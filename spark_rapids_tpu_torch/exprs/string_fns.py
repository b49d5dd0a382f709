"""String expressions (port of ``spark_rapids_tpu/exprs/string_fns.py``:
the match family, LIKE and RLIKE, the value-wise transforms and the INT32
functions, their types, keys and tagging; ``concat``, ``concat_ws`` and
``chr`` are in string_concat.py).

They have no row-wise device form of their own. A projection or a filter
routes them by the column's layout:

  * over a byte-rectangle column through ``string_rect.eval_rect_chain``:
    a chain of transforms is one ``rect_transform`` launch
    (exec/rect_transform.py), a literal match terminal one
    ``rect_match``, any other LIKE or RLIKE one ``rect_dfa``;
  * over a dictionary column once per dictionary entry on the host:
    ``string_rect.match_dictionary`` for the match family (in a filter:
    ``compiler.py`` ``DictFilterEvaluator``, in the form ``dict_form``
    names), and each transform's ``host_value`` (a ``dict_transform``
    chain in the project exec re-encodes the dictionary).

``StringSplit`` (``split``) runs on the device: a literal pattern,
Java's ``limit`` semantics, a list of strings as its result.

``host_value`` maps one Python ``str`` to its result with Spark's
semantics: numpy and Python only, as the card's machine has no pyarrow.
Where the reference's pyarrow kernels depart from Spark (``upper('ß')``),
the port follows Spark (ROADMAP.md Queue C).
"""
from __future__ import annotations

from typing import Optional

from ..types import BOOL, INT32, STRING, Schema
from .base import Expression

__all__ = ["Contains", "StartsWith", "EndsWith", "Like", "RLike",
           "StringLocate", "StringInstr", "Length", "Ascii", "BitLength",
           "OctetLength", "Upper", "Lower", "Substring", "StringTrim",
           "StringTrimLeft", "StringTrimRight", "StringReplace", "Lpad",
           "Rpad", "Reverse", "InitCap", "SubstringIndex", "StringRepeat",
           "StringTranslate", "StringSplit", "literal_pattern",
           "split_strings"]


class _HostStringExpr(Expression):
    #: value-wise STRING -> STRING transforms set True: over a dictionary
    #: column the project exec maps each entry once (``host_value``)
    dict_transform = False

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        return f"{type(self).__name__}: string expressions run on host"

    def fully_device_supported(self, schema: Schema) -> Optional[str]:
        """A chain over a lambda's string variable, or over another device
        expression giving a string (``upper(concat(a, b))``), runs on the
        device (``eval_device``); elsewhere the project and filter execs
        route string chains by the column's layout themselves."""
        from .base import ColumnRef
        from .string_rect import chain_bottom, chain_leaf
        leaf = chain_leaf(self, schema)
        if leaf is not None and leaf.startswith("`lambda_"):
            return None
        bottom = chain_bottom(self)
        if bottom is not None and not isinstance(bottom, ColumnRef) \
                and bottom.data_type(schema) == STRING \
                and bottom.fully_device_supported(schema) is None:
            return None
        return super().fully_device_supported(schema)

    def eval_device(self, ctx):
        """A string chain over one string column of ``ctx`` (a lambda's
        element, exprs/higher_order.py), by the column's layout: over a
        dictionary once per entry, over an ASCII byte rectangle through
        ``rect_transform`` and ``rect_match`` (string_rect.py)."""
        from .string_rect import eval_string_chain
        return eval_string_chain(self, ctx)

    def key(self):
        kids = ",".join(c.key() for c in self.children)
        return f"{type(self).__name__}({kids})"


class _PatternPredicate(_HostStringExpr):
    #: "range": on the SORTED dictionary the matching codes are one
    #: contiguous span -> (codes >= lo) & (codes < hi), no gather;
    #: "mask": any match set -> one lookup in a small table
    dict_form = "mask"

    def __init__(self, child, pattern: str):
        self.children = [child]
        self.pattern = pattern

    def data_type(self, schema):
        return BOOL

    def key(self):
        return (f"{type(self).__name__}({self.children[0].key()},"
                f"{self.pattern!r})")


class Contains(_PatternPredicate):
    pass


class StartsWith(_PatternPredicate):
    dict_form = "range"     # a prefix match is a code range on a sorted dict


class EndsWith(_PatternPredicate):
    pass


class Like(_PatternPredicate):
    """SQL LIKE, Spark's: a whole-string match where ``_`` is any
    character and ``%`` any run, a newline included (Spark compiles it
    with DOTALL; the JAX package's regex engine stops ``_`` and ``%`` at a
    newline: ROADMAP.md Queue C)."""

    def __init__(self, child, pattern: str, escape: str = "\\"):
        super().__init__(child, pattern)
        self.escape = escape
        self._dfa = None

    def dfa(self):
        """The pattern's DFA over bytes (exprs/regex_dfa.py), built once."""
        if self._dfa is None:
            from .regex_dfa import compile_like
            self._dfa = compile_like(self.pattern, self.escape)
        return self._dfa

    def host_matcher(self):
        """str -> bool: the match over one dictionary entry."""
        import re
        from .regex_transpiler import sql_like_to_regex
        rx = re.compile(sql_like_to_regex(self.pattern, self.escape),
                        re.DOTALL)
        return lambda v: rx.fullmatch(v) is not None

    def key(self):
        return (f"Like({self.children[0].key()},{self.pattern!r},"
                f"{self.escape!r})")


class RLike(_PatternPredicate):
    """Java-regex RLIKE: ``Matcher.find()``, the pattern anywhere in the
    string. A literal pattern (optionally after ``^``) runs as a literal
    match, any other through its DFA (exprs/regex_dfa.py, which refuses
    what it cannot take). Over a dictionary each entry is matched by
    Python's ``re`` with the transpiled pattern, ASCII case folding as
    Java's default (the JAX package's engine folds Unicode: ROADMAP.md
    Queue C)."""

    def __init__(self, child, pattern: str):
        super().__init__(child, pattern)
        self._dfa = None

    def dfa(self):
        """The pattern's DFA over bytes (exprs/regex_dfa.py), built once."""
        if self._dfa is None:
            from .regex_dfa import compile_rlike
            self._dfa = compile_rlike(self.pattern)
        return self._dfa

    def host_matcher(self):
        """str -> bool: the match over one dictionary entry (the empty
        string through the DFA: Python's ``\\B`` never matches it, Java's
        does)."""
        import re
        from .regex_dfa import dfa_match
        from .regex_transpiler import transpile_java_regex
        rx = re.compile(transpile_java_regex(self.pattern), re.ASCII)
        empty = dfa_match(self.dfa(), b"")
        return lambda v: rx.search(v) is not None if v else empty


class StringLocate(_HostStringExpr):
    """locate(substr, str): 1-based, 0 if absent."""

    def __init__(self, substr: str, child):
        self.children = [child]
        self.substr = substr

    def data_type(self, schema):
        return INT32

    def key(self):
        return f"locate({self.substr!r},{self.children[0].key()})"


class StringInstr(_HostStringExpr):
    """instr(str, substr): 1-based first occurrence, 0 if absent."""

    def __init__(self, child, substr):
        self.children = [child, substr]

    def data_type(self, schema):
        return INT32


# ---------------------------------------------------------------------------
# value-wise transforms (reference string_fns.py:51-706)
# ---------------------------------------------------------------------------

class _Unary(_HostStringExpr):
    dict_transform = True

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return STRING


class _IntTerminal(_HostStringExpr):
    """A STRING -> INT32 function that may end a chain: ``host_value``
    over one entry, ``rect_value`` over an ASCII byte rectangle (a byte a
    character)."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return INT32


class Length(_IntTerminal):
    """Characters (code points) of the string."""

    @staticmethod
    def host_value(v: str) -> int:
        return len(v)

    @staticmethod
    def rect_value(sv):
        return sv.lengths


class Ascii(_IntTerminal):
    """ascii(s): the code point of the first character, 0 for ''."""

    @staticmethod
    def host_value(v: str) -> int:
        return ord(v[0]) if v else 0

    @staticmethod
    def rect_value(sv):
        import torch
        if not sv.bytes_.shape[1]:
            return torch.zeros_like(sv.lengths)
        return torch.where(sv.lengths > 0, sv.bytes_[:, 0].to(torch.int32),
                           0)


class OctetLength(_IntTerminal):
    """octet_length(s): bytes of the UTF-8 string."""

    @staticmethod
    def host_value(v: str) -> int:
        return len(v.encode("utf-8"))

    @staticmethod
    def rect_value(sv):
        return sv.lengths


class BitLength(_IntTerminal):
    """bit_length(s): 8 x its bytes."""

    @staticmethod
    def host_value(v: str) -> int:
        return 8 * len(v.encode("utf-8"))

    @staticmethod
    def rect_value(sv):
        return sv.lengths * 8


class Upper(_Unary):
    """Java's ``toUpperCase``, full case mapping (``'ß'`` -> ``'SS'``)."""

    @staticmethod
    def host_value(v: str) -> str:
        return v.upper()


class Lower(_Unary):
    """Java's ``toLowerCase``, full case mapping (``'İ'`` -> ``'i̇'``)."""

    @staticmethod
    def host_value(v: str) -> str:
        return v.lower()


class Substring(_HostStringExpr):
    """Spark substring: 1-based, pos 0 treated as 1, negative from end."""
    dict_transform = True

    def __init__(self, child, pos: int, length: Optional[int] = None):
        self.children = [child]
        self.pos = pos
        self.length = length

    def data_type(self, schema):
        return STRING

    def host_value(self, v: str) -> str:
        start, end = substring_span(len(v), self.pos, self.length)
        return v[start:end]

    def key(self):
        return (f"substr({self.children[0].key()},{self.pos},"
                f"{self.length})")


def substring_span(n: int, pos: int, length: Optional[int]):
    """(start, end) of Spark's ``substring(s, pos, length)`` over a string
    of ``n`` characters (UTF8String.substringSQL), 0 <= start <= end <=
    n."""
    start = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
    end = n if length is None else start + length
    start = max(start, 0)
    end = min(end, n)
    return (start, max(end, start))


class _TrimBase(_HostStringExpr):
    """Default TRIM removes only the space character 0x20, not tabs or
    newlines (Spark semantics, SPARK-17299). ``chars`` trims that set."""
    dict_transform = True
    left = right = True

    def __init__(self, child, chars: Optional[str] = None):
        self.children = [child]
        self.chars = chars

    def data_type(self, schema):
        return STRING

    def host_value(self, v: str) -> str:
        chars = " " if self.chars is None else self.chars
        if self.left and self.right:
            return v.strip(chars)
        return v.lstrip(chars) if self.left else v.rstrip(chars)


class StringTrim(_TrimBase):
    pass


class StringTrimLeft(_TrimBase):
    right = False


class StringTrimRight(_TrimBase):
    left = False


class StringReplace(_HostStringExpr):
    """replace(str, search, replace): non-overlapping, left to right; an
    empty search leaves the string as it is (Spark)."""
    dict_transform = True

    def __init__(self, child, search: str, replace: str):
        self.children = [child]
        self.search = search
        self.replace = replace

    def data_type(self, schema):
        return STRING

    def host_value(self, v: str) -> str:
        return v.replace(self.search, self.replace) if self.search else v

    def key(self):
        return (f"replace({self.children[0].key()},{self.search!r},"
                f"{self.replace!r})")


class Lpad(_HostStringExpr):
    """lpad(str, length, pad): cut to ``length`` characters, or padded
    on the left with ``pad`` repeated (not padded when ``pad`` is
    empty)."""
    dict_transform = True
    left = True

    def __init__(self, child, length: int, pad: str = " "):
        self.children = [child]
        self.length = length
        self.pad = pad

    def data_type(self, schema):
        return STRING

    def host_value(self, v: str) -> str:
        n = max(self.length, 0)
        fill = (self.pad * n)[:max(n - len(v), 0)]
        return (fill + v if self.left else v + fill)[:n]

    def key(self):
        return (f"{type(self).__name__.lower()}({self.children[0].key()},"
                f"{self.length},{self.pad!r})")


class Rpad(Lpad):
    left = False


class Reverse(_Unary):
    @staticmethod
    def host_value(v: str) -> str:
        return v[::-1]


class StringRepeat(_HostStringExpr):
    """repeat(str, n): the string n times; '' for n <= 0."""
    dict_transform = True

    def __init__(self, child, times: int):
        self.children = [child]
        self.times = int(times)

    def data_type(self, schema):
        return STRING

    def host_value(self, v: str) -> str:
        return v * max(self.times, 0)

    def key(self):
        return f"repeat({self.children[0].key()},{self.times})"


def _literal_str(v) -> str:
    from .base import Literal
    if isinstance(v, Literal):
        v = v.value
    if not isinstance(v, str):
        raise TypeError(f"translate takes string literals, not {v!r}")
    return v


class StringTranslate(_HostStringExpr):
    """translate(str, from, to), Spark's ``StringTranslate``: each
    character of ``from`` maps to the character of ``to`` at its position
    (the first occurrence wins); one past the end of ``to``, or mapped to
    ``'\\0'``, is deleted."""
    dict_transform = True

    def __init__(self, child, src, dst):
        self.children = [child]
        self.src = _literal_str(src)
        self.dst = _literal_str(dst)

    def data_type(self, schema):
        return STRING

    def table(self) -> dict:
        """code point -> its replacement, None to delete."""
        out = {}
        for i, ch in enumerate(self.src):
            rep = self.dst[i] if i < len(self.dst) else "\0"
            out.setdefault(ord(ch), None if rep == "\0" else rep)
        return out

    def host_value(self, v: str) -> str:
        return v.translate(self.table())

    def key(self):
        return (f"translate({self.children[0].key()},{self.src!r},"
                f"{self.dst!r})")


class InitCap(_Unary):
    """initcap: the first letter of every space-separated word upper
    case, the rest lower case ('hELLO wORLD' -> 'Hello World')."""

    @staticmethod
    def host_value(v: str) -> str:
        return " ".join(w[:1].upper() + w[1:].lower() for w in v.split(" "))


class SubstringIndex(_HostStringExpr):
    """substring_index(str, delim, count): the part before the count-th
    delimiter (count > 0) or after the |count|-th from the end (count <
    0); "" for count 0 or an empty delimiter. Spark's
    ``UTF8String.subStringIndex``: each search starts one past the last
    match (``find(delim, idx + 1)``, ``rfind(delim, idx - 1)``), so
    matches may overlap: ``substring_index('aaa', 'aa', 2)`` is ``'a'``.
    Too few delimiters give the whole string."""
    dict_transform = True

    def __init__(self, child, delim: str, count: int):
        self.children = [child]
        self.delim = delim
        self.count = count

    def data_type(self, schema):
        return STRING

    def host_value(self, v: str) -> str:
        d, n = self.delim, len(self.delim)
        if not d or self.count == 0:
            return ""
        if self.count > 0:
            idx = -1
            for _ in range(self.count):
                idx = v.find(d, idx + 1)
                if idx < 0:
                    return v
            return v[:idx]
        idx = len(v) - n + 1
        for _ in range(-self.count):
            # the last match starting at or before idx - 1
            idx = v.rfind(d, 0, idx - 1 + n) if idx >= 1 else -1
            if idx < 0:
                return v
        return v[idx + n:]

    def key(self):
        return (f"substring_index({self.children[0].key()},"
                f"{self.delim!r},{self.count})")


# ---------------------------------------------------------------------------
# split (reference string_fns.py:645-700)
# ---------------------------------------------------------------------------

_REGEX_META = set(".$|()[]{}^?*+\\")


def literal_pattern(pattern: str) -> Optional[str]:
    """The literal a Java-regex ``pattern`` matches, when it is one: no
    metacharacter, or one escaped character (``\\|``); else None."""
    if len(pattern) == 2 and pattern[0] == "\\" and not pattern[1].isalnum():
        return pattern[1]
    if pattern and not any(c in _REGEX_META for c in pattern):
        return pattern
    return None


def _split_host(v: str, d: str, limit: int) -> list:
    """Java's ``String.split(d, limit)`` of a literal ``d``: at most
    ``limit`` parts when positive; trailing empty parts dropped when 0;
    the string itself when ``d`` is not in it."""
    if d not in v:
        return [v]
    parts = v.split(d, limit - 1) if limit > 0 else v.split(d)
    if limit == 0:
        while parts and parts[-1] == "":
            parts.pop()
    return parts


def _split_dictionary(col, d: str, limit: int, what: str):
    """Each dictionary entry split once on the host; rows gather their
    entry's token codes over the tokens' sorted dictionary."""
    import numpy as np
    import torch
    from ..columnar import DictColumn
    from ..columnar.nested import Slots, too_long, width_bucket
    from .base import ListVal
    split = [_split_host(v, d, limit) for v in col.dictionary]
    longest = max((len(t) for t in split), default=1)
    w = width_bucket(max(longest, 1))
    if w is None:
        raise too_long(what, longest)
    toks = sorted({t for ts in split for t in ts})
    code = {t: i for i, t in enumerate(toks)}
    table = np.zeros((max(len(split), 1), w), np.int32)
    counts = np.zeros(max(len(split), 1), np.int32)
    for i, ts in enumerate(split):
        table[i, :len(ts)] = [code[t] for t in ts]
        counts[i] = len(ts)
    dev = col.data.device
    idx = col.data.clamp(0, max(len(split) - 1, 0)).long()
    lengths = torch.where(col.validity, torch.from_numpy(counts).to(dev)[idx],
                          0)
    inside = torch.arange(w, device=dev)[None, :] < lengths[:, None]
    codes = torch.where(inside, torch.from_numpy(table).to(dev)[idx], 0)
    elems = DictColumn(codes.reshape(-1), inside.reshape(-1), STRING,
                       np.array(toks, dtype=object))
    return ListVal(Slots(elems, w), inside, lengths.to(torch.int32))


def _split_rect(col, d: bytes, limit: int, what: str):
    """Each row of a byte rectangle split on the device: the delimiter's
    matches, left to right and not overlapping, then each token's bytes
    gathered into a [P·W, B] rectangle of the tokens' widest bucket. One
    host read: the most tokens and the longest token."""
    import torch
    from ..columnar import ByteRectColumn
    from ..columnar.nested import Slots, too_long, width_bucket
    from ..columnar.strrect import rect_width_bucket
    from .base import ListVal
    n, b = col.data.shape
    dev = col.data.device
    L = len(d)
    lens = torch.where(col.validity, col.lengths, 0).to(torch.int64)
    m = max(b - L + 1, 0)
    j = torch.arange(m, device=dev)
    match = (j[None, :] + L <= lens[:, None])
    for t, ch in enumerate(d):
        match = match & (col.data[:, t:t + m] == ch)
    if L > 1 and m:
        free = torch.zeros(n, dtype=torch.int64, device=dev)
        cols = []
        for i in range(m):
            hit = match[:, i] & (free <= i)
            free = torch.where(hit, i + L, free)
            cols.append(hit)
        match = torch.stack(cols, dim=1)
    if limit > 0:
        match = match & (torch.cumsum(match.to(torch.int32), dim=1)
                         <= limit - 1)
    count = match.sum(dim=1)
    ntok = count + 1
    most = int(ntok.max().item()) if n else 1
    w = width_bucket(max(most, 1))
    if w is None:
        raise too_long(what, most)
    k = w - 1
    # the match positions of each row in order (past the last, ``b``):
    # the matches in row-major order, each row's from its first
    pos = torch.full((n, k + 1), b, dtype=torch.int64, device=dev)
    at = torch.nonzero(match.reshape(-1), as_tuple=True)[0]
    if at.numel():
        row = at // m
        first = torch.cumsum(count, 0) - count
        pos[row, torch.arange(at.numel(), device=dev) - first[row]] = at % m
    pos = pos[:, :k]
    starts = torch.cat([torch.zeros((n, 1), dtype=torch.int64, device=dev),
                        pos + L], dim=1)
    slot = torch.arange(w, device=dev)[None, :]
    ends = torch.where(slot < count[:, None], torch.cat(
        [pos, lens[:, None]], dim=1), lens[:, None])
    tok = torch.where(slot < ntok[:, None], (ends - starts).clamp(min=0), 0)
    if limit == 0:
        # trailing empty tokens dropped, where the delimiter was found
        nonempty = (tok > 0) & (slot < ntok[:, None])
        last = torch.where(nonempty, slot, -1).amax(dim=1) + 1
        ntok = torch.where(count > 0, last, ntok)
        tok = torch.where(slot < ntok[:, None], tok, 0)
    ntok = torch.where(col.validity, ntok, 0)
    inside = slot < ntok[:, None]
    tok = torch.where(inside, tok, 0)
    longest = int(tok.max().item()) if tok.numel() else 0
    bt = rect_width_bucket(longest, 1 << 30)
    out = torch.zeros((n, w, bt), dtype=torch.uint8, device=dev)
    for c in range(bt):
        src = (starts + c).clamp(0, max(b - 1, 0))
        out[:, :, c] = torch.where(c < tok, col.data.gather(1, src), 0) \
            if b else 0
    elems = ByteRectColumn(out.reshape(n * w, bt), inside.reshape(-1),
                           tok.reshape(-1).to(torch.int32),
                           ascii_only=col.ascii_only)
    return ListVal(Slots(elems, w), inside, ntok.to(torch.int32))


def split_strings(col, pattern: str, limit: int, what: str):
    """A flat string column's rows split on a literal pattern (Java's
    ``limit`` semantics): a ``ListVal`` of string slots, a dictionary's
    tokens over their own dictionary, a rectangle's as a rectangle."""
    from ..columnar import DictColumn
    d = literal_pattern(pattern)
    if isinstance(col, DictColumn):
        return _split_dictionary(col, d, limit, what)
    return _split_rect(col, d.encode("utf-8"), limit, what)


class StringSplit(Expression):
    """split(str, pattern[, limit]) -> array<string>: Java's
    ``String.split`` of a literal pattern (one with no regex
    metacharacter, or one escaped character); ``limit`` > 0 gives at most
    that many parts, 0 drops trailing empty parts, < 0 (the default)
    keeps them all. A dictionary column splits each entry once and
    gathers by code; a byte rectangle finds the delimiters on the device
    (``split_strings``). A regex pattern is refused, naming the strings
    slice; a row of more than 256 parts raises at its batch."""

    def __init__(self, child, pattern: str, limit: int = -1):
        self.children = [child]
        self.pattern = pattern
        self.limit = int(limit)

    def data_type(self, schema):
        from ..types import ArrayType
        return ArrayType(STRING)

    def device_unsupported_reason(self, schema):
        from .collection_fns import STRINGS_REST
        if literal_pattern(self.pattern) is None:
            return (f"split by the regex {self.pattern!r} arrives with "
                    f"{STRINGS_REST}")
        return None

    def fully_device_supported(self, schema):
        from .collection_fns import string_arg_reason
        return self.device_unsupported_reason(schema) or \
            string_arg_reason(self.children[0], schema)

    def eval_device(self, ctx):
        from .base import DVal
        from .collection_fns import string_column
        col = string_column(self.children[0], ctx)
        lv = split_strings(col, self.pattern, self.limit, "split")
        return DVal(lv, col.validity, self.data_type(ctx.schema))

    def key(self):
        return (f"split({self.children[0].key()},{self.pattern!r},"
                f"{self.limit})")
