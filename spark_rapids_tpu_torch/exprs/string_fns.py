"""String expressions (port of ``spark_rapids_tpu/exprs/string_fns.py``:
the literal match family and the value-wise transforms, their types, keys
and tagging).

They have no row-wise device form of their own. A projection or a filter
routes them by the column's layout:

  * over a byte-rectangle column through ``string_rect.eval_rect_chain``:
    a chain of transforms is one ``rect_transform`` launch
    (exec/rect_transform.py), a match terminal one ``rect_match``;
  * over a dictionary column once per dictionary entry on the host:
    ``string_rect.match_dictionary`` for the match family (in a filter:
    ``compiler.py`` ``DictFilterEvaluator``, in the form ``dict_form``
    names), and each transform's ``host_value`` (a ``dict_transform``
    chain in the project exec re-encodes the dictionary).

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
           "StringLocate", "StringInstr", "Length", "Upper", "Lower",
           "Substring", "StringTrim", "StringTrimLeft", "StringTrimRight",
           "StringReplace", "Lpad", "Rpad", "Reverse", "InitCap",
           "SubstringIndex"]


class _HostStringExpr(Expression):
    #: value-wise STRING -> STRING transforms set True: over a dictionary
    #: column the project exec maps each entry once (``host_value``)
    dict_transform = False

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        return f"{type(self).__name__}: string expressions run on host"

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
    """SQL LIKE."""

    def __init__(self, child, pattern: str, escape: str = "\\"):
        super().__init__(child, pattern)
        self.escape = escape

    def key(self):
        return (f"Like({self.children[0].key()},{self.pattern!r},"
                f"{self.escape!r})")


class RLike(_PatternPredicate):
    """Java-regex RLIKE (the port evaluates literal patterns only)."""


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


class Length(_HostStringExpr):
    """Characters (code points) of the string."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return INT32

    @staticmethod
    def host_value(v: str) -> int:
        return len(v)


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
