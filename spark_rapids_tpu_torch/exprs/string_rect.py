"""String expressions over byte rectangles and dictionaries (port of
``spark_rapids_tpu/exprs/string_rect.py``: the transform chains and the
literal match family).

A high-cardinality STRING column lives on the device as a ``StrVal``
rectangle (columnar/strrect.py). A chain of value-wise transforms over
one such column (upper, lower, initcap, space trim, substring, replace,
lpad/rpad, substring_index, reverse) evaluates as one ``rect_transform``
call (exec/rect_transform.py: the hand-written kernel on a card, its
plain torch version on the CPU), in place of the reference's jitted
``jnp`` transforms. The chain may end in a terminal: an INT32 function
(``Length``, ``Ascii``, ``OctetLength``, ``BitLength``), a literal match
(Contains / StartsWith / EndsWith, the literal LIKE and RLIKE forms,
StringLocate, StringInstr: exprs/rect_match.py, the hand-written kernel
when ``spark.rapids.tpu.sql.pallas.enabled`` is on, otherwise its plain
torch version), or any other LIKE or RLIKE, the ``"dfa"`` form: the
pattern's DFA (exprs/regex_dfa.py) walked by ``rect_dfa``
(exec/rect_dfa.py, on a card always the kernel). The ASCII gate stays
with the caller: the project exec takes this path only for an
``ascii_only`` rectangle, where a byte is a character.

Over a dictionary column the same chains run once per dictionary entry
on the host (``dictionary_values``), through each expression's
``host_value`` (a pattern's ``host_matcher``). A chain may also stand on
another expression giving a string (``upper(concat(a, b))``,
``chain_bottom``), evaluated first into a column.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..columnar.strrect import RECT_MAX_BYTES
from ..exec.rect_transform import MAX_LITERAL, MAX_WIDTH, rect_transform
from ..types import BOOL, INT32, STRING, DataType, Schema
from .base import ColumnRef, DVal, Expression, StrVal
from .rect_match import rect_match, rect_match_reference

__all__ = ["rect_chain_leaf", "chain_leaf", "chain_bottom",
           "transform_op", "match_form", "match_dictionary",
           "dictionary_values", "eval_rect_expr", "eval_rect_chain",
           "eval_rect_in"]

_REGEX_META = set(".^$*+?{}[]\\|()")


def _ascii(s: str) -> Optional[bytes]:
    try:
        return s.encode("ascii")
    except UnicodeEncodeError:
        return None


def _rlike_literal_parts(pattern: str):
    """(form, literal) when a Java-regex RLIKE pattern is a literal,
    optionally after ``^``; None otherwise. A trailing ``$`` goes to the
    DFA: Java's ``$`` also matches before a final line terminator, which
    no literal form says (the JAX package takes ``lit$`` as endswith:
    ROADMAP.md Queue C)."""
    if not pattern or pattern.endswith("$"):
        return None
    lead = pattern.startswith("^")
    body = pattern[1 if lead else 0:]
    if any(c in _REGEX_META for c in body) or _ascii(body) is None:
        return None
    return ("startswith", body) if lead else ("contains", body)


def _like_parts(pattern: str):
    """(form, literal) for LIKE patterns of one literal between optional
    leading/trailing %; None for '_', escapes, interior % or non-ASCII."""
    if "_" in pattern or "\\" in pattern or _ascii(pattern) is None:
        return None
    lead = pattern.startswith("%")
    trail = pattern.endswith("%")
    mid = pattern.strip("%")
    if "%" in mid:
        return None
    if lead and trail:
        return ("contains", mid)
    if lead:
        return ("endswith", mid)
    if trail:
        return ("startswith", mid)
    return ("equals", mid)


def match_form(e: Expression) -> Optional[Tuple[str, object, DataType]]:
    """(form, literal, output type) of a match expression, or None when
    ``e`` is not one. A LIKE or RLIKE that no literal form takes is
    ``("dfa", its DFA, BOOL)`` (exprs/regex_dfa.py, built here, at
    planning: a pattern it refuses raises ``NotImplementedError``)."""
    from .base import Literal
    from .string_fns import (Contains, EndsWith, Like, RLike, StartsWith,
                             StringInstr, StringLocate)
    if isinstance(e, Like):
        parts = _like_parts(e.pattern) if e.escape == "\\" else None
        return ("dfa", e.dfa(), BOOL) if parts is None else (*parts, BOOL)
    if isinstance(e, RLike):
        parts = _rlike_literal_parts(e.pattern)
        return ("dfa", e.dfa(), BOOL) if parts is None else (*parts, BOOL)
    for cls, form in ((Contains, "contains"), (StartsWith, "startswith"),
                      (EndsWith, "endswith")):
        if isinstance(e, cls):
            return (form, e.pattern, BOOL) if _ascii(e.pattern) is not None \
                else None
    if isinstance(e, StringLocate):
        return ("locate", e.substr, INT32) if _ascii(e.substr) is not None \
            else None
    if isinstance(e, StringInstr):
        sub = e.children[1]
        if (isinstance(sub, Literal) and isinstance(sub.value, str)
                and _ascii(sub.value) is not None):
            return ("locate", sub.value, INT32)
    return None


def transform_op(e: Expression) -> Optional[tuple]:
    """The ``rect_transform`` op (exec/rect_transform.py) of a STRING ->
    STRING transform the rectangle path evaluates, else None: the
    reference's ``rect_supported_op`` conditions (space-only trim, ASCII
    literals, a non-empty search and delimiter), with the kernel's bounds
    (literals of at most 32 bytes, a pad target in (0, 64], the widest
    row it writes); ``initcap`` and a negative substring ``pos`` too,
    which the reference runs on its host engine, and ``repeat`` and
    ``translate`` (ASCII literals of at most 32 bytes)."""
    from .string_fns import (InitCap, Lower, Lpad, Reverse, StringRepeat,
                             StringReplace, StringTranslate, SubstringIndex,
                             Substring, Upper, _TrimBase)

    def lit(v: str) -> Optional[bytes]:
        b = _ascii(v)
        return b if b is not None and 1 <= len(b) <= MAX_LITERAL else None
    if isinstance(e, Upper):
        return ("upper",)
    if isinstance(e, Lower):
        return ("lower",)
    if isinstance(e, InitCap):
        return ("initcap",)
    if isinstance(e, Reverse):
        return ("reverse",)
    if isinstance(e, _TrimBase):
        return ("trim", e.left, e.right) if e.chars is None else None
    if isinstance(e, Substring):
        return ("substring", e.pos, e.length)
    if isinstance(e, StringReplace):
        s, r = lit(e.search), _ascii(e.replace)
        if s is None or r is None or len(r) > MAX_LITERAL:
            return None
        return ("replace", s, r)
    if isinstance(e, Lpad):
        p = lit(e.pad)
        if p is None or not 0 < e.length <= MAX_WIDTH:
            return None
        return ("pad", e.length, p, e.left)
    if isinstance(e, SubstringIndex):
        d = lit(e.delim)
        return None if d is None else ("substring_index", d, e.count)
    if isinstance(e, StringRepeat):
        return ("repeat", max(e.times, 0))
    if isinstance(e, StringTranslate):
        src, dst = _ascii(e.src), _ascii(e.dst)
        if src is None or dst is None or max(len(src), len(dst)) \
                > MAX_LITERAL:
            return None
        return ("translate", src, dst)
    return None


def _terminal(e: Expression) -> bool:
    """A STRING -> INT or BOOL op that may end a chain."""
    from .string_fns import _IntTerminal
    return isinstance(e, _IntTerminal) or match_form(e) is not None


def _link(e: Expression) -> bool:
    """A value-wise STRING -> STRING transform of one child."""
    return getattr(e, "dict_transform", False) and len(e.children) == 1


def chain_bottom(e: Expression) -> Optional[Expression]:
    """What a chain (value-wise transforms, then an optional terminal)
    stands on: a ColumnRef, or another expression giving a string
    (``upper(concat(a, b))``); None when ``e`` is no chain."""
    cur = e.children[0] if _terminal(e) else e
    hops = int(cur is not e)
    while _link(cur):
        cur = cur.children[0]
        hops += 1
    return cur if hops else None


def _chain_leaf(e: Expression, schema: Schema, link) -> Optional[str]:
    """Leaf column name when ``e`` is ``link`` ops (an optional terminal
    at the root) over one STRING ColumnRef, else None."""
    cur = e
    if _terminal(cur):
        cur = cur.children[0]
    hops = int(cur is not e)
    while not isinstance(cur, ColumnRef):
        if not link(cur) or len(cur.children) != 1:
            return None
        cur = cur.children[0]
        hops += 1
    if hops and cur.name in schema.names() \
            and schema[cur.name].dtype == STRING:
        return cur.name
    return None


def rect_chain_leaf(e: Expression, schema: Schema) -> Optional[str]:
    """Leaf column name when ``e`` is a chain the rectangle path
    evaluates (transforms, then an optional terminal) over one STRING
    ColumnRef, else None."""
    return _chain_leaf(e, schema, lambda x: transform_op(x) is not None)


def chain_leaf(e: Expression, schema: Schema) -> Optional[str]:
    """Leaf column name when ``e`` is a chain of value-wise transforms
    (``dict_transform``), then an optional terminal, over one STRING
    ColumnRef, else None: the port runs every such chain over a
    dictionary column (once per entry), and over a byte rectangle the
    chains of ``rect_chain_leaf``, a subset of these."""
    return _chain_leaf(e, schema,
                       lambda x: getattr(x, "dict_transform", False))


def _split_chain(e: Expression):
    """(terminal or None, the transforms from the bottom up); a filter's
    ``In`` over a string column is a terminal too."""
    from .comparison import In
    term = e if _terminal(e) or isinstance(e, In) else None
    cur = e.children[0] if term is not None else e
    chain = []
    while not isinstance(cur, ColumnRef) and _link(cur):
        chain.append(cur)
        cur = cur.children[0]
    chain.reverse()
    return term, chain


def _rect_chain(e: Expression) -> bool:
    """Whether the byte-rectangle path takes the chain ``e`` (its
    transforms ``rect_transform`` ops, its terminal one it evaluates)."""
    term, chain = _split_chain(e)
    return all(transform_op(x) is not None for x in chain)


def dictionary_values(e: Expression, dictionary: np.ndarray) -> np.ndarray:
    """A chain (``chain_leaf``) over every entry of a string
    dictionary: an object array of str for a STRING result, int32 for
    Length, bool (or int32 for locate) for a match."""
    from .string_fns import _IntTerminal
    term, chain = _split_chain(e)
    vals = list(np.asarray(dictionary, dtype=object))
    for x in chain:
        vals = [x.host_value(v) for v in vals]
    if term is None:
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out
    if isinstance(term, _IntTerminal):
        return np.asarray([term.host_value(v) for v in vals],
                          dtype=np.int32)
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return match_dictionary(term, out)


def match_dictionary(e: Expression, dictionary: np.ndarray) -> np.ndarray:
    """A literal-match op (``match_form``, or ``In``) over every entry of a
    string dictionary, by character: bool per entry, or int32 1-based
    position for locate."""
    from .comparison import In
    # Python strings, not a numpy U array: that would drop each entry's
    # trailing NUL characters ("a\x00" == "a")
    d = list(np.asarray(dictionary, dtype=object))
    if isinstance(e, In):
        listed = {str(v) for v in e.values if v is not None}
        return np.fromiter((v in listed for v in d), bool, len(d))
    form, lit, _ = match_form(e)
    if form == "dfa":
        match = e.host_matcher()
        return np.fromiter((match(v) for v in d), bool, len(d))
    if form == "contains":
        return np.fromiter((lit in v for v in d), bool, len(d))
    if form == "startswith":
        return np.fromiter((v.startswith(lit) for v in d), bool, len(d))
    if form == "endswith":
        return np.fromiter((v.endswith(lit) for v in d), bool, len(d))
    if form == "equals":
        return np.fromiter((v == lit for v in d), bool, len(d))
    return np.fromiter((v.find(lit) + 1 for v in d), np.int32, len(d))


def eval_rect_expr(e: Expression, child: DVal,
                   use_kernel: bool = False) -> DVal:
    """Evaluate a chain's terminal (an INT32 function or a match) over a
    StrVal-typed DVal. A literal match runs the hand-written match kernel
    with ``use_kernel``, its plain version without; a pattern the literal
    forms do not take runs ``rect_dfa`` (on a card always the kernel)."""
    from .string_fns import _IntTerminal
    sv: StrVal = child.data
    if isinstance(e, _IntTerminal):
        return DVal(torch.where(child.validity, e.rect_value(sv), 0)
                    .to(torch.int32), child.validity, INT32)
    form, lit, out_dt = match_form(e)
    if form == "dfa":
        from ..exec.rect_dfa import rect_dfa
        return DVal(rect_dfa(sv.bytes_, sv.lengths, child.validity, lit),
                    child.validity, out_dt)
    fn = rect_match if use_kernel else rect_match_reference
    return DVal(fn(sv.bytes_, sv.lengths, lit.encode(), form),
                child.validity, out_dt)


def eval_rect_in(values, child: DVal, use_kernel: bool = False):
    """bool per row: the string equals one of the non-null ``values``
    (rect_match's ``equals`` mode once per value; a value that is not
    ASCII matches no row of an ASCII rectangle)."""
    sv: StrVal = child.data
    fn = rect_match if use_kernel else rect_match_reference
    import torch
    hit = torch.zeros(sv.lengths.shape, dtype=torch.bool,
                      device=sv.lengths.device)
    for v in values:
        lit = None if v is None else _ascii(v)
        if lit is not None:
            hit = torch.logical_or(hit, fn(sv.bytes_, sv.lengths, lit,
                                           "equals"))
    return hit


def eval_rect_chain(e: Expression, leaf_val: DVal, use_kernel: bool = False,
                    cap: int = RECT_MAX_BYTES.default) -> DVal:
    """Evaluate a rect chain (validated by rect_chain_leaf): its
    transforms as one ``rect_transform`` call, then its terminal."""
    term, chain = _split_chain(e)
    val = leaf_val
    if chain:
        sv: StrVal = val.data
        b, ln = rect_transform(sv.bytes_, sv.lengths, val.validity,
                               [transform_op(x) for x in chain], cap)
        val = DVal(StrVal(b, ln), val.validity, STRING)
    return val if term is None else eval_rect_expr(term, val, use_kernel)


def eval_string_chain(e: Expression, ctx) -> DVal:
    """A chain over one string column of ``ctx`` (``chain_leaf``), or
    over another expression giving a string (``chain_bottom``: its column
    through ``string_column``), evaluated by the column's layout: over a
    dictionary once per entry (a STRING result a dictionary column over
    the sorted distinct results, an INT or BOOL one a table gathered by
    code); over an ASCII byte rectangle through ``eval_rect_chain``
    (``rect_transform``, then the match kernels). A STRING result carries
    its column."""
    from ..columnar import ByteRectColumn, DictColumn
    from .collection_fns import string_column
    from .compiler import column_dval
    bottom = chain_bottom(e)
    if bottom is None:
        raise NotImplementedError(
            f"<{e.name_hint}> is not a string chain")
    if isinstance(bottom, ColumnRef):
        col = ctx.columns[ctx.schema.index_of(bottom.name)].column
    else:
        col = string_column(bottom, ctx)
    dt = e.data_type(ctx.schema)
    if isinstance(col, DictColumn):
        vals = dictionary_values(e, col.dictionary)
        dev = col.data.device
        if dt == STRING:
            if len(vals):
                uniq, inv = np.unique(vals, return_inverse=True)
                uniq = uniq.astype(object)
                rank = torch.from_numpy(inv.astype(np.int32).reshape(-1))
                codes = rank.to(dev)[col.data.clamp(0, len(rank) - 1).long()]
            else:
                uniq, codes = np.zeros(0, object), torch.zeros_like(col.data)
            out = DictColumn(torch.where(col.validity, codes, 0),
                             col.validity, STRING, uniq)
            return column_dval(out)
        table = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
        data = table[col.data.clamp(0, max(len(table) - 1, 0)).long()] \
            if len(table) else torch.zeros(col.padded_len, dtype=table.dtype,
                                           device=dev)
        return DVal(torch.where(col.validity, data, 0), col.validity, dt)
    if isinstance(col, ByteRectColumn) and col.ascii_only \
            and _rect_chain(e):
        out = eval_rect_chain(e, DVal(StrVal(col.data, col.lengths),
                                      col.validity, STRING),
                              ctx.use_kernel)
        if isinstance(out.data, StrVal):
            return column_dval(ByteRectColumn(
                out.data.bytes_, out.validity, out.data.lengths, True))
        return out
    from .collection_fns import STRINGS_REST
    raise NotImplementedError(
        f"<{e.name_hint}> over {col!r}: string expressions over non-ASCII "
        f"or host strings, and chains the byte-rectangle kernel does not "
        f"take, arrive with {STRINGS_REST}")
