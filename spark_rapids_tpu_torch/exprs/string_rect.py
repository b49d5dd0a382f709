"""String predicates over byte rectangles (port of
``spark_rapids_tpu/exprs/string_rect.py``, the literal match family).

A high-cardinality STRING column lives on the device as a ``StrVal``
rectangle (columnar/strrect.py). Contains / StartsWith / EndsWith, the
literal LIKE and RLIKE forms, StringLocate and StringInstr each become one
literal match (exprs/rect_match.py): the hand-written kernel when
``spark.rapids.tpu.sql.pallas.enabled`` is on, otherwise its plain torch
version, which stands for the reference's XLA ops ``_startswith``,
``_endswith``, ``_contains``, ``_equals`` and ``_locate``. The ASCII gate stays with the caller: the project exec takes
this path only for an ``ascii_only`` rectangle, where a byte is a
character.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..types import BOOL, INT32, STRING, DataType, Schema
from .base import ColumnRef, DVal, Expression, StrVal
from .rect_match import rect_match, rect_match_reference

__all__ = ["rect_supported_op", "rect_chain_leaf", "match_form",
           "match_dictionary", "eval_rect_expr", "eval_rect_chain",
           "eval_rect_in"]

_REGEX_META = set(".^$*+?{}[]\\|()")


def _ascii(s: str) -> Optional[bytes]:
    try:
        return s.encode("ascii")
    except UnicodeEncodeError:
        return None


def _rlike_literal_parts(pattern: str):
    """(form, literal) when a Java-regex RLIKE pattern is an (optionally
    anchored) literal; None otherwise."""
    if not pattern:
        return None
    lead = pattern.startswith("^")
    trail = pattern.endswith("$")
    body = pattern[1 if lead else 0: len(pattern) - (1 if trail else 0)]
    if any(c in _REGEX_META for c in body) or _ascii(body) is None:
        return None
    if lead and trail:
        return ("equals", body)
    if lead:
        return ("startswith", body)
    if trail:
        return ("endswith", body)
    return ("contains", body)


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


def match_form(e: Expression) -> Optional[Tuple[str, str, DataType]]:
    """(form, literal, output type) of a literal-match expression, or None
    when ``e`` is not one the rectangle path evaluates."""
    from .base import Literal
    from .string_fns import (Contains, EndsWith, Like, RLike, StartsWith,
                             StringInstr, StringLocate)
    if isinstance(e, Like):
        parts = _like_parts(e.pattern) if e.escape == "\\" else None
        return None if parts is None else (*parts, BOOL)
    if isinstance(e, RLike):
        parts = _rlike_literal_parts(e.pattern)
        return None if parts is None else (*parts, BOOL)
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


def rect_supported_op(e: Expression) -> bool:
    return match_form(e) is not None


def rect_chain_leaf(e: Expression, schema: Schema) -> Optional[str]:
    """Leaf column name when ``e`` is a rect-supported op over one STRING
    ColumnRef, else None."""
    if not rect_supported_op(e):
        return None
    leaf = e.children[0]
    if isinstance(leaf, ColumnRef) and leaf.name in schema.names() \
            and schema[leaf.name].dtype == STRING:
        return leaf.name
    return None


def match_dictionary(e: Expression, dictionary: np.ndarray) -> np.ndarray:
    """A literal-match op (``rect_supported_op``) over every entry of a
    string dictionary, by character: bool per entry, or int32 1-based
    position for locate."""
    from .comparison import In
    d = np.asarray(dictionary, dtype=str)
    if isinstance(e, In):
        listed = [v for v in e.values if v is not None]
        return np.isin(d, np.asarray(listed, dtype=str)) if listed \
            else np.zeros(len(d), bool)
    form, lit, _ = match_form(e)
    if form == "contains":
        return np.char.find(d, lit) >= 0
    if form == "startswith":
        return np.char.startswith(d, lit)
    if form == "endswith":
        return np.char.endswith(d, lit)
    if form == "equals":
        return d == lit
    return (np.char.find(d, lit) + 1).astype(np.int32)


def eval_rect_expr(e: Expression, child: DVal,
                   use_kernel: bool = False) -> DVal:
    """Evaluate one literal-match op over a StrVal-typed DVal;
    ``use_kernel`` routes it through the hand-written kernel."""
    form, lit, out_dt = match_form(e)
    sv: StrVal = child.data
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


def eval_rect_chain(e: Expression, leaf_val: DVal,
                    use_kernel: bool = False) -> DVal:
    """Evaluate a rect chain (validated by rect_chain_leaf)."""
    if isinstance(e, ColumnRef):
        return leaf_val
    return eval_rect_expr(e, eval_rect_chain(e.children[0], leaf_val,
                                             use_kernel), use_kernel)
