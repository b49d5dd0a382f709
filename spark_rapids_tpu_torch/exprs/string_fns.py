"""String predicate expressions (port of
``spark_rapids_tpu/exprs/string_fns.py``: the classes of the literal
match family, their types, keys and tagging).

They have no row-wise device form of their own: a projection or a filter
routes them over a byte-rectangle column through
``string_rect.eval_rect_expr``, and over a dictionary column through
``string_rect.match_dictionary`` (in a filter: ``compiler.py``
``DictFilterEvaluator``, in the form ``dict_form`` names).
"""
from __future__ import annotations

from typing import Optional

from ..types import BOOL, INT32, Schema
from .base import Expression

__all__ = ["Contains", "StartsWith", "EndsWith", "Like", "RLike",
           "StringLocate", "StringInstr"]


class _HostStringExpr(Expression):
    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        return f"{type(self).__name__}: string expressions run on host"


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
