"""AND, OR and NOT with SQL three-valued (Kleene) semantics (port of
``spark_rapids_tpu/exprs/logical.py``): FALSE AND NULL is FALSE, TRUE OR
NULL is TRUE, otherwise a null operand makes the result null; NOT NULL
is NULL."""
from __future__ import annotations

import torch

from ..types import BOOL, TypeEnum, TypeSig
from .base import DVal, Expression

__all__ = ["And", "Or", "Not"]

_bool_sig = TypeSig([TypeEnum.BOOLEAN])


class _BinaryLogical(Expression):
    device_type_sig = _bool_sig
    symbol = "?"

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self, schema):
        return BOOL

    def key(self):
        return (f"{self.symbol.lower()}({self.children[0].key()},"
                f"{self.children[1].key()})")

    @property
    def name_hint(self):
        return (f"({self.children[0].name_hint} {self.symbol} "
                f"{self.children[1].name_hint})")


class And(_BinaryLogical):
    symbol = "AND"

    def eval_device(self, ctx):
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        false_l = torch.logical_and(l.validity, torch.logical_not(l.data))
        false_r = torch.logical_and(r.validity, torch.logical_not(r.data))
        validity = torch.logical_or(torch.logical_and(l.validity, r.validity),
                                    torch.logical_or(false_l, false_r))
        data = torch.logical_and(torch.logical_and(l.data, l.validity),
                                 torch.logical_and(r.data, r.validity))
        return DVal(data, validity, BOOL)


class Or(_BinaryLogical):
    symbol = "OR"

    def eval_device(self, ctx):
        l = self.children[0].eval_device(ctx)
        r = self.children[1].eval_device(ctx)
        true_l = torch.logical_and(l.validity, l.data)
        true_r = torch.logical_and(r.validity, r.data)
        validity = torch.logical_or(torch.logical_and(l.validity, r.validity),
                                    torch.logical_or(true_l, true_r))
        return DVal(torch.logical_or(true_l, true_r), validity, BOOL)


class Not(Expression):
    device_type_sig = _bool_sig

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return BOOL

    def eval_device(self, ctx):
        c = self.children[0].eval_device(ctx)
        return DVal(torch.logical_not(c.data), c.validity, BOOL)

    def key(self):
        return f"not({self.children[0].key()})"
