"""AND with SQL three-valued (Kleene) semantics (port of
``spark_rapids_tpu/exprs/logical.py``): FALSE AND NULL is FALSE,
otherwise a null operand makes the result null."""
from __future__ import annotations

import torch

from ..types import BOOL, TypeEnum, TypeSig
from .base import DVal, Expression

__all__ = ["And"]

_bool_sig = TypeSig([TypeEnum.BOOLEAN])


class And(Expression):
    device_type_sig = _bool_sig

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self, schema):
        return BOOL

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

    def key(self):
        return f"and({self.children[0].key()},{self.children[1].key()})"

    @property
    def name_hint(self):
        return (f"({self.children[0].name_hint} AND "
                f"{self.children[1].name_hint})")
