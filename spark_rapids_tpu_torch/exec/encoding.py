"""Order-preserving key encodings for device sort and groupby (port of
``spark_rapids_tpu/exec/encoding.py``).

Every key column becomes sort operands whose ascending order equals
Spark's row order: a ``uint8`` null rank, then the key. Spark's total
order holds: every NaN is one canonical NaN, greater than +inf; -0.0 is
0.0; nulls first or last by the rank. Torch has no variadic sort, so
``lexsort_permutation`` sorts by the operands as stable passes, from the
last operand to the first.

The reference keeps floats as float operands and leans on XLA's
total-order comparator, which puts a negated NaN first. ``torch.sort``
puts every NaN last whatever its sign, so here a float key becomes the
signed integer of its bits with the lower bits of negative values
flipped: integer order is then float total order, and a descending key
is its bitwise complement, as for integers.

Only scalar lanes are encoded here (int, float, bool, date, timestamp);
a byte-rectangle string key arrives with the strings slice.
"""
from __future__ import annotations

from typing import List

import torch

from ..exprs.base import DVal, StrVal

__all__ = ["order_key_operands", "grouping_operands", "operands_equal",
           "canonicalize_floats", "lexsort_permutation"]

_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def canonicalize_floats(d: torch.Tensor) -> torch.Tensor:
    """-0.0 -> 0.0, every NaN -> the canonical positive NaN."""
    d = torch.where(d == 0.0, torch.zeros_like(d), d)
    return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)


def _float_order_key(d: torch.Tensor) -> torch.Tensor:
    """Signed integers whose order is the total order of the canonical
    floats ``d`` (-inf < ... < 0.0 < ... < +inf < NaN)."""
    idt = _BITS[d.dtype]
    b = canonicalize_floats(d).view(idt)
    low = torch.iinfo(idt).max          # every bit but the sign
    return torch.where(b < 0, torch.bitwise_xor(b, low), b)


def order_key_operands(v: DVal, ascending: bool,
                       nulls_first: bool) -> List[torch.Tensor]:
    """One sort order -> [null_rank uint8, key]. A null row's key is 0,
    so nulls are equal to each other and ordered by their rank alone."""
    if isinstance(v.data, StrVal):
        raise NotImplementedError(
            "sort or group key over a byte-rectangle string column: such "
            "keys arrive with the strings slice (ROADMAP.md Queue A)")
    d = v.data
    if d.is_floating_point():
        key = _float_order_key(d)
        if not ascending:
            key = torch.bitwise_not(key)
    elif d.dtype == torch.bool:
        key = d.to(torch.int8)
        if not ascending:
            key = 1 - key
    else:
        key = d if ascending else torch.bitwise_not(d)
    key = torch.where(v.validity, key, torch.zeros_like(key))
    # nulls first: a null ranks 0 and a value 1; nulls last the reverse
    ranked = v.validity if nulls_first else torch.logical_not(v.validity)
    return [ranked.to(torch.uint8), key]


def grouping_operands(v: DVal) -> List[torch.Tensor]:
    """Key operands for groupby (order irrelevant, equality must hold:
    null == null forms one group, NaN == NaN one group)."""
    return order_key_operands(v, ascending=True, nulls_first=False)


def operands_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise equality of sorted key operands; NaNs compare equal."""
    eq = a == b
    if a.is_floating_point():
        eq = torch.logical_or(eq, torch.logical_and(torch.isnan(a),
                                                    torch.isnan(b)))
    return eq


def lexsort_permutation(operands: List[torch.Tensor]) -> torch.Tensor:
    """The stable permutation that sorts rows by ``operands``
    lexicographically (the first operand decides first): one stable
    ``torch.sort`` per operand, last operand first, each over the rows as
    the passes before it left them."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for op in reversed(operands):
        order = torch.sort(op[perm], stable=True).indices
        perm = perm[order]
    return perm
