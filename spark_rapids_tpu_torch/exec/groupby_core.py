"""Aggregation cores (port of ``spark_rapids_tpu/exec/groupby_core.py``).

``global_groupby`` reduces a keyless aggregation to masked vector
reductions. The keyed sort path, ``segmented_groupby``, runs three
stages, as the reference does:

  * ``stage_sort``  -- encode the keys (exec/encoding.py) and sort the
    rows by them: stable ``torch.sort`` passes carry one row permutation,
    then keys and values are gathered once (torch has no variadic sort
    that carries payloads);
  * ``stage_scan``  -- segment starts from adjacent key operands, then
    every aggregate's update (or merge) over the sorted segments;
  * ``stage_pack``  -- each group's key from its last row. Float keys
    come out canonical (one NaN, 0.0 for -0.0), as the reference's exec
    rebuilds them from the sorted operands (Spark's
    NormalizeFloatingNumbers). A byte-rectangle string key (a
    ``StrVal``) sorts as its words and length (exec/encoding.py) and is
    rebuilt from those sorted operands, never gathered as bytes (the
    reference's ``k_scan``, ``_reconstructible`` for STRING): its rows
    come out as ``StrVal`` rectangles of the input's width.

Results come back one row per group, in key order. The dense path for
dictionary keys is ``exec/dense_groupby.py``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from ..columnar.segmented import GlobalSegments, SortedSegments
from ..columnar.strrect import unpack_words
from ..columnar.nested import slot_rows, take_rows
from ..exprs.base import DVal, ListVal, StrVal, StructVal
from .encoding import (canonicalize_floats, grouping_operands,
                       lexsort_permutation, operands_equal)

__all__ = ["global_groupby", "segmented_groupby", "stage_sort",
           "stage_scan", "stage_pack"]


def _positions(n: int, offset: int, device) -> torch.Tensor:
    return torch.arange(offset, offset + n, dtype=torch.int64,
                        device=device)


def global_groupby(vals: List[List[DVal]], aggs: Sequence, mode: str,
                   row_mask: torch.Tensor, row_offset: int = 0):
    """One segment over the rows where ``row_mask`` holds: every
    aggregate's update (or merge) is a masked vector reduction. Returns
    the flat list of (data[1], validity[1]) partials. ``row_offset`` is
    the position of the first row in the input (first/last rank rows by
    it)."""
    seg = GlobalSegments(row_mask, _positions(row_mask.shape[0], row_offset,
                                              row_mask.device))
    return _run_aggs(aggs, vals, seg, mode)


class _StringOperands(NamedTuple):
    """A string key after the sort: its sorted operands."""
    rank: torch.Tensor
    words: List[torch.Tensor]
    lengths: torch.Tensor


def stage_sort(keys: List[DVal], vals: List[List[DVal]],
               row_mask: torch.Tensor):
    """Sort the rows by the keys' grouping operands, live rows first.
    Returns (sorted operands, sorted keys, sorted values, sorted live
    mask, the permutation); a string key's entry is its sorted operands
    (``_StringOperands``)."""
    pad_flag = torch.logical_not(row_mask).to(torch.uint8)
    operands = [pad_flag]
    spans = []
    for k in keys:
        ops = grouping_operands(k)
        spans.append((len(operands) - 1, len(ops)))
        operands.extend(ops)
    perm = lexsort_permutation(operands)
    s_ops = [op[perm] for op in operands[1:]]
    s_keys = []
    for k, (at, n) in zip(keys, spans):
        if isinstance(k.data, StrVal):
            s_keys.append(_StringOperands(s_ops[at], s_ops[at + 1:at + n - 1],
                                          s_ops[at + n - 1]))
            continue
        d = canonicalize_floats(k.data) if k.data.is_floating_point() \
            else k.data
        s_keys.append(DVal(d[perm], k.validity[perm], k.dtype))
    s_vals = [[DVal(_take_rows(v.data, perm), v.validity[perm], v.dtype,
                    None if v.column is None else take_rows(v.column, perm))
               for v in vs] for vs in vals]
    return s_ops, s_keys, s_vals, row_mask[perm], perm


def _take_rows(data, perm):
    """``data``'s rows ``perm``: a tensor's, a list rectangle's (a
    ListVal partial of collect_list), a struct's or a string's; None
    stays None."""
    if data is None:
        return None
    if isinstance(data, ListVal):
        return ListVal(slot_rows(data.values, perm), data.elem_valid[perm],
                       data.lengths[perm])
    if isinstance(data, StructVal):
        return StructVal(tuple(take_rows(c, perm) for c in data.fields))
    if isinstance(data, StrVal):
        return StrVal(*(t[perm] for t in data))
    return data[perm]


def stage_scan(aggs: Sequence, mode: str, s_ops, s_vals, s_live,
               orig_index=None):
    """Segment starts where any key operand differs from the row before
    (on live rows), then the aggregates over the segments. Returns (the
    segments, the flat list of per-group (data, validity) partials).
    ``orig_index``: each sorted row's position in the input."""
    n = s_live.shape[0]
    differs = torch.zeros(n, dtype=torch.bool, device=s_live.device)
    for op in s_ops:
        differs[1:] |= torch.logical_not(operands_equal(op[1:], op[:-1]))
    if n:
        differs[0] = True
    seg = SortedSegments(torch.logical_and(differs, s_live), s_live,
                         orig_index)
    return seg, _run_aggs(aggs, s_vals, seg, mode)


def stage_pack(seg: SortedSegments, s_keys: List[DVal]):
    """Each group's key columns: (data, validity) at its last row; a
    string key's rectangle rebuilt from its words (a ``StrVal``)."""
    out = []
    for k in s_keys:
        if isinstance(k, _StringOperands):
            words = torch.stack([w[seg.ends] for w in k.words], dim=1)
            out.append((StrVal(unpack_words(words),
                               k.lengths[seg.ends].to(torch.int32)),
                        k.rank[seg.ends] == 0))
        else:
            out.append((k.data[seg.ends], k.validity[seg.ends]))
    return out


def segmented_groupby(keys: List[DVal], vals: List[List[DVal]],
                      aggs: Sequence, mode: str, row_mask: torch.Tensor,
                      row_offset: int = 0):
    """Group the rows where ``row_mask`` holds by ``keys``; mode 'update'
    runs each aggregate's update over ``vals``, 'merge' its merge over
    partial columns. Returns (key outputs [(data, validity)], partial
    outputs [(data, validity)], number of groups), one row per group in
    key order. ``row_offset``: the first row's position in the input."""
    if not keys:
        return [], global_groupby(vals, aggs, mode, row_mask,
                                  row_offset), 1
    s_ops, s_keys, s_vals, s_live, perm = stage_sort(keys, vals, row_mask)
    seg, partials = stage_scan(aggs, mode, s_ops, s_vals, s_live,
                               perm + row_offset)
    return stage_pack(seg, s_keys), partials, seg.num_segments


def _run_aggs(aggs, vals, seg, mode):
    outs = []
    for a, vs in zip(aggs, vals):
        if mode == "update":
            outs.extend(a.update(vs, seg))
        else:
            outs.extend(a.merge(vs, seg))
    return outs
