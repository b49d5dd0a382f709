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
    NormalizeFloatingNumbers).

Results come back one row per group, in key order. The dense path for
dictionary keys is ``exec/dense_groupby.py``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar.segmented import GlobalSegments, SortedSegments
from ..exprs.base import DVal
from .encoding import (canonicalize_floats, grouping_operands,
                       lexsort_permutation, operands_equal)

__all__ = ["global_groupby", "segmented_groupby", "stage_sort",
           "stage_scan", "stage_pack"]


def global_groupby(vals: List[List[DVal]], aggs: Sequence, mode: str,
                   row_mask: torch.Tensor):
    """One segment over the rows where ``row_mask`` holds: every
    aggregate's update (or merge) is a masked vector reduction. Returns
    the flat list of (data[1], validity[1]) partials."""
    return _run_aggs(aggs, vals, GlobalSegments(row_mask), mode)


def stage_sort(keys: List[DVal], vals: List[List[DVal]],
               row_mask: torch.Tensor):
    """Sort the rows by the keys' grouping operands, live rows first.
    Returns (sorted operands, sorted keys, sorted values, sorted live
    mask)."""
    pad_flag = torch.logical_not(row_mask).to(torch.uint8)
    operands = [pad_flag]
    for k in keys:
        operands.extend(grouping_operands(k))
    perm = lexsort_permutation(operands)
    s_ops = [op[perm] for op in operands[1:]]
    s_keys = [DVal((canonicalize_floats(k.data) if k.data.is_floating_point()
                    else k.data)[perm], k.validity[perm], k.dtype)
              for k in keys]
    s_vals = [[DVal(v.data[perm], v.validity[perm], v.dtype) for v in vs]
              for vs in vals]
    return s_ops, s_keys, s_vals, row_mask[perm]


def stage_scan(aggs: Sequence, mode: str, s_ops, s_vals, s_live):
    """Segment starts where any key operand differs from the row before
    (on live rows), then the aggregates over the segments. Returns (the
    segments, the flat list of per-group (data, validity) partials)."""
    n = s_live.shape[0]
    differs = torch.zeros(n, dtype=torch.bool, device=s_live.device)
    for op in s_ops:
        differs[1:] |= torch.logical_not(operands_equal(op[1:], op[:-1]))
    if n:
        differs[0] = True
    seg = SortedSegments(torch.logical_and(differs, s_live), s_live)
    return seg, _run_aggs(aggs, s_vals, seg, mode)


def stage_pack(seg: SortedSegments, s_keys: List[DVal]):
    """Each group's key columns: (data, validity) at its last row."""
    return [(k.data[seg.ends], k.validity[seg.ends]) for k in s_keys]


def segmented_groupby(keys: List[DVal], vals: List[List[DVal]],
                      aggs: Sequence, mode: str, row_mask: torch.Tensor):
    """Group the rows where ``row_mask`` holds by ``keys``; mode 'update'
    runs each aggregate's update over ``vals``, 'merge' its merge over
    partial columns. Returns (key outputs [(data, validity)], partial
    outputs [(data, validity)], number of groups), one row per group in
    key order."""
    if not keys:
        return [], global_groupby(vals, aggs, mode, row_mask), 1
    s_ops, s_keys, s_vals, s_live = stage_sort(keys, vals, row_mask)
    seg, partials = stage_scan(aggs, mode, s_ops, s_vals, s_live)
    return stage_pack(seg, s_keys), partials, seg.num_segments


def _run_aggs(aggs, vals, seg, mode):
    outs = []
    for a, vs in zip(aggs, vals):
        if mode == "update":
            outs.extend(a.update(vs, seg))
        else:
            outs.extend(a.merge(vs, seg))
    return outs
