"""Keyless aggregation core (port of ``spark_rapids_tpu/exec/groupby_core.py``
``global_groupby``; the keyed sort pipeline comes with the q1 slice).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar.segmented import GlobalSegments
from ..exprs.base import DVal

__all__ = ["global_groupby"]


def global_groupby(vals: List[List[DVal]], aggs: Sequence, mode: str,
                   row_mask: torch.Tensor):
    """One segment over the rows where ``row_mask`` holds: every
    aggregate's update (or merge) is a masked vector reduction. Returns
    the flat list of (data[1], validity[1]) partials."""
    seg = GlobalSegments(row_mask)
    outs = []
    for a, vs in zip(aggs, vals):
        if mode == "update":
            outs.extend(a.update(vs, seg, row_mask))
        else:
            outs.extend(a.merge(vs, seg))
    return outs
