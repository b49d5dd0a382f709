"""Segmented reductions (port of ``spark_rapids_tpu/columnar/segmented.py``,
the single-segment context a keyless aggregation uses).

``GlobalSegments`` reduces over the rows where ``live`` is True, one
masked vector reduction per call; results are shape-(1,) tensors, as
the reference's are.
"""
from __future__ import annotations

import torch

__all__ = ["GlobalSegments"]


class GlobalSegments:
    def __init__(self, live: torch.Tensor):
        self.live = live

    def sum(self, data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        ok = torch.logical_and(valid, self.live)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return torch.where(ok, data, zero).sum(dtype=data.dtype).reshape(1)

    def count(self, pred: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
        return torch.logical_and(pred, self.live).sum(dtype=dtype).reshape(1)
