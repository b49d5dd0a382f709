"""Columnar vectors on torch tensors (port of
``spark_rapids_tpu/columnar/column.py``).

  * ``DeviceColumn`` -- ``data`` + bool ``validity`` tensors of one length.
    Slots where validity is False (nulls and padding rows) hold the
    dtype's default value, so arithmetic never sees garbage.
  * ``DictColumn`` -- a STRING column as int32 codes into a SORTED host
    dictionary: code order is string order.
  * ``HostColumn`` -- numpy values + validity for a column with no device
    layout (a string column wider than ``rect.maxBytes``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import DataType

__all__ = ["DeviceColumn", "DictColumn", "HostColumn"]


class DeviceColumn:
    __slots__ = ("data", "validity", "dtype")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 dtype: DataType):
        self.data = data
        self.validity = validity
        self.dtype = dtype

    @property
    def padded_len(self) -> int:
        return int(self.data.shape[0])

    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.validity.numel())

    def with_arrays(self, data, validity) -> "DeviceColumn":
        """This column around row-rearranged arrays (compaction);
        subclasses carry their extra state across."""
        return DeviceColumn(data, validity, self.dtype)

    def to_numpy(self, num_rows: int):
        """(values, validity) host arrays truncated to num_rows, values in
        the device representation (DATE as int32 days)."""
        return (self.data[:num_rows].cpu().numpy(),
                self.validity[:num_rows].cpu().numpy())

    def __repr__(self):
        return f"DeviceColumn({self.dtype.name}, padded={self.padded_len})"


class DictColumn(DeviceColumn):
    __slots__ = ("dictionary",)

    def __init__(self, data, validity, dtype: DataType,
                 dictionary: np.ndarray):
        super().__init__(data, validity, dtype)
        self.dictionary = dictionary      # sorted object array of str

    def with_arrays(self, data, validity) -> "DictColumn":
        return DictColumn(data, validity, self.dtype, self.dictionary)

    def to_numpy(self, num_rows: int):
        codes, v = super().to_numpy(num_rows)
        if not len(self.dictionary):
            return np.full(len(codes), "", object), v
        return self.dictionary[np.clip(codes, 0, len(self.dictionary) - 1)], v

    def __repr__(self):
        return (f"DictColumn(card={len(self.dictionary)}, "
                f"padded={self.padded_len})")


class HostColumn:
    __slots__ = ("values", "validity", "dtype")

    def __init__(self, values: np.ndarray, validity: np.ndarray,
                 dtype: DataType):
        self.values = values
        self.validity = validity
        self.dtype = dtype

    @property
    def padded_len(self) -> int:
        return len(self.values)

    def to_numpy(self, num_rows: int):
        return self.values[:num_rows], self.validity[:num_rows]

    def __repr__(self):
        return f"HostColumn({self.dtype.name}, len={len(self.values)})"
