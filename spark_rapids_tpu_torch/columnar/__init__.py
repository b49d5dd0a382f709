"""Columnar data layer: columns and batches on torch tensors."""
from .batch import ColumnarBatch, HostTable, batch_from_reference
from .column import DeviceColumn, DictColumn, HostColumn
from .strrect import ByteRectColumn

__all__ = ["ColumnarBatch", "HostTable", "batch_from_reference",
           "DeviceColumn", "DictColumn", "HostColumn", "ByteRectColumn"]
