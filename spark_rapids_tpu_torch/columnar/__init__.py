"""Columnar data layer: columns and batches on torch tensors."""
from .batch import (ColumnarBatch, HostTable, batch_from_reference,
                    concat_batches)
from .column import DeviceColumn, DictColumn, HostColumn
from .nested import (HostList, HostMap, HostStruct, ListColumn, MapColumn,
                     StructColumn)
from .strrect import ByteRectColumn

__all__ = ["ColumnarBatch", "HostTable", "batch_from_reference",
           "concat_batches",
           "DeviceColumn", "DictColumn", "HostColumn", "ByteRectColumn",
           "ListColumn", "HostList", "MapColumn", "HostMap", "StructColumn",
           "HostStruct"]
