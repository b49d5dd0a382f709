"""Device list columns as rectangles (port of
``spark_rapids_tpu/columnar/nested.py``).

An ARRAY of a fixed-width element lives on the device as

  * ``data``        [P, W] element values, zero where no element is
  * ``elem_valid``  [P, W] element validity: False for NULL elements and
                    for the slots at or past each row's length
  * ``lengths``     [P]    int32 per-row lengths, 0 for NULL rows
  * ``validity``    [P]    row validity

with W the smallest of ``WIDTH_BUCKETS`` that holds the longest list.
Collection functions are then ops over axis 1, and rows move as the rows
of the rectangle (gathers, compaction, concatenation at the widest W).

On the host a list column is a ``HostList``: int64 ``offsets`` into flat
``values`` and their ``elem_valid`` (the numpy form of an Arrow
ListArray), beside the table's row validity. Ingest copies the flat
values and offsets and builds the rectangle on the device; the way back
is one packed copy of the rectangle a column, compacted on the host.
A list longer than the widest bucket, or a batch of more than 2^26
element slots, is refused at ingest (``NESTED_REST``): the port has no
host engine to keep it on.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import (NESTED_REST, ArrayType, DATE, DataType, TIMESTAMP,
                     from_numpy_dtype, torch_dtype)
from .column import DeviceColumn, packed_to_host, to_device

__all__ = ["ListColumn", "HostList", "WIDTH_BUCKETS", "MAX_ELEMENT_SLOTS",
           "width_bucket", "list_column", "pad_list"]

#: list widths snap to this ladder (the reference's)
WIDTH_BUCKETS = (4, 8, 16, 32, 64, 128, 256)
#: the most element slots (rows x W) one batch's rectangle may hold
MAX_ELEMENT_SLOTS = 1 << 26


def width_bucket(w: int) -> Optional[int]:
    """The smallest bucket holding ``w`` elements, None past the last."""
    for b in WIDTH_BUCKETS:
        if w <= b:
            return b
    return None


class HostList:
    """A host list column without its row validity: int64 ``offsets``
    (n + 1, absolute into ``values``), the flat element ``values`` and
    their ``elem_valid`` (all valid when not given). ``element`` is the
    element type, by default the values' (``datetime64[D]`` values are
    DATE elements, kept as int32 days). Sliced like an array (the offsets
    slice, the values stay shared)."""

    __slots__ = ("offsets", "values", "elem_valid", "element", "_longest")

    def __init__(self, offsets: np.ndarray, values: np.ndarray,
                 elem_valid: Optional[np.ndarray] = None,
                 element: Optional[DataType] = None):
        values = np.asarray(values)
        if element is None:
            element = from_numpy_dtype(values.dtype)
        if values.dtype.kind == "M":
            unit = "D" if element == DATE else "us"
            values = values.astype(f"datetime64[{unit}]").astype(np.int64) \
                .astype(element.np_dtype)
        self.offsets = np.asarray(offsets, np.int64)
        self.values = values
        self.element = element
        self.elem_valid = np.ones(len(values), bool) \
            if elem_valid is None else np.asarray(elem_valid, bool)
        self._longest = None

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, sl: slice) -> "HostList":
        start, stop, step = sl.indices(len(self))
        assert step == 1, "a HostList slices by a range of rows"
        return HostList(self.offsets[start:max(stop, start) + 1],
                        self.values, self.elem_valid, self.element)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def longest(self) -> int:
        """The most elements any row holds (a NULL row's too), found once
        and kept: a HostList is not changed after it is made."""
        if self._longest is None:
            self._longest = int(self.lengths.max()) if len(self) else 0
        return self._longest

    @property
    def nbytes(self) -> int:
        return self.offsets.nbytes + self.values.nbytes \
            + self.elem_valid.nbytes

    def compact(self) -> "HostList":
        """The same rows with offsets from 0 over only their elements."""
        lo, hi = int(self.offsets[0]), int(self.offsets[-1])
        return HostList(self.offsets - lo, self.values[lo:hi],
                        self.elem_valid[lo:hi], self.element)

    @staticmethod
    def concat(parts: Sequence["HostList"]) -> "HostList":
        parts = [p.compact() for p in parts]
        base = np.cumsum([0] + [len(p.values) for p in parts[:-1]])
        return HostList(
            np.concatenate([parts[0].offsets[:1]]
                           + [p.offsets[1:] + b
                              for p, b in zip(parts, base)]),
            np.concatenate([p.values for p in parts]),
            np.concatenate([p.elem_valid for p in parts]), parts[0].element)

    @staticmethod
    def from_pylist(rows, element: Optional[DataType] = None):
        """(HostList, row validity) of Python lists (None for a NULL row
        or element). The element type is inferred from the values unless
        given (int -> bigint, float -> double)."""
        valid = np.array([r is not None for r in rows], bool)
        lens = np.array([len(r) if r is not None else 0 for r in rows],
                        np.int64)
        flat = [x for r in rows if r is not None for x in r]
        ev = np.array([x is not None for x in flat], bool)
        if element is None:
            seen = [x for x in flat if x is not None]
            element = from_numpy_dtype(np.asarray(seen).dtype) if seen \
                else from_numpy_dtype(np.int64)
        np_dt = element.np_dtype
        if element == DATE:
            vals = np.array([int(np.datetime64(x, "D").astype(np.int64))
                             if x is not None else 0 for x in flat], np_dt)
        elif element == TIMESTAMP:
            vals = np.array([int(np.datetime64(x, "us").astype(np.int64))
                             if x is not None else 0 for x in flat], np_dt)
        else:
            vals = np.array([x if x is not None else 0 for x in flat],
                            np_dt)
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        return HostList(offsets, vals, ev, element), valid

    @staticmethod
    def from_arrow(arr):
        """(HostList, row validity) of an Arrow ListArray (pyarrow is
        imported by the caller, which holds the array)."""
        import pyarrow as pa
        from ..types import from_arrow
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        element = from_arrow(arr.type.value_type)
        if element.np_dtype is None:
            raise NotImplementedError(
                f"a list of {element.name} has no device layout; it "
                f"arrives with {NESTED_REST}")
        valid = ~np.asarray(arr.is_null())
        flat = arr.values
        ev = ~np.asarray(flat.is_null())
        if element == DATE:
            flat = flat.cast(pa.int32())
        elif element == TIMESTAMP:
            flat = flat.cast(pa.int64())
        fill = False if element.np_dtype == np.bool_ else 0
        vals = flat.fill_null(fill).to_numpy(zero_copy_only=False) \
            .astype(element.np_dtype, copy=False)
        return HostList(np.asarray(arr.offsets), vals, ev, element), valid

    def to_pylist(self, valid: np.ndarray, element: DataType) -> list:
        from ..api.dataframe import _py_values
        py = _py_values(self.values, self.elem_valid, element)
        off = self.offsets
        return [py[off[i]:off[i + 1]] if ok else None
                for i, ok in enumerate(valid.tolist())]

    def to_arrow(self, valid: np.ndarray, element: DataType):
        import pyarrow as pa
        from ..types import to_arrow
        c = self.compact()
        vals = pa.array(c.values, mask=~c.elem_valid)
        if element == DATE:
            vals = vals.cast(pa.int32()).cast(pa.date32())
        else:
            vals = vals.cast(to_arrow(element))
        offs = pa.array(c.offsets.astype(np.int32),
                        mask=np.concatenate([~valid, [False]]))
        return pa.ListArray.from_arrays(offs, vals)

    def __repr__(self):
        return f"HostList(rows={len(self)}, elements={len(self.values)})"


class ListColumn(DeviceColumn):
    """A list column on the device in the rectangle layout (module doc)."""

    __slots__ = ("elem_valid", "lengths")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 dtype: ArrayType, elem_valid: torch.Tensor,
                 lengths: torch.Tensor):
        super().__init__(data, validity, dtype)
        self.elem_valid = elem_valid
        self.lengths = lengths

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.elem_valid.numel() + self.validity.numel()
                + 4 * self.lengths.numel())

    def with_arrays(self, data, validity):
        raise TypeError("ListColumn rows move with their element validity "
                        "and lengths: use gather()")

    def gather(self, idx: torch.Tensor) -> "ListColumn":
        return ListColumn(self.data[idx], self.validity[idx], self.dtype,
                          self.elem_valid[idx], self.lengths[idx])

    def slice(self, start: int, stop: int) -> "ListColumn":
        return ListColumn(self.data[start:stop], self.validity[start:stop],
                          self.dtype, self.elem_valid[start:stop],
                          self.lengths[start:stop])

    def to_numpy(self, num_rows: int) -> Tuple[HostList, np.ndarray]:
        """(HostList, row validity) of the first ``num_rows`` rows: the
        rectangle comes back in one packed copy and is compacted here."""
        n = num_rows
        vals, ev, lens, rv = packed_to_host([
            self.data[:n], self.elem_valid[:n], self.lengths[:n],
            self.validity[:n]])
        lens = np.where(rv, lens, 0).astype(np.int64)
        inside = np.arange(self.width)[None, :] < lens[:, None]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        return HostList(offsets, vals[inside], ev[inside],
                        self.dtype.element), rv

    def __repr__(self):
        return (f"ListColumn({self.dtype.element.name}[{self.width}], "
                f"padded={self.padded_len})")


def list_column(values: torch.Tensor, elem_valid: torch.Tensor,
                lengths: torch.Tensor, validity: torch.Tensor,
                dtype: ArrayType) -> ListColumn:
    """A ListColumn in the layout's canonical form: a NULL row has length
    0, slots at or past a row's length are not valid, and every slot that
    is not valid holds 0."""
    lengths = torch.where(validity, lengths.to(torch.int32), 0)
    w = values.shape[1]
    inside = torch.arange(w, device=values.device)[None, :] \
        < lengths[:, None]
    ev = torch.logical_and(elem_valid, inside)
    data = torch.where(ev, values, torch.zeros((), dtype=values.dtype,
                                               device=values.device))
    return ListColumn(data, validity, dtype, ev, lengths)


def pad_list(col: ListColumn, width: int) -> ListColumn:
    """``col`` widened to ``width`` slots (at least its own)."""
    if width == col.width:
        return col
    if width < col.width:
        raise ValueError(f"a list column of width {col.width} cannot pad "
                         f"to {width}")
    pad = (0, width - col.width)
    return ListColumn(torch.nn.functional.pad(col.data, pad),
                      col.validity, col.dtype,
                      torch.nn.functional.pad(col.elem_valid, pad),
                      col.lengths)


def to_device_list(hl: HostList, valid: np.ndarray, dtype: ArrayType,
                   device, what: str = "a list column") -> ListColumn:
    """A ``HostList`` and its row validity as a ListColumn on ``device``:
    the flat values and offsets are copied, the rectangle is built there
    (a row's elements scattered into its row; a NULL row's and any
    element past W into a slot that is cut off). Refuses a list past the
    widest bucket or a rectangle past ``MAX_ELEMENT_SLOTS``."""
    n = len(hl)
    lens = np.where(valid, hl.lengths, 0)
    longest = int(lens.max()) if n else 0
    w = width_bucket(max(longest, 1))
    if w is None or w * n > MAX_ELEMENT_SLOTS:
        raise NotImplementedError(
            f"{what}: a list of {longest} elements over {n} rows exceeds "
            f"the device rectangle (at most {WIDTH_BUCKETS[-1]} elements a "
            f"list and {MAX_ELEMENT_SLOTS} slots a batch); longer lists "
            f"arrive with {NESTED_REST}")
    c = hl.compact()
    tdt = torch_dtype(dtype.element)
    raw = to_device(c.lengths, device)
    total = len(c.values)
    vals = to_device(c.values.astype(dtype.element.np_dtype, copy=False),
                   device)
    ev = to_device(c.elem_valid, device)
    rv = to_device(valid, device)
    data = torch.zeros((n, w + 1), dtype=tdt, device=device)
    evr = torch.zeros((n, w + 1), dtype=torch.bool, device=device)
    if total:
        row = torch.repeat_interleave(
            torch.arange(n, device=device), raw, output_size=total)
        start = torch.cumsum(raw, 0) - raw
        pos = torch.arange(total, device=device) - start[row]
        pos = torch.where(torch.logical_and(rv[row], pos < w), pos, w)
        data[row, pos] = vals
        evr[row, pos] = ev
    return list_column(data[:, :w], evr[:, :w],
                       to_device(lens.astype(np.int32), device), rv, dtype)


def concat_lists(parts: List[ListColumn], rows: List[int]) -> ListColumn:
    """List columns' first ``rows`` rows, in order, at the widest W."""
    w = max(p.width for p in parts)
    parts = [pad_list(p.slice(0, n), w) for p, n in zip(parts, rows)]
    return ListColumn(torch.cat([p.data for p in parts]),
                      torch.cat([p.validity for p in parts]),
                      parts[0].dtype,
                      torch.cat([p.elem_valid for p in parts]),
                      torch.cat([p.lengths for p in parts]))
