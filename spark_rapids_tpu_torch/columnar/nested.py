"""Device list, map and struct columns (port of
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
compacts the rectangle's slots on the device and brings them, the
lengths and the row validity back in one packed copy a column.
A list longer than the widest bucket, or a batch of more than 2^26
element slots, is refused at ingest (``NESTED_REST``): the port has no
host engine to keep it on.

A MAP is what Arrow and Spark make it, a list of ``struct<key, value>``:
a ``MapColumn`` is two list rectangles, the keys' and the values', over
one ``lengths`` and one row validity (keys are never NULL).
``map_entries``' result is a list of ``struct<key, value>`` (below).
On the host a ``HostMap`` is the two ``HostList``s over one offsets.

A STRUCT is its fields' device columns (numbers, dates, dictionary or
byte-rectangle strings, lists, maps, structs) and a row validity: a
``StructColumn``. A field keeps its own validity; a NULL struct row
does not null its fields' slots, ``get_field`` does (exprs/). On the
host a ``HostStruct`` is a ``HostTable`` of its fields.

Every device column is a list of tensors a row (``parts``) and a
``meta`` to rebuild it from them (``from_parts``): rows of any column
move by moving each tensor (``take_rows``, ``slice_rows``, ``null_rows``),
a spilled batch keeps the tensors and the meta (mem/spillable.py), and
a struct comes back to the host in one packed copy
(``to_host_column``).

An ARRAY (or a map's keys or values) of an element with no fixed width
-- a STRING, or a STRUCT of fixed-width and string fields -- keeps its
elements as ``Slots``: a flat device column of P·W rows, slot (i, j) at
row i·W + j, in the layout ingest gives such a column: dictionary codes
with one sorted dictionary, or a byte rectangle [P·W, B] with each
element's byte length (columnar/strrect.py), or a struct of those. The
flat column is what a lambda binds and what ``rect_match`` and
``rect_transform`` take, with no copy; its tensors viewed [P, W, ...]
are the list's parts, so its rows move, spill and concatenate as any
list's do (``slot_*`` below are the slot ops over either form). Strings
order by their dictionary codes, or by the rank of their packed words
in the batch (``slot_key``). On the host such a list keeps its
elements as ``HostStrings`` (or ``str`` objects) or a ``HostStruct``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import (NESTED_REST, NULLTYPE, STRING, ArrayType, DATE,
                     DataType, MapType, StructType, TIMESTAMP,
                     from_numpy_dtype, map_parts, nested_reason, torch_dtype)
from .column import DeviceColumn, DictColumn, packed_to_host, to_device

__all__ = ["ListColumn", "HostList", "WIDTH_BUCKETS", "MAX_ELEMENT_SLOTS",
           "width_bucket", "list_column", "pad_list", "MapColumn",
           "StructColumn", "HostMap", "HostStruct", "map_column", "parts",
           "from_parts", "take_rows", "slice_rows", "null_rows",
           "to_host_column", "concat_maps", "zero_rows", "Slots",
           "slot_take", "slot_rows", "slot_zero", "slot_pad", "slot_pick",
           "slot_key", "slot_hcat", "flat_key", "joint_keys",
           "elem_torch_dtype", "too_long", "with_validity"]

#: list widths snap to this ladder (the reference's)
WIDTH_BUCKETS = (4, 8, 16, 32, 64, 128, 256)
#: the most element slots (rows x W) one batch's rectangle may hold
MAX_ELEMENT_SLOTS = 1 << 26


def too_long(what: str, longest: int, rows: int = 0) -> NotImplementedError:
    """The refusal of a list past the rectangle's caps, naming the
    queue."""
    over = f" over {rows} rows" if rows else ""
    return NotImplementedError(
        f"{what}: a list of {longest} elements{over} exceeds the device "
        f"rectangle (at most {WIDTH_BUCKETS[-1]} elements a list and "
        f"{MAX_ELEMENT_SLOTS} slots a batch); longer lists arrive with "
        f"{NESTED_REST}")


def elem_torch_dtype(dt: DataType) -> torch.dtype:
    """The torch dtype of a fixed-width element's slots (a NULL-typed
    element, as in ``array()``, keeps int8 zeros)."""
    return torch.int8 if dt == NULLTYPE else torch_dtype(dt)


def width_bucket(w: int) -> Optional[int]:
    """The smallest bucket holding ``w`` elements, None past the last."""
    for b in WIDTH_BUCKETS:
        if w <= b:
            return b
    return None


def _host_elements(values):
    """A list's flat host elements as they are kept: ``HostStrings``, a
    ``HostStruct`` or an object array as given, anything else a numpy
    array."""
    from .strrect import HostStrings
    if isinstance(values, (HostStrings, HostStruct)):
        return values
    return np.asarray(values)


def _element_type(values) -> DataType:
    from .strrect import HostStrings
    if isinstance(values, HostStrings):
        return STRING
    if isinstance(values, HostStruct):
        return values.dtype
    return from_numpy_dtype(values.dtype)


class HostList:
    """A host list column without its row validity: int64 ``offsets``
    (n + 1, absolute into ``values``), the flat element ``values`` and
    their ``elem_valid`` (all valid when not given). ``element`` is the
    element type, by default the values' (``datetime64[D]`` values are
    DATE elements, kept as int32 days; an ``S``/``U``/object array or a
    ``HostStrings`` holds STRING elements, a ``HostStruct`` STRUCT
    ones). Sliced like an array (the offsets slice, the values stay
    shared)."""

    __slots__ = ("offsets", "values", "elem_valid", "element", "_longest")

    def __init__(self, offsets: np.ndarray, values,
                 elem_valid: Optional[np.ndarray] = None,
                 element: Optional[DataType] = None):
        values = _host_elements(values)
        if element is None:
            element = _element_type(values)
        if isinstance(values, np.ndarray) and values.dtype.kind == "M":
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
        from .batch import _concat_values
        parts = [p.compact() for p in parts]
        base = np.cumsum([0] + [len(p.values) for p in parts[:-1]])
        return HostList(
            np.concatenate([parts[0].offsets[:1]]
                           + [p.offsets[1:] + b
                              for p, b in zip(parts, base)]),
            _concat_values([p.values for p in parts]),
            np.concatenate([p.elem_valid for p in parts]), parts[0].element)

    @staticmethod
    def from_pylist(rows, element: Optional[DataType] = None):
        """(HostList, row validity) of Python lists (None for a NULL row
        or element). The element type is inferred from the values unless
        given (int -> bigint, float -> double, str -> string, a dict of
        string keys -> a struct of its values' types)."""
        valid = np.array([r is not None for r in rows], bool)
        lens = np.array([len(r) if r is not None else 0 for r in rows],
                        np.int64)
        flat = [x for r in rows if r is not None for x in r]
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        seen = [x for x in flat if x is not None]
        if any(isinstance(x, (list, tuple)) for x in seen):
            raise NotImplementedError(
                f"a list of lists has no device layout; it arrives with "
                f"{NESTED_REST}")
        if (element is None or isinstance(element, StructType)) and seen \
                and all(isinstance(x, dict) for x in seen):
            vals, ev = HostStruct.from_pylist(flat)
            return HostList(offsets, vals, ev), valid
        ev = np.array([x is not None for x in flat], bool)
        if element is None:
            element = from_numpy_dtype(np.asarray(seen).dtype) if seen \
                else from_numpy_dtype(np.int64)
        if element == STRING:
            vals = np.array([x if x is not None else "" for x in flat],
                            object)
            return HostList(offsets, vals, ev, STRING), valid
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
        r = nested_reason(ArrayType(element))
        if r:
            raise NotImplementedError(f"a list of {element.name} has no "
                                      f"device layout: {r}")
        valid = ~np.asarray(arr.is_null())
        vals, ev = _flat_values(arr.values, element)
        return HostList(np.asarray(arr.offsets), vals, ev, element), valid

    def to_pylist(self, valid: np.ndarray, element: DataType) -> list:
        from ..api.dataframe import _py_values
        py = _py_values(self.values, self.elem_valid, element)
        off = self.offsets
        return [py[off[i]:off[i + 1]] if ok else None
                for i, ok in enumerate(valid.tolist())]

    def to_arrow(self, valid: np.ndarray, element: DataType):
        import pyarrow as pa
        from ..api.dataframe import _arrow_values
        c = self.compact()
        vals = _arrow_values(c.values, c.elem_valid, element)
        offs = pa.array(c.offsets.astype(np.int32),
                        mask=np.concatenate([~valid, [False]]))
        return pa.ListArray.from_arrays(offs, vals)

    def __repr__(self):
        return f"HostList(rows={len(self)}, elements={len(self.values)})"


def _flat_values(flat, element: DataType):
    """(values in the device representation, validity) of a flat Arrow
    array of a fixed-width, string or struct ``element``."""
    import pyarrow as pa
    ev = ~np.asarray(flat.is_null())
    if isinstance(element, StructType):
        return HostStruct.from_arrow(flat)
    if element == STRING:
        vals = flat.fill_null("").to_numpy(zero_copy_only=False) \
            .astype(object)
        return vals, ev
    if element == NULLTYPE:
        return np.zeros(len(flat), np.int8), ev
    if element == DATE:
        flat = flat.cast(pa.int32())
    elif element == TIMESTAMP:
        flat = flat.cast(pa.int64())
    fill = False if element.np_dtype == np.bool_ else 0
    vals = flat.fill_null(fill).to_numpy(zero_copy_only=False) \
        .astype(element.np_dtype, copy=False)
    return vals, ev


class Slots:
    """The elements of a [P, W] list rectangle that have no fixed width
    (strings, structs): a flat device column ``col`` of P·W rows, slot
    (i, j) at row i·W + j (module doc)."""

    __slots__ = ("col", "width")

    def __init__(self, col, width: int):
        self.col = col
        self.width = int(width)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.col.padded_len // self.width, self.width)

    @property
    def device(self):
        return self.col.validity.device

    def nbytes(self) -> int:
        return self.col.nbytes()

    def map(self, fn) -> "Slots":
        """``fn`` over each tensor of the column viewed [P, W, ...], giving
        [P', W', ...]: the slots rearranged."""
        p, w = self.shape
        tensors, meta = parts(self.col)
        out = [fn(t.reshape((p, w) + tuple(t.shape[1:]))) for t in tensors]
        p2, w2 = out[0].shape[:2]
        return Slots(from_parts(meta, self.col.dtype, iter(
            t.reshape((p2 * w2,) + tuple(t.shape[2:])) for t in out)), w2)

    def __repr__(self):
        return f"Slots({self.col!r}, width={self.width})"


def slot_take(values, idx: torch.Tensor):
    """Each row's slots ``idx`` ([P, W'], in [0, W))."""
    if isinstance(values, Slots):
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        return values.map(lambda t: t[rows, idx])
    return values.gather(1, idx)


def slot_rows(values, idx: torch.Tensor):
    """Rows ``idx`` of the rectangle."""
    if isinstance(values, Slots):
        return values.map(lambda t: t[idx])
    return values[idx]


def slot_zero(values, keep: torch.Tensor):
    """The slots where ``keep`` [P, W] is False zeroed (a NULL string
    element of length 0, a NULL struct)."""
    if isinstance(values, Slots):
        def z(t):
            k = keep.reshape(tuple(keep.shape) + (1,) * (t.dim() - 2))
            return torch.where(k, t, torch.zeros((), dtype=t.dtype,
                                                 device=t.device))
        return values.map(z)
    return torch.where(keep, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))


def slot_pad(values, width: int):
    """The rectangle widened to ``width`` slots with zeros."""
    w = values.shape[1]
    if width == w:
        return values
    if isinstance(values, Slots):
        return values.map(lambda t: torch.cat([t, t.new_zeros(
            (t.shape[0], width - w) + tuple(t.shape[2:]))], 1))
    return torch.nn.functional.pad(values, (0, width - w))


def slot_pick(values, rows: torch.Tensor, j: torch.Tensor):
    """The slots (rows[k], j[k]) (in range): a tensor, or a flat column
    for ``Slots``."""
    if isinstance(values, Slots):
        return take_rows(values.col, rows * values.width + j)
    return values[rows, j]


def slot_hcat(parts_: Sequence):
    """Rectangles of one row count side by side: the slots of the first,
    then of the second, ... (their columns merged as concatenation
    merges them: one dictionary, the widest byte rectangle)."""
    if not isinstance(parts_[0], Slots):
        return torch.cat(list(parts_), dim=1)
    from .batch import _concat_column
    p = parts_[0].shape[0]
    ws = [x.width for x in parts_]
    col = _concat_column([x.col for x in parts_], [p * w for w in ws],
                         None)
    dev = parts_[0].device
    w = sum(ws)
    idx = torch.empty((p, w), dtype=torch.int64, device=dev)
    base = col_base = 0
    for x in ws:
        idx[:, base:base + x] = col_base + torch.arange(
            p, device=dev)[:, None] * x + torch.arange(x, device=dev)[None, :]
        base += x
        col_base += p * x
    return Slots(take_rows(col, idx.reshape(-1)), w)


def flat_key(c) -> torch.Tensor:
    """int64 per row of a flat column, whose ``==`` and order are Spark's
    for its values (NULLs aside): a number's order key, a dictionary
    string's code, a byte string's rank among the column's values (by
    its packed words, then its length), a struct's rank by its fields in
    order, a NULL field first."""
    from ..exprs.collection_fns import element_key
    from .strrect import ByteRectColumn, pack_words
    if isinstance(c, StructColumn):
        cols = []
        for f in c.children:
            cols.append((~f.validity).to(torch.int64))
            cols.append(torch.where(f.validity, flat_key(f), 0))
        if not cols:
            return torch.zeros(c.padded_len, dtype=torch.int64,
                               device=c.validity.device)
        return _rank(torch.stack(cols, dim=1))
    if isinstance(c, ByteRectColumn):
        words = pack_words(c.data)
        return _rank(torch.cat([words, c.lengths.to(torch.int64)[:, None]],
                               dim=1))
    if isinstance(c, DictColumn):
        return c.data.to(torch.int64)
    return element_key(c.data).to(torch.int64)


def _rank(rows: torch.Tensor) -> torch.Tensor:
    """Each row's rank among the distinct rows of ``rows`` [N, K] int64 in
    lexicographic order."""
    if not rows.shape[0]:
        return torch.zeros(0, dtype=torch.int64, device=rows.device)
    return torch.unique(rows, dim=0, return_inverse=True)[1]


def slot_key(values) -> torch.Tensor:
    """[P, W] keys whose ``==`` and order are Spark's for the elements
    (``flat_key``; a fixed-width element's ``element_key``)."""
    if isinstance(values, Slots):
        return flat_key(values.col).reshape(values.shape)
    from ..exprs.collection_fns import element_key
    return element_key(values)


def joint_keys(values: Sequence) -> List[torch.Tensor]:
    """``slot_key`` of several rectangles (or flat columns, a needle a
    row) over one ordering, so that keys compare across them: their
    elements ranked together."""
    from ..exprs.collection_fns import element_key
    if not any(isinstance(v, Slots) or isinstance(v, DeviceColumn)
               for v in values):
        common = values[0].dtype
        for v in values[1:]:
            common = torch.promote_types(common, v.dtype)
        return [element_key(v.to(common)) for v in values]
    from .batch import _concat_column
    cols = [v.col if isinstance(v, Slots) else v for v in values]
    rows = [c.padded_len for c in cols]
    key = flat_key(_concat_column(cols, rows, None))
    out, pos = [], 0
    for v, n in zip(values, rows):
        k = key[pos:pos + n]
        out.append(k.reshape(v.shape) if isinstance(v, Slots) else k)
        pos += n
    return out


class ListColumn(DeviceColumn):
    """A list column on the device in the rectangle layout (module doc):
    ``data`` is the [P, W] tensor of fixed-width elements, or the
    ``Slots`` of strings or structs."""

    __slots__ = ("elem_valid", "lengths")

    def __init__(self, data, validity: torch.Tensor,
                 dtype: ArrayType, elem_valid: torch.Tensor,
                 lengths: torch.Tensor):
        super().__init__(data, validity, dtype)
        self.elem_valid = elem_valid
        self.lengths = lengths

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    def nbytes(self) -> int:
        d = self.data
        size = d.nbytes() if isinstance(d, Slots) \
            else d.numel() * d.element_size()
        return (size + self.elem_valid.numel() + self.validity.numel()
                + 4 * self.lengths.numel())

    def with_arrays(self, data, validity):
        raise TypeError("ListColumn rows move with their element validity "
                        "and lengths: use take_rows()")

    def to_numpy(self, num_rows: int) -> Tuple[HostList, np.ndarray]:
        """(HostList, row validity) of the first ``num_rows`` rows: the
        slots inside each row, compacted on the device, come back in one
        packed copy with the lengths and the row validity (strings or
        structs: their flat column's copy, then that one)."""
        n = num_rows
        inside, lens = _inside(self.lengths[:n], self.validity[:n],
                               self.width)
        if isinstance(self.data, Slots):
            idx = torch.nonzero(inside.reshape(-1), as_tuple=True)[0]
            lens, rv = packed_to_host([lens, self.validity[:n]])
            elems = take_rows(self.data.col, idx)
            vals, ev = to_host_column(elems, len(idx)).to_numpy(len(idx))
            return HostList(_offsets(lens), vals, ev, self.dtype.element), rv
        vals, ev, lens, rv = packed_to_host([
            self.data[:n][inside], self.elem_valid[:n][inside], lens,
            self.validity[:n]])
        return HostList(_offsets(lens), vals, ev, self.dtype.element), rv

    def __repr__(self):
        return (f"ListColumn({self.dtype.element.name}[{self.width}], "
                f"padded={self.padded_len})")


def _inside(lengths: torch.Tensor, validity: torch.Tensor, width: int):
    """(the slots inside each row [n, width], each row's length: 0 for a
    NULL row), on the device."""
    lens = torch.where(validity, lengths, 0)
    inside = torch.arange(width, device=lens.device)[None, :] \
        < lens[:, None]
    return inside, lens


def _offsets(lens: np.ndarray) -> np.ndarray:
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return offsets


def list_column(values, elem_valid: torch.Tensor,
                lengths: torch.Tensor, validity: torch.Tensor,
                dtype: ArrayType) -> ListColumn:
    """A ListColumn in the layout's canonical form: a NULL row has length
    0, slots at or past a row's length are not valid, and every slot that
    is not valid holds 0."""
    lengths = torch.where(validity, lengths.to(torch.int32), 0)
    w = values.shape[1]
    inside = torch.arange(w, device=validity.device)[None, :] \
        < lengths[:, None]
    ev = torch.logical_and(elem_valid, inside)
    return ListColumn(slot_zero(values, ev), validity, dtype, ev, lengths)


def pad_list(col: ListColumn, width: int) -> ListColumn:
    """``col`` widened to ``width`` slots (at least its own)."""
    if width == col.width:
        return col
    if width < col.width:
        raise ValueError(f"a list column of width {col.width} cannot pad "
                         f"to {width}")
    return ListColumn(slot_pad(col.data, width), col.validity, col.dtype,
                      torch.nn.functional.pad(col.elem_valid,
                                              (0, width - col.width)),
                      col.lengths)


def _slot_of_elements(c: HostList, valid: np.ndarray, n: int, w: int,
                      device):
    """(each flat element's row, its slot in the rectangle: ``w`` for one
    that is cut off -- a NULL row's, or one past ``w``), on the device."""
    raw = to_device(c.lengths, device)
    total = len(c.values)
    rv = to_device(valid, device)
    row = torch.repeat_interleave(
        torch.arange(n, device=device), raw, output_size=total)
    start = torch.cumsum(raw, 0) - raw
    pos = torch.arange(total, device=device) - start[row]
    return row, torch.where(torch.logical_and(rv[row], pos < w), pos, w)


def to_device_list(hl: HostList, valid: np.ndarray, dtype: ArrayType,
                   device, what: str = "a list column",
                   rect_cap: int = 64) -> ListColumn:
    """A ``HostList`` and its row validity as a ListColumn on ``device``:
    the flat values and offsets are copied, the rectangle is built there
    (a row's elements scattered into its row; a NULL row's and any
    element past W into a slot that is cut off). Strings and structs
    are laid out first as a flat column of the elements (as ingest lays
    out a column: dictionary codes, or a byte rectangle up to
    ``rect_cap`` bytes wide), then gathered into their slots. Refuses a
    list past the widest bucket or a rectangle past
    ``MAX_ELEMENT_SLOTS``."""
    n = len(hl)
    lens = np.where(valid, hl.lengths, 0)
    longest = int(lens.max()) if n else 0
    w = width_bucket(max(longest, 1))
    if w is None or w * n > MAX_ELEMENT_SLOTS:
        raise too_long(what, longest, n)
    c = hl.compact()
    rv = to_device(valid, device)
    total = len(c.values)
    lengths = to_device(lens.astype(np.int32), device)
    if dtype.element.np_dtype is None and dtype.element != NULLTYPE:
        flat = _flat_device_column(c.values, c.elem_valid, dtype.element,
                                   device, rect_cap, what)
        src = torch.full((n * w + 1,), -1, dtype=torch.int64, device=device)
        if total:
            row, pos = _slot_of_elements(c, valid, n, w, device)
            src[torch.where(pos < w, row * w + pos, n * w)] = torch.arange(
                total, device=device)
        src = src[:n * w]
        taken = take_rows(flat, src.clamp(min=0)) if total \
            else zero_rows(flat, n * w)
        ev = (src >= 0).reshape(n, w) & to_device(
            c.elem_valid, device)[src.clamp(min=0)].reshape(n, w) \
            if total else torch.zeros((n, w), dtype=torch.bool,
                                      device=device)
        return list_column(Slots(null_rows(taken, ev.reshape(-1)), w), ev,
                           lengths, rv, dtype)
    tdt = elem_torch_dtype(dtype.element)
    vals = to_device(np.asarray(c.values).astype(
        str(tdt).replace("torch.", ""), copy=False), device)
    ev = to_device(c.elem_valid, device)
    data = torch.zeros((n, w + 1), dtype=tdt, device=device)
    evr = torch.zeros((n, w + 1), dtype=torch.bool, device=device)
    if total:
        row, pos = _slot_of_elements(c, valid, n, w, device)
        data[row, pos] = vals
        evr[row, pos] = ev
    return list_column(data[:, :w], evr[:, :w], lengths, rv, dtype)


def _flat_device_column(values, elem_valid: np.ndarray, element: DataType,
                        device, rect_cap: int, what: str):
    """A list's flat host elements as a device column, laid out as ingest
    lays out a column of their type; refused, naming the queue, where a
    string is past the byte rectangle's ``rect_cap`` bytes (or, not
    being ASCII, has no device form here)."""
    from .batch import ColumnarBatch, HostTable
    from .column import HostColumn
    from ..types import Schema, StructField
    table = HostTable({"e": (values, elem_valid)},
                      Schema([StructField("e", element)]))
    col = ColumnarBatch.from_host(table, device, rect_cap,
                                  encode=False).columns[0]
    if isinstance(col, HostColumn):
        raise NotImplementedError(
            f"{what}: a string element past the byte rectangle's "
            f"{rect_cap} bytes (spark.rapids.tpu.sql.string.rect.maxBytes) "
            f"arrives with {NESTED_REST}")
    return col


def concat_lists(parts: List[ListColumn], rows: List[int]) -> ListColumn:
    """List columns' first ``rows`` rows, in order, at the widest W
    (strings and structs: their flat columns concatenated as columns
    are, dictionaries merged and byte rectangles widened)."""
    w = max(p.width for p in parts)
    parts = [pad_list(slice_rows(p, 0, n), w) for p, n in zip(parts, rows)]
    if isinstance(parts[0].data, Slots):
        from .batch import _concat_column
        data = Slots(_concat_column([p.data.col for p in parts],
                                    [n * w for n in rows], None), w)
    else:
        data = torch.cat([p.data for p in parts])
    return ListColumn(data, torch.cat([p.validity for p in parts]),
                      parts[0].dtype,
                      torch.cat([p.elem_valid for p in parts]),
                      torch.cat([p.lengths for p in parts]))


# ---------------------------------------------------------------------------
# maps: two list rectangles over one lengths and row validity
# ---------------------------------------------------------------------------

def _key_value_types(dtype: DataType):
    kv = map_parts(dtype)
    if kv is None:
        raise TypeError(f"{dtype.name} is not a map")
    return kv


class HostMap:
    """A host map column without its row validity: the keys' and the
    values' ``HostList`` over one int64 ``offsets`` (n + 1). Keys are
    never NULL; ``value_valid`` marks the values that are (all valid when
    not given). Sliced like an array."""

    __slots__ = ("keys", "values")

    def __init__(self, offsets: np.ndarray, keys: np.ndarray,
                 values: np.ndarray,
                 value_valid: Optional[np.ndarray] = None,
                 key_type: Optional[DataType] = None,
                 value_type: Optional[DataType] = None):
        self.keys = HostList(offsets, keys, None, key_type)
        self.values = HostList(offsets, values, value_valid, value_type)

    @staticmethod
    def of(keys: HostList, values: HostList) -> "HostMap":
        m = HostMap.__new__(HostMap)
        m.keys, m.values = keys, values
        return m

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, sl: slice) -> "HostMap":
        return HostMap.of(self.keys[sl], self.values[sl])

    @property
    def dtype(self) -> MapType:
        return MapType(self.keys.element, self.values.element)

    @property
    def offsets(self) -> np.ndarray:
        return self.keys.offsets

    @property
    def longest(self) -> int:
        return self.keys.longest

    @property
    def nbytes(self) -> int:
        return self.keys.nbytes + self.values.values.nbytes \
            + self.values.elem_valid.nbytes

    @staticmethod
    def concat(parts: Sequence["HostMap"]) -> "HostMap":
        return HostMap.of(HostList.concat([p.keys for p in parts]),
                          HostList.concat([p.values for p in parts]))

    @staticmethod
    def from_pylist(rows, key_type: Optional[DataType] = None,
                    value_type: Optional[DataType] = None):
        """(HostMap, row validity) of Python maps: dicts or lists of
        (key, value) pairs, None for a NULL row. A NULL key raises, as
        Spark's does."""
        items = [None if r is None else list(
            r.items() if isinstance(r, dict) else r) for r in rows]
        if any(k is None for r in items if r is not None for k, _ in r):
            raise ValueError("Cannot use null as map key")
        keys, valid = HostList.from_pylist(
            [None if r is None else [k for k, _ in r] for r in items],
            key_type)
        values, _ = HostList.from_pylist(
            [None if r is None else [v for _, v in r] for r in items],
            value_type)
        return HostMap.of(keys, values), valid

    @staticmethod
    def from_arrow(arr):
        """(HostMap, row validity) of an Arrow MapArray."""
        import pyarrow as pa
        from ..types import from_arrow
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        kt, vt = from_arrow(arr.type.key_type), from_arrow(arr.type.item_type)
        r = nested_reason(MapType(kt, vt))
        if r:
            raise NotImplementedError(r)
        valid = ~np.asarray(arr.is_null())
        kv, _ = _flat_values(arr.keys, kt)
        vv, vev = _flat_values(arr.items, vt)
        return HostMap(np.asarray(arr.offsets), kv, vv, vev, kt, vt), valid

    def to_pylist(self, valid: np.ndarray) -> list:
        """Each row's (key, value) tuples, None for a NULL row."""
        ks = self.keys.to_pylist(valid, self.keys.element)
        vs = self.values.to_pylist(valid, self.values.element)
        return [None if k is None else list(zip(k, v))
                for k, v in zip(ks, vs)]

    def to_arrow(self, valid: np.ndarray, dtype: DataType):
        import pyarrow as pa
        keys = self.keys.to_arrow(valid, self.keys.element)
        vals = self.values.to_arrow(valid, self.values.element)
        return pa.MapArray.from_arrays(keys.offsets, keys.values,
                                       vals.values, mask=pa.array(~valid))

    def __repr__(self):
        return f"HostMap(rows={len(self)}, entries={len(self.keys.values)})"


class MapColumn(DeviceColumn):
    """A map on the device: the keys' and the
    values' ``ListColumn`` over one ``lengths`` and row validity (module
    doc). ``data`` is the keys' rectangle."""

    __slots__ = ("keys", "values")

    def __init__(self, keys: ListColumn, values: ListColumn,
                 dtype: DataType):
        super().__init__(keys.data, keys.validity, dtype)
        self.keys = keys
        self.values = values

    @property
    def lengths(self) -> torch.Tensor:
        return self.keys.lengths

    @property
    def width(self) -> int:
        return self.keys.width

    def nbytes(self) -> int:
        v = self.values
        return self.keys.nbytes() + v.nbytes() - v.validity.numel() \
            - 4 * v.lengths.numel()

    def with_arrays(self, data, validity):
        raise TypeError("MapColumn rows move with their values and "
                        "lengths: use take_rows()")

    def to_numpy(self, num_rows: int) -> Tuple[HostMap, np.ndarray]:
        """(HostMap, row validity) of the first ``num_rows`` rows: the
        entries compacted on the device, one packed copy."""
        n = num_rows
        if isinstance(self.keys.data, Slots) or isinstance(self.values.data,
                                                          Slots):
            keys, rv = self.keys.to_numpy(n)
            return HostMap.of(keys, self.values.to_numpy(n)[0]), rv
        inside, lens = _inside(self.lengths[:n], self.validity[:n],
                               self.width)
        kd, vd, vev, lens, rv = packed_to_host([
            self.keys.data[:n][inside], self.values.data[:n][inside],
            self.values.elem_valid[:n][inside], lens, self.validity[:n]])
        kt, vt = _key_value_types(self.dtype)
        return HostMap(_offsets(lens), kd, vd, vev, kt, vt), rv

    def __repr__(self):
        return (f"MapColumn({self.dtype.name}[{self.width}], "
                f"padded={self.padded_len})")


def map_column(keys: torch.Tensor, key_valid: torch.Tensor,
               values: torch.Tensor, value_valid: torch.Tensor,
               lengths: torch.Tensor, validity: torch.Tensor,
               dtype: DataType) -> MapColumn:
    """A MapColumn in the canonical form of both rectangles
    (``list_column``)."""
    kt, vt = _key_value_types(dtype)
    return MapColumn(
        list_column(keys, key_valid, lengths, validity, ArrayType(kt)),
        list_column(values, value_valid, lengths, validity, ArrayType(vt)),
        dtype)


def to_device_map(hm: HostMap, valid: np.ndarray, dtype: DataType, device,
                  what: str = "a map column",
                  rect_cap: int = 64) -> MapColumn:
    """A ``HostMap`` and its row validity as a MapColumn on ``device``
    (the caps of ``to_device_list``)."""
    kt, vt = _key_value_types(dtype)
    return MapColumn(
        to_device_list(hm.keys, valid, ArrayType(kt), device, what, rect_cap),
        to_device_list(hm.values, valid, ArrayType(vt), device, what,
                       rect_cap), dtype)


def concat_maps(parts: List[MapColumn], rows: List[int]) -> MapColumn:
    """Map columns' first ``rows`` rows, in order, at the widest W."""
    return MapColumn(concat_lists([p.keys for p in parts], rows),
                     concat_lists([p.values for p in parts], rows),
                     parts[0].dtype)


# ---------------------------------------------------------------------------
# structs: the fields' columns and a row validity
# ---------------------------------------------------------------------------

class HostStruct:
    """A host struct column without its row validity: a ``HostTable`` of
    its fields (each with its own validity). Sliced like an array."""

    __slots__ = ("table",)

    def __init__(self, table):
        self.table = table

    def __len__(self) -> int:
        return self.table.num_rows

    def __getitem__(self, sl: slice) -> "HostStruct":
        start, stop, step = sl.indices(len(self))
        assert step == 1, "a HostStruct slices by a range of rows"
        return HostStruct(self.table.slice(start, max(stop - start, 0)))

    @property
    def dtype(self) -> StructType:
        return StructType(self.table.schema.fields)

    @property
    def nbytes(self) -> int:
        return self.table.nbytes

    @staticmethod
    def concat(parts: Sequence["HostStruct"]) -> "HostStruct":
        from .batch import HostTable
        return HostStruct(HostTable.concat([p.table for p in parts]))

    @staticmethod
    def from_pylist(rows):
        """(HostStruct, row validity) of Python dicts (None for a NULL
        row), each field typed from its values (module doc of
        ``HostTable.from_dict``)."""
        from .batch import HostTable, py_column
        valid = np.array([r is not None for r in rows], bool)
        names: List[str] = []
        for r in rows:
            for k in (r or {}):
                if k not in names:
                    names.append(k)
        return HostStruct(HostTable.from_dict({
            n: py_column([None if r is None else r.get(n) for r in rows])
            for n in names})), valid

    @staticmethod
    def from_arrow(arr):
        """(HostStruct, row validity) of an Arrow StructArray."""
        import pyarrow as pa
        from .batch import HostTable
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        valid = ~np.asarray(arr.is_null())
        names = [arr.type.field(i).name for i in range(arr.type.num_fields)]
        kids = [arr.field(i) for i in range(arr.type.num_fields)]
        if arr.offset:
            kids = [k.slice(arr.offset, len(arr)) for k in kids]
        return HostStruct(HostTable.from_arrow(
            pa.Table.from_arrays(kids, names=names))), valid

    def to_pylist(self, valid: np.ndarray) -> list:
        from ..api.dataframe import _py_values
        names = self.table.schema.names()
        cols = [_py_values(*self.table.columns[n], f.dtype)
                for n, f in zip(names, self.table.schema.fields)]
        return [dict(zip(names, row)) if ok else None
                for ok, row in zip(valid.tolist(), zip(*cols))] \
            if cols else [{} if ok else None for ok in valid.tolist()]

    def to_arrow(self, valid: np.ndarray, dtype: DataType):
        import pyarrow as pa
        from ..api.dataframe import _arrow_values
        fields = self.table.schema.fields
        kids = [_arrow_values(*self.table.columns[f.name], f.dtype)
                for f in fields]
        from ..types import to_arrow
        return pa.StructArray.from_arrays(
            kids, fields=[pa.field(f.name, to_arrow(f.dtype))
                          for f in fields], mask=pa.array(~valid))

    def __repr__(self):
        return f"HostStruct(rows={len(self)}, {self.table.schema})"


class StructColumn(DeviceColumn):
    """A struct on the device: its fields' device columns and a row
    validity (module doc). ``data`` is the validity itself, so the
    column has a length and a device like any other."""

    __slots__ = ("children",)

    def __init__(self, children: Sequence, validity: torch.Tensor,
                 dtype: StructType):
        super().__init__(validity, validity, dtype)
        self.children = list(children)

    def nbytes(self) -> int:
        return self.validity.numel() + sum(c.nbytes() for c in self.children)

    def with_arrays(self, data, validity):
        raise TypeError("StructColumn rows move with their fields: use "
                        "take_rows()")

    def to_numpy(self, num_rows: int) -> Tuple[HostStruct, np.ndarray]:
        """(HostStruct, row validity) of the first ``num_rows`` rows,
        through one packed copy of every field's tensors."""
        from .batch import HostTable
        from ..types import Schema
        host = to_host_column(self, num_rows)
        return HostStruct(HostTable(
            {f.name: c.to_numpy(num_rows)
             for f, c in zip(self.dtype.fields, host.children)},
            Schema(self.dtype.fields))), host.validity.numpy()

    def __repr__(self):
        return (f"StructColumn({self.dtype.name}, "
                f"padded={self.padded_len})")


# ---------------------------------------------------------------------------
# any device column as tensors a row and a meta
# ---------------------------------------------------------------------------

def parts(c) -> Tuple[List[torch.Tensor], tuple]:
    """(the column's tensors, each with a row per row; a meta that
    ``from_parts`` rebuilds the column from with its type)."""
    from .strrect import ByteRectColumn
    if isinstance(c, MapColumn):
        kt, km = parts(c.keys)
        vt, vm = parts(c.values)
        return kt + vt, ("map", km, vm)
    if isinstance(c, StructColumn):
        tensors, metas = [c.validity], []
        for child in c.children:
            t, m = parts(child)
            tensors += t
            metas.append(m)
        return tensors, ("struct", metas)
    if isinstance(c, ListColumn):
        rest = [c.validity, c.elem_valid, c.lengths]
        if isinstance(c.data, Slots):
            p, w = c.data.shape
            t, m = parts(c.data.col)
            return [x.reshape((p, w) + tuple(x.shape[1:])) for x in t] \
                + rest, ("slots", m, len(t))
        return [c.data] + rest, ("list",)
    if isinstance(c, ByteRectColumn):
        return [c.data, c.validity, c.lengths], ("rect", c.ascii_only)
    if isinstance(c, DictColumn):
        return [c.data, c.validity], ("dict", c.dictionary)
    if isinstance(c, DeviceColumn):
        return [c.data, c.validity], ("dev",)
    raise NotImplementedError(
        f"{c!r}: a host column inside a nested column arrives with "
        f"{NESTED_REST}")


def from_parts(meta: tuple, dtype: DataType, tensors):
    """The column ``parts`` gave ``meta`` for, around the next tensors of
    the iterator ``tensors``."""
    from .strrect import ByteRectColumn
    kind = meta[0]
    if kind == "dev":
        return DeviceColumn(next(tensors), next(tensors), dtype)
    if kind == "dict":
        return DictColumn(next(tensors), next(tensors), dtype, meta[1])
    if kind == "rect":
        d, v, ln = next(tensors), next(tensors), next(tensors)
        return ByteRectColumn(d, v, ln, meta[1])
    if kind == "list":
        d, v, ev, ln = (next(tensors) for _ in range(4))
        return ListColumn(d, v, dtype, ev, ln)
    if kind == "slots":
        ts = [next(tensors) for _ in range(meta[2])]
        v, ev, ln = next(tensors), next(tensors), next(tensors)
        p, w = ev.shape
        flat = from_parts(meta[1], dtype.element, iter(
            x.reshape((p * w,) + tuple(x.shape[2:])) for x in ts))
        return ListColumn(Slots(flat, w), v, dtype, ev, ln)
    if kind == "map":
        kt, vt = _key_value_types(dtype)
        keys = from_parts(meta[1], ArrayType(kt), tensors)
        return MapColumn(keys, from_parts(meta[2], ArrayType(vt), tensors),
                         dtype)
    v = next(tensors)
    return StructColumn([from_parts(m, f.dtype, tensors)
                         for m, f in zip(meta[1], dtype.fields)], v, dtype)


def with_validity(c, valid: torch.Tensor):
    """``c`` with its row validity ``valid`` and every other tensor as it
    is (no copy of the data: the caller knows the rows that turn NULL
    need no canonical value)."""
    tensors, meta = parts(c)
    tensors[0 if meta[0] == "struct" else 1] = valid
    return from_parts(meta, c.dtype, iter(tensors))


def _rebuilt(c, fn):
    tensors, meta = parts(c)
    return from_parts(meta, c.dtype, iter([fn(t) for t in tensors]))


def take_rows(c, idx: torch.Tensor):
    """Rows ``idx`` (in range) of a device column of any kind."""
    return _rebuilt(c, lambda t: t[idx])


def slice_rows(c, start: int, stop: int):
    return _rebuilt(c, lambda t: t[start:stop])


def null_rows(c, keep: torch.Tensor):
    """``c`` with the rows where ``keep`` is False NULL, in the layout's
    canonical form: a NULL row's slots hold the dtype's default value (a
    dictionary code 0, a rectangle row of zero bytes and length 0), a
    NULL list or map row has length 0; a NULL struct row keeps its
    fields' slots."""
    if isinstance(c, MapColumn):
        return map_column(c.keys.data, c.keys.elem_valid, c.values.data,
                          c.values.elem_valid, c.lengths,
                          c.validity & keep, c.dtype)
    if isinstance(c, ListColumn):
        return list_column(c.data, c.elem_valid, c.lengths,
                           c.validity & keep, c.dtype)
    if isinstance(c, StructColumn):
        return StructColumn(c.children, c.validity & keep, c.dtype)
    tensors, meta = parts(c)
    valid = tensors[1] & keep
    out = [torch.where(valid.reshape((-1,) + (1,) * (t.dim() - 1)), t,
                       torch.zeros((), dtype=t.dtype, device=t.device))
           for t in tensors]
    out[1] = valid
    return from_parts(meta, c.dtype, iter(out))


def zero_rows(c, n: int):
    """``n`` NULL rows in ``c``'s layout (every tensor zero)."""
    return _rebuilt(c, lambda t: torch.zeros((n,) + tuple(t.shape[1:]),
                                             dtype=t.dtype, device=t.device))


def to_host_column(c, num_rows: int):
    """The first ``num_rows`` rows of a device column as the same column
    on the CPU, through one packed device-to-host copy."""
    tensors, meta = parts(c)
    host = packed_to_host([t[:num_rows] for t in tensors])
    return from_parts(meta, c.dtype, iter([torch.from_numpy(a)
                                           for a in host]))
