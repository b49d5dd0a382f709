"""Hash-based distinct flagging: the hand-written CUDA kernel, its plain
PyTorch version and the exec over them (port of
``spark_rapids_tpu/exec/distinct_flag.py``).

``count/sum/avg(DISTINCT e) GROUP BY g`` is rewritten (plan/rewrites.py
``_rewrite_distinct_hash``) into ``count/sum/avg(CASE WHEN __hd_flag
THEN e END)`` over ``HashDistinctFlagExec``, which appends a bool column:
true on the stream-global FIRST occurrence of each ``(g, e)`` pair (the
lowest row of the first batch that holds it), false elsewhere and on
every row whose value is NULL. A NULL group is a real group. Values and
groups are normalised first: ``-0.0`` as ``+0.0``, every NaN as one
pattern, float32 by its 32-bit pattern, narrow integers sign-extended to
64 bits. Types: bool, int8-int64, float, double, date and timestamp, at
most one group key.

``distinct_flag(table, value, value_valid, group, group_valid)`` flags
one batch against ``table``, which holds the keys of the earlier
batches:

* on CUDA tensors, the kernel ``csrc/distinct_flag.cu`` (replacing the
  reference's ``_probe_insert`` ``:83``, ``_flag_kernel`` ``:133`` and
  ``_rebuild_kernel`` ``:166``): an open-addressing table of 32-byte
  slots on the card, one cooperative launch a batch (insert-or-find, a
  grid barrier, mark), a rehash launch when the table grows (the
  source's doc);
* on CPU tensors, ``distinct_flag_reference``: the same normalisation,
  the batch's first rows by ``torch.unique(dim=0, return_inverse=True)``
  and a ``scatter_reduce(amin)`` of row ids, and the keys seen so far as
  a sorted tensor, met by one more ``torch.unique`` over it and the
  batch's keys.

Both give the same bits. ``distinct_flag.launches`` counts the kernel's
launches (one a batch, and each rehash).

The table is sized from the keys it is known to hold, never with a host
read that waits (``sized_table``): the kernel counts the keys it inserts
and stores the count, with its batch's epoch, into one pinned host word;
the host reads the word (``KeyCount``) and bounds the keys after the next
batch by that count plus the rows given since that epoch. The reference
sizes from the rows alone (``spark_rapids_tpu/exec/distinct_flag.py``
``:230``); the flags are the same.
"""
from __future__ import annotations

import array
import ctypes
import threading
from typing import Callable, Dict, Iterator, List, Optional

import torch

from ..columnar import ColumnarBatch, DeviceColumn
from ..exprs.compiler import DeviceProjector, batch_device
from ..types import BOOL, Schema, StructField
from .base import ExecContext, TpuExec

__all__ = ["DistinctTable", "KeyCount", "SeenKeys", "HashDistinctFlagExec",
           "distinct_flag", "distinct_flag_reference", "normalize",
           "sized_table", "SLOT_BYTES"]

#: csrc/distinct_flag_row.cuh DfKind of each element type
_KIND = {torch.bool: 0, torch.int8: 0, torch.int16: 1, torch.int32: 2,
         torch.int64: 3, torch.float32: 4, torch.float64: 5}
#: a slot's bytes (csrc/distinct_flag_row.cuh DfSlot; checked against the
#: library when it loads) and int64 words
SLOT_BYTES = 32
_SLOT_WORDS = SLOT_BYTES // 8
#: csrc/distinct_flag_row.cuh kDfMaxEpoch
MAX_EPOCH = 1 << 30
#: the largest table the kernel takes (slot indices are int32)
MAX_SLOTS = 1 << 31


def normalize(data: torch.Tensor) -> torch.Tensor:
    """int64 words of a key column, equal for equal SQL values (module
    doc; csrc/distinct_flag_row.cuh ``df_norm``)."""
    if data.dtype == torch.float64:
        data = torch.where(data == 0, torch.zeros_like(data), data)
        bits = data.view(torch.int64)
        return torch.where(torch.isnan(data),
                           torch.full_like(bits, 0x7FF8000000000000), bits)
    if data.dtype == torch.float32:
        data = torch.where(data == 0, torch.zeros_like(data), data)
        bits = data.view(torch.int32).to(torch.int64)
        return torch.where(torch.isnan(data),
                           torch.full_like(bits, 0x7FC00000), bits)
    return data.to(torch.int64)


def _check(value, value_valid, group, group_valid) -> None:
    cols = [(value, value_valid)] + ([] if group is None
                                     else [(group, group_valid)])
    for d, v in cols:
        if d.dtype not in _KIND or d.dim() != 1:
            raise TypeError(f"distinct_flag takes a vector of {list(_KIND)}, "
                            f"not {d.dtype} of {d.dim()} dimensions")
        if v is None or v.dtype != torch.bool or v.shape != d.shape:
            raise TypeError("each column needs a bool validity of its "
                            "length")
        if d.device != value.device or v.device != value.device:
            raise ValueError("every column must lie on the value's device")
        if d.shape[0] != value.shape[0]:
            raise ValueError("the group and the value need one length")


def _keys(value, value_valid, group, group_valid):
    """(active rows, their (group null, group word, value word) keys)."""
    val = normalize(value)
    if group is None:
        grp = torch.zeros_like(val)
        gnull = torch.zeros_like(val)
    else:
        grp = torch.where(group_valid, normalize(group),
                          torch.zeros_like(val))
        gnull = (~group_valid).to(torch.int64)
    rows = torch.nonzero(value_valid, as_tuple=True)[0]
    return rows, torch.stack([gnull, grp, val], dim=1)[rows]


class SeenKeys:
    """The plain version's state: the keys of the earlier batches as one
    sorted tensor of unique ``(group null, group word, value word)``
    rows."""

    def __init__(self):
        self.keys: Optional[torch.Tensor] = None


def distinct_flag_reference(seen: SeenKeys, value: torch.Tensor,
                            value_valid: torch.Tensor,
                            group: Optional[torch.Tensor] = None,
                            group_valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of ``distinct_flag`` (module doc); adds the
    batch's keys to ``seen``."""
    _check(value, value_valid, group, group_valid)
    n = value.shape[0]
    flags = torch.zeros(n, dtype=torch.bool, device=value.device)
    rows, keys = _keys(value, value_valid, group, group_valid)
    if not rows.numel():
        return flags
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64,
                       device=value.device).scatter_reduce(
        0, inv, rows, "amin")
    if seen.keys is None or not seen.keys.shape[0]:
        new = torch.ones(uniq.shape[0], dtype=torch.bool,
                         device=value.device)
        seen.keys = uniq
    else:
        s = seen.keys.shape[0]
        both, binv = torch.unique(torch.cat([seen.keys, uniq]), dim=0,
                                  return_inverse=True)
        was = torch.zeros(both.shape[0], dtype=torch.bool,
                          device=value.device)
        was[binv[:s]] = True
        new = ~was[binv[s:]]
        seen.keys = both
    flags[first[new]] = True
    return flags


class KeyCount:
    """A table's key count as the host knows it without waiting on the
    card: one pinned host word, which each launch's kernel sets after its
    barrier to ``(epoch << 32) | keys`` in one 8-byte store, and the
    table's rows after each queued epoch. ``poll`` reads the word: its
    epoch names the launch that wrote it, so the rows its count covers.
    On a card an event recorded after the newest launch keeps the pinned
    block from the allocator until that launch has stored."""

    def __init__(self, cuda: bool):
        self.host = torch.zeros(1, dtype=torch.int64, pin_memory=cuda)
        self._word = self.host.numpy()
        #: the table's rows after each epoch not yet read
        self.rows_after: Dict[int, int] = {}
        #: the newest count read, and the table's rows when it was taken
        self.keys = 0
        self.rows = 0
        self._last = torch.cuda.Event() if cuda else None

    def queued(self, epoch: int, rows: int, stream=None) -> None:
        """The launch of ``epoch`` (the table's rows ``rows`` after it)
        is queued on ``stream``."""
        self.rows_after[epoch] = rows
        if self._last is not None:
            self._last.record(stream)

    def poll(self) -> None:
        word = int(self._word[0])
        epoch = word >> 32
        rows = self.rows_after.get(epoch)
        if rows is not None:
            self.keys, self.rows = word & 0xFFFFFFFF, rows
            for e in [e for e in self.rows_after if e <= epoch]:
                del self.rows_after[e]

    def __del__(self):
        # the newest launch may still store into ``host``: its pinned
        # block must not go back to the allocator (and to another tensor)
        # first
        if self._last is not None and not self._last.query():
            self._last.synchronize()


class DistinctTable:
    """The keys of a stream's earlier batches: on a card the kernel's hash
    table (``capacity`` slots of SLOT_BYTES, zeroed; ``hashed``), on the
    CPU the plain version's ``SeenKeys``; with its key count (``keys``,
    a device word the kernel adds to; ``count``, the host's view of it)
    and the rows given to it so far. ``hashed`` may be forced to give a
    CPU tensor the kernel's table (the tests run the kernel's loops on
    the host over it)."""

    def __init__(self, device, capacity: int,
                 hashed: Optional[bool] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.hashed = self.device.type == "cuda" if hashed is None \
            else hashed
        self.capacity = capacity
        #: the latest batch's epoch (csrc/distinct_flag_row.cuh)
        self.epoch = 0
        #: rows of every batch flagged against the table
        self.rows = 0
        self.seen = SeenKeys()
        self.slots: Optional[torch.Tensor] = None
        self.error: Optional[torch.Tensor] = None
        self.keys = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.count = KeyCount(self.device.type == "cuda")
        if self.device.type == "cuda":
            _check_host(self.count.host)
        if self.hashed:
            if capacity < 2 or capacity & (capacity - 1) \
                    or capacity > MAX_SLOTS:
                raise ValueError(f"a table of {capacity} slots: a power "
                                 f"of two up to {MAX_SLOTS}")
            self.slots = torch.zeros(capacity * _SLOT_WORDS,
                                     dtype=torch.int64, device=self.device)
            self.error = torch.zeros(1, dtype=torch.int32,
                                     device=self.device)

    @property
    def nbytes(self) -> int:
        return 0 if self.slots is None else self.slots.numel() * 8

    def grow(self, capacity: int,
             rehash: Optional[Callable] = None) -> None:
        """Move the keys into a table of ``capacity`` slots: a rehash
        launch on a card (``rehash(old, old capacity, new, capacity,
        error)`` in its place: the tests' host loop)."""
        if not self.hashed:
            self.capacity = capacity
            return
        if capacity <= self.capacity or capacity & (capacity - 1) \
                or capacity > MAX_SLOTS:
            raise ValueError(f"cannot grow a table of {self.capacity} "
                             f"slots to {capacity}")
        new = torch.zeros(capacity * _SLOT_WORDS, dtype=torch.int64,
                          device=self.device)
        (rehash or _card_rehash)(self.slots, self.capacity, new, capacity,
                                 self.error)
        self.slots, self.capacity = new, capacity

    def failed(self) -> bool:
        """Whether an insert passed every slot (one host read)."""
        return self.error is not None and bool(self.error.item())

    def key_bound(self, rows: int):
        """(K, R): K keys known to be in the table (the newest count the
        host has read) and R rows given to it since, ``rows`` more
        included; the keys after those rows are at most K + R."""
        self.count.poll()
        return self.count.keys, self.rows - self.count.rows + rows


def _pack(table: DistinctTable, value, value_valid, group, group_valid,
          slot_of_row, flags) -> list:
    """One batch's arguments in csrc/distinct_flag.cu ``DistinctFlagArgs``
    order."""
    return [value.data_ptr(), _KIND[value.dtype], value_valid.data_ptr(),
            0 if group is None else group.data_ptr(),
            0 if group is None else _KIND[group.dtype],
            0 if group is None else group_valid.data_ptr(),
            value.shape[0], table.slots.data_ptr(), table.capacity,
            slot_of_row.data_ptr(), flags.data_ptr(),
            table.error.data_ptr(), table.keys.data_ptr(),
            table.count.host.data_ptr(), table.epoch]


def _flag(table: DistinctTable, value, value_valid, group, group_valid,
          launch: Callable[[list], None], stream=None) -> torch.Tensor:
    """The flags by the kernel's launch: ``launch(v)`` runs it over packed
    arguments (on the card; the tests' host build of its loops), after
    the epoch advances; the epoch's rows are noted for the count after,
    with ``stream`` the launch's."""
    if table.epoch >= MAX_EPOCH:
        raise OverflowError(f"a distinct-flag table serves at most "
                            f"{MAX_EPOCH} batches")
    table.epoch += 1
    n = value.shape[0]
    flags = torch.empty(n, dtype=torch.bool, device=value.device)
    if n:
        slot_of_row = torch.empty(n, dtype=torch.int32, device=value.device)
        # the contiguous copies live until the launch is queued
        cols = [value.contiguous(), value_valid.contiguous(),
                None if group is None else group.contiguous(),
                None if group is None else group_valid.contiguous()]
        launch(_pack(table, *cols, slot_of_row, flags))
        table.rows += n
        table.count.queued(table.epoch, table.rows, stream)
    return flags


_KERNEL: dict = {}
#: guards _KERNEL and the launch count
_LOCK = threading.Lock()
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _kernel() -> dict:
    """The library's functions, typed once."""
    with _LOCK:
        if _KERNEL:
            return _KERNEL
        from .. import native
        lib = native.load("distinct_flag")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.distinct_flag_launch.argtypes = [p, p]
        lib.distinct_flag_rehash.argtypes = [p, i64, p, i64, p, p]
        lib.distinct_flag_describe.argtypes = [p]
        lib.distinct_flag_host_ok.argtypes = [p]
        for f in (lib.distinct_flag_launch, lib.distinct_flag_rehash,
                  lib.distinct_flag_describe, lib.distinct_flag_host_ok):
            f.restype = ctypes.c_int
        lib.distinct_flag_slot_bytes.argtypes = []
        lib.distinct_flag_slot_bytes.restype = i64
        if lib.distinct_flag_slot_bytes() != SLOT_BYTES:
            raise RuntimeError("csrc/distinct_flag.cu's slot size differs "
                               f"from the wrapper's {SLOT_BYTES} bytes")
        _KERNEL.update(launch=lib.distinct_flag_launch,
                       rehash=lib.distinct_flag_rehash,
                       describe=lib.distinct_flag_describe,
                       host_ok=lib.distinct_flag_host_ok)
        return _KERNEL


def _stream(t: torch.Tensor) -> int:
    dev = t.get_device()
    return _RAW_STREAM(dev) if _RAW_STREAM is not None else \
        torch.cuda.current_stream(dev).cuda_stream


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"distinct_flag {what} launch failed: CUDA error "
                           f"{rc}")


def _counted() -> None:
    with _LOCK:
        distinct_flag.launches += 1


def _card_launch(stream: int) -> Callable[[list], None]:
    fn = _kernel()["launch"]

    def launch(v: list) -> None:
        packed = array.array("q", v)
        _rc(fn(packed.buffer_info()[0], stream), "cooperative")
        _counted()
    return launch


def _check_host(host: torch.Tensor) -> None:
    """The count's word must be host memory the kernel can store to."""
    if not _kernel()["host_ok"](host.data_ptr()):
        raise RuntimeError("distinct_flag: the count's word is not pinned "
                           "host memory mapped for the card")


def _card_rehash(old, old_capacity, new, capacity, error) -> None:
    _rc(_kernel()["rehash"](old.data_ptr(), old_capacity, new.data_ptr(),
                            capacity, error.data_ptr(), _stream(new)),
        "rehash")
    _counted()


def kernel_shape() -> dict:
    """The kernel's registers a thread, resident blocks an SM and its
    largest grid's threads on the current card (for reports)."""
    out = (ctypes.c_int * 3)()
    _rc(_kernel()["describe"](out), "describe")
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return {"registers": out[0], "blocks_per_sm": out[1],
            "grid_threads": out[1] * sms * out[2]}


def distinct_flag(table: DistinctTable, value: torch.Tensor,
                  value_valid: torch.Tensor,
                  group: Optional[torch.Tensor] = None,
                  group_valid: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One batch's flags against ``table`` (module doc): on CUDA tensors
    the kernel (or an error), on CPU tensors ``distinct_flag_reference``."""
    _check(value, value_valid, group, group_valid)
    if value.is_cuda:
        if not table.hashed or table.device != value.device:
            raise ValueError("the table was made for another device")
        return _flag(table, value, value_valid, group, group_valid,
                     _card_launch(_stream(value)),
                     torch.cuda.current_stream(value.device))
    if value.device.type != "cpu":
        raise ValueError(f"distinct_flag has no kernel for {value.device}")
    flags = distinct_flag_reference(table.seen, value, value_valid, group,
                                    group_valid)
    # the plain version's count is known at once
    table.rows += value.shape[0]
    table.count.keys = 0 if table.seen.keys is None \
        else int(table.seen.keys.shape[0])
    table.count.rows = table.rows
    return flags


#: kernel launches since the count was last set to 0
distinct_flag.launches = 0


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


#: the keys a table may hold are at most 1/LOAD_NUM of its slots (ref
#: ``_LOAD_NUM``, which bounds every row so far instead)
LOAD_NUM = 2


def table_slots(keys: int, rows: int, min_slots: int) -> int:
    """Slots for a table known to hold ``keys`` keys that takes ``rows``
    rows more: ``next_pow2(LOAD_NUM * (keys + rows))``, at least
    ``min_slots``. The keys after the rows (at most ``keys + rows``) load
    it to at most 1/LOAD_NUM, as the reference's row bound does."""
    return max(min_slots, _next_pow2(LOAD_NUM * (keys + rows)))


def sized_table(table: Optional[DistinctTable], device, rows: int,
                min_slots: int, rehash: Optional[Callable] = None,
                hashed: Optional[bool] = None):
    """(table, grew): ``table`` able to take a batch of ``rows`` rows, from
    the keys it is known to hold (``DistinctTable.key_bound``; no host
    read waits): made with ``table_slots(0, rows, min_slots)`` slots, or
    grown by a rehash to ``table_slots(K, R, min_slots)`` when it has
    fewer. A grown size is a power of two above the old, so growth is at
    least twofold. No count known (K = 0) gives the reference's size
    (twice the rows), and K + R never exceeds the rows."""
    if table is None:
        return DistinctTable(device, table_slots(0, rows, min_slots),
                             hashed), False
    need = table_slots(*table.key_bound(rows), min_slots)
    if table.capacity < need:
        table.grow(need, rehash)
        return table, True
    return table, False


class HashDistinctFlagExec(TpuExec):
    """Appends ``flag_name`` (module doc). The table is sized before each
    batch from the keys it is known to hold and the rows since
    (``sized_table``, at least ``_MIN_SLOTS`` slots). The kernel's error
    word is read once, at the end of the stream, and raises if an insert
    failed."""

    _MIN_SLOTS = 1 << 16

    def __init__(self, key_exprs, value_expr, flag_name: str,
                 child: TpuExec):
        super().__init__([child])
        self.key_exprs = list(key_exprs)
        if len(self.key_exprs) > 1:
            # the table stores ONE group word (the rewrite makes no more)
            raise ValueError("a distinct flag takes at most one group key")
        self.value_expr = value_expr
        self.flag_name = flag_name
        cs = child.output_schema()
        self._schema = Schema(list(cs.fields)
                              + [StructField(flag_name, BOOL, False)])
        #: the latest execution's table growths and final slots
        self.last_growths = 0
        self.last_slots = 0

    def output_schema(self) -> Schema:
        return self._schema

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        proj = DeviceProjector(self.key_exprs + [self.value_expr],
                               self.children[0].output_schema())
        table: Optional[DistinctTable] = None
        self.last_growths = 0
        for batch in self.children[0].execute(ctx):
            with ctx.semaphore.held():
                cols = proj.run(batch)
                v, g = cols[-1], (cols[0] if self.key_exprs else None)
                table, grew = sized_table(table, batch_device(batch),
                                          v.data.shape[0], self._MIN_SLOTS)
                self.last_growths += grew
                self.last_slots = table.capacity
                flags = distinct_flag(
                    table, v.data, v.validity,
                    None if g is None else g.data,
                    None if g is None else g.validity)
            out: List = list(batch.columns) + [
                DeviceColumn(flags, torch.ones_like(flags), BOOL)]
            yield ColumnarBatch(out, batch.num_rows, self._schema)
        if table is not None and table.failed():
            raise RuntimeError(f"distinct_flag: an insert passed every slot "
                               f"of a table of {table.capacity} slots")

    def describe(self):
        k = ", ".join(e.name_hint for e in self.key_exprs)
        return (f"HashDistinctFlag[keys=[{k}], "
                f"value={self.value_expr.name_hint}]")
