"""SpillableBatch: a columnar batch that can move device -> host -> disk
and come back on demand (port of ``spark_rapids_tpu/mem/spillable.py``).

Reference analog: SpillableColumnarBatch (SpillableColumnarBatch.scala:29)
+ the tiered stores (RapidsDeviceMemoryStore / RapidsHostMemoryStore /
RapidsDiskStore). The device tier holds the batch's tensors on the card;
the host tier the same batch with every tensor copied to host memory
(pinned when it comes from a card); the disk tier the host batch in the
port's own byte layout (``_encode``), written through the native slab
store (mem/native_spill.py) or, where no g++ built it, to one file a
batch. A dictionary column's dictionary and a byte rectangle's lengths
and ``ascii_only`` flag survive both tiers.
"""
from __future__ import annotations

import json
import os
import threading
import uuid
from typing import List, Optional

import numpy as np
import torch

from ..columnar import (ByteRectColumn, ColumnarBatch, DeviceColumn,
                        DictColumn, HostColumn)
from ..types import (BOOL, DATE, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64,
                     STRING, TIMESTAMP)
from .manager import MemoryManager

__all__ = ["SpillableBatch", "SpillPriorities"]

_TYPES = {t.name: t for t in (BOOL, INT8, INT16, INT32, INT64, FLOAT32,
                              FLOAT64, DATE, TIMESTAMP, STRING)}
#: byte alignment of every array in the disk layout
_ALIGN = 64


class SpillPriorities:
    """Lower spills first (ref SpillPriorities.scala)."""
    OUTPUT_FOR_SHUFFLE = 0
    ACTIVE_BATCHING = 50
    ACTIVE_ON_DECK = 100


def _move_batch(batch: ColumnarBatch, move) -> ColumnarBatch:
    """``batch`` with ``move`` applied to every tensor of its columns;
    dictionaries, lengths and flags ride along."""
    cols = []
    for c in batch.columns:
        if isinstance(c, ByteRectColumn):
            cols.append(ByteRectColumn(move(c.data), move(c.validity),
                                       move(c.lengths), c.ascii_only))
        elif isinstance(c, DeviceColumn):
            cols.append(c.with_arrays(move(c.data), move(c.validity)))
        else:
            cols.append(c)
    return ColumnarBatch(cols, batch.num_rows, batch.schema)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: into pinned memory from a card, with a
    blocking copy, so the copy is complete when this returns."""
    if t.is_cuda:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out
    return t.clone()


def _encode(batch: ColumnarBatch) -> np.ndarray:
    """A host batch as one uint8 buffer: an 8-byte little-endian header
    length, the JSON header (per column its kind, dtype, arrays' dtype,
    shape and offset, dictionary or values), then every array at a
    64-byte aligned offset."""
    arrays: List[np.ndarray] = []
    cols = []

    def put(t) -> list:
        a = np.ascontiguousarray(t.numpy() if isinstance(t, torch.Tensor)
                                 else t)
        arrays.append(a)
        return [a.dtype.str, list(a.shape)]

    for c in batch.columns:
        if isinstance(c, ByteRectColumn):
            cols.append({"kind": "rect", "ascii_only": c.ascii_only,
                         "arrays": [put(c.data), put(c.validity),
                                    put(c.lengths)]})
        elif isinstance(c, DictColumn):
            cols.append({"kind": "dict", "dtype": c.dtype.name,
                         "dictionary": [str(x) for x in c.dictionary],
                         "arrays": [put(c.data), put(c.validity)]})
        elif isinstance(c, DeviceColumn):
            cols.append({"kind": "device", "dtype": c.dtype.name,
                         "arrays": [put(c.data), put(c.validity)]})
        else:
            cols.append({"kind": "host", "dtype": c.dtype.name,
                         "values": [None if not ok else x for x, ok in
                                    zip(c.values.tolist(),
                                        c.validity.tolist())],
                         "arrays": [put(c.validity)]})
    offsets, pos = [], 0
    for a in arrays:
        offsets.append(pos)
        pos += -(-a.nbytes // _ALIGN) * _ALIGN
    header = json.dumps({"num_rows": batch.num_rows, "columns": cols,
                         "offsets": offsets}).encode()
    base = -(-(8 + len(header)) // _ALIGN) * _ALIGN
    buf = np.zeros(base + pos, dtype=np.uint8)
    buf[:8] = np.frombuffer(np.uint64(len(header)).tobytes(), np.uint8)
    buf[8:8 + len(header)] = np.frombuffer(header, np.uint8)
    for a, off in zip(arrays, offsets):
        buf[base + off:base + off + a.nbytes] = a.reshape(-1).view(np.uint8)
    return buf


def _decode(buf, schema) -> ColumnarBatch:
    """``_encode``'s buffer back to a host batch of ``schema``."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    hlen = int(raw[:8].view(np.uint64)[0])
    header = json.loads(bytes(raw[8:8 + hlen]))
    base = -(-(8 + hlen) // _ALIGN) * _ALIGN
    offsets = iter(header["offsets"])

    def take(spec) -> np.ndarray:
        dt, shape = np.dtype(spec[0]), spec[1]
        off = base + next(offsets)
        n = int(np.prod(shape)) * dt.itemsize
        return raw[off:off + n].view(dt).reshape(shape)

    cols = []
    for c in header["columns"]:
        arrs = [take(s) for s in c["arrays"]]
        t = [torch.from_numpy(a) for a in arrs]
        if c["kind"] == "rect":
            cols.append(ByteRectColumn(t[0], t[1], t[2], c["ascii_only"]))
        elif c["kind"] == "dict":
            cols.append(DictColumn(t[0], t[1], _TYPES[c["dtype"]],
                                   np.array(c["dictionary"], dtype=object)))
        elif c["kind"] == "device":
            cols.append(DeviceColumn(t[0], t[1], _TYPES[c["dtype"]]))
        else:
            cols.append(HostColumn(np.array(c["values"], dtype=object),
                                   arrs[0], _TYPES[c["dtype"]]))
    return ColumnarBatch(cols, header["num_rows"], schema)


class SpillableBatch:
    """Wraps a ColumnarBatch; while registered it may be spilled by the
    MemoryManager at any time, `get()` moves it back to its device."""

    def __init__(self, batch: ColumnarBatch,
                 mm: Optional[MemoryManager] = None,
                 spill_priority: int = SpillPriorities.ACTIVE_BATCHING):
        self._mm = mm or MemoryManager.get()
        self._lock = threading.RLock()
        self._batch: Optional[ColumnarBatch] = batch
        self._host_batch: Optional[ColumnarBatch] = None
        self._host_bytes = 0
        self._disk_path: Optional[str] = None
        self._disk_block: Optional[int] = None   # native store block id
        self._disk_bytes = 0
        self.tier = "device"
        self.spill_priority = spill_priority
        self._num_rows = batch.num_rows
        self._padded_len = batch.padded_len
        self._device = next((c.data.device for c in batch.columns
                             if isinstance(c, DeviceColumn)),
                            torch.device("cpu"))
        self.schema = batch.schema
        self._device_bytes = batch.device_size_bytes()
        self._closed = False
        self._mm.reserve_absorbing_retries(self._device_bytes)
        # register LAST: the moment the handle exists, another thread's
        # spill_device() may pick this batch up, so every field the
        # spill paths read must already be set
        self._handle = self._mm.register_spillable(self)
        #: creation site for the leak auditor, only in leak-debug mode
        self.created_at = None
        if os.environ.get("SRTPU_LEAK_DEBUG"):
            import traceback
            self.created_at = "".join(traceback.format_stack(limit=6)[:-1])

    @property
    def memory_manager(self) -> MemoryManager:
        """The manager accounting for this batch (splitters re-wrap
        pieces under the same manager)."""
        return self._mm

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def padded_len(self) -> int:
        return self._padded_len

    def device_bytes(self) -> int:
        """Device footprint when resident (ref
        SpillableColumnarBatch.sizeInBytes)."""
        return self._device_bytes

    # ------------------------------------------------------------- migration
    def spill_to_host(self) -> int:
        # a batch another thread holds (moving it back, closing it) is no
        # candidate: waiting for it while this thread holds a batch it is
        # moving back could deadlock two threads under pressure
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            if self.tier != "device" or self._closed:
                return 0
            # blocking copies: the device reservation is released only
            # once the data is on the host
            self._host_batch = _move_batch(self._batch, _to_host)
            self._host_bytes = self._host_batch.device_size_bytes()
            nbytes = self._device_bytes
            self._batch = None
            self.tier = "host"
            self._mm.release(nbytes)
            self._mm.reserve_host(self._host_bytes)
            with self._mm._lock:
                self._mm.spill_to_host_bytes += nbytes
            return nbytes
        finally:
            self._lock.release()

    def spill_to_disk(self) -> int:
        if not self._lock.acquire(blocking=False):   # as spill_to_host
            return 0
        try:
            if self.tier != "host" or self._closed:
                return 0
            nbytes = self._host_bytes
            data = _encode(self._host_batch)
            store = self._native_store()
            if store is not None:
                self._disk_block = store.write(data)
                kind = "native"
            else:
                os.makedirs(self._mm.spill_dir, exist_ok=True)
                path = os.path.join(self._mm.spill_dir,
                                    f"spill-{uuid.uuid4().hex}.bin")
                data.tofile(path)
                self._disk_path = path
                kind = "files"
            self._disk_bytes = int(data.nbytes)
            with self._mm._lock:
                self._mm.disk_used += self._disk_bytes
                self._mm.spill_to_disk_bytes += nbytes
                self._mm.disk_store = kind
            self._mm.release_host(nbytes)
            self._host_batch = None
            self.tier = "disk"
            return nbytes
        finally:
            self._lock.release()

    def _native_store(self):
        from .native_spill import get_store
        return get_store(self._mm.spill_dir)

    def _read_disk(self) -> ColumnarBatch:
        if self._disk_block is not None:
            data = self._native_store().read(self._disk_block)
        else:
            data = np.fromfile(self._disk_path, dtype=np.uint8)
        return _decode(data, self.schema)

    def _free_disk(self) -> None:
        if self._disk_block is not None:
            self._native_store().free(self._disk_block)
            self._disk_block = None
        elif self._disk_path is not None:
            os.unlink(self._disk_path)
            self._disk_path = None
        with self._mm._lock:
            self._mm.disk_used -= self._disk_bytes
        self._disk_bytes = 0

    def _unspill(self) -> ColumnarBatch:
        """Move back to the device. The device reservation happens BEFORE
        the source tier is dismantled: a failed reserve (real or injected
        RetryOOM) leaves this batch intact in its tier (the reference's
        r14 order, spillable.py:173-207)."""
        dev = self._device
        host = self._host_batch if self.tier == "host" else self._read_disk()
        batch = _move_batch(host, lambda t: t.to(dev))
        self._mm.reserve_absorbing_retries(self._device_bytes)  # may raise
        if self.tier == "host":
            self._mm.release_host(self._host_bytes)
            self._host_batch = None
        else:
            self._free_disk()
        self.tier = "device"
        return batch

    # ------------------------------------------------------------------- api
    def get(self) -> ColumnarBatch:
        """The batch on its device (moved back if spilled)."""
        with self._lock:
            if self._closed:
                raise ValueError("closed SpillableBatch")
            if self.tier != "device":
                self._batch = self._unspill()
            return self._batch

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._mm.unregister_spillable(self._handle)
            if self.tier == "device":
                self._mm.release(self._device_bytes)
            elif self.tier == "host":
                self._mm.release_host(self._host_bytes)
                self._host_batch = None
            else:
                self._free_disk()
            self._batch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

