"""ctypes binding to the native disk spill store (port of
``spark_rapids_tpu/mem/native_spill.py``; the C++ is the port's copy,
``csrc/spill_store.cpp``, the RapidsDiskStore/RapidsDiskBlockManager
analog).

Spilled batches append into large slab files through a C++ block store
with CRC32 verification on read-back; one store per spill directory,
shared by every MemoryManager pointing at it. ``get_store`` returns None
where no g++ built the store: SpillableBatch then writes the same bytes
as one plain file a batch.
"""
from __future__ import annotations

import atexit
import ctypes
import os
import threading
from typing import Dict, Optional

import numpy as np

__all__ = ["NativeSpillStore", "get_store"]

_LOCK = threading.Lock()
_lib = None          # guarded by _LOCK
_tried = False       # guarded by _LOCK
_stores: Dict[str, "NativeSpillStore"] = {}  # guarded by _LOCK


def _load_lib():
    global _lib, _tried
    with _LOCK:
        if _tried:
            return _lib
        _tried = True
        from ..native import build_host
        so = build_host("spill_store")
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.sp_open.restype = ctypes.c_void_p
        lib.sp_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.sp_write.restype = ctypes.c_int64
        lib.sp_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
        lib.sp_block_size.restype = ctypes.c_int64
        lib.sp_block_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sp_read.restype = ctypes.c_int64
        lib.sp_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_int64]
        lib.sp_free.restype = ctypes.c_int
        lib.sp_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sp_stats.restype = None
        lib.sp_stats.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int64 * 4)]
        lib.sp_close.restype = None
        lib.sp_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeSpillStore:
    """One slab-file block store rooted at a spill directory."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle
        self._lock = threading.Lock()

    def write(self, data) -> int:
        """Store ``data`` (bytes, or a contiguous numpy uint8 array, read
        in place); the block's id."""
        arr = np.frombuffer(data, dtype=np.uint8) \
            if isinstance(data, (bytes, bytearray)) else data
        if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
            raise TypeError("write takes bytes or a contiguous uint8 array")
        with self._lock:
            bid = self._lib.sp_write(self._h, arr.ctypes.data, arr.size)
        if bid < 0:
            raise IOError("native spill write failed")
        return int(bid)

    def read(self, block_id: int) -> bytearray:
        n = self._lib.sp_block_size(self._h, block_id)
        if n < 0:
            raise KeyError(f"unknown spill block {block_id}")
        out = bytearray(int(n))
        buf = (ctypes.c_char * len(out)).from_buffer(out)
        with self._lock:
            got = self._lib.sp_read(self._h, block_id, buf, n)
        if got == -2:
            raise IOError(f"spill block {block_id} failed CRC verification "
                          "(disk corruption)")
        if got != n:
            raise IOError(f"short read of spill block {block_id}")
        return out

    def free(self, block_id: int) -> None:
        with self._lock:
            self._lib.sp_free(self._h, block_id)

    def stats(self) -> dict:
        out = (ctypes.c_int64 * 4)()
        self._lib.sp_stats(self._h, ctypes.byref(out))
        return {"live_blocks": out[0], "live_bytes": out[1],
                "slab_files": out[2], "file_bytes": out[3]}


def _close_all():
    with _LOCK:
        for st in _stores.values():
            st._lib.sp_close(st._h)
        _stores.clear()


def get_store(spill_dir: str) -> Optional[NativeSpillStore]:
    """Shared store per spill directory, or None without g++. Slab files
    are pid-unique (safe for shared directories) and removed by sp_close
    at interpreter exit."""
    lib = _load_lib()
    if lib is None:
        return None
    with _LOCK:
        first = not _stores
        st = _stores.get(spill_dir)
        if st is None:
            os.makedirs(spill_dir, exist_ok=True)
            h = lib.sp_open(spill_dir.encode(), 0)
            if not h:
                return None
            st = _stores[spill_dir] = NativeSpillStore(lib, h)
            if first:
                atexit.register(_close_all)
        return st
