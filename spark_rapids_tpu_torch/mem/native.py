"""ctypes binding to the native OOM state machine (port of
``spark_rapids_tpu/mem/native.py``; the C++ is the port's copy,
``csrc/oom_state.cpp``).

The library is built with g++ at first use into ``build/`` (the port's
``native.build_host``: under a file lock, through a temporary file and a
rename). ``load()`` returns None where no g++ is installed, and the
Python twin in manager.py keeps working, as in the reference.
"""
from __future__ import annotations

import ctypes
import threading

__all__ = ["load", "NativeOomState"]

_LOCK = threading.Lock()
_lib = None          # guarded by _LOCK
_tried = False       # guarded by _LOCK


def load():
    global _lib, _tried
    with _LOCK:
        if _tried:
            return _lib
        _tried = True
        from ..native import build_host
        so = build_host("oom_state")
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        i64, lng = ctypes.c_int64, ctypes.c_long
        lib.oom_init.argtypes = [i64]
        lib.oom_init.restype = None
        lib.oom_reserve.argtypes = [i64, i64, lng]
        lib.oom_reserve.restype = ctypes.c_int
        lib.oom_release.argtypes = [i64]
        lib.oom_release.restype = None
        lib.oom_force_retry_oom.argtypes = [i64, lng, lng]
        lib.oom_force_retry_oom.restype = None
        lib.oom_force_split_and_retry_oom.argtypes = [i64, lng, lng]
        lib.oom_force_split_and_retry_oom.restype = None
        lib.oom_clear_injections.argtypes = []
        lib.oom_clear_injections.restype = None
        lib.oom_reset_max_used.argtypes = []
        lib.oom_reset_max_used.restype = None
        for f in ("oom_get_used", "oom_get_max_used"):
            getattr(lib, f).argtypes = []
            getattr(lib, f).restype = i64
        lib.oom_get_blocked_threads.argtypes = []
        lib.oom_get_blocked_threads.restype = lng
        for f in ("oom_get_retry_count", "oom_get_split_count"):
            getattr(lib, f).argtypes = [i64]
            getattr(lib, f).restype = lng
        _lib = lib
        return _lib


class NativeOomState:
    """Thin wrapper used by MemoryManager when the native lib loads. The
    machine is process-global: making one resets it."""

    def __init__(self, budget: int):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("the native OOM state machine did not build "
                               "(no g++?)")
        self.lib.oom_init(budget)

    def reserve(self, nbytes: int, block_ms: int = 0) -> int:
        return self.lib.oom_reserve(threading.get_ident(), nbytes, block_ms)

    def release(self, nbytes: int):
        self.lib.oom_release(nbytes)

    def force_retry_oom(self, num: int = 1, skip: int = 0, tid=None):
        self.lib.oom_force_retry_oom(
            tid if tid is not None else threading.get_ident(), num, skip)

    def force_split_and_retry_oom(self, num: int = 1, skip: int = 0,
                                  tid=None):
        self.lib.oom_force_split_and_retry_oom(
            tid if tid is not None else threading.get_ident(), num, skip)

    def clear_injections(self):
        self.lib.oom_clear_injections()

    def reset_max_used(self):
        self.lib.oom_reset_max_used()

    @property
    def used(self) -> int:
        return self.lib.oom_get_used()

    @property
    def max_used(self) -> int:
        return self.lib.oom_get_max_used()

    @property
    def blocked_threads(self) -> int:
        return self.lib.oom_get_blocked_threads()

    def retry_count(self, tid=None) -> int:
        return self.lib.oom_get_retry_count(
            tid if tid is not None else threading.get_ident())

    def split_count(self, tid=None) -> int:
        return self.lib.oom_get_split_count(
            tid if tid is not None else threading.get_ident())
