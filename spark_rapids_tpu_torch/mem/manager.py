"""Device-memory budget manager and spill orchestration (port of
``spark_rapids_tpu/mem/manager.py``).

Reference analog: RMM pool + RapidsBufferCatalog + DeviceMemoryEventHandler
(RapidsBufferCatalog.scala:810-851, DeviceMemoryEventHandler.scala:36).
Accounting is by reservation, as in the reference, not the caching
allocator's count: every long-lived device buffer the runtime retains
(aggregate partials, sort inputs, spillable batches) is registered here;
``reserve`` enforces the budget and, on pressure, synchronously spills
registered buffers (device -> host -> disk) in spill-priority order, the
role of the reference's onAllocFailure callback. When spilling cannot
satisfy a request, a RetryOOM/SplitAndRetryOOM is raised for the retry
framework (retry.py).

The budget is ``spark.rapids.tpu.memory.hbm.limitBytes``, or else
``allocFraction`` times the card's total memory
(``torch.cuda.mem_get_info``); on a CPU device, times the reference's
8 GiB default.

Fault injection (force_retry_oom / force_split_and_retry_oom) mirrors
RmmSpark.forceRetryOOM, the backbone of the reference's OOM test suites
(HashAggregateRetrySuite.scala:121-222).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from ..config import (ALLOC_FRACTION, HBM_LIMIT_BYTES, HOST_SPILL_LIMIT,
                      SPILL_DIR, TpuConf)

__all__ = ["MemoryManager", "RetryOOM", "SplitAndRetryOOM",
           "OutOfDeviceMemory"]

#: the budget's base where the device does not say (a CPU device)
DEFAULT_DEVICE_BYTES = 8 * 1024 * 1024 * 1024


class RetryOOM(RuntimeError):
    """Allocation failed but retrying after spill may succeed
    (ref GpuRetryOOM jni)."""


class SplitAndRetryOOM(RuntimeError):
    """Retry alone cannot succeed; caller must split its input
    (ref GpuSplitAndRetryOOM jni)."""


class OutOfDeviceMemory(RuntimeError):
    """Unrecoverable: nothing left to spill and input cannot be split."""


def device_memory_bytes(device) -> int:
    """The card's total memory, or the default for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return DEFAULT_DEVICE_BYTES


class MemoryManager:
    _global_lock = threading.Lock()
    #: budget -> the manager of that budget (guarded by _global_lock)
    _instances: Dict[int, "MemoryManager"] = {}

    def __init__(self, budget_bytes: int, host_limit_bytes: int,
                 spill_dir: str, use_native: bool = False):
        self.budget = budget_bytes
        self.host_limit = host_limit_bytes
        self.spill_dir = spill_dir
        self._lock = threading.RLock()
        # native accounting + fault machine (mem/native.py ->
        # csrc/oom_state.cpp); process-global, so only opted into (the
        # first singleton uses it)
        self._native = None
        if use_native:
            from .native import NativeOomState, load
            if load() is not None:
                self._native = NativeOomState(budget_bytes)
        # the fields below are guarded by _lock
        self._py_device_used = 0
        self.host_used = 0
        self.disk_used = 0
        self._py_max_device_used = 0
        self.spill_to_host_bytes = 0
        self.spill_to_disk_bytes = 0
        #: handle -> SpillableBatch, priority-ordered on demand
        self._spillables: Dict[int, object] = {}
        self._next_handle = 0
        #: thread ident -> [[kind, remaining skips, count], ...]
        self._inject: Dict[int, List] = {}
        #: thread ident -> {"retry": n, "split": n} injections fired
        self._fired: Dict[int, Dict[str, int]] = {}
        #: which disk store served the disk tier: "native" (slab files)
        #: or "files" (a file a batch, where no g++ built the store)
        self.disk_store: Optional[str] = None

    # ------------------------------------------------------------------ ctor
    @classmethod
    def get(cls, conf: Optional[TpuConf] = None,
            device="cpu") -> "MemoryManager":
        """The process's manager for the budget ``conf`` gives on
        ``device`` (module doc), made at first use."""
        conf = conf or TpuConf()
        limit = int(conf.get(HBM_LIMIT_BYTES))
        if not limit:
            limit = int(device_memory_bytes(device) * conf.get(ALLOC_FRACTION))
        with cls._global_lock:
            if limit not in cls._instances:
                # the first singleton owns the native machine
                cls._instances[limit] = cls(
                    limit, int(conf.get(HOST_SPILL_LIMIT)),
                    str(conf.get(SPILL_DIR)), use_native=not cls._instances)
            return cls._instances[limit]

    # ------------------------------------------------------------ accounting
    @property
    def device_used(self) -> int:
        if self._native is not None:
            return self._native.used
        return self._py_device_used   # one int read: no lock needed

    @property
    def max_device_used(self) -> int:
        if self._native is not None:
            return self._native.max_used
        return self._py_max_device_used

    def reset_max_device_used(self) -> None:
        """Restart ``max_device_used`` at the bytes in use now, so that it
        reads one query's peak."""
        if self._native is not None:
            self._native.reset_max_used()
            return
        with self._lock:
            self._py_max_device_used = self._py_device_used

    # ----------------------------------------------------------- registration
    def register_spillable(self, spillable) -> int:
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._spillables[h] = spillable
            return h

    def unregister_spillable(self, handle: int):
        with self._lock:
            self._spillables.pop(handle, None)

    # ------------------------------------------------------------ accounting
    def reserve(self, nbytes: int):
        """Account for nbytes of device memory about to be retained.

        On budget pressure: spill registered buffers; on injected or real
        exhaustion raise RetryOOM / SplitAndRetryOOM
        (ref DeviceMemoryEventHandler.onAllocFailure -> store.spill)."""
        if self._native is not None:
            rc = self._native.reserve(nbytes, block_ms=0)
            if rc == 0:
                return
            if rc == 2:
                raise SplitAndRetryOOM(
                    f"native: allocation of {nbytes} cannot ever fit "
                    f"(budget {self.budget}) or split was injected")
            self.spill_device(nbytes)
            # brief native block/wake window lets concurrent releases in
            rc = self._native.reserve(nbytes, block_ms=20)
            if rc == 0:
                return
            raise RetryOOM(f"native: could not reserve {nbytes} "
                           f"(used={self.device_used}, budget={self.budget})")
        self._maybe_inject()
        with self._lock:
            if self._py_device_used + nbytes <= self.budget:
                self._admit(nbytes)
                return
            # the shortfall read under the lock: a stale used-count here
            # under-spills and turns a satisfiable reserve into a
            # spurious RetryOOM
            shortfall = nbytes - (self.budget - self._py_device_used)
        self.spill_device(shortfall)
        with self._lock:
            if self._py_device_used + nbytes <= self.budget:
                self._admit(nbytes)
                return
        if nbytes > self.budget:
            raise SplitAndRetryOOM(
                f"allocation of {nbytes} exceeds whole budget {self.budget}")
        raise RetryOOM(f"could not reserve {nbytes} "
                       f"(used={self.device_used}, budget={self.budget})")

    def _admit(self, nbytes: int) -> None:
        self._py_device_used += nbytes
        self._py_max_device_used = max(self._py_max_device_used,
                                       self._py_device_used)

    def release(self, nbytes: int):
        if self._native is not None:
            self._native.release(nbytes)
            return
        with self._lock:
            self._py_device_used = max(0, self._py_device_used - nbytes)

    def reserve_absorbing_retries(self, nbytes: int, attempts: int = 10):
        """``reserve`` that absorbs transient RetryOOMs at the allocation
        site itself: spill-and-retry a bounded number of times before
        letting the OOM escape to the caller's retry frame (ref RMM's
        alloc loop re-entering the spill callback before GpuRetryOOM
        reaches the task thread). SpillableBatch reserves through this,
        so a bare ``[SpillableBatch(b, mm) for b in ...]`` survives an
        injected or transient OOM. SplitAndRetryOOM is never absorbed:
        only the caller can split its input."""
        last: Optional[BaseException] = None
        for _ in range(max(1, attempts)):
            try:
                return self.reserve(nbytes)
            except RetryOOM as e:
                last = e
                self.spill_device(nbytes)
                time.sleep(0)        # yield so other tasks can release
        raise last

    def reserve_host(self, nbytes: int):
        with self._lock:
            self.host_used += nbytes

    def release_host(self, nbytes: int):
        with self._lock:
            self.host_used = max(0, self.host_used - nbytes)

    # --------------------------------------------------------------- spilling
    def spill_device(self, need_bytes: int) -> int:
        """Synchronously spill device-tier spillables in priority order until
        need_bytes freed (ref RapidsBufferStore.synchronousSpill); host
        pressure then cascades to disk."""
        with self._lock:
            candidates = sorted(
                (s for s in self._spillables.values() if s.tier == "device"),
                key=lambda s: s.spill_priority)
        freed = 0
        for s in candidates:
            if freed >= need_bytes:
                break
            freed += s.spill_to_host()
        with self._lock:
            over = self.host_used - self.host_limit
        if over > 0:
            self.spill_host(over)
        return freed

    def spill_everything(self) -> int:
        """Spill every device-tier spillable this manager tracks (and
        cascade host pressure to disk): the cross-session pressure rung
        of the OOM escalation ladder (ref synchronousSpill(store, 0))."""
        with self._lock:
            need = sum(s.device_bytes() for s in self._spillables.values()
                       if s.tier == "device")
        return self.spill_device(need) if need > 0 else 0

    @classmethod
    def spill_all_sessions(cls) -> int:
        """``spill_everything`` across every live budget singleton, the
        process-wide pressure valve the retry ladder pulls before it
        gives up. Returns total bytes freed."""
        with cls._global_lock:
            insts = list(cls._instances.values())
        return sum(mm.spill_everything() for mm in insts)

    def spill_host(self, need_bytes: int) -> int:
        with self._lock:
            candidates = sorted(
                (s for s in self._spillables.values() if s.tier == "host"),
                key=lambda s: s.spill_priority)
        freed = 0
        for s in candidates:
            if freed >= need_bytes:
                break
            freed += s.spill_to_disk()
        return freed

    # -------------------------------------------------------- fault injection
    def force_retry_oom(self, num_ooms: int = 1, skip: int = 0,
                        thread_id: Optional[int] = None):
        """Next `num_ooms` reserves on the thread raise RetryOOM after
        skipping `skip` (ref RmmSpark.forceRetryOOM)."""
        if self._native is not None:
            self._native.force_retry_oom(num_ooms, skip, thread_id)
            return
        tid = thread_id if thread_id is not None else threading.get_ident()
        with self._lock:
            self._inject.setdefault(tid, []).append(["retry", skip, num_ooms])

    def force_split_and_retry_oom(self, num_ooms: int = 1, skip: int = 0,
                                  thread_id: Optional[int] = None):
        if self._native is not None:
            self._native.force_split_and_retry_oom(num_ooms, skip, thread_id)
            return
        tid = thread_id if thread_id is not None else threading.get_ident()
        with self._lock:
            self._inject.setdefault(tid, []).append(["split", skip, num_ooms])

    def clear_injections(self):
        if self._native is not None:
            self._native.clear_injections()
        with self._lock:
            self._inject.clear()

    def injections_fired(self, thread_id: Optional[int] = None
                         ) -> Dict[str, int]:
        """How many injected RetryOOMs and SplitAndRetryOOMs have fired on
        the thread (the native machine's per-thread counts)."""
        tid = thread_id if thread_id is not None else threading.get_ident()
        if self._native is not None:
            return {"retry": self._native.retry_count(tid),
                    "split": self._native.split_count(tid)}
        with self._lock:
            return dict(self._fired.get(tid, {"retry": 0, "split": 0}))

    def _maybe_inject(self):
        tid = threading.get_ident()
        with self._lock:
            queue = self._inject.get(tid)
            if not queue:
                return
            entry = queue[0]
            kind, skip, count = entry
            if skip > 0:
                entry[1] -= 1
                return
            entry[2] -= 1
            if entry[2] <= 0:
                queue.pop(0)
                if not queue:
                    self._inject.pop(tid, None)
            fired = self._fired.setdefault(tid, {"retry": 0, "split": 0})
            fired[kind] += 1
        if kind == "retry":
            raise RetryOOM("injected RetryOOM")
        raise SplitAndRetryOOM("injected SplitAndRetryOOM")

    # ----------------------------------------------------------- leak audit
    def audit_leaks(self) -> List[dict]:
        """Live (unclosed) spillable registrations, the MemoryCleaner
        leak tracker analog (ref Plugin.scala:573-588). Every
        SpillableBatch a query creates must be close()d by the time its
        sink finishes; anything still registered afterwards is a leak.
        Entries carry the creation site when leak detection is on."""
        with self._lock:
            return [{"handle": h, "tier": s.tier,
                     "bytes": s.device_bytes(),
                     "created_at": getattr(s, "created_at", None)}
                    for h, s in self._spillables.items()]

    @classmethod
    def audit_all_leaks(cls) -> List[dict]:
        with cls._global_lock:
            insts = list(cls._instances.values())
        out = []
        for mm in insts:
            out.extend(mm.audit_leaks())
        return out

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"device_used": self.device_used,
                    "host_used": self.host_used,
                    "disk_used": self.disk_used,
                    "max_device_used": self.max_device_used,
                    "budget": self.budget,
                    "spill_to_host_bytes": self.spill_to_host_bytes,
                    "spill_to_disk_bytes": self.spill_to_disk_bytes,
                    "num_spillables": len(self._spillables),
                    "disk_store": self.disk_store}
