"""Device admission semaphore (port of
``spark_rapids_tpu/mem/semaphore.py``; ref GpuSemaphore.scala:51).

Gates how many tasks may have live device work at once
(``spark.rapids.tpu.sql.concurrentTpuTasks``); tracks wait time the way
GpuTaskMetrics records gpuSemaphoreWait (GpuTaskMetrics.scala:146).

The **wedge watchdog**: a waiter blocked past
``spark.rapids.tpu.semaphore.wedgeTimeoutMs`` wakes up, logs a
holder/waiter/held-bytes diagnostic, and force-releases permits whose
holder THREAD is dead, so a worker killed while holding the semaphore
cannot wedge every later query. Waits also poll the calling thread's
query deadline (api/dataframe.py), so a timed-out query never sits out
the whole task timeout inside acquire().
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["DeviceSemaphore", "QueryTimeout"]

log = logging.getLogger(__name__)


class QueryTimeout(RuntimeError):
    """The query's cooperative deadline (spark.rapids.tpu.query.timeout)
    expired: raised at batch boundaries and from semaphore waits so the
    query unwinds through the normal exception path: permits release via
    their ``with`` scopes and spillables close via the operators' cleanup
    handlers (the zero-leak audit holds)."""


class DeviceSemaphore:
    def __init__(self, permits: int, timeout_s: float = 600.0,
                 wedge_timeout_ms: int = 10000, memory=None):
        self._permits = max(1, int(permits))
        self._sem = threading.BoundedSemaphore(self._permits)
        self._timeout = timeout_s
        self.wedge_timeout_ms = int(wedge_timeout_ms)
        #: MemoryManager for held-bytes diagnostics (optional)
        self._memory = memory
        self._lock = threading.Lock()
        # the counters and the holder table are guarded by _lock
        self.total_wait_s = 0.0
        self.acquires = 0
        #: tasks currently blocked in acquire()
        self.waiting = 0
        #: dead holders force-released by the wedge watchdog
        self.wedges = 0
        #: thread ident -> {name, thread, since, count} for every live
        #: top-level holder (the watchdog's force-release census)
        self._holders: Dict[int, dict] = {}
        self._held = threading.local()
        #: the calling thread's query deadline (time.monotonic instant):
        #: thread-local, because sessions' queries share one semaphore
        self._deadline = threading.local()

    def set_thread_deadline(self, deadline: Optional[float]) -> None:
        """Install (None clears) the calling thread's query deadline;
        acquire() waits on this thread poll it and raise QueryTimeout."""
        self._deadline.value = deadline

    @property
    def deadline(self) -> Optional[float]:
        return getattr(self._deadline, "value", None)

    @property
    def permits(self) -> int:
        return self._permits

    # ------------------------------------------------------------ acquire
    def acquire(self):
        if getattr(self._held, "count", 0) > 0:
            self._held.count += 1  # re-entrant per task thread
            with self._lock:
                h = self._holders.get(threading.get_ident())
                if h is not None:
                    h["count"] += 1
            return
        self._maybe_watchdog()
        t0 = time.perf_counter()
        with self._lock:
            self.waiting += 1
        try:
            acquired = self._wait_acquire()
        finally:
            with self._lock:
                self.waiting -= 1
        if not acquired:
            raise TimeoutError(
                f"device semaphore not acquired within {self._timeout}s; "
                f"diagnostics: {self.diagnostics()}")
        wait = time.perf_counter() - t0
        me = threading.current_thread()
        stale = None
        with self._lock:
            self.total_wait_s += wait
            self.acquires += 1
            old = self._holders.get(threading.get_ident())
            if old is not None and old["thread"] is not me \
                    and not old["thread"].is_alive():
                # the OS recycled a dead holder's thread ident before the
                # watchdog saw it; overwriting the record would orphan the
                # dead thread's permit forever: reclaim it
                stale = old
                self.wedges += 1
            self._holders[threading.get_ident()] = {
                "name": me.name, "thread": me,
                "since": time.monotonic(), "count": 1}
        if stale is not None:
            self._sem.release()
            log.error("semaphore wedge: reclaimed permit of dead thread "
                      "%r whose ident was recycled", stale["name"])
        self._held.count = 1

    def _wait_acquire(self) -> bool:
        """Bounded-step wait loop: wake at the wedge horizon to run the
        watchdog, and at the query deadline to cancel cooperatively."""
        start = time.monotonic()
        wedge_s = (self.wedge_timeout_ms / 1000.0
                   if self.wedge_timeout_ms > 0 else None)
        while True:
            now = time.monotonic()
            remaining = self._timeout - (now - start)
            if remaining <= 0:
                return False
            step = remaining
            if wedge_s is not None:
                step = min(step, wedge_s)
            dl = self.deadline
            if dl is not None:
                dl_rem = dl - now
                if dl_rem <= 0:
                    raise QueryTimeout(
                        "query deadline expired while waiting on the "
                        f"device semaphore; diagnostics: "
                        f"{self.diagnostics()}")
                step = min(step, dl_rem)
            if self._sem.acquire(timeout=max(step, 0.001)):
                return True
            if wedge_s is not None \
                    and (time.monotonic() - start) >= wedge_s:
                self.check_wedged()

    # ----------------------------------------------------------- watchdog
    def _maybe_watchdog(self) -> None:
        """Overdue-holder sweep on every top-level acquire: a dead holder
        of one of N permits halves capacity even when no waiter starves
        past the wedge horizon."""
        if self.wedge_timeout_ms <= 0:
            return
        wedge_s = self.wedge_timeout_ms / 1000.0
        now = time.monotonic()
        with self._lock:
            overdue = any(now - h["since"] >= wedge_s
                          for h in self._holders.values())
        if overdue:
            self.check_wedged()

    def check_wedged(self) -> List[dict]:
        """Force-release permits whose holder thread is DEAD and log the
        diagnostics when anything looks stuck. Returns the force-released
        holder records. Live holders are never touched: cooperative
        cancellation is the tool for those."""
        now = time.monotonic()
        released: List[dict] = []
        stuck = False
        wedge_s = self.wedge_timeout_ms / 1000.0 \
            if self.wedge_timeout_ms > 0 else None
        with self._lock:
            for tid, h in list(self._holders.items()):
                if not h["thread"].is_alive():
                    self._holders.pop(tid)
                    released.append(h)
                    self.wedges += 1
                elif wedge_s is not None and now - h["since"] >= wedge_s:
                    stuck = True
        for h in released:
            self._sem.release()
            log.error("semaphore wedge: force-released permit held by DEAD "
                      "thread %r (held %.1fs)", h["name"], now - h["since"])
        if released or stuck:
            log.warning("semaphore diagnostics: %s", self.diagnostics())
        return released

    def diagnostics(self) -> dict:
        """Holder/waiter/held-bytes census for wedge dumps and timeout
        errors (the GpuSemaphore dump analog)."""
        now = time.monotonic()
        with self._lock:
            holders = [{"thread": h["name"], "ident": tid,
                        "alive": h["thread"].is_alive(),
                        "held_s": round(now - h["since"], 3),
                        "reentry": h["count"]}
                       for tid, h in self._holders.items()]
            waiting = self.waiting
            wedges = self.wedges
        out = {"permits": self._permits, "waiting": waiting,
               "holders": holders, "wedges": wedges}
        if self._memory is not None:
            out["memory"] = self._memory.stats()
        return out

    # ------------------------------------------------------------ release
    def release(self):
        c = getattr(self._held, "count", 0)
        if c <= 0:
            return
        if c == 1:
            with self._lock:
                self._holders.pop(threading.get_ident(), None)
            self._sem.release()
        else:
            with self._lock:
                h = self._holders.get(threading.get_ident())
                if h is not None:
                    h["count"] = c - 1
        self._held.count = c - 1

    @contextmanager
    def held(self):
        self.acquire()
        try:
            yield self
        finally:
            self.release()
