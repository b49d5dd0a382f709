"""The port's memory runtime (spark_rapids_tpu_torch/mem) against the JAX
package's, on the CPU.

The cases of ``tests/test_memory.py`` and ``tests/test_native_oom.py``
that do not rest on chaos sites run as one parametrised test over both
packages where the call sequence is the same, so that both must show the
same outcomes. Where the reference's ladder ends on its host rung
(``degrades to host``), the port, which has no host engine and never
moves device work to the CPU, raises ``OutOfDeviceMemory``: those tests
say so. Then what only the port has: the spill round trip of dictionary
and byte-rectangle columns through both tiers, operators and TPC-H Q18's
inner aggregate under injected OOMs and a budget that forces spills
(equal to the reference), the semaphore shared by a session's threads,
the query deadline, and the native libraries' build under a lock. After
every test the port's leak audit is empty.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import chip_smoke
from harness import _assert_frames_equal
from spark_rapids_tpu import mem as ref_mem
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.columnar import ColumnarBatch as RefBatch
from spark_rapids_tpu.config import TpuConf as RefConf
from spark_rapids_tpu.exec.base import ExecContext as RefContext
from spark_rapids_tpu.mem.native import NativeOomState as RefNative
from spark_rapids_tpu.mem.native import load as ref_load
from spark_rapids_tpu.mem.native_spill import get_store as ref_get_store
from spark_rapids_tpu.mem.retry import split_batch_in_half as ref_split
from spark_rapids_tpu_torch import mem as port_mem
from spark_rapids_tpu_torch import native as port_native
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import (ByteRectColumn, ColumnarBatch,
                                            DictColumn, HostTable)
from spark_rapids_tpu_torch.config import TpuConf as PortConf
from spark_rapids_tpu_torch.exec.base import ExecContext as PortContext
from spark_rapids_tpu_torch.mem.native import NativeOomState as PortNative
from spark_rapids_tpu_torch.mem.native import load as port_load
from spark_rapids_tpu_torch.mem.native_spill import get_store as port_get_store
from spark_rapids_tpu_torch.mem.retry import split_batch_in_half as port_split
from test_torch_slice import prebuild_reference_native

REPO = Path(__file__).resolve().parent.parent
OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


@pytest.fixture(autouse=True)
def _port_leak_audit():
    yield
    assert port_mem.MemoryManager.audit_all_leaks() == []


class Pkg:
    """One package's memory runtime, under the names the tests use."""

    def __init__(self, name, mem, ctx_cls, conf_cls, split, native_cls,
                 load, get_store, make_batch, rows, first_ints):
        self.name = name
        self.mem = mem
        self.ctx_cls = ctx_cls
        self.conf_cls = conf_cls
        self.split = split
        self.native_cls = native_cls
        self.load = load
        self.get_store = get_store
        self.batch = make_batch
        self.rows = rows
        self.first_ints = first_ints

    def mm(self, tmp_path, budget=10**9):
        return self.mem.MemoryManager(budget, budget, str(tmp_path / "sp"))

    def ctx(self, conf, mm):
        if self.name == "ref":
            return self.ctx_cls(self.conf_cls(conf), memory=mm)
        return self.ctx_cls(self.conf_cls(conf), "cpu", memory=mm)

    def __repr__(self):
        return self.name


def _ref_batch(n=100):
    return RefBatch.from_pandas(
        pd.DataFrame({"a": range(n), "b": [float(x) for x in range(n)]}))


def _port_batch(n=100):
    return ColumnarBatch.from_host(HostTable.from_dict(
        {"a": np.arange(n), "b": np.arange(n, dtype=np.float64)}), "cpu", 64)


REF = Pkg("ref", ref_mem, RefContext, RefConf, ref_split, RefNative,
          ref_load, ref_get_store, _ref_batch,
          lambda b: b.num_rows,
          lambda b, k: b.to_arrow().column("a").to_pylist()[:k])
PORT = Pkg("port", port_mem, PortContext, PortConf, port_split, PortNative,
           port_load, port_get_store, _port_batch,
           lambda b: b.num_rows,
           lambda b, k: b.columns[0].data[:k].tolist())


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def pkg(request):
    return request.param


# ---------------------------------------------------------------------------
# the retry framework (tests/test_memory.py TestRetryFramework)
# ---------------------------------------------------------------------------

def test_retry_succeeds_after_injected_oom(pkg, tmp_path):
    mm = pkg.mm(tmp_path)
    mm.force_retry_oom(2)
    attempts = []

    def work():
        attempts.append(1)
        mm.reserve(10)
        mm.release(10)
        return "ok"

    assert pkg.mem.with_retry_no_split(work, mm) == "ok"
    assert len(attempts) == 3  # two injected failures + success


def test_split_and_retry_without_splitter_ends_in_out_of_device_memory(
        pkg, tmp_path):
    """A SplitAndRetryOOM in a no-split frame escalates to the pressure
    spill, then ends the ladder. The reference's default goes on to its
    host rung; with ``hostFallback.enabled=false`` it raises
    OutOfDeviceMemory, which is the port's only behaviour: the port has
    no host engine to degrade to."""
    mm = pkg.mm(tmp_path)
    conf = {"spark.rapids.tpu.oom.hostFallback.enabled": False}
    ctx = pkg.ctx(conf, mm)
    mm.force_split_and_retry_oom(2)
    stats = pkg.mem.RetryStats()
    with pytest.raises(pkg.mem.OutOfDeviceMemory):
        pkg.mem.with_retry_no_split(lambda: mm.reserve(10), mm, stats,
                                    ctx=ctx)
    mm.clear_injections()
    assert stats.pressure_spills == 1


def test_port_ladder_names_the_operator_and_rungs(tmp_path):
    mm = PORT.mm(tmp_path)
    mm.force_split_and_retry_oom(2)
    with pytest.raises(port_mem.OutOfDeviceMemory,
                       match=r"op=Sort.*pressure spill yes.*no host"):
        port_mem.with_retry_no_split(lambda: mm.reserve(10), mm, op="Sort")
    mm.clear_injections()


def test_with_retry_splits_input(pkg, tmp_path):
    mm = pkg.mm(tmp_path)
    sb = pkg.mem.SpillableBatch(pkg.batch(100), mm)
    mm.force_split_and_retry_oom(1)
    seen = []

    def fn(item):
        mm.reserve(1)
        mm.release(1)
        b = item.get()
        seen.append(b.num_rows)
        item.close()
        return b.num_rows

    total = sum(pkg.mem.with_retry([sb], fn, mm))
    assert total == 100
    assert sorted(seen) == [50, 50]  # split in half
    assert mm.audit_leaks() == []


def test_split_batch_closes_pieces_keeps_input_on_failure(pkg, tmp_path):
    """A failure wrapping the second piece closes the first but leaves
    the input open for the ladder to escalate with."""
    mm = pkg.mm(tmp_path)
    sb = pkg.mem.SpillableBatch(pkg.batch(100), mm)
    mm.force_split_and_retry_oom(1, skip=1)
    with pytest.raises(pkg.mem.SplitAndRetryOOM):
        pkg.split(sb)
    mm.clear_injections()
    assert not sb._closed
    assert len(mm.audit_leaks()) == 1   # the still-open input only
    sb.close()
    assert mm.audit_leaks() == []


def test_split_batch_uses_public_manager_accessor(pkg, tmp_path):
    mm = pkg.mm(tmp_path)
    sb = pkg.mem.SpillableBatch(pkg.batch(10), mm)
    assert sb.memory_manager is mm
    pieces = pkg.split(sb)
    assert sb._closed
    assert [p.memory_manager for p in pieces] == [mm, mm]
    assert [pkg.rows(p.get()) for p in pieces] == [5, 5]
    for p in pieces:
        p.close()
    assert mm.audit_leaks() == []


def test_injection_skip(pkg, tmp_path):
    mm = pkg.mm(tmp_path)
    mm.force_retry_oom(1, skip=2)
    mm.reserve(1)
    mm.reserve(1)
    with pytest.raises(pkg.mem.RetryOOM):
        mm.reserve(1)


# ---------------------------------------------------------------------------
# CheckpointRestore (TestCheckpointRestore)
# ---------------------------------------------------------------------------

class _Acc:
    def __init__(self):
        self.rows = []

    def checkpoint(self):
        self._saved = list(self.rows)

    def restore(self):
        self.rows = list(self._saved)


@pytest.mark.parametrize("checkpointed", [True, False])
def test_mutating_operator_retries(pkg, tmp_path, checkpointed):
    """Restored between attempts, the rows appear once; without the
    checkpoint the second attempt re-appends onto mutated state."""
    mm = pkg.mm(tmp_path)
    acc = _Acc()

    def work():
        acc.rows.extend(range(10))   # side effect BEFORE the OOM
        mm.reserve(1)
        mm.release(1)
        return list(acc.rows)

    mm.force_retry_oom(1)
    out = pkg.mem.with_retry_no_split(
        work, mm, retryable=acc if checkpointed else None)
    assert out == list(range(10)) * (1 if checkpointed else 2)


# ---------------------------------------------------------------------------
# the split-depth ladder (TestSplitDepthLadder)
# ---------------------------------------------------------------------------

def test_split_depth_bound_ends_in_out_of_device_memory(tmp_path):
    """A piece that still cannot fit at oom.maxSplitDepth escalates to
    the pressure spill and then, in the port, to OutOfDeviceMemory (the
    reference completes it on its host rung; the port has no host
    engine). No piece below 64/4 rows is ever split, and nothing leaks."""
    mm = PORT.mm(tmp_path)
    sb = port_mem.SpillableBatch(_port_batch(64), mm)
    stats = port_mem.RetryStats()
    calls = []

    def fn(item):
        b = item.get()
        calls.append(b.num_rows)
        raise port_mem.SplitAndRetryOOM("still too big")

    with pytest.raises(port_mem.OutOfDeviceMemory, match="maxSplitDepth=2"):
        list(port_mem.with_retry([sb], fn, mm, stats=stats,
                                 max_split_depth=2))
    assert min(calls) >= 16
    assert stats.splits >= 2
    assert stats.pressure_spills == 1
    assert mm.audit_leaks() == []


def test_unsplittable_single_row_ends_in_out_of_device_memory(tmp_path):
    """The reference runs a one-row batch that never fits on its host
    rung; the port raises OutOfDeviceMemory and leaks nothing."""
    mm = PORT.mm(tmp_path)
    sb = port_mem.SpillableBatch(_port_batch(1), mm)

    def fn(item):
        item.get()
        raise port_mem.SplitAndRetryOOM("cannot ever fit")

    with pytest.raises(port_mem.OutOfDeviceMemory, match="split failed"):
        list(port_mem.with_retry([sb], fn, mm))
    assert mm.audit_leaks() == []


def test_pieces_that_fit_after_a_split_complete(pkg, tmp_path):
    """The split rung alone: a 64-row batch that fits only in quarters."""
    mm = pkg.mm(tmp_path)
    sb = pkg.mem.SpillableBatch(pkg.batch(64), mm)
    calls = []

    def fn(item):
        b = item.get()
        if b.num_rows > 16:
            raise pkg.mem.SplitAndRetryOOM("too big")
        calls.append(b.num_rows)
        item.close()
        return b.num_rows

    assert sum(pkg.mem.with_retry([sb], fn, mm)) == 64
    assert calls == [16, 16, 16, 16]
    assert mm.audit_leaks() == []


# ---------------------------------------------------------------------------
# spilling (TestSpill, TestMemoryChaosSites' spill-all case)
# ---------------------------------------------------------------------------

def test_spill_everything_spills_registered_instances(pkg, tmp_path):
    mm = pkg.mm(tmp_path)
    sb = pkg.mem.SpillableBatch(pkg.batch(500), mm)
    assert sb.tier == "device"
    freed = mm.spill_everything()
    assert freed > 0 and sb.tier == "host"
    assert pkg.rows(sb.get()) == 500   # unspill round-trips
    sb.close()


def test_spill_to_host_and_back(pkg, tmp_path):
    mm = pkg.mm(tmp_path)
    sb = pkg.mem.SpillableBatch(pkg.batch(1000), mm)
    used = mm.device_used
    assert used > 0
    freed = sb.spill_to_host()
    assert freed > 0 and sb.tier == "host"
    assert mm.device_used == used - freed
    b = sb.get()
    assert sb.tier == "device"
    assert pkg.rows(b) == 1000
    sb.close()
    assert mm.device_used == 0


def test_spill_to_disk_roundtrip(pkg, tmp_path):
    mm = pkg.mm(tmp_path)
    sb = pkg.mem.SpillableBatch(pkg.batch(500), mm)
    sb.spill_to_host()
    sb.spill_to_disk()
    assert sb.tier == "disk"
    b = sb.get()
    assert pkg.rows(b) == 500
    assert pkg.first_ints(b, 3) == [0, 1, 2]
    sb.close()
    assert mm.stats()["disk_used"] == 0


def test_budget_pressure_triggers_spill(pkg, tmp_path):
    b = pkg.batch(1000)
    size = b.device_size_bytes()
    mm = pkg.mm(tmp_path, budget=int(size * 1.5))
    sb = pkg.mem.SpillableBatch(b, mm)
    # a second reservation must push the first one out
    mm.reserve(size)
    assert sb.tier == "host"
    mm.release(size)
    sb.close()


def test_oversized_reserve_raises_split(pkg, tmp_path):
    mm = pkg.mm(tmp_path, budget=1000)
    with pytest.raises(pkg.mem.SplitAndRetryOOM):
        mm.reserve(2000)


def _mixed_batch(n: int):
    """A port batch with a dictionary, a byte rectangle (ASCII and not),
    a host string column and a nullable double."""
    rng = np.random.RandomState(11)
    comments = chip_smoke.gen_comment(n)
    words = np.array([f"wörd{i}" for i in range(n)], dtype=object)
    words[::7] = None
    price = np.ma.MaskedArray(rng.rand(n), mask=rng.rand(n) < 0.2)
    return ColumnarBatch.from_host(HostTable.from_dict({
        "mode": rng.choice(["AIR", "MAIL", "SHIP"], n),
        "comment": comments, "word": words, "price": price}), "cpu", 64)


def _same_batch(a: ColumnarBatch, b: ColumnarBatch) -> None:
    assert a.num_rows == b.num_rows and a.schema == b.schema
    for x, y in zip(a.columns, b.columns):
        assert type(x) is type(y)
        vx, mx = x.to_numpy(a.num_rows)
        vy, my = y.to_numpy(b.num_rows)
        np.testing.assert_array_equal(mx, my)
        np.testing.assert_array_equal(vx[mx], vy[my])
        if isinstance(x, DictColumn):
            assert list(x.dictionary) == list(y.dictionary)
        if isinstance(x, ByteRectColumn):
            assert x.ascii_only == y.ascii_only
            np.testing.assert_array_equal(x.lengths.numpy(),
                                          y.lengths.numpy())


@pytest.mark.parametrize("native", [True, False])
def test_dict_and_rect_columns_survive_both_tiers(tmp_path, monkeypatch,
                                                  native):
    """A batch with a dictionary column, ASCII and non-ASCII byte
    rectangles and a host column, spilled to the host and to the disk
    (through the native slab store, or one file a batch where no g++
    built it), comes back the same."""
    from spark_rapids_tpu_torch.mem import spillable
    if not native:
        monkeypatch.setattr(spillable.SpillableBatch, "_native_store",
                            lambda self: None)
    batch = _mixed_batch(3000)
    kinds = [type(c).__name__ for c in batch.columns]
    assert kinds == ["DictColumn", "ByteRectColumn", "ByteRectColumn",
                     "DeviceColumn"]
    word = ColumnarBatch.from_host(HostTable.from_dict(
        {"w": np.array([f"{i}" * 70 for i in range(9)] + [None],
                       dtype=object)}), "cpu", 64)
    assert type(word.columns[0]).__name__ == "HostColumn"
    assert not batch.columns[2].ascii_only
    mm = PORT.mm(tmp_path)
    for b in (batch, word):
        sb = port_mem.SpillableBatch(b, mm)
        assert sb.spill_to_host() == b.device_size_bytes()
        _same_batch(b, sb._host_batch)
        assert sb.spill_to_disk() == b.device_size_bytes()
        assert sb.tier == "disk" and mm.stats()["disk_used"] > 0
        assert (sb._disk_block is not None) == native
        assert mm.stats()["disk_store"] == ("native" if native else "files")
        _same_batch(b, sb.get())
        assert sb.tier == "device"
        sb.close()
    st = mm.stats()
    assert st["host_used"] == 0 and st["disk_used"] == 0
    assert st["device_used"] == 0
    assert os.listdir(tmp_path / "sp") == [] or native


def test_unspill_keeps_the_spilled_copy_when_the_reserve_fails(tmp_path):
    """The reference's r14 order: reserve on the device before the source
    tier is dismantled."""
    mm = PORT.mm(tmp_path)
    sb = port_mem.SpillableBatch(_port_batch(100), mm)
    sb.spill_to_host()
    sb.spill_to_disk()
    mm.force_split_and_retry_oom(1)
    with pytest.raises(port_mem.SplitAndRetryOOM):
        sb.get()
    assert sb.tier == "disk" and mm.stats()["disk_used"] > 0
    assert PORT.first_ints(sb.get(), 3) == [0, 1, 2]
    sb.close()


def test_threads_moving_batches_back_under_pressure_finish(tmp_path):
    """Threads that take spillable batches back to the device (inside the
    retry frame, as operators do) while the budget and the host store
    each hold about one of them keep spilling one another's batches to
    the host and the disk. A batch another thread holds is no spill
    candidate: two threads moving batches back must not each wait for
    the other's batch. Every batch comes back whole."""
    batches = [_port_batch(1000) for _ in range(8)]
    for i, b in enumerate(batches):
        b.columns[0].data += 1000 * i
    size = batches[0].device_size_bytes()
    mm = port_mem.MemoryManager(int(size * 1.5), int(size * 1.5),
                                str(tmp_path / "sp"))
    sbs = [port_mem.SpillableBatch(b, mm) for b in batches]
    errors = []

    def work(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(300):
                i = int(rng.randint(len(sbs)))
                got = port_mem.with_retry_no_split(sbs[i].get, mm)
                assert int(got.columns[0].data[0]) == 1000 * i
        except BaseException as e:     # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work, args=(s,), daemon=True)
               for s in range(6)]
        [t.start() for t in ths]
        [t.join(timeout=60) for t in ths]
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ths), "threads deadlocked"
    assert not errors, errors[:2]
    st = mm.stats()
    assert st["spill_to_host_bytes"] > 0 and st["spill_to_disk_bytes"] > 0
    for sb in sbs:
        sb.close()
    assert mm.audit_leaks() == [] and mm.device_used == 0


# ---------------------------------------------------------------------------
# the semaphore (TestSemaphore)
# ---------------------------------------------------------------------------

def test_semaphore_limits_concurrency(pkg):
    sem = pkg.mem.DeviceSemaphore(2)
    active, peak = [], []
    lock = threading.Lock()

    def task():
        with sem.held():
            with lock:
                active.append(1)
                peak.append(len(active))
            time.sleep(0.01)
            with lock:
                active.pop()

    threads = [threading.Thread(target=task) for _ in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=30) for t in threads]
    assert not any(t.is_alive() for t in threads)
    assert max(peak) <= 2
    assert sem.acquires == 8


def test_semaphore_reentrant(pkg):
    sem = pkg.mem.DeviceSemaphore(1)
    with sem.held():
        with sem.held():
            pass
    with sem.held():
        pass


def test_wedge_watchdog_force_releases_dead_holder(pkg):
    sem = pkg.mem.DeviceSemaphore(1, timeout_s=10.0, wedge_timeout_ms=150)
    t = threading.Thread(target=sem.acquire, name="doomed")
    t.start()
    t.join()
    assert len(sem.diagnostics()["holders"]) == 1
    t0 = time.monotonic()
    with sem.held():                  # recovers via force-release
        pass
    assert time.monotonic() - t0 < 5.0
    assert sem.wedges == 1
    assert sem.diagnostics()["holders"] == []


def test_wedge_diagnostics_in_timeout_error(pkg):
    """A live stalled holder is never force-released; the waiter's
    TimeoutError carries the holder/waiter diagnostics."""
    sem = pkg.mem.DeviceSemaphore(1, timeout_s=0.4, wedge_timeout_ms=100)
    evt = threading.Event()

    def hog():
        with sem.held():
            evt.wait(5.0)

    t = threading.Thread(target=hog, name="hog")
    t.start()
    time.sleep(0.05)
    try:
        with pytest.raises(TimeoutError, match="holders"):
            sem.acquire()
    finally:
        evt.set()
        t.join(timeout=5)
    assert sem.wedges == 0


def test_diagnostics_carry_memory_stats(pkg, tmp_path):
    sem = pkg.mem.DeviceSemaphore(2, memory=pkg.mm(tmp_path))
    d = sem.diagnostics()
    assert d["permits"] == 2
    assert "budget" in d["memory"]


# ---------------------------------------------------------------------------
# native libraries (tests/test_native_oom.py, the disk store cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def native_state(pkg):
    if pkg.load() is None:
        pytest.fail("g++ is available in this environment")
    yield pkg.native_cls(1000)
    # the native machine is process-global: restore the singleton
    # manager's budget so later query tests are not squeezed into 1000
    for mm in pkg.mem.MemoryManager._instances.values():
        if mm._native is not None:
            mm._native.lib.oom_init(mm.budget)


def test_native_reserve_release(native_state):
    st = native_state
    assert st.reserve(400) == 0
    assert st.used == 400
    assert st.reserve(600) == 0
    assert st.used == 1000
    assert st.reserve(1) == 1  # full -> retry
    st.release(500)
    assert st.reserve(1) == 0
    assert st.max_used == 1000


def test_native_oversized_is_split(native_state):
    assert native_state.reserve(2000) == 2


def test_native_injection_with_skip(native_state):
    st = native_state
    st.force_retry_oom(2, skip=1)
    assert st.reserve(1) == 0   # skipped
    assert st.reserve(1) == 1   # injected
    assert st.reserve(1) == 1   # injected
    assert st.reserve(1) == 0
    assert st.retry_count() == 2


def test_native_split_injection(native_state):
    native_state.force_split_and_retry_oom(1)
    assert native_state.reserve(1) == 2
    assert native_state.reserve(1) == 0


def test_native_clear_injections(native_state):
    native_state.force_retry_oom(5)
    native_state.clear_injections()
    assert native_state.reserve(1) == 0


def test_native_blocked_thread_wakes_on_release(native_state):
    st = native_state
    assert st.reserve(900) == 0
    results = {}

    def blocked():
        results["rc"] = st.reserve(500, block_ms=2000)

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.1)
    assert st.blocked_threads == 1
    st.release(900)  # wakes the waiter
    t.join(timeout=3)
    assert results["rc"] == 0
    assert st.used == 500


def test_native_block_timeout(native_state):
    st = native_state
    assert st.reserve(1000) == 0
    t0 = time.perf_counter()
    assert st.reserve(500, block_ms=100) == 3
    assert 0.05 < time.perf_counter() - t0 < 1.0


def test_singleton_manager_uses_native(pkg):
    conf = pkg.conf_cls()
    mm = pkg.mem.MemoryManager.get(conf) if pkg.name == "ref" else \
        pkg.mem.MemoryManager.get(conf, "cpu")
    first = next(iter(pkg.mem.MemoryManager._instances.values()))
    assert first._native is not None
    assert mm.budget > 0


def test_native_spill_store_roundtrip(pkg, tmp_path):
    st = pkg.get_store(str(tmp_path / "spill"))
    assert st is not None, "g++ is available in this environment"
    ids = [st.write(bytes([i]) * (1000 + i)) for i in range(8)]
    for i, bid in enumerate(ids):
        assert st.read(bid) == bytes([i]) * (1000 + i)
    stats = st.stats()
    assert stats["live_blocks"] == 8 and stats["slab_files"] == 1
    for bid in ids[:4]:
        st.free(bid)
    assert st.stats()["live_blocks"] == 4
    with pytest.raises(KeyError):
        st.read(ids[0])


def test_host_libraries_build_once_under_concurrent_starts(tmp_path):
    """Processes that start together in a fresh build directory each
    load a whole library: one compiles under the lock, through a
    temporary file and a rename; the others wait and load it."""
    code = ("import sys, ctypes\n"
            "from pathlib import Path\n"
            "from spark_rapids_tpu_torch import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "for name in ('oom_state', 'spill_store'):\n"
            "    ctypes.CDLL(str(native.build_host(name)))\n"
            "print('loaded')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o[0].strip() == "loaded" for o in outs)
    libs = sorted(p.name for p in tmp_path.glob("*.so"))
    assert len(libs) == 2 and not list(tmp_path.glob("*.tmp"))
    assert port_native.build_host("oom_state").exists()


# ---------------------------------------------------------------------------
# operators under injected OOMs and memory pressure
# ---------------------------------------------------------------------------

def _ref_session(conf=None):
    return TpuSession({**OFF, **(conf or {})})


def _port_session(conf=None):
    return TorchSession({**OFF, **(conf or {})}, device="cpu")


def _frames(got_df, want_df):
    return (got_df.collect_arrow().to_pandas().reset_index(drop=True),
            want_df.to_pandas().reset_index(drop=True))


def _kv_table(n=4096):
    rng = np.random.RandomState(3)
    return pa.table({"k": pa.array(rng.randint(0, 300, n)),
                     "s": pa.array(rng.choice(["a", "b", "c"], n)),
                     "v": pa.array(rng.randint(-1000, 1000, n))})


QUERIES = {
    "keyed_sort_path": lambda df, F: df.group_by("k").agg(
        F.sum(F.col("v")).with_name("s"),
        F.count_star().with_name("n")).order_by("k"),
    "keyed_dense_path": lambda df, F: df.group_by("s").agg(
        F.sum(F.col("v")).with_name("sv")).order_by("s"),
    "sort": lambda df, F: df.filter(F.col("v") > F.lit(900)).order_by(
        F.col("v").desc(), F.col("k").asc()),
}

#: (RetryOOMs, SplitAndRetryOOMs)
INJECTIONS = {"retry": (2, 0), "split": (0, 1), "both": (2, 1)}


@pytest.mark.parametrize("inject", sorted(INJECTIONS))
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_operators_under_injected_ooms_equal_reference(query, inject):
    """ref HashAggregateRetrySuite: OOMs injected into a multi-batch
    aggregate or sort (5 batches) leave the result as it was. RetryOOMs
    are absorbed where a spillable reserves; a SplitAndRetryOOM must land
    inside a retried step, where the ladder's pressure spill answers it:
    an aggregate's update (the second batch's), or the sort's closure,
    whose inputs a small budget has pushed to the host (the sort wraps
    its 5 inputs outside any retried step, as the reference's does)."""
    table = _kv_table()
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1000}
    want = QUERIES[query](_ref_session(conf).create_dataframe(table), RF)
    skip = 1
    if query == "sort":
        conf["spark.rapids.tpu.memory.hbm.limitBytes"] = 1500
        skip = 5
    s = _port_session(conf)
    mm = s.memory
    retries, splits = INJECTIONS[inject]
    before = mm.injections_fired()
    if splits:
        mm.force_split_and_retry_oom(splits, skip=skip)
    if retries:
        mm.force_retry_oom(retries, skip=1)
    try:
        got, want = _frames(QUERIES[query](s.create_dataframe(table), PF),
                            want)
        fired = mm.injections_fired()
    finally:
        mm.clear_injections()
    _assert_frames_equal(got, want, approximate_float=False)
    assert fired["retry"] - before["retry"] == retries
    assert fired["split"] - before["split"] == splits
    assert s.last_retry_stats.pressure_spills == (1 if splits else 0)


def test_agg_survives_injected_retry_oom_as_the_reference():
    """tests/test_memory.py TestAggregateUnderOOM, on both packages."""
    table = _kv_table()
    q = QUERIES["keyed_sort_path"]
    out = {}
    for name, session, F in (("ref", _ref_session(), RF),
                             ("port", _port_session(), PF)):
        df = q(session.create_dataframe(table, num_partitions=4), F)
        mm = session.exec_context().memory
        mm.force_retry_oom(1)
        try:
            out[name] = df.collect()
        finally:
            mm.clear_injections()
    assert out["port"] == out["ref"]


def test_q18_agg_under_a_spilling_budget_equals_reference():
    """Q18's inner aggregate at 50k rows, in 8192-row batches: seven
    sort-path partials, then under a budget of half their bytes (at least
    twice the largest) and a host store below that, partials reach the
    host and the disk tiers, and the merge brings them back."""
    t = chip_smoke.gen_table(50000)
    del t["l_comment"]
    table = pa.table({k: pa.array(v) for k, v in t.items()})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 8192}
    want = chip_smoke.q18_agg(_ref_session(conf).create_dataframe(table), RF)
    s = _port_session(conf)
    got, want = _frames(chip_smoke.q18_agg(s.create_dataframe(table), PF),
                        want)
    _assert_frames_equal(got, want, approximate_float=False)
    assert len(got) > 10
    assert chip_smoke.rows_equal(got.to_dict("records"),
                                 chip_smoke.q18_agg_numpy(t))
    # the partials' bytes, by the same update on the port
    parts = []
    agg = chip_smoke.q18_agg(s.create_dataframe(table), PF)._physical()
    while type(agg).__name__ != "TpuHashAggregateExec":
        agg = agg.children[0]
    agg._dicts = []
    for b in agg.children[0].execute(s.exec_context()):
        parts.append(agg._update(b).device_size_bytes())
    assert len(parts) == 7
    budget = max(sum(parts) // 2, 2 * max(parts))
    pressured = {**conf, "spark.rapids.tpu.memory.hbm.limitBytes": budget,
                 "spark.rapids.tpu.memory.host.spillStorageSize": budget // 2,
                 "spark.rapids.tpu.memory.leakDetection": True}
    with _port_session(pressured) as ps:
        got2 = chip_smoke.q18_agg(ps.create_dataframe(table), PF) \
            .collect_arrow().to_pandas()
        st = ps.memory.stats()
    _assert_frames_equal(got2, want, approximate_float=False)
    assert st["spill_to_host_bytes"] > 0 and st["spill_to_disk_bytes"] > 0
    assert st["max_device_used"] <= budget
    assert st["device_used"] == st["host_used"] == st["disk_used"] == 0


# ---------------------------------------------------------------------------
# a session's threads, the query deadline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("permits", [1, 2])
def test_two_threads_share_the_session_semaphore(permits):
    t = chip_smoke.gen_table(6000)
    del t["l_comment"]
    want1 = chip_smoke.q1_numpy(t)
    want6 = chip_smoke.q6_numpy(t)
    s = _port_session({"spark.rapids.tpu.sql.concurrentTpuTasks": permits,
                       "spark.rapids.tpu.sql.batchSizeRows": 500})
    host = HostTable.from_dict(t)
    results, errors, peak = {}, [], [0]
    done = threading.Event()

    def run(name, q):
        try:
            for _ in range(3):
                results.setdefault(name, []).append(
                    q(s.create_dataframe(host), PF).collect())
        except BaseException as e:   # reported by the main thread
            errors.append(e)

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0],
                          len(s.semaphore.diagnostics()["holders"]))
            time.sleep(0.0005)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sampler = threading.Thread(target=sample)
        sampler.start()
        ths = [threading.Thread(target=run, args=("q1", chip_smoke.q1)),
               threading.Thread(target=run, args=("q6", chip_smoke.q6))]
        [th.start() for th in ths]
        [th.join(timeout=120) for th in ths]
        done.set()
        sampler.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths) and not errors, errors
    assert all(chip_smoke.q1_equal(r, want1) for r in results["q1"])
    assert all(abs(r[0]["revenue"] - want6) <= 1e-9 * want6
               for r in results["q6"])
    assert 1 <= peak[0] <= permits
    assert s.semaphore.diagnostics()["holders"] == []


def test_query_timeout_unwinds_leak_free():
    table = _kv_table()
    s = _port_session({"spark.rapids.tpu.sql.batchSizeRows": 500,
                       "spark.rapids.tpu.query.timeout": 1e-6})
    df = QUERIES["keyed_sort_path"](s.create_dataframe(table), PF)
    with pytest.raises(port_mem.QueryTimeout):
        df.collect()
    assert s.semaphore.diagnostics()["holders"] == []
    assert s.semaphore.deadline is None


def test_session_close_raises_on_a_leak():
    s = _port_session({"spark.rapids.tpu.memory.leakDetection": True})
    sb = port_mem.SpillableBatch(_port_batch(10), s.memory)
    with pytest.raises(AssertionError, match="leaked"):
        s.close()
    sb.close()
    s.close()
