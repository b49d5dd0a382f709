"""count/sum/avg(DISTINCT) and the distinct-flag kernel against the
reference, on the CPU.

* ``tpcds.q9`` and ``tpcds.q28`` unmodified on both packages, with the
  distinct flag and with the two-level rewrite
  (``spark.rapids.tpu.sql.hashDistinct.enabled=false``): counts and
  distinct counts exactly, averages to a relative 1e-12 (the two
  packages add the rows in other orders: the reference's one-hot
  reductions against the port's dense groupby and torch sums);
* the reference's hash-distinct cases (tests/test_hash_distinct.py) on
  both packages: grouped, keyless with sum/avg DISTINCT, NaN/-0.0/NULL
  values, a NULL group, many batches with table growth, the q28 shape,
  and the branch id grouped by direct addressing (the dense route);
* the port's ``HashDistinctFlagExec`` flags equal to the reference's exec
  (run on XLA:CPU) over the same batches, row for row;
* the kernel's row logic (csrc/distinct_flag_row.cuh) built by g++: its
  normalisation equal to ``normalize``; its launch run on the host as the
  kernel runs it: phase 1's rows' insert-or-find steps interleaved in
  shuffled orders (so probers meet claimed, unpublished slots), the grid
  barrier, phase 2's marks, with a thread's rows past its first through
  scratch; and its rehash, through the wrapper's own flow, equal to
  ``distinct_flag_reference`` bit for bit, with the key count equal to
  the keys inserted; a full table sets the error word;
* the count's pinned word: a word names the epoch that wrote it, and
  only a queued epoch's word is taken;
* the table's sizing from the key count with the kernel's stores to the
  word landing at once, late or never: the keys after a batch load it
  to at most half, and it is never above the reference's row-bound size.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.exec.base import ExecContext as RExecContext
from spark_rapids_tpu.exec.basic import InMemoryScanExec as RScan
from spark_rapids_tpu.exec.distinct_flag import \
    HashDistinctFlagExec as RFlagExec
from spark_rapids_tpu.exprs.base import ColumnRef as RColumnRef
from spark_rapids_tpu.types import Schema as RSchema
from spark_rapids_tpu.types import StructField as RStructField
from spark_rapids_tpu.types import from_arrow as r_from_arrow
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar.batch import HostTable
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.exec import distinct_flag as df
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec
from spark_rapids_tpu_torch.exprs.base import ColumnRef

from test_torch_slice import prebuild_reference_native

sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "benchmarks"))
import tpcds  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc"
#: the reference plans the distinct flag only off the device mesh
REF_CONF = {"spark.rapids.tpu.sql.optimizer.enabled": False,
            "spark.rapids.tpu.distributed.enabled": False}
OFF_HASH = {"spark.rapids.tpu.sql.hashDistinct.enabled": False}
#: averages: the packages add the same rows in other orders
REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _ref(conf=None):
    return TpuSession({**REF_CONF, **(conf or {})})


def _port(conf=None):
    return TorchSession({"spark.rapids.tpu.sql.optimizer.enabled": False,
                         **(conf or {})}, device="cpu")


def _rows_equal(got, want, rel=REL):
    """Same rows in the same order: ints, None and NaN exactly, floats to
    ``rel``."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, float) and gv is not None:
                if np.isnan(wv):
                    assert np.isnan(gv), (k, g, w)
                else:
                    assert abs(gv - wv) <= rel * max(abs(wv), 1e-300), \
                        (k, g, w)
            else:
                assert gv == wv, (k, g, w)


def _both(query, table, conf=None, ref_conf=None, parts=1):
    """(port rows, reference rows) of ``query(df, F)`` over ``table``."""
    got = query(_port(conf).create_dataframe(table, num_partitions=parts),
                PF).collect()
    want = query(_ref(ref_conf or conf).create_dataframe(
        table, num_partitions=parts), RF).collect()
    return got, want


def _sort_by(rows, key):
    return sorted(rows, key=lambda r: (r[key] is None, r[key]))


# ---------------------------------------------------------------------------
# q9 and q28, unmodified
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conf", [{}, OFF_HASH], ids=["hash", "two_level"])
def test_q28_unmodified_on_both_packages(conf):
    tab = tpcds.gen_store_sales(20000, seed=11)
    got, want = _both(tpcds.q28, tab, conf, parts=3)
    assert [r["b_cnt"] for r in got] == [r["b_cnt"] for r in want]
    assert [r["b_cntd"] for r in got] == [r["b_cntd"] for r in want]
    _rows_equal(got, want)


def test_q9_unmodified_on_both_packages():
    tab = tpcds.gen_store_sales(20000, seed=12)
    got, want = _both(tpcds.q9, tab,
                      {"spark.rapids.tpu.sql.batchSizeRows": 4096})
    _rows_equal(got, want)


def test_chip_smoke_copies_equal_the_benchmark():
    """chip_smoke.py's numpy-only copies of q9 and q28 give the
    benchmark's rows on the port, and its numpy references equal them."""
    import chip_smoke
    tab = tpcds.gen_store_sales(12000, seed=7)
    ss = chip_smoke.gen_store_sales(12000)
    s = _port()
    for query, copy, ref in ((tpcds.q9, chip_smoke.q9, chip_smoke.q9_numpy),
                             (tpcds.q28, chip_smoke.q28,
                              chip_smoke.q28_numpy)):
        got = query(s.create_dataframe(tab), PF).collect()
        assert copy(s.create_dataframe(ss), PF).collect() == got
        want = ref(ss)
        assert chip_smoke.stats_equal(got, want, REL), (got, want)


def test_hash_and_two_level_agree_on_q28():
    tab = tpcds.gen_store_sales(15000, seed=13)
    a = tpcds.q28(_port().create_dataframe(tab), PF).collect()
    b = tpcds.q28(_port(OFF_HASH).create_dataframe(tab), PF).collect()
    assert [(r["b_cnt"], r["b_cntd"]) for r in a] == \
        [(r["b_cnt"], r["b_cntd"]) for r in b]
    _rows_equal(a, b)


# ---------------------------------------------------------------------------
# the reference's hash-distinct cases on both packages
# ---------------------------------------------------------------------------

def _int_table(rng, n, cols):
    out = {}
    for name, (lo, hi, nulls) in cols.items():
        v = rng.randint(lo, hi, n).astype(np.int32)
        out[name] = pa.array(v, mask=(rng.rand(n) < 0.1) if nulls else None)
    return pa.table(out)


def _grouped(df, F):
    return (df.group_by("k")
            .agg(F.count_distinct(F.col("v")).with_name("cd"),
                 F.sum(F.col("w")).with_name("sw"),
                 F.count_star().with_name("n")))


@pytest.mark.parametrize("conf", [{}, OFF_HASH], ids=["hash", "two_level"])
def test_grouped_count_distinct(conf):
    t = _int_table(np.random.RandomState(5), 6000,
                   {"k": (0, 7, True), "v": (0, 200, True),
                    "w": (-1000, 1000, False)})
    q = _grouped(_port(conf).create_dataframe(t), PF)
    assert ("DistinctFlag" in q._physical().tree_string()) == (not conf)
    got, want = _both(_grouped, t, conf)
    assert _sort_by(got, "k") == _sort_by(want, "k")


@pytest.mark.parametrize("conf", [{}, OFF_HASH], ids=["hash", "two_level"])
def test_keyless_sum_and_avg_distinct(conf):
    t = _int_table(np.random.RandomState(6), 3000, {"v": (0, 50, True)})

    def q(df, F):
        return df.agg(F.count_distinct(F.col("v")).with_name("cd"),
                      F.sum_distinct(F.col("v")).with_name("sd"),
                      F.avg_distinct(F.col("v")).with_name("ad"))
    got, want = _both(q, t, conf)
    _rows_equal(got, want)


def test_nan_negative_zero_and_null_values():
    """SQL distinct: NULL ignored, NaN is one value, -0.0 == 0.0."""
    t = pa.table({
        "k": pa.array([0, 0, 0, 0, 0, 1, 1, 1] * 64, pa.int64()),
        "v": pa.array([1.5, float("nan"), float("nan"), -0.0, 0.0,
                       None, float("nan"), 2.0] * 64)})

    def q(df, F):
        return df.group_by("k").agg(
            F.count_distinct(F.col("v")).with_name("cd"),
            F.sum_distinct(F.col("v")).with_name("sd"))
    got, want = _both(q, t)
    assert {r["k"]: r["cd"] for r in got} == {0: 3, 1: 2}
    _rows_equal(_sort_by(got, "k"), _sort_by(want, "k"))


def test_null_group_is_a_group():
    t = _int_table(np.random.RandomState(7), 4000,
                   {"k": (0, 3, True), "v": (0, 40, False)})

    def q(df, F):
        return df.group_by("k").agg(
            F.count_distinct(F.col("v")).with_name("cd"))
    got, want = _both(q, t)
    assert None in [r["k"] for r in got]
    assert _sort_by(got, "k") == _sort_by(want, "k")


def test_many_batches_and_growth(monkeypatch):
    """Keys repeat across batches of a partitioned scan, and a small
    first table grows several times."""
    monkeypatch.setattr(df.HashDistinctFlagExec, "_MIN_SLOTS", 1 << 10)
    t = _int_table(np.random.RandomState(8), 20000,
                   {"k": (0, 5, False), "v": (0, 100000, False)})

    def q(d, F):
        return d.group_by("k").agg(
            F.count_distinct(F.col("v")).with_name("cd"),
            F.count(F.col("v")).with_name("c"))
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 4096}
    port = _port(conf)
    got = q(port.create_dataframe(t, num_partitions=8), PF).collect()
    flag = port.last_plan
    while not isinstance(flag, df.HashDistinctFlagExec):
        flag = flag.children[0]
    assert flag.last_growths >= 2, flag.last_growths
    want = q(_ref(conf).create_dataframe(t, num_partitions=8),
             RF).collect()
    assert _sort_by(got, "k") == _sort_by(want, "k")


def test_string_value_stays_on_the_two_level_path():
    t = pa.table({"k": pa.array([1, 1, 2] * 100, pa.int64()),
                  "v": pa.array(["a", "b", "a"] * 100)})

    def q(d, F):
        return d.group_by("k").agg(
            F.count_distinct(F.col("v")).with_name("cd"))
    assert "DistinctFlag" not in q(_port().create_dataframe(t),
                                   PF)._physical().tree_string()
    got, want = _both(q, t)
    assert _sort_by(got, "k") == _sort_by(want, "k")


def test_q28_shape_and_direct_addressing(monkeypatch):
    """The union-of-aggregates single pass with the distinct flag: one
    scan, no union, the branch id through the dense route; on one batch
    and on several."""
    calls = []
    real = pagg.dense_groupby

    def spy(*a, **k):
        calls.append(a[-1])
        return real(*a, **k)
    monkeypatch.setattr(pagg, "dense_groupby", spy)
    tab = tpcds.gen_store_sales(30000, seed=11)
    for parts in (1, 5):
        calls.clear()
        q = tpcds.q28(_port().create_dataframe(tab, num_partitions=parts),
                      PF)
        tree = q._physical().tree_string()
        assert "DistinctFlag" in tree and "BranchAlign" in tree, tree
        assert "Union" not in tree and tree.count("InMemoryScan") == 1, tree
        assert "route=dense" in tree, tree
        got = q.collect()
        assert len(calls) == parts and set(calls) == {16}, calls
        want = tpcds.q28(_ref().create_dataframe(tab, num_partitions=parts),
                         RF).collect()
        _rows_equal(got, want)


# ---------------------------------------------------------------------------
# the exec's flags against the reference's exec, row for row
# ---------------------------------------------------------------------------

def _flag_table(rng, n, vkind, gkind):
    pool = {"f64": np.array([np.nan, -np.nan, -0.0, 0.0, 1.5, -2.25, np.inf,
                             3.0]),
            "f32": np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 7.0],
                            np.float32),
            "i8": np.array([-128, -1, 0, 1, 5, 127], np.int8),
            "i64": np.arange(-40, 40, dtype=np.int64)}
    cols = {}
    for name, kind in (("v", vkind), ("g", gkind)):
        if kind is None:
            continue
        p = pool[kind]
        cols[name] = pa.array(p[rng.randint(0, len(p), n)],
                              mask=rng.rand(n) < 0.1)
    return pa.table(cols)


def _ref_flags(t, keys, batch_rows):
    schema = RSchema([RStructField(f.name, r_from_arrow(f.type), True)
                      for f in t.schema])
    ex = RFlagExec([RColumnRef(k) for k in keys], RColumnRef("v"), "__hd",
                   RScan([t], schema, batch_rows=batch_rows))
    return np.concatenate([b.to_arrow().column("__hd").to_numpy(
        zero_copy_only=False) for b in ex.execute(RExecContext())])


def _port_flags(t, keys, batch_rows):
    host = HostTable.from_arrow(t)
    ex = df.HashDistinctFlagExec(
        [ColumnRef(k) for k in keys], ColumnRef("v"), "__hd",
        InMemoryScanExec([host], host.schema, batch_rows=batch_rows))
    vals, valid = ex.collect(ExecContext(device="cpu"))[-1]
    assert valid.all()
    return vals


@pytest.mark.parametrize("vkind,gkind,batch_rows", [
    ("f64", "i64", 97), ("f32", "i8", 64), ("i8", None, 50),
    ("f64", "f32", 1000)])
def test_exec_flags_equal_the_reference_exec(vkind, gkind, batch_rows):
    t = _flag_table(np.random.RandomState(len(vkind) + batch_rows), 1200,
                    vkind, gkind)
    keys = [] if gkind is None else ["g"]
    got = _port_flags(t, keys, batch_rows)
    want = _ref_flags(t, keys, batch_rows)
    assert got.tolist() == want.tolist()
    assert got.any()


# ---------------------------------------------------------------------------
# the kernel's row logic, built by g++ and run on the host
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <algorithm>
#include <random>
#include <vector>
#include "distinct_flag_row.cuh"

// csrc/distinct_flag.cu's DistinctFlagArgs
struct Args {
  const void* val; int64_t vkind; const uint8_t* vvalid;
  const void* grp; int64_t gkind; const uint8_t* gvalid;
  int64_t n; DfSlot* table; int64_t capacity; int32_t* slot_of_row;
  uint8_t* flags; int32_t* error;
  unsigned long long* keys; unsigned long long* host_keys; int64_t epoch;
};

// csrc/distinct_flag.cu's kThreads
constexpr int64_t kThreads = 256;

struct HostOps {
  uint32_t load(uint32_t* w) const { return *w; }
  uint32_t cas(uint32_t* w, uint32_t e, uint32_t v) const {
    uint32_t o = *w;
    if (o == e) *w = v;
    return o;
  }
  void publish(uint32_t* w, uint32_t v) const { *w = v; }
  int64_t load64(int64_t* w) const { return *w; }
  void min(int32_t* w, int32_t v) const { if (v < *w) *w = v; }
};

struct Thread {
  int64_t row, val, grp;
  bool gnull;
  uint32_t ready;
  int32_t first;
  DfProbe p;
  int64_t slot;
};

// Run every thread's steps to the end, one step of a random thread at a
// time: a thread that has claimed a slot may wait while others meet it
// BUSY. Returns the threads with their results, in finishing order.
static std::vector<Thread> run(std::vector<Thread> live, DfSlot* table,
                               int64_t mask, bool copy, int32_t* error,
                               uint64_t seed) {
  std::mt19937_64 rng(seed);
  std::vector<Thread> done;
  while (!live.empty()) {
    size_t k = rng() % live.size();
    Thread& t = live[k];
    int r = df_step(table, mask, t.val, t.grp, t.gnull, t.ready, t.first,
                    copy, t.p, &t.slot, HostOps());
    if (r == DF_AGAIN) continue;
    if (r == DF_FAIL) {
      *error |= 1;
      t.slot = -1;
      t.p.owned = 0;
    }
    done.push_back(t);
    live[k] = live.back();
    live.pop_back();
  }
  return done;
}

// distinct_flag_kernel on a grid of at most ``max_threads`` threads:
// phase 1 (every valid row's steps interleaved in a random order; the
// count of keys inserted added), the grid barrier and the count's word,
// phase 2 (rows in another random order), each row's slot held where
// the kernel holds it (its thread's register for the thread's first
// row, scratch at the row for the later ones).
extern "C" int df_host_launch(const Args* a, int64_t max_threads,
                              uint64_t seed) {
  const int64_t n = a->n;
  const int64_t stride =
      df_grid_blocks(n, kThreads, max_threads / kThreads) * kThreads;
  std::vector<Thread> live;
  for (int64_t i = 0; i < n; ++i) {
    if (!a->vvalid[i]) continue;
    Thread t;
    t.row = i;
    t.val = df_norm(a->val, (int)a->vkind, i);
    t.gnull = a->grp != nullptr && a->gvalid[i] == 0;
    t.grp = a->grp == nullptr || t.gnull ? 0
                                         : df_norm(a->grp, (int)a->gkind, i);
    t.ready = df_ready(a->epoch, t.gnull);
    t.first = (int32_t)i;
    t.p = df_probe(t.val, t.grp, t.gnull, a->capacity - 1);
    t.slot = -1;
    live.push_back(t);
  }
  std::vector<int32_t> slot(n, -1), held(std::min(n, stride), -1);
  unsigned long long added = 0;
  for (const Thread& t : run(live, a->table, a->capacity - 1, false,
                             a->error, seed)) {
    slot[t.row] = (int32_t)t.slot;
    added += (unsigned long long)t.p.owned;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (i < stride)
      held[i] = slot[i];
    else
      a->slot_of_row[i] = slot[i];
  }
  *a->keys += added;
  // the grid barrier
  *a->host_keys = ((unsigned long long)a->epoch << 32) | *a->keys;
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::shuffle(order.begin(), order.end(), std::mt19937_64(seed + 1));
  for (int64_t i : order) {
    const int32_t s = i < stride ? held[i] : a->slot_of_row[i];
    a->flags[i] = df_flag(a->table, s, i) ? 1 : 0;
  }
  return 0;
}

// distinct_flag_rehash_kernel: a thread an occupied slot
extern "C" int df_host_rehash(const DfSlot* old, int64_t old_capacity,
                              DfSlot* table, int64_t capacity,
                              int32_t* error, uint64_t seed) {
  std::vector<Thread> live;
  for (int64_t j = 0; j < old_capacity; ++j) {
    const DfSlot& s = old[j];
    if (s.state == kDfEmpty) continue;
    Thread t;
    t.row = j;
    t.val = s.val;
    t.grp = s.grp;
    t.gnull = df_gnull(s.state);
    t.ready = s.state;
    t.first = s.first;
    t.p = df_probe(t.val, t.grp, t.gnull, capacity - 1);
    t.slot = -1;
    live.push_back(t);
  }
  run(live, table, capacity - 1, true, error, seed);
  return 0;
}

extern "C" void df_host_norm(const void* col, int kind, int64_t n,
                             int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = df_norm(col, kind, i);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("distinct_flag_host")
    src = d / "distinct_flag_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "libdistinct_flag_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    p, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
    lib.df_host_launch.argtypes = [p, i64, u64]
    lib.df_host_launch.restype = ctypes.c_int
    lib.df_host_rehash.argtypes = [p, i64, p, i64, p, u64]
    lib.df_host_norm.argtypes = [p, ctypes.c_int, i64, p]
    return lib


#: the count's word in csrc/distinct_flag.cu ``DistinctFlagArgs``
_HOST_KEYS = 13


def _host_launch(lib, seed, threads, late=None):
    """The kernel's launch on a grid of at most ``threads`` threads and its
    rehash, run on the host by the g++ build. With ``late`` (a list), the
    launch stores the count's word elsewhere and appends (that word, the
    table's word) to it: the store lands when the test copies it."""
    import array

    def launch(v):
        if late is not None:
            word = torch.zeros(1, dtype=torch.int64)
            late.append((word, v[_HOST_KEYS]))
            v = list(v)
            v[_HOST_KEYS] = word.data_ptr()
        packed = array.array("q", v)     # alive through the call
        assert lib.df_host_launch(packed.buffer_info()[0], threads,
                                  seed) == 0

    def rehash(old, oc, new, c, err):
        lib.df_host_rehash(old.data_ptr(), oc, new.data_ptr(), c,
                           err.data_ptr(), seed + 2)
    return launch, rehash


def _column(rng, kind, n):
    pools = {
        torch.float64: [np.nan, -np.nan, -0.0, 0.0, 1.5, -2.25, np.inf,
                        -np.inf, 1e-300],
        torch.float32: [np.nan, -0.0, 0.0, 1.5, -2.25, 3e38],
        torch.int8: [-128, -1, 0, 1, 127], torch.int16: [-32768, 0, 7],
        torch.int32: [-(1 << 31), 0, 9, (1 << 31) - 1],
        torch.int64: [-(1 << 63), -1, 0, 1 << 40], torch.bool: [0, 1]}
    pool = np.array(pools[kind])
    return torch.from_numpy(pool[rng.randint(0, len(pool), n)]).to(kind)


@pytest.mark.parametrize("kind", [torch.float64, torch.float32, torch.int8,
                                  torch.int16, torch.int32, torch.int64,
                                  torch.bool])
def test_kernel_normalisation_equals_normalize(host_lib, kind):
    col = _column(np.random.RandomState(3), kind, 500)
    out = torch.empty(500, dtype=torch.int64)
    host_lib.df_host_norm(col.data_ptr(), df._KIND[kind], 500,
                          out.data_ptr())
    assert torch.equal(out, df.normalize(col))


def _stream_batches(rng, n_batches, rows, vkind, gkind, hi):
    out = []
    for _ in range(n_batches):
        n = rows if isinstance(rows, int) else rng.randint(*rows)
        v = torch.from_numpy(rng.randint(0, hi, n)).to(vkind)
        if v.is_floating_point():
            # NaNs, signed zeros and infinities among the values
            special = torch.from_numpy(rng.rand(n) < 0.3)
            v = torch.where(special, _column(rng, vkind, n), v)
        vv = torch.from_numpy(rng.rand(n) > 0.1)
        g = gv = None
        if gkind is not None:
            g = torch.from_numpy(rng.randint(-2, 3, n)).to(gkind)
            gv = torch.from_numpy(rng.rand(n) > 0.15)
        out.append((v, vv, g, gv))
    return out


def _case_batches(case):
    rng = np.random.RandomState(len(case))
    if case == "nan_zero_null_group":
        batches = _stream_batches(rng, 3, 700, torch.float64, torch.int64,
                                  3)
    elif case == "float32_int8":
        batches = _stream_batches(rng, 3, 400, torch.float32, torch.int8, 4)
    elif case == "one_key":
        v = torch.full((900,), 4.5, dtype=torch.float64)
        batches = [(v, torch.ones(900, dtype=torch.bool), None, None)] * 2
    elif case == "growth":
        batches = _stream_batches(rng, 12, (300, 500), torch.int64, None,
                                  1 << 40)
    elif case == "repeats":
        batches = _stream_batches(rng, 5, 800, torch.int32, torch.int16, 60)
    elif case == "warp_repeats":
        # every 32-row piece holds keys repeated within it (its rows race
        # for one slot and its first row), and NULLs
        batches = _stream_batches(rng, 4, 900, torch.int64, torch.int8, 6)
    else:
        batches = [(torch.tensor([2.5]), torch.tensor([True]),
                    torch.tensor([1]), torch.tensor([False]))] * 2
    return batches


def _host_stream(host_lib, batches, seed, threads):
    """The host build's flags against the plain version's over
    ``batches``, the table sized as the exec sizes it: (growths, table,
    new keys a batch by the count, by the plain version)."""
    launch, rehash = _host_launch(host_lib, seed, threads)
    seen = df.SeenKeys()
    table, growths, counted, want_new = None, 0, [], []
    for v, vv, g, gv in batches:
        table, grew = df.sized_table(table, "cpu", v.shape[0], 64, rehash,
                                     hashed=True)
        growths += grew
        before = int(table.keys)
        had = 0 if seen.keys is None else seen.keys.shape[0]
        got = df._flag(table, v, vv, g, gv, launch)
        want = df.distinct_flag_reference(seen, v, vv, g, gv)
        assert torch.equal(got, want)
        counted.append(int(table.keys) - before)
        want_new.append(seen.keys.shape[0] - had if seen.keys is not None
                        else 0)
    assert not table.failed()
    table.count.poll()
    return growths, table, counted, want_new


@pytest.mark.parametrize("case", [
    "nan_zero_null_group", "float32_int8", "one_key", "growth", "repeats",
    "one_row", "warp_repeats"])
def test_kernel_passes_built_by_gxx_equal_the_plain_version(host_lib,
                                                            case):
    batches = _case_batches(case)
    # a grid of one block (a thread's rows past its first through
    # scratch), then one that holds every row in registers
    for seed, threads in ((1, 256), (2, 1 << 20)):
        growths, table, _, _ = _host_stream(host_lib, batches, seed,
                                            threads)
        assert table.count.keys == int(table.keys)
        if case == "growth":
            assert growths >= 2


@pytest.mark.parametrize("case", ["repeats", "growth", "warp_repeats"])
def test_key_count_equals_the_new_keys(host_lib, case):
    """The kernel's count grows by the keys new in each batch, and its
    pinned word hands the host the count after the last launch."""
    _, table, counted, want_new = _host_stream(host_lib,
                                               _case_batches(case), 3, 512)
    assert counted == want_new
    assert table.count.keys == sum(want_new) == int(table.keys)
    assert table.count.rows == table.rows


def _word(epoch, keys):
    return (epoch << 32) | keys


@pytest.mark.parametrize("case", ["unqueued_epoch", "newest", "in_order"])
def test_count_word_names_its_epoch(case):
    """The host takes the word's count with the rows of the epoch that
    wrote it, and only when that epoch was queued; reading drops the
    epochs up to it."""
    count = df.KeyCount(cuda=False)
    for e, rows in ((1, 100), (2, 250), (3, 300)):
        count.queued(e, rows)
    if case == "unqueued_epoch":
        count.host[0] = _word(7, 40)
        count.poll()
        assert (count.keys, count.rows) == (0, 0)
        assert sorted(count.rows_after) == [1, 2, 3]
    elif case == "newest":
        count.host[0] = _word(3, 90)
        count.poll()
        assert (count.keys, count.rows, count.rows_after) == (90, 300, {})
    else:
        for e, keys, rows in ((1, 60, 100), (2, 80, 250)):
            count.host[0] = _word(e, keys)
            count.poll()
            assert (count.keys, count.rows) == (keys, rows)
            assert min(count.rows_after) == e + 1
        count.poll()     # the same word again changes nothing
        assert (count.keys, count.rows) == (80, 250)


@pytest.mark.parametrize("min_slots", [2, 64, 1 << 16])
def test_table_slots_load_the_keys_to_at_most_half(min_slots):
    """For any keys known and rows to come: the keys after the rows fill
    at most 1/LOAD_NUM of the slots, the slots are a power of two at
    least ``min_slots``, and no count known gives the reference's size
    for the rows."""
    rng = np.random.RandomState(min_slots)
    for _ in range(500):
        keys, rows = (int(x) for x in rng.randint(0, 1 << 22, 2))
        slots = df.table_slots(keys, rows, min_slots)
        assert slots & (slots - 1) == 0 and slots >= min_slots
        assert df.LOAD_NUM * (keys + rows) <= slots
        assert slots < 2 * max(min_slots, df.LOAD_NUM * (keys + rows))
        assert df.table_slots(0, rows, min_slots) == max(
            min_slots, df._next_pow2(df.LOAD_NUM * rows))


def _reference_sizes(rows, min_slots):
    """The reference's table after each batch of ``rows``: twice the rows
    so far (spark_rapids_tpu/exec/distinct_flag.py), grown to twice the
    need."""
    cap, ub, out = None, 0, []
    for n in rows:
        ub += n
        need = df._next_pow2(df.LOAD_NUM * ub)
        if cap is None:
            cap = max(min_slots, need)
        elif cap < need:
            cap = 2 * need
        out.append(cap)
    return out


@pytest.mark.parametrize("events", ["completed", "pending", "lagging"])
def test_sizing_from_the_key_count_with_a_fake_event_ring(host_lib,
                                                          events):
    """Before each batch the table has at least LOAD_NUM x (the keys known
    plus the rows since) slots, so the keys after the batch load it to at
    most half, and never more than the reference's row-bound size. The
    kernel's stores to the count's word land at once (completed), two
    launches late (lagging) or never (pending: the count stays unknown
    and the size is the row bound)."""
    rng = np.random.RandomState(21)
    batches = _stream_batches(rng, 14, (200, 600), torch.int64, None, 3000)
    late = [] if events != "completed" else None
    launch, rehash = _host_launch(host_lib, 4, 512, late)
    seen, table = df.SeenKeys(), None
    ref = _reference_sizes([b[0].shape[0] for b in batches], 64)
    for j, (v, vv, g, gv) in enumerate(batches):
        n = v.shape[0]
        if table is not None:
            k, r = table.key_bound(n)
            assert k <= int(table.keys) and r >= n
        else:
            k, r = 0, n
        table, _ = df.sized_table(table, "cpu", n, 64, rehash, hashed=True)
        df._flag(table, v, vv, g, gv, launch)
        df.distinct_flag_reference(seen, v, vv, g, gv)
        keys = seen.keys.shape[0]
        assert table.capacity >= df.LOAD_NUM * (k + r) >= df.LOAD_NUM * keys
        assert table.capacity <= ref[j]
        if events == "lagging" and len(late) > 2:
            word, dest = late.pop(0)
            table.count.host[0] = word[0]
            assert dest == table.count.host.data_ptr()
    assert not table.failed()
    if events == "pending":
        assert table.count.keys == 0 and len(table.count.rows_after) == 14
        assert table.capacity == df._next_pow2(df.LOAD_NUM * table.rows)
    else:
        table.count.poll()
        assert table.count.keys > 0
        if events == "completed":
            assert table.count.keys == seen.keys.shape[0]
            assert table.capacity < ref[-1]


def test_full_table_sets_the_error_word(host_lib):
    launch, _ = _host_launch(host_lib, 5, 256)
    table = df.DistinctTable("cpu", 4, hashed=True)
    v = torch.arange(6, dtype=torch.int64)
    df._flag(table, v, torch.ones(6, dtype=torch.bool), None, None, launch)
    assert table.failed()
    # the count holds the keys inserted, not the row that failed
    assert int(table.keys) == 4


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    table = df.DistinctTable("cpu", 1 << 10)
    assert not table.hashed
    v = torch.tensor([1.0, -0.0, 0.0, float("nan"), float("nan")])
    ok = torch.tensor([True, True, True, True, False])
    saved = df.distinct_flag.launches
    assert df.distinct_flag(table, v, ok).tolist() == [True, True, False,
                                                       True, False]
    assert df.distinct_flag(table, v, ok).tolist() == [False] * 5
    assert df.distinct_flag.launches == saved
    with pytest.raises(TypeError):
        df.distinct_flag(table, v.to(torch.float16), ok)
