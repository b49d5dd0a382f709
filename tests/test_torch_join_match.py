"""The equi-join's match step and its neighbours against the reference,
on the CPU.

* ``join_match``'s plain version (exec/join_match.py) against the
  reference's ``_build_count_kernel``/``_gather_index_kernel`` pair sets;
* the kernel's per-row and per-tile logic (``csrc/join_match_row.cuh``)
  built by g++ and run through the kernel's tile loop on the host (tiles,
  rows and threads in shuffled orders, the look-back replaced by the
  tiles' totals summed in order), through the wrapper's own flow,
  against the plain version exactly; the route by the largest key count;
* the one-side key encoding of a broadcast join's prepared table equal
  to its half of the two-side encoding;
* murmur3 partition ids equal to the reference's ``hash_partition_ids``,
  and the split keeping each partition's rows in input order;
* the TPC-DS numpy copies in ``chip_smoke.py`` equal to
  ``benchmarks/tpcds.py``, and ``benchmarks/tpcds.py:q3`` run unmodified
  on both packages, multi-batch, in the broadcast and the shuffled plan:
  keys and row order exactly, ``sum_agg`` to a relative 1e-12 (the rows
  reach each sum in another order: the port's join emits them in stream
  order, the reference's group by group).
"""
import array
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
from spark_rapids_tpu.exec import joins as ref_joins
from spark_rapids_tpu.exprs.base import ColumnRef as RColumnRef
from spark_rapids_tpu.shuffle.partitioning import \
    hash_partition_ids as ref_hash_partition_ids
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import batch_from_reference
from spark_rapids_tpu_torch.exec import join_match as jm
from spark_rapids_tpu_torch.exec.joins import encode_keys, encode_one_side
from spark_rapids_tpu_torch.exprs.base import ColumnRef
from spark_rapids_tpu_torch.exprs.hash_fns import (murmur3_int,
                                                   murmur3_long)
from spark_rapids_tpu_torch.shuffle.partitioning import (
    hash_partition_ids, partition_batch)
from spark_rapids_tpu_torch.types import Schema, StructField, from_arrow

from test_torch_slice import prebuild_reference_native

sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "benchmarks"))
import tpcds  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc"
OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
HOWS = ["inner", "left", "right", "full", "leftsemi", "leftanti"]


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _ref(conf=None):
    return TpuSession({**OFF, **(conf or {})})


def _port(conf=None):
    return TorchSession({**OFF, **(conf or {})}, device="cpu")


# ---------------------------------------------------------------------------
# join_match's plain version against the reference's match kernels
# ---------------------------------------------------------------------------

def _key_table(rng, n, key_hi, null_frac, float_keys=False):
    k = rng.randint(0, key_hi, n)
    if float_keys:
        vals = np.array([np.nan, 0.0, -0.0, 1.5, -2.5, np.inf])[k % 6]
        arr = pa.array(vals, mask=rng.rand(n) < null_frac)
    else:
        arr = pa.array(k.astype(np.int64), mask=rng.rand(n) < null_frac)
    return pa.table({"k": arr, "v": pa.array(np.arange(n))})


def _ref_pairs(lt, rt, how):
    """(left row, right row) pairs of the reference's kernels."""
    lb, rb = RefBatch.from_arrow(lt), RefBatch.from_arrow(rt)
    kern = ref_joins._build_count_kernel([RColumnRef("k")],
                                         [RColumnRef("k")], lb.schema,
                                         rb.schema, how)
    lcols = [(c.data, c.validity) for c in lb.columns]
    rcols = [(c.data, c.validity) for c in rb.columns]
    (s_orig, cnt_l, cnt_r, start_l, start_r, _p, offsets, total,
     _g) = kern(lcols, rcols, jnp.int32(lb.num_rows),
                jnp.int32(rb.num_rows), lb.padded_len, rb.padded_len)
    n = int(total)
    cfg = jnp.array([int(how in ("right", "full")),
                     int(how in ("left", "full")),
                     int(how in ("leftsemi", "leftanti"))], jnp.int32)
    l_row, r_row = ref_joins._gather_index_kernel(
        s_orig, cnt_l, cnt_r, start_l, start_r, offsets, cfg,
        max(n, 1))
    l_row, r_row = np.asarray(l_row)[:n], np.asarray(r_row)[:n]
    if how in ("leftsemi", "leftanti"):
        return sorted(l_row.tolist())
    return sorted(zip(l_row.tolist(), r_row.tolist()))


def _port_batch(t: pa.Table):
    ref = RefBatch.from_arrow(t)
    cols = [{"data": np.asarray(c.data), "validity": np.asarray(c.validity)}
            for c in ref.columns]
    schema = Schema([StructField(f.name, from_arrow(f.type), True)
                     for f in t.schema])
    return batch_from_reference(cols, schema, "cpu", ref.num_rows)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("seed,float_keys", [(1, False), (2, False),
                                             (3, True)])
def test_join_match_plain_equals_reference_pairs(how, seed, float_keys):
    rng = np.random.RandomState(seed)
    lt = _key_table(rng, 300, 25, 0.1, float_keys)
    rt = _key_table(rng, 120, 25, 0.1, float_keys)
    sw, sn, bw, bn = encode_keys(_port_batch(lt), [ColumnRef("k")],
                                 _port_batch(rt), [ColumnRef("k")])
    maps = jm.join_match(sw, sn, jm.build_table(bw, bn), how)
    if how in ("leftsemi", "leftanti"):
        got = sorted(maps.stream.tolist())
    else:
        got = sorted(zip(maps.stream.tolist(), maps.build.tolist()))
    assert got == _ref_pairs(lt, rt, how)


def _encode_table(seed: int, n: int) -> pa.Table:
    rng = np.random.RandomState(seed)
    floats = np.array([np.nan, -np.nan, 0.0, -0.0, 1.5, -2.5, np.inf])
    return pa.table({
        "i32": pa.array(rng.randint(-2**31, 2**31 - 1, n).astype(np.int32),
                        mask=rng.rand(n) < 0.1),
        "i64": pa.array(np.where(rng.rand(n) < 0.5, rng.randint(
            -2**31, 2**31 - 1, n), rng.randint(-2**62, 2**62, n)),
            mask=rng.rand(n) < 0.1),
        "f32": pa.array(floats[rng.randint(0, 7, n)].astype(np.float32),
                        mask=rng.rand(n) < 0.1),
        "f64": pa.array(np.where(rng.rand(n) < 0.5, floats[rng.randint(
            0, 7, n)], rng.uniform(-1e9, 1e9, n)), mask=rng.rand(n) < 0.1),
        "d": pa.array(rng.randint(-5000, 20000, n).astype(np.int32),
                      mask=rng.rand(n) < 0.1).cast(pa.date32()),
    })


@pytest.mark.parametrize("lkeys,rkeys", [
    (["i32"], ["i64"]), (["i64"], ["i32"]), (["i32"], ["i32"]),
    (["f32"], ["f64"]), (["f64"], ["f64"]), (["d"], ["d"]),
    (["i32", "f64", "d"], ["i64", "f32", "d"])])
def test_one_side_encoding_equals_its_half_of_encode_keys(lkeys, rkeys):
    """A broadcast join encodes its build side once for the table and each
    stream batch alone (``encode_one_side``): each side's words and null
    flags equal its half of ``encode_keys`` over both sides (int32/int64
    mixes, floats with NaN of two bit patterns and +-0.0, dates, nulls)."""
    lb, rb = (_port_batch(_encode_table(1, 300)),
              _port_batch(_encode_table(2, 170)))
    lk, rk = [ColumnRef(k) for k in lkeys], [ColumnRef(k) for k in rkeys]
    lw, ln, rw, rn = encode_keys(lb, lk, rb, rk)
    for (w, nl), (ww, wn) in ((encode_one_side(lb, lk, rb.schema, rk),
                               (lw, ln)),
                              (encode_one_side(rb, rk, lb.schema, lk),
                               (rw, rn))):
        assert w.dtype == torch.int64 and torch.equal(w, ww)
        assert torch.equal(nl, wn)
    assert bool(ln.any()) and bool(rn.any())


def test_one_side_encoding_refuses_string_keys():
    t = pa.table({"s": pa.array(["a", "b"])})
    b = _port_batch(t)
    with pytest.raises(TypeError, match="string key"):
        encode_one_side(b, [ColumnRef("s")], b.schema, [ColumnRef("s")])


# ---------------------------------------------------------------------------
# the kernel's tile loop, built with g++ and run on the host
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <random>
#include <vector>
#include "join_match_row.cuh"

// csrc/join_match.cu's launch arguments, 8 bytes a field
struct Args {
  const int64_t* skeys; const uint8_t* snull; int64_t n, W, kind, phase;
  const int64_t* table; int64_t capacity; const int64_t* sorted_rows;
  uint8_t* matched; int64_t *out_s, *out_b; uint8_t* flags;
  int64_t out_cap; int64_t* total; void* scratch;
  int64_t scratch_tiles, epoch, shared;
};

struct HostCas {
  int64_t operator()(int64_t* word, int64_t meta) const {
    int64_t old = *word;
    if (old == 0) *word = meta;
    return old;
  }
};

static std::vector<int64_t> shuffled(int64_t n, uint64_t seed) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), std::mt19937_64(seed));
  return order;
}

// join_match_build_kernel's loop, keys in a shuffled order
extern "C" int jm_host_build(const int64_t* ukeys, const int64_t* ustart,
                             const int64_t* ucount, int64_t U, int W,
                             int64_t* table, int64_t cap, uint64_t seed) {
  for (int64_t u : shuffled(U, seed))
    jm_insert(table, cap - 1, ukeys + u * W, W,
              jm_meta(ustart[u], ucount[u]), HostCas());
  return 0;
}

// the rows' probes as the kernel makes them: the key in registers for
// widths of 1, 2 and 4 words (jm_find<W>), read through its pointer for
// any other width; each row's meta word
template <int K>
static int64_t find_k(const Args* a, int64_t i) {
  int64_t key[K];
  for (int w = 0; w < K; ++w) key[w] = a->skeys[i * K + w];
  return jm_find<K>(a->table, a->capacity - 1, K, key);
}

static void probe_rows(const Args* a, const int64_t* rows, int64_t m,
                       int64_t* meta) {
  for (int64_t q = 0; q < m; ++q) {
    const int64_t i = rows[q];
    if (a->snull[i] != 0) {
      meta[q] = 0;
      continue;
    }
    switch (a->W) {
      case 1: meta[q] = find_k<1>(a, i); break;
      case 2: meta[q] = find_k<2>(a, i); break;
      case 4: meta[q] = find_k<4>(a, i); break;
      default:
        meta[q] = jm_find(a->table, a->capacity - 1, (int)a->W,
                          a->skeys + i * a->W);
    }
  }
}

// join_match_tile_kernel's loop over one launch: tiles of tile_rows rows
// in a shuffled order, each tile's rows probed in a shuffled order (the
// card's threads race), their output counts scanned within the tile; the
// look-back replaced by the tiles' totals summed in tile order; then
// each tile's outputs written by ``threads`` threads striding over its
// range, tiles and threads in shuffled orders.
extern "C" int jm_host_launch(const Args* a, int tile_rows, int threads,
                              uint64_t seed) {
  const int64_t n = a->n;
  const int kind = (int)a->kind, phase = (int)a->phase;
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  std::vector<int64_t> incl(tiles * tile_rows, 0), agg(tiles, 0);
  std::vector<int64_t> first(tiles * tile_rows, -1);
  for (int64_t t : shuffled(tiles, seed)) {
    const int64_t base = t * tile_rows;
    const int rows = (int)std::min<int64_t>(tile_rows, n - base);
    std::vector<int64_t> order = shuffled(rows, seed + 7 * t + 1);
    for (int64_t& r : order) r += base;
    // every slot of the tile, those past the stream's end as no match
    std::vector<int64_t> meta(tile_rows, 0);
    probe_rows(a, order.data(), rows, meta.data());
    for (int q = 0; q < tile_rows; ++q) {
      const int64_t r = q < rows ? order[q] - base : q;
      if (kind == JM_EXIST) {
        if (q < rows) a->flags[base + r] = meta[q] != 0;
        continue;
      }
      if (q < rows && a->matched != nullptr && meta[q] != 0 && phase == 1)
        a->matched[jm_meta_start(meta[q])] = 1;
      incl[base + r] = jm_row_out(kind, meta[q], r < rows);
      first[base + r] = jm_meta_start(meta[q]);
    }
    for (int r = 1; r < tile_rows; ++r)
      incl[base + r] += incl[base + r - 1];
    agg[t] = incl[base + tile_rows - 1];
  }
  if (kind == JM_EXIST) return 0;
  std::vector<int64_t> excl(tiles, 0);
  int64_t sum = 0;
  for (int64_t t = 0; t < tiles; ++t) {
    excl[t] = sum;
    sum += agg[t];
  }
  *a->total = sum;
  if (phase != 1) return 0;
  for (int64_t t : shuffled(tiles, seed + 2)) {
    const int64_t base = t * tile_rows;
    const int rows = (int)std::min<int64_t>(tile_rows, n - base);
    const int64_t* ti = incl.data() + base;
    for (int64_t th : shuffled(threads, seed + 7 * t + 3)) {
      int r = 0;
      for (int64_t o = th; o < agg[t]; o += threads) {
        r = jm_output_row(ti, r, rows, o);
        const int64_t g = excl[t] + o;
        if (g >= a->out_cap) continue;
        a->out_s[g] = base + r;
        if (a->out_b != nullptr) {
          const int64_t p = jm_build_pos(o, ti, r, first[base + r]);
          a->out_b[g] = p < 0 ? -1 : a->sorted_rows[p];
        }
      }
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("join_match_host")
    src = d / "join_match_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "libjoin_match_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.jm_host_build.argtypes = [p, p, p, i64, i32, p, i64,
                                  ctypes.c_uint64]
    lib.jm_host_launch.argtypes = [p, i32, i32, ctypes.c_uint64]
    return lib


def _host_join(lib, sw, sn, table: jm.BuildTable, how: str, seed: int,
               tile_rows: int = jm.TILE_ROWS, threads: int = 256,
               launches: list = None):
    """join_match with the kernel's loop run by the host library: the
    wrapper's own flow (``_match``: the route, the buffers, the host read
    of the total, the unmatched rows) with CPU tensors."""
    U, W = table.ukeys.shape
    cap = jm._capacity(U)
    slots = torch.zeros(cap * (W + 1), dtype=torch.int64)
    lib.jm_host_build(table.ukeys.data_ptr(), table.ustart.data_ptr(),
                      table.ucount.data_ptr(), U, W, slots.data_ptr(), cap,
                      seed)

    def launch(v):
        packed = array.array("q", v)
        if launches is not None:
            launches.append(v[5])
        assert lib.jm_host_launch(packed.buffer_info()[0], tile_rows,
                                  threads, seed) == 0
    return jm._match(sw.contiguous(), sn.contiguous(),
                     table._replace(table=slots), how, launch)


def _words_case(seed: int, n_s: int, n_b: int, W: int, hi: int):
    rng = np.random.RandomState(seed)
    sw = torch.from_numpy(rng.randint(0, hi, (n_s, W)).astype(np.int64))
    bw = torch.from_numpy(rng.randint(0, hi, (n_b, W)).astype(np.int64))
    sn = torch.from_numpy(rng.rand(n_s) < 0.05)
    bn = torch.from_numpy(rng.rand(n_b) < 0.05)
    return sw, sn, bw, bn


def _maps_equal(got, want) -> None:
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("how", jm.JOIN_TYPES)
@pytest.mark.parametrize("seed,n_s,n_b,W,hi", [
    (1, 2000, 300, 1, 120), (2, 1500, 900, 2, 12), (3, 800, 2000, 4, 3),
    (4, 0, 50, 1, 10), (5, 100, 0, 1, 10)])
def test_kernel_loops_built_by_gxx_equal_the_plain_version(host_lib, how,
                                                           seed, n_s, n_b,
                                                           W, hi):
    sw, sn, bw, bn = _words_case(seed, n_s, n_b, W, hi)
    table = jm.build_table(bw, bn)
    want = jm.join_match_reference(sw, sn, table, how)
    for order_seed in (seed, seed + 100):
        _maps_equal(_host_join(host_lib, sw, sn, table, how, order_seed),
                    want)


def _skew_case():
    """One key with 3,000 build rows beside 40 keys of 1-3 rows; a third
    of the stream rows take the skewed key."""
    rng = np.random.RandomState(11)
    keys = np.concatenate([np.full(3000, 7), np.repeat(
        np.arange(100, 140), rng.randint(1, 4, 40))])
    bw = torch.from_numpy(rng.permutation(keys).astype(np.int64)[:, None])
    pick = rng.rand(600)
    s = np.where(pick < 0.33, 7, np.where(pick < 0.8, rng.randint(
        100, 140, 600), rng.randint(1000, 2000, 600)))
    sw = torch.from_numpy(s.astype(np.int64)[:, None])
    return sw, torch.from_numpy(rng.rand(600) < 0.05), bw, \
        torch.zeros(bw.shape[0], dtype=torch.bool)


def _all_miss_tile_case():
    """Three tiles of 100 rows whose middle tile's keys are all absent
    from the build side."""
    rng = np.random.RandomState(12)
    s = rng.randint(0, 30, 300)
    s[100:200] = rng.randint(500, 600, 100)
    b = np.repeat(np.arange(30), rng.randint(1, 4, 30))
    return (torch.from_numpy(s.astype(np.int64)[:, None]),
            torch.zeros(300, dtype=torch.bool),
            torch.from_numpy(rng.permutation(b).astype(np.int64)[:, None]),
            torch.zeros(len(b), dtype=torch.bool))


def _dup_case(dup: int, W: int = 2):
    """Every build key exactly ``dup`` times: the largest key count that
    picks the route."""
    rng = np.random.RandomState(13 + dup)
    keys = rng.permutation(np.repeat(np.arange(80), dup))
    bw = torch.from_numpy(np.stack([keys, keys * 3], 1)[:, :W].astype(
        np.int64))
    s = rng.randint(0, 120, 700)
    sw = torch.from_numpy(np.stack([s, s * 3], 1)[:, :W].astype(np.int64))
    return sw, torch.from_numpy(rng.rand(700) < 0.05), bw, \
        torch.from_numpy(rng.rand(len(keys)) < 0.05)


@pytest.mark.parametrize("how", jm.JOIN_TYPES)
@pytest.mark.parametrize("case,tile_rows,threads", [
    ("skew", 64, 32), ("skew", jm.TILE_ROWS, 256), ("all_miss", 100, 32),
    ("dup1", 128, 64), ("dup2", 128, 64), ("dup3", 128, 64),
    ("ragged", 7, 3), ("ragged", 37, 8), ("ragged", 1000, 256)])
def test_tile_loop_built_by_gxx_on_skew_misses_and_both_routes(
        host_lib, how, case, tile_rows, threads):
    """The tile loop against the plain version on a key with thousands of
    build rows, a tile whose rows all miss, largest key counts of 1 and 2
    (one launch) and 3 (count, then emit), and tiles that do not divide
    the stream rows (1,000 rows in tiles of 7, 37 and 1,000)."""
    if case == "skew":
        sw, sn, bw, bn = _skew_case()
    elif case == "all_miss":
        sw, sn, bw, bn = _all_miss_tile_case()
    elif case.startswith("dup"):
        sw, sn, bw, bn = _dup_case(int(case[3:]))
    else:
        sw, sn, bw, bn = _words_case(21, 1000, 400, 3, 150)
    table = jm.build_table(bw, bn)
    want = jm.join_match_reference(sw, sn, table, how)
    route = jm.launch_route(table, sw.shape[0], how)
    for order_seed in (5, 6):
        phases = []
        _maps_equal(_host_join(host_lib, sw, sn, table, how, order_seed,
                               tile_rows, threads, phases), want)
        assert phases == {"flags": [1], "single": [1],
                          "count_emit": [0, 1]}[route]
    if case.startswith("dup") and how in ("inner", "left", "right", "full"):
        assert table.max_ucount == int(case[3:])
        assert route == ("single" if table.max_ucount <= 2
                         else "count_emit")
    if case == "skew" and how == "inner":
        assert want.stream.shape[0] > 100_000


def test_launch_route_by_largest_key_count():
    """One launch where n * max(largest count, 1) <= 2n (semi and anti:
    always; existence: a flag a row), else count then emit."""
    for dup, route in ((1, "single"), (2, "single"), (3, "count_emit")):
        _, _, bw, bn = _dup_case(dup)
        t = jm.build_table(bw, bn)
        for how in ("inner", "left", "right", "full"):
            assert jm.launch_route(t, 700, how) == route
        assert jm.launch_route(t, 700, "leftsemi") == "single"
        assert jm.launch_route(t, 700, "leftanti") == "single"
        assert jm.launch_route(t, 700, "existence") == "flags"
    empty = jm.build_table(torch.zeros((0, 1), dtype=torch.int64),
                           torch.zeros(0, dtype=torch.bool))
    assert empty.max_ucount == 0
    assert jm.launch_route(empty, 5, "left") == "single"


def test_table_in_shared_by_budget():
    """The staged table's bytes: W + 1 words a slot, at least 4 slots a
    key (a power of two); keys of 1, 2 or 4 words only."""
    def table(U, W):
        w = torch.arange(U, dtype=torch.int64)[:, None].repeat(1, W)
        return jm.build_table(w, torch.zeros(U, dtype=torch.bool))
    assert table(150, 1).shared        # 1,024 slots, 16 KiB
    assert table(512, 1).shared        # 2,048 slots, 32 KiB
    assert not table(513, 1).shared    # 4,096 slots, 64 KiB
    assert not table(100_000, 1).shared
    assert table(256, 4).shared        # 1,024 slots, 40 KiB
    assert not table(257, 4).shared    # 2,048 slots, 80 KiB
    assert not table(100, 3).shared    # the generic width


def test_table_capacity_keeps_an_empty_slot():
    for u in (0, 1, 2, 3, 100, 1000, 1 << 16):
        c = jm._capacity(u)
        assert c >= 4 * u and c >= 2 and c & (c - 1) == 0


# ---------------------------------------------------------------------------
# murmur3 partition ids
# ---------------------------------------------------------------------------

def _hash_table(seed: int) -> pa.Table:
    rng = np.random.RandomState(seed)
    n = 500
    return pa.table({
        "i": pa.array(rng.randint(-2**31, 2**31 - 1, n).astype(np.int32),
                      mask=rng.rand(n) < 0.1),
        "l": pa.array(rng.randint(-2**62, 2**62, n),
                      mask=rng.rand(n) < 0.1),
        "f": pa.array(np.array([0.0, -0.0, np.nan, 1.5, -3.25, np.inf],
                               np.float32)[rng.randint(0, 6, n)]),
        "d": pa.array(rng.randint(-5000, 20000, n).astype(np.int32)
                      ).cast(pa.date32()),
        "b": pa.array(rng.rand(n) < 0.5),
    })


@pytest.mark.parametrize("keys,parts,seed", [
    (["i"], 16, 42), (["l"], 7, 42), (["f"], 5, 42), (["d", "i"], 64, 42),
    (["b", "l", "i"], 3, 1610612741), (["l", "f"], 11, 1879048201)])
def test_partition_ids_equal_reference(keys, parts, seed):
    t = _hash_table(len(keys) + parts)
    want = np.asarray(ref_hash_partition_ids(
        RefBatch.from_arrow(t), [RColumnRef(k) for k in keys], parts,
        seed=seed))
    got = hash_partition_ids(_port_batch(t), [ColumnRef(k) for k in keys],
                             parts, seed)
    # padding rows (the reference pads to a bucket) go to partition
    # ``parts`` in both
    np.testing.assert_array_equal(got.numpy(), want)


def test_murmur3_host_forms_known_values():
    """Spark's Murmur3Hash of a single int / long column, seed 42
    (values from Spark: hash(1) = -559580957, hash(1L) = -1712319331)."""
    assert murmur3_int(1, 42) == -559580957
    assert murmur3_long(1, 42) == -1712319331


def test_partition_batch_keeps_rows_in_order_within_a_partition():
    t = _hash_table(3)
    b = _port_batch(t)
    pb = partition_batch(b, [ColumnRef("i")], 4, 42)
    pid = hash_partition_ids(b, [ColumnRef("i")], 4, 42).numpy()[
        :t.num_rows]
    rows = t.column("l").to_pylist()
    for p in range(4):
        part = pb.partition_device(p)
        want = np.flatnonzero(pid == p)
        assert part.num_rows == len(want)
        vals, valid = part.columns[1].to_numpy(part.num_rows)
        assert [int(v) if ok else None for v, ok in zip(vals, valid)] == \
            [rows[i] for i in want]


# ---------------------------------------------------------------------------
# TPC-DS q3
# ---------------------------------------------------------------------------

def test_tpcds_numpy_copies_equal_the_originals():
    ss, dd, it = (chip_smoke.gen_store_sales(5000), chip_smoke.gen_date_dim(),
                  chip_smoke.gen_item())
    for got, want in ((ss, tpcds.gen_store_sales(5000)),
                      (dd, tpcds.gen_date_dim()), (it, tpcds.gen_item())):
        assert list(got) == want.column_names
        for k in got:
            np.testing.assert_array_equal(
                np.asarray(got[k]),
                want.column(k).to_numpy(zero_copy_only=False).astype(
                    np.asarray(got[k]).dtype))


def _q3_rows_equal(got, want, rel):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["d_year"], g["i_brand_id"], g["i_brand"]) == \
            (w["d_year"], w["i_brand_id"], w["i_brand"])
        assert math.isclose(g["sum_agg"], w["sum_agg"], rel_tol=rel)


@pytest.mark.parametrize("plan", ["broadcast", "shuffled"])
def test_tpcds_q3_unmodified_equals_reference(plan):
    """benchmarks/tpcds.py's q3 on both packages, in 7,000-row batches:
    keys and row order exactly, sum_agg to a relative 1e-12 (the rows
    reach each sum in another order)."""
    ss, dd, it = (tpcds.gen_store_sales(40000), tpcds.gen_date_dim(),
                  tpcds.gen_item())
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 7000}
    if plan == "shuffled":
        conf.update({"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
                     "spark.rapids.tpu.sql.join.subPartitionSizeBytes":
                     64 * 1024})
    port = _port(conf)
    got = tpcds.q3(port.create_dataframe(ss), port.create_dataframe(dd),
                   port.create_dataframe(it), PF).collect()
    ref = _ref(conf)
    want = tpcds.q3(ref.create_dataframe(ss), ref.create_dataframe(dd),
                    ref.create_dataframe(it), RF).collect()
    _q3_rows_equal(got, want, 1e-12)
    tree = port.last_plan.tree_string()
    assert ("BroadcastHashJoin" in tree) == (plan == "broadcast"), tree
    if plan == "shuffled":
        join = port.last_plan
        while type(join).__name__ != "TpuHashJoinExec":
            join = join.children[0]
        assert join.children[0].last_subpartitions >= 2 or \
            join.last_subpartitions >= 2
    want_np = chip_smoke.q3_numpy(*(
        {k: t.column(k).to_numpy(zero_copy_only=False) for k in
         t.column_names} for t in (ss, dd, it)))
    _q3_rows_equal(got, want_np, 1e-12)
