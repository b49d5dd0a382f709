"""The equi-join's match step and its neighbours against the reference,
on the CPU.

* ``join_match``'s plain version (exec/join_match.py) against the
  reference's ``_build_count_kernel``/``_gather_index_kernel`` pair sets;
* the kernels' per-row logic (``csrc/join_match_row.cuh``) built by g++
  and run through the kernels' loops on the host, keys and rows taken in
  shuffled orders (the card's threads race in any order), against the
  plain version exactly;
* murmur3 partition ids equal to the reference's ``hash_partition_ids``,
  and the split keeping each partition's rows in input order;
* the TPC-DS numpy copies in ``chip_smoke.py`` equal to
  ``benchmarks/tpcds.py``, and ``benchmarks/tpcds.py:q3`` run unmodified
  on both packages, multi-batch, in the broadcast and the shuffled plan:
  keys and row order exactly, ``sum_agg`` to a relative 1e-12 (the rows
  reach each sum in another order: the port's join emits them in stream
  order, the reference's group by group).
"""
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
from spark_rapids_tpu_torch.exec.joins import encode_keys
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


# ---------------------------------------------------------------------------
# the kernels' per-row logic, built with g++ and run on the host
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <random>
#include <vector>
#include "join_match_row.cuh"

struct HostCas {
  int32_t operator()(int32_t* slot, int32_t u) const {
    int32_t old = *slot;
    if (old == -1) *slot = u;
    return old;
  }
};

static std::vector<int64_t> shuffled(int64_t n, uint64_t seed) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), std::mt19937_64(seed));
  return order;
}

// join_match_build and join_match_probe's loops, rows and keys taken in
// a shuffled order (the card's threads race in any order)
extern "C" int jm_host_probe(const int64_t* ukeys, int64_t U, int W,
                             int32_t* table, int64_t cap,
                             const int64_t* skeys, const uint8_t* snull,
                             int64_t n, const int64_t* ucount, int32_t* uid,
                             int64_t* count, uint8_t* matched,
                             uint64_t seed) {
  for (int64_t u : shuffled(U, seed))
    jm_insert(table, cap - 1, ukeys + u * W, W, (int32_t)u, HostCas());
  for (int64_t i : shuffled(n, seed + 1)) {
    int32_t u;
    count[i] = jm_probe_row(skeys + i * W, snull[i] != 0, W, table,
                            cap - 1, ukeys, ucount, &u);
    uid[i] = u;
    if (matched != nullptr && u >= 0) matched[u] = 1;
  }
  return 0;
}

extern "C" int jm_host_emit(const int64_t* offsets, const int64_t* count,
                            const int32_t* uid, const int64_t* ustart,
                            const int64_t* sorted_rows, int64_t n, int outer,
                            int64_t* out_s, int64_t* out_b, uint64_t seed) {
  for (int64_t i : shuffled(n, seed))
    jm_emit_row(i, offsets[i], count[i], uid[i], ustart, sorted_rows,
                outer != 0, out_s, out_b);
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
    lib.jm_host_probe.argtypes = [p, i64, i32, p, i64, p, p, i64, p, p, p,
                                  p, ctypes.c_uint64]
    lib.jm_host_emit.argtypes = [p, p, p, p, p, i64, i32, p, p,
                                 ctypes.c_uint64]
    return lib


def _host_join(lib, sw, sn, table: jm.BuildTable, how: str, seed: int):
    """join_match with the kernels' loops run by the host library (the
    wrapper's flow of ``_launch``, CPU tensors)."""
    n, W = sw.shape
    U = int(table.ukeys.shape[0])
    cap = jm._capacity(U)
    tab = torch.full((cap,), -1, dtype=torch.int32)
    uid = torch.empty(n, dtype=torch.int32)
    count = torch.empty(n, dtype=torch.int64)
    matched = torch.zeros(U, dtype=torch.uint8) \
        if how in ("right", "full") else None
    sw, sn = sw.contiguous(), sn.contiguous()
    lib.jm_host_probe(table.ukeys.data_ptr(), U, W, tab.data_ptr(), cap,
                      sw.data_ptr(), sn.data_ptr(), n,
                      table.ucount.data_ptr(), uid.data_ptr(),
                      count.data_ptr(),
                      None if matched is None else matched.data_ptr(), seed)

    def emit(offsets, outer, total):
        s_map = torch.full((total,), -7, dtype=torch.int64)
        b_map = torch.full((total,), -7, dtype=torch.int64)
        lib.jm_host_emit(offsets.data_ptr(), count.data_ptr(),
                         uid.data_ptr(), table.ustart.data_ptr(),
                         table.sorted_rows.data_ptr(), n, int(outer),
                         s_map.data_ptr(), b_map.data_ptr(), seed)
        return s_map, b_map
    return jm._finish(how, count, uid, matched, table, emit)


def _words_case(seed: int, n_s: int, n_b: int, W: int, hi: int):
    rng = np.random.RandomState(seed)
    sw = torch.from_numpy(rng.randint(0, hi, (n_s, W)).astype(np.int64))
    bw = torch.from_numpy(rng.randint(0, hi, (n_b, W)).astype(np.int64))
    sn = torch.from_numpy(rng.rand(n_s) < 0.05)
    bn = torch.from_numpy(rng.rand(n_b) < 0.05)
    return sw, sn, bw, bn


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
        got = _host_join(host_lib, sw, sn, table, how, order_seed)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)


def test_table_capacity_keeps_an_empty_slot():
    for u in (0, 1, 2, 3, 100, 1000, 1 << 16):
        c = jm._capacity(u)
        assert c >= 2 * u and c & (c - 1) == 0


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
