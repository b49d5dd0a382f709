"""The port's keyed groupby and sort against the reference's.

Same inputs, made with numpy from a seed, go through the JAX package and
the port:

* the total-order key operands (exec/encoding.py) over int, float (NaN,
  -0.0, +-inf), bool and date columns with nulls, both directions and
  both null placements: the sort permutations are equal, and so are the
  operands themselves except float keys, which the port encodes as
  order-preserving integers (its module doc says why). One exception:
  descending over floats, the reference's device sort on the CPU puts
  NaN last, against Spark's order (NaN is greatest); there the port is
  held to the reference's own host order key, ``_np_total_order_key``
  (ROADMAP.md Queue C);
* ``segmented_groupby`` over random keys with nulls and NaNs, exactly:
  the port sums floats by the reference's segmented scan over the same
  sorted rows, so the additions happen in the same order;
* ``dense_groupby_reference`` against the reference's ``_seg_sum`` over
  the same group ids: counts exactly, float sums to a relative 1e-12
  (torch's and XLA's one-hot reductions add in different orders);
* the keyed aggregate end to end against ``TpuSession`` (optimizer off):
  keys and counts exactly, float columns to a relative 1e-12 (the dense
  path adds in another order than the reference's, and across batches
  the two packages' partials reach the merge in different layouts);
* the kernel's arithmetic (csrc/dense_groupby_row.cuh), built by g++,
  driven through the kernel's block loop and its block-order combine on
  the host, against the plain version: counts and integer sums exactly,
  float sums to a relative 1e-12 (the kernel's fixed order is not the
  one-hot's).
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.columnar.segmented import seg_sum as ref_seg_sum
from spark_rapids_tpu.exec import encoding as ref_enc
from spark_rapids_tpu.exec.groupby_core import \
    segmented_groupby as ref_segmented_groupby
from spark_rapids_tpu.exec.sort import _np_total_order_key
from spark_rapids_tpu.exprs import aggregates as RA
from spark_rapids_tpu.exprs.base import ColumnRef as RColumnRef
from spark_rapids_tpu.exprs.base import DVal as RDVal
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exec import encoding as enc
from spark_rapids_tpu_torch.exec.dense_groupby import (
    dense_groupby, dense_groupby_reference)
from spark_rapids_tpu_torch.exec.groupby_core import segmented_groupby
from spark_rapids_tpu_torch.exprs import aggregates as PA
from spark_rapids_tpu_torch.exprs.base import ColumnRef, DVal

from test_torch_slice import prebuild_reference_native

CSRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc"
REL = 1e-12
OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _rel_ok(got, want, rel=REL) -> bool:
    return abs(got - want) <= rel * max(abs(want), 1e-300)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _column(kind: str, rng, n: int = 400):
    """(numpy values, validity, port dtype, reference dtype)."""
    valid = rng.rand(n) > 0.15
    if kind == "int":
        v = rng.randint(-5, 6, n).astype(np.int32)
        v[:3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0]
        return v, valid, PT.INT32, RT.INT32
    if kind == "long":
        v = rng.randint(-(1 << 40), 1 << 40, n).astype(np.int64)
        v[::7] = v[1]            # ties
        return v, valid, PT.INT64, RT.INT64
    if kind == "double":
        # no subnormals: XLA on the CPU flushes them to zero, so the
        # reference folds -5e-324 into 0.0 there (ROADMAP.md Queue C);
        # test_float_key_is_spark_total_order holds the port's order
        pool = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5,
                         -1.5, 2.25, -1e300, 1e-300, -2.2250738585072014e-308])
        return pool[rng.randint(0, len(pool), n)], valid, PT.FLOAT64, \
            RT.FLOAT64
    if kind == "float":
        pool = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5,
                         3.0e38], np.float32)
        return pool[rng.randint(0, len(pool), n)], valid, PT.FLOAT32, \
            RT.FLOAT32
    if kind == "bool":
        return rng.rand(n) > 0.5, valid, PT.BOOL, RT.BOOL
    assert kind == "date"
    v = rng.randint(8000, 8010, n).astype(np.int32)
    return v, valid, PT.DATE, RT.DATE


def _zero_nulls(v, valid):
    out = v.copy()
    out[~valid] = 0
    return out


def _spark_order(cols, ascending: bool, nulls_first: bool) -> np.ndarray:
    """Stable row order of (values, validity) columns under Spark's
    ordering, from the reference's host order key."""
    keys = []
    for v, valid in cols:
        k = _np_total_order_key(v, valid)
        k = np.where(valid, k if ascending else ~k, np.uint64(0))
        keys += [np.where(valid, 1, 0) if nulls_first
                 else np.where(valid, 0, 1), k]
    return np.lexsort(keys[::-1])


def _ref_perm(ops):
    n = ops[0].shape[0]
    out = jax.lax.sort(tuple(ops) + (jnp.arange(n, dtype=jnp.int32),),
                       num_keys=len(ops), is_stable=True)
    return np.asarray(out[-1])


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("kind", ["int", "long", "double", "float", "bool",
                                  "date"])
def test_order_key_operands_sort_as_the_reference(kind, ascending,
                                                  nulls_first):
    rng = np.random.RandomState(11)
    v, valid, pdt, rdt = _column(kind, rng)
    v = _zero_nulls(v, valid)          # null slots hold the default
    ref_ops = ref_enc.order_key_operands(
        RDVal(jnp.asarray(v), jnp.asarray(valid), rdt), ascending,
        nulls_first)
    ops = enc.order_key_operands(
        DVal(torch.from_numpy(v), torch.from_numpy(valid), pdt), ascending,
        nulls_first)
    np.testing.assert_array_equal(ops[0].numpy(), np.asarray(ref_ops[0]))
    if kind not in ("double", "float"):
        np.testing.assert_array_equal(ops[1].numpy(), np.asarray(ref_ops[1]))
    perm = enc.lexsort_permutation(ops).numpy()
    if kind in ("double", "float") and not ascending:
        np.testing.assert_array_equal(perm, _spark_order(
            [(v, valid)], ascending, nulls_first))
    else:
        np.testing.assert_array_equal(perm, _ref_perm(ref_ops))
    # grouping equality: rows adjacent after the sort are equal on the
    # port's operands exactly where they are on the reference's
    eq = np.ones(len(v) - 1, bool)
    ref_eq = np.ones(len(v) - 1, bool)
    for op, rop in zip(ops, ref_ops):
        s = op.numpy()[perm]
        rs = np.asarray(rop)[perm]
        eq &= enc.operands_equal(torch.from_numpy(s[1:]),
                                 torch.from_numpy(s[:-1])).numpy()
        ref_eq &= np.asarray(ref_enc.operands_equal(jnp.asarray(rs[1:]),
                                                    jnp.asarray(rs[:-1])))
    np.testing.assert_array_equal(eq, ref_eq)


def test_float_key_is_spark_total_order():
    """NaN above +inf, -0.0 equal to 0.0, one NaN, subnormals kept, in
    both directions."""
    d = torch.tensor([np.nan, np.inf, -0.0, 0.0, -np.inf, -np.nan, 1.0,
                      -5e-324, 5e-324], dtype=torch.float64)
    ok = torch.ones(9, dtype=torch.bool)
    up = enc.order_key_operands(DVal(d, ok, PT.FLOAT64), True, True)[1]
    assert up[2] == up[3] and up[0] == up[5]
    assert (up[4] < up[7] < up[2] < up[8] < up[6] < up[1] < up[0]).item()
    down = enc.order_key_operands(DVal(d, ok, PT.FLOAT64), False, True)[1]
    assert (down[0] < down[1] < down[6] < down[8] < down[2] < down[7]
            < down[4]).item()


# ---------------------------------------------------------------------------
# segmented_groupby (the sort path)
# ---------------------------------------------------------------------------

def _groupby_case(seed: int, n: int):
    rng = np.random.RandomState(seed)
    k1 = rng.randint(0, 6, n).astype(np.int64)
    k1v = rng.rand(n) > 0.1
    pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.0, np.inf])
    k2 = pool[rng.randint(0, len(pool), n)]
    k2v = rng.rand(n) > 0.1
    x = np.round(rng.uniform(-1e4, 1e4, n), 2)
    xv = rng.rand(n) > 0.2
    y = rng.randint(-1000, 1000, n).astype(np.int32)
    yv = rng.rand(n) > 0.3
    keep = rng.rand(n) > 0.25
    return [(_zero_nulls(k1, k1v), k1v), (_zero_nulls(k2, k2v), k2v)], \
        (_zero_nulls(x, xv), xv), (_zero_nulls(y, yv), yv), keep


def _aggs(pkg):
    col = ColumnRef if pkg is PA else RColumnRef
    return [pkg.Sum(col("x")), pkg.Sum(col("y")), pkg.Count(col("y")),
            pkg.CountStar(), pkg.Average(col("x"))]


@pytest.mark.parametrize("seed,n", [(1, 1), (2, 37), (3, 1000), (4, 4099)])
def test_segmented_groupby_equals_reference(seed, n):
    keys, (x, xv), (y, yv), keep = _groupby_case(seed, n)
    kt = [(PT.INT64, RT.INT64), (PT.FLOAT64, RT.FLOAT64)]
    p_keys = [DVal(torch.from_numpy(d), torch.from_numpy(v), t[0])
              for (d, v), t in zip(keys, kt)]
    r_keys = [RDVal(jnp.asarray(d), jnp.asarray(v), t[1])
              for (d, v), t in zip(keys, kt)]

    def vals(mk, tx, ty, tl, arr):
        dx, dy = mk(arr(x), arr(xv), tx), mk(arr(y), arr(yv), ty)
        one = mk(arr(np.ones(n, np.int32)), arr(np.ones(n, bool)), tl)
        return [[dx], [dy], [dy], [one], [dx]]

    p_vals = vals(DVal, PT.FLOAT64, PT.INT32, PT.INT32, torch.from_numpy)
    r_vals = vals(RDVal, RT.FLOAT64, RT.INT32, RT.INT32, jnp.asarray)
    got_k, got_p, ng = segmented_groupby(p_keys, p_vals, _aggs(PA),
                                         "update", torch.from_numpy(keep))
    want_k, want_p, want_ng = ref_segmented_groupby(
        r_keys, r_vals, _aggs(RA), "update", n, n,
        row_mask=jnp.asarray(keep))
    want_ng = int(want_ng)
    assert ng == want_ng
    for (d, v), (rd, rv) in zip(got_k + got_p, list(want_k) + list(want_p)):
        rv = np.asarray(rv)[:ng]
        rd = np.asarray(rd)[:ng]
        np.testing.assert_array_equal(v.numpy(), rv)
        np.testing.assert_array_equal(np.where(rv, d.numpy(), 0),
                                      np.where(rv, rd, 0))

    # and the merge of those partials split in two, against the
    # reference's merge of the same rows
    h = ng // 2
    ptypes = [PT.FLOAT64, PT.INT64, PT.INT64, PT.INT64, PT.FLOAT64,
              PT.INT64]
    rtypes = [RT.FLOAT64, RT.INT64, RT.INT64, RT.INT64, RT.FLOAT64,
              RT.INT64]
    cols = [(d.numpy(), v.numpy()) for d, v in got_k + got_p]
    rows = np.concatenate([np.arange(h), np.arange(h), np.arange(h, ng)])
    mk = [(d[rows], v[rows]) for d, v in cols]
    mkeys_p = [DVal(torch.from_numpy(d), torch.from_numpy(v), t[0])
               for (d, v), t in zip(mk[:2], kt)]
    mkeys_r = [RDVal(jnp.asarray(d), jnp.asarray(v), t[1])
               for (d, v), t in zip(mk[:2], kt)]
    split = [[0], [1], [2], [3], [4, 5]]
    mv_p = [[DVal(torch.from_numpy(mk[2 + i][0]),
                  torch.from_numpy(mk[2 + i][1]), ptypes[i]) for i in g]
            for g in split]
    mv_r = [[RDVal(jnp.asarray(mk[2 + i][0]), jnp.asarray(mk[2 + i][1]),
                   rtypes[i]) for i in g] for g in split]
    live = np.ones(len(rows), bool)
    got_k, got_p, ng2 = segmented_groupby(mkeys_p, mv_p, _aggs(PA), "merge",
                                          torch.from_numpy(live))
    want_k, want_p, want_ng2 = ref_segmented_groupby(
        mkeys_r, mv_r, _aggs(RA), "merge", len(rows), len(rows),
        row_mask=jnp.asarray(live))
    assert ng2 == int(want_ng2) == ng
    for (d, v), (rd, rv) in zip(got_k + got_p, list(want_k) + list(want_p)):
        rv = np.asarray(rv)[:ng2]
        np.testing.assert_array_equal(v.numpy(), rv)
        np.testing.assert_array_equal(np.where(rv, d.numpy(), 0),
                                      np.where(rv, np.asarray(rd)[:ng2], 0))


# ---------------------------------------------------------------------------
# dense groupby: plain version and the kernel's arithmetic
# ---------------------------------------------------------------------------

def _dense_case(seed: int, rows: int, cards, ncols: int, G: int,
                all_dead: bool = False):
    """Per key: codes into a batch dictionary of its own size, a remap of
    them onto global codes below card, validity; a keep mask; value
    columns alternating float64, int64 and count-only."""
    rng = np.random.RandomState(seed)
    keys, remaps = [], []
    for c in cards:
        local = rng.randint(1, c + 1)
        remap = rng.permutation(c)[:local].astype(np.int32)
        codes = rng.randint(0, local, rows).astype(np.int32)
        valid = rng.rand(rows) > 0.1
        keys.append((codes, valid))
        remaps.append(remap)
    keep = np.zeros(rows, bool) if all_dead else rng.rand(rows) > 0.2
    values = []
    for j in range(ncols):
        valid = rng.rand(rows) > 0.15
        if j % 3 == 0:
            d = np.round(rng.uniform(-1e5, 1e5, rows), 2)
        elif j % 3 == 1:
            d = rng.randint(-(1 << 40), 1 << 40, rows).astype(np.int64)
        else:
            d = None
        if d is not None:
            d[~valid] = 0
        values.append((d, valid))
    return keys, remaps, list(cards), keep, values, G


def _torch_case(case):
    keys, remaps, cards, keep, values, G = case
    t = torch.from_numpy
    return ([(t(c), t(v)) for c, v in keys], [t(r) for r in remaps], cards,
            t(keep), [(None if d is None else t(d), t(v)) for d, v in values],
            G)


def _gid_numpy(keys, remaps, cards, keep, G):
    gid = np.zeros(len(keep), np.int64)
    stride = 1
    for (codes, valid), remap, card in reversed(list(zip(keys, remaps,
                                                         cards))):
        g = np.where(valid, remap[codes], card)
        gid += g * stride
        stride *= card + 1
    return np.where(keep, gid, G)


@pytest.mark.parametrize("seed,rows,cards,ncols,G", [
    (1, 1000, (3, 2), 5, 16),
    (2, 3001, (7,), 3, 16),
    (3, 5000, (3, 3, 1), 4, 64),
    (4, 777, (2, 2, 2, 1), 8, 64),
])
def test_dense_plain_version_equals_reference_seg_sum(seed, rows, cards,
                                                      ncols, G):
    case = _dense_case(seed, rows, cards, ncols, G)
    keys, remaps, cards, keep, values, G = case
    gid = jnp.asarray(_gid_numpy(keys, remaps, cards, keep, G))
    got = dense_groupby_reference(*_torch_case(case))
    occ = np.asarray(ref_seg_sum(jnp.asarray(keep.astype(np.int64)), gid, G))
    np.testing.assert_array_equal(got.occupancy.numpy(), occ)
    for k, (d, v) in enumerate(values):
        data = jnp.asarray(d if d is not None else np.zeros(rows))
        s, cnt = RA._seg_sum(data, jnp.asarray(v), gid, G)
        np.testing.assert_array_equal(got.counts[k].numpy(), np.asarray(cnt))
        if d is None:
            assert got.sums[k] is None
        elif d.dtype == np.int64:
            np.testing.assert_array_equal(got.sums[k].numpy(), np.asarray(s))
        else:
            for a, b in zip(got.sums[k].numpy(), np.asarray(s)):
                assert _rel_ok(a, b)


def test_dense_wrapper_on_cpu_runs_the_plain_version():
    case = _torch_case(_dense_case(5, 500, (3, 2), 3, 16))
    before = dense_groupby.launches
    got = dense_groupby(*case)
    want = dense_groupby_reference(*case)
    assert dense_groupby.launches == before          # no kernel ran
    assert torch.equal(got.occupancy, want.occupancy)
    assert torch.equal(got.counts, want.counts)
    for a, b in zip(got.sums, want.sums):
        assert (a is None and b is None) or torch.equal(a, b)
    keys, remaps, cards, keep, values, G = case
    with pytest.raises(ValueError, match="do not fit"):
        dense_groupby(keys, remaps, [15, 1], keep, values, 16)
    with pytest.raises(ValueError, match="groups"):
        dense_groupby(keys, remaps, cards, keep, values, 32)
    with pytest.raises(TypeError):
        dense_groupby(keys, remaps, cards, keep,
                      [(values[0][0].float(), values[0][1])], 16)


_HOST_SRC = r"""
#include <stdint.h>
#include <string.h>
#include <vector>
#include "dense_groupby_row.cuh"

// dense_groupby.cu's two launches, block by block and thread by thread,
// in the order the card adds: per block, each thread's group ids and
// occupancy (dg_stage_ids); per column, each thread's rows loaded
// (dg_load_column) and added into its slots (dg_accumulate), then per
// group the lanes' folds of every 32nd slot and the warp tree; then per
// (column, group) the lanes' folds of every 32nd block and the tree.
template <typename T>
static void fold_block(const T* sums, const int32_t* cnts, int G, int tpb,
                       int64_t* psum, int64_t* pcnt) {
  for (int g = 0; g < G; ++g) {
    int64_t n[kDgLanes];
    T s[kDgLanes];
    for (int l = 0; l < kDgLanes; ++l) {
      n[l] = dg_fold<int64_t>(cnts + dg_slot(g, 0, tpb), 1, l, tpb);
      s[l] = sums ? dg_fold<T>(sums + dg_slot(g, 0, tpb), 1, l, tpb) : T(0);
    }
    pcnt[g] = dg_tree_host(n);
    T total = dg_tree_host(s);
    memcpy(&psum[g], &total, 8);
  }
}

template <typename T>
static int64_t fold_blocks(const int64_t* part, int64_t stride,
                           int64_t blocks) {
  T v[kDgLanes];
  for (int l = 0; l < kDgLanes; ++l)
    v[l] = dg_fold<T>(reinterpret_cast<const T*>(part), stride, l, blocks);
  T total = dg_tree_host(v);
  int64_t bits;
  memcpy(&bits, &total, 8);
  return bits;
}

template <int R>
static int run(const DgKeys& k, const uint8_t* keep, int64_t rows,
               int ncols, const void* const* data,
               const uint8_t* const* valid, const uint8_t* is_int, int G,
               int tpb, int64_t* sums, int64_t* counts, int64_t* occupancy) {
  const int64_t blocks = (rows + kDgRowsPerBlock - 1) / kDgRowsPerBlock;
  const int64_t stride = int64_t(ncols + 1) * G;
  std::vector<int64_t> psum(blocks * stride), pcnt(blocks * stride);
  std::vector<int64_t> s_sum(G * tpb);
  std::vector<int32_t> s_cnt(G * tpb);
  // each thread's registers: its rows' group ids, one column over them
  std::vector<int> g(tpb * R);
  std::vector<int64_t> x(tpb * R);
  std::vector<uint8_t> v(tpb * R);
  for (int64_t b = 0; b < blocks; ++b) {
    const int64_t r0 = b * kDgRowsPerBlock;
    const int64_t r1 = rows - r0 < kDgRowsPerBlock ? rows
                                                   : r0 + kDgRowsPerBlock;
    int64_t* ps = psum.data() + b * stride;
    int64_t* pc = pcnt.data() + b * stride;
    std::fill(s_cnt.begin(), s_cnt.end(), 0);
    for (int t = 0; t < tpb; ++t)
      dg_stage_ids<R>(k, keep, r0, r1, t, tpb, G, &g[t * R], s_cnt.data());
    fold_block<int64_t>(nullptr, s_cnt.data(), G, tpb, ps + ncols * G,
                        pc + ncols * G);
    for (int c = 0; c < ncols; ++c) {
      std::fill(s_sum.begin(), s_sum.end(), 0);
      std::fill(s_cnt.begin(), s_cnt.end(), 0);
      const bool count_only = data[c] == nullptr;
      for (int t = 0; t < tpb; ++t) {
        dg_load_column<R>(static_cast<const int64_t*>(data[c]), valid[c],
                          r0, r1, t, tpb, &x[t * R], &v[t * R]);
        if (is_int[c])
          dg_accumulate<int64_t, R>(&g[t * R], &x[t * R], &v[t * R], t,
                                    tpb, G, count_only, s_sum.data(),
                                    s_cnt.data());
        else
          dg_accumulate<double, R>(&g[t * R], &x[t * R], &v[t * R], t, tpb,
                                   G, count_only,
                                   reinterpret_cast<double*>(s_sum.data()),
                                   s_cnt.data());
      }
      if (is_int[c])
        fold_block<int64_t>(count_only ? nullptr : s_sum.data(),
                            s_cnt.data(), G, tpb, ps + c * G, pc + c * G);
      else
        fold_block<double>(count_only ? nullptr
                           : reinterpret_cast<double*>(s_sum.data()),
                           s_cnt.data(), G, tpb, ps + c * G, pc + c * G);
    }
  }
  for (int c = 0; c <= ncols; ++c)
    for (int gr = 0; gr < G; ++gr) {
      const int64_t w = int64_t(c) * G + gr;
      const int64_t n = fold_blocks<int64_t>(pcnt.data() + w, stride,
                                             blocks);
      if (c == ncols) {
        occupancy[gr] = n;
        continue;
      }
      counts[w] = n;
      const int64_t bits = is_int[c]
          ? fold_blocks<int64_t>(psum.data() + w, stride, blocks)
          : fold_blocks<double>(psum.data() + w, stride, blocks);
      sums[w] = data[c] ? bits : 0;
    }
  return 0;
}

extern "C" int dense_groupby_host(
    int nkeys, const int32_t* const* codes, const uint8_t* const* kvalid,
    const int32_t* const* remaps, const int32_t* remap_len,
    const int32_t* cards, const uint8_t* keep, int64_t rows, int ncols,
    const void* const* data, const uint8_t* const* valid,
    const uint8_t* is_int, int G, int tpb, int64_t* sums, int64_t* counts,
    int64_t* occupancy) {
  DgKeys k = {};
  k.nkeys = nkeys;
  for (int i = 0; i < nkeys; ++i) {
    k.codes[i] = codes[i];
    k.valid[i] = kvalid[i];
    k.remap[i] = remaps[i];
    k.remap_len[i] = remap_len[i];
    k.card[i] = cards[i];
  }
  if (dg_strides(&k) > G) return 1;
  if (tpb == 256)
    return run<kDgRowsPerBlock / 256>(k, keep, rows, ncols, data, valid,
                                      is_int, G, tpb, sums, counts,
                                      occupancy);
  if (tpb == 128)
    return run<kDgRowsPerBlock / 128>(k, keep, rows, ncols, data, valid,
                                      is_int, G, tpb, sums, counts,
                                      occupancy);
  return 2;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("dense_groupby_host")
    src = d / "dense_groupby_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "libdense_groupby_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-ffp-contract=off", "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.dense_groupby_host.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int64,
                                                  ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 3)
    lib.dense_groupby_host.restype = ctypes.c_int
    return lib.dense_groupby_host


def _run_host(fn, case):
    keys, remaps, cards, keep, values, G = case
    tpb = 256 if G <= 16 else 128            # dense_groupby.cu threads_of
    K = len(values)
    keep_c = np.ascontiguousarray(keep.astype(np.uint8))
    kcodes = [np.ascontiguousarray(c) for c, _ in keys]
    kvalid = [np.ascontiguousarray(v.astype(np.uint8)) for _, v in keys]
    rm = [np.ascontiguousarray(r) if len(r) else np.zeros(1, np.int32)
          for r in remaps]
    vdata = [None if d is None else np.ascontiguousarray(d)
             for d, _ in values]
    vvalid = [np.ascontiguousarray(v.astype(np.uint8)) for _, v in values]

    def ptrs(arrs):
        return (ctypes.c_void_p * max(len(arrs), 1))(
            *[None if a is None else a.ctypes.data for a in arrs])
    sums = np.zeros((K, G), np.int64)
    counts = np.zeros((K, G), np.int64)
    occ = np.zeros(G, np.int64)
    i32 = ctypes.c_int32 * len(keys)
    rc = fn(len(keys), ptrs(kcodes), ptrs(kvalid), ptrs(rm),
            i32(*[len(r) for r in remaps]), i32(*cards), keep_c.ctypes.data,
            len(keep), K, ptrs(vdata), ptrs(vvalid),
            (ctypes.c_uint8 * max(K, 1))(*[int(d is not None and
                                               d.dtype == np.int64)
                                           for d, _ in values]),
            G, tpb, sums.ctypes.data, counts.ctypes.data, occ.ctypes.data)
    assert rc == 0
    return sums, counts, occ


@pytest.mark.parametrize("seed,rows,cards,ncols,G,dead", [
    (10, 1, (2,), 1, 16, False),
    (11, 2047, (3, 2), 3, 16, False),
    (12, 70001, (3, 2), 8, 16, False),       # 35 blocks: lanes fold two
    (13, 9000, (15,), 2, 16, False),
    (14, 20000, (4, 3, 2), 6, 64, False),
    (15, 4096, (63,), 4, 64, False),
    (16, 5000, (3, 2), 3, 16, True),          # every row dead
    (17, 3000, (2, 2), 0, 16, False),         # occupancy only
])
def test_kernel_block_loop_built_by_gxx(host_lib, seed, rows, cards, ncols,
                                        G, dead):
    case = _dense_case(seed, rows, cards, ncols, G, all_dead=dead)
    sums, counts, occ = _run_host(host_lib, case)
    want = dense_groupby_reference(*_torch_case(case))
    np.testing.assert_array_equal(occ, want.occupancy.numpy())
    np.testing.assert_array_equal(counts, want.counts.numpy())
    for k, (d, _) in enumerate(case[4]):
        if d is None:
            assert not sums[k].any()
        elif d.dtype == np.int64:
            np.testing.assert_array_equal(sums[k], want.sums[k].numpy())
        else:
            for a, b in zip(sums[k].view(np.float64), want.sums[k].numpy()):
                assert _rel_ok(a, b)
    if dead:
        assert not occ.any() and not counts.any()
    # the fixed order gives the same bits again
    again = _run_host(host_lib, case)
    for a, b in zip((sums, counts, occ), again):
        np.testing.assert_array_equal(a, b)


def test_group_id_clamps_and_drops(host_lib):
    """A code past its remap is clamped into it; an empty remap sends the
    key to its null slot."""
    keys = [(np.array([0, 5, -3, 1], np.int32), np.ones(4, bool)),
            (np.array([0, 0, 0, 0], np.int32), np.ones(4, bool))]
    remaps = [np.array([2, 1], np.int32), np.zeros(0, np.int32)]
    case = (keys, remaps, [3, 2], np.ones(4, bool), [], 16)
    _, _, occ = _run_host(host_lib, case)
    want = dense_groupby_reference(*_torch_case(case))
    np.testing.assert_array_equal(occ, want.occupancy.numpy())
    # codes 0, 5 -> 1 (clamped), -3 -> 0, 1: global 2, 1, 2, 1; key 2 null
    expect = np.zeros(16, np.int64)
    expect[2 * 3 + 2] = 2
    expect[1 * 3 + 2] = 2
    np.testing.assert_array_equal(occ, expect)


# ---------------------------------------------------------------------------
# the keyed aggregate end to end
# ---------------------------------------------------------------------------

def _table(n: int, seed: int = 3):
    rng = np.random.RandomState(seed)
    flags = ["A", "N", "R"]
    status = ["O", "F"]
    return pa.table({
        "f": pa.array([None if rng.rand() < 0.05 else flags[i]
                       for i in rng.randint(0, 3, n)], pa.string()),
        "s": pa.array([status[i] for i in rng.randint(0, 2, n)]),
        "k": pa.array(np.where(rng.rand(n) < 0.1, None,
                               rng.randint(0, 40, n)).tolist(), pa.int64()),
        "z": pa.array([None if rng.rand() < 0.1 else float(x) for x in
                       rng.choice([np.nan, -0.0, 0.0, 1.5, -2.5, np.inf],
                                  n)], pa.float64()),
        "x": pa.array(np.round(rng.uniform(-1e4, 1e4, n), 2)),
        "q": pa.array([None if rng.rand() < 0.2 else int(v)
                       for v in rng.randint(1, 50, n)], pa.int32()),
    })


def _key(row, names):
    return tuple((row[k] is None, "" if row[k] is None else str(row[k]))
                 for k in names)


def _assert_rows_equal(got, want, keys):
    """Same rows in any order: keys and integers exactly, floats to REL."""
    assert len(got) == len(want)
    got = sorted(got, key=lambda r: _key(r, keys))
    want = sorted(want, key=lambda r: _key(r, keys))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for c in g:
            a, b = g[c], w[c]
            if isinstance(b, float) and math.isnan(b):
                assert math.isnan(a), c
            elif isinstance(b, float) and c not in keys:
                assert _rel_ok(a, b), (c, a, b)
            else:
                assert a == b, (c, a, b)


_AGGS = lambda F: (F.sum(F.col("x")).with_name("sx"),     # noqa: E731
                   F.sum(F.col("q")).with_name("sq"),
                   F.count(F.col("q")).with_name("cq"),
                   F.avg(F.col("x")).with_name("ax"),
                   F.count_star().with_name("n"))

_QUERIES = {
    "one_dict_key": (["f"], lambda df, F: df.group_by("f").agg(*_AGGS(F))),
    "two_dict_keys": (["f", "s"], lambda df, F: df.filter(
        F.col("x") > F.lit(-5000.0)).with_column(
        "y", F.col("x") * F.lit(2.0)).group_by("f", "s").agg(
        *_AGGS(F), F.sum(F.col("y")).with_name("sy"))),
    "int_key": (["k"], lambda df, F: df.group_by("k").agg(*_AGGS(F))),
    "float_key": (["z"], lambda df, F: df.group_by("z").agg(*_AGGS(F))),
    "dict_and_int_keys": (["f", "k"], lambda df, F: df.group_by(
        "f", "k").agg(*_AGGS(F))),
    "all_filtered": (["f", "s"], lambda df, F: df.filter(
        F.col("x") > F.lit(1e9)).group_by("f", "s").agg(*_AGGS(F))),
}


@pytest.mark.parametrize("batch_rows", [1 << 20, 700])
@pytest.mark.parametrize("name", sorted(_QUERIES))
def test_keyed_aggregate_equals_reference(name, batch_rows):
    keys, q = _QUERIES[name]
    t = _table(3000)
    conf = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    want = q(TpuSession(conf).create_dataframe(t), RF).collect()
    before = dense_groupby.launches
    got = q(TorchSession(conf, device="cpu").create_dataframe(t),
            PF).collect()
    assert dense_groupby.launches == before
    _assert_rows_equal(got, want, keys)
    if name != "all_filtered":
        assert len(got) > 1
    else:
        assert got == []


def test_aggregate_over_empty_input():
    t = _table(3000).slice(0, 0)
    for keys in (["f", "s"], ["k"], []):
        want = TpuSession(OFF).create_dataframe(t).group_by(*keys).agg(
            *_AGGS(RF)).collect()
        got = TorchSession(OFF, device="cpu").create_dataframe(t).group_by(
            *keys).agg(*_AGGS(PF)).collect()
        assert got == want
        # keyed: no group; keyless: one row of nulls and zero counts
        assert len(got) == (0 if keys else 1)


def test_dense_path_grows_into_the_sort_path():
    """A dictionary that outgrows the dense kernel between batches sends
    the later batches down the sort path; both merge into one answer."""
    n = 4000
    rng = np.random.RandomState(9)
    names = [f"v{i:02d}" for i in range(80)]
    first = [names[i] for i in rng.randint(0, 10, n // 2)]
    rest = [names[i] for i in rng.randint(0, 80, n // 2)]
    t = pa.table({"g": pa.array(first + rest),
                  "x": pa.array(np.round(rng.uniform(0, 100, n), 2))})
    conf = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": n // 4}
    q = lambda df, F: df.group_by("g").agg(                  # noqa: E731
        F.sum(F.col("x")).with_name("sx"), F.count_star().with_name("n"))
    want = q(TpuSession(conf).create_dataframe(t), RF).collect()
    got = q(TorchSession(conf, device="cpu").create_dataframe(t),
            PF).collect()
    _assert_rows_equal(got, want, ["g"])
    assert len(got) == 80


@pytest.mark.parametrize("orders", [
    ("f", "s"), ("s", "f"), ("k",), ("z",), ("x",)])
@pytest.mark.parametrize("desc", [False, True])
def test_order_by_equals_reference(orders, desc):
    """ORDER BY over dictionary, int and float columns with nulls and
    NaNs, ascending and descending, over several batches."""
    t = _table(2000, seed=4)
    conf = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": 300}

    def q(df, F):
        os = [F.col(c).desc() if desc else F.col(c).asc() for c in orders]
        return df.order_by(*os)
    got = q(TorchSession(conf, device="cpu").create_dataframe(t),
            PF).collect()
    cols = []
    for c in orders:
        arr = t.column(c)
        valid = ~np.asarray(arr.is_null())
        cols.append((np.asarray(arr.to_pylist(), dtype=object)
                     if c in ("f", "s") else arr.to_numpy(
                         zero_copy_only=False), valid))
    spark = _spark_order(cols, not desc, not desc)
    assert [r["x"] for r in got] == t.column("x").to_numpy()[spark].tolist()
    if not (desc and orders == ("z",)):
        want = q(TpuSession(conf).create_dataframe(t), RF).collect()
        assert [r["x"] for r in got] == [r["x"] for r in want]


def test_sort_of_a_byte_rectangle_key_is_refused():
    vals = np.array([f"{i:06d}comment" for i in range(3000)], dtype=object)
    df = TorchSession(OFF, device="cpu").create_dataframe({"c": vals})
    with pytest.raises(NotImplementedError, match="strings slice"):
        df.order_by("c").collect()
    with pytest.raises(NotImplementedError, match="strings slice"):
        df.group_by("c").agg(PF.count_star()).collect()


def test_sort_larger_than_batch_size_bytes_is_refused():
    t = _table(1000)
    conf = {**OFF, "spark.rapids.tpu.sql.batchSizeBytes": 1000}
    df = TorchSession(conf, device="cpu").create_dataframe(t)
    with pytest.raises(NotImplementedError, match="slice 8"):
        df.order_by("x").collect()


def test_column_pruning_reaches_through_sort():
    """A projection above a sort narrows the scan below it to the
    projected columns and the sort keys."""
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.overrides import prune_columns
    t = _table(100)
    df = TorchSession(OFF, device="cpu").create_dataframe(t)
    plan = df.order_by(PF.col("k").desc(), "f").select("x").plan
    pruned = prune_columns(plan)
    scan = pruned.children[0].children[0]
    assert isinstance(pruned.children[0], L.Sort)
    assert scan.columns == ["f", "k", "x"]
    got = df.order_by(PF.col("k").desc(), "f").select("x").collect()
    want = TpuSession(OFF).create_dataframe(t).order_by(
        RF.col("k").desc(), "f").select("x").collect()
    assert got == want
