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
  driven through the kernel's warp loop (every ballot and shuffle
  emulated lane by lane), its fold in warp order and its two-level
  combine on the host, against the plain version: counts and integer
  sums exactly, float sums to a relative 1e-12 (the kernel's fixed order
  is not the one-hot's), sums that are not finite equal; and with
  blocks, warps and tickets taken in shuffled orders, the same bits.
"""
import ctypes
import math
import re
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
#include <algorithm>
#include <random>
#include <vector>
#include "dense_groupby_row.cuh"

// dense_groupby.cu's launch on the host, through the same functions: each
// warp's pieces of 32 rows lane by lane (every ballot and shuffle
// emulated over the 32 lanes), the block's fold in warp order, and the
// combine by the last block of each 16 and the last group; the blocks,
// and the warps within a block, taken in orders drawn from `seed` (0: in
// order).

struct Launch {
  DgKeys k;
  const uint8_t* keep;
  const uint8_t* data[kDgMaxCols];
  const uint8_t* valid[kDgMaxCols];
  int ncols, G;
  uint32_t int_mask, data_mask;
  int64_t rows;
};

// the segmented scan, steps while d < span
static void scan(bool is_int, int64_t* x, const int* start, int span) {
  for (int d = 1; d < span; d <<= 1) {
    int64_t y[kDgLanes];
    for (int l = 0; l < kDgLanes; ++l)       // __shfl_up_sync
      y[l] = x[l >= d ? l - d : l];
    for (int l = 0; l < kDgLanes; ++l)
      if (dg_scan_takes(l, d, start[l]))
        x[l] = is_int ? x[l] + y[l]
                      : dg_bits(dg_as<double>(x[l]) + dg_as<double>(y[l]));
  }
}

// piece p into one warp's slots; 0, or why the loop failed
static int reduce_piece(const Launch& L, int64_t p, int64_t* w_sum,
                        uint32_t* w_cnt) {
  const int G = L.G;
  int gid[kDgLanes];
  bool in[kDgLanes];
  for (int l = 0; l < kDgLanes; ++l) {
    const int64_t row = p * kDgLanes + l;
    in[l] = row < L.rows;
    gid[l] = in[l] ? dg_group_id(L.k, L.keep, row, G) : G;
  }
  unsigned lt[kDgLanes], eq[kDgLanes];
  for (int l = 0; l < kDgLanes; ++l) lt[l] = 0, eq[l] = 0xffffffffu;
  for (int b = dg_id_bits(G) - 1; b >= 0; --b) {
    unsigned ballot = 0;
    for (int l = 0; l < kDgLanes; ++l) ballot |= ((gid[l] >> b) & 1u) << l;
    for (int l = 0; l < kDgLanes; ++l)
      dg_rank_bit(gid[l], b, ballot, &lt[l], &eq[l]);
  }
  int src[kDgLanes], gs[kDgLanes];
  unsigned hit = 0;
  for (int l = 0; l < kDgLanes; ++l) {
    const int r = dg_rank(lt[l], eq[l], l);
    if (r < 0 || r >= kDgLanes || ((hit >> r) & 1u)) return 2;
    hit |= 1u << r;
    src[r] = l;
    gs[r] = gid[l];
  }
  for (int l = 1; l < kDgLanes; ++l)          // stable order by id
    if (gs[l - 1] > gs[l] || (gs[l - 1] == gs[l] && src[l - 1] > src[l]))
      return 3;
  unsigned heads = 0;
  for (int l = 0; l < kDgLanes; ++l)
    heads |= (l == 0 || gs[l] != gs[l - 1] ? 1u : 0u) << l;
  int start[kDgLanes], span = 0;
  unsigned seg[kDgLanes];
  bool last[kDgLanes];
  for (int l = 0; l < kDgLanes; ++l) {
    start[l] = dg_seg_start(heads, l);
    seg[l] = dg_seg_mask(start[l], l);
    last[l] = (l == kDgLanes - 1 || gs[l] != gs[l + 1]) && gs[l] < G;
    span = std::max(span, l - start[l] + 1); // __reduce_max_sync
    if (last[l]) w_cnt[L.ncols * G + gs[l]] += l - start[l] + 1;
  }
  for (int c = 0; c < L.ncols; ++c) {
    uint8_t v[kDgLanes];
    int64_t x[kDgLanes];
    unsigned vb = 0;
    for (int l = 0; l < kDgLanes; ++l) {
      const int64_t row = p * kDgLanes + l;
      v[l] = in[l] ? L.valid[c][row] : 0;
      x[l] = 0;
      if (in[l] && ((L.data_mask >> c) & 1u))
        memcpy(&x[l], L.data[c] + 8 * row, 8);
      vb |= (v[l] ? 1u : 0u) << l;
    }
    bool vs[kDgLanes];
    unsigned vsb = 0;
    for (int l = 0; l < kDgLanes; ++l) {
      vs[l] = gs[l] < G && ((vb >> src[l]) & 1u);
      vsb |= (vs[l] ? 1u : 0u) << l;
    }
    const bool is_int = (L.int_mask >> c) & 1u;
    int64_t xs[kDgLanes];
    for (int l = 0; l < kDgLanes; ++l) xs[l] = vs[l] ? x[src[l]] : 0;
    if ((L.data_mask >> c) & 1u) scan(is_int, xs, start, span);
    for (int l = 0; l < kDgLanes; ++l) {
      const unsigned nv = dg_popc(vsb & seg[l]);
      if (!(last[l] && nv)) continue;
      if ((L.data_mask >> c) & 1u) {
        int64_t* slot = w_sum + c * G + gs[l];
        *slot = is_int ? *slot + xs[l]
                       : dg_bits(dg_as<double>(*slot)
                                 + dg_as<double>(xs[l]));
      }
      w_cnt[c * G + gs[l]] += nv;
    }
  }
  return 0;
}

static void combine_into(const Launch& L, const int64_t* ps,
                         const int64_t* pc, int64_t n, int64_t* dsum,
                         int64_t* dcnt) {
  const int kg = L.ncols * L.G;
  for (int o = 0; o < kg + L.G; ++o) {
    dcnt[o] = dg_combine<int64_t>(pc, kg + L.G, n, o);
    if (o >= kg) continue;
    const int c = o / L.G;
    int64_t s = 0;
    if ((L.data_mask >> c) & 1u)
      s = ((L.int_mask >> c) & 1u) ? dg_combine<int64_t>(ps, kg, n, o)
                                   : dg_combine<double>(ps, kg, n, o);
    dsum[o] = s;
  }
}

// the packed arguments of dense_groupby_launch (scratch and stream
// unused); `grid` blocks at most; returns 0, or why the loop failed
extern "C" int dense_groupby_host(const int64_t* v, int64_t grid,
                                  uint64_t seed) {
  Launch L = {};
  const int nk = static_cast<int>(v[0]);
  L.ncols = static_cast<int>(v[1]);
  L.G = static_cast<int>(v[2]);
  L.rows = v[3];
  L.keep = reinterpret_cast<const uint8_t*>(v[4]);
  L.int_mask = static_cast<uint32_t>(v[9]);
  const int64_t* kv = v + 10;
  const int64_t* cv = kv + 5 * nk;
  L.k.nkeys = nk;
  for (int i = 0; i < nk; ++i) {
    L.k.codes[i] = reinterpret_cast<const int32_t*>(kv[5 * i]);
    L.k.valid[i] = reinterpret_cast<const uint8_t*>(kv[5 * i + 1]);
    L.k.remap[i] = reinterpret_cast<const int32_t*>(kv[5 * i + 2]);
    L.k.remap_len[i] = static_cast<int32_t>(kv[5 * i + 3]);
    L.k.card[i] = static_cast<int32_t>(kv[5 * i + 4]);
  }
  if (dg_strides(&L.k) > L.G) return 1;
  for (int c = 0; c < L.ncols; ++c) {
    L.data[c] = reinterpret_cast<const uint8_t*>(cv[2 * c]);
    L.valid[c] = reinterpret_cast<const uint8_t*>(cv[2 * c + 1]);
    L.data_mask |= (cv[2 * c] != 0 ? 1u : 0u) << c;
  }
  const int G = L.G, kg = L.ncols * G;
  const int64_t pieces = (L.rows + kDgLanes - 1) / kDgLanes;
  grid = std::max<int64_t>(1, std::min<int64_t>(
      grid, (pieces + kDgWarps - 1) / kDgWarps));
  std::vector<int64_t> psum(grid * kg), pcnt(grid * (kg + G));
  std::mt19937_64 rng(seed);
  std::vector<int64_t> order(grid);
  for (int64_t b = 0; b < grid; ++b) order[b] = b;
  if (seed) std::shuffle(order.begin(), order.end(), rng);
  for (int64_t b : order) {                   // blocks run in any order
    std::vector<int64_t> w_sum(kDgWarps * kg, 0);
    std::vector<uint32_t> w_cnt(kDgWarps * (kg + G), 0);
    int warps[kDgWarps];                      // warps interleave freely
    for (int w = 0; w < kDgWarps; ++w) warps[w] = w;
    if (seed) std::shuffle(warps, warps + kDgWarps, rng);
    for (int w : warps) {
      int64_t p0, p1;
      dg_piece_range(pieces, grid * kDgWarps, b * kDgWarps + w, &p0, &p1);
      for (int64_t p = p0; p < p1; ++p) {
        const int rc = reduce_piece(L, p, w_sum.data() + w * kg,
                                    w_cnt.data() + w * (kg + G));
        if (rc) return rc;
      }
    }
    for (int o = 0; o < kg + G; ++o) {
      pcnt[b * (kg + G) + o] =
          dg_fold_warps<int64_t>(w_cnt.data(), kg + G, kDgWarps, o);
      if (o >= kg) continue;
      const int c = o / G;
      int64_t s = 0;
      if ((L.data_mask >> c) & 1u)
        s = ((L.int_mask >> c) & 1u)
                ? dg_fold_warps<int64_t>(w_sum.data(), kg, kDgWarps, o)
                : dg_fold_warps<double>(w_sum.data(), kg, kDgWarps, o);
      psum[b * kg + o] = s;
    }
  }
  // tickets, taken as the blocks finish
  int64_t* sums = reinterpret_cast<int64_t*>(v[5]);
  int64_t* counts = sums + kg;
  const int64_t groups = (grid + kDgCombine - 1) / kDgCombine;
  std::vector<int64_t> gsum(groups * kg), gcnt(groups * (kg + G));
  std::vector<int> tickets(groups, 0);
  int last_groups = 0, combines = 0;
  if (seed) std::shuffle(order.begin(), order.end(), rng);
  for (int64_t b : order) {
    const int64_t q = b / kDgCombine, first = q * kDgCombine;
    const int64_t nq = std::min<int64_t>(kDgCombine, grid - first);
    if (++tickets[q] != nq) continue;
    ++combines;
    if (groups == 1) {
      combine_into(L, psum.data(), pcnt.data(), nq, sums, counts);
      continue;
    }
    combine_into(L, psum.data() + first * kg,
                 pcnt.data() + first * (kg + G), nq, gsum.data() + q * kg,
                 gcnt.data() + q * (kg + G));
    if (++last_groups == groups) {
      combine_into(L, gsum.data(), gcnt.data(), groups, sums, counts);
      ++combines;
    }
  }
  return combines == groups + (groups > 1 ? 1 : 0) ? 0 : 5;
}

// a block's dynamic shared memory (kDgWarps x dg_warp_bytes)
extern "C" int64_t dense_groupby_smem_host(int G, int ncols) {
  return kDgWarps * dg_warp_bytes(G, ncols);
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
    lib.dense_groupby_host.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_uint64]
    lib.dense_groupby_host.restype = ctypes.c_int
    lib.dense_groupby_smem_host.argtypes = [ctypes.c_int] * 2
    lib.dense_groupby_smem_host.restype = ctypes.c_int64
    return lib


def _at_offset(a: np.ndarray, mis: int) -> np.ndarray:
    """A copy of ``a`` whose first byte lies ``mis`` bytes past a 16-byte
    boundary (a view into a larger buffer, as a column view at an
    offset)."""
    buf = np.zeros(a.nbytes + 64, np.uint8)
    start = (mis - buf.ctypes.data) % 16
    out = buf[start:start + a.nbytes].view(a.dtype)
    out[:] = a
    assert out.ctypes.data % 16 == mis
    return out


def _run_host(lib, case, grid=1 << 20, seed=0, mis=None):
    """The kernel's loop on the host over ``case``, with the wrapper's
    packed arguments; ``mis`` places every array that many bytes (rounded
    to its element size) past a 16-byte boundary."""
    keys, remaps, cards, keep, values, G = case
    K = len(values)

    def arr(a, dtype):
        a = np.ascontiguousarray(a.astype(dtype, copy=False))
        if mis is not None:
            a = _at_offset(a, mis - mis % a.itemsize)
        return a
    keep_c = arr(keep, np.uint8)
    held = [keep_c]
    out = np.zeros(2 * K * G + G, np.int64)
    int_mask = sum(1 << c for c, (d, _) in enumerate(values)
                   if d is not None and d.dtype == np.int64)
    v = [len(keys), K, G, len(keep), keep_c.ctypes.data, out.ctypes.data,
         0, 0, 0, int_mask]
    for (codes, valid), remap, card in zip(keys, remaps, cards):
        c, kv = arr(codes, np.int32), arr(valid, np.uint8)
        r = np.ascontiguousarray(remap) if len(remap) else np.zeros(1,
                                                                   np.int32)
        held += [c, kv, r]
        v += [c.ctypes.data, kv.ctypes.data, r.ctypes.data, len(remap), card]
    for d, valid in values:
        vv = arr(valid, np.uint8)
        held.append(vv)
        if d is None:
            v += [0, vv.ctypes.data]
        else:
            dd = arr(d, d.dtype)
            held.append(dd)
            v += [dd.ctypes.data, vv.ctypes.data]
    packed = np.asarray(v, np.int64)
    rc = lib.dense_groupby_host(packed.ctypes.data, grid, seed)
    assert rc == 0
    return out[:K * G].reshape(K, G), out[K * G:2 * K * G].reshape(K, G), \
        out[2 * K * G:]


def _assert_host_equals_plain(case, got):
    """Counts and int sums exactly; float sums to REL, and where the plain
    version's sum is not finite, the same value."""
    sums, counts, occ = got
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
                if math.isfinite(b):
                    assert _rel_ok(a, b), (a, b)
                else:
                    assert a == b or (math.isnan(a) and math.isnan(b)), \
                        (a, b)


def _same_bits(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed,rows,cards,ncols,G,dead", [
    (10, 1, (2,), 1, 16, False),
    (11, 2047, (3, 2), 3, 16, False),
    (12, 70001, (3, 2), 8, 16, False),       # many tiles, several blocks
    (13, 9000, (15,), 2, 16, False),
    (14, 20000, (4, 3, 2), 6, 64, False),
    (15, 4096, (63,), 4, 64, False),
    (16, 5000, (3, 2), 3, 16, True),          # every row dead
    (17, 3000, (2, 2), 0, 16, False),         # occupancy only
])
def test_kernel_block_loop_built_by_gxx(host_lib, seed, rows, cards, ncols,
                                        G, dead):
    case = _dense_case(seed, rows, cards, ncols, G, all_dead=dead)
    got = _run_host(host_lib, case, grid=7)
    _assert_host_equals_plain(case, got)
    if dead:
        assert not got[2].any() and not got[1].any()
    # the fixed order gives the same bits again, and whatever the grid
    # (one block, or more than 16: the second combine level)
    _same_bits(got, _run_host(host_lib, case, grid=7))
    for grid in (1, 40):
        _assert_host_equals_plain(case, _run_host(host_lib, case, grid=grid))


def _skewed(case, how: str):
    """``case`` with its keys rewritten: every live row in one group, or
    each of the first rows in a group of its own."""
    keys, remaps, cards, keep, values, G = case
    rows = len(keep)
    keys = [(np.zeros(rows, np.int32) if how == "one" else
             (np.arange(rows) % len(r)).astype(np.int32)
             if len(cards) == 1 else c, np.ones(rows, bool))
            for (c, _), r in zip(keys, remaps)]
    return keys, remaps, cards, keep, values, G


def _nonfinite(case, seed: int):
    """``case`` with -0.0, NaN, +inf and -inf planted in its float
    columns, a few rows each."""
    keys, remaps, cards, keep, values, G = case
    rng = np.random.RandomState(seed)
    out = []
    for d, v in values:
        if d is not None and d.dtype == np.float64:
            d = d.copy()
            rows = rng.permutation(len(d))
            d[rows[:50]] = -0.0
            for k, x in enumerate((np.nan, np.inf, -np.inf)):
                d[rows[50 + 3 * k:53 + 3 * k]] = x
            d[~v] = 0
        out.append((d, v))
    return keys, remaps, cards, keep, out, G


@pytest.mark.parametrize("name", [
    "one_group_g16", "one_group_g64", "one_row_per_group_g64",
    "one_row_per_group_g16", "nonfinite_g16", "nonfinite_g64"])
def test_kernel_loop_skew_and_nonfinite(host_lib, name):
    """Every live row in one group; one row per group (up to 63 distinct
    groups in a warp's 32 rows at G = 64); -0.0, NaN and +-inf values."""
    G = 64 if name.endswith("g64") else 16
    cards = (63,) if name.startswith("one_row") and G == 64 else \
        (15,) if name.startswith("one_row") else (3, 2)
    case = _dense_case(len(name), 6000, cards, 4, G)
    if name.startswith("one_group"):
        case = _skewed(case, "one")
    elif name.startswith("one_row"):
        keys, remaps, cards, keep, values, G = case
        remaps = [np.arange(cards[0], dtype=np.int32)]
        case = _skewed((keys, remaps, cards, keep, values, G), "each")
    else:
        case = _nonfinite(case, 3)
    got = _run_host(host_lib, case, grid=5)
    _assert_host_equals_plain(case, got)
    _same_bits(got, _run_host(host_lib, case, grid=5, seed=9))
    if name.startswith("one_group"):
        assert np.count_nonzero(got[2]) == 1


@pytest.mark.parametrize("rows,grid", [
    (31, 1), (32, 1), (33, 1), (255, 1), (257, 1), (257, 2), (8 * 32 * 3, 3),
    (8 * 32 * 3 + 1, 3)])
def test_kernel_loop_row_counts_at_piece_edges(host_lib, rows, grid):
    """Row counts either side of a warp's 32-row piece, of a block's 8
    warps' pieces, and of the grid's: the pieces split among the warps
    with the ragged one last."""
    case = _dense_case(rows, rows, (3, 2), 5, 16)
    _assert_host_equals_plain(case, _run_host(host_lib, case, grid=grid))


@pytest.mark.parametrize("mis", [1, 3, 4, 8, 12, 15])
def test_kernel_loop_takes_column_views_at_any_offset(host_lib, mis):
    """Every array placed ``mis`` bytes past a 16-byte boundary (rounded
    down to its element size): the copies' plain ends and 16-byte aligned
    middles in 16-byte pieces still put every byte where the loop reads
    it."""
    case = _dense_case(40 + mis, 5000 + mis, (4, 3, 2), 5, 64)
    got = _run_host(host_lib, case, grid=3, mis=mis)
    _assert_host_equals_plain(case, got)
    _same_bits(got, _run_host(host_lib, case, grid=3))


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_blocks_finishing_in_any_order_give_the_same_bits(host_lib, seed):
    """Blocks run, and take their tickets, in shuffled orders, and warps
    interleave in shuffled orders: the bits never change, because every
    addition happens in an order fixed by the data's place alone."""
    case = _dense_case(77, 90001, (3, 2), 6, 16)
    base = _run_host(host_lib, case, grid=37)
    _same_bits(base, _run_host(host_lib, case, grid=37, seed=seed))
    _assert_host_equals_plain(case, base)


@pytest.mark.parametrize("G,ncols", [(16, 5), (64, 5), (64, 16), (16, 0)])
def test_block_shared_memory_is_small(host_lib, G, ncols):
    """A block's slots and scratch: a few KiB for q1's shape (G = 16) and
    the G = 64 timing shape, so that shared memory does not bound how many
    blocks an SM holds; the widest launch still fits one block."""
    smem = host_lib.dense_groupby_smem_host(G, ncols)
    assert smem == 8 * (ncols * G * 8 + (ncols + 1) * G * 4 + 32 * 8)
    if ncols <= 5 and G == 16:
        assert smem <= 16 * 1024
    assert smem <= 227 * 1024


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


def test_dense_operands_are_kept_across_queries():
    """The dense path's remaps and group slots are made once and found
    again by the next query over the same dictionaries (on the card that
    spares a copy and a stream wait a key and batch); the answer is the
    same."""
    from spark_rapids_tpu_torch.exec import aggregate as agg
    keys, q = _QUERIES["two_dict_keys"]
    t = _table(2000)
    conf = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": 700}
    agg._DEVICE_OPERANDS.clear()
    first = q(TorchSession(conf, device="cpu").create_dataframe(t),
              PF).collect()
    kept = dict(agg._DEVICE_OPERANDS)
    assert any(k[0] == "remap" for k in kept)
    assert any(k[0] == "slots" for k in kept)
    again = q(TorchSession(conf, device="cpu").create_dataframe(t),
              PF).collect()
    assert agg._DEVICE_OPERANDS.keys() == kept.keys()
    assert all(agg._DEVICE_OPERANDS[k] is kept[k] for k in kept)
    _assert_rows_equal(again, first, keys)


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
