"""The out-of-core sample sort and ``sort_within_partitions`` on the port
against the JAX package, and the ``sort_bucket`` kernel's plain version
and row logic, on the CPU.

* The out-of-core shapes of tests/test_sort.py (several buckets, NULLs,
  DESC, skewed keys) run through both packages with a 2,048-byte
  ``spark.rapids.tpu.sql.batchSizeBytes``; results compare row for row,
  exactly. The port's out-of-core result also equals its in-memory sort
  exactly (both stable), with keys that sort equal as different bits
  (-0.0 and 0.0, NaNs) on both sides of every splitter.
* ``sort_bucket_reference`` (the plain version) against the reference's
  ``_bucket_id_kernel`` on the same encoded operands, and against
  ``csrc/sort_bucket_row.cuh`` built by g++ and run as the kernel runs
  each row (its block's copy of the splitters included); and
  ``torch.searchsorted`` on one key word, the library call chip_smoke.py
  times beside the kernel.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from data_gen import DoubleGen, IntGen, gen_df
from harness import _assert_frames_equal, _canon
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exec.sort import TpuSortExec
from spark_rapids_tpu_torch.exec.sort_bucket import (_TYPES, key_words,
                                                     sort_bucket,
                                                     sort_bucket_reference)

from test_torch_slice import prebuild_reference_native

CSRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc"
OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
OOC = {**OFF, "spark.rapids.tpu.sql.batchSizeBytes": 2048}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _port(conf=OOC):
    return TorchSession(conf, device="cpu")


def _both(query, conf=OOC):
    """``query(F, session)`` on both packages, compared row for row
    exactly; returns the port's session (its ``last_plan``)."""
    s = _port(conf)
    got = query(PF, s).to_pandas()
    want = query(RF, TpuSession(conf)).to_pandas()
    _assert_frames_equal(_canon(got, False), _canon(want, False), False)
    return s


def _ooc_differential(F, s):
    df = s.create_dataframe(gen_df(
        {"a": IntGen(lo=0, hi=1000), "b": DoubleGen(), "c": IntGen()},
        n=4096), num_partitions=6)
    return df.order_by(F.col("a").asc(), F.col("b").desc())


def _ooc_nulls_and_desc(F, s):
    df = s.create_dataframe(gen_df(
        {"a": IntGen(lo=0, hi=50, nullable=True),
         "b": DoubleGen(nullable=True)}, n=2048), num_partitions=4)
    return df.order_by(F.col("a").desc(), F.col("b").asc())


def _ooc_skewed_keys(F, s):
    # heavy duplication: many splitters collapse into few distinct keys
    df = s.create_dataframe(gen_df(
        {"a": IntGen(lo=0, hi=2), "b": IntGen()}, n=4096), num_partitions=4)
    return df.order_by(F.col("a").asc(), F.col("b").asc())


def _ooc_nulls_last_three_keys(F, s):
    df = s.create_dataframe(gen_df(
        {"a": IntGen(lo=0, hi=8), "b": DoubleGen(nullable=True),
         "c": IntGen(lo=-5, hi=5)}, n=3000, seed=3), num_partitions=5)
    return df.order_by(F.col("b").asc(False), F.col("a").desc(True),
                       F.col("c").asc())


SHAPES = {"differential": _ooc_differential,
          "nulls_and_desc": _ooc_nulls_and_desc,
          "skewed_keys": _ooc_skewed_keys,
          "nulls_last_three_keys": _ooc_nulls_last_three_keys}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_out_of_core_sort_matches_reference(shape):
    s = _both(SHAPES[shape])
    plan = s.last_plan
    assert isinstance(plan, TpuSortExec) and plan.last_buckets > 1


def test_out_of_core_sort_emits_multiple_sorted_batches():
    s = _port()
    df = s.create_dataframe(gen_df({"a": IntGen()}, n=8192),
                            num_partitions=4).order_by(PF.col("a").asc())
    phys = df._physical()
    assert isinstance(phys, TpuSortExec)
    batches = [b.to_numpy()[0] for b in phys.execute(s.exec_context())]
    assert len(batches) > 1, "expected bucketed out-of-core output"
    vals = np.concatenate([v[ok] for v, ok in batches])
    assert np.all(np.diff(vals) >= 0)


def test_out_of_core_equals_in_memory_across_equal_keys():
    """Keys that sort equal with other bits (-0.0 and 0.0, NaNs of one
    value) stay in one bucket: the splitters are the rows' own encoded
    words. Both sorts are stable, so the rows come out the same."""
    rng = np.random.RandomState(5)
    n = 4000
    b = rng.choice([0.0, -0.0, np.nan, 1.5, -2.0, np.inf], n)
    t = pa.table({"b": pa.array(b), "i": pa.array(np.arange(n)),
                  "k": pa.array(rng.randint(0, 3, n),
                                mask=rng.rand(n) < 0.1)})

    def q(s):
        return s.create_dataframe(t, num_partitions=7).order_by(
            PF.col("b").desc(), PF.col("k").asc())
    ooc = _port()
    got = q(ooc).to_pandas()
    assert ooc.last_plan.last_buckets > 1
    want = q(_port(OFF)).to_pandas()
    pd.testing.assert_frame_equal(got, want)


def _string_parts(rng, layout: str, per: int) -> list:
    """Four batches' string values (None for NULL): low-cardinality pools
    that interleave in order across batches (each batch then holds its own
    dictionary, whose codes mean other strings than another batch's), or
    nearly unique values whose widest grows batch by batch (byte
    rectangles of other widths), or the two in turns."""
    pools = (["b", "d", "ff"], ["a", "c", "e", "ff"], ["bb", "cc"],
             ["a", "f", "z"])
    parts = []
    for p in range(4):
        if layout == "dictionaries" or (layout == "mixed" and p % 2 == 0):
            pool = pools[p]
            v = [pool[i] for i in rng.randint(0, len(pool), per)]
        else:
            v = ["".join(rng.choice(list("abcz"), rng.randint(
                1, 4 + 14 * p))) for _ in range(per)]
        parts.append([None if rng.rand() < 0.1 else x for x in v])
    return parts


@pytest.mark.parametrize("layout", ["dictionaries", "rectangles", "mixed"])
@pytest.mark.parametrize("ascending", [True, False])
def test_out_of_core_sort_by_a_string_across_batch_layouts(layout,
                                                           ascending):
    """ORDER BY a string column over batches that each hold the column in
    their own dictionary or in byte rectangles of their own width: the
    out-of-core sort brings the key to one form before it encodes it, so
    its buckets are ranges of the strings. Equal to the in-memory sort
    row for row (both stable), and the strings in order."""
    rng = np.random.RandomState(17)
    per = 600
    s_vals = [x for part in _string_parts(rng, layout, per) for x in part]
    n = len(s_vals)
    t = pa.table({"s": pa.array(s_vals, pa.string()),
                  "i": pa.array(np.arange(n))})

    def q(sess):
        key = PF.col("s").asc() if ascending else PF.col("s").desc()
        return sess.create_dataframe(t, num_partitions=4).order_by(key)
    ooc = _port()
    got = q(ooc).to_pandas()
    assert ooc.last_plan.last_buckets > 1
    want = q(_port(OFF)).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    nulls = got["s"].isna().to_numpy()
    vals = list(got["s"][~nulls])
    assert vals == sorted(vals, reverse=not ascending)
    # Spark: ascending puts NULLs first, descending last
    assert nulls[:nulls.sum()].all() if ascending \
        else nulls[n - nulls.sum():].all()


def test_sort_within_partitions_matches_reference():
    def q(F, s):
        df = s.create_dataframe(gen_df(
            {"a": IntGen(lo=0, hi=30, nullable=True), "b": DoubleGen()},
            n=2000, seed=2), num_partitions=3)
        return df.sort_within_partitions(F.col("a").desc(),
                                         F.col("b").asc())
    s = _both(q, OFF)
    assert isinstance(s.last_plan, TpuSortExec) \
        and not s.last_plan.global_sort


# ---------------------------------------------------------------------------
# sort_bucket's plain version, the reference's kernel and the row logic
# ---------------------------------------------------------------------------

#: the sort keys' element types, each with a scale that spreads its
#: values over its width
_KEY_TYPES = ((np.int64, 1 << 40), (np.int32, 1 << 20), (np.int16, 1 << 8),
              (np.int8, 1 << 3))


def _operands(rng, n: int, k: int):
    """k encoded operands: uint8 null ranks and signed keys of every
    width in turns, with duplicates."""
    ops = []
    for j in range(k):
        if j % 2 == 0:
            ops.append(rng.randint(0, 2, n).astype(np.uint8))
        else:
            dt, scale = _KEY_TYPES[(j // 2) % len(_KEY_TYPES)]
            ops.append((rng.randint(-6, 6, n) * scale).astype(dt))
    return ops


def _splitters(rng, ops, s: int):
    """s splitters drawn from the rows, ascending."""
    pick = rng.randint(0, len(ops[0]), s)
    sp = [op[pick] for op in ops]
    order = np.lexsort(tuple(reversed(sp)))
    return [x[order] for x in sp]


@pytest.mark.parametrize("k,s", [(1, 1), (1, 7), (2, 4), (4, 15),
                                 (6, 255)])
def test_plain_sort_bucket_matches_reference_kernel(k, s):
    from spark_rapids_tpu.exec.sort import _bucket_id_kernel
    rng = np.random.RandomState(k * 100 + s)
    n, live = 3000, 2990
    ops = _operands(rng, n, k)
    sp = _splitters(rng, ops, s)
    want = np.asarray(_bucket_id_kernel(
        tuple(jnp.asarray(o) for o in ops),
        tuple(jnp.asarray(x) for x in sp), jnp.int32(live), n))
    operands = [torch.from_numpy(o) for o in ops]
    splitters = key_words([torch.from_numpy(x) for x in sp])
    got = sort_bucket_reference(operands, splitters, live)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sort_bucket(operands, splitters, live).numpy(), want)
    if k == 1:
        lib = torch.searchsorted(splitters[0], operands[0].to(torch.int64),
                                 right=True)
        np.testing.assert_array_equal(lib[:live].numpy(), want[:live])


_HOST_SRC = r"""
#include <cstdint>
#include "sort_bucket_row.cuh"

// The kernel on the host: the operands' pointers and types as the launch
// packs them, then every row's search over the splitters as the sort
// keeps them ([K][S]).
extern "C" void sb_host(const void* const* ptrs, const int32_t* types,
                        int64_t n, int64_t num_rows,
                        const int64_t* splitters, int S, int K,
                        int32_t* out) {
  SbOperands ops = {};
  for (int k = 0; k < K; ++k) {
    ops.ptr[k] = ptrs[k];
    ops.type[k] = types[k];
  }
  for (int64_t i = 0; i < n; ++i)
    out[i] = sb_bucket(splitters, S, K, ops, i, num_rows);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("sort_bucket_host")
    src = d / "sb_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "libsb_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    lib.sb_host.argtypes = [p, p, ctypes.c_int64, ctypes.c_int64, p,
                            ctypes.c_int, ctypes.c_int, p]
    return lib


def _host_buckets(host_lib, ops, splitters, live: int) -> np.ndarray:
    n, k = len(ops[0]), len(ops)
    out = np.full(n, -7, dtype=np.int32)
    ptrs = (ctypes.c_void_p * k)(*[o.ctypes.data for o in ops])
    types = np.array([_TYPES[torch.from_numpy(o).dtype] for o in ops],
                     dtype=np.int32)
    spn = np.ascontiguousarray(splitters.numpy())
    host_lib.sb_host(ptrs, types.ctypes.data, n, live, spn.ctypes.data,
                     splitters.shape[1], k, out.ctypes.data)
    return out


def _sorted_splitters(rng, ops, s: int, k: int):
    sp = _splitters(rng, ops, s) if s else [o[:0] for o in ops]
    return key_words([torch.from_numpy(x) for x in sp]) if s \
        else torch.zeros((k, 0), dtype=torch.int64)


@pytest.mark.parametrize("k,s", [(1, 0), (1, 5), (3, 9), (4, 255),
                                 (8, 31), (2, 4), (3, 128)])
def test_row_logic_matches_plain_sort_bucket(host_lib, k, s):
    """csrc/sort_bucket_row.cuh built by g++ and run row by row as the
    kernel runs it, against the plain version."""
    rng = np.random.RandomState(k * 1000 + s)
    n, live = 2500, 2400
    ops = _operands(rng, n, k)
    operands = [torch.from_numpy(o) for o in ops]
    splitters = _sorted_splitters(rng, ops, s, k)
    want = sort_bucket_reference(operands, splitters, live).numpy()
    out = _host_buckets(host_lib, ops, splitters, live)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("s", [0, 1, 255])
def test_row_logic_on_mixed_widths_matches_plain_sort_bucket(host_lib, k,
                                                             s):
    """The row logic with K = 1..5 operands of mixed widths (uint8 null
    ranks and keys of every width in turns), 0, 1 and 255 splitters, and
    padding rows past ``live``."""
    rng = np.random.RandomState(k * 31 + s)
    n, live = 1000 + 3 * k, 990
    ops = _operands(rng, n, k)
    operands = [torch.from_numpy(o) for o in ops]
    splitters = _sorted_splitters(rng, ops, s, k)
    want = sort_bucket_reference(operands, splitters, live).numpy()
    out = _host_buckets(host_lib, ops, splitters, live)
    np.testing.assert_array_equal(out, want)
