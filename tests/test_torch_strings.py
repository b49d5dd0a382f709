"""String transforms (slice 7a) of the port against the reference, on the
CPU.

* Each plain transform of ``exec/rect_transform.py`` (the torch version
  of the ``rect_transform`` kernel) against the reference's
  ``exprs/string_rect.py`` function on the same rectangles: bytes and
  lengths exactly, at widths 8/16/32, with empty, all-space and null rows,
  a replace that grows, a pad above the width and a substring past the
  end. A negative substring position, which the reference runs on its
  host engine only, is held to the per-value function.
* The kernel's group logic (``csrc/rect_transform_row.cuh``: the words
  and the exchanges between a row's lanes), built here with g++ and run
  row group by row group as the kernel's warps run it (junk past each
  row's length in the input and in the scratch), against the plain
  version: every chain of ``chip_smoke.RT_CHAINS`` at widths 8-64, rows
  with 0x00 bytes inside their length, row counts that cut a lane
  group's set of rows and a warp; the word functions byte by byte.
* Each transform's per-value host function (the dictionary path) against
  the reference's ``eval_host`` (pyarrow), non-ASCII entries included;
  where the reference departs from Spark (``upper('ß')``, ``lower('İ')``,
  a final sigma; SQL ``substr(s, -3)``) the port follows Spark, and a
  test of its own says so (ROADMAP.md Queue C).
* bench.py's strings rung (``upper(trim(s))``, ``substring(s, 3, 4)``,
  grouped by both) in batches of 1,000 rows: 4,000 rows of 50 values (a
  dictionary: the dense groupby) and 4,000 rows drawn from 40,000 values
  (about 3,800 distinct, above ``dict_limit(1000)``: both packages hold a
  byte rectangle, and the port's aggregate groups on bytes); with ORDER BY
  u; as SQL text; both mid-stream key-form orders; every newly lowered SQL
  function; a filter over a transformed string. Results go through
  tests/harness.py's comparator: floats exactly, except keyed sums
  through the port's dense groupby, which adds in another order (relative
  1e-12; ROADMAP.md Queue C, "Float sums add in another order").
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from harness import _assert_frames_equal, _canon
from spark_rapids_tpu import exprs as RE
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
from spark_rapids_tpu.exprs import string_rect as ref_rect
from spark_rapids_tpu.exprs.base import StrVal as RefStrVal
from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import (ByteRectColumn, ColumnarBatch,
                                             DictColumn, HostTable)
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.rect_transform import (
    chain_widths, pack_chain, rect_transform, rect_transform_reference)
from spark_rapids_tpu_torch.native import CSRC

from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False,
       "spark.rapids.tpu.sql.batchSizeRows": 1000}
CAP = 64


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _rect(seed: int, rows: int, width: int):
    """Rows over a small alphabet (literals match often), with edge
    spaces, empty, all-space and null rows: uint8[P, W], int32[P],
    bool[P] in numpy, zero past each length (the rectangle convention)."""
    b, ln, v = chip_smoke._rt_rect(np.random.RandomState(seed), rows, width,
                                   "cpu")
    return b.numpy(), ln.numpy(), v.numpy()


# ---------------------------------------------------------------------------
# the plain transforms against the reference's jnp ones
# ---------------------------------------------------------------------------

def _ref_op(op, sv, valid):
    """The reference's string_rect function for one of the port's ops."""
    name = op[0]
    if name == "upper":
        return ref_rect._upper(sv)
    if name == "lower":
        return ref_rect._lower(sv)
    if name == "reverse":
        return ref_rect._reverse(sv)
    if name == "trim":
        return ref_rect._trim(sv, op[1], op[2])
    if name == "substring":
        return ref_rect._substring(sv, op[1], op[2])
    if name == "replace":
        return ref_rect._replace(sv, op[1], op[2], CAP)
    if name == "pad":
        return ref_rect._pad(sv, valid, op[1], op[2], op[3])
    return ref_rect._substring_index(sv, op[1], op[2])


#: ops the reference has on its rectangles, with the edge cases
#: substring past the end, replace that grows, pad above W
REF_OPS = [
    ("upper",), ("lower",), ("reverse",), ("trim", True, True),
    ("trim", True, False), ("trim", False, True), ("substring", 3, 4),
    ("substring", 0, None), ("substring", 2, None), ("substring", 40, 3),
    ("substring", 1, 0), ("replace", b"ab", b"XYZW"),
    ("replace", b" ", b""), ("replace", b"aa", b"a"),
    ("pad", 12, b"*-", True), ("pad", 12, b"*-", False),
    ("pad", 40, b"xy", True), ("pad", 3, b"#", False),
    ("substring_index", b"a", 2), ("substring_index", b"ab", -1),
    ("substring_index", b" ", -3), ("substring_index", b"a", 0),
]


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("op", REF_OPS, ids=lambda o: "-".join(map(str, o)))
def test_plain_transform_equals_reference(op, width):
    b, ln, v = _rect(width + len(op), 97, width)
    # jitted: the reference's unrolled loops compile faster as one kernel
    # than as eager ops of one shape each
    want = RefStrVal(*jax.jit(lambda b, ln, v: tuple(
        _ref_op(op, RefStrVal(b, ln), v)))(jnp.asarray(b), jnp.asarray(ln),
                                           jnp.asarray(v)))
    got = rect_transform_reference(torch.from_numpy(b), torch.from_numpy(ln),
                                   torch.from_numpy(v), [op], CAP)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.bytes_))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.lengths))
    assert got[0].shape[1] == chain_widths([op], width, CAP)[-1]


@pytest.mark.parametrize("pos,length", [(-3, None), (-5, 3), (-40, 50),
                                        (-2, 0), (-1, 1)])
def test_negative_substring_equals_spark(pos, length):
    """The reference runs a negative position on its host engine; the
    port's rectangle path takes it, equal to the per-value function."""
    b, ln, v = _rect(7, 200, 16)
    got_b, got_ln = rect_transform_reference(
        torch.from_numpy(b), torch.from_numpy(ln), torch.from_numpy(v),
        [("substring", pos, length)], CAP)
    e = PE.Substring(PE.ColumnRef("s"), pos, length)
    for r in range(len(ln)):
        want = e.host_value(bytes(b[r, :ln[r]]).decode()) if v[r] else ""
        assert bytes(got_b[r, :got_ln[r]].numpy()).decode() == want
        assert not got_b[r, got_ln[r]:].any()


def test_initcap_equals_reference_host():
    """initcap over ASCII bytes equals the reference's host function."""
    b, ln, v = _rect(8, 300, 16)
    got_b, got_ln = rect_transform_reference(
        torch.from_numpy(b), torch.from_numpy(ln), torch.from_numpy(v),
        [("initcap",)], CAP)
    for r in range(len(ln)):
        want = RE.InitCap._initcap(bytes(b[r, :ln[r]]).decode()) \
            if v[r] else ""
        assert bytes(got_b[r, :got_ln[r]].numpy()).decode() == want


def test_chain_past_the_cap_is_refused():
    b, ln, v = (torch.from_numpy(x) for x in _rect(9, 10, 64))
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        rect_transform(b, ln, v, [("replace", b"a", b"bb")], CAP)
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        rect_transform(b, ln, v, [("pad", 65, b"x", True)], CAP)
    with pytest.raises(ValueError):
        rect_transform(b, ln, v, [("title",)], CAP)
    with pytest.raises(TypeError):
        rect_transform(b.to(torch.int32), ln, v, [("upper",)], CAP)
    before = rect_transform.launches
    rect_transform(b, ln, v, [("upper",)], CAP)
    assert rect_transform.launches == before        # no kernel on the CPU


# ---------------------------------------------------------------------------
# the kernel's group logic, built with g++
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <stdint.h>
#include <string.h>
#include "rect_transform_row.cuh"

// The kernel's work (rect_transform.cu) on the host: a row on G lanes of
// 16 bytes, rows taken in sets of 32 / G as a warp takes them (rows past
// the end run as empty invalid rows and store nothing), the G lanes of a
// row's group run together through RtHostEx, the input words read whole
// (bytes past a row's length as the rectangle holds them), the scratch
// starting as junk, as stale shared memory would. Returns false when
// two rows made different exchanges (on the card the groups of a warp
// exchange together).
template <int G, bool kMatch>
static bool rows_host(const RtChain& c, const uint8_t* bytes,
                      const int32_t* lengths, const uint8_t* validity,
                      int64_t rows, uint8_t* out, int32_t* out_len) {
  const int w_in = c.ops[0].w_in, w_out = c.ops[c.n_ops - 1].w_out;
  alignas(4) uint8_t reps[kRtMaxOps * kRtRepBytes];
  for (int i = 0; i < c.n_ops * kRtRepBytes; ++i) {
    const RtOp& op = c.ops[i / kRtRepBytes];
    reps[i] = op.code == RT_PAD ? rt_rep_byte(op, i % kRtRepBytes) : 0;
  }
  alignas(4) uint8_t scr[16 * G];
  memset(scr, 0xA5, sizeof scr);
  const RtHostEx<G> ex;
  int k[G];
  for (int l = 0; l < G; ++l) k[l] = l;
  const int per_set = 32 / G;
  long calls = -1;
  for (int64_t s = 0; s * per_set < rows; ++s) {
    for (int g = 0; g < per_set; ++g) {
      const int64_t row = s * per_set + g;
      uint32_t w[G][4] = {};
      int len = 0;
      bool valid = false;
      if (row < rows) {
        len = lengths[row];
        valid = validity[row] != 0;
        for (int q = 0; 4 * q < w_in; ++q)
          memcpy(&w[q / 4][q % 4], bytes + row * w_in + 4 * q, 4);
      }
      ex.calls = 0;
      const int n = rt_group_chain<G, kMatch>(c.ops, c.n_ops, ex, w, k, len,
                                              valid, scr, reps);
      if (calls >= 0 && ex.calls != calls) return false;
      calls = ex.calls;
      if (row < rows) {
        for (int q = 0; 4 * q < w_out; ++q)
          memcpy(out + row * w_out + 4 * q, &w[q / 4][q % 4], 4);
        out_len[row] = n;
      }
    }
  }
  return true;
}

extern "C" int rt_rows_host(const uint8_t* bytes, const int32_t* lengths,
                            const uint8_t* validity, int64_t rows,
                            const void* chain, uint8_t* out,
                            int32_t* out_len) {
  RtChain c;
  memcpy(&c, chain, sizeof c);
  int widest = 8;
  for (int i = 0; i < c.n_ops; ++i) {
    widest = c.ops[i].w_in > widest ? c.ops[i].w_in : widest;
    widest = c.ops[i].w_out > widest ? c.ops[i].w_out : widest;
  }
  const int lanes = widest > 16 ? widest / 16 : 1;
  // the kernel's two instances: chains with a literal match and without
#define RT_HOST(G) (rt_chain_matches(c)                                      \
    ? rows_host<G, true>(c, bytes, lengths, validity, rows, out, out_len)   \
    : rows_host<G, false>(c, bytes, lengths, validity, rows, out, out_len))
  const bool same = lanes == 1 ? RT_HOST(1) : lanes == 2 ? RT_HOST(2)
                                                         : RT_HOST(4);
#undef RT_HOST
  return same ? lanes : -1;  // -1: rows made different exchanges
}

extern "C" int rt_chain_bytes() { return (int)sizeof(RtChain); }

// The word functions on their own, for the byte-by-byte checks.
extern "C" uint32_t rt_word(int which, uint32_t x, uint32_t arg) {
  switch (which) {
    case 0: return rt_upper_word(x);
    case 1: return rt_lower_word(x);
    case 2: return rt_initcap_word(x, arg);
    case 3: return rt_eq_bytes(x, arg);
    default: return rt_funnel(x, arg, 1) ^ rt_perm(x, arg, 0x3210);
  }
}

extern "C" uint64_t rt_select(uint64_t m, int n) {
  return rt_select_nonoverlap(m, n);
}

extern "C" int rt_nth(uint64_t m, int count) { return rt_nth_match(m, count); }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("rect_transform_host")
    src = d / "rect_transform_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "librect_transform_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    lib.rt_rows_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] \
        + [ctypes.c_void_p] * 3
    lib.rt_rows_host.restype = ctypes.c_int
    lib.rt_chain_bytes.restype = ctypes.c_int
    lib.rt_word.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32]
    lib.rt_word.restype = ctypes.c_uint32
    lib.rt_select.argtypes = [ctypes.c_uint64, ctypes.c_int]
    lib.rt_select.restype = ctypes.c_uint64
    lib.rt_nth.argtypes = [ctypes.c_uint64, ctypes.c_int]
    lib.rt_nth.restype = ctypes.c_int
    return lib


def _host_rows(host_lib, b, ln, v, chain, widths):
    """The chain through the kernel's group logic on the host: (bytes,
    lengths, lanes a row; -1 when two rows made different exchanges)."""
    out = np.zeros((len(ln), widths[-1]), np.uint8)
    out_len = np.zeros(len(ln), np.int32)
    vv = v.astype(np.uint8)
    lanes = host_lib.rt_rows_host(
        b.ctypes.data, ln.ctypes.data, vv.ctypes.data, len(ln),
        pack_chain(chain, widths).ctypes.data, out.ctypes.data,
        out_len.ctypes.data)
    return out, out_len, lanes


#: row counts: one row, part of a lane group's set of rows at every width,
#: a warp's rows at W = 64 and W = 8 and past them
HOST_ROWS = (1, 3, 16, 31, 33, 301)


@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_row_logic_equals_plain_version(host_lib, width):
    """Every chain of chip_smoke.RT_CHAINS through the kernel's group
    logic (the words and the exchanges of csrc/rect_transform_row.cuh),
    at each row count of HOST_ROWS: rows with 0x00 bytes inside their
    length, and junk past every row's length in the input (the kernel
    masks it), held bit-identical to the plain version."""
    assert host_lib.rt_chain_bytes() == len(pack_chain([("upper",)],
                                                       [8, 8]))
    checked = 0
    for rows in HOST_ROWS:
        b, ln, v = _rect(100 + width + rows, rows, width)
        assert (b[np.arange(width)[None, :] < ln[:, None]] == 0).any() \
            or rows < 100
        junk = b.copy()
        past = np.arange(width)[None, :] >= ln[:, None]
        junk[past] = np.random.RandomState(rows).randint(
            0, 256, int(past.sum()))
        for chain in chip_smoke.RT_CHAINS:
            try:
                widths = chain_widths(chain, width, CAP)
            except NotImplementedError:
                continue
            want_b, want_ln = rect_transform_reference(
                torch.from_numpy(b), torch.from_numpy(ln),
                torch.from_numpy(v), chain, CAP)
            out, out_len, lanes = _host_rows(host_lib, junk, ln, v, chain,
                                             widths)
            # every row the same exchanges (the warp's lanes exchange
            # together), each on widest / 16 lanes (at least one)
            assert lanes == max(1, max(widths) // 16), (chain, rows, lanes)
            np.testing.assert_array_equal(out, want_b.numpy(),
                                          err_msg=f"{chain} {rows}")
            np.testing.assert_array_equal(out_len, want_ln.numpy(),
                                          err_msg=f"{chain} {rows}")
            checked += 1
    assert checked >= len(HOST_ROWS) * (len(chip_smoke.RT_CHAINS) - 4)


def _bytes_of(x: int) -> list:
    return [(x >> (8 * j)) & 0xFF for j in range(4)]


def _word(bs) -> int:
    return sum(int(c) << (8 * j) for j, c in enumerate(bs))


@pytest.mark.parametrize("which", ["upper", "lower", "initcap", "eq_space",
                                   "funnel_perm"])
def test_word_functions_hold_for_every_byte(host_lib, which):
    """The within-word maps against the byte loop, every byte value in
    every byte of a word (its neighbours random)."""
    rng = np.random.RandomState(3)
    up = lambda c: c - 32 if 97 <= c <= 122 else c
    low = lambda c: c + 32 if 65 <= c <= 90 else c
    for pos in range(4):
        for c in range(256):
            bs = list(rng.randint(0, 256, 4))
            bs[pos] = c
            x = _word(bs)
            carry = int(rng.randint(0, 2)) * 0x80
            if which == "upper":
                got = host_lib.rt_word(0, x, 0)
                want = _word([up(b) for b in bs])
            elif which == "lower":
                got = host_lib.rt_word(1, x, 0)
                want = _word([low(b) for b in bs])
            elif which == "initcap":
                got = host_lib.rt_word(2, x, carry)
                prev = [32 if carry else 0] + bs[:3]
                want = _word([up(b) if p == 32 else low(b)
                              for b, p in zip(bs, prev)])
            elif which == "eq_space":
                got = host_lib.rt_word(3, x, 32)
                want = _word([0x80 if b == 32 else 0 for b in bs])
            else:
                y = _word(list(rng.randint(0, 256, 4)))
                got = host_lib.rt_word(4, x, y)
                want = ((x | y << 32) >> 8) & 0xFFFFFFFF ^ x
            assert got == want, (which, pos, c, bs)


def test_match_mask_selection_and_count(host_lib):
    """The greedy non-overlapping choice (replace) and the n-th match from
    either end (substring_index) on 64-position masks, against loops."""
    rng = np.random.RandomState(4)
    for _ in range(2000):
        m = int(rng.randint(0, 1 << 32, dtype=np.uint64)) << 32 \
            | int(rng.randint(0, 1 << 32, dtype=np.uint64))
        m &= int(rng.randint(0, 1 << 32, dtype=np.uint64)) << 32 \
            | int(rng.randint(0, 1 << 32, dtype=np.uint64))
        n = int(rng.randint(1, 9))
        sel, free = 0, 0
        for p in range(64):
            if (m >> p) & 1 and p >= free:
                sel |= 1 << p
                free = p + n
        assert host_lib.rt_select(m, n) == sel
        starts = [p for p in range(64) if (m >> p) & 1]
        for count in (1, 2, 5, -1, -3, 70, -70, 0):
            if count == 0 or abs(count) > len(starts):
                want = -1
            else:
                want = starts[count - 1] if count > 0 else starts[count]
            assert host_lib.rt_nth(m, count) == want, (m, count)


# ---------------------------------------------------------------------------
# the per-value host functions (the dictionary path) against eval_host
# ---------------------------------------------------------------------------

ENTRIES = ["", " ", "  a b  ", "abc", "Hello wORLD", "é", "ı", "naïve café",
           "a.b.c.d", "x--y--z", "   lead", "trail   ", "\tTab\t",
           "日本語テキスト", "mIxEd CaSe wOrDs", "aaaa"]


def _host_cases():
    c = PE.ColumnRef("s")
    r = RE.ColumnRef("s")
    return [
        ("length", PE.Length(c), RE.Length(r)),
        ("upper", PE.Upper(c), RE.Upper(r)),
        ("lower", PE.Lower(c), RE.Lower(r)),
        ("trim", PE.StringTrim(c), RE.StringTrim(r)),
        ("ltrim", PE.StringTrimLeft(c), RE.StringTrimLeft(r)),
        ("rtrim", PE.StringTrimRight(c), RE.StringTrimRight(r)),
        ("reverse", PE.Reverse(c), RE.Reverse(r)),
        ("initcap", PE.InitCap(c), RE.InitCap(r)),
        ("substr_2_3", PE.Substring(c, 2, 3), RE.Substring(r, 2, 3)),
        ("substr_0", PE.Substring(c, 0), RE.Substring(r, 0)),
        ("substr_-3", PE.Substring(c, -3), RE.Substring(r, -3)),
        ("substr_-5_2", PE.Substring(c, -5, 2), RE.Substring(r, -5, 2)),
        ("substr_-2_5", PE.Substring(c, -2, 5), RE.Substring(r, -2, 5)),
        ("substr_3_0", PE.Substring(c, 3, 0), RE.Substring(r, 3, 0)),
        ("replace", PE.StringReplace(c, "a", "XY"),
         RE.StringReplace(r, "a", "XY")),
        ("replace_é", PE.StringReplace(c, "é", "e"),
         RE.StringReplace(r, "é", "e")),
        ("lpad", PE.Lpad(c, 6, "*"), RE.Lpad(r, 6, "*")),
        ("lpad_multi", PE.Lpad(c, 9, "ab"), RE.Lpad(r, 9, "ab")),
        ("rpad", PE.Rpad(c, 6, "é"), RE.Rpad(r, 6, "é")),
        ("rpad_multi", PE.Rpad(c, 2, "xyz"), RE.Rpad(r, 2, "xyz")),
        ("substring_index_2", PE.SubstringIndex(c, ".", 2),
         RE.SubstringIndex(r, ".", 2)),
        ("substring_index_-1", PE.SubstringIndex(c, "--", -1),
         RE.SubstringIndex(r, "--", -1)),
        ("substring_index_0", PE.SubstringIndex(c, ".", 0),
         RE.SubstringIndex(r, ".", 0)),
    ]


@pytest.mark.parametrize("name,port,ref", _host_cases(),
                         ids=[c[0] for c in _host_cases()])
def test_host_value_equals_reference(name, port, ref):
    batch = RefBatch.from_arrow_host(pa.table({"s": pa.array(ENTRIES)}))
    want = ref.eval_host(batch).to_pylist()
    got = [port.host_value(v) for v in ENTRIES]
    assert got == want
    assert port.key() == ref.key()
    assert port.dict_transform == getattr(ref, "dict_transform", False)


def test_case_mapping_follows_spark_where_the_reference_departs():
    """Spark's upper/lower are Java's full case mappings; the reference's
    pyarrow kernels map one code point to one (ROADMAP.md Queue C)."""
    vals = ["ß", "straße", "İ", "ΌΣΟΣ"]
    batch = RefBatch.from_arrow_host(pa.table({"s": pa.array(vals)}))
    up = PE.Upper(PE.ColumnRef("s"))
    low = PE.Lower(PE.ColumnRef("s"))
    assert [up.host_value(v) for v in vals] == ["SS", "STRASSE", "İ",
                                                "ΌΣΟΣ"]
    assert [low.host_value(v) for v in vals] == ["ß", "straße", "i̇",
                                                 "όσος"]
    assert RE.Upper(RE.ColumnRef("s")).eval_host(batch).to_pylist()[:2] \
        == ["ẞ", "STRAẞE"]
    assert RE.Lower(RE.ColumnRef("s")).eval_host(batch).to_pylist()[2:] \
        == ["i", "όσοσ"]
    # through a dictionary column on the port: entries re-encoded, merged
    # and re-sorted ("ß" and "SS" both upper-case to "SS")
    df = TorchSession(OFF, device="cpu").create_dataframe(
        {"s": np.array(["ß", "SS", "ss", "b"] * 10, dtype=object)})
    got = df.select(PF.upper(PF.col("s")).alias("u")).collect()
    assert [r["u"] for r in got] == ["SS", "SS", "SS", "B"] * 10


def _spark_substring_index(v: bytes, d: bytes, count: int) -> bytes:
    """Spark's ``UTF8String.subStringIndex`` line for line over bytes:
    each search starts one past the last match, so matches overlap."""
    if not d or count == 0:
        return b""

    def find(i):
        while i <= len(v) - len(d):
            if v[i:i + len(d)] == d:
                return i
            i += 1
        return -1

    def rfind(i):
        while i >= 0:
            if v[i:i + len(d)] == d:
                return i
            i -= 1
        return -1
    if count > 0:
        idx = -1
        for _ in range(count):
            idx = find(idx + 1)
            if idx < 0:
                return v
        return v[:idx]
    idx = len(v) - len(d) + 1
    for _ in range(-count):
        idx = rfind(idx - 1)
        if idx < 0:
            return v
    return v[idx + len(d):]


@pytest.mark.parametrize("delim,count", [(b"aa", 2), (b"aa", -2),
                                         (b"aa", 3), (b"aba", 2),
                                         (b"aba", -1), (b"aaa", -3)])
def test_substring_index_with_an_overlapping_delimiter_follows_spark(
        host_lib, delim, count):
    """Spark counts overlapping delimiters (``substring_index('aaa', 'aa',
    2)`` is ``'a'``); the reference splits without overlap and answers
    ``'aaa'`` (ROADMAP.md Queue C). The plain version, the kernel's row
    logic and the per-value function all follow Spark."""
    rng = np.random.RandomState(len(delim) * 10 + count)
    rows = [b"aaa", b"aaaa", b"abababa", b""] + [
        rng.choice(np.frombuffer(b"aab", np.uint8),
                   rng.randint(0, 17)).tobytes()
        for _ in range(200)]
    b = np.zeros((len(rows), 16), np.uint8)
    for r, v in enumerate(rows):
        b[r, :len(v)] = np.frombuffer(v, np.uint8)
    ln = np.array([len(v) for v in rows], np.int32)
    v = np.ones(len(rows), bool)
    want = [_spark_substring_index(x, delim, count) for x in rows]
    op = ("substring_index", delim, count)
    got_b, got_ln = rect_transform_reference(
        torch.from_numpy(b), torch.from_numpy(ln), torch.from_numpy(v),
        [op], CAP)
    assert [bytes(got_b[r, :got_ln[r]].numpy())
            for r in range(len(rows))] == want
    out, out_ln, _ = _host_rows(host_lib, b, ln, v, [op], [16, 16])
    assert [bytes(out[r, :out_ln[r]]) for r in range(len(rows))] == want
    port = PE.SubstringIndex(PE.ColumnRef("s"), delim.decode(), count)
    assert [port.host_value(x.decode()).encode() for x in rows] == want
    ref = RE.SubstringIndex(RE.ColumnRef("s"), "aa", 2).eval_host(
        RefBatch.from_arrow_host(pa.table({"s": pa.array(["aaa"])})))
    assert ref.to_pylist() == ["aaa"]          # the reference departs
    assert port.key() == RE.SubstringIndex(RE.ColumnRef("s"),
                                           delim.decode(), count).key()


# ---------------------------------------------------------------------------
# the strings rung, both packages
# ---------------------------------------------------------------------------

def _strings_table(n: int, card: int, seed: int = 13) -> pa.Table:
    """bench.py's gen_string_table (``s`` from ``card`` values, ``v``)."""
    rng = np.random.RandomState(seed)
    pool = np.asarray([f"  Item-{i:05d}-{'x' * (i % 7)}  "
                       for i in range(card)], dtype=object)
    return pa.table({"s": pa.array(pool[rng.randint(0, card, n)]),
                     "v": pa.array(rng.uniform(0, 10, n))})


def _both(query, table, conf=OFF, ordered=False, approx=False):
    port_s = TorchSession(conf, device="cpu")
    got = query(port_s.create_dataframe(table), PF)
    rows = got.collect_arrow().to_pandas()
    want = query(TpuSession(conf).create_dataframe(table), RF).to_pandas()
    _assert_frames_equal(_canon(rows, not ordered), _canon(want,
                                                           not ordered),
                         approx)
    return rows, port_s


def _aggregate(session) -> TpuHashAggregateExec:
    node = session.last_plan
    while not isinstance(node, TpuHashAggregateExec):
        node = node.children[0]
    return node


#: the two regimes: 50 values (a dictionary) and 40,000 (a rectangle)
REGIMES = {"dictionary": 50, "rectangle": 40_000}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_strings_rung_equals_reference(regime):
    t = _strings_table(4000, REGIMES[regime])
    first = ColumnarBatch.from_host(HostTable.from_arrow(t.slice(0, 1000)),
                                    "cpu", CAP).columns[0]
    ref_first = RefBatch.from_arrow(t.slice(0, 1000)).columns[0]
    if regime == "rectangle":
        assert isinstance(first, ByteRectColumn) and first.width == 32
        assert type(ref_first).__name__ == "ByteRectColumn"
    else:
        assert isinstance(first, DictColumn)
        assert type(ref_first).__name__ == "DictColumn"
    rows, s = _both(chip_smoke.q_strings, t,
                    approx=regime == "dictionary")
    agg = _aggregate(s)
    assert agg._rect_keys == ({0, 1} if regime == "rectangle" else set())
    assert len(rows) == (50 if regime == "dictionary" else
                         t.column("s").unique().__len__())
    want = chip_smoke.strings_numpy(chip_smoke.gen_strings(
        4000, REGIMES[regime]))
    assert sorted(rows["u"]) == [w["u"] for w in want]


@pytest.mark.parametrize("regime", list(REGIMES))
def test_strings_rung_order_by_u_equals_reference(regime):
    t = _strings_table(4000, REGIMES[regime])
    rows, _ = _both(chip_smoke.q_strings_sorted, t, ordered=True,
                    approx=regime == "dictionary")
    assert list(rows["u"]) == sorted(rows["u"])


@pytest.mark.parametrize("regime", list(REGIMES))
def test_strings_rung_sql_equals_reference(regime):
    t = _strings_table(4000, REGIMES[regime])
    port = TorchSession(OFF, device="cpu")
    ref = TpuSession(OFF)
    for s in (port, ref):
        s.create_dataframe(t).create_or_replace_temp_view("strs")
    got = port.sql(chip_smoke.STRINGS_SQL).collect_arrow().to_pandas()
    want = ref.sql(chip_smoke.STRINGS_SQL).to_pandas()
    _assert_frames_equal(_canon(got, False), _canon(want, False),
                         regime == "dictionary")
    sub = ("SELECT u, pre, sum(v) AS sv, count(*) AS n FROM (SELECT "
           "upper(trim(s)) AS u, substr(s, 3, 4) AS pre, v FROM strs) t "
           "GROUP BY u, pre ORDER BY u")
    got2 = port.sql(sub).collect_arrow().to_pandas()
    _assert_frames_equal(_canon(got2, False), _canon(got, False),
                         regime == "dictionary")


def _two_forms(first_card: int, later_card: int) -> pa.Table:
    """1,000 rows of one cardinality, then 3,000 of another."""
    a = _strings_table(1000, first_card, seed=3)
    b = _strings_table(3000, later_card, seed=4)
    return pa.concat_tables([a, b])


@pytest.mark.parametrize("order", ["dictionary_then_rectangle",
                                   "rectangle_then_dictionary"])
@pytest.mark.parametrize("key", ["column", "computed"])
def test_key_changes_form_mid_stream(order, key):
    """The key's first batch decides; a dictionary key meeting a
    rectangle it cannot take switches to bytes and rebuilds the partials
    made so far, and a rectangle key gathers later dictionary batches."""
    cards = (50, 40_000) if order.startswith("dictionary") else (40_000, 50)
    t = _two_forms(*cards)

    def q(df, F):
        k = F.col("s") if key == "column" else F.upper(F.trim(F.col("s")))
        return (df.select(k.alias("k"), F.col("v")).group_by("k")
                .agg(F.sum(F.col("v")).with_name("sv"),
                     F.count_star().with_name("n")))
    rows, s = _both(q, t, approx=True)
    assert _aggregate(s)._rect_keys == {0}
    assert rows["n"].sum() == 4000


@pytest.mark.parametrize("order,fail_at", [
    ("dictionary_then_rectangle", 1), ("dictionary_then_rectangle", 2),
    ("rectangle_then_dictionary", 1), ("rectangle_then_dictionary", 3)])
def test_oom_while_a_key_changes_form_is_retried(monkeypatch, order,
                                                  fail_at):
    """An OOM in the gather that brings a key to rect key mode is retried
    like the rest of the update: the rebuild of the three partials made
    before the switch (part way through when ``fail_at`` is 2), or a
    later dictionary batch's gather into a rectangle. The answer is the
    reference's and nothing leaks."""
    import spark_rapids_tpu_torch.exec.aggregate as agg_mod
    from spark_rapids_tpu_torch import mem as port_mem
    rng = np.random.RandomState(5)

    def part(lo: int, card: int, n: int) -> pa.Table:
        return pa.table({"s": pa.array([f"  Item-{i:05d}-  " for i in
                                         rng.randint(lo, lo + card, n)]),
                         "v": pa.array(rng.uniform(0, 10, n))})
    if order.startswith("dictionary"):
        # three batches of 400 values each, disjoint: the exec's
        # dictionary holds 1,200 when a 1,000-value batch comes
        parts = [part(400 * k, 400, 1000) for k in range(3)] \
            + [part(10_000, 40_000, 2000)]
    else:
        parts = [part(10_000, 40_000, 1000), part(0, 50, 4000)]
    t = pa.concat_tables(parts)
    real = agg_mod.dict_to_rect
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == fail_at:
            raise port_mem.RetryOOM("injected while gathering a key")
        return real(*a, **k)
    monkeypatch.setattr(agg_mod, "dict_to_rect", flaky)
    rows, s = _both(lambda df, F: df.group_by("s").agg(
        F.sum(F.col("v")).with_name("sv"),
        F.count_star().with_name("n")), t, approx=True)
    assert len(calls) > fail_at and s.last_retry_stats.retries == 1
    assert _aggregate(s)._rect_keys == {0} and not _aggregate(s)._stale
    assert rows["n"].sum() == 5000
    assert port_mem.MemoryManager.audit_all_leaks() == []


def test_short_rectangle_batch_still_joins_the_dictionary():
    """Fault C1 stays fixed: a short last batch of a low-cardinality
    column ingests as a rectangle and joins the dictionary."""
    vals = np.array([f"v{i % 7}" for i in range(1003)], dtype=object)
    vals[1000:] = ["v1", "v2", "v3"]
    t = pa.table({"s": pa.array(vals), "v": pa.array(np.arange(1003.0))})
    last = ColumnarBatch.from_host(HostTable.from_arrow(t.slice(1000)),
                                   "cpu", CAP).columns[0]
    assert isinstance(last, ByteRectColumn)
    rows, s = _both(lambda df, F: df.group_by("s").agg(
        F.count_star().with_name("n")), t)
    assert _aggregate(s)._rect_keys == set() and len(rows) == 7


#: every function the lowering now takes, over a rectangle table (width
#: 16) and a dictionary table
SQL_FNS = ["upper(s)", "ucase(s)", "lower(s)", "lcase(s)", "length(s)",
           "char_length(s)", "trim(s)", "ltrim(s)", "rtrim(s)",
           "reverse(s)", "initcap(s)", "substring(s, 2, 3)", "substr(s, 4)"]


@pytest.fixture(scope="module")
def sql_sessions():
    rng = np.random.RandomState(21)
    words = np.array([f"  w{i:04d}ab Cd " for i in range(600)], dtype=object)
    words[rng.rand(600) < 0.05] = None
    low = np.array(["  Ab c", "xY ", "", " z  "], dtype=object)[
        rng.randint(0, 4, 600)]
    t = pa.table({"s": pa.array(words), "d": pa.array(low)})
    out = []
    for s in (TorchSession(OFF, device="cpu"), TpuSession(OFF)):
        s.create_dataframe(t).create_or_replace_temp_view("t")
        out.append(s)
    return out


@pytest.mark.parametrize("fn", SQL_FNS)
def test_lowered_string_function_equals_reference(sql_sessions, fn):
    text = (f"SELECT {fn} AS x, {fn.replace('(s', '(d')} AS y FROM t")
    port, ref = sql_sessions
    got = port.sql(text).collect_arrow().to_pandas()
    want = ref.sql(text).to_pandas()
    _assert_frames_equal(_canon(got, False), _canon(want, False), False)


def test_sql_negative_substring_follows_spark(sql_sessions):
    """``substr(s, -3)``: the reference's lowering takes the minus sign
    for the position and fails (ROADMAP.md Queue C); the port lowers it
    as Spark does."""
    port, ref = sql_sessions
    got = port.sql("SELECT substr(s, -3) AS x, substring(d, -2, 1) AS y "
                   "FROM t").collect()
    vals = port.sql("SELECT s, d FROM t").collect()
    assert [r["x"] for r in got] == [None if r["s"] is None else r["s"][-3:]
                                     for r in vals]
    assert [r["y"] for r in got] == [r["d"][-2:][:1] for r in vals]
    with pytest.raises(TypeError):
        ref.sql("SELECT substr(s, -3) AS x FROM t").to_pandas()


def test_filter_over_a_transformed_string_equals_reference(sql_sessions):
    port, ref = sql_sessions
    text = ("SELECT upper(d) AS u, count(*) AS n FROM t WHERE "
            "d IS NOT NULL AND lower(d) LIKE '%y%' GROUP BY upper(d) "
            "ORDER BY u")
    got = port.sql(text).collect_arrow().to_pandas()
    want = ref.sql(text).to_pandas()
    _assert_frames_equal(_canon(got, False), _canon(want, False), False)
    text = "SELECT s FROM t WHERE upper(trim(s)) LIKE 'W00%'"
    got = port.sql(text).collect_arrow().to_pandas()
    want = ref.sql(text).to_pandas()
    _assert_frames_equal(_canon(got, True), _canon(want, True), False)


@pytest.mark.parametrize("fn", ["concat(s, d)", "s || d",
                                "parse_url(s, 'HOST')"])
def test_concat_and_parse_url_name_the_next_strings_slice(sql_sessions, fn):
    """``concat`` and ``||`` run since slice 7's string building (equal
    to the reference); ``parse_url`` names the rest of slice 7."""
    port, ref = sql_sessions
    if fn.startswith("parse_url"):
        with pytest.raises(NotImplementedError,
                           match="slice 7, strings, the rest"):
            port.sql(f"SELECT {fn} AS x FROM t").collect()
        return
    text = f"SELECT {fn} AS x FROM t"
    got = port.sql(text).collect_arrow().to_pandas()
    want = ref.sql(text).to_pandas()
    _assert_frames_equal(_canon(got, False), _canon(want, False), False)


def test_transform_chains_over_both_layouts_equal_reference():
    """Chains of several transforms, ending in a string, a length or a
    match, over a rectangle and a dictionary column in one projection;
    ``describe`` names the dictionary transforms as the reference's does.
    """
    rng = np.random.RandomState(5)
    hi = np.array([f" {i:05d}-ab-cd {'x' * (i % 3)}" for i in
                   rng.permutation(3000)], dtype=object)
    lo = np.array(["a-b", "c-d-e", "ab ", " f"], dtype=object)[
        rng.randint(0, 4, 3000)]
    t = pa.table({"hi": pa.array(hi), "lo": pa.array(lo)})

    def q(df, F):
        out = []
        for c in ("hi", "lo"):
            col = F.col(c)
            out += [
                F.substring_index(F.upper(col), "-", 2).alias(c + "_si"),
                F.lpad(F.rtrim(col), 12, "*").alias(c + "_pad"),
                F.reverse(F.replace(col, "-", "+=")).alias(c + "_rep"),
                F.length(F.ltrim(col)).alias(c + "_len"),
                F.initcap(F.lower(col)).alias(c + "_ic"),
                F.locate("B", F.upper(col)).alias(c + "_loc"),
                F.rpad(F.substring(col, 2, 4), 6, "-").alias(c + "_sub")]
        return df.select(*out)
    rows, s = _both(q, t, ordered=True)
    assert "dict_transform=" in s.last_plan.describe()


def test_non_ascii_rectangle_under_a_transform_is_refused():
    vals = np.array([f"é{i:05d}" for i in range(4000)], dtype=object)
    df = TorchSession(OFF, device="cpu").create_dataframe({"m": vals})
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        df.select(PF.upper(PF.col("m")).alias("u")).collect()


def test_over_wide_pad_over_a_rectangle_is_refused():
    """A pad target past the kernel's 64-byte rows is refused by the
    rectangle path at planning (``transform_op``), so a batch that
    arrives as a rectangle raises, naming the bound."""
    from spark_rapids_tpu_torch.exprs.string_rect import (chain_leaf,
                                                          rect_chain_leaf)
    from spark_rapids_tpu_torch.types import STRING, Schema, StructField
    schema = Schema([StructField("m", STRING, True)])
    for n, rect in ((64, "m"), (65, None), (100, None)):
        pad = PE.Rpad(PE.ColumnRef("m"), n, "-")
        assert rect_chain_leaf(pad, schema) == rect
        assert chain_leaf(pad, schema) == "m"
    vals = np.array([f"{i:05d}" for i in range(4000)], dtype=object)
    df = TorchSession(OFF, device="cpu").create_dataframe({"m": vals})
    with pytest.raises(NotImplementedError,
                       match="a pad past its 64-byte rows"):
        df.select(PF.rpad(PF.col("m"), 100, "-").alias("p")).collect()


def test_pack_words_orders_as_bytes_and_round_trips():
    from spark_rapids_tpu_torch.columnar.strrect import (pack_words,
                                                         unpack_words)
    b, ln, v = _rect(11, 500, 24 + 8)
    t = torch.from_numpy(b)
    w = pack_words(t)
    assert torch.equal(unpack_words(w), t)
    keys = [bytes(r) for r in b]
    assert sorted(range(500), key=lambda i: keys[i]) == sorted(
        range(500), key=lambda i: tuple(w[i].tolist()))
