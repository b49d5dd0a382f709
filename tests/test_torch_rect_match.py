"""The port's literal-match kernel against the reference's.

``rect_match_reference`` (the plain torch version of the CUDA kernel) and
the ``rect_match`` wrapper on CPU tensors must equal, exactly, both the
reference's Pallas kernel ``pallas_match`` (interpret mode on the CPU)
and its XLA rect ops (``string_rect._contains`` etc.). The kernel's own
arithmetic (``csrc/rect_match_row.cuh``: the chunk predicates, the SWAR
first-byte test, the window read across words) is compiled here by g++
into a small host library that runs the kernel's tile loop, and is held
to the plain version over whole tiles, with every byte the predicates
skip set to junk.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from spark_rapids_tpu.exprs import string_rect as ref_rect
from spark_rapids_tpu.exprs.base import StrVal
from spark_rapids_tpu.exprs.pallas_rect import pallas_match
from spark_rapids_tpu_torch.exprs.rect_match import (MODES, rect_match,
                                                     rect_match_reference)

CSRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc"

#: per width, the patterns: empty, short, L == W, L > W
PATTERNS = {
    8: [b"", b"ab", b"abcabcab", b"abcabcabc"],
    16: [b"", b"bca", b"a" * 16, b"c" * 17],
    64: [b"", b"ab", b"ab" * 32, b"a" * 65],
}
ROWS = 1000          # not a multiple of the reference's 256-row blocks


def _case(width: int, pattern: bytes, seed: int):
    """Rows over a three-letter alphabet (so short patterns match often),
    zero past each length, some of length 0 and some ending with the
    pattern exactly at the row end."""
    rng = np.random.RandomState(seed)
    rect = rng.choice(np.frombuffer(b"abc", np.uint8), (ROWS, width))
    lens = rng.randint(0, width + 1, ROWS).astype(np.int32)
    lens[::17] = 0
    L = len(pattern)
    if 0 < L <= width:
        end = np.flatnonzero(lens >= L)[::5]
        for r in end:
            rect[r, lens[r] - L:lens[r]] = np.frombuffer(pattern, np.uint8)
        lens[3::29] = L
        rect[3::29, :L] = np.frombuffer(pattern, np.uint8)
    rect[np.arange(width)[None, :] >= lens[:, None]] = 0
    return rect, lens


_XLA = {"contains": ref_rect._contains, "startswith": ref_rect._startswith,
        "endswith": ref_rect._endswith, "equals": ref_rect._equals,
        "locate": ref_rect._locate}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("width", sorted(PATTERNS))
def test_plain_version_equals_pallas_and_xla_ops(width, mode):
    for k, pat in enumerate(PATTERNS[width]):
        rect, lens = _case(width, pat, seed=width * 10 + k)
        port = rect_match_reference(torch.from_numpy(rect),
                                    torch.from_numpy(lens), pat, mode)
        pallas = np.asarray(pallas_match(jnp.asarray(rect),
                                         jnp.asarray(lens), pat, mode))
        xla = np.asarray(_XLA[mode](StrVal(jnp.asarray(rect),
                                           jnp.asarray(lens)), pat))
        want_dt = np.int32 if mode == "locate" else np.bool_
        assert pallas.dtype == want_dt and port.numpy().dtype == want_dt
        np.testing.assert_array_equal(port.numpy(), pallas,
                                      err_msg=f"{mode} {pat!r} vs pallas")
        np.testing.assert_array_equal(port.numpy(), xla.astype(want_dt),
                                      err_msg=f"{mode} {pat!r} vs xla")


def test_wrapper_on_cpu_runs_the_plain_version():
    rect, lens = _case(64, b"ab", seed=3)
    before = rect_match.launches
    for mode in MODES:
        got = rect_match(torch.from_numpy(rect), torch.from_numpy(lens),
                         b"ab", mode)
        want = rect_match_reference(torch.from_numpy(rect),
                                    torch.from_numpy(lens), b"ab", mode)
        assert torch.equal(got, want)
    assert rect_match.launches == before       # no kernel ran
    with pytest.raises(ValueError):
        rect_match(torch.from_numpy(rect), torch.from_numpy(lens), b"a",
                   "regex")
    with pytest.raises(TypeError):
        rect_match(torch.from_numpy(rect).to(torch.int32),
                   torch.from_numpy(lens), b"a", "contains")


_HOST_SRC = r"""
#include <stdint.h>
#include <string.h>
#include <vector>
#include "rect_match_row.cuh"

// The kernel's tile loop (rect_match.cu, rect_match_tiles) one tile at a
// time: the chunks that the predicates ask for are copied into an image
// that starts out as junk (the pattern repeated when junk < 0, else the
// byte `junk`), then each row is scanned from the image by its Q threads
// in turn and their answers merged. The layout is chosen as the launcher
// chooses it, from the base address and width.
extern "C" void rect_match_tiles_host(const uint8_t* bytes,
                                      const int32_t* lengths, int64_t rows,
                                      int width, const uint8_t* pat, int L,
                                      int mode, int junk, int32_t* out) {
  const bool padded = (reinterpret_cast<uintptr_t>(bytes) % 16) == 0 &&
                      width >= 8 && width <= 1024 &&
                      (width & (width - 1)) == 0;
  const int T = padded ? rect_tile_rows(width) : rect_raw_rows(width);
  const int image = padded ? T * rect_row_stride(width)
                           : (15 + T * width + 15) / 16 * 16;
  std::vector<uint32_t> img((image + kRectStageSlack) / 4);
  std::vector<uint32_t> pw((L > 0 ? L : 0) / 4 + 2, 0u);
  if (L <= width && L > 0) memcpy(pw.data(), pat, L);
  uint8_t* im = reinterpret_cast<uint8_t*>(img.data());
  for (int64_t t0 = 0; t0 < rows; t0 += T) {
    const int n = rows - t0 < T ? static_cast<int>(rows - t0) : T;
    const uint8_t* src0 = bytes + t0 * width;
    const int32_t* tl = lengths + t0;
    for (size_t k = 0; k < img.size() * 4; ++k) {
      im[k] = junk >= 0 ? static_cast<uint8_t>(junk)
                        : (L > 0 ? pat[k % L] : 0xA5);
    }
    int src, dst;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src0) & 15);
    if (padded) {
      const int cb = rect_chunk_bytes(width);
      for (int r = 0; r < n; ++r) {
        int c0, c1;
        rect_row_chunks(tl[r], width, L, mode, cb, &c0, &c1);
        for (int c = c0; c < c1; ++c) {
          memcpy(im + r * rect_row_stride(width) + c * cb,
                 src0 + r * width + c * cb, cb);
        }
      }
    } else {
      for (int i = 0; i < (mis + n * width + 15) / 16; ++i) {
        if (rect_raw_chunk(i, width, n, mis, tl, L, mode, &src, &dst)) {
          memcpy(im + dst, src0 + src, 16);
        }
      }
    }
    const int Q = padded ? rect_row_threads(width) : 1;
    for (int r = 0; r < n; ++r) {
      const int off = padded ? r * rect_row_stride(width) : mis + r * width;
      int32_t v = 0;
      for (int q = 0; q < Q; ++q) {
        v = rect_merge_rows(
            v, padded && width == 8
                   ? rect_match_loaded<1, 2>(img.data(), off, width, tl[r],
                                             pw.data(), pw[0], L, mode, q, Q)
                   : rect_match_loaded<1, 4>(img.data(), off, width, tl[r],
                                             pw.data(), pw[0], L, mode, q,
                                             Q));
      }
      out[t0 + r] = v;
    }
  }
}

extern "C" void rect_match_host(const uint8_t* bytes, const int32_t* lengths,
                                int64_t rows, int width, const uint8_t* pat,
                                int L, int mode, int32_t* out) {
  rect_match_tiles_host(bytes, lengths, rows, width, pat, L, mode, -1, out);
}

extern "C" uint32_t rect_eq_hi4_host(uint32_t x, uint32_t b4) {
  return rect_eq_hi4(x, b4);
}

extern "C" int rect_chunk_needed_host(int start, int size, int32_t len,
                                      int width, int L, int mode) {
  int lo, hi;
  rect_row_window(len, width, L, mode, &lo, &hi);
  return rect_chunk_needed(start, size, lo, hi);
}

// 1 when chunk c lies in the row's chunk range (rect_row_chunks)
extern "C" int rect_row_chunks_host(int c, int size, int32_t len, int width,
                                    int L, int mode) {
  int c0, c1;
  rect_row_chunks(len, width, L, mode, size, &c0, &c1);
  return c0 <= c && c < c1;
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's ops here are small: with one intra-op thread
    they stay fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("rect_match_host")
    src = d / "rect_match_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "librect_match_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.rect_match_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rect_match_host.restype = None
    lib.rect_match_tiles_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.rect_match_tiles_host.restype = None
    lib.rect_eq_hi4_host.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.rect_eq_hi4_host.restype = ctypes.c_uint32
    lib.rect_chunk_needed_host.argtypes = [ctypes.c_int] * 6
    lib.rect_chunk_needed_host.restype = ctypes.c_int
    lib.rect_row_chunks_host.argtypes = [ctypes.c_int] * 6
    lib.rect_row_chunks_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_row_lib(host_lib):
    return host_lib.rect_match_host


@pytest.mark.parametrize("width", sorted(PATTERNS) + [128])
def test_kernel_row_logic_built_by_gxx(host_row_lib, width):
    pats = PATTERNS.get(width, [b"", b"abc", b"a" * 128, b"b" * 129])
    for k, pat in enumerate(pats):
        rect, lens = _case(width, pat, seed=width + k)
        pbuf = np.frombuffer(pat, np.uint8).copy() if pat else \
            np.zeros(1, np.uint8)
        for mode, code in MODES.items():
            out = np.zeros(ROWS, np.int32)
            host_row_lib(rect.ctypes.data, lens.ctypes.data, ROWS, width,
                         pbuf.ctypes.data, len(pat), code, out.ctypes.data)
            want = rect_match_reference(torch.from_numpy(rect),
                                        torch.from_numpy(lens), pat, mode)
            np.testing.assert_array_equal(
                out, want.numpy().astype(np.int32),
                err_msg=f"W={width} {mode} {pat!r}")


TILE_WIDTHS = [8, 16, 32, 64, 128, 256, 512, 1024]


def _tile_lengths(width: int) -> list:
    """Pattern lengths for a width: every L from 1 to W up to W = 64, then
    the chunk edges, W/2, W - 1 and W; with the empty pattern and L > W."""
    if width <= 64:
        ls = list(range(1, width + 1))
    else:
        ls = [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
              width // 2, width - 1, width]
    return [0] + ls + [width + 1]


def _tile_case(width: int, pattern: bytes, seed: int, rows: int = 600):
    """Rows over a three-letter alphabet with lengths at the chunk edges
    (8k - 1, 8k, 8k + 1) half the time, and the pattern planted across
    every 16-byte chunk boundary (ending at the row's length or inside
    it), at 0 and at W - L, and as the whole row."""
    rng = np.random.RandomState(seed)
    rect = rng.choice(np.frombuffer(b"abc", np.uint8), (rows, width))
    edges = sorted({e + d for e in range(0, width + 1, 8) for d in (-1, 0, 1)
                    if 0 <= e + d <= width})
    lens = np.where(rng.rand(rows) < 0.5, rng.choice(edges, rows),
                    rng.randint(0, width + 1, rows)).astype(np.int32)
    L = len(pattern)
    if 0 < L <= width:
        p = np.frombuffer(pattern, np.uint8)
        starts = [b - j for b in range(16, width, 16)
                  for j in range(1, min(L, 16))] + [0, width - L]
        starts = [s for s in starts if 0 <= s <= width - L]
        for k, r in enumerate(range(0, rows, 3)):
            s = starts[k % len(starts)]
            rect[r, s:s + L] = p
            lens[r] = s + L if k % 2 else max(lens[r], s + L)
        lens[1::7] = L
        rect[1::7, :L] = p
    rect[np.arange(width)[None, :] >= lens[:, None]] = 0
    return rect, lens


def _at_offset(a: np.ndarray, mis: int) -> np.ndarray:
    """A copy of ``a`` whose first byte lies ``mis`` bytes past a 16-byte
    boundary, with 16 bytes of slack on each side (the raw layout reads
    the aligned chunks around the rows)."""
    buf = np.zeros(a.nbytes + 64, np.uint8)
    start = 16 + (mis - buf.ctypes.data) % 16
    out = buf[start:start + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def _tiles_host(lib, rect, lens, pat, mode, junk=-1):
    out = np.zeros(len(lens), np.int32)
    pbuf = np.frombuffer(pat, np.uint8).copy() if pat else \
        np.zeros(1, np.uint8)
    lib.rect_match_tiles_host(rect.ctypes.data, lens.ctypes.data, len(lens),
                              rect.shape[1], pbuf.ctypes.data, len(pat),
                              MODES[mode], junk, out.ctypes.data)
    return out


@pytest.mark.parametrize("mis", [0, 3])
@pytest.mark.parametrize("width", TILE_WIDTHS)
def test_kernel_tile_logic_built_by_gxx(host_lib, width, mis):
    """The kernel's chunk predicates and scan over whole tiles (the padded
    layout at an aligned base, the raw one at base + 3), with every byte
    the predicates skip set to the pattern repeated, equal to the plain
    version in every mode."""
    rng = np.random.RandomState(width + mis)
    for k, L in enumerate(_tile_lengths(width)):
        pat = bytes(rng.choice(np.frombuffer(b"abc", np.uint8), L))
        rect, lens = _tile_case(width, pat, seed=width * 1000 + k,
                                rows=300 if width >= 256 else 600)
        want = {m: rect_match_reference(torch.from_numpy(rect),
                                        torch.from_numpy(lens), pat, m)
                for m in MODES}
        rect_m, lens_m = _at_offset(rect, mis), _at_offset(lens, 0)
        for mode in MODES:
            np.testing.assert_array_equal(
                _tiles_host(host_lib, rect_m, lens_m, pat, mode),
                want[mode].numpy().astype(np.int32),
                err_msg=f"W={width} mis={mis} {mode} L={L}")


@pytest.mark.parametrize("width", [12, 24, 100, 2048])
def test_kernel_raw_layout_other_widths(host_lib, width):
    """Widths that are not a power of two from 8 to 1024 take the raw
    layout, where one 16-byte chunk may span several rows."""
    for k, pat in enumerate([b"", b"a", b"abc", b"b" * (width // 2),
                             b"c" * width, b"a" * (width + 1)]):
        rect, lens = _tile_case(width, pat, seed=width + k, rows=200)
        for mode in MODES:
            want = rect_match_reference(torch.from_numpy(rect),
                                        torch.from_numpy(lens), pat, mode)
            for junk in (-1, 0):
                np.testing.assert_array_equal(
                    _tiles_host(host_lib, _at_offset(rect, 5),
                                _at_offset(lens, 0), pat, mode, junk),
                    want.numpy().astype(np.int32),
                    err_msg=f"W={width} {mode} {pat[:4]!r} junk={junk}")


def test_swar_byte_test_misses_no_byte(host_lib):
    """rect_eq_hi4 against a byte-by-byte compare: it marks every byte
    equal to the tested one, and any other mark sits on a byte that is the
    tested one ^ 1 above a true mark (the borrow), which the scan's full
    compare then rejects. Words are made to hold the byte often, next to
    zero bytes and next to its ^ 1."""
    rng = np.random.RandomState(11)
    words = rng.randint(0, 1 << 32, 4000, dtype=np.uint64)
    for b in (0, 1, 0x20, 0x73, 0x7F, 0x80, 0xFE, 0xFF):
        for x in words.tolist():
            for k in range(4):
                u = rng.rand()
                put = b if u < 0.4 else (b ^ 1 if u < 0.6 else
                                         (0 if u < 0.7 else None))
                if put is not None:
                    x = (x & ~(0xFF << 8 * k)) | (put << 8 * k)
            byte = [(x >> 8 * k) & 0xFF for k in range(4)]
            got = host_lib.rect_eq_hi4_host(x, b * 0x01010101)
            assert got & ~0x80808080 == 0
            for k in range(4):
                marked = bool(got >> (8 * k + 7) & 1)
                if byte[k] == b:
                    assert marked, (hex(x), b, k)
                elif marked:
                    assert byte[k] == b ^ 1 and any(
                        byte[j] == b for j in range(k)), (hex(x), b, k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunk_predicate_covers_exactly_the_window(host_lib, mode):
    """A chunk is requested exactly when it overlaps the bytes the mode
    reads: the length for contains/locate, [0, L) for startswith and
    equals (when the length test holds), [len - L, len) for endswith. The
    padded layout's per-row chunk range (rect_row_chunks) is that set."""
    W = 64
    for L in (0, 1, 7, 16, 17, 64, 65):
        for ln in range(0, W + 1):
            if L == 0 or L > W:
                lo = hi = 0
            elif mode in ("contains", "locate"):
                lo, hi = 0, ln if ln >= L else 0
            elif mode == "startswith":
                lo, hi = 0, L if ln >= L else 0
            elif mode == "equals":
                lo, hi = 0, L if ln == L else 0
            else:
                lo, hi = (ln - L, ln) if ln >= L else (0, 0)
            for start in range(-15, W, 8):
                for size in (8, 16):
                    want = lo < hi and start < hi and start + size > lo
                    got = host_lib.rect_chunk_needed_host(
                        start, size, ln, W, L, MODES[mode])
                    assert got == want, (mode, L, ln, start, size)
                    if start >= 0 and start % size == 0:
                        assert host_lib.rect_row_chunks_host(
                            start // size, size, ln, W, L,
                            MODES[mode]) == want, (mode, L, ln, start)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(width=st.sampled_from(TILE_WIDTHS + [40]), mis=st.integers(0, 15),
       seed=st.integers(0, 2 ** 31 - 1), data=st.data())
def test_kernel_tile_logic_random(host_lib, width, mis, seed, data):
    """Random rows, lengths, bases and patterns (cut from the rows, so
    they match often) through the tile loop, against the plain version."""
    rng = np.random.RandomState(seed)
    rows = data.draw(st.integers(1, 700))
    alpha = np.frombuffer(b"ab", np.uint8)
    rect = rng.choice(alpha, (rows, width))
    lens = rng.randint(0, width + 1, rows).astype(np.int32)
    rect[np.arange(width)[None, :] >= lens[:, None]] = 0
    L = data.draw(st.integers(0, min(width, 40)))
    r = int(rng.randint(rows))
    s = int(rng.randint(0, width - L + 1))
    pat = bytes(rect[r, s:s + L]) if rng.rand() < 0.7 else \
        bytes(rng.choice(alpha, L))
    junk = data.draw(st.sampled_from([-1, 0, 0x61]))
    for mode in MODES:
        want = rect_match_reference(torch.from_numpy(rect),
                                    torch.from_numpy(lens), pat, mode)
        np.testing.assert_array_equal(
            _tiles_host(host_lib, _at_offset(rect, mis), _at_offset(lens, 0),
                        pat, mode, junk),
            want.numpy().astype(np.int32), err_msg=f"{mode} {pat!r}")
