"""The port's literal-match kernel against the reference's.

``rect_match_reference`` (the plain torch version of the CUDA kernel) and
the ``rect_match`` wrapper on CPU tensors must equal, exactly, both the
reference's Pallas kernel ``pallas_match`` (interpret mode on the CPU)
and its XLA rect ops (``string_rect._contains`` etc.). The kernel's own
per-row logic (``csrc/rect_match_row.cuh``) is compiled here by g++ into
a small host library and held to the same cases.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
#include "rect_match_row.cuh"
extern "C" void rect_match_host(const uint8_t* bytes, const int32_t* lengths,
                                int64_t rows, int width, const uint8_t* pat,
                                int L, int mode, int32_t* out) {
  for (int64_t r = 0; r < rows; ++r)
    out[r] = rect_match_row(bytes + r * width, width, lengths[r], pat, L,
                            mode);
}
"""


@pytest.fixture(scope="module")
def host_row_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("rect_match_host")
    src = d / "rect_match_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "librect_match_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).rect_match_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = None
    return fn


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
