"""The ``rect_dfa`` kernel's two instances on the CPU.

* Each instance's row logic (``csrc/rect_dfa_row.cuh``: the byte-indexed
  and the class-indexed step, whole chunks without tests, loads ahead),
  built with g++ and run as the kernel's threads run it (``rd_thread``,
  rows a made-up grid apart, the shared table as the block's prologue
  leaves it), equals the plain version over both pattern corpora of
  ``test_torch_regex.py`` at widths 8 to 128: junk past every length,
  NULL rows, lengths past the width, rows whose lengths sit on the chunk
  boundaries, and rows that enter a sink on a chunk's first or last byte.
* The DFAs at the instances' boundary (66, 130 and 192 states, Q16's 19)
  and the host's rule that picks the instance.
* The byte-indexed table is ``table[s, classes[b]]`` for every state and
  byte.
* Fault C4: the wrappers hand the kernels a row-major, 16-byte aligned
  copy of a rectangle that is dense but not row-major.
"""
import ctypes
import re
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.columnar import strrect
from spark_rapids_tpu_torch.exec import rect_dfa as RDK
from spark_rapids_tpu_torch.exec import rect_transform as RT
from spark_rapids_tpu_torch.exprs import regex_dfa as RD
from spark_rapids_tpu_torch.native import CSRC

from test_torch_regex import ALPHA, LIKE_PATTERNS, RLIKE_PATTERNS

#: the DFAs at the instances' boundary: 66 and 130 states (no sink), Q16's
#: 19, and 192 states (past BYTE_STATES: the class-indexed instance)
BOUNDARY = [("rlike", "a(a|b){5}$", 66), ("rlike", "a(a|b){6}$", 130),
            ("like", "%Customer%Complaints%", 19),
            ("rlike", "a(a|b){6}c|d(a|b){5}e", 192)]

#: lengths on and around the chunk and group boundaries
EDGE_LENGTHS = [0, 1, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64, 65, 127,
                128, -3]

INSTANCES = {"byte": 1, "class": 0}


def _compile(kind: str, pattern: str) -> RD.Dfa:
    return (RD.compile_rlike(pattern) if kind == "rlike"
            else RD.compile_like(pattern))


_HOST_SRC = r"""
#include <stdint.h>
#include <string.h>
#include <vector>
#include "rect_dfa_row.cuh"

// The kernel's work (rect_dfa.cu) on the host: the instance's shared
// table as a block's prologue leaves it (the byte-indexed one made from
// the classes and the table, states kRdNextStride bytes apart), then the
// rows of each of `threads` threads, `threads` apart, through rd_thread:
// a chunk loaded whole from the rectangle (bytes past a row's length as it
// holds them; 8 bytes for an 8-byte row) where 16 (4i + c) < n, as
// rd_load loads it.
extern "C" void rd_kernel_host(int by_byte, const uint8_t* bytes,
                               const int32_t* lengths,
                               const uint8_t* validity, int64_t rows,
                               int width, const uint8_t* classes,
                               const uint8_t* table, const uint8_t* accept,
                               int n_states, int n_classes, int start,
                               int first_sink, int threads, uint8_t* out) {
  std::vector<uint8_t> next(by_byte ? n_states * kRdNextStride : 0, 0xee);
  for (int s = 0; by_byte && s < n_states; ++s)
    for (int b = 0; b < 256; ++b)
      next[s * kRdNextStride + b] = table[s * n_classes + classes[b]];
  auto span = [&](uint32_t r) {
    return r < (uint32_t)rows ? rd_span(lengths[r], validity[r] != 0, width)
                              : -1;
  };
  auto valid = [&](uint32_t r) {
    return r < (uint32_t)rows && validity[r] != 0;
  };
  auto load = [&](uint32_t r, int n, int i, uint32_t(&g)[kRdGroup][4]) {
    for (int c = 0; c < kRdGroup; ++c)
      if (16 * (kRdGroup * i + c) < n)
        memcpy(g[c], bytes + (int64_t)r * width + 16 * (kRdGroup * i + c),
               width >= 16 ? 16 : 8);
  };
  auto store = [&](uint32_t r, bool hit) { out[r] = hit; };
  const RdByteStep byte_step{next.data()};
  const RdClassStep class_step{classes, table, n_classes};
  for (int t = 0; t < threads; ++t) {
    if (by_byte)
      rd_thread(byte_step, accept, start, first_sink, width, t, threads,
                rows, span, valid, load, store);
    else
      rd_thread(class_step, accept, start, first_sink, width, t, threads,
                rows, span, valid, load, store);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("rect_dfa_kernel_host")
    src = d / "rect_dfa_kernel_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "librect_dfa_kernel_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    lib.rd_kernel_host.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rd_kernel_host.restype = None
    return lib


def _run(lib, instance, rect, lens, valid, dfa, threads) -> np.ndarray:
    tabs = [np.ascontiguousarray(a, dtype=np.uint8)
            for a in (dfa.classes, dfa.table, dfa.accept)]
    out = np.full(len(lens), 7, np.uint8)
    lib.rd_kernel_host(INSTANCES[instance], rect.ctypes.data,
                       lens.ctypes.data, valid.astype(np.uint8).ctypes.data,
                       len(lens), rect.shape[1],
                       *(a.ctypes.data for a in tabs), dfa.n_states,
                       dfa.n_classes, dfa.start, dfa.first_sink, threads,
                       out.ctypes.data)
    assert set(np.unique(out)) <= {0, 1}, "a row was not written"
    return out.astype(bool)


def _plain(rect, lens, valid, dfa) -> np.ndarray:
    return RDK.rect_dfa_reference(torch.from_numpy(rect),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(valid), dfa).numpy()


def _junk_rows(rng, rows: int, width: int, alphabet: bytes):
    """Bytes of ``alphabet`` over the whole width (junk past each
    length), lengths from -3 to past the width with EDGE_LENGTHS first,
    a tenth NULL."""
    alpha = np.frombuffer(alphabet, np.uint8)
    rect = alpha[rng.randint(0, len(alpha), (rows, width))]
    lens = rng.randint(-3, width + 20, rows).astype(np.int32)
    lens[:len(EDGE_LENGTHS)] = EDGE_LENGTHS
    valid = rng.rand(rows) >= 0.1
    valid[:len(EDGE_LENGTHS)] = True
    return rect, lens, valid


@pytest.mark.parametrize("instance", sorted(INSTANCES))
@pytest.mark.parametrize("width", [8, 16, 32, 64, 128])
def test_instance_row_logic_equals_plain_version(host_lib, width, instance):
    """Every pattern of both corpora through the instance's row logic, as
    the kernel's threads walk it (1, 7 and 64 threads), held to the plain
    version."""
    rng = np.random.RandomState(100 + width)
    rect, lens, valid = _junk_rows(rng, 263, width, ALPHA.encode())
    for kind, pats in (("rlike", RLIKE_PATTERNS), ("like", LIKE_PATTERNS)):
        for pat in pats:
            dfa = _compile(kind, pat)
            want = _plain(rect, lens, valid, dfa)
            for threads in (1, 7, 64):
                got = _run(host_lib, instance, rect, lens, valid, dfa,
                           threads)
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{kind} {pat!r}, {threads} threads")


@pytest.mark.parametrize("instance", sorted(INSTANCES))
@pytest.mark.parametrize("width", [16, 64, 128])
@pytest.mark.parametrize("kind,pattern", [("like", "%q%"), ("rlike", "q"),
                                          ("rlike", "^[a-p]*$"),
                                          ("like", "%q_")])
def test_sink_entered_on_a_chunk_edge(host_lib, width, instance, kind,
                                      pattern):
    """A 'q' (into an accepting or the dead sink) at a chunk's first and
    last byte, as the row's last byte, just past its length (junk), and
    inside it."""
    dfa = _compile(kind, pattern)
    if pattern != "%q_":
        assert dfa.first_sink < dfa.n_states
    at = [k for k in (0, 1, 14, 15, 16, 17, 31, 32, 47, 48, 63, 64, 65, 79,
                      80, 127) if k < width]
    rows = []
    for k in at:
        for extra in (-1, 0, 1, 20):
            rows.append((k, max(0, min(width, k + 1 + extra))))
    rng = np.random.RandomState(width)
    rect = np.frombuffer(b"abcdefghijklmnop", np.uint8)[
        rng.randint(0, 16, (len(rows), width))].copy()
    lens = np.zeros(len(rows), np.int32)
    for i, (k, n) in enumerate(rows):
        rect[i, k] = ord("q")
        lens[i] = n
    valid = np.ones(len(rows), bool)
    want = _plain(rect, lens, valid, dfa)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(
        _run(host_lib, instance, rect, lens, valid, dfa, 5), want)


@pytest.mark.parametrize("kind,pattern,states", BOUNDARY)
def test_boundary_dfas_and_the_instance_rule(host_lib, kind, pattern,
                                             states):
    """66 and 130 states and Q16's 19 run on the byte-indexed instance,
    192 on the class-indexed one; either instance gives the plain
    version's answer on each."""
    dfa = _compile(kind, pattern)
    assert dfa.n_states == states
    want_instance = "byte" if states <= 168 else "class"
    assert RDK.instance(dfa) == want_instance
    shared = RDK.shared_bytes(dfa)
    assert shared <= 48 * 1024
    if want_instance == "byte":
        assert shared == 512 + states * RDK.NEXT_STRIDE
    else:
        assert shared == 512 + states * dfa.n_classes
    rng = np.random.RandomState(states)
    for width in (16, 64, 128):
        rect, lens, valid = _junk_rows(rng, 301, width, b"ababababcdeCuso")
        want = _plain(rect, lens, valid, dfa)
        for instance in INSTANCES:
            np.testing.assert_array_equal(
                _run(host_lib, instance, rect, lens, valid, dfa, 9), want,
                err_msg=f"{instance} at width {width}")


def test_rule_and_strides_match_the_kernel_source():
    """The wrapper's BYTE_STATES and NEXT_STRIDE are the header's, and the
    byte-indexed table of BYTE_STATES states fits a block's 48 KB."""
    hdr = (CSRC / "rect_dfa_row.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kRd\w+) = (\d+);", hdr))
    assert int(consts["kRdByteStates"]) == RDK.BYTE_STATES
    assert int(consts["kRdNextStride"]) == RDK.NEXT_STRIDE
    assert int(consts["kRdMaxStates"]) == RD.MAX_STATES
    assert int(consts["kRdMaxTableBytes"]) == RD.MAX_TABLE_BYTES
    assert 512 + RDK.BYTE_STATES * RDK.NEXT_STRIDE <= 48 * 1024


@pytest.mark.parametrize("kind,pattern",
                         [("rlike", p) for p in RLIKE_PATTERNS]
                         + [("like", p) for p in LIKE_PATTERNS]
                         + [(k, p) for k, p, _ in BOUNDARY])
def test_byte_indexed_table_is_the_class_table_through_the_classes(
        kind, pattern):
    dfa = _compile(kind, pattern)
    nxt = RDK.next_table(dfa)
    assert nxt.dtype == np.uint8 and nxt.shape == (dfa.n_states, 256)
    assert nxt.flags.c_contiguous
    for s in range(dfa.n_states):
        for b in range(256):
            assert nxt[s, b] == dfa.table[s, dfa.classes[b]]


def test_kernel_rows_makes_a_row_major_aligned_copy():
    """C4: a transposed dense rectangle (stride (1, P)) comes back
    row-major with the same values; a contiguous slice that is not
    16-byte aligned comes back aligned; an aligned row-major one is
    returned as it is."""
    w, p = 16, 6
    t = torch.arange(p * w, dtype=torch.uint8).reshape(w, p).t()
    assert t.stride() == (1, p) and not t.is_contiguous()
    assert t.clone().stride() == (1, p)       # the fault
    got = strrect.kernel_rows(t)
    assert got.stride() == (w, 1) and got.data_ptr() % 16 == 0
    assert torch.equal(got, t)
    flat = torch.arange(8 + p * w, dtype=torch.uint8)
    off = flat[1:1 + p * w].view(p, w)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    got = strrect.kernel_rows(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)
    same = torch.zeros((p, w), dtype=torch.uint8)
    if same.data_ptr() % 16 == 0:
        assert strrect.kernel_rows(same) is same
    assert RT.kernel_rows is strrect.kernel_rows
    assert RDK.kernel_rows is strrect.kernel_rows


@pytest.mark.parametrize("pattern,form", [("%special%requests%", "byte"),
                                          ("%special%requests%", "class"),
                                          ("%a_", None)])
def test_wrapper_hands_the_kernel_row_major_bytes_and_its_tables(
        monkeypatch, pattern, form):
    """C4 through ``launch``: the bytes the launch function reads from the
    pointer it is given are the transposed rectangle's rows; the tables
    are the DFA's (class form) or the identity classes and next_table
    (byte form, the default below BYTE_STATES states)."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    dfa = RD.compile_like(pattern)
    w, p = 32, 5
    rng = np.random.RandomState(3)
    rows = rng.randint(97, 123, (p, w)).astype(np.uint8)
    t = torch.from_numpy(np.ascontiguousarray(rows.T)).t()
    assert t.stride() == (1, p)
    lens = torch.tensor([0, 5, 16, 31, 40], dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True])
    seen = {}

    def fake(b, ln, v, n, width, cls, tab, acc, n_states, n_cls, start,
             sink, out, stream):
        seen["bytes"] = np.frombuffer(ctypes.string_at(b, n * width),
                                      np.uint8).reshape(n, width).copy()
        seen["classes"] = np.frombuffer(ctypes.string_at(cls, 256),
                                        np.uint8).copy()
        seen["table"] = np.frombuffer(ctypes.string_at(
            tab, n_states * n_cls), np.uint8).reshape(n_states, n_cls).copy()
        seen["n"] = (n, width, n_states, n_cls, start, sink)
        return 0

    RDK.launch(fake, t, lens, valid, dfa, form)
    np.testing.assert_array_equal(seen["bytes"], rows)
    which = form or RDK.instance(dfa)
    if which == "byte":
        np.testing.assert_array_equal(seen["classes"], np.arange(256))
        np.testing.assert_array_equal(seen["table"], RDK.next_table(dfa))
        assert seen["n"][3] == 256
    else:
        np.testing.assert_array_equal(seen["classes"], dfa.classes)
        np.testing.assert_array_equal(seen["table"], dfa.table)
        assert seen["n"][3] == dfa.n_classes
    assert seen["n"][:3] == (p, w, dfa.n_states)
    assert seen["n"][4:] == (dfa.start, dfa.first_sink)
