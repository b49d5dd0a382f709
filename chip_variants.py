#!/usr/bin/env python3
"""Where the dense_groupby kernel's time goes, on one NVIDIA card.

    python3 chip_variants.py

Builds variants of spark_rapids_tpu_torch/csrc/dense_groupby.cu, each the
kernel with one part changed by a text substitution, into build/variants/,
one nvcc each, started together, and times each with the L2 cold beside
the kernel itself on q1's batch shape (1,048,576 rows, 2 keys of 3 and 2
values, 5 float64 columns, G = 16) and on the G = 64 shape of
chip_smoke.py:

  loads_only    -- each piece's loads, then a sink in place of the warp
                   loop (what the loads alone cost);
  compute_only  -- the warp loop over made-up ids and values, no column
                   loads (what the loop alone costs);
  no_combine    -- the block partials written, the combine left out;
  blocks_3, blocks_2 -- registers bounded for 3 or 2 blocks an SM in
                   place of 4.

The variants' results are wrong by design; only the kernel's own is
checked against the plain version. Prints one line a shape, with the
card's name and power limit first. Exits non-zero when no card is there.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np

import chip_smoke as cs

_PIECE = "  const int gid = in ? dg_group_id(a.keys, a.keep, row, G) : G;\n"
_LOADS = ("    v[u] = on ? s_valid[u][row] : 0;\n"
          "    x[u] = on && ((a.data_mask >> u) & 1u) ? s_data[u][row] : 0;")
VARIANTS = {
    "loads_only": [(_PIECE, _PIECE + (
        "  {\n    int64_t sink = gid;\n"
        "    for (int u = 0; u < kDgColsAPass; ++u) sink += x[u] + v[u];\n"
        "    if (sink == 0x5a5a5a5a5a5aLL) w_cnt[0] = 1;\n    return;\n  }\n"))],
    "compute_only": [
        (_PIECE, "  const int gid = in ? static_cast<int>((row * 7 / 3) % 6)"
                 " : G;\n"),
        (_LOADS, "    v[u] = on ? ((row + u) % 5 != 0) : 0;\n"
                 "    x[u] = on ? row * 3 + u : 0;")],
    "no_combine": [("  // the last block of each kDgCombine adds theirs in "
                    "block order\n", "  return;\n")],
    "blocks_3": [("H:constexpr int kDgMinBlocks = 4;",
                  "constexpr int kDgMinBlocks = 3;")],
    "blocks_2": [("H:constexpr int kDgMinBlocks = 4;",
                  "constexpr int kDgMinBlocks = 2;")],
}


def _build_variants():
    """Start one nvcc a variant; returns {name: (process, library)}."""
    from spark_rapids_tpu_torch import native
    src = (native.CSRC / "dense_groupby.cu").read_text()
    hdr = (native.CSRC / "dense_groupby_row.cuh").read_text()
    started = {}
    for name, subs in VARIANTS.items():
        s, h = src, hdr
        for old, new in subs:
            if old.startswith("H:"):
                cs._check(old[2:] in h, f"{name}: no {old[2:]!r} in header")
                h = h.replace(old[2:], new)
            else:
                cs._check(old in s, f"{name}: no {old!r} in the kernel")
                s = s.replace(old, new)
        d = native.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "dense_groupby.cu").write_text(s)
        (d / "dense_groupby_row.cuh").write_text(h)
        lib = d / "libdense_groupby.so"
        started[name] = (subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(d), "-o",
             str(lib), str(d / "dense_groupby.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    return started


def _use(lib_path):
    """Point the wrapper at another build of the library (None: the
    port's own)."""
    from spark_rapids_tpu_torch.exec import dense_groupby as dg
    dg._KERNEL.clear()
    if lib_path is None:
        dg._kernel()
        return
    lib = ctypes.CDLL(str(lib_path))
    lib.dense_groupby_launch.argtypes = [ctypes.c_void_p]
    lib.dense_groupby_launch.restype = ctypes.c_int
    lib.dense_groupby_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dense_groupby_scratch_bytes.restype = ctypes.c_int64
    dg._KERNEL.update(launch=lib.dense_groupby_launch,
                      scratch_bytes=lib.dense_groupby_scratch_bytes,
                      describe=None, sizes={})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_variants.py runs on the card",
              file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.exec import dense_groupby as dg
    cs.phase_device()
    started = _build_variants()
    cs.phase_build()
    for name, (proc, _) in started.items():
        log, _ = proc.communicate(timeout=600)
        cs._check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
    rng = np.random.RandomState(1)
    shapes = {"q1's batch shape": cs._dense_case(rng, 1 << 20, (3, 2), 5, 16,
                                                 floats=True),
              "the G = 64 shape": cs._g64_args(np.random.RandomState(64),
                                               1 << 20)}
    for label, args in shapes.items():
        cs._dense_check(args, label)
        n = max(2, -(-cs.COLD_BYTES // cs.dense_bound(args)["bytes"]))
        inputs = [args] + [cs._clone_args(args) for _ in range(n - 1)]
        ms = {}
        for name in ["kernel", *VARIANTS, "kernel again"]:
            _use(None if name.startswith("kernel") else started[name][1])
            ms[name] = cs._cold_ms(dg.dense_groupby, inputs,
                                   f"{label} {name}")[0]
        _use(None)
        print(f"dense_groupby variants on {label}, device ms a call, cold: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
