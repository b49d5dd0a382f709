#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

  1. device  -- the card's name and power limit (nvidia-smi), CUDA version;
  2. build   -- every CUDA kernel of the port, built from csrc/ with nvcc;
  3. kernels -- each kernel's wrapper on the card against its plain torch
                version, exact, in every mode, then timed (CUDA events,
                median of 20 after warm-up) beside its bound;
  4. q6      -- TPC-H Q6 at SF1 (6,001,215 lineitem rows, 1,048,576-row
                batches) through TorchSession/DataFrame on cuda, against a
                numpy reference computed here from the same arrays;
  5. q_comment -- the LIKE '%special%' comment scan at SF1 with
                spark.rapids.tpu.sql.pallas.enabled on (the match kernel
                must launch once per batch) and off (it must not launch).

The data is generated here from a seed, with numpy only: this script
imports neither JAX, pyarrow, pandas nor the JAX package. It prints a
``{"kernels": [...]}`` line and ends with one JSON line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

SF1_ROWS = 6_001_215
SEED = 42
#: the H100 SXM's published memory rate and its 32-bit non-tensor rate
#: (NVIDIA data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: relative tolerance of float sums against numpy: torch.sum and numpy
#: add the same values in different orders
REL_TOL = 1e-10


# ---------------------------------------------------------------------------
# data and queries: copies of benchmarks/tpch.py (gen_lineitem, q6) in numpy
# ---------------------------------------------------------------------------

def gen_lineitem(n_rows: int, seed: int = SEED) -> dict:
    """TPC-H lineitem columns as numpy arrays: the domains and the random
    draws (order included) of benchmarks/tpch.py:gen_lineitem."""
    rng = np.random.RandomState(seed)
    base = np.datetime64("1992-01-01")
    shipdate = base + rng.randint(0, 2526, n_rows)  # through 1998-11-28
    receiptdate = shipdate + rng.randint(1, 31, n_rows)
    qty = rng.randint(1, 51, n_rows).astype(np.float64)
    price = np.round(rng.uniform(900.0, 105000.0, n_rows), 2)
    return {
        "l_orderkey": rng.randint(1, n_rows // 4 + 2, n_rows),
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": np.round(rng.randint(0, 11, n_rows) / 100.0, 2),
        "l_tax": np.round(rng.randint(0, 9, n_rows) / 100.0, 2),
        "l_returnflag": rng.choice(["A", "N", "R"], n_rows),
        "l_linestatus": rng.choice(["O", "F"], n_rows),
        "l_shipdate": shipdate.astype("datetime64[D]"),
        "l_receiptdate": receiptdate.astype("datetime64[D]"),
        "l_shipmode": rng.choice(
            ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "REG AIR", "FOB"],
            n_rows),
    }


def q6(df, F):
    """Forecasting revenue change (TPC-H Q6): pure filter + reduction."""
    lo = np.datetime64("1994-01-01")
    hi = np.datetime64("1995-01-01")
    return (df.filter((F.col("l_shipdate") >= F.lit(lo))
                      & (F.col("l_shipdate") < F.lit(hi))
                      & (F.col("l_discount") >= F.lit(0.05))
                      & (F.col("l_discount") <= F.lit(0.07))
                      & (F.col("l_quantity") < F.lit(24.0)))
            .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                 .with_name("revenue")))


# TPC-H 4.2.2.10 text grammar word lists
_NOUNS = ("foxes ideas theodolites pinto_beans instructions dependencies "
          "excuses platelets asymptotes courts dolphins multipliers "
          "sauternes warthogs frets dinos attainments somas Tiresias "
          "patterns forges braids hockey_players frays warhorses dugouts "
          "notornis epitaphs pearls tithes waters orbits gifts sheaves "
          "depths sentiments decoys realms pains grouches escapades "
          "packages requests accounts deposits")
_VERBS = ("sleep wake are cajole haggle nag use boost affix detect "
          "integrate maintain nod was lose sublate solve thrash promise "
          "engage hinder print x-ray breach eat grow impress mold poach "
          "serve run dazzle snooze doze unwind kindle play hang believe "
          "doubt")
_ADJECTIVES = ("furious sly careful blithe quick fluffy slow quiet ruthless "
               "thin close dogged daring brave stealthy permanent enticing "
               "idle busy regular final ironic even bold silent special "
               "pending unusual express")
_ADVERBS = ("sometimes always never furiously slyly carefully blithely "
            "quickly fluffily slowly quietly ruthlessly thinly closely "
            "doggedly daringly bravely stealthily permanently enticingly "
            "idly busily regularly finally ironically evenly boldly "
            "silently")
_PREPOSITIONS = ("about above according_to across after against along "
                 "alongside_of among around at atop before behind beneath "
                 "beside besides between beyond by despite during except "
                 "for from in_place_of inside instead_of into near of on "
                 "outside over past since through throughout to toward "
                 "under until up upon without with within")
_AUXILIARIES = ("do may might shall will would can could should ought_to "
                "must will_have_to shall_have_to could_have_to "
                "should_have_to must_have_to need_to try_to")
_TERMINATORS = ". ; : ? ! --"

_COMMENT_MIN, _COMMENT_MAX, _COMMENT_WIDTH = 10, 43, 64
_TEXT_POOL_BYTES = 1 << 23


def _word_lists():
    def words(s):
        return [w.replace("_", " ").encode() for w in s.split()]
    adj = words(_ADJECTIVES)
    return [words(_NOUNS), words(_VERBS), adj, [a + b"," for a in adj],
            words(_ADVERBS), words(_PREPOSITIONS), words(_AUXILIARIES),
            [b"the"], words(_TERMINATORS)]


# word-list kinds
_N, _V, _ADJ, _ADJC, _ADV, _PREP, _AUX, _THE, _TERM = range(9)


def _text_pool(rng, n_bytes: int) -> np.ndarray:
    """uint8 text of grammar sentences, built without a per-word loop:

      sentence := NP VP T | NP VP PP T | NP VP NP T | NP PP VP NP T
                | NP PP VP PP T
      NP := noun | adj noun | adj, adj noun | adverb adj noun
      VP := verb | aux verb | verb adverb | aux verb adverb
      PP := preposition the NP

    Every sentence is laid out over 20 fixed slots, some absent; the
    present words of all sentences are then joined with spaces (a
    terminator attaches to the word before it)."""
    lists = _word_lists()
    offs = np.cumsum([0] + [len(l) for l in lists])
    vocab = [w for l in lists for w in l]
    v_len = np.array([len(w) for w in vocab], np.int64)
    v_start = np.concatenate([[0], np.cumsum(v_len)[:-1]])
    v_bytes = np.frombuffer(b"".join(vocab), np.uint8)

    s = n_bytes // 40 + 1                  # sentences, ~50 bytes each
    slots = []                             # per slot: (kind[s], present[s])

    def np_slots():
        f = rng.randint(0, 4, s)           # noun phrase form
        x1_kind = np.where(f == 2, _ADJC, np.where(f == 3, _ADV, _ADJ))
        return [(x1_kind, f >= 2), (np.full(s, _ADJ), f >= 1),
                (np.full(s, _N), np.ones(s, bool))]

    def vp_slots():
        g = rng.randint(0, 4, s)
        return [(np.full(s, _AUX), (g == 1) | (g == 3)),
                (np.full(s, _V), np.ones(s, bool)),
                (np.full(s, _ADV), g >= 2)]

    def pp_slots(on):
        return [(np.full(s, _PREP), on), (np.full(s, _THE), on)] + [
            (k, p & on) for k, p in np_slots()]

    t = rng.randint(0, 5, s)               # sentence template
    slots += np_slots()
    slots += pp_slots((t == 3) | (t == 4))
    slots += vp_slots()
    slots += pp_slots((t == 1) | (t == 4))
    slots += [(k, p & ((t == 2) | (t == 3))) for k, p in np_slots()]
    slots += [(np.full(s, _TERM), np.ones(s, bool))]
    kinds = np.stack([k for k, _ in slots], axis=1)
    present = np.stack([p for _, p in slots], axis=1)
    sizes = np.diff(offs)[kinds]
    word = offs[kinds] + (rng.random_sample(kinds.shape) * sizes).astype(
        np.int64)
    tok = word[present]                    # row-major: sentence order
    attached = kinds[present] == _TERM
    lens = v_len[tok]
    sep = np.where(attached, 0, 1)
    sep[0] = 0
    end = np.cumsum(sep + lens)
    start = end - lens                     # first byte of each word
    total = int(end[-1])
    out = np.full(total, ord(" "), np.uint8)
    within = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    out[np.repeat(start, lens) + within] = \
        v_bytes[np.repeat(v_start[tok], lens) + within]
    return out[:n_bytes]


def gen_comment(n_rows: int, seed: int = SEED + 1) -> np.ndarray:
    """TPC-H l_comment: per row a random 10-43 byte substring of a text
    pool made from the spec's grammar (4.2.2.10), as dbgen draws
    TEXT(10, 43). Returns an ``S64`` array, whose buffer is the byte
    rectangle uint8[n_rows, 64]. The pool is 8 MiB (dbgen's is larger);
    the comments are near-unique all the same."""
    rng = np.random.RandomState(seed)
    pool = _text_pool(rng, _TEXT_POOL_BYTES)
    pool = np.concatenate([pool, np.zeros(_COMMENT_WIDTH, np.uint8)])
    windows = np.lib.stride_tricks.sliding_window_view(pool, _COMMENT_WIDTH)
    start = rng.randint(0, _TEXT_POOL_BYTES - _COMMENT_MAX + 1, n_rows)
    length = rng.randint(_COMMENT_MIN, _COMMENT_MAX + 1, n_rows)
    rect = windows[start]
    rect *= (np.arange(_COMMENT_WIDTH)[None, :] < length[:, None])
    return rect.view(f"S{_COMMENT_WIDTH}").reshape(n_rows)


def q_comment(df, F):
    """The LIKE '%word%' comment scan of TPC-H Q13/Q16, over l_comment."""
    return (df.with_column("hit", F.col("l_comment").like("%special%"))
              .filter(F.col("hit"))
              .agg(F.count_star().with_name("n"),
                   F.sum(F.col("l_extendedprice")).with_name("revenue")))


def gen_table(n_rows: int) -> dict:
    t = gen_lineitem(n_rows)
    t["l_comment"] = gen_comment(n_rows)
    return t


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------

def q6_numpy(t: dict) -> float:
    sd = t["l_shipdate"]
    keep = ((sd >= np.datetime64("1994-01-01"))
            & (sd < np.datetime64("1995-01-01"))
            & (t["l_discount"] >= 0.05) & (t["l_discount"] <= 0.07)
            & (t["l_quantity"] < 24.0))
    return float(np.sum(t["l_extendedprice"][keep] * t["l_discount"][keep]))


def q_comment_numpy(t: dict):
    hit = np.char.find(t["l_comment"], b"special") >= 0
    return int(hit.sum()), float(np.sum(t["l_extendedprice"][hit]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median ms of one call, by CUDA events around each call."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    _log(line)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
         f"{np.__version__} device {torch.cuda.get_device_name(0)}")
    return line


def phase_build() -> None:
    from spark_rapids_tpu_torch import native
    t0 = time.perf_counter()
    log = native.build("rect_match")
    _log(f"build: rect_match in {time.perf_counter() - t0:.2f} s")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            _log(f"  ptxas rect_match: {ln.strip()}")


def _random_rect(rng, rows: int, width: int, pat: bytes):
    """Random printable-ASCII rows of random lengths, with ``pat``
    planted at a random offset, at the start, at the end and as the
    whole row in some of them."""
    L = len(pat)
    rect = rng.randint(32, 127, (rows, width)).astype(np.uint8)
    lens = rng.randint(0, width + 1, rows).astype(np.int32)
    p = np.frombuffer(pat, np.uint8)
    kind = rng.randint(0, 10, rows)
    lens[kind == 4] = L
    ok = lens >= L
    where = {1: rng.randint(0, width, rows) % np.maximum(lens - L + 1, 1),
             2: np.zeros(rows, np.int64), 3: lens - L, 4: np.zeros(rows,
                                                                 np.int64)}
    for k, off in where.items():
        sel = np.flatnonzero((kind == k) & ok)
        idx = off[sel][:, None] + np.arange(L)[None, :]
        rect[sel[:, None], idx] = p[None, :]
    rect[np.arange(width)[None, :] >= lens[:, None]] = 0
    return rect, lens


def phase_kernels(comment_batch) -> dict:
    """rect_match against rect_match_reference on the card: every mode
    and edge case on a random 1,048,576 x 64 rectangle, then the timed
    main-path call (contains 'special' over the first l_comment batch)."""
    import torch
    from spark_rapids_tpu_torch.exprs.rect_match import (
        rect_match, rect_match_reference)
    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    pat = b"special"
    rect, lens = _random_rect(rng, 1 << 20, 64, pat)
    b = torch.from_numpy(rect).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    cases = [(m, pat) for m in ("contains", "startswith", "endswith",
                                "equals", "locate")]
    cases += [("contains", b"ab"), ("locate", b"e"), ("equals", b""),
              ("locate", b""), ("contains", b""), ("startswith", b"x" * 64),
              ("contains", b"x" * 65), ("locate", b"y" * 65)]
    for rows, width in ((1000, 8), (777, 16), (5000, 32), (3, 128),
                        (0, 64)):
        r2, l2 = _random_rect(rng, rows, width, b"abc")
        cases.append(((r2, l2), b"abc"))
    checked = []
    max_err = 0
    for mode, p in cases:
        if isinstance(mode, tuple):      # other widths, all modes
            bb = torch.from_numpy(mode[0]).to(dev)
            ll = torch.from_numpy(mode[1]).to(dev)
            modes = ("contains", "startswith", "endswith", "equals",
                     "locate")
        else:
            bb, ll, modes = b, ln, (mode,)
        for m in modes:
            got = rect_match(bb, ll, p, m)
            want = rect_match_reference(bb, ll, p, m)
            torch.cuda.synchronize()
            if len(want):
                max_err = max(max_err, int((got.to(torch.int64) - want.to(
                    torch.int64)).abs().max()))
            _check(got.dtype == want.dtype and torch.equal(got, want),
                   f"rect_match {m} {p[:8]!r} W={bb.shape[1]} disagrees "
                   f"with its plain version")
            checked.append((m, len(p), int(bb.shape[1]),
                            int(want.to(torch.int64).sum())))
    _log(f"kernel rect_match: {len(checked)} cases exact "
         f"(mode, L, W, sum): {checked}")

    per_mode = {m: _time_ms(lambda m=m: rect_match(b, ln, pat, m), reps=10)
                for m in ("contains", "startswith", "endswith", "equals",
                          "locate")}
    plain_mode = {m: _time_ms(lambda m=m: rect_match_reference(b, ln, pat, m),
                              reps=10)
                  for m in per_mode}
    _log("kernel rect_match random 1048576x64 'special' ms: "
         + ", ".join(f"{m} {per_mode[m]:.4f} (plain {plain_mode[m]:.4f})"
                     for m in per_mode))

    # timed at the main path's shape and data
    cb = comment_batch
    P, W = cb.data.shape
    kern_ms = _time_ms(lambda: rect_match(cb.data, cb.lengths, pat,
                                          "contains"))
    plain_ms = _time_ms(lambda: rect_match_reference(cb.data, cb.lengths,
                                                     pat, "contains"))
    got = rect_match(cb.data, cb.lengths, pat, "contains")
    want = rect_match_reference(cb.data, cb.lengths, pat, "contains")
    _check(torch.equal(got, want), "rect_match disagrees on l_comment")
    # work this data needs: a row is read only as far as its scan goes (its
    # length, or the end of the first match), in the card's 32-byte
    # sectors; bytes past the length are zero and decide nothing, so
    # P*W is an upper count. One byte compare at least per scanned offset.
    first = rect_match_reference(cb.data, cb.lengths, pat, "locate")
    first = first.to(torch.int64)
    seen = torch.clamp(cb.lengths.to(torch.int64), max=W)
    need = torch.where(first > 0, first - 1 + len(pat), seen)
    row_bytes = (need + 31) // 32 * 32 if W % 32 == 0 else need
    scanned = torch.where(first > 0, first,
                          torch.clamp(seen - len(pat) + 1, min=0))
    ops = int(scanned.sum())
    nbytes = int(row_bytes.sum()) + 4 * P + P
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    _log(f"kernel rect_match contains P={P} W={W}: kernel {kern_ms:.4f} ms, "
         f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
         f"({nbytes} bytes, of at most {P * W + 5 * P}; {ops} byte "
         f"compares); max abs err {max_err}")
    return {"name": "rect_match", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/rect_match.cu",
            "replaces": "spark_rapids_tpu/exprs/pallas_rect.py:57",
            "modes": ["contains", "startswith", "endswith", "equals",
                      "locate"],
            "launches": None, "max_abs_err": float(max_err),
            "exact": max_err == 0,
            "ms": kern_ms, "kernel_ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "shape": [P, W]}


def _profile_host_encode(fn, top: int = 6) -> None:
    """Where the host encode of a batch goes: the calls with the most
    self time (the work is in a few numpy calls, so the profiler's
    per-call cost does not distort it)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2], v[0], k) for k, v in stats.items()), reverse=True)
    _log("host encode, self ms by call: " + "; ".join(
        f"{k[2]} ({k[0].rsplit('/', 1)[-1]}:{k[1]}) {t * 1e3:.1f} ms x{n}"
        for t, n, k in rows[:top]))


def _run_query(session, table, query):
    from spark_rapids_tpu_torch.api import functions as F
    t0 = time.perf_counter()
    rows = query(session.create_dataframe(table), F).collect()
    return rows, (time.perf_counter() - t0) * 1e3


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card",
              file=sys.stderr)
        return 2
    try:
        import spark_rapids_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not importable here: {e}", file=sys.stderr)
        return 2
    try:
        from spark_rapids_tpu_torch.api import TorchSession
        from spark_rapids_tpu_torch.columnar import (ByteRectColumn,
                                                     ColumnarBatch, HostTable)
        from spark_rapids_tpu_torch.exprs.rect_match import rect_match
        phase_device()
        phase_build()

        t0 = time.perf_counter()
        table = gen_table(SF1_ROWS)
        host = HostTable.from_dict(table)
        _log(f"data: {SF1_ROWS} rows generated in "
             f"{time.perf_counter() - t0:.2f} s")
        batch_rows = 1 << 20
        n_batches = math.ceil(SF1_ROWS / batch_rows)
        # one batch's ingest, split: host encode alone (a CPU target
        # copies nothing), then with the copy to the card, twice (the
        # first includes setting up the CUDA context)
        src = host.select(["l_comment"]).slice(0, batch_rows)
        ingest_ms = []
        for dev in ("cpu", "cuda", "cuda"):
            t0 = time.perf_counter()
            first = ColumnarBatch.from_host(src, dev, 64)
            torch.cuda.synchronize()
            ingest_ms.append((time.perf_counter() - t0) * 1e3)
        _log(f"ingest of one {batch_rows}-row l_comment batch: host encode "
             f"{ingest_ms[0]:.1f} ms; encode + copy to cuda "
             f"{ingest_ms[1]:.1f} ms first, {ingest_ms[2]:.1f} ms again")
        _profile_host_encode(lambda: ColumnarBatch.from_host(src, "cpu", 64))
        _check(isinstance(first.columns[0], ByteRectColumn)
               and first.columns[0].width == 64,
               f"l_comment ingested as {first.columns[0]!r}, not a "
               "64-byte rectangle")
        kernel = phase_kernels(first.columns[0])
        del first

        conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
        session = TorchSession(conf)          # device defaults to cuda
        _check(session.device.type == "cuda", "session is not on cuda")

        want6 = q6_numpy(table)
        rect_match.launches = 0
        rows, ms_cold = _run_query(session, host, q6)
        q6_launches = rect_match.launches
        rows2, ms_warm = _run_query(session, host, q6)
        got6 = rows[0]["revenue"]
        _check(len(rows) == 1 and math.isfinite(got6), f"q6 rows {rows}")
        _check(_rel(got6, want6) <= REL_TOL and rows2 == rows,
               f"q6 revenue {got6} != numpy {want6}")
        _log(f"q6 SF1: revenue {got6!r} (numpy {want6!r}, rel "
             f"{_rel(got6, want6):.3e}); wall {ms_cold:.1f} ms cold, "
             f"{ms_warm:.1f} ms warm; rect_match launches {q6_launches}")

        want_n, want_rev = q_comment_numpy(table)
        on = TorchSession({**conf,
                           "spark.rapids.tpu.sql.pallas.enabled": True})
        rect_match.launches = 0
        rows, on_cold = _run_query(on, host, q_comment)
        launches = rect_match.launches
        _check(launches == n_batches,
               f"q_comment launched rect_match {launches} times, "
               f"expected {n_batches} (one per batch)")
        rows_on, on_warm = _run_query(on, host, q_comment)
        rect_match.launches = 0
        rows_off, off_warm = _run_query(session, host, q_comment)
        _check(rect_match.launches == 0,
               "the conf-off route launched the kernel")
        for r in (rows, rows_on, rows_off):
            _check(r[0]["n"] == want_n
                   and _rel(r[0]["revenue"], want_rev) <= REL_TOL,
                   f"q_comment {r} != numpy ({want_n}, {want_rev})")
        _log(f"q_comment SF1: n {rows[0]['n']} revenue "
             f"{rows[0]['revenue']!r} (numpy {want_n}, {want_rev!r}); "
             f"wall pallas.enabled=on {on_cold:.1f} ms cold, "
             f"{on_warm:.1f} ms warm; off {off_warm:.1f} ms warm; "
             f"rect_match launches {launches} over {n_batches} batches")
        _log(json.dumps({"queries": {
            "q6": {"rows": SF1_ROWS, "wall_ms_cold": ms_cold,
                   "wall_ms_warm": ms_warm},
            "q_comment": {"rows": SF1_ROWS, "batches": n_batches,
                          "wall_ms_on_cold": on_cold,
                          "wall_ms_on_warm": on_warm,
                          "wall_ms_off_warm": off_warm}}}))
        kernel["launches"] = launches
        _log(json.dumps({"kernels": [kernel]}))
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
