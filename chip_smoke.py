#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--compare NAME=DIR ...]

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

  1. device  -- the card's name and power limit (nvidia-smi), CUDA version;
  2. build   -- every CUDA kernel of the port (rect_match, dense_groupby),
                built from csrc/ with one nvcc each, started together;
                ptxas must report no stack frame and no spills for any
                function. ``--compare NAME=DIR`` also builds
                DIR/rect_match.cu and/or DIR/dense_groupby.cu (another
                version of a kernel with its header, e.g. the parent
                commit's; dense_groupby with the C interface of commit
                645412c) alongside, to be timed beside the port's;
  3. kernels -- each kernel's wrapper on the card against its plain torch
                version: rect_match exactly, in every mode and edge case;
                dense_groupby with counts exact and float sums within a
                stated tolerance, over G = 16 and 64, 1-8 value columns,
                nulls, dead rows, row counts off a warp's 32 rows and
                the grid's, one group, a row per group, -0.0/NaN/+-inf,
                unaligned views
                and q1's batch, two launches giving the same bits. Then
                each timed with the L2 cold (launches queued back to back
                over distinct inputs, several times the L2) beside its
                bound from the data: rect_match over the main path's
                batches, every mode, every width; dense_groupby on q1's
                batch (G = 16) and on a G = 64 shape, in turns with the
                kernels to compare, beside a loop of index_add_, with
                each instance's launch shape (residency, grid, registers,
                shared memory);
  4. q6      -- TPC-H Q6 at SF1 (6,001,215 lineitem rows, 1,048,576-row
                batches) through TorchSession/DataFrame on cuda, against a
                numpy reference computed here from the same arrays;
  5. q_comment -- the LIKE '%special%' comment scan at SF1 with
                spark.rapids.tpu.sql.pallas.enabled on (the match kernel
                must launch once per batch) and off (it must not launch),
                then once more under torch.profiler: where the warm wall
                goes on the card;
  6. q1      -- TPC-H Q1 at SF1 (the filter and projections fused into a
                grouped aggregate over l_returnflag and l_linestatus, then
                ORDER BY), cold and warm, against numpy: dense_groupby must
                launch once per batch; then once more under torch.profiler,
                and once with the operand copies of commit 645412c (stream
                syncs and copies counted in both);
  7. memory  -- string predicates in filters and the memory runtime, each
                query cold and warm with its launches, the memory
                manager's peak and spills and the caching allocator's
                peaks: q12_modes (LIKE OR startswith over the
                l_shipmode dictionary, dense_groupby once per batch),
                q_comment_filter (NOT LIKE over the l_comment rectangle,
                rect_match once per batch with the kernel on, never
                with it off), q18_agg with the default budget and with
                one of half its partials' bytes (partials reach the host
                and the disk); the spill rates of one q18 partial; q1
                under 2 injected RetryOOMs and 1 SplitAndRetryOOM; q6 and
                q1 on two threads of one session with 1 and 2 device
                permits; the leak audit at session close.

The data is generated here from a seed, with numpy only: this script
imports neither JAX, pyarrow, pandas nor the JAX package. It prints a
``{"kernels": [...]}`` line and ends with one JSON line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

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
# data and queries: copies of benchmarks/tpch.py (gen_lineitem, q1, q6) in
# numpy
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


def q1(df, F):
    """Pricing summary report (TPC-H Q1)."""
    cutoff = np.datetime64("1998-12-01") - np.timedelta64(90, "D")
    disc_price = F.col("l_extendedprice") * (F.lit(1.0) -
                                             F.col("l_discount"))
    charge = disc_price * (F.lit(1.0) + F.col("l_tax"))
    return (df.filter(F.col("l_shipdate") <= F.lit(cutoff))
            .with_column("disc_price", disc_price)
            .with_column("charge", charge)
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(F.col("l_quantity")).with_name("sum_qty"),
                 F.sum(F.col("l_extendedprice")).with_name("sum_base_price"),
                 F.sum(F.col("disc_price")).with_name("sum_disc_price"),
                 F.sum(F.col("charge")).with_name("sum_charge"),
                 F.avg(F.col("l_quantity")).with_name("avg_qty"),
                 F.avg(F.col("l_extendedprice")).with_name("avg_price"),
                 F.avg(F.col("l_discount")).with_name("avg_disc"),
                 F.count_star().with_name("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


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


def q12_modes(df, F):
    """TPC-H Q12's shipping-mode filter over lineitem alone: LIKE (the
    dictionary's mask form) OR startswith (its code range), then a
    grouped count and revenue by mode."""
    lo = np.datetime64("1994-01-01")
    hi = np.datetime64("1995-01-01")
    return (df.filter((F.col("l_shipmode").like("MAIL")
                       | F.startswith(F.col("l_shipmode"), "SH"))
                      & (F.col("l_receiptdate") >= F.lit(lo))
                      & (F.col("l_receiptdate") < F.lit(hi)))
            .group_by("l_shipmode")
            .agg(F.count_star().with_name("n"),
                 F.sum(F.col("l_extendedprice")
                       * (F.lit(1.0) - F.col("l_discount")))
                 .with_name("revenue"))
            .order_by("l_shipmode"))


def q_comment_filter(df, F):
    """The Q13 form: NOT LIKE '%special%' directly in the filter."""
    return (df.filter(~F.col("l_comment").like("%special%"))
            .agg(F.count_star().with_name("n"),
                 F.sum(F.col("l_extendedprice")).with_name("revenue")))


#: TPC-H Q18's quantity threshold (the spec's substitution value)
Q18_QUANTITY = 300.0


def q18_agg(df, F):
    """TPC-H Q18's inner aggregate: the orders whose lines hold more than
    300 units, largest first."""
    return (df.group_by("l_orderkey")
            .agg(F.sum(F.col("l_quantity")).with_name("sum_qty"),
                 F.count_star().with_name("n"))
            .filter(F.col("sum_qty") > F.lit(Q18_QUANTITY))
            .order_by(F.col("sum_qty").desc(), F.col("l_orderkey").asc()))


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


def q1_numpy(t: dict) -> list:
    """TPC-H Q1's rows (dicts in collect()'s form), sorted by the keys."""
    keep = t["l_shipdate"] <= (np.datetime64("1998-12-01")
                               - np.timedelta64(90, "D"))
    flag, status = t["l_returnflag"][keep], t["l_linestatus"][keep]
    qty, price = t["l_quantity"][keep], t["l_extendedprice"][keep]
    disc, tax = t["l_discount"][keep], t["l_tax"][keep]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    rows = []
    for f in np.unique(flag):
        for s in np.unique(status):
            g = (flag == f) & (status == s)
            n = int(g.sum())
            if not n:
                continue
            rows.append({
                "l_returnflag": str(f), "l_linestatus": str(s),
                "sum_qty": float(qty[g].sum()),
                "sum_base_price": float(price[g].sum()),
                "sum_disc_price": float(disc_price[g].sum()),
                "sum_charge": float(charge[g].sum()),
                "avg_qty": float(qty[g].sum()) / n,
                "avg_price": float(price[g].sum()) / n,
                "avg_disc": float(disc[g].sum()) / n,
                "count_order": n})
    return rows


def q1_equal(got: list, want: list) -> bool:
    """Keys, order and counts exactly; sums and averages to REL_TOL."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            return False
        for k, v in w.items():
            if isinstance(v, float):
                if not _rel(g[k], v) <= REL_TOL:
                    return False
            elif g[k] != v:
                return False
    return True


def q_comment_numpy(t: dict):
    hit = np.char.find(t["l_comment"], b"special") >= 0
    return int(hit.sum()), float(np.sum(t["l_extendedprice"][hit]))


def q12_modes_numpy(t: dict) -> list:
    rd = t["l_receiptdate"]
    mode = t["l_shipmode"]
    keep = (((mode == "MAIL") | np.char.startswith(mode, "SH"))
            & (rd >= np.datetime64("1994-01-01"))
            & (rd < np.datetime64("1995-01-01")))
    rev = t["l_extendedprice"] * (1.0 - t["l_discount"])
    return [{"l_shipmode": str(m), "n": int((keep & (mode == m)).sum()),
             "revenue": float(rev[keep & (mode == m)].sum())}
            for m in np.unique(mode[keep])]


def q_comment_filter_numpy(t: dict):
    miss = np.char.find(t["l_comment"], b"special") < 0
    return int(miss.sum()), float(np.sum(t["l_extendedprice"][miss]))


def q18_agg_numpy(t: dict) -> list:
    keys, inv = np.unique(t["l_orderkey"], return_inverse=True)
    qty = np.bincount(inv, weights=t["l_quantity"])
    n = np.bincount(inv)
    sel = np.flatnonzero(qty > Q18_QUANTITY)
    sel = sel[np.lexsort((keys[sel], -qty[sel]))]
    return [{"l_orderkey": int(keys[i]), "sum_qty": float(qty[i]),
             "n": int(n[i])} for i in sel]


def rows_equal(got: list, want: list) -> bool:
    """Keys, order and counts exactly; float values to REL_TOL."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            return False
        for k, v in w.items():
            if isinstance(v, float):
                if not _rel(g[k], v) <= REL_TOL:
                    return False
            elif g[k] != v:
                return False
    return True


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

MODES = ("contains", "startswith", "endswith", "equals", "locate")
#: bytes of distinct inputs that a timed run rotates over: four times the
#: H100's 50 MB L2, so that every launch finds its input cold, as each
#: q_comment batch arrives
COLD_BYTES = 200 << 20
#: cycles per ms of the sleep that holds the stream while the host
#: enqueues a timed run (the H100 SXM's 1.98 GHz boost clock; the sleep
#: only has to outlast the enqueue, which _queued_ms checks)
CYCLES_PER_MS = 1_980_000
#: the main path's match: q_comment's LIKE '%special%'
PATTERN = b"special"


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def _queued_ms(calls, label: str):
    """(device ms, host ms) per call of ``calls`` run back to back. A sleep
    kernel holds the stream while the host enqueues them, so the events
    around the calls see device work only; the sleep is lengthened until
    it outlasts the enqueue."""
    import torch
    sleep_ms = 0.05 * len(calls) + 1.0
    for _ in range(8):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(sleep_ms * CYCLES_PER_MS))
        ev[1].record()
        t0 = time.perf_counter()
        for fn in calls:
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        slept = ev[0].elapsed_time(ev[1])
        if host_ms < slept:
            return (ev[1].elapsed_time(ev[2]) / len(calls),
                    host_ms / len(calls))
        sleep_ms = 2 * max(host_ms, sleep_ms) + 1.0
    raise AssertionError(f"{label}: the host's enqueue ({host_ms:.3f} ms) "
                         f"outlasted the sleep ({slept:.3f} ms) 8 times")


def _cold_ms(fn, inputs, label: str, rounds: int = 2, reps: int = 3):
    """(device ms, host ms) per call of ``fn`` over ``inputs`` in turn
    (distinct copies of at least COLD_BYTES in all, so each call finds its
    input cold in L2), ``rounds`` passes a run; median of ``reps`` runs
    after one untimed pass."""
    calls = [lambda x=x: fn(*x) for x in inputs]
    _queued_ms(calls, label)
    runs = [_queued_ms(calls * rounds, label) for _ in range(reps)]
    return (float(np.median([r[0] for r in runs])),
            float(np.median([r[1] for r in runs])))


def _copies(b, ln):
    """``(b, ln)`` and clones of it, COLD_BYTES in all (at least two)."""
    n = max(2, -(-COLD_BYTES // (b.nbytes + ln.nbytes)))
    return [(b, ln)] + [(b.clone(), ln.clone()) for _ in range(n - 1)]


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
    _check(hasattr(torch.cuda, "_sleep"),
           "torch.cuda._sleep is missing: the kernel timings need it")
    return line


def _ptxas_frames(log: str) -> list:
    """(function, stack bytes, spill store bytes, spill load bytes) for
    every function in nvcc's -Xptxas=-v output."""
    out, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.append((fn,) + tuple(int(g) for g in m.groups()))
    return out


def _start_compare_build(name: str, src_dir: str):
    """nvcc for other versions of the port's kernels (``src_dir`` holds a
    rect_match.cu and/or a dense_groupby.cu with their headers: the parent
    commit's, or a variant), started now and built like the port's own
    into build/. Returns [(name, kernel, process, library)]."""
    from spark_rapids_tpu_torch import native
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for kernel in KERNELS:
        src = Path(src_dir) / f"{kernel}.cu"
        if not src.exists():
            continue
        out = native.BUILD_DIR / f"lib{kernel}_compare_{name}.so"
        started.append((name, kernel, subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(src.parent),
             "-o", str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    _check(bool(started), f"no rect_match.cu or dense_groupby.cu in "
                          f"{src_dir}")
    return started


def _rect_match_compare(name, lib):
    """rect_match_launch of another build, with rect_match's arguments (no
    launch count: it is not on the port's path)."""
    import ctypes

    import torch
    from spark_rapids_tpu_torch.exprs import rect_match as rm
    fn = lib.rect_match_launch
    fn.argtypes = rm._ARGTYPES
    fn.restype = ctypes.c_int

    def other(b, ln, pat, mode):
        o = rm._out(b.shape[0], mode, b.device)
        rc = fn(b.data_ptr(), ln.data_ptr(), b.shape[0], b.shape[1], pat,
                len(pat), rm.MODES[mode], o.data_ptr(),
                torch.cuda.current_stream(b.device).cuda_stream)
        _check(rc == 0, f"{name} kernel launch failed: CUDA error {rc}")
        return o
    return other


def _dense_groupby_compare(name, lib):
    """A dense_groupby built with the C interface of commit 645412c (one
    launch of block partials and a second that adds them, each pointer
    array passed on its own), with dense_groupby's arguments and result;
    no launch count."""
    import ctypes

    import torch
    from spark_rapids_tpu_torch.exec.dense_groupby import DenseGroups
    fn = lib.dense_groupby_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    lib.dense_groupby_rows_per_block.restype = ctypes.c_int
    rows_per_block = lib.dense_groupby_rows_per_block()

    def ptrs(ts):
        return (ctypes.c_void_p * max(len(ts), 1))(
            *[None if t is None else t.data_ptr() for t in ts])

    def other(keys, remaps, cards, keep, values, G):
        K, p = len(values), keep.shape[0]
        part = max(-(-p // rows_per_block), 1) * (K + 1) * G
        buf = torch.empty(2 * part + 2 * K * G + G, dtype=torch.int64,
                          device=keep.device)
        sums = buf[2 * part:2 * part + K * G].view(K, G)
        counts = buf[2 * part + K * G:2 * part + 2 * K * G].view(K, G)
        occ = buf[2 * part + 2 * K * G:]
        i32 = ctypes.c_int32 * len(keys)
        rc = fn(len(keys), ptrs([c for c, _ in keys]),
                ptrs([v for _, v in keys]), ptrs(remaps),
                i32(*[len(r) for r in remaps]), i32(*[int(c) for c in cards]),
                keep.data_ptr(), p, K, ptrs([d for d, _ in values]),
                ptrs([v for _, v in values]),
                (ctypes.c_uint8 * max(K, 1))(*[
                    int(d is not None and d.dtype == torch.int64)
                    for d, _ in values]),
                G, buf.data_ptr(), buf.data_ptr() + 8 * part,
                sums.data_ptr(), counts.data_ptr(), occ.data_ptr(),
                torch.cuda.current_stream(keep.device).cuda_stream)
        _check(rc == 0, f"{name} dense_groupby launch failed: CUDA error "
                        f"{rc}")
        return DenseGroups(
            [None if d is None else (sums[k] if d.dtype == torch.int64
                                     else sums[k].view(torch.float64))
             for k, (d, _) in enumerate(values)], counts, occ)
    return other


def _finish_compare_build(name, kernel, proc, out):
    """The built kernel as a function with the port's wrapper's arguments
    (and no launch count: it is not on the port's path)."""
    import ctypes
    log, _ = proc.communicate(timeout=600)
    _check(proc.returncode == 0, f"nvcc failed for {name} {kernel}:\n{log}")
    frames = _ptxas_frames(log)
    _log(f"  ptxas {name} {kernel}: {len(frames)} functions, stack/spill "
         f"bytes {sorted({f[1:] for f in frames})}")
    lib = ctypes.CDLL(str(out))
    if kernel == "rect_match":
        return _rect_match_compare(name, lib)
    return _dense_groupby_compare(name, lib)


#: the port's kernel libraries (csrc/<name>.cu), built side by side
KERNELS = ("rect_match", "dense_groupby")


def phase_build(compare=()):
    """Build the port's kernels, one nvcc each, all started together (and
    the ones to compare at the same time); the ptxas report of every
    function of the port must show no stack frame and no spills. Returns
    {kernel: {name: launch function}} of the kernels to compare."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_tpu_torch import native
    t0 = time.perf_counter()
    started = [b for n, d in compare for b in _start_compare_build(n, d)]
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(native.build_log, KERNELS)))
    _log(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                _log(f"  ptxas {name}: {ln.strip()}")
        frames = _ptxas_frames(log)
        _check(bool(frames), f"nvcc printed no ptxas report for {name}")
        bad = [f for f in frames if f[1:] != (0, 0, 0)]
        _check(not bad, f"{name} functions with a stack frame or spills: "
                        f"{bad}")
        _log(f"  ptxas {name}: {len(frames)} functions, every one with a "
             "0-byte stack frame and 0 spill bytes")
    fns = {k: {} for k in KERNELS}
    for name, kernel, proc, out in started:
        fns[kernel][name] = _finish_compare_build(name, kernel, proc, out)
    if started:
        _log(f"build: {', '.join(f'{n} {k}' for n, k, _, _ in started)} "
             f"(to compare) done in {time.perf_counter() - t0:.2f} s")
    return fns


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


def _edge_rect(rng, rows: int, width: int, pat: bytes):
    """_random_rect, with lengths at the 16-byte chunk edges (16k - 1,
    16k, 16k + 1) in a third of the rows and ``pat`` planted across each
    chunk boundary, ending at the row's length, in another third."""
    rect, lens = _random_rect(rng, rows, width, pat)
    L = len(pat)
    edges = np.array(sorted({e + d for e in range(0, width + 1, 16)
                             for d in (-1, 0, 1) if 0 <= e + d <= width}))
    lens[0::3] = edges[rng.randint(0, len(edges), len(lens[0::3]))]
    starts = [b - j for b in range(16, width, 16) for j in range(1, L)
              if 0 <= b - j <= width - L]
    if starts:
        for k, r in enumerate(range(1, rows, 3)):
            s = starts[k % len(starts)]
            rect[r, s:s + L] = np.frombuffer(pat, np.uint8)
            lens[r] = s + L
    rect[np.arange(width)[None, :] >= lens[:, None]] = 0
    return rect, lens


def _at_offset(t, mis: int):
    """A contiguous copy of the 2-D tensor ``t`` whose base lies ``mis``
    bytes past a 16-byte boundary (a storage offset into a larger
    buffer)."""
    import torch
    buf = torch.zeros(t.numel() + 64, dtype=t.dtype, device=t.device)
    start = (mis - buf.data_ptr()) % 16
    out = buf[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    _check(out.is_contiguous() and out.data_ptr() % 16 == mis,
           f"could not place a tensor at base + {mis}")
    return out


def phase_exact() -> float:
    """rect_match against rect_match_reference on the card, exactly: every
    mode and edge case on a random 1,048,576 x 64 rectangle, every mode at
    the other widths (8 to 1024, and 24), lengths and planted patterns at
    the 16-byte chunk edges, and bases that are not 16-byte aligned.
    Returns the largest absolute difference seen (0)."""
    import torch
    from spark_rapids_tpu_torch.exprs.rect_match import (
        rect_match, rect_match_reference)
    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    rect, lens = _random_rect(rng, 1 << 20, 64, PATTERN)
    b = torch.from_numpy(rect).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    cases = [(b, ln, PATTERN, MODES)]
    cases += [(b, ln, p, (m,)) for m, p in (
        ("contains", b"ab"), ("locate", b"e"), ("equals", b""),
        ("locate", b""), ("contains", b""), ("startswith", b"x" * 64),
        ("contains", b"x" * 65), ("locate", b"y" * 65))]
    for rows, width in ((1000, 8), (777, 16), (5000, 32), (3, 128),
                        (0, 64), (3000, 256), (1000, 1024), (999, 24)):
        r2, l2 = _random_rect(rng, rows, width, b"abc")
        cases.append((torch.from_numpy(r2).to(dev),
                      torch.from_numpy(l2).to(dev), b"abc", MODES))
    for width, pat in ((64, PATTERN), (64, b"x" * 20), (256, b"ab" * 9),
                       (1024, b"abc" * 11)):
        r2, l2 = _edge_rect(rng, 4000, width, pat)
        cases.append((torch.from_numpy(r2).to(dev),
                      torch.from_numpy(l2).to(dev), pat, MODES))
    # unaligned bases: a storage offset of 3, and rows 1.. of W = 8 (8-byte
    # aligned only)
    cases.append((_at_offset(b[:100_000], 3), ln[:100_000], PATTERN, MODES))
    r8, l8 = _edge_rect(rng, 5001, 8, b"abc")
    b8 = torch.from_numpy(r8).to(dev)
    cases.append((b8[1:], torch.from_numpy(l8[1:]).to(dev), b"abc", MODES))
    checked, max_err = [], 0
    for bb, ll, p, modes in cases:
        for m in modes:
            got = rect_match(bb, ll, p, m)
            want = rect_match_reference(bb, ll, p, m)
            torch.cuda.synchronize()
            if len(want):
                max_err = max(max_err, int((got.to(torch.int64) - want.to(
                    torch.int64)).abs().max()))
            _check(got.dtype == want.dtype and torch.equal(got, want),
                   f"rect_match {m} {p[:8]!r} W={bb.shape[1]} base%16="
                   f"{bb.data_ptr() % 16} disagrees with its plain version")
            checked.append((m, len(p), int(bb.shape[1]),
                            bb.data_ptr() % 16,
                            int(want.to(torch.int64).sum())))
    _log(f"kernel rect_match: {len(checked)} cases exact "
         f"(mode, L, W, base%16, sum): {checked}")
    return float(max_err)


def _window(lens, W: int, L: int, mode: str):
    """Each row's window [lo, hi) (csrc/rect_match_row.cuh
    rect_row_window), as int64 tensors."""
    import torch
    n = lens.to(torch.int64)
    zero = torch.zeros_like(n)
    if L == 0 or L > W:
        return zero, zero
    if mode in ("contains", "locate"):
        c = n.clamp(max=W)
        return zero, torch.where(c >= L, c, zero)
    if mode == "startswith":
        return zero, torch.where(n >= L, zero + L, zero)
    if mode == "equals":
        return zero, torch.where(n == L, zero + L, zero)
    ok = (n >= L) & (n <= W)
    return torch.where(ok, n - L, zero), torch.where(ok, n, zero)


def rect_bound(b, ln, pat: bytes, mode: str) -> dict:
    """The least work one rect_match call needs on this data: the 32-byte
    sectors holding each row's window (cut at the end of the first match
    for contains and locate, where the scan stops), each read once, plus
    4P bytes of lengths and the output (P, or 4P for locate); and one byte
    compare per offset tested. ``ms`` is the larger of the bytes at the
    HBM rate and the compares at the 32-bit rate; ``ms_64`` the same with
    the sectors counted in aligned pairs (None for a base that is not
    64-byte aligned)."""
    import torch
    from spark_rapids_tpu_torch.exprs.rect_match import rect_match_reference
    P, W = b.shape
    L = len(pat)
    lo, hi = _window(ln, W, L, mode)
    tested = (hi > lo).to(torch.int64)
    if mode in ("contains", "locate") and 0 < L <= W:
        first = rect_match_reference(b, ln, pat, "locate").to(torch.int64)
        tested = torch.where(first > 0, first, (hi - L + 1).clamp(min=0))
        hi = torch.where(first > 0, first - 1 + L, hi)
    on = hi > lo
    start = b.data_ptr() % 32 + torch.arange(P, device=b.device) * W
    s0 = (start + lo) // 32
    s1 = (start + hi - 1) // 32
    mark = torch.zeros(2 * ((b.data_ptr() % 32 + P * W) // 64 + 2),
                       dtype=torch.bool, device=b.device)
    for k in range((W + 31) // 32 + 1):
        idx = s0 + k
        sel = on & (idx <= s1)
        mark[idx[sel]] = True
    rest = 4 * P + (4 if mode == "locate" else 1) * P
    nbytes = 32 * int(mark.sum()) + rest
    # the same at a 64-byte access granularity (the H100's, by the copy
    # test in phase_kernel_times): pairs of sectors
    nbytes_64 = 64 * int(mark.view(-1, 2).any(1).sum()) if b.data_ptr() % 64 \
        == 0 else None
    ops = int(tested.sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "ms": max(bytes_ms, ops_ms),
            "by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_64": None if nbytes_64 is None else nbytes_64 + rest,
            "ms_64": None if nbytes_64 is None else max(
                (nbytes_64 + rest) / HBM_BYTES_PER_S * 1e3, ops_ms),
            "whole_rows_bytes": P * W + rest}


def _device_rect(rows: int, width: int, seed: int, lo: int = 0,
                 hi: int = -1):
    """Random printable-ASCII rows made on the card from ``seed``, lengths
    uniform over [lo, hi] (hi -1: the width), zero past each length."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rect = torch.randint(32, 127, (rows, width), generator=g, device="cuda",
                         dtype=torch.uint8)
    lens = torch.randint(lo, (width if hi < 0 else hi) + 1, (rows,),
                         generator=g, device="cuda", dtype=torch.int32)
    rect.masked_fill_(
        torch.arange(width, device="cuda")[None, :] >= lens[:, None], 0)
    return rect, lens


def _timed_row(inputs, pat: bytes, mode: str, compare, label: str) -> dict:
    """kernel, the kernels to compare and plain ms, cold, beside the
    bound (averaged over ``inputs``, which are distinct)."""
    from spark_rapids_tpu_torch.exprs.rect_match import (
        rect_match, rect_match_reference)
    row = {}
    row["ms"], row["host_ms"] = _cold_ms(
        lambda b, ln: rect_match(b, ln, pat, mode), inputs, label)
    row["compare_ms"] = {
        name: _cold_ms(lambda b, ln, f=f: f(b, ln, pat, mode), inputs,
                       f"{label} {name}")[0]
        for name, f in compare.items()}
    row["plain_ms"], _ = _cold_ms(
        lambda b, ln: rect_match_reference(b, ln, pat, mode), inputs, label,
        rounds=1, reps=1)
    bounds = [rect_bound(b, ln, pat, mode) for b, ln in inputs]
    for k in ("bytes", "ops", "ms", "whole_rows_bytes", "bytes_64", "ms_64"):
        row["bound_" + k] = float(np.mean(
            [np.nan if x[k] is None else x[k] for x in bounds]))
    row["bound_by"] = bounds[0]["by"]
    return row


def _fmt(label: str, row: dict) -> str:
    other = "".join(f", {n} {ms:.4f}" for n, ms in row["compare_ms"].items())
    return (f"{label}: kernel {row['ms']:.4f} ms{other}, plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"({row['bound_bytes']:.0f} B in 32-byte sectors; "
            f"{row['bound_ms_64']:.4f} ms, {row['bound_bytes_64']:.0f} B in "
            f"64-byte pairs; whole rows {row['bound_whole_rows_bytes']:.0f} "
            f"B; {row['bound_ops']:.0f} compares), "
            f"{row['bound_ms'] / row['ms']:.0%} of bound; host "
            f"{row['host_ms']:.4f} ms a call")


def phase_kernel_times(batches, compare) -> dict:
    """rect_match timed with the L2 cold (COLD_BYTES of distinct inputs a
    run), beside its bound from the data, its plain version and the
    kernels to compare (``compare``: name -> launch function), each first
    held equal to the plain version on the first batch:

    - the main path: contains 'special' over q_comment's l_comment
      batches, one run over all of them (as the query reads them);
    - every mode on a random 1,048,576 x 64 rectangle;
    - contains at every width from 8 to 1024 (64 MiB rectangles);
    - the first 262,144 rows of the first batch warm in L2 and cold;
    - DRAM access granularity: contains over the same 64-byte rows with
      every length <= 16, in 17..32 and in 49..64, and two strided copies
      that ask for the same bytes in 32- and in 64-byte pieces."""
    import torch
    from spark_rapids_tpu_torch.exprs.rect_match import (
        rect_match, rect_match_reference)
    b0, l0 = batches[0]
    for name, f in compare.items():
        for m in MODES:
            _check(torch.equal(f(b0, l0, PATTERN, m),
                               rect_match_reference(b0, l0, PATTERN, m)),
                   f"{name} {m} disagrees with the plain version")
    out = {}
    main = _timed_row(batches, PATTERN, "contains", compare, "main path")
    P, W = batches[0][0].shape
    _log(_fmt(f"kernel rect_match main path, contains 'special' over "
              f"{len(batches)} l_comment batches of {P} x {W}, cold", main))
    out["main"] = main

    rng = np.random.RandomState(7)
    rect, lens = _random_rect(rng, 1 << 20, 64, PATTERN)
    inputs = _copies(torch.from_numpy(rect).cuda(),
                     torch.from_numpy(lens).cuda())
    out["per_mode"] = {}
    for m in MODES:
        out["per_mode"][m] = row = _timed_row(inputs, PATTERN, m, compare,
                                              f"mode {m}")
        _log(_fmt(f"kernel rect_match {m} 'special', random 1048576 x 64, "
                  f"{len(inputs)} copies, cold", row))
    del inputs

    out["per_width"] = {}
    for k, w in enumerate((8, 16, 32, 64, 128, 256, 512, 1024)):
        inputs = _copies(*_device_rect((64 << 20) // w, w, seed=100 + k))
        out["per_width"][w] = row = _timed_row(
            inputs, PATTERN, "contains", compare, f"width {w}")
        _log(_fmt(f"kernel rect_match contains 'special', random "
                  f"{(64 << 20) // w} x {w}, {len(inputs)} copies, cold",
                  row))
        del inputs

    # the kernel on a slice that fits the L2, warm (the same slice over and
    # over) against cold (distinct copies): how much of its time is DRAM
    small = (b0[:1 << 18], l0[:1 << 18])
    out["l2"] = {
        "warm_ms": _cold_ms(lambda b, ln: rect_match(b, ln, PATTERN,
                                                     "contains"),
                            [small], "warm slice", rounds=8)[0],
        "cold_ms": _cold_ms(lambda b, ln: rect_match(b, ln, PATTERN,
                                                     "contains"),
                            _copies(small[0].clone(), small[1].clone()),
                            "cold slice")[0]}
    _log(f"kernel rect_match contains 'special' over rows 0..262143 of the "
         f"first batch: {out['l2']['warm_ms']:.4f} ms warm in L2, "
         f"{out['l2']['cold_ms']:.4f} ms cold")
    out["granularity"] = {}
    base_rect, _ = _device_rect(1 << 20, 64, seed=200, lo=64, hi=64)
    for k, (lo, hi) in enumerate(((1, 16), (17, 32), (49, 64))):
        g = torch.Generator(device="cuda")
        g.manual_seed(300 + k)
        ln = torch.randint(lo, hi + 1, (1 << 20,), generator=g,
                           device="cuda", dtype=torch.int32)
        inputs = _copies(base_rect, ln)
        row = _timed_row(inputs, PATTERN, "contains", compare,
                         f"lengths {lo}..{hi}")
        out["granularity"][f"{lo}..{hi}"] = row
        _log(_fmt(f"kernel rect_match contains over the same 1048576 x 64 "
                  f"bytes, lengths {lo}..{hi}, cold", row))
        del inputs
    out["granularity"]["copy"] = _sector_copy_ms()
    return out


def _sector_copy_ms() -> dict:
    """The card's DRAM access granularity, by two runs of PyTorch's strided
    copy over one 256 MiB buffer, each with the same element count and the
    same contiguous 128 MiB output: the first 32 bytes of every 64-byte
    row, and the first 64 bytes of every 128-byte row. Both ask for half
    the buffer; the first in 32-byte pieces, one in each 64-byte segment.
    If the card read a 32-byte sector alone, the two would take the same
    time; if it fetches 64 bytes, the first moves 1.5x the bytes of the
    second."""
    import torch
    n = 1 << 22
    buf = torch.zeros(n * 8, dtype=torch.int64, device="cuda")
    dst = torch.empty(n * 4, dtype=torch.int64, device="cuda")
    halves = buf.view(n, 8)[:, :4]
    pairs = buf.view(n // 2, 16)[:, :8]
    sector = _cold_ms(lambda s: dst.view(n, 4).copy_(s), [(halves,)],
                      "32 of 64 bytes", rounds=4)[0]
    segment = _cold_ms(lambda s: dst.view(n // 2, 8).copy_(s), [(pairs,)],
                       "64 of 128 bytes", rounds=4)[0]
    _log(f"DRAM granularity: strided copy of 32 of every 64 bytes of "
         f"256 MiB {sector:.4f} ms; of 64 of every 128 bytes {segment:.4f} "
         f"ms (ratio {sector / segment:.3f}; 1.0 if a 32-byte sector is "
         "read alone, 1.5 if 64 bytes are fetched)")
    return {"sector_ms": sector, "segment_ms": segment}


#: the dense kernel's float sums against its plain version: |difference|
#: at most DENSE_TOL times the group's sum of magnitudes. The two add the
#: same values in different orders; each order's rounding error is at
#: most about (rows a group) x 2^-53 of that scale.
DENSE_TOL = 1e-12
#: the H100 SXM's float64 rate outside the tensor cores (NVIDIA data
#: sheet), for the dense kernel's additions
FP64_OPS_PER_S = 34e12
#: TPC-H Q1's ship-date cutoff
Q1_CUTOFF = np.datetime64("1998-12-01") - np.timedelta64(90, "D")


def _dense_case(rng, rows: int, cards, ncols: int, G: int, ints=False,
                dead=False, floats=False):
    """dense_groupby's arguments on the card: per key, codes into a batch
    dictionary of a random size below its card, a remap onto global codes
    and ~10% nulls; a keep mask (all False when ``dead``); value columns
    cycling float64, int64 and count-only (all int64 when ``ints``, all
    float64 when ``floats``), ~15% nulls."""
    import torch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    keys, remaps = [], []
    for c in cards:
        local = rng.randint(1, c + 1)
        remaps.append(t(rng.permutation(c)[:local].astype(np.int32)))
        keys.append((t(rng.randint(0, local, rows).astype(np.int32)),
                     t(rng.rand(rows) > 0.1)))
    keep = t(np.zeros(rows, bool) if dead else rng.rand(rows) > 0.2)
    values = []
    for j in range(ncols):
        valid = rng.rand(rows) > 0.15
        kind = 1 if ints else 0 if floats else j % 3
        if kind == 0:
            d = np.round(rng.uniform(-1e5, 1e5, rows), 2)
        elif kind == 1:
            d = rng.randint(-(1 << 40), 1 << 40, rows).astype(np.int64)
        else:
            d = None
        if d is not None:
            d[~valid] = 0
        values.append((None if d is None else t(d), t(valid)))
    return keys, remaps, list(cards), keep, values, G


def _q1_batch(host, batch_rows: int):
    """dense_groupby's arguments for q1's first batch, as the aggregate
    gives them: l_returnflag and l_linestatus codes, the ship-date keep
    mask, and the five distinct value columns of q1's aggregates
    (quantity, price, disc_price, charge, discount; count(*) is the
    occupancy)."""
    import torch
    from spark_rapids_tpu_torch.columnar import ColumnarBatch
    names = ["l_returnflag", "l_linestatus", "l_shipdate", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax"]
    b = ColumnarBatch.from_host(host.select(names).slice(0, batch_rows),
                                "cuda", 64)
    rf, ls, sd, qty, price, disc, tax = b.columns
    cutoff = int(Q1_CUTOFF.astype(np.int64))
    keep = (sd.data <= cutoff) & sd.validity
    disc_price = price.data * (1.0 - disc.data)
    charge = disc_price * (1.0 + tax.data)
    ok = price.validity & disc.validity & tax.validity
    values = [(qty.data, qty.validity), (price.data, price.validity),
              (disc_price, price.validity & disc.validity), (charge, ok),
              (disc.data, disc.validity)]
    cards = [len(rf.dictionary), len(ls.dictionary)]
    remaps = [torch.arange(c, dtype=torch.int32, device="cuda")
              for c in cards]
    return ([(rf.data, rf.validity), (ls.data, ls.validity)], remaps, cards,
            keep, values, 16)


def _dense_check(args, label: str) -> float:
    """dense_groupby against dense_groupby_reference on ``args``: counts
    and occupancy exactly, int64 sums exactly, float64 sums within
    DENSE_TOL of the group's scale (a sum that is not finite: the same
    value); a second launch gives the same bits. Returns the largest
    absolute float difference."""
    import torch
    from spark_rapids_tpu_torch.exec import dense_groupby as dg
    keys, remaps, cards, keep, values, G = args
    got = dg.dense_groupby(*args)
    again = dg.dense_groupby(*args)
    want = dg.dense_groupby_reference(*args)
    scale = dg.dense_groupby_reference(
        keys, remaps, cards, keep,
        [(None if d is None else d.abs(), v) for d, v in values], G).sums
    torch.cuda.synchronize()
    _check(torch.equal(got.occupancy, want.occupancy)
           and torch.equal(got.counts, want.counts),
           f"dense_groupby {label}: counts differ from the plain version")
    _check(torch.equal(got.occupancy, again.occupancy)
           and torch.equal(got.counts, again.counts),
           f"dense_groupby {label}: two launches counted differently")
    for a, c in zip(got.sums, again.sums):
        _check((a is None and c is None) or torch.equal(
            a.view(torch.int64), c.view(torch.int64)),
            f"dense_groupby {label}: two launches gave different bits")
    return _dense_sums_err(got, want, scale, label)


def _dense_sums_err(got, want, scale, label: str) -> float:
    import torch
    err = 0.0
    for a, b, sc in zip(got.sums, want.sums, scale):
        if a is None:
            _check(b is None, f"{label}: a count-only sum")
            continue
        if a.dtype == torch.int64:
            _check(torch.equal(a, b), f"dense_groupby {label}: int sums")
            continue
        fin = torch.isfinite(b)
        _check(torch.equal(a[~fin].nan_to_num(posinf=1, neginf=-1, nan=0),
                           b[~fin].nan_to_num(posinf=1, neginf=-1, nan=0))
               and torch.equal(a[~fin].isnan(), b[~fin].isnan()),
               f"dense_groupby {label}: sums that are not finite differ")
        diff = (a[fin] - b[fin]).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
        _check(bool((diff <= DENSE_TOL * sc[fin]).all()),
               f"dense_groupby {label}: float sums off by {err}")
    return err


def _one_group(args):
    """Every live row's keys in one group: valid, batch code 0."""
    import torch
    keys, remaps, cards, keep, values, G = args
    return ([(torch.zeros_like(c), torch.ones_like(v)) for c, v in keys],
            remaps, cards, keep, values, G)


def _row_per_group(rows: int, values_of):
    """One key of 63 values, row r in group r % 63: a warp's 32 rows in 32
    groups (G = 64)."""
    import torch
    codes = (torch.arange(rows, device="cuda") % 63).to(torch.int32)
    remap = torch.arange(63, dtype=torch.int32, device="cuda")
    keep = torch.ones(rows, dtype=torch.bool, device="cuda")
    return ([(codes, torch.ones_like(keep))], [remap], [63], keep,
            values_of, 64)


def _nonfinite(args, rng):
    """Float columns with -0.0 at 1% of the rows and NaN, +inf and -inf at
    a few rows each, in a few groups."""
    import torch
    keys, remaps, cards, keep, values, G = args
    out = []
    for d, v in values:
        if d is not None and d.dtype == torch.float64:
            d = d.clone()
            n = d.shape[0]
            idx = torch.from_numpy(rng.permutation(n)[:n // 100 + 9]).cuda()
            d[idx[9:]] = -0.0
            d[idx[0:3]] = float("nan")
            d[idx[3:6]] = float("inf")
            d[idx[6:9]] = float("-inf")
            d = torch.where(v, d, torch.zeros_like(d))
        out.append((d, v))
    return keys, remaps, cards, keep, out, G


def _unaligned(args):
    """Every array as a view whose base lies past a 16-byte boundary:
    bool arrays 3 bytes, int32 4, 8-byte values 8."""
    import torch
    keys, remaps, cards, keep, values, G = args

    def at(t):
        es = t.element_size()
        buf = torch.zeros(t.numel() + 64 // es, dtype=t.dtype,
                          device=t.device)
        start = ((3 if es == 1 else es) - buf.data_ptr()) % 16 // es
        out = buf[start:start + t.numel()]
        out.copy_(t)
        _check(out.data_ptr() % 16 == (3 if es == 1 else es),
               "could not place a view past a 16-byte boundary")
        return out
    return ([(at(c), at(v)) for c, v in keys], remaps, cards, at(keep),
            [(None if d is None else at(d), at(v)) for d, v in values], G)


def phase_dense_exact(q1_args, compare) -> float:
    """dense_groupby against its plain version on the card: G = 16 and 64,
    K = 1..8 value columns (float64/int64/count-only, and all int64),
    null keys and values, row counts off a warp's 32 rows and the grid's,
    all rows dead, no rows, every row in one group, a row per group, -0.0,
    NaN and +-inf, arrays at bases that are not 16-byte aligned, q1's first
    batch and the G = 64 timing shape; two launches must give the same
    bits. The kernels to compare are held to the plain version on q1's
    batch. Returns the largest absolute float difference."""
    from spark_rapids_tpu_torch.exec.dense_groupby import (
        dense_groupby_reference, kernel_shape)
    rng = np.random.RandomState(17)
    cases = []
    for G, cards in ((16, (3, 2)), (64, (4, 3, 2))):
        for K in range(1, 9):
            for ints in (False, True):
                rows = 262_144 + 7919 * K + (3 if ints else 0)
                cases.append((f"G={G} K={K} ints={ints} rows={rows}",
                              _dense_case(rng, rows, cards, K, G, ints)))
    cases.append(("G=64 one key card 63",
                  _dense_case(rng, 100_003, (63,), 4, 64)))
    cases.append(("G=16 four keys", _dense_case(rng, 50_001, (1, 1, 1, 1),
                                                 3, 16)))
    cases.append(("all rows dead", _dense_case(rng, 70_001, (3, 2), 3, 16,
                                               dead=True)))
    cases.append(("no rows", _dense_case(rng, 0, (3, 2), 3, 16)))
    shape = kernel_shape(16, 5)
    warps = shape["sms"] * shape["blocks_per_sm"] * shape["threads"] // 32
    for rows in (31, 33, 255, 257, 32 * warps - 1, 32 * warps + 1,
                 32 * warps * 7 + 17):
        cases.append((f"G=16 rows={rows} ({warps} warps of 32 rows)",
                      _dense_case(rng, rows, (3, 2), 5, 16, floats=True)))
    cases.append(("G=16 every row in one group", _one_group(
        _dense_case(rng, 300_001, (3, 2), 5, 16))))
    cases.append(("G=64 every row in one group", _one_group(
        _dense_case(rng, 300_001, (4, 3, 2), 5, 64, floats=True))))
    cases.append(("G=64 a row per group", _row_per_group(
        200_003, _dense_case(rng, 200_003, (1,), 5, 16)[4])))
    cases.append(("G=16 -0.0, NaN, +-inf", _nonfinite(
        _dense_case(rng, 200_003, (3, 2), 6, 16), rng)))
    cases.append(("G=64 -0.0, NaN, +-inf", _nonfinite(
        _dense_case(rng, 200_003, (4, 3, 2), 5, 64, floats=True), rng)))
    cases.append(("G=16 unaligned views", _unaligned(
        _dense_case(rng, 150_001, (3, 2), 6, 16))))
    cases.append(("G=64 unaligned views", _unaligned(
        _dense_case(rng, 150_001, (4, 3, 2), 5, 64, floats=True))))
    cases.append(("q1 batch", q1_args))
    cases.append(("G=64 timing shape", _g64_args(np.random.RandomState(64),
                                                 q1_args[3].shape[0])))
    err = max(_dense_check(a, label) for label, a in cases)
    _log(f"kernel dense_groupby: {len(cases)} cases equal to the plain "
         f"version (counts exact, int sums exact, float sums within "
         f"{DENSE_TOL:g} of the group's magnitude sum, sums that are not "
         f"finite equal, largest float difference {err:.3e}); two "
         "launches identical in every case: "
         + "; ".join(label for label, _ in cases))
    import torch
    for name, f in compare.items():
        keys, remaps, cards, keep, values, G = q1_args
        got = f(*q1_args)
        want = dense_groupby_reference(*q1_args)
        scale = dense_groupby_reference(
            keys, remaps, cards, keep,
            [(None if d is None else d.abs(), v) for d, v in values],
            G).sums
        torch.cuda.synchronize()
        _check(torch.equal(got.counts, want.counts)
               and torch.equal(got.occupancy, want.occupancy),
               f"{name} dense_groupby counts differ on q1's batch")
        _log(f"kernel dense_groupby {name}: equal to the plain version on "
             f"q1's batch (largest float difference "
             f"{_dense_sums_err(got, want, scale, name):.3e})")
    return err


def _g64_args(rng, rows: int):
    """The G = 64 timing shape: q1's batch rows, 3 keys of 4, 3 and 2
    values (every value in every batch, no nulls: 24 of the 60 group ids
    live), ~3% of the rows dead, 5 float64 columns without nulls."""
    import torch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    cards = [4, 3, 2]
    keys = [(t(rng.randint(0, c, rows).astype(np.int32)),
             t(np.ones(rows, bool))) for c in cards]
    remaps = [t(np.arange(c, dtype=np.int32)) for c in cards]
    values = [(t(np.round(rng.uniform(900.0, 105000.0, rows), 2)),
               t(np.ones(rows, bool))) for _ in range(5)]
    return keys, remaps, cards, t(rng.rand(rows) > 0.03), values, 64


def dense_bound(args) -> dict:
    """The least work one dense_groupby call needs on these inputs: each
    key's codes (4 B) and validity (1 B), the keep mask (1 B), each value
    column's 8 B and validity byte a row, its remaps, and the outputs
    written once; the additions done (a count for every live row and
    every valid live value, a sum for each valid live value). ``ms`` is
    the larger of the bytes at the HBM rate and the additions at the
    float64 rate."""
    keys, remaps, cards, keep, values, G = args
    p = int(keep.shape[0])
    nbytes = p * (5 * len(keys) + 1) + sum(4 * len(r) for r in remaps)
    ops = int(keep.sum())
    for d, v in values:
        nbytes += p * (1 + (8 if d is not None else 0))
        n = int((v & keep).sum())
        ops += n * (2 if d is not None else 1)
    nbytes += len(values) * G * 16 + G * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP64_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "ms": max(bytes_ms, ops_ms),
            "by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _clone_args(args):
    keys, remaps, cards, keep, values, G = args
    return ([(c.clone(), v.clone()) for c, v in keys],
            [r.clone() for r in remaps], cards, keep.clone(),
            [(None if d is None else d.clone(), v.clone())
             for d, v in values], G)


def _index_add_loop(gid, masked, valid64, occ_ones, G: int):
    """The library route: one index_add_ a sum and a count per column,
    and one for occupancy, into G + 1 slots (dead rows in the last)."""
    import torch
    out = []
    for m, v in zip(masked, valid64):
        if m is not None:
            out.append(torch.zeros(G + 1, dtype=m.dtype,
                                   device=m.device).index_add_(0, gid, m))
        out.append(torch.zeros(G + 1, dtype=torch.int64,
                               device=v.device).index_add_(0, gid, v))
    out.append(torch.zeros(G + 1, dtype=torch.int64,
                           device=gid.device).index_add_(0, gid, occ_ones))
    return out


def _shape_line(args) -> dict:
    """The instance's launch on this card for ``args``: threads a block,
    shared memory, blocks an SM, SMs, registers, and the grid."""
    from spark_rapids_tpu_torch.exec.dense_groupby import kernel_shape
    keys, _, _, keep, values, G = args
    sh = kernel_shape(G, len(values))
    warps = sh["threads"] // 32
    pieces = -(-int(keep.shape[0]) // 32)
    sh["grid"] = max(1, min(-(-pieces // warps),
                            sh["sms"] * sh["blocks_per_sm"]))
    _log(f"  dense_groupby<{G}> on {keep.shape[0]} rows, {len(keys)} keys, "
         f"{len(values)} columns: {sh['threads']} threads a block, "
         f"{sh['registers']} registers a thread, {sh['local_bytes']} local "
         f"bytes, {sh['smem_bytes']} B of shared memory, "
         f"{sh['blocks_per_sm']} blocks an SM "
         f"({sh['blocks_per_sm'] * warps} warps), grid {sh['grid']} on "
         f"{sh['sms']} SMs")
    return sh


def phase_dense_times(args, label: str, compare) -> dict:
    """dense_groupby on ``args``, timed with the L2 cold (distinct copies
    of the inputs, COLD_BYTES in all), beside its bound: the kernel and
    each kernel to compare in turns (kernel, others, others, kernel,
    kernel, others), its plain version, and a
    loop of index_add_ over the same columns (atomic, so its float sums
    vary from run to run: a yardstick only; its group ids and masked
    columns are made outside the timed window)."""
    import torch
    from spark_rapids_tpu_torch.exec import dense_groupby as dg
    b = dense_bound(args)
    n = max(2, -(-COLD_BYTES // b["bytes"]))
    inputs = [args] + [_clone_args(args) for _ in range(n - 1)]
    row = {"bound_ms": b["ms"], "bound_by": b["by"],
           "bound_bytes": b["bytes"], "bound_ops": b["ops"],
           "shape": _shape_line(args)}
    turns = {"kernel": []}
    turns.update({name: [] for name in compare})
    hosts = []
    order = [("kernel", dg.dense_groupby)] + list(compare.items())
    for who, f in order + order[::-1] + order:
        ms, host = _cold_ms(f, inputs, f"dense_groupby {label} {who}")
        turns[who].append(ms)
        if who == "kernel":
            hosts.append(host)
    row["ms"] = float(np.mean(turns["kernel"]))
    row["turns_ms"] = turns
    row["host_ms"] = float(np.mean(hosts))
    row["compare_ms"] = {name: float(np.mean(turns[name]))
                         for name in compare}
    row["plain_ms"], _ = _cold_ms(dg.dense_groupby_reference, inputs,
                                  f"dense_groupby {label} plain", rounds=1,
                                  reps=1)
    lib_inputs = []
    for keys, remaps, cards, keep, values, G in inputs:
        gid = torch.zeros(keep.shape[0], dtype=torch.int64, device="cuda")
        stride = 1
        for (codes, valid), remap, card in reversed(list(zip(keys, remaps,
                                                             cards))):
            g = torch.where(valid, remap[codes.long()].long(), card)
            gid += g * stride
            stride *= card + 1
        gid = torch.where(keep, gid, G)
        masked = [None if d is None else torch.where(v, d, 0)
                  for d, v in values]
        lib_inputs.append((gid, masked, [v.long() for _, v in values],
                           keep.long(), G))
    row["library_ms"], _ = _cold_ms(_index_add_loop, lib_inputs,
                                    f"{label} index_add_ loop")
    del lib_inputs, inputs
    keys, _, cards, keep, values, G = args
    others = "".join(f"; {name} {row['compare_ms'][name]:.4f} (turns "
                     f"{', '.join(f'{t:.4f}' for t in turns[name])})"
                     for name in compare)
    _log(f"kernel dense_groupby on {label} ({keep.shape[0]} rows, "
         f"{len(keys)} keys of cards {cards}, {len(values)} float64 "
         f"columns, G = {G}), cold: kernel {row['ms']:.4f} ms (turns "
         f"{', '.join(f'{t:.4f}' for t in turns['kernel'])}){others}; "
         f"plain "
         f"{row['plain_ms']:.4f}, index_add_ loop {row['library_ms']:.4f}, "
         f"bound {row['bound_ms']:.4f} ({row['bound_bytes']} B, "
         f"{row['bound_ops']} additions; by {row['bound_by']}), "
         f"{row['bound_ms'] / row['ms']:.0%} of bound; host "
         f"{row['host_ms']:.4f} ms a call; {n} input copies")
    return row


def _profile_host_encode(fn, label: str, top: int = 6) -> None:
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
    _log(f"host encode of {label}, self ms by call: " + "; ".join(
        f"{k[2]} ({k[0].rsplit('/', 1)[-1]}:{k[1]}) {t * 1e3:.1f} ms x{n}"
        for t, n, k in rows[:top]))


def _run_query(session, table, query):
    from spark_rapids_tpu_torch.api import functions as F
    t0 = time.perf_counter()
    rows = query(session.create_dataframe(table), F).collect()
    return rows, (time.perf_counter() - t0) * 1e3


def _device_time_us(e) -> float:
    """An event's self time on the card, under either of the names
    PyTorch has used for it."""
    for k in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, k, None)
        if v:
            return float(v)
    return 0.0


def _idle_share(spans, busy):
    """(window start, end, busy time, idle share): the window spans every
    interval of ``spans``; busy is the length of the union of ``busy``."""
    lo = min(s for s, _ in spans)
    hi = max(t for _, t in spans)
    union, end = 0.0, lo
    for s, t in sorted(busy):
        s = max(s, end)
        if t > s:
            union += t - s
            end = t
    return lo, hi, union, 1 - union / (hi - lo) if hi > lo else float("nan")


def _profile_report(prof, wall_ms: float, label: str, kernel: str) -> dict:
    """The top device operations of a profiled run, the hand-written
    kernel's share of device time (operations whose name holds
    ``kernel``), and the device's idle share of the profiled window (the
    union of its operations' intervals against the span of every
    event)."""
    from torch.autograd import DeviceType
    avg = prof.key_averages()
    dev = sorted(((_device_time_us(e), e.key, e.count) for e in avg
                  if _device_time_us(e) > 0), reverse=True)
    if not dev:
        _log("profile: key_averages() shows no device time; the CUDA-event "
             "numbers above stand")
        return {"device_time": False}
    total = sum(t for t, _, _ in dev)
    kern = sum(t for t, k, _ in dev if kernel in k)
    _log(f"profile of one warm {label} (wall {wall_ms:.1f} ms): "
         f"{len(dev)} device operations, {total / 1e3:.4f} ms of device "
         "time; top by time: " + "; ".join(
             f"{k[:70]} {t / 1e3:.4f} ms x{n} ({t / total:.0%})"
             for t, k, n in dev[:8]))
    spans, busy = [], []
    for e in prof.events():
        tr = getattr(e, "time_range", None)
        if tr is None:
            continue
        spans.append((tr.start, tr.end))
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            busy.append((tr.start, tr.end))
    lo, hi, union, idle = _idle_share(spans, busy)
    cpu = sorted(((e.self_cpu_time_total, e.key, e.count) for e in avg),
                 reverse=True)
    calls = {name: sum(e.count for e in avg if name in e.key)
             for name in ("cudaStreamSynchronize", "cudaMemcpyAsync",
                          "cudaLaunchKernel")}
    _log(f"profile: host calls in one warm {label}: " + ", ".join(
        f"{n} x{c}" for n, c in calls.items()))
    _log(f"profile: {kernel} {kern / 1e3:.4f} ms, {kern / total:.1%} of "
         f"device time; device busy {union / 1e3:.4f} ms of a "
         f"{(hi - lo) / 1e3:.4f} ms window, idle {idle:.1%}; top host self "
         "time: " + "; ".join(f"{k[:50]} {t / 1e3:.3f} ms x{n}"
                              for t, k, n in cpu[:6]))
    return {"device_time": True, "device_ms": total / 1e3,
            "kernel_ms": kern / 1e3, "kernel_share": kern / total,
            "window_ms": (hi - lo) / 1e3, "busy_ms": union / 1e3,
            "idle_share": idle, "host_calls": calls}


@contextlib.contextmanager
def _parent_operand_path():
    """The dense path's operand copies as commit 645412c made them: each
    key's remap copied from pageable memory with a stream wait, every
    batch; the group slots once a query."""
    from spark_rapids_tpu_torch.exec import aggregate as agg
    to_device, operand = agg._to_device, agg._device_operand
    agg._to_device = lambda t, dev: t.to(dev)
    agg._device_operand = lambda key, make: (
        make() if key[0] == "remap" else operand(key, make))
    agg._DEVICE_OPERANDS.clear()
    try:
        yield
    finally:
        agg._to_device, agg._device_operand = to_device, operand
        agg._DEVICE_OPERANDS.clear()


def phase_profile(session, host, query, right, label: str,
                  kernel: str) -> dict:
    """One warm run of ``query`` under torch.profiler: where its wall goes
    on the card. The result must satisfy ``right`` as any other run's;
    only reading the trace may fail without failing the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rows, wall = _run_query(session, host, query)
        torch.cuda.synchronize()
    _check(right(rows), f"{label} under the profiler: wrong result {rows}")
    try:
        return _profile_report(prof, wall, label, kernel)
    except Exception as e:  # the trace is read for information only
        _log(f"profile: could not be read ({e!r}); the CUDA-event numbers "
             "above stand")
        return {"device_time": False, "error": repr(e)}


# ---------------------------------------------------------------------------
# string predicates in filters and the memory runtime
# ---------------------------------------------------------------------------

def _measured(session, host, query, right, label: str) -> dict:
    """One run of ``query`` with its kernel launches (counts set to 0 just
    before, read just after), the memory manager's peak and spills, and
    the caching allocator's peaks; it fails on a wrong result."""
    import torch
    from spark_rapids_tpu_torch.exec.dense_groupby import dense_groupby
    from spark_rapids_tpu_torch.exprs.rect_match import rect_match
    mm = session.memory
    st0 = mm.stats()
    mm.reset_max_device_used()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rect_match.launches = 0
    dense_groupby.launches = 0
    rows, wall = _run_query(session, host, query)
    launches = {"rect_match": rect_match.launches,
                "dense_groupby": dense_groupby.launches}
    st = mm.stats()
    _check(right(rows), f"{label}: wrong result {rows[:4]}")
    return {"wall_ms": wall, "rows": len(rows), "launches": launches,
            "max_device_used": st["max_device_used"],
            "spill_to_host_bytes": st["spill_to_host_bytes"]
            - st0["spill_to_host_bytes"],
            "spill_to_disk_bytes": st["spill_to_disk_bytes"]
            - st0["spill_to_disk_bytes"],
            "disk_store": st["disk_store"],
            "budget": st["budget"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved(),
            "retry": session.last_retry_stats.as_dict()}


def _cold_warm(session, host, query, right, label: str) -> dict:
    out = {"cold": _measured(session, host, query, right, label),
           "warm": _measured(session, host, query, right, label)}
    c, w = out["cold"], out["warm"]
    _log(f"{label}: wall {c['wall_ms']:.1f} ms cold, {w['wall_ms']:.1f} ms "
         f"warm; launches {c['launches']} / {w['launches']}; manager "
         f"max_device_used {c['max_device_used']} B (budget {c['budget']}), "
         f"spilled to host {c['spill_to_host_bytes']} / "
         f"{w['spill_to_host_bytes']} B, to disk {c['spill_to_disk_bytes']} "
         f"/ {w['spill_to_disk_bytes']} B ({c['disk_store']}); "
         f"max_memory_allocated {c['max_memory_allocated']} / "
         f"{w['max_memory_allocated']} B, max_memory_reserved "
         f"{c['max_memory_reserved']} / {w['max_memory_reserved']} B; "
         f"retry {c['retry']}")
    return out


def _q18_partial_bytes(session, host) -> list:
    """The device bytes of each batch's partial of q18_agg's aggregate,
    from the same update the query runs."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
    agg = q18_agg(session.create_dataframe(host), F)._physical()
    while not isinstance(agg, TpuHashAggregateExec):
        agg = agg.children[0]
    agg._dicts = []
    return [agg._update(b).device_size_bytes()
            for b in agg.children[0].execute(session.exec_context())]


def phase_spill_rates(rows: int, spill_dir: str) -> dict:
    """MB/s of each tier move for a q18-shaped partial of ``rows`` groups
    on the card (int64 key, float64 sum, int64 count, live mask, each
    with validity): device to host (pinned, blocking), host to disk (the
    port's layout through the native slab store, into the page cache:
    no fsync), disk to device, host to device. Median of 3."""
    import torch
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, DeviceColumn
    from spark_rapids_tpu_torch.mem import MemoryManager, SpillableBatch
    from spark_rapids_tpu_torch.types import (BOOL, FLOAT64, INT64, Schema,
                                              StructField)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    cols = [DeviceColumn(torch.randint(0, 1 << 40, (rows,), device=dev,
                                       generator=g),
                         torch.ones(rows, dtype=torch.bool, device=dev),
                         INT64),
            DeviceColumn(torch.rand(rows, device=dev, dtype=torch.float64,
                                    generator=g),
                         torch.ones(rows, dtype=torch.bool, device=dev),
                         FLOAT64),
            DeviceColumn(torch.randint(1, 9, (rows,), device=dev,
                                       generator=g),
                         torch.ones(rows, dtype=torch.bool, device=dev),
                         INT64),
            DeviceColumn(torch.ones(rows, dtype=torch.bool, device=dev),
                         torch.ones(rows, dtype=torch.bool, device=dev),
                         BOOL)]
    schema = Schema([StructField(n, c.dtype, True) for n, c in
                     zip(("_k0", "_a0_0", "_a1_0", "__live"), cols)])
    batch = ColumnarBatch(cols, rows, schema)
    want = [c.data.cpu() for c in cols]
    mm = MemoryManager(1 << 40, 1 << 40, spill_dir)
    times = {"to_host": [], "to_disk": [], "disk_to_device": [],
             "host_to_device": []}
    for _ in range(3):
        sb = SpillableBatch(batch, mm)
        for leg, fn in (("to_host", sb.spill_to_host),
                        ("to_disk", sb.spill_to_disk),
                        ("disk_to_device", sb.get),
                        ("to_host", sb.spill_to_host),
                        ("host_to_device", sb.get)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[leg].append(time.perf_counter() - t0)
        back = sb.get()
        _check(all(torch.equal(b.data.cpu(), w) for b, w in
                   zip(back.columns, want)), "a spilled batch came back "
               "different")
        sb.close()
    nbytes = batch.device_size_bytes()
    out = {"bytes": nbytes, "rows": rows}
    for leg, ts in times.items():
        t = float(np.median(ts))
        out[leg] = {"ms": t * 1e3, "MB_per_s": nbytes / t / 1e6}
    _check(mm.audit_leaks() == [] and mm.device_used == 0,
           "the spill timing leaked")
    _log(f"spill of a {rows}-row q18-shaped partial ({nbytes} B): " + "; ".join(
        f"{leg} {v['ms']:.2f} ms = {v['MB_per_s']:.0f} MB/s"
        for leg, v in out.items() if isinstance(v, dict))
         + f" (disk store: {mm.stats()['disk_store']})")
    return out


def phase_injected_q1(session, host, want1, n_batches: int) -> dict:
    """q1 with 1 SplitAndRetryOOM injected into the update (the second
    batch's step: the ladder answers it with a pressure spill, which
    moves the first partial to the host) and 2 RetryOOMs into the merge
    (the first reserve after the update's: the first partial's move back
    to the card, absorbed where it reserves)."""
    mm = session.memory
    before = mm.injections_fired()
    mm.force_split_and_retry_oom(1, skip=1)
    mm.force_retry_oom(2, skip=n_batches - 1)
    try:
        run = _measured(session, host, q1, lambda r: q1_equal(r, want1),
                        "q1 under injected OOMs")
        fired = mm.injections_fired()
    finally:
        mm.clear_injections()
    fired = {k: fired[k] - before[k] for k in fired}
    _check(fired == {"retry": 2, "split": 1},
           f"the injected OOMs did not all fire: {fired}")
    _check(run["retry"]["pressure_spills"] == 1
           and run["spill_to_host_bytes"] > 0,
           f"the split did not reach the ladder: {run}")
    _check(run["launches"]["dense_groupby"] == n_batches + 1,
           f"q1 under injection launched dense_groupby "
           f"{run['launches']['dense_groupby']} times, expected "
           f"{n_batches + 1} (a batch's update ran twice)")
    _log(f"q1 SF1 under 2 injected RetryOOMs and 1 SplitAndRetryOOM: equal "
         f"to numpy; fired {fired}; RetryStats {run['retry']}; wall "
         f"{run['wall_ms']:.1f} ms; spilled to host "
         f"{run['spill_to_host_bytes']} B; launches {run['launches']}")
    return {"fired": fired, **run}


def phase_threads(conf, host, want1, want6) -> dict:
    """q6 and q1 on two threads of one session, with 1 and then 2 device
    permits: equal results, and never more holders than permits (the
    semaphore's diagnostics sampled every 0.2 ms)."""
    import threading
    from spark_rapids_tpu_torch.api import TorchSession
    out = {}
    for permits in (1, 2):
        s = TorchSession({**conf,
                          "spark.rapids.tpu.sql.concurrentTpuTasks": permits,
                          "spark.rapids.tpu.memory.leakDetection": True})
        results, errors, peak = {}, [], [0]
        done = threading.Event()

        def run(name, q, s=s, results=results, errors=errors):
            try:
                for _ in range(2):
                    results.setdefault(name, []).append(
                        _run_query(s, host, q))
            except BaseException as e:     # reported below
                errors.append(e)

        def sample(s=s, peak=peak, done=done):
            while not done.is_set():
                peak[0] = max(peak[0],
                              len(s.semaphore.diagnostics()["holders"]))
                time.sleep(0.0002)

        sampler = threading.Thread(target=sample)
        sampler.start()
        t0 = time.perf_counter()
        ths = [threading.Thread(target=run, args=("q1", q1)),
               threading.Thread(target=run, args=("q6", q6))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        wall = (time.perf_counter() - t0) * 1e3
        done.set()
        sampler.join(timeout=10)
        _check(not errors and not any(th.is_alive() for th in ths),
               f"two-thread phase failed: {errors!r}")
        for rows, _ in results["q1"]:
            _check(q1_equal(rows, want1), f"q1 on a thread: {rows}")
        for rows, _ in results["q6"]:
            _check(_rel(rows[0]["revenue"], want6) <= REL_TOL,
                   f"q6 on a thread: {rows}")
        d = s.semaphore.diagnostics()
        _check(1 <= peak[0] <= permits and not d["holders"],
               f"{peak[0]} holders at once with {permits} permits: {d}")
        s.close()
        out[permits] = {
            "wall_ms": wall, "max_holders": peak[0],
            "acquires": s.semaphore.acquires,
            "semaphore_wait_ms": s.semaphore.total_wait_s * 1e3,
            "q1_ms": [w for _, w in results["q1"]],
            "q6_ms": [w for _, w in results["q6"]]}
        _log(f"two threads (q1 x2, q6 x2) on one session, {permits} "
             f"permit(s): equal to numpy; wall {wall:.1f} ms; at most "
             f"{peak[0]} holder(s) at once; {s.semaphore.acquires} acquires, "
             f"{s.semaphore.total_wait_s * 1e3:.1f} ms waiting; q1 "
             f"{[round(w, 1) for w in out[permits]['q1_ms']]} ms, q6 "
             f"{[round(w, 1) for w in out[permits]['q6_ms']]} ms")
    return out


def phase_memory_slice(conf, table, host, n_batches: int) -> dict:
    """The slice's queries at SF1: q12_modes, q_comment_filter (kernel on
    and off), q18_agg without and with memory pressure; then the spill
    rates, q1 under injected OOMs, two threads on one session, and the
    leak audit."""
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.mem import MemoryManager
    session = TorchSession({**conf,
                            "spark.rapids.tpu.memory.leakDetection": True})
    out = {}
    want12 = q12_modes_numpy(table)
    out["q12_modes"] = _cold_warm(session, host, q12_modes,
                                  lambda r: rows_equal(r, want12),
                                  "q12_modes SF1")
    for run in out["q12_modes"].values():
        _check(run["launches"] == {"rect_match": 0,
                                   "dense_groupby": n_batches},
               f"q12_modes launches {run['launches']}")
    _log(f"q12_modes result {want12}")

    want_n, want_rev = q_comment_filter_numpy(table)

    def right_cf(r):
        return r[0]["n"] == want_n and _rel(r[0]["revenue"],
                                            want_rev) <= REL_TOL
    on = TorchSession({**conf, "spark.rapids.tpu.sql.pallas.enabled": True,
                       "spark.rapids.tpu.memory.leakDetection": True})
    out["q_comment_filter_on"] = _cold_warm(on, host, q_comment_filter,
                                            right_cf,
                                            "q_comment_filter SF1 kernel on")
    out["q_comment_filter_off"] = _cold_warm(session, host, q_comment_filter,
                                             right_cf,
                                             "q_comment_filter SF1 kernel off")
    for run in out["q_comment_filter_on"].values():
        _check(run["launches"]["rect_match"] == n_batches,
               f"q_comment_filter (on) launched rect_match "
               f"{run['launches']['rect_match']} times, expected "
               f"{n_batches}")
    for run in out["q_comment_filter_off"].values():
        _check(run["launches"]["rect_match"] == 0,
               "q_comment_filter (off) launched rect_match")
    _log(f"q_comment_filter result n {want_n} revenue {want_rev!r}")

    want18 = q18_agg_numpy(table)
    right18 = lambda r: rows_equal(r, want18)  # noqa: E731
    out["q18_agg"] = _cold_warm(session, host, q18_agg, right18,
                                "q18_agg SF1, default budget")
    parts = _q18_partial_bytes(session, host)
    budget = max(sum(parts) // 2, 2 * max(parts))
    _log(f"q18_agg: {len(want18)} rows; partials of {parts} B "
         f"({sum(parts)} B in all); pressured budget {budget} B, host "
         f"store {budget // 2} B")
    pressured = TorchSession({
        **conf, "spark.rapids.tpu.memory.hbm.limitBytes": budget,
        "spark.rapids.tpu.memory.host.spillStorageSize": budget // 2,
        "spark.rapids.tpu.memory.leakDetection": True})
    out["q18_agg_pressured"] = _cold_warm(pressured, host, q18_agg, right18,
                                          "q18_agg SF1 under pressure")
    for run in out["q18_agg_pressured"].values():
        _check(run["spill_to_host_bytes"] > 0
               and run["spill_to_disk_bytes"] > 0
               and run["max_device_used"] <= budget,
               f"q18_agg under pressure did not spill to both tiers "
               f"within the budget: {run}")
    out["q18_partial_bytes"] = parts
    out["q18_budget"] = budget
    pressured.close()
    out["spill_rates"] = phase_spill_rates(max(parts) // 29,
                                           session.memory.spill_dir)

    want1 = q1_numpy(table)
    out["q1_injected"] = phase_injected_q1(session, host, want1, n_batches)
    out["threads"] = phase_threads(conf, host, want1, q6_numpy(table))
    session.close()
    on.close()
    leaks = MemoryManager.audit_all_leaks()
    _check(leaks == [], f"leak audit: {leaks[:5]}")
    _log("leak audit at session close: no live device buffer registration")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", metavar="NAME=DIR", action="append",
                    default=[],
                    help="also build DIR/rect_match.cu and/or "
                    "DIR/dense_groupby.cu (another version of the kernel, "
                    "such as the parent commit's: rect_match with the same "
                    "launch signature, dense_groupby with that of commit "
                    "645412c) and time it beside the port's; repeatable")
    args = ap.parse_args(argv)
    compare = [c.split("=", 1) for c in args.compare]
    if any(len(c) != 2 for c in compare):
        ap.error("--compare takes NAME=DIR")
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
        from spark_rapids_tpu_torch.exec.dense_groupby import dense_groupby
        from spark_rapids_tpu_torch.exprs.rect_match import rect_match
        phase_device()
        compare = phase_build(compare)

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
        _profile_host_encode(lambda: ColumnarBatch.from_host(src, "cpu", 64),
                             "one l_comment batch")
        _check(isinstance(first.columns[0], ByteRectColumn)
               and first.columns[0].width == 64,
               f"l_comment ingested as {first.columns[0]!r}, not a "
               "64-byte rectangle")
        # every l_comment batch of the query, as its scan makes them
        comments = [(first.columns[0].data, first.columns[0].lengths)]
        for i in range(1, n_batches):
            c = ColumnarBatch.from_host(
                host.select(["l_comment"]).slice(i * batch_rows, batch_rows),
                "cuda", 64).columns[0]
            comments.append((c.data, c.lengths))
        del first

        max_err = phase_exact()
        times = phase_kernel_times(comments, compare["rect_match"])
        del comments
        q1_args = _q1_batch(host, batch_rows)
        dense_err = phase_dense_exact(q1_args, compare["dense_groupby"])
        dense_t = phase_dense_times(q1_args, "q1's batch",
                                    compare["dense_groupby"])
        del q1_args
        g64_args = _g64_args(np.random.RandomState(64), batch_rows)
        dense_t64 = phase_dense_times(g64_args, "the G = 64 shape",
                                      compare["dense_groupby"])
        del g64_args

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
        prof = phase_profile(
            on, host, q_comment,
            lambda r: r[0]["n"] == want_n
            and _rel(r[0]["revenue"], want_rev) <= REL_TOL,
            "q_comment (kernel on)", "rect_match")

        want1 = q1_numpy(table)
        dense_groupby.launches = 0
        rect_match.launches = 0
        rows, q1_cold = _run_query(session, host, q1)
        q1_launches = dense_groupby.launches
        _check(q1_launches == n_batches and rect_match.launches == 0,
               f"q1 launched dense_groupby {q1_launches} times, expected "
               f"{n_batches} (one per batch)")
        dense_groupby.launches = 0
        rows_warm, q1_warm = _run_query(session, host, q1)
        _check(dense_groupby.launches == n_batches,
               f"warm q1 launched dense_groupby {dense_groupby.launches} "
               "times")
        for r in (rows, rows_warm):
            _check(q1_equal(r, want1), f"q1 {r} != numpy {want1}")
        _log(f"q1 SF1: {len(rows)} groups equal to numpy (keys, order and "
             f"counts exact, sums and averages within {REL_TOL:g}): "
             f"{rows}; wall {q1_cold:.1f} ms cold, {q1_warm:.1f} ms warm; "
             f"dense_groupby launches {q1_launches} over {n_batches} "
             "batches")
        keys = host.select(["l_returnflag", "l_linestatus"])
        _profile_host_encode(
            lambda: ColumnarBatch.from_host(keys.slice(0, batch_rows), "cpu",
                                            64), "q1's key columns (one batch)")
        prof1 = phase_profile(session, host, q1,
                              lambda r: q1_equal(r, want1), "q1",
                              "dense_groupby")
        with _parent_operand_path():
            prof1_parent = phase_profile(
                session, host, q1, lambda r: q1_equal(r, want1),
                "q1 (the operand path of 645412c: each remap copied from "
                "pageable memory, waiting on the stream, every batch)",
                "dense_groupby")
        mem = phase_memory_slice(conf, table, host, n_batches)
        _log(json.dumps({"queries": {
            "q6": {"rows": SF1_ROWS, "wall_ms_cold": ms_cold,
                   "wall_ms_warm": ms_warm},
            "q_comment": {"rows": SF1_ROWS, "batches": n_batches,
                          "wall_ms_on_cold": on_cold,
                          "wall_ms_on_warm": on_warm,
                          "wall_ms_off_warm": off_warm,
                          "profile_on_warm": prof},
            "q1": {"rows": SF1_ROWS, "batches": n_batches, "groups":
                   len(rows), "wall_ms_cold": q1_cold,
                   "wall_ms_warm": q1_warm, "profile_warm": prof1,
                   "profile_warm_parent_operands": prof1_parent},
            **mem}}))
        main_t = times["main"]
        kernel = {
            "name": "rect_match", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/rect_match.cu",
            "replaces": "spark_rapids_tpu/exprs/pallas_rect.py:57",
            "launches": launches, "max_abs_err": max_err,
            "paths": {"q_comment": launches,
                      "q_comment_filter": mem["q_comment_filter_on"]["cold"][
                          "launches"]["rect_match"]},
            "exact": max_err == 0,
            "ms": main_t["ms"], "kernel_ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_ms_64": main_t["bound_ms_64"],
            "bound_by": main_t["bound_by"], "library_ms": None,
            "compare_ms": main_t["compare_ms"],
            "host_ms": main_t["host_ms"],
            "timing": "device time per launch, launches queued back to "
                      "back over distinct inputs (L2 cold)",
            "shape": list(map(int, (batch_rows, 64))),
            "per_mode": {m: {k: r[k] for k in ("ms", "compare_ms",
                                                "plain_ms", "bound_ms")}
                         for m, r in times["per_mode"].items()},
            "per_width": {str(w): {k: r[k] for k in ("ms", "compare_ms",
                                                      "plain_ms", "bound_ms")}
                          for w, r in times["per_width"].items()},
            "l2_slice": times["l2"],
            "granularity": {k: (r["ms"] if "ms" in r else r)
                            for k, r in times["granularity"].items()},
        }
        dense = {
            "name": "dense_groupby", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/dense_groupby.cu",
            "replaces": "spark_rapids_tpu/exec/aggregate.py:797",
            "launches": q1_launches, "max_abs_err": dense_err,
            "paths": {"q1": q1_launches,
                      "q12_modes": mem["q12_modes"]["cold"]["launches"][
                          "dense_groupby"],
                      "q1_injected": mem["q1_injected"]["launches"][
                          "dense_groupby"]},
            "tolerance": f"float sums within {DENSE_TOL:g} of the group's "
                         "sum of magnitudes; counts and int sums exact; "
                         "two launches bit-identical",
            "ms": dense_t["ms"], "plain_ms": dense_t["plain_ms"],
            "bound_ms": dense_t["bound_ms"], "bound_by": dense_t["bound_by"],
            "library_ms": dense_t["library_ms"],
            "library": "index_add_ loop (atomic, non-deterministic)",
            "host_ms": dense_t["host_ms"],
            "compare_ms": dense_t["compare_ms"],
            "turns_ms": dense_t["turns_ms"],
            "bound_bytes": dense_t["bound_bytes"],
            "timing": "device time per launch, launches queued back to "
                      "back over distinct inputs (L2 cold)",
            "shape": [batch_rows, 2, 5, 16],
            "launch": dense_t["shape"],
            "g64": {k: dense_t64[k] for k in (
                "ms", "turns_ms", "compare_ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes",
                "host_ms", "shape")},
        }
        _log(json.dumps({"kernels": [kernel, dense]}))
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
