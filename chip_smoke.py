#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--compare NAME=DIR ...]

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

  1. device  -- the card's name and power limit (nvidia-smi), CUDA version;
  2. build   -- every CUDA kernel of the port (rect_match, dense_groupby,
                join_match, distinct_flag, rect_transform, window_frame,
                sort_bucket, decimal_arith, rect_dfa), built from
                csrc/ with one nvcc each, started together;
                ptxas must report no stack frame and no spills for any
                function. ``--compare NAME=DIR`` also builds
                DIR/rect_match.cu, DIR/dense_groupby.cu,
                DIR/rect_transform.cu, DIR/window_frame.cu,
                DIR/sort_bucket.cu, DIR/decimal_arith.cu and/or
                DIR/rect_dfa.cu (another version of a kernel with its
                headers, e.g. an earlier commit's; dense_groupby with the
                C interface of commit 645412c) alongside, to be timed
                beside the port's (rect_transform, window_frame,
                sort_bucket, decimal_arith and rect_dfa in turns with
                it); rect_dfa with its class-indexed instance alone
                (kRdByteStates 0) is built beside the port's too;
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
                shared memory); join_match exactly equal to its plain
                version for every join type (about a million stream
                rows, two cases ending in a partial tile, against 100
                to 100,000 distinct build keys of 1-8 rows,
                one row, two rows or one key of 11,000 rows, 5% null
                keys, float keys with NaN and +-0.0, keys of 1-4 words:
                both launch routes, the table in shared memory and
                not), timed cold on q3's first join (one launch) and on
                100,000 build keys (count and emit) beside its bound;
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
                permits; the leak audit at session close;
  8. parquet -- lineitem written to Parquet by the script's own writer
                (numpy and zlib) and read by the port's reader, which
                needs no pyarrow (its host library is built with g++ at
                first use): q6, q1 and q_comment over the files equal the
                in-memory results exactly, with dense_groupby and
                rect_match once a batch; rung 1 (every ported arithmetic
                expression in one filter and projection) cold and warm
                against numpy; fault C1 at scale; row-group pruning of a
                l_shipdate range; the cold wall split (file read, host
                decode, string encode, copy, the rest) with the transfer
                encode on and off; PERFILE against MULTITHREADED; the
                host library's decode rate per encoding
                (``phase_parquet``); q12_in over the files too;
  9. gaps    -- (run before phase 7) q12_in (l_shipmode IN ('MAIL',
                'SHIP'), the dictionary route, dense_groupby once a batch)
                and q_extremes (count of l_comment, min/max/first/last of
                l_extendedprice and l_shipdate by l_returnflag, the sort
                path) cold and warm against numpy; (after phase 7) q18_agg
                under PR 5's budget through the aggregate's repartitioned
                merge;
 10. tpcds   -- TPC-DS q3 at SF10 (28,800,991 store_sales rows, the
                generator of benchmarks/tpcds.py copied in numpy), the
                broadcast plan (join_match twice a batch) and the shuffled
                plan (sub-partitioned), cold and warm, each equal to numpy
                and to the other, the broadcast plan once more under
                torch.profiler; store_sales joined with the whole item
                table as left, leftsemi and leftanti against numpy;
 11. tpcds2  -- distinct_flag bit-identical to its plain version on the
                card (NaN, +-0.0 and NULL values, a NULL group, float32
                and int8 keys, one key filling a batch, 2M distinct keys
                forcing two growths, keys repeating across batches, a
                batch of one row, repeated keys in every warp, batches
                of more rows than the kernel's grid has threads, 40
                batches queued behind a sleep with no synchronise, keys
                outgrowing the table twice; each case's slots, growths
                and launches printed), timed cold on q28's shape (the
                first batch against fresh tables, and the last against
                the table of the batches before it) beside its bound;
                its sizing and launch over q28's batches under PyTorch's
                sync debug mode "error" (no blocking host read); then
                TPC-DS q9 (CASE WHEN inside keyless aggregates over one
                widened batch) and q28 (six filtered aggregates in a
                union, run as one pass: a branch id through the dense
                route and count(DISTINCT) through distinct_flag, one
                launch a batch plus its growths, the table's final size
                and the peak allocation printed) at SF10 over phase 10's
                store_sales, cold and warm, against numpy, each once
                more under torch.profiler;
 13. strings -- (after phase 12) rect_transform bit-identical to its
                plain version on the card (every op alone, chains of 1-8
                ops, widths 8-64, nulls, 0x00 bytes inside lengths, 1, 3,
                31, 33 and 70,001 rows, replace and pad that grow,
                delimiters that overlap, chains past the cap refused by
                both) and on the rung's batch (1,048,576 x 32) and
                1,048,576-row batches 8 and 64 bytes wide (RT_TIMED),
                timed cold there beside its bound (and in turns with the
                versions of --compare); then bench.py's strings rung
                (upper(trim(s)), substring(s, 3, 4), grouped by both) at
                6,001,215 rows for 1,000 distinct s (a dictionary:
                rect_transform never launches) and 100,000 (a 32-byte
                rectangle: once a chain a batch, 12), cold, warm, with
                ORDER BY u and as SQL text, against numpy, and one warm
                run profiled.
 12. sql     -- SQL texts through TorchSession.sql over phase 4's SF1
                lineitem and phase 10's SF10 store_sales, date_dim and
                item as temp views (TPC-H q1 and q6, TPC-DS q3, a q9
                bucket and q28 as a UNION ALL of six SELECTs, a LIKE
                count with the match kernel on, a CTE/HAVING/ORDER BY/
                LIMIT text, INTERSECT and EXCEPT), each cold and warm,
                equal to numpy and to the DataFrame form of the same
                query in the same session (bit-equal where the plans
                agree up to the top Project), with each kernel's
                launches beside the DataFrame form's, the parse-and-
                lower time apart, the broadcast sides and the plans.
 14. windows -- (after phase 13) bench.py's window_bounded rung (sum(v)
                over ROWS BETWEEN 2 PRECEDING AND CURRENT ROW by p of
                512 values, ordered by o) at 6,001,215 rows in one
                batch, as a DataFrame and as SQL, every row
                bit-identical to numpy's row-order frame sums, cold,
                warm and profiled, window_frame once a run; window_frame
                alone on that batch (WF_TIMED: sum and max at W = 3;
                float sum, max, min, avg, count and int64 sum at W =
                101; a frame ahead of the row; the widest tiled frame
                and one past the tiled instance's halo), bit-identical
                to its plain version with the launch's own pick of
                instance and with each instance forced, timed cold
                beside its bound, each instance forced in turns, and in
                turns with the versions of --compare; over SF10
                store_sales by customer:
                row_number, lag and the RANGE-default running sum
                against numpy (exact cents), and q3's aggregate ranked
                within each year as SQL; ORDER BY ss_net_paid DESC,
                ss_item_sk over all of SF10 store_sales at the default
                512 MiB batchSizeBytes (the out-of-core sort, at least
                5 buckets, sort_bucket once a run), every column equal
                to numpy's stable sort, and sort_bucket alone on a run's
                operands at their own widths and on one operand, in
                turns with the versions of --compare and (one operand)
                torch.searchsorted.
 15. slice 9a -- (after phase 14) the math, date, cast, conditional,
                statistics and hash functions, rand, range and sample
                through the normal entry points, against numpy: (a)
                grouped statistics over SF1 lineitem (stddev_samp,
                var_pop, stddev_pop, avg of datediff, a CASE count and a
                rounded revenue by l_returnflag, l_linestatus, filtered
                on year and dayofweek) as a DataFrame and as SQL, cold
                and warm, dense_groupby twice a batch (the values, then
                each moment's value less its group's mean and its
                square), one warm run profiled;
                (b) a keyless SQL sum of sqrt, ln, exp, floor, ceil,
                round, CAST AS INT, quarter and dayofyear; (c) the
                wrapped sums of xxhash64 and hash against numpy's uint64
                forms, exactly; (d) stddev_samp and var_samp by
                ss_item_sk over SF10 store_sales (2,000 groups, the sort
                route); (e) sample(0.01, 42), rand(7) < 0.01 and
                max(monotonically_increasing_id()) over SF10 store_sales
                against RandomState(42), splitmix64 and n - 1; (f)
                range(0, 100,000,000) with the sum and stddev_pop of
                id % 7 against closed forms.
 16. slice 9b -- (after phase 15) list columns, collection and
                higher-order functions, generators and INTERSECT ALL /
                EXCEPT ALL through the normal entry points, against
                numpy. SF1 lineitem grouped by l_orderkey into nested
                orders (about 1.5 M rows, each with its l_quantity,
                l_extendedprice, l_discount and l_shipdate as lists in
                lineitem order; the width and device bytes printed),
                1,048,576-row batches: (a) keyless sums of size,
                array_max, element_at(.., -1), element_at(sort_array(..,
                false), 1), size(slice(.., 2, 3)), array_position and
                array_contains (in cents or counts: exact), and a count
                filtered on array_contains; (b) each order's
                aggregate(zip_with(price, discount, p * (1 - d)), 0D,
                acc + x) bit-equal to numpy's fold in element order,
                and size(filter(l_shipdate, ...)) and exists(l_quantity,
                ...) counts; (c) posexplode(l_extendedprice) grouped by
                pos (dense_groupby once a batch) and explode_outer over
                a list column with NULL and empty lists; (d) INTERSECT
                ALL and EXCEPT ALL of 1994's and 1995's (l_shipmode,
                l_quantity) lineitems as DataFrames and as SQL, the
                per-key counts against numpy's multisets (join_match
                launches printed). Each cold and warm; (a) and (c) once
                more under torch.profiler.
 17. maps and structs -- (after phase 16) slice 9b's map and struct
                half through the normal entry points at SF1, against
                numpy: (a) collect_list of l_quantity, l_linenumber (each
                lineitem's place in its order) and l_extendedprice and
                collect_set(l_quantity) by l_orderkey (about 1.5 M
                groups; lists in arrival order, sets sorted); (b) maps
                from (a)'s lists (map_from_arrays, create_map,
                map_concat of disjoint keys) and keyless sums of
                element_at, size(map_filter), array_max(map_keys), the
                values of transform_values and size(map_entries), in
                cents or counts: exact; (c) struct(l_quantity,
                l_extendedprice, l_discount, l_shipmode) over lineitem,
                filtered on get_field(s, "l_quantity") > 45, with
                keyless sums of its fields; (d) phase 16's orders with a
                map column o_lines (linenumber -> extendedprice, NULL
                and empty maps) at ingest: posexplode by pos
                (dense_groupby once a batch), explode by key (the sort
                route), explode_outer; (e) q1's groups with percentile,
                approx_percentile, min_by and max_by, each against
                Spark's definition in numpy; (f) the orders with o_lines
                and a struct column o_info ordered by o_totalprice DESC,
                o_orderkey out of core (sort_bucket launches and buckets
                printed), every row's map and struct equal after the
                sort; (g) percentile of l_extendedprice and l_quantity
                by l_orderkey at a 4 MiB batchSizeBytes: the partials
                of about 1.5 M groups outgrow it, so they and the value
                streams are hash-split alike and each partition merges,
                sorts and picks alone (partitions and buckets printed),
                every group equal to Spark's definition in numpy. Each
                cold and warm; (a) and (e) once more under
                torch.profiler.
 18. strings in lists -- (after phase 17) slice 9b's rest, first part:
                (a) words = split(l_comment, ' ') over SF1 lineitem, a
                byte rectangle [P, W, B] a batch: sum(size(words)), the
                rows where array_contains(words, 'special'), where
                exists(words, w -> w LIKE 'furious%'), the words LIKE
                '%ly' (filter), each equal to numpy's bytes.split(b' ')
                (rect_match at least three times a batch), and
                array_join(transform(words, w -> upper(w)), '-'): its
                lengths summed over SF1 and its first batch byte-equal
                (rect_transform once a batch); (b) by l_orderkey
                collect_list(l_shipmode), collect_set(l_shipinstruct),
                collect_list(struct(l_linenumber, l_quantity,
                l_shipmode)), max_by(l_shipmode, l_extendedprice), each
                list equal to numpy in arrival order; over them
                array_distinct, array_union, array_intersect,
                array_except against array('AIR', 'REG AIR'),
                array_remove, arrays_overlap, arrays_zip, concat_arrays
                with array_repeat, and a group-by on
                array_join(sort_array(array_distinct(modes)), ','); (c)
                phase 16's orders with o_modes (dictionary strings),
                o_comments (a 64-byte rectangle) and o_items (structs)
                at ingest, NULL and empty rows as its holes: posexplode
                by pos (dense_groupby once a batch), exists(o_comments,
                c -> c LIKE '%special%') (rect_match), explode(o_items)
                filtered on a field; (d) str_to_map of a per-row text of
                three pairs, grouped by element_at(m, 'mode'); (e) (c)'s
                orders ORDER BY o_orderkey DESC out of core (sort_bucket
                launches and buckets printed), every row's lists equal
                after the sort. Each cold and warm; (a) and (b) once
                more under torch.profiler.
 19. decimals -- (after phase 18) DecimalType as scaled int64 lanes:
                (a) TPC-H q1 and q6 unmodified over SF1 lineitem with
                l_quantity, l_extendedprice, l_discount and l_tax as
                decimal(15,2), in memory, over Parquet (INT64 with the
                DECIMAL type, the script's writer) and as the SQL texts
                of phase 12, each decimal total and average exact
                against numpy int64 over the unscaled values (Spark's
                types and HALF_UP), the double sums within REL_TOL
                (dense_groupby once a batch, decimal_arith launches
                printed); (b) TPC-DS q3 at SF10 with ss_ext_sales_price
                as decimal(7,2), in memory and over Parquet (INT32),
                exact (join_match launches printed); (c) phase 14's
                out-of-core ORDER BY keyed on ss_net_paid decimal(7,2)
                DESC (sort_bucket), equal to numpy's lexsort; (d)
                decimal_arith against its plain version bit for bit on
                1,048,576 rows of each function (q1's decimal(15,2) by
                decimal(16,2); decimal(38,10) / decimal(18,4) with
                overflows and zero divisors; decimal(38,0) + and %
                decimal(38,10), a rescale past int64; to_double at
                q1's own shape), timed with the L2 cold in turns with
                the versions of --compare, beside its bound, the plain
                version and (q1's to_double) torch's cast and divide;
                bit for bit on edge rows at every launch constant's
                boundary, from aligned and unaligned views; no integer
                division in its SASS (cuobjdump). Each query cold and
                warm.
 20. patterns -- (after phase 19) slice 7's patterns and string
                building: (a) rect_dfa against its plain version bit for
                bit on one SF1 l_comment batch (1,048,576 x 64) for
                TPC-H Q13's and Q16's LIKE patterns, a '_', an escaped
                '%', three RLIKE patterns, the empty ones and DFAs of
                66, 130 and 192 states, through the wrapper, the
                byte-indexed instance handed the class table, the
                class-indexed instance's own build and the versions of
                --compare, each timed with the L2 cold in turns with
                those builds beside its bound, the plain version and
                the host's ms a call, with its instance, states, classes,
                shared memory and registers; every version bit for bit
                on random rectangles 8 to 128 bytes wide with junk past
                the lengths; rect_dfa and rect_transform over a
                transposed (dense, not row-major) rectangle; (b)
                Q13's NOT LIKE '%special%requests%' (count and revenue)
                and Q16's LIKE '%Customer%Complaints%' over
                SF1 lineitem, as DataFrames and SQL (rect_dfa once a
                batch, rect_match never), and l_shipmode RLIKE
                '^(REG )?AIR$' over the dictionary (no rect_dfa), each
                against numpy, Q13 once more under torch.profiler; (c)
                concat(l_returnflag, '|', l_linestatus) grouped with
                count and sum, as a DataFrame and as SQL ||, and
                concat_ws('-', substring(l_comment, 1, 12), l_shipmode),
                translate, repeat, ascii, octet_length and chr over one
                batch, every value against numpy. Each cold and warm.

The data is generated here from a seed, with numpy only: this script
imports neither JAX, pyarrow, pandas nor the JAX package. It prints a
``{"kernels": [...]}`` line and ends with one JSON line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import decimal
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
#: the H100 SXM's float64 adds or compares a second outside the tensor
#: cores: 64 a clock on each of its 132 SMs at 1.98 GHz. (NVIDIA's data
#: sheet says 34 TFLOP/s, which counts a fused multiply-add as two
#: operations; a lone add or compare issues at half that.)
FP64_OPS_PER_S = 64 * 132 * 1.98e9
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
# TPC-DS: copies of benchmarks/tpcds.py (gen_store_sales, gen_date_dim,
# gen_item, q3) in numpy, the same seeds and draws
# ---------------------------------------------------------------------------

#: the H100's L2 cache
L2_BYTES = 50 << 20
#: store_sales rows at TPC-DS scale factor 10
SF10_STORE_SALES = 28_800_991
BRANDS = [f"brand#{i}" for i in range(1, 61)]


def gen_store_sales(n_rows: int, seed: int = 7, n_items: int = 2000,
                    n_dates: int = 1826) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "ss_sold_date_sk": rng.randint(0, n_dates, n_rows),
        "ss_item_sk": rng.randint(0, n_items, n_rows),
        "ss_customer_sk": rng.randint(0, n_rows // 8 + 2, n_rows),
        "ss_quantity": rng.randint(1, 101, n_rows),
        "ss_ext_sales_price": np.round(rng.uniform(1.0, 20000.0, n_rows), 2),
        "ss_ext_discount_amt": np.round(rng.uniform(0.0, 1000.0, n_rows), 2),
        "ss_net_paid": np.round(rng.uniform(1.0, 20000.0, n_rows), 2),
        "ss_net_profit": np.round(rng.uniform(-5000.0, 5000.0, n_rows), 2),
        "ss_list_price": np.round(rng.uniform(1.0, 200.0, n_rows), 2),
        "ss_coupon_amt": np.round(rng.uniform(0.0, 500.0, n_rows), 2),
        "ss_wholesale_cost": np.round(rng.uniform(1.0, 100.0, n_rows), 2),
    }


def gen_date_dim(n_dates: int = 1826, seed: int = 8) -> dict:
    days = np.arange(n_dates)
    dates = np.datetime64("1998-01-01") + days
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    moys = dates.astype("datetime64[M]").astype(int) % 12 + 1
    return {"d_date_sk": days, "d_date": dates.astype("datetime64[D]"),
            "d_year": years.astype(np.int32), "d_moy": moys.astype(np.int32)}


def gen_item(n_items: int = 2000, seed: int = 9) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "i_item_sk": np.arange(n_items),
        "i_brand_id": rng.randint(1, 61, n_items).astype(np.int32),
        "i_brand": np.array([BRANDS[b - 1] for b in
                             rng.randint(1, 61, n_items)], dtype=object),
        "i_manufact_id": rng.randint(1, 251, n_items).astype(np.int32),
    }


def q3(store_sales, date_dim, item, F, manufact_id: int = 128):
    """Brand revenue by year for one manufacturer, November only."""
    return (store_sales
            .join(date_dim.filter(F.col("d_moy") == F.lit(11)),
                  on=[("ss_sold_date_sk", "d_date_sk")])
            .join(item.filter(F.col("i_manufact_id") == F.lit(manufact_id)),
                  on=[("ss_item_sk", "i_item_sk")])
            .group_by("d_year", "i_brand_id", "i_brand")
            .agg(F.sum(F.col("ss_ext_sales_price")).with_name("sum_agg"))
            .order_by("d_year", F.desc("sum_agg"), "i_brand_id"))


def q3_numpy(ss: dict, dd: dict, it: dict, manufact_id: int = 128) -> list:
    """q3's rows from the arrays: the two filters as lookup tables over the
    keys, each group's sum by np.add.at in row order, q3's ORDER BY."""
    year = np.full(len(dd["d_date_sk"]), -1, np.int64)
    nov = dd["d_moy"] == 11
    year[dd["d_date_sk"][nov]] = dd["d_year"][nov]
    item = np.full(len(it["i_item_sk"]), -1, np.int64)
    sel = it["i_manufact_id"] == manufact_id
    item[it["i_item_sk"][sel]] = np.flatnonzero(sel)
    y = year[ss["ss_sold_date_sk"]]
    i = item[ss["ss_item_sk"]]
    keep = (y >= 0) & (i >= 0)
    y, i, p = y[keep], i[keep], ss["ss_ext_sales_price"][keep]
    # a group is (year, brand id, brand): items of one brand merge
    bid = it["i_brand_id"].astype(np.int64)
    _, bcode = np.unique(it["i_brand"].astype(str), return_inverse=True)
    code = (y * 61 + bid[i]) * len(BRANDS) + bcode[i]
    groups, gid = np.unique(code, return_inverse=True)
    sums = np.zeros(len(groups))
    np.add.at(sums, gid, p)
    first = np.zeros(len(groups), np.int64)
    first[gid[::-1]] = np.arange(len(gid))[::-1]
    rows = [{"d_year": int(y[f]), "i_brand_id": int(bid[i[f]]),
             "i_brand": str(it["i_brand"][i[f]]), "sum_agg": float(s)}
            for f, s in zip(first, sums)]
    rows.sort(key=lambda r: (r["d_year"], -r["sum_agg"], r["i_brand_id"]))
    return rows


def q3_equal(got: list, want: list, rel: float = REL_TOL) -> bool:
    """Same rows in the same order: keys exactly, sum_agg within ``rel``
    (the rows reach the sum in another order)."""
    return len(got) == len(want) and all(
        (g["d_year"], g["i_brand_id"], g["i_brand"])
        == (w["d_year"], w["i_brand_id"], w["i_brand"])
        and _rel(g["sum_agg"], w["sum_agg"]) <= rel
        for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# a Parquet writer of the script's own (numpy and zlib; the card's machine
# has no pyarrow)
# ---------------------------------------------------------------------------

#: TPC-H l_shipinstruct's four values (spec 4.2.3)
_SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN")
#: the share of l_partkey left null: the files' one nullable column
PARTKEY_NULLS = 0.01


def gen_parquet_extra(n_rows: int, seed: int = SEED + 2) -> dict:
    """Two lineitem columns that only the Parquet files carry:
    ``l_partkey`` (SF1's 200,000 parts, 1% null, as a masked array) and
    ``l_shipinstruct`` (the fourth low-cardinality string)."""
    rng = np.random.RandomState(seed)
    part = rng.randint(1, 200_001, n_rows).astype(np.int64)
    null = rng.rand(n_rows) < PARTKEY_NULLS
    return {"l_partkey": np.ma.MaskedArray(np.where(null, 0, part),
                                           mask=null),
            "l_shipinstruct": rng.choice(_SHIPINSTRUCT, n_rows)}


class _Thrift:
    """Thrift compact-protocol writer: a struct is a list of (field id,
    kind, value), kind one of "i32", "i64", "bin", "bool", "struct",
    ("list", element kind)."""

    _TYPE = {"bool": 1, "i32": 5, "i64": 6, "bin": 8, "struct": 12}

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def value(self, kind, v) -> None:
        if kind in ("i32", "i64"):
            self.varint((v << 1) ^ (v >> 63))
        elif kind == "bin":
            self.varint(len(v))
            self.out += v
        elif kind == "struct":
            self.struct(v)
        else:                                   # ("list", element kind)
            ek = kind[1]
            n = len(v)
            et = self._TYPE[ek]
            if n < 15:
                self.out.append((n << 4) | et)
            else:
                self.out.append(0xF0 | et)
                self.varint(n)
            for x in v:
                self.value(ek, x)

    def struct(self, fields) -> None:
        last = 0
        for fid, kind, v in fields:
            t = 1 if kind == "bool" and v else 2 if kind == "bool" \
                else 9 if isinstance(kind, tuple) else self._TYPE[kind]
            if 0 < fid - last <= 15:
                self.out.append(((fid - last) << 4) | t)
            else:
                self.out.append(t)
                self.varint((fid << 1) ^ (fid >> 63))
            last = fid
            if kind != "bool":
                self.value(kind, v)
        self.out.append(0)


def _thrift(fields) -> bytes:
    w = _Thrift()
    w.struct(fields)
    return bytes(w.out)


def _bitpacked(values: np.ndarray, width: int) -> bytes:
    """``values`` as one bit-packed run of the RLE/bit-packed hybrid (the
    last group padded to 8 values)."""
    n = len(values)
    groups = -(-n // 8)
    v = np.zeros(groups * 8, np.uint32)
    v[:n] = values
    bits = ((v[:, None] >> np.arange(width, dtype=np.uint32)) & 1) \
        .astype(np.uint8).reshape(-1)
    w = _Thrift()
    w.varint((groups << 1) | 1)
    return bytes(w.out) + np.packbits(bits, bitorder="little").tobytes()


def _byte_array_plain(s: np.ndarray) -> bytes:
    """PLAIN BYTE_ARRAY of an ``S`` array: a 4-byte length, then the
    bytes, per value (vectorised in chunks of rows)."""
    n, k = len(s), s.dtype.itemsize
    lens = np.char.str_len(s).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(4 + lens)[:-1]]) \
        if n else np.zeros(0, np.int64)
    out = np.zeros(int((4 + lens).sum()), np.uint8)
    for b in range(4):
        out[starts + b] = (lens >> (8 * b)) & 0xFF
    raw = np.ascontiguousarray(s).view(np.uint8).reshape(n, k)
    col = np.arange(k)
    for lo in range(0, n, 1 << 16):
        hi = min(lo + (1 << 16), n)
        keep = col[None, :] < lens[lo:hi, None]
        dest = (starts[lo:hi, None] + 4 + col[None, :])[keep]
        out[dest] = raw[lo:hi][keep]
    return out.tobytes()


def _gzip(b: bytes) -> bytes:
    import zlib
    c = zlib.compressobj(6, zlib.DEFLATED, 31)     # 31: the gzip format
    return c.compress(b) + c.flush()


# physical types, converted types, encodings, page kinds
_PQ_INT32, _PQ_INT64, _PQ_DOUBLE, _PQ_BYTE_ARRAY = 1, 2, 5, 6
_PQ_UTF8, _PQ_DECIMAL, _PQ_DATE = 0, 5, 6
_PQ_PLAIN, _PQ_RLE, _PQ_RLE_DICT = 0, 3, 8


def _parquet_column(name: str, values):
    """(physical type, converted type, encoding, nullable, PLAIN values
    or dictionary + indices, validity, statistics) of a lineitem
    column."""
    valid = None
    if isinstance(values, DecCol):
        # Spark's layout: precision up to 9 as INT32, up to 18 as INT64
        small = values.precision <= 9
        return dict(ptype=_PQ_INT32 if small else _PQ_INT64,
                    conv=_PQ_DECIMAL, enc=_PQ_PLAIN,
                    values=values.unscaled.astype("<i4" if small else "<i8"),
                    valid=valid, decimal=(values.precision, values.scale))
    if isinstance(values, np.ma.MaskedArray):
        valid = ~np.ma.getmaskarray(values)
        values = values.data
    kind = values.dtype.kind
    if kind == "M":
        return dict(ptype=_PQ_INT32, conv=_PQ_DATE, enc=_PQ_PLAIN,
                    values=values.astype("datetime64[D]").astype(np.int64)
                    .astype("<i4"), valid=valid)
    if kind == "f":
        return dict(ptype=_PQ_DOUBLE, conv=None, enc=_PQ_PLAIN,
                    values=values.astype("<f8"), valid=valid)
    if kind == "i":
        return dict(ptype=_PQ_INT64, conv=None, enc=_PQ_PLAIN,
                    values=values.astype("<i8"), valid=valid)
    if kind == "U":                          # a low-cardinality string
        uniq, idx = np.unique(values, return_inverse=True)
        return dict(ptype=_PQ_BYTE_ARRAY, conv=_PQ_UTF8, enc=_PQ_RLE_DICT,
                    dictionary=np.char.encode(uniq, "utf-8"),
                    values=idx.astype(np.uint32), valid=valid)
    if kind == "S":
        return dict(ptype=_PQ_BYTE_ARRAY, conv=_PQ_UTF8, enc=_PQ_PLAIN,
                    values=values, valid=valid)
    raise TypeError(f"{name}: {values.dtype}")


def _column_chunk(spec: dict, lo: int, hi: int, page_rows: int, v2: bool,
                  gzip: bool, offset: int):
    """(chunk bytes, ColumnMetaData fields) of rows lo..hi."""
    pages, chunk = [], bytearray()
    valid = spec["valid"][lo:hi] if spec["valid"] is not None else None
    vals = spec["values"][lo:hi]
    enc = spec["enc"]
    dict_off = None
    total_unc = 0
    if enc == _PQ_RLE_DICT:
        d = spec["dictionary"]
        width = max(1, int(len(d) - 1).bit_length())
        body = _byte_array_plain(d)
        comp = _gzip(body) if gzip else body
        head = _thrift([(1, "i32", 2), (2, "i32", len(body)),
                        (3, "i32", len(comp)),
                        (7, "struct", [(1, "i32", len(d)),
                                       (2, "i32", _PQ_PLAIN)])])
        dict_off = offset
        chunk += head + comp
        total_unc += len(head) + len(body)
    data_off = offset + len(chunk)
    for p in range(lo, hi, page_rows):
        q = min(p + page_rows, hi)
        pv = vals[p - lo:q - lo]
        pvalid = valid[p - lo:q - lo] if valid is not None else None
        dense = pv if pvalid is None else pv[pvalid]
        if enc == _PQ_RLE_DICT:
            values = bytes([width]) + _bitpacked(dense, width)
        elif spec["ptype"] == _PQ_BYTE_ARRAY:
            values = _byte_array_plain(dense)
        else:
            values = np.ascontiguousarray(dense).tobytes()
        levels = b""
        if pvalid is not None:
            levels = _bitpacked(pvalid.astype(np.uint32), 1)
        n, nulls = q - p, 0 if pvalid is None else int((~pvalid).sum())
        if v2:
            comp = _gzip(values) if gzip else values
            body = levels + comp
            head = _thrift([(1, "i32", 3),
                            (2, "i32", len(levels) + len(values)),
                            (3, "i32", len(body)),
                            (8, "struct", [(1, "i32", n), (2, "i32", nulls),
                                           (3, "i32", n), (4, "i32", enc),
                                           (5, "i32", len(levels)),
                                           (6, "i32", 0),
                                           (7, "bool", gzip)])])
            total_unc += len(head) + len(levels) + len(values)
        else:
            if pvalid is not None:
                levels = len(levels).to_bytes(4, "little") + levels
            plain = levels + values
            body = _gzip(plain) if gzip else plain
            head = _thrift([(1, "i32", 0), (2, "i32", len(plain)),
                            (3, "i32", len(body)),
                            (5, "struct", [(1, "i32", n), (2, "i32", enc),
                                           (3, "i32", _PQ_RLE),
                                           (4, "i32", _PQ_RLE)])])
            total_unc += len(head) + len(plain)
        chunk += head + body
    stats = [(3, "i64", 0 if valid is None else int((~valid).sum()))]
    if spec["ptype"] != _PQ_BYTE_ARRAY and len(vals):
        live = vals if valid is None else vals[valid]
        if len(live):
            stats += [(5, "bin", live.max().tobytes()),
                      (6, "bin", live.min().tobytes())]
    encs = sorted({enc, _PQ_RLE} | ({_PQ_PLAIN} if dict_off is not None
                                     else set()))
    meta = [(1, "i32", spec["ptype"]), (2, ("list", "i32"), encs),
            (3, ("list", "bin"), [spec["name"].encode()]),
            (4, "i32", 2 if gzip else 0), (5, "i64", hi - lo),
            (6, "i64", total_unc), (7, "i64", len(chunk)),
            (9, "i64", data_off)]
    if dict_off is not None:
        meta.append((11, "i64", dict_off))
    meta.append((12, "struct", stats))
    return bytes(chunk), meta


def write_parquet(path: str, table: dict, group_rows: int, v2: bool = False,
                  gzip: bool = False, page_rows: int = 1 << 18) -> int:
    """Write ``table`` (name -> numpy array; a masked array is a nullable
    column with definition levels) as one Parquet file of row groups of
    ``group_rows`` rows: PLAIN numbers and dates (INT64, DOUBLE, INT32
    DATE; a ``DecCol`` as INT32 or INT64 with the DECIMAL converted and
    logical types), RLE_DICTIONARY for ``U`` strings, PLAIN BYTE_ARRAY for ``S``
    strings, data pages v1 or v2 of ``page_rows`` rows, UNCOMPRESSED or
    GZIP, min/max statistics for fixed-width columns. Returns the
    number of row groups."""
    names = list(table)
    rows = len(table[names[0]])
    specs = []
    for name in names:
        spec = _parquet_column(name, table[name])
        spec["name"] = name
        specs.append(spec)
    groups = []
    with open(path, "wb") as f:
        f.write(b"PAR1")
        pos = 4
        for lo in range(0, rows, group_rows):
            hi = min(lo + group_rows, rows)
            chunks, size = [], 0
            for spec in specs:
                data, meta = _column_chunk(spec, lo, hi, page_rows, v2,
                                           gzip, pos)
                f.write(data)
                chunks.append([(2, "i64", pos), (3, "struct", meta)])
                pos += len(data)
                size += len(data)
            groups.append([(1, ("list", "struct"), chunks),
                           (2, "i64", size), (3, "i64", hi - lo)])
        schema = [[(4, "bin", b"schema"), (5, "i32", len(specs))]]
        for spec in specs:
            el = [(1, "i32", spec["ptype"]),
                  (3, "i32", 1 if spec["valid"] is not None else 0),
                  (4, "bin", spec["name"].encode())]
            if spec["conv"] is not None:
                el.append((6, "i32", spec["conv"]))
            if "decimal" in spec:
                # the DECIMAL converted type's scale and precision, and the
                # logical type (union member 5: {1: scale, 2: precision})
                prec, scale = spec["decimal"]
                el += [(7, "i32", scale), (8, "i32", prec),
                       (10, "struct", [(5, "struct", [(1, "i32", scale),
                                                      (2, "i32", prec)])])]
            schema.append(el)
        footer = _thrift([(1, "i32", 1), (2, ("list", "struct"), schema),
                          (3, "i64", rows),
                          (4, ("list", "struct"), groups),
                          (6, "bin", b"spark_rapids_tpu chip_smoke.py")])
        f.write(footer + len(footer).to_bytes(4, "little") + b"PAR1")
    return len(groups)


def write_lineitem_parquet(table: dict, out_dir: str, files: int = 6,
                           prune_group_rows: int = 1 << 16,
                           batch_rows: int = 1 << 20) -> dict:
    """The lineitem table as ``files`` files of one row group each,
    rows i * batch_rows onwards (so the files are the in-memory scan's
    batches), data pages v1 and v2 in turn, the last file in GZIP; and
    one file sorted by l_shipdate in row groups of ``prune_group_rows``
    (for pruning). Returns {"files": [(path, first row, end row)],
    "prune": (path, 0, rows), "prune_order": the sort permutation}."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    rows = len(next(iter(table.values())))
    step = max(batch_rows, -(-rows // files))
    out = {"files": []}
    for i in range(files):
        lo, hi = i * step, min((i + 1) * step, rows)
        if lo >= hi:
            break
        path = os.path.join(out_dir, f"lineitem-{i}.parquet")
        write_parquet(path, {k: v[lo:hi] for k, v in table.items()},
                      group_rows=hi - lo, v2=bool(i % 2),
                      gzip=i == files - 1)
        out["files"].append((path, lo, hi))
    order = np.argsort(table["l_shipdate"], kind="stable")
    path = os.path.join(out_dir, "lineitem-sorted.parquet")
    write_parquet(path, {k: v[order] for k, v in table.items()},
                  group_rows=prune_group_rows)
    out["prune"] = (path, 0, rows)
    out["prune_order"] = order
    return out


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
    rect_match.cu, dense_groupby.cu, rect_transform.cu, window_frame.cu,
    sort_bucket.cu, decimal_arith.cu and/or rect_dfa.cu with their
    headers: the parent commit's, or a variant), started now and built
    like the port's own into build/. Returns [(name, kernel, process,
    library, source directory)]."""
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
            stderr=subprocess.STDOUT, text=True), out, src.parent))
    _check(bool(started), f"no kernel source of {', '.join(KERNELS)} in "
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


def _rect_transform_compare(name, lib):
    """rect_transform_launch of another build (the C signature and the
    RtChain packing of the port's), with rect_transform's arguments (no
    launch count: it is not on the port's path)."""
    import ctypes

    import torch
    from spark_rapids_tpu_torch.exec import rect_transform as rt
    fn = lib.rect_transform_launch
    fn.argtypes = rt._ARGTYPES
    fn.restype = ctypes.c_int
    lib.rect_transform_chain_bytes.restype = ctypes.c_int
    _check(lib.rect_transform_chain_bytes() == rt._CHAIN_BYTES,
           f"{name} rect_transform packs its chain in another layout")

    def other(b, ln, v, ops, cap):
        widths = rt.chain_widths(ops, b.shape[1], cap)
        chain = rt.pack_chain(ops, widths)
        p = b.shape[0]
        out = torch.empty((p, widths[-1]), dtype=torch.uint8, device=b.device)
        out_len = torch.empty(p, dtype=torch.int32, device=b.device)
        rc = fn(b.data_ptr(), ln.data_ptr(), v.data_ptr(), p, widths[0],
                widths[-1], chain.ctypes.data, out.data_ptr(),
                out_len.data_ptr(),
                torch.cuda.current_stream(b.device).cuda_stream)
        _check(rc == 0, f"{name} rect_transform launch failed: CUDA error "
                        f"{rc}")
        return out, out_len
    return other


def _window_frame_compare(name, lib):
    """window_frame_launch of another build (the C signature of the
    port's; commit 8a644d5's has it), with window_frame's
    arguments and that build's own pick of instance (no launch count: it
    is not on the port's path)."""
    import ctypes

    import torch
    from spark_rapids_tpu_torch.exec import window_frame as wf
    fn = lib.window_frame_launch
    fn.argtypes = wf._ARGTYPES
    fn.restype = ctypes.c_int

    def other(values, valid, flags, lo, hi, op):
        n = values.shape[0]
        out = torch.empty(n, dtype=wf._out_dtype(values, op),
                          device=values.device)
        ok = torch.empty(n, dtype=torch.bool, device=values.device)
        rc = fn(values.data_ptr(), valid.data_ptr(), flags.data_ptr(),
                out.data_ptr(), ok.data_ptr(), n, wf._clamp(lo, n),
                wf._clamp(hi, n), wf.OPS[op],
                int(values.is_floating_point()), wf.SEARCHES["frame"],
                torch.cuda.current_stream(values.device).cuda_stream)
        _check(rc == 0, f"{name} window_frame launch failed: CUDA error "
                        f"{rc}")
        return out, ok
    return other


def _sort_bucket_compare(name, lib):
    """sort_bucket_launch of another build (the C signature and the
    SbOperands packing of the port's; commit 8a644d5's has them),
    with sort_bucket's arguments (no launch count)."""
    import ctypes

    import torch
    from spark_rapids_tpu_torch.exec import sort_bucket as sb
    fn = lib.sort_bucket_launch
    fn.argtypes = sb._ARGTYPES
    fn.restype = ctypes.c_int

    def other(operands, splitters, num_rows):
        n, dev = operands[0].shape[0], operands[0].device
        out = torch.empty(n, dtype=torch.int32, device=dev)
        rc = fn(ctypes.byref(sb._pack(operands)), n, num_rows,
                splitters.data_ptr(), splitters.shape[1], len(operands),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check(rc == 0, f"{name} sort_bucket launch failed: CUDA error {rc}")
        return out
    return other


def _decimal_arith_compare(name, lib):
    """decimal_arith_launch of another build (the C signature of the
    port's; commit 6c800d3's has it), with decimal_arith's arguments and
    result (no launch count: it is not on the port's path)."""
    import ctypes

    import torch
    from spark_rapids_tpu_torch.exprs import decimal_arith as da
    fn = lib.decimal_arith_launch
    fn.argtypes = da._ARGTYPES
    fn.restype = ctypes.c_int

    def other(op, operands, valid, valid2=None, k=0, t=0, m=0, p=38):
        n, dev = valid.shape[0], valid.device
        out = torch.empty(n, dtype=torch.int64, device=dev)
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        ptrs = [o.data_ptr() for o in operands] + [None] * (
            4 - len(operands))
        rc = fn(da.OPS[op], *ptrs, valid.data_ptr(),
                None if valid2 is None else valid2.data_ptr(), n, k, t, m,
                p, out.data_ptr(), ok.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _check(rc == 0, f"{name} decimal_arith launch failed: CUDA error "
                        f"{rc}")
        return out, ok
    return other


def _rect_dfa_compare(name, lib, form):
    """rect_dfa_launch of another build (the port's C signature; commit
    3444cf9's has it), with rect_dfa's arguments: the DFA's tables in
    ``form`` (None: as the port's wrapper hands them over; "class": its
    class-indexed table, the only one a build without the byte-indexed
    instance takes). No launch count: it is not on the port's path."""
    import ctypes

    from spark_rapids_tpu_torch.exec import rect_dfa as rd
    fn = lib.rect_dfa_launch
    fn.argtypes = rd._ARGTYPES
    fn.restype = ctypes.c_int

    def other(b, ln, v, dfa):
        return rd.launch(fn, b, ln, v, dfa, form)
    return other


_BYTE_STATES_LINE = r"constexpr int kRdByteStates = (\d+);"


def _rect_dfa_form(src_dir) -> str:
    """The tables a rect_dfa build in ``src_dir`` takes: the wrapper's
    (None) where its header has the byte-indexed instance, else the
    class-indexed table."""
    hdr = Path(src_dir) / "rect_dfa_row.cuh"
    m = hdr.exists() and re.search(_BYTE_STATES_LINE, hdr.read_text())
    return None if m and int(m.group(1)) > 0 else "class"


def _start_instance_builds():
    """rect_dfa with its class-indexed instance alone (kRdByteStates 0),
    from this checkout's sources into build/instances/rect_dfa_class/:
    checked and timed beside the kernel on every pattern, as a version
    of --compare is. Returns [(name, kernel, process, library, source
    directory)]."""
    from spark_rapids_tpu_torch import native
    d = native.BUILD_DIR / "instances" / "rect_dfa_class"
    d.mkdir(parents=True, exist_ok=True)
    hdr, n = re.subn(_BYTE_STATES_LINE, "constexpr int kRdByteStates = 0;",
                     (native.CSRC / "rect_dfa_row.cuh").read_text())
    _check(n == 1, "rect_dfa_row.cuh has no kRdByteStates line")
    (d / "rect_dfa_row.cuh").write_text(hdr)
    (d / "rect_dfa.cu").write_text((native.CSRC / "rect_dfa.cu").read_text())
    out = native.BUILD_DIR / "librect_dfa_class_instance.so"
    return [("class instance", "rect_dfa", subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-I", str(d), "-o", str(out),
         str(d / "rect_dfa.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), out, d)]


def _finish_compare_build(name, kernel, proc, out, src_dir):
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
    if kernel == "rect_transform":
        return _rect_transform_compare(name, lib)
    if kernel == "window_frame":
        return _window_frame_compare(name, lib)
    if kernel == "sort_bucket":
        return _sort_bucket_compare(name, lib)
    if kernel == "decimal_arith":
        other = _decimal_arith_compare(name, lib)
        other.library = out
        return other
    if kernel == "rect_dfa":
        return _rect_dfa_compare(name, lib, _rect_dfa_form(src_dir))
    return _dense_groupby_compare(name, lib)


#: the port's kernel libraries (csrc/<name>.cu), built side by side
KERNELS = ("rect_match", "dense_groupby", "join_match", "distinct_flag",
           "rect_transform", "window_frame", "sort_bucket", "decimal_arith",
           "rect_dfa")


def phase_build(compare=()):
    """Build the port's kernels, one nvcc each, all started together (and
    the ones to compare at the same time); the ptxas report of every
    function of the port must show no stack frame and no spills. Returns
    {kernel: {name: launch function}} of the kernels to compare."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_tpu_torch import native
    t0 = time.perf_counter()
    started = [b for n, d in compare for b in _start_compare_build(n, d)]
    started += _start_instance_builds()
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
    for name, kernel, proc, out, src in started:
        fns[kernel][name] = _finish_compare_build(name, kernel, proc, out,
                                                  src)
    _log(f"build: {', '.join(f'{n} {k}' for n, k, *_ in started)} "
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


def _run_query(session, table, query, collect: str = "collect"):
    """``query(df, F)`` over ``table``, collected by ``collect``
    (``collect`` or ``collect_numpy``): (its rows, its wall ms)."""
    from spark_rapids_tpu_torch.api import functions as F
    t0 = time.perf_counter()
    rows = getattr(query(session.create_dataframe(table), F), collect)()
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
    event). Device time is summed over the rows of the card's own
    operations (kernels, copies, fills): an ``aten::`` row's self device
    time is that of the kernels it launched, which have rows of their
    own."""
    from torch.autograd import DeviceType
    avg = prof.key_averages()
    dev = sorted(((_device_time_us(e), e.key, e.count) for e in avg
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and _device_time_us(e) > 0), reverse=True)
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
                  kernel: str, collect: str = "collect") -> dict:
    """One warm run of ``query`` under torch.profiler: where its wall goes
    on the card. The result must satisfy ``right`` as any other run's;
    only reading the trace may fail without failing the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rows, wall = _run_query(session, host, query, collect)
        torch.cuda.synchronize()
    _check(right(rows), f"{label} under the profiler: wrong result "
                        f"{str(rows)[:300]}")
    try:
        return _profile_report(prof, wall, label, kernel)
    except Exception as e:  # the trace is read for information only
        _log(f"profile: could not be read ({e!r}); the CUDA-event numbers "
             "above stand")
        return {"device_time": False, "error": repr(e)}


# ---------------------------------------------------------------------------
# join_match: the equi-join's hash build and probe
# ---------------------------------------------------------------------------

JOIN_STREAM_ROWS = 1 << 20
#: the join types join_match computes (exec/join_match.py JOIN_TYPES)
JOIN_TYPES = ("inner", "left", "right", "full", "leftsemi", "leftanti",
              "existence")


def _key_batch(cols: dict, n: int):
    """A device batch of key columns: name -> (numpy values, numpy
    validity)."""
    import torch
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, DeviceColumn
    from spark_rapids_tpu_torch.types import (Schema, StructField,
                                              from_numpy_dtype)
    fields, out = [], []
    for name, (v, ok) in cols.items():
        dt = from_numpy_dtype(v.dtype)
        fields.append(StructField(name, dt, True))
        out.append(DeviceColumn(torch.from_numpy(v).cuda(),
                                torch.from_numpy(ok).cuda(), dt))
    return ColumnarBatch(out, n, Schema(fields))


def _join_case(rng, U: int, kinds, rows: int = JOIN_STREAM_ROWS,
               dup: int = 0, skew: int = 0):
    """Stream and build key words for a join_match case: ``U`` unique build
    keys of the column kinds ``kinds`` ("i64", "i32", "f64"; floats hold
    NaN, 0.0 and -0.0), each 1-8 times on the build side (``dup`` times
    each when given; the first key ``skew`` times when given); 5% null
    keys on both sides; the stream draws 3 of every 4 rows from the build
    keys. Encoded by the joins' own key encoding (exec/joins.py
    encode_keys)."""
    from spark_rapids_tpu_torch.exec.joins import encode_keys
    from spark_rapids_tpu_torch.exprs.base import ColumnRef
    pool = []
    for k in kinds:
        if k == "f64":
            v = np.round(rng.uniform(-1e6, 1e6, U), 2)
            v[:3] = [np.nan, 0.0, -0.0][:min(3, U)]
        elif k == "i32":
            v = rng.randint(-2**31, 2**31 - 1, U).astype(np.int32)
        else:
            v = rng.randint(-2**62, 2**62, U).astype(np.int64)
        pool.append(v)
    dup = np.full(U, dup) if dup else rng.randint(1, 9, U)
    if skew:
        dup[0] = skew
    brow = rng.permutation(np.repeat(np.arange(U), dup))
    pick = np.where(rng.rand(rows) < 0.75, rng.randint(0, U, rows), -1)
    cols_b, cols_s = {}, {}
    for j, v in enumerate(pool):
        sv = np.where(pick >= 0, v[np.maximum(pick, 0)],
                      (rng.uniform(2e6, 3e6, rows) if v.dtype.kind == "f"
                       else rng.randint(0, 2**30, rows) * 2 + 1)
                      .astype(v.dtype))
        if v.dtype.kind == "f":
            # another NaN's bits and a -0.0 for 0.0 on the stream side
            sv[(pick == 0)] = -np.nan
            sv[(pick == 2)] = 0.0
        cols_b[f"k{j}"] = (v[brow], rng.rand(len(brow)) > 0.05)
        cols_s[f"k{j}"] = (sv, rng.rand(rows) > 0.05)
    keys = [ColumnRef(f"k{j}") for j in range(len(pool))]
    sb, bb = _key_batch(cols_s, rows), _key_batch(cols_b, len(brow))
    sw, sn, bw, bn = encode_keys(sb, keys, bb, keys)
    return sw, sn, bw, bn


def _maps_equal(a, b) -> bool:
    import torch
    return all((x is None and y is None) or (
        x is not None and y is not None and x.shape == y.shape
        and bool(torch.equal(x, y))) for x, y in zip(a, b))


#: (label, distinct build keys, key columns, rows a key (0: 1-8 at
#: random), rows of the first key (0: as the others), stream rows); each
#: runs every join type. The inner join's route and whether its table
#: sits in shared memory are printed beside each. Two cases end in a
#: partial tile of stream rows.
JOIN_CASES = (("100 keys, 1 int64 word", 100, ("i64",), 0, 0,
               JOIN_STREAM_ROWS),
              ("100,000 keys, 1 int64 word", 100_000, ("i64",), 0, 0,
               JOIN_STREAM_ROWS),
              ("100 keys, 1 float64 word (NaN, +-0.0)", 100, ("f64",), 0, 0,
               JOIN_STREAM_ROWS),
              ("100,000 keys, 2 words (int32, int64)", 100_000,
               ("i32", "i64"), 0, 0, JOIN_STREAM_ROWS),
              ("100,000 keys, 4 words (int64, float64, int32, int64)",
               100_000, ("i64", "f64", "i32", "i64"), 0, 0,
               JOIN_STREAM_ROWS),
              ("150 keys of one row, 1 int64 word, 1,048,575 stream rows",
               150, ("i64",), 1, 0, JOIN_STREAM_ROWS - 1),
              ("100,000 keys of one row, 1 int64 word", 100_000, ("i64",),
               1, 0, JOIN_STREAM_ROWS),
              ("1,000 keys of two rows, 3 words (int64, int32, float64), "
               "1,000,003 stream rows", 1000, ("i64", "i32", "f64"), 2, 0,
               1_000_003),
              ("1,000 keys, one of them in 11,000 build rows (10,000 or "
               "more of them not null), 2 words (int32, int64)", 1000,
               ("i32", "i64"), 0, 11_000, JOIN_STREAM_ROWS))


def _route_label(table, n: int, join_type: str = "inner") -> str:
    from spark_rapids_tpu_torch.exec import join_match as jm
    return (f"route {jm.launch_route(table, n, join_type)}, table in "
            f"{'shared memory' if table.shared else 'L1/L2'}")


def phase_join_exact() -> int:
    """join_match on the card against its plain version, exactly, for
    every join type over JOIN_CASES (about a million stream rows each):
    both routes, the table in shared memory and not, keys of 1-4 words, a
    skewed key, a partial last tile. Returns the largest difference of a
    map entry (0: exact)."""
    import torch
    from spark_rapids_tpu_torch.exec.join_match import (
        build_table, join_match, join_match_reference, launch_route)
    rng = np.random.RandomState(7)
    before = join_match.launches
    checked, err = 0, 0.0
    routes = set()
    for label, U, kinds, dup, skew, rows in JOIN_CASES:
        sw, sn, bw, bn = _join_case(rng, U, kinds, rows, dup, skew)
        table = build_table(bw, bn)
        _check(table.table is not None and int(table.ukeys.shape[0]) > 0,
               f"{label}: no table was built on the card")
        sizes = {}
        for jt in JOIN_TYPES:
            routes.add(launch_route(table, int(sw.shape[0]), jt))
            got = join_match(sw, sn, table, jt)
            want = join_match_reference(sw, sn, table, jt)
            torch.cuda.synchronize()
            _check(_maps_equal(got, want),
                   f"join_match {jt} over {label} differs from its plain "
                   "version")
            for x, y in zip(got, want):
                if x is not None and x.numel():
                    err = max(err, float((x.long() - y.long()).abs().max()))
            sizes[jt] = int(got.stream.shape[0])
            checked += sizes[jt]
        _log(f"join_match exact over {label}: {int(table.ukeys.shape[0])} "
             f"distinct build keys of {int(bw.shape[0])} rows (largest "
             f"count {table.max_ucount}), inner join's "
             f"{_route_label(table, int(sw.shape[0]))}; output rows {sizes}")
    _check(join_match.launches - before == len(JOIN_CASES) * len(JOIN_TYPES),
           "join_match did not launch once a call")
    _check(routes == {"flags", "single", "count_emit"},
           f"join_match's routes {routes}: not all were run")
    _log(f"join_match: {checked} output rows over {len(JOIN_CASES)} cases x "
         f"{len(JOIN_TYPES)} join types equal to the plain version exactly")
    return err


def join_bound(sw, sn, table, out_rows: int) -> dict:
    """The least bytes one inner probe and emit must move, each input read
    once and each output written once: the stream keys (8 B a word) and
    null flags, the build side (the distinct keys with their starts and
    counts, the sorted build rows, and a hash table of one 4-byte key id a
    slot at twice the distinct keys, the least a probe needs; the
    kernel's own table is larger by design, which the bound does not
    count), and the pairs (two int64 each). ``sector_bytes``
    counts as well a 32-byte sector of the table and of the key words for
    every non-null stream key, the count that holds when the table does
    not stay in the L2 (a build side of many keys)."""
    n, W = int(sw.shape[0]), int(sw.shape[1])
    U = int(table.ukeys.shape[0])
    slots = 2
    while slots < 2 * U:
        slots <<= 1
    build = slots * 4 + sum(t.numel() * t.element_size() for t in (
        table.ukeys, table.ustart, table.ucount, table.sorted_rows))
    nbytes = n * (8 * W + 1) + build + out_rows * 16
    sectors = n * (8 * W + 1) + int((~sn).sum()) * 2 * 32 + out_rows * 16
    return {"bytes": nbytes, "ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "by": "bytes", "sector_bytes": sectors,
            "sector_ms": sectors / HBM_BYTES_PER_S * 1e3}


def _raw_join_calls(sw, sn, table, join_type: str = "inner"):
    """The launches of one join_match call as a function of (words, null)
    with their outputs made beforehand (outside the wrapper: no launch
    count): the one launch of the single route, or the count and the emit
    launch of the count/emit route. Returns it, the output rows and the
    route."""
    import torch
    from spark_rapids_tpu_torch.exec import join_match as jm
    n = int(sw.shape[0])
    route = jm.launch_route(table, n, join_type)
    launch = jm._card_launch(sw.get_device(), jm._stream(sw))
    total = torch.empty(1, dtype=torch.int64, device="cuda")
    if route == "single":
        rows = jm._single_rows(table, n, join_type)
    else:
        launch(jm._pack(sw, sn, table, join_type, jm._COUNT,
                        total.data_ptr()))
        rows = int(total.item())
    out = torch.empty(2 * rows, dtype=torch.int64, device="cuda")

    def both(w, nl):
        if route == "count_emit":
            launch(jm._pack(w, nl, table, join_type, jm._COUNT,
                            total.data_ptr()))
        launch(jm._pack(w, nl, table, join_type, jm._EMIT, total.data_ptr(),
                        0, out.data_ptr(), out.data_ptr() + rows * 8, 0,
                        rows))
    both(sw, sn)
    torch.cuda.synchronize()
    return both, int(total.item()), route


def q3_join_shape(rows: int = JOIN_STREAM_ROWS):
    """q3's first join as the main path gives it: one store_sales batch's
    ss_sold_date_sk against the November rows of date_dim, encoded."""
    from spark_rapids_tpu_torch.exec.joins import encode_keys
    from spark_rapids_tpu_torch.exprs.base import ColumnRef
    ss = gen_store_sales(rows)
    dd = gen_date_dim()
    nov = dd["d_date_sk"][dd["d_moy"] == 11]
    sb = _key_batch({"k": (ss["ss_sold_date_sk"], np.ones(rows, bool))},
                    rows)
    bb = _key_batch({"k": (nov, np.ones(len(nov), bool))}, len(nov))
    k = [ColumnRef("k")]
    return encode_keys(sb, k, bb, k)


def _call_ms(fn, reps: int = 5):
    """(device ms, host ms) of one synchronised call of ``fn``: events
    around it on the card, the host clock beside them; medians of
    ``reps`` calls."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3))
    return (float(np.median([o[0] for o in out])),
            float(np.median([o[1] for o in out])))


def phase_join_times(sw, sn, bw, bn, label: str) -> dict:
    """join_match's launches for an inner join on ``label`` (one, or the
    count and the emit), timed with the L2 cold beside their bound; the
    whole wrapper call (with its host read of the total) and the plain
    version, each timed by events around a synchronised call."""
    import torch
    from spark_rapids_tpu_torch.exec.join_match import (
        build_table, join_match, join_match_reference)
    from spark_rapids_tpu_torch.exec.join_match import kernel_shape
    table = build_table(bw, bn)
    both, total, route = _raw_join_calls(sw, sn, table)
    shared = table.shared
    shape = kernel_shape(int(sw.shape[1]), shared)
    b = join_bound(sw, sn, table, total)
    per = sw.nbytes + sn.nbytes
    copies = [(sw, sn)] + [(sw.clone(), sn.clone()) for _ in range(
        max(1, -(-COLD_BYTES // per) - 1))]
    ms, _ = _cold_ms(both, copies, f"join_match {label}")

    saved = join_match.launches
    call_ms, host_ms = _call_ms(lambda: join_match(sw, sn, table, "inner"))
    join_match.launches = saved
    plain_ms, _ = _call_ms(lambda: join_match_reference(sw, sn, table,
                                                        "inner"), reps=3)
    row = {"ms": ms, "call_ms": call_ms, "host_ms": host_ms,
           "plain_ms": plain_ms, "bound_ms": b["ms"], "bound_by": b["by"],
           "bound_bytes": b["bytes"], "sector_ms": b["sector_ms"],
           "library_ms": None,
           "out_rows": total, "build_keys": int(table.ukeys.shape[0]),
           "stream_rows": int(sw.shape[0]), "route": route,
           "shared_table": shared, "launches_a_call":
           1 if route == "single" else 2, "launch": shape}
    _log(f"kernel join_match on {label} ({row['stream_rows']} stream rows, "
         f"{row['build_keys']} build keys, {total} pairs; route {route}, "
         f"table in {'shared memory' if shared else 'L1/L2'}; "
         f"{shape['registers']} registers, {shape['blocks_per_sm']} blocks "
         f"an SM at its largest shared memory), cold: {row['launches_a_call']} launch(es) "
         f"{ms:.4f} ms, bound {b['ms']:.4f} ({b['bytes']} B; by "
         f"bytes), {b['ms'] / ms:.0%} of bound (with a sector a lookup "
         f"{b['sector_ms']:.4f} ms, {b['sector_bytes']} B); whole call "
         f"(one host read "
         f"of the total) {call_ms:.4f} ms on the card, {host_ms:.4f} ms on "
         f"the host clock; plain {plain_ms:.4f} ms; library ms: none (no "
         f"one PyTorch call computes it); {len(copies)} input copies")
    return row


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



# ---------------------------------------------------------------------------
# TPC-DS q3 at SF10 (ladder rung 3) and joins at scale
# ---------------------------------------------------------------------------

def _q3_run(session, hosts, query=None, right=None, label="q3"):
    """One run of ``query`` (q3 by default) over the three host tables:
    rows, wall ms, join_match launches (count set to 0 just before, read
    just after), the sub-partition counts of its shuffled joins and the
    allocator's peak reservation."""
    import torch
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.exec.join_match import join_match
    from spark_rapids_tpu_torch.exec.joins import TpuHashJoinExec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    join_match.launches = 0
    t0 = time.perf_counter()
    dfs = [session.create_dataframe(h) for h in hosts]
    rows = (query or q3)(*dfs, F).collect()
    wall = (time.perf_counter() - t0) * 1e3
    launches = join_match.launches
    subs = []

    def walk(node):
        if isinstance(node, TpuHashJoinExec):
            subs.append(node.last_subpartitions)
        for c in node.children:
            walk(c)
    walk(session.last_plan)
    if right is not None:
        _check(right(rows), f"{label}: wrong result {rows[:4]}")
    return {"wall_ms": wall, "join_match_launches": launches,
            "subpartitions": subs,
            "max_memory_reserved": torch.cuda.max_memory_reserved(),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}, rows


def _joins_by_type(store_sales, date_dim, item, F, how: str):
    """store_sales joined with the whole item table, then a count and one
    sum (no date_dim: the arguments follow q3's)."""
    j = store_sales.join(item, on=[("ss_item_sk", "i_item_sk")], how=how)
    aggs = [F.count_star().with_name("n"),
            F.sum(F.col("ss_ext_sales_price")).with_name("s")]
    if how == "left":
        aggs.append(F.sum(F.col("i_brand_id")).with_name("b"))
    return j.agg(*aggs)


def joins_by_type_numpy(ss: dict, it: dict, how: str) -> dict:
    known = np.zeros(max(len(it["i_item_sk"]), int(ss["ss_item_sk"].max())
                         + 1), bool)
    known[it["i_item_sk"]] = True
    hit = known[ss["ss_item_sk"]]
    keep = ~hit if how == "leftanti" else (hit if how == "leftsemi"
                                           else np.ones(len(hit), bool))
    out = {"n": int(keep.sum()),
           "s": float(ss["ss_ext_sales_price"][keep].sum())
           if keep.any() else None}
    if how == "left":
        bid = np.zeros(len(known), np.int64)
        bid[it["i_item_sk"]] = it["i_brand_id"]
        out["b"] = int(bid[ss["ss_item_sk"]][hit].sum())
    return out


def phase_tpcds(card: str, batch_rows: int) -> dict:
    """TPC-DS q3 at SF10 (28,800,991 store_sales rows, 1,826 dates, 2,000
    items, benchmarks/tpcds.py's generator) in 1,048,576-row batches:
    the default plan (two broadcast hash joins) cold and warm, then
    under torch.profiler; the shuffled plan
    (autoBroadcastJoinThreshold=-1: both joins coalesced, the first
    sub-partitioned at the 256 MiB default) cold and warm. Both equal
    numpy (keys, order and counts exactly, sum_agg within REL_TOL) and
    each other. Then store_sales joined with the whole item table as
    left, leftsemi and leftanti against numpy."""
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.columnar import HostTable
    t0 = time.perf_counter()
    ss = gen_store_sales(SF10_STORE_SALES)
    dd, it = gen_date_dim(), gen_item()
    hosts = [HostTable.from_dict(ss), HostTable.from_dict(dd),
             HostTable.from_dict(it)]
    want = q3_numpy(ss, dd, it)
    gen_s = time.perf_counter() - t0
    n_batches = math.ceil(SF10_STORE_SALES / batch_rows)
    _log(f"tpcds SF10: {SF10_STORE_SALES} store_sales rows "
         f"({sum(v.nbytes for v in ss.values())} B in 11 columns), "
         f"generated with numpy q3 in {gen_s:.2f} s; q3 numpy: {len(want)} "
         f"rows [{card}]")
    res = {"card": card, "rows": SF10_STORE_SALES, "groups": len(want)}
    base = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    plans = {"broadcast": TorchSession(base),
             "shuffled": TorchSession({
                 **base, "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                 -1})}
    results = {}
    for name, session in plans.items():
        runs = {}
        for label in ("cold", "warm"):
            runs[label], rows = _q3_run(
                session, hosts, right=lambda r: q3_equal(r, want),
                label=f"q3 {name} {label}")
            results[(name, label)] = rows
        plan = session.last_plan.tree_string()
        _check(("BroadcastHashJoin" in plan) == (name == "broadcast"),
               f"q3 {name} plan:\n{plan}")
        c, w = runs["cold"], runs["warm"]
        expect = 2 * n_batches if name == "broadcast" else None
        for r in (c, w):
            _check(r["join_match_launches"] > 0 and (
                expect is None or r["join_match_launches"] == expect),
                f"q3 {name}: join_match launched "
                f"{r['join_match_launches']} times (expected "
                f"{expect or 'some'})")
        _log(f"q3 SF10 {name} plan: equal to numpy ({len(want)} rows; keys, "
             f"order exact, sum_agg within {REL_TOL:g}); wall "
             f"{c['wall_ms']:.1f} ms cold, {w['wall_ms']:.1f} ms warm; "
             f"join_match launches {c['join_match_launches']} / "
             f"{w['join_match_launches']}; sub-partitions of its coalesced "
             f"joins {c['subpartitions']}; max_memory_reserved "
             f"{c['max_memory_reserved']} / {w['max_memory_reserved']} B, "
             f"max_memory_allocated {c['max_memory_allocated']} / "
             f"{w['max_memory_allocated']} B [{card}]")
        _log(f"q3 {name} physical plan:\n{plan}")
        runs["plan"] = plan
        res[name] = runs
    _check(all(results[("broadcast", x)] == results[("broadcast", "cold")]
               for x in ("warm",)) and all(
        q3_equal(results[("shuffled", x)], results[("broadcast", "cold")],
                 rel=REL_TOL) for x in ("cold", "warm")),
        "q3's two plans disagree")
    _log(f"q3 SF10 result: {want}")
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run, _ = _q3_run(plans["broadcast"], hosts,
                         right=lambda r: q3_equal(r, want),
                         label="q3 broadcast under the profiler")
        torch.cuda.synchronize()
    try:
        res["profile_broadcast_warm"] = _profile_report(
            prof, run["wall_ms"], "q3 SF10 broadcast", "join_match")
    except Exception as e:  # the trace is read for information only
        _log(f"profile: could not be read ({e!r})")
        res["profile_broadcast_warm"] = {"device_time": False,
                                         "error": repr(e)}

    by_type = {}
    for how in ("left", "leftsemi", "leftanti"):
        w_ = joins_by_type_numpy(ss, it, how)
        run, rows = _q3_run(
            plans["broadcast"], hosts,
            lambda a, b, c, F, how=how: _joins_by_type(a, b, c, F, how))
        got = rows[0]
        _check(got["n"] == w_["n"] and (
            (got["s"] is None and w_["s"] is None)
            or _rel(got["s"], w_["s"]) <= REL_TOL)
            and got.get("b") == w_.get("b"),
            f"store_sales {how} item: {got} != numpy {w_}")
        _check(run["join_match_launches"] == n_batches,
               f"{how}: join_match launched {run['join_match_launches']} "
               f"times, expected {n_batches}")
        by_type[how] = {**run, "result": got}
        _log(f"store_sales {how} join item (SF10, broadcast): {got} equal to "
             f"numpy; wall {run['wall_ms']:.1f} ms; join_match launches "
             f"{run['join_match_launches']} [{card}]")
    res["joins_by_type"] = by_type
    for s in plans.values():
        s.close()
    return res, {"ss": ss, "dd": dd, "it": it, "hosts": hosts}



# ---------------------------------------------------------------------------
# phase 12: the SQL texts (TPCH_Q1, TPCH_Q6, TPCDS_Q3 and TPCDS_Q9_BUCKET
# are copies of benchmarks/queries_sql.py's, which tests/test_torch_sql.py
# holds equal)
# ---------------------------------------------------------------------------

TPCH_Q1 = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity)                                      AS sum_qty,
       sum(l_extendedprice)                                 AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount))              AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity)                                      AS avg_qty,
       avg(l_extendedprice)                                 AS avg_price,
       avg(l_discount)                                      AS avg_disc,
       count(*)                                             AS count_order
FROM lineitem
WHERE l_shipdate <= date '1998-12-01' - interval '90' day
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

TPCH_Q6 = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= date '1994-01-01'
  AND l_shipdate < date '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""

TPCDS_Q3 = """
SELECT d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) AS sum_agg
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk
  AND ss_item_sk = i_item_sk
  AND i_manufact_id = 128
  AND d_moy = 11
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, sum_agg DESC, i_brand_id
"""

TPCDS_Q9_BUCKET = """
SELECT count(CASE WHEN ss_quantity BETWEEN {lo} AND {hi}
                  THEN 1 ELSE NULL END)                        AS cnt,
       avg(CASE WHEN ss_quantity BETWEEN {lo} AND {hi}
                THEN ss_ext_sales_price ELSE NULL END)          AS avg_price,
       avg(CASE WHEN ss_quantity BETWEEN {lo} AND {hi}
                THEN ss_net_paid ELSE NULL END)                 AS avg_paid
FROM store_sales
"""


def _q28_branch(lo, hi, lp, cp, wc) -> str:
    return f"""SELECT avg(ss_list_price) AS b_avg,
       count(ss_list_price) AS b_cnt,
       count(DISTINCT ss_list_price) AS b_cntd
FROM store_sales
WHERE ss_quantity BETWEEN {lo} AND {hi}
  AND (ss_list_price >= {float(lp)} OR ss_coupon_amt >= {float(cp)}
       OR ss_wholesale_cost >= {float(wc)})"""


#: q28 (phase 11's, the benchmark's six buckets) as a user writes it: a
#: UNION ALL of six filtered keyless SELECTs
TPCDS_Q28 = "\nUNION ALL\n".join(_q28_branch(*b) for b in (
    (0, 5, 11, 460, 14930), (6, 10, 91, 1430, 32370),
    (11, 15, 66, 1480, 3750), (16, 20, 142, 3270, 21910),
    (21, 25, 135, 2450, 17300), (26, 30, 28, 2340, 33660)))

SQL_LIKE = ("SELECT count(*) FROM lineitem "
            "WHERE l_comment LIKE '%special%'")

#: the CTE / HAVING / ORDER BY / LIMIT text of tests/test_sql.py
SQL_CTE_LIMIT = """
WITH big AS (
    SELECT l_orderkey, sum(l_quantity) AS q
    FROM lineitem GROUP BY l_orderkey HAVING sum(l_quantity) > 60
)
SELECT l_orderkey, q FROM big ORDER BY q DESC, l_orderkey
LIMIT 10"""

#: two filtered projections of store_sales, as INTERSECT and EXCEPT
SQL_SETOP = """
SELECT * FROM (
    SELECT ss_item_sk, ss_quantity FROM store_sales
    WHERE ss_quantity <= 10 AND ss_item_sk < 300
    {op}
    SELECT ss_item_sk, ss_quantity FROM store_sales
    WHERE ss_net_paid > 19990.0) x
ORDER BY ss_item_sk, ss_quantity"""


# ---------------------------------------------------------------------------
# phase 11: TPC-DS q9 and q28 at SF10, and the distinct_flag kernel
# ---------------------------------------------------------------------------

def q9(store_sales, F):
    """Bucketed quantity-range statistics via conditional aggregation."""
    aggs = []
    buckets = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
    for i, (lo, hi) in enumerate(buckets, 1):
        in_b = ((F.col("ss_quantity") >= F.lit(lo))
                & (F.col("ss_quantity") <= F.lit(hi)))
        one_if = F.when(in_b, F.lit(1)).otherwise(F.lit(None))
        price_if = F.when(in_b, F.col("ss_ext_sales_price")) \
                    .otherwise(F.lit(None))
        paid_if = F.when(in_b, F.col("ss_net_paid")).otherwise(F.lit(None))
        aggs += [F.count(one_if).with_name(f"cnt{i}"),
                 F.avg(price_if).with_name(f"avg_price{i}"),
                 F.avg(paid_if).with_name(f"avg_paid{i}")]
    return store_sales.agg(*aggs)


Q28_BUCKETS = [(0, 5, 11, 460, 14930), (6, 10, 91, 1430, 32370),
               (11, 15, 66, 1480, 3750), (16, 20, 142, 3270, 21910),
               (21, 25, 135, 2450, 17300), (26, 30, 28, 2340, 33660)]


def q28(store_sales, F):
    """Bucketed list-price stats incl. distinct counts (6 buckets)."""
    outs = []
    for lo, hi, lp, cp, wc in Q28_BUCKETS:
        b = store_sales.filter(
            (F.col("ss_quantity") >= F.lit(lo))
            & (F.col("ss_quantity") <= F.lit(hi))
            & ((F.col("ss_list_price") >= F.lit(float(lp)))
               | (F.col("ss_coupon_amt") >= F.lit(float(cp)))
               | (F.col("ss_wholesale_cost") >= F.lit(float(wc)))))
        outs.append(b.agg(
            F.avg(F.col("ss_list_price")).with_name("b_avg"),
            F.count(F.col("ss_list_price")).with_name("b_cnt"),
            F.count_distinct(F.col("ss_list_price")).with_name("b_cntd")))
    res = outs[0]
    for o in outs[1:]:
        res = res.union(o)
    return res


def q9_numpy(ss: dict) -> list:
    q = ss["ss_quantity"]
    row = {}
    for i, (lo, hi) in enumerate([(1, 20), (21, 40), (41, 60), (61, 80),
                                  (81, 100)], 1):
        m = (q >= lo) & (q <= hi)
        n = int(m.sum())
        row[f"cnt{i}"] = n
        row[f"avg_price{i}"] = float(ss["ss_ext_sales_price"][m].mean()) \
            if n else None
        row[f"avg_paid{i}"] = float(ss["ss_net_paid"][m].mean()) \
            if n else None
    return [row]


def q28_masks(ss: dict) -> list:
    q, lpc = ss["ss_quantity"], ss["ss_list_price"]
    return [(q >= lo) & (q <= hi) & ((lpc >= lp)
                                     | (ss["ss_coupon_amt"] >= cp)
                                     | (ss["ss_wholesale_cost"] >= wc))
            for lo, hi, lp, cp, wc in Q28_BUCKETS]


def q28_numpy(ss: dict) -> list:
    rows = []
    for m in q28_masks(ss):
        p = ss["ss_list_price"][m]
        rows.append({"b_avg": float(p.mean()) if len(p) else None,
                     "b_cnt": int(len(p)),
                     "b_cntd": int(len(np.unique(p)))})
    return rows


def stats_equal(got: list, want: list, rel: float = REL_TOL) -> bool:
    """Same rows in order: ints and None exactly, floats within ``rel``
    (the card adds the rows in another order)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if set(g) != set(w):
            return False
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, float) and gv is not None:
                if _rel(gv, wv) > rel:
                    return False
            elif gv != wv:
                return False
    return True


def _df_case(rng, n_batches: int, rows: int, vkind: str, gkind,
             nulls: bool = True, hi: int = 1000):
    """Batches of (value, validity, group, validity) on the card: values of
    ``vkind`` in [0, hi) with NaN, +-0.0 and +-inf among floats, NULLs in
    both columns, a group of ``gkind`` (None: no group)."""
    import torch
    out = []
    specials = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf])
    for _ in range(n_batches):
        v = rng.randint(0, hi, rows).astype(vkind)
        if v.dtype.kind == "f":
            sp = rng.rand(rows) < 0.2
            v[sp] = specials[rng.randint(0, len(specials), sp.sum())]
        vv = rng.rand(rows) > 0.1 if nulls else np.ones(rows, bool)
        t = [torch.from_numpy(v).cuda(), torch.from_numpy(vv).cuda(), None,
             None]
        if gkind is not None:
            t[2] = torch.from_numpy(rng.randint(-3, 4, rows).astype(
                gkind)).cuda()
            t[3] = torch.from_numpy(rng.rand(rows) > 0.1).cuda()
        out.append(tuple(t))
    return out


def _df_stream(batches, min_slots: int = 1 << 16, hold_ms: float = 0.0):
    """The kernel's and the plain version's flags over ``batches`` on the
    card, the table sized as the exec sizes it. Each batch is synchronised
    and compared at once; with ``hold_ms``, a sleep of that long holds the
    stream first and every batch is queued with no synchronise, compared
    after the last (the key count then lags the launches). Returns
    {same: every batch bit-identical, growths, slots, flags, launches,
    carried: the most rows a bound carried beyond its batch's own}."""
    import torch
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    table, growths, carried, got = None, 0, 0, []
    saved = dfl.distinct_flag.launches
    dfl.distinct_flag.launches = 0
    seen, same = dfl.SeenKeys(), True
    if hold_ms:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold_ms * CYCLES_PER_MS))
    for v, vv, g, gv in batches:
        n = int(v.shape[0])
        if table is not None:
            carried = max(carried, table.key_bound(n)[1] - n)
        table, grew = dfl.sized_table(table, v.device, n, min_slots)
        growths += grew
        got.append(dfl.distinct_flag(table, v, vv, g, gv))
        if not hold_ms:
            want = dfl.distinct_flag_reference(seen, v, vv, g, gv)
            torch.cuda.synchronize()
            same = same and torch.equal(got[-1], want)
    launches = dfl.distinct_flag.launches
    dfl.distinct_flag.launches = saved
    if hold_ms:
        for f, (v, vv, g, gv) in zip(got, batches):
            same = same and torch.equal(
                f, dfl.distinct_flag_reference(seen, v, vv, g, gv))
    flagged = sum(int(f.sum()) for f in got)
    _check(not table.failed(), "distinct_flag set its error word")
    return {"same": same, "growths": growths, "slots": table.capacity,
            "flags": flagged, "launches": launches, "carried": carried}


def phase_distinct_exact() -> dict:
    """distinct_flag against its plain version on the card, bit for bit,
    over the cases of the module doc; each case's route (the kernel's
    table: its slots, growths and launches) recorded. The last four
    cases are: every 32-row piece with repeated keys (the rows of a key
    in a warp race for one slot and its first row), batches of more rows
    than the kernel's grid has threads (a thread's later rows through
    scratch), 40 batches queued behind a sleep
    with no synchronise (the key count lags, the bound carries rows), and
    keys that outgrow the table twice."""
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    rng = np.random.RandomState(11)
    one_key = np.full(1 << 20, 4.25)
    spread = rng.permutation(2_000_000).astype(np.int64)
    grid = dfl.kernel_shape()["grid_threads"]
    cases = {
        "nan_zero_null_value_null_group_f64_i64": _df_case(
            rng, 3, 200_000, np.float64, np.int64, hi=5000),
        "float32_value_int8_group": _df_case(rng, 3, 100_000, np.float32,
                                             np.int8, hi=300),
        "int8_value_no_group": _df_case(rng, 2, 50_000, np.int8, None,
                                        hi=100),
        "one_key_fills_a_batch": [_df_tensors(one_key, None)] * 2,
        "2M_distinct_keys_two_growths": [
            _df_tensors(spread[i:i + 250_000], None)
            for i in range(0, 2_000_000, 250_000)],
        "keys_repeat_across_batches": _df_case(rng, 6, 150_000, np.float64,
                                               np.int64, nulls=False,
                                               hi=20_000),
        "one_row": [_df_tensors(np.array([7.5]), np.array([3]))] * 2,
        "repeats_in_every_warp": _df_case(rng, 3, 200_000, np.int64,
                                          np.int8, hi=4),
        "more_rows_than_the_grid": _df_case(rng, 2, 4 * grid, np.float64,
                                            np.int64, hi=100_000),
        "40_batches_queued_unsynchronised": _df_case(
            rng, 40, 50_000, np.float64, np.int64, hi=30_000),
        "keys_outgrow_the_table_twice": [
            _df_tensors(spread[i:i + 300_000] * 3 + 1, None)
            for i in range(0, 1_500_000, 300_000)],
    }
    out = {}
    for name, batches in cases.items():
        r = _df_stream(batches, hold_ms=50.0 if name.startswith("40_")
                       else 0.0)
        _check(r["same"], f"distinct_flag {name}: differs from its plain "
                          "version")
        _check(r["launches"] == len(batches) + r["growths"],
               f"distinct_flag {name}: {r['launches']} launches for "
               f"{len(batches)} batches and {r['growths']} growths")
        out[name] = {"batches": len(batches), **{
            k: r[k] for k in ("growths", "slots", "flags", "launches",
                              "carried")},
            "route": f"cuda kernel, one launch a batch, table of "
                     f"{r['slots']} slots after {r['growths']} growths"}
    _check(out["2M_distinct_keys_two_growths"]["growths"] >= 2
           and out["keys_outgrow_the_table_twice"]["growths"] >= 2,
           "a growing case did not grow twice")
    _check(out["40_batches_queued_unsynchronised"]["carried"] > 0,
           "the queued stream's count never lagged its launches")
    _log("kernel distinct_flag exact against its plain version (every "
         f"batch bit-identical; grid of {grid} threads): " + "; ".join(
             f"{k}: {v['batches']} batches, {v['flags']} flags, "
             f"{v['slots']} slots, {v['growths']} growths, "
             f"{v['launches']} launches, bound carried up to "
             f"{v['carried']} rows" for k, v in out.items()))
    return out


def _df_tensors(values: np.ndarray, groups):
    import torch
    v = torch.from_numpy(values).cuda()
    g = None if groups is None else torch.from_numpy(groups).cuda()
    return (v, torch.ones_like(v, dtype=torch.bool), g,
            None if g is None else torch.ones_like(g, dtype=torch.bool))


def q28_flag_batches(ss: dict, batch_rows: int):
    """The distinct flag's inputs as q28's plan gives them: per scan batch,
    the rows some branch keeps (compacted), their branch id (int64) and
    list price (float64), on the card."""
    import torch
    masks = q28_masks(ss)
    bid = np.full(len(ss["ss_quantity"]), -1, np.int64)
    for i in range(len(masks) - 1, -1, -1):
        bid[masks[i]] = i
    out = []
    for off in range(0, len(bid), batch_rows):
        b = bid[off:off + batch_rows]
        keep = b >= 0
        out.append(_df_tensors(
            np.ascontiguousarray(ss["ss_list_price"][off:off + batch_rows][
                keep]), np.ascontiguousarray(b[keep])))
    return out


def phase_distinct_nosync(batches) -> dict:
    """HashDistinctFlagExec's sizing and the kernel over q28's batches with
    PyTorch's sync debug mode at "error": any blocking host read in the
    loop raises. The error word is read after, outside it."""
    import torch
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    torch.cuda.synchronize()
    table, growths = None, 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for v, vv, g, gv in batches:
            table, grew = dfl.sized_table(
                table, v.device, int(v.shape[0]),
                dfl.HashDistinctFlagExec._MIN_SLOTS)
            growths += grew
            dfl.distinct_flag(table, v, vv, g, gv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host_ms = (time.perf_counter() - t0) * 1e3
    _check(not table.failed(), "distinct_flag set its error word")
    _log(f"distinct_flag: sizing and kernel over q28's {len(batches)} "
         f"batches under set_sync_debug_mode('error'): no blocking host "
         f"read; {growths} growths, {table.capacity} slots at the end "
         f"(keys counted {int(table.keys)}), {host_ms:.2f} ms on the host")
    return {"batches": len(batches), "growths": growths,
            "slots": table.capacity, "host_ms": host_ms}


def distinct_bound(rows: int, new_keys: int) -> dict:
    """The least bytes one batch's flags need: the value and group words
    (8 B each) and their validity (1 B each) read once, the flag (1 B)
    written once, one 32-byte slot read a row and one written a new key."""
    from spark_rapids_tpu_torch.exec.distinct_flag import SLOT_BYTES
    nbytes = rows * (8 + 1 + 8 + 1 + 1 + SLOT_BYTES) + new_keys * SLOT_BYTES
    return {"bytes": nbytes, "ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "by": "bytes"}


def phase_distinct_times(batches, card: str) -> dict:
    """distinct_flag on q28's shape, cold (queued behind a sleep, over
    distinct inputs of at least COLD_BYTES): the first batch against a
    fresh table, apart; then the last full batch (the stream's last is
    the scan's short tail) against a table holding every earlier batch's
    keys. The whole call (synchronised) and the plain version beside
    them."""
    import torch
    from spark_rapids_tpu_torch.exec import distinct_flag as dfl
    first = batches[0]
    n0 = int(first[0].shape[0])
    slots0 = dfl.table_slots(0, n0, 1 << 16)
    # first batch: a fresh table a call (the table is most of the bytes)
    k = max(2, -(-COLD_BYTES // (slots0 * dfl.SLOT_BYTES + 18 * n0)))
    tables = [dfl.sized_table(None, first[0].device, n0, 1 << 16)[0]
              for _ in range(k)]
    inputs = [tuple(None if t is None else t.clone() for t in first)
              for _ in range(k)]
    saved = dfl.distinct_flag.launches
    torch.cuda.synchronize()
    first_ms, first_host = _queued_ms(
        [lambda t=t, x=x: dfl.distinct_flag(t, *x)
         for t, x in zip(tables, inputs)], "distinct_flag first batch")
    new0 = int(dfl.distinct_flag(dfl.sized_table(None, first[0].device, n0,
                                                 1 << 16)[0], *first).sum())
    del tables, inputs
    # the last full batch against the table of the stream before it
    at = max(len(batches) - 2, 0)
    table = None
    for v, vv, g, gv in batches[:at]:
        table, _ = dfl.sized_table(table, v.device, int(v.shape[0]),
                                   1 << 16)
        dfl.distinct_flag(table, v, vv, g, gv)
    last = batches[at]
    n = int(last[0].shape[0])
    table, _ = dfl.sized_table(table, last[0].device, n, 1 << 16)
    new_last = int(dfl.distinct_flag(table, *last).sum())
    per = 18 * n
    copies = [last] + [tuple(None if t is None else t.clone() for t in last)
                       for _ in range(max(1, -(-COLD_BYTES // per) - 1))]
    ms, host_ms = _cold_ms(lambda *x: dfl.distinct_flag(table, *x), copies,
                           f"distinct_flag on q28's batch {at + 1}")
    call_ms, call_host = _call_ms(lambda: dfl.distinct_flag(table, *last))
    dfl.distinct_flag.launches = saved
    seen = dfl.SeenKeys()
    for v, vv, g, gv in batches[:at]:
        dfl.distinct_flag_reference(seen, v, vv, g, gv)
    plain_ms, _ = _call_ms(lambda: dfl.distinct_flag_reference(
        seen, *last), reps=3)
    _check(not table.failed(), "distinct_flag set its error word")
    b = distinct_bound(n, 0)       # every key of the timed copies is found
    b0 = distinct_bound(n0, new0)
    shape = dfl.kernel_shape()
    row = {"ms": ms, "host_ms": host_ms, "call_ms": call_ms,
           "call_host_ms": call_host, "plain_ms": plain_ms,
           "bound_ms": b["ms"], "bound_by": b["by"],
           "bound_bytes": b["bytes"], "rows": n, "slots": table.capacity,
           "batch": at + 1, "batches": len(batches),
           "table_bytes": table.nbytes, "in_l2": table.nbytes <= L2_BYTES,
           "new_keys": new_last,
           "first_batch": {"ms": first_ms, "host_ms": first_host,
                           "rows": n0, "new_keys": new0,
                           "bound_ms": b0["ms"], "bound_bytes": b0["bytes"],
                           "tables": k},
           "launch": shape, "input_copies": len(copies), "card": card}
    _log(f"kernel distinct_flag on q28's batch {at + 1} of {len(batches)} "
         f"({n} rows, {new_last} of their keys new, a table of "
         f"{table.capacity} slots = {table.nbytes} B holding the earlier "
         f"batches' keys, {'within' if row['in_l2'] else 'beyond'} the "
         f"{L2_BYTES} B L2; {shape['registers']} registers, "
         f"{shape['blocks_per_sm']} blocks an SM, a grid of up to "
         f"{shape['grid_threads']} threads), cold: one launch "
         f"{ms:.4f} ms, bound {b['ms']:.4f} ms ({b['bytes']} B, by bytes), "
         f"{b['ms'] / ms:.0%} of bound; host {host_ms:.4f} ms a call "
         f"(enqueue); whole call synchronised {call_ms:.4f} ms on the card, "
         f"{call_host:.4f} ms on the host clock; plain {plain_ms:.4f} ms; "
         f"library ms: none (no PyTorch call computes this function); "
         f"first batch ({n0} rows, {new0} new keys, a fresh table of "
         f"{slots0} slots) {first_ms:.4f} ms, bound "
         f"{b0['ms']:.4f} ms, host {first_host:.4f} ms; {len(copies)} input "
         f"copies [{card}]")
    return row


def _tpcds2_run(session, host, query, right, label: str) -> dict:
    """One run of ``query`` with the launches of every kernel (counts set
    to 0 just before, read just after) and its physical plan."""
    import torch
    from spark_rapids_tpu_torch.exec.dense_groupby import dense_groupby
    from spark_rapids_tpu_torch.exec.distinct_flag import distinct_flag
    from spark_rapids_tpu_torch.exec.join_match import join_match
    from spark_rapids_tpu_torch.exprs.rect_match import rect_match
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = (rect_match, dense_groupby, join_match, distinct_flag)
    for k in counts:
        k.launches = 0
    rows, wall = _run_query(session, host, query)
    launches = {k.__name__: k.launches for k in counts}
    _check(right(rows), f"{label}: wrong result {rows}")
    return {"wall_ms": wall, "launches": launches,
            "max_memory_reserved": torch.cuda.max_memory_reserved(),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}, rows


def _plan_scan(node):
    from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec
    while not isinstance(node, InMemoryScanExec):
        node = node.children[0]
    return node


def phase_tpcds2(card: str, batch_rows: int, ss: dict, ss_host) -> dict:
    """Phase 11: distinct_flag exact and timed, then q9 and q28 at SF10
    over phase 10's store_sales, cold and warm, against numpy, each once
    more under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.api import TorchSession
    exact = phase_distinct_exact()
    t0 = time.perf_counter()
    flag_batches = q28_flag_batches(ss, batch_rows)
    want9, want28 = q9_numpy(ss), q28_numpy(ss)
    keys = sum(r["b_cntd"] for r in want28)
    _log(f"tpcds2 SF10: q9 and q28 in numpy, q28's flag inputs "
         f"({sum(int(b[0].shape[0]) for b in flag_batches)} rows in "
         f"{len(flag_batches)} batches, {keys} distinct (branch, list "
         f"price) keys) in {time.perf_counter() - t0:.2f} s [{card}]")
    times = phase_distinct_times(flag_batches, card)
    nosync = phase_distinct_nosync(flag_batches)
    n_flag_batches = len(flag_batches)
    del flag_batches
    session = TorchSession({"spark.rapids.tpu.sql.batchSizeRows":
                            batch_rows})
    res = {"card": card, "rows": SF10_STORE_SALES, "exact": exact,
           "q28_distinct_keys": keys, "nosync": nosync}
    for name, query, want in (("q9", q9, want9), ("q28", q28, want28)):
        runs = {}
        for label in ("cold", "warm"):
            runs[label], rows = _tpcds2_run(
                session, ss_host, query,
                lambda r, w=want: stats_equal(r, w),
                f"{name} SF10 {label}")
            if name == "q28":
                flag = session.last_plan
                while type(flag).__name__ != "HashDistinctFlagExec":
                    flag = flag.children[0]
                runs[label]["table_slots"] = flag.last_slots
                runs[label]["table_growths"] = flag.last_growths
        plan = session.last_plan.tree_string()
        scan = _plan_scan(session.last_plan)
        runs["plan"] = plan
        runs["scan_batch_rows"] = scan.batch_rows
        c, w = runs["cold"], runs["warm"]
        if name == "q9":
            _check(scan.batch_rows >= SF10_STORE_SALES,
                   f"q9's scan reads batches of {scan.batch_rows} rows, "
                   "not one widened batch")
        else:
            _check("DistinctFlag" in plan and "BranchAlign" in plan
                   and "Union" not in plan
                   and plan.count("InMemoryScan") == 1
                   and "route=dense" in plan, f"q28's plan:\n{plan}")
            for r in (c, w):
                _check(r["launches"]["distinct_flag"]
                       == n_flag_batches + r["table_growths"]
                       and r["launches"]["dense_groupby"] > 0,
                       f"q28 launched {r['launches']} over "
                       f"{n_flag_batches} batches and "
                       f"{r['table_growths']} growths")
                # the row-bound sizing (commit 04f2565) ended at
                # 33,554,432 slots
                _check(r["table_slots"] < (1 << 25) // 8,
                       f"q28's table ended at {r['table_slots']} slots")
            runs["table_slots"] = w["table_slots"]
            _log(f"q28 SF10: distinct_flag launches "
                 f"{c['launches']['distinct_flag']} / "
                 f"{w['launches']['distinct_flag']} ({n_flag_batches} "
                 f"batches, {c['table_growths']} / {w['table_growths']} "
                 f"growths); the table ends at {c['table_slots']} / "
                 f"{w['table_slots']} slots ({w['table_slots'] * 32} B); "
                 f"max_memory_allocated {c['max_memory_allocated']} / "
                 f"{w['max_memory_allocated']} B (cold / warm) [{card}]")
        _log(f"{name} SF10: equal to numpy (counts exact, averages within "
             f"{REL_TOL:g}): {rows}; wall {c['wall_ms']:.1f} ms cold, "
             f"{w['wall_ms']:.1f} ms warm; launches {c['launches']} / "
             f"{w['launches']}; scan batch rows {scan.batch_rows}; "
             f"max_memory_reserved {c['max_memory_reserved']} / "
             f"{w['max_memory_reserved']} B [{card}]")
        _log(f"{name} physical plan:\n{plan}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run, _ = _tpcds2_run(session, ss_host, query,
                                 lambda r, w=want: stats_equal(r, w),
                                 f"{name} under the profiler")
            torch.cuda.synchronize()
        try:
            runs["profile_warm"] = _profile_report(
                prof, run["wall_ms"], f"{name} SF10",
                "distinct_flag" if name == "q28" else "reduce")
        except Exception as e:  # the trace is read for information only
            _log(f"profile: could not be read ({e!r})")
            runs["profile_warm"] = {"device_time": False, "error": repr(e)}
        res[name] = runs
    session.close()
    q28c = res["q28"]["cold"]["launches"]
    res["kernel"] = {
        "name": "distinct_flag", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/distinct_flag.cu",
        "replaces": "spark_rapids_tpu/exec/distinct_flag.py:83",
        "launches": q28c["distinct_flag"],
        "paths": {"q28": q28c["distinct_flag"]},
        "max_abs_err": 0.0, "exact": True,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "bound_bytes": times["bound_bytes"], "library_ms": None,
        "library": "none: no PyTorch call computes this function",
        "host_ms": times["host_ms"], "call_ms": times["call_ms"],
        "first_batch": times["first_batch"],
        "table_bytes": times["table_bytes"], "in_l2": times["in_l2"],
        "q28_table_slots": res["q28"]["table_slots"],
        "timing": "the launch of q28's last full batch queued back to "
                  "back over distinct inputs (L2 cold), against a table "
                  "holding the earlier batches' keys, sized by the key "
                  "count; first_batch: against fresh tables",
        "shape": [times["rows"], times["slots"]],
        "launch": times["launch"],
        "cases": {k: v["route"] for k, v in exact.items()},
    }
    return res


# ---------------------------------------------------------------------------
# phase 12: the SQL front end
# ---------------------------------------------------------------------------

def q9_bucket(store_sales, F, lo: int, hi: int):
    """One q9 bucket as TPCDS_Q9_BUCKET computes it."""
    in_b = ((F.col("ss_quantity") >= F.lit(lo))
            & (F.col("ss_quantity") <= F.lit(hi)))
    return store_sales.agg(
        F.count(F.when(in_b, F.lit(1)).otherwise(F.lit(None)))
        .with_name("cnt"),
        F.avg(F.when(in_b, F.col("ss_ext_sales_price"))
              .otherwise(F.lit(None))).with_name("avg_price"),
        F.avg(F.when(in_b, F.col("ss_net_paid")).otherwise(F.lit(None)))
        .with_name("avg_paid"))


def cte_limit(lineitem, F):
    """SQL_CTE_LIMIT as DataFrame calls."""
    return (lineitem.group_by("l_orderkey")
            .agg(F.sum(F.col("l_quantity")).with_name("q"))
            .filter(F.col("q") > F.lit(60))
            .order_by(F.desc("q"), "l_orderkey").limit(10))


def cte_limit_numpy(t: dict) -> list:
    keys, inv = np.unique(t["l_orderkey"], return_inverse=True)
    qty = np.bincount(inv, weights=t["l_quantity"])
    sel = np.flatnonzero(qty > 60)
    sel = sel[np.lexsort((keys[sel], -qty[sel]))][:10]
    return [{"l_orderkey": int(keys[i]), "q": float(qty[i])} for i in sel]


def _setop_sides(store_sales, F):
    left = store_sales.filter((F.col("ss_quantity") <= F.lit(10))
                              & (F.col("ss_item_sk") < F.lit(300)))
    right = store_sales.filter(F.col("ss_net_paid") > F.lit(19990.0))
    cols = ("ss_item_sk", "ss_quantity")
    return left.select(*cols), right.select(*cols)


def setop(store_sales, F, op: str):
    """SQL_SETOP as DataFrame calls: ``op`` is intersect or subtract."""
    a, b = _setop_sides(store_sales, F)
    return getattr(a, op)(b).order_by("ss_item_sk", "ss_quantity")


def setop_numpy(ss: dict, op: str) -> list:
    q, i = ss["ss_quantity"], ss["ss_item_sk"]
    code = i.astype(np.int64) * 101 + q
    left = np.unique(code[(q <= 10) & (i < 300)])
    right = np.unique(code[ss["ss_net_paid"] > 19990.0])
    keep = np.isin(left, right, invert=op == "subtract")
    return [{"ss_item_sk": int(c // 101), "ss_quantity": int(c % 101)}
            for c in left[keep]]


#: (SQL text, DataFrame form over the views, numpy rows, why the two
#: forms' floats may differ (None: their plans agree up to the top
#: Project, so they must be equal))
def _sql_cases(table: dict, ds: dict) -> dict:
    ss = ds["ss"]
    q9w = q9_numpy(ss)[0]
    return {
        "q1": (TPCH_Q1, lambda s, F: q1(s.table("lineitem"), F),
               q1_numpy(table), None),
        "q6": (TPCH_Q6, lambda s, F: q6(s.table("lineitem"), F),
               [{"revenue": q6_numpy(table)}], None),
        "q3": (TPCDS_Q3, lambda s, F: q3(s.table("store_sales"),
                                         s.table("date_dim"),
                                         s.table("item"), F),
               q3_numpy(ss, ds["dd"], ds["it"]),
               "the SQL joins in FROM order (date_dim broadcast on the "
               "left, the filters after both joins), so the rows reach "
               "each group's sum in another order"),
        "q9_bucket": (TPCDS_Q9_BUCKET.format(lo=21, hi=40),
                      lambda s, F: q9_bucket(s.table("store_sales"), F,
                                             21, 40),
                      [{"cnt": q9w["cnt2"], "avg_price": q9w["avg_price2"],
                        "avg_paid": q9w["avg_paid2"]}], None),
        "q28": (TPCDS_Q28, lambda s, F: q28(s.table("store_sales"), F),
                q28_numpy(ss),
                "the SQL runs six passes (a Project over each branch's "
                "aggregate keeps the union-of-aggregates rewrite off), the "
                "DataFrame form one, so each average adds its rows in "
                "another order"),
        "like": (SQL_LIKE, lambda s, F: s.table("lineitem").filter(
            F.col("l_comment").like("%special%")).agg(
            F.count_star().with_name("__agg0")),
            [{"__agg0": q_comment_numpy(table)[0]}], None),
        "cte_limit": (SQL_CTE_LIMIT, lambda s, F: cte_limit(
            s.table("lineitem"), F), cte_limit_numpy(table), None),
        "intersect": (SQL_SETOP.format(op="INTERSECT"),
                      lambda s, F: setop(s.table("store_sales"), F,
                                         "intersect"),
                      setop_numpy(ss, "intersect"), None),
        "except": (SQL_SETOP.format(op="EXCEPT"),
                   lambda s, F: setop(s.table("store_sales"), F,
                                      "subtract"),
                   setop_numpy(ss, "subtract"), None),
    }


#: the kernels each text's plan must launch
SQL_KERNELS = {"q1": ("dense_groupby",), "q3": ("join_match",),
               "q28": ("distinct_flag",), "like": ("rect_match",),
               "intersect": ("join_match",), "except": ("join_match",)}


def _kernel_counters():
    from spark_rapids_tpu_torch.exec.dense_groupby import dense_groupby
    from spark_rapids_tpu_torch.exec.distinct_flag import distinct_flag
    from spark_rapids_tpu_torch.exec.join_match import join_match
    from spark_rapids_tpu_torch.exec.rect_dfa import rect_dfa
    from spark_rapids_tpu_torch.exec.rect_transform import rect_transform
    from spark_rapids_tpu_torch.exec.sort_bucket import sort_bucket
    from spark_rapids_tpu_torch.exec.window_frame import window_frame
    from spark_rapids_tpu_torch.exprs.decimal_arith import decimal_arith
    from spark_rapids_tpu_torch.exprs.rect_match import rect_match
    return (rect_match, dense_groupby, join_match, distinct_flag,
            rect_transform, window_frame, sort_bucket, decimal_arith,
            rect_dfa)


def _sql_run(session, make, collect: str = "collect") -> tuple:
    """One run of ``make(session)`` (a SQL text's lowering, or a DataFrame
    form's calls), then its ``collect`` (``collect`` or ``collect_numpy``):
    the rows, the ms of each part, every kernel's launches (counts set to
    0 just before, read just after) and the allocator's peak."""
    import torch
    counters = _kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    df = make(session)
    t1 = time.perf_counter()
    rows = getattr(df, collect)()
    t2 = time.perf_counter()
    return {"lower_ms": (t1 - t0) * 1e3, "exec_ms": (t2 - t1) * 1e3,
            "wall_ms": (t2 - t0) * 1e3,
            "launches": {k.__name__: k.launches for k in counters},
            "max_memory_allocated": torch.cuda.max_memory_allocated()}, rows


def _rows_close(got: list, want: list, rel: float) -> bool:
    """Same rows in order, by position within a row: floats within
    ``rel`` (0: bit-equal), Decimals equal at the same scale (Spark's
    result type's), everything else exactly."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        gv, wv = list(g.values()), list(w.values())
        if len(gv) != len(wv):
            return False
        for a, b in zip(gv, wv):
            if isinstance(b, float) and isinstance(a, float):
                if not (a == b or (rel and _rel(a, b) <= rel)):
                    return False
            elif a != b:
                return False
            elif isinstance(b, decimal.Decimal) and (
                    not isinstance(a, decimal.Decimal)
                    or a.as_tuple().exponent != b.as_tuple().exponent):
                return False
    return True


def _broadcast_sides(plan: str) -> list:
    return re.findall(r"BroadcastHashJoin\[(\w+),.*build=(\w+)\]", plan)


def phase_sql(card: str, batch_rows: int, table: dict, host, ds: dict,
              tpcds2: dict) -> dict:
    """Phase 12: SQL texts through ``TorchSession.sql`` over phase 4's SF1
    lineitem and phase 10's SF10 store_sales, date_dim and item as temp
    views, each cold and warm: equal to the DataFrame form of the same
    query in the same session (bit-equal where the plans agree up to the
    top Project, else within REL_TOL, saying why) and to numpy, with
    every kernel's launches beside the DataFrame form's; q3 and q28, whose
    plans differ from their DataFrame forms', once more under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    t_phase = time.perf_counter()
    # 1,048,576-row batches under the keyless aggregates too, as phases
    # 4-9: the per-batch launch counts rest on it
    session = TorchSession({
        "spark.rapids.tpu.sql.batchSizeRows": batch_rows,
        "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows,
        "spark.rapids.tpu.sql.pallas.enabled": True})
    _check(session.device.type == "cuda", "session is not on cuda")
    for name, h in (("lineitem", host), ("store_sales", ds["hosts"][0]),
                    ("date_dim", ds["hosts"][1]), ("item", ds["hosts"][2])):
        session.create_dataframe(h).create_or_replace_temp_view(name)
    li_batches = math.ceil(SF1_ROWS / batch_rows)
    ss_batches = math.ceil(SF10_STORE_SALES / batch_rows)
    expect = {"q1": {"dense_groupby": li_batches},
              "like": {"rect_match": li_batches}}
    res = {"card": card}
    for name, (text, frame, want, why) in _sql_cases(table, ds).items():
        runs = {}
        for label in ("cold", "warm"):
            runs[label], rows = _sql_run(session, lambda s: s.sql(text))
            _check(rows_equal(rows, want) if name not in ("q3", "q28")
                   else (q3_equal(rows, want) if name == "q3"
                         else stats_equal(rows, want)),
                   f"SQL {name} {label}: {rows[:6]} != numpy {want[:6]}")
        plan = session.last_plan.tree_string()
        runs["dataframe"], df_rows = _sql_run(session,
                                              lambda s: frame(s, F))
        df_plan = session.last_plan.tree_string()
        _check(_rows_close(rows, df_rows, REL_TOL if why else 0.0),
               f"SQL {name} {rows[:6]} != its DataFrame form "
               f"{df_rows[:6]}")
        for label in ("cold", "warm"):
            got = runs[label]["launches"]
            for k in SQL_KERNELS.get(name, ()):
                _check(got[k] > 0, f"SQL {name} {label}: {k} never "
                       f"launched ({got})")
            for k, n in expect.get(name, {}).items():
                _check(got[k] == n, f"SQL {name} {label}: {k} launched "
                       f"{got[k]} times, expected {n} (one a batch)")
        if name == "q28":
            for label in ("cold", "warm"):
                n = runs[label]["launches"]["distinct_flag"]
                _check(n >= 6 * ss_batches,
                       f"SQL q28 {label}: distinct_flag launched {n} times, "
                       f"fewer than 6 passes x {ss_batches} batches")
            _check(plan.count("HashDistinctFlag") == 6
                   and plan.count("InMemoryScan") == 6,
                   f"SQL q28's plan is not six passes:\n{plan}")
        if name in ("q3", "q28"):
            # the two texts whose plans differ from their DataFrame
            # forms: where their warm time goes
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run, _ = _sql_run(session, lambda s: s.sql(text))
                torch.cuda.synchronize()
            try:
                runs["profile_warm"] = _profile_report(
                    prof, run["wall_ms"], f"SQL {name}",
                    SQL_KERNELS[name][0])
            except Exception as e:  # read for information only
                _log(f"profile: could not be read ({e!r})")
                runs["profile_warm"] = {"device_time": False,
                                        "error": repr(e)}
        sides = _broadcast_sides(plan)
        runs.update({"plan": plan, "dataframe_plan": df_plan,
                     "broadcast": sides, "exact": why is None,
                     "why_not_exact": why})
        c, w, d = runs["cold"], runs["warm"], runs["dataframe"]
        how = "bit-equal" if why is None else f"within {REL_TOL:g}: {why}"
        _log(f"SQL {name}: equal to numpy and to its DataFrame form "
             f"({how}); {len(rows)} rows; cold {c['wall_ms']:.1f} ms (parse and "
             f"lower {c['lower_ms']:.2f} ms), warm {w['wall_ms']:.1f} ms "
             f"(parse and lower {w['lower_ms']:.2f} ms); DataFrame form "
             f"{d['wall_ms']:.1f} ms; launches cold {c['launches']}, warm "
             f"{w['launches']}, DataFrame form {d['launches']}"
             + (f"; broadcast joins (type, build side) {sides}"
                if sides else "") + f" [{card}]")
        _log(f"SQL {name} physical plan:\n{plan}")
        if name in ("q3", "q28"):
            _log(f"SQL {name}'s DataFrame form, physical plan:\n{df_plan}")
        res[name] = runs
    df28 = tpcds2["q28"]["warm"]["wall_ms"]
    _log(f"SQL q28 warm {res['q28']['warm']['wall_ms']:.1f} ms (six passes, "
         f"{res['q28']['warm']['launches']['distinct_flag']} distinct_flag "
         f"launches) against the DataFrame q28 warm: "
         f"{res['q28']['dataframe']['wall_ms']:.1f} ms in this session, "
         f"{df28:.1f} ms in phase 11 (one pass) [{card}]")
    session.close()
    res["seconds"] = time.perf_counter() - t_phase
    _log(f"phase 12 (sql): {res['seconds']:.1f} s [{card}]")
    return res


# ---------------------------------------------------------------------------
# the operator gaps: string IN, count(string), min/max/first/last, and the
# aggregate's repartitioned merge
# ---------------------------------------------------------------------------

def q12_in(df, F):
    """TPC-H Q12's shipping-mode filter as written there: l_shipmode IN
    ('MAIL', 'SHIP') over a receipt-date year, then a count and revenue
    by mode."""
    return (df.filter(F.col("l_shipmode").isin("MAIL", "SHIP")
                      & (F.col("l_receiptdate") >= F.lit(
                          np.datetime64("1994-01-01")))
                      & (F.col("l_receiptdate") < F.lit(
                          np.datetime64("1995-01-01"))))
            .group_by("l_shipmode")
            .agg(F.count_star().with_name("n"),
                 F.sum(F.col("l_extendedprice")
                       * (F.lit(1.0) - F.col("l_discount")))
                 .with_name("revenue"))
            .order_by("l_shipmode"))


def q12_in_numpy(t: dict) -> list:
    rd, mode = t["l_receiptdate"], t["l_shipmode"]
    keep = (((mode == "MAIL") | (mode == "SHIP"))
            & (rd >= np.datetime64("1994-01-01"))
            & (rd < np.datetime64("1995-01-01")))
    rev = t["l_extendedprice"] * (1.0 - t["l_discount"])
    return [{"l_shipmode": str(m), "n": int((keep & (mode == m)).sum()),
             "revenue": float(rev[keep & (mode == m)].sum())}
            for m in np.unique(mode[keep])]


def q_extremes(df, F):
    """count(l_comment), and min, max, first and last of l_extendedprice
    and l_shipdate by l_returnflag."""
    aggs = [F.count(F.col("l_comment")).with_name("n_comment")]
    for c in ("l_extendedprice", "l_shipdate"):
        aggs += [F.min(F.col(c)).with_name(f"min_{c}"),
                 F.max(F.col(c)).with_name(f"max_{c}"),
                 F.first(F.col(c)).with_name(f"first_{c}"),
                 F.last(F.col(c)).with_name(f"last_{c}")]
    return df.group_by("l_returnflag").agg(*aggs).order_by("l_returnflag")


def q_extremes_numpy(t: dict) -> list:
    import datetime
    out = []
    flags = t["l_returnflag"]
    for f in np.unique(flags):
        idx = np.flatnonzero(flags == f)
        row = {"l_returnflag": str(f), "n_comment": len(idx)}
        for c in ("l_extendedprice", "l_shipdate"):
            v = t[c][idx]
            vals = [v.min(), v.max(), v[0], v[-1]]
            if c == "l_shipdate":
                vals = [datetime.date(1970, 1, 1) + datetime.timedelta(
                    days=int(x.astype("datetime64[D]").astype(np.int64)))
                    for x in vals]
            else:
                vals = [float(x) for x in vals]
            for k, x in zip(("min", "max", "first", "last"), vals):
                row[f"{k}_{c}"] = x
        out.append(row)
    return out


def phase_operator_gaps(conf, table, host, n_batches: int,
                        card: str) -> dict:
    """The operator gaps at SF1 on the card, each cold and warm against
    numpy: q12_in (the IN filter over the l_shipmode dictionary; the
    aggregate's dense_groupby once a batch), q_extremes (count of a string
    column and min/max/first/last, which take the sort path: no
    dense_groupby). Returns the runs and q12_in's rows (for the Parquet
    phase)."""
    from spark_rapids_tpu_torch.api import TorchSession
    session = TorchSession(conf)
    out = {}
    want = q12_in_numpy(table)
    out["q12_in"] = _cold_warm(session, host, q12_in,
                               lambda r: rows_equal(r, want),
                               f"q12_in SF1 [{card}]")
    for run in out["q12_in"].values():
        _check(run["launches"] == {"rect_match": 0,
                                   "dense_groupby": n_batches},
               f"q12_in launches {run['launches']}")
    plan = session.last_plan.tree_string()
    _check("dict_eval" in plan, f"q12_in's IN filter is not on the "
                                f"dictionary route:\n{plan}")
    _log(f"q12_in result {want}")
    want_x = q_extremes_numpy(table)

    def right_x(rows):
        return len(rows) == len(want_x) and all(
            all(g[k] == w[k] for k in w) for g, w in zip(rows, want_x))
    out["q_extremes"] = _cold_warm(session, host, q_extremes, right_x,
                                   f"q_extremes SF1 [{card}]")
    for run in out["q_extremes"].values():
        _check(run["launches"]["dense_groupby"] == 0,
               "q_extremes launched dense_groupby: min/max/first/last must "
               "take the sort path")
    plan = session.last_plan.tree_string()
    _check("route=sort" in plan, f"q_extremes' route is not in its "
                                 f"plan:\n{plan}")
    _log(f"q_extremes result {want_x}")
    rows, _ = _run_query(session, host, q12_in)
    session.close()
    return out, rows


def phase_q18_repartitioned(conf, host, table, parts, budget: int,
                            card: str) -> dict:
    """q18_agg under PR 5's spilling budget with batchSizeBytes at the
    largest partial: the partials exceed it, so they merge through the
    repartitioned merge instead of the fan-in tree."""
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
    want18 = q18_agg_numpy(table)
    session = TorchSession({
        **conf, "spark.rapids.tpu.memory.hbm.limitBytes": budget,
        "spark.rapids.tpu.memory.host.spillStorageSize": budget // 2,
        "spark.rapids.tpu.sql.batchSizeBytes": max(parts),
        "spark.rapids.tpu.memory.leakDetection": True})
    out = _cold_warm(session, host, q18_agg,
                     lambda r: rows_equal(r, want18),
                     f"q18_agg SF1 under pressure, repartitioned merge "
                     f"[{card}]")
    node = session.last_plan
    while not isinstance(node, TpuHashAggregateExec):
        node = node.children[0]
    _check(node.last_repartitions >= 2,
           f"q18_agg did not take the repartitioned merge "
           f"({node.last_repartitions} partitions)")
    out["partitions"] = node.last_repartitions
    out["batch_size_bytes"] = max(parts)
    _log(f"q18_agg repartitioned merge: {node.last_repartitions} partitions "
         f"(batchSizeBytes {max(parts)} B, partials {sum(parts)} B, budget "
         f"{budget} B) [{card}]")
    session.close()
    return out


# ---------------------------------------------------------------------------
# phase 8: Parquet
# ---------------------------------------------------------------------------

def q_codes(df, F):
    """A count by return flag and shipping mode over two years of
    l_shipdate: only int, date and dictionary-code columns, so its
    batches are ones the transfer encode narrows (q1's float columns
    keep its batches raw)."""
    lo, hi = np.datetime64("1994-01-01"), np.datetime64("1996-01-01")
    return (df.filter((F.col("l_shipdate") >= F.lit(lo))
                      & (F.col("l_shipdate") < F.lit(hi)))
            .group_by("l_returnflag", "l_shipmode")
            .agg(F.count_star().with_name("n"),
                 F.sum(F.col("l_orderkey")).with_name("sum_orderkey"))
            .order_by("l_returnflag", "l_shipmode"))


def q_codes_numpy(t: dict) -> list:
    sd = t["l_shipdate"]
    keep = (sd >= np.datetime64("1994-01-01")) & \
        (sd < np.datetime64("1996-01-01"))
    flag, mode = t["l_returnflag"][keep], t["l_shipmode"][keep]
    ok = t["l_orderkey"][keep].astype(np.int64)
    return [{"l_returnflag": str(f), "l_shipmode": str(m),
             "n": int(((flag == f) & (mode == m)).sum()),
             "sum_orderkey": int(ok[(flag == f) & (mode == m)].sum())}
            for f in np.unique(flag) for m in np.unique(mode)
            if ((flag == f) & (mode == m)).any()]


def rung1(df, F):
    """Ladder rung 1: a filter and a projection that use every ported
    arithmetic expression, with divisors that are zero in some rows
    (l_discount and l_tax are 0.00 in about one row in ten; the modular
    divisors are 0 for one part key in 5, 7 or 9) and one nullable
    operand (l_partkey)."""
    ok, pk = F.col("l_orderkey"), F.col("l_partkey")
    return (df.filter((F.col("l_quantity") >= F.lit(40.0))
                      & (F.col("l_discount") <= F.lit(0.05)))
            .select(
                ok,
                (F.col("l_extendedprice") / F.col("l_discount"))
                .alias("price_per_disc"),
                F.div(ok, pk % F.lit(7)).alias("ok_div"),
                (ok % (pk % F.lit(5))).alias("ok_mod"),
                F.pmod(-ok, pk % F.lit(9) - F.lit(4)).alias("ok_pmod"),
                (F.col("l_quantity") % F.col("l_tax")).alias("qty_mod_tax"),
                (-F.col("l_extendedprice")).alias("neg_price"),
                F.abs(F.col("l_quantity") - F.lit(45.0)).alias("abs_qty"),
                (+F.col("l_tax")).alias("pos_tax"),
                ok.bitwiseAND(pk).alias("bit_and"),
                ok.bitwiseOR(F.lit(0x55)).alias("bit_or"),
                ok.bitwiseXOR(pk).alias("bit_xor"),
                F.bitwise_not(pk).alias("bit_not"),
                F.shiftleft(ok, F.lit(3)).alias("shl"),
                F.shiftright(-pk, F.lit(2)).alias("shr"),
                F.shiftrightunsigned(-ok, F.lit(60)).alias("shru")))


def rung1_numpy(t: dict) -> dict:
    """rung1's columns as (values, valid) from numpy: integers by Java's
    rules, each float column one IEEE operation a row."""
    keep = (t["l_quantity"] >= 40.0) & (t["l_discount"] <= 0.05)
    ok = t["l_orderkey"][keep].astype(np.int64)
    pkm = t["l_partkey"][keep]
    pk, pv = pkm.data.astype(np.int64), ~np.ma.getmaskarray(pkm)
    price, disc = t["l_extendedprice"][keep], t["l_discount"][keep]
    qty, tax = t["l_quantity"][keep], t["l_tax"][keep]
    ones = np.ones(len(ok), bool)

    def jdiv(a, b):
        b1 = np.where(b == 0, 1, b)
        q = np.abs(a) // np.abs(b1)
        return np.where((a < 0) != (b1 < 0), -q, q)

    def jmod(a, b):
        return np.fmod(a, np.where(b == 0, 1, b))

    with np.errstate(all="ignore"):
        out = {"l_orderkey": (ok, ones),
               "price_per_disc": (price / np.where(disc == 0, 1.0, disc),
                                  disc != 0)}
        d7, d5, d9 = pk % 7, pk % 5, pk % 9 - 4
        out["ok_div"] = (jdiv(ok, d7), pv & (d7 != 0))
        out["ok_mod"] = (jmod(ok, d5), pv & (d5 != 0))
        m = jmod(-ok, d9)
        out["ok_pmod"] = (np.where(m < 0, jmod(m + d9, d9), m),
                          pv & (d9 != 0))
        out["qty_mod_tax"] = (np.fmod(qty, np.where(tax == 0, 1.0, tax)),
                              tax != 0)
    out["neg_price"] = (-price, ones)
    out["abs_qty"] = (np.abs(qty - 45.0), ones)
    out["pos_tax"] = (tax, ones)
    out["bit_and"] = (ok & pk, pv)
    out["bit_or"] = (ok | 0x55, ones)
    out["bit_xor"] = (ok ^ pk, pv)
    out["bit_not"] = (~pk, pv)
    out["shl"] = (ok << 3, ones)
    out["shr"] = ((-pk) >> 2, pv)
    out["shru"] = (((-ok).view(np.uint64) >> np.uint64(60)).view(np.int64),
                   ones)
    return out


def rung1_equal(got: dict, want: dict) -> list:
    """The columns that differ: validity exactly, values exactly (floats
    bit for bit) where valid."""
    bad = []
    for name, (w, wv) in want.items():
        g = got[name]
        gv = ~np.ma.getmaskarray(g)
        gd = np.ma.getdata(g)
        if len(gd) != len(w) or not np.array_equal(gv, wv):
            bad.append(name)
            continue
        if w.dtype.kind == "f":
            same = gd[wv].view(np.int64) == w[wv].view(np.int64)
        else:
            same = gd[wv] == w[wv]
        if not same.all():
            bad.append(name)
    return bad


def _scan_node(physical):
    from spark_rapids_tpu_torch.io.parquet import ParquetScanExec
    node = physical
    while not isinstance(node, ParquetScanExec):
        node = node.children[0]
    return node


def _timed_scan_query(session, paths, query):
    """One run of ``query`` over ``paths`` with the scan's stage timings:
    (rows, wall ms, the scan's timings)."""
    import torch
    from spark_rapids_tpu_torch.api import functions as F
    t0 = time.perf_counter()
    df = query(session.read_parquet(*paths), F)
    physical = df._physical()
    ctx = session.exec_context()
    cols = physical.collect(ctx)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    names = physical.output_schema().names()
    rows = [dict(zip(names, r)) for r in zip(*[
        [None if not ok else (v.item() if hasattr(v, "item") else v)
         for v, ok in zip(vals, valid)] for vals, valid in cols])]
    return rows, wall, _scan_node(physical).timings


def _split_line(label: str, wall: float, tm: dict) -> dict:
    parts = {k: tm.get(k, 0.0) * 1e3 for k in ("read_s", "decode_s",
                                              "encode_s", "copy_s")}
    rest = wall - sum(parts.values())
    _log(f"{label}: wall {wall:.1f} ms = file read {parts['read_s']:.1f} + "
         f"host decode {parts['decode_s']:.1f} + string encode "
         f"{parts['encode_s']:.1f} + host-to-device copy "
         f"{parts['copy_s']:.1f} + the rest (device work and host dispatch)"
         f" {rest:.1f} ms; {tm.get('file_bytes', 0)} file bytes, "
         f"{tm.get('batches', 0)} batches")
    return {"wall_ms": wall, **{k[:-2] + "_ms": v for k, v in parts.items()},
            "rest_ms": rest, "file_bytes": tm.get("file_bytes", 0),
            "batches": tm.get("batches", 0)}


def _transfer_times(table: dict, batch_rows: int, card: str) -> dict:
    """lineitem's int, date and dictionary-code columns of the first
    batch through the transfer encode (q1's batch does not qualify: its
    four float columns keep it above the ratio): the host encode, the
    one pinned copy and the decode on the card (CUDA events over
    repeated calls), beside the plain copies of the raw columns that the
    encode-off route makes."""
    import torch
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.columnar.batch import _try_dict_encode
    from spark_rapids_tpu_torch.columnar.strrect import utf8_bytes
    sl = slice(0, batch_rows)
    ones = np.ones(min(batch_rows, len(table["l_orderkey"])), bool)
    pairs = [(table["l_orderkey"][sl].astype(np.int64), ones)]
    for c in ("l_shipdate", "l_receiptdate"):
        pairs.append((table[c][sl].astype("datetime64[D]").astype(np.int64)
                      .astype(np.int32), ones))
    for c in ("l_returnflag", "l_linestatus", "l_shipmode"):
        pairs.append((_try_dict_encode(utf8_bytes(table[c][sl], ones), ones,
                                       len(ones))[0], ones))
    n = len(ones)
    t0 = time.perf_counter()
    flat, specs, params, ratio, raw = transfer.encode_columns(pairs)
    enc_ms = (time.perf_counter() - t0) * 1e3
    _check(transfer.worthwhile(ratio, raw), "q1's batch does not encode")
    reps = 20
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        dev = transfer.copy_to_device(flat, "cuda")
    ev[1].record()
    for _ in range(reps):
        out = transfer.decode_columns(dev, specs, params, n, "cuda")
    ev[2].record()
    for _ in range(reps):
        plain = [(torch.from_numpy(d).to("cuda"), torch.from_numpy(v)
                  .to("cuda")) for d, v in pairs]
    ev[3].record()
    torch.cuda.synchronize()
    for (d, v), (gd, gv) in zip(pairs, out):
        _check(np.array_equal(gd.cpu().numpy(), d)
               and np.array_equal(gv.cpu().numpy(), v),
               "the transfer decode changed a column")
    del plain
    res = {"rows": n, "raw_bytes": raw,
           "encoded_bytes": int(sum(a.nbytes for a in flat)),
           "host_encode_ms": enc_ms,
           "pinned_copy_ms": ev[0].elapsed_time(ev[1]) / reps,
           "decode_ms": ev[1].elapsed_time(ev[2]) / reps,
           "raw_copies_ms": ev[2].elapsed_time(ev[3]) / reps}
    _log(f"transfer encode of a batch of lineitem's int, date and code "
         f"columns ({n} rows, {len(pairs)} columns): "
         f"{raw} B raw -> {res['encoded_bytes']} B; host encode "
         f"{enc_ms:.2f} ms, one pinned copy {res['pinned_copy_ms']:.3f} ms,"
         f" decode on the card {res['decode_ms']:.3f} ms a batch; the "
         f"encode-off route's copies {res['raw_copies_ms']:.3f} ms [{card}]")
    return res


def phase_parquet(table: dict, inmem: dict, batch_rows: int,
                  card: str) -> dict:
    """Phase 8: lineitem written to Parquet by the script's own writer
    and read back by the port's reader (no pyarrow), on the card.

    The writer (numpy and zlib) makes six files of one row group each
    (the in-memory scan's six batches), PLAIN numbers and dates,
    RLE_DICTIONARY for the four low-cardinality strings, PLAIN
    l_comment, the nullable l_partkey with definition levels, data pages
    v1 and v2 in turn and the last file in GZIP; and one file sorted by
    l_shipdate in row groups of 65,536 rows. Nothing on the card writes
    SNAPPY: its decompression is the same g++ code on both machines, and
    the CPU tests hold it against pyarrow's files.

    Checks: q6, q1 and q_comment over the files equal the in-memory
    results exactly, with dense_groupby and rect_match once a batch;
    rung 1 cold and warm against numpy; q1 over the sorted file in
    65,533-row batches (so that each row group ends in a 3-row batch,
    a byte rectangle where its three return flags differ: fault C1) equal
    to numpy; a l_shipdate range keeps the row groups numpy says may
    match. Prints the cold wall split (file read, host decode, string
    encode, copy, the rest) with the transfer encode on and off, for q1
    and for q_codes (int, date and code columns only), PERFILE
    against MULTITHREADED, the transfer decode's time a batch, and the
    host library's decode rate per encoding; every reading with the
    card's name and power limit."""
    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar import ByteRectColumn, DeviceColumn
    from spark_rapids_tpu_torch.exec.dense_groupby import dense_groupby
    from spark_rapids_tpu_torch.exprs.rect_match import rect_match
    from spark_rapids_tpu_torch.io.parquet import ParquetScanExec
    from spark_rapids_tpu_torch.io.parquet_meta import read_footer

    rows = len(table["l_orderkey"])
    n_batches = math.ceil(rows / batch_rows)
    out_dir = Path(__file__).resolve().parent / "build" / "parquet"
    t0 = time.perf_counter()
    full = {**table, **gen_parquet_extra(rows)}
    written = write_lineitem_parquet(full, str(out_dir), files=n_batches,
                                     batch_rows=batch_rows)
    files = [p for p, _, _ in written["files"]]
    prune = written["prune"][0]
    nbytes = sum(Path(p).stat().st_size for p in files + [prune])
    _log(f"parquet: {len(files)} files + the sorted one, {nbytes} bytes, "
         f"written in {time.perf_counter() - t0:.2f} s")
    base = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    res: dict = {"card": card, "file_bytes": nbytes}

    # q6, q1, q_comment over the files == the in-memory results
    on = TorchSession({**base, "spark.rapids.tpu.sql.pallas.enabled": True})
    for name, query, kernel in (("q6", q6, None), ("q1", q1, dense_groupby),
                                ("q_comment", q_comment, rect_match),
                                ("q12_in", q12_in, dense_groupby)):
        dense_groupby.launches = rect_match.launches = 0
        t1 = time.perf_counter()
        got = query(on.read_parquet(*files), F).collect()
        wall = (time.perf_counter() - t1) * 1e3
        launches = {"dense_groupby": dense_groupby.launches,
                    "rect_match": rect_match.launches}
        _check(got == inmem[name], f"{name} over Parquet {got} != in-memory "
               f"{inmem[name]}")
        if kernel is not None:
            _check(kernel.launches == n_batches,
                   f"{name} over Parquet launched {kernel.launches} times, "
                   f"expected {n_batches}")
        _log(f"{name} over Parquet: equal to the in-memory result exactly; "
             f"wall {wall:.1f} ms (each run reads the files); launches "
             f"{launches} over {n_batches} batches [{card}]")
        res[name] = {"wall_ms": wall, "launches": launches}

    # rung 1, cold (first read of the query's columns) and warm
    want = rung1_numpy(full)
    r1 = {}
    for label in ("cold", "warm"):
        t1 = time.perf_counter()
        got = rung1(on.read_parquet(*files), F).collect_numpy()
        r1[label] = (time.perf_counter() - t1) * 1e3
        bad = rung1_equal(got, want)
        _check(not bad, f"rung 1 {label}: columns {bad} differ from numpy")
    nulls = {k: int((~v).sum()) for k, (_, v) in want.items() if not v.all()}
    _log(f"rung 1 over Parquet: {len(want['l_orderkey'][0])} rows x "
         f"{len(want)} columns equal to numpy (integers exactly, floats bit "
         f"for bit); nulls by column {nulls}; wall {r1['cold']:.1f} ms cold, "
         f"{r1['warm']:.1f} ms warm [{card}]")
    res["rung1"] = {"rows": len(want["l_orderkey"][0]), "nulls": nulls,
                    "wall_ms_cold": r1["cold"], "wall_ms_warm": r1["warm"]}

    # fault C1 at scale: 65,533-row batches over the sorted file
    c1 = TorchSession({"spark.rapids.tpu.sql.batchSizeRows": 65533})
    rects = total = 0
    scan = _scan_node(c1.read_parquet(prune, columns=["l_returnflag"])
                      ._physical())
    for b in scan.execute(c1.exec_context()):
        total += 1
        c = b.columns[0]
        _check(isinstance(c, DeviceColumn) and c.data.is_cuda,
               f"the scan yielded {c!r} off the card")
        rects += isinstance(c, ByteRectColumn)
    want1 = q1_numpy(table)
    got = q1(c1.read_parquet(prune), F).collect()
    _check(rects > 0, "no l_returnflag batch arrived as a byte rectangle")
    _check(q1_equal(got, want1), f"q1 over 65,533-row batches {got} != "
           f"numpy {want1}")
    _log(f"C1 at scale: q1 over {total} batches of the sorted file, "
         f"{rects} of whose l_returnflag batches arrived as byte "
         f"rectangles, equals numpy [{card}]")
    res["c1"] = {"batches": total, "rect_batches": rects}

    # pruning: a l_shipdate range over the sorted file
    lo, hi = np.datetime64("1995-03-15"), np.datetime64("1995-06-01")
    sd = full["l_shipdate"][written["prune_order"]]
    g = 1 << 16
    may = [i for i in range(-(-rows // g))
           if sd[i * g] < hi and sd[min((i + 1) * g, rows) - 1] >= lo]
    meas = TorchSession({**base, "spark.rapids.tpu.io.scanTimings.enabled":
                         True})

    def ranged(df, F):
        return (df.filter((F.col("l_shipdate") >= F.lit(lo))
                          & (F.col("l_shipdate") < F.lit(hi)))
                .agg(F.count_star().with_name("n"),
                     F.sum(F.col("l_extendedprice")).with_name("revenue")))
    got, wall, tm = _timed_scan_query(meas, [prune], ranged)
    keep = (full["l_shipdate"] >= lo) & (full["l_shipdate"] < hi)
    kept = _scan_node(ranged(meas.read_parquet(prune), F)._physical()) \
        ._filter_row_groups(read_footer(prune))
    _check(kept == may, f"pruning kept row groups {kept}, numpy says {may}")
    _check(tm["row_groups_read"] == len(may), f"read {tm['row_groups_read']}"
           f" row groups, {len(may)} may match")
    _check(got[0]["n"] == int(keep.sum()) and _rel(
        got[0]["revenue"], float(full["l_extendedprice"][keep].sum()))
        <= REL_TOL, f"pruned query {got} != numpy")
    _log(f"pruning: l_shipdate in [{lo}, {hi}) read {tm['row_groups_read']}"
         f" of {tm['row_groups']} row groups (numpy: {len(may)} may match); "
         f"{got[0]['n']} rows; wall {wall:.1f} ms [{card}]")
    res["pruning"] = {"read": tm["row_groups_read"],
                      "of": tm["row_groups"], "wall_ms": wall}

    # the cold wall split, transfer encode on and off, in turns: q1 (its
    # batches stay raw either way) and q_codes (its batches narrow)
    res["split"] = {}
    want_codes = q_codes_numpy(full)
    for name, query, right in (("q1", q1, lambda r: q1_equal(r, want1)),
                               ("q_codes", q_codes,
                                lambda r: r == want_codes)):
        for turn, enc in enumerate((True, False, False, True)):
            s = TorchSession({
                **base, "spark.rapids.tpu.io.scanTimings.enabled": True,
                "spark.rapids.tpu.sql.transferEncode.enabled": enc,
                "spark.rapids.tpu.sql.format.parquet.reader.type":
                "PERFILE"})
            got, wall, tm = _timed_scan_query(s, files, query)
            _check(right(got), f"{name} (encode {enc}) {got} != numpy")
            res["split"].setdefault(name, {}).setdefault(
                "on" if enc else "off", []).append(_split_line(
                    f"{name} over Parquet, PERFILE, transfer encode "
                    f"{'on' if enc else 'off'} (turn {turn + 1}) [{card}]",
                    wall, tm))

    res["transfer"] = _transfer_times(table, batch_rows, card)

    # PERFILE against MULTITHREADED, in turns
    res["modes"] = {}
    for mode in ("PERFILE", "MULTITHREADED", "MULTITHREADED", "PERFILE"):
        s = TorchSession({**base, "spark.rapids.tpu.sql.format.parquet"
                          ".reader.type": mode})
        t1 = time.perf_counter()
        got = q1(s.read_parquet(*files), F).collect()
        wall = (time.perf_counter() - t1) * 1e3
        _check(q1_equal(got, want1), f"q1 ({mode}) {got} != numpy")
        res["modes"].setdefault(mode, []).append(wall)
    _log(f"q1 over Parquet by reader: PERFILE {res['modes']['PERFILE']} ms, "
         f"MULTITHREADED {res['modes']['MULTITHREADED']} ms [{card}]")

    # the host library's decode rate per encoding: every column of the
    # six files, one reader thread
    s = TorchSession({**base, "spark.rapids.tpu.io.scanTimings.enabled":
                      True, "spark.rapids.tpu.sql.format.parquet.reader"
                      ".type": "PERFILE"})
    df = s.read_parquet(*files)
    scan = ParquetScanExec(files, df.schema(), None, s.conf)
    t1 = time.perf_counter()
    n = sum(b.num_rows for b in scan.execute(s.exec_context()))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    _check(n == rows, f"full scan gave {n} rows")
    rates = {k: {"bytes": b, "ms": t * 1e3, "mb_s": b / t / 1e6}
             for k, (b, t) in scan.timings.get("rates", {}).items() if t}
    _log("host decode rate by encoding (all columns of the six files): "
         + "; ".join(f"{k} {v['mb_s']:.0f} MB/s ({v['bytes']} B in "
                     f"{v['ms']:.1f} ms)" for k, v in sorted(rates.items()))
         + f" [{card}]")
    res["full_scan"] = _split_line(f"full scan, all columns [{card}]", wall,
                                   scan.timings)
    res["rates"] = rates
    return res


# ---------------------------------------------------------------------------
# phase 13: string transforms (bench.py's strings rung) and rect_transform
# ---------------------------------------------------------------------------

#: the rung's distinct values (bench.py string_transforms and
#: string_transforms_100k): the first ingests as a dictionary, the second,
#: above DICT_ENCODE_MAX_CARD, as a 32-byte rectangle
STRING_CARDS = (1000, 100_000)
#: the transforms' width cap in phase 13 (rect.maxBytes, the default)
RT_CAP = 64
#: chains held bit-identical against the plain version: every op alone
#: (substring past the end, from the end, of no length; replace and pad
#: that grow; substring_index both ways, count 0 and a delimiter whose
#: matches overlap), chains of 2-4 ops,
#: the rung's two, one of the kernel's 8, and repeat and translate (0 and
#: 1 times, growing to 24 and 40 bytes; a repeated source byte, deletions
#: past the end of ``to`` and by a 0x00 in it)
RT_CHAINS = (
    (("upper",),), (("lower",),), (("initcap",),), (("reverse",),),
    (("trim", True, True),), (("trim", True, False),),
    (("trim", False, True),),
    (("substring", 3, 4),), (("substring", 0, None),),
    (("substring", 2, None),), (("substring", -5, 3),),
    (("substring", -3, None),), (("substring", 70, 2),),
    (("substring", 1, 0),), (("substring", -80, 90),),
    (("replace", b"ab", b"XYZW"),), (("replace", b" ", b""),),
    (("replace", b"aa", b"a"),), (("replace", b"b", b"b"),),
    (("pad", 12, b"*-", True),), (("pad", 12, b"*-", False),),
    (("pad", 40, b"xy", True),), (("pad", 3, b"#", False),),
    (("substring_index", b"a", 2),), (("substring_index", b"ab", -1),),
    (("substring_index", b" ", -3),), (("substring_index", b"a", 0),),
    (("substring_index", b"aa", 2),), (("substring_index", b"aa", -2),),
    (("trim", True, True), ("upper",)),
    (("lower",), ("replace", b"a", b"AA")),
    (("trim", True, True), ("upper",), ("substring", 2, 5)),
    (("initcap",), ("substring_index", b" ", 2), ("trim", False, True),
     ("pad", 9, b"<>", True)),
    (("lower",), ("replace", b"a", b"AA"), ("reverse",),
     ("pad", 20, b".", False)),
    (("trim", True, False), ("reverse",), ("trim", True, False),
     ("reverse",), ("upper",), ("substring", 2, None),
     ("replace", b"B", b"bb"), ("lower",)),
    (("repeat", 0),), (("repeat", 1), ("upper",)),
    (("substring", 1, 8), ("repeat", 3)), (("substring", 2, 4),
                                            ("repeat", 5)),
    (("translate", b"ab ", b"X"),), (("translate", b"aab", b"xyz"),),
    (("translate", b"a-\x00", b"\x00Q"),),
    (("trim", True, True), ("translate", b" Q", b"_"),
     ("substring", 1, 6), ("repeat", 2)),
)
#: row counts of the exact cases: one row, part of a lane group's set of
#: rows at every width, part of a warp, a warp and one row, and many
#: blocks ending part way through one
RT_ROWS = (1, 3, 31, 33, 70_001)


def gen_strings(n_rows: int, card: int, seed: int = 13) -> dict:
    """bench.py's ``gen_string_table`` in numpy: ``s`` drawn from ``card``
    values ``"  Item-{i:05d}-{'x' * (i % 7)}  "`` (15-21 bytes) as an
    ``S`` array, ``v`` uniform in [0, 10)."""
    rng = np.random.RandomState(seed)
    pool = np.array([f"  Item-{i:05d}-{'x' * (i % 7)}  ".encode()
                     for i in range(card)])
    idx = rng.randint(0, card, n_rows)
    return {"s": pool[idx], "v": rng.uniform(0, 10, n_rows),
            "_idx": idx, "_pool": pool}


def q_strings(df, F):
    """The strings rung (bench.py:369-380)."""
    return (df.select(F.upper(F.trim(F.col("s"))).alias("u"),
                      F.substring(F.col("s"), 3, 4).alias("pre"),
                      F.col("v"))
            .group_by("u", "pre")
            .agg(F.sum(F.col("v")).with_name("sv"),
                 F.count_star().with_name("n")))


def q_strings_sorted(df, F):
    return q_strings(df, F).order_by("u")


#: the rung as SQL text
STRINGS_SQL = ("SELECT upper(trim(s)) AS u, substring(s, 3, 4) AS pre, "
               "sum(v) AS sv, count(*) AS n FROM strs "
               "GROUP BY upper(trim(s)), substring(s, 3, 4) ORDER BY u")


def strings_numpy(t: dict) -> list:
    """The rung's rows in ``u`` order: each pool value is its own group
    (its number makes ``u`` distinct); sums by ``np.bincount``."""
    pool = t["_pool"]
    sums = np.bincount(t["_idx"], weights=t["v"], minlength=len(pool))
    counts = np.bincount(t["_idx"], minlength=len(pool))
    rows = [{"u": p.decode().strip(" ").upper(), "pre": p.decode()[2:6],
             "sv": float(sums[i]), "n": int(counts[i])}
            for i, p in enumerate(pool) if counts[i]]
    return sorted(rows, key=lambda r: r["u"])


def _rt_rect(rng, rows: int, width: int, device: str = "cuda"):
    """Rows over a small alphabet that makes the chains' literals match
    often, with edge spaces, empty and all-space rows, rows holding 0x00
    bytes inside their length (the last byte among them), and 10% nulls
    (zero bytes, length 0), on ``device``."""
    import torch
    alphabet = np.frombuffer(b"aab  bxyAB-Q.", np.uint8)
    rect = alphabet[rng.randint(0, len(alphabet), (rows, width))]
    lens = rng.randint(0, width + 1, rows).astype(np.int32)
    kind = rng.randint(0, 10, rows)
    rect[kind == 1] = 32                          # all spaces
    lens[kind == 2] = 0
    nul = (kind == 3)[:, None] & (rng.rand(rows, width) < 0.3)
    nul[(kind == 3) & (lens > 0), np.maximum(lens - 1, 0)[
        (kind == 3) & (lens > 0)]] = True
    rect[nul] = 0
    valid = rng.rand(rows) >= 0.1
    lens[~valid] = 0
    rect[np.arange(width)[None, :] >= lens[:, None]] = 0
    return (torch.from_numpy(rect).to(device),
            torch.from_numpy(lens).to(device),
            torch.from_numpy(valid).to(device))


def _rt_err(got, want) -> float:
    """The largest absolute difference between two rect_transform results,
    bytes and lengths (inf where their shapes differ)."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return math.inf
        if g.numel():
            err = max(err, float((g.to(torch.int64) - w.to(torch.int64))
                                 .abs().max()))
    return err


def phase_rt_exact() -> dict:
    """rect_transform against its plain version on the same tensors on
    the card: bytes and lengths bit-identical for every chain of
    RT_CHAINS, every width 8-64 and every row count of RT_ROWS; a chain
    that outgrows the cap must raise on both."""
    import torch
    from spark_rapids_tpu_torch.exec.rect_transform import (
        rect_transform, rect_transform_reference)
    rng = np.random.RandomState(130)
    cases = refused = 0
    max_err = 0.0
    for width in (8, 16, 32, 64):
        for rows in RT_ROWS:
            b, ln, v = _rt_rect(rng, rows, width)
            for chain in RT_CHAINS:
                try:
                    want = rect_transform_reference(b, ln, v, chain, RT_CAP)
                except NotImplementedError:
                    try:
                        rect_transform(b, ln, v, chain, RT_CAP)
                    except NotImplementedError:
                        refused += 1
                        continue
                    raise AssertionError(f"{chain} at W={width}: the kernel "
                                         "took a chain past the cap")
                got = rect_transform(b, ln, v, chain, RT_CAP)
                torch.cuda.synchronize()
                err = _rt_err(got, want)
                max_err = max(max_err, err)
                ok = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                  want[1])
                _check(ok, f"rect_transform {chain} at W={width}, {rows} "
                           f"rows: differs from its plain version (max abs "
                           f"err {err})")
                cases += 1
    _log(f"rect_transform exact: {cases} cases bit-identical to the plain "
         f"version ({len(RT_CHAINS)} chains x widths 8-64 x rows "
         f"{RT_ROWS}), max abs err {max_err}; {refused} past the "
         f"{RT_CAP}-byte cap refused by both")
    return {"cases": cases, "refused": refused, "max_abs_err": max_err}


def rt_bound(rows: int, w_in: int, w_out: int) -> dict:
    """The least time one rect_transform call needs: each input byte read
    once (the rectangle, 4-byte lengths, the validity) and each output
    byte written once (the rectangle and its lengths); the ops are a few
    integer operations a byte, far under the 32-bit rate."""
    nbytes = rows * (w_in + 4 + 1 + w_out + 4)
    ops = rows * max(w_in, w_out) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ms": max(bytes_ms, ops_ms),
            "by": "bytes" if bytes_ms >= ops_ms else "operations"}


#: the kernel's timed chains, (label, input, chain): "rung" is the rung's
#: 32-byte batch, "w8" and "w64" a 1,048,576-row _rt_rect of that width;
#: the replaces and the pad grow their strings (32 -> 64 and 8 -> 16
#: bytes wide, and up to 64 bytes long)
RT_TIMED = (
    ("upper_trim", "rung", (("trim", True, True), ("upper",))),
    ("substring", "rung", (("substring", 3, 4),)),
    ("replace_grow", "rung", (("replace", b"-", b"--"),)),
    ("w8_upper_trim", "w8", (("trim", True, True), ("upper",))),
    ("w8_replace_grow", "w8", (("replace", b"a", b"AA"),)),
    ("w64_upper_trim", "w64", (("trim", True, True), ("upper",))),
    ("w64_lpad", "w64", (("pad", 64, b"*-", True),)),
)


#: a plain version slower than this a call is timed call by call
PLAIN_SYNC_MS = 20.0


def _alone_ms(fn, x) -> float:
    """ms of one call of ``fn(*x)`` alone between two synchronisations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _plain_ms(fn, inputs, label: str) -> float:
    """A plain version's ms a call: queued cold as the kernels are
    (``_cold_ms``, one pass), or, where one call takes over PLAIN_SYNC_MS
    (a wide frame's thousands of launches) or its host enqueue outlasts
    any sleep (a replace's column loop), each call alone between two
    synchronisations, the median over the inputs."""
    first = _alone_ms(fn, inputs[0])
    try:
        if first > PLAIN_SYNC_MS:
            raise AssertionError(f"{label}: {first:.1f} ms a call")
        return _cold_ms(fn, inputs, label, rounds=1, reps=1)[0]
    except AssertionError:
        return float(np.median([_alone_ms(fn, x) for x in inputs]))


def _plain_alone_ms(fn, inputs, label: str) -> float:
    """A plain version's ms a call, each call alone between two
    synchronisations, the median over the inputs: for plain versions
    whose host enqueue always outlasts the sleep (hundreds of launches a
    call past the launch queue's depth, or a copy from pageable memory),
    where ``_plain_ms`` would first grow the sleep eight times."""
    return float(np.median([_alone_ms(fn, x) for x in inputs]))


def _rt_timed_row(name, b, ln, v, chain, compare,
                  plain_timer=_plain_ms) -> dict:
    """One chain on one batch: the kernel (and each version to compare)
    held bit-identical to the plain version, then timed with the L2 cold
    in turns (kernel, others, others reversed, kernel, ...), beside the
    bound and the plain version (timed by ``plain_timer``)."""
    import torch
    from spark_rapids_tpu_torch.exec.rect_transform import (
        rect_transform, rect_transform_reference)
    P, W = b.shape
    want = rect_transform_reference(b, ln, v, chain, RT_CAP)
    order = [("kernel", rect_transform)] + list(compare.items())
    row = {"max_abs_err": 0.0}
    for who, f in order:
        got = f(b, ln, v, chain, RT_CAP)
        torch.cuda.synchronize()
        err = _rt_err(got, want)
        if who == "kernel":
            row["max_abs_err"] = err
        _check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
               f"rect_transform {who} {name} on {P} x {W}: differs from "
               f"the plain version (max abs err {err})")
    w_out = want[0].shape[1]
    del got, want
    n = max(2, -(-COLD_BYTES // (b.nbytes + ln.nbytes + v.nbytes)))
    inputs = [(b, ln, v)] + [(b.clone(), ln.clone(), v.clone())
                             for _ in range(n - 1)]
    turns = {who: [] for who, _ in order}
    hosts = []
    for who, f in order + order[::-1] + order:
        ms, host = _cold_ms(
            lambda b, ln, v, f=f: f(b, ln, v, chain, RT_CAP), inputs,
            f"rect_transform {name} {who}")
        turns[who].append(ms)
        if who == "kernel":
            hosts.append(host)
    row["ms"] = float(np.mean(turns["kernel"]))
    row["turns_ms"] = turns
    row["compare_ms"] = {who: float(np.mean(turns[who]))
                         for who in compare}
    row["host_ms"] = float(np.mean(hosts))
    row["plain_ms"] = plain_timer(
        lambda b, ln, v: rect_transform_reference(b, ln, v, chain, RT_CAP),
        inputs, f"rect_transform {name} plain")
    bd = rt_bound(P, W, w_out)
    row.update({"bound_ms": bd["ms"], "bound_bytes": bd["bytes"],
                "bound_by": bd["by"], "shape": [int(P), int(W), int(w_out)]})
    others = "".join(f"; {who} {row['compare_ms'][who]:.4f} ms (turns "
                     f"{', '.join(f'{t:.4f}' for t in turns[who])}), "
                     f"{row['bound_ms'] / row['compare_ms'][who]:.0%} of "
                     f"bound" for who in compare)
    _log(f"rect_transform {name} ({P} x {W} -> {w_out}, {chain}): "
         f"bit-identical to the plain version (max abs err "
         f"{row['max_abs_err']}); kernel {row['ms']:.4f} ms (turns "
         f"{', '.join(f'{t:.4f}' for t in turns['kernel'])}), "
         f"{row['bound_ms'] / row['ms']:.0%} of bound{others}; plain "
         f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
         f"({bd['bytes']} B, by {bd['by']}); host {row['host_ms']:.4f} ms "
         f"a call; library: none (no PyTorch call computes this function)")
    return row


def phase_rt_times(col, compare=None) -> dict:
    """rect_transform on the rung's batch (its byte rectangle ``col`` of
    the 100,000-value table) and on 1,048,576-row rectangles 8 and 64
    bytes wide, every chain of RT_TIMED: held bit-identical to its plain
    version, then timed with the L2 cold beside the bound, the plain
    version, the versions to compare (``compare``: name -> launch, timed
    in turns with the kernel) and the launch shape."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.exec.rect_transform import launch_shape
    compare = compare or {}
    b, ln, v = col.data, col.lengths, col.validity
    P, W = b.shape
    regs = re.findall(r"Used (\d+) registers",
                      native.build_log("rect_transform"))
    out = {"shape": [int(P), int(W)], "registers": [int(r) for r in regs]}
    rng = np.random.RandomState(131)
    batches = {"rung": (b, ln, v)}
    for name, src, chain in RT_TIMED:
        if src not in batches:
            batches = {"rung": batches["rung"],
                       src: _rt_rect(rng, P, int(src[1:]))}
        bb, bl, bv = batches[src]
        row = _rt_timed_row(name, bb, bl, bv, chain, compare)
        row["launch"] = launch_shape(chain, int(bb.shape[0]),
                                     int(bb.shape[1]), RT_CAP)
        out[name] = row
    out["launch"] = out["upper_trim"]["launch"]
    _log(f"rect_transform launch {out['launch']}, ptxas registers "
         f"{out['registers']}")
    return out


def _strings_right(rows: list, want: list, ordered: bool) -> bool:
    """Groups and counts exact, sums within REL_TOL; in ``u`` order when
    ``ordered``."""
    got = rows if ordered else sorted(rows, key=lambda r: r["u"])
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if (g["u"], g["pre"], g["n"]) != (w["u"], w["pre"], w["n"]) \
                or _rel(g["sv"], w["sv"]) > REL_TOL:
            return False
    return True


def phase_strings(card: str, batch_rows: int, compare=None) -> dict:
    """Phase 13 (module doc): rect_transform exact and timed, then the
    strings rung at SF1 rows for 1,000 and 100,000 distinct values, cold
    and warm, with ORDER BY u, as SQL, and profiled."""
    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.columnar import (ByteRectColumn,
                                                 ColumnarBatch, DictColumn,
                                                 HostTable)
    from spark_rapids_tpu_torch.exec.rect_transform import rect_transform
    t_phase = time.perf_counter()
    out = {"exact": phase_rt_exact()}
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows}
    n_batches = math.ceil(SF1_ROWS / batch_rows)
    for distinct in STRING_CARDS:
        t0 = time.perf_counter()
        t = gen_strings(SF1_ROWS, distinct)
        host = HostTable.from_dict({"s": t["s"], "v": t["v"]})
        want = strings_numpy(t)
        first = ColumnarBatch.from_host(host.slice(0, batch_rows), "cuda",
                                        RT_CAP).columns[0]
        layout = type(first).__name__
        _check(isinstance(first, DictColumn if distinct <= 65536
                          else ByteRectColumn),
               f"{distinct} distinct s ingested as {first!r}")
        if distinct > 65536:
            _check(first.width == 32, f"s ingested {first.width} wide")
            out["times"] = phase_rt_times(first, compare)
        del first
        _log(f"strings {distinct}: {SF1_ROWS} rows generated in "
             f"{time.perf_counter() - t0:.2f} s, s ingests as {layout}")
        session = TorchSession(conf)
        runs = {}
        for label, query, ordered in (("cold", q_strings, False),
                                      ("warm", q_strings, False),
                                      ("order_by_u", q_strings_sorted, True)):
            torch.cuda.synchronize()
            rect_transform.launches = 0
            rows, ms = _run_query(session, host, query)
            launches = rect_transform.launches
            _check(_strings_right(rows, want, ordered),
                   f"strings {distinct} {label}: {len(rows)} rows differ "
                   f"from numpy's {len(want)}")
            runs[label] = {"wall_ms": ms, "rect_transform": launches}
        expect = 2 * n_batches if distinct > 65536 else 0
        for label, r in runs.items():
            _check(r["rect_transform"] == expect,
                   f"strings {distinct} {label}: rect_transform launched "
                   f"{r['rect_transform']} times, expected {expect} (one "
                   "a chain a batch over the rectangle, none over the "
                   "dictionary)")
        session.create_dataframe(host).create_or_replace_temp_view("strs")
        torch.cuda.synchronize()
        rect_transform.launches = 0
        t0 = time.perf_counter()
        rows = session.sql(STRINGS_SQL).collect()
        runs["sql"] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                       "rect_transform": rect_transform.launches}
        _check(_strings_right(rows, want, True),
               f"strings {distinct} SQL: rows differ from numpy")
        runs["profile_warm"] = phase_profile(
            session, host, q_strings,
            lambda r: _strings_right(r, want, False),
            f"strings rung, {distinct} distinct", "rect_transform")
        _log(f"strings {distinct} SF1 ({card}): {len(want)} groups equal to "
             f"numpy (keys and counts exact, sums within {REL_TOL:g}); wall "
             f"{runs['cold']['wall_ms']:.1f} ms cold, "
             f"{runs['warm']['wall_ms']:.1f} ms warm, ORDER BY u "
             f"{runs['order_by_u']['wall_ms']:.1f} ms, SQL "
             f"{runs['sql']['wall_ms']:.1f} ms; rect_transform launches "
             f"{runs['cold']['rect_transform']} over {n_batches} batches "
             f"(SQL {runs['sql']['rect_transform']})")
        out[str(distinct)] = runs
        del host, t
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"phase 13 (strings) took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: windows and the out-of-core sort
# ---------------------------------------------------------------------------

#: bench.py's window_bounded rung: sum(v) over ROWS BETWEEN 2 PRECEDING
#: AND CURRENT ROW, partitioned by p (512 values), ordered by o
WINDOW_PARTS = 512
WINDOW_SQL = """
SELECT p, o, v, sum(v) OVER (PARTITION BY p ORDER BY o
                             ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS wsum
FROM wtab
"""
#: window_frame timed alone on the rung's batch: (label, op, lo, hi,
#: values: the rung's float64 v, or "int" for v in int64 cents); the
#: last two frames lie just inside and just past the tiled instance's
#: halo (exec/window_frame.py HALO_MAX = 1,024 rows)
WF_TIMED = (("sum_w3", "sum", -2, 0, "float"),
            ("max_w3", "max", -2, 0, "float"),
            ("sum_w101", "sum", -100, 0, "float"),
            ("max_w101", "max", -100, 0, "float"),
            ("isum_w101", "sum", -100, 0, "int"),
            ("count_w101", "count", -100, 0, "float"),
            ("avg_w101", "avg", -100, 0, "float"),
            ("min_w101", "min", -100, 0, "float"),
            ("sum_ahead", "sum", 1, 3, "float"),
            ("sum_halo", "sum", -1024, 0, "float"),
            ("sum_past_halo", "sum", -1025, 0, "float"))
#: TPC-DS q3's aggregate ranked within each year, as SQL with a subquery
SQL_Q3_RANK = """
SELECT d_year, i_brand_id, i_brand, sum_agg,
       rank() OVER (PARTITION BY d_year ORDER BY sum_agg DESC) AS rk
FROM (SELECT d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) AS sum_agg
      FROM date_dim, store_sales, item
      WHERE d_date_sk = ss_sold_date_sk
        AND ss_item_sk = i_item_sk
        AND i_manufact_id = 128
        AND d_moy = 11
      GROUP BY d_year, i_brand_id, i_brand) t
ORDER BY d_year, rk, i_brand_id
"""


def gen_window_table(n_rows: int, seed: int = 11) -> dict:
    """bench.py's gen_window_table in numpy."""
    rng = np.random.RandomState(seed)
    return {"p": rng.randint(0, WINDOW_PARTS, n_rows),
            "o": rng.randint(0, 1 << 30, n_rows),
            "v": rng.uniform(-100.0, 100.0, n_rows)}


def window_rung(df, F):
    return df.with_window_column(
        "wsum", F.sum(F.col("v")), partition_by=["p"],
        order_by=[F.col("o").asc()], frame=("rows", -2, 0))


def _runs(keys_sorted: np.ndarray):
    """(first row, last row) of each sorted row's run of equal keys."""
    n = len(keys_sorted)
    idx = np.arange(n)
    first = np.r_[True, keys_sorted[1:] != keys_sorted[:-1]]
    last = np.r_[first[1:], True]
    start = np.maximum.accumulate(np.where(first, idx, 0))
    end = np.minimum.accumulate(np.where(last, idx, n - 1)[::-1])[::-1]
    return start, end


def window_rung_numpy(t: dict):
    """The rung in numpy: the rows sorted stably by (p, o), each row's
    three-term frame added in row order from 0, as Spark's sliding frame
    adds it. Returns (sort order, partition start and end of each sorted
    row, wsum in input order)."""
    order = np.lexsort((t["o"], t["p"]))
    start, end = _runs(t["p"][order])
    vs = t["v"][order]
    idx = np.arange(len(vs))
    acc = np.zeros(len(vs))
    for k in (-2, -1, 0):
        acc = acc + np.where(idx + k >= start, vs[np.maximum(idx + k, 0)],
                             0.0)
    want = np.empty_like(acc)
    want[order] = acc
    return order, start, end, want


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.int64),
        np.ascontiguousarray(b).view(np.int64))


def wf_bound(n: int, width: int, op: str, kind: str = "float") -> dict:
    """The least time one window_frame call needs: each row's value,
    validity and partition flag read once and its value and validity
    written once; a float64 sum or average adds its frame's W values in
    row order (W adds a row), the rest take three operations a row
    (prefix differences, sliding extremes)."""
    from spark_rapids_tpu_torch.exec.window_frame import frame_bytes
    nbytes = frame_bytes(n, op)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    per_row = width if kind == "float" and op in ("sum", "avg") else 3
    ops_ms = n * per_row / FP64_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ms": max(bytes_ms, ops_ms),
            "by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _wf_values(v, kind: str):
    """The rung's sorted values as a WF_TIMED case reads them: float64, or
    in int64 cents."""
    import torch
    return v if kind == "float" else torch.round(v * 100).to(torch.int64)


def phase_wf_times(args, card: str, compare=None) -> dict:
    """window_frame alone on the rung's sorted batch (``args``: values,
    validity and partition-start flags on the card), every frame of
    WF_TIMED: bit-identical to its plain version with the launch's own
    pick of instance, with each instance forced (the tiled one within its
    halo) and in each version of ``compare`` (name -> launch, its own
    pick); then timed with the L2 cold in turns with those versions
    (kernel, others, others, kernel, kernel, others), each instance
    forced in turns, beside its bound and the plain version."""
    import torch
    from spark_rapids_tpu_torch.exec.window_frame import (
        SEARCHES, describe, tiled, window_frame, window_frame_reference)
    compare = compare or {}
    n = int(args[0].shape[0])
    out = {"shape": [n], "launch": describe()}
    for name, op, lo, hi, kind in WF_TIMED:
        case = (_wf_values(args[0], kind),) + tuple(args[1:])
        per = sum(a.nbytes for a in case)
        inputs = [case] + [tuple(a.clone() for a in case)
                           for _ in range(max(2, -(-COLD_BYTES // per)) - 1)]
        searches = [s for s in SEARCHES if s != "tile" or tiled(lo, hi)]

        def forced(s):
            return lambda v, k, f: window_frame(v, k, f, lo, hi, op, s)

        def other(c):
            return lambda v, k, f: compare[c](v, k, f, lo, hi, op)
        versions = [(s, forced(s)) for s in searches] + \
            [(c, other(c)) for c in compare]
        want = window_frame_reference(*case, lo, hi, op)
        w = want[0].cpu().numpy()
        err = 0.0
        for who, fn in versions:
            got = fn(*case)
            torch.cuda.synchronize()
            g = got[0].cpu().numpy()
            e = float(np.max(np.abs(g.astype(np.float64)
                                    - w.astype(np.float64)), initial=0.0))
            if who in SEARCHES:
                err = max(err, e)
            _check(torch.equal(got[1], want[1]) and _bits_equal(g, w),
                   f"window_frame {name} ({who}): differs from its plain "
                   f"version (max abs err {e})")
        del got, want
        order = [("kernel", forced("frame"))] + \
            [(c, other(c)) for c in compare]
        turns = {who: [] for who, _ in order}
        hosts = []
        for who, fn in order + order[::-1] + order:
            ms, host = _cold_ms(fn, inputs, f"window_frame {name} {who}")
            turns[who].append(ms)
            if who == "kernel":
                hosts.append(host)
        ms = float(np.mean(turns["kernel"]))
        inst = {s: [] for s in searches if s != "frame"}
        for _ in range(2):
            for s in inst:
                inst[s].append(_cold_ms(forced(s), inputs,
                                        f"window_frame {name} {s}")[0])
        plain = _plain_ms(
            lambda v, k, f: window_frame_reference(v, k, f, lo, hi, op),
            inputs[:2], f"window_frame {name} plain")
        bd = wf_bound(n, max(hi - lo + 1, 0), op, kind)
        out[name] = {"ms": ms, "turns_ms": turns,
                     "compare_ms": {c: float(np.mean(turns[c]))
                                    for c in compare},
                     "host_ms": float(np.mean(hosts)), "plain_ms": plain,
                     "bound_ms": bd["ms"], "bound_bytes": bd["bytes"],
                     "bound_by": bd["by"], "max_abs_err": err,
                     "frame": [lo, hi], "op": op, "values": kind,
                     "tiled": tiled(lo, hi), "instance_turns_ms": inst}
        others = "".join(
            f"; {c} {out[name]['compare_ms'][c]:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in turns[c])}), "
            f"{bd['ms'] / out[name]['compare_ms'][c]:.0%} of bound"
            for c in compare)
        _log(f"window_frame {name} ({op} over ROWS {lo}..{hi}, {kind} "
             f"values, {n} rows, {card}): bit-identical to the plain "
             f"version ({', '.join(w for w, _ in versions)}); kernel "
             f"{ms:.4f} ms cold (turns "
             f"{', '.join(f'{t:.4f}' for t in turns['kernel'])}), "
             f"{bd['ms'] / ms:.0%} of bound {bd['ms']:.4f} ({bd['bytes']} "
             f"B, by {bd['by']}){others}; plain {plain:.4f} ms; host "
             f"{out[name]['host_ms']:.4f} ms a call; library: none (no "
             f"PyTorch call computes this function); instances in turns: "
             + ", ".join(f"{s} {v}" for s, v in inst.items()) + " ms")
    return out


def phase_window_rung(card: str, batch_rows: int, compare=None) -> dict:
    """(a) bench.py's window_bounded rung at SF1 rows in one batch, as a
    DataFrame and as SQL, every row bit-identical to numpy; cold, warm,
    profiled, with window_frame's launches and the peak allocation. (b)
    window_frame alone on the rung's sorted batch."""
    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar import HostTable
    t0 = time.perf_counter()
    t = gen_window_table(SF1_ROWS)
    order, start, end, want = window_rung_numpy(t)
    host = HostTable.from_dict(t)
    _log(f"window rung: {SF1_ROWS} rows ({sum(v.nbytes for v in t.values())}"
         f" B) and numpy's frames in {time.perf_counter() - t0:.2f} s on "
         "the host")
    # one batch: the rung's table is a window's one input batch
    session = TorchSession({"spark.rapids.tpu.sql.batchSizeRows": SF1_ROWS})
    session.create_dataframe(host).create_or_replace_temp_view("wtab")

    def right(out):
        return (_bits_equal(np.asarray(out["wsum"]), want)
                and not np.ma.getmaskarray(out["wsum"]).any()
                and all(np.array_equal(np.asarray(out[c]), t[c])
                        for c in ("p", "o", "v")))

    runs = {}
    for label, make in (
            ("cold", lambda s: window_rung(s.create_dataframe(host), F)),
            ("warm", lambda s: window_rung(s.create_dataframe(host), F)),
            ("warm2", lambda s: window_rung(s.create_dataframe(host), F)),
            ("sql", lambda s: s.sql(WINDOW_SQL))):
        runs[label], out = _sql_run(session, make, "collect_numpy")
        _check(right(out), f"window rung {label}: wsum differs from numpy's "
                           "row-order frame sums")
        _check(runs[label]["launches"]["window_frame"] == 1,
               f"window rung {label}: window_frame launched "
               f"{runs[label]['launches']['window_frame']} times, not once")
        del out
    runs["profile_warm"] = phase_profile(
        session, host, window_rung, right, f"window rung ({card})",
        "window_frame", "collect_numpy")
    _log(f"window rung SF1 ({card}): {SF1_ROWS} rows bit-identical to "
         f"numpy (DataFrame and SQL); wall {runs['cold']['wall_ms']:.1f} ms "
         f"cold, {runs['warm']['wall_ms']:.1f} / "
         f"{runs['warm2']['wall_ms']:.1f} ms warm, SQL "
         f"{runs['sql']['wall_ms']:.1f} ms; window_frame launches "
         f"{runs['cold']['launches']['window_frame']} a run; peak allocated "
         f"{runs['warm']['max_memory_allocated']} B warm, "
         f"{runs['cold']['max_memory_allocated']} B cold")
    args = (torch.from_numpy(t["v"][order]).cuda(),
            torch.ones(SF1_ROWS, dtype=torch.bool).cuda(),
            torch.from_numpy(start == np.arange(SF1_ROWS)).cuda())
    runs["times"] = phase_wf_times(args, card, compare)
    del args, host, t
    return runs


def ss_windows(df, F):
    """row_number, lag(ss_net_paid) and the default-frame running
    sum(ss_net_paid) per customer, by date and amount."""
    spec = {"partition_by": ["ss_customer_sk"],
            "order_by": [F.col("ss_sold_date_sk").asc(),
                         F.col("ss_net_paid").asc()]}
    return (df.with_window_column("rn", F.row_number(), **spec)
            .with_window_column("lg", F.lag(F.col("ss_net_paid")), **spec)
            .with_window_column("rs", F.sum(F.col("ss_net_paid")), **spec)
            .select("ss_customer_sk", "ss_sold_date_sk", "ss_net_paid",
                    "rn", "lg", "rs"))


def ss_windows_numpy(ss: dict) -> dict:
    """ss_windows in numpy, in input order. The amounts are whole cents,
    so each running sum is exact in int64 cents; Spark's default frame
    (RANGE UNBOUNDED PRECEDING .. CURRENT ROW) runs to the row's last
    peer (same customer, date and amount)."""
    cust, date = ss["ss_customer_sk"], ss["ss_sold_date_sk"]
    paid = ss["ss_net_paid"]
    cents = np.rint(paid * 100).astype(np.int64)
    _check(int(cust.max()) < (1 << 31) and int(date.max()) < (1 << 11)
           and int(cents.max()) < (1 << 21), "ss_windows_numpy: keys too wide")
    key = (cust.astype(np.int64) << 32) | (date.astype(np.int64) << 21) \
        | cents
    order = np.argsort(key, kind="stable")
    pstart, _ = _runs(cust[order])
    _, peer_end = _runs(key[order])
    n = len(key)
    idx = np.arange(n)
    cs = np.cumsum(cents[order])
    before = np.where(pstart > 0, cs[np.maximum(pstart - 1, 0)], 0)
    sorted_out = {
        "rn": (idx - pstart + 1).astype(np.int32),
        "lg": np.where(idx > pstart, paid[order][np.maximum(idx - 1, 0)],
                       0.0),
        "lg_valid": idx > pstart,
        "rs": (cs[peer_end] - before) / 100.0}
    out = {}
    for k, v in sorted_out.items():
        out[k] = np.empty_like(v)
        out[k][order] = v
    return out


def q3_rank_numpy(ss: dict, dd: dict, it: dict) -> list:
    """q3's rows ranked by sum_agg within each year (ties share a rank),
    ordered by year, rank and brand id."""
    rows = q3_numpy(ss, dd, it)
    out = []
    for i, r in enumerate(rows):
        if i == 0 or rows[i - 1]["d_year"] != r["d_year"]:
            year_start = run_start = i
        elif rows[i - 1]["sum_agg"] != r["sum_agg"]:
            run_start = i
        out.append({**r, "rk": run_start - year_start + 1})
    out.sort(key=lambda r: (r["d_year"], r["rk"], r["i_brand_id"]))
    return out


def phase_ss_windows(card: str, batch_rows: int, ds: dict) -> dict:
    """(c) windows over TPC-DS SF10 store_sales (28,800,991 rows, about
    3.6 M customers) against numpy, cold and warm; and q3's aggregate
    ranked within each year as SQL with a subquery."""
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    ss, host = ds["ss"], ds["hosts"][0]
    t0 = time.perf_counter()
    want = ss_windows_numpy(ss)
    _log(f"store_sales windows: numpy in {time.perf_counter() - t0:.2f} s")
    session = TorchSession({"spark.rapids.tpu.sql.batchSizeRows": batch_rows})

    def rel_err(out) -> float:
        return float(np.max(np.abs(np.asarray(out["rs"]) - want["rs"])
                            / np.maximum(np.abs(want["rs"]), 1e-300)))

    def right(out) -> bool:
        lg, ok = out["lg"], want["lg_valid"]
        return (np.array_equal(np.asarray(out["rn"]), want["rn"])
                and np.array_equal(~np.ma.getmaskarray(lg), ok)
                and np.array_equal(np.asarray(lg)[ok], want["lg"][ok])
                and rel_err(out) <= REL_TOL
                and np.array_equal(np.asarray(out["ss_net_paid"]),
                                   ss["ss_net_paid"]))

    def make(s):
        return ss_windows(s.create_dataframe(host), F)

    runs = {}
    for label in ("cold", "warm"):
        runs[label], out = _sql_run(session, make, "collect_numpy")
        runs[label]["rs_rel_err"] = rel_err(out)
        _check(right(out), f"store_sales windows {label}: differ from "
                           f"numpy (running sum rel err "
                           f"{runs[label]['rs_rel_err']:.3e})")
        _check(runs[label]["launches"]["window_frame"] == 0,
               "store_sales windows: no bounded frame, yet window_frame "
               "launched")
        del out
    runs["profile_warm"] = phase_profile(session, host, ss_windows, right,
                                         f"store_sales windows ({card})",
                                         "window_frame", "collect_numpy")
    for name, h in (("store_sales", host), ("date_dim", ds["hosts"][1]),
                    ("item", ds["hosts"][2])):
        session.create_dataframe(h).create_or_replace_temp_view(name)
    want_q3 = q3_rank_numpy(ss, ds["dd"], ds["it"])
    runs["q3_rank"], rows = _sql_run(session,
                                     lambda s: s.sql(SQL_Q3_RANK))
    _check(len(rows) == len(want_q3) and all(
        (g["d_year"], g["rk"], g["i_brand_id"], g["i_brand"])
        == (w["d_year"], w["rk"], w["i_brand_id"], w["i_brand"])
        and _rel(g["sum_agg"], w["sum_agg"]) <= REL_TOL
        for g, w in zip(rows, want_q3)),
        f"q3 rank SQL: rows differ from numpy ({rows[:3]} / {want_q3[:3]})")
    _log(f"store_sales windows SF10 ({card}): row_number, lag and the "
         f"RANGE-default running sum over {SF10_STORE_SALES} rows equal "
         f"numpy (running sum within {runs['cold']['rs_rel_err']:.2e} "
         f"relative); wall {runs['cold']['wall_ms']:.1f} ms cold, "
         f"{runs['warm']['wall_ms']:.1f} ms warm; peak allocated "
         f"{runs['warm']['max_memory_allocated']} B; q3 ranked by year "
         f"(SQL): {len(rows)} rows equal numpy, "
         f"{runs['q3_rank']['wall_ms']:.1f} ms")
    return runs


def sort_bucket_bound(n: int, itemsizes: list, s: int) -> dict:
    """The least time one sort_bucket call needs: each row's operands read
    at their own widths and its bucket written once, the splitters read
    once; the search is a few integer compares a row."""
    from spark_rapids_tpu_torch.exec.sort_bucket import bucket_bytes
    nbytes = bucket_bytes(n, itemsizes, s)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * len(itemsizes) * max(1, math.ceil(math.log2(s + 1))) \
        / SCALAR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ms": max(bytes_ms, ops_ms),
            "by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_sort_bucket_times(host, orders, batch_rows: int, n_buckets: int,
                            card: str, compare=None) -> dict:
    """sort_bucket alone on one store_sales run's encoded operands (K = 4:
    two orders' uint8 null ranks and keys, each at its own width) against
    ``n_buckets - 1`` splitters picked as the sort picks them:
    bit-identical to its plain version (and so is each version of
    ``compare``, name -> launch), timed cold in turns with those versions
    beside its bound and the plain version; then on the one amount key,
    in turns also with torch.searchsorted, the library call that computes
    the same function there."""
    import torch
    from spark_rapids_tpu_torch.columnar import ColumnarBatch
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec, sort_operands
    from spark_rapids_tpu_torch.exec.sort_bucket import (
        describe, key_words, sort_bucket, sort_bucket_reference)
    compare = compare or {}
    batch = ColumnarBatch.from_host(host.slice(0, batch_rows), "cuda", 64)
    ops = [op.contiguous() for op in sort_operands(orders, batch)]
    del batch
    K, n = len(ops), int(ops[0].shape[0])
    pick = torch.from_numpy(np.linspace(0, n - 1, num=8 * n_buckets)
                            .astype(np.int64)).cuda()
    sp = TpuSortExec._splitters([key_words([op[pick] for op in ops])
                                 .cpu().numpy()], n_buckets).cuda()
    S = int(sp.shape[1])
    out = {"shape": [n, K, S], "dtypes": [str(op.dtype) for op in ops],
           "launch": describe()}
    cases = (("operands", ops, sp), ("one_operand", ops[1:2],
                                     sp[1:2].contiguous()))
    for name, o, s in cases:
        got = sort_bucket(o, s, n)
        want = sort_bucket_reference(o, s, n)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs()
                    .max().item())
        _check(torch.equal(got, want),
               f"sort_bucket {name}: differs from its plain version")
        for c, f in compare.items():
            _check(torch.equal(f(o, s, n), want),
                   f"sort_bucket {name} ({c}): differs from the plain "
                   "version")
        per = sum(x.nbytes for x in o)
        inputs = [(o, s)] + [([x.clone() for x in o], s.clone())
                             for _ in range(max(2, -(-COLD_BYTES // per))
                                            - 1)]
        order = [("kernel", lambda a, b: sort_bucket(a, b, n))] + [
            (c, lambda a, b, f=f: f(a, b, n)) for c, f in compare.items()]
        if name == "one_operand":
            lib = torch.searchsorted(s[0], o[0], right=True)
            torch.cuda.synchronize()
            _check(torch.equal(lib.to(torch.int32), got),
                   "torch.searchsorted differs from sort_bucket on one "
                   "operand")
            order.append(("library", lambda a, b: torch.searchsorted(
                b[0], a[0], right=True)))
        turns = {who: [] for who, _ in order}
        hosts = []
        for who, fn in order + order[::-1] + order:
            ms, host_ms = _cold_ms(fn, inputs, f"sort_bucket {name} {who}")
            turns[who].append(ms)
            if who == "kernel":
                hosts.append(host_ms)
        ms = float(np.mean(turns["kernel"]))
        plain = _plain_ms(lambda a, b: sort_bucket_reference(a, b, n),
                          inputs[:2], f"sort_bucket {name} plain")
        sizes = [x.element_size() for x in o]
        bd = sort_bucket_bound(n, sizes, S)
        row = {"ms": ms, "turns_ms": turns, "host_ms": float(np.mean(hosts)),
               "compare_ms": {c: float(np.mean(turns[c])) for c in compare},
               "plain_ms": plain, "bound_ms": bd["ms"],
               "bound_bytes": bd["bytes"], "bound_by": bd["by"],
               "max_abs_err": err, "library_ms": None, "operands": len(o),
               "row_bytes": sum(sizes) + 4}
        if "library" in turns:
            row["library_ms"] = float(np.mean(turns["library"]))
        if name == "operands":
            # the int64 stack the kernel does not need: what widening the
            # operands first would cost on top of it
            row["widen_ms"] = _cold_ms(lambda a, b: key_words(a), inputs,
                                       "sort_bucket widening")[0]
        out[name] = row
        lib = (f"; library torch.searchsorted {row['library_ms']:.4f} ms "
               f"(turns {', '.join(f'{t:.4f}' for t in turns['library'])})"
               if row["library_ms"] is not None else "; library: none with "
               "more than one operand; widening the operands to an int64 "
               f"stack {row['widen_ms']:.4f} ms")
        others = "".join(
            f"; {c} {row['compare_ms'][c]:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in turns[c])}), "
            f"{bd['ms'] / row['compare_ms'][c]:.0%} of bound"
            for c in compare)
        _log(f"sort_bucket {name} ({n} rows x {len(o)} operands of "
             f"{sum(sizes)} B, {S} splitters, {card}): equal to the plain "
             f"version; kernel {ms:.4f} ms cold (turns "
             f"{', '.join(f'{t:.4f}' for t in turns['kernel'])}), "
             f"{bd['ms'] / ms:.0%} of bound {bd['ms']:.4f} ({bd['bytes']} B, "
             f"by {bd['by']}){others}; plain {plain:.4f} ms; host "
             f"{row['host_ms']:.4f} ms a call{lib}")
    return out


def phase_ooc_sort(card: str, batch_rows: int, ds: dict,
                   compare=None) -> dict:
    """(d) ORDER BY ss_net_paid DESC, ss_item_sk over all of SF10
    store_sales at the default batchSizeBytes: the out-of-core sort,
    every column equal to a stable numpy sort; sort_bucket's launches;
    then the kernel alone."""
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    ss, host = ds["ss"], ds["hosts"][0]
    t0 = time.perf_counter()
    order = np.lexsort((ss["ss_item_sk"], -ss["ss_net_paid"]))
    _log(f"store_sales ORDER BY: numpy's stable sort in "
         f"{time.perf_counter() - t0:.2f} s")
    session = TorchSession({"spark.rapids.tpu.sql.batchSizeRows": batch_rows})

    def order_by(df, F):
        return df.order_by(F.col("ss_net_paid").desc(),
                           F.col("ss_item_sk").asc())

    def make(s):
        return order_by(s.create_dataframe(host), F)

    def wrong(out) -> list:
        return [c for c in ss
                if not np.array_equal(np.asarray(out[c]), ss[c][order])]

    runs = {}
    for label in ("cold", "warm"):
        runs[label], out = _sql_run(session, make, "collect_numpy")
        plan = session.last_plan
        _check(isinstance(plan, TpuSortExec) and plan.last_buckets >= 5,
               f"store_sales ORDER BY: {getattr(plan, 'last_buckets', 0)} "
               "buckets, expected at least 5 (2.53 GB over 512 MiB)")
        runs[label]["buckets"] = plan.last_buckets
        bad = wrong(out)
        _check(not bad, f"store_sales ORDER BY {label}: columns {bad} "
                        "differ from numpy's stable sort")
        n_runs = math.ceil(SF10_STORE_SALES / batch_rows)
        _check(runs[label]["launches"]["sort_bucket"] == n_runs,
               f"store_sales ORDER BY: sort_bucket launched "
               f"{runs[label]['launches']['sort_bucket']} times, not once a "
               f"run ({n_runs})")
        del out
    _log(f"store_sales ORDER BY ss_net_paid DESC, ss_item_sk SF10 ({card}): "
         f"{SF10_STORE_SALES} rows in {runs['cold']['buckets']} buckets, "
         f"every column equal to numpy's stable sort; wall "
         f"{runs['cold']['wall_ms']:.1f} ms cold, "
         f"{runs['warm']['wall_ms']:.1f} ms warm; sort_bucket launches "
         f"{runs['cold']['launches']['sort_bucket']}; peak allocated "
         f"{runs['warm']['max_memory_allocated']} B")
    runs["profile_warm"] = phase_profile(session, host, order_by,
                                         lambda out: not wrong(out),
                                         f"store_sales ORDER BY ({card})",
                                         "sort_bucket", "collect_numpy")
    orders = session.last_plan.orders
    runs["times"] = phase_sort_bucket_times(host, orders, batch_rows,
                                            runs["cold"]["buckets"], card,
                                            compare)
    return runs


def phase_windows(card: str, batch_rows: int, ds: dict,
                  compare=None) -> dict:
    """Phase 14 (module doc): the window rung at SF1, window_frame alone,
    windows over SF10 store_sales and q3's ranked aggregate, and the
    out-of-core ORDER BY over SF10 store_sales with sort_bucket alone
    (``compare``: {kernel: {name: launch}}, the versions timed in turns
    with window_frame and sort_bucket)."""
    compare = compare or {}
    t0 = time.perf_counter()
    out = {"rung": phase_window_rung(card, batch_rows,
                                     compare.get("window_frame")),
           "store_sales": phase_ss_windows(card, batch_rows, ds),
           "order_by": phase_ooc_sort(card, batch_rows, ds,
                                      compare.get("sort_bucket"))}
    out["phase_s"] = time.perf_counter() - t0
    _log(f"phase 14 (windows and the out-of-core sort) took "
         f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: slice 9a -- math, date, cast, conditional, statistics and hash
# functions, rand, range and sample
# ---------------------------------------------------------------------------

STATS_SQL = """
SELECT l_returnflag, l_linestatus, count(*) AS n,
       stddev_samp(l_quantity) AS sd_qty, var_pop(l_extendedprice) AS var_price,
       stddev_pop(l_discount) AS sd_disc,
       avg(datediff(l_receiptdate, l_shipdate)) AS avg_transit,
       sum(CASE WHEN l_discount >= 0.05 THEN 1 ELSE 0 END) AS n_disc,
       round(sum(l_extendedprice * (1 - l_discount)), 2) AS revenue
FROM lineitem
WHERE year(l_shipdate) BETWEEN 1994 AND 1996 AND dayofweek(l_shipdate) <> 1
GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus
"""

SCALAR_SQL = """
SELECT count(*) AS n, sum(sqrt(l_extendedprice)) AS s_sqrt,
       sum(ln(l_extendedprice)) AS s_ln, sum(exp(-l_discount)) AS s_exp,
       sum(floor(l_extendedprice / 7)) AS s_floor,
       sum(ceil(l_extendedprice / 7)) AS s_ceil,
       sum(round(l_extendedprice * 1.1, 1)) AS s_round,
       sum(CAST(l_extendedprice AS INT)) AS s_int,
       sum(quarter(l_shipdate)) AS s_quarter,
       sum(dayofyear(l_receiptdate)) AS s_doy
FROM lineitem WHERE month(l_shipdate) IN (1, 2, 3)
"""

#: the statistics against numpy: a relative 1e-9. numpy takes two passes
#: (the mean, then the squared deviations); the port sums values shifted
#: by one constant, in another order, and its m2 = q - s*s/n loses about
#: log10(((mean - shift)^2) / var) digits, none here
STATS_TOL = 1e-9
#: the lineitem columns phase 15 reads
STATS_COLS = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
              "l_returnflag", "l_linestatus", "l_shipdate", "l_receiptdate"]


def q_stats(df, F):
    """STATS_SQL as a DataFrame."""
    ship = F.col("l_shipdate")
    yr = F.year(ship)
    return (df.filter((yr >= F.lit(1994)) & (yr <= F.lit(1996))
                      & (F.dayofweek(ship) != F.lit(1)))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.count_star().with_name("n"),
                 F.stddev(F.col("l_quantity")).with_name("sd_qty"),
                 F.var_pop(F.col("l_extendedprice")).with_name("var_price"),
                 F.stddev_pop(F.col("l_discount")).with_name("sd_disc"),
                 F.avg(F.datediff(F.col("l_receiptdate"), ship))
                 .with_name("avg_transit"),
                 F.sum(F.when(F.col("l_discount") >= F.lit(0.05), F.lit(1))
                       .otherwise(F.lit(0))).with_name("n_disc"),
                 F.sum(F.col("l_extendedprice")
                       * (F.lit(1) - F.col("l_discount"))).with_name("rev"))
            .select(F.col("l_returnflag"), F.col("l_linestatus"),
                    F.col("n"), F.col("sd_qty"), F.col("var_price"),
                    F.col("sd_disc"), F.col("avg_transit"), F.col("n_disc"),
                    F.round(F.col("rev"), 2).alias("revenue"))
            .order_by("l_returnflag", "l_linestatus"))


def _days(d: np.ndarray) -> np.ndarray:
    return d.astype("datetime64[D]").astype(np.int64)


def grouped_stats_numpy(t: dict) -> list:
    """STATS_SQL in numpy: the groups in key order, ``revenue`` unrounded
    (its round is compared as a round)."""
    ship = _days(t["l_shipdate"])
    year = t["l_shipdate"].astype("datetime64[Y]").astype(np.int64) + 1970
    keep = (year >= 1994) & (year <= 1996) & ((ship + 4) % 7 != 0)
    rf, ls = t["l_returnflag"][keep], t["l_linestatus"][keep]
    q, p = t["l_quantity"][keep], t["l_extendedprice"][keep]
    d = t["l_discount"][keep]
    transit = (_days(t["l_receiptdate"]) - ship)[keep]
    out = []
    for a in sorted(set(rf.tolist())):
        for b in sorted(set(ls.tolist())):
            g = (rf == a) & (ls == b)
            if not g.any():
                continue
            out.append({
                "l_returnflag": a, "l_linestatus": b, "n": int(g.sum()),
                "sd_qty": float(np.std(q[g], ddof=1)),
                "var_price": float(np.var(p[g])),
                "sd_disc": float(np.std(d[g])),
                "avg_transit": float(np.mean(transit[g])),
                "n_disc": int((d[g] >= 0.05).sum()),
                "revenue": float(np.sum(p[g] * (1 - d[g])))})
    return out


def grouped_stats_equal(got: list, want: list) -> bool:
    """Keys, order and the integers exactly; the statistics within
    STATS_TOL; the revenue within a rounding step of numpy's sum."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if any(g[k] != w[k] for k in ("l_returnflag", "l_linestatus", "n",
                                      "n_disc")):
            return False
        if any(_rel(g[k], w[k]) > STATS_TOL for k in (
                "sd_qty", "var_price", "sd_disc", "avg_transit")):
            return False
        if abs(g["revenue"] - w["revenue"]) > 0.005 + 1e-10 * abs(
                w["revenue"]):
            return False
    return True


def scalar_numpy(t: dict) -> dict:
    """SCALAR_SQL in numpy."""
    keep = np.isin(t["l_shipdate"].astype("datetime64[M]").astype(np.int64)
                   % 12 + 1, (1, 2, 3))
    p, d = t["l_extendedprice"][keep], t["l_discount"][keep]
    ship = t["l_shipdate"][keep]
    rec = t["l_receiptdate"][keep]
    r = p * 1.1
    month = ship.astype("datetime64[M]").astype(np.int64) % 12 + 1
    jan1 = rec.astype("datetime64[Y]").astype("datetime64[D]")
    return {"n": int(keep.sum()), "s_sqrt": float(np.sum(np.sqrt(p))),
            "s_ln": float(np.sum(np.log(p))),
            "s_exp": float(np.sum(np.exp(-d))),
            "s_floor": int(np.floor(p / 7).astype(np.int64).sum()),
            "s_ceil": int(np.ceil(p / 7).astype(np.int64).sum()),
            "s_round": float(np.sum(np.sign(r) * np.floor(np.abs(r) * 10.0
                                                          + 0.5) / 10.0)),
            "s_int": int(np.trunc(p).astype(np.int64).sum()),
            "s_quarter": int(((month + 2) // 3).sum()),
            "s_doy": int((_days(rec) - _days(jan1) + 1).sum())}


def scalar_equal(got: dict, want: dict) -> bool:
    """Integers exactly; float sums within REL_TOL (every row within a few
    ulps of numpy's, added in another order)."""
    return all(got[k] == v if isinstance(v, int) else _rel(got[k], v)
               <= REL_TOL for k, v in want.items())


def q_hashes(df, F):
    """The wrapped int64 sums of xxhash64(l_orderkey, l_quantity) and
    hash(l_orderkey)."""
    return (df.select(F.xxhash64(F.col("l_orderkey"), F.col("l_quantity"))
                      .alias("x"),
                      F.hash(F.col("l_orderkey")).alias("h"))
            .agg(F.sum(F.col("x")).with_name("sum_xx"),
                 F.sum(F.col("h")).with_name("sum_hash")))


_U64 = np.uint64
_XX = [_U64(c) for c in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                         0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                         0x27D4EB2F165667C5)]


def _rotl64_np(x, r: int):
    return (x << _U64(r)) | (x >> _U64(64 - r))


def xxhash64_long_np(v: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Spark's XXH64.hashLong over uint64 words and seeds (numpy)."""
    p1, p2, p3, p4, p5 = _XX
    with np.errstate(over="ignore"):
        h = seed + p5 + _U64(8)
        k = _rotl64_np(v * p2, 31) * p1
        h = _rotl64_np(h ^ k, 27) * p1 + p4
        h = (h ^ (h >> _U64(33))) * p2
        h = (h ^ (h >> _U64(29))) * p3
        return h ^ (h >> _U64(32))


def murmur3_long_np(v: np.ndarray, seed: int) -> np.ndarray:
    """Spark's Murmur3 hashLong over uint64 words (numpy uint32 lanes)."""
    u32 = np.uint32

    def rotl(x, r):
        return (x << u32(r)) | (x >> u32(32 - r))

    def k1(k):
        return rotl(k * u32(0xcc9e2d51), 15) * u32(0x1b873593)

    def h1(h, k):
        return rotl(h ^ k, 13) * u32(5) + u32(0xe6546b64)
    with np.errstate(over="ignore"):
        h = np.full(v.shape, seed, u32)
        h = h1(h, k1((v & _U64(0xffffffff)).astype(u32)))
        h = h1(h, k1((v >> _U64(32)).astype(u32))) ^ u32(8)
        h = (h ^ (h >> u32(16))) * u32(0x85ebca6b)
        h = (h ^ (h >> u32(13))) * u32(0xc2b2ae35)
        return (h ^ (h >> u32(16))).view(np.int32)


def hashes_numpy(t: dict) -> dict:
    key = t["l_orderkey"].astype(np.int64).view(np.uint64)
    qty = t["l_quantity"].astype(np.float64)
    qty = np.where(qty == 0, 0.0, qty)             # -0.0 as 0.0
    xx = xxhash64_long_np(qty.view(np.uint64), xxhash64_long_np(
        key, np.full(key.shape, 42, np.uint64)))
    with np.errstate(over="ignore"):
        sum_xx = int(xx.sum(dtype=np.uint64).view(np.int64))
    return {"sum_xx": sum_xx,
            "sum_hash": int(murmur3_long_np(key, 42).astype(np.int64).sum())}


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """The reference's splitmix64 (exprs/nondeterministic.py), numpy."""
    with np.errstate(over="ignore"):
        x = x + _U64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def rand_numpy(n: int, seed: int) -> np.ndarray:
    """rand(seed) over the n rows of one partition (the reference's
    formula)."""
    key = splitmix64_np(np.asarray([seed], np.uint64))[0]
    mixed = splitmix64_np(np.arange(n, dtype=np.uint64) ^ key)
    return (mixed >> _U64(11)).astype(np.float64) / float(1 << 53)


def q_ss_stats(df, F):
    return (df.group_by("ss_item_sk")
            .agg(F.stddev(F.col("ss_net_paid")).with_name("sd_paid"),
                 F.var_samp(F.col("ss_quantity")).with_name("var_qty"),
                 F.count_star().with_name("n"))
            .order_by("ss_item_sk"))


def ss_stats_numpy(ss: dict) -> dict:
    """q_ss_stats in numpy, two passes a group."""
    g = ss["ss_item_sk"]
    n = np.bincount(g)
    out = {"ss_item_sk": np.flatnonzero(n), "n": n[n > 0]}
    for col, name in (("ss_net_paid", "sd_paid"), ("ss_quantity", "var_qty")):
        x = ss[col].astype(np.float64)
        mean = np.bincount(g, x) / np.maximum(n, 1)
        m2 = np.bincount(g, (x - mean[g]) ** 2)[n > 0]
        var = m2 / np.maximum(n[n > 0] - 1, 1)
        out[name] = np.sqrt(var) if name == "sd_paid" else var
    return out


def phase_stats(card: str, batch_rows: int, table: dict, host,
                ds: dict) -> dict:
    """Phase 15 (module doc): slice 9a through the normal entry points at
    full size, against numpy."""
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    t_phase = time.perf_counter()
    n_batches = math.ceil(SF1_ROWS / batch_rows)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows}
    session = TorchSession(conf)
    li = host.select(STATS_COLS)
    session.create_dataframe(li).create_or_replace_temp_view("lineitem")
    out = {}

    # (a) grouped statistics, DataFrame and SQL
    t0 = time.perf_counter()
    want_a = grouped_stats_numpy(table)
    _log(f"phase 15 (a): numpy in {time.perf_counter() - t0:.2f} s")
    forms = {"dataframe": lambda s: q_stats(s.create_dataframe(li), F),
             "sql": lambda s: s.sql(STATS_SQL)}
    for form, make in forms.items():
        for label in ("cold", "warm"):
            run, rows = _sql_run(session, make)
            _check(grouped_stats_equal(rows, want_a),
                   f"(a) {form} {label}: {rows} != numpy {want_a}")
            k = run["launches"]["dense_groupby"]
            _check(k == 2 * n_batches, f"(a) {form} {label}: "
                   f"dense_groupby launched {k} times, expected "
                   f"{2 * n_batches} (two a batch: the values, then the "
                   "moments' shifted sums)")
            out[f"a_{form}_{label}"] = run
    out["a_profile_warm"] = phase_profile(
        session, li, q_stats, lambda r: grouped_stats_equal(r, want_a),
        f"phase 15 (a) grouped statistics ({card})", "dense_groupby")
    _log(f"phase 15 (a) grouped statistics over SF1 lineitem ({card}): "
         f"{len(want_a)} groups equal numpy (n and n_disc exact, statistics "
         f"within {STATS_TOL:g}); DataFrame "
         f"{out['a_dataframe_cold']['wall_ms']:.1f} ms cold, "
         f"{out['a_dataframe_warm']['wall_ms']:.1f} ms warm; SQL "
         f"{out['a_sql_cold']['wall_ms']:.1f} ms cold, "
         f"{out['a_sql_warm']['wall_ms']:.1f} ms warm; dense_groupby "
         f"launches {out['a_dataframe_warm']['launches']['dense_groupby']} "
         f"over {n_batches} batches; idle "
         f"{out['a_profile_warm'].get('idle_share', float('nan')):.1%}")

    # (b) a keyless sum of scalar functions, SQL
    want_b = scalar_numpy(table)
    for label in ("cold", "warm"):
        run, rows = _sql_run(session, lambda s: s.sql(SCALAR_SQL))
        _check(len(rows) == 1 and scalar_equal(rows[0], want_b),
               f"(b) {label}: {rows} != numpy {want_b}")
        out[f"b_{label}"] = run
    _log(f"phase 15 (b) scalar functions over SF1 ({card}): {rows[0]} equal "
         f"numpy; {out['b_cold']['wall_ms']:.1f} ms cold, "
         f"{out['b_warm']['wall_ms']:.1f} ms warm")

    # (c) hashes, DataFrame
    want_c = hashes_numpy(table)
    for label in ("cold", "warm"):
        run, rows = _sql_run(session,
                             lambda s: q_hashes(s.create_dataframe(li), F))
        _check(rows == [want_c], f"(c) {label}: {rows} != numpy {want_c}")
        out[f"c_{label}"] = run
    _log(f"phase 15 (c) xxhash64 and hash over SF1 ({card}): {rows[0]} "
         f"equal numpy's uint64 forms; {out['c_cold']['wall_ms']:.1f} ms "
         f"cold, {out['c_warm']['wall_ms']:.1f} ms warm")

    # (d) statistics over SF10 store_sales by item: the sort route
    ss, ss_host = ds["ss"], ds["hosts"][0]
    want_d = ss_stats_numpy(ss)
    for label in ("cold", "warm"):
        run, got = _sql_run(session, lambda s: q_ss_stats(
            s.create_dataframe(ss_host), F), "collect_numpy")
        ok = (np.array_equal(np.asarray(got["ss_item_sk"]),
                             want_d["ss_item_sk"])
              and np.array_equal(np.asarray(got["n"]), want_d["n"])
              and all(np.max(np.abs(np.asarray(got[k]) - want_d[k])
                             / np.abs(want_d[k])) <= STATS_TOL
                      for k in ("sd_paid", "var_qty")))
        _check(ok, f"(d) {label}: store_sales statistics differ from numpy")
        _check(run["launches"]["dense_groupby"] == 0,
               "(d): 2,000 integer keys launched dense_groupby")
        out[f"d_{label}"] = run
    _log(f"phase 15 (d) stddev_samp/var_samp by ss_item_sk over SF10 "
         f"store_sales ({card}): {len(want_d['n'])} groups equal numpy "
         f"within {STATS_TOL:g} (the sort route); "
         f"{out['d_cold']['wall_ms']:.1f} ms cold, "
         f"{out['d_warm']['wall_ms']:.1f} ms warm")

    # (e) sample, rand and the row ids over SF10 store_sales
    n_ss = len(ss["ss_net_paid"])
    keep = np.random.RandomState(42).random_sample(n_ss) < 0.01
    want_e = {"n": int(keep.sum()),
              "paid": float(ss["ss_net_paid"][keep].sum())}
    run, rows = _sql_run(session, lambda s: s.create_dataframe(ss_host)
                         .sample(0.01, 42)
                         .agg(F.count_star().with_name("n"),
                              F.sum(F.col("ss_net_paid")).with_name("paid")))
    _check(rows[0]["n"] == want_e["n"]
           and _rel(rows[0]["paid"], want_e["paid"]) <= REL_TOL,
           f"(e) sample: {rows} != numpy {want_e}")
    out["e_sample"] = run
    want_r = int((rand_numpy(n_ss, 7) < 0.01).sum())
    run, rows = _sql_run(session, lambda s: s.create_dataframe(ss_host)
                         .filter(F.rand(7) < F.lit(0.01))
                         .agg(F.count_star().with_name("n")))
    _check(rows == [{"n": want_r}], f"(e) rand: {rows} != numpy {want_r}")
    out["e_rand"] = run
    run, rows = _sql_run(session, lambda s: s.create_dataframe(ss_host)
                         .select(F.monotonically_increasing_id().alias("i"))
                         .agg(F.max(F.col("i")).with_name("m")))
    _check(rows == [{"m": n_ss - 1}], f"(e) ids: {rows}, expected "
                                      f"{n_ss - 1}")
    out["e_ids"] = run
    _log(f"phase 15 (e) over SF10 store_sales ({card}): sample(0.01, 42) "
         f"kept {want_e['n']} rows, RandomState(42)'s, sum equal; "
         f"rand(7) < 0.01 on {want_r} rows, splitmix64's; max id "
         f"{n_ss - 1}; {out['e_sample']['wall_ms']:.1f}, "
         f"{out['e_rand']['wall_ms']:.1f}, {out['e_ids']['wall_ms']:.1f} ms")

    # (f) range(0, 100,000,000): sum and stddev_pop of id % 7
    n_r = 100_000_000
    q, r = divmod(n_r, 7)
    s1 = q * 21 + sum(range(r))
    s2 = q * 91 + sum(k * k for k in range(r))
    want_f = {"s": s1, "sd": math.sqrt(s2 / n_r - (s1 / n_r) ** 2)}
    for label in ("cold", "warm"):
        run, rows = _sql_run(session, lambda s: s.range(0, n_r).select(
            (F.col("id") % F.lit(7)).alias("m")).agg(
            F.sum(F.col("m")).with_name("s"),
            F.stddev_pop(F.col("m")).with_name("sd")))
        _check(rows[0]["s"] == want_f["s"]
               and _rel(rows[0]["sd"], want_f["sd"]) <= STATS_TOL,
               f"(f) range {label}: {rows} != {want_f}")
        out[f"f_{label}"] = run
    _log(f"phase 15 (f) range(0, {n_r}) ({card}): sum and stddev_pop of "
         f"id % 7 {rows[0]} equal the closed forms; "
         f"{out['f_cold']['wall_ms']:.1f} ms cold, "
         f"{out['f_warm']['wall_ms']:.1f} ms warm")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"phase 15 (slice 9a) took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: slice 9b -- list columns, collection and higher-order
# functions, generators and INTERSECT ALL / EXCEPT ALL
# ---------------------------------------------------------------------------

NESTED_LISTS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")
#: l_quantity again, with NULL and empty lists put in (case c)
HOLES = "q_holes"
DATE_1994 = int(np.datetime64("1994-01-01", "D").astype(np.int64))
SETOP_COLS = ["l_shipmode", "l_quantity"]
SETOP_SQL = """
SELECT l_shipmode, l_quantity FROM lineitem WHERE year(l_shipdate) = 1994
{verb}
SELECT l_shipmode, l_quantity FROM lineitem WHERE year(l_shipdate) = 1995
"""


def gen_nested_orders(t: dict) -> dict:
    """TPC-H orders denormalized with their lineitems (the layout nested
    data users query): one row an l_orderkey, and for each of
    ``NESTED_LISTS`` the order's values in lineitem row order, as
    (offsets, flat values); ``HOLES`` is l_quantity's lists with every
    17th order NULL and every 19th empty."""
    key = t["l_orderkey"]
    order = np.argsort(key, kind="stable")
    keys, starts, counts = np.unique(key[order], return_index=True,
                                     return_counts=True)
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    out = {"o_orderkey": keys, "offsets": offsets, "counts": counts}
    for name in NESTED_LISTS:
        out[name] = t[name][order]
    n = len(keys)
    null = np.arange(n) % 17 == 5
    empty = (np.arange(n) % 19 == 7) & ~null
    hcounts = np.where(null | empty, 0, counts)
    hoff = np.zeros(n + 1, np.int64)
    np.cumsum(hcounts, out=hoff[1:])
    keep = np.repeat(hcounts > 0, counts)
    out[HOLES] = (hoff, out["l_quantity"][keep], ~null)
    return out


def nested_host_table(o: dict):
    from spark_rapids_tpu_torch.columnar import HostList, HostTable
    cols = {"o_orderkey": o["o_orderkey"]}
    for name in NESTED_LISTS:
        cols[name] = HostList(o["offsets"], o[name])
    hoff, hvals, hvalid = o[HOLES]
    cols[HOLES] = (HostList(hoff, hvals), hvalid)
    return HostTable.from_dict(cols)


def _per_order(o: dict, values: np.ndarray, reduce) -> np.ndarray:
    return reduce.reduceat(values, o["offsets"][:-1])


def q_nested_a(df, F):
    q, p = F.col("l_quantity"), F.col("l_extendedprice")
    d = F.col("l_discount")
    cents = F.lit(100.0)
    return df.select(
        F.size(q).alias("n"),
        F.round(F.array_max(p) * cents).cast("bigint").alias("pmax"),
        F.round(F.element_at(p, -1) * cents).cast("bigint").alias("plast"),
        F.element_at(F.sort_array(q, False), 1).cast("bigint")
        .alias("qtop"),
        F.size(F.slice(d, 2, 3)).alias("nslice"),
        F.array_position(q, 50.0).alias("pos50"),
        F.when(F.array_contains(d, 0.1), F.lit(1)).otherwise(F.lit(0))
        .alias("has10")).agg(*[F.sum(F.col(c)).with_name(c) for c in (
            "n", "pmax", "plast", "qtop", "nslice", "pos50", "has10")])


def q_nested_a_count(df, F):
    return df.filter(F.array_contains(F.col("l_discount"), 0.1)) \
        .agg(F.count_star().with_name("orders"))


def nested_a_numpy(o: dict) -> dict:
    cnt = o["counts"]
    last = o["offsets"][1:] - 1
    p, q, d = o["l_extendedprice"], o["l_quantity"], o["l_discount"]
    row = np.repeat(np.arange(len(cnt)), cnt)
    hit = np.flatnonzero(q == 50.0)
    none = np.iinfo(np.int64).max
    best = np.full(len(cnt), none, np.int64)
    np.minimum.at(best, row[hit], hit - o["offsets"][row[hit]] + 1)
    first50 = np.where(best == none, 0, best)
    has10 = np.zeros(len(cnt), bool)
    has10[row[d == 0.1]] = True
    return {"n": int(cnt.sum()),
            "pmax": int(np.round(_per_order(o, p, np.maximum) * 100.0)
                        .astype(np.int64).sum()),
            "plast": int(np.round(p[last] * 100.0).astype(np.int64).sum()),
            "qtop": int(_per_order(o, q, np.maximum).astype(np.int64).sum()),
            "nslice": int(np.clip(cnt - 1, 0, 3).sum()),
            "pos50": int(first50.sum()), "has10": int(has10.sum())}


def q_nested_b_fold(df, F):
    return df.select("o_orderkey", F.aggregate(
        F.zip_with(F.col("l_extendedprice"), F.col("l_discount"),
                   lambda p, d: p * (F.lit(1.0) - d)),
        F.lit(0.0), lambda acc, x: acc + x).alias("revenue"))


def q_nested_b_counts(df, F):
    return df.select(
        F.size(F.filter(F.col("l_shipdate"), lambda d: d >= F.lit(
            np.datetime64("1994-01-01", "D")))).alias("late"),
        F.when(F.exists(F.col("l_quantity"), lambda q: q > F.lit(49.0)),
               F.lit(1)).otherwise(F.lit(0)).alias("big")).agg(
        F.sum(F.col("late")).with_name("late"),
        F.sum(F.col("big")).with_name("big"))


def nested_b_numpy(o: dict) -> dict:
    """Each order's revenue folded in element order, as the port folds it
    (bit-equal), their sum, and the two counts."""
    v = o["l_extendedprice"] * (1.0 - o["l_discount"])
    cnt, start = o["counts"], o["offsets"][:-1]
    rev = np.zeros(len(cnt))
    for j in range(int(cnt.max())):
        m = cnt > j
        rev[m] = rev[m] + v[start[m] + j]
    days = o["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    row = np.repeat(np.arange(len(cnt)), cnt)
    big = np.zeros(len(cnt), bool)
    big[row[o["l_quantity"] > 49.0]] = True
    return {"revenue": rev, "late": int((days >= DATE_1994).sum()),
            "big": int(big.sum())}


def q_nested_c(df, F):
    return df.select(F.posexplode(F.col("l_extendedprice"))) \
        .group_by("pos").agg(F.sum(F.col("col")).with_name("s"),
                             F.count_star().with_name("n")).order_by("pos")


def q_nested_c_outer(df, F):
    return df.select(F.explode_outer(F.col(HOLES))).agg(
        F.count_star().with_name("rows"),
        F.count(F.col("col")).with_name("values"),
        F.sum(F.col("col")).with_name("s"))


def nested_c_numpy(o: dict) -> dict:
    cnt, start = o["counts"], o["offsets"][:-1]
    p = o["l_extendedprice"]
    rows = []
    for j in range(int(cnt.max())):
        m = cnt > j
        rows.append({"pos": j, "s": float(p[start[m] + j].sum()),
                     "n": int(m.sum())})
    hoff, hvals, hvalid = o[HOLES]
    hcnt = np.diff(hoff)
    return {"by_pos": rows, "outer": {
        "rows": int(np.where(hcnt > 0, hcnt, 1).sum()),
        "values": int(len(hvals)), "s": float(hvals.sum())}}


def setop_all_numpy(t: dict) -> dict:
    """The (l_shipmode, l_quantity) multisets of 1994 and 1995 lineitems:
    per key the INTERSECT ALL count (the least of the two) and the EXCEPT
    ALL count (the first less the second, at least 0)."""
    year = t["l_shipdate"].astype("datetime64[Y]").astype(np.int64) + 1970
    modes, mode = np.unique(t["l_shipmode"], return_inverse=True)
    code = mode.astype(np.int64) * 1000 + t["l_quantity"].astype(np.int64)
    counts = [dict(zip(*(x.tolist() for x in np.unique(
        code[year == y], return_counts=True)))) for y in (1994, 1995)]
    out = {"intersect_all": {}, "except_all": {}}
    for c in set(counts[0]) | set(counts[1]):
        a, b = counts[0].get(c, 0), counts[1].get(c, 0)
        key = (str(modes[c // 1000]), float(c % 1000))
        if min(a, b):
            out["intersect_all"][key] = min(a, b)
        if a > b:
            out["except_all"][key] = a - b
    return out


def _setop_counts(got: dict) -> dict:
    """Per (l_shipmode, l_quantity) the rows of a collected result."""
    modes = np.asarray(got["l_shipmode"], dtype=object)
    qty = np.asarray(got["l_quantity"], dtype=np.float64)
    out: dict = {}
    for m, q in zip(modes.tolist(), qty.tolist()):
        out[(m, q)] = out.get((m, q), 0) + 1
    return out


def phase_nested(card: str, batch_rows: int, table: dict, host) -> dict:
    """Phase 16 (module doc): slice 9b through the normal entry points at
    full size, against numpy."""
    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar import ColumnarBatch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    o = gen_nested_orders(table)
    orders = nested_host_table(o)
    n_orders = len(o["o_orderkey"])
    longest = int(o["counts"].max())
    built = [ColumnarBatch.from_host(orders.slice(i, batch_rows), "cuda",
                                     64)
             for i in range(0, n_orders, batch_rows)]
    torch.cuda.synchronize()
    widths = [{f.name: c.width for f, c in zip(orders.schema.fields,
                                               b.columns)
               if hasattr(c, "width")} for b in built]
    n_batches = len(built)
    table_bytes = sum(b.device_size_bytes() for b in built)
    del built
    _log(f"phase 16: nested orders from SF1 lineitem in "
         f"{time.perf_counter() - t0:.2f} s: {n_orders} orders of 1-"
         f"{longest} lineitems in {n_batches} batches of up to "
         f"{batch_rows} orders, list widths by batch {widths}, "
         f"{table_bytes / 2**30:.2f} GiB on the card (the batches' "
         "device_size_bytes)")
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows}
    session = TorchSession(conf)
    out = {"orders": n_orders, "longest": longest, "widths": widths,
           "device_bytes": table_bytes, "batches": n_batches}

    def runs(label, make, right, collect="collect"):
        for phase in ("cold", "warm"):
            run, rows = _sql_run(session, make, collect)
            _check(right(rows), f"{label} {phase}: {str(rows)[:300]}")
            out[f"{label}_{phase}"] = run
        return rows

    # (a) collection functions, keyless sums over the orders
    want_a = nested_a_numpy(o)
    runs("a", lambda s: q_nested_a(s.create_dataframe(orders), F),
         lambda r: r == [want_a])
    runs("a_count",
         lambda s: q_nested_a_count(s.create_dataframe(orders), F),
         lambda r: r == [{"orders": want_a["has10"]}])
    out["a_profile_warm"] = phase_profile(
        session, orders, q_nested_a, lambda r: r == [want_a],
        f"phase 16 (a) collection functions ({card})", "dense_groupby")
    _log(f"phase 16 (a) collection functions over {n_orders} orders "
         f"({card}): {want_a} equal numpy exactly; "
         f"{out['a_cold']['wall_ms']:.1f} ms cold, "
         f"{out['a_warm']['wall_ms']:.1f} ms warm; the filtered count "
         f"{out['a_count_cold']['wall_ms']:.1f} / "
         f"{out['a_count_warm']['wall_ms']:.1f} ms; idle "
         f"{out['a_profile_warm'].get('idle_share', float('nan')):.1%}, "
         f"cudaLaunchKernel "
         f"{out['a_profile_warm'].get('host_calls', {}).get('cudaLaunchKernel')}")

    # (b) higher-order functions: each order's fold bit-equal to numpy's
    # fold in element order; the sum over the orders within 1e-12 (torch
    # and numpy add the 1.5 M folds in different orders)
    want_b = nested_b_numpy(o)

    def right_fold(got):
        rev = np.asarray(got["revenue"])
        return (np.array_equal(np.asarray(got["o_orderkey"]),
                               o["o_orderkey"])
                and np.array_equal(rev, want_b["revenue"])
                and _rel(float(rev.sum()), float(want_b["revenue"].sum()))
                <= 1e-12)
    runs("b_fold", lambda s: q_nested_b_fold(s.create_dataframe(orders), F),
         right_fold, "collect_numpy")
    runs("b_counts",
         lambda s: q_nested_b_counts(s.create_dataframe(orders), F),
         lambda r: r == [{"late": want_b["late"], "big": want_b["big"]}])
    _log(f"phase 16 (b) aggregate(zip_with(...)) over {n_orders} orders "
         f"({card}): every order's revenue bit-equal to numpy's fold, sum "
         f"{want_b['revenue'].sum()!r}; filter/exists counts "
         f"{want_b['late']}, {want_b['big']} exact; fold "
         f"{out['b_fold_cold']['wall_ms']:.1f} ms cold, "
         f"{out['b_fold_warm']['wall_ms']:.1f} ms warm; counts "
         f"{out['b_counts_cold']['wall_ms']:.1f} / "
         f"{out['b_counts_warm']['wall_ms']:.1f} ms")

    # (c) posexplode grouped by position (dense_groupby), explode_outer
    want_c = nested_c_numpy(o)

    def right_c(rows):
        w = want_c["by_pos"]
        return len(rows) == len(w) and all(
            g["pos"] == x["pos"] and g["n"] == x["n"]
            and _rel(g["s"], x["s"]) <= REL_TOL for g, x in zip(rows, w))
    runs("c", lambda s: q_nested_c(s.create_dataframe(orders), F), right_c)
    k = out["c_warm"]["launches"]["dense_groupby"]
    _check(k == n_batches, f"(c): dense_groupby launched {k} times, "
           f"expected {n_batches} (once a generated batch)")
    wo = want_c["outer"]
    runs("c_outer",
         lambda s: q_nested_c_outer(s.create_dataframe(orders), F),
         lambda r: len(r) == 1 and r[0]["rows"] == wo["rows"]
         and r[0]["values"] == wo["values"]
         and _rel(r[0]["s"], wo["s"]) <= REL_TOL)
    out["c_profile_warm"] = phase_profile(
        session, orders, q_nested_c, right_c,
        f"phase 16 (c) posexplode by position ({card})", "dense_groupby")
    _log(f"phase 16 (c) posexplode(l_extendedprice) by pos ({card}): "
         f"{int(o['counts'].sum())} exploded rows, {len(want_c['by_pos'])} "
         f"positions equal numpy (counts exact, sums within {REL_TOL:g}); "
         f"{out['c_cold']['wall_ms']:.1f} ms cold, "
         f"{out['c_warm']['wall_ms']:.1f} ms warm; dense_groupby "
         f"launches {k}; idle "
         f"{out['c_profile_warm'].get('idle_share', float('nan')):.1%}, "
         f"cudaLaunchKernel "
         f"{out['c_profile_warm'].get('host_calls', {}).get('cudaLaunchKernel')}"
         f"; explode_outer over {HOLES} {wo['rows']} rows "
         f"{out['c_outer_cold']['wall_ms']:.1f} / "
         f"{out['c_outer_warm']['wall_ms']:.1f} ms")

    # (d) INTERSECT ALL / EXCEPT ALL of 1994's (l_shipmode, l_quantity)
    # rows against 1995's
    want_d = setop_all_numpy(table)
    li = host.select(SETOP_COLS + ["l_shipdate"])
    session.create_dataframe(li).create_or_replace_temp_view("lineitem")

    def frame(s, year):
        return s.create_dataframe(li).filter(
            F.year(F.col("l_shipdate")) == F.lit(year)).select(*SETOP_COLS)
    for verb, op in (("INTERSECT ALL", "intersect_all"),
                     ("EXCEPT ALL", "except_all")):
        want = want_d[op]
        n_want = sum(want.values())
        forms = {"dataframe": lambda s, op=op: getattr(frame(s, 1994), op)(
                     frame(s, 1995)),
                 "sql": lambda s, verb=verb: s.sql(
                     SETOP_SQL.format(verb=verb))}
        for form, make in forms.items():
            runs(f"d_{op}_{form}", make,
                 lambda got, want=want: _setop_counts(got) == want,
                 "collect_numpy")
        k = out[f"d_{op}_dataframe_warm"]["launches"]["join_match"]
        _check(k > 0 and out[f"d_{op}_sql_warm"]["launches"]["join_match"]
               > 0, f"(d) {verb}: join_match did not launch")
        _log(f"phase 16 (d) {verb} of 1994's and 1995's (l_shipmode, "
             f"l_quantity) ({card}): {n_want} rows over {len(want)} keys "
             f"(multiplicities up to {max(want.values())}) equal numpy's "
             "multisets; DataFrame "
             f"{out[f'd_{op}_dataframe_cold']['wall_ms']:.1f} ms cold, "
             f"{out[f'd_{op}_dataframe_warm']['wall_ms']:.1f} ms warm; SQL "
             f"{out[f'd_{op}_sql_cold']['wall_ms']:.1f} / "
             f"{out[f'd_{op}_sql_warm']['wall_ms']:.1f} ms; join_match "
             f"launches {out[f'd_{op}_dataframe_warm']['launches']['join_match']}"
             f" (SQL {out[f'd_{op}_sql_warm']['launches']['join_match']})")
        out[f"d_{op}_rows"] = n_want
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"phase 16 (slice 9b) took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: slice 9b's map and struct half -- struct and map columns, the
# map functions and lambdas, explode of a map, collect_list / collect_set
# / min_by / max_by / percentile
# ---------------------------------------------------------------------------

#: case (f)'s batchSizeBytes: the orders' sort goes out of core
NESTED_SORT_BYTES = 64 << 20
#: case (g)'s batchSizeBytes: the partials of every order outgrow it, so
#: the order statistics merge partition by partition
ORDER_STATS_SPLIT_BYTES = 4 << 20
Q1_CUTOFF = np.datetime64("1998-12-01") - np.timedelta64(90, "D")


def gen_order_maps(o: dict, t: dict) -> dict:
    """Phase 16's orders (``gen_nested_orders``) with ``o_lines``, a
    map<int, double> of linenumber -> extendedprice (every 17th order's
    NULL, every 19th empty), ``o_info``, a struct<lines: int, qty:
    double, mode: string> (the order's first lineitem's l_shipmode; every
    23rd NULL), and ``o_totalprice``; ``row_linenumber`` is each
    lineitem's 1-based place in its order, in lineitem row order (the
    TPC-H l_linenumber of the generated rows)."""
    n = len(o["o_orderkey"])
    cnt, off = o["counts"], o["offsets"]
    price = o["l_extendedprice"]
    ln = (np.arange(off[-1]) - np.repeat(off[:-1], cnt) + 1).astype(
        np.int32)
    null = np.arange(n) % 17 == 5
    empty = (np.arange(n) % 19 == 7) & ~null
    hcnt = np.where(null | empty, 0, cnt)
    hoff = np.zeros(n + 1, np.int64)
    np.cumsum(hcnt, out=hoff[1:])
    keep = np.repeat(hcnt > 0, cnt)
    order = np.argsort(t["l_orderkey"], kind="stable")
    row_ln = np.empty(len(ln), np.int32)
    row_ln[order] = ln
    return {**o, "linenumber": ln, "row_linenumber": row_ln,
            "o_lines": (hoff, ln[keep], price[keep], ~null),
            "o_info": {"lines": cnt.astype(np.int32),
                       "qty": np.add.reduceat(o["l_quantity"], off[:-1]),
                       "mode": t["l_shipmode"][order][off[:-1]],
                       "valid": np.arange(n) % 23 != 4},
            "o_totalprice": np.add.reduceat(price, off[:-1])}


def order_maps_table(om: dict):
    from spark_rapids_tpu_torch.columnar import (HostMap, HostStruct,
                                                 HostTable)
    hoff, keys, vals, valid = om["o_lines"]
    info = om["o_info"]
    return HostTable.from_dict({
        "o_orderkey": om["o_orderkey"], "o_totalprice": om["o_totalprice"],
        "o_lines": (HostMap(hoff, keys, vals), valid),
        "o_info": (HostStruct(HostTable.from_dict(
            {k: info[k] for k in ("lines", "qty", "mode")})),
            info["valid"])})


def q17_collect(df, F):
    return df.group_by("l_orderkey").agg(
        F.collect_list(F.col("l_quantity")).with_name("q"),
        F.collect_list(F.col("l_linenumber")).with_name("ln"),
        F.collect_list(F.col("l_extendedprice")).with_name("p"),
        F.collect_set(F.col("l_quantity")).with_name("qs"))


def _cents(c, F):
    return F.round(c * F.lit(100.0)).cast("bigint")


def q17_maps(df, F):
    lists = df.group_by("l_orderkey").agg(
        F.collect_list(F.col("l_linenumber")).with_name("ln"),
        F.collect_list(F.col("l_extendedprice")).with_name("p"))
    m = F.map_from_arrays(F.col("ln"), F.col("p"))
    cm = F.create_map(F.lit(0), F.size(F.col("p")).cast("double"),
                      F.lit(-1), F.element_at(F.col("p"), 1))
    both = F.map_concat(F.col("m"), F.col("cm"))
    twice = F.transform_values(F.col("m"), lambda k, v: v * F.lit(2.0))
    cols = {
        "first": _cents(F.element_at(F.col("m"), 1), F),
        "big": F.size(F.map_filter(F.col("m"),
                                   lambda k, v: v > F.lit(50000.0))),
        "lines": F.array_max(F.map_keys(F.col("m"))),
        "twice": F.aggregate(
            F.transform(F.map_values(twice), lambda x: _cents(x, F)),
            F.lit(0).cast("bigint"), lambda acc, x: acc + x),
        "entries": F.size(F.map_entries(F.col("m"))),
        "joined": F.size(both),
        "last": _cents(F.element_at(both, -1), F)}
    return lists.select(m.alias("m"), cm.alias("cm")).select(
        *[c.alias(n) for n, c in cols.items()]).agg(
        *[F.sum(F.col(n)).with_name(n) for n in cols])


def q17_structs(df, F):
    s = F.col("s")
    return df.select(F.struct(
        F.col("l_quantity"), F.col("l_extendedprice"), F.col("l_discount"),
        F.col("l_shipmode")).alias("s")).filter(
        F.get_field(s, "l_quantity") > F.lit(45.0)).agg(
        F.sum(F.get_field(s, "l_quantity")).with_name("qty"),
        F.sum(_cents(F.get_field(s, "l_extendedprice"), F))
        .with_name("price_cents"),
        F.sum(_cents(F.get_field(s, "l_discount"), F))
        .with_name("discount_cents"),
        F.count(F.get_field(s, "l_shipmode")).with_name("n"))


def q17_by_pos(df, F):
    return df.select(F.posexplode(F.col("o_lines"))).group_by("pos").agg(
        F.sum(F.col("value")).with_name("s"),
        F.count_star().with_name("n")).order_by("pos")


def q17_by_key(df, F):
    return df.select(F.explode(F.col("o_lines"))).group_by("key").agg(
        F.sum(F.col("value")).with_name("s"),
        F.count_star().with_name("n")).order_by("key")


def q17_outer(df, F):
    return df.select(F.explode_outer(F.col("o_lines"))).agg(
        F.count_star().with_name("rows"),
        F.count(F.col("value")).with_name("values"),
        F.sum(F.col("value")).with_name("s"))


def q17_stats(df, F):
    from spark_rapids_tpu_torch.exprs.aggregates import \
        ApproximatePercentile
    return df.filter(F.col("l_shipdate") <= F.lit(Q1_CUTOFF)).group_by(
        "l_returnflag", "l_linestatus").agg(
        F.percentile(F.col("l_extendedprice"), 0.5).with_name("p50_price"),
        F.percentile(F.col("l_quantity"), 0.9).with_name("p90_qty"),
        ApproximatePercentile(F.col("l_discount").expr, 0.25)
        .with_name("p25_disc"),
        F.min_by(F.col("l_orderkey"), F.col("l_extendedprice"))
        .with_name("cheapest"),
        F.max_by(F.col("l_orderkey"), F.col("l_extendedprice"))
        .with_name("dearest")).order_by("l_returnflag", "l_linestatus")


def q17_split_stats(df, F):
    return df.group_by("l_orderkey").agg(
        F.percentile(F.col("l_extendedprice"), 0.5).with_name("p50_price"),
        F.percentile(F.col("l_quantity"), 0.75).with_name("p75_qty"))


def q17_sorted(df, F):
    return df.order_by(F.desc("o_totalprice"), F.asc("o_orderkey"))


def _list_rows(lst, order: np.ndarray):
    """(lengths, flat values) of a collected list column's rows taken in
    ``order``."""
    off, vals = lst[0], lst[1]
    lens = np.diff(off)[order]
    starts = off[:-1][order]
    idx = np.repeat(starts - (np.cumsum(lens) - lens), lens) \
        + np.arange(int(lens.sum()))
    return lens, vals[idx]


def _sorted_sets(lens: np.ndarray, vals: np.ndarray):
    """Each row's distinct values, sorted: (lengths, flat values)."""
    row = np.repeat(np.arange(len(lens)), lens)
    o = np.lexsort((vals, row))
    r, v = row[o], vals[o]
    keep = np.r_[True, (r[1:] != r[:-1]) | (v[1:] != v[:-1])]
    return np.bincount(r[keep], minlength=len(lens)), v[keep]


def collect17_right(got: dict, om: dict) -> bool:
    keys = np.asarray(got["l_orderkey"])
    order = np.argsort(keys, kind="stable")
    if not np.array_equal(keys[order], om["o_orderkey"]):
        return False
    cnt = om["counts"]
    for name, want in (("q", om["l_quantity"]), ("ln", om["linenumber"]),
                       ("p", om["l_extendedprice"])):
        lens, vals = _list_rows(got[name], order)
        if not (np.array_equal(lens, cnt) and np.array_equal(vals, want)):
            return False
    lens, vals = _list_rows(got["qs"], order)
    wl, wv = _sorted_sets(cnt, om["l_quantity"])
    gl, gv = _sorted_sets(lens, vals)
    return np.array_equal(lens, wl) and np.array_equal(gl, wl) \
        and np.array_equal(gv, wv)


def maps17_numpy(om: dict) -> dict:
    p, cnt, off = om["l_extendedprice"], om["counts"], om["offsets"]
    first = np.round(p[off[:-1]] * 100.0).astype(np.int64).sum()
    return {"first": int(first), "big": int((p > 50000.0).sum()),
            "lines": int(cnt.sum()),
            "twice": int(np.round((p * 2.0) * 100.0).astype(np.int64).sum()),
            "entries": int(cnt.sum()),
            "joined": int(cnt.sum() + 2 * len(cnt)), "last": int(first)}


def structs17_numpy(t: dict) -> dict:
    m = t["l_quantity"] > 45.0
    return {"qty": float(t["l_quantity"][m].sum()),
            "price_cents": int(np.round(t["l_extendedprice"][m] * 100.0)
                               .astype(np.int64).sum()),
            "discount_cents": int(np.round(t["l_discount"][m] * 100.0)
                                  .astype(np.int64).sum()),
            "n": int(m.sum())}


def lines17_numpy(om: dict) -> dict:
    hoff, keys, vals, valid = om["o_lines"]
    hcnt = np.diff(hoff)
    pos = np.arange(len(keys)) - np.repeat(hoff[:-1], hcnt)
    by_pos = [{"pos": j, "s": float(vals[pos == j].sum()),
               "n": int((pos == j).sum())} for j in range(int(hcnt.max()))]
    return {"by_pos": by_pos, "outer": {
        "rows": int(np.where(hcnt > 0, hcnt, 1).sum()),
        "values": int(len(vals)), "s": float(vals.sum())}}


def _spark_percentile(vals: np.ndarray, p: float) -> float:
    """Spark's Percentile over sorted values: ``(hi - pos) * v[lo] +
    (pos - lo) * v[hi]``, ``pos = p * (n - 1)``."""
    pos = p * (len(vals) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi:
        return float(vals[lo])
    return float((hi - pos) * vals[lo] + (pos - lo) * vals[hi])


def stats17_numpy(t: dict) -> list:
    m = t["l_shipdate"] <= Q1_CUTOFF
    out = []
    for f in ("A", "N", "R"):
        for s in ("F", "O"):
            g = m & (t["l_returnflag"] == f) & (t["l_linestatus"] == s)
            if not g.any():
                continue
            price, key = t["l_extendedprice"][g], t["l_orderkey"][g]
            out.append({
                "l_returnflag": f, "l_linestatus": s,
                "p50_price": _spark_percentile(np.sort(price), 0.5),
                "p90_qty": _spark_percentile(np.sort(t["l_quantity"][g]),
                                             0.9),
                "p25_disc": _spark_percentile(np.sort(t["l_discount"][g]),
                                              0.25),
                "cheapest": int(key[np.argmin(price)]),
                "dearest": int(key[np.argmax(price)])})
    return out


def split_stats17_right(got: dict, t: dict) -> bool:
    """(g): each order's percentiles against Spark's definition in numpy,
    computed as the port computes it (float64, ``pos = p * (n - 1)``)."""
    keys = np.asarray(got["l_orderkey"])
    order = np.argsort(keys, kind="stable")
    k = t["l_orderkey"]
    uniq, counts = np.unique(k, return_counts=True)
    if not np.array_equal(keys[order], uniq):
        return False
    start = np.cumsum(counts) - counts
    for name, col, p in (("p50_price", "l_extendedprice", 0.5),
                         ("p75_qty", "l_quantity", 0.75)):
        if np.ma.getmaskarray(got[name]).any():
            return False
        v = t[col][np.lexsort((t[col], k))]
        pos = p * (counts - 1).astype(np.float64)
        lo = np.floor(pos).astype(np.int64)
        hi = np.ceil(pos).astype(np.int64)
        a, b = v[start + lo], v[start + hi]
        want = np.where(lo == hi, a, (hi - pos) * a + (pos - lo) * b)
        if not np.array_equal(np.asarray(got[name])[order], want):
            return False
    return True


def sorted17_right(got: dict, om: dict) -> bool:
    """The sorted orders' keys, prices, maps and structs against numpy's
    order (price descending, then key)."""
    order = np.lexsort((om["o_orderkey"], -om["o_totalprice"]))
    if not (np.array_equal(np.asarray(got["o_orderkey"]),
                           om["o_orderkey"][order])
            and np.array_equal(np.asarray(got["o_totalprice"]),
                               om["o_totalprice"][order])):
        return False
    hoff, keys, vals, valid = om["o_lines"]
    off, gk, gv, gvv, gvalid = got["o_lines"]
    if not np.array_equal(gvalid, valid[order]) or not gvv.all():
        return False
    lens, wk = _list_rows((hoff, keys), order)
    _, wv = _list_rows((hoff, vals), order)
    if not (np.array_equal(np.diff(off), lens) and np.array_equal(gk, wk)
            and np.array_equal(gv, wv)):
        return False
    fields, svalid = got["o_info"]
    info = om["o_info"]
    ok = info["valid"][order]
    return np.array_equal(svalid, ok) and all(
        np.array_equal(np.asarray(fields[k])[ok], info[k][order][ok])
        for k in ("lines", "qty", "mode"))


def _find_exec(node, name: str):
    while node is not None and type(node).__name__ != name:
        node = node.children[0] if node.children else None
    return node


def phase_maps_structs(card: str, batch_rows: int, table: dict,
                       host) -> dict:
    """Phase 17 (module doc): maps, structs and the collect and order
    aggregates through the normal entry points at full size, against
    numpy."""
    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, HostTable
    from spark_rapids_tpu_torch.types import INT32, Schema, StructField
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    om = gen_order_maps(gen_nested_orders(table), table)
    orders = order_maps_table(om)
    li = host.select(["l_orderkey", "l_quantity", "l_extendedprice",
                      "l_discount", "l_shipmode", "l_shipdate",
                      "l_returnflag", "l_linestatus"])
    li = HostTable({**li.columns, "l_linenumber": (
        om["row_linenumber"], np.ones(li.num_rows, bool))},
        Schema(list(li.schema.fields)
               + [StructField("l_linenumber", INT32, True)]))
    n_orders = len(om["o_orderkey"])
    built = [ColumnarBatch.from_host(orders.slice(i, batch_rows), "cuda",
                                     64)
             for i in range(0, n_orders, batch_rows)]
    torch.cuda.synchronize()
    n_batches = len(built)
    sizes = [{f.name: c.nbytes() for f, c in zip(orders.schema.fields,
                                                 b.columns)} for b in built]
    widths = [b.columns[2].width for b in built]
    table_bytes = sum(b.device_size_bytes() for b in built)
    del built
    _log(f"phase 17: orders with o_lines and o_info from SF1 lineitem in "
         f"{time.perf_counter() - t0:.2f} s: {n_orders} orders in "
         f"{n_batches} batches, map widths {widths}, device_size_bytes "
         f"{table_bytes} ({table_bytes / 2**30:.3f} GiB; by column and "
         f"batch {sizes})")
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows}
    session = TorchSession(conf)
    out = {"orders": n_orders, "device_bytes": table_bytes,
           "map_widths": widths, "batches": n_batches}

    def runs(label, make, right, collect="collect", s=session):
        for phase in ("cold", "warm"):
            run, rows = _sql_run(s, make, collect)
            _check(right(rows), f"{label} {phase}: {str(rows)[:300]}")
            out[f"{label}_{phase}"] = run
        return rows

    def walls(label):
        return (f"{out[f'{label}_cold']['wall_ms']:.1f} ms cold, "
                f"{out[f'{label}_warm']['wall_ms']:.1f} ms warm")

    # (a) collect_list / collect_set by l_orderkey
    runs("a", lambda s: q17_collect(s.create_dataframe(li), F),
         lambda got: collect17_right(got, om), "collect_numpy")
    agg = _find_exec(session.last_plan, "TpuHashAggregateExec")
    out["a_repartitions"] = agg.last_repartitions if agg else None
    out["a_profile_warm"] = phase_profile(
        session, li, q17_collect, lambda got: collect17_right(got, om),
        f"phase 17 (a) collect_list/collect_set ({card})", "sort",
        "collect_numpy")
    _log(f"phase 17 (a) collect_list x3 and collect_set by l_orderkey "
         f"({card}): {n_orders} groups, every list equal to numpy's in "
         f"arrival order and every set sorted; {walls('a')}; merge "
         f"repartitions {out['a_repartitions']}; peak "
         f"{out['a_warm']['max_memory_allocated'] / 2**30:.2f} GiB; idle "
         f"{out['a_profile_warm'].get('idle_share', float('nan')):.1%}, "
         f"cudaLaunchKernel "
         f"{out['a_profile_warm'].get('host_calls', {}).get('cudaLaunchKernel')}")

    # (b) maps from (a)'s lists
    want_b = maps17_numpy(om)
    runs("b", lambda s: q17_maps(s.create_dataframe(li), F),
         lambda r: r == [want_b])
    _log(f"phase 17 (b) map_from_arrays / create_map / map_concat and "
         f"the map functions over {n_orders} maps ({card}): {want_b} "
         f"equal numpy exactly; {walls('b')}")

    # (c) structs over lineitem
    want_c = structs17_numpy(table)
    runs("c", lambda s: q17_structs(s.create_dataframe(li), F),
         lambda r: r == [want_c])
    _log(f"phase 17 (c) struct(l_quantity, l_extendedprice, l_discount, "
         f"l_shipmode) filtered on get_field > 45 over {SF1_ROWS} rows "
         f"({card}): {want_c} equal numpy exactly; {walls('c')}")

    # (d) a map column at ingest: posexplode by pos, explode by key,
    # explode_outer
    want_d = lines17_numpy(om)

    def right_d(rows, key="pos"):
        w = want_d["by_pos"]
        return len(rows) == len(w) and all(
            g[key] == x["pos"] + (key == "key") and g["n"] == x["n"]
            and _rel(g["s"], x["s"]) <= REL_TOL for g, x in zip(rows, w))
    runs("d_pos", lambda s: q17_by_pos(s.create_dataframe(orders), F),
         right_d)
    k = out["d_pos_warm"]["launches"]["dense_groupby"]
    _check(k == n_batches, f"(d): dense_groupby launched {k} times, "
           f"expected {n_batches} (once a generated batch)")
    runs("d_key", lambda s: q17_by_key(s.create_dataframe(orders), F),
         lambda rows: right_d(rows, "key"))
    kk = out["d_key_warm"]["launches"]["dense_groupby"]
    _check(kk == 0, f"(d) by key launched dense_groupby {kk} times: a "
           "map's keys take the sort route")
    wo = want_d["outer"]
    runs("d_outer", lambda s: q17_outer(s.create_dataframe(orders), F),
         lambda r: len(r) == 1 and r[0]["rows"] == wo["rows"]
         and r[0]["values"] == wo["values"]
         and _rel(r[0]["s"], wo["s"]) <= REL_TOL)
    _log(f"phase 17 (d) o_lines (map<int, double>, NULL and empty maps) "
         f"({card}): {len(om['o_lines'][1])} entries; posexplode by pos "
         f"{walls('d_pos')}, dense_groupby launches {k} over {n_batches} "
         f"batches; explode by key (sort route, 0 launches) "
         f"{walls('d_key')}; explode_outer {wo['rows']} rows "
         f"{walls('d_outer')}; sums within {REL_TOL:g}, counts exact")

    # (e) order statistics in q1's groups
    want_e = stats17_numpy(table)
    runs("e", lambda s: q17_stats(s.create_dataframe(li), F),
         lambda r: r == want_e)
    agg = _find_exec(session.last_plan, "TpuHashAggregateExec")
    out["e_stream_buckets"] = list(agg.last_stream_buckets) if agg else None
    out["e_profile_warm"] = phase_profile(
        session, li, q17_stats, lambda r: r == want_e,
        f"phase 17 (e) percentile / min_by / max_by ({card})", "sort")
    _log(f"phase 17 (e) percentile(l_extendedprice, 0.5), percentile("
         f"l_quantity, 0.9), approx_percentile(l_discount, 0.25), min_by "
         f"and max_by(l_orderkey, l_extendedprice) by l_returnflag, "
         f"l_linestatus over SF1 ({card}): {len(want_e)} groups equal "
         f"Spark's definitions in numpy exactly: {want_e}; {walls('e')}; "
         f"value-stream sorts' buckets {out['e_stream_buckets']} (0: in "
         f"memory); peak "
         f"{out['e_warm']['max_memory_allocated'] / 2**30:.2f} GiB; idle "
         f"{out['e_profile_warm'].get('idle_share', float('nan')):.1%}, "
         f"cudaLaunchKernel "
         f"{out['e_profile_warm'].get('host_calls', {}).get('cudaLaunchKernel')}")

    # (f) the orders with their map and struct, out of core
    ooc = TorchSession({**conf, "spark.rapids.tpu.sql.batchSizeBytes":
                        NESTED_SORT_BYTES})
    runs("f", lambda s: q17_sorted(s.create_dataframe(orders), F),
         lambda got: sorted17_right(got, om), "collect_numpy", ooc)
    sorter = _find_exec(ooc.last_plan, "TpuSortExec")
    out["f_buckets"] = sorter.last_buckets if sorter else None
    kf = out["f_warm"]["launches"]["sort_bucket"]
    _check(kf > 0 and out["f_buckets"] and out["f_buckets"] > 1,
           f"(f): sort_bucket launched {kf} times over "
           f"{out['f_buckets']} buckets: not out of core")
    _log(f"phase 17 (f) ORDER BY o_totalprice DESC, o_orderkey of "
         f"{n_orders} orders with o_lines and o_info, batchSizeBytes "
         f"{NESTED_SORT_BYTES} ({card}): every row's key, price, map and "
         f"struct equal numpy's after the sort; {walls('f')}; "
         f"{out['f_buckets']} buckets, sort_bucket launches {kf}; peak "
         f"{out['f_warm']['max_memory_allocated'] / 2**30:.2f} GiB")

    # (g) order statistics of every order: the merge split by partition
    split = TorchSession({**conf, "spark.rapids.tpu.sql.batchSizeBytes":
                          ORDER_STATS_SPLIT_BYTES})
    runs("g", lambda s: q17_split_stats(s.create_dataframe(li), F),
         lambda got: split_stats17_right(got, table), "collect_numpy",
         split)
    agg = _find_exec(split.last_plan, "TpuHashAggregateExec")
    out["g_repartitions"] = agg.last_repartitions if agg else None
    out["g_stream_buckets"] = list(agg.last_stream_buckets) if agg \
        else None
    gb = out["g_stream_buckets"] or []
    _check(bool(out["g_repartitions"]) and out["g_repartitions"] > 1,
           f"(g): the merge was split into {out['g_repartitions']} "
           "partitions, expected more than 1")
    _log(f"phase 17 (g) percentile(l_extendedprice, 0.5), percentile("
         f"l_quantity, 0.75) by l_orderkey, batchSizeBytes "
         f"{ORDER_STATS_SPLIT_BYTES} ({card}): {n_orders} groups equal "
         f"Spark's definition in numpy exactly; {walls('g')}; merge "
         f"partitions {out['g_repartitions']}, {len(gb)} value-stream "
         f"sorts, {sum(b > 1 for b in gb)} of them out of core, buckets "
         f"at most {max(gb, default=0)}; sort_bucket launches "
         f"{out['g_warm']['launches']['sort_bucket']}; peak "
         f"{out['g_warm']['max_memory_allocated'] / 2**30:.2f} GiB")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"phase 17 (maps and structs) took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: slice 9b's rest, first part -- strings and structs inside lists
# and maps, split, str_to_map and the host-engine array functions
# ---------------------------------------------------------------------------

#: TPC-H's l_shipinstruct domain (the spec's 4.2.2.13); gen_lineitem has no
#: such column, so phase 18 draws one from its own seed
SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN"]
#: l_shipmode's domain, sorted (gen_lineitem's draws)
SHIPMODES = sorted(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "REG AIR",
                    "FOB"])
#: the literal list (b) sets the collected modes against
MODE_PAIR = ("AIR", "REG AIR")
#: phase 18 (e)'s batchSizeBytes: the orders with their lists (about
#: 1.1 GB on the card) sort out of core
NESTED18_SORT_BYTES = 128 << 20
#: phase 18's scan cache: (c)'s orders (about 3.7 GB on the card) stay
#: on the card between its queries, so a warm run reads no host table
SCAN18_CACHE_BYTES = 16 << 30


def gen_shipinstruct(n_rows: int, seed: int = SEED + 18) -> np.ndarray:
    return np.array(SHIPINSTRUCT, "S17")[
        np.random.RandomState(seed).randint(0, len(SHIPINSTRUCT), n_rows)]


def _comment_rect(comment: np.ndarray):
    """(uint8 [n, 64] rectangle, byte lengths) of ``gen_comment``'s
    comments (none holds a 0x00 byte)."""
    rect = np.ascontiguousarray(comment).view(np.uint8).reshape(
        len(comment), -1)
    return rect, (rect != 0).sum(axis=1)


def _windows(rows: np.ndarray, pat: bytes) -> np.ndarray:
    """bool [n, positions]: where ``pat`` starts in each row."""
    m = rows.shape[1] - len(pat) + 1
    hit = np.ones((rows.shape[0], m), bool)
    for t, ch in enumerate(pat):
        hit &= rows[:, t:t + m] == ch
    return hit


def _word_spans(comment: np.ndarray):
    """``bytes.split(b' ')`` of every comment at once: (the comments'
    bytes joined with one space after each, each word's start and
    length in them, each word's row)."""
    rect, lens = _comment_rect(comment)
    n, w = rect.shape
    keep = np.ones((n, w + 1), bool)
    keep[:, :w] = np.arange(w)[None, :] < lens[:, None]
    flat = np.concatenate([rect, np.full((n, 1), 32, np.uint8)],
                          axis=1)[keep]
    cut = np.flatnonzero(flat == 32)          # every word ends at one
    start = np.concatenate([[0], cut[:-1] + 1])
    row = np.searchsorted(np.cumsum(lens + 1) - 1, cut)
    return flat, start, cut - start, row


def _word_is(flat, start, length, word: bytes, prefix: bool = False,
             at_end: bool = False) -> np.ndarray:
    """bool per word: it equals ``word`` (``prefix``: starts with it;
    ``at_end``: ends with it)."""
    n = len(word)
    at = np.flatnonzero(length >= n if (prefix or at_end)
                        else length == n)
    base = start[at] + (length[at] - n if at_end else 0)
    for t, ch in enumerate(word):
        keep = flat[base + t] == ch
        at, base = at[keep], base[keep]
    out = np.zeros(len(start), bool)
    out[at] = True
    return out


def words18_numpy(comment: np.ndarray) -> dict:
    """Case (a) in numpy, by ``bytes.split(b' ')``'s rules: a row's words
    are the pieces between spaces (empty ones at a leading or trailing
    space, or between two)."""
    flat, start, length, row = _word_spans(comment)
    n = len(comment)

    def rows_with(hit):
        return int(np.bincount(row[hit], minlength=n).astype(bool).sum())
    return {"n_words": int(len(start)),
            "special": rows_with(_word_is(flat, start, length,
                                          b"special")),
            "furious": rows_with(_word_is(flat, start, length, b"furious",
                                          prefix=True)),
            "ly": int(_word_is(flat, start, length, b"ly",
                               at_end=True).sum()),
            "bytes": int(len(flat) - n)}


def joined18_numpy(comment: np.ndarray) -> np.ndarray:
    """``array_join(transform(split(c, ' '), w -> upper(w)), '-')`` in
    numpy: the comment upper-cased with every space made '-' (an ``S64``
    array)."""
    rect, _ = _comment_rect(comment)
    up = np.where((rect >= 97) & (rect <= 122), rect - 32, rect) \
        .astype(np.uint8)
    up[up == 32] = ord("-")
    return np.ascontiguousarray(up).view(f"S{rect.shape[1]}").reshape(-1)


def q18_words(df, F):
    w = F.col("words")
    return df.select(F.split(F.col("l_comment"), " ").alias("words")).agg(
        F.sum(F.size(w)).with_name("n_words"),
        F.sum(F.array_contains(w, "special").cast("bigint"))
        .with_name("special"),
        F.sum(F.exists(w, lambda x: x.like("furious%")).cast("bigint"))
        .with_name("furious"),
        F.sum(F.size(F.filter(w, lambda x: x.like("%ly")))).with_name("ly"))


def _joined(F):
    return F.array_join(F.transform(F.split(F.col("l_comment"), " "),
                                    lambda x: F.upper(x)), "-")


def q18_joined(df, F):
    return df.select(_joined(F).alias("j"))


def q18_joined_bytes(df, F):
    return df.select(_joined(F).alias("j")).select(
        F.length(F.col("j")).alias("n")).agg(
        F.sum(F.col("n")).with_name("bytes"),
        F.count(F.col("n")).with_name("rows"))


def q18_lists(df, F):
    return df.group_by("l_orderkey").agg(
        F.collect_list(F.col("l_shipmode")).with_name("modes"),
        F.collect_set(F.col("l_shipinstruct")).with_name("instr"),
        F.collect_list(F.struct(F.col("l_linenumber"), F.col("l_quantity"),
                                F.col("l_shipmode"))).with_name("items"),
        F.collect_list(F.col("l_linenumber")).with_name("lns"),
        F.max_by(F.col("l_shipmode"), F.col("l_extendedprice"))
        .with_name("dear"))


def _size_sum(c, name, F):
    return F.sum(F.size(c)).with_name(name)


def q18_setops(df, F):
    m, lns = F.col("modes"), F.col("lns")
    pair = F.array(*[F.lit(x) for x in MODE_PAIR])
    return q18_lists(df, F).agg(
        _size_sum(F.array_distinct(m), "distinct", F),
        _size_sum(F.array_union(m, pair), "union", F),
        _size_sum(F.array_intersect(m, pair), "intersect", F),
        _size_sum(F.array_except(m, pair), "except", F),
        _size_sum(F.array_remove(m, "MAIL"), "removed", F),
        F.sum(F.arrays_overlap(m, pair).cast("bigint")).with_name("overlap"),
        _size_sum(F.arrays_zip(lns, m), "zipped", F),
        _size_sum(F.concat_arrays(lns, F.array_repeat(F.size(lns), 2)),
                  "concat", F))


def q18_mode_sets(df, F):
    key = F.array_join(F.sort_array(F.array_distinct(F.col("modes"))), ",")
    return q18_lists(df, F).group_by(key.alias("modes")).agg(
        F.count_star().with_name("n")).order_by("modes")


def lists18_numpy(om: dict, t: dict, instr: np.ndarray) -> dict:
    """Case (b) in numpy: each order's lines in arrival order (phase 16's
    ``gen_nested_orders``), the mode sets as bit masks."""
    order = np.argsort(t["l_orderkey"], kind="stable")
    off, cnt = om["offsets"], om["counts"]
    modes = t["l_shipmode"][order].astype("S7")
    code = np.searchsorted(np.array(SHIPMODES, "S7"), modes)
    mask = np.bitwise_or.reduceat(1 << code, off[:-1])
    pair = sum(1 << SHIPMODES.index(x) for x in MODE_PAIR)
    price = t["l_extendedprice"][order]
    best = np.maximum.reduceat(price, off[:-1])
    first = np.minimum.reduceat(np.where(price == np.repeat(best, cnt),
                                         np.arange(len(price)), len(price)),
                                off[:-1])

    def bits(x):
        return np.array([bin(v).count("1") for v in range(128)])[x]
    sets = {}
    for m, n in zip(*np.unique(mask, return_counts=True)):
        sets[",".join(s for i, s in enumerate(SHIPMODES)
                      if m >> i & 1)] = int(n)
    return {"order": order, "modes": modes, "instr": instr[order],
            "dear": modes[first], "mask": mask,
            "sums": {"distinct": int(bits(mask).sum()),
                     "union": int(bits(mask | pair).sum()),
                     "intersect": int(bits(mask & pair).sum()),
                     "except": int(bits(mask & ~pair).sum()),
                     "removed": int((modes != b"MAIL").sum()),
                     "overlap": int(((mask & pair) != 0).sum()),
                     "zipped": int(cnt.sum()),
                     "concat": int(cnt.sum() + 2 * len(cnt))},
            "sets": sorted(sets.items())}


def _flat_rows(lst, order: np.ndarray):
    """(lengths, flat element index) of a collected list column's rows
    taken in ``order`` (``collect_numpy``'s (offsets, values, ...))."""
    off = lst[0]
    lens = np.diff(off)[order]
    idx = np.repeat(off[:-1][order] - (np.cumsum(lens) - lens), lens) \
        + np.arange(int(lens.sum()))
    return lens, idx


def lists18_right(got: dict, om: dict, want: dict) -> bool:
    keys = np.asarray(got["l_orderkey"])
    order = np.argsort(keys, kind="stable")
    if not np.array_equal(keys[order], om["o_orderkey"]):
        return False
    cnt = om["counts"]
    lens, idx = _flat_rows(got["modes"], order)
    if not (np.array_equal(lens, cnt) and np.array_equal(
            np.asarray(got["modes"][1], object)[idx].astype("S7"),
            want["modes"])):
        return False
    lens, idx = _flat_rows(got["lns"], order)
    if not (np.array_equal(lens, cnt) and np.array_equal(
            got["lns"][1][idx], om["linenumber"])):
        return False
    lens, idx = _flat_rows(got["items"], order)
    fields = got["items"][1].table.columns
    if not (np.array_equal(lens, cnt)
            and np.array_equal(fields["l_linenumber"][0][idx],
                               om["linenumber"])
            and np.array_equal(fields["l_quantity"][0][idx],
                               om["l_quantity"])
            and np.array_equal(fields["l_shipmode"][0][idx].astype("S7"),
                               want["modes"])):
        return False
    lens, idx = _flat_rows(got["instr"], order)
    codes = np.searchsorted(np.array(SHIPINSTRUCT, "S17"),
                            np.asarray(got["instr"][1], object)[idx]
                            .astype("S17"))
    wl, wv = _sorted_sets(cnt, np.searchsorted(np.array(SHIPINSTRUCT, "S17"),
                                               want["instr"]))
    gl, gv = _sorted_sets(lens, codes)
    dear = np.asarray(got["dear"], object)[order].astype("S7")
    return np.array_equal(lens, wl) and np.array_equal(gl, wl) \
        and np.array_equal(gv, wv) and np.array_equal(dear, want["dear"])


def gen_order_lists(o: dict, t: dict) -> dict:
    """Phase 16's orders (``gen_nested_orders``) with three list columns,
    every 17th order's NULL and every 19th empty (its ``HOLES``):
    ``o_modes`` (array<string>: the lines' l_shipmode, a dictionary of 7
    values), ``o_comments`` (array<string>: the lines' l_comment, near
    unique, B = 64) and ``o_items`` (array<struct<l_linenumber int,
    l_quantity double, l_shipmode string>>)."""
    from spark_rapids_tpu_torch.columnar import (HostList, HostStruct,
                                                 HostTable)
    n = len(o["o_orderkey"])
    cnt = o["counts"]
    null = np.arange(n) % 17 == 5
    empty = (np.arange(n) % 19 == 7) & ~null
    hcnt = np.where(null | empty, 0, cnt)
    hoff = np.zeros(n + 1, np.int64)
    np.cumsum(hcnt, out=hoff[1:])
    keep = np.repeat(hcnt > 0, cnt)
    order = np.argsort(t["l_orderkey"], kind="stable")
    ln = (np.arange(len(order)) - np.repeat(o["offsets"][:-1], cnt) + 1) \
        .astype(np.int32)
    modes = t["l_shipmode"][order].astype("S7")[keep]
    comments = t["l_comment"][order][keep]
    items = HostStruct(HostTable.from_dict({
        "l_linenumber": ln[keep], "l_quantity": o["l_quantity"][keep],
        "l_shipmode": modes}))
    return {"valid": ~null, "offsets": hoff, "counts": hcnt,
            "modes": modes, "comments": comments, "ln": ln[keep],
            "qty": o["l_quantity"][keep],
            "table": HostTable.from_dict({
                "o_orderkey": o["o_orderkey"],
                "o_modes": (HostList(hoff, modes), ~null),
                "o_comments": (HostList(hoff, comments), ~null),
                "o_items": (HostList(hoff, items), ~null)})}


def q18_modes_by_pos(df, F):
    return df.select(F.posexplode(F.col("o_modes"))).group_by("pos").agg(
        F.count_star().with_name("n")).order_by("pos")


def q18_special(df, F):
    return df.filter(F.exists(F.col("o_comments"),
                              lambda c: c.like("%special%"))).agg(
        F.count_star().with_name("n"))


def q18_items(df, F):
    it = F.col("col")
    return df.select(F.explode(F.col("o_items"))).filter(
        F.get_field(it, "l_quantity") > F.lit(45.0)).agg(
        F.sum(F.get_field(it, "l_linenumber")).with_name("lines"),
        F.sum(F.get_field(it, "l_quantity")).with_name("qty"),
        F.count(F.get_field(it, "l_shipmode")).with_name("modes"),
        F.count_star().with_name("n"))


def orders18_numpy(ol: dict) -> dict:
    cnt, valid = ol["counts"], ol["valid"]
    by_pos = [(p, int((cnt > p).sum())) for p in range(int(cnt.max()))]
    rect, lens = _comment_rect(ol["comments"])
    line = _windows(rect, b"special").any(axis=1)
    starts = ol["offsets"][:-1]
    has = np.zeros(len(cnt), bool)
    nz = cnt > 0
    has[nz] = np.logical_or.reduceat(line, starts[nz])
    big = ol["qty"] > 45.0
    return {"by_pos": by_pos, "special": int((has & valid).sum()),
            "items": {"lines": int(ol["ln"][big].sum()),
                      "qty": float(ol["qty"][big].sum()),
                      "modes": int(big.sum()), "n": int(big.sum())}}


def gen_attr_text(t: dict) -> np.ndarray:
    """Per lineitem row 'ok:<l_orderkey, 7 digits>,mode:<l_shipmode>,
    flag:<l_returnflag>' as an ``S64`` array (near unique, at most 30
    bytes): the key's digits by arithmetic, the rest one of the (mode,
    flag) tails gathered, no per-row loop."""
    n = len(t["l_orderkey"])
    out = np.zeros((n, 64), np.uint8)
    out[:, :3] = np.frombuffer(b"ok:", np.uint8)
    k = t["l_orderkey"].astype(np.int64)
    out[:, 3:10] = (k[:, None] // 10 ** np.arange(6, -1, -1)) % 10 + 48
    modes = sorted(set(t["l_shipmode"].tolist()))
    flags = sorted(set(t["l_returnflag"].tolist()))
    tails = np.array([f",mode:{m},flag:{f}".encode() for m in modes
                      for f in flags], "S24")
    combo = np.searchsorted(modes, t["l_shipmode"]) * len(flags) \
        + np.searchsorted(flags, t["l_returnflag"])
    out[:, 10:34] = tails.view(np.uint8).reshape(len(tails), 24)[combo]
    return out.view("S64").reshape(n)


def q18_attr_modes(df, F):
    m = F.str_to_map(F.col("attrs"))
    return df.select(m.alias("m")).group_by(
        F.element_at(F.col("m"), "mode").alias("mode")).agg(
        F.count_star().with_name("n")).order_by("mode")


def q18_attr_size(df, F):
    return df.select(F.str_to_map(F.col("attrs")).alias("m")).agg(
        F.sum(F.size(F.col("m"))).with_name("entries"))


def q18_sorted(df, F):
    return df.order_by(F.desc("o_orderkey"))


def sorted18_right(got: dict, om: dict, ol: dict) -> bool:
    keys = np.asarray(got["o_orderkey"])
    want_keys = om["o_orderkey"][::-1]
    if not np.array_equal(keys, want_keys):
        return False
    rev = np.arange(len(keys))[::-1]
    cnt = ol["counts"][rev]
    ok = np.array_equal(got["o_modes"][3], ol["valid"][rev])
    for name, want in (("o_modes", ol["modes"]),
                       ("o_comments", ol["comments"])):
        off = got[name][0]
        lens = np.diff(off)
        woff = ol["offsets"]
        idx = np.repeat(woff[:-1][rev] - (np.cumsum(cnt) - cnt), cnt) \
            + np.arange(int(cnt.sum()))
        ok = ok and np.array_equal(lens, cnt) and np.array_equal(
            np.asarray(got[name][1], object).astype(want.dtype),
            want[idx])
    fields = got["o_items"][1].table.columns
    ok = ok and np.array_equal(np.diff(got["o_items"][0]), cnt) \
        and np.array_equal(fields["l_linenumber"][0], ol["ln"][idx]) \
        and np.array_equal(fields["l_quantity"][0], ol["qty"][idx]) \
        and np.array_equal(np.asarray(fields["l_shipmode"][0], object)
                           .astype("S7"), ol["modes"][idx])
    return bool(ok)


def phase_string_lists(card: str, batch_rows: int, table: dict,
                       host) -> dict:
    """Phase 18 (module doc): strings and structs inside lists and maps,
    ``split``, ``str_to_map`` and the host-engine array functions through
    the normal entry points at full size, against numpy."""
    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, HostTable
    from spark_rapids_tpu_torch.columnar.strrect import HostStrings
    from spark_rapids_tpu_torch.types import (INT32, STRING, Schema,
                                              StructField)
    t_phase = time.perf_counter()
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows,
            "spark.rapids.tpu.sql.pallas.enabled": True,
            "spark.rapids.tpu.sql.scanCache.maxBytes": SCAN18_CACHE_BYTES}
    session = TorchSession(conf)
    out = {}

    def runs(label, make, right, collect="collect", s=session):
        for phase in ("cold", "warm"):
            run, rows = _sql_run(s, make, collect)
            _check(right(rows), f"{label} {phase}: {str(rows)[:300]}")
            out[f"{label}_{phase}"] = run
        return rows

    def walls(label):
        return (f"{out[f'{label}_cold']['wall_ms']:.1f} ms cold, "
                f"{out[f'{label}_warm']['wall_ms']:.1f} ms warm")

    def launches(label, kernel):
        return out[f"{label}_warm"]["launches"][kernel]

    n_batches = math.ceil(SF1_ROWS / batch_rows)
    # (a) words of l_comment
    t0 = time.perf_counter()
    want_a = words18_numpy(table["l_comment"])
    comments = host.select(["l_comment"])
    _log(f"phase 18 (a) numpy reference in {time.perf_counter() - t0:.2f} "
         f"s: {want_a}")
    first = ColumnarBatch.from_host(comments.slice(0, batch_rows), "cuda",
                                    64)
    from spark_rapids_tpu_torch.exprs.base import EvalContext
    from spark_rapids_tpu_torch.exprs.compiler import batch_dvals
    ctx = EvalContext(first.schema, batch_dvals(first), first.num_rows,
                      first.padded_len, torch.device("cuda"))
    words = F.split(F.col("l_comment"), " ").expr.eval_device(ctx).data
    wshape = (words.values.width, words.values.col.width)
    wbytes = words.values.nbytes()
    del ctx, words, first
    runs("a", lambda s: q18_words(s.create_dataframe(comments), F),
         lambda r: r == [{k: want_a[k] for k in
                          ("n_words", "special", "furious", "ly")}])
    ka = launches("a", "rect_match")
    _check(ka >= 3 * n_batches, f"(a) rect_match launched {ka} times, "
           f"expected at least {3 * n_batches} (three a batch)")
    runs("a_bytes", lambda s: q18_joined_bytes(
        s.create_dataframe(comments), F),
        lambda r: r == [{"bytes": want_a["bytes"], "rows": SF1_ROWS}])
    kt = launches("a_bytes", "rect_transform")
    _check(kt >= n_batches, f"(a) rect_transform launched {kt} times, "
           f"expected at least {n_batches} (one a batch)")
    one = comments.slice(0, batch_rows)
    want_j = joined18_numpy(table["l_comment"][:batch_rows])

    def right_j(got):
        j = np.asarray(got["j"], object)
        return len(j) == batch_rows and not np.ma.getmaskarray(
            got["j"]).any() and np.array_equal(j.astype("S64"), want_j)
    runs("a_first", lambda s: q18_joined(s.create_dataframe(one), F),
         right_j, "collect_numpy")
    out["a_profile_warm"] = phase_profile(
        session, comments, q18_words,
        lambda r: r[0]["n_words"] == want_a["n_words"],
        f"phase 18 (a) words of l_comment ({card})", "rect_match")
    _log(f"phase 18 (a) split(l_comment, ' ') over {SF1_ROWS} rows in "
         f"{n_batches} batches ({card}): words [P, W, B] = [{batch_rows}, "
         f"{wshape[0]}, {wshape[1]}], {wbytes} device bytes a batch; "
         f"{want_a['n_words']} words, {want_a['special']} rows holding "
         f"'special', {want_a['furious']} a word LIKE 'furious%', "
         f"{want_a['ly']} words LIKE '%ly': equal to numpy; "
         f"{walls('a')}; rect_match launches {ka}; array_join(transform("
         f"upper)) bytes {want_a['bytes']} equal, {walls('a_bytes')}, "
         f"rect_transform launches {kt}; its first batch byte-equal "
         f"({walls('a_first')}); idle "
         f"{out['a_profile_warm'].get('idle_share', float('nan')):.1%}, "
         f"cudaLaunchKernel "
         f"{out['a_profile_warm'].get('host_calls', {}).get('cudaLaunchKernel')}")
    out["a_shape"] = [batch_rows, *wshape]
    out["a_device_bytes"] = wbytes

    # (b) collected orders
    t0 = time.perf_counter()
    om = gen_order_maps(gen_nested_orders(table), table)
    instr = gen_shipinstruct(SF1_ROWS)
    li = host.select(["l_orderkey", "l_quantity", "l_extendedprice",
                      "l_shipmode"])
    li = HostTable({**li.columns,
                    "l_shipmode": (table["l_shipmode"].astype("S7"),
                                   np.ones(SF1_ROWS, bool)),
                    "l_linenumber": (om["row_linenumber"],
                                     np.ones(SF1_ROWS, bool)),
                    "l_shipinstruct": (instr, np.ones(SF1_ROWS, bool))},
                   Schema(list(li.schema.fields)
                          + [StructField("l_linenumber", INT32, True),
                             StructField("l_shipinstruct", STRING, True)]))
    want_b = lists18_numpy(om, table, instr)
    n_orders = len(om["o_orderkey"])
    _log(f"phase 18 (b) data and numpy reference in "
         f"{time.perf_counter() - t0:.2f} s: {n_orders} orders; "
         f"{want_b['sums']}; {len(want_b['sets'])} mode sets")
    runs("b", lambda s: q18_lists(s.create_dataframe(li), F),
         lambda got: lists18_right(got, om, want_b), "collect_numpy")
    runs("b_sums", lambda s: q18_setops(s.create_dataframe(li), F),
         lambda r: r == [want_b["sums"]])
    runs("b_sets", lambda s: q18_mode_sets(s.create_dataframe(li), F),
         lambda r: [(x["modes"], x["n"]) for x in r] == want_b["sets"])
    longest = max(len(k) for k, _ in want_b["sets"])
    out["b_profile_warm"] = phase_profile(
        session, li, q18_lists, lambda got: lists18_right(got, om, want_b),
        f"phase 18 (b) collected orders ({card})", "sort", "collect_numpy")
    _log(f"phase 18 (b) collect_list(l_shipmode), collect_set("
         f"l_shipinstruct), collect_list(struct(l_linenumber, l_quantity, "
         f"l_shipmode)), max_by(l_shipmode, l_extendedprice) by l_orderkey "
         f"({card}): {n_orders} groups equal to numpy (lists in arrival "
         f"order, sets sorted); {walls('b')}; peak "
         f"{out['b_warm']['max_memory_allocated'] / 2**30:.2f} GiB; idle "
         f"{out['b_profile_warm'].get('idle_share', float('nan')):.1%}, "
         f"cudaLaunchKernel "
         f"{out['b_profile_warm'].get('host_calls', {}).get('cudaLaunchKernel')}"
         f"; set operations {want_b['sums']} equal, {walls('b_sums')}; "
         f"group-by on array_join(sort_array(array_distinct(modes))): "
         f"{len(want_b['sets'])} keys, the longest {longest} bytes, equal, "
         f"{walls('b_sets')}")
    out["b_sets"] = len(want_b["sets"])
    out["b_longest_key"] = longest

    # (c) nested orders at ingest
    t0 = time.perf_counter()
    ol = gen_order_lists(om, table)
    orders = ol["table"]
    want_c = orders18_numpy(ol)
    built = [ColumnarBatch.from_host(orders.slice(i, batch_rows), "cuda",
                                     64)
             for i in range(0, n_orders, batch_rows)]
    torch.cuda.synchronize()
    nb = len(built)
    sizes = [{f.name: c.nbytes() for f, c in zip(orders.schema.fields,
                                                 b.columns)} for b in built]
    forms = [repr(c.data) for c in built[0].columns[1:]]
    table_bytes = sum(b.device_size_bytes() for b in built)
    del built
    _log(f"phase 18 (c) orders with o_modes, o_comments and o_items in "
         f"{time.perf_counter() - t0:.2f} s: {n_orders} orders in {nb} "
         f"batches, the lists' elements {forms}, device_size_bytes "
         f"{table_bytes} ({table_bytes / 2**30:.3f} GiB; by column and "
         f"batch {sizes})")
    runs("c_pos", lambda s: q18_modes_by_pos(s.create_dataframe(orders), F),
         lambda r: [(x["pos"], x["n"]) for x in r] == want_c["by_pos"])
    kd = launches("c_pos", "dense_groupby")
    _check(kd == nb, f"(c): dense_groupby launched {kd} times, expected "
           f"{nb} (once a generated batch)")
    runs("c_special", lambda s: q18_special(s.create_dataframe(orders), F),
         lambda r: r == [{"n": want_c["special"]}])
    kc = launches("c_special", "rect_match")
    _check(kc >= nb, f"(c): rect_match launched {kc} times in exists(), "
           f"expected at least {nb}")
    wi = want_c["items"]
    runs("c_items", lambda s: q18_items(s.create_dataframe(orders), F),
         lambda r: len(r) == 1 and r[0]["lines"] == wi["lines"]
         and _rel(r[0]["qty"], wi["qty"]) <= REL_TOL
         and r[0]["modes"] == wi["modes"] and r[0]["n"] == wi["n"])
    _log(f"phase 18 (c) ({card}): posexplode(o_modes) by pos "
         f"{want_c['by_pos']} equal, {walls('c_pos')}, dense_groupby "
         f"launches {kd} over {nb} batches; exists(o_comments, c -> c LIKE "
         f"'%special%') {want_c['special']} orders equal, "
         f"{walls('c_special')}, rect_match launches {kc}; explode(o_items) "
         f"with l_quantity > 45: {wi} equal, {walls('c_items')}")
    out.update(orders=n_orders, device_bytes=table_bytes, batches=nb)

    # (d) attribute maps
    t0 = time.perf_counter()
    attrs = gen_attr_text(table)
    alen = (attrs.view(np.uint8).reshape(SF1_ROWS, -1) != 0).sum(axis=1)
    at = HostTable({"attrs": (HostStrings(attrs, alen.astype(np.int32)),
                              np.ones(SF1_ROWS, bool))},
                   Schema([StructField("attrs", STRING, True)]))
    modes, counts = np.unique(table["l_shipmode"], return_counts=True)
    want_d = [(str(m), int(c)) for m, c in zip(modes, counts)]
    _log(f"phase 18 (d) attribute text in {time.perf_counter() - t0:.2f} s: "
         f"at most {int(alen.max())} bytes, e.g. {attrs[0]!r}")
    runs("d", lambda s: q18_attr_modes(s.create_dataframe(at), F),
         lambda r: [(x["mode"], x["n"]) for x in r] == want_d)
    runs("d_size", lambda s: q18_attr_size(s.create_dataframe(at), F),
         lambda r: r == [{"entries": 3 * SF1_ROWS}])
    kd2 = launches("d", "rect_match")
    _log(f"phase 18 (d) str_to_map of {SF1_ROWS} texts ({card}): "
         f"group_by(element_at(m, 'mode')) {want_d} equal, {walls('d')}, "
         f"rect_match launches {kd2}; sum(size(m)) {3 * SF1_ROWS} equal, "
         f"{walls('d_size')}")
    del at, attrs

    # (e) the orders' lists out of core
    s_ooc = TorchSession({**conf, "spark.rapids.tpu.sql.batchSizeBytes":
                          NESTED18_SORT_BYTES})
    runs("e", lambda s: q18_sorted(s.create_dataframe(orders), F),
         lambda got: sorted18_right(got, om, ol), "collect_numpy", s=s_ooc)
    sort = _find_exec(s_ooc.last_plan, "TpuSortExec")
    out["e_buckets"] = getattr(sort, "last_buckets", None)
    ke = launches("e", "sort_bucket")
    _check(ke >= 1, f"(e): sort_bucket launched {ke} times, expected at "
           "least one (the sort goes out of core)")
    _log(f"phase 18 (e) ORDER BY o_orderkey DESC of {n_orders} orders "
         f"carrying o_modes, o_comments and o_items at batchSizeBytes "
         f"{NESTED18_SORT_BYTES} ({card}): {out['e_buckets']} buckets, "
         f"sort_bucket launches {ke}; every row's lists equal numpy's; "
         f"{walls('e')}; peak "
         f"{out['e_warm']['max_memory_allocated'] / 2**30:.2f} GiB")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"phase 18 (strings and structs in lists and maps) took "
         f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: decimals -- DecimalType as scaled int64 lanes through ingest,
# Parquet, arithmetic, comparisons, casts, keys and exact SUM/AVG, and the
# decimal_arith kernel
# ---------------------------------------------------------------------------

#: lineitem's quantity and money columns, decimal(15,2) as Spark's TPC-H
#: schema types them
DEC_LINEITEM = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
#: store_sales' money columns, decimal(7,2) as TPC-DS types them
DEC_STORE_SALES = ("ss_ext_sales_price", "ss_net_paid")
#: the decimal_arith kernel phase's rows a function
DA_ROWS = 1 << 20
#: phase 19 (c)'s batchSizeBytes: the default, as phase 14's ORDER BY
DEC_SORT_BYTES = 512 << 20
#: 32-bit integer multiply-adds a row at least (the kernel's bound from
#: operations): a 64 by 64 bit product into 128 bits is four 32 by 32 bit
#: products, each a low and a high multiply-add (the remainder's product
#: of two residues too); add scales one side by 10^6, a 64 by 32 bit
#: product; rescale and the cast to double need no product of two
#: operands
DA_MIN_OPS = {"mul": 8, "div": 8, "avg": 8, "rescale": 0, "to_double": 0,
              "add": 4, "rem": 8}


class DecCol:
    """A decimal column for the script's Parquet writer and its host
    tables: unscaled int64 values at (precision, scale)."""

    def __init__(self, unscaled: np.ndarray, precision: int, scale: int):
        self.unscaled = np.asarray(unscaled, np.int64)
        self.precision = precision
        self.scale = scale

    def slice(self, lo: int, hi: int) -> "DecCol":
        return DecCol(self.unscaled[lo:hi], self.precision, self.scale)


def unscaled_cents(x: np.ndarray) -> np.ndarray:
    """Two-decimal doubles (``np.round(v, 2)``) as unscaled int64 cents."""
    return np.round(np.asarray(x) * 100.0).astype(np.int64)


def decimal_host(t: dict, names, decimals, precision: int):
    """A HostTable of ``names`` from ``t``, the ``decimals`` among them as
    decimal(precision, 2) of their unscaled cents."""
    from spark_rapids_tpu_torch.columnar import HostTable
    from spark_rapids_tpu_torch.types import DecimalType, Schema, StructField
    plain = HostTable.from_dict({n: t[n] for n in names
                                 if n not in decimals})
    cols, fields = {}, []
    for n in names:
        if n in decimals:
            u = unscaled_cents(t[n])
            cols[n] = (u, np.ones(len(u), bool))
            fields.append(StructField(n, DecimalType(precision, 2), True))
        else:
            cols[n] = plain.columns[n]
            fields.append(plain.schema[n])
    return HostTable(cols, Schema(fields))


def _half_up(n: int, d: int) -> int:
    q, r = divmod(n, d)
    return q + (2 * r >= d)


def spark_avg(total: int, count: int, p: int, s: int):
    """Spark's avg of a decimal(p, s) whose unscaled values sum to
    ``total`` over ``count`` rows: its Divide of the sum, typed
    decimal(min(p + 10, 38), s), by the count as decimal(20,0) (rounded at
    scale 38, then at the division's scale), cast HALF_UP to
    decimal(p + 4, s + 4); a Decimal."""
    sp = min(p + 10, 38)
    scale = max(6, s + 21)
    prec = sp - s + scale
    if prec > 38:
        scale = max(38 - (prec - scale), min(scale, 6))
    q = _half_up(abs(total) * 10 ** (38 - s), count)
    q = _half_up(q, 10 ** (38 - scale))
    out_s = min(s + 4, 38)
    q = _half_up(q, 10 ** (scale - out_s))
    return decimal.Decimal(-q if total < 0 else q).scaleb(-out_s)


def decimal_cents(u) -> "object":
    return decimal.Decimal(int(u)).scaleb(-2)


def q1_decimal_numpy(t: dict) -> tuple:
    """TPC-H Q1's rows over decimal(15,2) lineitem, (the DataFrame form's,
    the SQL text's): the decimal sums and averages exact from the
    unscaled int64 (Spark's types and rounding); the DataFrame form's
    disc_price and charge are doubles (its ``F.lit(1.0)``), as q1_numpy
    computes them; SQL's ``1 - l_discount`` stays decimal, so its two are
    exact at scales 4 and 6."""
    want = q1_numpy(t)
    keep = t["l_shipdate"] <= (np.datetime64("1998-12-01")
                               - np.timedelta64(90, "D"))
    flag, status = t["l_returnflag"][keep], t["l_linestatus"][keep]
    u = {c: unscaled_cents(t[c][keep]) for c in DEC_LINEITEM}
    disc_price = u["l_extendedprice"] * (100 - u["l_discount"])
    charge = disc_price * (100 + u["l_tax"])
    rows, sql = [], []
    for w in want:
        g = (flag == w["l_returnflag"]) & (status == w["l_linestatus"])
        n = int(g.sum())
        sq, sp = int(u["l_quantity"][g].sum()), \
            int(u["l_extendedprice"][g].sum())
        r = dict(w)
        r.update(sum_qty=decimal_cents(sq),
                 sum_base_price=decimal_cents(sp),
                 avg_qty=spark_avg(sq, n, 15, 2),
                 avg_price=spark_avg(sp, n, 15, 2),
                 avg_disc=spark_avg(int(u["l_discount"][g].sum()), n, 15, 2))
        rows.append(r)
        sql.append({**r, "sum_disc_price": decimal.Decimal(int(
            disc_price[g].sum())).scaleb(-4), "sum_charge": decimal.Decimal(
                int(charge[g].sum())).scaleb(-6)})
    return rows, sql


def q6_decimal_numpy(t: dict):
    """TPC-H Q6's revenue over decimal(15,2) lineitem, exact: the
    discount's bounds compare as doubles and the quantity's as a decimal
    (both equal the unscaled comparisons here)."""
    sd = t["l_shipdate"]
    d, q = unscaled_cents(t["l_discount"]), unscaled_cents(t["l_quantity"])
    keep = ((sd >= np.datetime64("1994-01-01"))
            & (sd < np.datetime64("1995-01-01")) & (d >= 5) & (d <= 7)
            & (q < 2400))
    p = unscaled_cents(t["l_extendedprice"])
    return decimal.Decimal(int((p[keep] * d[keep]).sum())).scaleb(-4)


def q3_decimal_numpy(ss: dict, dd: dict, it: dict,
                     manufact_id: int = 128) -> list:
    """q3's rows with ss_ext_sales_price as decimal(7,2): each group's sum
    exact from the unscaled cents (q3_numpy's groups and order)."""
    year = np.full(len(dd["d_date_sk"]), -1, np.int64)
    nov = dd["d_moy"] == 11
    year[dd["d_date_sk"][nov]] = dd["d_year"][nov]
    item = np.full(len(it["i_item_sk"]), -1, np.int64)
    sel = it["i_manufact_id"] == manufact_id
    item[it["i_item_sk"][sel]] = np.flatnonzero(sel)
    y = year[ss["ss_sold_date_sk"]]
    i = item[ss["ss_item_sk"]]
    keep = (y >= 0) & (i >= 0)
    y, i = y[keep], i[keep]
    p = unscaled_cents(ss["ss_ext_sales_price"][keep])
    bid = it["i_brand_id"].astype(np.int64)
    _, bcode = np.unique(it["i_brand"].astype(str), return_inverse=True)
    code = (y * 61 + bid[i]) * len(BRANDS) + bcode[i]
    groups, gid = np.unique(code, return_inverse=True)
    sums = np.zeros(len(groups), np.int64)
    np.add.at(sums, gid, p)
    first = np.zeros(len(groups), np.int64)
    first[gid[::-1]] = np.arange(len(gid))[::-1]
    rows = [{"d_year": int(y[f]), "i_brand_id": int(bid[i[f]]),
             "i_brand": str(it["i_brand"][i[f]]),
             "sum_agg": decimal_cents(s)}
            for f, s in zip(first, sums)]
    rows.sort(key=lambda r: (r["d_year"], -r["sum_agg"], r["i_brand_id"]))
    return rows


def _da_inputs(rng, n: int, which: str):
    """One decimal_arith function's operands on the card (module doc of
    phase 19 (d)): (operands, validity, second validity or None, k, t, m,
    p, bytes a row)."""
    import torch

    def dev(a, dt=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
    valid = dev(rng.rand(n) > 0.02, torch.bool)
    if which == "to_double_q1":
        # q1's cast of decimal(15,2) l_extendedprice to double: cents
        # below 2^53, s = 2, every row on the one-division path
        return ([dev(rng.randint(90000, 10500001, n))], valid, None, 2, 0,
                0, 15, 18)
    if which in ("mul", "rescale", "to_double"):
        # q1's decimal(15,2) price and decimal(16,2) (1 - discount)
        price = rng.randint(90000, 10500001, n)
        one_minus = 100 - rng.randint(0, 11, n)
        if which == "mul":
            return ([dev(price), dev(one_minus)], valid,
                    dev(rng.rand(n) > 0.02, torch.bool), 0, 0, 0, 32, 27)
        if which == "rescale":      # the product to scale 2, HALF_UP
            return ([dev(price * one_minus)], valid, None, -2, 0, 0, 32, 18)
        # decimal(38,10) values past 2^53 (the exact slow path) among
        # q1's prices
        x = np.where(rng.rand(n) < 0.5, price,
                     rng.randint(-2**62, 2**62, n, dtype=np.int64))
        return [dev(x)], valid, None, 10, 0, 0, 38, 18
    if which in ("add", "rem"):
        # decimal(38,0) + decimal(38,10) -> decimal(38,6), and % ->
        # decimal(38,10): the left side rescaled 10 digits (past int64
        # for most rows), the sum 4 digits lower; results past int64 and,
        # for %, zero divisors among them
        l = np.where(rng.rand(n) < 0.5, rng.randint(-10**12, 10**12, n),
                     rng.randint(-2**62, 2**62, n, dtype=np.int64))
        r = rng.randint(-2**62, 2**62, n, dtype=np.int64)
        r[rng.rand(n) < 0.01] = 0
        return ([dev(l), dev(r)], valid, dev(rng.rand(n) > 0.02,
                                              torch.bool), 10, 0,
                4 if which == "add" else 0, 38, 27)
    if which == "div":
        # decimal(38,10) / decimal(18,4) -> decimal(38,6): e = 6 + 4 - 10,
        # t = 38 - 6; zero divisors and overflows among them
        l = rng.randint(-2**62, 2**62, n, dtype=np.int64)
        r = rng.randint(-10**8, 10**8, n)
        r[rng.rand(n) < 0.01] = 0
        r[rng.rand(n) < 0.01] = 1
        return ([dev(l), dev(r)], valid, dev(rng.rand(n) > 0.02,
                                              torch.bool), 0, 32, 0, 38, 27)
    # avg of decimal(15,2): limbs of group totals of up to 2^20 rows,
    # the counts, e = 15 - 2, t = 38 - 15, m = 15 - 6, precision 19
    tot = rng.randint(-10**13, 10**13, n).astype(object) * \
        rng.randint(1, 1 << 20, n).astype(object)
    L = 10 ** 12
    l0 = np.array([t % L for t in tot], np.int64)
    l1 = np.array([(t // L) % L for t in tot], np.int64)
    l2 = np.array([t // L // L for t in tot], np.int64)
    cnt = rng.randint(1, 1 << 20, n)
    return ([dev(l0), dev(l1), dev(l2), dev(cnt)], valid, None, 13, 23, 9,
            19, 42)


#: the functions phase 19 (d) times at DA_ROWS rows (_da_inputs);
#: "to_double_q1" is to_double at q1's own shape
DA_TIMED = ("mul", "div", "rescale", "avg", "to_double", "add", "rem",
            "to_double_q1")
#: the launch constants' boundaries held bit for bit on edge rows: where a
#: power of ten passes one limb (10^19 < 2^64 < 10^20) and where a double
#: stops holding it exactly (10^22)
DA_BOUNDS = (0, 19, 20, 22, 23, 38)
#: operands whose every pair phase 19 (d)'s edge rows take
DA_EDGE = (0, 1, -1, 5, -5, 99, 10 ** 9, -10 ** 18, 2 ** 63 - 1, -2 ** 63,
           -2 ** 63 + 1, 2 ** 53 + 1, -(2 ** 53), 123456789012345, 10 ** 18,
           7)


def _da_edge_cases():
    """(function, k, t, m, p) of phase 19 (d)'s edge rows: every function
    at each of DA_BOUNDS (both signs where the constant may be negative),
    avg with m of 0 and 32 and add/sub with m of 0 and 32, at precisions
    38 and 15."""
    cases = []
    for p in (38, 15):
        cases += [("mul", k, 0, 0, p) for k in DA_BOUNDS + (-19, -20, -38)]
        cases += [("rescale", k, 0, 0, p)
                  for k in DA_BOUNDS + (-19, -20, -22, -23, -38)]
        cases += [("div", e, 32, 0, p) for e in DA_BOUNDS + (-19, -20, -38)]
        cases += [("avg", e, 20, m, p) for e in DA_BOUNDS for m in (0, 32)]
        cases += [("add", k, 0, m, p) for k in DA_BOUNDS for m in (0, 32)]
        cases += [("sub", 0, k, m, p) for k in DA_BOUNDS for m in (0, 32)]
        cases += [("rem", k, 0, 0, p) for k in DA_BOUNDS]
        cases += [("rem", 0, k, 0, p) for k in DA_BOUNDS]
    cases += [("to_double", s, 0, 0, 38) for s in DA_BOUNDS]
    return cases


def _da_edge_rows(rng, op: str):
    """Edge operands of ``op`` as numpy columns: every pair of DA_EDGE and
    61 random rows (an odd row count: a partial last group); avg
    takes limbs at their ends and counts of 1 to INT64_MAX."""
    if op == "avg":
        L = 10 ** 12
        rows = [(l0, l1, l2, c) for l0 in (0, 1, L - 1) for l1 in (0, L - 1)
                for l2 in (0, -1, 7, 2 ** 40 - 1, -(2 ** 40 - 1), 2 ** 40)
                for c in (1, 3, 7, 0, 2 ** 63 - 1)]
        rows += [(rng.randint(0, L), rng.randint(0, L),
                  rng.randint(-2 ** 40 + 1, 2 ** 40), rng.randint(1, 2 ** 62))
                 for _ in range(61)]
        return [np.array(c, np.int64) for c in zip(*rows)]
    a = [x for x in DA_EDGE for _ in DA_EDGE]
    b = [y for _ in DA_EDGE for y in DA_EDGE]
    a += rng.randint(-2 ** 63, 2 ** 63 - 1, 61, dtype=np.int64).tolist()
    b += rng.randint(-10 ** 9, 10 ** 9, 61).tolist()
    cols = [np.array(a, np.int64), np.array(b, np.int64)]
    return cols[:1] if op in ("rescale", "to_double") else cols


def phase_decimal_edges() -> int:
    """decimal_arith bit for bit against its plain version on edge rows
    (_da_edge_cases, _da_edge_rows, 2% of each validity false), each case
    twice: from aligned vectors (the vector instance, its last partial
    group a row a thread) and from views one int64 into larger
    vectors (not 16-byte aligned: the scalar instance). Returns the
    cases held."""
    import torch
    from spark_rapids_tpu_torch.exprs import decimal_arith as DA
    rng = np.random.RandomState(1919)
    cases = _da_edge_cases()
    for op, k, t, m, p in cases:
        cols = _da_edge_rows(rng, op)
        n = len(cols[0])
        vals = [rng.rand(n) > 0.02 for _ in range(2)]
        two = DA._ARITY[op] == 2
        want, wok = DA.decimal_arith_reference(
            op, [torch.from_numpy(c).cuda() for c in cols],
            torch.from_numpy(vals[0] & vals[1] if two else vals[0]).cuda(),
            k, t, m, p)
        for shift in (0, 1):
            def put(x, dt):
                buf = torch.zeros(n + shift, dtype=dt, device="cuda")
                buf[shift:] = torch.from_numpy(x).to("cuda", dt)
                return buf[shift:]
            ops = [put(c, torch.int64) for c in cols]
            got, ok = DA.decimal_arith(
                op, ops, put(vals[0], torch.bool),
                put(vals[1], torch.bool) if two else None, k, t, m, p)
            torch.cuda.synchronize()
            bad = (got != want) | (ok != wok)
            if bool(bad.any()):
                r = torch.nonzero(bad)[:4, 0].tolist()
                _log(f"decimal_arith {op} k={k} t={t} m={m} p={p} "
                     f"shift={shift}: rows {r}: operands "
                     f"{[[int(c[i]) for c in cols] for i in r]}, kernel "
                     f"{[(int(got[i]), bool(ok[i])) for i in r]}, plain "
                     f"{[(int(want[i]), bool(wok[i])) for i in r]}")
            _check(not bool(bad.any()),
                   f"decimal_arith {op} (k={k}, t={t}, m={m}, p={p}, "
                   f"view shift {shift}): {int(bad.sum())} edge rows differ "
                   "from the plain version")
    return len(cases)


def _sass_calls(lib_path) -> dict:
    """cuobjdump -sass of a built library, kernel by kernel: the
    subroutines each calls and its I2F conversions rounded toward +inf
    (.RP, the mark of an inlined integer division)."""
    from spark_rapids_tpu_torch import native
    tool = Path(native._nvcc()).with_name("cuobjdump")
    _check(tool.exists(), f"no cuobjdump beside nvcc ({tool})")
    proc = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    _check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[:400]}")
    out, fn = {}, None
    for ln in proc.stdout.splitlines():
        mf = re.search(r"Function : (\S+)", ln)
        if mf:
            fn = mf.group(1)
            out[fn] = {"calls": set(), "rp": 0, "instructions": 0}
            continue
        if fn is None or not re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            continue
        out[fn]["instructions"] += 1
        mc = re.search(r"CALL\S*\s+`?\(?([^`)\s;]+)", ln)
        if mc:
            out[fn]["calls"].add(mc.group(1))
        if re.search(r"I2F\S*\.RP\b", ln):
            out[fn]["rp"] += 1
    return out


def _integer_division_calls(sass: dict) -> dict:
    """{kernel: [subroutines that divide integers]}: a name with div or
    rem that is not a float routine (f32, f64, rcp), or any .RP
    conversion."""
    bad = {}
    for fn, info in sass.items():
        names = [c for c in info["calls"]
                 if re.search(r"div|rem", c, re.I)
                 and not re.search(r"f32|f64|rcp", c, re.I)]
        if names or info["rp"]:
            bad[fn] = names + ([f"{info['rp']} I2F .RP"] if info["rp"]
                               else [])
    return bad


def phase_decimal_sass(compare) -> dict:
    """The built decimal_arith library's SASS (and each version to
    compare, recorded only): no kernel of the port's may call an integer
    division routine or inline one."""
    from spark_rapids_tpu_torch import native
    sass = _sass_calls(native.library_path("decimal_arith"))
    kernels = {fn: v for fn, v in sass.items() if "decimal_arith" in fn}
    _check(len(kernels) == 16, f"decimal_arith SASS: {len(kernels)} kernels, "
                               "expected 16 (8 functions, 2 instances)")
    bad = _integer_division_calls(kernels)
    calls = sorted({c for v in kernels.values() for c in v["calls"]})
    _log(f"decimal_arith SASS (cuobjdump -sass): {len(kernels)} kernels, "
         f"{sum(v['instructions'] for v in kernels.values())} instructions; "
         f"subroutines called: {calls or 'none'}; integer division: "
         f"{bad or 'none'}")
    _check(not bad, f"decimal_arith kernels divide integers in software: "
                    f"{bad}")
    out = {"kernels": len(kernels), "calls": calls,
           "instructions": {fn: v["instructions"]
                            for fn, v in kernels.items()}}
    for name, f in (compare or {}).items():
        theirs = _sass_calls(f.library)
        theirs = {fn: v for fn, v in theirs.items() if "decimal_arith" in fn}
        out[name] = {"calls": sorted({c for v in theirs.values()
                                      for c in v["calls"]}),
                     "integer_division": {fn: v for fn, v in
                                          _integer_division_calls(
                                              theirs).items()}}
        _log(f"decimal_arith SASS of {name}: subroutines called "
             f"{out[name]['calls'] or 'none'}; integer division in "
             f"{len(out[name]['integer_division'])} of {len(theirs)} "
             "kernels")
    return out


def phase_decimal_kernel(card: str, compare=None) -> dict:
    """Phase 19 (d): decimal_arith on the card against its plain version,
    bit for bit, on DA_ROWS rows of each function of DA_TIMED (and each
    version of ``compare``, name -> launch), then timed with the L2 cold
    in turns with those versions (kernel, others, others, kernel, kernel,
    others) beside its bound and the plain version's time; to_double at
    q1's shape beside torch's cast and divide (the same function on its
    domain). Then the edge rows (phase_decimal_edges) and the SASS
    (phase_decimal_sass)."""
    import torch
    from spark_rapids_tpu_torch.exprs import decimal_arith as DA
    compare = compare or {}
    rng = np.random.RandomState(19)
    out = {}
    for which in DA_TIMED:
        op = "to_double" if which == "to_double_q1" else which
        ops, valid, valid2, k, t, m, p, row_bytes = _da_inputs(
            rng, DA_ROWS, which)
        n_ops = len(ops)
        ops = ops + [valid] + ([valid2] if valid2 is not None else [])

        def kern(*x, op=op, n_ops=n_ops, k=k, t=t, m=m, p=p):
            return DA.decimal_arith(op, x[:n_ops], x[n_ops],
                                    x[n_ops + 1] if len(x) > n_ops + 1
                                    else None, k, t, m, p)

        def plain(*x, op=op, n_ops=n_ops, k=k, t=t, m=m, p=p):
            both = x[n_ops] if len(x) == n_ops + 1 \
                else x[n_ops] & x[n_ops + 1]
            return DA.decimal_arith_reference(op, x[:n_ops], both, k, t,
                                              m, p)

        def other(f, op=op, n_ops=n_ops, k=k, t=t, m=m, p=p):
            return lambda *x: f(op, x[:n_ops], x[n_ops],
                                x[n_ops + 1] if len(x) > n_ops + 1
                                else None, k, t, m, p)
        want, wok = plain(*ops)
        versions = [("kernel", kern)] + [(c, other(f))
                                         for c, f in compare.items()]
        for who, f in versions:
            got, ok = f(*ops)
            torch.cuda.synchronize()
            _check(torch.equal(ok, wok), f"decimal_arith {which} ({who}): "
                   f"validity differs from the plain version in "
                   f"{int((ok != wok).sum())} rows")
            diff = int((got != want).sum())
            if diff:
                rows = torch.nonzero(got != want)[:5, 0].tolist()
                _log(f"decimal_arith {which} ({who}): rows {rows}: operands "
                     f"{[[int(o[r]) for o in ops[:n_ops]] for r in rows]}, "
                     f"kernel {[int(got[r]) for r in rows]}, plain "
                     f"{[int(want[r]) for r in rows]}")
            _check(diff == 0, f"decimal_arith {which} ({who}): {diff} "
                   "results differ from the plain version's bits")
        n_copies = max(2, -(-COLD_BYTES // (row_bytes * DA_ROWS)))
        inputs = [tuple(ops)] + [tuple(o.clone() for o in ops)
                                 for _ in range(n_copies - 1)]
        turns = {who: [] for who, _ in versions}
        hosts = []
        for who, f in versions + versions[::-1] + versions:
            ms, host = _cold_ms(f, inputs, f"decimal_arith {which} {who}")
            turns[who].append(ms)
            if who == "kernel":
                hosts.append(host)
        ms = float(np.mean(turns["kernel"]))
        plain_ms = _plain_ms(plain, inputs[:2], f"plain {which}")
        library_ms = None
        if valid2 is not None and which == "mul":
            # the two validities' AND the wrapper no longer launches on the
            # card (its plain version alone takes it)
            and_ms, and_host = _cold_ms(lambda *x: x[n_ops] & x[n_ops + 1],
                                        inputs, "validity AND")
        if which == "to_double_q1":
            # torch's exact cast and one IEEE division by 10^s: the same
            # function where every |x| < 2^53 and s <= 22 (validity aside)
            scale = torch.full((), 10.0 ** k, dtype=torch.float64,
                               device="cuda")

            def library(*x):
                return x[0].to(torch.float64).div(scale)
            lib = library(*ops)
            _check(torch.equal(lib.view(torch.int64)[wok], want[wok]),
                   "to_double at q1's shape differs from torch's cast and "
                   "divide")
            library_ms, _ = _cold_ms(library, inputs,
                                     "to_double q1 cast and divide")
        bytes_ms = row_bytes * DA_ROWS / HBM_BYTES_PER_S * 1e3
        ops_ms = DA_MIN_OPS[op] * DA_ROWS / SCALAR_OPS_PER_S * 1e3
        out[which] = {"ms": ms, "host_ms": float(np.mean(hosts)),
                      "turns_ms": turns,
                      "compare_ms": {c: float(np.mean(turns[c]))
                                     for c in compare},
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms
                      else "operations",
                      "bound_bytes": row_bytes * DA_ROWS,
                      "valid_rows": int(wok.sum()), "max_abs_err": 0,
                      "k": k, "t": t, "m": m, "p": p}
        row = out[which]
        if which == "mul":
            row.update(and_ms=and_ms, and_host_ms=and_host)
            _log(f"the two validities' AND the wrapper no longer launches: "
                 f"{and_ms:.4f} ms of device time, {and_host:.4f} ms of host "
                 "time a call")
        others = "".join(
            f"; {c} {row['compare_ms'][c]:.4f} ms (turns "
            f"{', '.join(f'{x:.4f}' for x in turns[c])}, "
            f"{row['bound_ms'] / row['compare_ms'][c]:.0%} of bound)"
            for c in compare)
        lib_txt = "" if library_ms is None else \
            f", torch cast and divide {library_ms:.4f} ms"
        _log(f"decimal_arith {which} ({card}): {DA_ROWS} rows bit-equal to "
             f"the plain version ({row['valid_rows']} valid); "
             f"{ms:.4f} ms a launch (L2 cold; turns "
             f"{', '.join(f'{x:.4f}' for x in turns['kernel'])}), "
             f"{row['bound_ms'] / ms:.0%} of bound {row['bound_ms']:.4f} "
             f"ms ({row['bound_by']}, {row_bytes} bytes a row at "
             f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s){others}{lib_txt}; plain "
             f"{plain_ms:.2f} ms, host {row['host_ms']:.4f} ms a call")
        del ops, inputs
    out["edge_cases"] = phase_decimal_edges()
    _log(f"decimal_arith ({card}): {out['edge_cases']} edge cases bit-equal "
         "to the plain version, aligned and from unaligned views")
    out["sass"] = phase_decimal_sass(compare)
    out["describe"] = DA.describe()
    _log(f"decimal_arith registers (vector / scalar instances): "
         f"{out['describe']}")
    out["max_abs_err"] = 0         # every check above is bit for bit
    return out


def phase_decimals(card: str, batch_rows: int, table: dict,
                   ds19: dict, compare=None) -> dict:
    """Phase 19 (module doc): decimals through the normal entry points at
    full TPC scale, exact against numpy, and the decimal_arith kernel
    (``compare``: name -> another build's launch, timed in turns)."""
    import shutil
    import tempfile

    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    t_phase = time.perf_counter()
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows}
    session = TorchSession(conf)
    out = {}

    def runs(label, make, right, collect="collect", s=session,
             phases=("cold", "warm")):
        for phase in phases:
            out[f"{label}_{phase}"], got = _sql_run(s, make, collect)
            _check(right(got), f"phase 19 {label} {phase}: wrong result "
                               f"{str(got)[:400]}")
        return got

    def launches(label, kernel):
        return out[f"{label}_cold"]["launches"][kernel]

    def walls(label):
        return (f"wall {out[label + '_cold']['wall_ms']:.1f} ms cold, "
                f"{out[label + '_warm']['wall_ms']:.1f} ms warm")

    # (a) TPC-H q1 and q6 at SF1 over decimal(15,2) lineitem: in memory,
    # over Parquet (INT64 with the DECIMAL type) and as SQL
    t0 = time.perf_counter()
    names = ("l_returnflag", "l_linestatus", "l_shipdate") + DEC_LINEITEM
    li = decimal_host(table, names, DEC_LINEITEM, 15)
    want1, want1_sql = q1_decimal_numpy(table)
    want6 = q6_decimal_numpy(table)
    _log(f"phase 19 (a) data and numpy reference in "
         f"{time.perf_counter() - t0:.2f} s")
    n_batches = math.ceil(SF1_ROWS / batch_rows)

    def q1_right(got, want=want1):
        return _rows_close(got, want, REL_TOL)

    runs("q1", lambda s: q1(s.create_dataframe(li), F), q1_right)
    runs("q6", lambda s: q6(s.create_dataframe(li), F),
         lambda got: _rows_close(got, [{"revenue": want6}], 0.0))
    for label in ("q1", "q6"):
        _check(launches(label, "decimal_arith") >= 1,
               f"phase 19 {label}: decimal_arith never launched")
    _check(launches("q1", "dense_groupby") == n_batches,
           f"phase 19 q1 launched dense_groupby "
           f"{launches('q1', 'dense_groupby')} times, expected {n_batches}")
    for label in ("q1", "q6"):
        _log(f"phase 19 (a) {label} over decimal(15,2) lineitem SF1 "
             f"({card}): equal to numpy (decimal totals and averages "
             f"exact); {walls(label)}; dense_groupby launches "
             f"{launches(label, 'dense_groupby')}, decimal_arith launches "
             f"{launches(label, 'decimal_arith')}")
    pq_dir = Path(tempfile.mkdtemp(prefix="decimals_", dir=str(
        Path(__file__).resolve().parent / "build")))
    t0 = time.perf_counter()
    cols = {n: (DecCol(unscaled_cents(table[n]), 15, 2)
                if n in DEC_LINEITEM else table[n]) for n in names}
    files = []
    for i in range(n_batches):
        lo, hi = i * batch_rows, min((i + 1) * batch_rows, SF1_ROWS)
        f = pq_dir / f"lineitem_{i}.parquet"
        write_parquet(str(f), {n: (c.slice(lo, hi) if isinstance(c, DecCol)
                                   else c[lo:hi]) for n, c in cols.items()},
                      batch_rows)
        files.append(str(f))
    _log(f"phase 19 (a) {len(files)} Parquet files of decimal(15,2) "
         f"lineitem (INT64, DECIMAL) in {time.perf_counter() - t0:.2f} s")
    runs("q1_parquet", lambda s: q1(s.read_parquet(*files), F), q1_right)
    runs("q6_parquet", lambda s: q6(s.read_parquet(*files), F),
         lambda got: _rows_close(got, [{"revenue": want6}], 0.0))
    session.create_dataframe(li).create_or_replace_temp_view("lineitem")
    runs("q1_sql", lambda s: s.sql(TPCH_Q1),
         lambda got: q1_right(got, want1_sql))
    runs("q6_sql", lambda s: s.sql(TPCH_Q6),
         lambda got: _rows_close(got, [{"revenue": want6}], 0.0))
    for label in ("q1_parquet", "q6_parquet", "q1_sql", "q6_sql"):
        _check(launches(label, "decimal_arith") >= 1,
               f"phase 19 {label}: decimal_arith never launched")
        _log(f"phase 19 (a) {label} ({card}): equal to numpy; "
             f"{walls(label)}; dense_groupby launches "
             f"{launches(label, 'dense_groupby')}, decimal_arith launches "
             f"{launches(label, 'decimal_arith')}")
    _check(launches("q1_sql", "dense_groupby") == n_batches,
           "phase 19 SQL q1 did not take the dense route once a batch "
           "(seven decimal aggregates at two limbs: 14 columns)")
    del li

    # (b) TPC-DS q3 at SF10 over decimal(7,2) ss_ext_sales_price, in
    # memory and over Parquet (INT32 with the DECIMAL type)
    t0 = time.perf_counter()
    ss, dd, it = ds19["ss"], ds19["dd"], ds19["it"]
    ss_names = ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price")
    ss_host = decimal_host(ss, ss_names, DEC_STORE_SALES, 7)
    from spark_rapids_tpu_torch.columnar import HostTable
    dd_host, it_host = HostTable.from_dict(dd), HostTable.from_dict(it)
    want3 = q3_decimal_numpy(ss, dd, it)
    _log(f"phase 19 (b) data and numpy reference in "
         f"{time.perf_counter() - t0:.2f} s")

    def q3_make(src):
        return lambda s: q3(src(s), s.create_dataframe(dd_host),
                            s.create_dataframe(it_host), F)
    runs("q3", q3_make(lambda s: s.create_dataframe(ss_host)),
         lambda got: _rows_close(got, want3, 0.0))
    t0 = time.perf_counter()
    ss_file = pq_dir / "store_sales.parquet"
    write_parquet(str(ss_file), {
        "ss_sold_date_sk": ss["ss_sold_date_sk"],
        "ss_item_sk": ss["ss_item_sk"],
        "ss_ext_sales_price": DecCol(unscaled_cents(
            ss["ss_ext_sales_price"]), 7, 2)}, batch_rows)
    _log(f"phase 19 (b) store_sales as Parquet (decimal(7,2) as INT32) in "
         f"{time.perf_counter() - t0:.2f} s")
    runs("q3_parquet", q3_make(lambda s: s.read_parquet(str(ss_file))),
         lambda got: _rows_close(got, want3, 0.0))
    for label in ("q3", "q3_parquet"):
        _check(launches(label, "join_match") >= 1,
               f"phase 19 {label}: join_match never launched")
        _log(f"phase 19 (b) {label} SF10 over decimal(7,2) ({card}): "
             f"{len(want3)} rows equal to numpy (sum_agg exact); "
             f"{walls(label)}; join_match launches "
             f"{launches(label, 'join_match')}, dense_groupby launches "
             f"{launches(label, 'dense_groupby')}")
    del ss_host

    # (c) the out-of-core ORDER BY of phase 14 keyed on ss_net_paid
    # decimal(7,2) DESC
    t0 = time.perf_counter()
    sort_names = ("ss_net_paid", "ss_item_sk", "ss_sold_date_sk",
                  "ss_ext_sales_price")
    sort_host = decimal_host(ss, sort_names, DEC_STORE_SALES, 7)
    paid = unscaled_cents(ss["ss_net_paid"])
    # numpy's lexsort by (-paid, item) as one stable argsort of a combined
    # key (paid below 2^40 cents, items below 2^20)
    _check(int(ss["ss_item_sk"].max()) < 1 << 20 and
           int(paid.max()) < 1 << 40, "phase 19 (c): keys too wide")
    order = np.argsort(((paid.max() - paid) << 20) + ss["ss_item_sk"],
                       kind="stable")
    want_sort = {"ss_net_paid": paid[order],
                 "ss_item_sk": ss["ss_item_sk"][order],
                 "ss_sold_date_sk": ss["ss_sold_date_sk"][order],
                 "ss_ext_sales_price": unscaled_cents(
                     ss["ss_ext_sales_price"])[order]}
    del order
    _log(f"phase 19 (c) numpy's stable sort in "
         f"{time.perf_counter() - t0:.2f} s")

    def sort_right(got):
        return all(np.array_equal(np.asarray(got[c]), want_sort[c])
                   for c in want_sort)
    s_sort = TorchSession({**conf, "spark.rapids.tpu.sql.batchSizeBytes":
                           DEC_SORT_BYTES})
    runs("order_by", lambda s: s.create_dataframe(sort_host).order_by(
        F.col("ss_net_paid").desc(), F.col("ss_item_sk").asc()),
        sort_right, "collect_numpy", s=s_sort)
    plan = s_sort.last_plan
    buckets = getattr(plan, "last_buckets", 0)
    _check(isinstance(plan, TpuSortExec) and buckets >= 2,
           f"phase 19 ORDER BY: {buckets} buckets, expected the sort out of "
           "core")
    _check(launches("order_by", "sort_bucket") >= 1,
           "phase 19 ORDER BY: sort_bucket never launched")
    out["order_by_buckets"] = buckets
    _log(f"phase 19 (c) ORDER BY ss_net_paid DESC (decimal(7,2)), "
         f"ss_item_sk over SF10 store_sales ({card}): {buckets} buckets, "
         f"every column equal to numpy's stable sort; {walls('order_by')}; "
         f"sort_bucket launches {launches('order_by', 'sort_bucket')}")
    del sort_host, want_sort
    shutil.rmtree(pq_dir, ignore_errors=True)

    # (d) the kernel alone
    out["kernel"] = phase_decimal_kernel(card, compare)
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"phase 19 (decimals) took {out['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 20: slice 7's patterns and string building -- LIKE of any pattern
# and RLIKE through rect_dfa, then concat / concat_ws / ||, repeat,
# translate, ascii, chr and octet_length
# ---------------------------------------------------------------------------

#: the kernel check's patterns over one l_comment batch: TPC-H Q13's and
#: Q16's, a '_', an escaped '%', three regular expressions, the empty
#: patterns, the byte-indexed instance's DFAs of 66 and 130 states and a
#: 192-state one (the class-indexed instance) (kind, pattern)
DFA_PATTERNS = (("like", "%special%requests%"),
                ("like", "%Customer%Complaints%"), ("like", "%sly_y %"),
                ("like", "%\\%%"), ("like", ""),
                ("rlike", "^[a-z]+ (pending|final) "),
                ("rlike", "(ly|ing)$"), ("rlike", "[0-9]{2,}"),
                ("rlike", ""), ("rlike", "a(a|b){5}$"),
                ("rlike", "a(a|b){6}$"), ("rlike", "a(a|b){6}c|d(a|b){5}e"))
#: the alphabet of phase_dfa_random's rectangles: the patterns' letters,
#: digits, '_', '%', '\\', a space, '\r' and '\n'
DFA_RANDOM_ALPHABET = (b"abcdeilnpqrsty CRSTUmo012345_%\\\r\n"
                       b"special requests Customer Complaints lying ")
#: lengths on and around the 16-byte chunks' and 64-byte groups' edges
DFA_EDGE_LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64, 65,
                    127, 128, -3)
#: Q13's filter (NOT LIKE) and Q16's (LIKE), over l_comment
Q13_PATTERN = "%special%requests%"
Q16_PATTERN = "%Customer%Complaints%"
SQL_Q13 = ("SELECT count(*) AS n, sum(l_extendedprice) AS revenue FROM "
           "lineitem WHERE l_comment NOT LIKE '%special%requests%'")
SQL_Q16 = ("SELECT count(*) AS n FROM lineitem WHERE l_comment LIKE "
           "'%Customer%Complaints%'")
SQL_FLAGS = ("SELECT l_returnflag || '|' || l_linestatus AS k, count(*) AS "
             "n, sum(l_extendedprice) AS s FROM lineitem GROUP BY "
             "l_returnflag || '|' || l_linestatus ORDER BY k")


def two_words_numpy(comment: np.ndarray, a: bytes, b: bytes) -> np.ndarray:
    """bool per row: ``a`` then, after it, ``b`` (LIKE '%a%b%')."""
    i = np.char.find(comment, a)
    j = np.char.find(comment, b, np.where(i >= 0, i + len(a), 0))
    return (i >= 0) & (j >= 0)


def dfa_walked(b, ln, v, dfa):
    """int64 per row: the bytes a DFA walk reads, up to the row's length
    or the byte that takes it into a sink (0 for a NULL row), on the
    card."""
    import torch
    from spark_rapids_tpu_torch.exec.rect_dfa import _tables
    classes, table, _ = (t.long() for t in _tables(dfa, b.device))
    state = torch.full(ln.shape, dfa.start, dtype=torch.int64,
                       device=b.device)
    walked = torch.zeros_like(state)
    for j in range(b.shape[1]):
        live = (j < ln) & (state < dfa.first_sink) & v
        walked += live
        state = torch.where(live, table[state * dfa.n_classes
                                        + classes[b[:, j].long()]], state)
    return walked


def dfa_bound(walked) -> dict:
    """The least time one rect_dfa call needs over these rows: each row's
    bytes up to where its walk stops (its length, or a sink), in 32-byte
    sectors (rect_match's ``contains`` rule), 4-byte lengths, the
    validity and one bool out; the walk is a few integer operations a
    byte, far under the 32-bit rate."""
    w = walked.cpu().numpy().astype(np.int64)
    n = len(w)
    nbytes = int((-(-w // 32) * 32).sum()) + 4 * n + n + n
    ops = int(w.sum()) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ms": max(bytes_ms, ops_ms),
            "by": "bytes" if bytes_ms >= ops_ms else "operations",
            "walked_bytes": int(w.sum())}


def _dfa_compile(kind: str, pat: str):
    from spark_rapids_tpu_torch.exprs.regex_dfa import (compile_like,
                                                        compile_rlike)
    return compile_like(pat) if kind == "like" else compile_rlike(pat)


def _dfa_versions(dfa, compare) -> list:
    """[(name, f(b, ln, v))]: the port's wrapper (the instance the host's
    rule picks), the byte-indexed instance handed the class table (its
    prologue makes the byte-indexed one) where the DFA is small enough,
    and each version of ``compare`` (the class-indexed instance's build
    among them)."""
    from spark_rapids_tpu_torch.exec import rect_dfa as RDK
    out = [("kernel", lambda b, ln, v: RDK.rect_dfa(b, ln, v, dfa))]
    if RDK.instance(dfa) == "byte":
        fn = RDK._launcher()["launch"]
        out.append(("byte instance from the class table",
                    lambda b, ln, v: RDK.launch(fn, b, ln, v, dfa, "class")))
    return out + [(who, lambda b, ln, v, f=f: f(b, ln, v, dfa))
                  for who, f in compare.items()]


def phase_dfa_kernel(card: str, comments, compare=None) -> dict:
    """rect_dfa against its plain version bit for bit on one SF1 l_comment
    batch, every pattern of DFA_PATTERNS, through every version of
    _dfa_versions; then timed with the L2 cold in turns (kernel, others,
    others reversed, kernel, ...) beside its bound, the plain version and
    the host's ms a call, with its instance, states, classes, shared
    memory, grid and registers. Then phase_dfa_random and phase_dfa_c4."""
    import torch
    from spark_rapids_tpu_torch.exec import rect_dfa as RDK
    compare = compare or {}
    b, ln, v = comments.data, comments.lengths, comments.validity
    P, W = b.shape
    n = max(2, -(-COLD_BYTES // (b.nbytes + ln.nbytes + v.nbytes)))
    inputs = [(b, ln, v)] + [(b.clone(), ln.clone(), v.clone())
                             for _ in range(n - 1)]
    out = {"shape": [int(P), int(W)], "patterns": {},
           "instances": RDK.describe()["instances"]}
    max_err = 0
    for kind, pat in DFA_PATTERNS:
        t0 = time.perf_counter()
        dfa = _dfa_compile(kind, pat)
        want = RDK.rect_dfa_reference(b, ln, v, dfa)
        versions = _dfa_versions(dfa, compare)
        for who, f in versions:
            got = f(b, ln, v)
            torch.cuda.synchronize()
            err = int((got != want).sum())
            if who == "kernel":
                max_err = max(max_err, err)
                matches = int(got.sum())
            _check(err == 0, f"rect_dfa {kind} {pat!r} ({who}): {err} rows "
                             "differ from the plain version")
        bd = dfa_bound(dfa_walked(b, ln, v, dfa))
        timed = [(who, f) for who, f in versions
                 if who == "kernel" or who in compare]
        turns = {who: [] for who, _ in timed}
        hosts = []
        for who, f in timed + timed[::-1] + timed:
            ms, host = _cold_ms(f, inputs, f"rect_dfa {pat!r} {who}")
            turns[who].append(ms)
            if who == "kernel":
                hosts.append(host)
        ms = float(np.mean(turns["kernel"]))
        plain = _plain_alone_ms(lambda b, ln, v, d=dfa:
                                RDK.rect_dfa_reference(b, ln, v, d),
                                inputs, f"rect_dfa {pat!r} plain")
        info = RDK.describe(dfa, int(P))
        row = {"kind": kind, "matches": matches, "ms": ms,
               "turns_ms": turns,
               "compare_ms": {who: float(np.mean(turns[who]))
                              for who in compare},
               "plain_ms": plain, "host_ms": float(np.mean(hosts)),
               "bound_ms": bd["ms"], "bound_by": bd["by"],
               "bound_bytes": bd["bytes"],
               "walked_bytes": bd["walked_bytes"], "max_abs_err": 0,
               "checked": [who for who, _ in versions],
               **{k: x for k, x in info.items() if k != "instances"}}
        out["patterns"][f"{kind} {pat}"] = row
        others = "".join(
            f"; {who} {row['compare_ms'][who]:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in turns[who])}), "
            f"{bd['ms'] / row['compare_ms'][who]:.0%} of bound"
            for who in compare)
        _log(f"rect_dfa {kind} {pat!r} on {P} x {W} ({card}): every version "
             f"bit-identical to the plain version ({', '.join(row['checked'])}"
             f"; {matches} rows match); kernel {ms:.4f} ms (turns "
             f"{', '.join(f'{t:.4f}' for t in turns['kernel'])}), "
             f"{bd['ms'] / ms:.0%} of bound {bd['ms']:.4f} ms "
             f"({bd['bytes']} B, by {bd['by']}; {bd['walked_bytes']} bytes "
             f"walked before a length or a sink){others}; plain "
             f"{plain:.4f} ms; host {row['host_ms']:.4f} ms a call; "
             f"{info['instance']}-indexed instance, {info['states']} states, "
             f"{info['classes']} classes, {info['sinks']} sinks, "
             f"{info['shared_bytes']} B shared, grid {info['grid']}, "
             f"{info['registers']} registers; library: none (no PyTorch "
             f"call matches a pattern); {time.perf_counter() - t0:.1f} s")
    _log(f"rect_dfa instances ({card}): " + "; ".join(
        f"{k}-indexed {x['registers']} registers, {x['threads']} threads, "
        f"{x['stack_bytes']} B stack" for k, x in out["instances"].items()))
    out["max_abs_err"] = max_err
    out["main"] = out["patterns"][f"like {Q13_PATTERN}"]
    del inputs
    out["random"] = phase_dfa_random(card, compare)
    out["c4"] = phase_dfa_c4(card, b, ln, v)
    return out


def phase_dfa_random(card: str, compare=None, rows: int = 65_537) -> dict:
    """Every version of _dfa_versions against the plain version bit for
    bit, every pattern of DFA_PATTERNS, on random rectangles 8, 16, 32, 64
    and 128 bytes wide: bytes of DFA_RANDOM_ALPHABET over the whole width
    (junk past every length), lengths from -3 to past the width with
    DFA_EDGE_LENGTHS first, a tenth of the rows NULL."""
    import torch
    from spark_rapids_tpu_torch.exec import rect_dfa as RDK
    compare = compare or {}
    t0 = time.perf_counter()
    rng = np.random.RandomState(20)
    alpha = np.frombuffer(DFA_RANDOM_ALPHABET, np.uint8)
    cases = 0
    for width in (8, 16, 32, 64, 128):
        rect = alpha[rng.randint(0, len(alpha), (rows, width))]
        lens = rng.randint(-3, width + 20, rows).astype(np.int32)
        lens[:len(DFA_EDGE_LENGTHS)] = DFA_EDGE_LENGTHS
        valid = rng.rand(rows) >= 0.1
        valid[:len(DFA_EDGE_LENGTHS)] = True
        b, ln, v = (torch.from_numpy(x).cuda() for x in (rect, lens, valid))
        for kind, pat in DFA_PATTERNS:
            dfa = _dfa_compile(kind, pat)
            want = RDK.rect_dfa_reference(b, ln, v, dfa)
            for who, f in _dfa_versions(dfa, compare):
                got = f(b, ln, v)
                torch.cuda.synchronize()
                err = int((got != want).sum())
                _check(err == 0, f"rect_dfa {kind} {pat!r} ({who}) on random "
                                 f"{rows} x {width} rows: {err} rows differ "
                                 "from the plain version")
                cases += 1
    _log(f"rect_dfa on random rectangles ({card}): {cases} cases (widths 8 "
         f"to 128, {rows} rows each, junk past the lengths, edge lengths, "
         f"NULLs; {len(DFA_PATTERNS)} patterns, every version) "
         f"bit-identical to the plain version in "
         f"{time.perf_counter() - t0:.1f} s")
    return {"cases": cases, "rows": rows}


def phase_dfa_c4(card: str, b, ln, v) -> dict:
    """Fault C4: a rectangle that is dense but not row-major (the batch's
    transpose, transposed back: strides (1, P)) through rect_dfa and
    rect_transform, each against its plain version over the row-major
    batch."""
    import torch
    from spark_rapids_tpu_torch.exec import rect_dfa as RDK
    from spark_rapids_tpu_torch.exec.rect_transform import (
        rect_transform, rect_transform_reference)
    P, W = b.shape
    tb = b.t().contiguous().t()
    _check(tb.stride() == (1, P) and not tb.is_contiguous(),
           f"the transposed rectangle has strides {tb.stride()}")
    dfa = _dfa_compile("like", Q13_PATTERN)
    got = RDK.rect_dfa(tb, ln, v, dfa)
    want = RDK.rect_dfa_reference(b, ln, v, dfa)
    chain = RT_NEW_TIMED[0][1]
    got_t = rect_transform(tb, ln, v, chain, RT_CAP)
    want_t = rect_transform_reference(b, ln, v, chain, RT_CAP)
    torch.cuda.synchronize()
    _check(torch.equal(got, want), "rect_dfa over a transposed-dense "
           f"rectangle: {int((got != want).sum())} rows differ")
    _check(torch.equal(got_t[0], want_t[0]) and torch.equal(got_t[1],
                                                            want_t[1]),
           "rect_transform over a transposed-dense rectangle differs from "
           "its plain version")
    _log(f"C4 ({card}): a {P} x {W} rectangle with strides {tb.stride()} "
         f"through rect_dfa ({Q13_PATTERN!r}) and rect_transform "
         f"({chain}): both bit-identical to their plain versions")
    return {"strides": list(tb.stride()), "exact": True}


#: rect_transform's repeat and translate, timed on phase 20's l_comment
#: batch: (label, chain)
RT_NEW_TIMED = (("translate", (("translate", b"aeiou", b"AEI"),)),
                ("repeat", (("substring", 1, 5), ("repeat", 3))))


def q13_filter(df, F):
    return (df.filter(~F.col("l_comment").like(Q13_PATTERN))
            .agg(F.count_star().with_name("n"),
                 F.sum(F.col("l_extendedprice")).with_name("revenue")))


def q16_filter(df, F):
    return df.filter(F.col("l_comment").like(Q16_PATTERN)).agg(
        F.count_star().with_name("n"))


def q_air_modes(df, F):
    return df.filter(F.col("l_shipmode").rlike("^(REG )?AIR$")).agg(
        F.count_star().with_name("n"))


def q_flags(df, F):
    k = F.concat(F.col("l_returnflag"), F.lit("|"), F.col("l_linestatus"))
    return (df.group_by(k.alias("k"))
            .agg(F.count_star().with_name("n"),
                 F.sum(F.col("l_extendedprice")).with_name("s"))
            .order_by("k"))


def flags_numpy(t: dict) -> list:
    key = np.char.add(np.char.add(t["l_returnflag"].astype("U1"), "|"),
                      t["l_linestatus"].astype("U1"))
    keys, inv = np.unique(key, return_inverse=True)
    n = np.bincount(inv, minlength=len(keys))
    s = np.bincount(inv, weights=t["l_extendedprice"], minlength=len(keys))
    return [{"k": str(k), "n": int(n[i]), "s": float(s[i])}
            for i, k in enumerate(keys)]


def flags_right(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        g["k"] == w["k"] and g["n"] == w["n"]
        and _rel(g["s"], w["s"]) <= REL_TOL for g, w in zip(got, want))


def q_building(df, F):
    """concat_ws, translate, repeat, ascii, chr and octet_length over one
    batch."""
    c = F.col("l_comment")
    return df.select(
        F.concat_ws("-", F.substring(c, 1, 12), F.col("l_shipmode"))
        .alias("ws"),
        F.translate(c, "aeiou", "AEI").alias("tr"),
        F.repeat(F.substring(c, 1, 5), 3).alias("rp"),
        F.ascii(c).alias("asc"), F.octet_length(c).alias("oct"),
        F.chr_(F.col("l_orderkey") % 300 - 20).alias("ch"))


def building_numpy(t: dict, rows: int) -> dict:
    """q_building's columns in numpy: S arrays, int32 and the chr's
    strings."""
    rect = t["l_comment"][:rows].view(np.uint8).reshape(rows, -1)
    lens = np.char.str_len(t["l_comment"][:rows]).astype(np.int32)
    cut = np.ascontiguousarray(rect[:, :12]).view("S12").reshape(rows)
    modes = t["l_shipmode"][:rows].astype("S7")
    ws = np.char.add(np.char.add(cut, b"-"), modes)
    table = np.arange(256, dtype=np.uint8)
    table[[ord("a"), ord("e"), ord("i")]] = [ord("A"), ord("E"), ord("I")]
    gone = np.zeros(256, bool)
    gone[[ord("o"), ord("u")]] = True
    live = np.arange(rect.shape[1])[None, :] < lens[:, None]
    keep = live & ~gone[rect]
    tr = np.zeros_like(rect)
    pos = np.cumsum(keep, axis=1) - keep
    r_idx = np.nonzero(keep)
    tr[r_idx[0], pos[keep]] = table[rect[keep]]
    five = np.ascontiguousarray(rect[:, :5]).view("S5").reshape(rows)
    n = t["l_orderkey"][:rows] % 300 - 20
    return {"ws": ws, "tr": np.ascontiguousarray(tr).view(
                f"S{rect.shape[1]}").reshape(rows),
            "rp": np.char.multiply(five, 3),
            "asc": np.where(lens > 0, rect[:, 0], 0).astype(np.int32),
            "oct": lens,
            "ch": np.where(n < 0, "", np.array([chr(i) for i in range(256)],
                                               object)[n & 255])}


def building_right(got: dict, want: dict) -> bool:
    def s_of(col):
        return np.array([x.encode("latin-1") for x in
                         np.asarray(col, object)], dtype=object)
    ok = True
    for k in ("ws", "tr", "rp"):
        ok &= not np.ma.getmaskarray(got[k]).any() and np.array_equal(
            s_of(got[k]), want[k].astype(object))
    for k in ("asc", "oct"):
        ok &= np.array_equal(np.asarray(got[k]), want[k])
    ok &= np.array_equal(np.asarray(got["ch"], object), want["ch"])
    return bool(ok)


def phase_patterns(card: str, batch_rows: int, table: dict, host,
                   compare=None) -> dict:
    """Phase 20 (module doc): rect_dfa exact and timed on one l_comment
    batch (in turns with the versions of ``compare``, name -> launch);
    TPC-H Q13's and Q16's comment filters and an RLIKE over the ship-mode
    dictionary at SF1, as DataFrames and SQL; then the string building
    functions, each against numpy."""
    import torch
    from spark_rapids_tpu_torch.api import TorchSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar import ColumnarBatch
    t_phase = time.perf_counter()
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows,
            "spark.rapids.tpu.sql.pallas.enabled": True}
    session = TorchSession(conf)
    session.create_dataframe(host).create_or_replace_temp_view("lineitem")
    out = {}
    n_batches = math.ceil(SF1_ROWS / batch_rows)

    def runs(label, make, right, collect="collect"):
        for phase in ("cold", "warm"):
            run, rows = _sql_run(session, make, collect)
            _check(right(rows), f"phase 20 {label} {phase}: "
                                f"{str(rows)[:300]}")
            out[f"{label}_{phase}"] = run
        return rows

    def summary(label, kernel):
        return (f"{out[f'{label}_cold']['wall_ms']:.1f} ms cold, "
                f"{out[f'{label}_warm']['wall_ms']:.1f} ms warm; {kernel} "
                f"launches {out[f'{label}_warm']['launches'][kernel]}")

    # (a) the kernel alone, on the first l_comment batch
    first = ColumnarBatch.from_host(host.select(["l_comment"]).slice(
        0, batch_rows), "cuda", 64).columns[0]
    _check(first.width == 64 and first.ascii_only,
           f"l_comment ingested as {first!r}")
    out["kernel"] = phase_dfa_kernel(card, first, compare)
    # rect_transform's new ops on the same batch (no other version has
    # them, so none is timed in turns)
    out["rt_times"] = {name: _rt_timed_row(
        name, first.data, first.lengths, first.validity, chain, {},
        _plain_alone_ms) for name, chain in RT_NEW_TIMED}
    del first
    _log(f"phase 20 (a) done at {time.perf_counter() - t_phase:.1f} s")

    # (b) Q13 and Q16 over SF1 lineitem, and RLIKE over the dictionary
    t0 = time.perf_counter()
    comment = table["l_comment"]
    special = two_words_numpy(comment, b"special", b"requests")
    want13 = [{"n": int((~special).sum()), "revenue": float(
        np.sum(table["l_extendedprice"][~special]))}]
    want16 = [{"n": int(two_words_numpy(comment, b"Customer",
                                        b"Complaints").sum())}]
    modes = table["l_shipmode"]
    want_air = [{"n": int(((modes == "AIR") | (modes == "REG AIR")).sum())}]
    _log(f"phase 20 (b) numpy answers in {time.perf_counter() - t0:.2f} s: "
         f"Q13 {want13}, Q16 {want16}, AIR modes {want_air}")

    def q13_right(rows):
        return len(rows) == 1 and rows[0]["n"] == want13[0]["n"] and _rel(
            rows[0]["revenue"], want13[0]["revenue"]) <= REL_TOL
    runs("q13", lambda s: q13_filter(s.table("lineitem"), F), q13_right)
    runs("q13_sql", lambda s: s.sql(SQL_Q13), q13_right)
    runs("q16", lambda s: q16_filter(s.table("lineitem"), F),
         lambda r: r == want16)
    runs("q16_sql", lambda s: s.sql(SQL_Q16), lambda r: r == want16)
    runs("air", lambda s: q_air_modes(s.table("lineitem"), F),
         lambda r: r == want_air)
    for label in ("q13", "q13_sql", "q16", "q16_sql"):
        for phase in ("cold", "warm"):
            k = out[f"{label}_{phase}"]["launches"]
            _check(k["rect_dfa"] == n_batches and k["rect_match"] == 0,
                   f"phase 20 {label} {phase}: rect_dfa launched "
                   f"{k['rect_dfa']} times, rect_match {k['rect_match']}; "
                   f"expected {n_batches} and 0 (one a batch)")
        _log(f"phase 20 (b) {label} SF1 ({card}): equal to numpy; "
             f"{summary(label, 'rect_dfa')} over {n_batches} batches")
    _check(out["air_warm"]["launches"]["rect_dfa"] == 0,
           "phase 20 RLIKE over the ship-mode dictionary launched rect_dfa")
    _log(f"phase 20 (b) l_shipmode RLIKE '^(REG )?AIR$' ({card}): "
         f"{want_air[0]['n']} rows, equal to numpy, over the dictionary; "
         f"{summary('air', 'rect_dfa')}")
    out["q13_profile_warm"] = phase_profile(
        session, host, q13_filter, q13_right,
        f"phase 20 Q13 NOT LIKE over SF1 l_comment ({card})", "rect_dfa")

    _log(f"phase 20 (b) done at {time.perf_counter() - t_phase:.1f} s")

    # (c) string building
    want_f = flags_numpy(table)
    runs("flags", lambda s: q_flags(s.table("lineitem"), F),
         lambda r: flags_right(r, want_f))
    runs("flags_sql", lambda s: s.sql(SQL_FLAGS),
         lambda r: flags_right(r, want_f))
    for label in ("flags", "flags_sql"):
        _log(f"phase 20 (c) {label} ({card}): {len(want_f)} groups equal "
             f"to numpy; {summary(label, 'dense_groupby')}")
    one = host.slice(0, batch_rows)
    t0 = time.perf_counter()
    want_b = building_numpy(table, batch_rows)
    _log(f"phase 20 (c) flags done at {t0 - t_phase:.1f} s; numpy's "
         f"building columns in {time.perf_counter() - t0:.1f} s")
    runs("building", lambda s: q_building(s.create_dataframe(one), F),
         lambda r: building_right(r, want_b), "collect_numpy")
    kt = out["building_warm"]["launches"]["rect_transform"]
    _check(kt >= 3, f"phase 20 (c) building: rect_transform launched {kt} "
                    "times, expected 3 (translate, repeat's chain and the "
                    "substring under concat_ws)")
    _log(f"phase 20 (c) concat_ws, translate, repeat, ascii, octet_length "
         f"and chr over {batch_rows} rows ({card}): every value equal to "
         f"numpy; {summary('building', 'rect_transform')}")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"phase 20 (patterns and string building) took "
         f"{out['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", metavar="NAME=DIR", action="append",
                    default=[],
                    help="also build DIR/rect_match.cu, "
                    "DIR/dense_groupby.cu, DIR/rect_transform.cu, "
                    "DIR/window_frame.cu, DIR/sort_bucket.cu, "
                    "DIR/decimal_arith.cu and/or DIR/rect_dfa.cu "
                    "(another version of the kernel, such as an earlier "
                    "commit's: each with the port's launch signature, "
                    "dense_groupby with that of commit 645412c) and time "
                    "it beside the port's; repeatable")
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
        card = phase_device()
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

        join_err = phase_join_exact()
        join_t = phase_join_times(*q3_join_shape(),
                                  "q3's first join (one store_sales batch "
                                  "against November's dates)")
        join_t100k = phase_join_times(
            *_join_case(np.random.RandomState(100), 100_000, ("i64",)),
            "100,000 build keys with 1-8 rows each")

        # phases 4-9 keep 1,048,576-row batches under their keyless
        # aggregates too (their per-batch launch counts and the Parquet
        # comparison rest on it); phase 11 lets q9's scan widen
        conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
                "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows}
        session = TorchSession(conf)          # device defaults to cuda
        _check(session.device.type == "cuda", "session is not on cuda")

        want6 = q6_numpy(table)
        rect_match.launches = 0
        rows, ms_cold = _run_query(session, host, q6)
        inmem = {"q6": rows}
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
        inmem["q_comment"] = rows_on
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
        inmem["q1"] = rows
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
        gaps, inmem["q12_in"] = phase_operator_gaps(conf, table, host,
                                                    n_batches, card)
        mem = phase_memory_slice(conf, table, host, n_batches)
        mem["q18_agg_repartitioned"] = phase_q18_repartitioned(
            conf, host, table, mem["q18_partial_bytes"], mem["q18_budget"],
            card)
        parquet = phase_parquet(table, inmem, batch_rows, card)
        tpcds, ds = phase_tpcds(card, batch_rows)
        tpcds2 = phase_tpcds2(card, batch_rows, ds["ss"], ds["hosts"][0])
        sql = phase_sql(card, batch_rows, table, host, ds, tpcds2)
        strings = phase_strings(card, batch_rows,
                                compare["rect_transform"])
        windows = phase_windows(card, batch_rows, ds, compare)
        stats = phase_stats(card, batch_rows, table, host, ds)
        ds19 = {"ss": {c: ds["ss"][c] for c in (
            "ss_sold_date_sk", "ss_item_sk") + DEC_STORE_SALES},
            "dd": ds["dd"], "it": ds["it"]}
        del ds
        nested = phase_nested(card, batch_rows, table, host)
        maps = phase_maps_structs(card, batch_rows, table, host)
        lists = phase_string_lists(card, batch_rows, table, host)
        decimals = phase_decimals(card, batch_rows, table, ds19,
                                  compare["decimal_arith"])
        del ds19
        patterns = phase_patterns(card, batch_rows, table, host,
                                  compare["rect_dfa"])
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
            **mem, **gaps, "parquet": parquet, "tpcds": tpcds,
            "tpcds2": {k: v for k, v in tpcds2.items()
                       if k != "kernel"}, "sql": sql,
            "strings": {k: v for k, v in strings.items()
                        if k not in ("times", "exact")},
            "windows": {"rung": {k: v for k, v in windows["rung"].items()
                                 if k != "times"},
                        "store_sales": windows["store_sales"],
                        "order_by": {k: v for k, v in
                                     windows["order_by"].items()
                                     if k != "times"},
                        "phase_s": windows["phase_s"]},
            "slice9a": {k: v for k, v in stats.items()
                        if not k.endswith("profile_warm")},
            "slice9a_profile_a": stats["a_profile_warm"],
            "slice9b": {k: v for k, v in nested.items()
                        if not k.endswith("profile_warm")},
            "slice9b_profile_a": nested["a_profile_warm"],
            "slice9b_profile_c": nested["c_profile_warm"],
            "slice9b_maps": {k: v for k, v in maps.items()
                             if not k.endswith("profile_warm")},
            "slice9b_maps_profile_a": maps["a_profile_warm"],
            "slice9b_maps_profile_e": maps["e_profile_warm"],
            "slice9b_rest": {k: v for k, v in lists.items()
                             if not k.endswith("profile_warm")},
            "slice9b_rest_profile_a": lists["a_profile_warm"],
            "slice9b_rest_profile_b": lists["b_profile_warm"],
            "decimals": {k: v for k, v in decimals.items()
                         if k != "kernel"},
            "patterns": {k: v for k, v in patterns.items()
                         if k != "kernel"}}}))
        main_t = times["main"]
        kernel = {
            "name": "rect_match", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/rect_match.cu",
            "replaces": "spark_rapids_tpu/exprs/pallas_rect.py:57",
            "launches": launches, "max_abs_err": max_err,
            "paths": {"q_comment": launches,
                      "q_comment_filter": mem["q_comment_filter_on"]["cold"][
                          "launches"]["rect_match"],
                      "sql_like": sql["like"]["cold"]["launches"][
                          "rect_match"],
                      **{f"string_lists_{k}": lists[f"{k}_cold"][
                          "launches"]["rect_match"]
                         for k in ("a", "c_special", "d")}},
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
                          "dense_groupby"],
                      "sql_q1": sql["q1"]["cold"]["launches"][
                          "dense_groupby"],
                      "stats_a": stats["a_dataframe_cold"]["launches"][
                          "dense_groupby"],
                      "stats_a_sql": stats["a_sql_cold"]["launches"][
                          "dense_groupby"],
                      "nested_c": nested["c_cold"]["launches"][
                          "dense_groupby"],
                      "maps_d_pos": maps["d_pos_cold"]["launches"][
                          "dense_groupby"],
                      "string_lists_c_pos": lists["c_pos_cold"][
                          "launches"]["dense_groupby"],
                      **{f"decimal_{k}": decimals[f"{k}_cold"]["launches"][
                          "dense_groupby"] for k in ("q1", "q1_parquet",
                                                     "q1_sql")}},
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
        q3b = tpcds["broadcast"]
        join = {
            "name": "join_match", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/join_match.cu",
            "replaces": "spark_rapids_tpu/exec/joins.py:55",
            "launches": q3b["cold"]["join_match_launches"],
            "max_abs_err": join_err, "exact": join_err == 0,
            "paths": {"q3_broadcast": q3b["cold"]["join_match_launches"],
                      "q3_shuffled": tpcds["shuffled"]["cold"][
                          "join_match_launches"],
                      **{f"ss_{k}_item": v["join_match_launches"]
                         for k, v in tpcds["joins_by_type"].items()},
                      "sql_q3": sql["q3"]["cold"]["launches"]["join_match"],
                      **{f"nested_{k}": nested[f"d_{k}_cold"]["launches"][
                          "join_match"] for k in (
                          "intersect_all_dataframe", "except_all_dataframe",
                          "intersect_all_sql", "except_all_sql")}},
            "ms": join_t["ms"], "plain_ms": join_t["plain_ms"],
            "bound_ms": join_t["bound_ms"], "bound_by": join_t["bound_by"],
            "bound_bytes": join_t["bound_bytes"],
            "bound_ms_sectors": join_t["sector_ms"], "library_ms": None,
            "call_ms": join_t["call_ms"], "host_ms": join_t["host_ms"],
            "timing": "the call's launches (one; or count and emit) "
                      "queued back to back over distinct inputs (L2 "
                      "cold); call_ms: a whole wrapper call with its "
                      "host read of the total",
            "launch_route": join_t["route"],
            "shared_table": join_t["shared_table"],
            "shape": [join_t["stream_rows"], join_t["build_keys"],
                      join_t["out_rows"]],
            "k100": {k: join_t100k[k] for k in (
                "ms", "plain_ms", "bound_ms", "sector_ms", "call_ms",
                "host_ms", "stream_rows", "build_keys", "out_rows",
                "shared_table")}, "launch_route_k100": join_t100k["route"],
        }
        dense["paths"]["q28"] = tpcds2["q28"]["cold"]["launches"][
            "dense_groupby"]
        tpcds2["kernel"]["paths"]["sql_q28"] = sql["q28"]["cold"][
            "launches"]["distinct_flag"]
        rt = strings["times"]["upper_trim"]
        rt_err = max([strings["exact"]["max_abs_err"]]
                     + [strings["times"][name]["max_abs_err"]
                        for name, _, _ in RT_TIMED])
        transform = {
            "name": "rect_transform", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/rect_transform.cu",
            "replaces": "spark_rapids_tpu/exprs/string_rect.py:74",
            "launches": strings["100000"]["cold"]["rect_transform"],
            "max_abs_err": rt_err, "exact": rt_err == 0,
            "exact_cases": strings["exact"]["cases"],
            "paths": {"strings_1000": strings["1000"]["cold"][
                          "rect_transform"],
                      "strings_100000": strings["100000"]["cold"][
                          "rect_transform"],
                      "strings_100000_sql": strings["100000"]["sql"][
                          "rect_transform"],
                      **{f"string_lists_{k}": lists[f"{k}_cold"][
                          "launches"]["rect_transform"]
                         for k in ("a_bytes", "a_first")}},
            "ms": rt["ms"], "plain_ms": rt["plain_ms"],
            "bound_ms": rt["bound_ms"], "bound_by": rt["bound_by"],
            "bound_bytes": rt["bound_bytes"], "library_ms": None,
            "host_ms": rt["host_ms"], "compare_ms": rt["compare_ms"],
            "turns_ms": rt["turns_ms"],
            "timing": "device time per launch, launches queued back to "
                      "back over distinct inputs (L2 cold)",
            "shape": strings["times"]["shape"],
            "launch": strings["times"]["launch"],
            "registers": strings["times"]["registers"],
            **{name: {k: strings["times"][name][k] for k in (
                "ms", "compare_ms", "plain_ms", "bound_ms", "host_ms",
                "shape", "max_abs_err")}
               for name, _, _ in RT_TIMED if name != "upper_trim"},
        }
        wt = windows["rung"]["times"]
        wf_err = max(wt[name]["max_abs_err"] for name, *_ in WF_TIMED)
        frame = {
            "name": "window_frame", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/window_frame.cu",
            "replaces": "spark_rapids_tpu/exec/window.py:209",
            "replaces_also": "spark_rapids_tpu/exec/window.py:559",
            "launches": windows["rung"]["cold"]["launches"]["window_frame"],
            "max_abs_err": wf_err, "exact": wf_err == 0,
            "paths": {"window_rung": windows["rung"]["cold"]["launches"][
                          "window_frame"],
                      "window_rung_sql": windows["rung"]["sql"]["launches"][
                          "window_frame"],
                      "store_sales_windows": windows["store_sales"]["cold"][
                          "launches"]["window_frame"]},
            "ms": wt["sum_w3"]["ms"], "plain_ms": wt["sum_w3"]["plain_ms"],
            "bound_ms": wt["sum_w3"]["bound_ms"],
            "bound_by": wt["sum_w3"]["bound_by"],
            "bound_bytes": wt["sum_w3"]["bound_bytes"], "library_ms": None,
            "host_ms": wt["sum_w3"]["host_ms"],
            "compare_ms": wt["sum_w3"]["compare_ms"],
            "turns_ms": wt["sum_w3"]["turns_ms"],
            "instance_turns_ms": wt["sum_w3"]["instance_turns_ms"],
            "timing": "device time per launch, launches queued back to "
                      "back over distinct inputs (L2 cold), in turns with "
                      "the versions of --compare",
            "shape": wt["shape"], "launch": wt["launch"],
            **{name: {k: wt[name][k] for k in (
                "ms", "compare_ms", "plain_ms", "bound_ms", "bound_by",
                "host_ms", "max_abs_err", "frame", "op", "values", "tiled",
                "instance_turns_ms")}
               for name, *_ in WF_TIMED if name != "sum_w3"},
        }
        bt = windows["order_by"]["times"]
        bucket = {
            "name": "sort_bucket", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/sort_bucket.cu",
            "replaces": "spark_rapids_tpu/exec/sort.py:164",
            "launches": windows["order_by"]["cold"]["launches"][
                "sort_bucket"],
            "max_abs_err": max(bt["operands"]["max_abs_err"],
                               bt["one_operand"]["max_abs_err"]),
            "exact": bt["operands"]["max_abs_err"] == 0
            and bt["one_operand"]["max_abs_err"] == 0,
            "paths": {"store_sales_order_by": windows["order_by"]["cold"][
                "launches"]["sort_bucket"],
                      "maps_f_order_by": maps["f_cold"]["launches"][
                          "sort_bucket"],
                      "maps_g_split_percentile": maps["g_cold"][
                          "launches"]["sort_bucket"],
                      "string_lists_e_order_by": lists["e_cold"][
                          "launches"]["sort_bucket"]},
            "buckets": windows["order_by"]["cold"]["buckets"],
            "ms": bt["operands"]["ms"],
            "plain_ms": bt["operands"]["plain_ms"],
            "bound_ms": bt["operands"]["bound_ms"],
            "bound_by": bt["operands"]["bound_by"],
            "bound_bytes": bt["operands"]["bound_bytes"],
            "library_ms": bt["one_operand"]["library_ms"],
            "library": "torch.searchsorted(right=True) on the one amount "
                       "key (one_operand); no PyTorch call takes the "
                       "four-operand key",
            "host_ms": bt["operands"]["host_ms"],
            "compare_ms": bt["operands"]["compare_ms"],
            "turns_ms": bt["operands"]["turns_ms"],
            "widen_ms": bt["operands"]["widen_ms"],
            "timing": "device time per launch, launches queued back to "
                      "back over distinct inputs (L2 cold)",
            "shape": bt["shape"], "launch": bt["launch"],
            "dtypes": bt["dtypes"], "one_operand": bt["one_operand"],
        }
        join["paths"].update({f"decimal_{k}": decimals[f"{k}_cold"][
            "launches"]["join_match"] for k in ("q3", "q3_parquet")})
        bucket["paths"]["decimal_order_by"] = decimals["order_by_cold"][
            "launches"]["sort_bucket"]
        dk = decimals["kernel"]
        dec = {
            "name": "decimal_arith", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/decimal_arith.cu",
            "replaces": "spark_rapids_tpu/exprs/arithmetic.py:130",
            "replaces_also": "spark_rapids_tpu/exprs/aggregates.py:366",
            "launches": decimals["q1_cold"]["launches"]["decimal_arith"],
            "max_abs_err": dk["max_abs_err"],
            "exact": dk["max_abs_err"] == 0,
            "paths": {k: decimals[f"{k}_cold"]["launches"]["decimal_arith"]
                      for k in ("q1", "q6", "q1_parquet", "q6_parquet",
                                "q1_sql", "q6_sql", "q3", "q3_parquet",
                                "order_by")},
            "ms": dk["mul"]["ms"], "plain_ms": dk["mul"]["plain_ms"],
            "bound_ms": dk["mul"]["bound_ms"],
            "bound_by": dk["mul"]["bound_by"],
            "bound_bytes": dk["mul"]["bound_bytes"], "library_ms": None,
            "library": "none: torch has no int128 (to_double_q1: "
                       "torch's cast and divide, the same function where "
                       "|x| < 2^53)",
            "host_ms": dk["mul"]["host_ms"],
            "validity_and_ms": dk["mul"]["and_ms"],
            "validity_and_host_ms": dk["mul"]["and_host_ms"],
            "compare_ms": dk["mul"]["compare_ms"],
            "turns_ms": dk["mul"]["turns_ms"],
            "timing": "device time per launch, launches queued back to "
                      "back over distinct inputs (L2 cold), in turns with "
                      "the versions of --compare",
            "shape": [DA_ROWS], "registers": dk["describe"],
            "edge_cases": dk["edge_cases"], "sass": dk["sass"],
            **{name: {k: dk[name][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "host_ms", "valid_rows", "max_abs_err", "compare_ms",
                "turns_ms")}
               for name in DA_TIMED if name != "mul"},
        }
        pk = patterns["kernel"]
        pm = pk["main"]
        dfa = {
            "name": "rect_dfa", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/rect_dfa.cu",
            "replaces": "none: the JAX package runs these patterns on its "
                        "host engine (spark_rapids_tpu/exprs/"
                        "string_fns.py:236, :257)",
            "launches": patterns["q13_cold"]["launches"]["rect_dfa"],
            "max_abs_err": pk["max_abs_err"],
            "exact": pk["max_abs_err"] == 0,
            "paths": {k: patterns[f"{k}_cold"]["launches"]["rect_dfa"]
                      for k in ("q13", "q13_sql", "q16", "q16_sql", "air")},
            "ms": pm["ms"], "plain_ms": pm["plain_ms"],
            "bound_ms": pm["bound_ms"], "bound_by": pm["bound_by"],
            "bound_bytes": pm["bound_bytes"], "library_ms": None,
            "library": "none: no PyTorch call matches a pattern",
            "host_ms": pm["host_ms"],
            "timing": "device time per launch, launches queued back to "
                      "back over distinct inputs (L2 cold), in turns with "
                      "the class-indexed instance's build and the versions "
                      "of --compare",
            "shape": pk["shape"], "instances": pk["instances"],
            "compare_ms": pm["compare_ms"], "turns_ms": pm["turns_ms"],
            "random_cases": pk["random"]["cases"], "c4": pk["c4"],
            "per_pattern": {k: {f: r[f] for f in (
                "ms", "compare_ms", "plain_ms", "host_ms", "bound_ms",
                "instance", "states", "classes", "sinks", "shared_bytes",
                "grid", "registers", "matches")}
                for k, r in pk["patterns"].items()},
        }
        transform["paths"]["patterns_building"] = patterns[
            "building_cold"]["launches"]["rect_transform"]
        transform.update({name: {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "host_ms", "shape",
            "max_abs_err")} for name, row in patterns["rt_times"].items()})
        transform["max_abs_err"] = max(
            [transform["max_abs_err"]] + [
                row["max_abs_err"] for row in patterns["rt_times"].values()])
        transform["exact"] = transform["max_abs_err"] == 0
        _log(json.dumps({"kernels": [kernel, dense, join,
                                     tpcds2["kernel"], transform, frame,
                                     bucket, dec, dfa]}))
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
