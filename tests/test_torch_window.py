"""Windows on the port (``TorchSession.with_window_column``, the window
functions of ``functions``, SQL ``OVER``) against the JAX package, and
the ``window_frame`` kernel's plain version and row logic, on the CPU.

* Every query shape of tests/test_window.py and every ``OVER`` text of
  tests/test_sql.py runs through both packages over the same tables (the
  reference with its cost optimizer off), and so does bench.py's
  ``window_bounded`` rung at 4,096 rows. Integers and every value a
  window moves or picks (ranks, lag/lead, nth_value, min, max) compare
  exactly. Float sums and averages compare exactly to the reference only
  where neither side's order can change the bits; elsewhere to a
  relative and absolute ``FLOAT_TOL``: the reference takes a frame's sum
  as a difference of two prefix sums over the table, the port adds the
  frame's own values (``window_frame``) or a Hillis-Steele scan
  (columnar/segmented.py), so the two round differently.
* Two places where the reference departs from Spark (ROADMAP.md Queue C)
  are held to a line-for-line Python model of Spark's frames
  (``spark_frames``): a frame sum is the frame's own, so +-inf stays in
  the frames that hold it; and ORDER BY without a frame is RANGE
  UNBOUNDED PRECEDING .. CURRENT ROW, so peers share one value. Where a
  query shape of tests/test_window.py has that default frame over order
  keys with ties, the port is given the ROWS frame the reference takes
  and its default is held to the model instead.
* ``window_frame_reference`` (the plain version) against the reference's
  bounded branch (``_windowed_agg`` over ``_bounded_minmax``), and
  against ``csrc/window_frame_row.cuh`` built by g++ and run as the
  kernel runs each row, bit for bit.
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from data_gen import DoubleGen, IntGen, gen_df
from harness import _canon
from benchmarks import tpch
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.exprs import ColumnRef as RCol
from spark_rapids_tpu.exprs import aggregates as RA
from spark_rapids_tpu.exprs import window_fns as RW
from spark_rapids_tpu.sql.parser import SqlError as RefSqlError
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exec.window_frame import (
    OPS, SEARCHES, window_frame, window_frame_reference)
from spark_rapids_tpu_torch.exprs import ColumnRef as PCol
from spark_rapids_tpu_torch.exprs import aggregates as PA
from spark_rapids_tpu_torch.exprs import window_fns as PW
from spark_rapids_tpu_torch.sql.parser import SqlError as PortSqlError

from test_torch_slice import prebuild_reference_native

CSRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc"
OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
#: float sums the packages round differently (module doc): relative and
#: absolute, for values of magnitude <= 100 over at most 4,096 rows
FLOAT_TOL = 1e-9

REF = SimpleNamespace(F=RF, W=RW, A=RA, col=RCol, running=None,
                      session=lambda conf=None: TpuSession({**OFF,
                                                            **(conf or {})}))
PORT = SimpleNamespace(F=PF, W=PW, A=PA, col=PCol,
                       running=("rows", None, 0),
                       session=lambda conf=None: TorchSession(
                           {**OFF, **(conf or {})}, device="cpu"))


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _same(got: pd.DataFrame, want: pd.DataFrame, ordered: bool,
          float_cols=(), tol: float = FLOAT_TOL) -> None:
    """Frames equal: nulls where nulls are, every column exact except
    ``float_cols``, which agree to ``tol`` (NaN equal to NaN)."""
    got, want = _canon(got, not ordered), _canon(want, not ordered)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        np.testing.assert_array_equal(g.isna().to_numpy(),
                                      w.isna().to_numpy(), err_msg=c)
        m = ~w.isna().to_numpy()
        gv, wv = g[m].to_numpy(), w[m].to_numpy()
        if c in float_cols:
            np.testing.assert_allclose(gv.astype(float), wv.astype(float),
                                       rtol=tol, atol=tol, equal_nan=True,
                                       err_msg=c)
        elif np.asarray(wv).dtype.kind == "f":
            np.testing.assert_array_equal(gv.astype(float),
                                          wv.astype(float), err_msg=c)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=c)


def _both(query, ordered=False, float_cols=(), conf=None):
    """``query(ns, session)`` on both packages, compared (``_same``)."""
    got = query(PORT, PORT.session(conf)).to_pandas()
    want = query(REF, REF.session(conf)).to_pandas()
    _same(got, want, ordered, float_cols)
    return got


# ---------------------------------------------------------------------------
# the query shapes of tests/test_window.py
# ---------------------------------------------------------------------------

def _df(ns, s, n=512, seed=0):
    return s.create_dataframe(gen_df(
        {"p": IntGen(lo=0, hi=6, nullable=False),
         "o": IntGen(lo=0, hi=1000, nullable=False),
         "v": IntGen(lo=-100, hi=100, nullable=False)}, n=n, seed=seed))


def _ov(ns):
    return [ns.F.col("o").asc(), ns.F.col("v").asc()]


def _row_number(ns, s):
    return _df(ns, s).with_window_column("rn", ns.W.RowNumber(),
                                         partition_by=["p"],
                                         order_by=_ov(ns))


def _rank_dense_rank(ns, s):
    df = _df(ns, s).with_window_column("rk", ns.W.Rank(), partition_by=["p"],
                                       order_by=[ns.F.col("o").asc()])
    return df.with_window_column("drk", ns.W.DenseRank(),
                                 partition_by=["p"],
                                 order_by=[ns.F.col("o").asc()])


def _lag_lead(ns, s):
    df = _df(ns, s).with_window_column("lag1", ns.W.Lag(ns.col("v"), 1),
                                       partition_by=["p"], order_by=_ov(ns))
    return df.with_window_column("lead2", ns.W.Lead(ns.col("v"), 2),
                                 partition_by=["p"], order_by=_ov(ns))


def _unbounded_partition_aggs(ns, s):
    df = _df(ns, s)
    for name, fn in (("psum", ns.A.Sum(ns.col("v"))),
                     ("pmin", ns.A.Min(ns.col("v"))),
                     ("pmax", ns.A.Max(ns.col("v"))),
                     ("pcnt", ns.A.CountStar())):
        df = df.with_window_column(name, fn, partition_by=["p"])
    return df


def _running_sum(ns, s):
    return _df(ns, s).with_window_column(
        "rsum", ns.A.Sum(ns.col("v")), partition_by=["p"],
        order_by=_ov(ns), frame=ns.running)


def _bounded_preceding_sum(ns, s):
    return _df(ns, s).with_window_column(
        "wsum", ns.A.Sum(ns.col("v")), partition_by=["p"],
        order_by=_ov(ns), frame=("rows", -2, 0))


def _window_no_partition(ns, s):
    return _df(ns, s, n=128).with_window_column("rn", ns.W.RowNumber(),
                                                order_by=_ov(ns))


def _rank_desc_multi_order(ns, s):
    rng = np.random.RandomState(9)
    t = pa.table({"g": pa.array(rng.choice(["a", "b"], 300)),
                  "x": pa.array(rng.randint(0, 10, 300).astype("int64")),
                  "y": pa.array(rng.randint(0, 5, 300).astype("int64"))})
    df = s.create_dataframe(t).with_window_column(
        "r", ns.W.Rank(), partition_by=["g"],
        order_by=[ns.F.col("x").desc(), ns.F.col("y").asc()])
    return df.with_window_column("dr", ns.W.DenseRank(), partition_by=["g"],
                                 order_by=[ns.F.col("x").desc()])


def _bounded_min_max(ns, s):
    df = _df(ns, s, n=600)
    for name, fn, frame in (("wmin", ns.A.Min, (-3, 0)),
                            ("wmax", ns.A.Max, (-2, 2)),
                            ("wmax2", ns.A.Max, (1, 3)),
                            ("rmin", ns.A.Min, (None, -1)),
                            ("smax", ns.A.Max, (2, None))):
        df = df.with_window_column(name, fn(ns.col("v")), partition_by=["p"],
                                   order_by=_ov(ns),
                                   frame=("rows",) + frame)
    return df


def _min_max_nan_and_null(ns, s):
    vals = [1.0, np.nan, None, 4.0, np.nan, None, 2.0, 8.0]
    t = pa.table({"g": pa.array([0] * len(vals), pa.int64()),
                  "o": pa.array(range(len(vals)), pa.int64()),
                  "v": pa.array(vals, pa.float64())})
    df = s.create_dataframe(t).with_window_column(
        "bmin", ns.A.Min(ns.col("v")), partition_by=["g"],
        order_by=[ns.F.col("o").asc()], frame=("rows", -1, 0))
    return df.with_window_column(
        "bmax", ns.A.Max(ns.col("v")), partition_by=["g"],
        order_by=[ns.F.col("o").asc()], frame=("rows", -1, 1))


def _nan_null_table(n=900):
    rng = np.random.RandomState(4)
    vals = rng.uniform(-50, 50, n)
    vmask = rng.rand(n) < 0.08
    vals[rng.rand(n) < 0.05] = np.nan
    return pa.table({"p": pa.array(rng.randint(0, 9, n)),
                     "o": pa.array(rng.randint(0, 1000, n)),
                     "v": pa.array(np.where(vmask, 0.0, vals),
                                   mask=vmask)})


def _fn_families_with_nan(ns, s):
    df = s.create_dataframe(_nan_null_table())
    o = [ns.F.col("o").asc()]
    df = df.with_window_column("ws", ns.A.Sum(ns.col("v")),
                               partition_by=["p"], order_by=o,
                               frame=("rows", -2, 1))
    df = df.with_window_column("wmin", ns.A.Min(ns.col("v")),
                               partition_by=["p"], order_by=o,
                               frame=("rows", -3, 0))
    df = df.with_window_column("wmax", ns.A.Max(ns.col("v")),
                               partition_by=["p"], order_by=o,
                               frame=("rows", None, 2))
    df = df.with_window_column("rk", ns.W.Rank(), partition_by=["p"],
                               order_by=[ns.F.col("o").desc()])
    df = df.with_window_column("lg", ns.W.Lag(ns.col("v"), 2),
                               partition_by=["p"], order_by=o)
    return df.with_window_column("av", ns.A.Average(ns.col("v")),
                                 partition_by=["p"], order_by=o,
                                 frame=ns.running)


def _lag_explicit_default(ns, s):
    t = pa.table({"p": [1, 1, 2], "o": [1, 2, 1], "v": [10.0, 20.0, 30.0]})
    o = [ns.F.col("o").asc()]
    return (s.create_dataframe(t)
            .with_window_column("lg", ns.W.Lag(ns.col("v"), 1, -1.0),
                                partition_by=["p"], order_by=o)
            .with_window_column("ld", ns.W.Lead(ns.col("v"), 1, -2.0),
                                partition_by=["p"], order_by=o))


def _ranks_and_values(ns, s):
    """percent_rank, ntile (fewer rows than buckets in some partitions),
    nth_value (unique order keys, so its running frame has no peers),
    lag/lead past the partition and a count over NULLs."""
    rng = np.random.RandomState(21)
    n = 700
    t = pa.table({"p": pa.array(rng.randint(0, 40, n)),
                  "o": pa.array(rng.permutation(n)),
                  "v": pa.array(rng.randint(-9, 9, n),
                                mask=rng.rand(n) < 0.2)})
    df = s.create_dataframe(t)
    o = [ns.F.col("o").asc()]
    for name, fn in (("pr", ns.W.PercentRank()), ("nt", ns.W.NTile(7)),
                     ("nv", ns.W.NthValue(ns.col("v"), 3)),
                     ("lg", ns.W.Lag(ns.col("v"), 30)),
                     ("ld", ns.W.Lead(ns.col("v"), 1, 99))):
        df = df.with_window_column(name, fn, partition_by=["p"], order_by=o)
    return df.with_window_column("cnt", ns.A.Count(ns.col("v")),
                                 partition_by=["p"], order_by=o,
                                 frame=("rows", -4, 1))


def _count_of_strings(ns, s):
    """count() of a dictionary string column over a bounded frame and
    over the whole partition."""
    rng = np.random.RandomState(17)
    n = 300
    t = pa.table({"p": pa.array(rng.randint(0, 5, n)),
                  "o": pa.array(rng.permutation(n)),
                  "s": pa.array(rng.choice(["ab", "c", "def"], n),
                                mask=rng.rand(n) < 0.2)})
    df = s.create_dataframe(t)
    o = [ns.F.col("o").asc()]
    df = df.with_window_column("cs", ns.A.Count(ns.col("s")),
                               partition_by=["p"], order_by=o,
                               frame=("rows", -3, 1))
    return df.with_window_column("ct", ns.A.Count(ns.col("s")),
                                 partition_by=["p"])


SHAPES = {
    "count_of_strings": (_count_of_strings, ()),
    "row_number": (_row_number, ()),
    "rank_dense_rank": (_rank_dense_rank, ()),
    "lag_lead": (_lag_lead, ()),
    "unbounded_partition_aggs": (_unbounded_partition_aggs, ()),
    "running_sum": (_running_sum, ()),
    "bounded_preceding_sum": (_bounded_preceding_sum, ()),
    "window_no_partition": (_window_no_partition, ()),
    "rank_desc_multi_order": (_rank_desc_multi_order, ()),
    "bounded_min_max_frames": (_bounded_min_max, ()),
    "min_max_nan_and_null": (_min_max_nan_and_null, ()),
    # bounded float sums: the reference's prefix difference rounds
    # otherwise; a running average: a scan against the prefix
    "fn_families_with_nan_and_null": (_fn_families_with_nan, ("ws", "av")),
    "lag_explicit_default": (_lag_explicit_default, ()),
    "ranks_and_values": (_ranks_and_values, ()),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_window_query_matches_reference(shape):
    query, float_cols = SHAPES[shape]
    _both(query, float_cols=float_cols)


def test_window_nan_vs_null_sql_matches_reference():
    """tests/test_window.py's SQL text: a bounded frame sum, a partition
    max and a lag over doubles with NaN and NULL."""
    rng = np.random.RandomState(9)
    n = 2000
    v = rng.rand(n)
    v[rng.rand(n) < 0.05] = np.nan
    mask = rng.rand(n) < 0.05
    t = pa.table({"g": rng.randint(0, 20, n),
                  "v": pa.array([None if m else x for m, x in zip(mask, v)]),
                  "o": rng.rand(n)})
    q = """SELECT g, sum(v) OVER (PARTITION BY g ORDER BY o
             ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) s,
           max(v) OVER (PARTITION BY g) mx,
           lag(v, 1) OVER (PARTITION BY g ORDER BY o) lg
           FROM t ORDER BY g, o"""

    def query(ns, s):
        s.create_dataframe(t).create_or_replace_temp_view("t")
        return s.sql(q)
    _both(query, ordered=True, float_cols=("s",))


# ---------------------------------------------------------------------------
# the OVER texts of tests/test_sql.py
# ---------------------------------------------------------------------------

def _views(s):
    s.create_dataframe(pa.table({"g": ["a", "a", "a", "b", "b"],
                                 "v": [3.0, 1.0, 2.0, 5.0, 4.0]})) \
        .create_or_replace_temp_view("w")
    s.create_dataframe(pa.table({"v": [1.0, 2.0, 3.0, 4.0]})) \
        .create_or_replace_temp_view("w2")
    s.create_dataframe(pa.table({"g": ["a", "a", "b", "b", None],
                                 "v": pa.array([3.0, None, 2.0, 5.0, 4.0])})) \
        .create_or_replace_temp_view("wx")
    s.create_dataframe(pa.table({"v": pa.array([None, None, 1.0, 2.0])})) \
        .create_or_replace_temp_view("nt")
    s.create_dataframe(tpch.gen_lineitem(2000)) \
        .create_or_replace_temp_view("lineitem")
    return s


OVER_TEXTS = {
    "row_number_sum_lag": """
        SELECT g, v,
               row_number() OVER (PARTITION BY g ORDER BY v) AS rn,
               sum(v) OVER (PARTITION BY g) AS gs,
               lag(v, 1) OVER (PARTITION BY g ORDER BY v) AS pv
        FROM w ORDER BY g, v""",
    "running_sum_frame": """
        SELECT v, sum(v) OVER (ORDER BY v
            ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs
        FROM w2 ORDER BY v""",
    "rank_over_subquery_aggregate": """
        SELECT rf, rank() OVER (ORDER BY sq DESC) AS r FROM
          (SELECT l_returnflag AS rf, sum(l_quantity) AS sq
           FROM lineitem GROUP BY l_returnflag) t
        ORDER BY r""",
    "ntile_and_lag_default": """
        SELECT g, v, ntile(2) OVER (ORDER BY v NULLS FIRST) AS nt,
               lag(v, 1, -1) OVER (PARTITION BY g ORDER BY v) AS pv
        FROM wx ORDER BY g NULLS FIRST, v;""",
    "window_in_order_by_only": """SELECT v FROM wx
                 ORDER BY row_number() OVER (ORDER BY v DESC)""",
    "rank_null_order_keys_tie": """
        SELECT v, rank() OVER (ORDER BY v) AS r,
               dense_rank() OVER (ORDER BY v) AS dr
        FROM nt ORDER BY r, v""",
    "bounded_frames_and_lead": """
        SELECT g, v, count(*) OVER (PARTITION BY g ORDER BY v
                 ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS c,
               min(v) OVER (PARTITION BY g ORDER BY v
                 ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS mn,
               lead(v, 2) OVER (PARTITION BY g ORDER BY v) AS ld
        FROM w ORDER BY g, v""",
}


@pytest.mark.parametrize("name", sorted(OVER_TEXTS))
def test_sql_over_matches_reference(name):
    _both(lambda ns, s: _views(s).sql(OVER_TEXTS[name]), ordered=True)


@pytest.mark.parametrize("text,match", [
    ("SELECT sum(DISTINCT v) OVER () FROM wx", "DISTINCT"),
    ("""SELECT l_returnflag, rank() OVER (ORDER BY sum(l_quantity))
        FROM lineitem GROUP BY l_returnflag""", "subquery"),
    ("""SELECT v, sum(v) OVER (ORDER BY v RANGE BETWEEN 1 PRECEDING
        AND CURRENT ROW) FROM w2""", "ROWS"),
])
def test_sql_over_refusals_match_reference(text, match):
    for ns, err in ((PORT, PortSqlError), (REF, RefSqlError)):
        with pytest.raises(err, match=match):
            _views(ns.session()).sql(text)


def test_range_frame_with_offsets_refused_at_planning():
    """A RANGE frame with an offset raises at planning, naming the slice
    (the reference runs the frame as ROWS)."""
    s = PORT.session()
    df = s.create_dataframe({"o": np.arange(4), "v": np.ones(4)}) \
        .with_window_column("w", PA.Sum(PCol("v")), order_by=["o"],
                            frame=("range", -1, 0))
    with pytest.raises(NotImplementedError, match="RANGE frame"):
        df.collect()


# ---------------------------------------------------------------------------
# bench.py's window_bounded rung, and tests/test_spark_semantics.py's cases
# ---------------------------------------------------------------------------

def _rung_table(n: int, seed: int = 11) -> pa.Table:
    """bench.py's gen_window_table."""
    rng = np.random.RandomState(seed)
    return pa.table({"p": pa.array(rng.randint(0, 512, n)),
                     "o": pa.array(rng.randint(0, 1 << 30, n)),
                     "v": pa.array(rng.uniform(-100.0, 100.0, n))})


def _rung(ns, s, t):
    return s.create_dataframe(t).with_window_column(
        "wsum", ns.A.Sum(ns.col("v")), partition_by=["p"],
        order_by=[ns.F.col("o").asc()], frame=("rows", -2, 0))


def test_window_bounded_rung_4096_rows():
    """The rung against the reference (its prefix difference rounds
    otherwise: FLOAT_TOL), and bit for bit against the three terms added
    in row order from 0, as numpy adds them."""
    t = _rung_table(4096)
    got = _both(lambda ns, s: _rung(ns, s, t), ordered=True,
                float_cols=("wsum",))
    p, o, v = (t.column(c).to_numpy() for c in ("p", "o", "v"))
    order = np.lexsort((o, p))
    ps, vs = p[order], v[order]
    idx = np.arange(len(v))
    start = np.maximum.accumulate(np.where(np.r_[True, ps[1:] != ps[:-1]],
                                           idx, 0))
    acc = np.zeros(len(v))
    for k in (-2, -1, 0):
        acc = acc + np.where(idx + k >= start, vs[np.maximum(idx + k, 0)],
                             0.0)
    want = np.empty_like(acc)
    want[order] = acc
    np.testing.assert_array_equal(got["wsum"].to_numpy().view(np.int64),
                                  want.view(np.int64))


@pytest.mark.parametrize("case,fn,values,want", [
    ("rank_ties", PW.Rank, [10, 10, 20], [1, 1, 3]),
    ("ntile_two_over_five", lambda: PW.NTile(2), [1, 2, 3, 4, 5],
     [1, 1, 1, 2, 2]),
])
def test_spark_semantics_cases(case, fn, values, want):
    s = PORT.session()
    df = s.create_dataframe(pa.table({"v": values})).with_window_column(
        "o", fn(), order_by=[PF.col("v").asc()]) \
        .select(PF.col("o")).order_by(PF.col("o").asc())
    assert [r["o"] for r in df.collect()] == want


# ---------------------------------------------------------------------------
# the two departures, against a line-for-line model of Spark's frames
# ---------------------------------------------------------------------------

def spark_frames(p, o, v, how: str, frame):
    """Spark's answer, row by row: rows sorted stably by (p, o); each
    row's frame (``frame`` ("rows", lo, hi) with None unbounded, or None:
    RANGE UNBOUNDED PRECEDING .. CURRENT ROW, through the row's last peer)
    aggregated in ascending row order from 0, NULLs (None) skipped, NaN
    greatest for min and max. Returns the values in input order."""
    n = len(v)
    order = sorted(range(n), key=lambda i: (p[i], o[i]))
    out = [None] * n
    for pos, i in enumerate(order):
        same = [j for j, r in enumerate(order) if p[r] == p[i]]
        first, last = same[0], same[-1]
        if frame is None:
            lo = first
            hi = max(j for j in same if o[order[j]] == o[i])
        else:
            _, a, b = frame
            lo = first if a is None else max(first, pos + a)
            hi = last if b is None else min(last, pos + b)
        vals = [v[order[j]] for j in range(lo, hi + 1)
                if v[order[j]] is not None]
        if how == "count":
            out[i] = len(vals)
        elif not vals:
            out[i] = None
        elif how in ("sum", "avg"):
            acc = 0.0
            for x in vals:
                acc = acc + x
            out[i] = acc if how == "sum" else acc / len(vals)
        elif how == "max":
            out[i] = math.nan if any(math.isnan(x) for x in vals) \
                else max(vals)
        else:
            real = [x for x in vals if not math.isnan(x)]
            out[i] = min(real) if real else math.nan
    return out


def _port_window(p, o, v, how, frame):
    fn = {"sum": PA.Sum, "avg": PA.Average, "min": PA.Min, "max": PA.Max,
          "count": PA.Count}[how](PCol("v"))
    t = pa.table({"p": pa.array(p, pa.int64()), "o": pa.array(o, pa.int64()),
                  "v": pa.array(v, pa.float64())})
    df = PORT.session().create_dataframe(t).with_window_column(
        "w", fn, partition_by=["p"], order_by=["o"], frame=frame)
    return [r["w"] for r in df.collect()]


INF_TABLE = ([0, 0, 0, 1, 1, 1], [1, 2, 3, 1, 2, 3],
             [math.inf, 1.0, 2.0, 3.0, 4.0, 5.0])


@pytest.mark.parametrize("frame,want", [
    (("rows", -1, 0), [math.inf, math.inf, 3.0, 3.0, 7.0, 9.0]),
    (("rows", None, 0), [math.inf, math.inf, math.inf, 3.0, 7.0, 12.0]),
])
def test_departure_frame_sum_is_the_frames_own(frame, want):
    """Departure 1: after +inf the reference reads inf - inf = NaN in
    every later frame; Spark (and the port) keep later partitions
    finite."""
    got = _port_window(*INF_TABLE, "sum", frame)
    assert got == want == spark_frames(*INF_TABLE, "sum", frame)


def test_departure_default_frame_is_range():
    """Departure 2: ORDER BY without a frame is RANGE UNBOUNDED
    PRECEDING .. CURRENT ROW, so peers share one value (the reference
    gives 10, 30, 60)."""
    s = PORT.session()
    s.create_dataframe({"o": np.array([1, 1, 2]),
                        "v": np.array([10, 20, 30])}) \
        .create_or_replace_temp_view("t")
    rows = s.sql("SELECT o, v, sum(v) OVER (ORDER BY o) AS s FROM t") \
        .collect()
    assert [r["s"] for r in rows] == [30, 30, 60]
    # the default frame of the test_window.py shapes with ties
    t = _nan_null_table()
    p, o, v = (t.column(c).to_pylist() for c in ("p", "o", "v"))
    got = _port_window(p, o, v, "avg", None)
    want = spark_frames(p, o, v, "avg", None)
    _close(got, want)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or g is None:
            assert g is None and w is None
        elif math.isnan(w):
            assert math.isnan(g)
        else:
            assert g == pytest.approx(w, rel=FLOAT_TOL, abs=FLOAT_TOL)


@pytest.mark.parametrize("how", ["sum", "avg", "min", "max", "count"])
@pytest.mark.parametrize("frame", [
    ("rows", -2, 0), ("rows", -3, 2), ("rows", 1, 4), ("rows", -5, -2),
    ("rows", None, 1), ("rows", -1, None), ("rows", None, None), None])
def test_frames_match_spark_model(how, frame):
    """Random tables with +-inf, NaN, NULL and tied order keys, every
    aggregate over every kind of frame, against the model: bounded frames
    exactly (the same additions in the same order), the scans to
    FLOAT_TOL (another association of the same values)."""
    rng = np.random.RandomState(hash((how, str(frame))) % (1 << 31))
    n = 160
    p = rng.randint(0, 7, n).tolist()
    o = rng.randint(0, 25, n).tolist()
    pool = [math.inf, -math.inf, math.nan, None, -0.0]
    v = [pool[rng.randint(len(pool))] if rng.rand() < 0.12
         else round(float(rng.uniform(-50, 50)), 3) for _ in range(n)]
    got = _port_window(p, o, v, how, frame)
    want = spark_frames(p, o, v, how, frame)
    if frame is not None and frame[1] is not None and frame[2] is not None:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None and w is None) or g == w or \
                (math.isnan(g) and math.isnan(w))
    else:
        _close(got, want)


# ---------------------------------------------------------------------------
# window_frame's plain version: against the reference's bounded branch, and
# against its row logic built by g++
# ---------------------------------------------------------------------------

def _sorted_partitions(rng, n: int, parts: int):
    sizes = np.diff(np.r_[0, np.sort(rng.choice(np.arange(1, n), parts - 1,
                                                replace=False)), n])
    start = np.repeat(np.cumsum(np.r_[0, sizes[:-1]]), sizes)
    end = start + np.repeat(sizes, sizes) - 1
    return start.astype(np.int32), end.astype(np.int32), \
        start == np.arange(n)


def _reference_bounded(how, vd, vv, start, end, lo, hi):
    """The reference's bounded branch (``_windowed_agg`` and
    ``_bounded_minmax``) over rows already sorted by partition."""
    from spark_rapids_tpu.exec.window import _windowed_agg
    from spark_rapids_tpu.exprs.base import DVal
    from spark_rapids_tpu.plan.logical import WindowSpec
    from spark_rapids_tpu.types import FLOAT64, INT64
    n = len(vd)
    fn = {"sum": RA.Sum, "avg": RA.Average, "min": RA.Min, "max": RA.Max,
          "count": RA.Count}[how](RCol("v"))
    idx = jnp.arange(n, dtype=jnp.int32)
    pflags = jnp.asarray(start == np.arange(n))
    end_mask = jnp.asarray(end == np.arange(n))
    child = DVal(jnp.asarray(vd), jnp.asarray(vv),
                 FLOAT64 if vd.dtype.kind == "f" else INT64)
    out, ok = _windowed_agg(fn, WindowSpec([], [], ("rows", lo, hi)), None,
                            child, jnp.asarray(start), idx,
                            jnp.ones(n, jnp.bool_), n, pflags, end_mask,
                            jnp.asarray(end))
    return np.asarray(out), np.asarray(ok)


@pytest.mark.parametrize("how", sorted(OPS))
@pytest.mark.parametrize("lo,hi", [(-3, 2), (1, 3)])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_plain_window_frame_matches_reference_bounded_branch(how, lo, hi,
                                                            kind):
    """Finite values (no +-inf, where the reference departs): counts,
    integer sums, minimum and maximum exactly; float sums and averages to
    FLOAT_TOL (the reference's prefix difference rounds otherwise)."""
    rng = np.random.RandomState(100 + lo * 7 + hi)
    n = 3000
    start, end, flags = _sorted_partitions(rng, n, 60)
    if kind == "int":
        vd = rng.randint(-1000, 1000, n).astype(np.int64)
    else:
        vd = rng.uniform(-100, 100, n)
        vd[rng.rand(n) < 0.03] = np.nan
    vv = rng.rand(n) > 0.1
    vd = np.where(vv, vd, 0).astype(vd.dtype)
    if how == "avg":
        vd = vd.astype(np.float64)
    got, ok = window_frame_reference(
        torch.from_numpy(vd), torch.from_numpy(vv), torch.from_numpy(flags),
        lo, hi, how)
    want, wok = _reference_bounded(how, vd, vv, start, end, lo, hi)
    np.testing.assert_array_equal(ok.numpy(), wok)
    g, w = got.numpy()[wok], want[wok]
    if kind == "float" and how in ("sum", "avg"):
        np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(g, w)


_HOST_SRC = r"""
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <random>
#include <vector>
#include "window_frame_row.cuh"
#include "window_frame_tile.cuh"

template <typename T, int OP, typename Out>
static void rows(const T* v, const uint8_t* valid, const uint8_t* flags,
                 Out* out, uint8_t* ok, int64_t n, int32_t lo, int32_t hi) {
  for (int64_t i = 0; i < n; ++i) {      // the kernel's body, a row a time
    int64_t a, b;
    wf_chunk_bounds(flags, n, i, lo, hi, &a, &b);
    Out r;
    uint8_t k;
    wf_row<T, OP>(v, valid, a, b, &r, &k);
    out[i] = r;
    ok[i] = k;
  }
}

template <typename T>
static int by_op(int op, const void* v, const uint8_t* valid,
                 const uint8_t* f, void* out, uint8_t* ok, int64_t n,
                 int32_t lo, int32_t hi) {
  const T* tv = (const T*)v;
  switch (op) {
    case WF_SUM: rows<T, WF_SUM>(tv, valid, f, (T*)out, ok, n, lo, hi);
      return 0;
    case WF_COUNT: rows<T, WF_COUNT>(tv, valid, f, (int64_t*)out, ok, n, lo,
                                     hi);
      return 0;
    case WF_AVG: rows<T, WF_AVG>(tv, valid, f, (double*)out, ok, n, lo, hi);
      return 0;
    case WF_MIN: rows<T, WF_MIN>(tv, valid, f, (T*)out, ok, n, lo, hi);
      return 0;
    case WF_MAX: rows<T, WF_MAX>(tv, valid, f, (T*)out, ok, n, lo, hi);
      return 0;
  }
  return 1;
}

// The instance a launch with search "frame" takes: WF_SEARCH_TILE or
// WF_SEARCH_CHUNKS.
extern "C" int wf_pick(int32_t lo, int32_t hi) {
  return wf_tiled(lo, hi) ? WF_SEARCH_TILE : WF_SEARCH_CHUNKS;
}

// The tiled kernel on the host: ``blocks`` persistent blocks in a
// shuffled order, each walking its tiles as the kernel does (the next
// tile staged into the other buffer before this one is computed), each
// step's nt threads in a shuffled order, a barrier between steps, in a
// shared memory of junk bytes with a guard after it.
template <typename T, int OP, bool SEG>
static int tiles(const void* v, const uint8_t* valid, const uint8_t* f,
                 void* out, uint8_t* ok, int64_t n, int32_t lo, int32_t hi,
                 int nt, int blocks, unsigned seed) {
  typedef WfKind<T, OP, SEG> K;
  if (!wf_tiled(lo, hi) || nt % 16 || ((uintptr_t)out & 15) ||
      ((uintptr_t)ok & 15))
    return 1;
  const WfGeo geo = wf_geo(n, lo, hi, nt);
  const int64_t bytes = wf_smem_bytes<T, OP, SEG>(geo);
  const int64_t ntiles = (n + geo.rows - 1) / geo.rows;
  if (blocks > ntiles) blocks = (int)ntiles;
  std::vector<uint8_t> mem(bytes + 16 + 64);
  uint8_t* base = mem.data() + ((16 - ((uintptr_t)mem.data() & 15)) & 15);
  std::vector<int> order(blocks), th(nt);
  std::iota(order.begin(), order.end(), 0);
  std::iota(th.begin(), th.end(), 0);
  std::mt19937 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);
  for (int blk : order) {
    for (auto& b : mem) b = (uint8_t)rng();
    std::vector<uint8_t> guard(base + bytes, base + bytes + 48);
    const WfSmem s = wf_carve<T, OP, SEG>(base, geo, v, valid, f);
    auto step = [&](auto fn) {
      std::shuffle(th.begin(), th.end(), rng);
      for (int t : th) fn(t);
    };
    int64_t tile = blk;
    step([&](int t) {
      wf_stage<OP>(wf_at(geo, tile), wf_buf(s, 0), v, valid, f, t);
    });
    for (int b = 0; tile < ntiles; tile += blocks, b ^= 1) {
      const WfGeo g = wf_at(geo, tile);
      const int64_t next = tile + blocks;
      if (next < ntiles)
        step([&](int t) {
          wf_stage<OP>(wf_at(geo, next), wf_buf(s, b ^ 1), v, valid, f, t);
        });
      const WfBuf bf = wf_buf(s, b);
      bool masks = false;  // the barrier's OR
      step([&](int t) {
        masks = wf_clamps(g, bf, valid, f, t) || masks;
      });
      step([&](int t) {
        if (masks) wf_masks(g, s, bf, t);
        if (K::kRowScans) wf_reduce<T, OP, SEG>(g, s, bf, t);
      });
      step([&](int t) {
        if (masks) wf_words(g, s, t);
        if (K::kRowScans) wf_carries<T, OP, SEG>(g, s, t);
      });
      if (K::kRowScans)
        step([&](int t) { wf_rescan<T, OP, SEG>(g, s, bf, t); });
      step([&](int t) { wf_rows<T, OP, SEG>(g, s, bf, t, masks); });
      step([&](int t) { wf_store(g, s, out, ok, t); });
    }
    if (!std::equal(guard.begin(), guard.end(), base + bytes)) return 2;
  }
  return 0;
}

template <typename T, int OP>
static int tiles_seg(const void* v, const uint8_t* valid, const uint8_t* f,
                     void* out, uint8_t* ok, int64_t n, int32_t lo,
                     int32_t hi, int nt, int blocks, unsigned seed) {
  return wf_segmented(OP, lo, hi)
             ? tiles<T, OP, true>(v, valid, f, out, ok, n, lo, hi, nt,
                                  blocks, seed)
             : tiles<T, OP, false>(v, valid, f, out, ok, n, lo, hi, nt,
                                   blocks, seed);
}

template <typename T>
static int tiles_op(int op, const void* v, const uint8_t* valid,
                    const uint8_t* f, void* out, uint8_t* ok, int64_t n,
                    int32_t lo, int32_t hi, int nt, int blocks,
                    unsigned seed) {
  switch (op) {
    case WF_SUM: return tiles_seg<T, WF_SUM>(v, valid, f, out, ok, n, lo,
                                             hi, nt, blocks, seed);
    case WF_COUNT: return tiles_seg<T, WF_COUNT>(v, valid, f, out, ok, n,
                                                 lo, hi, nt, blocks, seed);
    case WF_AVG: return tiles_seg<T, WF_AVG>(v, valid, f, out, ok, n, lo,
                                             hi, nt, blocks, seed);
    case WF_MIN: return tiles_seg<T, WF_MIN>(v, valid, f, out, ok, n, lo,
                                             hi, nt, blocks, seed);
    case WF_MAX: return tiles_seg<T, WF_MAX>(v, valid, f, out, ok, n, lo,
                                             hi, nt, blocks, seed);
  }
  return 3;
}

extern "C" int wf_tile_host(const void* v, const uint8_t* valid,
                            const uint8_t* f, void* out, uint8_t* ok,
                            int64_t n, int32_t lo, int32_t hi, int op,
                            int is_float, int nt, int blocks,
                            unsigned seed) {
  return is_float ? tiles_op<double>(op, v, valid, f, out, ok, n, lo, hi,
                                     nt, blocks, seed)
                  : tiles_op<int64_t>(op, v, valid, f, out, ok, n, lo, hi,
                                      nt, blocks, seed);
}

extern "C" int wf_host(const void* v, const uint8_t* valid,
                       const uint8_t* f, void* out, uint8_t* ok, int64_t n,
                       int32_t lo, int32_t hi, int op, int is_float) {
  return is_float ? by_op<double>(op, v, valid, f, out, ok, n, lo, hi)
                  : by_op<int64_t>(op, v, valid, f, out, ok, n, lo, hi);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("window_frame_host")
    src = d / "wf_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "libwf_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.wf_host.argtypes = [p, p, p, p, p, ctypes.c_int64, i32, i32,
                            ctypes.c_int, ctypes.c_int]
    lib.wf_pick.argtypes = [i32, i32]
    lib.wf_host.restype = ctypes.c_int
    lib.wf_tile_host.argtypes = [p, p, p, p, p, ctypes.c_int64, i32, i32,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_uint]
    lib.wf_tile_host.restype = ctypes.c_int
    return lib


def _special_values(rng, n: int, kind: str):
    if kind == "int":
        vd = rng.randint(-1000, 1000, n).astype(np.int64)
        big = np.iinfo(np.int64)
        vd[rng.rand(n) < 0.05] = big.max        # sums wrap
        vd[rng.rand(n) < 0.05] = big.min
        return vd
    vd = rng.uniform(-100, 100, n)
    for x, share in ((np.inf, 0.03), (-np.inf, 0.03), (np.nan, 0.03),
                     (-0.0, 0.05), (0.0, 0.03), (1e300, 0.02)):
        vd[rng.rand(n) < share] = x
    return vd


@pytest.mark.parametrize("how,kind", [
    (how, kind) for how in sorted(OPS) for kind in ("int", "float")
    if not (how == "avg" and kind == "int")])    # avg takes doubles
@pytest.mark.parametrize("lo,hi", [(-2, 0), (-100, 0), (-3, 2), (2, 5),
                                   (3, 1), (-4, -1), (-1, 40)])
def test_row_logic_matches_plain_window_frame(host_lib, how, lo, hi, kind):
    """csrc/window_frame_row.cuh built by g++ and run row by row as the
    chunked instance runs it, against the plain version and the wrapper
    on the CPU, bit for bit: +-inf, NaN, -0.0, NULLs, int64 sums that
    wrap, empty frames (lo > hi), frames wholly before or after the row,
    and frames past a partition's ends, found by chunks of 32 rows (the
    flags start off an 8-byte boundary)."""
    rng = np.random.RandomState(abs(lo * 13 + hi))
    n = 2500
    # 200 partitions: many shorter than 8 rows, so one word of flags
    # often holds two partition starts
    _, _, flags = _sorted_partitions(rng, n, 200)
    vd = _special_values(rng, n, kind)
    vv = rng.rand(n) > 0.1
    args = [torch.from_numpy(x) for x in (vd, vv, flags)]
    want, wok = window_frame_reference(*args, lo, hi, how)
    got, gok = window_frame(*args, lo, hi, how)
    assert torch.equal(gok, wok)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    out = np.zeros(n, dtype=want.numpy().dtype)
    ok = np.zeros(n, dtype=np.uint8)
    vd_c = np.ascontiguousarray(vd)
    vv_c = vv.astype(np.uint8)
    fl_c = np.zeros(n + 8, np.uint8)[3:3 + n]     # off 8-byte alignment
    fl_c[:] = flags
    rc = host_lib.wf_host(vd_c.ctypes.data, vv_c.ctypes.data,
                          fl_c.ctypes.data, out.ctypes.data, ok.ctypes.data,
                          n, lo, hi, OPS[how], int(kind == "float"))
    assert rc == 0
    np.testing.assert_array_equal(ok.astype(bool), wok.numpy())
    np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))


#: the tiled instance's halo (csrc/window_frame_tile.cuh WF_HALO_MAX)
HALO_MAX = 1024


def _tile_case(n: int, seed: int, kind: str, tile_rows: int):
    """n sorted rows in partitions mostly shorter than 32 rows, with a
    partition start on every third tile edge and on the row after one,
    and the special values of ``_special_values``."""
    rng = np.random.RandomState(seed)
    _, _, flags = _sorted_partitions(rng, n, max(n // 12, 1)) if n > 1 \
        else (None, None, np.ones(1, bool))
    flags[::3 * tile_rows] = True
    flags[tile_rows + 1::5 * tile_rows] = True
    return _special_values(rng, n, kind), rng.rand(n) > 0.1, flags


def _aligned16(n: int, dtype) -> np.ndarray:
    """A zeroed vector of n elements whose data is 16-byte aligned."""
    raw = np.zeros(n + 16, dtype=dtype)
    off = (-raw.ctypes.data % 16) // raw.itemsize
    return raw[off:off + n]


def _tile_run(host_lib, vd, vv, flags, lo, hi, how, kind, nt, seed=0,
              blocks=3, aligned=False):
    """The tile logic on the host; its flags 5 bytes off a 16-byte
    boundary (every tile then builds its bitmasks), or every input
    16-byte aligned (``aligned``: interior tiles without a clamp skip
    them)."""
    n = len(vd)
    out_t = np.int64 if how == "count" or (kind == "int" and how != "avg") \
        else np.float64
    out = _aligned16(n, out_t)
    ok = _aligned16(n, np.uint8)
    vd_c = _aligned16(n, vd.dtype)
    vd_c[:] = vd
    vv_c = _aligned16(n, np.uint8)
    vv_c[:] = vv
    fl_c = _aligned16(n, np.uint8) if aligned \
        else np.zeros(n + 8, np.uint8)[5:5 + n]
    fl_c[:] = flags
    rc = host_lib.wf_tile_host(vd_c.ctypes.data, vv_c.ctypes.data,
                               fl_c.ctypes.data, out.ctypes.data,
                               ok.ctypes.data, n, lo, hi, OPS[how],
                               int(kind == "float"), nt, blocks, seed)
    return rc, out, ok.astype(bool)


@pytest.mark.parametrize("how,kind", [
    (how, kind) for how in sorted(OPS) for kind in ("int", "float")
    if not (how == "avg" and kind == "int")])
@pytest.mark.parametrize("lo,hi", [(-2, 0), (-100, 0), (-3, 2), (2, 5),
                                   (3, 1), (-4, -1), (-1, 40),
                                   (-HALO_MAX, 2)])
@pytest.mark.parametrize("nt", [16, 256])
def test_tile_logic_matches_plain_window_frame(host_lib, how, kind, lo, hi,
                                               nt):
    """csrc/window_frame_tile.cuh built by g++ and run as the tiled
    kernel runs it (tiles in a shuffled order, each step's threads in a
    shuffled order, shared memory full of junk), against the plain
    version bit for bit: tiles of 80 rows (16 threads) and 1,280 (the
    card's 256), partitions shorter than the frame, partition starts on
    tile edges, lo > 0 and hi < 0, an empty frame (lo > hi), the widest
    halo, a ragged last tile, NULLs, NaN, +-inf, -0.0 and int64 sums
    that wrap."""
    n = 2500
    vd, vv, flags = _tile_case(n, abs(lo * 7 + hi) + nt, kind, nt * 5)
    args = [torch.from_numpy(x) for x in (vd, vv, flags)]
    want, wok = window_frame_reference(*args, lo, hi, how)
    rc, out, ok = _tile_run(host_lib, vd, vv, flags, lo, hi, how, kind, nt,
                            seed=nt + lo)
    assert rc == 0
    np.testing.assert_array_equal(ok, wok.numpy())
    np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))


@pytest.mark.parametrize("how,kind", [
    (how, kind) for how in sorted(OPS) for kind in ("int", "float")
    if not (how == "avg" and kind == "int")])
@pytest.mark.parametrize("lo,hi", [(-2, 0), (-100, 0), (2, 5), (-4, -1),
                                   (-16, 0)])
@pytest.mark.parametrize("nulls", [False, True])
def test_tile_logic_without_clamps(host_lib, how, kind, lo, hi, nulls):
    """Tiles with no NULL and no partition start (a block skips its
    bitmasks: 16-byte aligned inputs) beside tiles with one, on 16
    threads (80-row tiles): six partitions in 3,000 rows, one starting
    at the second staged row of the tile from row 2,400 for lo = -16
    (row 2,385), special values, and every row valid or three NULLs."""
    rng = np.random.RandomState(abs(lo) + hi)
    n = 3000
    vd = _special_values(rng, n, kind)
    flags = np.zeros(n, bool)
    flags[[0, 700, 1601, 1602, 2385, 2689]] = True
    vv = np.ones(n, bool)
    if nulls:
        vv[[150, 1234, 2950]] = False
    args = [torch.from_numpy(x) for x in (vd, vv, flags)]
    want, wok = window_frame_reference(*args, lo, hi, how)
    rc, out, ok = _tile_run(host_lib, vd, vv, flags, lo, hi, how, kind, 16,
                            aligned=True)
    assert rc == 0
    np.testing.assert_array_equal(ok, wok.numpy())
    np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))


@pytest.mark.parametrize("n", [1, 7, 80, 81, 1281])
@pytest.mark.parametrize("how", ["sum", "max", "count"])
def test_tile_logic_on_short_inputs(host_lib, n, how):
    """Inputs shorter than a tile, or a row past a whole tile (16 and 256
    threads: 80 and 1,280 rows), bit for bit against the plain
    version."""
    for nt in (16, 256):
        vd, vv, flags = _tile_case(n, n, "float", nt * 5)
        args = [torch.from_numpy(x) for x in (vd, vv, flags)]
        want, wok = window_frame_reference(*args, -3, 1, how)
        rc, out, ok = _tile_run(host_lib, vd, vv, flags, -3, 1, how,
                                "float", nt)
        assert rc == 0
        np.testing.assert_array_equal(ok, wok.numpy())
        np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))


def test_tiled_instance_stops_at_the_halo(host_lib):
    """The launch tiles a frame reaching at most HALO_MAX rows back and
    forward, and takes the chunked instance past it. The tile logic
    refuses a frame past the halo, and so does the wrapper asked for the
    tiled instance there."""
    lim = HALO_MAX
    tile, chunks = SEARCHES["tile"], SEARCHES["chunks"]
    for lo, hi, want in ((-2, 0, tile), (-lim, lim, tile), (5000, 3, tile),
                         (-40, -lim - 33, tile), (-lim - 1, 0, chunks),
                         (0, lim + 1, chunks),
                         (-lim - 20, -lim - 1, chunks)):
        assert host_lib.wf_pick(lo, hi) == want, (lo, hi)
    vd, vv, flags = _tile_case(300, 1, "float", 80)
    assert _tile_run(host_lib, vd, vv, flags, -lim - 1, 0, "sum", "float",
                     16)[0] == 1
    args = [torch.from_numpy(x) for x in (vd, vv, flags)]
    with pytest.raises(ValueError, match="halo"):
        window_frame(*args, -lim - 1, 0, "sum", "tile")
    got, ok = window_frame(*args, -lim, 0, "sum", "tile")
    want, wok = window_frame_reference(*args, -lim, 0, "sum")
    assert torch.equal(ok, wok)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


def _bits(x: np.ndarray) -> np.ndarray:
    """A float array's bits with every NaN as one NaN (a NaN's sign and
    payload depend on the processor and on which operand the compiler
    puts first: IEEE leaves them open), an integer array as it is."""
    if x.dtype.kind != "f":
        return x
    return np.where(np.isnan(x), np.nan, x).view(np.int64)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 14 references, held to the port on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_window_rung_reference():
    """chip_smoke's copy of bench.py's table generator, and its row-order
    frame sums, equal the port's rung bit for bit."""
    import chip_smoke
    t = chip_smoke.gen_window_table(3000)
    ref = _rung_table(3000)
    for c in ("p", "o", "v"):
        np.testing.assert_array_equal(t[c], ref.column(c).to_numpy())
    want = chip_smoke.window_rung_numpy(t)[3]
    got = chip_smoke.window_rung(PORT.session().create_dataframe(t), PF) \
        .collect_numpy()
    np.testing.assert_array_equal(np.asarray(got["wsum"]).view(np.int64),
                                  want.view(np.int64))


def test_chip_smoke_store_sales_windows_reference():
    """chip_smoke's numpy form of its store_sales windows (row_number,
    lag, the RANGE-default running sum in exact cents) equals the port's
    on a small store_sales."""
    import chip_smoke
    ss = chip_smoke.gen_store_sales(6000)
    want = chip_smoke.ss_windows_numpy(ss)
    got = chip_smoke.ss_windows(PORT.session().create_dataframe(ss), PF) \
        .collect_numpy()
    np.testing.assert_array_equal(np.asarray(got["rn"]), want["rn"])
    lg = got["lg"]
    np.testing.assert_array_equal(~np.ma.getmaskarray(lg), want["lg_valid"])
    np.testing.assert_array_equal(np.asarray(lg)[want["lg_valid"]],
                                  want["lg"][want["lg_valid"]])
    np.testing.assert_allclose(np.asarray(got["rs"]), want["rs"],
                               rtol=chip_smoke.REL_TOL)


def test_column_pruning_reaches_through_window():
    """A projection above a window narrows the scan below it to the
    columns the parent and the window expressions read, drops window
    columns nobody reads, and changes no output."""
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.overrides import prune_columns
    rng = np.random.RandomState(8)
    t = {"p": rng.randint(0, 4, 200), "o": rng.permutation(200),
         "v": rng.uniform(-1, 1, 200), "x": rng.randint(0, 9, 200),
         "y": rng.rand(200)}
    df = PORT.session().create_dataframe(t) \
        .with_window_column("w", PA.Sum(PCol("v")), partition_by=["p"],
                            order_by=["o"], frame=("rows", -1, 1)) \
        .with_window_column("unused", PW.RowNumber(), order_by=["y"])
    out = df.select("x", "w")
    pruned = prune_columns(out.plan)
    node = pruned
    while not isinstance(node, L.LogicalScan):
        if isinstance(node, L.Window):
            assert [n for _, _, n in node.window_exprs] == ["w"]
        node = node.children[0]
    assert set(node.columns) == {"p", "o", "v", "x"}
    got = out.collect_numpy()
    full = df.collect_numpy()
    np.testing.assert_array_equal(np.asarray(got["w"]), np.asarray(full["w"]))
    np.testing.assert_array_equal(np.asarray(got["x"]), t["x"])
