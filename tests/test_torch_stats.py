"""The moment aggregates (var_pop, var_samp, stddev_pop, stddev_samp) on
the port against the reference, on each route of the aggregate exec:
the dense route (dictionary string keys: two ``dense_groupby`` calls a
batch, the values, then each value less its group's mean and its
square), the sort route (integer keys, or more value columns than the
kernel takes) and the keyless route; across batch splits, with NULLs,
groups of one row and all-NULL groups; by their SQL names.

Tolerance: a relative 1e-9 against the reference. The port sums values
shifted by their group's mean, the reference the raw values, and takes
``s2 - n*mean^2``, which loses about log10(mean^2 / var) digits; the
columns here keep that loss under 1e-9. The cancellation case itself
(values 1e9 + 1, 2, 3) is held to Spark's answer, 2/3, and so is a group
of one row: 0 for the population forms, where the reference's
cancellation can leave a tiny positive variance (1.6e-7 for a stddev).
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exec import aggregate as PA

from test_torch_slice import prebuild_reference_native
from torch_compare import OFF, frames_equal, run_both

N = 3000
_AGGS = ("var_pop", "var_samp", "stddev_pop", "stddev")


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _table(seed: int = 0) -> pa.Table:
    rng = np.random.RandomState(seed)
    k = rng.choice(["a", "b", "c", "d", "e"], N).astype(object)
    k[:3] = ["solo", "nul", "nul"]          # one row; all NULL
    g = rng.randint(0, 40, N)
    g[:3] = [1000, 1001, 1001]
    v = rng.standard_normal(N) * 50 + 20
    vn = rng.rand(N) < 0.1
    vn[0] = False
    vn[1:3] = True
    q = rng.randint(1, 101, N)
    return pa.table({"k": k, "g": g, "v": pa.array(v, mask=vn),
                     "q": pa.array(q.astype(np.int32)),
                     "f": pa.array(v.astype(np.float32), mask=vn)})


def _check(got: pa.Table, ref: pa.Table, key=None) -> None:
    """The port equal to the reference but in the group of one row, which
    is held to Spark's answer."""
    if key is not None:
        solo = np.asarray(got.column(key).to_pylist()) == (
            "solo" if key == "k" else 1000)
        row = got.filter(pa.array(solo)).to_pylist()[0]
        for name, v in row.items():
            if name.startswith(("var_pop", "stddev_pop")):
                assert v == 0.0, name
            elif name.startswith(("var_samp", "stddev_")):
                assert v is None, name
        got, ref = (x.filter(pa.array(~solo)) for x in (got, ref))
    frames_equal(got, ref, approx=True)


def _aggs(F, cols=("v", "q", "f")):
    out = []
    for c in cols:
        for a in _AGGS:
            out.append(getattr(F, a)(F.col(c)).with_name(f"{a}_{c}"))
    return out


@pytest.mark.parametrize("batch_rows", [None, 512])
@pytest.mark.parametrize("route", ["dense", "sort", "keyless"])
def test_moments_equal_reference(route, batch_rows):
    key = {"dense": "k", "sort": "g"}.get(route)

    def build(df, F, E):
        if key is None:
            return df.agg(*_aggs(F))
        return df.group_by(key).agg(*_aggs(F, ("v", "q"))).order_by(key)
    ref, got = run_both(_table(1), build, batch_rows=batch_rows)
    _check(got, ref, key)


def test_dense_route_carries_moments_and_sort_route_past_16_columns(
        monkeypatch):
    """Eight moment aggregates over v and q take seven value columns: two
    counts (one a validity) and five columns of values (v's four share
    one float64 column, q's four each convert their own). Two dense calls
    a batch, the second with two shifted columns for each of the five.
    Over v, q and f the second would need eighteen, past the kernel's 16:
    the sort route takes the batch (the same answers)."""
    calls = []
    real = PA.dense_groupby

    def counting(*a, **k):
        calls.append(len(a[4]))
        return real(*a, **k)
    monkeypatch.setattr(PA, "dense_groupby", counting)
    t = _table(2)
    for cols, want_calls in ((("v", "q"), 12), (("v", "q", "f"), 0)):
        calls.clear()
        ref, got = run_both(t, lambda df, F, E: df.group_by("k").agg(
            *_aggs(F, cols)).order_by("k"), batch_rows=512)
        _check(got, ref, "k")
        assert len(calls) == want_calls, (cols, calls)
        assert calls == [7, 10] * (want_calls // 2), calls


def test_cancellation_follows_spark():
    """var_pop of 1e9+1, 1e9+2, 1e9+3 is 2/3 (Spark). The reference's
    s2 - n*mean^2 cancels (its answer is 0 here); the port's shifted sums
    do not, on every route."""
    vals = [1e9 + 1, 1e9 + 2, 1e9 + 3]
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({"x": vals, "k": ["a"] * 3,
                                      "g": [7] * 3}))
    for q in (df.agg(PF.var_pop(PF.col("x")).with_name("o")),
              df.group_by("k").agg(PF.var_pop(PF.col("x")).with_name("o")),
              df.group_by("g").agg(PF.var_pop(PF.col("x")).with_name("o"))):
        got = q.collect()[0]["o"]
        assert abs(got - 2 / 3) <= 1e-9, got
    got = df.agg(PF.stddev(PF.col("x")).with_name("o")).collect()[0]["o"]
    assert abs(got - 1.0) <= 1e-9


@pytest.mark.parametrize("batch_rows", [None, 2, 4])
@pytest.mark.parametrize("route", ["dense", "sort", "keyless"])
def test_cancellation_follows_spark_per_group(route, batch_rows):
    """The shift is each group's own: a group of small values first, then
    a group at 1e9 + 1, 2, 3, 2 (in batches of 2 and 4 its partials carry
    different shifts and merge). Both groups' var_pop follow Spark: 2/3
    and 1/2. Keyless, the small values come first and are filtered out."""
    x = [1.0, 2.0, 3.0, 1e9 + 1, 1e9 + 2, 1e9 + 3, 1e9 + 2]
    k = ["b"] * 3 + ["a"] * 4
    conf = dict(OFF) if batch_rows is None else {
        **OFF, "spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    s = TorchSession(conf, device="cpu")
    df = s.create_dataframe(pa.table({"x": x, "k": k,
                                      "g": [2 if c == "b" else 1
                                            for c in k]}))
    aggs = (PF.var_pop(PF.col("x")).with_name("vp"),
            PF.stddev_samp(PF.col("x")).with_name("ss"))
    want = {"a": (0.5, math.sqrt(2 / 3)), "b": (2 / 3, 1.0)}
    if route == "keyless":
        rows = df.filter(PF.col("k") == PF.lit("a")).agg(*aggs).collect()
        got = {"a": rows[0]}
    else:
        key = "k" if route == "dense" else "g"
        rows = df.group_by(key).agg(*aggs).collect()
        got = {(r[key] if key == "k" else "ab"[r[key] - 1]): r
               for r in rows}
    assert set(got) == ({"a"} if route == "keyless" else {"a", "b"})
    for name, r in got.items():
        vp, ss = want[name]
        assert abs(r["vp"] - vp) <= 1e-9, (name, r)
        assert abs(r["ss"] - ss) <= 1e-9, (name, r)


@pytest.mark.parametrize("ok,live,want_rows,want_has", [
    # segments start at rows 0, 3, 5; live rows 0..6
    ([0, 0, 0, 1, 1, 0, 0, 1], 7, [0, 3, 0], [False, True, False]),
    ([1, 1, 0, 0, 0, 0, 1, 0], 7, [0, 0, 6], [True, False, True]),
    ([0] * 8, 7, [0, 0, 0], [False] * 3),
])
def test_first_row_of_each_segment(ok, live, want_rows, want_has):
    """The shift's row on the sort and keyless routes: each segment's
    first live row where the mask holds; row 7 is not live."""
    import torch
    from spark_rapids_tpu_torch.columnar.segmented import (
        GlobalSegments, SortedSegments)
    flags = torch.zeros(8, dtype=torch.bool)
    flags[[0, 3, 5]] = True
    live_t = torch.arange(8) < live
    okt = torch.tensor(ok, dtype=torch.bool)
    rows, has = SortedSegments(flags, live_t).first(okt)
    assert rows.tolist() == want_rows and has.tolist() == want_has
    rows, has = GlobalSegments(live_t).first(okt)
    first = [i for i in range(live) if ok[i]]
    assert has.tolist() == [bool(first)]
    assert rows.tolist() == [first[0] if first else 0]
    rows, has = GlobalSegments(live_t[:0]).first(okt[:0])
    assert rows.tolist() == [0] and has.tolist() == [False]


def test_moments_recollect_and_reuse():
    """A second collect, and another query over other values with the
    same aggregate objects, agree with numpy: nothing an execution sees
    stays in the aggregate."""
    s = TorchSession({**OFF, "spark.rapids.tpu.sql.batchSizeRows": 3},
                     device="cpu")
    agg = PF.var_samp(PF.col("x")).with_name("o")
    a = s.create_dataframe(pa.table({"x": pa.array(
        [None, None, None, 1e12, 1e12 + 2, 1e12 + 7, 1e12 + 9])}))
    b = s.create_dataframe(pa.table({"x": [-5.0, 1.0, 2.0, 4.0]}))
    want_a = np.var([1e12, 1e12 + 2, 1e12 + 7, 1e12 + 9], ddof=1)
    for _ in range(2):
        assert abs(a.agg(agg).collect()[0]["o"] - want_a) <= 1e-9 * want_a
        assert b.agg(agg).collect()[0]["o"] == pytest.approx(
            np.var([-5.0, 1.0, 2.0, 4.0], ddof=1), rel=1e-12)


def test_sql_names_equal_reference():
    sql = ("SELECT k, stddev(v) a, stddev_samp(v) b, stddev_pop(v) c, "
           "variance(v) d, var_samp(q) e, var_pop(q) f, count(*) n "
           "FROM t GROUP BY k ORDER BY k")
    ref, got = run_both(_table(3), sql=sql)
    solo = np.asarray(got.column("k").to_pylist()) == "solo"
    assert got.filter(pa.array(solo)).to_pylist()[0]["c"] == 0.0
    frames_equal(*(x.filter(pa.array(~solo)) for x in (got, ref)),
                 approx=True)


@pytest.mark.parametrize("case", ["stddev_single_row_null",
                                  "var_pop_single_row_zero"])
def test_spark_semantics_stats_cases(case):
    """The statistics cases of tests/test_spark_semantics.py, with the
    port's F."""
    s = TorchSession(OFF, device="cpu")
    F = PF
    cases = {
        "stddev_single_row_null": (lambda: s.create_dataframe(
            pa.table({"v": [5.0]})).agg(
            F.stddev(F.col("v")).with_name("o")), [None]),
        "var_pop_single_row_zero": (lambda: s.create_dataframe(
            pa.table({"v": [5.0]})).agg(
            F.var_pop(F.col("v")).with_name("o")), [0.0]),
    }
    build, want = cases[case]
    assert [r["o"] for r in build().collect()] == want


def test_moments_of_nan_inf_and_over_a_window_refused():
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({"x": [1.0, math.nan, 2.0],
                                      "y": [1.0, math.inf, 2.0]}))
    r = df.agg(PF.var_pop(PF.col("x")).with_name("a"),
               PF.stddev(PF.col("y")).with_name("b")).collect()[0]
    assert math.isnan(r["a"]) and math.isnan(r["b"])
    with pytest.raises(NotImplementedError, match="later windows slice"):
        df.with_window_column("w", PF.stddev(PF.col("x")),
                              order_by=["y"]).collect()


@pytest.mark.parametrize("query", ["a_dataframe", "a_sql", "b_sql",
                                   "c_dataframe"])
def test_chip_smoke_phase15_queries_equal_reference(query):
    """chip_smoke.py phase 15's queries (a)-(c) at 20,000 rows in four
    batches, on both packages and against the script's numpy forms."""
    import chip_smoke as C
    data = C.gen_lineitem(20_000)
    t = pa.table(data)
    kind = query.split("_")[0]
    if query == "a_dataframe":
        ref, got = run_both(t, lambda df, F, E: C.q_stats(df, F),
                            batch_rows=5_000)
    elif query == "c_dataframe":
        ref, got = run_both(t, lambda df, F, E: C.q_hashes(df, F),
                            batch_rows=5_000)
    else:
        text = C.STATS_SQL if kind == "a" else C.SCALAR_SQL
        ref, got = run_both(t, sql=text.replace("FROM lineitem", "FROM t"),
                            batch_rows=5_000)
    rows = got.to_pylist()
    if kind == "a":
        frames_equal(got, ref, approx=True)
        assert C.grouped_stats_equal(rows, C.grouped_stats_numpy(data))
    elif kind == "b":
        frames_equal(got, ref, approx=True)
        assert C.scalar_equal(rows[0], C.scalar_numpy(data))
    else:
        frames_equal(got, ref)
        assert rows == [C.hashes_numpy(data)]
