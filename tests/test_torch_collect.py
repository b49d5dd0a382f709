"""collect_list, collect_set, min_by, max_by, percentile and
approx_percentile of the port against the JAX package, on the CPU.

* Keyed (an integer key, a string key: the sort route, and the dense
  route for ``percentile``, whose partial is a count) and keyless, over
  seeded values with NULLs, in one batch and in 64-row batches (partials
  merged across batches), on both packages over one Arrow table (the
  reference runs these on its host engine, pandas). ``collect_list``
  compares exactly and in arrival order; ``collect_set``'s order is
  unspecified, so its sets are sorted; ``min_by``/``max_by`` exactly;
  ``percentile`` within 4 ulps of the reference's, which interpolates
  through ``np.percentile`` (``lo + (hi - lo) * frac``) where the port
  takes Spark's ``(hi - pos) * v[lo] + (pos - lo) * v[hi]``; against
  Spark's formula in numpy the port is exact.
* The reference's own cases (tests/test_expr_breadth.py
  ``test_collect_minby_percentile_aggs`` and
  ``test_approx_percentile_exact``) on the port.
* Where the port follows Spark and the reference does not (ROADMAP.md
  Queue C): ``min_by``/``max_by`` rank a NaN ordering greatest where the
  reference skips it; ``percentile`` keeps NaN as the greatest value
  where the reference drops it. ``collect_set`` keeps one NaN and takes
  -0.0 and 0.0 as one value, as the reference does.
* A group of more than 256 values raises for ``collect_list`` and
  ``collect_set``, naming "slice 9b, the rest" (a list is never cut
  short), as does a list of lists; ``percentile`` orders its values
  through the out-of-core sort past a 2 KiB ``batchSizeBytes``.
* ``percentile`` by a key of about 600 groups (integer, and float with
  -0.0 beside 0.0 and two NaN payloads) at a 2 KiB ``batchSizeBytes``
  under a 32 KiB device budget: the merge splits by partition, every
  group equals Spark's definition exactly, nothing stays held; a value
  stream sorted in another order than the merged groups raises.
* chip_smoke.py phase 17's queries (a)-(f) at 20,000 lineitem rows, on
  the port against the script's numpy forms.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from torch_compare import run_both, within_ulps
from spark_rapids_tpu.exprs import aggregates as RA
from spark_rapids_tpu.exprs.base import ColumnRef as RC
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exprs import aggregates as PA
from spark_rapids_tpu_torch.exprs.base import ColumnRef as PC

from test_torch_structs import same

SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 64,
         "spark.rapids.tpu.sql.batchSizeBytes": 2048}
NAN = float("nan")


def table(n: int = 400, seed: int = 3) -> pa.Table:
    rng = np.random.RandomState(seed)
    v = rng.randint(-20, 20, n).astype(float)
    return pa.table({
        "k": pa.array(rng.randint(0, 6, n), pa.int64()),
        "s": pa.array(np.array(["x", "y", "z"], object)[rng.randint(0, 3,
                                                                   n)]),
        "v": pa.array(np.where(rng.rand(n) < 0.1, None, v).tolist(),
                      pa.float64()),
        "q": pa.array(np.where(rng.rand(n) < 0.1, None,
                               rng.randint(0, 9, n)).tolist(), pa.int32()),
        "o": pa.array(np.where(rng.rand(n) < 0.1, None,
                               rng.randint(0, 1000, n) * 0.5).tolist()),
        "i": pa.array(np.arange(n), pa.int64()),
    })


def _mods(F):
    return (RA, RC) if F.__name__.startswith("spark_rapids_tpu.") \
        else (PA, PC)


def aggs(F):
    A, C = _mods(F)
    return [A.CollectList(C("q")).with_name("cl"),
            A.CollectSet(C("q")).with_name("cs"),
            A.MinBy(C("i"), C("o")).with_name("mnb"),
            A.MaxBy(C("q"), C("o")).with_name("mxb"),
            A.Percentile(C("v"), 0.5).with_name("p50"),
            A.Percentile(C("q"), 0.9).with_name("p90"),
            A.ApproximatePercentile(C("v"), 0.25).with_name("ap25")]


def check(port: pa.Table, ref: pa.Table) -> None:
    assert port.column_names == ref.column_names
    for name in port.column_names:
        got, want = (t.column(name).to_pylist() for t in (port, ref))
        if name == "cs":
            got = [sorted(x) for x in got]
            want = [sorted(x) for x in want]
        if name.startswith(("p", "ap")):
            assert [g is None for g in got] == [w is None for w in want]
            within_ulps([g for g in got if g is not None],
                        [w for w in want if w is not None], 4, name)
        else:
            assert same(got, want), name


CASES = {
    "by_int_key": lambda df, F, E: df.group_by("k").agg(*aggs(F))
    .order_by("k"),
    "by_string_key": lambda df, F, E: df.group_by("s").agg(*aggs(F))
    .order_by("s"),
    "keyless": lambda df, F, E: df.filter(F.col("k") == F.lit(2))
    .agg(*aggs(F)),
}


@pytest.mark.parametrize("batch_rows", [None, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_collect_and_order_aggregates_equal_reference(case, batch_rows):
    conf = SMALL if batch_rows else None
    ref, port = run_both(table(), CASES[case], conf=conf,
                         batch_rows=batch_rows)
    check(port, ref)


def test_percentile_takes_the_dense_route_and_spark_formula(monkeypatch):
    """A count partial: a dictionary key's percentile takes the dense
    route (one dense_groupby call a batch); each group equals Spark's
    interpolation in numpy exactly."""
    from spark_rapids_tpu_torch.exec import aggregate as agg_exec
    calls = []
    plain = agg_exec.dense_groupby

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)
    monkeypatch.setattr(agg_exec, "dense_groupby", counted)
    t = table(500, seed=8)
    s = TorchSession(SMALL, device="cpu")
    df = s.create_dataframe(t).group_by("s").agg(
        PF.percentile(PF.col("v"), 0.3).with_name("p"),
        PF.count(PF.col("v")).with_name("n")).order_by("s")
    got = df.collect()
    assert len(calls) == -(-500 // 64)
    v = np.array(t.column("v").to_pylist(), dtype=object)
    keys = np.array(t.column("s").to_pylist(), dtype=object)
    for r in got:
        vals = np.sort(np.array([x for x in v[keys == r["s"]]
                                 if x is not None], float))
        pos = 0.3 * (len(vals) - 1)
        lo, hi = math.floor(pos), math.ceil(pos)
        want = vals[lo] if lo == hi else \
            (hi - pos) * vals[lo] + (pos - lo) * vals[hi]
        assert r["p"] == want and r["n"] == len(vals)
    agg = s.last_plan
    while type(agg).__name__ != "TpuHashAggregateExec":
        agg = agg.children[0]
    assert agg.last_stream_buckets and agg.last_stream_buckets[0] > 1


def test_reference_battery_on_the_port():
    """tests/test_expr_breadth.py's two cases."""
    s = TorchSession(device="cpu")
    t = pa.table({"g": pa.array([1, 1, 1, 2, 2]),
                  "v": pa.array([3, 1, 3, None, 7], type=pa.int64()),
                  "o": pa.array([0.5, 2.0, 1.0, 9.0, 3.0])})
    out = s.create_dataframe(t).group_by("g").agg(
        PF.collect_list(PF.col("v")).with_name("cl"),
        PF.collect_set(PF.col("v")).with_name("cs"),
        PF.min_by(PF.col("v"), PF.col("o")).with_name("mnb"),
        PF.max_by(PF.col("v"), PF.col("o")).with_name("mxb"),
        PF.percentile(PF.col("v"), 0.5).with_name("p50")) \
        .collect_arrow().to_pydict()
    rows = {g: (cl, sorted(cs), mnb, mxb, p)
            for g, cl, cs, mnb, mxb, p in zip(
                out["g"], out["cl"], out["cs"], out["mnb"], out["mxb"],
                out["p50"])}
    assert rows[1] == ([3, 1, 3], [1, 3], 3, 1, 3.0)
    assert rows[2][0] == [7] and rows[2][2] == 7 and rows[2][3] is None
    assert rows[2][4] == 7.0
    t = pa.table({"v": pa.array([float(i) for i in range(101)])})
    got = s.create_dataframe(t).agg(PA.ApproximatePercentile(
        PC("v"), 0.5).with_name("p50")).collect()
    assert got[0]["p50"] == 50.0


NAN_T = pa.table({"g": pa.array([1, 1, 1, 1, 2, 2, 2]),
                  "v": pa.array([NAN, 0.0, -0.0, 1.0, NAN, 2.0, NAN]),
                  "o": pa.array([NAN, 1.0, 3.0, 2.0, 1.0, NAN, 5.0]),
                  "i": pa.array([0, 1, 2, 3, 4, 5, 6])})


def _nan_build(df, F, E):
    A, C = _mods(F)
    return df.group_by("g").agg(
        A.CollectSet(C("v")).with_name("cs"),
        A.CollectList(C("v")).with_name("cl"),
        A.MinBy(C("i"), C("o")).with_name("mnb"),
        A.MaxBy(C("i"), C("o")).with_name("mxb"),
        A.Percentile(C("v"), 0.5).with_name("p50"),
        A.Percentile(C("v"), 1.0).with_name("p100")).order_by("g")


def test_collect_set_nan_and_signed_zero_as_reference():
    ref, port = run_both(NAN_T, _nan_build)
    for c in ("cs", "cl", "mnb"):
        assert same(port.column(c).to_pylist(), ref.column(c).to_pylist())
    assert same(port.column("cs").to_pylist(), [[NAN, 0.0, 1.0],
                                               [NAN, 2.0]])


def test_max_by_nan_ordering_departure():
    """Spark ranks a NaN ordering greatest: max_by picks its row; the
    reference skips NaN orderings (``np.nanargmax``)."""
    ref, port = run_both(NAN_T, _nan_build)
    assert ref.column("mxb").to_pylist() == [2, 6]
    assert port.column("mxb").to_pylist() == [0, 5]


def test_percentile_nan_departure():
    """Spark keeps NaN as the greatest value: group 1 sorts as -0.0, 0.0,
    1.0, NaN (median 0.5, p100 NaN), group 2 as 2.0, NaN, NaN; the
    reference drops NaN (medians 0.0 and 2.0)."""
    ref, port = run_both(NAN_T, _nan_build)
    assert ref.column("p50").to_pylist() == [0.0, 2.0]
    assert ref.column("p100").to_pylist() == [1.0, 2.0]
    assert same(port.column("p50").to_pylist(), [0.5, NAN])
    assert same(port.column("p100").to_pylist(), [NAN, NAN])


def _spark_percentile(vals, p):
    """Spark's percentile of ``vals`` in numpy (NaN sorts greatest)."""
    vals = np.sort(np.asarray(vals, float))
    if not len(vals):
        return None
    pos = p * (len(vals) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    return vals[lo] if lo == hi else \
        (hi - pos) * vals[lo] + (pos - lo) * vals[hi]


def _canonical(k):
    """A group key as Spark groups it: -0.0 with 0.0, every NaN one."""
    return "nan" if isinstance(k, float) and math.isnan(k) else k


def _many_groups(key_type: str, n: int = 3000) -> pa.Table:
    rng = np.random.RandomState(11)
    k = rng.randint(0, 600, n)
    v = rng.randint(-500, 500, n) * 0.25
    vnull = rng.rand(n) < 0.1
    if key_type == "int":
        keys = pa.array(k, pa.int64(), mask=rng.rand(n) < 0.05)
    else:
        kf = k * 0.5 - 100.0
        kf[k == 200] = -0.0                  # and half of them 0.0
        kf[(rng.rand(n) < 0.5) & (k == 200)] = 0.0
        # two NaN payloads, one group
        kf[k == 7] = np.frombuffer(np.uint64(0x7FF8000000000001)
                                   .tobytes(), np.float64)[0]
        kf[k == 8] = np.nan
        keys = pa.array(kf, pa.float64(), mask=rng.rand(n) < 0.05)
    return pa.table({"k": keys,
                     "v": pa.array(np.where(vnull, None, v).tolist(),
                                   pa.float64())})


@pytest.mark.parametrize("key_type", ["int", "float"])
def test_percentile_of_many_groups_merges_by_partition_under_a_budget(
        key_type):
    """percentile by a key of about 600 groups (a NULL key among them) in
    64-row batches at a 2 KiB batchSizeBytes: the partials outgrow it, so
    they and the value streams are hash-split on the keys alike and each
    partition merges, sorts and picks alone. Under a 32 KiB device budget
    and a 16 KiB host store, with the leak audit on, every group equals
    Spark's interpolation in numpy exactly; float keys group -0.0 with
    0.0 and every NaN as one; nothing stays held after."""
    t = _many_groups(key_type)
    conf = {**SMALL, "spark.rapids.tpu.memory.hbm.limitBytes": 32 << 10,
            "spark.rapids.tpu.memory.host.spillStorageSize": 16 << 10,
            "spark.rapids.tpu.memory.leakDetection": True}
    with TorchSession(conf, device="cpu") as s:
        df = s.create_dataframe(t).group_by("k").agg(
            PF.percentile(PF.col("v"), 0.5).with_name("p50"),
            PF.percentile(PF.col("v"), 0.9).with_name("p90"),
            PF.count(PF.col("v")).with_name("n"))
        got = df.collect()
        agg = s.last_plan
        while type(agg).__name__ != "TpuHashAggregateExec":
            agg = agg.children[0]
        st = s.memory.stats()
    assert agg.last_repartitions > 1
    assert len(agg.last_stream_buckets) > 1
    assert st["spill_to_host_bytes"] > 0
    assert st["max_device_used"] <= 32 << 10
    assert st["device_used"] == st["host_used"] == st["disk_used"] == 0
    want = {}
    for k, v in zip(t.column("k").to_pylist(), t.column("v").to_pylist()):
        vals = want.setdefault(_canonical(k), [])
        if v is not None:
            vals.append(v)
    assert len(got) == len(want)
    for r in got:
        vals = want[_canonical(r["k"])]
        assert r["n"] == len(vals)
        for name, p in (("p50", 0.5), ("p90", 0.9)):
            assert r[name] == _spark_percentile(vals, p), (r["k"], name)


def test_group_order_disagreement_raises(monkeypatch):
    """The picks assume the sorted value stream holds the groups in the
    merged partials' order; a stream sorted in another order (here its
    sort turned descending) raises instead of giving each group
    another's values."""
    from spark_rapids_tpu_torch.plan import logical
    real = logical.SortOrder
    monkeypatch.setattr(logical, "SortOrder",
                        lambda e, asc=True, nf=None: real(e, not asc, nf))
    s = TorchSession(SMALL, device="cpu")
    df = s.create_dataframe(table()).group_by("k").agg(
        PF.percentile(PF.col("v"), 0.5).with_name("p50"))
    with pytest.raises(RuntimeError, match="disagree on the groups' order"):
        df.collect()


@pytest.mark.parametrize("fn", ["collect_list", "collect_set"])
def test_long_groups_raise_and_never_truncate(fn):
    s = TorchSession(SMALL, device="cpu")
    t = pa.table({"k": pa.array([1] * 300 + [2] * 5, pa.int64()),
                  "v": pa.array(np.arange(305), pa.int64())})
    with pytest.raises(NotImplementedError,
                       match=r"300 values .*slice 9b, the rest"):
        s.create_dataframe(t).group_by("k").agg(
            getattr(PF, fn)(PF.col("v")).with_name("c")).collect()
    # 256 fit: a set of 300 values with 200 distinct ones is too
    t = pa.table({"k": pa.array([1] * 256, pa.int64()),
                  "v": pa.array(np.arange(256), pa.int64())})
    got = s.create_dataframe(t).group_by("k").agg(
        getattr(PF, fn)(PF.col("v")).with_name("c")).collect()
    assert sorted(got[0]["c"]) == list(range(256))


def test_string_values_are_refused():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(table(16))
    # strings run since slice 9b's rest, first part
    # (tests/test_torch_string_lists.py); lists of them still wait
    for agg in (PF.collect_list(PF.array(PF.col("s"))),
                PF.min_by(PF.array(PF.col("s")), PF.col("o"))):
        with pytest.raises(NotImplementedError,
                           match="slice 9b, the rest"):
            df.group_by("k").agg(agg.with_name("c")).collect()


PHASE17 = ["a", "b", "c", "d_pos", "d_key", "d_outer", "e", "f", "g"]


@pytest.mark.parametrize("case", PHASE17)
def test_chip_smoke_phase17_queries_equal_numpy(case):
    """chip_smoke.py phase 17's queries at 20,000 lineitem rows in
    5,000-row batches (case f out of core at 64 KiB, case g's merge split
    by partition at 16 KiB), on the port against the script's numpy
    forms."""
    import chip_smoke as C
    from spark_rapids_tpu_torch.columnar import HostTable
    from spark_rapids_tpu_torch.types import INT32, Schema, StructField
    t = C.gen_lineitem(20_000)
    om = C.gen_order_maps(C.gen_nested_orders(t), t)
    li = HostTable.from_dict(t)
    li = HostTable({**li.columns, "l_linenumber": (
        om["row_linenumber"], np.ones(li.num_rows, bool))},
        Schema(list(li.schema.fields)
               + [StructField("l_linenumber", INT32, True)]))
    orders = C.order_maps_table(om)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 5_000,
            "spark.rapids.tpu.sql.agg.wideBatchRows": 5_000}
    if case in ("f", "g"):
        conf["spark.rapids.tpu.sql.batchSizeBytes"] = \
            (64 if case == "f" else 16) << 10
    s = TorchSession(conf, device="cpu")
    if case == "a":
        assert C.collect17_right(C.q17_collect(
            s.create_dataframe(li), PF).collect_numpy(), om)
    elif case == "b":
        assert C.q17_maps(s.create_dataframe(li), PF).collect() == \
            [C.maps17_numpy(om)]
    elif case == "c":
        assert C.q17_structs(s.create_dataframe(li), PF).collect() == \
            [C.structs17_numpy(t)]
    elif case.startswith("d"):
        want = C.lines17_numpy(om)
        q = {"d_pos": C.q17_by_pos, "d_key": C.q17_by_key,
             "d_outer": C.q17_outer}[case]
        got = q(s.create_dataframe(orders), PF).collect()
        if case == "d_outer":
            w = want["outer"]
            assert (got[0]["rows"], got[0]["values"]) == (w["rows"],
                                                          w["values"])
            assert math.isclose(got[0]["s"], w["s"], rel_tol=1e-12)
        else:
            key = "pos" if case == "d_pos" else "key"
            assert [(g[key], g["n"]) for g in got] == [
                (x["pos"] + (key == "key"), x["n"]) for x in want["by_pos"]]
            assert all(math.isclose(g["s"], x["s"], rel_tol=1e-12)
                       for g, x in zip(got, want["by_pos"]))
    elif case == "e":
        assert C.q17_stats(s.create_dataframe(li), PF).collect() == \
            C.stats17_numpy(t)
    elif case == "g":
        assert C.split_stats17_right(C.q17_split_stats(
            s.create_dataframe(li), PF).collect_numpy(), t)
        agg = s.last_plan
        while type(agg).__name__ != "TpuHashAggregateExec":
            agg = agg.children[0]
        assert agg.last_repartitions > 1
    else:
        assert C.sorted17_right(C.q17_sorted(
            s.create_dataframe(orders), PF).collect_numpy(), om)
        sorter = s.last_plan
        while type(sorter).__name__ != "TpuSortExec":
            sorter = sorter.children[0]
        assert sorter.last_buckets > 1
