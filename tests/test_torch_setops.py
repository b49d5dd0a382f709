"""CASE WHEN, IS [NOT] NULL, UNION and the union-of-aggregates single pass
against the reference, on the CPU.

* ``If``, ``CaseWhen``, ``IsNull`` and ``IsNotNull`` over int and double
  columns with NULLs and NaN: the first matching branch wins, a NULL
  predicate picks the next branch, an untyped ``lit(None)`` else is the
  absent else (the reference's tests/test_conditional.py cases that use
  only these expressions, plus NaN, NULL predicates and nesting); values
  exactly. A string-typed CASE is refused at planning;
* ``union`` of two frames, and its refusal of schemas that differ;
* the reference's union-of-aggregates cases (tests/test_tpc_queries.py):
  the plan shape of q28 (a distinct flag, branch alignment, one scan, no
  union, the dense route for the branch id), overlapping branches through
  ``Expand``, a branch without rows getting the empty aggregate's values,
  and branch order kept; each on both packages;
* q9's keyless aggregate reading one widened batch, the widening's cap
  from the memory budget and ``agg.wideBatchRows``, and the scan cache
  keeping a widened scan's batches apart from a normal one's.
* INTERSECT ALL / EXCEPT ALL (slice 9b): ``intersect_all``/``except_all``
  and their SQL over int, double and string columns with NULLs, NaN and
  +-0.0, multiplicities from 1 to dozens, 64-row batches, against the
  reference row for row after sorting, and against a multiset model; the
  reference's own cases (tests/test_setops.py).
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu import exprs as RE
from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar.batch import HostTable
from spark_rapids_tpu_torch.exec import basic as pbasic

from test_torch_distinct import tpcds, _rows_equal
from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _ref(conf=None):
    return TpuSession({**OFF, **(conf or {})})


def _port(conf=None):
    return TorchSession({**OFF, **(conf or {})}, device="cpu")


def _both(query, table, conf=None):
    return (query(_port(conf).create_dataframe(table), PF).collect(),
            query(_ref(conf).create_dataframe(table), RF).collect())


def _table(n=600, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randint(-50, 50, n).astype(np.int32)
    b = rng.randint(-50, 50, n).astype(np.int32)
    d = rng.choice([np.nan, -0.0, 0.0, 0.25, 0.75, 1.5, -3.0], n)
    return pa.table({"a": pa.array(a, mask=rng.rand(n) < 0.1),
                     "b": pa.array(b, mask=rng.rand(n) < 0.1),
                     "d": pa.array(d, mask=rng.rand(n) < 0.1)})


# ---------------------------------------------------------------------------
# conditionals and null tests
# ---------------------------------------------------------------------------

def test_if_else():
    def q(df, F):
        return df.select(
            F.when(F.col("a") > F.col("b"), F.col("a"))
             .otherwise(F.col("b")).alias("max_ab"))
    got, want = _both(q, _table(seed=1))
    assert got == want


def test_case_when_multi_branch():
    def q(df, F):
        return df.select(
            F.when(F.col("a") < -10, -1)
             .when(F.col("a") > 10, 1)
             .otherwise(0).alias("bucket"))
    got, want = _both(q, _table(seed=2))
    assert got == want


def test_case_when_first_match_null_predicate_and_untyped_else():
    """Overlapping branches (the first wins), predicates over NULL columns
    (NULL picks the next branch), an untyped NULL else, over int and
    double with NaN."""
    def q(df, F):
        return df.select(
            F.when(F.col("a") > F.col("b"), F.col("d"))
             .when(F.col("a") > 0, F.lit(2.5))
             .when(F.col("a") > -20, F.col("a"))
             .otherwise(F.lit(None)).alias("w"),
            F.when(F.col("d") > 0.5, F.lit(1))
             .when(F.col("d").isNull(), F.lit(-1)).col.alias("no_else"),
            F.when(F.col("d") == F.col("d"), F.col("d"))
             .otherwise(F.lit(9.0)).alias("nan_eq"))
    got, want = _both(q, _table(seed=3))
    _rows_equal(got, want, rel=0.0)
    assert any(r["w"] is None for r in got)
    assert any(r["no_else"] is None for r in got)


def _if_query(E):
    """Nested ``If``s built from the expression classes of a package."""
    def q(df, F):
        inner = E.If((F.col("b") > 0).expr, F.col("b").expr,
                     F.lit(None).expr)
        return df.select(F.Col(E.If((F.col("a") > F.col("b")).expr,
                                    F.col("d").expr, inner)).alias("i"))
    return q


def test_if_expression_and_nesting():
    t = _table(seed=4)
    got = _if_query(PE)(_port().create_dataframe(t), PF).collect()
    want = _if_query(RE)(_ref().create_dataframe(t), RF).collect()
    _rows_equal(got, want, rel=0.0)


def test_is_null_and_is_not_null():
    def q(df, F):
        return df.select(F.col("a").isNull().alias("an"),
                         F.col("d").isNotNull().alias("dn"),
                         F.col("d").isNull().alias("dnull"))
    got, want = _both(q, _table(seed=5))
    assert got == want
    assert any(r["an"] for r in got) and any(r["dnull"] for r in got)


def test_is_not_null_filter():
    def q(df, F):
        return df.filter(F.col("a").isNotNull() & F.col("d").isNull()) \
            .agg(F.count_star().with_name("n"),
                 F.sum(F.col("a")).with_name("s"))
    got, want = _both(q, _table(seed=6))
    assert got == want and got[0]["n"] > 0


def test_string_case_is_refused_at_planning():
    t = pa.table({"a": pa.array([1, -1, 2], pa.int32())})
    df = _port().create_dataframe(t).select(
        PF.when(PF.col("a") > 0, "pos").col.alias("s"))
    with pytest.raises(NotImplementedError, match="slice 7"):
        df.collect()


# ---------------------------------------------------------------------------
# union
# ---------------------------------------------------------------------------

def test_union_of_two_frames():
    def q(df, F):
        lo = df.filter(F.col("a") < 0).select("a", "d")
        hi = df.filter(F.col("a") > 30).select(
            F.col("b").alias("a"), "d")
        return lo.union(hi)
    got, want = _both(q, _table(seed=7))
    _rows_equal(got, want, rel=0.0)
    tree = q(_port().create_dataframe(_table(seed=7)),
             PF)._physical().tree_string()
    assert "Union[2]" in tree, tree


def test_union_refuses_schemas_that_differ():
    df = _port().create_dataframe(_table(seed=8))
    with pytest.raises(ValueError, match="differ"):
        df.select("a").union(df.select("d"))
    with pytest.raises(ValueError, match="differ"):
        df.select("a", "b").union(df.select("a"))


# ---------------------------------------------------------------------------
# the union of aggregates in one pass
# ---------------------------------------------------------------------------

def test_q28_plan_shape():
    tab = tpcds.gen_store_sales(3000, seed=7)
    tree = tpcds.q28(_port().create_dataframe(tab),
                     PF)._physical().tree_string()
    assert "Union" not in tree, tree
    assert tree.count("InMemoryScan") == 1, tree
    assert "DistinctFlag" in tree and "BranchAlign" in tree, tree
    assert "route=dense" in tree, tree


def _branch_aggs(b, F):
    return b.agg(F.count(F.col("v")).with_name("c"),
                 F.sum(F.col("v")).with_name("s"),
                 F.avg(F.col("v")).with_name("a"),
                 F.count_distinct(F.col("v")).with_name("cd"))


def test_overlapping_branches_take_expand():
    """A row in two branches counts in both."""
    t = pa.table({"q": pa.array([1, 5, 10, 15, 20], pa.int64()),
                  "v": pa.array([1.0, 2.0, 3.0, 4.0, 2.0])})

    def q(df, F):
        b1 = df.filter((F.col("q") >= F.lit(0)) & (F.col("q") <= F.lit(10)))
        b2 = df.filter((F.col("q") >= F.lit(5)) & (F.col("q") <= F.lit(20)))
        return _branch_aggs(b1, F).union(_branch_aggs(b2, F))
    got, want = _both(q, t)
    _rows_equal(got, want)
    assert [r["c"] for r in got] == [3, 4] and [r["cd"] for r in got] == \
        [3, 3]
    tree = q(_port().create_dataframe(t), PF)._physical().tree_string()
    assert "Expand" in tree and "Union" not in tree, tree


def test_empty_branch_gets_the_empty_aggregate():
    t = pa.table({"q": pa.array([1, 2, 3], pa.int64()),
                  "v": pa.array([1.0, 2.0, 3.0])})

    def q(df, F):
        b1 = df.filter((F.col("q") >= F.lit(0)) & (F.col("q") <= F.lit(10)))
        b2 = df.filter((F.col("q") >= F.lit(100))
                       & (F.col("q") <= F.lit(200)))
        return _branch_aggs(b1, F).union(_branch_aggs(b2, F))
    got, want = _both(q, t)
    _rows_equal(got, want)
    assert got[1] == {"c": 0, "s": None, "a": None, "cd": 0}


def test_branch_order_is_kept():
    t = pa.table({"q": pa.array(list(range(30)), pa.int64())})

    def q(df, F):
        outs = None
        for lo, hi in [(20, 29), (0, 9), (10, 19)]:
            b = df.filter((F.col("q") >= F.lit(lo))
                          & (F.col("q") <= F.lit(hi))) \
                .agg(F.min(F.col("q")).with_name("mn"),
                     F.max(F.col("q")).with_name("mx"))
            outs = b if outs is None else outs.union(b)
        return outs
    got, want = _both(q, t)
    assert got == want and [r["mn"] for r in got] == [20, 0, 10]


# ---------------------------------------------------------------------------
# the keyless aggregate's widened scan
# ---------------------------------------------------------------------------

def _scan(physical):
    node = physical
    while not isinstance(node, pbasic.InMemoryScanExec):
        node = node.children[0]
    return node


def test_q9_reads_one_widened_batch():
    tab = tpcds.gen_store_sales(9000, seed=9)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1024}
    session = _port(conf)
    q = tpcds.q9(session.create_dataframe(tab), PF)
    assert _scan(q._physical()).batch_rows >= 9000
    got = q.collect()
    want = tpcds.q9(_ref(conf).create_dataframe(tab), RF).collect()
    _rows_equal(got, want)
    # a keyed aggregate keeps the conf's width
    keyed = session.create_dataframe(tab).group_by("ss_quantity").agg(
        PF.count_star())
    assert _scan(keyed._physical()).batch_rows == 1024


def test_widening_cap_and_conf():
    tab = tpcds.gen_store_sales(5000, seed=10)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 256}
    session = _port(conf)
    q = tpcds.q9(session.create_dataframe(tab), PF)
    from spark_rapids_tpu_torch.plan.overrides import plan_query
    # a budget of 64 KiB: half of it holds 32768 // 27 rows of the three
    # pruned columns (8 bytes and a validity byte each)
    assert _scan(plan_query(q.plan, session.conf, 1 << 16)).batch_rows \
        == (1 << 15) // 27
    pinned = TorchSession({**OFF, **conf,
                           "spark.rapids.tpu.sql.agg.wideBatchRows": 2000},
                          device="cpu")
    assert _scan(tpcds.q9(pinned.create_dataframe(tab),
                          PF)._physical()).batch_rows == 2000


def test_scan_cache_keys_on_the_batch_width():
    tab = HostTable.from_arrow(tpcds.gen_store_sales(4000, seed=11))
    session = _port({"spark.rapids.tpu.sql.batchSizeRows": 512})
    wide = tpcds.q9(session.create_dataframe(tab), PF).collect()
    keyed = (session.create_dataframe(tab).group_by("ss_quantity")
             .agg(PF.count_star().with_name("n")).collect())
    widths = {k[1] for k in pbasic._SCAN_CACHE if k[0] == id(tab)}
    assert 512 in widths and max(widths) >= 4000, widths
    assert sum(r["n"] for r in keyed) == 4000
    assert wide == tpcds.q9(session.create_dataframe(tab), PF).collect()
    assert math.isfinite(wide[0]["avg_price1"])


# ---------------------------------------------------------------------------
# INTERSECT ALL / EXCEPT ALL
# ---------------------------------------------------------------------------

def _multiset_table(n, seed):
    rng = np.random.RandomState(seed)
    i = rng.randint(0, 6, n).astype(np.int64)
    d = rng.choice([np.nan, -0.0, 0.0, 1.5, 2.5], n)
    s = rng.choice(["x", "y", "zz"], n)
    return pa.table({"i": pa.array(i, mask=rng.rand(n) < 0.1),
                     "d": pa.array(d, mask=rng.rand(n) < 0.1),
                     "s": pa.array(s, mask=rng.rand(n) < 0.1)})


def _key(row):
    """A sortable, comparable key of a row: NULL apart from NaN, -0.0 as
    0.0 (set operations take them as equal, and either may come out)."""
    out = []
    for v in row.values():
        if v is None:
            out.append((0, ""))
        elif isinstance(v, float) and math.isnan(v):
            out.append((1, ""))
        else:
            out.append((2, repr(v + 0.0) if isinstance(v, float) else
                        repr(v)))
    return tuple(out)


@pytest.mark.parametrize("op", ["intersect_all", "except_all"])
@pytest.mark.parametrize("form", ["dataframe", "sql"])
def test_all_set_operations_equal_reference_and_the_multiset(op, form):
    a, b = _multiset_table(300, 1), _multiset_table(200, 2)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 64}
    out = []
    for s in (_ref(conf), _port(conf)):
        x, y = s.create_dataframe(a), s.create_dataframe(b)
        if form == "sql":
            x.create_or_replace_temp_view("x")
            y.create_or_replace_temp_view("y")
            verb = "INTERSECT ALL" if op == "intersect_all" else "EXCEPT ALL"
            df = s.sql(f"SELECT i, d, s FROM x {verb} SELECT i, d, s FROM y")
        else:
            df = getattr(x, op)(y)
        out.append(sorted(_key(r) for r in df.collect()))
    want, got = out
    assert got == want
    from collections import Counter
    ca = Counter(_key(r) for r in a.to_pylist())
    cb = Counter(_key(r) for r in b.to_pylist())
    model = ca & cb if op == "intersect_all" else ca - cb
    assert got == sorted(model.elements())
    assert len(got) > 10


def test_all_set_operations_reference_cases():
    """tests/test_setops.py's INTERSECT ALL / EXCEPT ALL cases, on the
    port."""
    s = _port()
    l = s.create_dataframe(pa.table({
        "k": pa.array([1, 1, 2, 2, 3, None, None, 4], pa.int64()),
        "v": pa.array(["a", "a", "b", "b", "c", None, None, "d"])}))
    r = s.create_dataframe(pa.table({
        "k": pa.array([1, 2, 2, None, 5], pa.int64()),
        "v": pa.array(["a", "b", "b", None, "e"])}))

    def rows(df):
        return sorted(((x["k"], x["v"]) for x in df.collect()),
                      key=lambda x: (x[0] is None, x))
    assert rows(l.intersect_all(r)) == [(1, "a"), (2, "b"), (2, "b"),
                                        (None, None)]
    assert rows(l.except_all(r)) == [(1, "a"), (3, "c"), (4, "d"),
                                     (None, None)]
