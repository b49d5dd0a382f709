"""The SQL front end (``TorchSession.sql``) against the reference's, on
the CPU.

* Every query text of tests/test_sql.py whose operators the port has, and
  the TPC texts of benchmarks/queries_sql.py (TPC-H q1 and q6, TPC-DS q3
  and the q9 bucket), go through both packages' ``session.sql`` over the
  same Arrow tables (the reference with its cost optimizer off), and so
  do texts added here: the q28-shaped UNION ALL of six filtered keyless
  SELECTs with count(DISTINCT) (its plan has six distinct flags: the
  lowering's Project over each aggregate keeps the union-of-aggregates
  rewrite from firing, as in the reference), SELECT DISTINCT, UNION,
  INTERSECT and EXCEPT over int, double and dictionary-string columns with
  NULLs, NaN and +-0.0, and LIMITs of 0 rows, past the input and across
  64-row batches. Results are compared with tests/harness.py's comparator:
  floats exactly, except float sums and averages that the packages add in
  other orders (keyless ones, and keyed ones through the port's dense
  groupby), which are held to a relative 1e-12 (ROADMAP.md Queue C,
  "Float sums add in another order").
* Errors: bad ordinals and unknown tables raise what the reference
  raises; the texts the port refuses raise NotImplementedError naming
  the slice that brings what they need (concat and casts to strings:
  slice 7; decimals: their own item; the time-zone functions: where
  they are queued; DML and catalog statements: slice 10). INTERSECT ALL
  / EXCEPT ALL run since slice 9b (tests/test_torch_setops.py; the
  verbs here equal the reference's). The math, date and statistics
  functions run since slice 9a (tests/test_torch_math.py and its
  siblings). Window texts (``OVER``) run since slice
  8 (tests/test_torch_window.py); DISTINCT inside OVER raises the
  reference's SqlError.
* The port's copy of the parser gives the reference's AST (every class's
  fields, recursively) for every SQL text of tests/test_sql.py,
  benchmarks/queries_sql.py and this file, and the same errors; and
  chip_smoke.py's copies of the TPC texts equal benchmarks/queries_sql.py.
"""
import ast
import math
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import chip_smoke
from benchmarks import queries_sql as Q
from benchmarks import tpcds, tpch
from harness import _assert_frames_equal, _canon
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.sql import parser as ref_parser
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.sql import parser as port_parser

from test_torch_slice import prebuild_reference_native

REPO = Path(__file__).resolve().parent.parent
OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
#: keyless float sums and averages: the packages add in other orders
REL = 1e-12
LINEITEM_ROWS = 4000
STORE_SALES_ROWS = 4000


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _set_tables(seed: int = 5, negative_zero: bool = True):
    """Two tables of int, double and dictionary-string columns with NULLs,
    NaN and 0.0 (and -0.0 with ``negative_zero``), whose rows overlap."""
    rng = np.random.RandomState(seed)
    zero = -0.0 if negative_zero else 0.0

    def one(n):
        return pa.table({
            "i": pa.array(rng.randint(-3, 4, n), mask=rng.rand(n) < 0.15),
            "d": pa.array(rng.choice([np.nan, zero, 0.0, 1.5, -2.25], n),
                          mask=rng.rand(n) < 0.15),
            "s": pa.array(rng.choice(["x", "y", "zz"], n).astype(object),
                          mask=rng.rand(n) < 0.15)})
    return one(400), one(300)


def _set_rows(t: pa.Table) -> set:
    """A table's rows as a set under SQL set-operation equality: NULL
    equal to NULL, NaN to NaN, -0.0 to 0.0."""
    out = set()
    for i, d, s in zip(*[t.column(c).to_pylist() for c in t.column_names]):
        if d is not None:
            d = "nan" if math.isnan(d) else d + 0.0
        out.add((i, d, s))
    return out


@pytest.fixture(scope="module")
def sessions():
    """(port, reference) sessions with the same temp views."""
    views = {
        "lineitem": tpch.gen_lineitem(LINEITEM_ROWS),
        "store_sales": tpcds.gen_store_sales(STORE_SALES_ROWS),
        "date_dim": tpcds.gen_date_dim(),
        "item": tpcds.gen_item(),
        "t1": pa.table({"k": [1, 2, 3], "x": [10, 20, 30]}),
        "t2": pa.table({"k": [2, 3, 4], "y": [5, 6, 7]}),
        "people": pa.table({"name": ["Alice", "bob", "CAROL", None],
                            "v": [1.5, -2.5, 3.25, 4.0]}),
        "neg": pa.table({"x": [-1, 2, 5]}),
        "soft": pa.table({"rows": [1, 2], "current": [3, 4]}),
        "t": pa.table({"k": [1, 2, 2], "v": [1.0, 2.0, 3.0]}),
        "r": pa.table({"k": [2, 3], "name": ["a", "b"]}),
        "big": pa.table({"x": np.arange(1000)[::-1].copy(),
                         "y": np.arange(1000) * 0.5}),
    }
    views["sa"], views["sb"] = _set_tables()
    views["na"], views["nb"] = _set_tables(negative_zero=False)
    out = []
    for s in (TorchSession(OFF, device="cpu"), TpuSession(OFF)):
        for name, table in views.items():
            s.create_dataframe(table).create_or_replace_temp_view(name)
        out.append(s)
    return tuple(out)


def _frames_equal(got, want, ignore_order: bool, rel: float = 0.0):
    got, want = _canon(got, ignore_order), _canon(want, ignore_order)
    floats = [c for c in want.columns
              if pd.api.types.is_float_dtype(want[c])] if rel else []
    _assert_frames_equal(got.drop(columns=floats),
                         want.drop(columns=floats), False)
    assert list(got.columns) == list(want.columns)
    for c in floats:
        np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                   want[c].to_numpy(np.float64), rtol=rel,
                                   equal_nan=True, err_msg=c)


def _both(sessions, text, ignore_order=False, rel=0.0):
    port, ref = sessions
    got = port.sql(text).to_pandas()
    _frames_equal(got, ref.sql(text).to_pandas(), ignore_order, rel)
    return got


# ---------------------------------------------------------------------------
# the texts of tests/test_sql.py and benchmarks/queries_sql.py
# ---------------------------------------------------------------------------

Q1_SHORT = """
        SELECT l_returnflag, l_linestatus,
               sum(l_quantity) AS sum_qty,
               sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               avg(l_discount) AS avg_disc,
               count(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= date '1998-12-01' - interval '90' day
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus"""

Q3_SHORT = """
        SELECT d_year, i_brand_id, i_brand,
               sum(ss_ext_sales_price) AS sum_agg
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manufact_id = 128 AND d_moy = 11
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, sum_agg DESC, i_brand_id"""

#: (text, rows compared in order, relative tolerance of float columns)
TEXTS = {
    "tpch_q1": (Q.TPCH_Q1, True, REL),
    "tpch_q1_short": (Q1_SHORT, True, REL),
    "tpch_q6": (Q.TPCH_Q6, True, REL),
    "tpcds_q3": (Q.TPCDS_Q3, True, 0.0),
    "tpcds_q3_short": (Q3_SHORT, True, 0.0),
    "tpcds_q9_bucket": (Q.TPCDS_Q9_BUCKET.format(lo=21, hi=40), True, REL),
    "join_on": ("""SELECT d_year, count(*) AS n
                 FROM store_sales JOIN date_dim
                      ON ss_sold_date_sk = d_date_sk
                 GROUP BY d_year ORDER BY d_year""", True, 0.0),
    "join_using": ("SELECT k, x, y FROM t1 JOIN t2 USING (k) ORDER BY k",
                   True, 0.0),
    "left_join_using": ("SELECT k, x, y FROM t1 LEFT JOIN t2 USING (k) "
                        "ORDER BY k", True, 0.0),
    "right_join_using": ("SELECT k, y FROM t1 RIGHT JOIN t2 USING (k) "
                         "ORDER BY k", True, 0.0),
    "full_join_using": ("SELECT k FROM t1 FULL JOIN t2 USING (k) ORDER BY k",
                        True, 0.0),
    "self_join": ("SELECT count(*) AS n FROM t1 a JOIN t1 b ON a.k = b.k",
                  True, 0.0),
    "case_when_in_aggregates": ("""
        SELECT count(CASE WHEN ss_quantity BETWEEN 1 AND 20
                          THEN 1 ELSE NULL END) AS b1,
               avg(CASE WHEN ss_quantity BETWEEN 1 AND 20
                        THEN ss_ext_sales_price ELSE NULL END) AS a1
        FROM store_sales""", True, REL),
    "cte_having_order_limit": ("""
        WITH big AS (
            SELECT l_orderkey, sum(l_quantity) AS q
            FROM lineitem GROUP BY l_orderkey HAVING sum(l_quantity) > 60
        )
        SELECT l_orderkey, q FROM big ORDER BY q DESC, l_orderkey
        LIMIT 10""", True, 0.0),
    "union_all_of_limits": ("""
        SELECT 1 AS v FROM (SELECT l_orderkey FROM lineitem LIMIT 1) x
        UNION ALL
        SELECT 2 AS v FROM (SELECT l_orderkey FROM lineitem LIMIT 1) y
        ORDER BY v""", True, 0.0),
    "count_distinct_and_aliases": ("""
        SELECT count(DISTINCT ss_item_sk) AS items,
               count(*) AS n, sum(ss_quantity) / count(*) AS avg_q
        FROM store_sales""", True, 0.0),
    "double_in": ("SELECT v FROM people WHERE v IN (1.5, 4) ORDER BY v",
                  True, 0.0),
    "not_like": ("SELECT count(*) AS n FROM people "
                 "WHERE name NOT LIKE '%o%' AND name IS NOT NULL",
                 True, 0.0),
    # refused until the strings slice (slice 7)
    "upper_lower_like": ("""SELECT upper(name) AS u, abs(v) AS av
        FROM people WHERE name IS NOT NULL AND lower(name) LIKE '%o%'
        ORDER BY u""", True, 0.0),
    "length": ("SELECT length(name) AS n FROM people", False, 0.0),
    "group_by_ordinal": ("""SELECT l_returnflag AS rf, count(*) AS n
                 FROM lineitem GROUP BY 1 ORDER BY 1""", True, 0.0),
    "group_by_alias": ("""SELECT l_returnflag AS rf, count(*) AS n
                 FROM lineitem GROUP BY rf ORDER BY rf""", True, 0.0),
    "order_by_aggregate": ("""SELECT l_returnflag FROM lineitem
                   GROUP BY l_returnflag ORDER BY count(*) DESC""",
                           True, 0.0),
    "order_by_hidden_column": ("""SELECT l_returnflag AS rf, count(*) AS n
                    FROM lineitem
                    GROUP BY l_returnflag ORDER BY l_returnflag""",
                               True, 0.0),
    "negative_in_semicolon": ("SELECT x FROM neg WHERE x IN (-1, 2) "
                              "ORDER BY x;", True, 0.0),
    "soft_keywords": ("SELECT rows, current FROM soft ORDER BY rows",
                      True, 0.0),
    "qualified_colliding_keys": ("""SELECT t.k, count(name) c FROM t
                       LEFT JOIN r ON t.k = r.k GROUP BY t.k
                       ORDER BY t.k""", True, 0.0),
    "qualified_star": ("SELECT r.* FROM t JOIN r ON t.k = r.k", False, 0.0),
}

#: texts added here: the q28 shape (chip_smoke.py's copy of the
#: benchmark's q28 as SQL), set operations and LIMITs
Q28_SQL = chip_smoke.TPCDS_Q28

ADDED = {
    "q28_union_of_six": (Q28_SQL, True, REL),
    "distinct": ("SELECT DISTINCT i, d, s FROM sa", False, 0.0),
    "distinct_one_column": ("SELECT DISTINCT s FROM sb ORDER BY s", True,
                            0.0),
    "union_distinct": ("SELECT i, d, s FROM sa UNION SELECT i, d, s FROM sb",
                       False, 0.0),
    "intersect": ("SELECT i, d, s FROM na INTERSECT SELECT i, d, s FROM nb",
                  False, 0.0),
    "except": ("SELECT i, d, s FROM na EXCEPT SELECT i, d, s FROM nb",
               False, 0.0),
    "intersect_renamed_filtered": ("""
        SELECT * FROM (SELECT s AS a, d AS b FROM na WHERE i > 0
                       INTERSECT
                       SELECT s, d FROM nb WHERE d IS NOT NULL) x
        ORDER BY a, b""", True, 0.0),
    "except_minus_ints": ("SELECT i FROM sa MINUS SELECT i FROM sb "
                          "WHERE i <> 2", False, 0.0),
    "limit_0": ("SELECT x, y FROM big LIMIT 0", True, 0.0),
    "limit_past_the_input": ("SELECT x FROM big ORDER BY x LIMIT 5000",
                             True, 0.0),
    "limit_across_batches": ("SELECT x, y FROM big LIMIT 150", True, 0.0),
    "limit_sorted_across_batches": ("SELECT x, y FROM big WHERE x > 10 "
                                    "ORDER BY y DESC LIMIT 150", True, 0.0),
}


@pytest.mark.parametrize("name", list(TEXTS) + list(ADDED))
def test_sql_text_equals_reference(sessions, name):
    text, ordered, rel = {**TEXTS, **ADDED}[name]
    got = _both(sessions, text, ignore_order=not ordered, rel=rel)
    assert len(got) or name == "limit_0"


@pytest.mark.parametrize("op", ["INTERSECT", "EXCEPT"])
def test_set_operations_match_negative_zero_with_zero(sessions, op):
    """INTERSECT and EXCEPT over rows holding -0.0 and 0.0, NaN and NULLs,
    against the sets computed here. Not against the reference: its plan
    for these three columns keeps a -0.0 row from matching a 0.0 row
    (ROADMAP.md Queue C), while Spark normalises -0.0 to 0.0 in join
    keys; over the same tables without -0.0 the two packages agree
    (test_sql_text_equals_reference[intersect], [except])."""
    a, b = _set_tables()
    got = sessions[0].sql(
        f"SELECT i, d, s FROM sa {op} SELECT i, d, s FROM sb").collect_arrow()
    want = _set_rows(a) & _set_rows(b) if op == "INTERSECT" \
        else _set_rows(a) - _set_rows(b)
    assert got.num_rows == len(want) and _set_rows(got) == want


def test_limits_over_64_row_batches():
    """LIMITs over 64-row batches: none, within the first batch, across
    several, and past the input; the limit stops pulling batches."""
    conf = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": 64}
    t = pa.table({"x": np.arange(1000)[::-1].copy(),
                  "y": np.arange(1000) * 0.5})
    pair = (TorchSession(conf, device="cpu"), TpuSession(conf))
    for s in pair:
        s.create_dataframe(t).create_or_replace_temp_view("big")
    for n in (0, 10, 150, 1000, 5000):
        got = _both(pair, f"SELECT x, y FROM big LIMIT {n}")
        assert len(got) == min(n, 1000)
        _both(pair, f"SELECT x FROM big WHERE y > 3 ORDER BY x LIMIT {n}")
    plan = pair[0].sql("SELECT x FROM big LIMIT 150")._physical()
    assert "Limit[150]" in plan.tree_string()


def test_q28_as_sql_plans_six_passes(sessions):
    """The q28 shape as SQL runs six passes, each with its distinct flag:
    the lowering puts a Project over each branch's aggregate, so the
    union-of-aggregates rewrite does not fire."""
    plan = sessions[0].sql(Q28_SQL)._physical().tree_string()
    assert plan.count("HashDistinctFlag") == 6, plan
    assert plan.count("InMemoryScan") == 6 and "BranchAlign" not in plan


def test_q3_broadcasts_the_first_join_on_the_left(sessions):
    """The comma join lowers in FROM order (date_dim, store_sales, item):
    the small date_dim is the left side and is the one broadcast."""
    plan = sessions[0].sql(Q.TPCDS_Q3)._physical().tree_string()
    joins = [ln for ln in plan.splitlines() if "BroadcastHashJoin" in ln]
    assert [j.rsplit("build=", 1)[1] for j in joins] == ["right]", "left]"]


def test_duplicate_output_names_of_a_qualified_join(sessions):
    """t.k and r.k stay apart through the join and come out as two
    columns named k (tests/test_sql.py:test_qualified_refs_with_colliding_
    join_columns)."""
    port, ref = sessions
    text = "SELECT t.k, r.k FROM t JOIN r ON t.k = r.k"
    got, want = port.sql(text).collect_arrow(), ref.sql(text).collect_arrow()
    assert got.column_names == want.column_names == ["k", "k"]
    assert sorted(zip(*[c.to_pylist() for c in got.columns])) == \
        sorted(zip(*[c.to_pylist() for c in want.columns]))


def test_tpc_texts_equal_the_dataframe_forms(sessions):
    """The TPC texts equal the port's DataFrame forms of the same queries
    (benchmarks/tpch.py and tpcds.py, unmodified)."""
    from spark_rapids_tpu_torch.api import functions as PF
    port = sessions[0]
    got = port.sql(Q.TPCH_Q1).to_pandas()
    want = tpch.q1(port.table("lineitem"), PF).to_pandas()
    _frames_equal(got, want, False)
    got = port.sql(Q.TPCH_Q6).to_pandas()
    want = tpch.q6(port.table("lineitem"), PF).to_pandas()
    _frames_equal(got, want, False)
    got = port.sql(Q.TPCDS_Q3).to_pandas()
    want = tpcds.q3(port.table("store_sales"), port.table("date_dim"),
                    port.table("item"), PF).to_pandas()
    _frames_equal(got, want, False, rel=REL)


def test_verbs_equal_reference(sessions):
    """The DataFrame verbs the lowering calls, used directly."""
    for s in sessions:
        assert s.table("na").drop("d").columns == ["i", "s"]
    pairs = [(s.table("na"), s.table("nb")) for s in sessions]
    for verb in ("distinct", "intersect", "subtract", "limit",
                 "intersect_all", "except_all"):
        got, want = (
            (getattr(a, verb)() if verb == "distinct" else
             a.limit(7) if verb == "limit" else getattr(a, verb)(b))
            .to_pandas() for a, b in pairs)
        _frames_equal(got, want, verb != "limit")


# ---------------------------------------------------------------------------
# expressions the lowering reaches
# ---------------------------------------------------------------------------

def _expr_table(n=400, seed=9):
    rng = np.random.RandomState(seed)
    return pa.table({
        "a": pa.array(rng.randint(-5, 6, n).astype(np.int32),
                      mask=rng.rand(n) < 0.2),
        "b": pa.array(rng.randint(-5, 6, n).astype(np.int32),
                      mask=rng.rand(n) < 0.2),
        "x": pa.array(rng.choice([np.nan, -0.0, 0.0, 1.0, -np.inf, np.inf,
                                  2.5], n), mask=rng.rand(n) < 0.2),
        "y": pa.array(rng.choice([np.nan, 0.0, 1.0, -1.5], n),
                      mask=rng.rand(n) < 0.2),
        "dt": pa.array(rng.randint(9000, 9100, n).astype("datetime64[D]"),
                       mask=rng.rand(n) < 0.2)})


def _exprs(F):
    return [F.nullif(F.col("a"), F.col("b")).alias("nullif_ab"),
            F.nullif(F.col("x"), F.col("y")).alias("nullif_xy"),
            F.greatest(F.col("a"), F.col("b"), F.lit(-4)).alias("g_ab"),
            F.least(F.col("a"), F.col("b")).alias("l_ab"),
            F.greatest(F.col("x"), F.col("y")).alias("g_xy"),
            F.least(F.col("x"), F.col("y"), F.lit(0.5)).alias("l_xy"),
            F.least(F.col("a"), F.col("x")).alias("l_ax"),
            F.coalesce(F.col("a"), F.col("b"), F.lit(99)).alias("c_ab"),
            F.isnull(F.col("x")).alias("isnull_x"),
            F.date_add(F.col("dt"), F.col("a")).alias("da"),
            F.date_sub(F.col("dt"), 30).alias("ds"),
            F.cast(F.col("a"), "bigint").alias("a64"),
            (F.col("a") != F.col("b")).alias("ne"),
            (F.col("x") != F.lit(0.0)).alias("ne_x")]


def test_expressions_equal_reference():
    """NullIf, Greatest/Least (NaN greatest, NULLs skipped), Coalesce,
    isnull, DateAdd/DateSub, the widening cast and != in a projection,
    exactly."""
    from spark_rapids_tpu.api import functions as RF
    from spark_rapids_tpu_torch.api import functions as PF
    t = _expr_table()
    got = TorchSession(OFF, device="cpu").create_dataframe(t) \
        .select(*_exprs(PF)).to_pandas()
    want = TpuSession(OFF).create_dataframe(t).select(*_exprs(RF)) \
        .to_pandas()
    _frames_equal(got, want, False)


def test_literal_date_interval_in_a_fused_filter(sessions):
    """q1's cutoff, a DateSub over two literals, evaluates inside the
    filter that the aggregate folds into its update."""
    text = ("SELECT count(*) AS n FROM lineitem WHERE l_shipdate <= "
            "date '1998-12-01' - interval '2' week AND l_shipdate > "
            "date '1998-01-01' + interval '3' day")
    got = _both(sessions, text)
    plan = sessions[0].sql(text)._physical().tree_string()
    assert "fused=[filter" in plan, plan
    raw = tpch.gen_lineitem(LINEITEM_ROWS).column("l_shipdate") \
        .to_numpy().astype("datetime64[D]")
    assert int(got["n"][0]) == int(
        ((raw <= np.datetime64("1998-11-17"))
         & (raw > np.datetime64("1998-01-04"))).sum())


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,match", [
    ("SELECT * FROM nope", "not found"),
    ("SELECT FROM lineitem", None),
    ("SELECT frobnicate(l_quantity) FROM lineitem", "unknown function"),
    ("SELECT greatest(l_quantity, l_tax) FROM lineitem", "unknown function"),
    ("SELECT x FROM neg GROUP BY 0", "ordinal"),
    ("SELECT x FROM neg ORDER BY 5", "ordinal"),
    ("""SELECT l_returnflag, rank() OVER (ORDER BY sum(l_quantity))
        FROM lineitem GROUP BY l_returnflag""", "subquery"),
    ("SELECT sum(DISTINCT v) OVER () FROM people", "DISTINCT"),
])
def test_errors_equal_reference(sessions, text, match):
    for s in sessions:
        with pytest.raises(port_parser.SqlError if s is sessions[0]
                           else ref_parser.SqlError, match=match):
            s.sql(text)
    with pytest.raises(port_parser.SqlError, match="not found"):
        sessions[0].table("nope")


#: texts the port refuses, and the slice each names
REFUSED = [
    ("SELECT name || v FROM people", "slice 7"),
    ("SELECT CAST(v AS STRING) FROM people", "slice 7"),
    ("SELECT CAST(name AS DECIMAL) FROM people", "decimals"),
    ("SELECT from_utc_timestamp(l_shipdate, 'UTC') FROM lineitem",
     "time-zone"),
    ("SELECT to_utc_timestamp(l_shipdate, 'UTC') FROM lineitem",
     "time-zone"),
    ("SHOW TABLES", "slice 10"),
    ("UPDATE neg SET x = 1 WHERE x = 2", "slice 10"),
    ("DELETE FROM neg WHERE x = 2", "slice 10"),
    ("""MERGE INTO neg t USING soft s ON t.x = s.rows
        WHEN MATCHED THEN DELETE""", "slice 10"),
    ("CREATE TABLE n2 AS SELECT x FROM neg", "slice 10"),
    ("DROP TABLE IF EXISTS n2", "slice 10"),
]


@pytest.mark.parametrize("text,slice_", REFUSED)
def test_refused_texts_name_their_slice(sessions, text, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        sessions[0].sql(text).collect()


# ---------------------------------------------------------------------------
# the copies held to their originals
# ---------------------------------------------------------------------------

def _shape(node):
    """An AST as plain data: each parser class by name with its fields."""
    if isinstance(node, (list, tuple)):
        return type(node).__name__, [_shape(x) for x in node]
    if hasattr(node, "__dict__"):
        return type(node).__name__, {k: _shape(v)
                                     for k, v in sorted(vars(node).items())}
    return node


def _sql_literals(path: Path) -> list:
    """The string constants of a Python file that read as SQL."""
    tree = ast.parse(path.read_text())
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.lstrip().split(" ", 1)[0].upper()
            in ("SELECT", "WITH", "SELECT\n")]


def _all_texts() -> list:
    texts = _sql_literals(REPO / "tests" / "test_sql.py")
    texts += [Q.TPCH_Q1, Q.TPCH_Q6, Q.TPCDS_Q3,
              Q.TPCDS_Q9_BUCKET.format(lo=1, hi=20)]
    texts += [t for t, _, _ in list(TEXTS.values()) + list(ADDED.values())]
    texts += [t for t, _ in REFUSED]
    return texts


def test_sql_literal_scan_finds_every_text():
    assert len(_sql_literals(REPO / "tests" / "test_sql.py")) >= 30


@pytest.mark.parametrize("text", _all_texts())
def test_parser_copy_gives_the_reference_ast(text):
    try:
        want = _shape(ref_parser.parse(text))
    except ref_parser.SqlError as e:
        with pytest.raises(port_parser.SqlError) as got:
            port_parser.parse(text)
        assert str(got.value) == str(e)
        return
    assert repr(_shape(port_parser.parse(text))) == repr(want)


def test_parser_copy_is_the_original_file():
    port = REPO / "spark_rapids_tpu_torch" / "sql" / "parser.py"
    ref = REPO / "spark_rapids_tpu" / "sql" / "parser.py"
    assert port.read_text() == ref.read_text()


def test_chip_smoke_texts_equal_the_originals():
    assert chip_smoke.TPCH_Q1 == Q.TPCH_Q1
    assert chip_smoke.TPCH_Q6 == Q.TPCH_Q6
    assert chip_smoke.TPCDS_Q3 == Q.TPCDS_Q3
    assert chip_smoke.TPCDS_Q9_BUCKET == Q.TPCDS_Q9_BUCKET


def test_sql_package_imports_neither_pandas_nor_pyarrow():
    pkg = REPO / "spark_rapids_tpu_torch" / "sql"
    for f in pkg.glob("*.py"):
        for n in ast.walk(ast.parse(f.read_text())):
            if isinstance(n, (ast.Import, ast.ImportFrom)) and \
                    n.col_offset == 0:
                names = [a.name for a in n.names] if isinstance(
                    n, ast.Import) else [n.module or ""]
                assert not any(x.split(".")[0] in ("pandas", "pyarrow",
                                                   "jax", "spark_rapids_tpu")
                               for x in names), (f, names)
