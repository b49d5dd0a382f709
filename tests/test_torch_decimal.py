"""Decimals in the port (DecimalType as scaled int64 lanes): held to the
JAX package bit for bit wherever the reference answers (the cases of
tests/test_decimal.py, min/max/count, decimal group keys, ORDER BY,
casts to double, Parquet decimal columns in FIXED_LEN_BYTE_ARRAY, INT32 and
INT64), and to answers computed by hand with Python's ``decimal`` module
under Spark 3.5's rules where the reference departs from Spark (ROADMAP.md
Queue C): ``+ - * / %`` with their result types and precision loss, AVG,
comparisons with an integer literal, casts, literals, and hashing of wide
decimals. All on CPU torch at small sizes."""
from __future__ import annotations

import decimal
from decimal import Decimal as D

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from torch_compare import run_both, sessions
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.exprs import hash_fns as PH
from spark_rapids_tpu_torch.types import (DecimalType, Schema, StructField,
                                          adjust_precision_scale)

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
CTX = decimal.Context(prec=76, rounding=decimal.ROUND_HALF_UP)


def _port():
    return TorchSession(OFF, device="cpu")


def _same(ref: pa.Table, got: pa.Table, ordered: bool = False) -> None:
    """The same names, Arrow types and rows (in order with ``ordered``)."""
    assert got.schema.names == ref.schema.names
    assert [f.type for f in got.schema] == [f.type for f in ref.schema], \
        (got.schema, ref.schema)
    a, b = got.to_pylist(), ref.to_pylist()
    if not ordered:
        key = lambda r: [(v is None, str(v)) for v in r.values()]  # noqa
        a, b = sorted(a, key=key), sorted(b, key=key)
    assert a == b


def _table(n=4000, seed=0, prec=15, scale=2, null_frac=0.1):
    """tests/test_decimal.py's table."""
    rng = np.random.RandomState(seed)
    vals = [None if rng.rand() < null_frac
            else D(int(rng.randint(-10**13, 10**13))).scaleb(-scale)
            for _ in range(n)]
    return pa.table({"k": pa.array(rng.randint(0, 7, n)),
                     "d": pa.array(vals, pa.decimal128(prec, scale))})


# ---------------------------------------------------------------------------
# the cases of tests/test_decimal.py, on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_rows", [None, 700])
def test_decimal_sum_grouped_exact(batch_rows):
    t = _table()
    ref, got = run_both(t, lambda df, F, E: df.group_by("k").agg(
        F.sum(F.col("d")).with_name("sd"), F.count(F.col("d")).with_name("c"),
        F.min(F.col("d")).with_name("mn"), F.max(F.col("d")).with_name("mx")),
        batch_rows=batch_rows)
    _same(ref, got)
    exp = {}
    for k, v in zip(t.column("k").to_pylist(), t.column("d").to_pylist()):
        if v is not None:
            exp[k] = exp.get(k, D(0)) + v
    assert {r["k"]: r["sd"] for r in got.to_pylist()} == exp


def test_decimal_sum_output_type_widens():
    ref, got = run_both(_table(n=100), lambda df, F, E: df.agg(
        F.sum(F.col("d")).with_name("sd")))
    assert got.schema.field("sd").type == pa.decimal128(25, 2)
    _same(ref, got)


def test_decimal_wide_precision_group_by():
    ref, got = run_both(_table(prec=38), lambda df, F, E: df.group_by(
        "k").agg(F.sum(F.col("d")).with_name("sd")))
    assert got.schema.field("sd").type == pa.decimal128(38, 2)
    _same(ref, got)


def test_decimal_overflowing_sum_is_null():
    big = [D(9 * 10**16).scaleb(-2)] * 300       # ~2.7e19 > int64
    t = pa.table({"d": pa.array(big, pa.decimal128(38, 2))})
    ref, got = run_both(t, lambda df, F, E: df.agg(
        F.sum(F.col("d")).with_name("sd")))
    assert got.to_pylist() == [{"sd": None}]
    _same(ref, got)


def test_decimal_ingest_overflow_is_loud():
    huge = [D(2**63).scaleb(-2)]
    t = pa.table({"d": pa.array(huge, pa.decimal128(38, 2))})
    with pytest.raises(ValueError, match="64-bit unscaled"):
        _port().create_dataframe(t).select(PF.col("d")).collect()
    with pytest.raises(ValueError, match="64-bit unscaled"):
        _port().create_dataframe({"d": huge}).collect()


def _q1_table(n=20000):
    """test_decimal_tpch_q1_differential's table."""
    rng = np.random.RandomState(42)
    qty = [D(int(rng.randint(100, 5100))).scaleb(-2) for _ in range(n)]
    price = [D(int(rng.randint(90000, 10500000))).scaleb(-2)
             for _ in range(n)]
    return pa.table({
        "rf": pa.array(rng.choice(["A", "N", "R"], n)),
        "ls": pa.array(rng.choice(["O", "F"], n)),
        "qty": pa.array(qty, pa.decimal128(15, 2)),
        "price": pa.array(price, pa.decimal128(15, 2)),
    })


@pytest.mark.parametrize("batch_rows", [None, 3000])
def test_decimal_tpch_q1_differential(batch_rows):
    ref, got = run_both(_q1_table(), lambda df, F, E: df.group_by(
        "rf", "ls").agg(F.sum(F.col("qty")).with_name("sum_qty"),
                        F.sum(F.col("price")).with_name("sum_price"),
                        F.count_star().with_name("n")),
        batch_rows=batch_rows)
    _same(ref, got)


def test_q1_over_decimals_takes_the_dense_route(monkeypatch):
    """Two limbs a decimal aggregate: q1's five decimal aggregates, two
    double sums and count go through one dense_groupby call a batch (12
    columns), and the decimal totals equal Python's."""
    from spark_rapids_tpu_torch.exec import aggregate as AG
    t = _q1_table(6000)
    calls = []
    real = AG.dense_groupby

    def spy(pairs, remaps, cards, keep, columns, G):
        calls.append(len(columns))
        return real(pairs, remaps, cards, keep, columns, G)
    monkeypatch.setattr(AG, "dense_groupby", spy)
    s = _port()
    F = PF
    got = s.create_dataframe(t).group_by("rf", "ls").agg(
        F.sum(F.col("qty")).with_name("sq"),
        F.sum(F.col("price")).with_name("sp"),
        F.sum(F.col("price") * (F.lit(1.0) - F.col("qty"))).with_name("dd"),
        F.avg(F.col("qty")).with_name("aq"),
        F.avg(F.col("price")).with_name("ap"),
        F.count_star().with_name("n")).collect()
    assert calls and set(calls) == {9}
    rows = t.to_pylist()
    for r in got:
        mine = [x for x in rows if x["rf"] == r["rf"] and x["ls"] == r["ls"]]
        assert r["sq"] == sum(x["qty"] for x in mine)
        assert r["sp"] == sum(x["price"] for x in mine)
        assert r["n"] == len(mine)
        want = (sum(x["qty"] for x in mine) / len(mine)).quantize(
            D("0.000001"), rounding=decimal.ROUND_HALF_UP)
        assert r["aq"] == want


def test_min_max_count_key_and_order_by_equal_reference():
    rows = [D(f"{i % 5}.25") for i in range(600)]
    t = pa.table({"d": pa.array(rows, type=pa.decimal128(9, 2)),
                  "v": pa.array(list(range(600)), type=pa.int64()),
                  "e": pa.array([None if i % 7 == 0 else D(i - 300).scaleb(-3)
                                 for i in range(600)], pa.decimal128(12, 3))})
    ref, got = run_both(t, lambda df, F, E: df.group_by("d").agg(
        F.sum(F.col("v")).with_name("s"), F.count_star().with_name("n"),
        F.min(F.col("e")).with_name("mn"), F.max(F.col("e")).with_name("mx"),
        F.count(F.col("e")).with_name("c")), batch_rows=200)
    _same(ref, got)
    ref, got = run_both(t, lambda df, F, E: df.order_by(
        F.col("e").desc(), F.col("v")).select("e", "v"))
    _same(ref, got, ordered=True)


def test_decimal_to_double_equals_reference_and_java():
    """A decimal cast to double is the nearest double (Java's
    BigDecimal.doubleValue): the reference divides the unscaled value by
    10^s, correctly rounded while it is below 2^53."""
    rng = np.random.RandomState(3)
    vals = [D(int(x)).scaleb(-2) for x in rng.randint(-10**12, 10**12, 500)]
    t = pa.table({"d": pa.array(vals, pa.decimal128(15, 2))})
    ref, got = run_both(t, lambda df, F, E: df.select(
        F.col("d").cast("double").alias("x")))
    _same(ref, got, ordered=True)
    wide = [D(2**62 + 12345).scaleb(-3), D(-(2**60) - 7).scaleb(-19),
            D(2**53 + 1).scaleb(-1), D(9007199254740993).scaleb(-25)]
    for v in wide:
        s = -v.as_tuple().exponent
        t = pa.table({"d": pa.array([v], pa.decimal128(38, s))})
        got = _port().create_dataframe(t).select(
            PF.col("d").cast("double").alias("x")).collect()[0]["x"]
        assert got == float(v), (v, got)   # Python's float() of a Decimal
        # is correctly rounded, as Java's doubleValue is


@pytest.mark.parametrize("kind", ["flba", "int", "dict"])
def test_parquet_decimals_equal_reference(tmp_path, kind):
    """FIXED_LEN_BYTE_ARRAY (pyarrow's default), INT32/INT64
    (``store_decimal_as_integer``), dictionary pages; NULLs, negatives and
    row-group pruning on a decimal predicate."""
    rng = np.random.RandomState(5)
    n = 3000
    a = [None if i % 11 == 0 else D(int(x)).scaleb(-2)
         for i, x in enumerate(rng.randint(-10**9, 10**9, n))]
    b = [D(int(x)).scaleb(-1) for x in rng.randint(-99999, 99999, n)]
    c = [D(int(x)).scaleb(-4) for x in rng.randint(-10**15, 10**15, n)]
    t = pa.table({"a": pa.array(a, pa.decimal128(15, 2)),
                  "b": pa.array(b, pa.decimal128(6, 1)),
                  "c": pa.array(c, pa.decimal128(30, 4)),
                  "k": pa.array(np.arange(n) % 5)})
    p = str(tmp_path / f"{kind}.parquet")
    pq.write_table(t, p, row_group_size=1000, use_dictionary=kind == "dict",
                   store_decimal_as_integer=kind != "flba")
    ref_s, port_s = sessions()

    ref = ref_s.read_parquet(p).collect_arrow()
    got = port_s.read_parquet(p).collect_arrow()
    _same(ref, got, ordered=True)
    _same(t, got, ordered=True)
    # the reference's aggregates over these files raise ArrowInvalid in
    # some layouts: the port's are held to Python's sums here
    got = port_s.read_parquet(p).filter(PF.col("b") > PF.lit(0)).group_by(
        "k").agg(PF.sum(PF.col("a")).with_name("sa"),
                 PF.min(PF.col("b")).with_name("mb"),
                 PF.max(PF.col("c")).with_name("mc")).collect()
    for r in got:
        rows = [x for x in t.to_pylist() if x["k"] == r["k"] and x["b"] > 0]
        assert r["sa"] == sum(x["a"] for x in rows if x["a"] is not None)
        assert r["mb"] == min(x["b"] for x in rows)
        assert r["mc"] == max(x["c"] for x in rows)
    # pruning: a decimal literal above every value skips each group
    assert port_s.read_parquet(p).filter(
        PF.col("a") > PF.lit(D("99999999.99"))).collect() == []


@pytest.mark.parametrize("kind", ["flba", "int"])
def test_parquet_pruning_at_a_group_boundary_keeps_float_matches(tmp_path,
                                                                  kind):
    """A decimal compares with a double as its nearest double, so a row
    group made only of 0.05 matches ``d >= 0.05`` although the Decimal
    0.05 is below float(0.05); the pruning check compares as the card
    does. Held to the same filters over the table in memory, where
    nothing is pushed down; the last two filters are a double column with
    decimal literals."""
    vals = [D("0.05")] * 10 + [D("0.06")] * 10 + [D("0.10")] * 10
    t = pa.table({"d": pa.array(vals, pa.decimal128(15, 2)),
                  "f": pa.array([float(v) for v in vals]),
                  "i": pa.array(np.arange(30))})
    p = str(tmp_path / f"{kind}.parquet")
    pq.write_table(t, p, row_group_size=10, use_dictionary=False,
                   store_decimal_as_integer=kind == "int")
    s = _port()
    F = PF
    filters = [F.col("d") == F.lit(0.05), F.col("d") >= F.lit(0.05),
               F.col("d") <= F.lit(0.06), F.col("d") > F.lit(0.05),
               F.lit(0.06) >= F.col("d"),
               F.col("f") == F.lit(D("0.05")), F.col("f") <= F.lit(D("0.06"))]
    for cond in filters:
        want = s.create_dataframe(t).filter(cond).select("i").collect()
        got = s.read_parquet(p).filter(cond).select("i").collect()
        assert sorted(r["i"] for r in got) == sorted(r["i"] for r in want)
        assert want, cond.name_hint
    s.read_parquet(p).create_or_replace_temp_view("pq")
    s.create_dataframe(t).create_or_replace_temp_view("mem")
    for where in ("d = 0.05", "d >= 0.05", "d <= 0.06", "0.05 <= d"):
        got, want = (sorted(r["i"] for r in s.sql(
            f"SELECT i FROM {v} WHERE {where}").collect())
            for v in ("pq", "mem"))
        assert got == want and want, where


# ---------------------------------------------------------------------------
# Spark's answers where the reference departs
# ---------------------------------------------------------------------------

def _q(v: D, scale: int) -> D:
    return v.quantize(D(1).scaleb(-scale), rounding=decimal.ROUND_HALF_UP,
                      context=CTX)


def _fit(v, dt: DecimalType):
    """Spark's CheckOverflow (non-ANSI): NULL past the precision (and past
    the port's int64 lane)."""
    if v is None:
        return None
    u = int(v.scaleb(dt.scale, CTX))
    if abs(u) >= 10 ** dt.precision or not -2**63 <= u < 2**63:
        return None
    return v


def _div38(a: D, b: D, scale: int) -> D:
    """Spark's Decimal./: BigDecimal.divide at scale 38 HALF_UP, then the
    cast to the result's scale HALF_UP."""
    num = a.scaleb(38, CTX) / b                       # exact below 76 digits
    q38 = _q(num, 0).scaleb(-38, CTX)
    return _q(q38, scale)


ARITH = pa.table({
    "a": pa.array([D("1.25"), D("2.50"), None, D("0.01"), D("-1.25"),
                   D("9999999999999.99"), D("-0.05")], pa.decimal128(15, 2)),
    "b": pa.array([D("0.3333"), D("-2.0000"), D("1.0000"), D("0.0000"),
                   D("3.0000"), D("0.0001"), D("0.0300")],
                  pa.decimal128(15, 4)),
    "i": pa.array([2, 3, 4, 5, 0, -7, 3], pa.int32())})


def _spark_rows():
    """(name, Spark's result type, per row the answer) of each
    expression of ``test_arithmetic_follows_spark``."""
    rows = ARITH.to_pylist()
    ta, tb, ti = DecimalType(15, 2), DecimalType(15, 4), DecimalType(10, 0)

    def add_t(l, r):
        s = max(l.scale, r.scale)
        return adjust_precision_scale(max(l.precision - l.scale,
                                          r.precision - r.scale) + s + 1, s)
    mul_t = adjust_precision_scale(ta.precision + tb.precision + 1,
                                   ta.scale + tb.scale)
    div_s = max(6, ta.scale + tb.precision + 1)
    div_t = adjust_precision_scale(ta.precision - ta.scale + tb.scale
                                   + div_s, div_s)
    mod_t = adjust_precision_scale(min(13, 11) + 4, 4)
    divi_s = max(6, ta.scale + ti.precision + 1)
    divi_t = adjust_precision_scale(ta.precision - ta.scale + divi_s, divi_s)

    def each(f):
        return [None if r["a"] is None or r["b"] is None else f(r)
                for r in rows]
    t_add = add_t(ta, tb)
    return {
        "add": (t_add, each(lambda r: _fit(_q(r["a"] + r["b"], t_add.scale),
                                           t_add))),
        "sub": (t_add, each(lambda r: _fit(_q(r["a"] - r["b"], t_add.scale),
                                           t_add))),
        "mul": (mul_t, each(lambda r: _fit(_q(CTX.multiply(r["a"], r["b"]),
                                              mul_t.scale), mul_t))),
        "div": (div_t, each(lambda r: None if r["b"] == 0 else _fit(
            _div38(r["a"], r["b"], div_t.scale), div_t))),
        "mod": (mod_t, each(lambda r: None if r["b"] == 0 else _fit(
            _q(CTX.remainder(r["a"], r["b"]), 4), mod_t))),
        "ai": (adjust_precision_scale(26, 2), [
            None if r["a"] is None else _fit(r["a"] * r["i"],
                                             DecimalType(26, 2))
            for r in rows]),
        "adi": (divi_t, [None if r["a"] is None or r["i"] == 0 else _fit(
            _div38(r["a"], D(r["i"]), divi_t.scale), divi_t) for r in rows]),
        "one_minus": (DecimalType(16, 2), [
            None if r["a"] is None else D(1) - r["a"] for r in rows]),
        "neg": (ta, [None if r["a"] is None else -r["a"] for r in rows]),
    }


def test_arithmetic_follows_spark():
    """``+ - * / %`` over decimal(15,2) and decimal(15,4), a decimal by an
    int and by an integral literal: Spark's result types and values. The
    reference raises ArrowInvalid for all but ``/``, which it gives as a
    double (ROADMAP.md Queue C)."""
    F = PF
    a, b, i = F.col("a"), F.col("b"), F.col("i")
    got = _port().create_dataframe(ARITH).select(
        (a + b).alias("add"), (a - b).alias("sub"), (a * b).alias("mul"),
        (a / b).alias("div"), (a % b).alias("mod"), (a * i).alias("ai"),
        (a / i).alias("adi"), (F.lit(1) - a).alias("one_minus"),
        (-a).alias("neg")).collect_arrow()
    for name, (dt, want) in _spark_rows().items():
        assert got.schema.field(name).type == pa.decimal128(
            dt.precision, dt.scale), name
        assert got.column(name).to_pylist() == want, name


def test_add_and_remainder_past_an_int64_rescale_follow_spark():
    """decimal(38,0) with decimal(38,10): ``+`` and ``-`` give (38,6),
    ``%`` gives (38,10). At the larger scale 10^12 is 10^22 unscaled, past
    int64, where every answer below fits its type: these run through
    decimal_arith's add and remainder, exact then HALF_UP (ties of both
    signs)."""
    big = pa.table({
        "x": pa.array([D(10 ** 12), D(-10 ** 12), D(7), D(10 ** 18), None,
                       D(5)], pa.decimal128(38, 0)),
        "y": pa.array([D("1.0000005000"), D("-1.0000005000"),
                       D("-0.0000005001"), D("0.0000000001"), D(1),
                       D("0E-10")], pa.decimal128(38, 10))})
    F = PF
    x, y = F.col("x"), F.col("y")
    got = _port().create_dataframe(big).select(
        (x + y).alias("add"), (x - y).alias("sub"), (x % y).alias("mod"),
        (y - x).alias("rsub")).collect_arrow()
    want = {"add": (38, 6, lambda a, b: _q(a + b, 6)),
            "sub": (38, 6, lambda a, b: _q(a - b, 6)),
            "mod": (38, 10, lambda a, b: None if b == 0 else
                    CTX.remainder(a, b).quantize(D("1E-10"))),
            "rsub": (38, 6, lambda a, b: _q(b - a, 6))}
    rows = big.to_pylist()
    for name, (p, s, f) in want.items():
        assert got.schema.field(name).type == pa.decimal128(p, s), name
        exp = [None if r["x"] is None or r["y"] is None
               else _fit(f(r["x"], r["y"]), DecimalType(p, s))
               for r in rows]
        assert got.column(name).to_pylist() == exp, name
    assert got.column("add").to_pylist()[:3] == [
        D("1000000000001.000001"), D("-1000000000001.000001"),
        D("6.999999")]
    # 10^12 = 999999500000 * 1.0000005 + 0.25
    assert got.column("mod").to_pylist()[:2] == [D("0.2500000000"),
                                                 D("-0.2500000000")]
    # 10^18 at scale 6 passes int64 (the port's lane): NULL, as past the
    # precision
    assert got.column("add").to_pylist()[3] is None


@pytest.mark.parametrize("l,r,op,want_type", [
    ((38, 10), (38, 10), "*", (38, 6)),
    ((38, 10), (38, 10), "/", (38, 6)),
    ((38, 10), (38, 10), "+", (38, 9)),
    ((15, 2), (16, 2), "*", (32, 4)),
    ((32, 4), (16, 2), "*", (38, 6)),
    ((10, 0), (10, 0), "/", (21, 11)),
    ((18, 4), (38, 2), "%", (18, 4)),
])
def test_precision_loss_types_follow_spark(l, r, op, want_type):
    """Spark's adjustPrecisionScale examples: decimal(38,10) *
    decimal(38,10) is decimal(38,6), and the rest; values computed by
    hand at those types."""
    x, y = D(7).quantize(D(1).scaleb(-l[1])), \
        D(3).quantize(D(1).scaleb(-r[1]))
    t = pa.table({"x": pa.array([x, -x, None], pa.decimal128(*l)),
                  "y": pa.array([y, y, y], pa.decimal128(*r))})
    F = PF
    e = {"*": F.col("x") * F.col("y"), "/": F.col("x") / F.col("y"),
         "+": F.col("x") + F.col("y"), "%": F.col("x") % F.col("y")}[op]
    got = _port().create_dataframe(t).select(e.alias("o")).collect_arrow()
    assert got.schema.field("o").type == pa.decimal128(*want_type)
    exact = {"*": lambda u, v: u * v, "/": lambda u, v: u / v,
             "+": lambda u, v: u + v,
             "%": lambda u, v: CTX.remainder(u, v)}[op]
    want = [_q(exact(x, y), want_type[1]), _q(exact(-x, y), want_type[1]),
            None]
    assert got.column("o").to_pylist() == want


def test_overflow_and_zero_divisor_are_null():
    t = pa.table({"x": pa.array([D("99999999999999999.9"), D("1.0")],
                                pa.decimal128(18, 1)),
                  "z": pa.array([D("0.0"), D("0.0")], pa.decimal128(18, 1))})
    F = PF
    got = _port().create_dataframe(t).select(
        (F.col("x") * F.col("x")).alias("sq"), (F.col("x") / F.col("z"))
        .alias("dz"), (F.col("x") % F.col("z")).alias("mz"),
        F.col("x").cast("decimal(3,1)").alias("c")).collect()
    assert got == [{"sq": None, "dz": None, "mz": None, "c": None},
                   {"sq": D("1.00"), "dz": None, "mz": None, "c": D("1.0")}]


def test_average_follows_spark():
    """avg of a decimal is decimal(p+4, s+4): Spark's Divide of the exact
    total by the count (rounded at scale 38, then at the division's
    scale), cast HALF_UP; the reference raises ArrowInvalid."""
    vals = [D("1.01"), D("2.02"), D("0.04"), None, D("-0.01")]
    t = pa.table({"k": pa.array([1, 1, 1, 2, 2]),
                  "d": pa.array(vals, pa.decimal128(15, 2))})
    got = _port().create_dataframe(t).group_by("k").agg(
        PF.avg(PF.col("d")).with_name("a")).order_by("k").collect_arrow()
    assert got.schema.field("a").type == pa.decimal128(19, 6)
    assert got.column("a").to_pylist() == [
        _q(D("3.07") / 3, 6), D("-0.010000")]


def test_join_on_decimal_keys_of_different_scales():
    """Keys compare at the larger scale: 1.25 = 1.2500; 3.0001 matches
    nothing. Held to the reference where it answers, else to Spark."""
    l = pa.table({"a": pa.array([D("1.25"), D("2.50"), None, D("3")],
                                pa.decimal128(15, 2)), "x": [1, 2, 3, 4]})
    r = pa.table({"b": pa.array([D("1.2500"), D("2.5"), D("3.0001"),
                                 D("3")], pa.decimal128(9, 4)),
                  "y": [10, 20, 30, 40]})
    s = _port()
    got = s.create_dataframe(l).join(s.create_dataframe(r), on=[("a", "b")],
                                     how="inner").collect()
    assert sorted((g["x"], g["y"]) for g in got) == [(1, 10), (2, 20),
                                                     (4, 40)]
    full = s.create_dataframe(l).join(s.create_dataframe(r),
                                      on=[("a", "b")], how="full").collect()
    assert sorted((g["x"] or 0, g["y"] or 0) for g in full) == [
        (0, 30), (1, 10), (2, 20), (3, 0), (4, 40)]
    try:
        from spark_rapids_tpu.api import TpuSession
        rs = TpuSession(OFF)
        ref = rs.create_dataframe(l).join(rs.create_dataframe(r),
                                          on=[("a", "b")], how="inner")
        ref_rows = sorted((g["x"], g["y"]) for g in ref.collect())
    except Exception:       # the reference does not answer this join
        return
    assert ref_rows == [(1, 10), (2, 20), (4, 40)]


def test_comparisons_with_an_int_literal_follow_spark():
    """0.01 > 0 and 1.25 > 1: the reference truncates the decimal before
    it compares (ROADMAP.md Queue C)."""
    t = pa.table({"a": pa.array([D("0.01"), D("1.25"), D("1.00"), D("-0.5"),
                                 None], pa.decimal128(15, 2))})
    F = PF
    got = _port().create_dataframe(t).select(
        (F.col("a") > F.lit(0)).alias("gt0"),
        (F.col("a") > F.lit(1)).alias("gt1"),
        (F.col("a") == F.lit(1)).alias("eq1"),
        (F.col("a") <= F.lit(D("1.0"))).alias("le"),
        ((F.col("a") >= F.lit(0)) & (F.col("a") <= F.lit(1))).alias("btw"),
        F.col("a").isin(1, D("1.25"), 0.01).alias("isin"),
        (F.col("a") < F.lit(0.5)).alias("ltd")).collect()
    assert [list(r.values()) for r in got] == [
        [True, False, False, True, True, True, True],
        [True, True, False, False, False, True, False],
        [True, False, True, True, True, True, False],
        [False, False, False, True, False, False, True],
        [None] * 7]
    sql = _port()
    sql.create_dataframe(t).create_or_replace_temp_view("t")
    rows = sql.sql("SELECT count(*) AS n FROM t WHERE a > 0").collect()
    assert rows == [{"n": 3}]


def test_casts_follow_spark():
    """Spark 3.5's non-ANSI casts: decimal to integral truncates, to
    decimal rounds HALF_UP or overflows to NULL, a double goes through its
    shortest decimal form (1.005 -> 1.01, 2.675 -> 2.68), NaN and
    infinities are NULL; SQL's CAST AS DECIMAL(p, s) and bare DECIMAL."""
    t = pa.table({"a": pa.array([D("1.25"), D("-2.55"), D("123.45"), None],
                                pa.decimal128(15, 2)),
                  "x": [1.005, 2.675, float("nan"), -0.125],
                  "i": pa.array([7, -300, 2**31 - 1, 0], pa.int32())})
    F = PF
    got = _port().create_dataframe(t).select(
        F.col("a").cast("int").alias("ai"),
        F.col("a").cast("tinyint").alias("at"),
        F.col("a").cast("decimal(4,1)").alias("a41"),
        F.col("a").cast("decimal(3,1)").alias("a31"),
        F.col("a").cast("boolean").alias("ab"),
        F.col("x").cast("decimal(5,2)").alias("x52"),
        F.col("i").cast("decimal(4,1)").alias("i41"),
        F.col("a").cast("float").alias("af")).collect()
    assert [r["ai"] for r in got] == [1, -2, 123, None]
    assert [r["at"] for r in got] == [1, -2, 123, None]
    assert [r["a41"] for r in got] == [D("1.3"), D("-2.6"), D("123.5"), None]
    assert [r["a31"] for r in got] == [D("1.3"), D("-2.6"), None, None]
    assert [r["ab"] for r in got] == [True, True, True, None]
    assert [r["x52"] for r in got] == [D("1.01"), D("2.68"), None,
                                       D("-0.13")]
    assert [r["i41"] for r in got] == [D("7.0"), D("-300.0"), None,
                                       D("0.0")]
    # float: the nearest double rounded to float, exact here
    assert [r["af"] for r in got][:3] == [np.float32(1.25), np.float32(-2.55),
                                          np.float32(123.45)]
    s = _port()
    s.create_dataframe(t).create_or_replace_temp_view("t")
    rows = s.sql("SELECT CAST(x AS DECIMAL(6, 3)) AS d, CAST(a AS DECIMAL) "
                 "AS e FROM t").collect()
    assert [r["d"] for r in rows] == [D("1.005"), D("2.675"), None,
                                      D("-0.125")]
    assert [r["e"] for r in rows] == [D("1"), D("-3"), D("123"), None]
    assert s.sql("SELECT CAST(a AS DECIMAL) AS e FROM t").schema()["e"] \
        .dtype == DecimalType(10, 0)


def test_literals_follow_spark():
    """A Python Decimal literal is decimal(max(digits, scale), scale). SQL
    numeric literals keep the reference's typing (ROADMAP.md Queue C):
    ``1`` is an int, so ``1 - d`` stays decimal; ``0.05`` is a double, so
    ``d + 0.05`` is a double."""
    s = _port()
    got = s.create_dataframe({"k": np.arange(2)}).select(
        PF.lit(D("1.00")).alias("a"), PF.lit(D("0.05")).alias("b"),
        PF.lit(D("-123.4")).alias("c")).collect_arrow()
    assert [f.type for f in got.schema] == [
        pa.decimal128(3, 2), pa.decimal128(2, 2), pa.decimal128(4, 1)]
    assert got.to_pylist()[0] == {"a": D("1.00"), "b": D("0.05"),
                                  "c": D("-123.4")}
    s.create_dataframe(pa.table({"d": pa.array([D("0.25")],
                                               pa.decimal128(15, 2))})) \
        .create_or_replace_temp_view("t")
    out = s.sql("SELECT 1 - d AS x, d + 0.05 AS y FROM t")
    assert out.schema()["x"].dtype == DecimalType(16, 2)
    assert out.schema()["y"].dtype.name == "double"
    assert out.collect() == [{"x": D("0.75"), "y": 0.3}]


def _xxh64_bytes(data: bytes, seed: int) -> int:
    """Spark's XXH64.hashUnsafeBytes for fewer than 32 bytes."""
    M = (1 << 64) - 1
    P1, P2, P3, P4, P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                          0x27D4EB2F165667C5)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M
    n = len(data)
    h = (seed + P5 + n) & M
    i = 0
    while i + 8 <= n:
        k = int.from_bytes(data[i:i + 8], "little")
        h = (rotl(h ^ (rotl(k * P2 & M, 31) * P1 & M), 27) * P1 + P4) & M
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * P1 & M),
                  23) * P2 + P3) & M
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * P5 & M), 11) * P1 & M
        i += 1
    h ^= h >> 33
    h = h * P2 & M
    h ^= h >> 29
    h = h * P3 & M
    h ^= h >> 32
    return h - (1 << 64) if h >= 1 << 63 else h


def test_hashes_of_decimals():
    """A decimal of precision up to 18 hashes as its unscaled long, as the
    reference's does; a wider one as Spark's BigInteger bytes, where the
    reference hashes the long (ROADMAP.md Queue C)."""
    vals = [D("1.25"), D("-2.50"), None, D("0"), D("92233720368547758.07"),
            D("-0.01"), D("1280.00")]
    t18 = pa.table({"d": pa.array(vals[:4] + vals[5:], pa.decimal128(18, 2))})
    ref, got = run_both(t18, lambda df, F, E: df.select(
        F.hash(F.col("d")).alias("h"), F.xxhash64(F.col("d")).alias("x")))
    _same(ref, got, ordered=True)
    t38 = pa.table({"d": pa.array(vals, pa.decimal128(38, 2))})
    got = _port().create_dataframe(t38).select(
        PF.hash(PF.col("d")).alias("h"),
        PF.xxhash64(PF.col("d")).alias("x")).collect()
    for v, r in zip(vals, got):
        if v is None:
            assert r == {"h": 42, "x": 42}
            continue
        u = int(v.scaleb(2))
        b = u.to_bytes(max(1, (u.bit_length() + 8) // 8), "big", signed=True)
        assert r["h"] == PH.spark_murmur3_bytes(b, 42), v
        assert r["x"] == _xxh64_bytes(b, 42), v


def test_host_table_of_unscaled_values_and_collect_forms():
    """numpy int64 unscaled values with a DecimalType in the schema;
    collect() gives Decimals, collect_numpy() the unscaled int64,
    collect_arrow() decimal128."""
    u = np.array([125, -250, 0, 7], np.int64)
    valid = np.array([True, True, False, True])
    ht = HostTable({"d": (u, valid)},
                   Schema([StructField("d", DecimalType(9, 2))]))
    df = _port().create_dataframe(ht)
    assert [r["d"] for r in df.collect()] == [D("1.25"), D("-2.50"), None,
                                              D("0.07")]
    m = df.collect_numpy()["d"]
    assert m.dtype == np.int64 and m.tolist() == [125, -250, None, 7]
    assert df.collect_arrow().schema.field("d").type == pa.decimal128(9, 2)


def test_decimal_window_value_and_nested_decimals_are_refused():
    t = pa.table({"k": [1, 1, 2], "d": pa.array([D("1.5"), D("2"), None],
                                                pa.decimal128(5, 1))})
    df = _port().create_dataframe(t)
    with pytest.raises(NotImplementedError, match="windows"):
        df.with_window_column("w", PF.sum(PF.col("d")), partition_by=["k"],
                              order_by=["d"]).collect()
    with pytest.raises(NotImplementedError, match="slice 9b"):
        df.group_by("k").agg(PF.collect_list(PF.col("d")).with_name(
            "l")).collect()
    with pytest.raises(NotImplementedError, match="decimals item"):
        df.select((PF.col("d") // PF.lit(2)).alias("q")).collect() \
            if hasattr(PF.col("d"), "__floordiv__") else \
            df.select(PF.pmod(PF.col("d"), PF.lit(2)).alias("q")).collect()


def test_decimal_columns_move_through_concat_spill_and_reference_batches(
        tmp_path):
    """A decimal column slices, concatenates, spills to both tiers and
    comes back, and carries over from a reference batch, as its int64
    lane; an out-of-core ORDER BY on it (64-row batches) equals the
    reference's."""
    from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
    from spark_rapids_tpu_torch.columnar import (ColumnarBatch,
                                                 batch_from_reference)
    from spark_rapids_tpu_torch.columnar.batch import concat_batches
    from spark_rapids_tpu_torch.mem.manager import MemoryManager
    from spark_rapids_tpu_torch.mem.spillable import SpillableBatch
    t = _table(n=300, seed=9)
    b = ColumnarBatch.from_host(HostTable.from_arrow(t), "cpu", 64)
    both = concat_batches([b.slice(0, 100), b.slice(100, 200)])
    want = t.column("d").to_pylist()
    dt = both.schema["d"].dtype
    vals, ok = both.columns[1].to_numpy(both.num_rows)
    assert [D(int(v)).scaleb(-dt.scale) if o else None
            for v, o in zip(vals, ok)] == want
    mm = MemoryManager(1 << 30, 1 << 30, str(tmp_path / "spill"))
    for tier in ("host", "disk"):
        sb = SpillableBatch(both, mm)
        sb.spill_to_host()
        if tier == "disk":
            sb.spill_to_disk()
        back = sb.get()
        assert back.schema == both.schema
        v2, ok2 = back.columns[1].to_numpy(back.num_rows)
        assert (v2[ok2] == vals[ok]).all() and (ok2 == ok).all()
        sb.close()
    ref = RefBatch.from_arrow(t)
    cols = [{"data": np.asarray(c.data), "validity": np.asarray(c.validity)}
            for c in ref.columns]
    port = batch_from_reference(cols, b.schema, "cpu", ref.num_rows)
    v3, ok3 = port.columns[1].to_numpy(port.num_rows)
    assert (v3[ok3] == vals[ok]).all()
    small = {"spark.rapids.tpu.sql.batchSizeRows": 64,
             "spark.rapids.tpu.sql.batchSizeBytes": 2048}
    ref, got = run_both(t, lambda df, F, E: df.order_by(
        F.col("d").desc(), F.col("k")).select("d", "k"), conf=small)
    _same(ref, got, ordered=True)


def test_conditionals_over_decimals():
    """coalesce, greatest, CASE WHEN over decimals: the branches rescaled
    to the common decimal (an int literal as its digits), a double branch
    making the result a double."""
    t = pa.table({"k": [1, 1, 2, 2],
                  "d": pa.array([D("1.25"), D("-2.5"), None, D("3")],
                                pa.decimal128(9, 2)),
                  "v": [4.5, 3.0, 2.0, 1.0]})
    F = PF
    got = _port().create_dataframe(t).select(
        F.coalesce(F.col("d"), F.lit(0)).alias("c"),
        F.greatest(F.col("d"), F.lit(D("1.5"))).alias("g"),
        F.when(F.col("k") == F.lit(1), F.col("d")).otherwise(
            F.lit(D("9.999"))).alias("w"),
        F.when(F.col("k") == F.lit(1), F.col("d")).otherwise(
            F.col("v")).alias("wd")).collect_arrow()
    assert [f.type for f in got.schema] == [
        pa.decimal128(12, 2), pa.decimal128(9, 2), pa.decimal128(10, 3),
        pa.float64()]
    assert got.to_pylist() == [
        {"c": D("1.25"), "g": D("1.50"), "w": D("1.250"), "wd": 1.25},
        {"c": D("-2.50"), "g": D("1.50"), "w": D("-2.500"), "wd": -2.5},
        {"c": D("0.00"), "g": D("1.50"), "w": D("9.999"), "wd": 2.0},
        {"c": D("3.00"), "g": D("3.00"), "w": D("9.999"), "wd": 1.0}]


@pytest.mark.parametrize("case", ["q1", "q6", "q1_sql", "q6_sql", "q3"])
def test_chip_smoke_phase19_queries_equal_numpy(case):
    """chip_smoke.py phase 19's queries at 20,000 lineitem and 60,000
    store_sales rows against the script's numpy forms: q1 and q6
    unmodified over decimal(15,2) lineitem (the decimal totals and
    averages exact, the DataFrame q1's double sums within REL_TOL: they
    add in another order), as SQL, and q3 over decimal(7,2)."""
    import chip_smoke as C
    from benchmarks.queries_sql import TPCH_Q1, TPCH_Q6
    s = TorchSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                     device="cpu")
    F = PF
    if case == "q3":
        ss = C.gen_store_sales(60_000)
        dd, it = C.gen_date_dim(), C.gen_item()
        host = C.decimal_host(ss, ("ss_sold_date_sk", "ss_item_sk",
                                   "ss_ext_sales_price"),
                              C.DEC_STORE_SALES, 7)
        got = C.q3(s.create_dataframe(host), s.create_dataframe(dd),
                   s.create_dataframe(it), F).collect()
        assert got == C.q3_decimal_numpy(ss, dd, it)
        return
    t = C.gen_table(20_000)
    li = C.decimal_host(t, ("l_returnflag", "l_linestatus", "l_shipdate")
                        + C.DEC_LINEITEM, C.DEC_LINEITEM, 15)
    df = s.create_dataframe(li)
    df.create_or_replace_temp_view("lineitem")
    if case.startswith("q6"):
        got = (s.sql(TPCH_Q6) if case == "q6_sql" else C.q6(df, F)).collect()
        assert got == [{"revenue": C.q6_decimal_numpy(t)}]
        return
    got = (s.sql(TPCH_Q1) if case == "q1_sql" else C.q1(df, F)).collect()
    want = C.q1_decimal_numpy(t)[case == "q1_sql"]
    assert C._rows_close(got, want, C.REL_TOL)
    if case == "q1_sql":
        assert got == want      # every aggregate decimal: exact
