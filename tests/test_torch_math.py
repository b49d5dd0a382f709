"""The port's math functions (``spark_rapids_tpu_torch/exprs/math_fns.py``)
against the reference's (``spark_rapids_tpu/exprs/math_fns.py``) and
against Spark.

The same seeded columns (double and float with NULL, NaN, +-inf, -0.0, 0,
negative, tiny and large values planted; int and bigint) go through every
class on both packages, and the port's answer is also held to numpy's.

Tolerances, and why:
  * transcendentals: within 4 ulps of numpy's (glibc's) value: torch on
    the CPU and CUDA's libdevice each round in their own way, both within
    a few ulps of the correctly rounded result; within a relative 1e-12
    (absolute 1e-300) of the reference's, whose XLA CPU functions are
    approximations up to ~150 ulps off and flush subnormal results to 0;
  * everything else (floor, ceil, round, bround, signum, rint, degrees,
    radians, the NULL masks): exactly.

The departures from the reference (ROADMAP.md Queue C), each held to
Spark's answer here: NULL logarithms of x <= 0, floor/ceil of +-inf,
NaN and values past 2**63 (and of bigints past 2**53), round/bround of
values already integral at the scale, and Math.pow's NaN for |base| = 1
with an infinite exponent. Left open: ``round(1.005, 2)`` is 1.0 here
and in the reference (1.005 * 100 is 100.49999999999999 as a double),
1.01 in Spark, which rounds the shortest decimal form. (``round(2.675,
2)`` happens to agree: 2.675 * 100 rounds to 267.5 exactly.)
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF

from test_torch_slice import prebuild_reference_native
from torch_compare import OFF, column, frames_equal, run_both, within_ulps

N = 400

_SPECIAL = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5, math.nan, math.inf,
            -math.inf, 1e-300, -1e-300, 123.456, -7.25, 3.0, 2.675,
            1e15 + 0.5, 4.5e15, 1.7e308, -1.7e308, 9.3e18, -9.3e18, 0.999]


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _table(seed: int = 0) -> pa.Table:
    rng = np.random.RandomState(seed)
    d = rng.standard_normal(N) * 10.0 ** rng.randint(-3, 3, N)
    d = np.where(rng.rand(N) < 0.2, np.round(d, 1), d)
    pos = rng.choice(N, len(_SPECIAL) * 3, replace=False)
    d[pos] = np.tile(_SPECIAL, 3)
    null = rng.rand(N) < 0.08
    null[pos] = False
    i = rng.randint(-1000, 1000, N).astype(np.int32)
    i[:4] = [0, -1, 1, 2]
    big = rng.randint(-(2 ** 50), 2 ** 50, N)
    return pa.table({
        "d": pa.array(d, mask=null),
        "f": pa.array(np.clip(d, -3e38, 3e38).astype(np.float32),
                      mask=null),
        "i": pa.array(i, mask=rng.rand(N) < 0.08),
        "l": pa.array(big, type=pa.int64()),
        "e": pa.array(rng.choice([0.0, 0.5, 2.0, -1.0, 3.0, math.nan,
                                  math.inf, -math.inf], N)),
    })


_UNARY = ["Sqrt", "Exp", "Log", "Log10", "Log2", "Log1p", "Expm1", "Sin",
          "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Tanh",
          "Cbrt", "ToDegrees", "ToRadians", "Rint", "Asinh", "Acosh",
          "Atanh", "Cot", "Signum"]
_NUMPY = {"Sqrt": np.sqrt, "Exp": np.exp, "Log": np.log, "Log10": np.log10,
          "Log2": np.log2, "Log1p": np.log1p, "Expm1": np.expm1,
          "Sin": np.sin, "Cos": np.cos, "Tan": np.tan, "Asin": np.arcsin,
          "Acos": np.arccos, "Atan": np.arctan, "Sinh": np.sinh,
          "Cosh": np.cosh, "Tanh": np.tanh, "Cbrt": np.cbrt,
          "ToDegrees": np.degrees, "ToRadians": np.radians, "Rint": np.rint,
          "Asinh": np.arcsinh, "Acosh": np.arccosh, "Atanh": np.arctanh,
          "Cot": lambda x: 1.0 / np.tan(x), "Signum": np.sign}
#: where Spark's answer is NULL (UnaryLogExpression's yAsymptote)
_NULL_AT = {"Log": 0.0, "Log10": 0.0, "Log2": 0.0, "Log1p": -1.0}
_EXACT = {"ToDegrees", "ToRadians", "Rint", "Signum"}


@pytest.mark.parametrize("name", _UNARY)
def test_unary_double_equals_reference(name):
    t = _table(1)
    cols = ["d", "f", "i", "l"]
    ref, got = run_both(t, lambda df, F, E: df.select(*[
        F.Col(getattr(E, name)(F.col(c).expr)).alias(c) for c in cols]))
    for c in cols:
        x, xn = column(t, c)
        x = x.astype(np.float64)
        rv, rn = column(ref, c)
        pv, pn = column(got, c)
        spark_null = np.zeros(len(x), bool)
        if name in _NULL_AT:
            with np.errstate(invalid="ignore"):
                spark_null = ~xn & (x <= _NULL_AT[name])
        # the port is NULL where the input is, and where Spark is
        assert (pn == (xn | spark_null)).all(), (name, c)
        assert (rn == xn).all(), (name, c)
        keep = ~pn
        with np.errstate(all="ignore"):
            want = _NUMPY[name](x[keep])
        if name == "Signum":
            want = np.where(np.isnan(x[keep]), np.nan, want)
        if name in _EXACT:
            np.testing.assert_array_equal(pv[keep], want, err_msg=name)
            np.testing.assert_array_equal(pv[keep], rv[keep], err_msg=name)
            continue
        within_ulps(pv[keep], want, 4, f"{name}({c}) against numpy")
        r = rv[keep]
        assert (np.isnan(pv[keep]) == np.isnan(r)).all(), (name, c)
        fin = np.isfinite(r) & np.isfinite(pv[keep])
        np.testing.assert_allclose(pv[keep][fin], r[fin], rtol=1e-12,
                                   atol=1e-300, err_msg=f"{name}({c})")


def test_log_family_is_null_where_spark_is():
    """Departure: Spark's ln/log10/log2 of x <= 0, log1p of x <= -1 and
    log(base, x) with either <= 0 are NULL; the reference gives -inf or
    NaN (its math_fns.py _mk and Logarithm)."""
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({"x": [0.0, -0.0, -2.0, -1.0, 1.0,
                                            math.nan, math.e]}))
    x = PF.col("x")
    rows = df.select(PF.ln(x).alias("ln"), PF.log10(x).alias("l10"),
                     PF.log2(x).alias("l2"), PF.log1p(x).alias("l1p"),
                     PF.log(PF.lit(2.0), x).alias("lb"),
                     PF.log(x, PF.lit(8.0)).alias("bx")).collect()
    ln = [r["ln"] for r in rows]
    assert ln[:4] == [None] * 4 and ln[4] == 0.0 and math.isnan(ln[5])
    assert ln[6] == pytest.approx(1.0, rel=1e-15)
    assert [r["l10"] for r in rows][:4] == [None] * 4
    assert [r["l2"] for r in rows][:4] == [None] * 4
    l1p = [r["l1p"] for r in rows]
    assert l1p[2:4] == [None, None] and l1p[0] == 0.0
    assert [r["lb"] for r in rows][:4] == [None] * 4
    assert [r["bx"] for r in rows][:4] == [None] * 4
    assert [r["bx"] for r in rows][6] == pytest.approx(math.log(8.0))


@pytest.mark.parametrize("name", ["Floor", "Ceil"])
def test_floor_ceil_equal_reference_and_java(name):
    """Equal to the reference on finite doubles within the long range and
    on ints; NaN, +-inf and values past 2**63 convert as Java's (long)
    (departure: the reference's bare conversion); a bigint is unchanged,
    past 2**53 too (the reference rounds it through a double)."""
    t = _table(2)
    ref, got = run_both(t, lambda df, F, E: df.select(*[
        F.Col(getattr(E, name)(F.col(c).expr)).alias(c)
        for c in ("d", "f", "i")]))
    rnd = np.floor if name == "Floor" else np.ceil
    for c in ("d", "f", "i"):
        x, xn = column(t, c)
        x = x.astype(np.float64)
        rv, rn = column(ref, c)
        pv, pn = column(got, c)
        assert (pn == xn).all() and (rn == xn).all()
        ok = ~xn & np.isfinite(x) & (np.abs(x) < 2.0 ** 62)
        np.testing.assert_array_equal(pv[ok], rv[ok], err_msg=f"{name}({c})")
        with np.errstate(invalid="ignore"):
            java = np.where(np.isnan(x), 0, np.where(
                rnd(x) >= 2.0 ** 63, 2 ** 63 - 1, np.where(
                    rnd(x) <= -2.0 ** 63, -2 ** 63,
                    np.nan_to_num(rnd(x)).clip(-2.0 ** 62, 2.0 ** 62)
                    .astype(np.int64))))
        odd = ~xn & ~ok
        np.testing.assert_array_equal(pv[odd], java[odd])
    s = TorchSession(OFF, device="cpu")
    big = [2 ** 53 + 1, -(2 ** 62) - 3]
    rows = s.create_dataframe(pa.table({"l": pa.array(big, pa.int64())})) \
        .select(PF.floor(PF.col("l")).alias("a"),
                PF.ceil(PF.col("l")).alias("b")).collect()
    assert [r["a"] for r in rows] == big and [r["b"] for r in rows] == big
    rows = s.create_dataframe(pa.table({"x": [math.inf, -math.inf, math.nan,
                                              1e300]})) \
        .select(PF.floor(PF.col("x")).alias("a"),
                PF.ceil(PF.col("x")).alias("b")).collect()
    assert [r["a"] for r in rows] == [2 ** 63 - 1, -2 ** 63, 0, 2 ** 63 - 1]
    assert [r["b"] for r in rows] == [2 ** 63 - 1, -2 ** 63, 0, 2 ** 63 - 1]


@pytest.mark.parametrize("name", ["Round", "BRound"])
@pytest.mark.parametrize("scale", [0, 2, -1])
def test_round_equals_reference(name, scale):
    """HALF_UP (round) and HALF_EVEN (bround) at a scale, in the input's
    type: equal to the reference exactly, except where the value is
    integral at the scale already (|x| * 10**d >= 2**52), where Spark's
    answer is x itself and the reference's scaled form can overflow.
    Floats equal the scaled formula in numpy exactly and the reference
    within an ulp (XLA rewrites the division by the scale)."""
    t = _table(3)
    cols = ["d", "f", "i", "l"]
    ref, got = run_both(t, lambda df, F, E: df.select(*[
        F.Col(getattr(E, name)(F.col(c).expr, scale)).alias(c)
        for c in cols]))
    for c in cols:
        x, xn = column(t, c)
        rv, rn = column(ref, c)
        pv, pn = column(got, c)
        assert (pn == xn).all() and (rn == xn).all()
        xd = x.astype(np.float64)
        with np.errstate(all="ignore"):
            big = ~np.isfinite(xd) | (np.abs(xd) * 10.0 ** scale >= 2.0 ** 52)
        if t.column(c).type in (pa.int32(), pa.int64()):
            big = np.zeros(len(x), bool)
        ok = ~xn & ~big
        if c in ("i", "l"):
            np.testing.assert_array_equal(pv[ok], rv[ok], err_msg=c)
        else:
            # the scaled form in numpy, the port's arithmetic, exactly;
            # the reference within an ulp: XLA multiplies by the scale's
            # reciprocal where the formula divides by the scale
            sc = 10.0 ** scale
            with np.errstate(all="ignore"):
                want = np.sign(xd) * np.floor(np.abs(xd) * sc + 0.5) / sc \
                    if name == "Round" else np.rint(xd * sc) / sc
            want = want.astype(x.dtype)
            np.testing.assert_array_equal(pv[ok], want[ok], err_msg=c)
            within_ulps(pv[ok], rv[ok], 1, f"{name}({c})")
        odd = ~xn & big
        np.testing.assert_array_equal(pv[odd], x[odd])


def test_round_of_large_values_and_the_open_half_case():
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({"x": [1.7e308, -1.7e308, 4.5e15 + 1,
                                            1.005, 1234.5, 2.675]}))
    x = PF.col("x")
    rows = df.select(PF.round(x, 2).alias("r"), PF.bround(x, 2).alias("b"),
                     PF.round(x, -2).alias("m")).collect()
    assert [r["r"] for r in rows][:3] == [1.7e308, -1.7e308, 4.5e15 + 1]
    assert [r["b"] for r in rows][:3] == [1.7e308, -1.7e308, 4.5e15 + 1]
    # left open (ROADMAP.md Queue C): Spark rounds the shortest decimal
    # form, 1.01; the port and the reference round the scaled double
    assert rows[3]["r"] == 1.0
    assert rows[4]["m"] == 1200.0 and rows[5]["r"] == 2.68
    ints = s.create_dataframe(pa.table({"i": pa.array([1250, -1250, 1349,
                                                       -1351], pa.int32())}))
    rows = ints.select(PF.round(PF.col("i"), -2).alias("r"),
                       PF.bround(PF.col("i"), -2).alias("b")).collect()
    assert [r["r"] for r in rows] == [1300, -1300, 1300, -1400]
    assert [r["b"] for r in rows] == [1200, -1200, 1300, -1400]


@pytest.mark.parametrize("name", ["Pow", "Atan2", "Hypot", "Logarithm"])
def test_binary_equal_reference(name):
    t = _table(4)
    ref, got = run_both(t, lambda df, F, E: df.select(*[
        F.Col(getattr(E, name)(F.col(a).expr, F.col(b).expr)).alias(a + b)
        for a, b in (("d", "e"), ("i", "d"), ("e", "f"))]))
    fn = {"Pow": np.power, "Atan2": np.arctan2, "Hypot": np.hypot,
          "Logarithm": lambda b, x: np.log(x) / np.log(b)}[name]
    for a, b in (("d", "e"), ("i", "d"), ("e", "f")):
        x, xn = column(t, a)
        y, yn = column(t, b)
        x, y = x.astype(np.float64), y.astype(np.float64)
        rv, rn = column(ref, a + b)
        pv, pn = column(got, a + b)
        with np.errstate(all="ignore"):
            want = fn(x, y)
            spark_null = (x <= 0) | (y <= 0) if name == "Logarithm" \
                else np.zeros(len(x), bool)
            java_nan = ((np.abs(x) == 1) & np.isinf(y)) | (
                (x == 1) & np.isnan(y)) if name == "Pow" \
                else np.zeros(len(x), bool)
        null = xn | yn
        assert (rn == null).all()
        assert (pn == (null | (~null & spark_null))).all(), name
        keep = ~pn
        want = np.where(java_nan, np.nan, want)
        within_ulps(pv[keep], want[keep], 4, f"{name}({a},{b})")
        same = keep & ~java_nan & np.isfinite(rv) & np.isfinite(pv)
        np.testing.assert_allclose(pv[same], rv[same], rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize("case", ["round_half_up", "floor_negative_half",
                                  "pow_zero_zero", "pow_one_inf_is_nan"])
def test_spark_semantics_math_cases(case):
    """The math cases of tests/test_spark_semantics.py, rebuilt with the
    port's F, and Math.pow's NaN (a departure of the reference)."""
    s = TorchSession(OFF, device="cpu")
    F = PF
    cases = {
        "round_half_up": (lambda: s.create_dataframe(
            pa.table({"a": [2.5, 3.5, -2.5]})).select(
            F.round(F.col("a")).alias("o")), [3.0, 4.0, -3.0]),
        "floor_negative_half": (lambda: s.create_dataframe(
            pa.table({"x": [-2.5]})).select(
            F.floor(F.col("x")).alias("o")), [-3]),
        "pow_zero_zero": (lambda: s.create_dataframe(
            pa.table({"x": [0.0]})).select(
            F.pow(F.col("x"), F.lit(0.0)).alias("o")), [1.0]),
        "pow_one_inf_is_nan": (lambda: s.create_dataframe(
            pa.table({"x": [1.0, -1.0, 1.0, 2.0]})).select(
            F.pow(F.col("x"), F.lit(math.inf)).alias("o")), None),
    }
    build, want = cases[case]
    got = [r["o"] for r in build().collect()]
    if want is None:
        assert all(math.isnan(v) for v in got[:3]) and got[3] == math.inf
    else:
        assert got == want


def test_isnan_nanvl_and_names():
    t = _table(5)
    ref, got = run_both(t, lambda df, F, E: df.select(
        F.isnan(F.col("d")).alias("a"), F.isnan(F.col("i")).alias("b"),
        F.Col(E.NaNvl(F.col("d").expr, F.col("e").expr)).alias("c")))
    frames_equal(got, ref)
    assert isinstance(PF.power("x", 2).expr, type(PF.pow("x", 2).expr))
    # a str is a literal, as in the reference's F; a column is F.col
    assert isinstance(PF.sqrt("x").expr.children[0], type(PF.lit("x").expr))


def test_sql_names_equal_reference():
    """Every SQL name of slice 9a's scalar functions lowers and equals the
    reference (logarithms over positive values: the reference departs
    from Spark at x <= 0)."""
    rng = np.random.RandomState(6)
    n = 200
    days = rng.randint(-25567, 47482, n).astype(np.int32)
    t = pa.table({
        "p": rng.uniform(0.01, 1e6, n),
        "x": rng.standard_normal(n) * 100,
        "d": pa.array(days).cast(pa.date32()),
        "e": pa.array(np.roll(days, 3)).cast(pa.date32()),
        "t": pa.array(rng.randint(-2 * 10 ** 15, 4 * 10 ** 15, n))
        .cast(pa.timestamp("us", tz="UTC"))})
    sql = ("SELECT sqrt(p) a, exp(x / 100) b, ln(p) c, log(p) c2, "
           "floor(x) f, ceil(x) g, ceiling(x) g2, round(x, 1) r, "
           "round(x) r0, year(d) y, month(d) m, day(d) dd, dayofmonth(d) "
           "dm, hour(t) h, minute(t) mi, second(t) s, quarter(d) q, "
           "dayofweek(d) dw, dayofyear(d) dy, isnan(x / 0.0) nn, "
           "datediff(d, e) df, CAST(x AS INT) ci FROM t")
    ref, got = run_both(t, sql=sql)
    # transcendentals within XLA's CPU approximations (module doc); the
    # scaled round within the ulp of XLA's reciprocal
    for c, ulps in (("a", 200), ("b", 200), ("c", 200), ("c2", 200),
                    ("r", 1)):
        within_ulps(column(got, c)[0], column(ref, c)[0], ulps, c)
    exact = [c for c in ref.column_names
             if c not in ("a", "b", "c", "c2", "r")]
    frames_equal(got.select(exact), ref.select(exact))
    s = TorchSession(OFF, device="cpu")
    s.create_dataframe(pa.table({"x": [8.0, -1.0]})) \
        .create_or_replace_temp_view("v")
    rows = s.sql("SELECT log(2.0, x) AS l FROM v").collect()
    assert rows[0]["l"] == pytest.approx(3.0) and rows[1]["l"] is None
