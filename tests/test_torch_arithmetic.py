"""The port's arithmetic family against the reference's, and against the
arithmetic cases of Spark's semantics battery.

The same random columns (int8 to int64, float and double, made with numpy
from a seed) go through every expression of
``spark_rapids_tpu/exprs/arithmetic.py:106-417`` on both packages: nulls,
zeros, -1, the type's MinValue and MaxValue, and for floats NaN, +-inf
and -0.0 are planted in every column. Integers compare exactly; floats
compare bit for bit (every one of these expressions is one IEEE
operation per row, or none), except that a NaN compares equal to any
NaN: the sign of a NaN is not part of Spark's semantics.

One departure, logged in ROADMAP.md Queue C: the reference's ``div``
divides absolute values and ``abs(Long.MinValue)`` wraps, so a ``div``
with Long.MinValue on either side (after the cast to bigint: -inf and
floats below -2^63 saturate to it) is wrong there. Those rows are held to
Java's ``/`` instead, computed here with Python integers.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import exprs as RE
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF

from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
N = 240

_INTS = ["int8", "int16", "int32", "int64"]
_FLOATS = ["float32", "float64"]
_PA = {"int8": pa.int8(), "int16": pa.int16(), "int32": pa.int32(),
       "int64": pa.int64(), "float32": pa.float32(),
       "float64": pa.float64()}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _column(dt: str, seed: int):
    """N values of ``dt`` with the edge values planted, and a null mask."""
    rng = np.random.RandomState(seed)
    t = np.dtype(dt)
    if t.kind == "i":
        info = np.iinfo(t)
        v = rng.randint(info.min, info.max, N, dtype=np.int64).astype(t)
        small = rng.randint(-9, 10, N).astype(t)
        v = np.where(rng.rand(N) < 0.5, small, v)
        special = [0, -1, 1, info.min, info.max, 2, -2, 3]
    else:
        v = (rng.standard_normal(N) * 10.0 ** rng.randint(-3, 6, N)).astype(t)
        v = np.where(rng.rand(N) < 0.3, np.round(v), v).astype(t)
        special = [0.0, -0.0, -1.0, 1.0, np.nan, np.inf, -np.inf, 2.5]
    pos = rng.choice(N, len(special) * 6, replace=False)
    v[pos] = np.tile(np.array(special, dtype=t), 6)
    null = rng.rand(N) < 0.08
    null[pos[:2]] = False
    return v, null


def _table(ldt: str, rdt: str, seed: int = 0):
    lv, ln = _column(ldt, seed)
    rv, rn = _column(rdt, seed + 101)
    return pa.table({
        "a": pa.array(lv, type=_PA[ldt], mask=ln),
        "b": pa.array(rv, type=_PA[rdt], mask=rn),
        "n": pa.array(np.random.RandomState(seed + 7).randint(-70, 140, N),
                      type=pa.int32())})


def _same(got, want) -> bool:
    if got is None or want is None:
        return got is want
    if isinstance(want, float):
        if math.isnan(want):
            return isinstance(got, float) and math.isnan(got)
        return got == want and math.copysign(1, got) == \
            math.copysign(1, want)
    return got == want and type(got) is type(want)


def _run(pkg_exprs, session, t, build):
    cols = {c: pkg_exprs.ColumnRef(c) for c in t.column_names}
    F = RF if pkg_exprs is RE else PF
    return [r["o"] for r in session.create_dataframe(t).select(
        F.Col(build(pkg_exprs, cols)).alias("o")).collect()]


def _to_long(x) -> int:
    """Spark's cast of an int or float to bigint: truncate, saturate, NaN
    to 0."""
    if isinstance(x, float):
        if math.isnan(x):
            return 0
        if x >= 2.0 ** 63:
            return 2 ** 63 - 1
        if x <= -2.0 ** 63:
            return -2 ** 63
        return int(x)
    return x


def _java_div(a, b):
    """Java's long ``/`` over Spark's casts, or None for a zero divisor."""
    a, b = _to_long(a), _to_long(b)
    if b == 0:
        return None
    q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
    return (q + 2 ** 63) % 2 ** 64 - 2 ** 63


_BINARY = ["Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
           "Remainder", "Pmod"]
_BITWISE = ["BitwiseAnd", "BitwiseOr", "BitwiseXor"]
_PAIRS = [(d, d) for d in _INTS + _FLOATS] + [
    ("int32", "int64"), ("int8", "float64"), ("int64", "float32"),
    ("int16", "int32")]


def _check(name, ldt, rdt, build):
    t = _table(ldt, rdt, seed=_INTS.index(ldt) if ldt in _INTS else 9)
    want = _run(RE, TpuSession(OFF), t, build)
    got = _run(PE, TorchSession(OFF, device="cpu"), t, build)
    a = t.column("a").to_pylist()
    b = t.column("b").to_pylist()
    assert len(got) == len(want) == N
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        if name == "IntegralDivide" and None not in (a[i], b[i]) and \
                -2 ** 63 in (_to_long(a[i]), _to_long(b[i])):
            w = _java_div(a[i], b[i])
        if not _same(g, w):
            bad.append((i, a[i], b[i], g, w))
    assert not bad, bad[:8]
    return got, a, b


@pytest.mark.parametrize("ldt,rdt", _PAIRS)
@pytest.mark.parametrize("name", _BINARY)
def test_binary_arithmetic_equals_reference(name, ldt, rdt):
    got, a, b = _check(name, ldt, rdt, lambda E, c: getattr(E, name)(
        c["a"], c["b"]))
    if name in ("Divide", "IntegralDivide", "Remainder", "Pmod"):
        # a zero divisor gives NULL, floats included
        assert all(g is None for g, y in zip(got, b) if y == 0)


@pytest.mark.parametrize("ldt,rdt", [p for p in _PAIRS if p[0] in _INTS
                                     and p[1] in _INTS])
@pytest.mark.parametrize("name", _BITWISE)
def test_bitwise_equals_reference(name, ldt, rdt):
    _check(name, ldt, rdt, lambda E, c: getattr(E, name)(c["a"], c["b"]))


@pytest.mark.parametrize("name,dt", [
    (n, d) for n in ("UnaryMinus", "Abs", "UnaryPositive") for d in
    _INTS + _FLOATS] + [("BitwiseNot", d) for d in _INTS])
def test_unary_equals_reference(name, dt):
    got, a, _ = _check(name, dt, dt, lambda E, c: getattr(E, name)(c["a"]))
    if name in ("UnaryMinus", "Abs") and dt in _INTS:
        mn = int(np.iinfo(np.dtype(dt)).min)
        assert all(g == mn for g, x in zip(got, a) if x == mn)


@pytest.mark.parametrize("dt", _INTS)
@pytest.mark.parametrize("name", ["ShiftLeft", "ShiftRight",
                                  "ShiftRightUnsigned"])
def test_shift_equals_reference(name, dt):
    """Counts from -70 to 139: masked to the low 5 or 6 bits."""
    _check(name, dt, dt, lambda E, c: getattr(E, name)(c["a"], c["n"]))


def test_min_value_division_by_minus_one_wraps():
    """Java: Long.MinValue / -1 is Long.MinValue and Long.MinValue % -1
    is 0; Integer.MinValue likewise in its width (``%``, ``pmod``), and
    ``div`` widens to long first."""
    mn = -2 ** 63
    t = pa.table({"a": pa.array([mn, mn, -2 ** 31, 7], pa.int64()),
                  "i": pa.array([0, 0, -2 ** 31, 7], pa.int32()),
                  "b": pa.array([-1, 2, -1, -1], pa.int64()),
                  "j": pa.array([-1, -1, -1, -1], pa.int32())})
    df = TorchSession(OFF, device="cpu").create_dataframe(t)
    got = df.select(PF.div(PF.col("a"), PF.col("b")).alias("d"),
                    (PF.col("a") % PF.col("b")).alias("r"),
                    PF.pmod(PF.col("a"), PF.col("b")).alias("p"),
                    (PF.col("i") % PF.col("j")).alias("ri"),
                    PF.div(PF.col("i"), PF.col("j")).alias("di")).collect()
    assert [r["d"] for r in got] == [mn, -2 ** 62, 2 ** 31, -7]
    assert [r["r"] for r in got] == [0, 0, 0, 0]
    assert [r["p"] for r in got] == [0, 0, 0, 0]
    assert [r["ri"] for r in got] == [0, 0, 0, 0]
    assert [r["di"] for r in got] == [0, 0, 2 ** 31, -7]


@pytest.mark.parametrize("case", ["int_div_by_zero_null",
                                  "remainder_by_zero_null", "neg_mod_sign",
                                  "pmod_sign", "double_div_by_zero_null",
                                  "byte_add_wraps"])
def test_spark_semantics_arithmetic_cases(case):
    """The arithmetic cases of tests/test_spark_semantics.py, rebuilt with
    the port's F, and three more of the same kind."""
    s = TorchSession(OFF, device="cpu")
    F = PF
    cases = {
        "int_div_by_zero_null": (lambda: s.create_dataframe(
            pa.table({"a": [6, 7]})).select(
            (F.col("a") / F.lit(0)).alias("o")), [None, None]),
        "remainder_by_zero_null": (lambda: s.create_dataframe(
            pa.table({"a": [6]})).select(
            (F.col("a") % F.lit(0)).alias("o")), [None]),
        "neg_mod_sign": (lambda: s.create_dataframe(
            pa.table({"a": [-7]})).select(
            (F.col("a") % F.lit(3)).alias("o")), [-1]),
        "pmod_sign": (lambda: s.create_dataframe(
            pa.table({"a": [-7, 7, -7]})).select(
            F.pmod(F.col("a"), F.lit(3)).alias("o")), [2, 1, 2]),
        "double_div_by_zero_null": (lambda: s.create_dataframe(
            pa.table({"a": [1.5, -0.0, float("nan")]})).select(
            (F.col("a") / F.lit(0.0)).alias("o")), [None, None, None]),
        "byte_add_wraps": (lambda: s.create_dataframe(
            pa.table({"a": pa.array([127, -128], pa.int8())})).select(
            (F.col("a") + F.col("a")).alias("o")), [-2, 0]),
    }
    build, want = cases[case]
    assert [r["o"] for r in build().collect()] == want


def test_col_operators_build_the_arithmetic_family():
    c = PF.col("x")
    assert isinstance((c / 2).expr, PE.Divide)
    assert isinstance((c % 2).expr, PE.Remainder)
    assert isinstance((-c).expr, PE.UnaryMinus)
    assert isinstance((+c).expr, PE.UnaryPositive)
    assert isinstance(c.bitwiseAND(1).expr, PE.BitwiseAnd)
    assert isinstance(c.bitwiseOR(1).expr, PE.BitwiseOr)
    assert isinstance(c.bitwiseXOR(1).expr, PE.BitwiseXor)
    assert isinstance(PF.abs(c).expr, PE.Abs)
    assert isinstance(PF.div(c, 2).expr, PE.IntegralDivide)
    assert isinstance(PF.bitwise_not(c).expr, PE.BitwiseNot)
    assert isinstance(PF.shiftrightunsigned(c, 1).expr,
                      PE.ShiftRightUnsigned)
