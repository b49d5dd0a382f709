"""The port's casts (``spark_rapids_tpu_torch/exprs/cast.py``) against the
reference's device casts, and Java's saturation.

Every pair of boolean, tinyint, smallint, int, bigint, float, double,
date and timestamp goes through both packages over the same seeded
columns (NULLs, 0, -1, each type's bounds, and for floats NaN, +-inf,
-0.0, fractions and values past every integer range). Integers, dates and
timestamps compare exactly; floats bit for bit (every cast is one IEEE
conversion or none).

Two departures from the reference (ROADMAP.md Queue C), held to Spark's
answers instead: a float to tinyint or smallint goes through int and
keeps the low bits (Java's ``(byte)(int)x``), where the reference
saturates at the narrow type's bounds; and timestamps cast to and from
numbers count seconds, where the reference keeps microseconds.
"""
import decimal
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF

from test_torch_slice import prebuild_reference_native
from torch_compare import OFF, column, run_both

N = 300
_TYPES = ["boolean", "tinyint", "smallint", "int", "bigint", "float",
          "double", "date", "timestamp"]
_PA = {"boolean": pa.bool_(), "tinyint": pa.int8(), "smallint": pa.int16(),
       "int": pa.int32(), "bigint": pa.int64(), "float": pa.float32(),
       "double": pa.float64(), "date": pa.date32(),
       "timestamp": pa.timestamp("us", tz="UTC")}
_NP = {"tinyint": np.int8, "smallint": np.int16, "int": np.int32,
       "bigint": np.int64}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _values(ty: str, rng) -> np.ndarray:
    if ty == "boolean":
        return rng.rand(N) < 0.5
    if ty in _NP:
        info = np.iinfo(_NP[ty])
        v = rng.randint(info.min, info.max, N, dtype=np.int64)
        v[:6] = [0, -1, 1, info.min, info.max, 100]
        return v.astype(_NP[ty])
    if ty in ("float", "double"):
        v = rng.standard_normal(N) * 10.0 ** rng.randint(-2, 21, N)
        v[:14] = [0.0, -0.0, 0.5, -0.5, 2.9, -2.9, math.nan, math.inf,
                  -math.inf, 300.7, -40000.2, 3e9, -3e9, 1e19]
        return v.astype(np.float32 if ty == "float" else np.float64)
    if ty == "date":
        return rng.randint(-25567, 47482, N).astype(np.int32)
    us = rng.randint(-2 * 10 ** 15, 4 * 10 ** 15, N)
    us[:4] = [-1, 0, -1_000_001, 999_999]
    return us


def _table(seed: int = 0) -> pa.Table:
    rng = np.random.RandomState(seed)
    cols = {}
    for ty in _TYPES:
        v = _values(ty, rng)
        mask = rng.rand(N) < 0.06
        mask[:14] = False
        if ty in ("date", "timestamp"):
            cols[ty] = pa.array(v, mask=mask).cast(_PA[ty])
        else:
            cols[ty] = pa.array(v, type=_PA[ty], mask=mask)
    return pa.table(cols)


def _java_narrow(x: np.ndarray, ty: str) -> np.ndarray:
    """Java's (byte)(int)x / (short)(int)x of floats."""
    with np.errstate(invalid="ignore"):
        i = np.where(np.isnan(x), 0, np.clip(np.trunc(x), -2.0 ** 31,
                                             2.0 ** 31 - 1))
    return i.astype(np.int64).astype(np.int32).astype(_NP[ty])


@pytest.mark.parametrize("src", _TYPES)
def test_casts_equal_reference(src):
    t = _table(1)
    targets = [d for d in _TYPES if d != src]
    ref, got = run_both(t, lambda df, F, E: df.select(*[
        F.col(src).cast(d).alias(d) for d in targets]))
    x, xn = column(t, src)
    for d in targets:
        rv, rn = column(ref, d)
        pv, pn = column(got, d)
        if src == "timestamp" and d not in ("date", "boolean"):
            # Spark: seconds (floor), or seconds with their fraction
            us = x.astype("datetime64[us]").astype(np.int64)
            want = np.floor_divide(us, 1_000_000) if d != "float" and \
                d != "double" else us / 1e6
            if d in _NP:
                want = want.astype(_NP[d])      # the low bits, as Java's
            elif d == "float":
                want = want.astype(np.float32)
            assert (pn == xn).all(), d
            np.testing.assert_array_equal(pv[~pn], want[~pn], err_msg=d)
            continue
        if d == "timestamp" and src not in ("date", "boolean"):
            xs = x.astype(np.float64)
            with np.errstate(all="ignore"):
                if src in ("float", "double"):
                    bad = ~np.isfinite(xs)
                    want = np.trunc(np.where(bad, 0, xs) * 1e6)
                    want = np.where(np.abs(want) >= 2.0 ** 63,
                                    np.sign(want) * 2.0 ** 63 * 0.99, want)
                    want = want.astype(np.int64)
                else:
                    bad = np.zeros(N, bool)
                    want = x.astype(np.int64) * 1_000_000
            assert (pn == (xn | bad)).all(), d
            pus = pv.astype("datetime64[us]").astype(np.int64)
            ok = ~pn & (np.abs(xs) < 9e12)
            np.testing.assert_array_equal(pus[ok], want[ok], err_msg=d)
            continue
        assert (pn == rn).all() and (pn == xn).all(), d
        keep = ~pn
        if src in ("float", "double") and d in ("tinyint", "smallint"):
            np.testing.assert_array_equal(
                pv[keep], _java_narrow(x.astype(np.float64), d)[keep])
            continue
        np.testing.assert_array_equal(pv[keep], rv[keep], err_msg=d)
        if pv.dtype.kind == "f":         # -0.0 apart from 0.0 too
            num = keep & ~np.isnan(rv)
            assert (np.signbit(pv[num]) == np.signbit(rv[num])).all(), d


def test_float_to_integral_saturates_as_java():
    s = TorchSession(OFF, device="cpu")
    x = [math.nan, math.inf, -math.inf, 3e9, -3e9, 1e19, -1e19, 2.9, -2.9,
         -0.0, 300.7, 40000.2]
    rows = s.create_dataframe(pa.table({"x": x})).select(
        PF.col("x").cast("int").alias("i"), PF.col("x").cast("bigint")
        .alias("l"), PF.col("x").cast("tinyint").alias("b"),
        PF.col("x").cast("smallint").alias("s")).collect()
    imax, imin, lmax, lmin = 2 ** 31 - 1, -2 ** 31, 2 ** 63 - 1, -2 ** 63
    assert [r["i"] for r in rows] == [0, imax, imin, imax, imin, imax, imin,
                                      2, -2, 0, 300, 40000]
    assert [r["l"] for r in rows] == [0, lmax, lmin, 3_000_000_000,
                                      -3_000_000_000, lmax, lmin, 2, -2, 0,
                                      300, 40000]
    # (byte)(int)x: through int, then the low 8 or 16 bits
    assert [r["b"] for r in rows] == [0, -1, 0, -1, 0, -1, 0, 2, -2, 0, 44,
                                      64]
    assert [r["s"] for r in rows] == [0, -1, 0, -1, 0, -1, 0, 2, -2, 0, 300,
                                      -25536]


@pytest.mark.parametrize("case", ["cast_float_truncates_toward_zero",
                                  "cast_bool_to_int",
                                  "cast_timestamp_to_date"])
def test_spark_semantics_cast_cases(case):
    """The cast cases of tests/test_spark_semantics.py, with the port's
    F."""
    import datetime
    s = TorchSession(OFF, device="cpu")
    F = PF
    ts_ = datetime.datetime(2024, 3, 15, 13, 45, 30,
                            tzinfo=datetime.timezone.utc)
    cases = {
        "cast_float_truncates_toward_zero": (lambda: s.create_dataframe(
            pa.table({"x": [3.99, -3.99]})).select(
            F.col("x").cast("int").alias("o")), [3, -3]),
        "cast_bool_to_int": (lambda: s.create_dataframe(
            pa.table({"x": [True, False]})).select(
            F.col("x").cast("int").alias("o")), [1, 0]),
        "cast_timestamp_to_date": (lambda: s.create_dataframe(
            pa.table({"t": pa.array([ts_])})).select(
            F.col("t").cast("date").alias("o")),
            [datetime.date(2024, 3, 15)]),
    }
    build, want = cases[case]
    assert [r["o"] for r in build().collect()] == want


def test_string_and_decimal_casts_are_refused_by_name():
    df = TorchSession(OFF, device="cpu").create_dataframe(
        pa.table({"x": [1.5], "s": ["2"]}))
    with pytest.raises(NotImplementedError, match="strings slice"):
        df.select(PF.col("x").cast("string")).collect()
    with pytest.raises(NotImplementedError, match="strings slice"):
        df.select(PF.col("s").cast("int")).collect()
    # decimal casts of numbers run (tests/test_torch_decimal.py); between
    # strings and decimals they are refused, naming both
    with pytest.raises(NotImplementedError, match="strings slice.*decimals"):
        df.select(PF.col("s").cast("decimal(10,2)")).collect()
    with pytest.raises(NotImplementedError, match="strings slice.*decimals"):
        df.select(PF.col("x").cast("decimal(10,2)").cast("string")).collect()
    assert df.select(PF.col("x").cast("decimal(10,2)").alias("d")) \
        .collect() == [{"d": decimal.Decimal("1.50")}]
