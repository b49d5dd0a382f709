"""The port's date and time functions (``spark_rapids_tpu_torch/exprs/
datetime_fns.py``) against the reference's, exactly.

Dates run from 1900 to 2100 with every Feb 28/29 and Mar 1, Dec 31 and
Jan 1 in range planted, and NULLs; timestamps from 1900 to 2100 in
microseconds, negative ones included (just before the epoch, and just
before and after a day's boundary), to hold the floor division and
floor modulo of the civil-calendar arithmetic. The functions the
reference runs on its host engine only keep a named refusal.
"""
import datetime

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exprs import datetime_fns as DT

from test_torch_slice import prebuild_reference_native
from torch_compare import OFF, frames_equal, run_both

N = 600
_DAY_US = 86_400_000_000


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _table(seed: int = 0) -> pa.Table:
    rng = np.random.RandomState(seed)
    lo = (np.datetime64("1900-01-01") - np.datetime64("1970-01-01")) \
        .astype(np.int64)
    hi = (np.datetime64("2100-12-31") - np.datetime64("1970-01-01")) \
        .astype(np.int64)
    days = rng.randint(lo, hi + 1, N)
    edges = []
    for y in (1900, 1904, 1969, 1970, 1999, 2000, 2023, 2024, 2100):
        for m, d in ((2, 28), (3, 1), (12, 31), (1, 1)):
            edges.append((np.datetime64(f"{y}-{m:02d}-{d:02d}")
                          - np.datetime64("1970-01-01")).astype(np.int64))
        if y % 4 == 0 and y != 1900 and y != 2100:
            edges.append((np.datetime64(f"{y}-02-29")
                          - np.datetime64("1970-01-01")).astype(np.int64))
    days[:len(edges)] = edges
    us = rng.randint(lo * _DAY_US, hi * _DAY_US, N)
    us[:8] = [-1, 0, 1, -_DAY_US, -_DAY_US - 1, _DAY_US - 1,
              lo * _DAY_US, -3_600_000_001]
    return pa.table({
        "d": pa.array(days.astype(np.int32), mask=rng.rand(N) < 0.05)
        .cast(pa.date32()),
        "e": pa.array(np.roll(days, 7).astype(np.int32)).cast(pa.date32()),
        "t": pa.array(us, type=pa.int64(), mask=rng.rand(N) < 0.05)
        .cast(pa.timestamp("us", tz="UTC")),
        "n": pa.array(rng.randint(-30, 31, N).astype(np.int32),
                      mask=rng.rand(N) < 0.05),
        "s": pa.array(rng.randint(-2 ** 31, 2 ** 31, N), type=pa.int64()),
    })


_FIELDS = ["Year", "Month", "DayOfMonth", "Quarter", "DayOfWeek", "WeekDay",
           "DayOfYear", "LastDay", "UnixDate"]


@pytest.mark.parametrize("name", _FIELDS)
def test_date_fields_equal_reference(name):
    cols = ["d"] if name == "UnixDate" else ["d", "t"]
    if name == "LastDay":
        cols = ["d"]
    ref, got = run_both(_table(1), lambda df, F, E: df.select(*[
        F.Col(getattr(E, name)(F.col(c).expr)).alias(c) for c in cols]))
    frames_equal(got, ref)


@pytest.mark.parametrize("name", ["Hour", "Minute", "Second"])
def test_time_fields_equal_reference(name):
    ref, got = run_both(_table(2), lambda df, F, E: df.select(
        F.Col(getattr(E, name)(F.col("t").expr)).alias("o")))
    frames_equal(got, ref)


def test_date_arithmetic_equals_reference():
    ref, got = run_both(_table(3), lambda df, F, E: df.select(
        F.datediff(F.col("d"), F.col("e")).alias("diff"),
        F.Col(E.AddMonths(F.col("d").expr, F.col("n").expr)).alias("am"),
        F.Col(E.AddMonths(F.col("e").expr, E.Literal(1))).alias("am1"),
        F.Col(E.DateAddInterval(F.col("d").expr, 45)).alias("dai"),
        F.Col(E.TimeAdd(F.col("t").expr, -90_061_000_001)).alias("ta"),
        F.date_add(F.col("d"), F.col("n")).alias("da")))
    frames_equal(got, ref)


@pytest.mark.parametrize("level", ["year", "yyyy", "quarter", "month", "mm",
                                   "week", "day"])
def test_trunc_equals_reference(level):
    ref, got = run_both(_table(4), lambda df, F, E: df.select(
        F.Col(E.TruncDate(F.col("d").expr, level)).alias("o")))
    frames_equal(got, ref)


def test_epoch_conversions_equal_reference():
    ref, got = run_both(_table(5), lambda df, F, E: df.select(
        F.Col(E.SecondsToTimestamp(F.col("n").expr)).alias("sec"),
        F.Col(E.MillisToTimestamp(F.col("s").expr)).alias("ms"),
        F.Col(E.MicrosToTimestamp(F.col("s").expr)).alias("us"),
        F.Col(E.ToUnixTimestamp(F.col("t").expr)).alias("ut"),
        F.Col(E.ToUnixTimestamp(F.col("d").expr)).alias("ud"),
        F.Col(E.UnixTimestamp(F.col("t").expr)).alias("ux")))
    frames_equal(got, ref)


def test_fields_of_known_dates():
    """Against Python's calendar, 1900-2100, every day of four years and
    a few hundred others."""
    s = TorchSession(OFF, device="cpu")
    days = np.concatenate([np.arange(-25567, -25567 + 4 * 366),
                           np.arange(10900, 10900 + 4 * 366),
                           np.linspace(-25567, 47482, 500).astype(np.int64)])
    d = PF.col("d")
    rows = s.create_dataframe({"d": days.astype("datetime64[D]")}).select(
        PF.year(d).alias("y"), PF.month(d).alias("m"),
        PF.dayofmonth(d).alias("dd"), PF.dayofyear(d).alias("doy"),
        PF.dayofweek(d).alias("dow"), PF.weekday(d).alias("wd"),
        PF.last_day(d).alias("ld")).collect()
    epoch = datetime.date(1970, 1, 1)
    for n, r in zip(days, rows):
        d = epoch + datetime.timedelta(days=int(n))
        assert (r["y"], r["m"], r["dd"]) == (d.year, d.month, d.day)
        assert r["doy"] == d.timetuple().tm_yday
        assert r["dow"] == d.isoweekday() % 7 + 1
        assert r["wd"] == d.weekday()
        nxt = (d.replace(day=28) + datetime.timedelta(days=4))
        assert r["ld"] == nxt - datetime.timedelta(days=nxt.day)


@pytest.mark.parametrize("case", ["datediff_order",
                                  "add_months_clamps_month_end",
                                  "hour_of_timestamp",
                                  "dayofweek_sunday_is_1"])
def test_spark_semantics_datetime_cases(case):
    """The date cases of tests/test_spark_semantics.py, with the port's
    F."""
    s = TorchSession(OFF, device="cpu")
    F = PF
    ts_ = datetime.datetime(2024, 3, 15, 13, 45, 30,
                            tzinfo=datetime.timezone.utc)
    cases = {
        "datediff_order": (lambda: s.create_dataframe(pa.table({
            "a": pa.array([datetime.date(2024, 1, 3)]),
            "b": pa.array([datetime.date(2024, 1, 1)])})).select(
            F.datediff(F.col("a"), F.col("b")).alias("o")), [2]),
        "add_months_clamps_month_end": (lambda: s.create_dataframe(pa.table(
            {"d": pa.array([datetime.date(2024, 1, 31)])})).select(
            F.add_months(F.col("d"), 1).alias("o")),
            [datetime.date(2024, 2, 29)]),
        "hour_of_timestamp": (lambda: s.create_dataframe(pa.table(
            {"t": pa.array([ts_])})).select(
            F.hour(F.col("t")).alias("o")), [13]),
        "dayofweek_sunday_is_1": (lambda: s.create_dataframe(pa.table(
            {"d": pa.array([datetime.date(2024, 3, 17)])})).select(
            F.dayofweek(F.col("d")).alias("o")), [1]),
    }
    build, want = cases[case]
    assert [r["o"] for r in build().collect()] == want


def _expr(cls, col, *args):
    """A function F leaves out until the slice that runs it, built from
    its expression class."""
    return lambda F: F.Col(cls(F.col(col).expr, *args))


@pytest.mark.parametrize("make,match", [
    (lambda F: F.months_between(F.col("d"), F.col("e")), "host engine"),
    (_expr(DT.FromUnixTime, "s"), "host engine"),
    (_expr(DT.DateFormatClass, "t", "yyyy"), "host engine"),
    (_expr(DT.FromUtcTimestamp, "t", "UTC"), "time-zone"),
    (_expr(DT.ToUtcTimestamp, "t", "UTC"), "time-zone"),
    (lambda F: F.unix_timestamp(F.lit("2024-01-01 00:00:00")),
     "strings slice"),
])
def test_host_only_functions_are_refused_by_name(make, match):
    df = TorchSession(OFF, device="cpu").create_dataframe(_table(6))
    with pytest.raises(NotImplementedError, match=match):
        df.select(make(PF).alias("o")).collect()
