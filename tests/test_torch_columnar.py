"""The port's columnar ingest against the reference's.

One table with nulls, NaN, -0.0, dates, timestamps, a low-cardinality and
a high-cardinality string column goes in as a dict of numpy arrays and as
an Arrow table. The port's dictionary codes and dictionaries must equal
the reference's ``_try_dict_encode``, its byte rectangles, lengths and
widths the reference's ``encode_string_rect``; every column must come
back out unchanged; and ``batch_from_reference`` must rebuild a reference
batch exactly.
"""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
from spark_rapids_tpu.columnar.batch import _try_dict_encode as ref_dict
from spark_rapids_tpu.columnar.strrect import \
    encode_string_rect as ref_encode_rect
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.columnar import (ByteRectColumn, ColumnarBatch,
                                             DictColumn, HostTable,
                                             batch_from_reference)
from spark_rapids_tpu_torch.types import Schema, StructField, from_arrow
from test_torch_slice import prebuild_reference_native

N = 3000


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _numpy_table(seed: int = 11) -> dict:
    rng = np.random.RandomState(seed)
    nulls = rng.rand(N) < 0.1
    f = rng.normal(size=N)
    f[::13] = np.nan
    f[5::31] = -0.0
    low = np.array(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"], object)[
        rng.randint(0, 5, N)]
    low[rng.rand(N) < 0.05] = None
    high = np.array([f"comment {i} {rng.randint(1 << 30)}" for i in
                     range(N)], object)
    high[rng.rand(N) < 0.05] = None
    days = np.datetime64("1992-01-01") + rng.randint(0, 2526, N)
    us = np.datetime64("2020-01-01T00:00:00", "us") + \
        rng.randint(0, 10**9, N).astype("timedelta64[us]")
    return {
        "i64": np.ma.MaskedArray(rng.randint(-10**12, 10**12, N), nulls),
        "i32": rng.randint(-1000, 1000, N).astype(np.int32),
        "f64": np.ma.MaskedArray(f, np.roll(nulls, 3)),
        "flag": rng.rand(N) < 0.5,
        "day": np.ma.MaskedArray(days.astype("datetime64[D]"),
                                 np.roll(nulls, 7)),
        "ts": us,
        "low": low,
        "high": high,
    }


def _arrow(data: dict) -> pa.Table:
    cols = {}
    for k, v in data.items():
        if isinstance(v, np.ma.MaskedArray):
            cols[k] = pa.array(v.data, mask=np.ma.getmaskarray(v))
        else:
            cols[k] = pa.array(v)
    return pa.table(cols)


@pytest.fixture(scope="module")
def data():
    return _numpy_table()


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    return a == b


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert _same(g[k], w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("source", ["numpy", "arrow"])
def test_ingest_round_trip_equals_reference(data, source):
    table = _arrow(data)
    port = TorchSession(device="cpu").create_dataframe(
        data if source == "numpy" else table)
    got = port.select(*table.column_names).collect()
    want = TpuSession({"spark.rapids.tpu.sql.optimizer.enabled": False}) \
        .create_dataframe(table).select(*table.column_names).collect()
    _assert_rows_equal(got, want)
    back = port.select(*table.column_names).collect_arrow()
    ref_back = TpuSession().create_dataframe(table).select(
        *table.column_names).collect_arrow()
    assert back.schema == ref_back.schema
    np_out = port.select("f64", "day").collect_numpy()
    assert np_out["day"].dtype == np.dtype("datetime64[D]")
    f = np_out["f64"]
    src = data["f64"]
    assert np.array_equal(np.ma.getmaskarray(f), np.ma.getmaskarray(src))
    ok = ~np.ma.getmaskarray(src)
    assert np.array_equal(f.data[ok].view(np.int64),
                          src.data[ok].view(np.int64))   # NaN, -0.0 bits


@pytest.mark.parametrize("source", ["numpy", "arrow"])
def test_string_layouts_equal_reference(data, source):
    table = _arrow(data)
    host = HostTable.from_dict(data) if source == "numpy" \
        else HostTable.from_arrow(table)
    batch = ColumnarBatch.from_host(host, "cpu", 64)
    low = batch.column_by_name("low")
    assert isinstance(low, DictColumn)
    codes, valid, dictionary = ref_dict(table.column("low").combine_chunks(),
                                        N, N)
    np.testing.assert_array_equal(low.data.numpy(), codes)
    np.testing.assert_array_equal(low.validity.numpy(), valid)
    assert list(low.dictionary) == list(dictionary)
    high = batch.column_by_name("high")
    assert isinstance(high, ByteRectColumn)
    rect, lens, rvalid, ascii_only = ref_encode_rect(
        table.column("high").combine_chunks(), N, N, 64)
    assert high.width == rect.shape[1]
    np.testing.assert_array_equal(high.data.numpy(), rect)
    np.testing.assert_array_equal(high.lengths.numpy(), lens)
    np.testing.assert_array_equal(high.validity.numpy(), rvalid)
    assert high.ascii_only == ascii_only
    # the reference's own ingest agrees on which layout each column takes
    ref = RefBatch.from_arrow(table)
    assert type(ref.column_by_name("low")).__name__ == "DictColumn"
    assert type(ref.column_by_name("high")).__name__ == "ByteRectColumn"


def test_wide_strings_stay_on_host():
    from spark_rapids_tpu_torch.columnar import HostColumn
    vals = np.array([f"{i:04d}" + "x" * 70 for i in range(50)], object)
    batch = ColumnarBatch.from_host(HostTable.from_dict({"s": vals}),
                                    "cpu", 64)
    col = batch.columns[0]
    assert isinstance(col, HostColumn)
    assert list(col.to_numpy(50)[0]) == list(vals)


def test_batch_from_reference_round_trips(data):
    table = _arrow(data)
    ref = RefBatch.from_arrow(table)            # padded to a shape bucket
    assert ref.padded_len > ref.num_rows
    cols = []
    for c in ref.columns:
        d = {"data": np.asarray(c.data), "validity": np.asarray(c.validity)}
        if hasattr(c, "dictionary"):
            d["dictionary"] = c.dictionary
        if hasattr(c, "lengths"):        # a rectangle: data is its bytes
            d["bytes_"] = d.pop("data")
            d["lengths"] = np.asarray(c.lengths)
        cols.append(d)
    schema = Schema([StructField(f.name, from_arrow(table.schema.field(
        f.name).type), True) for f in ref.schema.fields])
    port = batch_from_reference(cols, schema, "cpu", ref.num_rows)
    assert port.padded_len == ref.padded_len
    assert type(port.column_by_name("high")).__name__ == "ByteRectColumn"
    assert type(port.column_by_name("low")).__name__ == "DictColumn"
    want = ref.to_arrow()
    for i, name in enumerate(want.column_names):
        vals, valid = port.columns[i].to_numpy(port.num_rows)
        w = want.column(name)
        assert np.array_equal(valid, ~np.asarray(w.is_null())), name
        if name in ("low", "high"):
            assert [v if ok else None for v, ok in zip(vals, valid)] == \
                w.to_pylist(), name
        elif name == "day":
            np.testing.assert_array_equal(
                vals[valid], np.asarray(w.cast(pa.int32()).drop_null()))
        elif name == "ts":
            np.testing.assert_array_equal(
                vals[valid], np.asarray(w.cast(pa.int64()).drop_null()))
        else:
            np.testing.assert_array_equal(
                vals[valid], w.drop_null().to_numpy(zero_copy_only=False))
        # padding rows stay invalid
        pad_valid = port.columns[i].validity[port.num_rows:]
        assert not bool(torch.any(pad_valid))
