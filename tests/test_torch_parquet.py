"""The port's Parquet reader (no pyarrow) against the reference's
``TpuSession.read_parquet`` (pyarrow's reader).

Files are written here by pyarrow and read by both packages; results
compare with ``tests/harness.py:_assert_frames_equal``, floats exactly.
The cases cover each reader mode; SNAPPY, GZIP and UNCOMPRESSED; data
pages v1 and v2; a dictionary that falls back to PLAIN partway; nulls,
required columns and every flat type the port reads, INT96 included;
several row groups and files and an empty file; column pruning; pushed
predicates, whose row-group pruning keeps what the reference's keeps
(where the reference can compare: see ``test_date_pruning``); the
device-decode key on and off; ZSTD refused with the codec named. Besides:
the host library's dictionary strings give ``_try_dict_encode``'s codes
and dictionary exactly, the transfer encode round-trips, and the files
``chip_smoke.py``'s own writer makes read back equal in pyarrow.
"""
import datetime

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
from harness import _assert_frames_equal
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import DictColumn
from spark_rapids_tpu_torch.columnar.batch import (DictStrings,
                                                   _try_dict_encode)
from spark_rapids_tpu_torch.io import host_decode, parquet_meta
from spark_rapids_tpu_torch.io.parquet import ParquetScanExec

from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
READER = "spark.rapids.tpu.sql.format.parquet.reader.type"
MODES = ["PERFILE", "COALESCING", "MULTITHREADED"]
_MODES7 = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "REG AIR", "FOB"]


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _table(n: int, seed: int, nullable: bool = True) -> pa.Table:
    """Every flat type the port reads, with nulls where ``nullable``."""
    rng = np.random.RandomState(seed)

    def nulls(p=0.1):
        return rng.rand(n) < p if nullable else np.zeros(n, bool)
    return pa.table({
        "i": pa.array(rng.randint(-1000, 1000, n), pa.int32(),
                      mask=nulls()),
        "l": pa.array(rng.randint(-10 ** 12, 10 ** 12, n), pa.int64(),
                      mask=nulls()),
        "i8": pa.array(rng.randint(-128, 128, n), pa.int8(), mask=nulls()),
        "i16": pa.array(rng.randint(-3000, 3000, n), pa.int16(),
                        mask=nulls()),
        "d": pa.array(np.round(rng.standard_normal(n) * 100, 2),
                      mask=nulls()),
        "f": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=nulls()),
        "b": pa.array(rng.rand(n) < 0.4, mask=nulls()),
        "s": pa.array(rng.choice(_MODES7, n), pa.string(), mask=nulls()),
        "c": pa.array([f"row {i:05d} {'xy' * (i % 11)}"
                       for i in range(n)], pa.string(), mask=nulls(0.05)),
        "u": pa.array([f"é{i % 37}ü" for i in range(n)], pa.string(),
                      mask=nulls()),
        "dt": pa.array(rng.randint(-3000, 20000, n).astype("datetime64[D]"),
                       mask=nulls()),
        "ts": pa.array(rng.randint(-10 ** 15, 10 ** 15, n)
                       .astype("datetime64[us]"), mask=nulls()),
    })


def _write(path, t, **kw):
    pq.write_table(t, path, **kw)
    return str(path)


def _frames(got_df, want_df):
    return got_df.collect_arrow().to_pandas(), \
        want_df.collect_arrow().to_pandas()


def _both(paths, conf=None, columns=None, query=None):
    conf = {**OFF, **(conf or {})}
    port = TorchSession(conf, device="cpu").read_parquet(*paths,
                                                         columns=columns)
    ref = TpuSession(conf).read_parquet(*paths, columns=columns)
    if query is not None:
        port, ref = query(port, PF), query(ref, RF)
    return port, ref


def _assert_equal(paths, conf=None, columns=None, query=None):
    port, ref = _both(paths, conf, columns, query)
    got, want = _frames(port, ref)
    _assert_frames_equal(got, want, approximate_float=False)
    return got


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", ["snappy", "gzip", "none"])
@pytest.mark.parametrize("mode", MODES)
def test_read_equals_reference(tmp_path, mode, codec, version):
    """Two files of several row groups each and an empty file, batches
    smaller than a row group."""
    paths = [_write(tmp_path / f"p{k}.parquet", _table(n, k),
                    compression=codec, data_page_version=version,
                    row_group_size=700)
             for k, n in enumerate([2000, 1300])]
    paths.append(_write(tmp_path / "p9.parquet", _table(0, 9),
                        compression=codec, data_page_version=version))
    got = _assert_equal(paths, {READER: mode,
                                "spark.rapids.tpu.sql.batchSizeRows": 500})
    assert len(got) == 3300


def test_dictionary_falls_back_to_plain(tmp_path):
    """A small dictionary page limit: each string chunk starts
    dictionary-encoded and goes on in PLAIN."""
    n = 6000
    t = pa.table({"c": pa.array([f"value-{i % 2500:04d}" for i in range(n)]),
                  "k": pa.array(np.arange(n) % 997, pa.int64())})
    p = _write(tmp_path / "fb.parquet", t, dictionary_pagesize_limit=2048,
               data_page_size=4096)
    enc = pq.ParquetFile(p).metadata.row_group(0).column(0).encodings
    assert "PLAIN" in enc and "RLE_DICTIONARY" in enc
    _assert_equal([p])
    _assert_equal([p], query=lambda df, F: df.group_by("c").agg(
        F.count_star().with_name("n")).order_by("c"))


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_required_columns(tmp_path, version):
    t = _table(1500, 3, nullable=False)
    schema = pa.schema([f.with_nullable(False) for f in t.schema])
    p = _write(tmp_path / "req.parquet", t.cast(schema),
               data_page_version=version)
    cols = parquet_meta.read_footer(p).columns
    assert all(c.max_def == 0 for c in cols.values())
    _assert_equal([p])


@pytest.mark.parametrize("kind", ["int96", "ms", "us"])
def test_timestamps(tmp_path, kind):
    """INT96 (Spark's default outputTimestampType) and INT64 in millis
    and micros all read as microseconds. The reference's plain scan gives
    the same values (its device path takes millis and INT96's nanos as
    microseconds: ROADMAP.md Queue C)."""
    ts = [datetime.datetime(2020, 1, 2, 3, 4, 5, 678000), None,
          datetime.datetime(1960, 5, 6, 7, 8, 9, 123000),
          datetime.datetime(1999, 12, 31, 23, 59, 59, 999000)]
    unit = "ms" if kind == "ms" else "us"
    t = pa.table({"ts": pa.array(ts, pa.timestamp(unit)),
                  "k": pa.array([1, 2, 3, 4])})
    p = _write(tmp_path / f"{kind}.parquet", t,
               use_deprecated_int96_timestamps=kind == "int96")
    phys = pq.ParquetFile(p).metadata.row_group(0).column(0).physical_type
    assert phys == ("INT96" if kind == "int96" else "INT64")
    _assert_equal([p])
    got = TorchSession(OFF, device="cpu").read_parquet(p).collect()
    assert [r["ts"] for r in got] == [
        x.replace(tzinfo=datetime.timezone.utc) if x else None for x in ts]


def test_column_pruning(tmp_path):
    p = _write(tmp_path / "prune.parquet", _table(900, 5))
    _assert_equal([p], columns=["s", "i"])
    df = TorchSession(OFF, device="cpu").read_parquet(p)
    q = df.filter(PF.col("i") > PF.lit(0)).select("d")
    scan = q._physical()
    while scan.children:
        scan = scan.children[0]
    assert isinstance(scan, ParquetScanExec)
    assert scan.output_schema().names() == ["i", "d"]
    _assert_equal([p], query=lambda df, F: df.filter(
        F.col("i") > F.lit(0)).select("d"))


def _scan_of(df):
    node = df._physical()
    while node.children:
        node = node.children[0]
    return node


_PREDICATES = {
    "int_range": lambda F: (F.col("k") >= F.lit(3000))
    & (F.col("k") < F.lit(4500)),
    "int_eq": lambda F: F.col("k") == F.lit(7001),
    "flipped": lambda F: F.lit(1000) > F.col("k"),
    "or": lambda F: (F.col("k") < F.lit(600)) | (F.col("k") > F.lit(9000)),
    "string": lambda F: F.col("g") == F.lit("g07"),
    "float_lt": lambda F: F.col("x") < F.lit(1500.0),
}


@pytest.mark.parametrize("name", sorted(_PREDICATES))
def test_pushed_predicate_prunes_as_the_reference(tmp_path, name):
    """Sorted data in row groups of 1000: the port keeps the row groups
    the reference keeps, and the answers are equal. (A string ``=`` does
    not plan in the port yet, ROADMAP.md Queue A item 2: its pruning is
    held to the reference's on the scans directly.)"""
    n = 10000
    t = pa.table({"k": pa.array(np.arange(n), pa.int64()),
                  "g": pa.array([f"g{i // 1000:02d}" for i in range(n)]),
                  "x": pa.array(np.arange(n) * 0.5)})
    p = _write(tmp_path / "sorted.parquet", t, row_group_size=1000)
    pred = _PREDICATES[name]
    if name == "string":
        ps, rs = (_scan_of(df) for df in _both([p]))
        ps.set_predicate(pred(PF).expr)
        rs.set_predicate(pred(RF).expr)
    else:
        port, ref = _both([p], query=lambda df, F: df.filter(pred(F)))
        ps, rs = _scan_of(port), _scan_of(ref)
        got, want = _frames(port, ref)
        _assert_frames_equal(got, want, approximate_float=False)
    assert ps.predicate is not None and rs.predicate is not None
    kept = ps._filter_row_groups(parquet_meta.read_footer(p))
    assert kept == rs._filter_row_groups(pq.ParquetFile(p))
    assert len(kept) < 10


def test_date_pruning_and_float_nan(tmp_path):
    """Dates: the port prunes by their statistics (the reference keeps
    every group: its pyarrow dates do not compare with its literals).
    Floats: a group whose max is below the literal may hold NaN, which
    Spark orders above everything, so ``>`` keeps it."""
    n = 4000
    days = np.arange(n) // 2
    x = np.arange(n, dtype=np.float64)
    x[3] = np.nan
    t = pa.table({"dt": pa.array(days.astype("datetime64[D]")),
                  "x": pa.array(x)})
    p = _write(tmp_path / "dates.parquet", t, row_group_size=500)
    lo = np.datetime64("1970-01-01") + np.timedelta64(700, "D")
    hi = np.datetime64("1970-01-01") + np.timedelta64(1200, "D")
    port, ref = _both([p], query=lambda df, F: df.filter(
        (F.col("dt") >= F.lit(lo)) & (F.col("dt") < F.lit(hi))))
    kept = _scan_of(port)._filter_row_groups(parquet_meta.read_footer(p))
    may = [g for g in range(8) if days[g * 500] < 1200
           and days[g * 500 + 499] >= 700]
    assert kept == may == [2, 3, 4]
    assert _scan_of(ref)._filter_row_groups(pq.ParquetFile(p)) == \
        list(range(8))
    got, want = _frames(port, ref)
    _assert_frames_equal(got, want, approximate_float=False)
    nan_q = TorchSession(OFF, device="cpu").read_parquet(p).filter(
        PF.col("x") > PF.lit(3990.0))
    assert _scan_of(nan_q)._filter_row_groups(
        parquet_meta.read_footer(p)) == list(range(8))
    got = [r["x"] for r in nan_q.collect()]
    assert np.isnan(got[0]) and got[1:] == [float(v) for v in
                                            range(3991, 4000)]


@pytest.mark.parametrize("on", [True, False])
def test_device_decode_key(tmp_path, monkeypatch, on):
    """The opt-in raw path over UNCOMPRESSED PLAIN null-free columns
    gives the standard path's answer; it engages only when asked."""
    from spark_rapids_tpu_torch.io import device_decode
    n = 3000
    rng = np.random.RandomState(4)
    t = pa.table({"a": pa.array(rng.randint(-9, 9, n), pa.int32()),
                  "b": pa.array(rng.standard_normal(n)),
                  "c": pa.array(rng.randint(0, 10 ** 9, n), pa.int64())})
    p = _write(tmp_path / "raw.parquet", t, compression="none",
               use_dictionary=False, row_group_size=1000)
    calls = []
    real = device_decode._device_columns
    monkeypatch.setattr(device_decode, "_device_columns",
                        lambda *a: calls.append(1) or real(*a))
    key = "spark.rapids.tpu.io.parquet.deviceDecode.enabled"
    conf = {key: on, READER: "PERFILE"}
    _assert_equal([p], conf)
    assert len(calls) == (1 if on else 0)
    if on:
        cols = real(_scan_of(TorchSession(OFF, device="cpu").read_parquet(
            p)), p, "cpu")
        assert cols is not None and cols[1].dtype == torch.float64


def test_zstd_is_refused_with_the_codec_named(tmp_path):
    p = _write(tmp_path / "z.parquet", _table(100, 1), compression="zstd")
    df = TorchSession(OFF, device="cpu").read_parquet(p)
    with pytest.raises(NotImplementedError, match="codec ZSTD") as e:
        df.collect()
    assert "z.parquet" in str(e.value) and "column i" in str(e.value)


def test_unsupported_columns_are_refused_at_planning(tmp_path):
    import decimal
    t = pa.table({"m": pa.array([decimal.Decimal("1.25")], pa.decimal128(9, 2)),
                  "n": pa.array([[1, 2]], pa.list_(pa.int64())),
                  "k": pa.array([7])})
    p = _write(tmp_path / "dec.parquet", t)
    s = TorchSession(OFF, device="cpu")
    # a decimal column is read now (tests/test_torch_decimal.py); the list
    # column is still refused
    with pytest.raises(NotImplementedError, match="nested and map"):
        s.read_parquet(p).collect()
    assert s.read_parquet(p).select("m").collect() == [
        {"m": decimal.Decimal("1.25")}]
    with pytest.raises(NotImplementedError, match="nested and map"):
        s.read_parquet(p).select("n").collect()
    assert s.read_parquet(p).select("k").collect() == [{"k": 7}]


def test_paths_directories_and_rules(tmp_path):
    d = tmp_path / "data"
    (d / "sub").mkdir(parents=True)
    _write(d / "a.parquet", _table(50, 1))
    _write(d / "sub" / "b.parquet", _table(60, 2))
    (d / "notes.txt").write_text("not parquet")
    conf = {"spark.rapids.tpu.io.pathReplacementRules":
            f"mem://bucket->{d}"}
    got = _assert_equal(["mem://bucket"], conf)
    assert len(got) == 110
    with pytest.raises(ValueError, match="malformed"):
        TorchSession({"spark.rapids.tpu.io.pathReplacementRules": "oops"},
                     device="cpu").read_parquet(str(d))


@pytest.mark.parametrize("n,seed", [(1000, 1), (7, 2), (300, 3)])
def test_dictionary_strings_give_try_dict_encode_codes(tmp_path, n, seed):
    """Codes, dictionary and the threshold from the chunk's dictionary
    equal ``_try_dict_encode`` over the decoded strings, over slices of
    every size (a short slice is above the threshold in both)."""
    rng = np.random.RandomState(seed)
    vals = rng.choice(_MODES7 + ["é", ""], n)
    t = pa.table({"s": pa.array(vals, mask=rng.rand(n) < 0.2)})
    p = _write(tmp_path / "ds.parquet", t)
    footer = parquet_meta.read_footer(p)
    cm = footer.meta.row_groups[0].columns[0]
    with open(p, "rb") as f:
        f.seek(cm.chunk_offset)
        raw = np.frombuffer(f.read(cm.total_compressed_size), np.uint8)
    ds, valid = host_decode.decode_chunk(raw.copy(), cm,
                                         footer.columns["s"], n, p)
    assert isinstance(ds, DictStrings)
    for off, ln in [(0, n), (0, 3), (n // 2, n - n // 2), (n - 1, 1)]:
        part, v = ds[off:off + ln], valid[off:off + ln]
        got = part.encode(v, len(v))
        want = _try_dict_encode(part.decode(), v, len(v))
        assert (got is None) == (want is None), (off, ln)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            assert list(got[1]) == list(want[1])


def test_parquet_batches_ingest_dictionary_strings(tmp_path):
    p = _write(tmp_path / "ing.parquet", _table(2000, 8))
    scan = _scan_of(TorchSession(OFF, device="cpu").read_parquet(
        p, columns=["s"]))
    ctx = TorchSession(OFF, device="cpu").exec_context()
    batches = list(scan.execute(ctx))
    assert len(batches) == 1
    assert all(isinstance(b.columns[0], DictColumn) for b in batches)


def test_snappy_matches_pyarrows_codec():
    rng = np.random.RandomState(0)
    for data in [b"", b"a" * 100000, bytes(rng.randint(0, 4, 70000)
                                           .astype(np.uint8)),
                 bytes(rng.randint(0, 256, 5000).astype(np.uint8))]:
        comp = pa.compress(data, codec="snappy", asbytes=True)
        got = host_decode.snappy_decompress(
            np.frombuffer(comp, np.uint8).copy(), len(data))
        assert got.tobytes() == data
    with pytest.raises(host_decode.ChunkError):
        host_decode.snappy_decompress(np.frombuffer(b"\x10\x01\x02",
                                                    np.uint8).copy())


def test_transfer_encode_round_trips():
    """Narrowed ints, dates and codes, bitpacked bools and validity come
    back exactly, and equal the reference's encode's choices."""
    from spark_rapids_tpu.columnar import transfer as ref_transfer
    from spark_rapids_tpu_torch.columnar import transfer
    rng = np.random.RandomState(1)
    n = 1 << 18
    valid = rng.rand(n) < 0.9
    cols = [rng.randint(0, 200, n).astype(np.int64),
            rng.randint(-30000, 30000, n).astype(np.int32),
            (rng.randint(0, 2500, n) + 8000).astype(np.int32),
            rng.randint(-2 ** 40, 2 ** 40, n).astype(np.int64),
            rng.rand(n) < 0.5, rng.standard_normal(n),
            rng.randint(0, 3, n).astype(np.int32)]
    pairs = [(np.where(valid, c, c.dtype.type(0)), valid) for c in cols]
    pairs.append((cols[0], np.ones(n, bool)))
    flat, specs, params, ratio, raw = transfer.encode_columns(pairs)
    rflat, rspecs, rparams, rratio, rraw = ref_transfer.encode_columns(pairs)
    assert [s[0][0] for s in specs] == [s[0][0] for s in rspecs]
    assert ratio == rratio and raw == rraw and transfer.worthwhile(ratio,
                                                                  raw)
    assert transfer.may_pay(pairs)
    out = transfer.decode_columns(transfer.copy_to_device(flat, "cpu"),
                                  specs, params, n, "cpu")
    for (d, v), (got_d, got_v) in zip(pairs, out):
        np.testing.assert_array_equal(got_v.numpy(), v)
        np.testing.assert_array_equal(got_d.numpy()[v], d[v])


@pytest.mark.parametrize("seed", range(6))
def test_transfer_skips_only_batches_that_cannot_pay(seed):
    """``may_pay`` is False only where the encode would not be
    worthwhile: over random mixes of float, int, bool and code columns
    of random ranges."""
    from spark_rapids_tpu_torch.columnar import transfer
    rng = np.random.RandomState(seed)
    n = 1 << 17
    for _ in range(12):
        pairs = []
        for _ in range(rng.randint(1, 7)):
            kind = rng.randint(4)
            if kind == 0:
                d = rng.standard_normal(n)
            elif kind == 1:
                d = rng.randint(0, 2 ** int(rng.randint(1, 40)), n)
            elif kind == 2:
                d = rng.rand(n) < 0.5
            else:
                d = rng.randint(0, 300, n).astype(np.int32)
            pairs.append((d, rng.rand(n) < rng.choice([0.5, 1.0])))
        flat, specs, params, ratio, raw = transfer.encode_columns(pairs)
        if not transfer.may_pay(pairs):
            assert not transfer.worthwhile(ratio, raw)


def test_chip_smoke_writer_files_read_back_in_pyarrow(tmp_path):
    """The script's own writer (numpy and zlib): pyarrow reads its files
    back equal to the input (page versions v1 and v2, GZIP, dictionary
    and PLAIN strings, the nullable l_partkey), and so does the port."""
    t = chip_smoke.gen_table(3000)
    t.update(chip_smoke.gen_parquet_extra(3000))
    out = chip_smoke.write_lineitem_parquet(t, str(tmp_path), files=3,
                                            prune_group_rows=512,
                                            batch_rows=1000)
    assert len(out["files"]) == 3
    order = out["prune_order"]
    cases = [(p, slice(lo, hi)) for p, lo, hi in out["files"]]
    cases.append((out["prune"][0], order))
    for p, rows in cases:
        got = pq.read_table(p)
        for name, col in zip(got.column_names, got.columns):
            w = t[name][rows]
            if isinstance(w, np.ma.MaskedArray):
                assert col.null_count == int(w.mask.sum()) > 0
                w = w.filled(0)
                col = col.fill_null(0)
            g = col.to_numpy(zero_copy_only=False)
            if w.dtype.kind in "US":
                assert g.astype(str).tolist() == w.astype(str).tolist(), name
            elif w.dtype.kind == "M":
                np.testing.assert_array_equal(g.astype("datetime64[D]"), w)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
    assert pq.ParquetFile(out["prune"][0]).metadata.num_row_groups == 6
    got = TorchSession(OFF, device="cpu").read_parquet(
        *[p for p, _, _ in out["files"]]).collect_numpy()
    for name, col in got.items():
        w = t[name]
        if w.dtype.kind in "US":
            assert col.data.astype(str).tolist() == w.astype(str).tolist()
        else:
            np.testing.assert_array_equal(np.ma.getmaskarray(col),
                                          np.ma.getmaskarray(w))
            np.testing.assert_array_equal(col.filled(0), np.ma.filled(w, 0),
                                          err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_c1_holds_when_the_last_row_group_is_short(tmp_path, mode):
    """Fault C1 over a Parquet scan: row groups of 500 rows and a last
    one of 3 rows of three modes, which ingests as a byte rectangle; the
    grouped count and the ORDER BY with a string payload equal the
    reference's."""
    from test_torch_groupby import _short_tail_table
    t = _short_tail_table()
    p = _write(tmp_path / "tail.parquet", t, row_group_size=500)
    assert pq.ParquetFile(p).metadata.row_group(2).num_rows == 3
    conf = {READER: mode}
    port, ref = _both([p], conf, query=lambda df, F: df.group_by("s").agg(
        F.count_star().with_name("n"),
        F.sum(F.col("x")).with_name("sx")).order_by("s"))
    got, want = port.collect(), ref.collect()
    assert [(r["s"], r["n"]) for r in got] == \
        [(r["s"], r["n"]) for r in want]
    # sums to a relative 1e-12: the port's batches follow row groups and
    # the reference's follow files, so they add in different orders
    for g, w in zip(got, want):
        assert abs(g["sx"] - w["sx"]) <= 1e-12 * abs(w["sx"]), (g, w)
    got = _assert_equal([p], conf, query=lambda df, F: df.select(
        "k", "s").order_by("k"))
    assert len(got) == 1003
    scan = _scan_of(TorchSession({**OFF, **conf}, device="cpu")
                    .read_parquet(p, columns=["s"]))
    kinds = [type(b.columns[0]).__name__ for b in scan.execute(
        TorchSession(OFF, device="cpu").exec_context())]
    assert kinds[-1] == "ByteRectColumn" or mode == "COALESCING"


@pytest.mark.parametrize("mode", MODES)
def test_scan_timings(tmp_path, mode):
    """spark.rapids.tpu.io.scanTimings.enabled fills the scan's stage
    times and counts (read by chip_smoke.py's cold wall split); off, the
    scan keeps none."""
    paths = [_write(tmp_path / f"t{k}.parquet", _table(800, k),
                    compression="gzip", row_group_size=300)
             for k in range(2)]
    for on in (True, False):
        s = TorchSession({**OFF, READER: mode,
                          "spark.rapids.tpu.io.scanTimings.enabled": on},
                         device="cpu")
        scan = _scan_of(s.read_parquet(*paths))
        assert sum(b.num_rows for b in scan.execute(s.exec_context())) \
            == 1600
        if not on:
            assert scan.timings is None
            continue
        tm = scan.timings
        assert tm["files"] == 2 and tm["row_groups_read"] == 6
        assert tm["batches"] == (1 if mode == "COALESCING" else 6)
        assert all(tm[k] > 0 for k in ("read_s", "decode_s", "encode_s",
                                       "copy_s", "file_bytes"))
        assert "GZIP" in tm["rates"] and "PLAIN byte array" in tm["rates"]
