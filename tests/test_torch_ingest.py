"""Fault C2 (ROADMAP.md Queue C): a string's trailing NUL bytes are part of
the string, on the CPU, against the reference.

numpy's ``S`` arrays drop a value's trailing 0x00 bytes on every read, so
the port's ingest once merged ``"a"``, ``"a\\x00"`` and ``"a\\x00\\x00"``
into one value of length 1. Strings with trailing and inner NULs
(``NUL_VALUES``) go through:

* both device layouts: a dictionary (few distinct values) and a byte
  rectangle (the same values among 1,700 distinct fillers, above the
  dictionary threshold of every 1,000-row batch);
* in-memory input from an object array and from an Arrow table, and a
  Parquet file (pyarrow's writer; plain and dictionary-encoded pages);
* GROUP BY with a count, ``count(DISTINCT)``, ORDER BY ascending and
  descending, ``=`` and ``IN`` against literals with NULs, ``length``,
  ``upper(trim())`` and ``substring``, and ``collect()`` of the values.

Each result is held equal to the reference's (``TpuSession``), whose
Arrow strings keep every byte. The ingest's own pieces are checked too:
dictionaries of strings without NULs are unchanged, and the host string
arrays keep their lengths through slicing, concatenation, Parquet pages
and the round trip back to Python strings.
"""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from harness import _assert_frames_equal, _canon
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import (ByteRectColumn, ColumnarBatch,
                                             DictColumn, HostTable)
from spark_rapids_tpu_torch.columnar.batch import (_try_dict_encode,
                                                   dict_to_rect, rect_to_dict)
from spark_rapids_tpu_torch.columnar.strrect import HostStrings, utf8_bytes

from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False,
       "spark.rapids.tpu.sql.batchSizeRows": 1000}

#: trailing and inner NULs, a NUL alone, the empty string, NULL, and
#: edge spaces around a NUL (for trim)
NUL_VALUES = ["a", "a\x00", "a\x00\x00", "\x00", "", None, "b", "a\x00b",
              " a\x00 ", "\x00\x00", "a"]


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _values(layout: str) -> np.ndarray:
    """2,400 values: NUL_VALUES over and over, among 1,700 distinct
    fillers for the rectangle layout."""
    rng = np.random.RandomState(7)
    base = np.array(NUL_VALUES, dtype=object)
    out = base[rng.randint(0, len(base), 2400)]
    if layout == "rectangle":
        fill = rng.rand(2400) < 0.75
        out[fill] = [f"w{i:05d}" for i in rng.permutation(
            int(fill.sum()))]
    return out


def _table(layout: str) -> pa.Table:
    s = _values(layout)
    return pa.table({"s": pa.array(list(s), pa.string()),
                     "x": pa.array(np.arange(len(s), dtype=np.int64))})


def _frames(layout: str, source: str, tmp_path):
    """(port DataFrame, reference DataFrame) over the same values."""
    t = _table(layout)
    port, ref = TorchSession(OFF, device="cpu"), TpuSession(OFF)
    if source == "objects":
        data = {"s": np.array(t.column("s").to_pylist(), dtype=object),
                "x": np.arange(t.num_rows, dtype=np.int64)}
        return port.create_dataframe(data), ref.create_dataframe(t)
    if source == "arrow":
        return port.create_dataframe(t), ref.create_dataframe(t)
    path = str(tmp_path / f"{layout}.parquet")
    # dictionary pages for the few-value table, plain pages past a small
    # dictionary page for the many-value one
    pq.write_table(t, path, row_group_size=1200,
                   dictionary_pagesize_limit=1024 if layout == "rectangle"
                   else 1 << 20)
    return port.read_parquet(path), ref.read_parquet(path)


def _group(df, F):
    return df.group_by("s").agg(F.count(F.col("x")).with_name("n"),
                                F.count_star().with_name("rows"))


def _distinct(df, F):
    return df.agg(F.count_distinct(F.col("s")).with_name("cd"),
                  F.count_star().with_name("rows"))


def _order_asc(df, F):
    return df.select("s", "x").order_by(F.col("s").asc(), F.col("x").asc())


def _order_desc(df, F):
    return df.select("s", "x").order_by(F.col("s").desc(),
                                        F.col("x").asc())


def _equals_in(df, F):
    return df.filter((F.col("s") == F.lit("a\x00"))
                     | F.col("s").isin("a\x00\x00", "\x00")).select("s", "x")


def _length(df, F):
    return df.select(F.length(F.col("s")).alias("n"), F.col("x"))


def _chain(df, F):
    return df.select(F.upper(F.trim(F.col("s"))).alias("u"),
                     F.substring(F.col("s"), 1, 2).alias("p"),
                     F.length(F.trim(F.col("s"))).alias("tn"), F.col("x"))


def _collect(df, F):
    return df.select("s", "x")


QUERIES = {"group_by": (_group, False), "count_distinct": (_distinct, False),
           "order_by_asc": (_order_asc, True),
           "order_by_desc": (_order_desc, True),
           "equals_in": (_equals_in, False), "length": (_length, False),
           "upper_trim_substring": (_chain, False),
           "collect": (_collect, False)}


@pytest.mark.parametrize("layout,kind", [("dictionary", DictColumn),
                                         ("rectangle", ByteRectColumn)])
def test_layouts_are_as_named(layout, kind):
    """Every 1,000-row batch of each table ingests in its named layout."""
    host = HostTable.from_arrow(_table(layout))
    for off in (0, 1000, 2000):
        col = ColumnarBatch.from_host(host.slice(off, 1000), "cpu",
                                      64).columns[0]
        assert isinstance(col, kind)


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("source", ["objects", "arrow", "parquet"])
@pytest.mark.parametrize("layout", ["dictionary", "rectangle"])
def test_nul_strings_equal_reference(layout, source, query, tmp_path):
    port_df, ref_df = _frames(layout, source, tmp_path)
    q, ordered = QUERIES[query]
    got = q(port_df, PF).collect_arrow().to_pandas()
    want = q(ref_df, RF).to_pandas()
    _assert_frames_equal(_canon(got, not ordered), _canon(want, not ordered),
                         False)
    if query == "group_by":
        keys = set(got["s"].dropna())
        assert {"a", "a\x00", "a\x00\x00", "\x00", "\x00\x00"} <= keys
    if query == "collect":
        vals = got.sort_values("x")["s"].tolist()
        assert [v if isinstance(v, str) else None for v in vals] \
            == list(_values(layout))


@pytest.mark.parametrize("layout,kind", [("dictionary", DictColumn),
                                         ("rectangle", ByteRectColumn)])
def test_probe_gives_six_groups_and_lengths(layout, kind):
    """The probe of fault C2 through both layouts: the reference's six
    groups and lengths 1, 2, 3."""
    probe = ["a", "a\x00", "a\x00\x00", "", "b", None, "a"]
    vals = np.array(probe + (probe * 9 if layout == "dictionary" else
                             [f"z{i:04d}" for i in range(600)]),
                    dtype=object)
    host = HostTable.from_dict({"s": vals, "x": np.arange(len(vals))})
    col = ColumnarBatch.from_host(host, "cpu", 64).columns[0]
    assert isinstance(col, kind)
    df = TorchSession(OFF, device="cpu").create_dataframe(
        {"s": vals, "x": np.arange(len(vals))})
    rows = df.filter(PF.col("x") < PF.lit(7)).group_by("s").agg(
        PF.count(PF.col("x")).with_name("n")).collect()
    got = {r["s"]: r["n"] for r in rows}
    assert got == {"a": 2, "a\x00": 1, "a\x00\x00": 1, "": 1, "b": 1,
                   None: 1}
    lens = [r["n"] for r in df.select(PF.length(PF.col("s")).alias("n"))
            .collect()[:3]]
    assert lens == [1, 2, 3]


def test_dictionaries_without_nuls_are_unchanged():
    """Codes and dictionaries of strings without NULs: numpy's unique over
    the ``S`` array, byte order, as before; from objects, an ``S`` array
    and a ``U`` array alike."""
    rng = np.random.RandomState(3)
    words = np.array(["b", "a", "ab", "", "é", "Z", "a b"], dtype=object)
    vals = words[rng.randint(0, len(words), 500)]
    valid = rng.rand(500) > 0.1
    want_dict = np.array(sorted(set(vals[valid]),
                                key=lambda v: v.encode()), dtype=object)
    for arr in (vals, vals.astype("U"),
                np.char.encode(vals.astype("U"), "utf-8")):
        codes, dictionary = _try_dict_encode(utf8_bytes(arr, valid), valid,
                                             500)
        assert list(dictionary) == list(want_dict)
        assert list(dictionary[codes[valid]]) == list(vals[valid])


def test_host_strings_keep_lengths():
    """Slices, index arrays, concatenation and the decode keep each
    value's trailing NULs; numpy's own S values have none."""
    vals = np.array(["a", "a\x00", "", "\x00é\x00", "xyz\x00\x00"],
                    dtype=object)
    hs = utf8_bytes(vals, np.ones(5, bool))
    assert list(hs.lengths) == [1, 2, 0, 4, 5]
    assert list(hs.to_objects()) == list(vals)
    assert list(hs[1:4].to_objects()) == list(vals[1:4])
    assert list(hs[np.array([4, 0, 1])].to_objects()) == list(vals[[4, 0,
                                                                    1]])
    both = HostStrings.concat([hs, HostStrings(np.array([b"q", b"r\x00"]))])
    assert list(both.to_objects()) == list(vals) + ["q", "r"]
    assert list(both.lengths) == [1, 2, 0, 4, 5, 1, 1]
    mixed = utf8_bytes(np.array([b"a\x00", "b\x00"], dtype=object),
                       np.ones(2, bool))
    assert list(mixed.lengths) == [2, 2]


def test_rectangle_and_dictionary_round_trip():
    """rect_to_dict and dict_to_rect (the aggregate's layout changes) keep
    trailing NULs, both ways."""
    vals = np.array(["a", "a\x00", "a\x00\x00", "\x00", "b", None] * 3,
                    dtype=object)
    host = HostTable.from_dict({"s": vals})
    # a 6-value batch of 18 rows is a dictionary; force the rectangle
    rect = ColumnarBatch.from_host(host, "cpu", 64).columns[0]
    if isinstance(rect, DictColumn):
        rect = dict_to_rect(rect, len(vals))
    assert isinstance(rect, ByteRectColumn)
    assert rect.lengths.tolist()[:5] == [1, 2, 3, 1, 1]
    d = rect_to_dict(rect, len(vals), 100)
    assert list(d.dictionary) == ["\x00", "a", "a\x00", "a\x00\x00", "b"]
    back = dict_to_rect(d, len(vals))
    assert back.lengths.tolist() == rect.lengths.tolist()
    assert list(back.to_numpy(len(vals))[0][:5]) == list(vals[:5])
