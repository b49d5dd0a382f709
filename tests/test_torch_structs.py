"""Struct columns of the port against the JAX package, on the CPU.

* ``struct``/``named_struct`` of numbers, dates, dictionary and
  byte-rectangle strings and lists, a struct of a struct, and
  ``get_field`` of each field (a NULL struct gives a NULL field, as
  ``pc.struct_field`` does), on both packages over one Arrow table (the
  reference runs structs on its host engine); values compare exactly.
* The reference's own battery (tests/test_collections.py,
  ``test_create_array_map_struct``'s struct cases) on the port.
* Ingest from Python dicts, a ``HostStruct`` and Arrow, back out through
  ``collect``, ``collect_numpy`` and ``collect_arrow``; each field keeps
  its layout (a dictionary or a byte rectangle, a list rectangle).
* Struct payloads through a filter on a field, ``concat_batches``, a
  join, both spill tiers and the out-of-core sort (64-row batches, a
  2 KiB ``batchSizeBytes``), against the reference.
* A string field of a struct as a sort key and a group key over
  batches whose dictionaries differ.
* Refusals, naming their queue entry: a struct as a group key, a field
  of host strings, a field of a list of strings.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from torch_compare import run_both
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import (ByteRectColumn, ColumnarBatch,
                                            DictColumn, HostStruct,
                                            ListColumn, StructColumn)
from spark_rapids_tpu_torch.columnar.batch import HostTable, concat_batches
from spark_rapids_tpu_torch.mem.manager import MemoryManager
from spark_rapids_tpu_torch.mem.spillable import SpillableBatch

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 64,
         "spark.rapids.tpu.sql.batchSizeBytes": 2048}


def same(a, b) -> bool:
    """Nested Python values equal, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def table(n: int = 300, seed: int = 7) -> pa.Table:
    rng = np.random.RandomState(seed)
    lists = [None if i % 11 == 3 else
             [int(x) for x in rng.randint(-5, 5, rng.randint(0, 6))]
             for i in range(n)]
    words = np.array(["ash", "birch", "cedar", "dogwood"], object)
    return pa.table({
        "k": pa.array(rng.randint(0, 9, n), pa.int64()),
        "x": pa.array(np.where(rng.rand(n) < 0.1, None,
                               rng.randint(-50, 50, n)).tolist(),
                      pa.int32()),
        "d": pa.array(np.round(rng.randn(n) * 100, 2)),
        "day": pa.array(rng.randint(8000, 9000, n).astype(np.int32),
                        pa.int32()).cast(pa.date32()),
        "w": pa.array([None if i % 13 == 0 else words[i % 4]
                       for i in range(n)]),
        "u": pa.array([f"row-{i}-{'z' * (i % 7)}" for i in range(n)]),
        "l": pa.array(lists, pa.list_(pa.int64())),
    })


BUILDS = {
    "struct_of_columns": lambda df, F, E: df.select(
        "k", F.struct(F.col("x"), F.col("d"), F.col("day"), F.col("w"),
                      F.col("l")).alias("s")),
    "named_struct": lambda df, F, E: df.select(F.named_struct(
        F.lit("a"), F.col("x"), F.lit("b"), F.col("d") * 2,
        F.lit("c"), F.col("u")).alias("s")),
    "struct_of_struct": lambda df, F, E: df.select(F.struct(
        F.struct(F.col("x"), F.col("w")).alias("in"), F.col("d"))
        .alias("s")),
    "get_field": lambda df, F, E: df.select(
        F.struct(F.col("x"), F.col("d"), F.col("w"), F.col("l"))
        .alias("s")).select(
        F.get_field(F.col("s"), "x").alias("x"),
        F.get_field(F.col("s"), "d").alias("d"),
        F.get_field(F.col("s"), "w").alias("w"),
        F.get_field(F.col("s"), "l").alias("l")),
    "get_field_of_struct": lambda df, F, E: df.select(F.struct(
        F.struct(F.col("x"), F.col("day")).alias("in")).alias("s")).select(
        F.get_field(F.get_field(F.col("s"), "in"), "day").alias("day")),
    "filter_on_field": lambda df, F, E: df.select(
        "k", F.struct(F.col("x"), F.col("d")).alias("s")).filter(
        F.get_field(F.col("s"), "x") > F.lit(10)),
    "arithmetic_on_fields": lambda df, F, E: df.select(
        F.struct(F.col("x"), F.col("d")).alias("s")).select(
        (F.get_field(F.col("s"), "x") * F.get_field(F.col("s"), "d"))
        .alias("p")),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_struct_functions_equal_reference(name):
    ref, port = run_both(table(), BUILDS[name])
    assert ref.column_names == port.column_names
    assert same(port.to_pylist(), ref.to_pylist()), name


def test_reference_battery_struct_cases():
    """tests/test_collections.py ``test_create_array_map_struct``."""
    s = TorchSession(device="cpu")
    df = s.create_dataframe(pa.table({"x": pa.array([5, None], pa.int64())}))
    got = df.select(PF.struct(PF.col("x"), (PF.col("x") * 2).alias("y"))
                    .alias("r")).collect()
    assert [r["r"] for r in got] == [{"x": 5, "y": 10},
                                    {"x": None, "y": None}]
    got = df.select(PF.get_field(PF.struct(PF.col("x")), "x").alias("r")) \
        .collect()
    assert [r["r"] for r in got] == [5, None]


def test_struct_column_ingest_and_collect_forms():
    rows = [{"a": 1, "b": 2.5, "c": [1, 2]}, None,
            {"a": None, "b": -1.0, "c": None}, {"a": 4, "b": 0.0, "c": []}]
    s = TorchSession(device="cpu")
    for data in ({"s": rows},
                 pa.table({"s": pa.array(rows)}),
                 {"s": HostStruct.from_pylist(rows)}):
        df = s.create_dataframe(data)
        assert [r["s"] for r in df.collect()] == rows
        fields, valid = df.collect_numpy()["s"]
        assert valid.tolist() == [True, False, True, True]
        # a NULL struct's field slots hold what they hold
        assert fields["a"].mask[valid].tolist() == [False, True, False]
        assert fields["c"][0].tolist() == [0, 2, 2, 2, 2]
        assert df.collect_arrow().column("s").to_pylist() == rows


def test_fields_keep_their_layouts():
    t = table(64)
    s = TorchSession(device="cpu")
    df = s.create_dataframe(t).select(
        PF.struct(PF.col("w"), PF.col("u"), PF.col("l"),
                  PF.struct(PF.col("x")).alias("in")).alias("s"))
    batch = next(iter(df._physical().execute(s.exec_context())))
    col = batch.columns[0]
    assert isinstance(col, StructColumn)
    kinds = [type(c) for c in col.children]
    assert kinds == [DictColumn, ByteRectColumn, ListColumn, StructColumn]
    # a sort moves every field in its layout
    out = s.create_dataframe(t).select(
        "k", PF.struct(PF.col("w"), PF.col("l")).alias("s")) \
        .order_by("k").collect()
    want = sorted(zip(t.column("k").to_pylist(),
                      [{"w": w, "l": li} for w, li in zip(
                          t.column("w").to_pylist(),
                          t.column("l").to_pylist())]),
                  key=lambda r: r[0])
    assert [(r["k"], r["s"]) for r in out] == want


def test_string_field_as_sort_and_group_key_across_batches():
    """A string field of a struct keyed on by a sort and a group-by, over
    64-row batches whose dictionaries differ (the first batch holds one
    word, the second another that no later batch holds): a projection
    below each makes the field a column, whose batches' dictionaries are
    unified as any string column's are; a struct made in an aggregate's
    folded projection keeps its string field's dictionary."""
    rng = np.random.RandomState(5)
    words = np.array(["AIR", "SHIP", "RAIL", "TRUCK", "MAIL"], object)
    m = words[rng.randint(0, 5, 400)]
    m[:64], m[64:128] = "AIR", "ZULU"
    t = pa.table({"a": pa.array(np.arange(400), pa.int64()),
                  "m": pa.array(m.tolist())})
    s = TorchSession(SMALL, device="cpu")
    df = s.create_dataframe(t).select(
        PF.struct(PF.col("a"), PF.col("m")).alias("st"))
    field = PF.get_field(PF.col("st"), "m")
    got = df.order_by(field, PF.get_field(PF.col("st"), "a")).collect()
    assert [(r["st"]["m"], r["st"]["a"]) for r in got] == \
        sorted(zip(m.tolist(), range(400)))
    grouped = df.group_by(field.alias("g")).agg(
        PF.count(PF.get_field(PF.col("st"), "a")).with_name("n")) \
        .order_by("g").collect()
    want = {}
    for w in m.tolist():
        want[w] = want.get(w, 0) + 1
    assert [(r["g"], r["n"]) for r in grouped] == sorted(want.items())
    firsts = s.create_dataframe(t).select(
        "a", PF.struct(PF.col("m")).alias("st")).group_by(
        PF.get_field(PF.col("st"), "m").alias("g")).agg(
        PF.min(PF.col("a")).with_name("lo")).order_by("g").collect()
    assert [r["g"] for r in firsts] == sorted(want)


def test_struct_payloads_through_concat_join_and_sort():
    t = table(400, seed=3)

    def with_struct(df, F):
        return df.select("k", F.struct(F.col("x"), F.col("w"), F.col("l"),
                                       F.col("day")).alias("s"))

    ref, port = run_both(t, lambda df, F, E: with_struct(df, F).order_by(
        F.col("k"), F.get_field(F.col("s"), "day")), conf=SMALL)
    assert same(port.to_pylist(), ref.to_pylist())
    s = TorchSession(SMALL, device="cpu")
    port_df = with_struct(s.create_dataframe(t), PF).order_by(
        PF.col("k"), PF.get_field(PF.col("s"), "day"))
    port_df.collect()
    assert s.last_plan.last_buckets > 1          # out of core

    right = pa.table({"rk": pa.array(range(0, 9, 2), pa.int64()),
                      "v": pa.array([1.5, 2.5, 3.5, 4.5, 5.5])})

    for how in ("inner", "left"):
        got = with_struct(s.create_dataframe(t), PF).join(
            s.create_dataframe(right), on=[("k", "rk")], how=how).collect()
        want = with_struct(TorchSession(device="cpu").create_dataframe(t),
                           PF).collect()
        keys = set(right.column("rk").to_pylist())
        expect = [w["s"] for w in want if how == "left" or w["k"] in keys]
        assert sorted(map(repr, (r["s"] for r in got))) == \
            sorted(map(repr, expect)), how

    # concat_batches: structs whose list fields have different widths
    parts = [ColumnarBatch.from_host(HostTable.from_dict({"s": rows}), "cpu",
                                     64)
             for rows in ([{"a": 1, "l": [1]}],
                          [{"a": 2, "l": list(range(9))}, None])]
    both = concat_batches(parts)
    assert both.columns[0].children[1].width == 16
    got, valid = both.columns[0].to_numpy(3)
    assert got.to_pylist(valid) == [{"a": 1, "l": [1]},
                                    {"a": 2, "l": list(range(9))}, None]


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_struct_batch_survives_spill_tiers(tier, tmp_path):
    t = table(100)
    s = TorchSession(device="cpu")
    df = s.create_dataframe(t).select(
        PF.struct(PF.col("x"), PF.col("w"), PF.col("u"), PF.col("l"),
                  PF.struct(PF.col("d")).alias("in")).alias("s"))
    want = df.collect()
    batch = next(iter(df._physical().execute(s.exec_context())))
    mm = MemoryManager(1 << 30, 1 << 30, str(tmp_path / "spill"))
    sb = SpillableBatch(batch, mm)
    sb.spill_to_host()
    if tier == "disk":
        sb.spill_to_disk()
    assert sb.tier == tier
    back = sb.get()
    vals, valid = back.columns[0].to_numpy(back.num_rows)
    assert [{"s": r} for r in vals.to_pylist(valid)] == want
    sb.close()


def test_struct_refusals_name_their_queue():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(table(16))
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.struct(PF.col("x")).alias("s")).group_by("s") \
            .agg(PF.count_star().with_name("n")).collect()
    # distinct strings past the 64-byte rectangle stay host strings
    wide = {"s": [{"t": f"{i}" * 200} for i in range(10)]}
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        s.create_dataframe(wide).collect()
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.struct(PF.array(PF.array(PF.col("w")))).alias("s")) \
            .collect()
