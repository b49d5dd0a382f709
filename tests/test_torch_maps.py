"""Map columns of the port against the JAX package, on the CPU.

* ``map_keys``, ``map_values``, ``map_entries``, ``element_at`` and
  ``map[key]`` (``GetMapValue``), ``size``, ``map``/``create_map``,
  ``map_from_arrays``, ``map_concat`` (of disjoint keys), the map lambdas
  (``transform_keys``, ``transform_values``, ``map_filter``) and
  ``explode``/``explode_outer``/``posexplode`` of a map, over seeded maps
  of integer keys with NULL values, NULL and empty maps, on both packages
  over one Arrow table (the reference runs maps on its host engine);
  values compare exactly.
* The reference's own battery (tests/test_collections.py
  ``test_map_basics``, ``test_map_concat_from_arrays_str_to_map``,
  ``test_map_hofs``, ``test_create_array_map_struct``'s map case) with
  integer keys where it uses string keys (string keys and ``str_to_map``:
  tests/test_torch_array_fns.py); maps of list values are refused naming
  "slice 9b, the rest".
* Where the port follows Spark (``mapKeyDedupPolicy`` EXCEPTION, its
  default) and the reference does not (ROADMAP.md Queue C): a repeated
  key raises in ``map``, ``map_concat``, ``map_from_arrays`` and
  ``transform_keys``, where the reference keeps the last value, the last
  value, both entries and both entries. A NULL key raises in both.
* Ingest from numpy offsets, Python dicts and lists of pairs and Arrow;
  map payloads through ``concat_batches`` at two widths, a join, both
  spill tiers and the out-of-core sort (64-row batches, a 2 KiB
  ``batchSizeBytes``); a group-by on ``posexplode``'s ``pos`` over an
  in-memory map column takes the dense route.
* ``batch_from_reference`` carries a reference batch's map and struct
  columns over, and counts the rows of a batch of Arrow columns alone.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from torch_compare import run_both, sessions
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import ColumnarBatch, HostMap
from spark_rapids_tpu_torch.columnar.batch import HostTable, concat_batches
from spark_rapids_tpu_torch.exprs.base import ColumnRef, Literal
from spark_rapids_tpu_torch.mem.manager import MemoryManager
from spark_rapids_tpu_torch.mem.spillable import SpillableBatch

from test_torch_structs import same

SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 64,
         "spark.rapids.tpu.sql.batchSizeBytes": 2048}
MAP_T = pa.map_(pa.int32(), pa.float64())


def maps(n: int, seed: int, longest: int = 6) -> list:
    """Seeded int -> double maps: distinct keys a row, every 9th value
    NULL, every 13th map NULL and every 7th empty."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 13 == 4:
            out.append(None)
            continue
        m = 0 if i % 7 == 2 else rng.randint(1, longest + 1)
        keys = rng.choice(40, m, replace=False)
        out.append([(int(k), None if (i + j) % 9 == 0 else
                     float(np.round(rng.randn() * 100, 2)))
                    for j, k in enumerate(keys)])
    return out


def table(n: int = 300, seed: int = 5) -> pa.Table:
    rng = np.random.RandomState(seed)
    m = maps(n, seed)
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "m": pa.array(m, MAP_T),
        "m2": pa.array([None if r is None else [(k + 100, v) for k, v in r]
                        for r in maps(n, seed + 1)], MAP_T),
        "key": pa.array(rng.randint(0, 40, n).astype(np.int32), pa.int32()),
        "ka": pa.array([None if i % 17 == 1 else list(
            range(i % 5, i % 5 + i % 4)) for i in range(n)],
            pa.list_(pa.int64())),
        "va": pa.array([None if i % 19 == 3 else [float(i), None, 2.5][
            :i % 4] + [0.5] * max(0, i % 4 - 3) for i in range(n)],
            pa.list_(pa.float64())),
        "x": pa.array(np.round(rng.randn(n), 3)),
    })


def _from_arrays(df, F):
    return df.filter(F.size(F.col("ka")) == F.size(F.col("va"))).select(
        F.map_from_arrays(F.col("ka"), F.col("va")).alias("r"))


BUILDS = {
    "map_keys": lambda df, F, E: df.select(F.map_keys(F.col("m")).alias("r")),
    "map_values": lambda df, F, E: df.select(
        F.map_values(F.col("m")).alias("r")),
    "map_entries": lambda df, F, E: df.select(
        F.map_entries(F.col("m")).alias("r")),
    "element_at": lambda df, F, E: df.select(
        F.element_at(F.col("m"), F.col("key")).alias("r"),
        F.element_at(F.col("m"), F.lit(7)).alias("r7")),
    "get_map_value": lambda df, F, E: df.select(F.Col(E.GetMapValue(
        F.col("m").expr, F.col("key").expr)).alias("r")),
    "size": lambda df, F, E: df.select(F.size(F.col("m")).alias("r"),
                                       F.size(F.map_entries(F.col("m")))
                                       .alias("e")),
    "create_map": lambda df, F, E: df.select(F.create_map(
        F.lit(1), F.col("x"), F.col("key") + F.lit(100), F.lit(2.0))
        .alias("r")),
    "map_from_arrays": lambda df, F, E: _from_arrays(df, F),
    "map_concat": lambda df, F, E: df.select(
        F.map_concat(F.col("m"), F.col("m2")).alias("r")),
    "transform_keys": lambda df, F, E: df.select(F.transform_keys(
        F.col("m"), lambda k, v: k * F.lit(3) + F.lit(1)).alias("r")),
    "transform_values": lambda df, F, E: df.select(F.transform_values(
        F.col("m"), lambda k, v: v * F.lit(2.0) + k).alias("r")),
    "map_filter": lambda df, F, E: df.select(F.map_filter(
        F.col("m"), lambda k, v: v > F.lit(0.0)).alias("r")),
    "explode": lambda df, F, E: df.select("id", F.explode(F.col("m"))),
    "explode_outer": lambda df, F, E: df.select(
        "id", F.explode_outer(F.col("m"))),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_map_functions_equal_reference(name):
    ref, port = run_both(table(), BUILDS[name])
    assert ref.column_names == port.column_names
    assert same(port.to_pylist(), ref.to_pylist()), name


@pytest.mark.parametrize("outer", [False, True])
def test_posexplode_of_a_map_departure(outer):
    """posexplode of a map: pos and key equal the reference's; the
    reference types ``value`` as the map's key (its generate zips the two
    entry columns with three fields), so the port's values, of the map's
    value type, are held to the reference's ``explode`` (ROADMAP.md
    Queue C)."""
    t = table()
    ref, port = run_both(t, lambda df, F, E: df.select(
        "id", (F.posexplode_outer if outer else F.posexplode)(F.col("m"))))
    ref_explode, exploded = run_both(t, lambda df, F, E: df.select(
        "id", (F.explode_outer if outer else F.explode)(F.col("m"))))
    assert port.schema.field("value").type == pa.float64()
    assert ref.schema.field("value").type == pa.int32()
    for c in ("id", "pos", "key"):
        assert port.column(c).to_pylist() == ref.column(c).to_pylist(), c
    assert same(port.column("value").to_pylist(),
                ref_explode.column("value").to_pylist())
    assert same(exploded.to_pylist(), ref_explode.to_pylist())


def test_posexplode_by_position_takes_the_dense_route():
    t = table(500, seed=9)

    def q(df, F, E):
        return df.select(F.posexplode(F.col("m"))).group_by("pos").agg(
            F.sum(F.col("value")).with_name("s"),
            F.count(F.col("value")).with_name("c"),
            F.count_star().with_name("n")).order_by("pos")
    s = TorchSession(SMALL, device="cpu")
    df = q(s.create_dataframe(t), PF, PE)
    assert "route=dense" in df._physical().tree_string()
    got = df.collect()
    rows = [r for r in t.column("m").to_pylist() if r]
    want = []
    for j in range(max(len(r) for r in rows)):
        vals = [r[j][1] for r in rows if len(r) > j]
        ok = [v for v in vals if v is not None]
        want.append({"pos": j, "n": len(vals), "c": len(ok),
                     "s": float(np.sum(ok))})
    assert [(r["pos"], r["n"], r["c"]) for r in got] == \
        [(w["pos"], w["n"], w["c"]) for w in want]
    # sums of 2-decimal values in another order: within 1e-12 relative
    for g, w in zip(got, want):
        assert math.isclose(g["s"], w["s"], rel_tol=1e-12, abs_tol=1e-9)


def _one(col_expr, **cols):
    s = TorchSession(device="cpu")
    df = s.create_dataframe(pa.table(cols) if cols else pa.table(
        {"a": pa.array([1], pa.int64())}))
    return [r["r"] for r in df.select(col_expr.alias("r")).collect()]


IMAPS = [[(1, 1), (2, 2)], [], None, [(3, None)]]


def test_reference_battery_with_integer_keys():
    """tests/test_collections.py's map cases, keys 1, 2, 3 for "a", "b",
    "c" and 9, 10 for "x", "y"."""
    m = pa.array(IMAPS, type=pa.map_(pa.int64(), pa.int64()))
    F = PF
    assert _one(F.map_keys(F.col("m")), m=m) == [[1, 2], [], None, [3]]
    assert _one(F.map_values(F.col("m")), m=m) == [[1, 2], [], None, [None]]
    assert _one(F.map_entries(F.col("m")), m=m) == \
        [[{"key": 1, "value": 1}, {"key": 2, "value": 2}], [], None,
         [{"key": 3, "value": None}]]
    assert _one(F.element_at(F.col("m"), F.lit(2)), m=m) == \
        [2, None, None, None]
    # the reference's map_concat(m, m) keeps the last of each repeated
    # key; Spark raises (test_repeated_key_departures): disjoint here
    m9 = pa.array([[(k + 10, v) for k, v in r] if r is not None else None
                   for r in IMAPS], type=pa.map_(pa.int64(), pa.int64()))
    assert _one(F.map_concat(F.col("m"), F.col("m9")), m=m, m9=m9) == \
        [[(1, 1), (2, 2), (11, 1), (12, 2)], [], None, [(3, None),
                                                        (13, None)]]
    got = _one(F.map_from_arrays(F.array(F.lit(9), F.lit(10)),
                                 F.array(F.lit(1), F.lit(2))))
    assert got[0] == [(9, 1), (10, 2)]
    got = _one(F.create_map(F.lit(7), F.col("x")),
               x=pa.array([5, 6], pa.int64()))
    assert got == [[(7, 5)], [(7, 6)]]
    m = pa.array([[(1, 1), (2, 2)], None],
                 type=pa.map_(pa.int64(), pa.int64()))
    assert _one(F.transform_values(F.col("m"), lambda k, v: v * 10),
                m=m) == [[(1, 10), (2, 20)], None]
    assert _one(F.transform_keys(F.col("m"), lambda k, v: k + 100),
                m=m) == [[(101, 1), (102, 2)], None]
    assert _one(F.map_filter(F.col("m"), lambda k, v: v > 1), m=m) == \
        [[(2, 2)], None]


def test_string_keyed_maps_are_refused():
    s = TorchSession(device="cpu")
    # string keys run since slice 9b's rest, first part; list values wait
    sm = pa.table({"m": pa.array([[("a", [1])]], pa.map_(
        pa.string(), pa.list_(pa.int64())))})
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        s.create_dataframe(sm).collect()
    df = s.create_dataframe(pa.table({"t": pa.array(["a:1,b:2"])}))
    for e in (PE.MapFromArrays(PE.CreateArray(ColumnRef("t")),
                               PE.CreateArray(PE.CreateArray(Literal(1)))),
              PE.CreateMap(ColumnRef("t"), PE.CreateArray(Literal(1)))):
        with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
            df.select(PF.Col(e).alias("r")).collect()


DEPARTURES = {
    # name: (build, the reference's answer for the one row)
    "create_map": (lambda F: F.create_map(F.lit(1), F.lit(2.0), F.lit(1),
                                          F.lit(3.0)), [(1, 3.0)]),
    "map_concat": (lambda F: F.map_concat(
        F.create_map(F.lit(1), F.lit(2.0)),
        F.create_map(F.lit(1), F.lit(3.0))), [(1, 3.0)]),
    "map_from_arrays": (lambda F: F.map_from_arrays(
        F.array(F.lit(1), F.lit(1)), F.array(F.lit(2.0), F.lit(3.0))),
        [(1, 2.0), (1, 3.0)]),
    "transform_keys": (lambda F: F.transform_keys(
        F.create_map(F.lit(1), F.lit(2.0), F.lit(2), F.lit(3.0)),
        lambda k, v: k * F.lit(0)), [(0, 2.0), (0, 3.0)]),
}


@pytest.mark.parametrize("name", sorted(DEPARTURES))
def test_repeated_key_departures(name):
    """A key twice in a map: Spark's default policy raises, the port
    follows it; the reference keeps an answer (ROADMAP.md Queue C)."""
    build, ref_answer = DEPARTURES[name]
    t = pa.table({"a": pa.array([1], pa.int64())})
    ref_s, port_s = sessions()
    ref = ref_s.create_dataframe(t).select(build(RF).alias("r")) \
        .collect_arrow().column("r").to_pylist()
    assert ref == [ref_answer]
    with pytest.raises(ValueError, match="Duplicate map key"):
        port_s.create_dataframe(t).select(build(PF).alias("r")).collect()


def test_null_map_key_raises_in_both():
    t = pa.table({"a": pa.array([1, None], pa.int64())})
    for s, F in zip(sessions(), (RF, PF)):
        with pytest.raises(Exception, match="null as map key"):
            s.create_dataframe(t).select(F.create_map(
                F.col("a"), F.lit(1.0)).alias("r")).collect_arrow()
    with pytest.raises(ValueError, match="null as map key"):
        TorchSession(device="cpu").create_dataframe(t).select(
            PF.map_from_arrays(PF.array(PF.col("a")),
                               PF.array(PF.lit(1.0))).alias("r")).collect()


def test_map_ingest_forms_and_collect():
    rows = [{1: 2.0, 3: None}, None, {}, {5: 6.5}]
    pairs = [None if r is None else list(r.items()) for r in rows]
    offsets = np.array([0, 2, 2, 2, 3])
    hm = HostMap(offsets, np.array([1, 3, 5], np.int32),
                 np.array([2.0, 0.0, 6.5]), np.array([True, False, True]))
    s = TorchSession(device="cpu")
    for data in ({"m": rows}, {"m": pairs},
                 {"m": (hm, np.array([True, False, True, True]))},
                 pa.table({"m": pa.array(pairs, MAP_T)})):
        df = s.create_dataframe(data)
        assert [r["m"] for r in df.collect()] == pairs
        off, keys, vals, vvalid, valid = df.collect_numpy()["m"]
        assert off.tolist() == [0, 2, 2, 2, 3]
        assert keys.tolist() == [1, 3, 5]
        assert vals[vvalid].tolist() == [2.0, 6.5]
        assert valid.tolist() == [True, False, True, True]
        assert df.collect_arrow().column("m").to_pylist() == pairs


def test_map_payloads_through_concat_join_sort_and_spill(tmp_path):
    t = table(400, seed=11)
    ref, port = run_both(t, lambda df, F, E: df.select(
        "key", "id", "m").order_by(F.col("key"), F.col("id")), conf=SMALL)
    assert same(port.to_pylist(), ref.to_pylist())
    s = TorchSession(SMALL, device="cpu")
    df = s.create_dataframe(t)
    df.select("key", "id", "m").order_by("key", "id").collect()
    assert s.last_plan.last_buckets > 1          # out of core
    right = pa.table({"rk": pa.array(range(0, 40, 3), pa.int32())})
    ref, port = run_both(t, lambda df, F, E: df.select("key", "id", "m")
                         .filter(F.col("key") % F.lit(3) == F.lit(0))
                         .order_by("id"))
    got = df.join(s.create_dataframe(right), on=[("key", "rk")],
                  how="inner").select("id", "m").order_by("id").collect()
    assert same([r["m"] for r in got], port.column("m").to_pylist())
    # two widths concatenate at the wider
    parts = [ColumnarBatch.from_host(HostTable.from_dict({"m": rows}),
                                     "cpu", 64)
             for rows in ([[(1, 1.0)]], [[(k, float(k)) for k in range(9)],
                                         None])]
    both = concat_batches(parts)
    assert both.columns[0].width == 16
    vals, valid = both.columns[0].to_numpy(3)
    assert vals.to_pylist(valid) == [[(1, 1.0)],
                                     [(k, float(k)) for k in range(9)],
                                     None]
    # both spill tiers
    mm = MemoryManager(1 << 30, 1 << 30, str(tmp_path / "spill"))
    for tier in ("host", "disk"):
        sb = SpillableBatch(both, mm)
        sb.spill_to_host()
        if tier == "disk":
            sb.spill_to_disk()
        assert sb.tier == tier
        back = sb.get().columns[0]
        v2, ok2 = back.to_numpy(3)
        assert v2.to_pylist(ok2) == vals.to_pylist(valid)
        sb.close()


def test_reference_batch_with_maps_and_structs_carries_over():
    """``batch_from_reference``: a reference batch's map and struct
    columns (host Arrow columns there, given as ``arrow``) arrive as the
    port's device columns, the padding rows NULL."""
    from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
    from spark_rapids_tpu_torch.columnar import (MapColumn, StructColumn,
                                                batch_from_reference)
    from spark_rapids_tpu_torch.types import Schema, StructField, from_arrow
    t = pa.table({"x": pa.array([1.5, None, 3.0]),
                  "m": pa.array([[(1, 2.0)], None, []], MAP_T),
                  "st": pa.array([{"a": 1, "b": [1, 2]}, None,
                                  {"a": None, "b": []}])})
    ref = RefBatch.from_arrow(t)
    cols = []
    for c in ref.columns:
        if hasattr(c, "array"):
            cols.append({"arrow": c.array})
        else:
            cols.append({"data": np.asarray(c.data),
                         "validity": np.asarray(c.validity)})
    schema = Schema([StructField(f.name, from_arrow(f.type), True)
                     for f in t.schema])
    port = batch_from_reference(cols, schema, "cpu", ref.num_rows)
    assert isinstance(port.columns[1], MapColumn)
    assert isinstance(port.columns[2], StructColumn)
    assert port.columns[1].padded_len == ref.padded_len
    assert not bool(port.columns[2].validity[ref.num_rows:].any())
    for i, name in enumerate(t.column_names[1:], 1):
        vals, valid = port.columns[i].to_numpy(port.num_rows)
        got = vals.to_pylist(valid)
        assert got == t.column(name).to_pylist(), name


def test_reference_batch_of_arrow_columns_alone_counts_its_rows():
    """``batch_from_reference`` with only ``arrow`` columns and no
    ``num_rows``: the batch holds as many rows as its columns, not
    none."""
    from spark_rapids_tpu_torch.columnar import batch_from_reference
    from spark_rapids_tpu_torch.types import Schema, StructField, from_arrow
    arr = pa.array([[(1, 2.0)], None, []], MAP_T)
    schema = Schema([StructField("m", from_arrow(arr.type), True)])
    port = batch_from_reference([{"arrow": arr}], schema, "cpu")
    assert port.num_rows == 3
    vals, valid = port.columns[0].to_numpy(port.num_rows)
    assert vals.to_pylist(valid) == arr.to_pylist()
    with pytest.raises(ValueError, match="num_rows"):
        batch_from_reference([], Schema([]), "cpu")
