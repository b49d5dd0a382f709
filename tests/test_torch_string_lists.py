"""Strings and structs inside lists and maps, on the port against the JAX
package, on the CPU.

* Ingest and the way back: lists of strings from Python lists, numpy
  offsets over an ``S`` array or a ``HostStrings`` (trailing NULs kept),
  and Arrow; lists of structs and string-keyed maps; both element forms,
  dictionary codes (few distinct elements) and a byte rectangle (near
  unique ones), each checked to be the form it should be.
* The collection functions that ran over fixed-width elements
  (``size``, ``array_contains`` by a literal and by a column,
  ``array_position``, ``element_at``, ``get``, ``sort_array``,
  ``array_min``/``array_max``, ``slice``, ``array_reverse``, ``array``),
  the lambdas (``transform`` with a string chain, ``filter``, ``exists``
  and ``forall`` with a ``LIKE`` or ``startswith`` body, ``aggregate``
  over ``length``), ``explode``/``posexplode``/``explode_outer``, over
  string elements in both forms, over struct elements and over maps with
  string keys and values, on both packages over one Arrow table (the
  reference runs them on its host engine); values compare exactly.
* ``collect_list``/``collect_set``/``min_by``/``max_by`` of a string,
  ``collect_list`` of a struct, across 64-row batches.
* Rows that move: ``concat_batches`` of lists whose dictionaries differ
  (merged) and whose byte widths differ (widened); a join; both spill
  tiers; the out-of-core sort at 64-row batches and a 2 KiB
  ``batchSizeBytes``; a reference batch carried over. A group-by on
  ``posexplode``'s ``pos`` over an in-memory list of strings takes the
  dense route.
* Refusals naming the queue: a list of lists, a list past 256 elements,
  a string element past ``rect.maxBytes``.
* ``chip_smoke.py`` phase 18's queries at 20,000 lineitem rows against
  the script's numpy forms (its numpy (a) also against Python's
  ``bytes.split``).
"""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import (ByteRectColumn, ColumnarBatch,
                                             DictColumn, HostList, ListColumn)
from spark_rapids_tpu_torch.columnar.batch import HostTable, concat_batches
from spark_rapids_tpu_torch.columnar.nested import Slots, to_device_list
from spark_rapids_tpu_torch.columnar.strrect import HostStrings
from spark_rapids_tpu_torch.mem.manager import MemoryManager
from spark_rapids_tpu_torch.mem.spillable import SpillableBatch
from spark_rapids_tpu_torch.types import ArrayType, STRING

from test_torch_slice import prebuild_reference_native
from torch_compare import run_both

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
SMALL = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": 64,
         "spark.rapids.tpu.sql.batchSizeBytes": 2048}
WORDS = ["ash", "birch", "", "cedar ", "dogwood", "elm"]
FORMS = ["dict", "rect"]
STRUCT_T = pa.list_(pa.struct([("n", pa.int64()), ("s", pa.string())]))
MAP_T = pa.map_(pa.string(), pa.string())


def setup_module(_):
    prebuild_reference_native()


def _word(rng, form: str) -> str:
    if form == "dict":
        return WORDS[rng.randint(len(WORDS))]
    return f"w{rng.randint(10**6)}" + " " * rng.randint(2)


def table(n: int = 240, form: str = "dict", seed: int = 5) -> pa.Table:
    """Seeded ragged lists of strings (NULL rows, NULL and empty-string
    elements, empty lists), a list of structs, a string-keyed map, a
    string column and a key."""
    rng = np.random.RandomState(seed)
    lists, items, maps = [], [], []
    for i in range(n):
        k = rng.randint(0, 7)
        row = [None if rng.rand() < 0.1 else _word(rng, form)
               for _ in range(k)]
        lists.append(None if i % 11 == 3 else row)
        items.append(None if i % 13 == 5 else [
            None if rng.rand() < 0.1 else
            {"n": int(rng.randint(-3, 4)), "s": _word(rng, form)}
            for _ in range(rng.randint(0, 4))])
        keys = list(dict.fromkeys(_word(rng, form)
                                  for _ in range(rng.randint(0, 4))))
        maps.append(None if i % 17 == 2 else [
            (kk, None if rng.rand() < 0.2 else _word(rng, form))
            for kk in keys])
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "k": pa.array(rng.randint(0, 9, n), pa.int64()),
        "o": pa.array(rng.randint(0, 50, n), pa.int64()),
        "s": pa.array([None if i % 7 == 1 else _word(rng, form)
                       for i in range(n)]),
        "l": pa.array(lists, pa.list_(pa.string())),
        "it": pa.array(items, STRUCT_T),
        "m": pa.array(maps, MAP_T),
    })


# ---------------------------------------------------------------------------
# ingest and the way back
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_lists_of_strings_round_trip_in_their_form(form):
    t = table(200, form)
    s = TorchSession(device="cpu")
    b = ColumnarBatch.from_host(HostTable.from_arrow(t), "cpu", 64)
    col = b.columns[t.column_names.index("l")]
    assert isinstance(col, ListColumn) and isinstance(col.data, Slots)
    want = DictColumn if form == "dict" else ByteRectColumn
    assert isinstance(col.data.col, want)
    got = s.create_dataframe(t).select("l", "it", "m").collect()
    assert [r["l"] for r in got] == t.column("l").to_pylist()
    assert [r["it"] for r in got] == t.column("it").to_pylist()
    assert [r["m"] for r in got] == [
        None if r is None else [tuple(x) for x in r]
        for r in t.column("m").to_pylist()]
    assert s.create_dataframe(t).select("l").collect_arrow() \
        .column("l").to_pylist() == t.column("l").to_pylist()


def test_lists_from_numpy_offsets_keep_trailing_nuls():
    vals = HostStrings(np.array([b"a", b"a", b"bb", b""], "S3"),
                       np.array([1, 2, 2, 0], np.int32))
    hl = HostList(np.array([0, 2, 2, 4]), vals)
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"l": (hl, np.array([True, False, True]))})
    assert df.collect() == [{"l": ["a", "a\x00"]}, {"l": None},
                            {"l": ["bb", ""]}]
    sa = HostList(np.array([0, 1, 3]), np.array([b"x", b"y", b"zz"]))
    assert s.create_dataframe({"l": sa}).select(
        PF.size(PF.col("l")).alias("n")).collect() == [{"n": 1}, {"n": 2}]


def test_python_lists_of_strings_and_dicts():
    s = TorchSession(device="cpu")
    rows = {"a": [["x", None, ""], None, []],
            "b": [[{"p": 1, "q": "u"}, None], None, [{"p": 2, "q": None}]]}
    got = s.create_dataframe(rows).collect()
    assert [r["a"] for r in got] == rows["a"]
    assert [r["b"] for r in got] == rows["b"]


# ---------------------------------------------------------------------------
# collection functions, lambdas and generators over strings and structs
# ---------------------------------------------------------------------------

def _l(F):
    return F.col("l")


BUILDS = {
    "size": lambda df, F: df.select(F.size(_l(F)).alias("r")),
    "contains": lambda df, F: df.select(
        F.array_contains(_l(F), WORDS[1]).alias("a"),
        F.array_contains(_l(F), "").alias("b"),
        F.array_contains(_l(F), F.col("s")).alias("c")),
    "position": lambda df, F: df.select(
        F.array_position(_l(F), WORDS[3]).alias("a"),
        F.array_position(_l(F), F.col("s")).alias("b")),
    "element_at": lambda df, F: df.select(
        F.element_at(_l(F), 1).alias("a"), F.element_at(_l(F), -2)
        .alias("b"), F.element_at(_l(F), F.col("k") % F.lit(3) + F.lit(1))
        .alias("c")),
    "get": lambda df, F: df.select(F.get(_l(F), 0).alias("r")),
    "sort_array": lambda df, F: df.select(
        F.sort_array(_l(F)).alias("a"), F.sort_array(_l(F), False)
        .alias("d")),
    "min_max": lambda df, F: df.select(F.array_min(_l(F)).alias("a"),
                                       F.array_max(_l(F)).alias("b")),
    "slice": lambda df, F: df.select(F.slice(_l(F), 2, 3).alias("a"),
                                     F.slice(_l(F), -2, 2).alias("b")),
    "reverse": lambda df, F: df.select(F.array_reverse(_l(F)).alias("r")),
    "array": lambda df, F: df.select(
        F.array(F.col("s"), F.lit("x"), F.col("s")).alias("r")),
    "transform": lambda df, F: df.select(F.transform(
        _l(F), lambda x: F.upper(F.trim(x))).alias("r")),
    "filter": lambda df, F: df.select(F.filter(
        _l(F), lambda x: x.like("%a%")).alias("r")),
    "exists_forall": lambda df, F: df.select(
        F.exists(_l(F), lambda x: x.like("w1%")).alias("a"),
        F.forall(_l(F), lambda x: F.startswith(x, "c")).alias("b")),
    "aggregate": lambda df, F: df.select(F.aggregate(
        _l(F), F.lit(0), lambda acc, x: acc + F.length(x)).alias("r")),
    "explode": lambda df, F: df.select("id", F.explode(_l(F))),
    "explode_outer": lambda df, F: df.select("id", F.explode_outer(_l(F))),
    "items": lambda df, F: df.select(
        F.size(F.col("it")).alias("n"),
        F.element_at(F.col("it"), 1).alias("first"),
        F.array_reverse(F.col("it")).alias("rev"),
        F.slice(F.col("it"), 1, 2).alias("sl")),
    "items_explode": lambda df, F: df.select(
        "id", F.explode(F.col("it"))).select(
        "id", F.get_field(F.col("col"), "s").alias("s"),
        F.get_field(F.col("col"), "n").alias("n")),
    "map_fns": lambda df, F: df.select(
        F.map_keys(F.col("m")).alias("k"), F.map_values(F.col("m"))
        .alias("v"), F.map_entries(F.col("m")).alias("e"),
        F.size(F.col("m")).alias("n"),
        F.element_at(F.col("m"), WORDS[1]).alias("b")),
    "map_explode": lambda df, F: df.select("id", F.explode(F.col("m"))),
    "map_lambdas": lambda df, F: df.select(
        F.transform_values(F.col("m"), lambda k, v: F.upper(v)).alias("a"),
        F.map_filter(F.col("m"), lambda k, v: k.like("%e%")).alias("b")),
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_string_and_struct_elements_equal_the_reference(name, form):
    t = table(160, form)
    ref, port = run_both(t, lambda df, F, E: BUILDS[name](df, F),
                         conf=SMALL)
    assert port.to_pylist() == ref.to_pylist()


@pytest.mark.parametrize("form", FORMS)
def test_collect_aggregates_of_strings_and_structs(form):
    t = table(300, form, seed=8)

    def build(df, F, E):
        return df.group_by("k").agg(
            F.collect_list(F.col("s")).with_name("cl"),
            F.collect_set(F.col("s")).with_name("cs"),
            F.min_by(F.col("s"), F.col("o")).with_name("lo"),
            F.max_by(F.col("s"), F.col("o")).with_name("hi"),
            F.collect_list(F.struct(F.col("o"), F.col("s")))
            .with_name("st")).order_by("k")
    ref, port = run_both(t, build, conf=SMALL)
    r, p = ref.to_pylist(), port.to_pylist()
    for row in r + p:
        row["cs"] = sorted(row["cs"])
    # min_by/max_by break ties by arrival order in both packages
    assert p == r


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("column", ["l", "it"])
def test_posexplode_of_strings_and_structs_follows_spark(column, form):
    """posexplode over a list of strings or of structs: each element with
    its 0-based position, as Spark gives it; the reference raises here
    (its generator builds ``pos`` typed as the element: ROADMAP.md Queue
    C)."""
    t = table(160, form)
    s = TorchSession(SMALL, device="cpu")
    got = s.create_dataframe(t).select(
        "id", PF.posexplode(PF.col(column))).collect()
    want = [{"id": i, "pos": p, "col": x}
            for i, row in enumerate(t.column(column).to_pylist())
            for p, x in enumerate(row or [])]
    assert got == want
    with pytest.raises(Exception, match="convert"):
        run_both(t, lambda df, F, E: df.select(
            "id", F.posexplode(F.col(column))), conf=SMALL)


def test_posexplode_of_strings_by_position_takes_the_dense_route():
    t = table(400, "dict", seed=9)

    def q(df, F):
        return df.select(F.posexplode(F.col("l"))).group_by("pos").agg(
            F.count(F.col("col")).with_name("c"),
            F.count_star().with_name("n")).order_by("pos")
    s = TorchSession(SMALL, device="cpu")
    df = q(s.create_dataframe(t), PF)
    assert "route=dense" in df._physical().tree_string()
    lists = [r for r in t.column("l").to_pylist() if r]
    want = [{"pos": p, "c": sum(len(r) > p and r[p] is not None
                                for r in lists),
             "n": sum(len(r) > p for r in lists)}
            for p in range(max(map(len, lists)))]
    assert df.collect() == want


# ---------------------------------------------------------------------------
# rows that move
# ---------------------------------------------------------------------------

def test_concat_merges_dictionaries_and_widens_bytes():
    def batch(rows):
        return ColumnarBatch.from_host(HostTable.from_dict({"l": rows}),
                                       "cpu", 64)
    short = [["ash", "birch"], None]
    more = [["cedar"], ["ash"]]
    parts = [batch(short), batch(more)]
    assert list(parts[0].columns[0].data.col.dictionary) == ["ash", "birch"]
    col = concat_batches(parts).columns[0]
    assert list(col.data.col.dictionary) == ["ash", "birch", "cedar"]
    vals, valid = col.to_numpy(4)
    assert vals.to_pylist(valid, STRING) == short + more
    narrow = [[f"a{i:03d}" for i in range(j, j + 4)] for j in range(0, 40, 4)]
    wide = [[f"b{'x' * 10}{i:03d}" for i in range(j, j + 9)]
            for j in range(0, 90, 9)] + [None]
    parts = [batch(narrow), batch(wide)]
    widths = [(p.columns[0].width, p.columns[0].data.col.width)
              for p in parts]
    assert widths == [(4, 8), (16, 16)]
    col = concat_batches(parts).columns[0]
    assert isinstance(col.data.col, ByteRectColumn)
    assert (col.width, col.data.col.width) == (16, 16)
    vals, valid = col.to_numpy(21)
    assert vals.to_pylist(valid, STRING) == narrow + wide


@pytest.mark.parametrize("form", FORMS)
def test_string_list_payloads_through_join_sort_and_spill(form, tmp_path):
    t = table(400, form, seed=11)
    ref, port = run_both(t, lambda df, F, E: df.select(
        "k", "id", "l", "it", "m").order_by(F.col("k"), F.col("id")),
        conf=SMALL)
    assert port.to_pylist() == ref.to_pylist()
    s = TorchSession(SMALL, device="cpu")
    df = s.create_dataframe(t)
    df.select("k", "id", "l", "it").order_by("k", "id").collect()
    assert s.last_plan.last_buckets > 1          # out of core
    right = pa.table({"rk": pa.array(range(0, 9, 2), pa.int64())})
    got = df.join(s.create_dataframe(right), on=[("k", "rk")]).select(
        "id", "l", "it", "m").order_by("id").collect()
    rows = [r for r in t.to_pylist() if r["k"] % 2 == 0]
    assert [(r["id"], r["l"], r["it"]) for r in got] == [
        (r["id"], r["l"], r["it"]) for r in rows]
    b = ColumnarBatch.from_host(HostTable.from_arrow(
        t.select(["l", "it", "m"])), "cpu", 64)
    want = [c.to_numpy(b.num_rows) for c in b.columns]
    mm = MemoryManager(1 << 30, 1 << 30, str(tmp_path / "spill"))
    for tier in ("host", "disk"):
        sb = SpillableBatch(b, mm)
        sb.spill_to_host()
        if tier == "disk":
            sb.spill_to_disk()
        assert sb.tier == tier
        back = sb.get()
        for c, (v, ok), f in zip(back.columns, want, b.schema.fields):
            v2, ok2 = c.to_numpy(back.num_rows)
            if isinstance(f.dtype, ArrayType):
                assert v2.to_pylist(ok2, f.dtype.element) == \
                    v.to_pylist(ok, f.dtype.element)
            else:
                assert v2.to_pylist(ok2) == v.to_pylist(ok)
        sb.close()


def test_reference_batch_with_string_lists_carries_over():
    from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
    from spark_rapids_tpu_torch.columnar import batch_from_reference
    from spark_rapids_tpu_torch.types import Schema, StructField, from_arrow
    t = table(30).select(["id", "l", "it"])
    ref = RefBatch.from_arrow(t)
    cols = [{"arrow": c.array} if hasattr(c, "array") else
            {"data": np.asarray(c.data), "validity": np.asarray(c.validity)}
            for c in ref.columns]
    schema = Schema([StructField(f.name, from_arrow(f.type), True)
                     for f in t.schema])
    port = batch_from_reference(cols, schema, "cpu", ref.num_rows)
    for i, name in ((1, "l"), (2, "it")):
        vals, valid = port.columns[i].to_numpy(port.num_rows)
        assert vals.to_pylist(valid, schema[name].dtype.element) == \
            t.column(name).to_pylist()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_list_refusals_name_their_queue():
    s = TorchSession(device="cpu")
    nested = pa.table({"n": pa.array([[["a"]]], pa.list_(pa.list_(
        pa.string())))})
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        s.create_dataframe(nested).collect()
    long = HostList(np.array([0, 300]), np.array(["x"] * 300, object))
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        to_device_list(long, np.array([True]), ArrayType(STRING), "cpu")
    wide = HostList(np.array([0, 10]),
                    np.array([f"{i}" + "y" * 100 for i in range(10)], object))
    with pytest.raises(NotImplementedError,
                       match="rect.maxBytes.*slice 9b, the rest"):
        to_device_list(wide, np.array([True]), ArrayType(STRING), "cpu")
    df = s.create_dataframe({"l": [["a", "b"]]})
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.Col(PE.CreateArray(PF.col("l").expr)).alias("r")) \
            .collect()
    many = s.create_dataframe({"s": np.array([" ".join(["w"] * 300)],
                                             object)})
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        many.select(PF.split(PF.col("s"), " ").alias("w")).collect()


#: fault C3's shapes (ROADMAP.md Queue C): each over a host string column
C3_CASES = {
    "split": lambda df: df.select(PF.split(PF.col("t"), ",").alias("o")),
    "str_to_map": lambda df: df.select(PF.str_to_map(PF.col("t"))
                                       .alias("o")),
    "array": lambda df: df.select(PF.array(PF.col("t")).alias("o")),
    "collect_list": lambda df: df.group_by("k").agg(
        PF.collect_list(PF.col("t")).with_name("o")),
}


@pytest.mark.parametrize("case", sorted(C3_CASES))
def test_host_strings_into_nested_paths_are_refused_by_name(case):
    """Fault C3: 200 distinct texts of ~80 bytes, past rect.maxBytes = 64
    and not dictionary-shaped, stay host strings; split, str_to_map,
    array() and collect_list over them raise the named NotImplementedError
    (host strings inside nested values, slice 9b's rest), not an
    AttributeError."""
    rng = np.random.RandomState(3)
    texts = np.array([f"k{i}:v{i}," + "".join(rng.choice(list("abcdef"), 72))
                      for i in range(200)], object)
    df = TorchSession(OFF, device="cpu").create_dataframe(
        {"t": texts, "k": np.arange(200) % 4})
    with pytest.raises(NotImplementedError,
                       match="host strings.*slice 9b, the rest"):
        C3_CASES[case](df).collect()


# ---------------------------------------------------------------------------
# chip_smoke.py phase 18 at a small size
# ---------------------------------------------------------------------------

PHASE18 = ["a", "a_bytes", "a_first", "b", "b_sums", "b_sets", "c_pos",
           "c_special", "c_items", "d", "d_size", "e"]


@pytest.fixture(scope="module")
def phase18_data():
    import chip_smoke as C
    from spark_rapids_tpu_torch.types import INT32, Schema, StructField
    t = C.gen_table(20_000)
    host = HostTable.from_dict(t)
    om = C.gen_order_maps(C.gen_nested_orders(t), t)
    instr = C.gen_shipinstruct(20_000)
    li = host.select(["l_orderkey", "l_quantity", "l_extendedprice",
                      "l_shipmode"])
    li = HostTable({**li.columns,
                    "l_linenumber": (om["row_linenumber"],
                                     np.ones(20_000, bool)),
                    "l_shipinstruct": (instr, np.ones(20_000, bool))},
                   Schema(list(li.schema.fields)
                          + [StructField("l_linenumber", INT32, True),
                             StructField("l_shipinstruct", STRING, True)]))
    ol = C.gen_order_lists(C.gen_nested_orders(t), t)
    attrs = C.gen_attr_text(t)
    alen = (attrs.view(np.uint8).reshape(20_000, -1) != 0).sum(axis=1)
    at = HostTable({"attrs": (HostStrings(attrs, alen.astype(np.int32)),
                              np.ones(20_000, bool))},
                   Schema([StructField("attrs", STRING, True)]))
    return {"t": t, "comments": host.select(["l_comment"]), "om": om,
            "li": li, "want_b": C.lists18_numpy(om, t, instr), "ol": ol,
            "at": at}


@pytest.mark.parametrize("case", PHASE18)
def test_chip_smoke_phase18_queries_equal_numpy(case, phase18_data):
    """chip_smoke.py phase 18's queries at 20,000 lineitem rows in
    5,000-row batches (case e out of core at 64 KiB), on the port against
    the script's numpy forms."""
    import chip_smoke as C
    d = phase18_data
    t = d["t"]
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 5_000,
            "spark.rapids.tpu.sql.agg.wideBatchRows": 5_000,
            "spark.rapids.tpu.sql.pallas.enabled": True}
    if case == "e":
        conf["spark.rapids.tpu.sql.batchSizeBytes"] = 64 << 10
    s = TorchSession(conf, device="cpu")
    if case.startswith("a"):
        want = C.words18_numpy(t["l_comment"])
        df = s.create_dataframe(d["comments"])
        if case == "a":
            split = [c.split(b" ") for c in t["l_comment"]]
            assert want["n_words"] == sum(map(len, split))
            assert want["special"] == sum(b"special" in w for w in split)
            assert want["furious"] == sum(
                any(x.startswith(b"furious") for x in w) for w in split)
            assert want["ly"] == sum(x.endswith(b"ly") for w in split
                                     for x in w)
            assert C.q18_words(df, PF).collect() == [
                {k: want[k] for k in ("n_words", "special", "furious",
                                      "ly")}]
        elif case == "a_bytes":
            assert C.q18_joined_bytes(df, PF).collect() == [
                {"bytes": want["bytes"], "rows": 20_000}]
        else:
            got = C.q18_joined(s.create_dataframe(
                d["comments"].slice(0, 5_000)), PF).collect_numpy()
            assert np.array_equal(np.asarray(got["j"], object)
                                  .astype("S64"),
                                  C.joined18_numpy(t["l_comment"][:5_000]))
    elif case.startswith("b"):
        df = s.create_dataframe(d["li"])
        want = d["want_b"]
        if case == "b":
            assert C.lists18_right(C.q18_lists(df, PF).collect_numpy(),
                                   d["om"], want)
        elif case == "b_sums":
            assert C.q18_setops(df, PF).collect() == [want["sums"]]
        else:
            assert [(r["modes"], r["n"]) for r in C.q18_mode_sets(
                df, PF).collect()] == want["sets"]
    elif case.startswith("c"):
        want = C.orders18_numpy(d["ol"])
        df = s.create_dataframe(d["ol"]["table"])
        if case == "c_pos":
            assert [(r["pos"], r["n"]) for r in C.q18_modes_by_pos(
                df, PF).collect()] == want["by_pos"]
        elif case == "c_special":
            assert C.q18_special(df, PF).collect() == [
                {"n": want["special"]}]
        else:
            got = C.q18_items(df, PF).collect()[0]
            w = want["items"]
            assert (got["lines"], got["modes"], got["n"]) == (
                w["lines"], w["modes"], w["n"])
            assert abs(got["qty"] - w["qty"]) <= 1e-9 * w["qty"]
    elif case.startswith("d"):
        df = s.create_dataframe(d["at"])
        if case == "d":
            modes, counts = np.unique(t["l_shipmode"], return_counts=True)
            assert [(r["mode"], r["n"]) for r in C.q18_attr_modes(
                df, PF).collect()] == [(str(m), int(c))
                                        for m, c in zip(modes, counts)]
        else:
            assert C.q18_attr_size(df, PF).collect() == [
                {"entries": 60_000}]
    else:
        got = C.q18_sorted(s.create_dataframe(d["ol"]["table"]),
                           PF).collect_numpy()
        assert C.sorted18_right(got, d["om"], d["ol"])
        sorter = s.last_plan
        while type(sorter).__name__ != "TpuSortExec":
            sorter = sorter.children[0]
        assert sorter.last_buckets > 1
