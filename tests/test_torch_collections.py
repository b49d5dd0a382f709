"""List columns and the collection functions of the port against the JAX
package, on the CPU.

* Every device collection function (``size``, ``array_contains``,
  ``array_position``, ``element_at``, ``get``, ``sort_array``,
  ``array_min``/``array_max``, ``slice``, ``array_reverse``, ``array``,
  ``sequence``) over seeded ragged lists of bigints and doubles with NULL
  rows, NULL elements, empty lists, NaN and -0.0, at widths 4 and 16, on
  both packages with the reference's optimizer off; values compare
  exactly (-0.0 and 0.0 as equal numbers here: where their order or sign
  is Spark's and not the reference's, the departure tests hold them).
* The reference's own battery (tests/test_collections.py, the list
  cases) and the collection cases of tests/test_spark_semantics.py, on
  the port.
* Where the port follows Spark and the reference does not (ROADMAP.md
  Queue C): NaN found by ``array_contains``/``array_position``; the first
  of equal extremes (-0.0, 0.0) from ``array_min``/``array_max``;
  ``sort_array`` descending keeping equal elements in order; a NULL step
  of ``sequence`` giving NULL.
* A list payload through a filter, a join and an out-of-core sort (64-row
  batches, a 2 KiB ``batchSizeBytes``), batches of different widths, a
  spilled list batch, and a list built from numpy offsets with pyarrow
  and pandas unimportable.
* Refusals: a literal index 0 at planning, a column's at its batch; and
  every construct that now waits for "slice 9b, the rest", each naming
  it.
"""
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import ColumnarBatch, HostList
from spark_rapids_tpu_torch.columnar.batch import HostTable, concat_batches
from spark_rapids_tpu_torch.columnar.nested import to_device_list
from spark_rapids_tpu_torch.exprs.aggregates import CollectList, CollectSet
from spark_rapids_tpu_torch.exprs.base import ColumnRef, Literal
from spark_rapids_tpu_torch.mem.manager import MemoryManager
from spark_rapids_tpu_torch.mem.spillable import SpillableBatch
from spark_rapids_tpu_torch.types import ArrayType, FLOAT64, INT64

from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
SMALL = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": 64,
         "spark.rapids.tpu.sql.batchSizeBytes": 2048}
NAN = float("nan")


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def ragged(n: int, width: int, kind: str, seed: int) -> list:
    """Seeded lists: NULL rows, empty lists, NULL elements, at most
    ``width`` elements (one row that long); doubles include NaN, -0.0 and
    0.0."""
    rng = np.random.RandomState(seed)
    pool = [NAN, -0.0, 0.0, 1.5, -2.25, 3.0, 1e300, -1e300]
    rows = []
    for i in range(n):
        r = rng.rand()
        if r < 0.1:
            rows.append(None)
            continue
        k = 0 if r < 0.2 else (width if i == 3 else rng.randint(1, width + 1))
        vals = []
        for _ in range(k):
            if rng.rand() < 0.15:
                vals.append(None)
            elif kind == "double":
                vals.append(float(pool[rng.randint(len(pool))])
                            if rng.rand() < 0.5 else float(rng.randint(-4, 5)))
            else:
                vals.append(int(rng.randint(-5, 6)))
        rows.append(vals)
    return rows


def table(n=60, width=4, kind="bigint", seed=0) -> pa.Table:
    atype = pa.float64() if kind == "double" else pa.int64()
    rng = np.random.RandomState(seed + 100)
    return pa.table({
        "a": pa.array(ragged(n, width, kind, seed), pa.list_(atype)),
        "b": pa.array(ragged(n, width, kind, seed + 1), pa.list_(atype)),
        "k": pa.array(rng.randint(-3, 4, n).astype(np.int64)),
        "i": pa.array(rng.randint(-3, 4, n).astype(np.int32),
                      mask=rng.rand(n) < 0.1)})


def norm(x):
    """A value for exact comparison: NaN as a string, -0.0 as 0.0."""
    if isinstance(x, list):
        return [norm(v) for v in x]
    if isinstance(x, float):
        return "nan" if math.isnan(x) else x + 0.0
    return x


def both(t: pa.Table, build, conf=None):
    """``build(df, F)`` on the reference and on the port: per output
    column its values, normalized."""
    conf = {**OFF, **(conf or {})}
    out = []
    for s, F in ((TpuSession(conf), RF),
                 (TorchSession(conf, device="cpu"), PF)):
        got = build(s.create_dataframe(t), F).collect_arrow()
        out.append({n: norm(got.column(n).to_pylist())
                    for n in got.column_names})
    return out


def port_rows(t, build, conf=None):
    s = TorchSession({**OFF, **(conf or {})}, device="cpu")
    return build(s.create_dataframe(t), PF).collect()


def _functions(F, kind):
    a = F.col("a")
    needle = 3.0 if kind == "double" else 3
    return [
        F.size(a).alias("size"),
        F.array_contains(a, needle).alias("contains"),
        F.array_position(a, -2.25 if kind == "double" else -2).alias("pos"),
        F.element_at(a, 2).alias("at2"),
        F.element_at(a, -1).alias("at_last"),
        F.element_at(a, F.lit(-3)).alias("at_m3"),
        F.get(a, 0).alias("get0"),
        F.get(a, 5).alias("get5"),
        F.sort_array(a).alias("sort_asc"),
        F.sort_array(a, False).alias("sort_desc"),
        F.array_min(a).alias("min"),
        F.array_max(a).alias("max"),
        F.slice(a, 2, 3).alias("slice"),
        F.slice(a, -2, 5).alias("slice_neg"),
        F.array_reverse(a).alias("reverse"),
        F.array(F.col("k"), F.col("k") * 2, F.lit(None)).alias("array"),
        F.size(F.slice(F.sort_array(a, False), 1, 2)).alias("nested"),
    ]


@pytest.mark.parametrize("kind", ["bigint", "double"])
@pytest.mark.parametrize("width", [4, 16])
def test_device_functions_equal_reference(kind, width):
    t = table(width=width, kind=kind, seed=width)
    want, got = both(t, lambda df, F: df.select(*_functions(F, kind)))
    for name in want:
        assert got[name] == want[name], name


def test_sequence_equals_reference():
    t = pa.table({"s": pa.array([1, 5, -2, 3, 0], pa.int64()),
                  "e": pa.array([4, 1, 2, 3, None], pa.int64())})
    want, got = both(t, lambda df, F: df.select(
        F.sequence(F.col("s"), F.col("e")).alias("d"),
        F.sequence(F.col("s"), F.col("s") + F.lit(6), F.lit(2)).alias("u"),
        F.size(F.sequence(F.lit(1), F.col("s") + F.lit(3))).alias("n")))
    assert got == want


def test_element_at_column_index_equals_reference():
    t = table(width=4, seed=5)
    i = np.asarray(t["i"].fill_null(1))
    t = t.set_column(3, "i", pa.array(np.where(i == 0, 2, i).astype(
        np.int32), mask=np.asarray(t["i"].is_null())))
    want, got = both(t, lambda df, F: df.select(
        F.element_at(F.col("a"), F.col("i")).alias("e"),
        F.get(F.col("a"), F.col("i")).alias("g"),
        F.array_contains(F.col("a"), F.col("k")).alias("c")))
    assert got == want


# ---------------------------------------------------------------------------
# the reference's battery (tests/test_collections.py), on the port
# ---------------------------------------------------------------------------

ARRS = [[1, 2, 3], [], None, [4, None, 6], [7], [None]]


def _run(col, **cols):
    if not cols:
        cols = {"a": ARRS}
    return [r["r"] for r in port_rows(pa.table(cols),
                                      lambda df, F: df.select(col.alias("r")))]


def test_reference_battery():
    F = PF
    a = F.col("a")
    assert _run(F.size(a)) == [3, 0, -1, 3, 1, 1]
    assert _run(F.array_contains(a, 1)) == [True, False, None, None, False,
                                            None]
    assert _run(F.array_contains(a, 6)) == [False, False, None, True, False,
                                            None]
    assert _run(F.array_position(a, 6)) == [0, 0, None, 3, 0, 0]
    assert _run(F.element_at(a, 2)) == [2, None, None, None, None, None]
    assert _run(F.element_at(a, -1)) == [3, None, None, 6, 7, None]
    assert _run(F.get(a, 0)) == [1, None, None, 4, 7, None]
    assert _run(F.get(a, 9)) == [None] * 6
    assert _run(F.sort_array(a)) == [[1, 2, 3], [], None, [None, 4, 6], [7],
                                     [None]]
    assert _run(F.sort_array(a, asc=False)) == [[3, 2, 1], [], None,
                                                [6, 4, None], [7], [None]]
    assert _run(F.array_min(a)) == [1, None, None, 4, 7, None]
    assert _run(F.array_max(a)) == [3, None, None, 6, 7, None]
    assert _run(F.slice(a, 2, 2)) == [[2, 3], [], None, [None, 6], [], []]
    assert _run(F.slice(a, -2, 2)) == [[2, 3], [], None, [None, 6], [], []]
    with pytest.raises(ValueError, match="start at 1"):
        _run(F.slice(a, 0, 2))
    assert _run(F.sequence(F.lit(1), F.lit(5))) == [[1, 2, 3, 4, 5]] * 6
    assert _run(F.sequence(F.lit(5), F.lit(1), F.lit(-2))) == [[5, 3, 1]] * 6
    with pytest.raises(ValueError, match="Illegal sequence boundaries"):
        _run(F.sequence(F.lit(1), F.lit(5), F.lit(-1)))
    assert _run(F.array_reverse(a)) == [[3, 2, 1], [], None, [6, None, 4],
                                        [7], [None]]
    assert _run(F.array(F.lit(1), F.lit(2))) == [[1, 2]] * 6


@pytest.mark.parametrize("case", ["element_at_negative_one_last",
                                  "sort_array_nulls_first_asc",
                                  "array_contains_null_semantics"])
def test_spark_semantics_collection_cases(case):
    """The collection cases of tests/test_spark_semantics.py, with the
    port's F."""
    F = PF
    cases = {
        "element_at_negative_one_last": (
            {"x": [[1, 2, 3]]}, F.element_at(F.col("x"), -1), [3]),
        "sort_array_nulls_first_asc": (
            {"x": [[3, None, 1]]}, F.sort_array(F.col("x")), [[None, 1, 3]]),
        "array_contains_null_semantics": (
            {"x": [[1, None], [1, 2]]}, F.array_contains(F.col("x"), 3),
            [None, False]),
    }
    cols, expr, want = cases[case]
    assert _run(expr, **cols) == want


# ---------------------------------------------------------------------------
# departures toward Spark (ROADMAP.md Queue C)
# ---------------------------------------------------------------------------

def _signed(x):
    if isinstance(x, list):
        return [_signed(v) for v in x]
    if isinstance(x, float):
        return "nan" if math.isnan(x) else (x, math.copysign(1.0, x))
    return x


def test_float_elements_follow_spark_ordering():
    """Spark compares elements by its ordering: NaN equals NaN (and is the
    greatest), -0.0 equals 0.0. So ``array_contains``/``array_position``
    find NaN; ``array_min``/``array_max`` keep the first of equal
    extremes; ``sort_array`` keeps equal elements in their order in both
    directions (a stable sort). The reference compares with ``==`` and
    takes XLA's min/max and a reversed ascending sort."""
    d = [[0.0, -0.0, NAN, 1.0], [-0.0, 0.0], [NAN], [2.0, NAN, -1.0],
         [0.0, None, -0.0]]
    F = PF
    x = F.col("d")
    got = {n: [_signed(v) for v in _run(e, d=d)] for n, e in [
        ("contains", F.array_contains(x, NAN)),
        ("pos", F.array_position(x, NAN)),
        ("min", F.array_min(x)), ("max", F.array_max(x)),
        ("desc", F.sort_array(x, False)), ("asc", F.sort_array(x))]}
    z, nz = (0.0, 1.0), (-0.0, -1.0)
    assert got["contains"] == [True, False, True, True, None]
    assert got["pos"] == [3, 0, 1, 2, 0]
    assert got["min"] == [z, nz, "nan", (-1.0, -1.0), z]
    assert got["max"] == ["nan", nz, "nan", "nan", z]
    assert got["desc"] == [["nan", (1.0, 1.0), z, nz], [nz, z], ["nan"],
                           ["nan", (2.0, 1.0), (-1.0, -1.0)], [z, nz, None]]
    assert got["asc"] == [[z, nz, (1.0, 1.0), "nan"], [nz, z], ["nan"],
                          [(-1.0, -1.0), (2.0, 1.0), "nan"], [None, z, nz]]


def test_sequence_with_a_null_step_is_null():
    """Spark's sequence is NULL when any argument is; the reference takes
    a NULL step as the default step."""
    t = pa.table({"s": pa.array([1, 1], pa.int64()),
                  "p": pa.array([None, 2], pa.int64())})
    rows = port_rows(t, lambda df, F: df.select(F.sequence(
        F.col("s"), F.lit(5), F.col("p")).alias("r")))
    assert [r["r"] for r in rows] == [None, [1, 3, 5]]


def test_index_zero_raises():
    F = PF
    t = pa.table({"a": pa.array([[1, 2], [3]], pa.list_(pa.int64())),
                  "i": pa.array([1, 0], pa.int32())})
    with pytest.raises(ValueError, match="start at 1"):
        port_rows(t, lambda df, F: df.select(F.element_at(F.col("a"), 0)))
    with pytest.raises(ValueError, match="start at 1"):
        port_rows(t, lambda df, F: df.select(
            F.element_at(F.col("a"), F.col("i"))))
    # a NULL list or a NULL index never raises
    t2 = pa.table({"a": pa.array([None, [3]], pa.list_(pa.int64())),
                   "i": pa.array([0, None], pa.int32())})
    assert port_rows(t2, lambda df, F: df.select(F.element_at(
        F.col("a"), F.col("i")).alias("r"))) == [{"r": None}, {"r": None}]
    with pytest.raises(ValueError, match="length must be greater"):
        port_rows(t, lambda df, F: df.select(F.slice(F.col("a"), 1, -1)))


# ---------------------------------------------------------------------------
# list payloads through operators, layouts and memory
# ---------------------------------------------------------------------------

def _payload_table(n=300, seed=3):
    rng = np.random.RandomState(seed)
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "g": pa.array(rng.randint(0, 40, n).astype(np.int64)),
        "v": pa.array(rng.randn(n)),
        "a": pa.array(ragged(n, 16, "double", seed), pa.list_(pa.float64())),
        "q": pa.array(ragged(n, 4, "bigint", seed + 7),
                      pa.list_(pa.int64()))})


@pytest.mark.parametrize("broadcast", [True, False])
def test_list_payload_through_filter_join_and_out_of_core_sort(broadcast):
    """The join broadcasts the small side, or (threshold -1) coalesces
    both sides' batches, list payloads of different widths included."""
    conf = SMALL if broadcast else {
        **SMALL, "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    t = _payload_table()
    dim = pa.table({"g": pa.array(np.arange(0, 40, 2, dtype=np.int64)),
                    "w": pa.array(np.arange(20, dtype=np.int64)),
                    "b": pa.array(ragged(20, 4, "bigint", 8),
                                  pa.list_(pa.int64()))})

    def q(df, F, other):
        j = other.join(df.filter(F.col("v") > F.lit(-0.5)), on="g",
                       how="inner")
        return j.order_by(F.col("v").desc(), F.col("id")) \
            .select("id", "a", "q", "w", "b", F.size(F.col("a")).alias("n"))
    out = []
    for s, F in ((TpuSession(conf), RF),
                 (TorchSession(conf, device="cpu"), PF)):
        got = q(s.create_dataframe(t), F, s.create_dataframe(dim)) \
            .collect_arrow()
        out.append({n: norm(got.column(n).to_pylist())
                    for n in got.column_names})
        last = s
    assert out[1] == out[0]
    assert len(out[1]["id"]) > 100
    execs = list(_execs(last.last_plan))
    joins = [type(e).__name__ for e in execs]
    assert ("TpuBroadcastHashJoinExec" in joins) == broadcast, joins
    sort = next(e for e in execs if type(e).__name__ == "TpuSortExec")
    assert sort.last_buckets >= 2           # the sort ran out of core


def _execs(node):
    yield node
    for c in node.children:
        yield from _execs(c)


def test_batches_of_different_widths_concatenate():
    """Two partitions, one holding lists of at most 3 elements (W = 4),
    the other of 16 (W = 16), meet in a global sort's concatenation and
    in ``concat_batches``; both give the rows back."""
    short = [[1, 2], None, [3, None, 4], []]
    long_ = [list(range(16)), [5], None]
    t = HostTable.from_dict({"id": np.arange(7, dtype=np.int64),
                             "a": short + long_})
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(t, num_partitions=2)
    rows = df.order_by(PF.col("id").desc()).collect()
    assert [r["a"] for r in rows] == (short + long_)[::-1]
    b1 = ColumnarBatch.from_host(t.slice(0, 4), "cpu", 64)
    b2 = ColumnarBatch.from_host(t.slice(4, 3), "cpu", 64)
    assert (b1.columns[1].width, b2.columns[1].width) == (4, 16)
    both_ = concat_batches([b1, b2])
    hl, valid = both_.columns[1].to_numpy(7)
    assert both_.columns[1].width == 16
    assert hl.to_pylist(valid, INT64) == short + long_


def test_spilled_list_batch_comes_back(tmp_path):
    """List batches under a budget of one and a half batches, on the
    device and on the host: the second batch spills the first to the
    host, the third the second, and the host tier's overflow sends the
    first to disk. Each comes back whole: the rectangle, its element
    validity, lengths and element type."""
    batches = [ColumnarBatch.from_host(HostTable.from_dict({
        "a": ragged(50, 16, "double", 9 + i),
        "k": np.arange(50, dtype=np.int64)}), "cpu", 64) for i in range(3)]
    size = max(b.device_size_bytes() for b in batches)
    mm = MemoryManager(int(size * 1.5), int(size * 1.5),
                       str(tmp_path / "spill"))
    held = [SpillableBatch(b, mm) for b in batches]
    try:
        assert [h.tier for h in held] == ["disk", "host", "device"]
        for h, want in zip(held, batches):
            back = h.get().columns[0]
            assert back.dtype == ArrayType(FLOAT64)
            for x, y in ((back.data, want.columns[0].data),
                         (back.elem_valid, want.columns[0].elem_valid),
                         (back.lengths, want.columns[0].lengths),
                         (back.validity, want.columns[0].validity)):
                assert torch.equal(x.nan_to_num(0.0) if x.is_floating_point()
                                   else x, y.nan_to_num(0.0)
                                   if y.is_floating_point() else y)
    finally:
        for h in held:
            h.close()


def test_list_from_numpy_offsets_without_pyarrow():
    """A list column from numpy offsets, values and element validity,
    with pyarrow and pandas made unimportable, as on the card: ingest,
    functions, explode and the three ways back."""
    code = textwrap.dedent("""
        import sys
        sys.modules["pyarrow"] = None
        sys.modules["pandas"] = None
        import numpy as np
        from spark_rapids_tpu_torch.api import TorchSession, functions as F
        from spark_rapids_tpu_torch.columnar import HostList
        hl = HostList(np.array([0, 2, 2, 5, 6]), np.array(
            [1.5, 2.5, 3.0, -1.0, 4.0, 7.0]),
            np.array([True, True, True, False, True, True]))
        valid = np.array([True, False, True, True])
        s = TorchSession(device="cpu")
        df = s.create_dataframe({"a": (hl, valid),
                                 "k": np.arange(4, dtype=np.int64)})
        rows = df.select("k", "a", F.size(F.col("a")).alias("n"),
                         F.array_max(F.col("a")).alias("m")).collect()
        assert [r["a"] for r in rows] == [[1.5, 2.5], None,
                                          [3.0, None, 4.0], [7.0]], rows
        assert [r["n"] for r in rows] == [2, -1, 3, 1], rows
        assert [r["m"] for r in rows] == [2.5, None, 4.0, 7.0], rows
        ex = df.select("k", F.explode(F.col("a"))).collect()
        assert [(r["k"], r["col"]) for r in ex] == [
            (0, 1.5), (0, 2.5), (2, 3.0), (2, None), (2, 4.0), (3, 7.0)]
        off, vals, ev, rv = df.collect_numpy()["a"]
        assert off.tolist() == [0, 2, 2, 5, 6]
        assert vals[ev].tolist() == [1.5, 2.5, 3.0, 4.0, 7.0]
        assert rv.tolist() == [True, False, True, True]
        assert "pyarrow" not in [m for m, v in sys.modules.items()
                                 if v is not None]
        print("ok")
    """)
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(root), "PATH": "/usr/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_list_past_the_width_cap_is_refused_at_ingest():
    hl = HostList(np.array([0, 300]), np.arange(300, dtype=np.int64))
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        to_device_list(hl, np.array([True]), ArrayType(INT64), "cpu")


# ---------------------------------------------------------------------------
# refusals: what now waits for "slice 9b, the rest", and the old sites
# ---------------------------------------------------------------------------

def _map_col(a, k):
    """A map of list values: maps of numbers and strings run since slice
    9b's rest, first part; lists inside maps wait for its next part."""
    return PE.CreateMap(k, a)


def _lists(a):
    """A list of lists: no device layout until the next part of slice
    9b's rest (strings inside lists run since its first part)."""
    return PE.CreateArray(a)


REFUSED = {
    "GetMapValue": lambda a, k: PE.GetMapValue(_map_col(a, k), Literal(1)),
    "GetStructField": lambda a, k: PE.GetStructField(
        PE.CreateNamedStruct(Literal("f"), _lists(a)), "f"),
    "MapKeys": lambda a, k: PE.MapKeys(_map_col(a, k)),
    "MapValues": lambda a, k: PE.MapValues(_map_col(a, k)),
    "MapEntries": lambda a, k: PE.MapEntries(_map_col(a, k)),
    "MapConcat": lambda a, k: PE.MapConcat(_map_col(a, k), _map_col(a, k)),
    "MapFromArrays": lambda a, k: PE.MapFromArrays(_lists(a), a),
    "CreateMap": lambda a, k: _map_col(a, k),
    "CreateNamedStruct": lambda a, k: PE.CreateNamedStruct(Literal("f"),
                                                           _lists(a)),
    "TransformValues": lambda a, k: PE.TransformValues(
        _map_col(a, k), [PE.NamedLambdaVariable("k"),
                         PE.NamedLambdaVariable("v")], Literal(1)),
    "ArrayJoin": lambda a, k: PE.ArrayJoin(_lists(a), Literal(",")),
    "ArrayRepeat": lambda a, k: PE.ArrayRepeat(a, Literal(2)),
    "ArraysZip": lambda a, k: PE.ArraysZip(_lists(a), a),
    "Concat": lambda a, k: PE.Concat(_lists(a), _lists(a)),
    "Flatten": lambda a, k: PE.Flatten(PE.CreateArray(a)),
    "ArrayDistinct": lambda a, k: PE.ArrayDistinct(_lists(a)),
    "ArrayUnion": lambda a, k: PE.ArrayUnion(_lists(a), _lists(a)),
    "ArrayIntersect": lambda a, k: PE.ArrayIntersect(_lists(a), _lists(a)),
    "ArrayExcept": lambda a, k: PE.ArrayExcept(_lists(a), _lists(a)),
    "ArrayRemove": lambda a, k: PE.ArrayRemove(_lists(a), a),
    "ArraysOverlap": lambda a, k: PE.ArraysOverlap(_lists(a), _lists(a)),
    "GetJsonObject": lambda a, k: PE.GetJsonObject(Literal("{}"),
                                                   Literal("$.x")),
    "MonthsBetween": lambda a, k: PE.MonthsBetween(Literal(
        np.datetime64("2024-01-01")), Literal(np.datetime64("2023-01-01"))),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_constructs_name_the_rest_of_slice_9b(name):
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({
        "a": pa.array([[1, 2]], pa.list_(pa.int64())),
        "k": pa.array([3], pa.int64())}))
    e = REFUSED[name](ColumnRef("a"), ColumnRef("k"))
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.Col(e).alias("r")).collect()


@pytest.mark.parametrize("agg", [CollectList, CollectSet])
def test_collect_aggregates_are_refused(agg):
    """collect_list/collect_set run since slice 9b's map and struct half
    (tests/test_torch_collect.py), of strings since its rest's first part
    (tests/test_torch_string_lists.py); a list of lists still waits."""
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({
        "k": pa.array([1, 1], pa.int64()),
        "s": pa.array([[1], [2]], pa.list_(pa.int64()))}))
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.group_by("k").agg(agg(ColumnRef("s")).with_name("c")).collect()


def test_refusal_sites_name_their_items(tmp_path):
    s = TorchSession(OFF, device="cpu")
    t = pa.table({"a": pa.array([[1, 2], None], pa.list_(pa.int64())),
                  "k": pa.array([1, 2], pa.int64())})
    df = s.create_dataframe(t)
    # nested Parquet columns (io/parquet_meta.py)
    path = str(tmp_path / "nested.parquet")
    pq.write_table(t, path)
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        s.read_parquet(path).collect()
    # rand in a sort key (plan/overrides.py)
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.order_by(PF.rand(1)).collect()
    # a list payload in a window (plan/overrides.py WindowMeta)
    with pytest.raises(NotImplementedError,
                       match="a later windows slice"):
        df.with_window_column("w", PF.sum(PF.col("k")),
                              order_by=["k"]).collect()
    # a list as a key
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.group_by("a").agg(PF.count_star().with_name("n")).collect()
    # months_between (exprs/datetime_fns.py), a map to explode
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.explode(PF.Col(_map_col(ColumnRef("a"),
                                             ColumnRef("k"))))).collect()
    # intersect_all / except_all (api/dataframe.py) and their SQL
    # (sql/lowering.py) now run
    df.create_or_replace_temp_view("t")
    assert s.sql("SELECT k FROM t INTERSECT ALL SELECT k FROM t") \
        .collect() != []
    assert s.sql("SELECT k FROM t EXCEPT ALL SELECT k FROM t") \
        .collect() == []
