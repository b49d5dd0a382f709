"""``split``, ``str_to_map`` and the array functions the reference runs on
its host engine, on the port against the JAX package, on the CPU.

* ``split`` of a literal pattern (one character, several, an escaped
  metacharacter) with Java's ``limit`` (-1, 0, 2) over dictionary and
  byte-rectangle strings, leading, trailing and repeated delimiters,
  empty strings and NULLs; a regex pattern is refused naming the
  strings slice.
* ``str_to_map`` with the default and other delimiters, parts without a
  key-value delimiter and NULL texts.
* ``array_join`` (with and without a NULL replacement), ``array_repeat``,
  ``arrays_zip``, ``concat_arrays``, ``array_distinct``, ``array_union``,
  ``array_intersect``, ``array_except``, ``array_remove`` and
  ``arrays_overlap`` over bigints, doubles, dates and strings in both
  forms; the empty ``array()``, ``map()`` and ``struct()``; all on both
  packages over one Arrow table, values compared exactly.
* The reference's own battery (tests/test_collections.py: ``array_join``,
  ``array_repeat``, ``concat_arrays``/``flatten``, the set operations,
  ``array_remove``/``arrays_overlap``, ``arrays_zip``, ``str_to_map``)
  on the port, equal to its answers; ``flatten`` refused naming the
  queue.
* Where the port follows Spark and the reference does not (ROADMAP.md
  Queue C): NaN equal to NaN in ``array_distinct`` and the set
  operations; a repeated key in ``str_to_map`` raises; ``array_join``
  of a non-string list is refused (the reference joins ``str(v)``).
* A result past ``rect.maxBytes`` raises at its batch; a list past 256
  elements from ``array_repeat`` raises, naming the queue.
"""
import datetime
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF

from test_torch_slice import prebuild_reference_native
from torch_compare import run_both, sessions

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
SMALL = {**OFF, "spark.rapids.tpu.sql.batchSizeRows": 64}
FORMS = ["dict", "rect"]


def setup_module(_):
    prebuild_reference_native()


def _text(rng, form: str, delims: str) -> str:
    if form == "dict":
        return ["a b", " a", "b  ", "", "x|y|", "aab"][rng.randint(6)]
    parts = [f"w{rng.randint(1000)}" for _ in range(rng.randint(0, 6))]
    return "".join(p + delims[rng.randint(len(delims))] for p in parts) \
        + ("" if rng.rand() < 0.5 else " ")


def text_table(form: str, n: int = 150, seed: int = 3) -> pa.Table:
    rng = np.random.RandomState(seed)
    return pa.table({"s": pa.array([
        None if i % 9 == 4 else _text(rng, form, " |ab")
        for i in range(n)])})


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("limit", [-1, 0, 2])
@pytest.mark.parametrize("pattern", [" ", "ab", "\\|"])
def test_split_equals_the_reference(pattern, limit, form):
    t = text_table(form)
    ref, port = run_both(t, lambda df, F, E: df.select(
        F.split(F.col("s"), pattern, limit).alias("w")), conf=SMALL)
    want = ref.to_pylist()
    if limit == 0:
        # Java gives [""] for "" (test_split_of_empty_with_limit_0)
        want = [{"w": [""]} if s == "" else w
                for s, w in zip(t.column("s").to_pylist(), want)]
    assert port.to_pylist() == want


def test_split_of_empty_with_limit_0_follows_java():
    """Spark's split is Java's ``String.split``: with limit 0 a string
    with no match is its one part, so ``split('', ' ', 0)`` is [""]; the
    reference drops the trailing empty part and gives []."""
    t = pa.table({"s": pa.array(["", "a ", "  "])})
    ref, port = run_both(t, lambda df, F, E: df.select(
        F.split(F.col("s"), " ", 0).alias("w")))
    assert port.column("w").to_pylist() == [[""], ["a"], []]
    assert ref.column("w").to_pylist() == [[], ["a"], []]


def test_split_of_a_regex_is_refused():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(text_table("dict"))
    for pattern in ("a+", "[ab]", "\\s"):
        with pytest.raises(NotImplementedError, match="slice 7"):
            df.select(PF.split(PF.col("s"), pattern).alias("w")).collect()


def map_text_table(n: int = 120, seed: int = 4) -> pa.Table:
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        keys = [f"k{j}" for j in rng.permutation(6)[:rng.randint(0, 4)]]
        pairs = [k if rng.rand() < 0.2 else f"{k}:{rng.randint(99)}"
                 for k in keys]
        rows.append(None if i % 10 == 3 else ",".join(pairs))
    return pa.table({"s": pa.array(rows),
                     "t": pa.array([None if r is None else
                                    r.replace(",", "&").replace(":", "=")
                                    for r in rows])})


def test_str_to_map_equals_the_reference():
    ref, port = run_both(map_text_table(), lambda df, F, E: df.select(
        F.str_to_map(F.col("s")).alias("a"),
        F.str_to_map(F.col("t"), "&", "=").alias("b"),
        F.element_at(F.str_to_map(F.col("s")), "k1").alias("c")),
        conf=SMALL)
    assert port.to_pylist() == ref.to_pylist()


# ---------------------------------------------------------------------------
# the ten host-engine array functions
# ---------------------------------------------------------------------------

def _values(rng, kind: str, form: str, k: int):
    if kind == "bigint":
        return [int(x) for x in rng.randint(-3, 4, k)]
    if kind == "double":
        return [float(x) for x in rng.randint(-3, 4, k) / 2.0]
    if kind == "date":
        return [datetime.date(2020, 1, 1) + datetime.timedelta(int(x))
                for x in rng.randint(0, 5, k)]
    if form == "dict":
        return [["a", "bb", "", "c d"][x] for x in rng.randint(0, 4, k)]
    return [f"v{x}-{rng.randint(3)}" for x in rng.randint(0, 1000, k)]


PA_TYPES = {"bigint": pa.int64(), "double": pa.float64(),
            "date": pa.date32(), "string": pa.string()}


def list_table(kind: str, form: str = "dict", n: int = 120,
               seed: int = 6) -> pa.Table:
    rng = np.random.RandomState(seed)

    def lists():
        out = []
        for i in range(n):
            vals = _values(rng, kind, form, rng.randint(0, 6))
            vals = [None if rng.rand() < 0.15 else v for v in vals]
            out.append(None if i % 8 == 5 else vals)
        return out
    return pa.table({
        "a": pa.array(lists(), pa.list_(PA_TYPES[kind])),
        "b": pa.array(lists(), pa.list_(PA_TYPES[kind])),
        "c": pa.array(lists(), pa.list_(PA_TYPES[kind])),
        "x": pa.array([None if i % 7 == 2 else v for i, v in
                       enumerate(_values(rng, kind, form, n))],
                      PA_TYPES[kind]),
        "n": pa.array([None if i % 11 == 6 else int(v) for i, v in
                       enumerate(rng.randint(-1, 5, n))], pa.int32()),
    })


def _abc(F):
    return F.col("a"), F.col("b"), F.col("c")


FNS = {
    "array_repeat": lambda F: [F.array_repeat(F.col("x"), F.col("n")),
                               F.array_repeat(F.col("x"), 2)],
    "arrays_zip": lambda F: [F.arrays_zip(F.col("a"), F.col("b")),
                             F.arrays_zip(*_abc(F))],
    "concat_arrays": lambda F: [F.concat_arrays(F.col("a"), F.col("b")),
                                F.concat_arrays(*_abc(F))],
    "array_distinct": lambda F: [F.array_distinct(F.col("a"))],
    "array_union": lambda F: [F.array_union(F.col("a"), F.col("b"))],
    "array_intersect": lambda F: [F.array_intersect(F.col("a"),
                                                    F.col("b"))],
    "array_except": lambda F: [F.array_except(F.col("a"), F.col("b"))],
    "array_remove": lambda F: [F.array_remove(F.col("a"), F.col("x"))],
    "arrays_overlap": lambda F: [F.arrays_overlap(F.col("a"), F.col("b"))],
}
CASES = [(fn, kind, "dict") for fn in sorted(FNS)
         for kind in ("bigint", "double", "date", "string")] + \
    [(fn, "string", "rect") for fn in sorted(FNS)]


@pytest.mark.parametrize("fn,kind,form", CASES)
def test_array_functions_equal_the_reference(fn, kind, form):
    t = list_table(kind, form)
    ref, port = run_both(t, lambda df, F, E: df.select(
        *[c.alias(f"r{i}") for i, c in enumerate(FNS[fn](F))]), conf=SMALL)
    assert port.to_pylist() == ref.to_pylist()


@pytest.mark.parametrize("form", FORMS)
def test_array_join_equals_the_reference(form):
    t = list_table("string", form)
    ref, port = run_both(t, lambda df, F, E: df.select(
        F.array_join(F.col("a"), ",").alias("j"),
        F.array_join(F.col("b"), "--", "NULL").alias("k"),
        F.array_join(F.col("c"), "").alias("m")), conf=SMALL)
    assert port.to_pylist() == ref.to_pylist()


def test_empty_array_map_and_struct():
    """``array()`` as the reference gives it; ``map()`` and ``struct()``,
    which the reference cannot type, as Spark gives them."""
    t = pa.table({"x": pa.array([1, None, 3], pa.int64())})
    ref, port = run_both(t, lambda df, F, E: df.select(
        F.size(F.array()).alias("n"), F.array().alias("a")))
    assert port.to_pylist() == ref.to_pylist()
    s = TorchSession(device="cpu")
    got = s.create_dataframe(t).select(PF.array().alias("a"),
                                       PF.create_map().alias("m"),
                                       PF.struct().alias("s")).collect()
    assert got == [{"a": [], "m": [], "s": {}}] * 3


# ---------------------------------------------------------------------------
# the reference's battery (tests/test_collections.py) on the port
# ---------------------------------------------------------------------------

BATTERY_A = [[1, 2, 3], [], None, [4, None, 6], [7], [None]]


def _run(expr, **cols):
    """The port's values of ``expr`` over columns given as Python lists
    (the reference battery's ``_run``)."""
    data = {"a": pa.array(BATTERY_A, pa.list_(pa.int64()))}
    for k, v in cols.items():
        data[k] = v if isinstance(v, pa.Array) else pa.array(v)
    n = max(len(v) for v in data.values())
    data = {k: v if len(v) == n else v.slice(0, n) if len(v) > n
            else pa.concat_arrays([v, pa.nulls(n - len(v), v.type)])
            for k, v in data.items()}
    s = TorchSession(OFF, device="cpu")
    out = s.create_dataframe(pa.table(data)).select(expr.alias("r"))
    return [r["r"] for r in out.collect()]


def test_battery_array_join():
    sa = [["1", "2", "3"], [], None, ["4", None, "6"], ["7"], [None]]
    assert _run(PF.array_join(PF.col("sa"), ","), sa=sa) == \
        ["1,2,3", "", None, "4,6", "7", ""]
    assert _run(PF.array_join(PF.col("sa"), ",", "NULL"), sa=sa) == \
        ["1,2,3", "", None, "4,NULL,6", "7", "NULL"]


def test_battery_array_repeat():
    assert _run(PF.array_repeat(PF.lit(7), PF.lit(3))) == [[7, 7, 7]] * 6
    assert _run(PF.array_repeat(PF.lit(7), PF.lit(-1))) == [[]] * 6


def test_battery_concat_arrays_and_flatten():
    assert _run(PF.concat_arrays(PF.col("a"), PF.col("a"))) == \
        [[1, 2, 3, 1, 2, 3], [], None, [4, None, 6, 4, None, 6], [7, 7],
         [None, None]]
    nested = pa.array([[[1, 2], [3]], [[], [4]], None, [[5], None]],
                      pa.list_(pa.list_(pa.int64())))
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        _run(PF.flatten(PF.col("n")), n=nested)


def test_battery_array_set_ops():
    a = pa.array([[1, 2, 2, None], [1, 2], None, []], pa.list_(pa.int64()))
    b = pa.array([[2, 3], None, [1], [None]], pa.list_(pa.int64()))
    got = {name: _run(fn(PF.col("x"), PF.col("y")), x=a, y=b)[:4]
           for name, fn in (("union", PF.array_union),
                            ("intersect", PF.array_intersect),
                            ("except", PF.array_except))}
    assert _run(PF.array_distinct(PF.col("x")), x=a)[:4] == \
        [[1, 2, None], [1, 2], None, []]
    assert got == {"union": [[1, 2, None, 3], None, None, [None]],
                   "intersect": [[2], None, None, []],
                   "except": [[1, None], None, None, []]}


def test_battery_array_remove_overlap_reverse():
    assert _run(PF.array_remove(PF.col("a"), PF.lit(2))) == \
        [[1, 3], [], None, [4, None, 6], [7], [None]]
    a = pa.array([[1, 2], [1, None], [1], None], pa.list_(pa.int64()))
    b = pa.array([[2, 3], [3], [2], [1]], pa.list_(pa.int64()))
    assert _run(PF.arrays_overlap(PF.col("x"), PF.col("y")), x=a,
                y=b)[:4] == [True, None, False, None]
    assert _run(PF.array_reverse(PF.col("a"))) == \
        [[3, 2, 1], [], None, [6, None, 4], [7], [None]]


def test_battery_arrays_zip():
    a = pa.array([[1, 2], [3]], pa.list_(pa.int64()))
    b = pa.array([[10], [20, 30]], pa.list_(pa.int64()))
    got = _run(PF.arrays_zip(PF.col("x"), PF.col("y")), x=a, y=b)[:2]
    assert got == [[{"x": 1, "y": 10}, {"x": 2, "y": None}],
                   [{"x": 3, "y": 20}, {"x": None, "y": 30}]]


def test_battery_map_from_arrays_and_str_to_map():
    got = _run(PF.map_from_arrays(PF.array(PF.lit("x"), PF.lit("y")),
                                  PF.array(PF.lit(1), PF.lit(2))))
    assert got[0] == [("x", 1), ("y", 2)]
    got = _run(PF.str_to_map(PF.lit("a:1,b:2")))
    assert got[0] == [("a", "1"), ("b", "2")]


# ---------------------------------------------------------------------------
# departures toward Spark (ROADMAP.md Queue C)
# ---------------------------------------------------------------------------

NAN = float("nan")


def _nan_key(v):
    return "nan" if isinstance(v, float) and math.isnan(v) else v


@pytest.mark.parametrize("fn", ["array_distinct", "array_union",
                                "array_intersect", "array_except"])
def test_set_operations_take_nan_as_equal_to_nan(fn):
    """Spark's array_distinct and set operations take NaN as equal to
    NaN; the reference compares with ``==``, so it keeps every NaN."""
    t = pa.table({"a": pa.array([[NAN, 1.0, NAN, 2.0]],
                                pa.list_(pa.float64())),
                  "b": pa.array([[NAN, 3.0]], pa.list_(pa.float64()))})
    spark = {"array_distinct": [NAN, 1.0, 2.0],
             "array_union": [NAN, 1.0, 2.0, 3.0],
             "array_intersect": [NAN],
             "array_except": [1.0, 2.0]}[fn]

    def build(df, F, E):
        f = getattr(F, fn)
        return df.select((f(F.col("a")) if fn == "array_distinct"
                          else f(F.col("a"), F.col("b"))).alias("r"))
    ref, port = run_both(t, build)
    got = port.column("r").to_pylist()[0]
    assert list(map(_nan_key, got)) == list(map(_nan_key, spark))
    assert list(map(_nan_key, ref.column("r").to_pylist()[0])) != \
        list(map(_nan_key, spark))


def test_str_to_map_of_a_repeated_key_raises():
    """Spark's mapKeyDedupPolicy EXCEPTION (its default) raises on a key
    twice; the reference keeps the last value."""
    t = pa.table({"s": pa.array(["a:1,a:2"])})
    ref_s, port_s = sessions()
    assert ref_s.create_dataframe(t).select(
        __import__("spark_rapids_tpu.api", fromlist=["functions"])
        .functions.str_to_map(
            __import__("spark_rapids_tpu.api", fromlist=["functions"])
            .functions.col("s")).alias("m")).collect() == \
        [{"m": [("a", "2")]}]
    with pytest.raises(ValueError, match="Duplicate map key"):
        port_s.create_dataframe(t).select(
            PF.str_to_map(PF.col("s")).alias("m")).collect()


def test_array_join_of_numbers_is_refused():
    """Spark's array_join takes array<string>; the reference joins
    ``str(v)`` of any element. A cast to string arrives with the
    strings slice."""
    t = pa.table({"a": pa.array([[1, 2]], pa.list_(pa.int64()))})
    ref_s, port_s = sessions()
    from spark_rapids_tpu.api import functions as RF
    assert ref_s.create_dataframe(t).select(
        RF.array_join(RF.col("a"), ",").alias("j")).collect() == \
        [{"j": "1,2"}]
    with pytest.raises(NotImplementedError, match="slice 7"):
        port_s.create_dataframe(t).select(
            PF.array_join(PF.col("a"), ",").alias("j")).collect()


def test_results_past_the_caps_raise():
    s = TorchSession(device="cpu")
    words = pa.array([[f"{i:02d}" + "x" * 30 for i in range(4)]] * 8,
                     pa.list_(pa.string()))
    df = s.create_dataframe(pa.table({"w": words, "n": pa.array(
        [300] + [1] * 7, pa.int32())}))
    with pytest.raises(NotImplementedError, match="maxBytes.*slice 7"):
        df.select(PF.array_join(PF.col("w"), ",").alias("j")).collect()
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.array_repeat(PF.lit(1), PF.col("n")).alias("r")) \
            .collect()
