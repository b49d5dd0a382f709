"""The port's Generate exec against the JAX package, on the CPU:
``explode``, ``explode_outer``, ``posexplode``, ``posexplode_outer`` over
list columns (NULL rows, NULL elements, empty lists, widths 4 and 16,
64-row batches) and over computed lists, ``stack`` over primitive
columns, ``explode(sequence(...))`` planned from the counts alone, an
alias, expressions over the pass-through columns, a group-by over the
exploded position, the reference's battery (tests/test_generate.py, the
list and ``stack`` cases), an all-empty input, and the split-and-retry
ladder halving a batch whose output does not fit. Outputs compare row
for row, exactly.
"""
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF

from test_torch_collections import OFF, both, port_rows, table
from test_torch_slice import prebuild_reference_native

ROWS64 = {"spark.rapids.tpu.sql.batchSizeRows": 64}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


GENERATORS = {
    "explode": lambda F: F.explode(F.col("a")),
    "explode_outer": lambda F: F.explode_outer(F.col("a")),
    "posexplode": lambda F: F.posexplode(F.col("a")),
    "posexplode_outer": lambda F: F.posexplode_outer(F.col("a")),
    "explode_sorted": lambda F: F.explode(F.col("s")),
    "explode_filtered": lambda F: F.explode_outer(
        F.filter(F.col("a"), lambda x: x > F.lit(0))),
}


@pytest.mark.parametrize("width", [4, 16])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_generators_equal_reference(gen, width):
    """``s`` is the lists sorted descending by a projection below: the
    reference sorts there on its device path (its host engine's
    ``sorted`` misplaces NaN, which Spark ranks greatest). ``posexplode``
    runs over bigints: the reference's casts a list's elements to int
    (``test_posexplode_of_doubles_follows_spark``)."""
    kind = "bigint" if gen.startswith("pos") else "double"
    t = table(n=150, width=width, kind=kind, seed=40 + width)
    want, got = both(t, lambda df, F: df.select(
        "k", "a", F.sort_array(F.col("a"), False).alias("s")).select(
        "k", GENERATORS[gen](F), (F.col("k") * 2).alias("k2")), ROWS64)
    assert got == want
    assert len(got["k"]) > 150


def test_stack_and_alias_equal_reference():
    t = table(n=40, seed=3)
    want, got = both(t, lambda df, F: df.select(
        F.stack(3, F.col("k"), F.col("k") * 10, F.col("k") + 1,
                F.col("k") - 1, F.lit(None), F.col("k") * 3)), ROWS64)
    assert got == want
    want, got = both(t, lambda df, F: df.select(
        F.explode(F.col("a")).alias("v"), "k"))
    assert got == want and list(got) == ["v", "k"]


def test_explode_of_a_sequence_equals_reference():
    t = pa.table({"s": pa.array([1, 4, None, 2, 7], pa.int64()),
                  "e": pa.array([3, 1, 5, 2, 7], pa.int64())})
    want, got = both(t, lambda df, F: df.select(
        "s", F.posexplode(F.sequence(F.col("s"), F.col("e")))))
    assert got == want
    want, got = both(t, lambda df, F: df.select(
        F.explode_outer(F.sequence(F.lit(10), F.col("e"), F.lit(-4)))
        .alias("v")))
    assert got == want


def test_group_by_exploded_position_equals_reference():
    t = table(n=200, width=16, kind="bigint", seed=11)

    def q(df, F):
        return df.select(F.posexplode(F.col("a"))) \
            .group_by("pos").agg(F.count(F.col("col")).with_name("n"),
                                 F.count_star().with_name("rows")) \
            .order_by("pos")
    want, got = both(t, q, ROWS64)
    assert got == want
    # the position's cardinality is the scan's longest list, which each
    # host list keeps: the dense route (dense_groupby on the card)
    s = TorchSession({**OFF, **ROWS64}, device="cpu")
    df = s.create_dataframe(t)
    assert "route=dense" in q(df, PF)._physical().tree_string()
    lists = [p.columns["a"][0] for p in df.plan.tables]
    assert [hl._longest for hl in lists] \
        == [max(len(r) for r in t.column("a").to_pylist() if r)]
    # a list computed in the query has no kept longest: the sort route
    computed = df.select(PF.transform(PF.col("a"), lambda x: x).alias("a"))
    plan = q(computed, PF)._physical().tree_string()
    assert "HashAggregate" in plan and "route=dense" not in plan


def test_reference_battery():
    """tests/test_generate.py's list and stack cases, on the port."""
    arrs = [[1, 2, 3], [], None, [4, None, 6]]
    t = pa.table({"id": [10, 20, 30, 40], "a": arrs})
    F = PF

    def run(*cols):
        rows = port_rows(t, lambda df, F: df.select(*cols))
        return {k: [r[k] for r in rows] for k in (rows[0] if rows else {})}
    got = run("id", F.explode(F.col("a")))
    assert got == {"id": [10, 10, 10, 40, 40, 40],
                   "col": [1, 2, 3, 4, None, 6]}
    got = run("id", F.explode_outer(F.col("a")))
    assert got["id"] == [10, 10, 10, 20, 30, 40, 40, 40]
    assert got["col"] == [1, 2, 3, None, None, 4, None, 6]
    assert run(F.explode(F.col("a")).alias("v")) == \
        {"v": [1, 2, 3, 4, None, 6]}
    got = run("id", F.posexplode(F.col("a")))
    assert list(got) == ["id", "pos", "col"]
    assert got["pos"] == [0, 1, 2, 0, 1, 2]
    assert run(F.posexplode_outer(F.col("a")))["pos"] == \
        [0, 1, 2, None, None, 0, 1, 2]
    assert run((F.col("id") * 2).alias("i2"), F.explode(F.col("a")))["i2"] \
        == [20, 20, 20, 80, 80, 80]
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({"a": [1, 2], "b": [10, 20]}))
    assert [r["col0"] for r in df.select(F.stack(2, F.col("a"), F.col("b")))
            .collect()] == [1, 10, 2, 20]
    df = s.create_dataframe(pa.table({"a": [1], "b": [2], "c": [3]}))
    rows = df.select(F.stack(2, F.col("a"), F.col("b"), F.col("c"))) \
        .collect()
    assert rows == [{"col0": 1, "col1": 2}, {"col0": 3, "col1": None}]


def test_posexplode_of_doubles_follows_spark():
    """Spark's posexplode gives each element beside its position. The
    reference's fills its position column with the elements
    (``Explode.generate`` pairs each 1-tuple with the first output field),
    so its ``col`` is the elements cast to int: doubles raise there."""
    t = pa.table({"a": pa.array([[1.5, None], None, [-0.0, 2.5, 1e300]],
                                pa.list_(pa.float64()))})
    rows = port_rows(t, lambda df, F: df.select(F.posexplode(F.col("a"))))
    assert [(r["pos"], r["col"]) for r in rows] == [
        (0, 1.5), (1, None), (0, -0.0), (1, 2.5), (2, 1e300)]


def test_explode_of_an_all_empty_input():
    t = pa.table({"id": pa.array([1, 2], pa.int64()),
                  "a": pa.array([None, []], pa.list_(pa.int64()))})
    want, got = both(t, lambda df, F: df.select("id", F.explode(F.col("a"))))
    assert got == want == {"id": [], "col": []}
    want, got = both(t, lambda df, F: df.select(
        "id", F.posexplode_outer(F.col("a"))))
    assert got == want and got["id"] == [1, 2]


def test_generate_splits_its_input_when_the_output_does_not_fit():
    t = table(n=120, width=16, kind="bigint", seed=5)
    s = TorchSession(OFF, device="cpu")
    want = s.create_dataframe(t).select("k", PF.explode(PF.col("a"))) \
        .collect()
    # the first reserve is the input's (its SpillableBatch), the second
    # the output's
    s.memory.force_split_and_retry_oom(1, skip=1)
    try:
        got = s.create_dataframe(t).select("k", PF.explode(PF.col("a"))) \
            .collect()
    finally:
        s.memory.clear_injections()
    assert got == want
    assert s.last_retry_stats.splits == 1


def test_explode_requires_one_generator_and_one_alias():
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(table(n=4))
    with pytest.raises(ValueError, match="only one generator"):
        df.select(PF.explode(PF.col("a")), PF.explode(PF.col("b")))
    with pytest.raises(ValueError, match="single alias"):
        df.select(PF.posexplode(PF.col("a")).alias("v"))
