"""The port's higher-order functions against the JAX package, on the CPU:
``transform`` (with and without the index), ``filter`` (with the index),
``exists``/``forall`` (three-valued), ``zip_with`` (the shorter list
padded with NULLs) and ``aggregate`` (with and without a finish), over
seeded ragged lists with NULL rows, NULL elements, empty lists, NaN and
-0.0, at widths 4 and 16; nested higher-order functions with an outer
reference (a column and an enclosing lambda's variable).

The reference runs these on its host engine, element by element; the
port evaluates each lambda once over the rectangle's slots. Results
compare exactly: ``aggregate`` folds each row's elements in the same
order as the reference, so even its float sums are bit-equal.

Departures toward Spark (ROADMAP.md Queue C): ``aggregate`` whose merge
gives another type than its zero raises, as Spark's analyzer does; the
reference answers in the zero's type. The map forms over a map of list
values are refused naming "slice 9b, the rest".
"""
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exprs.base import ColumnRef, Literal

from test_torch_collections import OFF, both, port_rows, table
from test_torch_slice import prebuild_reference_native


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _hofs(F, kind):
    a, b, k = F.col("a"), F.col("b"), F.col("k")
    one = F.lit(1.0) if kind == "double" else F.lit(1)
    zero = F.lit(0.0) if kind == "double" else F.lit(0).cast("bigint")
    return [
        F.transform(a, lambda x: x * 2 + one).alias("t"),
        F.transform(a, lambda x, i: x + i).alias("ti"),
        F.transform(a, lambda x: x + k).alias("tk"),
        F.filter(a, lambda x: x > one).alias("f"),
        F.filter(a, lambda x, i: i > 0).alias("fi"),
        F.exists(a, lambda x: x > one).alias("e"),
        F.forall(a, lambda x: x > F.lit(-3)).alias("fa"),
        F.zip_with(a, b, lambda x, y: x - y).alias("z"),
        F.aggregate(a, zero, lambda acc, x: acc + x).alias("s"),
        F.aggregate(a, zero, lambda acc, x: acc * F.lit(2) + x,
                    lambda acc: acc + one).alias("sf"),
        F.size(F.filter(F.transform(a, lambda x: x * 2),
                        lambda y: y > k)).alias("chain"),
    ]


@pytest.mark.parametrize("kind", ["bigint", "double"])
@pytest.mark.parametrize("width", [4, 16])
def test_higher_order_functions_equal_reference(kind, width):
    t = table(width=width, kind=kind, seed=20 + width)
    want, got = both(t, lambda df, F: df.select(*_hofs(F, kind)))
    for name in want:
        assert got[name] == want[name], name


def test_nested_higher_order_with_outer_references():
    """An inner lambda reading the enclosing lambda's variable and an
    outer column, and an inner fold over another list column."""
    t = table(width=4, kind="bigint", seed=7)

    def build(df, F):
        z = F.lit(0).cast("bigint")
        return df.select(
            F.transform(F.col("a"), lambda x: F.aggregate(
                F.col("b"), z, lambda acc, y: acc + y * x + F.col("k")))
            .alias("n1"),
            F.transform(F.col("a"), lambda x: F.exists(
                F.col("b"), lambda y: y == x)).alias("n2"))
    want, got = both(t, build)
    assert got == want


def test_reference_battery():
    """tests/test_collections.py's higher-order cases, on the port."""
    F = PF
    arrs = [[1, 2, 3], [], None, [4, None, 6], [7], [None]]

    def run(col, **cols):
        cols = cols or {"a": arrs}
        return [r["r"] for r in port_rows(pa.table(cols), lambda df, F:
                                          df.select(col.alias("r")))]
    a = F.col("a")
    assert run(F.transform(a, lambda x: x * 2)) == \
        [[2, 4, 6], [], None, [8, None, 12], [14], [None]]
    assert run(F.transform(a, lambda x, i: i)) == \
        [[0, 1, 2], [], None, [0, 1, 2], [0], [0]]
    assert run(F.transform(a, lambda x: x + F.col("k")),
               a=[[1, 2], [3]], k=[10, 20]) == [[11, 12], [23]]
    assert run(F.filter(a, lambda x: x > 2)) == \
        [[3], [], None, [4, 6], [7], []]
    assert run(F.exists(a, lambda x: x > 5)) == \
        [False, False, None, True, True, None]
    assert run(F.forall(a, lambda x: x > 0)) == \
        [True, True, None, None, True, None]
    assert run(F.aggregate(a, F.lit(0).cast("bigint"),
                           lambda acc, x: acc + x),
               a=[[1, 2, 3], [], None, [4, 6]]) == [6, 0, None, 10]
    assert run(F.aggregate(a, F.lit(0).cast("bigint"),
                           lambda acc, x: acc + x, lambda acc: acc * 10),
               a=[[1, 2, 3], []]) == [60, 0]
    assert run(F.zip_with(a, F.col("b"), lambda x, y: x + y),
               a=[[1, 2], [3]], b=[[10, 20], [30, 40]]) == \
        [[11, 22], [33, None]]
    assert run(F.filter(a, lambda x, i: i > 0), a=[[1, 2, 3], [4]]) == \
        [[2, 3], []]
    with pytest.raises(TypeError, match="between 2 and 2"):
        F.zip_with(a, a, lambda x: x)
    with pytest.raises(TypeError, match="between 1 and 2"):
        F.transform(a, lambda x, i, z: x)


def test_aggregate_merge_of_another_type_raises_as_spark():
    """Spark's analyzer requires the merge to give the zero's type
    (``aggregate(array(1L, 2L), 0, ...)`` fails); the reference folds and
    answers in the zero's type."""
    t = pa.table({"a": pa.array([[1, 2]], pa.list_(pa.int64()))})
    with pytest.raises(TypeError, match="argument 3 requires int type"):
        port_rows(t, lambda df, F: df.select(F.aggregate(
            F.col("a"), F.lit(0), lambda acc, x: acc + x)))


@pytest.mark.parametrize("cls", [PE.TransformKeys, PE.TransformValues,
                                 PE.MapFilter])
def test_map_higher_order_functions_are_refused(cls):
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({"k": pa.array([1], pa.int64())}))
    # the map forms run since slice 9b's map and struct half
    # (tests/test_torch_maps.py), over string keys since its rest's first
    # part; a map of list values still waits
    e = cls(PE.CreateMap(ColumnRef("k"), PE.CreateArray(ColumnRef("k"))),
            [PE.NamedLambdaVariable("k"), PE.NamedLambdaVariable("v")],
            Literal(True))
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.Col(e).alias("r")).collect()
