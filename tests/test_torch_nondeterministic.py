"""rand, the row ids, range, sample and the hashes on the port against the
reference, bit for bit.

``rand`` and ``monotonically_increasing_id`` number the rows an operator
sees in its partition during one execution: the same values whatever
the batch size, in every partition of a multi-partition scan, again on a
second collect, after a filter, and inside an aggregate that folds the
projection (exprs/nondeterministic.py). ``sample`` keeps the reference's
rows (one RandomState stream over the batches in order). ``range``
equals the reference for positive, non-dividing and empty ranges, and
Python's ``range`` for negative steps, where the reference counts no
values (a departure, ROADMAP.md Queue C). ``hash`` and ``xxhash64`` are
bit-identical to the reference's over every fixed-width type, NULLs
included, and to Spark's known values.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exprs import hash_fns as HF
from spark_rapids_tpu_torch.exprs import nondeterministic as ND
from spark_rapids_tpu_torch.exprs.hash_fns import (xxhash64_int,
                                                   xxhash64_long)
from spark_rapids_tpu_torch.exprs.nondeterministic import (splitmix64,
                                                           splitmix64_int)

from test_torch_slice import prebuild_reference_native
from torch_compare import (OFF, PORT, REF, frames_equal, run_both,
                           sessions)

N = 1500


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _table(seed: int = 0) -> pa.Table:
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(N)
    x[:6] = [0.0, -0.0, math.nan, math.inf, -math.inf, 1.5]
    return pa.table({
        "i": pa.array(rng.randint(-2 ** 31, 2 ** 31, N).astype(np.int32),
                      mask=rng.rand(N) < 0.05),
        "l": pa.array(rng.randint(-2 ** 62, 2 ** 62, N), type=pa.int64()),
        "x": pa.array(x, mask=rng.rand(N) < 0.05),
        "f": pa.array(x.astype(np.float32)),
        "b": pa.array(rng.rand(N) < 0.5),
        "s": pa.array(rng.randint(-100, 100, N).astype(np.int16)),
        "d": pa.array(rng.randint(-25567, 47482, N).astype(np.int32))
        .cast(pa.date32()),
        "t": pa.array(rng.randint(-2 * 10 ** 15, 4 * 10 ** 15, N))
        .cast(pa.timestamp("us", tz="UTC")),
    })


@pytest.mark.parametrize("batch_rows", [None, 100, 7])
def test_rand_and_ids_equal_reference_across_batches(batch_rows):
    ref, got = run_both(_table(1), lambda df, F, E: df.select(
        F.col("i"), F.rand(7).alias("r"), F.rand().alias("r0"),
        F.monotonically_increasing_id().alias("id"),
        F.spark_partition_id().alias("p")), batch_rows=batch_rows)
    frames_equal(got, ref)


def test_ids_per_partition_and_recollect():
    t = _table(2)
    out = []
    for s, (F, _) in zip(sessions({"spark.rapids.tpu.sql.batchSizeRows": 64}),
                         (REF, PORT)):
        df = s.create_dataframe(t, num_partitions=3).select(
            F.rand(3).alias("r"), F.monotonically_increasing_id().alias("id"),
            F.spark_partition_id().alias("p"))
        first = df.collect_arrow()
        assert first.equals(df.collect_arrow())      # counters restart
        out.append(first)
    frames_equal(out[1], out[0])
    ids = out[1].column("id").to_pylist()
    assert ids[0] == 0 and (1 << 33) in ids and (2 << 33) in ids


def test_rand_filter_and_ids_after_a_filter_equal_reference():
    t = _table(3)
    ref, got = run_both(t, lambda df, F, E: df.filter(F.rand(7) < F.lit(0.3))
                        .select(F.col("l")), batch_rows=200)
    frames_equal(got, ref)
    ref, got = run_both(t, lambda df, F, E: df.filter(F.col("s") > F.lit(0))
                        .select(F.col("s"), F.monotonically_increasing_id()
                                .alias("id"), F.rand(1).alias("r")),
                        batch_rows=200)
    frames_equal(got, ref)


def test_ids_inside_an_aggregate_count_only_the_rows_they_see():
    """A projection of rand/ids over a filter stays out of the
    aggregate's fold (a folded filter masks rows without compacting
    them), so the ids are those of the filtered rows, as the
    reference's."""
    t = _table(4)

    def build(df, F, E):
        return (df.filter(F.col("s") > F.lit(10))
                .select(F.monotonically_increasing_id().alias("id"),
                        F.rand(5).alias("r"))
                .agg(F.max(F.col("id")).with_name("m"),
                     F.sum(F.col("r")).with_name("s"),
                     F.count_star().with_name("n")))
    ref, got = run_both(t, build, batch_rows=128)
    frames_equal(got, ref, approx=True)
    row = got.to_pylist()[0]
    assert row["m"] == row["n"] - 1
    ref, got = run_both(t, lambda df, F, E: df.filter(F.rand(9) < F.lit(0.5))
                        .agg(F.count_star().with_name("n")), batch_rows=128)
    frames_equal(got, ref)
    ref, got = run_both(t, lambda df, F, E: df.filter(F.col("s") > F.lit(10))
                        .agg(F.sum(F.rand(3)).with_name("r"),
                             F.max(F.monotonically_increasing_id())
                             .with_name("m")), batch_rows=128)
    frames_equal(got, ref, approx=True)


def test_rand_formula():
    """splitmix64 over int64 lanes equals the Python form, and rand's
    values are the reference's formula over the row index."""
    rng = np.random.RandomState(5)
    words = [int(w) for w in rng.randint(0, 2 ** 63, 50)] + [0, 2 ** 64 - 1,
                                                              2 ** 63]
    import torch
    lanes = torch.tensor([w - 2 ** 64 if w >= 2 ** 63 else w for w in words],
                         dtype=torch.int64)
    got = [int(v) & (2 ** 64 - 1) for v in splitmix64(lanes).tolist()]
    assert got == [splitmix64_int(w) for w in words]
    s = TorchSession(OFF, device="cpu")
    r = s.range(0, 5).select(PF.rand(42).alias("r")).collect()
    key = splitmix64_int(42)
    want = [(splitmix64_int(i ^ key) >> 11) / 2.0 ** 53 for i in range(5)]
    assert [x["r"] for x in r] == want


@pytest.mark.parametrize("args", [(0, 10), (0, 10, 3), (5, 5), (7,),
                                  (-7, 30, 4), (3, 0, 1), (0, 1000, 7)])
def test_range_equals_reference(args):
    out = []
    for s in sessions({"spark.rapids.tpu.sql.batchSizeRows": 64}):
        out.append(s.range(*args).collect_arrow())
    frames_equal(out[1], out[0])
    assert out[1].column("id").to_pylist() == list(range(*args))


@pytest.mark.parametrize("args", [(10, 0, -3), (0, -10, -4), (5, -1, -1),
                                  (0, 10, -1)])
def test_range_with_a_negative_step_follows_spark(args):
    """Departure: the reference's range counts no values for a negative
    step (exec/basic.py:545); Spark counts down."""
    s = TorchSession({**OFF, "spark.rapids.tpu.sql.batchSizeRows": 2},
                     device="cpu")
    assert s.range(*args).collect_arrow().column("id").to_pylist() == \
        list(range(*args))
    with pytest.raises(ValueError, match="step"):
        s.range(0, 5, 0)


@pytest.mark.parametrize("batch_rows", [None, 97])
@pytest.mark.parametrize("fraction,seed", [(0.1, 42), (0.5, 7), (1.0, 3),
                                           (0.0, 1)])
def test_sample_keeps_the_reference_rows(batch_rows, fraction, seed):
    ref, got = run_both(_table(5), lambda df, F, E: df.sample(fraction, seed)
                        .select(F.col("l"), F.col("x")),
                        batch_rows=batch_rows)
    frames_equal(got, ref)


def test_sample_then_aggregate_equals_reference():
    ref, got = run_both(_table(6), lambda df, F, E: df.sample(0.3, 11).agg(
        F.count_star().with_name("n"), F.sum(F.col("l")).with_name("s")),
        batch_rows=100)
    frames_equal(got, ref)


_HASHED = [("i",), ("l",), ("x",), ("f",), ("b",), ("s",), ("d",), ("t",),
           ("i", "l"), ("l", "x", "d"), ("b", "s", "f", "t", "i")]


@pytest.mark.parametrize("cols", _HASHED, ids=["-".join(c) for c in _HASHED])
def test_hashes_equal_reference(cols):
    ref, got = run_both(_table(7), lambda df, F, E: df.select(
        F.Col(E.Murmur3Hash([F.col(c).expr for c in cols])).alias("h"),
        F.Col(E.XxHash64([F.col(c).expr for c in cols])).alias("x")))
    frames_equal(got, ref)


def test_hashes_known_values_and_fold():
    s = TorchSession(OFF, device="cpu")
    df = s.create_dataframe(pa.table({"a": pa.array([1, None, 42],
                                                    pa.int32()),
                                      "l": pa.array([1, 2, None],
                                                    pa.int64())}))
    a, l = PF.col("a"), PF.col("l")
    rows = df.select(PF.hash(a).alias("h"), PF.xxhash64(a).alias("x"),
                     PF.xxhash64(a, l).alias("xl")).collect()
    # Spark's hashInt(1, 42): murmur3 -559580957; XXH64 through the
    # host form, itself held to a bigint's -7001672635703045582
    assert rows[0]["h"] == -559580957
    assert rows[0]["x"] == xxhash64_int(1, 42)
    assert xxhash64_long(1, 42) == -7001672635703045582
    assert df.select(PF.xxhash64(l).alias("x")).collect()[0]["x"] == \
        -7001672635703045582
    assert rows[1]["x"] == 42                   # a NULL leaves the seed
    assert rows[0]["xl"] == xxhash64_long(1, xxhash64_int(1, 42) & (
        2 ** 64 - 1))
    assert rows[1]["xl"] == xxhash64_long(2, 42)
    with pytest.raises(NotImplementedError, match="strings slice"):
        s.create_dataframe(pa.table({"s": ["a"]})).select(
            PF.hash(PF.col("s"))).collect()
    for cls in (HF.Md5, HF.Sha1, HF.Crc32, HF.HiveHash):
        with pytest.raises(NotImplementedError, match="host engine"):
            df.select(PF.Col(cls(PF.col("a").expr)).alias("o")).collect()


def test_rand_outside_a_projection_is_refused_by_name():
    df = TorchSession(OFF, device="cpu").create_dataframe(_table(8))
    with pytest.raises(NotImplementedError, match="project the value"):
        df.order_by(PF.rand(1)).collect()
    with pytest.raises(NotImplementedError, match="slice 12"):
        df.repartition(4)
    with pytest.raises(NotImplementedError, match="slice 10"):
        df.select(PF.Col(ND.InputFileName())).collect()
