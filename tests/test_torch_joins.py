"""The port's joins against the reference's, on the CPU.

Every case of ``tests/test_joins.py`` runs here on both packages from the
same Arrow input (the reference on its device path,
``spark.rapids.tpu.sql.optimizer.enabled=false``): the join types, null
keys, duplicate keys, several keys, an empty side, conditions, cross and
nested-loop joins, a broadcast build side on either side, the
sub-partitioned join (a small ``subPartitionSizeBytes``) against the
unpartitioned one, the broadcast chosen by estimate or turned off, and the
USING join. Join results have no defined row order, so rows are compared
as sorted frames; values exactly. The match step itself, partitioning
and TPC-DS q3 are in ``tests/test_torch_join_match.py``.
"""
import math

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from data_gen import IntGen, gen_df
from harness import _assert_frames_equal, _canon
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exec import join_match as jm

from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
#: the coalesced join (no broadcast) with sub-partitions
SUBPART = {"spark.rapids.tpu.sql.join.subPartitionSizeBytes": 1024,
           "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _ref(conf=None):
    return TpuSession({**OFF, **(conf or {})})


def _port(conf=None):
    return TorchSession({**OFF, **(conf or {})}, device="cpu")


def _sides(s, n_l=512, n_r=256, key_hi=40, nullable=True, seed=0):
    l = s.create_dataframe(gen_df(
        {"lk": IntGen(lo=0, hi=key_hi, nullable=nullable),
         "lv": IntGen(nullable=False)}, n=n_l, seed=seed))
    r = s.create_dataframe(gen_df(
        {"rk": IntGen(lo=0, hi=key_hi, nullable=nullable),
         "rv": IntGen(nullable=False)}, n=n_r, seed=seed + 1))
    return l, r


def _assert_equal(q, conf=None):
    """``q(session, F)`` on both packages: the same rows in any order."""
    got = q(_port(conf), PF).collect_arrow().to_pandas()
    want = q(_ref(conf), RF).to_pandas()
    _assert_frames_equal(_canon(got, True), _canon(want, True), False)
    return got


def _equi(how, **kw):
    def q(s, F):
        l, r = _sides(s, **kw)
        return l.join(r, on=[("lk", "rk")], how=how)
    return q


def _multi_key(s, F):
    l = s.create_dataframe(gen_df(
        {"a": IntGen(lo=0, hi=5), "b": IntGen(lo=0, hi=5),
         "lv": IntGen(nullable=False)}, n=256))
    r = s.create_dataframe(gen_df(
        {"c": IntGen(lo=0, hi=5), "d": IntGen(lo=0, hi=5),
         "rv": IntGen(nullable=False)}, n=256, seed=7))
    return l.join(r, on=[("a", "c"), ("b", "d")], how="inner")


def _empty_side(s, F):
    l, r = _sides(s)
    return l.filter(F.col("lv") > 10**10).join(r, on=[("lk", "rk")],
                                               how="inner")


def _condition_inner(s, F):
    l, r = _sides(s, nullable=False)
    return l.join(r, on=[("lk", "rk")], how="inner",
                  condition=F.col("lv") > F.col("rv"))


def _cross(s, F):
    l = s.create_dataframe(pd.DataFrame({"a": [1, 2, 3]}))
    r = s.create_dataframe(pd.DataFrame({"b": [10, 20]}))
    return l.join(r, how="cross")


def _then_agg(s, F):
    l, r = _sides(s, nullable=False)
    return (l.join(r, on=[("lk", "rk")], how="inner").group_by("lk")
            .agg(F.sum(F.col("lv")).with_name("sl"),
                 F.count_star().with_name("n")))


def _conditional(how):
    def q(s, F):
        l, r = _sides(s, n_l=128, n_r=96, key_hi=10)
        return l.join(r, on=[("lk", "rk")], how=how,
                      condition=F.col("lv") > F.col("rv"))
    return q


def _existence(condition):
    def q(s, F):
        if condition:
            l, r = _sides(s, n_l=128, n_r=64, key_hi=8)
            return l.join(r, on=[("lk", "rk")], how="existence",
                          condition=F.col("lv") > F.col("rv"))
        l, r = _sides(s, n_l=256, n_r=64, key_hi=20)
        return l.join(r, on=[("lk", "rk")], how="existence")
    return q


def _nested(how):
    def q(s, F):
        l, r = _sides(s, n_l=64, n_r=48, key_hi=100)
        return l.join(r, how=how, condition=F.col("lk") < F.col("rk"))
    return q


def _cartesian_condition(s, F):
    l, r = _sides(s, n_l=32, n_r=32)
    return l.join(r, how="cross",
                  condition=F.col("lv") % 2 == F.col("rv") % 2)


def _nested_empty_right(s, F):
    l, r = _sides(s, n_l=32)
    return l.join(r.filter(F.col("rv") > 10**10), how="left",
                  condition=F.col("lk") < F.col("rk"))


def _broadcast(how):
    def q(s, F):
        l, r = _sides(s, n_l=512, n_r=64, key_hi=30)
        return l.join(F.broadcast(r), on=[("lk", "rk")], how=how)
    return q


def _broadcast_left(how):
    def q(s, F):
        l, r = _sides(s, n_l=64, n_r=512, key_hi=30)
        return F.broadcast(l).join(r, on=[("lk", "rk")], how=how)
    return q


def _broadcast_empty_stream(s, F):
    l, r = _sides(s, n_l=64, n_r=64, key_hi=10)
    return l.filter(F.col("lv") > 10**10).join(
        F.broadcast(r), on=[("lk", "rk")], how="left")


def _string_payloads(how):
    """A dictionary string payload on one side and a byte-rectangle one
    (many distinct values) on the other, through the gathers and the
    null extension."""
    def q(s, F):
        rng = np.random.RandomState(11)
        lt = pa.table({"lk": pa.array(rng.randint(0, 30, 400),
                                      mask=rng.rand(400) < 0.1),
                       "ls": pa.array(rng.choice(["AIR", "MAIL", "SHIP"],
                                                 400),
                                      mask=rng.rand(400) < 0.1)})
        rt = pa.table({"rk": pa.array(rng.randint(0, 40, 300)),
                       "rs": pa.array([f"comment {i:05d}" for i in
                                       rng.permutation(300)],
                                      mask=rng.rand(300) < 0.1)})
        return s.create_dataframe(lt).join(s.create_dataframe(rt),
                                           on=[("lk", "rk")], how=how)
    return q


_HOWS = ["inner", "left", "right", "full", "leftsemi", "leftanti"]

#: name -> (query over (session, F), conf): the cases of tests/test_joins.py
CASES = {
    **{f"equi_join-{h}": (_equi(h), None) for h in _HOWS},
    **{f"null_keys_never_match-{h}": (_equi(h, key_hi=3), None)
       for h in ("inner", "left", "full")},
    "duplicate_keys_product": (_equi("inner", n_l=64, n_r=64, key_hi=4,
                                     nullable=False), None),
    "multi_key": (_multi_key, None),
    "empty_side": (_empty_side, None),
    "condition_inner": (_condition_inner, None),
    "cross": (_cross, None),
    "then_agg": (_then_agg, None),
    **{f"conditional_equi_join-{h}": (_conditional(h), None)
       for h in _HOWS},
    "existence": (_existence(False), None),
    "existence_with_condition": (_existence(True), None),
    **{f"nested_loop-{h}": (_nested(h), None) for h in _HOWS},
    "cartesian_with_condition": (_cartesian_condition, None),
    "nested_loop_empty_right": (_nested_empty_right, None),
    **{f"broadcast-{h}": (_broadcast(h), None)
       for h in _HOWS + ["existence"]},
    **{f"subpartitioned-{h}": (_equi(h, n_l=1024, n_r=512, key_hi=50),
                               SUBPART) for h in _HOWS},
    **{f"broadcast_left_build-{h}": (_broadcast_left(h), None)
       for h in ("inner", "right", "left", "full")},
    "broadcast_empty_stream": (_broadcast_empty_stream, None),
    **{f"string_payloads-{h}": (_string_payloads(h), None)
       for h in ("left", "full")},
    "string_payloads-shuffled": (_string_payloads("left"), SUBPART),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_join_equals_reference(name):
    q, conf = CASES[name]
    _assert_equal(q, conf)


def test_float_keys_nan_matches_nan():
    """Spark: NaN joins NaN, -0.0 joins 0.0 (NormalizeFloatingNumbers)."""
    t_l = pa.table({"lk": pa.array([1.0, float("nan"), 0.0, -0.0]),
                    "lv": pa.array([1, 2, 3, 4], pa.int64())})
    t_r = pa.table({"rk": pa.array([float("nan"), 0.0, 2.0]),
                    "rv": pa.array([10, 20, 30], pa.int64())})

    def q(s, F):
        return s.create_dataframe(t_l).join(s.create_dataframe(t_r),
                                            on=[("lk", "rk")], how="inner")
    out = _assert_equal(q)
    assert sorted(zip(out["lv"], out["rv"])) == [(2, 10), (3, 20), (4, 20)]


def test_conditional_left_join_hand_oracle():
    """The condition decides which pairs match, it does not post-filter:
    a left row whose key matches but whose condition never holds is
    null-extended."""
    s = _port()
    l = s.create_dataframe(pa.table({"lk": [1, 1, 2], "lv": [10, 1, 5]}))
    r = s.create_dataframe(pa.table({"rk": [1, 1, 3], "rv": [5, 20, 0]}))
    out = l.join(r, on=[("lk", "rk")], how="left",
                 condition=PF.col("lv") > PF.col("rv")).collect()
    assert sorted(((o["lv"], o["rv"]) for o in out),
                  key=lambda x: (x[1] is None, x)) == [(10, 5), (1, None),
                                                       (5, None)]


@pytest.mark.parametrize("what", ["nested_loop", "broadcast_exchange"])
def test_join_plans(what):
    l, r = _sides(_port())
    if what == "nested_loop":
        tree = l.join(r, how="inner",
                      condition=PF.col("lk") < PF.col("rk"))._physical()
        assert "NestedLoopJoin" in tree.tree_string()
    else:
        t = l.join(PF.broadcast(r), on=[("lk", "rk")],
                   how="inner")._physical().tree_string()
        assert "BroadcastExchange" in t and "BroadcastHashJoin" in t


def test_subpartitioned_join_matches_unpartitioned():
    def q(s):
        l, r = _sides(s, n_l=777, n_r=333, key_hi=25)
        return l.join(r, on=[("lk", "rk")], how="inner")
    key = ["lk", "lv", "rk", "rv"]
    sub = q(_port(SUBPART))
    a = sub.collect_arrow().to_pandas()
    b = q(_port()).collect_arrow().to_pandas()
    a = a.sort_values(key, na_position="first").reset_index(drop=True)
    b = b.sort_values(key, na_position="first").reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b)
    assert sub.session.last_plan.last_subpartitions >= 2


def test_auto_broadcast_small_side():
    """The plan-time size estimate picks the broadcast side without a
    hint (Spark's autoBroadcastJoinThreshold)."""
    rng = np.random.RandomState(0)
    big = pa.table({"k": pa.array(rng.randint(0, 50, 50000)),
                    "v": pa.array(rng.standard_normal(50000))})
    dim = pa.table({"k2": pa.array(np.arange(50)),
                    "w": pa.array(np.arange(50) * 2.0)})

    def q(s, F):
        return s.create_dataframe(big).join(s.create_dataframe(dim),
                                            on=[("k", "k2")])
    tree = q(_port(), PF)._physical().tree_string()
    assert "BroadcastHashJoin" in tree and "build=right" in tree, tree
    got = q(_port(), PF).agg(PF.sum(PF.col("w")).with_name("sw")).collect()
    want = q(_ref(), RF).agg(RF.sum(RF.col("w")).with_name("sw")).collect()
    # the rows reach the sum in another order in each package
    assert math.isclose(got[0]["sw"], want[0]["sw"], rel_tol=1e-12)


@pytest.mark.parametrize("threshold", [0, -1])
def test_auto_broadcast_disabled_by_conf(threshold):
    big = pa.table({"k": pa.array(np.arange(1000))})
    dim = pa.table({"k2": pa.array(np.arange(10))})
    s = _port({"spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
               threshold})
    df = s.create_dataframe(big).join(s.create_dataframe(dim),
                                      on=[("k", "k2")])
    assert "BroadcastHashJoin" not in df._physical().tree_string()
    assert len(df.collect()) == 10


def test_broadcast_chosen_by_estimate_only():
    """The reference's AQE case (``test_aqe_broadcast_flips_on_measured_
    size``): a filter that keeps almost nothing leaves the estimate over
    the threshold. The port plans by estimate only (measured sizes wait
    for the adaptivity slice), so both plannings stay shuffled; the
    results equal the reference's."""
    rng = np.random.RandomState(4)
    n = 60000
    left = pa.table({"k": pa.array(rng.randint(0, 1000, n)),
                     "v": pa.array(rng.uniform(0, 1, n))})
    right = pa.table({"k2": pa.array(rng.randint(0, 1000, n)),
                      "w": pa.array(rng.randint(0, 3, n))})
    conf = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 64 * 1024}

    def q(s, F):
        r = s.create_dataframe(right).filter(F.col("w") == F.lit(0)) \
            .filter(F.col("k2") < F.lit(20))
        return (s.create_dataframe(left)
                .join(r, on=[(F.col("k"), F.col("k2"))], how="inner")
                .group_by("k").agg(F.count_star().with_name("n")))
    s = _port(conf)
    for _ in range(2):
        df = q(s, PF)
        assert "BroadcastHashJoin" not in df._physical().tree_string()
        df.collect()
    _assert_equal(q, conf)


def test_using_join_single_key_column():
    """join(on='k') emits one k column (PySpark's USING): left's values,
    right's for a right join, the two coalesced for a full join."""
    s = _port()
    l = s.create_dataframe(pa.table({"k": pa.array([1, 2], pa.int64()),
                                     "v": pa.array([10, 20], pa.int64())}))
    r = s.create_dataframe(pa.table({"k": pa.array([1], pa.int64()),
                                     "w": pa.array([5], pa.int64())}))
    j = l.join(r, on="k", how="left")
    assert j.columns == ["k", "v", "w"], j.columns
    out = j.order_by(PF.col("k").asc()).collect()
    assert [o["k"] for o in out] == [1, 2]
    assert [o["v"] for o in out] == [10, 20]
    assert out[0]["w"] == 5 and out[1]["w"] is None
    jr = l.join(r, on="k", how="right").collect()
    assert [o["k"] for o in jr] == [1] and [o["w"] for o in jr] == [5]
    r2 = s.create_dataframe(pa.table({"k": pa.array([3], pa.int64()),
                                      "w": pa.array([7], pa.int64())}))
    jf = l.join(r2, on="k", how="full").order_by(PF.col("k").asc())
    assert [o["k"] for o in jf.collect()] == [1, 2, 3]


def test_string_keys_join_through_the_union_dictionary():
    """Dictionary string keys of two sides (two dictionaries) match by
    value; a null string never matches; against pandas."""
    lt = pa.table({"s": pa.array(["a", "b", None, "c", "b", "d"]),
                   "x": pa.array(np.arange(6))})
    rt = pa.table({"t": pa.array(["b", "c", "c", None, "e"]),
                   "y": pa.array(np.arange(5) * 10)})
    s = _port()
    got = s.create_dataframe(lt).join(s.create_dataframe(rt),
                                      on=[("s", "t")], how="inner").collect()
    want = lt.to_pandas().dropna().merge(rt.to_pandas().dropna(),
                                         left_on="s", right_on="t")
    assert sorted((g["x"], g["y"]) for g in got) == sorted(
        zip(want["x"], want["y"]))


def test_output_past_int32_rows_raises_naming_the_join():
    """A join whose output would pass 2**31 - 1 rows raises before any
    map is written (the count is mocked: no such join is built)."""
    per = torch.tensor([1 << 30, 1 << 30, 5], dtype=torch.int64)
    with pytest.raises(OverflowError, match="equi-join output"):
        jm.output_size(per)
    assert jm.output_size(torch.tensor([3, 4])) == 7


def test_join_match_on_a_cpu_tensor_runs_the_plain_version():
    w = torch.tensor([[1], [2], [2]], dtype=torch.int64)
    n = torch.zeros(3, dtype=torch.bool)
    table = jm.build_table(w, n)
    assert table.table is None
    before = jm.join_match.launches
    maps = jm.join_match(w, n, table, "inner")
    assert jm.join_match.launches == before
    assert list(zip(maps.stream.tolist(), maps.build.tolist())) == [
        (0, 0), (1, 1), (1, 2), (2, 1), (2, 2)]
