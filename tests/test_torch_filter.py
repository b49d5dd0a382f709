"""String predicates inside a filter, and OR / NOT: the port against the
JAX package on the CPU.

A filter condition may hold literal-match predicates (LIKE without inner
wildcards, startswith, endswith, contains) over STRING columns, under
AND, OR and NOT. Over a dictionary column each predicate runs once per
dictionary entry, then on the device as a code range (startswith over
the sorted dictionary) or a lookup in the entries' mask; over an ASCII
byte rectangle it runs through the rect chain (the match kernel's plain
version here: the tensors lie on the CPU). The reference runs its device
path (``spark.rapids.tpu.sql.optimizer.enabled=false``). Row sets and
counts are compared exactly; float sums to a relative 1e-9
(``_assert_frames_equal``'s approximate mode): the two packages add the
same values in different orders.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from harness import _assert_frames_equal
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
from spark_rapids_tpu.exprs.compiler import DeviceProjector as RefProjector
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import (ColumnarBatch, DictColumn,
                                            batch_from_reference)
from spark_rapids_tpu_torch.exec.basic import TpuFilterExec
from spark_rapids_tpu_torch.exprs.compiler import (DeviceProjector,
                                                   build_dict_filter)
from spark_rapids_tpu_torch.exprs.rect_match import rect_match
from spark_rapids_tpu_torch.types import (STRING, Schema, StructField,
                                          from_arrow)

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
PALLAS = "spark.rapids.tpu.sql.pallas.enabled"
MODES = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "REG AIR", "FOB"]
N = 20000


def _ref(conf=None):
    return TpuSession({**OFF, **(conf or {})})


def _port(conf=None):
    return TorchSession({**OFF, **(conf or {})}, device="cpu")


def _frames(got_df, want_df):
    """Port and reference results as pandas, row order kept."""
    return (got_df.collect_arrow().to_pandas().reset_index(drop=True),
            want_df.to_pandas().reset_index(drop=True))


def _assert_equal(q, table, conf=None):
    got, want = _frames(q(_port(conf).create_dataframe(table), PF),
                        q(_ref(conf).create_dataframe(table), RF))
    _assert_frames_equal(got, want, approximate_float=True)
    return got


# ---------------------------------------------------------------------------
# OR and NOT with nulls
# ---------------------------------------------------------------------------

def _bool_table(n: int, seed: int) -> pa.Table:
    rng = np.random.RandomState(seed)
    return pa.table({c: pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.3)
                     for c in "abc"})


def _logical_exprs(F):
    a, b, c = F.col("a"), F.col("b"), F.col("c")
    return [a | b, ~a, a & b, ~(a | b), (a | ~b) & c, ~(~a & (b | c)),
            a | F.lit(True), a & F.lit(False), ~F.lit(None) | a]


@pytest.mark.parametrize("seed", [1, 2])
def test_or_not_three_valued_logic_equals_reference(seed):
    table = _bool_table(3000, seed)
    ref = RefBatch.from_arrow(table)
    ref_out = RefProjector([e.expr for e in _logical_exprs(RF)],
                           ref.schema).run(ref)
    cols = [{"data": np.asarray(c.data), "validity": np.asarray(c.validity)}
            for c in ref.columns]
    schema = Schema([StructField(f.name, from_arrow(f.type), True)
                     for f in table.schema])
    port = batch_from_reference(cols, schema, "cpu", ref.num_rows)
    exprs = [e.expr for e in _logical_exprs(PF)]
    port_out = DeviceProjector(exprs, schema).run(port)
    for e, r, p in zip(exprs, ref_out, port_out):
        rv = np.asarray(r.validity)
        np.testing.assert_array_equal(p.validity.numpy(), rv,
                                      err_msg=f"{e} validity")
        np.testing.assert_array_equal(p.data.numpy()[rv],
                                      np.asarray(r.data)[rv], err_msg=str(e))
    # the Kleene corner cases, spelled out
    v = {(x, y): None for x in (True, False, None) for y in (True, False,
                                                             None)}
    t = pa.table({"a": pa.array([k[0] for k in v], pa.bool_()),
                  "b": pa.array([k[1] for k in v], pa.bool_())})
    got = _port().create_dataframe(t).select(
        (PF.col("a") | PF.col("b")).alias("o"),
        (~PF.col("a")).alias("n")).collect()
    assert [r["o"] for r in got] == [
        True, True, True, True, False, None, True, None, None]
    assert [r["n"] for r in got] == [False] * 3 + [True] * 3 + [None] * 3


# ---------------------------------------------------------------------------
# pattern predicates over a dictionary column, both forms
# ---------------------------------------------------------------------------

def _mode_table(n: int, seed: int) -> pa.Table:
    rng = np.random.RandomState(seed)
    modes = rng.choice(MODES, n)
    return pa.table({
        "l_shipmode": pa.array(modes, mask=rng.rand(n) < 0.05),
        "v": pa.array(rng.randint(0, 100, n)),
        "w": pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.1),
    })


#: name -> (predicate over l_shipmode, the dictionary form it takes)
PREDICATES = {
    "like_equals": (lambda F, c: c.like("MAIL"), "mask"),
    "like_prefix": (lambda F, c: c.like("RE%"), "mask"),
    "like_suffix": (lambda F, c: c.like("%AIR"), "mask"),
    "like_contains": (lambda F, c: c.like("%AI%"), "mask"),
    "startswith": (lambda F, c: F.startswith(c, "SH"), "range"),
    "startswith_none": (lambda F, c: F.startswith(c, "ZZ"), "range"),
    "startswith_many": (lambda F, c: c.startswith("R"), "range"),
    "endswith": (lambda F, c: F.endswith(c, "UCK"), "mask"),
    "contains": (lambda F, c: c.contains("A"), "mask"),
}

#: name -> how the predicate sits in the condition
SHAPES = {
    "alone": lambda F, p: p,
    "and": lambda F, p: p & (F.col("v") < F.lit(60)),
    "or": lambda F, p: p | (F.col("v") > F.lit(90)),
    "or_pred": lambda F, p: p | F.col("l_shipmode").like("FOB"),
    "not": lambda F, p: ~p,
    "not_or_null": lambda F, p: ~(p | F.col("w")),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("pred", sorted(PREDICATES))
def test_dictionary_predicate_in_filter_equals_reference(pred, shape):
    table = _mode_table(4000, 7)
    make, form = PREDICATES[pred]

    def q(df, F):
        cond = SHAPES[shape](F, make(F, F.col("l_shipmode")))
        return df.filter(cond).select("l_shipmode", "v")

    got = _assert_equal(q, table)
    assert len(got) > 0 or pred == "startswith_none"
    df = q(_port().create_dataframe(table), PF)
    phys = df._physical()
    ev = phys._dict_eval if isinstance(phys, TpuFilterExec) \
        else phys.children[0]._dict_eval
    assert [f for _, _, f in ev.preds][0] == form


def test_unsorted_dictionary_takes_the_mask_form():
    """The range form needs a sorted dictionary, which ingest guarantees;
    where the matches are not one span, the mask form gives the rows."""
    dictionary = np.array(["SHIP", "AIR", "SHOE", "MAIL"], dtype=object)
    codes = torch.tensor([0, 1, 2, 3, 2, 0, 1], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False, True, True])
    schema = Schema([StructField("m", STRING, True)])
    batch = ColumnarBatch([DictColumn(codes, valid, STRING, dictionary)],
                          7, schema)
    ev = build_dict_filter(PF.startswith(PF.col("m"), "SH").expr, schema)
    keep = ev.keep_mask(batch)
    assert keep.tolist() == [True, False, True, False, False, True, False]
    ops = next(iter(ev._mask_cache.values()))[1]
    assert ops[0] == "mask"
    # a sorted dictionary takes the range, and keeps the same rows
    order = np.argsort(dictionary)
    rank = np.empty(4, np.int64)
    rank[order] = np.arange(4)
    sorted_batch = ColumnarBatch([DictColumn(
        torch.from_numpy(rank[codes.numpy()].astype(np.int32)), valid,
        STRING, dictionary[order])], 7, schema)
    ev2 = build_dict_filter(PF.startswith(PF.col("m"), "SH").expr, schema)
    assert ev2.keep_mask(sorted_batch).tolist() == keep.tolist()
    assert next(iter(ev2._mask_cache.values()))[1][0] == "range"


def test_dictionary_masks_are_made_once_per_dictionary():
    table = _mode_table(9000, 3)
    df = _port({"spark.rapids.tpu.sql.batchSizeRows": 3000}) \
        .create_dataframe(table).filter(
            PF.col("l_shipmode").like("%AI%")
            | PF.startswith(PF.col("l_shipmode"), "T"))
    phys = df._physical()
    phys.collect(df.session.exec_context())
    # two predicates over three batches, each batch its own dictionary
    assert len(phys._dict_eval._mask_cache) == 6


def test_condition_the_port_cannot_rewrite_is_refused():
    table = _mode_table(100, 1)
    df = _port().create_dataframe(table).filter(
        PF.col("l_shipmode").like("M_IL"))
    with pytest.raises(NotImplementedError, match="cannot run on the device"):
        df.collect()


# ---------------------------------------------------------------------------
# byte rectangles through the rect chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def comments():
    t = chip_smoke.gen_table(N)
    arrow = pa.table({
        "l_comment": pa.array(t["l_comment"]).cast(pa.string()),
        "l_extendedprice": pa.array(t["l_extendedprice"]),
        "l_quantity": pa.array(t["l_quantity"])})
    return t, arrow


RECT_CONDS = {
    "not_like": lambda F: ~F.col("l_comment").like("%special%"),
    "or": lambda F: (F.col("l_comment").contains("ironic")
                     | F.startswith(F.col("l_comment"), "furious")),
    "and_not": lambda F: (F.endswith(F.col("l_comment"), "s")
                          & ~F.col("l_comment").contains("the")
                          & (F.col("l_quantity") < F.lit(30.0))),
}


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("cond", sorted(RECT_CONDS))
def test_rect_column_predicate_in_filter_equals_reference(comments, cond,
                                                          kernel):
    _, arrow = comments

    def q(df, F):
        return df.filter(RECT_CONDS[cond](F)).agg(
            F.count_star().with_name("n"),
            F.sum(F.col("l_extendedprice")).with_name("revenue"))

    before = rect_match.launches
    got = _assert_equal(q, arrow, {PALLAS: kernel})
    assert rect_match.launches == before      # CPU tensors: no launch
    assert 0 < got["n"][0] < N


@pytest.mark.parametrize("case", ["over_wide", "non_ascii"])
def test_host_or_non_ascii_string_column_is_refused(case):
    """The reference filters such a batch on the host; the port has no
    host engine, and names the strings slice."""
    rng = np.random.RandomState(5)
    words = [f"w{i:05d}-special" if i % 3 else f"w{i:05d}" for i in
             range(500)]
    if case == "non_ascii":
        words = [w + "é" for w in words]
    conf = {"spark.rapids.tpu.sql.string.rect.maxBytes": 8} \
        if case == "over_wide" else None
    table = pa.table({"s": pa.array(rng.permutation(words))})
    df = _port(conf).create_dataframe(table).filter(
        ~PF.col("s").contains("special"))
    with pytest.raises(NotImplementedError, match="strings slice"):
        df.collect()


# ---------------------------------------------------------------------------
# the slice's queries
# ---------------------------------------------------------------------------

def test_q12_modes_equals_reference(comments):
    t, _ = comments
    arrow = pa.table({k: pa.array(v) for k, v in t.items()
                      if k != "l_comment"})
    got = _assert_equal(chip_smoke.q12_modes, arrow,
                        {"spark.rapids.tpu.sql.batchSizeRows": 6000})
    assert list(got["l_shipmode"]) == ["MAIL", "SHIP"]
    want = chip_smoke.q12_modes_numpy(t)
    assert list(got["n"]) == [w["n"] for w in want]


@pytest.mark.parametrize("kernel", [True, False])
def test_q_comment_filter_equals_reference(comments, kernel):
    t, arrow = comments
    got = _assert_equal(chip_smoke.q_comment_filter, arrow, {PALLAS: kernel})
    n, revenue = chip_smoke.q_comment_filter_numpy(t)
    assert got["n"][0] == n
    assert abs(got["revenue"][0] - revenue) <= 1e-9 * revenue


def test_filter_plans_the_dictionary_route():
    table = _mode_table(100, 2)
    df = _port().create_dataframe(table).filter(
        ~PF.col("l_shipmode").like("MAIL"))
    assert "dict_eval" in df._physical().tree_string()
