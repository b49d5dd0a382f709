"""String building (slice 7) in the port, on the CPU: ``concat`` and SQL
``||``, ``concat_ws``, ``repeat``, ``translate``, ``ascii``, ``chr``,
``bit_length`` and ``octet_length``.

* Each against the JAX package (optimizer off) over a byte rectangle and
  a dictionary column, with NULLs, at default and 3-row batches.
* A concat of dictionaries whose product is small is a dictionary column
  and serves as a group key, as DataFrame and as SQL ``||``.
* Where the JAX package departs from Spark (``chr`` of a multiple of 256;
  ``translate`` to ``'\\0'``) the port is held to Spark (ROADMAP.md
  Queue C).
* ``rect_transform``'s ``repeat`` and ``translate`` ops: the kernel's row
  logic (csrc/rect_transform_row.cuh, built with g++ by
  tests/test_torch_strings.py's harness) against the plain version, and
  the plain version against each value's ``host_value``.
* What is refused names its slice: a concat past the rectangle's cap,
  a child of another type, a list child of ``concat_ws``.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from harness import _assert_frames_equal, _canon
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exec.rect_transform import (
    chain_widths, rect_transform_reference)

from test_torch_slice import prebuild_reference_native
from test_torch_strings import _host_rows, host_lib  # noqa: F401

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
CAP = 64


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _table(n: int, seed: int) -> pa.Table:
    """``hi``: near-unique ASCII values up to 14 bytes (a byte rectangle);
    ``lo``, ``lo2``: a few values (dictionaries); ``n``: integers for
    ``chr``; NULLs in each."""
    rng = np.random.RandomState(seed)
    hi = [f"{'ab-Q'[i % 4]}x{i:05d} {'y' * (i % 5)}" for i in
          rng.permutation(n)]
    lo = np.array(["A", "N", "R", "", "a-b", "AAB"])[rng.randint(0, 6, n)]
    lo2 = np.array(["O", "F", "xyz"])[rng.randint(0, 3, n)]
    nums = rng.choice([-1, 65, 200, 97, 32, 126], n)
    return pa.table({
        "hi": pa.array(hi, mask=rng.rand(n) < 0.05),
        "lo": pa.array(lo, mask=rng.rand(n) < 0.05),
        "lo2": pa.array(lo2, mask=rng.rand(n) < 0.05),
        "n": pa.array(nums, mask=rng.rand(n) < 0.05),
        "v": pa.array(rng.rand(n)),
    })


def _both(query, table, conf=None, ordered=True):
    conf = {**OFF, **(conf or {})}
    got = query(TorchSession(conf, device="cpu").create_dataframe(table),
                PF).collect_arrow().to_pandas()
    want = query(TpuSession(conf).create_dataframe(table), RF).to_pandas()
    _assert_frames_equal(_canon(got, not ordered), _canon(want,
                                                          not ordered),
                         False)
    return got


def _build(df, F):
    c = F.col
    return df.select(
        F.concat(c("hi"), F.lit("|"), c("lo")).alias("c1"),
        F.concat(c("lo"), c("lo2")).alias("c2"),
        F.concat(c("lo"), F.lit(None)).alias("c3"),
        F.concat(F.upper(c("lo")), F.substring(c("hi"), 1, 5)).alias("c4"),
        F.concat_ws("-", c("hi"), c("lo"), F.lit(None), c("lo2"))
        .alias("w1"),
        F.concat_ws("", c("lo"), c("lo")).alias("w2"),
        F.concat_ws(F.lit(None), c("lo")).alias("w3"),
        F.repeat(c("lo"), 2).alias("r1"), F.repeat(c("hi"), 2).alias("r2"),
        F.repeat(c("lo"), 0).alias("r3"), F.repeat(c("hi"), -1).alias("r4"),
        F.translate(c("hi"), "abxx", "BA").alias("t1"),
        F.translate(c("lo"), "AAB-", "xyz").alias("t2"),
        F.ascii(c("hi")).alias("a1"), F.ascii(c("lo")).alias("a2"),
        F.bit_length(c("hi")).alias("b1"), F.bit_length(c("lo")).alias("b2"),
        F.octet_length(c("hi")).alias("o1"),
        F.octet_length(c("lo")).alias("o2"),
        F.chr_(c("n")).alias("ch"), c("v"))


@pytest.mark.parametrize("batch", [None, 3])
def test_string_building_equals_reference(batch):
    table = _table(400 if batch is None else 40, 7)
    conf = None if batch is None else {
        "spark.rapids.tpu.sql.batchSizeRows": batch}
    _both(_build, table, conf)


def test_chains_over_a_concat_run_in_projections_and_filters():
    """``upper(concat(...))`` and a pattern over a concat run (the chain's
    column comes from the concat), in a projection and a filter."""
    table = _table(300, 9)
    _both(lambda df, F: df.select(
        F.upper(F.concat(F.col("hi"), F.col("lo"))).alias("u"),
        F.length(F.concat(F.col("lo"), F.col("lo2"))).alias("n"),
        F.concat(F.col("hi"), F.col("lo")).like("%1%A").alias("m"),
        F.concat(F.col("lo"), F.lit("!")).rlike("^A.*!$").alias("r")),
        table)
    _both(lambda df, F: df.filter(
        F.concat(F.col("hi"), F.col("lo")).like("%0_A%"))
        .select("hi", "lo"), table)


def test_sql_concat_and_pipes_equal_reference():
    table = _table(300, 11)
    port = TorchSession(OFF, device="cpu")
    ref = TpuSession(OFF)
    for s in (port, ref):
        s.create_dataframe(table).create_or_replace_temp_view("t")
    for text in ("SELECT lo || '|' || lo2 AS k, concat(hi, lo) AS c "
                 "FROM t",
                 "SELECT lo || '|' || lo2 AS k, count(*) AS n, sum(v) AS s "
                 "FROM t GROUP BY lo || '|' || lo2 ORDER BY k"):
        got = port.sql(text).collect_arrow().to_pandas()
        want = ref.sql(text).to_pandas()
        _assert_frames_equal(_canon(got, False), _canon(want, False), True)


def test_dictionary_product_concat_is_a_dictionary_group_key():
    """``concat(lo, '|', lo2)``: 6 x 1 x 3 combinations, a dictionary
    column (its entries joined once on the host), grouped with count and
    sum as the reference groups it."""
    table = _table(2000, 5)
    key = PF.concat(PF.col("lo"), PF.lit("|"), PF.col("lo2"))
    s = TorchSession(OFF, device="cpu")
    got = (s.create_dataframe(table).group_by(key.alias("k"))
           .agg(PF.count_star().with_name("n"),
                PF.sum(PF.col("v")).with_name("s")).order_by("k")
           .collect_arrow().to_pandas())
    assert any(k[0] == "dict" for k in key.expr._cache)
    want = (TpuSession(OFF).create_dataframe(table)
            .group_by(RF.concat(RF.col("lo"), RF.lit("|"), RF.col("lo2"))
                      .alias("k"))
            .agg(RF.count_star().with_name("n"),
                 RF.sum(RF.col("v")).with_name("s")).order_by("k")
            .to_pandas())
    _assert_frames_equal(_canon(got, False), _canon(want, False), True)


def test_chr_follows_spark_for_multiples_of_256():
    """Spark's ``chr(n)``: '' for n < 0, else ``chr(n & 255)``, so 0 and
    256 give ``'\\0'``; the JAX package gives '' (ROADMAP.md Queue C)."""
    t = pa.table({"n": pa.array([-1, 0, 256, 65, 200, 511, None],
                                type=pa.int64())})
    got = TorchSession(OFF, device="cpu").create_dataframe(t).select(
        PF.chr_(PF.col("n")).alias("c")).collect()
    assert [r["c"] for r in got] == ["", "\0", "\0", "A", "\xc8", "\xff",
                                     None]
    ref = TpuSession(OFF).create_dataframe(t).select(
        RF.chr_(RF.col("n")).alias("c")).to_pandas()
    assert list(ref["c"])[:3] == ["", "", ""]


@pytest.mark.parametrize("layout_rows", [10, 4000])
def test_translate_to_nul_deletes_as_spark(layout_rows):
    """Spark's translate deletes a character mapped to ``'\\0'``; the JAX
    package keeps the NUL (ROADMAP.md Queue C). Over a dictionary and a
    rectangle."""
    vals = [f"a-b{i:05d}" for i in range(layout_rows)]
    df = TorchSession(OFF, device="cpu").create_dataframe(
        pa.table({"s": pa.array(vals)}))
    got = df.select(PF.translate(PF.col("s"), "a-", "\0Q").alias("t")) \
        .collect()
    assert [r["t"] for r in got] == [v.replace("a", "").replace("-", "Q")
                                     for v in vals]


# ---------------------------------------------------------------------------
# rect_transform's new ops
# ---------------------------------------------------------------------------

NEW_CHAINS = [c for c in chip_smoke.RT_CHAINS
              if any(op[0] in ("repeat", "translate") for op in c)]


def _rect(seed: int, rows: int, width: int):
    b, ln, v = chip_smoke._rt_rect(np.random.RandomState(seed), rows, width,
                                   "cpu")
    return b.numpy(), ln.numpy(), v.numpy()


@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_new_ops_row_logic_equals_plain_version(host_lib, width):  # noqa
    """repeat and translate through the kernel's group logic (junk past
    each row's length), against the plain version."""
    assert len(NEW_CHAINS) >= 6
    for rows in (1, 33, 301):
        b, ln, v = _rect(300 + width + rows, rows, width)
        junk = b.copy()
        past = np.arange(width)[None, :] >= ln[:, None]
        junk[past] = np.random.RandomState(rows).randint(
            0, 256, int(past.sum()))
        for chain in NEW_CHAINS:
            widths = chain_widths(chain, width, CAP)
            want_b, want_ln = rect_transform_reference(
                torch.from_numpy(b), torch.from_numpy(ln),
                torch.from_numpy(v), chain, CAP)
            out, out_len, lanes = _host_rows(host_lib, junk, ln, v, chain,
                                             widths)
            assert lanes == max(1, max(widths) // 16), (chain, lanes)
            np.testing.assert_array_equal(out, want_b.numpy(),
                                          err_msg=str(chain))
            np.testing.assert_array_equal(out_len, want_ln.numpy(),
                                          err_msg=str(chain))


@pytest.mark.parametrize("op,expr", [
    (("repeat", 3), PE.StringRepeat(PE.ColumnRef("s"), 3)),
    (("repeat", 0), PE.StringRepeat(PE.ColumnRef("s"), -2)),
    (("translate", b"aab -", b"xyz"),
     PE.StringTranslate(PE.ColumnRef("s"), "aab -", "xyz")),
])
def test_plain_new_ops_equal_host_value(op, expr):
    b, ln, v = _rect(17, 200, 16)
    got_b, got_ln = rect_transform_reference(
        torch.from_numpy(b), torch.from_numpy(ln), torch.from_numpy(v),
        [op], CAP)
    for r in range(len(ln)):
        want = expr.host_value(bytes(b[r, :ln[r]]).decode("latin-1")) \
            if v[r] else ""
        assert bytes(got_b[r, :got_ln[r]].numpy()).decode("latin-1") \
            == want, (op, r)


def test_repeat_past_the_cap_is_refused():
    vals = [f"{i:07d}" for i in range(4000)]
    df = TorchSession(OFF, device="cpu").create_dataframe(
        pa.table({"s": pa.array(vals)}))
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        df.select(PF.repeat(PF.col("s"), 9).alias("r")).collect()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_name_their_slice():
    vals = [f"{i:07d}-{'z' * 40}" for i in range(4000)]
    df = TorchSession(OFF, device="cpu").create_dataframe(
        pa.table({"s": pa.array(vals), "i": pa.array(range(4000)),
                  "l": pa.array([["a", None]] * 4000)}))
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        df.select(PF.concat(PF.col("s"), PF.col("s")).alias("c")).collect()
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest.*casts"):
        df.select(PF.concat(PF.col("s"), PF.col("i")).alias("c")).collect()
    with pytest.raises(NotImplementedError, match="slice 9b, the rest"):
        df.select(PF.concat_ws("-", PF.col("l")).alias("c")).collect()
