"""q6's predicate and projection expressions: the port against the
reference ``DeviceProjector`` on the same device layout.

Random lineitem batches with nulls (and NaN, -0.0 in the float columns)
are ingested by the reference, carried across to the port with
``batch_from_reference`` (padding rows included), and both evaluate the
same expressions built through their own ``functions`` modules. Bools
and ints must be equal exactly, and so must the float products: both
sides multiply the same float64 operands once.
"""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
from spark_rapids_tpu.exprs.compiler import DeviceProjector as RefProjector
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import batch_from_reference
from spark_rapids_tpu_torch.exprs.compiler import DeviceProjector
from spark_rapids_tpu_torch.types import Schema, StructField, from_arrow


def _batch(n: int, seed: int) -> pa.Table:
    rng = np.random.RandomState(seed)

    def masked(v, p=0.08):
        return pa.array(v, mask=rng.rand(n) < p)
    disc = np.round(rng.randint(0, 11, n) / 100.0, 2)
    disc[::97] = np.nan
    qty = rng.randint(1, 51, n).astype(np.float64)
    qty[3::89] = -0.0
    return pa.table({
        "l_shipdate": masked((np.datetime64("1992-01-01")
                              + rng.randint(0, 2526, n))
                             .astype("datetime64[D]")),
        "l_discount": masked(disc),
        "l_quantity": masked(qty),
        "l_extendedprice": masked(np.round(rng.uniform(900, 105000, n), 2)),
        "l_orderkey": masked(rng.randint(1, 1000, n)),
        "l_linenumber": masked(rng.randint(1, 8, n).astype(np.int32)),
    })


def _exprs(F):
    lo, hi = np.datetime64("1994-01-01"), np.datetime64("1995-01-01")
    pred = ((F.col("l_shipdate") >= F.lit(lo))
            & (F.col("l_shipdate") < F.lit(hi))
            & (F.col("l_discount") >= F.lit(0.05))
            & (F.col("l_discount") <= F.lit(0.07))
            & (F.col("l_quantity") < F.lit(24.0)))
    return [
        pred,
        F.col("l_shipdate") >= F.lit(lo),
        F.col("l_quantity") < F.lit(24.0),
        F.col("l_discount") <= F.lit(0.07),
        F.col("l_discount") == F.col("l_discount"),       # NaN == NaN
        F.col("l_quantity") > F.col("l_discount"),
        F.col("l_extendedprice") * F.col("l_discount"),
        F.lit(1.0) - F.col("l_discount"),
        F.col("l_extendedprice") * (F.lit(1.0) - F.col("l_discount")),
        F.col("l_orderkey") * F.col("l_linenumber"),      # int64 * int32
        F.col("l_orderkey") - F.lit(7),
        F.col("l_linenumber") + F.col("l_linenumber"),
    ]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_q6_expressions_equal_reference(seed):
    table = _batch(5000, seed)
    ref = RefBatch.from_arrow(table)
    assert ref.padded_len > ref.num_rows          # padding rows ride along
    ref_out = RefProjector([e.expr for e in _exprs(RF)], ref.schema).run(ref)
    cols = [{"data": np.asarray(c.data), "validity": np.asarray(c.validity)}
            for c in ref.columns]
    schema = Schema([StructField(f.name, from_arrow(f.type), True)
                     for f in table.schema])
    port = batch_from_reference(cols, schema, "cpu", ref.num_rows)
    exprs = [e.expr for e in _exprs(PF)]
    port_out = DeviceProjector(exprs, schema).run(port)
    for e, r, p in zip(exprs, ref_out, port_out):
        rv = np.asarray(r.validity)
        pv = p.validity.numpy()
        np.testing.assert_array_equal(pv, rv, err_msg=f"{e} validity")
        rd = np.asarray(r.data)
        pd_ = p.data.numpy()
        assert pd_.dtype == rd.dtype, e
        if rd.dtype.kind == "f":         # exact, bit for bit
            rd, pd_ = rd.view(np.int64), pd_.view(np.int64)
        np.testing.assert_array_equal(pd_[rv], rd[rv], err_msg=str(e))
