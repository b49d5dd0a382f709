"""Helpers for the tests that hold the port's slice 9a (math, date, cast,
conditional, statistics and hash functions, rand, range and sample) to
the JAX package: one query built twice, once with each package's
functions and expression classes, over the same Arrow table; the
reference with its optimizer off (its device path, XLA on the CPU), the
port on ``"cpu"``. Results compare through ``harness._assert_frames_equal``.
"""
from __future__ import annotations

import types

import numpy as np
import pyarrow as pa

from harness import _assert_frames_equal, _canon
from spark_rapids_tpu import exprs as RE
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.exprs import datetime_fns as RDT
from spark_rapids_tpu.exprs import hash_fns as RH
from spark_rapids_tpu.exprs import nondeterministic as RND
from spark_rapids_tpu_torch import exprs as PE
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exprs import datetime_fns as PDT
from spark_rapids_tpu_torch.exprs import hash_fns as PH
from spark_rapids_tpu_torch.exprs import nondeterministic as PND

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}


def _classes(*mods):
    ns = {}
    for m in mods:
        ns.update({k: v for k, v in vars(m).items() if not k.startswith("_")})
    return types.SimpleNamespace(**ns)


#: (functions, expression classes) of each package
REF = (RF, _classes(RE, RDT, RH, RND))
PORT = (PF, _classes(PE, PDT, PH, PND))


def sessions(conf=None):
    """(reference session, port session on the CPU)."""
    conf = {**OFF, **(conf or {})}
    return TpuSession(conf), TorchSession(conf, device="cpu")


def run_both(table: pa.Table, build=None, conf=None, sql=None,
             batch_rows=None):
    """``build(df, F, E)`` over ``table`` on both packages (or, with
    ``sql``, that text over ``table`` as the view ``t``): (reference
    result, port result), each an Arrow table. ``batch_rows`` cuts the
    scan into batches of that many rows."""
    if batch_rows is not None:
        conf = {**(conf or {}),
                "spark.rapids.tpu.sql.batchSizeRows": batch_rows,
                "spark.rapids.tpu.sql.agg.wideBatchRows": batch_rows}
    out = []
    for s, (F, E) in zip(sessions(conf), (REF, PORT)):
        df = s.create_dataframe(table)
        if sql is not None:
            df.create_or_replace_temp_view("t")
            out.append(s.sql(sql).collect_arrow())
        else:
            out.append(build(df, F, E).collect_arrow())
    return out[0], out[1]


def column(t: pa.Table, name: str):
    """(values as float64 or their own type, null mask) of a column; a
    NULL is apart from a NaN here, as pandas would not keep it."""
    c = t.column(name).combine_chunks()
    nulls = np.asarray(c.is_null())
    return c.to_numpy(zero_copy_only=False), nulls


def frames_equal(got: pa.Table, want: pa.Table, ignore_order: bool = False,
                 approx: bool = False) -> None:
    """The names, the row order (unless ``ignore_order``), the null masks
    (NULL and NaN apart) and the values equal (floats within harness's
    relative 1e-9 with ``approx``, else exactly)."""
    assert got.column_names == want.column_names, (got.column_names,
                                                   want.column_names)
    if not ignore_order:
        for n in want.column_names:
            assert (column(got, n)[1] == column(want, n)[1]).all(), n
    _assert_frames_equal(_canon(got.to_pandas(), ignore_order),
                         _canon(want.to_pandas(), ignore_order), approx)


def within_ulps(got, want, ulps: int, what: str = "") -> None:
    """Equal NaNs and infinities; finite values within ``ulps`` units in
    the last place of the reference's value. ``got``/``want``: float
    arrays (the caller compares null masks)."""
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    assert (np.isnan(g) == np.isnan(w)).all(), what
    inf = np.isinf(w)
    assert (g[inf] == w[inf]).all(), what
    fin = np.isfinite(w)
    gap = np.abs(g[fin] - w[fin])
    bad = gap > ulps * np.spacing(np.abs(w[fin]))
    assert not bad.any(), (what, g[fin][bad][:5], w[fin][bad][:5])
