"""The port's slice end to end on the CPU, against the JAX package.

TPC-H q1 and q6 run unmodified from ``benchmarks/tpch.py`` on both
packages, and the comment scan ``q_comment`` runs with the match kernel's
conf on and off on both. Keys, row order and counts are compared exactly;
float sums and averages to a relative 1e-12: the port's reductions and
XLA's add the same values in different orders.
"""
import ast
import fcntl
import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from benchmarks import tpch
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RefBatch
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import (ByteRectColumn, ColumnarBatch,
                                            DictColumn)
from spark_rapids_tpu_torch.columnar.batch import HostTable
from spark_rapids_tpu_torch.exec.dense_groupby import dense_groupby
from spark_rapids_tpu_torch.exprs.rect_match import rect_match

REPO = Path(__file__).resolve().parent.parent
N = 20000
REL = 1e-12
OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}
PALLAS = "spark.rapids.tpu.sql.pallas.enabled"


def prebuild_reference_native() -> None:
    """Build the JAX package's native memory library before its sessions
    are made. The package compiles it with g++ in place, at first use, in
    every process that finds it missing; test workers that start together
    in a fresh checkout then load a file another is still writing ("file
    too short"). Here it is compiled once, under a lock shared by the
    workers, into a temporary file renamed over the target, so that every
    process finds it whole and the package builds nothing."""
    from spark_rapids_tpu.mem import native as ref_native
    src = os.path.abspath(ref_native._SRC)
    so = os.path.abspath(ref_native._SO)
    lock = Path(tempfile.gettempdir()) / (
        "spark_rapids_tpu_oom_state."
        + hashlib.sha256(so.encode()).hexdigest()[:16] + ".lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        if os.path.exists(so) and \
                os.path.getmtime(so) >= os.path.getmtime(src):
            return
        tmp = f"{so}.{os.getpid()}.tmp"
        # the package's own command (spark_rapids_tpu/mem/native.py)
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                        "-pthread", src, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


def _ref(conf=None):
    return TpuSession({**OFF, **(conf or {})})


def _port(conf=None):
    return TorchSession({**OFF, **(conf or {})}, device="cpu")


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture(scope="module")
def lineitem():
    """benchmarks/tpch.py's lineitem plus the generated l_comment."""
    t = tpch.gen_lineitem(N)
    comments = chip_smoke.gen_comment(N)
    return t.append_column("l_comment",
                           pa.array(comments).cast(pa.string())), comments


def _assert_q1_equal(got, want):
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float):
                assert _rel(g[k], v) <= REL, (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("batch_rows", [1 << 20, 3000])
def test_q1_unmodified_equals_reference(lineitem, batch_rows):
    t, _ = lineitem
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    want = tpch.q1(_ref(conf).create_dataframe(t), RF).collect()
    before = dense_groupby.launches
    got = tpch.q1(_port(conf).create_dataframe(t), PF).collect()
    assert dense_groupby.launches == before      # CPU tensors: no launch
    assert len(got) == 6
    _assert_q1_equal(got, want)


def test_q6_unmodified_equals_reference(lineitem):
    t, _ = lineitem
    want = tpch.q6(_ref().create_dataframe(t), RF).collect()
    got = tpch.q6(_port().create_dataframe(t), PF).collect()
    assert len(got) == len(want) == 1
    assert _rel(got[0]["revenue"], want[0]["revenue"]) <= REL


@pytest.mark.parametrize("pallas", [True, False])
def test_q_comment_equals_reference(lineitem, pallas):
    t, _ = lineitem
    conf = {PALLAS: pallas}
    want = chip_smoke.q_comment(_ref(conf).create_dataframe(t), RF).collect()
    before = rect_match.launches
    got = chip_smoke.q_comment(_port(conf).create_dataframe(t),
                               PF).collect()
    assert rect_match.launches == before      # CPU tensors: no launch
    assert got[0]["n"] == want[0]["n"] > 0
    assert _rel(got[0]["revenue"], want[0]["revenue"]) <= REL


#: literal-match forms over one column: (name, builder(F, column))
_FORMS = [
    ("contains", lambda F, c: c.like("%AIR%")),
    ("startswith", lambda F, c: c.startswith("RE")),
    ("endswith", lambda F, c: F.endswith(c, "AIL")),
    ("equals", lambda F, c: c.like("MAIL")),
    ("locate", lambda F, c: F.locate("I", c)),
    ("instr", lambda F, c: F.instr(c, "AI")),
]


@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("form", [f for f, _ in _FORMS])
def test_dictionary_predicates_equal_reference(form, pallas):
    """A low-cardinality column ingests as a dictionary: the predicate is
    matched once per entry and gathered by code. Nulls stay null, and a
    non-ASCII entry is matched by character."""
    build = dict(_FORMS)[form]
    rng = np.random.RandomState(5)
    modes = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "REG AIR", "FOB",
             "ÉAIR", ""]
    vals = [None if rng.rand() < 0.1 else modes[i]
            for i in rng.randint(0, len(modes), 3000)]
    t = pa.table({"m": pa.array(vals, pa.string()),
                  "k": pa.array(np.arange(3000))})
    ingested = ColumnarBatch.from_host(HostTable.from_arrow(t), "cpu", 64)
    assert isinstance(ingested.columns[0], DictColumn)
    conf = {PALLAS: pallas}
    ref_df = _ref(conf).create_dataframe(t)
    port_df = _port(conf).create_dataframe(t)
    want = ref_df.with_column("x", build(RF, RF.col("m"))).collect()
    before = rect_match.launches
    got = port_df.with_column("x", build(PF, PF.col("m"))).collect()
    assert rect_match.launches == before
    assert [r["x"] for r in got] == [r["x"] for r in want]
    assert [r["k"] for r in got] == [r["k"] for r in want]
    assert any(r["x"] for r in got) and any(r["x"] is None for r in got)


def test_predicate_over_non_ascii_rectangle_is_refused():
    """A high-cardinality non-ASCII column is a rectangle whose bytes are
    not characters: the port refuses it rather than evaluate it some
    other way."""
    vals = [f"é{i:05d}AIR" for i in range(4000)]
    host = HostTable.from_dict({"m": np.array(vals, dtype=object)})
    col = ColumnarBatch.from_host(host, "cpu", 64).columns[0]
    assert isinstance(col, ByteRectColumn) and not col.ascii_only
    df = _port().create_dataframe({"m": np.array(vals, dtype=object)})
    with pytest.raises(NotImplementedError, match="strings slice"):
        df.with_column("x", PF.col("m").like("%AIR%")).collect()


def test_comment_ingests_as_byte_rectangle(lineitem):
    t, comments = lineitem
    ref = RefBatch.from_arrow(t.select(["l_comment"]))
    assert type(ref.columns[0]).__name__ == "ByteRectColumn"
    for src in ({"l_comment": comments}, t.select(["l_comment"])):
        host = HostTable.from_dict(src) if isinstance(src, dict) \
            else HostTable.from_arrow(src)
        port = ColumnarBatch.from_host(host, "cpu", 64)
        assert isinstance(port.columns[0], ByteRectColumn)
        assert port.columns[0].width == 64 and port.columns[0].ascii_only


def test_plan_shapes_match_reference_explain(lineitem, capsys):
    t, _ = lineitem
    conf = {PALLAS: True}
    for q in (tpch.q6, chip_smoke.q_comment):
        want = q(_ref(conf).create_dataframe(t), RF).explain()
        got = q(_port(conf).create_dataframe(t), PF).explain()
        assert got == want
    assert "rect_device=['hit']" in got and "fused=[filter]" in got


def test_chip_smoke_copies_equal_the_originals():
    n = 5000
    ref = tpch.gen_lineitem(n)
    copy = chip_smoke.gen_lineitem(n)
    assert list(copy) == ref.column_names
    for name in ref.column_names:
        want = ref.column(name).to_numpy(zero_copy_only=False)
        np.testing.assert_array_equal(copy[name], want, err_msg=name)
    a = tpch.q6(_port().create_dataframe(ref), PF).collect()
    b = chip_smoke.q6(_port().create_dataframe(copy), PF).collect()
    assert a == b
    assert chip_smoke.q6_numpy(copy) == pytest.approx(a[0]["revenue"],
                                                     rel=REL)
    a = tpch.q1(_port().create_dataframe(ref), PF).collect()
    b = chip_smoke.q1(_port().create_dataframe(copy), PF).collect()
    assert a == b
    want = chip_smoke.q1_numpy(copy)
    assert chip_smoke.q1_equal(a, want)
    _assert_q1_equal(a, want)
    t = chip_smoke.gen_table(n)
    hit_n, revenue = chip_smoke.q_comment_numpy(t)
    got = chip_smoke.q_comment(_port().create_dataframe(t), PF).collect()
    assert got[0]["n"] == hit_n and _rel(got[0]["revenue"], revenue) <= REL


def test_comments_follow_the_spec_domain():
    c = chip_smoke.gen_comment(N)
    lens = np.char.str_len(c)
    assert lens.min() >= 10 and lens.max() <= 43
    # near-unique, as TPC-H's: well above the dictionary threshold
    assert len(np.unique(c)) > 0.95 * N
    assert (np.char.find(c, b"special") >= 0).any()


def test_filter_on_a_string_predicate_is_refused(lineitem):
    """A string predicate inside a filter runs on the device over a
    dictionary or an ASCII byte rectangle (tests/test_torch_filter.py);
    over a host string column (here l_comment wider than the rectangle's
    cap) the port, which has no host engine, refuses it."""
    t, _ = lineitem
    df = _port({"spark.rapids.tpu.sql.string.rect.maxBytes": 32}) \
        .create_dataframe(t).filter(
            PF.col("l_comment").contains("special")).agg(PF.count_star())
    with pytest.raises(NotImplementedError, match="strings slice"):
        df.collect()


def test_keyed_query_now_runs(lineitem):
    """A grouped query, refused before the q1 slice, runs and equals the
    reference: a dictionary key through the dense path, a date key
    through the sort path, and a string predicate projected under both."""
    t, _ = lineitem
    for key in ("l_returnflag", "l_shipdate"):
        def q(df, F):
            return (df.with_column("hit",
                                   F.col("l_comment").like("%special%"))
                    .filter(F.col("hit")).group_by(key)
                    .agg(F.count_star().with_name("n"),
                         F.sum(F.col("l_extendedprice")).with_name("rev"))
                    .order_by(key))
        want = q(_ref().create_dataframe(t), RF).collect()
        got = q(_port().create_dataframe(t), PF).collect()
        assert [r[key] for r in got] == [r[key] for r in want]
        assert [r["n"] for r in got] == [r["n"] for r in want]
        assert all(_rel(g["rev"], w["rev"]) <= REL
                   for g, w in zip(got, want))
        assert len(got) > 2


def test_session_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TorchSession().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchSession()


def test_port_and_chip_smoke_import_no_jax():
    mods = [f"spark_rapids_tpu_torch.{p.relative_to(REPO / 'spark_rapids_tpu_torch').with_suffix('').as_posix().replace('/', '.')}"
            for p in sorted((REPO / "spark_rapids_tpu_torch").rglob("*.py"))
            if p.name != "__init__.py"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spark_rapids_tpu', 'pyarrow', 'pandas')]\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted((REPO / "spark_rapids_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "spark_rapids_tpu"}, f
    assert not set(_imported_roots(REPO / "chip_smoke.py")) & {
        "pyarrow", "pandas"}


def test_order_by_with_a_string_payload_whose_last_batch_is_a_rectangle():
    """Fault C1: ORDER BY concatenates batches whose string column
    arrives as dictionaries and, in the short last batch, as a byte
    rectangle; every row comes back in the reference's order."""
    from test_torch_groupby import _short_tail_table
    t = _short_tail_table()
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 500}

    def q(df, F):
        return df.select("k", "s").order_by("k")
    want = q(_ref(conf).create_dataframe(t), RF).collect()
    got = q(_port(conf).create_dataframe(t), PF).collect()
    assert len(got) == 1003
    assert got == want
