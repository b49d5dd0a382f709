"""LIKE of any pattern and RLIKE (slice 7's patterns) in the port, on the
CPU.

* The port's copy of the Java-regex transpiler gives the JAX package's
  output on a corpus of patterns (``$`` and ``\\Z`` aside: the copy keeps
  Java's rule between a final ``\\r`` and ``\\n``, ROADMAP.md Queue C).
* The DFA (exprs/regex_dfa.py) through the plain version of the
  ``rect_dfa`` kernel equals Python's ``re`` with the transpiled pattern
  (LIKE: ``re.DOTALL`` and ``fullmatch``, Spark's rule) over random
  ASCII strings drawn by hypothesis, with ``\\n``, ``\\r``, NULLs and
  empty strings.
* The kernel's row logic (``csrc/rect_dfa_row.cuh``), built with g++ and
  run row by row as the kernel's threads run it (junk past each row's
  length), equals the plain version.
* LIKE and RLIKE against the JAX package (optimizer off: its device path)
  over a byte rectangle and a dictionary column, at default and 3-row
  batches, in filters and projections, over a chain and as SQL LIKE;
  where the JAX package departs from Spark (a newline under ``_`` and
  ``%``; ``lit$`` before a final newline) the port is held to Spark.
* Every refused pattern raises ``NotImplementedError`` naming slice 7.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from harness import _assert_frames_equal, _canon
from spark_rapids_tpu.api import TpuSession
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.exprs import regex_transpiler as ref_tx
from spark_rapids_tpu_torch.api import TorchSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.exec.rect_dfa import (rect_dfa,
                                                  rect_dfa_reference)
from spark_rapids_tpu_torch.exprs import regex_dfa as RD
from spark_rapids_tpu_torch.exprs import regex_transpiler as port_tx
from spark_rapids_tpu_torch.native import CSRC

from test_torch_slice import prebuild_reference_native

OFF = {"spark.rapids.tpu.sql.optimizer.enabled": False}


@pytest.fixture(autouse=True, scope="module")
def _reference_native_built():
    prebuild_reference_native()


#: RLIKE patterns the DFA takes: anchors, classes, alternation, bounded
#: repeats, (?i), (?s), \b, \B, \d \w \s, $ \Z \z, escapes, POSIX classes
RLIKE_PATTERNS = [
    "^[a-z]+ (pending|final) ", "(ly|ing)$", "[0-9]{2,}", "", "a",
    "a\\b", "(?i)ab.c", "\\bfoo\\b", "x\\r$", "^$", "a|b$", "a.c",
    "(?s)a.c", "[^a-c]+x", "a{2,3}b?", "\\d+\\s\\w", "(?i)[a-c]x|Y\\z",
    "colou?r", "^\\s*$", "ab\\Z", "\\b", "o\\b|\\bx", "\\n$", "\\r$",
    "$", "\\z", "^\\r?\\n?$", "a*?b+?", "(a|)+b", "\\p{Alpha}+1",
    "(?i)\\p{Lower}", "\\x61\\u0062", "[a-]x", "[]a]", "[^]a]",
    "(?i)special.*requests", "[[:alpha:]]", "(?:ab|cd){2}", "^.{3}$",
    "\\W\\S", "\\.\\*", "[\\d-]+", "\\t|\\x0b",
]

#: LIKE patterns: _, %, the escape character, inner %
LIKE_PATTERNS = [
    "%special%requests%", "%Customer%Complaints%", "a_c%", "_", "%", "",
    "a\\%b", "%a_", "a\\_", "\\\\%", "ab\\", "a%b%c", "%\\%%", "__",
    "%_%_%",
]

#: the strings' alphabet: letters of both cases, digits, the anchors'
#: terminators, spaces, and the patterns' metacharacters
ALPHA = "abcoxyfY ABC12_%\\.*-\n\r\t]"


def _rect(strings, valid=None, width=None):
    """(uint8[P, W], int32[P], bool[P]) of ASCII strings, zero past each
    length; W the next power of two (at least 8)."""
    enc = [s.encode("ascii") for s in strings]
    w = width or max(8, 1 << max(0, max((len(b) for b in enc), default=1)
                                 - 1).bit_length())
    rect = np.zeros((len(enc), w), np.uint8)
    lens = np.zeros(len(enc), np.int32)
    for i, b in enumerate(enc):
        rect[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    v = np.ones(len(enc), bool) if valid is None else np.asarray(valid)
    lens[~v] = 0
    rect[~v] = 0
    return rect, lens, v


def _dfa_of(kind: str, pattern: str):
    if kind == "rlike":
        rx = re.compile(port_tx.transpile_java_regex(pattern), re.ASCII)
        return RD.compile_rlike(pattern), lambda s: rx.search(s) is not None
    rx = re.compile(port_tx.sql_like_to_regex(pattern), re.DOTALL)
    return RD.compile_like(pattern), lambda s: rx.fullmatch(s) is not None


# ---------------------------------------------------------------------------
# the transpiler copy
# ---------------------------------------------------------------------------

TRANSPILE_CORPUS = RLIKE_PATTERNS + [
    "\\p{Digit}{3}", "(?<n>ab)c", "a(?=b)", "a(?!b)", "(?<=a)b", "a++",
    "(?>ab)", "\\0101", "\\R", "[a[bc]]", "\\Bx", "(?i)x(?:y|z)",
]


@pytest.mark.parametrize("pattern", TRANSPILE_CORPUS)
def test_transpiler_copy_gives_the_reference_output(pattern):
    """The copy's Python output is the JAX package's (its ``target=
    "python"``), but for ``$``/``\\Z``: the copy's lookahead keeps a
    final lone ``\\n`` only where no ``\\r`` precedes it."""
    try:
        want = ref_tx.transpile_java_regex(pattern, target="python")
    except ref_tx.RegexUnsupported:
        with pytest.raises(port_tx.RegexUnsupported):
            port_tx.transpile_java_regex(pattern)
        return
    got = port_tx.transpile_java_regex(pattern)
    assert got == want.replace(ref_tx._END_Z, port_tx._END_Z)
    assert port_tx.sql_like_to_regex(pattern) == \
        ref_tx.sql_like_to_regex(pattern)


def test_dollar_follows_java_between_a_final_cr_and_lf():
    """Java's ``$`` does not match between the ``\\r`` and ``\\n`` of a
    final ``\\r\\n`` (``Pattern.Dollar``); the JAX package's lookahead
    does (ROADMAP.md Queue C)."""
    port = re.compile(port_tx.transpile_java_regex("a\\r$"))
    ref = re.compile(ref_tx.transpile_java_regex("a\\r$", target="python"))
    assert ref.search("a\r\n") and not port.search("a\r\n")
    assert not RD.dfa_match(RD.compile_rlike("a\\r$"), b"a\r\n")
    for s in ("a\r", "a\r\r\n", "xa\r\n\n"):
        assert bool(port.search(s)) == RD.dfa_match(
            RD.compile_rlike("a\\r$"), s.encode())


# ---------------------------------------------------------------------------
# the DFA's plain version against Python's re
# ---------------------------------------------------------------------------

_STRINGS = st.lists(st.one_of(st.none(), st.text(alphabet=ALPHA,
                                                   max_size=20)),
                    min_size=1, max_size=40)


@pytest.mark.parametrize("kind,pattern",
                         [("rlike", p) for p in RLIKE_PATTERNS]
                         + [("like", p) for p in LIKE_PATTERNS])
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(strings=_STRINGS)
def test_plain_dfa_equals_python_re(kind, pattern, strings):
    dfa, match = _dfa_of(kind, pattern)
    valid = [s is not None for s in strings]
    rect, lens, v = _rect([s or "" for s in strings], valid)
    got = rect_dfa(torch.from_numpy(rect), torch.from_numpy(lens),
                   torch.from_numpy(v), dfa).numpy()
    want = [ok and match(s) for s, ok in zip(strings, valid)]
    # Python's \B never matches an empty string; Java's does
    if "\\B" in pattern:
        want = [w or (ok and s == "") for w, s, ok in
                zip(want, strings, valid)]
    assert got.tolist() == want, (pattern, strings)
    assert [RD.dfa_match(dfa, (s or "").encode()) and ok
            for s, ok in zip(strings, valid)] == want


def test_like_underscore_and_percent_take_a_newline():
    """Spark compiles LIKE with DOTALL; the JAX package's regex engine
    stops ``_`` and ``%`` at a newline (ROADMAP.md Queue C)."""
    rows = ["a\nb", "a\nxb", "ab", "a\n"]
    for pat, want in (("a_b", [True, False, False, False]),
                      ("a%b", [True, True, True, False]),
                      ("a%", [True, True, True, True])):
        dfa = RD.compile_like(pat)
        assert [RD.dfa_match(dfa, r.encode()) for r in rows] == want
    t = pa.table({"s": pa.array(rows)})
    got = TorchSession(OFF, device="cpu").create_dataframe(t).select(
        PF.col("s").like("a_b").alias("m")).collect()
    assert [r["m"] for r in got] == [True, False, False, False]
    ref = TpuSession(OFF).create_dataframe(t).select(
        RF.col("s").like("a_b").alias("m")).to_pandas()
    assert list(ref["m"]) == [False, False, False, False]


def test_case_folding_is_ascii_as_java_and_boundaries_hold_on_empty():
    """Over a dictionary each entry is matched by Python's ``re`` with
    Java's default folding, ASCII only (the JAX package's RE2 folds
    Unicode: ROADMAP.md Queue C); the empty entry goes through the DFA,
    so ``\\B`` matches it on both layouts as in Java."""
    t = pa.table({"s": pa.array(["É", "é", "E", "", "x"] * 40)})
    port = TorchSession(OFF, device="cpu").create_dataframe(t)
    got = port.select(PF.col("s").rlike("(?i)é").alias("a"),
                      PF.col("s").rlike("\\B").alias("b")).collect()[:5]
    assert [r["a"] for r in got] == [False, True, False, False, False]
    assert [r["b"] for r in got] == [True, True, False, True, False]
    t2 = pa.table({"s": pa.array(["", "ab"] + [f"w{i:04d}" for i in
                                             range(2000)])})
    got = TorchSession(OFF, device="cpu").create_dataframe(t2).select(
        PF.col("s").rlike("\\B").alias("b")).collect()[:2]
    assert [r["b"] for r in got] == [True, True]
    ref = TpuSession(OFF).create_dataframe(t).select(
        RF.col("s").rlike("(?i)é").alias("a")).to_pandas()
    assert list(ref["a"])[:2] == [True, True]


def test_rlike_dollar_takes_a_final_newline():
    """``lit$`` matches before one final line terminator (Java); the JAX
    package's rectangle path takes it as endswith (ROADMAP.md Queue C)."""
    rows = ["xab", "xab\n", "xab\r\n", "xab\n\n", "ab"]
    want = [True, True, True, False, True]
    for layout_rows in (rows, rows * 1000 + [f"pad{i:05d}" for i in
                                             range(1000)]):
        t = pa.table({"s": pa.array(layout_rows)})
        got = TorchSession(OFF, device="cpu").create_dataframe(t).select(
            PF.col("s").rlike("ab$").alias("m")).collect()
        assert [r["m"] for r in got[:5]] == want


# ---------------------------------------------------------------------------
# the kernel's row logic, built with g++
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <stdint.h>
#include <string.h>
#include "rect_dfa_row.cuh"

// The kernel's work (rect_dfa.cu) on the host: every row walked as a
// thread walks it, 16-byte chunks loaded whole from the row (bytes past
// its length as the rectangle holds them; 8 bytes for an 8-byte row), a
// NULL row not walked.
extern "C" void rd_rows_host(const uint8_t* bytes, const int32_t* lengths,
                             const uint8_t* validity, int64_t rows,
                             int width, const uint8_t* classes,
                             const uint8_t* table, const uint8_t* accept,
                             int n_classes, int start, int first_sink,
                             uint8_t* out) {
  const RdTables t{classes, table, accept, n_classes, start, first_sink};
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* p = bytes + r * width;
    out[r] = validity[r] &&
             rd_row(t, lengths[r], width, [&](int c, uint32_t(&w)[4]) {
               memset(w, 0, sizeof w);
               memcpy(w, p + 16 * c, width >= 16 ? 16 : 8);
             });
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("rect_dfa_host")
    src = d / "rect_dfa_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "librect_dfa_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    lib.rd_rows_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rd_rows_host.restype = None
    return lib


@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_row_logic_equals_plain_version(host_lib, width):
    """Every pattern of both corpora through the row logic of
    csrc/rect_dfa_row.cuh, junk past each row's length and in NULL rows,
    held to the plain version."""
    rng = np.random.RandomState(width)
    rows = 301
    alpha = np.frombuffer(ALPHA.encode(), np.uint8)
    rect = alpha[rng.randint(0, len(alpha), (rows, width))]
    lens = rng.randint(0, width + 1, rows).astype(np.int32)
    valid = rng.rand(rows) >= 0.1
    clean = np.where(np.arange(width)[None, :] < lens[:, None], rect, 0)
    clean = clean.astype(np.uint8)
    junk = rect.copy()
    plen = np.where(valid, lens, 0).astype(np.int32)
    clean[~valid] = 0
    for kind, pats in (("rlike", RLIKE_PATTERNS), ("like", LIKE_PATTERNS)):
        for pat in pats:
            dfa = _dfa_of(kind, pat)[0]
            want = rect_dfa_reference(
                torch.from_numpy(clean), torch.from_numpy(plen),
                torch.from_numpy(valid), dfa).numpy()
            out = np.zeros(rows, np.uint8)
            tabs = [np.ascontiguousarray(a) for a in
                    (dfa.classes, dfa.table, dfa.accept)]
            host_lib.rd_rows_host(
                junk.ctypes.data, lens.ctypes.data,
                valid.astype(np.uint8).ctypes.data, rows, width,
                *(a.ctypes.data for a in tabs), dfa.n_classes, dfa.start,
                dfa.first_sink, out.ctypes.data)
            np.testing.assert_array_equal(out.astype(bool), want,
                                          err_msg=f"{kind} {pat!r}")


def test_sinks_are_numbered_last_and_absorb():
    for kind, pat in (("like", "%special%requests%"), ("rlike", "^abc"),
                      ("rlike", "[0-9]{2,}")):
        dfa = _dfa_of(kind, pat)[0]
        assert dfa.first_sink < dfa.n_states
        for s in range(dfa.first_sink, dfa.n_states):
            assert (dfa.table[s] == s).all()
        for s in range(dfa.first_sink):
            assert (dfa.table[s] != s).any()
        assert dfa.n_states <= RD.MAX_STATES


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _comment_table(n: int, seed: int) -> pa.Table:
    """``hi``: near-unique comment-like strings (a byte rectangle);
    ``lo``: eight values (a dictionary); NULLs in both; no newline (the
    JAX package stops ``_`` at one)."""
    rng = np.random.RandomState(seed)
    words = ["special", "requests", "Customer", "Complaints", "final",
             "pending", "slyly", "quickly", "regular", "ing", "12", "7"]
    hi = [" ".join(rng.choice(words, rng.randint(1, 5))) + f" {i:04d}"
          for i in range(n)]
    lo = np.array(["AIR", "REG AIR", "MAIL", "SHIP", "TRUCK", "FOB",
                   "RAIL", "x_y%z"])[rng.randint(0, 8, n)]
    return pa.table({
        "hi": pa.array(hi, mask=rng.rand(n) < 0.05),
        "lo": pa.array(lo, mask=rng.rand(n) < 0.05),
        "v": pa.array(rng.randint(0, 100, n)),
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


PATTERN_CASES = [
    ("like", "%special%requests%"), ("like", "%Customer%Complaints%"),
    ("like", "s_ecial%"), ("like", "%x\\_y\\%z"), ("like", "R__%"),
    ("rlike", "^[a-z]+ (pending|final) "), ("rlike", "(ly|ing)$"),
    ("rlike", "[0-9]{2,}"), ("rlike", "^(REG )?AIR$"), ("rlike", ""),
]


def _pred(F, c, kind, pat):
    return c.like(pat) if kind == "like" else c.rlike(pat)


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("kind,pat", PATTERN_CASES)
def test_patterns_equal_reference(kind, pat, batch):
    """In a filter (alone and under NOT) and in a projection, over the
    rectangle and the dictionary column, and over a chain."""
    table = _comment_table(600 if batch is None else 60, 41)
    conf = None if batch is None else {
        "spark.rapids.tpu.sql.batchSizeRows": batch}
    for col in ("hi", "lo"):
        _both(lambda df, F: df.filter(_pred(F, F.col(col), kind, pat))
              .select(col, "v"), table, conf)
        _both(lambda df, F: df.filter(~_pred(F, F.col(col), kind, pat))
              .select("v"), table, conf)
    _both(lambda df, F: df.select(
        _pred(F, F.col("hi"), kind, pat).alias("a"),
        _pred(F, F.col("lo"), kind, pat).alias("b"),
        _pred(F, F.upper(F.col("hi")), kind, pat.upper()).alias("c"),
        _pred(F, F.lower(F.col("lo")), kind, pat.lower()).alias("d"),
        F.col("v")), table, conf)


def test_q13_and_q16_filters_as_dataframe_and_sql_equal_reference():
    table = _comment_table(3000, 13)
    _both(lambda df, F: df.filter(~F.col("hi").like("%special%requests%"))
          .agg(F.count_star().with_name("n"),
               F.sum(F.col("v")).with_name("s")), table)
    _both(lambda df, F: df.filter(F.col("hi").like("%Customer%Complaints%"))
          .agg(F.count_star().with_name("n")), table)
    port = TorchSession(OFF, device="cpu")
    ref = TpuSession(OFF)
    for s in (port, ref):
        s.create_dataframe(table).create_or_replace_temp_view("t")
    for text in ("SELECT count(*) AS n FROM t WHERE hi NOT LIKE "
                 "'%special%requests%'",
                 "SELECT lo, count(*) AS n FROM t WHERE hi LIKE "
                 "'%Customer%Complaints%' GROUP BY lo ORDER BY lo",
                 "SELECT upper(hi) LIKE 'SP_CIAL%' AS m FROM t"):
        got = port.sql(text).collect_arrow().to_pandas()
        want = ref.sql(text).to_pandas()
        _assert_frames_equal(_canon(got, False), _canon(want, False), False)


def test_dfa_route_over_a_rectangle_is_not_gated_by_the_pallas_conf():
    """A DFA pattern over a rectangle goes through ``rect_dfa`` (its plain
    version on the CPU) whatever ``spark.rapids.tpu.sql.pallas.enabled``
    says; a literal one stays on ``rect_match``'s route."""
    import spark_rapids_tpu_torch.exprs.string_rect as SR
    calls = []
    orig = SR.eval_rect_expr

    def spy(e, child, use_kernel=False):
        calls.append(SR.match_form(e)[0])
        return orig(e, child, use_kernel)
    table = _comment_table(600, 3)
    SR.eval_rect_expr = spy
    try:
        for on in (False, True):
            conf = {**OFF, "spark.rapids.tpu.sql.pallas.enabled": on}
            TorchSession(conf, device="cpu").create_dataframe(table).filter(
                PF.col("hi").like("%special%requests%")
                | PF.col("hi").like("%special%")).collect()
    finally:
        SR.eval_rect_expr = orig
    assert calls.count("dfa") == 2 and calls.count("contains") == 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", [
    "(a)\\1", "a(?=b)", "a(?!b)", "(?<=a)b", "(?<!a)b", "a++", "a*+",
    "(?>ab)", "a$b", "a\\Zb", "a\\zb", "(a$)", "(a|b)*a(a|b){20}",
    "\\p{L}", "a{2000}", "(?m)^a", "(?x)a b",
])
def test_refused_patterns_name_slice_7(pattern):
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        RD.compile_rlike(pattern)
    df = TorchSession(OFF, device="cpu").create_dataframe(
        pa.table({"s": pa.array(["ab", "ba"])}))
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        df.filter(PF.col("s").rlike(pattern)).collect()


def test_mended_refusals_name_slice_7():
    """The refusals that named "item 3" name the slice now."""
    from spark_rapids_tpu_torch.exec.rect_transform import _NOT_YET
    assert _NOT_YET == "slice 7, strings, the rest (ROADMAP.md Queue A)"
    vals = np.array([f"é{i:05d}" for i in range(4000)], dtype=object)
    df = TorchSession(OFF, device="cpu").create_dataframe({"m": vals})
    with pytest.raises(NotImplementedError,
                       match=re.escape("slice 7, strings, the rest "
                                       "(ROADMAP.md Queue A)")):
        df.select(PF.lower(PF.col("m")).alias("u")).collect()
    with pytest.raises(NotImplementedError,
                       match="slice 7, strings, the rest"):
        df.filter(PF.col("m").like("%1%")).collect()
