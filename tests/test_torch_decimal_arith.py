"""The decimal_arith kernel's row logic (csrc/decimal_arith_row.cuh, built
by g++ and run row by row as the kernel runs it) and its plain version
(``exprs/decimal_arith.py:decimal_arith_reference``), each held to exact
answers computed with Python integers and the ``decimal`` module under
ROUND_HALF_UP at precision 76: Spark's decimal add and subtract (at the
larger scale, then rounded where precision is lost), remainder, multiply,
divide (rounded at scale 38, then at the result's scale), rescale,
average and ``BigDecimal.doubleValue``, over random and edge operands (zero, +-1,
INT64_MIN and INT64_MAX, -1 divisors, ties, results at their precision's
edge). Doubles compare bit for bit."""
from __future__ import annotations

import ctypes
import decimal
import shutil
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from spark_rapids_tpu_torch.exprs.decimal_arith import (
    DEC_LIMB, OPS, decimal_arith, decimal_arith_reference)

CSRC = Path(__file__).resolve().parents[1] / "spark_rapids_tpu_torch" / "csrc"
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1
CTX = decimal.Context(prec=76, rounding=decimal.ROUND_HALF_UP)

_HOST_SRC = r"""
#include <cstdint>
#include "decimal_arith_row.cuh"

// The kernel on the host: every row through da_row, invalid rows 0.
extern "C" void da_host(int op, const int64_t* a, const int64_t* b,
                        const int64_t* c, const int64_t* d, int64_t n,
                        int k, int t, int m, int p, int64_t* out,
                        uint8_t* ok) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = 0;
    bool v = da_row(op, a[i], b ? b[i] : 0, c ? c[i] : 0, d ? d[i] : 0,
                    k, t, m, p, &r);
    out[i] = v ? r : 0;
    ok[i] = v ? 1 : 0;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("decimal_arith_host")
    src = d / "da_host.cpp"
    src.write_text(_HOST_SRC)
    lib = d / "libda_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    lib.da_host.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_int64,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, p, p]
    return lib


# ---------------------------------------------------------------------------
# exact answers
# ---------------------------------------------------------------------------

def _half_up(n: int, d: int) -> int:
    """n / d rounded HALF_UP, n >= 0, d > 0."""
    q, r = divmod(n, d)
    return q + (2 * r >= d)


def _finish(mag: int, neg: bool, p: int):
    lim = min(10 ** p - 1, 2 ** 63 if neg else 2 ** 63 - 1)
    if mag > lim:
        return None
    return -mag if neg else mag


def want_mul(l, r, k, p):
    # the decimal module: the exact product (at most 38 digits) quantized
    prod = CTX.multiply(decimal.Decimal(l), decimal.Decimal(r))
    q = prod.scaleb(-k, CTX).quantize(decimal.Decimal(1), context=CTX) \
        if k > 0 else prod.scaleb(-k, CTX)
    return _finish(abs(int(q)), q < 0, p)


def want_div(l, r, e, t, p):
    if r == 0:
        return None
    num = abs(l) * 10 ** max(e, 0)
    den = abs(r) * 10 ** max(-e, 0)
    q38 = _half_up(num * 10 ** t, den)          # Spark: scale 38 first
    q = _half_up(q38, 10 ** t) if t > 0 else q38
    return _finish(q, (l < 0) != (r < 0) and q != 0, p)


def want_rescale(x, k, p):
    if k >= 0:
        return _finish(abs(x) * 10 ** k, x < 0, p)
    q = decimal.Decimal(x).scaleb(k, CTX).quantize(decimal.Decimal(1),
                                                   context=CTX)
    return _finish(abs(int(q)), q < 0, p)


def want_avg(l0, l1, l2, count, e, t, m, p):
    if count <= 0 or abs(l2) >= 2 ** 40:
        return None
    total = (l2 * DEC_LIMB + l1) * DEC_LIMB + l0
    n = abs(total) * 10 ** e
    if n >= 2 ** 128:
        return None
    q38 = _half_up(n * 10 ** t, count)          # Spark's Divide, scale 38
    q = _half_up(q38, 10 ** t) if t > 0 else q38
    q = _half_up(q, 10 ** m) if m > 0 else q * 10 ** -m   # the cast
    return _finish(q, total < 0, p)


def want_add(l, r, kl, kr, m, p, sub=False):
    exact = l * 10 ** kl + (-r if sub else r) * 10 ** kr
    return _finish(_half_up(abs(exact), 10 ** m), exact < 0, p)


def want_rem(l, r, kl, kr, p):
    if r == 0:
        return None
    a, b = abs(l) * 10 ** kl, abs(r) * 10 ** kr
    return _finish(a % b, l < 0, p)


def want_double(x, s):
    return float(Fraction(x, 10 ** s))


# ---------------------------------------------------------------------------
# the two implementations
# ---------------------------------------------------------------------------

def _host(lib, op, cols, k=0, t=0, p=38, m=0):
    cols = [np.ascontiguousarray(np.asarray(c, np.int64)) for c in cols]
    n = len(cols[0])
    out = np.zeros(n, np.int64)
    ok = np.zeros(n, np.uint8)
    ptrs = [c.ctypes.data for c in cols] + [None] * (4 - len(cols))
    lib.da_host(OPS[op], *ptrs, n, k, t, m, p, out.ctypes.data,
                ok.ctypes.data)
    return out, ok.astype(bool)


def _plain(op, cols, k=0, t=0, p=38, m=0):
    ts = [torch.tensor(np.asarray(c, np.int64)) for c in cols]
    valid = torch.ones(len(cols[0]), dtype=torch.bool)
    out, ok = decimal_arith_reference(op, ts, valid, k, t, m, p)
    return out.numpy(), ok.numpy()


def _both(lib, op, cols, want, k=0, t=0, p=38, double=False, m=0):
    """Both implementations against ``want`` (None for NULL) row by row;
    doubles as their bits."""
    for name, (out, ok) in (("host", _host(lib, op, cols, k, t, p, m)),
                            ("plain", _plain(op, cols, k, t, p, m))):
        if double:
            got = out.view(np.float64)
            for i, w in enumerate(want):
                assert ok[i] and got[i] == w and \
                    np.signbit(got[i]) == np.signbit(w), \
                    (name, op, [c[i] for c in cols], k, got[i], w)
            continue
        for i, w in enumerate(want):
            assert (w is None) == (not ok[i]), \
                (name, op, [c[i] for c in cols], k, t, p, out[i], w)
            if w is not None:
                assert out[i] == w, (name, op, [c[i] for c in cols], k, t,
                                     p, out[i], w)


EDGE = [0, 1, -1, 2, -2, 5, -5, 49, 50, -50, 99, 10 ** 9, -10 ** 9,
        10 ** 18 - 1, -(10 ** 18 - 1), 10 ** 18, I64_MAX, I64_MIN,
        I64_MIN + 1, 2 ** 53, 2 ** 53 + 1, -(2 ** 53 + 1), 123456789012345]
i64 = st.one_of(st.sampled_from(EDGE),
                st.integers(min_value=I64_MIN, max_value=I64_MAX),
                st.integers(min_value=-10 ** 6, max_value=10 ** 6))
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


rows2 = st.lists(st.tuples(i64, i64), min_size=1, max_size=24)


@SETTINGS
@given(rows=rows2, k=st.integers(0, 40), p=st.integers(1, 38))
def test_mul_matches_python_decimal(host_lib, rows, k, p):
    cols = [[a for a, _ in rows], [b for _, b in rows]]
    want = [want_mul(a, b, k, p) for a, b in rows]
    _both(host_lib, "mul", cols, want, k=k, p=p)


@SETTINGS
@given(rows=rows2, e=st.integers(-40, 40), s_out=st.integers(0, 38),
       p=st.integers(1, 38))
def test_div_matches_spark_two_roundings(host_lib, rows, e, s_out, p):
    cols = [[a for a, _ in rows], [b for _, b in rows]]
    t = 38 - s_out
    want = [want_div(a, b, e, t, p) for a, b in rows]
    _both(host_lib, "div", cols, want, k=e, t=t, p=p)


@SETTINGS
@given(xs=st.lists(i64, min_size=1, max_size=24),
       k=st.integers(-40, 40), p=st.integers(1, 38))
def test_rescale_matches_python_decimal(host_lib, xs, k, p):
    _both(host_lib, "rescale", [xs], [want_rescale(x, k, p) for x in xs],
          k=k, p=p)


@SETTINGS
@given(rows=rows2, k=st.integers(0, 38), left=st.booleans(),
       m=st.integers(0, 32), p=st.integers(1, 38), sub=st.booleans())
def test_add_matches_python_integers(host_lib, rows, k, left, m, p, sub):
    """One side rescaled up ``k`` digits (past 2^128 for the larger k),
    then ``m`` digits lower: ties of either sign, and sums whose sides
    nearly cancel."""
    kl, kr = (k, 0) if left else (0, k)
    cols = [[a for a, _ in rows], [b for _, b in rows]]
    want = [want_add(a, b, kl, kr, m, p, sub) for a, b in rows]
    _both(host_lib, "sub" if sub else "add", cols, want, k=kl, t=k - kl,
          p=p, m=m)


@SETTINGS
@given(rows=rows2, k=st.integers(0, 38), left=st.booleans(),
       p=st.integers(1, 38))
def test_rem_matches_python_integers(host_lib, rows, k, left, p):
    kl, kr = (k, 0) if left else (0, k)
    cols = [[a for a, _ in rows], [b for _, b in rows]]
    want = [want_rem(a, b, kl, kr, p) for a, b in rows]
    _both(host_lib, "rem", cols, want, k=kl, t=kr, p=p)


limb = st.integers(min_value=0, max_value=DEC_LIMB - 1)
high = st.one_of(st.integers(-3, 3), st.integers(-10 ** 7, 10 ** 7),
                 st.sampled_from([2 ** 40, -2 ** 40, 2 ** 40 - 1]))
count = st.one_of(st.integers(-1, 5), st.integers(1, I64_MAX))


@SETTINGS
@given(rows=st.lists(st.tuples(limb, limb, high, count), min_size=1,
                     max_size=16),
       e=st.integers(0, 30), t=st.integers(0, 32), m=st.integers(-6, 30),
       p=st.integers(1, 38))
def test_avg_matches_spark_divide_then_cast(host_lib, rows, e, t, m, p):
    cols = [list(c) for c in zip(*rows)]
    want = [want_avg(*r, e, t, m, p) for r in rows]
    _both(host_lib, "avg", cols, want, k=e, t=t, p=p, m=m)


@SETTINGS
@given(xs=st.lists(i64, min_size=1, max_size=24), s=st.integers(0, 38))
def test_to_double_is_correctly_rounded(host_lib, xs, s):
    _both(host_lib, "to_double", [xs], [want_double(x, s) for x in xs],
          k=s, double=True)


def test_ties_and_edges(host_lib):
    """HALF_UP of negative ties rounds away from zero; -1 divisors of
    INT64_MIN; a product that fits 128 bits whose result passes int64; the
    second rounding of a division carried by the first; doubles at ties
    past 2^53."""
    _both(host_lib, "mul", [[5, -5, 15, -15, 25], [1, 1, 1, 1, -1]],
          [1, -1, 2, -2, -3], k=1, p=38)
    _both(host_lib, "mul", [[I64_MAX, I64_MIN], [I64_MAX, 2]],
          [None, None], k=0, p=38)
    _both(host_lib, "div", [[I64_MIN, I64_MIN, 7], [-1, 1, -2]],
          [None, I64_MIN, -4], k=0, t=38, p=38)
    # 1/3 at scale 1, one digit past the result's: 0.3(3) -> 0.3
    _both(host_lib, "div", [[1, 2], [3, 3]], [3, 7], k=1, t=37, p=38)
    # a fraction of 0.4999... whose 38-digit rounding reaches 0.5
    n, d = 10 ** 20 - 1, 2 * 10 ** 20
    want = want_div(n, d, 0, 19, 38)
    assert want == 1 and _half_up(n, d) == 0
    _both(host_lib, "div", [[n // 10 ** 9], [d // 10 ** 9]],
          [want_div(n // 10 ** 9, d // 10 ** 9, 0, 19, 38)], k=0, t=19,
          p=38)
    _both(host_lib, "rescale", [[15, -15, 25, -25, 14]], [2, -2, 3, -3, 1],
          k=-1, p=38)
    # decimal(38,0) + decimal(38,10) at (38,6): 10^12 + 1.0000005 and its
    # negative (ties), 7 - 0.0000005001, 4 + 10^-38 past 2^128 at scale 38, and
    # 10^19 - 9.2e18 whose left side alone passes int64
    _both(host_lib, "add", [[10 ** 12, -10 ** 12, 7],
                            [10 ** 10 + 5000, -10 ** 10 - 5000, -5001]],
          [10 ** 18 + 10 ** 6 + 1, -10 ** 18 - 10 ** 6 - 1, 7000000 - 1],
          k=10, t=0, m=4, p=38)
    _both(host_lib, "add", [[4], [1]], [4 * 10 ** 6], k=38, t=0, m=32,
          p=38)
    _both(host_lib, "sub", [[1, 10 ** 18], [9 * 10 ** 18, I64_MIN]],
          [10 ** 19 - 9 * 10 ** 18, None], k=19, t=0, m=0, p=38)
    # remainders with the dividend's sign, past 2^128 on either side
    _both(host_lib, "rem", [[I64_MIN, 7, -7, 5], [-3, 10 ** 18, 3, 0]],
          [want_rem(I64_MIN, -3, 30, 0, 38), want_rem(7, 10 ** 18, 30, 0,
                                                      38),
           want_rem(-7, 3, 30, 0, 38), None], k=30, t=0, p=38)
    _both(host_lib, "rem", [[-123456789, I64_MAX], [7, 3]],
          [-123456789, I64_MAX], k=0, t=38, p=38)
    xs = [2 ** 53 + 1, -(2 ** 53 + 1), 2 ** 63 - 1, I64_MIN, 3 * 2 ** 60 + 5]
    for s in (0, 1, 2, 17, 19, 23, 38):
        _both(host_lib, "to_double", [xs], [want_double(x, s) for x in xs],
              k=s, double=True)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version, counts no launch,
    and applies both validities."""
    before = decimal_arith.launches
    l = torch.tensor([6, 7, 8], dtype=torch.int64)
    r = torch.tensor([2, 0, 4], dtype=torch.int64)
    lv = torch.tensor([True, True, False])
    rv = torch.tensor([True, True, True])
    out, ok = decimal_arith("div", (l, r), lv, rv, k=0, t=38, p=38)
    assert out.tolist() == [3, 0, 0] and ok.tolist() == [True, False, False]
    assert decimal_arith.launches == before
    with pytest.raises(TypeError):
        decimal_arith("mul", (l.to(torch.int32), r), lv)
