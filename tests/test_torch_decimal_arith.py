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
#include <cstring>
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

// The division core on the host, each value as two limbs (low, high).
// path 0: n / d with the divisor's reciprocal built for the row (one limb:
// two 2-by-1 steps; two limbs: one 3-by-2 step); path 1: the same over
// n's low limb alone (da_divrem64); path 2: n / 10^j with the divisor a
// launch's constant, as da_consts makes it for a cast to double of scale
// j (d's low limb is j); path 3: one 2-by-1 step, for n's high limb below
// d < 2^64 (da_divrem_narrow).
extern "C" void da_host_divmod(int path, const uint64_t* n,
                               const uint64_t* d, int64_t rows, uint64_t* q,
                               uint64_t* r) {
  for (int64_t i = 0; i < rows; ++i) {
    const da_u128 nn = ((da_u128)n[2 * i + 1] << 64) | n[2 * i];
    const da_u128 dd = ((da_u128)d[2 * i + 1] << 64) | d[2 * i];
    da_u128 qq, rr;
    if (path == 0) {
      qq = da_divrem(nn, da_divider(dd), &rr);
    } else if (path == 1) {
      qq = da_divrem64((uint64_t)nn, da_divider(dd), &rr);
    } else if (path == 3) {
      qq = da_divrem_narrow(nn, da_divider(dd), &rr);
    } else {
      qq = da_divrem(nn,
                     da_consts(DA_TO_DOUBLE, (int)d[2 * i], 0, 0, 38).down,
                     &rr);
    }
    q[2 * i] = (uint64_t)qq;
    q[2 * i + 1] = (uint64_t)(qq >> 64);
    r[2 * i] = (uint64_t)rr;
    r[2 * i + 1] = (uint64_t)(rr >> 64);
  }
}

// to_double's integer path (da_to_double_int) for each x != 0 at scale s,
// the double's bits
extern "C" void da_host_to_double_int(const int64_t* x, int64_t rows, int s,
                                      int64_t* out) {
  const DaConsts c = da_consts(DA_TO_DOUBLE, s, 0, 0, 38);
  for (int64_t i = 0; i < rows; ++i) {
    const double v = x[i] < 0 ? -da_to_double_int(da_mag(x[i]), c)
                              : da_to_double_int(da_mag(x[i]), c);
    memcpy(out + i, &v, sizeof v);
  }
}

// The reciprocal of each d in [2^63, 2^64)
extern "C" void da_host_recip(const uint64_t* d, int64_t rows, uint64_t* v) {
  for (int64_t i = 0; i < rows; ++i) v[i] = da_recip(d[i]);
}

// One 3-by-2 step (da_div32) over any three-limb n = (n2, n1, n0) with
// n2 < d1 and d = (d1, d0), d1's top bit set: quotient, remainder limbs
extern "C" void da_host_div32(const uint64_t* n, const uint64_t* d,
                              int64_t rows, uint64_t* q, uint64_t* r) {
  for (int64_t i = 0; i < rows; ++i) {
    da_u128 rr;
    q[i] = da_div32(n[3 * i], n[3 * i + 1], n[3 * i + 2], d[2 * i],
                    d[2 * i + 1], da_recip(d[2 * i]), &rr);
    r[2 * i] = (uint64_t)rr;
    r[2 * i + 1] = (uint64_t)(rr >> 64);
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
    lib.da_host_divmod.argtypes = [ctypes.c_int, p, p, ctypes.c_int64, p, p]
    lib.da_host_recip.argtypes = [p, ctypes.c_int64, p]
    lib.da_host_div32.argtypes = [p, p, ctypes.c_int64, p, p]
    lib.da_host_to_double_int.argtypes = [p, ctypes.c_int64, ctypes.c_int,
                                          p]
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


# ---------------------------------------------------------------------------
# the division core (csrc/decimal_arith_row.cuh da_divrem with a row's
# da_divider, da_divrem64, da_divrem_narrow, da_divrem by a launch
# constant, da_div32, da_recip) against Python's divmod
# ---------------------------------------------------------------------------

U64 = 2 ** 64
U128 = 2 ** 128


def _limbs(vals) -> np.ndarray:
    return np.array([[v % U64, v // U64] for v in vals], np.uint64).ravel()


def _divmod_core(lib, path: int, ns, ds):
    """(quotients, remainders) of the core's ``path`` as Python ints."""
    n, d = _limbs(ns), _limbs(ds)
    q, r = np.zeros_like(n), np.zeros_like(n)
    lib.da_host_divmod(path, n.ctypes.data, d.ctypes.data, len(ns),
                       q.ctypes.data, r.ctypes.data)
    back = [int(lo) + int(hi) * U64 for lo, hi in
            zip(q[0::2].tolist(), q[1::2].tolist())], \
        [int(lo) + int(hi) * U64 for lo, hi in
         zip(r[0::2].tolist(), r[1::2].tolist())]
    return back


def _hold_divmod(lib, ns, ds):
    """Every path that takes these operands equals divmod: the row's own
    reciprocal always, the one-limb dividend where n < 2^64, the launch
    constant where d is a power of ten."""
    want = [divmod(n, d) for n, d in zip(ns, ds)]
    got = _divmod_core(lib, 0, ns, ds)
    for i, (n, d) in enumerate(zip(ns, ds)):
        assert (got[0][i], got[1][i]) == want[i], ("row reciprocal", n, d)
    narrow = [i for i, (n, d) in enumerate(zip(ns, ds))
              if d < U64 and n // U64 < d]
    if narrow:
        got = _divmod_core(lib, 3, [ns[i] for i in narrow],
                           [ds[i] for i in narrow])
        for j, i in enumerate(narrow):
            assert (got[0][j], got[1][j]) == want[i], ("narrow", ns[i],
                                                       ds[i])
    small = [i for i, n in enumerate(ns) if n < U64]
    if small:
        got = _divmod_core(lib, 1, [ns[i] for i in small],
                           [ds[i] for i in small])
        for j, i in enumerate(small):
            assert (got[0][j], got[1][j]) == want[i], ("64-bit", ns[i],
                                                       ds[i])
    pows = [i for i, d in enumerate(ds) if d in POW10]
    if pows:
        got = _divmod_core(lib, 2, [ns[i] for i in pows],
                           [POW10[ds[i]] for i in pows])
        for j, i in enumerate(pows):
            assert (got[0][j], got[1][j]) == want[i], ("constant", ns[i],
                                                       ds[i])


#: 10^j -> j, j in [0, 38]
POW10 = {10 ** j: j for j in range(39)}
#: the divisors held on their edges: 1, 2, every power of ten a decimal
#: takes, both sides of 2^64, 2^63 and 2^127 - 1
EDGE_DIVISORS = sorted({1, 2, 2 ** 63, U64 - 1, U64, 2 ** 127 - 1}
                       | set(POW10))


@pytest.mark.parametrize("d", EDGE_DIVISORS)
def test_division_core_on_divisor_edges(host_lib, d):
    """n = d q + d - 1 (the largest remainder) across the quotient's
    range, n whose high limb is d - 1 (for d < 2^64: the first 2-by-1 step
    at its bound), and 0, d - 1, d, 2^64 +- 1 and 2^128 - 1."""
    rng = np.random.RandomState(d % 1000003)
    top = (U128 - 1) // d
    qs = {0, 1, 2, top, max(top - 1, 0), top // 2, top // 3}
    qs |= {int(rng.randint(0, 2 ** 62)) % (top + 1) for _ in range(8)}
    qs |= {(int(rng.randint(0, 2 ** 62)) << 64 | int(rng.randint(0, 2 ** 62)))
           % (top + 1) for _ in range(8)}
    ns = {d * q + d - 1 for q in qs if d * q + d - 1 < U128}
    ns |= {0, d - 1, d, U64 - 1, U64, U64 + 1, U128 - 1}
    if d < U64:
        ns |= {(d - 1) * U64 + x for x in (0, 1, U64 - 1,
                                           int(rng.randint(0, 2 ** 62)))}
    ns = sorted(n for n in ns if 0 <= n < U128)
    _hold_divmod(host_lib, ns, [d] * len(ns))


u128 = st.one_of(st.integers(0, U128 - 1), st.integers(0, U64 - 1),
                 st.integers(0, 2 ** 70), st.sampled_from(
                     [0, 1, U64 - 1, U64, U128 - 1, 2 ** 127, 2 ** 127 - 1]))
divisor = st.one_of(st.integers(1, U128 - 1), st.integers(1, U64 - 1),
                    st.integers(1, 2 ** 20), st.integers(U64, 2 ** 80),
                    st.sampled_from(EDGE_DIVISORS))


@SETTINGS
@given(rows=st.lists(st.tuples(u128, divisor), min_size=1, max_size=32))
def test_division_core_matches_python_divmod(host_lib, rows):
    _hold_divmod(host_lib, [n for n, _ in rows], [d for _, d in rows])


@SETTINGS
@given(ds=st.lists(st.one_of(st.integers(2 ** 63, U64 - 1), st.sampled_from(
    [2 ** 63, 2 ** 63 + 1, U64 - 1, U64 - 2, 3 * 2 ** 62,
     10 ** 19, (10 ** 18) << 4])), min_size=1, max_size=32))
def test_reciprocal_is_exact(host_lib, ds):
    """da_recip's double estimate and corrections give the exact
    floor((2^128 - 1) / d) - 2^64."""
    d = np.array(ds, np.uint64)
    v = np.zeros_like(d)
    host_lib.da_host_recip(d.ctypes.data, len(ds), v.ctypes.data)
    for x, got in zip(ds, v.tolist()):
        assert got == (U128 - 1) // x - U64, x


def _divisors_of_b2_minus_1():
    """The divisors of 2^128 - 1 in [2^63, 2^64): for them the remainder
    da_recip estimates over d is a whole multiple of d, so its estimate
    may fall just below the integer and take the upward correction."""
    primes = [3, 5, 17, 257, 641, 65537, 274177, 6700417, 67280421310721]
    out = set()
    for mask in range(1, 1 << len(primes)):
        v = 1
        for i, q in enumerate(primes):
            if mask >> i & 1:
                v *= q
        if 2 ** 63 <= v < U64:
            out.add(v)
    return sorted(out)


def test_reciprocal_where_its_remainder_is_a_multiple(host_lib):
    ds = _divisors_of_b2_minus_1() + [2 ** 63]
    assert len(ds) > 5
    d = np.array(ds, np.uint64)
    v = np.zeros_like(d)
    host_lib.da_host_recip(d.ctypes.data, len(ds), v.ctypes.data)
    for x, got in zip(ds, v.tolist()):
        assert got == (U128 - 1) // x - U64, x


def _div32(lib, rows):
    n = np.array([[x // U128, x // U64 % U64, x % U64] for x, _ in rows],
                 np.uint64).ravel()
    d = np.array([[y // U64, y % U64] for _, y in rows], np.uint64).ravel()
    q = np.zeros(len(rows), np.uint64)
    r = np.zeros(2 * len(rows), np.uint64)
    lib.da_host_div32(n.ctypes.data, d.ctypes.data, len(rows), q.ctypes.data,
                      r.ctypes.data)
    for i, (x, y) in enumerate(rows):
        got = (int(q[i]), int(r[2 * i]) + int(r[2 * i + 1]) * U64)
        assert got == divmod(x, y), (x, y, got)


norm_d = st.one_of(st.integers(2 ** 127, U128 - 1), st.sampled_from(
    [2 ** 127, 2 ** 127 + U64 - 1, U128 - 1, 2 ** 127 + 1]))


@SETTINGS
@given(rows=st.lists(st.tuples(norm_d, st.integers(0, U128 - 1),
                               st.integers(0, U64 - 1)),
                     min_size=1, max_size=32))
def test_three_by_two_step_matches_python_divmod(host_lib, rows):
    """da_div32 over any dividend whose top limb is below d1: wider than
    the kernel's own dividends, so the estimate from d1 can be 2 too large
    (Knuth's bound) and both corrections run."""
    _div32(host_lib, [(min(hi * U64 + lo, (d // U64) * U128 - 1), d)
                      for d, hi, lo in rows])


def test_three_by_two_step_takes_two_corrections(host_lib):
    """Knuth's worst case: d1 near 2^63, d0 near 2^64 and the quotient
    near 2^64, where the estimate from d1 is q + 2 (found by a search),
    and its neighbours."""
    d = 0x8000000000000002fffffffffffffff1
    x = 0x8000000000000001ffffffffffffffcea448585c23e6fb80
    assert ((x // U64) // (d // U64)) - x // d == 2
    rows = [(x + e, d) for e in (-1, 0, 1, U64, -d)]
    rows += [(2 ** 63 * U128 - 1 - e, 2 ** 127 + U64 - 1)
             for e in (0, 1, U64 - 1, U64)]
    _div32(host_lib, rows)


# ---------------------------------------------------------------------------
# every function at the launch constants' boundaries: one limb of 10^j
# (j <= 19) or two (j >= 20), to_double's exact double 10^s (s <= 22)
# ---------------------------------------------------------------------------

BOUNDS = (0, 19, 20, 22, 23, 38)
_PAIR_EDGE = [0, 1, -1, 5, -5, 99, 10 ** 9, -10 ** 18, I64_MAX, I64_MIN,
              I64_MIN + 1, 2 ** 53 + 1, -(2 ** 53), 123456789012345,
              10 ** 18, 7]


def _pairs(seed: int):
    """Every pair of _PAIR_EDGE and 64 random pairs: two columns."""
    rng = np.random.RandomState(seed)
    a = [x for x in _PAIR_EDGE for _ in _PAIR_EDGE]
    b = [y for _ in _PAIR_EDGE for y in _PAIR_EDGE]
    for _ in range(64):
        a.append(int(rng.randint(I64_MIN, I64_MAX, dtype=np.int64)))
        b.append(int(rng.randint(-10 ** 9, 10 ** 9)))
    return [a, b]


BOUNDARY_CASES = (
    [("mul", k, 0, 0) for k in BOUNDS + (-19, -20, -38)]
    + [("rescale", k, 0, 0) for k in BOUNDS + (-19, -20, -22, -23, -38)]
    + [("div", e, 38 - 6, 0) for e in BOUNDS + (-19, -20, -38)]
    + [("avg", e, 20, m) for e in BOUNDS for m in (0, 32)]
    + [(op, k, 0, m) for op in ("add", "sub") for k in BOUNDS
       for m in (0, 32)]
    + [("rem", k, 0, 0) for k in BOUNDS] + [("rem", 0, k, 0) for k in BOUNDS]
    + [("to_double", s, 0, 0) for s in BOUNDS])


@pytest.mark.parametrize("op,k,t,m", BOUNDARY_CASES)
def test_function_at_launch_constant_boundary(host_lib, op, k, t, m):
    """Each function with k (s, e), t and m where its powers of ten change
    form, over every pair of edge operands: the g++-built row logic and
    the plain version equal the exact answers."""
    seed = abs(hash((op, k, t, m))) % 2 ** 31
    if op == "to_double":
        xs = sorted(set(_pairs(seed)[0]))
        _both(host_lib, op, [xs], [want_double(x, k) for x in xs], k=k,
              double=True)
        return
    if op == "rescale":
        xs = sorted(set(_pairs(seed)[0]))
        _both(host_lib, op, [xs], [want_rescale(x, k, 38) for x in xs],
              k=k, p=38)
        return
    if op == "avg":
        rng = np.random.RandomState(seed)
        rows = [(l0, l1, l2, c) for l0 in (0, 1, DEC_LIMB - 1)
                for l1 in (0, DEC_LIMB - 1) for l2 in (0, -1, 7, 2 ** 40 - 1,
                                                       -(2 ** 40 - 1))
                for c in (1, 3, 7, I64_MAX)]
        rows += [(int(rng.randint(0, DEC_LIMB)), int(rng.randint(0, DEC_LIMB)),
                  int(rng.randint(-2 ** 40 + 1, 2 ** 40)),
                  int(rng.randint(1, 2 ** 62))) for _ in range(64)]
        cols = [list(c) for c in zip(*rows)]
        _both(host_lib, op, cols, [want_avg(*r, k, t, m, 38) for r in rows],
              k=k, t=t, p=38, m=m)
        return
    a, b = _pairs(seed)
    if op == "mul":
        want = [want_mul(x, y, k, 38) for x, y in zip(a, b)]
    elif op == "div":
        want = [want_div(x, y, k, t, 38) for x, y in zip(a, b)]
    elif op in ("add", "sub"):
        kl, kr = (k, 0) if op == "add" else (0, k)
        want = [want_add(x, y, kl, kr, m, 38, op == "sub")
                for x, y in zip(a, b)]
        _both(host_lib, op, [a, b], want, k=kl, t=kr, p=38, m=m)
        return
    else:
        want = [want_rem(x, y, k, t, 38) for x, y in zip(a, b)]
    _both(host_lib, op, [a, b], want, k=k, t=t, p=38, m=m)


@SETTINGS
@given(xs=st.lists(st.one_of(i64, st.integers(-2 ** 53, 2 ** 53)),
                   min_size=1, max_size=24), s=st.integers(0, 38))
def test_to_double_integer_path_is_correctly_rounded_everywhere(host_lib,
                                                                xs, s):
    """The integer path alone, also over the exact doubles (|x| < 2^53,
    s <= 22) that a row takes one IEEE division for: the kernel sends a
    warp with any row past them down the integer path, so it must give
    the same nearest double."""
    xs = [x for x in xs if x != 0] or [1]
    x = np.array(xs, np.int64)
    out = np.zeros(len(xs), np.int64)
    host_lib.da_host_to_double_int(x.ctypes.data, len(xs), s,
                                   out.ctypes.data)
    for v, got in zip(xs, out.view(np.float64).tolist()):
        assert got == want_double(v, s), (v, s, got)


@SETTINGS
@given(rows=st.lists(st.tuples(i64, i64, high, count), min_size=1,
                     max_size=16),
       e=st.integers(0, 30), t=st.integers(0, 32), m=st.integers(-6, 30))
def test_avg_of_limbs_outside_a_sums_range(host_lib, rows, e, t, m):
    """Low limbs that no SUM makes (negative, or past 10^12) take the row
    logic's signed total, and still equal the exact answers. (The plain
    version takes a SUM's limbs, l0 and l1 in [0, 10^12), alone.)"""
    cols = [list(c) for c in zip(*rows)]
    out, ok = _host(host_lib, "avg", cols, e, t, 38, m)
    for i, r in enumerate(rows):
        w = want_avg(*r, e, t, m, 38)
        assert (w is None) == (not ok[i]) and (w is None or out[i] == w), \
            (r, e, t, m, out[i], w)
