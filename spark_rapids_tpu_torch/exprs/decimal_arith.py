"""Decimal arithmetic past int64: the hand-written CUDA kernel
``decimal_arith``, its plain PyTorch version, and the wrapper that picks
between them.

A decimal is its unscaled value in an int64 lane (types.py
``DecimalType``). Adding two of them at scales far apart, multiplying
them, dividing with the dividend scaled up to Spark's result scale,
rescaling down with HALF_UP, averaging an exact total held in limbs, and
converting to the nearest double all need 128-bit intermediates even
where the result fits int64; torch has no int128. The functions
(``OPS``), each over rows, taking the rows' validity:

* ``add(l, r; kl, kr, m, p)`` and ``sub``: ``l * 10^kl + r * 10^kr``
  (``-`` for ``sub``; one of ``kl``, ``kr`` is 0: both at the larger
  scale), then ``m`` digits lower, HALF_UP (Spark's precision loss,
  ``m <= 32``);
* ``rem(l, r; kl, kr, p)``: the remainder of ``l * 10^kl`` over ``r *
  10^kr`` (one of them 0), truncated, with ``l``'s sign (Java's
  ``BigDecimal.remainder``); a zero divisor gives NULL;

* ``mul(l, r; k, p)``: ``l * r`` at a scale ``k`` digits below the
  operands' summed scales, HALF_UP;
* ``div(l, r; e, t, p)``: ``l * 10^e / r`` (``e`` may be negative),
  rounded HALF_UP at ``t`` digits below, then HALF_UP to the result's
  scale: Spark's division at scale 38 and its cast to the result type
  (``t = 38 - s_out``); a zero divisor gives NULL;
* ``rescale(x; k, p)``: ``x`` at a scale ``k`` digits higher (``k < 0``:
  lower, HALF_UP);
* ``avg(l0, l1, l2, count; e, t, m, p)``: Spark's average, its Divide
  and then its cast: the total ``(l2 * 10^12 + l1) * 10^12 + l0`` (a
  SUM's limbs: ``l0``, ``l1`` in ``[0, 10^12)``, which the plain version
  assumes; the kernel's row logic takes any int64 limbs) scaled
  by ``10^e`` over the count, rounded as ``div`` rounds (``t = 38 -`` the
  division's scale), then ``m`` digits lower, HALF_UP
  (exprs/aggregates.py ``Average``);
* ``to_double(x; s)``: the double nearest ``x / 10^s``, ties to even
  (Java's ``BigDecimal.doubleValue``).

Every integer result is NULL where its magnitude passes its declared
precision ``p`` or int64. The row arithmetic is
``csrc/decimal_arith_row.cuh``.

* On CUDA tensors: one launch of ``csrc/decimal_arith.cu`` (two rows a
  thread, the launch's powers of ten and their reciprocals computed once
  on the host; a row a thread for views that are not aligned for its
  vector loads); ``decimal_arith.launches`` counts them.
* On CPU tensors: ``decimal_arith_reference``, the same arithmetic in
  torch int64 ops over numbers held as base-2^16 digits (a [rows,
  digits] tensor): schoolbook products, division by powers of ten in
  steps of 10^4, and restoring division bit by bit for the rest. No loop
  runs over rows and no float enters, but for ``to_double``'s one
  division of two exact doubles.

No PyTorch call computes these functions (torch has no int128), so
chip_smoke.py times no library call beside the kernel. ``scale_up`` is
the int64 rescale that the arithmetic, comparisons and join keys take in
torch where the types guarantee that it fits.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

__all__ = ["OPS", "decimal_arith", "decimal_arith_reference", "add", "rem",
           "mul", "div", "rescale", "avg", "to_double", "scale_up",
           "DEC_LIMB", "MAX_DIGITS"]

#: csrc/decimal_arith_row.cuh DaOp
OPS = {"mul": 0, "div": 1, "rescale": 2, "avg": 3, "to_double": 4,
       "add": 5, "sub": 6, "rem": 7}
#: csrc/decimal_arith_row.cuh DA_MAX_DIGITS
MAX_DIGITS = 38
#: the base of a decimal SUM's partial limbs (csrc DA_LIMB)
DEC_LIMB = 10 ** 12
#: operands of each function
_ARITY = {"mul": 2, "div": 2, "rescale": 1, "avg": 4, "to_double": 1,
          "add": 2, "sub": 2, "rem": 2}

_B = 16
_MASK = (1 << _B) - 1
_INT64_CAP = 2 ** 63


# ---------------------------------------------------------------------------
# numbers as base-2^16 digits: int64 [rows, digits], little-endian
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor) -> torch.Tensor:
    """Carries propagated: every digit in [0, 2^16) but the top one
    (negative digits borrow: ``>>`` floors and ``&`` takes the floor
    modulus)."""
    x = x.clone()
    for i in range(x.shape[1] - 1):
        c = x[:, i] >> _B
        x[:, i] &= _MASK
        x[:, i + 1] += c
    return x


def _pad(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` with ``d`` digits (zeros added on top, or top digits that
    are zero dropped)."""
    if x.shape[1] >= d:
        return x[:, :d]
    return torch.nn.functional.pad(x, (0, d - x.shape[1]))


def _const(v: int, d: int, device) -> torch.Tensor:
    """The non-negative Python int ``v`` as [1, d] digits."""
    return torch.tensor([[(v >> (_B * i)) & _MASK for i in range(d)]],
                        dtype=torch.int64, device=device)


def _ndigits(v: int) -> int:
    return max(1, -(-v.bit_length() // _B))


def _mag(x: torch.Tensor) -> torch.Tensor:
    """|x| of int64 ``x`` as [N, 4] digits (2^63 for INT64_MIN): the
    digits of ``~x`` plus one where ``x`` is negative."""
    neg = x < 0
    bits = torch.where(neg, torch.bitwise_not(x), x)
    d = torch.stack([(bits >> (_B * i)) & _MASK for i in range(4)]
                    + [torch.zeros_like(x)], 1)
    d[:, 0] += neg.to(torch.int64)
    return _pad(_norm(d), 4)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b ([N or 1, Da] by [N or 1, Db] -> [N, Da + Db]): products of
    digits below 2^32, column sums below 2^36."""
    n = max(a.shape[0], b.shape[0])
    out = torch.zeros((n, a.shape[1] + b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for j in range(b.shape[1]):
        out[:, j:j + a.shape[1]] += a * b[:, j:j + 1]
    return _norm(out)


def _cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sign of a - b per row (int64 -1, 0 or 1); both of d digits."""
    diff = a - b
    d = diff.shape[1]
    nz = (diff != 0).to(torch.int32)
    top = d - 1 - torch.argmax(nz.flip(1), dim=1)
    return torch.sign(diff.gather(1, top[:, None])[:, 0])


def _cmp_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_cmp`` of digit tensors of any widths (rows broadcast)."""
    d = max(a.shape[1], b.shape[1])
    a, b = _pad(a, d), _pad(b, d)
    rows = max(a.shape[0], b.shape[0])
    return _cmp(a.expand(rows, d), b.expand(rows, d))


def _high(n: torch.Tensor, w: int) -> torch.Tensor:
    """n >> (16 w) as digits (one zero digit when nothing is left)."""
    if n.shape[1] > w:
        return n[:, w:]
    return torch.zeros((n.shape[0], 1), dtype=torch.int64, device=n.device)


def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=1)


def _divmod_small(a: torch.Tensor, s: int):
    """(floor(a / s), a mod s) for 1 <= s < 2^15: long division from the
    top digit, every partial value below 2^31."""
    q = torch.empty_like(a)
    r = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for i in range(a.shape[1] - 1, -1, -1):
        cur = (r << _B) + a[:, i]
        qi = torch.div(cur, s, rounding_mode="floor")
        q[:, i] = qi
        r = cur - qi * s
    return q, r


def _div_pow10_half_up(a: torch.Tensor, k: int) -> torch.Tensor:
    """a / 10^k rounded HALF_UP (k >= 1): floor((a + 5 * 10^(k-1)) /
    10^k), the division in steps of at most 10^4."""
    half = 5 * 10 ** (k - 1)
    d = max(a.shape[1], _ndigits(half)) + 1
    a = _norm(_pad(a, d) + _const(half, d, a.device))
    while k > 0:
        c = min(k, 4)
        a, _ = _divmod_small(a, 10 ** c)
        k -= c
    return a


def _shl1(x: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """2x + bit (x normalized; the top digit's carry dropped)."""
    carry = (x >> (_B - 1)) & 1
    y = (x << 1) & _MASK
    y[:, 1:] |= carry[:, :-1]
    y[:, 0] |= bit
    return y


def _long_div(n: torch.Tensor, d: torch.Tensor, qbits: int):
    """(floor(n / d) as qbits / 16 digits, n mod d): restoring division
    over n's low ``qbits`` bits, for rows where n >> qbits < d (the
    caller masks the others). ``d`` is [N or 1, Dd], non-zero."""
    w = qbits // _B
    dr = max(d.shape[1], 1) + 1
    rows = n.shape[0]
    dd = _pad(d, dr).expand(rows, dr)
    hi = _high(n, w)
    rem = torch.where((_cmp_wide(hi, d) < 0)[:, None], _pad(hi, dr), 0)
    nl = _pad(n, w)
    q = torch.zeros((rows, w), dtype=torch.int64, device=n.device)
    for i in range(qbits - 1, -1, -1):
        bit = (nl[:, i // _B] >> (i % _B)) & 1
        rem = _shl1(rem, bit)
        ge = _cmp(rem, dd) >= 0
        rem = torch.where(ge[:, None], _norm(rem - dd), rem)
        q[:, i // _B] |= ge.to(torch.int64) << (i % _B)
    return q, rem


def _round_up(rem: torch.Tensor, d: torch.Tensor, t: int) -> torch.Tensor:
    """csrc da_round_up: a quotient with remainder ``rem`` over ``d``
    rounded HALF_UP ``t`` digits below the result's scale, then HALF_UP to
    it, rounds up where (d - 2 rem) * 10^t <= d (t = 0: 2 rem >= d)."""
    dd = _pad(d, rem.shape[1]).expand(rem.shape[0], -1)
    x = _norm(dd - rem)
    up = _cmp(rem, x) >= 0
    if 0 < t <= MAX_DIGITS:
        x2 = torch.where(up[:, None], 0, _norm(x - rem))
        prod = _mul(x2, _const(10 ** t, _ndigits(10 ** t), rem.device))
        up = up | (_cmp_wide(prod, dd) <= 0)
    return up


def _plus(q: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """q + up (a bool per row), one digit wider."""
    w = q.shape[1]
    return _norm(_pad(q, w + 1) + torch.nn.functional.pad(
        up.to(torch.int64)[:, None], (0, w)))


def _limits(p: int, d: int, device):
    """(positive, negative) magnitude limits of precision ``p`` as [1, d]
    digits (csrc da_limit)."""
    lim = 10 ** p - 1
    return (_const(min(lim, _INT64_CAP - 1), d, device),
            _const(min(lim, _INT64_CAP), d, device))


def _finish(mag: torch.Tensor, neg: torch.Tensor, ok: torch.Tensor,
            p: int):
    """(int64 values, validity) of magnitudes ``mag`` with signs ``neg``:
    NULL past precision ``p`` or int64, or where ``ok`` is False."""
    d = max(mag.shape[1], 5)
    mag = _pad(mag, d)
    pos_lim, neg_lim = _limits(p, d, mag.device)
    lim = torch.where(neg[:, None], neg_lim, pos_lim)
    valid = ok & (_cmp(mag, lim) <= 0)
    v = mag[:, 0] | (mag[:, 1] << 16) | (mag[:, 2] << 32) | (mag[:, 3] << 48)
    v = torch.where(neg, -v, v)
    return torch.where(valid, v, 0), valid


# ---------------------------------------------------------------------------
# the plain version, function by function
# ---------------------------------------------------------------------------

def _mul_ref(l, r, k: int, p: int):
    mag = _mul(_mag(l), _mag(r))
    neg = (l < 0) != (r < 0)
    ok = torch.ones_like(neg)
    if k > MAX_DIGITS:
        mag = torch.zeros_like(mag)
    elif k > 0:
        mag = _div_pow10_half_up(mag, k)
    elif k < 0:
        if -k > MAX_DIGITS:
            ok = _is_zero(mag)
        else:
            mag = _mul(mag, _const(10 ** -k, _ndigits(10 ** -k), l.device))
    return _finish(mag, neg, ok, p)


def _scaled_mag(x, k: int) -> torch.Tensor:
    """|x| * 10^k as digits (0 <= k <= MAX_DIGITS)."""
    mag = _mag(x)
    if k == 0:
        return mag
    return _mul(mag, _const(10 ** k, _ndigits(10 ** k), x.device))


def _add_ref(l, r, kl: int, kr: int, m: int, p: int, sub: bool):
    a, b = _scaled_mag(l, kl), _scaled_mag(r, kr)
    d = max(a.shape[1], b.shape[1]) + 1
    a, b = _pad(a, d), _pad(b, d)
    na, nb = l < 0, (r < 0) != sub
    a_big = (_cmp(a, b) >= 0)[:, None]
    mag = torch.where((na == nb)[:, None], _norm(a + b),
                      torch.where(a_big, _norm(a - b), _norm(b - a)))
    neg = torch.where(na == nb, na, torch.where(a_big[:, 0], na, nb))
    if m > 0:
        mag = _div_pow10_half_up(mag, m)
    ok = torch.full_like(na, 0 <= m <= 32)
    return _finish(mag, neg & ~_is_zero(mag), ok, p)


def _rem_ref(l, r, kl: int, kr: int, p: int):
    ok = (r != 0) & (min(kl, kr) == 0)
    a, b = _scaled_mag(l, kl), _scaled_mag(r, kr)
    b = torch.where(ok[:, None], b, 1)
    _, rem = _long_div(a, b, _B * a.shape[1])
    return _finish(rem, (l < 0) & ~_is_zero(rem), ok, p)


def _div_ref(l, r, e: int, t: int, p: int):
    neg = (l < 0) != (r < 0)
    ok = r != 0
    zero = l == 0
    n, d = _mag(l), _mag(r)
    dev = l.device
    if e > 0:
        if e > MAX_DIGITS:
            ok = ok & zero
        else:
            n = _mul(n, _const(10 ** e, _ndigits(10 ** e), dev))
            # past 2^128 the kernel gives NULL (the quotient passes 2^65)
            ok = ok & (zero | _is_zero(n[:, 8:]))
    elif e < 0:
        if -e > MAX_DIGITS:
            # a divisor past 2^127: the quotient rounds to 0
            d = _const(1 << 127, 8, dev).expand(d.shape[0], 8)
        else:
            d = _mul(d, _const(10 ** -e, _ndigits(10 ** -e), dev))
    d = torch.where(ok[:, None] & ~_is_zero(d)[:, None], d, 1)
    fits = _cmp_wide(_high(n, 4), d) < 0
    q, rem = _long_div(n, d, 64)
    q = _plus(q, _round_up(rem, d, t))
    q = torch.where(zero[:, None], 0, q)
    return _finish(q, neg & ~zero, ok & (fits | zero), p)


def _rescale_ref(x, k: int, p: int):
    neg = x < 0
    mag = _mag(x)
    ok = torch.ones_like(neg)
    if k > 0:
        if k > MAX_DIGITS:
            ok = x == 0
        else:
            mag = _mul(mag, _const(10 ** k, _ndigits(10 ** k), x.device))
    elif k < 0:
        mag = torch.zeros_like(mag) if -k > MAX_DIGITS \
            else _div_pow10_half_up(mag, -k)
    return _finish(mag, neg, ok, p)


def _avg_ref(l0, l1, l2, count, e: int, t: int, m: int, p: int):
    dev = l0.device
    ok = (count > 0) & (l2 < (1 << 40)) & (l2 > -(1 << 40))
    l2 = torch.where(ok, l2, 0)
    neg_hi = l2 < 0
    low = _norm(_pad(_mul(_mag(l1), _const(DEC_LIMB, 3, dev)), 8)
                + _pad(_mag(l0), 8))                     # below 10^24
    high = _pad(_mul(_mag(l2), _const(DEC_LIMB ** 2, 6, dev)), 8)
    # l2 < 0: total = -(|l2| 10^24 - low), which is negative as low < 10^24
    mag = torch.where(neg_hi[:, None], _norm(high - low), _norm(high + low))
    zero = _is_zero(mag)
    neg = neg_hi & ~zero
    if e > 0:
        if e > MAX_DIGITS:
            ok = ok & zero
        else:
            mag = _mul(mag, _const(10 ** e, _ndigits(10 ** e), dev))
            ok = ok & _is_zero(mag[:, 8:])
    mag = _pad(mag, 8)
    c = _mag(torch.where(ok & (count > 0), count, 1))
    q, rem = _long_div(mag, c, 128)
    q = _plus(q, _round_up(rem, c, t))
    if m > 0:
        q = torch.zeros_like(q) if m > MAX_DIGITS \
            else _div_pow10_half_up(q, m)
    elif m < 0:
        if -m > MAX_DIGITS:
            ok = ok & _is_zero(q)
        else:
            q = _mul(q, _const(10 ** -m, _ndigits(10 ** -m), dev))
    return _finish(q, neg, ok, p)


def _bit_length(d: torch.Tensor) -> torch.Tensor:
    """The bit length of each row's digits (0 for 0)."""
    nz = (d != 0).to(torch.int32)
    top = d.shape[1] - 1 - torch.argmax(nz.flip(1), dim=1)
    digit = d.gather(1, top[:, None])[:, 0]
    _, ex = torch.frexp(digit.to(torch.float64))      # exact below 2^16
    return torch.where(digit == 0, 0, top * _B + ex.to(torch.int64))


def _to_double_ref(x, s: int):
    dev = x.device
    neg = x < 0
    mag = _mag(x)
    small = (x > -(1 << 53)) & (x < (1 << 53)) & (s <= 22)
    num = torch.abs(torch.where(small, x, 0)).to(torch.float64)
    # a tensor divisor: torch divides a CUDA tensor by a Python number
    # through its reciprocal, which is not the one IEEE division
    fast = num / torch.full_like(num, 10.0 ** s)
    lu = _bit_length(mag)
    z = 63 - lu
    bits = mag[:, 0] | (mag[:, 1] << 16) | (mag[:, 2] << 32) \
        | (mag[:, 3] << 48)
    un = torch.where(z >= 0, bits << z.clamp(min=0),
                     torch.full_like(bits, 1 << 62))
    un = torch.where(x == 0, 1 << 62, un)
    big = 10 ** s
    lp = big.bit_length()
    und = _mag(un)
    if lp < 8:
        X, D = und, _const(big << (8 - lp), 1, dev)
    else:
        sh = 1 << (lp - 8)
        X, D = _mul(und, _const(sh, _ndigits(sh), dev)), \
            _const(big, _ndigits(big), dev)
    Qd, rem = _long_div(X, D, 64)
    Q = Qd[:, 0] | (Qd[:, 1] << 16) | (Qd[:, 2] << 32) | (Qd[:, 3] << 48)
    shv = torch.where(Q >= (1 << 55), 3, 2)
    mant = Q >> shv
    dropped = Q & ((1 << shv) - 1)
    half = 1 << (shv - 1)
    sticky = ~_is_zero(rem)
    up = (dropped > half) | ((dropped == half) & (sticky | ((mant & 1) == 1)))
    mant = mant + up.to(torch.int64)
    # times 2^e, e the exponent below, built from its bits (a normal
    # double): exact, where torch.ldexp's power of two goes through pow
    e = shv - (lp - 8) - z
    slow = mant.to(torch.float64) * ((e + 1023) << 52).view(torch.float64)
    out = torch.where(small, fast, slow)
    out = torch.where(x == 0, 0.0, torch.where(neg, -out, out))
    return out.view(torch.int64), torch.ones_like(neg)


def decimal_arith_reference(op: str, operands, valid: torch.Tensor,
                            k: int = 0, t: int = 0, m: int = 0,
                            p: int = 38):
    """Plain PyTorch version of ``decimal_arith`` (module doc): (int64
    results, the double's bits for ``to_double``; validity)."""
    if op == "mul":
        out, ok = _mul_ref(*operands, k, p)
    elif op == "div":
        out, ok = _div_ref(*operands, k, t, p)
    elif op == "rescale":
        out, ok = _rescale_ref(*operands, k, p)
    elif op == "avg":
        out, ok = _avg_ref(*operands, k, t, m, p)
    elif op in ("add", "sub"):
        out, ok = _add_ref(*operands, k, t, m, p, op == "sub")
    elif op == "rem":
        out, ok = _rem_ref(*operands, k, t, p)
    else:
        out, ok = _to_double_ref(*operands, k)
    ok = ok & valid
    return torch.where(ok, out, 0), ok


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_LIB: dict = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _launcher():
    with _LOCK:
        if not _LIB:
            from .. import native
            lib = native.load("decimal_arith")
            fn = lib.decimal_arith_launch
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            lib.decimal_arith_describe.argtypes = [ctypes.c_void_p]
            lib.decimal_arith_describe.restype = ctypes.c_int
            _LIB.update(launch=fn, describe=lib.decimal_arith_describe)
        return _LIB


def describe() -> dict:
    """Registers a thread of every function's vector instance (several
    rows a thread) and of its scalar instance (a row a thread, for
    unaligned views), threads a block and rows a thread."""
    out = (ctypes.c_int * 18)()
    rc = _launcher()["describe"](ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"decimal_arith_describe failed: CUDA error {rc}")
    return {"registers": {op: out[i] for op, i in OPS.items()},
            "scalar_registers": {op: out[8 + i] for op, i in OPS.items()},
            "threads": out[16], "rows_per_thread": out[17]}


def _check(op: str, operands, valid, second) -> None:
    if op not in OPS:
        raise ValueError(f"decimal_arith has no function {op!r}")
    if len(operands) != _ARITY[op]:
        raise ValueError(f"decimal_arith {op} takes {_ARITY[op]} operands")
    n, dev = valid.shape[0], valid.device
    for t in list(operands) + [valid] + ([second] if second is not None
                                         else []):
        if t.dim() != 1 or t.shape[0] != n or t.device != dev:
            raise ValueError("decimal_arith takes vectors of one length on "
                             "one device")
    if any(t.dtype != torch.int64 for t in operands) or \
            valid.dtype != torch.bool or (second is not None
                                          and second.dtype != torch.bool):
        raise TypeError("decimal_arith takes int64 operands and bool "
                        "validity")


def decimal_arith(op: str, operands, valid: torch.Tensor,
                  valid2: Optional[torch.Tensor] = None, k: int = 0,
                  t: int = 0, m: int = 0, p: int = 38
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 results, validity) of function ``op`` (module doc) over int64
    ``operands`` whose rows are valid where ``valid`` (and ``valid2``)
    are. On CUDA tensors one kernel launch (or an error); on CPU tensors
    ``decimal_arith_reference``. ``to_double``'s results are the doubles'
    bits (``.view(torch.float64)``)."""
    _check(op, operands, valid, valid2)
    dev = valid.device
    if dev.type == "cpu":
        both = valid if valid2 is None else valid & valid2
        return decimal_arith_reference(op, operands, both, k, t, m, p)
    if dev.type != "cuda":
        raise ValueError(f"decimal_arith has no kernel for {dev}")
    n = valid.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, out_valid
    ops = [o.contiguous() for o in operands]
    ptrs = [o.data_ptr() for o in ops] + [None] * (4 - len(ops))
    av = valid.contiguous()
    bv = valid2.contiguous() if valid2 is not None else None
    rc = _launcher()["launch"](
        OPS[op], *ptrs, av.data_ptr(),
        bv.data_ptr() if bv is not None else None, n, k, t, m, p,
        out.data_ptr(), out_valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decimal_arith kernel launch failed: CUDA error "
                           f"{rc}")
    with _COUNT_LOCK:           # queries on several threads launch it
        decimal_arith.launches += 1
    return out, out_valid


#: kernel launches since the count was last set to 0
decimal_arith.launches = 0


def add(l, lv, r, rv, kl: int, kr: int, m: int, p: int,
        subtract: bool = False):
    """``l * 10^kl + r * 10^kr`` (``-`` with ``subtract``) ``m`` digits
    lower, precision ``p``."""
    if not 0 <= m <= 32 or min(kl, kr) != 0:
        raise ValueError(f"decimal_arith add takes one operand at the "
                         f"larger scale and m in [0, 32]: {kl}, {kr}, {m}")
    return decimal_arith("sub" if subtract else "add", (l, r), lv, rv,
                         k=kl, t=kr, m=m, p=p)


def rem(l, lv, r, rv, kl: int, kr: int, p: int):
    """The remainder of ``l * 10^kl`` over ``r * 10^kr``, precision
    ``p``."""
    if min(kl, kr) != 0 or max(kl, kr) > MAX_DIGITS:
        raise ValueError(f"decimal_arith rem takes one operand at the "
                         f"larger scale: {kl}, {kr}")
    return decimal_arith("rem", (l, r), lv, rv, k=kl, t=kr, p=p)


def scale_up(x: torch.Tensor, k: int):
    """(``x * 10^k`` in int64 where it fits, else 0; whether it fits),
    ``k >= 0``: a rescale up in torch, for callers whose types leave it
    in int64 or that decide the rows it does not fit themselves."""
    if k == 0:
        return x, torch.ones_like(x, dtype=torch.bool)
    if k > 18:
        return torch.zeros_like(x), x == 0
    lim = (2 ** 63 - 1) // 10 ** k
    fits = (x <= lim) & (x >= -lim)
    return torch.where(fits, x, 0) * 10 ** k, fits


def mul(l, lv, r, rv, k: int, p: int):
    """``l * r`` at ``k`` digits below the summed scales, precision ``p``."""
    return decimal_arith("mul", (l, r), lv, rv, k=k, p=p)


def div(l, lv, r, rv, e: int, t: int, p: int):
    """Spark's ``l / r`` (module doc)."""
    return decimal_arith("div", (l, r), lv, rv, k=e, t=t, p=p)


def rescale(x, xv, k: int, p: int):
    """``x`` at a scale ``k`` digits higher (lower for k < 0, HALF_UP)."""
    if k == 0 and p >= 19:
        return x, xv
    return decimal_arith("rescale", (x,), xv, k=k, p=p)


def avg(l0, l1, l2, count, valid, e: int, t: int, m: int, p: int):
    """Spark's average of a decimal from its limb total and count."""
    return decimal_arith("avg", (l0, l1, l2, count), valid, k=e, t=t, m=m,
                         p=p)


def to_double(x, xv, s: int):
    """(float64 nearest ``x / 10^s``, validity)."""
    bits, ok = decimal_arith("to_double", (x,), xv, k=s)
    return bits.view(torch.float64), ok
