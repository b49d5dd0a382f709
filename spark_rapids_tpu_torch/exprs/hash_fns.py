"""Spark-exact Murmur3 and xxHash64 (port of
``spark_rapids_tpu/exprs/hash_fns.py``: the host forms,
``murmur3_fold_device``, ``xxhash64_fold_device`` and the ``Murmur3Hash``
and ``XxHash64`` expressions).

Murmur3_x86_32 as Spark's ``Murmur3Hash`` computes it, with Spark's type
normalizations: bool -> 1/0 int; byte/short/int/date -> the 4-byte path;
long/timestamp -> the 8-byte path; float -> floatToIntBits and double ->
doubleToLongBits, each with -0.0 as 0.0 and one canonical NaN; a NULL
leaves the running hash as it is; columns fold from the seed
(``seed = hash(col_i, seed)``).

The device forms are eager torch over int64 lanes. Murmur3's lanes hold
32-bit words: torch has no full uint32 arithmetic, but a product of two
words wraps modulo 2**64 and keeps its low 32 bits, so every step masks
to 32 bits. xxHash64's lanes hold 64-bit words: int64 products and sums
wrap as uint64 ones do, left shifts are products by powers of two, and
every right shift is masked (torch's ``>>`` is arithmetic). The
reference hashes doubles only on the host (its device emulates f64);
torch bitcasts float64 on every device, so doubles hash here too.

``hash`` and ``xxhash64`` of a string run on the reference's host
engine: the port refuses them at planning, naming the strings slice.
HiveHash, the digests (md5, sha1, sha2) and crc32 are host-only in the
reference and are refused too.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..types import (INT32, INT64, STRING, DecimalType, Schema, TypeEnum,
                     TypeSig)
from .base import DVal, Expression

__all__ = ["device_hashable", "spark_murmur3_bytes", "murmur3_int",
           "murmur3_long", "murmur3_fold_device", "xxhash64_int",
           "xxhash64_long", "xxhash64_fold_device", "Murmur3Hash",
           "XxHash64", "HiveHash", "Md5", "Sha1", "Sha2", "Crc32"]

_M3_C1 = 0xcc9e2d51
_M3_C2 = 0x1b873593
_M32 = 0xffffffff

#: key types the device fold hashes (the reference's set, and DOUBLE)
device_hashable = TypeSig([TypeEnum.BOOLEAN, TypeEnum.BYTE, TypeEnum.SHORT,
                           TypeEnum.INT, TypeEnum.LONG, TypeEnum.FLOAT,
                           TypeEnum.DOUBLE, TypeEnum.DATE,
                           TypeEnum.TIMESTAMP, TypeEnum.DECIMAL])


# ---------------------------------------------------------------------------
# host forms: Python integers (the tests' oracle)
# ---------------------------------------------------------------------------

def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _m3_mix_k1(k1):
    k1 = (k1 * _M3_C1) & _M32
    k1 = _rotl32(k1, 15)
    return (k1 * _M3_C2) & _M32


def _m3_mix_h1(h1, k1):
    h1 ^= k1
    h1 = _rotl32(h1, 13)
    return (h1 * 5 + 0xe6546b64) & _M32


def _m3_fmix(h1, length):
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85ebca6b) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xc2b2ae35) & _M32
    h1 ^= h1 >> 16
    return h1


def _signed(h: int) -> int:
    return h - (1 << 32) if h >= (1 << 31) else h


def spark_murmur3_bytes(data: bytes, seed: int) -> int:
    """Spark's Murmur3_x86_32.hashUnsafeBytes: the word loop, then each
    trailing byte (signed) through the full mix; a signed int32."""
    h1 = seed & _M32
    n = len(data)
    aligned = n - (n % 4)
    for i in range(0, aligned, 4):
        h1 = _m3_mix_h1(h1, _m3_mix_k1(int.from_bytes(data[i:i + 4],
                                                      "little")))
    for i in range(aligned, n):
        b = data[i] - 256 if data[i] >= 128 else data[i]
        h1 = _m3_mix_h1(h1, _m3_mix_k1(b & _M32))
    return _signed(_m3_fmix(h1, n))


def murmur3_int(v: int, seed: int) -> int:
    """hashInt(v, seed) as a signed int32."""
    h = _m3_mix_h1(seed & _M32, _m3_mix_k1(v & _M32))
    return _signed(_m3_fmix(h, 4))


def murmur3_long(v: int, seed: int) -> int:
    """hashLong(v, seed) as a signed int32."""
    v &= 0xffffffffffffffff
    h = _m3_mix_h1(seed & _M32, _m3_mix_k1(v & _M32))
    h = _m3_mix_h1(h, _m3_mix_k1(v >> 32))
    return _signed(_m3_fmix(h, 8))


# ---------------------------------------------------------------------------
# device form: int64 lanes masked to 32 bits
# ---------------------------------------------------------------------------

def _rotl32_dev(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1_dev(k1):
    k1 = (k1 * _M3_C1) & _M32
    return (_rotl32_dev(k1, 15) * _M3_C2) & _M32


def _mix_h1_dev(h1, k1):
    h1 = _rotl32_dev(h1 ^ k1, 13)
    return (h1 * 5 + 0xe6546b64) & _M32


def _fmix_dev(h1, length: int):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85ebca6b) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xc2b2ae35) & _M32
    return h1 ^ (h1 >> 16)


def _normalize_to_words(val: DVal):
    """A DVal as ("int", 32-bit word) or ("long", 64-bit word), both in
    int64 lanes, with Spark's normalization (a decimal of precision up to
    18 is its unscaled long; a wider one is hashed as bytes:
    ``_decimal_bytes``)."""
    d, name = val.data, val.dtype.name
    if isinstance(val.dtype, DecimalType):
        return "long", d.to(torch.int64)
    if name in ("boolean", "tinyint", "smallint", "int", "date"):
        return "int", d.to(torch.int64) & _M32
    if name in ("bigint", "timestamp"):
        return "long", d.to(torch.int64)
    if name in ("float", "double"):
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
        d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
        if name == "float":
            return "int", d.view(torch.int32).to(torch.int64) & _M32
        return "long", d.view(torch.int64)
    raise TypeError(f"cannot hash {name} on the device")


def _wide_decimal(v: DVal) -> bool:
    return isinstance(v.dtype, DecimalType) and v.dtype.precision > 18


def _decimal_bytes(x: torch.Tensor):
    """A wide decimal's unscaled value as Java's
    ``BigInteger.toByteArray``: (its length L in 1..8 per row, and per L a
    function giving byte j of the big-endian minimal two's complement as
    an int64 in [0, 256))."""
    L = torch.ones_like(x)
    for n in range(1, 8):
        lim = 1 << (8 * n - 1)
        L = torch.where((x < -lim) | (x >= lim), n + 1, L)

    def byte(n: int, j: int) -> torch.Tensor:
        return (x >> (8 * (n - 1 - j))) & 0xFF
    return L, byte


def _murmur3_decimal(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Spark's ``hashUnsafeBytes`` of a wide decimal's bytes
    (``_decimal_bytes``): little-endian 4-byte words, then each trailing
    byte, signed, through the full mix; one pass per length."""
    L, byte = _decimal_bytes(x)
    out = h
    for n in range(1, 9):
        nh = h
        for i in range(n // 4):
            w = byte(n, 4 * i) | (byte(n, 4 * i + 1) << 8) \
                | (byte(n, 4 * i + 2) << 16) | (byte(n, 4 * i + 3) << 24)
            nh = _mix_h1_dev(nh, _mix_k1_dev(w))
        for j in range(n - n % 4, n):
            b = byte(n, j)
            nh = _mix_h1_dev(nh, _mix_k1_dev(torch.where(
                b >= 128, b - 256, b) & _M32))
        out = torch.where(L == n, _fmix_dev(nh, n), out)
    return out


def _xxhash64_decimal(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Spark's XXH64 ``hashUnsafeBytes`` of a wide decimal's bytes (fewer
    than 32: an 8-byte word, a 4-byte word, then single bytes)."""
    L, byte = _decimal_bytes(x)
    out = h
    for n in range(1, 9):
        nh = h + _P5 + n
        j = 0
        if n == 8:
            k = torch.zeros_like(x)
            for b in range(8):
                k = k | (byte(n, b) << (8 * b))
            nh = _rotl64_dev(nh ^ (_rotl64_dev(k * _P2, 31) * _P1), 27) \
                * _P1 + _P4
            j = 8
        if n - j >= 4:
            w = byte(n, j) | (byte(n, j + 1) << 8) | (byte(n, j + 2) << 16) \
                | (byte(n, j + 3) << 24)
            nh = _rotl64_dev(nh ^ (w * _P1), 23) * _P2 + _P3
            j += 4
        for b in range(j, n):
            nh = _rotl64_dev(nh ^ (byte(n, b) * _P5), 11) * _P1
        out = torch.where(L == n, _xx_fmix_dev(nh), out)
    return out


def murmur3_fold_device(vals: List[DVal], seed: int) -> torch.Tensor:
    """Spark's murmur3 folded over the columns from ``seed``: int32 per
    row."""
    h = torch.full(vals[0].validity.shape, seed & _M32, dtype=torch.int64,
                   device=vals[0].validity.device)
    for v in vals:
        if _wide_decimal(v):
            h = torch.where(v.validity, _murmur3_decimal(h, v.data), h)
            continue
        kind, w = _normalize_to_words(v)
        if kind == "int":
            nh = _fmix_dev(_mix_h1_dev(h, _mix_k1_dev(w)), 4)
        else:
            nh = _mix_h1_dev(h, _mix_k1_dev(w & _M32))
            nh = _fmix_dev(_mix_h1_dev(nh, _mix_k1_dev((w >> 32) & _M32)), 8)
        h = torch.where(v.validity, nh, h)     # a NULL skips the column
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)



# ---------------------------------------------------------------------------
# xxHash64: host forms (the tests' oracle) and the device form
# ---------------------------------------------------------------------------

_XX_P1 = 0x9E3779B185EBCA87
_XX_P2 = 0xC2B2AE3D27D4EB4F
_XX_P3 = 0x165667B19E3779F9
_XX_P4 = 0x85EBCA77C2B2AE63
_XX_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _xx_fmix(h):
    h ^= h >> 33
    h = (h * _XX_P2) & _M64
    h ^= h >> 29
    h = (h * _XX_P3) & _M64
    return h ^ (h >> 32)


def _signed64(h: int) -> int:
    h &= _M64
    return h - (1 << 64) if h >= (1 << 63) else h


def xxhash64_int(v: int, seed: int) -> int:
    """Spark's XXH64.hashInt(v, seed) as a signed int64."""
    h = (seed + _XX_P5 + 4) & _M64
    h ^= ((v & _M32) * _XX_P1) & _M64
    h = (_rotl64(h, 23) * _XX_P2 + _XX_P3) & _M64
    return _signed64(_xx_fmix(h))


def xxhash64_long(v: int, seed: int) -> int:
    """Spark's XXH64.hashLong(v, seed) as a signed int64."""
    v &= _M64
    h = (seed + _XX_P5 + 8) & _M64
    h ^= (_rotl64((v * _XX_P2) & _M64, 31) * _XX_P1) & _M64
    h = (_rotl64(h, 27) * _XX_P1 + _XX_P4) & _M64
    return _signed64(_xx_fmix(h))


_P1, _P2, _P3, _P4, _P5 = (_signed64(p) for p in (_XX_P1, _XX_P2, _XX_P3,
                                                   _XX_P4, _XX_P5))


def _lsr64(x, k: int):
    return (x >> k) & ((1 << (64 - k)) - 1)


def _rotl64_dev(x, r: int):
    return (x * (1 << r)) | _lsr64(x, 64 - r)


def _xx_fmix_dev(h):
    h = (h ^ _lsr64(h, 33)) * _P2
    h = (h ^ _lsr64(h, 29)) * _P3
    return h ^ _lsr64(h, 32)


def xxhash64_fold_device(vals: List[DVal], seed: int) -> torch.Tensor:
    """Spark's xxhash64 folded over the columns from ``seed`` (each
    column's hash seeds the next): int64 per row."""
    h = torch.full(vals[0].validity.shape, _signed64(seed),
                   dtype=torch.int64, device=vals[0].validity.device)
    for v in vals:
        if _wide_decimal(v):
            h = torch.where(v.validity, _xxhash64_decimal(h, v.data), h)
            continue
        kind, w = _normalize_to_words(v)
        if kind == "int":
            nh = (h + (_P5 + 4)) ^ (w * _P1)
            nh = _rotl64_dev(nh, 23) * _P2 + _P3
        else:
            k = _rotl64_dev(w * _P2, 31) * _P1
            nh = _rotl64_dev((h + (_P5 + 8)) ^ k, 27) * _P1 + _P4
        h = torch.where(v.validity, _xx_fmix_dev(nh), h)
    return h


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

class _HashBase(Expression):
    """hash/xxhash64 over columns of fixed-width types; never NULL (a NULL
    column leaves the running hash as it is)."""

    def __init__(self, children, seed: int = 42):
        self.children = list(children)
        self.seed = seed

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        if not self.children:
            return f"{type(self).__name__} needs at least one column"
        for c in self.children:
            dt = c.data_type(schema)
            if dt == STRING:
                return (f"{type(self).__name__} of a string hashes on the "
                        "reference's host engine; it arrives with the "
                        "strings slice (ROADMAP.md Queue A, slice 7)")
            r = device_hashable.reason_not_supported(dt)
            if r is not None:
                return f"{type(self).__name__}: input {r}"
        return None

    def _vals(self, ctx):
        return [c.eval_device(ctx) for c in self.children]

    def key(self):
        kids = ",".join(c.key() for c in self.children)
        return f"{type(self).__name__}({kids},seed={self.seed})"


class Murmur3Hash(_HashBase):
    """hash(cols...): Spark's Murmur3 with seed 42 (HashPartitioning's)."""

    def data_type(self, schema):
        return INT32

    def eval_device(self, ctx) -> DVal:
        h = murmur3_fold_device(self._vals(ctx), self.seed)
        return DVal(h, torch.ones_like(h, dtype=torch.bool), INT32)


class XxHash64(_HashBase):
    """xxhash64(cols...): Spark's XXH64 with seed 42."""

    def data_type(self, schema):
        return INT64

    def eval_device(self, ctx) -> DVal:
        h = xxhash64_fold_device(self._vals(ctx), self.seed)
        return DVal(h, torch.ones_like(h, dtype=torch.bool), INT64)


class _HostOnlyHash(Expression):
    """A hash the reference computes on its host engine only."""
    result = INT32

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self, schema):
        return self.result

    def device_unsupported_reason(self, schema: Schema) -> Optional[str]:
        return (f"{type(self).__name__} runs on the reference's host engine "
                "only; the port has no host engine (ROADMAP.md Queue A, "
                "the host-only functions: queued with the strings slice, "
                "slice 7)")


class HiveHash(_HostOnlyHash):
    pass


class Md5(_HostOnlyHash):
    result = STRING


class Sha1(_HostOnlyHash):
    result = STRING


class Sha2(_HostOnlyHash):
    result = STRING


class Crc32(_HostOnlyHash):
    result = INT64
