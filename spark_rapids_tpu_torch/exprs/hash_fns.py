"""Spark-exact Murmur3 (port of ``spark_rapids_tpu/exprs/hash_fns.py``: the
host forms and ``murmur3_fold_device``).

Murmur3_x86_32 as Spark's ``Murmur3Hash`` computes it, with Spark's type
normalizations: bool -> 1/0 int; byte/short/int/date -> the 4-byte path;
long/timestamp -> the 8-byte path; float -> floatToIntBits and double ->
doubleToLongBits, each with -0.0 as 0.0 and one canonical NaN; a NULL
leaves the running hash as it is; columns fold from the seed
(``seed = hash(col_i, seed)``).

The device form is eager torch over int64 lanes holding 32-bit words:
torch has no full uint32 arithmetic, but a product of two words wraps
modulo 2**64 and keeps its low 32 bits, so every step masks to 32 bits.
The reference hashes doubles only on the host (its device emulates f64);
torch bitcasts float64 on every device, so doubles hash here too.
xxhash64, HiveHash and the ``Murmur3Hash`` expression wait for a later
slice.
"""
from __future__ import annotations

from typing import List

import torch

from ..types import TypeEnum, TypeSig
from .base import DVal

__all__ = ["device_hashable", "spark_murmur3_bytes", "murmur3_int",
           "murmur3_long", "murmur3_fold_device"]

_M3_C1 = 0xcc9e2d51
_M3_C2 = 0x1b873593
_M32 = 0xffffffff

#: key types the device fold hashes (the reference's set, and DOUBLE)
device_hashable = TypeSig([TypeEnum.BOOLEAN, TypeEnum.BYTE, TypeEnum.SHORT,
                           TypeEnum.INT, TypeEnum.LONG, TypeEnum.FLOAT,
                           TypeEnum.DOUBLE, TypeEnum.DATE,
                           TypeEnum.TIMESTAMP])


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
    int64 lanes, with Spark's normalization."""
    d, name = val.data, val.dtype.name
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


def murmur3_fold_device(vals: List[DVal], seed: int) -> torch.Tensor:
    """Spark's murmur3 folded over the columns from ``seed``: int32 per
    row."""
    h = torch.full(vals[0].validity.shape, seed & _M32, dtype=torch.int64,
                   device=vals[0].validity.device)
    for v in vals:
        kind, w = _normalize_to_words(v)
        if kind == "int":
            nh = _fmix_dev(_mix_h1_dev(h, _mix_k1_dev(w)), 4)
        else:
            nh = _mix_h1_dev(h, _mix_k1_dev(w & _M32))
            nh = _fmix_dev(_mix_h1_dev(nh, _mix_k1_dev((w >> 32) & _M32)), 8)
        h = torch.where(v.validity, nh, h)     # a NULL skips the column
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)
