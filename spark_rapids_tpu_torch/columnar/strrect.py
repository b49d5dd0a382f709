"""Device strings as dense byte rectangles (port of
``spark_rapids_tpu/columnar/strrect.py``, the layout and its encoder).

A high-cardinality STRING column lives on the device as

  bytes_[P, W] uint8   zero past each row's length
  lengths[P]   int32   byte length per row
  validity[P]  bool

with W the smallest power of two >= the longest value (floor 8), up to
``rect.maxBytes``. ``ascii_only`` records whether every byte is below
0x80, where a byte is a character.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import register
from ..types import STRING
from .column import DeviceColumn

__all__ = ["ByteRectColumn", "RECT_MAX_BYTES", "rect_width_bucket",
           "encode_string_rect", "utf8_bytes", "pack_words", "unpack_words"]

RECT_MAX_BYTES = register(
    "spark.rapids.tpu.sql.string.rect.maxBytes", 64,
    "Width cap for the device byte-rectangle string layout: columns "
    "whose longest value exceeds this stay host-resident. Power of two.")


def rect_width_bucket(max_len: int, cap: int) -> Optional[int]:
    """Smallest power-of-two width >= max_len (floor 8), or None past
    the cap."""
    w = 8
    while w < max_len:
        w <<= 1
    return w if w <= cap else None


def utf8_bytes(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """A string array (``S``, ``U`` or object) as a numpy ``S`` array of
    UTF-8 bytes; invalid slots become b"". An ``S`` array is taken to be
    UTF-8 already and passes through without a copy."""
    if values.dtype.kind == "S":
        return values
    if values.dtype.kind == "U":
        out = np.char.encode(values, "utf-8")
    else:
        out = np.array([v.encode("utf-8") if ok else b""
                        for v, ok in zip(values, valid)], dtype=object)
        out = out.astype("S") if len(out) else np.zeros(0, "S1")
    if not valid.all():
        out = np.where(valid, out, b"")
    return out


def encode_string_rect(values: np.ndarray, valid: np.ndarray,
                       padded: int, cap: int):
    """UTF-8 ``S`` array -> (rect uint8[P, W], lengths int32[P],
    valid bool[P], ascii_only), or None when the longest value is wider
    than ``cap``. Vectorised: the ``S`` array's buffer already is the
    rectangle, zero-padded past each value."""
    n, k = len(values), values.dtype.itemsize
    raw = np.ascontiguousarray(values).view(np.uint8).reshape(n, k)
    lens = np.char.str_len(values).astype(np.int32)
    w = rect_width_bucket(int(lens.max()) if n else 0, cap)
    if w is None:
        return None
    rect = np.zeros((padded, w), np.uint8)
    rect[:n, :min(w, k)] = raw[:, :min(w, k)]
    lengths = np.zeros(padded, np.int32)
    lengths[:n] = lens
    v = np.zeros(padded, bool)
    v[:n] = valid
    return rect, lengths, v, bool((rect < 0x80).all())


_SIGN = -0x8000000000000000


def pack_words(bytes_: torch.Tensor) -> torch.Tensor:
    """uint8[P, W] (W a multiple of 8) -> int64[P, W/8] order-preserving
    words: each 8 bytes read big-endian, the sign bit flipped, so that the
    signed order of the words is the unsigned order of the bytes. Bytes
    past a row's length are zero and compare below every real byte, so a
    string sorts before its extensions. One byte flip and one view, not
    eight shifts a word (the reference's ``pack_words``)."""
    p, w = bytes_.shape
    be = bytes_.reshape(p, w // 8, 8).flip(-1).contiguous()
    return be.view(torch.int64).reshape(p, w // 8) ^ _SIGN


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_words``: int64[P, K] -> uint8[P, 8K]."""
    p, k = words.shape
    raw = (words ^ _SIGN).contiguous().view(torch.uint8).reshape(p, k, 8)
    return raw.flip(-1).reshape(p, 8 * k).contiguous()


class ByteRectColumn(DeviceColumn):
    """STRING column on the device as a byte rectangle (module doc)."""

    __slots__ = ("lengths", "ascii_only")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 lengths: torch.Tensor, ascii_only: bool = True):
        super().__init__(data, validity, STRING)
        self.lengths = lengths
        self.ascii_only = ascii_only

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    def nbytes(self) -> int:
        return (self.data.numel() + self.validity.numel()
                + 4 * self.lengths.numel())

    def with_arrays(self, data, validity):
        raise TypeError("ByteRectColumn rows move with their lengths")

    def gather(self, idx: torch.Tensor) -> "ByteRectColumn":
        return ByteRectColumn(self.data[idx], self.validity[idx],
                              self.lengths[idx], self.ascii_only)

    def to_numpy(self, num_rows: int):
        rect = self.data[:num_rows].cpu().numpy()
        v = self.validity[:num_rows].cpu().numpy()
        w = rect.shape[1]
        vals = np.ascontiguousarray(rect).view(f"S{w}").reshape(num_rows)
        if self.ascii_only:         # ASCII: numpy's cast decodes it
            return vals.astype(f"U{w}").astype(object), v
        out = np.char.decode(vals, "utf-8", "replace").astype(object)
        return out, v

    def __repr__(self):
        return f"ByteRectColumn(width={self.width}, padded={self.padded_len})"
