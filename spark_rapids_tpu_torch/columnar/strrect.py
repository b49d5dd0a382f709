"""Device strings as dense byte rectangles (port of
``spark_rapids_tpu/columnar/strrect.py``, the layout and its encoder).

A high-cardinality STRING column lives on the device as

  bytes_[P, W] uint8   zero past each row's length
  lengths[P]   int32   byte length per row
  validity[P]  bool

with W the smallest power of two >= the longest value (floor 8), up to
``rect.maxBytes``. ``ascii_only`` records whether every byte is below
0x80, where a byte is a character.

On the host a string column's UTF-8 bytes are a ``HostStrings``: a numpy
``S`` array and each value's byte length. numpy drops a value's trailing
0x00 bytes on every read of an ``S`` array (an item, ``np.char.str_len``,
``np.unique``, ``np.char.decode``), so ``b"a"`` and ``b"a\x00"`` share a
buffer and read alike; the lengths keep them apart from the point where
they are known (a Python ``str`` or ``bytes``, an Arrow column, a Parquet
page, a rectangle's ``lengths``) to the device and back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import register
from ..types import STRING
from .column import DeviceColumn

__all__ = ["ByteRectColumn", "HostStrings", "RECT_MAX_BYTES",
           "rect_width_bucket", "encode_string_rect", "utf8_bytes",
           "pack_words", "unpack_words", "kernel_rows"]

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


def kernel_rows(bytes_: torch.Tensor) -> torch.Tensor:
    """A rectangle as the kernels read it: row-major and 16-byte aligned;
    the tensor itself where it is, else a row-major copy (``clone()``
    alone keeps the strides of a dense tensor that is not row-major)."""
    if bytes_.is_contiguous() and bytes_.data_ptr() % 16 == 0:
        return bytes_
    return bytes_.clone(memory_format=torch.contiguous_format)


class HostStrings:
    """UTF-8 strings on the host: ``s``, an ``S`` array whose buffer holds
    each value zero-padded, and ``lengths``, each value's byte length
    (int32). Built without lengths, the values are numpy's own (an ``S``
    or ``U`` array handed in: none ends in 0x00, each length is
    ``np.char.str_len``, computed when first asked). Sliced and indexed
    like an array."""

    __slots__ = ("s", "_lengths", "_cut")

    def __init__(self, s: np.ndarray, lengths: Optional[np.ndarray] = None):
        self.s = s
        self._lengths = lengths
        self._cut = None if lengths is None else False

    def __len__(self) -> int:
        return len(self.s)

    def __getitem__(self, idx) -> "HostStrings":
        out = HostStrings(self.s[idx], None if self._lengths is None
                          else self._lengths[idx])
        if self._cut is None:               # no value of a part has a cut
            out._cut = None
        elif self._cut is not False:
            cut = self._cut[idx]
            out._cut = cut if cut.any() else None
        return out

    @property
    def lengths(self) -> np.ndarray:
        if self._lengths is None:
            self._lengths = np.char.str_len(self.s).astype(np.int32)
        return self._lengths

    @property
    def nbytes(self) -> int:
        return self.s.nbytes + (0 if self._lengths is None
                                else self._lengths.nbytes)

    def cut(self) -> Optional[np.ndarray]:
        """Per value, the trailing 0x00 bytes that numpy's reads of ``s``
        drop (int32), or None when no value has any."""
        if self._cut is False:
            cut = self._lengths - np.char.str_len(self.s).astype(np.int32)
            self._cut = cut if cut.any() else None
        return self._cut

    @staticmethod
    def concat(parts) -> "HostStrings":
        if all(p._lengths is None for p in parts):
            return HostStrings(np.concatenate([p.s for p in parts]))
        return HostStrings(np.concatenate([p.s for p in parts]),
                           np.concatenate([p.lengths for p in parts]))

    def to_objects(self, errors: str = "strict",
                   ascii_only: bool = False) -> np.ndarray:
        """The values as an object array of ``str``, trailing 0x00 bytes
        included (``ascii_only``: every byte is below 0x80, and numpy's
        cast decodes it)."""
        if ascii_only:
            out = self.s.astype(f"U{self.s.dtype.itemsize}").astype(object)
        elif len(self.s):
            out = np.char.decode(self.s, "utf-8", errors).astype(object)
        else:
            out = np.zeros(0, object)
        cut = self.cut()
        if cut is not None:
            for i in np.flatnonzero(cut):
                out[i] = out[i] + "\x00" * int(cut[i])
        return out


def _encoded(values) -> list:
    try:
        return [v.encode("utf-8") for v in values]
    except AttributeError:
        return [v if isinstance(v, bytes) else v.encode("utf-8")
                for v in values]


def utf8_bytes(values, valid: np.ndarray) -> HostStrings:
    """A string array (``S``, ``U`` or object of ``str``/``bytes``) as
    ``HostStrings`` of UTF-8 bytes; invalid slots become b"". An ``S``
    array is taken to be UTF-8 already and passes through without a copy,
    as does a ``HostStrings``. Python strings keep their trailing NULs
    (exact lengths); an ``S`` or ``U`` array's values are numpy's."""
    if isinstance(values, HostStrings):
        return values
    if values.dtype.kind == "S":
        return HostStrings(values)
    if values.dtype.kind == "U":
        out = np.char.encode(values, "utf-8")
        if not valid.all():
            out = np.where(valid, out, b"")
        return HostStrings(out)
    if not len(values):
        return HostStrings(np.zeros(0, "S1"), np.zeros(0, np.int32))
    enc = _encoded(values if valid.all() else
                   np.where(valid, values, ""))
    return HostStrings(np.array(enc, dtype="S"),
                       np.fromiter(map(len, enc), np.int32, len(enc)))


def encode_string_rect(values: HostStrings, valid: np.ndarray,
                       padded: int, cap: int):
    """UTF-8 ``HostStrings`` -> (rect uint8[P, W], lengths int32[P],
    valid bool[P], ascii_only), or None when the longest value is wider
    than ``cap``. Vectorised: the ``S`` array's buffer already is the
    rectangle, zero-padded past each value."""
    n, k = len(values), values.s.dtype.itemsize
    raw = np.ascontiguousarray(values.s).view(np.uint8).reshape(n, k)
    lens = values.lengths
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
        raise TypeError("ByteRectColumn rows move with their lengths: use "
                        "columnar.nested.take_rows()")

    def to_numpy(self, num_rows: int):
        rect = self.data[:num_rows].cpu().numpy()
        v = self.validity[:num_rows].cpu().numpy()
        w = rect.shape[1]
        vals = np.ascontiguousarray(rect).view(f"S{w}").reshape(num_rows)
        lens = self.lengths[:num_rows].cpu().numpy().astype(np.int32)
        return HostStrings(vals, lens).to_objects(
            "replace", self.ascii_only), v

    def __repr__(self):
        return f"ByteRectColumn(width={self.width}, padded={self.padded_len})"
