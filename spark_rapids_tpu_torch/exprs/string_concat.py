"""String building on the device: ``concat`` (and SQL ``||``),
``concat_ws`` and ``chr`` (port of the JAX package's ``ConcatStrings``,
``ConcatWs`` and ``Chr``, spark_rapids_tpu/exprs/string_fns.py, which run
on its host engine).

Each child of a concat is a string column, a chain over one
(exprs/string_rect.py), another device expression giving a string, or a
string literal; ``string_column`` gives each as a flat column (a literal
as a dictionary of its one value). Two routes, by the children's layout
in each batch:

  * every child a dictionary and the product of their sizes (a NULL slot
    each for ``concat_ws``) at most ``CONCAT_DICT_MAX``: the result is a
    dictionary column. Its entries are every combination joined once on
    the host, sorted and made unique; a row's code is the mixed-radix
    combination of its children's codes, remapped by one gather;
  * otherwise each child as a byte rectangle (a dictionary's entries
    gathered by code), and each child's bytes written at the running
    offset (the sum of the lengths before it) into a rectangle as wide as
    the children's widths together (a dictionary's: its longest entry),
    bucketed; past
    ``spark.rapids.tpu.sql.string.rect.maxBytes`` it raises.

Spark's NULL rules: ``concat`` is NULL where any child is; ``concat_ws``
skips NULL children and is NULL only for a NULL separator (a string
literal). A list child of ``concat_ws`` and a child of another type (the
cast to string) are refused at planning, naming the slice that brings
them.

``chr(n)`` over an integer column is a dictionary column of its 257
results: ``''`` for n < 0, else the character ``n & 255`` (``'\\0'`` for
0, Spark's answer; the JAX package gives ``''``: ROADMAP.md Queue C).
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch

from ..columnar.strrect import RECT_MAX_BYTES, rect_width_bucket
from ..types import STRING, Schema
from .base import DVal, Expression, Literal

__all__ = ["ConcatStrings", "ConcatWs", "Chr", "CONCAT_DICT_MAX",
           "CHR_DICTIONARY"]

#: combinations of the children's dictionary entries joined on the host,
#: past which a concat of dictionaries writes a byte rectangle instead
CONCAT_DICT_MAX = 4096
#: chr's results in order: '' (n < 0), then the characters 0-255
CHR_DICTIONARY = np.array([""] + [chr(i) for i in range(256)], dtype=object)
#: kept per expression: combined dictionaries and dictionaries as
#: rectangles, by the identity of the dictionaries they came from
_CACHE_MAX = 64


def _string_arg_reason(e: Expression, schema: Schema, what: str):
    """Why a child of a concat has no device form, None when it has."""
    from ..types import ArrayType
    from .collection_fns import STRINGS_REST, string_arg_reason
    dt = e.data_type(schema)
    if isinstance(dt, ArrayType):
        from ..types import NESTED_REST
        return (f"{what} of a list of strings arrives with {NESTED_REST}")
    if dt != STRING and not (isinstance(e, Literal) and e.value is None):
        return (f"{what} of a {dt.name} argument: the cast to string "
                f"arrives with {STRINGS_REST}, casts")
    r = string_arg_reason(e, schema)
    return f"{what}: {r}" if r else None


class _Concat(Expression):
    """What ``concat`` and ``concat_ws`` share: the planning check, the
    two routes (module doc) and their caches."""

    def __init__(self, children):
        self.children = list(children)
        self._cache: dict = {}

    def data_type(self, schema):
        return STRING

    def _parts(self):
        """The children joined (concat_ws: after the separator)."""
        return self.children

    def device_unsupported_reason(self, schema):
        return None

    def fully_device_supported(self, schema) -> Optional[str]:
        for c in self._parts():
            r = _string_arg_reason(c, schema, type(self).__name__)
            if r:
                return r
        return None

    def _sep(self) -> Optional[str]:
        return None

    def _skips_nulls(self) -> bool:
        return False

    def _cached(self, key, dicts, make):
        got = self._cache.get(key)
        if got is None or any(a is not b for a, b in zip(got[0], dicts)):
            if len(self._cache) >= _CACHE_MAX:
                self._cache.clear()
            got = self._cache[key] = (dicts, make())
        return got[1]

    def eval_device(self, ctx) -> DVal:
        from ..columnar import DictColumn
        from .collection_fns import string_column
        from .compiler import column_dval
        cols = [string_column(c, ctx) for c in self._parts()]
        sep = self._sep()
        p = ctx.padded_len
        if self._skips_nulls():
            valid = torch.full((p,), sep is not None, dtype=torch.bool,
                               device=ctx.device)
        else:
            valid = torch.ones(p, dtype=torch.bool, device=ctx.device)
            for c in cols:
                valid = valid & c.validity
        sizes = [len(c.dictionary) + self._skips_nulls()
                 if isinstance(c, DictColumn) else None for c in cols]
        if all(s is not None for s in sizes) \
                and math.prod(sizes) <= CONCAT_DICT_MAX:
            out = self._dictionary(cols, sizes, valid, sep)
        else:
            out = self._rectangle(cols, valid, sep)
        return column_dval(out)

    def _dictionary(self, cols, sizes, valid, sep):
        """Every combination of the children's entries joined once on the
        host (module doc); the rows' codes remapped by one gather."""
        from ..columnar import DictColumn
        skip = self._skips_nulls()
        dicts = tuple(c.dictionary for c in cols)

        def make():
            entries = [list(d) + ([None] if skip else []) for d in dicts]
            joined = [(sep or "").join(v for v in combo if v is not None)
                      for combo in itertools.product(*entries)]
            if not joined:
                return np.zeros(0, object), None
            uniq, inv = np.unique(np.array(joined, dtype=object),
                                  return_inverse=True)
            return uniq.astype(object), torch.from_numpy(
                inv.astype(np.int64).reshape(-1)).to(valid.device)
        uniq, remap = self._cached(("dict",) + tuple(map(id, dicts)), dicts,
                                   make)
        if remap is None:
            codes = torch.zeros_like(valid, dtype=torch.int32)
        else:
            mixed = torch.zeros_like(valid, dtype=torch.int64)
            for c, size in zip(cols, sizes):
                code = c.data.to(torch.int64).clamp(0, max(size - 1, 0))
                if skip:
                    code = torch.where(c.validity, code, size - 1)
                mixed = mixed * size + code
            codes = remap[mixed].to(torch.int32)
        return DictColumn(torch.where(valid, codes, 0), valid, STRING, uniq)

    def _as_rect(self, col):
        """(bytes uint8[P, W], lengths int32[P], ascii, the most bytes a
        row may hold) of a string column; a dictionary's entries gathered
        by code (the entries' rectangle kept per dictionary)."""
        from ..columnar import ByteRectColumn
        if isinstance(col, ByteRectColumn):
            return col.data, col.lengths, col.ascii_only, col.width
        d = col.dictionary

        def make():
            enc = [v.encode("utf-8") for v in d]
            w = rect_width_bucket(max((len(b) for b in enc), default=0),
                                  1 << 30)
            table = np.zeros((max(len(enc), 1), w), np.uint8)
            lens = np.zeros(max(len(enc), 1), np.int32)
            for i, b in enumerate(enc):
                table[i, :len(b)] = np.frombuffer(b, np.uint8)
                lens[i] = len(b)
            dev = col.data.device
            return (torch.from_numpy(table).to(dev),
                    torch.from_numpy(lens).to(dev),
                    all(len(b) == len(v) for b, v in zip(enc, d)),
                    int(lens.max()))
        table, lens, ascii_only, most = self._cached(("rect", id(d)), (d,),
                                                     make)
        idx = col.data.to(torch.int64).clamp(0, table.shape[0] - 1)
        return table[idx], lens[idx], ascii_only, most

    def _rectangle(self, cols, valid, sep):
        """The children's bytes written one after another (module doc)."""
        from ..columnar import ByteRectColumn
        from .collection_fns import STRINGS_REST
        p = valid.shape[0]
        dev = valid.device
        pieces = []                 # (bytes [P, W], lengths [P])
        total = 0                   # the most bytes a row may hold
        ascii_only = True
        seen = torch.zeros(p, dtype=torch.bool, device=dev)
        sep_b = None if sep is None else sep.encode("utf-8")
        for c in cols:
            b, ln, a, most = self._as_rect(c)
            ascii_only &= a
            total += most
            present = c.validity & valid
            if sep_b is not None and pieces:
                lit = torch.tensor(list(sep_b) or [0], dtype=torch.uint8,
                                   device=dev)
                pieces.append((lit[None, :].expand(p, lit.shape[0]),
                               torch.where(present & seen, len(sep_b), 0)))
                ascii_only &= len(sep_b) == len(sep)
                total += len(sep_b)
            pieces.append((b, torch.where(present, ln, 0)))
            seen = seen | present
        cap = RECT_MAX_BYTES.default
        w = rect_width_bucket(max(total, 1), cap)
        if w is None:
            raise NotImplementedError(
                f"<{self.name_hint}>: a concat of strings of up to {total} "
                f"bytes together, past spark.rapids.tpu.sql.string.rect."
                f"maxBytes ({cap}): it arrives with {STRINGS_REST}")
        out = torch.zeros((p, w + 1), dtype=torch.uint8, device=dev)
        off = torch.zeros(p, dtype=torch.int64, device=dev)
        for b, ln in pieces:
            j = torch.arange(b.shape[1], device=dev)[None, :]
            live = j < ln.to(torch.int64)[:, None]
            out.scatter_(1, torch.where(live, off[:, None] + j, w),
                         b.to(torch.uint8))
            off = off + ln.to(torch.int64)
        lengths = torch.where(valid, off, 0).to(torch.int32)
        data = torch.where(valid[:, None], out[:, :w], 0).contiguous()
        return ByteRectColumn(data, valid, lengths, ascii_only)


class ConcatStrings(_Concat):
    """concat(s1, s2, ...) and SQL ``||``: NULL where any child is."""

    def __init__(self, *children):
        super().__init__(children)


class ConcatWs(_Concat):
    """concat_ws(sep, s1, s2, ...): the non-NULL children joined by
    ``sep`` (a string literal); NULL only for a NULL separator."""

    def __init__(self, sep, *children):
        super().__init__([sep] + list(children))

    def _parts(self):
        return self.children[1:]

    def _sep(self):
        return self.children[0].value

    def _skips_nulls(self) -> bool:
        return True

    def fully_device_supported(self, schema):
        from .collection_fns import STRINGS_REST, _string_literal
        if not _string_literal(self.children[0]):
            return (f"concat_ws with a separator that is not a string "
                    f"literal arrives with {STRINGS_REST}")
        return super().fully_device_supported(schema)


class Chr(Expression):
    """chr(n): '' for n < 0, else the character n & 255 ('\\0' for 0:
    Spark's ``Chr``)."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self, schema):
        return STRING

    def device_unsupported_reason(self, schema):
        from ..types import DecimalType
        dt = self.children[0].data_type(schema)
        if dt.np_dtype is None or dt.np_dtype.kind not in "iu" \
                or isinstance(dt, DecimalType):
            return f"chr of a {dt.name} argument"
        return None

    def fully_device_supported(self, schema):
        return self.device_unsupported_reason(schema) or \
            self.children[0].fully_device_supported(schema)

    def eval_device(self, ctx) -> DVal:
        from ..columnar import DictColumn
        from .compiler import column_dval
        v = self.children[0].eval_device(ctx)
        n = v.data.to(torch.int64)
        code = torch.where(n < 0, 0, (n & 255) + 1).to(torch.int32)
        return column_dval(DictColumn(torch.where(v.validity, code, 0),
                                      v.validity, STRING, CHR_DICTIONARY))

    @staticmethod
    def host_value(n: int) -> str:
        return "" if n < 0 else chr(n & 255)
