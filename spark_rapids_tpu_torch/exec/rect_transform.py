"""String transform chains over byte rectangles: the hand-written CUDA
kernel ``rect_transform``, its plain PyTorch version, and the chain's
output widths.

Replaces the jitted ``jax.numpy`` transforms of
``spark_rapids_tpu/exprs/string_rect.py`` (``_upper`` :74, ``_lower`` :80,
``_trim`` :86, ``_substring`` :111, ``_replace`` :222, ``_pad`` :263,
``_substring_index`` :363, ``_reverse`` :389), which the reference fuses
into one XLA kernel a chain (``exprs/compiler.py:compile_rect_chain``
:478). No Pallas kernel: eager torch would need dozens of launches a
batch for one ``upper(trim(s))`` (the realign is W masked shifts, the
non-overlapping match of replace W sequential steps), so one hand-written
kernel evaluates a whole chain a batch (``csrc/rect_transform.cu``, its
row logic ``csrc/rect_transform_row.cuh``; the source's note gives the
bound and the design).

A chain is a list of ops, each a tuple:

  ("upper",) ("lower",) ("reverse",) ("initcap",)
  ("trim", left, right)                   space (0x20) only, as Spark
  ("substring", pos, length or None)      Spark's 1-based pos; 0 as 1;
                                          negative from the end
  ("replace", search, replacement)        bytes; non-overlapping, left to
                                          right; len(search) >= 1
  ("pad", length, pad, left)              length >= 1, pad bytes >= 1
  ("substring_index", delim, count)       bytes; len(delim) >= 1; matches
                                          may overlap (Spark's search)
  ("repeat", times)                       times >= 0
  ("translate", from, to)                 bytes; from's first occurrence
                                          wins; past to's end, or to a
                                          0x00 byte, deleted (Spark)

over an ASCII rectangle ``bytes_`` uint8[P, W] (zero past each row's
length), ``lengths`` int32[P], ``validity`` bool[P]. The output is a
rectangle of the width ``chain_widths`` computes on the host by the
reference's rules, zero past each row's new length; an invalid row is all
zeros with length 0 (grouping on words relies on it). A chain whose width
would pass the cap raises ``NotImplementedError``: the reference runs such
a batch on its host engine, which the port does not have.

``rect_transform`` launches the kernel for a CUDA tensor (or raises) and
runs ``rect_transform_reference`` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.strrect import kernel_rows, rect_width_bucket

__all__ = ["OPCODES", "HEAVY_OPS", "MAX_OPS", "MAX_LITERAL", "MAX_WIDTH", "BLOCK_THREADS",
           "chain_widths", "pack_chain", "rect_transform",
           "rect_transform_reference", "launch_shape"]

#: op name -> the kernel's op code (csrc/rect_transform_row.cuh RtOpCode)
OPCODES = {"upper": 1, "lower": 2, "trim": 3, "substring": 4, "replace": 5,
           "pad": 6, "substring_index": 7, "reverse": 8, "initcap": 9,
           "repeat": 10, "translate": 11}
#: ops the kernel runs in its heavier instance (rt_chain_matches)
HEAVY_OPS = ("replace", "substring_index", "repeat", "translate")
#: ops a launch takes, literal bytes an op takes, widest row (in or out);
#: csrc/rect_transform_row.cuh kRtMaxOps, kRtMaxLiteral, kRtMaxWidth
MAX_OPS = 8
MAX_LITERAL = 32
MAX_WIDTH = 64
#: threads of a block (csrc/rect_transform.cu kRtBlock)
BLOCK_THREADS = 256
#: bytes of one op and of the chain as the kernel reads them (RtOp,
#: RtChain): 8 int32 fields and two literals; 4 int32 then the ops
_OP_BYTES = 32 + 2 * MAX_LITERAL
_CHAIN_BYTES = 16 + MAX_OPS * _OP_BYTES
#: bytes of one op's repeated pad in shared memory (kRtRepBytes)
_REP_BYTES = 80

_NOT_YET = "slice 7, strings, the rest (ROADMAP.md Queue A)"


# ---------------------------------------------------------------------------
# widths
# ---------------------------------------------------------------------------

def _op_width(op: tuple, w: int, cap: int) -> int:
    """The width of ``op``'s output over a rectangle of width ``w``: the
    reference's rules (string_rect.py ``_substring``, ``_replace``,
    ``_pad``), with growth allowed up to ``max(cap, w)``."""
    name = op[0]
    if name == "substring":
        length = op[2]
        if length is not None:
            wb = rect_width_bucket(max(length, 1), w)
            if wb is not None and wb < w:
                return wb
        return w
    if name == "replace":
        l1, l2 = len(op[1]), len(op[2])
        need = w + max(0, l2 - l1) * (w // l1)
        wo = rect_width_bucket(max(need, 1), max(cap, w))
        if wo is None:
            raise NotImplementedError(
                f"replace({op[1]!r}, {op[2]!r}) grows a {w}-byte rectangle "
                f"to {need} bytes, past spark.rapids.tpu.sql.string.rect."
                f"maxBytes ({cap}): such batches arrive with {_NOT_YET}")
        return wo
    if name == "repeat":
        need = w * max(op[1], 0)
        wo = rect_width_bucket(max(need, 1), max(cap, w))
        if wo is None:
            raise NotImplementedError(
                f"repeat({op[1]}) grows a {w}-byte rectangle to {need} "
                f"bytes, past spark.rapids.tpu.sql.string.rect.maxBytes "
                f"({cap}): such batches arrive with {_NOT_YET}")
        return wo
    if name == "pad":
        wo = rect_width_bucket(max(op[1], 1), max(cap, w))
        if wo is None:
            raise NotImplementedError(
                f"pad to {op[1]} characters is wider than spark.rapids.tpu."
                f"sql.string.rect.maxBytes ({cap}): such batches arrive with "
                f"{_NOT_YET}")
        return wo
    return w


def chain_widths(ops: Sequence[tuple], w: int, cap: int) -> List[int]:
    """[input width, each op's output width] of a chain over a rectangle
    of width ``w``; raises NotImplementedError past the cap."""
    out = [w]
    for op in ops:
        out.append(_op_width(op, out[-1], cap))
    return out


# ---------------------------------------------------------------------------
# the plain PyTorch version (the reference's jnp transforms, op for op)
# ---------------------------------------------------------------------------

def _cols(w: int, device) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int64, device=device)[None, :]


def _zero_tail(b: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    live = _cols(b.shape[1], b.device) < ln.to(torch.int64)[:, None]
    return torch.where(live, b, torch.zeros((), dtype=b.dtype,
                                            device=b.device))


def _take(b: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[p, j] = b[p, src[p, j]], 0 where src is outside [0, W)."""
    w = b.shape[1]
    bx = torch.nn.functional.pad(b, (0, 1))
    src = torch.where((src >= 0) & (src < w), src, torch.full_like(src, w))
    return torch.gather(bx, 1, src)


def _matches(b: torch.Tensor, ln: torch.Tensor, pat: bytes) -> torch.Tensor:
    """bool[P, W]: ``pat`` starts at j and ends within the length."""
    p, w = b.shape
    L = len(pat)
    m = torch.zeros((p, w), dtype=torch.bool, device=b.device)
    if L > w:
        return m
    n = w - L + 1
    hit = b[:, 0:n] == pat[0]
    for k in range(1, L):
        hit &= b[:, k:k + n] == pat[k]
    m[:, :n] = hit
    return m & (_cols(w, b.device) + L <= ln.to(torch.int64)[:, None])


def _select_nonoverlap(b: torch.Tensor, ln: torch.Tensor, pat: bytes):
    """Greedy left-to-right non-overlapping occurrences of ``pat`` (the
    reference's ``_select_nonoverlap``): sel[p, j] marks occurrence
    starts."""
    match = _matches(b, ln, pat)
    p, w = b.shape
    L = len(pat)
    next_free = torch.zeros(p, dtype=torch.int64, device=b.device)
    sel = torch.zeros_like(match)
    for j in range(w):
        s = match[:, j] & (next_free <= j)
        next_free = torch.where(s, torch.full_like(next_free, j + L),
                                next_free)
        sel[:, j] = s
    return sel


def _upper(b, ln):
    low = (b >= 97) & (b <= 122)
    return torch.where(low, b - 32, b), ln


def _lower(b, ln):
    up = (b >= 65) & (b <= 90)
    return torch.where(up, b + 32, b), ln


def _initcap(b, ln):
    """The first byte of every space-separated word upper case, the others
    lower case (the reference's ``InitCap._initcap`` over ASCII)."""
    prev = torch.nn.functional.pad(b[:, :-1], (1, 0), value=32)
    first = prev == 32
    low = (b >= 97) & (b <= 122)
    up = (b >= 65) & (b <= 90)
    out = torch.where(first & low, b - 32, b)
    return torch.where(~first & up, b + 32, out), ln


def _trim(b, ln, left: bool, right: bool):
    """Space-only trim (SPARK-17299); an all-space row trims to 0."""
    w = b.shape[1]
    j = _cols(w, b.device)
    ln64 = ln.to(torch.int64)
    nonsp = (j < ln64[:, None]) & (b != 32)
    lead = torch.zeros_like(ln64)
    if left:
        lead = torch.minimum(torch.where(nonsp, j, w).min(dim=1).values,
                             ln64)
    trail = torch.zeros_like(ln64)
    if right:
        last = torch.where(nonsp, j, -1).max(dim=1).values
        trail = torch.where(last >= 0, ln64 - 1 - last, ln64)
    new_len = torch.clamp(ln64 - lead - trail, min=0)
    out = _take(b, j + lead[:, None])
    return _zero_tail(out, new_len), new_len.to(torch.int32)


def _substring(b, ln, pos: int, length: Optional[int], wo: int):
    """Spark's substring: 1-based ``pos``, 0 as 1, negative from the end
    (the reference takes ``pos >= 0`` on the device; the port also takes
    a negative one, Spark's ``substringSQL``)."""
    ln64 = ln.to(torch.int64)
    if pos > 0:
        start = torch.full_like(ln64, pos - 1)
    elif pos < 0:
        start = ln64 + pos
    else:
        start = torch.zeros_like(ln64)
    end = ln64 if length is None else start + length
    start = torch.clamp(start, min=0)
    end = torch.minimum(end, ln64)
    new_len = torch.clamp(end - start, min=0)
    out = _take(b, _cols(wo, b.device) + start[:, None])
    return _zero_tail(out, new_len), new_len.to(torch.int32)


def _replace(b, ln, search: bytes, rep: bytes, wo: int):
    """Non-overlapping, left to right; the output is ``wo`` wide."""
    p, w = b.shape
    l1, l2 = len(search), len(rep)
    sel = _select_nonoverlap(b, ln, search)
    cov = torch.zeros_like(sel)
    for k in range(1, min(l1, w)):
        cov[:, k:] |= sel[:, :-k]
    live = _cols(w, b.device) < ln.to(torch.int64)[:, None]
    emit = torch.where(sel, l2, torch.where(cov | ~live, 0, 1)) \
        .to(torch.int64)
    outpos = torch.cumsum(emit, dim=1) - emit
    new_len = emit.sum(dim=1)
    out = torch.zeros((p, wo + 1), dtype=torch.uint8, device=b.device)
    dump = torch.full_like(outpos, wo)
    out.scatter_(1, torch.where(sel | cov | ~live, dump, outpos), b)
    for k in range(l2):
        idx = torch.where(sel, outpos + k, dump)
        out.scatter_(1, idx, torch.full_like(b, rep[k]))
    return _zero_tail(out[:, :wo], new_len), new_len.to(torch.int32)


def _pad(b, ln, length: int, pad: bytes, left: bool, wo: int):
    """lpad/rpad to ``length`` with ``pad`` repeated; a longer row keeps
    its prefix (Spark)."""
    w = b.shape[1]
    bx = torch.nn.functional.pad(b, (0, wo - w)) if wo > w else b[:, :wo]
    j = _cols(wo, b.device)
    fill = torch.tensor(list(np.resize(np.frombuffer(pad, np.uint8), wo)),
                        dtype=torch.uint8, device=b.device)[None, :]
    ln64 = ln.to(torch.int64)[:, None]
    if left:
        src = j - torch.clamp(length - ln64, min=0)
        out = torch.where(src >= 0, _take(bx, src), fill)
    else:
        k = torch.clamp(j - ln64, 0, wo - 1)
        out = torch.where(j < ln64, bx, fill.expand_as(bx).gather(1, k))
    new_len = torch.full_like(ln, length)
    return _zero_tail(out, new_len), new_len


def _substring_index(b, ln, delim: bytes, count: int):
    """Spark's ``subStringIndex``: the count-th match from the left, or
    the |count|-th from the right, among all matches, overlapping ones
    included (each search starts one past the last match); the reference
    counts non-overlapping matches only, which differs for a delimiter
    that overlaps itself (ROADMAP.md Queue C)."""
    w = b.shape[1]
    if count == 0:
        return torch.zeros_like(b), torch.zeros_like(ln)
    sel = _matches(b, ln, delim)
    cum = torch.cumsum(sel.to(torch.int32), dim=1)
    j = _cols(w, b.device)
    ln64 = ln.to(torch.int64)
    if count > 0:
        cut = torch.where(sel & (cum == count), j, w).min(dim=1).values
        new_len = torch.minimum(ln64, cut)
        return _zero_tail(b, new_len), new_len.to(torch.int32)
    target = cum[:, -1].to(torch.int64) + count + 1
    mask = sel & (cum == target[:, None])
    start = torch.where(mask, j, 0).max(dim=1).values + len(delim)
    start = torch.where(target >= 1, start, torch.zeros_like(start))
    new_len = torch.clamp(ln64 - start, min=0)
    out = _take(b, j + start[:, None])
    return _zero_tail(out, new_len), new_len.to(torch.int32)


def _reverse(b, ln):
    j = _cols(b.shape[1], b.device)
    out = _take(b, ln.to(torch.int64)[:, None] - 1 - j)
    return _zero_tail(out, ln), ln


def _repeat(b, ln, times: int, wo: int):
    """The row ``times`` times over: output byte j is row byte j mod
    len, below len x times."""
    ln64 = ln.to(torch.int64)[:, None]
    j = _cols(wo, b.device)
    src = torch.where(ln64 > 0, j % ln64.clamp(min=1), -1)
    new_len = (ln.to(torch.int64) * max(times, 0)).clamp(max=wo)
    return _zero_tail(_take(b, src), new_len), new_len.to(torch.int32)


def _translate(b, ln, src: bytes, dst: bytes):
    """Each byte of ``src`` to the byte of ``dst`` at its position, the
    first occurrence winning; past ``dst``'s end, or to 0x00, deleted, and
    the kept bytes moved together."""
    to = np.arange(256, dtype=np.uint8)
    gone = np.zeros(256, bool)
    seen = set()
    for i, c in enumerate(src):
        if c in seen:
            continue
        seen.add(c)
        if i < len(dst) and dst[i] != 0:
            to[c] = dst[i]
        else:
            gone[c] = True
    p, w = b.shape
    idx = b.long()
    mapped = torch.from_numpy(to).to(b.device)[idx]
    live = _cols(w, b.device) < ln.to(torch.int64)[:, None]
    keep = live & ~torch.from_numpy(gone).to(b.device)[idx]
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - keep.to(torch.int64)
    out = torch.zeros((p, w + 1), dtype=torch.uint8, device=b.device)
    out.scatter_(1, torch.where(keep, pos, w), mapped)
    new_len = keep.sum(dim=1)
    return _zero_tail(out[:, :w], new_len), new_len.to(torch.int32)


def _apply(op: tuple, b, ln, wo: int):
    name = op[0]
    if name == "upper":
        return _upper(b, ln)
    if name == "lower":
        return _lower(b, ln)
    if name == "initcap":
        return _initcap(b, ln)
    if name == "reverse":
        return _reverse(b, ln)
    if name == "trim":
        return _trim(b, ln, op[1], op[2])
    if name == "substring":
        return _substring(b, ln, op[1], op[2], wo)
    if name == "replace":
        return _replace(b, ln, op[1], op[2], wo)
    if name == "pad":
        return _pad(b, ln, op[1], op[2], op[3], wo)
    if name == "substring_index":
        return _substring_index(b, ln, op[1], op[2])
    if name == "repeat":
        return _repeat(b, ln, op[1], wo)
    if name == "translate":
        return _translate(b, ln, op[1], op[2])
    raise ValueError(f"unknown rect transform {name!r}")


def rect_transform_reference(bytes_: torch.Tensor, lengths: torch.Tensor,
                             validity: torch.Tensor, ops: Sequence[tuple],
                             cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chain: each op as the reference's
    vector transform, in order; invalid rows all zeros, length 0."""
    _check(bytes_, lengths, validity, ops)
    widths = chain_widths(ops, bytes_.shape[1], cap)
    b, ln = _zero_tail(bytes_, lengths), lengths
    for op, wo in zip(ops, widths[1:]):
        b, ln = _apply(op, b, ln, wo)
    ln = torch.where(validity, ln.to(torch.int32), 0)
    return _zero_tail(b, ln), ln


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _check(bytes_, lengths, validity, ops) -> None:
    if bytes_.dtype != torch.uint8 or bytes_.dim() != 2:
        raise TypeError("bytes_ must be a uint8[P, W] tensor")
    p = bytes_.shape[0]
    if lengths.dtype != torch.int32 or lengths.shape != (p,):
        raise TypeError("lengths must be an int32[P] tensor")
    if validity.dtype != torch.bool or validity.shape != (p,):
        raise TypeError("validity must be a bool[P] tensor")
    if not (bytes_.device == lengths.device == validity.device):
        raise ValueError("bytes_, lengths and validity lie on different "
                         "devices")
    if not ops:
        raise ValueError("a rect transform chain needs at least one op")
    for op in ops:
        if op[0] not in OPCODES:
            raise ValueError(f"unknown rect transform {op[0]!r}")


def pack_chain(ops: Sequence[tuple], widths: Sequence[int]) -> np.ndarray:
    """The chain as the kernel's ``RtChain`` (csrc/rect_transform_row.cuh):
    uint8[784]."""
    if len(ops) > MAX_OPS:
        raise NotImplementedError(
            f"a chain of {len(ops)} string transforms: the kernel takes "
            f"{MAX_OPS}; longer chains arrive with {_NOT_YET}")
    buf = np.zeros(_CHAIN_BYTES, np.uint8)
    buf[:4] = np.frombuffer(np.int32(len(ops)).tobytes(), np.uint8)
    for k, (op, w_in, w_out) in enumerate(zip(ops, widths, widths[1:])):
        name = op[0]
        a = b = c = 0
        lit1 = lit2 = b""
        if name == "trim":
            a, b = int(op[1]), int(op[2])
        elif name == "substring":
            clamp = lambda v: int(min(max(v, -(1 << 31)), (1 << 31) - 1))
            a = clamp(op[1])
            if op[2] is not None:
                b, c = clamp(op[2]), 1
        elif name == "replace":
            lit1, lit2 = op[1], op[2]
        elif name == "pad":
            a, b, lit1 = int(op[1]), int(op[3]), op[2]
        elif name == "substring_index":
            lit1, a = op[1], int(op[2])
        elif name == "repeat":
            a = int(min(max(op[1], 0), (1 << 31) - 1))
        elif name == "translate":
            lit1, lit2 = op[1], op[2]
        for lit in (lit1, lit2):
            if len(lit) > MAX_LITERAL:
                raise NotImplementedError(
                    f"{name} with a {len(lit)}-byte literal: the kernel "
                    f"takes {MAX_LITERAL}; longer ones arrive with "
                    f"{_NOT_YET}")
        off = 16 + k * _OP_BYTES
        head = np.array([OPCODES[name], a, b, c, w_in, w_out, len(lit1),
                         len(lit2)], np.int32)
        buf[off:off + 32] = head.view(np.uint8)
        buf[off + 32:off + 32 + len(lit1)] = np.frombuffer(lit1, np.uint8)
        buf[off + 64:off + 64 + len(lit2)] = np.frombuffer(lit2, np.uint8)
    return buf


def launch_shape(ops: Sequence[tuple], rows: int, w: int, cap: int) -> dict:
    """The launch of the chain ``ops`` over ``rows`` rows ``w`` bytes wide
    (on the card: the grid comes from the kernel's library): a row on a
    group of widest / 16 lanes (at least one; 16 bytes a lane), sets of 32
    / lanes rows a warp, the next set loaded while one is computed,
    BLOCK_THREADS threads a block, as many blocks as the card holds at
    once (the warps walk the sets); static shared memory holds the chain,
    each op's repeated pad and 16 bytes of scratch a thread. A chain with
    a literal match runs the kernel's instance that has the match code."""
    widest = max(chain_widths(ops, w, cap))
    match = any(op[0] in HEAVY_OPS for op in ops)
    lanes = max(1, widest // 16)
    lib = _launcher()[1]
    return {"grid": int(lib.rect_transform_grid(rows, widest, int(match))),
            "block": BLOCK_THREADS, "lanes_per_row": lanes,
            "rows_per_set": 32 // lanes, "match": match,
            "smem_bytes": MAX_OPS * (_OP_BYTES + _REP_BYTES)
            + 16 * BLOCK_THREADS}


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _launcher():
    """(the launch function, the library)."""
    from .. import native
    lib = native.load("rect_transform")
    fn = lib.rect_transform_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.rect_transform_grid.argtypes = [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int]
        lib.rect_transform_grid.restype = ctypes.c_int64
        lib.rect_transform_chain_bytes.restype = ctypes.c_int
        got = lib.rect_transform_chain_bytes()
        if got != _CHAIN_BYTES:
            raise RuntimeError(f"RtChain is {got} bytes in the kernel, "
                               f"{_CHAIN_BYTES} here")
    return fn, lib


def rect_transform(bytes_: torch.Tensor, lengths: torch.Tensor,
                   validity: torch.Tensor, ops: Sequence[tuple],
                   cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain ``ops`` over every row (module doc): (bytes uint8[P, Wo],
    lengths int32[P]). On a CUDA tensor one kernel launch (or an error);
    on a CPU tensor ``rect_transform_reference``."""
    _check(bytes_, lengths, validity, ops)
    if bytes_.device.type == "cpu":
        return rect_transform_reference(bytes_, lengths, validity, ops, cap)
    if bytes_.device.type != "cuda":
        raise ValueError(f"rect_transform has no kernel for "
                         f"{bytes_.device}")
    widths = chain_widths(ops, bytes_.shape[1], cap)
    if max(widths) > MAX_WIDTH or widths[0] % 8:
        raise NotImplementedError(
            f"string transforms over {widths[0]}-byte rows (widths "
            f"{widths}): the kernel takes rows of 8 to {MAX_WIDTH} bytes; "
            f"wider ones arrive with {_NOT_YET}")
    chain = pack_chain(ops, widths)
    p = bytes_.shape[0]
    dev = bytes_.device
    out = torch.empty((p, widths[-1]), dtype=torch.uint8, device=dev)
    out_len = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out, out_len
    bytes_ = kernel_rows(bytes_)
    lengths = lengths.contiguous()
    validity = validity.contiguous()
    fn = _launcher()[0]
    rc = fn(bytes_.data_ptr(), lengths.data_ptr(), validity.data_ptr(), p,
            widths[0], widths[-1], chain.ctypes.data, out.data_ptr(),
            out_len.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rect_transform kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNT_LOCK:           # queries on several threads launch it
        rect_transform.launches += 1
    return out, out_len


#: kernel launches since the count was last set to 0
rect_transform.launches = 0
_COUNT_LOCK = threading.Lock()
