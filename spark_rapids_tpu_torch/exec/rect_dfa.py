"""LIKE of any pattern and RLIKE over byte rectangles: the hand-written
CUDA kernel ``rect_dfa``, its plain PyTorch version, and the launch
count.

The JAX package runs these patterns on its host engine
(``spark_rapids_tpu/exprs/string_fns.py``, ``Like``/``RLike.eval_host``);
it has no TPU kernel for them. The port has no host engine and PyTorch
has no call that matches a regular expression, so the pattern is compiled
once on the host to a DFA over bytes (exprs/regex_dfa.py) and each row of
an ASCII rectangle is walked through it: ``csrc/rect_dfa.cu``, its row
logic ``csrc/rect_dfa_row.cuh`` (the source's note gives the bound and the
design). A DFA of at most ``BYTE_STATES`` states runs on the kernel's
byte-indexed instance, handed its table as ``next_table`` builds it (once a
DFA and device); a larger one on the class-indexed instance.

``rect_dfa(bytes_, lengths, validity, dfa)`` over a uint8[P, W] rectangle
(zero past each row's length), int32[P] lengths and bool[P] validity
gives bool[P]: the row matches, false for a NULL row (the caller keeps
the validity). On a CUDA tensor it launches the kernel (or raises); on a
CPU tensor it runs ``rect_dfa_reference``. Unlike ``rect_match`` it is not
gated by ``spark.rapids.tpu.sql.pallas.enabled``: there is no other route
on the card.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from ..columnar.strrect import kernel_rows
from ..exprs.regex_dfa import Dfa

__all__ = ["rect_dfa", "rect_dfa_reference", "describe", "shared_bytes",
           "next_table", "instance", "BYTE_STATES"]

#: the most states the byte-indexed instance takes (csrc/rect_dfa_row.cuh
#: kRdByteStates), and the bytes between two states' rows of its table in
#: shared memory (kRdNextStride)
BYTE_STATES = 168
NEXT_STRIDE = 280


def _check(bytes_, lengths, validity) -> None:
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


def _tables(dfa: Dfa, device) -> tuple:
    """The DFA's classes, table and accept flags on ``device``, copied
    once a device and kept on the automaton."""
    key = str(device)
    got = dfa.device_tables.get(key)
    if got is None:
        got = dfa.device_tables[key] = tuple(
            torch.from_numpy(a.reshape(-1).copy()).to(device)
            for a in (dfa.classes, dfa.table, dfa.accept))
    return got


def next_table(dfa: Dfa) -> np.ndarray:
    """The byte-indexed table: uint8[states, 256], ``next[s, b] =
    table[s, classes[b]]``."""
    return np.ascontiguousarray(dfa.table[:, dfa.classes])


def instance(dfa: Dfa) -> str:
    """The kernel's instance that walks ``dfa``: ``"byte"`` (one lookup a
    byte) up to ``BYTE_STATES`` states, else ``"class"`` (two)."""
    return "byte" if dfa.n_states <= BYTE_STATES else "class"


def _kernel_tables(dfa: Dfa, device, form: str) -> tuple:
    """(classes, table, accept, n_classes) as the kernel takes them:
    ``form`` "class" the DFA's own tables, "byte" the identity classes and
    ``next_table`` (256 classes), copied once a device beside
    ``_tables``."""
    if form == "class":
        return _tables(dfa, device) + (dfa.n_classes,)
    key = f"{device} next"
    got = dfa.device_tables.get(key)
    if got is None:
        got = dfa.device_tables[key] = (
            torch.arange(256, dtype=torch.uint8).to(device),
            torch.from_numpy(next_table(dfa).reshape(-1)).to(device),
            _tables(dfa, device)[2])
    return got + (256,)


def rect_dfa_reference(bytes_: torch.Tensor, lengths: torch.Tensor,
                       validity: torch.Tensor, dfa: Dfa) -> torch.Tensor:
    """Plain PyTorch version: one step over all rows for each of the W
    columns, a row's state kept past its length."""
    _check(bytes_, lengths, validity)
    classes, table, accept = (t.long() for t in _tables(dfa, bytes_.device))
    p, w = bytes_.shape
    n_cls = dfa.n_classes
    state = torch.full((p,), dfa.start, dtype=torch.int64,
                       device=bytes_.device)
    ln = lengths.to(torch.int64)
    for j in range(w):
        nxt = table[state * n_cls + classes[bytes_[:, j].long()]]
        state = torch.where(j < ln, nxt, state)
    return (accept[state] != 0) & validity


def shared_bytes(dfa: Dfa) -> int:
    """Shared memory of a block (csrc/rect_dfa.cu rd_smem)."""
    if instance(dfa) == "byte":
        return 512 + dfa.n_states * NEXT_STRIDE
    return 512 + dfa.n_states * dfa.n_classes


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_LIB: dict = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _launcher() -> dict:
    with _LOCK:
        if not _LIB:
            from .. import native
            lib = native.load("rect_dfa")
            fn = lib.rect_dfa_launch
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            lib.rect_dfa_grid.argtypes = [ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int]
            lib.rect_dfa_grid.restype = ctypes.c_int64
            lib.rect_dfa_describe.argtypes = [ctypes.c_void_p]
            lib.rect_dfa_describe.restype = ctypes.c_int
            _LIB.update(launch=fn, grid=lib.rect_dfa_grid,
                        describe=lib.rect_dfa_describe)
        return _LIB


def describe(dfa: Dfa = None, rows: int = 0) -> dict:
    """Registers a thread, threads a block and stack bytes of each
    instance (``instances``); with a DFA, the instance it runs on (and its
    registers at the top level), its states, classes, sinks,
    shared-memory bytes and the grid of a launch over ``rows`` rows."""
    out = (ctypes.c_int * 6)()
    lib = _launcher()
    rc = lib["describe"](ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"rect_dfa_describe failed: CUDA error {rc}")
    info = {"instances": {
        name: {"registers": out[3 * k], "threads": out[3 * k + 1],
               "stack_bytes": out[3 * k + 2]}
        for k, name in enumerate(("byte", "class"))}}
    if dfa is not None:
        which = instance(dfa)
        info.update(info["instances"][which], instance=which,
                    states=dfa.n_states, classes=dfa.n_classes,
                    sinks=dfa.n_states - dfa.first_sink,
                    shared_bytes=shared_bytes(dfa),
                    grid=int(lib["grid"](rows, dfa.n_states,
                                         dfa.n_classes)))
    return info


def launch(fn, bytes_: torch.Tensor, lengths: torch.Tensor,
           validity: torch.Tensor, dfa: Dfa,
           form: Optional[str] = None) -> torch.Tensor:
    """One launch of ``fn`` (a build's ``rect_dfa_launch``) over CUDA
    tensors, the DFA's tables in ``form`` ("byte" or "class"; by default
    the form of its instance): bool[P]. No launch count."""
    p, w = bytes_.shape
    if not (w == 8 or (w >= 16 and w % 16 == 0)):
        raise ValueError(f"rect_dfa takes rows of 8 bytes or a multiple of "
                         f"16, not {w}")
    dev = bytes_.device
    out = torch.empty(p, dtype=torch.bool, device=dev)
    if p == 0:
        return out
    bytes_ = kernel_rows(bytes_)
    lengths = lengths.contiguous()
    validity = validity.contiguous()
    classes, table, accept, n_cls = _kernel_tables(
        dfa, dev, form or instance(dfa))
    rc = fn(bytes_.data_ptr(), lengths.data_ptr(), validity.data_ptr(), p, w,
            classes.data_ptr(), table.data_ptr(), accept.data_ptr(),
            dfa.n_states, n_cls, dfa.start, dfa.first_sink, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rect_dfa kernel launch failed: CUDA error {rc}")
    return out


def rect_dfa(bytes_: torch.Tensor, lengths: torch.Tensor,
             validity: torch.Tensor, dfa: Dfa) -> torch.Tensor:
    """Whether each row matches the DFA (module doc): bool[P]. On a CUDA
    tensor one kernel launch (or an error); on a CPU tensor
    ``rect_dfa_reference``."""
    _check(bytes_, lengths, validity)
    dev = bytes_.device
    if dev.type == "cpu":
        return rect_dfa_reference(bytes_, lengths, validity, dfa)
    if dev.type != "cuda":
        raise ValueError(f"rect_dfa has no kernel for {dev}")
    out = launch(_launcher()["launch"], bytes_, lengths, validity, dfa)
    if bytes_.shape[0]:
        with _COUNT_LOCK:           # queries on several threads launch it
            rect_dfa.launches += 1
    return out


#: kernel launches since the count was last set to 0
rect_dfa.launches = 0
