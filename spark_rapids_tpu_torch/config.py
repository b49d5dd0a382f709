"""Typed configuration (port of ``spark_rapids_tpu/config.py``, the part
the slice reads).

Keys keep the reference's names (``spark.rapids.tpu.*``), so one conf
dict drives both packages; keys the port does not register are carried
and ignored.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["ConfEntry", "TpuConf", "register",
           "SQL_ENABLED", "BATCH_SIZE_ROWS", "BATCH_SIZE_BYTES"]

_LOCK = threading.Lock()
_REGISTRY: Dict[str, "ConfEntry"] = {}


class ConfEntry:
    def __init__(self, key: str, default: Any, doc: str,
                 conv: Callable[[str], Any]):
        self.key = key
        self.default = default
        self.doc = doc
        self.conv = conv

    def get(self, conf: "TpuConf") -> Any:
        raw = conf.raw.get(self.key)
        if raw is None:
            raw = os.environ.get(self.key.upper().replace(".", "_"))
        if raw is None:
            return self.default
        if isinstance(raw, str):
            return self.conv(raw)
        return raw


def _bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def register(key: str, default, doc: str) -> ConfEntry:
    if isinstance(default, bool):
        conv: Callable[[str], Any] = _bool
    elif isinstance(default, int):
        conv = int
    elif isinstance(default, float):
        conv = float
    else:
        conv = str
    with _LOCK:
        if key in _REGISTRY:
            raise ValueError(f"duplicate conf key {key}")
        e = _REGISTRY[key] = ConfEntry(key, default, doc, conv)
    return e


SQL_ENABLED = register(
    "spark.rapids.tpu.sql.enabled", True,
    "Plan queries onto the device. The port has no host engine yet, so "
    "planning raises when this is false.")

BATCH_SIZE_ROWS = register(
    "spark.rapids.tpu.sql.batchSizeRows", 1 << 20,
    "Maximum rows per columnar batch an in-memory scan produces.")

BATCH_SIZE_BYTES = register(
    "spark.rapids.tpu.sql.batchSizeBytes", 512 * 1024 * 1024,
    "Largest input, in device bytes, that the global sort takes in memory "
    "(the reference's batch-size goal); the out-of-core sort is not "
    "ported yet.")


class TpuConf:
    """Immutable snapshot of raw key -> value settings."""

    def __init__(self, raw: Optional[Dict[str, Any]] = None):
        self.raw = dict(raw or {})

    def get(self, entry: ConfEntry):
        return entry.get(self)

    @property
    def sql_enabled(self) -> bool:
        return bool(self.get(SQL_ENABLED))

    @property
    def batch_size_rows(self) -> int:
        return int(self.get(BATCH_SIZE_ROWS))
