"""Typed configuration (port of ``spark_rapids_tpu/config.py``, the part
the slice reads).

Keys keep the reference's names (``spark.rapids.tpu.*``), so one conf
dict drives both packages; keys the port does not register are carried
and ignored.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional

__all__ = ["ConfEntry", "TpuConf", "register",
           "SQL_ENABLED", "BATCH_SIZE_ROWS", "BATCH_SIZE_BYTES",
           "CONCURRENT_TPU_TASKS", "ALLOC_FRACTION", "HBM_LIMIT_BYTES",
           "HOST_SPILL_LIMIT", "SPILL_DIR", "OOM_MAX_SPLIT_DEPTH",
           "LEAK_DETECTION", "TASK_TIMEOUT", "SEMAPHORE_WEDGE_TIMEOUT_MS",
           "QUERY_TIMEOUT", "MULTITHREADED_READ_THREADS",
           "IO_PATH_REPLACEMENT", "PARQUET_READER_TYPE",
           "AUTO_BROADCAST_THRESHOLD", "JOIN_SUBPARTITION_SIZE"]

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
    "(the reference's batch-size goal); a larger input takes the "
    "out-of-core sample sort.")


AGG_WIDE_BATCH_ROWS = register(
    "spark.rapids.tpu.sql.agg.wideBatchRows", 0,
    "Batch-width ceiling for in-memory scans feeding a keyless "
    "aggregation, which has no group count to keep small and pays per "
    "batch: the scan feeds the widest batches it can. 0 = auto: up to the "
    "whole partition while one batch's estimated bytes fit half the "
    "memory manager's budget; a row count pins the ceiling instead.")

CONCURRENT_TPU_TASKS = register(
    "spark.rapids.tpu.sql.concurrentTpuTasks", 2,
    "Number of tasks that may hold the device semaphore concurrently "
    "(ref RapidsConf.scala:545 concurrentGpuTasks / GpuSemaphore.scala:137).")

ALLOC_FRACTION = register(
    "spark.rapids.tpu.memory.hbm.allocFraction", 0.85,
    "Fraction of device memory the pool manager budgets for columnar "
    "buffers (ref RapidsConf spark.rapids.memory.gpu.allocFraction).")

HBM_LIMIT_BYTES = register(
    "spark.rapids.tpu.memory.hbm.limitBytes", 0,
    "Explicit device-memory budget in bytes; 0 = derive from device "
    "(ref GpuDeviceManager.computeRmmPoolSize).")

HOST_SPILL_LIMIT = register(
    "spark.rapids.tpu.memory.host.spillStorageSize", 4 * 1024 * 1024 * 1024,
    "Bytes of host memory for spilled buffers before going to disk "
    "(ref RapidsHostMemoryStore.scala:41).")

OOM_MAX_SPLIT_DEPTH = register(
    "spark.rapids.tpu.oom.maxSplitDepth", 8,
    "How many times a single input batch may be halved by the "
    "SplitAndRetryOOM rung of the retry state machine before the "
    "escalation ladder moves on (cross-session pressure spill, then "
    "OutOfDeviceMemory; mem/retry.py). Depth 8 means pieces as small as "
    "1/256th of the original batch.")

LEAK_DETECTION = register(
    "spark.rapids.tpu.memory.leakDetection", False,
    "Debug-mode allocation auditing: every SpillableBatch records its "
    "creation site, and TorchSession.close() raises if any device buffer "
    "registration is still live (ref cudf MemoryCleaner leak tracking at "
    "shutdown, Plugin.scala:573-588).")

SPILL_DIR = register(
    "spark.rapids.tpu.memory.spillDir",
    str(Path(__file__).resolve().parent.parent / "build" / "spill"),
    "Directory for disk-tier spill files (ref RapidsDiskStore.scala:38).")

TASK_TIMEOUT = register(
    "spark.rapids.tpu.task.semaphore.timeoutSeconds", 600,
    "Max seconds a task waits on the device semaphore before erroring.")

SEMAPHORE_WEDGE_TIMEOUT_MS = register(
    "spark.rapids.tpu.semaphore.wedgeTimeoutMs", 10000,
    "Wedge-watchdog horizon for the device semaphore: a task blocked in "
    "acquire() for this long wakes up, dumps a holder/waiter/held-bytes "
    "diagnostic, and force-releases permits whose holder THREAD is dead "
    "(a killed worker can no longer wedge every later query). <= 0 "
    "disables the watchdog: waits block until "
    "task.semaphore.timeoutSeconds.")

QUERY_TIMEOUT = register(
    "spark.rapids.tpu.query.timeout", 0.0,
    "Whole-query deadline in seconds, enforced by cooperative "
    "cancellation: every operator checks the deadline at each produced "
    "batch (and semaphore waits poll it), so a timed-out query unwinds "
    "through the normal exception path: the device semaphore is "
    "released and every spillable batch is closed (the zero-leak audit "
    "holds). Raises QueryTimeout. 0 disables.")


MULTITHREADED_READ_THREADS = register(
    "spark.rapids.tpu.sql.multiThreadedRead.numThreads", 8,
    "Host read thread-pool size for cloud/coalescing file readers "
    "(ref Plugin.scala:269-281).")

IO_PATH_REPLACEMENT = register(
    "spark.rapids.tpu.io.pathReplacementRules", "",
    "Semicolon-separated 'prefix->replacement' rules applied to scan paths "
    "before opening (ref AlluxioUtils.scala s3://->alluxio:// rewriting); "
    "e.g. 's3://bucket->/mnt/alluxio/bucket'.")

PARQUET_READER_TYPE = register(
    "spark.rapids.tpu.sql.format.parquet.reader.type", "AUTO",
    "PERFILE / COALESCING / MULTITHREADED / AUTO "
    "(ref GpuParquetScan.scala reader factory:1070).")

AUTO_BROADCAST_THRESHOLD = register(
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Equi-joins broadcast a side whose plan-time size estimate is at or "
    "below this many bytes (ref Spark's autoBroadcastJoinThreshold). <= 0 "
    "disables the choice; a broadcast hint still applies.")

JOIN_SUBPARTITION_SIZE = register(
    "spark.rapids.tpu.sql.join.subPartitionSizeBytes", 256 * 1024 * 1024,
    "When the combined input of a coalesced equi-join exceeds this many "
    "device bytes, the join hash-partitions both sides and runs N "
    "independent sub-joins (ref GpuSubPartitionHashJoin.scala). <= 0 "
    "disables sub-partitioning.")


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

    @property
    def concurrent_tpu_tasks(self) -> int:
        return int(self.get(CONCURRENT_TPU_TASKS))
