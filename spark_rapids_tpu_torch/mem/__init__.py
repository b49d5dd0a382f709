"""The memory runtime (port of ``spark_rapids_tpu/mem``): the device
budget and spill orchestration, spillable batches over device, host and
disk tiers, the OOM retry ladder and the device semaphore."""
from .manager import (MemoryManager, OutOfDeviceMemory, RetryOOM,
                      SplitAndRetryOOM)
from .retry import (CheckpointRestore, RetryStats, split_batch_in_half,
                    with_retry, with_retry_no_split, wrap_spillable_sides,
                    wrap_spillables)
from .semaphore import DeviceSemaphore, QueryTimeout
from .spillable import SpillableBatch, SpillPriorities

__all__ = ["MemoryManager", "OutOfDeviceMemory", "RetryOOM",
           "SplitAndRetryOOM", "RetryStats", "split_batch_in_half",
           "with_retry", "with_retry_no_split", "wrap_spillables",
           "wrap_spillable_sides",
           "CheckpointRestore", "DeviceSemaphore", "QueryTimeout",
           "SpillableBatch", "SpillPriorities"]
