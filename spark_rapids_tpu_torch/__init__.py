"""spark-rapids-tpu on PyTorch and CUDA.

A port of ``spark_rapids_tpu`` to torch tensors on an NVIDIA Hopper card:
the same DataFrame API, planning and columnar layout, with expressions as
eager torch ops and the reference's Pallas kernel rewritten by hand in
CUDA C++ (``csrc/``). It imports torch and numpy, never JAX, and nothing
of the JAX package.

    from spark_rapids_tpu_torch.api import TorchSession, functions as F
"""
from .config import TpuConf
from .types import Schema, StructField

__version__ = "0.1.0"
__all__ = ["TpuConf", "Schema", "StructField", "__version__"]
