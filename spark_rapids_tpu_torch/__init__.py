"""spark_rapids_tpu_torch: the PyTorch/CUDA port of spark_rapids_tpu.

A columnar SQL engine whose operators run as PyTorch calls and
hand-written CUDA kernels (ops/kernels.py, csrc/) on an NVIDIA card.  It
imports torch and nothing of JAX or of the JAX package.  See README.md
("The PyTorch/CUDA port") for what the slice covers.
"""
from .engine import DataFrame, GroupedData, TpuSession
from .plan.logical import SortOrder, Window, col, functions, lit

__all__ = ["DataFrame", "GroupedData", "SortOrder", "TpuSession", "Window",
           "col", "functions", "lit"]
