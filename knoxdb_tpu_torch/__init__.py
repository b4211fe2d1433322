"""knoxdb_tpu_torch — the PyTorch and CUDA port of knoxdb_tpu.

The same columnar engine on an NVIDIA GPU: bit-sliced compressed packs
built on the host, uploaded to a torch device, and scanned by fused
filter + aggregate kernels written in CUDA C++ (csrc/). The package
imports torch and never jax; its tests hold it against knoxdb_tpu bit
for bit on the CPU, where each kernel runs as its plain PyTorch version.
"""

from .types import FieldType, FilterMode, FilterType, IndexType

__all__ = ["FieldType", "FilterMode", "FilterType", "IndexType"]
