"""knoxdb_tpu_torch — the PyTorch and CUDA port of knoxdb_tpu.

The same columnar engine on an NVIDIA GPU: bit-sliced compressed packs
built on the host, uploaded to a torch device, scanned by fused filter +
aggregate kernels and grouped by exact per-group count/sum kernels, all
written in CUDA C++ (csrc/). The package imports torch and never jax;
its tests hold it against knoxdb_tpu bit for bit on the CPU, where each
kernel runs as its plain PyTorch version.

    import knoxdb_tpu_torch as kx
    db = kx.create_database("demo", device="cuda")
"""

from .types import (FieldType, FilterMode, FilterType, IndexType, JoinType,
                    OrderType)

__all__ = [
    "FieldType", "FilterMode", "FilterType", "IndexType", "OrderType",
    "JoinType", "knox", "create_database", "open_database",
]


def __getattr__(name):
    # lazy SDK surface: knoxdb_tpu_torch.create_database(...) without
    # importing the engine stack at package import time. importlib, NOT
    # `from . import knox`: the fromlist path re-enters this __getattr__
    # while the submodule import is in flight -> infinite recursion on
    # `from knoxdb_tpu_torch import knox`
    if name in ("knox", "create_database", "open_database"):
        import importlib
        mod = importlib.import_module(".knox", __name__)
        return mod if name == "knox" else getattr(mod, name)
    raise AttributeError(name)
