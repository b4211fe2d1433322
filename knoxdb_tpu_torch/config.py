"""Pack geometry for the PyTorch port (knoxdb_tpu/config.py without jax).

There are no kernel switches: on a CUDA tensor the scan kernels always
run, and on a CPU tensor their plain PyTorch versions do.
"""

from __future__ import annotations

import os

# Rows per pack. A power of two; the bitsets hold 32 rows per word.
PACK_SIZE = int(os.environ.get("KNOX_TPU_PACK_SIZE", 1 << 16))
assert PACK_SIZE % 4096 == 0, "PACK_SIZE must be a multiple of 4096"

# Words per pack for packed u32 bitsets.
PACK_WORDS = PACK_SIZE // 32

# Statistics: max string prefix bytes kept in zone maps.
STATS_STRING_MAX_LEN = 8
