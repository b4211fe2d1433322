"""ALP: Adaptive Lossless floating-Point compression (host analyze).

Carried over from knoxdb_tpu/encode/alp.py: find a decimal exponent e such
that every double in the pack round-trips exactly through
enc = round(v * 10^e), v = enc / 10^e. Packs that round-trip store
enc - min(enc) bitplane-packed, the same layout as integer BITPACK.
"""

from __future__ import annotations

import numpy as np

__all__ = ["try_alp", "MAX_EXP"]

MAX_EXP = 18
_MAX_ENC = float(1 << 51)      # keep |enc| well inside exact-double range


def try_alp(vals: np.ndarray) -> tuple[np.ndarray, int] | None:
    """f64[N] -> (enc int64[N], exponent) or None if no exponent
    round-trips every value exactly."""
    if not np.isfinite(vals).all():
        return None
    av = np.abs(vals)
    if av.size == 0:
        return np.zeros(0, np.int64), 0
    amax = av.max()
    for e in range(MAX_EXP + 1):
        scale = 10.0 ** e
        if amax * scale >= _MAX_ENC:
            return None
        enc = np.round(vals * scale)
        if (enc / scale == vals).all():
            return enc.astype(np.int64), e
    return None
