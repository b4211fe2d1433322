"""LogLogBeta cardinality estimation (carried over from
knoxdb_tpu/filter/llb.py, register for register the same).

Register-max sketches over the two 32-bit hashes of ops/hash.hash2_np
with the beta bias-correction formula (upstream internal/filter/llb).
Used by the count-distinct aggregate. Sketches build on the host with
numpy and merge by elementwise max (across packs, segments or hosts).
"""

from __future__ import annotations

import numpy as np

from ..ops import hash as H

__all__ = ["LLB", "count_distinct_exact"]

# beta(p=14) polynomial coefficients (Qin et al., LogLog-Beta)
_BETA14 = np.array([
    -0.370393911, 0.070471823, 0.17393686, 0.16339839,
    -0.09237745, 0.03738027, -0.005384159, 0.00042419,
])


class LLB:
    """LogLog-Beta sketch, p=14 (16384 registers, ~0.8% rel error)."""

    P = 14
    M = 1 << 14

    def __init__(self, registers: np.ndarray | None = None):
        self.reg = registers if registers is not None \
            else np.zeros(self.M, np.uint8)

    def add_limbs(self, limbs: np.ndarray) -> None:
        """Add keyform values u32[L, N]."""
        h1, h2 = H.hash2_np(limbs)
        h = (h1.astype(np.uint64) << np.uint64(32)) | h2
        idx = (h >> np.uint64(64 - self.P)).astype(np.int64)
        rest = (h << np.uint64(self.P)) | np.uint64(1 << (self.P - 1))
        # rank = leading zeros of the remaining bits + 1
        lz = np.zeros(len(h), np.uint8)
        cur = rest
        for shift in (32, 16, 8, 4, 2, 1):
            mask = cur < (np.uint64(1) << np.uint64(64 - shift))
            lz = np.where(mask, lz + shift, lz)
            cur = np.where(mask, cur << np.uint64(shift), cur)
        rank = (lz + 1).astype(np.uint8)
        np.maximum.at(self.reg, idx, rank)

    def add_keys64(self, keys: np.ndarray) -> None:
        limbs = np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                          keys.astype(np.uint32)])
        self.add_limbs(limbs)

    def merge(self, other: "LLB") -> "LLB":
        return LLB(np.maximum(self.reg, other.reg))

    def cardinality(self) -> float:
        m = float(self.M)
        ez = float((self.reg == 0).sum())
        zl = np.log(ez + 1.0)
        beta = ez * _BETA14[0]
        for i, c in enumerate(_BETA14[1:], start=1):
            beta += c * zl ** i
        s = float(np.sum(0.5 ** self.reg.astype(np.float64)))
        alpha = 0.7213 / (1.0 + 1.079 / m)
        return alpha * m * (m - ez) / (beta + s)


def count_distinct_exact(keys: np.ndarray) -> int:
    return len(np.unique(keys))
