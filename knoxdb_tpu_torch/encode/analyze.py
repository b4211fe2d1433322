"""One-pass column vector analysis feeding compression scheme selection.

Carried over from knoxdb_tpu/encode/analyze.py. The port keeps the numpy
form of the one-pass statistics (min/max, runs, delta and pack widths);
it gives the same numbers as the reference's native helper.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Context", "analyze_keys", "analyze_u64"]


@dataclass
class Context:
    """Analysis result over one pack (key domain)."""
    n: int
    min_key: int
    max_key: int
    num_runs: int
    card: int                 # exact cardinality (unique count)
    delta_width: int          # bits needed for zigzag(first-difference), 64 if n/a
    pack_width: int           # bits needed for (v - min)
    unique: np.ndarray | None = None   # sorted unique keys (u64) when computed
    codes: np.ndarray | None = None    # dict codes aligned with input
    run_ends: np.ndarray | None = None
    run_values: np.ndarray | None = None
    sorted: bool = False


def analyze_u64(keys: np.ndarray):
    """(min, max, num_runs, delta_width, pack_width, sorted) of u64 keys."""
    mn, mx = int(keys.min()), int(keys.max())
    runs = 1 + int((keys[1:] != keys[:-1]).sum())
    if len(keys) > 1:
        with np.errstate(over="ignore"):
            d = (keys[1:] - keys[:-1]).view(np.int64)
            zz = ((d << 1) ^ (d >> 63)).view(np.uint64)
        dw = int(zz.max()).bit_length()
        sorted_ = bool((d >= 0).all())
    else:
        dw, sorted_ = 0, True
    return mn, mx, runs, dw, (mx - mn).bit_length(), sorted_


def analyze_keys(keys: np.ndarray, want_dict: bool = True) -> Context:
    """keys: u64[N] key-domain values.

    Run/unique arrays are only materialized when the quick stats say
    RLE/DICT could win."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, np.uint64)
    mn, mx, num_runs, delta_width, pack_width, is_sorted = \
        analyze_u64(keys)

    run_ends = run_values = None
    if num_runs < n // 4:
        change = np.flatnonzero(keys[1:] != keys[:-1])
        run_ends = np.concatenate([change + 1, [n]]).astype(np.uint32)
        run_values = keys[np.concatenate([[0], change + 1])]

    unique = codes = None
    card = min(num_runs, n)
    if mn == mx:
        card = 1
    elif want_dict and n:
        # sampled cardinality probe (reference selector samples too,
        # internal/encode/int.go) — full unique only when dict plausible
        samp = keys[::max(1, n // 1024)]
        scard = len(np.unique(samp))
        if scard <= max(16, len(samp) // 4):
            unique, codes = np.unique(keys, return_inverse=True)
            card = len(unique)
            codes = codes.astype(np.uint32)

    return Context(
        n=n, min_key=mn, max_key=mx, num_runs=num_runs, card=card,
        delta_width=delta_width, pack_width=pack_width,
        unique=unique, codes=codes,
        run_ends=run_ends, run_values=run_values, sorted=is_sorted,
    )
