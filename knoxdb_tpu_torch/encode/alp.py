"""ALP: Adaptive Lossless floating-Point compression (host analyze).

Carried over from knoxdb_tpu/encode/alp.py: find a decimal exponent e such
that every double in the pack round-trips exactly through
enc = round(v * 10^e), v = enc / 10^e. Packs that round-trip store
enc - min(enc) bitplane-packed, the same layout as integer BITPACK.
Predicates are rewritten on the host into the enc domain (`enc_bounds`),
and integer aggregation makes float sums exact rationals: only the final
division rounds.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

__all__ = ["try_alp", "MAX_EXP", "frac_bounds", "enc_bounds"]

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


def frac_bounds(c: float, e: int) -> tuple[int, int, bool]:
    """Exact RATIONAL thresholds (floor, ceil, is_integer) of c * 10^e, c
    taken as its exact binary value. Predicate rewriting uses enc_bounds
    instead: the stored values are the DOUBLES double(enc / 10^e), so
    boundary decisions belong in the double domain, not the rational one."""
    t = Fraction(c) * (10 ** e)
    fl = t.numerator // t.denominator
    ce = -((-t.numerator) // t.denominator)
    return int(fl), int(ce), fl == ce


_HUGE = 1 << 62


def enc_bounds(c: float, e: int) -> tuple[int, int, int | None]:
    """Double-domain enc thresholds for constant c at exponent e.

    Returns (le, ge, eq): enc <= le iff decode(enc) <= c; enc >= ge iff
    decode(enc) >= c; eq = the enc with decode == c, or None.
    decode(enc) = double(enc / 10^e) is strictly monotone over the legal
    |enc| < 2^51 domain, so one probe near round(c * 10^e) decides."""
    s = 10.0 ** e
    t = c * s
    if not math.isfinite(t):
        if t > 0 or c > 0:
            return _HUGE, _HUGE, None       # above every enc
        return -_HUGE, -_HUGE, None         # below every enc
    ce = int(round(t))
    d = ce / s
    le = ce if d <= c else ce - 1
    ge = ce if d >= c else ce + 1
    eq = ce if d == c else None
    return le, ge, eq
