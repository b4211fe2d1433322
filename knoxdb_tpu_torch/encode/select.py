"""Cost-model compression scheme selection (carried over from
knoxdb_tpu/encode/select.py).

Analyze the vector once, estimate the encoded size per legal scheme and
pick the cheapest, with a small preference bias toward schemes whose
matchers are cheapest (CONST > BITPACK > DICT > RLE > DELTA > RAW).
Widths are rounded up to a small allowed set so that packs share shapes.
"""

from __future__ import annotations

import numpy as np

from .analyze import Context, analyze_keys
from . import schemes as S
from .schemes import EncodedPack, Scheme

__all__ = ["ALLOWED_WIDTHS", "round_width", "select_scheme", "encode_pack",
           "estimate_sizes"]

# Shared bit widths: dense at the small end (where most real columns live),
# sparse above. Keeps the compile-cache hot across tables.
ALLOWED_WIDTHS = (0, 1, 2, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64)


def round_width(w: int) -> int:
    for a in ALLOWED_WIDTHS:
        if w <= a:
            return a
    return 64


# Matcher-cost preference multipliers (smaller = preferred at equal size).
_PREF = {
    Scheme.CONST: 0.5,
    Scheme.BITPACK: 1.0,
    Scheme.DICT: 1.15,
    Scheme.RLE: 1.3,
    Scheme.DELTA: 1.5,   # compare requires cumsum decode
    Scheme.RAW: 1.6,
}

# Run-end/dict entries cost (value limbs + end word), bytes per entry.
def _entry_bytes(nlimbs: int) -> int:
    return nlimbs * 4 + 4


def estimate_sizes(ctx: Context, nlimbs: int) -> dict[Scheme, int]:
    """Estimated encoded bytes per candidate scheme."""
    n = ctx.n
    out: dict[Scheme, int] = {Scheme.RAW: n * nlimbs * 4}
    if ctx.card == 1:
        out[Scheme.CONST] = nlimbs * 4
        return out
    pw = round_width(ctx.pack_width)
    out[Scheme.BITPACK] = n * pw // 8 + 8
    if ctx.delta_width and ctx.delta_width < 64:
        dw = round_width(ctx.delta_width)
        out[Scheme.DELTA] = n * dw // 8 + 8
    if ctx.run_ends is not None and ctx.num_runs < n // 4:
        out[Scheme.RLE] = ctx.num_runs * _entry_bytes(nlimbs)
    if ctx.unique is not None and 2 <= ctx.card < n // 4:
        cw = round_width(max(1, (ctx.card - 1).bit_length()))
        out[Scheme.DICT] = n * cw // 8 + ctx.card * nlimbs * 4
    return out


def select_scheme(ctx: Context, nlimbs: int) -> Scheme:
    sizes = estimate_sizes(ctx, nlimbs)
    return min(sizes, key=lambda s: sizes[s] * _PREF[s])


def encode_pack(keys: np.ndarray, nlimbs: int, n_pad: int,
                scheme: Scheme | None = None,
                ctx: Context | None = None) -> EncodedPack:
    """Encode one pack of u64 keyform keys (types up to 64 bits).

    n_pad: padded row capacity (the segment pack size)."""
    ctx = ctx or analyze_keys(keys)
    scheme = scheme or select_scheme(ctx, nlimbs)

    if scheme == Scheme.CONST:
        limbs = S._key_to_limbs(keys[:1], nlimbs)
        return S.encode_const(limbs, ctx.n)
    if scheme == Scheme.BITPACK:
        w = round_width(ctx.pack_width)
        return S.encode_bitpack(keys, nlimbs, ctx.min_key, w, n_pad)
    if scheme == Scheme.DELTA:
        w = round_width(ctx.delta_width)
        return S.encode_delta(keys, nlimbs, w, n_pad)
    if scheme == Scheme.RLE:
        rv = S._key_to_limbs(ctx.run_values, nlimbs)
        return S.encode_rle(rv, ctx.run_ends, ctx.n, nlimbs)
    if scheme == Scheme.DICT:
        uv = S._key_to_limbs(ctx.unique, nlimbs)
        cw = round_width(max(1, (ctx.card - 1).bit_length()))
        return S.encode_dict(ctx.codes, uv, ctx.n, nlimbs, n_pad, width=cw,
                             dict_keys=ctx.unique)
    limbs = S._key_to_limbs(keys, nlimbs)
    return S.encode_raw(limbs, ctx.n, n_pad)
