"""Per-block byte-chunk group partials: the chunk form of the group kernel.

The port of the group probes' kernels, probes/pg3_variants.py (`k_v1`,
`k_v2`, `k_v3`, `make_call(S, vec)`: H = 128, L = 8, C = 4) and
probes/pg_bigG.py (`k_loop`, `k_vec`, `k_chunk`: H = 256, L = 32, C = 6,
8 passes to G = 65,536). They are one function at different geometries,
tile heights S, output types and column layouts; `group_chunk_partials`
takes those as parameters, launches the hand-written CUDA kernel of
csrc/group_chunk_kernels.cu on a CUDA tensor (or raises) and runs the plain
PyTorch version on a CPU tensor. `LAUNCHES` counts kernel launches and
`PLAIN_CALLS` plain-version runs taken by the wrapper.

Contract (that of knoxdb_tpu/ops/pallas_group.fused_group_partials): rows
are cut into blocks of S * 1024; with h = gid >> shift, l = gid & (L - 1),
NC = n_chunks + 1 and byte c of the value taken from vlo (c < 4) or vhi,

    out[b, h, l * NC + c] = Σ byte_c   over rows of block b with that (h, l)
    out[b, h, l * NC + C] = their count

and in the band layout column c * L + l instead. A row whose h is outside
[0, H) adds nothing: a sentinel gid, or a gid below the pass of a
multi-pass caller (negative after gid - p * H * L). Every entry is at most
255 * S * 1024 < 2^24 for S <= 64, so float32 holds it exactly, as int32
does. The caller adds the blocks (exec/groupby.group_count_chunks).

Inputs: gid int32[n]; vlo, vhi int32-carried u32[n] (ops/words.py).
"""

from __future__ import annotations

import torch

__all__ = ["group_chunk_partials", "group_chunk_partials_torch",
           "unband", "LAUNCHES", "PLAIN_CALLS", "reset_counts", "ROWS",
           "MAX_CELLS"]

ROWS = 1024                     # rows per unit of S
MAX_CELLS = 232448 // 4         # int32 histogram cells a block can hold

LAUNCHES = {"group_chunk_partials": 0}
PLAIN_CALLS = {"group_chunk_partials": 0}


def reset_counts() -> None:
    LAUNCHES["group_chunk_partials"] = 0
    PLAIN_CALLS["group_chunk_partials"] = 0


def unband(parts: torch.Tensor, L: int) -> torch.Tensor:
    """Band-layout partials [B, H, NC * L] -> the interleaved layout
    [B, H, L * NC]."""
    B, H, cols = parts.shape
    return parts.view(B, H, cols // L, L).transpose(2, 3).reshape(B, H, cols)


def group_chunk_partials_torch(gid, vlo, vhi, H: int, L: int, shift: int,
                               n_chunks: int, S: int = 8,
                               out_dtype=torch.float32, band: bool = False):
    """Plain PyTorch version of group_chunk_partials: one index_add_ per
    column into the [B * H * L, NC] table."""
    C = n_chunks
    NC = C + 1
    n = gid.numel()
    T = S * ROWS
    B = -(-n // T)
    dev = gid.device
    g = gid.to(torch.int64)
    h = g >> shift
    ok = (h >= 0) & (h < H)
    blk = torch.arange(n, dtype=torch.int64, device=dev) // T
    cell = ((blk * H + h) * L + (g & (L - 1)))[ok]
    acc = torch.zeros((B * H * L, NC), dtype=torch.int64, device=dev)
    for c in range(C):
        w = vlo if c < 4 else vhi
        byte = (w >> (8 * (c % 4))) & 0xFF
        acc[:, c].index_add_(0, cell, byte[ok].to(torch.int64))
    acc[:, C].index_add_(0, cell, torch.ones_like(cell))
    acc = acc.view(B, H, L, NC)
    if band:
        acc = acc.transpose(2, 3)
    return acc.reshape(B, H, L * NC).to(out_dtype)


def group_chunk_partials(gid, vlo, vhi, H: int, L: int, shift: int,
                         n_chunks: int, S: int = 8, out_dtype=torch.float32,
                         band: bool = False, out=None):
    """Per-block byte-chunk partials [ceil(n / (S * 1024)), H, L * NC] of
    out_dtype float32 or int32 (see the module docstring). `out`, if given,
    is a contiguous tensor of that shape and type to write into (a
    multi-pass caller reuses one buffer)."""
    name = "group_chunk_partials"
    C = n_chunks
    if not 0 <= C <= 8:
        raise ValueError(f"{name}: n_chunks = {C}")
    if H <= 0 or L <= 0 or L & (L - 1) or not 0 <= shift <= 30:
        raise ValueError(f"{name}: H = {H}, L = {L}, shift = {shift}")
    if S % 8 or not 0 < S <= 64:
        raise ValueError(f"{name}: S = {S} must be a multiple of 8 in "
                         f"(0, 64]: the float32 partials are exact below "
                         f"2^24")
    if out_dtype not in (torch.float32, torch.int32):
        raise ValueError(f"{name}: out_dtype {out_dtype}")
    if H * L * (C + 1) > MAX_CELLS:
        raise ValueError(f"{name}: a histogram of {H} x {L * (C + 1)} cells "
                         f"exceeds a block's {MAX_CELLS}")
    if not isinstance(gid, torch.Tensor) or gid.dim() != 1:
        raise ValueError(f"{name}: gid must be a 1-d tensor")
    n = gid.numel()
    if not 0 < n < 1 << 31:
        raise ValueError(f"{name}: {n} rows")
    dev = gid.device
    for t, nm in ((gid, "gid"), (vlo, "vlo"), (vhi, "vhi")):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name}: {nm} must be an int32 tensor, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if tuple(t.shape) != (n,) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous [{n}] on "
                             f"{dev}")
    shape = (-(-n // (S * ROWS)), H, L * (C + 1))
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != out_dtype or out.device != dev
                            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be contiguous {shape} of "
                         f"{out_dtype} on {dev}")
    if dev.type == "cpu":
        PLAIN_CALLS[name] += 1
        res = group_chunk_partials_torch(gid, vlo, vhi, H, L, shift, C, S,
                                         out_dtype, band)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    from .cuda_build import load
    lib = load()
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knox_group_chunk_partials(
            gid.data_ptr(), vlo.data_ptr(), vhi.data_ptr(), out.data_ptr(),
            n, S * ROWS, H, L, shift, C, int(out_dtype == torch.float32),
            int(band), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES[name] += 1
    return out
