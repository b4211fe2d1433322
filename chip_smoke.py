#!/usr/bin/env python3
"""Smoke run of knoxdb_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits nonzero:
  1. card: nvidia-smi's name and power limit, torch's device name;
  2. build: the CUDA kernels of knoxdb_tpu_torch/csrc from source (nvcc,
     sm_90a), with the seconds it took and ptxas' register report;
  3. kernel = plain: each kernel against its plain PyTorch version on the
     card, bit for bit. Scan kernels: random planes at widths 0-64, P = 64,
     W = 2048, 1-3 leaves, sum and min/max specs and an empty pack. Group
     kernels: 4,194,304 rows at G = 1, 200, 1000, 8192 and 65,536, with
     invalid gids, 70% masks and all-ones values; the moments kernel with
     the squares of values up to 2^32 - 1. The tile sort (kernel #8):
     4 tiles of keys in [0, 8) and 32 tiles of full-range u32 keys, ntpose
     0 and 8. The split scan kernels (range_mask_count,
     masked_plane_popcounts): widths 0, 1, 16, 33 and 64 at 37 packs, every
     combination of the five flag words, random, empty, full and absent
     incoming masks, and the one-leaf kernel and both split kernels on the
     permuted view of a pack-major tensor against the plane-major result.
     The chunk kernel (group_chunk_partials, kernels #6 and #7): both probe
     geometries (H = 128, L = 8 and H = 256, L = 32 with its 224 KiB of
     shared memory), float32 and int32 outputs, interleaved and band
     layouts, S = 8, 16 and 32, a ragged last block, negative and sentinel
     gids;
  4. main paths, each run with every launch counter set to 0 just before
     it and read just after, each exactly equal to a numpy oracle:
     - scan: the benchmark segment (256 packs x 65,536 rows, seed 0xBEEF,
       the schema and data of bench.py) scanned with BASELINE config #1,
       the two-leaf check and the entry() query;
     - materialization on the same segment: scan(project=val, bal) and
       scan_stream of a ~1% filter, every row id and value;
     - group-by, BASELINE config #3 (bench_suite.py:171-198, seed
       0xC0FFEE, G = 1000, the 99%-pass `bal GT` filter) at 256 x 65,536
       rows, group_scan with minmax False and True: every group's count,
       sum, min and max;
     - group-by config #3c: G = 65,536 at 64 packs, minmax False;
     - series, config #6 (bench_suite.py:438-455, 1024 buckets of 64):
       series_scan moments at 64 packs, counts, sums and sums of squares;
     - the chunk route: group_count_chunks on the operands group_scan hands
       its group kernel at config #3 (1 launch) and #3c (8 launches): the
       same counts and python-int sums as group_scan and numpy;
     - floats, config #6's schema and bucket plan at 64 packs plus two
       FLOAT64 columns (price: four decimals, ALP packs; lat: full
       precision, keyform packs; probes/compression_matrix.py:97-103):
       series_scan with moments, firstlast and fminmax on both and tsruns
       and firstlast on val; scan(price RANGE, count, sum, min, max);
       scan(project=price) at 1%; exact outputs equal to numpy, float
       moments within 64 eps * Σ|v| per bucket;
     - config #2 (bench_suite.py:55-95, seed 0xC0FFEE, 256 x 65,536 rows:
       id pk, val u64, acct bytes of 64 values, bal i64, and one more
       column fee u64 that is zero in every fourth pack): the source's
       three-leaf AND (it fuses whole); an OR subtree (the ladder kernel
       twice); fee RANGE with sum(fee), sum(id), min(id), max(id) (the
       ladder and popcount kernels on the BITPACK group, the CONST
       branches, the DELTA sum and min/max); id RANGE (the DELTA matcher);
       scan(project=id, val);
     - top-k, config #4 (bench_suite.py:243-300, 256 packs: big INT128 in
       wide BITPACK packs, val u64, the DELTA pk): segment_topk of the 100
       largest big and val under val LT 50000 (the bit descent) and of id
       (the stable-sort fallback), keys and ids against numpy;
     - joins, config #5 (bench_suite.py:303-418) at nl = nr = 4,194,304:
       join_pairs_device INNER and LEFT, unique_build with keys32, a build
       key run wider than SHIFT_S (the ladder's fallback), join_pairs_core
       with a cap retry and join_count_device, each an exact pair multiset;
     - the sort probe: kernel #8 on the join's merged (key, tagged id)
       operands at M = 8,388,608;
     - tx join accounts from two segments of 4,194,304 rows, composed as
       engine/table.py's join_side and rows_at_positions do, with no
       filter and with amount > 0: every pair's amount and bal;
  5. timing (CUDA events, medians over alternating query variants, with
     the host's launch overhead hidden behind a GPU sleep): each kernel
     and its plain version at the main paths' shapes (scan kernels also
     with L2 flushed before each launch); the host wall time of whole
     scan(), group_scan() and series_scan() calls; rows/s; the kernel's
     bytes/s as a share of a same-run torch read pass over 256 MiB; and
     for group_scan and series_scan the device time of each stage (mask,
     group ids, decode, kernel), the host combine, and torch.profiler's
     device idle share and top kernels; kernel #8, its plain version and
     torch.sort on the join's operands with the probe's projection
     (msort_probe.py:221-236) from the card's own costs; each join
     core's wall and its device time in sorts, in the D2H copy and in the
     rest; scan(project=) and the tx join's wall; the split kernels on
     config #1's val planes beside the one-leaf kernel, warm and L2-flushed
     and at the pack-major view; wall and device idle share of every
     config #2 and config #4 call; top-k's stages (add_const_planes,
     topk_select, the gathers with the projection) and kernel launches per
     call; the DELTA decode's transpose and prefix sum; the chunk kernel at
     config #3's and #3c's operands beside its plain version, one
     index_add_ and kernel #3 on the same rows, and the wall, device time
     and idle share of the chunk route and of every float call. Every kernel's
     record carries its bound (bytes over the published HBM rate against
     word operations over the published float32 rate; kernel #8 also its
     shared-memory traffic) and, where one PyTorch call computes the same
     function, that call's time.

The last three lines are the kernels' JSON record, the card, and
{"ok": true, "device": {...}}. Needs a CUDA device and the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_PACKS = 256
PACK_SIZE = 1 << 16
SEED = 0xBEEF
ITERS = 60          # timed iterations per measurement (after warm-up)
_SOURCES = {"fused_range_sum_masked": "knoxdb_tpu_torch/csrc/scan_kernels.cu",
            "fused_tree_agg": "knoxdb_tpu_torch/csrc/scan_kernels.cu",
            "range_mask_count": "knoxdb_tpu_torch/csrc/scan_kernels.cu",
            "masked_plane_popcounts": "knoxdb_tpu_torch/csrc/scan_kernels.cu",
            "fused_group_partials": "knoxdb_tpu_torch/csrc/group_kernels.cu",
            "fused_group_moments_partials":
                "knoxdb_tpu_torch/csrc/group_kernels.cu",
            "group_chunk_partials":
                "knoxdb_tpu_torch/csrc/group_chunk_kernels.cu"}
_REPLACES = {"fused_range_sum_masked": "knoxdb_tpu/ops/pallas_scan.py:126",
             "fused_tree_agg": "knoxdb_tpu/ops/pallas_scan.py:259",
             "range_mask_count": "probes/ps_variants.py:85",
             "masked_plane_popcounts": "probes/ps_variants.py:94",
             "fused_group_partials": "knoxdb_tpu/ops/pallas_group.py:95",
             "fused_group_moments_partials":
                 "knoxdb_tpu/ops/pallas_group.py:116"}
GROUP_SEED = 0xC0FFEE
G3 = 1000
THR3 = -((1 << 40) * 49) // 50      # config #3's 99%-pass filter
PACKS_SMALL = 64                    # bench_suite.py's default --packs
G6, T6, IV6 = 1024, 1_000_000, 64
# The card's published peaks (NVIDIA's H100 SXM data sheet): HBM3, and
# for 32-bit integer word operations half the 67 T/s float32 rate outside
# the tensor cores (an SM has 64 int32 lanes beside its 128 float32
# lanes); shared memory moves 128 B per clock per SM on 132 SMs at the
# 1.755 GHz boost clock.
HBM_BPS = 3.35e12
OPS_PER_S = 33.5e12
SMEM_BPS = 132 * 128 * 1.755e9


def _bound(nbytes: float, nops: float, smem_bytes: float = 0.0):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes = max(nbytes / HBM_BPS, smem_bytes / SMEM_BPS)
    t_ops = nops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def _same(a, b) -> int:
    """Max |a - b| over two int32 outputs (0 when bit-identical); raises on
    a shape or dtype mismatch."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def _flat(out):
    """A kernel's outputs as a flat list of tensors."""
    if len(out) == 3 and isinstance(out[2], list):      # fused_tree_agg
        mask, cnt, parts = out
        return [mask, cnt] + [d[k] for d in parts for k in sorted(d)]
    return list(out)


def _max_err(got, want) -> int:
    g, w = _flat(got), _flat(want)
    if len(g) != len(w):
        raise AssertionError(f"{len(g)} outputs vs {len(w)}")
    return max(_same(a, b) for a, b in zip(g, w))


def phase_kernels_vs_plain(dev):
    import torch
    from knoxdb_tpu_torch.ops import scan_kernels as SK
    from knoxdb_tpu_torch.ops import words as WD
    from knoxdb_tpu_torch.testing import random_tree_case

    rng = np.random.default_rng(SEED)
    P, W = 64, 2048
    ncase = 0
    for width in (0, 1, 16, 41, 48, 64):
        planes, ops, _lf, mask_in, _fw, _sp = random_tree_case(
            rng, (width,), P, W, 1, ())
        args = (WD.to_words(planes[0], dev),
                *(WD.to_words(a, dev) for a in ops[0]),
                WD.to_words(mask_in, dev), width)
        err = _max_err(SK.fused_range_sum_masked(*args),
                       SK.fused_range_sum_masked_torch(*args))
        if err:
            raise AssertionError(f"fused_range_sum_masked w={width}: {err}")
        ncase += 1
    for widths, nleaf in (((16,), 1), ((41, 1), 2), ((64, 48, 16), 3),
                          ((48, 0), 2), ((1, 41), 3)):
        for specs in (tuple((f, f % 2 == 0, True)
                            for f in range(len(widths))),
                      ((0, True, False),), ()):
            case = random_tree_case(rng, widths, P, W, nleaf, specs)
            planes, leaf_ops, leaf_field, mask_in, fw, sp = case
            args = ([WD.to_words(p, dev) for p in planes],
                    [tuple(WD.to_words(a, dev) for a in op)
                     for op in leaf_ops], leaf_field,
                    WD.to_words(mask_in, dev), fw, sp)
            got = SK.fused_tree_agg(*args)
            err = _max_err(got, SK.fused_tree_agg_torch(*args))
            if err or int(got[1][-1]) != 0:
                raise AssertionError(f"fused_tree_agg {widths} {specs}: "
                                     f"err {err}, empty-pack count "
                                     f"{int(got[1][-1])}")
            ncase += 1
    torch.cuda.synchronize()
    print(f"phase 3 kernel=plain: {ncase} random cases bit-identical "
          f"(P={P}, W={W}, widths 0-64, 1-3 leaves, sum and min/max specs, "
          f"an empty pack)")


def phase_split_kernels_vs_plain(dev):
    """range_mask_count and masked_plane_popcounts against their plain
    versions, bit for bit, and every strided entry at the pack-major view
    against its plane-major result."""
    import torch
    from knoxdb_tpu_torch.ops import scan_kernels as SK
    from knoxdb_tpu_torch.ops import words as WD
    from knoxdb_tpu_torch.testing import random_tree_case

    rng = np.random.default_rng(SEED + 5)
    P, W = 37, 2048                      # Pg not a multiple of 8
    ncase = nview = 0
    for width in (0, 1, 16, 33, 64):
        planes, ops, _lf, mask_in, _fw, _sp = random_tree_case(
            rng, (width,), P, W, 1, (), empty_pack=False)
        lo_b, hi_b, flags = ops[0]
        # every combination of the five flag words, one per pack
        flags = flags.copy()
        for j in range(P):
            for c in range(5):
                flags[j, c] = 0xFFFFFFFF if (j >> c) & 1 else 0
        pt = WD.to_words(planes[0], dev)
        cons = tuple(WD.to_words(a, dev) for a in (lo_b, hi_b, flags))
        masks = {"random": mask_in, "empty": np.zeros_like(mask_in),
                 "full": np.full_like(mask_in, 0xFFFFFFFF), "none": None}
        for mname, m in masks.items():
            mt = None if m is None else WD.to_words(m, dev)
            got = SK.range_mask_count(pt, *cons, mt, width)
            err = _max_err(got, SK.range_mask_count_torch(pt, *cons, mt,
                                                          width))
            if mt is not None:
                err = max(err, _max_err(
                    SK.masked_plane_popcounts(pt, mt, width),
                    SK.masked_plane_popcounts_torch(pt, mt, width)))
            if err:
                raise AssertionError(f"split kernels w={width} mask={mname}: "
                                     f"max abs err {err}")
            ncase += 1
        if width:
            pk = pt.permute(1, 0, 2).contiguous().permute(1, 0, 2)
            if width > 1 and pk.is_contiguous():
                raise AssertionError("the pack-major view is a copy")
            mt = WD.to_words(mask_in, dev)
            for fn, args in (
                    (SK.fused_range_sum_masked, (*cons, mt, width)),
                    (SK.range_mask_count, (*cons, mt, width)),
                    (SK.masked_plane_popcounts, (mt, width))):
                err = _max_err(fn(pk, *args), fn(pt, *args))
                if err:
                    raise AssertionError(f"{fn.__name__} at the pack-major "
                                         f"view, w={width}: {err}")
                nview += 1
    torch.cuda.synchronize()
    print(f"phase 3 split kernels=plain: {ncase} cases bit-identical "
          f"(P={P}, W={W}, widths 0, 1, 16, 33, 64, all 32 flag "
          f"combinations, random / empty / full / absent masks); {nview} "
          f"pack-major-view results = plane-major (kernels #1, 5a, 5b)")


def phase_group_kernels_vs_plain(dev):
    """Both group kernels against their plain versions at 4,194,304 rows."""
    import torch
    from knoxdb_tpu_torch.exec import groupby as GB
    from knoxdb_tpu_torch.ops import bitset as BS
    from knoxdb_tpu_torch.ops import group_kernels as GK
    from knoxdb_tpu_torch.ops import words as WD

    rng = np.random.default_rng(GROUP_SEED)
    P, N = 64, PACK_SIZE
    ncase = 0
    for G in (1, 200, 1000, 8192, 65536):
        gid = torch.from_numpy(rng.integers(-2, G + 3, (P, N))
                               .astype(np.int32)).to(dev)
        mask = torch.from_numpy(rng.random((P, N)) < 0.7).to(dev)
        words = BS.pack_mask(mask)
        vals = rng.integers(0, 1 << 32, (2, P, N), dtype=np.uint64) \
            .astype(np.uint32)
        vals[:, :, :256] = 0xFFFFFFFF                  # carry stress
        vlo, vhi = (WD.to_words(v, dev) for v in vals)
        err = _max_err(GK.fused_group_partials(gid, words, vlo, vhi, G),
                       GK.fused_group_partials_torch(gid, words, vlo, vhi, G))
        # moments: r < 2^32 (C1 = 4 chunks, so rhi = 0) and its square
        q = GB.square_halves(vlo)
        zero = torch.zeros_like(vhi)
        err = max(err, _max_err(
            GK.fused_group_moments_partials(gid, words, vlo, zero, *q, G),
            GK.fused_group_moments_partials_torch(gid, words, vlo, zero,
                                                  *q, G)))
        if err:
            raise AssertionError(f"group kernels at G={G}: max abs err {err}")
        ncase += 2
    torch.cuda.synchronize()
    print(f"phase 3 group kernel=plain: {ncase} cases bit-identical "
          f"({P * N} rows, G = 1, 200, 1000, 8192, 65536; gids in [-2, G+3), "
          f"70% masks, all-ones values, squares of values up to 2^32 - 1)")


def phase_chunk_kernel_vs_plain(dev):
    """The chunk kernel (kernels #6 and #7) against its plain version, bit
    for bit: both probe geometries, both output types, both layouts, S in
    {8, 16, 32}, a ragged last block, negative and sentinel gids."""
    import torch
    from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK
    from knoxdb_tpu_torch.ops import words as WD

    rng = np.random.default_rng(GROUP_SEED + 6)
    ncase = 0
    for H, L, shift, C in ((128, 8, 3, 4), (128, 8, 3, 6), (256, 32, 5, 6)):
        for S in (8, 16, 32):
            n = S * 1024 * 9 + 4321
            gid = rng.integers(-3 * H * L, 4 * H * L, n).astype(np.int32)
            gid[:4] = [-1, -(1 << 31), (1 << 31) - 1, H * L]
            gid[4:4096] = 5                       # one contended cell
            g = torch.from_numpy(gid).to(dev)
            vlo, vhi = (WD.to_words(rng.integers(0, 1 << 32, n,
                                                 dtype=np.uint64)
                                    .astype(np.uint32), dev)
                        for _ in range(2))
            for out_dtype in (torch.float32, torch.int32):
                for band in (False, True):
                    got = GCK.group_chunk_partials(g, vlo, vhi, H, L, shift,
                                                   C, S, out_dtype, band)
                    want = GCK.group_chunk_partials_torch(
                        g, vlo, vhi, H, L, shift, C, S, out_dtype, band)
                    if got.dtype != want.dtype or not torch.equal(got, want):
                        raise AssertionError(
                            f"group_chunk_partials H={H} L={L} C={C} S={S} "
                            f"{out_dtype} band={band}: differs from plain")
                    ncase += 1
    torch.cuda.synchronize()
    print(f"phase 3 chunk kernel=plain: {ncase} cases bit-identical (H, L, C "
          f"= 128, 8, 4 / 128, 8, 6 / 256, 32, 6; S = 8, 16, 32; float32 and "
          f"int32; interleaved and band; ragged last block; gids in "
          f"[-3HL, 4HL) with -2^31, 2^31 - 1 and the sentinel)")


def _bench_segment():
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType

    n = PACK_SIZE * N_PACKS
    rng = np.random.default_rng(SEED)
    sch = (Builder("bench").pk("id")
           .add("val", FieldType.UINT64)
           .add("bal", FieldType.INT64)
           .finish())
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
        "bal": rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64),
    }
    t0 = time.perf_counter()
    seg = build_segment(sch, data, pack_size=PACK_SIZE)
    return sch, data, seg, time.perf_counter() - t0


def _queries(sch):
    from knoxdb_tpu_torch.exec.scan import AggSpec
    from knoxdb_tpu_torch.query.filter import Filter, and_, leaf
    from knoxdb_tpu_torch.types import FilterMode

    def cfg1(lo):
        return leaf(Filter(sch.field("val"), FilterMode.RANGE,
                           (lo, 50000))).optimize()

    def two_leaf(lo):
        return and_(leaf(Filter(sch.field("val"), FilterMode.RANGE,
                                (lo, 50000))),
                    leaf(Filter(sch.field("bal"), FilterMode.GT, 0))
                    ).optimize()

    return {
        "config1": (cfg1, [AggSpec("count"), AggSpec("sum", "val")]),
        "two_leaf": (two_leaf, [AggSpec("count"), AggSpec("sum", "bal")]),
        "entry": (two_leaf, [AggSpec("count"), AggSpec("sum", "bal"),
                             AggSpec("min", "val"), AggSpec("max", "val")]),
    }


def _mat_tree(sch, lo):
    """The materialization query: val RANGE (lo, lo + 655), ~1% of rows."""
    from knoxdb_tpu_torch.query.filter import Filter, leaf
    from knoxdb_tpu_torch.types import FilterMode
    return leaf(Filter(sch.field("val"), FilterMode.RANGE,
                       (lo, lo + 655))).optimize()


def _gt_tree(sch, field, thr):
    from knoxdb_tpu_torch.query.filter import Filter, leaf
    from knoxdb_tpu_torch.types import FilterMode
    return leaf(Filter(sch.field(field), FilterMode.GT, thr)).optimize()


def _oracle(data, name, lo):
    m = (data["val"] >= lo) & (data["val"] <= 50000)
    if name != "config1":
        m &= data["bal"] > 0
    out = {("count", ""): int(m.sum())}
    if name == "config1":
        out[("sum", "val")] = int(data["val"][m].astype(object).sum())
    else:
        out[("sum", "bal")] = int(data["bal"][m].astype(object).sum())
    if name == "entry":
        out[("min", "val")] = int(data["val"][m].min())
        out[("max", "val")] = int(data["val"][m].max())
    return int(m.sum()), out


_CYCLES_PER_MS = None
_T0 = time.perf_counter()


def _mark(what: str) -> None:
    print(f"elapsed: {what} done at {time.perf_counter() - _T0:.1f} s",
          flush=True)


def _gpu_sleep(ms: float):
    """Keep the stream busy for about `ms` (torch.cuda._sleep spins for a
    number of clock cycles, calibrated once with events)."""
    import torch
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS = 20_000_000 / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS))


def _event_ms(fn, iters=ITERS, warmup=5, before=None):
    """Median device time of fn(i) in ms over `iters` calls, one CUDA event
    pair per call. Before each call the stream sleeps for longer than the
    host takes to enqueue fn (measured in the warm-up), so the events time
    the device work and not the host's launch overhead. `before(i)` runs
    outside the timed window."""
    import torch
    host = []
    for i in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    cover_ms = 2e3 * max(host) + 0.2
    times = []
    for i in range(iters):
        if before is not None:
            before(i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _gpu_sleep(cover_ms)
        a.record()
        fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _stream_bps(dev) -> float:
    """Same-run device read bandwidth: a torch float32 sum over 256 MiB."""
    import torch
    x = torch.ones((256 << 20) // 4, dtype=torch.float32, device=dev)
    ms = _event_ms(lambda i: x.sum())
    return x.numel() * 4 / (ms / 1e3)


def _cfg3_segment(n_packs: int, G: int):
    """BASELINE config #3 (bench_suite.py:171-198) at n_packs packs."""
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType

    rng = np.random.default_rng(GROUP_SEED)
    n = PACK_SIZE * n_packs
    sch = (Builder("c3").pk("id")
           .add("acct", FieldType.UINT64)
           .add("bal", FieldType.DECIMAL64, scale=4)
           .finish())
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "acct": rng.integers(0, G, n, dtype=np.uint64),
            "bal": rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64)}
    t0 = time.perf_counter()
    seg = build_segment(sch, data, pack_size=PACK_SIZE)
    return sch, data, seg, time.perf_counter() - t0


_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_BIT63 = np.uint64(1 << 63)


def _cfg3_check(name, data, thr, out, minmax):
    """Every group's count, keyform sum and (with minmax) min and max
    against numpy; the sums exact through 21-bit split bincounts. The
    group domain is the dense range of acct keys the zone maps give."""
    gplan, counts, res = out
    G, k0 = gplan.G, int(gplan.keys[0])
    if gplan.mode[0][0] != "range" or int(gplan.keys[-1]) != k0 + G - 1:
        raise AssertionError(f"{name}: group domain {gplan.mode[0][0]}")
    a_all, b_all = data["acct"].astype(np.int64) - k0, data["bal"]
    m = b_all > thr
    a, b = a_all[m], b_all[m]
    cnt = np.bincount(a, minlength=G)
    if not np.array_equal(counts, cnt):
        raise AssertionError(f"{name}: counts differ from np.bincount")
    x = b + (1 << 40)                       # in [0, 2^41)
    lo = np.bincount(a, weights=(x & ((1 << 21) - 1)).astype(np.float64),
                     minlength=G)
    hi = np.bincount(a, weights=(x >> 21).astype(np.float64), minlength=G)
    want = [int(h) * (1 << 21) + int(l) + int(c) * ((1 << 63) - (1 << 40))
            for h, l, c in zip(hi, lo, cnt)]
    if list(res["bal"][0]) != want:
        g = next(i for i, (u, v) in enumerate(zip(res["bal"][0], want))
                 if u != v)
        raise AssertionError(f"{name}: sum of group {g}: "
                             f"{res['bal'][0][g]} != {want[g]}")
    wmn = np.full(G, _U64_MAX, np.uint64)
    wmx = np.zeros(G, np.uint64)
    if minmax:
        bs = b[np.argsort(a, kind="stable")]
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        nz = cnt > 0
        wmn[nz] = np.minimum.reduceat(bs, starts[nz]).view(np.uint64) ^ _BIT63
        wmx[nz] = np.maximum.reduceat(bs, starts[nz]).view(np.uint64) ^ _BIT63
    if not (np.array_equal(res["bal"][1], wmn)
            and np.array_equal(res["bal"][2], wmx)):
        raise AssertionError(f"{name}: min/max differ from numpy")
    return int(cnt.sum())


def _cfg6_segment(n_packs: int):
    """Config #6 (bench_suite.py:438-455) at n_packs packs."""
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType

    rng = np.random.default_rng(GROUP_SEED)
    n = PACK_SIZE * n_packs
    sch = (Builder("c6").pk("id")
           .add("ts", FieldType.UINT64)
           .add("val", FieldType.INT64)
           .finish())
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "ts": (T6 + rng.integers(0, G6 * IV6, n)).astype(np.uint64),
            "val": rng.integers(-1 << 30, 1 << 30, n)}
    t0 = time.perf_counter()
    seg = build_segment(sch, data, pack_size=PACK_SIZE)
    return sch, data, seg, time.perf_counter() - t0


def _cfg6_check(data, out):
    """Counts exact against np.bincount; sums and sums of squares equal
    to the exact python-int sums cast to f64 (split bincounts, every
    partial sum an integer below 2^53)."""
    ts, val = data["ts"], data["val"]
    m = (ts >= T6) & (ts < T6 + G6 * IV6)
    b = ((ts[m] - np.uint64(T6)) // np.uint64(IV6)).astype(np.int64)
    v = val[m]
    cnt = np.bincount(b, minlength=G6)
    s1 = np.bincount(b, weights=v.astype(np.float64), minlength=G6)
    sq = v * v
    lo = np.bincount(b, weights=(sq & ((1 << 30) - 1)).astype(np.float64),
                     minlength=G6)
    hi = np.bincount(b, weights=(sq >> 30).astype(np.float64), minlength=G6)
    s2 = np.array([float(int(h) * (1 << 30) + int(l))
                   for h, l in zip(hi, lo)])
    n_, sm, sqs = out[("val", "moments")]
    if not np.array_equal(n_, cnt):
        raise AssertionError("config6: bucket counts differ")
    if not (np.array_equal(sm, s1) and np.array_equal(sqs, s2)):
        raise AssertionError("config6: sums or sums of squares differ")
    return int(cnt.sum())


def _capture(mod, name, call, every=False):
    """Run call() with mod.name wrapped; returns the first operands the
    main path handed that wrapper, or with every=True the operands of
    each of its calls in order (the wrappers are looked up on their
    module at call time)."""
    orig = getattr(mod, name)
    got = []

    def rec(*args, **kw):
        if every or not got:
            got.append(args)
        return orig(*args, **kw)

    setattr(mod, name, rec)
    try:
        call()
    finally:
        setattr(mod, name, orig)
    return got if every else got[0]


def _wall_ms(fn, iters=ITERS, warmup=3):
    """Median host wall time of fn(i), which ends in a device->host copy."""
    for i in range(warmup):
        fn(i)
    t = []
    for i in range(iters):
        t0 = time.perf_counter()
        fn(i)
        t.append(time.perf_counter() - t0)
    return statistics.median(t) * 1e3


def _profile(fn, n=10):
    """torch.profiler over n calls of fn(i): profiled wall and device busy
    time per call, the device idle share, the top kernels, and the device
    time per call of sort kernels (names with "sort" or "radix"), of
    device-to-host copies and of everything else."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = {}
    nev = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            nev += 1
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    cats = {"sort_ms": 0.0, "d2h_ms": 0.0, "other_ms": 0.0}
    for name, ms in by.items():
        low = name.lower()
        if "memcpy" in low and "dtoh" in low:
            cats["d2h_ms"] += ms / n
        elif "sort" in low or "radix" in low:
            cats["sort_ms"] += ms / n
        else:
            cats["other_ms"] += ms / n
    return {"wall_ms": wall / n, "device_ms": busy / n,
            "idle_share": 1.0 - busy / wall,
            "device_ops_per_call": nev / n, **cats,
            "top": [(k[:70], v / n) for k, v in top]}


# ------------------------- the chunk route and the float series path ---

FLOAT_SEED = 0xA17                 # probes/compression_matrix.py:119
EPS64 = 2.0 ** -52
PRICE_LO, PRICE_HI = 1000.0, 3000.0
PROJ_LO, PROJ_HI = 1000.0, 1050.0   # ~1% of prices uniform in (0.01, 5000)


def phase_chunk_route(name, sc, sch, data, want_launches):
    """group_count_chunks on the operands group_scan hands its group kernel:
    the same counts and python-int sums as group_scan, and as numpy."""
    from knoxdb_tpu_torch.exec import groupby as GB
    tree = _gt_tree(sch, "bal", THR3)
    box = {}

    def call():
        box["out"] = sc.group_scan(tree, "acct", ["bal"], minmax=False)

    ops = _capture(GB, "group_count_sum", call)     # gids, mask, pair, G
    gplan, counts, res = box["out"]
    C, bias = GB.chunk_plan(sc.d.seg.stats.fields["bal"])
    (cc, chunks), launches = run_path(
        lambda: GB.group_count_chunks(*ops, C, bias))
    if launches["group_chunk_partials"] != want_launches:
        raise AssertionError(f"{name}: {launches['group_chunk_partials']} "
                             f"chunk kernel launches, not {want_launches}")
    cnp = cc.cpu().numpy()
    sums = GB.mxu_chunk_sums([c.cpu().numpy() for c in chunks]) \
        + bias * cnp.astype(object)
    if not np.array_equal(cnp, counts) or list(sums) != list(res["bal"][0]):
        raise AssertionError(f"{name}: the chunk route differs from "
                             f"group_scan")
    G = gplan.G
    nsel = _cfg3_check(name, data, THR3, (gplan, cnp, {"bal": (
        sums, np.full(G, _U64_MAX, np.uint64), np.zeros(G, np.uint64))}),
        False)
    H, L = GB._chunk_geometry(min(G, GB.CHUNK_PASS_GROUPS))
    print(f"phase 4 main path {name} group_count_chunks: "
          f"{ops[0].numel()} rows, G={G}, H={H}, L={L}, {C} byte chunks, "
          f"bias {bias}, {nsel} rows pass; counts and python-int sums equal "
          f"to group_scan's and numpy's; launches "
          f"{launches['group_chunk_partials']}")
    return {"ops": ops, "C": C, "bias": bias, "H": H, "L": L,
            "launches": launches["group_chunk_partials"]}


def _cfg6f_segment(n_packs: int):
    """Config #6's schema and data (bench_suite.py:436-447) plus two FLOAT64
    columns from probes/compression_matrix.py:97-98 (dec4_price: four
    decimals, ALP) and :103 (poi_lat: full precision, keyform)."""
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType

    rng = np.random.default_rng(GROUP_SEED)
    frng = np.random.default_rng(FLOAT_SEED)
    n = PACK_SIZE * n_packs
    sch = (Builder("c6f").pk("id")
           .add("ts", FieldType.UINT64)
           .add("val", FieldType.INT64)
           .add("price", FieldType.FLOAT64)
           .add("lat", FieldType.FLOAT64)
           .finish())
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "ts": (T6 + rng.integers(0, G6 * IV6, n)).astype(np.uint64),
            "val": rng.integers(-1 << 30, 1 << 30, n),
            "price": np.round(frng.uniform(0.01, 5000, n), 4),
            "lat": frng.uniform(-90, 90, n)}
    t0 = time.perf_counter()
    seg = build_segment(sch, data, pack_size=PACK_SIZE)
    return sch, data, seg, time.perf_counter() - t0


KINDS6F = {"price": ("moments", "firstlast", "fminmax"),
           "lat": ("moments", "firstlast", "fminmax"),
           "val": ("tsruns", "firstlast")}


def _cfg6f_check(data, out, t0: int):
    """Every output of the float series call against numpy: counts, first /
    last, float min / max and the ts runs exactly; float moments within 64
    eps * Σ|v| (Σv²) per bucket of the exactly rounded sums (math.fsum)."""
    import math

    from knoxdb_tpu_torch.types import FieldType
    from knoxdb_tpu_torch.utils import limbs as L_
    ts = data["ts"]
    m = (ts >= t0) & (ts < t0 + G6 * IV6)
    rows = np.flatnonzero(m)
    b = ((ts[rows] - np.uint64(t0)) // np.uint64(IV6)).astype(np.int64)
    order = np.lexsort((ts[rows], b))            # stable: ties in row order
    rows, b = rows[order], b[order]
    cnt = np.bincount(b, minlength=G6)
    if (cnt == 0).any():
        raise AssertionError("config6f: an empty bucket (the oracle takes "
                             "every bucket as filled)")
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    ends = starts + cnt - 1
    tss = ts[rows]
    worst = 0.0
    for f in ("price", "lat"):
        v = data[f][rows]
        n_, s1, s2 = out[(f, "moments")]
        if not np.array_equal(n_, cnt):
            raise AssertionError(f"config6f {f}: bucket counts differ")
        for got, x in ((s1, v), (s2, v * v)):
            parts = np.split(x, starts[1:])
            exact = np.array([math.fsum(p) for p in parts])
            scale = np.add.reduceat(np.abs(x), starts)
            err = np.abs(got - exact) / (EPS64 * scale)
            worst = max(worst, float(err.max()))
            if err.max() > 64:
                raise AssertionError(f"config6f {f} moments: {err.max():.1f} "
                                     f"eps * sum|v| off the exact sum")
        keys = L_.to_keys64(v, FieldType.FLOAT64)
        c, mn, mx = out[(f, "fminmax")]
        if not (np.array_equal(c, cnt)
                and np.array_equal(mn, np.minimum.reduceat(keys, starts))
                and np.array_equal(mx, np.maximum.reduceat(keys, starts))):
            raise AssertionError(f"config6f {f} fminmax differs")
    for f in ("price", "lat", "val"):
        col = data[f][rows]
        pay = col.view(np.uint64) if col.dtype == np.float64 \
            else col.astype(np.int64).view(np.uint64) ^ _BIT63
        f_ts, f_v, l_ts, l_v, c = out[(f, "firstlast")]
        want = (tss[starts], pay[starts], tss[ends], pay[ends], cnt)
        for g_, w_ in zip((f_ts, f_v, l_ts, l_v, c), want):
            if not np.array_equal(g_, w_):
                raise AssertionError(f"config6f {f} firstlast differs")
    # ts runs of val: rows of one (bucket, ts) are one run
    val = data["val"][rows].astype(np.int64)
    new = np.ones(len(rows), bool)
    new[1:] = (b[1:] != b[:-1]) | (tss[1:] != tss[:-1])
    rs = np.flatnonzero(new)
    run_b, run_ts = b[rs], tss[rs]
    run_cnt = np.diff(np.concatenate([rs, [len(rows)]]))
    vu = val.view(np.uint64)
    run_lo = np.add.reduceat(vu & np.uint64(0xFFFFFFFF), rs)
    run_hi = np.add.reduceat(vu >> np.uint64(32), rs)
    run_sum = np.add.reduceat(val, rs)           # |sum| < 2^43: exact
    nr = np.bincount(run_b, minlength=G6)
    if nr.min() < 3:
        raise AssertionError("config6f: a bucket with fewer than 3 runs")
    fi = np.concatenate([[0], np.cumsum(nr)[:-1]])
    li = fi + nr - 1
    r = out[("val", "tsruns")]
    key = run_sum.view(np.uint64) ^ _BIT63
    inner = np.stack([fi + 1, li]).T.ravel()     # [fi + 1, li) per bucket
    sq = run_sum.astype(object) ** 2
    cs = np.concatenate([[0], np.cumsum(sq)])
    isq = np.array([float(cs[e] - cs[s_]) for s_, e in zip(fi + 1, li)])
    csum = np.concatenate([[0], np.cumsum(run_sum)])
    want = (nr, run_ts[fi], run_cnt[fi], run_lo[fi], run_hi[fi], run_ts[li],
            run_cnt[li], run_lo[li], run_hi[li],
            np.minimum.reduceat(key, inner)[::2],
            np.maximum.reduceat(key, inner)[::2], nr - 2,
            (csum[li] - csum[fi + 1]).astype(np.float64))
    for i, w_ in enumerate(want):
        if not np.array_equal(r[i], w_):
            raise AssertionError(f"config6f val tsruns output {i} differs")
    err = np.abs(r[13] - isq) / (EPS64 * isq)
    if err.max() > 64:
        raise AssertionError(f"config6f val tsruns int_sumsq: {err.max():.1f} "
                             f"eps off")
    return int(cnt.sum()), int(nr.sum()), max(worst, float(err.max()))


def phase_floats(dev):
    """The float series path at full width, each call against numpy."""
    from fractions import Fraction

    from knoxdb_tpu_torch.encode.schemes import Scheme
    from knoxdb_tpu_torch.exec import groupby as GB
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu_torch.query import filter as Q
    from knoxdb_tpu_torch.types import FilterMode

    sch, data, seg, t_build = _cfg6f_segment(PACKS_SMALL)
    sc = SegmentScanner(DeviceSegment(seg, dev))
    schemes = {f: sorted({g.scheme.name for g in sc.d.column(f).groups})
               for f in ("price", "lat")}
    if schemes["price"] != ["ALP"] or "ALP" in schemes["lat"]:
        raise AssertionError(f"config6f schemes: {schemes}")
    widths = sorted({g.width for g in sc.d.column("price").groups})
    plans = [GB.plan_buckets(sc.d, "ts", T6 + k, IV6, G6) for k in (0, 1)]
    out, launches = run_path(
        lambda: sc.series_scan(None, "ts", KINDS6F, plans[0]))
    need(launches, ("fused_tree_agg",), "config6f series_scan")
    nsel, nruns, worst = _cfg6f_check(data, out, T6)
    print(f"phase 4 main path config6f series_scan (moments + firstlast + "
          f"fminmax on price and lat, tsruns + firstlast on val): "
          f"{seg.nrows_total} rows, {G6} buckets, {nsel} rows bucketed, "
          f"{nruns} ts runs, price {schemes['price']} widths {widths}, lat "
          f"{schemes['lat']}, host build {t_build:.2f} s; exact outputs "
          f"equal to numpy, float sums within {worst:.2f} eps * sum|v| of "
          f"the exact sums (limit 64); launches {launches}")

    def rng_tree(lo, hi):
        return Q.leaf(Q.Filter(sch.field("price"), FilterMode.RANGE,
                               (lo, hi))).optimize()

    aggs = [AggSpec("count"), AggSpec("sum", "price"),
            AggSpec("min", "price"), AggSpec("max", "price")]
    res, launches = run_path(
        lambda: sc.scan(rng_tree(PRICE_LO, PRICE_HI), aggs))
    need(launches, ("range_mask_count", "masked_plane_popcounts"),
         "config6f price RANGE")
    price = data["price"]
    m = (price >= PRICE_LO) & (price <= PRICE_HI)
    enc = np.rint(price[m] * 1e4).astype(np.int64)
    want = {("count", ""): int(m.sum()),
            ("sum", "price"): float(Fraction(int(enc.sum()), 10 ** 4)),
            ("min", "price"): float(price[m].min()),
            ("max", "price"): float(price[m].max())}
    if res.count != int(m.sum()) or res.aggs != want:
        raise AssertionError(f"config6f price RANGE: {res.count} "
                             f"{res.aggs} != {want}")
    print(f"phase 4 main path config6f scan(price RANGE [{PRICE_LO}, "
          f"{PRICE_HI}], count, sum, min, max): count={res.count} "
          f"aggs={res.aggs}; the sum is the exact rational sum rounded "
          f"once; exact vs numpy; launches {launches}")

    res, launches = run_path(
        lambda: sc.scan(rng_tree(PROJ_LO, PROJ_HI), [], project=["price"]))
    need(launches, ("range_mask_count",), "config6f project price")
    rows = np.flatnonzero((price >= PROJ_LO) & (price <= PROJ_HI))
    if not (np.array_equal(res.row_ids, rows.astype(np.uint64))
            and np.array_equal(res.rows["price"].view(np.uint64),
                               price[rows].view(np.uint64))):
        raise AssertionError("config6f scan(project=price) differs")
    print(f"phase 4 main path config6f scan(project=price) at "
          f"{100.0 * len(rows) / len(price):.2f}%: {len(rows)} rows, ids "
          f"and float64 bits equal to numpy; launches {launches}")
    calls = {
        "series_scan floats": lambda i: sc.series_scan(None, "ts", KINDS6F,
                                                       plans[i % 2]),
        "price RANGE": lambda i: sc.scan(
            rng_tree(PRICE_LO + (i % 2), PRICE_HI), aggs),
        "project price": lambda i: sc.scan(
            rng_tree(PROJ_LO + (i % 2), PROJ_HI + (i % 2)), [],
            project=["price"])}
    return calls


def time_chunk_kernels(routes, records3, ops3c, stream, dev):
    """Kernels #6 and #7 at the operands the chunk route hands them: kernel
    = plain bit for bit, kernel, plain and index_add_ times, the bound from
    these operands, kernel #3's time on the same rows, and the whole
    route's wall and profile beside group_count_sum's."""
    import torch
    from knoxdb_tpu_torch.exec import groupby as GB
    from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK

    k3 = {"config3": next(r["ms"] for r in records3
                          if r["name"] == "fused_group_partials"),
          "config3c": _event_ms(lambda i: GB.group_count_sum(*ops3c))}
    out = []
    for (qname, rt), num, repl in zip(
            routes.items(), ("6", "7"),
            ("probes/pg3_variants.py:84", "probes/pg_bigG.py:98")):
        ops, C, bias = rt["ops"], rt["C"], rt["bias"]
        passes = _capture(GCK, "group_chunk_partials",
                          lambda: GB.group_count_chunks(*ops, C, bias),
                          every=True)
        gid, vlo, vhi, H, L, shift, C_ = passes[0]
        got = GCK.group_chunk_partials(*passes[0])
        if not torch.equal(got, GCK.group_chunk_partials_torch(*passes[0])):
            raise AssertionError(f"group_chunk_partials at {qname}'s "
                                 f"operands differs from plain")
        buf = torch.empty_like(got)
        n = gid.numel()
        # what this run's data needs: 12 B per row in, the partials out, and
        # one shared-memory atomic (a read and a write of 4 B) per row of
        # the pass and per nonzero byte of its value
        inp = (gid >= 0) & (gid < H * L)
        atomics = int(inp.sum())
        for c in range(C_):
            w = vlo if c < 4 else vhi
            atomics += int((inp & (((w >> (8 * (c % 4))) & 0xFF) != 0)).sum())
        nbytes = 12 * n + got.numel() * 4
        bound_ms, bound_by = _bound(nbytes, n * (4 + 3 * C_),
                                    smem_bytes=8 * atomics)
        ms = _event_ms(lambda i: GCK.group_chunk_partials(*passes[0],
                                                          out=buf))
        all_ms = _event_ms(lambda i: [GCK.group_chunk_partials(*a, out=buf)
                                      for a in passes], iters=20)
        plain_ms = _event_ms(
            lambda i: GCK.group_chunk_partials_torch(*passes[0]), iters=10)
        # the library route: ONE index_add_ of the count and the byte
        # columns into int64[NC, H * L + 1] (the last slot takes the rows
        # outside the pass), its operands made outside the timed window
        cols = [(((vlo if c < 4 else vhi) >> (8 * (c % 4))) & 0xFF)
                .to(torch.int64) for c in range(C_)]
        src = torch.stack(cols + [torch.ones_like(cols[0])])
        at = torch.where(inp, gid, H * L).long()
        lib_ms = _event_ms(
            lambda i: torch.zeros((C_ + 1, H * L + 1), dtype=torch.int64,
                                  device=dev).index_add_(1, at, src),
            iters=20)
        del cols, src, at, inp
        fn_c = lambda i: GB.group_count_chunks(*ops, C, bias)[0].cpu()  # noqa
        fn_s = lambda i: GB.group_count_sum(*ops)[0].cpu()              # noqa
        rec = {"name": "group_chunk_partials", "kernel": f"#{num}",
               "route": "cuda", "source": _SOURCES["group_chunk_partials"],
               "replaces": repl, "launches": rt["launches"],
               "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "query": f"{qname} chunk route",
               "geometry": {"H": H, "L": L, "C": C_, "S": 8, "rows": n,
                            "blocks": got.shape[0]},
               "bytes": nbytes, "smem_atomics": atomics,
               "bound_stream_ms": nbytes / stream * 1e3,
               "ms_all_passes": all_ms,
               "kernel3_ms_same_rows": k3[qname],
               "route_wall_ms": _wall_ms(fn_c, iters=20),
               "route_profile": _profile(fn_c, n=5),
               "count_sum_route_wall_ms": _wall_ms(fn_s, iters=20),
               "rows_per_s": n / (ms / 1e3),
               "pct_of_stream_bw": 100.0 * nbytes / (ms / 1e3) / stream}
        print(f"phase 5 chunk kernel #{num} ({qname}: {n} rows, H={H}, "
              f"L={L}, C={C_}, {got.shape[0]} blocks): kernel {ms:.4f} ms per "
              f"launch ({rt['launches']} launches {all_ms:.4f} ms), bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {atomics} shared "
              f"atomics), plain {plain_ms:.3f} ms, index_add_ {lib_ms:.3f} "
              f"ms, kernel #3 on the same rows {k3[qname]:.4f} ms; whole "
              f"group_count_chunks {rec['route_wall_ms']:.3f} ms against "
              f"group_count_sum {rec['count_sum_route_wall_ms']:.3f} ms; "
              f"profiled: {rec['route_profile']}")
        out.append(rec)
    return out


def time_floats(calls):
    out = {}
    for name, fn in calls.items():
        out[name] = {"wall_ms": _wall_ms(fn, iters=20),
                     "profile": _profile(fn, n=5)}
        print(f"phase 5 config6f {name}: {out[name]}")
    return out


# ------------------------------------------------ joins and tile sorts ---

JOIN_SEED = 0xC0FFEE                  # bench_suite.py:642, config 5 alone
NL5 = PACK_SIZE * N_PACKS // 4        # bench_suite.py:320 at 256 packs
TAGBIT = 1 << 31


def phase_sort_kernel_vs_plain(dev):
    """Kernel #8 against its plain version, bit for bit: keys from the
    probe's default_rng(3), payload arange; 4 tiles of keys in [0, 8)
    (ties everywhere) and 32 tiles of full-range u32 keys; ntpose 0 and 8
    (msort_probe.py:132-134)."""
    import torch
    from knoxdb_tpu_torch.ops import sort_kernels as S8
    from knoxdb_tpu_torch.ops import words as WD

    rng = np.random.default_rng(3)
    ncase = 0
    for B, krange in ((4, 8), (32, 1 << 32)):
        n = B * S8.TILE
        keys = WD.to_words(rng.integers(0, krange, n, dtype=np.uint64)
                           .astype(np.uint32), dev)
        pay = torch.arange(n, dtype=torch.int32, device=dev)
        for ntpose in (0, 8):
            got = S8.tile_bitonic_sort(keys, pay, ntpose)
            err = _max_err(got, S8.tile_bitonic_sort_torch(keys, pay, ntpose))
            if err:
                raise AssertionError(f"tile_bitonic_sort B={B} keys < "
                                     f"{krange} ntpose={ntpose}: {err}")
            ncase += 1
    torch.cuda.synchronize()
    print(f"phase 3 tile sort kernel=plain: {ncase} cases bit-identical "
          f"(4 tiles of keys in [0, 8), 32 tiles of full-range u32 keys, "
          f"payload arange, ntpose 0 and 8)")


def _cfg5_keys(nl: int):
    """Config #5's join keys (bench_suite.py:320-322, :356): u64 keys
    uniform in [0, 2 nl) with duplicates on both sides, and the unique
    build side permutation(2 * arange(nr))."""
    rng = np.random.default_rng(JOIN_SEED)
    lk = rng.integers(0, nl * 2, nl, dtype=np.uint64)
    rk = rng.integers(0, nl * 2, nl, dtype=np.uint64)
    rku = rng.permutation(np.arange(nl, dtype=np.uint64) * np.uint64(2))
    return lk, rk, rku


def _join_oracle(lk, rk, how):
    """Vectorized numpy join: every (probe row, build row) of equal keys,
    plus (probe row, -1) for LEFT misses. Returns the pairs encoded as
    sorted int64 codes l * (nr + 1) + r + 1 (a multiset). The probe keys
    are searched in sorted order: numpy's search of ascending needles
    walks the build keys once, several times faster than random ones."""
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lorder = np.argsort(lk, kind="stable")
    ls = lk[lorder]
    lo = np.searchsorted(rs, ls, "left")
    cnt = np.searchsorted(rs, ls, "right") - lo
    eff = np.maximum(cnt, 1) if how == "left" else cnt
    li = np.repeat(lorder, eff)
    k = np.arange(len(li)) - np.repeat(np.cumsum(eff) - eff, eff)
    hit = np.repeat(cnt > 0, eff)
    ri = np.full(len(li), -1, np.int64)
    ri[hit] = order[np.repeat(lo, eff)[hit] + k[hit]]
    return _pair_codes(li, ri, len(rk))


def _pair_codes(li, ri, nr):
    return np.sort(np.asarray(li, np.int64) * (nr + 1)
                   + np.asarray(ri, np.int64) + 1)


def _check_pairs(name, got, want, nr):
    codes = _pair_codes(got[0], got[1], nr)
    if not np.array_equal(codes, want):
        raise AssertionError(f"{name}: {len(codes)} pairs vs {len(want)} "
                             f"from the numpy oracle, or they differ")
    return len(codes)


def _key_tensor(a, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64)).to(dev)


def _merged_operands(lk, rk, dev):
    """The config #5 join's merged sort operands, as the keys32 merged
    sort builds them (exec/join._merged_sort_tagged): key = the low 32 key
    bits of [build, probe], payload = build ids, then TAGBIT | probe ids;
    int32-carried u32."""
    from knoxdb_tpu_torch.ops import words as WD
    keys = (np.concatenate([rk, lk]) & np.uint64(0xFFFFFFFF)) \
        .astype(np.uint32)
    pidt = np.concatenate([np.arange(len(rk), dtype=np.uint32),
                           np.arange(len(lk), dtype=np.uint32)
                           | np.uint32(TAGBIT)])
    return WD.to_words(keys, dev), WD.to_words(pidt, dev)


def phase_joins(dev, nl):
    """Config #5 at nl = nr: join_pairs_device INNER and LEFT (shift
    core), unique_build with keys32, join_pairs_core with a cap retry,
    join_count_device, and a build with a key run wider than SHIFT_S (the
    ladder falls back to the general core); each an exact pair multiset
    against numpy. Returns the device keys and the oracles for phase 5."""
    from knoxdb_tpu_torch.exec import join as TJ
    from knoxdb_tpu_torch.types import JoinType

    lk, rk, rku = _cfg5_keys(nl)
    # one key with 40 builds: its run spans more than SHIFT_S entries
    rkw = rk.copy()
    rkw[:40] = lk[0]
    d = {n: _key_tensor(a, dev) for n, a in
         (("lk", lk), ("rk", rk), ("rku", rku), ("rkw", rkw))}
    want = {"inner": _join_oracle(lk, rk, "inner"),
            "left": _join_oracle(lk, rk, "left"),
            "unique": _join_oracle(lk, rku, "inner"),
            "wide": _join_oracle(lk, rkw, "inner")}
    out = {}
    out["inner"] = _check_pairs("join_pairs_device INNER", TJ.join_pairs_device(
        d["lk"], d["rk"], JoinType.INNER), want["inner"], nl)
    out["left"] = _check_pairs("join_pairs_device LEFT", TJ.join_pairs_device(
        d["lk"], d["rk"], JoinType.LEFT), want["left"], nl)
    out["unique"] = _check_pairs(
        "join_pairs_device unique_build keys32", TJ.join_pairs_device(
            d["lk"], d["rku"], JoinType.INNER, unique_build=True,
            keys32=True), want["unique"], nl)
    _, _, _, maxneed = TJ.join_pairs_core_shift(d["lk"], d["rkw"],
                                                S=TJ.SHIFT_S)
    if int(maxneed) <= TJ.SHIFT_S:
        raise AssertionError(f"wide run: maxneed {int(maxneed)}")
    out["wide"] = _check_pairs("join_pairs_device wide run (fallback)",
                               TJ.join_pairs_device(d["lk"], d["rkw"]),
                               want["wide"], nl)
    # the general core directly, with a cap that cuts, then the retry
    cap = 1 << (nl // 4 - 1).bit_length()
    _, _, total = TJ.join_pairs_core(d["lk"], d["rk"], cap)
    total = int(total)
    if total != len(want["inner"]) or total <= cap:
        raise AssertionError(f"join_pairs_core total {total} at cap {cap}")
    cap = 1 << (total - 1).bit_length()
    li, ri, _ = TJ.join_pairs_core(d["lk"], d["rk"], cap)
    keep = li != -2
    out["core"] = _check_pairs("join_pairs_core", (li[keep].cpu().numpy(),
                               ri[keep].cpu().numpy()), want["inner"], nl)
    for how, key in ((JoinType.INNER, "inner"), (JoinType.LEFT, "left")):
        c = int(TJ.join_count_device(d["lk"], d["rk"], how))
        if c != len(want[key]):
            raise AssertionError(f"join_count_device {key}: {c}")
    print(f"phase 4 main path config5 joins: nl = nr = {nl}, pairs "
          f"INNER {out['inner']}, LEFT {out['left']}, unique build "
          f"{out['unique']}, wide-run fallback {out['wide']}, "
          f"join_pairs_core after a cap retry {out['core']} (cap {cap}), "
          f"join_count_device INNER and LEFT; every pair multiset exact vs "
          f"numpy")
    return d, cap, out, (lk, rk, rku)


def _txacct_segments(lk, rku):
    """tx (id pk, acct u64 = the probe keys, amount i64 in +-2^40) and
    accounts (id pk, aid u64 = the unique build keys, bal i64)."""
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType

    rng = np.random.default_rng(JOIN_SEED + 1)
    nl, nr = len(lk), len(rku)
    tx_s = (Builder("tx").pk("id").add("acct", FieldType.UINT64)
            .add("amount", FieldType.INT64).finish())
    ac_s = (Builder("accounts").pk("id").add("aid", FieldType.UINT64)
            .add("bal", FieldType.INT64).finish())
    tx = {"id": np.arange(1, nl + 1, dtype=np.uint64), "acct": lk,
          "amount": rng.integers(-1 << 40, 1 << 40, nl, dtype=np.int64)}
    ac = {"id": np.arange(1, nr + 1, dtype=np.uint64), "aid": rku,
          "bal": rng.integers(-1 << 40, 1 << 40, nr, dtype=np.int64)}
    t0 = time.perf_counter()
    segs = (build_segment(tx_s, tx, pack_size=PACK_SIZE),
            build_segment(ac_s, ac, pack_size=PACK_SIZE))
    return (tx_s, tx, segs[0]), (ac_s, ac, segs[1]), \
        time.perf_counter() - t0


def _join_side(sc, tree, field):
    """engine/table.py:836-861 for one segment: the scan's mask plan ->
    the key column decoded (group_decode_keys, table.py:845-852) -> the
    selection vector (mask_to_indexes, :854-855) -> the keys and positions
    of the matching rows (:856-860). Keys in the two's-complement value
    domain (:830): the ordered key with bit 63 flipped back for an
    unsigned field, as it stands for a signed one."""
    import torch
    from knoxdb_tpu_torch.exec import device as D
    from knoxdb_tpu_torch.ops import compact as CP

    d = sc.d
    fn, args = sc.prepare(tree, [])
    mask_words, counts, _ = fn(*args)
    total = int(counts.sum())
    cap = min(1 << max(0, (total - 1).bit_length()), d.P * d.N)
    groups = d.column(field).groups
    keys = torch.empty((d.P, d.N), dtype=torch.int64, device=d.device)
    for g in groups:
        keys[g.idx_t] = D.group_decode_keys(g, d.W)
    if not d.seg.columns[field].field.type.is_signed:
        keys ^= -(1 << 63)
    idx, _ = CP.packed_mask_to_indexes(mask_words, cap)
    safe = torch.where(idx == CP.SENTINEL, 0, idx).long()
    pos = (idx.long() & 0xFFFFFFFF)[:total]
    return keys.reshape(-1)[safe][:total], pos


def _rows_at(sc, positions, project):
    """engine/table.py:892-911 for one segment: the matched positions as an
    include bitset, one scan(None, project=) over it, then each position's
    row through the inverse of the ascending row ids (a scatter; table.py
    searches them, which costs seconds at 2M random positions)."""
    from knoxdb_tpu_torch.exec.scan import AggSpec
    from knoxdb_tpu_torch.ops import bitset as BS

    d = sc.d
    mm = np.zeros(d.P * d.N, bool)
    mm[positions] = True
    incl = BS.np_pack_mask(mm).reshape(d.P, d.N // 32)
    r = sc.scan(None, [AggSpec("count")], project=project, include_words=incl)
    inv = np.empty(d.P * d.N, np.int64)
    inv[r.row_ids.astype(np.int64)] = np.arange(len(r.row_ids))
    take = inv[positions]
    return {name: r.rows[name][take] for name in project}


def _tx_join(sc_tx, sc_ac, tree):
    """tx ⋈ accounts on acct = aid, amount and bal of every pair."""
    from knoxdb_tpu_torch.exec import join as TJ
    from knoxdb_tpu_torch.types import JoinType

    lkeys, lpos = _join_side(sc_tx, tree, "acct")
    rkeys, rpos = _join_side(sc_ac, None, "aid")
    li, ri = TJ.join_pairs_device(lkeys, rkeys, JoinType.INNER,
                                  unique_build=True)
    lp = lpos.cpu().numpy()[li]
    rp = rpos.cpu().numpy()[ri]
    return lp, rp, {**_rows_at(sc_tx, lp, ["amount"]),
                    **_rows_at(sc_ac, rp, ["bal"])}


def _tx_join_check(name, got, tx, ac, m):
    """Against numpy: every tx row passing m whose acct has an account,
    with its amount and that account's bal, in any order."""
    lp, rp, cols = got
    order = np.argsort(ac["aid"])
    aid = ac["aid"][order]
    l_rows = np.flatnonzero(m)
    l_rows = l_rows[np.argsort(tx["acct"][l_rows], kind="stable")]
    acct = tx["acct"][l_rows]                     # ascending: a fast search
    at = np.minimum(np.searchsorted(aid, acct), len(order) - 1)
    hit = aid[at] == acct
    wl, wr = l_rows[hit], order[at[hit]]
    s = np.argsort(wl)
    wl, wr = wl[s], wr[s]
    s = np.argsort(lp, kind="stable")
    if not (np.array_equal(lp[s], wl) and np.array_equal(rp[s], wr)
            and np.array_equal(cols["amount"][s], tx["amount"][wl])
            and np.array_equal(cols["bal"][s], ac["bal"][wr])):
        raise AssertionError(f"{name}: pairs or projected values differ "
                             f"from numpy")
    return len(wl)


def time_sort_probe(kops, pops, probe_ns, stream):
    """Kernel #8 (ntpose 0 and 8), its plain version and torch.sort
    (stable, key + payload gather: the join's own sort) on the join's
    merged operands, and the probe's projection (msort_probe.py:221-236)
    with the card's per-stage cost and the same-run read pass in place of
    its TPU constants."""
    import torch
    from knoxdb_tpu_torch.ops import sort_kernels as S8

    out = []
    for n in probe_ns:
        k, p = kops[:n], pops[:n]
        k64 = k.long() & 0xFFFFFFFF

        def lib_sort(i):
            s = torch.sort(k64, stable=True)
            return s.values, p[s.indices]

        t_stage = _event_ms(lambda i: S8.tile_bitonic_sort(k, p, 0), iters=20)
        t_tpose = _event_ms(lambda i: S8.tile_bitonic_sort(k, p, 8), iters=20)
        t_plain = _event_ms(lambda i: S8.tile_bitonic_sort_torch(k, p, 0),
                            iters=5, warmup=2)
        t_lib = _event_ms(lib_sort, iters=20)
        per_stage = t_stage / len(S8.STAGES)
        per_tpose = max(t_tpose - t_stage, 0.0) / 8
        n_phases = int(np.log2(n))
        total_stages = n_phases * (n_phases + 1) // 2
        cross_tile = sum(max(0, q - int(np.log2(S8.TILE)))
                         for q in range(1, n_phases + 1))
        hbm_pass_ms = n * 8 * 3 / stream * 1e3
        est = (per_stage * total_stages + per_tpose * 2 * n_phases
               + cross_tile * hbm_pass_ms)
        rec = {"n": n, "kernel_ms": t_stage, "kernel_ntpose8_ms": t_tpose,
               "plain_ms": t_plain, "torch_sort_ms": t_lib,
               "per_stage_ms": per_stage, "per_tpose_ms": per_tpose,
               "cross_tile_stages": cross_tile, "hbm_pass_ms": hbm_pass_ms,
               "projection_ms": est,
               "verdict": "BUILD IT" if est < t_lib / 1.3 else "LEVER CLOSED"}
        out.append(rec)
        print(f"phase 5 sort probe N={n}: kernel {t_stage:.4f} ms "
              f"(ntpose 8: {t_tpose:.4f}), plain {t_plain:.4f} ms, "
              f"torch.sort {t_lib:.4f} ms; per-stage {per_stage * 1e3:.2f} us, "
              f"per-transpose {per_tpose * 1e3:.2f} us, cross-tile stages "
              f"{cross_tile}; PROJECTION full bitonic ~{est:.3f} ms vs "
              f"torch.sort {t_lib:.3f} ms -> {rec['verdict']}")
    return out


def time_joins(d, cap):
    """Each join core's host wall (median of 10 calls that end in the
    host copy of the pairs) and, profiled over 5 calls, the device time of
    its sorts, of the device-to-host copy and of the rest (shifts, fills,
    filtering), with the device idle share; and the filter + copy of the
    shift core's pairs on their own."""
    import torch
    from knoxdb_tpu_torch.exec import join as TJ
    from knoxdb_tpu_torch.types import JoinType

    def filtered(li, ri):
        keep = li != -2
        return torch.stack([li[keep], ri[keep]]).cpu().numpy()

    calls = {
        "unique keys32": lambda i: TJ.join_pairs_device(
            d["lk"], d["rku"], JoinType.INNER, unique_build=True,
            keys32=True),
        "shift INNER": lambda i: TJ.join_pairs_device(d["lk"], d["rk"]),
        "shift INNER keys32": lambda i: TJ.join_pairs_device(
            d["lk"], d["rk"], keys32=True),
        "shift LEFT": lambda i: TJ.join_pairs_device(d["lk"], d["rk"],
                                                     JoinType.LEFT),
        "general (join_pairs_core)": lambda i: filtered(
            *TJ.join_pairs_core(d["lk"], d["rk"], cap)[:2]),
        "wide-run fallback": lambda i: TJ.join_pairs_device(d["lk"],
                                                           d["rkw"]),
        "join_count_device": lambda i: int(TJ.join_count_device(d["lk"],
                                                                d["rk"])),
    }
    out = {}
    for name, fn in calls.items():
        out[name] = {"wall_ms": _wall_ms(fn, iters=10, warmup=2),
                     "profile": _profile(fn, n=5)}
        print(f"phase 5 join {name}: wall {out[name]['wall_ms']:.3f} ms; "
              f"profiled: {out[name]['profile']}")
    li, ri, _, _ = TJ.join_pairs_core_shift(d["lk"], d["rk"])
    torch.cuda.synchronize()
    npairs = int((li != -2).sum())
    out["shift filter + D2H"] = {
        "wall_ms": _wall_ms(lambda i: filtered(li, ri), iters=10),
        "bytes": npairs * 8, "candidates": li.numel()}
    print(f"phase 5 join shift filter + D2H alone: "
          f"{out['shift filter + D2H']}")
    return out


def run_path(call):
    """Drive one main path with every launch counter at 0 just before it;
    returns its result and the counters just after."""
    import torch
    from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK
    from knoxdb_tpu_torch.ops import group_kernels as GK
    from knoxdb_tpu_torch.ops import scan_kernels as SK
    from knoxdb_tpu_torch.ops import sort_kernels as S8
    for mod in (SK, GK, S8, GCK):
        mod.reset_counts()
    out = call()
    torch.cuda.synchronize()
    return out, {**SK.LAUNCHES, **GK.LAUNCHES, **S8.LAUNCHES, **GCK.LAUNCHES}


def need(launches, names, what):
    if not all(launches[k] > 0 for k in names):
        raise AssertionError(f"{what}: a kernel of the path never "
                             f"launched: {launches}")


def phase_materialize(sc, sch, data):
    """scan(project=) and scan_stream of ~1% of the rows: every passing
    row's id and values against numpy."""
    mat_lo, mat_hi, mat_cols = 1000, 1000 + 655, ["val", "bal"]
    (mat, mat_stream), mat_launches = run_path(lambda: (
        sc.scan(_mat_tree(sch, mat_lo), [], project=mat_cols),
        list(sc.scan_stream(_mat_tree(sch, mat_lo), mat_cols))))
    need(mat_launches, ("fused_tree_agg",), "materialization")
    rows = np.flatnonzero((data["val"] >= mat_lo) & (data["val"] <= mat_hi))
    for what, ids, vals in (
            ("scan(project=)", mat.row_ids, mat.rows),
            ("scan_stream", np.concatenate([b.row_ids for b in mat_stream]),
             {c: np.concatenate([b.rows[c] for b in mat_stream])
              for c in mat_cols})):
        if not (np.array_equal(ids, rows.astype(np.uint64))
                and all(np.array_equal(vals[c], data[c][rows])
                        for c in mat_cols)):
            raise AssertionError(f"materialization {what}: rows differ "
                                 f"from numpy")
    print(f"phase 4 main path materialization: val RANGE ({mat_lo}, "
          f"{mat_hi}) on the config1 segment, {len(rows)} rows "
          f"({100 * len(rows) / len(data['val']):.2f}%), scan(project=val, "
          f"bal) and scan_stream ({len(mat_stream)} windows of 64 packs): "
          f"row ids and values exact vs numpy; launches {mat_launches}")
    return mat_lo, mat_cols


def phase_sort_probe(dev, lk, rk):
    """Kernel #8 on the config #5 join's merged (key, tagged id) operands,
    at the probe's N = 2,097,152 and at the join's M: every column sorted
    and bit-identical to the plain version."""
    from knoxdb_tpu_torch.ops import sort_kernels as S8
    kops, pops = _merged_operands(lk, rk, dev)
    M5 = kops.shape[0]
    probe_ns = tuple(sorted({min(32 * S8.TILE, M5), M5}))
    sorted_, sort_launches = run_path(
        lambda: [S8.tile_bitonic_sort(kops[:n], pops[:n]) for n in probe_ns])
    need(sort_launches, ("tile_bitonic_sort",), "sort probe")
    sort_err = 0
    for n, (ko, po) in zip(probe_ns, sorted_):
        sort_err = max(sort_err, _max_err(
            (ko, po), S8.tile_bitonic_sort_torch(kops[:n], pops[:n])))
        kv = (ko ^ (-(1 << 31))).view(-1, S8.R, S8.C)
        if not bool((kv[:, 1:] >= kv[:, :-1]).all()):
            raise AssertionError(f"sort probe N={n}: a column is unsorted")
    if sort_err:
        raise AssertionError(f"tile_bitonic_sort on the join's merged "
                             f"operands: max abs err {sort_err}")
    print(f"phase 4 main path config5 sort probe: kernel #8 on the join's "
          f"merged (key, tagged id) operands at N = {probe_ns[0]} and "
          f"M = {M5}: every column sorted, bit-identical to the plain "
          f"version; launches {sort_launches}")
    return kops, pops, probe_ns, sort_err, sort_launches


def phase_tx_join(dev, lk, rku):
    """tx ⋈ accounts from segments, with no filter and with amount > 0."""
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner

    nl = len(lk)
    (tx_s, tx, seg_tx), (ac_s, ac, seg_ac), t_build5 = \
        _txacct_segments(lk, rku)
    sc_tx = SegmentScanner(DeviceSegment(seg_tx, dev))
    sc_ac = SegmentScanner(DeviceSegment(seg_ac, dev))
    tx_tree = _gt_tree(tx_s, "amount", 0)
    for name, tree, m in (("no filter", None, np.ones(nl, bool)),
                          ("amount > 0", tx_tree, tx["amount"] > 0)):
        got, launches = run_path(lambda: _tx_join(sc_tx, sc_ac, tree))
        need(launches, ("fused_tree_agg",), f"tx join {name}")
        npairs = _tx_join_check(f"tx join {name}", got, tx, ac, m)
        print(f"phase 4 main path tx join accounts ({name}): {nl} x {nl} "
              f"rows, host build {t_build5:.2f} s; join_side (mask, "
              f"group_decode_keys, mask_to_indexes, take) -> "
              f"join_pairs_device(unique_build) -> scan(project=) over "
              f"include bitsets: {npairs} pairs, amount and bal exact vs "
              f"numpy; launches {launches}")
    return sc_tx, sc_ac, tx_tree

# ------------------------------------- config #2 and config #4 (top-k) ---

def _cfg2_segment():
    """BASELINE config #2 (bench_suite.py:55-95, seed 0xC0FFEE) at 256
    packs, with one more column drawn after the source's: fee u64, zero in
    every pack whose index is a multiple of 4 and uniform in [0, 2^20)
    elsewhere, so that it splits into a CONST and a BITPACK group. `ai`
    keeps each row's account number for the oracle."""
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType

    rng = np.random.default_rng(GROUP_SEED)
    n = PACK_SIZE * N_PACKS
    sch = (Builder("c2").pk("id")
           .add("val", FieldType.UINT64)
           .add("acct", FieldType.BYTES)
           .add("bal", FieldType.INT64)
           .add("fee", FieldType.UINT64)
           .finish())
    accts = np.array([b"acct-%03d" % i for i in range(64)], object)
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "val": rng.integers(0, 1 << 16, n, dtype=np.uint64)}
    ai = rng.integers(0, 64, n)
    data["acct"] = accts[ai]
    data["bal"] = rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64)
    fee = rng.integers(0, 1 << 20, n, dtype=np.uint64)
    fee[(np.arange(n) // PACK_SIZE) % 4 == 0] = 0
    data["fee"] = fee
    t0 = time.perf_counter()
    seg = build_segment(sch, data, pack_size=PACK_SIZE)
    data["ai"] = ai
    return sch, data, seg, time.perf_counter() - t0


def _isum(a) -> int:
    """Exact python-int sum of an integer array (split at 32 bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        return (int((a >> np.uint64(32)).sum(dtype=np.uint64)) << 32) \
            + int((a & np.uint64(0xFFFFFFFF)).sum(dtype=np.uint64))
    return (int((a >> 32).sum(dtype=np.int64)) << 32) \
        + int((a & 0xFFFFFFFF).sum(dtype=np.int64))


def _cfg2_queries(sch, n):
    """name -> (tree(k), aggs, oracle mask(data, k), kernels that must
    launch); k = 0 or 1 shifts a literal so that timed calls alternate."""
    from knoxdb_tpu_torch.exec.scan import AggSpec
    from knoxdb_tpu_torch.query.filter import Filter, and_, leaf, or_
    from knoxdb_tpu_torch.types import FilterMode as FM

    def lf(name, mode, v):
        return leaf(Filter(sch.field(name), mode, v))

    acct = b"acct-042"
    cnt, sm = AggSpec("count"), AggSpec
    return {
        "source AND": (
            lambda k: and_(lf("val", FM.RANGE, (1000 + k, 50000)),
                           lf("acct", FM.EQ, acct),
                           lf("bal", FM.GT, 0)).optimize(),
            [cnt, sm("sum", "bal")],
            lambda d, k: ((d["val"] >= 1000 + k) & (d["val"] <= 50000)
                          & (d["ai"] == 42) & (d["bal"] > 0)),
            ("fused_tree_agg",)),
        "OR subtree": (
            lambda k: and_(or_(lf("val", FM.RANGE, (1000 + k, 50000)),
                               lf("bal", FM.LT, -(1 << 39))),
                           lf("acct", FM.EQ, acct)).optimize(),
            [cnt, sm("sum", "bal")],
            lambda d, k: ((((d["val"] >= 1000 + k) & (d["val"] <= 50000))
                           | (d["bal"] < -(1 << 39))) & (d["ai"] == 42)),
            ("fused_tree_agg", "range_mask_count")),
        "fee RANGE": (
            lambda k: lf("fee", FM.RANGE, (1000 + k, 500000)).optimize(),
            [cnt, sm("sum", "fee"), sm("sum", "id"), sm("min", "id"),
             sm("max", "id")],
            lambda d, k: (d["fee"] >= 1000 + k) & (d["fee"] <= 500000),
            ("fused_tree_agg", "range_mask_count",
             "masked_plane_popcounts")),
        "id RANGE": (
            lambda k: lf("id", FM.RANGE, (n // 4 + k, n // 2)).optimize(),
            [cnt, sm("sum", "val")],
            lambda d, k: (d["id"] >= n // 4 + k) & (d["id"] <= n // 2),
            ("fused_tree_agg",)),
    }


def phase_config2(dev):
    """Config #2's source query and the unfused-path queries, each exact
    against numpy with its kernels' launch counters above 0."""
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner

    sch, data, seg, t_build = _cfg2_segment()
    n = seg.nrows_total
    sc = SegmentScanner(DeviceSegment(seg, dev))
    queries = _cfg2_queries(sch, n)
    launches_of = {}
    for name, (mk, aggs, oracle, kernels) in queries.items():
        res, launches = run_path(lambda: sc.scan(mk(0), aggs))
        need(launches, kernels, f"config2 {name}")
        m = oracle(data, 0)
        want = {}
        for a in aggs:
            col = data[a.field][m] if a.field else None
            want[(a.op, a.field)] = (
                int(m.sum()) if a.op == "count" else _isum(col)
                if a.op == "sum" else int(getattr(col, a.op)()))
        if res.count != int(m.sum()) or res.aggs != want:
            raise AssertionError(f"config2 {name}: {res.count} {res.aggs} "
                                 f"!= {want}")
        launches_of[name] = launches
        print(f"phase 4 main path config2 {name}: {n} rows, count="
              f"{res.count} aggs={res.aggs}; exact vs numpy; launches "
              f"{launches}")
    schemes = {f: [(g.scheme.name, g.width, g.npacks)
                   for g in sc.d.column(f).groups]
               for f in ("id", "val", "acct", "bal", "fee")}
    if [g[0] for g in schemes["fee"]] != ["CONST", "BITPACK"] \
            or schemes["id"][0][0] != "DELTA":
        raise AssertionError(f"config2 schemes: {schemes}")
    # the DELTA projection: scan(project=id, val) of ~1% of the rows
    lo = 1000
    res, launches = run_path(lambda: sc.scan(
        _mat_tree(sch, lo), [], project=["id", "val"]))
    need(launches, ("fused_tree_agg",), "config2 projection")
    rows = np.flatnonzero((data["val"] >= lo) & (data["val"] <= lo + 655))
    if not (np.array_equal(res.row_ids, rows.astype(np.uint64))
            and np.array_equal(res.rows["id"], data["id"][rows])
            and np.array_equal(res.rows["val"], data["val"][rows])):
        raise AssertionError("config2 scan(project=id, val): rows differ")
    print(f"phase 4 main path config2 scan(project=id, val): val RANGE "
          f"({lo}, {lo + 655}), {len(rows)} rows, ids (DELTA) and values "
          f"exact vs numpy; host build {t_build:.2f} s; column groups "
          f"{schemes}; launches {launches}")
    return sc, sch, queries, launches_of


def _cfg4_segment():
    """BASELINE config #4 (bench_suite.py:243-300, seed 0xC0FFEE) at 256
    packs (its default 64 x 4): big INT128 = block * 2^70 + (x << 9) with x
    uniform in +-2^50 and block the pack index, val u64 in [0, 2^16), the
    sequential pk. The source builds big from 16.8 M python ints and
    encodes it row by row (minutes on one host core); here the same values
    go from (block, x) to the same packs with numpy: per pack the wide
    base as a python int and the pack-relative keys as u64, as
    pack/segment._encode_wide gives them."""
    from knoxdb_tpu_torch.encode import schemes as S
    from knoxdb_tpu_torch.encode import select as sel
    from knoxdb_tpu_torch.pack.segment import (EncodedColumn, Segment,
                                                build_segment)
    from knoxdb_tpu_torch.pack.stats import FieldStats
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType

    rng = np.random.default_rng(GROUP_SEED)
    n = PACK_SIZE * N_PACKS
    x = rng.integers(-1 << 50, 1 << 50, n)
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "val": rng.integers(0, 1 << 16, n, dtype=np.uint64), "x": x}
    sch = (Builder("c4").pk("id").add("big", FieldType.INT128)
           .add("val", FieldType.UINT64).finish())
    narrow = (Builder("c4n").pk("id").add("val", FieldType.UINT64).finish())
    t0 = time.perf_counter()
    seg_n = build_segment(narrow, {k: data[k] for k in ("id", "val")},
                          pack_size=PACK_SIZE)
    packs, bases, mins, maxs = [], [], [], []
    low = (x << 9).reshape(N_PACKS, PACK_SIZE)
    for b in range(N_PACKS):
        mn, mx = int(low[b].min()), int(low[b].max())
        rel = (low[b] - mn).astype(np.uint64)
        w = sel.round_width((mx - mn).bit_length())
        packs.append(S.encode_bitpack(rel, 4, 0, w, PACK_SIZE))
        bases.append(b * (1 << 70) + mn + (1 << 127))      # keyform
        mins.append(bases[-1])
        maxs.append(bases[-1] + mx - mn)
    cols = dict(seg_n.columns)
    cols["big"] = EncodedColumn(sch.field("big"), packs, wide=True,
                                wide_bases=bases)
    for name in ("id", "val"):
        cols[name] = EncodedColumn(sch.field(name), cols[name].packs,
                                   wide=False)
    stats = seg_n.stats
    stats.fields["big"] = FieldStats(np.array(mins, object),
                                     np.array(maxs, object))
    seg = Segment(sch, PACK_SIZE, n, seg_n.nrows, cols, stats)
    return sch, data, seg, time.perf_counter() - t0


def _cfg4_oracle(data, m, field, k=100):
    """The k largest keyform keys of `field` over rows m, descending, and
    for checking a returned row: its keyform key."""
    rows = np.flatnonzero(m)
    if field == "big":
        block, x = rows // PACK_SIZE, data["x"][rows]
        top = rows[np.lexsort((x, block))[::-1][:k]]
    else:
        top = rows[np.argsort(data[field][rows], kind="stable")[::-1][:k]]
    return [_cfg4_key(data, field, int(r)) for r in top]


def _cfg4_key(data, field, r: int) -> int:
    if field == "big":
        return (r // PACK_SIZE) * (1 << 70) + (int(data["x"][r]) << 9) \
            + (1 << 127)
    return int(data[field][r])


def phase_config4(dev):
    """segment_topk(val LT 50000, order, 100, desc, project=id) ordered by
    big and by val (the bit descent) and by id (the fallback): the keys
    equal the sorted numpy answer, and every returned row carries its key,
    passes the filter, is returned once and projects its own id."""
    from knoxdb_tpu_torch.exec import sort as TS
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner

    sch, data, seg, t_build = _cfg4_segment()
    sc = SegmentScanner(DeviceSegment(seg, dev))
    m = data["val"] < 50000

    def tree(k=0):
        from knoxdb_tpu_torch.query.filter import Filter, leaf
        from knoxdb_tpu_torch.types import FilterMode
        return leaf(Filter(sch.field("val"), FilterMode.LT,
                           50000 - k)).optimize()

    for field in ("big", "val", "id"):
        fast = TS._topk_fast_plan(sc.d, seg.columns[field], field)
        if (fast is None) != (field == "id"):
            raise AssertionError(f"config4 {field}: route {fast is None}")
        (keys, rows, nv), launches = run_path(lambda: TS.segment_topk(
            sc, tree(), field, 100, desc=True, project=["id"]))
        need(launches, ("fused_tree_agg",), f"config4 top-k by {field}")
        want = _cfg4_oracle(data, m, field)
        idx = rows["__idx"].astype(np.int64)
        ids = (rows["id"][0].astype(np.uint64) << np.uint64(32)) \
            | rows["id"][1].astype(np.uint64)
        if not (keys == want and nv == 100 and len(set(idx.tolist())) == 100
                and m[idx].all() and np.array_equal(ids, data["id"][idx])
                and [_cfg4_key(data, field, int(r)) for r in idx] == keys):
            raise AssertionError(f"config4 top-100 by {field}: keys or ids "
                                 f"differ from numpy: {keys[:3]} {want[:3]}")
        print(f"phase 4 main path config4 segment_topk by {field} "
              f"({'fallback sort' if fast is None else f'bit descent, {fast[0]} planes'}"
              f"): {seg.nrows_total} rows, {int(m.sum())} pass val LT 50000, "
              f"top 100 desc: keys and ids exact vs numpy (first key "
              f"{keys[0]}); host build {t_build:.2f} s; launches {launches}")
    # a RANGE leaf over the wide column with count and sum(big): the bounds
    # relate to each pack's python-int base on the host, the ladder and
    # the popcount kernel run on the 64 pack-relative planes
    from knoxdb_tpu_torch.exec.scan import AggSpec
    from knoxdb_tpu_torch.query.filter import Filter, leaf
    from knoxdb_tpu_torch.types import FilterMode
    b_lo, b_hi = N_PACKS // 4, 3 * N_PACKS // 4 - 1

    def big_tree(k=0):
        return leaf(Filter(sch.field("big"), FilterMode.RANGE,
                           (b_lo << 70, (b_hi << 70) - k))).optimize()

    big_aggs = [AggSpec("count"), AggSpec("sum", "big")]
    res, launches = run_path(lambda: sc.scan(big_tree(), big_aggs))
    need(launches, ("range_mask_count", "masked_plane_popcounts"),
         "config4 big RANGE")
    block, x = np.arange(seg.nrows_total) // PACK_SIZE, data["x"]
    mb = ((block > b_lo) & (block < b_hi)) | ((block == b_lo) & (x >= 0)) \
        | ((block == b_hi) & (x <= 0))
    want = {("count", ""): int(mb.sum()),
            ("sum", "big"): (_isum(block[mb]) << 70) + (_isum(x[mb]) << 9)}
    if res.count != int(mb.sum()) or res.aggs != want:
        raise AssertionError(f"config4 big RANGE: {res.count} {res.aggs} != "
                             f"{want}")
    print(f"phase 4 main path config4 scan(big RANGE ({b_lo} * 2^70, {b_hi} "
          f"* 2^70), count, sum(big)) over the wide BITPACK column: count="
          f"{res.count} sum={res.aggs[('sum', 'big')]}; exact vs python "
          f"ints; launches {launches}")
    return sc, tree, (big_tree, big_aggs)


def _split_need(name, args):
    """Bytes the split kernel must move for these operands (every plane
    once, the mask in where there is one, the mask out for 5a) and its
    word operations (the ladder's 8, the popcount's 2 per plane word)."""
    planes = args[0]
    mask = args[4] if name == "range_mask_count" else args[1]
    mw = planes.shape[1] * planes.shape[2] * 4
    nbytes = planes.numel() * 4 + (mw if mask is not None else 0) \
        + (mw if name == "range_mask_count" else 0)
    nops = (8 if name == "range_mask_count" else 2) * planes.numel()
    return nbytes, nops


def time_split_kernels(var1, path_ops, launches, stream, flush):
    """Kernels 5a and 5b. First on every set of operands that the main
    paths handed them (path_ops: name -> [(query, args), ...]): kernel
    = plain bit for bit, then warm, L2-flushed and plain times and the
    bound from those operands; each kernel's record carries the numbers of
    its first set and lists the others. Then on config #1's val planes
    beside the one-leaf kernel, and all three at the permuted view of a
    pack-major copy of the same planes. var1: the operands the main path
    gave fused_range_sum_masked. Returns the records and the layout
    table."""
    import torch
    from knoxdb_tpu_torch.ops import scan_kernels as SK

    plain_of = {"range_mask_count": SK.range_mask_count_torch,
                "masked_plane_popcounts": SK.masked_plane_popcounts_torch}
    records = {}
    for name, sets in path_ops.items():
        kf, ref = getattr(SK, name), plain_of[name]
        at = []
        for query, args in sets:
            err = _max_err(kf(*args), ref(*args))
            if err:
                raise AssertionError(f"{name} on the operands of {query}: "
                                     f"max abs err {err}")
            nbytes, nops = _split_need(name, args)
            bound_ms, bound_by = _bound(nbytes, nops)
            ms = _event_ms(lambda i: kf(*args))
            fl = _event_ms(lambda i: kf(*args),
                           before=lambda i: flush.fill_(i))
            mask = args[4] if name == "range_mask_count" else args[1]
            at.append({
                "query": query,
                "planes": list(args[0].shape), "mask_in": mask is not None,
                "max_abs_err": err, "ms": ms, "ms_l2_flushed": fl,
                "plain_ms": _event_ms(lambda i: ref(*args), iters=20),
                "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_stream_ms": nbytes / stream * 1e3,
                "pct_of_stream_bw": 100.0 * nbytes / (ms / 1e3) / stream,
                "pct_of_stream_bw_l2_flushed":
                    100.0 * nbytes / (fl / 1e3) / stream})
        records[name] = {
            "name": name, "route": "cuda", "source": _SOURCES[name],
            "replaces": _REPLACES[name], "launches": launches[name],
            **at[0], "library_ms": None, "other_operands": at[1:]}
        print(f"phase 5 {name} on its main paths' operands, kernel = "
              f"plain bit for bit; ms warm / L2 flushed / plain / bound: "
              + "; ".join(
                  f"{r['query']} planes {r['planes']}"
                  f"{' under a mask' if r['mask_in'] else ''}: "
                  f"{r['ms']:.4f} / {r['ms_l2_flushed']:.4f} / "
                  f"{r['plain_ms']:.4f} / {r['bound_ms']:.4f}" for r in at))

    planes, lo_b, hi_b, flags, mask_in, width = var1
    pk = planes.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    mask, _cnt = SK.range_mask_count(planes, lo_b, hi_b, flags, mask_in,
                                     width)
    torch.cuda.synchronize()
    calls = {
        "fused_range_sum_masked": (
            lambda p: SK.fused_range_sum_masked(p, lo_b, hi_b, flags,
                                                mask_in, width),
            lambda: SK.fused_range_sum_masked_torch(planes, lo_b, hi_b,
                                                    flags, mask_in, width)),
        "range_mask_count": (
            lambda p: SK.range_mask_count(p, lo_b, hi_b, flags, mask_in,
                                          width),
            lambda: SK.range_mask_count_torch(planes, lo_b, hi_b, flags,
                                              mask_in, width)),
        "masked_plane_popcounts": (
            lambda p: SK.masked_plane_popcounts(p, mask, width),
            lambda: SK.masked_plane_popcounts_torch(planes, mask, width)),
    }
    layouts = {}
    for name, (kf, ref) in calls.items():
        err = max(_max_err(kf(planes), ref()), _max_err(kf(pk), ref()))
        if err:
            raise AssertionError(f"{name} on config1's val planes: {err}")
        t = {"plane_major_ms": _event_ms(lambda i: kf(planes)),
             "pack_major_ms": _event_ms(lambda i: kf(pk)),
             "plane_major_l2_flushed_ms": _event_ms(
                 lambda i: kf(planes), before=lambda i: flush.fill_(i)),
             "pack_major_l2_flushed_ms": _event_ms(
                 lambda i: kf(pk), before=lambda i: flush.fill_(i))}
        layouts[name] = t
        if name in records:
            records[name]["on_config1_val_planes"] = {
                **t, "plain_ms": _event_ms(lambda i: ref(), iters=20)}
    print("phase 5 split kernels on config1's val planes under its mask, ms "
          "plane-major / pack-major view (L2 flushed: the same): "
          + "; ".join(
              f"{k}: {v['plane_major_ms']:.4f} / {v['pack_major_ms']:.4f} "
              f"({v['plane_major_l2_flushed_ms']:.4f} / "
              f"{v['pack_major_l2_flushed_ms']:.4f})"
              for k, v in layouts.items())
          + "; plain: " + ", ".join(
              f"{k} {r['on_config1_val_planes']['plain_ms']:.4f}"
              for k, r in records.items()))
    return list(records.values()), layouts


def time_config2(sc2, sch2, queries2):
    """Wall (median of 20 calls alternating two literals) and profiled
    device time, idle share and device operations per call of every
    config #2 query, and of scan(project=id, val)."""
    out = {}
    for name, (mk, aggs, _oracle, _k) in queries2.items():
        fn = lambda i, mk=mk, aggs=aggs: sc2.scan(mk(i % 2), aggs)  # noqa
        out[name] = {"wall_ms": _wall_ms(fn, iters=20),
                     "profile": _profile(fn, n=5)}
    fn = lambda i: sc2.scan(_mat_tree(sch2, 1000 + i % 2), [],      # noqa
                            project=["id", "val"])
    out["project id, val"] = {"wall_ms": _wall_ms(fn, iters=10),
                              "profile": _profile(fn, n=5)}
    for name, r in out.items():
        print(f"phase 5 config2 {name}: wall {r['wall_ms']:.3f} ms; "
              f"profiled: {r['profile']}")
    return out


def time_delta_decode(sc2):
    """The DELTA pk's decode at [256, 65,536]: the bit transpose, the
    row-wise int64 prefix sum alone, and the whole group decode."""
    import torch
    from knoxdb_tpu_torch.encode import schemes as S
    from knoxdb_tpu_torch.exec import device as D

    g = sc2.d.column("id").groups[0]
    zz = S.decode_bitplanes_u64(g.arrays["planes"], g.width)
    torch.cuda.synchronize()
    out = {"width": g.width, "npacks": g.npacks,
           "transpose_ms": _event_ms(lambda i: S.decode_bitplanes_u64(
               g.arrays["planes"], g.width), iters=20),
           "cumsum_ms": _event_ms(lambda i: torch.cumsum(zz, dim=-1),
                                  iters=20),
           "group_decode_halves_ms": _event_ms(
               lambda i: D.group_decode_halves(g, sc2.d.W), iters=20)}
    print(f"phase 5 DELTA decode of id: {out}")
    return out


def time_topk(sc4, tree4):
    """Config #4's top-k: wall of the whole call by big, val and id, the
    profiled window (device time, idle share, device operations per call),
    and for the bit descent by big the device time of each stage alone."""
    import torch
    from knoxdb_tpu_torch.exec import sort as TS
    from knoxdb_tpu_torch.ops import bitslice as B
    from knoxdb_tpu_torch.ops import compact as CP

    d = sc4.d
    out = {}
    for field in ("big", "val", "id"):
        fn = lambda i, f=field: TS.segment_topk(                    # noqa
            sc4, tree4(i % 2), f, 100, desc=True, project=["id"])
        out[field] = {"wall_ms": _wall_ms(fn, iters=10, warmup=2),
                      "profile": _profile(fn, n=5)}
        print(f"phase 5 config4 top-k by {field}: wall "
              f"{out[field]['wall_ms']:.3f} ms "
              f"({d.P * d.N / out[field]['wall_ms'] / 1e6:.2f} G rows/s); "
              f"profiled: {out[field]['profile']}")
    wo, cb_np, _gmin = sc4._fns[("topk-fastplan", "big")]
    cb = sc4._fns[("topk-cb", "big")]
    planes = d.column("big").groups[0].arrays["planes"]
    mask_fn, margs = sc4.prepare(tree4(0), [])
    mask = mask_fn(*margs)[0]
    absp = B.add_const_planes(planes, cb, wo)
    _tw, better, tie, _nb = B.topk_select(absp, mask, 100, wo, True)
    torch.cuda.synchronize()

    def gathers(i):
        bi, _ = CP.first_k_indexes(better, 128)
        ti, _ = CP.first_k_indexes(tie, 128)
        idx = torch.cat([bi, ti])
        return CP.gather_plane_values(absp, idx, d.N), idx

    idx = gathers(0)[1]
    out["stages_big"] = {
        "planes_out": wo, "absp_bytes": absp.numel() * 4,
        "mask_ms": _event_ms(lambda i: mask_fn(*margs), iters=20),
        "add_const_planes_ms": _event_ms(
            lambda i: B.add_const_planes(planes, cb, wo), iters=20),
        "topk_select_ms": _event_ms(
            lambda i: B.topk_select(absp, mask, 100, wo, True), iters=20),
        "topk_select_wall_ms": _wall_ms(lambda i: int(B.topk_select(
            absp, mask, 100, wo, True)[3]), iters=20),
        "gathers_ms": _event_ms(gathers, iters=20),
        "project_id_ms": _event_ms(
            lambda i: TS._flat_limbs(sc4, "id")[:, idx.long()], iters=20)}
    print(f"phase 5 config4 top-k by big, stages: {out['stages_big']}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {card} (torch: {kind}, {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device)")

    from knoxdb_tpu_torch.exec import device as D
    from knoxdb_tpu_torch.exec import groupby as GB
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner
    from knoxdb_tpu_torch.ops import cuda_build
    from knoxdb_tpu_torch.ops import group_kernels as GK
    from knoxdb_tpu_torch.ops import scan_kernels as SK

    t0 = time.perf_counter()
    cuda_build.load()
    ptxas = [ln.strip() for ln in cuda_build.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln or ln.startswith("[")]
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_build.build_info['seconds']:.2f} s, one process per "
          f"source) -> {cuda_build.build_info['library']}")
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    phase_kernels_vs_plain(dev)
    phase_split_kernels_vs_plain(dev)
    phase_group_kernels_vs_plain(dev)
    phase_chunk_kernel_vs_plain(dev)
    phase_sort_kernel_vs_plain(dev)
    _mark("phase 3")

    # ---- phase 4: the main paths ----
    sch, data, seg, t_build = _bench_segment()
    t0 = time.perf_counter()
    sc = SegmentScanner(DeviceSegment(seg, dev))
    queries = _queries(sch)
    n_rows = PACK_SIZE * N_PACKS
    results, scan_launches = run_path(
        lambda: {name: sc.scan(mk(1000), aggs)
                 for name, (mk, aggs) in queries.items()})
    t_path = time.perf_counter() - t0
    for name, res in results.items():
        count, want = _oracle(data, name, 1000)
        if res.count != count or res.aggs != want:
            raise AssertionError(f"{name}: {res.count} {res.aggs} != "
                                 f"{count} {want}")
    need(scan_launches, ("fused_range_sum_masked", "fused_tree_agg"), "scan")
    print(f"phase 4 main path scan: {n_rows} rows in {N_PACKS} packs, host "
          f"build {t_build:.2f} s, upload + first scans {t_path:.2f} s; "
          + "; ".join(f"{n}: count={r.count} aggs={r.aggs}"
                      for n, r in results.items())
          + f"; exact vs numpy oracle; launches {scan_launches}")

    mat_lo, mat_cols = phase_materialize(sc, sch, data)
    _mark("scan and materialization")

    sch3, data3, seg3, t_build3 = _cfg3_segment(N_PACKS, G3)
    sc3 = SegmentScanner(DeviceSegment(seg3, dev))
    group_launches = {}
    for minmax in (False, True):
        t0 = time.perf_counter()
        out, launches = run_path(lambda: sc3.group_scan(
            _gt_tree(sch3, "bal", THR3), "acct", ["bal"], minmax=minmax))
        t_first = time.perf_counter() - t0
        need(launches, ("fused_tree_agg",)
             + (() if minmax else ("fused_group_partials",)),
             f"config3 minmax={minmax}")
        if not minmax:
            group_launches = launches
        nsel = _cfg3_check(f"config3 minmax={minmax}", data3, THR3, out,
                           minmax)
        print(f"phase 4 main path config3 group_scan(minmax={minmax}): "
              f"{seg3.nrows_total} rows, G={out[0].G}, {nsel} rows pass the "
              f"filter, "
              f"host build {t_build3:.2f} s, first call {t_first:.2f} s; "
              f"every count, sum{', min and max' if minmax else ''} exact vs "
              f"numpy; launches {launches}")

    sch3c, data3c, seg3c, t_build3c = _cfg3_segment(PACKS_SMALL, 1 << 16)
    sc3c = SegmentScanner(DeviceSegment(seg3c, dev))
    out, launches = run_path(lambda: sc3c.group_scan(
        _gt_tree(sch3c, "bal", THR3), "acct", ["bal"], minmax=False))
    need(launches, ("fused_tree_agg", "fused_group_partials"), "config3c")
    nsel = _cfg3_check("config3c", data3c, THR3, out, False)
    print(f"phase 4 main path config3c group_scan(minmax=False): "
          f"{seg3c.nrows_total} rows, G={out[0].G}, {nsel} rows pass, host build "
          f"{t_build3c:.2f} s; every count and sum exact; launches {launches}")

    sch6, data6, seg6, t_build6 = _cfg6_segment(PACKS_SMALL)
    sc6 = SegmentScanner(DeviceSegment(seg6, dev))
    plans6 = [GB.plan_buckets(sc6.d, "ts", T6 + k, IV6, G6) for k in (0, 1)]
    kinds6 = {"val": ("moments",)}
    out6, series_launches = run_path(
        lambda: sc6.series_scan(None, "ts", kinds6, plans6[0]))
    need(series_launches, ("fused_tree_agg", "fused_group_moments_partials"),
         "config6")
    nsel = _cfg6_check(data6, out6)
    print(f"phase 4 main path config6 series_scan moments: "
          f"{seg6.nrows_total} rows, {G6} buckets of {IV6} "
          f"({plans6[0].mode[0][0]}), {nsel} rows bucketed, host build "
          f"{t_build6:.2f} s; counts exact, sums and sums of squares equal "
          f"to the exact python-int sums cast to f64; launches "
          f"{series_launches}")

    routes = {
        "config3": phase_chunk_route("config3", sc3, sch3, data3, 1),
        "config3c": phase_chunk_route("config3c", sc3c, sch3c, data3c, 8)}
    float_calls = phase_floats(dev)
    _mark("group-by, series, the chunk route and floats")

    # ---- phase 4: config #2 (unfused leaves and sums, every scheme of
    # its columns) and config #4 (ordered top-k) ----
    sc2, sch2, queries2, launches2 = phase_config2(dev)
    _mark("config #2")
    sc4, tree4, big_query4 = phase_config4(dev)
    _mark("config #4 top-k")

    # ---- phase 4: config #5 joins, the sort probe, tx ⋈ accounts ----
    jd, jcap, jpairs, keys5 = phase_joins(dev, NL5)
    lk, rk, rku = keys5
    kops, pops, probe_ns, sort_err, sort_launches = \
        phase_sort_probe(dev, lk, rk)
    sc_tx, sc_ac, tx_tree = phase_tx_join(dev, lk, rku)
    _mark("joins, sort probe, tx join")

    launches_by_kernel = {
        "fused_range_sum_masked": scan_launches["fused_range_sum_masked"],
        "fused_tree_agg": scan_launches["fused_tree_agg"],
        "fused_group_partials": group_launches["fused_group_partials"],
        "fused_group_moments_partials":
            series_launches["fused_group_moments_partials"],
        "tile_bitonic_sort": sort_launches["tile_bitonic_sort"],
        "range_mask_count": launches2["OR subtree"]["range_mask_count"],
        "masked_plane_popcounts":
            launches2["fee RANGE"]["masked_plane_popcounts"]}

    # ---- phase 5: timing at the main paths' shapes ----
    variants = {}
    for kname, qname in (("fused_range_sum_masked", "config1"),
                         ("fused_tree_agg", "entry")):
        mk, aggs = queries[qname]
        variants[kname] = [
            _capture(SK, kname, lambda lo=lo: sc.scan(mk(lo), aggs))
            for lo in (1000, 1001)]
    trees3 = [_gt_tree(sch3, "bal", THR3 + k) for k in (0, 1)]
    variants["fused_group_partials"] = [
        _capture(GK, "fused_group_partials",
                 lambda t=t: sc3.group_scan(t, "acct", ["bal"], minmax=False))
        for t in trees3]
    variants["fused_group_moments_partials"] = [
        _capture(GK, "fused_group_moments_partials",
                 lambda p=p: sc6.series_scan(None, "ts", kinds6, p))
        for p in plans6]
    plain = {"fused_range_sum_masked": SK.fused_range_sum_masked_torch,
             "fused_tree_agg": SK.fused_tree_agg_torch,
             "fused_group_partials": GK.fused_group_partials_torch,
             "fused_group_moments_partials":
                 GK.fused_group_moments_partials_torch}
    kern = {k: getattr(SK if k in SK.LAUNCHES else GK, k) for k in plain}
    query_of = {"fused_range_sum_masked": "config1",
                "fused_tree_agg": "entry", "fused_group_partials": "config3",
                "fused_group_moments_partials": "config6"}
    rows_of = {"config1": n_rows, "entry": n_rows,
               "config3": seg3.nrows_total, "config6": seg6.nrows_total}
    flush = torch.empty((128 << 20) // 4, dtype=torch.int32, device=dev)
    stream = _stream_bps(dev)
    records = []
    for kname, var in variants.items():
        kf, ref = kern[kname], plain[kname]
        err = max(_max_err(kf(*a), ref(*a)) for a in var)
        if err:
            raise AssertionError(f"{kname} at the main path's shapes: max "
                                 f"abs err {err}")
        ms = _event_ms(lambda i: kf(*var[i % 2]))
        plain_ms = _event_ms(lambda i: ref(*var[i % 2]))
        rec = {"name": kname, "route": "cuda", "source": _SOURCES[kname],
               "replaces": _REPLACES[kname],
               "launches": launches_by_kernel[kname], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "query": query_of[kname]}
        if kname in SK.LAUNCHES:
            rec["ms_l2_flushed"] = _event_ms(
                lambda i: kf(*var[i % 2]), before=lambda i: flush.fill_(i))
            if kname == "fused_range_sum_masked":
                planes, mask_in = [var[0][0]], var[0][4]
            else:
                planes, mask_in = var[0][0], var[0][3]
            # bytes the pass needs: every plane once, mask in, mask out
            nbytes = sum(p.numel() * 4 for p in planes) \
                + 2 * mask_in.numel() * 4
            rec["pct_of_stream_bw_l2_flushed"] = \
                100.0 * nbytes / (rec["ms_l2_flushed"] / 1e3) / stream
            # ~10 word operations per plane word (the ladder's 8 and the
            # popcount's 2); no single PyTorch call computes the function
            nops = 10 * sum(p.numel() for p in planes)
            rec["library_ms"] = None
        else:
            # gid and every value word once, the mask words, the output
            gid, words, *vals = var[0][:-1]
            G = var[0][-1]
            nbytes = (gid.numel() + words.numel()
                      + sum(v.numel() for v in vals)) * 4 \
                + (1 + len(vals)) * G * 8
            nops = gid.numel() * (2 + len(vals))
            # the library route: ONE index_add_ of the count and every
            # value half into int64[1 + 2K, G], its operands made outside
            # the timed window
            from knoxdb_tpu_torch.ops import bitset as BS
            from knoxdb_tpu_torch.ops import words as WD
            ok = BS.unpack_mask(words) & (gid >= 0) & (gid < G)
            src = torch.stack([ok.to(torch.int64)]
                              + [WD.u32_to_i64(v) * ok for v in vals]) \
                .reshape(1 + len(vals), -1)
            at = torch.where(ok, gid, 0).reshape(-1).long()
            rec["library_ms"] = _event_ms(
                lambda i: torch.zeros((src.shape[0], G), dtype=torch.int64,
                                      device=dev).index_add_(1, at, src),
                iters=20)
            del ok, src, at
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, nops)
        rec["bound_stream_ms"] = nbytes / stream * 1e3
        rows = rows_of[rec["query"]]
        rec.update(bytes=nbytes, rows_per_s=rows / (ms / 1e3),
                   pct_of_stream_bw=100.0 * nbytes / (ms / 1e3) / stream)
        records.append(rec)

    calls = {
        "config1": lambda i: sc.scan(queries["config1"][0](1000 + i % 2),
                                     queries["config1"][1]),
        "entry": lambda i: sc.scan(queries["entry"][0](1000 + i % 2),
                                   queries["entry"][1]),
        "config3": lambda i: sc3.group_scan(trees3[i % 2], "acct", ["bal"],
                                            minmax=False),
        "config3_minmax": lambda i: sc3.group_scan(trees3[i % 2], "acct",
                                                   ["bal"], minmax=True),
        "config6": lambda i: sc6.series_scan(None, "ts", kinds6,
                                             plans6[i % 2]),
    }
    walls = {q: _wall_ms(f, iters=20 if q == "config3_minmax" else ITERS)
             for q, f in calls.items()}
    for r in records:
        q = r["query"]
        r["call_ms"] = walls[q]
        r["call_rows_per_s"] = rows_of[q] / (walls[q] / 1e3)
    print(f"phase 5 timing: stream read {stream / 1e9:.1f} GB/s; "
          + "; ".join(f"{r['name']} ({r['query']}): kernel {r['ms']:.4f} ms"
                      + (f" (L2 flushed {r['ms_l2_flushed']:.4f})"
                         if "ms_l2_flushed" in r else "")
                      + f", plain {r['plain_ms']:.4f} ms, whole call "
                      f"{r['call_ms']:.3f} ms, "
                      f"{r['rows_per_s'] / 1e9:.1f} G rows/s kernel, "
                      f"{r['pct_of_stream_bw']:.0f}% of stream bw"
                      for r in records)
          + f"; group_scan(minmax=True) at config3 "
          f"{walls['config3_minmax']:.3f} ms")

    # stage breakdown of the group and series calls: device time of each
    # stage alone (events), the host combine, and a profiled window
    stages = {}
    for q, scn, gf, field, plan_of in (
            ("config3", sc3, "acct", "bal",
             lambda i: GB.plan_groups(sc3.d, "acct")),
            ("config6", sc6, "ts", "val", lambda i: plans6[i % 2])):
        tree = trees3[0] if q == "config3" else None
        mask_fn, margs = scn.prepare(tree, [], None)
        gplan = plan_of(0)
        tags = tuple(m[0] for m in gplan.mode)
        gc = GB.gid_consts(gplan, dev)
        groups = scn.d.column(gf).groups
        kname = ("fused_group_partials" if q == "config3"
                 else "fused_group_moments_partials")
        outs = kern[kname](*variants[kname][0])
        torch.cuda.synchronize()

        def combine():
            c = outs[0].cpu().numpy()
            return c, [GB.halves_sum(outs[j], outs[j + 1])
                       for j in range(1, len(outs), 2)]

        t_comb = []
        for _ in range(20):
            t0 = time.perf_counter()
            combine()
            t_comb.append(time.perf_counter() - t0)
        stages[q] = {
            "host_plan_ms": _wall_ms(lambda i: (plan_of(i),
                                                scn.prepare(tree, [], None)),
                                     iters=20),
            "mask_ms": _event_ms(lambda i: mask_fn(*margs)),
            "gid_ms": _event_ms(lambda i: GB.row_gids(
                tags, groups, gc, scn.d.P, scn.d.W)),
            "decode_ms": _event_ms(lambda i: scn._decode_rows(
                field, D.group_decode_halves)),
            "kernel_ms": next(r["ms"] for r in records if r["name"] == kname),
            "host_combine_ms": statistics.median(t_comb) * 1e3,
            "profile": _profile(calls[q]),
        }
        print(f"phase 5 stages {q}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in stages[q].items() if k != "profile")
            + f"; profiled: {stages[q]['profile']}")
    stages["config3_minmax"] = {"profile": _profile(calls["config3_minmax"])}
    print(f"phase 5 stages config3_minmax: profiled: "
          f"{stages['config3_minmax']['profile']}")

    # the operands the main paths hand 5a and 5b: every launch of config
    # #2's OR-subtree query and fee RANGE and of config #4's big RANGE
    path_ops = {"range_mask_count": [], "masked_plane_popcounts": []}
    q2 = {q: (lambda q=q: sc2.scan(queries2[q][0](0), queries2[q][1]))
          for q in ("OR subtree", "fee RANGE")}
    for kname, label, call in (
            ("range_mask_count", "config2 OR subtree", q2["OR subtree"]),
            ("range_mask_count", "config2 fee RANGE", q2["fee RANGE"]),
            ("masked_plane_popcounts", "config2 fee RANGE", q2["fee RANGE"]),
            *((k, "config4 big RANGE",
               lambda: sc4.scan(big_query4[0](), big_query4[1]))
              for k in path_ops)):
        path_ops[kname] += [(label, a)
                            for a in _capture(SK, kname, call, every=True)]
    nops5 = {k: [q for q, _a in v] for k, v in path_ops.items()}
    if [len(v) for v in nops5.values()] != [4, 2]:
        raise AssertionError(f"split-kernel launches of the paths: {nops5}")
    split_records, layouts = time_split_kernels(
        variants["fused_range_sum_masked"][0], path_ops, launches_by_kernel,
        stream, flush)
    records.extend(split_records)
    records.extend(time_chunk_kernels(routes, records,
                                      routes["config3c"]["ops"], stream,
                                      dev))
    stages["config6f"] = time_floats(float_calls)
    stages["layouts"] = layouts
    stages["config2"] = time_config2(sc2, sch2, queries2)
    stages["delta_decode"] = time_delta_decode(sc2)
    stages["config4"] = time_topk(sc4, tree4)
    fn = lambda i: sc4.scan(big_query4[0](i % 2), big_query4[1])    # noqa
    stages["config4"]["big RANGE"] = {"wall_ms": _wall_ms(fn, iters=20),
                                      "profile": _profile(fn, n=5)}
    print(f"phase 5 config4 scan(big RANGE, count, sum(big)): "
          f"{stages['config4']['big RANGE']}")
    _mark("phase 5 kernels, calls and stages")
    probe = time_sort_probe(kops, pops, probe_ns, stream)
    rec8 = probe[-1]
    records.append({
        "name": "tile_bitonic_sort", "route": "cuda",
        "source": "knoxdb_tpu_torch/csrc/sort_kernels.cu",
        "replaces": "probes/msort_probe.py:127",
        "launches": launches_by_kernel["tile_bitonic_sort"],
        "max_abs_err": sort_err, "ms": rec8["kernel_ms"],
        "plain_ms": rec8["plain_ms"], "torch_sort_ms": rec8["torch_sort_ms"],
        "library_ms": rec8["torch_sort_ms"],
        # 8 B in and 8 B out per element; 45 stages, each reading and
        # writing 8 B per element in shared memory; ~8 word operations per
        # element per stage
        **dict(zip(("bound_ms", "bound_by"), _bound(
            16 * rec8["n"], 45 * 8 * rec8["n"],
            smem_bytes=45 * 2 * 8 * rec8["n"]))),
        "bound_stream_ms": 16 * rec8["n"] / stream * 1e3,
        "query": f"config5 merged operands, N = {rec8['n']}",
        "at_2M": probe[0]})
    stages["joins"] = time_joins(jd, jcap)
    stages["scan_project_ms"] = _wall_ms(lambda i: sc.scan(
        _mat_tree(sch, mat_lo + i % 2), [], project=mat_cols), iters=20)
    stages["tx_join_ms"] = {
        name: _wall_ms(lambda i: _tx_join(sc_tx, sc_ac, tree), iters=5,
                       warmup=1)
        for name, tree in (("no filter", None), ("amount > 0", tx_tree))}
    print(f"phase 5 scan(project=val, bal) at ~1%: "
          f"{stages['scan_project_ms']:.3f} ms; tx join accounts whole "
          f"composition: {stages['tx_join_ms']}")

    _mark("phase 5 sort probe, joins, materialization")
    print(json.dumps({"kernels": records, "stream_bytes_per_s": stream,
                      "stages": stages, "card": card, "n_rows": n_rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
