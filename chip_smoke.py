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
     the squares of values up to 2^32 - 1;
  4. main paths, each run with every launch counter set to 0 just before
     it and read just after, each exactly equal to a numpy oracle:
     - scan: the benchmark segment (256 packs x 65,536 rows, seed 0xBEEF,
       the schema and data of bench.py) scanned with BASELINE config #1,
       the two-leaf check and the entry() query;
     - group-by, BASELINE config #3 (bench_suite.py:171-198, seed
       0xC0FFEE, G = 1000, the 99%-pass `bal GT` filter) at 256 x 65,536
       rows, group_scan with minmax False and True: every group's count,
       sum, min and max;
     - group-by config #3c: G = 65,536 at 64 packs, minmax False;
     - series, config #6 (bench_suite.py:438-455, 1024 buckets of 64):
       series_scan moments at 64 packs, counts, sums and sums of squares;
  5. timing (CUDA events, medians over alternating query variants, with
     the host's launch overhead hidden behind a GPU sleep): each kernel
     and its plain version at the main paths' shapes (scan kernels also
     with L2 flushed before each launch); the host wall time of whole
     scan(), group_scan() and series_scan() calls; rows/s; the kernel's
     bytes/s as a share of a same-run torch read pass over 256 MiB; and
     for group_scan and series_scan the device time of each stage (mask,
     group ids, decode, kernel), the host combine, and torch.profiler's
     device idle share and top kernels.

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
            "fused_group_partials": "knoxdb_tpu_torch/csrc/group_kernels.cu",
            "fused_group_moments_partials":
                "knoxdb_tpu_torch/csrc/group_kernels.cu"}
_REPLACES = {"fused_range_sum_masked": "knoxdb_tpu/ops/pallas_scan.py:126",
             "fused_tree_agg": "knoxdb_tpu/ops/pallas_scan.py:259",
             "fused_group_partials": "knoxdb_tpu/ops/pallas_group.py:95",
             "fused_group_moments_partials":
                 "knoxdb_tpu/ops/pallas_group.py:116"}
GROUP_SEED = 0xC0FFEE
G3 = 1000
THR3 = -((1 << 40) * 49) // 50      # config #3's 99%-pass filter
PACKS_SMALL = 64                    # bench_suite.py's default --packs
G6, T6, IV6 = 1024, 1_000_000, 64


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


def _cfg3_tree(sch, thr: int):
    from knoxdb_tpu_torch.query.filter import Filter, leaf
    from knoxdb_tpu_torch.types import FilterMode
    return leaf(Filter(sch.field("bal"), FilterMode.GT, thr)).optimize()


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


def _capture(mod, name, call):
    """Run call() with mod.name wrapped; returns the first operands the
    main path handed that wrapper (the wrappers are looked up on their
    module at call time)."""
    orig = getattr(mod, name)
    got = []

    def rec(*args):
        if not got:
            got.append(args)
        return orig(*args)

    setattr(mod, name, rec)
    try:
        call()
    finally:
        setattr(mod, name, orig)
    return got[0]


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
    time per call, the device idle share, and the top kernels."""
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall / n, "device_ms": busy / n,
            "idle_share": 1.0 - busy / wall,
            "top": [(k[:70], v / n) for k, v in top]}


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
    phase_group_kernels_vs_plain(dev)

    def run_path(call):
        """Drive one main path with every launch counter at 0 just before
        it; returns its result and the counters just after."""
        SK.reset_counts()
        GK.reset_counts()
        out = call()
        torch.cuda.synchronize()
        return out, {**SK.LAUNCHES, **GK.LAUNCHES}

    def need(launches, names, what):
        if not all(launches[k] > 0 for k in names):
            raise AssertionError(f"{what}: a kernel of the path never "
                                 f"launched: {launches}")

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

    sch3, data3, seg3, t_build3 = _cfg3_segment(N_PACKS, G3)
    sc3 = SegmentScanner(DeviceSegment(seg3, dev))
    group_launches = {}
    for minmax in (False, True):
        t0 = time.perf_counter()
        out, launches = run_path(lambda: sc3.group_scan(
            _cfg3_tree(sch3, THR3), "acct", ["bal"], minmax=minmax))
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
        _cfg3_tree(sch3c, THR3), "acct", ["bal"], minmax=False))
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
    launches_by_kernel = {
        "fused_range_sum_masked": scan_launches["fused_range_sum_masked"],
        "fused_tree_agg": scan_launches["fused_tree_agg"],
        "fused_group_partials": group_launches["fused_group_partials"],
        "fused_group_moments_partials":
            series_launches["fused_group_moments_partials"]}

    # ---- phase 5: timing at the main paths' shapes ----
    variants = {}
    for kname, qname in (("fused_range_sum_masked", "config1"),
                         ("fused_tree_agg", "entry")):
        mk, aggs = queries[qname]
        variants[kname] = [
            _capture(SK, kname, lambda lo=lo: sc.scan(mk(lo), aggs))
            for lo in (1000, 1001)]
    trees3 = [_cfg3_tree(sch3, THR3 + k) for k in (0, 1)]
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
        else:
            # gid and every value word once, the mask words, the output
            gid, words, *vals = var[0][:-1]
            nbytes = (gid.numel() + words.numel()
                      + sum(v.numel() for v in vals)) * 4
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

    print(json.dumps({"kernels": records, "stream_bytes_per_s": stream,
                      "stages": stages, "card": card, "n_rows": n_rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
