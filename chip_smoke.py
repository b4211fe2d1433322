#!/usr/bin/env python3
"""Smoke run of knoxdb_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits nonzero:
  1. card: nvidia-smi's name and power limit, torch's device name;
  2. build: the CUDA kernels of knoxdb_tpu_torch/csrc from source (nvcc,
     sm_90a), with the seconds it took and ptxas' register report;
  3. kernel = plain: each kernel against its plain PyTorch version on the
     card, random planes at widths 0-64, P = 64, W = 2048, 1-3 leaves, sum
     and min/max specs and an empty pack, bit for bit;
  4. main path: the benchmark segment (256 packs x 65,536 rows, seed
     0xBEEF, the schema and data of bench.py) built on the host, uploaded,
     and scanned with BASELINE config #1, the two-leaf check and the
     entry() query, each exactly equal to a numpy oracle, with each
     kernel's launch counter read around the run;
  5. timing (CUDA events, medians over alternating query variants lo =
     1000 / 1001, with the host's launch overhead hidden behind a GPU
     sleep): each kernel, also with L2 flushed before each launch, and its
     plain version at the main path's shapes; the host wall time of a
     whole scan() call; rows/s; and the kernel's bytes/s as a share of a
     same-run torch read pass over 256 MiB.

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
_SOURCE = "knoxdb_tpu_torch/csrc/scan_kernels.cu"
_REPLACES = {"fused_range_sum_masked": "knoxdb_tpu/ops/pallas_scan.py:126",
             "fused_tree_agg": "knoxdb_tpu/ops/pallas_scan.py:259"}


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

    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner
    from knoxdb_tpu_torch.ops import cuda_build
    from knoxdb_tpu_torch.ops import scan_kernels as SK

    t0 = time.perf_counter()
    cuda_build.load()
    ptxas = [ln.strip() for ln in cuda_build.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_build.build_info['seconds']:.2f} s) -> "
          f"{cuda_build.build_info['library']}")
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    phase_kernels_vs_plain(dev)

    sch, data, seg, t_build = _bench_segment()
    t0 = time.perf_counter()
    sc = SegmentScanner(DeviceSegment(seg, dev))
    queries = _queries(sch)
    n_rows = PACK_SIZE * N_PACKS

    # capture the operands the main path hands each kernel (the wrappers
    # are looked up on the module at call time)
    captured = {}
    originals = {k: getattr(SK, k) for k in SK.LAUNCHES}

    def recorder(name):
        def rec(*args):
            captured.setdefault(name, args)
            return originals[name](*args)
        return rec

    for k in originals:
        setattr(SK, k, recorder(k))
    SK.reset_counts()
    results = {name: sc.scan(mk(1000), aggs)
               for name, (mk, aggs) in queries.items()}
    torch.cuda.synchronize()
    launches = dict(SK.LAUNCHES)
    for k, f in originals.items():
        setattr(SK, k, f)
    t_path = time.perf_counter() - t0
    for name, res in results.items():
        count, want = _oracle(data, name, 1000)
        if res.count != count or res.aggs != want:
            raise AssertionError(f"{name}: {res.count} {res.aggs} != "
                                 f"{count} {want}")
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    print(f"phase 4 main path: {n_rows} rows in {N_PACKS} packs, host build "
          f"{t_build:.2f} s, upload + first scans {t_path:.2f} s; "
          + "; ".join(f"{n}: count={r.count} aggs={r.aggs}"
                      for n, r in results.items())
          + f"; exact vs numpy oracle; launches {launches}")

    # ---- phase 5: timing at the main path's shapes ----
    kernel_query = {"fused_range_sum_masked": "config1",
                    "fused_tree_agg": "entry"}
    variants = {}
    for kname, qname in kernel_query.items():
        mk, aggs = queries[qname]
        var = []
        for lo in (1000, 1001):
            captured.pop(kname, None)
            setattr(SK, kname, recorder(kname))
            sc.scan(mk(lo), aggs)
            setattr(SK, kname, originals[kname])
            var.append(captured[kname])
        variants[kname] = var
    plain = {"fused_range_sum_masked": SK.fused_range_sum_masked_torch,
             "fused_tree_agg": SK.fused_tree_agg_torch}
    flush = torch.empty((128 << 20) // 4, dtype=torch.int32, device=dev)
    stream = _stream_bps(dev)
    records = []
    for kname, var in variants.items():
        kern, ref = getattr(SK, kname), plain[kname]
        err = max(_max_err(kern(*a), ref(*a)) for a in var)
        if err:
            raise AssertionError(f"{kname} at the main path's shapes: max "
                                 f"abs err {err}")
        ms = _event_ms(lambda i: kern(*var[i % 2]))
        ms_cold = _event_ms(lambda i: kern(*var[i % 2]),
                            before=lambda i: flush.fill_(i))
        plain_ms = _event_ms(lambda i: ref(*var[i % 2]))
        # bytes the pass needs: every plane once, mask_in in, mask out
        if kname == "fused_range_sum_masked":
            planes, mask_in = [var[0][0]], var[0][4]
        else:
            planes, mask_in = var[0][0], var[0][3]
        nbytes = sum(p.numel() * 4 for p in planes) + 2 * mask_in.numel() * 4
        records.append({
            "name": kname, "route": "cuda", "source": _SOURCE,
            "replaces": _REPLACES[kname], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "ms_l2_flushed": ms_cold, "query": kernel_query[kname],
            "bytes": nbytes, "rows_per_s": n_rows / (ms / 1e3),
            "pct_of_stream_bw": 100.0 * nbytes / (ms / 1e3) / stream,
            "pct_of_stream_bw_l2_flushed":
                100.0 * nbytes / (ms_cold / 1e3) / stream,
        })
    scans = {}
    for qname in ("config1", "entry"):
        mk, aggs = queries[qname]
        trees = [mk(1000), mk(1001)]
        for i in range(5):
            sc.scan(trees[i % 2], aggs)
        t = []
        for i in range(ITERS):
            t0 = time.perf_counter()
            sc.scan(trees[i % 2], aggs)      # ends in a device->host copy
            t.append(time.perf_counter() - t0)
        scans[qname] = statistics.median(t) * 1e3
    for r in records:
        q = r["query"]
        r["scan_ms"] = scans[q]
        r["scan_rows_per_s"] = n_rows / (scans[q] / 1e3)
    print(f"phase 5 timing: stream read {stream / 1e9:.1f} GB/s; "
          + "; ".join(f"{r['name']} ({r['query']}): kernel {r['ms']:.4f} ms "
                      f"(L2 flushed {r['ms_l2_flushed']:.4f}), plain "
                      f"{r['plain_ms']:.4f} ms, scan() {r['scan_ms']:.3f} ms, "
                      f"{r['rows_per_s'] / 1e9:.1f} G rows/s kernel, "
                      f"{r['pct_of_stream_bw']:.0f}% of stream bw"
                      for r in records))
    print(json.dumps({"kernels": records, "stream_bytes_per_s": stream,
                      "card": card, "n_rows": n_rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
