#!/usr/bin/env python3
"""Times one family of this checkout's CUDA kernels against earlier or
variant sources of the same kernels, in turns, on the operands the main
paths hand them.

    python3 ab_kernels.py FAMILY DIR [DIR ...]

FAMILY is one of
  group  the group-sums kernel (#3-#4, csrc/group_kernels.cu
         knox_group_sums) at config #3's group_scan (G = 1000, 256 packs),
         config #3c's (G = 65,536, 64 packs; K = 1, and K = 2 on the same
         gids with the values' squares), config #6's series_scan moments
         (K = 2, 64 packs), and past the shared histogram at G =
         max_shared_groups(K) + 1, 12,000, 20,000, 32,768, 40,000, 49,152
         and 65,536 for K = 1 and 2 over 4,194,304 rows (uniform gids, 99%
         masks), and skewed gids at #3c's size (K = 1, G = 65,536; K = 2,
         G = 20,000): Zipf (s = 1) with the hottest groups at the lowest
         ids (in the first slice), the same with the ids shuffled, and
         one group taking every row with all-ones words; past the shared
         histogram this tree's CLUSTER form also
         in each cluster size that holds G (8 and 16 CTAs), where the
         plan runs GLOBAL too. Each DIR is commit
         c5ef0bc's source (LIMBS and the GLOBAL loop, launch geometry
         (mode, stages, blocks));
  sort   the tile sort (#8, csrc/sort_kernels.cu knox_tile_bitonic_sort)
         on the config #5 join's merged operands at N = 2,097,152 and
         8,388,608, ntpose 0, and at 8,388,608 with ntpose 1 and 8; each
         DIR's entry takes this tree's arguments (commit c5ef0bc's body,
         or a copy of this tree's source with other constants);
  split  the split scan kernels 5a and 5b (csrc/scan_kernels.cu
         knox_range_mask_count, knox_masked_plane_popcounts) at every
         operand set that config #2's OR subtree and fee RANGE, config
         #4's big RANGE and config #6f's price RANGE hand them, and at
         width 0 on the same packs (the cost of a launch that reads no
         plane); each DIR's entries must take this tree's arguments (e.g.
         the bodies of commit 68506b1, or a copy of this tree's
         source with other geometry constants).
A DIR holds the other source: `git archive COMMIT knoxdb_tpu_torch/csrc |
tar -x -C tmp_base`, then DIR = tmp_base/knoxdb_tpu_torch/csrc; a build
is named by its DIR without that suffix.

The script builds the family's source of this checkout and of every DIR
under names of their own in the git-ignored knoxdb_tpu_torch/_build/ab/
(one nvcc each, started together), checks that every build gives this
tree's outputs bit for bit on every operand set, and prints their median
CUDA-event times in turns (the DIRs and this tree's forced geometries
in order, this tree twice, the same in reverse), with ptxas' report of every build and its SASS (atomics by
kernel for group, global loads by width for split). Each group and sort
case carries its bound and its library call (one index_add_, torch.sort).
Split kernels are timed warm,
after a 128 MiB fill (L2 flushed, its dirty lines written back during the
launch) and after a 128 MiB read (L2 evicted, clean). The last line is
one JSON object of the results. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke as CS

# family -> (source file, C entry points, kernel names for ptxas / SASS)
FAMILIES = {
    "group": ("group_kernels.cu", ("knox_group_sums",), ("group_sums",)),
    "sort": ("sort_kernels.cu", ("knox_tile_bitonic_sort",),
             ("tile_bitonic_sort",)),
    "split": ("scan_kernels.cu",
              ("knox_range_mask_count", "knox_masked_plane_popcounts"),
              ("range_mask_count_kernel", "masked_popcounts_kernel")),
}
# commit c5ef0bc's knox_group_sums: geometry (mode, stages, blocks), mode 0
# its GLOBAL loop at up to 4 blocks of 1024 rows per SM
_BASE_GROUP_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _label(src_dir: str) -> str:
    return src_dir.rstrip("/").removesuffix("knoxdb_tpu_torch/csrc") \
        .rstrip("/") or src_dir


def _build(family: str, dirs):
    """This checkout's and every DIR's source of the family, each built by
    its own nvcc (started together) into knoxdb_tpu_torch/_build/ab/;
    returns each DIR's entry points by name ({label: {entry: fn}}) and
    {label | "new": (library path, nvcc's log)}."""
    from knoxdb_tpu_torch.ops import cuda_build
    source, entries, _names = FAMILIES[family]
    out = cuda_build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n, (label, src) in enumerate(
            [("new", cuda_build.SRC_DIR)]
            + [(_label(d), Path(d)) for d in dirs]):
        so = out / f"lib{n}_{Path(source).stem}.so"
        jobs[label] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(src / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"build of {label} failed:\n{log}")
        built[label] = (str(so), log)
    libs = {}
    for label, (so, _log) in built.items():
        if label == "new":
            continue
        lib = ctypes.CDLL(so)
        libs[label] = {}
        for name in entries:
            fn = getattr(lib, name)
            fn.argtypes = _BASE_GROUP_ARGS if family == "group" \
                else cuda_build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            libs[label][name] = fn
    return libs, built


def _base_group(fns, args):
    """Commit c5ef0bc's group kernel on a wrapper's operands: its LIMBS
    plan (the same as this tree's) or, past the shared histogram, its
    GLOBAL loop."""
    import torch
    from knoxdb_tpu_torch.ops import group_kernels as GK
    gid, words, *vals, G = args
    K = len(vals) // 2
    sms = torch.cuda.get_device_properties(gid.device).multi_processor_count
    if G <= GK.max_shared_groups(K):
        p = GK.group_tile_plan(gid.numel(), G, K, sms)
        geom = (1, p.stages, p.blocks)
    else:
        geom = (0, 0, min(-(-gid.numel() // 1024), 4 * sms))
    out = torch.zeros((1 + len(vals), G), dtype=torch.int64,
                      device=gid.device)
    ptrs = [v.data_ptr() for v in vals] + [None] * (4 - len(vals))
    err = fns["knox_group_sums"](
        gid.data_ptr(), words.data_ptr(), *ptrs, K, gid.numel(), G,
        out.data_ptr(), *geom, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier kernel: cudaError_t {err}")
    return tuple(out.unbind(0))


def _variant_group(args, S):
    """This tree's group kernel in the CLUSTER form, clusters of S CTAs."""
    from knoxdb_tpu_torch.ops import cuda_build
    from knoxdb_tpu_torch.ops import group_kernels as GK
    gid, words, *vals, G = args
    lib = cuda_build.load()
    plan = GK.cuda_plan(lib, gid.device, gid.numel(), G, len(vals) // 2, S)
    return tuple(GK.launch(lib, gid, words, vals, G, plan).unbind(0))


def _base_sort(fns, args):
    """Another build's tile sort on the wrapper's operands."""
    import torch
    keys, pay, ntpose = args
    ko, po = torch.empty_like(keys), torch.empty_like(pay)
    err = fns["knox_tile_bitonic_sort"](
        keys.data_ptr(), pay.data_ptr(), ko.data_ptr(), po.data_ptr(),
        keys.numel(), ntpose, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier sort: cudaError_t {err}")
    return ko, po


def _base_split(fns, name, args):
    """Another build's 5a or 5b on a wrapper's operands, with the outputs
    its wrapper allocates."""
    import torch
    planes, width = args[0], args[-1]
    P, W = planes.shape[1:]
    dev = planes.device
    stream = torch.cuda.current_stream().cuda_stream
    cnt = torch.empty((P,), dtype=torch.int64, device=dev)
    if name == "range_mask_count":
        _p, lo, hi, fl, mask_in, _w = args
        mask = torch.empty((P, W), dtype=torch.int32, device=dev)
        err = fns["knox_range_mask_count"](
            planes.data_ptr(), width, planes.stride(0), planes.stride(1),
            lo.data_ptr(), hi.data_ptr(), fl.data_ptr(),
            mask_in.data_ptr() if mask_in is not None else None,
            mask.data_ptr(), cnt.data_ptr(), P, W, stream)
        out = (mask, cnt)
    else:
        _p, mask, _w = args
        pcnt = torch.empty((P, max(width, 1)), dtype=torch.int64,
                           device=dev)
        err = fns["knox_masked_plane_popcounts"](
            planes.data_ptr(), width, planes.stride(0), planes.stride(1),
            mask.data_ptr(), pcnt.data_ptr(), cnt.data_ptr(), P, W, stream)
        out = (pcnt, cnt)
    if err:
        raise RuntimeError(f"{name}: cudaError_t {err}")
    return out


def _k2_of(args):
    """K = 2 operands on K = 1 ones, as phase 3 of chip_smoke builds them:
    the low words, a zero high word and the squares' halves."""
    import torch
    from knoxdb_tpu_torch.exec import groupby as GB
    gid, words, vlo, _vhi, G = args
    return (gid, words, vlo, torch.zeros_like(vlo),
            *GB.square_halves(vlo), G)


def _sweep_ops(dev, G, K, rows=1 << 22):
    """Past the shared histogram: uniform gids in [0, G), a 99% mask,
    random value words (K = 2: the squares of the low words)."""
    import torch
    from knoxdb_tpu_torch.ops import bitset as BS
    from knoxdb_tpu_torch.ops import words as WD
    rng = np.random.default_rng(G * 2 + K)
    P, N = rows // CS.PACK_SIZE, CS.PACK_SIZE
    gid = torch.from_numpy(rng.integers(0, G, (P, N)).astype(np.int32)) \
        .to(dev)
    words = BS.pack_mask(torch.from_numpy(rng.random((P, N)) < 0.99)
                         .to(dev))
    vlo, vhi = (WD.to_words(rng.integers(0, 1 << 32, (P, N),
                                         dtype=np.uint64)
                            .astype(np.uint32), dev) for _ in range(2))
    args = (gid, words, vlo, vhi, G)
    return args if K == 1 else _k2_of(args)


def _skew_ops(dev, G, K, kind, rows=1 << 22):
    """Skewed gids in [0, G) (99% masks, random value words, K = 2 the
    squares): "zipf", rank k drawn with weight 1 / (k + 1) and group k the
    k-th hottest; "zipf shuffled", the same groups under a random
    permutation; "one group", every row in group G - 1 with all-ones
    words and every mask bit set."""
    import torch
    from knoxdb_tpu_torch.ops import bitset as BS
    from knoxdb_tpu_torch.ops import words as WD
    rng = np.random.default_rng(G * 5 + K)
    P, N = rows // CS.PACK_SIZE, CS.PACK_SIZE
    if kind == "one group":
        gid = torch.full((P, N), G - 1, dtype=torch.int32, device=dev)
        ones = torch.full((P, N), -1, dtype=torch.int32, device=dev)
        words = torch.full((P, N // 32), -1, dtype=torch.int32, device=dev)
        return (gid, words, *[ones] * (2 * K), G)
    w = 1.0 / np.arange(1, G + 1)
    g = rng.choice(G, size=(P, N), p=w / w.sum())
    if kind == "zipf shuffled":
        g = rng.permutation(G)[g]
    gid = torch.from_numpy(g.astype(np.int32)).to(dev)
    words = BS.pack_mask(torch.from_numpy(rng.random((P, N)) < 0.99)
                         .to(dev))
    vlo, vhi = (WD.to_words(rng.integers(0, 1 << 32, (P, N),
                                         dtype=np.uint64)
                            .astype(np.uint32), dev) for _ in range(2))
    args = (gid, words, vlo, vhi, G)
    return args if K == 1 else _k2_of(args)


def _group_cases(dev, libs):
    """case -> (kernel name, [{build: call()} per operand set], extra
    record fields), the operands captured from the wrappers as the main
    paths hand them over, then the sweep past the shared histogram."""
    from knoxdb_tpu_torch.exec import groupby as GB
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner
    from knoxdb_tpu_torch.ops import cuda_build
    from knoxdb_tpu_torch.ops import group_kernels as GK

    sets = {}
    for name, packs, G in (("config3", CS.N_PACKS, CS.G3),
                           ("config3c", CS.PACKS_SMALL, 1 << 16)):
        sch, _data, seg, _t = CS._cfg3_segment(packs, G)
        sc = SegmentScanner(DeviceSegment(seg, dev))
        sets[name] = [CS._capture(
            GK, "fused_group_partials",
            lambda t=t: sc.group_scan(t, "acct", ["bal"], minmax=False))
            for t in (CS._gt_tree(sch, "bal", CS.THR3 + k) for k in (0, 1))]
    sets["config3c K=2"] = [_k2_of(a) for a in sets["config3c"]]
    _sch6, _data6, seg6, _t = CS._cfg6_segment(CS.PACKS_SMALL)
    sc6 = SegmentScanner(DeviceSegment(seg6, dev))
    plans = [GB.plan_buckets(sc6.d, "ts", CS.T6 + k, CS.IV6, CS.G6)
             for k in (0, 1)]
    sets["config6"] = [CS._capture(
        GK, "fused_group_moments_partials",
        lambda p=p: sc6.series_scan(None, "ts", {"val": ("moments",)}, p))
        for p in plans]
    for K in (1, 2):
        for G in (GK.max_shared_groups(K) + 1, 12000, 20000, 32768, 40000,
                  49152, 1 << 16):
            sets[f"sweep K={K} G={G}"] = [_sweep_ops(dev, G, K)]
    for K, G in ((1, 1 << 16), (2, 20000)):
        for kind in ("zipf", "zipf shuffled", "one group"):
            sets[f"skew K={K} G={G} {kind}"] = [_skew_ops(dev, G, K, kind)]
    lib = cuda_build.load()
    out = {}
    for case, ops in sets.items():
        K = (len(ops[0]) - 3) // 2
        kf = GK.fused_group_partials if K == 1 \
            else GK.fused_group_moments_partials
        gid, G = ops[0][0], ops[0][-1]
        plan = GK.cuda_plan(lib, dev, gid.numel(), G, K)
        variants = {}
        if G > GK.max_shared_groups(K):
            # the CLUSTER form at both sizes, also where the plan runs GLOBAL
            variants = {
                f"cluster S={S} rc={GK.cluster_shape(G, K, S)[2]}": S
                for S in (8, 16) if GK.cluster_shape(G, K, S)}
        nbytes, nops = CS._group_need(ops[0])
        bound_ms, bound_by = CS._bound(nbytes, nops)
        extra = {"plan": plan.__dict__.copy(), "bytes": nbytes,
                 "bound_ms": bound_ms, "bound_by": bound_by}
        if case.startswith(("config3c", "skew")):
            extra["library_ms"] = CS._group_library_ms(ops[0])
        out[case] = (kf.__name__, [
            {"new": lambda a=a, kf=kf: kf(*a),
             **{k: lambda a=a, f=f: _base_group(f, a)
                for k, f in libs.items()},
             **{k: lambda a=a, v=v: _variant_group(a, v)
                for k, v in variants.items()}} for a in ops], extra)
    return out


def _sort_cases(dev, libs):
    """Kernel #8 on the config #5 join's merged (key, tagged id) operands
    (chip_smoke._merged_operands at nl = nr = 4,194,304), with its bound
    (each pair read once and written once) and torch.sort (stable, the
    payload gathered: the join's own sort) as its library call."""
    import torch
    from knoxdb_tpu_torch.ops import sort_kernels as S8
    lk, rk, _rku = CS._cfg5_keys(CS.NL5)
    kops, pops = CS._merged_operands(lk, rk, dev)
    out = {}
    for n, nt in ((32 * S8.TILE, 0), (kops.numel(), 0), (kops.numel(), 1),
                  (kops.numel(), 8)):
        k, p = kops[:n], pops[:n]
        k64 = k.long() & 0xFFFFFFFF

        def lib_sort(i, k64=k64, p=p):
            s = torch.sort(k64, stable=True)
            return s.values, p[s.indices]

        bound_ms, bound_by = CS._bound(16 * n, 0)
        out[f"N={n} ntpose={nt}"] = ("tile_bitonic_sort", [
            {"new": lambda a=(k, p, nt): S8.tile_bitonic_sort(*a),
             **{lab: lambda a=(k, p, nt), f=f: _base_sort(f, a)
                for lab, f in libs.items()}}],
            {"n": n, "ntpose": nt, "bytes": 16 * n, "bound_ms": bound_ms,
             "bound_by": bound_by,
             "library_ms": CS._event_ms(lib_sort, iters=20)})
    return out


def _split_ops(dev):
    """The operands config #2's OR subtree and fee RANGE, config #4's big
    RANGE and config #6f's price RANGE hand 5a and 5b
    (chip_smoke.split_path_ops)."""
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner

    sch2, _d2, seg2, _t = CS._cfg2_segment()
    sc2 = SegmentScanner(DeviceSegment(seg2, dev))
    q2 = CS._cfg2_queries(sch2, seg2.nrows_total)
    sch4, _d4, seg4, _t = CS._cfg4_segment()
    sc4 = SegmentScanner(DeviceSegment(seg4, dev))
    big_tree, big_aggs = CS._cfg4_big_query(sch4)
    sch6, _d6, seg6, _t = CS._cfg6f_segment(CS.PACKS_SMALL)
    sc6 = SegmentScanner(DeviceSegment(seg6, dev))
    return CS.split_path_ops({
        "config2 OR subtree": lambda: sc2.scan(
            q2["OR subtree"][0](0), q2["OR subtree"][1]),
        "config2 fee RANGE": lambda: sc2.scan(
            q2["fee RANGE"][0](0), q2["fee RANGE"][1]),
        "config4 big RANGE": lambda: sc4.scan(big_tree(), big_aggs),
        "config6f price RANGE": lambda: sc6.scan(
            CS._price_tree(sch6, CS.PRICE_LO, CS.PRICE_HI),
            CS._price_aggs())})


def _width0(kname, args):
    """The operands of a launch on the same packs at width 0: one zero
    plane, the ladder's constants passing every row, the same mask."""
    import torch
    planes = torch.zeros((1, *args[0].shape[1:]), dtype=torch.int32,
                         device=args[0].device)
    if kname == "masked_plane_popcounts":
        return (planes, args[1], 0)
    flags = torch.zeros_like(args[3])
    flags[:, 1] = flags[:, 4] = -1
    lo = torch.zeros((planes.shape[1], 1), dtype=torch.int32,
                     device=planes.device)
    return (planes, lo, lo, flags, args[4], 0)


def _split_case(kname, args, libs):
    """(kernel name, [{build: call()}], record fields) of one operand set
    of 5a or 5b."""
    from knoxdb_tpu_torch.ops import scan_kernels as SK
    kf = getattr(SK, kname)
    nbytes, nops = CS._split_need(kname, args)
    bound_ms, bound_by = CS._bound(nbytes, nops)
    return (kname, [{"new": lambda: kf(*args),
                     **{k: lambda f=f: _base_split(f, kname, args)
                        for k, f in libs.items()}}],
            {"planes": list(args[0].shape), "bytes": nbytes,
             "bound_ms": bound_ms, "bound_by": bound_by})


def _split_cases(dev, libs, ops=None):
    """The same for 5a and 5b: one case per operand set of
    chip_smoke.SPLIT_PATHS, and one at width 0 per kernel and distinct
    (P, W, mask in), each with its bound."""
    out = {}
    for kname, sets in (ops or _split_ops(dev)).items():
        floors = {}
        for n, (label, a) in enumerate(sets):
            case = f"{kname} {label}" + (f" #{n}" if label.endswith(
                "OR subtree") else "")
            out[case] = _split_case(kname, a, libs)
            mask = a[4] if kname == "range_mask_count" else a[1]
            floors.setdefault((*a[0].shape[1:], mask is not None),
                              (label, _width0(kname, a)))
        for label, a in floors.values():
            out[f"{kname} width 0 at {label}'s packs"] = \
                _split_case(kname, a, libs)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 3 \
            or sys.argv[1] not in FAMILIES:
        print("ab_kernels: needs a CUDA device, FAMILY (group, sort or split) "
              "and "
              "one DIR or more (see the docstring)", file=sys.stderr)
        return 1
    from knoxdb_tpu_torch.ops import cuda_build

    family, dirs = sys.argv[1], sys.argv[2:]
    dev = torch.device("cuda:0")
    card = CS._card()
    t0 = time.perf_counter()
    cuda_build.load()
    libs, built = _build(family, dirs)
    print(f"card: {card}; builds in {time.perf_counter() - t0:.2f} s")
    names = FAMILIES[family][2]
    ptxas = {k: CS._ptxas_of(log, names) for k, (_so, log) in built.items()}
    sass = {k: (CS._sass_loads(so, names) if family == "split"
                else CS._sass_atomics(so, names))
            for k, (so, _log) in built.items()}
    print(f"ptxas: {ptxas}\nSASS "
          f"{'global loads' if family == 'split' else 'atomics'}: {sass}")

    cases = {"split": _split_cases, "group": _group_cases,
             "sort": _sort_cases}[family](dev, libs)
    others = list(dict.fromkeys(k for _n, sets, _e in cases.values()
                                for k in sets[0] if k != "new"))
    order = others + ["new", "new"] + list(reversed(others))
    flush = torch.empty((128 << 20) // 4, dtype=torch.int32, device=dev)
    results = {}
    for case, (kname, sets, extra) in cases.items():
        for s in sets:
            want = s["new"]()
            err = max(CS._max_err(s[k](), want) for k in s)
            if err:
                raise AssertionError(f"{case}: a build differs by {err}")
        turns = {k: {"warm": [], "l2_flushed": [], "l2_read_evicted": []}
                 for k in sets[0]}
        for k in order:
            if k not in sets[0]:
                continue
            f = lambda i, k=k: sets[i % len(sets)][k]()    # noqa: E731
            turns[k]["warm"].append(CS._event_ms(f, iters=30))
            if family == "split":
                turns[k]["l2_flushed"].append(CS._event_ms(
                    f, iters=30, before=lambda i: flush.fill_(i)))
                turns[k]["l2_read_evicted"].append(CS._event_ms(
                    f, iters=30, before=lambda i: flush.sum()))
        ms = {k: {m: sum(v) / len(v) for m, v in t.items() if v}
              for k, t in turns.items()}
        results[case] = {"kernel": kname, "turns_ms": turns, "ms": ms,
                         **extra}
        if "bound_ms" in extra:
            results[case]["share_of_bound"] = {
                k: {m: extra["bound_ms"] / t for m, t in v.items()}
                for k, v in ms.items()}
        print(f"{case}: " + "; ".join(
            f"{k} " + " / ".join(f"{t:.5f}" for t in v.values())
            for k, v in ms.items())
            + (f"; bound {extra['bound_ms']:.5f}" if "bound_ms" in extra
               else ""), flush=True)
    print(json.dumps({"card": card, "family": family, "order": order,
                      "cases": results, "ptxas": ptxas, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
