#!/usr/bin/env python3
"""Times the group-sums kernel (kernels #3-#4, csrc/group_kernels.cu) of
this checkout against an earlier source of the same kernel, in turns, on
the operands the main paths hand it.

    python3 ab_group_kernel.py DIR

DIR holds the earlier group_kernels.cu, whose knox_group_sums takes no
launch geometry (commit 3295ac2's: `git archive 3295ac2
knoxdb_tpu_torch/csrc | tar -x -C tmp_base`, then DIR =
tmp_base/knoxdb_tpu_torch/csrc). The script builds it and this
checkout's source under names of their own in the git-ignored
knoxdb_tpu_torch/_build/ab/, captures
the kernel's operands from config #3's group_scan (G = 1000, 256 packs),
config #3c's (G = 65,536, 64 packs) and config #6's series_scan moments
(K = 2, 64 packs), checks that both builds give the same outputs bit for
bit, and prints their median CUDA-event times, run earlier, new, new,
earlier, with ptxas' report and the SASS atomics of both libraries. The
last line is one JSON object of the results. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as CS

ORDER = ("base", "new", "new", "base")


def _build(src_dir: str):
    """This checkout's and the earlier group_kernels.cu, each built by its
    own nvcc (started together) into knoxdb_tpu_torch/_build/ab/ for
    ptxas' report and the SASS; returns the earlier build's
    knox_group_sums and {"new" | "base": (library path, nvcc's log)}."""
    from knoxdb_tpu_torch.ops import cuda_build
    out = cuda_build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for side, src in (("new", cuda_build.SRC_DIR), ("base", Path(src_dir))):
        so = out / f"lib{side}_group_kernels.so"
        jobs[side] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(src / "group_kernels.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for side, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"build of the {side} kernel failed:\n{log}")
        built[side] = (str(so), log)
    fn = ctypes.CDLL(built["base"][0]).knox_group_sums
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, P, P]
    fn.restype = I
    return fn, built


def _base_call(fn, args):
    """The earlier kernel on a wrapper's operands."""
    import torch
    gid, words, *vals, G = args
    out = torch.zeros((1 + len(vals), G), dtype=torch.int64,
                      device=gid.device)
    ptrs = [v.data_ptr() for v in vals] + [None] * (4 - len(vals))
    err = fn(gid.data_ptr(), words.data_ptr(), *ptrs, len(vals) // 2,
             gid.numel(), G, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier kernel: cudaError_t {err}")
    return tuple(out.unbind(0))


def _cases(dev):
    """kernel name and operand sets per main path, captured from the
    wrappers as the calls hand them over."""
    from knoxdb_tpu_torch.exec import groupby as GB
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import SegmentScanner
    from knoxdb_tpu_torch.ops import group_kernels as GK

    out = {}
    for name, packs, G in (("config3", CS.N_PACKS, CS.G3),
                           ("config3c", CS.PACKS_SMALL, 1 << 16)):
        sch, _data, seg, _t = CS._cfg3_segment(packs, G)
        sc = SegmentScanner(DeviceSegment(seg, dev))
        out[name] = ("fused_group_partials", [CS._capture(
            GK, "fused_group_partials",
            lambda t=t: sc.group_scan(t, "acct", ["bal"], minmax=False))
            for t in (CS._gt_tree(sch, "bal", CS.THR3 + k) for k in (0, 1))])
    _sch6, _data6, seg6, _t = CS._cfg6_segment(CS.PACKS_SMALL)
    sc6 = SegmentScanner(DeviceSegment(seg6, dev))
    plans = [GB.plan_buckets(sc6.d, "ts", CS.T6 + k, CS.IV6, CS.G6)
             for k in (0, 1)]
    out["config6"] = ("fused_group_moments_partials", [CS._capture(
        GK, "fused_group_moments_partials",
        lambda p=p: sc6.series_scan(None, "ts", {"val": ("moments",)}, p))
        for p in plans])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("ab_group_kernel: needs a CUDA device and DIR (see the "
              "docstring)", file=sys.stderr)
        return 1
    from knoxdb_tpu_torch.ops import cuda_build
    from knoxdb_tpu_torch.ops import group_kernels as GK

    dev = torch.device("cuda:0")
    card = CS._card()
    t0 = time.perf_counter()
    cuda_build.load()
    base, built = _build(sys.argv[1])
    print(f"card: {card}; builds in {time.perf_counter() - t0:.2f} s")
    ptxas = {k: CS._ptxas_of(log, ("group_sums",))
             for k, (_so, log) in built.items()}
    sass = {k: CS._sass_atomics(so) for k, (so, _log) in built.items()}
    print(f"ptxas: {ptxas}\nSASS atomics: {sass}")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    for case, (kname, sets) in _cases(dev).items():
        kf = getattr(GK, kname)
        fns = {"new": lambda i: kf(*sets[i % len(sets)]),
               "base": lambda i: _base_call(base, sets[i % len(sets)])}
        err = max(CS._max_err(fns["base"](i), fns["new"](i))
                  for i in range(len(sets)))
        if err:
            raise AssertionError(f"{case}: the builds differ by {err}")
        turns = {k: [] for k in fns}
        for k in ORDER:
            turns[k].append(CS._event_ms(fns[k], iters=30))
        gid, G = sets[0][0], sets[0][-1]
        results[case] = {
            "kernel": kname, "turns_ms": turns,
            "ms": {k: sum(v) / len(v) for k, v in turns.items()},
            "plan": GK.group_tile_plan(gid.numel(), G,
                                       (len(sets[0]) - 3) // 2,
                                       sms).__dict__.copy()}
        print(f"{case} ({kname}): {results[case]}", flush=True)
    print(json.dumps({"card": card, "cases": results, "ptxas": ptxas,
                      "sass_atomics": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
