"""The engine's scan over a Mesh: the general fused scan plan (any filter
tree, multi-column aggregates, group-by, pruning) run per shard (the port
of knoxdb_tpu/parallel/engine_spmd.py).

Layout contract (pack/segment.build_segment(uniform=N)):
- every column is ONE (scheme, width, k) device group covering all P
  packs, P a multiple of the shard count N (padded with empty packs);
- shard r holds packs [r P/N, (r+1) P/N) of every column as contiguous
  tensors on mesh.devices[r], uploaded once when the scanner is built
  (kernel #2 takes contiguous planes only, and a pack range of plane-major
  [w, P, W] planes is not contiguous). The scanner's own image of the
  whole segment holds host metadata only (DeviceSegment(arrays=False)):
  the host plans over it, and no column lives on the device twice.

`prepare` keeps the inherited (fn, args) contract (exec/scan.py): the
host prunes and binds the query once over the whole segment, and fn cuts
each per-pack argument at every shard's pack range, launches every
shard's plan (the same plan the single-device scanner builds, over the
shard's own arrays: kernel #1 or #2, 5a / 5b for the leaves that do not
fuse) before it reads any result, and concatenates (mask, counts, parts)
along the pack axis in shard order. The inherited host combine then runs
unchanged, so counts, exact sums, min and max and float sums (a fixed
pairwise order per pack) are the single-device answers.

`group_scan` (kernel #3 where minmax=False) and the exact moments of
`series_scan` (kernel #4) run per shard under each shard's mask; their
[G] partials combine exactly on the host (counts and python-int sums
add, min and max fold). The row paths that need whole columns in pack
order (projections, scan_stream, top-k, the join side, the other series
kinds) run the inherited code over the concatenated mask, and their
decodes, group ids and rebased planes come per shard, joined in pack
order (`_over_packs`), so they see the single-device rows and ties.
"""

from __future__ import annotations

import numpy as np
import torch

from ..exec import device as D
from ..exec.scan import SegmentScanner
from ..pack.segment import EncodedColumn, Segment
from ..pack.stats import FieldStats, SegmentStats
from .mesh import Mesh, place

__all__ = ["ShardedScanner", "is_uniform_segment"]


def is_uniform_segment(dseg: D.DeviceSegment, ndev: int) -> bool:
    """True when the segment satisfies the shard layout contract."""
    if dseg.P % ndev:
        return False
    for name in dseg.seg.columns:
        col = dseg.column(name)
        if len(col.groups) != 1 or col.groups[0].npacks != dseg.P:
            return False
    return True


# ------------------------------------------------------ the pack axis ---
# Which axis of each per-pack operand and partial is the pack axis, for
# the port's own layouts; a key the table does not know raises.

# leaf constants of exec/rewrite.leaf_group_consts
_CONST_CUT = {"const_match", "dict_mask", "base_limbs"}   # [Pg, ...]
_CONST_CUT_TUPLE = {"range", "rel"}     # tuples of [Pg, ...] tensors
_CONST_WHOLE = {"cs", "cs_limbs", "lo_limbs", "hi_limbs"}  # query keys
_CONST_INT = {"lo", "hi"}               # python ints (DELTA bounds)

# partials of exec/device.group_masked_* and the fused scan kernels
_PART_AXIS = {"cnt": 0, "pcnt": 0, "mnmx": 0, "lo": 0, "hi": 0, "mn": 0,
              "mx": 0, "fsum": 0, "limb_sums": 1, "mn_limbs": 1,
              "mx_limbs": 1}


def _cut(x: torch.Tensor, axis: int, lo: int, hi: int, device):
    return place(x.narrow(axis, lo, hi - lo), device).contiguous()


def _cut_const_entry(entry: dict, lo: int, hi: int, device) -> dict:
    out = {}
    for k, v in entry.items():
        if k in _CONST_CUT:
            out[k] = _cut(v, 0, lo, hi, device)
        elif k in _CONST_CUT_TUPLE:
            out[k] = tuple(_cut(t, 0, lo, hi, device) for t in v)
        elif k == "rels":
            out[k] = [tuple(_cut(t, 0, lo, hi, device) for t in r)
                      for r in v]
        elif k in _CONST_WHOLE:
            out[k] = place(v, device)
        elif k in _CONST_INT:
            out[k] = v
        else:
            raise ValueError(f"unknown const key {k!r}")
    return out


def _cut_consts(consts: list, lo: int, hi: int, device) -> list:
    """consts of SegmentScanner._prepare_tail: per leaf a list of per-group
    constant dicts ([] for a leaf the zone maps decided), then the fused
    kernel's operands: (lo_bits, hi_bits, flags) [P, w] for the one-leaf
    kernel or one such triple per fused leaf."""
    *leaves, fused = consts
    out = [[_cut_const_entry(g, lo, hi, device) for g in leaf]
           for leaf in leaves]
    if fused and isinstance(fused[0], tuple):
        out.append(tuple(tuple(_cut(t, 0, lo, hi, device) for t in e)
                         for e in fused))
    else:
        out.append(tuple(_cut(t, 0, lo, hi, device) for t in fused))
    return out


def _cut_gconsts(mode_tags: tuple, gconsts: list, lo: int, hi: int,
                 device) -> list:
    """exec/groupby.gid_consts per shard: the per-pack int32 LUT and CONST
    gids are cut; the bucket starts and search keys are copied whole; the
    bucket32 pair and the range base are python values."""
    out = []
    for tag, gc in zip(mode_tags, gconsts):
        if tag in ("lut", "const"):
            out.append(_cut(gc, 0, lo, hi, device))
        elif isinstance(gc, torch.Tensor):
            out.append(place(gc, device))
        else:
            out.append(gc)
    return out


# ---------------------------------------------------------- placement ---

def _slice_stats(fs: FieldStats, lo: int, hi: int) -> FieldStats:
    return FieldStats(fs.min_key[lo:hi], fs.max_key[lo:hi],
                      None if fs.bloom_words is None
                      else fs.bloom_words[lo:hi],
                      fs.filter_type, is_prefix=fs.is_prefix,
                      pack_filters=None if fs.pack_filters is None
                      else fs.pack_filters[lo:hi])


def _slice_segment(seg: Segment, lo: int, hi: int) -> Segment:
    """Packs [lo, hi) of a host segment, sharing its packs."""
    cols = {n: EncodedColumn(c.field, c.packs[lo:hi], c.wide,
                             None if c.wide_bases is None
                             else c.wide_bases[lo:hi])
            for n, c in seg.columns.items()}
    st = seg.stats
    stats = SegmentStats(st.nrows[lo:hi], st.rid_base[lo:hi],
                         {n: _slice_stats(fs, lo, hi)
                          for n, fs in st.fields.items()})
    nrows = seg.nrows[lo:hi]
    return Segment(seg.schema, seg.pack_size, int(nrows.sum()), nrows, cols,
                   stats, seg.epoch)


class ShardedScanner(SegmentScanner):
    """SegmentScanner whose plans run per shard over a mesh.

    Requires a uniform segment (build_segment(uniform=ndev)). The scanner
    plans over the whole segment; `self.shards[r]` is the single-device
    scanner of shard r, whose plans it runs."""

    def __init__(self, dseg: D.DeviceSegment, mesh: Mesh,
                 axis: str = "packs"):
        if dseg.with_arrays:
            dseg = D.DeviceSegment(dseg.seg, dseg.device, arrays=False)
        super().__init__(dseg)
        if mesh.devices.ndim != 1 or mesh.axis_names != (axis,):
            raise ValueError(f"ShardedScanner needs a 1-d mesh over "
                             f"{axis!r}, got {mesh}; flatten a hybrid mesh "
                             f"with parallel.multihost.attach")
        ndev = mesh.shape[axis]
        if not is_uniform_segment(dseg, ndev):
            raise ValueError(
                "ShardedScanner needs a uniform segment (one group per "
                f"column, P % {ndev} == 0); build with uniform={ndev}")
        self.mesh = mesh
        self.axis = axis
        step = dseg.P // ndev
        self.ranges = [(r * step, (r + 1) * step) for r in range(ndev)]
        self.shards = self._place_arrays()

    def _place_arrays(self) -> list[SegmentScanner]:
        """Every column's packs of each shard's range uploaded to the
        shard's device, once."""
        seg = self.d.seg
        shards = []
        for (lo, hi), dev in zip(self.ranges, self.mesh.flat()):
            sd = D.DeviceSegment(_slice_segment(seg, lo, hi), dev)
            for name in seg.columns:
                sd.column(name)
            shards.append(SegmentScanner(sd))
        return shards

    def _over_packs(self, fn, dim: int = 0):
        outs = [fn(sh.d, lo, hi) for sh, (lo, hi) in zip(self.shards,
                                                        self.ranges)]
        dev = self.d.device
        if isinstance(outs[0], tuple):
            return tuple(self.mesh.concat(parts, dev, dim)
                         for parts in zip(*outs))
        return self.mesh.concat(outs, dev, dim)

    def _row_gids(self, field: str, mode_tags: tuple, gconsts):
        from ..exec import groupby as GB
        return self._over_packs(lambda d, lo, hi: GB.row_gids(
            mode_tags, d.column(field).groups,
            _cut_gconsts(mode_tags, gconsts, lo, hi, d.device), d.P, d.W))

    # ------------------------------------------------------------ plans --

    def _build_fn(self, tdesc, leaves, skip_leaf, aggs, agg_fields, fuse,
                  has_excl, has_incl):
        fns = [sh._build_fn(tdesc, leaves, skip_leaf, aggs, agg_fields,
                            fuse, has_excl, has_incl) for sh in self.shards]

        def shard_outputs(arrays, consts, overrides, valid, excl=()):
            """Every shard's (mask, counts, parts) on its own device; all
            launched before anything is read."""
            names = list(arrays)
            outs = []
            for sh, f, (lo, hi) in zip(self.shards, fns, self.ranges):
                dev = sh.d.device
                outs.append(f(
                    sh.d.arrays(names), _cut_consts(consts, lo, hi, dev),
                    [(_cut(a, 0, lo, hi, dev), _cut(n, 0, lo, hi, dev))
                     for a, n in overrides],
                    sh.d.valid_words,
                    tuple(_cut(w, 0, lo, hi, dev) for w in excl)))
            return outs

        def fn(arrays, consts, overrides, valid, excl=()):
            return self._concat_outputs(
                shard_outputs(arrays, consts, overrides, valid, excl))

        fn.shard_outputs = shard_outputs
        return fn

    def _concat_outputs(self, outs):
        """(mask, counts, parts) of every shard joined along the pack axis
        in shard order, on the scanner's device."""
        dev = self.d.device

        def cat(ts, dim=0):
            return self.mesh.concat(ts, dev, dim)

        mask = cat([o[0] for o in outs])
        cnt = cat([o[1] for o in outs])
        parts = []
        for i, p0 in enumerate(outs[0][2]):
            if p0 is None:
                parts.append(None)
                continue
            groups = []
            for gi, g0 in enumerate(p0):
                unknown = set(g0) - set(_PART_AXIS)
                if unknown:
                    raise ValueError(f"unknown partial {sorted(unknown)}")
                groups.append({k: cat([o[2][i][gi][k] for o in outs],
                                      _PART_AXIS[k]) for k in g0})
            parts.append(groups)
        return mask, cnt, parts

    def _shard_masks(self, tree, exclude_words):
        mask_fn, margs = self.prepare(tree, [], exclude_words)
        return [o[0] for o in mask_fn.shard_outputs(*margs)]

    # ---------------------------------------------------------- group-by --

    def group_scan(self, tree, group_field: str, agg_fields: list[str],
                   exclude_words=None, global_keys=None, gplan=None,
                   minmax: bool = True):
        """Per-shard group-by: each shard aggregates its packs into [G]
        partials (kernel #3 where minmax=False); the host adds counts and
        python-int sums and folds min and max."""
        from ..exec import groupby as GB
        if not agg_fields:
            agg_fields = [group_field]
        if gplan is None:
            gplan = GB.plan_groups(self.d, group_field, global_keys)
        masks = self._shard_masks(tree, exclude_words)
        gconsts = GB.gid_consts(gplan, self.d.device)
        tags = tuple(m[0] for m in gplan.mode)
        outs = [sh._group_parts(m, _cut_gconsts(tags, gconsts, lo, hi,
                                                sh.d.device),
                                tags, gplan.G, group_field, agg_fields,
                                minmax)
                for sh, m, (lo, hi) in zip(self.shards, masks, self.ranges)]
        counts, results = None, None
        for out in outs:
            c, res = self._group_collect(gplan, out, agg_fields, minmax)
            if counts is None:
                counts, results = c, res
                continue
            counts = counts + c
            for f in agg_fields:
                s, mn, mx = results[f]
                s2, mn2, mx2 = res[f]
                results[f] = (s + s2, np.minimum(mn, mn2),
                              np.maximum(mx, mx2))
        return gplan, counts, results

    def series_scan(self, tree, time_field: str, kinds: dict, gplan,
                    exclude_words=None):
        """The exact moments run per shard (kernel #4) and add as python
        ints; the other kinds run the inherited code over the concatenated
        mask and per-shard decodes, so first / last and ts runs see rows
        in global order."""
        from ..exec import groupby as GB
        kspec, meta, mplan = self._series_plan(kinds)
        exact = tuple((f, ("moments",)) for f, fk in kspec
                      if "moments" in fk and f in mplan)
        rest = tuple((f, tuple(k for k in fk
                               if not (k == "moments" and f in mplan)))
                     for f, fk in kspec)
        rest = tuple((f, fk) for f, fk in rest if fk)
        masks = self._shard_masks(tree, exclude_words)
        gconsts = GB.gid_consts(gplan, self.d.device)
        tags = tuple(m[0] for m in gplan.mode)
        outs = [sh._series_parts(m, _cut_gconsts(tags, gconsts, lo, hi,
                                                 sh.d.device),
                                 tags, gplan.G, time_field, exact, meta,
                                 mplan)
                for sh, m, (lo, hi) in zip(self.shards, masks, self.ranges)]
        res = {}
        if rest:
            mask = self.mesh.concat(masks, self.d.device)
            res = self._series_collect(
                self._series_parts(mask, gconsts, tags, gplan.G, time_field,
                                   rest, meta, mplan), meta, mplan)
        for f, _k in exact:
            n, s_r, s_q = None, 0, 0
            for out in outs:
                c, sr_lo, sr_hi, sq_lo, sq_hi = out[(f, "moments")]
                c = c.cpu().numpy()
                n = c if n is None else n + c
                s_r = s_r + GB.halves_sum(sr_lo, sr_hi)
                s_q = s_q + GB.halves_sum(sq_lo, sq_hi)
            res[(f, "moments")] = self.exact_moments(n, s_r, s_q, mplan[f],
                                                     meta[f][0])
        return res
