"""Segment scan executor: filter tree + aggregates -> one fused kernel.

The port of knoxdb_tpu/exec/scan.py (prepare / plan / scan / combine).
Per query:

1. the host prunes packs by zone maps (pack/stats.py) into per-pack
   ALL/NONE tri-states, rewrites every leaf into per-group device
   constants (exec/rewrite.py) and plans the fusion (`_plan_fusion`);
2. the leaves that do not fuse (OR subtrees, columns in several groups
   or in a scheme other than narrow BITPACK / DICT, leaves past the fused
   kernel's capacity) are evaluated into the "rest mask"
   (exec/device.group_match: the ladder kernel for range-family leaves
   over BITPACK and DICT code planes, plain torch for the rest), ANDed
   with validity and the exclude / include words;
3. ONE fused scan kernel (ops/scan_kernels.py) runs every fused AND
   leaf's ladder on that mask and emits every fused aggregate's partials;
   aggregates that do not fuse run after it (exec/device.py: the popcount
   kernel for BITPACK and ALP sums, per-scheme decodes for the rest, a
   fixed pairwise order for keyform float sums);
4. the host combines the per-pack partials exactly with python ints (ALP
   sums as exact rationals, divided once);
5. with project=, the mask becomes a selection vector (ops/compact.py),
   each projected column is decoded to keyform limbs and gathered at it
   on the device, and only the selected rows cross to the host
   (`_materialize`; `scan_stream` does it one window of packs at a time).

Plans are cached on their full signature (segment shapes, the filter
tree, pruning decisions, aggregates, the fusion plan and the per-group
rewrite statics), so two queries share a plan only if they run the same
program; query literals stay runtime operands. Group-by and series calls
(`group_scan`, `series_scan`) run a mask-only scan plan first, then their
partials over that mask (`_group_parts`, `_series_parts`), which a
sharded scanner runs per shard (parallel/engine_spmd.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from fractions import Fraction

import numpy as np
import torch

from ..encode import schemes as S
from ..encode.schemes import Scheme
from ..ops import compact as CP
from ..ops import scan_kernels as SK
from ..ops import words as WD
from ..pack.stats import TriState, prune_leaf
from ..query.filter import Filter, Node
from ..types import FieldType, FilterMode
from ..utils import limbs as lb
from . import device as D
from . import rewrite as RW
from .rewrite import _dict_code_range_host, _mode_to_range_host

__all__ = ["AggSpec", "ScanResult", "SegmentScanner"]


@dataclass(frozen=True)
class AggSpec:
    op: str          # count | sum | min | max | avg
    field: str = ""  # unused for count


@dataclass
class ScanResult:
    count: int = 0
    aggs: dict = dc_field(default_factory=dict)    # (op, field) -> value
    rows: dict = dc_field(default_factory=dict)    # field -> np array
    row_ids: np.ndarray | None = None              # u64 segment-local rids
    stats: dict = dc_field(default_factory=dict)   # pruning info


def _tree_desc(node: Node, leaf_index: dict) -> tuple:
    """Static tree shape for the plan signature; assigns leaf indices."""
    if node.is_leaf:
        i = len(leaf_index)
        leaf_index[i] = node.filter
        return ("leaf", i, node.filter.field.name, int(node.filter.mode))
    return ("or" if node.or_ else "and",
            tuple(_tree_desc(c, leaf_index) for c in node.children))


class SegmentScanner:
    """Executes filter+aggregate plans against one DeviceSegment."""

    def __init__(self, dseg: D.DeviceSegment):
        self.d = dseg
        self._fns: dict = {}        # full plan signature -> plan fn
        self._plan_sigs: dict = {}  # id(plan fn) -> its full signature
        self._acache: dict = {}     # (tdesc, leaf values) -> device consts
        self._fused_ops: dict = {}  # kernel operand cache; keys:
        # bitpack (field, w, lo, hi) / dict (field, w, "dict", mode, value)

    # ------------------------------------------------------------ public --

    def prepare(self, tree: Node | None, aggs: list[AggSpec],
                exclude_words=None, include_words=None):
        """Plan (or fetch) the scan and build its arguments.

        exclude_words: optional packed u32[P, W] bitset of rows to EXCLUDE
        (journal tombstones). include_words: optional packed bitset
        RESTRICTING the scan (index rid pushdown). Either may be a numpy
        u32 array or an int32 word tensor. Returns (fn, args) with
        fn(*args) -> (mask int32[P, W], counts int32[P], agg parts)."""
        d = self.d
        leaves: dict[int, Filter] = {}
        tdesc = _tree_desc(tree, leaves) if tree is not None else ("true",)

        # upload cache: a repeated query re-uses the device copies of its
        # leaf constants and tri-state overrides
        akey = (tdesc, tuple(_leaf_cache_key(f) for f in leaves.values()))
        cached = self._acache.get(akey)
        if cached is not None:
            tri, consts, skip_leaf = cached
            return self._prepare_tail(tdesc, leaves, tri, consts,
                                      skip_leaf, aggs, exclude_words,
                                      include_words)

        # --- host: stats pruning + constant preparation per leaf ---
        tri, consts, skip_leaf = [], [], []
        for i in range(len(leaves)):
            f = leaves[i]
            t = self._leaf_tristate(f)
            tri.append(t)
            decided = bool((t.all_ | t.none).all())
            skip_leaf.append(decided)
            if decided:
                consts.append([])
                continue
            col = d.seg.columns[f.field.name]
            consts.append([RW.leaf_group_consts(f, col, g, d.device)
                           for g in d.column(f.field.name).groups])

        tri = [(torch.from_numpy(t.all_).to(d.device),
                torch.from_numpy(t.none).to(d.device)) for t in tri]
        if len(self._acache) < 256:
            self._acache[akey] = (tri, consts, skip_leaf)
        return self._prepare_tail(tdesc, leaves, tri, consts, skip_leaf,
                                  aggs, exclude_words, include_words)

    def _prepare_tail(self, tdesc, leaves, overrides, consts, skip_leaf,
                      aggs, exclude_words, include_words):
        d = self.d
        agg_fields = sorted({a.field for a in aggs if a.field})
        filter_fields = sorted({f.field.name for f in leaves.values()})
        used = sorted(set(agg_fields) | set(filter_fields))

        has_excl = exclude_words is not None
        has_incl = include_words is not None
        fuse = self._plan_fusion(tdesc, leaves, skip_leaf, aggs)
        sig = (d.sig(used), tdesc, tuple(skip_leaf), has_excl, has_incl,
               tuple((a.op, a.field) for a in aggs), fuse,
               tuple(RW.leaf_group_static(leaves[i], g)
                     for i in range(len(leaves)) if not skip_leaf[i]
                     for g in d.column(leaves[i].field.name).groups))
        fn = self._fns.get(sig)
        if fn is None:
            fn = self._build_fn(tdesc, leaves, skip_leaf, aggs, agg_fields,
                                fuse, has_excl, has_incl)
            self._fns[sig] = fn
        # dependent plans (group_scan, series_scan) key on the mask plan's
        # whole signature: two trees must never share one
        self._plan_sigs[id(fn)] = sig

        # fused kernel operands: per-plane select words bound on the HOST
        # per query (tiny numpy over P packs), appended as the trailing
        # consts entry and cached like every other leaf constant
        if fuse[0] == "multi":
            consts = list(consts) + [tuple(self._bind(leaves[i], f)
                                           for i, f in fuse[1])]
        else:
            consts = list(consts) + [self._bind(leaves[fuse[0]], fuse[1])]

        excl = tuple(self._words(w) for w in (exclude_words, include_words)
                     if w is not None)
        return fn, (d.arrays(used), consts, overrides, d.valid_words, excl)

    def _words(self, w) -> torch.Tensor:
        if isinstance(w, torch.Tensor):
            return w.to(self.d.device, torch.int32)
        return WD.to_words(np.asarray(w, np.uint32), self.d.device)

    def _bind(self, fl: Filter, fname: str):
        """(lo_bits, hi_bits, flags) device words for one fused leaf."""
        d = self.d
        g = d.column(fname).groups[0]
        fw = g.width
        if g.scheme == Scheme.DICT:
            # dict leaf: per-pack CODE ranges (dictionaries are sorted, so
            # value predicates are code ranges; misses and empties are the
            # inverted (1, 0) interval, which no row satisfies)
            vrep = fl.value_bytes if g.dict_bytes is not None \
                else (int(fl.key), int(getattr(fl, "key_hi", 0) or 0))
            if isinstance(vrep, list):
                vrep = tuple(vrep)
            okey = (fname, fw, "dict", fl.mode, vrep)
            ops = self._fused_ops.get(okey)
            if ops is None:
                lo_a, hi_a = _dict_code_range_host(fl, g)
                ops = SK.range_consts(np.zeros(g.npacks, np.uint64),
                                      lo_a, hi_a, fw)
        else:
            lo_v, hi_v = _mode_to_range_host(
                fl.mode, int(fl.key), int(getattr(fl, "key_hi", 0) or 0))
            okey = (fname, fw, lo_v, hi_v)
            ops = self._fused_ops.get(okey)
            if ops is None:
                ops = SK.range_consts(g.min_keys, np.uint64(lo_v),
                                      np.uint64(hi_v), fw)
        if not isinstance(ops[0], torch.Tensor):
            ops = tuple(WD.to_words(a, d.device) for a in ops)
            if len(self._fused_ops) < 1024:
                self._fused_ops[okey] = ops
        return ops

    def scan(self, tree: Node | None, aggs: list[AggSpec],
             project: list[str] | None = None, limit: int = 0,
             exclude_words=None, include_words=None) -> ScanResult:
        d = self.d
        fn, args = self.prepare(tree, aggs, exclude_words, include_words)
        mask_words, pack_counts, agg_parts = fn(*args)

        res = ScanResult()
        counts_np = pack_counts.cpu().numpy()
        res.count = int(counts_np.sum(dtype=np.int64))
        res.stats["packs_scanned"] = d.P
        res.stats["packs_matched"] = int((counts_np > 0).sum())
        self._combine_aggs(res, aggs, agg_parts)

        if project:
            cap = limit if limit else res.count
            cap = max(1, 1 << (max(0, cap - 1)).bit_length())
            cap = min(cap, d.P * d.N)
            self._materialize(res, mask_words, project, cap, limit)
        return res

    def scan_stream(self, tree: Node | None, project: list[str],
                    batch_packs: int = 64, exclude_words=None,
                    include_words=None):
        """Streaming scan: yields ScanResult row batches one window of
        batch_packs packs at a time. The filter runs once over the whole
        segment; each window then compacts and fetches only its own
        matches, so host memory stays bounded by the window."""
        d = self.d
        fn, args = self.prepare(tree, [], exclude_words, include_words)
        mask_words, pack_counts, _parts = fn(*args)
        counts = pack_counts.cpu().numpy()
        for s in range(0, d.P, batch_packs):
            e = min(s + batch_packs, d.P)
            n_win = int(counts[s:e].sum())
            if n_win == 0:
                continue
            win = torch.zeros_like(mask_words)
            win[s:e] = mask_words[s:e]
            res = ScanResult()
            res.count = n_win
            # pow2 cap: at most log2(P*N) distinct plan shapes
            cap = min(max(1, 1 << (n_win - 1).bit_length()), d.P * d.N)
            self._materialize(res, win, project, cap, 0)
            yield res

    # ---------------------------------------------------------- group-by --

    def group_scan(self, tree: Node | None, group_field: str,
                   agg_fields: list[str], exclude_words=None,
                   global_keys: np.ndarray | None = None, gplan=None,
                   minmax: bool = True):
        """Hash-aggregate: per-group (count, exact int sum, min, max) for
        each agg field. Returns (gplan, counts int64[G], {field: (sums
        object[G] of python ints, min u64[G], max u64[G])}), sums and
        extremes in keyform.

        The group domain comes from host metadata (dictionaries, zone
        maps); pass global_keys to align several segments on one domain.
        minmax=False runs the group kernel (ops/group_kernels.py) at every
        G, and min/max are then the empty sentinels (u64 max, 0);
        minmax=True runs exec/groupby.group_aggregate."""
        from . import groupby as GB
        d = self.d
        if not agg_fields:
            agg_fields = [group_field]   # count-only: aggregate the key
        if gplan is None:
            gplan = GB.plan_groups(d, group_field, global_keys)
        mask_fn, margs = self.prepare(tree, [], exclude_words)
        used = sorted(set([group_field] + list(agg_fields)))
        mode_tags = tuple(m[0] for m in gplan.mode)
        sig = ("group", d.sig(used), group_field, tuple(agg_fields),
               mode_tags, gplan.G, exclude_words is not None, minmax,
               self._plan_sigs[id(mask_fn)])
        gfn = self._fns.get(sig)
        if gfn is None:
            G = gplan.G

            def gfn(margs, gconsts):
                return self._group_parts(mask_fn(*margs)[0], gconsts,
                                         mode_tags, G, group_field,
                                         agg_fields, minmax)

            self._fns[sig] = gfn

        out = gfn(margs, GB.gid_consts(gplan, d.device))
        return (gplan, *self._group_collect(gplan, out, agg_fields, minmax))

    def _group_parts(self, mask, gconsts, mode_tags: tuple, G: int,
                     group_field: str, agg_fields: list[str],
                     minmax: bool) -> dict:
        """group_scan's device partials under a mask of this segment:
        {field: group_aggregate's outputs (minmax) or group_count_sum's}."""
        from . import groupby as GB
        gids = self._row_gids(group_field, mode_tags, gconsts)
        out = {}
        for f in agg_fields:
            if minmax:
                keys = self._decode_rows(f, D.group_decode_keys)
                out[f] = GB.group_aggregate(gids, mask, keys, G)
            else:
                pair = self._decode_rows(f, D.group_decode_halves)
                out[f] = GB.group_count_sum(gids, mask, pair, G)
        return out

    @staticmethod
    def _group_collect(gplan, out: dict, agg_fields: list[str],
                       minmax: bool):
        """group_scan's partials on the host: (counts, {field: (sums,
        min, max)})."""
        from . import groupby as GB
        results = {}
        counts = None
        for f in agg_fields:
            c, s_lo, s_hi = out[f][:3]
            if minmax:
                mn, mx = (WD.u64_from_ordered(t.cpu().numpy())
                          for t in out[f][3:])
            else:
                mn = np.full(gplan.G, 0xFFFFFFFFFFFFFFFF, np.uint64)
                mx = np.zeros(gplan.G, np.uint64)
            if counts is None:
                counts = c.cpu().numpy()
            results[f] = (GB.halves_sum(s_lo, s_hi), mn, mx)
        return counts, results

    def series_scan(self, tree: Node | None, time_field: str, kinds: dict,
                    gplan, exclude_words=None):
        """Per-bucket reducer partials for the series layer.

        kinds: {field: iterable from {"moments", "firstlast", "tsruns",
        "fminmax"}}. Returns {(field, kind): tuple of numpy arrays}:
          moments   -> (n int64[G], sum f64[G], sumsq f64[G])
          firstlast -> (first_ts, first_val, last_ts, last_val u64[G],
                        counts int64[G]); ts and integer values in keyform,
                        float values as raw float64 bits
          tsruns    -> the 14 arrays of exec/groupby.group_ts_runs, its
                        order-preserving outputs as u64 keyform
          fminmax   -> (n int64[G], min u64[G], max u64[G]) in the FLOAT
                        keyform (keyform packs stay integers; ALP packs
                        decode to float64 and map through f64_to_keyform)

        Moments of an integer field whose rebased zone-map range fits 32
        bits (exec/groupby.chunk_plan gives at most 4 byte chunks) are
        exact: r = key - gmin and its square run through the moments kernel
        in one pass, and the host recombines python-int sums (value = r +
        base, base = gmin - sign offset), cast to f64 once. Float fields
        and wider integers take exec/groupby.group_moments, whose float
        sums' low bits depend on the device.

        An ALP pack decodes as (enc + base) / 10^e, a true IEEE division in
        float64 by a divisor built on the host, which reproduces the
        encoder's round trip bit for bit."""
        from . import groupby as GB
        d = self.d
        kspec, meta, mplan = self._series_plan(kinds)
        mask_fn, margs = self.prepare(tree, [], exclude_words)
        used = sorted(set([time_field] + list(kinds)))
        mode_tags = tuple(m[0] for m in gplan.mode)
        sig = ("series", d.sig(used), time_field, kspec, mode_tags,
               gplan.G, exclude_words is not None, tuple(sorted(mplan)),
               self._plan_sigs[id(mask_fn)])
        sfn = self._fns.get(sig)
        if sfn is None:
            G = gplan.G

            def sfn(margs, gconsts, mbase):
                return self._series_parts(mask_fn(*margs)[0], gconsts,
                                          mode_tags, G, time_field, kspec,
                                          meta, mbase)

            self._fns[sig] = sfn

        out = sfn(margs, GB.gid_consts(gplan, d.device), mplan)
        return self._series_collect(out, meta, mplan)

    def _series_plan(self, kinds: dict):
        """(kspec, meta, mplan) of series_scan: the kinds per field in a
        fixed order; per field (signed bias, is_float); and the integer
        fields whose moments take the exact route, with their zone-map
        minimum."""
        from . import groupby as GB
        d = self.d
        fields = sorted(kinds)
        kspec = tuple((f, tuple(sorted(kinds[f]))) for f in fields)
        meta, mplan = {}, {}
        for f, fk in kspec:
            unknown = set(fk) - {"moments", "firstlast", "tsruns", "fminmax"}
            if unknown:
                raise ValueError(f"series_scan {f}: kinds {sorted(unknown)}")
            ft = d.seg.columns[f].field.type
            meta[f] = ((1 << (ft.bits - 1)) if ft.is_signed else 0,
                       ft.is_float)
            if "moments" in fk and not ft.is_float:
                n_chunks, gmin = GB.chunk_plan(d.seg.stats.fields.get(f))
                if n_chunks <= 4:
                    mplan[f] = gmin
        return kspec, meta, mplan

    def _series_parts(self, mask, gconsts, mode_tags: tuple, G: int,
                      time_field: str, kspec, meta: dict,
                      mplan: dict) -> dict:
        """series_scan's device partials under a mask of this segment:
        {(field, kind): tuple of tensors}."""
        from . import groupby as GB
        gids = self._row_gids(time_field, mode_tags, gconsts)
        ts_keys = None
        out = {}
        for f, fk in kspec:
            bias, is_float = meta[f]
            if is_float:
                vf = self._decode_f64(f)
                vk = vf.view(torch.int64)
            else:
                vf = None
                pair = self._decode_rows(f, D.group_decode_halves)
                vk = WD.bits_i64(*pair)
            if "fminmax" in fk:
                c, _lo, _hi, mn, mx = GB.group_aggregate(
                    gids, mask, self._decode_fkey(f, vf), G)
                out[(f, "fminmax")] = (c, mn, mx)
            if "moments" in fk and f in mplan:
                rlo, rhi = GB._value_halves(pair, mplan[f])
                out[(f, "moments")] = GB.group_moments_exact(
                    gids, mask, (rlo, rhi), GB.square_halves(rlo), G)
            elif "moments" in fk:
                out[(f, "moments")] = GB.group_moments(
                    gids, mask, vf if is_float else vk, G, bias, is_float)
            if ts_keys is None and ("firstlast" in fk or "tsruns" in fk):
                ts_keys = self._decode_rows(time_field, D.group_decode_keys)
            if "firstlast" in fk:
                out[(f, "firstlast")] = GB.group_first_last(
                    gids, mask, ts_keys, vk, G)
            if "tsruns" in fk:
                out[(f, "tsruns")] = GB.group_ts_runs(
                    gids, mask, ts_keys, vk, G, bias)
        return out

    @staticmethod
    def exact_moments(counts: np.ndarray, s_r, s_q, gmin: int, bias: int):
        """(n, sum, sumsq) of the exact moments route from the counts and
        the python-int sums of r = key - gmin and of r^2: value = r + base,
        base = gmin - bias, cast to f64 once."""
        base = gmin - bias
        no = counts.astype(object)
        return (counts, (base * no + s_r).astype(np.float64),
                (no * (base * base) + (2 * base) * s_r + s_q)
                .astype(np.float64))

    @classmethod
    def _series_collect(cls, out: dict, meta: dict, mplan: dict) -> dict:
        """series_scan's partials on the host, in the documented forms."""
        from . import groupby as GB

        def ordered(t):
            return WD.u64_from_ordered(t.cpu().numpy())

        def bits(t):
            return t.cpu().numpy().view(np.uint64)

        res = {}
        for (f, kind), v in out.items():
            if kind == "moments" and f in mplan:
                c, sr_lo, sr_hi, sq_lo, sq_hi = v
                res[(f, kind)] = cls.exact_moments(
                    c.cpu().numpy(), GB.halves_sum(sr_lo, sr_hi),
                    GB.halves_sum(sq_lo, sq_hi), mplan[f], meta[f][0])
            elif kind == "moments":
                res[(f, kind)] = tuple(t.cpu().numpy() for t in v)
            elif kind == "fminmax":
                res[(f, kind)] = (v[0].cpu().numpy(), ordered(v[1]),
                                  ordered(v[2]))
            elif kind == "firstlast":
                res[(f, kind)] = (ordered(v[0]), bits(v[1]), ordered(v[2]),
                                  bits(v[3]), v[4].cpu().numpy())
            else:
                # tsruns: ts, int_min and int_max are order-preserving,
                # the limb sums plain bits, the rest int64 / float64
                conv = {1: ordered, 5: ordered, 9: ordered, 10: ordered,
                        3: bits, 4: bits, 7: bits, 8: bits}
                res[(f, kind)] = tuple(
                    conv[i](t) if i in conv else t.cpu().numpy()
                    for i, t in enumerate(v))
        return res

    def _decode_f64(self, fname: str) -> torch.Tensor:
        """A float column as float64 VALUES [P, N]: ALP packs through
        their pack's base and exponent, the others from their keyform."""
        ft = self.d.seg.columns[fname].field.type

        def one(g, W):
            lo, hi = D.group_decode_halves(g, W)
            if g.scheme != Scheme.ALP:
                return D.keyform_to_float(lo, hi, ft).to(torch.float64)
            base = torch.tensor([float(b) for b in g.bases],
                                dtype=torch.float64, device=lo.device)
            scale = torch.tensor([10.0 ** e for e in g.exps],
                                 dtype=torch.float64, device=lo.device)
            enc = WD.bits_i64(lo, hi).to(torch.float64)
            return (enc + base[:, None]) / scale[:, None]
        return self._decode_rows(fname, one)

    def _decode_fkey(self, fname: str, vf) -> torch.Tensor:
        """A float column as order-preserving int64 keys of its FLOAT
        keyform [P, N]: keyform packs pass through as integers (no float
        round trip); a column with ALP packs maps its decoded values vf."""
        from . import groupby as GB
        if any(g.scheme == Scheme.ALP for g in self.d.column(fname).groups):
            return GB.f64_to_keyform(vf) ^ WD.I64_MIN
        return self._decode_rows(fname, D.group_decode_keys)

    def _over_packs(self, fn, dim: int = 0):
        """fn(d, lo, hi) -> a tensor or tuple of tensors over packs [lo,
        hi) of the device segment d, their pack axis at `dim`. Here one
        call over the whole segment; a sharded scanner calls it once per
        shard on the shard's own segment and joins the results in pack
        order (parallel/engine_spmd.py)."""
        return fn(self.d, 0, self.d.P)

    def _decode_rows(self, fname: str, dec):
        """One column decoded over the whole segment: dec(group, W) ->
        tensor or tuple of tensors [Pg, N] per device group, scattered
        into [P, N] where the column has several groups."""
        return self._over_packs(lambda d, lo, hi: _decode_rows_of(d, fname,
                                                                  dec))

    def _row_gids(self, field: str, mode_tags: tuple, gconsts):
        """exec/groupby.row_gids over the whole segment."""
        from . import groupby as GB
        d = self.d
        return GB.row_gids(mode_tags, d.column(field).groups, gconsts, d.P,
                           d.W)

    # ---------------------------------------------------------- planning --

    def _leaf_tristate(self, f: Filter) -> TriState:
        st = self.d.seg.stats
        if f.mode == FilterMode.TRUE:
            return TriState(np.ones(self.d.P, bool), np.zeros(self.d.P, bool))
        if f.mode == FilterMode.FALSE:
            return TriState(np.zeros(self.d.P, bool), np.ones(self.d.P, bool))
        fs = st.fields.get(f.field.name)
        if fs is None:
            return TriState.unknown(self.d.P)
        kb = None
        if f.field.type.is_bytes_like and f.mode in (
                FilterMode.EQ, FilterMode.IN):
            vb = f.value_bytes
            kb = vb if isinstance(vb, list) else [vb]
        return prune_leaf(fs, f.mode, lo=f.key, hi=f.key_hi, keys=f.keys,
                          key_limbs=None if kb else f.key_limbs,
                          key_bytes=kb)

    _FUSED_MODES = (FilterMode.RANGE, FilterMode.GT, FilterMode.GE,
                    FilterMode.LT, FilterMode.LE, FilterMode.EQ)

    def _fusable_col(self, fname: str, leaf_ok: bool = False):
        """Single-group full-coverage column whose planes the fused kernels
        can consume -> its device group, else None. Aggregates need narrow
        BITPACK value planes; LEAVES (leaf_ok=True) may also be DICT
        groups, whose code planes compare against per-pack code ranges."""
        d = self.d
        col = d.seg.columns.get(fname)
        if col is None or col.field.type.is_float or col.wide:
            return None
        dcol = d.column(fname)
        if len(dcol.groups) != 1 or dcol.groups[0].npacks != d.P:
            return None
        g = dcol.groups[0]
        if g.scheme == Scheme.BITPACK:
            return g
        if leaf_ok and g.scheme == Scheme.DICT and g.width > 0:
            return g
        return None

    def _plan_fusion(self, tdesc, leaves, skip_leaf, aggs):
        """Plan the fused scan kernel. Every scan runs one kernel: every
        fusable top-level AND leaf and every fusable aggregate ride it, up
        to the kernel's capacity (ops/scan_kernels.MAX_*); what does not
        fit, or does not fuse, stays in the rest mask or runs after the
        kernel. The plan depends only on the segment and the query, so
        the CPU runs the plan the card runs. Returns (leaf_i, field) for
        the one-leaf sum kernel (config #1's shape), else
        ("multi", ((leaf_i, field), ...), (fields...),
        ((field, want_sum, want_mm), ...))."""
        if tdesc[0] == "leaf":
            top_leaves = [tdesc]
        elif tdesc[0] == "and":
            top_leaves = [c for c in tdesc[1] if c[0] == "leaf"]
        else:
            top_leaves = []
        # fusable aggregate wants, in agg order: field -> [sum, minmax]
        agg_want: dict[str, list] = {}
        for a in aggs:
            if not a.field or self._fusable_col(a.field) is None:
                continue
            if a.op in ("sum", "avg"):
                agg_want.setdefault(a.field, [False, False])[0] = True
            elif a.op in ("min", "max"):
                agg_want.setdefault(a.field, [False, False])[1] = True

        def width_of(fname):
            return self._fusable_col(fname, leaf_ok=True).width

        fusable = [(c[1], c[2]) for c in top_leaves
                   if not skip_leaf[c[1]]
                   and FilterMode(c[3]) in self._FUSED_MODES
                   and self._fusable_col(c[2], leaf_ok=True) is not None]

        # aggregate columns first (each saves a second pass over its
        # planes), then leaves widest-first, within the kernel capacity
        fields: list[str] = []
        aspec = []
        for f, (ws, wm) in agg_want.items():
            if len(fields) < SK.MAX_FIELDS and len(aspec) < SK.MAX_SPECS:
                fields.append(f)
                aspec.append((f, ws, wm))
        entries = []
        for i, fname in sorted(fusable, key=lambda e: -width_of(e[1])):
            if len(entries) == SK.MAX_LEAVES:
                break
            if fname not in fields:
                if len(fields) == SK.MAX_FIELDS:
                    continue
                fields.append(fname)
            entries.append((i, fname))
        if len(entries) == 1 and aspec == [(entries[0][1], True, False)]:
            return entries[0]
        entries.sort()
        return ("multi", tuple(entries), tuple(fields), tuple(aspec))

    @staticmethod
    def _drop_leaves(desc, idxs):
        if desc[0] == "leaf":
            return ("true",) if desc[1] in idxs else desc
        if desc[0] == "and":
            return ("and", tuple(SegmentScanner._drop_leaves(c, idxs)
                                 for c in desc[1]))
        return desc

    def _build_fn(self, tdesc, leaves, skip_leaf, aggs, agg_fields, fuse,
                  has_excl, has_incl):
        d = self.d
        W = d.W
        leaf_groups = {i: d.column(f.field.name).groups
                       for i, f in leaves.items() if not skip_leaf[i]}
        agg_groups = {name: d.column(name).groups for name in agg_fields}
        agg_specs = [(a.op, a.field) for a in aggs]
        float_types = {name: d.seg.columns[name].field.type
                       for name in agg_fields
                       if d.seg.columns[name].field.type.is_float}

        if fuse[0] == "multi":
            _tag, f_entries, f_fields, f_aspec = fuse
            f_slots = tuple(f_fields.index(f) for _i, f in f_entries)
            f_widths = tuple(d.column(f).groups[0].width for f in f_fields)
            f_specs = tuple((f_fields.index(f), ws, wm)
                            for f, ws, wm in f_aspec)
            tdesc_rest = self._drop_leaves(
                tdesc, frozenset(i for i, _f in f_entries))
        else:
            fuse_i, fuse_f = fuse
            fuse_width = d.column(fuse_f).groups[0].width
            tdesc_rest = self._drop_leaves(tdesc, frozenset((fuse_i,)))

        def eval_node(desc, consts, overrides, valid):
            kind = desc[0]
            if kind == "true":
                return torch.full_like(valid, WD.FULL)
            if kind == "leaf":
                i, mode = desc[1], FilterMode(desc[3])
                all_, none = overrides[i]
                if skip_leaf[i]:
                    return torch.zeros_like(valid).masked_fill_(
                        all_[:, None], WD.FULL)
                groups = leaf_groups[i]
                if len(groups) == 1 and groups[0].npacks == d.P:
                    full = D.group_match(groups[0], mode, consts[i][0], W)
                else:
                    full = torch.zeros_like(valid)
                    for g, c in zip(groups, consts[i]):
                        full[g.idx_t] = D.group_match(g, mode, c, W)
                full = full.masked_fill(all_[:, None], WD.FULL)
                return full.masked_fill(none[:, None], 0)
            kids = [eval_node(c, consts, overrides, valid) for c in desc[1]]
            out = kids[0]
            for k in kids[1:]:
                out = (out | k) if kind == "or" else (out & k)
            return out

        def fn(arrays, consts, overrides, valid, excl=()):
            rest = eval_node(tdesc_rest, consts, overrides, valid) & valid
            if has_excl:
                rest = rest & ~excl[0]
            if has_incl:
                rest = rest & excl[1 if has_excl else 0]
            fused_sum, fused_mm = {}, {}
            if fuse[0] == "multi":
                planes_list = [arrays[f][0]["planes"] for f in f_fields]
                mask, cnt, fparts = SK.fused_tree_agg(
                    planes_list, consts[-1], f_slots, rest, f_widths,
                    f_specs)
                for (fname, _ws, _wm), part in zip(f_aspec, fparts):
                    if "pcnt" in part:
                        fused_sum[fname] = {"pcnt": part["pcnt"], "cnt": cnt}
                    if "mnmx" in part:
                        fused_mm[fname] = {"mnmx": part["mnmx"], "cnt": cnt}
            else:
                lo_b, hi_b, flags = consts[-1]
                mask, pcnt, cnt = SK.fused_range_sum_masked(
                    arrays[fuse_f][0]["planes"], lo_b, hi_b, flags, rest,
                    fuse_width)
                fused_sum[fuse_f] = {"pcnt": pcnt, "cnt": cnt}
            parts = []
            for op, fname in agg_specs:
                if op == "count" or not fname:
                    parts.append(None)
                elif op in ("sum", "avg") and fname in fused_sum:
                    parts.append([fused_sum[fname]])
                elif op in ("min", "max") and fname in fused_mm:
                    parts.append([fused_mm[fname]])
                elif op in ("sum", "avg", "min", "max"):
                    col_parts = []
                    for g in agg_groups[fname]:
                        gmask = mask if g.npacks == d.P else mask[g.idx_t]
                        if op in ("min", "max"):
                            col_parts.append(D.group_masked_minmax(g, gmask))
                        elif fname in float_types \
                                and g.scheme != Scheme.ALP:
                            col_parts.append(D.group_masked_sum_float(
                                g, gmask, float_types[fname]))
                        else:
                            col_parts.append(D.group_masked_sum(g, gmask))
                    parts.append(col_parts)
                else:
                    raise ValueError(f"agg op {op}")
            return mask, cnt, parts

        return fn

    # --------------------------------------------------- materialization --

    def _materialize(self, res: ScanResult, mask_words, project, cap, limit):
        """Selection vector of the mask at capacity cap, then each
        projected column decoded to keyform limbs (bytes columns: their
        dictionary codes) and gathered at it on the device; only the
        first min(count, limit, cap) rows cross to the host, which maps
        them to values."""
        d = self.d
        sig = ("mat", d.sig(project), cap)
        fn = self._fns.get(sig)
        if fn is None:
            bytes_cols = {name for name in project
                          if d.seg.columns[name].field.type.is_bytes_like}

            def codes_of(g, W):
                return S.decode_bitplanes_u32(g.arrays["planes"], g.width)

            def limbs_of(g, W):
                return tuple(D.group_decode_limbs(g, W))

            def fn(mask):
                idx, count = CP.packed_mask_to_indexes(mask, cap)
                outs = {}
                for name in project:
                    if name in bytes_cols:
                        codes = self._decode_rows(name, codes_of)
                        outs[name] = CP.take_rows(codes.reshape(1, -1), idx)
                        continue
                    dec = torch.stack(self._decode_rows(name, limbs_of))
                    outs[name] = CP.take_rows(dec.reshape(dec.shape[0], -1),
                                              idx)
                return idx, count, outs

            self._fns[sig] = fn

        idx, count, outs = fn(mask_words)
        n = int(count) if not limit else min(int(count), limit)
        n = min(n, cap)
        idx_np = WD.from_words(idx[:n])
        res.row_ids = idx_np.astype(np.uint64)
        for name in project:
            col = d.seg.columns[name]
            limbs = WD.from_words(outs[name][:, :n])
            if col.field.type.is_bytes_like:
                res.rows[name] = self._bytes_values(col, limbs[0], idx_np)
            elif col.wide:
                res.rows[name] = self._wide_values(col, limbs, idx_np)
            elif any(p.scheme == Scheme.ALP for p in col.packs):
                res.rows[name] = self._float_alp_values(col, limbs, idx_np)
            else:
                res.rows[name] = lb.from_keyform(limbs, col.field.type)

    def _bytes_values(self, col, codes: np.ndarray, idx_np: np.ndarray):
        """Code rows -> byte values via the per-pack host dictionaries,
        one fancy-index per pack (idx // N gives each row's pack)."""
        N = self.d.N
        as_str = col.field.type == FieldType.STRING
        n = len(codes)
        out = np.empty(n, object)
        packs = (idx_np[:n] // N).astype(np.int64)
        cd = codes.astype(np.int64)
        for p in np.unique(packs):
            ep = col.packs[int(p)]
            # decoded-dict cache on the pack: repeated projections of the
            # same pack pay the dict decode once
            key = "_mat_dict_str" if as_str else "_mat_dict_bytes"
            arr = getattr(ep, key, None)
            if arr is None:
                arr = np.empty(len(ep.dict_bytes), object)
                arr[:] = [b.decode() for b in ep.dict_bytes] if as_str \
                    else ep.dict_bytes
                try:
                    setattr(ep, key, arr)
                except AttributeError:
                    pass                      # slotted/frozen pack: skip
            m = packs == p
            out[m] = arr[cd[m]]
        return out

    def _float_alp_values(self, col, limbs: np.ndarray, idx_np: np.ndarray):
        """FLOAT64 rows from mixed ALP / keyform packs. ALP rows arrive as
        their pack-relative enc in two limbs; enc stays below 2^52, so the
        float64 add and numpy's correctly rounded divide reproduce the
        encoder's round trip exactly."""
        N = self.d.N
        n = limbs.shape[1]
        out = np.empty(n, np.float64)
        packs = (idx_np[:n] // N).astype(np.int64)
        k64 = WD.join_u64(limbs[1], limbs[0])
        for p in np.unique(packs):
            ep = col.packs[int(p)]
            m = packs == p
            if ep.scheme == Scheme.ALP:
                out[m] = (np.float64(ep.min_key)
                          + k64[m].astype(np.float64)) / (10.0 ** ep.exp)
            else:
                out[m] = lb.from_keyform(
                    np.stack([limbs[0][m], limbs[1][m]]), col.field.type)
        return out

    def _wide_values(self, col, limbs: np.ndarray, idx_np: np.ndarray):
        """Recombine wide rows: the device limbs hold either full RAW /
        CONST keyform limbs or (zeros..., hi, lo) pack-relative keys that
        need their pack's python-int base."""
        ft = col.field.type
        N = self.d.N
        n = limbs.shape[1]
        bias = 1 << (ft.bits - 1) if ft.is_signed else 0
        out = np.empty(n, object)
        packs = (idx_np[:n] // N).astype(np.int64)
        # object-int vector arithmetic: exact at any width, no row loop
        rel = (limbs[-2].astype(object) << 32) | limbs[-1].astype(object)
        for p in np.unique(packs):
            ep = col.packs[int(p)]
            m = packs == p
            if ep.scheme == Scheme.BITPACK:
                out[m] = rel[m] + (col.wide_bases[int(p)] - bias)
            else:
                v = np.zeros(int(m.sum()), object)
                for l in range(limbs.shape[0]):
                    v = (v << 32) | limbs[l][m].astype(object)
                out[m] = v - bias
        return out

    # ------------------------------------------------------ host combine --

    def _combine_aggs(self, res: ScanResult, aggs, agg_parts):
        for spec, part in zip(aggs, agg_parts):
            key = (spec.op, spec.field)
            if spec.op == "count":
                res.aggs[key] = res.count
                continue
            col = self.d.seg.columns[spec.field]
            ft = col.field.type
            groups = self.d.column(spec.field).groups
            if spec.op in ("sum", "avg"):
                total, cnt = self._combine_sum(part, groups, ft, col)
                if spec.op == "sum":
                    res.aggs[key] = total
                else:
                    res.aggs[key] = (total / cnt) if cnt else None
            else:
                res.aggs[key] = self._combine_minmax(part, groups, ft,
                                                     spec.op == "min", col)

    @staticmethod
    def _combine_sum(parts, groups, ft: FieldType, col=None):
        """The keyform sum over every group's per-pack partials (the forms
        of exec/device.group_masked_sum), in python ints, then the signed
        keyform bias: Σ_p 2^p·pcnt[:, p] plus min_key (or the wide base)
        times the count; the pack value times the count; per-limb sums
        weighted by 2^32 per limb; lo + 2^32·hi. Float columns: ALP packs
        give exact rationals (enc sum / 10^e), keyform packs the device's
        pairwise float sums; one division and one addition round."""
        if ft.is_float:
            return SegmentScanner._combine_sum_float(parts, groups)
        total = 0
        cnt = 0
        for part, g in zip(parts, groups):
            c = part["cnt"].cpu().numpy().astype(object)
            cnt += int(c.sum())
            if "pcnt" in part:
                pc = part["pcnt"].cpu().numpy().astype(object)
                weights = np.array([1 << p for p in range(pc.shape[1])],
                                   object)
                total += int((pc * weights[None, :]).sum())
                base = np.array(g.bases, object) if g.wide \
                    else g.min_keys.astype(object)
                total += int((base * c).sum())
            elif "limb_sums" in part:
                sums = part["limb_sums"].cpu().numpy().astype(object)
                L = sums.shape[0]
                for l in range(L):
                    total += int(sums[l].sum()) << (32 * (L - 1 - l))
            elif "lo" in part:
                total += int(part["lo"].cpu().numpy().astype(object).sum())
                total += int(part["hi"].cpu().numpy().astype(object)
                             .sum()) << 32
            else:                                   # CONST packs
                total += sum(RW._pack_const_value(col, g, j) * int(c[j])
                             for j in np.flatnonzero(c))
        if ft.is_signed:
            total -= cnt << (ft.bits - 1)
        return total, cnt

    @staticmethod
    def _combine_sum_float(parts, groups):
        frac = Fraction(0)
        fl = 0.0
        any_frac = False
        cnt = 0
        for part, g in zip(parts, groups):
            c = part["cnt"].cpu().numpy()
            cnt += int(c.sum())
            if g.scheme == Scheme.ALP:
                pc = part["pcnt"].cpu().numpy().astype(object)
                weights = np.array([1 << p for p in range(pc.shape[1])],
                                   object)
                rel = (pc * weights[None, :]).sum(axis=1)
                for j in range(len(c)):
                    enc = int(rel[j]) + g.bases[j] * int(c[j])
                    frac += Fraction(enc, 10 ** g.exps[j])
                any_frac = True
            else:
                fl += float(part["fsum"].cpu().numpy().sum())
        if any_frac and fl == 0.0:
            return float(frac), cnt       # the fully exact path
        return (float(frac) + fl if any_frac else fl), cnt

    @staticmethod
    def _combine_minmax(parts, groups, ft: FieldType, want_min: bool,
                        col=None):
        """The best value over every non-empty pack's winner (the forms of
        exec/device.group_masked_minmax), in the native domain; None when
        nothing matched."""
        best = None
        mcol = (0, 1) if want_min else (2, 3)
        for part, g in zip(parts, groups):
            c = part["cnt"].cpu().numpy()
            hit = np.flatnonzero(c)
            if g.scheme == Scheme.ALP:
                # pack-relative enc halves; the python-int division by 10^e
                # is the exact decode
                mm = WD.from_words(part["mnmx"])
                for j in hit:
                    rel = int(mm[j, mcol[0]]) | (int(mm[j, mcol[1]]) << 32)
                    v = (g.bases[j] + rel) / (10 ** g.exps[j])
                    if best is None or (v < best if want_min else v > best):
                        best = v
                continue
            if "mnmx" in part:
                mm = WD.from_words(part["mnmx"])
                keys = [(int(mm[j, mcol[0]]) | (int(mm[j, mcol[1]]) << 32))
                        + (int(g.bases[j]) if g.wide else int(g.min_keys[j]))
                        for j in hit]
            elif "mn_limbs" in part:
                src = WD.from_words(part["mn_limbs" if want_min
                                         else "mx_limbs"])
                keys = []
                for j in hit:
                    k = 0
                    for l in range(src.shape[0]):
                        k = (k << 32) | int(src[l, j])
                    keys.append(k)
            elif "mn" in part:
                src = WD.u64_from_ordered(
                    part["mn" if want_min else "mx"].cpu().numpy())
                keys = [int(src[j]) for j in hit]
            else:                                   # CONST packs
                keys = [RW._pack_const_value(col, g, j) for j in hit]
            for k in keys:
                v = _key_to_value(k, ft)
                if best is None or (v < best if want_min else v > best):
                    best = v
        return best


def _decode_rows_of(d: D.DeviceSegment, fname: str, dec):
    """SegmentScanner._decode_rows over the device segment d."""
    groups = d.column(fname).groups
    if len(groups) == 1 and groups[0].npacks == d.P:
        return dec(groups[0], d.W)
    full = None
    for g in groups:
        part = dec(g, d.W)
        parts = part if isinstance(part, tuple) else (part,)
        if full is None:
            full = [p.new_zeros((d.P, d.N)) for p in parts]
        for f_, p in zip(full, parts):
            f_[g.idx_t] = p
    return tuple(full) if isinstance(part, tuple) else full[0]


def _leaf_cache_key(f: Filter) -> tuple:
    """Hashable EXACT identity of a leaf's constants for the upload cache,
    built from the canonical keyform attributes (never repr(), which
    truncates long arrays and would collide two queries)."""
    ks = getattr(f, "keys", None)
    if ks is not None:
        ks = tuple(int(k) for k in ks)
    vb = getattr(f, "value_bytes", None)
    if vb is not None:
        if hasattr(vb, "pattern"):              # compiled REGEXP
            vb = ("re", vb.pattern)
        elif isinstance(vb, (list, tuple, np.ndarray)):
            vb = tuple(bytes(x) for x in vb)
        else:
            vb = bytes(vb)
    return (f.field.name, int(f.mode),
            getattr(f, "key", None), getattr(f, "key_hi", None), ks, vb)


def _key_to_value(key: int, ft: FieldType):
    """Keyform python int -> native value."""
    if ft.is_float:
        return float(lb.keyform_to_scalar(_split_limbs(key, ft.nlimbs), ft))
    if ft.is_signed:
        return key - (1 << (ft.bits - 1))
    return key


def _split_limbs(key: int, L: int) -> tuple:
    out = []
    for l in range(L - 1, -1, -1):
        out.append((key >> (32 * l)) & 0xFFFFFFFF)
    return tuple(out)
