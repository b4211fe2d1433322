"""Segment scan executor: filter tree + aggregates -> one fused kernel.

The port of knoxdb_tpu/exec/scan.py (prepare / plan / scan / combine).
Per query:

1. the host prunes packs by zone maps (pack/stats.py) into per-pack
   ALL/NONE tri-states, rewrites every leaf into per-group device
   constants (exec/rewrite.py) and plans the fusion (`_plan_fusion`);
2. the leaves that do not fuse are evaluated into the "rest mask"
   (exec/device.group_match), ANDed with validity and the exclude /
   include words;
3. ONE fused scan kernel (ops/scan_kernels.py) runs every fused AND
   leaf's ladder on that mask and emits every fused aggregate's partials;
   aggregates that do not fuse run after it (exec/device.py);
4. the host combines the per-pack partials exactly with python ints.

Plans are cached on their full signature (segment shapes, the filter
tree, pruning decisions, aggregates, the fusion plan and the per-group
rewrite statics), so two queries share a plan only if they run the same
program; query literals stay runtime operands.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..encode.schemes import Scheme
from ..ops import scan_kernels as SK
from ..ops import words as WD
from ..pack.stats import TriState, prune_leaf
from ..query.filter import Filter, Node
from ..types import FieldType, FilterMode
from ..utils import limbs as lb
from . import device as D
from . import rewrite as RW

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
        if project:
            raise NotImplementedError(
                "row materialization (project=) is not ported yet: "
                "ROADMAP.md queue 1 item 5")
        d = self.d
        fn, args = self.prepare(tree, aggs, exclude_words, include_words)
        _mask, pack_counts, agg_parts = fn(*args)

        res = ScanResult()
        counts_np = pack_counts.cpu().numpy()
        res.count = int(counts_np.sum(dtype=np.int64))
        res.stats["packs_scanned"] = d.P
        res.stats["packs_matched"] = int((counts_np > 0).sum())
        self._combine_aggs(res, aggs, agg_parts)
        return res

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
                    agg = D.group_masked_sum if op in ("sum", "avg") \
                        else D.group_masked_minmax
                    parts.append([agg(g, mask if g.npacks == d.P
                                      else mask[g.idx_t])
                                  for g in agg_groups[fname]])
                else:
                    raise ValueError(f"agg op {op}")
            return mask, cnt, parts

        return fn

    # ------------------------------------------------------ host combine --

    def _combine_aggs(self, res: ScanResult, aggs, agg_parts):
        for spec, part in zip(aggs, agg_parts):
            key = (spec.op, spec.field)
            if spec.op == "count":
                res.aggs[key] = res.count
                continue
            ft = self.d.seg.columns[spec.field].field.type
            groups = self.d.column(spec.field).groups
            if spec.op in ("sum", "avg"):
                total, cnt = self._combine_sum(part, groups, ft)
                if spec.op == "sum":
                    res.aggs[key] = total
                else:
                    res.aggs[key] = (total / cnt) if cnt else None
            else:
                res.aggs[key] = self._combine_minmax(part, groups, ft,
                                                     spec.op == "min")

    @staticmethod
    def _combine_sum(parts, groups, ft: FieldType):
        """Σ_p 2^p·pcnt[:, p] + min_key·count per pack, in python ints,
        then the signed keyform bias."""
        if ft.is_float:
            raise NotImplementedError(
                "float sums are not ported yet: ROADMAP.md queue 1 item 4")
        total = 0
        cnt = 0
        for part, g in zip(parts, groups):
            pc = part["pcnt"].cpu().numpy().astype(object)
            c = part["cnt"].cpu().numpy().astype(np.int64)
            weights = np.array([1 << p for p in range(pc.shape[1])], object)
            total += int((pc * weights[None, :]).sum())
            total += int((g.min_keys.astype(object) * c.astype(object)).sum())
            cnt += int(c.sum())
        if ft.is_signed:
            total -= cnt << (ft.bits - 1)
        return total, cnt

    @staticmethod
    def _combine_minmax(parts, groups, ft: FieldType, want_min: bool):
        """Pack-relative u32 halves + min_key per non-empty pack -> the
        best value in the native domain (None when nothing matched)."""
        best = None
        col = (0, 1) if want_min else (2, 3)
        for part, g in zip(parts, groups):
            mm = WD.from_words(part["mnmx"])
            c = part["cnt"].cpu().numpy()
            for j in np.flatnonzero(c):
                rel = int(mm[j, col[0]]) | (int(mm[j, col[1]]) << 32)
                v = _key_to_value(rel + int(g.min_keys[j]), ft)
                if best is None or (v < best if want_min else v > best):
                    best = v
        return best


def _dict_code_range_host(leaf, g):
    """Per-pack inclusive CODE ranges for a DICT-group leaf of the fused
    kernel; it must agree predicate by predicate with
    exec/rewrite._dict_consts*, which serve the rest mask. Dictionaries
    are sorted, so EQ/LT/LE/GT/GE/RANGE map to half-open code intervals
    via bisect. Empty intervals (incl. EQ misses) encode as the inverted
    pair (1, 0): the ladders then require code >= 1 AND code <= 0, which
    no row satisfies. Returns (lo u64[P], hi u64[P])."""
    P = g.npacks
    lo = np.zeros(P, np.uint64)
    hi = np.zeros(P, np.uint64)
    m = leaf.mode
    is_bytes = g.dict_bytes is not None
    for j in range(P):
        if is_bytes:
            dk = g.dict_bytes[j]
            v = leaf.value_bytes
            v0, v1 = (v[0], v[1]) if m == FilterMode.RANGE else (v, v)
            lb_ = lambda x: bisect.bisect_left(dk, x)      # noqa: E731
            ub_ = lambda x: bisect.bisect_right(dk, x)     # noqa: E731
        else:
            dk = g.dict_keys[j]
            v0 = np.uint64(int(leaf.key))
            v1 = np.uint64(int(getattr(leaf, "key_hi", 0) or 0)) \
                if m == FilterMode.RANGE else v0
            lb_ = lambda x: int(np.searchsorted(dk, x, "left"))   # noqa: E731
            ub_ = lambda x: int(np.searchsorted(dk, x, "right"))  # noqa: E731
        card = len(dk)
        if m == FilterMode.EQ:
            l, h = lb_(v0), ub_(v0)            # [pos, pos+1) or empty
        elif m == FilterMode.LT:
            l, h = 0, lb_(v0)
        elif m == FilterMode.LE:
            l, h = 0, ub_(v0)
        elif m == FilterMode.GT:
            l, h = ub_(v0), card
        elif m == FilterMode.GE:
            l, h = lb_(v0), card
        elif m == FilterMode.RANGE:
            l, h = lb_(v0), ub_(v1)
        else:
            raise ValueError(f"_dict_code_range_host: {m}")
        if h <= l:
            lo[j], hi[j] = 1, 0                # universally empty
        else:
            lo[j], hi[j] = l, h - 1
    return lo, hi


def _mode_to_range_host(mode: FilterMode, lo: int, hi: int):
    """Inclusive u64 (lo, hi) of a fusable mode. Strict modes adjust by one
    key; boundary wraps (GT u64max, LT 0) map to the universally-empty
    range (1, 0)."""
    U = (1 << 64) - 1
    if mode == FilterMode.RANGE:
        return lo, hi
    if mode == FilterMode.EQ:
        return lo, lo
    if mode == FilterMode.GE:
        return lo, U
    if mode == FilterMode.LE:
        return 0, lo
    if mode == FilterMode.GT:
        return (1, 0) if lo == U else (lo + 1, U)
    if mode == FilterMode.LT:
        return (1, 0) if lo == 0 else (0, lo - 1)
    raise ValueError(f"_mode_to_range_host: {mode}")


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
