"""Time-series aggregation: bucketed reducers with fill modes (carried over from
knoxdb_tpu/series.py).

Analog of the reference's reducer + series layer
(internal/reducer/reducer.go:24-48, fill.go,
pkg/series/series.go:21-60): a request with a time range, interval,
aggregate set and fill mode runs as ONE device group-scan where
gid = (ts - t0) // interval (exec/groupby.py bucket mode), then fills
empty buckets on the host (none | null | zero | last | linear).

Reducers (full reference surface, reducer.go:24-48):
- count, sum, min, max, mean: exact integer paths (split-limb device
  partials, python-int host combine).
- first, last: value at the smallest/largest timestamp in the bucket
  (device kernel exec/groupby.group_first_last; ties resolve to row
  order — segment order, then journal — matching the reference's
  stream-arrival semantics for time-ordered data).
- var, std: SAMPLE variance/stddev (n-1 denominator, NaN below n=2,
  reducer.go:352-427). FLOAT CONTRACT: computed from f64 moments of
  bias-centered values; exact for |value| < 2^53, else rounded like the
  reference's own float64 Welford accumulators.
- first_join, last_join, min_join, max_join, mean_join, var_join,
  std_join: rows sharing one timestamp are summed, then the base
  reducer applies to the per-timestamp sums (reducer.go:460-700).
  Device kernel exec/groupby.group_ts_runs coalesces runs per segment;
  equal-timestamp runs ACROSS segments/journal are merged exactly on
  the host via per-bucket boundary runs. When contributor time-ranges
  interleave inside a bucket (rare: out-of-order backfill), that bucket
  is recomputed exactly from materialized rows. 64-bit sums wrap mod
  2^64 like the reference's native ints; narrower types sum exactly
  (no artificial wrap — deviation, improvement).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from .exec import groupby as GB
from .exec import oracle as ORC
from .types import FieldType

__all__ = ["SeriesRequest", "FillMode", "run_series"]


class FillMode:
    NONE = "none"      # drop empty buckets
    NULL = "null"      # keep, value None
    ZERO = "zero"
    LAST = "last"      # carry last seen value forward
    LINEAR = "linear"  # interpolate between neighbours


BASIC_OPS = {"count", "sum", "mean", "avg", "min", "max"}
JOIN_OPS = {"first_join", "last_join", "min_join", "max_join",
            "mean_join", "var_join", "std_join"}
EXT_OPS = {"first", "last", "var", "std"} | JOIN_OPS


@dataclass
class SeriesRequest:
    table: object                       # knox.TableHandle or engine Table
    time_field: str
    start: int                          # inclusive, ns (or any int domain)
    end: int                            # exclusive
    interval: int
    aggs: list = dc_field(default_factory=list)   # [(op, field)]
    fill: str = FillMode.NONE
    where: object = None                # optional knox Query-style tree


def run_series(req: SeriesRequest) -> dict:
    """Returns {"time": i64[G'], "count": i64[G'], (op, field): values}."""
    t = req.table._t if hasattr(req.table, "_t") else req.table
    G = max(1, -(-(req.end - req.start) // req.interval))
    if G > GB.MAX_GROUPS:
        raise ValueError(f"series: {G} buckets exceeds {GB.MAX_GROUPS}")
    def _is_flt(f):
        return t.full_schema.field(f).type.is_float

    # float sum/mean ride the moments kernel, float min/max the fminmax
    # keyform kernel (keyform SUMS are meaningless for floats — the int
    # group_scan path takes only non-float fields)
    agg_fields = sorted({f for op, f in req.aggs
                         if f and op in BASIC_OPS and not _is_flt(f)})

    # dispatch extended reducers to their device kernels
    kinds: dict[str, set] = {}
    fallback_join: set[str] = set()       # *_join on float columns
    for op, f in req.aggs:
        if op == "count":
            continue
        if op in BASIC_OPS:
            if f and _is_flt(f):
                if op in ("sum", "mean", "avg"):
                    kinds.setdefault(f, set()).add("moments")
                else:
                    kinds.setdefault(f, set()).add("fminmax")
            continue
        if op not in EXT_OPS:
            raise ValueError(f"series reducer {op}")
        ftf = t.full_schema.field(f).type
        if ftf.nlimbs > 2 or ftf.is_bytes_like:
            raise ValueError(f"series {op}({f}): wide/bytes values are "
                             f"not supported; cast or bucket first")
        if op in ("var", "std"):
            kinds.setdefault(f, set()).add("moments")
        elif op in ("first", "last"):
            kinds.setdefault(f, set()).add("firstlast")
        elif ftf.is_float:
            fallback_join.add(f)          # exact host run-coalescing
        else:
            kinds.setdefault(f, set()).add("tsruns")

    with t.engine.begin(read_only=True) as tx:
        snap = tx.snapshot
        # restrict to the time range via the filter tree
        from .query.filter import Filter, and_, leaf
        from .types import FilterMode
        rng_leaf = leaf(Filter(t.full_schema.field(req.time_field),
                               FilterMode.RANGE,
                               (req.start, req.end - 1)))
        tree = and_(req.where, rng_leaf).optimize() if req.where is not None \
            else rng_leaf.optimize()

        counts = np.zeros(G, np.int64)
        sums = {f: [0] * G for f in agg_fields}
        mins = {f: [None] * G for f in agg_fields}
        maxs = {f: [None] * G for f in agg_fields}
        ext_parts: dict = {}             # (field, kind) -> [contributor...]

        # bucket arithmetic happens in the KEYFORM domain (signed time
        # types carry a 2^63 bias; differences are bias-free)
        from .query.filter import _key_int
        tf0 = t.full_schema.field(req.time_field).type
        t0_key = _key_int(req.start, tf0)
        tbias = (1 << (tf0.bits - 1)) if tf0.is_signed else 0

        segments, jdata, jrids, dead = t._read_view(snap)
        excl_by_seg = t._exclude_masks_of(segments, dead)
        need_minmax = any(op in ("min", "max") and f and not _is_flt(f)
                          for op, f in req.aggs)
        for h, excl in zip(segments, excl_by_seg):
            sc = h.scanner_()
            gplan = GB.plan_buckets(sc.d, req.time_field, t0_key,
                                    req.interval, G)
            if agg_fields or not kinds:
                _gp, c, res = sc.group_scan(
                    tree, req.time_field, agg_fields, exclude_words=excl,
                    gplan=gplan, minmax=need_minmax)
                counts += c
                for f in agg_fields:
                    s, mn, mx = res[f]
                    for g in np.flatnonzero(np.asarray(c) > 0):
                        sums[f][g] += s[g]
                        if mins[f][g] is None or int(mn[g]) < mins[f][g]:
                            mins[f][g] = int(mn[g])
                        if maxs[f][g] is None or int(mx[g]) > maxs[f][g]:
                            maxs[f][g] = int(mx[g])
            else:
                _gp, c, _res = sc.group_scan(
                    tree, req.time_field, [], exclude_words=excl,
                    gplan=gplan, minmax=False)
                counts += c
            if kinds:
                sp = sc.series_scan(tree, req.time_field, kinds, gplan,
                                    exclude_words=excl)
                for k, v in sp.items():
                    ext_parts.setdefault(k, []).append(v)

        jsel = np.zeros(0, np.int64)
        jg = jts_k = None
        if len(jrids):
            jm = ORC.eval_tree(tree, jdata, len(jrids))
            sel = np.flatnonzero(jm)
            if len(sel):
                ts = np.array([int(v) for v in
                               jdata[req.time_field][sel]], np.int64)
                g_of = (ts - req.start) // req.interval
                ok = (g_of >= 0) & (g_of < G)
                sel, g_of = sel[ok], g_of[ok]
                jsel, jg = sel, g_of
                # keyform timestamps as python ints (tbias can be 2^63)
                jts_k = ts[ok].astype(object) + tbias
                np.add.at(counts, g_of, 1)
                for f in agg_fields:
                    ftf = t.full_schema.field(f).type
                    keys = ORC.column_keys(jdata[f][sel], ftf)
                    gsum, gmin, gmax, hit = _group_reduce_exact(
                        g_of, keys, G)
                    for g in np.flatnonzero(hit):
                        sums[f][g] += gsum[g]
                        if mins[f][g] is None or gmin[g] < mins[f][g]:
                            mins[f][g] = gmin[g]
                        if maxs[f][g] is None or gmax[g] > maxs[f][g]:
                            maxs[f][g] = gmax[g]

        # journal contributions to extended reducers (appended LAST:
        # journal rows are the most recent arrivals — tie-break order)
        if len(jsel):
            for f, ks in kinds.items():
                ftf = t.full_schema.field(f).type
                keys = ORC.column_keys(jdata[f][jsel], ftf)
                for kind in ks:
                    if ftf.is_float and kind == "firstlast":
                        # device parts carry raw f64 bits, match them
                        vr = np.asarray(
                            [float(v) for v in jdata[f][jsel]],
                            np.float64).view(np.uint64)
                    else:
                        vr = keys
                    jp = _np_series_part(kind, jg, jts_k, vr, G, ftf)
                    ext_parts.setdefault((f, kind), []).append(jp)

        # exact host path: *_join over float columns, and any bucket
        # whose contributor time-ranges interleave
        rows_cache: dict = {}

        def rows_of(f):
            if f not in rows_cache:
                rows_cache[f] = _materialize_rows(
                    t, segments, excl_by_seg, jdata, jsel, tree,
                    req.time_field, f, tbias)
            return rows_cache[f]

        ext_vals = _finalize_ext(req, t, G, counts, ext_parts,
                                 fallback_join, rows_of)

    times = req.start + np.arange(G, dtype=np.int64) * req.interval
    out: dict = {"time": times, "count": counts}
    for op, f in req.aggs:
        if op == "count" or not f:
            continue
        ftf = t.full_schema.field(f).type
        bias = (1 << (ftf.bits - 1)) if ftf.is_signed else 0
        vals = []
        for g in range(G):
            if counts[g] == 0:
                vals.append(None)
            elif op in EXT_OPS:
                vals.append(ext_vals[(op, f)][g])
            elif ftf.is_float and op in ("sum", "mean", "avg"):
                parts = ext_parts.get((f, "moments"), [])
                S = sum(float(p[1][g]) for p in parts)
                vals.append(S / int(counts[g])
                            if op in ("mean", "avg") else S)
            elif ftf.is_float and op in ("min", "max"):
                best = None
                for p in ext_parts.get((f, "fminmax"), []):
                    if int(p[0][g]) == 0:
                        continue
                    k = int(p[1][g]) if op == "min" else int(p[2][g])
                    if best is None or (k < best if op == "min"
                                        else k > best):
                        best = k
                vals.append(None if best is None else _kv(best, ftf))
            elif op in ("sum", "mean", "avg"):
                v = sums[f][g] - int(counts[g]) * bias
                vals.append(v / int(counts[g]) if op in ("mean", "avg") else v)
            elif op == "min":
                vals.append(_kv(mins[f][g], ftf))
            elif op == "max":
                vals.append(_kv(maxs[f][g], ftf))
            else:
                raise ValueError(f"series reducer {op}")
        out[(op, f)] = _fill(vals, req.fill, times)
    if req.fill == FillMode.NONE:
        keep = counts > 0
        out = {k: (v[keep] if isinstance(v, np.ndarray) else
                   np.array([x for x, kp in zip(v, keep) if kp], object))
               for k, v in out.items()}
    return out


_W64 = 1 << 64
_U64MAX = _W64 - 1


def _val_of_mod(s_mod: int, signed: bool):
    """Value-domain mod-2^64 int -> python int (signed interp)."""
    return s_mod - _W64 if (signed and s_mod >= (1 << 63)) else s_mod


def _np_series_part(kind: str, g_of, ts_k, keys, G: int, ftf: FieldType):
    """Journal-overlay contributor for one extended-reducer kind, shaped
    exactly like the device kernel outputs (exec/groupby.py) so the
    combine code treats devices and journal uniformly."""
    bias = (1 << (ftf.bits - 1)) if ftf.is_signed else 0
    k_int = [int(k) for k in keys]
    if kind == "moments":
        n = np.zeros(G, np.int64)
        S = np.zeros(G, np.float64)
        Q = np.zeros(G, np.float64)
        for g in np.unique(g_of):
            m = g_of == g
            if ftf.is_float:
                fv = np.array([_kv(k, ftf) for k, mm in zip(k_int, m)
                               if mm], np.float64)
            else:
                fv = np.array([float(k - bias) for k, mm
                               in zip(k_int, m) if mm], np.float64)
            n[g] = len(fv)
            S[g] = fv.sum()
            Q[g] = (fv * fv).sum()
        return (n, S, Q)
    if kind == "fminmax":
        n = np.zeros(G, np.int64)
        mn = np.full(G, _U64MAX, object)
        mx = np.zeros(G, object)
        for g in np.unique(g_of):
            kk = [k_int[i] for i in np.flatnonzero(g_of == g)]
            n[g] = len(kk)
            mn[g], mx[g] = min(kk), max(kk)
        return (n, mn, mx)
    if kind == "firstlast":
        f_ts = np.full(G, _U64MAX, object)
        f_v = np.zeros(G, object)
        l_ts = np.zeros(G, object)
        l_v = np.zeros(G, object)
        c = np.zeros(G, np.int64)
        for g in np.unique(g_of):
            idx = np.flatnonzero(g_of == g)
            tg = ts_k[idx]
            i_f = idx[np.argmin(tg)]                      # earliest row wins
            i_l = idx[len(tg) - 1 - np.argmax(tg[::-1])]  # latest row wins
            f_ts[g], f_v[g] = int(ts_k[i_f]), k_int[i_f]
            l_ts[g], l_v[g] = int(ts_k[i_l]), k_int[i_l]
            c[g] = len(idx)
        return (f_ts, f_v, l_ts, l_v, c)
    assert kind == "tsruns"
    n_runs = np.zeros(G, np.int64)
    cols = [np.zeros(G, object) for _ in range(8)]   # f_ts..l_hi
    i_min = np.full(G, _U64MAX, object)
    i_max = np.zeros(G, object)
    i_n = np.zeros(G, np.int64)
    i_s = np.zeros(G, np.float64)
    i_q = np.zeros(G, np.float64)
    for g in np.unique(g_of):
        idx = np.flatnonzero(g_of == g)
        runs: dict = {}
        for i in idx:
            e = runs.setdefault(int(ts_k[i]), [0, 0])
            e[0] += 1
            e[1] = (e[1] + k_int[i] - bias) % _W64
        items = sorted(runs.items())
        n_runs[g] = len(items)
        (ft_, (fc_, fs_)) = items[0]
        (lt_, (lc_, ls_)) = items[-1]
        cols[0][g], cols[1][g], cols[2][g], cols[3][g] = ft_, fc_, fs_, 0
        cols[4][g], cols[5][g], cols[6][g], cols[7][g] = lt_, lc_, ls_, 0
        mn = mx = None
        for ts_, (c_, s_) in items[1:-1]:
            kf = (s_ + bias) % _W64
            mn = kf if mn is None or kf < mn else mn
            mx = kf if mx is None or kf > mx else mx
            fv = float(_val_of_mod(s_, ftf.is_signed))
            i_n[g] += 1
            i_s[g] += fv
            i_q[g] += fv * fv
        if mn is not None:
            i_min[g], i_max[g] = mn, mx
    return (n_runs, *cols, i_min, i_max, i_n, i_s, i_q)


def _materialize_rows(t, segments, excl_by_seg, jdata, jsel, tree,
                      time_field: str, f: str, tbias: int):
    """All rows matching the series tree: (ts_key i64-as-int list,
    value list) per contributor order (segments then journal). Values
    are NATIVE (python ints / floats). Used by the exact *_join paths."""
    ts_all: list = []
    v_all: list = []
    for h, excl in zip(segments, excl_by_seg):
        sc = h.scanner_()
        res = sc.scan(tree, [], project=[time_field, f],
                      exclude_words=excl)
        ts_all.extend(int(v) + tbias for v in res.rows[time_field])
        v_all.extend(res.rows[f].tolist())
    for i in jsel:
        ts_all.append(int(jdata[time_field][i]) + tbias)
        v_all.append(jdata[f][i])
    return ts_all, v_all


def _exact_join_stats(rows, t0_key: int, interval: int, g: int,
                      signed: bool, is_float: bool):
    """Recompute one bucket's *_join stats exactly from raw rows."""
    ts_all, v_all = rows
    runs: dict = {}
    lo = t0_key + g * interval
    hi = lo + interval
    for ts, v in zip(ts_all, v_all):
        if not (lo <= ts < hi):
            continue
        e = runs.setdefault(ts, [0, 0.0 if is_float else 0])
        e[0] += 1
        if is_float:
            e[1] += float(v)
        else:
            e[1] = (e[1] + int(v)) % _W64
    if not runs:
        return None
    items = sorted(runs.items())
    if is_float:
        vals = [s for _, (_c, s) in items]
    else:
        vals = [_val_of_mod(s, signed) for _, (_c, s) in items]
    fl = [float(v) for v in vals]
    n = len(vals)
    S = sum(fl)
    return {"first": vals[0], "last": vals[-1], "min": min(vals),
            "max": max(vals), "n": n, "S": S,
            "Q": sum(x * x for x in fl)}


def _merge_join_stats(parts, g: int, bias: int, signed: bool):
    """Merge per-contributor tsruns parts for one bucket. Returns a
    stats dict, None (empty), or "overlap" (contributor time ranges
    interleave -> caller recomputes exactly)."""
    live = []
    for p in parts:
        if int(p[0][g]) == 0:
            continue
        live.append((
            int(p[0][g]), int(p[1][g]), int(p[2][g]),
            (int(p[3][g]) + (int(p[4][g]) << 32)) % _W64,
            int(p[5][g]), int(p[6][g]),
            (int(p[7][g]) + (int(p[8][g]) << 32)) % _W64,
            int(p[9][g]), int(p[10][g]), int(p[11][g]),
            float(p[12][g]), float(p[13][g])))
    if not live:
        return None
    if len(live) > 1:
        iv = sorted((p[1], p[4] if p[0] > 1 else p[1]) for p in live)
        for (_a, b), (c, _d) in zip(iv, iv[1:]):
            if c < b:
                return "overlap"
    bruns: dict = {}
    i_n_tot = 0
    S = 0.0
    Q = 0.0
    kf_min = kf_max = None
    for (nr, f_ts, f_cnt, f_sum, l_ts, l_cnt, l_sum,
         imin, imax, i_n, i_s, i_q) in live:
        bounds = [(f_ts, f_cnt, f_sum)]
        if nr > 1:
            bounds.append((l_ts, l_cnt, l_sum))
        for ts_, c_, s_ in bounds:
            e = bruns.setdefault(ts_, [0, 0])
            e[0] += c_
            e[1] = (e[1] + s_) % _W64
        i_n_tot += i_n
        S += i_s
        Q += i_q
        if i_n > 0:
            kf_min = imin if kf_min is None or imin < kf_min else kf_min
            kf_max = imax if kf_max is None or imax > kf_max else kf_max
    items = sorted(bruns.items())
    bvals = [_val_of_mod(s_, signed) for _, (_c, s_) in items]
    for _ts, (_c, s_) in items:
        kf = (s_ + bias) % _W64
        kf_min = kf if kf_min is None or kf < kf_min else kf_min
        kf_max = kf if kf_max is None or kf > kf_max else kf_max
    for v in bvals:
        fv = float(v)
        S += fv
        Q += fv * fv
    n = i_n_tot + len(items)
    return {"first": bvals[0], "last": bvals[-1],
            "min": _val_of_mod((kf_min - bias) % _W64, signed),
            "max": _val_of_mod((kf_max - bias) % _W64, signed),
            "n": n, "S": S, "Q": Q}


def _finalize_ext(req, t, G: int, counts, ext_parts, fallback_join,
                  rows_of):
    """Per-bucket values for every extended reducer in the request."""
    import math
    from .query.filter import _key_int
    tf0 = t.full_schema.field(req.time_field).type
    t0_key = _key_int(req.start, tf0)
    ext_vals: dict = {}
    join_stats: dict = {}

    def stats_of(f, ftf):
        if f in join_stats:
            return join_stats[f]
        bias = (1 << (ftf.bits - 1)) if ftf.is_signed else 0
        out = [None] * G
        if f in fallback_join:
            rows = rows_of(f)
            for g in range(G):
                out[g] = _exact_join_stats(rows, t0_key, req.interval, g,
                                           ftf.is_signed, ftf.is_float)
        else:
            parts = ext_parts.get((f, "tsruns"), [])
            for g in range(G):
                st = _merge_join_stats(parts, g, bias, ftf.is_signed)
                if st == "overlap":
                    st = _exact_join_stats(rows_of(f), t0_key,
                                           req.interval, g,
                                           ftf.is_signed, ftf.is_float)
                out[g] = st
        join_stats[f] = out
        return out

    for op, f in req.aggs:
        if op not in EXT_OPS:
            continue
        ftf = t.full_schema.field(f).type
        if op in ("first", "last"):
            parts = ext_parts.get((f, "firstlast"), [])
            vals = [None] * G
            for g in range(G):
                best_ts = best_v = None
                for p in parts:
                    f_ts, f_v, l_ts, l_v, c = p
                    if int(c[g]) == 0:
                        continue
                    if op == "first":
                        tsv, vv = int(f_ts[g]), int(f_v[g])
                        if best_ts is None or tsv < best_ts:
                            best_ts, best_v = tsv, vv
                    else:
                        tsv, vv = int(l_ts[g]), int(l_v[g])
                        if best_ts is None or tsv >= best_ts:
                            best_ts, best_v = tsv, vv
                if best_ts is not None:
                    if ftf.is_float:       # device payload = raw f64 bits
                        vals[g] = float(np.array([best_v], np.uint64)
                                        .view(np.float64)[0])
                    else:
                        vals[g] = _kv(best_v, ftf)
            ext_vals[(op, f)] = vals
        elif op in ("var", "std"):
            parts = ext_parts.get((f, "moments"), [])
            vals = [None] * G
            for g in range(G):
                n = sum(int(p[0][g]) for p in parts)
                if n == 0:
                    continue
                if n < 2:
                    vals[g] = float("nan")     # reducer.go:375-378
                    continue
                S = sum(float(p[1][g]) for p in parts)
                Q = sum(float(p[2][g]) for p in parts)
                var = max(0.0, (Q - S * S / n)) / (n - 1)
                vals[g] = math.sqrt(var) if op == "std" else var
            ext_vals[(op, f)] = vals
        else:
            sts = stats_of(f, ftf)
            vals = [None] * G
            for g in range(G):
                st = sts[g]
                if st is None:
                    continue
                base = op[:-5]                 # strip "_join"
                if base in ("first", "last", "min", "max"):
                    vals[g] = st[base]
                else:
                    n, S, Q = st["n"], st["S"], st["Q"]
                    if base == "mean":
                        vals[g] = S / n
                    else:                      # var_join / std_join
                        if n < 2:
                            vals[g] = float("nan")
                        else:
                            var = max(0.0, (Q - S * S / n)) / (n - 1)
                            vals[g] = math.sqrt(var) if base == "std" \
                                else var
            ext_vals[(op, f)] = vals
    return ext_vals


def _group_reduce_exact(gids: np.ndarray, keys: np.ndarray, G: int):
    """Vectorized exact per-group (sum, min, max) of keyform keys.

    Mirrors the device invariant: u64 keys split into 32-bit
    limbs whose per-group f64 bincount sums stay exact below 2^53, then
    recombined with python ints. No per-row python loop, so the
    journal overlay scales. Object (wide) key
    arrays fall back to a python reduction."""
    hit = np.zeros(G, bool)
    np.logical_or.at(hit, gids, True)
    gmin = np.empty(G, object)
    gmax = np.empty(G, object)
    gsum = np.zeros(G, object)
    if keys.dtype == object:
        for g in np.flatnonzero(hit):
            kk = [int(k) for k in keys[gids == g]]
            gsum[g] = sum(kk)
            gmin[g], gmax[g] = min(kk), max(kk)
        return gsum, gmin, gmax, hit
    k = keys.astype(np.uint64)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.float64)
    hi = (k >> np.uint64(32)).astype(np.float64)
    lo_s = np.bincount(gids, weights=lo, minlength=G)
    hi_s = np.bincount(gids, weights=hi, minlength=G)
    mn = np.full(G, np.iinfo(np.uint64).max, np.uint64)
    mx = np.zeros(G, np.uint64)
    np.minimum.at(mn, gids, k)
    np.maximum.at(mx, gids, k)
    for g in np.flatnonzero(hit):
        gsum[g] = (int(hi_s[g]) << 32) + int(lo_s[g])
        gmin[g], gmax[g] = int(mn[g]), int(mx[g])
    return gsum, gmin, gmax, hit


def _kv(key: int, ft: FieldType):
    from .exec.scan import _key_to_value
    return _key_to_value(key, ft)


def _fill(vals: list, mode: str, times: np.ndarray):
    if mode in (FillMode.NONE, FillMode.NULL):
        return np.array(vals, object)
    out = list(vals)
    if mode == FillMode.ZERO:
        out = [0 if v is None else v for v in out]
    elif mode == FillMode.LAST:
        last = None
        for i, v in enumerate(out):
            if v is None:
                out[i] = last
            else:
                last = v
    elif mode == FillMode.LINEAR:
        known = [i for i, v in enumerate(out) if v is not None]
        for i, v in enumerate(out):
            if v is not None:
                continue
            prev = max((k for k in known if k < i), default=None)
            nxt = min((k for k in known if k > i), default=None)
            if prev is not None and nxt is not None:
                w = (i - prev) / (nxt - prev)
                out[i] = out[prev] + (out[nxt] - out[prev]) * w
            elif prev is not None:
                out[i] = out[prev]
            elif nxt is not None:
                out[i] = out[nxt]
    return np.array(out, object)
