"""packview — inspect a database's tables, segments, packs and stats
(carried over from knoxdb_tpu/tools/packview.py; upstream cmd/packview/
packview.go: PrintSchema/PrintMetadata/PrintDetail/PrintContent).

    python -m knoxdb_tpu_torch.tools.packview <db-path> [table]
        [--schema]            field detail (type/scale/index/filter)
        [--packs]             per-pack scheme/width/bytes detail
        [--stats]             zone maps + filters + stats-tree dump
        [--content SEG:PACK]  decode + print one pack's rows
        [--json]
        [--device D]          torch device of --content's scan (cuda, cpu)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def human(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024:
            return f"{n:.1f}{unit}" if isinstance(n, float) else f"{n}{unit}"
        n = n / 1024
    return f"{n:.1f}TiB"


def _logical_bytes(seg, cname: str) -> int:
    """Uncompressed logical size of a column (rows x type width; byte
    columns count their actual value bytes) — the compression-ratio
    denominator, like upstream's stats view."""
    col = seg.columns[cname]
    ft = col.field.type
    if ft.is_bytes_like:
        return sum(sum(len(b) for b in p.dict_bytes) * max(1, p.n // max(p.card, 1))
                   if p.dict_bytes else 0 for p in col.packs)
    return seg.nrows_total * max(1, ft.bits // 8)


def _seg_info(seg, key: str, nbytes: int, dead: int, args) -> dict:
    si = {"key": key, "rows": seg.nrows_total, "dead_rows": dead,
          "packs": seg.npacks, "pack_size": seg.pack_size,
          "bytes": nbytes, "epoch": seg.epoch, "columns": {}}
    for cname, col in seg.columns.items():
        schemes = {}
        widths = {}
        for p in col.packs:
            schemes[p.scheme.name] = schemes.get(p.scheme.name, 0) + 1
            widths[p.width] = widths.get(p.width, 0) + 1
        logical = _logical_bytes(seg, cname)
        ci = {"schemes": schemes, "width_hist": widths,
              "bytes": col.nbytes,
              "ratio": round(logical / col.nbytes, 2) if col.nbytes else 0}
        if args.stats and cname in seg.stats.fields:
            fs = seg.stats.fields[cname]
            ci["min"] = str(fs.min_key.min())
            ci["max"] = str(fs.max_key.max())
            ci["filter"] = fs.filter_type.name
            if fs.bloom_words is not None:
                ci["filter_bytes"] = int(fs.bloom_words.nbytes)
            elif fs.pack_filters is not None:
                ci["filter_bytes"] = int(sum(
                    f.nbytes for f in fs.pack_filters))
            # two-level stats tree (coarse super blocks)
            cmin, cmax = fs.coarse()
            ci["tree"] = [{"block": b, "min": str(cmin[b]),
                           "max": str(cmax[b])}
                          for b in range(len(cmin))][:64]
            if args.packs:
                ci["zone_maps"] = [
                    {"pack": p, "min": str(fs.min_key[p]),
                     "max": str(fs.max_key[p])}
                    for p in range(len(fs.min_key))]
        if args.packs:
            ci["pack_detail"] = [
                {"scheme": p.scheme.name, "w": p.width, "n": p.n,
                 "k": p.k, "card": p.card, "bytes": p.nbytes}
                for p in col.packs]
        si["columns"][cname] = ci
    return si


def _print_content(seg, pack: int, limit: int = 32,
                   device: str = "cuda") -> None:
    """Decode + print one pack's rows (upstream PrintContent) through a
    scan on `device`."""
    from ..exec.device import DeviceSegment
    from ..exec.scan import AggSpec, SegmentScanner
    from ..ops import bitset as bs
    P, N = seg.npacks, seg.pack_size
    if not 0 <= pack < P:
        print(f"pack {pack} out of range [0, {P})", file=sys.stderr)
        return
    m = np.zeros(P * N, bool)
    m[pack * N:pack * N + int(seg.nrows[pack])] = True
    incl = bs.np_pack_mask(m).reshape(P, N // 32)
    sc = SegmentScanner(DeviceSegment(seg, device))
    names = [f.name for f in seg.schema.fields]
    r = sc.scan(None, [AggSpec("count")], project=names,
                include_words=incl)
    n = min(limit, r.count)
    print(f"# pack {pack}: {r.count} rows (showing {n})")
    print("\t".join(names))
    for i in range(n):
        print("\t".join(str(r.rows[c][i]) for c in names))


def main(argv=None):
    ap = argparse.ArgumentParser("packview")
    ap.add_argument("path", help="database directory (file driver)")
    ap.add_argument("table", nargs="?", help="table name (default: all)")
    ap.add_argument("--schema", action="store_true", help="field detail")
    ap.add_argument("--packs", action="store_true", help="per-pack detail")
    ap.add_argument("--stats", action="store_true", help="zone-map stats")
    ap.add_argument("--content", metavar="SEG:PACK",
                    help="decode + dump one pack's rows")
    ap.add_argument("--limit", type=int, default=32,
                    help="max content rows")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --content's scan (cuda, cpu)")
    args = ap.parse_args(argv)

    from ..store import segio
    from ..store.kv import FileStore

    store = FileStore(f"{args.path}/data")
    cat = store.bucket("catalog").get(b"catalog")
    if not cat:
        print("no catalog found", file=sys.stderr)
        return 1
    cat = json.loads(cat)

    out = []
    for td in cat["tables"]:
        name = td["schema"]["name"]
        if args.table and name != args.table:
            continue
        info = {"table": name, "id": td["id"], "state": td["state"],
                "fields": [f"{f['name']}:{f['type']}"
                           for f in td["schema"]["fields"]],
                "segments": []}
        if args.schema:
            info["schema"] = td["schema"]["fields"]
        try:
            b = store.bucket(f"table_{td['id']}_segments", create=False)
        except KeyError:
            b = None
        segdead = td.get("segdead", {})
        if b:
            for k, blob in b.items():
                key = k.decode()
                if key not in td.get("segkeys", [key]):
                    continue                       # staged/dead blobs
                if "_dead_" in key:
                    continue
                seg = segio.load_segment(blob)
                dead = 0
                dk = segdead.get(key)
                if dk:
                    db_ = b.get(dk.encode())
                    dead = len(db_) // 8 if db_ else 0
                si = _seg_info(seg, key, len(blob), dead, args)
                info["segments"].append(si)
                if args.content:
                    skey, _, pk = args.content.partition(":")
                    if skey in (key, "*"):
                        _print_content(seg, int(pk or 0), args.limit,
                                       args.device)
        out.append(info)

    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    for info in out:
        print(f"table {info['table']} (id={info['id']}) "
              f"rows={info['state']['n_rows']} epoch={info['state']['epoch']}")
        print(f"  fields: {', '.join(info['fields'])}")
        if args.schema:
            for f in info["schema"]:
                knobs = [k for k in ("pk", "index", "filter", "scale",
                                     "fixed") if f.get(k)]
                extra = " ".join(f"{k}={f[k]}" for k in knobs)
                print(f"    {f['name']:12s} type={f['type']} {extra}")
        for si in info["segments"]:
            dead = f" dead={si['dead_rows']}" if si["dead_rows"] else ""
            print(f"  segment {si['key']}: {si['rows']} rows{dead}, "
                  f"{si['packs']} packs x {si['pack_size']}, "
                  f"{human(si['bytes'])}")
            for cname, ci in si["columns"].items():
                extra = f" x{ci['ratio']}"
                if "min" in ci:
                    extra += f" min={ci['min']} max={ci['max']}"
                    if ci.get("filter", "NONE") != "NONE":
                        extra += (f" {ci['filter'].lower()}"
                                  f"({human(ci.get('filter_bytes', 0))})")
                print(f"    {cname:12s} {human(ci['bytes']):>10s}  "
                      f"{ci['schemes']} w={ci['width_hist']}{extra}")
            if args.stats:
                for cname, ci in si["columns"].items():
                    if len(ci.get("tree", [])) > 1:
                        blocks = " ".join(
                            f"[{t['min']},{t['max']}]"
                            for t in ci["tree"][:8])
                        print(f"    tree {cname}: {blocks}"
                              + (" ..." if len(ci["tree"]) > 8 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
