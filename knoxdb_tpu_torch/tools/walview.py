"""walview — dump WAL records (carried over from
knoxdb_tpu/tools/walview.py; upstream cmd/walview/main.go). Host only.

    python -m knoxdb_tpu_torch.tools.walview <db-path> [--from-lsn N] [--entity N]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser("walview")
    ap.add_argument("path", help="database directory")
    ap.add_argument("--from-lsn", type=int, default=0)
    ap.add_argument("--entity", type=int, default=None)
    ap.add_argument("--type", dest="rtype", default=None,
                    help="record type filter (insert/delete/commit/"
                         "abort/checkpoint)")
    ap.add_argument("--txid", type=int, default=None)
    ap.add_argument("--mode", choices=["fail", "skip", "truncate"],
                    default="skip")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--summary", action="store_true",
                    help="per-type/entity record counts only")
    args = ap.parse_args(argv)

    from ..wal.wal import RecordType, RecoveryMode, Wal

    w = Wal(f"{args.path}/wal")
    mode = RecoveryMode[args.mode.upper()]
    want_type = RecordType[args.rtype.upper()] if args.rtype else None
    count = 0
    by_type: dict = {}
    by_entity: dict = {}
    for rec in w.records(from_lsn=args.from_lsn, entity=args.entity,
                         mode=mode):
        if want_type is not None and rec.type != want_type:
            continue
        if args.txid is not None and rec.txid != args.txid:
            continue
        by_type[rec.type.name] = by_type.get(rec.type.name, 0) + 1
        by_entity[rec.entity] = by_entity.get(rec.entity, 0) + 1
        if not args.summary:
            note = ""
            if rec.type == RecordType.DELETE:
                note = f" rids={len(rec.data) // 8}"
            elif rec.type == RecordType.CHECKPOINT:
                note = f" epoch={rec.data.decode(errors='replace')}"
            print(f"lsn={rec.lsn:>10d} {rec.type.name:<10s} "
                  f"entity={rec.entity} txid={rec.txid} "
                  f"len={len(rec.data)}{note}")
        count += 1
        if args.limit and count >= args.limit:
            break
    if args.summary:
        for tname, c in sorted(by_type.items()):
            print(f"{tname:<10s} {c}")
        print(f"# entities: {dict(sorted(by_entity.items()))}")
    print(f"# {count} records, tail_lsn={w.tail_lsn}", file=sys.stderr)
    w.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
