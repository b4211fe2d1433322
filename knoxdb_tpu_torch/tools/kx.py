"""kx — admin CLI: stats, merge, gc, truncate, describe, import
(carried over from knoxdb_tpu/tools/kx.py; upstream cmd/kx/main.go).

    python -m knoxdb_tpu_torch.tools.kx <db-path> stats|merge|gc [table]
    python -m knoxdb_tpu_torch.tools.kx <db-path> truncate <table>
    python -m knoxdb_tpu_torch.tools.kx <db-path> describe <table>
    python -m knoxdb_tpu_torch.tools.kx <db-path> import <table> --csv <file>

The store opens on --device (default cuda; --device cpu without a card).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser("kx")
    ap.add_argument("path")
    ap.add_argument("cmd", choices=["stats", "merge", "gc", "truncate",
                                    "describe", "import"])
    ap.add_argument("table", nargs="?")
    ap.add_argument("--csv", help="CSV file for the import command")
    ap.add_argument("--device", default="cuda",
                    help="torch device the tables scan on (cuda, cpu)")
    args = ap.parse_args(argv)

    from .. import knox
    db = knox.open_database("kx", driver="file", path=args.path,
                            background_merge=False, device=args.device)
    try:
        tables = ([db.engine.table(args.table)] if args.table
                  else list(db.engine.tables.values()))
        if args.cmd == "stats":
            for t in tables:
                m = t.metrics
                print(f"{t.schema.name}: rows={t.state.n_rows} "
                      f"segments={len(t.segments)} "
                      f"journal={t.journal.nrows} merges={m.merges} "
                      f"stored={m.bytes_stored}")
        elif args.cmd == "merge":
            for t in tables:
                t.merge()
                print(f"{t.schema.name}: merged -> epoch {t.state.epoch}")
        elif args.cmd == "gc":
            db.engine.try_gc()
            print(f"wal tail_lsn={db.engine.wal.tail_lsn}")
        elif args.cmd == "truncate":
            if not args.table:
                ap.error("truncate needs a table name")
            db.engine.truncate_table(args.table)
            print(f"{args.table}: truncated")
        elif args.cmd == "describe":
            if not args.table:
                ap.error("describe needs a table name")
            import json
            print(json.dumps(db.describe(args.table), indent=2))
        elif args.cmd == "import":
            if not args.table or not args.csv:
                ap.error("import needs a table name and --csv")
            n = db.table(args.table).import_csv(args.csv)
            print(f"{args.table}: imported {n} rows")
    finally:
        db.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
