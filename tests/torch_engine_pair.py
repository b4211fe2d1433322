"""Two engines, one of knoxdb_tpu and one of knoxdb_tpu_torch (on the
CPU), driven by the same writes and queries: the harness of the
engine-level parity tests. Every write returns the same value in both,
every read the same result (`same`), and both engines write the same
files."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

import knoxdb_tpu.engine.engine as RE
import knoxdb_tpu.exec.scan as RS
import knoxdb_tpu.query.filter as RQ
import knoxdb_tpu.schema.schema as RSCH
import knoxdb_tpu.types as RT
import knoxdb_tpu_torch.engine.engine as TE
import knoxdb_tpu_torch.exec.scan as TS
import knoxdb_tpu_torch.query.filter as TQ
import knoxdb_tpu_torch.schema.schema as TSCH
import knoxdb_tpu_torch.types as TT

PKG = {"ref": (RE, RS, RQ, RSCH, RT), "port": (TE, TS, TQ, TSCH, TT)}
SIDES = ("ref", "port")


def schema(side: str, name: str, cols, pk: str = "id"):
    """cols: [(name, FieldType name, {filter/index/...: enum names})]."""
    _E, _S, _Q, SCH, T = PKG[side]
    b = SCH.Builder(name).pk(pk)
    for c in cols:
        fname, ft = c[0], c[1]
        kw = dict(c[2]) if len(c) > 2 else {}
        if "filter" in kw:
            kw["filter"] = T.FilterType[kw["filter"]]
        if "index" in kw:
            kw["index"] = T.IndexType[kw["index"]]
        b.add(fname, T.FieldType[ft], **kw)
    return b.finish()


def tree(side: str, sch, spec):
    """Neutral spec -> one package's optimized tree: None, ("leaf",
    field, mode name, value) or ("and"|"or", child, ...)."""
    if spec is None:
        return None
    _E, _S, Q, _SCH, T = PKG[side]

    def build(s):
        if s[0] == "leaf":
            return Q.leaf(Q.Filter(sch.field(s[1]), T.FilterMode[s[2]],
                                   s[3]))
        kids = [build(c) for c in s[1:]]
        return (Q.and_ if s[0] == "and" else Q.or_)(*kids)
    return build(spec).optimize()


def leaf(field, mode, value):
    return ("leaf", field, mode, value)


def same(a, b, where="result"):
    """Deep equality of two results: dicts, ScanResults, numpy arrays
    (dtype included; object arrays element by element), floats bit for
    bit with NaN equal to NaN."""
    if hasattr(a, "aggs") and hasattr(a, "rows"):
        same(a.count, b.count, f"{where}.count")
        same(a.aggs, b.aggs, f"{where}.aggs")
        same(a.rows, b.rows, f"{where}.rows")
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            f"{where}: keys {sorted(map(str, a))} != {sorted(map(str, b))}"
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
        return
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), f"{where}: {type(b)}"
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f"{where}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
                same(x, y, f"{where}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: len {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
        return
    if isinstance(a, float) or isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or \
            (a == b and type(a) is type(b)), f"{where}: {a!r} != {b!r}"
        return
    assert a == b, f"{where}: {a!r} != {b!r}"


def files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


class Pair:
    """One table of the same schema in two engines at root/ref and
    root/port."""

    def __init__(self, root: Path, name: str, cols, *, table: str = "t",
                 history: bool = False, table_kw=None, side_opts=None,
                 **opts):
        self.root = Path(root)
        self.name = name
        self.tname = table
        self.opts = dict(driver="file", pack_size=256, journal_size=1 << 20,
                         background_merge=False)
        self.opts.update(opts)
        # options of one side only, e.g. {"ref": {"mesh": m1}, "port":
        # {"mesh": m2}}
        self.side_opts = side_opts or {}
        self._open()
        for side in SIDES:
            self.tab[side] = self.eng[side].create_table(
                schema(side, table, cols), history=history,
                **(table_kw or {}))

    def _open(self):
        self.eng, self.tab = {}, {}
        for side in SIDES:
            E = PKG[side][0]
            kw = dict(self.opts, path=str(self.root / side),
                      **self.side_opts.get(side, {}))
            if side == "port":
                kw["device"] = "cpu"
            self.eng[side] = E.Engine(self.name, E.Options(**kw))

    def reopen(self):
        self.close()
        self._open()
        self.tab = {s: self.eng[s].table(self.tname) for s in SIDES}

    def close(self):
        for side in SIDES:
            self.eng[side].close()

    def sch(self, side):
        return self.tab[side].schema

    def _both(self, fn, check=True):
        out = {s: fn(s, self.eng[s], self.tab[s]) for s in SIDES}
        if check:
            same(out["ref"], out["port"])
        return out["port"]

    # ------------------------------------------------------------ writes --

    def _write(self, op, make_arg):
        def run(side, eng, tab):
            with eng.begin() as tx:
                return getattr(tab, op)(tx, make_arg(side))
        return self._both(run)

    def insert(self, data):
        return self._write("insert_rows", lambda s: data)

    def update(self, data):
        return self._write("update_rows", lambda s: data)

    def delete(self, spec):
        return self._write("delete_rows",
                           lambda s: tree(s, self.sch(s), spec))

    def merge(self):
        for side in SIDES:
            self.tab[side].merge()

    # ------------------------------------------------------------- reads --

    def query(self, spec, aggs=(("count",),), project=None, limit=0):
        def run(side, eng, tab):
            A = PKG[side][1].AggSpec
            with eng.begin(read_only=True) as tx:
                r = tab.query(tx.snapshot, tree(side, self.sch(side), spec),
                              [A(*a) for a in aggs], project=project,
                              limit=limit)
            r.stats = {}
            return r
        return self._both(run)

    def count(self, spec=None):
        return self.query(spec).count

    def group(self, spec, gfield, aggs):
        def run(side, eng, tab):
            with eng.begin(read_only=True) as tx:
                return tab.group_query(tx.snapshot,
                                       tree(side, self.sch(side), spec),
                                       gfield, list(aggs))
        return self._both(run)

    def sorted(self, spec, order_by, desc=False, limit=0, project=None):
        def run(side, eng, tab):
            with eng.begin(read_only=True) as tx:
                r = tab.sorted_query(tx.snapshot,
                                     tree(side, self.sch(side), spec),
                                     order_by, desc=desc, limit=limit,
                                     project=project)
            r.stats = {}
            return r
        return self._both(run)

    def stream(self, spec, project, batch_packs=2, limit=0):
        def run(side, eng, tab):
            with eng.begin(read_only=True) as tx:
                return list(tab.stream_query(
                    tx.snapshot, tree(side, self.sch(side), spec), project,
                    batch_packs=batch_packs, limit=limit))
        return self._both(run)

    def segments(self):
        """(rows, dead rows) per sealed segment, equal in both."""
        return self._both(lambda s, e, t: [(h.seg.nrows_total, h.n_dead)
                                           for h in t.segments])

    def same_files(self):
        a, b = files(self.root / "ref"), files(self.root / "port")
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k] == b[k], k
