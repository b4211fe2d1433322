"""The SDK of both packages, knoxdb_tpu.knox and knoxdb_tpu_torch.knox
(the port on the CPU), driven by the same seeded calls: the harness of
the SDK-level parity tests. A case is a function of (side, knox module)
that runs the calls and returns what they answered; `both` runs it in
each package and holds the two answers equal (`same`)."""

from __future__ import annotations

import knoxdb_tpu.knox as RK
import knoxdb_tpu_torch.knox as TK

from torch_engine_pair import SIDES, same

SDK = {"ref": RK, "port": TK}


def _kw(side: str, kw: dict) -> dict:
    kw = dict(kw)
    if side == "port":
        kw.setdefault("device", "cpu")
    return kw


def create(side: str, name: str, **kw):
    """knox.create_database of one side; the port's on the CPU."""
    return SDK[side].create_database(name, **_kw(side, kw))


def open_db(side: str, name: str, **kw):
    return SDK[side].open_database(name, **_kw(side, kw))


def both(case, *args, **kw):
    """case(side, knox, *args) in both packages -> the port's answer,
    equal to the reference's."""
    out = {s: case(s, SDK[s], *args, **kw) for s in SIDES}
    same(out["ref"], out["port"])
    return out["port"]


def multiset(cols: dict) -> list:
    """A join result's rows as a sorted list of tuples (pair order is
    unspecified): None sorts first."""
    names = sorted(k for k in cols if k != "__n")
    n = cols["__n"]
    rows = [tuple(_key(cols[k][i]) for k in names) for i in range(n)]
    return sorted(rows)


def _key(v):
    if hasattr(v, "item"):
        v = v.item()
    return (0, "") if v is None else (1, repr(type(v).__name__), v)
