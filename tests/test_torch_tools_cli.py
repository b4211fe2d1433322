"""The port's CLI tools (knoxdb_tpu_torch.tools.kx, packview, walview)
against knoxdb_tpu's (the cases of tests/test_tools_cli.py), and stores
carried across: each store is written once by one package's knox, copied,
and each package's tool runs on its own copy with the same arguments;
the printed lines are equal, with the store's path normalized. A store
written by either package (zlib and lz4 segment blobs, a WAL tail)
opens in the other package's knox with the same answers. The port runs
on the CPU (--device cpu)."""

import contextlib
import io
import json
import shutil
from dataclasses import dataclass

import numpy as np
import pytest

import knoxdb_tpu.tools.kx as RKX
import knoxdb_tpu.tools.packview as RPV
import knoxdb_tpu.tools.walview as RWV
import knoxdb_tpu_torch.tools.kx as TKX
import knoxdb_tpu_torch.tools.packview as TPV
import knoxdb_tpu_torch.tools.walview as TWV

from torch_knox_pair import SDK, create, open_db

TOOLS = {"kx": (RKX, TKX), "packview": (RPV, TPV), "walview": (RWV, TWV)}
DEVICE = {"kx": True, "packview": True, "walview": False}


@dataclass
class Acct:
    id: int = 0
    bal: int = 0
    kind: int = 0


def _write_store(side, path, seed=0xC11):
    rng = np.random.default_rng(seed)
    db = create(side, "cli", driver="file", path=str(path), pack_size=256,
                background_merge=False)
    t = db.create_table(Acct)
    n = 600
    t.insert({"id": np.zeros(n, np.uint64),
              "bal": rng.integers(0, 10_000, n),
              "kind": rng.integers(0, 5, n)})
    t.merge()
    t.insert([Acct(bal=1, kind=9)])          # journal row
    db.close()


@pytest.fixture(params=["ref", "port"])
def stores(request, tmp_path):
    """One store written by `writer`'s knox, copied once per package."""
    src = tmp_path / "src"
    _write_store(request.param, src)
    out = {}
    for side in ("ref", "port"):
        out[side] = tmp_path / side
        shutil.copytree(src, out[side])
    return out


def _run(tool, side, path, *args):
    """(exit code, stdout) of one package's tool on its copy."""
    mod = TOOLS[tool][side == "port"]
    argv = [str(path), *args]
    if side == "port" and DEVICE[tool]:
        argv += ["--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().replace(str(path), "<db>")


def _same(tool, stores, *args):
    r = _run(tool, "ref", stores["ref"], *args)
    p = _run(tool, "port", stores["port"], *args)
    assert p == r
    assert p[0] == 0
    return p[1]


def test_kx_stats_merge_gc(stores):
    out = _same("kx", stores, "stats")
    assert "acct" in out and "rows=601" in out and "journal=1" in out
    assert "merged" in _same("kx", stores, "merge", "acct")
    assert "journal=0" in _same("kx", stores, "stats", "acct")
    assert "tail_lsn=" in _same("kx", stores, "gc")


def test_kx_describe(stores):
    d = json.loads(_same("kx", stores, "describe", "acct"))
    assert d["name"] == "acct" and d["rows"] == 601
    assert {f["name"] for f in d["fields"]} == {"id", "bal", "kind"}


def test_kx_import_then_truncate(stores, tmp_path):
    csv = tmp_path / "more.csv"
    csv.write_text("id,bal,kind\n" +
                   "\n".join(f"0,{i},{i % 3}" for i in range(50)))
    assert "imported 50" in _same("kx", stores, "import", "acct", "--csv",
                                  str(csv))
    counts = {}
    for side in ("ref", "port"):
        db = open_db(side, "cli", driver="file", path=str(stores[side]),
                     background_merge=False)
        counts[side] = db.table("acct").count()
        db.close()
    assert counts == {"ref": 651, "port": 651}
    assert "truncated" in _same("kx", stores, "truncate", "acct")
    assert "rows=0" in _same("kx", stores, "stats")


def test_kx_errors(stores):
    for args in (["truncate"], ["import", "acct"], ["compact"]):
        for side in ("ref", "port"):
            with pytest.raises(SystemExit):
                _run("kx", side, stores[side], *args)


def test_packview(stores):
    assert "acct" in _same("packview", stores, "--packs", "--stats")
    assert "acct" in _same("packview", stores, "--schema")
    data = json.loads(_same("packview", stores, "acct", "--json"))
    assert data[0]["table"] == "acct"


def test_packview_deep(stores):
    data = json.loads(_same("packview", stores, "acct", "--schema",
                            "--stats", "--packs", "--json"))
    si = data[0]["segments"][0]
    ci = si["columns"]["bal"]
    assert ci["ratio"] > 0 and ci["width_hist"] and "tree" in ci
    assert len(ci["zone_maps"]) == len(ci["pack_detail"]) == si["packs"]
    out = _same("packview", stores, "acct", "--content", f"{si['key']}:1",
                "--limit", "5")
    assert "# pack 1" in out and "bal" in out
    assert len(out.strip().splitlines()) >= 7


def test_walview(stores):
    out = _same("walview", stores)
    assert "INSERT" in out and "COMMIT" in out
    assert len(_same("walview", stores, "--limit", "3")
               .strip().splitlines()) == 3
    lines = [ln for ln in _same("walview", stores, "--type", "insert")
             .splitlines() if ln.startswith("lsn=")]
    assert lines and all("INSERT" in ln for ln in lines)
    out = _same("walview", stores, "--summary")
    assert "# entities:" in out


@pytest.mark.parametrize("codec", ["zlib", "lz4"])
def test_store_opens_in_the_other_package(tmp_path, monkeypatch, codec):
    """A store written by one package's knox (segment blobs under
    `codec`, a WAL tail of committed rows and a tombstone) answers the
    same in both packages' knox."""
    monkeypatch.setenv("KNOX_SEG_COMPRESS", codec)
    rng = np.random.default_rng(0x5707)
    bal = rng.integers(-10**6, 10**6, 1500)
    kind = rng.integers(0, 7, 1500)
    for writer in ("ref", "port"):
        src = tmp_path / f"w_{writer}"
        db = create(writer, "carry", driver="file", path=str(src),
                    pack_size=256, background_merge=False)
        t = db.create_table(Acct)
        t.insert({"id": np.zeros(1500, np.uint64), "bal": bal,
                  "kind": kind})
        t.merge()
        t.insert([Acct(bal=7, kind=9), Acct(bal=-7, kind=9)])
        t.delete(t.query().where(id=3))       # WAL tail: a tombstone
        db.close()
        answers = {}
        for reader in ("ref", "port"):
            path = tmp_path / f"{writer}_{reader}"
            shutil.copytree(src, path)
            db = open_db(reader, "carry", driver="file", path=str(path),
                         background_merge=False)
            t = db.table("acct")
            F = SDK[reader].F
            answers[reader] = {
                "count": t.count(), "sum": t.query().sum("bal"),
                "kind9": t.query().where(kind=9).select("bal").rows(),
                "groups": t.query().group_by("kind").sum("bal"),
                "range": t.query().where(F("bal").between(-1000, 5000))
                .count(),
                "segments": len(t._t.segments),
                "journal": t._t.journal.nrows}
            db.close()
        from torch_engine_pair import same
        same(answers["ref"], answers["port"])
        assert answers["port"]["count"] == 1501
        assert answers["port"]["sum"] == int(bal.sum()) - int(bal[2])
