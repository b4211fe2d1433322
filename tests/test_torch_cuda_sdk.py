"""knoxdb_tpu_torch.knox on the card: a database on device="cuda" gives the
CPU database's answers through the SDK (queries, or_where, order_by,
rows, stream_batches, count_distinct, group_by, join, import_csv) and
the kx / packview tools open its store on the card; the CUDA kernels'
launch counters rise. Exact answers compare bit for bit, the group
variance (f64 moments) within rel 1e-12. The card test skips without one; run it there with
`python -m pytest -m cuda tests/test_torch_cuda_sdk.py` (no jax needed)."""

import contextlib
import io

import numpy as np
import pytest
import torch

import knoxdb_tpu_torch as KT
from knoxdb_tpu_torch.ops import group_kernels as GK
from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.tools import kx as KX
from knoxdb_tpu_torch.tools import packview as PV


def _answers(root, device):
    knox = KT.knox
    F, FT = knox.F, knox.FieldType
    db = KT.create_database("sdk", driver="file", path=str(root),
                            device=device, pack_size=1024,
                            background_merge=False)
    t = db.create_table(knox.Builder("t").pk("id")
                        .add("val", FT.UINT64).add("bal", FT.INT64)
                        .add("g", FT.UINT16)
                        .add("d", FT.DECIMAL64, scale=2).finish())
    a = db.create_table(knox.Builder("a").pk("id")
                        .add("code", FT.UINT64).finish())
    rng = np.random.default_rng(0x5DC)
    n = 6 * 4096
    t.insert({"id": np.zeros(n, np.uint64),
              "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
              "bal": rng.integers(-1 << 40, 1 << 40, n),
              "g": rng.integers(1, 60, n).astype(np.uint16),
              "d": [int(x) for x in rng.integers(-10**6, 10**6, n)]})
    a.insert({"id": np.zeros(64, np.uint64),
              "code": np.arange(64, dtype=np.uint64) * 3})
    t.merge()
    a.merge()
    t.delete(t.query().where(id__in=list(range(5, n, 97))))
    t.insert({"id": np.zeros(100, np.uint64),
              "val": np.arange(100, dtype=np.uint64),
              "bal": np.arange(100), "g": np.full(100, 7, np.uint16),
              "d": list(range(100))})
    q = t.query().where(F("val").between(1000, 50000))
    csv = "val,bal,g,d\n" + "\n".join(f"{i},{-i},{i % 9},{i}.25"
                                      for i in range(2000))
    out = {
        "count": q.count(), "sum": q.sum("val"), "dsum": q.sum("d"),
        "entry": t.query().where(F("val").between(1000, 50000),
                                 F("bal") > 0).aggregate(
            ("count", ""), ("sum", "bal"), ("min", "val"), ("max", "val")),
        "or": t.query().or_where(F("val") < 2000, F("bal") < -(1 << 39))
        .aggregate(("count", ""), ("sum", "val"), ("sum", "id")),
        "top": t.query().order_by("val", desc=True).limit(20)
        .select("id", "val").execute(),
        "rows": {k: v.tolist() for k, v in t.query().where(
            F("val").between(1000, 1655)).rows().items()},
        "batches": [{k: v.tolist() for k, v in b.items()}
                    for b in t.query().where(F("g") == 7)
                    .select("id", "d").stream_batches(batch_packs=2)],
        "distinct": (t.query().where(F("val") < 5000).count_distinct("g"),
                     t.query().count_distinct("bal", exact=False)),
        # count, sums and the var of val (a 16-bit range): kernels #3 and
        # #4; min and the var of bal (41 bits): the scatter routes
        "group": {k if isinstance(k, str) else "|".join(k): list(v)
                  for spec in ((("count", ""), ("sum", "d"), ("var", "val")),
                               (("min", "val"), ("var", "bal")))
                  for k, v in t.query().where(F("bal") > 0).group_by("g")
                  .aggregate(*spec).items()},
        "join": sorted(zip(*[list(v) for k, v in sorted(KT.knox.join(
            t.query().where(F("val") < 3000), a.query(), on=("g", "id"),
            select=("val", "code")).items()) if k != "__n"])),
        "imported": t.import_csv(io.StringIO(csv)),
    }
    out["after_import"] = t.count()
    db.close()
    return out


def _tool(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.cuda
def test_cuda_sdk_equals_cpu_sdk(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    want = _answers(tmp_path / "cpu", "cpu")
    SK.reset_counts()
    GK.reset_counts()
    got = _answers(tmp_path / "cuda", "cuda")
    launched = {**SK.LAUNCHES, **GK.LAUNCHES}
    # the group variance is a float from f64 moments: rel 1e-12, as the
    # engine's card test holds series variances
    for k in ("var|val", "var|bal"):
        np.testing.assert_allclose(np.array(got["group"].pop(k), float),
                                   np.array(want["group"].pop(k), float),
                                   rtol=1e-12)
    assert got == want
    for k in ("fused_range_sum_masked", "fused_tree_agg",
              "fused_group_partials", "fused_group_moments_partials"):
        assert launched[k] > 0, launched
    for tool, argv in ((KX.main, ["stats"]), (PV.main, ["t", "--content",
                                                        "*:0"])):
        outs = [_tool(tool, [str(tmp_path / dev), *argv, "--device", dev])
                for dev in ("cpu", "cuda")]
        assert outs[0] == outs[1] and outs[0][0] == 0
