"""knoxdb_tpu_torch's engine on the card: an Engine on device="cuda" gives
the CPU engine's answers, through the CUDA kernels (their launch counters
rise); and an engine that names "cuda" on a machine without a card raises
instead of running on the CPU. The card tests skip without one; run them
there with `python -m pytest -m cuda tests/test_torch_cuda_engine.py`
(no jax needed)."""

import numpy as np
import pytest
import torch

from knoxdb_tpu_torch import series as SER
from knoxdb_tpu_torch.engine.engine import Engine, Options
from knoxdb_tpu_torch.exec import join as TJ
from knoxdb_tpu_torch.exec.scan import AggSpec
from knoxdb_tpu_torch.ops import group_kernels as GK
from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.query.filter import Filter, and_, leaf, or_
from knoxdb_tpu_torch.schema.schema import Builder
from knoxdb_tpu_torch.types import FieldType, FilterMode


def test_cuda_engine_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine("nocard", Options(driver="mem", path=str(tmp_path)))
    with pytest.raises(RuntimeError, match="is_available"):
        Engine("nocard", Options(driver="file", path=str(tmp_path),
                                 device="cuda:0"))
    # the CPU is taken only when asked for
    e = Engine("cpu", Options(driver="mem", path=str(tmp_path),
                              device="cpu"))
    assert e.device == torch.device("cpu")
    e.close()


def _engine(path, device):
    e = Engine("g", Options(driver="file", path=str(path), device=device,
                            pack_size=1024, background_merge=False))
    sch = (Builder("t").pk("id").add("val", FieldType.UINT64)
           .add("bal", FieldType.INT64).add("g", FieldType.UINT16)
           .add("ts", FieldType.INT64).finish())
    t = e.create_table(sch)
    rng = np.random.default_rng(0xBEEF)
    n = 4 * 8192
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
            "bal": rng.integers(-1 << 40, 1 << 40, n),
            "g": rng.integers(0, 50, n).astype(np.uint16),
            "ts": rng.integers(0, 64 * 32, n)}
    for b in range(4):
        with e.begin() as tx:
            t.insert_rows(tx, {k: v[b * 8192:(b + 1) * 8192]
                               for k, v in data.items()})
        t.merge()
    with e.begin() as tx:
        t.delete_rows(tx, leaf(Filter(sch.field("id"), FilterMode.IN,
                                      list(range(3, n, 331)))).optimize())
    t.merge()
    with e.begin() as tx:
        t.update_rows(tx, {k: v[:100] for k, v in data.items()})
    return e, t


def _answers(e, t):
    s = t.schema
    F = lambda f, m, v: leaf(Filter(s.field(f), m, v))    # noqa: E731
    out = {}
    with e.begin(read_only=True) as tx:
        snap = tx.snapshot
        for name, tree, aggs in (
                ("config1", F("val", FilterMode.RANGE, (1000, 50000)),
                 ["count", ("sum", "val")]),
                ("entry", and_(F("val", FilterMode.RANGE, (1000, 50000)),
                               F("bal", FilterMode.GT, 0)),
                 ["count", ("sum", "bal"), ("min", "val"), ("max", "val")]),
                ("or", or_(F("val", FilterMode.RANGE, (1000, 5000)),
                           F("bal", FilterMode.LT, -(1 << 39))),
                 ["count", ("sum", "val"), ("sum", "id")])):
            r = t.query(snap, tree.optimize(),
                        [AggSpec(*((a,) if isinstance(a, str) else a))
                         for a in aggs])
            out[name] = (r.count, r.aggs)
        out["group"] = {str(k): v.tolist() for k, v in t.group_query(
            snap, None, "g", [("count", ""), ("sum", "bal")]).items()}
        r = t.sorted_query(snap, None, "val", desc=True, limit=20,
                           project=["id", "val"])
        out["topk"] = sorted(zip(r.rows["val"].tolist(),
                                 r.rows["id"].tolist()))
        lk, lp, _ = t.join_side(snap, F("g", FilterMode.LT, 3).optimize(),
                                "g")
        rk, rp, _ = t.join_side(snap, F("id", FilterMode.LE, 40).optimize(),
                                "g")
        li, ri = TJ.join_pairs_device(lk, rk)
        out["join"] = sorted(zip(lp.cpu().numpy()[li].tolist(),
                                 rp.cpu().numpy()[ri].tolist()))
    res = SER.run_series(SER.SeriesRequest(
        table=t, time_field="ts", start=0, end=64 * 32, interval=32,
        aggs=[("count", ""), ("mean", "bal"), ("var", "val")]))
    out["series"] = {k: v.tolist() for k, v in res.items()}
    return out


@pytest.mark.cuda
def test_cuda_engine_equals_cpu_engine(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ec, tc = _engine(tmp_path / "cpu", "cpu")
    want = _answers(ec, tc)
    ec.close()
    eg, tg = _engine(tmp_path / "cuda", "cuda")
    SK.reset_counts()
    GK.reset_counts()
    got = _answers(eg, tg)
    launched = {**SK.LAUNCHES, **GK.LAUNCHES}
    for k in ("fused_range_sum_masked", "fused_tree_agg",
              "range_mask_count", "fused_group_partials",
              "fused_group_moments_partials"):
        assert launched[k] > 0, (k, launched)
    assert not any(SK.PLAIN_CALLS.values())
    ser_w, ser_g = want.pop("series"), got.pop("series")
    assert got == want
    for k, v in ser_w.items():
        if k == ("var", "val"):
            np.testing.assert_allclose(np.array(ser_g[k], float),
                                       np.array(v, float), rtol=1e-12)
        else:
            assert ser_g[k] == v, k
    eg.close()
    # reopen on the card: the same answers from the store and the WAL
    e2 = Engine("g", Options(driver="file", path=str(tmp_path / "cuda"),
                             device="cuda", background_merge=False))
    again = _answers(e2, e2.table("t"))
    again.pop("series")
    assert again == got
    e2.close()
