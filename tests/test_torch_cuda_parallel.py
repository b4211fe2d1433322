"""knoxdb_tpu_torch's parallel layer on the card: a virtual mesh of four
shards on cuda:0 gives the answers of a mesh of four CPU shards for a
scan (kernels #1 and #2 once per shard), a group scan (kernel #3 once per
shard) and a shuffle join (equal pairs and ladder decisions). Skips
without a card; run there with
`python -m pytest -m cuda tests/test_torch_cuda_parallel.py` (no jax
needed)."""

import numpy as np
import pytest
import torch

from knoxdb_tpu_torch.exec.device import DeviceSegment
from knoxdb_tpu_torch.exec.scan import AggSpec
from knoxdb_tpu_torch.ops import group_kernels as GK
from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.pack.segment import build_segment
from knoxdb_tpu_torch.parallel import Mesh, ShardedScanner
from knoxdb_tpu_torch.parallel import shuffle as SH
from knoxdb_tpu_torch.query.filter import Filter, and_, leaf
from knoxdb_tpu_torch.schema.schema import Builder
from knoxdb_tpu_torch.types import FieldType, FilterMode

pytestmark = pytest.mark.cuda

NDEV = 4


@pytest.fixture
def meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return (Mesh([torch.device("cpu")] * NDEV, ("packs",)),
            Mesh([torch.device("cuda", 0)] * NDEV, ("packs",)))


def _segment():
    rng = np.random.default_rng(0xBEEF)
    n = 29 * 4096 + 77
    sch = (Builder("t").pk("id").add("val", FieldType.UINT64)
           .add("bal", FieldType.INT64).add("g", FieldType.UINT16).finish())
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
            "bal": rng.integers(-1 << 40, 1 << 40, n),
            "g": rng.integers(0, 1000, n).astype(np.uint16)}
    return sch, build_segment(sch, data, 4096, uniform=NDEV)


def _scanners(meshes):
    sch, seg = _segment()
    cpu, gpu = meshes
    return (sch, ShardedScanner(DeviceSegment(seg, "cpu"), cpu),
            ShardedScanner(DeviceSegment(seg, "cuda:0"), gpu))


def test_scan_on_cuda_mesh_equals_cpu_mesh(meshes):
    sch, c, g = _scanners(meshes)
    cfg1 = leaf(Filter(sch.field("val"), FilterMode.RANGE, (1000, 50_000)))
    entry = and_(cfg1, leaf(Filter(sch.field("bal"), FilterMode.GT, 0)))
    for tree, aggs, kernel in (
            (cfg1, [AggSpec("count"), AggSpec("sum", "val")],
             "fused_range_sum_masked"),
            (entry, [AggSpec("count"), AggSpec("sum", "bal"),
                     AggSpec("min", "val"), AggSpec("max", "val")],
             "fused_tree_agg")):
        tree = tree.optimize()
        want = c.scan(tree, aggs)
        SK.reset_counts()
        got = g.scan(tree, aggs)
        torch.cuda.synchronize()
        assert SK.LAUNCHES[kernel] == NDEV
        assert (got.count, got.aggs) == (want.count, want.aggs)


@pytest.mark.parametrize("minmax", [False, True])
def test_group_scan_on_cuda_mesh_equals_cpu_mesh(meshes, minmax):
    sch, c, g = _scanners(meshes)
    tree = leaf(Filter(sch.field("val"), FilterMode.GT, 500)).optimize()
    wp, wc, wr = c.group_scan(tree, "g", ["bal"], minmax=minmax)
    GK.reset_counts()
    gp, gc, gr = g.group_scan(tree, "g", ["bal"], minmax=minmax)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["fused_group_partials"] == (0 if minmax else NDEV)
    assert gp.G == wp.G == 1000
    np.testing.assert_array_equal(gc, wc)
    for a, b in zip(gr["bal"], wr["bal"]):
        np.testing.assert_array_equal(np.asarray(a, object),
                                      np.asarray(b, object))


@pytest.mark.parametrize("kw", [{}, {"unique_build": True},
                                {"how": "left"}, {"skew_factor": 2.0}])
def test_shuffle_join_on_cuda_mesh_equals_cpu_mesh(meshes, kw):
    cpu, gpu = meshes
    rng = np.random.default_rng(0xC0FFEE)
    nr = 50_000
    rk = rng.permutation(np.arange(1, nr + 1)).astype(np.uint64)
    lk = rng.integers(1, nr * 2, 200_000).astype(np.uint64)
    lk[:40_000] = 777                       # a hot key
    want = SH.shuffle_join_rows(cpu, lk, rk, axis="packs", **kw)
    got = SH.shuffle_join_rows(gpu, torch.from_numpy(lk.view(np.int64))
                               .cuda(), rk, axis="packs", **kw)
    assert sorted(zip(got[0].tolist(), got[1].tolist())) == \
        sorted(zip(want[0].tolist(), want[1].tolist()))
    for key in ("core", "heavy_buckets", "cap_exchange", "cap_pairs",
                "rows_per_dev"):
        assert got[2][key] == want[2][key], key
