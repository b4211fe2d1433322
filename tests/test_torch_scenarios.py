"""The port's seeded scenario runner (knoxdb_tpu_torch.testing.scenario)
against knoxdb_tpu's, at the seeds of tests/test_scenarios.py: every run
of the port holds the engine to its python model after each step (it
raises on any divergence), runs the reference test's full step counts,
and at a cut step count gives the same coverage report as knoxdb_tpu's
run of the same seed. The port runs on the CPU.

The cuts: knoxdb_tpu compiles its queries for each new segment shape, so
its runs here take PAIR_STEPS steps where the reference test takes
STEPS (plain 40 -> 16, deep 88 -> 10, rich 44 -> 5, determinism
25 -> 10); the port's own runs keep STEPS."""

import pytest

from knoxdb_tpu.testing import scenario as RSC
from knoxdb_tpu_torch.testing import scenario as TSC

STEPS = {"plain": 40, "deep": 88, "rich": 44, "det": 25}
PAIR_STEPS = {"plain": 16, "deep": 10, "rich": 5, "det": 10}


def _pair(fn, seed, path, steps):
    """The same seeded run in both packages: equal coverage reports."""
    want = getattr(RSC, fn)(seed, str(path / "ref"), steps=steps)
    got = getattr(TSC, fn)(seed, str(path / "port"), steps=steps,
                           device="cpu")
    assert got == want
    return got


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_workload_model_equivalence(seed, tmp_path):
    rep = TSC.run_scenario(seed, str(tmp_path / f"s{seed}"),
                           steps=STEPS["plain"], device="cpu")
    assert all(v > 0 for v in rep.values()), rep
    _pair("run_scenario", seed, tmp_path, PAIR_STEPS["plain"])


@pytest.mark.parametrize("seed", [3, 11, 57, 101, 257, 999])
def test_workload_deep(seed, tmp_path):
    rep = TSC.run_scenario(seed, str(tmp_path / f"d{seed}"),
                           steps=STEPS["deep"], device="cpu")
    assert all(v > 0 for v in rep.values()), rep
    _pair("run_scenario", seed, tmp_path, PAIR_STEPS["deep"])


@pytest.mark.parametrize("seed", [5, 13, 77])
def test_workload_rich(seed, tmp_path):
    rep = TSC.run_scenario_rich(seed, str(tmp_path / f"r{seed}"),
                                steps=STEPS["rich"], device="cpu")
    assert all(v > 0 for v in rep.values()), rep
    _pair("run_scenario_rich", seed, tmp_path, PAIR_STEPS["rich"])


def test_scenario_is_deterministic(tmp_path):
    r1 = TSC.run_scenario(99, str(tmp_path / "a"), steps=STEPS["det"],
                          device="cpu")
    r2 = TSC.run_scenario(99, str(tmp_path / "b"), steps=STEPS["det"],
                          device="cpu")
    assert r1 == r2
    _pair("run_scenario", 99, tmp_path, PAIR_STEPS["det"])


def test_scenario_device_defaults_to_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        TSC.run_scenario(1, str(tmp_path / "c"), steps=2)
