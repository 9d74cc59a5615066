"""Execution plan wiring, the compile-cache helper and chip_smoke's
contract (everything here runs on the CPU)."""

import json
import pathlib
import sys

import jax
import pytest

from n_body_problem_tpu import SimConfig, Simulation, models
from n_body_problem_tpu.plan import ExecutionPlan, execution_plan

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_plan_is_a_static_argument():
    """Force functions take the plan as a static jit argument."""
    gpu = execution_plan("gpu")
    assert isinstance(gpu, ExecutionPlan)
    assert hash(gpu) == hash(execution_plan("gpu"))
    assert gpu != execution_plan("cpu")


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no execution plan"):
        execution_plan(platform)


def test_simulation_takes_the_plans_path():
    """Simulation asks the plan once: the CPU's auto solver, the dense
    treecode path without explicit capacities, the hierarchical list path
    with them (and the 128-body rows that go with it)."""
    sim = Simulation(SimConfig(), models.plummer(512, seed=0))
    assert sim.solver == "mxu" and sim.plan == execution_plan("cpu")
    dense = Simulation(SimConfig(solver="treecode"),
                       models.plummer(4096, seed=0))
    assert dense.tree_variant == "dense" and dense.cfg.tree_tile == 32
    hier = Simulation(SimConfig(solver="treecode", tree_flat_cap=4096,
                                tree_far_cap=4096),
                      models.plummer(4096, seed=0))
    assert hier.tree_variant == "hier" and hier.cfg.tree_tile == 128


def test_compile_cache_uses_env_var_when_set(monkeypatch, tmp_path):
    from n_body_problem_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # untouched


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from n_body_problem_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    try:
        got = cache.enable_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_result_line():
    line = _chip_smoke().result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_chip_smoke_refuses_a_cpu(capsys):
    """Without a GPU the smoke test fails before any phase and prints no
    result line."""
    before = jax.config.jax_compilation_cache_dir
    try:
        assert _chip_smoke().main([]) == 1
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    out = capsys.readouterr().out
    assert '"ok"' not in out and "platform=cpu" in out
