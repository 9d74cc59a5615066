"""Determinism: the answer to the reference's data-race worries.

The reference's symmetric kernel needed careful staggered-atomics reasoning
(``kernel.cu:756-757``) and still accumulates in nondeterministic order
across CUDA blocks. The all-pairs kernel here carries every sum inside one
program (no atomics) and the XLA reductions are deterministic, so repeated
runs must be bitwise identical — these tests pin that property (SURVEY.md
§5, race detection row). The half-pair kernel's float atomics are the
exception and are not pinned.
"""

import dataclasses

import jax
import numpy as np
import pytest

from n_body_problem_tpu import SimConfig, Simulation, models, pad_state
from n_body_problem_tpu.parallel import make_ring_mesh, make_sharded_step, shard_state
from n_body_problem_tpu.plan import execution_plan
from n_body_problem_tpu.simulation import make_step_fn, run_steps


@pytest.mark.parametrize("solver", ["direct", "blocked", "mxu", "pallas"])
def test_bitwise_deterministic_runs(solver):
    cfg = SimConfig(solver=solver, block_size=64,
                    pallas_tile_i=64, pallas_tile_j=128)
    plan = execution_plan()
    if solver == "pallas":     # the GPU kernel, through the interpreter
        plan = dataclasses.replace(execution_plan("gpu"), interpret=True)
    results = []
    for _ in range(2):
        sim = Simulation(cfg, models.plummer(128, seed=0), plan=plan)
        sim.run(25)
        results.append(np.asarray(sim.state.pos))
    np.testing.assert_array_equal(results[0], results[1])


def test_model_generation_deterministic():
    a = models.plummer(256, seed=42)
    b = models.plummer(256, seed=42)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    c = models.plummer(256, seed=43)
    assert not np.array_equal(np.asarray(a.pos), np.asarray(c.pos))


def test_sharded_run_deterministic():
    mesh = make_ring_mesh(8)
    cfg = SimConfig(solver="direct")
    outs = []
    for _ in range(2):
        state = shard_state(pad_state(models.plummer(120, seed=1), multiple=8), mesh)
        step = jax.jit(make_sharded_step(cfg, mesh, strategy="half_ring"))
        for _ in range(5):
            state = step(state)
        outs.append(np.asarray(state.pos))
    np.testing.assert_array_equal(outs[0], outs[1])
