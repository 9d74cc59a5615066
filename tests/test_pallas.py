"""All-pairs GPU kernel vs the direct oracle (Pallas interpreter on CPU).

The same kernel compiles for the card through Triton
(tests/test_gpu_kernels.py lowers it here and runs it under ``-m gpu``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from n_body_problem_tpu import SimConfig, Simulation, models, pad_state
from n_body_problem_tpu.ops import direct_acc
from n_body_problem_tpu.ops.pallas_force import pallas_acc
from n_body_problem_tpu.plan import execution_plan

EPS2 = 1e-6
C = 0.1


@pytest.fixture(scope="module")
def padded_cloud():
    state = pad_state(models.plummer(300, seed=7), multiple=128)
    return state.pos, state.mass


def test_pallas_matches_direct(padded_cloud):
    pos, mass = padded_cloud
    want = direct_acc(pos, mass, eps2=EPS2, compensate=C)
    got = pallas_acc(pos, mass, eps2=EPS2, compensate=C, tile_i=64,
                     tile_j=128, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_pallas_single_tile(padded_cloud):
    """Grid degenerates to one program with one loop step."""
    pos, mass = padded_cloud
    pos, mass = pos[:256], mass[:256]
    want = direct_acc(pos, mass, eps2=EPS2, compensate=C)
    got = pallas_acc(pos, mass, eps2=EPS2, compensate=C, tile_i=256,
                     tile_j=256, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_pallas_rejects_misaligned():
    state = models.plummer(100, seed=0)
    with pytest.raises(ValueError):
        pallas_acc(state.pos, state.mass, eps2=EPS2, tile_i=64, tile_j=128,
                   interpret=True)


def test_pallas_plain_softening(padded_cloud):
    pos, mass = padded_cloud
    want = direct_acc(pos, mass, eps2=1e-4, compensate=1.0)
    got = pallas_acc(pos, mass, eps2=1e-4, compensate=1.0, tile_i=64,
                     tile_j=128, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_simulation_with_pallas_solver():
    """Full Simulation path with solver='pallas' under the GPU plan (the
    kernel through the interpreter); the CPU plan refuses the kernel
    solver instead of interpreting it quietly."""
    cfg = SimConfig(solver="pallas", pallas_tile_i=64, pallas_tile_j=128)
    with pytest.raises(ValueError, match="GPU kernel"):
        Simulation(cfg, models.plummer(200, seed=1))
    plan = dataclasses.replace(execution_plan("gpu"), interpret=True)
    sim = Simulation(cfg, models.plummer(200, seed=1), plan=plan)
    assert sim.state.n % 128 == 0
    sim.run(3)
    assert int(sim.state.step) == 3
    assert bool(jnp.all(jnp.isfinite(sim.state.pos)))
