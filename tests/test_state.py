"""SimState construction, padding, pytree behavior, diagnostics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from n_body_problem_tpu import SimConfig, make_state, models, pad_state, unpad_state
from n_body_problem_tpu import diagnostics as diag


def test_make_state_validates_shapes():
    with pytest.raises(ValueError):
        make_state(np.zeros((4, 2)), np.zeros((4, 2)), np.zeros(4))
    with pytest.raises(ValueError):
        make_state(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(5))


def test_pad_unpad_roundtrip():
    state = models.plummer(100, seed=0)
    padded = pad_state(state, multiple=256, extra=1)
    assert padded.n == 257  # the reference's K*256+1 policy (kernel.cu:260-278)
    assert padded.n_real == 100
    assert float(jnp.sum(padded.mass[100:])) == 0.0
    back = unpad_state(padded)
    assert back.n == 100
    np.testing.assert_array_equal(np.asarray(back.pos), np.asarray(state.pos))


def test_state_is_pytree():
    state = models.plummer(32, seed=0)
    doubled = jax.tree_util.tree_map(lambda x: x * 2, state)
    np.testing.assert_allclose(np.asarray(doubled.pos), 2 * np.asarray(state.pos))
    assert doubled.n_real == 32  # static metadata survives tree_map


def test_jit_with_static_n_real():
    state = models.plummer(16, seed=0)

    @jax.jit
    def f(s):
        return jnp.sum(s.real_mask())

    assert int(f(state)) == 16
    padded = pad_state(state, multiple=32)
    assert int(f(padded)) == 16


def test_diagnostics_mask_padding():
    state = models.plummer(100, seed=1)
    padded = pad_state(state, multiple=64)
    cfg = SimConfig(solver="direct")
    for fn in (diag.kinetic_energy, diag.momentum, diag.angular_momentum, diag.max_abs):
        np.testing.assert_allclose(
            np.asarray(fn(state)), np.asarray(fn(padded)), rtol=1e-6, atol=1e-7
        )
    np.testing.assert_allclose(
        float(diag.potential_energy(state, cfg)),
        float(diag.potential_energy(padded, cfg)),
        rtol=1e-6,
    )


def test_summary_and_probes():
    cfg = SimConfig(solver="direct")
    state = models.plummer(64, seed=2)
    s = diag.summary(state, cfg)
    assert s["n_real"] == 64
    assert s["energy"] == pytest.approx(s["kinetic"] + s["potential"])
    assert s["overspeed"] == 0
    text = diag.first_bodies(state, 5)
    assert text.count("\n") == 4 and text.startswith("No.0 data point:")


def test_config_roundtrip(tmp_path):
    cfg = SimConfig(dt=0.004, solver="blocked", integrator="leapfrog")
    p = tmp_path / "cfg.json"
    cfg.save(p)
    cfg2 = SimConfig.from_file(p)
    assert cfg2 == cfg
    assert cfg.eps2_effective == pytest.approx(1e-4)
    with pytest.raises(ValueError):
        SimConfig(solver="nope")


def test_tuned_tree_overrides():
    """The measured per-N tuning table yields valid SimConfig overrides
    and a runnable small-N treecode Simulation (tools/tune_small_n.py)."""
    from n_body_problem_tpu.config import tuned_tree_overrides
    from n_body_problem_tpu import Simulation

    small = tuned_tree_overrides(20480)
    assert small["tree_src_tile"] == 32  # census-modelled
    cfg = SimConfig(solver="treecode", **small)  # all keys valid fields
    assert SimConfig(**tuned_tree_overrides(1 << 20)) is not None
    sim = Simulation(cfg, models.plummer(4096, seed=0))
    sim.run(4)
    assert bool(jnp.all(jnp.isfinite(sim.state.pos)))


def test_config_toml(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text('dt = 0.002\nsolver = "blocked"\nintegrator = "leapfrog"\n')
    cfg = SimConfig.from_file(p)
    assert cfg.dt == 0.002 and cfg.solver == "blocked"


def test_profiling_noop_trace(tmp_path):
    from n_body_problem_tpu.utils.profiling import trace

    with trace(None):
        pass  # no-op path must not require a profiler session
