"""n_body_problem_tpu — a gravitational N-body framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the CUDA+OpenGL
reference simulator ``ctbfl/N_body_problem`` (see SURVEY.md): softened
direct-sum O(N^2) gravity with multiple solver backends (pure-XLA blocked,
matmul formulation, an all-pairs GPU Pallas kernel), a Barnes-Hut
treecode, the reference's Newton's-third-law half-pair method across
devices (``half_ring``), semi-implicit Euler /
leapfrog integrators under ``lax.scan``, the reference's four dataset
formats (tipsy binary, tab, dat, NEMO snap), a device-side splat renderer
replacing the CUDA-GL point-sprite pipeline, energy/momentum diagnostics,
checkpoint/resume, and multi-device scaling via particle sharding with
``ppermute`` ring tile exchange. Runs on an NVIDIA GPU; the CPU runs the
plain XLA forms (tests).

Public API::

    import n_body_problem_tpu as nb

    cfg = nb.SimConfig(dt=0.008)
    state = nb.models.plummer(4096, seed=0)
    sim = nb.Simulation(cfg, state)
    sim.run(1000)
    print(nb.diagnostics.total_energy(sim.state, cfg))
"""

from n_body_problem_tpu.config import SimConfig
from n_body_problem_tpu.state import SimState, make_state, pad_state, unpad_state
from n_body_problem_tpu.simulation import Simulation, make_step_fn, run_steps
from n_body_problem_tpu import diagnostics
from n_body_problem_tpu import models
from n_body_problem_tpu import ops
from n_body_problem_tpu import io
from n_body_problem_tpu import render
from n_body_problem_tpu import parallel

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "SimState",
    "make_state",
    "pad_state",
    "unpad_state",
    "Simulation",
    "make_step_fn",
    "run_steps",
    "diagnostics",
    "models",
    "ops",
    "io",
    "render",
    "parallel",
]
