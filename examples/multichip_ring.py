"""Multi-device particle sharding demo (runs on a virtual CPU mesh too).

    python examples/multichip_ring.py                    # all local GPUs
    NBODY_CPU_DEVICES=8 python examples/multichip_ring.py   # virtual mesh
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

_n_cpu = os.environ.get("NBODY_CPU_DEVICES")
if _n_cpu:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_n_cpu}"
    ).strip()

import jax

if _n_cpu:
    jax.config.update("jax_platforms", "cpu")

if jax.device_count() == 1:
    print(f"note: only 1 device ({jax.devices()[0]}); mesh of 1 "
          f"(set NBODY_CPU_DEVICES=8 for a virtual mesh)")

import n_body_problem_tpu as nb
from n_body_problem_tpu.parallel import ShardedSimulation, make_ring_mesh

mesh = make_ring_mesh()
cfg = nb.SimConfig(solver="direct", integrator="leapfrog", dt=0.005)
state = nb.models.plummer(4096, seed=0)

sim = ShardedSimulation(cfg, state, mesh, strategy="half_ring")
print(f"mesh: {mesh.devices.size} devices, strategy=half_ring "
      f"(Newton's 3rd law across chips)")

for _ in range(3):
    sim.run(100)
    d = sim.diagnostics()
    print(f"step {d['step']:>4d}  E={d['energy']:.6e}  overspeed={d['overspeed']}")
