"""ShardedSimulation — the multi-chip counterpart of Simulation.

Scales BASELINE.json configs 4-5 (N=262k over 4 devices, N=1M+): bodies
are sharded over a ring mesh, whole multi-step runs scan on-device inside one
jit, and the only cross-chip traffic per force evaluation is the
``ppermute`` tile rotation (strategy ``"ring"``) or the half-ring packet
exchange (strategy ``"half_ring"``, Newton's 3rd law across chips).

>>> mesh = make_ring_mesh()                       # all local devices
>>> sim = ShardedSimulation(cfg, state, mesh, strategy="half_ring")
>>> sim.run(1000)
>>> sim.diagnostics()["energy"]
"""

from __future__ import annotations

import time as _time

import jax
import jax.numpy as jnp
from jax import lax

from n_body_problem_tpu.config import SimConfig
from n_body_problem_tpu.parallel.mesh import RING_AXIS, make_ring_mesh
from n_body_problem_tpu.parallel.ring import make_sharded_step, shard_state
from n_body_problem_tpu.plan import ExecutionPlan, execution_plan
from n_body_problem_tpu.state import SimState, pad_state


class ShardedSimulation:
    def __init__(
        self,
        cfg: SimConfig,
        state: SimState,
        mesh=None,
        *,
        strategy: str = "ring",
        axis_name: str = RING_AXIS,
        local_solver: str = "auto",
        plan: ExecutionPlan | None = None,
    ):
        self.plan = plan = plan or execution_plan()
        staged = strategy == "treecode_staged"
        if cfg.tree_tile == 0:
            # Auto target-row granularity, mirroring Simulation.__init__:
            # 128 when the per-device hierarchical far field will engage,
            # 32 on the single-level flat/dense paths.
            from n_body_problem_tpu.ops.treecode import DEFAULT_HIER_TILE

            hier = (strategy in ("treecode", "treecode_staged")
                    and plan.tree_variant(cfg, state.n,
                                          lists=plan.tree_lists or staged)
                    == "hier")
            cfg = cfg.replace(tree_tile=DEFAULT_HIER_TILE if hier else 32)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_ring_mesh()
        self.strategy = strategy
        n_dev = self.mesh.devices.size
        if strategy in ("treecode", "treecode_staged"):
            self._init_treecode(cfg, state, axis_name, staged=staged)
            return
        if cfg.morton_sort:
            import numpy as _np

            from n_body_problem_tpu.state import unpad_state
            from n_body_problem_tpu.utils.morton import (
                apply_permutation,
                morton_argsort,
            )

            real = unpad_state(state) if state.n != state.n_real else state
            state = apply_permutation(real, morton_argsort(_np.asarray(real.pos)))
        if state.n % n_dev:
            state = pad_state(state, multiple=n_dev)
        self.state = shard_state(state, self.mesh)

        if cfg.integrator == "leapfrog":
            # Prime the carried acceleration (leapfrog's first half-kick
            # needs the force at the initial positions).
            from jax.sharding import PartitionSpec as P

            from n_body_problem_tpu.parallel.ring import half_ring_acc, ring_acc

            force = half_ring_acc if strategy == "half_ring" else ring_acc
            fkw = dict(axis_name=axis_name, eps2=cfg.eps2,
                       compensate=cfg.compensate, G=cfg.G,
                       local_solver=local_solver, plan=plan)
            row = P(axis_name)
            acc = jax.jit(jax.shard_map(
                lambda p, m: force(p, m, **fkw),
                mesh=self.mesh, in_specs=(row, row), out_specs=row,
                check_vma=False,
            ))(self.state.pos, self.state.mass)
            self.state = SimState(
                pos=self.state.pos, vel=self.state.vel, mass=self.state.mass,
                eps=self.state.eps, acc=acc, time=self.state.time,
                step=self.state.step, n_real=self.state.n_real,
            )
        step = make_sharded_step(cfg, self.mesh, axis_name, strategy,
                                 local_solver, plan)

        def run_steps(s: SimState, n: int) -> SimState:
            def body(carry, _):
                return step(carry), None

            out, _ = lax.scan(body, s, length=n)
            return out

        donate = (0,) if cfg.donate else ()
        self._jit_run = jax.jit(run_steps, static_argnums=(1,), donate_argnums=donate)
        self._step = jax.jit(step, donate_argnums=donate)
        self.wall_seconds = 0.0

    def _init_treecode(self, cfg: SimConfig, state: SimState,
                       axis_name: str, staged: bool = False) -> None:
        """Distributed Barnes-Hut: bodies globally Morton-sorted, each
        chip owns a contiguous tile range; auto-tunes the static near
        capacity exactly like the single-chip path.

        ``staged=False``: replicated sources (parallel/tree.py — the
        throughput path). ``staged=True``: ring-streamed source panels +
        replicated summaries (parallel/stream.py — the capacity path;
        same planners, the flat-list machinery is mandatory)."""
        import math as _math

        import numpy as _np

        from n_body_problem_tpu.ops.treecode import (
            CHUNK_LANES,
            suggest_flat_cap_sharded,
            suggest_hier_sharded,
            suggest_max_near,
        )
        from n_body_problem_tpu.parallel.tree import (
            make_sharded_treecode_force,
            make_sharded_treecode_run,
        )
        from n_body_problem_tpu.state import unpad_state
        from n_body_problem_tpu.utils.morton import (
            apply_permutation,
            morton_argsort,
        )

        n_dev = self.mesh.devices.size
        real = unpad_state(state) if state.n != state.n_real else state
        init_perm = morton_argsort(_np.asarray(real.pos))
        state = apply_permutation(real, init_perm)
        state = pad_state(state, multiple=_math.lcm(
            n_dev * cfg.tree_tile, cfg.tree_src_tile, 256))
        if cfg.tree_vip_tiles == -1:
            from n_body_problem_tpu.config import resolve_vip_tiles

            cfg = cfg.replace(
                tree_vip_tiles=resolve_vip_tiles(-1, state.n))
        # Compacted flat/hier lists where the plan says so, mirroring
        # Simulation.__init__. The staged strategy is BUILT on the flat
        # machinery (per-shard compacted work lists feed the ring
        # stages), so it plans them on every platform.
        variant = self.plan.tree_variant(
            cfg, state.n, n_dev, lists=self.plan.tree_lists or staged)
        use_flat = (cfg.tree_flat_cap == 0 and variant != "dense"
                    and (state.n // cfg.tree_tile) % n_dev == 0)
        if staged and not use_flat and cfg.tree_flat_cap <= 0:
            raise ValueError(
                "treecode_staged needs the flat-list machinery: N must "
                f"be >= {CHUNK_LANES}, a multiple of src_tile="
                f"{cfg.tree_src_tile}, with K_t divisible by "
                f"n_dev={n_dev} (or pass an explicit tree_flat_cap)")
        src = (cfg.tree_src_tile
               if use_flat or cfg.tree_flat_cap > 0 else None)
        use_hier = variant == "hier" and (use_flat or cfg.tree_flat_cap > 0)
        mac = dict(mac_tau=cfg.tree_mac_tau, eps2=cfg.eps2,
                   compensate=cfg.compensate)
        if use_hier:
            # Per-chip planner (flat_cap/far_cap are worst-chip-block
            # demands; max_near/far_max stay global per-row bounds).
            caps = suggest_hier_sharded(
                state.pos, state.mass, n_dev, tile=cfg.tree_tile,
                src_tile=cfg.tree_src_tile, theta=cfg.tree_theta,
                vip_tiles=cfg.tree_vip_tiles, slack=cfg.tree_near_slack,
                **dict(mac, mac_tau=cfg.tree_hier_tau,
                       mac_tau0=cfg.tree_mac_tau,
                       union_coarse=cfg.tree_hier_union),
            )
            for field, key in (("tree_max_near", "max_near"),
                               ("tree_flat_cap", "flat_cap"),
                               ("tree_far_max", "far_max"),
                               ("tree_far_cap", "far_cap")):
                if getattr(cfg, field) == 0:
                    cfg = cfg.replace(**{field: caps[key]})
        else:
            if cfg.tree_max_near == 0:
                cfg = cfg.replace(tree_max_near=suggest_max_near(
                    state.pos, state.mass, tile=cfg.tree_tile,
                    theta=cfg.tree_theta, vip_tiles=cfg.tree_vip_tiles,
                    src_tile=src, **mac,
                ))
            if use_flat:
                cfg = cfg.replace(tree_flat_cap=suggest_flat_cap_sharded(
                    state.pos, state.mass, n_dev, tile=cfg.tree_tile,
                    src_tile=cfg.tree_src_tile, theta=cfg.tree_theta,
                    vip_tiles=cfg.tree_vip_tiles, slack=cfg.tree_near_slack,
                    **mac,
                ))
        self.cfg = cfg
        self.state = shard_state(state, self.mesh)
        self.sort_perm = init_perm
        if cfg.integrator == "leapfrog":
            if staged:
                from n_body_problem_tpu.parallel.stream import (
                    make_staged_force,
                )

                acc = jax.jit(make_staged_force(
                    cfg, self.mesh, axis_name, self.plan))(
                    self.state.pos, self.state.mass)
            else:
                force = make_sharded_treecode_force(cfg, self.mesh,
                                                    axis_name)
                acc = jax.jit(force)(
                    self.state.pos, self.state.mass,
                    jnp.asarray(state.n_real, jnp.int32),
                )
            self.state = SimState(
                pos=self.state.pos, vel=self.state.vel, mass=self.state.mass,
                eps=self.state.eps, acc=acc, time=self.state.time,
                step=self.state.step, n_real=self.state.n_real,
            )
        if staged:
            from n_body_problem_tpu.parallel.stream import make_staged_run

            run = make_staged_run(cfg, self.mesh, axis_name, self.plan)
        else:
            run = make_sharded_treecode_run(cfg, self.mesh, axis_name,
                                            self.plan)
        donate = (0,) if cfg.donate else ()
        self._jit_tree_run = jax.jit(run, static_argnums=(1,),
                                     donate_argnums=donate)
        self._jit_run = None
        self._step = None
        self.wall_seconds = 0.0

    def run(self, n_steps: int) -> SimState:
        t0 = _time.perf_counter()
        if self.strategy in ("treecode", "treecode_staged"):
            import numpy as _np

            self.state, ids = self._jit_tree_run(self.state, n_steps)
            ids = _np.asarray(ids)[: self.state.n_real]
            self.sort_perm = (ids if self.sort_perm is None
                              else _np.asarray(self.sort_perm)[ids])
        else:
            self.state = self._jit_run(self.state, n_steps)
        self.state.block_until_ready()
        self.wall_seconds += _time.perf_counter() - t0
        return self.state

    def step(self) -> SimState:
        self.state = self._step(self.state)
        return self.state

    # ------------------------------------------------------------ metrics
    def pairs_per_step(self) -> int:
        """Physical directed pair interactions per step (real bodies only)."""
        k = self.state.n_real
        return k * (k - 1)

    def padded_pairs_per_step(self) -> int:
        return self.state.n * self.state.n

    def diagnostics(self) -> dict:
        from n_body_problem_tpu import diagnostics as diag

        return diag.summary(self.state, self.cfg)
