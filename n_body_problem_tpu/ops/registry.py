"""Solver registry: config -> force function.

The reference selects its solver at compile time via ``#define VERSION``
(``kernel.cu:70-73``). Here ``SimConfig.solver`` picks one at trace time;
``"auto"`` and the form of each stage come from the execution plan
(:mod:`n_body_problem_tpu.plan`).
"""

from __future__ import annotations

from typing import Callable

import jax

from n_body_problem_tpu.config import SimConfig
from n_body_problem_tpu.ops import forces
from n_body_problem_tpu.plan import ExecutionPlan, execution_plan

ForceFn = Callable[[jax.Array, jax.Array], jax.Array]


def make_force_fn(cfg: SimConfig, plan: ExecutionPlan | None = None,
                  n: int | None = None) -> ForceFn:
    """Build ``(pos, mass) -> acc`` for the configured solver.

    All returned functions require N to already satisfy the solver's padding
    (see :func:`n_body_problem_tpu.ops.forces.required_padding` and
    :func:`n_body_problem_tpu.state.pad_state`). ``n`` only sizes the
    treecode's automatic VIP budget; the returned function stays
    shape-generic.
    """
    plan = plan or execution_plan()
    solver = plan.solver(cfg.solver)
    kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G)

    if solver == "direct":
        return lambda pos, mass: forces.direct_acc(pos, mass, **kw)
    if solver == "blocked":
        return lambda pos, mass: forces.blocked_acc(
            pos, mass, block_size=cfg.block_size, **kw
        )
    if solver == "mxu":
        return lambda pos, mass: forces.mxu_acc(
            pos, mass, block_size=cfg.block_size, **kw
        )
    if solver == "pallas":
        from n_body_problem_tpu.ops import pallas_force

        return lambda pos, mass: pallas_force.pallas_acc(
            pos, mass, tile_i=cfg.pallas_tile_i, tile_j=cfg.pallas_tile_j,
            interpret=plan.interpret, **kw
        )
    if solver == "treecode":
        from n_body_problem_tpu.config import resolve_vip_tiles
        from n_body_problem_tpu.ops import treecode

        if cfg.tree_vip_tiles == -1:
            # Simulation resolves the auto sentinel at init; resolve here
            # too for direct make_force_fn callers (n=None falls back to
            # the flagship budget).
            cfg = cfg.replace(tree_vip_tiles=resolve_vip_tiles(
                -1, n if n else 262144))
        max_near = cfg.tree_max_near or treecode.DEFAULT_MAX_NEAR
        tile = cfg.tree_tile or 32
        if cfg.tree_hier and cfg.tree_flat_cap > 0 and cfg.tree_far_cap > 0:
            # Hierarchical production path (multi-level compacted far
            # lists); acceptance built fresh per call — Simulation.run
            # caches it across tree_rebuild_every steps instead.
            hsel = dict(tile=tile, src_tile=cfg.tree_src_tile,
                        theta=cfg.tree_theta, max_near=max_near,
                        vip_tiles=cfg.tree_vip_tiles)

            def hier_force(pos, mass):
                x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
                aux = treecode.build_tree_hier_cols(
                    x, y, z, mass, slack=cfg.tree_near_slack,
                    flat_cap=cfg.tree_flat_cap, far_max=cfg.tree_far_max,
                    far_cap=cfg.tree_far_cap, mac_tau=cfg.tree_hier_tau,
                    mac_tau0=cfg.tree_mac_tau,
                    union_coarse=cfg.tree_hier_union,
                    eps2=cfg.eps2, compensate=cfg.compensate, **hsel)
                ax, ay, az = treecode.treecode_acc_hier_cols(
                    x, y, z, mass, aux, far_max=cfg.tree_far_max, plan=plan,
                    **kw, **hsel)
                import jax.numpy as _jnp

                return _jnp.stack([ax, ay, az], axis=1)

            return hier_force
        if cfg.tree_flat_cap > 0:
            # The flat (asymmetric, mean-bound) production path; builds
            # its acceptance fresh per call — Simulation.run caches it
            # across tree_rebuild_every steps instead.
            sel = dict(tile=tile, src_tile=cfg.tree_src_tile,
                       theta=cfg.tree_theta, max_near=max_near,
                       vip_tiles=cfg.tree_vip_tiles)

            def flat_force(pos, mass):
                aux = treecode.build_tree_flat(
                    pos, mass, slack=cfg.tree_near_slack,
                    flat_cap=cfg.tree_flat_cap,
                    mac_tau=cfg.tree_mac_tau, eps2=cfg.eps2,
                    compensate=cfg.compensate, **sel)
                return treecode.treecode_acc_flat(pos, mass, aux, plan=plan,
                                                  **kw, **sel)

            return flat_force
        return lambda pos, mass: treecode.treecode_acc(
            pos, mass, tile=tile, theta=cfg.tree_theta,
            max_near=max_near, vip_tiles=cfg.tree_vip_tiles,
            mac_tau=cfg.tree_mac_tau, **kw
        )
    if solver == "pair_matrix":
        from n_body_problem_tpu.ops import pair_matrix

        return lambda pos, mass: pair_matrix.pair_matrix_acc(pos, mass, **kw)
    raise ValueError(f"unknown solver {solver!r}")
