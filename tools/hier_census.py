"""Acceptance census for the hierarchical treecode (runs on the CPU).

Counts UNCAPPED near/far evals per target row of the exact production
acceptance chain (`_hier_open_masks` + `_chain_evals`) on a Morton-
sorted Plummer sphere — the cost model behind capacity planning and
the acceptance decisions in docs/acceptance.md:

- the 65k→1M scaling table (far/row growth, compression vs flat),
- the wide-halo-row pathology (far_max ≈ K_src) and its fix
  (`tree_hier_union`: per-body-union distances at coarse levels),
- the per-level composition (geometric decay check).

Usage: python tools/hier_census.py [--src TILE] [N ...]
       (defaults: production src tile, N in {65536, 262144})
Emits one JSON line per (N, union_coarse) plus a per-level line for
union=True. Counts only (no timing), so it forces the CPU backend.
"""
from __future__ import annotations

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, ".")


def census(n: int, src_tile: int = 0, tau0: float = 0.0,
           hier_tau: float = 0.0) -> None:
    from n_body_problem_tpu import SimConfig, Simulation, models
    from n_body_problem_tpu.ops import treecode as tc

    tile = 128
    kw = {"tree_src_tile": src_tile} if src_tile else {}
    if tau0:
        kw["tree_mac_tau"] = tau0
    if hier_tau:
        kw["tree_hier_tau"] = hier_tau
    sim = Simulation(SimConfig(solver="treecode", tree_tile=tile, **kw),
                     models.plummer(n, seed=0))
    st, cfg = sim.state, sim.cfg
    src = cfg.tree_src_tile
    k_s = st.n // src
    xc, yc, zc = st.pos[:, 0], st.pos[:, 1], st.pos[:, 2]
    vipn = tc._clamp_vip(
        tc._vip_src_tiles(cfg.tree_vip_tiles, tile, src), k_s)
    mass_tree = st.mass
    if vipn:
        mass_tree, _, _ = tc._vip_split(xc, yc, zc, st.mass, src, vipn)
    plan = tc._level_plan(k_s)
    levels = tc._level_summaries(xc, yc, zc, mass_tree, src, plan,
                                 tc.HIER_BRANCH)

    for union in (False, True):
        opens, _, _, _ = tc._hier_open_masks(
            xc, yc, zc, levels, tile, src, mac_tau=cfg.tree_hier_tau,
            theta=cfg.tree_theta, eps2=cfg.eps2, c2=cfg.compensate ** 2,
            mac_tau0=cfg.tree_mac_tau, union_coarse=union)
        evals, reach0 = tc._chain_evals(opens, tc.HIER_BRANCH)
        ev0 = jnp.logical_and(reach0, jnp.logical_not(opens[0]))
        per = ([float(ev0.sum(1).mean())]
               + [float(e.sum(1).mean()) for e in evals[1:]])
        far = np.asarray(ev0.sum(1) + sum(e.sum(1) for e in evals[1:]))
        near = np.asarray(jnp.logical_and(reach0, opens[0]).sum(1))
        rec = dict(n=st.n, src=src, k_src=k_s, union_coarse=union,
                   near_mean=round(float(near.mean()), 1),
                   near_max=int(near.max()),
                   near_pairs_mean=round(float(near.mean()) * src, 1),
                   far_mean=round(float(far.mean()), 1),
                   far_max=int(far.max()),
                   flat_far_mean=round(float(k_s - near.mean()), 1))
        if union:
            rec["far_mean_by_level"] = {
                f"K{plan[i]}": round(per[i], 1) for i in range(len(plan))}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]

    def _opt(name: str, cast):
        if name in args:
            i = args.index(name)
            v = cast(args[i + 1])
            del args[i:i + 2]
            return v
        return cast(0)

    src_arg = _opt("--src", int)
    tau0_arg = _opt("--tau0", float)
    hier_tau_arg = _opt("--hier-tau", float)
    ns = [int(a) for a in args] or [65536, 262144]
    for n_arg in ns:
        census(n_arg, src_arg, tau0_arg, hier_tau_arg)
