"""Per-stage device time of the hierarchical treecode on the GPU.

    python tools/profile_treecode.py [--n 1048576] [--reps 5]
                                     [--out chiprun_out/profile_treecode.json]

Builds the production configuration through ``Simulation`` (planned
capacities, Morton-sorted state), then times each stage of one force
evaluation on its own: the Morton resort and the acceptance build (once
per ``tree_rebuild_every`` steps), the level summaries, the near field,
the far field and the VIP sweep (kernel and XLA form where both exist),
the whole force, and ``Simulation.run`` ms/step for reference. Each time
is the best of ``--reps`` calls that end in ``block_until_ready``; stage
times do not add up to the step exactly (fusion and overlap differ).
Prints one JSON line per stage and writes them, with the card's name and
power limit, to ``--out``. ``--interpret`` rehearses on the CPU at tiny
sizes (times meaningless).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--out", default="chiprun_out/profile_treecode.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import device_record
    from n_body_problem_tpu import SimConfig, Simulation, models
    from n_body_problem_tpu.ops import treecode as tc
    from n_body_problem_tpu.plan import XLA, execution_plan
    from n_body_problem_tpu.utils.cache import enable_compile_cache
    from n_body_problem_tpu.utils.morton import resort_cols

    enable_compile_cache()
    plan = execution_plan("gpu")
    if args.interpret:
        plan = dataclasses.replace(plan, interpret=True)
        info = {"platform": jax.devices()[0].platform}
    else:
        info = device_record()
    xla = dataclasses.replace(plan, near=XLA, far=XLA, pair=XLA)
    print(json.dumps(info), flush=True)

    sim = Simulation(SimConfig(solver="treecode"),
                     models.plummer(args.n, seed=0), plan=plan)
    c = sim.cfg
    assert sim.tree_variant == "hier", sim.tree_variant
    st = sim.state
    x, y, z = (st.pos[:, i] for i in range(3))
    m = st.mass
    n = st.n
    k_s = n // c.tree_src_tile
    entries = tc.CHUNK_LANES // c.tree_src_tile
    sel = dict(tile=c.tree_tile, src_tile=c.tree_src_tile,
               theta=c.tree_theta, max_near=c.tree_max_near,
               vip_tiles=c.tree_vip_tiles)
    aux = jax.jit(lambda x, y, z, m: tc.build_tree_hier_cols(
        x, y, z, m, slack=c.tree_near_slack, flat_cap=c.tree_flat_cap,
        far_max=c.tree_far_max, far_cap=c.tree_far_cap,
        mac_tau=c.tree_hier_tau, mac_tau0=c.tree_mac_tau,
        union_coarse=c.tree_hier_union, eps2=c.eps2,
        compensate=c.compensate, **sel))
    flat_src, chunk_tgt, far_src, far_tgt, is_vip = aux(x, y, z, m)
    (_, _, _, max_near, vip_src, levels_plan, _, far_max) = tc._hier_static(
        n, c.tree_tile, c.tree_src_tile, c.tree_theta, c.tree_max_near,
        c.tree_vip_tiles, c.tree_far_max, tc.HIER_BRANCH)
    c2 = c.compensate ** 2
    gc3 = c.G * c2 * c.compensate
    m_tree = jnp.where(is_vip, 0.0, m)
    src = tc._source_cols(x, y, z, m_tree * gc3, c.tree_src_tile)
    summ = tc._summary_panel(tc._level_summaries(
        x, y, z, m_tree, c.tree_src_tile, levels_plan, tc.HIER_BRANCH))
    vip_tile_idx, _ = tc._vip_body_idx(is_vip, k_s, c.tree_src_tile, vip_src)
    near_kw = dict(eps2=c.eps2, c2=c2, tile=c.tree_tile,
                   src_tile=c.tree_src_tile, max_chunks=max_near // entries)
    far_kw = dict(eps2=c.eps2, c2=c2, G=c.G, tile=c.tree_tile,
                  max_chunks=far_max // tc.FAR_ENTRIES)
    zero = jnp.zeros((n,), jnp.float32)

    def vip(p):
        return lambda x, y, z, m, idx: tc._apply_vip(
            zero, zero, zero, x, y, z, m, idx, k_s=k_s,
            src_tile=c.tree_src_tile, gc3=gc3, eps2=c.eps2, c2=c2, plan=p)

    def force(p):
        return lambda x, y, z, m, a: tc.treecode_acc_hier_cols(
            x, y, z, m, a, eps2=c.eps2, compensate=c.compensate, G=c.G,
            far_max=c.tree_far_max, plan=p, **sel)

    def reaction(splits):
        from n_body_problem_tpu.ops.pallas_force import pair_block_cols

        return lambda vx, vy, vz, *a: pair_block_cols(
            vx, vy, vz, *a, eps2=c.eps2, c2=c2, splits=splits,
            interpret=plan.interpret)

    vrow = lambda col: col.reshape(k_s, -1)[vip_tile_idx].reshape(-1)
    react_args = (vrow(x), vrow(y), vrow(z), x, y, z, m * gc3)
    cols = (x, y, z) + (zero,) * 6 + (m, st.eps, jnp.arange(n))
    stages = [
        ("resort", lambda *a: resort_cols(a, st.n_real), cols),
        ("build", lambda x, y, z, m: aux(x, y, z, m), (x, y, z, m)),
        ("summaries", lambda x, y, z, m: tc._summary_panel(
            tc._level_summaries(x, y, z, m, c.tree_src_tile, levels_plan,
                                tc.HIER_BRANCH)), (x, y, z, m_tree)),
        ("near kernel", lambda *a: tc._near_field_flat_cols(
            *a, plan=plan, **near_kw), (x, y, z, src, flat_src, chunk_tgt)),
        ("near xla", lambda *a: tc._near_field_flat_cols(
            *a, plan=xla, **near_kw), (x, y, z, src, flat_src, chunk_tgt)),
        ("far kernel", lambda *a: tc._far_field_hier_cols(
            *a, plan=plan, **far_kw), (x, y, z, summ, far_src, far_tgt)),
        ("far xla", lambda *a: tc._far_field_hier_cols(
            *a, plan=xla, **far_kw), (x, y, z, summ, far_src, far_tgt)),
        ("vip kernel", vip(plan), (x, y, z, m, vip_tile_idx)),
        ("vip xla", vip(xla), (x, y, z, m, vip_tile_idx)),
        ("vip reaction kernel, column splits", reaction(None), react_args),
        ("vip reaction kernel, no splits", reaction(1), react_args),
        ("force (plan)", force(plan), (x, y, z, m, (flat_src, chunk_tgt,
                                                   far_src, far_tgt, is_vip))),
    ]
    rows = []
    for name, fn, fargs in stages:
        f = jax.jit(fn)
        jax.block_until_ready(f(*fargs))
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*fargs))
            best = min(best, time.perf_counter() - t0)
        rows.append(dict(stage=name, n=n, ms=best * 1e3))
        print(json.dumps(rows[-1]), flush=True)

    sim.run(args.steps)
    t0 = time.perf_counter()
    sim.run(args.steps)
    rows.append(dict(stage=f"Simulation.run ms/step ({args.steps} steps, "
                           f"rebuild every {c.tree_rebuild_every})", n=n,
                     ms=(time.perf_counter() - t0) / args.steps * 1e3))
    print(json.dumps(rows[-1]), flush=True)
    rows.append(dict(stage="caps", max_near=c.tree_max_near,
                     flat_cap=c.tree_flat_cap, far_max=c.tree_far_max,
                     far_cap=c.tree_far_cap, vip_tiles=c.tree_vip_tiles,
                     near_chunks_used=int((chunk_tgt < n // c.tree_tile).sum()),
                     far_chunks_used=int((far_tgt < n // c.tree_tile).sum())))
    print(json.dumps(rows[-1]), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(info, rows=rows), indent=1))


if __name__ == "__main__":
    main()
