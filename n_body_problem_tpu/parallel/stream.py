"""Staged source streaming: the capacity-scaling path past replication.

The replicated multi-chip treecode (``parallel/tree.py``) keeps an O(N)
per-chip footprint: every force evaluation ``all_gather``s the global
position columns (12N bytes resident per chip) and rebuilds the
(K_s+1, 4, S) source panel from them (16N bytes) — throughput scales
1/D but capacity does not (docs/design.md "Capacity ceiling" quantifies
it at ~1e8 bodies on a 16-GiB chip, rebuild transients included).

This module is the decomposition that lifts the ceiling for the force
evaluation, promoted in round 5 from a flat/no-VIP force-only prototype
to a full ``ShardedSimulation`` strategy (``"treecode_staged"``):

- only the per-source-tile SUMMARIES replicate (~44 B per ``src_tile``
  bodies — 64x lighter than positions at src_tile=64 before lane
  padding); the coarser hierarchy levels merge from them identically on
  every chip (``_merge_levels`` — the same code the single-chip build
  runs), so the ENTIRE far field (flat or hierarchical) needs no body
  replication at all;
- the near-field source PANELS stream ring-wise: D stages, each
  ``ppermute``-ing one (N/D)-body shard around the ring while every chip
  evaluates the near entries whose source tiles live in the visiting
  shard. Peak resident source data drops from O(N) to O(N/D) +
  summaries; total interconnect bytes are unchanged (the gather moved the same
  shards, all at once). Acceptance lists compact PER SOURCE SHARD at
  build time — same scores, same criterion, bucketed by which ring
  stage can serve them;
- the VIP split stays GLOBAL and deterministic at O(W) traffic: every
  chip selects the same largest-radius source tiles from the gathered
  raw radii, the W-body VIP panel replicates by one masked ``psum``
  (each tile has exactly one owner), and the fused Newton's-3rd-law
  sweep + psum'd reactions work exactly as on the replicated path;
- the MAC normalization scale a_med gathers per-shard sampled monopole
  magnitudes (the per-shard stride equals the global stride, so the
  union IS the single-chip sample set) and medians the identical global
  vector on every chip — acceptance thresholds match the single-chip
  build exactly.

The remaining O(N) term is the resort TRANSIENT: every
``tree_rebuild_every`` steps the global Morton resort gathers the 12
state columns and multi-operand-sorts them redundantly (52N bytes
transient, ~5.2 GB at N=1e8 — the ceiling moves from resident O(N) to
transient O(N), ~2-3e8 bodies on 16 GiB; a ppermute bucket sort would
remove it and is sketched in docs/design.md).

Equality with the replicated path is by construction (same opening
scores ⇒ same near set, modulo the per-shard vs global top-k rounding
of the slack entries — an exact-near-work difference inside the force
error envelope; ``tests/test_stream.py`` pins the exact-limit bitwise
case, the production-tau tolerance case, VIP and hier equality, and the
end-to-end run; ``__graft_entry__.dryrun_multichip`` certifies the run
against the single-chip integrator).

Reference: the ring rotation is kernel.cu's shared-memory tile stream
(``kernel.cu:840-860``) lifted across chips, exactly like
``parallel/ring.py`` for the exact solvers.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from n_body_problem_tpu.config import SimConfig
from n_body_problem_tpu.ops.treecode import (
    CHUNK_LANES,
    FAR_ENTRIES,
    HIER_BRANCH,
    _chain_evals,
    _clamp_vip,
    _compact_open_lists,
    _far_field_cols,
    _far_field_hier_cols,
    _hier_open_masks,
    _level0_from_summaries,
    _level_plan,
    _merge_levels,
    _monopole_acc_mags,
    _near_field_flat_cols,
    _opening_scores,
    _source_cols,
    _summary_panel,
    _tile_radius,
    _vip_src_tiles,
    _vip_sweep_cols,
    tile_summaries_cols,
)
from n_body_problem_tpu.parallel.ring import RING_AXIS
from n_body_problem_tpu.plan import ExecutionPlan, execution_plan
from n_body_problem_tpu.state import SimState
from n_body_problem_tpu.utils.morton import morton_keys_cols

_TINY = 1e-30


def _staged_shapes(cfg: SimConfig, n_l: int, n_dev: int):
    """Static per-shard shape/capacity plan (trace time)."""
    tile = cfg.tree_tile or 32
    src = cfg.tree_src_tile
    entries = CHUNK_LANES // src
    k_t_l = n_l // tile
    k_s_l = n_l // src
    k_s_g = k_s_l * n_dev
    if k_s_l < entries:
        # Mirror _flat_src_static's guard at the per-shard count: with
        # fewer source tiles than chunk entries, max_near clamps below
        # one chunk and _compact_open_lists emits ZERO chunks per row —
        # the near field (including the forced-open self tile) would
        # silently fall into the far field as a self-multipole at d~0.
        # Fail loudly instead.
        raise ValueError(
            f"staged streaming needs per-shard K_src >= entries: "
            f"N/D={n_l} gives {k_s_l} source tiles of {src} < "
            f"{entries} chunk entries (CHUNK_LANES={CHUNK_LANES}); "
            f"use fewer devices, more bodies, or a larger src_tile")
    max_near = max(-(-cfg.tree_max_near // entries) * entries, entries)
    max_near = min(max_near, k_s_l - (k_s_l % entries) or k_s_l)
    cap = max(cfg.tree_flat_cap, k_t_l * entries)
    cap = -(-cap // entries) * entries
    vip_src = _clamp_vip(
        _vip_src_tiles(cfg.tree_vip_tiles, tile, src), k_s_g)
    use_hier = bool(cfg.tree_hier and cfg.tree_far_cap > 0
                    and cfg.tree_far_max > 0)
    hier = None
    if use_hier:
        if k_s_g < FAR_ENTRIES:
            raise ValueError(
                f"staged hierarchical treecode needs global K_src >= "
                f"{FAR_ENTRIES}; use the flat far field")
        plan = _level_plan(k_s_g, HIER_BRANCH)
        k_total = sum(plan)
        far_max = max(-(-cfg.tree_far_max // FAR_ENTRIES) * FAR_ENTRIES,
                      FAR_ENTRIES)
        far_max = min(far_max, (k_total // FAR_ENTRIES) * FAR_ENTRIES)
        far_cap = max(cfg.tree_far_cap, k_t_l * FAR_ENTRIES)
        far_cap = -(-far_cap // FAR_ENTRIES) * FAR_ENTRIES
        hier = (plan, far_max, far_cap)
    return tile, src, entries, k_t_l, k_s_l, k_s_g, max_near, cap, \
        vip_src, hier


def _staged_build(cfg: SimConfig, xl, yl, zl, ml, me, n_dev: int,
                  axis_name: str):
    """Per-chunk acceptance build from LOCAL columns (inside shard_map).

    Returns ``aux = (flat_src_all (D, cap), chunk_tgt_all (D, cap/E),
    near_mask (K_t_l, K_s_g), far_src | None, far_tgt | None,
    vip_idx | None, is_vip_body_l | None)`` — everything the per-step
    :func:`_staged_acc` needs, compacted per source shard so each ring
    stage has a ready work list. Only summaries (and W VIP bodies)
    cross the interconnect; positions never replicate.
    """
    (tile, src, entries, k_t_l, k_s_l, k_s_g, max_near, cap, vip_src,
     hier) = _staged_shapes(cfg, xl.shape[0], n_dev)
    f32 = jnp.float32
    xl, yl, zl, ml = (a.astype(f32) for a in (xl, yl, zl, ml))
    c2 = cfg.compensate * cfg.compensate
    gather = lambda a: lax.all_gather(a, axis_name, tiled=True)

    # ---- global deterministic VIP split from gathered raw radii (the
    # only VIP traffic at build time: one (K_s_g,) float gather).
    if vip_src:
        rad_raw_g = gather(_tile_radius(xl, yl, zl, ml, src))
        _, vip_idx = lax.top_k(rad_raw_g, vip_src)
        is_vip_tile_g = (jnp.zeros((k_s_g,), bool)
                         .at[vip_idx].set(True))
        is_vip_l = lax.dynamic_slice_in_dim(is_vip_tile_g, me * k_s_l,
                                            k_s_l)
        is_vip_body_l = jnp.repeat(is_vip_l, src)
        mass_tree_l = jnp.where(is_vip_body_l, 0.0, ml)
        vip_idx = vip_idx.astype(jnp.int32)
    else:
        vip_idx = is_vip_body_l = None
        mass_tree_l = ml

    # ---- replicated SUMMARIES only (44 B per src tile, vs 12N bytes of
    # positions on the replicated path). Tiles are wholly contained in
    # one shard, so the gathered summaries are exactly the single-chip
    # tile_summaries_cols output.
    com_l, mt_l, rad_l, quad_l = tile_summaries_cols(xl, yl, zl,
                                                     mass_tree_l, src)
    com_g, mt_g, rad_g, quad_g = (gather(a) for a in
                                  (com_l, mt_l, rad_l, quad_l))

    far_src = far_tgt = None
    if hier is not None:
        plan, far_max, far_cap = hier
        levels = _merge_levels(
            _level0_from_summaries(com_g, mt_g, rad_g, quad_g), plan,
            HIER_BRANCH)
        # Global a_med from gathered per-shard sample magnitudes: the
        # per-shard stride n_l/(2048/D) equals the global stride N/2048
        # and shard offsets are stride multiples, so the gathered vector
        # IS the single-chip sample — identical median on every chip.
        per = max(2048 // n_dev, 1)
        step = max(xl.shape[0] // per, 1)
        com0 = jnp.stack(levels[0][:3], axis=1)
        mags_l = _monopole_acc_mags(xl[::step], yl[::step], zl[::step],
                                    com0, levels[0][3],
                                    eps2=cfg.eps2, c2=c2)
        a_med = jnp.maximum(jnp.median(gather(mags_l)), _TINY)
        opens, minds, score0, thresh0 = _hier_open_masks(
            xl, yl, zl, levels, tile, src, mac_tau=cfg.tree_hier_tau,
            theta=cfg.tree_theta, eps2=cfg.eps2, c2=c2,
            row_offset=me * k_t_l, a_med=a_med,
            mac_tau0=cfg.tree_mac_tau, union_coarse=cfg.tree_hier_union)
        evals, reach0 = _chain_evals(opens, HIER_BRANCH)
        score0 = jnp.where(reach0, score0, -1.0)
    else:
        score0, thresh0 = _opening_scores(
            xl, yl, zl, com_g, rad_g, mt_g, tile, theta=cfg.tree_theta,
            mac_tau=cfg.tree_mac_tau, row_offset=me * k_t_l,
            src_tile=src, eps2=cfg.eps2, c2=c2)

    # ---- near lists compacted PER SOURCE SHARD (same scores, same
    # criterion; the per-shard slack/rounding extras may differ from the
    # global compaction — an exact-near-work difference inside the force
    # error envelope, pinned by tests/test_stream.py).
    lists = [
        _compact_open_lists(
            lax.dynamic_slice_in_dim(score0, d * k_s_l, k_s_l, axis=1),
            thresh0, cfg.tree_near_slack, cap, entries, max_near)
        for d in range(n_dev)
    ]
    flat_src_all = jnp.stack([l[0] for l in lists])      # (D, cap)
    chunk_tgt_all = jnp.stack([l[1] for l in lists])     # (D, cap/E)
    near_mask = jnp.concatenate([l[2] for l in lists], axis=1)

    if hier is not None:
        # Far lists over the replicated hierarchy, complementing the
        # near coverage that actually LANDED (graceful overflow).
        evals[0] = jnp.logical_and(reach0, jnp.logical_not(near_mask))
        key = jnp.concatenate(
            [jnp.where(ev, lv[3][None, :] / (md * md), -1.0)
             for ev, lv, md in zip(evals, levels, minds)], axis=1)
        far_src, far_tgt, _ = _compact_open_lists(
            key, 0.0, 0, far_cap, FAR_ENTRIES, far_max)

    return (flat_src_all, chunk_tgt_all, near_mask, far_src, far_tgt,
            vip_idx, is_vip_body_l)


def _staged_acc(cfg: SimConfig, xl, yl, zl, ml, me, aux, n_dev: int,
                axis_name: str, plan: ExecutionPlan):
    """One staged force evaluation of LOCAL rows (inside shard_map):
    ring-streamed near panels, replicated-summary far field (flat or
    hierarchical), psum-replicated VIP panel with psum'd reactions.
    Returns ``(axl, ayl, azl)`` — complete, VIP rows included."""
    (tile, src, entries, k_t_l, k_s_l, k_s_g, max_near, _, vip_src,
     hier) = _staged_shapes(cfg, xl.shape[0], n_dev)
    (flat_src_all, chunk_tgt_all, near_mask, far_src, far_tgt,
     vip_idx, is_vip_body_l) = aux
    f32 = jnp.float32
    xl, yl, zl, ml = (a.astype(f32) for a in (xl, yl, zl, ml))
    n_l = xl.shape[0]
    c2 = cfg.compensate * cfg.compensate
    gc3 = cfg.G * c2 * cfg.compensate
    gather = lambda a: lax.all_gather(a, axis_name, tiled=True)

    mass_tree_l = (jnp.where(is_vip_body_l, 0.0, ml)
                   if vip_src else ml)

    # ---- ring-staged near field. After s ppermute hops the device
    # holds shard (me - s) mod D, so stage s uses that shard's work list.
    payload0 = (xl, yl, zl, mass_tree_l * f32(gc3))      # 4 x (N/D,)
    stage_ids = (me - jnp.arange(n_dev, dtype=jnp.int32)) % n_dev
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def stage(carry, s):
        payload, accn = carry
        sid = stage_ids[s]
        fs = jnp.take(flat_src_all, sid, axis=0)
        ct = jnp.take(chunk_tgt_all, sid, axis=0)
        part = _near_field_flat_cols(
            xl, yl, zl, _source_cols(*payload, src), fs, ct,
            eps2=cfg.eps2, c2=c2, tile=tile, src_tile=src,
            max_chunks=max_near // entries, plan=plan)
        accn = tuple(a + p for a, p in zip(accn, part))
        payload = lax.ppermute(payload, axis_name, perm)
        return (payload, accn), None

    zero = jnp.zeros((n_l,), f32)
    (_, accn), _ = lax.scan(stage, (payload0, (zero, zero, zero)),
                            jnp.arange(n_dev, dtype=jnp.int32))

    # ---- far field from replicated summaries (per-step traffic: one
    # summaries gather — O(K_s_g), not O(N)).
    com_l, mt_l, rad_l, quad_l = tile_summaries_cols(xl, yl, zl,
                                                     mass_tree_l, src)
    com_g, mt_g, rad_g, quad_g = (gather(a) for a in
                                  (com_l, mt_l, rad_l, quad_l))
    if hier is not None:
        levels_plan, far_max, _ = hier
        levels = _merge_levels(
            _level0_from_summaries(com_g, mt_g, rad_g, quad_g),
            levels_plan, HIER_BRANCH)
        fax, fay, faz = _far_field_hier_cols(
            xl, yl, zl, _summary_panel(levels), far_src, far_tgt,
            eps2=cfg.eps2, c2=c2, G=cfg.G, tile=tile,
            max_chunks=far_max // FAR_ENTRIES, plan=plan)
    else:
        fax, fay, faz = _far_field_cols(
            xl, yl, zl, com_g, mt_g, quad_g, near_mask,
            eps2=cfg.eps2, c2=c2, G=cfg.G, tile=tile)
    ax = accn[0] + fax
    ay = accn[1] + fay
    az = accn[2] + faz
    if not vip_src:
        return ax, ay, az

    # ---- VIP: replicate the W-body panel by one masked psum (each VIP
    # tile has exactly one owner), fused action/reaction sweep, psum the
    # partial reactions, overwrite owned VIP rows with the complete
    # pull — the same contract as parallel/tree.py.
    scaled_all_l = ml * f32(gc3)
    rel_t = vip_idx - me * k_s_l
    own = (rel_t >= 0) & (rel_t < k_s_l)
    safe = jnp.where(own, rel_t, 0)
    pick = lambda col: jnp.where(own[:, None],
                                 col.reshape(k_s_l, src)[safe], 0.0)
    panel = lax.psum(
        jnp.stack([pick(xl), pick(yl), pick(zl), pick(scaled_all_l)]),
        axis_name)                                       # (4, V, S)
    action, react = _vip_sweep_cols(
        xl, yl, zl, scaled_all_l,
        panel[0].reshape(-1), panel[1].reshape(-1),
        panel[2].reshape(-1), panel[3].reshape(-1),
        eps2=cfg.eps2, c2=c2, plan=plan,
    )
    ax = ax + action[0]
    ay = ay + action[1]
    az = az + action[2]
    react = lax.psum(react, axis_name)                   # 3 x (W,) complete
    vip_body_g = (vip_idx[:, None] * src
                  + jnp.arange(src, dtype=jnp.int32)[None, :]).reshape(-1)
    rel = vip_body_g - me * n_l
    dest = jnp.where((rel >= 0) & (rel < n_l), rel, n_l)
    ax = ax.at[dest].set(react[0], mode="drop")
    ay = ay.at[dest].set(react[1], mode="drop")
    az = az.at[dest].set(react[2], mode="drop")
    return ax, ay, az


def make_staged_force(cfg: SimConfig, mesh: Mesh,
                      axis_name: str = RING_AXIS,
                      plan: ExecutionPlan | None = None) -> Callable:
    """``(pos (N,3) sharded, mass (N,) sharded) -> acc (N,3) sharded`` —
    one staged treecode force evaluation (fresh acceptance build every
    call; the run loop caches the build across ``tree_rebuild_every``
    steps instead). Flat or hierarchical far field per
    ``cfg.tree_hier``/``tree_far_cap``; VIP per ``cfg.tree_vip_tiles``.

    Requires explicit ``tree_tile``/``tree_src_tile``/``tree_max_near``
    and ``tree_flat_cap`` (the PER-STAGE per-chip near capacity; size it
    with ``suggest_flat_cap_sharded`` — conservative, since it bounds
    the per-chip TOTAL demand and any single stage serves a subset).
    """
    n_dev = mesh.devices.size
    plan = plan or execution_plan()

    def local(xl, yl, zl, ml):
        me = lax.axis_index(axis_name)
        aux = _staged_build(cfg, xl, yl, zl, ml, me, n_dev, axis_name)
        return _staged_acc(cfg, xl, yl, zl, ml, me, aux, n_dev,
                           axis_name, plan)

    row = P(axis_name)
    sharded = jax.shard_map(local, mesh=mesh, in_specs=(row,) * 4,
                            out_specs=(row,) * 3, check_vma=False)

    def force(pos: jax.Array, mass: jax.Array) -> jax.Array:
        ax, ay, az = sharded(pos[:, 0], pos[:, 1], pos[:, 2], mass)
        return jnp.stack([ax, ay, az], axis=1)

    return force


def make_staged_run(cfg: SimConfig, mesh: Mesh,
                    axis_name: str = RING_AXIS,
                    plan: ExecutionPlan | None = None) -> Callable:
    """``(sharded SimState, n_steps) -> (SimState, ids)`` — the staged
    counterpart of ``parallel.tree.make_sharded_treecode_run``: chunked
    global resort + per-chunk staged acceptance build + scanned steps
    with ring-streamed near panels, all inside one shard_map.

    The resort is the replicated path's multi-operand ``lax.sort`` of
    the gathered columns (identical permutation on every chip, no
    sort-specific communication) — the one remaining O(N) TRANSIENT of
    the staged strategy (52N bytes; see the module docstring). The
    steady-state footprint is O(N/D) columns + O(K_s_g) summaries.
    """
    tile = cfg.tree_tile or 32
    r = cfg.tree_rebuild_every
    dt = cfg.dt
    n_dev = mesh.devices.size
    plan = plan or execution_plan()

    def local_run(*args):
        *cols_l, n_real, n_steps = args
        cols_l = tuple(cols_l)
        me = lax.axis_index(axis_name)
        n_l = cols_l[0].shape[0]

        def gather(c):
            return lax.all_gather(c, axis_name, tiled=True)

        def chunk(cols_l, length):
            # ---- global columnar resort (transient O(N); identical to
            # the replicated flat run so staged == replicated == single
            # chip reduces to the force path).
            gl = tuple(gather(c) for c in cols_l)
            key = morton_keys_cols(gl[0], gl[1], gl[2], n_real)
            srt = lax.sort((key,) + gl, num_keys=1, is_stable=True)[1:]
            cols_l = tuple(
                lax.dynamic_slice(c, (me * n_l,), (n_l,)) for c in srt)
            x, y, z, vx, vy, vz, ax, ay, az, m, eps, ids = cols_l
            aux = _staged_build(cfg, x, y, z, m, me, n_dev, axis_name)

            def force(px, py, pz):
                return _staged_acc(cfg, px, py, pz, m, me, aux, n_dev,
                                   axis_name, plan)

            if cfg.integrator == "leapfrog":
                half = 0.5 * dt

                def body(c, _):
                    x, y, z, vx, vy, vz, ax, ay, az = c
                    vx = vx + ax * half
                    vy = vy + ay * half
                    vz = vz + az * half
                    x = x + vx * dt
                    y = y + vy * dt
                    z = z + vz * dt
                    ax, ay, az = force(x, y, z)
                    return (x, y, z, vx + ax * half, vy + ay * half,
                            vz + az * half, ax, ay, az), None
            else:
                def body(c, _):
                    x, y, z, vx, vy, vz, ax, ay, az = c
                    ax, ay, az = force(x, y, z)
                    vx = vx + ax * dt
                    vy = vy + ay * dt
                    vz = vz + az * dt
                    return (x + vx * dt, y + vy * dt, z + vz * dt,
                            vx, vy, vz, ax, ay, az), None

            carry, _ = lax.scan(body, (x, y, z, vx, vy, vz, ax, ay, az),
                                length=length)
            return carry + (m, eps, ids)

        full, rem = divmod(n_steps, r)
        if full:
            cols_l, _ = lax.scan(lambda c, _: (chunk(c, r), None),
                                 cols_l, length=full)
        if rem:
            cols_l = chunk(cols_l, rem)
        return cols_l

    row = P(axis_name)
    sharded = jax.shard_map(
        local_run, mesh=mesh,
        in_specs=(row,) * 12 + (P(), None),
        out_specs=(row,) * 12,
        check_vma=False,
    )

    def run(state: SimState, n_steps: int):
        ids = jnp.arange(state.n, dtype=jnp.int32)
        out = sharded(
            state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
            state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
            state.acc[:, 0], state.acc[:, 1], state.acc[:, 2],
            state.mass, state.eps, ids,
            jnp.asarray(state.n_real, jnp.int32), n_steps,
        )
        x, y, z, vx, vy, vz, ax, ay, az, m, eps, ids = out
        new = SimState(
            pos=jnp.stack([x, y, z], axis=1),
            vel=jnp.stack([vx, vy, vz], axis=1),
            acc=jnp.stack([ax, ay, az], axis=1),
            mass=m, eps=eps,
            time=state.time + jnp.asarray(n_steps * dt, state.time.dtype),
            step=state.step + n_steps, n_real=state.n_real,
        )
        return new, ids

    return run
