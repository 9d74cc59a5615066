"""Multi-chip Barnes-Hut: replicated sources, sharded target rows.

The ring decomposition (``parallel/ring.py``) distributes the EXACT
solvers; this module distributes the treecode. The decomposition is the
simple, strong one for N up to a few million bodies:

- Bodies stay globally Morton-sorted; each chip owns a CONTIGUOUS
  segment (= a contiguous range of acceptance tiles, spatially coherent
  by construction).
- Per force evaluation, every chip ``all_gather``s positions (the only
  per-step traffic: 12N bytes over the interconnect — O(N), against
  O(N * mean-near)
  local compute), rebuilds the global tile summaries redundantly (O(N)
  flops, trivial), and runs the single-chip machinery restricted to its
  own target rows: the acceptance matrices are (K/D, K), the near panels
  gather from the replicated source tiles, the far field sweeps its rows
  against the global summaries.
- The VIP split stays GLOBAL and deterministic (every chip selects the
  same largest-radius tiles from the same gathered arrays). The fused
  Newton's-3rd-law sweep runs local rows x global VIP panel; the partial
  reactions ``psum`` to the VIPs' complete accelerations, and each chip
  overwrites the VIP rows it owns.
- Every ``tree_rebuild_every`` steps the chunk re-sorts GLOBALLY: each
  chip computes the identical argsort of the gathered Morton keys and
  takes its own slice of the permuted state — a distributed sort with no
  sort-specific communication (the gather was already needed).

Everything runs inside one ``shard_map``-ped scan: per-step traffic is
one tiled all_gather + one (W, 3) psum. Validated against the
single-chip treecode on virtual CPU meshes (the global sort and per-tile
acceptance are identical by construction, so results match to kernel
rounding).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from n_body_problem_tpu.config import SimConfig
from n_body_problem_tpu.ops.treecode import (
    _acceptance,
    _far_field,
    _gather_panels,
    _near_field_xla,
    _tile_radius,
    _dense_sweep,
    _clamp_vip,
    build_flat_local,
    build_hier_local,
    flat_local_acc,
    hier_local_acc,
    tile_summaries,
)
from n_body_problem_tpu.parallel.mesh import RING_AXIS
from n_body_problem_tpu.plan import ExecutionPlan, execution_plan
from n_body_problem_tpu.state import SimState
from n_body_problem_tpu.utils.morton import morton_keys_cols, morton_keys_device


def _local_treecode_acc(pos_l, mass_l, pos_g, mass_g, aux, *,
                        eps2, compensate, G, tile, vip_tiles):
    """acc (N_local, 3) of local rows from ALL bodies (inside shard_map,
    replicated sources; the dense per-target path, plain XLA).
    ``aux`` = (near_idx_l, near_mask_l, is_vip_g)."""
    near_idx_l, near_mask_l, is_vip_g = aux
    n_g = pos_g.shape[0]
    k = n_g // tile
    c2 = compensate * compensate
    gc3 = G * c2 * compensate
    f32 = jnp.float32

    mass_tree_g = jnp.where(is_vip_g, 0.0, mass_g) if vip_tiles else mass_g
    com, m_tot, _, quad = tile_summaries(pos_g, mass_tree_g, tile)

    scaled_tree = mass_tree_g * f32(gc3)
    panels = _gather_panels(pos_g, scaled_tree, near_idx_l, tile)
    acc = _near_field_xla(pos_l, panels, eps2=eps2, c2=c2, tile=tile)
    acc = acc + _far_field(pos_l, com, m_tot, quad, near_mask_l,
                           eps2=eps2, c2=c2, G=G, tile=tile)

    if vip_tiles:
        vip_tile_idx = jnp.nonzero(
            is_vip_g.reshape(k, tile)[:, 0], size=vip_tiles, fill_value=0
        )[0]
        vip_body_g = (vip_tile_idx[:, None] * tile
                      + jnp.arange(tile, dtype=jnp.int32)[None, :]).reshape(-1)
        scaled_all_g = mass_g * f32(gc3)
        action = _dense_sweep(pos_l, pos_g[vip_body_g],
                              scaled_all_g[vip_body_g], eps2=eps2, c2=c2)
        react = _dense_sweep(pos_g[vip_body_g], pos_l, mass_l * f32(gc3),
                             eps2=eps2, c2=c2)
        acc = acc + action
        react = lax.psum(react, RING_AXIS)                  # (W, 3) complete
        n_local = pos_l.shape[0]
        me = lax.axis_index(RING_AXIS)
        rel = vip_body_g - me * n_local
        dest = jnp.where((rel >= 0) & (rel < n_local), rel, n_local)
        acc = acc.at[dest].set(react, mode="drop")
    return acc


def _make_sharded_flat_run(cfg: SimConfig, mesh: Mesh, axis_name: str,
                           plan: ExecutionPlan) -> Callable:
    """Sharded counterpart of the single-chip COLUMNAR flat run
    (``simulation.make_treecode_run`` with ``tree_flat_cap > 0``): each
    chip carries twelve local (N/D,) columns, the global resort is one
    redundant multi-operand ``lax.sort`` of the gathered columns (every
    chip computes the identical result and slices its own row block — a
    distributed sort with no sort-specific communication), and the force
    is ``flat_local_acc`` (mean-bound compacted near lists for the LOCAL
    rows, replicated sources, psum'd VIP reactions)."""
    tile = cfg.tree_tile
    src = cfg.tree_src_tile
    r = cfg.tree_rebuild_every
    dt = cfg.dt
    sel = dict(tile=tile, src_tile=src, theta=cfg.tree_theta,
               max_near=cfg.tree_max_near, vip_tiles=cfg.tree_vip_tiles)
    akw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G,
               tile=tile, src_tile=src, max_near=cfg.tree_max_near,
               vip_tiles=cfg.tree_vip_tiles, plan=plan)
    flat_cap = cfg.tree_flat_cap
    # Hierarchical far field per chip (round 3): same decomposition, the
    # near/far lists compacted locally from the globally-redundant level
    # summaries. Requires the per-chip far capacities to be planned
    # (suggest_hier_sharded via ShardedSimulation).
    use_hier = (cfg.tree_hier and cfg.tree_far_cap > 0
                and cfg.tree_far_max > 0)

    def local_run(*args):
        *cols_l, n_real, n_steps = args
        cols_l = tuple(cols_l)
        me = lax.axis_index(axis_name)
        n_l = cols_l[0].shape[0]
        k_t_l = n_l // tile

        def gather(c):
            return lax.all_gather(c, axis_name, tiled=True)

        def chunk(cols_l, length):
            # ---- global columnar resort: all chips sort the identical
            # gathered columns (the permutation rides the sort network),
            # then slice their own contiguous row block.
            gl = tuple(gather(c) for c in cols_l)
            key = morton_keys_cols(gl[0], gl[1], gl[2], n_real)
            srt = lax.sort((key,) + gl, num_keys=1, is_stable=True)[1:]
            cols_l = tuple(
                lax.dynamic_slice(c, (me * n_l,), (n_l,)) for c in srt)
            x, y, z, vx, vy, vz, ax, ay, az, m, eps, ids = cols_l
            xg, yg, zg, mg = srt[0], srt[1], srt[2], srt[9]
            if use_hier:
                aux = build_hier_local(
                    x, y, z, xg, yg, zg, mg, slack=cfg.tree_near_slack,
                    flat_cap=flat_cap, far_max=cfg.tree_far_max,
                    far_cap=cfg.tree_far_cap, row_offset=me * k_t_l,
                    mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau,
                    union_coarse=cfg.tree_hier_union, eps2=cfg.eps2,
                    compensate=cfg.compensate, **sel)
            else:
                aux = build_flat_local(
                    x, y, z, xg, yg, zg, mg, slack=cfg.tree_near_slack,
                    flat_cap=flat_cap, row_offset=me * k_t_l,
                    mac_tau=cfg.tree_mac_tau, eps2=cfg.eps2,
                    compensate=cfg.compensate, **sel)

            def force(px, py, pz):
                pxg, pyg, pzg = gather(px), gather(py), gather(pz)
                if use_hier:
                    axl, ayl, azl, react, vip_idx = hier_local_acc(
                        px, py, pz, m, pxg, pyg, pzg, mg, aux,
                        far_max=cfg.tree_far_max, **akw)
                else:
                    axl, ayl, azl, react, vip_idx = flat_local_acc(
                        px, py, pz, m, pxg, pyg, pzg, mg, aux, **akw)
                if react is not None:
                    react = lax.psum(react, axis_name)   # 3 x (W,) complete
                    rel = vip_idx - me * n_l
                    dest = jnp.where((rel >= 0) & (rel < n_l), rel, n_l)
                    axl = axl.at[dest].set(react[0], mode="drop")
                    ayl = ayl.at[dest].set(react[1], mode="drop")
                    azl = azl.at[dest].set(react[2], mode="drop")
                return axl, ayl, azl

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


def make_sharded_treecode_run(
    cfg: SimConfig,
    mesh: Mesh,
    axis_name: str = RING_AXIS,
    plan: ExecutionPlan | None = None,
) -> Callable:
    """``(sharded SimState, n_steps) -> (SimState, ids)`` — the multi-device
    counterpart of ``simulation.make_treecode_run`` (chunked global resort
    + cached local acceptance + scanned steps, all inside shard_map).
    With ``cfg.tree_flat_cap > 0`` the columnar mean-bound flat machinery
    runs per device (the production path, see ``_make_sharded_flat_run``);
    otherwise the dense max-bound path below."""
    if cfg.tree_flat_cap > 0:
        return _make_sharded_flat_run(cfg, mesh, axis_name,
                                      plan or execution_plan())
    tile = cfg.tree_tile
    r = cfg.tree_rebuild_every
    dt = cfg.dt
    kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G, tile=tile)
    n_dev = mesh.devices.size

    def local_run(pos_l, vel_l, mass_l, eps_l, acc_l, ids_l, n_real, n_steps):
        me = lax.axis_index(axis_name)
        n_local = pos_l.shape[0]
        k_global = n_local * n_dev // tile
        vip_tiles = _clamp_vip(cfg.tree_vip_tiles, k_global)
        max_near = min(max(cfg.tree_max_near, 4), k_global)

        def gather(x):
            return lax.all_gather(x, axis_name, tiled=True)

        def chunk(carry, length):
            pos_l, vel_l, mass_l, eps_l, acc_l, ids_l = carry
            # ---- global resort: identical argsort on every chip, then
            # each takes its own slice (no sort-specific communication).
            pos_g = gather(pos_l)
            key = morton_keys_device(pos_g, n_real)
            perm = jnp.argsort(key, stable=True)
            perm_l = lax.dynamic_slice(perm, (me * n_local,), (n_local,))
            pos_l = pos_g[perm_l]
            vel_l = gather(vel_l)[perm_l]
            mass_l = gather(mass_l)[perm_l]
            eps_l = gather(eps_l)[perm_l]
            acc_l = gather(acc_l)[perm_l]
            ids_l = gather(ids_l)[perm_l]
            pos_g = pos_g[perm]
            mass_g = gather(mass_l)

            # ---- acceptance for the LOCAL target tiles (+ global VIP)
            if vip_tiles:
                radius_raw = _tile_radius(pos_g[:, 0], pos_g[:, 1], pos_g[:, 2], mass_g, tile)
                _, vip_idx = lax.top_k(radius_raw, vip_tiles)
                is_vip_tile = jnp.zeros((k_global,), bool).at[vip_idx].set(True)
                is_vip_g = jnp.repeat(is_vip_tile, tile)
                mass_tree_g = jnp.where(is_vip_g, 0.0, mass_g)
            else:
                is_vip_g = jnp.zeros((pos_g.shape[0],), bool)
                mass_tree_g = mass_g
            com, m_tot_g, radius, _ = tile_summaries(pos_g, mass_tree_g, tile)
            near_idx_l, near_mask_l = _acceptance(
                pos_l, com, radius, tile, cfg.tree_theta, max_near,
                row_offset=me * (n_local // tile), m_tot=m_tot_g,
                mac_tau=cfg.tree_mac_tau, eps2=cfg.eps2,
                c2=cfg.compensate * cfg.compensate,
            )
            aux = (near_idx_l, near_mask_l, is_vip_g)

            # ---- inner steps with cached acceptance
            def force(p_l):
                return _local_treecode_acc(
                    p_l, mass_l, gather(p_l), mass_g, aux,
                    vip_tiles=vip_tiles, **kw,
                )

            def euler(c, _):
                p, v, a = c
                a = force(p)
                v = v + a * dt
                return (p + v * dt, v, a), None

            def leapfrog(c, _):
                p, v, a = c
                v_half = v + a * (0.5 * dt)
                p = p + v_half * dt
                a = force(p)
                return (p, v_half + a * (0.5 * dt), a), None

            body = leapfrog if cfg.integrator == "leapfrog" else euler
            (pos_l, vel_l, acc_l), _ = lax.scan(
                body, (pos_l, vel_l, acc_l), length=length
            )
            return (pos_l, vel_l, mass_l, eps_l, acc_l, ids_l), None

        carry = (pos_l, vel_l, mass_l, eps_l, acc_l, ids_l)
        full, rem = divmod(n_steps, r)
        if full:
            carry, _ = lax.scan(lambda c, _: chunk(c, r), carry, length=full)
        if rem:
            carry, _ = chunk(carry, rem)
        return carry

    row = P(axis_name)
    sharded = jax.shard_map(
        local_run,
        mesh=mesh,
        in_specs=(row, row, row, row, row, row, P(), None),
        out_specs=(row, row, row, row, row, row),
        check_vma=False,
    )

    def run(state: SimState, n_steps: int):
        ids = jnp.arange(state.n, dtype=jnp.int32)
        pos, vel, mass, eps, acc, ids = sharded(
            state.pos, state.vel, state.mass, state.eps, state.acc, ids,
            jnp.asarray(state.n_real, jnp.int32), n_steps,
        )
        out = SimState(
            pos=pos, vel=vel, mass=mass, eps=eps, acc=acc,
            time=state.time + jnp.asarray(n_steps * dt, state.time.dtype),
            step=state.step + n_steps, n_real=state.n_real,
        )
        return out, ids

    return run


def make_sharded_treecode_force(cfg: SimConfig, mesh: Mesh,
                                axis_name: str = RING_AXIS) -> Callable:
    """One distributed treecode force evaluation (for leapfrog priming and
    diagnostics): ``(pos, mass) sharded -> acc sharded``. Builds the
    acceptance fresh (no caching)."""
    tile = cfg.tree_tile
    kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G, tile=tile)
    n_dev = mesh.devices.size

    def local(pos_l, mass_l, n_real):
        k_global = pos_l.shape[0] * n_dev // tile
        vip_tiles = _clamp_vip(cfg.tree_vip_tiles, k_global)
        max_near = min(max(cfg.tree_max_near, 4), k_global)
        pos_g = lax.all_gather(pos_l, axis_name, tiled=True)
        mass_g = lax.all_gather(mass_l, axis_name, tiled=True)
        if vip_tiles:
            radius_raw = _tile_radius(pos_g[:, 0], pos_g[:, 1], pos_g[:, 2], mass_g, tile)
            _, vip_idx = lax.top_k(radius_raw, vip_tiles)
            is_vip_g = jnp.repeat(
                jnp.zeros((k_global,), bool).at[vip_idx].set(True), tile)
            mass_tree_g = jnp.where(is_vip_g, 0.0, mass_g)
        else:
            is_vip_g = jnp.zeros((pos_g.shape[0],), bool)
            mass_tree_g = mass_g
        com, m_tot_g, radius, _ = tile_summaries(pos_g, mass_tree_g, tile)
        me = lax.axis_index(axis_name)
        aux = (*_acceptance(pos_l, com, radius, tile, cfg.tree_theta,
                            max_near,
                            row_offset=me * (pos_l.shape[0] // tile),
                            m_tot=m_tot_g, mac_tau=cfg.tree_mac_tau,
                            eps2=cfg.eps2,
                            c2=cfg.compensate * cfg.compensate),
               is_vip_g)
        return _local_treecode_acc(pos_l, mass_l, pos_g, mass_g, aux,
                                   vip_tiles=vip_tiles, **kw)

    row = P(axis_name)
    return jax.shard_map(local, mesh=mesh, in_specs=(row, row, P()),
                         out_specs=row, check_vma=False)
