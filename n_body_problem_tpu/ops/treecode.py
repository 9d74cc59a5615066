"""Barnes-Hut treecode on the Morton tiling — the beyond-brute-force solver.

The reference is exact brute force (1.6 ms/step at N=20,225 on an RTX
4090, ``kernel.cu:73`` — the reference's published number, kept as a
point of comparison). This solver crosses that line algorithmically
while keeping every shape static. Bodies must be Morton-sorted
(``SimConfig.morton_sort`` / ``resort_every``); consecutive ``tile``-body
blocks are then spatially compact clusters.

Per force evaluation:

1. **VIP split** (handles the halo problem). Equal-count Morton tiles in
   the sparse outskirts of a centrally-concentrated system span enormous
   radii; as multipole sources they fail the opening test for *every*
   target, and as targets their own bounding radius drags the whole core
   into their near set. The ``vip_tiles`` largest-radius tiles are
   therefore pulled out of the tree entirely and evaluated **exactly, both
   directions** (dense body-vs-panel sweeps): their mass is zeroed in the
   tree summaries, every body adds the exact pair force from the VIP
   panel, and VIP bodies' own rows are overwritten with an exact sweep
   against everyone. Static capacity, selected by ``top_k`` on tile radius
   each call — fully adaptive, zero error contribution.

2. **Tile summaries** for the remaining mass: centre of mass, total mass,
   bounding radius over massive bodies, quadrupole tensor.

3. **Opening criterion, per-body union.** Source tile j must be computed
   exactly for target tile i iff ANY body y of i violates the Barnes-Hut
   test:   min_{y in i} |y - com_j|  <  radius_j / theta.
   (The conservative tile-level margin ``d(com_i,com_j) - radius_i`` would
   over-open for every target with a non-tiny radius — measured 4x worse.)
   Each target keeps the ``max_near`` worst tiles (largest
   ``radius_j / min_dist`` ratio, self forced first) as its near list — a
   static shape. If ``max_near`` bounds the true open count (auto-tuned by
   :func:`suggest_max_near`, observable via :func:`open_counts`) the
   theta-criterion is honoured exactly; spare slots just compute more
   tiles exactly; overflow degrades gracefully (worst offenders stay
   near). ``max_near >= K`` degenerates to the exact solver.

4. **Near field (exact):** the reference pair math against the listed
   source tiles — on the GPU a Pallas (Triton) kernel that walks each
   target row's slice of the compacted list (:func:`_near_flat_kernel`),
   elsewhere the plain XLA form beside it.

5. **Far field (monopole + quadrupole):** body-vs-tile expansion of the
   *softened* kernel, coefficients derived for
   ``phi = -G m c (c^2 r^2 + eps2)^(-1/2)`` — the same physics the near
   field computes, not an unsoftened approximation. An isotropic
   quadrupole contributes exactly zero (validated in tests). The
   hierarchical far lists run through a second Triton kernel on the GPU
   (:func:`_far_hier_kernel`).

Force error of the production path (Plummer, MAC tau=2e-4): ~1e-3 p99
and ~2e-4 median relative force error (envelopes asserted in
tests/test_treecode.py and tests/test_treecode_hier.py). Which form of
each stage runs is decided by ``n_body_problem_tpu.plan``.

The reference has no tree — cited here as the perf target
(``kernel.cu:73``), not as provenance.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from n_body_problem_tpu.plan import ExecutionPlan, execution_plan

DEFAULT_TILE = 32
DEFAULT_THETA = 0.55
DEFAULT_MAC_TAU = 2e-4    # mass-aware MAC tolerance (see _opening_scores);
                          # 0 selects the geometric theta criterion
MAC_REF_KSRC = 4096       # tau calibration point: the effective threshold
                          # is tau * sqrt(MAC_REF_KSRC / K_s), so the
                          # aggregated (CLT, ~sqrt(K)) far-field error
                          # envelope is N-independent — measured p99
                          # 7.7e-4 at N=262k (K_s=4096) and 8.2e-4 at
                          # N=65k (K_s=1024, effective tau 2x) with the
                          # same tau=2e-4
DEFAULT_MAX_NEAR = 416     # fallback when suggest_max_near wasn't consulted
DEFAULT_VIP_TILES = 128

_TINY = 1e-12


# --------------------------------------------------------------- summaries
def _cols(pos):
    """(N, 3) -> three (N,) coordinate columns (the only layout the hot
    path touches)."""
    return pos[:, 0], pos[:, 1], pos[:, 2]


def tile_summaries(pos: jax.Array, mass: jax.Array, tile: int):
    """Per-tile (com (K,3), m_tot (K,), radius (K,), quad (K,6)) — see
    :func:`tile_summaries_cols`."""
    return tile_summaries_cols(*_cols(pos), mass, tile)


def tile_summaries_cols(xc, yc, zc, mass: jax.Array, tile: int):
    """Per-tile (com (K,3), m_tot (K,), radius (K,), quad (K,6)).

    ``radius`` spans bodies with mass > 0 only: massless padding bodies sit
    at the origin and would otherwise inflate a boundary tile's radius to
    the whole-system scale. ``quad`` is the raw second-moment tensor
    sum_a m_a outer(delta_a, delta_a), packed [xx, yy, zz, xy, xz, yz].
    Empty (all-massless) tiles get m_tot = radius = quad = 0 and are inert
    as sources.
    """
    n = xc.shape[0]
    k = n // tile
    x = xc.reshape(k, tile)
    y = yc.reshape(k, tile)
    z = zc.reshape(k, tile)
    m = mass.reshape(k, tile)
    m_tot = jnp.sum(m, axis=1)                                  # (K,)
    inv_m = 1.0 / jnp.maximum(m_tot, _TINY)
    has_mass = m_tot > 0
    cx = jnp.where(has_mass, jnp.sum(m * x, axis=1) * inv_m, jnp.mean(x, axis=1))
    cy = jnp.where(has_mass, jnp.sum(m * y, axis=1) * inv_m, jnp.mean(y, axis=1))
    cz = jnp.where(has_mass, jnp.sum(m * z, axis=1) * inv_m, jnp.mean(z, axis=1))
    dx = x - cx[:, None]                                        # (K, T)
    dy = y - cy[:, None]
    dz = z - cz[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    radius = jnp.sqrt(jnp.max(jnp.where(m > 0, r2, 0.0), axis=1))
    com = jnp.stack([cx, cy, cz], axis=1)                       # (K, 3)
    quad = jnp.stack(
        [
            jnp.sum(m * dx * dx, axis=1),
            jnp.sum(m * dy * dy, axis=1),
            jnp.sum(m * dz * dz, axis=1),
            jnp.sum(m * dx * dy, axis=1),
            jnp.sum(m * dx * dz, axis=1),
            jnp.sum(m * dy * dz, axis=1),
        ],
        axis=1,
    )                                                           # (K, 6)
    return com, m_tot, radius, quad


def _chunk_size(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (min(n, 8192)
    crashed reshape for n not a multiple of 8192)."""
    for c in range(min(n, target), 0, -1):
        if n % c == 0:
            return c
    return n


def _min_tile_dist(xc, yc, zc, com: jax.Array, tile: int) -> jax.Array:
    """(K_t, K_s): min over bodies of target tile i of |y - com_j|."""
    n = xc.shape[0]
    k_s = com.shape[0]
    # chunk must divide n AND be a tile multiple (for the in-chunk min).
    chunk = tile * _chunk_size(n // tile, max(8192 // tile, 1))
    cx, cy, cz = com[:, 0], com[:, 1], com[:, 2]

    def per_chunk(args):
        x_c, y_c, z_c = args                                    # (C,) each
        dx = cx[None, :] - x_c[:, None]                         # (C, K_s)
        dy = cy[None, :] - y_c[:, None]
        dz = cz[None, :] - z_c[:, None]
        d2 = dx * dx + dy * dy + dz * dz
        # min within each target tile, inside the chunk (chunk % tile == 0)
        return jnp.min(d2.reshape(-1, tile, k_s), axis=1)

    shape = (n // chunk, chunk)
    d2_min = lax.map(per_chunk, (xc.reshape(shape),
                                 yc.reshape(shape),
                                 zc.reshape(shape)))
    return jnp.sqrt(d2_min.reshape(n // tile, k_s))


def _tile_radius(xc, yc, zc, mass, tile: int):
    """Radius-only summary (the VIP selector needs nothing else)."""
    n = xc.shape[0]
    k = n // tile
    x = xc.reshape(k, tile)
    y = yc.reshape(k, tile)
    z = zc.reshape(k, tile)
    m = mass.reshape(k, tile)
    inv_m = 1.0 / jnp.maximum(jnp.sum(m, axis=1), _TINY)
    cx = jnp.sum(m * x, axis=1) * inv_m
    cy = jnp.sum(m * y, axis=1) * inv_m
    cz = jnp.sum(m * z, axis=1) * inv_m
    dx = x - cx[:, None]
    dy = y - cy[:, None]
    dz = z - cz[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    return jnp.sqrt(jnp.max(jnp.where(m > 0, r2, 0.0), axis=1))


def _vip_split(xc, yc, zc, mass, tile: int, vip_tiles: int):
    """(mass_tree, vip_body_idx (W,), is_vip_body (N,)) — pull the
    ``vip_tiles`` largest-radius tiles out of the tree."""
    n = xc.shape[0]
    k = n // tile
    radius = _tile_radius(xc, yc, zc, mass, tile)
    _, vip_idx = lax.top_k(radius, vip_tiles)                   # (V,)
    body_idx = (vip_idx[:, None] * tile
                + jnp.arange(tile, dtype=vip_idx.dtype)[None, :]).reshape(-1)
    is_vip_tile = jnp.zeros((k,), bool).at[vip_idx].set(True)
    is_vip_body = jnp.repeat(is_vip_tile, tile)
    mass_tree = jnp.where(is_vip_body, 0.0, mass)
    return mass_tree, body_idx, is_vip_body


# -------------------------------------------------------------- acceptance
def _monopole_acc_mags(xs, ys, zs, com, m_tot, *, eps2, c2):
    """(S,) per-G acceleration magnitudes of the given sample bodies,
    estimated from monopole tile summaries (the raw ingredient of the MAC
    normalization scale; the staged multi-chip path gathers per-shard
    magnitudes and medians the SAME global vector on every chip)."""
    c3 = c2 * math.sqrt(c2)
    dx = com[:, 0][None, :] - xs[:, None]               # (S, K)
    dy = com[:, 1][None, :] - ys[:, None]
    dz = com[:, 2][None, :] - zs[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    u2 = 1.0 / (c2 * r2 + eps2)
    w = m_tot[None, :] * u2 * jnp.sqrt(u2) * c3
    ax = jnp.sum(w * dx, axis=1)
    ay = jnp.sum(w * dy, axis=1)
    az = jnp.sum(w * dz, axis=1)
    return jnp.sqrt(ax * ax + ay * ay + az * az)


def _median_monopole_acc(xc, yc, zc, com, m_tot, *, eps2, c2):
    """Median per-G acceleration magnitude of a body sample, estimated
    from monopole tile summaries: the MAC normalization scale.

    Cheap (sample x K_s matrix), deterministic, self-contained — the same
    estimate on every chip of a mesh (global summaries), at init, and at
    every rebuild, so the acceptance criterion never depends on carried
    state. Accuracy ~theta-level, which is plenty for a SCALE.
    """
    n = xc.shape[0]
    step = max(n // 2048, 1)
    return jnp.median(_monopole_acc_mags(
        xc[::step], yc[::step], zc[::step], com, m_tot, eps2=eps2, c2=c2))


def _opening_scores(xc, yc, zc, com, radius, m_tot, tile: int, *,
                    theta: float, mac_tau: float, row_offset=0,
                    src_tile: int | None = None, eps2: float = 1e-6,
                    c2: float = 0.01):
    """(scores (K_t, K_s), threshold) for the opening decision, self=inf.

    ``mac_tau == 0``: the geometric Barnes-Hut test — score
    radius_j / min-body-distance against ``theta``. ``mac_tau > 0``: the
    mass-aware absolute-error MAC (Dehnen 2002's style): score
    (m_j r_j^3 / d^5) / a_med against ``mac_tau`` (scaled by
    sqrt(MAC_REF_KSRC / K_s) so the aggregated error envelope is
    N-independent), where a_med is the median body acceleration estimated
    from monopole summaries — i.e. open a tile iff its quadrupole-
    truncation error would exceed the (scaled) tolerance times the median
    acceleration. Measured on a Plummer sphere at matched open counts the
    MAC is ~2x more accurate at p99 than the geometric test in the useful
    range (heavy near-threshold tiles open, light far ones don't); it
    also never opens massless padding tiles.
    """
    src_tile = src_tile or tile
    k_t = xc.shape[0] // tile
    k_s = com.shape[0]
    min_d = jnp.maximum(_min_tile_dist(xc, yc, zc, com, tile), _TINY)
    if mac_tau > 0:
        a_med = jnp.maximum(
            _median_monopole_acc(xc, yc, zc, com, m_tot, eps2=eps2, c2=c2),
            _TINY)
        d5 = jnp.square(jnp.square(min_d)) * min_d
        score = (m_tot * radius * radius * radius)[None, :] / d5 / a_med
        thresh = mac_tau * math.sqrt(MAC_REF_KSRC / k_s)
    else:
        score = radius[None, :] / min_d
        thresh = theta
    return jnp.where(_self_overlap(k_t, k_s, tile, src_tile, row_offset),
                     jnp.inf, score), thresh


def _self_overlap(k_t: int, k_s: int, tile: int, src_tile: int, row_offset):
    """(K_t, K_s) bool: target row i and source col j overlap in bodies.

    Valid for either granularity direction (target rows coarser OR finer
    than source tiles): row i spans [i*tile, (i+1)*tile), col j spans
    [j*src, (j+1)*src); with one a multiple of the other, overlap reduces
    to equality of the coarser-granularity indices.
    """
    rows = jax.lax.broadcasted_iota(jnp.int32, (k_t, k_s), 0) + row_offset
    cols = jax.lax.broadcasted_iota(jnp.int32, (k_t, k_s), 1)
    return (rows // max(src_tile // tile, 1)) == (cols // max(tile // src_tile, 1))


def _opening_ratio(xc, yc, zc, com, radius, tile: int, row_offset=0,
                   src_tile: int | None = None):
    """(K_t, K_s) opening ratios radius_j / min-body-distance, self = inf.

    ``row_offset`` maps local target-tile rows to global source columns
    (the multi-chip path computes rows for its own contiguous tile range).
    ``src_tile`` sets the SOURCE granularity (asymmetric acceptance: target
    rows stay at ``tile`` bodies, sources span ``src_tile`` bodies); the
    "self" source (forced near) is the one containing the target tile.
    """
    src_tile = src_tile or tile
    k_t = xc.shape[0] // tile
    k_s = com.shape[0]
    min_d = _min_tile_dist(xc, yc, zc, com, tile)               # (K_t, K_s)
    ratio = radius[None, :] / jnp.maximum(min_d, _TINY)
    return jnp.where(_self_overlap(k_t, k_s, tile, src_tile, row_offset),
                     jnp.inf, ratio)


def _acceptance(pos, com, radius, tile: int, theta: float, max_near: int,
                row_offset=0, m_tot=None, mac_tau: float = 0.0,
                eps2: float = 1e-6, c2: float = 0.01):
    """Near lists from the per-body-union opening criterion (geometric
    theta test, or the mass-aware MAC when ``mac_tau > 0`` — see
    :func:`_opening_scores`).

    Returns (near_idx (K_t, M) int32, near_mask (K_t, K_s) bool).
    """
    k_s = com.shape[0]
    xc, yc, zc = _cols(pos)
    if mac_tau > 0:
        ratio, theta = _opening_scores(
            xc, yc, zc, com, radius, m_tot, tile, theta=theta,
            mac_tau=mac_tau, row_offset=row_offset, eps2=eps2, c2=c2)
    else:
        ratio = _opening_ratio(xc, yc, zc, com, radius, tile, row_offset)
    _, near_idx = lax.top_k(ratio, max_near)                    # (K_t, M)
    near_mask = jnp.any(
        near_idx[:, :, None] == jnp.arange(k_s)[None, None, :], axis=1
    )                                                           # (K_t, K_s)
    return near_idx.astype(jnp.int32), near_mask


@functools.partial(jax.jit, static_argnames=("tile", "theta", "vip_tiles",
                                              "src_tile", "mac_tau", "eps2",
                                              "compensate"))
def open_counts(pos, mass, *, tile: int = DEFAULT_TILE,
                theta: float = DEFAULT_THETA,
                vip_tiles: int = DEFAULT_VIP_TILES,
                src_tile: int | None = None,
                mac_tau: float = 0.0,
                eps2: float = 1e-6,
                compensate: float = 0.1) -> jax.Array:
    """Per-target-tile count of SOURCE tiles failing the far test (self
    included), after the VIP split. ``max_near`` must cover
    ``max(open_counts)`` for the theta-criterion to hold exactly;
    :func:`suggest_max_near` adds margin. ``src_tile`` sets the source
    granularity (defaults to ``tile``; the flat path uses a coarser one).
    """
    n = pos.shape[0]
    src_tile = src_tile or tile
    k_s = n // src_tile
    xc, yc, zc = _cols(pos)
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    mass_tree = mass
    if vip_src:
        mass_tree, _, _ = _vip_split(xc, yc, zc, mass, src_tile, vip_src)
    com, m_tot, radius, _ = tile_summaries_cols(xc, yc, zc, mass_tree,
                                                src_tile)
    score, thresh = _opening_scores(
        xc, yc, zc, com, radius, m_tot, tile, theta=theta, mac_tau=mac_tau,
        src_tile=src_tile, eps2=eps2, c2=compensate * compensate)
    return jnp.sum(score > thresh, axis=1)


def _clamp_vip(vip_tiles: int, k: int) -> int:
    """VIP capacity must leave a tree behind (and stay 0 for tiny K)."""
    return int(min(vip_tiles, k // 4))


def _vip_src_tiles(vip_tiles: int, tile: int, src_tile: int) -> int:
    """Re-express the VIP capacity at the SOURCE granularity.

    ``vip_tiles`` is counted in fixed ``DEFAULT_TILE`` (32)-body units
    regardless of the target-row ``tile``: the VIP budget is an
    exact-body budget (128 units = 4,096 bodies by default) and the
    halo-tile pathology it patches lives at SOURCE granularity, so the
    output-row granularity must not scale it. (Scaling by ``tile``
    silently quadrupled the hierarchical path's N x V VIP sweep at
    tile=128 with no accuracy rationale.)"""
    del tile
    return max(int(vip_tiles * DEFAULT_TILE // src_tile),
               1 if vip_tiles else 0)


def suggest_max_near(
    pos,
    mass,
    *,
    tile: int = DEFAULT_TILE,
    theta: float = DEFAULT_THETA,
    vip_tiles: int = DEFAULT_VIP_TILES,
    margin: float = 1.2,
    multiple: int = 32,
    src_tile: int | None = None,
    mac_tau: float = 0.0,
    eps2: float = 1e-6,
    compensate: float = 0.1,
) -> int:
    """Static near-list capacity (in SOURCE tiles) for this distribution
    (host-side).

    ``margin`` absorbs near-count growth between Morton re-sorts —
    measured +12% over the default 8-step rebuild cadence at N=65k, so
    1.2 leaves real headroom (spare slots also tighten accuracy by
    computing the worst far tiles exactly); ``multiple`` rounds the
    capacity up.
    """
    counts = np.asarray(open_counts(
        jnp.asarray(pos), jnp.asarray(mass),
        tile=tile, theta=theta, vip_tiles=vip_tiles, src_tile=src_tile,
        mac_tau=mac_tau, eps2=eps2, compensate=compensate,
    ))
    k = max(pos.shape[0] // (src_tile or tile), 1)
    need = int(math.ceil(float(counts.max()) * margin))
    need = ((need + multiple - 1) // multiple) * multiple
    return int(min(max(need, 1), k))


# --------------------------------------------------------------- far field
def _far_field(pos, com, m_tot, quad, near_mask, *,
               eps2: float, c2: float, G: float, tile: int):
    """(N, 3) form of :func:`_far_field_cols`."""
    return jnp.stack(_far_field_cols(
        *_cols(pos), com, m_tot, quad, near_mask, eps2=eps2, c2=c2, G=G,
        tile=tile), axis=1)


def _far_field_cols(xc, yc, zc, com, m_tot, quad, near_mask, *,
                    eps2: float, c2: float, G: float, tile: int):
    """Monopole+quadrupole acceleration from all non-near tiles,
    (ax, ay, az) columns (the single-level far field: every body against
    every source tile, near tiles masked out).

    Softened multipole expansion around each tile's com with
    u = (c^2 r^2 + eps2)^(-1/2), d = com - y:

        acc = G c [ M c^2 u^3 - (3/2) c^4 tr(S) u^5
                    + (15/2) c^6 (d'Sd) u^7 ] d  -  3 G c^5 u^5 S d

    Reduces to the classic Newtonian quadrupole for eps2 -> 0; vanishes
    for isotropic S. ``near_mask`` rows may be a LOCAL slice of the
    target tiles (the sharded paths); columns span all source tiles.
    """
    n = xc.shape[0]
    k = com.shape[0]
    c = math.sqrt(c2)
    c4 = c2 * c2
    c6 = c4 * c2
    gc = G * c

    sxx, syy, szz = quad[:, 0], quad[:, 1], quad[:, 2]
    sxy, sxz, syz = quad[:, 3], quad[:, 4], quad[:, 5]
    tr = sxx + syy + szz                                        # (K,)

    cx, cy, cz = com[:, 0], com[:, 1], com[:, 2]

    def per_chunk(args):
        x_c, y_c, z_c, mask_c = args                            # (C,), (C,K)
        dx = cx[None, :] - x_c[:, None]                         # (C, K)
        dy = cy[None, :] - y_c[:, None]
        dz = cz[None, :] - z_c[:, None]
        r2 = dx * dx + dy * dy + dz * dz
        u2 = 1.0 / (c2 * r2 + eps2)
        u = jnp.sqrt(u2)
        u3 = u2 * u
        u5 = u3 * u2
        u7 = u5 * u2
        sdx = sxx * dx + sxy * dy + sxz * dz                    # (C, K)
        sdy = sxy * dx + syy * dy + syz * dz
        sdz = sxz * dx + syz * dy + szz * dz
        q = dx * sdx + dy * sdy + dz * sdz                      # d' S d
        wd = m_tot * c2 * u3 - 1.5 * c4 * tr * u5 + 7.5 * c6 * q * u7
        live = jnp.logical_not(mask_c)
        wd = jnp.where(live, wd, 0.0)
        ws = jnp.where(live, -3.0 * c4 * u5, 0.0)
        ax = jnp.sum(wd * dx + ws * sdx, axis=1)
        ay = jnp.sum(wd * dy + ws * sdy, axis=1)
        az = jnp.sum(wd * dz + ws * sdz, axis=1)
        return gc * jnp.stack([ax, ay, az], axis=0)             # (3, C)

    chunk = tile * _chunk_size(n // tile, max(8192 // tile, 1))
    body_tile = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0] // tile
    mask = near_mask[body_tile]                                 # (N, K)
    shape = (n // chunk, chunk)
    out = lax.map(
        per_chunk,
        (xc.reshape(shape), yc.reshape(shape), zc.reshape(shape),
         mask.reshape(n // chunk, chunk, k)),
    )                                                           # (n/C, 3, C)
    out = jnp.moveaxis(out, 1, 0).reshape(3, n)
    return out[0], out[1], out[2]


# -------------------------------------------------------------- near field
def _gather_panels(pos, scaled_mass, near_idx, tile: int):
    """(4, K, M*T) gathered [x y z m] panels per target tile (the dense
    per-target path: every target row gathers its ``max_near`` source
    tiles)."""
    k, m_near = near_idx.shape
    body_idx = (near_idx[:, :, None] * tile
                + jnp.arange(tile, dtype=near_idx.dtype)[None, None, :]
                ).reshape(k, m_near * tile)                     # (K, M*T)
    comps = [pos[:, 0], pos[:, 1], pos[:, 2], scaled_mass]
    return jnp.stack([c[body_idx] for c in comps], axis=0)      # (4, K, M*T)


def _near_field_xla(pos, panels, *, eps2: float, c2: float, tile: int):
    """Gathered-panel near field of the dense path. panels: (4, K, W)."""
    n = pos.shape[0]
    k = panels.shape[1]

    def per_tile(args):
        pi, pan = args                                          # (T,3), (4,W)
        dx = pan[0][None, :] - pi[:, 0:1]                       # (T, W)
        dy = pan[1][None, :] - pi[:, 1:2]
        dz = pan[2][None, :] - pi[:, 2:3]
        inv = lax.rsqrt(c2 * (dx * dx + dy * dy + dz * dz) + eps2)
        w = pan[3][None, :] * (inv * inv * inv)
        return jnp.stack([jnp.sum(w * dx, axis=1), jnp.sum(w * dy, axis=1),
                          jnp.sum(w * dz, axis=1)], axis=1)     # (T, 3)

    return lax.map(
        per_tile, (pos.reshape(k, tile, 3), jnp.swapaxes(panels, 0, 1))
    ).reshape(n, 3)


# --------------------------------------------------------------- VIP sweep
def _dense_sweep_cols(xi, yi, zi, xj, yj, zj, scaled_mj, *, eps2: float,
                      c2: float):
    """Exact acc columns of the row bodies due to the (pre-scaled-mass)
    column panel — the plain XLA form of the all-pairs block operation
    (``ops/pallas_force.py`` holds the kernel)."""
    ni = xi.shape[0]
    chunk = _chunk_size(ni, max(1, _PAIR_BUDGET // max(xj.shape[0], 1)))

    def per_chunk(args):
        x_c, y_c, z_c = args                                    # (C,)
        dx = xj[None, :] - x_c[:, None]                         # (C, W)
        dy = yj[None, :] - y_c[:, None]
        dz = zj[None, :] - z_c[:, None]
        inv = lax.rsqrt(c2 * (dx * dx + dy * dy + dz * dz) + eps2)
        w = scaled_mj[None, :] * (inv * inv * inv)
        return jnp.stack([jnp.sum(w * dx, axis=1), jnp.sum(w * dy, axis=1),
                          jnp.sum(w * dz, axis=1)], axis=0)     # (3, C)

    shape = (ni // chunk, chunk)
    out = lax.map(per_chunk, (xi.reshape(shape), yi.reshape(shape),
                              zi.reshape(shape)))
    out = jnp.moveaxis(out, 1, 0).reshape(3, ni)
    return out[0], out[1], out[2]


def _dense_sweep(pos_i, pos_j, scaled_mass_j, *, eps2: float, c2: float):
    """(N_i, 3) form of :func:`_dense_sweep_cols`."""
    return jnp.stack(_dense_sweep_cols(
        *_cols(pos_i), *_cols(pos_j), scaled_mass_j, eps2=eps2, c2=c2),
        axis=1)


def _pow2_tile(n: int, cap: int) -> int:
    """Largest power of two <= cap dividing n (kernel block width)."""
    t = cap
    while n % t:
        t //= 2
    return t


def _pair_cols(xi, yi, zi, xj, yj, zj, scaled_mj, *, eps2, c2,
               plan: ExecutionPlan):
    """All-pairs block op through the plan: kernel or plain XLA."""
    if plan.pair_kernel:
        from n_body_problem_tpu.ops.pallas_force import pair_block_cols

        return pair_block_cols(
            xi, yi, zi, xj, yj, zj, scaled_mj, eps2=eps2, c2=c2,
            tile_i=_pow2_tile(xi.shape[0], 64),
            tile_j=_pow2_tile(xj.shape[0], 64), interpret=plan.interpret)
    return _dense_sweep_cols(xi, yi, zi, xj, yj, zj, scaled_mj, eps2=eps2,
                             c2=c2)


def _vip_sweep_cols(xc, yc, zc, scaled_all, vx, vy, vz, vscaled, *,
                    eps2: float, c2: float, plan: ExecutionPlan):
    """Both directions of the exact VIP sweep, as columns:
    ``((ax, ay, az) of every row body due to the VIP panel,
    (rx, ry, rz) of every VIP due to the row bodies)``.

    Rows and panel are decoupled so the multi-device paths can sweep
    LOCAL rows against the GLOBAL panel (the reactions then psum to
    completeness). The reaction is the same block operation with the
    roles swapped: the row set is all bodies, VIPs included, and
    self-pairs contribute zero, so it IS each VIP's complete
    acceleration.
    """
    action = _pair_cols(xc, yc, zc, vx, vy, vz, vscaled, eps2=eps2, c2=c2,
                        plan=plan)
    react = _pair_cols(vx, vy, vz, xc, yc, zc, scaled_all, eps2=eps2, c2=c2,
                       plan=plan)
    return action, react


# ------------------------------------------------------------------ solver
def _static_args(n, tile, theta, max_near, vip_tiles):
    if n % tile:
        raise ValueError(f"treecode_acc: N={n} must be a multiple of tile={tile}")
    if not (0.0 < theta <= 1.0):
        raise ValueError(f"theta must be in (0, 1], got {theta}")
    k = n // tile
    # Round the capacity to a multiple of 4; extra slots only add exact
    # tiles.
    max_near = min(-(-max_near // 4) * 4, k)
    vip_tiles = _clamp_vip(vip_tiles, k)
    return k, max_near, vip_tiles


@functools.partial(
    jax.jit,
    static_argnames=("tile", "theta", "max_near", "vip_tiles", "mac_tau",
                     "eps2", "compensate"),
)
def build_tree(
    pos: jax.Array,
    mass: jax.Array,
    *,
    tile: int = DEFAULT_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    mac_tau: float = 0.0,
    eps2: float = 1e-6,
    compensate: float = 0.1,
):
    """Acceptance structures: (near_idx, near_mask, is_vip_body).

    The expensive, slowly-varying part of the solver (top_k over the
    (K, K) opening ratios + VIP selection). Bodies move ~v*dt per step
    while tile scales are ~100x larger, so callers may reuse the result
    across ``SimConfig.tree_rebuild_every`` steps — the ``suggest_max_near``
    margin absorbs the drift (the lists stay conservative: stale entries
    are merely computed exactly a little longer than strictly needed).
    """
    n = pos.shape[0]
    k, max_near, vip_tiles = _static_args(n, tile, theta, max_near, vip_tiles)
    f32 = jnp.float32
    pos = pos.astype(f32)
    mass = mass.astype(f32)
    xc, yc, zc = _cols(pos)
    if vip_tiles:
        mass_tree, _, is_vip_body = _vip_split(xc, yc, zc, mass, tile,
                                               vip_tiles)
    else:
        is_vip_body = jnp.zeros((n,), bool)
        mass_tree = mass
    com, m_tot, radius, _ = tile_summaries_cols(xc, yc, zc, mass_tree, tile)
    near_idx, near_mask = _acceptance(
        pos, com, radius, tile, theta, max_near, m_tot=m_tot,
        mac_tau=mac_tau, eps2=eps2, c2=compensate * compensate)
    return near_idx, near_mask, is_vip_body


# ------------------------------------------------- compacted (flat) lists
# Near cost with per-target static capacity is max-bound (every target
# pays for the worst target's near count). The flat path compacts the
# per-target near lists into ONE work array so cost is MEAN-bound, and
# works at an ASYMMETRIC granularity: target rows stay ``tile`` bodies —
# the output/accuracy granularity — while near SOURCES span ``src_tile``
# (=64) bodies. Coarser sources shrink every bookkeeping structure 2x
# (acceptance matrix, top_k, far-field summary count); the price is a
# thicker exact-near boundary shell (the opening test fires earlier for
# bigger sources).
CHUNK_LANES = 2048        # source bodies per near work-list chunk: the
                          # lists are allocated in chunks of
                          # CHUNK_LANES / src_tile source tiles (an
                          # algorithm default, not yet tuned on the GPU)
DEFAULT_SRC_TILE = 64     # source granularity (bodies) of the flat path
                          # (64 vs 128: equal p99 error on the same state
                          # at N=262k, half the near work per entry)
DEFAULT_NEAR_SLACK = 8    # extra closest-far source tiles computed exactly
                          # per target (headroom for inter-rebuild drift)
_PAIR_BUDGET = 1 << 26    # pair evaluations per step of the XLA forms'
                          # loops (bounds their transient memory)


def _flat_static(n, tile, src_tile, theta, max_near, vip_tiles):
    if src_tile % tile and tile % src_tile:
        raise ValueError(f"src_tile={src_tile} and tile={tile} must be "
                         f"multiples of one another")
    if n % tile:
        raise ValueError(f"flat treecode: N={n} must be a multiple of "
                         f"tile={tile}")
    if n % src_tile:
        raise ValueError(f"flat treecode: N={n} must be a multiple of "
                         f"src_tile={src_tile}")
    if not (0.0 < theta <= 1.0):
        raise ValueError(f"theta must be in (0, 1], got {theta}")
    if src_tile > CHUNK_LANES:
        raise ValueError(f"src_tile={src_tile} > {CHUNK_LANES}")
    k_t = n // tile
    k_s = n // src_tile
    entries = CHUNK_LANES // src_tile
    if k_s < entries:
        raise ValueError(f"flat path needs K_src >= {entries}; "
                         "use treecode_acc")
    max_near = max(-(-max_near // entries) * entries, entries)
    max_near = min(max_near, k_s - (k_s % entries) or k_s)
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    return k_t, k_s, entries, max_near, vip_src


@functools.partial(
    jax.jit,
    static_argnames=("tile", "src_tile", "theta", "max_near", "vip_tiles",
                     "slack", "flat_cap", "mac_tau", "eps2", "compensate"),
)
def build_tree_flat(
    pos: jax.Array,
    mass: jax.Array,
    *,
    tile: int = DEFAULT_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    slack: int = DEFAULT_NEAR_SLACK,
    flat_cap: int,
    mac_tau: float = 0.0,
    eps2: float = 1e-6,
    compensate: float = 0.1,
):
    """Compacted asymmetric acceptance structures.

    Returns ``(flat_src (flat_cap,), chunk_tgt (flat_cap/E,), near_mask
    (K_t, K_s) bool, is_vip_body (N,))`` with E = CHUNK_LANES/src_tile
    entries per work chunk. Target row i occupies
    ``v_i = round_up(open_count_i + slack, E)`` slots (clamped to
    ``max_near``, worst tiles first); entries past ``flat_cap`` drop, and
    ``near_mask`` is reconstructed from the entries that actually LANDED,
    so the far field exactly complements the near coverage even under
    capacity overflow (nothing is ever double-counted or lost to both
    sides). Size ``flat_cap`` with margin via :func:`suggest_flat_cap`.
    """
    return build_tree_flat_cols(
        *_cols(pos), mass, tile=tile, src_tile=src_tile, theta=theta,
        max_near=max_near, vip_tiles=vip_tiles, slack=slack,
        flat_cap=flat_cap, mac_tau=mac_tau, eps2=eps2,
        compensate=compensate)


def build_tree_flat_cols(
    xc, yc, zc, mass,
    *,
    tile: int = DEFAULT_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    slack: int = DEFAULT_NEAR_SLACK,
    flat_cap: int,
    mac_tau: float = 0.0,
    eps2: float = 1e-6,
    compensate: float = 0.1,
):
    """Columnar core of :func:`build_tree_flat` ((N,) coordinate columns
    in; same outputs). The scanned run carries columns, so this avoids
    ever materializing an (N, 3) array on the hot path."""
    n = xc.shape[0]
    k_t, k_s, entries, max_near, vip_src = _flat_static(
        n, tile, src_tile, theta, max_near, vip_tiles)
    f32 = jnp.float32
    i32 = jnp.int32
    xc = xc.astype(f32)
    yc = yc.astype(f32)
    zc = zc.astype(f32)
    mass = mass.astype(f32)
    if vip_src:
        mass_tree, _, is_vip_body = _vip_split(xc, yc, zc, mass, src_tile,
                                               vip_src)
    else:
        is_vip_body = jnp.zeros((n,), bool)
        mass_tree = mass
    com, m_tot, radius, _ = tile_summaries_cols(xc, yc, zc, mass_tree,
                                                src_tile)
    score, thresh = _opening_scores(
        xc, yc, zc, com, radius, m_tot, tile, theta=theta, mac_tau=mac_tau,
        src_tile=src_tile, eps2=eps2, c2=compensate * compensate)
    flat_src, chunk_tgt, near_mask = _compact_open_lists(
        score, thresh, slack, flat_cap, entries, max_near)
    return flat_src, chunk_tgt, near_mask, is_vip_body


def _compact_open_lists(ratio, theta, slack, flat_cap, entries, max_near):
    """Compact per-row opening ratios into the flat work lists:
    (flat_src (flat_cap,), chunk_tgt (flat_cap/E,), near_mask (K_t, K_s)).

    ``ratio`` rows may be a LOCAL slice of the global target rows (the
    sharded path builds per-chip lists); columns span all sources.
    """
    k_t, k_s = ratio.shape
    i32 = jnp.int32
    vals, near_idx = lax.top_k(ratio, max_near)                 # (K_t, M)
    # Entries with a NEGATIVE score are excluded by construction (the
    # hierarchical path marks leaves already covered by an accepted
    # ancestor with score -1; computing them here too would double-count
    # that mass). Point them at the sentinel source (k_s): the kernel
    # fetches the zero tile, and the near-mask scatter drops them.
    near_idx = jnp.where(vals < 0, k_s, near_idx.astype(i32))
    cnt = jnp.sum(ratio > theta, axis=1).astype(i32)            # (K_t,)
    v = jnp.clip(
        ((cnt + slack + entries - 1) // entries) * entries,
        entries, max_near,
    )                                                           # (K_t,)
    # Graceful overflow: if the total demand exceeds flat_cap, keep one
    # chunk per row (so every row retains its top-ranked entries — the
    # worst offenders, self tile first; a dropped self tile would inject a
    # catastrophic self-multipole at d ~ 0) and scale the EXCESS
    # proportionally. sum(v') <= k_t*E + sf*sum(v - E) <= flat_cap, so no
    # row ever spills past the capacity.
    if flat_cap < k_t * entries:
        raise ValueError(
            f"flat_cap={flat_cap} < one chunk per target row "
            f"({k_t} * {entries}); use suggest_flat_cap")
    total = jnp.sum(v)
    extra = v - entries
    sf = ((flat_cap - k_t * entries)
          / jnp.maximum(jnp.sum(extra), 1).astype(jnp.float32))
    v_scaled = entries + (jnp.floor(extra.astype(jnp.float32) * sf)
                          .astype(i32) // entries) * entries
    v = jnp.where(total > flat_cap, v_scaled, v)
    offs = jnp.concatenate([jnp.zeros((1,), i32),
                            jnp.cumsum(v, dtype=i32)])[:k_t]    # (K_t,)

    s_idx = jax.lax.broadcasted_iota(i32, (k_t, max_near), 1)
    valid = s_idx < v[:, None]
    dest = jnp.where(valid, offs[:, None] + s_idx, flat_cap)
    flat_src = (
        jnp.full((flat_cap + 1,), k_s, i32)                     # sentinel
        .at[dest.reshape(-1)].set(near_idx.reshape(-1), mode="drop")
    )[:flat_cap]

    n_chunks = flat_cap // entries
    cpr = max_near // entries                                   # chunks/row
    c_idx = jax.lax.broadcasted_iota(i32, (k_t, cpr), 1)
    cvalid = c_idx < (v // entries)[:, None]
    cdest = jnp.where(cvalid, offs[:, None] // entries + c_idx, n_chunks)
    rows = jax.lax.broadcasted_iota(i32, (k_t, cpr), 0)
    chunk_tgt = (
        jnp.full((n_chunks + 1,), k_t, i32)                     # dummy target
        .at[cdest.reshape(-1)].set(rows.reshape(-1), mode="drop")
    )[:n_chunks]

    # Far-field complement from the entries that LANDED (slot -> its
    # chunk's target row; sentinel rows/cols fall out via OOB drop).
    slot_rows = jnp.repeat(chunk_tgt, entries)                  # (flat_cap,)
    near_mask = (
        jnp.zeros((k_t, k_s), bool)
        .at[slot_rows, flat_src]
        .max(jnp.ones((flat_cap,), bool), mode="drop")
    )
    return flat_src, chunk_tgt, near_mask


def suggest_flat_cap(pos, mass, *, tile: int = DEFAULT_TILE,
                     src_tile: int = DEFAULT_SRC_TILE,
                     theta: float = DEFAULT_THETA,
                     vip_tiles: int = DEFAULT_VIP_TILES,
                     slack: int = DEFAULT_NEAR_SLACK,
                     margin: float = 1.25,
                     mac_tau: float = 0.0,
                     eps2: float = 1e-6,
                     compensate: float = 0.1) -> int:
    """Static flat-list capacity for this distribution (host-side).

    ``margin`` covers near-count growth over the whole run (the capacity
    is fixed at init, unlike the lists which rebuild every few steps);
    unused tail chunks carry the sentinel tag and the near kernel skips
    their compute, so headroom costs almost nothing.
    """
    counts = np.asarray(open_counts(
        jnp.asarray(pos), jnp.asarray(mass),
        tile=tile, theta=theta, vip_tiles=vip_tiles, src_tile=src_tile,
        mac_tau=mac_tau, eps2=eps2, compensate=compensate,
    ))
    entries = CHUNK_LANES // src_tile
    v = np.maximum(
        ((counts + slack + entries - 1) // entries) * entries, entries,
    )
    need = int(math.ceil(float(v.sum()) * margin))
    k_t = max(pos.shape[0] // tile, 1)
    need = max(need, k_t * entries)    # >= one chunk per target row
    return ((need + entries - 1) // entries) * entries


def suggest_flat_cap_sharded(pos, mass, n_dev: int, *,
                             tile: int = DEFAULT_TILE,
                             src_tile: int = DEFAULT_SRC_TILE,
                             theta: float = DEFAULT_THETA,
                             vip_tiles: int = DEFAULT_VIP_TILES,
                             slack: int = DEFAULT_NEAR_SLACK,
                             margin: float = 1.4,
                             mac_tau: float = 0.0,
                             eps2: float = 1e-6,
                             compensate: float = 0.1) -> int:
    """Static PER-CHIP flat-list capacity when target rows are sharded
    over ``n_dev`` chips (host-side).

    Each chip owns a contiguous row block; the core chips' blocks open
    more tiles than the halo chips', so the shared static capacity is the
    worst block's demand. ``margin`` is higher than the single-chip 1.25
    because per-block imbalance drifts as the system evolves.
    """
    counts = np.asarray(open_counts(
        jnp.asarray(pos), jnp.asarray(mass),
        tile=tile, theta=theta, vip_tiles=vip_tiles, src_tile=src_tile,
        mac_tau=mac_tau, eps2=eps2, compensate=compensate,
    ))
    entries = CHUNK_LANES // src_tile
    v = np.maximum(
        ((counts + slack + entries - 1) // entries) * entries, entries,
    )
    k_t = len(v)
    if k_t % n_dev:
        raise ValueError(f"K_t={k_t} not divisible by n_dev={n_dev}")
    per_chip = v.reshape(n_dev, k_t // n_dev).sum(axis=1)
    need = int(math.ceil(float(per_chip.max()) * margin))
    need = max(need, (k_t // n_dev) * entries)
    return ((need + entries - 1) // entries) * entries


def _source_cols(xc, yc, zc, scaled, src_tile: int):
    """Near-field source columns ``(xs, ys, zs, ms)``: the bodies in
    source-tile order plus one all-zero sentinel tile at index K_s (list
    entries that point there contribute exactly nothing). Masses are
    pre-scaled by G c^3."""
    pad = lambda a: jnp.concatenate(
        [a.astype(jnp.float32), jnp.zeros((src_tile,), jnp.float32)])
    return pad(xc), pad(yc), pad(zc), pad(scaled)


def _row_ranges(chunk_tgt, k_t: int):
    """(first chunk (K_t,), chunk count (K_t,)) of every target row in a
    compacted work list. ``_compact_open_lists`` writes each row's chunks
    contiguously in row order (sentinel tail last), so ``chunk_tgt`` is
    sorted and two searches give the ranges."""
    rows = jnp.arange(k_t, dtype=chunk_tgt.dtype)
    first = jnp.searchsorted(chunk_tgt, rows, side="left")
    last = jnp.searchsorted(chunk_tgt, rows, side="right")
    return first.astype(jnp.int32), (last - first).astype(jnp.int32)


def _row_sums(vals, chunk_tgt, k_t: int, max_chunks: int):
    """Sum per-chunk partials ``vals (n_chunks, ...)`` into their target
    rows: ``(K_t, ...)``. Each row gathers its own ``max_chunks`` slots in
    a fixed order — deterministic from run to run, unlike a scatter-add,
    whose float additions land in whatever order the atomics do."""
    first, count = _row_ranges(chunk_tgt, k_t)
    slot = jnp.arange(max_chunks, dtype=jnp.int32)
    idx = first[:, None] + slot[None, :]                        # (K_t, C)
    valid = slot[None, :] < count[:, None]
    g = vals[jnp.where(valid, idx, 0)]                          # (K_t, C, ...)
    valid = valid.reshape(valid.shape + (1,) * (g.ndim - 2))
    return jnp.sum(jnp.where(valid, g, 0.0), axis=1)


def _near_flat_kernel(first_ref, count_ref, fsrc_ref, xt_ref, yt_ref,
                      zt_ref, xs_ref, ys_ref, zs_ref, ms_ref,
                      ax_ref, ay_ref, az_ref, *, c2: float, eps2: float,
                      src_tile: int, entries: int, blocks_per_row: int):
    """Flat near field for the GPU (Pallas, Triton): one program per
    block of a target row, looping over that row's own slice of the
    compacted list — one ``src_tile``-body source tile per iteration,
    its index loaded from the list and its bodies from the source
    columns. Sums stay in registers; each program writes only its own
    rows, so there are no atomics and the result is deterministic.
    Sentinel entries point at the zero tile; the list's sentinel tail
    (tag K_t) belongs to no row and is never visited."""
    row = pl.program_id(0) // blocks_per_row
    e0 = first_ref[row] * entries
    e1 = e0 + count_ref[row] * entries
    xi = xt_ref[...][:, None]                           # (TB, 1)
    yi = yt_ref[...][:, None]
    zi = zt_ref[...][:, None]

    def body(e, acc):
        sx, sy, sz = acc
        o = pl.multiple_of(fsrc_ref[e] * src_tile, src_tile)
        dx = xs_ref[pl.ds(o, src_tile)][None, :] - xi      # (TB, S)
        dy = ys_ref[pl.ds(o, src_tile)][None, :] - yi
        dz = zs_ref[pl.ds(o, src_tile)][None, :] - zi
        inv = lax.rsqrt((dx * dx + dy * dy + dz * dz) * c2 + eps2)
        w = ms_ref[pl.ds(o, src_tile)][None, :] * (inv * inv * inv)
        return sx + w * dx, sy + w * dy, sz + w * dz

    zero = jnp.zeros((xi.shape[0], src_tile), jnp.float32)
    sx, sy, sz = lax.fori_loop(e0, e1, body, (zero, zero, zero))
    ax_ref[...] = jnp.sum(sx, axis=1)
    ay_ref[...] = jnp.sum(sy, axis=1)
    az_ref[...] = jnp.sum(sz, axis=1)


NEAR_ROWS = 64            # target rows per near-kernel program
NEAR_WARPS = 4
NEAR_STAGES = 3


def _near_field_flat_kernel(xc, yc, zc, src, flat_src, chunk_tgt, *,
                            eps2: float, c2: float, tile: int,
                            src_tile: int, interpret: bool = False):
    """Kernel form of :func:`_near_field_flat_cols` (same arguments)."""
    n = xc.shape[0]
    k_t = n // tile
    rows = _pow2_tile(tile, NEAR_ROWS)
    first, count = _row_ranges(chunk_tgt, k_t)
    blk = pl.BlockSpec((rows,), lambda p: (p,))
    whole = pl.no_block_spec
    out = jax.ShapeDtypeStruct((n,), jnp.float32)
    return pl.pallas_call(
        functools.partial(_near_flat_kernel, c2=float(c2), eps2=float(eps2),
                          src_tile=src_tile,
                          entries=CHUNK_LANES // src_tile,
                          blocks_per_row=tile // rows),
        grid=(n // rows,),
        in_specs=[whole, whole, whole, blk, blk, blk,
                  whole, whole, whole, whole],
        out_specs=[blk, blk, blk],
        out_shape=[out, out, out],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NEAR_WARPS,
                                             num_stages=NEAR_STAGES),
        interpret=interpret,
        name="nbody_near_flat",
    )(first, count, flat_src.astype(jnp.int32), xc, yc, zc, *src)


def _near_field_flat_xla(xc, yc, zc, src, flat_src, chunk_tgt, *,
                         eps2: float, c2: float, tile: int, src_tile: int,
                         max_chunks: int, block: int | None = None):
    """Plain XLA form of :func:`_near_field_flat_cols`: per-chunk partial
    sums in ``block``-chunk steps of a loop (mean-bound, like the list),
    then the deterministic per-row reduction :func:`_row_sums`."""
    n = xc.shape[0]
    k_t = n // tile
    entries = CHUNK_LANES // src_tile
    width = entries * src_tile
    n_chunks = chunk_tgt.shape[0]
    k_s = src[0].shape[0] // src_tile - 1
    xs, ys, zs, ms = (a.reshape(k_s + 1, src_tile) for a in src)
    tx, ty, tz = (jnp.concatenate([a, jnp.zeros((tile,), a.dtype)])
                  .reshape(k_t + 1, tile) for a in (xc, yc, zc))
    b = block or max(1, _PAIR_BUDGET // (tile * width))
    b = min(b, n_chunks)
    pad = -n_chunks % b
    ct = jnp.concatenate([chunk_tgt, jnp.full((pad,), k_t, jnp.int32)])
    fs = jnp.concatenate([flat_src, jnp.full((pad * entries,), k_s,
                                             jnp.int32)])

    def per_block(args):
        ct_b, fs_b = args                               # (B,), (B*E,)
        idx = fs_b.reshape(b, entries)
        px = xs[idx].reshape(b, 1, width)
        py = ys[idx].reshape(b, 1, width)
        pz = zs[idx].reshape(b, 1, width)
        pm = ms[idx].reshape(b, 1, width)
        dx = px - tx[ct_b][:, :, None]                  # (B, T, W)
        dy = py - ty[ct_b][:, :, None]
        dz = pz - tz[ct_b][:, :, None]
        inv = lax.rsqrt(c2 * (dx * dx + dy * dy + dz * dz) + eps2)
        w = pm * (inv * inv * inv)
        return jnp.stack([jnp.sum(w * dx, axis=2), jnp.sum(w * dy, axis=2),
                          jnp.sum(w * dz, axis=2)], axis=2)  # (B, T, 3)

    vals = lax.map(per_block, (ct.reshape(-1, b),
                               fs.reshape(-1, b * entries)))
    vals = vals.reshape(-1, tile, 3)[:n_chunks]
    acc = _row_sums(vals, chunk_tgt, k_t, max_chunks).reshape(n, 3)
    return acc[:, 0], acc[:, 1], acc[:, 2]


def _near_field_flat_cols(xc, yc, zc, src, flat_src, chunk_tgt, *,
                          eps2: float, c2: float, tile: int, src_tile: int,
                          max_chunks: int, plan: ExecutionPlan):
    """Mean-bound exact near field of the compacted lists: (ax, ay, az)
    of the ``tile``-body target rows in ``xc`` from the source columns
    ``src`` (:func:`_source_cols`). ``max_chunks`` bounds any row's chunk
    count (``max_near / entries``). The plan picks the GPU kernel or the
    plain XLA form."""
    if plan.near_kernel:
        return _near_field_flat_kernel(
            xc, yc, zc, src, flat_src, chunk_tgt, eps2=eps2, c2=c2,
            tile=tile, src_tile=src_tile, interpret=plan.interpret)
    return _near_field_flat_xla(
        xc, yc, zc, src, flat_src, chunk_tgt, eps2=eps2, c2=c2, tile=tile,
        src_tile=src_tile, max_chunks=max_chunks)


# ---------------------------------------------------- sharded flat helpers
def _flat_src_static(n_g: int, tile: int, src_tile: int,
                     max_near: int, vip_tiles: int):
    """(k_s, entries, max_near, vip_src) for a GLOBAL source population
    (the sharded path validates rows and sources separately)."""
    if n_g % src_tile:
        raise ValueError(f"flat treecode: global N={n_g} must be a "
                         f"multiple of src_tile={src_tile}")
    k_s = n_g // src_tile
    entries = CHUNK_LANES // src_tile
    if k_s < entries:
        raise ValueError(f"flat path needs K_src >= {entries}")
    max_near = max(-(-max_near // entries) * entries, entries)
    max_near = min(max_near, k_s - (k_s % entries) or k_s)
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    return k_s, entries, max_near, vip_src


def build_flat_local(xl, yl, zl, xg, yg, zg, mass_g, *, tile: int,
                     src_tile: int, theta: float, max_near: int,
                     vip_tiles: int, slack: int, flat_cap: int,
                     row_offset, mac_tau: float = 0.0,
                     eps2: float = 1e-6, compensate: float = 0.1):
    """Flat acceptance for LOCAL target rows against GLOBAL sources
    (inside shard_map: every chip computes the identical global VIP split
    and source summaries from replicated columns, then compacts work
    lists for its own contiguous row block only).

    Returns ``(flat_src, chunk_tgt, near_mask (K_t_local, K_s_global),
    is_vip_g (N_global,))``; ``flat_cap`` is the PER-CHIP capacity.
    """
    n_g = xg.shape[0]
    k_s, entries, max_near, vip_src = _flat_src_static(
        n_g, tile, src_tile, max_near, vip_tiles)
    if vip_src:
        mass_tree_g, _, is_vip_g = _vip_split(xg, yg, zg, mass_g,
                                              src_tile, vip_src)
    else:
        is_vip_g = jnp.zeros((n_g,), bool)
        mass_tree_g = mass_g
    com, m_tot, radius, _ = tile_summaries_cols(xg, yg, zg, mass_tree_g,
                                                src_tile)
    score, thresh = _opening_scores(
        xl, yl, zl, com, radius, m_tot, tile, theta=theta, mac_tau=mac_tau,
        row_offset=row_offset, src_tile=src_tile, eps2=eps2,
        c2=compensate * compensate)
    flat_src, chunk_tgt, near_mask = _compact_open_lists(
        score, thresh, slack, flat_cap, entries, max_near)
    return flat_src, chunk_tgt, near_mask, is_vip_g


def _vip_body_idx(is_vip_body, k_s: int, src_tile: int, vip_src: int):
    """(vip tile ids (V,), vip body ids (V*S,)) of the VIP split."""
    vip_tile_idx = jnp.nonzero(
        is_vip_body.reshape(k_s, src_tile)[:, 0], size=vip_src, fill_value=0,
    )[0]
    body_idx = (vip_tile_idx[:, None] * src_tile
                + jnp.arange(src_tile, dtype=jnp.int32)[None, :]).reshape(-1)
    return vip_tile_idx, body_idx


def _apply_vip(ax, ay, az, xc, yc, zc, mass, vip_tile_idx, *, k_s: int,
               src_tile: int, gc3: float, eps2: float, c2: float,
               plan: ExecutionPlan):
    """Single-device VIP step: add the VIP panel's exact pull to every
    row and overwrite the VIP rows with their exact accelerations.
    VIP bodies are whole source tiles, so the panel gather and the
    overwrite run as row slices of the (K_s, S) column view instead of
    element-wise random access."""
    n = xc.shape[0]
    scaled_all = mass * jnp.float32(gc3)
    vrow = lambda col: col.reshape(k_s, src_tile)[vip_tile_idx].reshape(-1)
    action, react = _vip_sweep_cols(
        xc, yc, zc, scaled_all, vrow(xc), vrow(yc), vrow(zc),
        vrow(scaled_all), eps2=eps2, c2=c2, plan=plan)

    def merge(col, add, rcol):
        out = (col + add).reshape(k_s, src_tile)
        out = out.at[vip_tile_idx].set(rcol.reshape(-1, src_tile))
        return out.reshape(n)

    return tuple(merge(c, a, r) for c, a, r in zip((ax, ay, az), action,
                                                   react))


def flat_local_acc(xl, yl, zl, ml, xg, yg, zg, mass_g, aux, *, eps2: float,
                   compensate: float, G: float, tile: int, src_tile: int,
                   max_near: int, vip_tiles: int,
                   plan: ExecutionPlan | None = None):
    """Columnar flat treecode acc of LOCAL rows from replicated GLOBAL
    sources: ``(axl, ayl, azl, react (rx, ry, rz) | None,
    vip_body_idx | None)``.

    ``react`` is this device's partial pull on the global VIP panel — the
    caller must ``psum`` it over the mesh axis and overwrite the VIP rows
    it owns with it (see parallel/tree.py). Physics identical to
    :func:`treecode_acc_flat_cols` restricted to local target rows.
    """
    plan = plan or execution_plan()
    flat_src, chunk_tgt, near_mask, is_vip_g = aux
    n_g = xg.shape[0]
    k_s, entries, max_near, vip_src = _flat_src_static(
        n_g, tile, src_tile, max_near, vip_tiles)
    c2 = compensate * compensate
    gc3 = G * c2 * compensate
    f32 = jnp.float32
    mass_tree_g = jnp.where(is_vip_g, 0.0, mass_g) if vip_src else mass_g
    com, m_tot, _, quad = tile_summaries_cols(xg, yg, zg, mass_tree_g,
                                              src_tile)
    src = _source_cols(xg, yg, zg, mass_tree_g * f32(gc3), src_tile)
    nx, ny, nz = _near_field_flat_cols(
        xl, yl, zl, src, flat_src, chunk_tgt, eps2=eps2, c2=c2, tile=tile,
        src_tile=src_tile, max_chunks=max_near // entries, plan=plan)
    fx, fy, fz = _far_field_cols(xl, yl, zl, com, m_tot, quad, near_mask,
                                 eps2=eps2, c2=c2, G=G, tile=tile)
    ax, ay, az = nx + fx, ny + fy, nz + fz
    if not vip_src:
        return ax, ay, az, None, None
    _, vip_body_idx = _vip_body_idx(is_vip_g, k_s, src_tile, vip_src)
    scaled_all_g = mass_g * f32(gc3)
    action, react = _vip_sweep_cols(
        xl, yl, zl, ml * f32(gc3),
        xg[vip_body_idx], yg[vip_body_idx], zg[vip_body_idx],
        scaled_all_g[vip_body_idx], eps2=eps2, c2=c2, plan=plan)
    return (ax + action[0], ay + action[1], az + action[2], react,
            vip_body_idx)


@functools.partial(
    jax.jit,
    static_argnames=(
        "eps2", "compensate", "G", "tile", "src_tile", "theta", "max_near",
        "vip_tiles", "plan",
    ),
)
def treecode_acc_flat(
    pos: jax.Array,
    mass: jax.Array,
    aux_flat,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    plan: ExecutionPlan | None = None,
) -> jax.Array:
    """Approximate acc (N, 3) with compacted asymmetric near lists.

    ``aux_flat`` must come from :func:`build_tree_flat` with the same
    static knobs. Physics identical to :func:`treecode_acc` (theta
    acceptance, exact near field, monopole+quadrupole far field, exact
    VIP rows both ways); the near cost is mean-bound instead of
    max-bound.
    """
    ax, ay, az = treecode_acc_flat_cols(
        *_cols(pos), mass, aux_flat, eps2=eps2, compensate=compensate,
        G=G, tile=tile, src_tile=src_tile, theta=theta, max_near=max_near,
        vip_tiles=vip_tiles, plan=plan)
    return jnp.stack([ax, ay, az], axis=1)


def treecode_acc_flat_cols(
    xc, yc, zc, mass, aux_flat,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    plan: ExecutionPlan | None = None,
):
    """Columnar core of :func:`treecode_acc_flat`: (N,) coordinate columns
    in, (ax, ay, az) columns out. The scanned run carries columns so no
    (N, 3) array is ever materialized per step."""
    plan = plan or execution_plan()
    n = xc.shape[0]
    k_t, k_s, entries, max_near, vip_src = _flat_static(
        n, tile, src_tile, theta, max_near, vip_tiles)
    c2 = compensate * compensate
    gc3 = G * c2 * compensate
    f32 = jnp.float32
    xc, yc, zc, mass = (a.astype(f32) for a in (xc, yc, zc, mass))

    flat_src, chunk_tgt, near_mask, is_vip_body = aux_flat
    mass_tree = jnp.where(is_vip_body, 0.0, mass) if vip_src else mass
    com, m_tot, _, quad = tile_summaries_cols(xc, yc, zc, mass_tree,
                                              src_tile)
    src = _source_cols(xc, yc, zc, mass_tree * f32(gc3), src_tile)
    nx, ny, nz = _near_field_flat_cols(
        xc, yc, zc, src, flat_src, chunk_tgt, eps2=eps2, c2=c2, tile=tile,
        src_tile=src_tile, max_chunks=max_near // entries, plan=plan)
    fx, fy, fz = _far_field_cols(xc, yc, zc, com, m_tot, quad, near_mask,
                                 eps2=eps2, c2=c2, G=G, tile=tile)
    ax, ay, az = nx + fx, ny + fy, nz + fz
    if vip_src:
        vip_tile_idx, _ = _vip_body_idx(is_vip_body, k_s, src_tile, vip_src)
        ax, ay, az = _apply_vip(ax, ay, az, xc, yc, zc, mass, vip_tile_idx,
                                k_s=k_s, src_tile=src_tile, gc3=gc3,
                                eps2=eps2, c2=c2, plan=plan)
    return ax, ay, az


@functools.partial(
    jax.jit,
    static_argnames=(
        "eps2", "compensate", "G", "tile", "theta", "max_near", "vip_tiles",
        "mac_tau",
    ),
)
def treecode_acc(
    pos: jax.Array,
    mass: jax.Array,
    aux=None,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    mac_tau: float = 0.0,
) -> jax.Array:
    """Approximate acc (N, 3): theta-criterion near/far split + exact VIPs
    (the dense per-target path, plain XLA on every platform).

    Bodies should be Morton-sorted. ``max_near >= K`` is exact. ``aux``
    (from :func:`build_tree` with the same static knobs) reuses cached
    acceptance structures; None rebuilds them for this evaluation.
    """
    n = pos.shape[0]
    k, max_near, vip_tiles = _static_args(n, tile, theta, max_near, vip_tiles)
    c2 = compensate * compensate
    gc3 = G * c2 * compensate
    f32 = jnp.float32
    pos = pos.astype(f32)
    mass = mass.astype(f32)

    if aux is None:
        aux = build_tree(pos, mass, tile=tile, theta=theta,
                         max_near=max_near, vip_tiles=vip_tiles,
                         mac_tau=mac_tau, eps2=eps2, compensate=compensate)
    near_idx, near_mask, is_vip_body = aux
    mass_tree = jnp.where(is_vip_body, 0.0, mass) if vip_tiles else mass
    com, m_tot, _, quad = tile_summaries_cols(*_cols(pos), mass_tree, tile)

    panels = _gather_panels(pos, mass_tree * f32(gc3), near_idx, tile)
    acc = _near_field_xla(pos, panels, eps2=eps2, c2=c2, tile=tile)
    if max_near < k:
        acc = acc + _far_field(pos, com, m_tot, quad, near_mask,
                               eps2=eps2, c2=c2, G=G, tile=tile)

    if vip_tiles:
        _, vip_body_idx = _vip_body_idx(is_vip_body, k, tile, vip_tiles)
        scaled_all = mass * f32(gc3)
        pos_v = pos[vip_body_idx]                               # (W, 3)
        acc = acc + _dense_sweep(pos, pos_v, scaled_all[vip_body_idx],
                                 eps2=eps2, c2=c2)
        acc_vip = _dense_sweep(pos_v, pos, scaled_all, eps2=eps2, c2=c2)
        acc = acc.at[vip_body_idx].set(acc_vip)
    return acc


# ------------------------------------------------ hierarchical far field
# The single-level far field sweeps every body against all K_s source
# tiles — O(N * K_s), the wall toward N=1M. This section replaces it
# with a BINARY MERGE HIERARCHY over the Morton source tiles plus
# COMPACTED multi-level work lists (masked lanes still execute;
# structural sparsity needs compacted lists, not masks —
# docs/acceptance.md).
#
#   * Levels: level 0 = the src_tile-body Morton tiles; level l merges
#     PAIRS of level-(l-1) nodes (branch=2: the finer level granularity
#     gives tighter acceptance shells than octree-style merge-by-8 —
#     measured 280 vs 561 mean far nodes per row at N=65k).
#   * Summaries: com / mass / bounding radius / quadrupole, merged
#     bottom-up by the parallel-axis theorem (exact for com/m/quad,
#     conservative for radius). All columnar (K,) ops.
#   * Acceptance per level: the mass-aware MAC with the amplitude taken
#     from the MASS-WEIGHTED RMS radius (tr S / m)^(3/2) instead of the
#     bounding radius — equal-count Morton merges give elongated boxes
#     whose bounding sphere wildly overestimates the truncation error of
#     a concentrated mass (measured: near sets shrink 275 -> 126 tiles
#     per row at the same tau, coverage identical). The threshold is the
#     ABSOLUTE tau (no sqrt(K) rescale): hierarchical accepted counts
#     are nearly N-independent, so the aggregated (~sqrt(n_acc)) error
#     envelope already is.
#   * Chain: walking each root-to-leaf path, the topmost node that
#     passes the MAC is evaluated; everything below an accepted node is
#     excluded; leaves with no accepted ancestor fall to the near list.
#       reach_top = all;  reach_l = repeat(reach_{l+1} & open_{l+1})
#       eval_l   = reach_l & ~open_l          (l > 0)
#       eval_0   = reach_0 & ~near_landed     (graceful near overflow:
#                                              dropped leaves are still
#                                              covered as multipoles)
#     Every (target row, leaf) pair is covered EXACTLY once
#     (tests/test_treecode_hier.py asserts the partition).
#   * Far lists: per-target compacted chunks of FAR_ENTRIES global node
#     ids (all levels share one summary array), ranked by monopole
#     strength m/d^2 so capacity overflow sheds the weakest
#     contributors; sentinel entries fetch an all-zero summary row and
#     contribute exactly nothing.
#   * Evaluation (_far_field_hier_cols): on the GPU a Pallas (Triton)
#     kernel with the near kernel's skeleton — one program per target
#     block walks its row's far-list slice, FAR_GROUP node summaries per
#     loop step; elsewhere the plain XLA form (per chunk, a gather of
#     FAR_ENTRIES summaries and a reduction over them, then a
#     fixed-order per-row sum).
#
# The reference has no tree at all; `kernel.cu:73` is cited as the perf
# target only.
HIER_BRANCH = 2
DEFAULT_HIER_TAU = 0.01   # hier MAC tolerance (own scale: the (d-r)^5
                          # convergence-aware denominator shifts the
                          # score magnitudes; calibrated frontier in
                          # docs/acceptance.md)
FAR_ENTRIES = 64          # far-list node entries per work-list chunk
                          # (an algorithm default, not yet tuned on the
                          # GPU)
HIER_MIN_NODES = 16       # coarsest level keeps at least this many nodes
DEFAULT_HIER_TILE = 128   # target-row granularity of the hierarchical
                          # path: near-work is FLAT from 32 to 128 (the
                          # per-body-union acceptance makes adjacent
                          # tiles' open sets nearly identical; measured
                          # 10.62M near-work units at both), and 128-body
                          # rows give each far chunk 4x the work per
                          # fetched node summary.


def _level_plan(k_s: int, branch: int = HIER_BRANCH,
                min_nodes: int = HIER_MIN_NODES) -> tuple[int, ...]:
    """Node counts per level, finest first. Always includes level 0;
    degenerates to (k_s,) when K_s is small or indivisible (the far list
    then holds level-0 complements only — same coverage as the
    single-level path, just compacted)."""
    ks = [k_s]
    while ks[-1] % branch == 0 and ks[-1] // branch >= min_nodes:
        ks.append(ks[-1] // branch)
    return tuple(ks)


def _level_summaries(xc, yc, zc, mass, src_tile: int, plan, branch: int):
    """Columnar multipole summaries for every level of the hierarchy.

    Returns a list (finest first) of tuples
    ``(cx, cy, cz, m_tot, radius, rms2, (qxx, qyy, qzz, qxy, qxz, qyz))``
    of (K_l,) columns. ``rms2`` is the mass-weighted mean square radius
    tr(S)/m (the MAC amplitude scale); ``radius`` is the conservative
    bounding-sphere radius over massive bodies. com and quad merge
    EXACTLY via the parallel-axis theorem; radius merges conservatively
    as max(child_dist + child_radius). Massless nodes are inert
    (m = radius = quad = 0).
    """
    k0 = plan[0]
    x = xc.reshape(k0, src_tile)
    y = yc.reshape(k0, src_tile)
    z = zc.reshape(k0, src_tile)
    m = mass.reshape(k0, src_tile)

    def finish(m_tot, cx, cy, cz, radius, qxx, qyy, qzz, qxy, qxz, qyz):
        rms2 = (qxx + qyy + qzz) / jnp.maximum(m_tot, _TINY)
        return (cx, cy, cz, m_tot, radius, rms2,
                (qxx, qyy, qzz, qxy, qxz, qyz))

    m_tot = jnp.sum(m, axis=1)
    inv = 1.0 / jnp.maximum(m_tot, _TINY)
    has = m_tot > 0
    cx = jnp.where(has, jnp.sum(m * x, axis=1) * inv, jnp.mean(x, axis=1))
    cy = jnp.where(has, jnp.sum(m * y, axis=1) * inv, jnp.mean(y, axis=1))
    cz = jnp.where(has, jnp.sum(m * z, axis=1) * inv, jnp.mean(z, axis=1))
    dx = x - cx[:, None]
    dy = y - cy[:, None]
    dz = z - cz[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    radius = jnp.sqrt(jnp.max(jnp.where(m > 0, r2, 0.0), axis=1))
    level0 = finish(
        m_tot, cx, cy, cz, radius,
        jnp.sum(m * dx * dx, axis=1), jnp.sum(m * dy * dy, axis=1),
        jnp.sum(m * dz * dz, axis=1), jnp.sum(m * dx * dy, axis=1),
        jnp.sum(m * dx * dz, axis=1), jnp.sum(m * dy * dz, axis=1))
    return _merge_levels(level0, plan, branch)


def _level0_from_summaries(com, m_tot, radius, quad):
    """Level-0 tuple (see :func:`_level_summaries`) from per-tile
    summaries as returned by :func:`tile_summaries_cols` — the staged
    multi-chip path builds level 0 per shard, all_gathers these four
    summary arrays (~44 B per src tile), and merges the coarser levels
    from them with :func:`_merge_levels`; positions never replicate."""
    qxx, qyy, qzz, qxy, qxz, qyz = (quad[:, i] for i in range(6))
    rms2 = (qxx + qyy + qzz) / jnp.maximum(m_tot, _TINY)
    return (com[:, 0], com[:, 1], com[:, 2], m_tot, radius, rms2,
            (qxx, qyy, qzz, qxy, qxz, qyz))


def _merge_levels(level0, plan, branch: int):
    """Branch-``branch`` upward merges of the level tuples (exact com and
    quad via the parallel-axis theorem, conservative radius) — shared by
    the position-based and the summaries-based level-0 constructions so
    both paths produce identical hierarchies."""
    def finish(m_tot, cx, cy, cz, radius, qxx, qyy, qzz, qxy, qxz, qyz):
        rms2 = (qxx + qyy + qzz) / jnp.maximum(m_tot, _TINY)
        return (cx, cy, cz, m_tot, radius, rms2,
                (qxx, qyy, qzz, qxy, qxz, qyz))

    levels = [level0]
    for k in plan[1:]:
        cx, cy, cz, m_tot, radius, _, q = levels[-1]
        qxx, qyy, qzz, qxy, qxz, qyz = q
        part = lambda a: a.reshape(k, branch)
        mc = part(m_tot)
        mp = jnp.sum(mc, axis=1)
        invp = 1.0 / jnp.maximum(mp, _TINY)
        hasp = mp > 0
        cxp = jnp.where(hasp, jnp.sum(mc * part(cx), axis=1) * invp,
                        jnp.mean(part(cx), axis=1))
        cyp = jnp.where(hasp, jnp.sum(mc * part(cy), axis=1) * invp,
                        jnp.mean(part(cy), axis=1))
        czp = jnp.where(hasp, jnp.sum(mc * part(cz), axis=1) * invp,
                        jnp.mean(part(cz), axis=1))
        ddx = part(cx) - cxp[:, None]
        ddy = part(cy) - cyp[:, None]
        ddz = part(cz) - czp[:, None]
        d2 = ddx * ddx + ddy * ddy + ddz * ddz
        radp = jnp.max(
            jnp.where(mc > 0, jnp.sqrt(d2) + part(radius), 0.0), axis=1)
        levels.append(finish(
            mp, cxp, cyp, czp, radp,
            jnp.sum(part(qxx) + mc * ddx * ddx, axis=1),
            jnp.sum(part(qyy) + mc * ddy * ddy, axis=1),
            jnp.sum(part(qzz) + mc * ddz * ddz, axis=1),
            jnp.sum(part(qxy) + mc * ddx * ddy, axis=1),
            jnp.sum(part(qxz) + mc * ddx * ddz, axis=1),
            jnp.sum(part(qyz) + mc * ddy * ddz, axis=1)))
    return levels


def _hier_open_masks(xc, yc, zc, levels, tile: int, src_tile: int, *,
                     mac_tau: float, theta: float, eps2: float, c2: float,
                     row_offset=0, a_med=None,
                     mac_tau0: float | None = None,
                     union_coarse: bool = True):
    """Per-level (opens, min_d) + the level-0 score matrix for near
    ranking (self rows forced +inf).

    ``mac_tau > 0``: open node j for target row i iff

        m_j rms_j^2 r_j / (d_ij - r_j)^5  >  tau * a_med

    with d = per-body-union min distance to the node com (the same
    union test as the single-level path), rms the mass-weighted RMS
    radius and r the bounding radius. Two measured calibration lessons
    (N=32,768 Plummer, exact-vs-quadrupole error on every (row, node)
    pair; docs/acceptance.md):

      * numerator m rms^2 r_max: each third moment is truly bounded by
        the second moment times the max radius, so this bounds the
        octupole coefficient — m rms^3 underestimates it up to 46x for
        mass-skewed nodes, m r^3 overestimates ~10x for centrally
        concentrated ones;
      * denominator (d - r)^5, not d^5: the worst violators all sat at
        d/r in [1.1, 1.7], where the multipole series barely converges
        and EVERY polynomial estimate underestimates by the geometric
        factor 1/(1 - r/d)^k. Measuring distance from the bounding
        sphere's surface makes the tail sound: at matched near-work the
        per-node p99.9 error drops ~4x, and nodes with d <= r are
        structurally never accepted (delta clamps to _TINY -> huge
        score).

    ``mac_tau == 0``: geometric bounding-radius/theta test per level.

    ``mac_tau0 > 0`` (hybrid, the production default): LEVEL 0 instead
    uses the single-level flat path's calibrated criterion —
    ``m r^3 / d^5 > mac_tau0 * sqrt(MAC_REF_KSRC / K_s) * a_med`` —
    so the near/far boundary matches the flat path's measured
    cost/error optimum (the octupole-bound (d-r)^5 guard is ~35%
    stricter there at 65k: 237 vs 175 near tiles/row at matched p99 —
    it was calibrated against COARSE-node blowups, but level-0 Morton
    tiles are small enough that the flat criterion's loose tail is
    already in the 6e-4 class). Coarser levels keep the guarded
    octupole score: that is where barely-convergent acceptance
    actually blows up.

    At EVERY level, a node whose body range overlaps the target row is
    forced open (score +inf) by the static index test — containment is
    a property of the Morton layout, not geometry. This is load-bearing:
    a light, spatially wide ancestor (halo) that contains the target can
    have a tiny MAC score (small m, min-body-to-com distance ~ its rms
    radius), and accepting it evaluates the target's OWN neighbourhood —
    target included — as a point multipole. Measured before the guard at
    N=32,768/tau=2e-4: 84/1024 target rows had an accepted
    self-containing ancestor and the far-field p99 was 5.0e-3; the
    guard removes the entire tail (see docs/acceptance.md).
    """
    cx0, cy0, cz0, m0, _, _, _ = levels[0]
    com0 = jnp.stack([cx0, cy0, cz0], axis=1)
    if mac_tau > 0 and a_med is None:
        # a_med defaults to the median over the rows in xc; the sharded
        # path passes the GLOBAL population's median instead so every
        # chip uses the identical acceptance threshold.
        a_med = jnp.maximum(
            _median_monopole_acc(xc, yc, zc, com0, m0, eps2=eps2, c2=c2),
            _TINY)
    opens, minds = [], []
    k_t = xc.shape[0] // tile
    # ``union_coarse`` (default): per-body union distances at EVERY
    # level. The alternative conservative tile bound d(com_t, com_s) -
    # r_t collapses for wide halo target rows (r_t up to ~60x the
    # median at N=262k): min_d <= 0 against every node, the whole tree
    # opens to the leaves, and those rows evaluate ~K_src leaves
    # individually. Measured census at N=262k (docs/acceptance.md,
    # round-3 union table): union everywhere cuts mean far evals
    # 1546 -> 1145/row (-26%) and the worst row 4062 -> 1644 (-60%),
    # at ~2x the build's distance work (the coarse levels sum to
    # ~K_src nodes) -- a net win because the far kernel is the
    # per-step cost while the build amortizes over
    # tree_rebuild_every. Distances can only get MORE accurate
    # (the bound under-estimates), so acceptance stays sound.
    tx = xc.reshape(k_t, tile)
    ty = yc.reshape(k_t, tile)
    tz = zc.reshape(k_t, tile)
    tcx = jnp.mean(tx, axis=1)
    tcy = jnp.mean(ty, axis=1)
    tcz = jnp.mean(tz, axis=1)
    trad = jnp.sqrt(jnp.max(
        (tx - tcx[:, None]) ** 2 + (ty - tcy[:, None]) ** 2
        + (tz - tcz[:, None]) ** 2, axis=1))
    for lvl, (cx, cy, cz, m, radius, rms2, _) in enumerate(levels):
        com = com0 if lvl == 0 else jnp.stack([cx, cy, cz], axis=1)
        if lvl == 0 or union_coarse:
            min_d = jnp.maximum(_min_tile_dist(xc, yc, zc, com, tile),
                                _TINY)
        else:
            dcx = cx[None, :] - tcx[:, None]
            dcy = cy[None, :] - tcy[:, None]
            dcz = cz[None, :] - tcz[:, None]
            dcom = jnp.sqrt(dcx * dcx + dcy * dcy + dcz * dcz)
            min_d = jnp.maximum(dcom - trad[:, None], _TINY)
        if mac_tau > 0 and lvl == 0 and mac_tau0:
            d5 = jnp.square(jnp.square(min_d)) * min_d
            score = (m * radius * radius * radius)[None, :] / d5 / a_med
            thresh = mac_tau0 * math.sqrt(MAC_REF_KSRC / m.shape[0])
        elif mac_tau > 0:
            amp = m * rms2 * radius
            delta = jnp.maximum(min_d - radius[None, :], _TINY)
            d5 = jnp.square(jnp.square(delta)) * delta
            score = amp[None, :] / d5 / a_med
            thresh = mac_tau
        else:
            score = radius[None, :] / min_d
            thresh = theta
        k_l = score.shape[1]
        # bodies per level-lvl node, from the GLOBAL level-0 node count
        # (xc may be a local row shard on a future sharded-hier path)
        node_bodies = levels[0][0].shape[0] * src_tile // k_l
        score = jnp.where(
            _self_overlap(k_t, k_l, tile, node_bodies, row_offset),
            jnp.inf, score)
        if lvl == 0:
            score0, thresh0 = score, thresh
        opens.append(score > thresh)
        minds.append(min_d)
    return opens, minds, score0, thresh0


def _chain_evals(opens, branch: int):
    """(evals per level, reach_0) from the open masks — the topmost
    passing node on each root-to-leaf path is evaluated; leaves with no
    passing ancestor reach level 0 (near candidates)."""
    n_levels = len(opens)
    reach = jnp.ones(opens[-1].shape, bool)
    evals = [None] * n_levels
    for lvl in range(n_levels - 1, -1, -1):
        evals[lvl] = jnp.logical_and(reach, jnp.logical_not(opens[lvl]))
        if lvl:
            reach = jnp.repeat(jnp.logical_and(reach, opens[lvl]),
                               branch, axis=1)
    return evals, reach


def _hier_static(n, tile, src_tile, theta, max_near, vip_tiles, far_max,
                 branch):
    k_t, k_s, entries, max_near, vip_src = _flat_static(
        n, tile, src_tile, theta, max_near, vip_tiles)
    if k_s < FAR_ENTRIES:
        # A smaller K would make far_max // FAR_ENTRIES zero chunks per
        # row and silently drop the whole far field.
        raise ValueError(
            f"hierarchical treecode needs K_src >= {FAR_ENTRIES} "
            f"(N >= {FAR_ENTRIES * src_tile}); use the flat path")
    plan = _level_plan(k_s, branch)
    k_total = sum(plan)
    far_max = max(-(-far_max // FAR_ENTRIES) * FAR_ENTRIES, FAR_ENTRIES)
    far_max = min(far_max, (k_total // FAR_ENTRIES) * FAR_ENTRIES)
    return k_t, k_s, entries, max_near, vip_src, plan, k_total, far_max


def build_tree_hier_cols(
    xc, yc, zc, mass,
    *,
    tile: int = DEFAULT_HIER_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    slack: int = DEFAULT_NEAR_SLACK,
    flat_cap: int,
    far_max: int,
    far_cap: int,
    branch: int = HIER_BRANCH,
    mac_tau: float = DEFAULT_HIER_TAU,
    mac_tau0: float | None = None,
    eps2: float = 1e-6,
    compensate: float = 0.1,
    union_coarse: bool = True,
):
    """Hierarchical acceptance structures (the production path).

    Returns ``(flat_src, chunk_tgt, far_src, far_tgt, is_vip_body)``:
    the near work lists exactly as :func:`build_tree_flat_cols` plus
    compacted multi-level FAR lists (``far_cap`` node-id slots in chunks
    of ``FAR_ENTRIES``, per-target contiguous, tagged by ``far_tgt``).
    Together the lists cover every (target row, source leaf) pair exactly
    once: near exact, everything else at the topmost MAC-accepted
    ancestor. Size the capacities with :func:`suggest_hier`.
    """
    n = xc.shape[0]
    (k_t, k_s, entries, max_near, vip_src, plan, k_total,
     far_max) = _hier_static(n, tile, src_tile, theta, max_near, vip_tiles,
                             far_max, branch)
    f32 = jnp.float32
    xc = xc.astype(f32)
    yc = yc.astype(f32)
    zc = zc.astype(f32)
    mass = mass.astype(f32)
    c2 = compensate * compensate
    if vip_src:
        mass_tree, _, is_vip_body = _vip_split(xc, yc, zc, mass, src_tile,
                                               vip_src)
    else:
        is_vip_body = jnp.zeros((n,), bool)
        mass_tree = mass
    levels = _level_summaries(xc, yc, zc, mass_tree, src_tile, plan, branch)
    opens, minds, score0, thresh0 = _hier_open_masks(
        xc, yc, zc, levels, tile, src_tile, mac_tau=mac_tau, theta=theta,
        eps2=eps2, c2=c2, mac_tau0=mac_tau0, union_coarse=union_coarse)
    evals, reach0 = _chain_evals(opens, branch)

    # Near: only leaves the chain actually reaches may be computed
    # exactly (a leaf under an accepted ancestor is already covered —
    # score -1 ranks it out AND _compact_open_lists sentinels it).
    score0 = jnp.where(reach0, score0, -1.0)
    flat_src, chunk_tgt, near_mask = _compact_open_lists(
        score0, thresh0, slack, flat_cap, entries, max_near)

    # Far: level-0 complements of the LANDED near coverage (graceful
    # near overflow: a dropped leaf is covered as a multipole), plus the
    # chain evals at every coarser level; ranked by monopole strength so
    # far overflow sheds the weakest contributors (and massless nodes).
    evals[0] = jnp.logical_and(reach0, jnp.logical_not(near_mask))
    key = jnp.concatenate(
        [jnp.where(ev, lv[3][None, :] / (md * md), -1.0)
         for ev, lv, md in zip(evals, levels, minds)], axis=1)
    far_src, far_tgt, _ = _compact_open_lists(
        key, 0.0, 0, far_cap, FAR_ENTRIES, far_max)
    return flat_src, chunk_tgt, far_src, far_tgt, is_vip_body


def _summary_panel(levels):
    """(K_total + 1, 11) node summaries of every level for the far field.

    Columns: cx cy cz m qxx qyy qzz qxy qxz qyz tr; the final all-zero
    row is the sentinel (contributes exactly nothing).
    """
    cat = lambda i: jnp.concatenate([lv[i] for lv in levels])
    qs = [jnp.concatenate([lv[6][i] for lv in levels]) for i in range(6)]
    tr = qs[0] + qs[1] + qs[2]
    summ = jnp.stack([cat(0), cat(1), cat(2), cat(3)] + qs + [tr], axis=1)
    return jnp.pad(summ, ((0, 1), (0, 0)))


FAR_GROUP = 16            # far-kernel node entries per loop step


def _far_hier_kernel(first_ref, count_ref, fsrc_ref, xt_ref, yt_ref, zt_ref,
                     *refs, c2: float, eps2: float, gc: float,
                     blocks_per_row: int):
    """Compacted multi-level far field for the GPU (Pallas, Triton): one
    program per block of a target row, looping over that row's slice of
    the far list ``FAR_GROUP`` node ids at a time, each group's summaries
    gathered from the summary columns; the monopole + quadrupole
    expansion of :func:`_far_field_cols`, summed over the group into
    registers. Each program writes only its own rows (no atomics)."""
    summ = refs[:11]          # cx cy cz m qxx qyy qzz qxy qxz qyz tr
    ax_ref, ay_ref, az_ref = refs[11:]
    row = pl.program_id(0) // blocks_per_row
    g0 = first_ref[row] * (FAR_ENTRIES // FAR_GROUP)
    g1 = g0 + count_ref[row] * (FAR_ENTRIES // FAR_GROUP)
    xi = xt_ref[...][None, :]                           # (1, TB)
    yi = yt_ref[...][None, :]
    zi = zt_ref[...][None, :]
    c4 = c2 * c2
    c6 = c4 * c2

    def body(g, acc):
        sx, sy, sz = acc
        idx = fsrc_ref[pl.ds(pl.multiple_of(g * FAR_GROUP, FAR_GROUP),
                             FAR_GROUP)]
        col = [r[idx][:, None] for r in summ]           # (G, 1) each
        dx = col[0] - xi                                # (G, TB)
        dy = col[1] - yi
        dz = col[2] - zi
        u2 = 1.0 / (c2 * (dx * dx + dy * dy + dz * dz) + eps2)
        u = jnp.sqrt(u2)
        u3 = u2 * u
        u5 = u3 * u2
        sdx = col[4] * dx + col[7] * dy + col[8] * dz
        sdy = col[7] * dx + col[5] * dy + col[9] * dz
        sdz = col[8] * dx + col[9] * dy + col[6] * dz
        q = dx * sdx + dy * sdy + dz * sdz
        wd = (col[3] * c2 * u3 - 1.5 * c4 * col[10] * u5
              + 7.5 * c6 * q * u5 * u2)
        ws = -3.0 * c4 * u5
        return (sx + jnp.sum(wd * dx + ws * sdx, axis=0),
                sy + jnp.sum(wd * dy + ws * sdy, axis=0),
                sz + jnp.sum(wd * dz + ws * sdz, axis=0))

    zero = jnp.zeros((xi.shape[1],), jnp.float32)
    sx, sy, sz = lax.fori_loop(g0, g1, body, (zero, zero, zero))
    ax_ref[...] = gc * sx
    ay_ref[...] = gc * sy
    az_ref[...] = gc * sz


FAR_WARPS = 4
FAR_STAGES = 2


def _far_field_hier_kernel(xc, yc, zc, summ, far_src, far_tgt, *,
                           eps2: float, c2: float, G: float, tile: int,
                           interpret: bool = False):
    """Kernel form of :func:`_far_field_hier_cols` (same arguments)."""
    n = xc.shape[0]
    rows = _pow2_tile(tile, NEAR_ROWS)
    first, count = _row_ranges(far_tgt, n // tile)
    blk = pl.BlockSpec((rows,), lambda p: (p,))
    whole = pl.no_block_spec
    out = jax.ShapeDtypeStruct((n,), jnp.float32)
    return pl.pallas_call(
        functools.partial(_far_hier_kernel, c2=float(c2), eps2=float(eps2),
                          gc=float(G * math.sqrt(c2)),
                          blocks_per_row=tile // rows),
        grid=(n // rows,),
        in_specs=[whole, whole, whole, blk, blk, blk] + [whole] * 11,
        out_specs=[blk, blk, blk],
        out_shape=[out, out, out],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=FAR_WARPS,
                                             num_stages=FAR_STAGES),
        interpret=interpret,
        name="nbody_far_hier",
    )(first, count, far_src.astype(jnp.int32), xc, yc, zc,
      *(summ[:, k] for k in range(11)))


def _far_field_hier_cols(xc, yc, zc, summ, far_src, far_tgt, *,
                         eps2: float, c2: float, G: float, tile: int,
                         max_chunks: int, plan: ExecutionPlan):
    """Compacted multi-level far field, (ax, ay, az) columns of the
    ``tile``-body target rows in ``xc``: each far chunk is
    ``FAR_ENTRIES`` node summaries (rows of ``summ``,
    :func:`_summary_panel`) against one target row. ``max_chunks`` bounds
    any row's chunk count (``far_max / FAR_ENTRIES``). The plan picks the
    GPU kernel or the plain XLA form."""
    if plan.far_kernel:
        return _far_field_hier_kernel(
            xc, yc, zc, summ, far_src, far_tgt, eps2=eps2, c2=c2, G=G,
            tile=tile, interpret=plan.interpret)
    return _far_field_hier_xla(
        xc, yc, zc, summ, far_src, far_tgt, eps2=eps2, c2=c2, G=G,
        tile=tile, max_chunks=max_chunks)


def _far_field_hier_xla(xc, yc, zc, summ, far_src, far_tgt, *,
                        eps2: float, c2: float, G: float, tile: int,
                        max_chunks: int, block: int | None = None):
    """Plain XLA form of :func:`_far_field_hier_cols`: the monopole +
    quadrupole of the softened kernel (coefficients as in
    :func:`_far_field_cols`) per chunk, in ``block``-chunk steps of a loop
    (one XLA reduction fusion each), then the deterministic per-row
    reduction :func:`_row_sums`.
    """
    n = xc.shape[0]
    k_t = n // tile
    n_chunks = far_tgt.shape[0]
    k_sent = summ.shape[0] - 1
    c = math.sqrt(c2)
    c4 = c2 * c2
    c6 = c4 * c2
    gc = G * c
    tx, ty, tz = (jnp.concatenate([a, jnp.zeros((tile,), a.dtype)])
                  .reshape(k_t + 1, tile) for a in (xc, yc, zc))
    b = block or max(1, _PAIR_BUDGET // (4 * tile * FAR_ENTRIES))
    b = min(b, n_chunks)
    pad = -n_chunks % b
    ft = jnp.concatenate([far_tgt, jnp.full((pad,), k_t, jnp.int32)])
    fs = jnp.concatenate([far_src, jnp.full((pad * FAR_ENTRIES,), k_sent,
                                            jnp.int32)])

    def per_block(args):
        ft_b, fs_b = args                               # (B,), (B*E,)
        s = summ[fs_b.reshape(b, FAR_ENTRIES)]          # (B, E, 11)
        col = lambda i: s[:, :, i][:, :, None]          # (B, E, 1)
        dx = col(0) - tx[ft_b][:, None, :]              # (B, E, T)
        dy = col(1) - ty[ft_b][:, None, :]
        dz = col(2) - tz[ft_b][:, None, :]
        u2 = 1.0 / (c2 * (dx * dx + dy * dy + dz * dz) + eps2)
        u = jnp.sqrt(u2)
        u3 = u2 * u
        u5 = u3 * u2
        u7 = u5 * u2
        sdx = col(4) * dx + col(7) * dy + col(8) * dz
        sdy = col(7) * dx + col(5) * dy + col(9) * dz
        sdz = col(8) * dx + col(9) * dy + col(6) * dz
        q = dx * sdx + dy * sdy + dz * sdz
        wd = (col(3) * c2 * u3 - 1.5 * c4 * col(10) * u5
              + 7.5 * c6 * q * u7)
        ws = -3.0 * c4 * u5
        return gc * jnp.stack(
            [jnp.sum(wd * dx + ws * sdx, axis=1),
             jnp.sum(wd * dy + ws * sdy, axis=1),
             jnp.sum(wd * dz + ws * sdz, axis=1)], axis=2)  # (B, T, 3)

    vals = lax.map(per_block, (ft.reshape(-1, b),
                               fs.reshape(-1, b * FAR_ENTRIES)))
    vals = vals.reshape(-1, tile, 3)[:n_chunks]
    acc = _row_sums(vals, far_tgt, k_t, max_chunks).reshape(n, 3)
    return acc[:, 0], acc[:, 1], acc[:, 2]


def treecode_acc_hier_cols(
    xc, yc, zc, mass, aux_hier,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_HIER_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    far_max: int = 0,
    branch: int = HIER_BRANCH,
    plan: ExecutionPlan | None = None,
):
    """Columnar hierarchical treecode acceleration: (N,) coordinate
    columns in, (ax, ay, az) out.

    ``aux_hier`` comes from :func:`build_tree_hier_cols` with the same
    static knobs. Node summaries are recomputed LIVE from the current
    positions every call (cheap columnar reductions); only the
    acceptance lists are cached, exactly like the single-level flat
    path. Physics: exact near field + monopole/quadrupole far field at
    the topmost accepted ancestor + exact both-ways VIP sweep.
    """
    plan = plan or execution_plan()
    n = xc.shape[0]
    (k_t, k_s, entries, max_near, vip_src, levels_plan, k_total,
     far_max) = _hier_static(n, tile, src_tile, theta, max_near, vip_tiles,
                             far_max, branch)
    c2 = compensate * compensate
    gc3 = G * c2 * compensate
    f32 = jnp.float32
    xc, yc, zc, mass = (a.astype(f32) for a in (xc, yc, zc, mass))

    flat_src, chunk_tgt, far_src, far_tgt, is_vip_body = aux_hier
    mass_tree = jnp.where(is_vip_body, 0.0, mass) if vip_src else mass
    src = _source_cols(xc, yc, zc, mass_tree * f32(gc3), src_tile)
    nx, ny, nz = _near_field_flat_cols(
        xc, yc, zc, src, flat_src, chunk_tgt, eps2=eps2, c2=c2, tile=tile,
        src_tile=src_tile, max_chunks=max_near // entries, plan=plan)
    levels = _level_summaries(xc, yc, zc, mass_tree, src_tile, levels_plan,
                              branch)
    fx, fy, fz = _far_field_hier_cols(
        xc, yc, zc, _summary_panel(levels), far_src, far_tgt, eps2=eps2,
        c2=c2, G=G, tile=tile, max_chunks=far_max // FAR_ENTRIES, plan=plan)
    ax, ay, az = nx + fx, ny + fy, nz + fz
    if vip_src:
        vip_tile_idx, _ = _vip_body_idx(is_vip_body, k_s, src_tile, vip_src)
        ax, ay, az = _apply_vip(ax, ay, az, xc, yc, zc, mass, vip_tile_idx,
                                k_s=k_s, src_tile=src_tile, gc3=gc3,
                                eps2=eps2, c2=c2, plan=plan)
    return ax, ay, az


def build_hier_local(xl, yl, zl, xg, yg, zg, mass_g, *, tile: int,
                     src_tile: int, theta: float, max_near: int,
                     vip_tiles: int, slack: int, flat_cap: int,
                     far_max: int, far_cap: int, row_offset,
                     branch: int = HIER_BRANCH,
                     mac_tau: float = DEFAULT_HIER_TAU,
                     mac_tau0: float | None = None,
                     eps2: float = 1e-6, compensate: float = 0.1,
                     union_coarse: bool = True):
    """Hierarchical acceptance for LOCAL target rows against GLOBAL
    sources (inside shard_map — the multi-level analogue of
    :func:`build_flat_local`). Every chip computes the identical global
    VIP split and level summaries from replicated columns, then compacts
    near AND far work lists for its own contiguous row block only.
    ``flat_cap``/``far_cap`` are PER-CHIP capacities.

    Returns ``(flat_src, chunk_tgt, far_src, far_tgt, is_vip_g)``.
    """
    n_g = xg.shape[0]
    (k_t, k_s, entries, max_near, vip_src, plan, k_total,
     far_max) = _hier_static(n_g, tile, src_tile, theta, max_near,
                             vip_tiles, far_max, branch)
    f32 = jnp.float32
    xl, yl, zl = xl.astype(f32), yl.astype(f32), zl.astype(f32)
    c2 = compensate * compensate
    if vip_src:
        mass_tree_g, _, is_vip_g = _vip_split(xg, yg, zg, mass_g,
                                              src_tile, vip_src)
    else:
        is_vip_g = jnp.zeros((n_g,), bool)
        mass_tree_g = mass_g
    levels = _level_summaries(xg.astype(f32), yg.astype(f32),
                              zg.astype(f32), mass_tree_g.astype(f32),
                              src_tile, plan, branch)
    # Global a_med so every chip applies the identical threshold (the
    # local-rows median would differ per chip and split the acceptance).
    cx0, cy0, cz0, m0 = levels[0][:4]
    a_med = None
    if mac_tau > 0:
        a_med = jnp.maximum(
            _median_monopole_acc(
                xg.astype(f32), yg.astype(f32), zg.astype(f32),
                jnp.stack([cx0, cy0, cz0], axis=1), m0,
                eps2=eps2, c2=c2),
            _TINY)
    opens, minds, score0, thresh0 = _hier_open_masks(
        xl, yl, zl, levels, tile, src_tile, mac_tau=mac_tau, theta=theta,
        eps2=eps2, c2=c2, row_offset=row_offset, a_med=a_med,
        mac_tau0=mac_tau0, union_coarse=union_coarse)
    evals, reach0 = _chain_evals(opens, branch)
    score0 = jnp.where(reach0, score0, -1.0)
    flat_src, chunk_tgt, near_mask = _compact_open_lists(
        score0, thresh0, slack, flat_cap, entries, max_near)
    evals[0] = jnp.logical_and(reach0, jnp.logical_not(near_mask))
    key = jnp.concatenate(
        [jnp.where(ev, lv[3][None, :] / (md * md), -1.0)
         for ev, lv, md in zip(evals, levels, minds)], axis=1)
    far_src, far_tgt, _ = _compact_open_lists(
        key, 0.0, 0, far_cap, FAR_ENTRIES, far_max)
    return flat_src, chunk_tgt, far_src, far_tgt, is_vip_g


def hier_local_acc(xl, yl, zl, ml, xg, yg, zg, mass_g, aux, *, eps2: float,
                   compensate: float, G: float, tile: int, src_tile: int,
                   max_near: int, vip_tiles: int, far_max: int,
                   theta: float = DEFAULT_THETA,
                   branch: int = HIER_BRANCH,
                   plan: ExecutionPlan | None = None):
    """Columnar hierarchical acc of LOCAL rows from replicated GLOBAL
    sources: ``(axl, ayl, azl, react | None, vip_body_idx | None)``
    — the multi-level analogue of :func:`flat_local_acc` (same psum
    contract for the VIP reactions; see parallel/tree.py)."""
    plan = plan or execution_plan()
    flat_src, chunk_tgt, far_src, far_tgt, is_vip_g = aux
    n_g = xg.shape[0]
    (_, k_s, entries, max_near, vip_src, levels_plan, k_total,
     far_max) = _hier_static(n_g, tile, src_tile, theta, max_near,
                             vip_tiles, far_max, branch)
    c2 = compensate * compensate
    gc3 = G * c2 * compensate
    f32 = jnp.float32
    mass_tree_g = jnp.where(is_vip_g, 0.0, mass_g) if vip_src else mass_g
    src = _source_cols(xg, yg, zg, mass_tree_g * f32(gc3), src_tile)
    nx, ny, nz = _near_field_flat_cols(
        xl, yl, zl, src, flat_src, chunk_tgt, eps2=eps2, c2=c2, tile=tile,
        src_tile=src_tile, max_chunks=max_near // entries, plan=plan)
    levels = _level_summaries(xg.astype(f32), yg.astype(f32),
                              zg.astype(f32), mass_tree_g, src_tile,
                              levels_plan, branch)
    fx, fy, fz = _far_field_hier_cols(
        xl, yl, zl, _summary_panel(levels), far_src, far_tgt, eps2=eps2,
        c2=c2, G=G, tile=tile, max_chunks=far_max // FAR_ENTRIES, plan=plan)
    ax, ay, az = nx + fx, ny + fy, nz + fz
    if not vip_src:
        return ax, ay, az, None, None
    _, vip_body_idx = _vip_body_idx(is_vip_g, k_s, src_tile, vip_src)
    scaled_all_g = mass_g * f32(gc3)
    action, react = _vip_sweep_cols(
        xl, yl, zl, ml * f32(gc3),
        xg[vip_body_idx], yg[vip_body_idx], zg[vip_body_idx],
        scaled_all_g[vip_body_idx], eps2=eps2, c2=c2, plan=plan)
    return (ax + action[0], ay + action[1], az + action[2], react,
            vip_body_idx)


@functools.partial(
    jax.jit,
    static_argnames=("tile", "src_tile", "theta", "vip_tiles", "branch",
                     "mac_tau", "mac_tau0", "eps2", "compensate",
                     "union_coarse"),
)
def hier_counts(pos, mass, *, tile: int = DEFAULT_HIER_TILE,
                src_tile: int = DEFAULT_SRC_TILE,
                theta: float = DEFAULT_THETA,
                vip_tiles: int = DEFAULT_VIP_TILES,
                branch: int = HIER_BRANCH,
                mac_tau: float = DEFAULT_HIER_TAU,
                mac_tau0: float | None = None,
                eps2: float = 1e-6,
                compensate: float = 0.1,
                union_coarse: bool = True):
    """(near_count (K_t,), far_count (K_t,)) of the hierarchical chain on
    this distribution (uncapped; the capacity planner for
    :func:`build_tree_hier_cols`)."""
    n = pos.shape[0]
    k_s = n // src_tile
    plan = _level_plan(k_s, branch)
    xc, yc, zc = _cols(pos)
    c2 = compensate * compensate
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    mass_tree = mass
    if vip_src:
        mass_tree, _, _ = _vip_split(xc, yc, zc, mass, src_tile, vip_src)
    levels = _level_summaries(xc.astype(jnp.float32), yc.astype(jnp.float32),
                              zc.astype(jnp.float32),
                              mass_tree.astype(jnp.float32), src_tile, plan,
                              branch)
    opens, _, _, _ = _hier_open_masks(
        xc, yc, zc, levels, tile, src_tile, mac_tau=mac_tau, theta=theta,
        eps2=eps2, c2=c2, mac_tau0=mac_tau0, union_coarse=union_coarse)
    evals, reach0 = _chain_evals(opens, branch)
    near = jnp.sum(jnp.logical_and(reach0, opens[0]), axis=1)
    far = sum(jnp.sum(ev, axis=1) for ev in evals)
    return near, far


def suggest_hier(pos, mass, *, tile: int = DEFAULT_HIER_TILE,
                 src_tile: int = DEFAULT_SRC_TILE,
                 theta: float = DEFAULT_THETA,
                 vip_tiles: int = DEFAULT_VIP_TILES,
                 slack: int = DEFAULT_NEAR_SLACK,
                 branch: int = HIER_BRANCH,
                 mac_tau: float = DEFAULT_HIER_TAU,
                 mac_tau0: float | None = None,
                 eps2: float = 1e-6,
                 compensate: float = 0.1,
                 union_coarse: bool = True,
                 margin: float = 1.3,
                 far_margin: float = 1.25) -> dict:
    """Host-side capacity planner for the hierarchical path.

    Returns ``{"max_near", "flat_cap", "far_max", "far_cap"}``.
    ``far_margin`` exceeds the near margin because far overflow sheds
    mass (weakest-first) instead of degrading to multipoles — headroom
    is cheap (sentinel entries skip nothing but fetch zero summaries).
    """
    near, far = hier_counts(
        jnp.asarray(pos), jnp.asarray(mass), tile=tile, src_tile=src_tile,
        theta=theta, vip_tiles=vip_tiles, branch=branch, mac_tau=mac_tau,
        mac_tau0=mac_tau0, eps2=eps2, compensate=compensate,
        union_coarse=union_coarse)
    near = np.asarray(near)
    far = np.asarray(far)
    entries = CHUNK_LANES // src_tile
    k_t = len(near)
    rnd = lambda v, e: ((v + e - 1) // e) * e
    max_near = int(rnd(int(math.ceil(near.max() * margin)), entries))
    v = np.maximum(rnd(near + slack, entries), entries)
    flat_cap = int(rnd(max(int(math.ceil(v.sum() * margin)),
                           k_t * entries), entries))
    far_max = int(rnd(int(math.ceil(far.max() * far_margin)), FAR_ENTRIES))
    w = np.maximum(rnd(far, FAR_ENTRIES), FAR_ENTRIES)
    far_cap = int(rnd(max(int(math.ceil(w.sum() * far_margin)),
                          k_t * FAR_ENTRIES), FAR_ENTRIES))
    return {"max_near": max_near, "flat_cap": flat_cap,
            "far_max": far_max, "far_cap": far_cap}


def suggest_hier_sharded(pos, mass, n_dev: int, *,
                         tile: int = DEFAULT_HIER_TILE,
                         src_tile: int = DEFAULT_SRC_TILE,
                         theta: float = DEFAULT_THETA,
                         vip_tiles: int = DEFAULT_VIP_TILES,
                         slack: int = DEFAULT_NEAR_SLACK,
                         branch: int = HIER_BRANCH,
                         mac_tau: float = DEFAULT_HIER_TAU,
                         mac_tau0: float | None = None,
                         eps2: float = 1e-6,
                         compensate: float = 0.1,
                         union_coarse: bool = True,
                         margin: float = 1.4,
                         far_margin: float = 1.6) -> dict:
    """PER-CHIP capacity planner for the sharded hierarchical path.

    ``max_near``/``far_max`` stay global per-row bounds; ``flat_cap``/
    ``far_cap`` are the worst CHIP BLOCK's demand (core chips' rows open
    more than halo chips') with a drift margin above the single-chip
    planner's, like :func:`suggest_flat_cap_sharded`.
    """
    near, far = hier_counts(
        jnp.asarray(pos), jnp.asarray(mass), tile=tile, src_tile=src_tile,
        theta=theta, vip_tiles=vip_tiles, branch=branch, mac_tau=mac_tau,
        mac_tau0=mac_tau0, eps2=eps2, compensate=compensate,
        union_coarse=union_coarse)
    near = np.asarray(near)
    far = np.asarray(far)
    entries = CHUNK_LANES // src_tile
    k_t = len(near)
    if k_t % n_dev:
        raise ValueError(f"K_t={k_t} not divisible by n_dev={n_dev}")
    rnd = lambda v, e: ((v + e - 1) // e) * e
    max_near = int(rnd(int(math.ceil(near.max() * margin)), entries))
    v = np.maximum(rnd(near + slack, entries), entries)
    per_chip = v.reshape(n_dev, k_t // n_dev).sum(axis=1)
    flat_cap = int(rnd(max(int(math.ceil(per_chip.max() * margin)),
                           (k_t // n_dev) * entries), entries))
    far_max = int(rnd(int(math.ceil(far.max() * far_margin)), FAR_ENTRIES))
    w = np.maximum(rnd(far, FAR_ENTRIES), FAR_ENTRIES)
    per_chip_f = w.reshape(n_dev, k_t // n_dev).sum(axis=1)
    far_cap = int(rnd(max(int(math.ceil(per_chip_f.max() * far_margin)),
                          (k_t // n_dev) * FAR_ENTRIES), FAR_ENTRIES))
    return {"max_near": max_near, "flat_cap": flat_cap,
            "far_max": far_max, "far_cap": far_cap}
