"""All-pairs softened gravity as a Pallas kernel for the GPU (Triton).

The reference's VERSION 1 design (``simple_update_all``,
``kernel.cu:828-884``): a program owns ``tile_i`` target bodies, keeps
them in registers, and streams the source bodies through in
``tile_j``-wide tiles, with the partial sums carried by a loop inside the
program (no cross-program reduction, no atomics: the result is the same
bit for bit from run to run). ``num_stages`` pipelines the source loads.

One kernel serves the exact solver (:func:`pallas_acc`), the ring stage
of the sharded exact solvers (resident block against the visiting block,
``parallel/ring.py``) and both halves of the treecode's VIP sweep. When
the rows are few (the VIP reaction) the columns split across programs
and the partial sums are added afterwards, in a fixed order.

Pair math per (i, j), float32 throughout, no matmul anywhere:

    d = p_j - p_i;  w = m_j G c^3 rsqrt(c^2 |d|^2 + eps2)^3;  a_i += w d

(subtract first, scale the squared distance after: ``c`` = 0.1 is not a
power of two, so pre-scaling coordinates would round them before the
cancellation). Masses are pre-multiplied by G c^3 outside the kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

DEFAULT_TILE_I = 64
DEFAULT_TILE_J = 64
NUM_WARPS = 4
NUM_STAGES = 3


MIN_PROGRAMS = 512       # ~4 programs per SM of an H100 (132 SMs)


def _pair_kernel(xi_ref, yi_ref, zi_ref, xj_ref, yj_ref, zj_ref, mj_ref,
                 ax_ref, ay_ref, az_ref, *, c2: float, eps2: float,
                 tile_j: int, n_tiles: int):
    xi = xi_ref[...][:, None]                       # (TI, 1)
    yi = yi_ref[...][:, None]
    zi = zi_ref[...][:, None]

    def body(j, acc):
        sx, sy, sz = acc
        o = pl.multiple_of(j * tile_j, tile_j)
        dx = xj_ref[pl.ds(o, tile_j)][None, :] - xi     # (TI, TJ)
        dy = yj_ref[pl.ds(o, tile_j)][None, :] - yi
        dz = zj_ref[pl.ds(o, tile_j)][None, :] - zi
        inv = lax.rsqrt((dx * dx + dy * dy + dz * dz) * c2 + eps2)
        w = mj_ref[pl.ds(o, tile_j)][None, :] * (inv * inv * inv)
        return sx + w * dx, sy + w * dy, sz + w * dz

    j0 = pl.program_id(1) * n_tiles
    zero = jnp.zeros((xi.shape[0], tile_j), jnp.float32)
    sx, sy, sz = lax.fori_loop(j0, j0 + n_tiles, body, (zero, zero, zero))
    ax_ref[...] = jnp.sum(sx, axis=1)
    ay_ref[...] = jnp.sum(sy, axis=1)
    az_ref[...] = jnp.sum(sz, axis=1)


def _column_splits(row_blocks: int, col_tiles: int) -> int:
    """Power-of-two number of column ranges per row block, so that a few
    row blocks (the VIP reaction: 4,096 rows against every body) still
    give the card enough programs."""
    splits = 1
    while row_blocks * splits < MIN_PROGRAMS and col_tiles % (2 * splits) == 0:
        splits *= 2
    return splits


def pair_block_cols(xi, yi, zi, xj, yj, zj, scaled_mj, *, eps2: float,
                    c2: float, tile_i: int = DEFAULT_TILE_I,
                    tile_j: int = DEFAULT_TILE_J, splits: int | None = None,
                    interpret: bool = False):
    """Columnar core: (ax, ay, az) of the row bodies due to the column
    bodies, masses already scaled by G c^3. Rows must divide ``tile_i``
    and columns ``tile_j`` (both powers of two).

    With few row blocks the columns are cut into ``splits`` ranges
    (default: :func:`_column_splits`), one program each; their partial
    sums are added in XLA in a fixed order (still no atomics)."""
    ni, nj = xi.shape[0], xj.shape[0]
    if ni % tile_i or nj % tile_j:
        raise ValueError(
            f"pair kernel: Ni={ni} must be a multiple of tile_i={tile_i} "
            f"and Nj={nj} of tile_j={tile_j}; pad the state first")
    if splits is None:
        splits = _column_splits(ni // tile_i, nj // tile_j)
    f32 = jnp.float32
    row = pl.BlockSpec((tile_i,), lambda i, s: (i,))
    part = pl.BlockSpec((None, tile_i), lambda i, s: (s, i))
    whole = pl.no_block_spec
    out = jax.ShapeDtypeStruct((splits, ni), f32)
    parts = pl.pallas_call(
        functools.partial(_pair_kernel, c2=float(c2), eps2=float(eps2),
                          tile_j=tile_j, n_tiles=nj // tile_j // splits),
        grid=(ni // tile_i, splits),
        in_specs=[row, row, row, whole, whole, whole, whole],
        out_specs=[part, part, part],
        out_shape=[out, out, out],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="nbody_pair",
    )(*(a.astype(f32) for a in (xi, yi, zi, xj, yj, zj, scaled_mj)))
    return tuple(jnp.sum(p, axis=0) for p in parts)


@functools.partial(
    jax.jit,
    static_argnames=("eps2", "compensate", "G", "tile_i", "tile_j",
                     "interpret"),
)
def pallas_block_acc(
    pos_i: jax.Array,
    pos_j: jax.Array,
    mass_j: jax.Array,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile_i: int = DEFAULT_TILE_I,
    tile_j: int = DEFAULT_TILE_J,
    interpret: bool = False,
) -> jax.Array:
    """acc (Ni, 3) of the row bodies due to every column body.

    ``pos_i`` and ``pos_j`` may be the same array (the all-pairs solve,
    :func:`pallas_acc`) or different blocks (a ring stage: resident
    bodies against the visiting block).
    """
    c2 = compensate * compensate
    scaled = mass_j.astype(jnp.float32) * jnp.float32(G * c2 * compensate)
    ax, ay, az = pair_block_cols(
        pos_i[:, 0], pos_i[:, 1], pos_i[:, 2],
        pos_j[:, 0], pos_j[:, 1], pos_j[:, 2], scaled,
        eps2=eps2, c2=c2, tile_i=tile_i, tile_j=tile_j, interpret=interpret)
    return jnp.stack([ax, ay, az], axis=1)


def pallas_acc(pos: jax.Array, mass: jax.Array, **kw) -> jax.Array:
    """acc (N, 3) from pos (N, 3) and mass (N,) — all-pairs block solve."""
    return pallas_block_acc(pos, pos, mass, **kw)
