"""Softened pairwise gravity — pure-XLA solver backends.

All solvers compute the same physics as the reference's pair function
(``cal_single_acclerate_without_mass_new``, ``kernel.cu:665-692``):

    d      = c * (p_j - p_i)                 # compensate pre-scale, c = 0.1
    r2     = |d|^2 + eps2                    # EPSILON = 1e-6 (kernel.cu:66)
    acc_i += sum_j  m_j * d * rsqrt(r2)^3 * c^2

which (folding the scales) equals a Plummer-softened direct sum with
effective softening ``eps2 / c^2``:

    acc_i = G * sum_j  m_j * (p_j - p_i) * (|p_j - p_i|^2 + eps2/c^2)^(-3/2)

Self-pairs contribute exactly zero (d = 0 with eps2 > 0), so none of the
solvers mask the diagonal — same trick the reference relies on. Zero-mass
padding bodies contribute nothing to real bodies.

Three backends, all returning ``acc (N, 3)`` float32:

- :func:`direct_acc`   — one-shot broadcast; O(N^2) memory pressure, the
  ground-truth oracle (role of the reference's single-thread VERSION 2,
  ``kernel.cu:891-923``).
- :func:`blocked_acc`  — ``lax.map`` over row blocks; O(B*N) live memory, the
  pure-XLA production path (role of VERSION 1, ``kernel.cu:828-884``).
- :func:`mxu_acc`      — matmul formulation: the force accumulation as one
  ``W @ [P, 1]`` matrix product per row block (float32,
  ``Precision.HIGHEST``: a TF32 product would wreck the cancellation between
  its two terms), validated against direct_acc in tests.

No other solver here uses a matrix product: every reduction over pairs is
an elementwise product followed by a sum, exact float32 on every platform.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

from n_body_problem_tpu.utils.padding import round_up

__all__ = ["direct_acc", "blocked_acc", "mxu_acc", "pair_accel_tile"]


def _coef(mass_j: jax.Array, r2: jax.Array, eps2: float, c2: float, Gc3: float) -> jax.Array:
    """Per-pair scalar weight w_ij = G * m_j * c^3 * rsqrt(c^2 r2 + eps2)^3.

    ``acc_i = sum_j w_ij * (p_j - p_i)``. Elementwise; ``rsqrt``
    mirrors the reference's ``rsqrtf`` (kernel.cu:682).
    """
    inv = lax.rsqrt(c2 * r2 + eps2)
    return (Gc3 * mass_j) * (inv * inv * inv)


def pair_accel_tile(
    pos_i: jax.Array,   # (I, 3)
    pos_j: jax.Array,   # (J, 3)
    mass_j: jax.Array,  # (J,)
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> jax.Array:
    """Acceleration of each body in tile I due to every body in tile J.

    The shared building block for the blocked solver and the multi-device
    ring (one visiting tile per ring step). Componentwise broadcast
    formulation, (I, 1) - (1, J) per coordinate; the reductions are sums of
    elementwise products, never a matrix product.
    """
    c2 = compensate * compensate
    Gc3 = G * c2 * compensate
    dx = pos_j[None, :, 0] - pos_i[:, 0:1]             # (I, J)
    dy = pos_j[None, :, 1] - pos_i[:, 1:2]
    dz = pos_j[None, :, 2] - pos_i[:, 2:3]
    w = _coef(mass_j[None, :], dx * dx + dy * dy + dz * dz, eps2, c2, Gc3)
    return jnp.stack([jnp.sum(w * dx, axis=1), jnp.sum(w * dy, axis=1),
                      jnp.sum(w * dz, axis=1)], axis=1)


def pair_accel_tile_symmetric(
    pos_i: jax.Array,   # (I, 3)
    mass_i: jax.Array,  # (I,)
    pos_j: jax.Array,   # (J, 3)
    mass_j: jax.Array,  # (J,)
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> tuple[jax.Array, jax.Array]:
    """Both halves of a block-pair interaction from one pair evaluation.

    Returns ``(acc_i, acc_j)`` — the action of tile J on tile I and the
    reaction of tile I on tile J — sharing the distance/rsqrt work, the
    XLA-level analogue of the reference's Newton's-3rd-law tile
    (``kernel.cu:748-761``). Used by the multi-chip symmetric half-ring.
    """
    c2 = compensate * compensate
    Gc3 = G * c2 * compensate
    d = [pos_j[None, :, c] - pos_i[:, c:c + 1] for c in range(3)]  # (I, J)
    inv = lax.rsqrt(c2 * (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) + eps2)
    u = (Gc3) * (inv * inv * inv)                      # (I, J) mass-free
    a = u * mass_j[None, :]
    b = u * mass_i[:, None]
    acc_i = jnp.stack([jnp.sum(a * dc, axis=1) for dc in d], axis=1)
    acc_j = jnp.stack([-jnp.sum(b * dc, axis=0) for dc in d], axis=1)
    return acc_i, acc_j


def direct_acc(
    pos: jax.Array,
    mass: jax.Array,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> jax.Array:
    """One-shot O(N^2) broadcast direct sum (the validation oracle)."""
    return pair_accel_tile(pos, pos, mass, eps2=eps2, compensate=compensate, G=G)


def blocked_acc(
    pos: jax.Array,
    mass: jax.Array,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    block_size: int = 256,
) -> jax.Array:
    """Row-blocked direct sum: ``lax.map`` over row chunks.

    Each chunk of ``block_size`` "row" bodies sweeps the full body list —
    the same tiling shape as the reference's VERSION 1 shared-memory kernel
    (``simple_update_all``, ``kernel.cu:828-884``) with XLA doing the
    staging. N must be a multiple of ``block_size`` (pad first).
    """
    n = pos.shape[0]
    if n % block_size:
        raise ValueError(
            f"blocked_acc: N={n} not a multiple of block_size={block_size}; pad the state"
        )
    rows = pos.reshape(n // block_size, block_size, 3)

    def chunk(pos_i):
        return pair_accel_tile(pos_i, pos, mass, eps2=eps2, compensate=compensate, G=G)

    return lax.map(chunk, rows).reshape(n, 3)


def mxu_acc(
    pos: jax.Array,
    mass: jax.Array,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    block_size: int = 1024,
) -> jax.Array:
    """Matmul-assisted direct sum: broadcast r^2 elementwise, force
    accumulation as one matrix product.

    Per row block I (``lax.map`` over blocks):

      1. ``dx, dy, dz`` and ``r2`` per coordinate via broadcasting — robust
         (no Gram-matrix ``|p_i|^2 + |p_j|^2 - 2 p_i.p_j`` cancellation,
         which is catastrophic for well-separated bodies in fp32).
      2. ``w_ij``: rsqrt + cube, elementwise.
      3. ``acc_i = S_i[:3] - p_i * S_i[3]`` where ``S = W @ [P, 1]`` — the
         ``sum_j w_ij p_j`` and ``sum_j w_ij`` reductions fold into a single
         matrix product. The self-pair is masked out because its huge
         ``w_ii`` only cancels analytically between the two S terms.
    """
    n = pos.shape[0]
    if n % block_size:
        raise ValueError(
            f"mxu_acc: N={n} not a multiple of block_size={block_size}; pad the state"
        )
    c2 = compensate * compensate
    Gc3 = G * c2 * compensate

    ones = jnp.ones((n, 1), dtype=pos.dtype)
    p_ext = jnp.concatenate([pos, ones], axis=-1)      # (N, 4)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    rows = pos.reshape(n // block_size, block_size, 3)
    idx_rows = idx.reshape(n // block_size, block_size)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]

    def chunk(args):
        pos_i, idx_i = args                            # (B, 3), (B,)
        dx = x[None, :] - pos_i[:, 0:1]                # (B, N)
        dy = y[None, :] - pos_i[:, 1:2]
        dz = z[None, :] - pos_i[:, 2:3]
        r2 = dx * dx + dy * dy + dz * dz
        w = _coef(mass[None, :], r2, eps2, c2, Gc3)    # (B, N)
        # Zero self-pairs AND coincident pairs: d = 0 means the physical
        # contribution is exactly zero, but the huge w would cancel only
        # analytically between the two S terms below, wrecking fp32.
        w = jnp.where(
            jnp.logical_or(idx_i[:, None] == idx[None, :], r2 == 0.0), 0.0, w
        )
        # HIGHEST = full float32: the default may run as TF32 (or bf16)
        # passes, and the S terms cancel against each other, so reduced
        # mantissas here are catastrophic.
        s = jnp.dot(w, p_ext, preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST)   # (B, 4)
        return s[:, :3] - pos_i * s[:, 3:4]

    return lax.map(chunk, (rows, idx_rows)).reshape(n, 3)


def required_padding(
    solver: str,
    n: int,
    block_size: int,
    tile_i: int = 256,
    tile_j: int = 1024,
    tree_tile: int = 32,
    tree_src_tile: int = 64,  # = treecode.DEFAULT_SRC_TILE
) -> int:
    """Padded body count a solver needs for N bodies (``solver`` is a
    concrete one: resolve ``"auto"`` through the execution plan first)."""
    if solver in ("blocked", "mxu"):
        return round_up(n, block_size)
    if solver == "pallas":
        return round_up(n, math.lcm(tile_i, tile_j))
    if solver == "treecode":
        # lcm with 256: the VIP sweeps run through the all-pairs kernel,
        # whose tiles want power-of-two body counts; the flat path also
        # needs whole source tiles.
        return round_up(n, math.lcm(tree_tile, tree_src_tile, 256))
    return n
