"""Morton (Z-order) spatial sorting.

Reordering bodies along a space-filling curve makes kernel tiles spatially
compact, which the treecode's tile summaries and acceptance lists rely on
and which improves the locality of every tiled solver. Sorting permutes
body order; the force physics is permutation-invariant, so correctness
never depends on it.
"""

from __future__ import annotations

import numpy as np


def _spread_bits_21(v: np.ndarray) -> np.ndarray:
    """Interleave 21-bit integers with two zero bits (uint64)."""
    x = v.astype(np.uint64)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_keys(pos: np.ndarray, bits: int = 21) -> np.ndarray:
    """(N,) uint64 Z-order keys from (N, 3) positions (host-side)."""
    pos = np.asarray(pos, dtype=np.float64)
    lo = pos.min(axis=0)
    span = pos.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    scale = (2**bits - 1) / span
    q = np.clip((pos - lo) * scale, 0, 2**bits - 1).astype(np.uint64)
    return (
        _spread_bits_21(q[:, 0])
        | (_spread_bits_21(q[:, 1]) << np.uint64(1))
        | (_spread_bits_21(q[:, 2]) << np.uint64(2))
    )


def morton_argsort(pos: np.ndarray) -> np.ndarray:
    """Permutation putting bodies in Z-order."""
    return np.argsort(morton_keys(pos), kind="stable")


def apply_permutation(state, perm: np.ndarray):
    """Reorder a SimState's bodies (returns a new state; padding must be
    re-applied afterwards if perm covers only real bodies)."""
    from n_body_problem_tpu.state import SimState
    import jax.numpy as jnp

    idx = jnp.asarray(perm)
    return SimState(
        pos=state.pos[idx],
        vel=state.vel[idx],
        mass=state.mass[idx],
        eps=state.eps[idx],
        acc=state.acc[idx],
        time=state.time,
        step=state.step,
        n_real=state.n_real,
    )


# ------------------------------------------------------------ device-side
def _spread_bits_10_jnp(v):
    """Interleave 10-bit integers with two zero bits (int32, on device)."""
    import jax.numpy as jnp

    x = v.astype(jnp.int32)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys_cols(x, y, z, n_real):
    """(N,) int32 Z-order keys from (N,) coordinate columns, jittable.

    Componentwise on purpose: the run loop carries (N,) columns, never
    (N, 3) arrays. Padding bodies (slots >= n_real) get the maximal key so a stable sort
    keeps them at the end — the layout invariant every kernel relies on.
    """
    import jax
    import jax.numpy as jnp

    n = x.shape[0]
    mask = (jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
            < n_real)
    spread = []
    for c in (x, y, z):
        c = c.astype(jnp.float32)
        lo = jnp.min(jnp.where(mask, c, jnp.inf))
        hi = jnp.max(jnp.where(mask, c, -jnp.inf))
        span = jnp.where(hi > lo, hi - lo, 1.0)
        q = jnp.clip((c - lo) * (1023.0 / span), 0.0, 1023.0
                     ).astype(jnp.int32)
        spread.append(_spread_bits_10_jnp(q))
    key = spread[0] | (spread[1] << 1) | (spread[2] << 2)
    return jnp.where(mask, key, jnp.int32(0x7FFFFFFF))


def morton_keys_device(pos, n_real):
    """(N,) int32 Z-order keys from (N, 3) positions (see
    :func:`morton_keys_cols`; 10 bits/dim = 30-bit codes — plenty to order
    tiles; the host path keeps 21-bit precision)."""
    return morton_keys_cols(pos[:, 0], pos[:, 1], pos[:, 2], n_real)


def resort_cols(cols, n_real):
    """Z-order any number of (N,) body columns in ONE fused multi-operand
    sort. ``cols[0:3]`` must be x, y, z.

    ``lax.sort`` with trailing operands applies the permutation inside the
    sort itself, instead of an argsort followed by one gather per
    column.
    """
    from jax import lax

    key = morton_keys_cols(cols[0], cols[1], cols[2], n_real)
    out = lax.sort((key,) + tuple(cols), num_keys=1, is_stable=True)
    return out[1:]


def device_resort(state, ids):
    """Z-order a SimState on device (jittable; used inside scanned runs).

    ``ids`` tracks body identity across permutations (``ids[i]`` = the
    input slot of the body now at slot i). Padding stays at the end.
    Columnwise through :func:`resort_cols` (8x faster than argsort +
    (N, 3) gathers).
    """
    import jax.numpy as jnp

    from n_body_problem_tpu.state import SimState

    cols = resort_cols(
        (state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
         state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
         state.acc[:, 0], state.acc[:, 1], state.acc[:, 2],
         state.mass, state.eps, ids),
        state.n_real,
    )
    return SimState(
        pos=jnp.stack(cols[0:3], axis=1),
        vel=jnp.stack(cols[3:6], axis=1),
        acc=jnp.stack(cols[6:9], axis=1),
        mass=cols[9],
        eps=cols[10],
        time=state.time,
        step=state.step,
        n_real=state.n_real,
    ), cols[11]
