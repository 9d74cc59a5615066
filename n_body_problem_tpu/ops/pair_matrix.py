"""Method A foil: materialized pair-force matrix (dev-history D1).

The reference's first working solver (``unused_files/
project_develop_code.cu:657-861``) wrote every pair force to a length
N(N-1)/2 array — ``calculate_index(N,i,j) = i(2N-i-1)/2 + j-i-1``
(``project_develop_code.cu:660-667``) — then reduced row i by gathering
its N-1 entries (``add_up_gravity``, 784-809) and divided by mass
(``update_position_and_speed``, 812-829; the matrix stores FORCE, not
acceleration). It ran at 30 ms/step on the 4090 vs 1.6 ms for the final
kernel (``project_develop_code.cu:80``) — the dev history's lesson that a
materialized O(N^2) intermediate is memory-bound no matter how parallel
the arithmetic.

This reimplementation exists as the runnable perf-history foil, NOT a
production path: it materializes the same strict-upper-triangle force
array (here scatter-reduced with ``segment_sum``; gathers of ragged rows
are worse) and loses to every other solver for
the same reason the CUDA version did: N(N-1)/2 * 16 bytes of HBM traffic
per step where the streaming kernels touch O(N). Memory, not FLOPs, is
the budget: N = 32k already materializes ~6.4 GB/step of intermediate
traffic. Use small N.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["pair_matrix_acc", "MAX_PAIR_MATRIX_BODIES"]

# Above this the materialized triangle exceeds a sane HBM budget
# (N(N-1)/2 * 4 f32 components ~ 8.6 GB at 46341); refuse rather than OOM.
MAX_PAIR_MATRIX_BODIES = 32768


@functools.partial(jax.jit, static_argnames=("eps2", "compensate", "G"))
def pair_matrix_acc(
    pos: jax.Array,
    mass: jax.Array,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> jax.Array:
    """acc (N, 3) via the materialized half-pair force matrix (slow foil)."""
    n = pos.shape[0]
    if n > MAX_PAIR_MATRIX_BODIES:
        raise ValueError(
            f"pair_matrix_acc is the Method-A perf foil; N={n} exceeds "
            f"{MAX_PAIR_MATRIX_BODIES} (the materialized triangle would be "
            ">8 GB). Use any production solver instead."
        )
    f32 = jnp.float32
    pos = pos.astype(f32)
    mass = mass.astype(f32)
    c2 = compensate * compensate
    gc3 = G * c2 * compensate

    # The strict upper triangle, flattened — the same pair enumeration as
    # calculate_index (project_develop_code.cu:660-667).
    iu, ju = jnp.triu_indices(n, k=1)                       # (P,), (P,)
    d = pos[ju] - pos[iu]                                   # (P, 3)
    r2 = jnp.sum(d * d, axis=-1)
    inv = lax.rsqrt(c2 * r2 + eps2)
    # FORCE magnitude per pair (both masses), as Method A stored it.
    f = (gc3 * mass[iu] * mass[ju] * inv * inv * inv)[:, None] * d  # (P, 3)

    # Reduce the matrix: force on i is +sum over its row, on j the
    # reaction. segment_sum stands in for the reference's per-row gather
    # loop (add_up_gravity).
    acc_i = jax.ops.segment_sum(f, iu, num_segments=n)
    acc_j = jax.ops.segment_sum(f, ju, num_segments=n)
    force = acc_i - acc_j                                   # (N, 3)
    # Force -> acceleration (update_position_and_speed divides by mass).
    safe = jnp.where(mass > 0, mass, 1.0)
    return jnp.where(mass[:, None] > 0, force / safe[:, None], 0.0)
