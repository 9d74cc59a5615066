"""SimState — the device-resident simulation state pytree.

The reference keeps state as two AoS float4 device buffers:
``position_and_weight[i] = (x, y, z, mass)`` in a CUDA-GL shared PBO and
``velocity[i] = (vx, vy, vz, eps)`` in a plain device buffer
(``kernel.cu:88-161, 249-256``), plus a separate float3 acceleration
accumulator zeroed after each use (``kernel.cu:780, 1148-1160``).

The layout is SoA: ``pos[N,3]``, ``vel[N,3]``, ``mass[N]`` (the kernels
and the treecode's run loop work on (N,) columns of it). The per-body softening
``eps`` slot that the file formats carry (``vel.w``) is preserved for format
round-trips even though — exactly like the reference — the force kernels use
the global softening from :class:`~n_body_problem_tpu.config.SimConfig`
instead. ``acc`` is carried so the leapfrog integrator reuses the previous
force evaluation (one force eval per step).

``n_real`` is static metadata (not traced): the reference pads the body count
to ``K*256 + 1`` with zero-mass bodies at the origin (``kernel.cu:260-278``)
and only ever draws/diagnoses the first ``real_body_nums`` bodies
(``kernel.cu:1261``). We do the same with kernel-friendly padding
multiples.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from n_body_problem_tpu.utils.padding import round_up


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    pos: jax.Array   # (N, 3) positions
    vel: jax.Array   # (N, 3) velocities
    mass: jax.Array  # (N,)   masses (zero for padding bodies)
    eps: jax.Array   # (N,)   per-body softening carried from file formats (unused by force)
    acc: jax.Array   # (N, 3) last force evaluation (zeros until first step)
    time: jax.Array  # ()     simulation time
    step: jax.Array  # ()     int32 step counter
    n_real: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def n(self) -> int:
        """Total (padded) body count."""
        return int(self.pos.shape[0])

    @property
    def n_padding(self) -> int:
        return self.n - self.n_real

    def real_mask(self) -> jax.Array:
        """(N,) bool mask selecting real (non-padding) bodies."""
        idx = jax.lax.broadcasted_iota(jnp.int32, (self.n, 1), 0)[:, 0]
        return idx < self.n_real

    def block_until_ready(self) -> "SimState":
        jax.block_until_ready((self.pos, self.vel, self.acc, self.step))
        return self


def make_state(
    pos: Any,
    vel: Any,
    mass: Any,
    eps: Any | None = None,
    *,
    acc: Any | None = None,
    n_real: int | None = None,
    time: float = 0.0,
    step: int = 0,
    dtype: Any = jnp.float32,
) -> SimState:
    """Build a SimState from array-likes, validating shapes.

    ``acc`` (optional) restores a carried acceleration (checkpoint resume);
    defaults to zeros, which the leapfrog primer refreshes.
    """
    pos = jnp.asarray(pos, dtype=dtype)
    vel = jnp.asarray(vel, dtype=dtype)
    mass = jnp.asarray(mass, dtype=dtype)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (N, 3), got {pos.shape}")
    if vel.shape != pos.shape:
        raise ValueError(f"vel shape {vel.shape} != pos shape {pos.shape}")
    n = pos.shape[0]
    if mass.shape != (n,):
        raise ValueError(f"mass must be ({n},), got {mass.shape}")
    if eps is None:
        eps = jnp.zeros((n,), dtype=dtype)
    else:
        eps = jnp.asarray(eps, dtype=dtype)
        if eps.shape != (n,):
            raise ValueError(f"eps must be ({n},), got {eps.shape}")
    if acc is None:
        acc = jnp.zeros_like(pos)
    else:
        acc = jnp.asarray(acc, dtype=dtype)
        if acc.shape != pos.shape:
            raise ValueError(f"acc shape {acc.shape} != pos shape {pos.shape}")
    return SimState(
        pos=pos,
        vel=vel,
        mass=mass,
        eps=eps,
        acc=acc,
        time=jnp.asarray(time, dtype=dtype),
        step=jnp.asarray(step, dtype=jnp.int32),
        n_real=int(n if n_real is None else n_real),
    )


def pad_state(state: SimState, multiple: int = 256, extra: int = 0) -> SimState:
    """Pad to a multiple of ``multiple`` (+``extra``) with zero-mass bodies.

    The reference pads to ``ceil(N/256)*256 + 1`` (``kernel.cu:260-278``); its
    ``+1`` exists only because its pair matrix excludes self-interaction by
    construction. The kernels here don't need the +1 (self-pairs contribute exactly
    zero force), but ``extra=1`` reproduces the reference count for parity
    tests.
    """
    n = state.n
    target = round_up(max(n, 1), multiple) + extra
    if target == n:
        return state
    if target < n:
        raise ValueError(f"cannot pad {n} bodies down to {target}")
    p = target - n

    def pad2(x):
        return jnp.concatenate([x, jnp.zeros((p,) + x.shape[1:], dtype=x.dtype)])

    return SimState(
        pos=pad2(state.pos),
        vel=pad2(state.vel),
        mass=pad2(state.mass),
        eps=pad2(state.eps),
        acc=pad2(state.acc),
        time=state.time,
        step=state.step,
        n_real=state.n_real,
    )


def pad_state_to(state: SimState, n_total: int) -> SimState:
    """Pad to an absolute body count (zero-mass bodies at the origin)."""
    if n_total < state.n:
        raise ValueError(f"cannot pad {state.n} bodies down to {n_total}")
    return pad_state(state, multiple=1, extra=n_total - state.n)


def unpad_state(state: SimState) -> SimState:
    """Drop padding bodies, returning a state with N == n_real."""
    k = state.n_real
    return SimState(
        pos=state.pos[:k],
        vel=state.vel[:k],
        mass=state.mass[:k],
        eps=state.eps[:k],
        acc=state.acc[:k],
        time=state.time,
        step=state.step,
        n_real=k,
    )


def to_numpy(state: SimState) -> dict:
    """Host-side dict of numpy arrays (for checkpointing / IO)."""
    return {
        "pos": np.asarray(state.pos),
        "vel": np.asarray(state.vel),
        "mass": np.asarray(state.mass),
        "eps": np.asarray(state.eps),
        "acc": np.asarray(state.acc),
        "time": np.asarray(state.time),
        "step": np.asarray(state.step),
        "n_real": np.asarray(state.n_real),
    }
