"""Ring-decomposed all-pairs force over a device mesh.

Bodies are sharded over the ring axis. Each force evaluation runs
``n_shards`` stages: every device computes the interaction of its resident
bodies against a *visiting* (pos, mass) tile, then rotates the visiting tile
to its ring neighbor with ``lax.ppermute``. After ``n_shards`` stages every
local body has accumulated force from every shard — structurally identical
to ring attention's KV rotation, and the multi-device form of the
reference's single-GPU tile sweep (``kernel.cu:828-884``): the grid over
shared-memory tiles becomes a grid over devices, with the device
interconnect (NVLink) instead of SM shared memory.

Compute/communication overlap: within each stage the pair math is O(B^2)
while the ppermute moves O(B) bytes, so XLA's async collectives hide the
transfer entirely for realistic shard sizes.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from n_body_problem_tpu.config import SimConfig
from n_body_problem_tpu.ops.forces import pair_accel_tile
from n_body_problem_tpu.parallel.mesh import RING_AXIS
from n_body_problem_tpu.plan import ExecutionPlan, execution_plan
from n_body_problem_tpu.state import SimState


def _resolve_local_solver(local_solver: str, plan: ExecutionPlan) -> str:
    if local_solver == "auto":
        return "pallas" if plan.pair_kernel else "xla"
    if local_solver not in ("xla", "pallas"):
        raise ValueError(f"unknown local_solver {local_solver!r}")
    return local_solver


def _block_force(local_solver: str, plan: ExecutionPlan):
    """(pos_i, pos_j, mass_j, **fkw) -> acc_i for one ring stage.

    ``pallas`` runs the all-pairs GPU kernel per stage (shard size must
    be a multiple of 16); ``xla`` is the broadcast form that runs
    everywhere.
    """
    if local_solver == "pallas":
        from n_body_problem_tpu.ops.pallas_force import pallas_block_acc
        from n_body_problem_tpu.ops.treecode import _pow2_tile

        def f(pos_i, pos_j, mass_j, **fkw):
            return pallas_block_acc(
                pos_i, pos_j, mass_j,
                tile_i=_pow2_tile(pos_i.shape[0], 64),
                tile_j=_pow2_tile(pos_j.shape[0], 64),
                interpret=plan.interpret, **fkw,
            )

        return f
    return lambda pos_i, pos_j, mass_j, **fkw: pair_accel_tile(
        pos_i, pos_j, mass_j, **fkw
    )


def ring_acc(
    pos_local: jax.Array,   # (B, 3) this shard's bodies
    mass_local: jax.Array,  # (B,)
    *,
    axis_name: str = RING_AXIS,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    local_solver: str = "auto",
    plan: ExecutionPlan | None = None,
) -> jax.Array:
    """Acceleration of local bodies from ALL bodies (inside ``shard_map``)."""
    plan = plan or execution_plan()
    n_shards = lax.axis_size(axis_name)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    force = _block_force(_resolve_local_solver(local_solver, plan), plan)
    fkw = dict(eps2=eps2, compensate=compensate, G=G)

    # Stage 0 consumes the local tile, then permute-then-compute for the
    # remaining n_shards - 1 stages — no wasted final rotation.
    acc = force(pos_local, pos_local, mass_local, **fkw)

    def stage(carry, _):
        acc, pos_vis, mass_vis = carry
        pos_vis, mass_vis = lax.ppermute((pos_vis, mass_vis), axis_name, perm)
        acc = acc + force(pos_local, pos_vis, mass_vis, **fkw)
        return (acc, pos_vis, mass_vis), None

    init = (acc, pos_local, mass_local)
    (acc, _, _), _ = lax.scan(stage, init, length=n_shards - 1)
    return acc


def half_ring_acc(
    pos_local: jax.Array,   # (B, 3) this shard's bodies
    mass_local: jax.Array,  # (B,)
    *,
    axis_name: str = RING_AXIS,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    local_solver: str = "auto",
    plan: ExecutionPlan | None = None,
) -> jax.Array:
    """Symmetric (Newton's 3rd law) ring: each unordered *block pair* is
    evaluated on exactly one chip.

    The cross-chip analogue of the reference's half-pair kernel: the
    visiting packet carries ``(pos, mass, reaction_acc)``; at each of
    ``floor(D/2)`` stages the host chip computes both halves of the block
    interaction from one pair evaluation, adds the action locally and the
    reaction into the travelling packet; after the sweep one ``ppermute``
    returns each packet's accumulated reaction to its owner. For even D the
    final diagonal is gated to the lower half of the ring (each block pair
    would otherwise be visited twice). Cross-chip pair work is ~halved at
    the cost of one extra (B, 3) hop per stage.
    """
    from n_body_problem_tpu.ops.forces import pair_accel_tile_symmetric

    plan = plan or execution_plan()
    solver = _resolve_local_solver(local_solver, plan)
    block = _block_force(solver, plan)
    n_shards = lax.axis_size(axis_name)
    fkw = dict(eps2=eps2, compensate=compensate, G=G)
    # Stage 0: the local block against itself (self-pairs contribute zero).
    acc = block(pos_local, pos_local, mass_local, **fkw)
    if n_shards == 1:
        return acc

    s_last = n_shards // 2
    even = n_shards % 2 == 0
    me = lax.axis_index(axis_name)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def stage(carry, s):
        acc, pos_v, mass_v, react_v = carry
        pos_v, mass_v, react_v = lax.ppermute(
            (pos_v, mass_v, react_v), axis_name, fwd
        )

        # After s hops the packet on this chip belongs to shard (me - s).
        def compute(acc, react_v):
            if solver == "pallas":
                # Two kernel calls (action + reaction). The XLA path
                # shares the distance/rsqrt work between halves; the
                # kernel recomputes it for the reaction.
                a_local = block(pos_local, pos_v, mass_v, **fkw)
                a_visit = block(pos_v, pos_local, mass_local, **fkw)
            else:
                a_local, a_visit = pair_accel_tile_symmetric(
                    pos_local, mass_local, pos_v, mass_v, **fkw
                )
            return acc + a_local, react_v + a_visit

        if even:
            # For even D the final diagonal pairs each block twice; rows
            # i >= D/2 skip it. lax.cond (not a 0/1 gate-multiply) so the
            # inactive chips skip the pair work entirely;
            # the predicate is device-varying, which is fine under
            # shard_map's per-device SPMD (no collectives inside).
            active = jnp.logical_or(s < s_last, me < n_shards // 2)
            acc, react_v = lax.cond(
                active, compute, lambda a, r: (a, r), acc, react_v
            )
        else:
            acc, react_v = compute(acc, react_v)
        return (acc, pos_v, mass_v, react_v), None

    init = (acc, pos_local, mass_local, jnp.zeros_like(pos_local))
    (acc, _, _, react_v), _ = lax.scan(
        stage, init, jnp.arange(1, s_last + 1), length=s_last
    )
    # The packet now on chip d belongs to shard (d - s_last): send its
    # reaction home in one hop of distance s_last around the ring.
    home = [(i, (i - s_last) % n_shards) for i in range(n_shards)]
    acc = acc + lax.ppermute(react_v, axis_name, home)
    return acc


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place a state with bodies sharded over the ring axis (scalars replicated).

    N must be divisible by the mesh size; use
    :func:`n_body_problem_tpu.state.pad_state` first.
    """
    n_dev = mesh.devices.size
    if state.n % n_dev:
        raise ValueError(f"N={state.n} not divisible by mesh size {n_dev}; pad first")
    row = NamedSharding(mesh, P(RING_AXIS))
    rep = NamedSharding(mesh, P())

    def place(x):
        return jax.device_put(x, row if getattr(x, "ndim", 0) >= 1 else rep)

    return jax.tree_util.tree_map(place, state)


def make_sharded_step(
    cfg: SimConfig,
    mesh: Mesh,
    axis_name: str = RING_AXIS,
    strategy: str = "ring",
    local_solver: str = "auto",
    plan: ExecutionPlan | None = None,
) -> Callable:
    """One integration step over sharded state: ``state -> state``.

    The whole step (ring force + integrator) runs inside one ``shard_map``,
    so the only cross-chip traffic is the ``ppermute`` tile rotation.
    Supports both integrators; leapfrog uses the carried ``state.acc``.

    ``strategy``: ``"ring"`` (every chip sweeps all tiles) or
    ``"half_ring"`` (Newton's-3rd-law coverage, ~half the cross-chip pair
    work — the distributed version of the reference's report method).

    ``local_solver``: ``"xla"`` (runs everywhere), ``"pallas"`` (the
    all-pairs GPU kernel per ring stage) or ``"auto"`` (the plan's
    choice for the all-pairs block operation).
    """
    if strategy not in ("ring", "half_ring"):
        raise ValueError(f"unknown ring strategy {strategy!r}")
    force = ring_acc if strategy == "ring" else half_ring_acc
    dt = cfg.dt
    fkw = dict(axis_name=axis_name, eps2=cfg.eps2, compensate=cfg.compensate,
               G=cfg.G, local_solver=local_solver,
               plan=plan or execution_plan())

    def _euler(pos, vel, mass, acc_prev):
        acc = force(pos, mass, **fkw)
        vel = vel + acc * dt
        pos = pos + vel * dt
        return pos, vel, acc

    def _leapfrog(pos, vel, mass, acc_prev):
        v_half = vel + acc_prev * (0.5 * dt)
        pos = pos + v_half * dt
        acc = force(pos, mass, **fkw)
        vel = v_half + acc * (0.5 * dt)
        return pos, vel, acc

    inner = _leapfrog if cfg.integrator == "leapfrog" else _euler
    row = P(axis_name)
    sharded = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(row, row, row, row),
        out_specs=(row, row, row),
        # Pallas calls inside shard_map can't annotate varying-mesh-axes
        # metadata on their out_shapes; skip the check.
        check_vma=False,
    )

    def step(state: SimState) -> SimState:
        pos, vel, acc = sharded(state.pos, state.vel, state.mass, state.acc)
        return SimState(
            pos=pos, vel=vel, mass=state.mass, eps=state.eps, acc=acc,
            time=state.time + jnp.asarray(dt, state.time.dtype),
            step=state.step + 1, n_real=state.n_real,
        )

    return step


def sharded_kinetic_energy(state: SimState, mesh: Mesh, axis_name: str = RING_AXIS) -> jax.Array:
    """psum-reduced kinetic energy over the mesh (collective diagnostic)."""
    row = P(axis_name)

    def inner(vel, mass, mask):
        local = 0.5 * jnp.sum(mask * mass * jnp.sum(vel * vel, axis=-1))
        return lax.psum(local, axis_name)

    mask = state.real_mask().astype(state.pos.dtype)
    return jax.shard_map(inner, mesh=mesh, in_specs=(row, row, row), out_specs=P())(
        state.vel, state.mass, mask
    )
