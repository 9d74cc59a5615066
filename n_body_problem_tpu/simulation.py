"""Step driver: build a step function and scan it on device.

The reference runs one force launch + one integrate launch per rendered
frame, crossing the host<->device boundary four times per step
(map/unmap + two ``cudaDeviceSynchronize``, ``kernel.cu:1223-1243``). Here
the entire multi-step run is a single ``lax.scan`` inside one ``jit`` —
zero host round-trips until results are fetched.
"""

from __future__ import annotations

import functools
import time as _time
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from n_body_problem_tpu.config import SimConfig
from n_body_problem_tpu.ops.integrators import make_integrator, prime_leapfrog
from n_body_problem_tpu.ops.registry import make_force_fn
from n_body_problem_tpu.plan import ExecutionPlan, execution_plan
from n_body_problem_tpu.state import SimState

StepFn = Callable[[SimState], SimState]


def make_step_fn(cfg: SimConfig, plan: ExecutionPlan | None = None,
                 n: int | None = None) -> StepFn:
    """One simulation step ``state -> state`` (force + integrate, fused)."""
    force_fn = make_force_fn(cfg, plan, n)
    return make_integrator(cfg.integrator, force_fn, cfg.dt)


def run_steps(state: SimState, step_fn: StepFn, n_steps: int) -> SimState:
    """Advance ``n_steps`` with ``lax.scan`` (jit-safe, static length)."""
    def body(s, _):
        return step_fn(s), None

    state, _ = lax.scan(body, state, length=n_steps)
    return state


def make_treecode_run(cfg: SimConfig, plan: ExecutionPlan | None = None):
    """Chunked treecode run: every ``cfg.tree_rebuild_every`` steps,
    re-Z-order the bodies ON DEVICE and rebuild the acceptance lists, then
    scan the steps with both cached.

    The resort is load-bearing, not an optimization: Morton tile locality
    decays on the core crossing timescale (measured at N=65k Plummer: max
    open count 451 fresh -> 506 after 8 steps -> 992 after 32), and once
    counts blow past the static near capacity the leaked tiles' multipole
    errors heat the core and the run explodes (a 10k-step
    Euler run hit dE/E ~ 1e3 without this). Everything happens inside the
    outer scan — zero host round-trips.

    Returns ``(state, step_fn_ignored, n_steps) -> (state, ids)`` where
    ``ids[i]`` is the input slot of the body now at slot i.
    """
    from n_body_problem_tpu.ops.treecode import (
        build_tree,
        build_tree_flat_cols,
        build_tree_hier_cols,
        treecode_acc,
        treecode_acc_flat_cols,
        treecode_acc_hier_cols,
    )
    from n_body_problem_tpu.utils.morton import device_resort, resort_cols

    plan = plan or execution_plan()
    r = cfg.tree_rebuild_every
    sel = dict(tile=cfg.tree_tile, theta=cfg.tree_theta,
               max_near=cfg.tree_max_near, vip_tiles=cfg.tree_vip_tiles)
    bsel = dict(mac_tau=cfg.tree_mac_tau, eps2=cfg.eps2,
                compensate=cfg.compensate, **sel)
    kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G, **sel)
    fkw = dict(kw, plan=plan)
    flat_cap = cfg.tree_flat_cap
    src = cfg.tree_src_tile
    dt = cfg.dt
    use_hier = cfg.tree_hier and flat_cap > 0 and cfg.tree_far_cap > 0

    if flat_cap > 0:
        # Columnar fast path: the whole run carries twelve (N,) columns
        # (x y z vx vy vz ax ay az mass eps ids) — never an (N, 3) array;
        # the resort is one fused multi-operand sort of the columns.
        def chunk_cols(cols, length: int, n_real: int):
            cols = resort_cols(cols, n_real)
            x, y, z, vx, vy, vz, ax, ay, az, m, eps, ids = cols
            if use_hier:
                aux = build_tree_hier_cols(
                    x, y, z, m, src_tile=src, slack=cfg.tree_near_slack,
                    flat_cap=flat_cap, far_max=cfg.tree_far_max,
                    far_cap=cfg.tree_far_cap,
                    union_coarse=cfg.tree_hier_union,
                    **dict(bsel, mac_tau=cfg.tree_hier_tau,
                           mac_tau0=cfg.tree_mac_tau))

                def force(px, py, pz):
                    return treecode_acc_hier_cols(
                        px, py, pz, m, aux, src_tile=src,
                        far_max=cfg.tree_far_max, **fkw)
            else:
                aux = build_tree_flat_cols(x, y, z, m, src_tile=src,
                                           slack=cfg.tree_near_slack,
                                           flat_cap=flat_cap, **bsel)

                def force(px, py, pz):
                    return treecode_acc_flat_cols(px, py, pz, m, aux,
                                                  src_tile=src, **fkw)

            if cfg.integrator == "semi_implicit_euler":
                def body(c, _):
                    x, y, z, vx, vy, vz, ax, ay, az = c
                    ax, ay, az = force(x, y, z)
                    vx = vx + ax * dt
                    vy = vy + ay * dt
                    vz = vz + az * dt
                    return (x + vx * dt, y + vy * dt, z + vz * dt,
                            vx, vy, vz, ax, ay, az), None
            else:  # leapfrog KDK, stored-acceleration form
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

            carry, _ = lax.scan(body, (x, y, z, vx, vy, vz, ax, ay, az),
                                length=length)
            return carry + (m, eps, ids)

        def to_cols(state: SimState):
            ids = jnp.arange(state.n, dtype=jnp.int32)
            return (state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
                    state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
                    state.acc[:, 0], state.acc[:, 1], state.acc[:, 2],
                    state.mass, state.eps, ids)

        def advance(cols, n_steps: int, n_real: int):
            full, rem = divmod(n_steps, r)
            if full:
                def outer(c, _):
                    return chunk_cols(c, r, n_real), None

                cols, _ = lax.scan(outer, cols, length=full)
            if rem:
                cols = chunk_cols(cols, rem, n_real)
            return cols

        def from_cols(cols, state: SimState, n_steps: int):
            x, y, z, vx, vy, vz, ax, ay, az, m, eps, ids = cols
            out = SimState(
                pos=jnp.stack([x, y, z], axis=1),
                vel=jnp.stack([vx, vy, vz], axis=1),
                acc=jnp.stack([ax, ay, az], axis=1),
                mass=m, eps=eps,
                time=state.time + n_steps * jnp.asarray(dt, state.time.dtype),
                step=state.step + n_steps,
                n_real=state.n_real,
            )
            return out, ids

        def run(state: SimState, _step_fn, n_steps: int):
            cols = advance(to_cols(state), n_steps, state.n_real)
            return from_cols(cols, state, n_steps)

        def movie(state: SimState, n_steps: int, render_every: int,
                  view_projection, scale_factors, width: int, height: int):
            """Chunked treecode movie: the full resort + cached-acceptance
            machinery runs between frames, so long treecode movies are as
            safe as :func:`run` (the generic ``run_with_frames`` path
            rebuilds per step and never re-sorts — short spans only).
            Returns (state, ids, frames (F, H, W, 3))."""
            from n_body_problem_tpu.render.splat import splat_frame

            if n_steps % render_every:
                raise ValueError("n_steps must be a multiple of render_every")
            n_real = state.n_real
            n = state.n
            mask = (jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
                    < n_real)

            def frame_body(c, _):
                c = advance(c, render_every, n_real)
                pos = jnp.stack([c[0], c[1], c[2]], axis=1)
                frame = splat_frame(pos, c[9], mask, view_projection,
                                    scale_factors, width=width, height=height)
                return c, frame

            cols, frames = lax.scan(frame_body, to_cols(state),
                                    length=n_steps // render_every)
            out, ids = from_cols(cols, state, n_steps)
            return out, ids, frames

        def trajectory(state: SimState, n_steps: int, save_every: int):
            """Chunked treecode trajectory (same machinery as ``movie``):
            (state, ids, pos_history (F, N, 3)).

            Every saved frame is un-permuted back to the CALL-ENTRY body
            order (the chunked resort re-orders bodies every rebuild, so
            raw frames would each be in a different Morton order and
            could not be mapped to body identities). Frame
            row i is therefore the same body in every frame, exactly as
            on the dense/generic path; ``ids`` still maps the FINAL
            state's slots to entry slots.
            """
            if n_steps % save_every:
                raise ValueError("n_steps must be a multiple of save_every")
            n_real = state.n_real

            def save_body(c, _):
                c = advance(c, save_every, n_real)
                # One multi-operand sort keyed on the ids column (the
                # sort applies the permutation to all three columns).
                _, x0, y0, z0 = lax.sort((c[11], c[0], c[1], c[2]),
                                         num_keys=1)
                return c, jnp.stack([x0, y0, z0], axis=1)

            cols, hist = lax.scan(save_body, to_cols(state),
                                  length=n_steps // save_every)
            out, ids = from_cols(cols, state, n_steps)
            return out, ids, hist

        run.movie = movie
        run.trajectory = trajectory
        return run

    def chunk(state: SimState, ids: jax.Array, length: int):
        state, ids = device_resort(state, ids)
        aux = build_tree(state.pos, state.mass, **bsel)
        force = lambda pos, mass: treecode_acc(pos, mass, aux, **kw)
        step = make_integrator(cfg.integrator, force, cfg.dt)
        return run_steps(state, step, length), ids

    def run(state: SimState, _step_fn, n_steps: int):
        ids = jnp.arange(state.n, dtype=jnp.int32)
        full, rem = divmod(n_steps, r)
        if full:
            def outer(carry, _):
                s, i = carry
                return chunk(s, i, r), None

            (state, ids), _ = lax.scan(outer, (state, ids), length=full)
        if rem:
            state, ids = chunk(state, ids, rem)
        return state, ids

    return run


def run_trajectory(
    state: SimState,
    step_fn: StepFn,
    n_steps: int,
    save_every: int = 1,
) -> tuple[SimState, jax.Array]:
    """Advance ``n_steps``, stacking positions every ``save_every`` steps.

    Returns ``(final_state, pos_history[n_steps // save_every, N, 3])``.
    """
    if n_steps % save_every:
        raise ValueError("n_steps must be a multiple of save_every")

    def outer(s, _):
        s = run_steps(s, step_fn, save_every)
        return s, s.pos

    return lax.scan(outer, state, length=n_steps // save_every)


def run_with_frames(
    state: SimState,
    step_fn: StepFn,
    n_steps: int,
    render_every: int,
    view_projection: jax.Array,
    scale_factors: jax.Array,
    width: int,
    height: int,
) -> tuple[SimState, jax.Array]:
    """Advance ``n_steps``, rendering a frame every ``render_every`` steps
    *inside* the scan — the whole movie is one device program (the
    reference's step+draw frame loop, kernel.cu:1191-1282, without any of
    its four per-frame host round-trips). Camera matrices are traced
    arguments, so moving the camera between calls does not recompile.
    Returns (state, frames[F, H, W, 3]).
    """
    from n_body_problem_tpu.render.splat import splat_frame

    if n_steps % render_every:
        raise ValueError("n_steps must be a multiple of render_every")

    def outer(s, _):
        s = run_steps(s, step_fn, render_every)
        frame = splat_frame(
            s.pos, s.mass, s.real_mask(), view_projection, scale_factors,
            width=width, height=height,
        )
        return s, frame

    return lax.scan(outer, state, length=n_steps // render_every)


class Simulation:
    """Stateful convenience wrapper with jit + donation caching.

    >>> sim = Simulation(SimConfig(), models.plummer(1024, seed=0))
    >>> sim.run(100)
    >>> sim.state.pos
    """

    def __init__(self, cfg: SimConfig, state: SimState,
                 plan: ExecutionPlan | None = None):
        from n_body_problem_tpu.ops.forces import required_padding
        from n_body_problem_tpu.state import pad_state_to

        self.plan = plan = plan or execution_plan()
        solver = plan.solver(cfg.solver)
        self.solver = solver
        if solver == "treecode" and cfg.tree_tile == 0:
            # Resolve the auto target-row granularity BEFORE padding (the
            # padding requirement depends on it): 128 on the hierarchical
            # flat path, 32 otherwise.
            # Both granularities pad to a multiple of 256 (required_padding).
            from n_body_problem_tpu.ops.treecode import DEFAULT_HIER_TILE
            from n_body_problem_tpu.utils.padding import round_up

            hier = plan.tree_variant(
                cfg, round_up(state.n_real, 256)) == "hier"
            cfg = cfg.replace(tree_tile=DEFAULT_HIER_TILE if hier else 32)
        elif cfg.tree_tile == 0:
            cfg = cfg.replace(tree_tile=32)
        if solver == "treecode" and not (cfg.morton_sort or cfg.resort_every):
            # The treecode's acceptance works on contiguous Morton tiles;
            # unsorted bodies would be silently inaccurate AND slow.
            # (run() additionally re-sorts ON DEVICE every
            # tree_rebuild_every steps — see make_treecode_run.)
            cfg = cfg.replace(morton_sort=True)
        self.cfg = cfg
        self.tree_variant = None
        self.sort_perm = None
        self.state = state
        if cfg.morton_sort or cfg.resort_every > 0:
            from n_body_problem_tpu.state import unpad_state

            if state.n != state.n_real:
                self.state = unpad_state(state)
            self._resort()
        state = self.state
        need = required_padding(
            solver, state.n, cfg.block_size, cfg.pallas_tile_i,
            cfg.pallas_tile_j, cfg.tree_tile, cfg.tree_src_tile,
        )
        if state.n < need:
            state = pad_state_to(state, need)
        if solver == "treecode" and cfg.tree_vip_tiles == -1:
            from n_body_problem_tpu.config import resolve_vip_tiles

            cfg = cfg.replace(
                tree_vip_tiles=resolve_vip_tiles(-1, state.n))
        if solver == "treecode":
            # Auto-tune the static capacities on the (sorted, padded)
            # initial distribution; margins absorb drift between re-sorts.
            # Static shapes, so they must be fixed pre-trace.
            from n_body_problem_tpu.ops.treecode import (
                suggest_flat_cap,
                suggest_hier,
                suggest_max_near,
            )

            self.tree_variant = plan.tree_variant(cfg, state.n)
            use_flat = cfg.tree_flat_cap == 0 and self.tree_variant != "dense"
            use_hier = self.tree_variant == "hier"
            mac = dict(mac_tau=cfg.tree_mac_tau, eps2=cfg.eps2,
                       compensate=cfg.compensate)
            if use_hier:
                mac = dict(mac, mac_tau=cfg.tree_hier_tau,
                           mac_tau0=cfg.tree_mac_tau,
                           union_coarse=cfg.tree_hier_union)
                # The hierarchical planner sizes all four capacities
                # consistently (its RMS-amplitude MAC and absolute-tau
                # threshold give different counts than the single-level
                # criterion, so the old planners would mis-size it).
                caps = suggest_hier(
                    state.pos, state.mass, tile=cfg.tree_tile,
                    src_tile=cfg.tree_src_tile, theta=cfg.tree_theta,
                    vip_tiles=cfg.tree_vip_tiles,
                    slack=cfg.tree_near_slack, **mac,
                )
                for field, key in (("tree_max_near", "max_near"),
                                   ("tree_flat_cap", "flat_cap"),
                                   ("tree_far_max", "far_max"),
                                   ("tree_far_cap", "far_cap")):
                    if getattr(cfg, field) == 0:
                        cfg = cfg.replace(**{field: caps[key]})
            else:
                # The flat path counts near capacity in SOURCE tiles; the
                # dense path in target tiles.
                src = (cfg.tree_src_tile
                       if use_flat or cfg.tree_flat_cap > 0 else None)
                if cfg.tree_max_near == 0:
                    cfg = cfg.replace(tree_max_near=suggest_max_near(
                        state.pos, state.mass, tile=cfg.tree_tile,
                        theta=cfg.tree_theta, vip_tiles=cfg.tree_vip_tiles,
                        src_tile=src, **mac,
                    ))
                if use_flat:
                    cfg = cfg.replace(tree_flat_cap=suggest_flat_cap(
                        state.pos, state.mass, tile=cfg.tree_tile,
                        src_tile=cfg.tree_src_tile,
                        theta=cfg.tree_theta, vip_tiles=cfg.tree_vip_tiles,
                        slack=cfg.tree_near_slack, **mac,
                    ))
            self.cfg = cfg
        if cfg.integrator == "leapfrog":
            state = jax.jit(functools.partial(
                prime_leapfrog, force_fn=make_force_fn(cfg, plan, state.n)
            ))(state)
        self.state = state
        self._step_fn = make_step_fn(cfg, plan, state.n)
        donate = (0,) if cfg.donate else ()
        run_impl = run_steps
        self._run_returns_ids = solver == "treecode"
        self._jit_tree_movie = None
        self._jit_tree_traj = None
        if self._run_returns_ids:
            # Fused device resort + cached acceptance rebuild every
            # tree_rebuild_every steps. The flat (columnar) run also
            # carries a chunked movie variant so long treecode movies get
            # the same resort safety; the dense fallback's movie goes
            # through the generic per-step path (short spans only).
            run_impl = make_treecode_run(cfg, plan)
            if hasattr(run_impl, "movie"):
                self._jit_tree_movie = jax.jit(
                    run_impl.movie, static_argnums=(1, 2, 5, 6),
                    donate_argnums=donate)
                self._jit_tree_traj = jax.jit(
                    run_impl.trajectory, static_argnums=(1, 2),
                    donate_argnums=donate)
        self._jit_run = jax.jit(run_impl, static_argnums=(1, 2), donate_argnums=donate)
        self._jit_traj = jax.jit(
            run_trajectory, static_argnums=(1, 2, 3), donate_argnums=donate
        )
        self._jit_movie = jax.jit(
            run_with_frames, static_argnums=(1, 2, 3, 6, 7), donate_argnums=donate
        )
        self.wall_seconds = 0.0

    @property
    def step_fn(self) -> StepFn:
        return self._step_fn

    def run(self, n_steps: int) -> SimState:
        """Advance n_steps. With ``cfg.resort_every = r`` the call runs in
        fixed chunks of r steps with a Morton re-sort between them (at most
        two distinct scan lengths compile: r and the remainder).

        Resort locality: the treecode path re-sorts ON DEVICE inside one
        scanned program (``make_treecode_run``); every other solver's
        ``resort_every`` chunks at the HOST — one device round-trip per
        chunk, because those solvers only need sorting for cache locality,
        not correctness, and the host `numpy` Morton sort keeps their step
        functions permutation-free. Note: the generic :meth:`trajectory` /
        :meth:`movie` programs deliberately do NOT re-sort mid-run (the
        flat treecode variants do, chunked)."""
        t0 = _time.perf_counter()
        if self._run_returns_ids:
            self.state, ids = self._jit_run(self.state, self._step_fn, n_steps)
            self._track_ids(ids)
        else:
            r = self.cfg.resort_every
            if r > 0:
                done = 0
                while n_steps - done >= r:
                    self.state = self._jit_run(self.state, self._step_fn, r)
                    done += r
                    if done < n_steps:  # skip trailing sort: no steps follow
                        self._resort()
                if n_steps - done:
                    self.state = self._jit_run(
                        self.state, self._step_fn, n_steps - done)
            else:
                self.state = self._jit_run(self.state, self._step_fn, n_steps)
        self.state.block_until_ready()
        self.wall_seconds += _time.perf_counter() - t0
        return self.state

    def _track_ids(self, ids) -> None:
        """Compose a device run's body permutation into sort_perm."""
        import numpy as _np

        ids = _np.asarray(ids)[: self.state.n_real]
        if self.sort_perm is None:
            self.sort_perm = ids
        else:
            self.sort_perm = _np.asarray(self.sort_perm)[ids]

    def _resort(self) -> None:
        """Re-Morton-order bodies (spatial locality decays as bodies move).

        Permutation-invariant physics; ``sort_perm`` is updated so callers
        can still map back to the original body order.
        """
        import numpy as _np

        from n_body_problem_tpu.utils.morton import apply_permutation, morton_argsort

        k = self.state.n_real
        perm_real = morton_argsort(_np.asarray(self.state.pos[:k]))
        perm = _np.concatenate([perm_real, _np.arange(k, self.state.n)])
        self.state = apply_permutation(self.state, perm)
        if self.sort_perm is None:
            self.sort_perm = perm_real
        else:
            self.sort_perm = _np.asarray(self.sort_perm)[perm_real]

    def _guard_dense_tree_span(self, n_steps: int) -> None:
        """Refuse long movies/trajectories on the DENSE treecode fallback.

        That path runs the generic per-step program: no Morton re-sort
        fires inside it, tile locality decays, and once open counts blow
        past the static near capacity the leaked multipole errors heat the
        core (measured dE/E ~ 1e3 over a long un-resorted run). The flat
        (columnar) treecode variants chunk-resort and have no limit.
        """
        if self._run_returns_ids and self._jit_tree_traj is None:
            limit = 4 * self.cfg.tree_rebuild_every
            if n_steps > limit:
                raise ValueError(
                    f"movie/trajectory of {n_steps} steps on the dense "
                    f"treecode fallback would run without mid-span Morton "
                    f"re-sorts (locality decay corrupts long runs; "
                    f"measured dE/E ~ 1e3). Use run(), split the span "
                    f"into chunks of <= {limit} steps, or use the flat "
                    f"treecode path (the GPU default).")

    def trajectory(self, n_steps: int, save_every: int = 1) -> jax.Array:
        self._guard_dense_tree_span(n_steps)
        t0 = _time.perf_counter()
        if self._jit_tree_traj is not None:
            self.state, ids, hist = self._jit_tree_traj(
                self.state, n_steps, save_every)
            self._track_ids(ids)
        else:
            self.state, hist = self._jit_traj(
                self.state, self._step_fn, n_steps, save_every)
        self.state.block_until_ready()
        self.wall_seconds += _time.perf_counter() - t0
        return hist

    def movie(
        self,
        n_steps: int,
        render_every: int,
        camera,
        scale_factors=(0.0, 0.0, 0.0),
        *,
        width: int = 1024,
        height: int = 768,
    ) -> jax.Array:
        """Simulate + render on device in one program; (F, H, W, 3) frames."""
        import numpy as _np

        self._guard_dense_tree_span(n_steps)
        vp = jnp.asarray(camera.view_projection())
        scales = jnp.asarray(_np.asarray(scale_factors, _np.float32))
        t0 = _time.perf_counter()
        if self._jit_tree_movie is not None:
            self.state, ids, frames = self._jit_tree_movie(
                self.state, n_steps, render_every, vp, scales, width, height,
            )
            self._track_ids(ids)
        else:
            self.state, frames = self._jit_movie(
                self.state, self._step_fn, n_steps, render_every, vp, scales,
                width, height,
            )
        self.state.block_until_ready()
        self.wall_seconds += _time.perf_counter() - t0
        return frames

    # ------------------------------------------------------------ metrics
    def pairs_per_step(self) -> int:
        """Physical directed pair interactions per step: n_real*(n_real-1).

        Padding bodies are massless and contribute no physics, so quoted
        throughput counts only real-body pairs (the padded-N^2 rate the
        kernels actually execute is :meth:`padded_pairs_per_step`).
        """
        k = self.state.n_real
        return k * (k - 1)

    def padded_pairs_per_step(self) -> int:
        """Directed pair evaluations the kernel executes (padded N^2)."""
        return self.state.n * self.state.n

    def diagnostics(self) -> dict:
        from n_body_problem_tpu import diagnostics as diag

        return diag.summary(self.state, self.cfg)
