"""Barnes-Hut treecode: error envelopes, exact limits, solver wiring."""

import numpy as np
import pytest

import jax.numpy as jnp

from n_body_problem_tpu import SimConfig, Simulation, models
from n_body_problem_tpu.ops import direct_acc
from n_body_problem_tpu.ops.treecode import (
    open_counts,
    suggest_max_near,
    tile_summaries,
    treecode_acc,
)
from n_body_problem_tpu.utils.morton import apply_permutation, morton_argsort

EPS2 = 1e-6


def _sorted_plummer(n, seed=0):
    state = models.plummer(n, seed=seed)
    perm = morton_argsort(np.asarray(state.pos))
    return apply_permutation(state, perm)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    denom = np.maximum(np.linalg.norm(want, axis=1), 1e-12)
    return np.linalg.norm(got - want, axis=1) / denom


def test_error_envelope_theta_half():
    """The headline acceptance guarantee: theta=0.5 with quadrupole far
    field and auto capacity stays inside ~1e-3 p99 relative force error
    (measured 1.06e-3 at N=65k; small N is strictly easier)."""
    state = _sorted_plummer(8192, seed=1)
    m = suggest_max_near(state.pos, state.mass, tile=32, theta=0.5,
                         vip_tiles=32)
    got = treecode_acc(state.pos, state.mass, eps2=EPS2, tile=32, theta=0.5,
                       max_near=m, vip_tiles=32)
    want = direct_acc(state.pos, state.mass, eps2=EPS2)
    err = _rel_err(got, want)
    assert np.median(err) < 5e-4, f"median {np.median(err):.2e}"
    assert np.percentile(err, 99) < 2e-3, f"p99 {np.percentile(err, 99):.2e}"


def test_exact_when_capacity_covers_everything():
    """max_near >= K degenerates to the exact direct solver."""
    state = _sorted_plummer(2048, seed=2)
    k = 2048 // 32
    got = treecode_acc(state.pos, state.mass, eps2=EPS2, tile=32, theta=0.5,
                       max_near=k, vip_tiles=0)
    want = direct_acc(state.pos, state.mass, eps2=EPS2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=2e-6)


def test_pallas_near_path_matches_xla():
    """The flat path with the GPU plan's kernels (the Triton near kernel
    and the all-pairs kernel for both VIP sweeps, run by the Pallas
    interpreter) == the same path in its plain XLA forms."""
    import dataclasses

    from n_body_problem_tpu.ops.treecode import (
        build_tree_flat,
        suggest_flat_cap,
        treecode_acc_flat,
    )
    from n_body_problem_tpu.plan import execution_plan

    state = _sorted_plummer(4096, seed=3)
    kw = dict(tile=32, src_tile=64, theta=0.5, max_near=64, vip_tiles=16)
    cap = suggest_flat_cap(state.pos, state.mass, tile=32, src_tile=64,
                           theta=0.5, vip_tiles=16, slack=2)
    aux = build_tree_flat(state.pos, state.mass, slack=2, flat_cap=cap, **kw)
    gpu = dataclasses.replace(execution_plan("gpu"), interpret=True)
    a = treecode_acc_flat(state.pos, state.mass, aux, eps2=EPS2,
                          plan=execution_plan("cpu"), **kw)
    b = treecode_acc_flat(state.pos, state.mass, aux, eps2=EPS2, plan=gpu,
                          **kw)
    # Same pairs, same float32 math; only the summation order differs.
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-6)


def test_suggest_covers_open_counts():
    state = _sorted_plummer(4096, seed=4)
    counts = np.asarray(open_counts(state.pos, state.mass, tile=32,
                                    theta=0.5, vip_tiles=16))
    m = suggest_max_near(state.pos, state.mass, tile=32, theta=0.5,
                         vip_tiles=16)
    assert m >= counts.max()
    assert m % 16 == 0 or m == 4096 // 32


def test_quadrupole_beats_monopole():
    """The far expansion must out-approximate a plain monopole for an
    anisotropic source cluster (quadrupole term live and correct)."""
    rng = np.random.default_rng(5)
    # Anisotropic bar of 32 bodies + 32 distant probes.
    bar = np.zeros((32, 3), np.float32)
    bar[:, 0] = np.linspace(-1, 1, 32)
    probes = rng.normal(size=(32, 3)).astype(np.float32)
    probes = 6.0 * probes / np.linalg.norm(probes, axis=1, keepdims=True)
    pos = jnp.asarray(np.concatenate([probes, bar]))
    mass = jnp.asarray(np.concatenate([np.zeros(32), np.ones(32)])
                       .astype(np.float32))
    want = np.asarray(direct_acc(pos, mass, eps2=EPS2))[:32]

    # treecode with probes near only themselves: bar is pure far field.
    got = np.asarray(treecode_acc(pos, mass, eps2=EPS2, tile=32, theta=1.0,
                                  max_near=1, vip_tiles=0))[:32]
    # hand monopole of the bar at its com (origin), reference pair math
    c2, gc3 = 0.01, 1e-3
    d = -probes
    r2 = (d * d).sum(1)
    u = 1.0 / np.sqrt(c2 * r2 + EPS2)
    mono = (32.0 * gc3 * u**3)[:, None] * d
    err_tree = np.linalg.norm(got - want, axis=1)
    err_mono = np.linalg.norm(mono - want, axis=1)
    assert err_tree.max() < 0.2 * err_mono.max()


def test_isotropic_quadrupole_is_inert():
    """An isotropic second moment must contribute nothing (the tracelessness
    identity the far-field coefficients encode)."""
    # 8 cube corners x4 = exactly 32 bodies with an isotropic S.
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    ) / np.sqrt(3.0)
    src = np.concatenate([corners] * 4) * 0.5
    probes = np.array([[5.0, 1.0, -2.0]] * 32, np.float32)
    pos = jnp.asarray(np.concatenate([probes, src]))
    mass = jnp.asarray(np.concatenate([np.zeros(32), np.ones(32) / 32])
                       .astype(np.float32))
    com, m_tot, radius, quad = tile_summaries(pos[32:], mass[32:], 32)
    s = np.asarray(quad)[0]
    assert abs(s[0] - s[1]) < 1e-6 and abs(s[3]) < 1e-7     # isotropic-ish
    got = np.asarray(treecode_acc(pos, mass, eps2=EPS2, tile=32, theta=1.0,
                                  max_near=1, vip_tiles=0))[0]
    c2, gc3 = 0.01, 1e-3
    d = np.asarray(com[0]) - probes[0]
    u = 1.0 / np.sqrt(c2 * (d * d).sum() + EPS2)
    mono = float(np.asarray(m_tot)[0]) * gc3 * u**3 * d
    np.testing.assert_allclose(got, mono, rtol=5e-4, atol=1e-7)


def test_vip_tiles_are_exact_both_ways():
    """Bodies in the largest-radius tiles get exact forces, and their
    sources are exact for everyone (no tree contribution)."""
    state = _sorted_plummer(2048, seed=6)
    want = np.asarray(direct_acc(state.pos, state.mass, eps2=EPS2))
    got = np.asarray(treecode_acc(state.pos, state.mass, eps2=EPS2, tile=32,
                                  theta=0.5, max_near=16, vip_tiles=16))
    # identify VIP bodies the same way the solver does
    _, _, radius, _ = tile_summaries(state.pos, state.mass, 32)
    vip = np.argsort(-np.asarray(radius))[:16]
    vip_rows = (vip[:, None] * 32 + np.arange(32)).reshape(-1)
    err = _rel_err(got[vip_rows], want[vip_rows])
    assert np.percentile(err, 99) < 1e-4   # exact rows (f32 rounding only)


def test_simulation_wiring_auto_sort_and_capacity():
    """SimConfig(solver='treecode') is a first-class solver: Simulation
    auto-enables Morton sorting, auto-tunes the near capacity, and runs."""
    cfg = SimConfig(solver="treecode", tree_vip_tiles=8)
    sim = Simulation(cfg, models.plummer(2048, seed=7))
    assert sim.cfg.morton_sort
    assert sim.cfg.tree_max_near > 0
    sim.run(3)
    assert bool(jnp.all(jnp.isfinite(sim.state.pos)))
    d = sim.diagnostics()
    assert np.isfinite(d["energy"])


def test_rejects_bad_shapes_and_theta():
    state = _sorted_plummer(256, seed=8)
    with pytest.raises(ValueError):
        treecode_acc(state.pos[:100], state.mass[:100], eps2=EPS2, tile=32)
    with pytest.raises(ValueError):
        treecode_acc(state.pos, state.mass, eps2=EPS2, tile=32, theta=1.5)


def test_long_run_stability_with_device_resort():
    """Round-2 regression: without periodic re-sorting, Morton locality
    decays, near counts blow past the static capacity, and the leaked
    multipole errors explode the core (measured dE/E ~ 1e3 at 10k steps).
    The fused device resort + rebuild must keep a few hundred steps of a
    live Plummer core drift-bounded."""
    cfg = SimConfig(solver="treecode", tree_vip_tiles=8, dt=0.008)
    sim = Simulation(cfg, models.plummer(2048, seed=31))
    e0 = sim.diagnostics()["energy"]
    sim.run(200)
    d = sim.diagnostics()
    drift = abs((d["energy"] - e0) / e0)
    assert drift < 0.01, f"treecode run drifted dE/E = {drift:.2e}"
    assert d["overspeed"] == 0
    # identity tracking survived the device permutations
    assert sim.sort_perm is not None
    assert sorted(sim.sort_perm.tolist()) == list(range(2048))


def test_flat_path_matches_dense_path():
    """The compacted asymmetric near path (source tiles 4x the target
    granularity) computes the same physics as the per-target static lists
    — its near sets are supersets at coarser granularity, so agreement
    must hold to the approximation envelope."""
    from n_body_problem_tpu.ops.treecode import (
        build_tree_flat,
        suggest_flat_cap,
        treecode_acc_flat,
    )

    state = _sorted_plummer(4096, seed=41)
    mn = suggest_max_near(state.pos, state.mass, tile=32, src_tile=64,
                          theta=0.5, vip_tiles=16, multiple=16)
    kw = dict(tile=32, src_tile=64, theta=0.5, max_near=mn, vip_tiles=16)
    cap = suggest_flat_cap(state.pos, state.mass, tile=32, src_tile=64,
                           theta=0.5, vip_tiles=16, slack=2)
    aux = build_tree_flat(state.pos, state.mass, slack=2, flat_cap=cap, **kw)
    got = treecode_acc_flat(state.pos, state.mass, aux, eps2=EPS2,
                            **kw)
    want = direct_acc(state.pos, state.mass, eps2=EPS2)
    err = _rel_err(got, want)
    assert np.median(err) < 5e-4, f"median {np.median(err):.2e}"
    assert np.percentile(err, 99) < 2e-3, f"p99 {np.percentile(err, 99):.2e}"


def test_flat_segmented_accumulation_matches_single_call():
    """The XLA near field evaluates the work list in blocks of chunks and
    sums each target row's chunks afterwards; rows whose chunks straddle
    block boundaries must get exactly what one block gives, and the row
    sum runs in a fixed order (no scatter-add)."""
    from n_body_problem_tpu.ops.treecode import (
        _near_field_flat_xla,
        _source_cols,
        build_tree_flat,
        suggest_flat_cap,
    )

    state = _sorted_plummer(2048, seed=42)
    kw = dict(tile=32, src_tile=128, theta=0.5, max_near=16, vip_tiles=0)
    cap = suggest_flat_cap(state.pos, state.mass, tile=32, src_tile=128,
                           theta=0.5, vip_tiles=0, slack=2)
    flat_src, chunk_tgt, _, _ = build_tree_flat(
        state.pos, state.mass, slack=2, flat_cap=cap, **kw)
    x, y, z = (state.pos[:, i] for i in range(3))
    src = _source_cols(x, y, z, state.mass, 128)
    args = dict(eps2=EPS2, c2=0.01, tile=32, src_tile=128, max_chunks=1)
    n_chunks = int(chunk_tgt.shape[0])
    one = _near_field_flat_xla(x, y, z, src, flat_src, chunk_tgt,
                               block=n_chunks, **args)
    # a third of the chunks per block forces mid-row block boundaries
    segd = _near_field_flat_xla(x, y, z, src, flat_src, chunk_tgt,
                                block=n_chunks // 3 + 1, **args)
    np.testing.assert_array_equal(np.asarray(one), np.asarray(segd))


def test_flat_capacity_overflow_is_consistent():
    """When flat_cap can't hold every open entry, the dropped sources
    must fall back to the far field (near_mask is rebuilt from entries
    that actually landed) — degraded accuracy, but nothing double-counted
    or lost. A 1e0-scale error would indicate a coverage hole."""
    from n_body_problem_tpu.ops.treecode import (
        build_tree_flat,
        suggest_flat_cap,
        treecode_acc_flat,
    )

    state = _sorted_plummer(4096, seed=43)
    kw = dict(tile=32, src_tile=128, theta=0.5, max_near=32, vip_tiles=0)
    full = suggest_flat_cap(state.pos, state.mass, tile=32, src_tile=128,
                            theta=0.5, vip_tiles=0, slack=0, margin=1.0)
    k_t_e = (4096 // 32) * 16                   # one chunk per row (floor)
    cap = max(k_t_e, (full // 2) // 16 * 16)    # starve the capacity
    aux = build_tree_flat(state.pos, state.mass, slack=0, flat_cap=cap, **kw)
    flat_src, chunk_tgt, near_mask, _ = map(np.asarray, aux)

    # Structural invariants under overflow:
    k_t, k_s, entries = 4096 // 32, 4096 // 128, 16
    slot_rows = np.repeat(chunk_tgt, entries)
    # (1) every row keeps its top entries — the self source must land
    self_ok = np.zeros(k_t, bool)
    landed = np.zeros((k_t, k_s), bool)
    for r, s in zip(slot_rows, flat_src):
        if r < k_t and s < k_s:
            landed[r, s] = True
            if s == (r * 32) // 128:
                self_ok[r] = True
    assert self_ok.all(), f"{(~self_ok).sum()} rows dropped their self tile"
    # (2) the far mask complements exactly what landed (no hole, no
    # double count)
    np.testing.assert_array_equal(near_mask, landed)

    got = treecode_acc_flat(state.pos, state.mass, aux, eps2=EPS2,
                            **kw)
    want = direct_acc(state.pos, state.mass, eps2=EPS2)
    err = _rel_err(got, want)
    # Degraded (dropped near sources fall back to multipole at close
    # range) but consistent: nothing explodes the way a coverage hole
    # does (a dropped self tile measured p99 ~ 63).
    assert np.percentile(err, 99) < 1.0, f"p99 {np.percentile(err, 99):.2e}"
    assert np.median(err) < 2e-2, f"median {np.median(err):.2e}"
    assert np.isfinite(np.asarray(got)).all()


@pytest.mark.slow
def test_mac_criterion_beats_theta_at_matched_cost():
    """The mass-aware MAC (tree_mac_tau > 0) must be substantially more
    accurate than the geometric theta test at comparable open counts —
    the measured frontier property that made it the default (heavy
    near-threshold tiles open, light far ones don't). Also: MAC never
    opens massless padding tiles."""
    from n_body_problem_tpu.ops.treecode import open_counts

    state = _sorted_plummer(8192, seed=45)
    kw = dict(tile=32, src_tile=64, vip_tiles=16)
    cnt_theta = np.asarray(open_counts(
        state.pos, state.mass, theta=0.55, **kw))
    # tau is calibrated at K_s=4096; descale to this test's K_s=128 so
    # the effective operating point matches the measured frontier.
    tau = 2e-4 / (4096 / 128) ** 0.5
    cnt_mac = np.asarray(open_counts(
        state.pos, state.mass, mac_tau=tau, eps2=EPS2,
        compensate=0.1, **kw))
    # comparable cost: within ~35% of the geometric criterion's opens
    assert cnt_mac.mean() < cnt_theta.mean() * 1.35, (
        f"MAC opens {cnt_mac.mean():.1f} vs theta {cnt_theta.mean():.1f}")

    sel = dict(tile=32, src_tile=64, theta=0.55, max_near=160,
               vip_tiles=16)
    want = direct_acc(state.pos, state.mass, eps2=EPS2)

    def p99_err(mac_tau):
        from n_body_problem_tpu.ops.treecode import (
            build_tree_flat,
            suggest_flat_cap,
            treecode_acc_flat,
        )

        cap = suggest_flat_cap(
            state.pos, state.mass, tile=32, src_tile=64, theta=0.55,
            vip_tiles=16, slack=2, mac_tau=mac_tau, eps2=EPS2,
            compensate=0.1)
        aux = build_tree_flat(
            state.pos, state.mass, slack=2, flat_cap=cap,
            mac_tau=mac_tau, eps2=EPS2, compensate=0.1, **sel)
        got = treecode_acc_flat(state.pos, state.mass, aux, eps2=EPS2,
                                **sel)
        return np.percentile(_rel_err(got, want), 99)


    e_theta = p99_err(0.0)
    e_mac = p99_err(tau)
    assert e_mac < e_theta * 0.75, (
        f"MAC p99 {e_mac:.2e} not clearly better than theta {e_theta:.2e}")
    assert e_mac < 1.5e-3


@pytest.mark.slow
def test_flat_treecode_movie_matches_run():
    """The flat treecode movie runs the SAME chunked resort+rebuild
    machinery as run() between frames (long-movie safety); with
    render_every == tree_rebuild_every the chunk sequence is identical,
    so the final state must match run() exactly."""
    from n_body_problem_tpu.render import OrbitCamera

    n = 4096
    cfg = SimConfig(solver="treecode", tree_vip_tiles=8, tree_src_tile=64,
                    tree_max_near=64, tree_rebuild_every=4,
                    tree_flat_cap=(n // 32) * 64, donate=False)
    sim_a = Simulation(cfg, models.plummer(n, seed=7))
    assert sim_a._jit_tree_movie is not None, "flat movie path not wired"
    frames = sim_a.movie(8, render_every=4, camera=OrbitCamera(distance=2.0),
                         width=128, height=128)
    assert frames.shape[0] == 2 and np.isfinite(np.asarray(frames)).all()
    assert np.asarray(frames).max() > 0, "frames are blank"

    sim_b = Simulation(cfg, models.plummer(n, seed=7))
    sim_b.run(8)
    inv_a = np.empty(n, int); inv_a[sim_a.sort_perm] = np.arange(n)
    inv_b = np.empty(n, int); inv_b[sim_b.sort_perm] = np.arange(n)
    np.testing.assert_allclose(
        np.asarray(sim_a.state.pos[:n])[inv_a],
        np.asarray(sim_b.state.pos[:n])[inv_b], rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_flat_treecode_trajectory_matches_run():
    """trajectory() on the flat path uses the same chunked machinery, and
    every frame is un-permuted to the call-entry body order (ADVICE r2:
    raw frames were each in a different Morton order)."""
    n = 4096
    cfg = SimConfig(solver="treecode", tree_vip_tiles=8, tree_src_tile=64,
                    tree_max_near=64, tree_rebuild_every=4,
                    tree_flat_cap=(n // 32) * 64, donate=False)
    sim_a = Simulation(cfg, models.plummer(n, seed=9))
    entry_perm = np.asarray(sim_a.sort_perm).copy()  # entry slot -> orig id
    hist = sim_a.trajectory(8, save_every=4)
    assert hist.shape == (2, sim_a.state.n, 3)

    sim_b = Simulation(cfg, models.plummer(n, seed=9))
    sim_b.run(8)
    # Compare in original-id space: frame rows are call-entry slots.
    by_orig_a = np.empty((n, 3))
    by_orig_a[entry_perm] = np.asarray(hist[-1][:n])
    by_orig_b = np.empty((n, 3))
    by_orig_b[np.asarray(sim_b.sort_perm)] = np.asarray(sim_b.state.pos[:n])
    np.testing.assert_allclose(by_orig_a, by_orig_b, rtol=1e-6, atol=1e-7)

    # Fixed-order property: row r is the SAME body in both frames, so
    # per-row displacement across 4 steps is tiny; a Morton-permuted row
    # would jump by the system scale.
    disp = np.linalg.norm(np.asarray(hist[1][:n] - hist[0][:n]), axis=1)
    assert np.median(disp) < 0.1, "frame rows are not a fixed body order"


def test_dense_tree_long_span_refused():
    """The DENSE treecode fallback cannot resort inside movie()/
    trajectory(); long spans must be refused loudly instead of silently
    decaying (VERDICT r2 #6). run() (which chunk-resorts) stays fine."""
    import pytest

    n = 2048
    cfg = SimConfig(solver="treecode", tree_vip_tiles=8, tree_max_near=32,
                    tree_rebuild_every=4, tree_flat_cap=0, donate=False)
    sim = Simulation(cfg, models.plummer(n, seed=3))
    assert sim._jit_tree_traj is None, "expected the dense fallback"
    with pytest.raises(ValueError, match="re-sort"):
        sim.trajectory(64, save_every=8)
    from n_body_problem_tpu.render import OrbitCamera

    with pytest.raises(ValueError, match="re-sort"):
        sim.movie(64, render_every=8, camera=OrbitCamera(distance=2.0),
                  width=64, height=64)
    sim.trajectory(8, save_every=8)  # short span still allowed
