"""Hierarchical (multi-level) treecode: summaries, chain coverage,
force-error envelopes, capacity planning.

The reference has no tree (its only solver is exact brute force,
``kernel.cu:703-774``); these tests guard the hierarchy against the
exact oracle instead.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from n_body_problem_tpu import models
from n_body_problem_tpu.ops.forces import direct_acc
from n_body_problem_tpu.ops import treecode as tc
from n_body_problem_tpu.utils.morton import morton_argsort

EPS2 = 1e-6
COMP = 0.1


def _sorted_plummer(n, seed=0):
    st = models.plummer(n, seed=seed)
    pos = np.asarray(st.pos)
    perm = morton_argsort(pos)
    return jnp.asarray(pos[perm]), jnp.asarray(np.asarray(st.mass)[perm])


def _hier_aux(pos, mass, **kw):
    caps = tc.suggest_hier(pos, mass, **kw)
    aux = tc.build_tree_hier_cols(
        pos[:, 0], pos[:, 1], pos[:, 2], mass,
        flat_cap=caps["flat_cap"], max_near=caps["max_near"],
        far_max=caps["far_max"], far_cap=caps["far_cap"], **kw)
    return aux, caps


def _hier_acc(pos, mass, aux, caps, **kw):
    ax, ay, az = tc.treecode_acc_hier_cols(
        pos[:, 0], pos[:, 1], pos[:, 2], mass, aux,
        eps2=EPS2, max_near=caps["max_near"], far_max=caps["far_max"],
        **kw)
    return np.stack([np.asarray(ax), np.asarray(ay), np.asarray(az)], axis=1)


def test_level_summaries_exact_merge():
    """Parent com/mass/quadrupole must equal direct computation from the
    bodies (parallel-axis merging is exact); radius stays conservative."""
    pos, mass = _sorted_plummer(4096, seed=1)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    plan = tc._level_plan(4096 // 64)
    assert len(plan) >= 3
    levels = tc._level_summaries(x, y, z, mass, 64, plan, tc.HIER_BRANCH)
    p = np.asarray(pos)
    m = np.asarray(mass)
    for lvl, k in enumerate(plan):
        width = 4096 // k
        cx, cy, cz, mt, rad, rms2, q = levels[lvl]
        pb = p.reshape(k, width, 3)
        mb = m.reshape(k, width)
        mt_d = mb.sum(1)
        com_d = (mb[:, :, None] * pb).sum(1) / mt_d[:, None]
        np.testing.assert_allclose(np.asarray(mt), mt_d, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(cx), com_d[:, 0],
                                   rtol=1e-4, atol=1e-5)
        d = pb - com_d[:, None, :]
        qxx_d = (mb * d[:, :, 0] * d[:, :, 0]).sum(1)
        qxy_d = (mb * d[:, :, 0] * d[:, :, 1]).sum(1)
        np.testing.assert_allclose(np.asarray(q[0]), qxx_d,
                                   rtol=1e-3, atol=1e-9)
        np.testing.assert_allclose(np.asarray(q[3]), qxy_d,
                                   rtol=1e-3, atol=1e-9)
        # bounding radius conservative: >= true max body distance
        rmax = np.sqrt(((d ** 2).sum(2)) * (mb > 0)).max(1)
        assert (np.asarray(rad) >= rmax - 1e-5).all()
        # rms2 = tr(S)/m
        np.testing.assert_allclose(
            np.asarray(rms2),
            (qxx_d + (mb * d[:, :, 1] ** 2).sum(1)
             + (mb * d[:, :, 2] ** 2).sum(1)) / mt_d, rtol=1e-3)


@pytest.mark.slow
def test_chain_coverage_partition():
    """Every (target row, source leaf) pair is covered exactly once:
    near-candidate or the topmost accepted ancestor."""
    pos, mass = _sorted_plummer(8192, seed=2)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    tile, src = 128, 64
    k_s = 8192 // src
    plan = tc._level_plan(k_s)
    vip_src = tc._clamp_vip(tc._vip_src_tiles(128, tile, src), k_s)
    mass_tree, _, _ = tc._vip_split(x, y, z, mass, src, vip_src)
    levels = tc._level_summaries(x, y, z, mass_tree, src, plan,
                                 tc.HIER_BRANCH)
    opens, _, _, _ = tc._hier_open_masks(
        x, y, z, levels, tile, src, mac_tau=tc.DEFAULT_HIER_TAU, theta=0.55,
        eps2=EPS2, c2=COMP * COMP)
    evals, reach0 = tc._chain_evals(opens, tc.HIER_BRANCH)
    near = np.asarray(reach0 & opens[0])
    cover = near.astype(np.int32)
    for lvl, ev in enumerate(evals):
        e = np.asarray(ev)
        for _ in range(lvl):
            e = np.repeat(e, tc.HIER_BRANCH, axis=1)
        cover += e.astype(np.int32)
    assert cover.min() == 1 and cover.max() == 1


@pytest.mark.slow
def test_hier_force_error_envelope():
    """End-to-end hierarchical force vs the exact oracle: the p99
    relative error stays in the expected MAC class."""
    pos, mass = _sorted_plummer(8192, seed=3)
    kw = dict(tile=128, src_tile=64, vip_tiles=128,
              mac_tau=tc.DEFAULT_HIER_TAU, eps2=EPS2, compensate=COMP)
    aux, caps = _hier_aux(pos, mass, **kw)
    acc = _hier_acc(pos, mass, aux, caps,
                    tile=128, src_tile=64, vip_tiles=128)
    exact = np.asarray(direct_acc(pos, mass, eps2=EPS2, compensate=COMP))
    err = (np.linalg.norm(acc - exact, axis=1)
           / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))
    assert np.isfinite(acc).all()
    assert np.percentile(err, 99) < 2.5e-3, np.percentile(err, 99)
    assert np.median(err) < 5e-4, np.median(err)


@pytest.mark.slow
def test_hier_matches_flat_quality():
    """The hierarchical path must stay in the flat path's error class
    at the default taus (it computes the SAME near
    field and replaces distant level-0 multipoles with coarser nodes
    only where the MAC allows)."""
    pos, mass = _sorted_plummer(8192, seed=4)
    exact = np.asarray(direct_acc(pos, mass, eps2=EPS2, compensate=COMP))

    kw = dict(tile=128, src_tile=64, vip_tiles=128,
              mac_tau=tc.DEFAULT_HIER_TAU, eps2=EPS2, compensate=COMP)
    aux, caps = _hier_aux(pos, mass, **kw)
    acc_h = _hier_acc(pos, mass, aux, caps,
                      tile=128, src_tile=64, vip_tiles=128)

    cap = tc.suggest_flat_cap(pos, mass, tile=32, src_tile=64,
                              vip_tiles=128, mac_tau=2e-4,
                              eps2=EPS2, compensate=COMP)
    aux_f = tc.build_tree_flat(pos, mass, tile=32, src_tile=64,
                               vip_tiles=128, mac_tau=2e-4, eps2=EPS2,
                               compensate=COMP, flat_cap=cap)
    acc_f = np.asarray(tc.treecode_acc_flat(
        pos, mass, aux_f, eps2=EPS2, tile=32, src_tile=64, vip_tiles=128))

    def p99(a):
        err = (np.linalg.norm(a - exact, axis=1)
               / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))
        return np.percentile(err, 99)

    assert p99(acc_h) < max(2.0 * p99(acc_f), 2.5e-3), (p99(acc_h),
                                                        p99(acc_f))


@pytest.mark.slow
def test_hier_exact_limit():
    """tau -> 0 opens everything: the near field computes every pair
    exactly and the far lists are empty; the result must match the
    direct sum to kernel rounding."""
    pos, mass = _sorted_plummer(4096, seed=5)
    k_s = 4096 // 64
    kw = dict(tile=128, src_tile=64, vip_tiles=0, mac_tau=1e-12,
              eps2=EPS2, compensate=COMP)
    aux, caps = _hier_aux(pos, mass, **kw)
    assert caps["max_near"] >= k_s
    acc = _hier_acc(pos, mass, aux, caps,
                    tile=128, src_tile=64, vip_tiles=0)
    exact = np.asarray(direct_acc(pos, mass, eps2=EPS2, compensate=COMP))
    err = (np.linalg.norm(acc - exact, axis=1)
           / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))
    assert np.percentile(err, 99) < 1e-5, np.percentile(err, 99)


@pytest.mark.slow
def test_hier_far_overflow_sheds_weakest():
    """A deliberately small far_cap must stay finite and lose only the
    weakest contributors (error grows but stays bounded)."""
    pos, mass = _sorted_plummer(8192, seed=6)
    kw = dict(tile=128, src_tile=64, vip_tiles=128,
              mac_tau=tc.DEFAULT_HIER_TAU, eps2=EPS2, compensate=COMP)
    caps = tc.suggest_hier(pos, mass, **kw)
    small = dict(caps)
    k_t = 8192 // 128
    small["far_cap"] = max(k_t * tc.FAR_ENTRIES,
                           (caps["far_cap"] // (2 * tc.FAR_ENTRIES))
                           * tc.FAR_ENTRIES)
    aux = tc.build_tree_hier_cols(
        pos[:, 0], pos[:, 1], pos[:, 2], mass,
        flat_cap=small["flat_cap"], max_near=small["max_near"],
        far_max=small["far_max"], far_cap=small["far_cap"], **kw)
    acc = _hier_acc(pos, mass, aux, small,
                    tile=128, src_tile=64, vip_tiles=128)
    exact = np.asarray(direct_acc(pos, mass, eps2=EPS2, compensate=COMP))
    err = (np.linalg.norm(acc - exact, axis=1)
           / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))
    assert np.isfinite(acc).all()
    assert np.percentile(err, 99) < 5e-2, np.percentile(err, 99)


def test_suggest_hier_caps_are_sufficient():
    """The planner's capacities must hold the uncapped demand with
    margin (no silent far shedding on the distribution it planned)."""
    pos, mass = _sorted_plummer(8192, seed=7)
    kw = dict(tile=128, src_tile=64, vip_tiles=128,
              mac_tau=tc.DEFAULT_HIER_TAU, eps2=EPS2, compensate=COMP)
    caps = tc.suggest_hier(pos, mass, **kw)
    near, far = tc.hier_counts(pos, mass, **kw)
    near = np.asarray(near)
    far = np.asarray(far)
    entries = tc.CHUNK_LANES // 64
    assert caps["max_near"] >= near.max()
    assert caps["far_max"] >= far.max()
    v = np.maximum(((near + 8 + entries - 1) // entries) * entries, entries)
    assert caps["flat_cap"] >= v.sum()
    w = np.maximum(((far + tc.FAR_ENTRIES - 1) // tc.FAR_ENTRIES)
                   * tc.FAR_ENTRIES, tc.FAR_ENTRIES)
    assert caps["far_cap"] >= w.sum()


def test_hier_simulation_end_to_end():
    """Full Simulation wiring: explicit flat+far caps enable the
    hierarchical scanned run on CPU; auto-planning fills the rest; the
    trajectory stays close to the exact solver over a short span."""
    from n_body_problem_tpu import SimConfig, Simulation

    n = 4096
    cfg = SimConfig(solver="treecode", tree_flat_cap=64 * 32 * 4,
                    tree_far_cap=32 * tc.FAR_ENTRIES * 8,
                    tree_vip_tiles=8, tree_rebuild_every=4, donate=False)
    st = models.plummer(n, seed=11)
    sim = Simulation(cfg, st)
    assert sim.cfg.tree_tile == tc.DEFAULT_HIER_TILE
    assert sim.cfg.tree_far_max > 0 and sim.cfg.tree_max_near > 0
    sim.run(8)
    assert np.isfinite(np.asarray(sim.state.pos)).all()

    ref = Simulation(SimConfig(solver="direct", donate=False),
                     models.plummer(n, seed=11))
    ref.run(8)
    inv = np.empty(n, int)
    inv[np.asarray(sim.sort_perm)] = np.arange(n)
    delta = np.abs(np.asarray(sim.state.pos[:n])[inv]
                   - np.asarray(ref.state.pos[:n])).max()
    assert delta < 1e-3, delta


def test_hier_work_beats_flat_at_matched_error():
    """VERDICT r2 #1 'done' criterion, CI-checkable half: the structural
    properties behind the measured speedups (docs/acceptance.md).

    With the hybrid acceptance (flat criterion at level 0, guarded
    octupole MAC above), at each path's calibrated default tolerance:

    * FAR COMPRESSION: hierarchical far evals per body stay well below
      the flat path's structural K_s-per-body sweep — this is the term
      that made the flat path O(N^2/64) and is the entire point of the
      hierarchy. (Compression deepens with N: 0.62x K_s at 65k, 0.38x
      at 262k measured on this distribution.)
    * BOUNDED NEAR INFLATION: the hierarchical near boundary at
      128-body target rows uses the SAME level-0 criterion as the flat
      path, so its near count may exceed the flat path's 32-row count
      only by the row-union conservatism (wider rows take a min over
      4x more bodies), measured ~1.3x — not by criterion drift.

    Total-step wins are measured on the chip (the far kernel is ~4.3x
    the per-unit cost of a near unit and kernel efficiencies differ by
    tile width); CI guards the structure that produces them.
    """
    n, src = 65536, 64
    pos, mass = _sorted_plummer(n, seed=8)
    k_s = n // src
    vip = max(16, min(128, n // 2048))

    near_h, far_h = tc.hier_counts(
        pos, mass, tile=128, src_tile=src, vip_tiles=vip,
        mac_tau=tc.DEFAULT_HIER_TAU, mac_tau0=tc.DEFAULT_MAC_TAU,
        eps2=EPS2, compensate=COMP)
    near_f = tc.open_counts(
        pos, mass, tile=32, src_tile=src, vip_tiles=vip,
        mac_tau=tc.DEFAULT_MAC_TAU, eps2=EPS2, compensate=COMP)

    far_per_body = float(jnp.mean(far_h))
    assert far_per_body < 0.7 * k_s, (far_per_body, k_s)
    ratio = float(jnp.mean(near_h)) / float(jnp.mean(near_f))
    assert ratio < 1.4, ratio
    # and at 32-body rows the level-0 criterion must MATCH the flat
    # path's near boundary exactly (same score, same threshold).
    near_h32, _ = tc.hier_counts(
        pos, mass, tile=32, src_tile=src, vip_tiles=vip,
        mac_tau=tc.DEFAULT_HIER_TAU, mac_tau0=tc.DEFAULT_MAC_TAU,
        eps2=EPS2, compensate=COMP)
    match = float(jnp.mean(near_h32)) / float(jnp.mean(near_f))
    assert 0.98 < match < 1.02, match


def test_union_coarse_shrinks_far_lists():
    """Per-body-union coarse distances (tree_hier_union, the default)
    must strictly reduce far work vs the com-minus-row-radius bound —
    the bound collapses for wide halo target rows (min_d <= 0 against
    every node opens the whole tree to the leaves). Census at N=262k:
    mean far -26%, worst row -60% (docs/acceptance.md)."""
    pos, mass = _sorted_plummer(8192, seed=3)
    kw = dict(tile=128, src_tile=64, vip_tiles=64,
              mac_tau=tc.DEFAULT_HIER_TAU, eps2=EPS2, compensate=COMP)
    near_b, far_b = tc.hier_counts(pos, mass, union_coarse=False, **kw)
    near_u, far_u = tc.hier_counts(pos, mass, union_coarse=True, **kw)
    far_b, far_u = np.asarray(far_b), np.asarray(far_u)
    # The exact union distance can only be >= the bound, so acceptance
    # can only move UP the tree: fewer far evals, never more.
    assert far_u.mean() < far_b.mean()
    assert far_u.max() <= far_b.max()
    # Near work must not grow (level 0 already used unions; coarse
    # accepts can only remove leaves from the reach set).
    assert np.asarray(near_u).mean() <= np.asarray(near_b).mean() + 1e-9


def test_union_coarse_error_envelope():
    """The union-coarse acceptance must hold the same force-error class
    as the bound-based one (accepts are still guarded by the octupole
    (d-r)^5 criterion; only the distance estimate got exact)."""
    n = 8192
    pos, mass = _sorted_plummer(n, seed=11)
    kw = dict(tile=128, src_tile=64, vip_tiles=64, theta=0.55,
              mac_tau=tc.DEFAULT_HIER_TAU, eps2=EPS2, compensate=COMP)
    aux, caps = _hier_aux(pos, mass, union_coarse=True, **kw)
    acc = _hier_acc(pos, mass, aux, caps,
                    **{k: kw[k] for k in ("tile", "src_tile", "vip_tiles",
                                          "theta", "compensate")})
    exact = np.asarray(direct_acc(pos, mass, eps2=EPS2, compensate=COMP))
    err = (np.linalg.norm(acc - exact, axis=1)
           / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))
    assert np.percentile(err, 99) < 2e-3
    assert np.median(err) < 3e-4


@pytest.mark.parametrize("block", [1, 7])
def test_far_hier_blocking_is_exact(block):
    """The XLA far field evaluates the compacted far list in blocks of
    chunks and sums each target row's chunks in a fixed order afterwards;
    any block size must give bit-for-bit the one-block result."""
    n = 4096
    pos, mass = _sorted_plummer(n, seed=3)
    kw = dict(tile=128, src_tile=64, vip_tiles=8, theta=0.55,
              mac_tau=tc.DEFAULT_HIER_TAU, eps2=EPS2, compensate=COMP)
    aux, caps = _hier_aux(pos, mass, union_coarse=True, **kw)
    _, _, far_src, far_tgt, is_vip = aux
    xc, yc, zc = pos[:, 0], pos[:, 1], pos[:, 2]
    plan = tc._level_plan(n // 64)
    levels = tc._level_summaries(xc, yc, zc, jnp.where(is_vip, 0.0, mass),
                                 64, plan, tc.HIER_BRANCH)
    summ = tc._summary_panel(levels)
    args = dict(eps2=EPS2, c2=COMP * COMP, G=1.0, tile=128,
                max_chunks=caps["far_max"] // tc.FAR_ENTRIES)
    one = tc._far_field_hier_xla(xc, yc, zc, summ, far_src, far_tgt,
                                  block=far_tgt.shape[0], **args)
    got = tc._far_field_hier_xla(xc, yc, zc, summ, far_src, far_tgt,
                                  block=block, **args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(one))
