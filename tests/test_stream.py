"""Staged source streaming (parallel/stream.py) on the 8-fake-device mesh.

The capacity-scaling strategy: source panels ppermute ring-wise instead
of being all_gather-replicated; only tile summaries (and the W-body VIP
panel) replicate. Validated against the single-chip flat/hier treecode
(whose equality with the replicated sharded path is separately pinned in
test_parallel.py).

Equality regimes:
- exact limit (theta -> 0, mac_tau = 0): every tile opens on both sides,
  identical near sets, empty far field — agreement to accumulation-order
  rounding (the strongest pin; covers the ring scan, the per-shard
  compaction plumbing, and the VIP psum panel/reaction machinery).
- production MAC: the staged per-SOURCE-SHARD compaction may promote
  different rounding extras to exact evaluation than the single-chip
  global compaction — a difference bounded by the multipole truncation
  error of borderline-acceptable tiles, an order under the solver's own
  force-error envelope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from n_body_problem_tpu import SimConfig, Simulation, models
from n_body_problem_tpu.parallel import make_ring_mesh
from n_body_problem_tpu.parallel.stream import make_staged_force
from n_body_problem_tpu.utils.morton import device_resort


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 fake devices"
    return make_ring_mesh(8)


def _sorted_state(n, seed=7):
    st = models.plummer(n, seed=seed)
    st, _ = device_resort(st, jnp.arange(n, dtype=jnp.int32))
    return st


def _single_chip_flat(cfg, st, vip_tiles=0):
    from n_body_problem_tpu.ops.treecode import (
        build_tree_flat_cols,
        treecode_acc_flat_cols,
    )

    xc, yc, zc = st.pos[:, 0], st.pos[:, 1], st.pos[:, 2]
    sel = dict(tile=cfg.tree_tile, theta=cfg.tree_theta,
               max_near=cfg.tree_max_near, vip_tiles=vip_tiles)
    aux = build_tree_flat_cols(
        xc, yc, zc, st.mass, src_tile=cfg.tree_src_tile,
        slack=cfg.tree_near_slack, flat_cap=cfg.tree_flat_cap * 8,
        mac_tau=cfg.tree_mac_tau, eps2=cfg.eps2,
        compensate=cfg.compensate, **sel)
    ax, ay, az = treecode_acc_flat_cols(
        xc, yc, zc, st.mass, aux, src_tile=cfg.tree_src_tile,
        eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G, **sel)
    return np.stack([np.asarray(ax), np.asarray(ay), np.asarray(az)],
                    axis=1)


def _single_chip_hier(cfg, st, far_max, far_cap):
    from n_body_problem_tpu.ops.treecode import (
        build_tree_hier_cols,
        treecode_acc_hier_cols,
    )

    xc, yc, zc = st.pos[:, 0], st.pos[:, 1], st.pos[:, 2]
    sel = dict(tile=cfg.tree_tile, src_tile=cfg.tree_src_tile,
               theta=cfg.tree_theta, max_near=cfg.tree_max_near,
               vip_tiles=cfg.tree_vip_tiles)
    aux = build_tree_hier_cols(
        xc, yc, zc, st.mass, slack=cfg.tree_near_slack,
        flat_cap=cfg.tree_flat_cap * 8, far_max=far_max, far_cap=far_cap,
        mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau,
        eps2=cfg.eps2, compensate=cfg.compensate,
        union_coarse=cfg.tree_hier_union, **sel)
    ax, ay, az = treecode_acc_hier_cols(
        xc, yc, zc, st.mass, aux, eps2=cfg.eps2,
        compensate=cfg.compensate, G=cfg.G, far_max=far_max, **sel)
    return np.stack([np.asarray(ax), np.asarray(ay), np.asarray(az)],
                    axis=1)


def test_staged_exact_limit_matches_single_chip(mesh):
    """theta -> 0 opens every tile on both sides: identical near sets,
    empty far field — the staged ring sum must equal the single-chip
    flat sum to accumulation-order rounding."""
    n = 16384
    st = _sorted_state(n)
    cfg = SimConfig(solver="treecode", tree_tile=128, tree_src_tile=128,
                    tree_theta=1e-30, tree_mac_tau=0.0, tree_max_near=2048,
                    tree_near_slack=0, tree_vip_tiles=0,
                    tree_flat_cap=16 * 128, tree_hier=False)
    force = make_staged_force(cfg, mesh)
    got = np.asarray(jax.jit(force)(st.pos, st.mass))
    want = _single_chip_flat(cfg, st)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-5,
                               atol=2e-6 * scale)


def test_staged_vip_exact_limit_matches_single_chip(mesh):
    """VIP promotion in the exact limit: the globally-selected
    largest-radius tiles leave the tree (mass zeroed), replicate as a
    psum'd panel, and get their complete pull from the psum'd reaction
    rows — must match the single-chip VIP split to rounding."""
    n = 16384
    st = _sorted_state(n, seed=17)
    cfg = SimConfig(solver="treecode", tree_tile=128, tree_src_tile=128,
                    tree_theta=1e-30, tree_mac_tau=0.0, tree_max_near=2048,
                    tree_near_slack=0, tree_vip_tiles=8,
                    tree_flat_cap=16 * 128, tree_hier=False)
    force = make_staged_force(cfg, mesh)
    got = np.asarray(jax.jit(force)(st.pos, st.mass))
    want = _single_chip_flat(cfg, st, vip_tiles=8)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-5,
                               atol=2e-6 * scale)


def test_staged_production_tau_matches_single_chip(mesh):
    """At the production MAC the staged per-shard compaction may promote
    different slack/rounding extras to exact evaluation than the global
    compaction — a difference bounded by the multipole truncation error
    of borderline-acceptable tiles. Per-body relative agreement must stay
    an order under the solver's own force-error envelope."""
    n = 16384
    st = _sorted_state(n, seed=11)
    cfg = SimConfig(solver="treecode", tree_tile=128, tree_src_tile=128,
                    tree_theta=0.55, tree_mac_tau=2e-4, tree_max_near=512,
                    tree_near_slack=4, tree_vip_tiles=0,
                    tree_flat_cap=16 * 128, tree_hier=False)
    force = make_staged_force(cfg, mesh)
    got = np.asarray(jax.jit(force)(st.pos, st.mass))[:n]
    want = _single_chip_flat(cfg, st)[:n]
    rel = (np.linalg.norm(got - want, axis=1)
           / np.maximum(np.linalg.norm(want, axis=1), 1e-12))
    # Measured: p99 3.1e-4 (the promoted extras' truncation error) — in
    # the solver's own ~5e-4 p99 force-error class, an order under the
    # positions-equality bar used by the sharded tests.
    assert np.percentile(rel, 99) < 8e-4, np.percentile(rel, 99)
    assert rel.max() < 8e-3, rel.max()


def test_staged_hier_matches_single_chip(mesh):
    """Hierarchical far field from REPLICATED SUMMARIES: level 0 builds
    per shard, the gathered summaries merge into the same branch-2
    hierarchy on every chip (no position replication), and the a_med
    normalization medians the identical global sample. Production-tau
    agreement with the single-chip hier solver inside the borderline
    truncation envelope; VIP on."""
    n = 16384
    st = _sorted_state(n, seed=29)
    k_t_l = (n // 8) // 128
    cfg = SimConfig(solver="treecode", tree_tile=128, tree_src_tile=128,
                    tree_theta=0.55, tree_mac_tau=2e-4, tree_max_near=512,
                    tree_near_slack=0, tree_vip_tiles=8,
                    tree_flat_cap=16 * 128, tree_hier=True,
                    tree_far_max=64, tree_far_cap=k_t_l * 64)
    force = make_staged_force(cfg, mesh)
    got = np.asarray(jax.jit(force)(st.pos, st.mass))[:n]
    want = _single_chip_hier(cfg, st, far_max=64,
                             far_cap=(n // 128) * 64)[:n]
    rel = (np.linalg.norm(got - want, axis=1)
           / np.maximum(np.linalg.norm(want, axis=1), 1e-12))
    assert np.percentile(rel, 99) < 8e-4, np.percentile(rel, 99)
    assert rel.max() < 8e-3, rel.max()


def test_staged_run_matches_single_chip(mesh):
    """End-to-end ShardedSimulation(strategy="treecode_staged"): chunked
    global resort + per-chunk staged build + scanned ring-streamed steps
    must track the single-chip flat run. slack=0 on both sides so the
    only acceptance difference is the per-shard vs global rounding of
    chunk-entry extras (exact-vs-multipole borderline tiles); position
    agreement over 8 steps (resort fires mid-run at rebuild_every=4)
    stays within the force-envelope integration bound."""
    from n_body_problem_tpu.parallel.sharded import ShardedSimulation

    n = 16384
    cfg = SimConfig(solver="treecode", tree_tile=128, tree_src_tile=128,
                    tree_theta=0.55, tree_mac_tau=2e-4, tree_near_slack=0,
                    tree_vip_tiles=8, tree_rebuild_every=4,
                    tree_hier=False, tree_max_near=16,
                    tree_flat_cap=16 * 16)
    ssim = ShardedSimulation(cfg, models.plummer(n, seed=43), mesh,
                             strategy="treecode_staged")
    ssim.run(8)
    # Single chip: unclamped global near list (max_near = K_s = 128).
    ref = Simulation(
        cfg.replace(tree_max_near=128, tree_flat_cap=(n // 128) * 128),
        models.plummer(n, seed=43))
    ref.run(8)
    a = np.asarray(ssim.state.pos[:n])
    b = np.asarray(ref.state.pos[:n])
    inv_a = np.empty(n, int); inv_a[ssim.sort_perm] = np.arange(n)
    inv_b = np.empty(n, int); inv_b[ref.sort_perm] = np.arange(n)
    np.testing.assert_allclose(a[inv_a], b[inv_b], rtol=5e-4, atol=5e-5)
    d = ssim.diagnostics()
    assert d["overspeed"] == 0 and np.isfinite(d["energy"])


def test_staged_rejects_undersized_shard(mesh):
    """ADVICE r4 (medium): with fewer per-shard source tiles than chunk
    entries, _compact_open_lists would emit ZERO near chunks per row and
    the self tile would silently fall into the far field as a
    self-multipole at d~0 — the guard must fail loudly at trace time."""
    n = 8192  # N/D = 1024 -> 16 source tiles of 64 < 32 entries
    st = _sorted_state(n, seed=13)
    cfg = SimConfig(solver="treecode", tree_tile=32, tree_src_tile=64,
                    tree_theta=0.55, tree_max_near=64, tree_vip_tiles=0,
                    tree_near_slack=0, tree_flat_cap=4096, tree_hier=False)
    force = make_staged_force(cfg, mesh)
    with pytest.raises(ValueError, match="K_src >= entries"):
        jax.jit(force)(st.pos, st.mass)
