"""The GPU kernels (Pallas, Triton) against their plain references.

On the CPU the kernels run through the Pallas interpreter and are lowered
for CUDA (Triton IR), which catches what the lowering refuses. The
``gpu``-marked tests compile them for the card and skip elsewhere
(``JAX_PLATFORMS=cuda python -m pytest -m gpu``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from n_body_problem_tpu import models, pad_state
from n_body_problem_tpu.ops import direct_acc
from n_body_problem_tpu.ops import treecode as tc
from n_body_problem_tpu.ops.pallas_force import pair_block_cols, pallas_acc
from n_body_problem_tpu.plan import execution_plan
from n_body_problem_tpu.utils.morton import apply_permutation, morton_argsort

EPS2 = 1e-6
C = 0.1
C2 = C * C


def _sorted_plummer(n, seed=0):
    st = models.plummer(n, seed=seed)
    return apply_permutation(st, morton_argsort(np.asarray(st.pos)))


def _cols(st):
    return st.pos[:, 0], st.pos[:, 1], st.pos[:, 2]


def _flat_lists(st, tile, src_tile=64, vip_tiles=0):
    """Production flat or hierarchical near lists for a sorted state."""
    if tile == 128:
        caps = tc.suggest_hier(st.pos, st.mass, tile=128, src_tile=src_tile,
                               vip_tiles=vip_tiles)
        flat_src, chunk_tgt, _, _, _ = tc.build_tree_hier_cols(
            *_cols(st), st.mass, tile=128, src_tile=src_tile,
            vip_tiles=vip_tiles, max_near=caps["max_near"],
            flat_cap=caps["flat_cap"], far_max=caps["far_max"],
            far_cap=caps["far_cap"])
        return flat_src, chunk_tgt, caps["max_near"]
    max_near = tc.suggest_max_near(st.pos, st.mass, tile=tile,
                                   src_tile=src_tile, vip_tiles=vip_tiles,
                                   mac_tau=2e-4)
    cap = tc.suggest_flat_cap(st.pos, st.mass, tile=tile, src_tile=src_tile,
                              vip_tiles=vip_tiles, mac_tau=2e-4)
    flat_src, chunk_tgt, _, _ = tc.build_tree_flat(
        st.pos, st.mass, tile=tile, src_tile=src_tile, max_near=max_near,
        vip_tiles=vip_tiles, flat_cap=cap, mac_tau=2e-4)
    entries = tc.CHUNK_LANES // src_tile
    return flat_src, chunk_tgt, max(-(-max_near // entries) * entries,
                                    entries)


# ------------------------------------------------------ all-pairs kernel
@pytest.mark.parametrize("tile_i,tile_j", [(64, 64), (32, 128), (128, 32)])
def test_pair_kernel_matches_direct(tile_i, tile_j):
    st = pad_state(models.plummer(300, seed=7), multiple=128)
    want = direct_acc(st.pos, st.mass, eps2=EPS2, compensate=C)
    got = pallas_acc(st.pos, st.mass, eps2=EPS2, compensate=C,
                     tile_i=tile_i, tile_j=tile_j, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-6)


def test_pair_kernel_blocks_of_different_sizes():
    """Rows and columns are different blocks (a ring stage; a VIP sweep),
    with zero-mass padding in the column block."""
    rows = models.plummer(192, seed=1)
    cols = pad_state(models.plummer(200, seed=2), multiple=64)   # 256
    scaled = cols.mass * (C2 * C)
    got = pair_block_cols(*_cols(rows), *_cols(cols), scaled, eps2=EPS2,
                          c2=C2, interpret=True)
    want = tc._dense_sweep_cols(*_cols(rows), *_cols(cols), scaled,
                                eps2=EPS2, c2=C2)
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("splits", [None, 1, 4])
def test_pair_kernel_column_splits(splits):
    """Few row blocks against many columns (the VIP reaction): the
    columns split across programs and the partials add up to the same
    sums."""
    rows = models.plummer(64, seed=3)
    cols = models.plummer(1024, seed=4)
    scaled = cols.mass * (C2 * C)
    got = pair_block_cols(*_cols(rows), *_cols(cols), scaled, eps2=EPS2,
                          c2=C2, splits=splits, interpret=True)
    want = tc._dense_sweep_cols(*_cols(rows), *_cols(cols), scaled,
                                eps2=EPS2, c2=C2)
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1),
                               rtol=1e-5, atol=1e-7)


def test_pair_kernel_rejects_misaligned():
    st = models.plummer(100, seed=0)
    with pytest.raises(ValueError):
        pallas_acc(st.pos, st.mass, eps2=EPS2, interpret=True)


# ---------------------------------------------------- near-field kernel
@pytest.mark.parametrize("tile", [32, 128])
def test_near_kernel_matches_xla_on_production_lists(tile):
    """tile=32: a program's row block is the whole (ragged, narrower than
    NEAR_ROWS) target row; tile=128: two programs per target row. The
    hierarchical lists carry sentinel entries (leaves under an accepted
    ancestor) and a sentinel tail."""
    st = _sorted_plummer(8192, seed=5)
    flat_src, chunk_tgt, max_near = _flat_lists(st, tile)
    src = tc._source_cols(*_cols(st), st.mass * (C2 * C), 64)
    kw = dict(eps2=EPS2, c2=C2, tile=tile, src_tile=64)
    got = tc._near_field_flat_kernel(*_cols(st), src, flat_src, chunk_tgt,
                                     interpret=True, **kw)
    want = tc._near_field_flat_xla(*_cols(st), src, flat_src, chunk_tgt,
                                   max_chunks=max_near // 32, **kw)
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_near_kernel_sentinel_tail_and_empty_rows():
    """Hand-built list: row 0 has two chunks (one entry points at the
    zero sentinel tile), row 1 has none (an empty list), row 2 one chunk,
    then two sentinel-tail chunks tagged K_t that belong to no row."""
    n, tile, src_tile = 96, 32, 1024          # 3 target rows, E = 2
    st = models.plummer(n, seed=9)
    xs = jnp.concatenate([st.pos[:, 0], jnp.zeros(2048 - n)])
    ys = jnp.concatenate([st.pos[:, 1], jnp.zeros(2048 - n)])
    zs = jnp.concatenate([st.pos[:, 2], jnp.zeros(2048 - n)])
    ms = jnp.concatenate([st.mass, jnp.zeros(2048 - n)])
    # two 1024-body source tiles (bodies 0..95 live in tile 0) + sentinel
    src = tc._source_cols(xs, ys, zs, ms * (C2 * C), src_tile)
    k_s = 2
    chunk_tgt = jnp.array([0, 0, 2, 3, 3], jnp.int32)
    flat_src = jnp.array([0, k_s, 1, k_s, 0, 1, k_s, k_s, k_s, k_s],
                         jnp.int32)
    kw = dict(eps2=EPS2, c2=C2, tile=tile, src_tile=src_tile)
    got = np.stack(tc._near_field_flat_kernel(
        *_cols(st), src, flat_src, chunk_tgt, interpret=True, **kw), 1)
    want = np.stack(tc._near_field_flat_xla(
        *_cols(st), src, flat_src, chunk_tgt, max_chunks=2, **kw), 1)
    exact = np.asarray(direct_acc(st.pos, st.mass, eps2=EPS2, compensate=C))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # rows 0 and 2 see all bodies (tile 0 once); row 1 sees nothing
    np.testing.assert_allclose(got[:32], exact[:32], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[64:], exact[64:], rtol=1e-5, atol=1e-7)
    assert not got[32:64].any()


# ----------------------------------------------------- far-field kernel
def _far_lists(st, tile=128):
    caps = tc.suggest_hier(st.pos, st.mass, tile=tile, src_tile=64,
                           vip_tiles=16)
    _, _, far_src, far_tgt, is_vip = tc.build_tree_hier_cols(
        *_cols(st), st.mass, tile=tile, src_tile=64, vip_tiles=16,
        max_near=caps["max_near"], flat_cap=caps["flat_cap"],
        far_max=caps["far_max"], far_cap=caps["far_cap"])
    k_s = st.n // 64
    levels = tc._level_summaries(*_cols(st), jnp.where(is_vip, 0.0, st.mass),
                                 64, tc._level_plan(k_s), tc.HIER_BRANCH)
    return (tc._summary_panel(levels), far_src, far_tgt,
            -(-caps["far_max"] // tc.FAR_ENTRIES))


@pytest.mark.parametrize("tile", [32, 128])
def test_far_kernel_matches_xla_on_production_lists(tile):
    """Multi-level far lists with sentinel entries (massless, shed or
    padding slots point at the zero summary row) and a sentinel tail;
    tile=32 rows are narrower than one program's block."""
    st = _sorted_plummer(8192, seed=7)
    summ, far_src, far_tgt, max_chunks = _far_lists(st, tile)
    kw = dict(eps2=EPS2, c2=C2, G=1.0, tile=tile)
    got = np.stack(tc._far_field_hier_kernel(
        *_cols(st), summ, far_src, far_tgt, interpret=True, **kw), 1)
    want = np.stack(tc._far_field_hier_xla(
        *_cols(st), summ, far_src, far_tgt, max_chunks=max_chunks, **kw), 1)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_far_kernel_empty_rows():
    """A row with no far chunks gets exactly zero."""
    st = _sorted_plummer(4096, seed=8)
    summ, far_src, far_tgt, _ = _far_lists(st)
    k_t, e = 4096 // 128, tc.FAR_ENTRIES
    ft, fs = np.asarray(far_tgt), np.asarray(far_src).reshape(-1, e)
    keep = ft != 3                                # drop row 3's chunks
    pad = int((~keep).sum())
    ft = np.concatenate([ft[keep], np.full(pad, k_t)])
    fs = np.concatenate([fs[keep], np.full((pad, e), summ.shape[0] - 1)])
    kw = dict(eps2=EPS2, c2=C2, G=1.0, tile=128)
    got = np.stack(tc._far_field_hier_kernel(
        *_cols(st), summ, jnp.asarray(fs.reshape(-1)), jnp.asarray(ft),
        interpret=True, **kw), 1)
    full = np.stack(tc._far_field_hier_kernel(
        *_cols(st), summ, far_src, far_tgt, interpret=True, **kw), 1)
    assert pad and not got[3 * 128:4 * 128].any()
    np.testing.assert_array_equal(got[:3 * 128], full[:3 * 128])
    np.testing.assert_array_equal(got[4 * 128:], full[4 * 128:])


# ------------------------------------------- plain references vs dense
def test_flat_near_reference_matches_direct():
    """With every source tile listed for every row, the XLA near field
    is the exact direct sum."""
    st = _sorted_plummer(2048, seed=4)
    k_t, k_s, e = 2048 // 32, 2048 // 64, 32
    chunk_tgt = jnp.repeat(jnp.arange(k_t, dtype=jnp.int32), k_s // e)
    flat_src = jnp.tile(jnp.arange(k_s, dtype=jnp.int32), k_t)
    src = tc._source_cols(*_cols(st), st.mass * (C2 * C), 64)
    got = tc._near_field_flat_xla(*_cols(st), src, flat_src, chunk_tgt,
                                  eps2=EPS2, c2=C2, tile=32, src_tile=64,
                                  max_chunks=1)
    want = direct_acc(st.pos, st.mass, eps2=EPS2, compensate=C)
    np.testing.assert_allclose(np.stack(got, 1), np.asarray(want),
                               rtol=1e-4, atol=2e-6)


def test_hier_far_reference_matches_dense_far():
    """A far list holding every level-0 tile for every row evaluates the
    same multipoles as the dense single-level far field with an empty
    near mask."""
    st = _sorted_plummer(4096, seed=6)
    k_t, k_s = 4096 // 128, 4096 // 64
    levels = tc._level_summaries(*_cols(st), st.mass, 64, (k_s,), 2)
    summ = tc._summary_panel(levels)
    per_row = k_s // tc.FAR_ENTRIES
    far_tgt = jnp.repeat(jnp.arange(k_t, dtype=jnp.int32), per_row)
    far_src = jnp.tile(jnp.arange(k_s, dtype=jnp.int32), k_t)
    got = tc._far_field_hier_xla(*_cols(st), summ, far_src, far_tgt,
                                  eps2=EPS2, c2=C2, G=1.0, tile=128,
                                  max_chunks=per_row)
    com, m_tot, _, quad = tc.tile_summaries(st.pos, st.mass, 64)
    want = tc._far_field_cols(*_cols(st), com, m_tot, quad,
                              jnp.zeros((k_t, k_s), bool), eps2=EPS2, c2=C2,
                              G=1.0, tile=128)
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1),
                               rtol=1e-4, atol=1e-6)


def test_vip_reference_matches_pair_tile():
    """The VIP sweep's XLA form (both directions) is the direct pair sum."""
    from n_body_problem_tpu.ops.forces import pair_accel_tile

    st = models.plummer(512, seed=8)
    vip = slice(128, 192)
    scaled = st.mass * (C2 * C)
    action, react = tc._vip_sweep_cols(
        *_cols(st), scaled, st.pos[vip, 0], st.pos[vip, 1], st.pos[vip, 2],
        scaled[vip], eps2=EPS2, c2=C2, plan=execution_plan("cpu"))
    want_a = pair_accel_tile(st.pos, st.pos[vip], st.mass[vip], eps2=EPS2,
                             compensate=C)
    want_r = pair_accel_tile(st.pos[vip], st.pos, st.mass, eps2=EPS2,
                             compensate=C)
    np.testing.assert_allclose(np.stack(action, 1), np.asarray(want_a),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.stack(react, 1), np.asarray(want_r),
                               rtol=1e-5, atol=1e-7)


# ------------------------------------------------ lowering for the card
def _lower_for_cuda(fn, *args):
    lowered = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text().lower()


def test_pair_kernel_lowers_for_cuda():
    st = pad_state(models.plummer(256, seed=0), multiple=64)
    _lower_for_cuda(lambda p, m: pallas_acc(p, m, eps2=EPS2), st.pos,
                    st.mass)


def test_near_kernel_lowers_for_cuda():
    st = _sorted_plummer(4096, seed=2)
    flat_src, chunk_tgt, _ = _flat_lists(st, 128)
    src = tc._source_cols(*_cols(st), st.mass, 64)
    _lower_for_cuda(
        lambda x, y, z, s, fs, ct: tc._near_field_flat_kernel(
            x, y, z, s, fs, ct, eps2=EPS2, c2=C2, tile=128, src_tile=64),
        *_cols(st), src, flat_src, chunk_tgt)


def test_far_kernel_lowers_for_cuda():
    st = _sorted_plummer(4096, seed=2)
    summ, far_src, far_tgt, _ = _far_lists(st)
    _lower_for_cuda(
        lambda x, y, z, s, fs, ft: tc._far_field_hier_kernel(
            x, y, z, s, fs, ft, eps2=EPS2, c2=C2, G=1.0, tile=128),
        *_cols(st), summ, far_src, far_tgt)


# --------------------------------------------------------- on the card
@pytest.mark.gpu
def test_pair_kernel_on_gpu(gpu):
    st = pad_state(models.plummer(8192, seed=1), multiple=64)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(direct_acc(st.pos, st.mass, eps2=EPS2))
    got = np.asarray(pallas_acc(st.pos, st.mass, eps2=EPS2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [32, 128])
def test_near_kernel_on_gpu(gpu, tile):
    st = _sorted_plummer(65536, seed=5)
    flat_src, chunk_tgt, max_near = _flat_lists(st, tile, vip_tiles=32)
    src = tc._source_cols(*_cols(st), st.mass * (C2 * C), 64)
    kw = dict(eps2=EPS2, c2=C2, tile=tile, src_tile=64)
    got = np.stack(tc._near_field_flat_kernel(
        *_cols(st), src, flat_src, chunk_tgt, **kw), 1)
    want = np.stack(tc._near_field_flat_xla(
        *_cols(st), src, flat_src, chunk_tgt, max_chunks=max_near // 32,
        **kw), 1)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.gpu
def test_far_kernel_on_gpu(gpu):
    st = _sorted_plummer(65536, seed=5)
    summ, far_src, far_tgt, max_chunks = _far_lists(st)
    kw = dict(eps2=EPS2, c2=C2, G=1.0, tile=128)
    got = np.stack(tc._far_field_hier_kernel(
        *_cols(st), summ, far_src, far_tgt, **kw), 1)
    want = np.stack(tc._far_field_hier_xla(
        *_cols(st), summ, far_src, far_tgt, max_chunks=max_chunks, **kw), 1)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.gpu
def test_gpu_plan_simulation_matches_xla_forms(gpu):
    """The hierarchical treecode with the GPU plan's kernels == the same
    run with every stage in its XLA form, on the card."""
    from n_body_problem_tpu import SimConfig, Simulation
    from n_body_problem_tpu.plan import XLA

    plan = execution_plan()
    a = Simulation(SimConfig(solver="treecode"),
                   models.plummer(65536, seed=3), plan=plan)
    assert a.tree_variant == "hier"
    b = Simulation(a.cfg, models.plummer(65536, seed=3),
                   plan=dataclasses.replace(plan, near=XLA, far=XLA,
                                            pair=XLA))
    a.run(8)
    b.run(8)
    np.testing.assert_allclose(np.asarray(a.state.pos),
                               np.asarray(b.state.pos), rtol=5e-4,
                               atol=5e-5)
