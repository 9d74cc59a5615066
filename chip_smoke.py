"""Smoke test of the whole program on NVIDIA GPUs, in one process.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-device phase only

Phases (one card):

1. device: platform, device kind and count as JAX reports them, and the
   card's name and power limit from ``nvidia-smi``. Anything but a GPU
   fails here.
2. kernels: every hand-written GPU kernel compiled at real widths and
   compared with its plain reference (the all-pairs kernel at N=65,536
   against the direct sum; the near-field and far-field kernels at
   N=1,048,576 on the production lists against their XLA forms), with
   each compiled program's ``memory_analysis()``.
3. treecode: ``python -m n_body_problem_tpu run --model plummer --n
   1048576 --solver treecode --steps 64 --render-every 32 --diag-every 64``
   through the CLI's own ``main`` in this process; positions finite,
   overspeed 0, the hierarchical list path taken, p99 force error on
   2,048 sampled bodies against the exact sum <= 2e-3. Prints ms/step
   (informational) beside the card's name and power limit.
4. exact: ``solver="auto"`` at N=65,536 for 4 steps against the direct
   sum evaluated row-blocked (``solver="blocked"``).
5. gpu tests: ``pytest -m gpu`` in this process.

``--four`` runs ``ShardedSimulation`` over four cards with ``ring`` and
``half_ring`` at N=262,144 and ``treecode`` and ``treecode_staged`` at
N=1,048,576, each against the one-card ``Simulation`` of the same
problem, and checks that the shards sit on four distinct devices.

Any failed phase makes the exit code nonzero. On success the last line of
standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent

# Tolerances (docs/numerics.md): kernels against their references, and the
# sharded runs against the one-card run of the same problem.
PAIR_TOL = 1e-4      # all-pairs kernel: max relative force error
LIST_TOL = 1e-5      # near/far kernels vs XLA forms: max |diff| / max |acc|
TREE_P99 = 2e-3      # treecode p99 relative force error (README class)
EXACT_RTOL, EXACT_ATOL = 2e-5, 1e-5    # exact runs: positions
TREE_RTOL, TREE_ATOL = 5e-4, 5e-5      # treecode runs: positions


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a successful run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def card_info() -> str:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e!r})"


def _rel_err(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want, axis=1)
            / np.maximum(np.linalg.norm(want, axis=1), 1e-30))


def _exact_rows(pos, mass, rows, cfg):
    """Exact accelerations of bodies ``rows`` from every body (float32
    direct sum, in row chunks)."""
    import jax
    import numpy as np

    from n_body_problem_tpu.ops.forces import pair_accel_tile

    f = jax.jit(lambda p, pa, m: pair_accel_tile(
        p, pa, m, eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G))
    step = 256
    with jax.default_matmul_precision("highest"):
        return np.concatenate([
            np.asarray(f(pos[rows[a:a + step]], pos, mass))
            for a in range(0, len(rows), step)])


def _memory(tag, fn, *args):
    comp = fn.lower(*args).compile()
    print(f"  {tag}: memory_analysis: {comp.memory_analysis()}")


def phase_kernels(n_exact: int = 65536, n_tree: int = 1 << 20, plan=None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from n_body_problem_tpu import SimConfig, Simulation, models, pad_state
    from n_body_problem_tpu.ops import treecode as tc
    from n_body_problem_tpu.ops.pallas_force import pallas_acc
    from n_body_problem_tpu.plan import execution_plan

    plan = plan or execution_plan()
    cfg = SimConfig()
    st = pad_state(models.plummer(n_exact, seed=0), multiple=64)
    f = jax.jit(lambda p, m: pallas_acc(p, m, eps2=cfg.eps2,
                                        compensate=cfg.compensate,
                                        interpret=plan.interpret))
    _memory(f"pair kernel N={n_exact}", f, st.pos, st.mass)
    rows = np.arange(0, st.n, max(st.n // 4096, 1))
    got = np.asarray(f(st.pos, st.mass))[rows]
    want = _exact_rows(st.pos, st.mass, rows, cfg)
    err = _rel_err(got, want)
    print(f"  pair kernel N={n_exact}: max rel force err {err.max():.3e} "
          f"(p99 {np.percentile(err, 99):.3e}, tol {PAIR_TOL:g})")
    assert err.max() <= PAIR_TOL

    sim = Simulation(SimConfig(solver="treecode"),
                     models.plummer(n_tree, seed=0), plan=plan)
    c = sim.cfg
    assert sim.tree_variant == "hier", sim.tree_variant
    x, y, z = (sim.state.pos[:, i] for i in range(3))
    m = sim.state.mass
    build = jax.jit(lambda x, y, z, m: tc.build_tree_hier_cols(
        x, y, z, m, tile=c.tree_tile, src_tile=c.tree_src_tile,
        theta=c.tree_theta, max_near=c.tree_max_near,
        vip_tiles=c.tree_vip_tiles, slack=c.tree_near_slack,
        flat_cap=c.tree_flat_cap, far_max=c.tree_far_max,
        far_cap=c.tree_far_cap, mac_tau=c.tree_hier_tau,
        mac_tau0=c.tree_mac_tau, union_coarse=c.tree_hier_union,
        eps2=c.eps2, compensate=c.compensate))
    flat_src, chunk_tgt, far_src, far_tgt, is_vip = build(x, y, z, m)
    m_tree = jnp.where(is_vip, 0.0, m)
    src = tc._source_cols(x, y, z, m_tree, c.tree_src_tile)
    summ = tc._summary_panel(tc._level_summaries(
        x, y, z, m_tree, c.tree_src_tile, tc._level_plan(
            sim.state.n // c.tree_src_tile), tc.HIER_BRANCH))
    entries = tc.CHUNK_LANES // c.tree_src_tile
    kw = dict(eps2=c.eps2, c2=c.compensate ** 2, tile=c.tree_tile)
    ikw = dict(interpret=plan.interpret)
    near = (tc._near_field_flat_kernel, functools.partial(
        tc._near_field_flat_xla, max_chunks=-(-c.tree_max_near // entries)),
        dict(kw, src_tile=c.tree_src_tile),
        (x, y, z, src, flat_src, chunk_tgt))
    far = (tc._far_field_hier_kernel, functools.partial(
        tc._far_field_hier_xla,
        max_chunks=-(-c.tree_far_max // tc.FAR_ENTRIES)),
        dict(kw, G=c.G), (x, y, z, summ, far_src, far_tgt))
    for tag, (kern, xla, fkw, args) in (("near", near), ("far", far)):
        fk = jax.jit(functools.partial(kern, **fkw, **ikw))
        fx = jax.jit(functools.partial(xla, **fkw))
        _memory(f"{tag} kernel N={n_tree}", fk, *args)
        a = np.stack([np.asarray(v) for v in fk(*args)], axis=1)
        b = np.stack([np.asarray(v) for v in fx(*args)], axis=1)
        err = np.abs(a - b).max() / np.abs(b).max()
        print(f"  {tag} kernel N={n_tree} ({int(args[-1].shape[0])} chunks):"
              f" max |diff| / max |acc| {err:.3e} (tol {LIST_TOL:g})")
        assert err <= LIST_TOL


def phase_treecode(out: pathlib.Path, card: str):
    import jax.numpy as jnp
    import numpy as np

    from n_body_problem_tpu import cli
    from n_body_problem_tpu.config import SimConfig
    from n_body_problem_tpu.io.checkpoint import load_checkpoint
    from n_body_problem_tpu.ops.registry import make_force_fn

    rc = cli.main(["run", "--model", "plummer", "--n", "1048576",
                   "--solver", "treecode", "--steps", "64",
                   "--render-every", "32", "--diag-every", "64",
                   "--width", "512", "--height", "384", "--out", str(out)])
    assert rc == 0, f"cli rc {rc}"
    run = json.loads((out / "run.json").read_text())
    state, _ = load_checkpoint(out / "final.npz")
    pos = np.asarray(state.pos)
    print(f"  hier path: {run['tree_variant']}, overspeed {run['overspeed']}"
          f", frames {len(list((out / 'frames').glob('*.png')))}")
    assert run["tree_variant"] == "hier"
    assert np.isfinite(pos).all(), "non-finite positions"
    assert run["overspeed"] == 0
    cfg = SimConfig.from_dict(run["config"])
    force = make_force_fn(cfg, n=state.n)
    rows = np.arange(0, state.n_real, state.n_real // 2048)
    approx = np.asarray(force(jnp.asarray(state.pos),
                              jnp.asarray(state.mass)))[rows]
    exact = _exact_rows(jnp.asarray(state.pos), jnp.asarray(state.mass),
                        rows, cfg)
    err = _rel_err(approx, exact)
    p99 = float(np.percentile(err, 99))
    print(f"  force err on {len(rows)} bodies: median "
          f"{np.median(err):.3e} p99 {p99:.3e} (tol {TREE_P99:g})")
    print(f"  treecode N=1048576: {run['ms_per_step']:.3f} ms/step over "
          f"{run['steps']} steps incl. compilation, rendering and "
          f"diagnostics (informational; card: {card})")
    assert p99 <= TREE_P99


def phase_exact():
    import numpy as np

    from n_body_problem_tpu import SimConfig, Simulation, models

    sims = {}
    for solver in ("auto", "blocked"):
        sim = Simulation(SimConfig(solver=solver), models.plummer(65536,
                                                                  seed=0))
        sim.run(4)
        sims[solver] = sim
    a = np.asarray(sims["auto"].state.pos)
    b = np.asarray(sims["blocked"].state.pos)
    print(f"  auto = {sims['auto'].solver}: max |dpos| vs direct "
          f"{np.abs(a - b).max():.3e} after 4 steps")
    np.testing.assert_allclose(a, b, rtol=EXACT_RTOL, atol=EXACT_ATOL)


def phase_gpu_tests():
    import pytest

    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests")])
    assert rc == 0, f"pytest -m gpu rc {rc}"


def _shards_on(arr, n: int):
    devs = {s.device for s in arr.addressable_shards}
    assert len(devs) == n, f"shards on {len(devs)} devices, want {n}"


def phase_four(n_exact: int = 262144, n_tree: int = 1 << 20):
    import numpy as np

    from n_body_problem_tpu import SimConfig, Simulation, models
    from n_body_problem_tpu.parallel import ShardedSimulation, make_ring_mesh

    mesh = make_ring_mesh(4)

    def aligned(sim):
        n = sim.state.n_real
        pos = np.asarray(sim.state.pos[:n])
        perm = getattr(sim, "sort_perm", None)
        if perm is None:
            return pos
        inv = np.empty(n, int)
        inv[np.asarray(perm)] = np.arange(n)
        return pos[inv]

    for n, solver, strategies, steps, rtol, atol in (
            (n_exact, "auto", ("ring", "half_ring"), 2,
             EXACT_RTOL, EXACT_ATOL),
            (n_tree, "treecode", ("treecode", "treecode_staged"), 4,
             TREE_RTOL, TREE_ATOL)):
        cfg = SimConfig(solver=solver)
        ref = Simulation(cfg, models.plummer(n, seed=0))
        ref.run(steps)
        want = aligned(ref)
        for strategy in strategies:
            t0 = time.perf_counter()
            ssim = ShardedSimulation(cfg, models.plummer(n, seed=0), mesh,
                                     strategy=strategy)
            _shards_on(ssim.state.pos, 4)
            ssim.run(steps)
            got = aligned(ssim)
            print(f"  {strategy} N={n}: max |dpos| vs one card "
                  f"{np.abs(got - want).max():.3e} after {steps} steps "
                  f"({time.perf_counter() - t0:.1f} s incl. compile)")
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    try:
        import jax

        from n_body_problem_tpu.utils.cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    devices = jax.devices()
    d0 = devices[0]
    card = card_info()
    print(f"device: platform={d0.platform} kind={d0.device_kind} "
          f"count={len(devices)}")
    print(f"card: {card}")
    if d0.platform != "gpu":
        print(f"chip_smoke: needs a GPU, found {d0.platform!r}",
              file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    if args.four:
        phases = [("four cards", phase_four)]
    else:
        phases = [("kernels", phase_kernels),
                  ("treecode", lambda: phase_treecode(
                      pathlib.Path(tmp.name) / "tree", card)),
                  ("exact", phase_exact),
                  ("gpu tests", phase_gpu_tests)]
    failed = []
    with tmp:
        for name, fn in phases:
            t0 = time.perf_counter()
            print(f"phase {name}: start", flush=True)
            try:
                fn()
            except Exception:
                traceback.print_exc()
                failed.append(name)
                print(f"phase {name}: FAILED "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                continue
            print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(result_line(d0.platform, d0.device_kind,
                      len(devices) if args.four else 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
