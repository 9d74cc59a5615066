"""Throughput benchmark: effective pairwise interactions/sec on one GPU.

Default (no args) runs four sustained treecode legs — N=524,288 and
N=1,048,576 (the largest scales), N=20,480 tuned (the reference's own
workload: 1.6 ms/step on an RTX 4090 at N=20,225, ``kernel.cu:73``, the
only number the reference published) and N=65,536. Each leg runs hundreds
of steps through ``Simulation.run`` (every rebuild, resort and capacity
effect inside the timed window; compilation excluded by a same-length
warmup) and then measures its force-error envelope against the exact
oracle on 2,048 sampled bodies of the post-warmup state, so every
effective-throughput claim carries its accuracy (~1e-3 p99 relative force
error at the default tau).

The cumulative report is printed as one JSON line after every leg and
every error probe, so the last line on stdout is always the most complete
record; ``legs_done``/``legs_total`` mark partial ones. ``--full`` adds
secondary legs (N=262,144, the 24k/32k tuned legs, the exact solver at
20,480 and 65,536, step+render). ``vs_baseline`` compares with the
reference's published RTX 4090 throughput, 2.6e11 directed
interactions/s (``BASELINE``, derived in BASELINE.md). ``--n``/``--solver``
benchmark one configuration instead (same schema, one line).

Every record names the device it ran on (platform, device kind, count,
card name and power limit); the benchmark refuses to run on anything but
a GPU, and any failed leg makes the exit code nonzero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BASELINE = 2.6e11  # the reference's RTX 4090, directed interactions/s (BASELINE.md)


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit from nvidia-smi. Refuses a non-GPU."""
    import jax

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, found {d0.platform!r}")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not available"
    return {"platform": d0.platform, "device_kind": d0.device_kind,
            "device_count": len(jax.devices()), "card": card}


def time_config(n: int, solver: str, steps: int, warmup: int = 1,
                probe_error: bool | None = None, windows: int = 3,
                **cfg_kw):
    """Time one configuration; returns ``(record, probe_fn)``.

    ``record`` carries the timing (best of ``windows`` windows of
    ``steps`` steps); ``probe_fn`` (or ``None``) is a deferred closure
    that runs the exact-oracle error probe and adds the ``force_err_*``
    fields to ``record`` — the suite flushes a finished timing before
    spending the probe's compilations on it. Extra kwargs are SimConfig
    overrides (tools/tune_small_n.py uses them for its sweep).
    """
    import numpy as np

    from n_body_problem_tpu import SimConfig, Simulation, models

    cfg = SimConfig(solver=solver, **cfg_kw)
    sim = Simulation(cfg, models.plummer(n, seed=0))
    print(f"bench: n={n} padded={sim.state.n} solver={sim.solver} "
          f"steps={steps}", file=sys.stderr)

    # Warm up with the SAME step count: scan length is a static jit arg, so
    # a different count would push the compile into the timed region.
    for _ in range(max(warmup, 1)):
        sim.run(steps)

    # Snapshot the post-warmup state for the error probe BEFORE the timed
    # windows evolve it further: force error grows as the Plummer core
    # collapses, so the probe depth must be a fixed function of the leg
    # (warmup * steps), not of how many windows follow. Host copies: the
    # timed windows donate the state's device buffers.
    probe_pos = np.asarray(sim.state.pos)
    probe_mass = np.asarray(sim.state.mass)
    rcfg = sim.cfg  # resolved config (auto caps filled in)

    dt = float("inf")
    for _ in range(max(windows, 1)):
        t0 = time.perf_counter()
        sim.run(steps)          # ends in block_until_ready
        dt = min(dt, time.perf_counter() - t0)

    out = {
        "solver": sim.solver,
        "n": n,
        "n_padded": sim.state.n,
        "steps_timed": steps,
        "ms_per_step": dt / steps * 1e3,
        "pairs_per_sec": sim.pairs_per_step() * steps / dt,
        "padded_pairs_per_sec": sim.padded_pairs_per_step() * steps / dt,
    }
    if sim.tree_variant:
        out["tree_variant"] = sim.tree_variant
    print(f"bench: {out['ms_per_step']:.3f} ms/step, "
          f"{out['pairs_per_sec']:.3e} pairs/s", file=sys.stderr)

    if probe_error is None:
        probe_error = solver == "treecode"
    if not probe_error:
        return out, None

    def probe() -> dict:
        # Exact oracle on 2,048 stride-sampled bodies of the post-warmup
        # state. Stride sampling over the Morton-sorted order is a spatial
        # stratified sample; the empirical p99 of 2,048 samples sits
        # between the true p98.3 and p99.7 (95% CI) regardless of N.
        import jax.numpy as jnp

        from n_body_problem_tpu.ops.forces import pair_accel_tile
        from n_body_problem_tpu.ops.registry import make_force_fn

        n_pad = probe_pos.shape[0]
        out["probe_depth_steps"] = steps * max(warmup, 1)
        sub = np.arange(0, n_pad, max(n_pad // 2048, 1))
        force_fn = make_force_fn(rcfg, n=n_pad)
        approx = np.asarray(force_fn(jnp.asarray(probe_pos),
                                     jnp.asarray(probe_mass)))[sub]
        # The oracle is the float32 direct sum written as elementwise
        # products and sums (no matrix product, so no TF32 on the GPU).
        # Row chunks bound its (rows, N) transients (~1.5 GB).
        rows = min(512, max(64, int(1.5e9 // (12 * n_pad))))
        dev_pos, dev_mass = jnp.asarray(probe_pos), jnp.asarray(probe_mass)
        exact = np.concatenate([
            np.asarray(pair_accel_tile(
                dev_pos[sub[a:a + rows]], dev_pos, dev_mass,
                eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G,
            )) for a in range(0, len(sub), rows)
        ])
        err = (np.linalg.norm(approx - exact, axis=1)
               / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))
        out["force_err_median"] = float(np.median(err))
        out["force_err_p99"] = float(np.percentile(err, 99))
        print(f"bench: force err median {out['force_err_median']:.2e} "
              f"p99 {out['force_err_p99']:.2e}", file=sys.stderr)
        return out

    return out, probe


def bench_config(n: int, solver: str, steps: int, warmup: int = 1,
                 probe_error: bool | None = None, windows: int = 3,
                 **cfg_kw) -> dict:
    """Time one configuration and run its error probe immediately."""
    out, probe = time_config(n, solver, steps, warmup=warmup,
                             probe_error=probe_error, windows=windows,
                             **cfg_kw)
    if probe is not None:
        probe()
    return out


def bench_render(n: int, solver: str) -> float:
    """ms/step including a rendered frame (the reference integrates once
    per rendered frame) — fused step+render in one scanned program."""
    from n_body_problem_tpu import SimConfig, Simulation, models
    from n_body_problem_tpu.render import OrbitCamera

    sim = Simulation(SimConfig(solver=solver), models.plummer(n, seed=0))
    cam = OrbitCamera(distance=2.0)
    sim.movie(10, render_every=1, camera=cam, width=1024, height=1024)
    t0 = time.perf_counter()
    sim.movie(10, render_every=1, camera=cam, width=1024, height=1024)
    return (time.perf_counter() - t0) / 10 * 1e3


def run_single(n: int, solver: str, steps: int = 0, windows: int = 3) -> dict:
    """Benchmark one configuration; returns (and prints) the JSON record
    (the ``nbody bench`` CLI subcommand calls this)."""
    device = device_record()
    n = n or 65536
    solver = solver or "auto"
    steps = steps or (8 if n > 131072 else 16)
    r = bench_config(n, solver, steps, windows=windows)
    r.update({
        "metric": f"pairwise interactions/sec ({r['solver']}, N={n})",
        "value": r["pairs_per_sec"],
        "unit": "pairs/s",
        "vs_baseline": r["pairs_per_sec"] / BASELINE,
        **device,
    })
    print(json.dumps(r))
    return r


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=0,
                    help="single-config mode: body count")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--solver", type=str, default="")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="append the secondary legs (262k, 24k/32k tuned, "
                         "exact solver, render) after the headline suite")
    args = ap.parse_args()

    from n_body_problem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.n or args.solver:
        run_single(args.n, args.solver, args.steps, windows=args.windows)
        return

    device = device_record()
    if args.steps:
        print("bench: --steps is ignored in suite mode (leg step counts "
              "are fixed); use --n for single-config mode", file=sys.stderr)
    from n_body_problem_tpu.config import tuned_tree_overrides

    legs: list[tuple[str, dict]] = [
        ("sustained_524k", dict(n=524288, solver="treecode", steps=128,
                                windows=1)),
        ("sustained_1m", dict(n=1048576, solver="treecode", steps=96,
                              windows=1)),
        ("sustained_20k", dict(n=20480, solver="treecode", steps=1024,
                               windows=1, **tuned_tree_overrides(20480))),
        ("sustained_65k", dict(n=65536, solver="treecode", steps=512,
                               windows=1)),
    ]
    if args.full:
        legs += [
            ("sustained_262k", dict(n=262144, solver="treecode", steps=256,
                                    windows=1)),
            ("24k", dict(n=24576, solver="treecode", steps=256,
                         **tuned_tree_overrides(24576))),
            ("32k", dict(n=32768, solver="treecode", steps=256,
                         **tuned_tree_overrides(32768))),
        ]

    done: dict[str, dict] = {}
    failed: list[str] = []

    def snapshot(total: int, exact: dict | None = None,
                 ms_render=None) -> None:
        """Cumulative report over completed legs (largest leg first)."""
        order = ("sustained_1m", "sustained_524k", "sustained_262k",
                 "sustained_65k", "sustained_20k", "24k", "32k")
        head_tag = next((t for t in order if t in done), None)
        if head_tag is None:
            return
        head = done[head_tag]
        report = {
            "metric": "effective pairwise interactions/sec "
                      f"(treecode sustained, N={head['n']})",
            "value": head["pairs_per_sec"],
            "unit": "pairs/s",
            "vs_baseline": head["pairs_per_sec"] / BASELINE,
            "ms_per_step": head["ms_per_step"],
            "force_err_p99": head.get("force_err_p99"),
            "force_err_median": head.get("force_err_median"),
            "n": head["n"],
            "solver": "treecode",
            **device,
            "legs_done": len(done),
            "legs_total": total,
            "legs_failed": failed,
        }
        for tag, leg in done.items():
            report[f"tree_pairs_per_sec_{tag}"] = leg["pairs_per_sec"]
            report[f"tree_ms_per_step_{tag}"] = leg["ms_per_step"]
            report[f"tree_vs_baseline_{tag}"] = leg["pairs_per_sec"] / BASELINE
            report[f"tree_force_err_p99_{tag}"] = leg.get("force_err_p99")
        for tag, leg in (exact or {}).items():
            report[f"exact_solver_{tag}"] = leg["solver"]
            report[f"exact_pairs_per_sec_{tag}"] = leg["pairs_per_sec"]
            report[f"exact_ms_per_step_{tag}"] = leg["ms_per_step"]
            report[f"exact_vs_baseline_{tag}"] = leg["pairs_per_sec"] / BASELINE
        if ms_render is not None:
            report["ms_per_step_with_render_65k"] = ms_render
        print(json.dumps(report), flush=True)

    def safe(tag, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as e:
            print(f"bench: leg {tag} failed: {e!r}", file=sys.stderr)
            failed.append(tag)
            return None

    # Timings first, flushing after each leg; then the error probes,
    # cheapest first (each probe mutates its leg's record in place).
    total = len(legs)
    probes: list[tuple[int, str, callable]] = []
    for tag, kw in legs:
        r = safe(tag, time_config, **kw)
        if r is not None:
            rec, probe = r
            done[tag] = rec
            if probe is not None:
                probes.append((kw["n"], tag, probe))
            snapshot(total)
    for _, tag, probe in sorted(probes, key=lambda p: p[0]):
        if safe(f"{tag}_probe", probe) is not None:
            snapshot(total)

    exact, ms_render = {}, None
    if args.full:
        for tag, n, steps in (("20k", 20480, 64), ("65k", 65536, 16)):
            r = safe(f"exact_{tag}", bench_config, n, "auto", steps=steps)
            if r is not None:
                exact[tag] = r
        ms_render = safe("render", bench_render, 65536, "auto")

    snapshot(total, exact, ms_render)
    if failed or not done:
        print(f"bench: failed legs: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
