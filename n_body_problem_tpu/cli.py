"""Command-line interface.

The reference's entire CLI is one positional dataset id
(``kernel.cu:1069-1086``); everything else is compile-time #defines. Here:

    python -m n_body_problem_tpu run --dataset 0 --steps 1000 --render-every 50
    python -m n_body_problem_tpu run --model plummer --n 65536 --solver pallas
    python -m n_body_problem_tpu info
    python -m n_body_problem_tpu convert data/galaxy_20K.bin out.csv
    python -m n_body_problem_tpu render checkpoint.npz frame.png

``run`` is headless: physics scans on device in ``--steps-per-block``
chunks, frames stream to PNGs through the async viewer, checkpoints and
snap exports land in ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys


# Physics flags default to None sentinels so _build_config can tell "user
# typed it" from "argparse default" — otherwise a --config file's (or a
# resumed checkpoint's) physics would be silently clobbered by defaults.
_PHYSICS_FLAGS = ("dt", "eps2", "compensate", "G", "solver", "integrator")


def _add_physics_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dt", type=float, default=None, help="timestep (default 0.008)")
    p.add_argument("--eps2", type=float, default=None,
                   help="softening added to the scaled r^2 (default 1e-6)")
    p.add_argument("--compensate", type=float, default=None,
                   help="separation pre-scale (default 0.1)")
    p.add_argument("--g", type=float, default=None, dest="G",
                   help="gravitational constant (default 1)")
    p.add_argument("--solver", default=None,
                   help="force solver (default auto: the execution plan's "
                        "exact solver; see `info` for choices)")
    p.add_argument("--integrator", default=None,
                   choices=["semi_implicit_euler", "leapfrog"],
                   help="(default semi_implicit_euler)")
    p.add_argument("--config", help="JSON/TOML config file (flags override)")


def _build_config(args, base=None):
    """Config precedence: checkpoint < --config file < explicit CLI flags."""
    from n_body_problem_tpu.config import SimConfig

    if getattr(args, "config", None):
        base = SimConfig.from_file(args.config)
    if base is None:
        base = SimConfig()
    overrides = {
        k: getattr(args, k) for k in _PHYSICS_FLAGS
        if getattr(args, k, None) is not None
    }
    return base.replace(**overrides) if overrides else base


def _load_initial_state(args):
    """Returns (state, scale_factors, camera_distance, checkpoint_cfg|None)."""
    from n_body_problem_tpu.io.datasets import DATASETS, load_dataset
    from n_body_problem_tpu.models import make_model

    if args.resume:
        from n_body_problem_tpu.io.checkpoint import load_checkpoint

        # The checkpoint's saved config is the base for resumed runs; the
        # run continues with the physics it was created with unless flags
        # explicitly override.
        state, ck_cfg = load_checkpoint(args.resume)
        return state, (0.0, 0.0, 0.0), 1.0, ck_cfg
    if args.model:
        state = make_model(args.model, args.n, seed=args.seed)
        return state, (0.0, 0.0, 0.0), 1.0, None
    state, spec = load_dataset(
        args.dataset, directory=args.data_dir, quirk_compat=args.quirk_compat,
        seed=args.seed,
    )
    return state, spec.scale_factors, spec.camera_distance, None


def cmd_run(args) -> int:
    import json

    import numpy as np

    from n_body_problem_tpu import Simulation, diagnostics
    from n_body_problem_tpu.io.checkpoint import export_snap, save_checkpoint
    from n_body_problem_tpu.render import FrameWriter, OrbitCamera, render_state
    from n_body_problem_tpu.utils.metrics import StepTimer
    from n_body_problem_tpu.utils.profiling import trace

    state, scales, cam_dist, ck_cfg = _load_initial_state(args)
    cfg = _build_config(args, base=ck_cfg)
    if args.morton_sort:
        cfg = cfg.replace(morton_sort=True)
    if getattr(args, "tree_tuned", False):
        from n_body_problem_tpu.config import tuned_tree_overrides
        from n_body_problem_tpu.ops.forces import required_padding

        # Bracket on the PADDED body count (what Simulation will run and
        # what the tuning table is keyed on — 20,480 is dataset 0's padded
        # size), not n_real. The treecode pad multiple is 256 for every
        # tile/src_tile combination in use.
        padded = required_padding("treecode", state.n_real, cfg.block_size)
        cfg = cfg.replace(**tuned_tree_overrides(padded))
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.devices > 1:
        from n_body_problem_tpu.parallel import ShardedSimulation, make_ring_mesh

        sim = ShardedSimulation(
            cfg, state, make_ring_mesh(args.devices), strategy=args.strategy
        )
    else:
        sim = Simulation(cfg, state)
    solver = getattr(sim, "solver", cfg.solver)
    variant = getattr(sim, "tree_variant", None)
    print(
        f"n={sim.state.n_real} (padded {sim.state.n})  solver={solver}"
        f"{f' ({variant} path)' if variant else ''}  "
        f"integrator={cfg.integrator}  dt={cfg.dt}", file=sys.stderr,
    )
    if args.diag_every:
        d = sim.diagnostics()
        e0 = d["energy"]
        print(f"E0={e0:.6e}  |p|={np.linalg.norm(d['momentum']):.3e}", file=sys.stderr)

    camera = OrbitCamera(
        theta_deg=args.cam_theta, phi_deg=args.cam_phi,
        distance=cam_dist * args.cam_zoom, aspect=args.width / args.height,
    )
    render_every = args.render_every
    live = None
    if args.serve:
        from n_body_problem_tpu.render.server import LiveViewer

        live = LiveViewer(args.serve, camera, exposure=args.exposure,
                          host=args.serve_host)
        live.stats["n"] = sim.state.n_real
        render_every = render_every or args.steps_per_block
        print(f"live viewer: http://{args.serve_host}:{live.port}/",
              file=sys.stderr)
    viewer = (
        FrameWriter(out / "frames", exposure=args.exposure)
        if args.render_every else None
    )
    timer = StepTimer(n_bodies=sim.state.n_real)

    # A block must not straddle any output interval, or events get skipped.
    intervals = [v for v in (render_every, args.diag_every,
                             args.checkpoint_every) if v > 0]
    block = min([args.steps_per_block] + intervals)
    done = 0
    frame_idx = 0
    last_diag = None
    try:
        with trace(out / "profile" if args.profile else None):
            while done < args.steps:
                todo = min(block, args.steps - done)
                timer.start()
                sim.run(todo)
                timer.stop(todo)
                done += todo
                if timer.window_full:
                    timer.report()
                if render_every and done % render_every < todo:
                    lock = live.camera_lock if live else contextlib.nullcontext()
                    with lock:  # /control mutates the camera concurrently
                        frame = render_state(
                            sim.state, camera, scales,
                            width=args.width, height=args.height,
                        )
                    if live:
                        live.submit(frame)
                        live.stats.update(
                            step=done,
                            ms_per_step=timer.total_time
                            / max(timer.total_steps, 1) * 1e3,
                        )
                    if viewer:
                        viewer.submit(frame_idx, frame)
                        frame_idx += 1
                if args.diag_every and done % args.diag_every < todo:
                    d = sim.diagnostics()
                    drift = (d["energy"] - e0) / abs(e0) if e0 else 0.0
                    last_diag = dict(step=done, energy=d["energy"],
                                     drift=drift, overspeed=d["overspeed"])
                    print(
                        f"[step {done}] E={d['energy']:.6e} drift={drift:+.2e} "
                        f"overspeed={d['overspeed']}", file=sys.stderr,
                    )
                if args.checkpoint_every and done % args.checkpoint_every < todo:
                    save_checkpoint(out / f"ck_{done:08d}.npz", sim.state, cfg)
    finally:
        if viewer:
            viewer.close()
        if live:
            live.close()

    if args.gif and viewer and viewer.frames_written:
        from n_body_problem_tpu.render.viewer import assemble_gif

        n_frames = assemble_gif(out / "frames", out / "movie.gif", fps=args.gif_fps)
        print(f"assembled movie.gif ({n_frames} frames)", file=sys.stderr)

    save_checkpoint(out / "final.npz", sim.state, cfg)
    if args.export_snap:
        export_snap(out / "final.snap", sim.state)
    wall = timer.total_time
    vmax = cfg.vmax_guard if cfg.vmax_guard > 0 else 10.0
    (out / "run.json").write_text(json.dumps({
        "n": sim.state.n_real, "n_padded": sim.state.n, "steps": done,
        "solver": solver, "tree_variant": variant,
        "wall_s": wall, "ms_per_step": wall / max(done, 1) * 1e3,
        "overspeed": int(diagnostics.overspeed_count(sim.state, vmax)),
        "last_diagnostics": last_diag,
        "config": sim.cfg.to_dict(),
    }, indent=1))
    print(
        f"done: {args.steps} steps in {wall:.2f}s "
        f"({sim.pairs_per_step() * args.steps / max(wall, 1e-9):.3e} pairs/s); "
        f"outputs in {out}", file=sys.stderr,
    )
    return 0


def cmd_info(args) -> int:
    import jax

    from n_body_problem_tpu import __version__
    from n_body_problem_tpu.plan import execution_plan
    from n_body_problem_tpu.config import INTEGRATORS, SOLVERS
    from n_body_problem_tpu.io.datasets import DATASETS
    from n_body_problem_tpu.io import native
    from n_body_problem_tpu.models import MODELS

    print(f"n_body_problem_tpu {__version__}")
    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    print(f"plan: {execution_plan()}")
    print(f"native io: {'available' if native.available() else 'python fallback'}")
    print(f"solvers: {', '.join(SOLVERS)}")
    print(f"integrators: {', '.join(INTEGRATORS)}")
    print(f"models: {', '.join(sorted(MODELS))}")
    print("datasets:")
    for i, spec in sorted(DATASETS.items()):
        print(f"  {i}: {spec.name:<12} {spec.reader:<6} scales={spec.scale_factors}"
              f"  {spec.description}")
    return 0


def cmd_convert(args) -> int:
    from n_body_problem_tpu.io.convert import tipsy_to_csv

    n = tipsy_to_csv(args.src, args.dst)
    print(f"wrote {n} bodies to {args.dst}", file=sys.stderr)
    return 0


def cmd_render(args) -> int:
    from n_body_problem_tpu.io.checkpoint import load_checkpoint
    from n_body_problem_tpu.render import OrbitCamera, render_state, tonemap, write_png
    import numpy as np

    state, _ = load_checkpoint(args.checkpoint)
    camera = OrbitCamera(
        theta_deg=args.cam_theta, phi_deg=args.cam_phi, distance=args.cam_zoom,
        aspect=args.width / args.height,
    )
    frame = render_state(
        state, camera, tuple(args.scales), width=args.width, height=args.height
    )
    write_png(args.output, tonemap(np.asarray(frame), exposure=args.exposure))
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    import bench  # repo-root harness

    bench.run_single(args.n, args.solver, args.steps)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="n_body_problem_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a simulation headlessly")
    src = r.add_argument_group("initial conditions")
    src.add_argument("--dataset", type=int, default=1,
                     help="dataset id 0-5 (default 1, as the reference)")
    src.add_argument("--data-dir", default=None)
    src.add_argument("--model", help="procedural model instead of a dataset")
    src.add_argument("--n", type=int, default=8192)
    src.add_argument("--seed", type=int, default=0)
    src.add_argument("--resume", help="checkpoint .npz to resume from")
    src.add_argument("--quirk-compat", action="store_true",
                     help="reproduce reference loader quirks (Q1)")
    _add_physics_flags(r)
    r.add_argument("--steps", type=int, default=1000)
    r.add_argument("--steps-per-block", type=int, default=50)
    r.add_argument("--out", default="out")
    r.add_argument("--render-every", type=int, default=0)
    r.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="live HTTP viewer (MJPEG + orbit/zoom controls); "
                        "renders every --render-every steps (default: "
                        "every steps-per-block)")
    r.add_argument("--serve-host", default="127.0.0.1")
    r.add_argument("--gif", action="store_true",
                   help="assemble frames into movie.gif (needs Pillow)")
    r.add_argument("--gif-fps", type=float, default=25.0)
    r.add_argument("--width", type=int, default=1024)
    r.add_argument("--height", type=int, default=768)
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--cam-theta", type=float, default=0.0)
    r.add_argument("--cam-phi", type=float, default=20.0)
    r.add_argument("--cam-zoom", type=float, default=1.0)
    r.add_argument("--diag-every", type=int, default=0)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--export-snap", action="store_true")
    r.add_argument("--profile", action="store_true")
    r.add_argument("--morton-sort", action="store_true",
                   help="Z-order bodies at init (tile locality)")
    r.add_argument("--tree-tuned", action="store_true",
                   help="apply the measured per-N treecode tuning table "
                        "(config.tuned_tree_overrides; small-N sweep)")
    r.add_argument("--devices", type=int, default=1,
                   help="shard bodies over a ring mesh of this many devices")
    r.add_argument("--strategy", default="ring",
                   choices=["ring", "half_ring", "treecode",
                            "treecode_staged"],
                   help="distributed force strategy (with --devices > 1): "
                        "exact ppermute ring, Newton's-3rd-law half ring, "
                        "the sharded Barnes-Hut treecode (replicated "
                        "sources — the throughput path), or the "
                        "ring-streamed staged treecode (O(N/D) resident "
                        "sources — the capacity path)")
    r.set_defaults(fn=cmd_run)

    i = sub.add_parser("info", help="environment, datasets, solvers")
    i.set_defaults(fn=cmd_info)

    c = sub.add_parser("convert", help="tipsy binary -> csv")
    c.add_argument("src")
    c.add_argument("dst")
    c.set_defaults(fn=cmd_convert)

    rr = sub.add_parser("render", help="render one frame from a checkpoint")
    rr.add_argument("checkpoint")
    rr.add_argument("output")
    rr.add_argument("--width", type=int, default=1024)
    rr.add_argument("--height", type=int, default=768)
    rr.add_argument("--scales", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    rr.add_argument("--exposure", type=float, default=1.0)
    rr.add_argument("--cam-theta", type=float, default=0.0)
    rr.add_argument("--cam-phi", type=float, default=20.0)
    rr.add_argument("--cam-zoom", type=float, default=1.0)
    rr.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    b.add_argument("--n", type=int, default=65536)
    b.add_argument("--steps", type=int, default=20)
    b.add_argument("--solver", default="auto")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    from n_body_problem_tpu.utils.cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
