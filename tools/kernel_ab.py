"""Kernel against plain XLA, end to end: ``Simulation.run`` ms/step with
each hand-written GPU kernel on and off, at the widths of the main path.

    python tools/kernel_ab.py [--tree-n 1048576] [--exact-n 65536]
                              [--tree-steps 32] [--exact-steps 8]
                              [--rounds 2] [--out chiprun_out/kernel_ab.json]

Treecode (Plummer, hierarchical list path): the execution plan with the
near-field kernel, the far-field kernel and the all-pairs kernel for the
VIP sweep, each switched to its XLA form in turn, and all together. Exact solver: the
all-pairs kernel (``pallas``) and the two XLA forms (``blocked``,
``mxu``).
Every variant is compiled and warmed first (same step count), then timed
``--rounds`` times in interleaved order, so drift on the card hits every
variant alike. Prints one JSON line per timing and writes all of them,
with the card's name and power limit, to ``--out``.

``--interpret`` runs the kernels through the Pallas interpreter so the
script can be rehearsed on the CPU at tiny sizes; its times mean nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree-n", type=int, default=1 << 20)
    ap.add_argument("--exact-n", type=int, default=65536)
    ap.add_argument("--tree-steps", type=int, default=32)
    ap.add_argument("--exact-steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args()

    import jax

    from n_body_problem_tpu import SimConfig, Simulation, models
    from n_body_problem_tpu.plan import KERNEL, XLA, execution_plan
    from n_body_problem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    d0 = jax.devices()[0]
    base = execution_plan("gpu")
    if args.interpret:
        base = dataclasses.replace(base, interpret=True)
    elif d0.platform != "gpu":
        sys.exit(f"kernel_ab: needs a GPU (found {d0.platform!r}); "
                 "--interpret rehearses on the CPU")
    info = dict(platform=d0.platform, kind=d0.device_kind,
                count=len(jax.devices()), card=card())
    print(json.dumps(info), flush=True)

    variants = []
    tree0 = Simulation(SimConfig(solver="treecode"),
                       models.plummer(args.tree_n, seed=0), plan=base)
    tcfg = tree0.cfg          # resolved: every variant shares the caps
    print(f"kernel_ab: treecode path {tree0.tree_variant}, cfg "
          f"tile={tcfg.tree_tile} max_near={tcfg.tree_max_near} "
          f"flat_cap={tcfg.tree_flat_cap} far_max={tcfg.tree_far_max} "
          f"far_cap={tcfg.tree_far_cap} vip={tcfg.tree_vip_tiles}",
          file=sys.stderr, flush=True)
    for near, far, pair in ((KERNEL, KERNEL, KERNEL), (XLA, KERNEL, KERNEL),
                            (KERNEL, XLA, KERNEL), (KERNEL, KERNEL, XLA),
                            (XLA, XLA, XLA)):
        plan = dataclasses.replace(base, near=near, far=far, pair=pair)
        variants.append((f"tree near={near} far={far} vip={pair}", tcfg,
                         plan, args.tree_n, args.tree_steps))
    for solver in ("pallas", "blocked", "mxu"):
        variants.append((f"exact {solver}", SimConfig(solver=solver), base,
                         args.exact_n, args.exact_steps))

    sims = {}
    for name, cfg, plan, n, steps in variants:
        t0 = time.perf_counter()
        try:
            sim = Simulation(cfg, models.plummer(n, seed=0), plan=plan)
            sim.run(steps)                   # compile + warm
        except Exception as e:  # report and keep timing the others
            print(f"kernel_ab: {name} failed: {e!r}", file=sys.stderr,
                  flush=True)
            continue
        sims[name] = (sim, steps)
        print(f"kernel_ab: {name} ready in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    rows = []
    for r in range(args.rounds):
        order = list(sims) if r % 2 == 0 else list(reversed(sims))
        for name in order:
            sim, steps = sims[name]
            t0 = time.perf_counter()
            sim.run(steps)
            dt = time.perf_counter() - t0
            row = dict(variant=name, round=r, n=sim.state.n, steps=steps,
                       ms_per_step=dt / steps * 1e3)
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(info, rows=rows), indent=1))


if __name__ == "__main__":
    main()
