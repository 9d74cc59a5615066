"""Small-N treecode tuning sweep + 4090-baseline crossover scan.

The only benchmark the reference ever published is 1.6 ms/step at
N=20,225 on an RTX 4090 (``kernel.cu:73``) — 2.6e11 directed pairs/s.
The treecode's effective throughput grows with N (sub-quadratic step
time over a quadratic pair count), so there is some crossover N* below
which the 4090 wins and above which this card does. This tool measures
both sides:

  --mode sweep      config sweep at N=20,480 (dataset-0 padded size):
                    rebuild cadence, VIP budget, source tile, MAC tau,
                    hier on/off — finds the best small-N configuration.
  --mode crossover  default config at N in {20480, 32768, 49152,
                    65536}: brackets N* for BASELINE.md.

Runs on the GPU (bench.py refuses anything else), one leg after the
other in one process. One JSON line per leg on stdout; a summary line at
the end.
"""
from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")  # repo root (bench.py)
from bench import BASELINE, bench_config  # noqa: E402

SWEEP_N = 20480
SWEEP = [
    ("default", {}),
    ("rebuild16", {"tree_rebuild_every": 16}),
    ("rebuild32", {"tree_rebuild_every": 32}),
    ("vip16", {"tree_vip_tiles": 16}),
    ("vip0", {"tree_vip_tiles": 0}),
    ("src32", {"tree_src_tile": 32}),
    ("tau3e-4", {"tree_mac_tau": 3e-4}),
    ("tau5e-4", {"tree_mac_tau": 5e-4}),
    ("slack4", {"tree_near_slack": 4}),
    ("flat", {"tree_hier": False}),
    ("rebuild16_vip16", {"tree_rebuild_every": 16, "tree_vip_tiles": 16}),
    # Census-modelled combos (docs/acceptance.md src-tile frontier): at
    # N=20,480 src32+tau5e-4 halves near+far pair work vs default
    # (4,964 near + 2x335 far vs 10,794 + 2x112 per row).
    ("src32_tau5e-4", {"tree_src_tile": 32, "tree_mac_tau": 5e-4}),
    ("src32_tau5e-4_rebuild16", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                                 "tree_rebuild_every": 16}),
    ("src32_tau1e-3", {"tree_src_tile": 32, "tree_mac_tau": 1e-3}),
    ("src32_tau5e-4_vip16", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                             "tree_vip_tiles": 16}),
    # rebuild32 was the best single knob in the first sweep pass
    # (2.408 ms vs 2.572 default); combine it with the census winner.
    ("src32_tau5e-4_rebuild32", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                                 "tree_rebuild_every": 32}),
    ("src32_rebuild32", {"tree_src_tile": 32, "tree_rebuild_every": 32}),
    # Near cost rides the compacted flat_cap = union of opens over a
    # TARGET tile; at small N a 64-row target tile tightens the union
    # (the 128-row default was tuned at 262k+). Profiled 2026-08-18:
    # near = 0.79 of the 1.82 ms/step at tile=128.
    ("best_tile64", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                     "tree_rebuild_every": 32, "tree_tile": 64}),
    ("best_tile32", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                     "tree_rebuild_every": 32, "tree_tile": 32}),
    ("best_slack4", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                     "tree_rebuild_every": 32, "tree_near_slack": 4}),
]
CROSSOVER_NS = [20480, 32768, 49152, 65536]


def leg(name: str, n: int, steps: int, **cfg_kw) -> dict | None:
    try:
        r = bench_config(n, "treecode", steps=steps, **cfg_kw)
    except Exception as e:
        print(f"tune: leg {name} failed: {e!r}", file=sys.stderr)
        return None
    r["leg"] = name
    r["vs_baseline"] = r["pairs_per_sec"] / BASELINE
    print(json.dumps(r))
    return r


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["sweep", "crossover"],
                    default="sweep")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--legs", type=str, default="",
                    help="comma-separated leg names to run (sweep mode)")
    ap.add_argument("--n", type=int, default=0,
                    help="crossover mode: run this single N only")
    ap.add_argument("--sweep-n", type=int, default=SWEEP_N,
                    help="sweep mode: body count (the same knob legs "
                         "apply at any N)")
    args = ap.parse_args()

    from bench import device_record
    from n_body_problem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    print(json.dumps(device_record()))

    if args.mode == "sweep":
        picked = ([s for s in SWEEP if s[0] in args.legs.split(",")]
                  if args.legs else SWEEP)
        results = [leg(name, args.sweep_n, args.steps, **kw)
                   for name, kw in picked]
        done = [r for r in results if r]
        if done:
            best = min(done, key=lambda r: r["ms_per_step"])
            print(json.dumps({
                "summary": "sweep", "n": args.sweep_n,
                "best_leg": best["leg"],
                "best_ms_per_step": best["ms_per_step"],
                "best_vs_baseline": best["vs_baseline"],
                "best_force_err_p99": best.get("force_err_p99"),
            }))
    else:
        ns = [args.n] if args.n else CROSSOVER_NS
        results = [leg(f"n{n}", n, args.steps) for n in ns]
        done = [r for r in results if r]
        # Crossover: log-linear interpolation of vs_baseline over N
        # between the bracketing pair.
        import math
        cross = None
        for a, b in zip(done, done[1:]):
            va, vb = a["vs_baseline"], b["vs_baseline"]
            if va < 1.0 <= vb:
                la, lb = math.log(a["n"]), math.log(b["n"])
                cross = math.exp(la + (lb - la) * (1.0 - va) / (vb - va))
                break
        print(json.dumps({
            "summary": "crossover",
            "vs_baseline_by_n": {str(r["n"]): r["vs_baseline"]
                                 for r in done},
            "crossover_n_estimate": cross,
        }))


if __name__ == "__main__":
    main()
