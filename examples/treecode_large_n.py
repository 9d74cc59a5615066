"""Barnes-Hut treecode: past the brute-force wall.

The exact solvers evaluate N^2 pairs; the treecode's mass-aware MAC
acceptance (docs/acceptance.md) runs the same physics at a fraction of
the pair work (~1e-3 p99 relative force error at the default
tree_mac_tau=2e-4). On a GPU it takes the hierarchical list path with
the compiled near-field kernel (n_body_problem_tpu.plan).

    python examples/treecode_large_n.py --n 262144 --steps 64
"""

import argparse
import time

from n_body_problem_tpu import SimConfig, Simulation, models


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--tau", type=float, default=0.0,
                    help="tree_mac_tau override (0 keeps the default)")
    args = ap.parse_args()

    over = {"tree_mac_tau": args.tau} if args.tau else {}
    cfg = SimConfig(solver="treecode", **over)
    sim = Simulation(cfg, models.plummer(args.n, seed=0))
    print(f"n={sim.state.n_real}  mac_tau={cfg.tree_mac_tau}  "
          f"near capacity={sim.cfg.tree_max_near} tiles  "
          f"flat cap={sim.cfg.tree_flat_cap}")

    d0 = sim.diagnostics()
    sim.run(args.steps)          # warm-up + compile
    t0 = time.perf_counter()
    sim.run(args.steps)          # ends in block_until_ready
    dt = time.perf_counter() - t0

    d = sim.diagnostics()
    drift = (d["energy"] - d0["energy"]) / abs(d0["energy"])
    eff = sim.pairs_per_step() * args.steps / dt
    print(f"{dt / args.steps * 1e3:.2f} ms/step  "
          f"effective {eff:.3e} pairs/s  dE/E={drift:+.2e}  "
          f"overspeed={d['overspeed']}")


if __name__ == "__main__":
    main()
