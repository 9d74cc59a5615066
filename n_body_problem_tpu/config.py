"""Simulation configuration.

The reference hardcodes every knob as a compile-time ``#define``
(``kernel.cu:62-73``: G=1, TIME_TICK=0.008, BLOCK_SIZE=256, EPSILON=1e-6,
VERSION selecting the solver). Here the same knobs live in a single frozen
dataclass that is hashable (usable as a ``jax.jit`` static argument) and can
be loaded from JSON/TOML or overridden from the CLI.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

def resolve_vip_tiles(vip_tiles: int, n: int) -> int:
    """-1 (auto) -> clamp(n // 2048, 16, 128) 32-body VIP units: ~n/64
    exact-evaluated halo bodies (an algorithm default chosen for its
    cost/error balance from 32,768 to 524,288 bodies; not yet tuned on
    the GPU)."""
    if vip_tiles != -1:
        return vip_tiles
    return max(16, min(128, n // 2048))


def tuned_tree_overrides(n: int) -> dict[str, Any]:
    """Per-N treecode overrides for small N (defaults stay untouched —
    callers opt in via ``SimConfig(solver="treecode",
    **tuned_tree_overrides(n))``, the CLI's ``--tree-tuned``, or
    ``tools/tune_small_n.py``). Algorithm defaults, not yet tuned on the
    GPU (``tools/tune_small_n.py`` re-runs the sweep there).

    Below ~32k bodies the flat-path near/far balance shifts: the
    32-body source tile halves near pair work for +44% far evaluations
    and a 32-step rebuild cadence amortizes the (relatively large at
    small N) build. At the reference's own N=20,480 a looser tau (5e-4)
    stays inside the ~1e-3 p99 force-error class (1.15e-3 measured);
    at 24k-32k the same tau gave ~4e-3 p99, so that bracket keeps the
    default tau. Large N keeps the defaults.
    """
    if n <= 20480:
        return {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                "tree_rebuild_every": 32, "tree_near_slack": 4}
    if n <= 32768:
        return {"tree_src_tile": 32, "tree_rebuild_every": 32,
                "tree_near_slack": 4}
    return {}


SOLVERS = (
    "auto",        # the execution plan's exact solver (n_body_problem_tpu.plan)
    "direct",      # one-shot jnp O(N^2); the serial ground truth (kernel.cu:891-923 role)
    "blocked",     # lax.map over row blocks; memory-safe pure-XLA O(N^2)
    "mxu",         # matmul formulation: W @ [P, 1] force accumulation (float32, HIGHEST precision)
    "pallas",      # all-pairs GPU kernel, Pallas/Triton (kernel.cu:828-884 role)
    "treecode",    # Barnes-Hut on the Morton tiling: beyond-brute-force, ~1e-4 median force error
    "pair_matrix", # dev-history Method A foil (project_develop_code.cu:657-861); small N only
)

INTEGRATORS = (
    "semi_implicit_euler",  # v += a*dt; x += v*dt  (kernel.cu:777-801)
    "leapfrog",             # KDK leapfrog (dev-history capability, project_develop_code.cu:831-859)
)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All physics + execution knobs for a simulation.

    Numerical defaults reproduce the reference's method C
    (``cal_single_acclerate_without_mass_new``, ``kernel.cu:665-692``):
    pair separation is scaled by ``compensate`` = 0.1 before squaring and the
    raw ``eps2`` = 1e-6 is added to the *scaled* square distance, which is
    algebraically a Plummer softening with effective eps'^2 = eps2/compensate^2
    = 1e-4 while keeping fp32 intermediates well-scaled.
    """

    # --- physics (kernel.cu:62-66) ---
    dt: float = 0.008          # TIME_TICK
    G: float = 1.0
    eps2: float = 1e-6         # EPSILON, added to the *scaled* squared distance
    compensate: float = 0.1    # separation pre-scale; 1.0 => plain Plummer softening with eps2

    # --- solver / integrator selection (VERSION, kernel.cu:70-73) ---
    solver: str = "auto"
    integrator: str = "semi_implicit_euler"

    # --- execution ---
    block_size: int = 256      # row-chunk for blocked/mxu solvers (BLOCK_SIZE analogue)
    pallas_tile_i: int = 64    # all-pairs kernel: target bodies per program
    pallas_tile_j: int = 64    # all-pairs kernel: source bodies per loop step
    # --- treecode solver (ops/treecode.py; requires Morton-sorted bodies,
    # Simulation auto-enables morton_sort for it) ---
    tree_tile: int = 0         # target-row Morton tile (output granularity);
                               # 0 = auto: 128 on the hierarchical flat path
                               # (near-work is flat in the row size there —
                               # measured — and wide rows amortize each far
                               # node fetch), 32 otherwise
    tree_src_tile: int = 64    # SOURCE tile of the flat path (asymmetric
                               # acceptance: bigger sources shrink the
                               # bookkeeping, thicken the exact near shell;
                               # 64 gives p99 error equal to 128's on the
                               # same state at half the near work)
    tree_theta: float = 0.55   # geometric opening angle (used when
                               # tree_mac_tau == 0)
    tree_mac_tau: float = 2e-4 # mass-aware MAC tolerance: open a source
                               # tile iff its estimated quadrupole-
                               # truncation error exceeds tau x the median
                               # body acceleration. ~2x more accurate than
                               # the theta test at matched cost (measured);
                               # 0 falls back to the geometric criterion.
    tree_max_near: int = 0     # near-list capacity; 0 = auto-tune at init
                               # (in source tiles on the flat path)
    tree_vip_tiles: int = -1   # largest-radius tiles evaluated exactly,
                               # counted in 32-body units (see
                               # ops.treecode._vip_src_tiles). -1 = auto:
                               # clamp(N // 2048, 16, 128), ~N/64 exact
                               # bodies (config.resolve_vip_tiles).
                               # 0 disables the VIP split.
    tree_rebuild_every: int = 8   # device re-sort + acceptance rebuild
                                  # cadence inside Simulation.run (near
                                  # counts grow ~12% over 8 steps; the
                                  # suggest_max_near margin covers it)
    tree_near_slack: int = 8   # extra exact SOURCE tiles per target (flat
                               # path headroom for inter-rebuild drift)
    tree_flat_cap: int = 0     # compacted work-list capacity; 0 = auto
                               # where the execution plan plans the lists
                               # (the GPU), -1 = disable
    tree_hier: bool = True     # multi-level far field on the flat path:
                               # binary merge hierarchy + compacted far
                               # lists + octupole-bound MAC (round 3); off
                               # falls back to the single-level masked far
    tree_hier_tau: float = 0.01  # hierarchical MAC tolerance: open a node
                               # iff m rms^2 r_max / (d - r_max)^5 exceeds
                               # tau x the median body acceleration. Own
                               # scale (the convergence-aware distance
                               # changes the score's units of magnitude);
                               # calibrated on the measured per-node error
                               # frontier (docs/acceptance.md). 0 falls
                               # back to the geometric theta criterion.
    tree_far_cap: int = 0      # hierarchical far-list capacity; 0 = auto
    tree_far_max: int = 0      # per-target far-list bound; 0 = auto
    tree_hier_union: bool = True  # per-body union distances at COARSE
                               # levels too (not just level 0): the cheap
                               # com-minus-row-radius bound collapses for
                               # wide halo target rows (everything opens
                               # to the leaves). Census at N=262k: mean
                               # far evals -26%, worst row -60%, for ~2x
                               # the build's (amortized) distance work
                               # (docs/acceptance.md round-3 union table).
    # (Physics is fp32 throughout — the reference's `real`; no dtype knob.)
    morton_sort: bool = False  # Z-order bodies at init (tile locality)
    resort_every: int = 0      # >0: sort at init AND re-sort every N steps
                               # of Simulation.run (trajectory/movie are
                               # single device programs and never re-sort)
    donate: bool = True        # donate state buffers through jitted scans

    # --- guards / diagnostics (dev-history D4: project_develop_code.cu:1089-1091) ---
    vmax_guard: float = 0.0    # if > 0, diagnostics.overspeed_count uses this threshold

    def __post_init__(self) -> None:
        if self.solver not in SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}; expected one of {SOLVERS}")
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"unknown integrator {self.integrator!r}; expected one of {INTEGRATORS}"
            )
        if self.compensate <= 0:
            raise ValueError("compensate must be > 0")
        if self.eps2 <= 0:
            # eps2 = 0 turns the self-pair into 0 * inf = NaN; the reference
            # relies on EPSILON > 0 for the same reason (kernel.cu:66, 679).
            raise ValueError("eps2 must be > 0")
        if not (0.0 < self.tree_theta <= 1.0):
            raise ValueError(f"tree_theta must be in (0, 1], got {self.tree_theta}")
        if self.tree_max_near < 0 or self.tree_vip_tiles < -1:
            raise ValueError(
                "tree_max_near must be >= 0 and tree_vip_tiles >= -1 "
                "(-1 = auto)")
        if self.tree_mac_tau < 0:
            raise ValueError(f"tree_mac_tau must be >= 0, got {self.tree_mac_tau}")
        if self.tree_hier_tau < 0:
            raise ValueError(
                f"tree_hier_tau must be >= 0, got {self.tree_hier_tau}")
        if self.tree_tile and (self.tree_src_tile % self.tree_tile
                               and self.tree_tile % self.tree_src_tile):
            raise ValueError(
                f"tree_src_tile ({self.tree_src_tile}) and tree_tile "
                f"({self.tree_tile}) must be multiples of one another"
            )
        if self.tree_rebuild_every < 1:
            raise ValueError("tree_rebuild_every must be >= 1")

    # Effective Plummer softening (added to the unscaled squared distance).
    @property
    def eps2_effective(self) -> float:
        return self.eps2 / (self.compensate * self.compensate)

    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "SimConfig":
        path = pathlib.Path(path)
        text = path.read_text()
        if path.suffix in (".toml", ".tml"):
            import tomllib

            return cls.from_dict(tomllib.loads(text))
        return cls.from_dict(json.loads(text))

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_dict(), indent=2))
