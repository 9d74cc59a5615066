"""Execution plan: which solver and which form of each stage runs where.

One function, :func:`execution_plan`, decides from the platform of the
first JAX device what ``solver="auto"`` means, whether the treecode plans
its compacted flat/hierarchical work lists on its own, and, for every
stage that has both a hand-written GPU kernel and a plain XLA form,
which of the two runs. ``Simulation`` and ``ShardedSimulation`` call it
once at construction; the force functions take the plan as a static
argument (a frozen, hashable dataclass), so nothing below them asks the
backend again.

- ``gpu``: the compacted hierarchical treecode lists plus the compiled
  Pallas (Triton) kernels that beat their XLA forms on the card
  (``PERF.md`` holds both timings for each).
- ``cpu``: the plain XLA forms everywhere; the treecode takes the dense
  per-target path unless capacities are given explicitly.
- any other platform raises.

``interpret`` is False in every plan this module returns. Tests that run
the GPU kernels through the Pallas interpreter on the CPU set it on a
copy (``dataclasses.replace(plan, interpret=True)``); nothing in the
library does.
"""

from __future__ import annotations

import dataclasses

KERNEL = "kernel"
XLA = "xla"


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Per-platform choices (see the module docstring).

    ``exact``: the concrete solver ``"auto"`` resolves to.
    ``tree_lists``: the treecode plans compacted flat/hierarchical work
    lists itself when ``tree_flat_cap == 0`` (otherwise it takes the
    dense per-target path unless capacities are given).
    ``near``: flat near field (compacted source-tile lists).
    ``far``: the hierarchical far field (compacted multi-level lists).
    ``pair``: the all-pairs block operation wherever it appears outside
    the exact solver itself — the ring stage of the sharded exact
    solvers and both halves of the treecode's VIP sweep.
    """

    platform: str
    exact: str
    tree_lists: bool
    near: str
    far: str
    pair: str
    interpret: bool = False

    @property
    def near_kernel(self) -> bool:
        return self.near == KERNEL

    @property
    def far_kernel(self) -> bool:
        return self.far == KERNEL

    @property
    def pair_kernel(self) -> bool:
        return self.pair == KERNEL

    def solver(self, requested: str) -> str:
        """Concrete solver for a requested one; kernel-only solvers
        refuse platforms that cannot compile them."""
        solver = self.exact if requested == "auto" else requested
        if solver in KERNEL_SOLVERS and self.platform != "gpu" \
                and not self.interpret:
            raise ValueError(
                f"solver {solver!r} is a GPU kernel; on platform "
                f"{self.platform!r} use 'auto', 'blocked', 'mxu' or "
                "'direct'")
        return solver

    def tree_variant(self, cfg, n: int, n_dev: int = 1,
                     lists: bool | None = None) -> str:
        """``"hier"``, ``"flat"`` or ``"dense"``: which treecode path a
        (padded) population of ``n`` bodies takes under ``cfg``.
        ``lists`` overrides ``tree_lists`` (the staged multi-device
        strategy is built on the compacted lists on every platform)."""
        from n_body_problem_tpu.ops.treecode import CHUNK_LANES, FAR_ENTRIES

        lists = self.tree_lists if lists is None else lists
        explicit = cfg.tree_flat_cap > 0
        planned = (cfg.tree_flat_cap == 0 and lists
                   and n >= CHUNK_LANES and n % cfg.tree_src_tile == 0)
        if not (explicit or planned):
            return "dense"
        tile = cfg.tree_tile or 32
        hier = (cfg.tree_hier and n >= FAR_ENTRIES * cfg.tree_src_tile
                and (n // tile) % n_dev == 0
                and (planned or cfg.tree_far_cap > 0))
        return "hier" if hier else "flat"


# Solvers that exist only as compiled GPU kernels.
KERNEL_SOLVERS = ("pallas",)

_PLANS = {
    "gpu": ExecutionPlan(platform="gpu", exact="pallas", tree_lists=True,
                         near=KERNEL, far=KERNEL, pair=KERNEL),
    "cpu": ExecutionPlan(platform="cpu", exact="mxu", tree_lists=False,
                         near=XLA, far=XLA, pair=XLA),
}


def execution_plan(platform: str | None = None) -> ExecutionPlan:
    """The plan for ``platform`` (default: ``jax.devices()[0].platform``).

    Raises ``ValueError`` for a platform this program has no plan for.
    """
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    try:
        return _PLANS[platform]
    except KeyError:
        raise ValueError(
            f"no execution plan for platform {platform!r}; this program "
            f"runs on {sorted(_PLANS)}") from None
