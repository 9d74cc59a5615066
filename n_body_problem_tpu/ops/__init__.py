from n_body_problem_tpu.ops.forces import (
    direct_acc,
    blocked_acc,
    mxu_acc,
    pair_accel_tile,
)
from n_body_problem_tpu.ops.registry import make_force_fn
from n_body_problem_tpu.ops import integrators

__all__ = [
    "direct_acc",
    "blocked_acc",
    "mxu_acc",
    "pair_accel_tile",
    "make_force_fn",
    "integrators",
]
