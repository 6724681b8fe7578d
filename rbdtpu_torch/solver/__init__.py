"""Trajectory optimisation on torch tensors: DDP/iLQR with its costs,
rollouts and linearisation."""
from .integrate import (
    pack_state, split_state, state_diff, euler_semi_implicit, step_jacobians,
)
from .costs import (
    Cost, ee_reaching_cost, quadratic_tracking_cost, trajectory_cost,
    quadratize_trajectory,
)
from .rollout import linearize_trajectory, normalize_f_ext, rollout
from .ddp import (
    DDPConfig, DDPState, ddp_solve, backward_pass, forward_pass,
    forward_pass_fused,
)

__all__ = [
    "pack_state", "split_state", "state_diff", "euler_semi_implicit",
    "step_jacobians", "Cost", "ee_reaching_cost", "quadratic_tracking_cost",
    "trajectory_cost",
    "quadratize_trajectory", "linearize_trajectory", "normalize_f_ext",
    "rollout", "DDPConfig", "DDPState",
    "ddp_solve", "backward_pass", "forward_pass", "forward_pass_fused",
]
