"""Trajectory optimisation on torch tensors: DDP/iLQR with its costs,
rollouts, linearisation and backward-pass strategies, MPPI and the
MPPI -> DDP hybrid, and the receding-horizon MPC loop with solver-state
checkpoints."""
from .integrate import (
    pack_state, split_state, state_diff, state_retract, config_diff,
    config_retract, euler_semi_implicit, step_jacobians,
)
from .costs import (
    Cost, add_limit_barrier, ee_reaching_cost, quadratic_tracking_cost,
    trajectory_cost, quadratize_trajectory,
)
from .rollout import linearize_trajectory, normalize_f_ext, rollout
from .ddp import (
    DDPConfig, DDPState, ddp_solve, backward_pass, forward_pass,
    forward_pass_fused,
)
from .parallel_riccati import backward_pass_parallel
from .mppi import MPPIConfig, mppi_step, mppi_solve
from .hybrid import hybrid_solve
from .mpc import (
    MPCCarry, mpc_step, mpc_run, save_solver_state, load_solver_state,
)

__all__ = [
    "pack_state", "split_state", "state_diff", "state_retract",
    "config_diff", "config_retract", "euler_semi_implicit",
    "step_jacobians", "Cost", "add_limit_barrier", "ee_reaching_cost",
    "quadratic_tracking_cost",
    "trajectory_cost",
    "quadratize_trajectory", "linearize_trajectory", "normalize_f_ext",
    "rollout", "DDPConfig", "DDPState",
    "ddp_solve", "backward_pass", "forward_pass", "forward_pass_fused",
    "backward_pass_parallel", "MPCCarry", "mpc_step", "mpc_run",
    "save_solver_state", "load_solver_state",
    "MPPIConfig", "mppi_step", "mppi_solve", "hybrid_solve",
]
