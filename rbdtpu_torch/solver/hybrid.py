"""Sampling + DDP hybrid solve (``rbdtpu.solver.hybrid``; BASELINE.json
configs[4]): MPPI explores with perturbed rollouts, then DDP refines its
plan with exact linearisations."""
from __future__ import annotations

from ..model.robot import RobotModel
from .costs import Cost
from .ddp import DDPConfig, ddp_solve
from .mppi import MPPIConfig, mppi_solve


def hybrid_solve(model: RobotModel, cost: Cost, x0, U0, generator=None,
                 mppi_config: MPPIConfig = MPPIConfig(),
                 ddp_config: DDPConfig = DDPConfig(), mppi_iters: int = 8,
                 f_ext=None, noise=None):
    """MPPI warm start, then DDP refinement, natively batched over leading
    problem dims: x0 (..., nx), U0 (..., H, nv).  ``generator`` and
    ``noise`` (iters, ..., S, H, nv) feed the MPPI stage as in
    ``mppi_solve``.  ``f_ext``: optional world-frame wrenches, (nb, 6) or
    (H, nb, 6) (``solver.rollout.normalize_f_ext``), applied in both
    stages' rollouts.  Returns (DDPState, (mppi_hist, ddp_hist))."""
    U_warm, mppi_hist = mppi_solve(model, cost, x0, U0, generator,
                                   iters=mppi_iters, config=mppi_config,
                                   f_ext=f_ext, noise=noise)
    state, ddp_hist = ddp_solve(model, cost, x0, U_warm, ddp_config,
                                f_ext=f_ext)
    return state, (mppi_hist, ddp_hist)
