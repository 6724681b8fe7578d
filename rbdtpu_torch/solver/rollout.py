"""Batched linearisation along a trajectory (``rbdtpu.solver.rollout``)."""
from __future__ import annotations

from ..dynamics.fd import forward_dynamics_full
from ..model.robot import RobotModel
from .integrate import split_state, step_jacobians


def linearize_trajectory(model: RobotModel, X, U, dt: float,
                         gravity: float = -9.81):
    """Per-knot discrete Jacobians: X (..., H+1, nx), U (..., H, nv) ->
    A (..., H, nx, nx), B (..., H, nx, nv), all knots in one batched sweep."""
    q, qd = split_state(model, X[..., :-1, :])
    _, Mi, dq, dqd = forward_dynamics_full(model, q, qd, U, gravity)
    return step_jacobians(model, Mi, dq, dqd, dt)
