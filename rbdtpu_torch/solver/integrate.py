"""State representation and the semi-implicit Euler integrator
(``rbdtpu.solver.integrate``, flat-chart branch).  The quaternion root's
manifold chart is not ported yet and raises ``NotImplementedError``."""
from __future__ import annotations

import torch

from ..model.robot import RobotModel


def _require_flat_chart(model: RobotModel):
    if model.floating_base and model.root_quat:
        raise NotImplementedError(
            "the quaternion-root tangent chart is not ported yet")


def pack_state(q, qd):
    return torch.cat([q, qd], dim=-1)


def split_state(model: RobotModel, x):
    return x[..., : model.nq], x[..., model.nq:]


def state_diff(model: RobotModel, x1, x0):
    """x1 (-) x0: the flat difference."""
    _require_flat_chart(model)
    return x1 - x0


def euler_semi_implicit(model: RobotModel, x, qdd, dt: float):
    """x' = [q + dt*qd', qd'] with qd' = qd + dt*qdd."""
    _require_flat_chart(model)
    q, qd = split_state(model, x)
    qd_new = qd + dt * qdd
    return pack_state(q + dt * qd_new, qd_new)


def step_jacobians(model: RobotModel, Mi, dqdd_dq, dqdd_dqd, dt: float):
    """Exact A = dx'/dx, B = dx'/du of the semi-implicit Euler step:

    A = [[I + dt² ∂qdd/∂q,  dt I + dt² ∂qdd/∂qd],
         [dt   ∂qdd/∂q,     I    + dt  ∂qdd/∂qd]]
    B = [[dt² M⁻¹], [dt M⁻¹]]
    """
    _require_flat_chart(model)
    dt2 = dt * dt
    eye = torch.eye(model.nv, dtype=Mi.dtype, device=Mi.device)
    A = torch.cat(
        [
            torch.cat([eye + dt2 * dqdd_dq, dt * eye + dt2 * dqdd_dqd], -1),
            torch.cat([dt * dqdd_dq, eye + dt * dqdd_dqd], -1),
        ],
        dim=-2,
    )
    B = torch.cat([dt2 * Mi, dt * Mi], dim=-2)
    return A, B
