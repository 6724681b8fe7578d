"""State representation, the semi-implicit Euler integrator and the
tangent chart of the state (``rbdtpu.solver.integrate``).

State x = [q; qd] (nq + nv).  Fixed-base models and the rpy root keep the
flat chart: x1 (-) x0 = x1 - x0 and q' = q + dt qd'.  On the quaternion
root (nq = nv + 1) the configuration lives on R^3 x S^3 x R^(nb - 1) and
the solver works in the 2 nv-wide tangent: ``config_retract`` and
``config_diff`` define the chart (root rotation tangent = body-frame
rotation vector, root translation tangent = body-frame displacement, the
coordinates of the root twist), and ``euler_semi_implicit`` integrates the
root on the manifold through the quaternion exponential.
"""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import skew
from ..spatial.quat import (
    quat_conj, quat_exp, quat_log, quat_mul, quat_normalize, quat_to_R,
    so3_right_jacobian,
)


def _quat_root(model: RobotModel) -> bool:
    return model.floating_base and model.root_quat


def pack_state(q, qd):
    return torch.cat([q, qd], dim=-1)


def split_state(model: RobotModel, x):
    return x[..., : model.nq], x[..., model.nq:]


def config_retract(model: RobotModel, q, xi):
    """q (+) xi: a tangent step xi (..., nv) applied to q (..., nq).  Flat
    except on the quaternion root, where xi[0:3] is a body-frame rotation
    vector and xi[3:6] a body-frame translation."""
    if not _quat_root(model):
        return q + xi
    p, quat, rest = q[..., 0:3], q[..., 3:7], q[..., 7:]
    dth, dp, drest = xi[..., 0:3], xi[..., 3:6], xi[..., 6:]
    quat_new = quat_normalize(quat_mul(quat, quat_exp(dth)))
    p_new = p + (quat_to_R(quat) * dp[..., None, :]).sum(-1)
    return torch.cat([p_new, quat_new, rest + drest], dim=-1)


def config_diff(model: RobotModel, q1, q0):
    """q1 (-) q0 -> tangent (..., nv): the inverse of ``config_retract`` to
    first order (exact for the rotation, through the quaternion log)."""
    if not _quat_root(model):
        return q1 - q0
    dth = quat_log(quat_mul(quat_conj(q0[..., 3:7]), q1[..., 3:7]))
    R0 = quat_to_R(q0[..., 3:7])
    dp = ((q1[..., 0:3] - q0[..., 0:3])[..., :, None] * R0).sum(-2)
    return torch.cat([dth, dp, q1[..., 7:] - q0[..., 7:]], dim=-1)


def state_retract(model: RobotModel, x, xi):
    """x (+) xi with xi (..., 2 nv) = [config tangent; velocity delta]."""
    if not _quat_root(model):
        return x + xi
    q, qd = split_state(model, x)
    n = model.nv
    return pack_state(config_retract(model, q, xi[..., :n]), qd + xi[..., n:])


def state_diff(model: RobotModel, x1, x0):
    """x1 (-) x0 -> (..., 2 nv) tangent; x1 - x0 unless quaternion root."""
    if not _quat_root(model):
        return x1 - x0
    q1, qd1 = split_state(model, x1)
    q0, qd0 = split_state(model, x0)
    return torch.cat([config_diff(model, q1, q0), qd1 - qd0], dim=-1)


def euler_semi_implicit(model: RobotModel, x, qdd, dt: float):
    """x' = [q (+) dt qd', qd'] with qd' = qd + dt qdd: flat q + dt qd' on
    the fixed base and the rpy root, the manifold retraction on the
    quaternion root."""
    q, qd = split_state(model, x)
    qd_new = qd + dt * qdd
    if _quat_root(model):
        return pack_state(config_retract(model, q, dt * qd_new), qd_new)
    return pack_state(q + dt * qd_new, qd_new)


def step_jacobians(model: RobotModel, Mi, dqdd_dq, dqdd_dqd, dt: float,
                   qd_new=None):
    """Exact A = dx'/dx, B = dx'/du of the semi-implicit Euler step, in the
    tangent chart (2 nv x 2 nv and 2 nv x nv):

    A = [[I + dt² ∂qdd/∂q,  dt I + dt² ∂qdd/∂qd],
         [dt   ∂qdd/∂q,     I    + dt  ∂qdd/∂qd]]
    B = [[dt² M⁻¹], [dt M⁻¹]]

    On the quaternion root ∂qdd/∂q holds tangent columns and the root pose
    rows take the SO(3) transport of the retraction, which needs the
    post-step twist ``qd_new`` (..., nv):

      δθ' = exp(-ŵ) ξθ + dt Jr(w) δω'            w  = dt ω'
      δp' = exp(-ŵ)(ξp + dt ξθ × v' + dt δv')    v' = the post-step linear
    twist (rbdtpu solver/integrate.py:127-166).
    """
    n = model.nv
    dt2 = dt * dt
    eye = torch.eye(n, dtype=Mi.dtype, device=Mi.device)
    A_qq = eye + dt2 * dqdd_dq
    A_qv = dt * eye + dt2 * dqdd_dqd
    A_vq = dt * dqdd_dq
    A_vv = eye + dt * dqdd_dqd
    B_v = dt * Mi
    B_q = dt2 * Mi
    if _quat_root(model):
        if qd_new is None:
            raise ValueError("quaternion-root step_jacobians needs qd_new")
        w = dt * qd_new[..., 0:3]
        vl = qd_new[..., 3:6]
        Rt = quat_to_R(quat_exp(-w))  # exp(-w^)
        Jr = so3_right_jacobian(w)
        zero3 = torch.zeros_like(Rt)
        T2 = torch.cat([torch.cat([dt * Jr, zero3], -1),
                        torch.cat([zero3, dt * Rt], -1)], -2)
        T1 = torch.cat([torch.cat([Rt, zero3], -1),
                        torch.cat([-dt * (Rt @ skew(vl)), Rt], -1)], -2)
        pose_q = T2 @ A_vq[..., 0:6, :]
        pose_q = torch.cat([pose_q[..., 0:6] + T1, pose_q[..., 6:]], -1)
        A_qq = torch.cat([pose_q, A_qq[..., 6:, :]], -2)
        A_qv = torch.cat([T2 @ A_vv[..., 0:6, :], A_qv[..., 6:, :]], -2)
        B_q = torch.cat([T2 @ B_v[..., 0:6, :], B_q[..., 6:, :]], -2)
    A = torch.cat([torch.cat([A_qq, A_qv], -1), torch.cat([A_vq, A_vv], -1)],
                  dim=-2)
    B = torch.cat([B_q, B_v], dim=-2)
    return A, B
