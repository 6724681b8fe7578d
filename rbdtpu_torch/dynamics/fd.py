"""Forward dynamics (Minv route), its gradient and its one-pass
linearization (``rbdtpu.dynamics.fd``)."""
from __future__ import annotations

from ..model.robot import RobotModel
from ..spatial.ops import mv
from .minv import minv
from .rnea import rnea
from .rnea_grad import rnea_grad
from .xforms import joint_transforms_list


def forward_dynamics(model: RobotModel, q, qd, u, gravity: float = -9.81,
                     f_ext=None):
    """qdd = M^-1 (u - C(q, qd)), the bias C carrying the world-frame
    wrenches f_ext (..., NB, 6) when given."""
    Xs = joint_transforms_list(model, q)
    c = rnea(model, q, qd, None, gravity, f_ext, Xs=Xs)[0]
    return mv(minv(model, q, Xs=Xs), u - c)


def forward_dynamics_grad(model: RobotModel, q, qd, u,
                          gravity: float = -9.81):
    """(d qdd/dq, d qdd/dqd) = (-M^-1 dc/dq, -M^-1 dc/dqd) at
    qdd = FD(q, qd, u)."""
    return forward_dynamics_full(model, q, qd, u, gravity)[2:]


def forward_dynamics_full(model: RobotModel, q, qd, u, gravity: float = -9.81,
                          *, Xs=None):
    """qdd and its linearization sharing M^-1: (qdd, Mi, dqdd_dq, dqdd_dqd).
    ``Xs``: q's joint transforms, when the caller has them."""
    if Xs is None:
        Xs = joint_transforms_list(model, q)
    c = rnea(model, q, qd, None, gravity, Xs=Xs)[0]
    Mi = minv(model, q, Xs=Xs)
    qdd = mv(Mi, u - c)
    dc_dq, dc_dqd = rnea_grad(model, q, qd, qdd, gravity, split=True, Xs=Xs)
    return qdd, Mi, -(Mi @ dc_dq), -(Mi @ dc_dqd)
