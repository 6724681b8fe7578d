"""Forward dynamics (Minv route) and its one-pass linearization
(``rbdtpu.dynamics.fd``)."""
from __future__ import annotations

from ..model.robot import RobotModel
from ..spatial.ops import mv
from .minv import minv
from .rnea import rnea
from .rnea_grad import rnea_grad


def forward_dynamics(model: RobotModel, q, qd, u, gravity: float = -9.81,
                     f_ext=None):
    """qdd = M^-1 (u - C(q, qd)), the bias C carrying the world-frame
    wrenches f_ext (..., NB, 6) when given."""
    c = rnea(model, q, qd, None, gravity, f_ext)[0]
    return mv(minv(model, q), u - c)


def forward_dynamics_full(model: RobotModel, q, qd, u, gravity: float = -9.81):
    """qdd and its linearization sharing M^-1: (qdd, Mi, dqdd_dq, dqdd_dqd)."""
    c = rnea(model, q, qd, None, gravity)[0]
    Mi = minv(model, q)
    qdd = mv(Mi, u - c)
    dc_dq, dc_dqd = rnea_grad(model, q, qd, qdd, gravity, split=True)
    return qdd, Mi, -(Mi @ dc_dq), -(Mi @ dc_dqd)
