"""RNEA — recursive Newton-Euler inverse dynamics (``rbdtpu.dynamics.rnea``).

Batched over arbitrary leading dims; the two tree sweeps loop over bodies.
External forces (``f_ext``) are not ported yet.
"""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import cross_force, cross_motion, mtv, mv
from .xforms import joint_transforms_list


def gravity_accel(gravity: float, dtype=torch.float32, device="cpu"):
    """Fictitious base acceleration encoding gravity: [0,0,0,0,0,-gravity]."""
    g = torch.zeros(6, dtype=dtype, device=device)
    g[5] = -gravity
    return g


def joint_motion(model: RobotModel, i: int, u):
    """S_i * u_i: (..., nv) -> (..., 6)."""
    return model.S[i] * u[..., i, None]


def rnea_fpass(model: RobotModel, Xs, qd, qdd=None, gravity: float = -9.81):
    """Root->leaf sweep: body velocities, accelerations and forces (lists)."""
    a_grav = gravity_accel(gravity, Xs[0].dtype, Xs[0].device)
    v_l, a_l, f_l = [], [], []
    for i in range(model.nb):
        p = model.parent[i]
        Xi = Xs[i]
        vJ = joint_motion(model, i, qd)
        if p == -1:
            v = vJ
            a = mv(Xi, a_grav)
        else:
            v = mv(Xi, v_l[p]) + vJ
            a = mv(Xi, a_l[p])
        a = a + cross_motion(v, vJ)
        if qdd is not None:
            a = a + joint_motion(model, i, qdd)
        f = mv(model.I[i], a) + cross_force(v, mv(model.I[i], v))
        v_l.append(v)
        a_l.append(a)
        f_l.append(f)
    return v_l, a_l, f_l


def rnea_bpass(model: RobotModel, Xs, f_list):
    """Leaf->root sweep: c = S^T f and f[parent] += X^T f.
    Returns (c (..., nv), accumulated force list)."""
    f_l = list(f_list)
    c_cols = [None] * model.nb
    for i in range(model.nb - 1, -1, -1):
        p = model.parent[i]
        c_cols[i] = (model.S[i] * f_l[i]).sum(-1)
        if p != -1:
            f_l[p] = f_l[p] + mtv(Xs[i], f_l[i])
    return torch.stack(c_cols, dim=-1), f_l


def rnea(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81):
    """Inverse dynamics.  Returns (c (..., nv), v, a, f (..., NB, 6))."""
    Xs = joint_transforms_list(model, q)
    v_l, a_l, f_l = rnea_fpass(model, Xs, qd, qdd, gravity)
    c, f_l = rnea_bpass(model, Xs, f_l)
    stack = lambda xs: torch.stack(xs, dim=-2)
    return c, stack(v_l), stack(a_l), stack(f_l)
