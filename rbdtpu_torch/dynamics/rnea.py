"""RNEA — recursive Newton-Euler inverse dynamics (``rbdtpu.dynamics.rnea``),
with world-frame external wrenches (``f_ext``).

Batched over arbitrary leading dims; the two tree sweeps loop over bodies.
Fixed-base models and the floating roots (a 6-DoF joint with S = I, its
pose from rpy angles or a quaternion: ``xforms``).
"""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import cross_force, cross_motion, mtv, mv
from ..spatial.transforms import x_force_inv_T
from .xforms import joint_transforms_list


def gravity_accel(gravity: float, dtype=torch.float32, device="cpu"):
    """Fictitious base acceleration encoding gravity: [0,0,0,0,0,-gravity]."""
    g = torch.zeros(6, dtype=dtype, device=device)
    g[5] = -gravity
    return g


def joint_motion(model: RobotModel, i: int, u):
    """S_i * u_i: (..., nv) -> (..., 6); a floating root's S is the identity,
    so its motion is u[..., 0:6]."""
    if model.floating_base and i == 0:
        return u[..., 0:6]
    return model.S[i] * u[..., model.v_index(i), None]


def joint_force(model: RobotModel, i: int, f):
    """S_i^T f: (..., 6) -> (..., k), the k = 6 rows of a floating root or the
    one row of a 1-DoF joint."""
    if model.floating_base and i == 0:
        return f
    return (model.S[i] * f).sum(-1, keepdim=True)


def apply_external_forces(model: RobotModel, Xs, f_list, f_ext):
    """Subtract world-frame wrenches from per-body forces:
    f[i] -= Xa[i]^{-T} f_ext[i] with the world->body chain
    Xa[i] = Xs[i] @ Xa[parent].  f_list: list of (..., 6); f_ext
    (..., NB, 6)."""
    Xa = [None] * model.nb
    out = list(f_list)
    for i in range(model.nb):
        p = model.parent[i]
        Xa[i] = Xs[i] if p == -1 else Xs[i] @ Xa[p]
        out[i] = out[i] - mv(x_force_inv_T(Xa[i]), f_ext[..., i, :])
    return out


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
        c_cols[i] = joint_force(model, i, f_l[i])
        if p != -1:
            f_l[p] = f_l[p] + mtv(Xs[i], f_l[i])
    return torch.cat(c_cols, dim=-1), f_l


def rnea(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81,
         f_ext=None, *, Xs=None):
    """Inverse dynamics with optional world-frame wrenches f_ext (..., NB, 6).
    ``Xs``: q's joint transforms, when the caller has them.
    Returns (c (..., nv), v, a, f (..., NB, 6))."""
    if Xs is None:
        Xs = joint_transforms_list(model, q)
    v_l, a_l, f_l = rnea_fpass(model, Xs, qd, qdd, gravity)
    if f_ext is not None:
        f_l = apply_external_forces(model, Xs, f_l, f_ext)
    c, f_l = rnea_bpass(model, Xs, f_l)
    stack = lambda xs: torch.stack(xs, dim=-2)
    return c, stack(v_l), stack(a_l), stack(f_l)


def inverse_dynamics(model: RobotModel, q, qd, qdd=None,
                     gravity: float = -9.81, f_ext=None):
    """The joint forces of ``rnea`` alone: (..., nv)."""
    return rnea(model, q, qd, qdd, gravity, f_ext)[0]
