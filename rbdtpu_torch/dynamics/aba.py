"""ABA — articulated-body forward dynamics, O(NB) per state
(``rbdtpu.dynamics.aba``, fixed-base branch; ``f_ext`` not ported yet)."""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import cross_force, cross_motion, mtv, mv, xtax
from .rnea import gravity_accel, joint_motion
from .xforms import joint_transforms_list


def aba(model: RobotModel, q, qd, tau, gravity: float = -9.81):
    """q (..., nq), qd/tau (..., nv) -> qdd (..., nv)."""
    nb = model.nb
    Xs = joint_transforms_list(model, q)
    a_grav = gravity_accel(gravity, Xs[0].dtype, Xs[0].device)

    # sweep 1 (root->leaf): velocities, bias accelerations, bias forces
    v_l, c_l, pA = [], [], []
    IA = [model.I[i] for i in range(nb)]
    for i in range(nb):
        p = model.parent[i]
        vJ = joint_motion(model, i, qd)
        if p == -1:
            v = vJ
            c = torch.zeros_like(vJ)
        else:
            v = mv(Xs[i], v_l[p]) + vJ
            c = cross_motion(v, vJ)
        v_l.append(v)
        c_l.append(c)
        pA.append(cross_force(v, mv(model.I[i], v)))

    # sweep 2 (leaf->root): articulated inertias
    U_l, d_l, u_l = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, -1, -1):
        p = model.parent[i]
        S = model.S[i]
        U = mv(IA[i], S)
        d = (S * U).sum(-1)
        u = tau[..., i] - (S * pA[i]).sum(-1)
        U_l[i], d_l[i], u_l[i] = U, d, u
        if p != -1:
            Ia = IA[i] - U[..., :, None] * U[..., None, :] / d[..., None, None]
            pa = pA[i] + mv(Ia, c_l[i]) + U * (u / d)[..., None]
            IA[p] = IA[p] + xtax(Xs[i], Ia)
            pA[p] = pA[p] + mtv(Xs[i], pa)

    # sweep 3 (root->leaf): accelerations
    qdd_cols = [None] * nb
    a_l = [None] * nb
    for i in range(nb):
        p = model.parent[i]
        a = mv(Xs[i], a_grav if p == -1 else a_l[p]) + c_l[i]
        qdd_i = (u_l[i] - (U_l[i] * a).sum(-1)) / d_l[i]
        a_l[i] = a + model.S[i] * qdd_i[..., None]
        qdd_cols[i] = qdd_i
    return torch.stack(qdd_cols, dim=-1)
