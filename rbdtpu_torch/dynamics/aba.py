"""ABA — articulated-body forward dynamics, O(NB) per state
(``rbdtpu.dynamics.aba``), with world-frame external wrenches (``f_ext``)
subtracted from the bias forces between sweeps 1 and 2.  The rpy floating
root is a 6-wide joint (S = I) whose 6x6 articulated block is solved by an
unrolled Cholesky factorisation: a block that is not positive definite
gives NaN, never an error."""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import (
    cholesky_small, cholesky_solve_small, cross_force, cross_motion, mtv, mv,
    xtax,
)
from .rnea import apply_external_forces, gravity_accel, joint_motion
from .xforms import joint_transforms_list


def aba(model: RobotModel, q, qd, tau, f_ext=None, gravity: float = -9.81):
    """q (..., nq), qd/tau (..., nv), f_ext None or (..., NB, 6) ->
    qdd (..., nv)."""
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
    if f_ext is not None:
        pA = apply_external_forces(model, Xs, pA, f_ext)

    # sweep 2 (leaf->root): articulated inertias
    U_l, d_l, u_l = [None] * nb, [None] * nb, [None] * nb
    fb = model.floating_base
    for i in range(nb - 1, -1, -1):
        p = model.parent[i]
        if fb and i == 0:  # U = IA S = IA, D = S^T IA S = IA
            U_l[0], d_l[0], u_l[0] = IA[0], IA[0], tau[..., 0:6] - pA[0]
            continue
        S = model.S[i]
        U = mv(IA[i], S)
        d = (S * U).sum(-1)
        u = tau[..., model.v_index(i)] - (S * pA[i]).sum(-1)
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
        if fb and i == 0:
            qdd_i = cholesky_solve_small(cholesky_small(d_l[0]),
                                         u_l[0] - mtv(U_l[0], a))
            a_l[0] = a + qdd_i
            qdd_cols[0] = qdd_i
            continue
        qdd_i = (u_l[i] - (U_l[i] * a).sum(-1)) / d_l[i]
        a_l[i] = a + model.S[i] * qdd_i[..., None]
        qdd_cols[i] = qdd_i[..., None]
    return torch.cat(qdd_cols, dim=-1)
