"""Analytical RNEA gradient dc/dq and dc/dqd (``rbdtpu.dynamics.rnea_grad``):
both forward derivative sweeps fused in one pass over bodies, each body's
block a (..., 6, n) tensor over all derivative columns.

The rpy floating root's dqd columns are the identity block through the
same sweeps; its six root-pose dq columns are filled, as rbdtpu fills them,
by forward-mode derivatives of RNEA (``torch.func.jvp``, one tangent per
root coordinate)."""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import cross_force, cross_motion, mtv, mv
from .rnea import gravity_accel, rnea
from .xforms import joint_transforms_list


def _cols(fn, M, other):
    """Apply a 6-vector op to every column of M (..., 6, n)."""
    return fn(M.transpose(-1, -2), other).transpose(-1, -2)


def rnea_grad_fpass(model: RobotModel, Xs, qd, v, a, gravity=-9.81):
    """Forward derivative sweeps.  v, a: (..., NB, 6) from rnea.
    Returns (df_dq, df_dqd): lists of (..., 6, n) per body."""
    nb, n = model.nb, model.nv
    batch = Xs[0].shape[:-2]
    kw = dict(dtype=Xs[0].dtype, device=Xs[0].device)
    a_grav = gravity_accel(gravity, **kw)
    dv_q, da_q, df_q = [None] * nb, [None] * nb, [None] * nb
    dv_d, da_d, df_d = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb):
        p = model.parent[i]
        Xi = Xs[i]
        S = model.S[i]
        zeros = torch.zeros(batch + (6, n), **kw)
        if model.floating_base and i == 0:
            # root-pose dq columns come from forward-mode AD (rnea_grad);
            # dqd: dv = the identity block, da = d(v x v) = 0
            dvq, daq, dad = zeros, zeros, zeros
            dvd = zeros.clone()
            dvd[..., :, 0:6] += torch.eye(6, **kw)
        else:
            qi = model.v_index(i)
            if p == -1:
                dvq, daq, dad = zeros, zeros, zeros
                Xa_ref = mv(Xi, a_grav)
                dvd = zeros.clone()
                dvd[..., :, qi] += S
            else:
                dvq = Xi @ dv_q[p]
                dvq[..., :, qi] += cross_motion(mv(Xi, v[..., p, :]), S)
                daq = Xi @ da_q[p]
                Xa_ref = mv(Xi, a[..., p, :])
                dvd = Xi @ dv_d[p]
                dvd[..., :, qi] += S
                dad = Xi @ da_d[p]
            qd_i = qd[..., qi, None, None]
            daq = daq + qd_i * _cols(cross_motion, dvq, S)
            daq[..., :, qi] += cross_motion(Xa_ref, S)
            dad = dad + qd_i * _cols(cross_motion, dvd, S)
            dad[..., :, qi] += cross_motion(v[..., i, :], S)

        Ii = model.I[i]
        vi = v[..., i, :]
        Iv = mv(Ii, vi)[..., None, :]
        vi_c = vi[..., None, :]
        dfq = Ii @ daq + _cols(cross_force, dvq, Iv) + _cols(
            lambda m, w: cross_force(w, m), Ii @ dvq, vi_c)
        dfd = Ii @ dad + _cols(cross_force, dvd, Iv) + _cols(
            lambda m, w: cross_force(w, m), Ii @ dvd, vi_c)
        dv_q[i], da_q[i], df_q[i] = dvq, daq, dfq
        dv_d[i], da_d[i], df_d[i] = dvd, dad, dfd
    return df_q, df_d


def rnea_grad_bpass(model: RobotModel, Xs, f, df_q, df_d):
    """Backward derivative sweeps.  f: (..., NB, 6) accumulated forces.
    Returns (dc_dq, dc_dqd), each (..., n, n)."""
    nb = model.nb
    df_q, df_d = list(df_q), list(df_d)
    rows_q, rows_d = [None] * nb, [None] * nb
    for i in range(nb - 1, -1, -1):
        p = model.parent[i]
        if model.floating_base and i == 0:  # S = I: the six rows of df
            rows_q[0], rows_d[0] = df_q[0], df_d[0]
            continue
        S = model.S[i]
        rows_q[i] = (S[:, None] * df_q[i]).sum(-2, keepdim=True)
        rows_d[i] = (S[:, None] * df_d[i]).sum(-2, keepdim=True)
        if p != -1:
            Xt = Xs[i].transpose(-1, -2)
            df_q[p] = Xt @ df_q[i] + df_q[p]
            # d(X^T f)/dq_i = X^T crf(S) f, injected into column i
            df_q[p][..., :, model.v_index(i)] += mtv(
                Xs[i], cross_force(S, f[..., i, :]))
            df_d[p] = Xt @ df_d[i] + df_d[p]
    return torch.cat(rows_q, dim=-2), torch.cat(rows_d, dim=-2)


def rnea_grad(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81,
              split: bool = False):
    """d(tau)/d(q, qd) of inverse dynamics: (..., n, 2n), or the
    (dc_dq, dc_dqd) pair when split=True."""
    Xs = joint_transforms_list(model, q)
    _, v, a, f = rnea(model, q, qd, qdd, gravity)
    df_q, df_d = rnea_grad_fpass(model, Xs, qd, v, a, gravity)
    dc_dq, dc_dqd = rnea_grad_bpass(model, Xs, f, df_q, df_d)
    if model.floating_base:
        dc_dq[..., :, 0:6] = _root_pose_columns(model, q, qd, qdd, gravity)
    if split:
        return dc_dq, dc_dqd
    return torch.cat([dc_dq, dc_dqd], dim=-1)


def _root_pose_columns(model: RobotModel, q, qd, qdd, gravity):
    """d tau / d q[0:6] of the rpy root by forward-mode AD through RNEA:
    (..., nv, 6)."""
    rest = q[..., 6:]
    tau_of_root = lambda r6: rnea(model, torch.cat([r6, rest], -1), qd, qdd,
                                  gravity)[0]
    cols = []
    for j in range(6):
        tangent = torch.zeros_like(q[..., 0:6])
        tangent[..., j] = 1.0
        cols.append(torch.func.jvp(tau_of_root, (q[..., 0:6],),
                                   (tangent,))[1])
    return torch.stack(cols, dim=-1)
