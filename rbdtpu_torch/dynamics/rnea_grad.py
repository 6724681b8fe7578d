"""Analytical RNEA gradient dc/dq and dc/dqd (``rbdtpu.dynamics.rnea_grad``):
both forward derivative sweeps fused in one pass over bodies, each body's
block a (..., 6, n) tensor over all derivative columns.

A floating root's dqd columns are the identity block through the same
sweeps.  Its six root-pose dq columns (the rpy root's coordinates, or the
quaternion root's body-twist tangent) are M[:, 0:6] times the derivative
of the gravity seed: the root pose enters RNEA only through the root's
base acceleration u6 = X0 a_grav, in which tau is linear with coefficient
M[:, 0:6].  rbdtpu differentiates all of RNEA in forward mode for them;
the port differentiates only u6 (``gravity_seed_derivs``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..model.robot import RobotModel
from ..spatial.ops import cross_force, cross_motion, mtv, mv
from .crba import composite_inertias
from .rnea import gravity_accel, rnea
from .xforms import joint_transforms_list


def _cols(fn, M, other):
    """Apply a 6-vector op to every column of M (..., 6, n)."""
    return fn(M.transpose(-1, -2), other).transpose(-1, -2)


def _col(x, j: int, n: int):
    """x (..., r, c) placed at columns j:j+c of a zero (..., r, n) block.
    Out of place, so the sweeps stay differentiable by ``torch.func``
    (``dynamics.idsva.idsva_so_ad``)."""
    return F.pad(x, (j, n - j - x.shape[-1]))


def rnea_grad_fpass(model: RobotModel, Xs, qd, v, a, gravity=-9.81,
                    full: bool = False):
    """Forward derivative sweeps.  v, a: (..., NB, 6) from rnea.
    Returns (df_dq, df_dqd): lists of (..., 6, n) per body; with ``full``
    all six lists (dv_dq, da_dq, df_dq, dv_dqd, da_dqd, df_dqd), rbdtpu's
    ``full=True`` (the reference's separate fpass intermediates, which
    ``compat`` reports).  A floating root's dq columns are zero here
    (``rnea_grad`` fills them)."""
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
            # root-pose dq columns come from the gravity seed (rnea_grad);
            # dqd: dv = the identity block, da = d(v x v) = 0
            dvq, daq, dad = zeros, zeros, zeros
            dvd = zeros + _col(torch.eye(6, **kw), 0, n)
        else:
            qi = model.v_index(i)
            if p == -1:
                dvq, daq, dad = zeros, zeros, zeros
                Xa_ref = mv(Xi, a_grav)
                dvd = zeros + _col(S[:, None], qi, n)
            else:
                dvq = Xi @ dv_q[p] + _col(
                    cross_motion(mv(Xi, v[..., p, :]), S)[..., None], qi, n)
                daq = Xi @ da_q[p]
                Xa_ref = mv(Xi, a[..., p, :])
                dvd = Xi @ dv_d[p] + _col(S[:, None], qi, n)
                dad = Xi @ da_d[p]
            qd_i = qd[..., qi, None, None]
            daq = (daq + qd_i * _cols(cross_motion, dvq, S)
                   + _col(cross_motion(Xa_ref, S)[..., None], qi, n))
            dad = (dad + qd_i * _cols(cross_motion, dvd, S)
                   + _col(cross_motion(v[..., i, :], S)[..., None], qi, n))

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
    if full:
        return dv_q, da_q, df_q, dv_d, da_d, df_d
    return df_q, df_d


def rnea_grad_bpass(model: RobotModel, Xs, f, df_q, df_d,
                    use_damping: bool = False):
    """Backward derivative sweeps.  f: (..., NB, 6) accumulated forces.
    Returns (dc_dq, dc_dqd), each (..., n, n); with ``use_damping`` dc_dqd
    adds the joints' damping on its diagonal (``damping_diagonal``)."""
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
            # d(X^T f)/dq_i = X^T crf(S) f, injected into column i
            df_q[p] = Xt @ df_q[i] + df_q[p] + _col(
                mtv(Xs[i], cross_force(S, f[..., i, :]))[..., None],
                model.v_index(i), df_q[p].shape[-1])
            df_d[p] = Xt @ df_d[i] + df_d[p]
    dc_dqd = torch.cat(rows_d, dim=-2)
    if use_damping:
        dc_dqd = dc_dqd + torch.diag(damping_diagonal(model))
    return torch.cat(rows_q, dim=-2), dc_dqd


def damping_diagonal(model: RobotModel):
    """The joints' damping by velocity coordinate (nv,): a floating root's
    damping on its six rows (rbdtpu dynamics/rnea_grad.py:179-187)."""
    d = model.damping
    if model.floating_base:
        return torch.cat([d[:1].expand(6), d[1:]])
    return d


def rnea_grad(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81,
              use_damping: bool = False, split: bool = False, *, Xs=None):
    """d(tau)/d(q, qd) of inverse dynamics: (..., n, 2n), or the
    (dc_dq, dc_dqd) pair when split=True; ``use_damping`` adds the joints'
    damping to dc_dqd's diagonal (rbdtpu's signature).  ``Xs``: q's joint
    transforms, when the caller has them."""
    if Xs is None:
        Xs = joint_transforms_list(model, q)
    _, v, a, f = rnea(model, q, qd, qdd, gravity, Xs=Xs)
    df_q, df_d = rnea_grad_fpass(model, Xs, qd, v, a, gravity)
    dc_dq, dc_dqd = rnea_grad_bpass(model, Xs, f, df_q, df_d, use_damping)
    if model.floating_base:
        root = torch.einsum("...ik,...kj->...ij", root_inertia_columns(
            model, Xs), gravity_seed_derivs(model, q, gravity)[0])
        dc_dq = torch.cat([root, dc_dq[..., :, 6:]], dim=-1)
    if split:
        return dc_dq, dc_dqd
    return torch.cat([dc_dq, dc_dqd], dim=-1)


def root_inertia_columns(model: RobotModel, Xs):
    """The floating root's six columns of the mass matrix, M[:, 0:6]:
    (..., nv, 6).  Rows 0:6 are the composite inertia of the whole tree;
    joint i's row is S_i^T IC_i X_(i<-0), its composite inertia carried to
    the root frame."""
    nb = model.nb
    IC = composite_inertias(model, Xs)
    Xc = [None] * nb
    rows = [IC[0]]
    for i in range(1, nb):
        p = model.parent[i]
        Xc[i] = Xs[i] if p == 0 else Xs[i] @ Xc[p]
        rows.append(mtv(Xc[i], mv(IC[i], model.S[i]))[..., None, :])
    return torch.cat(rows, dim=-2)


def gravity_seed_derivs(model: RobotModel, q, gravity: float = -9.81,
                        second: bool = False):
    """Derivatives of the floating root's gravity seed u6 = X0 a_grav (the
    root frame's base acceleration, through which alone the root pose
    enters RNEA) in the root's six coordinates c: du6/dc (..., 6, 6) and,
    with ``second``, d2u6/dc2 (..., 6, 6, 6).  The coordinates are the rpy
    root's q[0:6], or the quaternion root's body-twist tangent [dtheta;
    dp_body] at 0 through the retraction quat (x) exp(dtheta), p + R dp
    (rbdtpu differentiates that retraction in forward mode,
    dynamics/rnea_grad.py:215-228 and dynamics/idsva.py:400-431).

    Closed form: Xtree0 keeps a_grav's angular part 0, so u6 = [0; E w]
    with w the linear part of Xtree0 a_grav and E = R^T the root's
    coordinate rotation; only the rotation coordinates enter.  rpy, R =
    Rz(yaw) Ry(pitch) Rx(roll): each derivative replaces the factors of the
    coordinates it takes by their derivatives.  Quaternion, R exp(dtheta)
    at 0: dE/dtheta_k = -K_k E and d2E/dtheta_k dtheta_l = (K_k K_l +
    K_l K_k) E / 2, K_k = skew(e_k)."""
    from ..spatial.ops import skew
    from ..spatial.quat import quat_to_R
    from ..spatial.transforms import d2rot_axis, drot_axis, rot_axis

    kw = dict(dtype=q.dtype, device=q.device)
    w = mv(model.Xtree[0], gravity_accel(gravity, **kw))[3:6]
    eye3 = torch.eye(3, **kw)
    if model.root_quat:
        ul = mv(quat_to_R(q[..., 3:7]).transpose(-1, -2), w)  # E w
        K = skew(eye3)  # K[k] = skew(e_k)
        # [..., i, k] = d(E w)_i / dtheta_k
        d1 = -mv(K, ul[..., None, :]).transpose(-1, -2)
        KK = K[:, None] @ K[None, :]
        d2 = 0.5 * mv(KK + KK.transpose(0, 1), ul[..., None, None, :])
        d2 = d2.movedim(-1, -3)  # [..., i, k, l]
        c0 = 0
    else:
        th = q[..., 3:6]
        # each coordinate's factor and its first and second derivative,
        # R = F[2] F[1] F[0]
        F_ = [[f(eye3[j], th[..., j]) for f in (rot_axis, drot_axis,
                                                 d2rot_axis)]
              for j in range(3)]
        R_of = lambda o: F_[2][o[2]] @ F_[1][o[1]] @ F_[0][o[0]]
        Ew = lambda o: mv(R_of(o).transpose(-1, -2), w)
        unit = lambda *js: tuple(sum(1 for j in js if j == k)
                                 for k in range(3))
        d1 = torch.stack([Ew(unit(k)) for k in range(3)], dim=-1)
        d2 = torch.stack([torch.stack([Ew(unit(k, l)) for l in range(3)],
                                      dim=-1) for k in range(3)], dim=-2)
        c0 = 3
    out = (F.pad(d1, (c0, 3 - c0, 3, 0)),)
    if second:
        out += (F.pad(d2, (c0, 3 - c0, c0, 3 - c0, 3, 0)),)
    return out
