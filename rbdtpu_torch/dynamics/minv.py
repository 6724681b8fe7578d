"""Minv — direct analytical inverse of the joint-space inertia matrix
(``rbdtpu.dynamics.minv``): a batched up-down tree sweep whose dense
zero-initialised F rows make the subtree restriction implicit.  A
floating root is one 6-wide block, inverted through its Cholesky factor,
whose rows span all nv columns."""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import cholesky_small, cholesky_solve_small, mv, xtax
from .xforms import joint_transforms_list


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


def minv_bpass(model: RobotModel, Xs, return_fb_Dinv: bool = False):
    """Leaf->root sweep: articulated inertias and the upper rows of M^-1.
    Returns (rows of M^-1: list of (..., n), F list of (..., 6, n), U list,
    Dinv list); a floating root's six rows are rows[0:6].  With
    ``return_fb_Dinv`` a fifth item follows, the inverse of the root's
    articulated inertia (..., 6, 6), or None on a fixed base (rbdtpu's
    ``fb_Dinv``, which the reference-compatible ``compat.minv_bpass``
    reports)."""
    nb, n = model.nb, model.nv
    batch = Xs[0].shape[:-2]
    kw = dict(dtype=Xs[0].dtype, device=Xs[0].device)
    rows = [torch.zeros(batch + (n,), **kw) for _ in range(n)]
    F = [torch.zeros(batch + (6, n), **kw) for _ in range(nb)]
    U_l, Dinv_l = [None] * nb, [None] * nb
    IA = [model.I[i] for i in range(nb)]
    fb_Dinv = None
    for i in range(nb - 1, -1, -1):
        p = model.parent[i]
        if model.floating_base and i == 0:
            # the 6x6 block's inverse, added over its own columns, minus
            # that inverse times F[0] over every column
            eye6 = torch.eye(6, **kw).expand(IA[0].shape)
            fb_Dinv = cholesky_solve_small(cholesky_small(IA[0]), eye6)
            corr = fb_Dinv @ F[0]
            for r in range(6):
                row = -corr[..., r, :]
                row[..., 0:6] = row[..., 0:6] + fb_Dinv[..., r, :]
                rows[r] = rows[r] + row
            continue
        mi = model.v_index(i)
        S = model.S[i]
        U = mv(IA[i], S)
        Dinv = 1.0 / (S * U).sum(-1)
        U_l[i], Dinv_l[i] = U, Dinv
        row = -Dinv[..., None] * (S[:, None] * F[i]).sum(-2)
        row[..., mi] = row[..., mi] + Dinv
        rows[mi] = rows[mi] + row
        if p != -1:
            F[i] = F[i] + _outer(U, rows[mi])
            F[p] = F[p] + Xs[i].transpose(-1, -2) @ F[i]
            Ia = IA[i] - Dinv[..., None, None] * _outer(U, U)
            IA[p] = IA[p] + xtax(Xs[i], Ia)
    if return_fb_Dinv:
        return rows, F, U_l, Dinv_l, fb_Dinv
    return rows, F, U_l, Dinv_l


def minv_fpass(model: RobotModel, Xs, rows, F, U_l, Dinv_l):
    """Root->leaf sweep completing the rows of M^-1."""
    rows = list(rows)
    for i in range(model.nb):
        p = model.parent[i]
        if model.floating_base and i == 0:
            F[0] = torch.stack(rows[0:6], dim=-2)  # S = I
            continue
        mi = model.v_index(i)
        S = model.S[i]
        if p == -1:
            F[i] = _outer(S, rows[mi])
        else:
            XF = Xs[i] @ F[p]
            rows[mi] = rows[mi] - Dinv_l[i][..., None] * (
                U_l[i][..., :, None] * XF).sum(-2)
            F[i] = XF + _outer(S, rows[mi])
    return rows


def minv(model: RobotModel, q, output_dense: bool = True, *, Xs=None):
    """Analytical M^-1(q): (..., nq) -> (..., nv, nv).  With output_dense the
    upper triangle is authoritative and mirrored into the lower one.
    ``Xs``: q's joint transforms, when the caller has them."""
    if Xs is None:
        Xs = joint_transforms_list(model, q)
    rows, F, U_l, Dinv_l = minv_bpass(model, Xs)
    Minv = torch.stack(minv_fpass(model, Xs, rows, F, U_l, Dinv_l), dim=-2)
    if output_dense:
        Minv = torch.triu(Minv) + torch.triu(Minv, 1).transpose(-1, -2)
    return Minv
