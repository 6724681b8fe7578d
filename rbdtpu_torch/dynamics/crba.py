"""CRBA — the composite-rigid-body mass matrix H(q)
(``rbdtpu.dynamics.crba``): composite inertias accumulate leaf->root, then
each body's force vector is carried up its ancestor chain, giving one block
of H per (body, ancestor) pair; a floating root contributes its 6x6 block
(S = I).  The blocks are assembled with ``torch.cat``, out of place, so
``torch.func`` differentiates it (``dynamics.idsva.idsva_so_ad``)."""
from __future__ import annotations

import torch

from ..model.robot import RobotModel
from ..spatial.ops import mtv, mv, xtax
from .xforms import joint_transforms_list


def composite_inertias(model: RobotModel, Xs):
    """Each body's composite inertia IC_i, its own and its subtree's
    carried in by the joint transforms ``Xs``, leaf to root: a list of
    (..., 6, 6) in the body's frame."""
    batch = Xs[0].shape[:-2]
    IC = [I.expand(batch + (6, 6)) for I in model.I]
    for i in range(model.nb - 1, 0, -1):
        p = model.parent[i]
        if p != -1:
            IC[p] = IC[p] + xtax(Xs[i], IC[i])
    return IC


def crba(model: RobotModel, q):
    """Mass matrix H: (..., nq) -> (..., nv, nv)."""
    nb = model.nb
    Xs = joint_transforms_list(model, q)
    batch = Xs[0].shape[:-2]
    kw = dict(dtype=Xs[0].dtype, device=Xs[0].device)
    root = lambda i: model.floating_base and i == 0
    IC = composite_inertias(model, Xs)

    blocks = {}
    for i in range(nb):
        if root(i):
            blocks[0, 0] = IC[0]  # S^T IC S with S = eye(6)
            continue
        S = model.S[i]
        fh = mv(IC[i], S)
        blocks[i, i] = (S * fh).sum(-1)[..., None, None]
        j = i
        while model.parent[j] != -1:
            fh = mtv(Xs[j], fh)
            j = model.parent[j]
            hij = (fh[..., None, :] if root(j)
                   else (model.S[j] * fh).sum(-1)[..., None, None])
            blocks[i, j] = hij
            blocks[j, i] = hij.transpose(-1, -2)
    width = [6 if root(i) else 1 for i in range(nb)]
    return torch.cat([
        torch.cat([blocks[i, j] if (i, j) in blocks
                   else torch.zeros(batch + (width[i], width[j]), **kw)
                   for j in range(nb)], dim=-1)
        for i in range(nb)], dim=-2)
