"""Joint transform builders — the parts of ``rbdtpu.spatial.transforms`` that
``dynamics.xforms`` and the FK sweeps use.

Conventions (as in rbdtpu): the spatial motion transform ``X`` maps motion
vectors from PARENT to CHILD coordinates, ``X = XJ(q) @ Xtree``; the
homogeneous ``T`` maps points from CHILD to PARENT, ``T = Ttree @ TJ(q)``.
Joint types: 0 revolute, 1 prismatic, 2 floating root, 3 fixed.
"""
from __future__ import annotations

import torch

from .ops import skew

REVOLUTE = 0
PRISMATIC = 1
FLOATING = 2
FIXED = 3


def rot_axis(axis, q):
    """Active rotation about a unit axis (Rodrigues): (3,), (...) -> (..., 3, 3)."""
    k = skew(axis)
    s = torch.sin(q)[..., None, None]
    c = torch.cos(q)[..., None, None]
    kk = k @ k
    return torch.eye(3, dtype=q.dtype, device=q.device) + s * k + (1.0 - c) * kk


def drot_axis(axis, q):
    """d/dq of rot_axis."""
    k = skew(axis)
    s = torch.sin(q)[..., None, None]
    c = torch.cos(q)[..., None, None]
    return c * k + s * (k @ k)


def _blocks(tl, tr, bl, br):
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([bl, br], -1)], -2)


def joint_spatial_x(jtype: int, axis, Xtree, q):
    """X = XJ(q) @ Xtree for one 1-DoF joint of STATIC type.

    axis (3,), Xtree (6, 6), q (...) -> (..., 6, 6)."""
    if jtype == PRISMATIC:
        eye3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(
            q.shape + (3, 3))
        zero3 = torch.zeros_like(eye3)
        XJ = _blocks(eye3, zero3, -skew(axis * q[..., None]), eye3)
    elif jtype == REVOLUTE:
        E = rot_axis(axis, q).transpose(-1, -2)  # coordinate rotation R^T
        zero3 = torch.zeros_like(E)
        XJ = _blocks(E, zero3, zero3, E)
    else:
        raise NotImplementedError(f"joint type {jtype} has no 1-DoF transform")
    return XJ @ Xtree


def _hom(R, p):
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, p[..., None]], -1), bottom], -2)


def _hom_zero_row(R):
    z = torch.zeros(R.shape[:-2] + (3, 1), dtype=R.dtype, device=R.device)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    return torch.cat([torch.cat([R, z], -1), bottom], -2)


def joint_hom_T(jtype: int, axis, Ttree, q):
    """Homogeneous child->parent transform T = Ttree @ TJ(q): -> (..., 4, 4)."""
    if jtype == PRISMATIC:
        eye3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(
            q.shape + (3, 3))
        TJ = _hom(eye3, axis * q[..., None])
    elif jtype == REVOLUTE:
        R = rot_axis(axis, q)
        TJ = _hom(R, torch.zeros(R.shape[:-1], dtype=q.dtype, device=q.device))
    else:
        raise NotImplementedError(f"joint type {jtype} has no 1-DoF transform")
    return Ttree @ TJ


def joint_hom_dT(jtype: int, axis, Ttree, q):
    """d/dq of joint_hom_T."""
    if jtype == PRISMATIC:
        dTJ = torch.zeros(q.shape + (4, 4), dtype=q.dtype, device=q.device)
        dTJ[..., :3, 3] = axis
    elif jtype == REVOLUTE:
        dTJ = _hom_zero_row(drot_axis(axis, q))
    else:
        raise NotImplementedError(f"joint type {jtype} has no 1-DoF transform")
    return Ttree @ dTJ
