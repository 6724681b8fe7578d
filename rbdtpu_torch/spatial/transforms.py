"""Joint transform builders — the parts of ``rbdtpu.spatial.transforms`` that
``dynamics.xforms`` and the FK sweeps use.

Conventions (as in rbdtpu): the spatial motion transform ``X`` maps motion
vectors from PARENT to CHILD coordinates, ``X = XJ(q) @ Xtree``; the
homogeneous ``T`` maps points from CHILD to PARENT, ``T = Ttree @ TJ(q)``.
Joint types: 0 revolute, 1 prismatic, 2 floating root, 3 fixed.  The
floating root here is the rpy one: q6 = [x, y, z, roll, pitch, yaw].
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


def x_force_inv_T(X):
    """The force transform X^{-T} of a motion transform X, by block
    rearrangement: X = [[E, 0], [-E rx, E]] -> X^{-T} = [[E, -E rx], [0, E]]
    (``rbdtpu.dynamics.xforms.x_force_inv_T``).  (..., 6, 6) -> (..., 6, 6)."""
    E = X[..., :3, :3]
    return _blocks(E, X[..., 3:, :3], torch.zeros_like(E), E)


def rpy_to_R(rpy):
    """URDF rpy (roll-pitch-yaw, extrinsic XYZ) to the active rotation
    R = Rz Ry Rx: (..., 3) -> (..., 3, 3)."""
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def plux(E, r):
    """Spatial motion transform [[E, 0], [-E r^, E]] from a coordinate
    rotation E and an origin offset r: (..., 3, 3), (..., 3) -> (..., 6, 6)."""
    return _blocks(E, torch.zeros_like(E), -E @ skew(r), E)


def hom(R, p):
    """Homogeneous transform from an active rotation R and a translation p."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, p[..., None]], -1), bottom], -2)


def floating_spatial_x(Xtree, q6):
    """World->body motion transform of the rpy floating root,
    plux(R^T, xyz) @ Xtree with q6 = [x, y, z, roll, pitch, yaw]."""
    R = rpy_to_R(q6[..., 3:6])
    return plux(R.transpose(-1, -2), q6[..., 0:3]) @ Xtree


def floating_hom_T(Ttree, q6):
    """Body->world homogeneous transform of the rpy floating root."""
    return Ttree @ hom(rpy_to_R(q6[..., 3:6]), q6[..., 0:3])


def _hom_zero_row(R):
    z = torch.zeros(R.shape[:-2] + (3, 1), dtype=R.dtype, device=R.device)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    return torch.cat([torch.cat([R, z], -1), bottom], -2)


def joint_hom_T(jtype: int, axis, Ttree, q):
    """Homogeneous child->parent transform T = Ttree @ TJ(q): -> (..., 4, 4)."""
    if jtype == PRISMATIC:
        eye3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(
            q.shape + (3, 3))
        TJ = hom(eye3, axis * q[..., None])
    elif jtype == REVOLUTE:
        R = rot_axis(axis, q)
        TJ = hom(R, torch.zeros(R.shape[:-1], dtype=q.dtype, device=q.device))
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
