"""The end-effector Gauss-Newton kernel (K4) beside its plain PyTorch
version.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from ..kinematics.fk import ee_pose, ee_position_jacobian_tangent, resolve_ee
from ..model.robot import RobotModel
from . import _lib


def _single_ee(model: RobotModel, ee_names):
    ees = resolve_ee(model, ee_names)
    if len(ees) != 1:
        raise ValueError("ee_gn handles one end effector; name it in "
                         "ee_names for a multi-leaf model")
    return ees[0]


def ee_gn_plain(model: RobotModel, q, target, *, ee_names=None,
                gn: bool = True):
    """q (B, nq) -> (e (B, 3), g0 (B, n), H0 (B, n, n)) with
    e = p_ee(q) - target, g0 = J^T e, H0 = J^T J (position Jacobian); with
    gn=False, (e, None, None)."""
    _single_ee(model, ee_names)
    tgt = torch.as_tensor(target, dtype=q.dtype, device=q.device)
    e = ee_pose(model, q, ee_names=ee_names)[..., 0, :3] - tgt
    if not gn:
        return e, None, None
    J = ee_position_jacobian_tangent(model, q, ee_names=ee_names)[..., 0, :, :]
    Jt = J.transpose(-1, -2)
    return e, (Jt @ e[..., None])[..., 0], Jt @ J


def ee_gn_fused(model: RobotModel, q, target, *, ee_names=None,
                gn: bool = True):
    """``ee_gn_plain`` in one launch: kernel ``ee_gn`` (gn=True) or
    ``ee_err`` (gn=False) in csrc/ee_gn.cu.

    Replaces rbdtpu's ``kernels.fk_lane.ee_gn_fused`` (Pallas,
    fk_lane.py:203): one thread per state walks the EE chain root to tip
    (homogeneous transforms, the geometric position Jacobian a_k x (p - o_k)
    for revolute joints and a_k for prismatic ones) and writes e, J^T e and
    the full J^T J.  The cost weights stay outside.  Bound on the H100: the
    output bytes — H0 is n*n values per state, 25x the input; ``ee_err``,
    which scores the line search's 102,400 states, writes e alone and never
    forms J.
    """
    if not q.is_cuda:
        return ee_gn_plain(model, q, target, ee_names=ee_names, gn=gn)
    jid, fid = _single_ee(model, ee_names)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    tx, ty, tz = (float(t) for t in target)
    ee = _lib.ee_table(model, fid, q.device, q.dtype)
    e = torch.empty(B, 3, dtype=q.dtype, device=q.device)
    if not gn:
        _lib.launch("ee_err", model, q, ee, jid, q, tx, ty, tz, e, B)
        return e, None, None
    g0 = torch.empty(B, n, dtype=q.dtype, device=q.device)
    H0 = torch.empty(B, n, n, dtype=q.dtype, device=q.device)
    _lib.launch("ee_gn", model, q, ee, jid, q, tx, ty, tz, e, g0, H0, B)
    return e, g0, H0
