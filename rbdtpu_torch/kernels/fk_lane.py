"""The end-effector Gauss-Newton kernel (K4) beside its plain PyTorch
version.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from ..kinematics.fk import ee_pose, ee_position_jacobian_tangent, resolve_ee
from ..model.robot import RobotModel
from ..spatial.transforms import PRISMATIC
from . import _lib


def _single_ee(model: RobotModel, ee_names):
    ees = resolve_ee(model, ee_names)
    if len(ees) != 1:
        raise ValueError("ee_gn handles one end effector; name it in "
                         "ee_names for a multi-leaf model")
    return ees[0]


def ee_chain(model: RobotModel, jid: int):
    """(chain, prismatic): the bodies from the root to joint ``jid`` and
    those of them whose joint is prismatic, one bit a body each: what the
    end-effector kernels walk (an rpy root is body 0's bit; the kernel
    expands it into the root's six columns).  Worked out once per (model,
    jid)."""
    key = ("ee_chain", jid)
    if key not in model._tables:
        chain = prism = 0
        j = jid
        while j >= 0:
            chain |= 1 << j
            prism |= int(model.joint_type[j] == PRISMATIC) << j
            j = model.parent[j]
        model._tables[key] = (chain, prism)
    return model._tables[key]


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
    fk_lane.py:203): the EE chain is walked root to tip with homogeneous
    transforms in registers (the geometric position Jacobian a_k x (p - o_k)
    for revolute joints and a_k for prismatic ones), by a team of 8 lanes a
    state for ``ee_gn`` (on the fixed base one lane a column of J, which
    forms g0's entry and H0's row; on the rpy root, instantiated for the
    "fb16" class, lane c columns c, c + 8 and c + 16, the root's six among
    them) and by one thread a state for ``ee_err``, which scores the line
    search's states, writes e alone and never forms J.  On the rpy root,
    whose chart is the configuration coordinates, the root's columns are
    its translations' (Ttree0's rotation) and its Euler angles' (rbdtpu
    ``ee_chain_lane``).  A block stages its states' rows through shared
    memory, so every global access is contiguous (``_lib.ee_geometry``).
    The cost weights stay outside.  Bound on the H100: the bytes at the
    large batches (H0 is n*n values a state: 0.00101 ms for 12,800 arm7
    states in float32, ee_err 0.00122 ms for 102,400), one state's chain at
    the small ones.
    """
    if not q.is_cuda:
        return ee_gn_plain(model, q, target, ee_names=ee_names, gn=gn)
    jid, fid = _single_ee(model, ee_names)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    tx, ty, tz = (float(t) for t in target)
    ee = _lib.ee_table(model, fid, q.device, q.dtype)
    e = torch.empty(B, 3, dtype=q.dtype, device=q.device)
    chain = ee_chain(model, jid)
    kernel = "ee_gn" if gn else "ee_err"
    args = _lib.ee_args(kernel, q.dtype, B, q.device,
                        _lib.model_class(kernel, model))
    if not gn:
        _lib.launch("ee_err", model, q, ee, *chain, q, tx, ty, tz, e, B,
                    *args)
        return e, None, None
    g0 = torch.empty(B, n, dtype=q.dtype, device=q.device)
    H0 = torch.empty(B, n, n, dtype=q.dtype, device=q.device)
    _lib.launch("ee_gn", model, q, ee, *chain, q, tx, ty, tz, e, g0, H0, B,
                *args)
    return e, g0, H0
