"""Forward kinematics: world transforms, end-effector pose and the position
Jacobian in the solver's chart (``rbdtpu.kinematics.fk``).  The world
transforms and poses cover the rpy floating root; the position Jacobian
covers fixed-base models only (a floating root raises
``NotImplementedError``).

The Jacobian is the analytic chain derivative of rbdtpu's
``ee_pose_gradient``: one prefix and one suffix product per chain, column
k = prefix[k] @ dT_k @ suffix[k] applied to the EE offset.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..dynamics.xforms import joint_transforms_hom_list
from ..model.robot import RobotModel
from ..spatial.transforms import joint_hom_dT


def fk_world_hom(model: RobotModel, q):
    """World homogeneous transform of every body: (..., nq) -> (..., NB, 4, 4)."""
    T = joint_transforms_hom_list(model, q)
    Tw = [None] * model.nb
    for i in range(model.nb):
        p = model.parent[i]
        Tw[i] = T[i] if p == -1 else Tw[p] @ T[i]
    return torch.stack(Tw, dim=-3)


def resolve_ee(model: RobotModel, ee_names: Optional[Sequence[str]]):
    """[(joint id, fixed-frame id or None)] for the named end effectors;
    all leaf joints when ``ee_names`` is None."""
    if ee_names is None:
        return [(jid, None) for jid in model.leaves()]
    out = []
    for name in ee_names:
        if name in model.joint_names:
            out.append((model.joint_names.index(name), None))
        elif name in model.fixed_frame_names:
            fid = model.fixed_frame_names.index(name)
            out.append((model.fixed_frame_parent[fid], fid))
        else:
            raise ValueError(f"no joint or fixed frame named {name!r}")
    return out


def _offset(model, offset):
    if offset is None:
        offset = torch.tensor([0.0, 0.0, 0.0, 1.0])
    return torch.as_tensor(offset, dtype=model.dtype, device=model.device)


def _pose_from_T(T, offset):
    """[xyz, roll, pitch, yaw] from a world transform."""
    xyz = (T @ offset)[..., :3]
    roll = torch.atan2(T[..., 2, 1], T[..., 2, 2])
    pitch = torch.atan2(-T[..., 2, 0],
                        torch.sqrt(T[..., 2, 2] ** 2 + T[..., 2, 1] ** 2))
    yaw = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.cat([xyz, torch.stack([roll, pitch, yaw], dim=-1)], dim=-1)


def ee_pose(model: RobotModel, q, ee_names=None, offset=None):
    """End-effector pose(s): (..., nq) -> (..., n_ee, 6)."""
    offset = _offset(model, offset)
    Tw = fk_world_hom(model, q)
    poses = []
    for jid, fid in resolve_ee(model, ee_names):
        T = Tw[..., jid, :, :]
        if fid is not None:
            T = T @ model.T_fixed[fid]
        poses.append(_pose_from_T(T, offset))
    return torch.stack(poses, dim=-2)


def ee_position_jacobian_tangent(model: RobotModel, q, ee_names=None,
                                 offset=None):
    """d(EE position)/dq: (..., nq) -> (..., n_ee, 3, nv).  For fixed-base
    models the solver chart is the configuration coordinates; columns of
    joints off the EE's chain are zero."""
    if model.floating_base:
        raise NotImplementedError(
            "ee_position_jacobian_tangent: the floating root's columns are "
            "not ported yet")
    offset = _offset(model, offset)
    T = joint_transforms_hom_list(model, q)
    eye = torch.eye(4, dtype=q.dtype, device=q.device).expand(
        T[0].shape)
    jacs = []
    for jid, fid in resolve_ee(model, ee_names):
        chain = model.chain(jid)
        prefix, acc = [], eye
        for k in chain:
            prefix.append(acc)
            acc = acc @ T[k]
        tail = (model.T_fixed[fid] if fid is not None
                else torch.eye(4, dtype=q.dtype, device=q.device))
        suffix = [None] * len(chain)
        acc = tail.expand(eye.shape)
        for idx in range(len(chain) - 1, -1, -1):
            suffix[idx] = acc
            acc = T[chain[idx]] @ acc
        J = torch.zeros(eye.shape[:-2] + (3, model.nv), dtype=q.dtype,
                        device=q.device)
        for idx, k in enumerate(chain):
            dT = joint_hom_dT(model.joint_type[k], model.axis[k],
                              model.Ttree[k], q[..., k])
            J[..., :, k] = (prefix[idx] @ dT @ suffix[idx] @ offset)[..., :3]
        jacs.append(J)
    return torch.stack(jacs, dim=-3)
