"""Forward kinematics: world transforms, end-effector pose and the position
Jacobian in the solver's chart (``rbdtpu.kinematics.fk``), for fixed-base
models and both floating roots.

On the fixed base and the rpy root the Jacobian is the position rows of
rbdtpu's analytic ``ee_pose_gradient``: one prefix and one suffix product
per chain, column k = prefix[k] @ dT_k @ suffix[k] applied to the EE
offset; on the rpy root, whose chart is the configuration coordinates, the
root's six columns are its transform's exact derivatives
(``_root_hom_derivs``) applied through suffix[0].  On the quaternion root
the chart is the body-twist tangent of ``solver.integrate.config_retract``
and the Jacobian is geometric (rbdtpu ``kinematics/fk.py:217-260``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..dynamics.xforms import joint_transforms_hom_list, q_per_joint
from ..model.robot import RobotModel
from ..spatial.transforms import PRISMATIC, drot_axis, joint_hom_dT, rot_axis


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


def _hom_R_block(M):
    """Embed a (..., 3, 3) block as [[M, 0], [0, 0]] (4x4)."""
    out = torch.zeros(M.shape[:-2] + (4, 4), dtype=M.dtype, device=M.device)
    out[..., :3, :3] = M
    return out


def _root_hom_derivs(model: RobotModel, q):
    """The first derivatives of the rpy floating root's homogeneous
    transform T0 = Ttree0 @ [[Rz(y) Ry(p) Rx(r), xyz], [0, 1]] with respect
    to its six coordinates [x, y, z, roll, pitch, yaw]: a list of six
    (..., 4, 4) (rbdtpu ``kinematics.fk._root_hom_derivs``, whose second
    derivatives wait for the EE Hessian).  Translation: Ttree0 @ [[0, e_t],
    [0, 0]]; rotation: Ttree0 @ [[dR, 0], [0, 0]]."""
    r, p, y = q[..., 3], q[..., 4], q[..., 5]
    kw = dict(dtype=q.dtype, device=q.device)
    ex, ey, ez = (torch.tensor(v, **kw)
                  for v in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)))
    Rx, Ry, Rz = rot_axis(ex, r), rot_axis(ey, p), rot_axis(ez, y)
    dRx, dRy, dRz = drot_axis(ex, r), drot_axis(ey, p), drot_axis(ez, y)
    Tt = model.Ttree[0].to(q.dtype)
    dT0 = []
    for t in range(3):
        D = torch.zeros(Rx.shape[:-2] + (4, 4), **kw)
        D[..., t, 3] = 1.0
        dT0.append(Tt @ D)
    for dR in (Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx):
        dT0.append(Tt @ _hom_R_block(dR))
    return dT0


def _check_fb_chain(model: RobotModel, chain) -> bool:
    """True when the chain starts at a floating rpy root, whose columns
    ``_root_hom_derivs`` gives."""
    return model.floating_base and chain[0] == 0


def _quat_jacobian_tangent(model: RobotModel, q, ee_names, offset):
    """The quaternion root's Jacobian in the body-twist tangent
    xi = [body rotation vector; body translation; joint deltas]: with a_i
    the world images of the root body's axes (columns of its world
    rotation) and o_root its origin, d p_ee / d xi_rot,i = a_i x (p_ee -
    o_root) and d p_ee / d xi_trans,i = a_i; joint columns are the
    geometric revolute (a_k x (p_ee - o_k)) and prismatic (a_k) ones."""
    Tw = fk_world_hom(model, q)
    jacs = []
    for jid, fid in resolve_ee(model, ee_names):
        T = Tw[..., jid, :, :]
        if fid is not None:
            T = T @ model.T_fixed[fid]
        p_ee = (T @ offset)[..., :3]
        J = torch.zeros(p_ee.shape[:-1] + (3, model.nv), dtype=q.dtype,
                        device=q.device)
        chain = model.chain(jid)
        R0, o0 = Tw[..., 0, :3, :3], Tw[..., 0, :3, 3]
        for i in range(3):
            a = R0[..., :, i]
            J[..., :, i] = torch.linalg.cross(a, p_ee - o0)
            J[..., :, 3 + i] = a
        for k in chain[1:]:
            a = Tw[..., k, :3, :3] @ model.axis[k].to(q.dtype)
            J[..., :, model.v_index(k)] = (
                a if model.joint_type[k] == PRISMATIC
                else torch.linalg.cross(a, p_ee - Tw[..., k, :3, 3]))
        jacs.append(J)
    return torch.stack(jacs, dim=-3)


def ee_position_jacobian_tangent(model: RobotModel, q, ee_names=None,
                                 offset=None):
    """d(EE position)/d(solver tangent): (..., nq) -> (..., n_ee, 3, nv).
    For fixed-base models and the rpy root the solver chart is the
    configuration coordinates; on the quaternion root it is the body-twist
    tangent (``_quat_jacobian_tangent``).  Columns of joints off the EE's
    chain are zero."""
    offset = _offset(model, offset)
    if model.floating_base and model.root_quat:
        return _quat_jacobian_tangent(model, q, ee_names, offset)
    T = joint_transforms_hom_list(model, q)
    qj = q_per_joint(model, q)
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
        fb_root = _check_fb_chain(model, chain)
        if fb_root:
            for c, dT0 in enumerate(_root_hom_derivs(model, q)):
                J[..., :, c] = (dT0 @ suffix[0] @ offset)[..., :3]
        for idx, k in enumerate(chain):
            if fb_root and idx == 0:
                continue
            dT = joint_hom_dT(model.joint_type[k], model.axis[k],
                              model.Ttree[k], qj[k])
            J[..., :, model.v_index(k)] = (
                prefix[idx] @ dT @ suffix[idx] @ offset)[..., :3]
        jacs.append(J)
    return torch.stack(jacs, dim=-3)
