"""Forward kinematics: world transforms, end-effector pose, its first and
second derivatives, and the position Jacobian in the solver's chart
(``rbdtpu.kinematics.fk``), for fixed-base models and both floating roots.

On the fixed base and the rpy root the derivatives are rbdtpu's analytic
ones: one prefix and one suffix product per chain, column k = prefix[k] @
dT_k @ suffix[k] (``_chain_transforms``), the pose's angles through the
atan2 derivatives (``_dpose_cols``, ``_d2pose_cols``); on the rpy root,
whose chart is the configuration coordinates, the root's six columns are
its transform's exact derivatives (``_root_hom_derivs``) applied through
suffix[0].  The position Jacobian is the position rows of that gradient.
On the quaternion root the chart is the body-twist tangent of
``solver.integrate.config_retract``: the position Jacobian is geometric
(rbdtpu ``kinematics/fk.py:217-260``) and the pose derivatives raise, as
rbdtpu's do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..dynamics.xforms import joint_transforms_hom_list, q_per_joint
from ..model.robot import RobotModel
from ..spatial.transforms import (
    PRISMATIC, d2rot_axis, drot_axis, joint_hom_d2T, joint_hom_dT, rot_axis,
)


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


def _root_hom_derivs(model: RobotModel, q, second: bool = False):
    """The derivatives of the rpy floating root's homogeneous transform
    T0 = Ttree0 @ [[Rz(y) Ry(p) Rx(r), xyz], [0, 1]] with respect to its six
    coordinates [x, y, z, roll, pitch, yaw] (rbdtpu
    ``kinematics.fk._root_hom_derivs``): a list of six (..., 4, 4) first
    derivatives (translation: Ttree0 @ [[0, e_t], [0, 0]]; rotation:
    Ttree0 @ [[dR, 0], [0, 0]]) and, with ``second``, also the dict of
    second derivatives d2T0[(i, j)], i <= j, zero wherever a translation
    takes part (T0 is affine in xyz)."""
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
    if not second:
        return dT0
    d2Rx, d2Ry, d2Rz = (d2rot_axis(ex, r), d2rot_axis(ey, p),
                        d2rot_axis(ez, y))
    d2R = {(3, 3): Rz @ Ry @ d2Rx, (3, 4): Rz @ dRy @ dRx,
           (3, 5): dRz @ Ry @ dRx, (4, 4): Rz @ d2Ry @ Rx,
           (4, 5): dRz @ dRy @ Rx, (5, 5): d2Rz @ Ry @ Rx}
    zero4 = torch.zeros(Rx.shape[:-2] + (4, 4), **kw)
    d2T0 = {(i, j): Tt @ _hom_R_block(d2R[(i, j)]) if i >= 3 else zero4
            for i in range(6) for j in range(i, 6)}
    return dT0, d2T0


def _check_fb_chain(model: RobotModel, chain) -> bool:
    """True when the chain starts at a floating rpy root, whose columns
    ``_root_hom_derivs`` gives; raises ValueError on the quaternion root,
    whose pose derivatives depend on the chart (rbdtpu
    ``kinematics.fk._check_fb_chain``: differentiate in the solver's
    tangent instead)."""
    if not (model.floating_base and chain[0] == 0):
        return False
    if model.root_quat:
        raise ValueError(
            "ee_pose_gradient/hessian cover fixed-base and rpy-root models; "
            "the quaternion root's pose derivatives are chart-dependent — "
            "differentiate in the solver tangent space instead")
    return True


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
    jacs = []
    for jid, fid in resolve_ee(model, ee_names):
        chain, _, dT, _, prefix, suffix = _chain_transforms(model, q, jid,
                                                           fid)
        J = torch.zeros(prefix[0].shape[:-2] + (3, model.nv), dtype=q.dtype,
                        device=q.device)
        fb_root = _check_fb_chain(model, chain)
        if fb_root:
            for c, dT0 in enumerate(_root_hom_derivs(model, q)):
                J[..., :, c] = (dT0 @ suffix[0] @ offset)[..., :3]
        for idx, k in enumerate(chain):
            if fb_root and idx == 0:
                continue
            J[..., :, model.v_index(k)] = (
                prefix[idx] @ dT[k] @ suffix[idx] @ offset)[..., :3]
        jacs.append(J)
    return torch.stack(jacs, dim=-3)


def _chain_transforms(model: RobotModel, q, jid: int, fid,
                      second: bool = False):
    """The building blocks of the EE derivatives (rbdtpu
    ``kinematics.fk._chain_transforms``): (chain, T, dT, d2T, prefix,
    suffix) with ``chain`` the bodies root -> jid, T every body's joint
    transform, dT (and with ``second`` d2T, else None) the first (second)
    derivatives of the chain's 1-DoF joints' transforms by body, prefix[k]
    the world transform of chain[k]'s parent (the identity at the root)
    and suffix[k] the product of the chain's transforms after chain[k] and
    the fixed frame's mount."""
    chain = model.chain(jid)
    T = joint_transforms_hom_list(model, q)
    qj = q_per_joint(model, q)
    joints = [k for k in chain if qj[k] is not None]
    derivs = lambda fn: {k: fn(model.joint_type[k], model.axis[k],
                               model.Ttree[k], qj[k]) for k in joints}
    dT = derivs(joint_hom_dT)
    d2T = derivs(joint_hom_d2T) if second else None
    eye = torch.eye(4, dtype=q.dtype, device=q.device).expand(T[0].shape)
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
    return chain, T, dT, d2T, prefix, suffix


def _datan2(y, x, yp, xp):
    """d/dz atan2(y(z), x(z))."""
    return (-xp * y + x * yp) / (x * x + y * y)


def _dpose_cols(T, dT, offset):
    """The pose derivative [dxyz, droll, dpitch, dyaw] (..., 6) of the
    world transform T along its derivative dT (rbdtpu
    ``kinematics.fk._dpose_cols``)."""
    dxyz = (dT @ offset)[..., :3]
    droll = _datan2(T[..., 2, 1], T[..., 2, 2], dT[..., 2, 1], dT[..., 2, 2])
    psq = torch.sqrt(T[..., 2, 2] ** 2 + T[..., 2, 1] ** 2)
    dpsq = (T[..., 2, 2] * dT[..., 2, 2] + T[..., 2, 1] * dT[..., 2, 1]) / psq
    dpitch = _datan2(-T[..., 2, 0], psq, -dT[..., 2, 0], dpsq)
    dyaw = _datan2(T[..., 1, 0], T[..., 0, 0], dT[..., 1, 0], dT[..., 0, 0])
    return torch.cat([dxyz, torch.stack([droll, dpitch, dyaw], dim=-1)],
                     dim=-1)


def ee_pose_gradient(model: RobotModel, q, ee_names=None, offset=None):
    """d(pose)/dq: (..., nq) -> (..., n_ee, 6, nv) (rbdtpu
    ``kinematics.fk.ee_pose_gradient``).  Columns of joints off the EE's
    chain are zero; on the rpy root the six root columns come from the
    root transform's exact derivatives; the quaternion root raises
    ValueError (``_check_fb_chain``)."""
    offset = _offset(model, offset)
    grads = []
    for jid, fid in resolve_ee(model, ee_names):
        chain, T, dT, _, prefix, suffix = _chain_transforms(model, q, jid,
                                                           fid)
        fb_root = _check_fb_chain(model, chain)
        Tw = prefix[-1] @ T[chain[-1]] @ suffix[-1]
        cols = [torch.zeros(Tw.shape[:-2] + (6,), dtype=q.dtype,
                            device=q.device)] * model.nv
        if fb_root:
            for c, dT0 in enumerate(_root_hom_derivs(model, q)):
                cols[c] = _dpose_cols(Tw, dT0 @ suffix[0], offset)
        for idx, k in enumerate(chain):
            if fb_root and idx == 0:
                continue
            cols[model.v_index(k)] = _dpose_cols(
                Tw, prefix[idx] @ dT[k] @ suffix[idx], offset)
        grads.append(torch.stack(cols, dim=-1))
    return torch.stack(grads, dim=-3)


def _d2atan2(y, x, ypi, xpi, ypj, xpj, ypp, xpp, same: bool):
    """The second derivative of atan2(y, x) along i and j by the quotient
    rule (rbdtpu ``kinematics.fk._d2atan2``); ``same``: i == j."""
    top = -xpi * y + x * ypi
    dtop = -xpp * y + x * ypp
    if not same:
        dtop = dtop + (-xpi * ypj + xpj * ypi)
    bottom = x * x + y * y
    dbottom = 2 * x * xpj + 2 * y * ypj
    return (bottom * dtop - top * dbottom) / (bottom * bottom)


def _d2pose_cols(T, dTi, dTj, d2T, offset, same: bool):
    """The pose's second derivative (..., 6) along i and j (rbdtpu
    ``kinematics.fk._d2pose_cols``)."""
    d2xyz = (d2T @ offset)[..., :3]
    d2roll = _d2atan2(
        T[..., 2, 1], T[..., 2, 2], dTi[..., 2, 1], dTi[..., 2, 2],
        dTj[..., 2, 1], dTj[..., 2, 2], d2T[..., 2, 1], d2T[..., 2, 2], same)
    psq = torch.sqrt(T[..., 2, 2] ** 2 + T[..., 2, 1] ** 2)
    dpsq_i = (T[..., 2, 2] * dTi[..., 2, 2]
              + T[..., 2, 1] * dTi[..., 2, 1]) / psq
    dpsq_j_top = T[..., 2, 2] * dTj[..., 2, 2] + T[..., 2, 1] * dTj[..., 2, 1]
    dpsq_j = dpsq_j_top / psq
    dpsq_i_top_dj = (dTj[..., 2, 2] * dTi[..., 2, 2]
                     + T[..., 2, 2] * d2T[..., 2, 2]
                     + dTj[..., 2, 1] * dTi[..., 2, 1]
                     + T[..., 2, 1] * d2T[..., 2, 1])
    d2psq = (psq * dpsq_i_top_dj - dpsq_i * dpsq_j_top) / (psq * psq)
    d2pitch = _d2atan2(
        -T[..., 2, 0], psq, -dTi[..., 2, 0], dpsq_i,
        -dTj[..., 2, 0], dpsq_j, -d2T[..., 2, 0], d2psq, same)
    d2yaw = _d2atan2(
        T[..., 1, 0], T[..., 0, 0], dTi[..., 1, 0], dTi[..., 0, 0],
        dTj[..., 1, 0], dTj[..., 0, 0], d2T[..., 1, 0], d2T[..., 0, 0], same)
    return torch.cat([d2xyz, torch.stack([d2roll, d2pitch, d2yaw], dim=-1)],
                     dim=-1)


def ee_pose_hessian(model: RobotModel, q, ee_names=None, offset=None):
    """d2(pose)/dq2: (..., nq) -> (..., n_ee, 6, nv, nv) (rbdtpu
    ``kinematics.fk.ee_pose_hessian``).  Entries where either index is off
    the EE's chain are zero; on the rpy root the root-root and root-joint
    blocks come from the root transform's exact derivatives; the
    quaternion root raises ValueError."""
    offset = _offset(model, offset)
    n = model.nv
    hessians = []
    for jid, fid in resolve_ee(model, ee_names):
        chain, T, dT, d2T, prefix, suffix = _chain_transforms(
            model, q, jid, fid, second=True)
        fb_root = _check_fb_chain(model, chain)
        Tw = prefix[-1] @ T[chain[-1]] @ suffix[-1]
        Hs = torch.zeros(Tw.shape[:-2] + (6, n, n), dtype=q.dtype,
                         device=q.device)
        # derivative slots (column, chain position, local dT): one a 1-DoF
        # joint, six for the floating root (all at chain position 0)
        slots = []
        if fb_root:
            dT0, d2T0 = _root_hom_derivs(model, q, second=True)
            slots += [(c, 0, dT0[c]) for c in range(6)]
        slots += [(model.v_index(k), idx, dT[k])
                  for idx, k in enumerate(chain) if not (fb_root and idx == 0)]
        dTw = [prefix[pos] @ dloc @ suffix[pos] for _, pos, dloc in slots]

        def d2local(si, sj):
            """The local second derivative of two slots at one chain
            position: the root's pair, or a joint with itself."""
            ci, cj = slots[si][0], slots[sj][0]
            if fb_root and slots[si][1] == 0:
                return d2T0[(min(ci, cj), max(ci, cj))]
            return d2T[chain[slots[si][1]]]

        # the products between chain positions i < j, T[chain[i + 1]] ...
        # T[chain[j - 1]], grown along the inner loop
        eye = torch.eye(4, dtype=q.dtype, device=q.device).expand(Tw.shape)
        for si, (vi, pi, dli) in enumerate(slots):
            d2Tw = prefix[pi] @ d2local(si, si) @ suffix[pi]
            Hs[..., :, vi, vi] = _d2pose_cols(Tw, dTw[si], dTw[si], d2Tw,
                                              offset, same=True)
            pre_d = prefix[pi] @ dli
            M, last = eye, pi
            for sj in range(si + 1, len(slots)):
                vj, pj, dlj = slots[sj]
                if pj == pi:  # the root's pair
                    d2Tw = prefix[pi] @ d2local(si, sj) @ suffix[pi]
                else:
                    while last < pj - 1:
                        last += 1
                        M = M @ T[chain[last]]
                    d2Tw = pre_d @ M @ dlj @ suffix[pj]
                col = _d2pose_cols(Tw, dTw[si], dTw[sj], d2Tw, offset,
                                   same=False)
                Hs[..., :, vi, vj] = col
                Hs[..., :, vj, vi] = col
        hessians.append(Hs)
    return torch.stack(hessians, dim=-4)
