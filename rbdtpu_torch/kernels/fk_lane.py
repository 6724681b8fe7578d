"""The end-effector Gauss-Newton kernel (K4) beside its plain PyTorch
version, and its model-specialised form (K0): rbdtpu's lane walk of the
effector's chain (``ee_chain_lane``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from ..kinematics.fk import ee_pose, ee_position_jacobian_tangent, resolve_ee
from ..model.robot import RobotModel
from ..spatial.transforms import PRISMATIC
from . import _lib
from . import lanescalar as ls
from .fused import ModelStatic, _lanes, _stack, get_static


def _single_ee(model: RobotModel, ee_names):
    ees = resolve_ee(model, ee_names)
    if len(ees) != 1:
        raise ValueError("ee_gn handles one end effector; name it in "
                         "ee_names for a multi-leaf model")
    return ees[0]


def ee_chain(model: RobotModel, jid: int):
    """(chain, prismatic): the bodies from the root to joint ``jid`` and
    those of them whose joint is prismatic, one bit a body each: what the
    end-effector kernels walk (a floating root is body 0's bit; the kernel
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
                gn: bool = True, specialize: bool = False):
    """``ee_gn_plain`` in one launch: kernel ``ee_gn`` (gn=True) or
    ``ee_err`` (gn=False) in csrc/ee_gn.cu.  ``specialize=True`` takes the
    model-specialised kernels ``ee_gn_static`` / ``ee_err_static``
    (``_static_ee``).

    Replaces rbdtpu's ``kernels.fk_lane.ee_gn_fused`` (Pallas,
    fk_lane.py:203): the EE chain is walked root to tip with homogeneous
    transforms in registers (the geometric position Jacobian a_k x (p - o_k)
    for revolute joints and a_k for prismatic ones), by a team of 8 lanes a
    state for ``ee_gn`` (on the fixed base one lane a column of J, which
    forms g0's entry and H0's row; on the rpy root, instantiated for the
    "fb16" and "fb32" classes, lane c columns c + 8 s, the root's six
    among them) and by one thread a state for ``ee_err``, which scores the
    line search's states, writes e alone and never forms J.  On the rpy root,
    whose chart is the configuration coordinates, the root's columns are
    its translations' (Ttree0's rotation) and its Euler angles' (rbdtpu
    ``ee_chain_lane``); on the quaternion root ("fq32", up to 32 bodies, 8
    lanes a state, lane c columns c + 8 s) they are the body-twist
    tangent's: a_i x (p - o_root) and a_i, a_i the columns of Ttree0's
    rotation times R(quat) (rbdtpu fk_lane.py:137-149).  A block stages its states' rows through shared
    memory, so every global access is contiguous (``_lib.ee_geometry``).
    The cost weights stay outside.  Bound on the H100: the bytes at the
    large batches (H0 is n*n values a state: 0.00101 ms for 12,800 arm7
    states in float32, ee_err 0.00122 ms for 102,400), one state's chain at
    the small ones.
    """
    if specialize:
        return _static_ee(model, q, target, ee_names, gn)
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


# ----------------------------------------------------------------------- #
# K0: rbdtpu's lane walk of the effector's chain (fk_lane.py:42-200) and   #
# its kernel body (:249-290), one state a thread                           #
# ----------------------------------------------------------------------- #

def _mat3_static(M):
    return [[float(M[i][j]) for j in range(3)] for i in range(3)]


def _m3v(R, v):
    """3x3 @ 3-vec on mixed static/lane entries."""
    return [
        ls._add(ls._add(ls._mul(R[i][0], v[0]), ls._mul(R[i][1], v[1])),
                ls._mul(R[i][2], v[2]))
        for i in range(3)
    ]


def _m3m(A, B):
    return [
        [
            ls._add(ls._add(ls._mul(A[i][0], B[0][j]),
                            ls._mul(A[i][1], B[1][j])),
                    ls._mul(A[i][2], B[2][j]))
            for j in range(3)
        ]
        for i in range(3)
    ]


def _v3add(a, b):
    return [ls._add(a[i], b[i]) for i in range(3)]


def _v3sub(a, b):
    return [ls._add(a[i], ls._mul(-1.0, b[i])) for i in range(3)]


def _v3cross(a, b):
    return [
        ls._add(ls._mul(a[1], b[2]), ls._mul(-1.0, ls._mul(a[2], b[1]))),
        ls._add(ls._mul(a[2], b[0]), ls._mul(-1.0, ls._mul(a[0], b[2]))),
        ls._add(ls._mul(a[0], b[1]), ls._mul(-1.0, ls._mul(a[1], b[0]))),
    ]


def _rodrigues(axis, s, c):
    """Active rotation about a static unit axis with lane-scalar sin/cos
    (spatial.transforms.rot_axis, unrolled)."""
    ax, ay, az = (float(a) for a in axis)
    one_c = ls._add(1.0, ls._mul(-1.0, c))
    R = [[0.0] * 3 for _ in range(3)]
    kk = [
        [ax * ax - 1.0, ax * ay, ax * az],
        [ax * ay, ay * ay - 1.0, ay * az],
        [ax * az, ay * az, az * az - 1.0],
    ]
    k = [[0.0, -az, ay], [az, 0.0, -ax], [-ay, ax, 0.0]]
    for i in range(3):
        for j in range(3):
            val = ls._mul(s, k[i][j]) if k[i][j] != 0.0 else 0.0
            val = ls._add(val, ls._mul(one_c, kk[i][j]))
            if i == j:
                val = ls._add(val, 1.0)
            R[i][j] = val
    return R


def ee_chain_lane(ms: ModelStatic, q_s, jid: int, fid, offset):
    """The effector's world position and its chain's position-Jacobian
    columns on lane scalars (rbdtpu fk_lane.py:105-200): q_s the nq lane
    scalars; returns (p_ee 3-list, [(velocity index, 3-list dp/dq)]).  A
    revolute joint's column is a x (p_ee - o), a prismatic one's its axis
    a; on the rpy root the translation columns are Ttree0's rotation and
    the Euler columns the chained axes ez, Rz ey, Rz Ry ex crossed with
    (p_ee - o_root); on the quaternion root the body-twist tangent's,
    a_i x (p_ee - o_root) and a_i with a_i the columns of Ttree0's rotation
    times R(quat).  The fixed frame ``fid`` and the ``offset`` are folded
    in."""
    if ms.Ttree is None:
        raise ValueError("model host_data lacks Ttree; build it with "
                         "rbdtpu_torch.model.make_model")
    chain = []
    k = jid
    while k != -1:
        chain.append(k)
        k = ms.parent[k]
    chain.reverse()

    R = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    p = [0.0, 0.0, 0.0]
    entries = []  # (vel_index, is_translation, a_world, o_world)
    for k in chain:
        if ms.fb and k == 0:
            Tt = ms.Ttree[0]
            Rt = _mat3_static([row[:3] for row in Tt])
            pt = [Tt[i][3] for i in range(3)]
            xyz = [q_s[0], q_s[1], q_s[2]]
            o_root = _v3add(_m3v(Rt, xyz), pt)
            p = o_root
            if ms.quat:
                Rq = ls.quat_R(q_s[3], q_s[4], q_s[5], q_s[6])
                R = _m3m(Rt, Rq)
                for i in range(3):
                    a_i = [R[r][i] for r in range(3)]
                    entries.append((i, False, a_i, o_root))
                    entries.append((3 + i, True, a_i, None))
                continue
            sr, cr = ls.sin(q_s[3]), ls.cos(q_s[3])
            sp_, cp_ = ls.sin(q_s[4]), ls.cos(q_s[4])
            sy, cy = ls.sin(q_s[5]), ls.cos(q_s[5])
            Rx = _rodrigues((1.0, 0.0, 0.0), sr, cr)
            Ry = _rodrigues((0.0, 1.0, 0.0), sp_, cp_)
            Rz = _rodrigues((0.0, 0.0, 1.0), sy, cy)
            RtRz = _m3m(Rt, Rz)
            RtRzRy = _m3m(RtRz, Ry)
            R = _m3m(RtRzRy, Rx)
            for t in range(3):
                entries.append((t, True, [Rt[i][t] for i in range(3)], None))
            entries.append((3, False, [RtRzRy[i][0] for i in range(3)],
                            o_root))
            entries.append((4, False, [RtRz[i][1] for i in range(3)],
                            o_root))
            entries.append((5, False, [Rt[i][2] for i in range(3)], o_root))
            continue
        Tt = ms.Ttree[k]
        Rt = [[Tt[i][j] for j in range(3)] for i in range(3)]
        pt = [Tt[i][3] for i in range(3)]
        p = _v3add(p, _m3v(R, pt))
        R1 = _m3m(R, Rt)
        qk = q_s[ms.qi(k)]
        a_world = _m3v(R1, [float(v) for v in ms.axis[k]])
        if ms.jtype[k] == PRISMATIC:
            p = _v3add(p, [ls._mul(qk, a) for a in a_world])
            R = R1
            entries.append((ms.vi(k), True, a_world, None))
        else:
            s, c = ls.sin(qk), ls.cos(qk)
            R = _m3m(R1, _rodrigues(ms.axis[k], s, c))
            entries.append((ms.vi(k), False, a_world, p))
    if fid is not None:
        Tf = ms.T_fixed[fid]
        Rf = [[Tf[i][j] for j in range(3)] for i in range(3)]
        pf = [Tf[i][3] for i in range(3)]
        p = _v3add(p, _m3v(R, pf))
        R = _m3m(R, Rf)
    off = [float(o) for o in offset[:3]]
    p_ee = _v3add(p, _m3v(R, off))
    cols = []
    for vi, is_trans, a_world, o_world in entries:
        if is_trans:
            col = list(a_world)
        else:
            col = _v3cross(a_world, _v3sub(p_ee, o_world))
        cols.append((vi, col))
    return p_ee, cols


def ee_lane(ms: ModelStatic, q_s, jid: int, fid, target, gn: bool):
    """K4's body on lane scalars (rbdtpu fk_lane.py:254-290), one state at
    the effector with no offset (``ee_gn_fused``'s): e = p_ee - target
    (target three lane scalars or floats), and with gn g0 = J^T e (nv) and
    H0 = J^T J (nv x nv, its lower triangle the mirror of the upper) from
    ``ee_chain_lane``'s columns.  Returns (e, g0, H0), g0 and H0 None
    without gn."""
    p_ee, cols = ee_chain_lane(ms, q_s, jid, fid, (0.0, 0.0, 0.0))
    e = [p_ee[r] - target[r] for r in range(3)]
    if not gn:
        return e, None, None
    n = ms.nv
    J = [[0.0] * n for _ in range(3)]
    for ci, col in cols:
        for r in range(3):
            J[r][ci] = ls._add(J[r][ci], col[r])
    g0 = []
    for i in range(n):
        acc = 0.0
        for r in range(3):
            acc = ls._add(acc, ls._mul(J[r][i], e[r]))
        g0.append(acc)
    H0 = [[0.0] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            acc = 0.0
            for r in range(3):
                acc = ls._add(acc, ls._mul(J[r][i], J[r][j]))
            H0[i][j] = H0[j][i] = acc
    return e, g0, H0


def ee_gn_static_plain(model: RobotModel, q, target, *, ee_names=None,
                       gn: bool = True):
    """``ee_lane`` on (B,) lanes: the plain version of ``ee_gn_static``
    (gn=True) and ``ee_err_static`` (gn=False), shapes as
    ``ee_gn_plain``."""
    jid, fid = _single_ee(model, ee_names)
    ms = get_static(model)
    e, g0, H0 = ee_lane(ms, _lanes(q), jid, fid,
                        [float(t) for t in target], gn)
    if not gn:
        return _stack(e, q), None, None
    return (_stack(e, q), _stack(g0, q),
            torch.stack([_stack(row, q) for row in H0], 1))


def _static_ee(model: RobotModel, q, target, ee_names, gn: bool):
    """Kernels ``ee_gn_static`` (gn=True) and ``ee_err_static`` (gn=False),
    K4 specialised to the model and its effector (kernels/codegen.py): one
    thread a state runs ``ee_lane``'s straight-line code with the
    effector's chain, its fixed frame and its offset folded in, the target
    (three scalars) read at run time.  Replace rbdtpu's ``ee_gn_fused``
    body (fk_lane.py:249-290).  A CPU tensor runs
    ``ee_gn_static_plain``."""
    if not q.is_cuda:
        return ee_gn_static_plain(model, q, target, ee_names=ee_names, gn=gn)
    jid, fid = _single_ee(model, ee_names)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    tx, ty, tz = (float(t) for t in target)
    e = torch.empty(B, 3, dtype=q.dtype, device=q.device)
    ee = (jid, fid)
    if not gn:
        _lib.launch_static("ee_err_static", model, q, None, q, tx, ty, tz, e,
                           B, _lib.STATIC_THREADS, ee=ee)
        return e, None, None
    g0 = torch.empty(B, n, dtype=q.dtype, device=q.device)
    H0 = torch.empty(B, n, n, dtype=q.dtype, device=q.device)
    _lib.launch_static("ee_gn_static", model, q, None, q, tx, ty, tz, e, g0,
                       H0, B, _lib.STATIC_THREADS, ee=ee)
    return e, g0, H0
