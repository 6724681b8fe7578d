"""Oracle adapter: the port's RobotModel behind the URDFParser ``robot``
interface (the port's copy of ``rbdtpu.oracle.adapter``).

The numpy reference ``RBDReference`` is parameterised by a ``robot`` object
from A2R-Lab's URDFParser package.  This adapter serves that interface
from a RobotModel's float64 data (``host_data``, whatever the model's
device and dtype), so the reference class can run on the same model data
as the port.  No reference code is copied; only its consumer interface is
served.
"""
from __future__ import annotations

import numpy as np

from ..model.robot import RobotModel
from ..spatial.transforms import PRISMATIC, FLOATING


def _skew(r):
    return np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])


def _rot_axis(axis, q):
    k = _skew(axis)
    return np.eye(3) + np.sin(q) * k + (1 - np.cos(q)) * (k @ k)


def _rpy_R(r, p, y):
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _plux(E, r):
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ _skew(r)
    return X


class _FixedJoint:
    def __init__(self, adapter, fid):
        self._a = adapter
        self._fid = fid

    def get_id(self):
        return self._fid

    @property
    def parent_name(self):
        return self._a.model.joint_names[self._a.model.fixed_frame_parent[self._fid]]

    def get_transformation_matrix_hom(self):
        return np.matrix(self._a._T_fixed[self._fid])


class _Joint:
    def __init__(self, jid):
        self._jid = jid

    def get_id(self):
        return self._jid


class OracleRobotAdapter:
    """Duck-typed URDFParser ``robot``."""

    def __init__(self, model: RobotModel):
        self.model = model
        self.floating_base = model.floating_base
        data = model.host_data
        self._T = data["Ttree"]
        self._X = data["Xtree"]
        self._axis = data["axis"]
        self._S = data["S"]
        self._I = data["I"]
        self._damping = data["damping"]
        self._T_fixed = data["T_fixed"]

    # --- sizes ---
    def get_num_bodies(self):
        return self.model.nb

    def get_num_joints(self):
        return self.model.nb  # 1 joint per body (fb root counted once)

    def get_num_vel(self):
        return self.model.nv

    # --- topology ---
    def get_parent_id(self, i):
        return self.model.parent[i]

    def get_subtree_by_id(self, i):
        return list(self.model.subtree(i))

    def get_ancestors_by_id(self, i):
        return list(self.model.ancestors(i))

    def get_leaf_nodes(self):
        return list(self.model.leaves())

    # --- index maps ---
    def get_joint_index_q(self, i):
        idx = self.model.q_index(i)
        return np.arange(6) if isinstance(idx, slice) else idx

    def get_joint_index_v(self, i):
        return self.get_joint_index_q(i)

    def get_joint_index_f(self, i):
        return self.get_joint_index_q(i)

    # --- numeric model data ---
    def get_S_by_id(self, i):
        if self.floating_base and i == 0:
            return np.eye(6)
        return self._S[i]

    def get_Imat_by_id(self, i):
        return self._I[i]

    def get_Imats_dict_by_id(self):
        return {i: self._I[i].copy() for i in range(self.model.nb)}

    def get_damping_by_id(self, i):
        return float(self._damping[i])

    # --- transforms (closures, matching the reference's evaluation style) ---
    def get_Xmat_Func_by_id(self, i):
        jt = self.model.joint_type[i]
        Xtree = self._X[i]
        axis = self._axis[i]
        if jt == FLOATING:
            def fb(q6):
                q6 = np.asarray(q6, dtype=np.float64).ravel()
                E = _rpy_R(q6[3], q6[4], q6[5]).T
                return _plux(E, q6[0:3]) @ Xtree
            return fb
        if jt == PRISMATIC:
            return lambda q: _plux(np.eye(3), axis * float(q)) @ Xtree
        return lambda q: _plux(_rot_axis(axis, float(q)).T, np.zeros(3)) @ Xtree

    def get_Xmat_hom_Func_by_id(self, i):
        jt = self.model.joint_type[i]
        Ttree = self._T[i]
        axis = self._axis[i]

        def hom_rev(q):
            T = np.eye(4)
            T[:3, :3] = _rot_axis(axis, float(q))
            return np.matrix(Ttree @ T)

        def hom_pris(q):
            T = np.eye(4)
            T[:3, 3] = axis * float(q)
            return np.matrix(Ttree @ T)

        def hom_fb(q6):
            q6 = np.asarray(q6, dtype=np.float64).ravel()
            T = np.eye(4)
            T[:3, :3] = _rpy_R(q6[3], q6[4], q6[5])
            T[:3, 3] = q6[0:3]
            return np.matrix(Ttree @ T)

        if jt == FLOATING:
            return hom_fb
        return hom_pris if jt == PRISMATIC else hom_rev

    def get_dXmat_hom_Func_by_id(self, i):
        jt = self.model.joint_type[i]
        Ttree = self._T[i]
        axis = self._axis[i]
        k = _skew(axis)

        def d_rev(q):
            dR = np.cos(float(q)) * k + np.sin(float(q)) * (k @ k)
            dT = np.zeros((4, 4))
            dT[:3, :3] = dR
            return np.matrix(Ttree @ dT)

        def d_pris(q):
            dT = np.zeros((4, 4))
            dT[:3, 3] = axis
            return np.matrix(Ttree @ dT)

        return d_pris if jt == PRISMATIC else d_rev

    def get_d2Xmat_hom_Func_by_id(self, i):
        jt = self.model.joint_type[i]
        Ttree = self._T[i]
        axis = self._axis[i]
        k = _skew(axis)

        def d2_rev(q):
            d2R = -np.sin(float(q)) * k + np.cos(float(q)) * (k @ k)
            dT = np.zeros((4, 4))
            dT[:3, :3] = d2R
            return np.matrix(Ttree @ dT)

        def d2_pris(q):
            return np.matrix(np.zeros((4, 4)))

        return d2_pris if jt == PRISMATIC else d2_rev

    # --- named joints / fixed frames ---
    def get_joint_by_name(self, name):
        if name in self.model.joint_names:
            return _Joint(self.model.joint_names.index(name))
        return None

    def get_fixed_joint_by_name(self, name):
        if name in self.model.fixed_frame_names:
            return _FixedJoint(self, self.model.fixed_frame_names.index(name))
        return None

    def get_fixed_joint_by_id(self, fid):
        return _FixedJoint(self, fid)
