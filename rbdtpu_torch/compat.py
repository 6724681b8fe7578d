"""The reference-compatible per-pass API (``rbdtpu.compat``).

``RBDReferenceTorch`` mirrors ``rbdtpu.compat.RBDReferenceTPU``, itself a
mirror of the serial numpy reference ``RBDReference``: the same method
names, keywords (``GRAVITY``, ``USE_VELOCITY_DAMPING``, ``output_dense``,
``f_ext``, ``ee_joint_names``, ``ee_offsets``), defaults and return
layouts, per-body arrays in the reference's (6, NB) and (6, n, NB)
orientation.  A consumer of the reference switches by replacing the
constructor.

Inputs are one state (numpy or anything ``np.asarray`` takes); outputs are
numpy float64.  The computation runs on the model's device (``device``
moves it there) in the model's dtype.  For the batched API use
``rbdtpu_torch.dynamics`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dynamics as dyn
from .dynamics.xforms import joint_transforms_list
from .kinematics import fk
from .model.robot import RobotModel


class RBDReferenceTorch:
    def __init__(self, robot, device=None):
        """robot: a RobotModel, or any object with a ``.model`` RobotModel
        attribute (e.g. ``oracle.OracleRobotAdapter``); ``device``: where
        to compute (default: the model's device)."""
        self.robot = robot
        model = robot if isinstance(robot, RobotModel) else robot.model
        self.model: RobotModel = (model if device is None
                                  else model.to(device))

    # --- helpers -------------------------------------------------------- #
    def _t(self, x, shape=None):
        a = np.asarray(x, dtype=np.float64)
        a = a.ravel() if shape is None else a.reshape(shape)
        return torch.tensor(a, dtype=self.model.dtype,
                            device=self.model.device)

    @staticmethod
    def _np(x):
        return x.detach().to("cpu", torch.float64).numpy()

    def _opt(self, x, shape=None):
        return None if x is None else self._t(x, shape)

    def _Xs(self, q):
        return joint_transforms_list(self.model, self._t(q))

    def _body_lists(self, x, tail):
        """A reference (6, ..., NB) array as a per-body list of (6, ...)."""
        a = np.asarray(x, dtype=np.float64)
        return [self._t(a[..., i], (6,) + tail) for i in range(self.model.nb)]

    def _ref(self, lst):
        """Per-body list of (6,) or (6, n) -> the reference's (6, [n,] NB)."""
        return np.stack([self._np(x) for x in lst], axis=-1)

    # --- inverse dynamics ----------------------------------------------- #
    def rnea(self, q, qd, qdd=None, GRAVITY=-9.81, f_ext=None):
        """Returns (c, v, a, f) with v/a/f in the reference's (6, NB)
        layout.  Unlike the reference (which ignores f_ext), f_ext IS
        applied, as in rbdtpu."""
        c, v, a, f = dyn.rnea(
            self.model, self._t(q), self._t(qd), self._opt(qdd), GRAVITY,
            self._opt(f_ext, (self.model.nb, 6)))
        return self._np(c), self._np(v).T, self._np(a).T, self._np(f).T

    def rnea_fpass(self, q, qd, qdd=None, GRAVITY=-9.81):
        v, a, f = dyn.rnea_fpass(self.model, self._Xs(q), self._t(qd),
                                 self._opt(qdd), GRAVITY)
        return self._ref(v), self._ref(a), self._ref(f)

    def rnea_bpass(self, q, f):
        c, f_l = dyn.rnea_bpass(self.model, self._Xs(q),
                                self._body_lists(f, ()))
        return self._np(c), self._ref(f_l)

    def apply_external_forces(self, q, f_in, f_ext):
        out = dyn.apply_external_forces(
            self.model, self._Xs(q), self._body_lists(f_in, ()),
            self._t(np.asarray(f_ext, dtype=np.float64).T,
                    (self.model.nb, 6)))
        return self._ref(out)

    # --- mass matrix ----------------------------------------------------- #
    def minv(self, q, output_dense=True):
        return self._np(dyn.minv(self.model, self._t(q), output_dense))

    def crba(self, q):
        return self._np(dyn.crba(self.model, self._t(q)))

    # --- forward dynamics ------------------------------------------------ #
    def aba(self, q, qd, tau, f_ext=None, GRAVITY=-9.81):
        return self._np(dyn.aba(
            self.model, self._t(q), self._t(qd), self._t(tau),
            self._opt(f_ext, (self.model.nb, 6)), GRAVITY))

    def forward_dynamics(self, q, qd, u, GRAVITY=-9.81):
        return self._np(dyn.forward_dynamics(
            self.model, self._t(q), self._t(qd), self._t(u), GRAVITY))

    def forward_dynamics_grad(self, q, qd, u, GRAVITY=-9.81):
        dq, dqd = dyn.forward_dynamics_grad(
            self.model, self._t(q), self._t(qd), self._t(u), GRAVITY)
        return self._np(dq), self._np(dqd)

    # --- granular Minv passes -------------------------------------------- #
    def minv_bpass(self, q):
        """Backward Minv sweep; returns (Minv, F, U, Dinv) in the
        reference's layouts: Minv (n, n) upper rows, F (n, 6, n), U (n, 6),
        Dinv (n,).  The reference's ``Dinv`` array stores D = S^T IA S (its
        ``minv_fpass`` divides by it); matched here.  Floating base: the
        root block's U rows hold the articulated root inertia (S = eye(6))
        and Dinv[0:6] its diagonal."""
        m = self.model
        rows, F, U_l, Dinv_l, fb_Dinv = dyn.minv_bpass(
            m, self._Xs(q), return_fb_Dinv=True)
        n = m.nv
        Fr, Ur, Dr = np.zeros((n, 6, n)), np.zeros((n, 6)), np.zeros(n)
        for i in range(m.nb):
            if m.floating_base and i == 0:
                D_root = np.linalg.inv(self._np(fb_Dinv))  # = articulated IA
                Ur[0:6, :] = D_root  # U = IA @ eye(6)
                Dr[0:6] = np.diag(D_root)
                Fr[0:6, :, :] = self._np(F[0])[None]
            else:
                mi = m.v_index(i)
                Fr[mi] = self._np(F[i])
                Ur[mi] = self._np(U_l[i])
                Dr[mi] = 1.0 / float(self._np(Dinv_l[i]))
        return self._np(torch.stack(rows)), Fr, Ur, Dr

    def minv_fpass(self, q, Minv, F, U, Dinv):
        """Forward Minv sweep completing the upper-triangular M^-1; takes
        ``minv_bpass``'s reference-layout intermediates and returns Minv
        (n, n)."""
        m = self.model
        fb = m.floating_base
        F = np.asarray(F, dtype=np.float64)
        F_l = [self._t(F[0 if fb and i == 0 else m.v_index(i)], (6, m.nv))
               for i in range(m.nb)]
        U_l, Dinv_l = [None] * m.nb, [None] * m.nb
        for i in range(1 if fb else 0, m.nb):
            mi = m.v_index(i)
            U_l[i] = self._t(U[mi])
            Dinv_l[i] = self._t(1.0 / np.float64(Dinv[mi]), ())
        rows = list(self._t(Minv, (m.nv, m.nv)).unbind(0))
        out = dyn.minv_fpass(m, self._Xs(q), rows, F_l, U_l, Dinv_l)
        return self._np(torch.stack(out))

    # --- granular RNEA-gradient passes ----------------------------------- #
    def _grad_fpass_full(self, q, qd, v, a, GRAVITY=-9.81):
        """v, a: the reference's (6, NB) layout (from ``rnea``, qdd
        included)."""
        nb = self.model.nb
        return dyn.rnea_grad_fpass(
            self.model, self._Xs(q), self._t(qd),
            self._t(np.asarray(v, dtype=np.float64).T, (nb, 6)),
            self._t(np.asarray(a, dtype=np.float64).T, (nb, 6)), GRAVITY,
            full=True)

    def rnea_grad_fpass_dq(self, q, qd, v, a, GRAVITY=-9.81):
        """dq forward derivative sweep: (dv_dq, da_dq, df_dq), each
        (6, n, NB).  ``v``/``a``: (6, NB) kinematics from ``rnea``."""
        dv_q, da_q, df_q, _, _, _ = self._grad_fpass_full(q, qd, v, a,
                                                          GRAVITY)
        return self._ref(dv_q), self._ref(da_q), self._ref(df_q)

    def rnea_grad_fpass_dqd(self, q, qd, v):
        """dqd forward derivative sweep: (dv_dqd, da_dqd, df_dqd), each
        (6, n, NB).  ``v``: (6, NB)."""
        a0 = np.zeros_like(np.asarray(v, dtype=np.float64))  # unused by dqd
        _, _, _, dv_d, da_d, df_d = self._grad_fpass_full(q, qd, v, a0)
        return self._ref(dv_d), self._ref(da_d), self._ref(df_d)

    def rnea_grad_bpass_dq(self, q, f, df_dq):
        """dq backward sweep -> dc_dq (n, n).  ``f``: (6, NB) accumulated
        forces; ``df_dq``: (6, n, NB)."""
        m = self.model
        df_q = self._body_lists(df_dq, (m.nv,))
        zeros = [torch.zeros_like(d) for d in df_q]
        dc_dq, _ = dyn.rnea_grad_bpass(
            m, self._Xs(q), self._t(np.asarray(f, dtype=np.float64).T,
                                    (m.nb, 6)), df_q, zeros)
        return self._np(dc_dq)

    def rnea_grad_bpass_dqd(self, q, df_dqd, USE_VELOCITY_DAMPING=False):
        """dqd backward sweep -> dc_dqd (n, n)."""
        m = self.model
        df_d = self._body_lists(df_dqd, (m.nv,))
        zeros = [torch.zeros_like(d) for d in df_d]
        f0 = torch.zeros((m.nb, 6), dtype=m.dtype, device=m.device)
        _, dc_dqd = dyn.rnea_grad_bpass(m, self._Xs(q), f0, zeros, df_d,
                                        USE_VELOCITY_DAMPING)
        return self._np(dc_dqd)

    # --- first/second-order derivatives ---------------------------------- #
    def rnea_grad(self, q, qd, qdd=None, GRAVITY=-9.81,
                  USE_VELOCITY_DAMPING=False):
        return self._np(dyn.rnea_grad(
            self.model, self._t(q), self._t(qd), self._opt(qdd), GRAVITY,
            USE_VELOCITY_DAMPING))

    def second_order_idsva_parallel(self, q, qd, qdd, GRAVITY=-9.81):
        outs = dyn.idsva_so(self.model, self._t(q), self._t(qd),
                            self._t(qdd), GRAVITY)
        return tuple(self._np(o) for o in outs)

    def fdsva_so(self, q, qd, u, GRAVITY=-9.81):
        outs = dyn.fdsva_so(self.model, self._t(q), self._t(qd), self._t(u),
                            GRAVITY)
        return tuple(self._np(o) for o in outs)

    # --- end-effector kinematics ----------------------------------------- #
    def end_effector_pose(self, q, ee_joint_names=None, ee_offsets=None):
        return self._np(fk.ee_pose(self.model, self._t(q),
                                   ee_names=ee_joint_names,
                                   offset=self._opt(ee_offsets)))

    def end_effector_pose_gradient(self, q, ee_joint_names=None,
                                   ee_offsets=None):
        return self._np(fk.ee_pose_gradient(self.model, self._t(q),
                                            ee_names=ee_joint_names,
                                            offset=self._opt(ee_offsets)))

    def end_effector_pose_hessian(self, q, ee_joint_names=None,
                                  ee_offsets=None):
        return self._np(fk.ee_pose_hessian(self.model, self._t(q),
                                           ee_names=ee_joint_names,
                                           offset=self._opt(ee_offsets)))
