"""The DDP linearisation kernel (K3) beside its plain PyTorch version.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from ..dynamics.aba import aba
from ..dynamics.minv import minv
from ..dynamics.rnea_grad import rnea_grad
from ..model.robot import RobotModel
from ..solver.integrate import step_jacobians
from . import _lib


def linearize_parts_plain(model: RobotModel, q, qd, u,
                          gravity: float = -9.81):
    """q (B, nq), qd, u (B, n) -> (Minv (B, n, n) symmetric, dc/dq, dc/dqd
    (B, n, n) indexed [b, row, col], qdd (B, n)); the bias-force gradients
    are taken at the ABA acceleration, dc/dq in the solver's chart (the
    quaternion root's tangent columns)."""
    qdd = aba(model, q, qd, u, gravity=gravity)
    dcq, dcd = rnea_grad(model, q, qd, qdd, gravity, split=True)
    return minv(model, q), dcq, dcd, qdd


def linearize_parts_fused(model: RobotModel, q, qd, u,
                          gravity: float = -9.81):
    """The pieces of ``linearize_parts_plain`` in one launch, for
    fixed-base models and both floating roots.

    Kernel ``linearize_parts`` (csrc/linearize.cu) replaces rbdtpu's
    ``kernels.colvec.linearize_parts_fused`` (Pallas, colvec.py:289): one
    team of lanes (``_lib.TEAM``) per knot computes the base quantities once
    into shared memory (the team ABA step of csrc/rbd_team.cuh, then the
    RNEA accelerations and forces at its qdd), then runs the 2 nv
    derivative columns and the nv columns of M^-1 one column a lane, each
    walking the bodies in depth-first preorder with one shared-memory slot
    a tree level, so no lane keeps a per-body array on its stack (trees of
    up to ``_lib.LIN_LEVELS`` levels).  Bound on the H100: latency (a
    column's walk over the tree is one dependent chain).  On the rpy root
    the kernel seeds the six root-pose columns of dc/dq analytically (the
    pose enters only through the gravity seed, as in rbdtpu's kernel); on
    the quaternion root ("fq32") its three rotation columns seed w x e_j,
    w the linear part of X_0 a_grav, and its translation columns vanish
    (rbdtpu colvec.py:154-170).  The plain version takes them by
    forward-mode AD, so the two agree to rounding.
    """
    if not q.is_cuda:
        return linearize_parts_plain(model, q, qd, u, gravity)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    _lib.check(qd, "qd", (B, n), q)
    _lib.check(u, "u", (B, n), q)
    Minv = torch.empty(B, n, n, dtype=q.dtype, device=q.device)
    dcq = torch.empty_like(Minv)
    dcd = torch.empty_like(Minv)
    qdd = torch.empty_like(qd)
    _, tpb, smem, _ = _lib.linearize_geometry(
        _lib.size_class("linearize_parts", model), q.dtype, B,
        _lib.sm_count(q.device))
    _lib.launch("linearize_parts", model, q, q, qd, u, Minv, dcq, dcd, qdd,
                B, tpb, smem, gravity)
    return Minv, dcq, dcd, qdd


def linearize_fused(model: RobotModel, q, qd, u, dt: float,
                    gravity: float = -9.81):
    """Discrete-step Jacobians from the kernel's pieces:
    q (B, nq), qd/u (B, n) -> A (B, 2n, 2n), B (B, 2n, n).  The assembly
    (dqdd/dq = -Minv dc/dq, then step_jacobians, which on the quaternion
    root takes the post-step twist qd + dt qdd) is plain torch."""
    Mi, dcq, dcd, qdd = linearize_parts_fused(model, q, qd, u, gravity)
    qd_new = qd + dt * qdd if model.root_quat else None
    return step_jacobians(model, Mi, -(Mi @ dcq), -(Mi @ dcd), dt,
                          qd_new=qd_new)
