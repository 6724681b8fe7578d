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
    """q, qd, u (B, n) -> (Minv (B, n, n) symmetric, dc/dq, dc/dqd (B, n, n)
    indexed [b, row, col], qdd (B, n)); the bias-force gradients are taken
    at the ABA acceleration."""
    qdd = aba(model, q, qd, u, gravity=gravity)
    dcq, dcd = rnea_grad(model, q, qd, qdd, gravity, split=True)
    return minv(model, q), dcq, dcd, qdd


def linearize_parts_fused(model: RobotModel, q, qd, u,
                          gravity: float = -9.81):
    """The pieces of ``linearize_parts_plain`` in one launch, for
    fixed-base models and the rpy floating root.

    Kernel ``linearize_parts`` (csrc/linearize.cu) replaces rbdtpu's
    ``kernels.colvec.linearize_parts_fused`` (Pallas, colvec.py:289): one
    thread per knot runs ABA, the RNEA sweeps at that acceleration, the
    analytical M^-1 (upper triangle, mirrored in the kernel) and, column by
    column, the dc/dq and dc/dqd derivative sweeps.  Bound on the H100:
    arithmetic per knot (roughly 2n tree sweeps of 6x6 algebra) and local
    memory — the per-body sweep state and the M^-1 F blocks do not fit in
    registers, so they spill to L1-cached local memory.  12,800 knots are
    200 blocks of 64 threads, enough to cover the 132 SMs; one thread per
    (knot, column) would add parallelism at the cost of recomputing the
    shared sweeps, a later trade.  On the rpy root the kernel seeds the
    six root-pose columns of dc/dq analytically (the pose enters only
    through the gravity seed, as in rbdtpu's kernel); the plain version
    takes them by forward-mode AD, so the two agree to rounding.
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
    _lib.launch("linearize_parts", model, q, q, qd, u, Minv, dcq, dcd, qdd,
                B, gravity)
    return Minv, dcq, dcd, qdd


def linearize_fused(model: RobotModel, q, qd, u, dt: float,
                    gravity: float = -9.81):
    """Discrete-step Jacobians from the kernel's pieces:
    q/qd/u (B, n) -> A (B, 2n, 2n), B (B, 2n, n).  The assembly
    (dqdd/dq = -Minv dc/dq, then step_jacobians) is plain torch."""
    Mi, dcq, dcd, _ = linearize_parts_fused(model, q, qd, u, gravity)
    return step_jacobians(model, Mi, -(Mi @ dcq), -(Mi @ dcd), dt)
