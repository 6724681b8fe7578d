"""Dynamics-step kernels: the ABA + semi-implicit Euler step (K1) and the
line-search feedback rollout (K2), each beside its plain PyTorch version.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from ..dynamics.aba import aba
from ..model.robot import RobotModel
from ..solver.integrate import euler_semi_implicit, split_state, state_diff
from ..spatial.ops import mv
from . import _lib


def fd_step_plain(model: RobotModel, x, u, dt: float, gravity: float = -9.81):
    """x (B, nx), u (B, nv) -> x' (B, nx): ABA, then semi-implicit Euler."""
    q, qd = split_state(model, x)
    return euler_semi_implicit(model, x, aba(model, q, qd, u, gravity), dt)


def fd_step_fused(model: RobotModel, x, u, dt: float, gravity: float = -9.81):
    """One forward-dynamics step x (B, nx), u (B, nv) -> x' (B, nx).

    Kernel ``fd_step`` (csrc/fd_step.cu) replaces rbdtpu's
    ``kernels.fused.fd_step_fused`` (Pallas, fused.py:450): one thread per
    batch element builds the compact joint transforms, runs the three ABA
    sweeps and integrates, reading only x and u and writing only x'.
    Bound on the H100: latency, not bandwidth — at the solver's B=128 one
    launch fills one SM, and the per-thread ABA state (articulated inertias
    of every body) lives in local memory.  The design accepts that for now:
    the horizon loop stays on the host (100 launches per rollout), and fusing
    it is the whole-horizon kernel's job (rbdtpu K5).
    """
    if not x.is_cuda:
        return fd_step_plain(model, x, u, dt, gravity)
    B = x.shape[0]
    _lib.check(x, "x", (B, model.nx), x)
    _lib.check(u, "u", (B, model.nv), x)
    xo = torch.empty_like(x)
    _lib.launch("fd_step", model, x, x, u, xo, B, dt, gravity)
    return xo


def feedback_rollout_plain(model: RobotModel, x0, X_nom, U_nom, k_ff, K_fb,
                           dt: float, gravity: float = -9.81, u_clip=None):
    """Closed-loop rollout: per knot u = U_t + k_t + K_t (x - X_t), clamped
    to [-u_clip, u_clip] when given, then one ABA + Euler step.

    x0 (B, nx); X_nom (B, H, nx); U_nom, k_ff (B, H, nv) with the line-search
    step already folded into k_ff; K_fb (B, H, nv, nx).
    Returns (X (B, H, nx) — states 1..H, U (B, H, nv) — applied controls)."""
    x = x0
    xs, us = [], []
    for t in range(U_nom.shape[1]):
        dx = state_diff(model, x, X_nom[:, t])
        u = U_nom[:, t] + k_ff[:, t] + mv(K_fb[:, t], dx)
        if u_clip is not None:
            u = torch.clamp(u, -u_clip, u_clip)
        x = fd_step_plain(model, x, u, dt, gravity)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def feedback_rollout_fused(model: RobotModel, x0, X_nom, U_nom, k_ff, K_fb,
                           dt: float, gravity: float = -9.81, u_clip=None):
    """The line-search rollout of ``feedback_rollout_plain``, one launch for
    the whole horizon.

    Kernel ``feedback_rollout`` (csrc/feedback_rollout.cu) replaces rbdtpu's
    ``kernels.fused.feedback_rollout_fused`` (Pallas, fused.py:611, one
    launch per knot inside lax.scan): one thread per trajectory loops over
    the H knots with its state in registers.  Bound on the H100: the gain
    reads — each knot reads nv*nx values of K per thread, contiguous within
    a thread and so uncoalesced across the warp — and occupancy: 1024
    trajectories are 32 blocks of 32 threads on 132 SMs.  Small blocks
    spread them over as many SMs as possible; a transposed K layout (knot
    major, trajectory minor) would coalesce the reads and is left for later.
    """
    if not x0.is_cuda:
        return feedback_rollout_plain(model, x0, X_nom, U_nom, k_ff, K_fb,
                                      dt, gravity, u_clip)
    B, H = U_nom.shape[0], U_nom.shape[1]
    nx, nv = model.nx, model.nv
    _lib.check(x0, "x0", (B, nx), x0)
    _lib.check(X_nom, "X_nom", (B, H, nx), x0)
    _lib.check(U_nom, "U_nom", (B, H, nv), x0)
    _lib.check(k_ff, "k_ff", (B, H, nv), x0)
    _lib.check(K_fb, "K_fb", (B, H, nv, nx), x0)
    if u_clip is not None:
        _lib.check(u_clip, "u_clip", (nv,), x0)
    Xo = torch.empty_like(X_nom)
    Uo = torch.empty_like(U_nom)
    _lib.launch("feedback_rollout", model, x0, x0, X_nom, U_nom, k_ff, K_fb,
                u_clip, Xo, Uo, B, H, dt, gravity)
    return Xo, Uo
