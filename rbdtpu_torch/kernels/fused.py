"""Dynamics-step kernels, each beside its plain PyTorch version: the ABA +
semi-implicit Euler step (K1), the line-search feedback rollout (K2), RNEA
(K10), the M^-1 + RNEA step (K6) and the whole-horizon rollout (K5).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from ..dynamics.aba import aba
from ..dynamics.fd import forward_dynamics
from ..dynamics.rnea import rnea
from ..model.robot import RobotModel
from ..solver.integrate import euler_semi_implicit, split_state, state_diff
from ..spatial.ops import mv
from . import _lib


def _fext_arg(model: RobotModel, f_ext, B: int, ref: torch.Tensor):
    """A step kernel's wrench argument: (None, 0) without wrenches; the
    contiguous (nb, 6) set shared by the batch with stride 0; or the
    (B, nb, 6) per-element sets with stride nb*6."""
    if f_ext is None:
        return None, 0
    if f_ext.dim() == 2:
        _lib.check(f_ext, "f_ext", (model.nb, 6), ref)
        return f_ext, 0
    _lib.check(f_ext, "f_ext", (B, model.nb, 6), ref)
    return f_ext, model.nb * 6


def fd_step_plain(model: RobotModel, x, u, dt: float, gravity: float = -9.81,
                  f_ext=None):
    """x (B, nx), u (B, nv) -> x' (B, nx): ABA with the world-frame wrenches
    f_ext ((nb, 6) or (B, nb, 6)) when given, then semi-implicit Euler."""
    q, qd = split_state(model, x)
    return euler_semi_implicit(
        model, x, aba(model, q, qd, u, f_ext=f_ext, gravity=gravity), dt)


def fd_step_fused(model: RobotModel, x, u, dt: float, gravity: float = -9.81,
                  f_ext=None):
    """One forward-dynamics step x (B, nx), u (B, nv) -> x' (B, nx), with
    optional world-frame wrenches f_ext, (nb, 6) shared by the batch or
    (B, nb, 6).

    Kernel ``fd_step`` (csrc/fd_step.cu) replaces rbdtpu's
    ``kernels.fused.fd_step_fused`` (Pallas, fused.py:450): one thread per
    batch element builds the compact joint transforms, runs the three ABA
    sweeps (the wrenches enter the bias forces through the compact
    world->body chain) and integrates, reading only x, u and f_ext and
    writing only x'.  Bound on the H100: latency, not bandwidth — at the
    solver's B=128 one launch fills one SM, and the per-thread ABA state
    (articulated inertias of every body) lives in local memory.  The design
    accepts that for now: a rollout that needs only its final state takes
    the whole-horizon kernel (``rollout_fused_multi``) instead.
    """
    if not x.is_cuda:
        return fd_step_plain(model, x, u, dt, gravity, f_ext)
    B = x.shape[0]
    _lib.check(x, "x", (B, model.nx), x)
    _lib.check(u, "u", (B, model.nv), x)
    fe, stride = _fext_arg(model, f_ext, B, x)
    xo = torch.empty_like(x)
    _lib.launch("fd_step", model, x, x, u, fe, stride, xo, B, dt, gravity)
    return xo


def rollout_fused(model: RobotModel, x0, U, dt: float,
                  gravity: float = -9.81):
    """Rollout driven by the step kernel: x0 (B, nx), U (H, B, nv)
    scan-major -> final state (B, nx); one ``fd_step_fused`` per step."""
    x = x0
    for t in range(U.shape[0]):
        x = fd_step_fused(model, x, U[t], dt, gravity)
    return x


def rnea_plain(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81):
    """q, qd, qdd (B, n) -> tau (B, n); without qdd the bias forces."""
    return rnea(model, q, qd, qdd, gravity)[0]


def rnea_fused(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81):
    """RNEA joint forces in one launch: q, qd and optional qdd (B, n) ->
    tau (B, n).

    Kernel ``rnea`` (csrc/rnea.cu) replaces rbdtpu's
    ``kernels.fused.rnea_fused`` (Pallas, fused.py:358): one thread per
    state runs the transforms and both RNEA sweeps.  Without qdd the kernel
    is instantiated with the acceleration term compiled out.  Bound on the
    H100: arithmetic and latency of the serial tree walk; the traffic is the
    inputs once and tau once.
    """
    if not q.is_cuda:
        return rnea_plain(model, q, qd, qdd, gravity)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    _lib.check(qd, "qd", (B, n), q)
    if qdd is not None:
        _lib.check(qdd, "qdd", (B, n), q)
    tau = torch.empty(B, n, dtype=q.dtype, device=q.device)
    _lib.launch("rnea", model, q, q, qd, qdd, tau, B, gravity)
    return tau


def fd_step_minv_plain(model: RobotModel, x, u, dt: float,
                       gravity: float = -9.81, dense_minv: bool = False,
                       f_ext=None):
    """One step of ``forward_dynamics`` (qdd = M^-1 (u - c), the bias c
    carrying f_ext) and semi-implicit Euler.  The plain M^-1 is the dense
    analytical one either way; ``dense_minv`` selects the kernel's
    variant."""
    q, qd = split_state(model, x)
    qdd = forward_dynamics(model, q, qd, u, gravity, f_ext)
    return euler_semi_implicit(model, x, qdd, dt)


def fd_step_minv_fused(model: RobotModel, x, u, dt: float,
                       gravity: float = -9.81, dense_minv: bool = False,
                       f_ext=None):
    """One forward-dynamics step on the M^-1 + RNEA route (BASELINE.json
    configs[1]): x (B, nx), u (B, nv) -> x' (B, nx), with optional wrenches
    f_ext, (nb, 6) or (B, nb, 6).

    Kernel ``fd_step_minv`` (csrc/fd_step_minv.cu) replaces rbdtpu's
    ``kernels.fused.fd_step_minv_fused`` (Pallas, fused.py:1267): per
    element the bias RNEA (with the wrenches), then qdd = M^-1 (u - c) by
    the articulated-inertia factorisation applied to that vector, or with
    ``dense_minv=True`` by the explicit analytical M^-1, then Euler.  Bound
    on the H100: arithmetic and latency of the serial tree walks.
    """
    if not x.is_cuda:
        return fd_step_minv_plain(model, x, u, dt, gravity, dense_minv,
                                  f_ext)
    B = x.shape[0]
    _lib.check(x, "x", (B, model.nx), x)
    _lib.check(u, "u", (B, model.nv), x)
    fe, stride = _fext_arg(model, f_ext, B, x)
    xo = torch.empty_like(x)
    _lib.launch("fd_step_minv", model, x, x, u, fe, stride, xo, B,
                int(dense_minv), dt, gravity)
    return xo


_ROUTES = ("aba", "minv")


def rollout_multi_plain(model: RobotModel, x0, U, dt: float,
                        gravity: float = -9.81, route: str = "aba",
                        f_ext=None):
    """x0 (B, nx), U (H, B, nv), f_ext None or (H, nb, 6) -> final state
    (B, nx) after H steps of ``aba`` ("aba") or ``forward_dynamics``
    ("minv"), each followed by semi-implicit Euler."""
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    step = fd_step_minv_plain if route == "minv" else fd_step_plain
    x = x0
    for t in range(U.shape[0]):
        x = step(model, x, U[t], dt, gravity,
                 f_ext=None if f_ext is None else f_ext[t])
    return x


def rollout_fused_multi(model: RobotModel, x0, U, dt: float,
                        gravity: float = -9.81, route: str = "aba",
                        f_ext=None):
    """The whole horizon in one launch: x0 (B, nx), U (H, B, nv)
    scan-major -> final state (B, nx).  route "aba" (O(n) articulated
    step) or "minv" (bias RNEA + factorised M^-1 apply, BASELINE.json
    configs[1]); f_ext None or (H, nb, 6) per-knot world wrenches shared by
    the batch.

    Kernel ``rollout_multi`` (csrc/rollout_multi.cu) replaces rbdtpu's
    ``kernels.fused.rollout_fused_multi`` (Pallas, fused.py:1029), whose
    sequential grid axis carried the state in VMEM between steps: here one
    thread per trajectory loops over the H steps with its state in the
    thread and writes only the final state.  Bound on the H100: arithmetic
    and the latency of H dependent tree walks per thread; at B=4096 the
    32-thread blocks reach 128 of the 132 SMs.  Any B >= 1 is taken as it
    is.
    """
    if not x0.is_cuda:
        return rollout_multi_plain(model, x0, U, dt, gravity, route, f_ext)
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    H, B = U.shape[0], x0.shape[0]
    _lib.check(x0, "x0", (B, model.nx), x0)
    _lib.check(U, "U", (H, B, model.nv), x0)
    if f_ext is not None:
        _lib.check(f_ext, "f_ext", (H, model.nb, 6), x0)
    xo = torch.empty_like(x0)
    _lib.launch("rollout_multi", model, x0, x0, U, f_ext, xo, B, H,
                int(route == "minv"), dt, gravity)
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
