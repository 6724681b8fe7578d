"""DDP / iLQR trajectory optimiser (``rbdtpu.solver.ddp``, iLQR branch).

Natively batched over arbitrary leading dims of (x0, U0), with a fixed
iteration count and masked accept/reject, as in rbdtpu:

  - rollouts: a Python loop over the horizon; with ``DDPConfig(fused=True)``
    each step is the ``fd_step`` kernel on CUDA tensors;
  - linearisation: one batched sweep over all knots (``linearize_parts``
    kernel when fused);
  - backward pass: the Riccati recursion, with a Cholesky of Quu whose
    non-PD result is NaN (the PD guard), routed as rbdtpu routes it
    (``_backward_route``): one knot at a time in plain torch, the whole
    horizon in one launch of the ``riccati_fused`` kernel at nx <= 16
    (``kernels.riccati``) or of the ``riccati`` kernel above
    (``kernels.riccati_chunk``), or the parallel-in-time scan
    (``solver.parallel_riccati``);
  - line search: every step size of the alpha ladder in parallel (one more
    batch dim), through the ``feedback_rollout`` kernel (K2) or its
    chunked-gain form ``feedback_chunked`` (K9) when fused, routed by
    ``_feedback_route``; the best candidate per problem is accepted only
    when it improves the cost by more than ``tol_dJ`` (relative).

rbdtpu's TPU gates are not carried over (compile probes, the 256-lane floor
of the feedback kernel, the multiple of 8 that the wrenches' fused step
needs): with ``fused=True`` and CUDA tensors every call site launches its
kernel.  The one exception is ``fused_feedback=True``, which applies
rbdtpu's tier rule between K2, K9 and the plain pass.

Disturbance wrenches (``ddp_solve(..., f_ext=...)``, rbdtpu's robust-MPC
surface) enter every rollout, the initial one and every line-search
candidate, through the kernels' wrench variants when fused; the
linearisation keeps the undisturbed A and B.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..dynamics.aba import aba
from ..dynamics.fd import forward_dynamics
from ..kernels.colvec import linearize_fused
from ..kernels.fused import (
    fd_step_fused, feedback_chunks, feedback_fused_ok,
    feedback_rollout_fused, feedback_rollout_fused_chunked,
)
from ..kernels.riccati import NX_MAX as LANE_SCALAR_NX_MAX
from ..kernels.riccati import backward_pass_fused
from ..kernels.riccati_chunk import backward_pass_chunked
from ..model.robot import RobotModel
from ..spatial.ops import mv
from .costs import Cost, quadratize_trajectory, trajectory_cost
from .integrate import euler_semi_implicit, split_state, state_diff
from .parallel_riccati import backward_pass_parallel
from .rollout import linearize_trajectory, normalize_f_ext


@dataclasses.dataclass(frozen=True)
class DDPConfig:
    """rbdtpu's DDPConfig fields.  Not ported yet (raises when set):
    ``exact_hessians=True``.  The backward pass (``_backward_route``):
    ``parallel_riccati=True`` runs the parallel-in-time scan (None and
    False: off; rbdtpu's auto gate for it is TPU-only).  Otherwise
    ``fused_riccati``: None runs the chunked sweep kernel on CUDA tensors
    at nx >= 24 (rbdtpu's routing boundary) and the plain sweep below;
    True runs the lane-scalar sweep kernel at nx <= 16 and the chunked one
    above (each its plain version on CPU tensors); False always runs the
    plain sweep.

    The line search (``_feedback_route``), with ``fused=True``:
    ``fused_feedback`` None runs K2 at any batch; True runs K2 where
    rbdtpu's budget for the unchunked kernel admits batch x alphas
    trajectories, else K9 with rbdtpu's chunk count, else (a batch x alphas
    that is not a multiple of 8, or no count fits) the plain pass; False
    runs the plain pass.  The budget is rbdtpu's routing rule, derived from
    the TPU's VMEM (``kernels.fused.feedback_fused_ok``,
    ``feedback_chunks``), not a limit of the H100: it keeps both packages on
    the same algorithm for the same configuration, and the port's own bench
    decides later whether the tier pays on this card."""
    iters: int = 20
    dt: float = 0.01
    gravity: float = -9.81
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e6
    reg_up: float = 10.0
    reg_down: float = 0.5
    n_alphas: int = 8  # parallel line-search ladder 1, 1/2, ..., 2^-(n-1)
    # minimum RELATIVE improvement to accept a candidate:
    # J_new < J - tol_dJ * max(1, |J|)
    tol_dJ: float = 1e-12
    fused: bool = False  # the fd_step kernel for rollouts
    fused_linearize: bool | None = None  # None follows ``fused``
    parallel_riccati: bool | None = None
    rollout_route: str = "aba"  # un-fused step: "aba" or "minv"
    exact_hessians: bool = False
    fused_feedback: bool | None = None  # None follows ``fused``
    fused_riccati: bool | None = None
    u_limits: bool = False  # clamp controls to the URDF effort limits


class DDPState(NamedTuple):
    X: torch.Tensor  # (..., H+1, nx) nominal states
    U: torch.Tensor  # (..., H, nv) nominal controls
    J: torch.Tensor  # (...) cost
    reg: torch.Tensor  # (...) regularisation
    dJ: torch.Tensor  # (...) last accepted improvement


# rbdtpu's auto boundary for the chunked sweep (solver/ddp.py,
# RBDTPU_CHUNK_NX_MIN's default); the lane-scalar sweep takes nx <= 16
CHUNK_NX_MIN = 24


def _check_config(config: DDPConfig):
    if config.exact_hessians:
        raise NotImplementedError("DDPConfig.exact_hessians is not ported yet")
    if config.rollout_route not in ("aba", "minv"):
        raise ValueError(f"unknown rollout_route {config.rollout_route!r}")


def _backward_route(model: RobotModel, config: DDPConfig, on_card: bool):
    """rbdtpu's backward-pass routing (solver/ddp.py:475-586), its
    ``_on_tpu()`` read as "the tensors are on the card": "parallel",
    "fused" (the lane-scalar sweep), "chunked" or "plain"."""
    if config.parallel_riccati:
        return "parallel"
    if config.fused_riccati is None:
        return "chunked" if on_card and model.nx >= CHUNK_NX_MIN else "plain"
    if not config.fused_riccati:
        return "plain"
    return "fused" if model.nx <= LANE_SCALAR_NX_MAX else "chunked"


def _feedback_route(model: RobotModel, config: DDPConfig,
                    batch_total: int):
    """The line search's route for ``batch_total`` = batch x alphas
    trajectories (rbdtpu solver/ddp.py:506-528): ("fused", None) for K2,
    ("chunked", nchunks) for K9, ("plain", None) for the plain pass."""
    if not config.fused or config.fused_feedback is False:
        return "plain", None
    if config.fused_feedback is None or feedback_fused_ok(model, batch_total):
        return "fused", None
    nchunks = feedback_chunks(model, batch_total)
    return ("plain", None) if nchunks is None else ("chunked", nchunks)


def _step_plain(model, x, u, dt, gravity, route="aba", f_ext=None):
    q, qd = split_state(model, x)
    if route == "minv":
        qdd = forward_dynamics(model, q, qd, u, gravity, f_ext)
    else:
        qdd = aba(model, q, qd, u, f_ext=f_ext, gravity=gravity)
    return euler_semi_implicit(model, x, qdd, dt)


def _flat(t):
    return t.reshape(-1, t.shape[-1]).contiguous()


def _make_step(model, config):
    """One step ``step(x, u, fe=None)``, fe a knot's wrench set (nb, 6) or
    None: with ``fused`` the ``fd_step`` kernel (its wrench variant under
    fe) at any batch."""
    if config.fused:
        def step(x, u, fe=None):
            xn = fd_step_fused(model, _flat(x), _flat(u), config.dt,
                               config.gravity, f_ext=fe)
            return xn.reshape(x.shape)
        return step
    return lambda x, u, fe=None: _step_plain(
        model, x, u, config.dt, config.gravity, config.rollout_route,
        f_ext=fe)


def _make_linearize(model, config):
    fused = (config.fused_linearize if config.fused_linearize is not None
             else config.fused)
    if not fused:
        return lambda X, U: linearize_trajectory(model, X, U, config.dt,
                                                 config.gravity)

    def lin(X, U):
        q, qd = split_state(model, X[..., :-1, :])
        lead = q.shape[:-1]
        A, B = linearize_fused(model, _flat(q), _flat(qd), _flat(U),
                               config.dt, config.gravity)
        return A.reshape(lead + A.shape[1:]), B.reshape(lead + B.shape[1:])
    return lin


def _at(t, arr, rank):
    """Knot t of a per-knot block, or the block itself when it is a
    constant (unbatched, ``rank`` dims)."""
    return arr if arr.dim() == rank else arr[..., t, :, :]


def backward_pass(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg):
    """Riccati sweep over the horizon.  A (..., H, nx, nx), B (..., H, nx, nu),
    lx/lu (..., H, n), lxx/luu/lux per knot (..., H, r, c) or constant (r, c),
    lfx (..., nx), lfxx (..., nx, nx), reg (...).

    Returns (k (..., H, nu), K (..., H, nu, nx), dV1 (...), ok (...)); ok is
    False where some Quu + reg I was not positive definite."""
    H = A.shape[-3]
    nu = lu.shape[-1]
    eye_u = torch.eye(nu, dtype=lu.dtype, device=lu.device)
    reg_I = reg[..., None, None] * eye_u
    Vx, Vxx = lfx, lfxx
    ok = torch.ones(lfx.shape[:-1], dtype=torch.bool, device=lfx.device)
    dV1 = torch.zeros(lfx.shape[:-1], dtype=lfx.dtype, device=lfx.device)
    ks, Ks = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        A_s, B_s = A[..., t, :, :], B[..., t, :, :]
        At, Bt = A_s.transpose(-1, -2), B_s.transpose(-1, -2)
        VxxA = Vxx @ A_s
        Qx = lx[..., t, :] + mv(At, Vx)
        Qu = lu[..., t, :] + mv(Bt, Vx)
        Qxx = _at(t, lxx, 2) + At @ VxxA
        Quu = _at(t, luu, 2) + Bt @ (Vxx @ B_s)
        Qux = _at(t, lux, 2) + Bt @ VxxA
        # non-PD Quu + reg I -> NaN factor -> pd False (the PD guard)
        L, info = torch.linalg.cholesky_ex(Quu + reg_I)
        L = torch.where((info != 0)[..., None, None],
                        torch.full_like(L, float("nan")), L)
        pd = torch.isfinite(L).all(-1).all(-1)
        k = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
        K = -torch.cholesky_solve(Qux, L)
        Kt, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
        Vx = Qx + mv(Kt, mv(Quu, k)) + mv(Kt, Qu) + mv(QuxT, k)
        Vxx = Qxx + Kt @ (Quu @ K) + Kt @ Qux + QuxT @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        dV1 = dV1 + (k * Qu).sum(-1)
        ok = ok & pd
        ks[t], Ks[t] = k, K
    return torch.stack(ks, dim=-2), torch.stack(Ks, dim=-3), dV1, ok


def forward_pass(model: RobotModel, cost: Cost, X, U, k, K, alphas, dt,
                 gravity, step_fn=None, u_clip=None, f_ext=None):
    """Closed-loop rollouts for every alpha of the ladder, in parallel, for
    every problem.  X (..., H+1, nx), U/k (..., H, nv), K (..., H, nv, nx),
    alphas (n_alpha,).  f_ext: None or (H, nb, 6) per-knot wrenches, each
    knot's passed to ``step_fn(x, u, fe)`` (fe None without them).
    Returns (Xs, Us, Js) with a leading n_alpha axis."""
    if step_fn is None:
        step_fn = lambda x, u, fe=None: _step_plain(model, x, u, dt, gravity,
                                                    f_ext=fe)
    n_alpha = alphas.shape[0]
    batch = U.shape[:-2]
    al = alphas.reshape((n_alpha,) + (1,) * (len(batch) + 1))
    x = X[..., 0, :].expand((n_alpha,) + X.shape[:-2] + X.shape[-1:])
    xs, us = [x], []
    for t in range(U.shape[-2]):
        u = U[..., t, :] + al * k[..., t, :] + mv(
            K[..., t, :, :], state_diff(model, x, X[..., t, :]))
        if u_clip is not None:
            u = torch.clamp(u, -u_clip, u_clip)
        x = step_fn(x, u, None if f_ext is None else f_ext[t])
        xs.append(x)
        us.append(u)
    X_new = torch.stack(xs, dim=-2)
    U_new = torch.stack(us, dim=-2)
    return X_new, U_new, trajectory_cost(cost, X_new, U_new)


def forward_pass_fused(model: RobotModel, cost: Cost, X, U, k, K, alphas, dt,
                       gravity, u_clip=None, nchunks=None, f_ext=None):
    """forward_pass with the whole alpha ladder x problem batch flattened
    into one launch (alpha folded into k): ``feedback_rollout`` (K2), or
    with ``nchunks`` its chunked-gain form ``feedback_chunked`` (K9); with
    ``f_ext`` ((H, nb, 6), contiguous) their wrench variants."""
    n_alpha = alphas.shape[0]
    batch = U.shape[:-2]
    lead = (n_alpha,) + batch
    al = alphas.reshape((n_alpha,) + (1,) * (len(batch) + 2))
    flat = lambda a: a.expand(lead + a.shape[len(batch):]).reshape(
        (-1,) + a.shape[len(batch):]).contiguous()
    X_b = flat(X)
    args = (model, X_b[:, 0].contiguous(), X_b[:, :-1].contiguous(), flat(U),
            (al * k).reshape((-1,) + k.shape[len(batch):]).contiguous(),
            flat(K), dt, gravity)
    if nchunks is None:
        X_tail, U_new = feedback_rollout_fused(*args, u_clip=u_clip,
                                               f_ext=f_ext)
    else:
        X_tail, U_new = feedback_rollout_fused_chunked(
            *args, u_clip=u_clip, nchunks=nchunks, f_ext=f_ext)
    X_new = torch.cat([X_b[:, :1], X_tail], dim=1)
    X_new = X_new.reshape(lead + X_new.shape[1:])
    U_new = U_new.reshape(lead + U_new.shape[1:])
    return X_new, U_new, trajectory_cost(cost, X_new, U_new)


def ddp_solve(model: RobotModel, cost: Cost, x0, U0,
              config: DDPConfig = DDPConfig(), f_ext=None):
    """Solve trajectory-optimisation problem(s): x0 (..., nx), U0 (..., H, nv)
    with arbitrary (possibly empty) leading batch dims.

    f_ext: optional world-frame disturbance wrenches on the bodies, (nb, 6)
    constant or (H, nb, 6) per knot, shared by the batch
    (``normalize_f_ext``): the initial rollout and every line-search
    candidate apply them with ``dynamics.aba(f_ext)`` semantics, so J is
    the disturbed cost; A and B stay undisturbed (rbdtpu's
    ``ddp_solve(f_ext)``).
    Returns (DDPState, J_history (iters, ...))."""
    _check_config(config)
    dt, gravity = config.dt, config.gravity
    kw = dict(dtype=x0.dtype, device=x0.device)
    alphas = 2.0 ** -torch.arange(config.n_alphas, **kw)
    batch = x0.shape[:-1]
    F = normalize_f_ext(model, f_ext, U0.shape[-2], x0.dtype)
    if F is not None:
        F = F.to(x0.device).contiguous()
    step_fn = _make_step(model, config)
    lin_fn = _make_linearize(model, config)
    batch_total = config.n_alphas
    for b in batch:
        batch_total *= b
    fwd_route, nchunks = _feedback_route(model, config, batch_total)
    route = _backward_route(model, config, x0.is_cuda)
    backward = {"parallel": backward_pass_parallel,
                "fused": backward_pass_fused,
                "chunked": backward_pass_chunked,
                "plain": backward_pass}[route]
    u_clip = model.u_limit_vector().to(**kw) if config.u_limits else None
    if u_clip is not None:
        U0 = torch.clamp(U0, -u_clip, u_clip)

    xs = [x0]
    for t in range(U0.shape[-2]):
        xs.append(step_fn(xs[-1], U0[..., t, :],
                          None if F is None else F[t]))
    X0 = torch.stack(xs, dim=-2)
    state = DDPState(
        X=X0, U=U0, J=trajectory_cost(cost, X0, U0),
        reg=torch.full(batch, config.reg_init, **kw),
        dJ=torch.full(batch, float("inf"), **kw),
    )
    J_hist = []
    for _ in range(config.iters):
        A, B = lin_fn(state.X, state.U)
        lx, lu, lxx, luu, lux, lfx, lfxx = quadratize_trajectory(
            cost, state.X, state.U)
        if route in ("fused", "chunked"):
            A, B, lx, lu, lxx, luu, lux = (t.contiguous() for t in (
                A, B, lx, lu, lxx, luu, lux))
        k, K, _, ok = backward(A, B, lx, lu, lxx, luu, lux, lfx, lfxx,
                               state.reg)
        if fwd_route != "plain":
            Xs, Us, Js = forward_pass_fused(model, cost, state.X, state.U, k,
                                            K, alphas, dt, gravity, u_clip,
                                            nchunks, F)
        else:
            Xs, Us, Js = forward_pass(
                model, cost, state.X, state.U, k, K, alphas, dt, gravity,
                step_fn, u_clip, F)
        Js = torch.where(torch.isfinite(Js), Js, float("inf"))
        best = torch.argmin(Js, dim=0)  # first index on ties
        J_best = Js.amin(dim=0)

        def take(arr):
            idx = best.reshape((1,) + best.shape
                               + (1,) * (arr.dim() - 1 - best.dim()))
            return torch.gather(arr, 0, idx.expand((1,) + arr.shape[1:]))[0]

        min_dJ = config.tol_dJ * torch.clamp(state.J.abs(), min=1.0)
        improved = ok & (J_best < state.J - min_dJ)
        sel = lambda c, a, b: torch.where(
            c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)
        reg = torch.where(improved, state.reg * config.reg_down,
                          state.reg * config.reg_up)
        state = DDPState(
            X=sel(improved, take(Xs), state.X),
            U=sel(improved, take(Us), state.U),
            J=torch.where(improved, J_best, state.J),
            reg=torch.clamp(reg, config.reg_min, config.reg_max),
            dJ=torch.where(improved, state.J - J_best,
                           torch.zeros_like(state.J)),
        )
        J_hist.append(state.J)
    return state, torch.stack(J_hist)
