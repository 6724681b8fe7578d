"""DDP / iLQR trajectory optimiser (``rbdtpu.solver.ddp``, iLQR branch).

Natively batched over arbitrary leading dims of (x0, U0), with a fixed
iteration count and masked accept/reject, as in rbdtpu:

  - rollouts: a Python loop over the horizon; with ``DDPConfig(fused=True)``
    each step is the ``fd_step`` kernel on CUDA tensors;
  - linearisation: one batched sweep over all knots (``linearize_parts``
    kernel when fused);
  - backward pass: the plain Riccati recursion, one knot at a time, with a
    Cholesky of Quu whose non-PD result is NaN (the PD guard);
  - line search: every step size of the alpha ladder in parallel (one more
    batch dim), through the ``feedback_rollout`` kernel when fused; the best
    candidate per problem is accepted only when it improves the cost by
    more than ``tol_dJ`` (relative).

rbdtpu's TPU routing gates (compile probes, the batch % 8 packing branches,
the 256-lane floor of the feedback kernel) are not carried over: with
``fused=True`` and CUDA tensors every call site launches its kernel.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..dynamics.aba import aba
from ..dynamics.fd import forward_dynamics
from ..kernels.colvec import linearize_fused
from ..kernels.fused import fd_step_fused, feedback_rollout_fused
from ..model.robot import RobotModel
from ..spatial.ops import mv
from .costs import Cost, quadratize_trajectory, trajectory_cost
from .integrate import euler_semi_implicit, split_state, state_diff
from .rollout import linearize_trajectory


@dataclasses.dataclass(frozen=True)
class DDPConfig:
    """rbdtpu's DDPConfig fields.  Not ported yet (raise when set):
    ``parallel_riccati=True``, ``exact_hessians=True``,
    ``fused_riccati=True``."""
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


def _check_config(config: DDPConfig):
    for name in ("parallel_riccati", "exact_hessians", "fused_riccati"):
        if getattr(config, name):
            raise NotImplementedError(f"DDPConfig.{name} is not ported yet")
    if config.rollout_route not in ("aba", "minv"):
        raise ValueError(f"unknown rollout_route {config.rollout_route!r}")


def _step_plain(model, x, u, dt, gravity, route="aba"):
    q, qd = split_state(model, x)
    if route == "minv":
        qdd = forward_dynamics(model, q, qd, u, gravity)
    else:
        qdd = aba(model, q, qd, u, gravity=gravity)
    return euler_semi_implicit(model, x, qdd, dt)


def _flat(t):
    return t.reshape(-1, t.shape[-1]).contiguous()


def _make_step(model, config):
    if config.fused:
        def step(x, u):
            xn = fd_step_fused(model, _flat(x), _flat(u), config.dt,
                               config.gravity)
            return xn.reshape(x.shape)
        return step
    return lambda x, u: _step_plain(model, x, u, config.dt, config.gravity,
                                    config.rollout_route)


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
                 gravity, step_fn=None, u_clip=None):
    """Closed-loop rollouts for every alpha of the ladder, in parallel, for
    every problem.  X (..., H+1, nx), U/k (..., H, nv), K (..., H, nv, nx),
    alphas (n_alpha,).  Returns (Xs, Us, Js) with a leading n_alpha axis."""
    if step_fn is None:
        step_fn = lambda x, u: _step_plain(model, x, u, dt, gravity)
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
        x = step_fn(x, u)
        xs.append(x)
        us.append(u)
    X_new = torch.stack(xs, dim=-2)
    U_new = torch.stack(us, dim=-2)
    return X_new, U_new, trajectory_cost(cost, X_new, U_new)


def forward_pass_fused(model: RobotModel, cost: Cost, X, U, k, K, alphas, dt,
                       gravity, u_clip=None):
    """forward_pass with the whole alpha ladder x problem batch flattened
    into one ``feedback_rollout`` launch (alpha folded into k)."""
    n_alpha = alphas.shape[0]
    batch = U.shape[:-2]
    lead = (n_alpha,) + batch
    al = alphas.reshape((n_alpha,) + (1,) * (len(batch) + 2))
    flat = lambda a: a.expand(lead + a.shape[len(batch):]).reshape(
        (-1,) + a.shape[len(batch):]).contiguous()
    X_b = flat(X)
    X_tail, U_new = feedback_rollout_fused(
        model, X_b[:, 0].contiguous(), X_b[:, :-1].contiguous(), flat(U),
        (al * k).reshape((-1,) + k.shape[len(batch):]).contiguous(), flat(K),
        dt, gravity, u_clip=u_clip,
    )
    X_new = torch.cat([X_b[:, :1], X_tail], dim=1)
    X_new = X_new.reshape(lead + X_new.shape[1:])
    U_new = U_new.reshape(lead + U_new.shape[1:])
    return X_new, U_new, trajectory_cost(cost, X_new, U_new)


def ddp_solve(model: RobotModel, cost: Cost, x0, U0,
              config: DDPConfig = DDPConfig()):
    """Solve trajectory-optimisation problem(s): x0 (..., nx), U0 (..., H, nv)
    with arbitrary (possibly empty) leading batch dims.
    Returns (DDPState, J_history (iters, ...))."""
    _check_config(config)
    dt, gravity = config.dt, config.gravity
    kw = dict(dtype=x0.dtype, device=x0.device)
    alphas = 2.0 ** -torch.arange(config.n_alphas, **kw)
    batch = x0.shape[:-1]
    step_fn = _make_step(model, config)
    lin_fn = _make_linearize(model, config)
    use_fused_fwd = config.fused and config.fused_feedback is not False
    u_clip = model.u_limit_vector().to(**kw) if config.u_limits else None
    if u_clip is not None:
        U0 = torch.clamp(U0, -u_clip, u_clip)

    xs = [x0]
    for t in range(U0.shape[-2]):
        xs.append(step_fn(xs[-1], U0[..., t, :]))
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
        k, K, _, ok = backward_pass(A, B, lx, lu, lxx, luu, lux, lfx, lfxx,
                                    state.reg)
        if use_fused_fwd:
            Xs, Us, Js = forward_pass_fused(model, cost, state.X, state.U, k,
                                            K, alphas, dt, gravity, u_clip)
        else:
            Xs, Us, Js = forward_pass(model, cost, state.X, state.U, k, K,
                                      alphas, dt, gravity, step_fn, u_clip)
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
