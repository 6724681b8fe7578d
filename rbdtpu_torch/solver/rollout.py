"""Trajectory rollout and batched linearisation (``rbdtpu.solver.rollout``)."""
from __future__ import annotations

import torch

from ..dynamics.fd import forward_dynamics_full
from ..model.robot import RobotModel
from .integrate import split_state, step_jacobians


def normalize_f_ext(model: RobotModel, f_ext, H: int, dtype):
    """Validate and broadcast a disturbance-wrench input to (H, NB, 6).

    ``f_ext`` holds per-body world-frame spatial wrenches, either (NB, 6),
    constant over the horizon, or (H, NB, 6), one per knot; it is shared by
    the whole batch.  Semantics are those of ``dynamics.aba(f_ext)``."""
    if f_ext is None:
        return None
    fe = torch.as_tensor(f_ext, dtype=dtype)
    if fe.ndim == 2 and tuple(fe.shape) == (model.nb, 6):
        return fe[None].expand(H, model.nb, 6)
    if fe.ndim == 3 and tuple(fe.shape) == (H, model.nb, 6):
        return fe
    raise ValueError(f"f_ext must be (NB={model.nb}, 6) or (H={H}, NB, 6); "
                     f"got {tuple(fe.shape)}")


def rollout(model: RobotModel, x0, U, dt: float, gravity: float = -9.81,
            fused: bool = False, f_ext=None):
    """Roll the dynamics forward under a control sequence:
    x0 (..., nx), U (..., H, nv) -> X (..., H+1, nx), states 0..H.

    Each step is ABA + semi-implicit Euler.  fused=True runs each step
    through ``kernels.fd_step_fused`` (K1) on the flattened batch — one
    launch per step on a CUDA tensor, its plain version on a CPU tensor.
    f_ext: optional world-frame wrenches, (NB, 6) or (H, NB, 6)
    (``normalize_f_ext``), applied with ``dynamics.aba(f_ext)`` semantics.
    Each step's state is pinned to the input's dtype, as rbdtpu pins its
    scan carry: a model in a wider dtype would otherwise promote the
    reduced-precision states of MPPI's ``sampling_dtype``."""
    H = U.shape[-2]
    F = normalize_f_ext(model, f_ext, H, U.dtype)
    if F is not None:
        F = F.to(U.device)
    from ..kernels.fused import fd_step_fused, fd_step_plain

    if fused:
        def step(x, u, fe):
            flat = x.reshape(-1, x.shape[-1]).contiguous()
            return fd_step_fused(model, flat,
                                 u.reshape(-1, u.shape[-1]).contiguous(), dt,
                                 gravity, f_ext=fe).reshape(x.shape).to(
                                     x.dtype)
    else:
        def step(x, u, fe):
            return fd_step_plain(model, x, u, dt, gravity, fe).to(x.dtype)

    xs = [x0]
    for t in range(H):
        xs.append(step(xs[-1], U[..., t, :],
                       None if F is None else F[t].contiguous()))
    return torch.stack(xs, dim=-2)


def linearize_trajectory(model: RobotModel, X, U, dt: float,
                         gravity: float = -9.81):
    """Per-knot discrete Jacobians: X (..., H+1, nx), U (..., H, nv) ->
    A (..., H, ntan, ntan), B (..., H, ntan, nv), all knots in one batched
    sweep (the quaternion root's transport takes the post-step twist)."""
    q, qd = split_state(model, X[..., :-1, :])
    qdd, Mi, dq, dqd = forward_dynamics_full(model, q, qd, U, gravity)
    qd_new = qd + dt * qdd if model.root_quat else None
    return step_jacobians(model, Mi, dq, dqd, dt, qd_new=qd_new)
