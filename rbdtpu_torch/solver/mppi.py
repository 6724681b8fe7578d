"""MPPI, sampling-based trajectory optimisation (``rbdtpu.solver.mppi``):
perturbed control sequences rolled out in one batch and reweighted by a
softmin of their costs.

Natively batched over leading problem dims, as rbdtpu's: problems x samples
flatten into one rollout batch, which with ``MPPIConfig(fused=True)`` and
CUDA tensors steps through the ``fd_step`` kernel (K1).

Noise: rbdtpu draws it with ``jax.random.normal(key, ...)``, whose bits
torch cannot reproduce.  So the port draws standard normals from an explicit
``torch.Generator`` on the tensors' device, or takes them ready-made through
``noise`` (scaled by ``sigma`` inside, as rbdtpu scales its draws): the
argument exists so that a test can feed both packages the same draws.
"""
from __future__ import annotations

import dataclasses

import torch

from ..model.robot import RobotModel
from .costs import Cost, trajectory_cost
from .rollout import rollout


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """rbdtpu's MPPIConfig fields.  ``temperature`` is relative: the softmin's
    lambda is temperature x (mean finite sample cost - best sample cost).
    ``u_limits`` clips the samples, and so the update, to the model's
    effort box.  ``sampling_dtype`` (e.g. "float32", "bfloat16") runs the
    sample rollouts in that dtype and scores them back in the solve dtype;
    the update's rollout and the acceptance guard stay in the solve dtype.
    On the card the kernels take float32 and float64 only, so a bfloat16
    sampling rollout with ``fused=True`` raises."""
    n_samples: int = 256
    sigma: float = 0.5
    temperature: float = 0.05
    dt: float = 0.01
    gravity: float = -9.81
    fused: bool = False  # the fd_step kernel for the rollouts
    u_limits: bool = False
    sampling_dtype: str | None = None


def _roll(model, config, x0, U, f_ext, dtype=None):
    """Rollouts of x0 (..., nx) under U (..., H, nv) flattened to one batch;
    in ``dtype`` when given (and then f_ext too), else in U's."""
    nx, (H, nu) = x0.shape[-1], U.shape[-2:]
    if dtype is not None:
        x0, U = x0.to(dtype), U.to(dtype)
        f_ext = None if f_ext is None else torch.as_tensor(f_ext).to(dtype)
    X = rollout(model, x0.reshape(-1, nx), U.reshape(-1, H, nu), config.dt,
                config.gravity, fused=config.fused, f_ext=f_ext)
    return X.reshape(U.shape[:-2] + (H + 1, nx))


def mppi_step(model: RobotModel, cost: Cost, x0, U, generator=None,
              config: MPPIConfig = MPPIConfig(), f_ext=None, noise=None):
    """One MPPI update: x0 (..., nx), U (..., H, nv) -> (U_new (..., H, nv),
    accepted cost (...)).

    Draws ``sigma`` x N(0, 1) perturbations from ``generator`` (a
    torch.Generator on U's device), or takes the standard normals ``noise``
    (..., S, H, nv) when given; sample 0 is the unperturbed nominal.  The
    acceptance guard keeps the best of the weighted update, the best sample
    and the nominal; with ``sampling_dtype`` the best sample and the
    nominal are re-scored by two rollouts in the solve dtype."""
    batch = U.shape[:-2]
    H, nu = U.shape[-2:]
    nx = x0.shape[-1]
    S = config.n_samples
    shape = batch + (S, H, nu)
    if noise is None:
        if generator is None:
            raise ValueError("mppi_step needs a torch.Generator or noise")
        noise = torch.randn(shape, generator=generator, dtype=U.dtype,
                            device=U.device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
    eps = config.sigma * noise.to(dtype=U.dtype, device=U.device)
    eps = torch.cat([torch.zeros_like(eps[..., :1, :, :]),
                     eps[..., 1:, :, :]], dim=-3)
    U_samp = U[..., None, :, :] + eps
    if config.u_limits:
        lim = model.u_limit_vector().to(dtype=U.dtype, device=U.device)
        U_samp = torch.clamp(U_samp, -lim, lim)
        eps = U_samp - U[..., None, :, :]

    x0_b = x0[..., None, :].expand(batch + (S, nx))
    if config.sampling_dtype is not None:
        sdt = getattr(torch, config.sampling_dtype, None)
        if not isinstance(sdt, torch.dtype):
            raise ValueError(
                f"unknown sampling_dtype {config.sampling_dtype!r}")
        X_samp = _roll(model, config, x0_b, U_samp, f_ext, sdt)
        Js = trajectory_cost(cost, X_samp.to(U.dtype), U_samp)
    else:
        Js = trajectory_cost(cost, _roll(model, config, x0_b, U_samp, f_ext),
                             U_samp)
    Js = torch.where(torch.isfinite(Js), Js, float("inf"))
    beta = Js.amin(dim=-1)
    finite = torch.where(torch.isfinite(Js), Js, beta[..., None])
    lam = config.temperature * (finite.mean(dim=-1) - beta) + 1e-10
    w = torch.softmax(-(Js - beta[..., None]) / lam[..., None], dim=-1)
    U_new = U + torch.einsum("...s,...shu->...hu", w, eps)
    J_new = trajectory_cost(cost, _roll(model, config, x0, U_new, f_ext),
                            U_new)
    idx = Js.argmin(dim=-1)[..., None, None, None].expand(batch + (1, H, nu))
    U_best = torch.gather(U_samp, -3, idx)[..., 0, :, :]
    if config.sampling_dtype is not None:
        J_best = trajectory_cost(
            cost, _roll(model, config, x0, U_best, f_ext), U_best)
        J_nom = trajectory_cost(cost, _roll(model, config, x0, U, f_ext), U)
        cand_J = torch.stack([J_new, J_best, J_nom], dim=-1)
    else:
        cand_J = torch.stack([J_new, beta, Js[..., 0]], dim=-1)
    pick = cand_J.argmin(dim=-1)
    pick_e = pick[..., None, None]
    U_out = torch.where(pick_e == 0, U_new,
                        torch.where(pick_e == 1, U_best, U))
    J_out = torch.gather(cand_J, -1, pick[..., None])[..., 0]
    return U_out, J_out


def mppi_solve(model: RobotModel, cost: Cost, x0, U0, generator=None,
               iters: int = 16, config: MPPIConfig = MPPIConfig(),
               f_ext=None, noise=None):
    """``iters`` MPPI updates (batched as ``mppi_step``); ``noise``, when
    given, holds every iteration's standard normals, (iters, ..., S, H,
    nv).  Returns (U, cost history (iters, ...))."""
    U, hist = U0, []
    for t in range(iters):
        U, J = mppi_step(model, cost, x0, U, generator, config, f_ext,
                         None if noise is None else noise[t])
        hist.append(J)
    return U, torch.stack(hist)
