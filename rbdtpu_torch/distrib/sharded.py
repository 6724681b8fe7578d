"""Sharded batched solves (``rbdtpu.distrib.sharded``) on
``torch.distributed``.

Every rank takes the global batch, as rbdtpu's callers pass it, solves its
own rows (``mesh.shard_batch``) with the natively batched solver, and
returns what rbdtpu's global arrays hold: the per-problem results gathered
from every rank (``all_gather``) and the scalar reductions (``all_reduce``,
rbdtpu's ``psum`` and ``pmin``).  ``axis`` is an axis name or a tuple of
names: on a ("host", "batch") mesh ``axis=("host", "batch")`` shards over
every rank and reduces over both axes.

On a gloo group the collectives move their operands (costs, controls,
scalars: small next to the solve) through host memory, where every gloo
build takes them; on an NCCL group they stay on the card.  That is each
backend's need, not a fallback: the backend is the mesh's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..model.robot import RobotModel
from ..solver.costs import Cost, trajectory_cost
from ..solver.ddp import DDPConfig, ddp_solve
from ..solver.mppi import MPPIConfig
from ..solver.rollout import rollout
from .mesh import Mesh, shard_batch


def _wire(mesh: Mesh, t):
    """``t`` where the mesh's backend reduces it: host memory for gloo."""
    return t.detach().to("cpu" if mesh.backend == "gloo" else mesh.device)


def _all_reduce(mesh: Mesh, t, axis, op=dist.ReduceOp.SUM):
    buf = _wire(mesh, t).clone()
    dist.all_reduce(buf, op=op, group=mesh.group(axis)[0])
    return buf.to(t.device)


def _all_gather(mesh: Mesh, t, axis):
    """Every shard's ``t`` over ``axis``, concatenated along dim 0 in shard
    order (``mesh.axis_index``)."""
    group, ranks = mesh.group(axis)
    buf = _wire(mesh, t).contiguous()
    parts = [torch.empty_like(buf) for _ in ranks]
    dist.all_gather(parts, buf, group=group)
    order = sorted(range(len(ranks)),
                   key=lambda g: mesh.axis_index(axis, ranks[g]))
    return torch.cat([parts[g] for g in order]).to(t.device)


def _check_model(mesh: Mesh, model: RobotModel):
    if model.device != mesh.device:
        raise ValueError(f"the model is on {model.device}, the rank on "
                         f"{mesh.device}: replicate(mesh, model) first")


def sharded_rollouts(mesh: Mesh, model: RobotModel, x0, U, dt,
                     gravity=-9.81, axis="batch"):
    """Rollouts of x0 (B, nx) under U (B, H, nv), B divisible by the
    number of shards over ``axis``: each rank rolls its rows with the
    plain ``rollout`` (as rbdtpu calls it, without ``fused``).  Returns X
    (B, H+1, nx) on every rank."""
    _check_model(mesh, model)
    X = rollout(model, shard_batch(mesh, x0, axis),
                shard_batch(mesh, U, axis), dt, gravity)
    return _all_gather(mesh, X, axis)


def sharded_ddp_solve(mesh: Mesh, model: RobotModel, cost: Cost, x0_batch,
                      U0_batch, config: DDPConfig = DDPConfig(),
                      axis="batch"):
    """A batch of independent DDP solves sharded over ``axis``: each rank
    runs the natively batched ``ddp_solve`` on its rows (with
    ``config.fused`` on the card, the kernels at the local batch).
    Returns (J (B,), U (B, H, nv), mean_J) on every rank; mean_J is the
    all-reduced sum of J over the all-reduced count of problems, rbdtpu's
    reduction."""
    _check_model(mesh, model)
    x0_s = shard_batch(mesh, x0_batch, axis)
    states, _ = ddp_solve(model, cost, x0_s, shard_batch(mesh, U0_batch,
                                                         axis), config)
    total = _all_reduce(mesh, states.J.sum(), axis)
    n = _all_reduce(mesh, torch.tensor(float(states.J.shape[0]),
                                       dtype=x0_s.dtype, device=x0_s.device),
                    axis)
    return (_all_gather(mesh, states.J, axis),
            _all_gather(mesh, states.U, axis), total / n)


def sharded_mppi_step(mesh: Mesh, model: RobotModel, cost: Cost, x0, U,
                      generator=None, config: MPPIConfig = MPPIConfig(),
                      axis="batch", noise=None):
    """One MPPI update whose sample population is sharded over ``axis``
    (rbdtpu's multi-host sampling MPC of BASELINE.json configs[4]).

    Each rank draws its ``n_samples // shards`` perturbations (standard
    normals from ``generator``, a torch.Generator on the rank's device that
    the caller seeds per rank as rbdtpu folds the device index into its
    key, or the ready normals ``noise`` (local_n, H, nv)), rolls them out
    with the plain ``rollout``, and the softmin's best cost (all-reduce
    MIN), its robust mean, normaliser, weighted update and weighted cost
    (all-reduce SUM) are global.  Unlike ``solver.mppi_step`` there is no
    nominal sample and no acceptance guard: rbdtpu's sharded update.
    x0 (nx,), U (H, nv) the same on every rank -> (U_new (H, nv), J_mean)."""
    _check_model(mesh, model)
    x0, U = x0.to(mesh.device), U.to(mesh.device)
    local_n = config.n_samples // mesh.axis_size(axis)
    shape = (local_n,) + tuple(U.shape)
    if noise is None:
        if generator is None:
            raise ValueError("sharded_mppi_step needs a torch.Generator or "
                             "noise")
        noise = torch.randn(shape, generator=generator, dtype=U.dtype,
                            device=U.device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
    eps = config.sigma * noise.to(dtype=U.dtype, device=U.device)
    U_samp = U[None] + eps
    X = rollout(model, x0.expand((local_n,) + tuple(x0.shape)), U_samp,
                config.dt, config.gravity)
    Js = trajectory_cost(cost, X, U_samp)
    Js = torch.where(torch.isfinite(Js), Js, float("inf"))
    beta = _all_reduce(mesh, Js.min(), axis, dist.ReduceOp.MIN)
    finite = torch.where(torch.isfinite(Js), Js, beta)
    mean = _all_reduce(mesh, finite.sum(), axis) / config.n_samples
    lam = config.temperature * (mean - beta) + 1e-10
    w_un = torch.exp(-(Js - beta) / lam)
    w = w_un / _all_reduce(mesh, w_un.sum(), axis)
    dU = _all_reduce(mesh, torch.einsum("s,shu->hu", w, eps), axis)
    J_mean = _all_reduce(mesh, (w * Js).sum(), axis)
    return U + dU, J_mean
