"""Cost models for trajectory optimisation (``rbdtpu.solver.costs``).

Costs are batch-closed callables ``stage(x, u, t)`` / ``terminal(x)`` on
arbitrary leading dims, with analytic quadratisations ``stage_derivs`` /
``terminal_derivs``.  The AD quadratisation of rbdtpu (for costs without
analytic derivatives) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..kernels.fk_lane import ee_gn_fused, ee_gn_plain
from ..model.robot import RobotModel


@dataclasses.dataclass(frozen=True)
class Cost:
    stage: Callable  # (x, u, t) -> (...) cost per state
    terminal: Callable  # (x,) -> (...)
    stage_derivs: Optional[Callable] = None  # (x,u,t)->(lx,lu,lxx,luu,lux)
    terminal_derivs: Optional[Callable] = None  # (x,)->(lfx,lfxx)


def _sq(v):
    return (v * v).sum(-1)


def quadratic_tracking_cost(
    model: RobotModel, x_goal, *, w_q=1.0, w_qd=0.1, w_u=1e-4,
    w_q_f=100.0, w_qd_f=10.0,
) -> Cost:
    """0.5 * weighted squared distance to a goal state plus control effort,
    with its exact quadratisation (flat chart; the quaternion-root tangent
    form is not ported yet)."""
    if model.floating_base and model.root_quat:
        raise NotImplementedError("quaternion-root tracking cost not ported")
    nq, nv = model.nq, model.nv
    nx = nq + nv

    def weights(wq, wqd, ref):
        kw = dict(dtype=ref.dtype, device=ref.device)
        return torch.cat([torch.full((nq,), wq, **kw),
                          torch.full((nv,), wqd, **kw)])

    def goal(ref):
        return torch.as_tensor(x_goal, dtype=ref.dtype, device=ref.device)

    def stage(x, u, t):
        d = x - goal(x)
        return 0.5 * ((weights(w_q, w_qd, x) * d * d).sum(-1) + w_u * _sq(u))

    def terminal(x):
        d = x - goal(x)
        return 0.5 * (weights(w_q_f, w_qd_f, x) * d * d).sum(-1)

    def stage_derivs(x, u, t):
        W = weights(w_q, w_qd, x)
        kw = dict(dtype=x.dtype, device=x.device)
        # constant blocks stay unbatched
        return (W * (x - goal(x)), w_u * u, torch.diag(W),
                w_u * torch.eye(nv, **kw), torch.zeros(nv, nx, **kw))

    def terminal_derivs(x):
        Wf = weights(w_q_f, w_qd_f, x)
        return Wf * (x - goal(x)), torch.diag(Wf).expand(
            x.shape[:-1] + (nx, nx))

    return Cost(stage, terminal, stage_derivs, terminal_derivs)


def ee_reaching_cost(
    model: RobotModel, target_xyz, *, w_ee=1.0, w_qd=1e-2, w_u=1e-4,
    w_ee_f=100.0, w_qd_f=1.0, ee_names=None, fused: bool | None = None,
) -> Cost:
    """Reach a Cartesian end-effector target: 0.5 w_ee |p_ee(q) - target|^2
    plus velocity and effort terms, with the Gauss-Newton quadratisation
    through the position Jacobian.  One end effector: ``ee_names`` names
    it, and None means the model's single leaf (a floating model's feet are
    several leaves: name one).  Fixed-base models and the rpy root, whose
    chart is the configuration coordinates (nq = nv, so J^T J fills the
    q-block of lxx as it is).

    ``fused``: compute (e, J^T e, J^T J) through the ``ee_gn`` kernel's
    wrapper (``kernels.fk_lane.ee_gn_fused``), which follows the tensor's
    device: the kernel for CUDA tensors, its plain version for CPU tensors.
    None and True both do that; False always takes the plain version.
    """
    target = tuple(float(t) for t in target_xyz)
    nq, nv = model.nq, model.nv
    nx = nq + nv

    def _ee_gn(x, gn):
        """(e, J^T e, J^T J) at the states x (..., nx); with gn=False,
        (e, None, None)."""
        lead = x.shape[:-1]
        fn = ee_gn_plain if fused is False else ee_gn_fused
        e, g0, H0 = fn(model, x[..., :nq].reshape(-1, nq).contiguous(),
                       target, ee_names=ee_names, gn=gn)
        if not gn:
            return e.reshape(lead + (3,)), None, None
        return (e.reshape(lead + (3,)), g0.reshape(lead + (nv,)),
                H0.reshape(lead + (nv, nv)))

    def ee_err(x):
        return _ee_gn(x, gn=False)[0]

    def _ee_terms(x, w):
        """w J^T e and w J^T J (Gauss-Newton terms of 0.5 w |e|^2)."""
        _, g0, H0 = _ee_gn(x, gn=True)
        return w * g0, w * H0

    def stage(x, u, t):
        return 0.5 * (w_ee * _sq(ee_err(x)) + w_qd * _sq(x[..., nq:])
                      + w_u * _sq(u))

    def terminal(x):
        return 0.5 * (w_ee_f * _sq(ee_err(x)) + w_qd_f * _sq(x[..., nq:]))

    def _assemble(g_q, H_qq, w_qd_blk, x):
        batch = x.shape[:-1]
        kw = dict(dtype=x.dtype, device=x.device)
        lx = torch.cat([g_q, w_qd_blk * x[..., nq:]], dim=-1)
        lxx = torch.zeros(batch + (nx, nx), **kw)
        lxx[..., :nq, :nq] = H_qq
        lxx[..., nq:, nq:] = w_qd_blk * torch.eye(nv, **kw)
        return lx, lxx

    def stage_derivs(x, u, t):
        g_q, H_qq = _ee_terms(x, w_ee)
        lx, lxx = _assemble(g_q, H_qq, w_qd, x)
        kw = dict(dtype=x.dtype, device=x.device)
        # constant blocks stay unbatched (nv, nv) / (nv, nx)
        return (lx, w_u * u, lxx, w_u * torch.eye(nv, **kw),
                torch.zeros(nv, nx, **kw))

    def terminal_derivs(x):
        g_q, H_qq = _ee_terms(x, w_ee_f)
        return _assemble(g_q, H_qq, w_qd_f, x)

    return Cost(stage, terminal, stage_derivs, terminal_derivs)


def trajectory_cost(cost: Cost, X, U):
    """Total cost: X (..., H+1, nx), U (..., H, nv) -> (...)."""
    ts = torch.arange(U.shape[-2], device=U.device)
    return cost.stage(X[..., :-1, :], U, ts).sum(-1) + cost.terminal(
        X[..., -1, :])


def quadratize_trajectory(cost: Cost, X, U):
    """Per-knot analytic cost expansions:
    (lx, lu, lxx, luu, lux, lfx, lfxx) with (..., H, ...) stage terms."""
    if cost.stage_derivs is None or cost.terminal_derivs is None:
        raise NotImplementedError(
            "AD quadratisation is not ported; give the cost analytic "
            "stage_derivs and terminal_derivs")
    ts = torch.arange(U.shape[-2], device=U.device)
    lx, lu, lxx, luu, lux = cost.stage_derivs(X[..., :-1, :], U, ts)
    lfx, lfxx = cost.terminal_derivs(X[..., -1, :])
    return lx, lu, lxx, luu, lux, lfx, lfxx
