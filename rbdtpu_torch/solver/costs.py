"""Cost models for trajectory optimisation (``rbdtpu.solver.costs``).

Costs are batch-closed callables ``stage(x, u, t)`` / ``terminal(x)`` on
arbitrary leading dims, with analytic quadratisations ``stage_derivs`` /
``terminal_derivs``; a cost without them is quadratised by ``torch.func``
(``quadratize_trajectory``), on the quaternion root in the solver's
tangent chart.  ``add_limit_barrier`` adds the URDF's joint limits to any
cost.
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


def _quat_tracking_cost(model: RobotModel, x_goal, w_q, w_qd, w_u, w_q_f,
                        w_qd_f) -> Cost:
    """The tracking cost on the quaternion root (rbdtpu
    solver/costs.py:54-112): the distance is the tangent d =
    state_diff(x, x_goal) (2 nv), the root's attitude error its log-map
    rotation vector; lx = J^T W d through the tangent Jacobian of the diff
    (Jr^-1(d_rot) on the rotation block, exp(d_rot^) on the translation
    block) and lxx its Gauss-Newton form J^T W J."""
    from ..spatial.quat import quat_exp, quat_to_R, so3_right_jacobian_inv
    from .integrate import state_diff

    nv = model.nv
    ndim = 2 * nv

    def weights(wq, wqd, ref):
        kw = dict(dtype=ref.dtype, device=ref.device)
        return torch.cat([torch.full((nv,), wq, **kw),
                          torch.full((nv,), wqd, **kw)])

    def diff(x):
        return state_diff(model, x, torch.as_tensor(
            x_goal, dtype=x.dtype, device=x.device))

    def derivs(x, W):
        d = diff(x)
        drot = d[..., 0:3]
        Jri = so3_right_jacobian_inv(drot)
        Rd = quat_to_R(quat_exp(drot))  # R_goal^T R_x = exp(d_rot^)
        g = W * d
        g_rot = (Jri * g[..., 0:3, None]).sum(-2)  # Jri^T g
        g_p = (Rd * g[..., 3:6, None]).sum(-2)  # Rd^T g
        lx = torch.cat([g_rot, g_p, g[..., 6:]], dim=-1)
        Hd = torch.diag(W).expand(x.shape[:-1] + (ndim, ndim)).clone()
        Hd[..., 0:3, 0:3] = Jri.transpose(-1, -2) @ (W[0:3, None] * Jri)
        Hd[..., 3:6, 3:6] = Rd.transpose(-1, -2) @ (W[3:6, None] * Rd)
        return lx, Hd

    def stage(x, u, t):
        d = diff(x)
        return 0.5 * ((weights(w_q, w_qd, x) * d * d).sum(-1) + w_u * _sq(u))

    def terminal(x):
        d = diff(x)
        return 0.5 * (weights(w_q_f, w_qd_f, x) * d * d).sum(-1)

    def stage_derivs(x, u, t):
        lx, lxx = derivs(x, weights(w_q, w_qd, x))
        kw = dict(dtype=x.dtype, device=x.device)
        return (lx, w_u * u, lxx, w_u * torch.eye(nv, **kw),
                torch.zeros(nv, ndim, **kw))

    def terminal_derivs(x):
        return derivs(x, weights(w_q_f, w_qd_f, x))

    return Cost(stage, terminal, stage_derivs, terminal_derivs)


def quadratic_tracking_cost(
    model: RobotModel, x_goal, *, w_q=1.0, w_qd=0.1, w_u=1e-4,
    w_q_f=100.0, w_qd_f=10.0,
) -> Cost:
    """0.5 * weighted squared distance to a goal state plus control effort,
    with its exact quadratisation: the flat difference, or on the
    quaternion root the tangent one (``_quat_tracking_cost``)."""
    if model.floating_base and model.root_quat:
        return _quat_tracking_cost(model, x_goal, w_q, w_qd, w_u, w_q_f,
                                   w_qd_f)
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
    specialize: bool = False,
) -> Cost:
    """Reach a Cartesian end-effector target: 0.5 w_ee |p_ee(q) - target|^2
    plus velocity and effort terms, with the Gauss-Newton quadratisation
    through the position Jacobian.  One end effector: ``ee_names`` names
    it, and None means the model's single leaf (a floating model's feet are
    several leaves: name one).  Every root quadratises in the solver's
    chart (``ee_position_jacobian_tangent``): the configuration coordinates
    on the fixed base and the rpy root, the body-twist tangent on the
    quaternion root, whose lx and lxx are therefore 2 nv wide (rbdtpu
    solver/costs.py:158-236).

    ``fused``: compute (e, J^T e, J^T J) through the ``ee_gn`` kernel's
    wrapper (``kernels.fk_lane.ee_gn_fused``), which follows the tensor's
    device: the kernel for CUDA tensors, its plain version for CPU tensors.
    None and True both do that; False always takes the plain version.
    ``specialize=True`` passes ``specialize`` to that wrapper for both of
    its kernels (gn True and False): the effector's model-specialised
    kernels ``ee_gn_static`` / ``ee_err_static`` (K4·K0) on CUDA tensors,
    their plain lane version on CPU tensors; with ``fused=False`` it
    raises ValueError.
    """
    if specialize and fused is False:
        raise ValueError("specialize=True takes the ee_gn kernel's "
                         "model-specialised form: fused must not be False")
    target = tuple(float(t) for t in target_xyz)
    nq, nv = model.nq, model.nv
    nb_q = nv  # the configuration block in the solver chart
    ndim = nb_q + nv

    def _ee_gn(x, gn):
        """(e, J^T e, J^T J) at the states x (..., nx); with gn=False,
        (e, None, None)."""
        lead = x.shape[:-1]
        q = x[..., :nq].reshape(-1, nq).contiguous()
        if fused is False:
            e, g0, H0 = ee_gn_plain(model, q, target, ee_names=ee_names,
                                    gn=gn)
        else:
            e, g0, H0 = ee_gn_fused(model, q, target, ee_names=ee_names,
                                    gn=gn, specialize=specialize)
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
        lxx = torch.zeros(batch + (ndim, ndim), **kw)
        lxx[..., :nb_q, :nb_q] = H_qq
        lxx[..., nb_q:, nb_q:] = w_qd_blk * torch.eye(nv, **kw)
        return lx, lxx

    def stage_derivs(x, u, t):
        g_q, H_qq = _ee_terms(x, w_ee)
        lx, lxx = _assemble(g_q, H_qq, w_qd, x)
        kw = dict(dtype=x.dtype, device=x.device)
        # constant blocks stay unbatched (nv, nv) / (nv, ndim)
        return (lx, w_u * u, lxx, w_u * torch.eye(nv, **kw),
                torch.zeros(nv, ndim, **kw))

    def terminal_derivs(x):
        g_q, H_qq = _ee_terms(x, w_ee_f)
        return _assemble(g_q, H_qq, w_qd_f, x)

    return Cost(stage, terminal, stage_derivs, terminal_derivs)


def add_limit_barrier(model: RobotModel, cost: Cost, *, w_q=100.0,
                      w_qd=10.0) -> Cost:
    """``cost`` plus quadratic hinges on the model's URDF position and
    velocity limits (rbdtpu solver/costs.py:277-380):

        0.5 w_q  sum relu(q - q_hi)^2 + relu(q_lo - q)^2
      + 0.5 w_qd sum relu(|qd| - qd_lim)^2

    with their exact piecewise derivatives (the Hessian is the active set's
    diagonal) added to the base cost's quadratisation, so an EE cost keeps
    its kernel route.  Unbounded coordinates (continuous joints, the
    floating root) add nothing.  On the quaternion root the terms live in
    the tangent chart: the joints' rows v_index(i) with a unit Jacobian
    (their retraction is additive), the root's six rows zero.  A base cost
    without analytic derivatives gives one without them (AD quadratises
    both)."""
    nq, nv = model.nq, model.nv
    quat_root = model.floating_base and model.root_quat
    ndim = 2 * nv if quat_root else nq + nv
    q_lo, q_hi = model.q_limit_vectors()
    qd_lim = model.qd_limit_vector()
    # finite limits only: an infinite one gives a zero hinge and gradient
    q_lo_f, q_hi_f, qd_f = (torch.isfinite(v) for v in (q_lo, q_hi, qd_lim))
    q_lo_s, q_hi_s, qd_s = (torch.where(f, v, torch.zeros_like(v)) for f, v in
                            ((q_lo_f, q_lo), (q_hi_f, q_hi), (qd_f, qd_lim)))

    def _hinges(x):
        q, qd = x[..., :nq], x[..., nq:]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        h_hi = torch.where(q_hi_f, torch.clamp(q - q_hi_s, min=0.0), zero)
        h_lo = torch.where(q_lo_f, torch.clamp(q_lo_s - q, min=0.0), zero)
        h_qd = torch.where(qd_f, torch.clamp(qd.abs() - qd_s, min=0.0), zero)
        return h_hi, h_lo, h_qd, qd

    def _penalty(x):
        h_hi, h_lo, h_qd, _ = _hinges(x)
        return 0.5 * (w_q * (_sq(h_hi) + _sq(h_lo)) + w_qd * _sq(h_qd))

    def _grad_diag(x):
        """(lx, diagonal of lxx) of the penalty in the solver's chart."""
        h_hi, h_lo, h_qd, qd = _hinges(x)
        g_q = w_q * (h_hi - h_lo)
        d_q = w_q * ((h_hi > 0) | (h_lo > 0)).to(x.dtype)
        g_qd = w_qd * h_qd * torch.sign(qd)
        d_qd = w_qd * (h_qd > 0).to(x.dtype)
        if quat_root:  # [root twist (6) | joints (nv - 6) | qd (nv)]
            zroot = torch.zeros(x.shape[:-1] + (6,), dtype=x.dtype,
                                device=x.device)
            return (torch.cat([zroot, g_q[..., 7:], g_qd], dim=-1),
                    torch.cat([zroot, d_q[..., 7:], d_qd], dim=-1))
        return (torch.cat([g_q, g_qd], dim=-1), torch.cat([d_q, d_qd], dim=-1))

    def stage(x, u, t):
        return cost.stage(x, u, t) + _penalty(x)

    def terminal(x):
        return cost.terminal(x) + _penalty(x)

    if cost.stage_derivs is None or cost.terminal_derivs is None:
        return Cost(stage, terminal)

    def _addx(lx, lxx, x):
        g, d = _grad_diag(x)
        lxx = lxx.expand(x.shape[:-1] + (ndim, ndim))
        return lx + g, lxx + torch.diag_embed(d)

    def stage_derivs(x, u, t):
        lx, lu, lxx, luu, lux = cost.stage_derivs(x, u, t)
        lx, lxx = _addx(lx, lxx, x)
        return lx, lu, lxx, luu, lux

    def terminal_derivs(x):
        return _addx(*cost.terminal_derivs(x), x)

    return Cost(stage, terminal, stage_derivs, terminal_derivs)


def trajectory_cost(cost: Cost, X, U):
    """Total cost: X (..., H+1, nx), U (..., H, nv) -> (...)."""
    ts = torch.arange(U.shape[-2], device=U.device)
    return cost.stage(X[..., :-1, :], U, ts).sum(-1) + cost.terminal(
        X[..., -1, :])


def quadratize_trajectory(cost: Cost, X, U, model: RobotModel | None = None):
    """Per-knot cost expansions (lx, lu, lxx, luu, lux, lfx, lfxx) with
    (..., H, ...) stage terms: the cost's analytic forms when it has them,
    else ``torch.func``'s gradients and Hessians under ``vmap`` over the
    flattened batch and knots (rbdtpu solver/costs.py:381-449).  On the
    quaternion root (pass ``model``) AD differentiates in the tangent chart,
    c(xi, u) = cost(state_retract(x, xi), u) at xi = 0, so lx and lxx are
    2 nv wide; analytic forms are taken to be in that chart already (the
    built-in costs' are)."""
    ts = torch.arange(U.shape[-2], device=U.device)
    if cost.stage_derivs is not None and cost.terminal_derivs is not None:
        lx, lu, lxx, luu, lux = cost.stage_derivs(X[..., :-1, :], U, ts)
        lfx, lfxx = cost.terminal_derivs(X[..., -1, :])
        return lx, lu, lxx, luu, lux, lfx, lfxx
    from torch.func import grad, hessian, jacfwd, vmap

    H, nx, nu = U.shape[-2], X.shape[-1], U.shape[-1]
    batch = U.shape[:-2]
    Xf = X[..., :-1, :].reshape(-1, nx)
    Uf = U.reshape(-1, nu)
    tf = ts.expand(batch + (H,)).reshape(-1)
    st = cost.stage
    if model is not None and model.floating_base and model.root_quat:
        from .integrate import state_retract

        ndim = 2 * model.nv
        z = torch.zeros(ndim, dtype=X.dtype, device=X.device)
        stage_t = lambda xi, x, u, t: st(state_retract(model, x, xi), u, t)
        term_t = lambda xi, x: cost.terminal(state_retract(model, x, xi))
        gx = vmap(lambda x, u, t: grad(stage_t)(z, x, u, t))
        hxx = vmap(lambda x, u, t: hessian(stage_t)(z, x, u, t))
        hux = vmap(lambda x, u, t: jacfwd(
            lambda xi: grad(stage_t, argnums=2)(xi, x, u, t))(z))
        gfx = vmap(lambda x: grad(term_t)(z, x))
        hfxx = vmap(lambda x: hessian(term_t)(z, x))
    else:
        ndim = nx
        gx, hxx = vmap(grad(st)), vmap(hessian(st))
        hux = vmap(jacfwd(grad(st, argnums=1)))
        gfx, hfxx = vmap(grad(cost.terminal)), vmap(hessian(cost.terminal))
    gu, huu = vmap(grad(st, argnums=1)), vmap(hessian(st, argnums=1))
    rs = lambda a: a.reshape(batch + (H,) + a.shape[1:])
    XT = X[..., -1, :].reshape(-1, nx)
    return (rs(gx(Xf, Uf, tf)), rs(gu(Xf, Uf, tf)), rs(hxx(Xf, Uf, tf)),
            rs(huu(Xf, Uf, tf)), rs(hux(Xf, Uf, tf)),
            gfx(XT).reshape(batch + (ndim,)),
            hfxx(XT).reshape(batch + (ndim, ndim)))
