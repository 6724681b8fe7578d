"""The port's last gaps against rbdtpu, in float64 on the CPU:
``rnea_grad(use_damping=True)``, ``ee_pose_gradient`` and
``ee_pose_hessian``, ``add_limit_barrier``, the AD quadratisation of a cost
without analytic derivatives (and a DDP solve with it), the plain version of
K5 (``rollout_multi_plain``) on the floating roots, and the rpy humanoid's
EE cost, whose terms K4's plain version forms.  rbdtpu's results are
recorded in tests/data/kernel_gaps_refs.npz by
tests/make_kernel_gaps_fixture.py, so this file runs no JAX computation.
Tolerances: 1e-9 (absolute, or relative to the value's scale where it
exceeds 1), 1e-6 for controls and 1e-9 relative for J."""
import os

import numpy as np
import pytest
import torch

from rbdtpu_torch.dynamics import rnea_grad
from rbdtpu_torch.kernels import fused
from rbdtpu_torch.kinematics import ee_pose_gradient, ee_pose_hessian
from rbdtpu_torch.model import LEAVES, STATIC, load_asset, model_from_numpy
from rbdtpu_torch.solver import (
    Cost, DDPConfig, add_limit_barrier, ddp_solve, ee_reaching_cost,
    quadratic_tracking_cost, quadratize_trajectory,
)

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "kernel_gaps_refs.npz")
DT, GRAVITY = 0.01, -9.81
W = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
ITERS, ALPHAS = 3, 4
TARGET_M, EE_M = (0.35, 0.25, 1.1), ("left_arm_wrist_roll",)
WM = dict(w_ee=10.0, w_ee_f=500.0, w_qd=1e-2, w_u=1e-5)
NAMES = ("lx", "lu", "lxx", "luu", "lux", "lfx", "lfxx")


@pytest.fixture(scope="module")
def ref():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


_MODELS = {"arm7": ("arm7", {}),
           "quad": ("quadruped12", {"floating_base": True}),
           "quad_q": ("quadruped12", {"floating_base": True,
                                      "root_quat": True}),
           "hum": ("humanoid30", {"floating_base": True}),
           "hum_q": ("humanoid30", {"floating_base": True,
                                    "root_quat": True})}


def model(tag: str):
    name, kw = _MODELS[tag]
    return load_asset(name, device="cpu", dtype=torch.float64, **kw)


def T(a):
    return torch.tensor(a, dtype=torch.float64)


def close(got, want, tol=1e-9):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("tag", ["arm7", "quad"])
def test_rnea_grad_with_damping(ref, tag):
    """dc/dq and dc/dqd with the joints' damping on dc/dqd's diagonal (a
    floating root's on its six rows), the model's damping handed over
    through ``model_from_numpy``; without damping the diagonal goes."""
    base = model(tag)
    leaves = {k: getattr(base, k).numpy() for k in LEAVES}
    leaves["damping"] = ref[f"dmp_{tag}_damping"]
    m = model_from_numpy(leaves, {k: getattr(base, k) for k in STATIC},
                         device="cpu", dtype=torch.float64)
    x = T(ref[f"dmp_{tag}_x"])
    q, qd, qdd = x[:, :m.nq], x[:, m.nq:], T(ref[f"dmp_{tag}_qdd"])
    dcq, dcd = rnea_grad(m, q, qd, qdd, GRAVITY, use_damping=True,
                         split=True)
    close(dcq, ref[f"dmp_{tag}_dcq"])
    close(dcd, ref[f"dmp_{tag}_dcd"])
    _, free = rnea_grad(m, q, qd, qdd, GRAVITY, split=True)
    d = ref[f"dmp_{tag}_damping"]
    diag = np.concatenate([np.repeat(d[:1], 6), d[1:]]) if m.floating_base \
        else d
    close(dcd - free, np.broadcast_to(np.diag(diag), dcd.shape))


@pytest.mark.parametrize("tag,ee", [("arm7", None), ("quad_knee", ("FL_knee",)),
                                    ("quad_foot", ("RL_foot_fixed",))],
                         ids=["arm7", "quad_knee", "quad_foot"])
def test_ee_pose_derivatives(ref, tag, ee):
    """``ee_pose_gradient`` (..., n_ee, 6, nv) and ``ee_pose_hessian``
    (..., n_ee, 6, nv, nv): the atan2 derivatives of the pose's angles and,
    on the rpy root, the root transform's exact first and second
    derivatives."""
    m = model("arm7" if tag == "arm7" else "quad")
    q = T(ref[f"pose_{tag}_q"])
    close(ee_pose_gradient(m, q, ee_names=ee), ref[f"pose_{tag}_grad"])
    close(ee_pose_hessian(m, q, ee_names=ee), ref[f"pose_{tag}_hess"])


def test_ee_pose_derivatives_refuse_the_quaternion_root():
    """rbdtpu refuses the quaternion root's pose derivatives (its chart is
    the solver's tangent), and so does the port, with the same error."""
    m = model("quad_q")
    q = torch.zeros(1, m.nq, dtype=torch.float64)
    q[:, 3] = 1.0
    for fn in (ee_pose_gradient, ee_pose_hessian):
        with pytest.raises(ValueError, match="chart-dependent"):
            fn(m, q, ee_names=("FL_knee",))


def _goal(m):
    g = np.zeros(m.nx)
    if m.floating_base:
        g[2] = 0.4
        if m.root_quat:
            g[3] = 1.0
    return g


@pytest.mark.parametrize("tag", ["arm7", "quad_q"])
def test_limit_barrier_quadratisation(ref, tag):
    """The tracking cost inside ``add_limit_barrier`` at states past the
    joints' position and velocity limits: the hinges' exact gradient and
    active-set diagonal added to the analytic quadratisation (on the
    quaternion root in the tangent chart)."""
    m = model(tag)
    lo, hi = m.q_limit_vectors()
    assert bool(torch.isfinite(lo).any()) and bool(torch.isfinite(
        m.qd_limit_vector()).any())
    X, U = T(ref[f"quad_{tag}_X"]), T(ref[f"quad_{tag}_U"])
    q = X[..., :m.nq]
    assert bool(((q > hi) | (q < lo)).any()), "no limit is active"
    cost = add_limit_barrier(m, quadratic_tracking_cost(m, _goal(m), **W))
    assert cost.stage_derivs is not None
    for k, got in zip(NAMES, quadratize_trajectory(cost, X, U, model=m)):
        close(got.expand(ref[f"barrier_{tag}_{k}"].shape),
              ref[f"barrier_{tag}_{k}"])


@pytest.mark.parametrize("tag", ["arm7", "quad_q"])
def test_ad_quadratisation(ref, tag):
    """A cost without analytic derivatives (the tracking cost's stage and
    terminal alone) quadratised by ``torch.func`` under ``vmap``: on the
    quaternion root through ``state_retract`` at xi = 0 (lx and lxx 2 nv
    wide)."""
    m = model(tag)
    base = quadratic_tracking_cost(m, _goal(m), **W)
    X, U = T(ref[f"quad_{tag}_X"]), T(ref[f"quad_{tag}_U"])
    got = quadratize_trajectory(Cost(base.stage, base.terminal), X, U,
                                model=m)
    for k, g in zip(NAMES, got):
        close(g, ref[f"ad_{tag}_{k}"])


@pytest.mark.parametrize("tag", ["arm7", "quad_q"])
def test_ddp_solve_with_an_ad_cost(ref, tag):
    """``ddp_solve`` takes a stage/terminal-only cost on every root (it
    passes the model to the quadratisation): B = 2, H = 8, 3 iterations,
    plain route, against rbdtpu's: U within 1e-6, J within 1e-9
    relative."""
    m = model(tag)
    base = quadratic_tracking_cost(m, _goal(m), **W)
    state, hist = ddp_solve(
        m, Cost(base.stage, base.terminal), T(ref[f"ddp_{tag}_x0"]),
        T(ref[f"ddp_{tag}_U0"]),
        DDPConfig(iters=ITERS, dt=DT, n_alphas=ALPHAS, fused=False))
    np.testing.assert_allclose(state.U.numpy(), ref[f"ddp_{tag}_U"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(state.J.numpy(), ref[f"ddp_{tag}_J"],
                               rtol=1e-9)
    np.testing.assert_allclose(hist.numpy(), ref[f"ddp_{tag}_hist"],
                               rtol=1e-9)


@pytest.mark.parametrize("wrench", [False, True], ids=["free", "fext"])
@pytest.mark.parametrize("route", ["aba", "minv"])
@pytest.mark.parametrize("tag", ["quad", "hum", "hum_q"])
def test_rollout_multi_plain_on_the_roots(ref, tag, route, wrench):
    """K5's plain version, which its wrapper runs on CPU tensors, on the
    rpy quadruped, the rpy humanoid and the quaternion humanoid, both
    routes, with and without per-step wrenches, B = 4, H = 6: rbdtpu's
    plain step scanned (ABA or ``forward_dynamics``, then semi-implicit
    Euler, the manifold step on the quaternion root)."""
    m = model(tag)
    x0, U = T(ref[f"roll_{tag}_x0"]), T(ref[f"roll_{tag}_U"])
    F = T(ref[f"roll_{tag}_F"]) if wrench else None
    close(fused.rollout_fused_multi(m, x0, U, DT, GRAVITY, route=route,
                                    f_ext=F),
          ref[f"roll_{tag}_{route}{'_fext' if wrench else ''}"])


def test_ee_cost_on_the_rpy_humanoid(ref):
    """Path M's cost, ``ee_reaching_cost`` at the left wrist of the 31-body
    rpy humanoid on the kernel route (K4's plain version on the CPU, the
    class "fb32" on the card), against rbdtpu's analytic quadratisation;
    wrapped in ``add_limit_barrier`` it keeps its analytic route."""
    m = model("hum")
    X, U = T(ref["ee_hum_X"]), T(ref["ee_hum_U"])
    cost = ee_reaching_cost(m, TARGET_M, ee_names=EE_M, fused=None, **WM)
    close(cost.stage(X[:, :-1], U, torch.arange(U.shape[1])),
          ref["ee_hum_stage"])
    close(cost.terminal(X[:, -1]), ref["ee_hum_terminal"])
    for k, got in zip(NAMES, quadratize_trajectory(cost, X, U, model=m)):
        close(got.expand(ref[f"ee_hum_{k}"].shape), ref[f"ee_hum_{k}"])
    assert add_limit_barrier(m, cost).stage_derivs is not None
