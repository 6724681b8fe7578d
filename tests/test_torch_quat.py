"""The port's quaternion floating root against rbdtpu's, in float64 on the
CPU: the quaternion algebra and the tangent chart, the dynamics with the
root's tangent columns, FK's body-twist Jacobian, the plain versions of
K1-K4 against rbdtpu's Pallas kernels (run once in interpret mode), the
tracking and hand-reaching costs with their quadratisations, and paths G
(the quaternion humanoid hybrid, bench.py:539-590 with root_quat=True) and
H (humanoid hand reaching, bench.py:640-672) cut to B = 2, H = 4 and 2
iterations.  rbdtpu's results are recorded in tests/data/quat_refs.npz by
tests/make_quat_fixture.py, so this file runs no JAX computation.
Tolerances: 1e-9 for the algebra, dynamics, kinematics and costs, 1e-6 for
controls (relative 1e-9 for J)."""
import os

import numpy as np
import pytest
import torch

from rbdtpu_torch import solver
from rbdtpu_torch.dynamics import aba, minv, rnea, rnea_grad
from rbdtpu_torch.kernels import colvec, fk_lane, fused
from rbdtpu_torch.kinematics import ee_position_jacobian_tangent, fk_world_hom
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.spatial import quat as Q

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "quat_refs.npz")
DT, GRAVITY = 0.01, -9.81
WG = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
WE = dict(w_ee=10.0, w_ee_f=500.0, w_qd=1e-2, w_u=1e-5)
TARGET_H, EE_H = (0.35, 0.25, 1.1), ("left_arm_wrist_roll",)


@pytest.fixture(scope="module")
def ref():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def models():
    load = lambda name: load_asset(name, device="cpu", dtype=torch.float64,
                                   floating_base=True, root_quat=True)
    return {"quad": load("quadruped12"), "hum": load("humanoid30")}


def T(a):
    return torch.tensor(a, dtype=torch.float64)


def close(got, want, tol=1e-9):
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


ALGEBRA = {
    "quat_exp": lambda r: Q.quat_exp(T(r["phi"])),
    "quat_log": lambda r: Q.quat_log(T(r["qa"])),
    "quat_mul": lambda r: Q.quat_mul(T(r["qa"]), T(r["qb"])),
    "quat_to_R": lambda r: Q.quat_to_R(T(r["qa"])),
    "quat_normalize": lambda r: Q.quat_normalize(T(r["qb"])),
    "quat_from_rpy": lambda r: Q.quat_from_rpy(T(r["rpy"])),
    "jr": lambda r: Q.so3_right_jacobian(T(r["phi"])),
    "jr_inv": lambda r: Q.so3_right_jacobian_inv(T(r["phi"])),
}


@pytest.mark.parametrize("fn", list(ALGEBRA))
def test_quaternion_algebra(ref, fn):
    """spatial/quat.py against rbdtpu's, the Taylor branches (a zero and a
    1e-7 rotation, a w < 0 quaternion of a tiny angle) included."""
    close(ALGEBRA[fn](ref), ref[fn])


CHART = {
    "config_retract": lambda m, r: solver.config_retract(
        m, T(r["chart_q0"]), T(r["chart_xi"])),
    "config_diff": lambda m, r: solver.config_diff(
        m, T(r["chart_x1"][:, :m.nq]), T(r["chart_q0"])),
    "state_diff": lambda m, r: solver.state_diff(
        m, T(r["chart_x1"]), T(r["chart_x0"])),
    "euler": lambda m, r: solver.euler_semi_implicit(
        m, T(r["chart_x0"]), T(r["chart_qdd"]), DT),
    "step_A": lambda m, r: solver.step_jacobians(
        m, T(r["chart_Mi"]), T(r["chart_dq"]), T(r["chart_dqd"]), DT,
        qd_new=T(r["chart_qd_new"]))[0],
    "step_B": lambda m, r: solver.step_jacobians(
        m, T(r["chart_Mi"]), T(r["chart_dq"]), T(r["chart_dqd"]), DT,
        qd_new=T(r["chart_qd_new"]))[1],
}


@pytest.mark.parametrize("fn", list(CHART))
def test_tangent_chart(ref, models, fn):
    """The chart of solver/integrate.py on the quaternion humanoid: retract,
    diff, the manifold Euler step and the step Jacobians' SO(3)
    transport."""
    close(CHART[fn](models["hum"], ref), ref[fn])


def test_state_retract_inverts_diff(ref, models):
    """state_retract(x0, state_diff(x1, x0)) is x1 (rbdtpu's x1 was made
    as a retraction of x0)."""
    m = models["hum"]
    x0, x1 = T(ref["chart_x0"]), T(ref["chart_x1"])
    close(solver.state_retract(m, x0, solver.state_diff(m, x1, x0)), x1)


DYNAMICS = {
    "rnea": lambda m, a: rnea(m, a["q"], a["qd"], a["qdd"], GRAVITY)[0],
    "rnea_fext": lambda m, a: rnea(m, a["q"], a["qd"], a["qdd"], GRAVITY,
                                   f_ext=a["fext"])[0],
    "aba": lambda m, a: aba(m, a["q"], a["qd"], a["tau"], gravity=GRAVITY),
    "aba_fext": lambda m, a: aba(m, a["q"], a["qd"], a["tau"],
                                 f_ext=a["fext"], gravity=GRAVITY),
    "minv": lambda m, a: minv(m, a["q"]),
    "dcq": lambda m, a: rnea_grad(m, a["q"], a["qd"], a["qdd"], GRAVITY,
                                  split=True)[0],
    "dcd": lambda m, a: rnea_grad(m, a["q"], a["qd"], a["qdd"], GRAVITY,
                                  split=True)[1],
    "fk": lambda m, a: fk_world_hom(m, a["q"]),
}


@pytest.mark.parametrize("fn", list(DYNAMICS))
@pytest.mark.parametrize("tag", ["quad", "hum"])
def test_dynamics(ref, models, tag, fn):
    """RNEA (with and without world wrenches), ABA (likewise), M^-1, the
    RNEA gradient (the root's six tangent columns of dc/dq by forward-mode
    AD through the retraction) and FK on the quaternion quadruped and
    humanoid at B = 3."""
    a = {k: T(ref[f"{tag}_{k}"]) for k in ("q", "qd", "qdd", "tau", "fext")}
    close(DYNAMICS[fn](models[tag], a), ref[f"{tag}_{fn}"])


def test_ee_jacobian_tangent(ref, models):
    """The humanoid's left-wrist position Jacobian in the body-twist
    tangent chart."""
    close(ee_position_jacobian_tangent(models["hum"], T(ref["hum_q"]),
                                       ee_names=EE_H), ref["hum_jac"])


def test_fd_step_plain_matches_rbdtpus_kernel(ref, models):
    """K1's plain version against rbdtpu's ``fd_step_fused`` (Pallas,
    interpret mode): ABA, then the manifold Euler step."""
    m = models["quad"]
    x = torch.cat([T(ref["k_q"]), T(ref["k_qd"])], -1)
    close(fused.fd_step_plain(m, x, T(ref["k_u"]), DT, GRAVITY), ref["k1"])


def test_feedback_rollout_plain_matches_rbdtpus_kernel(ref, models):
    """K2's plain version against rbdtpu's ``feedback_rollout_fused``: the
    gains act on the tangent difference (the root's quaternion log)."""
    m = models["quad"]
    X, U = fused.feedback_rollout_plain(
        m, *(T(ref[f"k2_{k}"]) for k in ("x0", "Xn", "Un", "kf", "Kf")), DT,
        GRAVITY)
    close(X, ref["k2_X"])
    close(U, ref["k2_U"])


def test_linearize_parts_plain_matches_rbdtpus_kernel(ref, models):
    """K3's plain version against rbdtpu's ``linearize_parts_fused``: the
    root's analytic tangent columns (rbdtpu's kernel) against forward-mode
    AD (the port's plain version)."""
    got = colvec.linearize_parts_plain(models["quad"], T(ref["k_q"]),
                                       T(ref["k_qd"]), T(ref["k_u"]),
                                       GRAVITY)
    for g, k in zip(got, ("Minv", "dcq", "dcd", "qdd")):
        close(g, ref[f"k3_{k}"])


def test_ee_gn_plain_matches_rbdtpus_kernel(ref, models):
    """K4's plain version against rbdtpu's ``ee_gn_fused`` at the
    humanoid's left wrist (the fused EE Jacobian equals the analytic one to
    rounding, rbdtpu solver/costs.py:153-154)."""
    e, g0, H0 = fk_lane.ee_gn_plain(models["hum"], T(ref["k4_q"]), TARGET_H,
                                    ee_names=EE_H)
    close(e, ref["k4_e"])
    close(g0, ref["k4_g0"])
    close(H0, ref["k4_H0"])


def _cost(m, tag, goal):
    if tag == "track":
        return solver.quadratic_tracking_cost(m, goal, **WG)
    return solver.ee_reaching_cost(m, TARGET_H, ee_names=EE_H, fused=False,
                                   **WE)


@pytest.mark.parametrize("tag", ["track", "ee"])
def test_costs(ref, models, tag):
    """The tracking cost (log-map attitude error, Jr^-1 and exp(d_rot^) in
    its derivatives) and the hand-reaching cost (Gauss-Newton through the
    tangent Jacobian): J and every quadratisation block."""
    m = models["hum"]
    cost = _cost(m, tag, ref["goal"])
    X, U = T(ref["cost_X"]), T(ref["cost_U"])
    close(solver.trajectory_cost(cost, X, U), ref[f"{tag}_J"])
    for got, k in zip(solver.quadratize_trajectory(cost, X, U),
                      ("lx", "lu", "lxx", "luu", "lux", "lfx", "lfxx")):
        close(torch.broadcast_to(got, ref[f"{tag}_{k}"].shape),
              ref[f"{tag}_{k}"])


def test_path_g_hybrid(ref, models):
    """Path G cut to size: the quaternion humanoid's hybrid (2 MPPI
    iterations of 8 samples at sigma 0.3 on rbdtpu's draws, then 2 DDP
    iterations of 4 line-search steps), plain route: controls to 1e-6, J
    and both histories to 1e-9 relative."""
    m = models["hum"]
    cost = _cost(m, "track", ref["goal"])
    state, (mh, dh) = solver.hybrid_solve(
        m, cost, T(ref["g_x0"]), T(ref["g_U0"]), None,
        solver.MPPIConfig(n_samples=8, sigma=0.3, dt=DT),
        solver.DDPConfig(iters=2, dt=DT, n_alphas=4), mppi_iters=2,
        noise=T(ref["g_noise"]))
    close(state.U, ref["g_U"], 1e-6)
    for got, k in ((state.J, "g_J"), (mh, "g_mppi"), (dh, "g_ddp")):
        np.testing.assert_allclose(got.numpy(), ref[k], rtol=1e-9, atol=0)


def test_path_h_hand_reaching(ref, models):
    """Path H cut to size: the quaternion humanoid reaching with its left
    wrist, 2 DDP iterations of 4 line-search steps, plain route."""
    m = models["hum"]
    state, hist = solver.ddp_solve(
        m, _cost(m, "ee", None), T(ref["h_x0"]), T(ref["h_U0"]),
        solver.DDPConfig(iters=2, dt=DT, n_alphas=4))
    close(state.U, ref["h_U"], 1e-6)
    np.testing.assert_allclose(state.J.numpy(), ref["h_J"], rtol=1e-9, atol=0)
    np.testing.assert_allclose(hist.numpy(), ref["h_hist"], rtol=1e-9, atol=0)


def test_backward_route_takes_the_tangent_width(models):
    """The backward pass is routed by the tangent's width (2 nv = 72 on the
    humanoid, one less than nx = 73), as rbdtpu routes it
    (solver/ddp.py:535): the chunked sweep on the card from 24 up, the
    lane-scalar sweep only at 16 and below."""
    from rbdtpu_torch.solver.ddp import _backward_route

    m = models["hum"]
    assert (m.nx, m.ntan) == (73, 72)
    cfg = solver.DDPConfig
    assert _backward_route(m, cfg(), True) == "chunked"
    assert _backward_route(m, cfg(), False) == "plain"
    assert _backward_route(m, cfg(fused_riccati=True), False) == "chunked"
