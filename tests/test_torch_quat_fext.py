"""The port's quaternion root on the kernels its class "fq32" adds to K1-K4
(K9, K2 and K9 with wrenches, K6, K10) and under world wrenches, against
rbdtpu in float64 on the CPU: the plain versions of those kernels against
rbdtpu's Pallas kernels (run once each in interpret mode on the
quaternion quadruped), ``ddp_solve(f_ext)`` on the quaternion quadruped
and ``hybrid_solve(f_ext)`` on the quaternion humanoid (on rbdtpu's MPPI
normals) against rbdtpu's plain route, through the port's kernel route
(the kernels' plain versions on the CPU) and its plain route, and the
line search's K2/K9 budget rule against rbdtpu's on the quaternion
humanoid.  rbdtpu's results are recorded in tests/data/quat_fext_refs.npz
by tests/make_quat_fext_fixture.py, so this file runs no JAX computation.
Tolerances: 1e-9 for the kernels, 1e-6 for controls and 1e-9 relative for
J."""
import os

import numpy as np
import pytest
import torch

from rbdtpu_torch import solver
from rbdtpu_torch.kernels import fused
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import ddp

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "quat_fext_refs.npz")
DT, GRAVITY = 0.01, -9.81
W3 = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
WG = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)


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


def _line_search(ref):
    return tuple(T(ref[f"k_{k}"]) for k in ("x0", "Xn", "Un", "kf", "Kf"))


@pytest.mark.parametrize("nchunks", [2, 3])
def test_feedback_chunked_plain_matches_rbdtpus_kernel(ref, models, nchunks):
    """K9's plain version against rbdtpu's ``feedback_rollout_fused_chunked``
    (interpret mode): the chunks split the 2 nv tangent columns, the
    root's rows of dx are the quaternion log."""
    X, U = fused.feedback_rollout_chunked_plain(
        models["quad"], *_line_search(ref), DT, GRAVITY, nchunks=nchunks)
    close(X, ref[f"k9_{nchunks}_X"])
    close(U, ref[f"k9_{nchunks}_U"])


@pytest.mark.parametrize("kernel", ["k2", "k9"])
def test_feedback_fext_plain_matches_rbdtpus_kernel(ref, models, kernel):
    """K2's and K9's (two chunks) plain versions under a per-knot (H, nb,
    6) wrench set against rbdtpu's kernels given the same ``f_ext``."""
    args = (models["quad"], *_line_search(ref), DT, GRAVITY)
    F = T(ref["k_F"])
    if kernel == "k2":
        X, U = fused.feedback_rollout_plain(*args, f_ext=F)
    else:
        X, U = fused.feedback_rollout_chunked_plain(*args, nchunks=2, f_ext=F)
    close(X, ref[f"{kernel}_fext_X"])
    close(U, ref[f"{kernel}_fext_U"])


K6_CASES = {"fact": (False, None), "dense": (True, None),
            "fact_f1": (False, "k_F1"), "dense_fb": (True, "k_FB")}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_fd_step_minv_plain_matches_rbdtpus_kernel(ref, models, case):
    """K6's plain version (bias RNEA, M^-1, the manifold Euler step)
    against rbdtpu's ``fd_step_minv_fused`` on both routes, without
    wrenches, under one (nb, 6) set and under one set a state."""
    dense, fkey = K6_CASES[case]
    x = torch.cat([T(ref["k_q"]), T(ref["k_qd"])], -1)
    got = fused.fd_step_minv_plain(models["quad"], x, T(ref["k_u"]), DT,
                                   GRAVITY, dense_minv=dense,
                                   f_ext=None if fkey is None
                                   else T(ref[fkey]))
    close(got, ref[f"k6_{case}"])


@pytest.mark.parametrize("qdd", [False, True], ids=["bias", "qdd"])
def test_rnea_plain_matches_rbdtpus_kernel(ref, models, qdd):
    """K10's plain version (q one value wider) against rbdtpu's
    ``rnea_fused``, with and without qdd."""
    got = fused.rnea_plain(models["quad"], T(ref["k_q"]), T(ref["k_qd"]),
                           T(ref["k_qdd"]) if qdd else None, GRAVITY)
    close(got, ref[f"k10_{'qdd' if qdd else 'bias'}"], 1e-9 * max(
        1.0, np.abs(ref[f"k10_{'qdd' if qdd else 'bias'}"]).max()))


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_ddp_solve_under_push(ref, models, kernels):
    """``ddp_solve(f_ext)`` on the quaternion quadruped (B = 2, H = 8, 2
    iterations of 6 line-search steps, a 40 N trunk push) against rbdtpu's
    plain route: the kernel route (K1 and K2 with wrenches, here their
    plain versions) and the plain route both give its controls to 1e-6
    and its J history to 1e-9 relative."""
    m = models["quad"]
    state, hist = solver.ddp_solve(
        m, solver.quadratic_tracking_cost(m, T(ref["q_goal"]), **W3),
        T(ref["q_x0"]), T(ref["q_U0"]),
        solver.DDPConfig(iters=2, dt=DT, n_alphas=6, fused=kernels),
        f_ext=T(ref["q_F"]))
    close(state.U, ref["q_U"], 1e-6)
    np.testing.assert_allclose(state.J.numpy(), ref["q_J"], rtol=1e-9, atol=0)
    np.testing.assert_allclose(hist.numpy(), ref["q_hist"], rtol=1e-9, atol=0)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_hybrid_under_push(ref, models, kernels):
    """``hybrid_solve(f_ext)`` on the quaternion humanoid at the quaternion
    fixture's cut (2 MPPI iterations of 8 samples at sigma 0.3 on rbdtpu's
    draws, then 2 DDP iterations of 4 steps) under a 20 N trunk push:
    controls to 1e-6, J and both histories to 1e-9 relative, through the
    kernel route and the plain route."""
    m = models["hum"]
    state, (mh, dh) = solver.hybrid_solve(
        m, solver.quadratic_tracking_cost(m, T(ref["h_goal"]), **WG),
        T(ref["h_x0"]), T(ref["h_U0"]), None,
        solver.MPPIConfig(n_samples=8, sigma=0.3, dt=DT, fused=kernels),
        solver.DDPConfig(iters=2, dt=DT, n_alphas=4, fused=kernels),
        mppi_iters=2, f_ext=T(ref["h_F"]), noise=T(ref["h_noise"]))
    close(state.U, ref["h_U"], 1e-6)
    for got, k in ((state.J, "h_J"), (mh, "h_mppi"), (dh, "h_ddp")):
        np.testing.assert_allclose(got.numpy(), ref[k], rtol=1e-9, atol=0)


def test_budget_rule_matches_rbdtpu(ref, models):
    """The line search's K2/K9 budget halves on the quaternion humanoid
    (nx = 73) against rbdtpu's at 4 x {128, 135, 136, 142, 256}
    trajectories: K2 up to 128 problems, the plain pass at 135 (not a
    multiple of 8), K9 with one chunk at 136 and two from 142; path J's
    256 problems of four steps route to K9 with two chunks."""
    m = models["hum"]
    for bt, ok, chunks, chunked_ok in zip(
            ref["budget_batches"], ref["budget_fused_ok"],
            ref["budget_chunks"], ref["budget_chunked_ok"]):
        bt = int(bt)
        assert fused.feedback_fused_ok(m, bt) == bool(ok), bt
        assert (fused.feedback_chunks(m, bt) or 0) == int(chunks), bt
        assert (fused.feedback_chunks(m, bt) or 0) == int(chunked_ok), bt
    assert [int(c) for c in ref["budget_chunks"]] == [1, 0, 1, 2, 2]
    assert list(ref["budget_fused_ok"]) == [True, False, False, False, False]
    route = lambda B: ddp._feedback_route(
        m, solver.DDPConfig(fused=True, fused_feedback=True, n_alphas=4),
        4 * B)
    assert route(256) == ("chunked", 2)
    assert route(142) == ("chunked", 2) and route(141) == ("plain", None)
    assert route(136) == ("chunked", 1) and route(128) == ("fused", None)


def test_wrappers_route_cpu_tensors_to_plain(ref, models):
    """On CPU tensors the fq32 kernels' wrappers run their plain versions:
    K9 and K2/K9 with wrenches, K6 on both routes, K10."""
    m = models["quad"]
    args = (m, *_line_search(ref), DT, GRAVITY)
    F = T(ref["k_F"])
    for a, b in zip(fused.feedback_rollout_fused_chunked(*args, nchunks=3,
                                                         f_ext=F),
                    fused.feedback_rollout_chunked_plain(*args, nchunks=3,
                                                         f_ext=F)):
        assert torch.equal(a, b)
    x = torch.cat([T(ref["k_q"]), T(ref["k_qd"])], -1)
    for dense in (False, True):
        assert torch.equal(
            fused.fd_step_minv_fused(m, x, T(ref["k_u"]), DT, GRAVITY,
                                     dense_minv=dense),
            fused.fd_step_minv_plain(m, x, T(ref["k_u"]), DT, GRAVITY,
                                     dense_minv=dense))
    assert torch.equal(fused.rnea_fused(m, T(ref["k_q"]), T(ref["k_qd"])),
                       fused.rnea_plain(m, T(ref["k_q"]), T(ref["k_qd"])))
