"""The port's floating-base quadruped MPC solve (BASELINE.json configs[3],
cut to B=2, H=4, 2 iterations, float64 on the CPU) against rbdtpu's solve
of the same numpy inputs, recorded in tests/data/quadruped_rpy_ddp.npz by
tests/make_quadruped_fixture.py: 1e-6 on the controls and 1e-9 relative on
J (tests/test_control_parity.py's tolerances), and 1e-9 on the knot
Jacobians of linearize_trajectory.  The ``slow`` test re-runs rbdtpu live
(about a minute) and holds the port and the recording against it."""
import numpy as np
import pytest
import torch

from make_quadruped_fixture import (
    DT, ITERS, N_ALPHAS, PATH, WEIGHTS, reference,
)
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import (
    DDPConfig, ddp_solve, linearize_trajectory, quadratic_tracking_cost,
)


@pytest.fixture(scope="module")
def tm():
    return load_asset("quadruped12", device="cpu", dtype=torch.float64,
                      floating_base=True)


@pytest.fixture(scope="module")
def recorded():
    with np.load(PATH) as f:
        return dict(f)


def solve(tm, ref):
    """The port's solve of the recorded problem, on its plain route."""
    cost = quadratic_tracking_cost(tm, ref["goal"], **WEIGHTS)
    cfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS, fused=False)
    return ddp_solve(tm, cost, torch.tensor(ref["x0"]),
                     torch.tensor(ref["U0"]), cfg)


def _hold(state, J_hist, ref):
    assert np.abs(state.U.numpy() - ref["U"]).max() < 1e-6
    np.testing.assert_allclose(J_hist.numpy(), ref["J_hist"], rtol=1e-9)
    np.testing.assert_allclose(state.J.numpy(), ref["J"], rtol=1e-9)


def test_ddp_solve_matches_recorded_rbdtpu(tm, recorded):
    state, J_hist = solve(tm, recorded)
    _hold(state, J_hist, recorded)
    assert (J_hist[-1] < J_hist[0]).all()


def test_linearize_trajectory_matches_recorded_rbdtpu(tm, recorded):
    A, Bm = linearize_trajectory(tm, torch.tensor(recorded["X"]),
                                 torch.tensor(recorded["U"]), DT)
    for out, ref in ((A, recorded["A"]), (Bm, recorded["B"])):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max())


@pytest.mark.slow
def test_recording_is_rbdtpus_solve(tm, recorded):
    live = reference()
    for k in ("x0", "U0", "goal"):
        np.testing.assert_array_equal(recorded[k], live[k])
    _hold(*solve(tm, live), live)
    np.testing.assert_allclose(recorded["U"], live["U"], rtol=0, atol=1e-12)


# ---- foot reaching on the rpy root (path E), against rbdtpu recorded in
# tests/data/footreach_rpy_refs.npz by tests/make_footreach_fixture.py ----

@pytest.fixture(scope="module")
def foot():
    import make_footreach_fixture as mf

    with np.load(mf.PATH) as f:
        return mf, dict(f)


def _near(out, ref, tol=1e-9):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def test_ee_jacobian_rpy_matches_recorded_rbdtpu(tm, foot):
    """``ee_position_jacobian_tangent`` and ``ee_pose`` on the rpy
    quadruped at every leaf joint, at a foot's fixed frame and at a leaf
    with an EE offset: rbdtpu's at 1e-9."""
    from rbdtpu_torch.kinematics import ee_pose, ee_position_jacobian_tangent

    mf, ref = foot
    q = torch.tensor(ref["q"])
    leaf = tm.joint_names[tm.leaves()[0]]
    off = torch.tensor(mf.OFFSET)
    for tag, kw in (("leaves", {}), ("frame", {"ee_names": [mf.FRAME]}),
                    ("offset", {"ee_names": [leaf], "offset": off})):
        _near(ee_position_jacobian_tangent(tm, q, **kw), ref[f"jac_{tag}"])
        _near(ee_pose(tm, q, **kw), ref[f"pose_{tag}"])


def test_ee_gn_plain_rpy_matches_recorded_rbdtpu(tm, foot):
    """K4's plain version on the rpy quadruped against rbdtpu's Pallas
    ``ee_gn_fused`` (recorded in interpret mode) at 1e-9, and its gn=False
    error alone."""
    from rbdtpu_torch.kernels import ee_gn_plain

    mf, ref = foot
    q = torch.tensor(ref["q"])
    names = [tm.joint_names[tm.leaves()[0]]]
    for out, key in zip(ee_gn_plain(tm, q, mf.TARGET, ee_names=names),
                        ("gn_e", "gn_g0", "gn_H0")):
        _near(out, ref[key])
    e, g0, H0 = ee_gn_plain(tm, q, mf.TARGET, ee_names=names, gn=False)
    assert g0 is None and H0 is None
    _near(e, ref["gn_e"])


def test_ee_reaching_cost_rpy_matches_recorded_rbdtpu(tm, foot):
    """``ee_reaching_cost`` on the quadruped's foot (path E's weights):
    stage and terminal values, the trajectory cost and every block of
    ``quadratize_trajectory`` against rbdtpu's at 1e-9, through the plain
    version (fused=False) and the wrapper (fused=None on a CPU tensor)."""
    from rbdtpu_torch.solver import (
        ee_reaching_cost, quadratize_trajectory, trajectory_cost,
    )

    mf, ref = foot
    X, U = torch.tensor(ref["X"]), torch.tensor(ref["U"])
    names = [tm.joint_names[tm.leaves()[0]]]
    for fused in (False, None):
        cost = ee_reaching_cost(tm, mf.TARGET, ee_names=names, fused=fused,
                                **mf.WEIGHTS)
        _near(cost.stage(X[..., :-1, :], U, torch.arange(mf.H)),
              ref["stage"])
        _near(cost.terminal(X[..., -1, :]), ref["terminal"])
        _near(trajectory_cost(cost, X, U), ref["J_traj"])
        for out, key in zip(quadratize_trajectory(cost, X, U),
                            ("lx", "lu", "lxx", "luu", "lux", "lfx",
                             "lfxx")):
            _near(out, ref[f"d_{key}"])


def test_footreach_solve_matches_recorded_rbdtpu(tm, foot):
    """Path E (bench.py:509-537) cut to B=2, H=4, 2 iterations, float64 on
    the plain route: U within 1e-6 and J (and its history) within 1e-9
    relative of rbdtpu's, and J falls."""
    from rbdtpu_torch.solver import ee_reaching_cost

    mf, ref = foot
    cost = ee_reaching_cost(tm, mf.TARGET,
                            ee_names=[tm.joint_names[tm.leaves()[0]]],
                            **mf.WEIGHTS)
    cfg = DDPConfig(iters=mf.ITERS, dt=mf.DT, n_alphas=mf.N_ALPHAS)
    state, J_hist = ddp_solve(tm, cost, torch.tensor(ref["x0"]),
                              torch.tensor(ref["U0"]), cfg)
    assert np.abs(state.U.numpy() - ref["solve_U"]).max() < 1e-6
    np.testing.assert_allclose(J_hist.numpy(), ref["solve_J_hist"],
                               rtol=1e-9)
    np.testing.assert_allclose(state.J.numpy(), ref["solve_J"], rtol=1e-9)
    assert (J_hist[-1] < J_hist[0]).all()


# ---- disturbance wrenches (f_ext), against rbdtpu recorded in
# tests/data/push_refs.npz by tests/make_push_fixture.py ----

@pytest.fixture(scope="module")
def push():
    import make_push_fixture as mp

    with np.load(mp.PATH) as f:
        return mp, dict(f)


def test_feedback_rollouts_with_fext_match_recorded_rbdtpu(tm, push):
    """rbdtpu's ``forward_pass(f_ext)`` (the line search of its K2 and K9)
    on the rpy quadruped under a per-knot wrench set, against the port's
    ``forward_pass(f_ext)`` and the plain versions of K2 and K9
    (``feedback_rollout_plain``, ``feedback_rollout_chunked_plain`` at 1, 2
    and 3 chunks) fed the flattened ladder as ``forward_pass_fused`` feeds
    the kernels: states, controls and costs at 1e-9."""
    from rbdtpu_torch.kernels import fused
    from rbdtpu_torch.solver import forward_pass, trajectory_cost

    mp, ref = push
    T = torch.tensor
    X, U, k, K = (T(ref[f"fp_{n}"]) if n != "U" else T(ref["U0"])
                  for n in ("X", "U", "k", "K"))
    al, F = T(ref["fp_alphas"]), T(ref["F_knot"])
    cost = quadratic_tracking_cost(tm, ref["goal"], **mp.W3)
    Xs, Us, Js = forward_pass(tm, cost, X, U, k, K, al, mp.DT, -9.81,
                              f_ext=F)
    for out, key in ((Xs, "fp_Xs"), (Us, "fp_Us"), (Js, "fp_Js")):
        _near(out, ref[key])
    n_al, B = al.shape[0], X.shape[0]
    flat = lambda a: a.expand((n_al,) + a.shape).reshape(
        (-1,) + a.shape[1:]).contiguous()
    Xf = flat(X)
    args = (Xf[:, 0].contiguous(), Xf[:, :-1].contiguous(), flat(U),
            (al[:, None, None, None] * k).reshape(-1, *k.shape[1:]),
            flat(K), mp.DT)
    runs = [fused.feedback_rollout_plain(tm, *args, f_ext=F)]
    runs += [fused.feedback_rollout_chunked_plain(tm, *args, nchunks=c,
                                                  f_ext=F) for c in (1, 2, 3)]
    for X_tail, U_new in runs:
        Xn = torch.cat([Xf[:, :1], X_tail], 1).reshape(ref["fp_Xs"].shape)
        _near(Xn, ref["fp_Xs"])
        _near(U_new.reshape(ref["fp_Us"].shape), ref["fp_Us"])
        _near(trajectory_cost(cost, Xn, U_new.reshape(Us.shape)),
              ref["fp_Js"])


@pytest.mark.parametrize("which", ["const", "knot"])
def test_ddp_solve_fext_matches_recorded_rbdtpu(tm, push, which):
    """``ddp_solve(f_ext)`` on configs[3]'s problem cut to B=2, H=6, 2
    iterations, float64 on the plain route, under a constant (nb, 6) set
    and a per-knot (H, nb, 6) set with a trunk push: U within 1e-6 and J
    within 1e-9 relative of rbdtpu's."""
    mp, ref = push
    cost = quadratic_tracking_cost(tm, ref["goal"], **mp.W3)
    cfg = DDPConfig(iters=mp.ITERS, dt=mp.DT, n_alphas=mp.N_ALPHAS)
    F = ref["F_const"] if which == "const" else ref["F_knot"]
    state, J_hist = ddp_solve(tm, cost, torch.tensor(ref["x0"]),
                              torch.tensor(ref["U0"]), cfg,
                              f_ext=torch.tensor(F))
    assert np.abs(state.U.numpy() - ref[f"solve_{which}_U"]).max() < 1e-6
    np.testing.assert_allclose(J_hist.numpy(), ref[f"solve_{which}_J_hist"],
                               rtol=1e-9)
    np.testing.assert_allclose(state.J.numpy(), ref[f"solve_{which}_J"],
                               rtol=1e-9)


def test_ddp_solve_fext_never_takes_a_wrench_free_pass(tm, push,
                                                       monkeypatch):
    """rbdtpu's routing guard (tests/test_fext.py:209-240) on the port:
    under ``f_ext`` every rollout carries the wrenches.  With fused=True on
    CPU tensors, every line-search call of the kernels' entry points (K2 on
    the default tier, K9 on the chunked tier) and every step of the initial
    rollout receives the knot's wrench set, and the wrench-free plain
    forward pass is never taken; the solve equals the plain route's."""
    from rbdtpu_torch.solver import ddp

    mp, ref = push
    cost = quadratic_tracking_cost(tm, ref["goal"], **mp.W3)
    x0, U0 = torch.tensor(ref["x0"]), torch.tensor(ref["U0"])
    F = torch.tensor(ref["F_knot"])
    calls = []

    def spy(name, fn):
        def call(*a, **kw):
            calls.append((name, kw.get("f_ext")))
            return fn(*a, **kw)
        return call

    for name in ("feedback_rollout_fused", "feedback_rollout_fused_chunked",
                 "fd_step_fused"):
        monkeypatch.setattr(ddp, name, spy(name, getattr(ddp, name)))
    monkeypatch.setattr(ddp, "forward_pass", spy(
        "forward_pass", ddp.forward_pass))
    cfg = dict(iters=mp.ITERS, dt=mp.DT, n_alphas=mp.N_ALPHAS)
    plain, _ = ddp_solve(tm, cost, x0, U0, DDPConfig(**cfg), f_ext=F)
    for tier, line in ((None, "feedback_rollout_fused"),
                       (True, "feedback_rollout_fused_chunked")):
        calls.clear()
        if tier:  # the chunked tier, as rbdtpu's budget picks it at scale
            monkeypatch.setattr(ddp, "_feedback_route",
                                lambda *a: ("chunked", 2))
        state, _ = ddp_solve(tm, cost, x0, U0, DDPConfig(
            fused=True, fused_feedback=tier, **cfg), f_ext=F)
        names = [n for n, _ in calls]
        assert names.count(line) == mp.ITERS
        assert names.count("fd_step_fused") == mp.H
        assert "forward_pass" not in names
        assert all(fe is not None for _, fe in calls)
        torch.testing.assert_close(state.U, plain.U, rtol=0, atol=1e-9)


def test_push_recovery_example_at_cpu_size():
    """The port's push-recovery example (rbdtpu's examples/push_recovery.py)
    cut to 2 problems, 20 knots and 3 iterations on the CPU: the plan made
    knowing the push beats the oblivious plan when both roll out under
    it."""
    from rbdtpu_torch.examples import push_recovery

    aware, oblivious = push_recovery.run("cpu", B=2, H=20, iters=3)
    assert np.isfinite(aware) and aware < oblivious


@pytest.mark.slow
def test_footreach_recording_is_rbdtpus(foot):
    """tests/data/footreach_rpy_refs.npz is what rbdtpu computes now (its
    inputs equal, every output within 1e-12)."""
    mf, ref = foot
    live = mf.reference()
    assert set(live) == set(ref)
    for k, v in live.items():
        np.testing.assert_allclose(ref[k], v, rtol=0, atol=1e-12)


@pytest.mark.slow
def test_push_recording_is_rbdtpus(push):
    """tests/data/push_refs.npz is what rbdtpu computes now."""
    mp, ref = push
    live = mp.reference()
    assert set(live) == set(ref)
    for k, v in live.items():
        np.testing.assert_allclose(ref[k], v, rtol=0, atol=1e-12)
