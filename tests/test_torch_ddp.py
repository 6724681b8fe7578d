"""The port's solver against rbdtpu's: costs, the Riccati backward pass and
the arm7 end-effector DDP solve, float64 on the CPU.  Tolerances: 1e-6 on
the controls and 1e-9 relative on J (tests/test_control_parity.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbdtpu import solver as js
from rbdtpu_torch import solver as ts
from rbdtpu_torch.model import load_asset

TARGET = (0.3, 0.2, 0.8)
WEIGHTS = dict(w_ee=10.0, w_ee_f=2000.0, w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)


@pytest.fixture(scope="module")
def tm():
    return load_asset("arm7", device="cpu", dtype=torch.float64)


def test_ddp_solve_matches_rbdtpu(tm):
    """fused=True on CPU tensors runs the kernels' plain versions; rbdtpu
    solved with its jnp path (B=2, H=8, 3 iterations), as recorded in
    tests/data/arm7_solver_refs.npz by tests/make_arm7_fixture.py (its
    live re-run is tests/test_torch_mpc.py's slow test)."""
    from make_arm7_fixture import DDP, PATH

    with np.load(PATH) as f:
        rec = dict(f)
    out, hist = ts.ddp_solve(
        tm, ts.ee_reaching_cost(tm, TARGET, **WEIGHTS),
        torch.tensor(rec["ddp_x0"]), torch.tensor(rec["ddp_U0"]),
        ts.DDPConfig(fused=True, **DDP["cfg"]))
    assert np.abs(out.U.numpy() - rec["ddp_plain_U"]).max() < 1e-6
    np.testing.assert_allclose(hist.numpy(), rec["ddp_plain_J_hist"],
                               rtol=1e-9)
    np.testing.assert_allclose(out.reg.numpy(), rec["ddp_plain_reg"])
    assert hist[-1].mean() < hist[0].mean()


@pytest.mark.parametrize("route,u_limits", [("aba", True), ("minv", False)])
def test_kernel_route_matches_plain_route(tm, rng, route, u_limits):
    """The fused solver path (kernel wrappers) and the un-fused one agree;
    with u_limits the clamp applies on both."""
    B, H = 2, 6
    q0 = torch.tensor(0.3 * rng.standard_normal((B, tm.nq)))
    x0 = torch.cat([q0, torch.zeros_like(q0)], -1)
    U0 = torch.tensor(rng.uniform(-40, 40, (B, H, tm.nv)))
    cost = ts.ee_reaching_cost(tm, TARGET, **WEIGHTS)
    kw = dict(iters=2, n_alphas=4, u_limits=u_limits, rollout_route=route)
    a = ts.ddp_solve(tm, cost, x0, U0, ts.DDPConfig(fused=True, **kw))[0]
    b = ts.ddp_solve(tm, cost, x0, U0, ts.DDPConfig(fused=False, **kw))[0]
    assert (a.U - b.U).abs().max() < 1e-6
    if u_limits:
        assert (a.U.abs() <= tm.u_limit_vector()).all()


def test_backward_pass_matches_rbdtpu(rng):
    """Riccati sweep, including a problem whose Quu is not positive
    definite: its factor is NaN and ok is False on both sides."""
    Bp, H, nx, nu = 2, 4, 4, 2
    A = np.eye(nx) + 0.1 * rng.standard_normal((Bp, H, nx, nx))
    Bm = 0.1 * rng.standard_normal((Bp, H, nx, nu))
    lx = rng.standard_normal((Bp, H, nx))
    lu = rng.standard_normal((Bp, H, nu))
    lxx = np.eye(nx)
    luu = np.broadcast_to(np.eye(nu), (Bp, H, nu, nu)).copy()
    luu[1, 2] = -5.0 * np.eye(nu)  # problem 1, knot 2: non-PD
    lux = 0.1 * rng.standard_normal((nu, nx))
    lfx = rng.standard_normal((Bp, nx))
    lfxx = np.broadcast_to(2.0 * np.eye(nx), (Bp, nx, nx)).copy()
    reg = np.full(Bp, 1e-6)
    args = (A, Bm, lx, lu, lxx, luu, lux, lfx, lfxx, reg)
    k_r, K_r, dV_r, ok_r = js.backward_pass(*(jnp.asarray(a) for a in args))
    k, K, dV, ok = ts.backward_pass(*(torch.tensor(a) for a in args))
    assert ok.tolist() == np.asarray(ok_r).tolist() == [True, False]
    np.testing.assert_allclose(k[0].numpy(), np.asarray(k_r)[0], atol=1e-12)
    np.testing.assert_allclose(K[0].numpy(), np.asarray(K_r)[0], atol=1e-12)
    np.testing.assert_allclose(dV[0].item(), float(dV_r[0]), rtol=1e-12)
    assert not torch.isfinite(K[1, 2]).any()


@pytest.fixture(scope="module")
def quadratized(arm7):
    """rbdtpu's quadratisation and cost of one random batch of trajectories
    (computed once; jitted)."""
    rng = np.random.default_rng(3)
    H = 3
    X = rng.uniform(-1, 1, (2, H + 1, arm7.nx))
    U = rng.uniform(-1, 1, (2, H, arm7.nv))
    cost = js.ee_reaching_cost(arm7, jnp.array(TARGET), fused=False, **WEIGHTS)
    ref = jax.jit(lambda X_, U_: (js.quadratize_trajectory(cost, X_, U_),
                                  js.trajectory_cost(cost, X_, U_)))(X, U)
    return X, U, ref


@pytest.mark.parametrize("fused", [True, False])
def test_ee_cost_quadratization_matches_rbdtpu(tm, quadratized, fused):
    """fused=True takes the ee_gn wrapper (its plain version on the CPU)."""
    X, U, (ref, ref_J) = quadratized
    cost = ts.ee_reaching_cost(tm, TARGET, fused=fused, **WEIGHTS)
    out = ts.quadratize_trajectory(cost, torch.tensor(X), torch.tensor(U))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(r).max()))
    np.testing.assert_allclose(
        ts.trajectory_cost(cost, torch.tensor(X), torch.tensor(U)).numpy(),
        np.asarray(ref_J), rtol=1e-12)


def test_tracking_cost_matches_rbdtpu(arm7, tm, rng):
    """The repository's control-parity cost (tests/test_control_parity.py)."""
    H = 3
    X = rng.uniform(-1, 1, (2, H + 1, tm.nx))
    U = rng.uniform(-1, 1, (2, H, tm.nv))
    goal = rng.uniform(-0.4, 0.4, tm.nx)
    ref_cost = js.quadratic_tracking_cost(arm7, jnp.asarray(goal))
    cost = ts.quadratic_tracking_cost(tm, goal)
    ref = js.quadratize_trajectory(ref_cost, jnp.asarray(X), jnp.asarray(U))
    out = ts.quadratize_trajectory(cost, torch.tensor(X), torch.tensor(U))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(
        ts.trajectory_cost(cost, torch.tensor(X), torch.tensor(U)).numpy(),
        np.asarray(js.trajectory_cost(ref_cost, X, U)), rtol=1e-12)


@pytest.mark.parametrize("field", ["exact_hessians"])
def test_unported_options_raise(tm, field):
    x0 = torch.zeros(1, tm.nx, dtype=torch.float64)
    U0 = torch.zeros(1, 2, tm.nv, dtype=torch.float64)
    cost = ts.ee_reaching_cost(tm, TARGET)
    with pytest.raises(NotImplementedError):
        ts.ddp_solve(tm, cost, x0, U0, ts.DDPConfig(**{field: True}))


@pytest.mark.parametrize("option,ran", [
    ({"fused_riccati": True}, ["backward_pass_fused", "backward_pass"]),
    ({"parallel_riccati": True}, ["backward_pass_parallel"]),
    ({"parallel_riccati": True, "fused_riccati": True},
     ["backward_pass_parallel"]),
    ({}, ["backward_pass"])])
def test_backward_route_on_cpu(tm, monkeypatch, option, ran):
    """On CPU tensors at nx = 14, the calls of each iteration:
    fused_riccati=True goes through the lane-scalar kernel's wrapper, which
    runs the plain sweep; parallel_riccati=True runs the scan, ahead of
    fused_riccati."""
    from rbdtpu_torch.kernels import launches, reset_launches
    from rbdtpu_torch.solver import ddp

    calls = []
    for name in ("backward_pass", "backward_pass_parallel",
                 "backward_pass_fused", "backward_pass_chunked"):
        fn = getattr(ddp, name)
        monkeypatch.setattr(ddp, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    x0 = torch.zeros(2, tm.nx, dtype=torch.float64)
    U0 = torch.zeros(2, 3, tm.nv, dtype=torch.float64)
    cost = ts.ee_reaching_cost(tm, TARGET, **WEIGHTS)
    reset_launches()
    state, _ = ts.ddp_solve(tm, cost, x0, U0, ts.DDPConfig(
        iters=2, n_alphas=3, fused=True, **option))
    assert calls == ran * 2
    assert not any(launches.values())
    assert torch.isfinite(state.U).all()
