"""The port's backward-pass strategies and its receding-horizon MPC loop
against rbdtpu's, float64 on the CPU, on the references recorded in
tests/data/arm7_solver_refs.npz by tests/make_arm7_fixture.py (the
``slow`` test re-runs rbdtpu live, about ten minutes, and holds the
recording to it):

- ``kernels.backward_pass_fused`` (K11; its plain version on CPU tensors)
  against rbdtpu's lane-scalar Pallas kernel in interpret mode, at rtol
  1e-9 / atol 1e-11 (tests/test_kernels.py's tolerances), NaN gains and ok
  identical on a problem whose Quu is not positive definite;
- ``backward_pass_parallel`` against rbdtpu's at 1e-9 relative to each
  output's scale, and both against the exact sequential reference of
  tests/test_parallel_riccati.py at its 1e-6;
- ``ddp_solve`` on each new route, ``mpc_run`` on the sequential and
  parallel sweeps: 1e-6 on the controls and 1e-9 relative on J
  (tests/test_control_parity.py's tolerances);
- the batched ``mpc_step`` against one call per problem, and solver-state
  checkpoints written by one package and read by the other."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_arm7_fixture import (
    DDP, DDPF, K11_NON_PD, MPC_CFG, MPC_TICKS, PATH, RICCATI_ARGS, TARGET,
    WEIGHTS, reference,
)
from rbdtpu.solver import DDPState as JState
from rbdtpu.solver import load_solver_state as j_load
from rbdtpu.solver import save_solver_state as j_save
from rbdtpu_torch.kernels import backward_pass_fused, launches, reset_launches
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import (
    DDPConfig, DDPState, MPCCarry, backward_pass_parallel, ddp_solve,
    ee_reaching_cost, load_solver_state, mpc_run, mpc_step,
    save_solver_state,
)
from test_parallel_riccati import _sequential_exact


@pytest.fixture(scope="module")
def tm():
    return load_asset("arm7", device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def rec():
    with np.load(PATH) as f:
        return dict(f)


def _args(rec, prefix):
    return tuple(torch.tensor(rec[prefix + n]) for n in RICCATI_ARGS)


def _close(out, ref, tol=1e-9):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("prefix", ["k11_knot_", "k11_const_"],
                         ids=["per-knot-non-pd", "constant"])
def test_fused_sweep_matches_rbdtpu_kernel(rec, prefix):
    """On CPU tensors the K11 wrapper runs the plain sweep and launches
    nothing."""
    reset_launches()
    out = backward_pass_fused(*_args(rec, prefix))
    assert launches["riccati_fused"] == 0
    k, K, dV, ok = (o.numpy() for o in out)
    assert ok.tolist() == rec[prefix + "ok"].tolist()
    for a, name in ((k, "k"), (K, "K"), (dV, "dV1")):
        b = rec[prefix + name]
        assert np.array_equal(np.isnan(a), np.isnan(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=1e-11)
    if prefix == "k11_knot_":  # NaN gains from the non-PD knot back
        bad, knot = K11_NON_PD
        assert ok.sum() == len(ok) - 1 and not ok[bad]
        assert np.isnan(k[bad, :knot + 1]).all()
        assert np.isfinite(k[bad, knot + 1:]).all()


def test_fused_sweep_refuses_large_state():
    """nx > 16 is the chunked sweep's regime, on either device."""
    z = lambda *s: torch.zeros(s, dtype=torch.float64)
    nx, nu = 24, 12
    with pytest.raises(ValueError, match="backward_pass_chunked"):
        backward_pass_fused(z(1, 2, nx, nx), z(1, 2, nx, nu), z(1, 2, nx),
                            z(1, 2, nu), z(nx, nx), z(nu, nu), z(nu, nx),
                            z(1, nx), z(1, nx, nx), z(1))


@pytest.mark.parametrize("prefix", ["par1_", "par3_"],
                         ids=["single", "batched"])
def test_parallel_sweep_matches_rbdtpu(rec, prefix):
    out = backward_pass_parallel(*_args(rec, prefix))
    assert out[3].numpy().tolist() == rec[prefix + "ok"].tolist()
    assert out[3].all()
    for o, name in zip(out[:3], ("k", "K", "dV1")):
        _close(o, rec[prefix + name])


def test_parallel_sweep_solves_the_exact_lqr(rec):
    """Both packages' scans against the exactly regularised sequential
    recursion (tests/test_parallel_riccati.py), per problem."""
    args = [rec["par3_" + n] for n in RICCATI_ARGS]
    k, K, _, _ = backward_pass_parallel(*(torch.tensor(a) for a in args))
    for b in range(k.shape[0]):
        k_ref, K_ref = _sequential_exact(*(a[b] for a in args[:9]),
                                         args[9][b])
        for out in (k[b].numpy(), rec["par3_k"][b]):
            np.testing.assert_allclose(out, k_ref, rtol=1e-6, atol=1e-8)
        for out in (K[b].numpy(), rec["par3_K"][b]):
            np.testing.assert_allclose(out, K_ref, rtol=1e-6, atol=1e-8)


def _hold_solve(state, J_hist, rec, prefix):
    assert np.abs(state.U.numpy() - rec[prefix + "U"]).max() < 1e-6
    np.testing.assert_allclose(J_hist.numpy(), rec[prefix + "J_hist"],
                               rtol=1e-9)
    np.testing.assert_allclose(state.J.numpy(), rec[prefix + "J"], rtol=1e-9)


def test_ddp_fused_riccati_matches_rbdtpu(tm, rec):
    cost = ee_reaching_cost(tm, DDPF["target"])
    cfg = DDPConfig(fused=True, fused_riccati=True, **DDPF["cfg"])
    _hold_solve(*ddp_solve(tm, cost, torch.tensor(rec["ddpf_x0"]),
                           torch.tensor(rec["ddpf_U0"]), cfg), rec, "ddpf_")


def test_ddp_parallel_riccati_matches_rbdtpu(tm, rec):
    cost = ee_reaching_cost(tm, TARGET, **WEIGHTS)
    cfg = DDPConfig(fused=True, parallel_riccati=True, **DDP["cfg"])
    state, J_hist = ddp_solve(tm, cost, torch.tensor(rec["ddp_x0"]),
                              torch.tensor(rec["ddp_U0"]), cfg)
    _hold_solve(state, J_hist, rec, "ddp_parallel_")
    assert (J_hist[-1] < J_hist[0]).all()


def _mpc(tm, x0, U0, **kw):
    cost = ee_reaching_cost(tm, TARGET, **WEIGHTS)
    return mpc_run(tm, cost, torch.tensor(x0), torch.tensor(U0), MPC_TICKS,
                   DDPConfig(fused=True, **MPC_CFG, **kw))


@pytest.mark.parametrize("route,recorded", [
    ("plain", "plain"), ("fused_riccati", "plain"),
    ("parallel_riccati", "parallel")])
def test_mpc_run_matches_rbdtpu(tm, rec, route, recorded):
    """The lane-scalar route is rbdtpu's sequential sweep; the parallel
    scan solves the exactly regularised subproblem, so it has its own
    recording."""
    kw = {} if route == "plain" else {route: True}
    carry, (U_app, J_hist) = _mpc(tm, rec["mpc_x0"], rec["mpc_U0"], **kw)
    p = f"mpc_{recorded}_"
    assert U_app.shape == (MPC_TICKS, tm.nv)
    assert np.abs(U_app.numpy() - rec[p + "U_applied"]).max() < 1e-6
    np.testing.assert_allclose(J_hist.numpy(), rec[p + "J_hist"], rtol=1e-9)
    np.testing.assert_allclose(carry.x.numpy(), rec[p + "x"], rtol=0,
                               atol=1e-8)
    assert np.abs(carry.U.numpy() - rec[p + "U"]).max() < 1e-6


def test_batched_mpc_step_matches_per_problem(tm):
    """The port's mpc_step is batched over the carry's leading dims (the
    form of rbdtpu's vmap): each problem's tick is its own call's, up to
    the rounding of batched against single products (1e-9 relative to
    each output's scale, the repository's dynamics tolerance)."""
    rng = np.random.default_rng(7)
    q0 = torch.tensor(0.3 * rng.standard_normal((2, tm.nq)))
    x0 = torch.cat([q0, torch.zeros_like(q0)], -1)
    U0 = torch.tensor(rng.standard_normal((2, 5, tm.nv)))
    cost = ee_reaching_cost(tm, TARGET, **WEIGHTS)
    cfg = DDPConfig(iters=2, n_alphas=4, fused=True)
    carry, (u, J) = mpc_step(tm, cost, MPCCarry(x0, U0), cfg)
    assert carry.x.shape == x0.shape and carry.U.shape == U0.shape
    for b in range(2):
        cb, (ub, Jb) = mpc_step(tm, cost, MPCCarry(x0[b], U0[b]), cfg)
        for a, r in ((u[b], ub), (J[b], Jb), (carry.x[b], cb.x),
                     (carry.U[b], cb.U)):
            _close(a, r.numpy())


def _state(rng):
    X, U = rng.standard_normal((2, 4, 3)), rng.standard_normal((2, 3, 2))
    J, reg, dJ = rng.standard_normal((3, 2))
    return X, U, J, reg, dJ


def test_checkpoint_written_here_is_read_by_rbdtpu(tmp_path):
    arrays = _state(np.random.default_rng(8))
    path = str(tmp_path / "port_state.npz")
    save_solver_state(path, DDPState(*(torch.tensor(a) for a in arrays)))
    like = JState(*(jnp.zeros(1) for _ in arrays))
    for a, b in zip(j_load(path, like), arrays):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = load_solver_state(path, DDPState(*(torch.zeros(1)
                                              for _ in arrays)))
    assert isinstance(back, DDPState)
    for a, b in zip(back, arrays):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), b)


def test_checkpoint_written_by_rbdtpu_is_read_here(tmp_path):
    arrays = _state(np.random.default_rng(9))
    path = str(tmp_path / "rbdtpu_state.npz")
    j_save(path, JState(*(jnp.asarray(a) for a in arrays)))
    state = load_solver_state(path, DDPState(*(torch.zeros(1)
                                               for _ in arrays)))
    for a, b in zip(state, arrays):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.slow
def test_recording_is_rbdtpus(rec):
    live = reference()
    assert sorted(live) == sorted(rec)
    for key, val in live.items():
        if key.endswith(("_ok",)) or np.asarray(val).dtype == bool:
            np.testing.assert_array_equal(rec[key], val)
        else:
            np.testing.assert_allclose(rec[key], val, rtol=1e-12,
                                       atol=1e-12, equal_nan=True)
