"""The humanoid on the rpy root (humanoid30, 31 bodies, nx = 72), float64
on the CPU:

- ``hybrid_solve`` (BASELINE.json configs[4], cut to B=2, H=4, 2 MPPI
  iterations of 8 samples and 2 DDP iterations) against rbdtpu's solve of
  the same inputs and draws, recorded in tests/data/humanoid_rpy_refs.npz
  by tests/make_humanoid_fixture.py: controls to 1e-6, both J histories to
  1e-9 relative (tests/test_control_parity.py's tolerances), through the
  plain route and through the kernels' route (their plain versions here);
- ``ddp_solve(fused=True, fused_feedback=True)`` at the smallest batch
  where rbdtpu's rule sends the line search to K9 with two chunks (142
  problems x 4 step sizes), H=2, one iteration: the route taken, and the
  same solve on the K2 tier to 1e-9 (the two differ only in the order of
  the feedback sums).
The ``slow`` test re-runs rbdtpu live (about two minutes)."""
import numpy as np
import pytest
import torch

from make_humanoid_fixture import (
    DDP_ITERS, DT, MPPI_ITERS, N_ALPHAS, PATH, SAMPLES, SIGMA, WEIGHTS,
    reference,
)
from rbdtpu_torch.dynamics import rnea
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import (
    DDPConfig, MPPIConfig, ddp, ddp_solve, hybrid_solve,
    quadratic_tracking_cost,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These solves are loops of small batched tensor ops: one thread runs
    them as fast as eight and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tm():
    return load_asset("humanoid30", device="cpu", dtype=torch.float64,
                      floating_base=True)


@pytest.fixture(scope="module")
def recorded():
    with np.load(PATH) as f:
        return dict(f)


def _cost(tm, goal):
    return quadratic_tracking_cost(tm, torch.as_tensor(goal), **WEIGHTS)


def solve(tm, ref, kernels: bool, f_ext=None):
    g = lambda k: torch.tensor(ref[k])
    return hybrid_solve(
        tm, _cost(tm, ref["goal"]), g("x0"), g("U0"), None,
        MPPIConfig(n_samples=SAMPLES, sigma=SIGMA, dt=DT, fused=kernels),
        DDPConfig(iters=DDP_ITERS, dt=DT, n_alphas=N_ALPHAS, fused=kernels),
        mppi_iters=MPPI_ITERS, f_ext=f_ext, noise=g("noise"))


def _hold(out, ref):
    state, (mppi_hist, ddp_hist) = out
    assert np.abs(state.U.numpy() - ref["U"]).max() < 1e-6
    np.testing.assert_allclose(mppi_hist.numpy(), ref["mppi_hist"],
                               rtol=1e-9)
    np.testing.assert_allclose(ddp_hist.numpy(), ref["ddp_hist"], rtol=1e-9)
    np.testing.assert_allclose(state.J.numpy(), ref["J"], rtol=1e-9)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_hybrid_matches_recorded_rbdtpu(tm, recorded, kernels):
    out = solve(tm, recorded, kernels)
    _hold(out, recorded)
    assert (out[1][1][-1] < out[1][0][0]).all()


def test_hybrid_refuses_wrenches(tm, recorded):
    """``hybrid_solve`` takes world wrenches in both stages (rbdtpu's
    ``f_ext``) and refuses a set that is neither (nb, 6) nor (H, nb, 6);
    an all-zero set gives rbdtpu's wrench-free solve.  Its wrenches are
    held against rbdtpu in tests/test_torch_mppi.py."""
    H = recorded["U0"].shape[-2]
    for shape in ((tm.nb, 3), (H + 1, tm.nb, 6), (tm.nb - 1, 6)):
        with pytest.raises(ValueError, match="f_ext"):
            solve(tm, recorded, False,
                  f_ext=torch.zeros(shape, dtype=torch.float64))
    _hold(solve(tm, recorded, False,
                f_ext=torch.zeros(tm.nb, 6, dtype=torch.float64)), recorded)


def test_k9_tier_matches_k2_tier(tm, monkeypatch):
    """142 problems x 4 step sizes = 568 trajectories: rbdtpu's budget
    refuses the unchunked kernel and picks two chunks; the solve through
    that tier (K9's plain route here) equals the K2 tier's."""
    Bm, H = 142, 2
    rng = np.random.default_rng(4)
    q0 = np.zeros((Bm, tm.nq))
    q0[:, 2] = 0.9
    q0 = torch.tensor(q0 + 0.02 * rng.standard_normal(q0.shape))
    z = torch.zeros_like(q0)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(tm, q0, z, z)[0][:, None].expand(Bm, H, tm.nv).contiguous()
    goal = np.zeros(tm.nx)
    goal[2] = 0.95
    cost = _cost(tm, goal)
    cfg = dict(iters=1, dt=DT, n_alphas=N_ALPHAS, fused=True)
    assert ddp._feedback_route(tm, DDPConfig(fused_feedback=True, **cfg),
                               Bm * N_ALPHAS) == ("chunked", 2)
    seen = []
    k9 = ddp.feedback_rollout_fused_chunked
    monkeypatch.setattr(ddp, "feedback_rollout_fused_chunked",
                        lambda *a, **kw: (seen.append(kw["nchunks"]),
                                          k9(*a, **kw))[1])
    a, ha = ddp_solve(tm, cost, x0, U0, DDPConfig(fused_feedback=True, **cfg))
    assert seen == [2]
    b, hb = ddp_solve(tm, cost, x0, U0, DDPConfig(fused_feedback=None, **cfg))
    assert seen == [2]
    assert (a.U - b.U).abs().max().item() < 1e-9
    np.testing.assert_allclose(ha.numpy(), hb.numpy(), rtol=1e-9)
    assert torch.isfinite(a.U).all() and torch.isfinite(ha).all()


@pytest.mark.slow
def test_recording_is_rbdtpus_hybrid(tm, recorded):
    live = reference()
    for k in ("x0", "U0", "goal", "noise"):
        np.testing.assert_array_equal(recorded[k], live[k])
    _hold(solve(tm, live, kernels=True), live)
    np.testing.assert_allclose(recorded["U"], live["U"], rtol=0, atol=1e-12)
