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
