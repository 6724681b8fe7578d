"""The port's DDP at the north-star control-parity config
(tests/test_control_parity.py:34-66: arm7, quadratic tracking, H=100, 10
iterations, ``rollout_route="minv"``, gravity-compensation warm start,
3 problems, float64 on the CPU) against rbdtpu's solves of the same numpy
draws, recorded in tests/data/control_parity_refs.npz by
tests/make_control_parity_fixture.py; held to that test's own bounds,
max |u - u_ref| < 1e-6 and relative |dJ| < 1e-9.  The intermediate J
history is not held: the open-loop warm start amplifies rounding over
H=100, and on problem 0 a 1e-14 change of x0 moves the port's own second
iterate's J by 7e-5 relative, while the converged controls still agree
with rbdtpu's to 8.8e-7.  The config's route runs here; the kernel route
(``fused=True``: the plain versions of the step and line-search kernels,
ABA steps) is the ``slow`` case."""
import numpy as np
import pytest
import torch

from make_control_parity_fixture import (
    DT, ITERS, N_ALPHAS, N_PROBLEMS, PATH,
)
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import DDPConfig, ddp_solve, quadratic_tracking_cost


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
    return load_asset("arm7", device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def recorded():
    with np.load(PATH) as f:
        return dict(f)


def _solve_and_hold(tm, rec, p, **route):
    cfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS,
                    parallel_riccati=False, **route)
    cost = quadratic_tracking_cost(tm, torch.tensor(rec["goal"][p]))
    state, J_hist = ddp_solve(tm, cost, torch.tensor(rec["x0"][p]),
                              torch.tensor(rec["U0"][p]), cfg)
    err = np.abs(state.U.numpy() - rec["U"][p]).max()
    assert err < 1e-6, f"problem {p}: max |u - u_ref| = {err:.3e}"
    J_ref = float(rec["J"][p])
    assert abs(float(state.J) - J_ref) / max(1.0, abs(J_ref)) < 1e-9
    assert J_hist[-1] <= J_hist[0]


@pytest.mark.parametrize("p", range(N_PROBLEMS))
def test_minv_route_matches_recorded_rbdtpu(tm, recorded, p):
    _solve_and_hold(tm, recorded, p, rollout_route="minv")


@pytest.mark.slow
@pytest.mark.parametrize("p", range(N_PROBLEMS))
def test_kernel_route_matches_recorded_rbdtpu(tm, recorded, p):
    _solve_and_hold(tm, recorded, p, fused=True)
