"""The port's MPPI (``solver.mppi_step``, ``mppi_solve``) against rbdtpu's,
float64 on the CPU, fed the standard normals rbdtpu drew through ``noise``:
the cases and rbdtpu's results are recorded in tests/data/mppi_refs.npz by
tests/make_mppi_fixture.py (arm7 and quadruped12's rpy root; the nominal
sample, ``u_limits``, each branch of the acceptance guard, and
``sampling_dtype="float32"``).  Tolerances: 1e-9 on the controls and 1e-9
relative on the accepted costs; with float32 sample rollouts 1e-5 (both
packages round those rollouts to float32 in a different order, which moves
the softmin weights at about 1e-7 relative).  The ``slow`` test re-runs
rbdtpu live (about a minute and a half)."""
import numpy as np
import pytest
import torch

from make_mppi_fixture import ARM_W, CASES, PATH, QUAD_W, reference
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import (
    MPPIConfig, mppi_solve, mppi_step, quadratic_tracking_cost,
)

TOL64, TOL32 = 1e-9, 1e-5


@pytest.fixture(scope="module")
def models():
    return {"arm7": load_asset("arm7", device="cpu", dtype=torch.float64),
            "quadruped12": load_asset("quadruped12", device="cpu",
                                      dtype=torch.float64,
                                      floating_base=True)}


@pytest.fixture(scope="module")
def recorded():
    with np.load(PATH) as f:
        return dict(f)


def run(models, rec, case):
    """The port's result of a recorded case: (U, J, config, inputs)."""
    name, _, fields, iters, _ = CASES[case]
    g = {k: torch.tensor(rec[f"{case}/{k}"])
         for k in ("x0", "U0", "goal", "noise")}
    m = models[name]
    cost = quadratic_tracking_cost(m, g["goal"],
                                   **(ARM_W if name == "arm7" else QUAD_W))
    cfg = MPPIConfig(**fields)
    if iters is None:
        U, J = mppi_step(m, cost, g["x0"], g["U0"], None, cfg,
                         noise=g["noise"][0])
    else:
        U, J = mppi_solve(m, cost, g["x0"], g["U0"], None, iters, cfg,
                          noise=g["noise"])
    return U, J, cfg, g


def _hold(U, J, ref_U, ref_J, tol):
    scale = max(1.0, np.abs(ref_U).max())
    assert np.abs(U.numpy() - ref_U).max() <= tol * scale
    np.testing.assert_allclose(J.numpy(), ref_J, rtol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_mppi_matches_recorded_rbdtpu(models, recorded, case):
    U, J, cfg, _ = run(models, recorded, case)
    tol = TOL32 if cfg.sampling_dtype else TOL64
    _hold(U, J, recorded[f"{case}/U"], recorded[f"{case}/J"], tol)
    assert torch.isfinite(U).all() and torch.isfinite(J).all()


def _branches(U, cfg, g, lim):
    """Which candidate the guard kept for each problem: "nominal" (U
    itself), "best" (one of the samples) or "update" (the weighted
    update)."""
    U0 = g["U0"]
    eps = cfg.sigma * g["noise"][0].clone()
    eps[:, 0] = 0.0
    samples = U0[:, None] + eps
    if cfg.u_limits:
        samples = torch.clamp(samples, -lim, lim)
    out = []
    for b in range(U.shape[0]):
        if torch.equal(U[b], U0[b]):
            out.append("nominal")
        elif any(torch.equal(U[b], s) for s in samples[b]):
            out.append("best")
        else:
            out.append("update")
    return out


def test_every_branch_of_the_guard_wins(models, recorded):
    """The recorded cases make each candidate win somewhere: the weighted
    update and the best sample, and with ``sampling_dtype`` and a nominal
    plan beyond the effort box the nominal itself (only the guard's third
    branch returns a plan outside the box)."""
    lim = models["arm7"].u_limit_vector()
    seen = {}
    for case in ("arm7_update", "quad_update", "arm7_nominal"):
        U, _, cfg, g = run(models, recorded, case)
        seen[case] = _branches(U, cfg, g, lim)
    assert {"update", "best", "nominal"} <= set(seen["arm7_update"])
    assert "update" in seen["quad_update"]
    kept = [b for b, w in enumerate(seen["arm7_nominal"]) if w == "nominal"]
    assert kept and all((g["U0"][b].abs() > lim).any() for b in kept)


def test_nominal_sample_ignores_its_draw(models, recorded):
    """Sample 0 is the unperturbed nominal whatever its draw."""
    U, J, cfg, g = run(models, recorded, "arm7_update")
    noise = g["noise"][0].clone()
    noise[:, 0] = 1e6
    m = models["arm7"]
    cost = quadratic_tracking_cost(m, g["goal"], **ARM_W)
    U2, J2 = mppi_step(m, cost, g["x0"], g["U0"], None, cfg, noise=noise)
    assert torch.equal(U, U2) and torch.equal(J, J2)


def test_hybrid_solve_fext_matches_recorded_rbdtpu(models):
    """``hybrid_solve(f_ext)`` on arm7 under a per-knot wrench set (both
    stages' rollouts disturbed), fed the standard normals rbdtpu's MPPI
    drew (recorded in tests/data/push_refs.npz by
    tests/make_push_fixture.py): U within 1e-6, J and both J histories
    within 1e-9 relative of rbdtpu's."""
    import make_push_fixture as mp
    from rbdtpu_torch.solver import DDPConfig, hybrid_solve

    with np.load(mp.PATH) as f:
        ref = {k: torch.tensor(f[k]) for k in f if k.startswith("hy_")}
    m = models["arm7"]
    cost = quadratic_tracking_cost(m, ref["hy_goal"], **mp.ARM_W)
    state, (mh, dh) = hybrid_solve(
        m, cost, ref["hy_x0"], ref["hy_U0"], None,
        MPPIConfig(n_samples=mp.SAMPLES, sigma=mp.SIGMA, dt=mp.DT),
        DDPConfig(iters=mp.DDP_ITERS, dt=mp.DT, n_alphas=mp.ARM_ALPHAS),
        mppi_iters=mp.MPPI_ITERS, f_ext=ref["hy_F"], noise=ref["hy_noise"])
    assert (state.U - ref["hy_U"]).abs().max().item() < 1e-6
    for out, key in ((state.J, "hy_J"), (mh, "hy_mppi_hist"),
                     (dh, "hy_ddp_hist")):
        np.testing.assert_allclose(out.numpy(), ref[key].numpy(), rtol=1e-9)


def test_generator_draws_and_their_checks(models):
    """With a generator the draws are torch's: the same seed gives the
    same update; without a generator or noise, or with noise of the wrong
    shape, the step refuses."""
    m = models["arm7"]
    x0 = torch.zeros(2, m.nx, dtype=torch.float64)
    U0 = torch.zeros(2, 3, m.nv, dtype=torch.float64)
    cost = quadratic_tracking_cost(m, torch.zeros(m.nx, dtype=torch.float64))
    cfg = MPPIConfig(n_samples=4, sigma=0.1)
    a = mppi_step(m, cost, x0, U0, torch.Generator().manual_seed(1), cfg)
    b = mppi_step(m, cost, x0, U0, torch.Generator().manual_seed(1), cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        mppi_step(m, cost, x0, U0, None, cfg)
    with pytest.raises(ValueError):
        mppi_step(m, cost, x0, U0, None, cfg,
                  noise=torch.zeros(2, 5, 3, m.nv, dtype=torch.float64))


@pytest.mark.slow
def test_recording_is_rbdtpus_mppi(models, recorded):
    live = reference()
    for k, v in live.items():
        np.testing.assert_allclose(recorded[k], v, rtol=1e-12, atol=1e-12)
