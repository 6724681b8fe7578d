"""Record rbdtpu's MPPI -> DDP hybrid on the humanoid's rpy root, the
reference that tests/test_torch_humanoid.py holds the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_humanoid_fixture.py

writes tests/data/humanoid_rpy_refs.npz (about two minutes, most of it
rbdtpu's compile at humanoid size).  The problem is BASELINE.json
configs[4]'s (bench.py:539-590: humanoid30 with the rpy floating root,
standing at q[2] = 0.9 with 0.02 N(0,1) on every coordinate, at rest,
tracking cost w_q=2, w_qd=0.05, w_u=1e-5 to a standing height of 0.95,
gravity compensation at every knot, MPPI sigma 0.3, 4 line-search steps)
cut to B=2 problems, H=4 knots, 2 MPPI iterations of 8 samples and 2 DDP
iterations, float64, with its start made from SEED by numpy.  rbdtpu
solves it on its plain jnp route (fused=False); the standard normals its
MPPI stage drew (``jax.random.normal`` of each iteration's key) are kept
beside the result, so the port can be fed the same draws.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_humanoid_fixture.py --witness

writes nothing: it runs rbdtpu's MPPI stage at configs[4]'s full shape
(16 problems, 32 knots, 4 iterations of 128 samples, plain route) in
float32 and float64, at configs[4]'s sigma and at WITNESS_SMALL_SIGMA, and
prints for each how many (iteration, problem) pairs replaced the nominal
plan (J fell), then feeds rbdtpu's float64 draws to the port's plain route
and prints how far its controls and J history are from rbdtpu's (about
five minutes, most of it rbdtpu's four compiles).  chip_smoke.py's phase 16
runs the same two sigmas on the card."""
import os
import sys

import numpy as np

SEED = 20261018
B, H, MPPI_ITERS, SAMPLES, DDP_ITERS, N_ALPHAS = 2, 4, 2, 8, 2, 4
DT, SIGMA, KEY = 0.01, 0.3, 3
WEIGHTS = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
WITNESS_B, WITNESS_H, WITNESS_ITERS, WITNESS_SAMPLES = 16, 32, 4, 128
WITNESS_SMALL_SIGMA = 3e-4
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "humanoid_rpy_refs.npz")


def reference() -> dict:
    """rbdtpu's hybrid solve, with the inputs and draws that made it."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        DDPConfig, MPPIConfig, hybrid_solve, quadratic_tracking_cost,
    )

    m = load_asset("humanoid30", dtype=np.float64, floating_base=True)
    rng = np.random.default_rng(SEED)
    q0 = np.zeros((B, m.nq))
    q0[:, 2] = 0.9
    q0 += 0.02 * rng.standard_normal(q0.shape)
    z = np.zeros((B, m.nv))
    x0 = np.concatenate([q0, z], -1)
    U0 = np.broadcast_to(
        np.asarray(rnea(m, jnp.asarray(q0), jnp.asarray(z),
                        jnp.asarray(z))[0])[:, None], (B, H, m.nv)).copy()
    goal = np.zeros(m.nx)
    goal[2] = 0.95
    cost = quadratic_tracking_cost(m, jnp.asarray(goal), **WEIGHTS)
    mcfg = MPPIConfig(n_samples=SAMPLES, sigma=SIGMA, dt=DT, fused=False)
    dcfg = DDPConfig(iters=DDP_ITERS, dt=DT, n_alphas=N_ALPHAS, fused=False)
    key = jax.random.PRNGKey(KEY)
    state, (mppi_hist, ddp_hist) = jax.jit(
        lambda x, U: hybrid_solve(m, cost, x, U, key, mcfg, dcfg,
                                  mppi_iters=MPPI_ITERS))(
        jnp.asarray(x0), jnp.asarray(U0))
    noise = np.stack([
        np.asarray(jax.random.normal(k, (B, SAMPLES, H, m.nv), jnp.float64))
        for k in jax.random.split(key, MPPI_ITERS)])
    return dict(x0=x0, U0=U0, goal=goal, noise=noise, U=np.asarray(state.U),
                J=np.asarray(state.J), mppi_hist=np.asarray(mppi_hist),
                ddp_hist=np.asarray(ddp_hist))


def start(m, rnea, Bm: int, Hk: int, rng):
    """configs[4]'s start as numpy arrays: (x0 (Bm, nx), U0 (Bm, Hk, nv),
    goal (nx,)); ``rnea(q, qd, qdd)`` returns numpy torques."""
    q0 = np.zeros((Bm, m.nq))
    q0[:, 2] = 0.9
    q0 += 0.02 * rng.standard_normal(q0.shape)
    z = np.zeros((Bm, m.nv))
    U0 = np.broadcast_to(rnea(q0, z, z)[:, None], (Bm, Hk, m.nv)).copy()
    goal = np.zeros(m.nx)
    goal[2] = 0.95
    return np.concatenate([q0, z], -1), U0, goal


def moved(J0, hist):
    """(iteration, problem) pairs whose accepted J fell below the previous
    one by more than rounding (1e-9 relative in float64, 1e-5 in float32):
    the guard took the weighted update or the best sample, not the
    nominal."""
    rel = 1e-9 if hist.dtype == np.float64 else 1e-5
    prev = np.concatenate([J0[None], hist[:-1]])
    return int((hist < prev * (1 - rel)).sum())


def witness():
    """rbdtpu's MPPI stage at configs[4]'s shape, and the port's plain
    route fed rbdtpu's float64 draws (see the module's docstring)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import rbdtpu_torch.model
    from rbdtpu.dynamics import rnea
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        MPPIConfig, mppi_solve, quadratic_tracking_cost, rollout,
        trajectory_cost,
    )
    from rbdtpu_torch import solver as tsolver

    m = load_asset("humanoid30", dtype=np.float64, floating_base=True)
    x0, U0, goal = start(m, lambda *a: np.asarray(rnea(
        m, *map(jnp.asarray, a))[0]), WITNESS_B, WITNESS_H,
        np.random.default_rng(SEED + 1))
    key = jax.random.PRNGKey(KEY + 1)
    draws = np.stack([
        np.asarray(jax.random.normal(
            k, (WITNESS_B, WITNESS_SAMPLES, WITNESS_H, m.nv), jnp.float64))
        for k in jax.random.split(key, WITNESS_ITERS)])
    tm = rbdtpu_torch.model.load_asset("humanoid30", device="cpu",
                                       dtype=torch.float64,
                                       floating_base=True)
    tcost = tsolver.quadratic_tracking_cost(tm, goal, **WEIGHTS)
    for sigma in (SIGMA, WITNESS_SMALL_SIGMA):
        cfg = MPPIConfig(n_samples=WITNESS_SAMPLES, sigma=sigma, dt=DT,
                         fused=False)
        for dtype in (jnp.float32, jnp.float64):
            mp = load_asset("humanoid30", dtype=dtype, floating_base=True)
            cost = quadratic_tracking_cost(mp, jnp.asarray(goal, dtype),
                                           **WEIGHTS)
            x, U = jnp.asarray(x0, dtype), jnp.asarray(U0, dtype)
            J0 = np.asarray(trajectory_cost(cost, rollout(
                mp, x, U, DT, -9.81), U))
            Ur, hist = jax.jit(lambda x, U: mppi_solve(
                mp, cost, x, U, key, WITNESS_ITERS, cfg))(x, U)
            hist = np.asarray(hist)
            print(f"rbdtpu MPPI sigma={sigma:g} {jnp.dtype(dtype).name}: "
                  f"{moved(J0, hist)} of {hist.size} (iteration, problem) "
                  f"pairs replaced the nominal; mean J {J0.mean():.9g} -> "
                  + " ".join(f"{v:.9g}" for v in hist.mean(-1)))
        Ut, ht = tsolver.mppi_solve(
            tm, tcost, torch.tensor(x0), torch.tensor(U0), None,
            WITNESS_ITERS, tsolver.MPPIConfig(
                n_samples=WITNESS_SAMPLES, sigma=sigma, dt=DT),
            noise=torch.tensor(draws))
        du = np.abs(Ut.numpy() - np.asarray(Ur)).max()
        dj = (np.abs(ht.numpy() - hist) / np.abs(hist)).max()
        print(f"port plain route, rbdtpu's float64 draws, sigma={sigma:g}: "
              f"max|dU| {du:.3e}, max rel |dJ| over the history {dj:.3e}, "
              f"{moved(J0, ht.numpy())} pairs replaced the nominal")


if __name__ == "__main__":
    if sys.argv[1:] == ["--witness"]:
        witness()
    else:
        np.savez_compressed(PATH, **reference())
        print(f"wrote {PATH}")
