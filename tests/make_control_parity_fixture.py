"""Record rbdtpu's solves at the control-parity config, the reference that
tests/test_torch_control_parity.py holds the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_control_parity_fixture.py

writes tests/data/control_parity_refs.npz.  The config is
tests/test_control_parity.py's north star: arm7, quadratic_tracking_cost
with its default weights to a goal posture drawn uniformly in [-0.4, 0.4]
at rest, H=100, 10 iterations, 8 line-search steps, dt 0.01,
``rollout_route="minv"``, ``parallel_riccati=False``, from a start drawn
uniformly in [-0.2, 0.2] at rest with the gravity-compensation warm start,
3 problems solved one at a time, float64; the draws are made by numpy from
SEED with that test's distributions."""
import os

import numpy as np

SEED = 20261020
H, ITERS, DT, N_PROBLEMS, N_ALPHAS = 100, 10, 0.01, 3, 8
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "control_parity_refs.npz")


def problems():
    """(x0s, x_goals), each (N_PROBLEMS, 14)."""
    rng = np.random.default_rng(SEED)
    nq = 7
    goals = np.stack([np.concatenate([rng.uniform(-0.4, 0.4, nq),
                                      np.zeros(nq)])
                      for _ in range(N_PROBLEMS)])
    x0s = np.stack([np.concatenate([rng.uniform(-0.2, 0.2, nq),
                                    np.zeros(nq)])
                    for _ in range(N_PROBLEMS)])
    return x0s, goals


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.model import load_asset
    from rbdtpu.solver import DDPConfig, ddp_solve, quadratic_tracking_cost

    m = load_asset("arm7", dtype=np.float64)
    cfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS,
                    rollout_route="minv", parallel_riccati=False)
    x0s, goals = problems()
    out = dict(x0=x0s, goal=goals, U0=[], U=[], J=[], J_hist=[])
    for x0, goal in zip(x0s, goals):
        q0, zero = jnp.asarray(x0[:7]), jnp.zeros(7)
        U0 = np.broadcast_to(np.asarray(rnea(m, q0, zero, zero)[0]),
                             (H, 7)).copy()
        cost = quadratic_tracking_cost(m, jnp.asarray(goal))
        state, J_hist = ddp_solve(m, cost, jnp.asarray(x0), jnp.asarray(U0),
                                  cfg)
        for k, v in dict(U0=U0, U=state.U, J=state.J, J_hist=J_hist).items():
            out[k].append(np.asarray(v))
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
