"""Record rbdtpu's solve of a small floating-base quadruped MPC problem,
the reference that tests/test_torch_quadruped.py holds the port against:

    JAX_PLATFORMS=cpu python tests/make_quadruped_fixture.py

writes tests/data/quadruped_rpy_ddp.npz.  The problem is BASELINE.json
configs[3]'s (bench.py:482-507: quadruped12 with the rpy floating root,
tracking cost w_q=2, w_qd=0.05, w_u=1e-5 to a standing height of 0.4, dt
0.01, 6 line-search steps, gravity-compensation warm start) cut to B=2
problems, H=4 knots and 2 iterations, float64, with its start made from
SEED by numpy.  rbdtpu solves it on its plain jnp route (fused=False);
the file also keeps rbdtpu's linearize_trajectory at the solution."""
import os

import numpy as np

SEED = 20261017
B, H, ITERS, DT, N_ALPHAS = 2, 4, 2, 0.01, 6
WEIGHTS = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "quadruped_rpy_ddp.npz")


def reference() -> dict:
    """rbdtpu's solve and linearisation, with the inputs that made them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.model import load_asset
    from rbdtpu.solver import DDPConfig, ddp_solve, quadratic_tracking_cost
    from rbdtpu.solver.rollout import linearize_trajectory

    m = load_asset("quadruped12", dtype=np.float64, floating_base=True)
    rng = np.random.default_rng(SEED)
    q0 = np.zeros((B, m.nq))
    q0[:, 2] = 0.35
    q0 += 0.05 * rng.standard_normal(q0.shape)
    z = np.zeros((B, m.nv))
    x0 = np.concatenate([q0, z], -1)
    U0 = np.broadcast_to(
        np.asarray(rnea(m, jnp.asarray(q0), jnp.asarray(z),
                        jnp.asarray(z))[0])[:, None], (B, H, m.nv)).copy()
    goal = np.zeros(m.nx)
    goal[2] = 0.4
    cost = quadratic_tracking_cost(m, jnp.asarray(goal), **WEIGHTS)
    cfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS, fused=False)
    state, J_hist = jax.jit(lambda x, U: ddp_solve(m, cost, x, U, cfg))(
        jnp.asarray(x0), jnp.asarray(U0))
    A, Bm = linearize_trajectory(m, state.X, state.U, DT)
    return dict(x0=x0, U0=U0, goal=goal, U=np.asarray(state.U),
                X=np.asarray(state.X), J=np.asarray(state.J),
                J_hist=np.asarray(J_hist), A=np.asarray(A), B=np.asarray(Bm))


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
