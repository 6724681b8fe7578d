"""Record rbdtpu's end-effector kinematics, cost and solve on the rpy
floating root, the references that the port's quadruped foot-reaching tests
(tests/test_torch_quadruped.py) hold the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_footreach_fixture.py

writes tests/data/footreach_rpy_refs.npz (about two minutes).  Everything
is float64 on quadruped12 with floating_base=True, from inputs made by
numpy from SEED:

- at B_KIN configurations uniform in [-1, 1]: rbdtpu's
  ``ee_position_jacobian_tangent`` at every leaf joint, at one foot's fixed
  frame and at a leaf joint with an EE offset, and ``ee_pose`` there; its
  ``ee_gn_fused`` in interpret mode at the first leaf (the one recorded
  case of the Pallas kernel);
- ``ee_reaching_cost`` toward TARGET at the first leaf (bench.py:509-537's
  weights): stage and terminal values and ``quadratize_trajectory`` on a
  random (B, H + 1) trajectory;
- path E, bench.py's quadruped foot-reaching solve (bench.py:509-537), cut
  to B problems, H knots and ITERS iterations: ``ddp_solve`` on rbdtpu's
  plain jnp route (fused=False) from q[2] = 0.35 + 0.05 N(0,1) at rest,
  warm-started with gravity compensation.
"""
import os

import numpy as np

SEED = 20261018
B_KIN = 3
B, H, ITERS, DT, N_ALPHAS = 2, 4, 2, 0.01, 6
TARGET = (0.3, 0.1, 0.1)
WEIGHTS = dict(w_ee=10.0, w_ee_f=500.0, w_qd=1e-2, w_u=1e-5)
FRAME = "RL_foot_fixed"
OFFSET = (0.02, -0.01, 0.03, 1.0)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "footreach_rpy_refs.npz")


def problems(nq: int, nv: int, rng):
    """Path E's start (bench.py:522-525): q[2] = 0.35 plus 0.05 N(0,1) on
    every coordinate, at rest."""
    q0 = np.zeros((B, nq))
    q0[:, 2] = 0.35
    q0 += 0.05 * rng.standard_normal(q0.shape)
    return q0, np.zeros((B, nv))


def reference() -> dict:
    """rbdtpu's outputs, with the inputs that made them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.kernels.fk_lane import ee_gn_fused
    from rbdtpu.kinematics import fk
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        DDPConfig, ddp_solve, ee_reaching_cost, quadratize_trajectory,
        trajectory_cost,
    )

    m = load_asset("quadruped12", dtype=np.float64, floating_base=True)
    rng = np.random.default_rng(SEED)
    leaf = m.joint_names[m.leaves()[0]]
    out = {}
    q = rng.uniform(-1.0, 1.0, (B_KIN, m.nq))
    qj = jnp.asarray(q)
    out["q"] = q
    out["jac_leaves"] = fk.ee_position_jacobian_tangent(m, qj)
    out["pose_leaves"] = fk.ee_pose(m, qj)
    out["jac_frame"] = fk.ee_position_jacobian_tangent(m, qj,
                                                       ee_names=[FRAME])
    out["pose_frame"] = fk.ee_pose(m, qj, ee_names=[FRAME])
    off = jnp.asarray(OFFSET)
    out["jac_offset"] = fk.ee_position_jacobian_tangent(m, qj, [leaf], off)
    out["pose_offset"] = fk.ee_pose(m, qj, [leaf], off)
    e, g0, H0 = ee_gn_fused(m, qj, TARGET, ee_names=[leaf], interpret=True)
    out.update(gn_e=e, gn_g0=g0, gn_H0=H0)

    cost = ee_reaching_cost(m, jnp.asarray(TARGET), ee_names=[leaf],
                            fused=False, **WEIGHTS)
    X = rng.uniform(-0.5, 0.5, (B, H + 1, m.nx))
    X[..., 2] += 0.35
    U = rng.standard_normal((B, H, m.nv))
    Xj, Uj = jnp.asarray(X), jnp.asarray(U)
    out.update(X=X, U=U,
               stage=cost.stage(Xj[..., :-1, :], Uj, jnp.arange(H)),
               terminal=cost.terminal(Xj[..., -1, :]),
               J_traj=trajectory_cost(cost, Xj, Uj))
    for k, v in zip(("lx", "lu", "lxx", "luu", "lux", "lfx", "lfxx"),
                    quadratize_trajectory(cost, Xj, Uj, model=m)):
        out[f"d_{k}"] = v

    q0, z = problems(m.nq, m.nv, rng)
    x0 = np.concatenate([q0, z], -1)
    U0 = np.broadcast_to(
        np.asarray(rnea(m, jnp.asarray(q0), jnp.asarray(z),
                        jnp.asarray(z))[0])[:, None], (B, H, m.nv)).copy()
    cfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS, fused=False)
    state, J_hist = jax.jit(lambda x, U_: ddp_solve(m, cost, x, U_, cfg))(
        jnp.asarray(x0), jnp.asarray(U0))
    out.update(x0=x0, U0=U0, solve_U=state.U, solve_J=state.J,
               solve_J_hist=J_hist)
    return {k: np.asarray(v) for k, v in out.items()}


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
