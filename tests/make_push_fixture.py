"""Record rbdtpu's solver under disturbance wrenches (``f_ext``), the
references that the port's wrench tests (tests/test_torch_quadruped.py and
tests/test_torch_mppi.py) hold the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_push_fixture.py

writes tests/data/push_refs.npz (about three minutes).  Float64, inputs
made by numpy from SEED:

- ``forward_pass(f_ext)`` on quadruped12 (rpy root), B problems of H knots
  under a per-knot wrench set: rbdtpu's line-search rollouts (the plain
  pass its kernels K2 and K9 replace), from a nominal trajectory, gains K
  that hold it (K = -M(q0) [100 I, 10 I] perturbed by 10%) and steps k;
- ``ddp_solve(f_ext)`` on BASELINE.json configs[3]'s problem (bench.py:
  482-507: tracking to a standing height of 0.4), cut to B problems, H
  knots and ITERS iterations, under a constant (nb, 6) set and under a
  per-knot (H, nb, 6) set that pushes the trunk for a window of knots, on
  rbdtpu's plain jnp route;
- ``hybrid_solve(f_ext)`` on arm7 (B problems, H knots, MPPI_ITERS
  iterations of SAMPLES samples, DDP_ITERS DDP iterations) under a
  per-knot set, with the standard normals rbdtpu's MPPI drew (each
  iteration's ``jax.random.normal``, recorded so the port can take them).
"""
import os

import numpy as np

SEED = 20261019
B, H, ITERS, DT, N_ALPHAS = 2, 6, 2, 0.01, 6
W3 = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
ARM_W = dict(w_q=1.0, w_qd=0.1, w_u=1e-4)
# the hybrid: MPPI iterations, samples and sigma, DDP iterations and steps
MPPI_ITERS, SAMPLES, SIGMA, DDP_ITERS, ARM_ALPHAS, KEY = 2, 8, 0.1, 2, 4, 3
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "push_refs.npz")


def wrenches(nb: int, rng):
    """(constant (nb, 6) set 2 N(0,1), per-knot (H, nb, 6) set: 0.5 N(0,1)
    on every body and 40 N along +y on the trunk for knots 1-3)."""
    F_const = 2.0 * rng.standard_normal((nb, 6))
    F_knot = 0.5 * rng.standard_normal((H, nb, 6))
    F_knot[1:4, 0, 4] += 40.0
    return F_const, F_knot


def reference() -> dict:
    """rbdtpu's outputs, with the inputs that made them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import minv, rnea
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        DDPConfig, MPPIConfig, ddp_solve, hybrid_solve,
        quadratic_tracking_cost,
    )
    from rbdtpu.solver.ddp import forward_pass

    quad = load_asset("quadruped12", dtype=np.float64, floating_base=True)
    arm = load_asset("arm7", dtype=np.float64)
    rng = np.random.default_rng(SEED)
    out = {}
    nq, nv, nb = quad.nq, quad.nv, quad.nb
    q0 = np.zeros((B, nq))
    q0[:, 2] = 0.35
    q0 += 0.05 * rng.standard_normal(q0.shape)
    z = np.zeros((B, nv))
    x0 = np.concatenate([q0, z], -1)
    zj = jnp.asarray(z)
    U0 = np.broadcast_to(np.asarray(rnea(quad, jnp.asarray(q0), zj, zj)[0])
                         [:, None], (B, H, nv)).copy()
    F_const, F_knot = wrenches(nb, rng)
    goal = np.zeros(quad.nx)
    goal[2] = 0.4
    cost = quadratic_tracking_cost(quad, jnp.asarray(goal), **W3)
    out.update(x0=x0, U0=U0, F_const=F_const, F_knot=F_knot, goal=goal)

    # the line search under the per-knot set
    X = x0[:, None] + 0.01 * rng.standard_normal((B, H + 1, quad.nx))
    pd = np.concatenate([100.0 * np.eye(nv), 10.0 * np.eye(nv)], 1)
    M = np.linalg.inv(np.asarray(minv(quad, jnp.asarray(q0))))
    K = -(M[:, None] @ (pd * (1 + 0.1 * rng.standard_normal((B, H, nv,
                                                             2 * nv)))))
    k = 0.5 * rng.standard_normal((B, H, nv))
    alphas = 2.0 ** -np.arange(N_ALPHAS)
    Xs, Us, Js = forward_pass(quad, cost, jnp.asarray(X), jnp.asarray(U0),
                              jnp.asarray(k), jnp.asarray(K),
                              jnp.asarray(alphas), DT, -9.81,
                              f_ext=jnp.asarray(F_knot))
    out.update(fp_X=X, fp_k=k, fp_K=K, fp_alphas=alphas, fp_Xs=Xs, fp_Us=Us,
               fp_Js=Js)

    cfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS, fused=False)
    for name, F in (("const", F_const), ("knot", F_knot)):
        state, J_hist = jax.jit(
            lambda x, U_, F_: ddp_solve(quad, cost, x, U_, cfg, f_ext=F_))(
            jnp.asarray(x0), jnp.asarray(U0), jnp.asarray(F))
        out.update({f"solve_{name}_U": state.U, f"solve_{name}_J": state.J,
                    f"solve_{name}_J_hist": J_hist})

    # the hybrid on arm7: bent start at rest, goal: hold problem 0's start
    aq = 0.5 * rng.standard_normal((B, arm.nq))
    ax0 = np.concatenate([aq, np.zeros_like(aq)], -1)
    agoal = np.concatenate([aq[0], np.zeros(arm.nv)])
    aU0 = np.zeros((B, H, arm.nv))
    aF = 0.5 * rng.standard_normal((H, arm.nb, 6))
    acost = quadratic_tracking_cost(arm, jnp.asarray(agoal), **ARM_W)
    mcfg = MPPIConfig(n_samples=SAMPLES, sigma=SIGMA, dt=DT)
    dcfg = DDPConfig(iters=DDP_ITERS, dt=DT, n_alphas=ARM_ALPHAS)
    key = jax.random.PRNGKey(KEY)
    state, (mh, dh) = hybrid_solve(arm, acost, jnp.asarray(ax0),
                                   jnp.asarray(aU0), key, mcfg, dcfg,
                                   mppi_iters=MPPI_ITERS,
                                   f_ext=jnp.asarray(aF))
    shape = (B, SAMPLES, H, arm.nv)
    noise = jnp.stack([jax.random.normal(kk, shape, jnp.float64)
                       for kk in jax.random.split(key, MPPI_ITERS)])
    out.update(hy_x0=ax0, hy_U0=aU0, hy_goal=agoal, hy_F=aF, hy_noise=noise,
               hy_U=state.U, hy_J=state.J, hy_mppi_hist=mh, hy_ddp_hist=dh)
    return {kk: np.asarray(v) for kk, v in out.items()}


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
