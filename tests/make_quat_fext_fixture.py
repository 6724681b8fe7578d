"""Record rbdtpu on the quaternion floating root under world wrenches and
on the kernels the port's "fq32" class adds (K9, K2 and K9 with wrenches,
K6, K10), the reference that tests/test_torch_quat_fext.py holds the port
against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_quat_fext_fixture.py

writes tests/data/quat_fext_refs.npz (several minutes, most of it rbdtpu's
interpret-mode traces and the humanoid hybrid's compile).  Everything is
float64, its inputs made by numpy from SEED:

- one Pallas interpret-mode case each on the quaternion quadruped at 8
  states: K9 (``feedback_rollout_fused_chunked``, nchunks 2 and 3), K9 and
  K2 (``feedback_rollout_fused``) under a per-knot (H, nb, 6) wrench set,
  K6 (``fd_step_minv_fused``) on both routes without wrenches, the
  factorised route under one (nb, 6) set and the dense one under one set a
  state, K10 (``rnea_fused``) with and without qdd;
- ``ddp_solve(f_ext)`` on the quaternion quadruped (configs[3]'s task on
  that root: tracking to a standing height of 0.4 with the identity
  quaternion), B = 2 problems, H = 8 knots, 2 iterations, under a trunk
  push, on rbdtpu's plain jnp route;
- ``hybrid_solve(f_ext)`` on the quaternion humanoid at
  tests/make_quat_fixture.py's cut (B = 2, H = 4, 2 MPPI iterations of 8
  samples, then 2 DDP iterations of 4 steps) under a trunk push, with the
  standard normals its MPPI stage drew;
- rbdtpu's K2/K9 budget halves (``feedback_fused_ok``,
  ``feedback_chunks``, ``feedback_chunked_ok``) on the quaternion humanoid
  at 4 x BATCHES line-search trajectories.
"""
import os

import numpy as np

SEED = 20261021
DT, GRAVITY = 0.01, -9.81
# the kernels' cases: states, knots
BK, HK = 8, 2
# ddp_solve(f_ext) on the quaternion quadruped
BQ, HQ, ITERS_Q, ALPHAS_Q = 2, 8, 2, 6
W3 = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
# hybrid_solve(f_ext) on the quaternion humanoid (make_quat_fixture's cut)
B, H, ITERS, SAMPLES, N_ALPHAS, SIGMA, KEY = 2, 4, 2, 8, 4, 0.3, 11
WG = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
# trunk pushes (newtons along +y on body 0, knots [start, end)) over
# 0.5 N(0,1) wrenches on every body
PUSH_Q, PUSH_H = (40.0, (2, 6)), (20.0, (1, 3))
# the budget halves: problems, four line-search steps each
BATCHES, ALPHAS_J = (128, 135, 136, 142, 256), 4
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "quat_fext_refs.npz")


def push(nb: int, Hk: int, newtons: float, knots, rng):
    """(Hk, nb, 6) world wrenches: 0.5 N(0,1) on every body, ``newtons``
    along +y on the trunk for ``knots``."""
    F = 0.5 * rng.standard_normal((Hk, nb, 6))
    F[knots[0]:knots[1], 0, 4] += newtons
    return F


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.kernels import fused as jf
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        DDPConfig, MPPIConfig, ddp_solve, hybrid_solve,
        quadratic_tracking_cost,
    )
    from rbdtpu.solver.integrate import (
        config_retract, euler_semi_implicit, state_retract,
    )

    rng = np.random.default_rng(SEED)
    out = {}
    A = lambda a: np.asarray(a)
    J = jnp.asarray
    quad = load_asset("quadruped12", dtype=np.float64, floating_base=True,
                      root_quat=True)
    hum = load_asset("humanoid30", dtype=np.float64, floating_base=True,
                     root_quat=True)

    # ---- the kernels, interpret mode, on the quaternion quadruped ----
    n, nb = quad.nv, quad.nb
    q = np.zeros((BK, quad.nq))
    q[:, 2], q[:, 3] = 0.35, 1.0
    q = A(config_retract(quad, J(q), J(0.3 * rng.standard_normal((BK, n)))))
    qd, u, qdd = 0.5 * rng.standard_normal((3, BK, n))
    x = np.concatenate([q, qd], -1)
    Xn = np.stack([x, A(euler_semi_implicit(quad, J(x), J(0.1 * u), DT))], 1)
    Un = 0.5 * rng.standard_normal((BK, HK, n))
    kf = 0.1 * rng.standard_normal((BK, HK, n))
    Kf = 0.5 * rng.standard_normal((BK, HK, n, 2 * n))
    xs = A(state_retract(quad, J(x), J(0.05 * rng.standard_normal((BK, 2 * n)))))
    F = push(nb, HK, 20.0, (0, 1), rng)
    F1 = 0.5 * rng.standard_normal((nb, 6))
    FB = 0.5 * rng.standard_normal((BK, nb, 6))
    out.update(k_q=q, k_qd=qd, k_u=u, k_qdd=qdd, k_x0=xs, k_Xn=Xn, k_Un=Un,
               k_kf=kf, k_Kf=Kf, k_F=F, k_F1=F1, k_FB=FB)
    fb = (J(xs), J(Xn), J(Un), J(kf), J(Kf))
    for c in (2, 3):
        Xk, Uk = jf.feedback_rollout_fused_chunked(
            quad, *fb, DT, GRAVITY, nchunks=c, interpret=True)
        out.update({f"k9_{c}_X": A(Xk), f"k9_{c}_U": A(Uk)})
    Xk, Uk = jf.feedback_rollout_fused_chunked(
        quad, *fb, DT, GRAVITY, nchunks=2, interpret=True, f_ext=J(F))
    out.update(k9_fext_X=A(Xk), k9_fext_U=A(Uk))
    Xk, Uk = jf.feedback_rollout_fused(quad, *fb, DT, GRAVITY,
                                       interpret=True, f_ext=J(F))
    out.update(k2_fext_X=A(Xk), k2_fext_U=A(Uk))
    for tag, dense, fe in (("fact", False, None), ("dense", True, None),
                           ("fact_f1", False, F1), ("dense_fb", True, FB)):
        out[f"k6_{tag}"] = A(jf.fd_step_minv_fused(
            quad, J(x), J(u), DT, GRAVITY, interpret=True, dense_minv=dense,
            f_ext=None if fe is None else J(fe)))
    out["k10_bias"] = A(jf.rnea_fused(quad, J(q), J(qd), None, GRAVITY,
                                      interpret=True))
    out["k10_qdd"] = A(jf.rnea_fused(quad, J(q), J(qd), J(qdd), GRAVITY,
                                     interpret=True))

    # ---- ddp_solve(f_ext) on the quaternion quadruped, plain route ----
    q0 = np.zeros((BQ, quad.nq))
    q0[:, 2], q0[:, 3] = 0.35, 1.0
    q0 = A(config_retract(quad, J(q0), J(0.05 * rng.standard_normal((BQ, n)))))
    z = np.zeros((BQ, n))
    U0 = np.broadcast_to(A(rnea(quad, J(q0), J(z), J(z))[0])[:, None],
                         (BQ, HQ, n)).copy()
    goal = np.zeros(quad.nx)
    goal[2], goal[3] = 0.4, 1.0
    FQ = push(nb, HQ, *PUSH_Q, rng)
    cost = quadratic_tracking_cost(quad, J(goal), **W3)
    cfg = DDPConfig(iters=ITERS_Q, dt=DT, n_alphas=ALPHAS_Q, fused=False)
    state, hist = jax.jit(lambda x0, U, F_: ddp_solve(
        quad, cost, x0, U, cfg, f_ext=F_))(J(np.concatenate([q0, z], -1)),
                                           J(U0), J(FQ))
    out.update(q_x0=np.concatenate([q0, z], -1), q_U0=U0, q_goal=goal,
               q_F=FQ, q_U=A(state.U), q_J=A(state.J), q_hist=A(hist))

    # ---- hybrid_solve(f_ext) on the quaternion humanoid, plain route ----
    nh = hum.nv
    qh = np.zeros((B, hum.nq))
    qh[:, 2], qh[:, 3] = 0.9, 1.0
    qh = A(config_retract(hum, J(qh), J(0.02 * rng.standard_normal((B, nh)))))
    zh = np.zeros((B, nh))
    Uh = np.broadcast_to(A(rnea(hum, J(qh), J(zh), J(zh))[0])[:, None],
                         (B, H, nh)).copy()
    gh = np.zeros(hum.nx)
    gh[2], gh[3] = 0.95, 1.0
    FH = push(hum.nb, H, *PUSH_H, rng)
    hcost = quadratic_tracking_cost(hum, J(gh), **WG)
    mcfg = MPPIConfig(n_samples=SAMPLES, sigma=SIGMA, dt=DT, fused=False)
    dcfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS, fused=False)
    key = jax.random.PRNGKey(KEY)
    xh = np.concatenate([qh, zh], -1)
    state, (mh, dh) = jax.jit(lambda x0, U, F_: hybrid_solve(
        hum, hcost, x0, U, key, mcfg, dcfg, mppi_iters=ITERS, f_ext=F_))(
        J(xh), J(Uh), J(FH))
    noise = np.stack([
        A(jax.random.normal(k, (B, SAMPLES, H, nh), jnp.float64))
        for k in jax.random.split(key, ITERS)])
    out.update(h_x0=xh, h_U0=Uh, h_goal=gh, h_F=FH, h_noise=noise,
               h_U=A(state.U), h_J=A(state.J), h_mppi=A(mh), h_ddp=A(dh))

    # ---- the K2/K9 budget halves on the quaternion humanoid ----
    bt = np.array([ALPHAS_J * b for b in BATCHES])
    out.update(
        budget_batches=bt,
        budget_fused_ok=np.array([jf.feedback_fused_ok(hum, int(t))
                                  for t in bt]),
        budget_chunks=np.array([jf.feedback_chunks(hum, int(t)) or 0
                                for t in bt]),
        budget_chunked_ok=np.array([jf.feedback_chunked_ok(hum, int(t)) or 0
                                    for t in bt]))
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
