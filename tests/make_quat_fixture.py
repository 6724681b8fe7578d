"""Record rbdtpu on the quaternion floating root, the reference that
tests/test_torch_quat.py holds the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_quat_fixture.py

writes tests/data/quat_refs.npz (a few minutes, most of it rbdtpu's
compiles at humanoid size).  Everything is float64, its inputs made by
numpy from SEED:

- the quaternion algebra (exp, log, product, rotation, the SO(3) right
  Jacobians, from rpy) and the tangent chart (``config_retract``,
  ``config_diff``, ``state_retract``, ``state_diff``,
  ``euler_semi_implicit``, ``step_jacobians`` with its SO(3) transport) on
  the quaternion humanoid;
- ``rnea`` (with and without world wrenches), ``aba`` (with and without),
  ``minv`` and ``rnea_grad`` (the root's tangent columns included) on
  quadruped12 and humanoid30 with ``root_quat=True`` at B = 3, and FK: the
  world transforms and the tangent EE Jacobian at the humanoid's left
  wrist;
- one Pallas interpret-mode case each of K1 (``fd_step_fused``), K2
  (``feedback_rollout_fused``), K3 (``linearize_parts_fused``) on the
  quaternion quadruped, and K4 (``ee_gn_fused``) on the quaternion
  humanoid at its left wrist;
- the tracking cost (bench.py:566-572's) and the hand-reaching cost
  (bench.py:659-663's) with their quadratisations;
- path G, the quaternion humanoid hybrid (bench.py:539-590 with
  root_quat=True), and path H, humanoid hand reaching (bench.py:640-672),
  each cut to B = 2 problems, H = 4 knots and 2 iterations (path G's MPPI
  stage 2 iterations of 8 samples) on rbdtpu's plain jnp route
  (fused=False), with the standard normals its MPPI stage drew.
"""
import os

import numpy as np

SEED = 20261020
B, H, ITERS, SAMPLES, N_ALPHAS = 2, 4, 2, 8, 4
DT, SIGMA, KEY, GRAVITY = 0.01, 0.3, 7, -9.81
WG = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
WE = dict(w_ee=10.0, w_ee_f=500.0, w_qd=1e-2, w_u=1e-5)
TARGET_H, EE_H = (0.35, 0.25, 1.1), "left_arm_wrist_roll"
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "quat_refs.npz")


def start(m, cr, rnea, Bm: int, Hk: int, rng):
    """Path G's and H's start as numpy arrays: the identity quaternion at
    height 0.9 retracted by 0.02 N(0,1) (``cr``: config_retract), at rest,
    gravity compensation at every knot (``rnea(q, qd, qdd)``: numpy)."""
    q0 = np.zeros((Bm, m.nq))
    q0[:, 2], q0[:, 3] = 0.9, 1.0
    q0 = cr(q0, 0.02 * rng.standard_normal((Bm, m.nv)))
    z = np.zeros((Bm, m.nv))
    U0 = np.broadcast_to(rnea(q0, z, z)[:, None], (Bm, Hk, m.nv)).copy()
    return np.concatenate([q0, z], -1), U0


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import aba, minv, rnea, rnea_grad
    from rbdtpu.kernels.colvec import linearize_parts_fused
    from rbdtpu.kernels.fk_lane import ee_gn_fused
    from rbdtpu.kernels.fused import fd_step_fused, feedback_rollout_fused
    from rbdtpu.kinematics.fk import (
        ee_position_jacobian_tangent, fk_world_hom,
    )
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        DDPConfig, MPPIConfig, ddp_solve, ee_reaching_cost, hybrid_solve,
        quadratic_tracking_cost,
    )
    from rbdtpu.solver.costs import quadratize_trajectory, trajectory_cost
    from rbdtpu.solver.integrate import (
        config_diff, config_retract, euler_semi_implicit, state_diff,
        state_retract, step_jacobians,
    )
    from rbdtpu.spatial import quat as Q

    rng = np.random.default_rng(SEED)
    out = {}
    A = lambda a: np.asarray(a)
    J = jnp.asarray
    hum = load_asset("humanoid30", dtype=np.float64, floating_base=True,
                     root_quat=True)
    quad = load_asset("quadruped12", dtype=np.float64, floating_base=True,
                      root_quat=True)

    # ---- the quaternion algebra ----
    phi = rng.standard_normal((6, 3))
    phi[0] = 0.0
    phi[1] *= 1e-7  # below the Taylor branches' threshold
    phi[2] *= 2.0
    qa = rng.standard_normal((6, 4))
    qa /= np.linalg.norm(qa, axis=-1, keepdims=True)
    qa[0] = [1.0, 0.0, 0.0, 0.0]
    qa[1] = [-np.sqrt(1 - 3e-16), 1e-8, 1e-8, 1e-8]  # w < 0, tiny angle
    qb = rng.standard_normal((6, 4))
    rpy = rng.standard_normal((6, 3))
    out.update(phi=phi, qa=qa, qb=qb, rpy=rpy,
               quat_exp=A(Q.quat_exp(J(phi))),
               quat_log=A(Q.quat_log(J(qa))),
               quat_mul=A(Q.quat_mul(J(qa), J(qb))),
               quat_to_R=A(Q.quat_to_R(J(qa))),
               quat_normalize=A(Q.quat_normalize(J(qb))),
               quat_from_rpy=A(Q.quat_from_rpy(J(rpy))),
               jr=A(Q.so3_right_jacobian(J(phi))),
               jr_inv=A(Q.so3_right_jacobian_inv(J(phi))))

    # ---- the chart, on the quaternion humanoid ----
    cr = lambda q, xi: A(config_retract(hum, J(q), J(xi)))
    n = hum.nv
    q0 = np.zeros((3, hum.nq))
    q0[:, 2], q0[:, 3] = 0.9, 1.0
    q0 = cr(q0, 0.5 * rng.standard_normal((3, n)))
    xi = 0.3 * rng.standard_normal((3, n))
    xi[0, 0:3] *= 1e-8
    x0 = np.concatenate([q0, rng.standard_normal((3, n))], -1)
    x1 = A(state_retract(hum, J(x0), J(0.4 * rng.standard_normal((3, 2 * n)))))
    qdd = rng.standard_normal((3, n))
    Mi = rng.standard_normal((3, n, n))
    dq, dqd = rng.standard_normal((2, 3, n, n))
    qd_new = rng.standard_normal((3, n))
    Aj, Bj = step_jacobians(hum, J(Mi), J(dq), J(dqd), DT, qd_new=J(qd_new))
    out.update(chart_q0=q0, chart_xi=xi, chart_x0=x0, chart_x1=x1,
               chart_qdd=qdd, chart_Mi=Mi, chart_dq=dq, chart_dqd=dqd,
               chart_qd_new=qd_new,
               config_retract=cr(q0, xi),
               config_diff=A(config_diff(hum, J(x1[:, :hum.nq]), J(q0))),
               state_diff=A(state_diff(hum, J(x1), J(x0))),
               state_retract=x1,
               euler=A(euler_semi_implicit(hum, J(x0), J(qdd), DT)),
               step_A=A(Aj), step_B=A(Bj))

    # ---- dynamics and FK at B = 3 ----
    for tag, m in (("quad", quad), ("hum", hum)):
        n = m.nv
        q = np.zeros((3, m.nq))
        q[:, 2], q[:, 3] = 0.5, 1.0
        q = A(config_retract(m, J(q), J(0.4 * rng.standard_normal((3, n)))))
        qd, qdd, tau = (rng.standard_normal((3, n)) for _ in range(3))
        fe = 0.5 * rng.standard_normal((3, m.nb, 6))
        dcq, dcd = rnea_grad(m, J(q), J(qd), J(qdd), GRAVITY, split=True)
        out.update({
            f"{tag}_q": q, f"{tag}_qd": qd, f"{tag}_qdd": qdd,
            f"{tag}_tau": tau, f"{tag}_fext": fe,
            f"{tag}_rnea": A(rnea(m, J(q), J(qd), J(qdd), GRAVITY)[0]),
            f"{tag}_rnea_fext": A(rnea(m, J(q), J(qd), J(qdd), GRAVITY,
                                       f_ext=J(fe))[0]),
            f"{tag}_aba": A(aba(m, J(q), J(qd), J(tau), gravity=GRAVITY)),
            f"{tag}_aba_fext": A(aba(m, J(q), J(qd), J(tau), f_ext=J(fe),
                                     gravity=GRAVITY)),
            f"{tag}_minv": A(minv(m, J(q))),
            f"{tag}_dcq": A(dcq), f"{tag}_dcd": A(dcd),
            f"{tag}_fk": A(fk_world_hom(m, J(q))),
        })
    out["hum_jac"] = A(ee_position_jacobian_tangent(
        hum, J(out["hum_q"]), ee_names=[EE_H]))

    # ---- one interpret-mode case each of K1-K4 on the quaternion root ----
    n = quad.nv
    q = np.zeros((8, quad.nq))
    q[:, 2], q[:, 3] = 0.35, 1.0
    q = A(config_retract(quad, J(q), J(0.3 * rng.standard_normal((8, n)))))
    qd, u = 0.5 * rng.standard_normal((2, 8, n))
    x = np.concatenate([q, qd], -1)
    out.update(k_q=q, k_qd=qd, k_u=u,
               k1=A(fd_step_fused(quad, J(x), J(u), DT, GRAVITY,
                                  interpret=True)))
    parts = linearize_parts_fused(quad, J(q), J(qd), J(u), GRAVITY,
                                  interpret=True)
    out.update({f"k3_{k}": A(v) for k, v in zip(
        ("Minv", "dcq", "dcd", "qdd"), parts)})
    Hk = 2
    Xn = np.stack([x, A(euler_semi_implicit(quad, J(x), J(0.1 * u), DT))], 1)
    Un = 0.5 * rng.standard_normal((8, Hk, n))
    kf = 0.1 * rng.standard_normal((8, Hk, n))
    Kf = 0.5 * rng.standard_normal((8, Hk, n, 2 * n))
    xs = A(state_retract(quad, J(x), J(0.05 * rng.standard_normal((8, 2 * n)))))
    Xk, Uk = feedback_rollout_fused(quad, J(xs), J(Xn), J(Un), J(kf), J(Kf),
                                    DT, GRAVITY, interpret=True)
    out.update(k2_x0=xs, k2_Xn=Xn, k2_Un=Un, k2_kf=kf, k2_Kf=Kf, k2_X=A(Xk),
               k2_U=A(Uk))
    qh = np.zeros((8, hum.nq))
    qh[:, 2], qh[:, 3] = 0.9, 1.0
    qh = A(config_retract(hum, J(qh), J(0.3 * rng.standard_normal((8, hum.nv)))))
    e, g0, H0 = ee_gn_fused(hum, J(qh), TARGET_H, ee_names=[EE_H],
                            interpret=True)
    out.update(k4_q=qh, k4_e=A(e), k4_g0=A(g0), k4_H0=A(H0))

    # ---- the costs and their quadratisations ----
    xh = np.concatenate([qh[:6], 0.3 * rng.standard_normal((6, hum.nv))], -1)
    Xc = np.stack([xh[:3], xh[3:]], 1)  # (3, 2, nx): one knot, terminal
    Uc = rng.standard_normal((3, 1, hum.nv))
    goal = np.zeros(hum.nx)
    goal[2], goal[3] = 0.95, 1.0
    for tag, cost in (
            ("track", quadratic_tracking_cost(hum, J(goal), **WG)),
            ("ee", ee_reaching_cost(hum, J(np.array(TARGET_H)),
                                    ee_names=[EE_H], fused=False, **WE))):
        d = quadratize_trajectory(cost, J(Xc), J(Uc), model=hum)
        out.update({f"{tag}_{k}": A(v) for k, v in zip(
            ("lx", "lu", "lxx", "luu", "lux", "lfx", "lfxx"), d)})
        out[f"{tag}_J"] = A(trajectory_cost(cost, J(Xc), J(Uc)))
    out.update(cost_X=Xc, cost_U=Uc, goal=goal)

    # ---- paths G and H, cut to size, plain route ----
    rnea_np = lambda q, qd, qdd: A(rnea(hum, J(q), J(qd), J(qdd))[0])
    x0, U0 = start(hum, cr, rnea_np, B, H, rng)
    cost = quadratic_tracking_cost(hum, J(goal), **WG)
    mcfg = MPPIConfig(n_samples=SAMPLES, sigma=SIGMA, dt=DT, fused=False)
    dcfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=N_ALPHAS, fused=False)
    key = jax.random.PRNGKey(KEY)
    state, (mh, dh) = jax.jit(lambda x, U: hybrid_solve(
        hum, cost, x, U, key, mcfg, dcfg, mppi_iters=ITERS))(J(x0), J(U0))
    noise = np.stack([
        A(jax.random.normal(k, (B, SAMPLES, H, hum.nv), jnp.float64))
        for k in jax.random.split(key, ITERS)])
    out.update(g_x0=x0, g_U0=U0, g_noise=noise, g_U=A(state.U),
               g_J=A(state.J), g_mppi=A(mh), g_ddp=A(dh))
    x0, U0 = start(hum, cr, rnea_np, B, H, rng)
    ecost = ee_reaching_cost(hum, J(np.array(TARGET_H)), ee_names=[EE_H],
                             fused=False, **WE)
    state, hist = jax.jit(lambda x, U: ddp_solve(hum, ecost, x, U, dcfg))(
        J(x0), J(U0))
    out.update(h_x0=x0, h_U0=U0, h_U=A(state.U), h_J=A(state.J),
               h_hist=A(hist))
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
