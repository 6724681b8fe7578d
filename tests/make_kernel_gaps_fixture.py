"""Record rbdtpu on the calls whose port closes its last gaps against the
reference, which tests/test_torch_kernel_gaps.py holds the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_kernel_gaps_fixture.py

writes tests/data/kernel_gaps_refs.npz.  Everything is float64, its inputs
made by numpy from SEED:

- ``rnea_grad(..., use_damping=True)`` on arm7 and the rpy quadruped, each
  with joint damping DAMPING (rbdtpu's assets carry none);
- ``ee_pose_gradient`` and ``ee_pose_hessian`` on arm7 (its leaf) and the
  rpy quadruped (a knee and a foot's fixed frame);
- ``add_limit_barrier`` around the tracking cost, quadratised on arm7 and
  the quaternion quadruped at states past their joint and velocity limits;
- the AD quadratisation of the tracking cost stripped of its derivatives
  (``Cost(stage, terminal)``) on arm7 and the quaternion quadruped, and
  ``ddp_solve`` with it at B = 2, H = 8, 3 iterations on both;
- the rollout of ``rollout_multi`` on the rpy quadruped, the rpy humanoid
  and the quaternion humanoid: rbdtpu's plain step (ABA on route "aba",
  ``forward_dynamics`` on route "minv", then semi-implicit Euler) scanned
  over H = 6 steps at B = 4, with and without per-step wrenches 0.5 N(0,1);
- ``ee_reaching_cost``'s analytic quadratisation (``fused=False``) on the
  rpy humanoid at the left wrist (path M's cost), whose EE terms K4's plain
  version forms in the port.
"""
import dataclasses
import os

import numpy as np

SEED = 20261031
DT, GRAVITY = 0.01, -9.81
DAMPING = 0.05
# the quadratisations: problems, knots
BQ, HQ = 2, 3
# ddp_solve with the AD quadratisation
BD, HD, ITERS, ALPHAS = 2, 8, 3, 4
W = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
# rollout_multi: trajectories, steps
BR, HR = 4, 6
# path M's cost (bench.py:640-672 with root_quat=False)
TARGET_M, EE_M = (0.35, 0.25, 1.1), ("left_arm_wrist_roll",)
WM = dict(w_ee=10.0, w_ee_f=500.0, w_qd=1e-2, w_u=1e-5)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "kernel_gaps_refs.npz")


def goal_state(model):
    """The tracking goal: standing at 0.4 (the identity quaternion on the
    quaternion root), at rest; arm7's is zero."""
    g = np.zeros(model.nq + model.nv)
    if model.floating_base:
        g[2] = 0.4
        if model.root_quat:
            g[3] = 1.0
    return g


def states(model, rng, lead, scale_q, scale_qd):
    """Random states of shape lead + (nx,): q = scale_q N(0,1) (retracted
    from a standing pose on a floating root), qd = scale_qd N(0,1)."""
    import jax.numpy as jnp

    from rbdtpu.solver.integrate import config_retract

    n = model.nv
    if model.floating_base:
        q = np.zeros(lead + (model.nq,))
        q[..., 2] = 0.9
        if model.root_quat:
            q[..., 3] = 1.0
        q = np.asarray(config_retract(model, jnp.asarray(q), jnp.asarray(
            scale_q * rng.standard_normal(lead + (n,)))))
    else:
        q = scale_q * rng.standard_normal(lead + (n,))
    return np.concatenate([q, scale_qd * rng.standard_normal(lead + (n,))],
                          -1)


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import aba, forward_dynamics, rnea, rnea_grad
    from rbdtpu.kinematics.fk import ee_pose_gradient, ee_pose_hessian
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        Cost, DDPConfig, add_limit_barrier, ddp_solve, ee_reaching_cost,
        quadratic_tracking_cost, quadratize_trajectory,
    )
    from rbdtpu.solver.integrate import euler_semi_implicit

    rng = np.random.default_rng(SEED)
    out = {}
    A = lambda a: np.asarray(a)
    J = jnp.asarray
    load = lambda name, **kw: load_asset(name, dtype=np.float64, **kw)
    arm = load("arm7")
    quad = load("quadruped12", floating_base=True)
    quad_q = load("quadruped12", floating_base=True, root_quat=True)
    hum = load("humanoid30", floating_base=True)
    hum_q = load("humanoid30", floating_base=True, root_quat=True)
    models = {"arm7": arm, "quad": quad, "quad_q": quad_q}

    # ---- rnea_grad with joint damping ----
    for tag in ("arm7", "quad"):
        m = dataclasses.replace(models[tag], damping=J(
            DAMPING * (1.0 + np.arange(models[tag].nb))))
        x = states(m, rng, (3,), 0.5, 0.5)
        qdd = rng.standard_normal((3, m.nv))
        dcq, dcd = rnea_grad(m, J(x[:, :m.nq]), J(x[:, m.nq:]), J(qdd),
                             GRAVITY, use_damping=True, split=True)
        out.update({f"dmp_{tag}_damping": A(m.damping), f"dmp_{tag}_x": x,
                    f"dmp_{tag}_qdd": qdd, f"dmp_{tag}_dcq": A(dcq),
                    f"dmp_{tag}_dcd": A(dcd)})

    # ---- the EE pose's derivatives ----
    for tag, m, ee in (("arm7", arm, None), ("quad_knee", quad, ("FL_knee",)),
                       ("quad_foot", quad, ("RL_foot_fixed",))):
        q = rng.uniform(-0.8, 0.8, (3, m.nq))
        out.update({f"pose_{tag}_q": q,
                    f"pose_{tag}_grad": A(ee_pose_gradient(m, J(q),
                                                           ee_names=ee)),
                    f"pose_{tag}_hess": A(ee_pose_hessian(m, J(q),
                                                          ee_names=ee))})

    # ---- the limit barrier and the AD quadratisation ----
    names = ("lx", "lu", "lxx", "luu", "lux", "lfx", "lfxx")
    for tag in ("arm7", "quad_q"):
        m = models[tag]
        # q 1.5 N(0,1) passes the joints' limits, qd 8 N(0,1) the velocity
        # limits of 10 rad/s in places
        X = states(m, rng, (BQ, HQ + 1), 1.5, 8.0)
        U = rng.standard_normal((BQ, HQ, m.nv))
        base = quadratic_tracking_cost(m, J(goal_state(m)), **W)
        out.update({f"quad_{tag}_X": X, f"quad_{tag}_U": U})
        for kind, cost in (("barrier", add_limit_barrier(m, base)),
                           ("ad", Cost(base.stage, base.terminal))):
            got = quadratize_trajectory(cost, J(X), J(U), model=m)
            out.update({f"{kind}_{tag}_{k}": A(v) for k, v in zip(names, got)})
        x0 = states(m, rng, (BD,), 0.3, 0.0)
        U0 = 0.5 * rng.standard_normal((BD, HD, m.nv))
        cfg = DDPConfig(iters=ITERS, dt=DT, n_alphas=ALPHAS, fused=False)
        cost = Cost(base.stage, base.terminal)
        state, hist = jax.jit(lambda x, u: ddp_solve(m, cost, x, u, cfg))(
            J(x0), J(U0))
        out.update({f"ddp_{tag}_x0": x0, f"ddp_{tag}_U0": U0,
                    f"ddp_{tag}_U": A(state.U), f"ddp_{tag}_J": A(state.J),
                    f"ddp_{tag}_hist": A(hist)})

    # ---- rollout_multi's plain step, scanned ----
    def scan(m, route, x0, U, F):
        def step(x, u, fe):
            q, qd = x[:, :m.nq], x[:, m.nq:]
            fd = forward_dynamics if route == "minv" else aba
            qdd = fd(m, q, qd, u, f_ext=fe, gravity=GRAVITY)
            return euler_semi_implicit(m, x, qdd, DT)

        step = jax.jit(step)
        x = J(x0)
        for t in range(U.shape[0]):
            x = step(x, J(U[t]), None if F is None else J(F[t]))
        return A(x)

    for tag, m in (("quad", quad), ("hum", hum), ("hum_q", hum_q)):
        x0 = states(m, rng, (BR,), 0.05, 0.3)
        z = np.zeros((BR, m.nv))
        hold = A(rnea(m, J(x0[:, :m.nq]), J(z), J(z))[0])
        U = hold[None] + 0.2 * rng.standard_normal((HR, BR, m.nv))
        # 0.5 N(0,1) wrenches, chip_smoke's: at 5 N(0,1) the rpy humanoid's
        # light links spin up to |x| ~ 1e7 within the 6 steps
        F = 0.5 * rng.standard_normal((HR, m.nb, 6))
        out.update({f"roll_{tag}_x0": x0, f"roll_{tag}_U": U,
                    f"roll_{tag}_F": F})
        for route in ("aba", "minv"):
            out[f"roll_{tag}_{route}"] = scan(m, route, x0, U, None)
            out[f"roll_{tag}_{route}_fext"] = scan(m, route, x0, U, F)

    # ---- path M's EE cost, analytic quadratisation, on the rpy humanoid ----
    X = states(hum, rng, (BQ, HQ + 1), 0.3, 0.5)
    U = rng.standard_normal((BQ, HQ, hum.nv))
    cost = ee_reaching_cost(hum, J(np.array(TARGET_M)), ee_names=list(EE_M),
                            fused=False, **WM)
    got = quadratize_trajectory(cost, J(X), J(U), model=hum)
    out.update({"ee_hum_X": X, "ee_hum_U": U,
                "ee_hum_stage": A(cost.stage(J(X[:, :-1]), J(U),
                                             jnp.arange(HQ))),
                "ee_hum_terminal": A(cost.terminal(J(X[:, -1])))})
    out.update({f"ee_hum_{k}": A(v) for k, v in zip(names, got)})
    return out


if __name__ == "__main__":
    import time

    t0 = time.perf_counter()
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH} in {time.perf_counter() - t0:.0f} s")
