"""Record rbdtpu's second-order dynamics, the reference that
tests/test_torch_second_order.py holds the port against on the floating
roots:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_second_order_fixture.py

writes tests/data/second_order_refs.npz (about a minute).  Everything is
float64, its inputs made by numpy from SEED (q, qd, qdd uniform in
[-1, 1], the quaternion a normalised N(0, I_4)):

- ``idsva_so_native`` and ``fdsva_so`` on quadruped12 with the rpy root
  and with the quaternion root at B = 2 (rbdtpu's own tests hold its
  ``idsva_so_ad`` to its native sweep at 1e-10, so the native tensors are
  the reference of both of the port's sweeps);
- ``idsva_so_native`` on humanoid30 with the quaternion root at B = 1;
- ``ddp_solve(exact_hessians=True)`` on tests/test_idsva.py's two
  problems (:211-227 on the rpy quadruped, :269-290 on the quaternion
  one: H = 8, dt = 0.02, 6 iterations): the J history and U.
"""
import os

import numpy as np

SEED = 20261018
B_QUAD, B_HUM = 2, 1
H, DT, ITERS = 8, 0.02, 6
W = dict(w_q=5.0, w_qd=0.1, w_u=1e-4)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "second_order_refs.npz")


def states(rng, nq: int, nv: int, quat: bool, B: int):
    """(q, qd, qdd) at B states, uniform in [-1, 1]; a quaternion root's
    q[3:7] a normalised N(0, I_4)."""
    q = rng.uniform(-1.0, 1.0, (B, nq))
    if quat:
        r = rng.standard_normal((B, 4))
        q[:, 3:7] = r / np.linalg.norm(r, axis=-1, keepdims=True)
    return q, rng.uniform(-1.0, 1.0, (B, nv)), rng.uniform(-1.0, 1.0, (B, nv))


def ddp_problem(nq: int, nv: int, quat: bool, retract=None):
    """tests/test_idsva.py's exact-Hessian problems as numpy (x_goal, x0):
    standing at 0.35, the rpy one moved by 0.05 in height and its first
    joint by 0.2, the quaternion one retracted (``retract(q, xi)``) by 0.2
    about x and 0.05 along body z."""
    x_goal = np.zeros(nq + nv)
    x_goal[2] = 0.35
    if not quat:
        x0 = x_goal.copy()
        x0[2] += 0.05
        x0[6] += 0.2
        return x_goal, x0
    x_goal[3] = 1.0
    xi = np.zeros(nv)
    xi[5], xi[0] = 0.05, 0.2
    return x_goal, np.concatenate([retract(x_goal[:nq], xi), np.zeros(nv)])


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import fdsva_so, idsva_so_native
    from rbdtpu.model import load_asset
    from rbdtpu.solver import DDPConfig, ddp_solve, quadratic_tracking_cost
    from rbdtpu.solver.integrate import config_retract

    rng = np.random.default_rng(SEED)
    out = {}
    A = lambda a: np.asarray(a)
    J = jnp.asarray
    for tag, name, quat, B, fd in (
            ("rpy", "quadruped12", False, B_QUAD, True),
            ("quat", "quadruped12", True, B_QUAD, True),
            ("hum", "humanoid30", True, B_HUM, False)):
        m = load_asset(name, dtype=np.float64, floating_base=True,
                       root_quat=quat)
        q, qd, qdd = states(rng, m.nq, m.nv, quat, B)
        out.update({f"{tag}_q": q, f"{tag}_qd": qd, f"{tag}_qdd": qdd})
        for k, t in zip(("d2q", "d2qd", "dvdq", "dM"),
                        idsva_so_native(m, J(q), J(qd), J(qdd))):
            out[f"{tag}_native_{k}"] = A(t)
        if fd:
            for k, t in zip(("qq", "vq", "vv", "tq"),
                            fdsva_so(m, J(q), J(qd), J(qdd))):
                out[f"{tag}_fdsva_{k}"] = A(t)
        if tag == "hum":
            continue
        retract = lambda q_, xi: A(config_retract(m, J(q_), J(xi)))
        x_goal, x0 = ddp_problem(m.nq, m.nv, quat, retract)
        cost = quadratic_tracking_cost(m, J(x_goal), **W)
        state, hist = ddp_solve(
            m, cost, J(x0), jnp.zeros((H, m.nv)),
            DDPConfig(iters=ITERS, dt=DT, exact_hessians=True))
        out.update({f"{tag}_ddp_x0": x0, f"{tag}_ddp_goal": x_goal,
                    f"{tag}_ddp_U": A(state.U), f"{tag}_ddp_J": A(hist)})
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
