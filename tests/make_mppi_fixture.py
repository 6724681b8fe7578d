"""Record rbdtpu's MPPI updates, the reference that tests/test_torch_mppi.py
holds the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_mppi_fixture.py

writes tests/data/mppi_refs.npz (about a minute and a half).  Each case is
rbdtpu's ``mppi_step`` (or ``mppi_solve`` over ``iters``) on B=4 problems,
H=4 knots, float64, from inputs made by numpy from SEED, with the standard
normals rbdtpu drew (``jax.random.normal`` of each iteration's key, which
rbdtpu scales by sigma) recorded beside its result, so the port can be fed
the same draws.  The cases are chosen so that each branch of the acceptance
guard wins for some problem: the weighted update (``update``), the best
sample (``best``: a temperature so high that the weights are uniform), and
the nominal (``nominal``: with ``u_limits`` the samples are clipped to the
effort box, while the nominal plan, beyond the box, drives exactly to the
goal and wins the full-precision re-score of ``sampling_dtype``).
"""
import os

import numpy as np

SEED = 20261017
B, H = 4, 4
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "mppi_refs.npz")
ARM_W = dict(w_q=1.0, w_qd=0.1, w_u=1e-4)
QUAD_W = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
# name -> (model, start, MPPIConfig fields, iterations (None: one
# mppi_step), key seed).  Starts: "zeros" (zero controls), "hold" (gravity
# compensation), "beyond"
# (controls of 400 on the first joint, beyond the 300 effort box, and the
# goal their rollout reaches)
CASES = {
    "arm7_update": ("arm7", "zeros", dict(n_samples=8, sigma=0.1), None, 1),
    "arm7_best": ("arm7", "hold", dict(n_samples=16, sigma=0.1,
                                       temperature=1e4), None, 2),
    "arm7_limits": ("arm7", "beyond", dict(n_samples=8, sigma=0.1,
                                           u_limits=True), None, 3),
    "arm7_nominal": ("arm7", "beyond", dict(
        n_samples=8, sigma=0.1, u_limits=True, sampling_dtype="float32"),
        None, 4),
    "arm7_solve": ("arm7", "zeros", dict(n_samples=8, sigma=0.1), 3, 5),
    "arm7_float32": ("arm7", "zeros", dict(
        n_samples=16, sigma=0.1, sampling_dtype="float32"), 2, 6),
    "quad_update": ("quadruped12", "hold", dict(n_samples=8, sigma=0.1),
                    None, 7),
    "quad_limits": ("quadruped12", "hold", dict(
        n_samples=8, sigma=200.0, u_limits=True), None, 8),
    "quad_solve": ("quadruped12", "hold", dict(n_samples=8, sigma=0.1), 2, 9),
    "quad_float32": ("quadruped12", "hold", dict(
        n_samples=8, sigma=0.1, sampling_dtype="float32"), 2, 10),
}


def inputs(name, start, rng, rnea, rollout):
    """(x0, U0, goal) as numpy arrays; ``rnea`` and ``rollout`` take and
    return numpy arrays for model ``name``.  arm7 starts bent (0.5 N(0,1)
    angles, at rest) and its goal is to hold problem 0's start, which
    zero controls lose to gravity; the quadruped stands at q[2] = 0.35 and
    its goal is to rise to 0.4."""
    fb = name != "arm7"
    nq = 18 if fb else 7
    q0 = np.zeros((B, nq))
    if fb:
        q0[:, 2] = 0.35
        q0 += 0.05 * rng.standard_normal(q0.shape)
    else:
        q0 += 0.5 * rng.standard_normal(q0.shape)
    z = np.zeros((B, nq))
    x0 = np.concatenate([q0, z], -1)
    goal = np.zeros(2 * nq)
    if fb:
        goal[2] = 0.4
    else:
        goal[:nq] = q0[0]
    if start == "zeros":
        U0 = np.zeros((B, H, nq))
    elif start == "hold":
        U0 = np.repeat(rnea(q0)[:, None], H, axis=1)
    else:
        U0 = np.zeros((B, H, nq))
        U0[..., 0] = 400.0
        goal = rollout(x0[:1], U0[:1])[0, -1]
    return x0, U0, goal


def reference() -> dict:
    """rbdtpu's result of every case, with its inputs and draws."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        MPPIConfig, mppi_solve, mppi_step, quadratic_tracking_cost, rollout,
    )

    models = {"arm7": load_asset("arm7", dtype=np.float64),
              "quadruped12": load_asset("quadruped12", dtype=np.float64,
                                        floating_base=True)}
    rng = np.random.default_rng(SEED)
    out = {}
    for case, (name, start, fields, iters, seed) in CASES.items():
        m = models[name]
        zq = lambda q: jnp.zeros_like(jnp.asarray(q))
        x0, U0, goal = inputs(
            name, start, rng,
            lambda q: np.asarray(rnea(m, jnp.asarray(q), zq(q), zq(q))[0]),
            lambda x, U: np.asarray(rollout(m, jnp.asarray(x),
                                            jnp.asarray(U), 0.01)))
        cost = quadratic_tracking_cost(
            m, jnp.asarray(goal), **(ARM_W if name == "arm7" else QUAD_W))
        cfg = MPPIConfig(**fields)
        key = jax.random.PRNGKey(seed)
        shape = (B, cfg.n_samples, H, m.nv)
        if iters is None:
            U, J = mppi_step(m, cost, jnp.asarray(x0), jnp.asarray(U0), key,
                             cfg)
            noise = jax.random.normal(key, shape, jnp.float64)[None]
        else:
            U, J = mppi_solve(m, cost, jnp.asarray(x0), jnp.asarray(U0), key,
                              iters=iters, config=cfg)
            noise = jnp.stack([jax.random.normal(k, shape, jnp.float64)
                               for k in jax.random.split(key, iters)])
        for field, v in dict(x0=x0, U0=U0, goal=goal, noise=noise, U=U,
                             J=J).items():
            out[f"{case}/{field}"] = np.asarray(v)
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
