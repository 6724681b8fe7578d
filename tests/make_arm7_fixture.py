"""Record rbdtpu's arm-class solver on small problems: its backward-pass
strategies, ddp_solve on each route and its receding-horizon MPC loop, the
references that tests/test_torch_mpc.py and tests/test_torch_ddp.py hold
the port against:

    JAX_PLATFORMS=cpu python tests/make_arm7_fixture.py

writes tests/data/arm7_solver_refs.npz (about ten minutes, most of it
compiling), every input made from SEED by numpy, float64:

- ``k11_knot_*`` / ``k11_const_*``: rbdtpu's lane-scalar Riccati kernel
  (kernels/riccati.py backward_pass_fused, Pallas in interpret mode, as its
  own tests/test_kernels.py runs it) at nx=6, nv=3, H=5, B=8, with per-knot
  cost blocks and one problem whose Quu is not positive definite, and with
  constant blocks;
- ``par1_*`` / ``par3_*``: rbdtpu's backward_pass_parallel on
  tests/test_parallel_riccati.py's random LQR problems (one at H=24, nx=6,
  nu=3; three stacked at H=10, nx=4, nu=2);
- ``ddpf_*``: ddp_solve with fused_riccati=True as tests/test_kernels.py
  runs it (arm7, EE target [0.3, 0.2, 0.6], B=8, H=6, 3 iterations,
  4 line-search steps), the rest of the solve on rbdtpu's jnp route;
- ``ddp_*``: ddp_solve on configs[2]'s cost (B=2, H=8, 3 iterations,
  8 line-search steps) from ``ddp_x0``/``ddp_U0``, on rbdtpu's jnp route
  (``ddp_plain_*``) and with parallel_riccati=True (``ddp_parallel_*``);
- ``mpc_plain_*`` / ``mpc_parallel_*``: mpc_run as
  examples/mpc_reaching.py runs it (configs[2]'s cost, dt=0.01,
  4 line-search steps) cut to H=8, 5 ticks and 2 iterations, from one
  start at rest with gravity compensation, on the sequential sweep and on
  the parallel scan.
"""
import os

import numpy as np

from riccati_problems import riccati_problem

SEED = 20261017
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "arm7_solver_refs.npz")
TARGET = (0.3, 0.2, 0.8)
WEIGHTS = dict(w_ee=10.0, w_ee_f=2000.0, w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)
# the lane-scalar kernel's case: (nx, nv, H, B) and the non-PD (problem, knot)
K11_SHAPE, K11_NON_PD = (6, 3, 5, 8), (5, 2)
# ddp_solve with fused_riccati=True (tests/test_kernels.py:310-330)
DDPF = dict(target=(0.3, 0.2, 0.6), B=8, H=6,
            cfg=dict(iters=3, dt=0.01, n_alphas=4))
# ddp_solve on configs[2]'s cost, plain and with parallel_riccati=True
DDP = dict(B=2, H=8, cfg=dict(iters=3, dt=0.01, n_alphas=8))
# mpc_run: horizon, ticks, and the solver's settings
MPC_H, MPC_TICKS = 8, 5
MPC_CFG = dict(iters=2, dt=0.01, n_alphas=4)
RICCATI_ARGS = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "lfx", "lfxx",
                "reg")


def _random_lqr(rng, H, nx, nu):
    """tests/test_parallel_riccati.py's problem generator."""
    A = np.stack([np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
                  for _ in range(H)])
    B = 0.1 * rng.standard_normal((H, nx, nu))
    lx = rng.standard_normal((H, nx))
    lu = rng.standard_normal((H, nu))
    mk_psd = lambda n: (lambda M: M @ M.T + 0.5 * np.eye(n))(
        0.3 * rng.standard_normal((n, n)))
    lxx = np.stack([mk_psd(nx) for _ in range(H)])
    luu = np.stack([mk_psd(nu) for _ in range(H)])
    lux = 0.1 * rng.standard_normal((H, nu, nx))
    lfx = rng.standard_normal(nx)
    lfxx = mk_psd(nx)
    return A, B, lx, lu, lxx, luu, lux, lfx, lfxx


def lqr_problems(rng):
    """(one problem with reg, three stacked with their regs)."""
    one = _random_lqr(rng, 24, 6, 3) + (np.asarray(1e-6),)
    many = [_random_lqr(rng, 10, 4, 2) for _ in range(3)]
    three = tuple(np.stack([p[i] for p in many]) for i in range(9))
    return one, three + (np.full(3, 1e-6),)


def arm_start(q0, H, rnea_fn):
    """At rest at q0 (..., nq) with gravity compensation at every knot."""
    z = np.zeros_like(q0)
    x0 = np.concatenate([q0, z], -1)
    u = np.asarray(rnea_fn(q0, z, z))
    U0 = np.broadcast_to(u[..., None, :], q0.shape[:-1] + (H, q0.shape[-1]))
    return x0, U0.copy()


def reference() -> dict:
    """rbdtpu's results, with the inputs that made them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.kernels.riccati import backward_pass_fused
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        DDPConfig, ddp_solve, ee_reaching_cost, mpc_run,
    )
    from rbdtpu.solver.parallel_riccati import backward_pass_parallel

    rng = np.random.default_rng(SEED)
    out = {}
    rnea_fn = lambda q, qd, qdd: rnea(m, jnp.asarray(q), jnp.asarray(qd),
                                      jnp.asarray(qdd))[0]

    def record(prefix, names, arrays):
        for n, a in zip(names, arrays):
            out[f"{prefix}{n}"] = np.asarray(a)

    nx, nv, H, B = K11_SHAPE
    for prefix, const, non_pd in (("k11_knot_", False, K11_NON_PD),
                                  ("k11_const_", True, None)):
        args = riccati_problem(rng, nx, nv, H, B, const, non_pd)
        res = backward_pass_fused(*(jnp.asarray(a) for a in args),
                                  interpret=True)
        record(prefix, RICCATI_ARGS, args)
        record(prefix, ("k", "K", "dV1", "ok"), res)

    par = jax.jit(backward_pass_parallel)
    for prefix, args in zip(("par1_", "par3_"), lqr_problems(rng)):
        record(prefix, RICCATI_ARGS, args)
        record(prefix, ("k", "K", "dV1", "ok"),
               par(*(jnp.asarray(a) for a in args)))

    m = load_asset("arm7", dtype=np.float64)
    solve = lambda cost, cfg: jax.jit(
        lambda x, U: ddp_solve(m, cost, x, U, cfg))
    x0, U0 = arm_start(rng.uniform(-0.3, 0.3, (DDPF["B"], m.nq)), DDPF["H"],
                       rnea_fn)
    cost = ee_reaching_cost(m, jnp.array(DDPF["target"]))
    st, hist = solve(cost, DDPConfig(fused_riccati=True, **DDPF["cfg"]))(
        x0, U0)
    record("ddpf_", ("x0", "U0", "U", "J", "J_hist"),
           (x0, U0, st.U, st.J, hist))

    cost = ee_reaching_cost(m, jnp.array(TARGET), **WEIGHTS)
    x0, U0 = arm_start(0.3 * rng.standard_normal((DDP["B"], m.nq)),
                       DDP["H"], rnea_fn)
    out["ddp_x0"], out["ddp_U0"] = x0, U0
    for name, par_ in (("plain", False), ("parallel", True)):
        st, hist = solve(cost, DDPConfig(parallel_riccati=par_,
                                         **DDP["cfg"]))(x0, U0)
        record(f"ddp_{name}_", ("U", "J", "J_hist", "reg"),
               (st.U, st.J, hist, st.reg))

    x0, U0 = arm_start(0.3 * rng.standard_normal(m.nq), MPC_H, rnea_fn)
    out["mpc_x0"], out["mpc_U0"] = x0, U0
    for name, par_ in (("plain", False), ("parallel", True)):
        cfg = DDPConfig(parallel_riccati=par_, **MPC_CFG)
        carry, (U_app, J_hist) = jax.jit(lambda x, U: mpc_run(
            m, cost, x, U, MPC_TICKS, cfg))(x0, U0)
        record(f"mpc_{name}_", ("x", "U", "U_applied", "J_hist"),
               (carry.x, carry.U, U_app, J_hist))
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
