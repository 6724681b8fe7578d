"""Record rbdtpu's sharded solves (``rbdtpu.distrib``), which
tests/test_torch_distrib.py holds the port's two gloo ranks against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_distrib_fixture.py

writes tests/data/distrib_refs.npz, float64, arm7, every input made by
numpy from SEED, on rbdtpu's 8-virtual-device CPU mesh at the shapes of
tests/test_distrib.py:25-88 and tests/test_multihost.py:33-74:

- ``rollouts``: ``sharded_rollouts``, B = 16, H = 5, over "batch";
- ``ddp``: ``sharded_ddp_solve``, B = 8, H = 6, 2 iterations, 3 steps,
  tracking toward q = 0.2 at rest, over "batch";
- ``ddp_fused``: the same with ``fused=True`` (rbdtpu's Pallas kernels in
  interpret mode), B = 16, H = 5, 4 steps;
- ``ddp_2d``: ``sharded_ddp_solve`` on the 2-D ("host", "batch") mesh
  (2, 4), B = 16, H = 6, the batch over both axes;
- ``mppi`` (32 samples, sigma 0.3, dt 0.02, H = 5, over "batch") and
  ``mppi_2d`` (64 samples, sigma 0.4, over ("host", "batch")):
  ``sharded_mppi_step``, with each device's standard normals
  (``normal(fold_in(key, axis_index))``, (8, local_n, H, nv)), so that the
  port's ranks can take the same draws.
"""
import os
import time

import numpy as np

SEED = 20261102
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "distrib_refs.npz")
DEVICES = 8
# name -> (B, H, iterations, steps, fused) of the DDP cases
DDP = {"ddp": (8, 6, 2, 3, False), "ddp_fused": (16, 5, 2, 4, True),
       "ddp_2d": (16, 6, 2, 3, False)}
DDP_DT, GOAL_Q = 0.02, 0.2
# name -> (samples, sigma, H, key) of the MPPI cases
MPPI = {"mppi": (32, 0.3, 5, 1), "mppi_2d": (64, 0.4, 5, 0)}
MPPI_DT = 0.02
ROLL_B, ROLL_H, ROLL_DT = 16, 5, 0.01


def inputs(nq: int, nv: int) -> dict:
    """Every case's inputs from SEED."""
    rng = np.random.default_rng(SEED)
    nx = nq + nv
    out = {"rollouts/x0": rng.uniform(-0.3, 0.3, (ROLL_B, nx)),
           "rollouts/U": rng.uniform(-1, 1, (ROLL_B, ROLL_H, nv))}
    for name, (B, H, _, _, _) in DDP.items():
        out[f"{name}/x0"] = rng.uniform(-0.2, 0.2, (B, nx))
        out[f"{name}/U0"] = np.zeros((B, H, nv))
    for name, (_, _, H, _) in MPPI.items():
        out[f"{name}/x0"] = rng.uniform(-0.3, 0.3, nx)
        out[f"{name}/U0"] = 0.1 * rng.standard_normal((H, nv))
    return out


def main():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{DEVICES}")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.distrib import (
        make_mesh, sharded_ddp_solve, sharded_mppi_step, sharded_rollouts,
    )
    from rbdtpu.model import load_asset
    from rbdtpu.solver import (
        DDPConfig, MPPIConfig, pack_state, quadratic_tracking_cost,
    )

    assert len(jax.devices()) == DEVICES, jax.devices()
    arm = load_asset("arm7", dtype=np.float64)
    mesh1 = make_mesh(DEVICES)
    mesh2 = make_mesh(DEVICES, axis_names=("host", "batch"), shape=(2, 4))
    meshes = {"batch": (mesh1, "batch"),
              "2d": (mesh2, ("host", "batch"))}
    out = inputs(arm.nq, arm.nv)
    J = lambda k: jnp.asarray(out[k])

    t0 = time.perf_counter()
    out["rollouts/X"] = np.asarray(sharded_rollouts(
        mesh1, arm, J("rollouts/x0"), J("rollouts/U"), ROLL_DT))
    print(f"rollouts: {time.perf_counter() - t0:.1f} s", flush=True)

    goal = pack_state(jnp.full(arm.nq, GOAL_Q), jnp.zeros(arm.nv))
    cost = quadratic_tracking_cost(arm, goal)
    for name, (B, H, iters, alphas, fused) in DDP.items():
        t0 = time.perf_counter()
        mesh, axis = meshes["2d" if name.endswith("2d") else "batch"]
        cfg = DDPConfig(iters=iters, dt=DDP_DT, n_alphas=alphas, fused=fused)
        Js, Us, mean_J = sharded_ddp_solve(mesh, arm, cost, J(f"{name}/x0"),
                                           J(f"{name}/U0"), cfg, axis=axis)
        out[f"{name}/J"], out[f"{name}/U"] = np.asarray(Js), np.asarray(Us)
        out[f"{name}/mean_J"] = np.asarray(mean_J)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)

    mppi_cost = quadratic_tracking_cost(arm, jnp.zeros(arm.nx))
    for name, (S, sigma, H, key) in MPPI.items():
        t0 = time.perf_counter()
        mesh, axis = meshes["2d" if name.endswith("2d") else "batch"]
        cfg = MPPIConfig(n_samples=S, sigma=sigma, dt=MPPI_DT)
        k = jax.random.PRNGKey(key)
        U1, J_mean = sharded_mppi_step(mesh, arm, mppi_cost, J(f"{name}/x0"),
                                       J(f"{name}/U0"), k, cfg, axis=axis)
        # each device's draws as sharded_mppi_step makes them
        # (rbdtpu/distrib/sharded.py:105-109), device index linearised
        # over the reduced axes
        local_n = S // DEVICES
        out[f"{name}/noise"] = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(k, idx), (local_n, H, arm.nv), jnp.float64))
            for idx in range(DEVICES)])
        out[f"{name}/U"], out[f"{name}/J_mean"] = (np.asarray(U1),
                                                   np.asarray(J_mean))
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)

    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
