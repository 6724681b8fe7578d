"""Record rbdtpu's chunked-gain line search (K9,
``kernels.fused.feedback_rollout_fused_chunked``, in Pallas interpret mode
through its own ``solver.ddp.forward_pass_fused(nchunks=c)``), the reference
that tests/test_torch_chunked.py holds the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_chunked_fixture.py

writes tests/data/chunked_refs.npz (about three minutes: 6.5-14 s a case).
Cases: nchunks in CHUNKS, with and without an effort clamp, on arm7 (B=3
problems, so rbdtpu pads its lane batch of 6 to 8) and on quadruped12's rpy
root (B=2), H=4 knots, 2 step sizes, float64, inputs made by numpy from
SEED: a nominal trajectory, controls, and gains and feedforward terms of
scale 0.1."""
import os

import numpy as np

SEED = 20261019
H, DT, ALPHAS = 4, 0.01, (1.0, 0.5)
CHUNKS = (1, 2, 3, 99)
CLIP = 5.0
MODELS = {"arm7": 3, "quadruped12": 2}  # name -> problems
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "chunked_refs.npz")


def inputs(name, nq, rng) -> dict:
    """A nominal trajectory X (B, H+1, nx), controls U, feedforward k
    (B, H, nv) and gains K (B, H, nv, nx), and the goal of the tracking
    cost that scores the candidates."""
    B, nx = MODELS[name], 2 * nq
    X = 0.1 * rng.standard_normal((B, H + 1, nx))
    goal = np.zeros(nx)
    if name != "arm7":
        X[..., 2] += 0.35
        goal[2] = 0.4
    return dict(X=X, U=rng.standard_normal((B, H, nq)),
                k=0.1 * rng.standard_normal((B, H, nq)),
                K=0.1 * rng.standard_normal((B, H, nq, nx)), goal=goal)


def case_key(name, nchunks, clip) -> str:
    return f"{name}/c{nchunks}/{'clip' if clip else 'free'}"


def solve_case(m, arrays, nchunks, clip):
    """rbdtpu's forward_pass_fused with the chunked kernel (interpret
    mode): (X, U, J) of every step size."""
    import jax.numpy as jnp

    from rbdtpu.solver import quadratic_tracking_cost
    from rbdtpu.solver.ddp import forward_pass_fused

    cost = quadratic_tracking_cost(m, jnp.asarray(arrays["goal"]))
    u_clip = np.full(m.nv, CLIP) if clip else None
    out = forward_pass_fused(
        m, cost, *(jnp.asarray(arrays[k]) for k in ("X", "U", "k", "K")),
        jnp.asarray(ALPHAS), DT, -9.81, u_clip=u_clip, nchunks=nchunks)
    return tuple(np.asarray(a) for a in out)


def models():
    from rbdtpu.model import load_asset

    return {"arm7": load_asset("arm7", dtype=np.float64),
            "quadruped12": load_asset("quadruped12", dtype=np.float64,
                                      floating_base=True)}


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(SEED)
    out = {}
    for name, m in models().items():
        arrays = inputs(name, m.nq, rng)
        out.update({f"{name}/{k}": v for k, v in arrays.items()})
        for c in CHUNKS:
            for clip in (False, True):
                X, U, J = solve_case(m, arrays, c, clip)
                key = case_key(name, c, clip)
                out.update({f"{key}/X": X, f"{key}/U": U, f"{key}/J": J})
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
