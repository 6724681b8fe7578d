"""Record rbdtpu's reference-compatible mirror (``rbdtpu.compat``), which
tests/test_torch_compat.py holds the port's ``RBDReferenceTorch`` against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_compat_fixture.py

writes tests/data/compat_refs.npz: every ``RBDReferenceTPU`` method,
called as ``calls`` calls it, on arm7, the rpy quadruped and the
quaternion humanoid (each with joint damping DAMPING), in float64 on one
state a model made by numpy from SEED (``calls``, the models, the state
and the constants are ``rbdtpu_torch.oracle.compat_calls``, which the
port's tests and chip_smoke.py share).  A call that rbdtpu refuses on a
model (it raises) is recorded by
name under ``<model>/refused``; the test then requires the port to refuse
it too.  Chained calls (the passes fed by ``rnea`` and ``minv_bpass``)
take their inputs from the same mirror, rbdtpu's here and the port's in
the test.
"""
import os
import time

import numpy as np

from rbdtpu_torch.oracle.compat_calls import DAMPING, MODELS, calls, state

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "compat_refs.npz")


def main():
    import dataclasses

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.compat import RBDReferenceTPU
    from rbdtpu.model import load_asset

    out = {}
    for tag, (name, kw) in MODELS.items():
        m = load_asset(name, dtype=np.float64, **kw)
        m = dataclasses.replace(m, damping=jnp.full_like(m.damping, DAMPING))
        c = RBDReferenceTPU(m)
        s = state(tag, m.nq, m.nv, m.nb)
        for k, v in s.items():
            out[f"{tag}/in/{k}"] = v
        refused = []
        for call, fn in calls(c, tag, s):
            t0 = time.perf_counter()
            try:
                res = fn()
            except (ValueError, NotImplementedError, TypeError) as e:
                refused.append(call)
                print(f"{tag} {call}: refused ({type(e).__name__}: {e})")
                continue
            for i, r in enumerate(res):
                out[f"{tag}/{call}/{i}"] = np.asarray(r, dtype=np.float64)
            print(f"{tag} {call}: {len(res)} outputs, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[f"{tag}/refused"] = np.array(refused, dtype=str)
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
