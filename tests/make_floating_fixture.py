"""Record rbdtpu's dynamics and transforms on the rpy floating root, the
references that tests/test_torch_floating.py holds the port against:

    JAX_PLATFORMS=cpu python tests/make_floating_fixture.py

writes tests/data/floating_rpy_refs.npz: quadruped12 with
floating_base=True, float64, B states made from SEED by numpy (q, qd and u
uniform in [-1, 1], world-frame wrenches fe uniform in [-1, 1] on every
body), and rbdtpu's RNEA (with the wrenches), ABA (with and without),
M^-1, forward dynamics, the split RNEA gradient at the ABA acceleration,
the root transforms and every body's joint transform, each computed
eagerly as the port's tests once computed them live."""
import os

import numpy as np

SEED = 20261017
B = 3
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "floating_rpy_refs.npz")


def reference() -> dict:
    """rbdtpu's outputs, with the inputs that made them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu import dynamics as jdyn
    from rbdtpu.dynamics import xforms as jxf
    from rbdtpu.model import load_asset
    from rbdtpu.spatial import transforms as jtf

    jm = load_asset("quadruped12", dtype=np.float64, floating_base=True)
    rng = np.random.default_rng(SEED)
    q = rng.uniform(-1.0, 1.0, (B, jm.nq))
    qd, u = rng.uniform(-1.0, 1.0, (2, B, jm.nv))
    fe = rng.uniform(-1.0, 1.0, (B, jm.nb, 6))
    qj, qdj, uj, fej = (jnp.asarray(a) for a in (q, qd, u, fe))
    qdd = jdyn.aba(jm, qj, qdj, uj)
    dcq, dcd = jdyn.rnea_grad(jm, qj, qdj, qdd, split=True)
    E = jnp.swapaxes(jtf.rpy_to_R(qj[:, 3:6]), -1, -2)
    out = {
        "q": q, "qd": qd, "u": u, "fe": fe,
        "rnea_fext": jdyn.rnea(jm, qj, qdj, uj, f_ext=fej)[0],
        "aba_fext": jdyn.aba(jm, qj, qdj, uj, f_ext=fej),
        "aba": qdd,
        "minv": jdyn.minv(jm, qj),
        "forward_dynamics": jdyn.forward_dynamics(jm, qj, qdj, uj),
        "rnea_grad_dq": dcq, "rnea_grad_dqd": dcd,
        "rpy_to_R": jtf.rpy_to_R(qj[:, 3:6]), "E": E,
        "plux": jtf.plux(E, qj[:, 0:3]),
        "hom": jtf.hom(E, qj[:, 0:3]),
        "floating_spatial_x": jtf.floating_spatial_x(jm.Xtree[0], qj[:, 0:6]),
        "floating_hom_T": jtf.floating_hom_T(jm.Ttree[0], qj[:, 0:6]),
        "joint_transforms_list": jnp.stack(jxf.joint_transforms_list(jm, qj)),
        "joint_transforms_hom_list": jnp.moveaxis(
            jxf.joint_transforms_hom(jm, qj), -3, 0),
        "q_per_joint": jxf.q_per_joint(jm, qj),
    }
    return {k: np.asarray(v) for k, v in out.items()}


if __name__ == "__main__":
    np.savez_compressed(PATH, **reference())
    print(f"wrote {PATH}")
