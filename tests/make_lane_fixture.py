"""Record rbdtpu's model-specialised kernel code (K0), the reference that
tests/test_torch_lanescalar.py holds the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_lane_fixture.py

writes tests/data/lane_refs.npz.  Everything is float64, its inputs made by
numpy from SEED, at B states:

- on arm7, the rpy quadruped, the quaternion quadruped and the rpy
  humanoid: rbdtpu's ``ModelStatic`` fields (``kernels.fused.get_static``)
  and its lane sweeps run eagerly on (B,) arrays: ``rnea_lane`` with and
  without qdd and wrenches, ``aba_lane`` with and without wrenches,
  ``minv_lane`` on ``_body_xc``'s transforms, and ``_step_lane`` on the
  "aba" route, the factorised "minv" route and the dense one, each with
  and without wrenches; and the number of operations rbdtpu traces for
  ``rnea_lane`` (with qdd) and for ``_step_lane`` on each route (the
  equations of its jaxpr), which the port's generator must emit too;
- on arm7 and the rpy quadruped, rbdtpu's Pallas kernels in interpret
  mode, as its own CPU tests run them: ``rnea_fused`` (bias and with qdd),
  ``fd_step_fused`` (bare, one (nb, 6) wrench set, one a state),
  ``fd_step_minv_fused`` (both routes, bare, the factorised route under one
  set and the dense one under one a state) and ``rollout_fused_multi``
  (H knots, both routes, with and without (H, nb, 6) wrenches).
"""
import os

import numpy as np

SEED = 20261018
B, H = 4, 6
DT, GRAVITY = 0.01, -9.81
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "lane_refs.npz")
# (key, asset, floating_base, root_quat, interpret-mode kernels)
MODELS = (("arm7", "arm7", False, False, True),
          ("quad_rpy", "quadruped12", True, False, True),
          ("quad_quat", "quadruped12", True, True, False),
          ("hum_rpy", "humanoid30", True, False, False))
FIELDS = ("nb", "parent", "jtype", "fb", "quat", "axis", "Xtree", "I", "S",
          "Ttree", "T_fixed", "nv", "nq")


def inputs(nq: int, nv: int, nb: int, quat: bool, rng) -> dict:
    """The states of one model: q (a unit root quaternion on the quaternion
    root), qd, qdd, u, wrenches (nb, 6), (B, nb, 6), (H, nb, 6), and the
    rollout's x0 and U (H, B, nv)."""
    q = 0.3 * rng.standard_normal((B, nq))
    if quat:
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    x0 = np.concatenate([q, 0.1 * rng.standard_normal((B, nv))], 1)
    return dict(q=q, qd=0.5 * rng.standard_normal((B, nv)),
                qdd=0.5 * rng.standard_normal((B, nv)),
                u=rng.standard_normal((B, nv)),
                F1=0.5 * rng.standard_normal((nb, 6)),
                FB=0.5 * rng.standard_normal((B, nb, 6)),
                FH=0.5 * rng.standard_normal((H, nb, 6)),
                x0=x0, U=0.2 * rng.standard_normal((H, B, nv)))


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.kernels import fused as jf
    from rbdtpu.model import load_asset

    rng = np.random.default_rng(SEED)
    out = {}
    A = lambda a: np.asarray(a)
    J = jnp.asarray
    stack = lambda vals: np.stack([np.broadcast_to(A(v), (B,)) for v in vals],
                                  -1)
    for key, asset, fb, quat, kernels in MODELS:
        m = load_asset(asset, dtype=np.float64, floating_base=fb,
                       root_quat=quat)
        ms = jf.get_static(m)
        for f in FIELDS:
            val = getattr(ms, f)
            out[f"{key}/static/{f}"] = np.asarray(
                [] if val is None else val, dtype=np.float64)
        inp = inputs(ms.nq, ms.nv, ms.nb, quat, rng)
        out.update({f"{key}/in/{k}": v for k, v in inp.items()})
        cols = lambda a: [J(a[:, i]) for i in range(a.shape[1])]
        q, qd, qdd, u = (cols(inp[k]) for k in ("q", "qd", "qdd", "u"))
        fe = jf._fext_lists(ms, cols(inp["FB"].reshape(B, -1)))
        for tag, acc, f in (("bias", None, None), ("qdd", qdd, None),
                            ("bias_fext", None, fe), ("qdd_fext", qdd, fe)):
            out[f"{key}/rnea_{tag}"] = stack(
                jf.rnea_lane(ms, q, qd, acc, GRAVITY, f_ext=f))
        for tag, f in (("", None), ("_fext", fe)):
            out[f"{key}/aba{tag}"] = stack(
                jf.aba_lane(ms, q, qd, u, GRAVITY, f_ext=f))
        X = [jf._body_xc(ms, i, q) for i in range(ms.nb)]
        out[f"{key}/minv"] = np.stack(
            [stack(row) for row in jf.minv_lane(ms, X)], 1)
        for route, dense in (("aba", False), ("minv", False),
                             ("dense", True)):
            for tag, f in (("", None), ("_fext", fe)):
                qn, qdn = jf._step_lane(
                    ms, q, qd, u, DT, GRAVITY,
                    "aba" if route == "aba" else "minv", dense_minv=dense,
                    f_ext=f)
                out[f"{key}/step_{route}{tag}"] = stack(list(qn) + list(qdn))
        # operations traced a state (the equations of the lane code's jaxpr)
        eqns = lambda fn, *a: len(jax.make_jaxpr(fn)(*a).jaxpr.eqns)
        J1 = lambda a: [J(a[0, i]) for i in range(a.shape[1])]
        out[f"{key}/ops/rnea_qdd"] = np.asarray(eqns(
            lambda a, b, c: jf.rnea_lane(ms, a, b, c, GRAVITY),
            J1(inp["q"]), J1(inp["qd"]), J1(inp["qdd"])))
        for route, dense in (("aba", False), ("minv", False),
                             ("dense", True)):
            out[f"{key}/ops/{route}"] = np.asarray(eqns(
                lambda a, b, c, r=route, d=dense: jf._step_lane(
                    ms, a, b, c, DT, GRAVITY, "aba" if r == "aba" else "minv",
                    dense_minv=d),
                J1(inp["q"]), J1(inp["qd"]), J1(inp["u"])))
        if not kernels:
            continue
        x = np.concatenate([inp["q"], inp["qd"]], 1)
        out[f"{key}/k10_bias"] = A(jf.rnea_fused(
            m, J(inp["q"]), J(inp["qd"]), None, GRAVITY, interpret=True))
        out[f"{key}/k10_qdd"] = A(jf.rnea_fused(
            m, J(inp["q"]), J(inp["qd"]), J(inp["qdd"]), GRAVITY,
            interpret=True))
        for tag, f in (("", None), ("_f1", "F1"), ("_fb", "FB")):
            out[f"{key}/k1{tag}"] = A(jf.fd_step_fused(
                m, J(x), J(inp["u"]), DT, GRAVITY, interpret=True,
                f_ext=None if f is None else J(inp[f])))
        for tag, dense, f in (("fact", False, None), ("dense", True, None),
                              ("fact_f1", False, "F1"),
                              ("dense_fb", True, "FB")):
            out[f"{key}/k6_{tag}"] = A(jf.fd_step_minv_fused(
                m, J(x), J(inp["u"]), DT, GRAVITY, interpret=True,
                dense_minv=dense, f_ext=None if f is None else J(inp[f])))
        for route in ("aba", "minv"):
            for tag, f in (("", None), ("_fh", "FH")):
                out[f"{key}/k5_{route}{tag}"] = A(jf.rollout_fused_multi(
                    m, J(inp["x0"]), J(inp["U"]), DT, GRAVITY, route=route,
                    interpret=True, f_ext=None if f is None else J(inp[f])))
    return out


if __name__ == "__main__":
    import time

    start = time.perf_counter()
    refs = reference()
    np.savez_compressed(PATH, **refs)
    print(f"wrote {PATH}: {len(refs)} arrays in "
          f"{time.perf_counter() - start:.1f} s")
