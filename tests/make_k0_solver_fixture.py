"""Record rbdtpu's model-specialised solver kernels (K0 of K2, K3 and K4),
the reference that tests/test_torch_lanescalar.py and
tests/test_torch_codegen.py hold the port against:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_k0_solver_fixture.py

writes tests/data/k0_solver_refs.npz.  Everything is float64, its inputs
made by numpy from SEED, on arm7, the rpy quadruped and the quaternion
quadruped (the quadrupeds' effector FL_knee):

- rbdtpu's lane sweeps run eagerly: ``_dx_rows`` on (B,) arrays,
  ``minv_colvec`` and both ``grad_pass_colvec`` sweeps on (1, B) lanes
  with its (C, 1) one-hot masks (C = nv rounded up to 8), at the ABA qdd
  and RNEA's v, a, f, and ``ee_chain_lane`` (the effector's position and
  its Jacobian columns);
- its Pallas kernels in interpret mode, as its own CPU tests run them:
  ``linearize_parts_fused``, ``ee_gn_fused`` with gn True and False, and
  ``feedback_rollout_fused`` at B x H with a clamp, and with the clamp and
  (H, nb, 6) wrenches;
- the equations of the jaxpr of each body on 0-d scalars (the one-hot
  masks inputs too), less its dtype conversions: K2's knot body
  (fused.py:695-709, its lines below in ``k2_body``), K3's
  (colvec.py:321-329) and K4's effector error (fk_lane.py:255-256);
- configs[2]'s ``ddp_solve`` at Bm x H_SOLVE with every kernel of its
  path (fused=True, fused_feedback=True, the cost's fused=True) in
  interpret mode, from gravity-compensated starts at rest.
"""
import os

import numpy as np

SEED = 20261019
B, H = 8, 4
DT, GRAVITY = 0.01, -9.81
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "k0_solver_refs.npz")
# (key, asset, floating_base, root_quat, effector, target)
MODELS = (("arm7", "arm7", False, False, None, (0.3, 0.2, 0.8)),
          ("quad_rpy", "quadruped12", True, False, "FL_knee",
           (0.3, 0.1, 0.1)),
          ("quad_quat", "quadruped12", True, True, "FL_knee",
           (0.3, 0.1, 0.1)))
U_CLIP = 0.8  # the clamp, a fraction of the recorded controls' scale
# configs[2]'s solve (chip_smoke.WEIGHTS, TARGET), cut to Bm x H_SOLVE
SOLVE = dict(Bm=2, H=8, iters=3, n_alphas=8)
WEIGHTS = dict(w_ee=10.0, w_ee_f=2000.0, w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)


def inputs(nq: int, nv: int, nb: int, quat: bool, rng) -> dict:
    """One model's inputs: q, qd, u (B states; a unit root quaternion on
    the quaternion root) and the line search's x0, X_nom (x0 moved by
    0.05 N(0,1) a knot), U_nom, k_ff, K_fb (0.1 N(0,1)) and (H, nb, 6)
    wrenches."""
    def unit(q):
        if quat:
            q[..., 3:7] /= np.linalg.norm(q[..., 3:7], axis=-1, keepdims=True)
        return q
    q = unit(0.3 * rng.standard_normal((B, nq)))
    x0 = np.concatenate([q, 0.1 * rng.standard_normal((B, nv))], 1)
    X_nom = x0[:, None] + 0.05 * rng.standard_normal((B, H, nq + nv))
    unit(X_nom)
    return dict(q=q, qd=0.5 * rng.standard_normal((B, nv)),
                u=rng.standard_normal((B, nv)), x0=x0, X_nom=X_nom,
                U_nom=rng.standard_normal((B, H, nv)),
                k_ff=0.1 * rng.standard_normal((B, H, nv)),
                K_fb=0.1 * rng.standard_normal((B, H, nv, 2 * nv)),
                FH=0.5 * rng.standard_normal((H, nb, 6)))


def k2_body(jf, ms, x, Xt, Ut, kt, Kt, fe, lims, dt, gravity):
    """rbdtpu's K2 knot body, kernels/fused.py:695-709 line for line (a
    closure there), with its clamp constants ``lims``."""
    import jax.numpy as jnp

    nq, nv = ms.nq, ms.nv
    ndx = 2 * nv
    dx = jf._dx_rows(ms, x, Xt)
    u = []
    for i in range(nv):
        acc = Ut[i] + kt[i]
        for j in range(ndx):
            acc = acc + Kt[i * ndx + j] * dx[j]
        if lims is not None and np.isfinite(lims[i]):
            acc = jnp.clip(acc, -lims[i], lims[i])
        u.append(acc)
    q_s, qd_s = x[:nq], x[nq:]
    qdd = jf.aba_lane(ms, q_s, qd_s, u, gravity, f_ext=fe)
    qd_new = [qd_s[i] + dt * qdd[i] for i in range(nv)]
    q_new = jf._integrate_q_lane(ms, q_s, qd_new, dt)
    return q_new, qd_new, u


def resolve(m, name):
    """(jid, fid) of rbdtpu's ee_gn_fused for one effector name (None: the
    single leaf)."""
    if name is None:
        leaves = [i for i in range(m.nb) if i not in set(m.parent)]
        return leaves[0], None
    if name in m.joint_names:
        return m.joint_names.index(name), None
    fid = m.fixed_frame_names.index(name)
    return m.fixed_frame_parent[fid], fid


def reference() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rbdtpu.dynamics import rnea
    from rbdtpu.kernels import colvec as jc
    from rbdtpu.kernels import fk_lane as jk
    from rbdtpu.kernels import fused as jf
    from rbdtpu.kernels import lanescalar as jls
    from rbdtpu.model import load_asset
    from rbdtpu.solver import DDPConfig, ddp_solve, ee_reaching_cost

    rng = np.random.default_rng(SEED)
    out = {}
    A = np.asarray
    J = jnp.asarray
    fill = lambda v, shape: np.broadcast_to(A(v), shape)
    # the operations of a body: its jaxpr's equations less the dtype
    # bookkeeping (convert_element_type) that jnp.where and jnp.maximum add
    # around Python constants
    eqns = lambda fn, *a: sum(
        e.primitive.name != "convert_element_type"
        for e in jax.make_jaxpr(fn)(*a).jaxpr.eqns)
    for key, asset, fb, quat, ee, target in MODELS:
        m = load_asset(asset, dtype=np.float64, floating_base=fb,
                       root_quat=quat)
        ms = jf.get_static(m)
        nq, nv, nb = ms.nq, ms.nv, ms.nb
        C = jc._pad8(nv)
        inp = inputs(nq, nv, nb, quat, rng)
        out.update({f"{key}/in/{k}": v for k, v in inp.items()})
        # ---- the lane sweeps ----
        lanes = lambda a: [J(a[:, i]) for i in range(a.shape[1])]
        rows = lambda a: [J(a[None, :, i]) for i in range(a.shape[1])]
        xs = lanes(inp["x0"])
        xn = lanes(inp["X_nom"][:, 0])
        out[f"{key}/dx_rows"] = np.stack(
            [fill(v, (B,)) for v in jf._dx_rows(ms, xs, xn)], -1)
        q_s, qd_s, u_s = rows(inp["q"]), rows(inp["qd"]), rows(inp["u"])
        X = [jf._body_xc(ms, i, q_s) for i in range(nb)]
        qdd = jf.aba_lane(ms, q_s, qd_s, u_s, GRAVITY, X=X)
        v, a, f, _ = jf._rnea_sweeps_lane(ms, X, qd_s, qdd, GRAVITY)
        oh = jc._make_oh(C, jnp.float64)
        colscalars = lambda vals: np.stack([fill(r, (C, B)) for r in vals])
        out[f"{key}/minv_colvec"] = colscalars(jc.minv_colvec(ms, X, oh))
        for wrt in ("q", "qd"):
            out[f"{key}/grad_{wrt}"] = colscalars(jc.grad_pass_colvec(
                ms, X, q_s, qd_s, v, a, f, oh, wrt, GRAVITY))
        jid, fid = resolve(m, ee)
        p_ee, cols = jk.ee_chain_lane(ms, lanes(inp["q"]), jid, fid,
                                      (0.0, 0.0, 0.0))
        out[f"{key}/ee_p"] = np.stack([fill(p, (B,)) for p in p_ee], -1)
        out[f"{key}/ee_vi"] = np.asarray([vi for vi, _ in cols])
        out[f"{key}/ee_cols"] = np.stack(
            [np.stack([fill(c, (B,)) for c in col], -1) for _, col in cols])
        # ---- the kernels in interpret mode ----
        out[f"{key}/k3"] = np.stack([A(t) for t in jc.linearize_parts_fused(
            m, J(inp["q"]), J(inp["qd"]), J(inp["u"]), GRAVITY,
            interpret=True)[:3]])
        out[f"{key}/k3_qdd"] = A(jc.linearize_parts_fused(
            m, J(inp["q"]), J(inp["qd"]), J(inp["u"]), GRAVITY,
            interpret=True)[3])
        names = None if ee is None else [ee]
        for gn in (True, False):
            res = jk.ee_gn_fused(m, J(inp["q"]), target, ee_names=names,
                                 gn=gn, interpret=True)
            for tag, r in zip(("e", "g0", "H0"), res):
                if r is not None:
                    out[f"{key}/k4_{'gn' if gn else 'err'}_{tag}"] = A(r)
        clip = np.full(nv, U_CLIP)
        for tag, F in (("clip", None), ("clip_fext", J(inp["FH"]))):
            Xr, Ur = jf.feedback_rollout_fused(
                m, J(inp["x0"]), J(inp["X_nom"]), J(inp["U_nom"]),
                J(inp["k_ff"]), J(inp["K_fb"]), DT, GRAVITY, u_clip=clip,
                interpret=True, f_ext=F)
            out[f"{key}/k2_{tag}_X"], out[f"{key}/k2_{tag}_U"] = A(Xr), A(Ur)
        # ---- the operations of each body, on 0-d scalars ----
        s0 = lambda a: [J(a[0, i]) for i in range(a.shape[1])]
        masks = [J(np.float64(i == 0)) for i in range(C)]
        for tag, with_fe in (("feedback", False), ("feedback_fext", True)):
            fe0 = [J(v) for v in inp["FH"][0].reshape(-1)]
            out[f"{key}/ops/{tag}"] = np.asarray(eqns(
                lambda x_, xt, ut, kt, Kt, fe_: k2_body(
                    jf, ms, x_, xt, ut, kt, Kt,
                    jf._fext_lists(ms, fe_) if with_fe else None, clip,
                    DT, GRAVITY),
                s0(inp["x0"]), s0(inp["X_nom"][:, 0]),
                s0(inp["U_nom"][:, 0]), s0(inp["k_ff"][:, 0]),
                s0(inp["K_fb"][:, 0].reshape(B, -1)), fe0))

        def k3_body(q_, qd_, u_, mk):
            X_ = [jf._body_xc(ms, i, q_) for i in range(nb)]
            qdd_ = jf.aba_lane(ms, q_, qd_, u_, GRAVITY, X=X_)
            v_, a_, f_, _ = jf._rnea_sweeps_lane(ms, X_, qd_, qdd_, GRAVITY)
            ohs = lambda i: mk[i]
            return (jc.minv_colvec(ms, X_, ohs),
                    jc.grad_pass_colvec(ms, X_, q_, qd_, v_, a_, f_, ohs,
                                        "q", GRAVITY),
                    jc.grad_pass_colvec(ms, X_, q_, qd_, v_, a_, f_, ohs,
                                        "qd", GRAVITY), qdd_)

        out[f"{key}/ops/linearize"] = np.asarray(eqns(
            k3_body, s0(inp["q"]), s0(inp["qd"]), s0(inp["u"]), masks))

        def k4_body(q_):
            p, _ = jk.ee_chain_lane(ms, q_, jid, fid, (0.0, 0.0, 0.0))
            return [jls._add(p[r], -target[r]) for r in range(3)]

        out[f"{key}/ops/ee_err"] = np.asarray(eqns(k4_body, s0(inp["q"])))

    # ---- configs[2]'s solve with every kernel of its path ----
    m = load_asset("arm7", dtype=np.float64)
    Bm, Hs = SOLVE["Bm"], SOLVE["H"]
    q0 = 0.3 * rng.standard_normal((Bm, m.nq))
    z = np.zeros_like(q0)
    tau_g = A(rnea(m, J(q0), J(z), J(z))[0])
    x0 = np.concatenate([q0, z], 1)
    U0 = np.repeat(tau_g[:, None], Hs, 1)
    cost = ee_reaching_cost(m, MODELS[0][5], fused=True, **WEIGHTS)
    cfg = DDPConfig(iters=SOLVE["iters"], dt=DT, gravity=GRAVITY,
                    n_alphas=SOLVE["n_alphas"], fused=True,
                    fused_feedback=True)
    st, hist = jax.jit(lambda x, U: ddp_solve(m, cost, x, U, cfg))(
        J(x0), J(U0))
    out.update({"solve/x0": x0, "solve/U0": U0, "solve/U": A(st.U),
                "solve/J": A(st.J), "solve/J_hist": A(hist)})
    return out


if __name__ == "__main__":
    import time

    start = time.perf_counter()
    refs = reference()
    np.savez_compressed(PATH, **refs)
    print(f"wrote {PATH}: {len(refs)} arrays in "
          f"{time.perf_counter() - start:.1f} s")
