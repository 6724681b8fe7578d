"""The port's model-specialised kernel code (K0: ``kernels.lanescalar``,
``ModelStatic``/``get_static`` and the lane sweeps of ``kernels.fused``)
against rbdtpu in float64 on the CPU: the statics field for field, the
lane sweeps at 1e-9 on arm7, the rpy and the quaternion quadruped and the
rpy humanoid, the operations the port's generator emits a state equal to
those rbdtpu traces, and the four entry points with ``specialize=True``
on CPU tensors (the lane sweeps on (B,) tensors) against rbdtpu's Pallas
kernels in interpret mode at 1e-9.  The solver's kernels likewise on
arm7 and both quadruped roots: the lane sweeps of K2, K3 and K4
(``_dx_rows``, ``minv_colvec``, ``grad_pass_colvec``, ``ee_chain_lane``),
``specialize=True`` on ``feedback_rollout_fused``,
``linearize_parts_fused`` and ``ee_gn_fused``, their bodies' operation
counts, and configs[2]'s specialised ``ddp_solve`` (controls < 1e-6).
rbdtpu's results are recorded in tests/data/lane_refs.npz and
tests/data/k0_solver_refs.npz by tests/make_lane_fixture.py and
tests/make_k0_solver_fixture.py, so this file runs no JAX
computation."""
import os

import numpy as np
import pytest
import torch

from rbdtpu_torch.kernels import codegen, fused
from rbdtpu_torch.kernels import lanescalar as ls
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.spatial import quat as sq

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "lane_refs.npz")
DT, GRAVITY, TOL = 0.01, -9.81, 1e-9
MODELS = {"arm7": ("arm7", False, False),
          "quad_rpy": ("quadruped12", True, False),
          "quad_quat": ("quadruped12", True, True),
          "hum_rpy": ("humanoid30", True, False)}
FIELDS = ("nb", "parent", "jtype", "fb", "quat", "axis", "Xtree", "I", "S",
          "Ttree", "T_fixed", "nv", "nq")


@pytest.fixture(scope="module")
def ref():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def models():
    return {k: load_asset(a, device="cpu", dtype=torch.float64,
                          floating_base=fb, root_quat=qt)
            for k, (a, fb, qt) in MODELS.items()}


def T(a):
    return torch.tensor(a, dtype=torch.float64)


def lanes(a):
    return [T(a[:, i]) for i in range(a.shape[1])]


def stack(vals, B):
    return np.stack([np.broadcast_to(np.asarray(v), (B,)) for v in vals], -1)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


@pytest.mark.parametrize("key", list(MODELS))
def test_statics_match_rbdtpu(ref, models, key):
    """``get_static`` builds, from the port's float64 model data, the very
    constants rbdtpu's does from its own (both from one URDF): every field
    equal, exactly."""
    ms = fused.get_static(models[key])
    assert fused.get_static(models[key]) is ms
    for f in FIELDS:
        val = getattr(ms, f)
        got = np.asarray([] if val is None else val, dtype=np.float64)
        np.testing.assert_array_equal(got, ref[f"{key}/static/{f}"],
                                      err_msg=f)


@pytest.mark.parametrize("sweep", ["rnea", "aba", "minv", "step"])
@pytest.mark.parametrize("key", list(MODELS))
def test_lane_sweeps_match_rbdtpu(ref, models, key, sweep):
    """The lane sweeps on (B,) tensors against rbdtpu's on (B,) arrays, on
    the same inputs: ``rnea_lane`` (bias and with qdd, each with and without
    wrenches), ``aba_lane`` (with and without), ``minv_lane`` and
    ``_step_lane`` (the "aba" route, the factorised "minv" route and the
    dense one, each with and without wrenches), at 1e-9."""
    ms = fused.get_static(models[key])
    g = lambda k: ref[f"{key}/in/{k}"]
    B = g("q").shape[0]
    q, qd, qdd, u = (lanes(g(k)) for k in ("q", "qd", "qdd", "u"))
    fe = fused._fext_lists(ms, lanes(g("FB").reshape(B, -1)))
    if sweep == "rnea":
        for tag, acc, f in (("bias", None, None), ("qdd", qdd, None),
                            ("bias_fext", None, fe), ("qdd_fext", qdd, fe)):
            close(stack(fused.rnea_lane(ms, q, qd, acc, GRAVITY, f_ext=f), B),
                  ref[f"{key}/rnea_{tag}"])
    elif sweep == "aba":
        for tag, f in (("", None), ("_fext", fe)):
            close(stack(fused.aba_lane(ms, q, qd, u, GRAVITY, f_ext=f), B),
                  ref[f"{key}/aba{tag}"])
    elif sweep == "minv":
        X = [fused._body_xc(ms, i, q) for i in range(ms.nb)]
        got = np.stack([stack(row, B) for row in fused.minv_lane(ms, X)], 1)
        close(got, ref[f"{key}/minv"])
    else:
        for route, dense in (("aba", False), ("minv", False),
                             ("dense", True)):
            for tag, f in (("", None), ("_fext", fe)):
                qn, qdn = fused._step_lane(
                    ms, q, qd, u, DT, GRAVITY,
                    "aba" if route == "aba" else "minv", dense_minv=dense,
                    f_ext=f)
                close(stack(list(qn) + list(qdn), B),
                      ref[f"{key}/step_{route}{tag}"])


@pytest.mark.parametrize("key", list(MODELS))
def test_generator_emits_rbdtpus_operations(ref, models, key):
    """The generated bodies hold exactly as many operations a state as
    rbdtpu traces for the same lane code (the equations of its jaxpr):
    ``rnea_lane`` with qdd and ``_step_lane`` on each route, so the model's
    zeros fold alike in both packages."""
    ops = codegen.generate(models[key], torch.float64, GRAVITY).ops
    for body in ("rnea_qdd", "aba", "minv", "dense"):
        assert ops[body] == int(ref[f"{key}/ops/{body}"]), body


@pytest.mark.parametrize("kernel", ["k10", "k1", "k6", "k5"])
@pytest.mark.parametrize("key", ["arm7", "quad_rpy"])
def test_specialized_entry_points_match_rbdtpu(ref, models, key, kernel):
    """``rnea_fused``, ``fd_step_fused``, ``fd_step_minv_fused`` and
    ``rollout_fused_multi`` with ``specialize=True`` on CPU tensors (the
    plain versions of the specialised kernels) against rbdtpu's Pallas
    kernels in interpret mode, at 1e-9: K10 bias and with qdd; K1 bare,
    under one (nb, 6) set and one set a state; K6 on both routes, the
    factorised one under one set and the dense one under one a state; K5
    over H knots on both routes, with and without (H, nb, 6) wrenches."""
    m = models[key]
    g = lambda k: T(ref[f"{key}/in/{k}"])
    q, qd, u = g("q"), g("qd"), g("u")
    x = torch.cat([q, qd], 1)
    r = lambda k: ref[f"{key}/{k}"]
    if kernel == "k10":
        close(fused.rnea_fused(m, q, qd, None, GRAVITY, specialize=True),
              r("k10_bias"))
        close(fused.rnea_fused(m, q, qd, g("qdd"), GRAVITY, specialize=True),
              r("k10_qdd"))
    elif kernel == "k1":
        for tag, f in (("", None), ("_f1", "F1"), ("_fb", "FB")):
            close(fused.fd_step_fused(m, x, u, DT, GRAVITY,
                                      f_ext=None if f is None else g(f),
                                      specialize=True), r(f"k1{tag}"))
    elif kernel == "k6":
        for tag, dense, f in (("fact", False, None), ("dense", True, None),
                              ("fact_f1", False, "F1"),
                              ("dense_fb", True, "FB")):
            close(fused.fd_step_minv_fused(
                m, x, u, DT, GRAVITY, dense_minv=dense,
                f_ext=None if f is None else g(f), specialize=True),
                r(f"k6_{tag}"))
    else:
        for route in ("aba", "minv"):
            for tag, f in (("", None), ("_fh", "FH")):
                close(fused.rollout_fused_multi(
                    m, g("x0"), g("U"), DT, GRAVITY, route=route,
                    f_ext=None if f is None else g(f), specialize=True),
                    r(f"k5_{route}{tag}"))


def test_quaternion_lane_helpers_match_spatial_quat():
    """``quat_step`` and ``quat_log_rel`` on lane tensors (both branches of
    their small-angle switches) against the port's quaternion algebra:
    q (x) exp(dt w) normalised, and log(conj(q0) (x) q1) with the
    minimal-rotation sign fix, at 1e-12."""
    rng = np.random.default_rng(7)
    q0 = T(rng.standard_normal((6, 4)))
    q0 = q0 / q0.norm(dim=1, keepdim=True)
    w = T(rng.standard_normal((6, 3)))
    w[0] = 0.0
    w[1] *= 1e-9
    dt = 0.01
    got = torch.stack(ls.quat_step(*q0.T, *w.T, dt), -1)
    want = sq.quat_normalize(sq.quat_mul(q0, sq.quat_exp(dt * w)))
    close(got, want.numpy(), 1e-12)
    q1 = sq.quat_mul(q0, sq.quat_exp(T(rng.standard_normal((6, 3)))))
    q1[2] = -q1[2]
    q1[3] = q0[3]
    got = torch.stack(ls.quat_log_rel(tuple(q0.T), tuple(q1.T)), -1)
    want = sq.quat_log(sq.quat_mul(sq.quat_conj(q0), q1))
    close(got, want.numpy(), 1e-12)


def test_dispatch_on_the_scalar_type():
    """The functions rbdtpu took from jnp/lax take a tensor, a static float
    and the generator's symbol alike."""
    x = T([0.25, -2.0, float("nan")])
    close(ls.maximum(x, 0.0), np.array([0.25, 0.0, np.nan]))
    close(ls.clip(x, -1.0, 0.5), np.array([0.25, -1.0, np.nan]))
    close(ls.where(x < 0, -x, x), np.array([0.25, 2.0, np.nan]))
    assert ls.sqrt(4.0) == 2.0 and ls.rsqrt(4.0) == 0.5
    assert ls.maximum(1.0, 2.0) == 2.0 and ls.where(True, 1.0, x) == 1.0
    em = codegen.Emitter("double")
    s = codegen.Sym(em, "a")
    ls.where(s < 0.0, ls.sin(s), ls.clip(ls.rsqrt(s), -1.0, 1.0))
    assert em.count == 5
    assert "sin(a)" in em.lines[1] and "t0 ? t1 : t3" in em.lines[-1]


# ---- K0 of the solver's kernels (K2, K3, K4): tests/data/k0_solver_refs.npz
# (tests/make_k0_solver_fixture.py) ----
SOLVER_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "k0_solver_refs.npz")
SOLVER_MODELS = {"arm7": ("arm7", False, False, None, (0.3, 0.2, 0.8)),
                 "quad_rpy": ("quadruped12", True, False, ("FL_knee",),
                              (0.3, 0.1, 0.1)),
                 "quad_quat": ("quadruped12", True, True, ("FL_knee",),
                               (0.3, 0.1, 0.1))}
U_CLIP = 0.8
WEIGHTS = dict(w_ee=10.0, w_ee_f=2000.0, w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)


@pytest.fixture(scope="module")
def sref():
    with np.load(SOLVER_PATH) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def smodels():
    return {k: load_asset(a, device="cpu", dtype=torch.float64,
                          floating_base=fb, root_quat=qt)
            for k, (a, fb, qt, _, _) in SOLVER_MODELS.items()}


def colscalars(vals, B, C):
    """Colscalars (B, C) tensors, (B, 1) lanes or statics -> (n, C, B), the
    layout rbdtpu's (C, B) colscalars are recorded in."""
    return np.stack([np.broadcast_to(np.asarray(v), (B, C)).T for v in vals])


@pytest.mark.parametrize("sweep", ["dx_rows", "minv_colvec", "grad_pass",
                                   "ee_chain"])
@pytest.mark.parametrize("key", list(SOLVER_MODELS))
def test_solver_lane_sweeps_match_rbdtpu(sref, smodels, key, sweep):
    """The solver kernels' lane sweeps against rbdtpu's on the same inputs,
    at 1e-9: ``_dx_rows`` (the quaternion root's manifold difference
    included), ``minv_colvec`` and both ``grad_pass_colvec`` sweeps on
    (B, 1) lanes with (C,) one-hot masks (every root's seeds: the rpy
    Euler columns, the quaternion's tangent rotations, the root's dqd
    identity), and ``ee_chain_lane`` (the effector's position and each
    Jacobian column with its velocity index)."""
    from rbdtpu_torch.kernels import colvec, fk_lane

    m = smodels[key]
    ms = fused.get_static(m)
    g = lambda k: sref[f"{key}/in/{k}"]
    B = g("q").shape[0]
    if sweep == "dx_rows":
        got = fused._dx_rows(ms, lanes(g("x0")), lanes(g("X_nom")[:, 0]))
        close(stack(got, B), sref[f"{key}/dx_rows"])
    elif sweep == "ee_chain":
        jid, fid = fk_lane._single_ee(m, SOLVER_MODELS[key][3])
        p_ee, cols = fk_lane.ee_chain_lane(ms, lanes(g("q")), jid, fid,
                                           (0.0, 0.0, 0.0))
        close(stack(p_ee, B), sref[f"{key}/ee_p"])
        assert [vi for vi, _ in cols] == sref[f"{key}/ee_vi"].tolist()
        close(np.stack([stack(col, B) for _, col in cols]),
              sref[f"{key}/ee_cols"])
    else:
        C = colvec._pad8(ms.nv)
        col = lambda a: [T(a[:, i])[:, None] for i in range(a.shape[1])]
        q, qd, u = col(g("q")), col(g("qd")), col(g("u"))
        X = [fused._body_xc(ms, i, q) for i in range(ms.nb)]
        qdd = fused.aba_lane(ms, q, qd, u, GRAVITY, X=X)
        v, a, f, _ = fused._rnea_sweeps_lane(ms, X, qd, qdd, GRAVITY)
        oh = colvec._make_oh(C, T(g("q")))
        if sweep == "minv_colvec":
            close(colscalars(colvec.minv_colvec(ms, X, oh), B, C),
                  sref[f"{key}/minv_colvec"])
        else:
            for wrt in ("q", "qd"):
                close(colscalars(colvec.grad_pass_colvec(
                    ms, X, q, qd, v, a, f, oh, wrt, GRAVITY), B, C),
                    sref[f"{key}/grad_{wrt}"])


@pytest.mark.parametrize("kernel", ["k2", "k3", "k4"])
@pytest.mark.parametrize("key", list(SOLVER_MODELS))
def test_specialized_solver_kernels_match_rbdtpu(sref, smodels, key, kernel):
    """``feedback_rollout_fused``, ``linearize_parts_fused`` and
    ``ee_gn_fused`` with ``specialize=True`` on CPU tensors (the plain
    versions of ``feedback_rollout_static``, ``linearize_parts_static``,
    ``ee_gn_static`` and ``ee_err_static``) against rbdtpu's Pallas kernels
    in interpret mode, at 1e-9: K2 with a clamp, and with it under
    (H, nb, 6) wrenches; K3's symmetrised M^-1, dc/dq, dc/dqd and qdd; K4
    with gn True and False."""
    from rbdtpu_torch.kernels import colvec, fk_lane

    m = smodels[key]
    g = lambda k: T(sref[f"{key}/in/{k}"])
    r = lambda k: sref[f"{key}/{k}"]
    if kernel == "k2":
        clip = torch.full((m.nv,), U_CLIP, dtype=torch.float64)
        for tag, F in (("clip", None), ("clip_fext", g("FH"))):
            X, U = fused.feedback_rollout_fused(
                m, g("x0"), g("X_nom"), g("U_nom"), g("k_ff"), g("K_fb"), DT,
                GRAVITY, u_clip=clip, f_ext=F, specialize=True)
            close(X, r(f"k2_{tag}_X"))
            close(U, r(f"k2_{tag}_U"))
    elif kernel == "k3":
        Mi, dcq, dcd, qdd = colvec.linearize_parts_fused(
            m, g("q"), g("qd"), g("u"), GRAVITY, specialize=True)
        close(torch.stack([Mi, dcq, dcd]), r("k3"))
        close(qdd, r("k3_qdd"))
    else:
        _, _, _, ee, target = SOLVER_MODELS[key]
        for gn, tag in ((True, "gn"), (False, "err")):
            out = fk_lane.ee_gn_fused(m, g("q"), target, ee_names=ee, gn=gn,
                                      specialize=True)
            for name, got in zip(("e", "g0", "H0"), out):
                if gn or name == "e":
                    close(got, r(f"k4_{tag}_{name}"))
                else:
                    assert got is None


@pytest.mark.parametrize("key", list(SOLVER_MODELS))
def test_generator_emits_rbdtpus_solver_operations(sref, smodels, key):
    """K2's knot body (without and with wrenches), K3's column body and
    K4's effector error hold exactly as many operations a state as rbdtpu's
    jaxpr of the same body has equations (less its dtype conversions)."""
    from rbdtpu_torch.kernels import fk_lane

    m = smodels[key]
    ops = codegen.generate(m, torch.float64, GRAVITY).ops
    for body in ("feedback", "feedback_fext", "linearize"):
        assert ops[body] == int(sref[f"{key}/ops/{body}"]), body
    jid, fid = fk_lane._single_ee(m, SOLVER_MODELS[key][3])
    ee_ops = codegen.generate_ee(m, torch.float64, jid, fid).ops
    assert ee_ops["ee_err"] == int(sref[f"{key}/ops/ee_err"])
    # ee_gn adds J^T e and the upper triangle of J^T J, which rbdtpu forms
    # on its colscalars (no lane body to count)
    assert ee_ops["ee_gn"] > ee_ops["ee_err"]


def test_specialized_solve_matches_rbdtpu(sref, smodels):
    """configs[2]'s ``ddp_solve`` with ``DDPConfig(fused=True,
    specialize=True)`` and ``ee_reaching_cost(specialize=True)`` on CPU
    tensors (every kernel's plain lane version) against rbdtpu's solve with
    every kernel of the path in interpret mode: controls < 1e-6, J 1e-9
    relative."""
    from rbdtpu_torch.solver import DDPConfig, ddp_solve, ee_reaching_cost

    m = smodels["arm7"]
    U_ref = sref["solve/U"]
    cost = ee_reaching_cost(m, SOLVER_MODELS["arm7"][4], specialize=True,
                            **WEIGHTS)
    cfg = DDPConfig(iters=3, dt=DT, gravity=GRAVITY, n_alphas=8, fused=True,
                    specialize=True)
    st, hist = ddp_solve(m, cost, T(sref["solve/x0"]), T(sref["solve/U0"]),
                         cfg)
    close(st.U, U_ref, 1e-6)
    np.testing.assert_allclose(hist.numpy(), sref["solve/J_hist"],
                               rtol=1e-9, atol=0)


def test_specialized_solve_refuses_routes_without_k0(smodels):
    """``specialize=True`` raises ValueError, and never falls back to a
    table kernel, where no model-specialised kernel exists: the line
    search's K9 tier (the rpy humanoid at 256 x 4 trajectories with
    ``fused_feedback=True``, rbdtpu's rule picks K9), a solve that is not
    fused, and the EE cost's plain route."""
    from rbdtpu_torch.solver import (DDPConfig, ddp_solve, ee_reaching_cost,
                                     quadratic_tracking_cost)
    from rbdtpu_torch.solver.ddp import _feedback_route

    h = load_asset("humanoid30", device="cpu", dtype=torch.float64,
                   floating_base=True)
    cfg = DDPConfig(iters=1, n_alphas=4, fused=True, fused_feedback=True,
                    specialize=True)
    assert _feedback_route(h, cfg, 256 * 4)[0] == "chunked"
    x0 = torch.zeros(256, h.nx, dtype=torch.float64)
    U0 = torch.zeros(256, 2, h.nv, dtype=torch.float64)
    cost = quadratic_tracking_cost(h, np.zeros(h.nx))
    with pytest.raises(ValueError, match="chunked"):
        ddp_solve(h, cost, x0, U0, cfg)
    m = smodels["arm7"]
    with pytest.raises(ValueError, match="fused=True"):
        ddp_solve(m, quadratic_tracking_cost(m, np.zeros(m.nx)),
                  torch.zeros(1, m.nx, dtype=torch.float64),
                  torch.zeros(1, 2, m.nv, dtype=torch.float64),
                  DDPConfig(iters=1, specialize=True))
    with pytest.raises(ValueError, match="specialize"):
        ee_reaching_cost(m, (0.3, 0.2, 0.8), fused=False, specialize=True)
