"""The operation counts behind the kernels' roofline bounds
(``rbdtpu_torch.opcount``): each counted function carries its values, and
here they are held against the port's plain versions, float64 on the CPU,
at 1e-9, on arm7, on the mixed revolute/prismatic tree and (for the
kernels that take it) on quadruped12's rpy floating root; the Riccati
knot against the plain sweep.  So the operations counted are those of the
function the kernel computes."""
import numpy as np
import pytest
import torch

from rbdtpu_torch import opcount as oc
from rbdtpu_torch.kernels import (
    ee_gn_plain, fd_step_minv_plain, fd_step_plain,
    feedback_rollout_chunked_plain, feedback_rollout_plain,
    linearize_parts_plain, rnea_plain,
)
from rbdtpu_torch.kernels.fk_lane import _single_ee
from rbdtpu_torch.model import load_asset, parse_urdf
from rbdtpu_torch.solver.ddp import backward_pass
from test_torch_cuda import mixed_tree_urdf

TOL = 1e-9
DT, G = 0.01, -9.81
TARGET = (0.3, 0.2, 0.8)
EE = {"arm7": None, "mixed": ("j4",)}


def _case(name):
    """(port model, counting model, EE names, numpy rng)."""
    if name == "arm7":
        m = load_asset("arm7", device="cpu", dtype=torch.float64)
    elif name == "mixed":
        m = parse_urdf(mixed_tree_urdf(), device="cpu", dtype=torch.float64)
    else:
        m = load_asset("quadruped12", device="cpu", dtype=torch.float64,
                       floating_base=True)
    return m, oc.Model(m), EE.get(name), np.random.default_rng(7)


@pytest.fixture(scope="module", params=["arm7", "mixed"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module", params=["arm7", "mixed", "quad_rpy"])
def tree_case(request):
    """``case`` over the fixed-base trees and the rpy floating root."""
    return _case(request.param)


def _nums(a):
    return np.vectorize(oc.Num, otypes=[object])(a).tolist()


def _vals(x):
    return np.vectorize(oc.value, otypes=[float])(np.array(x, dtype=object))


def _close(counted, ref):
    ref = ref.numpy()
    np.testing.assert_allclose(_vals(counted), ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()))


def _state(m, rng):
    n = m.nv
    x = np.concatenate([0.3 * rng.standard_normal(n),
                        0.5 * rng.standard_normal(n)])
    return x, rng.standard_normal(n), 0.5 * rng.standard_normal((m.nb, 6))


@pytest.mark.parametrize("with_qdd", [False, True])
def test_rnea(tree_case, with_qdd):
    m, md, _, rng = tree_case
    x, qdd, _ = _state(m, rng)
    n = m.nv
    out = oc.rnea_state(md, _nums(x[:n]), _nums(x[n:]),
                        _nums(qdd) if with_qdd else None, G)
    T = lambda a: torch.tensor(a)[None]
    ref = rnea_plain(m, T(x[:n]), T(x[n:]), T(qdd) if with_qdd else None, G)
    _close(out, ref[0])


@pytest.mark.parametrize("with_fext", [False, True])
def test_fd_step(tree_case, with_fext):
    m, md, _, rng = tree_case
    x, u, w = _state(m, rng)
    out = oc.fd_step(md, _nums(x), _nums(u), DT, G,
                     _nums(w) if with_fext else None)
    ref = fd_step_plain(m, torch.tensor(x)[None], torch.tensor(u)[None], DT,
                        G, torch.tensor(w) if with_fext else None)
    _close(out, ref[0])


@pytest.mark.parametrize("dense,with_fext", [(False, False), (True, False),
                                             (False, True)])
def test_fd_step_minv(tree_case, dense, with_fext):
    m, md, _, rng = tree_case
    x, u, w = _state(m, rng)
    out = oc.fd_step_minv(md, _nums(x), _nums(u), DT, G, dense,
                          _nums(w) if with_fext else None)
    ref = fd_step_minv_plain(m, torch.tensor(x)[None], torch.tensor(u)[None],
                             DT, G, f_ext=torch.tensor(w) if with_fext
                             else None)
    _close(out, ref[0])


def test_feedback_knot(tree_case):
    m, md, _, rng = tree_case
    n = m.nv
    x, u, _ = _state(m, rng)
    xn, kf = rng.standard_normal(2 * n), rng.standard_normal(n)
    K = rng.standard_normal((n, 2 * n))
    (xo, uo) = oc.feedback_knot(md, _nums(x), _nums(xn), _nums(u), _nums(kf),
                                _nums(K), DT, G)
    T = lambda a: torch.tensor(a)[None, None]
    Xr, Ur = feedback_rollout_plain(m, torch.tensor(x)[None], T(xn), T(u),
                                    T(kf), T(K), DT, G)
    _close(xo, Xr[0, 0])
    _close(uo, Ur[0, 0])


@pytest.mark.parametrize("nchunks", [1, 2, 5])
def test_feedback_knot_chunked(tree_case, nchunks):
    """K9's counted knot computes the chunked plain version's function, in
    as many operations as K2's."""
    m, md, _, rng = tree_case
    n = m.nv
    x, u, _ = _state(m, rng)
    xn, kf = rng.standard_normal(2 * n), rng.standard_normal(n)
    K = rng.standard_normal((n, 2 * n))
    args = (_nums(x), _nums(xn), _nums(u), _nums(kf), _nums(K), DT, G)
    (xo, uo), ops = oc.counted(oc.feedback_knot_chunked, md, *args,
                               nchunks=nchunks)
    T = lambda a: torch.tensor(a)[None, None]
    Xr, Ur = feedback_rollout_chunked_plain(
        m, torch.tensor(x)[None], T(xn), T(u), T(kf), T(K), DT, G,
        nchunks=nchunks)
    _close(xo, Xr[0, 0])
    _close(uo, Ur[0, 0])
    assert ops == oc.counted(oc.feedback_knot, md, *args)[1]


def test_linearize_parts(tree_case):
    m, md, _, rng = tree_case
    n = m.nv
    x, u, _ = _state(m, rng)
    out = oc.linearize_parts(md, _nums(x[:n]), _nums(x[n:]), _nums(u), G)
    T = lambda a: torch.tensor(a)[None]
    ref = linearize_parts_plain(m, T(x[:n]), T(x[n:]), T(u), G)
    for o, r in zip(out, ref):
        _close(o, r[0])


@pytest.mark.parametrize("gn", [True, False])
def test_ee(case, gn):
    m, md, ee_names, rng = case
    q = 0.3 * rng.standard_normal(m.nb)
    jid, fid = _single_ee(m, ee_names)
    out = oc.ee(md, jid, fid, _nums(q), TARGET, gn)
    ref = ee_gn_plain(m, torch.tensor(q)[None], TARGET, ee_names=ee_names,
                      gn=gn)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            _close(o, r[0])


@pytest.mark.parametrize("ee", ["leaf", "frame"])
@pytest.mark.parametrize("gn", [True, False])
def test_ee_rpy(gn, ee):
    """The counted K4 function on the rpy quadruped (the root's six
    columns, then the leg's) at a leaf joint and at a foot's fixed frame
    against ``ee_gn_plain`` at 1e-9; the count grows with gn."""
    m = load_asset("quadruped12", device="cpu", dtype=torch.float64,
                   floating_base=True)
    md = oc.Model(m)
    names = ((m.joint_names[m.leaves()[1]],) if ee == "leaf"
             else ("RR_foot_fixed",))
    q = np.random.default_rng(4).uniform(-1.0, 1.0, m.nq)
    jid, fid = _single_ee(m, names)
    out, ops = oc.counted(oc.ee, md, jid, fid, _nums(q), TARGET, gn)
    ref = ee_gn_plain(m, torch.tensor(q)[None], TARGET, ee_names=names,
                      gn=gn)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            _close(o, r[0])
    keys = oc.per_state(m, TARGET, ee_names=names)
    assert keys["ee_err"] < keys["ee_gn"]
    assert ops == keys["ee_gn" if gn else "ee_err"]


def test_feedback_knot_fext():
    """K2's counted knot under a wrench set against
    ``feedback_rollout_plain`` over one knot with the same wrenches, and
    ``per_state``'s counts: K2's and K9's with wrenches equal, above the
    wrench-free ones."""
    m = load_asset("quadruped12", device="cpu", dtype=torch.float64,
                   floating_base=True)
    md, n = oc.Model(m), m.nv
    rng = np.random.default_rng(5)
    x = 0.1 * rng.standard_normal(2 * n)
    x[2] += 0.4
    xn, u, kf = (0.1 * rng.standard_normal(s) for s in (2 * n, n, n))
    K = 0.1 * rng.standard_normal((n, 2 * n))
    w = rng.standard_normal((m.nb, 6))
    (xo, uo), ops = oc.counted(oc.feedback_knot, md, _nums(x), _nums(xn),
                               _nums(u), _nums(kf), _nums(K), 0.01, G,
                               fext=_nums(w))
    T = lambda a: torch.tensor(a)[None]
    Xr, Ur = feedback_rollout_plain(
        m, T(x), T(xn)[:, None], T(u)[:, None], T(kf)[:, None],
        T(K)[:, None], 0.01, G, f_ext=torch.tensor(w)[None])
    _close(xo, Xr[0, 0])
    _close(uo, Ur[0, 0])
    keys = oc.per_state(m, TARGET)
    assert ops == keys["feedback_rollout+fext"] == keys[
        "feedback_chunked+fext"] > keys["feedback_rollout"]


def test_primitive_counts():
    """The general costs of the spatial primitives, all operands counted."""
    rng = np.random.default_rng(0)
    v = lambda *s: _nums(rng.standard_normal(s))
    X = (v(3, 3), v(3))
    A = v(6, 6)
    A = [[A[min(r, s)][max(r, s)] for s in range(6)] for r in range(6)]
    I = (oc.Num(2.0), v(3), v(3, 3))
    assert oc.counted(oc.xmv, X, v(6))[1] == 42
    assert oc.counted(oc.xtf, X, v(6))[1] == 42
    assert oc.counted(oc.crm, v(6), v(6))[1] == 30
    assert oc.counted(oc.crf, v(6), v(6))[1] == 30
    assert oc.counted(oc.rbi_mv, I, v(6))[1] == 42
    out, ops = oc.counted(oc.xtax, X, A)
    assert ops == 339
    E = np.array(_vals(X[0]))
    r = _vals(X[1])
    rx = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    Xd = np.block([[E, np.zeros((3, 3))], [-E @ rx, E]])
    Ad = _vals(A)
    np.testing.assert_allclose(_vals(out), Xd.T @ Ad @ Xd, rtol=0, atol=1e-12)


def test_per_state_keys():
    m = load_asset("arm7", device="cpu", dtype=torch.float64)
    ops = oc.per_state(m, TARGET)
    assert set(ops) == {
        "fd_step", "fd_step+fext", "feedback_rollout", "feedback_chunked",
        "feedback_rollout+fext", "feedback_chunked+fext",
        "linearize_parts", "ee_gn", "ee_err", "rnea", "rnea+qdd",
        "fd_step_minv", "fd_step_minv+dense", "fd_step_minv+fext",
        "fd_step_minv+dense+fext"}
    assert ops["feedback_chunked"] == ops["feedback_rollout"]
    assert ops["rnea"] < ops["rnea+qdd"] < ops["fd_step_minv"]
    assert ops["ee_err"] < ops["ee_gn"]
    assert ops["fd_step"] < ops["fd_step+fext"]
    assert ops["fd_step_minv+dense"] < ops["fd_step_minv+dense+fext"]
    fb = load_asset("quadruped12", device="cpu", dtype=torch.float64,
                    floating_base=True)
    assert set(oc.per_state(fb, TARGET)) == {
        "fd_step", "fd_step+fext", "feedback_rollout", "feedback_chunked",
        "feedback_rollout+fext", "feedback_chunked+fext",
        "linearize_parts", "rnea", "rnea+qdd", "fd_step_minv",
        "fd_step_minv+dense", "fd_step_minv+fext", "fd_step_minv+dense+fext"}


def test_per_state_humanoid():
    """The counts reach the humanoid (31 bodies, rpy root), whose kernels
    are the fb32 size class, and grow with the tree."""
    quad = oc.per_state(load_asset("quadruped12", device="cpu",
                                   dtype=torch.float64, floating_base=True),
                        TARGET)
    hum = oc.per_state(load_asset("humanoid30", device="cpu",
                                  dtype=torch.float64, floating_base=True),
                       TARGET)
    assert set(hum) == set(quad)
    assert all(hum[k] > quad[k] for k in hum)
    assert hum["feedback_chunked"] == hum["feedback_rollout"]


def test_riccati_knot():
    """Two knots of the counted sweep against the plain sweep over H=2
    (so the new Vx and Vxx are held too), and the count's growth with nx
    at nu = nx / 2: as nx^3."""
    rng = np.random.default_rng(3)
    nx, nu = 6, 3
    A = np.eye(nx) + 0.1 * rng.standard_normal((2, nx, nx))
    Bm = 0.1 * rng.standard_normal((2, nx, nu))
    lx, lu = rng.standard_normal((2, nx)), rng.standard_normal((2, nu))
    lxx, luu = 2.0 * np.eye(nx), 2.0 * np.eye(nu)
    lux = 0.1 * rng.standard_normal((nu, nx))
    lfx = rng.standard_normal(nx)
    G = rng.standard_normal((nx, nx))
    lfxx = G @ G.T + np.eye(nx)
    reg = 1e-3
    T = lambda a: torch.tensor(a)[None]
    k, K, dV, ok = backward_pass(T(A), T(Bm), T(lx), T(lu), torch.tensor(lxx),
                                 torch.tensor(luu), torch.tensor(lux), T(lfx),
                                 T(lfxx), torch.tensor([reg]))
    Vx, Vxx, dV_c = _nums(lfx), _nums(lfxx), 0.0
    for t in (1, 0):
        kc, Kc, dv, Vx, Vxx = oc.riccati_knot(
            _nums(A[t]), _nums(Bm[t]), _nums(lx[t]), _nums(lu[t]), lxx, luu,
            lux, Vx, Vxx, reg)
        _close(kc, k[0, t])
        _close(Kc, K[0, t])
        dV_c = dV_c + dv
    _close([dV_c], dV)
    assert ok.item()
    ops = [oc.riccati_knot_ops(n, n // 2) for n in (16, 32)]
    assert 7.0 < ops[1] / ops[0] < 8.0
