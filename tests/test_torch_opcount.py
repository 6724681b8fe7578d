"""The operation counts behind the kernels' roofline bounds
(``rbdtpu_torch.opcount``): each counted function carries its values, and
here they are held against the port's plain versions, float64 on the CPU,
at 1e-9, on arm7 and on the mixed revolute/prismatic tree.  So the
operations counted are those of the function the kernel computes."""
import numpy as np
import pytest
import torch

from rbdtpu_torch import opcount as oc
from rbdtpu_torch.kernels import (
    ee_gn_plain, fd_step_minv_plain, fd_step_plain, feedback_rollout_plain,
    linearize_parts_plain, rnea_plain,
)
from rbdtpu_torch.kernels.fk_lane import _single_ee
from rbdtpu_torch.model import load_asset, parse_urdf
from test_torch_cuda import mixed_tree_urdf

TOL = 1e-9
DT, G = 0.01, -9.81
TARGET = (0.3, 0.2, 0.8)
EE = {"arm7": None, "mixed": ("j4",)}


@pytest.fixture(scope="module", params=["arm7", "mixed"])
def case(request):
    """(port model, counting model, EE names, numpy rng)."""
    if request.param == "arm7":
        m = load_asset("arm7", device="cpu", dtype=torch.float64)
    else:
        m = parse_urdf(mixed_tree_urdf(), device="cpu", dtype=torch.float64)
    return m, oc.Model(m), EE[request.param], np.random.default_rng(7)


def _nums(a):
    return np.vectorize(oc.Num, otypes=[object])(a).tolist()


def _vals(x):
    return np.vectorize(oc.value, otypes=[float])(np.array(x, dtype=object))


def _close(counted, ref):
    ref = ref.numpy()
    np.testing.assert_allclose(_vals(counted), ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()))


def _state(m, rng):
    n = m.nb
    x = np.concatenate([0.3 * rng.standard_normal(n),
                        0.5 * rng.standard_normal(n)])
    return x, rng.standard_normal(n), 0.5 * rng.standard_normal((n, 6))


@pytest.mark.parametrize("with_qdd", [False, True])
def test_rnea(case, with_qdd):
    m, md, _, rng = case
    x, qdd, _ = _state(m, rng)
    n = m.nb
    out = oc.rnea_state(md, _nums(x[:n]), _nums(x[n:]),
                        _nums(qdd) if with_qdd else None, G)
    T = lambda a: torch.tensor(a)[None]
    ref = rnea_plain(m, T(x[:n]), T(x[n:]), T(qdd) if with_qdd else None, G)
    _close(out, ref[0])


@pytest.mark.parametrize("with_fext", [False, True])
def test_fd_step(case, with_fext):
    m, md, _, rng = case
    x, u, w = _state(m, rng)
    out = oc.fd_step(md, _nums(x), _nums(u), DT, G,
                     _nums(w) if with_fext else None)
    ref = fd_step_plain(m, torch.tensor(x)[None], torch.tensor(u)[None], DT,
                        G, torch.tensor(w) if with_fext else None)
    _close(out, ref[0])


@pytest.mark.parametrize("dense,with_fext", [(False, False), (True, False),
                                             (False, True)])
def test_fd_step_minv(case, dense, with_fext):
    m, md, _, rng = case
    x, u, w = _state(m, rng)
    out = oc.fd_step_minv(md, _nums(x), _nums(u), DT, G, dense,
                          _nums(w) if with_fext else None)
    ref = fd_step_minv_plain(m, torch.tensor(x)[None], torch.tensor(u)[None],
                             DT, G, f_ext=torch.tensor(w) if with_fext
                             else None)
    _close(out, ref[0])


def test_feedback_knot(case):
    m, md, _, rng = case
    n = m.nb
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


def test_linearize_parts(case):
    m, md, _, rng = case
    n = m.nb
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
        "fd_step", "fd_step+fext", "feedback_rollout", "linearize_parts",
        "ee_gn", "ee_err", "rnea", "rnea+qdd", "fd_step_minv",
        "fd_step_minv+dense", "fd_step_minv+fext"}
    assert ops["rnea"] < ops["rnea+qdd"] < ops["fd_step_minv"]
    assert ops["ee_err"] < ops["ee_gn"]
    assert ops["fd_step"] < ops["fd_step+fext"]
