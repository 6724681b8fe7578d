"""The port's second-order dynamics and full DDP against rbdtpu's, in
float64 on the CPU: the spatial factors and transforms' second
derivatives, ``crba``, ``forward_dynamics_grad`` and ``inverse_dynamics``
(arm7 and the rpy quadruped, live), IDSVA-SO native and by AD and FDSVA-SO
(arm7 live; the rpy and quaternion quadrupeds and the quaternion humanoid
from tests/data/second_order_refs.npz, recorded by
tests/make_second_order_fixture.py), the port's native sweep against its
own AD on both floating roots, the Riccati sweep with the fxx terms, and
``ddp_solve(exact_hessians=True)`` on tests/test_idsva.py's two problems.
Tolerances: 1e-9 (relative to the tensor's largest entry where that
passes 1), 1e-6 on controls, 1e-9 relative on J."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbdtpu import dynamics as jd
from rbdtpu import solver as js
from rbdtpu.spatial import ops as jops
from rbdtpu.spatial import transforms as jtf
from rbdtpu_torch import dynamics as td
from rbdtpu_torch import solver as ts
from rbdtpu_torch import spatial as tsp
from rbdtpu_torch.model import load_asset

from make_second_order_fixture import B_QUAD, DT, ITERS, PATH, W, H

TENSORS = ("d2q", "d2qd", "dvdq", "dM")
FD_TENSORS = ("qq", "vq", "vv", "tq")


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, tol=1e-9):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def ref():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


def _load(name, **kw):
    return load_asset(name, device="cpu", dtype=torch.float64, **kw)


@pytest.fixture(scope="module")
def tmodels():
    return {"arm7": _load("arm7"),
            "rpy": _load("quadruped12", floating_base=True),
            "quat": _load("quadruped12", floating_base=True, root_quat=True),
            "hum": _load("humanoid30", floating_base=True, root_quat=True)}


@pytest.fixture(scope="module")
def jmodels(arm7, quadruped12fb):
    return {"arm7": arm7, "rpy": quadruped12fb}


def _states(m, B, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (B, m.nq))
    if m.root_quat:
        r = rng.standard_normal((B, 4))
        q[:, 3:7] = r / np.linalg.norm(r, axis=-1, keepdims=True)
    return q, rng.uniform(-1, 1, (B, m.nv)), rng.uniform(-1, 1, (B, m.nv))


SPATIAL = {
    "icrf": lambda o, a: o.icrf(a["v"]),
    "vxIv": lambda o, a: o.vxIv(a["v"], a["I"]),
    "factor_inertia": lambda o, a: o.factor_inertia(a["I"], a["v"]),
    "dot_inertia": lambda o, a: o.dot_inertia(a["I"], a["v"]),
    "mcI": lambda o, a: o.mcI(a["m"], a["c"], a["Ic"]),
}


@pytest.mark.parametrize("fn", list(SPATIAL))
def test_spatial_factors_match_rbdtpu(fn):
    rng = np.random.default_rng(11)
    arrays = {"v": rng.standard_normal((3, 6)),
              "I": rng.standard_normal((3, 6, 6)),
              "m": rng.uniform(0.5, 2.0, 3), "c": rng.standard_normal((3, 3)),
              "Ic": rng.standard_normal((3, 3, 3))}
    f = SPATIAL[fn]
    close(f(tsp, {k: T(v) for k, v in arrays.items()}),
          f(jops, {k: jnp.asarray(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("jtype", [0, 1], ids=["revolute", "prismatic"])
def test_second_derivative_transforms_match_rbdtpu(jtype):
    """d2rot_axis and joint_hom_d2T, and d2rot_axis against a central
    difference of drot_axis."""
    rng = np.random.default_rng(12)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    Ttree = np.eye(4)
    Ttree[:3, 3] = rng.standard_normal(3)
    q = rng.uniform(-2.0, 2.0, 5)
    close(tsp.d2rot_axis(T(axis), T(q)),
          jtf.d2rot_axis(jnp.asarray(axis), jnp.asarray(q)))
    close(tsp.joint_hom_d2T(jtype, T(axis), T(Ttree), T(q)),
          jtf.joint_hom_d2T(jnp.asarray(jtype), jnp.asarray(axis),
                            jnp.asarray(Ttree), jnp.asarray(q)))
    h = 1e-6
    fd = (tsp.drot_axis(T(axis), T(q + h)) - tsp.drot_axis(
        T(axis), T(q - h))) / (2 * h)
    close(tsp.d2rot_axis(T(axis), T(q)), fd.numpy(), tol=1e-8)


FIRST = {
    "crba": (lambda d, m, q, qd, qdd: d.crba(m, q)),
    "forward_dynamics_grad": (lambda d, m, q, qd, qdd:
                              d.forward_dynamics_grad(m, q, qd, qdd)),
    "inverse_dynamics": (lambda d, m, q, qd, qdd:
                         d.inverse_dynamics(m, q, qd, qdd)),
}


@pytest.mark.parametrize("fn", list(FIRST))
@pytest.mark.parametrize("name", ["arm7", "rpy"])
def test_first_order_pieces_match_rbdtpu(tmodels, jmodels, name, fn):
    tm, jm = tmodels[name], jmodels[name]
    q, qd, qdd = _states(tm, 2, seed=13)
    got = FIRST[fn](td, tm, T(q), T(qd), T(qdd))
    want = FIRST[fn](jd, jm, *(jnp.asarray(a) for a in (q, qd, qdd)))
    if fn == "forward_dynamics_grad":
        for g, w in zip(got, want):
            close(g, w)
    else:
        close(got, want)


@pytest.fixture(scope="module")
def arm7_refs(arm7):
    """rbdtpu's native sweep and FDSVA-SO on arm7 at B = 2 (its AD, which
    its tests hold to the native sweep at 1e-10, costs more to run here
    than this whole file's budget allows)."""
    from rbdtpu.dynamics import idsva as ji

    q, qd, qdd = _states(arm7, 2, seed=14)
    args = tuple(jnp.asarray(a) for a in (q, qd, qdd))
    return (q, qd, qdd), {
        "native": jax.jit(lambda *a: ji.idsva_so_native(arm7, *a))(*args),
        "fdsva": ji.fdsva_so(arm7, *args)}


@pytest.mark.parametrize("fn", ["native", "ad", "fdsva"])
def test_arm7_second_order_matches_rbdtpu(tmodels, arm7_refs, fn):
    """The port's native sweep and its AD against rbdtpu's native sweep,
    FDSVA-SO against rbdtpu's."""
    (q, qd, qdd), refs = arm7_refs
    f = {"native": td.idsva_so_native, "ad": td.idsva_so_ad,
         "fdsva": td.fdsva_so}[fn]
    got = f(tmodels["arm7"], T(q), T(qd), T(qdd))
    for g, w in zip(got, refs["fdsva" if fn == "fdsva" else "native"]):
        assert g.shape == (2, 7, 7, 7)
        close(g, w)


@pytest.mark.parametrize("fn", ["native", "ad", "fdsva"])
@pytest.mark.parametrize("tag", ["rpy", "quat"])
def test_quadruped_second_order_matches_rbdtpu(tmodels, ref, tag, fn):
    """Both of the port's sweeps against rbdtpu's native tensors (which
    rbdtpu's tests hold to its AD at 1e-10), FDSVA-SO against rbdtpu's."""
    m = tmodels[tag]
    args = (T(ref[f"{tag}_q"]), T(ref[f"{tag}_qd"]), T(ref[f"{tag}_qdd"]))
    if fn == "fdsva":
        for k, g in zip(FD_TENSORS, td.fdsva_so(m, *args)):
            close(g, ref[f"{tag}_fdsva_{k}"])
        return
    f = td.idsva_so_native if fn == "native" else td.idsva_so_ad
    for k, g in zip(TENSORS, f(m, *args)):
        assert g.shape == (B_QUAD, m.nv, m.nv, m.nv)
        close(g, ref[f"{tag}_native_{k}"])


def test_quat_humanoid_native_matches_rbdtpu(tmodels, ref):
    m = tmodels["hum"]
    args = (T(ref["hum_q"]), T(ref["hum_qd"]), T(ref["hum_qdd"]))
    out = td.idsva_so(m, *args)
    for k, g in zip(TENSORS, out):
        assert g.shape == (1, 36, 36, 36)
        close(g, ref[f"hum_native_{k}"])


@pytest.mark.parametrize("tag", ["rpy", "quat"])
def test_native_matches_own_ad(tmodels, tag):
    """The port's native sweep against its own AD at unbatched and batched
    states the fixture did not record."""
    m = tmodels[tag]
    q, qd, qdd = _states(m, 2, seed=15)
    for sl in (0, slice(None)):
        args = (T(q[sl]), T(qd[sl]), T(qdd[sl]))
        for a, b in zip(td.idsva_so_native(m, *args),
                        td.idsva_so_ad(m, *args)):
            close(a, b.numpy())


def test_backward_pass_with_fxx_matches_rbdtpu():
    """The full-DDP Riccati sweep on a random well-posed problem (n = 4,
    nx = 8, nu = 4, H = 5): k, K, dV1 and ok against rbdtpu's."""
    rng = np.random.default_rng(16)
    Bp, Hk, n = 2, 5, 4
    nx, nu = 2 * n, n
    A = np.eye(nx) + 0.1 * rng.standard_normal((Bp, Hk, nx, nx))
    Bm = 0.1 * rng.standard_normal((Bp, Hk, nx, nu))
    lx = rng.standard_normal((Bp, Hk, nx))
    lu = rng.standard_normal((Bp, Hk, nu))
    lxx = np.eye(nx)
    luu = 0.5 * np.eye(nu)
    lux = 0.1 * rng.standard_normal((Bp, Hk, nu, nx))
    lfx = rng.standard_normal((Bp, nx))
    lfxx = np.broadcast_to(2.0 * np.eye(nx), (Bp, nx, nx)).copy()
    reg = np.full(Bp, 1e-3)
    fxx = [rng.standard_normal((Bp, Hk, n, n, n)) for _ in range(4)]
    fxx[0] = fxx[0] + fxx[0].swapaxes(-1, -2)
    fxx[2] = fxx[2] + fxx[2].swapaxes(-1, -2)
    args = (A, Bm, lx, lu, lxx, luu, lux, lfx, lfxx, reg)
    want = js.backward_pass(*(jnp.asarray(a) for a in args),
                            fxx=tuple(jnp.asarray(f) for f in fxx), dt=DT)
    got = ts.backward_pass(*(T(a) for a in args),
                           fxx=tuple(T(f) for f in fxx), dt=DT)
    assert got[3].tolist() == np.asarray(want[3]).tolist() == [True, True]
    for g, w in zip(got[:3], want[:3]):
        close(g, w, tol=1e-12)


@pytest.mark.parametrize("tag", ["rpy", "quat"])
def test_exact_hessian_ddp_matches_rbdtpu(tmodels, ref, tag):
    """tests/test_idsva.py's exact-Hessian solves (H = 8, dt = 0.02, 6
    iterations) against rbdtpu's recording: the J history at relative
    1e-9, U at 1e-6; J descends."""
    m = tmodels[tag]
    cost = ts.quadratic_tracking_cost(m, ref[f"{tag}_ddp_goal"], **W)
    state, hist = ts.ddp_solve(
        m, cost, T(ref[f"{tag}_ddp_x0"]),
        torch.zeros(H, m.nv, dtype=torch.float64),
        ts.DDPConfig(iters=ITERS, dt=DT, exact_hessians=True))
    np.testing.assert_allclose(hist.numpy(), ref[f"{tag}_ddp_J"], rtol=1e-9)
    assert np.abs(state.U.numpy() - ref[f"{tag}_ddp_U"]).max() < 1e-6
    assert hist[-1] < hist[0]


def test_exact_hessians_refuse_the_parallel_scan(tmodels):
    """As in rbdtpu: parallel_riccati=True cannot fold the fxx terms;
    under exact_hessians every other backward option takes the plain
    sweep."""
    from rbdtpu_torch.solver.ddp import _backward_route

    m = tmodels["rpy"]
    x0 = torch.zeros(1, m.nx, dtype=torch.float64)
    U0 = torch.zeros(1, 2, m.nv, dtype=torch.float64)
    cost = ts.quadratic_tracking_cost(m, np.zeros(m.nx))
    with pytest.raises(ValueError):
        ts.ddp_solve(m, cost, x0, U0, ts.DDPConfig(
            exact_hessians=True, parallel_riccati=True))
    for option in ({}, {"fused_riccati": True}, {"fused_riccati": None}):
        cfg = ts.DDPConfig(exact_hessians=True, **option)
        assert _backward_route(m, cfg, on_card=True) == "plain"
