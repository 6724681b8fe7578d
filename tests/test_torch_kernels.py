"""The plain PyTorch versions of the four CUDA kernels against rbdtpu,
float64 on the CPU (1e-9, the tolerance of tests/test_kernels.py), and the
CPU routing of their wrappers.  The kernels themselves run only on a card:
tests/test_torch_cuda.py holds each against its plain version there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbdtpu import dynamics as jdyn
from rbdtpu.kinematics import fk as jfk
from rbdtpu.solver import costs as jcosts
from rbdtpu.solver import ddp as jddp
from rbdtpu.solver import euler_semi_implicit as jeuler
from rbdtpu_torch.kernels import (
    colvec, ee_gn_fused, fd_step_fused, feedback_rollout_fused, fk_lane, fused,
    launches, linearize_parts_fused, reset_launches,
)
from rbdtpu_torch.model import load_asset

TOL = 1e-9
DT = 0.01
TARGET = (0.3, 0.2, 0.8)


@pytest.fixture(scope="module")
def tm():
    return load_asset("arm7", dtype=torch.float64)


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()))


def test_fd_step_plain_matches_aba_euler(arm7, tm, rng):
    x = rng.uniform(-0.5, 0.5, (16, tm.nx))
    u = rng.uniform(-1, 1, (16, tm.nv))
    q, qd = x[:, :7], x[:, 7:]
    ref = jeuler(arm7, x, jdyn.aba(arm7, q, qd, u), DT)
    _close(fused.fd_step_plain(tm, torch.tensor(x), torch.tensor(u), DT), ref)


@pytest.mark.parametrize("clip", [False, True])
def test_feedback_rollout_plain_matches_forward_pass(arm7, tm, rng, clip):
    """The whole line search: rbdtpu's forward_pass over the alpha ladder
    against the port's rollout with each alpha folded into k."""
    B, H, n, nx = 3, 6, tm.nv, tm.nx
    X = rng.uniform(-0.5, 0.5, (B, H + 1, nx))
    U = rng.uniform(-2, 2, (B, H, n))
    k = rng.uniform(-1, 1, (B, H, n))
    K = 0.1 * rng.standard_normal((B, H, n, nx))
    alphas = np.array([1.0, 0.5, 0.25])
    u_clip = np.full(n, 1.5) if clip else None
    cost = jcosts.quadratic_tracking_cost(arm7, jnp.zeros(nx))
    Xs, Us, _ = jax.jit(lambda *a: jddp.forward_pass(
        arm7, cost, *a, DT, -9.81,
        u_clip=None if u_clip is None else jnp.asarray(u_clip)))(
            X, U, k, K, jnp.asarray(alphas))
    T = torch.tensor
    for i, a in enumerate(alphas):
        Xo, Uo = fused.feedback_rollout_plain(
            tm, T(X[:, 0]), T(X[:, :-1]), T(U), T(a * k), T(K), DT,
            u_clip=None if u_clip is None else T(u_clip))
        _close(Xo, np.asarray(Xs)[i, :, 1:])
        _close(Uo, np.asarray(Us)[i])


def test_linearize_parts_plain_matches_rbdtpu(arm7, tm, rng):
    q, qd, u = (rng.uniform(-1, 1, (8, tm.nv)) for _ in range(3))
    qdd = jdyn.aba(arm7, q, qd, u)
    dcq, dcd = jdyn.rnea_grad(arm7, q, qd, qdd, split=True)
    out = colvec.linearize_parts_plain(tm, *(torch.tensor(a) for a in (q, qd, u)))
    for o, r in zip(out, (jdyn.minv(arm7, q), dcq, dcd, qdd)):
        _close(o, r)


@pytest.mark.parametrize("gn", [True, False])
def test_ee_gn_plain_matches_rbdtpu(arm7, tm, rng, gn):
    q = rng.uniform(-1.5, 1.5, (16, tm.nq))
    e = np.asarray(jfk.ee_pose(arm7, q))[:, 0, :3] - np.array(TARGET)
    J = np.asarray(jfk.ee_position_jacobian_tangent(arm7, q))[:, 0]
    out = fk_lane.ee_gn_plain(tm, torch.tensor(q), TARGET, gn=gn)
    _close(out[0], e)
    if gn:
        _close(out[1], np.einsum("bri,br->bi", J, e))
        _close(out[2], np.einsum("bri,brj->bij", J, J))
    else:
        assert out[1] is None and out[2] is None


def test_cpu_tensors_take_the_plain_versions(tm, rng):
    """A CPU tensor runs the plain version and launches nothing."""
    reset_launches()
    T = lambda *s: torch.tensor(rng.uniform(-0.5, 0.5, s))
    x, u = T(4, tm.nx), T(4, tm.nv)
    torch.testing.assert_close(fd_step_fused(tm, x, u, DT),
                               fused.fd_step_plain(tm, x, u, DT))
    args = (T(4, tm.nx), T(4, 3, tm.nx), T(4, 3, tm.nv), T(4, 3, tm.nv),
            T(4, 3, tm.nv, tm.nx))
    for a, b in zip(feedback_rollout_fused(tm, *args, DT),
                    fused.feedback_rollout_plain(tm, *args, DT)):
        torch.testing.assert_close(a, b)
    q, qd = T(4, tm.nv), T(4, tm.nv)
    for a, b in zip(linearize_parts_fused(tm, q, qd, u),
                    colvec.linearize_parts_plain(tm, q, qd, u)):
        torch.testing.assert_close(a, b)
    for a, b in zip(ee_gn_fused(tm, q, TARGET),
                    fk_lane.ee_gn_plain(tm, q, TARGET)):
        torch.testing.assert_close(a, b)
    ee_gn_fused(tm, q, TARGET, gn=False)
    assert all(v == 0 for v in launches.values()), launches


def test_model_tables_layout(tm):
    """The kernels' per-body table: compact (E, r) rebuilds Xtree, and the
    other fields are the model's own."""
    from rbdtpu_torch.kernels import _lib

    tab, itab = _lib.model_tables(tm, torch.device("cpu"), torch.float64)
    rows = tab.numpy().reshape(tm.nb, _lib.STRIDE)
    for i, row in enumerate(rows):
        E, r = row[0:9].reshape(3, 3), row[9:12]
        rx = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
        X = np.block([[E, np.zeros((3, 3))], [-E @ rx, E]])
        np.testing.assert_allclose(X, tm.host_data["Xtree"][i], atol=1e-15)
        np.testing.assert_array_equal(row[12:15], tm.host_data["axis"][i])
        np.testing.assert_array_equal(row[15:51].reshape(6, 6),
                                      tm.host_data["I"][i])
        np.testing.assert_array_equal(row[51:57], tm.host_data["S"][i])
        T = tm.host_data["Ttree"][i]
        np.testing.assert_array_equal(row[57:66].reshape(3, 3), T[:3, :3])
        np.testing.assert_array_equal(row[66:69], T[:3, 3])
    assert itab.tolist() == list(tm.parent) + list(tm.joint_type)
