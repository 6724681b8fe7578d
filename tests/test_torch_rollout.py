"""The forward-dynamics rollout path of rbdtpu_torch against rbdtpu, float64
on the CPU, on the same numpy inputs, at 1e-9 (tests/test_parity.py,
tests/test_kernels.py), rollouts over H <= 4 steps at the magnitudes of
tests/test_kernels.py:806-809:

- world-frame external wrenches (f_ext) in rnea, aba and forward_dynamics;
- the plain versions of the path's kernels — RNEA (K10), the M^-1 + RNEA
  step (K6), the whole-horizon rollout (K5), the scan of the ABA step
  (``rollout_fused``) — against rbdtpu's jnp functions, which rbdtpu's own
  tests tie to its Pallas kernels (tests/test_torch_compiled_refs.py holds
  one case of each against those kernels in interpret mode, and
  ``solver.rollout`` against rbdtpu's);
- the CPU routing of the kernels' wrappers.

The CUDA kernels run only on a card: tests/test_torch_cuda.py holds each
against its plain version there."""
import numpy as np
import pytest
import torch

from conftest import random_state
from rbdtpu import dynamics as jdyn
from rbdtpu.model import parse_urdf as jax_parse_urdf
from rbdtpu.solver import euler_semi_implicit as jeuler
from rbdtpu.solver import split_state as jsplit
from rbdtpu_torch import dynamics as tdyn
from rbdtpu_torch.kernels import (
    fd_step_fused, fd_step_minv_fused, fd_step_minv_plain, fd_step_plain,
    launches, reset_launches, rnea_fused, rnea_plain, rollout_fused,
    rollout_fused_multi, rollout_multi_plain,
)
from rbdtpu_torch.model import load_asset, parse_urdf
from test_torch_cuda import mixed_tree_urdf

TOL = 1e-9
B, DT = 8, 0.01
T = torch.tensor


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def tm():
    return load_asset("arm7", device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def models(request, arm7, tm):
    """(rbdtpu model, port model): arm7, or the small mixed
    revolute/prismatic tree whose prismatic joints sit on every sweep and on
    the wrench chain."""
    if request.param == "mixed":
        urdf = mixed_tree_urdf()
        return (jax_parse_urdf(urdf, dtype=np.float64),
                parse_urdf(urdf, device="cpu", dtype=torch.float64))
    return arm7, tm


def _jstep(model, route, x, u, fe):
    """rbdtpu's jnp step: aba or forward_dynamics, then semi-implicit
    Euler."""
    q, qd = jsplit(model, x)
    qdd = (jdyn.forward_dynamics(model, q, qd, u, f_ext=fe) if route == "minv"
           else jdyn.aba(model, q, qd, u, f_ext=fe))
    return jeuler(model, x, qdd, DT)


def _rollout_inputs(model, rng, H, B_=B):
    q, qd, _ = random_state(rng, model, batch=(B_,))
    x0 = np.concatenate([q, 0.3 * qd], -1)
    U = rng.uniform(-0.5, 0.5, (H, B_, model.nv))
    F = rng.normal(0, 15.0, (H, model.nb, 6))
    return x0, U, F


# ---- f_ext in the dynamics ----

# (rbdtpu, port) on numpy (q, qd, u, f_ext)
DYNAMICS = {
    "rnea": (lambda m, q, qd, u, fe: jdyn.rnea(m, q, qd, u, f_ext=fe)[0],
             lambda m, q, qd, u, fe: tdyn.rnea(m, q, qd, u, f_ext=fe)[0]),
    "aba": (lambda m, q, qd, u, fe: jdyn.aba(m, q, qd, u, f_ext=fe),
            lambda m, q, qd, u, fe: tdyn.aba(m, q, qd, u, f_ext=fe)),
    "forward_dynamics": (
        lambda m, q, qd, u, fe: jdyn.forward_dynamics(m, q, qd, u, f_ext=fe),
        lambda m, q, qd, u, fe: tdyn.forward_dynamics(m, q, qd, u,
                                                      f_ext=fe)),
}
# forward_dynamics adds only M^-1 (tests/test_torch_dynamics.py) to the
# wrench-carrying rnea, so the mixed tree holds rnea and aba
FEXT_CASES = [(name, fn, batched) for name in ("arm7", "mixed")
              for fn in sorted(DYNAMICS) for batched in (False, True)
              if not (name == "mixed" and fn == "forward_dynamics")]


@pytest.mark.parametrize(
    "models,fn,batched", FEXT_CASES, indirect=["models"],
    ids=[f"{c[0]}-{c[1]}-{'batched' if c[2] else 'shared'}"
         for c in FEXT_CASES])
def test_dynamics_with_fext_match_rbdtpu(models, fn, batched, rng):
    """f_ext (nb, 6) shared by the batch, or (B, nb, 6)."""
    jm, m = models
    q, qd, u = random_state(rng, jm, batch=(B,))
    fe = rng.normal(0, 15.0, ((B,) if batched else ()) + (m.nb, 6))
    ref_fn, port_fn = DYNAMICS[fn]
    _close(port_fn(m, T(q), T(qd), T(u), T(fe)), ref_fn(jm, q, qd, u, fe))


# ---- the kernels' plain versions ----

@pytest.mark.parametrize("models", ["arm7", "mixed"], indirect=True)
@pytest.mark.parametrize("with_qdd", [True, False], ids=["qdd", "bias"])
def test_rnea_plain_matches_rbdtpu(models, with_qdd, rng):
    jm, m = models
    q, qd, qdd = random_state(rng, jm, batch=(B,))
    a = qdd if with_qdd else None
    _close(rnea_plain(m, T(q), T(qd), None if a is None else T(a)),
           jdyn.rnea(jm, q, qd, a)[0])


@pytest.mark.parametrize("wrench", [None, "shared", "batched"])
def test_fd_step_minv_plain_matches_rbdtpu(arm7, tm, wrench, rng):
    """Both dense_minv values, without wrenches and with (nb, 6) or
    (B, nb, 6) ones."""
    q, qd, u = random_state(rng, arm7, batch=(B,))
    x = np.concatenate([q, qd], -1)
    fe = (None if wrench is None else
          rng.normal(0, 10.0, ((B,) if wrench == "batched" else ()) +
                     (tm.nb, 6)))
    ref = _jstep(arm7, "minv", x, u, fe)
    for dense_minv in (False, True):
        _close(fd_step_minv_plain(tm, T(x), T(u), DT, dense_minv=dense_minv,
                                  f_ext=None if fe is None else T(fe)), ref)


@pytest.mark.parametrize("route", ["aba", "minv"])
def test_rollout_multi_plain_matches_rbdtpu(arm7, tm, route, rng):
    """H=3 steps of rbdtpu's jnp step, free and with per-knot wrenches
    (H, nb, 6)."""
    x0, U, F = _rollout_inputs(arm7, rng, H=3)
    for wrench in (False, True):
        x = x0
        for t in range(3):
            x = _jstep(arm7, route, x, U[t], F[t] if wrench else None)
        _close(rollout_multi_plain(tm, T(x0), T(U), DT, route=route,
                                   f_ext=T(F) if wrench else None), x)


def test_rollout_fused_matches_rbdtpu_aba_scan(arm7, tm, rng):
    x0, U, _ = _rollout_inputs(arm7, rng, H=4)
    x = x0
    for t in range(4):
        x = _jstep(arm7, "aba", x, U[t], None)
    _close(rollout_fused(tm, T(x0), T(U), DT), x)


def test_cpu_tensors_take_the_plain_versions(tm, rng):
    """Every new wrapper runs its plain version on CPU tensors, at an odd
    batch (no padding), and launches nothing."""
    reset_launches()
    Bo = 5
    x0, U, F = (T(a) for a in _rollout_inputs(tm, rng, H=2, B_=Bo))
    q, qd = x0[:, :tm.nq], x0[:, tm.nq:]
    fe = F[0].contiguous()
    torch.testing.assert_close(rnea_fused(tm, q, qd), rnea_plain(tm, q, qd))
    torch.testing.assert_close(rnea_fused(tm, q, qd, U[0]),
                               rnea_plain(tm, q, qd, U[0]))
    for dense in (False, True):
        torch.testing.assert_close(
            fd_step_minv_fused(tm, x0, U[0], DT, dense_minv=dense, f_ext=fe),
            fd_step_minv_plain(tm, x0, U[0], DT, f_ext=fe))
    torch.testing.assert_close(fd_step_fused(tm, x0, U[0], DT, f_ext=fe),
                               fd_step_plain(tm, x0, U[0], DT, f_ext=fe))
    for route in ("aba", "minv"):
        out = rollout_fused_multi(tm, x0, U, DT, route=route, f_ext=F)
        assert tuple(out.shape) == (Bo, tm.nx)
        torch.testing.assert_close(
            out, rollout_multi_plain(tm, x0, U, DT, route=route, f_ext=F))
    torch.testing.assert_close(rollout_fused(tm, x0, U, DT),
                               rollout_multi_plain(tm, x0, U, DT))
    with pytest.raises(ValueError):
        rollout_fused_multi(tm, x0, U, DT, route="crba")
    assert all(v == 0 for v in launches.values()), launches
