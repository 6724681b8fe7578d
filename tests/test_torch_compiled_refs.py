"""The rollout path of rbdtpu_torch against rbdtpu functions that JAX
traces and compiles whole, float64 on the CPU, at 1e-9 (tests/test_kernels.py,
tests/test_parity.py):

- the plain versions of the path's kernels against rbdtpu's Pallas kernels
  themselves, run in interpret mode as rbdtpu's own tests run them on a
  CPU, at B=8: K10 ``rnea_fused``, K6 ``fd_step_minv_fused(dense_minv=True)``
  and K5 ``rollout_fused_multi`` (route "minv", per-knot wrenches, H=4);
  one case each, the other cases are in tests/test_torch_rollout.py against
  rbdtpu's jnp functions;
- ``solver.rollout`` with and without f_ext, plain and through the step
  kernel's CPU route, against rbdtpu's scanned ``rollout`` over H=6 steps at
  the magnitudes of tests/test_kernels.py:806-809.

They sit apart from tests/test_torch_rollout.py, whose eager references pay
their per-operation compile once per test process."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_state
from rbdtpu.kernels import fused as jfused
from rbdtpu.solver import rollout as jrollout
from rbdtpu_torch.kernels import (
    fd_step_minv_plain, launches, reset_launches, rnea_plain,
    rollout_multi_plain,
)
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import normalize_f_ext, rollout

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


def test_rnea_matches_rbdtpu_pallas_kernel(arm7, tm, rng):
    q, qd, qdd = random_state(rng, arm7, batch=(B,))
    ref = jfused.rnea_fused(arm7, jnp.asarray(q), jnp.asarray(qd),
                            jnp.asarray(qdd))
    _close(rnea_plain(tm, T(q), T(qd), T(qdd)), ref)


def test_fd_step_minv_dense_matches_rbdtpu_pallas_kernel(arm7, tm, rng):
    q, qd, u = random_state(rng, arm7, batch=(B,))
    x = np.concatenate([q, qd], -1)
    ref = jfused.fd_step_minv_fused(arm7, jnp.asarray(x), jnp.asarray(u), DT,
                                    dense_minv=True)
    _close(fd_step_minv_plain(tm, T(x), T(u), DT, dense_minv=True), ref)


def test_rollout_multi_fext_matches_rbdtpu_pallas_kernel(arm7, tm, rng):
    q, qd, _ = random_state(rng, arm7, batch=(B,))
    x0 = np.concatenate([q, 0.3 * qd], -1)
    U = rng.uniform(-0.5, 0.5, (4, B, arm7.nv))
    F = rng.normal(0, 15.0, (4, arm7.nb, 6))
    ref = jfused.rollout_fused_multi(arm7, jnp.asarray(x0), jnp.asarray(U),
                                     DT, route="minv", f_ext=jnp.asarray(F))
    _close(rollout_multi_plain(tm, T(x0), T(U), DT, route="minv", f_ext=T(F)),
           ref)


# ---- solver.rollout ----

@pytest.fixture(scope="module")
def rollout_refs(arm7):
    """rbdtpu's rollout over H=6, once per wrench form: X (B, H+1, nx)."""
    rng = np.random.default_rng(11)
    q, qd, _ = random_state(rng, arm7, batch=(B,))
    x0 = np.concatenate([q, 0.3 * qd], -1)
    U = rng.uniform(-0.5, 0.5, (B, 6, arm7.nv))
    F = rng.normal(0, 15.0, (6, arm7.nb, 6))
    forms = {"none": None, "constant": F[0], "per_knot": F}
    refs = {k: np.asarray(jrollout(arm7, jnp.asarray(x0), jnp.asarray(U), DT,
                                   f_ext=None if f is None
                                   else jnp.asarray(f)))
            for k, f in forms.items()}
    return x0, U, forms, refs


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("form", ["none", "constant", "per_knot"])
def test_rollout_matches_rbdtpu(rollout_refs, tm, form, fused):
    """fused=True takes the step kernel's CPU route (its plain version)."""
    x0, U, forms, refs = rollout_refs
    f = forms[form]
    reset_launches()
    X = rollout(tm, T(x0), T(U), DT, fused=fused,
                f_ext=None if f is None else T(f))
    assert tuple(X.shape) == (B, 7, tm.nx)
    _close(X, refs[form])
    assert all(v == 0 for v in launches.values()), launches


def test_normalize_f_ext_shapes(tm):
    F = torch.ones(tm.nb, 6, dtype=torch.float64)
    assert tuple(normalize_f_ext(tm, F, 5, torch.float64).shape) == (5, tm.nb, 6)
    assert normalize_f_ext(tm, None, 5, torch.float64) is None
    for bad in (torch.zeros(3, 6), torch.zeros(4, tm.nb, 6)):
        with pytest.raises(ValueError):
            normalize_f_ext(tm, bad, 5, torch.float64)
