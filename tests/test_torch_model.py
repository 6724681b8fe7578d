"""rbdtpu_torch model layer against rbdtpu: the URDF parse, the numpy
hand-over (model_from_numpy) and the package boundary (no JAX)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rbdtpu.model import load_asset as jax_load_asset
from rbdtpu_torch.model import LEAVES, STATIC, load_asset, model_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = [
    ("arm7", {}),
    ("quadruped12", {}),
    ("quadruped12", {"floating_base": True}),
    ("quadruped12", {"floating_base": True, "root_quat": True}),
    ("humanoid30", {"floating_base": True}),
]


def _ref(name, kw):
    return jax_load_asset(name, dtype=np.float64, **kw)


@pytest.mark.parametrize("name,kw", MODELS)
def test_load_asset_matches_rbdtpu(name, kw):
    ref = _ref(name, kw)
    m = load_asset(name, dtype=torch.float64, **kw)
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(m, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    for k in STATIC:
        assert getattr(m, k) == getattr(ref, k), k
    assert (m.nb, m.nq, m.nv, m.nx) == (ref.nb, ref.nq, ref.nv, ref.nx)
    assert m.leaves() == ref.leaves()
    np.testing.assert_array_equal(m.u_limit_vector().numpy(),
                                  np.asarray(ref.u_limit_vector()))


@pytest.mark.parametrize("name,kw", MODELS)
def test_model_from_numpy_matches_load_asset(name, kw):
    ref = _ref(name, kw)
    m = model_from_numpy({k: np.asarray(getattr(ref, k)) for k in LEAVES},
                         {k: getattr(ref, k) for k in STATIC},
                         dtype=torch.float64)
    own = load_asset(name, dtype=torch.float64, **kw)
    for k in LEAVES:
        assert torch.equal(getattr(m, k), getattr(own, k)), k
    for k, v in own.host_data.items():
        np.testing.assert_array_equal(m.host_data[k], v, err_msg=k)
        # the kernel tables' source equals rbdtpu's host_data
        np.testing.assert_array_equal(
            v, np.asarray(dict(ref.host_data)[k], dtype=np.float64).reshape(
                v.shape), err_msg=k)


def test_floating_base_dynamics_refuse():
    from rbdtpu_torch.dynamics import aba

    m = load_asset("quadruped12", dtype=torch.float64, floating_base=True)
    q = torch.zeros(2, m.nq, dtype=torch.float64)
    v = torch.zeros(2, m.nv, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        aba(m, q, v, v)


def test_import_leaves_jax_out():
    code = ("import sys, rbdtpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rbdtpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
