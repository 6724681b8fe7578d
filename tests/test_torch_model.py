"""rbdtpu_torch model layer against rbdtpu: the URDF parse, the numpy
hand-over (model_from_numpy), the bundled URDF copies, the default device
and the package boundary (no JAX)."""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rbdtpu.model import load_asset as jax_load_asset
from rbdtpu_torch.model import (
    LEAVES, STATIC, load_asset, make_model, model_from_numpy, parse_urdf,
)

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
    m = load_asset(name, device="cpu", dtype=torch.float64, **kw)
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
                         device="cpu", dtype=torch.float64)
    own = load_asset(name, device="cpu", dtype=torch.float64, **kw)
    for k in LEAVES:
        assert torch.equal(getattr(m, k), getattr(own, k)), k
    for k, v in own.host_data.items():
        np.testing.assert_array_equal(m.host_data[k], v, err_msg=k)
        # the kernel tables' source equals rbdtpu's host_data
        np.testing.assert_array_equal(
            v, np.asarray(dict(ref.host_data)[k], dtype=np.float64).reshape(
                v.shape), err_msg=k)


REFUSED = [("dynamics", "quat")] + [
    (k, root) for root in ("quat", "rpy")
    for k in ("ee_gn", "ee_err", "rollout_multi")
] + [(k, "quat") for k in ("fd_step", "feedback_rollout", "linearize_parts",
                           "rnea", "fd_step_minv")]


@pytest.mark.parametrize("what,root", REFUSED,
                         ids=[f"{w}-{r}" for w, r in REFUSED])
def test_floating_base_dynamics_refuse(what, root):
    """What the port does not cover raises NotImplementedError rather than
    computing a wrong answer: the quaternion root everywhere (the EE
    Jacobian's root columns included), the rpy root in K5, which has no
    floating-base instantiation, and K4 on an rpy tree past its fb16
    instantiation's 16 bodies (the humanoid's 31).  The CUDA kernels refuse
    before launching, so this needs no card."""
    from rbdtpu_torch.dynamics import aba
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.kinematics import ee_position_jacobian_tangent

    m = load_asset("quadruped12", device="cpu", dtype=torch.float64,
                   floating_base=True, root_quat=root == "quat")
    if what.startswith("ee_") and root == "rpy":
        assert _lib.size_class(what, m) == "fb16"
        big = load_asset("humanoid30", device="cpu", dtype=torch.float64,
                         floating_base=True)
        with pytest.raises(ValueError, match="31 bodies"):
            _lib.size_class(what, big)
        return
    if what.startswith("ee_"):
        with pytest.raises(NotImplementedError):
            ee_position_jacobian_tangent(
                m, torch.zeros(2, m.nq, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        if what == "dynamics":
            q = torch.zeros(2, m.nq, dtype=torch.float64)
            v = torch.zeros(2, m.nv, dtype=torch.float64)
            aba(m, q, v, v)
        else:
            _lib.size_class(what, m)


def test_rpy_root_reaches_its_kernels():
    """K1-K3, K6 and K10 take the rpy root in their floating-base
    instantiation."""
    from rbdtpu_torch.kernels import _lib

    m = load_asset("quadruped12", device="cpu", dtype=torch.float64,
                   floating_base=True)
    for k in ("fd_step", "feedback_rollout", "linearize_parts", "rnea",
              "fd_step_minv"):
        assert _lib.size_class(k, m) == "fb16"
    arm = load_asset("arm7", device="cpu", dtype=torch.float64)
    assert _lib.size_class("rollout_multi", arm) == "n8"


def test_import_leaves_jax_out():
    code = ("import sys, rbdtpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rbdtpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("name", ["arm7", "quadruped12", "humanoid30"])
def test_bundled_urdfs_are_copies_of_rbdtpus(name):
    """The port reads its own copies of the URDFs; they stay byte-identical
    to the reference package's."""
    def read(pkg):
        with open(os.path.join(REPO, pkg, "assets", f"{name}.urdf"), "rb") as f:
            return f.read()

    assert read("rbdtpu_torch") == read("rbdtpu")


@pytest.mark.parametrize("fn", [load_asset, parse_urdf, make_model,
                                model_from_numpy])
def test_entry_points_default_to_the_card(fn):
    """Every model entry point builds on the card unless given a device;
    without a card the default raises (no silent CPU fallback)."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available() and fn is load_asset:
        with pytest.raises((AssertionError, RuntimeError)):
            load_asset("arm7")
