"""The port's reference-compatible mirror (``rbdtpu_torch.compat``)
against rbdtpu's (``rbdtpu.compat.RBDReferenceTPU``), in float64 on the
CPU: every method, with its keywords, on arm7, the rpy quadruped and the
quaternion humanoid (each with joint damping), called as
``rbdtpu_torch.oracle.compat_calls.calls`` calls them, its outputs in the
reference's layouts held at 1e-9 (relative where a value exceeds 1) with
their shapes equal.  Where rbdtpu's mirror refuses a call on a model, the
port's must refuse it too.  rbdtpu's results are recorded in
tests/data/compat_refs.npz, so this file runs no JAX computation."""
import numpy as np
import pytest
import torch

from make_compat_fixture import PATH
from rbdtpu_torch.compat import RBDReferenceTorch
from rbdtpu_torch.model import LEAVES, STATIC, load_asset, model_from_numpy
from rbdtpu_torch.oracle.compat_calls import (
    DAMPING, MODELS, NAMES, STATE_KEYS, calls)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One state a call: one thread is as fast and leaves the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


def damped_model(tag: str):
    """The bundled model with joint damping DAMPING, as the fixture's."""
    name, kw = MODELS[tag]
    m = load_asset(name, device="cpu", dtype=torch.float64, **kw)
    leaves = {k: getattr(m, k).numpy() for k in LEAVES}
    leaves["damping"] = np.full(m.nb, DAMPING)
    return model_from_numpy(leaves, {k: getattr(m, k) for k in STATIC},
                            device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def mirrors():
    return {tag: RBDReferenceTorch(damped_model(tag)) for tag in MODELS}


def close(got, want, tol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("tag", list(MODELS))
@pytest.mark.parametrize("call", NAMES)
def test_mirror_matches_rbdtpu(ref, mirrors, tag, call):
    s = {k: ref[f"{tag}/in/{k}"] for k in STATE_KEYS}
    fn = dict(calls(mirrors[tag], tag, s))[call]
    if call in set(ref[f"{tag}/refused"].tolist()):
        with pytest.raises((ValueError, NotImplementedError, TypeError)):
            fn()
        return
    out = fn()
    n = sum(1 for k in ref if k.startswith(f"{tag}/{call}/"))
    assert len(out) == n
    for i, o in enumerate(out):
        close(o, ref[f"{tag}/{call}/{i}"])


def test_mirror_moves_the_model(mirrors):
    """``device`` places the computation; the mirror reads numpy and
    writes numpy float64, whatever the model's dtype."""
    m32 = load_asset("arm7", device="cpu", dtype=torch.float32)
    c = RBDReferenceTorch(m32, device="cpu")
    assert c.model.device.type == "cpu"
    out = c.minv(np.zeros(m32.nq))
    assert out.dtype == np.float64 and out.shape == (m32.nv, m32.nv)
