"""rbdtpu_torch on the rpy floating root against rbdtpu: the root's
transforms, RNEA (with world-frame wrenches), ABA, M^-1, forward dynamics,
the RNEA gradient (root-pose columns included) and the linearisation
kernel's plain version, float64 on the CPU on quadruped12 with
floating_base=True, at 1e-9 relative to each output's scale (the
repository's dynamics parity tolerance, tests/test_parity.py).

rbdtpu's outputs on one set of numpy inputs are recorded in
tests/data/floating_rpy_refs.npz by tests/make_floating_fixture.py; the
port's functions take the same inputs.  The ``slow`` test re-runs rbdtpu
live (eagerly, about 20 s) and holds the recording to it."""
import numpy as np
import pytest
import torch

from make_floating_fixture import PATH, reference
from rbdtpu_torch import dynamics as tdyn
from rbdtpu_torch.dynamics import xforms as txf
from rbdtpu_torch.kernels import colvec, fd_step_fused, fused
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.spatial import ops as tops
from rbdtpu_torch.spatial import transforms as ttf

TOL = 1e-9


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def tm():
    return load_asset("quadruped12", device="cpu", dtype=torch.float64,
                      floating_base=True)


@pytest.fixture(scope="module")
def recorded():
    with np.load(PATH) as f:
        return dict(f)


@pytest.fixture(scope="module")
def inputs(recorded):
    return tuple(recorded[k] for k in ("q", "qd", "u", "fe"))


@pytest.fixture(scope="module")
def refs(recorded):
    """rbdtpu's outputs on ``inputs``; the gradient at the ABA
    acceleration, as the linearisation takes it."""
    refs = {k: recorded[k] for k in ("rnea_fext", "aba_fext", "aba", "minv",
                                     "forward_dynamics")}
    refs["rnea_grad"] = (recorded["rnea_grad_dq"], recorded["rnea_grad_dqd"])
    return refs


def _port(name, tm, q, qd, u, fe, qdd):
    T = torch.tensor
    q, qd, u, fe, qdd = (T(a) for a in (q, qd, u, fe, qdd))
    return {
        "rnea_fext": lambda: tdyn.rnea(tm, q, qd, u, f_ext=fe)[0],
        "aba_fext": lambda: tdyn.aba(tm, q, qd, u, f_ext=fe),
        "aba": lambda: tdyn.aba(tm, q, qd, u),
        "minv": lambda: tdyn.minv(tm, q),
        "forward_dynamics": lambda: tdyn.forward_dynamics(tm, q, qd, u),
        "rnea_grad": lambda: tdyn.rnea_grad(tm, q, qd, qdd, split=True),
    }[name]()


@pytest.mark.parametrize("name", ["rnea_fext", "aba_fext", "aba", "minv",
                                  "forward_dynamics", "rnea_grad"])
def test_dynamics_match_rbdtpu(tm, inputs, refs, name):
    out = _port(name, tm, *inputs, refs["aba"])
    ref = refs[name]
    if isinstance(ref, tuple):  # (dc/dq, dc/dqd)
        for o, r in zip(out, ref):
            close(o, r)
    else:
        close(out, ref)


def test_linearize_parts_plain_matches_rbdtpu(tm, inputs, refs):
    """K3's plain version: M^-1, dc/dq (root-pose columns by forward-mode
    AD) and dc/dqd at the ABA acceleration, and that acceleration."""
    q, qd, u, _ = (torch.tensor(a) for a in inputs)
    Mi, dcq, dcd, qdd = colvec.linearize_parts_plain(tm, q, qd, u)
    close(Mi, refs["minv"])
    close(dcq, refs["rnea_grad"][0])
    close(dcd, refs["rnea_grad"][1])
    close(qdd, refs["aba"])


def test_root_transforms_match_rbdtpu(tm, recorded):
    """The root's rotation and transforms; plux and hom take rbdtpu's
    E = R^T, as recorded, so both packages see the same input."""
    q6 = torch.tensor(recorded["q"][:, 0:6])
    close(ttf.rpy_to_R(q6[:, 3:6]), recorded["rpy_to_R"])
    E = torch.tensor(recorded["E"])
    close(ttf.plux(E, q6[:, 0:3]), recorded["plux"])
    close(ttf.hom(E, q6[:, 0:3]), recorded["hom"])
    close(ttf.floating_spatial_x(tm.Xtree[0], q6),
          recorded["floating_spatial_x"])
    close(ttf.floating_hom_T(tm.Ttree[0], q6), recorded["floating_hom_T"])


@pytest.mark.parametrize("fn", ["joint_transforms_list",
                                "joint_transforms_hom_list"])
def test_joint_transforms_match_rbdtpu(tm, recorded, fn):
    """Every body's transform, the root's from q[0:6] and joint i's from
    q[i + 5]."""
    q = recorded["q"]
    out = getattr(txf, fn)(tm, torch.tensor(q))
    ref = recorded[fn]
    assert len(out) == len(ref) == tm.nb
    for o, r in zip(out, ref):
        close(o, r)
    per_joint = txf.q_per_joint(tm, torch.tensor(q))
    assert per_joint[0] is None
    for i in range(1, tm.nb):
        close(per_joint[i], recorded["q_per_joint"][..., i])


def test_step_kernel_plain_and_cpu_route(tm, inputs, refs):
    """K1's plain version is ABA + semi-implicit Euler (flat on the root's
    six coordinates); its wrapper takes it for CPU tensors."""
    q, qd, u, fe = (torch.tensor(a) for a in inputs)
    x = torch.cat([q, qd], -1)
    qd1 = qd + 0.01 * torch.tensor(refs["aba_fext"])
    ref = torch.cat([q + 0.01 * qd1, qd1], -1)
    torch.testing.assert_close(fused.fd_step_plain(tm, x, u, 0.01, f_ext=fe),
                               ref, rtol=0, atol=1e-12)
    torch.testing.assert_close(fd_step_fused(tm, x, u, 0.01, f_ext=fe), ref,
                               rtol=0, atol=1e-12)


def test_aba_inverts_rnea(tm, inputs):
    """Cross-consistency inside the port on the floating tree."""
    q, qd, qdd, _ = (torch.tensor(a) for a in inputs)
    tau = tdyn.rnea(tm, q, qd, qdd)[0]
    torch.testing.assert_close(tdyn.aba(tm, q, qd, tau), qdd, rtol=0,
                               atol=1e-9)


def test_non_pd_block_gives_nan():
    """The unrolled Cholesky of the root's block: NaN for a block that is
    not positive definite, never an error (rbdtpu's cholesky_small)."""
    A = torch.eye(6, dtype=torch.float64).repeat(2, 1, 1)
    A[1, 4, 4] = -1.0
    L = tops.cholesky_small(A)
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).any()
    torch.testing.assert_close(L[0], torch.eye(6, dtype=torch.float64))
    x = tops.cholesky_solve_small(L, torch.ones(2, 6, dtype=torch.float64))
    torch.testing.assert_close(x[0], torch.ones(6, dtype=torch.float64))
    assert torch.isnan(x[1]).any()


@pytest.mark.slow
def test_recording_is_rbdtpus(recorded):
    live = reference()
    assert sorted(live) == sorted(recorded)
    for key, val in live.items():
        np.testing.assert_allclose(recorded[key], val, rtol=1e-12,
                                   atol=1e-12)
