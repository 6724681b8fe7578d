"""rbdtpu_torch dynamics and kinematics against rbdtpu, float64 on the CPU,
on the same numpy inputs; tolerance 1e-9 (the repository's dynamics parity
tolerance, tests/test_parity.py)."""
import numpy as np
import pytest
import torch

from rbdtpu import dynamics as jdyn
from rbdtpu.kinematics import fk as jfk
from rbdtpu.model import load_asset as jax_load_asset
from rbdtpu.model import parse_urdf as jax_parse_urdf
from rbdtpu_torch import dynamics as tdyn
from rbdtpu_torch import kinematics as tkin
from rbdtpu_torch.model import load_asset, parse_urdf
from test_torch_cuda import mixed_tree_urdf

TOL = 1e-9
B = 4

# each case: (reference on rbdtpu's model, port on the port's model); both
# take the numpy inputs (q, qd, tau) and return a tuple of arrays
CASES = {
    "aba": (lambda m, q, qd, u: (jdyn.aba(m, q, qd, u),),
            lambda m, q, qd, u: (tdyn.aba(m, q, qd, u),)),
    "rnea": (lambda m, q, qd, u: jdyn.rnea(m, q, qd, u),
             lambda m, q, qd, u: tdyn.rnea(m, q, qd, u)),
    "rnea_bias": (lambda m, q, qd, u: jdyn.rnea(m, q, qd),
                  lambda m, q, qd, u: tdyn.rnea(m, q, qd)),
    "minv": (lambda m, q, qd, u: (jdyn.minv(m, q),),
             lambda m, q, qd, u: (tdyn.minv(m, q),)),
    "rnea_grad": (lambda m, q, qd, u: jdyn.rnea_grad(m, q, qd, u, split=True),
                  lambda m, q, qd, u: tdyn.rnea_grad(m, q, qd, u, split=True)),
    "forward_dynamics_full": (
        lambda m, q, qd, u: jdyn.forward_dynamics_full(m, q, qd, u),
        lambda m, q, qd, u: tdyn.forward_dynamics_full(m, q, qd, u)),
    "ee_pose": (lambda m, q, qd, u: (jfk.ee_pose(m, q),),
                lambda m, q, qd, u: (tkin.ee_pose(m, q),)),
    "ee_position_jacobian_tangent": (
        lambda m, q, qd, u: (jfk.ee_position_jacobian_tangent(m, q),),
        lambda m, q, qd, u: (tkin.ee_position_jacobian_tangent(m, q),)),
}


@pytest.fixture(scope="module", params=["arm7", "mixed"])
def models(request):
    """(rbdtpu model, port model) of a fixed-base tree: the arm7 chain, and
    a small branched tree with prismatic joints (the card tests' second
    model)."""
    if request.param == "mixed":
        urdf = mixed_tree_urdf()
        return (jax_parse_urdf(urdf, dtype=np.float64),
                parse_urdf(urdf, dtype=torch.float64))
    return (jax_load_asset(request.param, dtype=np.float64),
            load_asset(request.param, dtype=torch.float64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_rbdtpu(models, case, rng):
    jm, tm = models
    q, qd, u = (rng.uniform(-1.0, 1.0, (B, tm.nv)) for _ in range(3))
    ref_fn, port_fn = CASES[case]
    ref = ref_fn(jm, q, qd, u)
    out = port_fn(tm, *(torch.tensor(a) for a in (q, qd, u)))
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("op", ["crm", "crf"])
def test_cross_operators_match_rbdtpu(op, rng):
    """The 6x6 cross-product matrices equal rbdtpu's and act as the
    vector forms the sweeps use."""
    from rbdtpu.spatial import ops as jops
    from rbdtpu_torch.spatial import ops as tops

    v, w = rng.standard_normal((2, B, 6))
    M = getattr(tops, op)(torch.tensor(v))
    np.testing.assert_array_equal(M.numpy(), np.asarray(getattr(jops, op)(v)))
    vec = tops.cross_motion if op == "crm" else tops.cross_force
    torch.testing.assert_close((M @ torch.tensor(w)[..., None])[..., 0],
                               vec(torch.tensor(v), torch.tensor(w)))


def test_aba_inverts_rnea(rng):
    """Cross-consistency inside the port: aba(q, qd, rnea(q, qd, qdd)) = qdd."""
    m = load_asset("arm7", dtype=torch.float64)
    q, qd, qdd = (torch.tensor(rng.uniform(-1, 1, (B, m.nv))) for _ in range(3))
    tau = tdyn.rnea(m, q, qd, qdd)[0]
    torch.testing.assert_close(tdyn.aba(m, q, qd, tau), qdd, rtol=0,
                               atol=1e-9)
