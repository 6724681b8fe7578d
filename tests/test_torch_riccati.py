"""The port's Riccati sweeps against rbdtpu's chunked Pallas sweep
(kernels/riccati_chunk.py backward_pass_chunked, run in interpret mode as
its own tests run it on the CPU), and the DDP solver's backward-pass
routing.  Float64 on the CPU; 1e-9 relative to each output's scale.

rbdtpu's kernel has two call sites, both held: the small-batch variant
(batch < 128, here 8 problems with constant cost blocks) and the lane-tiled
one (130 problems with per-knot cost blocks, one of them with a Quu that is
not positive definite)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbdtpu.kernels.riccati_chunk import backward_pass_chunked as jchunked
from rbdtpu_torch.kernels import (
    backward_pass_chunked, launches, reset_launches,
)
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import ddp as tddp, quadratic_tracking_cost
from riccati_problems import riccati_problem

TOL = 1e-9
NX, NV, H = 10, 4, 4


@pytest.fixture(scope="module", params=[(8, True, None), (130, False, (5, 2))],
                ids=["small-constant", "lane-per-knot-non-pd"])
def case(request):
    """(problem, rbdtpu's k, K, dV1, ok) for one call site."""
    Bm, const, non_pd = request.param
    args = riccati_problem(np.random.default_rng(Bm), NX, NV, H, Bm, const,
                           non_pd)
    ref = jchunked(*(jnp.asarray(a) for a in args), interpret=True)
    return args, tuple(np.asarray(r) for r in ref)


def _matches(out, ref):
    k, K, dV, ok = (o.numpy() for o in out)
    kr, Kr, dVr, okr = ref
    assert ok.tolist() == okr.tolist()
    for a, b in ((k, kr), (K, Kr), (dV, dVr)):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                   atol=TOL * max(1.0, np.abs(b[fin]).max()))


def test_plain_sweep_matches_rbdtpu_chunked(case):
    args, ref = case
    _matches(tddp.backward_pass(*(torch.tensor(a) for a in args)), ref)
    if args[5].ndim == 4:  # the non-PD problem: NaN gains, ok False
        assert not ref[3][5] and np.isnan(ref[0][5, :3]).all()
        assert ref[3].sum() == len(ref[3]) - 1


def test_chunked_cpu_route_matches_rbdtpu_chunked(case):
    """On CPU tensors the kernel's wrapper runs the plain sweep and
    launches nothing."""
    args, ref = case
    reset_launches()
    _matches(backward_pass_chunked(*(torch.tensor(a) for a in args)), ref)
    assert launches["riccati_chunk"] == launches["riccati_small"] == 0


@pytest.mark.parametrize("name,option,on_card,route", [
    ("arm7", {}, True, "plain"),  # nx = 14: configs[2] keeps the plain sweep
    ("arm7", {"fused_riccati": True}, True, "fused"),  # K11 at nx <= 16
    ("arm7", {"fused_riccati": True}, False, "fused"),
    ("arm7", {"parallel_riccati": True, "fused_riccati": True}, True,
     "parallel"),
    ("quadruped12", {}, True, "chunked"),  # nx = 36 >= 24 on the card
    ("quadruped12", {}, False, "plain"),
    ("quadruped12", {"fused_riccati": True}, False, "chunked"),
    ("quadruped12", {"fused_riccati": False}, True, "plain"),
    ("quadruped12", {"parallel_riccati": True}, True, "parallel"),
])
def test_backward_pass_routing(name, option, on_card, route):
    """rbdtpu's routing (solver/ddp.py:475-586) with "on the TPU" read as
    "the tensors are on the card"; parallel_riccati=None stays off (its
    auto gate is TPU-only)."""
    m = load_asset(name, device="cpu", dtype=torch.float64,
                   floating_base=name != "arm7")
    cfg = tddp.DDPConfig(**option)
    assert tddp._backward_route(m, cfg, on_card) == route


def test_chunked_route_on_cpu_gives_the_plain_sweep():
    """A short solve at nx = 24 (quadruped12 on a fixed base): the chunked
    route (its wrapper's plain version on the CPU) and the plain sweep give
    the same controls."""
    m = load_asset("quadruped12", device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(5)
    x0 = torch.tensor(np.concatenate(
        [0.05 * rng.standard_normal((2, m.nq)), np.zeros((2, m.nv))], -1))
    U0 = torch.tensor(rng.standard_normal((2, 3, m.nv)))
    goal = np.zeros(m.nx)
    cost = quadratic_tracking_cost(m, goal, w_q=2.0, w_qd=0.05, w_u=1e-5)
    out = [tddp.ddp_solve(m, cost, x0, U0, tddp.DDPConfig(
        iters=1, n_alphas=3, fused=True, fused_riccati=fr))[0].U
        for fr in (True, False)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
