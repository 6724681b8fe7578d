"""The port's oracle layer (``rbdtpu_torch.oracle``) and run utilities
(``rbdtpu_torch.utils``), in float64 on the CPU.

- ``OracleRobotAdapter``: every URDFParser-style ``get_*`` method equal to
  rbdtpu's adapter on the same model data, exactly (both serve the same
  float64 numbers through numpy), on arm7 and the rpy quadruped;
- ``NumpyDDP`` driven by the port's ``RBDReferenceTorch`` against the
  port's ``ddp_solve(rollout_route="minv")`` on arm7 at H = 10: controls
  within 1e-6, J within 1e-9 relative (rbdtpu's control-parity bounds);
- ``SolveMetrics`` against rbdtpu's on the same J and dJ arrays; the
  timers and the trace on the CPU.

rbdtpu's adapter and metrics are numpy and a few eager jnp reductions: no
JAX compile of a solver."""
import json
import os

import numpy as np
import pytest
import torch

from rbdtpu.model import load_asset as load_asset_jax
from rbdtpu.oracle import OracleRobotAdapter as AdapterJax
from rbdtpu_torch.compat import RBDReferenceTorch
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.oracle import (
    NumpyDDP, OracleRobotAdapter, QuadTrackingCostNp, load_reference_class,
)
from rbdtpu_torch.solver import DDPConfig, ddp_solve, quadratic_tracking_cost
from rbdtpu_torch.utils import SolveMetrics, Timer, benchmark, profile_trace

MODELS = {"arm7": ("arm7", {}),
          "quad": ("quadruped12", {"floating_base": True})}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One state a call: one thread is as fast and leaves the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def adapters():
    out = {}
    for tag, (name, kw) in MODELS.items():
        out[tag] = (OracleRobotAdapter(load_asset(
            name, device="cpu", dtype=torch.float64, **kw)),
            AdapterJax(load_asset_jax(name, dtype=np.float64, **kw)))
    return out


def _q_of(a, i, rng):
    """A joint coordinate of body i (six on a floating root)."""
    return rng.uniform(-1, 1, 6) if a.floating_base and i == 0 else float(
        rng.uniform(-1, 1))


def _same(x, y):
    if isinstance(x, dict):
        assert x.keys() == y.keys()
        for k in x:
            _same(x[k], y[k])
        return
    if isinstance(x, (list, tuple)):
        assert len(x) == len(y)
        for a, b in zip(x, y):
            _same(a, b)
        return
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _per_body(a, b, fn):
    for i in range(a.get_num_bodies()):
        _same(fn(a, i), fn(b, i))


def _funcs(getter, skip_root):
    """Evaluate each body's transform closure at the same coordinate."""
    def call(ad, i):
        rng = np.random.default_rng(100 + i)
        if skip_root and ad.floating_base and i == 0:
            return 0
        return getattr(ad, getter)(i)(_q_of(ad, i, rng))
    return call


def _fixed(ad, name):
    fj = ad.get_fixed_joint_by_name(name)
    return (fj.get_id(), fj.parent_name, fj.get_transformation_matrix_hom(),
            ad.get_fixed_joint_by_id(fj.get_id()).get_id())


GETTERS = {
    "sizes": lambda a, b: _same(
        [a.get_num_bodies(), a.get_num_joints(), a.get_num_vel(),
         a.floating_base],
        [b.get_num_bodies(), b.get_num_joints(), b.get_num_vel(),
         b.floating_base]),
    "topology": lambda a, b: (
        _per_body(a, b, lambda ad, i: (
            ad.get_parent_id(i), ad.get_subtree_by_id(i),
            ad.get_ancestors_by_id(i))),
        _same(a.get_leaf_nodes(), b.get_leaf_nodes())),
    "index_maps": lambda a, b: _per_body(a, b, lambda ad, i: (
        ad.get_joint_index_q(i), ad.get_joint_index_v(i),
        ad.get_joint_index_f(i))),
    "inertia": lambda a, b: (
        _per_body(a, b, lambda ad, i: (
            ad.get_S_by_id(i), ad.get_Imat_by_id(i),
            ad.get_damping_by_id(i))),
        _same(a.get_Imats_dict_by_id(), b.get_Imats_dict_by_id())),
    "Xmat": lambda a, b: _per_body(a, b, _funcs("get_Xmat_Func_by_id",
                                                False)),
    "Xmat_hom": lambda a, b: _per_body(a, b, _funcs(
        "get_Xmat_hom_Func_by_id", False)),
    "dXmat_hom": lambda a, b: _per_body(a, b, _funcs(
        "get_dXmat_hom_Func_by_id", True)),
    "d2Xmat_hom": lambda a, b: _per_body(a, b, _funcs(
        "get_d2Xmat_hom_Func_by_id", True)),
    "named": lambda a, b: (
        _same([a.get_joint_by_name(n).get_id()
               for n in a.model.joint_names],
              [b.get_joint_by_name(n).get_id()
               for n in b.model.joint_names]),
        _same(a.get_joint_by_name("no such joint"),
              b.get_joint_by_name("no such joint")),
        [_same(_fixed(a, n), _fixed(b, n))
         for n in a.model.fixed_frame_names]),
}


@pytest.mark.parametrize("tag", list(MODELS))
@pytest.mark.parametrize("getter", list(GETTERS))
def test_adapter_equals_rbdtpus(adapters, tag, getter):
    ours, theirs = adapters[tag]
    GETTERS[getter](ours, theirs)


def test_numpy_ddp_through_the_mirror_matches_ddp_solve():
    """The serial numpy DDP stepping through ``RBDReferenceTorch`` (Minv +
    RNEA forward dynamics, ``rnea_grad``) against the batched solver on
    the same route: arm7, tracking toward q = 0.2, H = 10, 3 iterations."""
    m = load_asset("arm7", device="cpu", dtype=torch.float64)
    H, iters, alphas, dt = 10, 3, 4, 0.01
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-0.3, 0.3, m.nx)
    goal = np.concatenate([np.full(m.nq, 0.2), np.zeros(m.nv)])
    U0 = 0.1 * rng.standard_normal((H, m.nv))
    oracle = NumpyDDP(RBDReferenceTorch(m), m.nq, m.nv, dt=dt, iters=iters,
                      n_alphas=alphas)
    _, U_np, J_np = oracle.solve(QuadTrackingCostNp(m.nq, m.nv, goal), x0,
                                 U0)
    cfg = DDPConfig(iters=iters, dt=dt, n_alphas=alphas,
                    rollout_route="minv", parallel_riccati=False)
    state, _ = ddp_solve(m, quadratic_tracking_cost(m, torch.tensor(goal)),
                         torch.tensor(x0), torch.tensor(U0), cfg)
    assert np.abs(state.U.numpy() - U_np).max() < 1e-6
    assert abs(state.J.item() - J_np) / max(1.0, abs(J_np)) < 1e-9
    assert J_np < oracle.traj_cost(QuadTrackingCostNp(m.nq, m.nv, goal),
                                   oracle.rollout(x0, U0), U0)


def test_solve_metrics_match_rbdtpus():
    """``SolveMetrics.from_states`` and ``json()`` field for field against
    rbdtpu's on the same J and dJ."""
    import jax.numpy as jnp

    from rbdtpu.utils import SolveMetrics as MetricsJax

    class States:
        def __init__(self, J, dJ):
            self.J, self.dJ = J, dJ

    rng = np.random.default_rng(4)
    J = rng.uniform(0, 10, 37)
    dJ = rng.standard_normal(37)
    dJ[::5] = 0.0
    ours = SolveMetrics.from_states(
        States(torch.tensor(J), torch.tensor(dJ)), 0.25).json()
    theirs = MetricsJax.from_states(
        States(jnp.asarray(J), jnp.asarray(dJ)), 0.25).json()
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-12, err_msg=k)
    json.dumps(ours)


def test_timers_and_trace_on_the_cpu(tmp_path):
    """The timers run (nothing to wait for on the CPU) and the trace
    writes a chrome trace of the host's operators."""
    x = torch.ones(64, 64)
    with Timer() as t:
        (x @ x).sum()
    assert t.elapsed >= 0
    assert 0 <= benchmark(lambda a: a @ a, x, reps=2, batches=2) < 10
    with profile_trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_no_reference_without_its_path():
    """The numpy reference is loaded only from RBD_REFERENCE_PATH."""
    from rbdtpu_torch import oracle

    if oracle.REFERENCE_PATH is None:
        assert load_reference_class() is None
