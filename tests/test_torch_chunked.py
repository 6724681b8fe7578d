"""The port's chunked-gain line search (K9's plain route,
``kernels.feedback_rollout_fused_chunked``, through
``solver.ddp.forward_pass_fused(nchunks=c)``) and its routing against
rbdtpu, float64 on the CPU.

- rbdtpu's K9 in Pallas interpret mode, through its own forward_pass_fused,
  recorded by tests/make_chunked_fixture.py in tests/data/chunked_refs.npz
  (nchunks 1, 2, 3, 99, with and without a clamp, arm7 with rbdtpu's pad
  and the rpy quadruped), and one case run live: X and U to 1e-9, J to 1e-9
  relative;
- the port's copy of rbdtpu's budget arithmetic (lane budget, chunk count,
  the budget halves of feedback_fused_ok and feedback_chunked_ok) against
  rbdtpu's functions over arm7, quadruped12 and humanoid30 and a grid of
  batch x alphas (pure integers: nothing compiles);
- which line search ``ddp_solve`` takes for each ``fused_feedback``, without
  a card, as test_torch_ddp.py's test_backward_route_on_cpu does.
The ``slow`` test re-runs every recorded case live (about three minutes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_chunked_fixture import (
    ALPHAS, CHUNKS, CLIP, DT, MODELS, PATH, case_key, models, solve_case,
)
from rbdtpu.kernels import fused as jf
from rbdtpu.model import load_asset as j_load_asset
from rbdtpu_torch import solver as ts
from rbdtpu_torch.kernels import fused as tf
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import ddp

TOL = 1e-9


@pytest.fixture(scope="module")
def tms():
    return {"arm7": load_asset("arm7", device="cpu", dtype=torch.float64),
            "quadruped12": load_asset("quadruped12", device="cpu",
                                      dtype=torch.float64,
                                      floating_base=True)}


@pytest.fixture(scope="module")
def recorded():
    with np.load(PATH) as f:
        return dict(f)


def port_pass(m, rec, name, nchunks, clip):
    """The port's forward_pass_fused on a recorded case's inputs."""
    g = lambda k: torch.tensor(rec[f"{name}/{k}"])
    cost = ts.quadratic_tracking_cost(m, g("goal"))
    u_clip = torch.full((m.nv,), CLIP, dtype=torch.float64) if clip else None
    return ddp.forward_pass_fused(
        m, cost, g("X"), g("U"), g("k"), g("K"),
        torch.tensor(ALPHAS, dtype=torch.float64), DT, -9.81, u_clip=u_clip,
        nchunks=nchunks)


def _hold(out, ref):
    X, U, J = out
    Xr, Ur, Jr = ref
    assert np.abs(X.numpy() - Xr).max() <= TOL * max(1.0, np.abs(Xr).max())
    assert np.abs(U.numpy() - Ur).max() <= TOL * max(1.0, np.abs(Ur).max())
    np.testing.assert_allclose(J.numpy(), Jr, rtol=TOL)


@pytest.mark.parametrize("clip", [False, True], ids=["free", "clip"])
@pytest.mark.parametrize("nchunks", CHUNKS)
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_pass_chunked_matches_recorded_rbdtpu(tms, recorded, name,
                                                      nchunks, clip):
    key = case_key(name, nchunks, clip)
    _hold(port_pass(tms[name], recorded, name, nchunks, clip),
          tuple(recorded[f"{key}/{k}"] for k in ("X", "U", "J")))


@pytest.mark.parametrize("nchunks", [2, 99])
def test_wrapper_matches_recorded_rbdtpu(tms, recorded, nchunks):
    """feedback_rollout_fused_chunked itself, on the flattened alpha x
    problem batch (alpha folded into k), against the recorded states and
    controls; and the chunk order sums as K2's plain version does to
    rounding."""
    name, m = "quadruped12", tms["quadruped12"]
    g = lambda k: torch.tensor(recorded[f"{name}/{k}"])
    X, U, k, K = g("X"), g("U"), g("k"), g("K")
    al = torch.tensor(ALPHAS, dtype=torch.float64)
    rep = lambda a: a[None].expand((len(ALPHAS),) + a.shape).reshape(
        (-1,) + a.shape[1:])
    kf = (al[:, None, None, None] * k[None]).reshape((-1,) + k.shape[1:])
    args = (m, rep(X)[:, 0], rep(X)[:, :-1], rep(U), kf, rep(K), DT)
    Xo, Uo = tf.feedback_rollout_fused_chunked(*args, nchunks=nchunks)
    ref = f"{case_key(name, nchunks, False)}/"
    Xr = recorded[ref + "X"].reshape((-1,) + X.shape[1:])[:, 1:]
    Ur = recorded[ref + "U"].reshape((-1,) + U.shape[1:])
    assert np.abs(Xo.numpy() - Xr).max() <= TOL * np.abs(Xr).max()
    assert np.abs(Uo.numpy() - Ur).max() <= TOL * np.abs(Ur).max()
    X2, U2 = tf.feedback_rollout_plain(*args)
    torch.testing.assert_close(Xo, X2, rtol=0, atol=1e-12)
    torch.testing.assert_close(Uo, U2, rtol=0, atol=1e-12)


def test_one_case_live(tms, recorded):
    """One case through rbdtpu's interpret-mode K9 now (6.5-7 s)."""
    name, c, clip = "arm7", 2, True
    arrays = {k: recorded[f"{name}/{k}"] for k in ("X", "U", "k", "K", "goal")}
    live = solve_case(models()[name], arrays, c, clip)
    _hold(port_pass(tms[name], recorded, name, c, clip), live)


def test_chunk_geometry():
    """rbdtpu's split: width ceil(ndx / n), count renormalised so every
    chunk is nonempty; any count >= 1 is taken."""
    assert tf.chunk_geometry(72, 2) == (36, 2)
    assert tf.chunk_geometry(72, 5) == (15, 5)
    assert tf.chunk_geometry(14, 99) == (1, 14)
    assert tf.chunk_geometry(36, 8) == (5, 8)
    assert tf.chunk_geometry(36, 7) == (6, 6)
    with pytest.raises(ValueError):
        tf.chunk_geometry(14, 0)


BATCHES = sorted(set(range(1, 73)) | {
    128, 256, 512, 520, 536, 544, 552, 560, 568, 576, 1000, 1024, 2048,
    4096, 4104, 4112, 5000, 8192, 9000, 16384})


@pytest.mark.parametrize("name,fb", [("arm7", False), ("quadruped12", True),
                                     ("humanoid30", True)])
def test_budget_arithmetic_matches_rbdtpu(name, fb):
    tm = load_asset(name, device="cpu", floating_base=fb)
    jm = j_load_asset(name, dtype=np.float64, floating_base=fb)
    nv = tm.nv
    assert tf.feedback_lane_budget(tm.nx, nv, 2 * nv) == \
        jf.feedback_lane_budget(jm.nq + jm.nv, nv, 2 * nv)
    for bt in BATCHES:
        assert tf._pad_batch(bt) == jf._pad_batch(bt)
        assert tf.feedback_chunks(tm, bt) == jf.feedback_chunks(jm, bt), bt
        # off a TPU rbdtpu's compile probes pass, so its functions are
        # their budget halves here
        assert tf.feedback_fused_ok(tm, bt) == jf.feedback_fused_ok(
            jm, bt, jnp.float64), bt
        assert tf.feedback_chunks(tm, bt) == jf.feedback_chunked_ok(
            jm, bt, jnp.float64), bt


@pytest.mark.parametrize("name,fb", [("arm7", False), ("quadruped12", True),
                                     ("humanoid30", True)])
def test_feedback_route_is_rbdtpus_rule(name, fb):
    """ddp_solve's line-search tier: False the plain pass; True rbdtpu's
    tiers (solver/ddp.py:506-528: K2 where its budget admits the batch,
    else K9 with its chunk count, else the plain pass); None K2 at any
    batch (the port has no TPU lane floor)."""
    tm = load_asset(name, device="cpu", floating_base=fb)
    jm = j_load_asset(name, dtype=np.float64, floating_base=fb)
    route = lambda ff, bt: ddp._feedback_route(
        tm, ts.DDPConfig(fused=True, fused_feedback=ff), bt)
    for bt in BATCHES:
        if jf.feedback_fused_ok(jm, bt, jnp.float64):
            want = ("fused", None)
        else:
            c = jf.feedback_chunked_ok(jm, bt, jnp.float64)
            want = ("plain", None) if c is None else ("chunked", c)
        assert route(True, bt) == want, bt
        assert route(None, bt) == ("fused", None)
        assert route(False, bt) == ("plain", None)
        assert ddp._feedback_route(tm, ts.DDPConfig(fused=False), bt) == (
            "plain", None)
    if name == "humanoid30":
        assert route(True, 544) == ("chunked", 1)
        assert route(True, 540) == ("plain", None)  # not a multiple of 8
        assert route(True, 568) == ("chunked", 2)
        assert route(True, 1024) == ("chunked", 2)


@pytest.mark.parametrize("ff,refuse_k2,bm,want", [
    (None, False, 2, ["K2"]), (True, False, 2, ["K2"]),
    (True, True, 2, ["K9:1"]), (True, False, 3, ["plain"]),
    (False, False, 2, ["plain"])])
def test_ddp_solve_takes_the_route(monkeypatch, ff, refuse_k2, bm, want):
    """The calls of each iteration on CPU tensors (arm7, 4 step sizes):
    with ``refuse_k2`` rbdtpu's budget is made to refuse K2, which sends
    fused_feedback=True to K9 with arm7's chunk count (1); 3 problems x 4
    alphas is not a multiple of 8, so True takes the plain pass."""
    calls = []
    k2, k9, plain = (ddp.feedback_rollout_fused,
                     ddp.feedback_rollout_fused_chunked, ddp.forward_pass)
    monkeypatch.setattr(ddp, "feedback_rollout_fused", lambda *a, **kw: (
        calls.append("K2"), k2(*a, **kw))[1])
    monkeypatch.setattr(ddp, "feedback_rollout_fused_chunked",
                        lambda *a, **kw: (calls.append(
                            f"K9:{kw['nchunks']}"), k9(*a, **kw))[1])
    monkeypatch.setattr(ddp, "forward_pass", lambda *a, **kw: (
        calls.append("plain"), plain(*a, **kw))[1])
    if refuse_k2:
        monkeypatch.setattr(ddp, "feedback_fused_ok", lambda *a: False)
    tm = load_asset("arm7", device="cpu", dtype=torch.float64)
    x0 = torch.zeros(bm, tm.nx, dtype=torch.float64)
    U0 = torch.zeros(bm, 3, tm.nv, dtype=torch.float64)
    cost = ts.quadratic_tracking_cost(tm, torch.full((tm.nx,), 0.1,
                                                     dtype=torch.float64))
    state, _ = ts.ddp_solve(tm, cost, x0, U0, ts.DDPConfig(
        iters=2, n_alphas=4, fused=True, fused_feedback=ff))
    assert calls == want * 2
    assert torch.isfinite(state.U).all()


@pytest.mark.slow
@pytest.mark.parametrize("name", list(MODELS))
def test_recording_is_rbdtpus_k9(recorded, name):
    m = models()[name]
    arrays = {k: recorded[f"{name}/{k}"] for k in ("X", "U", "k", "K", "goal")}
    for c in CHUNKS:
        for clip in (False, True):
            key = case_key(name, c, clip)
            for ref, live in zip((recorded[f"{key}/{k}"] for k in "XUJ"),
                                 solve_case(m, arrays, c, clip)):
                np.testing.assert_allclose(ref, live, rtol=1e-12, atol=1e-12)
