"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and the CUDA toolkit; skipped without a card.  The file
imports neither JAX nor rbdtpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from rbdtpu_torch.kernels import (
    _lib, backward_pass_chunked, backward_pass_fused, colvec, ee_gn_fused,
    fd_step_fused,
    fd_step_minv_fused, feedback_rollout_fused,
    feedback_rollout_fused_chunked, fk_lane, fused,
    linearize_parts_fused, rnea_fused, rollout_fused_multi,
)
from rbdtpu_torch.model import load_asset, parse_urdf
from riccati_problems import riccati_problem

pytestmark = pytest.mark.cuda

DT = 0.01
TARGET = (0.3, 0.2, 0.8)


def mixed_tree_urdf() -> str:
    """A small branched tree of revolute and prismatic joints with dense
    inertias and tilted joint frames: bodies 0 -> 1 -> {2, 3 -> 4}, joints
    1 and 3 prismatic.  The bundled robots have revolute joints only."""
    jtypes = ["revolute", "prismatic", "revolute", "prismatic", "revolute"]
    parent_links = [0, 1, 2, 2, 4]
    axes = ["0 1 0", "1 0 0", "0 0 1", "1 0 0", "0 1 0"]
    links = "".join(
        f'<link name="l{i}"><inertial><origin xyz="0.05 0.02 0.1"/>'
        f'<mass value="{1.0 + 0.2 * i}"/><inertia ixx="0.02" iyy="0.03" '
        f'izz="0.015" ixy="0.002" ixz="0.001" iyz="0.003"/></inertial></link>'
        for i in range(len(jtypes) + 1))
    joints = "".join(
        f'<joint name="j{i}" type="{jt}">'
        f'<origin xyz="0.1 0.05 0.2" rpy="0.1 {0.1 * i} 0"/>'
        f'<parent link="l{p}"/><child link="l{i + 1}"/>'
        f'<axis xyz="{axes[i]}"/></joint>'
        for i, (jt, p) in enumerate(zip(jtypes, parent_links)))
    return f'<robot name="mixed">{links}{joints}</robot>'


# model name -> (builder, end effector for ee_gn: arm7's single leaf, or
# the mixed tree's leaf behind both prismatic joints)
MODELS = {
    "arm7": (lambda **kw: load_asset("arm7", **kw), None),
    "mixed": (lambda **kw: parse_urdf(mixed_tree_urdf(), **kw), ("j4",)),
}
# the kernels that also take the rpy floating root (K1-K3, K6, K9, K10) run
# on these too
FLOATING = {
    "quad_rpy": (lambda **kw: load_asset("quadruped12", floating_base=True,
                                         **kw), None),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=[
    (name, dt) for name in MODELS for dt in (torch.float64, torch.float32)],
    ids=lambda p: f"{p[0]}-{str(p[1])[6:]}")
def case(card, request):
    """(model, end effector, tolerance): 1e-9 absolute in float64; float32
    sums are reordered between kernel and plain version, so 1e-4 relative
    to the output's scale."""
    return _case(MODELS, *request.param)


@pytest.fixture(scope="module", params=[
    (name, dt) for name in (*MODELS, *FLOATING)
    for dt in (torch.float64, torch.float32)],
    ids=lambda p: f"{p[0]}-{str(p[1])[6:]}")
def tree_case(card, request):
    """``case`` over the fixed-base trees and the rpy floating root."""
    return _case({**MODELS, **FLOATING}, *request.param)


def _case(models, name, dt):
    build, ee = models[name]
    return (build(device="cuda", dtype=dt), ee,
            1e-9 if dt == torch.float64 else 1e-4)


def _inputs(m, *shapes, scale=0.5):
    rng = np.random.default_rng(7)
    return [torch.tensor(scale * rng.standard_normal(s), dtype=m.dtype,
                         device=m.device) for s in shapes]


def _close(a, b, tol):
    torch.testing.assert_close(a, b, rtol=0,
                               atol=tol * max(1.0, b.abs().max().item()))


def _launched(name, fn):
    before = _lib.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert _lib.launches[name] == before + 1
    return out


# batches around the team kernels' team and block sizes (one team a block
# for a small batch, whole warps of teams, a ragged last block)
TEAM_BATCHES = (1, 37, 1000)


@pytest.mark.parametrize("B", TEAM_BATCHES)
def test_fd_step(tree_case, B):
    m, _, tol = tree_case
    x, u = _inputs(m, (B, m.nx), (B, m.nv))
    out = _launched("fd_step", lambda: fd_step_fused(m, x, u, DT))
    _close(out, fused.fd_step_plain(m, x, u, DT), tol)


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_fd_step_fext(tree_case, batched):
    """World-frame wrenches, (nb, 6) shared by the batch or (B, nb, 6)."""
    m, _, tol = tree_case
    B = 37
    x, u, fe = _inputs(m, (B, m.nx), (B, m.nv),
                       ((B,) if batched else ()) + (m.nb, 6))
    fe = 20.0 * fe
    out = _launched("fd_step", lambda: fd_step_fused(m, x, u, DT, f_ext=fe))
    _close(out, fused.fd_step_plain(m, x, u, DT, f_ext=fe), tol)


# K6's and K10's batches: one state (one team a block), an odd batch, and
# one past the rollout path's 4096 (a ragged last block)
MINV_BATCHES = (1, 37, 4097)


@pytest.mark.parametrize("B", MINV_BATCHES)
@pytest.mark.parametrize("with_qdd", [True, False], ids=["qdd", "bias"])
def test_rnea(tree_case, with_qdd, B):
    """K10 against its plain version on the fixed-base trees and the rpy
    quadruped, with and without qdd."""
    m, _, tol = tree_case
    q, qd, qdd = _inputs(m, (B, m.nq), (B, m.nv), (B, m.nv), scale=1.0)
    a = qdd if with_qdd else None
    out = _launched("rnea", lambda: rnea_fused(m, q, qd, a))
    _close(out, fused.rnea_plain(m, q, qd, a), tol)


@pytest.mark.parametrize("B", MINV_BATCHES)
@pytest.mark.parametrize("wrench", ["free", "shared", "batched"])
@pytest.mark.parametrize("dense", [False, True], ids=["fact", "dense"])
def test_fd_step_minv(tree_case, dense, wrench, B):
    """K6 against its plain version on both routes, the fixed-base trees
    and the rpy quadruped, without wrenches and under wrenches 10 N(0,1),
    one set shared by the batch or one an element."""
    m, _, tol = tree_case
    x, u, fe = _inputs(m, (B, m.nx), (B, m.nv),
                       ((B,) if wrench == "batched" else ()) + (m.nb, 6))
    fe = None if wrench == "free" else 20.0 * fe
    out = _launched("fd_step_minv", lambda: fd_step_minv_fused(
        m, x, u, DT, dense_minv=dense, f_ext=fe))
    _close(out, fused.fd_step_minv_plain(m, x, u, DT, f_ext=fe), tol)


@pytest.mark.parametrize("H", [1, 8, 50])
@pytest.mark.parametrize("B", [1, 37, 4096, 4097])
@pytest.mark.parametrize("wrench", [False, True], ids=["free", "fext"])
@pytest.mark.parametrize("route", ["aba", "minv"])
def test_rollout_multi_is_one_launch(case, route, wrench, B, H):
    """The whole horizon is one launch of rollout_multi and none of the
    step kernels, for one trajectory, an odd batch, the rollout path's 4096
    and one more (a ragged last block), over one step, eight and the path's
    50, from x0 = 0.5 N(0,1) under wrenches 10 N(0,1).  Over 50 steps the
    wrenches are the rollout path's 0.5 N(0,1) (chip_smoke.rollout_inputs):
    under 10 N(0,1) the plain route itself ends in NaN.  At 4096 and 4097
    trajectories over 50 steps x0 is the rollout path's 0.1 N(0,1) too:
    from 0.5 N(0,1) some of 4096 open-loop arms diverge to |x| ~ 1e24,
    where the kernel and the plain route part by more than any
    tolerance."""
    m, _, tol = case
    x0, U, F = _inputs(m, (B, m.nx), (H, B, m.nv), (H, m.nb, 6))
    if H < 50:
        F = 20.0 * F
    elif B >= 4096:
        x0 = 0.2 * x0
    F = F if wrench else None
    before = dict(_lib.launches)
    out = rollout_fused_multi(m, x0, U, DT, route=route, f_ext=F)
    torch.cuda.synchronize()
    assert _lib.launches["rollout_multi"] == before["rollout_multi"] + 1
    for k in ("fd_step", "fd_step_minv"):
        assert _lib.launches[k] == before[k]
    want = fused.rollout_multi_plain(m, x0, U, DT, route=route, f_ext=F)
    assert bool(want.isfinite().all()), "the plain route is not finite"
    _close(out, want, tol)


def test_entry_points_default_to_the_card(card):
    assert load_asset("arm7").device.type == "cuda"
    assert parse_urdf(mixed_tree_urdf()).device.type == "cuda"


def _closed_loop(m, B, H):
    """Line-search inputs whose closed loop holds its start, as
    ``_humanoid_inputs`` builds them: rest at 0.3 N(0,1) joint angles (an
    rpy root standing at 0.35 with 0.05 N(0,1) on its coordinates), gravity
    compensation, K = -M(q0) [400 I, 40 I] perturbed by 10% per knot toward
    nominals 0.01 N(0,1) away, from states 0.02 N(0,1) away.  Random gains
    let some of a thousand arm trajectories leave the loop and grow to 1e5
    within 8 knots, where float32 rounding is amplified past any
    tolerance."""
    from rbdtpu_torch.dynamics import minv, rnea

    rng = np.random.default_rng(11)
    T = lambda a: torch.tensor(a, dtype=m.dtype, device=m.device)
    n = m.nv
    q0 = 0.3 * rng.standard_normal((B, n))
    if m.floating_base:
        q0[:, :6] = 0.05 * rng.standard_normal((B, 6))
        q0[:, 2] += 0.35
    q0 = T(q0)
    z = torch.zeros_like(q0)
    x0 = torch.cat([q0, z], -1)
    Xn = x0[:, None] + T(0.01 * rng.standard_normal((B, H, 2 * n)))
    pd = np.concatenate([400.0 * np.eye(n), 40.0 * np.eye(n)], 1)
    gains = T(pd * (1 + 0.1 * rng.standard_normal((B, H, n, 2 * n))))
    Kf = -(torch.linalg.inv(minv(m, q0))[:, None] @ gains)
    kf = -(Kf @ (x0[:, None] - Xn)[..., None])[..., 0]
    Un = rnea(m, q0, z, z)[0][:, None].expand(B, H, n).contiguous()
    xs = x0 + T(0.02 * rng.standard_normal((B, 2 * n)))
    return xs, Xn.contiguous(), Un, kf.contiguous(), Kf.contiguous()


# (inputs, B, H) of K2's checks: the closed loop at TEAM_BATCHES over one
# and eight knots, and random gains over eight knots at 70 trajectories
FEEDBACK_CASES = [("closed", B, H) for B in TEAM_BATCHES for H in (1, 8)]
FEEDBACK_CASES.append(("random", 70, 8))


@pytest.mark.parametrize("inputs,B,H", FEEDBACK_CASES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("clip", [False, True])
def test_feedback_rollout(tree_case, clip, inputs, B, H):
    """K2 against its plain version: over a closed loop, with and without a
    clamp at 0.8 of the largest control each coordinate takes unclamped;
    and open loop, random gains 0.1 N(0,1), with and without a clamp at
    0.05, which bites on most controls."""
    m, _, tol = tree_case
    if inputs == "closed":
        args = _closed_loop(m, B, H)
    else:
        args = _inputs(m, (B, m.nx), (B, H, m.nx), (B, H, m.nv),
                       (B, H, m.nv), (B, H, m.nv, m.nx), scale=0.1)
    u_clip = None
    if clip and inputs == "closed":
        applied = fused.feedback_rollout_plain(m, *args, DT)[1]
        u_clip = 0.8 * applied.abs().amax(dim=(0, 1))
    elif clip:
        u_clip = torch.full((m.nv,), 0.05, dtype=m.dtype, device=m.device)
    X, U = _launched("feedback_rollout", lambda: feedback_rollout_fused(
        m, *args, DT, u_clip=u_clip))
    Xp, Up = fused.feedback_rollout_plain(m, *args, DT, u_clip=u_clip)
    _close(X, Xp, tol)
    _close(U, Up, tol)


@pytest.mark.parametrize("B", [1, 37, 70])
def test_linearize_parts_batches(tree_case, B):
    """K3 at one knot, at a batch past one warp of columns' teams, and at
    an odd batch, on n8 (arm7, the mixed tree) and fb16 (the rpy
    quadruped)."""
    m, _, tol = tree_case
    q, qd, u = _inputs(m, (B, m.nq), (B, m.nv), (B, m.nv))
    out = _launched("linearize_parts",
                    lambda: linearize_parts_fused(m, q, qd, u))
    for a, b in zip(out, colvec.linearize_parts_plain(m, q, qd, u)):
        _close(a, b, tol)


@pytest.mark.parametrize("B", [1, 37, 70])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_linearize_parts_humanoid_batches(card, dtype, B):
    """K3 at fb32 (the humanoid, 11 tree levels) at the same batches."""
    m = _humanoid(dtype)
    assert _lib.size_class("linearize_parts", m) == "fb32"
    _, (x, u) = _humanoid_inputs(m, B, 2)
    q, qd = x[:, :m.nq].contiguous(), x[:, m.nq:].contiguous()
    out = _launched("linearize_parts",
                    lambda: linearize_parts_fused(m, q, qd, u))
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for a, b in zip(out, colvec.linearize_parts_plain(m, q, qd, u)):
        _close(a, b, tol)


def test_linearize_parts(tree_case):
    """On the rpy root the plain version fills the root-pose columns of
    dc/dq by forward-mode AD, the kernel analytically."""
    m, _, tol = tree_case
    q, qd, u = _inputs(m, (300, m.nq), (300, m.nv), (300, m.nv))
    out = _launched("linearize_parts",
                    lambda: linearize_parts_fused(m, q, qd, u))
    for a, b in zip(out, colvec.linearize_parts_plain(m, q, qd, u)):
        _close(a, b, tol)


@pytest.mark.parametrize("B", [1, 37, 128, 12800, 102401])
@pytest.mark.parametrize("gn", [True, False])
def test_ee_gn(case, gn, B):
    """One launch of ee_gn or ee_err against the plain version, at one
    state, an odd batch, the paths' 128 and 12,800 and one past the line
    search's 102,400 (a ragged last block)."""
    m, ee, tol = case
    (q,) = _inputs(m, (B, m.nq), scale=1.0)
    out = _launched("ee_gn" if gn else "ee_err", lambda: ee_gn_fused(
        m, q, TARGET, ee_names=ee, gn=gn))
    for a, b in zip(out, fk_lane.ee_gn_plain(m, q, TARGET, ee_names=ee,
                                             gn=gn)):
        if b is None:
            assert a is None
        else:
            _close(a, b, tol)


def test_wrappers_refuse_bad_input(card):
    m = load_asset("arm7", device=card, dtype=torch.float64)
    x, u = _inputs(m, (8, m.nx), (8, m.nv))
    with pytest.raises(ValueError):  # wrong dtype
        fd_step_fused(m, x, u.float(), DT)
    with pytest.raises(ValueError):  # not contiguous
        fd_step_fused(m, x, torch.cat([u, u], 1)[:, ::2], DT)
    with pytest.raises(ValueError):  # wrong shape
        fd_step_fused(m, x[:, :7], u, DT)
    with pytest.raises(ValueError):  # wrong device
        fd_step_fused(m, x, u.cpu(), DT)
    with pytest.raises(ValueError):  # integer tensors have no kernel
        fd_step_fused(m, x.int(), u.int(), DT)
    # the rpy root reaches K1-K6, K9 and K10 (each launches its kernel; K4
    # the 31-body humanoid too); the quaternion root K1-K6 and K10
    fb = load_asset("quadruped12", device=card, dtype=torch.float64,
                    floating_base=True)
    q = torch.zeros(8, fb.nq, dtype=torch.float64, device=card)
    v = torch.zeros(8, fb.nv, dtype=torch.float64, device=card)
    x = torch.cat([q, v], -1)
    ee = (fb.joint_names[3],)
    for name, launched in (
            ("rnea", lambda: rnea_fused(fb, q, v)),
            ("rnea", lambda: rnea_fused(fb, q, v, v)),
            ("fd_step_minv", lambda: fd_step_minv_fused(fb, x, v, DT)),
            ("fd_step_minv", lambda: fd_step_minv_fused(fb, x, v, DT,
                                                        dense_minv=True)),
            ("ee_err", lambda: ee_gn_fused(fb, q, TARGET, ee_names=ee,
                                           gn=False)[0]),
            ("ee_gn", lambda: ee_gn_fused(fb, q, TARGET, ee_names=ee)[2])):
        assert bool(_launched(name, launched).isfinite().all())
    assert bool(_launched("rollout_multi", lambda: rollout_fused_multi(
        fb, x, v[None], DT)).isfinite().all())
    hum = _humanoid(torch.float64)
    qh = torch.zeros(8, hum.nq, dtype=torch.float64, device=card)
    assert bool(_launched("ee_gn", lambda: ee_gn_fused(
        hum, qh, TARGET, ee_names=(hum.joint_names[hum.leaves()[0]],))[2])
        .isfinite().all())
    quat = load_asset("quadruped12", device=card, dtype=torch.float64,
                      floating_base=True, root_quat=True)
    qq = torch.zeros(8, quat.nq, dtype=torch.float64, device=card)
    vq = torch.zeros(8, quat.nv, dtype=torch.float64, device=card)
    xq = torch.cat([qq, vq], -1)
    qq[:, 3] = 1.0
    xq = torch.cat([qq, vq], -1)
    for name, launched in (
            ("rnea", lambda: rnea_fused(quat, qq, vq)),
            ("fd_step_minv", lambda: fd_step_minv_fused(quat, xq, vq, DT))):
        assert bool(_launched(name, launched).isfinite().all())
    assert bool(_launched("rollout_multi", lambda: rollout_fused_multi(
        quat, xq, vq[None], DT)).isfinite().all())
    got = _launched("linearize_parts",
                    lambda: linearize_parts_fused(quat, qq, vq, vq))
    for a, b in zip(got, colvec.linearize_parts_plain(quat, qq, vq, vq)):
        _close(a, b, 1e-9)


def test_ddp_kernels_match_plain(card):
    """A short arm7 EE-reaching solve through the kernels and through the
    plain versions, float64: the controls agree to 1e-6."""
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import DDPConfig, ddp_solve, ee_reaching_cost

    m = load_asset("arm7", device=card, dtype=torch.float64)
    (q0,) = _inputs(m, (3, m.nq), scale=0.3)
    z = torch.zeros_like(q0)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(m, q0, z, z)[0][:, None].expand(3, 12, m.nv).contiguous()
    w = dict(w_ee=10.0, w_ee_f=2000.0, w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)
    out = []
    for fused_ in (True, False):
        cost = ee_reaching_cost(m, TARGET, fused=None if fused_ else False,
                                **w)
        out.append(ddp_solve(m, cost, x0, U0,
                             DDPConfig(iters=5, n_alphas=8, fused=fused_))[0])
    assert (out[0].U - out[1].U).abs().max().item() < 1e-6


def _riccati(B, H, nx, nu, const, dtype, seed, non_pd=None):
    return tuple(torch.tensor(a, dtype=dtype, device="cuda")
                 for a in riccati_problem(np.random.default_rng(seed), nx, nu,
                                          H, B, const, non_pd))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("B,H,nx,nu,const", [
    (4, 6, 10, 4, True), (130, 5, 10, 4, False), (16, 4, 36, 18, True),
    (128, 3, 36, 18, False), (3, 3, 72, 36, False), (1, 1, 6, 1, True),
    (7, 5, 13, 5, False), (16, 4, 72, 36, True), (256, 3, 72, 36, True)],
    ids=["small", "lane", "quad-small", "quad-lane", "humanoid", "one",
         "odd", "path-C", "path-D"])
def test_riccati_chunked(card, B, H, nx, nu, const, dtype):
    """The sweep kernel against the plain sweep at both call sites, with
    constant and per-knot cost blocks: one problem of one knot and one
    control, an odd nx = 13 / nu = 5 (tiles past every edge), and the
    humanoid's nx = 72 / nu = 36 at path C's 16 problems and path D's 256
    (256 threads a block, 195 KB of shared memory in float64); float64
    within 1e-9 relative to the
    output's scale, float32 within 1e-3 (a Riccati sweep accumulates the
    reordered float32 sums of H knots)."""
    from rbdtpu_torch.solver.ddp import backward_pass

    args = _riccati(B, H, nx, nu, const, dtype, B + nx)
    name = "riccati_chunk" if B >= 128 else "riccati_small"
    out = _launched(name, lambda: backward_pass_chunked(*args))
    ref = backward_pass(*args)
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in zip(out[:3], ref[:3]):
        _close(a, b, tol)
    assert out[3].tolist() == ref[3].tolist() == [True] * B


@pytest.mark.parametrize("knot", [0, 3], ids=["t0", "mid"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_riccati_non_pd_humanoid(card, dtype, knot):
    """A non-PD Quu at knot t = 0 (the sweep's last) or mid-horizon in one
    of 16 humanoid-size problems (path C's batch): NaN gains from that knot
    back and ok False where the plain sweep has them, the other problems
    within the sweep's tolerance."""
    from rbdtpu_torch.solver.ddp import backward_pass

    args = _riccati(16, 6, 72, 36, False, dtype, 11 + knot, non_pd=(9, knot))
    k, K, dV, ok = _launched("riccati_small",
                             lambda: backward_pass_chunked(*args))
    kr, Kr, dVr, okr = backward_pass(*args)
    assert ok.tolist() == okr.tolist() == [i != 9 for i in range(16)]
    assert torch.equal(k.isnan(), kr.isnan())
    assert torch.equal(K.isnan(), Kr.isnan())
    assert k[9, :knot + 1].isnan().all() and k[9, knot + 1:].isfinite().all()
    fin = ok.nonzero()[:, 0]
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in ((k[fin], kr[fin]), (K[fin], Kr[fin]), (dV[fin], dVr[fin])):
        _close(a, b, tol)


def test_riccati_non_pd(card):
    """A non-PD Quu: NaN gains from that knot back and ok False, in the same
    places as the plain sweep; the other problems are untouched."""
    from rbdtpu_torch.solver.ddp import backward_pass

    args = _riccati(5, 6, 10, 4, False, torch.float64, 3, non_pd=(2, 3))
    k, K, dV, ok = backward_pass_chunked(*args)
    kr, Kr, dVr, okr = backward_pass(*args)
    assert ok.tolist() == okr.tolist() == [True, True, False, True, True]
    assert torch.equal(k.isnan(), kr.isnan())
    assert torch.equal(K.isnan(), Kr.isnan())
    assert k[2, :4].isnan().all() and k[2, 4:].isfinite().all()
    fin = ok.nonzero()[:, 0]
    _close(K[fin], Kr[fin], 1e-9)
    _close(dV[fin], dVr[fin], 1e-9)


@pytest.mark.parametrize("Bm,H,iters", [(4, 10, 3), (130, 4, 2)],
                         ids=["small", "lane"])
def test_ddp_quadruped_kernels_match_plain(card, Bm, H, iters):
    """The floating-base quadruped solve (BASELINE.json configs[3]'s
    problem, short) through K1, K2, K3 and the sweep kernel, and through
    the plain versions, float64: the controls agree to 1e-6."""
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import (
        DDPConfig, ddp_solve, quadratic_tracking_cost,
    )

    m = load_asset("quadruped12", device=card, dtype=torch.float64,
                   floating_base=True)
    rng = np.random.default_rng(11)
    q0 = np.zeros((Bm, m.nq))
    q0[:, 2] = 0.35
    q0 = torch.tensor(q0 + 0.05 * rng.standard_normal(q0.shape),
                      device=card)
    z = torch.zeros(Bm, m.nv, dtype=torch.float64, device=card)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(m, q0, z, z)[0][:, None].expand(Bm, H, m.nv).contiguous()
    goal = torch.zeros(m.nx, dtype=torch.float64)
    goal[2] = 0.4
    cost = quadratic_tracking_cost(m, goal, w_q=2.0, w_qd=0.05, w_u=1e-5)
    name = "riccati_chunk" if Bm >= 128 else "riccati_small"
    before = _lib.launches[name]
    a = ddp_solve(m, cost, x0, U0, DDPConfig(iters=iters, n_alphas=6,
                                             fused=True))[0]
    torch.cuda.synchronize()
    assert _lib.launches[name] == before + iters
    b = ddp_solve(m, cost, x0, U0, DDPConfig(iters=iters, n_alphas=6,
                                             fused=False,
                                             fused_riccati=False))[0]
    assert (a.U - b.U).abs().max().item() < 1e-6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("B,H,nx,nu,const", [
    (1, 100, 14, 7, False), (3, 20, 14, 7, True), (130, 6, 14, 7, False),
    (5, 7, 6, 3, True), (4, 5, 16, 16, False)] + [
    (B, 5, nx, nu, const) for B in (1, 4, 128, 133)
    for nx, nu in ((16, 16), (13, 5), (10, 1)) for const in (False, True)],
    ids=["one-arm7", "three-constant", "lane-arm7", "small", "nx16"] + [
    f"B{B}-{nx}-{nu}-{'constant' if const else 'per-knot'}"
    for B in (1, 4, 128, 133)
    for nx, nu in ((16, 16), (13, 5), (10, 1)) for const in (False, True)])
def test_riccati_fused(card, B, H, nx, nu, const, dtype):
    """The arm-class sweep kernel (K11, one block a problem) against the
    plain sweep, one launch a call, at any batch: path B's one problem, the
    parity cases' four, configs[2]'s 128 and more problems than SMs, with
    per-knot and constant cost blocks, up to nx = nu = 16, an odd (13, 5)
    and one control; float64 within 1e-9 relative to the output's scale,
    float32 within 1e-3 (a sweep accumulates the reordered float32 sums of
    H knots)."""
    from rbdtpu_torch.solver.ddp import backward_pass

    args = _riccati(B, H, nx, nu, const, dtype, 2 * B + nx)
    out = _launched("riccati_fused", lambda: backward_pass_fused(*args))
    ref = backward_pass(*args)
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in zip(out[:3], ref[:3]):
        _close(a, b, tol)
    assert out[3].tolist() == ref[3].tolist() == [True] * B


@pytest.mark.parametrize("knot", [0, 50], ids=["t0", "mid"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_riccati_fused_non_pd_knots(card, dtype, knot):
    """A non-PD Quu at knot t = 0 (the sweep's last) or mid-horizon in one
    of configs[2]'s 128 arm-size problems (H = 100): NaN gains from that
    knot back and ok False where the plain sweep has them, the other
    problems within the sweep's tolerance."""
    from rbdtpu_torch.solver.ddp import backward_pass

    args = _riccati(128, 100, 14, 7, False, dtype, 17 + knot,
                    non_pd=(77, knot))
    k, K, dV, ok = _launched("riccati_fused",
                             lambda: backward_pass_fused(*args))
    kr, Kr, dVr, okr = backward_pass(*args)
    assert ok.tolist() == okr.tolist() == [i != 77 for i in range(128)]
    assert torch.equal(k.isnan(), kr.isnan())
    assert torch.equal(K.isnan(), Kr.isnan())
    assert k[77, :knot + 1].isnan().all() and k[77, knot + 1:].isfinite().all()
    fin = ok.nonzero()[:, 0]
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in ((k[fin], kr[fin]), (K[fin], Kr[fin]), (dV[fin], dVr[fin])):
        _close(a, b, tol)


def test_riccati_fused_non_pd(card):
    """A non-PD Quu: NaN gains from that knot back and ok False, in the same
    places as the plain sweep; the other problems are untouched."""
    from rbdtpu_torch.solver.ddp import backward_pass

    args = _riccati(6, 8, 14, 7, False, torch.float64, 5, non_pd=(4, 5))
    k, K, dV, ok = backward_pass_fused(*args)
    kr, Kr, dVr, okr = backward_pass(*args)
    assert ok.tolist() == okr.tolist() == [True] * 4 + [False, True]
    assert torch.equal(k.isnan(), kr.isnan())
    assert torch.equal(K.isnan(), Kr.isnan())
    assert k[4, :6].isnan().all() and k[4, 6:].isfinite().all()
    fin = ok.nonzero()[:, 0]
    _close(K[fin], Kr[fin], 1e-9)
    _close(dV[fin], dVr[fin], 1e-9)


def _arm_start(m, B, H):
    from rbdtpu_torch.dynamics import rnea

    (q0,) = _inputs(m, (B, m.nq), scale=0.3)
    z = torch.zeros_like(q0)
    return (torch.cat([q0, z], -1),
            rnea(m, q0, z, z)[0][:, None].expand(B, H, m.nv).contiguous())


@pytest.mark.parametrize("option", ["fused_riccati", "parallel_riccati"])
def test_ddp_backward_routes_match_plain(card, option):
    """The arm7 EE solve in float64 with the backward pass through K11
    (one launch an iteration, no plain sweep) or the parallel scan, beside
    the plain sweep: K11 gives the plain sweep's controls (1e-6); the scan
    solves the exactly regularised subproblem, so its iterates differ and
    only its descent is held."""
    from rbdtpu_torch.solver import DDPConfig, ddp_solve, ee_reaching_cost

    m = load_asset("arm7", device=card, dtype=torch.float64)
    x0, U0 = _arm_start(m, 3, 12)
    cost = ee_reaching_cost(m, TARGET, w_ee=10.0, w_ee_f=2000.0, w_u=1e-6,
                            w_qd=1e-3, w_qd_f=0.1)
    before = _lib.launches["riccati_fused"]
    a, hist = ddp_solve(m, cost, x0, U0, DDPConfig(iters=4, n_alphas=8,
                                                   fused=True, **{option: True}))
    torch.cuda.synchronize()
    b = ddp_solve(m, cost, x0, U0, DDPConfig(iters=4, n_alphas=8, fused=True,
                                             fused_riccati=False))[0]
    if option == "fused_riccati":
        assert _lib.launches["riccati_fused"] == before + 4
        assert (a.U - b.U).abs().max().item() < 1e-6
    else:
        assert _lib.launches["riccati_fused"] == before
        assert torch.isfinite(a.U).all() and (hist[-1] <= hist[0]).all()


def test_mpc_step_and_checkpoint_on_the_card(card, tmp_path):
    """A batched MPC tick through the kernels, and its solver state
    written and read back on the card bit for bit."""
    from rbdtpu_torch.solver import (
        DDPConfig, MPCCarry, ddp_solve, ee_reaching_cost, load_solver_state,
        mpc_step, save_solver_state,
    )

    m = load_asset("arm7", device=card, dtype=torch.float32)
    x0, U0 = _arm_start(m, 2, 10)
    cost = ee_reaching_cost(m, TARGET)
    cfg = DDPConfig(iters=2, n_alphas=4, fused=True, fused_riccati=True)
    carry, (u, J) = mpc_step(m, cost, MPCCarry(x0, U0), cfg)
    assert carry.x.shape == x0.shape and u.shape == (2, m.nv)
    assert torch.isfinite(carry.x).all() and torch.isfinite(J).all()
    state = ddp_solve(m, cost, x0, U0, cfg)[0]
    path = str(tmp_path / "state.npz")
    save_solver_state(path, state)
    back = load_solver_state(path, state)
    for a, b in zip(back, state):
        assert a.device == b.device and torch.equal(a, b)


def _humanoid(dtype):
    return load_asset("humanoid30", device="cuda", dtype=dtype,
                      floating_base=True)


@pytest.mark.parametrize("B", MINV_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_humanoid_rnea_and_minv_step(card, dtype, B):
    """K10 (with and without qdd) and K6 (both routes, without wrenches
    and under one set shared by the batch and one an element) at the
    humanoid's size class (fb32, 31 bodies, 11 tree levels) against their
    plain versions: 1e-9 in float64, 1e-4 relative in float32."""
    m = _humanoid(dtype)
    assert _lib.size_class("rnea", m) == "fb32"
    assert _lib.size_class("fd_step_minv", m) == "fb32"
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    _, (x, u) = _humanoid_inputs(m, B, 1)
    q, qd = x[:, :m.nq].contiguous(), x[:, m.nq:].contiguous()
    (qdd,) = _inputs(m, (B, m.nv))
    for a in (qdd, None):
        out = _launched("rnea", lambda: rnea_fused(m, q, qd, a))
        _close(out, fused.rnea_plain(m, q, qd, a), tol)
    fes = [None] + [20.0 * _inputs(m, s)[0] for s in ((m.nb, 6),
                                                      (B, m.nb, 6))]
    for dense in (False, True):
        for fe in fes:
            out = _launched("fd_step_minv", lambda: fd_step_minv_fused(
                m, x, u, DT, dense_minv=dense, f_ext=fe))
            _close(out, fused.fd_step_minv_plain(m, x, u, DT, f_ext=fe), tol)


def _humanoid_inputs(m, B, H):
    """configs[4]'s start (standing at q[2] = 0.9, 0.02 N(0,1) on every
    coordinate, at rest) and a closed loop that holds it: gravity
    compensation plus K (x - x0), K = -M(q0) [400 I, 40 I] perturbed by 10%
    per knot, from states 0.02 N(0,1) away.  Random gains would make the
    humanoid's light links amplify rounding far beyond any tolerance.
    Returns (x0, Xn, Un, kf, Kf) and step inputs (x, u) at B states."""
    from rbdtpu_torch.dynamics import minv, rnea

    rng = np.random.default_rng(5)
    T = lambda a: torch.tensor(a, dtype=m.dtype, device=m.device)
    n = m.nv
    q0 = np.zeros((B, n))
    q0[:, 2] = 0.9
    q0 = T(q0 + 0.02 * rng.standard_normal(q0.shape))
    z = torch.zeros_like(q0)
    x0 = torch.cat([q0, z], -1)
    g = rnea(m, q0, z, z)[0]
    Xn = x0[:, None] + T(0.01 * rng.standard_normal((B, H, 2 * n)))
    pd = np.concatenate([400.0 * np.eye(n), 40.0 * np.eye(n)], 1)
    gains = T(pd * (1 + 0.1 * rng.standard_normal((B, H, n, 2 * n))))
    Kf = -(torch.linalg.inv(minv(m, q0))[:, None] @ gains)
    kf = -(Kf @ (x0[:, None] - Xn)[..., None])[..., 0]
    Un = g[:, None].expand(B, H, n).contiguous()
    xs = x0 + T(0.02 * rng.standard_normal((B, 2 * n)))
    qd = T(0.5 * rng.standard_normal((B, n)))
    u = g + T(rng.standard_normal((B, n)))
    return ((xs, Xn.contiguous(), Un, kf.contiguous(), Kf.contiguous()),
            (torch.cat([q0, qd], -1), u))


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_humanoid_tree_kernels(card, dtype, B):
    """K1, K2 and K3 at the humanoid's size class (fb32, 31 bodies) against
    their plain versions: 1e-9 in float64, 1e-4 relative in float32 (1e-3
    for the 8-knot closed loop).  K1 also under world wrenches, one set
    shared by the batch and one per state; K2 also over one knot with and
    without a clamp at 0.8 of the largest first control."""
    m = _humanoid(dtype)
    assert _lib.size_class("fd_step", m) == "fb32"
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    fb, (x, u) = _humanoid_inputs(m, B, 8)
    out = _launched("fd_step", lambda: fd_step_fused(m, x, u, DT))
    _close(out, fused.fd_step_plain(m, x, u, DT), tol)
    for shape in ((m.nb, 6), (B, m.nb, 6)):
        fe = 20.0 * _inputs(m, shape)[0]
        out = _launched("fd_step",
                        lambda: fd_step_fused(m, x, u, DT, f_ext=fe))
        _close(out, fused.fd_step_plain(m, x, u, DT, f_ext=fe), tol)
    X, U = _launched("feedback_rollout",
                     lambda: feedback_rollout_fused(m, *fb, DT))
    Xp, Up = fused.feedback_rollout_plain(m, *fb, DT)
    _close(X, Xp, 10 * tol if dtype == torch.float32 else tol)
    _close(U, Up, 10 * tol if dtype == torch.float32 else tol)
    one = tuple((a[:, :1] if a.dim() > 2 else a).contiguous() for a in fb)
    clip = 0.8 * fused.feedback_rollout_plain(m, *one, DT)[1].abs().amax(
        dim=(0, 1))
    for u_clip in (None, clip):
        X, U = _launched("feedback_rollout", lambda: feedback_rollout_fused(
            m, *one, DT, u_clip=u_clip))
        Xp, Up = fused.feedback_rollout_plain(m, *one, DT, u_clip=u_clip)
        _close(X, Xp, tol)
        _close(U, Up, tol)
    q, qd = x[:, :m.nq].contiguous(), x[:, m.nq:].contiguous()
    out = _launched("linearize_parts",
                    lambda: linearize_parts_fused(m, q, qd, u))
    for a, b in zip(out, colvec.linearize_parts_plain(m, q, qd, u)):
        _close(a, b, tol)


@pytest.mark.parametrize("nchunks", [1, 2, 3, 100])
@pytest.mark.parametrize("clip", [False, True])
def test_feedback_chunked(tree_case, clip, nchunks):
    """K9 against its plain version (rbdtpu's chunked order of sums) at
    any chunk count, with and without the clamp, on the fixed-base trees
    and the rpy quadruped; an odd batch."""
    m, _, tol = tree_case
    B, H = 67, 8
    args = _inputs(m, (B, m.nx), (B, H, m.nx), (B, H, m.nv), (B, H, m.nv),
                   (B, H, m.nv, m.nx), scale=0.1)
    u_clip = torch.full((m.nv,), 0.05, dtype=m.dtype,
                        device=m.device) if clip else None
    X, U = _launched("feedback_chunked", lambda: feedback_rollout_fused_chunked(
        m, *args, DT, u_clip=u_clip, nchunks=nchunks))
    Xp, Up = fused.feedback_rollout_chunked_plain(m, *args, DT, u_clip=u_clip,
                                                  nchunks=nchunks)
    _close(X, Xp, tol)
    _close(U, Up, tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("nchunks", [1, 2, 3, 100])
def test_feedback_chunked_humanoid(card, dtype, nchunks):
    """K9 at the humanoid's size class against its plain version and
    against K2 on the same inputs (in float64 they differ only in the order
    of the feedback sums)."""
    m = _humanoid(dtype)
    fb, _ = _humanoid_inputs(m, 70, 8)
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    X, U = _launched("feedback_chunked", lambda: feedback_rollout_fused_chunked(
        m, *fb, DT, nchunks=nchunks))
    Xp, Up = fused.feedback_rollout_chunked_plain(m, *fb, DT, nchunks=nchunks)
    X2, U2 = feedback_rollout_fused(m, *fb, DT)
    for a, b in ((X, Xp), (U, Up), (X, X2), (U, U2)):
        _close(a, b, tol)


def test_feedback_chunked_refuses_a_bad_split(card):
    """The launch takes the chunk width and count from the caller
    (``fused.chunk_geometry``) and refuses a split that does not cover the
    gain's columns exactly."""
    m = load_asset("arm7", device=card, dtype=torch.float64)
    B, H = 4, 2
    x0, Xn, Un, kf, Kf = _inputs(m, (B, m.nx), (B, H, m.nx), (B, H, m.nv),
                                 (B, H, m.nv), (B, H, m.nv, m.nx))
    Xo, Uo = torch.empty_like(Xn), torch.empty_like(Un)
    assert fused.chunk_geometry(m.nx, 2) == (7, 2)
    geometry = _lib.team_args("feedback_chunked", m, x0, B)
    for cw, nc in ((7, 1), (7, 3), (0, 14), (14, 0)):
        with pytest.raises(RuntimeError, match="feedback_chunked"):
            _lib.launch("feedback_chunked", m, x0, x0, Xn, Un, kf, Kf, None,
                        Xo, Uo, B, H, cw, nc, *geometry, DT, -9.81)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("nchunks", [1, 2, 3, 100])
def test_feedback_chunked_path_d(card, dtype, nchunks):
    """K9 at path D's line search (1024 humanoid trajectories x 32 knots)
    against its plain version, with and without a clamp at 0.8 of the
    largest unclamped control, at one trajectory and at an odd batch, and
    against K2 on the same inputs: 1e-9 in float64, 1e-3 relative in
    float32 (32 closed-loop humanoid knots)."""
    m = _humanoid(dtype)
    fb, _ = _humanoid_inputs(m, 1024, 32)
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    U = fused.feedback_rollout_plain(m, *fb, DT)[1]
    clip = (0.8 * U.abs().amax(dim=(0, 1))).contiguous()
    cases = [(fb, None), (fb, clip)] + [
        (tuple(a[:B].contiguous() for a in fb), None) for B in (1, 1021)]
    for args, u_clip in cases:
        X, U = _launched("feedback_chunked",
                         lambda: feedback_rollout_fused_chunked(
                             m, *args, DT, u_clip=u_clip, nchunks=nchunks))
        Xp, Up = fused.feedback_rollout_chunked_plain(
            m, *args, DT, u_clip=u_clip, nchunks=nchunks)
        _close(X, Xp, tol)
        _close(U, Up, tol)
    X, U = feedback_rollout_fused_chunked(m, *fb, DT, nchunks=nchunks)
    X2, U2 = feedback_rollout_fused(m, *fb, DT)
    _close(X, X2, tol)
    _close(U, U2, tol)


def test_feedback_chunked_keeps_the_stack_limit(card):
    """K9 at the humanoid's size class in double, a team kernel since its
    redesign, runs right under a 1,024-byte stack limit and leaves it
    there; the limit is set back afterwards."""
    limit = _lib.stack_limit(card)
    _lib.set_stack_limit(card, 1024)
    try:
        m = _humanoid(torch.float64)
        fb, _ = _humanoid_inputs(m, 70, 4)
        X, U = _launched("feedback_chunked", lambda: (
            feedback_rollout_fused_chunked(m, *fb, DT, nchunks=2)))
        Xp, Up = fused.feedback_rollout_chunked_plain(m, *fb, DT, nchunks=2)
        _close(X, Xp, 1e-9)
        _close(U, Up, 1e-9)
        assert _lib.stack_limit(card) == 1024
    finally:
        _lib.set_stack_limit(card, limit)


def test_stack_limit_round_trip(card):
    """The per-thread stack limit reads back what was set; K3 at the
    humanoid's size class in double, whose columns keep their state in
    shared memory, runs right under a 1,024-byte limit and leaves it at
    1,024 bytes; the limit is set back afterwards."""
    limit = _lib.stack_limit(card)
    _lib.set_stack_limit(card, 1024)
    try:
        assert _lib.stack_limit(card) == 1024
        m = _humanoid(torch.float64)
        _, (x, u) = _humanoid_inputs(m, 70, 2)
        q, qd = x[:, :m.nq].contiguous(), x[:, m.nq:].contiguous()
        out = _launched("linearize_parts",
                        lambda: linearize_parts_fused(m, q, qd, u))
        for a, b in zip(out, colvec.linearize_parts_plain(m, q, qd, u)):
            _close(a, b, 1e-9)
        assert _lib.stack_limit(card) == 1024
    finally:
        _lib.set_stack_limit(card, limit)
    assert _lib.stack_limit(card) == limit


def test_ddp_k9_tier_on_the_card(card):
    """The humanoid DDP solve at the smallest batch where rbdtpu's rule
    sends the line search to K9 with two chunks (142 problems, 4 step
    sizes): one K9 launch an iteration and no K2, and the K2 tier's
    controls, float64."""
    from rbdtpu_torch.solver import DDPConfig, ddp, ddp_solve, \
        quadratic_tracking_cost

    m = _humanoid(torch.float64)
    fb, _ = _humanoid_inputs(m, 142, 2)
    x0, U0 = fb[0], fb[2]
    goal = torch.zeros(m.nx, dtype=m.dtype)
    goal[2] = 0.95
    cost = quadratic_tracking_cost(m, goal, w_q=2.0, w_qd=0.05, w_u=1e-5)
    cfg = dict(iters=2, n_alphas=4, fused=True)
    assert ddp._feedback_route(m, DDPConfig(fused_feedback=True, **cfg),
                               568) == ("chunked", 2)
    before = dict(_lib.launches)
    a = ddp_solve(m, cost, x0, U0, DDPConfig(fused_feedback=True, **cfg))[0]
    torch.cuda.synchronize()
    assert _lib.launches["feedback_chunked"] == before["feedback_chunked"] + 2
    assert _lib.launches["feedback_rollout"] == before["feedback_rollout"]
    b = ddp_solve(m, cost, x0, U0, DDPConfig(fused_feedback=None, **cfg))[0]
    assert (a.U - b.U).abs().max().item() < 1e-6


def test_hybrid_solve_on_the_card(card):
    """configs[4]'s hybrid, small, float64: through the kernels and
    through the plain versions on the card with the same noise, the same
    controls (1e-6); a bfloat16 sampling rollout has no kernel and
    raises."""
    from rbdtpu_torch.solver import (
        DDPConfig, MPPIConfig, hybrid_solve, mppi_step,
        quadratic_tracking_cost,
    )

    m = _humanoid(torch.float64)
    fb, _ = _humanoid_inputs(m, 2, 4)
    x0, U0 = fb[0], fb[2]
    goal = torch.zeros(m.nx, dtype=m.dtype)
    goal[2] = 0.95
    cost = quadratic_tracking_cost(m, goal, w_q=2.0, w_qd=0.05, w_u=1e-5)
    noise = torch.randn(2, 2, 8, 4, m.nv, dtype=m.dtype, device=card,
                        generator=torch.Generator(card).manual_seed(3))
    out = []
    for kernels in (True, False):
        state, (mh, dh) = hybrid_solve(
            m, cost, x0, U0, None,
            MPPIConfig(n_samples=8, sigma=0.3, fused=kernels),
            DDPConfig(iters=2, n_alphas=4, fused=kernels), mppi_iters=2,
            noise=noise)
        out.append(state.U)
        assert torch.isfinite(mh).all() and torch.isfinite(dh).all()
    assert (out[0] - out[1]).abs().max().item() < 1e-6
    with pytest.raises(ValueError):
        mppi_step(m, cost, x0, U0, torch.Generator(card), MPPIConfig(
            n_samples=8, fused=True, sampling_dtype="bfloat16"))


# ---- K4 on the rpy root (fb16) and K2/K9 with wrenches ----

QUAD_EE = ("FL_knee",)


@pytest.mark.parametrize("ee", ["leaf", "foot"])
@pytest.mark.parametrize("B", [1, 37, 1024, 51200, 313345])
@pytest.mark.parametrize("gn", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_ee_gn_rpy(card, dtype, gn, B, ee):
    """One launch of K4's fb16 instantiation (ee_gn or ee_err) on the rpy
    quadruped against the plain version, at a leaf joint and at a foot's
    fixed frame: one state, an odd batch, path E's 1,024 (terminal) and
    51,200 (knots), and one past its line search's 313,344; q uniform in
    [-1, 1] (the root turned as far)."""
    m = load_asset("quadruped12", device="cuda", dtype=dtype,
                   floating_base=True)
    assert _lib.size_class("ee_gn", m) == "fb16"
    names = QUAD_EE if ee == "leaf" else ("RL_foot_fixed",)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    q = torch.tensor(np.random.default_rng(9).uniform(-1, 1, (B, m.nq)),
                     dtype=dtype, device="cuda")
    target = (0.3, 0.1, 0.1)
    out = _launched("ee_gn" if gn else "ee_err", lambda: ee_gn_fused(
        m, q, target, ee_names=names, gn=gn))
    for a, b in zip(out, fk_lane.ee_gn_plain(m, q, target, ee_names=names,
                                             gn=gn)):
        if b is None:
            assert a is None
        else:
            _close(a, b, tol)


def _fext_models(dtype):
    """(name, model, closed-loop line-search inputs at 37 trajectories of 8
    knots) at each class: arm7 (n8), the rpy quadruped (fb16), the
    humanoid (fb32)."""
    arm = load_asset("arm7", device="cuda", dtype=dtype)
    quad = load_asset("quadruped12", device="cuda", dtype=dtype,
                      floating_base=True)
    hum = _humanoid(dtype)
    return [("arm7", arm, _closed_loop(arm, 37, 8)),
            ("quad_rpy", quad, _closed_loop(quad, 37, 8)),
            ("humanoid", hum, _humanoid_inputs(hum, 37, 8)[0])]


@pytest.mark.parametrize("nchunks", [None, 1, 2, 3],
                         ids=["k2", "k9-1", "k9-2", "k9-3"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_feedback_fext(card, dtype, nchunks):
    """K2 (nchunks None) and K9 with per-knot wrenches (H, nb, 6) against
    their plain versions at n8, fb16 and fb32 (1e-9 in float64, 1e-3
    relative in float32 over 8 closed-loop knots), with and without a
    clamp, at 37 trajectories (two of a block past the batch when teams
    share a block) and at one; with all-zero wrenches each equals its
    wrench-free twin bit for bit."""
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    name = "feedback_rollout" if nchunks is None else "feedback_chunked"
    kern = (feedback_rollout_fused if nchunks is None else
            lambda *a, **kw: feedback_rollout_fused_chunked(
                *a, nchunks=nchunks, **kw))
    plain = (fused.feedback_rollout_plain if nchunks is None else
             lambda *a, **kw: fused.feedback_rollout_chunked_plain(
                 *a, nchunks=nchunks, **kw))
    for label, m, fb in _fext_models(dtype):
        (F,) = _inputs(m, (8, m.nb, 6), scale=2.0)
        F[2:5, 0, 4] += 40.0
        applied = plain(m, *fb, DT, f_ext=F)[1]
        clip = 0.8 * applied.abs().amax(dim=(0, 1))
        for args in (fb, tuple(a[:1].contiguous() for a in fb)):
            for u_clip in (None, clip):
                X, U = _launched(name + "_fext", lambda: kern(
                    m, *args, DT, u_clip=u_clip, f_ext=F))
                Xp, Up = plain(m, *args, DT, u_clip=u_clip, f_ext=F)
                _close(X, Xp, tol)
                _close(U, Up, tol)
        Z = torch.zeros_like(F)
        X, U = _launched(name + "_fext", lambda: kern(m, *fb, DT, f_ext=Z))
        X0, U0 = _launched(name, lambda: kern(m, *fb, DT))
        assert torch.equal(X, X0) and torch.equal(U, U0), label


def test_feedback_fext_refuses_bad_wrenches(card):
    """The wrench variants take (H, nb, 6) on the inputs' device and dtype
    only."""
    m = load_asset("arm7", device=card, dtype=torch.float64)
    fb = _closed_loop(m, 4, 3)
    for bad in (torch.zeros(m.nb, 6, dtype=m.dtype, device=card),
                torch.zeros(3, m.nb, 6, dtype=torch.float32, device=card),
                torch.zeros(4, m.nb, 6, dtype=m.dtype, device=card)):
        with pytest.raises(ValueError):
            feedback_rollout_fused(m, *fb, DT, f_ext=bad)
        with pytest.raises(ValueError):
            feedback_rollout_fused_chunked(m, *fb, DT, f_ext=bad)


def test_ddp_fext_kernels_match_plain(card):
    """``ddp_solve(f_ext)`` on the rpy quadruped (configs[3]'s tracking
    problem, Bm=4, H=10, 3 iterations, float64) through the kernels and
    through the plain route under a per-knot trunk push: |dU| < 1e-6; the
    kernel route launches K1 and K2 with wrenches, and no wrench-free K2."""
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import (
        DDPConfig, ddp_solve, quadratic_tracking_cost,
    )

    m = load_asset("quadruped12", device=card, dtype=torch.float64,
                   floating_base=True)
    Bm, H = 4, 10
    rng = np.random.default_rng(13)
    q0 = np.zeros((Bm, m.nq))
    q0[:, 2] = 0.35
    q0 = torch.tensor(q0 + 0.05 * rng.standard_normal(q0.shape),
                      device=card)
    z = torch.zeros(Bm, m.nv, dtype=m.dtype, device=card)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(m, q0, z, z)[0][:, None].expand(Bm, H, m.nv).contiguous()
    goal = torch.zeros(m.nx, dtype=m.dtype, device=card)
    goal[2] = 0.4
    cost = quadratic_tracking_cost(m, goal, w_q=2.0, w_qd=0.05, w_u=1e-5)
    F = torch.zeros(H, m.nb, 6, dtype=m.dtype, device=card)
    F[2:6, 0, 4] = 60.0
    _lib.reset_launches()
    sk, _ = ddp_solve(m, cost, x0, U0, DDPConfig(iters=3, n_alphas=6,
                                                fused=True), f_ext=F)
    counts = dict(_lib.launches)
    sp, _ = ddp_solve(m, cost, x0, U0, DDPConfig(iters=3, n_alphas=6,
                                                fused=False,
                                                fused_riccati=False), f_ext=F)
    assert counts["feedback_rollout_fext"] == 3 and counts["fd_step"] == H
    assert counts["feedback_rollout"] == counts["feedback_chunked"] == 0
    assert (sk.U - sp.U).abs().max().item() < 1e-6


def _quat(name, dtype):
    return load_asset(name, device="cuda", dtype=dtype, floating_base=True,
                      root_quat=True)


def _quat_states(m, B, seed=21):
    """B quaternion-root states (the identity pose 0.5 high retracted by
    0.3 N(0,1), velocities 0.5 N(0,1)) and controls N(0,1), on the card."""
    from rbdtpu_torch.solver.integrate import config_retract

    rng = np.random.default_rng(seed)
    q = torch.zeros(B, m.nq, dtype=torch.float64)
    q[:, 2], q[:, 3] = 0.5, 1.0
    q = config_retract(m, q, torch.tensor(0.3 * rng.standard_normal((B, m.nv))))
    x = torch.cat([q, torch.tensor(0.5 * rng.standard_normal((B, m.nv)))], -1)
    u = torch.tensor(rng.standard_normal((B, m.nv)))
    return (x.to(device=m.device, dtype=m.dtype),
            u.to(device=m.device, dtype=m.dtype))


QUAT_MODELS = ("quadruped12", "humanoid30")
DTYPES = [torch.float64, torch.float32]


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_fd_step(card, name, dtype, B):
    """K1 on the quaternion root ("fq32": the manifold Euler step) against
    its plain version."""
    m = _quat(name, dtype)
    x, u = _quat_states(m, B)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    _close(_launched("fd_step", lambda: fd_step_fused(m, x, u, DT)),
           fused.fd_step_plain(m, x, u, DT), tol)


def _quat_line_search(m64, B, H):
    """Float64 line-search inputs (x0, Xn, Un, kf, Kf) on the quaternion
    root, on the card: nominals near the start, stabilising gains -M(q0)
    [400 I, 40 I] acting on the tangent difference, k cancelling K (x0 (-)
    X_t), the start 0.02 N(0,1) away in the tangent."""
    from rbdtpu_torch.dynamics import minv
    from rbdtpu_torch.solver.integrate import state_diff, state_retract

    x0, _ = _quat_states(m64, B, seed=22)
    rng = np.random.default_rng(23)
    n = m64.nv
    T = lambda *s: torch.tensor(rng.standard_normal(s), device=m64.device)
    Xn = torch.stack([state_retract(m64, x0, 0.01 * T(B, 2 * n))
                      for _ in range(H)], 1)
    Un = T(B, H, n)
    pd = torch.cat([400.0 * torch.eye(n), 40.0 * torch.eye(n)], 1).to(
        device=m64.device, dtype=torch.float64)
    Kf = -(torch.linalg.inv(minv(m64, x0[:, :m64.nq]))[:, None] @ pd).expand(
        B, H, n, 2 * n).contiguous()
    kf = -(Kf @ state_diff(m64, x0[:, None], Xn)[..., None])[..., 0]
    xs = state_retract(m64, x0, 0.02 * T(B, 2 * n))
    return (xs, Xn.contiguous(), Un, kf.contiguous(), Kf)


@pytest.mark.parametrize("B,H", [(1, 1), (37, 1), (37, 8)])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_feedback_rollout(card, name, dtype, clip, B, H):
    """K2 on the quaternion root: the gains (nv x 2 nv) act on the tangent
    difference, whose root rows are the quaternion log; nominals near the
    start, stabilising gains -M(q0) [400 I, 40 I], with and without a clamp
    at 0.8 of the largest unclamped control."""
    m64 = _quat(name, torch.float64)
    args64 = _quat_line_search(m64, B, H)
    kw = {}
    if clip:
        applied = fused.feedback_rollout_plain(m64, *args64, DT)[1]
        kw["u_clip"] = (0.8 * applied.abs().amax(dim=(0, 1))).contiguous()
    m = _quat(name, dtype)
    args = tuple(a.to(dtype) for a in args64)
    kw = {k: v.to(dtype) for k, v in kw.items()}
    got = _launched("feedback_rollout",
                    lambda: feedback_rollout_fused(m, *args, DT, **kw))
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in zip(got, fused.feedback_rollout_plain(m, *args, DT, **kw)):
        _close(a, b, tol)


@pytest.mark.parametrize("B", [1, 37, 70])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_linearize_parts(card, name, dtype, B):
    """K3 on the quaternion root: M^-1, dc/dq with the root's tangent
    columns, dc/dqd and qdd against the plain version."""
    m = _quat(name, dtype)
    x, u = _quat_states(m, B, seed=24)
    q, qd = x[:, :m.nq].contiguous(), x[:, m.nq:].contiguous()
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    got = _launched("linearize_parts",
                    lambda: linearize_parts_fused(m, q, qd, u))
    for a, b in zip(got, colvec.linearize_parts_plain(m, q, qd, u)):
        _close(a, b, tol)


@pytest.mark.parametrize("B", [1, 37, 512, 2049])
@pytest.mark.parametrize("gn", [True, False], ids=["ee_gn", "ee_err"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_ee_gn(card, name, dtype, gn, B):
    """K4 on the quaternion root: the humanoid's left wrist (path H's end
    effector) and a quadruped foot's fixed frame, the root's body-twist
    columns, against ``ee_gn_plain``."""
    m = _quat(name, dtype)
    ee = (("left_arm_wrist_roll",) if name == "humanoid30"
          else ("RL_foot_fixed",))
    q = _quat_states(m, B, seed=25)[0][:, :m.nq].contiguous()
    target = (0.35, 0.25, 1.1)
    got = _launched("ee_gn" if gn else "ee_err",
                    lambda: ee_gn_fused(m, q, target, ee_names=ee, gn=gn))
    want = fk_lane.ee_gn_plain(m, q, target, ee_names=ee, gn=gn)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for a, b in zip(got, want):
        if b is not None:
            _close(a, b, tol)


@pytest.mark.parametrize("path", ["hybrid", "ee"])
def test_quat_paths_match_plain(card, path):
    """Paths G and H cut to B = 2, H = 8, 2 iterations in float64: the
    kernels (K1-K4 at fq32) against the plain route on the card, |dU|
    < 1e-6; then the hybrid's DDP stage under a trunk push (K1 and K2 with
    wrenches at fq32) against the plain route likewise."""
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import (
        DDPConfig, MPPIConfig, ddp_solve, ee_reaching_cost, hybrid_solve,
        quadratic_tracking_cost,
    )

    m = _quat("humanoid30", torch.float64)
    x0, _ = _quat_states(m, 2, seed=26)
    x0[:, m.nq:] = 0.0
    z = torch.zeros(2, m.nv, dtype=m.dtype, device=card)
    U0 = rnea(m, x0[:, :m.nq], z, z)[0][:, None].expand(2, 8, m.nv)
    U0 = U0.contiguous()
    goal = torch.zeros(m.nx, dtype=m.dtype)
    goal[2], goal[3] = 0.95, 1.0
    noise = torch.tensor(np.random.default_rng(27).standard_normal(
        (2, 2, 8, 8, m.nv)), device=card)
    out = {}
    for fused_ in (True, False):
        cfg = DDPConfig(iters=2, n_alphas=4, fused=fused_)
        if path == "hybrid":
            cost = quadratic_tracking_cost(m, goal, w_q=2.0, w_qd=0.05,
                                           w_u=1e-5)
            st, _ = hybrid_solve(m, cost, x0, U0, None,
                                 MPPIConfig(n_samples=8, sigma=0.3,
                                            fused=fused_), cfg, mppi_iters=2,
                                 noise=noise)
        else:
            cost = ee_reaching_cost(m, (0.35, 0.25, 1.1),
                                    ee_names=("left_arm_wrist_roll",),
                                    fused=None if fused_ else False,
                                    w_ee=10.0, w_ee_f=500.0, w_qd=1e-2,
                                    w_u=1e-5)
            st, _ = ddp_solve(m, cost, x0, U0, cfg)
        out[fused_] = st.U
    assert (out[True] - out[False]).abs().max().item() < 1e-6
    if path == "hybrid":
        fe = torch.zeros(8, m.nb, 6, dtype=m.dtype, device=card)
        fe[2:5, 0, 4] = 40.0
        out = {}
        for fused_ in (True, False):
            before = _lib.launches["feedback_rollout_fext"]
            st, _ = ddp_solve(m, cost, x0, U0, DDPConfig(
                iters=2, n_alphas=4, fused=fused_), f_ext=fe)
            torch.cuda.synchronize()
            assert _lib.launches["feedback_rollout_fext"] - before == (
                2 if fused_ else 0)
            out[fused_] = st.U
        assert (out[True] - out[False]).abs().max().item() < 1e-6


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("nchunks", [1, 2, 3, 100])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_feedback_chunked(card, name, dtype, nchunks, B):
    """K9 on the quaternion root ("fq32") against its plain version over 8
    knots: the chunks split the 2 nv tangent columns (100 chunks: one a
    column), the root's rows of dx are the quaternion log."""
    m64 = _quat(name, torch.float64)
    args = tuple(a.to(dtype) for a in _quat_line_search(m64, B, 8))
    m = _quat(name, dtype)
    got = _launched("feedback_chunked", lambda: feedback_rollout_fused_chunked(
        m, *args, DT, nchunks=nchunks))
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in zip(got, fused.feedback_rollout_chunked_plain(
            m, *args, DT, nchunks=nchunks)):
        _close(a, b, tol)


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("kernel", ["feedback_rollout_fext",
                                    "feedback_chunked_fext"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_feedback_fext(card, name, dtype, kernel, B):
    """K2 and K9 (two chunks) with wrenches on the quaternion root against
    their plain versions over 8 knots under a per-knot (H, nb, 6) set: 0.5
    N(0,1) on every body and a 40 N push along +y on the trunk for knots
    2-4."""
    m64 = _quat(name, torch.float64)
    args = tuple(a.to(dtype) for a in _quat_line_search(m64, B, 8))
    m = _quat(name, dtype)
    F = torch.tensor(0.5 * np.random.default_rng(24).standard_normal(
        (8, m.nb, 6)), dtype=dtype, device=card)
    F[2:5, 0, 4] += 40.0
    if kernel == "feedback_rollout_fext":
        kern, plain, kw = (feedback_rollout_fused,
                           fused.feedback_rollout_plain, {})
    else:
        kern, plain, kw = (feedback_rollout_fused_chunked,
                           fused.feedback_rollout_chunked_plain,
                           {"nchunks": 2})
    got = _launched(kernel, lambda: kern(m, *args, DT, f_ext=F, **kw))
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in zip(got, plain(m, *args, DT, f_ext=F, **kw)):
        _close(a, b, tol)


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("with_qdd", [True, False], ids=["qdd", "bias"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_rnea(card, name, dtype, with_qdd, B):
    """K10 on the quaternion root (q one value wider) against its plain
    version, with and without qdd."""
    m = _quat(name, dtype)
    x, qdd = _quat_states(m, B, seed=28)
    q, qd = x[:, :m.nq].contiguous(), x[:, m.nq:].contiguous()
    a = qdd if with_qdd else None
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    _close(_launched("rnea", lambda: rnea_fused(m, q, qd, a)),
           fused.rnea_plain(m, q, qd, a), tol)


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("wrench", ["free", "shared", "batched"])
@pytest.mark.parametrize("dense", [False, True], ids=["fact", "dense"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", QUAT_MODELS)
def test_quat_fd_step_minv(card, name, dtype, dense, wrench, B):
    """K6 on the quaternion root against its plain version on both routes
    (the manifold Euler step after M^-1), without wrenches and under 10
    N(0,1) wrenches, one set shared by the batch or one an element."""
    m = _quat(name, dtype)
    x, u = _quat_states(m, B, seed=29)
    fe = torch.tensor(10.0 * np.random.default_rng(30).standard_normal(
        ((B,) if wrench == "batched" else ()) + (m.nb, 6)), dtype=dtype,
        device=card)
    fe = None if wrench == "free" else fe
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    _close(_launched("fd_step_minv", lambda: fd_step_minv_fused(
        m, x, u, DT, dense_minv=dense, f_ext=fe)),
        fused.fd_step_minv_plain(m, x, u, DT, f_ext=fe), tol)


SECOND_ORDER_MODELS = {
    "arm7": lambda: load_asset("arm7", device="cuda", dtype=torch.float64),
    "quad_rpy": lambda: load_asset("quadruped12", device="cuda",
                                   dtype=torch.float64, floating_base=True),
    "quad_quat": lambda: _quat("quadruped12", torch.float64),
}


@pytest.mark.parametrize("name", list(SECOND_ORDER_MODELS))
def test_idsva_native_matches_ad(card, name):
    """IDSVA-SO on the card in float64: the native sweep against
    forward-mode AD on every root, max |native - AD| <= 1e-9."""
    from rbdtpu_torch.dynamics import idsva_so_ad, idsva_so_native

    m = SECOND_ORDER_MODELS[name]()
    rng = np.random.default_rng(28)
    q = rng.uniform(-1.0, 1.0, (3, m.nq))
    if m.root_quat:
        r = rng.standard_normal((3, 4))
        q[:, 3:7] = r / np.linalg.norm(r, axis=-1, keepdims=True)
    args = [torch.tensor(a, device=card) for a in (
        q, rng.uniform(-1, 1, (3, m.nv)), rng.uniform(-1, 1, (3, m.nv)))]
    for a, b in zip(idsva_so_native(m, *args), idsva_so_ad(m, *args)):
        assert a.is_cuda and a.shape == (3, m.nv, m.nv, m.nv)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9)


def test_full_ddp_matches_plain(card):
    """Path I (exact-Hessian DDP on the rpy quadruped) cut to B = 2, H = 8,
    3 iterations in float64: the kernels (K1, K2, K3, each launched)
    against the plain route on the card, |dU| < 1e-6, J nonincreasing."""
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import (
        DDPConfig, ddp_solve, quadratic_tracking_cost,
    )

    m = load_asset("quadruped12", device="cuda", dtype=torch.float64,
                   floating_base=True)
    rng = np.random.default_rng(29)
    q0 = np.zeros((2, m.nq))
    q0[:, 2] = 0.35
    q0 = torch.tensor(q0 + 0.05 * rng.standard_normal(q0.shape), device=card)
    z = torch.zeros(2, m.nv, dtype=m.dtype, device=card)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(m, q0, z, z)[0][:, None].expand(2, 8, m.nv).contiguous()
    goal = np.zeros(m.nx)
    goal[2] = 0.4
    cost = quadratic_tracking_cost(m, goal, w_q=2.0, w_qd=0.05, w_u=1e-5)
    out = {}
    for fused_ in (True, False):
        before = dict(_lib.launches)
        st, hist = ddp_solve(m, cost, x0, U0, DDPConfig(
            iters=3, n_alphas=6, fused=fused_, exact_hessians=True))
        torch.cuda.synchronize()
        ran = {k: _lib.launches[k] - before[k] for k in before}
        for k in ("fd_step", "feedback_rollout", "linearize_parts"):
            assert (ran[k] > 0) == fused_, (k, ran[k])
        assert hist.isfinite().all() and (hist[1:] <= hist[:-1]).all()
        out[fused_] = st.U
    assert (out[True] - out[False]).abs().max().item() < 1e-6


# ---- K5 on the floating roots and K4 at fb32 (paths L and M) ----

ROOT_MODELS = {"quad_rpy": ("quadruped12", False),
               "humanoid_rpy": ("humanoid30", False),
               "humanoid_quat": ("humanoid30", True)}


def _root_start(m, B, seed=31):
    """B floating-root states at rest, standing (q[2] = 0.9, the quaternion
    the identity) moved by 0.05 N(0,1) in the tangent, with velocities
    0.3 N(0,1)."""
    from rbdtpu_torch.solver import state_retract

    rng = np.random.default_rng(seed)
    x = torch.zeros(B, m.nx, dtype=m.dtype, device=m.device)
    x[:, 2] = 0.9
    if m.root_quat:
        x[:, 3] = 1.0
    return state_retract(m, x, torch.tensor(
        np.concatenate([0.05 * rng.standard_normal((B, m.nv)),
                        0.3 * rng.standard_normal((B, m.nv))], -1),
        dtype=m.dtype, device=m.device))


@pytest.mark.parametrize("B,H", [(1, 1), (37, 8), (512, 50)])
@pytest.mark.parametrize("wrench", [False, True], ids=["free", "fext"])
@pytest.mark.parametrize("route", ["aba", "minv"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(ROOT_MODELS))
def test_rollout_multi_roots(card, name, dtype, route, wrench, B, H):
    """K5 at the floating roots' classes (fb16, fb32, fq32) in one launch
    against ``rollout_multi_plain``, both routes, with and without per-step
    wrenches, from a standing start under hold controls plus 0.2 N(0,1):
    float64 1e-9 absolute, float32 1e-3 relative (50 open-loop steps);
    zero wrenches give the wrench-free kernel's result bit for bit.  The
    wrenches are 0.5 N(0,1) on every body (5 N(0,1) over one step), and
    over 50 steps path L's 80 N trunk push (through the trunk's start
    height) over 0.05 N(0,1): under 0.5 N(0,1) for 50 steps, or a push
    through the world origin, the open-loop humanoid spins the plain
    route itself to inf."""
    from rbdtpu_torch.dynamics import rnea

    asset, quat = ROOT_MODELS[name]
    m = load_asset(asset, device=card, dtype=dtype, floating_base=True,
                   root_quat=quat)
    x0 = _root_start(m, B)
    q0, z = x0[:, :m.nq], torch.zeros(B, m.nv, dtype=dtype, device=card)
    (noise, F) = _inputs(m, (H, B, m.nv), (H, m.nb, 6))
    U = (rnea(m, q0, z, z)[0][None] + 0.4 * noise).contiguous()
    if H == 1:
        F = 10.0 * F
    elif H == 50:
        F = 0.1 * F
        F[5:15, 0, 4] += 80.0
        F[5:15, 0, 0] -= 0.9 * 80.0
    F = F if wrench else None
    out = _launched("rollout_multi", lambda: rollout_fused_multi(
        m, x0, U, DT, route=route, f_ext=F))
    want = fused.rollout_multi_plain(m, x0, U, DT, route=route, f_ext=F)
    assert bool(want.isfinite().all())
    _close(out, want, 1e-9 if dtype == torch.float64 else 1e-3)
    if wrench:
        zero = rollout_fused_multi(m, x0, U, DT, route=route,
                                   f_ext=torch.zeros_like(F))
        free = rollout_fused_multi(m, x0, U, DT, route=route)
        assert torch.equal(zero, free)


@pytest.mark.parametrize("B", [1, 16, 512, 2048])
@pytest.mark.parametrize("gn", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_ee_gn_fb32(card, dtype, gn, B):
    """K4 at the rpy humanoid's class (fb32) against ``ee_gn_plain`` at the
    left wrist, at one state, path M's 16 terminal states, 512 knots and
    2,048 line-search states: float64 1e-9, float32 1e-4 relative."""
    m = _humanoid(dtype)
    (q,) = _inputs(m, (B, m.nq), scale=0.5)
    ee = ("left_arm_wrist_roll",)
    out = _launched("ee_gn" if gn else "ee_err", lambda: ee_gn_fused(
        m, q, (0.35, 0.25, 1.1), ee_names=ee, gn=gn))
    assert _lib.class_launches["ee_gn" if gn else "ee_err", "fb32"] > 0
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for a, b in zip(out, fk_lane.ee_gn_plain(m, q, (0.35, 0.25, 1.1),
                                             ee_names=ee, gn=gn)):
        if b is None:
            assert a is None
        else:
            _close(a, b, tol)


@pytest.mark.parametrize("barrier", [False, True], ids=["ee", "barrier"])
def test_path_m_kernels_match_plain(card, barrier):
    """Path M cut to Bm = 2, H = 8, 3 iterations, float64: the rpy
    humanoid's hand-reaching DDP (left wrist, bench.py:640-672's weights)
    through the kernels (K4 at fb32 among them) against the plain route;
    with ``add_limit_barrier`` around the cost too, from a start with the
    left shoulder pitch above its position limit, the elbow below its own
    and the wrist pitch past its velocity limit, whose hinges must still
    be active after the first knot: |dU| < 1e-6."""
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import (
        DDPConfig, add_limit_barrier, ddp_solve, ee_reaching_cost,
    )

    m = _humanoid(torch.float64)
    rng = np.random.default_rng(41)
    q0 = np.zeros((2, m.nq))
    q0[:, 2] = 0.9
    q0 = torch.tensor(q0 + 0.02 * rng.standard_normal(q0.shape),
                      dtype=m.dtype, device=card)
    z = torch.zeros(2, m.nv, dtype=m.dtype, device=card)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(m, q0, z, z)[0][:, None].expand(2, 8, m.nv).contiguous()
    lo, hi = m.q_limit_vectors()
    qd_lim = m.qd_limit_vector()
    if barrier:
        i, j, k = (m.q_index(m.body_names.index(f"left_arm_{n}_link"))
                   for n in ("shoulder_pitch", "elbow", "wrist_pitch"))
        x0[:, i], x0[:, j] = hi[i] + 0.05, lo[j] - 0.05
        x0[:, m.nq + k] = qd_lim[k] + 0.5
    us = []
    for kernels in (True, False):
        cost = ee_reaching_cost(m, (0.35, 0.25, 1.1),
                                ee_names=("left_arm_wrist_roll",),
                                fused=None if kernels else False, w_ee=10.0,
                                w_ee_f=500.0, w_qd=1e-2, w_u=1e-5)
        if barrier:
            cost = add_limit_barrier(m, cost)
        before = dict(_lib.class_launches)
        state, _ = ddp_solve(m, cost, x0, U0, DDPConfig(
            iters=3, dt=DT, n_alphas=4, fused=kernels))
        torch.cuda.synchronize()
        if kernels:
            assert _lib.class_launches["ee_gn", "fb32"] > before.get(
                ("ee_gn", "fb32"), 0)
        if barrier:
            q, qd = state.X[:, 1:, :m.nq], state.X[:, 1:, m.nq:]
            assert bool(((q > hi) | (q < lo) | (qd.abs() > qd_lim)).any())
        us.append(state.U)
    assert (us[0] - us[1]).abs().max().item() < 1e-6


# ---- path N: distrib, compat and the examples on the card ----

def test_quat_identity_defaults_to_the_card(card):
    from rbdtpu_torch.spatial import quat_identity

    assert quat_identity().device.type == "cuda"


@pytest.mark.parametrize("tag", ["arm7", "quad", "hum_q"])
def test_compat_on_the_card_matches_the_cpu(card, tag):
    """Every call of the compat mirror
    (``rbdtpu_torch.oracle.compat_calls.calls``) with the model on the
    card against the CPU, float64: <= 1e-9 relative to the value's scale;
    refusals alike."""
    from rbdtpu_torch.compat import RBDReferenceTorch
    from rbdtpu_torch.oracle.compat_calls import MODELS, calls, state

    name, kw = MODELS[tag]
    m = load_asset(name, device="cpu", dtype=torch.float64, **kw)
    s = state(tag, m.nq, m.nv, m.nb)
    gpu = RBDReferenceTorch(m, device=card)
    assert gpu.model.device.type == "cuda"
    cpu = dict(calls(RBDReferenceTorch(m), tag, s))
    for call, fn in calls(gpu, tag, s):
        try:
            want = cpu[call]()
        except ValueError:
            with pytest.raises(ValueError):
                fn()
            continue
        for got, ref in zip(fn(), want):
            _close(torch.tensor(got), torch.tensor(ref), 1e-9)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_ddp_world_one_over_nccl(card, monkeypatch):
    """``make_mesh`` from the torchrun environment on the card takes NCCL;
    configs[2]'s EE reaching cut to Bm = 8, H = 20, 3 iterations, float32,
    ``fused=True``: the sharded solve launches K1-K4 and equals the
    unsharded ``ddp_solve`` bit for bit."""
    import torch.distributed as dist
    from rbdtpu_torch.distrib import make_mesh, sharded_ddp_solve
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import DDPConfig, ddp_solve, ee_reaching_cost

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    mesh = make_mesh()
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        m = load_asset("arm7", device=mesh.device, dtype=torch.float32)
        rng = np.random.default_rng(61)
        q0 = torch.tensor(0.3 * rng.standard_normal((8, m.nq)),
                          dtype=m.dtype, device=card)
        z = torch.zeros_like(q0)
        U0 = rnea(m, q0, z, z)[0][:, None].expand(8, 20, m.nv).contiguous()
        x0 = torch.cat([q0, z], -1)
        cost = ee_reaching_cost(m, TARGET, w_ee=10.0, w_ee_f=2000.0,
                                w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)
        cfg = DDPConfig(iters=3, dt=DT, n_alphas=8, fused=True)
        _lib.reset_launches()
        J, U, mean_J = sharded_ddp_solve(mesh, m, cost, x0, U0, cfg)
        torch.cuda.synchronize()
        for k in ("fd_step", "feedback_rollout", "linearize_parts", "ee_gn",
                  "ee_err"):
            assert _lib.launches[k] > 0, k
        state, _ = ddp_solve(m, cost, x0, U0, cfg)
        assert torch.equal(J, state.J) and torch.equal(U, state.U)
        assert abs(mean_J.item() - state.J.mean().item()) <= 1e-5 * abs(
            state.J.mean().item())
    finally:
        dist.destroy_process_group()


def _run(args, timeout=600):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-m", *args], cwd=repo,
                          capture_output=True, text=True, timeout=timeout)


def test_launch_two_gloo_ranks_share_the_card(card):
    """``python -m rbdtpu_torch.distrib.launch`` with two ranks on one card
    over gloo: the self-check (arm7, float64, the batch over ("host",
    "batch")) passes on both ranks."""
    out = _run(["rbdtpu_torch.distrib.launch", "--num-processes", "2",
                "--backend", "gloo", "--device", "cuda"])
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert '"multihost": "ok"' in out.stdout
    assert '"device": "cuda:0"' in out.stdout


def test_sharded_fleet_example_on_the_card(card):
    """The sharded-fleet example through the launcher, two ranks sharing
    the card over gloo, at a small fan: its own check (|dJ| < 1e-5)
    passes."""
    out = _run(["rbdtpu_torch.examples.sharded_fleet", "--backend", "gloo",
                "--per-rank", "4", "--horizon", "10", "--iters", "2"])
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "OK" in out.stdout.splitlines()


def test_mpc_reaching_example_on_the_card(card):
    """The MPC reaching example at a small size: the solve lowers the
    cost and the loop approaches the target (its own checks)."""
    from rbdtpu_torch.examples import mpc_reaching

    assert mpc_reaching.main(["--batch", "4", "--horizon", "20", "--iters",
                              "3", "--ticks", "3"]) == 0


# ---- the model-specialised kernels (K0, ``specialize=True``) ----
STATIC_MODELS = {"arm7": ("arm7", False), "quad_rpy": ("quadruped12", True)}


@pytest.fixture(scope="module")
def static_models(card):
    """(name, dtype) -> model, every specialised library built in one
    parallel build."""
    models = {(n, dt): load_asset(a, device=card, dtype=dt, floating_base=fb)
              for n, (a, fb) in STATIC_MODELS.items() for dt in DTYPES}
    _lib.prepare_static([(m, dt) for (_, dt), m in models.items()])
    return models


def _static_launched(name, fn):
    """fn()'s result, after requiring that it launched ``name`` once and no
    other kernel."""
    before = dict(_lib.launches)
    out = fn()
    torch.cuda.synchronize()
    moved = {k: _lib.launches[k] - before[k] for k in before
             if _lib.launches[k] != before[k]}
    assert moved == {name: 1}, moved
    return out


def _static_tol(dtype, steps: int = 1):
    return 1e-9 if dtype == torch.float64 else (1e-4 if steps == 1 else 1e-3)


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATIC_MODELS))
def test_static_rnea(static_models, name, dtype, B):
    """``rnea_static`` (bias and with qdd) against its plain lane version
    and the table kernel K10 on the same inputs."""
    m, tol = static_models[name, dtype], _static_tol(dtype)
    q, qd, qdd = _inputs(m, (B, m.nq), (B, m.nv), (B, m.nv))
    for acc in (None, qdd):
        out = _static_launched("rnea_static", lambda: rnea_fused(
            m, q, qd, acc, specialize=True))
        _close(out, fused.rnea_static_plain(m, q, qd, acc), tol)
        _close(out, rnea_fused(m, q, qd, acc), tol)


@pytest.mark.parametrize("wrench", ["free", "shared", "batched"])
@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATIC_MODELS))
def test_static_fd_step(static_models, name, dtype, B, wrench):
    """``fd_step_static`` (K1), bare or under (nb, 6) / (B, nb, 6)
    wrenches, against its plain lane version and the table K1."""
    m, tol = static_models[name, dtype], _static_tol(dtype)
    x, u, F1, FB = _inputs(m, (B, m.nx), (B, m.nv), (m.nb, 6),
                           (B, m.nb, 6))
    F = {"free": None, "shared": F1, "batched": FB}[wrench]
    out = _static_launched("fd_step_static", lambda: fd_step_fused(
        m, x, u, DT, f_ext=F, specialize=True))
    _close(out, fused.fd_step_static_plain(m, x, u, DT, f_ext=F), tol)
    _close(out, fd_step_fused(m, x, u, DT, f_ext=F), tol)


@pytest.mark.parametrize("wrench", ["free", "shared", "batched"])
@pytest.mark.parametrize("dense", [False, True], ids=["fact", "dense"])
@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATIC_MODELS))
def test_static_fd_step_minv(static_models, name, dtype, B, dense, wrench):
    """``fd_step_minv_static`` (K6) on both routes, bare or under wrenches,
    against its plain lane version and the table K6."""
    m, tol = static_models[name, dtype], _static_tol(dtype)
    x, u, F1, FB = _inputs(m, (B, m.nx), (B, m.nv), (m.nb, 6),
                           (B, m.nb, 6))
    F = {"free": None, "shared": F1, "batched": FB}[wrench]
    out = _static_launched("fd_step_minv_static", lambda: fd_step_minv_fused(
        m, x, u, DT, dense_minv=dense, f_ext=F, specialize=True))
    _close(out, fused.fd_step_static_plain(m, x, u, DT, f_ext=F,
                                           route="minv", dense_minv=dense),
           tol)
    _close(out, fd_step_minv_fused(m, x, u, DT, dense_minv=dense, f_ext=F),
           tol)


@pytest.mark.parametrize("B,H", [(1, 1), (37, 8), (512, 50)])
@pytest.mark.parametrize("wrench", [False, True], ids=["free", "fext"])
@pytest.mark.parametrize("route", ["aba", "minv"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATIC_MODELS))
def test_static_rollout(static_models, name, dtype, route, wrench, B, H):
    """``rollout_multi_static`` (K5) in one launch against its plain lane
    rollout and the table K5, both routes, with and without (H, nb, 6)
    wrenches of 0.5 N(0,1): arm7 from x0 = 0.1 N(0,1) under 0.2 N(0,1)
    controls, the quadruped from a standing start under hold controls plus
    0.4 N(0,1); float64 1e-9 absolute, float32 1e-3 relative over more than
    one step."""
    from rbdtpu_torch.dynamics import rnea

    m = static_models[name, dtype]
    noise, F = _inputs(m, (H, B, m.nv), (H, m.nb, 6))
    if m.floating_base:
        x0 = _root_start(m, B)
        z = torch.zeros(B, m.nv, dtype=dtype, device=m.device)
        U = (rnea(m, x0[:, :m.nq], z, z)[0][None] + 0.8 * noise).contiguous()
    else:
        (x0,) = _inputs(m, (B, m.nx), scale=0.1)
        U = (0.4 * noise).contiguous()
    F = F if wrench else None
    out = _static_launched("rollout_multi_static", lambda: rollout_fused_multi(
        m, x0, U, DT, route=route, f_ext=F, specialize=True))
    want = fused.rollout_static_plain(m, x0, U, DT, route=route, f_ext=F)
    assert bool(want.isfinite().all())
    tol = _static_tol(dtype, H)
    _close(out, want, tol)
    _close(out, rollout_fused_multi(m, x0, U, DT, route=route, f_ext=F), tol)


def test_static_refuses_another_dtype(static_models):
    """The specialised kernels take float32 and float64 only, and raise on
    any other dtype, as the table kernels do."""
    m = static_models["arm7", torch.float32]
    x = torch.zeros(4, m.nx, dtype=torch.float16, device=m.device)
    with pytest.raises(ValueError):
        fd_step_fused(m, x, x[:, :m.nv].contiguous(), DT, specialize=True)


# ---- the solver's kernels specialised (K2·K0, K3·K0, K4·K0) ----
STATIC_EE = {"arm7": None, "quad_rpy": ("FL_knee",)}


@pytest.fixture(scope="module")
def static_solver_models(static_models):
    """static_models with every effector library built too, in one
    parallel build."""
    _lib.prepare_static([], ees=[
        (m, dt, *fk_lane._single_ee(m, STATIC_EE[n]))
        for (n, dt), m in static_models.items()])
    return static_models


@pytest.mark.parametrize("variant", ["free", "clip", "clip_fext"])
@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATIC_MODELS))
def test_static_feedback_rollout(static_solver_models, name, dtype, B,
                                 variant):
    """``feedback_rollout_static`` (K2·K0) over 8 knots of
    ``_closed_loop``'s line search against its plain lane version and the
    table K2, bare, with a clamp at 0.8 of each joint's largest unclamped
    control (1 N m at least), and with that clamp under (H, nb, 6)
    wrenches of 0.5 N(0,1)."""
    m, H = static_solver_models[name, dtype], 8
    args = _closed_loop(m, B, H)
    kw = {}
    if variant != "free":
        applied = feedback_rollout_fused(m, *args, DT)[1]
        kw["u_clip"] = (0.8 * applied.abs().amax((0, 1))).clamp(min=1.0)
    if variant == "clip_fext":
        (kw["f_ext"],) = _inputs(m, (H, m.nb, 6))
    out = _static_launched("feedback_rollout_static",
                           lambda: feedback_rollout_fused(
                               m, *args, DT, specialize=True, **kw))
    tol = _static_tol(dtype, H)
    for want in (fused.feedback_rollout_static_plain(m, *args, DT, **kw),
                 feedback_rollout_fused(m, *args, DT, **kw)):
        for a, b in zip(out, want):
            _close(a, b, tol)


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATIC_MODELS))
def test_static_linearize(static_solver_models, name, dtype, B):
    """``linearize_parts_static`` (K3·K0, one thread a derivative column)
    against its plain lane version and the table K3: M^-1 symmetrised,
    dc/dq, dc/dqd and qdd."""
    m, tol = static_solver_models[name, dtype], _static_tol(dtype)
    q, qd, u = _inputs(m, (B, m.nq), (B, m.nv), (B, m.nv))
    if m.floating_base:
        q = _root_start(m, B)[:, :m.nq].contiguous()
    out = _static_launched("linearize_parts_static", lambda:
                           linearize_parts_fused(m, q, qd, u,
                                                 specialize=True))
    for want in (colvec.linearize_parts_static_plain(m, q, qd, u),
                 linearize_parts_fused(m, q, qd, u)):
        for a, b in zip(out, want):
            _close(a, b, tol)


@pytest.mark.parametrize("B", TEAM_BATCHES)
@pytest.mark.parametrize("gn", [True, False], ids=["gn", "err"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATIC_MODELS))
def test_static_ee(static_solver_models, name, dtype, gn, B):
    """``ee_gn_static`` / ``ee_err_static`` (K4·K0, the effector's own
    library) against their plain lane version and the table K4."""
    m, tol = static_solver_models[name, dtype], _static_tol(dtype)
    (q,) = _inputs(m, (B, m.nq))
    ee = STATIC_EE[name]
    out = _static_launched("ee_gn_static" if gn else "ee_err_static",
                           lambda: ee_gn_fused(m, q, TARGET, ee_names=ee,
                                               gn=gn, specialize=True))
    for want in (fk_lane.ee_gn_static_plain(m, q, TARGET, ee_names=ee,
                                            gn=gn),
                 ee_gn_fused(m, q, TARGET, ee_names=ee, gn=gn)):
        for a, b in zip(out, want):
            if b is None:
                assert a is None
            else:
                _close(a, b, tol)


def test_static_solve_launches_only_k0(static_solver_models):
    """configs[2]'s solve cut to 4 problems, H=8, 2 iterations, float32,
    with ``DDPConfig(fused=True, specialize=True)`` and
    ``ee_reaching_cost(specialize=True)``: K1·K0-K4·K0 launched, no table
    kernel of K1-K4, and the controls within 1e-3 (relative) of the table
    route's."""
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import DDPConfig, ddp_solve, ee_reaching_cost

    m = static_solver_models["arm7", torch.float32]
    (q0,) = _inputs(m, (4, m.nq), scale=0.3)
    z = torch.zeros_like(q0)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(m, q0, z, z)[0][:, None].expand(4, 8, m.nv).contiguous()
    runs = {}
    for spec in (True, False):
        cost = ee_reaching_cost(m, TARGET, specialize=spec)
        _lib.reset_launches()
        runs[spec] = ddp_solve(m, cost, x0, U0, DDPConfig(
            iters=2, fused=True, specialize=spec))[0]
        torch.cuda.synchronize()
        if spec:
            moved = {k for k, v in _lib.launches.items() if v}
            assert moved == {"fd_step_static", "feedback_rollout_static",
                             "linearize_parts_static", "ee_gn_static",
                             "ee_err_static"}, moved
    _close(runs[True].U, runs[False].U, 1e-3)
