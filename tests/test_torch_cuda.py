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
    # the rpy root reaches K1-K4 (K4 up to 16 bodies), K6, K9 and K10
    # (each launches its kernel) but not K5; the quaternion root no kernel
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
    with pytest.raises(NotImplementedError):
        rollout_fused_multi(fb, x, v[None], DT)
    hum = _humanoid(torch.float64)
    with pytest.raises(ValueError, match="31 bodies"):
        ee_gn_fused(hum, torch.zeros(8, hum.nq, dtype=torch.float64,
                                     device=card), TARGET,
                    ee_names=(hum.joint_names[hum.leaves()[0]],))
    quat = load_asset("quadruped12", device=card, dtype=torch.float64,
                      floating_base=True, root_quat=True)
    qq = torch.zeros(8, quat.nq, dtype=torch.float64, device=card)
    vq = torch.zeros(8, quat.nv, dtype=torch.float64, device=card)
    xq = torch.cat([qq, vq], -1)
    before = dict(_lib.launches)
    for refused in (lambda: rnea_fused(quat, qq, vq),
                    lambda: fd_step_minv_fused(quat, xq, vq, DT),
                    lambda: _lib.launch("linearize_parts", quat, qq, qq, vq,
                                        vq, vq, vq, vq, vq, 8, -9.81)):
        with pytest.raises(NotImplementedError):
            refused()
    assert _lib.launches == before


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
