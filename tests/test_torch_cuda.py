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
# the kernels that also take the rpy floating root (K1-K3) run on these too
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


def test_fd_step(tree_case):
    m, _, tol = tree_case
    x, u = _inputs(m, (200, m.nx), (200, m.nv))
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


@pytest.mark.parametrize("with_qdd", [True, False], ids=["qdd", "bias"])
def test_rnea(case, with_qdd):
    m, _, tol = case
    q, qd, qdd = _inputs(m, (37, m.nq), (37, m.nv), (37, m.nv), scale=1.0)
    a = qdd if with_qdd else None
    out = _launched("rnea", lambda: rnea_fused(m, q, qd, a))
    _close(out, fused.rnea_plain(m, q, qd, a), tol)


@pytest.mark.parametrize("wrench", [False, True], ids=["free", "fext"])
@pytest.mark.parametrize("dense", [False, True], ids=["fact", "dense"])
def test_fd_step_minv(case, dense, wrench):
    m, _, tol = case
    x, u, fe = _inputs(m, (37, m.nx), (37, m.nv), (m.nb, 6))
    fe = 20.0 * fe if wrench else None
    out = _launched("fd_step_minv", lambda: fd_step_minv_fused(
        m, x, u, DT, dense_minv=dense, f_ext=fe))
    _close(out, fused.fd_step_minv_plain(m, x, u, DT, f_ext=fe), tol)


@pytest.mark.parametrize("wrench", [False, True], ids=["free", "fext"])
@pytest.mark.parametrize("route", ["aba", "minv"])
def test_rollout_multi_is_one_launch(case, route, wrench):
    """The whole horizon is one launch of rollout_multi and none of the
    step kernels; an odd batch needs no padding."""
    m, _, tol = case
    B, H = 37, 8
    x0, U, F = _inputs(m, (B, m.nx), (H, B, m.nv), (H, m.nb, 6))
    F = 20.0 * F if wrench else None
    before = dict(_lib.launches)
    out = rollout_fused_multi(m, x0, U, DT, route=route, f_ext=F)
    torch.cuda.synchronize()
    assert _lib.launches["rollout_multi"] == before["rollout_multi"] + 1
    for k in ("fd_step", "fd_step_minv"):
        assert _lib.launches[k] == before[k]
    _close(out, fused.rollout_multi_plain(m, x0, U, DT, route=route,
                                          f_ext=F), tol)


def test_entry_points_default_to_the_card(card):
    assert load_asset("arm7").device.type == "cuda"
    assert parse_urdf(mixed_tree_urdf()).device.type == "cuda"


@pytest.mark.parametrize("clip", [False, True])
def test_feedback_rollout(tree_case, clip):
    m, _, tol = tree_case
    B, H = 70, 8
    x0, Xn, Un, kf, Kf = _inputs(m, (B, m.nx), (B, H, m.nx), (B, H, m.nv),
                                 (B, H, m.nv), (B, H, m.nv, m.nx), scale=0.1)
    u_clip = torch.full((m.nv,), 0.05, dtype=m.dtype,
                        device=m.device) if clip else None
    X, U = _launched("feedback_rollout", lambda: feedback_rollout_fused(
        m, x0, Xn, Un, kf, Kf, DT, u_clip=u_clip))
    Xp, Up = fused.feedback_rollout_plain(m, x0, Xn, Un, kf, Kf, DT,
                                          u_clip=u_clip)
    _close(X, Xp, tol)
    _close(U, Up, tol)


def test_linearize_parts(tree_case):
    """On the rpy root the plain version fills the root-pose columns of
    dc/dq by forward-mode AD, the kernel analytically."""
    m, _, tol = tree_case
    q, qd, u = _inputs(m, (300, m.nq), (300, m.nv), (300, m.nv))
    out = _launched("linearize_parts",
                    lambda: linearize_parts_fused(m, q, qd, u))
    for a, b in zip(out, colvec.linearize_parts_plain(m, q, qd, u)):
        _close(a, b, tol)


@pytest.mark.parametrize("gn", [True, False])
def test_ee_gn(case, gn):
    m, ee, tol = case
    (q,) = _inputs(m, (500, m.nq), scale=1.0)
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
    # the rpy root reaches K1-K3 only; the quaternion root no kernel
    fb = load_asset("quadruped12", device=card, dtype=torch.float64,
                    floating_base=True)
    q = torch.zeros(8, fb.nq, dtype=torch.float64, device=card)
    v = torch.zeros(8, fb.nv, dtype=torch.float64, device=card)
    x = torch.cat([q, v], -1)
    for refused in (lambda: rnea_fused(fb, q, v),
                    lambda: fd_step_minv_fused(fb, x, v, DT),
                    lambda: rollout_fused_multi(fb, x, v[None], DT),
                    lambda: ee_gn_fused(fb, q, TARGET,
                                        ee_names=(fb.joint_names[3],))):
        with pytest.raises(NotImplementedError):
            refused()
    quat = load_asset("quadruped12", device=card, dtype=torch.float64,
                      floating_base=True, root_quat=True)
    qq = torch.zeros(8, quat.nq, dtype=torch.float64, device=card)
    vq = torch.zeros(8, quat.nv, dtype=torch.float64, device=card)
    with pytest.raises(NotImplementedError):
        _lib.launch("linearize_parts", quat, qq, qq, vq, vq, vq, vq, vq, vq,
                    8, -9.81)


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
    (128, 3, 36, 18, False), (3, 3, 72, 36, False)],
    ids=["small", "lane", "quad-small", "quad-lane", "humanoid"])
def test_riccati_chunked(card, B, H, nx, nu, const, dtype):
    """The sweep kernel against the plain sweep at both call sites, with
    constant and per-knot cost blocks, up to the humanoid's nx = 72 (above
    48 KB of shared memory in float64); float64 within 1e-9 relative to the
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
    (5, 7, 6, 3, True), (4, 5, 16, 16, False)],
    ids=["one-arm7", "three-constant", "lane-arm7", "small", "nx16"])
def test_riccati_fused(card, B, H, nx, nu, const, dtype):
    """The arm-class sweep kernel (K11) against the plain sweep, one launch
    a call, at any batch (warps past the batch in the last block return),
    with per-knot and constant cost blocks, up to nx = 16; float64 within
    1e-9 relative to the output's scale, float32 within 1e-3 (a sweep
    accumulates the reordered float32 sums of H knots)."""
    from rbdtpu_torch.solver.ddp import backward_pass

    args = _riccati(B, H, nx, nu, const, dtype, 2 * B + nx)
    out = _launched("riccati_fused", lambda: backward_pass_fused(*args))
    ref = backward_pass(*args)
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for a, b in zip(out[:3], ref[:3]):
        _close(a, b, tol)
    assert out[3].tolist() == ref[3].tolist() == [True] * B


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_humanoid_tree_kernels(card, dtype):
    """K1, K2 and K3 at the humanoid's size class (fb32, 31 bodies) against
    their plain versions: 1e-9 in float64, 1e-4 relative in float32 (1e-3
    for the 8-knot closed loop)."""
    m = _humanoid(dtype)
    assert _lib.size_class("fd_step", m) == "fb32"
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    fb, (x, u) = _humanoid_inputs(m, 70, 8)
    out = _launched("fd_step", lambda: fd_step_fused(m, x, u, DT))
    _close(out, fused.fd_step_plain(m, x, u, DT), tol)
    X, U = _launched("feedback_rollout",
                     lambda: feedback_rollout_fused(m, *fb, DT))
    Xp, Up = fused.feedback_rollout_plain(m, *fb, DT)
    _close(X, Xp, 10 * tol if dtype == torch.float32 else tol)
    _close(U, Up, 10 * tol if dtype == torch.float32 else tol)
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
    for cw, nc in ((7, 1), (7, 3), (0, 14), (14, 0)):
        with pytest.raises(RuntimeError, match="feedback_chunked"):
            _lib.launch("feedback_chunked", m, x0, x0, Xn, Un, kf, Kf, None,
                        Xo, Uo, B, H, cw, nc, DT, -9.81)


def test_stack_limit_round_trip(card):
    """The per-thread stack limit reads back what was set, K3 at the
    humanoid's size class (the largest stack frame, in double) stays right
    under a lowered limit, and the limit is set back afterwards."""
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
