"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and the CUDA toolkit; skipped without a card.  The file
imports neither JAX nor rbdtpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from rbdtpu_torch.kernels import (
    _lib, colvec, ee_gn_fused, fd_step_fused, feedback_rollout_fused, fk_lane,
    fused, linearize_parts_fused,
)
from rbdtpu_torch.model import load_asset, parse_urdf

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
    name, dt = request.param
    build, ee = MODELS[name]
    return (build(device=card, dtype=dt), ee,
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


def test_fd_step(case):
    m, _, tol = case
    x, u = _inputs(m, (200, m.nx), (200, m.nv))
    out = _launched("fd_step", lambda: fd_step_fused(m, x, u, DT))
    _close(out, fused.fd_step_plain(m, x, u, DT), tol)


@pytest.mark.parametrize("clip", [False, True])
def test_feedback_rollout(case, clip):
    m, _, tol = case
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


def test_linearize_parts(case):
    m, _, tol = case
    q, qd, u = _inputs(m, (300, m.nv), (300, m.nv), (300, m.nv))
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
    fb = load_asset("quadruped12", device=card, dtype=torch.float64,
                    floating_base=True)
    q = torch.zeros(8, fb.nq, dtype=torch.float64, device=card)
    v = torch.zeros(8, fb.nv, dtype=torch.float64, device=card)
    with pytest.raises(NotImplementedError):
        linearize_parts_fused(fb, q, v, v)


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
