"""The model-specialised kernels' generator (``rbdtpu_torch.kernels.codegen``)
on the CPU: the generated sources, compiled with g++ as host C++ (each
kernel a loop over the states) and called through ctypes in float64, held
against the lane sweeps' plain versions on tensors at 1e-12 (the same
operations in the same order; g++ on x86-64 contracts no FMA here).  All
four kernels on arm7; K1, K6 (both routes) and K5 (H = 3) on the rpy and
the quaternion quadruped; the solver's K2, K3 and K4 (the effector's own
library) on all three.  A library is built when a test first calls it,
with at most JOBS g++ processes at once.  Also: a model whose data differ
in one inertia gets other sources and another build directory, and so
does another gravity; the new modules import neither JAX nor rbdtpu.
The host builds skip without a host C++ compiler."""
import ast
import concurrent.futures
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rbdtpu_torch.kernels import _lib, codegen, colvec, fk_lane, fused
from rbdtpu_torch.model import load_asset, make_model

DT, GRAVITY, TOL = 0.01, -9.81, 1e-12
B, H = 5, 3
MODELS = {"arm7": ("arm7", {}),
          "quad_rpy": ("quadruped12", dict(floating_base=True)),
          "quad_quat": ("quadruped12", dict(floating_base=True,
                                            root_quat=True))}
# each model's effector (None: the single leaf)
EFFECTORS = {"arm7": None, "quad_rpy": ("FL_knee",),
             "quad_quat": ("FL_knee",)}
CASES = [("arm7", "k10"), ("arm7", "k1"), ("arm7", "k6"), ("arm7", "k5"),
         ("quad_rpy", "k1"), ("quad_rpy", "k6"), ("quad_rpy", "k5"),
         ("quad_quat", "k1"), ("quad_quat", "k6"), ("quad_quat", "k5")]
SOLVER_CASES = [(key, k) for key in MODELS for k in ("k2", "k3", "k4")]
# g++ processes at once: the other test files' workers share the host
JOBS = 4
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compile(cxx: str, d: str, name: str):
    p = subprocess.run([cxx, "-O0", "-fPIC", "-x", "c++", "-c",
                        os.path.join(d, name), "-o",
                        os.path.join(d, name[:-3] + ".o")],
                       capture_output=True, text=True)
    return name, p.returncode, p.stderr


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """build(key, ee=False) -> (model, host-built library of its float64
    sources, or with ``ee`` of its effector's): a library is generated and
    compiled (JOBS g++ at once, then one link) when a test first asks for
    it, so a selection of the tests builds only the libraries it calls."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    root = tmp_path_factory.mktemp("codegen")
    models, libs = {}, {}

    def build(key: str, ee: bool = False):
        if (key, ee) in libs:
            return libs[key, ee]
        if key not in models:
            asset, kw = MODELS[key]
            models[key] = load_asset(asset, device="cpu",
                                     dtype=torch.float64, **kw)
        m = models[key]
        gen = (codegen.generate_ee(m, torch.float64, *fk_lane._single_ee(
            m, EFFECTORS[key])) if ee
            else codegen.generate(m, torch.float64, GRAVITY))
        d = os.path.join(root, key + ("_ee" if ee else ""))
        os.makedirs(d)
        for name, text in gen.sources.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        with concurrent.futures.ThreadPoolExecutor(JOBS) as pool:
            runs = list(pool.map(lambda n: _compile(cxx, d, n), gen.sources))
        failed = [f"{n}: {err}" for n, rc, err in runs if rc]
        assert not failed, "\n".join(failed)
        so = os.path.join(d, "lib.so")
        subprocess.run([cxx, "-shared", "-o", so,
                        *[os.path.join(d, n[:-3] + ".o") for n in gen.sources]],
                       check=True)
        libs[key, ee] = (m, _lib.bind_static(so, torch.float64, ee=ee))
        return libs[key, ee]

    return build


def _inputs(m, seed: int):
    rng = np.random.default_rng(seed)
    T = lambda s, *sh: torch.tensor(s * rng.standard_normal(sh))
    q = T(0.3, B, m.nq)
    if m.root_quat:
        q[:, 3:7] /= q[:, 3:7].norm(dim=1, keepdim=True)
    X_nom = torch.cat([q, T(0.1, B, m.nv)], 1)[:, None] + T(0.02, B, H, m.nx)
    if m.root_quat:
        X_nom[..., 3:7] /= X_nom[..., 3:7].norm(dim=-1, keepdim=True)
    return dict(q=q, qd=T(0.5, B, m.nv), qdd=T(0.5, B, m.nv),
                u=T(1.0, B, m.nv), F1=T(0.5, m.nb, 6),
                FB=T(0.5, B, m.nb, 6), U=T(0.2, H, B, m.nv),
                FH=T(0.5, H, m.nb, 6), X_nom=X_nom, U_nom=T(1.0, B, H, m.nv),
                k_ff=T(0.1, B, H, m.nv), K_fb=T(0.1, B, H, m.nv, 2 * m.nv),
                u_clip=torch.full((m.nv,), 0.6, dtype=torch.float64))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("key,kernel", CASES)
def test_host_kernel_matches_lane_plain(host_build, key, kernel):
    """The generated kernel, built for the host, equals its plain version
    (the same lane sweep on tensors) at 1e-12 on every variant: K10 bias
    and with qdd; K1 bare, under one (nb, 6) set and one set a state; K6 on
    both routes under each; K5 on both routes with and without (H, nb, 6)
    wrenches."""
    m, lib = host_build(key)
    inp = _inputs(m, CASES.index((key, kernel)))
    x = torch.cat([inp["q"], inp["qd"]], 1)
    wrenches = ((None, 0), (inp["F1"], 0), (inp["FB"], m.nb * 6))
    if kernel == "k10":
        for qdd in (None, inp["qdd"]):
            tau = torch.empty(B, m.nv, dtype=torch.float64)
            assert lib.rbd_rnea_static(_ptr(inp["q"]), _ptr(inp["qd"]),
                                       _ptr(qdd), _ptr(tau), B, 1,
                                       None) == 0
            _close(tau, fused.rnea_static_plain(m, inp["q"], inp["qd"], qdd,
                                                GRAVITY))
    elif kernel == "k1":
        for fe, stride in wrenches:
            xo = torch.empty_like(x)
            assert lib.rbd_fd_step_static(_ptr(x), _ptr(inp["u"]), _ptr(fe),
                                          stride, _ptr(xo), B, 1, DT,
                                          None) == 0
            _close(xo, fused.fd_step_static_plain(m, x, inp["u"], DT, GRAVITY,
                                                  fe))
    elif kernel == "k6":
        for dense in (0, 1):
            for fe, stride in wrenches:
                xo = torch.empty_like(x)
                assert lib.rbd_fd_step_minv_static(
                    _ptr(x), _ptr(inp["u"]), _ptr(fe), stride, _ptr(xo), B,
                    dense, 1, DT, None) == 0
                _close(xo, fused.fd_step_static_plain(
                    m, x, inp["u"], DT, GRAVITY, fe, "minv", bool(dense)))
    else:
        x0 = x.clone()
        x0[:, m.nq:] *= 0.2
        for minv in (0, 1):
            for fe in (None, inp["FH"]):
                xo = torch.empty_like(x0)
                assert lib.rbd_rollout_multi_static(
                    _ptr(x0), _ptr(inp["U"]), _ptr(fe), _ptr(xo), B, H, minv,
                    1, DT, None) == 0
                _close(xo, fused.rollout_static_plain(
                    m, x0, inp["U"], DT, GRAVITY, ("aba", "minv")[minv], fe))


@pytest.mark.parametrize("key,kernel", SOLVER_CASES)
def test_host_solver_kernel_matches_lane_plain(host_build, key, kernel):
    """The solver's generated kernels, built for the host, equal their
    plain lane versions at 1e-12: K2 (``rbd_feedback_rollout_static``)
    bare, with a clamp and with the clamp under (H, nb, 6) wrenches over H
    knots; K3 (``rbd_linearize_parts_static``, one column a thread, its
    M^-1 columns mirrored); K4 (``rbd_ee_gn_static``,
    ``rbd_ee_err_static``, the effector's own library) on its effector."""
    inp = _inputs(host_build(key)[0], 20 + SOLVER_CASES.index((key, kernel)))
    if kernel == "k4":
        m, lib = host_build(key, ee=True)
        target = (0.3, 0.1, 0.2)
        e, g0, H0 = fk_lane.ee_gn_static_plain(
            m, inp["q"], target, ee_names=EFFECTORS[key])
        out = [torch.empty_like(t) for t in (e, g0, H0)]
        assert lib.rbd_ee_gn_static(_ptr(inp["q"]), *target,
                                    *map(_ptr, out), B, 1, None) == 0
        for got, want in zip(out, (e, g0, H0)):
            _close(got, want)
        err = torch.empty_like(e)
        assert lib.rbd_ee_err_static(_ptr(inp["q"]), *target, _ptr(err), B,
                                     1, None) == 0
        _close(err, e)
        return
    m, lib = host_build(key)
    if kernel == "k3":
        want = colvec.linearize_parts_static_plain(m, inp["q"], inp["qd"],
                                                   inp["u"], GRAVITY)
        out = [torch.empty_like(t) for t in want]
        assert lib.rbd_linearize_parts_static(
            _ptr(inp["q"]), _ptr(inp["qd"]), _ptr(inp["u"]),
            *map(_ptr, out), B, 1, None) == 0
        for got, w in zip(out, want):
            _close(got, w)
        return
    x0 = torch.cat([inp["q"], 0.2 * inp["qd"]], 1)
    args = (x0, inp["X_nom"], inp["U_nom"], inp["k_ff"], inp["K_fb"])
    for uc, fe in ((None, None), (inp["u_clip"], None),
                   (inp["u_clip"], inp["FH"])):
        Xo, Uo = torch.empty_like(inp["X_nom"]), torch.empty_like(inp["U_nom"])
        assert lib.rbd_feedback_rollout_static(
            *map(_ptr, args), _ptr(fe), _ptr(uc), _ptr(Xo), _ptr(Uo), B, H,
            1, DT, None) == 0
        Xw, Uw = fused.feedback_rollout_static_plain(m, *args, DT, GRAVITY,
                                                     uc, fe)
        _close(Xo, Xw)
        _close(Uo, Uw)


def test_other_gravity_gets_its_own_library():
    """Gravity is folded into the code: another gravity gives other
    sources and another build directory, which ``model_library`` keys by
    the gravity, with the same operations a state."""
    m = load_asset("arm7", device="cpu", dtype=torch.float64)
    ga, gb = (codegen.generate(m, torch.float64, g) for g in (GRAVITY, -9.8))
    assert ga.sources != gb.sources
    assert _lib.static_dir(ga) != _lib.static_dir(gb)
    assert ga.ops == gb.ops


def test_one_inertia_apart_gets_its_own_library():
    """Two models that differ in one entry of one body's inertia give
    other sources and another build directory (the cache is keyed by the
    sources' hash, never by the model's name)."""
    a = load_asset("arm7", device="cpu", dtype=torch.float64)
    fields = {k: a.host_data[k].copy() for k in ("Xtree", "Ttree", "axis",
                                                 "S", "I", "T_fixed")}
    fields["I"][3, 0, 0] *= 1.01
    b = make_model(parent=a.parent, joint_type=a.joint_type,
                   damping=a.host_data["damping"], name=a.name,
                   device="cpu", dtype=torch.float64, **fields)
    ga, gb = (codegen.generate(m, torch.float64, GRAVITY) for m in (a, b))
    assert ga.sources != gb.sources
    assert _lib.static_dir(ga) != _lib.static_dir(gb)
    assert _lib.static_dir(ga) == _lib.static_dir(
        codegen.generate(a, torch.float64, GRAVITY))
    # the same tree and the same zeros: the same operations
    assert ga.ops == codegen.generate(b, torch.float64, GRAVITY).ops


@pytest.mark.parametrize("path", ["rbdtpu_torch/kernels/lanescalar.py",
                                  "rbdtpu_torch/kernels/codegen.py",
                                  "rbdtpu_torch/kernels/fused.py",
                                  "rbdtpu_torch/kernels/_lib.py",
                                  "rbdtpu_torch/kernels/colvec.py",
                                  "rbdtpu_torch/kernels/fk_lane.py"])
def test_module_imports_no_jax(path):
    """The specialised kernels' modules import neither jax nor rbdtpu."""
    with open(os.path.join(_ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if n.split(".")[0] in ("jax", "rbdtpu")]
