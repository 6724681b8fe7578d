"""The model-specialised kernels' generator (``rbdtpu_torch.kernels.codegen``)
on the CPU: the generated sources, compiled with g++ as host C++ (each
kernel a loop over the states) and called through ctypes in float64, held
against the lane sweeps' plain versions on tensors at 1e-12 (the same
operations in the same order; g++ on x86-64 contracts no FMA here).  All
four kernels on arm7; K1, K6 (both routes) and K5 (H = 3) on the rpy and
the quaternion quadruped.  Also: a model whose data differ in one inertia
gets other sources and another build directory, and so does another
gravity; the new modules import neither JAX nor rbdtpu.  Skips without a host C++ compiler."""
import ast
import concurrent.futures
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rbdtpu_torch.kernels import _lib, codegen, fused
from rbdtpu_torch.model import load_asset, make_model

DT, GRAVITY, TOL = 0.01, -9.81, 1e-12
B, H = 5, 3
MODELS = {"arm7": ("arm7", {}),
          "quad_rpy": ("quadruped12", dict(floating_base=True)),
          "quad_quat": ("quadruped12", dict(floating_base=True,
                                            root_quat=True))}
CASES = [("arm7", "k10"), ("arm7", "k1"), ("arm7", "k6"), ("arm7", "k5"),
         ("quad_rpy", "k1"), ("quad_rpy", "k6"), ("quad_rpy", "k5"),
         ("quad_quat", "k1"), ("quad_quat", "k6"), ("quad_quat", "k5")]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compile(cxx: str, d: str, name: str):
    p = subprocess.run([cxx, "-O0", "-fPIC", "-x", "c++", "-c",
                        os.path.join(d, name), "-o",
                        os.path.join(d, name[:-3] + ".o")],
                       capture_output=True, text=True)
    return name, p.returncode, p.stderr


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """model key -> (model, host-built library of its float64 sources)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    root = tmp_path_factory.mktemp("codegen")
    built, jobs = {}, []
    for key, (asset, kw) in MODELS.items():
        m = load_asset(asset, device="cpu", dtype=torch.float64, **kw)
        d = os.path.join(root, key)
        os.makedirs(d)
        for name, text in codegen.generate(m, torch.float64,
                                           GRAVITY).sources.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
            jobs.append((d, name))
        built[key] = (m, d)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        runs = list(pool.map(lambda j: _compile(cxx, *j), jobs))
    failed = [f"{n}: {err}" for n, rc, err in runs if rc]
    assert not failed, "\n".join(failed)
    libs = {}
    for key, (m, d) in built.items():
        objs = sorted(os.path.join(d, n) for n in os.listdir(d)
                      if n.endswith(".o"))
        so = os.path.join(d, "lib.so")
        subprocess.run([cxx, "-shared", "-o", so, *objs], check=True)
        libs[key] = (m, _lib.bind_static(so, torch.float64))
    return libs


def _inputs(m, seed: int):
    rng = np.random.default_rng(seed)
    T = lambda s, *sh: torch.tensor(s * rng.standard_normal(sh))
    q = T(0.3, B, m.nq)
    if m.root_quat:
        q[:, 3:7] /= q[:, 3:7].norm(dim=1, keepdim=True)
    return dict(q=q, qd=T(0.5, B, m.nv), qdd=T(0.5, B, m.nv),
                u=T(1.0, B, m.nv), F1=T(0.5, m.nb, 6),
                FB=T(0.5, B, m.nb, 6), U=T(0.2, H, B, m.nv),
                FH=T(0.5, H, m.nb, 6))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("key,kernel", CASES)
def test_host_kernel_matches_lane_plain(host_libs, key, kernel):
    """The generated kernel, built for the host, equals its plain version
    (the same lane sweep on tensors) at 1e-12 on every variant: K10 bias
    and with qdd; K1 bare, under one (nb, 6) set and one set a state; K6 on
    both routes under each; K5 on both routes with and without (H, nb, 6)
    wrenches."""
    m, lib = host_libs[key]
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


def test_other_gravity_gets_its_own_library(host_libs):
    """Gravity is folded into the code: another gravity gives other
    sources and another build directory, which ``model_library`` keys by
    the gravity, with the same operations a state."""
    m, _ = host_libs["arm7"]
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
                                  "rbdtpu_torch/kernels/_lib.py"])
def test_module_imports_no_jax(path):
    """The specialised kernels' modules import neither jax nor rbdtpu."""
    with open(os.path.join(_ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if n.split(".")[0] in ("jax", "rbdtpu")]
