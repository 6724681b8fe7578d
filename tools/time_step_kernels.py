#!/usr/bin/env python3
"""Time the step kernels K1 (``fd_step``) and K2 (``feedback_rollout``),
the chunked line search K9 (``feedback_chunked``), the linearisation K3
(``linearize_parts``), the end-effector terms K4 (``ee_gn``, ``ee_err``),
the whole-horizon rollout K5 (``rollout_multi``), the M^-1 + RNEA step K6
(``fd_step_minv``), RNEA K10 (``rnea``), the Riccati sweep K7/K8
(``riccati``) and the arm-class sweep K11 (``riccati_fused``) on one CUDA
card, float32, at each path's shapes:

    python3 tools/time_step_kernels.py [--root DIR] [--label NAME]
    python3 tools/time_step_kernels.py --sweep [--models KEY ...]

Shapes: arm7 K1 at 128 and 1 states, K2 at 1024 trajectories x 100 knots,
K3 at 12,800 knots (BASELINE.json configs[2]); the rpy quadruped K1 at
1024, K2 at 6144 x 50, K3 at 51,200 knots (configs[3]); humanoid30 K1 at
2048, K2 at 1024 x 32, K3 at 8,192 knots (configs[4] paths C and D); K9
with two chunks on each model's K2 inputs (path D's line search on the
humanoid); the sweep at configs[3]'s 1024 problems x 50 knots (nx=36,
nu=18), at four such problems (the small-batch call site), and at paths
D's and C's 256 and 16 humanoid problems x 32 knots (nx=72, nu=36),
constant cost blocks; K11 and, on the same inputs, the sweep at
configs[2]'s 128 problems x 100 knots (nx=14, nu=7, per-knot cost blocks),
at four and at one (path B's tick) (``chip_smoke.riccati_problem``); K4
on arm7, ee_gn at 12,800 (the knots of configs[2]) and 128 states (its
terminal cost) and ee_err at 102,400 (its line search) and 1,024; K5 on
arm7 at 4096 trajectories x 50 steps (configs[1],
``chip_smoke.rollout_inputs``) on each route, and on each route with
(H, nb, 6) wrenches, and on the floating-root models at path L's 4096 x 50
(``chip_smoke.legged_inputs``) on each route with and without its trunk
push; K10 (bias and with qdd) and K6 (factorised and
dense, each without wrenches and with one set shared by the batch or one
a state) at arm7's 4096 states (``chip_smoke.rollout_inputs``), the rpy
quadruped's 1024 and the humanoid's 2048 (``chip_smoke.minv_rnea_checks``
on K1's states; a root whose kernel has no instantiation there is
reported as such); on each model K2 and K9 (two chunks) under per-knot
world wrenches (``chip_smoke.push_wrenches``, a trunk push over
0.5 N(0,1)) at K2's shape; the quaternion humanoid (class fq32) K1 at
2048 states, K2, K9 and their wrench twins at path J's 1024 x 32, K3 at
path G's 512 knots, K10 and K6 at K1's states (``chip_smoke.
quat_kernel_inputs``, ``quat_feedback_inputs``); and on the rpy quadruped
K4 at path E's shapes
(ee_gn at 51,200 knots and 1,024 terminal states, ee_err at the line
search's 307,200 and 6,144; the first leaf's target, ``chip_smoke.
TARGET_E``); a tree whose entry points take no wrenches reports that.  Each time is ``chip_smoke.graph_ms``
(the device's time alone) and, beside it, ``chip_smoke.cuda_ms`` over 20
single calls (the host's launch included) and ``host_ms``, the host's own
time a call.  ``--root`` times the
``rbdtpu_torch`` of another checkout (a parent commit unpacked into an
ignored directory) with this checkout's timers and inputs, so two commits
compare on one card by running the tool once per root in turns (parent,
change, change, parent).

``--sweep`` rebuilds this checkout's kernels at each team size of
``_lib.TEAM_SIZES`` (every entry of ``_lib.TEAM`` set to it) and times, in
float32 and float64, K1 at 1, 16 and 256 states and at the path's batch,
K2 at the path's shape in both walks of the step's root->leaf recursions,
K9 (two chunks) at the same shape in the walk ``_lib.level_walk`` picks,
K2 and K9 (two chunks) with per-knot (H, nb, 6) wrenches at that shape,
K3 at the path's knots, K5 at 4096 x 50 on each route, with and without
(H, nb, 6) wrenches (arm7's or path L's inputs), and K10 and K6 at the
shapes above (graph replay): the measurements ``_lib.TEAM`` and
``_lib.level_walk`` were fixed from.  ``--models`` restricts either run
to some of the models (keys of MODELS: "arm7", "rpy quadruped",
"humanoid", "quaternion humanoid").  Prints one JSON line with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT, GRAVITY = 0.01, -9.81
# (key, asset, floating base, quaternion root)
MODELS = (("arm7", "arm7", False, False),
          ("rpy quadruped", "quadruped12", True, False),
          ("humanoid", "humanoid30", True, False),
          ("quaternion humanoid", "humanoid30", True, True))
SWEEP_STATES = (1, 16, 256)
# the Riccati sweep's shapes: (label, problems, knots, nx, nu)
RICCATI_SHAPES = (("configs[3]", 1024, 50, 36, 18), ("B=4", 4, 50, 36, 18),
                  ("path D", 256, 32, 72, 36), ("path C", 16, 32, 72, 36))
# K11's shapes, per-knot cost blocks: configs[2] (path A), the parity
# batch, path B's one robot
K11_SHAPES = (("configs[2]", 128, 100, 14, 7), ("B=4", 4, 100, 14, 7),
              ("B=1", 1, 100, 14, 7))
NCHUNKS = 2
ROUTES = ("aba", "minv")


def smoke():
    """This checkout's chip_smoke.py as a module (timers, input makers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def path_inputs(cs, key, m64):
    """(x, u) of K1, K2's five inputs and K3's (q, qd, u) at ``key``'s path
    shapes, float64."""
    if key == "arm7":
        inp = cs.kernel_inputs(m64, np.random.default_rng(cs.SEED))
    elif key == "rpy quadruped":
        inp = cs.quadruped_kernel_inputs(m64,
                                         np.random.default_rng(cs.SEED + 5))
    elif key == "quaternion humanoid":
        rng = np.random.default_rng(cs.SEED + 110)
        inp = cs.quat_kernel_inputs(m64, rng)
        return inp["fd_step"], cs.quat_feedback_inputs(
            m64, rng, cs.BD * cs.ALPHAS_H, cs.HH), inp["linearize_parts"]
    else:
        inp = cs.floating_kernel_inputs(
            m64, np.random.default_rng(cs.SEED + 90), cs.humanoid_problems,
            2048, 1024, 32, cs.BD * cs.HH)
    return inp["fd_step"], inp["feedback_rollout"], inp["linearize_parts"]


def host_ms(fn, reps: int = 100, rounds: int = 5) -> float:
    """Milliseconds of the host's own work in one ``fn`` call: ``reps``
    calls issued back to back without waiting on the device, the fewest
    of ``rounds`` such runs (the device caught up between them), over
    ``reps``.  ``reps`` launches stay well inside the device's queue, so
    no call waits on an earlier one."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t)
        torch.cuda.synchronize()
    return best / reps * 1e3


def rollout_args(cs, m64):
    """K5's float32 inputs at the rollout path's shape: x0, U per route and
    the (H, nb, 6) wrenches (``chip_smoke.rollout_inputs``)."""
    ins = {label: (args, kw) for label, _, args, kw, _, _ in
           cs.rollout_inputs(m64, np.random.default_rng(cs.SEED + 3))}
    f32 = lambda t: t.float().contiguous()
    (x0, U_minv), _ = ins["rollout_multi minv"]
    (_, U_aba), kw = ins["rollout_multi aba f_ext (H,nb,6)"]
    return f32(x0), {"minv": f32(U_minv), "aba": f32(U_aba)}, f32(kw["f_ext"])


# path L's start of each floating-root model (chip_smoke's makers)
LEGGED = {"rpy quadruped": "quadruped_problems", "humanoid": "humanoid_problems",
          "quaternion humanoid": "quat_problems"}


def k5_args(cs, key, m64):
    """K5's float64 inputs at its path's shape: (x0, {route: U}, wrenches)
    from ``rollout_args`` on arm7, from ``chip_smoke.legged_inputs`` (the
    same controls on both routes, path F's trunk push) on the floating
    roots."""
    if key == "arm7":
        return rollout_args(cs, m64)
    x0, U, F = cs.legged_inputs(m64, getattr(cs, LEGGED[key]), cs.BL, cs.HL,
                                cs.SEED + 132)
    return x0, {"aba": U, "minv": U}, F


def k5_calls(m, k5):
    """(label, call) of K5 on model ``m`` in m's dtype on each route, with
    and without the wrenches (``k5_args``' inputs)."""
    from rbdtpu_torch.kernels import fused

    x0, Us, F = k5
    x0, F = x0.to(m.dtype), F.to(m.dtype)
    Us = {route: U.to(m.dtype) for route, U in Us.items()}
    return [(f"K5 {route}{wr} {x0.shape[0]}x{Us[route].shape[0]}",
             functools.partial(fused.rollout_fused_multi, m, x0, Us[route],
                               DT, GRAVITY, route=route, f_ext=fe))
            for route in ROUTES for wr, fe in (("", None), (" f_ext", F))]


def minv_rnea_cases(cs, key, m64, fd):
    """K10's and K6's checks (``chip_smoke.check_kernels``' form, float64)
    at ``key``'s step shape: arm7 the rollout path's 4096 states, the rpy
    models K1's states ``fd`` with the extras phases 9 and 15 draw."""
    if key == "arm7":
        return [c for c in cs.rollout_inputs(
            m64, np.random.default_rng(cs.SEED + 3))
            if c[1] in ("rnea", "fd_step_minv")]
    seed = cs.SEED + {"rpy quadruped": 6, "humanoid": 91,
                      "quaternion humanoid": 122}[key]
    return cs.minv_rnea_checks(m64, fd, "", *cs.step_extras(
        m64, fd[0].shape[0], seed))


def minv_rnea_calls(cs, m, checks):
    """(label, call) of each K10/K6 check on model ``m`` in m's dtype."""
    table = cs.kernel_table()
    out = []
    for label, kname, a64, kw, _, _ in checks:
        a = tuple(t.to(m.dtype).contiguous() for t in a64)
        k = {n: v.to(m.dtype) if isinstance(v, torch.Tensor) else v
             for n, v in kw.items()}
        tag = "K10" if kname == "rnea" else "K6"
        out.append((f"{tag} {label} B={a[0].shape[0]}",
                    functools.partial(table[kname][0], m, *a, **k)))
    return out


def load(name, fb, quat, dtype):
    from rbdtpu_torch.model import load_asset

    kw = {"root_quat": True} if quat else {}
    return load_asset(name, device="cuda", dtype=dtype, floating_base=fb,
                      **kw)


def compare(cs, label: str, models=MODELS) -> dict:
    from rbdtpu_torch.kernels import colvec, fk_lane, fused
    from rbdtpu_torch.kernels.riccati import backward_pass_fused
    from rbdtpu_torch.kernels.riccati_chunk import backward_pass_chunked

    out = {}
    timed = lambda fn: {"graph": cs.graph_ms(fn),
                        "call": cs.cuda_ms(fn, reps=20), "host": host_ms(fn)}
    for key, name, fb, quat in models:
        m64 = load(name, fb, quat, torch.float64)
        m32 = load(name, fb, quat, torch.float32)
        fd64, k2, k3 = path_inputs(cs, key, m64)
        x, u = (t.float().contiguous() for t in fd64)
        k2 = tuple(t.float().contiguous() for t in k2)
        k3 = tuple(t.float().contiguous() for t in k3)
        cases = [(f"K1 B={x.shape[0]}",
                  lambda: fused.fd_step_fused(m32, x, u, DT, GRAVITY))]
        if key == "arm7":
            x1, u1 = x[:1].contiguous(), u[:1].contiguous()
            cases.append(("K1 B=1", lambda: fused.fd_step_fused(
                m32, x1, u1, DT, GRAVITY)))
        cases.append((f"K2 {k2[2].shape[0]}x{k2[2].shape[1]}",
                      lambda: fused.feedback_rollout_fused(m32, *k2, DT,
                                                           GRAVITY)))
        cases.append((f"K9 {k2[2].shape[0]}x{k2[2].shape[1]} nchunks="
                      f"{NCHUNKS}", lambda: fused.feedback_rollout_fused_chunked(
                          m32, *k2, DT, GRAVITY, nchunks=NCHUNKS)))
        cases.append((f"K3 {k3[0].shape[0]}", lambda: colvec.
                      linearize_parts_fused(m32, *k3, GRAVITY)))
        push = cs.push_wrenches(m32, k2[2].shape[1], 0.5, cs.SEED + 120)
        cases.append((f"K2 f_ext {k2[2].shape[0]}x{k2[2].shape[1]}",
                      functools.partial(fused.feedback_rollout_fused, m32,
                                        *k2, DT, GRAVITY, f_ext=push)))
        cases.append((f"K9 f_ext {k2[2].shape[0]}x{k2[2].shape[1]} "
                      f"nchunks={NCHUNKS}", functools.partial(
                          fused.feedback_rollout_fused_chunked, m32, *k2, DT,
                          GRAVITY, nchunks=NCHUNKS, f_ext=push)))
        if key == "rpy quadruped":
            rng = np.random.default_rng(cs.SEED + 12)
            ee = (m32.joint_names[m32.leaves()[0]],)
            for kernel, gn, batches in (
                    ("ee_gn", True, (cs.B3 * cs.H3, cs.B3)),
                    ("ee_err", False, (cs.ALPHAS3 * cs.B3 * cs.H3,
                                       cs.ALPHAS3 * cs.B3))):
                for B in batches:
                    x0q, _ = cs.quadruped_problems(m32, B, 1, rng)
                    q = (x0q[:, :m32.nq] + torch.tensor(
                        0.1 * rng.standard_normal((B, m32.nq)),
                        dtype=torch.float32, device="cuda")).contiguous()
                    cases.append((f"K4 {kernel} B={B}", functools.partial(
                        fk_lane.ee_gn_fused, m32, q, cs.TARGET_E, gn=gn,
                        ee_names=ee)))
        cases += k5_calls(m32, k5_args(cs, key, m64))
        if key == "arm7":
            rng = np.random.default_rng(cs.SEED + 11)
            for kernel, gn, batches in (("ee_gn", True, (12800, 128)),
                                        ("ee_err", False, (102400, 1024))):
                for B in batches:
                    q = torch.tensor(0.3 * rng.standard_normal((B, m32.nq)),
                                     dtype=torch.float32, device="cuda")
                    cases.append((f"K4 {kernel} B={B}", functools.partial(
                        fk_lane.ee_gn_fused, m32, q, cs.TARGET, gn=gn)))
        cases += minv_rnea_calls(cs, m32,
                                 minv_rnea_cases(cs, key, m64, fd64))
        for case, fn in cases:
            try:
                fn()
            except NotImplementedError:
                out[f"{key} {case}"] = "not instantiated"
                continue
            except TypeError:
                out[f"{key} {case}"] = "no such argument"
                continue
            out[f"{key} {case}"] = timed(fn)
        del fd64, x, u, k2, k3, cases
        torch.cuda.empty_cache()
    for case, B, H, nx, nu in RICCATI_SHAPES:
        prob = tuple(torch.tensor(a, dtype=torch.float32, device="cuda")
                     for a in cs.riccati_problem(
                         np.random.default_rng(cs.SEED + B), nx, nu, H, B,
                         True))
        out[f"riccati {case} {B}x{H} nx={nx}"] = timed(
            lambda: backward_pass_chunked(*prob))
        del prob
    for case, B, H, nx, nu in K11_SHAPES:
        prob = tuple(torch.tensor(a, dtype=torch.float32, device="cuda")
                     for a in cs.riccati_problem(
                         np.random.default_rng(cs.SEED + B), nx, nu, H, B,
                         False))
        out[f"K11 {case} {B}x{H} nx={nx}"] = timed(
            lambda: backward_pass_fused(*prob))
        out[f"riccati on K11's {case} {B}x{H} nx={nx}"] = timed(
            lambda: backward_pass_chunked(*prob))
    return {"label": label, "ms": out}


def sweep(cs, models=MODELS) -> dict:
    from rbdtpu_torch.kernels import _lib, colvec, fused

    out = {}
    for team in _lib.TEAM_SIZES:
        for k in _lib.TEAM:
            _lib.TEAM[k] = team
        _lib.library.cache_clear()
        _lib.library()
        for key, name, fb, quat in models:
            m64 = load(name, fb, quat, torch.float64)
            k5 = k5_args(cs, key, m64)
            (x64, u64), k2_64, k3_64 = path_inputs(cs, key, m64)
            k6 = minv_rnea_cases(cs, key, m64, (x64, u64))
            for dtype in (torch.float32, torch.float64):
                m = load(name, fb, quat, dtype)
                sfx = _lib._SUFFIX[dtype]
                x, u = x64.to(dtype), u64.to(dtype)
                k2 = tuple(t.to(dtype).contiguous() for t in k2_64)

                def k1(B):
                    xb = x.repeat(-(-B // x.shape[0]), 1)[:B].contiguous()
                    ub = u.repeat(-(-B // u.shape[0]), 1)[:B].contiguous()
                    xo = torch.empty_like(xb)
                    return lambda: _lib.launch(
                        "fd_step", m, xb, xb, ub, None, 0, xo, B,
                        *_lib.team_args("fd_step", m, xb, B), DT, GRAVITY)

                def k2_walk(levels):
                    B, H = k2[2].shape[:2]
                    Xo, Uo = torch.empty_like(k2[1]), torch.empty_like(k2[2])
                    args = _lib.team_args("feedback_rollout", m, x, B)[1:]
                    return lambda: _lib.launch(
                        "feedback_rollout", m, x, *k2, None, Xo, Uo, B, H,
                        levels, *args, DT, GRAVITY)

                for B in (*SWEEP_STATES, x.shape[0]):
                    out[f"{team} {key} {sfx} K1 B={B}"] = cs.graph_ms(k1(B))
                B, H = k2[2].shape[:2]
                for levels, walk in ((1, "levels"), (0, "bodies")):
                    out[f"{team} {key} {sfx} K2 {B}x{H} by {walk}"] = (
                        cs.graph_ms(k2_walk(levels)))
                out[f"{team} {key} {sfx} K9 {B}x{H} nchunks={NCHUNKS}"] = (
                    cs.graph_ms(lambda: fused.feedback_rollout_fused_chunked(
                        m, *k2, DT, GRAVITY, nchunks=NCHUNKS)))
                F = cs.push_wrenches(m, H, 0.5, cs.SEED + 110)
                out[f"{team} {key} {sfx} K2 f_ext {B}x{H}"] = cs.graph_ms(
                    lambda: fused.feedback_rollout_fused(
                        m, *k2, DT, GRAVITY, f_ext=F))
                out[f"{team} {key} {sfx} K9 f_ext {B}x{H} nchunks="
                    f"{NCHUNKS}"] = cs.graph_ms(
                        lambda: fused.feedback_rollout_fused_chunked(
                            m, *k2, DT, GRAVITY, nchunks=NCHUNKS, f_ext=F))
                k3 = tuple(t.to(dtype).contiguous() for t in k3_64)
                out[f"{team} {key} {sfx} K3 B={k3[0].shape[0]}"] = (
                    cs.graph_ms(lambda: colvec.linearize_parts_fused(
                        m, *k3, GRAVITY)))
                for case, fn in k5_calls(m, k5):
                    out[f"{team} {key} {sfx} {case}"] = cs.graph_ms(fn)
                for case, fn in minv_rnea_calls(cs, m, k6):
                    out[f"{team} {key} {sfx} {case}"] = cs.graph_ms(fn)
            torch.cuda.empty_cache()
    return {"label": "team sweep", "ms": out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose rbdtpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="time every team size of this checkout")
    ap.add_argument("--models", nargs="+", default=None,
                    choices=[k for k, *_ in MODELS],
                    help="time these models only")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_step_kernels: no CUDA device", file=sys.stderr)
        return 2
    root = REPO if a.sweep else os.path.abspath(a.root)
    sys.path.insert(0, root)
    cs = smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    models = [m for m in MODELS if a.models is None or m[0] in a.models]
    out = sweep(cs, models) if a.sweep else compare(
        cs, a.label or os.path.basename(root), models)
    print(json.dumps({**out, "card": smi.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
