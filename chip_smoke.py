#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rbdtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending the run with a nonzero exit when it fails:

1. identify the card (name, power limit) and build the CUDA kernels from
   ``rbdtpu_torch/csrc``;
2. hold each kernel of the DDP path against its plain PyTorch version on
   the card, at that path's shapes: max abs error <= 1e-9 in float64, and
   a relative bound in float32; time both (CUDA events) and compute each
   kernel's bound (bytes over the memory rate, or operations over the
   float32 peak, whichever is larger; the operations each function needs
   are counted by ``rbdtpu_torch/opcount.py``);
3. drive the arm7 end-effector DDP path (BASELINE.json configs[2]) —
   ``ddp_solve`` on arm7 EE reaching, Bm=128, H=100, 10 iterations, 8
   line-search steps, float32, ``fused=True`` — and check that every kernel
   of that path was launched, that J is finite and nonincreasing and that
   the mean J fell;
4. solve Bm=4 problems in float64 twice, through the kernels and through
   the plain versions on the card, at H=100 (the main path's horizon) and
   at H=20, and require max |U_kernel - U_plain| < 1e-6 (the repository's
   control-parity tolerance) at both;
5. profile one DDP solve: per-phase wall time, torch.profiler's device time
   per kernel, the kernels a solve launches and the device's idle share;
6. the same checks for the rollout path's kernels at its shapes (after
   the DDP phases, which therefore run as they did before these kernels);
7. drive the forward-dynamics rollout path (BASELINE.json configs[1]) on
   bench.py's inputs: 4096 arm7 trajectories x H=50, float32, the 10-step
   check of the whole-horizon kernel against the scan of its step kernel
   and against the plain route (< 1e-3), then ``rollout_fused_multi``
   timed on the "minv" and "aba" routes (steps/s), each call one launch;
   every kernel of the path must have been launched and the final states
   finite.

The last three lines of standard output are the card's name and power
limit, the kernels' JSON summary and the result line.  Without a CUDA
device the script exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
TARGET = (0.3, 0.2, 0.8)
WEIGHTS = dict(w_ee=10.0, w_ee_f=2000.0, w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)
DT, GRAVITY = 0.01, -9.81
TOL64 = 1e-9
# float32: |kernel - plain| <= tol * max(1, max|plain|).  Single steps and
# per-knot sweeps reorder float32 sums (measured float32-vs-float64 spread of
# the plain versions: <= 5e-7 relative), so 1e-4; the feedback rollout
# carries 100 closed-loop steps, so 1e-3.
TOL32 = {"fd_step": 1e-4, "feedback_rollout": 1e-3, "linearize_parts": 1e-4,
         "ee_gn": 1e-4, "ee_err": 1e-4, "rnea": 1e-4, "fd_step_minv": 1e-4,
         "rollout_multi": 1e-3}
U_PARITY = 1e-6
PARITY_H = (100, 20)
# the rollout path (BASELINE.json configs[1], bench.py:132-209, 377-416)
B1, H1, HONEST_H, HONEST_TOL = 4096, 50, 10, 1e-3
# H100 SXM published peaks at 700 W: HBM bytes/s, float32 and float64
# operations/s outside the tensor cores
PEAK_BYTES, PEAK_OPS = 3.35e12, {"float32": 67e12, "float64": 34e12}


def require(ok: bool, msg: str):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(args, outs, model, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (every input tensor, the model tables and every output once) over the
    memory rate and its operations (``ops``, the algorithm's count from
    ``rbdtpu_torch/opcount.py``) over the peak rate of ``dtype``."""
    import torch
    from rbdtpu_torch.kernels import _lib

    if not isinstance(outs, tuple):
        outs = (outs,)
    tensors = [t for t in (*args, *outs) if isinstance(t, torch.Tensor)]
    tab, itab = _lib.model_tables(model, model.device, model.dtype)
    nbytes = sum(t.numel() * t.element_size() for t in (*tensors, tab, itab))
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(model64, rng):
    """Float64 CUDA inputs at the main path's shapes for every kernel."""
    import torch
    from rbdtpu_torch.dynamics import minv, rnea

    n = model64.nv
    dev = model64.device
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)

    def states(B):
        q = T(0.3 * rng.standard_normal((B, n)))
        qd = T(0.5 * rng.standard_normal((B, n)))
        z = torch.zeros_like(q)
        u = rnea(model64, q, z, z)[0] + T(rng.standard_normal((B, n)))
        return q, qd, u

    q, qd, u = states(128)
    fd = (torch.cat([q, qd], -1), u)
    # line search: 8 step sizes x 128 problems over H=100.  Gains are
    # stabilising (computed-torque PD, perturbed per knot) and k cancels
    # K (x0 - X_nom), so the closed loop holds the gravity equilibrium:
    # the open-loop arm amplifies rounding ~1e9-fold over 100 steps, which
    # would swamp any kernel-vs-plain comparison.
    B, H = 1024, 100
    q0 = T(0.3 * rng.standard_normal((B, n)))
    x0 = torch.cat([q0, torch.zeros_like(q0)], -1)
    Xn = x0[:, None] + T(0.1 * rng.standard_normal((B, H, 2 * n)))
    z = torch.zeros_like(q0)
    Un = rnea(model64, q0, z, z)[0][:, None].expand(B, H, n).contiguous()
    pd = np.concatenate([400.0 * np.eye(n), 40.0 * np.eye(n)], 1)
    gains = T(pd * (1 + 0.1 * rng.standard_normal((B, H, n, 2 * n))))
    Kf = -(torch.linalg.inv(minv(model64, q0))[:, None] @ gains)
    kf = -(Kf @ (x0[:, None] - Xn)[..., None])[..., 0]
    fb = (x0, Xn.contiguous(), Un, kf.contiguous(), Kf.contiguous())
    lin = states(12800)
    q_gn = T(0.3 * rng.standard_normal((12800, n)))
    q_err = T(0.3 * rng.standard_normal((102400, n)))
    return {"fd_step": fd, "feedback_rollout": fb, "linearize_parts": lin,
            "ee_gn": (q_gn,), "ee_err": (q_err,)}


def kernel_table():
    """name -> (kernel fn, plain fn, source, replaces)."""
    from rbdtpu_torch.kernels import colvec, fk_lane, fused

    def ee(gn):
        return (lambda m, q: fk_lane.ee_gn_fused(m, q, TARGET, gn=gn),
                lambda m, q: fk_lane.ee_gn_plain(m, q, TARGET, gn=gn))

    return {
        "fd_step": (
            lambda m, x, u, **kw: fused.fd_step_fused(m, x, u, DT, GRAVITY,
                                                      **kw),
            lambda m, x, u, **kw: fused.fd_step_plain(m, x, u, DT, GRAVITY,
                                                      **kw),
            "rbdtpu_torch/csrc/fd_step.cu", "rbdtpu/kernels/fused.py:450"),
        "feedback_rollout": (
            lambda m, *a: fused.feedback_rollout_fused(m, *a, DT, GRAVITY),
            lambda m, *a: fused.feedback_rollout_plain(m, *a, DT, GRAVITY),
            "rbdtpu_torch/csrc/feedback_rollout.cu",
            "rbdtpu/kernels/fused.py:611"),
        "linearize_parts": (
            lambda m, *a: colvec.linearize_parts_fused(m, *a, GRAVITY),
            lambda m, *a: colvec.linearize_parts_plain(m, *a, GRAVITY),
            "rbdtpu_torch/csrc/linearize.cu", "rbdtpu/kernels/colvec.py:289"),
        "ee_gn": (*ee(True), "rbdtpu_torch/csrc/ee_gn.cu",
                  "rbdtpu/kernels/fk_lane.py:203"),
        "ee_err": (*ee(False), "rbdtpu_torch/csrc/ee_gn.cu",
                   "rbdtpu/kernels/fk_lane.py:203"),
        "rnea": (
            lambda m, *a: fused.rnea_fused(m, *a, gravity=GRAVITY),
            lambda m, *a: fused.rnea_plain(m, *a, gravity=GRAVITY),
            "rbdtpu_torch/csrc/rnea.cu", "rbdtpu/kernels/fused.py:358"),
        "fd_step_minv": (
            lambda m, x, u, **kw: fused.fd_step_minv_fused(m, x, u, DT, GRAVITY,
                                                           **kw),
            lambda m, x, u, **kw: fused.fd_step_minv_plain(m, x, u, DT, GRAVITY,
                                                           **kw),
            "rbdtpu_torch/csrc/fd_step_minv.cu",
            "rbdtpu/kernels/fused.py:1267"),
        "rollout_multi": (
            lambda m, x0, U, **kw: fused.rollout_fused_multi(m, x0, U, DT,
                                                             GRAVITY, **kw),
            lambda m, x0, U, **kw: fused.rollout_multi_plain(m, x0, U, DT,
                                                             GRAVITY, **kw),
            "rbdtpu_torch/csrc/rollout_multi.cu",
            "rbdtpu/kernels/fused.py:1029"),
    }


def rollout_inputs(model64, rng):
    """Float64 CUDA inputs at the rollout path's shapes (B1 trajectories):
    bench.py's x0 = 0.1 N(0,1), U = 0.5 N(0,1) for "minv" and 0.2 N(0,1) for
    "aba"; world-frame wrenches 0.5 N(0,1) (at 2 N(0,1) a few of the 4096
    open-loop trajectories overflow within 50 steps).  Each entry: (label,
    kernel name, args, keyword args, operations key, states x steps)."""
    import torch

    n, nb = model64.nv, model64.nb
    T = lambda sc, *s: torch.tensor(sc * rng.standard_normal(s),
                                    dtype=torch.float64, device=model64.device)
    x0, u, qdd = T(0.1, B1, 2 * n), T(0.5, B1, n), T(0.5, B1, n)
    q, qd = x0[:, :n].contiguous(), x0[:, n:].contiguous()
    U_minv, U_aba = T(0.5, H1, B1, n), T(0.2, H1, B1, n)
    F1, FB, FH = T(0.5, nb, 6), T(0.5, B1, nb, 6), T(0.5, H1, nb, 6)
    return [
        ("rnea bias", "rnea", (q, qd), {}, "rnea", B1),
        ("rnea qdd", "rnea", (q, qd, qdd), {}, "rnea+qdd", B1),
        ("fd_step_minv", "fd_step_minv", (x0, u), {}, "fd_step_minv", B1),
        ("fd_step_minv dense", "fd_step_minv", (x0, u),
         {"dense_minv": True}, "fd_step_minv+dense", B1),
        ("rollout_multi minv", "rollout_multi", (x0, U_minv),
         {"route": "minv"}, "fd_step_minv", B1 * H1),
        ("rollout_multi aba", "rollout_multi", (x0, U_aba),
         {"route": "aba"}, "fd_step", B1 * H1),
        ("rollout_multi minv f_ext (H,nb,6)", "rollout_multi", (x0, U_minv),
         {"route": "minv", "f_ext": FH}, "fd_step_minv+fext", B1 * H1),
        ("fd_step f_ext (nb,6)", "fd_step", (x0, u), {"f_ext": F1},
         "fd_step+fext", B1),
        ("fd_step f_ext (B,nb,6)", "fd_step", (x0, u), {"f_ext": FB},
         "fd_step+fext", B1),
    ]


def errors(outs_a, outs_b, relative: bool) -> list:
    """Per-output max |a - b| (relative: divided by max(1, max|b|)); the
    ``None`` outputs of ee_err are skipped."""
    if not isinstance(outs_a, tuple):
        outs_a, outs_b = (outs_a,), (outs_b,)
    errs = []
    for a, b in zip(outs_a, outs_b):
        if a is None:
            continue
        require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        require(bool(b.isfinite().all()), "plain version gave non-finite values")
        err = (a.double() - b.double()).abs().max().item()
        if relative:
            err /= max(1.0, b.abs().max().item())
        errs.append(err)
    return errs


def solve(model, x0, U0, fused: bool, iters: int):
    from rbdtpu_torch.solver import DDPConfig, ddp_solve, ee_reaching_cost

    cost = ee_reaching_cost(model, TARGET, fused=None if fused else False,
                            **WEIGHTS)
    cfg = DDPConfig(iters=iters, dt=DT, gravity=GRAVITY, n_alphas=8,
                    fused=fused)
    return ddp_solve(model, cost, x0, U0, cfg)


def start_problems(model, Bm: int, H: int, rng):
    """Random start configurations at rest, gravity-compensation warm start
    at every knot (the bench's configs[2] start)."""
    import torch
    from rbdtpu_torch.dynamics import rnea

    q0 = torch.tensor(0.3 * rng.standard_normal((Bm, model.nq)),
                      dtype=model.dtype, device=model.device)
    z = torch.zeros_like(q0)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(model, q0, z, z)[0][:, None].expand(Bm, H, model.nv).contiguous()
    return x0, U0


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    registers, stack frame and spill bytes a thread."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            # kernels are plain templates: _Z<len><name>I<d|f>(Lb<0|1>E)*...,
            # the bools being GN, HAS_QDD, DENSE, MINV or FEXT
            m = re.search(r"for _Z(\d+)(\w+)", line)
            name = None
            if m:
                n = int(m.group(1))
                base, tail = m.group(2)[:n], m.group(2)[n:]
                t = re.match(r"I([df])((?:Lb[01]E)*)", tail)
                args = ["double" if t and t.group(1) == "d" else "float"]
                flags = re.findall(r"Lb([01])E", t.group(2) if t else "")
                args += ["true" if b == "1" else "false" for b in flags]
                name = f"{base}<{', '.join(args)}>"
        elif name and "bytes stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"ptxas {name}: {regs} registers, {frame}")
            name = None
    return out


def profile_main_path(model, x0, U0, iters: int):
    """Where one main-path solve spends its time: per-phase wall time (each
    phase synchronised, so the total exceeds an unsynchronised solve), then
    torch.profiler's device time per kernel, the kernels launched per solve
    and the device's idle share against an unprofiled solve."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from rbdtpu_torch.solver import ddp

    def run():
        solve(model, x0, U0, fused=True, iters=iters)
        torch.cuda.synchronize()

    spent, calls = collections.Counter(), collections.Counter()

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            calls[name] += 1
            return out
        return call

    phases = {p: getattr(ddp, p) for p in (
        "fd_step_fused", "linearize_fused", "quadratize_trajectory",
        "backward_pass", "forward_pass_fused")}
    for p, fn in phases.items():
        setattr(ddp, p, timed(p, fn))
    try:
        t = time.perf_counter()
        run()
        total = time.perf_counter() - t
    finally:
        for p, fn in phases.items():
            setattr(ddp, p, fn)
    print(f"profile: one solve with each phase synchronised: "
          f"{total * 1e3:.1f} ms")
    for p in phases:
        print(f"  {p:24s} {spent[p] * 1e3:9.2f} ms  calls {calls[p]}")
    print(f"  {'rest (J0, selection)':24s} "
          f"{(total - sum(spent.values())) * 1e3:9.2f} ms")

    t = time.perf_counter()
    run()
    wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.key_averages()
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3
    on_dev = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy = sum(dev_ms(e) for e in on_dev)
    print(f"profile: {sum(e.count for e in on_dev)} device kernels per solve,"
          f" {busy:.1f} ms device time; unprofiled solve {wall:.1f} ms -> "
          f"device idle share {1 - busy / wall:.3f}")
    for e in sorted(on_dev, key=dev_ms, reverse=True)[:12]:
        print(f"  {dev_ms(e):9.2f} ms  x{e.count:6d}  {e.key[:90]}")
    launch_calls = {e.key: e.count for e in events
                    if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    print(f"profile: host launch calls per solve {launch_calls}")


def check_kernels(checks, m64, m32, smi: str, rows=None) -> dict:
    """Hold each kernel against its plain version (float64 max abs error
    <= TOL64, float32 relative error <= TOL32), time both in float32 and
    compute the bound.  ``checks``: (label, kernel name, float64 args,
    keyword args, operations key, states x steps).  The first check of a
    kernel gives its row of the JSON line; the row's max_abs_err is the
    largest over the kernel's checks.  Fails after printing every check."""
    import torch
    from rbdtpu_torch import opcount

    flops = opcount.per_state(m32, TARGET)
    table = kernel_table()
    rows = {} if rows is None else rows
    failures = []
    for label, kname, a64, kw, ops_key, states in checks:
        kern, plain, source, replaces = table[kname]
        a32 = tuple(a.float() for a in a64)
        kw32 = {k: v.float() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}
        p64 = plain(m64, *a64, **kw)
        e64 = errors(kern(m64, *a64, **kw), p64, relative=False)
        k32, p32 = kern(m32, *a32, **kw32), plain(m32, *a32, **kw32)
        e32 = errors(k32, p32, relative=True)
        torch.cuda.synchronize()
        err64, err32 = max(e64), max(e32)
        if err64 > TOL64:
            failures.append(f"{label}: float64 max abs error {err64:.3e} > "
                            f"{TOL64:g}")
        if err32 > TOL32[kname]:
            failures.append(f"{label}: float32 relative error {err32:.3e} > "
                            f"{TOL32[kname]:g}")
        ms = cuda_ms(lambda: kern(m32, *a32, **kw32), reps=20)
        plain_ms = cuda_ms(lambda: plain(m32, *a32, **kw32), reps=3)
        ops = flops[ops_key] * states
        bound_ms, bound_by = bound((*a32, *kw32.values()), k32, m32, ops,
                                   "float32")
        shapes = " ".join(str(tuple(a.shape)) for a in a64)
        fmt = lambda es: "[" + " ".join(f"{e:.2e}" for e in es) + "]"
        print(f"kernel {label}: inputs {shapes}  f64 max|err| {fmt(e64)}  "
              f"f32 rel err {fmt(e32)} (kernel vs f64 plain "
              f"{fmt(errors(k32, p64, relative=True))}, plain vs f64 plain "
              f"{fmt(errors(p32, p64, relative=True))})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound_ms:.6f} ms by "
              f"{bound_by} ({ops:.4g} operations) (f32, median, {smi})")
        if kname not in rows:
            rows[kname] = dict(name=kname, route="cuda", source=source,
                               replaces=replaces, max_abs_err=err64, ms=ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=None)
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err64)
    require(not failures, "; ".join(failures))
    return rows


# the kernels each path launches; the JSON line reports each kernel's
# launches from the path it belongs to (fd_step from the DDP path).  rnea
# (K10) is the bias pass of fd_step_minv as a kernel of its own: held
# against its plain version, launched by neither path, reported with the
# rollout path's count (0).
DDP_KERNELS = ("fd_step", "feedback_rollout", "linearize_parts", "ee_gn",
               "ee_err")
ROLLOUT_KERNELS = ("fd_step_minv", "rollout_multi")


def rollout_path(m32, rng, smi: str) -> dict:
    """BASELINE.json configs[1] through the port's entry points, on
    bench.py's inputs (bench.py:132-209, 377-416): B1 arm7 trajectories of
    H1 steps, dt=0.01, float32, x0 = 0.1 N(0,1).  The 10-step check holds
    the whole-horizon kernel against the plain route (< 1e-3, as
    bench.py:174) and against the scan of its step kernel
    (``fd_step_minv_fused`` or ``rollout_fused``) on U = 0.5 N(0,1), the
    controls of bench.py's check; then each route is timed on
    U = 0.2 N(0,1), the controls bench.py times both routes on (median of 7
    CUDA-event timings after a warm-up).  Returns the launch counts of the
    run."""
    import torch
    from rbdtpu_torch.kernels import _lib, fused

    n = m32.nv
    T = lambda sc, *s: torch.tensor(sc * rng.standard_normal(s),
                                    dtype=torch.float32, device=m32.device)
    x0 = T(0.1, B1, 2 * n)
    U_check, U = T(0.5, HONEST_H, B1, n), T(0.2, H1, B1, n)
    torch.cuda.synchronize()
    _lib.reset_launches()

    def minv_scan(x, Us):
        for t in range(Us.shape[0]):
            x = fused.fd_step_minv_fused(m32, x, Us[t], DT, GRAVITY)
        return x

    step_scans = {
        "minv": minv_scan,
        "aba": lambda x, Us: fused.rollout_fused(m32, x, Us, DT, GRAVITY),
    }
    for route, scan in step_scans.items():
        xk = fused.rollout_fused_multi(m32, x0, U_check, DT, GRAVITY,
                                       route=route)
        xs = scan(x0, U_check)
        xp = fused.rollout_multi_plain(m32, x0, U_check, DT, GRAVITY,
                                       route=route)
        e_plain = (xk - xp).abs().max().item()
        e_scan = (xk - xs).abs().max().item()
        print(f"rollout path {route}: {HONEST_H}-step whole-horizon kernel vs "
              f"plain route max|err| {e_plain:.3e}, vs the scan of its step "
              f"kernel {e_scan:.3e} (bound {HONEST_TOL:g})")
        require(e_plain < HONEST_TOL and e_scan < HONEST_TOL,
                f"the {route} rollout kernel diverges over {HONEST_H} steps")
    for route in ("minv", "aba"):
        before = dict(_lib.launches)
        xf = fused.rollout_fused_multi(m32, x0, U, DT, GRAVITY, route=route)
        torch.cuda.synchronize()
        delta = {k: _lib.launches[k] - before[k] for k in before}
        require(delta["rollout_multi"] == 1 and delta["fd_step"] == 0
                and delta["fd_step_minv"] == 0,
                f"one {route} rollout launched {delta}")
        require(tuple(xf.shape) == (B1, 2 * n), f"final state {xf.shape}")
        require(bool(xf.isfinite().all()), f"non-finite {route} final state")
        ms = cuda_ms(lambda: fused.rollout_fused_multi(
            m32, x0, U, DT, GRAVITY, route=route), reps=7)
        print(f"rollout path {route}: B={B1} H={H1} f32: {ms:.4f} ms per "
              f"rollout (median of 7, CUDA events) = "
              f"{B1 * H1 / (ms / 1e3):.6g} steps/s, one launch; max|x_H| "
              f"{xf.abs().max().item():.4g} on {smi}")
    counts = dict(_lib.launches)
    print(f"rollout path launches: {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.kernels.fused import fd_step_fused
    from rbdtpu_torch.model import load_asset
    from rbdtpu_torch.solver import ee_reaching_cost, trajectory_cost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. identify and build ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    so = _lib.build()
    _lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so}")
    with open(so[:-3] + ".ptxas.log") as f:
        for line in ptxas_summary(f.read()):
            print(line)

    # ---- 2. the DDP path's kernels against their plain versions ----
    m64 = load_asset("arm7", device="cuda", dtype=torch.float64)
    m32 = load_asset("arm7", device="cuda", dtype=torch.float32)
    inputs64 = kernel_inputs(m64, np.random.default_rng(SEED))
    ddp_states = {"fd_step": 128, "feedback_rollout": 1024 * 100,
                  "linearize_parts": 12800, "ee_gn": 12800,
                  "ee_err": 102400}
    rows = check_kernels(
        [(k, k, inputs64[k], {}, k, ddp_states[k]) for k in inputs64],
        m64, m32, smi)

    # ---- 3. the main path: arm7 EE reaching DDP, float32, kernels ----
    Bm, H, iters = 128, 100, 10
    x0, U0 = start_problems(m32, Bm, H, np.random.default_rng(SEED + 1))
    # the starting cost, by the solver's own (kernel) rollout and cost: the
    # open-loop warm start amplifies rounding, so only the same arithmetic
    # reproduces the solver's J0
    xs = [x0]
    for t in range(H):
        xs.append(fd_step_fused(m32, xs[-1], U0[:, t].contiguous(), DT,
                                GRAVITY))
    J0 = trajectory_cost(ee_reaching_cost(m32, TARGET, **WEIGHTS),
                         torch.stack(xs, dim=-2), U0)
    solve(m32, x0, U0, fused=True, iters=iters)  # warm-up
    torch.cuda.synchronize()
    _lib.reset_launches()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, J_hist = solve(m32, x0, U0, fused=True, iters=iters)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    counts = dict(_lib.launches)
    print(f"main path launches (3 solves): {counts}")
    for kname in DDP_KERNELS:
        require(counts[kname] > 0, f"{kname} was not launched on the main path")
        rows[kname]["launches"] = counts[kname]
    require(tuple(J_hist.shape) == (iters, Bm), f"J_hist shape {J_hist.shape}")
    require(bool(J_hist.isfinite().all()), "non-finite J on the main path")
    require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[0] <= J0 * (1 + 1e-6)).all()), "J increased in an iteration")
    require(J_hist[-1].mean() < J0.mean(), "mean J did not fall")
    require(tuple(state.U.shape) == (Bm, H, m32.nv), "U shape")
    sec = statistics.median(times)
    print(f"main path: arm7 EE reaching, Bm={Bm} H={H} iters={iters} f32 "
          f"fused: mean J {J0.mean().item():.4f} -> "
          f"{J_hist[-1].mean().item():.4f}; solve {sec * 1e3:.1f} ms "
          f"(median of {len(times)}, CUDA events) = {Bm / sec:.1f} solves/s "
          f"on {smi}")

    # ---- 4. solver parity in float64: kernels vs plain versions ----
    # At H=100 the open-loop warm start amplifies rounding ~1e9-fold and the
    # weakly penalised controls (w_u=1e-6) follow it, so the bound there
    # also demands that each kernel rounds almost as its plain version does;
    # H=20 is the well-conditioned check.
    for Hp in PARITY_H:
        x0p, U0p = start_problems(m64, 4, Hp, np.random.default_rng(SEED + 2))
        sk, _ = solve(m64, x0p, U0p, fused=True, iters=iters)
        sp, _ = solve(m64, x0p, U0p, fused=False, iters=iters)
        du = (sk.U - sp.U).abs().max().item()
        dj = ((sk.J - sp.J).abs() / sp.J.abs().clamp(min=1)).max().item()
        print(f"parity f64 Bm=4 H={Hp} iters={iters}: max|U_kernel - U_plain| "
              f"{du:.3e} (bound {U_PARITY:g}); max rel |dJ| {dj:.3e}")
        require(du < U_PARITY,
                f"control parity at H={Hp}: {du:.3e} >= {U_PARITY:g}")

    # ---- 5. where the main path's time goes ----
    profile_main_path(m32, x0, U0, iters)

    # ---- 6. the rollout path's kernels against their plain versions, after
    # the DDP path so that its host-bound solve runs in the same process
    # state as before they existed ----
    check_kernels(rollout_inputs(m64, np.random.default_rng(SEED + 3)),
                  m64, m32, smi, rows)

    # ---- 7. the rollout path: 4096 x H=50 arm7 rollouts, float32 ----
    counts = rollout_path(m32, np.random.default_rng(SEED + 4), smi)
    for kname in ROLLOUT_KERNELS:
        require(counts[kname] > 0,
                f"{kname} was not launched on the rollout path")
        rows[kname]["launches"] = counts[kname]
    rows["rnea"]["launches"] = counts["rnea"]

    print(smi)
    print(json.dumps({"kernels": [
        {k: rows[n_][k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for n_ in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
