#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rbdtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending the run with a nonzero exit when it fails:

1. identify the card (name, power limit) and build the CUDA kernels from
   ``rbdtpu_torch/csrc``;
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes of the arm7 end-effector DDP main path: max abs error <= 1e-9 in
   float64, and a relative bound in float32; time both (CUDA events);
3. drive the main path — ``ddp_solve`` on arm7 EE reaching, Bm=128, H=100,
   10 iterations, 8 line-search steps, float32, ``fused=True`` — and check
   that every kernel was launched, that J is finite and nonincreasing and
   that the mean J fell;
4. solve Bm=4 problems in float64 twice, through the kernels and through
   the plain versions on the card, at H=100 (the main path's horizon) and
   at H=20, and require max |U_kernel - U_plain| < 1e-6 (the repository's
   control-parity tolerance) at both;
5. profile one main-path solve: per-phase wall time, torch.profiler's
   device time per kernel, the kernels a solve launches and the device's
   idle share.

The last two lines of standard output are the kernels' JSON summary and
the result line.  Without a CUDA device the script exits nonzero and prints
no result.
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
         "ee_gn": 1e-4, "ee_err": 1e-4}
U_PARITY = 1e-6
PARITY_H = (100, 20)


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
            lambda m, x, u: fused.fd_step_fused(m, x, u, DT, GRAVITY),
            lambda m, x, u: fused.fd_step_plain(m, x, u, DT, GRAVITY),
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
    }


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
            # kernels are plain templates: _Z<len><name>I<d|f>[Lb<0|1>E]...
            m = re.search(r"for _Z(\d+)(\w+)", line)
            name = None
            if m:
                n = int(m.group(1))
                base, tail = m.group(2)[:n], m.group(2)[n:]
                name = (f"{base}<{'double' if tail[1:2] == 'd' else 'float'}"
                        f"{', GN' if tail[2:6] == 'Lb1E' else ''}>")
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

    # ---- 2. every kernel against its plain version ----
    m64 = load_asset("arm7", device="cuda", dtype=torch.float64)
    m32 = load_asset("arm7", device="cuda", dtype=torch.float32)
    inputs64 = kernel_inputs(m64, np.random.default_rng(SEED))
    rows, failures = {}, []
    for kname, (kern, plain, source, replaces) in kernel_table().items():
        a64 = inputs64[kname]
        a32 = tuple(a.float() for a in a64)
        p64 = plain(m64, *a64)
        e64 = errors(kern(m64, *a64), p64, relative=False)
        k32, p32 = kern(m32, *a32), plain(m32, *a32)
        e32 = errors(k32, p32, relative=True)
        torch.cuda.synchronize()
        err64, err32 = max(e64), max(e32)
        if err64 > TOL64:
            failures.append(f"{kname}: float64 max abs error {err64:.3e} > "
                            f"{TOL64:g}")
        if err32 > TOL32[kname]:
            failures.append(f"{kname}: float32 relative error {err32:.3e} > "
                            f"{TOL32[kname]:g}")
        ms = cuda_ms(lambda: kern(m32, *a32), reps=20)
        plain_ms = cuda_ms(lambda: plain(m32, *a32), reps=3)
        shapes = " ".join(str(tuple(a.shape)) for a in a64)
        fmt = lambda es: "[" + " ".join(f"{e:.2e}" for e in es) + "]"
        print(f"kernel {kname}: inputs {shapes}  f64 max|err| {fmt(e64)}  "
              f"f32 rel err {fmt(e32)} (kernel vs f64 plain "
              f"{fmt(errors(k32, p64, relative=True))}, plain vs f64 plain "
              f"{fmt(errors(p32, p64, relative=True))})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms (f32, median, {smi})")
        rows[kname] = dict(name=kname, route="cuda", source=source,
                           replaces=replaces, max_abs_err=err64, ms=ms,
                           plain_ms=plain_ms)
    require(not failures, "; ".join(failures))

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
    for kname in rows:
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

    print(smi)
    print(json.dumps({"kernels": [
        {k: rows[n_][k] for k in ("name", "route", "source", "replaces",
                                  "launches", "max_abs_err", "ms", "plain_ms")}
        for n_ in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
