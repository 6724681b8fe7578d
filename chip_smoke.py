#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rbdtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending the run with a nonzero exit when it fails:

1. identify the card (name, power limit), build the CUDA kernels from
   ``rbdtpu_torch/csrc`` and require every instantiation of the team
   kernels K1 (``fd_step``), K2 (``feedback_rollout``), K3
   (``linearize_parts``), K5 (``rollout_multi``), K6 (``fd_step_minv``),
   K9 (``feedback_chunked``) and K10 (``rnea``), of the end-effector
   kernels K4 (``ee_gn``, ``ee_err``) and of the Riccati sweeps
   (``riccati``, K7/K8, and ``riccati_fused``, K11) in the build with a
   ptxas stack frame under 1,024 bytes;
2. hold each kernel of the DDP path against its plain PyTorch version on
   the card, at that path's shapes: max abs error <= 1e-9 in float64, and
   a relative bound in float32; time both (CUDA events around one call
   with its launch; K1-K6, K9, K10 and the Riccati sweeps also by
   replaying a CUDA graph of 20 calls, the device's time alone) and
   compute each kernel's
   bound (bytes over the memory rate, or operations over the float32 peak,
   whichever is larger; the operations each function needs are counted by
   ``rbdtpu_torch/opcount.py``); then
   K1 at 1, 37 and 1000 states and under world wrenches (one set, one per
   state), K2 over one knot at 1 and 37 trajectories with and without a
   clamp and at 37 over the horizon, in both dtypes; print the team
   kernels' launch geometry (team size, teams and shared memory a block,
   K2's walk of the step's recursions);
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
   the DDP phases, which therefore run as they did before these kernels):
   K10 (bias and with qdd) and K6 (both routes, without wrenches, under
   one set shared by the batch and under one set a state) at 4096 states,
   K5 on both routes, with and without per-step wrenches (H, nb, 6);
7. drive the forward-dynamics rollout path (BASELINE.json configs[1]) on
   bench.py's inputs: 4096 arm7 trajectories x H=50, float32, K5's launch
   geometry (team size, teams and shared memory a block) in both dtypes,
   the 10-step check of the whole-horizon kernel against the scan of its
   step kernel and against the plain route (< 1e-3), then
   ``rollout_fused_multi`` timed on the "minv" and "aba" routes (steps/s),
   each call one launch; every kernel of the path must have been launched
   and the final states finite;
8. hold the Riccati sweep kernel against the plain sweep at configs[3]'s
   shape (B=1024, H=50, nx=36, nu=18, constant cost blocks), at B=4 (the
   small-batch call site), at the humanoid's (B=16, H=32, nx=72, nu=36,
   per-knot cost blocks, above 48 KB of shared memory in float64) and at
   paths C and D's (B=16 and B=256, H=32, nx=72, nu=36, the tracking
   cost's constant blocks; the small-batch and the lane call site), each
   with the split it took (one block a problem, its threads): float64
   relative error <= 1e-9, float32 <= 1e-4, each timed (one call, and by
   graph replay) beside its bound; and on a batch with one non-PD problem,
   whose NaN gains and ok must be the plain sweep's;
9. hold K1, K2 and K3 on quadruped12's rpy floating root against their
   plain versions at configs[3]'s shapes (1024 states, 6 x 1024
   trajectories of 50 knots, 51,200 knots), with the team kernels' extra
   checks and times, as in phase 2, and K10 and K6 at its 1024 states as
   in phase 6;
10. drive the floating-base quadruped MPC path (BASELINE.json configs[3],
   bench.py:482-507): ``ddp_solve`` of 1024 problems, H=50, 5 iterations,
   6 line-search steps, float32, ``fused=True``, timed (solves/s); per
   solve K1 50 launches, K2, K3 and the sweep kernel 5, the plain sweep
   none; J finite, nonincreasing and falling; then its profile;
11. solve the configs[3] problem in float64 through the kernels and
   through the plain versions at Bm=4, H=50, 5 iterations (the sweep's
   small-batch call site) and at Bm=130, H=10, 2 iterations (its lane
   call site): max |U_kernel - U_plain| < 1e-6 at both;
12. hold the arm-class Riccati sweep kernel (K11, ``riccati_fused``)
   against the plain sweep at configs[2]'s shape (B=128, H=100, nx=14,
   nu=7) with per-knot and with constant cost blocks, at B=1 and at B=4,
   each with the split it took (one block a problem, its threads and
   shared bytes, in both dtypes): float64 relative error <= 1e-9, float32
   <= 1e-4, each timed (one call, and by graph replay) beside the plain
   sweep, beside the chunked sweep kernel (K7) on the same inputs (timed
   both ways) and beside its bound; and on a batch with one non-PD
   problem;
13. path A: the configs[2] solve of phase 3 with ``fused_riccati=True``:
   per solve ``riccati_fused`` 10 launches, the plain sweep none; J finite,
   nonincreasing and falling; its profile; float64 control parity against
   the plain route at Bm=4, H=20 and H=100 (< 1e-6);
14. path B: the closed-loop MPC loop of examples/mpc_reaching.py with the
   kernels (``mpc_run``: configs[2]'s cost and dt, H=100, 50 ticks,
   ``DDPConfig(iters=3, n_alphas=4, fused=True)``, float32) at Bm=1
   under the plain sweep, K11 and the parallel-in-time scan, and at
   Bm=128 under K11 and the plain sweep: ms per tick, the end effector's
   distance to the target (must fall), finite controls and states, J
   finite at Bm=1 (at Bm=128 the robots whose J overflowed are printed);
   K11 against the plain sweep on the controls applied over 5 ticks at
   Bm=2, H=20, float64 (< 1e-6); a solver-state checkpoint written and
   read back on the card bit for bit;
15. the humanoid's kernels (humanoid30, rpy root, the "fb32" size class):
   K1, K2 and K3 against their plain versions at paths C and D's shapes
   (2048 states, 1024 trajectories x 32 knots, 8192 knots), as in phase 2,
   and K10 and K6 at path C's 2048 states as in phase 6, with the
   per-thread stack limit and the device memory outside PyTorch's pool
   before and after them (none may move the limit), then the team
   kernels' extra checks and times; K9
   (``feedback_chunked``, K2's team body with rbdtpu's chunked sum) at
   nchunks 2, 1, 3 and 100 with and without a clamp, at an odd batch, on
   arm7 and on the rpy quadruped, with the stack limit before and after
   (K9 at fb32 in float64 must leave it where it was), and against K2 on
   the same inputs (float64 <= 1e-9, both timed by one call and by graph
   replay);
16. path C, BASELINE.json configs[4] (bench.py:539-590): ``hybrid_solve``
   of 16 humanoid problems, H=32, 4 MPPI iterations of 128 samples then 4
   DDP iterations of 4 line-search steps, float32, every kernel on: solve
   time, the MPPI and DDP stages apart, launch counts (K1, K2, K3 and the
   small-batch sweep; no K9), both J histories finite and falling; then
   the hybrid in float64 at the same shapes, through the kernels and
   through the plain route (``fused=False``), fed the same standard
   normals, at configs[4]'s sigma and at a sigma small enough that MPPI
   replaces its nominal plan: |dU| < 1e-6 and relative |dJ| < 1e-9 over
   both J histories, and at the small sigma MPPI must have moved;
17. path D, the DDP stage at 256 problems (tools/bench_chunked.py) with
   ``fused_feedback=True``, which rbdtpu's rule sends to K9 with two
   chunks: one K9 launch an iteration and no K2, J falling, its profile,
   the same solve timed on the K2 tier and on the plain pass; then the K9
   tier against the K2 tier in float64 at 142 problems (|dU| < 1e-6,
   relative |dJ| < 1e-9);
18. path E, quadruped foot reaching (bench.py:509-537): K4's fb16
   instantiation (``ee_gn``, ``ee_err`` on the rpy root) against its plain
   version at the path's shapes (ee_gn at 51,200 knots and 1,024 terminal
   states, ee_err at the line search's 307,200 and 6,144), timed by one
   call and by graph replay beside its bound; then ``ddp_solve`` of 1,024
   quadrupeds reaching a foot target, H=50, 5 iterations, 6 line-search
   steps, float32, ``fused=True``: ms a solve, each kernel's launches a
   solve (K1 50, K2, K3 and K7 5, ee_gn 10, ee_err 12; the plain sweep
   none), J finite, nonincreasing and falling, its profile; and float64
   kernels against plain at Bm=4, H=50 and H=20 (|dU| < 1e-6);
19. path F, robust MPC under world wrenches: K2 and K9 (nchunks 1, 2, 3)
   with a per-knot wrench set (a trunk push window on 0.5 N(0,1)) against
   their plain versions on arm7 (1,024 x 100), the rpy quadruped
   (configs[3]'s 6 x 1,024 x 50) and the humanoid (path D's 1,024 x 32),
   each timed, and with all-zero wrenches equal to the wrench-free
   kernels bit for bit; the port's push-recovery example on the card (the
   aware plan must beat the oblivious one, K1 and K2 launched with
   wrenches); configs[3]'s solve at full width under a push (ms a solve,
   launches, J falling); float64 kernels against plain under the push at
   Bm=4, H=50 (|dU| < 1e-6); path D under a trunk push (K9 with wrenches
   once an iteration, no wrench-free K9 or K2); and the hybrid at path C's
   shapes under a 20 N trunk push in float64, kernels against plain on the
   same normals (|dU| < 1e-6, relative |dJ| < 1e-9), beside the plain
   route's own parting when its start moves by 1e-13.

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
         "rollout_multi": 1e-3, "riccati": 1e-4, "riccati_fused": 1e-4,
         "feedback_chunked": 1e-3, "feedback_rollout_fext": 1e-3,
         "feedback_chunked_fext": 1e-3}
U_PARITY = 1e-6
PARITY_H = (100, 20)
# the team kernels (csrc/rbd_team.cuh): one team of lanes per state (K1),
# trajectory (K2, K5, K9) or knot (K3); their ptxas stack, the end-effector
# kernels' (K4) and the Riccati sweeps' must stay under STACK_MAX bytes in
# every instantiation (3 classes x 2 dtypes at the team size of
# kernels/_lib.py TEAM, K1 with and without wrenches, K2 and K9 in both
# walks, K10 with and without qdd, K6 on both routes with and without
# wrenches; K5 on n8 in 2 dtypes x 2 routes x with and without wrenches; K4
# and each sweep in 2 dtypes; K4 on the rpy root and K2 and K9 with
# wrenches at every class in both walks), and K1/K2's extra checks run these
# batches
TEAM_KERNELS = ("fd_step", "feedback_rollout")
STACK_INSTANCES = {"fd_step": 12, "feedback_rollout": 12,
                   "linearize_parts": 6, "feedback_chunked": 12,
                   "rollout_multi": 8, "ee_gn": 2, "ee_err": 2,
                   "riccati": 2, "riccati_fused": 2, "rnea": 12,
                   "fd_step_minv": 24, "ee_gn_rpy": 2, "ee_err_rpy": 2,
                   "feedback_rollout_fext": 12, "feedback_chunked_fext": 12}
# the kernels whose rows add graph_ms, the device's time by graph replay
GRAPH_KERNELS = ("fd_step", "feedback_rollout", "linearize_parts",
                 "feedback_chunked", "rollout_multi", "ee_gn", "ee_err",
                 "rnea", "fd_step_minv", "feedback_rollout_fext",
                 "feedback_chunked_fext")
STACK_MAX = 1024
TEAM_BATCHES = (1, 37, 1000)
# the rollout path (BASELINE.json configs[1], bench.py:132-209, 377-416)
B1, H1, HONEST_H, HONEST_TOL = 4096, 50, 10, 1e-3
# H100 SXM published peaks at 700 W: HBM bytes/s, float32 and float64
# operations/s outside the tensor cores
PEAK_BYTES, PEAK_OPS = 3.35e12, {"float32": 67e12, "float64": 34e12}
# the floating-base quadruped MPC path (BASELINE.json configs[3],
# bench.py:482-507): Bm problems, H knots, iterations, line-search steps,
# tracking weights; its control parity at the sweep's two call sites,
# (Bm, H, iterations) below and above 128 problems
B3, H3, ITERS3, ALPHAS3 = 1024, 50, 5, 6
W3 = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
PARITY3 = ((4, 50, 5), (130, 10, 2))
# the humanoid paths: humanoid30 on the rpy root, tracking weights to a
# standing height of 0.95.  Path C is BASELINE.json configs[4]
# (bench.py:539-590): Bm problems, H knots, MPPI samples, noise scale and
# iterations, then DDP iterations and line-search steps.  Path D is its DDP
# stage at fleet batch (tools/bench_chunked.py), whose line search takes
# K9; its float64 tier parity runs at the smallest batch where rbdtpu's
# rule picks K9 with two chunks.  K9 is checked at these chunk counts.
BH, HH, SAMPLES_H, SIGMA_H, MPPI_ITERS_H = 16, 32, 128, 0.3, 4
# a noise scale at which MPPI beats the nominal plan on path C's problems
# (at configs[4]'s sigma every sample rolls out worse than the nominal)
SIGMA_MOVE = 3e-4
ITERS_H, ALPHAS_H = 4, 4
WH = dict(w_q=2.0, w_qd=0.05, w_u=1e-5)
BD, BD_PARITY, NCHUNKS_D = 256, 142, 2
NCHUNKS_CHECKS = (2, 1, 3, 100)
# the Riccati sweep's checks: (label, problems, knots, nx, nu, constant cost
# blocks): configs[3]'s shape, the small-batch call site, a humanoid batch
# with per-knot blocks, and the humanoid paths' shapes with the tracking
# cost's constant blocks (path C: K8; path D: K7)
RICCATI_CASES = (("configs[3]", B3, H3, 36, 18, True),
                 ("small batch", 4, H3, 36, 18, True),
                 ("humanoid", 16, 32, 72, 36, False),
                 ("path C", BH, HH, 72, 36, True),
                 ("path D", BD, HH, 72, 36, True))
# the arm-class sweep's (K11) checks, in the same form: configs[2]'s shape
# (the EE cost's blocks are per knot), with constant blocks, one robot, four
RICCATI_FUSED_CASES = (("configs[2]", 128, 100, 14, 7, False),
                       ("configs[2] constant", 128, 100, 14, 7, True),
                       ("one robot", 1, 100, 14, 7, False),
                       ("four robots", 4, 100, 14, 7, True))
# the MPC loop (examples/mpc_reaching.py:57-63 with the kernels): horizon,
# ticks, iterations and line-search steps a tick, and the K11-vs-plain
# check (problems, knots, ticks)
MPC_H, MPC_TICKS, MPC_ITERS, MPC_ALPHAS = 100, 50, 3, 4
MPC_PARITY = (2, 20, 5)
# path E, quadruped foot reaching (bench.py:509-537): configs[3]'s problems
# and solver, the first leaf joint's target and weights; its float64
# control parity at Bm=4 over these horizons
TARGET_E = (0.3, 0.1, 0.1)
WE = dict(w_ee=10.0, w_ee_f=500.0, w_qd=1e-2, w_u=1e-5)
PARITY_E = (50, 20)
# path F, robust MPC: a push on the trunk (body 0) of PUSH_N newtons along
# +y for the knots of PUSH_KNOTS (examples/push_recovery.py's), over
# 0.5 N(0,1) wrenches on every body for the kernel checks; K9's counts.
# The hybrid's float64 parity holds |dJ| within TOL64 under PUSH_HYBRID_N.
# Under PUSH_N the humanoid hybrid's plain route alone parts from itself by
# about 5e-10 relative in J when x0 moves by 1e-13 relative, so there the
# bound on |dJ| is FLOOR_TIMES that floor, measured in the same run: a
# wrong wrench moves J by far more (the push raises it 180-fold).
PUSH_N, PUSH_KNOTS, PUSH_HYBRID_N, FLOOR_TIMES = 80.0, (5, 15), 20.0, 100.0
NCHUNKS_F = (1, 2, 3)


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


def graph_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one ``fn`` call on the device alone: after a
    warm-up call, ``reps`` calls captured in one CUDA graph, the graph
    replayed 5 times, each replay timed by CUDA events.  The host's cost of
    a launch, which the single-call events of ``cuda_ms`` take in whenever
    it exceeds the kernel's time, is not in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(args, outs, model, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (every input tensor, the model tables unless ``model`` is None, and
    every output once) over the memory rate and its operations (``ops``,
    the algorithm's count from ``rbdtpu_torch/opcount.py``) over the peak
    rate of ``dtype``."""
    import torch
    from rbdtpu_torch.kernels import _lib

    if not isinstance(outs, tuple):
        outs = (outs,)
    tensors = [t for t in (*args, *outs) if isinstance(t, torch.Tensor)]
    if model is not None:
        tensors += list(_lib.model_tables(model, model.device, model.dtype))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
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
        return (lambda m, q, **kw: fk_lane.ee_gn_fused(m, q, TARGET, gn=gn,
                                                       **kw),
                lambda m, q, **kw: fk_lane.ee_gn_plain(m, q, TARGET, gn=gn,
                                                       **kw))

    table = {
        "fd_step": (
            lambda m, x, u, **kw: fused.fd_step_fused(m, x, u, DT, GRAVITY,
                                                      **kw),
            lambda m, x, u, **kw: fused.fd_step_plain(m, x, u, DT, GRAVITY,
                                                      **kw),
            "rbdtpu_torch/csrc/fd_step.cu", "rbdtpu/kernels/fused.py:450"),
        "feedback_rollout": (
            lambda m, *a, **kw: fused.feedback_rollout_fused(m, *a, DT, GRAVITY,
                                                             **kw),
            lambda m, *a, **kw: fused.feedback_rollout_plain(m, *a, DT, GRAVITY,
                                                             **kw),
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
        "feedback_chunked": (
            lambda m, *a, **kw: fused.feedback_rollout_fused_chunked(
                m, *a, DT, GRAVITY, **kw),
            lambda m, *a, **kw: fused.feedback_rollout_chunked_plain(
                m, *a, DT, GRAVITY, **kw),
            "rbdtpu_torch/csrc/feedback_chunked.cu",
            "rbdtpu/kernels/fused.py:819"),
    }
    # K2 and K9 with wrenches: the same entry points given f_ext
    table["feedback_rollout_fext"] = table["feedback_rollout"]
    table["feedback_chunked_fext"] = table["feedback_chunked"]
    return table


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
    U_minv, U_aba = T(0.5, H1, B1, n), T(0.2, H1, B1, n)
    F1, FB, FH = T(0.5, nb, 6), T(0.5, B1, nb, 6), T(0.5, H1, nb, 6)
    return [
        *minv_rnea_checks(model64, (x0, u), "", qdd, (F1, FB)),
        ("rollout_multi minv", "rollout_multi", (x0, U_minv),
         {"route": "minv"}, "fd_step_minv", B1 * H1),
        ("rollout_multi aba", "rollout_multi", (x0, U_aba),
         {"route": "aba"}, "fd_step", B1 * H1),
        ("rollout_multi aba f_ext (H,nb,6)", "rollout_multi", (x0, U_aba),
         {"route": "aba", "f_ext": FH}, "fd_step+fext", B1 * H1),
        ("rollout_multi minv f_ext (H,nb,6)", "rollout_multi", (x0, U_minv),
         {"route": "minv", "f_ext": FH}, "fd_step_minv+fext", B1 * H1),
        ("fd_step f_ext (nb,6)", "fd_step", (x0, u), {"f_ext": F1},
         "fd_step+fext", B1),
        ("fd_step f_ext (B,nb,6)", "fd_step", (x0, u), {"f_ext": FB},
         "fd_step+fext", B1),
    ]


def minv_rnea_checks(model64, fd, tag: str, qdd, wrenches) -> list:
    """K10's and K6's checks at one model's step states ``fd`` = (x, u)
    (float64), in ``check_kernels``'s form: K10 without qdd (the bias) and
    with ``qdd``; K6 on the factorised and the dense route, and on each
    under ``wrenches`` = (one set shared by the batch (nb, 6), one a state
    (B, nb, 6)), the first on the factorised route, the second on the
    dense one."""
    x, u = fd
    B, n = x.shape[0], model64.nv
    q, qd = x[:, :n].contiguous(), x[:, n:].contiguous()
    F1, FB = wrenches
    sp = " " if tag else ""
    return [
        (f"rnea{sp}{tag} bias", "rnea", (q, qd), {}, "rnea", B),
        (f"rnea{sp}{tag} qdd", "rnea", (q, qd, qdd), {}, "rnea+qdd", B),
        (f"fd_step_minv{sp}{tag}", "fd_step_minv", (x, u), {},
         "fd_step_minv", B),
        (f"fd_step_minv{sp}{tag} dense", "fd_step_minv", (x, u),
         {"dense_minv": True}, "fd_step_minv+dense", B),
        (f"fd_step_minv{sp}{tag} f_ext (nb,6)", "fd_step_minv", (x, u),
         {"f_ext": F1}, "fd_step_minv+fext", B),
        (f"fd_step_minv{sp}{tag} dense f_ext (B,nb,6)", "fd_step_minv",
         (x, u), {"dense_minv": True, "f_ext": FB},
         "fd_step_minv+dense+fext", B),
    ]


def step_extras(model64, B: int, seed: int):
    """``minv_rnea_checks``' qdd and wrenches for B states of ``model64``,
    each 0.5 N(0,1), float64, drawn from ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    T = lambda *s: torch.tensor(0.5 * rng.standard_normal(s),
                                dtype=torch.float64, device=model64.device)
    return T(B, model64.nv), (T(model64.nb, 6), T(B, model64.nb, 6))


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


def solve(model, x0, U0, fused: bool, iters: int, **options):
    """configs[2]'s ``ddp_solve``; ``options`` are further DDPConfig
    fields (the backward pass's)."""
    from rbdtpu_torch.solver import DDPConfig, ddp_solve, ee_reaching_cost

    cost = ee_reaching_cost(model, TARGET, fused=None if fused else False,
                            **WEIGHTS)
    cfg = DDPConfig(iters=iters, dt=DT, gravity=GRAVITY, n_alphas=8,
                    fused=fused, **options)
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


_TEMPLATE_ARG = re.compile(
    r"N3rbd4DimsILi(\d+)ELb([01])EEE|Lb([01])E|([fd])|Li(\d+)E")


def template_args(tail: str) -> list:
    """The template arguments of a mangled kernel name's tail
    (``I...E``): the scalar type, the size class ``Dims<NB, FB>``, the
    bools (GN, HAS_QDD, DENSE, MINV or FEXT) and the ints (a team's
    lanes)."""
    args, pos = [], 1
    while pos < len(tail) and tail[pos] != "E":
        m = _TEMPLATE_ARG.match(tail, pos)
        if not m:
            break
        if m.group(1):
            args.append(f"Dims<{m.group(1)}, "
                        f"{'true' if m.group(2) == '1' else 'false'}>")
        elif m.group(3):
            args.append("true" if m.group(3) == "1" else "false")
        elif m.group(5):
            args.append(m.group(5))
        else:
            args.append("double" if m.group(4) == "d" else "float")
        pos = m.end()
    return args


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    registers, stack frame and spill bytes a thread."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"for _Z(\d+)(\w+)", line)
            name = None
            if m:
                n = int(m.group(1))
                base, tail = m.group(2)[:n], m.group(2)[n:]
                name = f"{base}<{', '.join(template_args(tail))}>"
        elif name and "bytes stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"ptxas {name}: {regs} registers, {frame}")
            name = None
    return out


def profile_main_path(solve_once, extra=()):
    """Where one solve (``solve_once()``) spends its time: per-phase wall
    time (each phase synchronised, so the total exceeds an unsynchronised
    solve; ``extra`` names further phases of ``solver.ddp``), then
    torch.profiler's device time per kernel, the kernels launched per solve
    and the device's idle share against an unprofiled solve."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from rbdtpu_torch.solver import ddp

    def run():
        solve_once()
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
        "backward_pass", "backward_pass_chunked", "forward_pass_fused",
        *extra)}
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


def check_kernels(checks, m64, m32, smi: str, rows=None, row_tag: str = "",
                  time_all: bool = True, ee_names=None) -> dict:
    """Hold each kernel against its plain version (float64 max abs error
    <= TOL64, float32 relative error <= TOL32), time both in float32 and
    compute the bound.  ``checks``: (label, kernel name, float64 args,
    keyword args, operations key, states x steps).  The first check of a
    kernel gives its row of the JSON line (named kernel name + row_tag);
    the row's max_abs_err is the largest over the kernel's checks.  With
    ``time_all=False`` only that first check is timed.  ``ms`` is one
    call's time with its launch (``cuda_ms``) for every kernel; the rows
    of GRAPH_KERNELS add the device's time alone (``graph_ms``).  Fails
    after printing every check.  ``ee_names`` names K4's end effector on a
    model of several leaves (for its operation count)."""
    import torch
    from rbdtpu_torch import opcount

    flops = opcount.per_state(m32, TARGET, ee_names=ee_names)
    table = kernel_table()
    rows = {} if rows is None else rows
    failures = []
    for label, kname, a64, kw, ops_key, states in checks:
        kern, plain, source, replaces = table[kname]
        row = kname + row_tag
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
        ops = flops[ops_key] * states
        bound_ms, bound_by = bound((*a32, *kw32.values()), k32, m32, ops,
                                   "float32")
        shapes = " ".join(str(tuple(a.shape)) for a in a64)
        fmt = lambda es: "[" + " ".join(f"{e:.2e}" for e in es) + "]"
        timing, gms = "not timed", None
        if time_all or row not in rows:
            ms = cuda_ms(lambda: kern(m32, *a32, **kw32), reps=20)
            plain_ms = cuda_ms(lambda: plain(m32, *a32, **kw32), reps=3)
            timing = f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
            if kname in GRAPH_KERNELS:
                gms = graph_ms(lambda: kern(m32, *a32, **kw32))
                timing += f" ({gms:.4f} ms by graph replay)"
        print(f"kernel {label}: inputs {shapes}  f64 max|err| "
              f"{fmt(e64)}  f32 rel err {fmt(e32)} (kernel vs f64 plain "
              f"{fmt(errors(k32, p64, relative=True))}, plain vs f64 plain "
              f"{fmt(errors(p32, p64, relative=True))})  {timing}  bound "
              f"{bound_ms:.6f} ms by {bound_by} ({ops:.4g} operations) (f32, "
              f"median, {smi})")
        if row not in rows:
            rows[row] = dict(name=row, route="cuda", source=source,
                             replaces=replaces, max_abs_err=err64, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
            if gms is not None:
                rows[row]["graph_ms"] = gms
        rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], err64)
    require(not failures, "; ".join(failures))
    return rows


def team_stack_check(ptxas: list):
    """Phase 1: every instantiation of the kernels of STACK_INSTANCES is in
    the build and none has a stack frame of STACK_MAX bytes or more."""
    for k in STACK_INSTANCES:
        lines = [ln for ln in ptxas if ln.startswith(f"ptxas {k}_kernel<")]
        stacks = [int(re.search(r"(\d+) bytes stack frame", ln).group(1))
                  for ln in lines]
        require(len(lines) == STACK_INSTANCES[k],
                f"{k}: {len(lines)} instantiations in the build, expected "
                f"{STACK_INSTANCES[k]}")
        require(max(stacks) < STACK_MAX, f"{k}: a stack frame of "
                f"{max(stacks)} B a thread (limit {STACK_MAX})")
        print(f"ptxas {k}: {len(lines)} instantiations, stack frames "
              f"{min(stacks)}-{max(stacks)} B a thread (limit {STACK_MAX})")


def team_checks(m64, fd, fb, tag: str) -> list:
    """The team kernels' extra checks at one size class, from its path's
    float64 inputs ``fd`` = (x, u) and ``fb`` (K2's five): K1 at
    TEAM_BATCHES states (rows of fd repeated as needed) and at 37 states
    under one wrench set and under one set per state (0.5 N(0,1)); K2 at 1
    and 37 trajectories over one knot, with and without a clamp at 0.8 of
    the largest first control each coordinate takes unclamped, and at 37
    over the path's horizon.  Entries as ``check_kernels`` takes them."""
    import torch
    from rbdtpu_torch.kernels import fused

    x, u = fd
    rows = lambda t, B: t.repeat(-(-B // t.shape[0]), 1)[:B].contiguous()
    checks = [(f"fd_step {tag} B={B}", "fd_step", (rows(x, B), rows(u, B)),
               {}, "fd_step", B) for B in TEAM_BATCHES]
    rng = np.random.default_rng(SEED + 7)
    wrench = lambda *shape: torch.tensor(
        0.5 * rng.standard_normal(shape), dtype=torch.float64,
        device=m64.device)
    for label, f in (("(nb,6)", wrench(m64.nb, 6)),
                     ("(B,nb,6)", wrench(37, m64.nb, 6))):
        checks.append((f"fd_step {tag} B=37 f_ext {label}", "fd_step",
                       (rows(x, 37), rows(u, 37)), {"f_ext": f},
                       "fd_step+fext", 37))
    first = tuple((t[:64, :1] if t.dim() > 2 else t[:64]).contiguous()
                  for t in fb)
    applied = fused.feedback_rollout_plain(m64, *first, DT, GRAVITY)[1]
    clip = (0.8 * applied.abs().amax(dim=(0, 1))).contiguous()
    for B in (1, 37):
        one = tuple((t[:B, :1] if t.dim() > 2 else t[:B]).contiguous()
                    for t in fb)
        for kw in ({}, {"u_clip": clip}):
            checks.append((f"feedback_rollout {tag} B={B} H=1"
                           f"{' u_clip' if kw else ''}", "feedback_rollout",
                           one, kw, "feedback_rollout", B))
    H = fb[1].shape[1]
    checks.append((f"feedback_rollout {tag} B=37 H={H}", "feedback_rollout",
                   tuple(t[:37].contiguous() for t in fb), {},
                   "feedback_rollout", 37 * H))
    return checks


def team_report(label: str, m64, m32, fd, fb):
    """The team kernels' launch geometry at one size class's path shapes
    (``fd`` and ``fb`` as ``team_checks`` takes them), in float32 and
    float64: team size, teams a block, shared memory a block, blocks, and
    K2's walk of the step's root->leaf recursions."""
    from rbdtpu_torch.kernels import _lib

    cls = _lib.size_class("fd_step", m32)
    for m in (m32, m64):
        sfx = _lib._SUFFIX[m.dtype]
        for kernel, B in (("fd_step", fd[0].shape[0]),
                          ("feedback_rollout", fb[2].shape[0])):
            team, tpb, smem, blocks = _lib.team_geometry(
                kernel, cls, m.dtype, B, _lib.sm_count(m.device))
            walk = ("levels" if kernel == "feedback_rollout"
                    and _lib.level_walk(m) else "bodies")
            print(f"team {label} {kernel} {cls} {sfx}: B={B} team {team} "
                  f"lanes, {tpb} teams a block, {smem} B of shared memory a "
                  f"block, {blocks} blocks, walk {walk}")


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
    for dtype in (torch.float32, torch.float64):
        team, tpb, smem, blocks = _lib.team_geometry(
            "rollout_multi", "n8", dtype, B1, _lib.sm_count(m32.device))
        print(f"team rollout_multi n8 {_lib._SUFFIX[dtype]}: B={B1} team "
              f"{team} lanes, {tpb} teams a block, {smem} B of shared memory "
              f"a block, {blocks} blocks")
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


def riccati_problem(rng, nx, nv, H, Bm, const, non_pd=None):
    """A random, well-conditioned Riccati problem, built as
    tests/test_riccati_strategy.py (and tests/riccati_problems.py) build
    them; ``const`` gives unbatched (n, m) cost blocks, ``non_pd`` =
    (problem, knot) a negative definite luu there."""
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    rnd = lambda *s: rng.standard_normal(s)
    A = 0.1 * rnd(Bm, H, nx, nx) + np.eye(nx)
    Bmat = 0.1 * rnd(Bm, H, nx, nv)
    lx, lu = rnd(Bm, H, nx), rnd(Bm, H, nv)
    lfx = rnd(Bm, nx)
    lfxx = sym(np.eye(nx) + 0.1 * rnd(Bm, nx, nx))
    lfxx = lfxx @ np.swapaxes(lfxx, -1, -2)
    reg = rng.uniform(1e-6, 1e-2, Bm)
    lead = () if const else (Bm, H)
    lxx = sym(0.05 * rnd(*lead, nx, nx)) + 2.0 * np.eye(nx)
    luu = sym(0.05 * rnd(*lead, nv, nv)) + 2.0 * np.eye(nv)
    lux = 0.05 * rnd(*lead, nv, nx)
    if non_pd is not None:
        luu[non_pd] = -5.0 * np.eye(nv)
    return (A, Bmat, lx, lu, lxx, luu, lux, lfx, lfxx, reg)


# each sweep kernel's row: (source, replaces)
SWEEP_ROWS = {
    "riccati_chunk": ("rbdtpu_torch/csrc/riccati_chunk.cu",
                      "rbdtpu/kernels/riccati_chunk.py:523"),
    "riccati_small": ("rbdtpu_torch/csrc/riccati_chunk.cu",
                      "rbdtpu/kernels/riccati_chunk.py:334"),
    "riccati_fused": ("rbdtpu_torch/csrc/riccati_fused.cu",
                      "rbdtpu/kernels/riccati.py:102"),
}


def check_riccati(smi: str, rows: dict):
    """The chunked sweep kernel against the plain sweep: RICCATI_CASES,
    then a configs[3]-shaped batch with one non-PD problem.  Adds the rows
    of riccati_chunk (K7, batch >= 128) and riccati_small (K8)."""
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.kernels.riccati_chunk import (
        LANE_BATCH, backward_pass_chunked,
    )

    check_sweep(smi, rows, "riccati", backward_pass_chunked, RICCATI_CASES,
                lambda B: "riccati_chunk" if B >= LANE_BATCH
                else "riccati_small", (B3, H3, 36, 18, (7, H3 // 2)),
                (SEED + 10, SEED + 20), split=_lib.riccati_geometry)


def check_riccati_fused(smi: str, rows: dict):
    """The arm-class sweep kernel (K11) against the plain sweep:
    RICCATI_FUSED_CASES, each with its split and also timed through the
    chunked sweep kernel on the same inputs, then a configs[2]-shaped batch
    with one non-PD problem.  Adds the row of riccati_fused."""
    from rbdtpu_torch.kernels import (
        _lib, backward_pass_chunked, backward_pass_fused,
    )

    check_sweep(smi, rows, "riccati_fused", backward_pass_fused,
                RICCATI_FUSED_CASES, lambda B: "riccati_fused",
                (128, 100, 14, 7, (7, 50)), (SEED + 50, SEED + 60),
                beside=("K7 kernel", backward_pass_chunked),
                split=_lib.riccati_fused_geometry)


def check_sweep(smi: str, rows: dict, tag: str, kernel, cases, row_name,
                non_pd, seeds, beside=None, split=None):
    """A sweep kernel's wrapper ``kernel`` against the plain sweep
    (``solver.ddp.backward_pass``) on the card: each of ``cases`` (label,
    B, H, nx, nu, constant cost blocks) in float64 (max error relative to
    each output's scale <= TOL64) and float32 (<= TOL32[tag]), every ok
    True, timed in float32 beside its bound (and beside ``beside`` =
    (label, wrapper), another sweep on the same inputs); then, in float64,
    a batch ``non_pd`` = (B, H, nx, nu, (problem, knot)) whose one problem
    has a Quu that is not positive definite at one knot: the NaN entries
    and ok must be the plain sweep's, the finite entries within TOL64.
    ``row_name(B)`` names the JSON row a case belongs to; ``seeds`` seed
    the first case (the next ones count up) and the non-PD batch.  With
    ``split`` (the kernel's geometry function, ``_lib.riccati_geometry``
    or ``_lib.riccati_fused_geometry``) each case also prints the launch's
    split in both dtypes (one block a problem, its threads and shared
    bytes) and is timed by graph replay as well, which the row keeps as
    ``graph_ms``; ``beside`` is then timed both ways too.  Fails after
    printing every check."""
    import torch
    from rbdtpu_torch import opcount
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver.ddp import backward_pass

    def cuda(args, dtype):
        return tuple(torch.tensor(a, dtype=dtype, device="cuda")
                     for a in args)

    fmt = lambda es: "[" + " ".join(f"{e:.2e}" for e in es) + "]"
    failures = []
    for i, (label, B, H, nx, nu, const) in enumerate(cases):
        name = row_name(B)
        prob = riccati_problem(np.random.default_rng(seeds[0] + i), nx, nu,
                               H, B, const)
        a64, a32 = cuda(prob, torch.float64), cuda(prob, torch.float32)
        k64, p64 = kernel(*a64), backward_pass(*a64)
        k32, p32 = kernel(*a32), backward_pass(*a32)
        torch.cuda.synchronize()
        e64 = errors(k64[:3], p64[:3], relative=True)
        abs64 = errors(k64[:3], p64[:3], relative=False)
        e32 = errors(k32[:3], p32[:3], relative=True)
        oks = [o.tolist() for o in (k64[3], p64[3], k32[3], p32[3])]
        if max(e64) > TOL64:
            failures.append(f"{tag} {label}: float64 relative error "
                            f"{max(e64):.3e} > {TOL64:g}")
        if max(e32) > TOL32[tag]:
            failures.append(f"{tag} {label}: float32 relative error "
                            f"{max(e32):.3e} > {TOL32[tag]:g}")
        if any(ok != [True] * B for ok in oks):
            failures.append(f"{tag} {label}: a well-conditioned problem "
                            "was reported not positive definite")
        ms = cuda_ms(lambda: kernel(*a32), reps=20)
        plain_ms = cuda_ms(lambda: backward_pass(*a32), reps=3)
        also, gms = "", None
        if split is not None:
            gms = graph_ms(lambda: kernel(*a32))
            also = f" ({gms:.4f} ms by graph replay)"
            for a in (a64, a32):
                nt, smem, blocks = split(nx, nu, a[0].dtype, B,
                                         _lib.sm_count(a[0].device))
                also += (f"  split {str(a[0].dtype)[6:]}: one block a "
                         f"problem, {nt} threads, {smem} B of shared memory "
                         f"a block, {blocks} blocks")
        if beside is not None:
            also += (f"  {beside[0]} "
                     f"{cuda_ms(lambda: beside[1](*a32), reps=20):.4f} ms")
            if split is not None:
                also += (f" ({graph_ms(lambda: beside[1](*a32)):.4f} ms by "
                         "graph replay)")
        ops = opcount.riccati_knot_ops(nx, nu) * B * H
        bound_ms, bound_by = bound(a32, k32, None, ops, "float32")
        print(f"kernel {tag} {label} ({name}): B={B} H={H} nx={nx} nu={nu} "
              f"{'constant' if const else 'per-knot'} cost blocks  f64 rel "
              f"err {fmt(e64)} (abs {fmt(abs64)})  f32 rel err {fmt(e32)}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms{also}  bound "
              f"{bound_ms:.6f} ms by {bound_by} ({ops:.4g} operations) "
              f"(f32, median, {smi})")
        if name not in rows:
            source, replaces = SWEEP_ROWS[name]
            rows[name] = dict(name=name, route="cuda", source=source,
                              replaces=replaces, max_abs_err=max(abs64),
                              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=None)
            if gms is not None:
                rows[name]["graph_ms"] = gms
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], *abs64)
    B, H, nx, nu, bad = non_pd
    a64 = cuda(riccati_problem(np.random.default_rng(seeds[1]), nx, nu, H,
                               B, False, non_pd=bad), torch.float64)
    out, ref = kernel(*a64), backward_pass(*a64)
    same_nan = all(torch.equal(o.isnan(), r.isnan())
                   for o, r in zip(out[:3], ref[:3]))
    ok_rows = (~out[3]).nonzero()[:, 0].tolist()
    good = out[3].nonzero()[:, 0]
    e_fin = errors(tuple(o[good] for o in out[:3]),
                   tuple(r[good] for r in ref[:3]), relative=True)
    print(f"kernel {tag} non-PD: problem {bad[0]} knot {bad[1]} of B={B} "
          f"H={H}: ok False at {ok_rows} (plain "
          f"{(~ref[3]).nonzero()[:, 0].tolist()}), NaN entries identical "
          f"{same_nan}, gains NaN at knots <= {bad[1]}: "
          f"{bool(out[0][bad[0], :bad[1] + 1].isnan().all())}, the other "
          f"problems f64 rel err {fmt(e_fin)}")
    if not (same_nan and ok_rows == [bad[0]]
            and out[3].tolist() == ref[3].tolist()
            and bool(out[0][bad[0], :bad[1] + 1].isnan().all())
            and bool(out[0][bad[0], bad[1] + 1:].isfinite().all())
            and max(e_fin) <= TOL64):
        failures.append(f"{tag} non-PD: NaN rows or ok differ from the "
                        "plain sweep")
    require(not failures, "; ".join(failures))


def quadruped_problems(model, Bm: int, H: int, rng):
    """configs[3]'s start (bench.py:482-507): standing at q[2] = 0.35 with
    0.05 N(0,1) on every coordinate, at rest, gravity compensation (root
    wrench included) at every knot."""
    import torch
    from rbdtpu_torch.dynamics import rnea

    q0 = np.zeros((Bm, model.nq))
    q0[:, 2] = 0.35
    q0 = torch.tensor(q0 + 0.05 * rng.standard_normal(q0.shape),
                      dtype=model.dtype, device=model.device)
    z = torch.zeros(Bm, model.nv, dtype=model.dtype, device=model.device)
    x0 = torch.cat([q0, z], -1)
    U0 = rnea(model, q0, z, z)[0][:, None].expand(Bm, H, model.nv)
    return x0, U0.contiguous()


def quadruped_cost(model):
    from rbdtpu_torch.solver import quadratic_tracking_cost

    goal = np.zeros(model.nx)
    goal[2] = 0.4
    return quadratic_tracking_cost(model, goal, **W3)


def quadruped_solve(model, x0, U0, iters: int, kernels: bool, cost=None,
                    f_ext=None):
    """configs[3]'s ``ddp_solve`` (with ``cost`` in place of its tracking
    cost, and under the wrenches ``f_ext``, when given); ``kernels=False``
    takes every plain version (the plain sweep included)."""
    from rbdtpu_torch.solver import DDPConfig, ddp_solve

    cfg = DDPConfig(iters=iters, dt=DT, gravity=GRAVITY, n_alphas=ALPHAS3,
                    fused=kernels, fused_riccati=None if kernels else False)
    return ddp_solve(model, quadruped_cost(model) if cost is None else cost,
                     x0, U0, cfg, f_ext=f_ext)


def quadruped_kernel_inputs(m64, rng):
    """Float64 CUDA inputs for K1-K3 on the rpy quadruped at configs[3]'s
    shapes: K1 at B3 states (the initial rollout's step), K2 at ALPHAS3 *
    B3 trajectories over H3 knots (the line search), K3 at B3 * H3 knots
    (``floating_kernel_inputs``)."""
    return floating_kernel_inputs(m64, rng, quadruped_problems, B3,
                                  ALPHAS3 * B3, H3, B3 * H3)


def floating_kernel_inputs(m64, rng, problems, n_step, n_traj, H, n_knots):
    """Float64 CUDA inputs for K1-K3 (and K9) on an rpy-root model whose
    start configurations ``problems(model, Bm, H, rng)`` makes: K1 at
    n_step states, K2 at n_traj trajectories over H knots, K3 at n_knots
    knots.  K2's gains pull each trajectory, started 0.02 N(0,1) away, back
    to its nominal start x0: u = U + K (x - x0) with K = -M(q0) [400 I,
    40 I] perturbed by 10% per knot and U the gravity compensation, so the
    closed loop stays near x0."""
    import torch
    from rbdtpu_torch.dynamics import minv

    n = m64.nv
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=m64.device)

    def states(B):
        x0, U0 = problems(m64, B, 1, rng)
        qd = T(0.5 * rng.standard_normal((B, n)))
        return (x0[:, :n].contiguous(), qd,
                (U0[:, 0] + T(rng.standard_normal((B, n)))).contiguous())

    q, qd, u = states(n_step)
    fd = (torch.cat([q, qd], -1), u)
    B = n_traj
    x0, U0 = problems(m64, B, H, rng)
    Xn = x0[:, None] + T(0.01 * rng.standard_normal((B, H, 2 * n)))
    pd = np.concatenate([400.0 * np.eye(n), 40.0 * np.eye(n)], 1)
    gains = T(pd * (1 + 0.1 * rng.standard_normal((B, H, n, 2 * n))))
    Kf = -(torch.linalg.inv(minv(m64, x0[:, :n]))[:, None] @ gains)
    kf = -(Kf @ (x0[:, None] - Xn)[..., None])[..., 0]
    x_start = x0 + T(0.02 * rng.standard_normal((B, 2 * n)))
    fb = (x_start, Xn.contiguous(), U0, kf.contiguous(), Kf.contiguous())
    return {"fd_step": fd, "feedback_rollout": fb,
            "linearize_parts": states(n_knots)}


def quadruped_path(m32, smi: str) -> dict:
    """BASELINE.json configs[3] through the port's entry points, float32:
    ``ddp_solve`` of B3 floating-base quadruped problems, H3 knots, ITERS3
    iterations, ALPHAS3 line-search steps, ``DDPConfig(fused=True)``.  One
    warm-up solve, then three timed ones (CUDA events) with the counts set
    to 0 just before: per solve K1 H3 times (the initial rollout), K2, K3
    and the sweep kernel once an iteration, the plain sweep never.  J must
    be finite, nonincreasing and fall.  Returns the counts of the three
    solves."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.kernels.fused import fd_step_fused
    from rbdtpu_torch.solver import ddp, trajectory_cost

    x0, U0 = quadruped_problems(m32, B3, H3, np.random.default_rng(SEED + 30))
    xs = [x0]
    for t in range(H3):
        xs.append(fd_step_fused(m32, xs[-1], U0[:, t].contiguous(), DT,
                                GRAVITY))
    J0 = trajectory_cost(quadruped_cost(m32), torch.stack(xs, dim=-2), U0)
    quadruped_solve(m32, x0, U0, ITERS3, kernels=True)  # warm-up
    torch.cuda.synchronize()
    plain_sweeps = []
    plain = ddp.backward_pass
    ddp.backward_pass = lambda *a, **kw: plain_sweeps.append(1) or plain(
        *a, **kw)
    _lib.reset_launches()
    times = []
    try:
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, J_hist = quadruped_solve(m32, x0, U0, ITERS3, kernels=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    finally:
        ddp.backward_pass = plain
    counts = dict(_lib.launches)
    print(f"configs[3] path launches (3 solves): {counts}; plain sweeps "
          f"{len(plain_sweeps)}")
    per_solve = {"fd_step": H3, "feedback_rollout": ITERS3,
                 "linearize_parts": ITERS3, "riccati_chunk": ITERS3}
    for k, v in per_solve.items():
        require(counts[k] == 3 * v, f"configs[3]: {k} launched {counts[k]} "
                f"times in 3 solves, expected {3 * v}")
    require(counts["riccati_small"] == 0 and not plain_sweeps,
            "configs[3]: the plain sweep or the small-batch site ran")
    require(tuple(J_hist.shape) == (ITERS3, B3), f"J_hist {J_hist.shape}")
    require(bool(J_hist.isfinite().all()), "configs[3]: non-finite J")
    require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[0] <= J0 * (1 + 1e-6)).all()), "configs[3]: J increased")
    require(J_hist[-1].mean() < J0.mean(), "configs[3]: mean J did not fall")
    require(tuple(state.U.shape) == (B3, H3, m32.nv), "configs[3]: U shape")
    sec = statistics.median(times)
    print(f"configs[3] path: quadruped12 rpy tracking, Bm={B3} H={H3} "
          f"iters={ITERS3} alphas={ALPHAS3} f32 fused: mean J "
          f"{J0.mean().item():.6g} -> {J_hist[-1].mean().item():.6g}; solve "
          f"{sec * 1e3:.1f} ms (median of {len(times)}: "
          f"{' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) = "
          f"{B3 / sec:.1f} solves/s on {smi}")
    profile_main_path(lambda: quadruped_solve(m32, x0, U0, ITERS3, True))
    return counts


def quadruped_parity(m64) -> dict:
    """Kernel route against plain route on the configs[3] problem, float64,
    at the sweep's two call sites (PARITY3): max |U_kernel - U_plain| <
    U_PARITY at each.  Returns the counts of the small-batch kernel-route
    solve (the run that drives the sweep's small-batch call site)."""
    from rbdtpu_torch.kernels import _lib

    counts = None
    for Bm, H, iters in PARITY3:
        x0, U0 = quadruped_problems(m64, Bm, H,
                                    np.random.default_rng(SEED + 40))
        _lib.reset_launches()
        sk, _ = quadruped_solve(m64, x0, U0, iters, kernels=True)
        if counts is None:
            counts = dict(_lib.launches)
        sp, _ = quadruped_solve(m64, x0, U0, iters, kernels=False)
        du = (sk.U - sp.U).abs().max().item()
        dj = ((sk.J - sp.J).abs() / sp.J.abs().clamp(min=1)).max().item()
        print(f"configs[3] parity f64 Bm={Bm} H={H} iters={iters}: "
              f"max|U_kernel - U_plain| {du:.3e} (bound {U_PARITY:g}); "
              f"max rel |dJ| {dj:.3e}")
        require(du < U_PARITY, f"configs[3] control parity at Bm={Bm}: "
                f"{du:.3e} >= {U_PARITY:g}")
    print(f"configs[3] parity Bm={PARITY3[0][0]} kernel-route launches: "
          f"{counts}")
    return counts


def arm_path(m32, smi: str, name: str, Bm: int, H: int, iters: int,
             **options):
    """The configs[2] solve (arm7 EE reaching, float32, kernels) through
    ``ddp_solve``, with ``options`` for its backward pass: one warm-up
    solve, then three timed ones (CUDA events) with the counts set to 0
    just before, the plain sweeps counted beside them.  J must be finite,
    nonincreasing and fall.  Returns (the counts of the three solves, x0,
    U0)."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.kernels.fused import fd_step_fused
    from rbdtpu_torch.solver import ddp, ee_reaching_cost, trajectory_cost

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
    solve(m32, x0, U0, fused=True, iters=iters, **options)  # warm-up
    torch.cuda.synchronize()
    plain_sweeps = []
    plain = ddp.backward_pass
    ddp.backward_pass = lambda *a, **kw: plain_sweeps.append(1) or plain(
        *a, **kw)
    _lib.reset_launches()
    times = []
    try:
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, J_hist = solve(m32, x0, U0, fused=True, iters=iters,
                                  **options)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    finally:
        ddp.backward_pass = plain
    counts = dict(_lib.launches)
    print(f"{name} launches (3 solves): {counts}; plain sweeps "
          f"{len(plain_sweeps)}")
    if options.get("fused_riccati"):
        require(not plain_sweeps, f"{name}: the plain sweep ran")
    require(tuple(J_hist.shape) == (iters, Bm), f"J_hist shape {J_hist.shape}")
    require(bool(J_hist.isfinite().all()), f"non-finite J on the {name}")
    require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[0] <= J0 * (1 + 1e-6)).all()), "J increased in an iteration")
    require(J_hist[-1].mean() < J0.mean(), "mean J did not fall")
    require(tuple(state.U.shape) == (Bm, H, m32.nv), "U shape")
    sec = statistics.median(times)
    opts = "".join(f", {k}={v}" for k, v in options.items())
    print(f"{name}: arm7 EE reaching, Bm={Bm} H={H} iters={iters} f32 "
          f"fused{opts}: mean J {J0.mean().item():.4f} -> "
          f"{J_hist[-1].mean().item():.4f}; solve {sec * 1e3:.1f} ms "
          f"(median of {len(times)}: "
          f"{' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) = "
          f"{Bm / sec:.1f} solves/s on {smi}")
    return counts, x0, U0


def arm_parity(m64, name: str, iters: int, **options):
    """Kernel route (with ``options``) against the plain route on the
    configs[2] problem in float64, Bm=4, at each horizon of PARITY_H: max
    |U_kernel - U_plain| < U_PARITY.  At H=100 the open-loop warm start
    amplifies rounding ~1e9-fold and the weakly penalised controls
    (w_u=1e-6) follow it, so the bound there also demands that each kernel
    rounds almost as its plain version does; H=20 is the well-conditioned
    check."""
    for Hp in PARITY_H:
        x0p, U0p = start_problems(m64, 4, Hp, np.random.default_rng(SEED + 2))
        sk, _ = solve(m64, x0p, U0p, fused=True, iters=iters, **options)
        sp, _ = solve(m64, x0p, U0p, fused=False, iters=iters)
        du = (sk.U - sp.U).abs().max().item()
        dj = ((sk.J - sp.J).abs() / sp.J.abs().clamp(min=1)).max().item()
        print(f"{name} f64 Bm=4 H={Hp} iters={iters}: max|U_kernel - U_plain| "
              f"{du:.3e} (bound {U_PARITY:g}); max rel |dJ| {dj:.3e}")
        require(du < U_PARITY,
                f"{name}: control parity at H={Hp}: {du:.3e} >= {U_PARITY:g}")


def mpc_run_timed(model, x0, U0, ticks: int, **options):
    """``mpc_run`` of configs[2]'s cost with the kernels (DDPConfig(iters=
    MPC_ITERS, n_alphas=MPC_ALPHAS, fused=True, **options)), each tick
    (one ``mpc_step``) timed by CUDA events, and the calls of each backward
    pass of ``solver.ddp`` counted.  Returns (final carry, U_applied,
    J_hist, ms per tick, calls)."""
    import collections

    import torch
    from rbdtpu_torch.solver import DDPConfig, ddp, ee_reaching_cost, mpc

    cfg = DDPConfig(iters=MPC_ITERS, dt=DT, gravity=GRAVITY,
                    n_alphas=MPC_ALPHAS, fused=True, **options)
    cost = ee_reaching_cost(model, TARGET, **WEIGHTS)
    step, times, calls = mpc.mpc_step, [], collections.Counter()

    def timed_step(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*a, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        return out

    def counted(name, fn):
        return lambda *a, **kw: calls.update([name]) or fn(*a, **kw)

    sweeps = {n: getattr(ddp, n) for n in (
        "backward_pass", "backward_pass_fused", "backward_pass_parallel",
        "backward_pass_chunked")}
    mpc.mpc_step = timed_step
    for n, fn in sweeps.items():
        setattr(ddp, n, counted(n, fn))
    try:
        carry, (U_app, J_hist) = mpc.mpc_run(model, cost, x0, U0, ticks, cfg)
    finally:
        mpc.mpc_step = step
        for n, fn in sweeps.items():
            setattr(ddp, n, fn)
    return carry, U_app, J_hist, times, dict(calls)


def ee_distance(model, x):
    """The end effector's distance to TARGET at states x (..., nx)."""
    import torch
    from rbdtpu_torch.kinematics.fk import ee_pose

    p = ee_pose(model, x[..., :model.nq])[..., 0, :3]
    return (p - torch.tensor(TARGET, dtype=p.dtype, device=p.device)).norm(
        dim=-1)


def mpc_path(m32, m64, smi: str):
    """Path B, the closed-loop MPC loop (examples/mpc_reaching.py:57-63
    with the kernels) in float32 at H=MPC_H for MPC_TICKS ticks: at Bm=1
    under the plain sweep, K11 and the parallel scan, and at Bm=128 under
    K11 and the plain sweep, each from configs[2]'s start (at rest,
    gravity compensation) with the counts set to 0 just before.  Every
    run: the controls applied and the plant's states finite, the backward
    pass ran MPC_ITERS times a tick through its strategy alone (and K11
    launched as often), the mean EE distance to the target falls.  At
    Bm=1 also every J is finite and the distance falls.  At Bm=128 the
    robots whose J went non-finite are printed with their first such tick:
    in float32 the open-loop rollout of a fast robot's warm start can
    overflow, and the solver's acceptance test (rbdtpu's, J_new < J -
    tol_dJ max(1, |J|)) never accepts against an infinite J, whatever the
    backward pass.  Then K11 against the plain sweep in float64 on the
    controls applied (MPC_PARITY), and a checkpoint round trip on the
    card."""
    import tempfile

    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import (
        DDPConfig, ddp_solve, ee_reaching_cost, load_solver_state,
        save_solver_state,
    )

    H = MPC_H
    runs = (("plain sweep", 1, {}, "backward_pass"),
            ("K11", 1, {"fused_riccati": True}, "backward_pass_fused"),
            ("parallel scan", 1, {"parallel_riccati": True},
             "backward_pass_parallel"),
            ("K11", 128, {"fused_riccati": True}, "backward_pass_fused"),
            ("plain sweep", 128, {}, "backward_pass"))
    for label, Bm, options, sweep in runs:
        x0, U0 = start_problems(m32, Bm, H, np.random.default_rng(SEED + 70))
        torch.cuda.synchronize()
        _lib.reset_launches()
        carry, U_app, J_hist, ms, calls = mpc_run_timed(m32, x0, U0,
                                                        MPC_TICKS, **options)
        torch.cuda.synchronize()
        counts = dict(_lib.launches)
        d0, d1 = ee_distance(m32, x0), ee_distance(m32, carry.x)
        bad = (~J_hist.isfinite()).any(0).nonzero()[:, 0].tolist()
        first_bad = {b: int((~J_hist[:, b].isfinite()).nonzero()[0]) + 1
                     for b in bad}
        med = statistics.median(ms[1:])
        print(f"path B {label} Bm={Bm} H={H} f32: {MPC_TICKS} ticks, "
              f"{med:.2f} ms per tick (median of ticks 2-{MPC_TICKS}; first "
              f"{ms[0]:.1f}, range {min(ms[1:]):.2f}-{max(ms[1:]):.2f}, CUDA "
              f"events) = {1e3 / med:.1f} ticks/s, {Bm * 1e3 / med:.1f} "
              f"robot-ticks/s; EE distance mean {d0.mean().item():.4f} -> "
              f"{d1.mean().item():.4f} m (max {d1.max().item():.4f}, fell for "
              f"{int((d1 < d0).sum())} of {Bm}); J (finite) "
              f"{J_hist[0][J_hist[0].isfinite()].mean().item():.4f} -> "
              f"{J_hist[-1][J_hist[-1].isfinite()].mean().item():.4f}; J "
              f"non-finite for robot: first tick {first_bad}; sweeps {calls};"
              f" launches {counts} on {smi}")
        n = MPC_TICKS * MPC_ITERS
        require(tuple(U_app.shape) == (MPC_TICKS, Bm, m32.nv),
                f"path B {label}: U_applied {tuple(U_app.shape)}")
        require(bool(U_app.isfinite().all()) and bool(carry.x.isfinite().all()),
                f"path B {label} Bm={Bm}: non-finite controls or state")
        require(d1.mean() < d0.mean(),
                f"path B {label} Bm={Bm}: the EE distance did not fall")
        if Bm == 1:
            require(not bad and bool((d1 < d0).all()),
                    f"path B {label}: non-finite J or the distance rose")
        require(calls == {sweep: n}, f"path B {label}: backward passes "
                f"{calls}, expected {n} of {sweep}")
        require(counts["riccati_fused"] == (n if "fused_riccati" in options
                                            else 0),
                f"path B {label}: riccati_fused launched "
                f"{counts['riccati_fused']} times")
        require(counts["feedback_rollout"] == n and counts["fd_step"] > 0,
                f"path B {label}: kernel launches {counts}")

    Bp, Hp, ticks = MPC_PARITY
    x0, U0 = start_problems(m64, Bp, Hp, np.random.default_rng(SEED + 71))
    U_k = mpc_run_timed(m64, x0, U0, ticks, fused_riccati=True)[1]
    U_p = mpc_run_timed(m64, x0, U0, ticks)[1]
    du = (U_k - U_p).abs().max().item()
    print(f"path B parity f64 Bm={Bp} H={Hp} {ticks} ticks: max|u_K11 - "
          f"u_plain| over the controls applied {du:.3e} (bound {U_PARITY:g})")
    require(du < U_PARITY, f"path B parity: {du:.3e} >= {U_PARITY:g}")

    cost = ee_reaching_cost(m32, TARGET, **WEIGHTS)
    x0, U0 = start_problems(m32, 4, 20, np.random.default_rng(SEED + 72))
    state, _ = ddp_solve(m32, cost, x0, U0, DDPConfig(
        iters=2, dt=DT, gravity=GRAVITY, n_alphas=MPC_ALPHAS, fused=True,
        fused_riccati=True))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/solver_state.npz"
        save_solver_state(path, state)
        back = load_solver_state(path, state)
    same = all(a.device == b.device and a.dtype == b.dtype
               and torch.equal(a, b) for a, b in zip(back, state))
    print(f"path B checkpoint: save_solver_state then load_solver_state on "
          f"{back.X.device}: every field identical {same}")
    require(same and type(back) is type(state),
            "path B: the checkpoint round trip changed the state")


def humanoid_problems(model, Bm: int, H: int, rng):
    """configs[4]'s start (bench.py:555-579): standing at q[2] = 0.9 with
    0.02 N(0,1) on every coordinate, at rest, gravity compensation at
    every knot."""
    import torch
    from rbdtpu_torch.dynamics import rnea

    q0 = np.zeros((Bm, model.nq))
    q0[:, 2] = 0.9
    q0 = torch.tensor(q0 + 0.02 * rng.standard_normal(q0.shape),
                      dtype=model.dtype, device=model.device)
    z = torch.zeros(Bm, model.nv, dtype=model.dtype, device=model.device)
    U0 = rnea(model, q0, z, z)[0][:, None].expand(Bm, H, model.nv)
    return torch.cat([q0, z], -1), U0.contiguous()


def humanoid_cost(model):
    from rbdtpu_torch.solver import quadratic_tracking_cost

    goal = np.zeros(model.nx)
    goal[2] = 0.95
    return quadratic_tracking_cost(model, goal, **WH)


def humanoid_kernels(h64, h32, arm, quad, smi: str, rows: dict, ptxas: list):
    """Phase 15: K1-K3 at the fb32 size class against their plain versions
    at the humanoid paths' shapes (K1 at path C's BH x SAMPLES_H sample
    states, K2 at path D's BD x ALPHAS_H trajectories of HH knots, K3 at
    path D's BD x HH knots), K10 and K6 at K1's states, the stack limit
    required unchanged across them; K9 (``feedback_chunked``) at path D's shape at
    every count of NCHUNKS_CHECKS, with and without a clamp that bites,
    on arm7 and the rpy quadruped (``arm``, ``quad``: (m64, m32, K2's
    float64 inputs, states x steps)) and at an odd batch, the stack limit
    required unchanged across K9 at fb32 in float64; then K9 against K2 on
    the same inputs of each model, float64 within TOL64, both timed.
    Returns the humanoid's float64 inputs (``floating_kernel_inputs``)."""
    import torch
    from rbdtpu_torch.kernels import _lib, fused

    for line in ptxas:
        if "Dims<32" in line or "feedback_chunked" in line:
            print(f"phase 15 {line}")
    hin = floating_kernel_inputs(h64, np.random.default_rng(SEED + 90),
                                 humanoid_problems, BH * SAMPLES_H,
                                 BD * ALPHAS_H, HH, BD * HH)
    states = {"fd_step": BH * SAMPLES_H, "feedback_rollout":
              BD * ALPHAS_H * HH, "linearize_parts": BD * HH}

    def outside_pool():
        """GB of device memory in use outside PyTorch's allocator: the
        context and the local memory the CUDA driver reserves for the
        largest stack frame launched so far, for every thread the card can
        hold."""
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        return (total - free - torch.cuda.memory_reserved()) / 1e9

    limit, before = _lib.stack_limit(h64.device), outside_pool()
    check_kernels([(f"{k} humanoid", k, hin[k], {}, k, states[k])
                   for k in hin], h64, h32, smi, rows, row_tag="_fb32")
    check_kernels(minv_rnea_checks(h64, hin["fd_step"], "humanoid",
                                   *step_extras(h64, BH * SAMPLES_H,
                                                SEED + 91)),
                  h64, h32, smi, rows)
    grown, after = _lib.stack_limit(h64.device), outside_pool()
    print(f"device memory outside PyTorch's pool: {before:.2f} GB before "
          f"K1-K3, K6 and K10 at fb32 (stack limit {limit} B a thread), "
          f"{after:.2f} GB after them (limit {grown} B) ({smi})")
    require(grown == limit, f"K1-K3, K6 or K10 at fb32 raised the stack "
            f"limit from {limit} to {grown} B a thread")
    check_kernels(team_checks(h64, hin["fd_step"], hin["feedback_rollout"],
                              "humanoid"), h64, h32, smi, rows,
                  row_tag="_fb32", time_all=False)
    team_report("humanoid", h64, h32, hin["fd_step"], hin["feedback_rollout"])
    fb = hin["feedback_rollout"]
    # 0.8 of the largest control each coordinate takes unclamped: the clamp
    # bites on a few knots.  A tighter one lets the humanoid fall out of the
    # closed loop, whose rounding then grows past any tolerance (float32 and
    # float64 plain versions part by 1e-1 at half the nominal controls).
    applied = fused.feedback_rollout_fused(h64, *fb, DT, GRAVITY)[1]
    clip = 0.8 * applied.abs().amax(dim=(0, 1))
    k9 = [(f"feedback_chunked humanoid nchunks={c}"
           f"{' u_clip' if u is not None else ''}", "feedback_chunked", fb,
           {"nchunks": c, **({} if u is None else {"u_clip": u})},
           "feedback_chunked", states["feedback_rollout"])
          for c in NCHUNKS_CHECKS for u in (None, clip)]
    odd = tuple(a[:BD * ALPHAS_H - 3].contiguous() for a in fb)
    k9.append(("feedback_chunked humanoid odd batch", "feedback_chunked", odd,
               {"nchunks": NCHUNKS_D}, "feedback_chunked",
               odd[0].shape[0] * HH))
    # K9 is a team kernel: at fb32 in float64 it runs within the stack
    # limit the earlier phases left
    limit = _lib.stack_limit(h64.device)
    check_kernels(k9, h64, h32, smi, rows, time_all=False)
    grown = _lib.stack_limit(h64.device)
    print(f"stack limit {limit} B a thread before K9 at fb32, {grown} B after "
          f"it ({smi})")
    require(grown == limit, f"K9 at fb32 raised the stack limit from {limit} "
            f"to {grown} B a thread")
    for label, (m64, m32, args, steps) in (("arm7", arm),
                                           ("rpy quadruped", quad)):
        check_kernels([(f"feedback_chunked {label}", "feedback_chunked", args,
                        {"nchunks": NCHUNKS_D}, "feedback_chunked", steps)],
                      m64, m32, smi, rows, time_all=False)
    for label, (m64, m32, args, _) in (("humanoid", (h64, h32, fb, 0)),
                                       ("arm7", arm), ("rpy quadruped", quad)):
        k2 = fused.feedback_rollout_fused(m64, *args, DT, GRAVITY)
        k9 = fused.feedback_rollout_fused_chunked(m64, *args, DT, GRAVITY,
                                                  nchunks=NCHUNKS_D)
        err = max(errors(k9, k2, relative=False))
        a32 = tuple(a.float() for a in args)
        k2_32 = lambda: fused.feedback_rollout_fused(m32, *a32, DT, GRAVITY)
        k9_32 = lambda: fused.feedback_rollout_fused_chunked(
            m32, *a32, DT, GRAVITY, nchunks=NCHUNKS_D)
        ms2, ms9 = cuda_ms(k2_32, reps=20), cuda_ms(k9_32, reps=20)
        print(f"kernel feedback_chunked vs feedback_rollout {label} "
              f"{tuple(args[4].shape)}: f64 max|K9 - K2| {err:.3e} (bound "
              f"{TOL64:g}); f32 K9 nchunks={NCHUNKS_D} {ms9:.4f} ms "
              f"({graph_ms(k9_32):.4f} ms by graph replay), K2 {ms2:.4f} ms "
              f"({graph_ms(k2_32):.4f} ms by graph replay) (median of 20, "
              f"CUDA events, {smi})")
        require(err <= TOL64, f"K9 against K2 on {label}: {err:.3e} > "
                f"{TOL64:g}")
    return hin


def timed_runs(fn, reps: int = 3, warm: bool = True):
    """A warm-up call of ``fn`` (unless ``warm`` is False), then ``reps``
    calls each timed by CUDA events: (the last call's result, seconds of
    each)."""
    import torch

    if warm:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return out, times


def hybrid_path(m32, smi: str) -> dict:
    """Phase 16, path C: BASELINE.json configs[4] as bench.py:539-590 runs
    it, through ``hybrid_solve``: BH humanoid problems, HH knots, float32,
    MPPI_ITERS_H MPPI iterations of SAMPLES_H samples then ITERS_H DDP
    iterations of ALPHAS_H line-search steps, every kernel on, noise from a
    seeded generator on the card.  One warm-up solve, then three timed ones
    with the counts set to 0 just before: K1 in the sampling, K2, K3 and
    the small-batch sweep once a DDP iteration, K9 and the plain sweep
    never; then the MPPI and DDP stages timed apart.  Both J histories must
    be finite and fall (MPPI's within 1e-6 relative: its guard compares
    costs of separately batched rollouts), the final J below the initial.
    Returns the counts of the three solves."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import (
        DDPConfig, MPPIConfig, ddp_solve, hybrid_solve, mppi_solve, rollout,
        trajectory_cost,
    )

    x0, U0 = humanoid_problems(m32, BH, HH, np.random.default_rng(SEED + 91))
    cost = humanoid_cost(m32)
    mcfg = MPPIConfig(n_samples=SAMPLES_H, sigma=SIGMA_H, dt=DT,
                      gravity=GRAVITY, fused=True)
    dcfg = DDPConfig(iters=ITERS_H, dt=DT, gravity=GRAVITY,
                     n_alphas=ALPHAS_H, fused=True)
    J0 = trajectory_cost(cost, rollout(m32, x0, U0, DT, GRAVITY, fused=True),
                         U0)
    gen = torch.Generator(device=m32.device)

    def solve():
        gen.manual_seed(SEED)
        return hybrid_solve(m32, cost, x0, U0, gen, mcfg, dcfg,
                            mppi_iters=MPPI_ITERS_H)

    def sample():
        gen.manual_seed(SEED)
        return mppi_solve(m32, cost, x0, U0, gen, MPPI_ITERS_H, mcfg)

    solve()
    torch.cuda.synchronize()
    _lib.reset_launches()
    (state, (mh, dh)), times = timed_runs(solve, warm=False)
    torch.cuda.synchronize()
    counts = dict(_lib.launches)
    print(f"path C launches (3 solves): {counts}")
    (U_warm, _), t_mppi = timed_runs(sample)
    _, t_ddp = timed_runs(lambda: ddp_solve(m32, cost, x0, U_warm, dcfg))
    n = 3 * ITERS_H
    for k, v in {"feedback_rollout": n, "linearize_parts": n,
                 "riccati_small": n, "feedback_chunked": 0,
                 "riccati_chunk": 0}.items():
        require(counts[k] == v, f"path C: {k} launched {counts[k]} times in "
                f"3 solves, expected {v}")
    require(counts["fd_step"] > 0, "path C: no fd_step launch")
    for name, h in (("MPPI", mh), ("DDP", dh)):
        require(tuple(h.shape) == (MPPI_ITERS_H if name == "MPPI"
                                   else ITERS_H, BH), f"path C {name} J "
                f"history {tuple(h.shape)}")
        require(bool(h.isfinite().all()), f"path C: non-finite {name} J")
    require(bool((mh[1:] <= mh[:-1] * (1 + 1e-6)).all())
            and bool((mh[0] <= J0 * (1 + 1e-6)).all()),
            "path C: MPPI's J increased")
    require(bool((dh[1:] <= dh[:-1]).all())
            and bool((dh[0] <= mh[-1] * (1 + 1e-6)).all()),
            "path C: DDP's J increased")
    require(bool((dh[-1] < J0).all()), "path C: J did not fall")
    require(bool(state.U.isfinite().all()), "path C: non-finite controls")
    sec, sm, sd = (statistics.median(t) for t in (times, t_mppi, t_ddp))
    fmt = lambda h: " ".join(f"{v:.6g}" for v in h.mean(-1).tolist())
    print(f"path C: configs[4] humanoid30 rpy hybrid, Bm={BH} H={HH} "
          f"MPPI {MPPI_ITERS_H} x {SAMPLES_H} samples, DDP {ITERS_H} iters x "
          f"{ALPHAS_H} alphas, f32 fused: mean J {J0.mean().item():.6g}, "
          f"MPPI {fmt(mh)}, DDP {fmt(dh)}; solve {sec * 1e3:.1f} ms (median "
          f"of 3: {' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) "
          f"= {BH / sec:.1f} solves/s; MPPI stage {sm * 1e3:.1f} ms, DDP "
          f"stage {sd * 1e3:.1f} ms (medians of 3) on {smi}")
    return counts


def mppi_moved(J0, hist, rel: float = 1e-9) -> int:
    """(iteration, problem) pairs whose accepted J fell below the previous
    one: MPPI's guard took the weighted update or the best sample, not the
    nominal plan."""
    import torch

    prev = torch.cat([J0[None], hist[:-1]])
    return int((hist < prev * (1 - rel)).sum())


def hybrid_parity(m64, smi: str, f_ext=None, sigmas=(SIGMA_H, SIGMA_MOVE),
                  tag: str = "path C", floor_times=None):
    """Phase 16's check of the hybrid at path C's shapes (BH problems, HH
    knots, MPPI_ITERS_H iterations of SAMPLES_H samples, then ITERS_H DDP
    iterations) in float64: ``hybrid_solve`` through the kernels and
    through the plain route (``fused=False`` in both stages), fed the same
    standard normals through ``noise``, at configs[4]'s sigma and at
    SIGMA_MOVE, where MPPI replaces its nominal plan.  |dU| < U_PARITY and
    relative |dJ| < TOL64 over both J histories; at SIGMA_MOVE the MPPI
    stage must have moved in at least one (iteration, problem) pair.  With
    ``f_ext`` both routes solve under those wrenches (``tag`` names the
    run).  With ``floor_times`` the plain route also solves from x0 moved
    by 1e-13 N(0,1) relative: how far that parts from it in J is the
    problem's own sensitivity to rounding, below which no comparison of
    two routes can resolve the kernels, and relative |dJ| must stay under
    ``floor_times`` times it instead of TOL64.  Returns the kernel route's
    launches of its last solve, by kernel and by (kernel, size class)."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import (
        DDPConfig, MPPIConfig, hybrid_solve, rollout, trajectory_cost,
    )

    x0, U0 = humanoid_problems(m64, BH, HH, np.random.default_rng(SEED + 94))
    cost = humanoid_cost(m64)
    J0 = trajectory_cost(cost, rollout(m64, x0, U0, DT, GRAVITY,
                                       f_ext=f_ext), U0)
    gen = torch.Generator(device=m64.device).manual_seed(SEED + 95)
    noise = torch.randn((MPPI_ITERS_H, BH, SAMPLES_H, HH, m64.nv),
                        generator=gen, dtype=m64.dtype, device=m64.device)
    counts = None
    rng = np.random.default_rng(SEED + 96)
    moved_x0 = x0 * (1 + 1e-13 * torch.tensor(
        rng.standard_normal(x0.shape), dtype=x0.dtype, device=x0.device))
    runs = ((True, x0), (False, x0)) + (
        ((None, moved_x0),) if floor_times else ())
    for sigma in sigmas:
        out = {}
        for fused, x in runs:
            _lib.reset_launches()
            state, (mh, dh) = hybrid_solve(
                m64, cost, x, U0, None,
                MPPIConfig(n_samples=SAMPLES_H, sigma=sigma, dt=DT,
                           gravity=GRAVITY, fused=bool(fused)),
                DDPConfig(iters=ITERS_H, dt=DT, gravity=GRAVITY,
                          n_alphas=ALPHAS_H, fused=bool(fused)),
                mppi_iters=MPPI_ITERS_H, f_ext=f_ext, noise=noise)
            torch.cuda.synchronize()
            if fused:
                counts = dict(_lib.launches)
                by_class = dict(_lib.class_launches)
            out[fused] = (state.U, mh, dh)
        Up, mp, dp = out[False]
        parts = lambda U, m, d: ((U - Up).abs().max().item(), max(
            ((a - b).abs() / b.abs()).max().item()
            for a, b in ((m, mp), (d, dp))))
        bound = TOL64
        if floor_times:
            fu, fj = parts(*out[None])
            bound = floor_times * fj
            print(f"{tag} floor f64 sigma={sigma:g}: the plain route from x0 "
                  f"x (1 + 1e-13 N(0,1)) against the plain route: max|dU| "
                  f"{fu:.3e}, max rel |dJ| {fj:.3e}")
        Uk, mk, dk = out[True]
        du, dj = parts(Uk, mk, dk)
        moved = (mppi_moved(J0, mk), mppi_moved(J0, mp))
        print(f"{tag} parity f64 sigma={sigma:g}: hybrid Bm={BH} H={HH} "
              f"MPPI {MPPI_ITERS_H} x {SAMPLES_H} samples, DDP {ITERS_H} "
              f"iters, kernels vs plain route, same noise: max|dU| "
              f"{du:.3e} (bound {U_PARITY:g}), max rel |dJ| over both J "
              f"histories {dj:.3e} (bound {bound:.3g}"
              f"{f' = {floor_times:g} x the floor' if floor_times else ''}); "
              f"(iteration, problem) "
              f"pairs where MPPI replaced the nominal: {moved[0]} kernels, "
              f"{moved[1]} plain, of {mk.numel()}; mean J "
              f"{J0.mean().item():.9g} -> MPPI "
              f"{mk[-1].mean().item():.9g} -> DDP {dk[-1].mean().item():.9g}"
              f" ({smi})")
        require(du < U_PARITY and dj < bound and moved[0] == moved[1],
                f"{tag} sigma={sigma:g}: the kernels' hybrid departs from "
                "the plain route's")
        require(sigma != SIGMA_MOVE or moved[0] > 0, f"{tag} sigma="
                f"{sigma:g}: MPPI never replaced its nominal plan, so the "
                "check did not reach its update")
    print(f"{tag} parity kernel-route launches (last solve): {counts}")
    return counts, by_class


def humanoid_solve(m, x0, U0, fused_feedback, f_ext=None):
    """Path D's ``ddp_solve``: the humanoid tracking task, ITERS_H
    iterations, ALPHAS_H line-search steps, every kernel on, the line
    search's tier from ``fused_feedback``, under ``f_ext`` when given."""
    from rbdtpu_torch.solver import DDPConfig, ddp_solve

    return ddp_solve(m, humanoid_cost(m), x0, U0, DDPConfig(
        iters=ITERS_H, dt=DT, gravity=GRAVITY, n_alphas=ALPHAS_H, fused=True,
        fused_feedback=fused_feedback), f_ext=f_ext)


def humanoid_ddp_path(m32, m64, smi: str) -> dict:
    """Phase 17, path D: configs[4]'s DDP stage at fleet batch as
    tools/bench_chunked.py runs it: BD humanoid problems, HH knots, ITERS_H
    iterations, ALPHAS_H line-search steps, float32,
    ``DDPConfig(fused=True, fused_feedback=True)``, whose line search
    rbdtpu's rule sends to K9 with NCHUNKS_D chunks.  One warm-up, three
    timed solves with the counts set to 0 just before: K9 and the chunked
    sweep once an iteration, K2 and the plain pass never; J finite,
    nonincreasing and falling; its profile; the same solve timed with
    ``fused_feedback=None`` (K2) and False (the plain pass).  Then in
    float64 at BD_PARITY problems the K9 tier against the K2 tier:
    |dU| < U_PARITY and relative |dJ| < TOL64.  Returns the counts of the
    three K9-tier solves."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import DDPConfig, ddp, rollout, trajectory_cost

    cfg = DDPConfig(fused=True, fused_feedback=True, n_alphas=ALPHAS_H)
    for B in (BD, BD_PARITY):
        tier = ddp._feedback_route(m32, cfg, B * ALPHAS_H)
        require(tier == ("chunked", NCHUNKS_D), f"path D: {B} problems take "
                f"the line-search tier {tier}")
    x0, U0 = humanoid_problems(m32, BD, HH, np.random.default_rng(SEED + 92))
    J0 = trajectory_cost(humanoid_cost(m32),
                         rollout(m32, x0, U0, DT, GRAVITY, fused=True), U0)
    plain_passes = []
    plain = ddp.forward_pass
    ddp.forward_pass = lambda *a, **kw: plain_passes.append(1) or plain(
        *a, **kw)
    results = {}
    try:
        for fb in (True, None, False):
            humanoid_solve(m32, x0, U0, fb)
            torch.cuda.synchronize()
            plain_passes.clear()
            _lib.reset_launches()
            (state, J_hist), times = timed_runs(
                lambda: humanoid_solve(m32, x0, U0, fb), warm=False)
            torch.cuda.synchronize()
            results[fb] = (state, J_hist, times, dict(_lib.launches),
                           len(plain_passes))
    finally:
        ddp.forward_pass = plain
    n = 3 * ITERS_H
    expect = {True: (n, 0, 0), None: (0, n, 0), False: (0, 0, n)}
    for fb, (state, J_hist, times, counts, passes) in results.items():
        sec = statistics.median(times)
        print(f"path D fused_feedback={fb}: humanoid30 rpy tracking, Bm={BD} "
              f"H={HH} iters={ITERS_H} alphas={ALPHAS_H} f32: mean J "
              f"{J0.mean().item():.6g} -> {J_hist[-1].mean().item():.6g}; "
              f"solve {sec * 1e3:.1f} ms (median of 3: "
              f"{' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) = "
              f"{BD / sec:.1f} solves/s; launches (3 solves) {counts}; plain "
              f"line-search passes {passes} on {smi}")
        got = (counts["feedback_chunked"], counts["feedback_rollout"], passes)
        require(got == expect[fb], f"path D fused_feedback={fb}: K9, K2 and "
                f"plain passes {got}, expected {expect[fb]}")
        require(counts["riccati_chunk"] == n and counts["linearize_parts"]
                == n, f"path D fused_feedback={fb}: launches {counts}")
        require(bool(J_hist.isfinite().all()), f"path D {fb}: non-finite J")
        require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
            (J_hist[0] <= J0 * (1 + 1e-6)).all()), f"path D {fb}: J increased")
        require(J_hist[-1].mean() < J0.mean(), f"path D {fb}: J did not fall")
    profile_main_path(lambda: humanoid_solve(m32, x0, U0, True),
                      extra=("forward_pass",))

    x0, U0 = humanoid_problems(m64, BD_PARITY, HH,
                               np.random.default_rng(SEED + 93))
    _lib.reset_launches()
    k9, h9 = humanoid_solve(m64, x0, U0, True)
    torch.cuda.synchronize()
    launched = _lib.launches["feedback_chunked"]
    k2, h2 = humanoid_solve(m64, x0, U0, None)
    du = (k9.U - k2.U).abs().max().item()
    dj = ((h9 - h2).abs() / h2.abs().clamp(min=1)).max().item()
    print(f"path D parity f64 Bm={BD_PARITY} H={HH} iters={ITERS_H}: K9 tier "
          f"({launched} launches) vs K2 tier max|dU| {du:.3e} (bound "
          f"{U_PARITY:g}), max rel |dJ| over the J history {dj:.3e} (bound "
          f"{TOL64:g})")
    require(launched == ITERS_H and du < U_PARITY and dj < TOL64,
            "path D: the K9 tier departs from the K2 tier")
    return results[True][3]


def foot_cost(model, fused: bool = True):
    """Path E's cost (bench.py:525-530): ``ee_reaching_cost`` toward
    TARGET_E at the first leaf joint (a front foot's knee), weights WE;
    ``fused=False`` takes K4's plain version."""
    from rbdtpu_torch.solver import ee_reaching_cost

    return ee_reaching_cost(model, TARGET_E, ee_names=foot_ee(model),
                            fused=None if fused else False, **WE)


def foot_ee(model):
    return (model.joint_names[model.leaves()[0]],)


def foot_kernels(q64, q32, smi: str, rows: dict):
    """Phase 18's kernel checks: K4's fb16 instantiation against its plain
    version at path E's shapes: ee_gn at the B3 x H3 knots of a
    quadratisation and the B3 terminal states, ee_err at the line search's
    ALPHAS3 x B3 x H3 stage states and ALPHAS3 x B3 terminal ones;
    configurations from configs[3]'s start with 0.1 N(0,1) more on every
    coordinate."""
    import torch

    rng = np.random.default_rng(SEED + 100)

    def qs(B):
        x0, _ = quadruped_problems(q64, B, 1, rng)
        q = x0[:, :q64.nq]
        return (q + torch.tensor(0.1 * rng.standard_normal(q.shape),
                                 dtype=q.dtype, device=q.device)).contiguous()

    kw = {"ee_names": foot_ee(q64)}
    checks = [("ee_gn rpy knots", "ee_gn", (qs(B3 * H3),), kw, "ee_gn",
               B3 * H3),
              ("ee_gn rpy terminal", "ee_gn", (qs(B3),), kw, "ee_gn", B3),
              ("ee_err rpy line search", "ee_err", (qs(ALPHAS3 * B3 * H3),),
               kw, "ee_err", ALPHAS3 * B3 * H3),
              ("ee_err rpy terminal", "ee_err", (qs(ALPHAS3 * B3),), kw,
               "ee_err", ALPHAS3 * B3)]
    check_kernels(checks, q64, q32, smi, rows, row_tag="_fb16",
                  ee_names=foot_ee(q64))


def foot_path(q32, smi: str) -> dict:
    """Phase 18, path E (bench.py:509-537) through the port's entry points:
    ``ddp_solve`` of B3 quadrupeds (configs[3]'s start, gravity
    compensation) reaching TARGET_E with the first leaf, H3 knots, ITERS3
    iterations, ALPHAS3 line-search steps, float32, ``fused=True``.  One
    warm-up solve, then three timed ones with the counts set to 0 just
    before: per solve K1 H3 times, K2, K3 and K7 once an iteration, ee_gn
    twice an iteration (knots and terminal), ee_err twice for J0 and twice
    an iteration (the line search's stage and terminal costs), the plain
    sweep never.  J finite, nonincreasing and falling; its profile.
    Returns the counts of the three solves."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.kernels.fused import fd_step_fused
    from rbdtpu_torch.solver import ddp, trajectory_cost

    x0, U0 = quadruped_problems(q32, B3, H3, np.random.default_rng(SEED + 101))
    cost = foot_cost(q32)
    xs = [x0]
    for t in range(H3):
        xs.append(fd_step_fused(q32, xs[-1], U0[:, t].contiguous(), DT,
                                GRAVITY))
    J0 = trajectory_cost(cost, torch.stack(xs, dim=-2), U0)
    run = lambda: quadruped_solve(q32, x0, U0, ITERS3, True, cost=cost)
    run()
    torch.cuda.synchronize()
    plain_sweeps = []
    plain = ddp.backward_pass
    ddp.backward_pass = lambda *a, **kw: plain_sweeps.append(1) or plain(
        *a, **kw)
    _lib.reset_launches()
    try:
        (state, J_hist), times = timed_runs(run, warm=False)
    finally:
        ddp.backward_pass = plain
    counts = dict(_lib.launches)
    per_solve = {"fd_step": H3, "feedback_rollout": ITERS3,
                 "linearize_parts": ITERS3, "riccati_chunk": ITERS3,
                 "ee_gn": 2 * ITERS3, "ee_err": 2 + 2 * ITERS3}
    print(f"path E launches (3 solves): {counts}; per solve "
          f"{ {k: counts[k] / 3 for k in per_solve} }; plain sweeps "
          f"{len(plain_sweeps)}")
    for k, v in per_solve.items():
        require(counts[k] == 3 * v, f"path E: {k} launched {counts[k]} times "
                f"in 3 solves, expected {3 * v}")
    require(not plain_sweeps and counts["riccati_small"] == 0,
            "path E: the plain sweep or the small-batch site ran")
    require(tuple(J_hist.shape) == (ITERS3, B3), f"J_hist {J_hist.shape}")
    require(bool(J_hist.isfinite().all()), "path E: non-finite J")
    require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[0] <= J0 * (1 + 1e-6)).all()), "path E: J increased")
    require(J_hist[-1].mean() < J0.mean(), "path E: mean J did not fall")
    sec = statistics.median(times)
    print(f"path E: quadruped12 rpy foot reaching {foot_ee(q32)[0]} -> "
          f"{TARGET_E}, Bm={B3} H={H3} iters={ITERS3} alphas={ALPHAS3} f32 "
          f"fused: mean J {J0.mean().item():.6g} -> "
          f"{J_hist[-1].mean().item():.6g}; solve {sec * 1e3:.1f} ms (median "
          f"of 3: {' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) "
          f"= {B3 / sec:.1f} solves/s on {smi}")
    profile_main_path(run)
    return counts


def foot_parity(q64):
    """Path E in float64 at Bm=4 through the kernels and through the plain
    versions (K4's included) at each horizon of PARITY_E, ITERS3
    iterations: max |U_kernel - U_plain| < U_PARITY."""
    for Hp in PARITY_E:
        x0, U0 = quadruped_problems(q64, 4, Hp,
                                    np.random.default_rng(SEED + 102))
        sk, _ = quadruped_solve(q64, x0, U0, ITERS3, True, cost=foot_cost(q64))
        sp, _ = quadruped_solve(q64, x0, U0, ITERS3, False,
                                cost=foot_cost(q64, fused=False))
        du = (sk.U - sp.U).abs().max().item()
        dj = ((sk.J - sp.J).abs() / sp.J.abs().clamp(min=1)).max().item()
        print(f"path E parity f64 Bm=4 H={Hp} iters={ITERS3}: "
              f"max|U_kernel - U_plain| {du:.3e} (bound {U_PARITY:g}); max "
              f"rel |dJ| {dj:.3e}")
        require(du < U_PARITY, f"path E control parity at H={Hp}: {du:.3e} "
                f">= {U_PARITY:g}")


def push_wrenches(model, H: int, noise: float = 0.0, seed: int = 0,
                  newtons: float = PUSH_N):
    """(H, nb, 6) world-frame wrenches on ``model``'s device and dtype:
    ``newtons`` along +y on the trunk (body 0) for the knots of
    PUSH_KNOTS, over ``noise`` N(0,1) on every body (from ``seed``)."""
    import torch

    rng = np.random.default_rng(seed)
    F = noise * rng.standard_normal((H, model.nb, 6))
    F[PUSH_KNOTS[0]:PUSH_KNOTS[1], 0, 4] += newtons
    return torch.tensor(F, dtype=model.dtype, device=model.device)


def fext_kernels(models, smi: str, rows: dict):
    """Phase 19's kernel checks: K2 and K9 (NCHUNKS_F) with per-knot
    wrenches (``push_wrenches`` over 0.5 N(0,1)) against their plain
    versions on each of ``models`` ((label, m64, m32, K2's float64 inputs,
    row tag)): float64 within TOL64, float32 within TOL32, timed (K9's
    first count); then, in both dtypes, K2 and K9 under all-zero wrenches
    equal the wrench-free kernels bit for bit."""
    import torch
    from rbdtpu_torch.kernels import fused

    for i, (label, m64, m32, fb, tag) in enumerate(models):
        B, H = fb[2].shape[:2]
        F = push_wrenches(m64, H, 0.5, SEED + 110 + i)
        checks = [(f"feedback_rollout f_ext {label}", "feedback_rollout_fext",
                   fb, {"f_ext": F}, "feedback_rollout+fext", B * H)]
        checks += [(f"feedback_chunked f_ext {label} nchunks={c}",
                    "feedback_chunked_fext", fb, {"f_ext": F, "nchunks": c},
                    "feedback_chunked+fext", B * H) for c in NCHUNKS_F]
        check_kernels(checks, m64, m32, smi, rows, row_tag=tag,
                      time_all=False)
        for m in (m64, m32):
            args = tuple(a.to(m.dtype) for a in fb)
            Z = torch.zeros(H, m.nb, 6, dtype=m.dtype, device=m.device)
            pairs = [(fused.feedback_rollout_fused(m, *args, DT, GRAVITY,
                                                   f_ext=Z),
                      fused.feedback_rollout_fused(m, *args, DT, GRAVITY))]
            pairs += [(fused.feedback_rollout_fused_chunked(
                m, *args, DT, GRAVITY, nchunks=c, f_ext=Z),
                fused.feedback_rollout_fused_chunked(
                    m, *args, DT, GRAVITY, nchunks=c)) for c in NCHUNKS_F]
            same = all(torch.equal(a, b) for w, z in pairs
                       for a, b in zip(w, z))
            print(f"kernel feedback_rollout/feedback_chunked f_ext=0 {label} "
                  f"{str(m.dtype)[6:]}: equal to the wrench-free kernels bit "
                  f"for bit: {same}")
            require(same, f"K2/K9 with zero wrenches on {label} differ from "
                    "the wrench-free kernels")


class WrenchSpy:
    """Counts the calls of the step kernel's entry point (K1) with and
    without wrenches made through ``solver.ddp`` and ``solver.rollout``
    while it is entered."""

    def __enter__(self):
        from rbdtpu_torch.kernels import fused
        from rbdtpu_torch.solver import ddp

        self.calls = {"with": 0, "without": 0}
        self.saved = [(mod, mod.fd_step_fused) for mod in (ddp, fused)]
        real = fused.fd_step_fused

        def spy(*a, **kw):
            self.calls["with" if kw.get("f_ext") is not None
                       else "without"] += 1
            return real(*a, **kw)

        for mod, _ in self.saved:
            mod.fd_step_fused = spy
        return self

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod.fd_step_fused = fn


def push_path(q32, q64, h32, h64, smi: str) -> dict:
    """Phase 19's paths (path F): the port's push-recovery example on the
    card; configs[3]'s solve at full width under a trunk push (one warm-up,
    three timed solves: K1 H3 and K2 with wrenches ITERS3 a solve, no
    wrench-free K2; J finite, nonincreasing, falling); its float64 parity
    under the push at Bm=4, H=H3; path D under a trunk push (K9 with
    wrenches once an iteration, no wrench-free K9 or K2, J falling); and
    the hybrid at path C's shapes and configs[4]'s sigma, float64 kernels
    against plain on hybrid_parity's normals, under a push of
    PUSH_HYBRID_N and under PUSH_N (there beside the plain route's floor).
    Returns the launches by (kernel, size class) of three path runs, each
    counted from 0: configs[3]'s three solves, path D's three solves and
    the hybrid's kernel route under PUSH_N."""
    import torch
    from rbdtpu_torch.examples import push_recovery
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import rollout, trajectory_cost

    _lib.reset_launches()
    with WrenchSpy() as spy:
        t = time.perf_counter()
        aware, oblivious = push_recovery.run("cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
    ex = dict(_lib.launches)
    print(f"path F push recovery (rbdtpu_torch/examples/push_recovery.py, "
          f"B={push_recovery.B} H={push_recovery.H} iters="
          f"{push_recovery.ITERS}, f32, kernels): disturbed cost aware plan "
          f"{aware:.6g}, oblivious plan {oblivious:.6g}; {sec:.2f} s for both "
          f"solves and the scoring rollout; launches {ex}; K1 calls with "
          f"wrenches {spy.calls['with']}, without {spy.calls['without']} "
          f"({smi})")
    require(aware < oblivious, "path F: the disturbance-aware plan does not "
            "beat the oblivious one under the push")
    require(spy.calls["with"] >= 2 * push_recovery.H
            and ex["feedback_rollout_fext"] == push_recovery.ITERS
            and ex["feedback_rollout"] == push_recovery.ITERS,
            f"path F example: K1 with wrenches {spy.calls}, K2 {ex}")

    x0, U0 = quadruped_problems(q32, B3, H3, np.random.default_rng(SEED + 30))
    F = push_wrenches(q32, H3)
    J0 = trajectory_cost(quadruped_cost(q32),
                         rollout(q32, x0, U0, DT, GRAVITY, fused=True,
                                 f_ext=F), U0)
    run = lambda: quadruped_solve(q32, x0, U0, ITERS3, True, f_ext=F)
    run()
    torch.cuda.synchronize()
    _lib.reset_launches()
    with WrenchSpy() as spy:
        (state, J_hist), times = timed_runs(run, warm=False)
    q3, q3_class = dict(_lib.launches), dict(_lib.class_launches)
    sec = statistics.median(times)
    print(f"path F configs[3] under a push of {PUSH_N:g} N on the trunk at "
          f"knots {PUSH_KNOTS[0]}-{PUSH_KNOTS[1] - 1}: Bm={B3} H={H3} iters="
          f"{ITERS3} f32 fused: mean J {J0.mean().item():.6g} -> "
          f"{J_hist[-1].mean().item():.6g}; solve {sec * 1e3:.1f} ms (median "
          f"of 3: {' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) "
          f"= {B3 / sec:.1f} solves/s; launches (3 solves) {q3}; K1 calls "
          f"with wrenches {spy.calls['with']}, without "
          f"{spy.calls['without']} on {smi}")
    require(spy.calls == {"with": 3 * H3, "without": 0}
            and q3["feedback_rollout_fext"] == 3 * ITERS3
            and q3["feedback_rollout"] == 0 and q3["feedback_chunked"] == 0,
            f"path F configs[3]: K1 {spy.calls}, launches {q3}")
    require(bool(J_hist.isfinite().all()), "path F configs[3]: non-finite J")
    require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[0] <= J0 * (1 + 1e-6)).all()), "path F configs[3]: J rose")
    require(J_hist[-1].mean() < J0.mean(), "path F configs[3]: J did not "
            "fall")

    x0, U0 = quadruped_problems(q64, 4, H3, np.random.default_rng(SEED + 40))
    F64 = push_wrenches(q64, H3)
    sk, _ = quadruped_solve(q64, x0, U0, ITERS3, True, f_ext=F64)
    sp, _ = quadruped_solve(q64, x0, U0, ITERS3, False, f_ext=F64)
    du = (sk.U - sp.U).abs().max().item()
    dj = ((sk.J - sp.J).abs() / sp.J.abs().clamp(min=1)).max().item()
    print(f"path F configs[3] parity f64 under the push Bm=4 H={H3} iters="
          f"{ITERS3}: max|U_kernel - U_plain| {du:.3e} (bound {U_PARITY:g}); "
          f"max rel |dJ| {dj:.3e}")
    require(du < U_PARITY, f"path F control parity: {du:.3e}")

    x0, U0 = humanoid_problems(h32, BD, HH, np.random.default_rng(SEED + 92))
    FD = push_wrenches(h32, HH)
    J0 = trajectory_cost(humanoid_cost(h32),
                         rollout(h32, x0, U0, DT, GRAVITY, fused=True,
                                 f_ext=FD), U0)
    run = lambda: humanoid_solve(h32, x0, U0, True, f_ext=FD)
    run()
    torch.cuda.synchronize()
    _lib.reset_launches()
    (state, J_hist), times = timed_runs(run, warm=False)
    pd, pd_class = dict(_lib.launches), dict(_lib.class_launches)
    sec = statistics.median(times)
    print(f"path F path D under a push of {PUSH_N:g} N on the trunk: Bm={BD} "
          f"H={HH} iters={ITERS_H} alphas={ALPHAS_H} f32 fused_feedback=True:"
          f" mean J {J0.mean().item():.6g} -> {J_hist[-1].mean().item():.6g};"
          f" solve {sec * 1e3:.1f} ms (median of 3: "
          f"{' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events); "
          f"launches (3 solves) {pd} on {smi}")
    require(pd["feedback_chunked_fext"] == 3 * ITERS_H
            and pd["feedback_chunked"] == 0 and pd["feedback_rollout"] == 0
            and pd["feedback_rollout_fext"] == 0,
            f"path F path D: launches {pd}")
    require(bool(J_hist.isfinite().all()) and bool(
        (J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[-1] < J0).all()), "path F path D: J not finite or not "
        "falling")

    for newtons, floor_times in ((PUSH_HYBRID_N, None),
                                 (PUSH_N, FLOOR_TIMES)):
        hy, hy_class = hybrid_parity(
            h64, smi, f_ext=push_wrenches(h64, HH, newtons=newtons),
            sigmas=(SIGMA_H,), tag=f"path F hybrid {newtons:g} N",
            floor_times=floor_times)
        require(hy["feedback_rollout_fext"] == ITERS_H
                and hy["feedback_rollout"] == 0,
                f"path F hybrid {newtons:g} N: K2 launches {hy}")
    return q3_class, pd_class, hy_class


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.model import load_asset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clock = time.perf_counter()

    def mark(phase: int):
        print(f"chip_smoke: phase {phase} from {time.perf_counter() - clock:.1f} "
              "s")

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
        ptxas = ptxas_summary(f.read())
    for line in ptxas:
        print(line)
    team_stack_check(ptxas)

    mark(2)
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
    check_kernels(team_checks(m64, inputs64["fd_step"],
                              inputs64["feedback_rollout"], "arm7"),
                  m64, m32, smi, rows, time_all=False)
    team_report("arm7", m64, m32, inputs64["fd_step"],
                inputs64["feedback_rollout"])

    mark(3)
    # ---- 3. the main path: arm7 EE reaching DDP, float32, kernels ----
    Bm, H, iters = 128, 100, 10
    counts, x0, U0 = arm_path(m32, smi, "main path", Bm, H, iters)
    for kname in DDP_KERNELS:
        require(counts[kname] > 0, f"{kname} was not launched on the main path")
        rows[kname]["launches"] = counts[kname]

    mark(4)
    # ---- 4. solver parity in float64: kernels vs plain versions ----
    arm_parity(m64, "parity", iters)

    mark(5)
    # ---- 5. where the main path's time goes ----
    profile_main_path(lambda: solve(m32, x0, U0, fused=True, iters=iters))

    mark(6)
    # ---- 6. the rollout path's kernels against their plain versions, after
    # the DDP path so that its host-bound solve runs in the same process
    # state as before they existed ----
    check_kernels(rollout_inputs(m64, np.random.default_rng(SEED + 3)),
                  m64, m32, smi, rows)

    mark(7)
    # ---- 7. the rollout path: 4096 x H=50 arm7 rollouts, float32 ----
    counts = rollout_path(m32, np.random.default_rng(SEED + 4), smi)
    for kname in ROLLOUT_KERNELS:
        require(counts[kname] > 0,
                f"{kname} was not launched on the rollout path")
        rows[kname]["launches"] = counts[kname]
    rows["rnea"]["launches"] = counts["rnea"]

    mark(8)
    # ---- 8. the Riccati sweep kernel against the plain sweep ----
    check_riccati(smi, rows)

    mark(9)
    # ---- 9. K1-K3 on the rpy floating root, at configs[3]'s shapes ----
    q64 = load_asset("quadruped12", device="cuda", dtype=torch.float64,
                     floating_base=True)
    q32 = load_asset("quadruped12", device="cuda", dtype=torch.float32,
                     floating_base=True)
    qin = quadruped_kernel_inputs(q64, np.random.default_rng(SEED + 5))
    q_states = {"fd_step": B3, "feedback_rollout": ALPHAS3 * B3 * H3,
                "linearize_parts": B3 * H3}
    check_kernels([(f"{k} rpy", k, qin[k], {}, k, q_states[k]) for k in qin],
                  q64, q32, smi, rows)
    check_kernels(team_checks(q64, qin["fd_step"], qin["feedback_rollout"],
                              "rpy"), q64, q32, smi, rows, time_all=False)
    check_kernels(minv_rnea_checks(q64, qin["fd_step"], "rpy",
                                   *step_extras(q64, B3, SEED + 6)),
                  q64, q32, smi, rows)
    team_report("rpy quadruped", q64, q32, qin["fd_step"],
                qin["feedback_rollout"])

    mark(10)
    # ---- 10. the configs[3] path: 1024 quadruped MPC problems, float32 ----
    counts = quadruped_path(q32, smi)
    rows["riccati_chunk"]["launches"] = counts["riccati_chunk"]

    mark(11)
    # ---- 11. configs[3] control parity, kernels vs plain, float64 ----
    counts = quadruped_parity(q64)
    require(counts["riccati_small"] > 0,
            "the sweep's small-batch call site was not launched")
    rows["riccati_small"]["launches"] = counts["riccati_small"]

    mark(12)
    # ---- 12. the arm-class Riccati sweep kernel (K11) against the plain
    # sweep ----
    check_riccati_fused(smi, rows)

    mark(13)
    # ---- 13. path A: configs[2] with the backward pass through K11 ----
    counts, x0, U0 = arm_path(m32, smi, "path A", Bm, H, iters,
                              fused_riccati=True)
    require(counts["riccati_fused"] == 3 * iters,
            f"path A: riccati_fused launched {counts['riccati_fused']} times "
            f"in 3 solves, expected {3 * iters}")
    for kname in DDP_KERNELS:
        require(counts[kname] > 0, f"path A: {kname} was not launched")
    rows["riccati_fused"]["launches"] = counts["riccati_fused"]
    profile_main_path(lambda: solve(m32, x0, U0, fused=True, iters=iters,
                                    fused_riccati=True),
                      extra=("backward_pass_fused",))
    arm_parity(m64, "path A parity", iters, fused_riccati=True)

    mark(14)
    # ---- 14. path B: the closed-loop MPC loop ----
    mpc_path(m32, m64, smi)

    mark(15)
    # ---- 15. the humanoid's kernels: K1-K3 at fb32 and K9 ----
    h64 = load_asset("humanoid30", device="cuda", dtype=torch.float64,
                     floating_base=True)
    h32 = load_asset("humanoid30", device="cuda", dtype=torch.float32,
                     floating_base=True)
    hin = humanoid_kernels(
        h64, h32, (m64, m32, inputs64["feedback_rollout"], 1024 * 100),
        (q64, q32, qin["feedback_rollout"], ALPHAS3 * B3 * H3), smi, rows,
        ptxas)

    mark(16)
    # ---- 16. path C: configs[4], the humanoid MPPI -> DDP hybrid ----
    counts = hybrid_path(h32, smi)
    rows["fd_step_fb32"]["launches"] = counts["fd_step"]
    rows["feedback_rollout_fb32"]["launches"] = counts["feedback_rollout"]
    hybrid_parity(h64, smi)

    mark(17)
    # ---- 17. path D: the 256-problem humanoid DDP on the K9 tier ----
    counts = humanoid_ddp_path(h32, h64, smi)
    for kname in ("linearize_parts", "feedback_chunked"):
        require(counts[kname] > 0, f"{kname} was not launched on path D")
    rows["linearize_parts_fb32"]["launches"] = counts["linearize_parts"]
    rows["feedback_chunked"]["launches"] = counts["feedback_chunked"]

    mark(18)
    # ---- 18. path E: quadruped foot reaching, K4 on the rpy root ----
    foot_kernels(q64, q32, smi, rows)
    counts = foot_path(q32, smi)
    for k in ("ee_gn", "ee_err"):
        rows[f"{k}_fb16"]["launches"] = counts[k]
    foot_parity(q64)

    mark(19)
    # ---- 19. path F: robust MPC, K2 and K9 with wrenches ----
    # K2 and K9 with wrenches are team kernels too: at fb32 in float64 they
    # run within the stack limit the earlier phases left
    limit = _lib.stack_limit(h64.device)
    fext_kernels([
        ("arm7", m64, m32, inputs64["feedback_rollout"], ""),
        ("rpy quadruped", q64, q32, qin["feedback_rollout"], "_fb16"),
        ("humanoid", h64, h32, hin["feedback_rollout"], "_fb32")],
        smi, rows)
    grown = _lib.stack_limit(h64.device)
    print(f"stack limit {limit} B a thread before K2 and K9 with wrenches, "
          f"{grown} B after them ({smi})")
    require(grown == limit, f"K2 or K9 with wrenches raised the stack limit "
            f"from {limit} to {grown} B a thread")
    # each row's launches from one path run counted from 0, by size class:
    # K2 with wrenches at fb16 from configs[3]'s solves under the push, at
    # fb32 from the hybrid's under PUSH_N, K9 with wrenches at fb32 from
    # path D's; arm7's (n8) K2 and K9 with wrenches and the quadruped's K9
    # with wrenches, held against their plain versions above, are launched
    # by no path (the quadruped's line search takes K2): configs[3]'s run
    # reads them
    q3_class, pd_class, hy_class = push_path(q32, q64, h32, h64, smi)
    for row, kname, cls, run in (
            ("feedback_rollout_fext_fb16", "feedback_rollout_fext", "fb16",
             q3_class),
            ("feedback_rollout_fext_fb32", "feedback_rollout_fext", "fb32",
             hy_class),
            ("feedback_chunked_fext_fb32", "feedback_chunked_fext", "fb32",
             pd_class),
            ("feedback_rollout_fext", "feedback_rollout_fext", "n8",
             q3_class),
            ("feedback_chunked_fext", "feedback_chunked_fext", "n8",
             q3_class),
            ("feedback_chunked_fext_fb16", "feedback_chunked_fext", "fb16",
             q3_class)):
        rows[row]["launches"] = run.get((kname, cls), 0)
    for row in ("feedback_rollout_fext_fb16", "feedback_rollout_fext_fb32",
                "feedback_chunked_fext_fb32"):
        require(rows[row]["launches"] > 0, f"{row} was not launched on path F")

    print(f"chip_smoke: phases 1-19 took {time.perf_counter() - clock:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        {k: rows[n_][k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "graph_ms") if k in rows[n_]}
        for n_ in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
