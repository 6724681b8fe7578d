#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rbdtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending the run with a nonzero exit when it fails:

1. identify the card (name, power limit), build the CUDA kernels from
   ``rbdtpu_torch/csrc`` and require every instantiation of the team
   kernels K1 (``fd_step``), K2 (``feedback_rollout``), K3
   (``linearize_parts``), K5 (``rollout_multi``), K6 (``fd_step_minv``),
   K9 (``feedback_chunked``) and K10 (``rnea``), of the end-effector
   kernels K4 (``ee_gn``, ``ee_err``, and their floating-root kernel
   ``ee_root``) and of the Riccati sweeps (``riccati``, K7/K8, and
   ``riccati_fused``, K11) in the build with a ptxas stack frame under
   1,024 bytes, the floating roots' instantiations of K5 (fb16, fb32,
   fq32) and the quaternion root's ("fq32": every tree kernel) among
   them;
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
   per kernel (a trace of the CUDA activity alone), the kernels a solve
   launches and the device's idle share;
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
   kernels (``mpc_run``: configs[2]'s cost and dt, H=100, 50 ticks under
   K11 and 20 under the host-bound references,
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
19. path F, robust MPC under world wrenches: K2 and K9 (nchunks 2; 1 and
   3 at 37 trajectories) with a per-knot wrench set (a trunk push window
   on 0.5 N(0,1)) against their plain versions on arm7 (1,024 x 100), the
   rpy quadruped (configs[3]'s 6 x 1,024 x 50) and the humanoid (path D's
   1,024 x 32), each timed, and with all-zero wrenches equal to the
   wrench-free kernels bit for bit; the port's push-recovery example on
   the card (the aware plan must beat the oblivious one, K1 and K2
   launched with wrenches); configs[3]'s solve at full width under a push
   (ms a solve, launches, J falling); float64 kernels against plain under the push at
   Bm=4, H=50 (|dU| < 1e-6); path D under a trunk push (K9 with wrenches
   once an iteration, no wrench-free K9 or K2); and the hybrid at path C's
   shapes (2 MPPI and 2 DDP iterations) under a 20 N trunk push in
   float64, kernels against plain on the same normals (|dU| < 1e-6,
   relative |dJ| < 1e-9), beside the plain route's own parting when its
   start moves by 1e-13;
20. paths G and H, the quaternion root (humanoid30 with ``root_quat=True``,
   K1-K4's "fq32" instantiations): K1 at path G's 2,048 sampled states,
   K2 at its 64 line-search trajectories x 32 knots, K3 at its 512 knots,
   ee_gn at 512 knots and 16 terminal states and ee_err at 2,048 and 64
   (path H's) against their plain versions (float64 <= 1e-9, float32
   relative), timed by one call and by graph replay beside their bounds,
   K1/K2's extra checks, the stack limit unchanged across them; path G,
   configs[4]'s hybrid on the quaternion root (bench.py:539-590 with
   root_quat=True: path C's shapes and solver, the identity quaternion at
   0.9 retracted by 0.02 N(0,1)), with path C's launch and J checks and a
   profile; path H, humanoid hand reaching (bench.py:640-672: 16
   problems, H=32, 5 iterations of 4 line-search steps, the left wrist
   toward [0.35, 0.25, 1.1], float32): per solve K1 32, K2, K3 and K8 5,
   ee_gn 10, ee_err 12, J finite, nonincreasing and falling, a profile;
   then both in float64 at Bm=4, H=32 through the kernels and through the
   plain route (|dU| < 1e-6, relative |dJ| < 1e-9 over the J history, or
   phase 19's rule against the plain route's own floor where |dJ| passes
   1e-9);
21. second order: IDSVA-SO's native sweep against forward-mode AD in
   float64 on arm7, the rpy and the quaternion quadruped (4 states each)
   and the quaternion humanoid (1 state), max |native - AD| <= 1e-9; path
   I, exact-Hessian ("full") DDP on the rpy quadruped
   (tools/bench_fbddp.py: Bm=64, H=32, 10 iterations, 6 line-search
   steps, configs[3]'s start and cost), first in float64 at Bm=4, H=8
   through the kernels against the plain route (|dU| < 1e-6, relative
   |dJ| < 1e-9, J finite and nonincreasing, K1, K2 and K3 each launched),
   then in float32 beside iLQR on the same problems: ms a solve, mean J an
   iteration, the iteration within 0.1% of each floor, K1/K2/K3 launches
   by size class, a profile with the FDSVA-SO assembly and the backward
   sweep apart; then the IDSVA cells in float32, native against AD in
   eval/s by CUDA events (arm7 at 2,048 states x 8 calls, bench.py:674-707;
   the quaternion humanoid at 256 x 4 natively and 4 x 1 by AD,
   bench.py:593-638).  Each step of phase 21 prints its peak device
   memory.  Phase 21 also holds K1-K3 at path I's own shapes (K1 at 64
   states, K2 at 6 x 64 trajectories over 32 knots, K3 at 2,048 knots)
   against their plain versions, float64 <= 1e-9 and float32 at TOL32;
22. paths J and K, the quaternion root's remaining kernels ("fq32": K9,
   K2 and K9 with wrenches, K6, K10): K9 at path J's 1,024 trajectories x
   32 knots at nchunks 2 (1, 3 and 100 at 37 trajectories) and at 1, 37
   and 1,000 trajectories, K2 with wrenches at path G's 64 x 32 and K9 with
   wrenches (two chunks) at 1,024 x 32 under a trunk push over 0.5
   N(0,1) wrenches (and under zero wrenches bit for bit the wrench-free
   kernels), K10 with and without qdd and K6 on both routes with and
   without wrenches at path G's 2,048 states, against their plain versions
   (float64 <= 1e-9, float32 relative), timed beside their bounds, the
   stack limit unchanged across them; path J, path D's DDP at fleet batch
   (256 problems, H=32, 4 iterations of 4 steps, float32) on the
   quaternion humanoid from path G's start with its cost, on the K9
   (``fused_feedback=True``, two chunks), K2 and plain line-search tiers:
   ms a solve, launches by size class, J finite, nonincreasing and
   falling, a profile of the K9 tier; its float64 tier parity (K9 against
   the plain pass, |dU| < 1e-6, relative |dJ| < 1e-9) at the smallest
   batch the port's rule sends to K9 with two chunks; path K, path G's
   hybrid and path J's K9 tier under path F's 80 N trunk push (K1, K2 and
   K9 only with wrenches), then float64 parity of the hybrid at 4
   problems (2 MPPI and 2 DDP iterations), kernels against plain on the
   same normals, under 20 N
   (relative |dJ| < 1e-9) and under 80 N (below 100 times the plain
   route's own floor where it passes 1e-9), and of the K9 tier under 80 N;
23. paths L and M, the last kernel gaps (K5 at fb16, fb32 and fq32; K4 at
   fb32): K5 against its plain version in float64 on the rpy quadruped,
   the rpy humanoid and the quaternion humanoid at 512 trajectories x 50
   steps, both routes, with and without path F's trunk push (<= 1e-9;
   zero wrenches bit for bit the wrench-free kernel in both dtypes), K4
   at fb32 at path M's shapes (ee_gn at 512 and 16 states, ee_err at
   2,048 and 64), the stack limit unchanged across them and K4 fb32's
   stack within 288 B; path L, ``rollout_fused_multi`` at 4,096 x 50 in
   float32 on the three models, both routes, with and without the push
   (four launches of K5 at the model's class, none of K1 or K6, final
   states finite and within 1e-3 relative of ``rollout_multi_plain``'s
   on the same inputs), beside the K1 scan (``solver.rollout(fused=True)
   ``), whose final state the aba route's equals bit for bit, each timed
   (steps/s, median of 7, and device time by graph replay); path M, path
   H on the rpy root (bench.py:640-672 with root_quat=False: 16
   humanoids, H=32, 5 iterations, float32) with path H's launch, J and
   profile checks, one solve of its cost inside ``add_limit_barrier``
   from a start pushed past three of the arm's limits, and float64 parity
   kernels against plain at 4 problems over 16 knots with and without the
   barrier (|dU| < 1e-6, relative |dJ| < 1e-9 or phase 19's floor rule),
   the barrier's hinges active after the first knot;
24. path N, the sharded fleet (``rbdtpu_torch.distrib``): configs[2]'s
   solve (Bm=128, H=100, 10 iterations, 8 steps, float32, ``fused=True``)
   through ``sharded_ddp_solve`` on two ranks sharing the card over gloo,
   started by ``python -m rbdtpu_torch.distrib.launch`` (each rank
   launching K1-K4 and holding its rows to its process-local solve of
   them bit for bit), then at world size 1 over NCCL in this process
   (``make_mesh`` from the torchrun environment; K1-K4 launched; bit for
   bit the unsharded ``ddp_solve``, whose J is finite and
   nonincreasing); the ranks' J against the unsharded solve's within the
   larger of 1e-4 and 100 times its own floor measured in the same run,
   and in float64 at Bm=8, H=20 (|dU| < 1e-6, relative |dJ| < 1e-9);
   configs[4]'s population-sharded MPPI update (``sharded_mppi_step``,
   the rpy humanoid, 2,048 samples, H=32, sigma 0.3, float64) on the two
   ranks against one rank on the same normals (<= 1e-9); the compat
   mirror (``RBDReferenceTorch``) on the card against the CPU in float64
   on arm7, the rpy quadruped and the quaternion humanoid (<= 1e-9).
   Ranks that share one card check the harness; their times are no
   scaling result;
25. path O, the model-specialised kernels (K0, ``specialize=True``,
   ``rbdtpu_torch/kernels/codegen.py``): build the generated libraries of
   arm7 and the rpy quadruped in float32 and float64 (one nvcc a source,
   all at once; each source's build seconds and each function's ptxas
   registers, stack and spills printed); hold ``rnea_static`` (bias, with
   qdd), ``fd_step_static`` (bare, (nb, 6) and (B, nb, 6) wrenches),
   ``fd_step_minv_static`` (both routes, with and without wrenches) and
   ``rollout_multi_static`` (both routes, with and without per-knot
   wrenches, 10 steps) against their plain lane versions and their table
   twins on the same inputs (float64 <= 1e-9, float32 the twin's
   relative bound; each call launching its kernel alone), arm7's K1 at
   128 states and K6 and K10 at 4,096, the quadruped's at 1,024, each
   timed beside its twin; then path O: ``rollout_fused_multi(...,
   specialize=True)`` at 4,096 x 50 in float32 on arm7 (the rollout
   path's inputs, with and without per-knot wrenches) and on the
   quadruped (path L's, with and without the push), 10 steps of the
   specialised K1 and K6 (both routes) against the specialised K5 and the
   hold torques at the final states by the specialised K10, launching
   only the specialised kernels; each rollout held against its plain lane
   rollout and the table K5 (1e-3 relative), its final state finite,
   timed (steps/s, median of 7, and by graph replay) beside the table K5.
   ``chip_smoke.static_phase(smi, {})`` runs it alone after ``_lib.build()``.
   Its build also compiles phase 26's sources and the effector libraries,
   every source at once;
26. paths P and Q, the DDP solve on the model-specialised kernels:
   ``feedback_rollout_static`` (K2·K0; bare, with a clamp, with the clamp
   under per-knot wrenches), ``linearize_parts_static`` (K3·K0, one thread
   a derivative column) and ``ee_gn_static`` / ``ee_err_static`` (K4·K0,
   the effector folded in) on arm7 and the rpy quadruped, each against its
   plain lane version and its table twin at the table rows' shapes
   (float64 <= 1e-9, float32 the twin's relative bound), timed beside the
   twin with its bound; path P, configs[2] (Bm=128, H=100, 10 iterations,
   float32) through ``DDPConfig(fused=True, specialize=True)`` and
   ``ee_reaching_cost(specialize=True)``: K1·K0-K4·K0 launched, no table
   K1-K4, J finite, nonincreasing and falling, ms a solve beside the table
   route's, a profile; path Q, configs[3] (Bm=1,024, H=50, 5 iterations)
   likewise with K1·K0, K2·K0, K3·K0 and the table K7; each in float64 at
   Bm=4, H=20 against the plain route and the table route (|dU| < 1e-6).
   ``chip_smoke.solver_static_phase(smi, {})`` runs it alone after
   ``_lib.build()`` (~95 s with its build).

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
# wrenches; K5 at n8, fb16, fb32 and fq32 in 2 dtypes x 2 routes x with
# and without wrenches; K4 and each sweep in 2 dtypes; K4 on the floating
# roots (ee_root: fb16, fb32 and fq32, both modes, 2 dtypes) and K2 and K9
# with wrenches at every class in both walks; on the quaternion root's
# class fq32 K1-K4, K9, K6 and K10 too, K1 with and without wrenches, K2,
# K9 and K2/K9 with wrenches in both walks), and K1/K2's extra checks run
# these batches
TEAM_KERNELS = ("fd_step", "feedback_rollout")
STACK_INSTANCES = {"fd_step": 16, "feedback_rollout": 16,
                   "linearize_parts": 8, "feedback_chunked": 16,
                   "rollout_multi": 32, "ee_gn": 2, "ee_err": 2,
                   "riccati": 2, "riccati_fused": 2, "rnea": 16,
                   "fd_step_minv": 32, "ee_root": 12,
                   "feedback_rollout_fext": 16, "feedback_chunked_fext": 16}
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
# the plain sweep's and the parallel scan's runs, host-bound at 120-470 ms a
# tick, take fewer ticks (the script's time; K11's runs keep MPC_TICKS)
MPC_TICKS_REF = 20
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
# the trajectories of phases 19 and 22's K9 checks at the chunk counts no
# path takes
CUT_B = 37
# the float64 hybrid parities under a push (paths F and K) run this many
# MPPI and DDP iterations (path C's shapes otherwise; 4 and 4 before phase
# 25 took their time)
MPPI_ITERS_PUSH, ITERS_PUSH = 2, 2
# paths G and H, the quaternion root (humanoid30 with root_quat=True, the
# "fq32" size class of K1-K4): path G is configs[4] on it (path C's
# shapes, bench.py:539-590 with root_quat=True), path H humanoid hand
# reaching (bench.py:640-672): the left wrist toward TARGET_Q, ITERS_Q
# iterations, path C's problems, knots and line-search steps, weights WE.
# Their float64 parity runs at BQ_PARITY problems over HH knots.
TARGET_Q, EE_Q, ITERS_Q, BQ_PARITY = ((0.35, 0.25, 1.1),
                                      ("left_arm_wrist_roll",), 5, 4)
# path I, exact-Hessian ("full") DDP on the rpy quadruped at
# tools/bench_fbddp.py's shapes: BI problems, HI knots, ITERS_I iterations,
# configs[3]'s start, tracking cost and line-search steps, beside iLQR on
# the same problems; its float64 kernels-vs-plain check at BI_PARITY
# problems over HI_PARITY knots.  The IDSVA cells: arm7 at B_SO states x
# R_SO calls (bench.py:674-707), the quaternion humanoid at B_SO_H x
# R_SO_H natively and B_SO_AD x 1 by AD (bench.py:593-638); the float64
# native-vs-AD checks at B_SO_CHECK states (the humanoid at 1).
BI, HI, ITERS_I, BI_PARITY, HI_PARITY = 64, 32, 10, 4, 8
B_SO, R_SO, B_SO_H, R_SO_H, B_SO_AD, B_SO_CHECK = 2048, 8, 256, 4, 4, 4
# paths J and K, the quaternion humanoid at fleet batch and under a push:
# path J is path D's DDP stage (BD problems, HH knots, ITERS_H iterations,
# ALPHAS_H line-search steps) from path G's start with path G's cost on the
# line search's three tiers (fused_feedback True: K9 at fq32, None: K2,
# False: the plain pass); path K is path G's hybrid and path J's K9 tier
# under path F's trunk push.  Their float64 tier parity runs at the
# smallest batch whose line search the port's rule sends to K9 with
# NCHUNKS_D chunks (``quat_parity_batch``), the hybrid's at BQ_PARITY.
J_TIERS = (True, None, False)
# path L, whole-horizon legged rollouts: BL trajectories of HL steps on the
# rpy quadruped (configs[3]'s start), the rpy humanoid (path C's) and the
# quaternion humanoid (path G's) under hold controls plus SIGMA_L N(0,1),
# with and without path F's trunk push; K5's checks at BL_CHECK x HL.
# Path M, the rpy humanoid's hand reaching: path H's shapes, cost and
# solver on the rpy root (bench.py:640-672 with root_quat=False), its
# float64 parity at BQ_PARITY problems over HM_PARITY knots; K4 at fb32
# keeps its stack within EE_STACK_MAX bytes.
BL, HL, BL_CHECK, SIGMA_L = 4096, 50, 512, 0.2
HM_PARITY, EE_STACK_MAX = 16, 288
# path N, the sharded fleet: configs[2]'s solve (the main path's problems
# and solver) through ``distrib.sharded_ddp_solve``, at world size 1 over
# NCCL in this process and on N_RANKS ranks sharing the card over gloo
# (``distrib.launch``, entry ``path_n_rank``), its float64 check at
# BN_CHECK problems over HN_CHECK knots; configs[4]'s population-sharded
# MPPI update (path C's BH x SAMPLES_H samples, HH knots, SIGMA_H) on the
# rpy humanoid in float64, the ranks held against one rank on the same
# normals within MPPI_N_TOL (relative).  Each rank's rows must equal its
# process-local solve of them bit for bit.  A few of configs[2]'s problems
# part from themselves by O(1) in J when x0 moves by 1e-13, so the ranks
# are held to the unsharded solve in float64 at configs[2]'s own shapes by
# phase 19's floor rule (TOL64, or FLOOR_TIMES times the unsharded solve's
# parting from itself at that move) on the upper quartile over the
# problems; their float32 parting is printed, and ``path_n_split`` finds
# which operators round by batch size.
N_RANKS, BN, HN, ITERS_N, BN_CHECK, HN_CHECK = 2, 128, 100, 10, 8, 20
MPPI_N_TOL = 1e-9


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


def timed_call(fn):
    """(fn(), the milliseconds of that one call by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
    B, nq = x.shape[0], model64.nq
    q, qd = x[:, :nq].contiguous(), x[:, nq:].contiguous()
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
                            specialize=options.get("specialize", False),
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
    r"N3rbd4DimsILi(\d+)ELb([01])EEE|Lb([01])E|([fd])|Li(\d+)E"
    r"|N3rbd8DimsQuatILi(\d+)EEE")


def template_args(tail: str) -> list:
    """The template arguments of a mangled kernel name's tail
    (``I...E``): the scalar type, the size class ``Dims<NB, FB>`` or
    ``DimsQuat<NB>``, the
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
        elif m.group(6):
            args.append(f"DimsQuat<{m.group(6)}>")
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


def profile_main_path(solve_once, extra=(), cpu: bool = True):
    """Where one solve (``solve_once()``) spends its time: per-phase wall
    time (each phase synchronised, so the total exceeds an unsynchronised
    solve; ``extra`` names further phases of ``solver.ddp``), then
    torch.profiler's device time per kernel, the kernels launched per solve
    and the device's idle share against an unprofiled solve.  ``cpu=False``
    traces the CUDA activity alone (kernels and runtime calls, no torch
    operators): for a solve of tens of thousands of operators, whose
    trace would take a minute."""
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
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
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
                  time_all: bool = True, ee_names=None,
                  float32: bool = True) -> dict:
    """Hold each kernel against its plain version (float64 max abs error
    <= TOL64, float32 relative error <= TOL32), time both in float32 and
    compute the bound.  ``checks``: (label, kernel name, float64 args,
    keyword args, operations key, states x steps).  The first check of a
    kernel gives its row of the JSON line (named kernel name + row_tag);
    the row's max_abs_err is the largest over the kernel's checks.  With
    ``time_all=False`` only that first check is timed.  ``ms`` is one
    call's time with its launch (``cuda_ms``) for every kernel; the rows
    of GRAPH_KERNELS add the device's time alone (``graph_ms``); the
    plain version's is its float32 check's own call (``timed_call``, after
    its float64 call has run the same code).  Fails
    after printing every check.  ``ee_names`` names K4's end effector on a
    model of several leaves (for its operation count).  With
    ``float32=False`` only the float64 check runs: the caller holds and
    times the float32 kernel at its path's shape and completes the row
    (ms, plain_ms, bound_ms, bound_by)."""
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
        err64 = max(e64)
        if err64 > TOL64:
            failures.append(f"{label}: float64 max abs error {err64:.3e} > "
                            f"{TOL64:g}")
        shapes = " ".join(str(tuple(a.shape)) for a in a64)
        fmt = lambda es: "[" + " ".join(f"{e:.2e}" for e in es) + "]"
        if not float32:
            print(f"kernel {label}: inputs {shapes}  f64 max|err| "
                  f"{fmt(e64)} (float32 held and timed at its path's shape; "
                  f"{smi})")
            rows.setdefault(row, dict(name=row, route="cuda", source=source,
                                      replaces=replaces, max_abs_err=err64,
                                      library_ms=None))
            rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], err64)
            continue
        timed = time_all or row not in rows
        k32 = kern(m32, *a32, **kw32)
        p32, plain_ms = timed_call(lambda: plain(m32, *a32, **kw32))
        e32 = errors(k32, p32, relative=True)
        torch.cuda.synchronize()
        err32 = max(e32)
        if err32 > TOL32[kname]:
            failures.append(f"{label}: float32 relative error {err32:.3e} > "
                            f"{TOL32[kname]:g}")
        ops = flops[ops_key] * states
        bound_ms, bound_by = bound((*a32, *kw32.values()), k32, m32, ops,
                                   "float32")
        timing, gms = "not timed", None
        if timed:
            ms = cuda_ms(lambda: kern(m32, *a32, **kw32), reps=20)
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
                    f_ext=None, **options):
    """configs[3]'s ``ddp_solve`` (with ``cost`` in place of its tracking
    cost, and under the wrenches ``f_ext``, when given; ``options`` are
    further DDPConfig fields: path I's ``exact_hessians``);
    ``kernels=False`` takes every plain version (the plain sweep
    included)."""
    from rbdtpu_torch.solver import DDPConfig, ddp_solve

    cfg = DDPConfig(iters=iters, dt=DT, gravity=GRAVITY, n_alphas=ALPHAS3,
                    fused=kernels, fused_riccati=None if kernels else False,
                    **options)
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
    with the kernels) in float32 at H=MPC_H for MPC_TICKS ticks under K11
    and MPC_TICKS_REF under the plain sweep and the parallel scan: at Bm=1
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
        ticks = MPC_TICKS if "fused_riccati" in options else MPC_TICKS_REF
        x0, U0 = start_problems(m32, Bm, H, np.random.default_rng(SEED + 70))
        torch.cuda.synchronize()
        _lib.reset_launches()
        carry, U_app, J_hist, ms, calls = mpc_run_timed(m32, x0, U0, ticks,
                                                        **options)
        torch.cuda.synchronize()
        counts = dict(_lib.launches)
        d0, d1 = ee_distance(m32, x0), ee_distance(m32, carry.x)
        bad = (~J_hist.isfinite()).any(0).nonzero()[:, 0].tolist()
        first_bad = {b: int((~J_hist[:, b].isfinite()).nonzero()[0]) + 1
                     for b in bad}
        med = statistics.median(ms[1:])
        print(f"path B {label} Bm={Bm} H={H} f32: {ticks} ticks, "
              f"{med:.2f} ms per tick (median of ticks 2-{ticks}; first "
              f"{ms[0]:.1f}, range {min(ms[1:]):.2f}-{max(ms[1:]):.2f}, CUDA "
              f"events) = {1e3 / med:.1f} ticks/s, {Bm * 1e3 / med:.1f} "
              f"robot-ticks/s; EE distance mean {d0.mean().item():.4f} -> "
              f"{d1.mean().item():.4f} m (max {d1.max().item():.4f}, fell for "
              f"{int((d1 < d0).sum())} of {Bm}); J (finite) "
              f"{J_hist[0][J_hist[0].isfinite()].mean().item():.4f} -> "
              f"{J_hist[-1][J_hist[-1].isfinite()].mean().item():.4f}; J "
              f"non-finite for robot: first tick {first_bad}; sweeps {calls};"
              f" launches {counts} on {smi}")
        n = ticks * MPC_ITERS
        require(tuple(U_app.shape) == (ticks, Bm, m32.nv),
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


def hybrid_path(m32, smi: str, problems=None, cost_fn=None,
                tag: str = "path C",
                label: str = "configs[4] humanoid30 rpy hybrid", f_ext=None):
    """Phase 16, path C: BASELINE.json configs[4] as bench.py:539-590 runs
    it, through ``hybrid_solve`` (``problems`` and ``cost_fn`` in place of
    ``humanoid_problems`` and ``humanoid_cost`` when given: path G, the
    same task on the quaternion root; ``tag`` and ``label`` name the run in
    its lines): BH humanoid problems, HH knots, float32,
    MPPI_ITERS_H MPPI iterations of SAMPLES_H samples then ITERS_H DDP
    iterations of ALPHAS_H line-search steps, every kernel on, noise from a
    seeded generator on the card, under the wrenches ``f_ext`` in every
    rollout when given (path K).  One warm-up solve, then three timed ones
    with the counts set to 0 just before: K1 in the sampling, K2, K3 and
    the small-batch sweep once a DDP iteration, K9 and the plain sweep
    never (under ``f_ext`` K1 only with wrenches, and K2's wrench kernel in
    place of K2); then the MPPI and DDP stages timed apart.  Both J histories must
    be finite and fall (MPPI's within 1e-6 relative: its guard compares
    costs of separately batched rollouts), the final J below the initial.
    Returns the counts of the three solves, by kernel and by (kernel, size
    class), and one solve as a function."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import (
        DDPConfig, MPPIConfig, ddp_solve, hybrid_solve, mppi_solve, rollout,
        trajectory_cost,
    )

    x0, U0 = (problems or humanoid_problems)(m32, BH, HH,
                                             np.random.default_rng(SEED + 91))
    cost = (cost_fn or humanoid_cost)(m32)
    mcfg = MPPIConfig(n_samples=SAMPLES_H, sigma=SIGMA_H, dt=DT,
                      gravity=GRAVITY, fused=True)
    dcfg = DDPConfig(iters=ITERS_H, dt=DT, gravity=GRAVITY,
                     n_alphas=ALPHAS_H, fused=True)
    J0 = trajectory_cost(cost, rollout(m32, x0, U0, DT, GRAVITY, fused=True,
                                       f_ext=f_ext), U0)
    gen = torch.Generator(device=m32.device)

    def solve():
        gen.manual_seed(SEED)
        return hybrid_solve(m32, cost, x0, U0, gen, mcfg, dcfg,
                            mppi_iters=MPPI_ITERS_H, f_ext=f_ext)

    def sample():
        gen.manual_seed(SEED)
        return mppi_solve(m32, cost, x0, U0, gen, MPPI_ITERS_H, mcfg,
                          f_ext=f_ext)

    solve()
    torch.cuda.synchronize()
    _lib.reset_launches()
    with WrenchSpy() as spy:
        (state, (mh, dh)), times = timed_runs(solve, warm=False)
    torch.cuda.synchronize()
    counts, by_class = dict(_lib.launches), dict(_lib.class_launches)
    print(f"{tag} launches (3 solves): {counts}; K1 calls with wrenches "
          f"{spy.calls['with']}, without {spy.calls['without']}")
    (U_warm, _), t_mppi = timed_runs(sample)
    _, t_ddp = timed_runs(lambda: ddp_solve(m32, cost, x0, U_warm, dcfg,
                                            f_ext=f_ext))
    n = 3 * ITERS_H
    k2, k2_other = (("feedback_rollout_fext", "feedback_rollout")
                    if f_ext is not None else
                    ("feedback_rollout", "feedback_rollout_fext"))
    for k, v in {k2: n, k2_other: 0, "linearize_parts": n,
                 "riccati_small": n, "feedback_chunked": 0,
                 "feedback_chunked_fext": 0, "riccati_chunk": 0}.items():
        require(counts[k] == v, f"{tag}: {k} launched {counts[k]} times in "
                f"3 solves, expected {v}")
    require(counts["fd_step"] > 0, f"{tag}: no fd_step launch")
    wrenched = spy.calls["with"] if f_ext is not None else spy.calls[
        "without"]
    require(wrenched > 0 and spy.calls["with"] + spy.calls["without"]
            == wrenched, f"{tag}: K1 calls {spy.calls}")
    for name, h in (("MPPI", mh), ("DDP", dh)):
        require(tuple(h.shape) == (MPPI_ITERS_H if name == "MPPI"
                                   else ITERS_H, BH), f"{tag} {name} J "
                f"history {tuple(h.shape)}")
        require(bool(h.isfinite().all()), f"{tag}: non-finite {name} J")
    require(bool((mh[1:] <= mh[:-1] * (1 + 1e-6)).all())
            and bool((mh[0] <= J0 * (1 + 1e-6)).all()),
            f"{tag}: MPPI's J increased")
    require(bool((dh[1:] <= dh[:-1]).all())
            and bool((dh[0] <= mh[-1] * (1 + 1e-6)).all()),
            f"{tag}: DDP's J increased")
    require(bool((dh[-1] < J0).all()), f"{tag}: J did not fall")
    require(bool(state.U.isfinite().all()), f"{tag}: non-finite controls")
    sec, sm, sd = (statistics.median(t) for t in (times, t_mppi, t_ddp))
    fmt = lambda h: " ".join(f"{v:.6g}" for v in h.mean(-1).tolist())
    print(f"{tag}: {label}, Bm={BH} H={HH} "
          f"MPPI {MPPI_ITERS_H} x {SAMPLES_H} samples, DDP {ITERS_H} iters x "
          f"{ALPHAS_H} alphas, f32 fused: mean J {J0.mean().item():.6g}, "
          f"MPPI {fmt(mh)}, DDP {fmt(dh)}; solve {sec * 1e3:.1f} ms (median "
          f"of 3: {' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) "
          f"= {BH / sec:.1f} solves/s; MPPI stage {sm * 1e3:.1f} ms, DDP "
          f"stage {sd * 1e3:.1f} ms (medians of 3) on {smi}")
    return counts, by_class, solve


def mppi_moved(J0, hist, rel: float = 1e-9) -> int:
    """(iteration, problem) pairs whose accepted J fell below the previous
    one: MPPI's guard took the weighted update or the best sample, not the
    nominal plan."""
    import torch

    prev = torch.cat([J0[None], hist[:-1]])
    return int((hist < prev * (1 - rel)).sum())


def hybrid_parity(m64, smi: str, f_ext=None, sigmas=(SIGMA_H, SIGMA_MOVE),
                  tag: str = "path C", floor_times=None,
                  mppi_iters: int = MPPI_ITERS_H, iters: int = ITERS_H):
    """Phase 16's check of the hybrid at path C's shapes (BH problems, HH
    knots, ``mppi_iters`` iterations of SAMPLES_H samples, then ``iters``
    DDP iterations) in float64: ``hybrid_solve`` through the kernels and
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
    noise = torch.randn((mppi_iters, BH, SAMPLES_H, HH, m64.nv),
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
                DDPConfig(iters=iters, dt=DT, gravity=GRAVITY,
                          n_alphas=ALPHAS_H, fused=bool(fused)),
                mppi_iters=mppi_iters, f_ext=f_ext, noise=noise)
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
              f"MPPI {mppi_iters} x {SAMPLES_H} samples, DDP {iters} "
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
                  newtons: float = PUSH_N, height: float = 0.0):
    """(H, nb, 6) world-frame wrenches [n; f] on ``model``'s device and
    dtype: ``newtons`` along +y on the trunk (body 0) for the knots of
    PUSH_KNOTS, over ``noise`` N(0,1) on every body (from ``seed``).  The
    push's line of action passes through the world origin, or with
    ``height`` through the point ``height`` above it (its moment about the
    origin, n_x = -height newtons)."""
    import torch

    rng = np.random.default_rng(seed)
    F = noise * rng.standard_normal((H, model.nb, 6))
    F[PUSH_KNOTS[0]:PUSH_KNOTS[1], 0, 4] += newtons
    F[PUSH_KNOTS[0]:PUSH_KNOTS[1], 0, 0] -= height * newtons
    return torch.tensor(F, dtype=model.dtype, device=model.device)


def fext_kernels(models, smi: str, rows: dict):
    """Phase 19's kernel checks: K2 and K9 (NCHUNKS_F) with per-knot
    wrenches (``push_wrenches`` over 0.5 N(0,1)) against their plain
    versions on each of ``models`` ((label, m64, m32, K2's float64 inputs,
    row tag)), K9 over the whole batch at NCHUNKS_D chunks (its row's
    timed check) and over CUT_B trajectories at the other counts: float64
    within TOL64, float32 within TOL32; then, in both dtypes, K2 and K9
    under all-zero wrenches equal the wrench-free kernels bit for bit."""
    import torch
    from rbdtpu_torch.kernels import fused

    for i, (label, m64, m32, fb, tag) in enumerate(models):
        B, H = fb[2].shape[:2]
        F = push_wrenches(m64, H, 0.5, SEED + 110 + i)
        checks = [(f"feedback_rollout f_ext {label}", "feedback_rollout_fext",
                   fb, {"f_ext": F}, "feedback_rollout+fext", B * H)]
        # K9 at the paths' chunk count over the whole batch, at the others
        # over CUT_B trajectories (phase 26's time)
        for c in sorted(NCHUNKS_F, key=lambda c: c != NCHUNKS_D):
            Bc = B if c == NCHUNKS_D else CUT_B
            checks.append((f"feedback_chunked f_ext {label} nchunks={c} "
                           f"B={Bc}", "feedback_chunked_fext",
                           tuple(t[:Bc].contiguous() for t in fb),
                           {"f_ext": F, "nchunks": c},
                           "feedback_chunked+fext", Bc * H))
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
    PUSH_HYBRID_N and under PUSH_N (there beside the plain route's floor),
    each over MPPI_ITERS_PUSH MPPI and ITERS_PUSH DDP iterations.
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
            floor_times=floor_times, mppi_iters=MPPI_ITERS_PUSH,
            iters=ITERS_PUSH)
        require(hy["feedback_rollout_fext"] == ITERS_PUSH
                and hy["feedback_rollout"] == 0,
                f"path F hybrid {newtons:g} N: K2 launches {hy}")
    return q3_class, pd_class, hy_class


def quat_problems(model, Bm: int, H: int, rng):
    """Paths G and H's start (bench.py:555-566 with root_quat=True and
    bench.py:655-658): the identity quaternion at height 0.9 retracted by
    0.02 N(0,1) through ``config_retract``, at rest, gravity compensation
    at every knot."""
    import torch
    from rbdtpu_torch.dynamics import rnea
    from rbdtpu_torch.solver import config_retract

    kw = dict(dtype=model.dtype, device=model.device)
    q0 = torch.zeros(Bm, model.nq, **kw)
    q0[:, 2], q0[:, 3] = 0.9, 1.0
    q0 = config_retract(model, q0, torch.tensor(
        0.02 * rng.standard_normal((Bm, model.nv)), **kw))
    z = torch.zeros(Bm, model.nv, **kw)
    U0 = rnea(model, q0, z, z)[0][:, None].expand(Bm, H, model.nv)
    return torch.cat([q0, z], -1), U0.contiguous()


def quat_cost(model):
    """Path G's tracking cost (bench.py:566-572): standing height 0.95 with
    the identity quaternion, weights WH, the attitude error the log map's."""
    from rbdtpu_torch.solver import quadratic_tracking_cost

    goal = np.zeros(model.nx)
    goal[2], goal[3] = 0.95, 1.0
    return quadratic_tracking_cost(model, goal, **WH)


def hand_cost(model, fused: bool = True):
    """Path H's cost (bench.py:659-663): ``ee_reaching_cost`` toward
    TARGET_Q at the left wrist, weights WE, in the body-twist tangent
    chart; ``fused=False`` takes K4's plain version."""
    from rbdtpu_torch.solver import ee_reaching_cost

    return ee_reaching_cost(model, TARGET_Q, ee_names=EE_Q,
                            fused=None if fused else False, **WE)


def quat_kernel_inputs(m64, rng):
    """Float64 CUDA inputs of K1-K4 on the quaternion humanoid at paths G
    and H's shapes: K1 at path G's BH x SAMPLES_H sampled states, K2 at
    BH x ALPHAS_H trajectories over HH knots, K3 at BH x HH knots, K4's
    configurations at the knots and terminal states (ee_gn) and at the
    line search's (ee_err).  K2's gains pull each trajectory, started 0.02
    N(0,1) away in the tangent, back to its nominals 0.01 N(0,1) from x0:
    u = U + K (x (-) X_t) with K = -M(q0) [400 I, 40 I] perturbed by 10%
    per knot (``quat_feedback_inputs``)."""
    import torch

    n, nq = m64.nv, m64.nq
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=m64.device)

    def states(B):
        x0, U0 = quat_problems(m64, B, 1, rng)
        qd = T(0.5 * rng.standard_normal((B, n)))
        return (x0[:, :nq].contiguous(), qd,
                (U0[:, 0] + T(rng.standard_normal((B, n)))).contiguous())

    q, qd, u = states(BH * SAMPLES_H)
    fb = quat_feedback_inputs(m64, rng, BH * ALPHAS_H, HH)

    def configs(Bq):
        from rbdtpu_torch.solver import config_retract

        x, _ = quat_problems(m64, Bq, 1, rng)
        return config_retract(m64, x[:, :nq], T(
            0.1 * rng.standard_normal((Bq, n)))).contiguous()

    return {"fd_step": (torch.cat([q, qd], -1), u), "feedback_rollout": fb,
            "linearize_parts": states(BH * HH),
            "ee_gn": (configs(BH * HH), configs(BH)),
            "ee_err": (configs(ALPHAS_H * BH * HH), configs(ALPHAS_H * BH))}


def quat_feedback_inputs(m64, rng, B: int, H: int):
    """Float64 CUDA inputs of the line-search kernels (K2, K9 and their
    wrench twins) on the quaternion root: B trajectories over H knots
    started 0.02 N(0,1) away in the tangent from ``quat_problems``' x0,
    nominals 0.01 N(0,1) from it, u = U + K (x (-) X_t) with K = -M(q0)
    [400 I, 40 I] perturbed by 10% per knot and k cancelling K (x0 (-)
    X_t)."""
    import torch
    from rbdtpu_torch.dynamics import minv
    from rbdtpu_torch.solver import state_diff, state_retract

    n, nq = m64.nv, m64.nq
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=m64.device)
    x0, U0 = quat_problems(m64, B, H, rng)
    Xn = state_retract(m64, x0[:, None].expand(B, H, m64.nx),
                       T(0.01 * rng.standard_normal((B, H, 2 * n))))
    pd = np.concatenate([400.0 * np.eye(n), 40.0 * np.eye(n)], 1)
    gains = T(pd * (1 + 0.1 * rng.standard_normal((B, H, n, 2 * n))))
    Kf = -(torch.linalg.inv(minv(m64, x0[:, :nq]))[:, None] @ gains)
    kf = -(Kf @ state_diff(m64, x0[:, None], Xn)[..., None])[..., 0]
    x_start = state_retract(m64, x0, T(0.02 * rng.standard_normal((B, 2 * n))))
    return (x_start, Xn.contiguous(), U0, kf.contiguous(), Kf.contiguous())


def quat_kernels(h64, h32, smi: str, rows: dict, ptxas: list):
    """Phase 20's kernel checks: K1-K4 at the quaternion root's class
    "fq32" against their plain versions at paths G and H's shapes
    (``quat_kernel_inputs``), each timed by one call and by graph replay
    beside its bound, with the per-thread stack limit before and after
    them (none may move it); then K1/K2's extra checks and launch
    geometry."""
    from rbdtpu_torch.kernels import _lib

    for line in ptxas:
        if "DimsQuat" in line:
            print(f"phase 20 {line}")
    qin = quat_kernel_inputs(h64, np.random.default_rng(SEED + 110))
    states = {"fd_step": BH * SAMPLES_H, "feedback_rollout": BH * ALPHAS_H * HH,
              "linearize_parts": BH * HH}
    checks = [(f"{k} quat", k, qin[k], {}, k, states[k]) for k in states]
    for kname, sizes in (("ee_gn", ("knots", "terminal")),
                         ("ee_err", ("line search", "terminal"))):
        for size, q in zip(sizes, qin[kname]):
            checks.append((f"{kname} quat {size}", kname, (q,),
                           {"ee_names": EE_Q}, kname, q.shape[0]))
    limit = _lib.stack_limit(h64.device)
    check_kernels(checks, h64, h32, smi, rows, row_tag="_fq32",
                  ee_names=EE_Q)
    check_kernels(team_checks(h64, qin["fd_step"], qin["feedback_rollout"],
                              "quat"), h64, h32, smi, rows,
                  row_tag="_fq32", time_all=False)
    grown = _lib.stack_limit(h64.device)
    print(f"stack limit {limit} B a thread before K1-K4 at fq32, {grown} B "
          f"after them ({smi})")
    require(grown == limit, f"K1-K4 at fq32 raised the stack limit from "
            f"{limit} to {grown} B a thread")
    team_report("quaternion humanoid", h64, h32, qin["fd_step"],
                qin["feedback_rollout"])


def hand_path(m32, smi: str, problems=None, tag: str = "path H",
              seed: int = SEED + 111, root: str = "quaternion root"):
    """Phase 20, path H (bench.py:640-672) through the port's entry points:
    ``ddp_solve`` of BH quaternion humanoids (``quat_problems``) reaching
    TARGET_Q with the left wrist, HH knots, ITERS_Q iterations, ALPHAS_H
    line-search steps, float32, ``fused=True``.  One warm-up solve, then
    three timed ones with the counts set to 0 just before: per solve K1 HH
    times, K2, K3 and the small-batch sweep (K8) once an iteration, ee_gn
    twice an iteration, ee_err twice for J0 and twice an iteration, the
    plain sweep and the large-batch site never.  J finite, nonincreasing
    and falling; its profile.  Phase 23's path M runs it on the rpy
    humanoid (``problems``: ``humanoid_problems``).  Returns the counts of
    the three solves by kernel and by (kernel, size class)."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import DDPConfig, ddp, ddp_solve, rollout, \
        trajectory_cost

    x0, U0 = (problems or quat_problems)(m32, BH, HH,
                                         np.random.default_rng(seed))
    cost = hand_cost(m32)
    J0 = trajectory_cost(cost, rollout(m32, x0, U0, DT, GRAVITY, fused=True),
                         U0)
    cfg = DDPConfig(iters=ITERS_Q, dt=DT, gravity=GRAVITY, n_alphas=ALPHAS_H,
                    fused=True)
    run = lambda: ddp_solve(m32, cost, x0, U0, cfg)
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
    counts, by_class = dict(_lib.launches), dict(_lib.class_launches)
    per_solve = {"fd_step": HH, "feedback_rollout": ITERS_Q,
                 "linearize_parts": ITERS_Q, "riccati_small": ITERS_Q,
                 "ee_gn": 2 * ITERS_Q, "ee_err": 2 + 2 * ITERS_Q,
                 "riccati_chunk": 0, "feedback_chunked": 0}
    print(f"{tag} launches (3 solves): {counts}; by size class "
          f"{ {f'{k}/{c}': v for (k, c), v in by_class.items()} }; per solve "
          f"{ {k: counts[k] / 3 for k in per_solve} }; plain sweeps "
          f"{len(plain_sweeps)}")
    for k, v in per_solve.items():
        require(counts[k] == 3 * v, f"{tag}: {k} launched {counts[k]} times "
                f"in 3 solves, expected {3 * v}")
    require(not plain_sweeps, f"{tag}: the plain sweep ran")
    require(tuple(J_hist.shape) == (ITERS_Q, BH), f"J_hist {J_hist.shape}")
    require(bool(J_hist.isfinite().all()), f"{tag}: non-finite J")
    require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[0] <= J0 * (1 + 1e-6)).all()), f"{tag}: J increased")
    require(bool((J_hist[-1] < J0).all()), f"{tag}: J did not fall")
    sec = statistics.median(times)
    print(f"{tag}: humanoid30 {root} hand reaching {EE_Q[0]} -> "
          f"{TARGET_Q}, Bm={BH} H={HH} iters={ITERS_Q} alphas={ALPHAS_H} f32 "
          f"fused: mean J {J0.mean().item():.6g} -> "
          f"{J_hist[-1].mean().item():.6g}; solve {sec * 1e3:.1f} ms (median "
          f"of 3: {' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) "
          f"= {BH / sec:.1f} solves/s on {smi}")
    profile_main_path(run)
    return counts, by_class


def quat_parity(m64, smi: str):
    """Paths G and H in float64 at BQ_PARITY problems and HH knots, through
    the kernels and through the plain route on the card: path G's hybrid
    fed the same standard normals (MPPI_ITERS_H iterations of SAMPLES_H
    samples at SIGMA_H, then ITERS_H DDP iterations), path H's ITERS_Q DDP
    iterations (K4's plain version in the plain route).  Both require
    |dU| < U_PARITY and relative |dJ| < TOL64 over the J history; where
    |dJ| passes TOL64, the plain route's own floor (its parting from itself
    when x0 moves by 1e-13 relative) is measured in the same run and, as
    phase 19 does, |dJ| must stay under FLOOR_TIMES times it.  The line
    says which bound held."""
    import torch
    from rbdtpu_torch.solver import (
        DDPConfig, MPPIConfig, ddp_solve, hybrid_solve,
    )

    rng = np.random.default_rng(SEED + 112)
    gen = torch.Generator(device=m64.device).manual_seed(SEED + 113)
    noise = torch.randn((MPPI_ITERS_H, BQ_PARITY, SAMPLES_H, HH, m64.nv),
                        generator=gen, dtype=m64.dtype, device=m64.device)

    def path_g(kernels, x0, U0):
        state, (mh, dh) = hybrid_solve(
            m64, quat_cost(m64), x0, U0, None,
            MPPIConfig(n_samples=SAMPLES_H, sigma=SIGMA_H, dt=DT,
                       gravity=GRAVITY, fused=kernels),
            DDPConfig(iters=ITERS_H, dt=DT, gravity=GRAVITY,
                      n_alphas=ALPHAS_H, fused=kernels),
            mppi_iters=MPPI_ITERS_H, noise=noise)
        return state.U, torch.cat([mh, dh])

    def path_h(kernels, x0, U0):
        state, hist = ddp_solve(
            m64, hand_cost(m64, kernels), x0, U0,
            DDPConfig(iters=ITERS_Q, dt=DT, gravity=GRAVITY,
                      n_alphas=ALPHAS_H, fused=kernels))
        return state.U, hist

    for tag, fn in (("path G", path_g), ("path H", path_h)):
        route_parity(tag, fn, *quat_problems(m64, BQ_PARITY, HH, rng), rng,
                     smi)


def route_parity(tag: str, fn, x0, U0, rng, smi: str):
    """``fn(kernels, x0, U0)`` -> (U, J history) through the kernels and
    through the plain route, float64: |dU| < U_PARITY and relative |dJ| <
    TOL64 over the J history; where |dJ| passes TOL64, the plain route's own
    floor (its parting from itself when x0 moves by 1e-13 relative) is
    measured in the same run and |dJ| must stay under FLOOR_TIMES times it.
    The line says which bound held."""
    import torch

    moved = x0 * (1 + 1e-13 * torch.tensor(
        rng.standard_normal(x0.shape), dtype=x0.dtype, device=x0.device))
    (Uk, Jk), (Up, Jp) = fn(True, x0, U0), fn(False, x0, U0)
    torch.cuda.synchronize()
    rel = lambda a, b: ((a - b).abs() / b.abs()).max().item()
    du, dj = (Uk - Up).abs().max().item(), rel(Jk, Jp)
    bound, rule = TOL64, f"{TOL64:g}"
    if dj >= TOL64:
        Uf, Jf = fn(False, moved, U0)
        bound = FLOOR_TIMES * rel(Jf, Jp)
        rule = (f"{bound:.3g} = {FLOOR_TIMES:g} x the plain route's floor"
                f", which parts by max|dU| "
                f"{(Uf - Up).abs().max().item():.3e} from x0 x (1 + "
                f"1e-13 N(0,1))")
    print(f"{tag} parity f64 Bm={x0.shape[0]} H={U0.shape[1]}: kernels vs "
          f"plain route: max|dU| {du:.3e} (bound {U_PARITY:g}), max rel |dJ| "
          f"over the J history {dj:.3e} (bound {rule}) ({smi})")
    require(du < U_PARITY and dj < bound, f"{tag}: the kernels' solve "
            "departs from the plain route's")


def quat_phase(smi: str, rows: dict, ptxas: list):
    """Phase 20: K1-K4 on the quaternion root (``quat_kernels``), path G
    (``hybrid_path`` on ``quat_problems`` and ``quat_cost``, then its
    profile), path H (``hand_path``) and their float64 parity
    (``quat_parity``).  Each "fq32" row's launches are read by size class
    from one path's three solves: K1-K3 from path G's, K4 from path H's."""
    import torch
    from rbdtpu_torch.model import load_asset

    h64, h32 = (load_asset("humanoid30", device="cuda", dtype=dt,
                           floating_base=True, root_quat=True)
                for dt in (torch.float64, torch.float32))
    quat_kernels(h64, h32, smi, rows, ptxas)
    _, g_class, solve_g = hybrid_path(
        h32, smi, quat_problems, quat_cost, "path G",
        "configs[4] humanoid30 quaternion-root hybrid")
    profile_main_path(solve_g)
    for k in ("fd_step", "feedback_rollout", "linearize_parts"):
        rows[f"{k}_fq32"]["launches"] = g_class.get((k, "fq32"), 0)
    _, h_class = hand_path(h32, smi)
    for k in ("ee_gn", "ee_err"):
        rows[f"{k}_fq32"]["launches"] = h_class.get((k, "fq32"), 0)
    for k in ("fd_step", "feedback_rollout", "linearize_parts", "ee_gn",
              "ee_err"):
        require(rows[f"{k}_fq32"]["launches"] > 0,
                f"{k} was not launched at fq32 on path G or H")
    quat_parity(h64, smi)


def quat_ext_kernels(h64, h32, smi: str, rows: dict, ptxas: list) -> dict:
    """Phase 22's kernel checks, the kernels the quaternion root's class
    "fq32" adds to K1-K4, against their plain versions at the paths'
    shapes (float64 <= TOL64, float32 at TOL32), each row's first check
    timed by one call and by graph replay beside its bound: K9 at path J's
    BD x ALPHAS_H trajectories over HH knots at NCHUNKS_D chunks, at the
    other counts of NCHUNKS_CHECKS over CUT_B trajectories, and at
    TEAM_BATCHES trajectories; K2 with wrenches at
    path G's BH x ALPHAS_H trajectories and K9 with wrenches (NCHUNKS_D
    chunks) at path J's, under ``push_wrenches`` over 0.5 N(0,1); both
    under all-zero
    wrenches equal to the wrench-free kernels bit for bit; K10 (bias and
    with qdd) and K6 (both routes, without wrenches, under one set shared
    by the batch and one a state) at path G's BH x SAMPLES_H states, each
    of those timed.  The
    per-thread stack limit must not move across them.  Returns path J's
    float64 line-search inputs."""
    import torch
    from rbdtpu_torch.kernels import _lib, fused

    new = ("feedback_chunked", "feedback_rollout_fext", "fd_step_minv",
           "rnea")
    for line in ptxas:
        if "DimsQuat" in line and any(f"ptxas {k}" in line for k in new):
            print(f"phase 22 {line}")
    rng = np.random.default_rng(SEED + 120)
    fbj = quat_feedback_inputs(h64, rng, BD * ALPHAS_H, HH)
    fbg = quat_feedback_inputs(h64, rng, BH * ALPHAS_H, HH)
    x0, U0 = quat_problems(h64, BH * SAMPLES_H, 1, rng)
    fd = (torch.cat([x0[:, :h64.nq], torch.tensor(
        0.5 * rng.standard_normal((BH * SAMPLES_H, h64.nv)),
        dtype=torch.float64, device=h64.device)], -1).contiguous(),
        (U0[:, 0] + torch.tensor(rng.standard_normal(U0[:, 0].shape),
                                 dtype=torch.float64,
                                 device=h64.device)).contiguous())
    traj = BD * ALPHAS_H * HH
    cut = lambda t, B: t[:B].contiguous()
    # path J's chunk count over its whole batch, the other counts over
    # CUT_B trajectories (phase 26's time)
    checks = [(f"feedback_chunked quat nchunks={NCHUNKS_D}",
               "feedback_chunked", fbj, {"nchunks": NCHUNKS_D},
               "feedback_chunked", traj)]
    checks += [(f"feedback_chunked quat nchunks={c} B={CUT_B}",
                "feedback_chunked", tuple(cut(t, CUT_B) for t in fbj),
                {"nchunks": c}, "feedback_chunked", CUT_B * HH)
               for c in NCHUNKS_CHECKS if c != NCHUNKS_D]
    checks += [(f"feedback_chunked quat B={B}", "feedback_chunked",
                tuple(cut(t, B) for t in fbj), {"nchunks": NCHUNKS_D},
                "feedback_chunked", B * HH) for B in TEAM_BATCHES]
    FG = push_wrenches(h64, HH, 0.5, SEED + 121)
    checks.append(("feedback_rollout f_ext quat", "feedback_rollout_fext",
                   fbg, {"f_ext": FG}, "feedback_rollout+fext",
                   BH * ALPHAS_H * HH))
    checks.append((f"feedback_chunked f_ext quat nchunks={NCHUNKS_D}",
                   "feedback_chunked_fext", fbj,
                   {"f_ext": FG, "nchunks": NCHUNKS_D},
                   "feedback_chunked+fext", traj))
    limit = _lib.stack_limit(h64.device)
    check_kernels(checks, h64, h32, smi, rows, row_tag="_fq32",
                  time_all=False)
    check_kernels(minv_rnea_checks(h64, fd, "quat", *step_extras(
        h64, BH * SAMPLES_H, SEED + 122)), h64, h32, smi, rows,
        row_tag="_fq32")
    for m in (h64, h32):
        pairs = []
        for args in (fbg, fbj):
            a = tuple(t.to(m.dtype) for t in args)
            Z = torch.zeros(HH, m.nb, 6, dtype=m.dtype, device=m.device)
            pairs += [(fused.feedback_rollout_fused(m, *a, DT, GRAVITY,
                                                    f_ext=Z),
                       fused.feedback_rollout_fused(m, *a, DT, GRAVITY)),
                      (fused.feedback_rollout_fused_chunked(
                          m, *a, DT, GRAVITY, nchunks=NCHUNKS_D, f_ext=Z),
                       fused.feedback_rollout_fused_chunked(
                           m, *a, DT, GRAVITY, nchunks=NCHUNKS_D))]
        same = all(torch.equal(a, b) for w, z in pairs
                   for a, b in zip(w, z))
        print(f"kernel feedback_rollout/feedback_chunked f_ext=0 quat "
              f"{str(m.dtype)[6:]}: equal to the wrench-free kernels bit "
              f"for bit: {same}")
        require(same, "K2/K9 with zero wrenches at fq32 differ from the "
                "wrench-free kernels")
    grown = _lib.stack_limit(h64.device)
    print(f"stack limit {limit} B a thread before K9, K2/K9 with wrenches, "
          f"K6 and K10 at fq32, {grown} B after them ({smi})")
    require(grown == limit, f"a kernel at fq32 raised the stack limit from "
            f"{limit} to {grown} B a thread")
    for kernel, B in (("feedback_chunked", BD * ALPHAS_H),
                      ("feedback_chunked_fext", BD * ALPHAS_H),
                      ("feedback_rollout_fext", BH * ALPHAS_H),
                      ("fd_step_minv", BH * SAMPLES_H),
                      ("rnea", BH * SAMPLES_H)):
        for m in (h32, h64):
            for dense in ((False, True) if kernel == "fd_step_minv"
                          else (False,)):
                team, tpb, smem, blocks = _lib.team_geometry(
                    kernel, "fq32", m.dtype, B, _lib.sm_count(m.device),
                    dense)
                print(f"team quaternion humanoid {kernel}"
                      f"{' dense' if dense else ''} fq32 "
                      f"{_lib._SUFFIX[m.dtype]}: B={B} team {team} lanes, "
                      f"{tpb} teams a block, {smem} B of shared memory a "
                      f"block, {blocks} blocks")
    return fbj


def quat_solve(m, x0, U0, fused_feedback, f_ext=None):
    """Path J's ``ddp_solve``: path D's solver (ITERS_H iterations,
    ALPHAS_H line-search steps, every kernel on, the line search's tier
    from ``fused_feedback``) on path G's tracking cost, under ``f_ext``
    when given."""
    from rbdtpu_torch.solver import DDPConfig, ddp_solve

    return ddp_solve(m, quat_cost(m), x0, U0, DDPConfig(
        iters=ITERS_H, dt=DT, gravity=GRAVITY, n_alphas=ALPHAS_H, fused=True,
        fused_feedback=fused_feedback), f_ext=f_ext)


def quat_parity_batch(m) -> int:
    """The smallest problem count whose ALPHAS_H-step line search the
    port's rule (``solver.ddp._feedback_route``: ``feedback_fused_ok``
    refuses K2, ``feedback_chunks`` gives the count) sends to K9 with
    NCHUNKS_D chunks on model ``m``."""
    from rbdtpu_torch.solver import DDPConfig, ddp

    cfg = DDPConfig(fused=True, fused_feedback=True, n_alphas=ALPHAS_H)
    for B in range(1, BD + 1):
        if ddp._feedback_route(m, cfg, B * ALPHAS_H) == ("chunked",
                                                         NCHUNKS_D):
            return B
    raise SystemExit(f"chip_smoke FAILED: no batch up to {BD} takes K9 "
                     f"with {NCHUNKS_D} chunks")


def quat_ddp_path(m32, smi: str, f_ext=None, tag: str = "path J",
                  tiers=J_TIERS) -> dict:
    """Path J (and, under ``f_ext``, path K's DDP run): ``quat_solve`` of
    BD quaternion humanoids (``quat_problems``) over HH knots, float32, on
    each line-search tier of ``tiers``.  Per tier one warm-up, then three
    timed solves with the counts set to 0 just before: the tier True
    launches K9 (its wrench kernel under ``f_ext``) once an iteration at
    fq32, None K2 and False the plain pass, none of them anything else of
    the three (no wrench-free line-search kernel under ``f_ext``; K1 with
    wrenches only); K3 and the chunked sweep once an iteration; J finite,
    nonincreasing and falling.  Without ``f_ext`` the K9 tier's profile.
    Returns the K9 tier's launches by (kernel, size class)."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import DDPConfig, ddp, rollout, trajectory_cost

    cfg = DDPConfig(fused=True, fused_feedback=True, n_alphas=ALPHAS_H)
    route = ddp._feedback_route(m32, cfg, BD * ALPHAS_H)
    require(route == ("chunked", NCHUNKS_D), f"{tag}: {BD} problems take the "
            f"line-search tier {route}")
    x0, U0 = quat_problems(m32, BD, HH, np.random.default_rng(SEED + 130))
    J0 = trajectory_cost(quat_cost(m32), rollout(
        m32, x0, U0, DT, GRAVITY, fused=True, f_ext=f_ext), U0)
    sfx = "_fext" if f_ext is not None else ""
    k9, k2 = "feedback_chunked" + sfx, "feedback_rollout" + sfx
    others = [k for k in _lib.FEEDBACK_KERNELS if k not in (k9, k2)]
    plain_passes = []
    plain = ddp.forward_pass
    ddp.forward_pass = lambda *a, **kw: plain_passes.append(1) or plain(
        *a, **kw)
    results = {}
    try:
        for fb in tiers:
            quat_solve(m32, x0, U0, fb, f_ext)
            torch.cuda.synchronize()
            plain_passes.clear()
            _lib.reset_launches()
            with WrenchSpy() as spy:
                (state, J_hist), times = timed_runs(
                    lambda: quat_solve(m32, x0, U0, fb, f_ext), warm=False)
            torch.cuda.synchronize()
            results[fb] = (J_hist, times, dict(_lib.launches),
                           dict(_lib.class_launches), len(plain_passes),
                           dict(spy.calls))
    finally:
        ddp.forward_pass = plain
    n = 3 * ITERS_H
    expect = {True: (n, 0, 0), None: (0, n, 0), False: (0, 0, n)}
    for fb, (J_hist, times, counts, by_class, passes, calls) in \
            results.items():
        sec = statistics.median(times)
        print(f"{tag} fused_feedback={fb}: humanoid30 quaternion-root "
              f"tracking{' under a push' if f_ext is not None else ''}, "
              f"Bm={BD} H={HH} iters={ITERS_H} alphas={ALPHAS_H} f32: mean J "
              f"{J0.mean().item():.6g} -> {J_hist[-1].mean().item():.6g}; "
              f"solve {sec * 1e3:.1f} ms (median of 3: "
              f"{' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) = "
              f"{BD / sec:.1f} solves/s; launches (3 solves) {counts}; by "
              f"size class {by_class}; plain line-search passes {passes}; K1 "
              f"calls with wrenches {calls['with']}, without "
              f"{calls['without']} on {smi}")
        got = (by_class.get((k9, "fq32"), 0), by_class.get((k2, "fq32"), 0),
               passes)
        require(got == expect[fb] and counts[k9] == got[0]
                and counts[k2] == got[1]
                and not any(counts[k] for k in others),
                f"{tag} fused_feedback={fb}: {k9}, {k2} at fq32 and plain "
                f"passes {got}, expected {expect[fb]}; launches {counts}")
        require(counts["riccati_chunk"] == n and counts["linearize_parts"]
                == n, f"{tag} fused_feedback={fb}: launches {counts}")
        wrenched = calls["with"] if f_ext is not None else calls["without"]
        require(wrenched >= 3 * HH and calls["with"] + calls["without"]
                == wrenched, f"{tag} fused_feedback={fb}: K1 calls {calls}")
        require(bool(J_hist.isfinite().all()), f"{tag} {fb}: non-finite J")
        require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
            (J_hist[0] <= J0 * (1 + 1e-6)).all()), f"{tag} {fb}: J increased")
        require(J_hist[-1].mean() < J0.mean(), f"{tag} {fb}: J did not fall")
    if f_ext is None:
        profile_main_path(lambda: quat_solve(m32, x0, U0, True),
                          extra=("forward_pass",))
    return results[tiers[0]][3]


def quat_tier_parity(m64, smi: str, tag: str, newtons=None):
    """Path J's (or, under a trunk push of ``newtons``, path K's) float64
    tier parity at ``quat_parity_batch`` problems: the K9 tier (one K9
    launch an iteration at fq32, its wrench kernel under the push) against
    the plain line-search pass (every other kernel alike), |dU| < U_PARITY
    and relative |dJ| < TOL64 over the J history; under the push the plain
    pass also solves from x0 moved by 1e-13 N(0,1) relative, and |dJ| may
    reach FLOOR_TIMES times that floor where it passes TOL64 (phase 19's
    rule)."""
    import torch
    from rbdtpu_torch.kernels import _lib

    Bp = quat_parity_batch(m64)
    rng = np.random.default_rng(SEED + 132)
    x0, U0 = quat_problems(m64, Bp, HH, rng)
    F = None if newtons is None else push_wrenches(m64, HH, newtons=newtons)
    k9 = "feedback_chunked" + ("" if F is None else "_fext")
    _lib.reset_launches()
    sk, hk = quat_solve(m64, x0, U0, True, F)
    torch.cuda.synchronize()
    launched = _lib.class_launches[(k9, "fq32")]
    sp, hp = quat_solve(m64, x0, U0, False, F)
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1)).max().item()
    du, dj = (sk.U - sp.U).abs().max().item(), rel(hk, hp)
    bound, rule = TOL64, f"{TOL64:g}"
    if F is not None:
        moved = x0 * (1 + 1e-13 * torch.tensor(
            rng.standard_normal(x0.shape), dtype=x0.dtype, device=x0.device))
        sf, hf = quat_solve(m64, moved, U0, False, F)
        floor = rel(hf, hp)
        bound = max(TOL64, FLOOR_TIMES * floor)
        rule = (f"{bound:.3g}: {TOL64:g} or {FLOOR_TIMES:g} x the plain "
                f"pass's floor {floor:.3e} (max|dU| "
                f"{(sf.U - sp.U).abs().max().item():.3e} from x0 x (1 + "
                f"1e-13 N(0,1)))")
    print(f"{tag} tier parity f64 Bm={Bp} H={HH} iters={ITERS_H}"
          f"{'' if F is None else f' under {newtons:g} N'}: K9 tier "
          f"({launched} {k9} launches at fq32) vs the plain line-search pass "
          f"max|dU| {du:.3e} (bound {U_PARITY:g}), max rel |dJ| over the J "
          f"history {dj:.3e} (bound {rule}) ({smi})")
    require(launched == ITERS_H and du < U_PARITY and dj < bound,
            f"{tag}: the K9 tier departs from the plain pass")


def quat_push_parity(m64, smi: str, mppi_iters: int, iters: int):
    """Path K's hybrid in float64 at BQ_PARITY problems over HH knots,
    ``mppi_iters`` MPPI and ``iters`` DDP iterations (path G's start,
    cost and MPPI normals), through the kernels and
    through the plain route under a trunk push: at PUSH_HYBRID_N relative
    |dJ| < TOL64 over both J histories, at PUSH_N beside the plain route's
    own parting when x0 moves by 1e-13 N(0,1) relative (|dJ| under the
    larger of TOL64 and FLOOR_TIMES times it); |dU| < U_PARITY at both.
    The kernel route launches K2 with wrenches once a DDP iteration and
    K2 never."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import DDPConfig, MPPIConfig, hybrid_solve

    rng = np.random.default_rng(SEED + 133)
    gen = torch.Generator(device=m64.device).manual_seed(SEED + 134)
    noise = torch.randn((mppi_iters, BQ_PARITY, SAMPLES_H, HH, m64.nv),
                        generator=gen, dtype=m64.dtype, device=m64.device)
    x0, U0 = quat_problems(m64, BQ_PARITY, HH, rng)
    moved = x0 * (1 + 1e-13 * torch.tensor(
        rng.standard_normal(x0.shape), dtype=x0.dtype, device=x0.device))

    def path_k(kernels, x, F):
        state, (mh, dh) = hybrid_solve(
            m64, quat_cost(m64), x, U0, None,
            MPPIConfig(n_samples=SAMPLES_H, sigma=SIGMA_H, dt=DT,
                       gravity=GRAVITY, fused=kernels),
            DDPConfig(iters=iters, dt=DT, gravity=GRAVITY,
                      n_alphas=ALPHAS_H, fused=kernels),
            mppi_iters=mppi_iters, f_ext=F, noise=noise)
        return state.U, torch.cat([mh, dh])

    rel = lambda a, b: ((a - b).abs() / b.abs()).max().item()
    for newtons in (PUSH_HYBRID_N, PUSH_N):
        F = push_wrenches(m64, HH, newtons=newtons)
        _lib.reset_launches()
        Uk, Jk = path_k(True, x0, F)
        torch.cuda.synchronize()
        counts, by_class = dict(_lib.launches), dict(_lib.class_launches)
        Up, Jp = path_k(False, x0, F)
        du, dj = (Uk - Up).abs().max().item(), rel(Jk, Jp)
        bound, rule = TOL64, f"{TOL64:g}"
        if newtons == PUSH_N:
            Uf, Jf = path_k(False, moved, F)
            floor = rel(Jf, Jp)
            bound = max(TOL64, FLOOR_TIMES * floor)
            rule = (f"{bound:.3g}: {TOL64:g} or {FLOOR_TIMES:g} x the plain "
                    f"route's floor {floor:.3e} (max|dU| "
                    f"{(Uf - Up).abs().max().item():.3e} from x0 x (1 + "
                    f"1e-13 N(0,1)))")
        print(f"path K parity f64 {newtons:g} N: hybrid Bm={BQ_PARITY} "
              f"H={HH} MPPI {mppi_iters} x {SAMPLES_H} samples, DDP "
              f"{iters} iters, kernels vs plain route, same noise: max|dU| "
              f"{du:.3e} (bound {U_PARITY:g}), max rel |dJ| over both J "
              f"histories {dj:.3e} (bound {rule}); kernel-route launches "
              f"{counts} ({smi})")
        require(du < U_PARITY and dj < bound, f"path K {newtons:g} N: the "
                "kernels' hybrid departs from the plain route's")
        require(by_class.get(("feedback_rollout_fext", "fq32"), 0) ==
                iters and counts["feedback_rollout"] == 0,
                f"path K {newtons:g} "
                f"N: K2 launches {counts}")


def quat_ext_phase(smi: str, rows: dict, ptxas: list):
    """Phase 22: the kernels "fq32" adds (``quat_ext_kernels``); path J,
    the quaternion humanoid's DDP at fleet batch on its three line-search
    tiers (``quat_ddp_path``) with its float64 tier parity
    (``quat_tier_parity``); path K, path G's hybrid under PUSH_N
    (``hybrid_path`` with wrenches) and path J's K9 tier under it, with
    the float64 parity of both (``quat_push_parity``, ``quat_tier_parity``
    under PUSH_N).  Each new row's launches are read by size class from
    one path's three solves: K9 from path J's K9 tier, K2 with wrenches
    from path K's hybrid, K9 with wrenches from path K's K9 tier; K6 and
    K10 from path J's K9 tier (no path launches them: 0)."""
    import torch
    from rbdtpu_torch.model import load_asset

    clock = time.perf_counter()

    def took(step: str):
        nonlocal clock
        print(f"phase 22: {step} took {time.perf_counter() - clock:.1f} s")
        clock = time.perf_counter()

    h64, h32 = (load_asset("humanoid30", device="cuda", dtype=dt,
                           floating_base=True, root_quat=True)
                for dt in (torch.float64, torch.float32))
    quat_ext_kernels(h64, h32, smi, rows, ptxas)
    took("the kernel checks")
    j_class = quat_ddp_path(h32, smi)
    took("path J")
    quat_tier_parity(h64, smi, "path J")
    took("path J's float64 parity")
    F = push_wrenches(h32, HH)
    _, k_class, _ = hybrid_path(
        h32, smi, quat_problems, quat_cost, "path K",
        "configs[4] humanoid30 quaternion-root hybrid under a push", f_ext=F)
    kj_class = quat_ddp_path(h32, smi, f_ext=F, tag="path K",
                             tiers=(True,))
    took("path K")
    quat_push_parity(h64, smi, mppi_iters=MPPI_ITERS_PUSH, iters=ITERS_PUSH)
    quat_tier_parity(h64, smi, "path K", newtons=PUSH_N)
    took("path K's float64 parity")
    for row, kname, run in (
            ("feedback_chunked_fq32", "feedback_chunked", j_class),
            ("feedback_rollout_fext_fq32", "feedback_rollout_fext", k_class),
            ("feedback_chunked_fext_fq32", "feedback_chunked_fext",
             kj_class),
            ("fd_step_minv_fq32", "fd_step_minv", j_class),
            ("rnea_fq32", "rnea", j_class)):
        rows[row]["launches"] = run.get((kname, "fq32"), 0)
    for row in ("feedback_chunked_fq32", "feedback_rollout_fext_fq32",
                "feedback_chunked_fext_fq32"):
        require(rows[row]["launches"] > 0, f"{row} was not launched on path "
                "J or K")


def legged_models():
    """Path L's models, each (tag, float64, float32, its start's maker, K5's
    size class): the rpy quadruped (configs[3]'s start), the rpy humanoid
    (path C's) and the quaternion humanoid (path G's)."""
    import torch
    from rbdtpu_torch.model import load_asset

    out = []
    for tag, name, quat, problems, cls in (
            ("rpy quadruped", "quadruped12", False, quadruped_problems,
             "fb16"),
            ("rpy humanoid", "humanoid30", False, humanoid_problems, "fb32"),
            ("quaternion humanoid", "humanoid30", True, quat_problems,
             "fq32")):
        m64, m32 = (load_asset(name, device="cuda", dtype=dt,
                               floating_base=True, root_quat=quat)
                    for dt in (torch.float64, torch.float32))
        out.append((tag, m64, m32, problems, cls))
    return out


def legged_inputs(m, problems, B: int, H: int, seed: int):
    """Path L's inputs on ``m`` (its device and dtype): x0 (B, nx) from the
    path's start, U (H, B, nv) scan-major, the start's hold controls
    (gravity compensation) plus SIGMA_L N(0,1), and path F's trunk push
    (H, nb, 6) along a line through the trunk's mean start height: pushed
    through the world origin, a free trunk 0.9 m above it takes a 72 N m
    moment too, which spins the open-loop humanoid (plain route and kernel
    alike) to inf within the 50 steps."""
    import torch

    rng = np.random.default_rng(seed)
    x0, U0 = problems(m, B, H, rng)
    U = U0.transpose(0, 1) + torch.tensor(
        SIGMA_L * rng.standard_normal((H, B, m.nv)), dtype=m.dtype,
        device=m.device)
    return x0.contiguous(), U.contiguous(), push_wrenches(
        m, H, height=float(x0[:, 2].mean()))


def gap_kernels(models, smi: str, rows: dict, ptxas: list):
    """Phase 23's kernel checks: K5 at each floating root's class against
    ``rollout_multi_plain`` in float64 at BL_CHECK x HL (path L's inputs),
    both routes, with and without the push, <= TOL64 (``path_l`` holds and
    times the float32 kernel at path L's own BL x HL), and with zero
    wrenches bit for bit the wrench-free kernel in both dtypes; K4 at fb32 (the rpy humanoid's left wrist) at path M's shapes
    (ee_gn at its 512 knots and 16 terminal states, ee_err at its 2,048 and
    64 line-search states); the per-thread stack limit unchanged across
    them, and K4 fb32's stack within EE_STACK_MAX."""
    import torch
    from rbdtpu_torch.kernels import _lib, fused

    k5 = [ln for ln in ptxas if ln.startswith("ptxas rollout_multi_kernel<")
          and "Dims<8, false>" not in ln]
    k4 = [ln for ln in ptxas if ln.startswith("ptxas ee_root_kernel<")
          and "Dims<32, true>" in ln]
    for line in k5 + k4:
        print(f"phase 23 {line}")
    stacks = [int(re.search(r"(\d+) bytes stack frame", ln).group(1))
              for ln in k4]
    require(len(stacks) == 4 and max(stacks) <= EE_STACK_MAX,
            f"ee_root fb32: stack frames {stacks} B a thread (limit "
            f"{EE_STACK_MAX})")
    limit = _lib.stack_limit(models[0][1].device)
    for tag, m64, m32, problems, cls in models:
        x0, U, F = legged_inputs(m64, problems, BL_CHECK, HL, SEED + 130)
        checks = [(f"rollout_multi {tag} {route}{wr}", "rollout_multi",
                   (x0, U), {"route": route, **kw}, key + plus, BL_CHECK * HL)
                  for route, key in (("aba", "fd_step"),
                                     ("minv", "fd_step_minv"))
                  for wr, kw, plus in (("", {}, ""),
                                       (" push", {"f_ext": F}, "+fext"))]
        check_kernels(checks, m64, m32, smi, rows, row_tag=f"_{cls}",
                      float32=False)
        for m in (m64, m32):
            xm, Um = x0.to(m.dtype), U.to(m.dtype)
            zero = torch.zeros(HL, m.nb, 6, dtype=m.dtype, device=m.device)
            for route in ("aba", "minv"):
                require(torch.equal(
                    fused.rollout_fused_multi(m, xm, Um, DT, GRAVITY,
                                              route=route, f_ext=zero),
                    fused.rollout_fused_multi(m, xm, Um, DT, GRAVITY,
                                              route=route)),
                    f"rollout_multi {tag} {route}: zero wrenches part from "
                    f"the wrench-free kernel in {m.dtype}")
        print(f"rollout_multi {tag} ({cls}): zero wrenches give the "
              "wrench-free kernel's states bit for bit, both routes, both "
              "dtypes")
    _, h64, h32, _, _ = models[1]
    rng = np.random.default_rng(SEED + 131)

    def configs(B):
        x, _ = humanoid_problems(h64, B, 1, rng)
        return (x[:, :h64.nq] + torch.tensor(
            0.1 * rng.standard_normal((B, h64.nq)), dtype=torch.float64,
            device=h64.device)).contiguous()

    checks = [(f"{kname} fb32 {size}", kname, (configs(B),),
               {"ee_names": EE_Q}, kname, B)
              for kname, sizes in (("ee_gn", (("knots", BH * HH),
                                              ("terminal", BH))),
                                   ("ee_err", (("line search",
                                                ALPHAS_H * BH * HH),
                                               ("terminal", ALPHAS_H * BH))))
              for size, B in sizes]
    check_kernels(checks, h64, h32, smi, rows, row_tag="_fb32",
                  ee_names=EE_Q)
    grown = _lib.stack_limit(h64.device)
    print(f"stack limit {limit} B a thread before K5 at fb16/fb32/fq32 and "
          f"K4 at fb32, {grown} B after them ({smi})")
    require(grown == limit, f"K5 or K4 fb32 raised the stack limit from "
            f"{limit} to {grown} B a thread")
    for cls in ("fb16", "fb32", "fq32"):
        team, tpb, smem, blocks = _lib.team_geometry(
            "rollout_multi", cls, torch.float32, BL, _lib.sm_count("cuda"))
        print(f"team rollout_multi {cls} f32: B={BL} team {team} lanes, "
              f"{tpb} teams a block, {smem} B of shared memory a block, "
              f"{blocks} blocks")


def path_l(models, smi: str, rows: dict) -> dict:
    """Phase 23, path L: ``rollout_fused_multi`` at BL x HL in float32 on
    each legged model (``legged_inputs``), both routes, with and without
    the push: with the counts set to 0 just before, the four rollouts are
    four launches of K5 at the model's class and none of K1 or K6; their
    final states, finite, are held against ``rollout_multi_plain`` on the
    same inputs (TOL32 relative), and the aba route's must equal the K1
    scan's (``solver.rollout(fused=True)``) bit for bit; then each timed
    (median of 7 after a warm-up, CUDA events, and by graph replay).
    Completes each class's K5 row (``gap_kernels``) at this shape: ms and
    graph_ms of the aba route without the push, plain_ms of its plain
    version (the comparison's own call, ``timed_call``; gap_kernels ran
    the same plain code in float64 before), bound_ms from the step's operation
    count.  Returns the launches of the four rollouts of each model by
    (kernel, size class)."""
    import collections

    import torch
    from rbdtpu_torch import opcount
    from rbdtpu_torch.kernels import _lib, fused
    from rbdtpu_torch.solver import rollout

    counts = collections.Counter()
    for tag, _, m32, problems, cls in models:
        x0, U, F = legged_inputs(m32, problems, BL, HL, SEED + 132)
        torch.cuda.synchronize()
        _lib.reset_launches()
        finals = {(route, wr): fused.rollout_fused_multi(
            m32, x0, U, DT, GRAVITY, route=route, f_ext=fe)
            for route in ("aba", "minv") for wr, fe in (("", None),
                                                        (" push", F))}
        torch.cuda.synchronize()
        launched = dict(_lib.launches)
        require(launched["rollout_multi"] == 4 and launched["fd_step"] == 0
                and launched["fd_step_minv"] == 0,
                f"path L {tag}: four rollouts launched {launched}")
        counts.update(_lib.class_launches)
        require(counts[("rollout_multi", cls)] == 4,
                f"path L {tag}: K5 at {cls} launched "
                f"{counts[('rollout_multi', cls)]} times, expected 4")
        row = rows[f"rollout_multi_{cls}"]
        for (route, wr), xf in finals.items():
            require(tuple(xf.shape) == (BL, m32.nx),
                    f"path L {tag}: final state {tuple(xf.shape)}")
            require(bool(xf.isfinite().all()),
                    f"path L {tag} {route}{wr}: non-finite final state")
            plain = lambda route=route, fe=F if wr else None: (
                fused.rollout_multi_plain(m32, x0, U, DT, GRAVITY,
                                          route=route, f_ext=fe))
            xp, plain_ms = timed_call(plain)
            if (route, wr) == ("aba", ""):
                row["plain_ms"] = plain_ms
            err = errors(xf, xp, relative=True)[0]
            print(f"path L {tag} ({cls}) {route}{wr}: B={BL} H={HL} f32 K5 "
                  f"vs rollout_multi_plain: rel max|err| {err:.3e} (bound "
                  f"{TOL32['rollout_multi']:g}) ({smi})")
            require(err <= TOL32["rollout_multi"],
                    f"path L {tag} {route}{wr}: K5 and its plain version "
                    f"part by {err:.3e}")
        row["bound_ms"], row["bound_by"] = bound(
            (x0, U), finals[("aba", "")], m32,
            opcount.per_state(m32, TARGET)["fd_step"] * BL * HL, "float32")
        Ub = U.transpose(0, 1).contiguous()
        for wr, fe in (("", None), (" push", F)):
            scan = lambda fe=fe: rollout(m32, x0, Ub, DT, GRAVITY,
                                         fused=True, f_ext=fe)
            xs = scan()[:, -1]
            xk = finals[("aba", wr)]
            err = (xk - xs).abs().max().item()
            require(torch.equal(xk, xs),
                    f"path L {tag}{wr}: K5 and the K1 scan part by {err:.3e}")
            scan_ms = cuda_ms(scan, reps=7)
            print(f"path L {tag}{wr}: the K1 scan (solver.rollout(fused="
                  f"True), {HL} launches) {scan_ms:.4f} ms = "
                  f"{BL * HL / (scan_ms / 1e3):.6g} steps/s; K5 aba's final "
                  f"state equals the scan's bit for bit ({smi})")
            for route in ("aba", "minv"):
                fn = lambda route=route, fe=fe: fused.rollout_fused_multi(
                    m32, x0, U, DT, GRAVITY, route=route, f_ext=fe)
                ms, gms = cuda_ms(fn, reps=7), graph_ms(fn, reps=5)
                if (route, wr) == ("aba", ""):
                    row["ms"], row["graph_ms"] = ms, gms
                print(f"path L {tag} ({cls}) {route}{wr}: B={BL} H={HL} f32: "
                      f"{ms:.4f} ms a rollout (median of 7, CUDA events) = "
                      f"{BL * HL / (ms / 1e3):.6g} steps/s, device "
                      f"{gms:.4f} ms by graph replay, one launch; max|x_H| "
                      f"{finals[(route, wr)].abs().max().item():.4g} ({smi})")
    return counts


def past_limits(model, x0):
    """x0 with the left arm's shoulder pitch 0.05 rad above its upper
    position limit, its elbow 0.05 rad below its lower one and its wrist
    pitch 0.5 rad/s past its velocity limit: ``add_limit_barrier``'s
    three kinds of hinge act on the wrist's chain, beside K4's
    derivatives, from the first knot."""
    lo, hi = model.q_limit_vectors()
    qd_lim = model.qd_limit_vector()
    body = lambda n: model.body_names.index(f"left_arm_{n}_link")
    i, j, k = (body(n) for n in ("shoulder_pitch", "elbow", "wrist_pitch"))
    x = x0.clone()
    x[:, model.q_index(i)] = hi[model.q_index(i)] + 0.05
    x[:, model.q_index(j)] = lo[model.q_index(j)] - 0.05
    x[:, model.nq + model.v_index(k)] = qd_lim[model.v_index(k)] + 0.5
    return x


def active_hinges(model, X) -> int:
    """How many of ``add_limit_barrier``'s hinges are active over the
    states X (..., nx): coordinates past a position limit plus speeds past
    a velocity limit."""
    lo, hi = model.q_limit_vectors()
    q, qd = X[..., :model.nq], X[..., model.nq:]
    return int(((q > hi) | (q < lo)).sum().item()
               + (qd.abs() > model.qd_limit_vector()).sum().item())


def path_m(h32, smi: str) -> dict:
    """Phase 23, path M: ``hand_path`` on the rpy humanoid (16 problems,
    H=32, 5 iterations of 4 line-search steps, float32, the left wrist
    toward TARGET_Q), with its launch, J and profile checks; then one solve
    of its cost wrapped in ``add_limit_barrier`` at the same shapes through
    the kernels, from the start pushed past three of the arm's limits
    (``past_limits``): ms, J, K4 at fb32 launched, hinges active on the
    solved trajectory after its first knot.  Returns path M's three
    solves' launches by (kernel, size class)."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import DDPConfig, add_limit_barrier, ddp_solve

    _, by_class = hand_path(h32, smi, humanoid_problems, "path M",
                            SEED + 133, "rpy root")
    x0, U0 = humanoid_problems(h32, BH, HH, np.random.default_rng(SEED + 133))
    x0 = past_limits(h32, x0)
    cost = add_limit_barrier(h32, hand_cost(h32))
    cfg = DDPConfig(iters=ITERS_Q, dt=DT, gravity=GRAVITY, n_alphas=ALPHAS_H,
                    fused=True)
    ddp_solve(h32, cost, x0, U0, cfg)
    torch.cuda.synchronize()
    _lib.reset_launches()
    (state, J_hist), times = timed_runs(lambda: ddp_solve(h32, cost, x0, U0,
                                                          cfg), reps=1,
                                        warm=False)
    barrier = dict(_lib.class_launches)
    active = active_hinges(h32, state.X[:, 1:])
    require(bool(J_hist.isfinite().all()), "path M barrier: non-finite J")
    require(active > 0, "path M barrier: no hinge active after knot 0")
    require(barrier.get(("ee_gn", "fb32"), 0) == 2 * ITERS_Q and barrier.get(
        ("ee_err", "fb32"), 0) == 2 + 2 * ITERS_Q,
        f"path M barrier: K4 at fb32 launched {barrier}")
    print(f"path M with add_limit_barrier: Bm={BH} H={HH} iters={ITERS_Q} "
          f"f32 fused, from past the limits: {active} active hinges over "
          f"knots 1-{HH}; mean J {J_hist[0].mean().item():.6g} -> "
          f"{J_hist[-1].mean().item():.6g}; solve {times[0] * 1e3:.1f} ms "
          f"(CUDA events); launches by size class "
          f"{ {f'{k}/{c}': v for (k, c), v in barrier.items()} } ({smi})")
    return by_class


def path_m_parity(h64, smi: str):
    """Path M in float64 at BQ_PARITY problems over HM_PARITY knots, ITERS_Q
    iterations, through the kernels and through the plain route (K4's plain
    version there), with and without ``add_limit_barrier`` around the cost
    (``route_parity``); with the barrier from the start pushed past three
    of the arm's limits (``past_limits``), whose hinges must be active on
    the kernels' solved trajectory after its first knot."""
    from rbdtpu_torch.solver import DDPConfig, add_limit_barrier, ddp_solve

    rng = np.random.default_rng(SEED + 134)
    for barrier in (False, True):
        solved = {}

        def fn(kernels, x0, U0, barrier=barrier):
            cost = hand_cost(h64, kernels)
            if barrier:
                cost = add_limit_barrier(h64, cost)
            state, hist = ddp_solve(h64, cost, x0, U0, DDPConfig(
                iters=ITERS_Q, dt=DT, gravity=GRAVITY, n_alphas=ALPHAS_H,
                fused=kernels))
            solved.setdefault(kernels, state.X)
            return state.U, hist

        x0, U0 = humanoid_problems(h64, BQ_PARITY, HM_PARITY, rng)
        if barrier:
            x0 = past_limits(h64, x0)
        route_parity("path M" + (" with add_limit_barrier" if barrier
                                 else ""), fn, x0, U0, rng, smi)
        if barrier:
            active = active_hinges(h64, solved[True][:, 1:])
            print(f"path M with add_limit_barrier parity: {active} active "
                  f"hinges over knots 1-{HM_PARITY} of the kernels' solve "
                  f"({smi})")
            require(active > 0, "path M barrier parity: no hinge active "
                    "after knot 0")


def gaps_phase(smi: str, rows: dict, ptxas: list):
    """Phase 23: K5 at fb16, fb32 and fq32 and K4 at fb32 against their
    plain versions (``gap_kernels``); path L, whole-horizon legged
    rollouts (``path_l``); path M, the rpy humanoid's hand reaching
    (``path_m``) and its float64 parity with and without the limit barrier
    (``path_m_parity``).  K5's rows take their launches, times and bound
    from path L's rollouts, K4 fb32's launches from path M's three solves,
    by size class."""
    clock = time.perf_counter()

    def took(step: str):
        nonlocal clock
        print(f"phase 23: {step} took {time.perf_counter() - clock:.1f} s")
        clock = time.perf_counter()

    models = legged_models()
    gap_kernels(models, smi, rows, ptxas)
    took("the kernel checks")
    l_class = path_l(models, smi, rows)
    took("path L")
    _, h64, h32, _, _ = models[1]
    m_class = path_m(h32, smi)
    took("path M")
    path_m_parity(h64, smi)
    took("path M's float64 parity")
    for row, kname, cls, run in (
            ("rollout_multi_fb16", "rollout_multi", "fb16", l_class),
            ("rollout_multi_fb32", "rollout_multi", "fb32", l_class),
            ("rollout_multi_fq32", "rollout_multi", "fq32", l_class),
            ("ee_gn_fb32", "ee_gn", "fb32", m_class),
            ("ee_err_fb32", "ee_err", "fb32", m_class)):
        rows[row]["launches"] = run.get((kname, cls), 0)
        require(rows[row]["launches"] > 0,
                f"{row} was not launched on path L or M")
        require(all(k in rows[row] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "graph_ms")),
                f"{row} lacks a time or its bound")


def peak_mb(label: str, fn):
    """``fn()`` with the device's peak allocated memory, printed on a line
    of its own beside what fn added to what the process held before it;
    returns fn's result."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 21 memory: {label}: peak {peak / 2 ** 20:.1f} MiB "
          f"allocated, {(peak - held) / 2 ** 20:.1f} MiB above the "
          f"{held / 2 ** 20:.1f} MiB held before it")
    return out


def so_states(model, B: int, rng):
    """CUDA states (q, qd, qdd) in the model's dtype for the native-vs-AD
    checks (tests/test_idsva.py's draws): uniform in [-1, 1], a quaternion
    root's q[3:7] a normalised N(0, I_4)."""
    import torch

    q = rng.uniform(-1.0, 1.0, (B, model.nq))
    if model.root_quat:
        r = rng.standard_normal((B, 4))
        q[:, 3:7] = r / np.linalg.norm(r, axis=-1, keepdims=True)
    T = lambda a: torch.tensor(a, dtype=model.dtype, device=model.device)
    return (T(q), T(rng.uniform(-1.0, 1.0, (B, model.nv))),
            T(rng.uniform(-1.0, 1.0, (B, model.nv))))


def second_order_checks(models: dict, smi: str):
    """Phase 21's float64 checks of IDSVA-SO on the card: the native sweep
    against forward-mode AD (``idsva_so_ad``) on each model of ``models``
    (label -> (model, states)), max |native - AD| <= TOL64 on all four
    tensors, as rbdtpu's tests/test_idsva.py holds them."""
    import torch
    from rbdtpu_torch.dynamics import idsva_so_ad, idsva_so_native

    rng = np.random.default_rng(SEED + 120)
    for label, (m, B) in models.items():
        args = so_states(m, B, rng)
        nat = peak_mb(f"idsva_so_native f64 {label} B={B}",
                      lambda: idsva_so_native(m, *args))
        ad = peak_mb(f"idsva_so_ad f64 {label} B={B}",
                     lambda: idsva_so_ad(m, *args))
        errs = [(a - b).abs().max().item() for a, b in zip(nat, ad)]
        scale = max(t.abs().max().item() for t in ad)
        print(f"phase 21 IDSVA-SO f64 {label} B={B}: max|native - AD| "
              f"d2q/d2qd/dvdq/dM {' '.join(f'{e:.3e}' for e in errs)} "
              f"(largest entry {scale:.4g}; bound {TOL64:g}) ({smi})")
        require(all(t.shape == (B, m.nv, m.nv, m.nv) and
                    bool(t.isfinite().all()) for t in nat),
                f"IDSVA-SO {label}: native tensors of the wrong shape or "
                "not finite")
        require(max(errs) <= TOL64, f"IDSVA-SO {label}: native and AD "
                f"differ by {max(errs):.3e} > {TOL64:g}")
        del nat, ad
        torch.cuda.empty_cache()


def full_ddp_parity(q64, smi: str):
    """Path I in float64 at BI_PARITY problems over HI_PARITY knots,
    ITERS_I iterations: the kernels (K1 in the initial rollout, K3 in the
    linearisation, K2 in the line search) against the plain route on the
    card, |dU| < U_PARITY, relative |dJ| < TOL64 over the J history, J
    finite and nonincreasing; the kernel solve, its counts set to 0 just
    before, must launch each of K1, K2 and K3."""
    from rbdtpu_torch.kernels import _lib

    x0, U0 = quadruped_problems(q64, BI_PARITY, HI_PARITY,
                                np.random.default_rng(SEED + 121))
    _lib.reset_launches()
    sk, hk = quadruped_solve(q64, x0, U0, ITERS_I, True, exact_hessians=True)
    counts = dict(_lib.launches)
    sp, hp = quadruped_solve(q64, x0, U0, ITERS_I, False,
                             exact_hessians=True)
    du = (sk.U - sp.U).abs().max().item()
    dj = ((hk - hp).abs() / hp.abs().clamp(min=1)).max().item()
    print(f"path I parity f64 Bm={BI_PARITY} H={HI_PARITY} iters={ITERS_I}"
          f": max|U_kernel - U_plain| {du:.3e} (bound {U_PARITY:g}); max "
          f"rel |dJ| over the J history {dj:.3e} (bound {TOL64:g}); kernel "
          f"launches a solve: fd_step {counts['fd_step']}, "
          f"feedback_rollout {counts['feedback_rollout']}, linearize_parts "
          f"{counts['linearize_parts']} ({smi})")
    for h in (hk, hp):
        require(bool(h.isfinite().all()), "path I parity: non-finite J")
        require(bool((h[1:] <= h[:-1]).all()), "path I parity: J increased")
    require(du < U_PARITY and dj < TOL64, "path I: the kernels' full-DDP "
            "solve departs from the plain route's")
    for k in ("fd_step", "feedback_rollout", "linearize_parts"):
        require(counts[k] > 0, f"path I: {k} was not launched under "
                "exact_hessians=True")


def full_ddp_path(q32, smi: str):
    """Path I in float32 (tools/bench_fbddp.py): ``ddp_solve`` of BI rpy
    quadrupeds, HI knots, ITERS_I iterations, ALPHAS3 line-search steps,
    ``fused=True``, ``exact_hessians=True``, beside the same solve with
    ``exact_hessians=False`` (iLQR).  Per solve: ms (median of 3 after a
    warm-up, CUDA events), the mean J each iteration and the iteration that
    first comes within 0.1% of the solve's own floor.  The three timed
    full-DDP solves, counts set to 0 just before, launch K1 HI times and
    K2 and K3 once an iteration each at fb16 (``_lib.class_launches``);
    both J histories finite, nonincreasing and falling.  Then the full-DDP
    solve's profile, the ``fdsva_so`` assembly and the backward sweep
    apart."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.kernels.fused import fd_step_fused
    from rbdtpu_torch.solver import trajectory_cost

    x0, U0 = quadruped_problems(q32, BI, HI, np.random.default_rng(SEED + 122))
    xs = [x0]
    for t in range(HI):
        xs.append(fd_step_fused(q32, xs[-1], U0[:, t].contiguous(), DT,
                                GRAVITY))
    J0 = trajectory_cost(quadruped_cost(q32), torch.stack(xs, dim=-2), U0)
    out = {}
    for name, exact in (("full DDP", True), ("iLQR", False)):
        solve = lambda e=exact: quadruped_solve(q32, x0, U0, ITERS_I, True,
                                                exact_hessians=e)
        peak_mb(f"path I {name} solve", solve)  # also the warm-up
        _lib.reset_launches()
        (state, hist), times = timed_runs(solve, warm=False)
        by_class = dict(_lib.class_launches)
        Jm = hist.double().mean(-1).cpu().numpy()
        floor = Jm[-1]
        k = int(np.argmax(Jm <= floor * 1.001)) + 1
        sec = statistics.median(times)
        print(f"path I {name}: quadruped12 rpy tracking, Bm={BI} H={HI} "
              f"iters={ITERS_I} alphas={ALPHAS3} f32 fused: solve "
              f"{sec * 1e3:.1f} ms (median of 3: "
              f"{' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) = "
              f"{BI / sec:.1f} solves/s, {sec * 1e3 / ITERS_I:.2f} ms an "
              f"iteration; mean J {J0.mean().item():.6g} then per iteration "
              f"{' '.join(f'{v:.6g}' for v in Jm)}; within 0.1% of its floor "
              f"({floor:.6g}) at iteration {k} ({smi})")
        print(f"path I {name} launches by (kernel, size class), 3 solves: "
              f"{by_class}")
        require(bool(hist.isfinite().all()), f"path I {name}: non-finite J")
        require(bool((hist[1:] <= hist[:-1]).all()) and bool(
            (hist[0] <= J0 * (1 + 1e-6)).all()), f"path I {name}: J "
                "increased")
        require(hist[-1].mean() < J0.mean(), f"path I {name}: mean J did "
                "not fall")
        out[name] = by_class
    full = out["full DDP"]
    for k, v in (("fd_step", HI), ("feedback_rollout", ITERS_I),
                 ("linearize_parts", ITERS_I)):
        require(full.get((k, "fb16"), 0) == 3 * v, f"path I: {k} at fb16 "
                f"launched {full.get((k, 'fb16'), 0)} times in 3 solves, "
                f"expected {3 * v}")
    profile_main_path(lambda: quadruped_solve(q32, x0, U0, ITERS_I, True,
                                              exact_hessians=True),
                      extra=("fdsva_so",), cpu=False)


def path_i_kernels(q64, q32, smi: str):
    """K1-K3 on the rpy root (class fb16) against their plain versions at
    path I's own shapes (``floating_kernel_inputs``): K1 at BI states (the
    initial rollout's step), K2 at ALPHAS3 * BI trajectories over HI knots
    (the line search), K3 at BI * HI knots (the linearisation); float64
    within TOL64, float32 within TOL32, each timed beside its bound."""
    qin = floating_kernel_inputs(q64, np.random.default_rng(SEED + 124),
                                 quadruped_problems, BI, ALPHAS3 * BI, HI,
                                 BI * HI)
    states = {"fd_step": BI, "feedback_rollout": ALPHAS3 * BI * HI,
              "linearize_parts": BI * HI}
    check_kernels([(f"{k} path I", k, qin[k], {}, k, states[k])
                   for k in states], q64, q32, smi)


def idsva_cells(a32, h32, smi: str):
    """The two IDSVA cells in float32, native sweep against AD, eval/s by
    CUDA events: arm7 at B_SO states x R_SO calls on q, qd, qdd drawn
    0.5 N(0,1) apart (bench.py:674-707), and the quaternion humanoid with
    states retracted from the identity by 0.3 N(0,1), qd and qdd
    0.5 N(0,1) (bench.py:593-638), natively at B_SO_H x R_SO_H and by
    retraction AD at B_SO_AD x 1.  Each output must be finite.  The native
    rows take the best of 3 timed runs, the AD rows (seconds a run) of 2,
    each after the warm-up call that reads its peak memory."""
    import torch
    from rbdtpu_torch.dynamics import idsva_so_ad, idsva_so_native
    from rbdtpu_torch.solver import config_retract

    rng = np.random.default_rng(SEED + 123)
    T = lambda m, a: torch.tensor(a, dtype=m.dtype, device=m.device)

    def humanoid_states(B):
        q = torch.zeros(B, h32.nq, dtype=h32.dtype, device=h32.device)
        q[:, 3] = 1.0
        q = config_retract(h32, q, T(h32, 0.3 * rng.standard_normal(
            (B, h32.nv))))
        return (q, T(h32, 0.5 * rng.standard_normal((B, h32.nv))),
                T(h32, 0.5 * rng.standard_normal((B, h32.nv))))

    arm = tuple(T(a32, 0.5 * rng.standard_normal((B_SO, a32.nv)))
                for _ in range(3))
    hum, hum_ad = humanoid_states(B_SO_H), humanoid_states(B_SO_AD)
    for label, m, fn, args, R, reps in (
            ("arm7 native", a32, idsva_so_native, arm, R_SO, 3),
            ("arm7 AD", a32, idsva_so_ad, arm, R_SO, 2),
            ("humanoid30 quat native", h32, idsva_so_native, hum, R_SO_H, 3),
            ("humanoid30 quat retraction-AD", h32, idsva_so_ad, hum_ad, 1,
             2)):
        outs = peak_mb(f"IDSVA cell {label} B={args[0].shape[0]}",
                       lambda: fn(m, *args))
        require(all(bool(t.isfinite().all()) for t in outs),
                f"IDSVA cell {label}: non-finite tensors")
        del outs
        B = args[0].shape[0]
        _, times = timed_runs(lambda: [fn(m, *args) for _ in range(R)],
                              reps, warm=False)
        rate = B * R / min(times)
        print(f"IDSVA cell {label}: B={B} x {R} calls f32: {rate:,.1f} "
              f"eval/s (best of {reps}: "
              f"{' '.join(f'{t * 1e3:.2f}' for t in times)} ms for {R} "
              f"calls, CUDA events) ({smi})")
        torch.cuda.empty_cache()


def second_order_phase(smi: str):
    """Phase 21: the float64 IDSVA-SO checks (``second_order_checks``),
    path I's float64 parity (``full_ddp_parity``), K1-K3 at path I's
    shapes against their plain versions (``path_i_kernels``), then path I
    timed (``full_ddp_path``) and the IDSVA cells (``idsva_cells``) in
    float32."""
    import torch
    from rbdtpu_torch.model import load_asset

    load = lambda name, dt, **kw: load_asset(name, device="cuda", dtype=dt,
                                             **kw)
    f64 = torch.float64
    clock = time.perf_counter()

    def took(step: str):
        nonlocal clock
        print(f"phase 21: {step} took {time.perf_counter() - clock:.1f} s")
        clock = time.perf_counter()

    second_order_checks({
        "arm7": (load("arm7", f64), B_SO_CHECK),
        "quadruped12 rpy": (load("quadruped12", f64, floating_base=True),
                            B_SO_CHECK),
        "quadruped12 quat": (load("quadruped12", f64, floating_base=True,
                                  root_quat=True), B_SO_CHECK),
        "humanoid30 quat": (load("humanoid30", f64, floating_base=True,
                                 root_quat=True), 1)}, smi)
    took("the float64 IDSVA-SO checks")
    q64 = load("quadruped12", f64, floating_base=True)
    q32 = load("quadruped12", torch.float32, floating_base=True)
    full_ddp_parity(q64, smi)
    took("path I's float64 parity")
    path_i_kernels(q64, q32, smi)
    took("K1-K3 at path I's shapes")
    full_ddp_path(q32, smi)
    took("path I")
    idsva_cells(load("arm7", torch.float32),
                load("humanoid30", torch.float32, floating_base=True,
                     root_quat=True), smi)
    took("the IDSVA cells")


def path_n_solves(mesh, m32, m64) -> dict:
    """Path N's sharded solves on ``mesh`` (over all its axes): configs[2]
    in float32 (one warm-up, then one solve timed by CUDA events with the
    counts set to 0 just before and read just after), then ``ddp_solve``
    of this rank's rows alone (the process-local solve; at world size 1
    the unsharded one), timed likewise; then in float64 the same problems
    and the check at BN_CHECK x HN_CHECK.  Returns the gathered results on
    the host, whether this rank's rows equal the local solve's bit for
    bit, the local solve's J history, both solves' ms, the sharded solve's
    launches and the peak memory."""
    import torch
    from rbdtpu_torch.distrib import shard_batch, sharded_ddp_solve
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import DDPConfig, ee_reaching_cost

    axis = mesh.axis_names
    cfg = DDPConfig(iters=ITERS_N, dt=DT, gravity=GRAVITY, n_alphas=8,
                    fused=True)
    x0, U0 = start_problems(m32, BN, HN, np.random.default_rng(SEED + 1))
    cost = ee_reaching_cost(m32, TARGET, **WEIGHTS)
    solve_n = lambda: sharded_ddp_solve(mesh, m32, cost, x0, U0, cfg, axis)
    solve_n()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    (J, U, mean_J), ms = timed_call(solve_n)
    launches = {k: _lib.launches[k] for k in DDP_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    (local, J_hist), local_ms = timed_call(lambda: solve(
        m32, shard_batch(mesh, x0, axis), shard_batch(mesh, U0, axis), True,
        ITERS_N))
    same = (torch.equal(shard_batch(mesh, J, axis), local.J)
            and torch.equal(shard_batch(mesh, U, axis), local.U))
    cost64 = ee_reaching_cost(m64, TARGET, **WEIGHTS)
    x64, U64 = start_problems(m64, BN, HN, np.random.default_rng(SEED + 1))
    Jf, Uf, mean_f = sharded_ddp_solve(mesh, m64, cost64, x64, U64, cfg,
                                       axis)
    x8, U8 = start_problems(m64, BN_CHECK, HN_CHECK,
                            np.random.default_rng(SEED + 2))
    J8, U8, _ = sharded_ddp_solve(mesh, m64, cost64, x8, U8, cfg, axis)
    host = lambda t: t.cpu().numpy()
    return dict(J=host(J), U=host(U), mean_J=mean_J.item(), ms=ms,
                local_ms=local_ms, launches=launches, peak_mib=peak,
                local_equal=bool(same),
                J_local=host(local.J), U_local=host(local.U),
                J_hist=host(J_hist), J64=host(Jf), U64=host(Uf),
                mean_J64=mean_f.item(), J8=host(J8), U8=host(U8))


def path_n_mppi(mesh, h64):
    """configs[4]'s population-sharded MPPI update on ``mesh``: one rpy
    humanoid problem (path C's start), BH x SAMPLES_H standard normals
    from one seed on the card, this rank's share by its shard index.
    Returns (U_new, J_mean) on the host and the update's ms."""
    import torch
    from rbdtpu_torch.distrib import sharded_mppi_step
    from rbdtpu_torch.solver import MPPIConfig

    axis = mesh.axis_names
    S = BH * SAMPLES_H
    x0, U0 = humanoid_problems(h64, 1, HH, np.random.default_rng(SEED + 40))
    gen = torch.Generator(device=h64.device).manual_seed(SEED + 41)
    noise = torch.randn((S, HH, h64.nv), generator=gen, dtype=h64.dtype,
                        device=h64.device)
    per, k = S // mesh.axis_size(axis), mesh.axis_index(axis)
    cfg = MPPIConfig(n_samples=S, sigma=SIGMA_H, dt=DT, gravity=GRAVITY)
    (U1, J1), ms = timed_call(lambda: sharded_mppi_step(
        mesh, h64, humanoid_cost(h64), x0[0], U0[0], config=cfg, axis=axis,
        noise=noise[k * per:(k + 1) * per]))
    return U1.cpu().numpy(), J1.item(), ms


def path_n_rank(mesh, argv) -> int:
    """``distrib.launch``'s entry for path N's ranks: the sharded solves
    and the MPPI update on this rank; writes its launches, times and peak
    memory to ``argv[0]``/rank<r>.json, and rank 0 the gathered results
    to ``argv[0]``/ranks.npz."""
    import torch
    from rbdtpu_torch.model import load_asset

    t0 = time.perf_counter()
    load = lambda name, dt, **kw: load_asset(name, device=mesh.device,
                                             dtype=dt, **kw)
    r = path_n_solves(mesh, load("arm7", torch.float32),
                      load("arm7", torch.float64))
    U_m, J_m, mppi_ms = path_n_mppi(
        mesh, load("humanoid30", torch.float64, floating_base=True))
    with open(f"{argv[0]}/rank{mesh.rank}.json", "w") as f:
        json.dump({
            "device": str(mesh.device), "backend": mesh.backend,
            "launches": r["launches"], "local_equal": r["local_equal"],
            "solve_ms": r["ms"], "local_solve_ms": r["local_ms"],
            "mppi_ms": mppi_ms, "peak_mib": r["peak_mib"],
            "s": time.perf_counter() - t0}, f)
    if mesh.rank == 0:
        np.savez(f"{argv[0]}/ranks.npz", mppi_U=U_m, mppi_J=J_m,
                 **{k: r[k] for k in ("J", "U", "mean_J", "J64", "U64",
                                      "mean_J64", "J8", "U8")})
    return 0


def path_n_split(m64, m32, J_ref, smi: str):
    """Where configs[2]'s float32 solve parts by batch size, in one
    process: each piece of an iteration called once on the whole batch
    and once on its first 1/N_RANKS of the rows, at the main path's
    shapes (K1-K4 and their plain versions on ``kernel_inputs``; the
    Riccati sweep ``backward_pass`` over BN problems and HN knots, and its
    batched products, Cholesky factor and Cholesky solve alone); then the BN
    problems solved as N_RANKS row blocks, on the plain route
    (``fused=False``) for one iteration against its whole batch, and
    through the kernels for ITERS_N iterations against ``J_ref``, the
    whole batch's J.  Prints, per piece and per route, how many rows are
    not bit for bit the same.  Requires K1-K4 to be row for row the same
    at both batches (each state, trajectory or knot is computed alone).
    Returns the kernel route's block J on the host."""
    import torch
    from rbdtpu_torch.solver.ddp import backward_pass

    differ = lambda whole, part, n: sum(
        int((w[:n] != p).reshape(n, -1).any(-1).sum())
        for w, p in zip(whole, part))
    outs = lambda o: [t for t in (o if isinstance(o, tuple) else (o,))
                      if t is not None]
    table = kernel_table()
    inputs = kernel_inputs(m64, np.random.default_rng(SEED + 4))
    kernel_rows = {}
    for kname in DDP_KERNELS:
        kern, plain = table[kname][:2]
        a = tuple(t.float() for t in inputs[kname])
        B = a[0].shape[0]
        half = B // N_RANKS
        cut = tuple(t[:half].contiguous() for t in a)
        for route, fn in (("kernel", kern), ("plain", plain)):
            n = differ(outs(fn(m32, *a)), outs(fn(m32, *cut)), half)
            if route == "kernel":
                kernel_rows[kname] = n
            print(f"phase 24 path N split: {kname} {route} B={B} against "
                  f"its first {half} rows, float32: {n} rows not bit for bit")
    rng = np.random.default_rng(SEED + 5)
    nx, nu = 2 * m32.nv, m32.nv
    T = lambda *sh: torch.tensor(rng.standard_normal(sh), dtype=torch.float32,
                                 device=m32.device)
    eye = lambda n: torch.eye(n, dtype=torch.float32, device=m32.device)
    M = T(BN, nx, nx)
    S = M[:, :nu, :nu] @ M[:, :nu, :nu].transpose(-1, -2) + eye(nu)
    ops = {
        # A, B, lx, lu, lxx, luu, lux (constant), lfx, lfxx, reg
        "backward_pass": (backward_pass, (
            eye(nx) + 0.01 * T(BN, HN, nx, nx), 0.01 * T(BN, HN, nx, nu),
            T(BN, HN, nx), T(BN, HN, nu), eye(nx), 1e-2 * eye(nu),
            0 * T(nu, nx), T(BN, nx), 10 * eye(nx),
            torch.full((BN,), 1e-6, device=m32.device))),
        # the sweep's products: A^T (Vxx A), B^T (Vxx B), A^T Vx
        "matmul": (torch.matmul, (M, M)),
        "matmul A^T M": (lambda a, m: a.transpose(-1, -2) @ m, (M, M)),
        "matmul B^T M B": (lambda b, m: b.transpose(-1, -2) @ (m @ b),
                           (M[..., :nu], M)),
        "mv A^T x": (lambda a, x: (a.transpose(-1, -2) @ x[..., None]),
                     (M, M[..., 0])),
        "cholesky_ex": (lambda s: torch.linalg.cholesky_ex(s)[0], (S,)),
        "cholesky_solve": (torch.cholesky_solve,
                           (T(BN, nu, nx), torch.linalg.cholesky(S))),
    }
    half = BN // N_RANKS
    for op, (fn, a) in ops.items():
        cut = tuple(t[:half] if t.shape[0] == BN else t for t in a)
        n = differ(outs(fn(*a)), outs(fn(*cut)), half)
        print(f"phase 24 path N split: {op} plain B={BN} against its first "
              f"{half} rows, float32: {n} rows not bit for bit")
    x0, U0 = start_problems(m32, BN, HN, np.random.default_rng(SEED + 1))
    blocks = [slice(r * half, (r + 1) * half) for r in range(N_RANKS)]
    for fused, iters in ((False, 1), (True, ITERS_N)):
        J = torch.cat([solve(m32, x0[b], U0[b], fused, iters)[0].J
                       for b in blocks]).cpu().numpy()
        whole = (solve(m32, x0, U0, fused, iters)[0].J.cpu().numpy()
                 if not fused else J_ref)
        print(f"phase 24 path N split: solve on the "
              f"{'kernel' if fused else 'plain'} route, float32, {iters} "
              f"iteration(s): {int((J != whole).sum())} of {BN} J not bit "
              f"for bit as {N_RANKS} blocks, max rel |dJ| "
              f"{np.max(np.abs(J - whole) / np.abs(whole)):.3e} ({smi})")
    for kname, n in kernel_rows.items():
        require(n == 0, f"path N: {kname}'s kernel depends on the batch in "
                f"{n} rows")
    return J


def compat_on_card(smi: str):
    """The compat mirror's calls (``rbdtpu_torch.oracle.compat_calls``,
    the CPU tests' list) on the card against the CPU in float64, on arm7,
    the rpy quadruped and the quaternion humanoid: <= 1e-9 (relative
    where a value exceeds 1); a call the mirror refuses on the CPU must be
    refused on the card."""
    import torch
    from rbdtpu_torch.compat import RBDReferenceTorch
    from rbdtpu_torch.model import load_asset
    from rbdtpu_torch.oracle.compat_calls import MODELS, calls, state

    for tag, (name, kw) in MODELS.items():
        m = load_asset(name, device="cpu", dtype=torch.float64, **kw)
        s = state(tag, m.nq, m.nv, m.nb)
        cpu = dict(calls(RBDReferenceTorch(m), tag, s))
        worst, n = 0.0, 0
        for call, fn in calls(RBDReferenceTorch(m, device="cuda"), tag, s):
            try:
                want = cpu[call]()
            except ValueError:
                try:
                    fn()
                except ValueError:
                    continue
                raise SystemExit(f"chip_smoke FAILED: compat {tag} {call} "
                                 "refused on the CPU, not on the card")
            for got, ref in zip(fn(), want):
                scale = max(1.0, float(np.abs(ref).max()))
                err = float(np.abs(np.asarray(got) - ref).max()) / scale
                require(np.shape(got) == np.shape(ref) and err <= 1e-9,
                        f"compat {tag} {call}: card against CPU {err:.3e}")
                worst = max(worst, err)
            n += 1
        print(f"phase 24 compat {tag}: {n} calls on the card against the "
              f"CPU, float64, max rel err {worst:.3e} (bound 1e-9) on {smi}")


def sharded_phase(smi: str):
    """Phase 24, path N: the sharded fleet.  First N_RANKS ranks sharing
    the card over gloo, started by ``python -m
    rbdtpu_torch.distrib.launch`` (entry ``path_n_rank``), each launching
    K1-K4 and holding its rows to its process-local solve of them bit for
    bit; then world size 1 over NCCL in this process (``make_mesh`` from
    the torchrun environment), whose configs[2] solve must equal the
    unsharded ``ddp_solve`` bit for bit, its J finite and nonincreasing.
    The ranks' float32 parting from the unsharded solve is printed;
    ``path_n_split`` finds where it comes from, requires K1-K4 to be row
    for row the same at the ranks' batch, and the ranks' J must equal this
    process's solve of their row blocks bit for bit.  In float64 at
    configs[2]'s shapes the sharded solves are held to the unsharded one
    by phase 19's floor rule on the upper quartile over the problems (J,
    U) and on the mean J, which must also be its gathered J's; the float64
    check at BN_CHECK x HN_CHECK (|dU| < 1e-6, relative |dJ| < 1e-9); the
    ranks' MPPI update against one rank's on the same normals
    (MPPI_N_TOL); the compat mirror on the card.  Ranks that share one
    card check the harness; their times are no scaling result."""
    import os
    import shutil
    import socket
    import tempfile

    import torch
    import torch.distributed as dist
    from rbdtpu_torch.distrib import make_mesh
    from rbdtpu_torch.model import load_asset

    clock = time.perf_counter()

    def took(step: str):
        nonlocal clock
        print(f"phase 24: {step} took {time.perf_counter() - clock:.1f} s")
        clock = time.perf_counter()

    out_dir = tempfile.mkdtemp(prefix="path_n_")
    saved = {k: os.environ.get(k) for k in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    try:
        # ---- N_RANKS ranks sharing the card over gloo ----
        proc = subprocess.run(
            [sys.executable, "-m", "rbdtpu_torch.distrib.launch",
             "--num-processes", str(N_RANKS), "--backend", "gloo",
             "--device", "cuda", "--entry", "chip_smoke:path_n_rank", "--",
             out_dir], capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        require(proc.returncode == 0, f"path N: distrib.launch exited "
                f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                f"{proc.stderr[-3000:]}")
        for r in range(N_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                rank = json.load(f)
            print(f"phase 24 path N rank {r}: {json.dumps(rank)} ({smi})")
            for kname in DDP_KERNELS:
                require(rank["launches"][kname] > 0,
                        f"path N: {kname} was not launched on rank {r}")
            require(rank["local_equal"], f"path N: rank {r}'s rows are not "
                    "its process-local solve of them bit for bit")
        with np.load(os.path.join(out_dir, "ranks.npz")) as f:
            ranks = {k: f[k] for k in f.files}
        took(f"{N_RANKS} ranks over gloo")

        # ---- world size 1 over NCCL ----
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        mesh = make_mesh()
        require(mesh.backend == "nccl" and mesh.device.type == "cuda",
                f"make_mesh on the card gave {mesh.backend} on {mesh.device}")
        m32 = load_asset("arm7", device=mesh.device, dtype=torch.float32)
        m64 = load_asset("arm7", device=mesh.device, dtype=torch.float64)
        one = path_n_solves(mesh, m32, m64)
        for kname in DDP_KERNELS:
            require(one["launches"][kname] > 0,
                    f"path N: {kname} was not launched at world size 1")
        print(f"phase 24 path N world size 1 (nccl): launches "
              f"{one['launches']}; sharded solve {one['ms']:.1f} ms, the "
              f"unsharded one {one['local_ms']:.1f} ms (CUDA events); peak "
              f"{one['peak_mib']:.1f} MiB allocated in this process (with "
              f"what the earlier phases hold) on {smi}")
        took("world size 1 over NCCL")

        # ---- the unsharded solve of the same problems: world size 1's
        # process-local solve ----
        J_hist = one["J_hist"]
        require(np.isfinite(J_hist).all()
                and bool((J_hist[1:] <= J_hist[:-1]).all()),
                "path N: the unsharded J is not finite and nonincreasing")
        J_ref, U_ref = one["J_local"], one["U_local"]
        require(one["local_equal"], "path N: the world-size-1 sharded solve "
                "is not the unsharded one bit for bit")
        require(abs(one["mean_J"] - J_ref.mean()) <= 1e-6 * abs(
            J_ref.mean()), "path N: mean J")
        dj32 = np.abs(ranks["J"] - J_ref) / np.abs(J_ref)
        print(f"phase 24 path N {N_RANKS} ranks against unsharded, float32 "
              f"Bm={BN} H={HN} (measured; held in float64 below): max rel "
              f"|dJ| {dj32.max():.3e}, median {np.median(dj32):.3e}, "
              f"{int((dj32 > 0).sum())} of {BN} problems not bit for bit, "
              f"max |dU| {np.abs(ranks['U'] - U_ref).max():.3e}, rel |d "
              f"mean J| {abs(ranks['mean_J'] - J_ref.mean()) / J_ref.mean():.3e}"
              f"; mean J {J_ref.mean():.4f}")
        took("world size 1's checks")
        J_blocks = path_n_split(m64, m32, J_ref, smi)
        require(np.array_equal(ranks["J"], J_blocks), f"path N: the "
                f"{N_RANKS} ranks' J is not this process's solve of their "
                "row blocks bit for bit")
        took("the batch split")
        # float64 at configs[2]'s shapes.  A few problems part from
        # themselves by O(1) in J when x0 moves by 1e-13, so phase 19's
        # floor rule is applied to the upper quartile over the problems
        rng = np.random.default_rng(SEED + 3)
        x64, U64 = start_problems(m64, BN, HN, np.random.default_rng(SEED + 1))
        moved = x64 * (1 + 1e-13 * torch.tensor(
            rng.standard_normal(x64.shape), dtype=x64.dtype,
            device=x64.device))
        host = lambda st: (st.J.cpu().numpy(), st.U.cpu().numpy())
        J64, U64r = host(solve(m64, x64, U64, True, ITERS_N)[0])
        parts = lambda J, U: (np.abs(J - J64) / np.abs(J64), np.abs(
            U - U64r).reshape(BN, -1).max(1))
        q = lambda v: float(np.quantile(v, 0.75))
        Jm, Um = host(solve(m64, moved, U64, True, ITERS_N)[0])
        fj, fu = parts(Jm, Um)
        d_mean = lambda m: abs(float(m) - J64.mean()) / J64.mean()
        bj = max(TOL64, FLOOR_TIMES * q(fj))
        bu = max(U_PARITY, FLOOR_TIMES * q(fu))
        bm = max(TOL64, FLOOR_TIMES * d_mean(Jm.mean()))
        print(f"phase 24 path N float64 Bm={BN} H={HN} floor: the unsharded "
              f"solve from x0 x (1 + 1e-13 N(0,1)): rel |dJ| upper quartile "
              f"{q(fj):.3e}, max {fj.max():.3e}; |dU| upper quartile "
              f"{q(fu):.3e}, max {fu.max():.3e}; rel |d mean J| "
              f"{d_mean(Jm.mean()):.3e}")
        for tag, r in (("world size 1", one), (f"{N_RANKS} ranks", ranks)):
            dj, du = parts(r["J64"], r["U64"])
            mean = float(r["mean_J64"])
            gathered = abs(mean - r["J64"].mean()) / r["J64"].mean()
            print(f"phase 24 path N {tag} against unsharded, float64 Bm={BN}"
                  f" H={HN}: rel |dJ| upper quartile {q(dj):.3e} (bound "
                  f"{bj:.3g}), max {dj.max():.3e}; |dU| upper quartile "
                  f"{q(du):.3e} (bound {bu:.3g}), max {du.max():.3e}; rel "
                  f"|d mean J| {d_mean(mean):.3e} (bound {bm:.3g}) (bounds: "
                  f"{TOL64:g}, {U_PARITY:g} and {TOL64:g}, or "
                  f"{FLOOR_TIMES:g} x the floor's); mean J {mean:.9g} "
                  f"against its gathered J {gathered:.3e} (bound 1e-12)")
            require(q(dj) <= bj and q(du) <= bu and d_mean(mean) <= bm
                    and gathered <= 1e-12, f"path N {tag}: the float64 "
                    "sharded solve departs from the unsharded one")
        x8, U8 = start_problems(m64, BN_CHECK, HN_CHECK,
                                np.random.default_rng(SEED + 2))
        J8, U8r = host(solve(m64, x8, U8, True, ITERS_N)[0])
        for tag, r in (("world size 1", one), (f"{N_RANKS} ranks", ranks)):
            du8 = float(np.abs(r["U8"] - U8r).max())
            dj8 = float(np.max(np.abs(r["J8"] - J8) / np.maximum(
                1.0, np.abs(J8))))
            print(f"phase 24 path N {tag} float64 Bm={BN_CHECK} "
                  f"H={HN_CHECK}: max |dU| {du8:.3e} (bound 1e-6), max rel "
                  f"|dJ| {dj8:.3e} (bound 1e-9)")
            require(du8 < 1e-6 and dj8 < 1e-9,
                    f"path N {tag}: float64 check |dU| {du8:.3e}, "
                    f"|dJ| {dj8:.3e}")
        took("the float64 solves")

        # ---- the MPPI update: one rank on the ranks' normals ----
        U_m, J_m, mppi_ms = path_n_mppi(mesh, load_asset(
            "humanoid30", device=mesh.device, dtype=torch.float64,
            floating_base=True))
        err_u = float(np.abs(ranks["mppi_U"] - U_m).max()) / max(
            1.0, float(np.abs(U_m).max()))
        err_j = abs(float(ranks["mppi_J"]) - J_m) / max(1.0, abs(J_m))
        print(f"phase 24 path N MPPI, rpy humanoid, {BH * SAMPLES_H} "
              f"samples, H={HH}, sigma={SIGMA_H}, float64: {N_RANKS} ranks "
              f"against one on the same normals, rel |dU| {err_u:.3e}, "
              f"|dJ| {err_j:.3e} (bound {MPPI_N_TOL:g}); one rank "
              f"{mppi_ms:.1f} ms (CUDA events)")
        require(np.isfinite(U_m).all() and err_u <= MPPI_N_TOL
                and err_j <= MPPI_N_TOL, "path N: the sharded MPPI update")
        took("the MPPI update")
        compat_on_card(smi)
        took("the compat mirror")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(out_dir, ignore_errors=True)


# ---- phase 25: path O, the model-specialised kernels (K0) ----
# each specialised kernel, its table twin and the TPU kernel both replace
STATIC_TWINS = {"rnea_static": "rnea", "fd_step_static": "fd_step",
                "fd_step_minv_static": "fd_step_minv",
                "rollout_multi_static": "rollout_multi"}
STATIC_SOURCE = "rbdtpu_torch/kernels/codegen.py"
# path O on the rpy quadruped: path L's start and inputs at BL x HL
_PTXAS_FN = re.compile(r"(?:Compiling entry function|Function properties "
                       r"for) '?([A-Za-z0-9_]+)")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def static_table():
    """name -> (specialised kernel, its plain lane version, its table twin),
    each fn(model, *args, **kw) on the args of ``check_kernels``' form."""
    from rbdtpu_torch.kernels import colvec, fk_lane, fused

    def minv_plain(m, x, u, dense_minv=False, f_ext=None):
        return fused.fd_step_static_plain(m, x, u, DT, GRAVITY, f_ext,
                                          "minv", dense_minv)

    def rollout_plain(m, x0, U, route="aba", f_ext=None):
        return fused.rollout_static_plain(m, x0, U, DT, GRAVITY, route, f_ext)

    return {
        "rnea_static": (
            lambda m, *a: fused.rnea_fused(m, *a, gravity=GRAVITY,
                                           specialize=True),
            lambda m, *a: fused.rnea_static_plain(m, *a, gravity=GRAVITY),
            lambda m, *a: fused.rnea_fused(m, *a, gravity=GRAVITY)),
        "fd_step_static": (
            lambda m, x, u, **kw: fused.fd_step_fused(
                m, x, u, DT, GRAVITY, specialize=True, **kw),
            lambda m, x, u, **kw: fused.fd_step_static_plain(
                m, x, u, DT, GRAVITY, **kw),
            lambda m, x, u, **kw: fused.fd_step_fused(m, x, u, DT, GRAVITY,
                                                      **kw)),
        "fd_step_minv_static": (
            lambda m, x, u, **kw: fused.fd_step_minv_fused(
                m, x, u, DT, GRAVITY, specialize=True, **kw),
            minv_plain,
            lambda m, x, u, **kw: fused.fd_step_minv_fused(
                m, x, u, DT, GRAVITY, **kw)),
        "rollout_multi_static": (
            lambda m, x0, U, **kw: fused.rollout_fused_multi(
                m, x0, U, DT, GRAVITY, specialize=True, **kw),
            rollout_plain,
            lambda m, x0, U, **kw: fused.rollout_fused_multi(
                m, x0, U, DT, GRAVITY, **kw)),
        "feedback_rollout_static": (
            lambda m, *a, **kw: fused.feedback_rollout_fused(
                m, *a, DT, GRAVITY, specialize=True, **kw),
            plain_lane_feedback,
            lambda m, *a, **kw: fused.feedback_rollout_fused(
                m, *a, DT, GRAVITY, **kw)),
        "linearize_parts_static": (
            lambda m, *a: colvec.linearize_parts_fused(m, *a, GRAVITY,
                                                       specialize=True),
            lambda m, *a: colvec.linearize_parts_static_plain(m, *a,
                                                              GRAVITY),
            lambda m, *a: colvec.linearize_parts_fused(m, *a, GRAVITY)),
        **{f"ee_{'gn' if gn else 'err'}_static": (
            lambda m, q, target, ee_names=None, gn=gn: fk_lane.ee_gn_fused(
                m, q, target, ee_names=ee_names, gn=gn, specialize=True),
            lambda m, q, target, ee_names=None, gn=gn:
                fk_lane.ee_gn_static_plain(m, q, target, ee_names=ee_names,
                                           gn=gn),
            lambda m, q, target, ee_names=None, gn=gn: fk_lane.ee_gn_fused(
                m, q, target, ee_names=ee_names, gn=gn))
            for gn in (True, False)},
    }


def only_launch(kname: str, fn):
    """fn()'s result, requiring that it launched ``kname`` once and no other
    kernel (a specialised call never falls back to a table kernel)."""
    import torch
    from rbdtpu_torch.kernels import _lib

    before = dict(_lib.launches)
    out = fn()
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _lib.launches.items()
             if v != before[k]}
    require(moved == {kname: 1}, f"a {kname} call launched {moved}")
    return out


def static_ptxas(log: str) -> list:
    """Per function of one library's ptxas report: (name, registers or
    None, stack bytes, spill store bytes, spill load bytes, source)."""
    out, fn, regs, source = [], None, {}, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            source = ln[3:].strip()
            continue
        m = _PTXAS_FN.search(ln)
        if m:
            fn = m.group(1)
        m = _PTXAS_STACK.search(ln)
        if m and fn:
            out.append([fn, None, *map(int, m.groups()), source])
        m = _PTXAS_REGS.search(ln)
        if m and fn:
            regs[fn] = int(m.group(1))
    for row in out:
        row[1] = regs.get(row[0])
    return out


def static_ees(models) -> list:
    """(tag, model, dtype, jid, fid) of each model's effector library: the
    single leaf (arm7's configs[2] effector), or path E's foot
    (``foot_ee``) on a model of several leaves."""
    from rbdtpu_torch.kernels.fk_lane import _single_ee

    return [(tag, m, m.dtype, *_single_ee(
        m, foot_ee(m) if len(m.leaves()) > 1 else None))
            for tag, m64, m32 in models for m in (m64, m32)]


def static_build(models, smi: str, ees=(), phase: int = 25,
                 sources=None) -> dict:
    """Build the specialised libraries of every (tag, float64 model,
    float32 model) and the effector libraries of ``ees`` (``static_ees``)
    in one call (``_lib.prepare_static``: one nvcc a source, all at once)
    and print each source's build seconds and each function's ptxas line
    (of the sources named in ``sources`` alone, when given).  Returns
    {(tag, dtype name): build.json} with the ptxas rows under "ptxas"
    (an effector library's tag ends in " effector")."""
    import os

    from rbdtpu_torch.kernels import _lib

    pairs = [(tag, m) for tag, m64, m32 in models for m in (m64, m32)]
    t = time.perf_counter()
    dirs = _lib.prepare_static([(m, m.dtype) for _, m in pairs],
                               ees=[e[1:] for e in ees])
    print(f"phase {phase} build: {len(dirs)} specialised libraries, "
          f"{sum(len(os.listdir(d)) for d in dirs)} files, "
          f"{time.perf_counter() - t:.1f} s ({smi})")
    info = {}
    named = pairs + [(f"{e[0]} effector", e[1]) for e in ees]
    keep = lambda n: sources is None or n in sources
    for (tag, m), d in zip(named, dirs):
        dt = str(m.dtype)[6:]
        with open(os.path.join(d, "build.json")) as f:
            b = json.load(f)
        with open(os.path.join(d, "ptxas.log")) as f:
            b["ptxas"] = static_ptxas(f.read())
        info[tag, dt] = b
        print(f"phase {phase} build {tag} {dt}: seconds a source (wall, "
              f"{b['parallel']} compiles at once) " + ", ".join(
                  f"{n} {s:.1f}" for n, s in b["seconds"].items() if keep(n))
              + f"; link {b['link_seconds']:.1f}; operations a state "
              + ", ".join(f"{n} {o}" for n, o in b["ops"].items()))
        for fn, regs, stack, st, ld, src in b["ptxas"]:
            if keep(src):
                print(f"phase {phase} ptxas {tag} {dt} {src} {fn}: "
                      f"{'-' if regs is None else regs} registers, {stack} "
                      f"bytes stack frame, {st} bytes spill stores, {ld} "
                      f"bytes spill loads")
    return info


def static_checks(checks, m64, m32, smi: str, rows: dict, tag: str,
                  phase: int = 25):
    """Hold each specialised kernel against its plain lane version and its
    table twin on the same inputs (float64 max abs error <= TOL64, float32
    relative error <= its twin's TOL32), each call launching its kernel
    alone.  ``checks``: (label, specialised kernel name, float64 args,
    keyword args, operations key, states), as ``check_kernels`` takes
    them.  A kernel's first check gives its row (named kernel name + tag):
    ms (one call with its launch) and graph_ms (graph replay) of the
    float32 kernel, plain_ms (its plain lane version's one call), the
    table twin's ms and graph_ms on the same inputs, and the bound of the
    inputs and outputs alone (the kernel reads no model table).  Fails
    after printing every check."""
    import torch
    from rbdtpu_torch import opcount

    counted = {}
    table = static_table()
    twins = {**STATIC_TWINS, **SOLVER_TWINS}
    failures = []
    fmt = lambda es: "[" + " ".join(f"{e:.2e}" for e in es) + "]"
    for label, kname, a64, kw, ops_key, states in checks:
        ee = kw.get("ee_names")
        if ee not in counted:
            counted[ee] = opcount.per_state(m32, TARGET, ee_names=ee)
        flops = counted[ee]
        kern, plain, twin = table[kname]
        a32 = tuple(a.float() for a in a64)
        kw32 = {k: v.float() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}
        k64 = only_launch(kname, lambda: kern(m64, *a64, **kw))
        e64 = (errors(k64, plain(m64, *a64, **kw), relative=False)
               + errors(k64, twin(m64, *a64, **kw), relative=False))
        k32 = only_launch(kname, lambda: kern(m32, *a32, **kw32))
        p32, plain_ms = timed_call(lambda: plain(m32, *a32, **kw32))
        e32 = (errors(k32, p32, relative=True)
               + errors(k32, twin(m32, *a32, **kw32), relative=True))
        tol32 = TOL32[twins[kname]]
        if max(e64) > TOL64:
            failures.append(f"{label}: float64 max abs error {max(e64):.3e}")
        if max(e32) > tol32:
            failures.append(f"{label}: float32 relative error "
                            f"{max(e32):.3e} > {tol32:g}")
        row = kname + tag
        timing = ""
        if row not in rows:
            fn = lambda: kern(m32, *a32, **kw32)
            tw = lambda: twin(m32, *a32, **kw32)
            ops = flops[ops_key] * states
            bound_ms, bound_by = bound((*a32, *kw32.values()), k32, None,
                                       ops, "float32")
            rows[row] = dict(
                name=row, route="cuda", source=STATIC_SOURCE,
                replaces=kernel_table()[twins[kname]][3],
                max_abs_err=0.0, ms=cuda_ms(fn, reps=20), graph_ms=graph_ms(fn),
                plain_ms=plain_ms, table_ms=cuda_ms(tw, reps=20),
                table_graph_ms=graph_ms(tw), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)
            r = rows[row]
            timing = (f"  kernel {r['ms']:.4f} ms ({r['graph_ms']:.4f} by "
                      f"graph replay), plain lane {plain_ms:.4f} ms, table "
                      f"kernel {r['table_ms']:.4f} ms ({r['table_graph_ms']:.4f}"
                      f" by graph replay), bound {bound_ms:.6f} ms by "
                      f"{bound_by} ({ops:.4g} operations)")
        rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], max(e64[:1]))
        print(f"phase {phase} {label}: inputs "
              f"{' '.join(str(tuple(a.shape)) for a in a64)}  f64 max|err| "
              f"vs plain lane, vs table {fmt(e64)}  f32 rel err {fmt(e32)} "
              f"(bounds {TOL64:g}, {tol32:g}){timing} (f32, {smi})")
    require(not failures, "; ".join(failures))


def static_step_checks(m64, tag: str, B_step: int, B_minv: int, seed: int):
    """Phase 25's step checks on one model in float64: K1 at ``B_step``
    states (bare, under one (nb, 6) wrench set and one a state), K10 (bias,
    with qdd) and K6 (both routes, with and without wrenches) at ``B_minv``
    states, as phases 2 and 6 hold their table twins: q 0.3 N(0,1) (the
    floating root's at configs[3]'s start), qd 0.5 N(0,1), u the gravity
    compensation plus N(0,1), wrenches and qdd 0.5 N(0,1)."""
    import torch
    from rbdtpu_torch.dynamics import rnea

    rng = np.random.default_rng(seed)
    T = lambda s, *sh: torch.tensor(s * rng.standard_normal(sh),
                                    dtype=torch.float64, device=m64.device)

    def step_states(B):
        if m64.floating_base:
            x, _ = quadruped_problems(m64, B, 1, rng)
            q = x[:, :m64.nq].contiguous()
        else:
            q = T(0.3, B, m64.nq)
        z = torch.zeros(B, m64.nv, dtype=torch.float64, device=m64.device)
        u = rnea(m64, q, z, z)[0] + T(1.0, B, m64.nv)
        return torch.cat([q, T(0.5, B, m64.nv)], -1), u

    x, u = step_states(B_step)
    checks = [(f"fd_step_static {tag}{lab} B={B_step}", "fd_step_static",
               (x, u), kw, "fd_step" + ("+fext" if kw else ""), B_step)
              for lab, kw in (("", {}),
                              (" f_ext (nb,6)", {"f_ext": T(0.5, m64.nb, 6)}),
                              (" f_ext (B,nb,6)",
                               {"f_ext": T(0.5, B_step, m64.nb, 6)}))]
    xm, um = step_states(B_minv)
    for label, kname, args, kw, ops_key, states in minv_rnea_checks(
            m64, (xm, um), tag, T(0.5, B_minv, m64.nv),
            (T(0.5, m64.nb, 6), T(0.5, B_minv, m64.nb, 6))):
        checks.append((label.replace(kname, kname + "_static", 1) +
                       f" B={B_minv}", kname + "_static", args, kw, ops_key,
                       states))
    return checks


def path_o(models, smi: str, rows: dict) -> dict:
    """Path O, the model-specialised kernels through the entry points a user
    calls: ``rollout_fused_multi(..., specialize=True)`` at B1 x H1 in
    float32 on arm7 (``rollout_inputs``' distributions: x0 0.1 N(0,1), U
    0.5 N(0,1) on "minv" and 0.2 N(0,1) on "aba", with and without per-knot
    wrenches 0.5 N(0,1)) and on the rpy quadruped (path L's inputs at BL x
    HL: configs[3]'s start, hold controls plus SIGMA_L N(0,1), with and
    without path F's push); then, from the same states, HONEST_H steps of
    ``fd_step_fused`` and ``fd_step_minv_fused`` (both routes) with
    ``specialize=True`` held against the whole-horizon kernel, and the hold
    torques at the final states by ``rnea_fused(..., specialize=True)``.
    With the counts set to 0 just before, the run launches only the
    specialised kernels.  Afterwards (uncounted) each rollout is held to
    its plain lane rollout (``plain_lane_rollout``) and to the table K5
    (TOL32 relative), its final state finite, and timed (median of 7, CUDA events, and by graph replay)
    beside the table K5 on the same inputs.  Returns each model's launches
    in the run."""
    import torch
    from rbdtpu_torch import opcount
    from rbdtpu_torch.kernels import _lib, fused

    runs = []
    for tag, _, m32 in models:
        if m32.floating_base:
            x0, U, F = legged_inputs(m32, quadruped_problems, BL, HL,
                                     SEED + 132)
            cases = [(r, w, U, F if w else None) for r in ("aba", "minv")
                     for w in ("", " push")]
        else:
            rng = np.random.default_rng(SEED + 140)
            T = lambda sc, *s: torch.tensor(
                sc * rng.standard_normal(s), dtype=torch.float32,
                device=m32.device)
            x0 = T(0.1, B1, m32.nx)
            Us = {"minv": T(0.5, H1, B1, m32.nv),
                  "aba": T(0.2, H1, B1, m32.nv)}
            FH = T(0.5, H1, m32.nb, 6)
            cases = [(r, w, Us[r], FH if w else None) for r in ("aba", "minv")
                     for w in ("", " f_ext (H,nb,6)")]
        runs.append((tag, m32, x0, cases))
    torch.cuda.synchronize()
    _lib.reset_launches()
    finals, scans, holds, by_model = {}, {}, {}, {}
    for tag, m32, x0, cases in runs:
        before = dict(_lib.launches)
        for route, w, U, F in cases:
            finals[tag, route, w] = fused.rollout_fused_multi(
                m32, x0, U, DT, GRAVITY, route=route, f_ext=F,
                specialize=True)
        for route, dense in (("aba", False), ("minv", False),
                             ("minv", True)):
            x, U = x0, cases[0 if route == "aba" else 2][2]
            for t in range(HONEST_H):
                x = (fused.fd_step_fused(m32, x, U[t], DT, GRAVITY,
                                         specialize=True) if route == "aba"
                     else fused.fd_step_minv_fused(
                         m32, x, U[t], DT, GRAVITY, dense_minv=dense,
                         specialize=True))
            scans[tag, route, dense] = x
        xf = finals[tag, "aba", ""]
        holds[tag] = fused.rnea_fused(m32, xf[:, :m32.nq].contiguous(),
                                      torch.zeros_like(xf[:, m32.nq:]),
                                      gravity=GRAVITY, specialize=True)
        by_model[tag] = {k: v - before[k] for k, v in _lib.launches.items()}
    torch.cuda.synchronize()
    counts = dict(_lib.launches)
    steps = 3 * HONEST_H * len(runs)
    require({k: v for k, v in counts.items() if v} == {
        "rollout_multi_static": 4 * len(runs),
        "fd_step_static": HONEST_H * len(runs),
        "fd_step_minv_static": 2 * HONEST_H * len(runs),
        "rnea_static": len(runs)}, f"path O launched {counts}")
    print(f"path O launches: {counts} ({steps} step launches of the "
          f"{HONEST_H}-step checks among them)")
    counts = by_model
    for tag, m32, x0, cases in runs:
        B, H = x0.shape[0], cases[0][2].shape[0]
        require(bool(holds[tag].isfinite().all()),
                f"path O {tag}: non-finite hold torques")
        for route, dense in (("aba", False), ("minv", False),
                             ("minv", True)):
            U = cases[0 if route == "aba" else 2][2]
            xk = fused.rollout_fused_multi(m32, x0, U[:HONEST_H].contiguous(),
                                           DT, GRAVITY, route=route,
                                           specialize=True)
            err = errors(scans[tag, route, dense], xk, relative=True)[0]
            print(f"path O {tag} {route}{' dense' if dense else ''}: "
                  f"{HONEST_H} specialised steps against the specialised "
                  f"whole-horizon kernel rel max|err| {err:.3e} (bound "
                  f"{HONEST_TOL:g})")
            require(err < HONEST_TOL, f"path O {tag}: the specialised step "
                    f"and rollout kernels part by {err:.3e}")
        for route, w, U, F in cases:
            xf = finals[tag, route, w]
            require(tuple(xf.shape) == (B, m32.nx) and bool(
                xf.isfinite().all()), f"path O {tag} {route}{w}: final "
                f"state {tuple(xf.shape)} not finite")
            xp, plain_ms = timed_call(lambda: plain_lane_rollout(
                m32, x0, U, route, F))
            xt = fused.rollout_fused_multi(m32, x0, U, DT, GRAVITY,
                                           route=route, f_ext=F)
            ep, et = (errors(xf, xp, relative=True)[0],
                      errors(xf, xt, relative=True)[0])
            fn = lambda: fused.rollout_fused_multi(
                m32, x0, U, DT, GRAVITY, route=route, f_ext=F,
                specialize=True)
            tw = lambda: fused.rollout_fused_multi(
                m32, x0, U, DT, GRAVITY, route=route, f_ext=F)
            ms, tms = cuda_ms(fn, reps=7), cuda_ms(tw, reps=7)
            gms, tgms = graph_ms(fn, reps=5), graph_ms(tw, reps=5)
            print(f"path O {tag} {route}{w}: B={B} H={H} f32 specialised K5 "
                  f"{ms:.4f} ms a rollout (median of 7, CUDA events) = "
                  f"{B * H / (ms / 1e3):.6g} steps/s, device {gms:.4f} ms by "
                  f"graph replay; table K5 {tms:.4f} ms = "
                  f"{B * H / (tms / 1e3):.6g} steps/s, device {tgms:.4f} ms;"
                  f" rel max|err| vs plain lane {ep:.3e}, vs table K5 "
                  f"{et:.3e} (bound {TOL32['rollout_multi']:g}); plain lane "
                  f"{plain_ms:.1f} ms; max|x_H| {xf.abs().max().item():.4g} "
                  f"({smi})")
            require(max(ep, et) <= TOL32["rollout_multi"],
                    f"path O {tag} {route}{w}: the specialised K5 parts from "
                    f"its plain lane version or the table K5 by "
                    f"{max(ep, et):.3e}")
            if (route, w) == ("aba", ""):
                row = rows[f"rollout_multi_static{tag_suffix(tag)}"]
                row.update(ms=ms, graph_ms=gms, plain_ms=plain_ms,
                           table_ms=tms, table_graph_ms=tgms)
                row["bound_ms"], row["bound_by"] = bound(
                    (x0, U), xf, None, opcount.per_state(m32, TARGET)[
                        "fd_step"] * B * H, "float32")
    return counts


def plain_lane_rollout(m, x0, U, route: str, F):
    """``rollout_static_plain``'s result by the same operations, faster: one
    plain lane step (``fd_step_static_plain``, its ~2-6k operators) captured
    in a CUDA graph on fixed buffers and replayed for each of the H steps,
    which spares the host's launch of every operator at every step."""
    import torch
    from rbdtpu_torch.kernels import fused

    x, u = x0.clone(), U[0].clone()
    f = None if F is None else F[0].clone()
    step = lambda: fused.fd_step_static_plain(m, x, u, DT, GRAVITY, f, route)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step()
    for t in range(U.shape[0]):
        u.copy_(U[t])
        if f is not None:
            f.copy_(F[t])
        g.replay()
        x.copy_(out)
    return x


def tag_suffix(tag: str) -> str:
    """A model's suffix of its rows' names in phase 25."""
    return "_" + tag.split()[-1]


def static_phase(smi: str, rows: dict):
    """Phase 25: build the specialised libraries (``static_build``); hold
    K10, K1 and K6 specialised to arm7 and the rpy quadruped against their
    plain lane versions and table twins at phases 2 and 6's shapes (arm7:
    K1 at 128 states, K6 and K10 at B1; the quadruped all three at B3),
    and K5 at HONEST_H steps of path O's inputs, in both dtypes; then path
    O (``path_o``).  Every row's launches come from path O's run."""
    import torch
    from rbdtpu_torch.model import load_asset

    clock = time.perf_counter()

    def took(step: str):
        nonlocal clock
        print(f"phase 25: {step} took {time.perf_counter() - clock:.1f} s")
        clock = time.perf_counter()

    models = [(tag, *(load_asset(name, device="cuda", dtype=dt, **kw)
                      for dt in (torch.float64, torch.float32)))
              for tag, name, kw in (
                  ("arm7", "arm7", {}),
                  ("rpy quadruped", "quadruped12",
                   {"floating_base": True}))]
    # phase 26's kernels (K2, K3 and K4 specialised) build here too, every
    # source at once
    static_build(models, smi, static_ees(models))
    took("the build")
    for (tag, m64, m32), (B_step, B_minv), seed in zip(
            models, ((128, B1), (B3, B3)), (SEED + 141, SEED + 142)):
        checks = static_step_checks(m64, tag, B_step, B_minv, seed)
        rng = np.random.default_rng(seed + 10)
        T = lambda sc, *s: torch.tensor(sc * rng.standard_normal(s),
                                        dtype=torch.float64,
                                        device=m64.device)
        x0 = checks[0][2][0][:64]
        for route in ("aba", "minv"):
            for lab, kw in (("", {}), (" f_ext (H,nb,6)",
                                       {"f_ext": T(0.5, HONEST_H, m64.nb,
                                                   6)})):
                checks.append((f"rollout_multi_static {tag} {route}{lab} "
                               f"B={len(x0)} H={HONEST_H}",
                               "rollout_multi_static",
                               (x0, T(0.2, HONEST_H, len(x0), m64.nv)),
                               {"route": route, **kw},
                               "fd_step" if route == "aba" else
                               "fd_step_minv", len(x0) * HONEST_H))
        static_checks(checks, m64, m32, smi, rows, tag_suffix(tag))
    took("the kernel checks")
    counts = path_o(models, smi, rows)
    took("path O")
    for tag, _, _ in models:
        for kname in STATIC_TWINS:
            rows[kname + tag_suffix(tag)]["launches"] = counts[tag][kname]


# ---- phase 26: paths P and Q, the DDP solve on the model-specialised
# kernels ----
# each specialised solver kernel (K2, K3 and K4 through K0) and its table
# twin
SOLVER_TWINS = {"feedback_rollout_static": "feedback_rollout",
                "linearize_parts_static": "linearize_parts",
                "ee_gn_static": "ee_gn", "ee_err_static": "ee_err"}
# the sources of phase 26's kernels in the specialised libraries
SOLVER_SOURCES = ("feedback.cu", "feedback_fext.cu", "linearize.cu",
                  "ee_gn.cu", "ee_err.cu")
# the table kernels of K1-K4 that a specialised solve must not launch
TABLE_SOLVER = ("fd_step", "feedback_rollout", "feedback_rollout_fext",
                "linearize_parts", "ee_gn", "ee_err", "feedback_chunked",
                "feedback_chunked_fext")
# the float64 parities of paths P and Q: problems, knots; the knots of
# arm7's clamped line-search checks
PARITY_PQ, CLAMP_H = (4, 20), 20


def plain_lane_feedback(m, x0, Xn, Un, kf, K, u_clip=None, f_ext=None):
    """``feedback_rollout_static_plain``'s result by the same operations,
    faster: one knot of ``feedback_lane`` on (B,) tensors (its ~2.4-7k
    operators) captured in a CUDA graph on fixed buffers and replayed for
    each of the H knots."""
    import torch
    from rbdtpu_torch.kernels import fused

    ms = fused.get_static(m)
    B, H = Un.shape[:2]
    x = x0.clone()
    xt, ut, kt = Xn[:, 0].clone(), Un[:, 0].clone(), kf[:, 0].clone()
    Kt = K[:, 0].reshape(B, -1).clone()
    fe = None if f_ext is None else f_ext[0].clone()
    uc = None if u_clip is None else list(u_clip.unbind(0))
    L = fused._lanes

    def knot():
        q_new, qd_new, u = fused.feedback_lane(
            ms, L(x), L(xt), L(ut), L(kt), L(Kt), DT, GRAVITY, uc,
            None if fe is None else fused._fext_lanes(ms, fe, B))
        return fused._stack(list(q_new) + list(qd_new), x), fused._stack(u, x)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        knot()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        xo, uo = knot()
    Xs, Us = torch.empty_like(Xn), torch.empty_like(Un)
    for t in range(H):
        xt.copy_(Xn[:, t])
        ut.copy_(Un[:, t])
        kt.copy_(kf[:, t])
        Kt.copy_(K[:, t].reshape(B, -1))
        if fe is not None:
            fe.copy_(f_ext[t])
        g.replay()
        Xs[:, t].copy_(xo)
        Us[:, t].copy_(uo)
        x.copy_(xo)
    return Xs, Us


def solver_static_checks(models, smi: str, rows: dict):
    """Phase 26's kernel checks, each specialised kernel against its plain
    lane version and its table twin at the table rows' shapes (float64 <=
    TOL64, float32 the twin's bound; ``static_checks``): K2 at 1,024 x 100
    (arm7, ``kernel_inputs``' stabilising gains) and ALPHAS3 * B3 x H3
    (the quadruped, ``quadruped_kernel_inputs``), bare, then with a clamp
    at 0.8 of each joint's largest unclamped control (arm7 over CLAMP_H
    knots), and with that clamp under 0.5 N(0,1) per-knot wrenches; K3 at 12,800 and B3 * H3 knots; K4 on
    arm7's effector (``ee_gn`` at 12,800 and 128 states, ``ee_err`` at
    102,400 and 1,024) and on the quadruped's FL_knee at path E's 51,200
    and 307,200 states (``foot_kernels``' configurations)."""
    import torch
    from rbdtpu_torch.kernels import fused

    for tag, m64, m32 in models:
        if m64.floating_base:
            inp = quadruped_kernel_inputs(m64, np.random.default_rng(
                SEED + 151))
            rng = np.random.default_rng(SEED + 152)

            def qs(B):
                x0, _ = quadruped_problems(m64, B, 1, rng)
                q = x0[:, :m64.nq]
                return (q + torch.tensor(0.1 * rng.standard_normal(q.shape),
                                         dtype=q.dtype, device=q.device)
                        ).contiguous()

            ee = {"target": TARGET_E, "ee_names": foot_ee(m64)}
            ees = [("ee_gn_static", qs(B3 * H3)),
                   ("ee_err_static", qs(ALPHAS3 * B3 * H3))]
        else:
            inp = kernel_inputs(m64, np.random.default_rng(SEED + 150))
            ee = {"target": TARGET}
            (q_gn,), (q_err,) = inp["ee_gn"], inp["ee_err"]
            ees = [("ee_gn_static", q_gn), ("ee_gn_static", q_gn[:128]),
                   ("ee_err_static", q_err), ("ee_err_static", q_err[:1024])]
        fb = inp["feedback_rollout"]
        B, H = fb[2].shape[:2]
        checks = [(f"feedback_rollout_static {tag} B={B} H={H}",
                   "feedback_rollout_static", fb, {}, "feedback_rollout",
                   B * H)]
        # the clamp at 0.8 of each joint's largest unclamped control (1 N m
        # at least: arm7's joints 0 and 6 carry no gravity load), over
        # CLAMP_H knots on arm7, whose stiff clamped loop parts float32
        # from float64 over 100
        Hc = H if m64.floating_base else CLAMP_H
        fbc = tuple(a[:, :Hc].contiguous() if a.dim() > 2 else a
                    for a in fb)
        applied = fused.feedback_rollout_fused(m64, *fbc, DT, GRAVITY)[1]
        clip = (0.8 * applied.abs().amax((0, 1))).clamp(min=1.0)
        F = push_wrenches(m64, Hc, 0.5, SEED + 153, newtons=0.0)
        checks += [(f"feedback_rollout_static {tag}{lab} B={B} H={Hc}",
                    "feedback_rollout_static", fbc, kw,
                    "feedback_rollout" + ("+fext" if "f_ext" in kw else ""),
                    B * Hc)
                   for lab, kw in ((" clip", {"u_clip": clip.contiguous()}),
                                   (" clip f_ext (H,nb,6)",
                                    {"u_clip": clip.contiguous(),
                                     "f_ext": F}))]
        lin = inp["linearize_parts"]
        checks.append((f"linearize_parts_static {tag} B={len(lin[0])}",
                       "linearize_parts_static", lin, {}, "linearize_parts",
                       len(lin[0])))
        checks += [(f"{k} {tag} B={len(q)}", k, (q,), ee,
                    k[:-len("_static")], len(q)) for k, q in ees]
        static_checks(checks, m64, m32, smi, rows, tag_suffix(tag), phase=26)


def static_solve_path(label: str, spec, table, J0, per_solve: dict,
                      iters: int, Bm: int, smi: str) -> dict:
    """One specialised solve path in float32: a warm-up solve, then three
    timed ones (``spec``, CUDA events) with the counts set to 0 just
    before; each kernel of ``per_solve`` launched that many times a solve,
    no table kernel of K1-K4 (TABLE_SOLVER) and no plain sweep; J finite,
    nonincreasing from J0 (the specialised route's own starting cost) and
    falling on the mean.  Then the table route (``table``) timed the same
    way in the same run, and the specialised solve's profile (device time
    by kernel).  Returns the counts of the three specialised solves."""
    import torch
    from rbdtpu_torch.kernels import _lib
    from rbdtpu_torch.solver import ddp

    spec()
    torch.cuda.synchronize()
    plain_sweeps = []
    plain = ddp.backward_pass
    ddp.backward_pass = lambda *a, **kw: plain_sweeps.append(1) or plain(
        *a, **kw)
    _lib.reset_launches()
    try:
        (state, J_hist), times = timed_runs(spec, warm=False)
    finally:
        ddp.backward_pass = plain
    counts = dict(_lib.launches)
    print(f"{label} launches (3 solves): "
          f"{ {k: v for k, v in counts.items() if v} }; plain sweeps "
          f"{len(plain_sweeps)}")
    for k, v in per_solve.items():
        require(counts[k] == 3 * v if v else counts[k] > 0,
                f"{label}: {k} launched {counts[k]} times in 3 solves, "
                f"expected {3 * v if v else 'some'}")
    table_runs = {k: counts[k] for k in TABLE_SOLVER if counts[k]}
    require(not table_runs, f"{label}: table kernels launched {table_runs}")
    require(tuple(J_hist.shape) == (iters, Bm), f"J_hist {J_hist.shape}")
    require(bool(J_hist.isfinite().all()), f"{label}: non-finite J")
    require(bool((J_hist[1:] <= J_hist[:-1]).all()) and bool(
        (J_hist[0] <= J0 * (1 + 1e-6)).all()), f"{label}: J increased")
    require(J_hist[-1].mean() < J0.mean(), f"{label}: mean J did not fall")
    _, table_times = timed_runs(table)
    sec, tsec = statistics.median(times), statistics.median(table_times)
    print(f"{label}: Bm={Bm} iters={iters} f32 specialised: mean J "
          f"{J0.mean().item():.6g} -> {J_hist[-1].mean().item():.6g}; solve "
          f"{sec * 1e3:.1f} ms (median of 3: "
          f"{' '.join(f'{t * 1e3:.1f}' for t in times)}, CUDA events) = "
          f"{Bm / sec:.1f} solves/s; table route {tsec * 1e3:.1f} ms (median "
          f"of 3: {' '.join(f'{t * 1e3:.1f}' for t in table_times)}) on "
          f"{smi}")
    profile_main_path(spec, cpu=False)
    return counts


def path_p(m32, smi: str) -> dict:
    """Path P: configs[2] (the main path's problems, Bm=128, H=100, 10
    iterations, 8 steps, float32) through ``ddp_solve`` with
    ``DDPConfig(fused=True, specialize=True)`` and
    ``ee_reaching_cost(specialize=True)``: K1·K0 100 times a solve, K2·K0
    and K3·K0 once an iteration, K4·K0 (``ee_gn_static``,
    ``ee_err_static``) every quadratisation and cost, the table K1-K4
    never; beside the table route (``DDPConfig(fused=True)``)."""
    from rbdtpu_torch.kernels.fused import fd_step_fused
    from rbdtpu_torch.solver import ee_reaching_cost, trajectory_cost
    import torch

    Bm, H, iters = 128, 100, 10
    x0, U0 = start_problems(m32, Bm, H, np.random.default_rng(SEED + 1))
    xs = [x0]
    for t in range(H):
        xs.append(fd_step_fused(m32, xs[-1], U0[:, t].contiguous(), DT,
                                GRAVITY, specialize=True))
    J0 = trajectory_cost(ee_reaching_cost(m32, TARGET, specialize=True,
                                          **WEIGHTS),
                         torch.stack(xs, dim=-2), U0)
    return static_solve_path(
        "path P", lambda: solve(m32, x0, U0, True, iters, specialize=True),
        lambda: solve(m32, x0, U0, True, iters), J0,
        {"fd_step_static": H, "feedback_rollout_static": iters,
         "linearize_parts_static": iters, "ee_gn_static": 0,
         "ee_err_static": 0}, iters, Bm, smi)


def path_q(q32, smi: str) -> dict:
    """Path Q: configs[3] (B3 rpy quadrupeds, H3 knots, ITERS3 iterations,
    ALPHAS3 steps, float32) with ``specialize=True``: K1·K0 H3 times a
    solve, K2·K0, K3·K0 and the table K7 once an iteration, the table
    K1-K3 never; beside the table route."""
    from rbdtpu_torch.kernels.fused import fd_step_fused
    from rbdtpu_torch.solver import trajectory_cost
    import torch

    x0, U0 = quadruped_problems(q32, B3, H3, np.random.default_rng(SEED + 30))
    xs = [x0]
    for t in range(H3):
        xs.append(fd_step_fused(q32, xs[-1], U0[:, t].contiguous(), DT,
                                GRAVITY, specialize=True))
    J0 = trajectory_cost(quadruped_cost(q32), torch.stack(xs, dim=-2), U0)
    return static_solve_path(
        "path Q", lambda: quadruped_solve(q32, x0, U0, ITERS3, True,
                                          specialize=True),
        lambda: quadruped_solve(q32, x0, U0, ITERS3, True), J0,
        {"fd_step_static": H3, "feedback_rollout_static": ITERS3,
         "linearize_parts_static": ITERS3, "riccati_chunk": ITERS3},
        ITERS3, B3, smi)


def static_parity(label: str, spec, plain, table):
    """Float64: the specialised solve against the plain route and the table
    route on the same problems, max |dU| < U_PARITY each."""
    sk, _ = spec()
    for route, fn in (("plain", plain), ("table", table)):
        so, _ = fn()
        du = (sk.U - so.U).abs().max().item()
        dj = ((sk.J - so.J).abs() / so.J.abs().clamp(min=1)).max().item()
        print(f"{label} parity f64 Bm={PARITY_PQ[0]} H={PARITY_PQ[1]}: "
              f"max|U_specialised - U_{route}| {du:.3e} (bound "
              f"{U_PARITY:g}); max rel |dJ| {dj:.3e}")
        require(du < U_PARITY, f"{label}: specialised against {route} "
                f"route {du:.3e} >= {U_PARITY:g}")


def solver_static_phase(smi: str, rows: dict):
    """Phase 26: the specialised K2, K3 and K4 (built with phase 25's
    libraries, or here when run alone; their sources' build seconds and
    ptxas lines printed) held against their plain lane versions and table
    twins (``solver_static_checks``); path P (``path_p``) and path Q
    (``path_q``), each with its float64 parity at PARITY_PQ (configs[2]
    ITERS of the main path, configs[3] ITERS3).  Every new row's launches
    come from path P (arm7) or path Q (the quadruped; its effector kernels
    run on no path)."""
    import torch
    from rbdtpu_torch.model import load_asset

    clock = time.perf_counter()

    def took(step: str):
        nonlocal clock
        print(f"phase 26: {step} took {time.perf_counter() - clock:.1f} s")
        clock = time.perf_counter()

    models = [(tag, *(load_asset(name, device="cuda", dtype=dt, **kw)
                      for dt in (torch.float64, torch.float32)))
              for tag, name, kw in (
                  ("arm7", "arm7", {}),
                  ("rpy quadruped", "quadruped12",
                   {"floating_base": True}))]
    static_build(models, smi, static_ees(models), phase=26,
                 sources=SOLVER_SOURCES)
    took("the build")
    solver_static_checks(models, smi, rows)
    took("the kernel checks")
    (_, a64, a32), (_, q64, q32) = models
    counts = {"arm7": path_p(a32, smi)}
    took("path P")
    x0, U0 = start_problems(a64, *PARITY_PQ, np.random.default_rng(SEED + 2))
    static_parity(
        "path P", lambda: solve(a64, x0, U0, True, 10, specialize=True),
        lambda: solve(a64, x0, U0, False, 10),
        lambda: solve(a64, x0, U0, True, 10))
    took("path P's parity")
    counts["rpy quadruped"] = path_q(q32, smi)
    took("path Q")
    x0, U0 = quadruped_problems(q64, *PARITY_PQ,
                                np.random.default_rng(SEED + 40))
    static_parity(
        "path Q", lambda: quadruped_solve(q64, x0, U0, ITERS3, True,
                                          specialize=True),
        lambda: quadruped_solve(q64, x0, U0, ITERS3, False),
        lambda: quadruped_solve(q64, x0, U0, ITERS3, True))
    took("path Q's parity")
    for tag, _, _ in models:
        for kname in SOLVER_TWINS:
            rows[kname + tag_suffix(tag)]["launches"] = counts[tag][kname]


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
    # the default solve's ~60k operators: a trace of the CUDA activity
    # alone (a CPU trace takes about a minute)
    profile_main_path(lambda: solve(m32, x0, U0, fused=True, iters=iters),
                      cpu=False)

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
    counts = hybrid_path(h32, smi)[0]
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

    mark(20)
    # ---- 20. paths G and H: the quaternion root, K1-K4 at fq32 ----
    quat_phase(smi, rows, ptxas)

    mark(21)
    # ---- 21. second order: IDSVA-SO, path I (full DDP), the IDSVA cells --
    t21 = time.perf_counter()
    second_order_phase(smi)
    print(f"chip_smoke: phase 21 took {time.perf_counter() - t21:.1f} s")

    mark(22)
    # ---- 22. paths J and K: K9, K2/K9 with wrenches, K6 and K10 at fq32 --
    t22 = time.perf_counter()
    quat_ext_phase(smi, rows, ptxas)
    print(f"chip_smoke: phase 22 took {time.perf_counter() - t22:.1f} s")

    mark(23)
    # ---- 23. paths L and M: K5 at fb16, fb32 and fq32, K4 at fb32 ----
    t23 = time.perf_counter()
    gaps_phase(smi, rows, ptxas)
    print(f"chip_smoke: phase 23 took {time.perf_counter() - t23:.1f} s")

    mark(24)
    # ---- 24. path N: the sharded fleet (distrib, compat) ----
    t24 = time.perf_counter()
    sharded_phase(smi)
    print(f"chip_smoke: phase 24 took {time.perf_counter() - t24:.1f} s")

    mark(25)
    # ---- 25. path O: the model-specialised kernels (K0) ----
    t25 = time.perf_counter()
    static_phase(smi, rows)
    print(f"chip_smoke: phase 25 took {time.perf_counter() - t25:.1f} s")

    mark(26)
    # ---- 26. paths P and Q: the solve on the model-specialised kernels ----
    t26 = time.perf_counter()
    solver_static_phase(smi, rows)
    print(f"chip_smoke: phase 26 took {time.perf_counter() - t26:.1f} s")

    print(f"chip_smoke: phases 1-26 took {time.perf_counter() - clock:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        {k: rows[n_][k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "graph_ms", "table_ms", "table_graph_ms") if k in rows[n_]}
        for n_ in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
