"""Build, load and feed the CUDA kernels in ``rbdtpu_torch/csrc``.

Each ``.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into an object,
all of them at once in parallel, and the objects are linked into ONE shared
library with a plain C interface, loaded with ctypes.  The build happens on
first use, from the sources in the package only, into ``rbdtpu_torch/_build``
(named by a hash of the sources and flags, so an edited source rebuilds).

Every C entry point returns the ``cudaError_t`` of its launch; ``launch``
raises on a nonzero code and only then counts the launch in ``launches``.

The model-specialised kernels (K0, ``specialize=True``) are generated per
model, dtype and gravity (``kernels/codegen.py``) and built by
``model_library`` the same way into a library of their own under
``rbdtpu_torch/_build/models/<hash of the sources and flags>/``;
``launch_static`` launches them.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")
# per-body table stride; equals rbd::STRIDE (E 9, r 3, axis 3, I 36, S 6,
# Ttree rotation 9, Ttree translation 3)
STRIDE = 69
# The tree kernels are compiled once per size class (rbd_common.cuh: Dims),
# each with its own compile-time bound on bodies: fixed-base trees of up to
# 8 bodies ("n8"), rpy floating-base trees of up to 16 ("fb16", the
# quadruped) and up to 32 ("fb32", the humanoid).  A class lists the kernels
# instantiated for it; C symbols are rbd_<kernel>_<class>_<f32|f64>.
# ``size_class`` takes the smallest class that fits.  K2 and K9 with world
# wrenches are kernels of their own (``feedback_rollout_fext``,
# ``feedback_chunked_fext``), beside the wrench-free ones.  The quaternion
# root has classes of its own (QUAT_CLASSES: "fq32", trees of up to 32
# bodies, the humanoid and the quadruped), whose q has one coordinate more
# than its tangent (nq = nv + 1); CLASSES holds every class.  Every class
# instantiates every tree kernel.
FEEDBACK_KERNELS = ("feedback_rollout", "feedback_chunked",
                    "feedback_rollout_fext", "feedback_chunked_fext")
SIZE_CLASSES = {
    "n8": (8, False, ("fd_step", "feedback_rollout", "linearize_parts",
                      "ee_gn", "ee_err", "rnea", "fd_step_minv",
                      "rollout_multi", "feedback_chunked",
                      "feedback_rollout_fext", "feedback_chunked_fext")),
    "fb16": (16, True, ("fd_step", "feedback_rollout", "linearize_parts",
                        "feedback_chunked", "rnea", "fd_step_minv",
                        "ee_gn", "ee_err", "feedback_rollout_fext",
                        "feedback_chunked_fext", "rollout_multi")),
    "fb32": (32, True, ("fd_step", "feedback_rollout", "linearize_parts",
                        "feedback_chunked", "rnea", "fd_step_minv",
                        "feedback_rollout_fext", "feedback_chunked_fext",
                        "ee_gn", "ee_err", "rollout_multi")),
}
QUAT_CLASSES = {
    "fq32": (32, True, ("fd_step", "feedback_rollout", "linearize_parts",
                        "ee_gn", "ee_err", "feedback_chunked",
                        "feedback_rollout_fext", "feedback_chunked_fext",
                        "fd_step_minv", "rnea", "rollout_multi")),
}
CLASSES = {**SIZE_CLASSES, **QUAT_CLASSES}


def class_dims(cls: str):
    """(bodies, nv, nq) at size class ``cls``'s bound: a floating root's
    six DoFs make nv = NB + 5, the quaternion root's q nv + 1."""
    nb, fb, _ = CLASSES[cls]
    nv = nb + 5 if fb else nb
    return nb, nv, nv + (cls in QUAT_CLASSES)


# Lanes a team of the team kernels (csrc/rbd_team.cuh: one team of one warp
# runs one state's step in fd_step and fd_step_minv, its RNEA in rnea, one
# trajectory in feedback_rollout, feedback_chunked and rollout_multi, one
# knot's linearisation in linearize_parts), per kernel, size class and
# dtype, fixed from their times on an H100 at each class's path shapes
# (PERF.md §6, tools/time_step_kernels.py --sweep).  The build compiles each
# kernel at this size alone (``team_defines``).
TEAM = {(k, cls, sfx): 32 for k in ("fd_step", "linearize_parts",
                                     *FEEDBACK_KERNELS)
        for cls in ("n8", "fb16", "fb32") for sfx in ("f32", "f64")}
# K5: on the floating roots the fastest over path L's four rollouts at
# 4096 x 50 (both routes, with and without the push)
TEAM.update({("rollout_multi", "n8", "f32"): 16,
             ("rollout_multi", "n8", "f64"): 32,
             ("rollout_multi", "fb16", "f32"): 32,
             ("rollout_multi", "fb16", "f64"): 16,
             ("rollout_multi", "fb32", "f32"): 32,
             ("rollout_multi", "fb32", "f64"): 32,
             ("rollout_multi", "fq32", "f32"): 32,
             ("rollout_multi", "fq32", "f64"): 32})
TEAM[("fd_step", "fb32", "f32")] = 16
# the quaternion root's K1, K2, K9 and K2/K9 with wrenches, as the
# humanoid's rpy class (fb32)
TEAM.update({(k, "fq32", sfx): TEAM[(k, "fb32", sfx)]
             for k in ("fd_step", *FEEDBACK_KERNELS) for sfx in ("f32", "f64")})
# K6's by its factorised route, K5's step (the dense route, off the paths,
# would take 8 lanes on n8 and 16 on fb32: PERF.md §6)
TEAM.update({("rnea", "n8", "f32"): 16, ("rnea", "n8", "f64"): 16,
             ("rnea", "fb16", "f32"): 32, ("rnea", "fb16", "f64"): 32,
             ("rnea", "fb32", "f32"): 16, ("rnea", "fb32", "f64"): 32,
             ("fd_step_minv", "n8", "f32"): 16,
             ("fd_step_minv", "n8", "f64"): 16,
             ("fd_step_minv", "fb16", "f32"): 32,
             ("fd_step_minv", "fb16", "f64"): 32,
             ("fd_step_minv", "fb32", "f32"): 8,
             ("fd_step_minv", "fb32", "f64"): 32,
             ("rnea", "fq32", "f32"): 16, ("rnea", "fq32", "f64"): 32,
             ("fd_step_minv", "fq32", "f32"): 8,
             ("fd_step_minv", "fq32", "f64"): 32})
TEAM.update({("linearize_parts", "n8", "f32"): 8,
             ("linearize_parts", "n8", "f64"): 8,
             ("linearize_parts", "fb16", "f32"): 8,
             ("linearize_parts", "fb16", "f64"): 16,
             ("linearize_parts", "fb32", "f32"): 16,
             ("linearize_parts", "fb32", "f64"): 16,
             ("linearize_parts", "fq32", "f32"): 16,
             ("linearize_parts", "fq32", "f64"): 16})
# the team sizes rbd_team.cuh takes
TEAM_SIZES = (8, 16, 32)
# shared memory a block may take on an H100 (above 48 KB by opt-in)
SMEM_MAX = 232448
# streaming multiprocessors of an H100 SXM, the default of team_geometry
H100_SMS = 132


def team_values(kernel: str, cls: str, team: int, dense: bool = False) -> int:
    """Shared-memory values one team of ``kernel`` takes in size class
    ``cls``: the step's scratch (rbd_team.cuh TeamLayout: per body the
    compact transform, 12, and the dense transform's lower-left block, 9;
    v, c, pA, U and S, 6 each; IA, 36; 1 / d, u and the parent; then one
    body's (IA - U U^T / d) X and bias force and 12 partial sums, 54, and
    qdd), fd_step's, fd_step_minv's and rollout_multi's with the wrenches'
    chain (12 a body) and two buffers of U.a partial sums,
    feedback_rollout's with the level order (2 nb + 2) and each body's U.a
    partial sums; then the kernel's own values (fd_step: x and u;
    fd_step_minv: x, u and u - c, and with ``dense`` the rpy root's 6x6
    inverse, the M^-1 columns' slots, 6 a tree level (LIN_LEVELS) a lane,
    and M^-1 with rows of nv + 1; rollout_multi: x, two stages of u and of
    the wrench set, u - c; feedback_rollout and feedback_chunked, which
    share one team body: x, dx, u and the knot buffer, K with rows of
    nx + 1; their _fext twins keep the wrenches' chain in IA's values, so
    they take as much); rnea's is its
    own (rnea.cu RneaLayout: transform, lower-left block, v, a, I v, f, S
    and the parent, 52 a body; then q, qd and qdd).  On the quaternion root
    x is one value wider (nq = nv + 1): fd_step's, fd_step_minv's and
    rollout_multi's x, the line search's x and nominal, and rnea's q.  Rounded up to 32 and offset by ``team`` % 32 as the
    sources pad them.  The launch refuses any other count (with
    ``block_values`` ahead of the teams)."""
    nb, fb, kernels = CLASSES[cls]
    if kernel not in kernels:
        raise ValueError(f"{kernel} has no instantiation in class {cls}")
    _, nv, nq = class_dims(cls)
    values = 90 * nb + 54 + nv
    if kernel == "rnea":
        values = 52 * nb + nq + 2 * nv
    elif kernel == "fd_step":
        values += 12 * nb + 12 + 2 * nv + nq
    elif kernel == "fd_step_minv":
        values += 12 * nb + 12 + nq + 3 * nv
        if dense:
            values += 36 + 6 * LIN_LEVELS[cls] * team + nv * (nv + 1)
    elif kernel == "rollout_multi":
        values += 12 * nb + 12 + nq + 4 * nv + 12 * nb
    elif kernel in FEEDBACK_KERNELS:
        values += 8 * nb + 2 + 7 * nv + 2 * nq + nv * (2 * nv + 1)
    else:
        raise ValueError(f"{kernel} is not a team kernel")
    return -(-values // 32) * 32 + team % 32


def block_values(kernel: str, cls: str) -> int:
    """Shared-memory values a block of ``kernel`` keeps ahead of its teams:
    for the line-search kernels with wrenches two stages of a knot's wrench
    set, 6 values a body of the class each, rounded up to 32
    (csrc/feedback_team.cuh feedback_wrench_values); none for the others."""
    if not kernel.endswith("_fext"):
        return 0
    return -(-12 * CLASSES[cls][0] // 32) * 32


# The most tree levels linearize_parts and fd_step_minv take per size
# class: their column sweeps (K3's derivatives and M^-1, K6's dense M^-1)
# keep one slot a level (csrc/rbd_team.cuh lin_levels).
LIN_LEVELS = {"n8": 8, "fb16": 8, "fb32": 12, "fq32": 12}
LEVEL_KERNELS = ("linearize_parts", "fd_step_minv")


def linearize_values(cls: str, team: int) -> int:
    """Shared-memory values of one team of linearize_parts in size class
    ``cls`` (csrc/linearize.cu LinLayout STRIDE): what the columns read of
    the ABA step (31 a body and qdd), I v and the RNEA forces (12 a body),
    the root's 6x6 inverse, q (nq), qd and u, the walk's path (a level a
    lane), then one region for the team step's scratch (96 a body, 66 and
    qdd) that the columns' slots (18 a level a lane, M^-1 among them)
    reuse; rounded up to 32 and offset by ``team`` % 32 so the teams of a
    warp start on different banks; M^-1 (rows of nv + 1) sits beside the
    M^-1 columns' slots where it fits, else after the region.  The launch
    refuses any other count."""
    nb, nv, nq = class_dims(cls)
    levels = LIN_LEVELS[cls]
    minv = nv * (nv + 1)  # M^-1, beside the slots where it fits
    values = (31 * nb + nv + 12 * nb + 36 + nq + 2 * nv + levels * team
              + max(96 * nb + 66 + nv, 18 * levels * team)
              + (0 if 12 * levels * team >= minv else minv))
    return -(-values // 32) * 32 + team % 32


def linearize_geometry(cls: str, dtype, B: int, nsm: int = H100_SMS):
    """(team, teams a block, shared bytes a block, blocks) of a
    linearize_parts launch over B knots: one team a knot, at most one warp
    of teams a block within SMEM_MAX, halved while the batch would leave
    SMs without a block."""
    team = TEAM[("linearize_parts", cls, _SUFFIX[dtype])]
    per = linearize_values(cls, team) * torch.finfo(dtype).bits // 8
    tpb = min(32 // team, SMEM_MAX // per)
    while tpb > 1 and -(-B // tpb) < nsm:
        tpb //= 2
    return team, tpb, tpb * per, -(-B // tpb)


def riccati_values(nx: int, nu: int) -> int:
    """Shared-memory values of the Riccati sweep (csrc/riccati_chunk.cu
    riccati_layout): the carry Vxx (rows padded to four), Vx, Qx, [A | B],
    the products' region (n x (n + m), or R, the elimination's entries and
    T, Z and [K | k] if larger), [Qux | Qu], Quu, the pivots and a flag."""
    up4 = lambda x: -(-x // 4) * 4
    n, m = nx, nu
    ldv, ldab, ldq, ldm = up4(n), up4(n + m), up4(n + 1), up4(m)
    after = up4(m) * ldm + max(m * ldm, m * ldq) + m * ldq
    return (n * ldv + 2 * up4(n) + n * ldab + max(n * ldab, after)
            + m * ldq + up4(m) * ldm + up4(m) + 4)


# threads a block of the Riccati sweeps: at least two warps, at most 256
# (csrc/riccati_chunk.cu RBD_RIC_THREADS, csrc/riccati_fused.cu
# RBD_K11_THREADS), the registers a thread both kernels' launch bounds
# allow, and the elimination entries a thread of the chunked sweep keeps in
# registers (riccati_chunk.cu TRI)
RIC_THREADS = (64, 256)
RIC_REGS = 128
RIC_TRI = 8
# shared memory of an SM on an H100, and what the driver keeps of it a block
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024


def riccati_geometry(nx: int, nu: int, dtype, B: int, nsm: int = H100_SMS):
    """(threads a block, shared bytes a block, blocks) of a Riccati sweep
    over B problems, one block each, on a card with ``nsm`` SMs.  A sweep's
    time is the chain of its knots, so a block takes the most threads (up
    to one a tile of its largest product, in whole warps) that still leave
    the launch as few waves as any count: configs[3]'s 1024 problems take
    64 threads, eight blocks an SM, one wave; path D's 256 humanoid problems
    256 threads, two blocks an SM."""
    t4 = lambda x: -(-x // 4)
    up32 = lambda x: -(-x // 32) * 32
    tri = nu * (nu + 1) // 2
    work = max(t4(nx) * t4(nx + nu), t4(nu) * t4(nx + 1), -(-tri // RIC_TRI))
    lo = max(RIC_THREADS[0], up32(-(-tri // RIC_TRI)))
    hi = max(lo, min(RIC_THREADS[1], up32(work)))
    smem = riccati_values(nx, nu) * torch.finfo(dtype).bits // 8
    return _fewest_waves(lo, hi, smem, B, nsm), smem, B


def _fewest_waves(lo: int, hi: int, smem: int, B: int, nsm: int) -> int:
    """The most threads a block, in whole warps from hi down to lo, that
    leave B blocks of ``smem`` shared bytes (at most RIC_REGS registers a
    thread) in as few waves over ``nsm`` SMs as any count."""
    def waves(nt):
        per_sm = min(65536 // (RIC_REGS * nt),
                     SM_SMEM // (smem + BLOCK_SMEM_RESERVED), 2048 // nt, 32)
        return -(-B // (nsm * max(per_sm, 1)))

    return min(range(hi, lo - 1, -32), key=lambda t: (waves(t), -t))


def riccati_fused_values(nx: int, nu: int) -> int:
    """Shared-memory values of the arm-class sweep K11
    (csrc/riccati_fused.cu k11::layout): two stage buffers of a knot's A,
    B, lx, lu, lxx, luu and lux, each padded to four values; Vxx with Vx as its last row; [P | Pb] with
    [Qx | Qu] as its last row; Qux, Qu, Quu; the augmented system
    [Quu + reg I | Qux | Qu]; the pivots' inverses; [K | k] and Z; the
    entry tables of its first, second and fourth phase, one slot an
    entry."""
    n, m = nx, nu
    up4 = lambda x: -(-x // 4) * 4
    stage = sum(up4(v) for v in (n * n, n * m, n, m, n * n, m * m, m * n))
    return (2 * stage + n * n + n + 2 * (n + 1) * (n + m) + m * n + m + m * m
            + m * (m + n + 1) + m + 2 * m * (n + 1)
            + n * n + m * n + m * (m + 1) // 2 + n * (n + 1) // 2 + n)


def riccati_fused_geometry(nx: int, nu: int, dtype, B: int,
                           nsm: int = H100_SMS):
    """(threads a block, shared bytes a block, blocks) of a K11 sweep over
    B problems, one block each, on a card with ``nsm`` SMs.  A sweep's time
    is its knots' chain of phases, each one dot product a thread at one
    entry a thread, so a block takes the most threads (up to one an entry
    of its largest phase, in whole warps) that still leave the launch as
    few waves as any count: configs[2]'s 128 problems, the MPC tick's one
    and the parity cases' four take 256."""
    up32 = lambda x: -(-x // 32) * 32
    work = max((nx + 1) * (nx + nu), nx * nx + nu * nx + nu * (nu + 1) // 2)
    lo = RIC_THREADS[0]
    hi = max(lo, min(RIC_THREADS[1], up32(work)))
    smem = riccati_fused_values(nx, nu) * torch.finfo(dtype).bits // 8
    return _fewest_waves(lo, hi, smem, B, nsm), smem, B


def team_geometry(kernel: str, cls: str, dtype, B: int, nsm: int = H100_SMS,
                  dense: bool = False):
    """(team, teams a block, shared bytes a block, blocks) of a launch of
    ``kernel`` over B states or trajectories on a card with ``nsm`` SMs (for
    fd_step_minv on the route ``dense`` picks): the team size of TEAM, at
    most one warp of teams a block within SMEM_MAX (after the block's own
    ``block_values``), halved while the batch would leave SMs without a
    block."""
    team = TEAM[(kernel, cls, _SUFFIX[dtype])]
    size = torch.finfo(dtype).bits // 8
    per = team_values(kernel, cls, team, dense) * size
    extra = block_values(kernel, cls) * size
    tpb = min(32 // team, (SMEM_MAX - extra) // per)
    while tpb > 1 and -(-B // tpb) < nsm:
        tpb //= 2
    return team, tpb, tpb * per + extra, -(-B // tpb)


# The end-effector kernels' blocks (csrc/ee_gn.cu): ee_gn runs a team of 8
# lanes a state (on the fixed base one lane a column of J, four states a
# warp; on a floating root lane c columns c + 8 s), ee_err one thread a
# state; per kernel the lanes a state and the most and fewest states a
# block (n8; a floating root's ee_gn: EE_STATES_RPY).  A block's shared
# memory stays within EE_SMEM_MAX (no opt-in) on n8 and fb16; the
# quaternion root's fq32, whose H0 rows of 37 values take 4 states past it
# in double, opts in up to SMEM_MAX (EE_SMEM).
EE_LANES = {"ee_gn": 8, "ee_err": 1}
EE_STATES = {"ee_gn": (32, 4), "ee_err": (128, 32)}
EE_STATES_RPY = {"ee_gn": (16, 4), "ee_err": (128, 32)}
EE_SMEM_MAX = 48 * 1024
EE_SMEM = {"n8": EE_SMEM_MAX, "fb16": EE_SMEM_MAX, "fb32": SMEM_MAX,
           "fq32": SMEM_MAX}


def ee_fixed(cls: str = "n8") -> int:
    """A block's shared values ahead of its states (csrc/ee_gn.cu EE_FIXED,
    ee_fixed_values): the walk's row of each body of the class (Ttree's
    rotation and translation, the joint axis: 15 values) and the EE mount
    (12)."""
    return 15 * CLASSES[cls][0] + 12


EE_FIXED = ee_fixed("n8")


def ee_values(kernel: str, cls: str = "n8") -> int:
    """Shared-memory values a state takes in a block of ``kernel`` at the
    class's bound of nv coordinates (csrc/ee_gn.cu ee_state_values, 8 on
    n8, and ee_root_state_values, 21 on fb16 and 37 on fb32 and fq32): the staged q
    row (nq: nv, or nv + 1 on the quaternion root) and e (3); ee_gn also
    g0 (nv), H0 (nv x nv) and the state's columns of J (3 x nv)."""
    _, nv, nq = class_dims(cls)
    if kernel == "ee_err":
        return nq + 3
    if kernel == "ee_gn":
        return nq + nv + 3 + nv * nv + 3 * nv
    raise ValueError(f"{kernel} is not an end-effector kernel")


def ee_geometry(kernel: str, dtype, B: int, nsm: int = H100_SMS,
                cls: str = "n8"):
    """(states a block, threads a block, shared bytes a block, blocks) of
    an ``ee_gn`` or ``ee_err`` launch over B states in size class ``cls``:
    the most states of EE_STATES (EE_STATES_RPY on a floating root) a
    block, halved down to its fewest while the batch would leave SMs
    without a block or the block would pass the class's EE_SMEM; its
    shared memory holds ``ee_fixed(cls)`` values and ``ee_values`` a
    state.  Every count is a multiple of four, which keeps each staged
    row's range of a block 16-byte aligned."""
    spb, least = (EE_STATES_RPY if CLASSES[cls][1] else EE_STATES)[kernel]
    size = torch.finfo(dtype).bits // 8
    smem = lambda k: (ee_fixed(cls) + k * ee_values(kernel, cls)) * size
    while spb > least and (-(-B // spb) < nsm or smem(spb) > EE_SMEM[cls]):
        spb //= 2
    return spb, spb * EE_LANES[kernel], smem(spb), -(-B // spb)


@functools.lru_cache(maxsize=256)
def ee_args(kernel: str, dtype, B: int, device, cls: str = "n8"):
    """(states a block, shared bytes a block) of an end-effector launch
    over B states in ``dtype`` on CUDA ``device`` in size class ``cls``,
    worked out once per (kernel, dtype, B, device, cls)."""
    spb, _, smem, _ = ee_geometry(kernel, dtype, B, sm_count(device), cls)
    return spb, smem


def team_defines() -> tuple:
    """The nvcc defines that fix each team kernel's team size per size
    class and dtype (RBD_TEAM_<kernel>_<class>_<f32|f64>) from TEAM."""
    return tuple(f"-DRBD_TEAM_{k}_{cls}_{sfx}={n}"
                 for (k, cls, sfx), n in sorted(TEAM.items()))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_dtype(kernel: str, ref: torch.Tensor):
    if ref.dtype not in _SUFFIX:
        raise ValueError(f"{kernel}: kernels take float32 or float64, got "
                         f"{ref.dtype}")


def tree_depths(model) -> list:
    """Each body's depth in the model's tree (parents precede children)."""
    depth = []
    for p in model.parent:
        depth.append(0 if p < 0 else depth[p] + 1)
    return depth


def level_walk(model) -> bool:
    """Whether feedback_rollout and feedback_chunked walk the step's
    root->leaf recursions level
    by level: where the tree branches (the rpy root's legs and limbs), the
    bodies of a level run side by side; a chain (an arm) is walked body by
    body, which keeps the next body's data loading under the barrier
    (PERF.md §6).  fd_step always walks body by body."""
    return max(tree_depths(model)) + 1 < model.nb


def team_args(kernel: str, model, ref: torch.Tensor, B: int,
              dense: bool = False):
    """The geometry arguments of a team kernel's launch over B elements of
    ``model`` on ref's device (fd_step_minv: on the ``dense`` route or the
    factorised one): (teams a block, shared bytes a block), for
    feedback_rollout and feedback_chunked after the walk (1: level by
    level, 0: body by body; ``level_walk``'s).  Worked out once per model,
    kernel, dtype, B, device, route and team size, in the model's table
    cache, so a call's host work is a few dictionary lookups."""
    _check_dtype(kernel, ref)
    cls = model_class(kernel, model)
    key = ("team_args", kernel, ref.dtype, B, str(ref.device), dense,
           TEAM[(kernel, cls, _SUFFIX[ref.dtype])])
    if key not in model._tables:
        _, tpb, smem, _ = team_geometry(kernel, cls, ref.dtype, B,
                                        sm_count(ref.device), dense)
        walk = ((int(level_walk(model)),)
                if kernel in FEEDBACK_KERNELS else ())
        model._tables[key] = (*walk, tpb, smem)
    return model._tables[key]


# launches per kernel since the last reset_launches(); a wrapper adds one
# only after its kernel launched without error.  riccati_chunk and
# riccati_small count the chunked Riccati kernel at its two call sites
# (batch >= 128 and < 128); riccati_fused is the arm-class sweep (nx <= 16);
# feedback_chunked is the line search's chunked-gain kernel (K9), counted
# apart from feedback_rollout (K2); feedback_rollout_fext and
# feedback_chunked_fext are K2 and K9 with wrenches; the *_static kernels
# are K10, K1, K6, K5, K2 (with or without wrenches), K3 and K4 specialised
# to a model (class "static").
launches = {"fd_step": 0, "feedback_rollout": 0, "linearize_parts": 0,
            "ee_gn": 0, "ee_err": 0, "rnea": 0, "fd_step_minv": 0,
            "rollout_multi": 0, "riccati_chunk": 0, "riccati_small": 0,
            "riccati_fused": 0, "feedback_chunked": 0,
            "feedback_rollout_fext": 0, "feedback_chunked_fext": 0,
            "rnea_static": 0, "fd_step_static": 0, "fd_step_minv_static": 0,
            "rollout_multi_static": 0, "feedback_rollout_static": 0,
            "linearize_parts_static": 0, "ee_gn_static": 0,
            "ee_err_static": 0}
# the same launches of the kernels that take a model, by (kernel, size
# class): one kernel's instantiations apart
class_launches = collections.Counter()

# C signatures: p pointer, i int, s scalar of the kernel's dtype; every
# function ends with the stream.  The tree kernels' signatures follow a
# leading (tab, itab, nb); the Riccati sweep takes no model.
_SIGNATURES = {
    # x u fext fext_stride xo B tpb smem dt gravity
    "fd_step": "pppipiiiss",
    # x0 Xn Un kf Kf uclip Xo Uo B H levels tpb smem dt gravity
    "feedback_rollout": "ppppppppiiiiiss",
    # q qd u Minv dcq dcd qdd B tpb smem gravity
    "linearize_parts": "pppppppiiis",
    # ee chain prism q tx ty tz e g0 H0 B spb smem (chain: the EE joint
    # and its ancestors, one bit a body; prism: those that are prismatic)
    "ee_gn": "piipssspppiii",
    "ee_err": "piipssspiii",       # ee chain prism q tx ty tz e B spb smem
    "rnea": "ppppiiis",            # q qd qdd tau B tpb smem gravity
    # x u fext fext_stride xo B dense tpb smem dt gravity
    "fd_step_minv": "pppipiiiiss",
    # x0 U fext xo B H minv tpb smem dt gravity
    "rollout_multi": "ppppiiiiiss",
    # x0 Xn Un kf Kf uclip Xo Uo B H cw nc levels tpb smem dt gravity
    "feedback_chunked": "ppppppppiiiiiiiss",
    # as feedback_rollout and feedback_chunked, with fext (H, nb, 6) after Kf
    "feedback_rollout_fext": "pppppppppiiiiiss",
    "feedback_chunked_fext": "pppppppppiiiiiiiss",
}
# A B lx lu lxx sb st luu sb st lux sb st lfx lfxx reg k K dV1 ok B H nx nu
# threads smem (the two Riccati sweeps share these)
_MODEL_FREE = {"riccati": "pppppiipiipiipppppppiiiiii",
               "riccati_fused": "pppppiipiipiipppppppiiiiii"}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def reset_launches():
    for k in launches:
        launches[k] = 0
    class_launches.clear()


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile the kernels (once per source content and TEAM); returns the
    .so path.  One nvcc per source, all started together, then one link.
    The compiler's register/spill report is kept beside the library as
    .ptxas.log."""
    srcs = _sources()
    flags = (*COMPILE_FLAGS, *team_defines())
    h = hashlib.sha256(" ".join(flags + LINK_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"librbdtpu_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    nvcc, cus = _nvcc(), [p for p in srcs if p.endswith(".cu")]
    work = f"{so}.{os.getpid()}.d"
    os.makedirs(work, exist_ok=True)
    run = lambda cmd: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    try:
        objs = [os.path.join(work, os.path.basename(p)[:-3] + ".o")
                for p in cus]
        lib = os.path.join(work, "lib.so")
        procs = [run([nvcc, *flags, "-o", o, p])
                 for o, p in zip(objs, cus)]
        logs = [p.communicate()[0] for p in procs]
        if all(p.returncode == 0 for p in procs):
            procs.append(run([nvcc, *LINK_FLAGS, "-o", lib, *objs]))
            logs.append(procs[-1].communicate()[0])
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                log for p, log in zip(procs, logs) if p.returncode))
        with open(so[:-3] + ".ptxas.log", "w") as f:
            f.write("".join(logs))
        os.replace(lib, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    model_args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    bind = [(f"rbd_{k}_{cls}", model_args, _SIGNATURES[k])
            for cls, (_, _, kernels) in CLASSES.items() for k in kernels]
    bind += [(f"rbd_{k}", [], sig) for k, sig in _MODEL_FREE.items()]
    for prefix, lead, sig in bind:
        for dtype, suffix in _SUFFIX.items():
            codes = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "s": _CTYPE[dtype]}
            fn = getattr(lib, f"{prefix}_{suffix}")
            fn.argtypes = (lead + [codes[c] for c in sig]
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.rbd_stack_limit.argtypes = [ctypes.POINTER(ctypes.c_size_t)]
    lib.rbd_set_stack_limit.argtypes = [ctypes.c_size_t]
    lib.rbd_stack_limit.restype = lib.rbd_set_stack_limit.restype = (
        ctypes.c_int)
    return lib


def stack_limit(device) -> int:
    """The per-thread stack limit of CUDA ``device`` in bytes
    (cudaLimitStackSize).  The driver raises it to the largest stack frame
    launched so far and keeps local memory of that size for every thread
    the card can hold, outside PyTorch's allocator."""
    out = ctypes.c_size_t()
    with torch.cuda.device(device):
        err = library().rbd_stack_limit(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetLimit failed: cudaError {err}")
    return out.value


def set_stack_limit(device, nbytes: int):
    """Set ``device``'s per-thread stack limit; lowering it frees the local
    memory the driver kept for a larger frame (a later launch that needs
    more raises it again)."""
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        err = library().rbd_set_stack_limit(nbytes)
    if err != 0:
        raise RuntimeError(f"cudaDeviceSetLimit failed: cudaError {err}")


def size_class(kernel: str, model) -> str:
    """The size class whose instantiation of ``kernel`` takes ``model``;
    raises NotImplementedError for a root the kernel does not cover and
    ValueError for a tree larger than every instantiation.  The quaternion
    root takes QUAT_CLASSES, the fixed base and the rpy root SIZE_CLASSES."""
    quat = model.floating_base and model.root_quat
    fits = [(nmax, cls) for cls, (nmax, fb, kernels) in (
        QUAT_CLASSES if quat else SIZE_CLASSES).items()
        if fb == model.floating_base and kernel in kernels]
    if not fits:
        raise NotImplementedError(
            f"{kernel}: no CUDA instantiation covers this model's root")
    levels = max(tree_depths(model)) + 1
    for nmax, cls in sorted(fits):
        if model.nb <= nmax and (kernel not in LEVEL_KERNELS
                                 or levels <= LIN_LEVELS[cls]):
            return cls
    if model.nb <= max(fits)[0]:
        raise ValueError(f"{kernel}: a tree of {levels} levels exceeds the "
                         f"kernel's deepest instantiation "
                         f"({max(LIN_LEVELS.values())} levels)")
    raise ValueError(f"{kernel}: {model.nb} bodies exceed the kernel's "
                     f"largest instantiation ({max(fits)[0]} bodies)")


def model_class(kernel: str, model) -> str:
    """``size_class(kernel, model)``, worked out once per model and kernel
    (the model's table cache)."""
    key = ("size_class", kernel)
    if key not in model._tables:
        model._tables[key] = size_class(kernel, model)
    return model._tables[key]


def preorder(model) -> list:
    """The bodies in depth-first preorder (each body's children in the
    model's order), which linearize_parts' column sweeps walk."""
    children = [[] for _ in range(model.nb)]
    for i, p in enumerate(model.parent):
        if p >= 0:
            children[p].append(i)
    out, stack = [], [i for i, p in enumerate(model.parent) if p < 0][::-1]
    while stack:
        i = stack.pop()
        out.append(i)
        stack.extend(children[i][::-1])
    return out


def model_tables(model, device, dtype):
    """The model's kernel tables on ``device`` in ``dtype``, uploaded once
    per (model, device, dtype): per body [E, r, axis, I, S, Ttree R, Ttree p]
    (the compact (E, r) split of Xtree: X = [[E, 0], [-E r^, E]]), and the
    int32 [parent..., joint_type..., the bodies in order of depth in the
    tree..., the number of depths, where each depth starts in that order
    (and its end)..., the bodies in depth-first preorder..., each body's
    depth...]: the team kernels (csrc/rbd_team.cuh) walk the level order,
    linearize_parts the preorder.  An rpy floating root's row carries its
    Xtree[0] and inertia like any other; its joint (type FLOATING, six DoFs,
    S = I) is the kernels' to know."""
    key = ("model", str(device), dtype)
    if key not in model._tables:
        hd = model.host_data
        rows = []
        for i in range(model.nb):
            X = hd["Xtree"][i]
            E = X[:3, :3]
            rh = -E.T @ X[3:, :3]
            T = hd["Ttree"][i]
            rows.append(np.concatenate([
                E.ravel(), [rh[2, 1], rh[0, 2], rh[1, 0]], hd["axis"][i],
                hd["I"][i].ravel(), hd["S"][i], T[:3, :3].ravel(), T[:3, 3],
            ]))
        tab = torch.tensor(np.concatenate(rows), dtype=dtype, device=device)
        depth = tree_depths(model)
        levels = max(depth) + 1
        order = sorted(range(model.nb), key=lambda i: (depth[i], i))
        starts = [sum(d < lv for d in depth) for lv in range(levels + 1)]
        itab = torch.tensor(
            list(model.parent) + list(model.joint_type) + order + [levels]
            + starts + preorder(model) + depth, dtype=torch.int32,
            device=device)
        model._tables[key] = (tab, itab)
    return model._tables[key]


def ee_table(model, fid, device, dtype):
    """The end-effector mount [R (row-major), p] of fixed frame ``fid``
    (identity for a joint frame), uploaded once per (model, fid, device,
    dtype)."""
    key = ("ee", fid, str(device), dtype)
    if key not in model._tables:
        T = np.eye(4) if fid is None else model.host_data["T_fixed"][fid]
        model._tables[key] = torch.tensor(
            np.concatenate([T[:3, :3].ravel(), T[:3, 3]]), dtype=dtype,
            device=device)
    return model._tables[key]


def check(t: torch.Tensor, name: str, shape, ref: torch.Tensor):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ref's
    device in ref's dtype."""
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"{name}: expected {ref.dtype} on {ref.device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(kernel: str, model, ref: torch.Tensor, *args, count_as=None):
    """Launch ``kernel`` on ref's device and dtype, on the current stream,
    for ``model`` (its size class's instantiation, after the leading (tab,
    itab, nb)), or with ``model=None`` for a kernel that takes no model.
    ``args`` follow the C signature: tensors (or None for a null pointer),
    ints and floats.  The launch counts under ``count_as`` (default: the
    kernel's name)."""
    _check_dtype(kernel, ref)
    lead, cls = [], None
    symbol = f"rbd_{kernel}"
    if model is not None:
        cls = model_class(kernel, model)
        symbol += "_" + cls
        tab, itab = model_tables(model, ref.device, ref.dtype)
        lead = [tab.data_ptr(), itab.data_ptr(), model.nb]
    fn = getattr(library(), f"{symbol}_{_SUFFIX[ref.dtype]}")
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(*lead, *conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    launches[count_as or kernel] += 1
    if cls is not None:
        class_launches[count_as or kernel, cls] += 1


# ----------------------------------------------------------------------- #
# the model-specialised kernels (K0): one library per model, dtype and     #
# gravity, generated by kernels/codegen.py                                 #
# ----------------------------------------------------------------------- #

STATIC_KERNELS = ("rnea_static", "fd_step_static", "fd_step_minv_static",
                  "rollout_multi_static", "feedback_rollout_static",
                  "linearize_parts_static", "ee_gn_static", "ee_err_static")
# the C signatures of the table kernels they shadow, less the tables, the
# shared memory and the gravity (folded into the code)
_STATIC_SIGNATURES = {
    "rnea_static": "ppppii",              # q qd qdd tau B tpb
    "fd_step_static": "pppipiis",         # x u fext fext_stride xo B tpb dt
    # x u fext fext_stride xo B dense tpb dt
    "fd_step_minv_static": "pppipiiis",
    "rollout_multi_static": "ppppiiiis",  # x0 U fext xo B H minv tpb dt
    # x0 Xn Un kf Kf fext uclip Xo Uo B H tpb dt (fext, uclip may be null)
    "feedback_rollout_static": "pppppppppiiis",
    "linearize_parts_static": "pppppppii",  # q qd u Minv dcq dcd qdd B tpb
}
# the effector's library (one a model, dtype and effector): its chain, fixed
# frame and offset are folded in, the target is read at run time
_STATIC_EE_SIGNATURES = {
    "ee_gn_static": "pssspppii",          # q tx ty tz e g0 H0 B tpb
    "ee_err_static": "pssspii",           # q tx ty tz e B tpb
}
MODEL_BUILD_DIR = os.path.join(BUILD_DIR, "models")
# threads a block of a specialised launch (the kernels' __launch_bounds__),
# one thread a state: at the paths' 128-4,096 states 32 leaves the fewest
# SMs without a block
STATIC_THREADS = 32


def static_dir(gen) -> str:
    """The build directory of generated sources ``gen``
    (``codegen.Generated``): named by the sha256 of the flags and of every
    source's name and text, so a model whose data differ gets its own."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in sorted(gen.sources):
        h.update(name.encode())
        h.update(gen.sources[name].encode())
    return os.path.join(MODEL_BUILD_DIR, h.hexdigest()[:32])


def _timed(cmd):
    """(return code, output, seconds) of one compiler run."""
    start = time.perf_counter()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    return p.returncode, p.stdout, time.perf_counter() - start


def build_static(gens) -> list:
    """Build the libraries of generated sources ``gens`` that are not built
    yet: one nvcc per source of every library, all started together, then
    one link a library.  Each library's directory keeps its sources,
    ``lib.so``, the compiler's report (``ptxas.log``, one section a source)
    and ``build.json`` (each source's build seconds, wall time with every
    compile of the call running, the link's, and the operations each body
    emits a state).  Returns the directories; raises if a build fails."""
    dirs = [static_dir(g) for g in gens]
    todo = {d: g for d, g in zip(dirs, gens)
            if not os.path.exists(os.path.join(d, "lib.so"))}
    if not todo:
        return dirs
    nvcc, flags = _nvcc(), COMPILE_FLAGS
    jobs = []
    for d, g in todo.items():
        work = os.path.join(d, f"work.{os.getpid()}")
        os.makedirs(work, exist_ok=True)
        for name, text in g.sources.items():
            src = os.path.join(d, name)
            with open(src, "w") as f:
                f.write(text)
            jobs.append((d, name, [nvcc, *flags, "-o",
                                   os.path.join(work, name[:-3] + ".o"),
                                   src]))
    try:
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            runs = list(pool.map(_timed, [cmd for _, _, cmd in jobs]))
        failed = [f"{name}:\n{out}" for (_, name, _), (rc, out, _) in
                  zip(jobs, runs) if rc]
        if failed:
            raise RuntimeError("nvcc failed on a generated source:\n"
                               + "\n".join(failed))
        links = {d: [nvcc, *LINK_FLAGS, "-o",
                     os.path.join(d, f"work.{os.getpid()}", "lib.so"),
                     *[os.path.join(d, f"work.{os.getpid()}", n[:-3] + ".o")
                       for n in todo[d].sources]] for d in todo}
        with concurrent.futures.ThreadPoolExecutor(len(links)) as pool:
            linked = dict(zip(links, pool.map(_timed, links.values())))
        for d, (rc, out, secs) in linked.items():
            if rc:
                raise RuntimeError(f"nvcc failed to link {d}:\n{out}")
            mine = [(name, run) for (dd, name, _), run in zip(jobs, runs)
                    if dd == d]
            with open(os.path.join(d, "ptxas.log"), "w") as f:
                f.write("".join(f"== {name}\n{out}" for name, (_, out, _)
                                in mine))
            with open(os.path.join(d, "build.json"), "w") as f:
                json.dump({"seconds": {name: s for name, (_, _, s) in mine},
                           "link_seconds": secs, "parallel": len(jobs),
                           "ops": todo[d].ops}, f, indent=1)
            os.replace(os.path.join(d, f"work.{os.getpid()}", "lib.so"),
                       os.path.join(d, "lib.so"))
    finally:
        for d in todo:
            shutil.rmtree(os.path.join(d, f"work.{os.getpid()}"),
                          ignore_errors=True)
    return dirs


def bind_static(so: str, dtype, ee: bool = False) -> ctypes.CDLL:
    """Load a specialised library generated in ``dtype`` (a model's, or
    with ``ee`` an effector's) and declare its entry points (also for a
    host build of the sources, whose stream argument is ignored)."""
    lib = ctypes.CDLL(so)
    codes = {"p": ctypes.c_void_p, "i": ctypes.c_int, "s": _CTYPE[dtype]}
    sigs = _STATIC_EE_SIGNATURES if ee else _STATIC_SIGNATURES
    for k, sig in sigs.items():
        fn = getattr(lib, f"rbd_{k}")
        fn.argtypes = [codes[c] for c in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def prepare_static(pairs, gravity: float = -9.81, ees=()) -> list:
    """Generate, build (all together) and load the specialised libraries
    of every (model, dtype) in ``pairs`` and the effector libraries of
    every (model, dtype, jid, fid) in ``ees``; returns their build
    directories, the models' then the effectors'."""
    from . import codegen

    keys = [(m, ("static_lib", dt, float(gravity))) for m, dt in pairs]
    keys += [(m, ("static_ee", dt, jid, fid)) for m, dt, jid, fid in ees]
    need = [(m, k) for m, k in keys if k not in m._tables]
    gens = [codegen.generate(m, k[1], gravity) if k[0] == "static_lib"
            else codegen.generate_ee(m, k[1], k[2], k[3]) for m, k in need]
    dirs = build_static(gens)
    for (m, k), d in zip(need, dirs):
        m._tables[k] = (bind_static(os.path.join(d, "lib.so"), k[1],
                                    ee=k[0] == "static_ee"), d)
    return [m._tables[k][1] for m, k in keys]


def model_library(model, dtype, gravity: float = -9.81):
    """(the loaded library, its build directory) of ``model``'s specialised
    kernels in ``dtype`` under ``gravity``, generated and built at first
    use and kept in the model's table cache."""
    key = ("static_lib", dtype, float(gravity))
    if key not in model._tables:
        prepare_static([(model, dtype)], gravity)
    return model._tables[key]


def ee_library(model, dtype, jid: int, fid):
    """(the loaded library, its build directory) of the effector kernels
    of ``model`` in ``dtype`` for the effector at joint ``jid`` and fixed
    frame ``fid`` (or None), generated and built at first use."""
    key = ("static_ee", dtype, jid, fid)
    if key not in model._tables:
        prepare_static([], ees=[(model, dtype, jid, fid)])
    return model._tables[key]


def launch_static(kernel: str, model, ref: torch.Tensor, gravity, *args,
                  ee=None):
    """Launch the specialised ``kernel`` (STATIC_KERNELS) of ``model`` on
    ref's device and dtype, on the current stream, from the model's
    library under ``gravity`` or, for K4, from the library of the effector
    ``ee`` = (jid, fid); ``args`` follow its C signature.  Raises on a
    nonzero cudaError; counts the launch in ``launches`` and
    ``class_launches`` (class "static")."""
    _check_dtype(kernel, ref)
    lib, _ = (model_library(model, ref.dtype, gravity) if ee is None
              else ee_library(model, ref.dtype, *ee))
    fn = getattr(lib, f"rbd_{kernel}")
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    launches[kernel] += 1
    class_launches[kernel, "static"] += 1
