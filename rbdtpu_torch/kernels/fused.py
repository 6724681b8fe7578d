"""Dynamics-step kernels, each beside its plain PyTorch version: the ABA +
semi-implicit Euler step (K1), the line-search feedback rollout (K2) and
its chunked-gain form (K9), RNEA (K10), the M^-1 + RNEA step (K6) and the
whole-horizon rollout (K5); and rbdtpu's budget arithmetic that picks
between K2 and K9 in the line search.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  Every kernel here takes fixed-base models, the rpy floating root
and the quaternion root (``_lib.size_class``).  K1, K2, K5, K6 and K9 take
world-frame wrenches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dynamics.aba import aba
from ..dynamics.fd import forward_dynamics
from ..dynamics.rnea import rnea
from ..model.robot import RobotModel
from ..solver.integrate import euler_semi_implicit, split_state, state_diff
from ..spatial.ops import mv
from ..spatial.transforms import PRISMATIC
from . import _lib
from . import lanescalar as ls


def _fext_arg(model: RobotModel, f_ext, B: int, ref: torch.Tensor):
    """A step kernel's wrench argument: (None, 0) without wrenches; the
    contiguous (nb, 6) set shared by the batch with stride 0; or the
    (B, nb, 6) per-element sets with stride nb*6."""
    if f_ext is None:
        return None, 0
    if f_ext.dim() == 2:
        _lib.check(f_ext, "f_ext", (model.nb, 6), ref)
        return f_ext, 0
    _lib.check(f_ext, "f_ext", (B, model.nb, 6), ref)
    return f_ext, model.nb * 6


def fd_step_plain(model: RobotModel, x, u, dt: float, gravity: float = -9.81,
                  f_ext=None):
    """x (B, nx), u (B, nv) -> x' (B, nx): ABA with the world-frame wrenches
    f_ext ((nb, 6) or (B, nb, 6)) when given, then semi-implicit Euler.
    A state narrower than the model's dtype (MPPI's sampling dtype) is
    stepped in the wider of the two, as rbdtpu's promotion does, and
    returned in its own."""
    wide = torch.promote_types(x.dtype, model.dtype)
    if wide != x.dtype:
        return fd_step_plain(
            model, x.to(wide), u.to(wide), dt, gravity,
            None if f_ext is None else f_ext.to(wide)).to(x.dtype)
    q, qd = split_state(model, x)
    return euler_semi_implicit(
        model, x, aba(model, q, qd, u, f_ext=f_ext, gravity=gravity), dt)


def fd_step_fused(model: RobotModel, x, u, dt: float, gravity: float = -9.81,
                  f_ext=None, specialize: bool = False):
    """One forward-dynamics step x (B, nx), u (B, nv) -> x' (B, nx), with
    optional world-frame wrenches f_ext, (nb, 6) shared by the batch or
    (B, nb, 6).  ``specialize=True`` takes the model-specialised kernel
    ``fd_step_static`` (``_static_step``).  On the quaternion root (nx = 2 nv + 1) the step retracts
    the root's pose on the manifold (rbdtpu fused.py _integrate_q_lane):
    p' = p + dt R(quat) v', quat' = normalize(quat (x) exp(dt w')), on one
    lane as a real call (csrc/rbd_common.cuh quat_root_step).

    Kernel ``fd_step`` (csrc/fd_step.cu) replaces rbdtpu's
    ``kernels.fused.fd_step_fused`` (Pallas, fused.py:450): one team of
    lanes of a warp per batch element (csrc/rbd_team.cuh) builds the
    compact joint transforms one lane a body, runs the three ABA sweeps
    with each body's 6x6 products split over its lanes and the per-body
    state in shared memory (the wrenches enter the bias forces through the
    compact world->body chain) and integrates, reading only x, u and f_ext
    and writing only x'.  Bound on the H100: the latency of the step's
    chain along the tree for a small batch, instruction issue for a large
    one, not bytes; the team size per size class and dtype (``_lib.TEAM``)
    and the teams a block are ``_lib.team_geometry``'s, which spreads a
    small batch (the MPC plant's B=1, the solver's B=128) over as many SMs
    as it has teams.
    """
    if specialize:
        return _static_step("fd_step_static", model, x, u, dt, gravity, f_ext)
    if not x.is_cuda:
        return fd_step_plain(model, x, u, dt, gravity, f_ext)
    B = x.shape[0]
    _lib.check(x, "x", (B, model.nx), x)
    _lib.check(u, "u", (B, model.nv), x)
    fe, stride = _fext_arg(model, f_ext, B, x)
    xo = torch.empty_like(x)
    _lib.launch("fd_step", model, x, x, u, fe, stride, xo, B,
                *_lib.team_args("fd_step", model, x, B), dt, gravity)
    return xo


def rollout_fused(model: RobotModel, x0, U, dt: float,
                  gravity: float = -9.81):
    """Rollout driven by the step kernel: x0 (B, nx), U (H, B, nv)
    scan-major -> final state (B, nx); one ``fd_step_fused`` per step."""
    x = x0
    for t in range(U.shape[0]):
        x = fd_step_fused(model, x, U[t], dt, gravity)
    return x


def rnea_plain(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81):
    """q, qd, qdd (B, n) -> tau (B, n); without qdd the bias forces."""
    return rnea(model, q, qd, qdd, gravity)[0]


def rnea_fused(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81,
               specialize: bool = False):
    """RNEA joint forces in one launch: q, qd and optional qdd (B, n) ->
    tau (B, n).  ``specialize=True`` takes the model-specialised kernel
    ``rnea_static`` (``_static_rnea``).

    Kernel ``rnea`` (csrc/rnea.cu) replaces rbdtpu's
    ``kernels.fused.rnea_fused`` (Pallas, fused.py:358): one team of lanes
    of a warp per state (csrc/rbd_team.cuh ``team_rnea``) builds the
    transforms one lane a body and runs both RNEA sweeps one lane a
    component, with the per-body state in shared memory; a floating root's
    six rows are its body force.  On the quaternion root q is (B, nv + 1)
    and the root's transform comes from its quaternion (csrc/rbd_common.cuh
    floating_quat_xc, a real call on one lane).  Without qdd the kernel is
    instantiated with the acceleration term compiled out.  Bound on the
    H100: the latency of the sweeps' chain along the tree; the traffic is
    the inputs once and tau once.  Team size and teams a block are
    ``_lib.team_geometry``'s.
    """
    if specialize:
        return _static_rnea(model, q, qd, qdd, gravity)
    if not q.is_cuda:
        return rnea_plain(model, q, qd, qdd, gravity)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    _lib.check(qd, "qd", (B, n), q)
    if qdd is not None:
        _lib.check(qdd, "qdd", (B, n), q)
    tau = torch.empty(B, n, dtype=q.dtype, device=q.device)
    _lib.launch("rnea", model, q, q, qd, qdd, tau, B,
                *_lib.team_args("rnea", model, q, B), gravity)
    return tau


def fd_step_minv_plain(model: RobotModel, x, u, dt: float,
                       gravity: float = -9.81, dense_minv: bool = False,
                       f_ext=None):
    """One step of ``forward_dynamics`` (qdd = M^-1 (u - c), the bias c
    carrying f_ext) and semi-implicit Euler.  The plain M^-1 is the dense
    analytical one either way; ``dense_minv`` selects the kernel's
    variant."""
    q, qd = split_state(model, x)
    qdd = forward_dynamics(model, q, qd, u, gravity, f_ext)
    return euler_semi_implicit(model, x, qdd, dt)


def fd_step_minv_fused(model: RobotModel, x, u, dt: float,
                       gravity: float = -9.81, dense_minv: bool = False,
                       f_ext=None, specialize: bool = False):
    """One forward-dynamics step on the M^-1 + RNEA route (BASELINE.json
    configs[1]): x (B, nx), u (B, nv) -> x' (B, nx), with optional wrenches
    f_ext, (nb, 6) or (B, nb, 6).  ``specialize=True`` takes the
    model-specialised kernel ``fd_step_minv_static`` (``_static_step``).

    Kernel ``fd_step_minv`` (csrc/fd_step_minv.cu) replaces rbdtpu's
    ``kernels.fused.fd_step_minv_fused`` (Pallas, fused.py:1267): one team
    of lanes of a warp per element runs the team RNEA bias (with the
    wrenches), then qdd = M^-1 (u - c) by the articulated sweeps at zero
    velocity and gravity (K5's minv step), or with ``dense_minv=True``
    builds the explicit analytical M^-1 one column a lane and applies it,
    then Euler.  On the quaternion root (nx = 2 nv + 1) the bias's root
    transform comes from the quaternion and Euler retracts the root's pose
    on the manifold (csrc/rbd_common.cuh quat_root_step on one lane, as
    ``fd_step_fused``), on both routes.  Bound on the H100: the latency of
    the sweeps' chain along the tree.  Team size and teams a block (per
    route) are ``_lib.team_geometry``'s.
    """
    if specialize:
        return _static_step("fd_step_minv_static", model, x, u, dt, gravity,
                            f_ext, dense_minv)
    if not x.is_cuda:
        return fd_step_minv_plain(model, x, u, dt, gravity, dense_minv,
                                  f_ext)
    B = x.shape[0]
    _lib.check(x, "x", (B, model.nx), x)
    _lib.check(u, "u", (B, model.nv), x)
    fe, stride = _fext_arg(model, f_ext, B, x)
    xo = torch.empty_like(x)
    _lib.launch("fd_step_minv", model, x, x, u, fe, stride, xo, B,
                int(dense_minv),
                *_lib.team_args("fd_step_minv", model, x, B, dense_minv), dt,
                gravity)
    return xo


_ROUTES = ("aba", "minv")


def rollout_multi_plain(model: RobotModel, x0, U, dt: float,
                        gravity: float = -9.81, route: str = "aba",
                        f_ext=None):
    """x0 (B, nx), U (H, B, nv), f_ext None or (H, nb, 6) -> final state
    (B, nx) after H steps of ``aba`` ("aba") or ``forward_dynamics``
    ("minv"), each followed by semi-implicit Euler."""
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    step = fd_step_minv_plain if route == "minv" else fd_step_plain
    x = x0
    for t in range(U.shape[0]):
        x = step(model, x, U[t], dt, gravity,
                 f_ext=None if f_ext is None else f_ext[t])
    return x


def rollout_fused_multi(model: RobotModel, x0, U, dt: float,
                        gravity: float = -9.81, route: str = "aba",
                        f_ext=None, specialize: bool = False):
    """The whole horizon in one launch: x0 (B, nx), U (H, B, nv)
    scan-major -> final state (B, nx).  route "aba" (O(n) articulated
    step) or "minv" (bias RNEA + factorised M^-1 apply, BASELINE.json
    configs[1]); f_ext None or (H, nb, 6) per-knot world wrenches shared by
    the batch.  ``specialize=True`` takes the model-specialised kernel
    ``rollout_multi_static`` (``_static_rollout``).

    Kernel ``rollout_multi`` (csrc/rollout_multi.cu) replaces rbdtpu's
    ``kernels.fused.rollout_fused_multi`` (Pallas, fused.py:1029), whose
    sequential grid axis carried the state in VMEM between steps: here one
    team of lanes of a warp per trajectory loops over the H steps with its
    state in shared memory and writes only the final state.  A step is the
    team ABA step of ``fd_step_fused`` ("aba"), or the team's RNEA bias
    followed by the step's articulated sweeps at zero velocity and gravity
    ("minv"); the next step's controls and wrenches arrive by cp.async
    while the team computes.  On a floating root the rpy root's six-DoF
    block is solved inside the step, and on the quaternion root (x rows of
    nq + nv values) Euler is the manifold step of ``fd_step_fused``, on
    both routes.  Bound on the H100: the latency and issue of H dependent
    team steps; at B=4096 the arm7 batch fills the SMs in one wave.
    Team size and teams a block are ``_lib.team_geometry``'s; any B >= 1
    and H >= 0 are taken as they are.
    """
    if specialize:
        return _static_rollout(model, x0, U, dt, gravity, route, f_ext)
    if not x0.is_cuda:
        return rollout_multi_plain(model, x0, U, dt, gravity, route, f_ext)
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    H, B = U.shape[0], x0.shape[0]
    _lib.check(x0, "x0", (B, model.nx), x0)
    _lib.check(U, "U", (H, B, model.nv), x0)
    if f_ext is not None:
        _lib.check(f_ext, "f_ext", (H, model.nb, 6), x0)
    xo = torch.empty_like(x0)
    _lib.launch("rollout_multi", model, x0, x0, U, f_ext, xo, B, H,
                int(route == "minv"),
                *_lib.team_args("rollout_multi", model, x0, B), dt, gravity)
    return xo


def feedback_rollout_plain(model: RobotModel, x0, X_nom, U_nom, k_ff, K_fb,
                           dt: float, gravity: float = -9.81, u_clip=None,
                           f_ext=None):
    """Closed-loop rollout: per knot u = U_t + k_t + K_t (x (-) X_t), clamped
    to [-u_clip, u_clip] when given, then one ABA + Euler step under the
    knot's world-frame wrenches f_ext[t] when given.

    x0 (B, nx); X_nom (B, H, nx); U_nom, k_ff (B, H, nv) with the line-search
    step already folded into k_ff; K_fb (B, H, nv, ntan) acting on the
    tangent difference ``state_diff`` (2 nv wide); f_ext None or
    (H, nb, 6), shared by the batch (``dynamics.aba(f_ext)`` semantics).
    Returns (X (B, H, nx) — states 1..H, U (B, H, nv) — applied controls)."""
    x = x0
    xs, us = [], []
    for t in range(U_nom.shape[1]):
        dx = state_diff(model, x, X_nom[:, t])
        u = U_nom[:, t] + k_ff[:, t] + mv(K_fb[:, t], dx)
        if u_clip is not None:
            u = torch.clamp(u, -u_clip, u_clip)
        x = fd_step_plain(model, x, u, dt, gravity,
                          None if f_ext is None else f_ext[t])
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def feedback_rollout_fused(model: RobotModel, x0, X_nom, U_nom, k_ff, K_fb,
                           dt: float, gravity: float = -9.81, u_clip=None,
                           f_ext=None, specialize: bool = False):
    """The line-search rollout of ``feedback_rollout_plain``, one launch for
    the whole horizon.  ``specialize=True`` takes the model-specialised
    kernel ``feedback_rollout_static`` (``_static_feedback``).

    Kernel ``feedback_rollout`` (csrc/feedback_rollout.cu) replaces rbdtpu's
    ``kernels.fused.feedback_rollout_fused`` (Pallas, fused.py:611, one
    launch per knot inside lax.scan): one team of lanes of a warp per
    trajectory loops over the H knots with its state in shared memory.  Per
    knot the team's lanes copy the knot's gains and nominals into shared
    memory with consecutive lanes on consecutive addresses (cp.async, issued
    one knot ahead so the copies overlap the previous knot's step), sum the
    feedback one lane a row of K, clamp, and run the team ABA step of
    ``fd_step_fused``, its root->leaf recursions level by level on a
    branched tree (``_lib.level_walk``).  Bound on the H100: the latency of
    H dependent steps per trajectory; the gains are read once, coalesced.
    Team size and teams a block are ``_lib.team_geometry``'s; any B >= 1
    and H >= 1 are taken as they are.  The lanes stay independent and alpha
    stays folded into k_ff (rbdtpu's contract), so the line search's
    n_alpha candidates of one problem each read their own copy of K.  On
    the quaternion root the gains act on the tangent difference, whose six
    root rows lane 0 forms as a real call (csrc/rbd_common.cuh
    quat_root_dx: the quaternion log and R0^T dp, rbdtpu fused.py
    _dx_rows), and the step is K1's manifold one, with or without
    wrenches.

    With ``f_ext`` ((H, nb, 6) world-frame wrenches shared by the batch,
    rbdtpu's contract) the kernel ``feedback_rollout_fext`` runs the same
    body with the wrenches' chain in the step: a knot's wrench set arrives
    once a block, in the cp.async group of the knot's gains, into two
    stages the block's teams share.
    """
    if specialize:
        return _static_feedback(model, x0, X_nom, U_nom, k_ff, K_fb, dt,
                                gravity, u_clip, f_ext)
    if not x0.is_cuda:
        return feedback_rollout_plain(model, x0, X_nom, U_nom, k_ff, K_fb,
                                      dt, gravity, u_clip, f_ext)
    kernel, B, H, Xo, Uo = _feedback_launch_args(
        "feedback_rollout", model, x0, X_nom, U_nom, k_ff, K_fb, u_clip,
        f_ext)
    _lib.launch(kernel, model, x0, x0, X_nom, U_nom, k_ff, K_fb,
                *(() if f_ext is None else (f_ext,)), u_clip, Xo, Uo, B, H,
                *_lib.team_args(kernel, model, x0, B), dt, gravity)
    return Xo, Uo


def _feedback_launch_args(kernel: str, model: RobotModel, x0, X_nom, U_nom,
                          k_ff, K_fb, u_clip, f_ext):
    """Check the line-search kernels' inputs; (the kernel to launch, with
    ``_fext`` where wrenches are given, B, H, empty Xo, empty Uo)."""
    B, H = U_nom.shape[0], U_nom.shape[1]
    nx, nv = model.nx, model.nv
    _lib.check(x0, "x0", (B, nx), x0)
    _lib.check(X_nom, "X_nom", (B, H, nx), x0)
    _lib.check(U_nom, "U_nom", (B, H, nv), x0)
    _lib.check(k_ff, "k_ff", (B, H, nv), x0)
    _lib.check(K_fb, "K_fb", (B, H, nv, model.ntan), x0)
    if u_clip is not None:
        _lib.check(u_clip, "u_clip", (nv,), x0)
    if f_ext is not None:
        _lib.check(f_ext, "f_ext", (H, model.nb, 6), x0)
        kernel += "_fext"
    return kernel, B, H, torch.empty_like(X_nom), torch.empty_like(U_nom)


def chunk_geometry(ndx: int, nchunks: int):
    """(width, count) of the gain's column chunks as rbdtpu splits them
    (fused.py:842-843): width ceil(ndx / nchunks), then the count
    renormalised to ceil(ndx / width), so every chunk is nonempty."""
    if nchunks < 1:
        raise ValueError(f"nchunks must be >= 1, got {nchunks}")
    cw = -(-ndx // nchunks)
    return cw, -(-ndx // cw)


def feedback_rollout_chunked_plain(model: RobotModel, x0, X_nom, U_nom, k_ff,
                                   K_fb, dt: float, gravity: float = -9.81,
                                   u_clip=None, nchunks: int = 2, f_ext=None):
    """``feedback_rollout_plain`` with the feedback summed in rbdtpu's
    chunked order: u = U_t + k_t, then for each column chunk in order
    u += sum over its columns, ascending, starting from the first product;
    clamp, ABA under f_ext[t] when given, Euler.  Same shapes and
    outputs."""
    ndx = K_fb.shape[-1]
    cw, nc = chunk_geometry(ndx, nchunks)
    x = x0
    xs, us = [], []
    for t in range(U_nom.shape[1]):
        dx = state_diff(model, x, X_nom[:, t])
        K = K_fb[:, t]
        u = U_nom[:, t] + k_ff[:, t]
        for c in range(nc):
            j0 = c * cw
            acc = K[..., j0] * dx[:, None, j0]
            for j in range(j0 + 1, min(j0 + cw, ndx)):
                acc = acc + K[..., j] * dx[:, None, j]
            u = u + acc
        if u_clip is not None:
            u = torch.clamp(u, -u_clip, u_clip)
        x = fd_step_plain(model, x, u, dt, gravity,
                          None if f_ext is None else f_ext[t])
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def feedback_rollout_fused_chunked(model: RobotModel, x0, X_nom, U_nom, k_ff,
                                   K_fb, dt: float, gravity: float = -9.81,
                                   u_clip=None, nchunks: int = 2, f_ext=None):
    """The line-search rollout with the gain block taken in ``nchunks``
    column chunks, one launch for the whole horizon; shapes and outputs as
    ``feedback_rollout_fused``.

    Kernel ``feedback_chunked`` (csrc/feedback_chunked.cu) replaces
    rbdtpu's ``kernels.fused.feedback_rollout_fused_chunked`` (Pallas,
    fused.py:819: nchunks partial products and one dynamics call per knot,
    :904 and :945).  It runs K2's team body (csrc/feedback_team.cuh): one
    team of lanes a trajectory, each knot's whole gain block staged in
    shared memory by cp.async one knot ahead, one lane a row of K summing
    its column chunks in rbdtpu's order, then the team ABA step.  On this
    card the chunk is only the order of the sum.  Bound on the H100: the
    latency of H dependent steps per trajectory, as K2.  Team size, teams a
    block and walk are ``_lib.team_args``'; any B >= 1 and any nchunks >= 1
    are taken (``chunk_geometry``: the chunks split the 2 nv tangent
    columns).  On the quaternion root the gains act on the tangent
    difference as K2's do (its root rows by ``quat_root_dx``); a team past
    the batch returns before it reads a state, so unlike rbdtpu's padded
    lanes (w = 1 quaternions, fused.py:854-858) none is formed.  With
    ``f_ext`` ((H, nb, 6), shared by the batch) the kernel
    ``feedback_chunked_fext`` takes the wrenches as
    ``feedback_rollout_fused`` does.
    """
    cw, nc = chunk_geometry(model.nv * 2, nchunks)
    if not x0.is_cuda:
        return feedback_rollout_chunked_plain(model, x0, X_nom, U_nom, k_ff,
                                              K_fb, dt, gravity, u_clip,
                                              nchunks, f_ext)
    kernel, B, H, Xo, Uo = _feedback_launch_args(
        "feedback_chunked", model, x0, X_nom, U_nom, k_ff, K_fb, u_clip,
        f_ext)
    _lib.launch(kernel, model, x0, x0, X_nom, U_nom, k_ff, K_fb,
                *(() if f_ext is None else (f_ext,)), u_clip, Xo, Uo, B, H,
                cw, nc, *_lib.team_args(kernel, model, x0, B), dt, gravity)
    return Xo, Uo


# rbdtpu's routing between K2 and K9 (kernels/fused.py:312-319, 530-560,
# 757-777): a model of the TPU's scoped VMEM, copied as integer arithmetic
# only (no compile probe).  It is rbdtpu's rule, not a limit of the H100;
# the port applies it so that both packages run the same line search on the
# same configuration.
VMEM_BUDGET = 6 * 1024 * 1024


def _pad_batch(B: int) -> int:
    """rbdtpu's lane padding: B up to a multiple of 8, and above 4096 up to
    a multiple of 1024."""
    B8 = ((B + 7) // 8) * 8
    if B8 // 8 <= 512:
        return B8
    return ((B8 + 1023) // 1024) * 1024


def _feedback_rows_total(nx: int, nv: int, ndx: int) -> int:
    """Rows per lane of the unchunked feedback kernel: x, X_t, U_t, k_t,
    K_t and the outputs x', u."""
    return 3 * nx + 3 * nv + nv * ndx


def feedback_lane_budget(nx: int, nv: int, ndx: int) -> int:
    """The widest lane block of the unchunked feedback kernel within
    rbdtpu's VMEM budget."""
    return VMEM_BUDGET // (_feedback_rows_total(nx, nv, ndx) * 8 * 4)


def feedback_fused_ok(model: RobotModel, batch_total: int) -> bool:
    """The budget half of rbdtpu's ``feedback_fused_ok``: the unchunked
    kernel (K2) takes ``batch_total`` = batch x alphas trajectories."""
    if batch_total % 8 != 0:
        return False
    nv = int(model.nv)
    nx = int(model.nq) + nv
    BT = _pad_batch(batch_total) // 8
    return feedback_lane_budget(nx, nv, 2 * nv) >= min(BT, 128)


def feedback_chunks(model: RobotModel, batch_total: int,
                    max_chunks: int = 8):
    """rbdtpu's ``feedback_chunks``, which is also the budget half of its
    ``feedback_chunked_ok``: the smallest chunk count (1 .. max_chunks)
    whose chunk call fits the budget at this batch, or None."""
    if batch_total % 8 != 0:
        return None
    nv = int(model.nv)
    nx = int(model.nq) + nv
    ndx = 2 * nv
    BT = _pad_batch(batch_total) // 8
    for c in range(1, max_chunks + 1):
        cw = chunk_geometry(ndx, c)[0]
        rows = 2 * nx + nv * cw + nv
        if VMEM_BUDGET // (rows * 8 * 4) >= min(BT, 128):
            return c
    return None


# ----------------------------------------------------------------------- #
# K0: the model's constants as Python floats, and the lane sweeps over     #
# them (rbdtpu kernels/fused.py:37-310, 413-437, 982-1004, 1149-1266).     #
# Run on (B,) tensors they are the plain versions of the model-specialised #
# kernels (``specialize=True``); run on the generator's symbols            #
# (kernels/codegen.py) they write those kernels out.                       #
# ----------------------------------------------------------------------- #

class ModelStatic:
    """The model's constants as Python floats, built from the float64 copy
    of its data (``RobotModel.host_data``, which the table kernels read
    too), with rbdtpu's fields: nb, parent, jtype, fb, quat, axis, Xtree, I,
    S, Ttree, T_fixed, nv, nq, and the index maps qi and vi."""

    def __init__(self, parent, jtype, host_data, floating_base=False,
                 root_quat=False):
        self.nb = len(parent)
        self.parent = tuple(parent)
        self.jtype = tuple(jtype)
        self.fb = bool(floating_base)
        self.quat = bool(root_quat)
        d = host_data
        self.axis = np.asarray(d["axis"], dtype=np.float64).tolist()
        self.Xtree = np.asarray(d["Xtree"], dtype=np.float64).tolist()
        self.I = np.asarray(d["I"], dtype=np.float64).tolist()
        self.S = np.asarray(d["S"], dtype=np.float64).tolist()
        self.Ttree = (np.asarray(d["Ttree"], dtype=np.float64).tolist()
                      if "Ttree" in d else None)
        self.T_fixed = (np.asarray(d["T_fixed"], dtype=np.float64).tolist()
                        if "T_fixed" in d else None)
        self.nv = self.nb + 5 if self.fb else self.nb
        self.nq = self.nv + 1 if self.quat else self.nv

    def qi(self, i):
        """q-list index of 1-DoF joint i (root handled separately for fb)."""
        if self.quat:
            return i + 6
        return i + 5 if self.fb else i

    def vi(self, i):
        """velocity-list index of 1-DoF joint i."""
        return i + 5 if self.fb else i


def get_static(model: RobotModel) -> ModelStatic:
    """The model's ``ModelStatic``, built once per model (its table
    cache)."""
    if not model.host_data:
        raise ValueError("model has no host_data; build it with "
                         "rbdtpu_torch.model.make_model")
    key = ("static",)
    if key not in model._tables:
        model._tables[key] = ModelStatic(
            model.parent, model.joint_type, model.host_data,
            model.floating_base, model.root_quat)
    return model._tables[key]


def _joint_x(ms: ModelStatic, i: int, qi):
    if ms.jtype[i] == PRISMATIC:
        return ls.prismatic_x(ms.axis[i], ms.Xtree[i], qi)
    s, c = ls.sin(qi), ls.cos(qi)
    return ls.revolute_x(ms.axis[i], ms.Xtree[i], s, c)


def _split_xtree(ms: ModelStatic):
    """(E_t, r_t) static split of every Xtree, cached on the ModelStatic."""
    if not hasattr(ms, "_xc_tree"):
        ms._xc_tree = [ls.plux_split_static(X) for X in ms.Xtree]
    return ms._xc_tree


def _joint_xc(ms: ModelStatic, i: int, qi):
    """Compact X = XJ(q) @ Xtree: plux(E1,r1)@plux(E2,r2) =
    plux(E1 E2, r2 + E2^T r1).  Revolute: r1 = 0 -> r STATIC = r_t.
    Prismatic: E1 = I -> E STATIC = E_t, r = r_t + E_t^T (axis q)."""
    Et, rt = _split_xtree(ms)[i]
    if ms.jtype[i] == PRISMATIC:
        d = [ls._mul(float(a), qi) for a in ms.axis[i]]
        return [row[:] for row in Et], ls.vadd(rt, ls.mtv3(Et, d))
    s, c = ls.sin(qi), ls.cos(qi)
    EJ = ls.rot3_coord(ms.axis[i], s, c)
    return ls.matmat(EJ, Et), list(rt)


def _root_R(ms: ModelStatic, q):
    """The floating root's active rotation from the q scalar list: from its
    quaternion, or from roll, pitch and yaw."""
    if ms.quat:
        return ls.quat_R(q[3], q[4], q[5], q[6])
    sr, cr = ls.sin(q[3]), ls.cos(q[3])
    sp, cp = ls.sin(q[4]), ls.cos(q[4])
    sy, cy = ls.sin(q[5]), ls.cos(q[5])
    return ls.rpy_R(sr, cr, sp, cp, sy, cy)


def _body_xc(ms: ModelStatic, i: int, q):
    """Compact per-body transform from the full q scalar list (fb root:
    plux(R^T, p) @ Xtree -> E = R^T E_t, r = r_t + E_t^T p)."""
    if ms.fb and i == 0:
        Et, rt = _split_xtree(ms)[0]
        R = _root_R(ms, q)
        Rt = [[R[j][i] for j in range(3)] for i in range(3)]  # R^T
        E = ls.matmat(Rt, Et)
        r = ls.vadd(rt, ls.mtv3(Et, [q[0], q[1], q[2]]))
        return E, r
    return _joint_xc(ms, i, q[ms.qi(i)])


def _body_x(ms: ModelStatic, i: int, q):
    """Dense transform of body i from the full q scalar list (fb root =
    6-DoF rpy+xyz joint, or xyz + wxyz on the quaternion root)."""
    if ms.fb and i == 0:
        return ls.floating_x(ms.Xtree[0], q[0], q[1], q[2], _root_R(ms, q))
    return _joint_x(ms, i, q[ms.qi(i)])


def _vj(ms: ModelStatic, i: int, u):
    """Joint-space velocity/acceleration contribution from a full nv list."""
    if ms.fb and i == 0:
        return list(u[0:6])
    return ls.vscale(u[ms.vi(i)], ms.S[i])


def _xa_chain(ms: ModelStatic, X):
    """World->body compact transforms down the tree: Xa[i] = X[i] o Xa[p]."""
    Xa = [None] * ms.nb
    for i in range(ms.nb):
        p = ms.parent[i]
        Xa[i] = X[i] if p == -1 else ls.xc_compose(X[i], Xa[p])
    return Xa


def _apply_fext_lane(ms: ModelStatic, X, f_list, f_ext):
    """Subtract world-frame wrenches from per-body forces:
    f[i] -= Xa[i]^{-T} f_ext[i], the lane twin of
    dynamics.rnea.apply_external_forces.  f_ext: list of nb 6-lists."""
    Xa = _xa_chain(ms, X)
    return [
        ls.vsub(f_list[i], ls.xc_fvT(Xa[i], f_ext[i]))
        for i in range(ms.nb)
    ]


def rnea_lane(ms: ModelStatic, q, qd, qdd=None, gravity: float = -9.81,
              f_ext=None):
    """Lane-scalar RNEA: q/qd/qdd are lists of lane scalars; f_ext an
    optional list of nb world-frame wrench 6-lists (dynamics.rnea(f_ext)
    semantics).  Returns tau (list of nv lane scalars)."""
    X = [_body_xc(ms, i, q) for i in range(ms.nb)]
    return _rnea_sweeps_lane(ms, X, qd, qdd, gravity, f_ext)[3]


def aba_lane(ms: ModelStatic, q, qd, tau, gravity: float = -9.81, X=None,
             f_ext=None):
    """Lane-scalar ABA: returns qdd (list of nv lane scalars).  Pass
    precomputed COMPACT (E, r) transforms via ``X`` (``_body_xc``) to share
    them with other sweeps.  f_ext: optional list of nb world-frame wrench
    6-lists subtracted from the bias forces (dynamics.aba(f_ext))."""
    nb = ms.nb
    a_grav = [0.0, 0.0, 0.0, 0.0, 0.0, -gravity]
    v, cb, pA = [None] * nb, [None] * nb, [None] * nb
    X = list(X) if X is not None else [None] * nb
    IA = [[row[:] for row in ms.I[i]] for i in range(nb)]
    for i in range(nb):
        p = ms.parent[i]
        Xi = X[i] if X[i] is not None else _body_xc(ms, i, q)
        vJ = _vj(ms, i, qd)
        if p == -1:
            vi = vJ
            ci = ls.vec6(0.0)
        else:
            vi = ls.vadd(ls.xc_mv(Xi, v[p]), vJ)
            ci = ls.cross_motion(vi, vJ)
        Iv = ls.matvec(ms.I[i], vi)
        X[i], v[i], cb[i] = Xi, vi, ci
        pA[i] = ls.cross_force(vi, Iv)

    if f_ext is not None:
        pA = _apply_fext_lane(ms, X, pA, f_ext)

    U, dinv, u_ = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, -1, -1):
        p = ms.parent[i]
        if ms.fb and i == 0:
            # 6-wide root block: solved in the last sweep by cholesky6
            u_[i] = [tau[k] - pA[0][k] for k in range(6)]
            continue
        S = ms.S[i]
        Ui = ls.matvec(IA[i], S)
        di = ls.dot(S, Ui)
        dinv_i = 1.0 / di
        ui = tau[ms.vi(i)] - ls.dot(S, pA[i])
        U[i], dinv[i], u_[i] = Ui, dinv_i, ui
        if p != -1:
            Ia = ls.mat_combine_sym(IA[i], ls.outer_sym(Ui), -dinv_i)
            pa = ls.vadd(
                pA[i],
                ls.vadd(ls.matvec(Ia, cb[i]), ls.vscale(ui * dinv_i, Ui)),
            )
            IA[p] = ls.mat_add_sym(IA[p], ls.xc_xtax_sym(X[i], Ia))
            pA[p] = ls.vadd(pA[p], ls.xc_mtv(X[i], pa))

    qdd = [None] * ms.nv
    acc = [None] * nb
    for i in range(nb):
        p = ms.parent[i]
        if p == -1:
            ai = ls.xc_mv(X[i], a_grav)
        else:
            ai = ls.xc_mv(X[i], acc[p])
        ai = ls.vadd(ai, cb[i])
        if ms.fb and i == 0:
            # S = eye(6): solve IA0 qdd_root = u - IA0 a
            rhs = ls.vsub(u_[0], ls.matvec(IA[0], ai))
            L6 = ls.cholesky6(IA[0])
            qdd_root = ls.cholesky6_solve(L6, rhs)
            for k in range(6):
                qdd[k] = qdd_root[k]
            acc[i] = ls.vadd(ai, qdd_root)
        else:
            qdd_i = (u_[i] - ls.dot(U[i], ai)) * dinv[i]
            acc[i] = ls.vadd(ai, ls.vscale(qdd_i, ms.S[i]))
            qdd[ms.vi(i)] = qdd_i
    return qdd


def _integrate_q_lane(ms: ModelStatic, q_s, qd_new, dt):
    """Lane twin of the semi-implicit position update: flat q + dt*qd' for
    1-DoF/rpy coordinates, manifold retraction for a quaternion root
    (p' = p + dt R(quat) v', quat' = quat (x) exp(dt w'), as
    solver.integrate).  Returns the nq-list q'."""
    if not (ms.fb and ms.quat):
        return [q_s[i] + dt * qd_new[i] for i in range(ms.nq)]
    R = ls.quat_R(q_s[3], q_s[4], q_s[5], q_s[6])
    w, v = qd_new[0:3], qd_new[3:6]
    p_new = [
        q_s[k] + dt * (R[k][0] * v[0] + R[k][1] * v[1] + R[k][2] * v[2])
        for k in range(3)
    ]
    quat_new = ls.quat_step(q_s[3], q_s[4], q_s[5], q_s[6],
                            w[0], w[1], w[2], dt)
    joints = [q_s[7 + j] + dt * qd_new[6 + j] for j in range(ms.nb - 1)]
    return p_new + list(quat_new) + joints


def _fext_lists(ms: ModelStatic, fe):
    """nb*6 packed wrench scalars -> list of nb wrench 6-lists."""
    return [[fe[i * 6 + k] for k in range(6)] for i in range(ms.nb)]


def _step_lane(ms: ModelStatic, q_s, qd_s, u_s, dt, gravity, route="aba",
               dense_minv=False, f_ext=None):
    """One forward-dynamics + semi-implicit-Euler step on lane scalars,
    shared by the per-step and whole-horizon kernels.  Returns
    (q_new, qd_new).  f_ext: optional list of nb wrench 6-lists (world
    frame), with dynamics.aba/forward_dynamics semantics."""
    n = ms.nv
    if route == "minv":
        X = [_body_xc(ms, i, q_s) for i in range(ms.nb)]
        _, _, _, c = _rnea_sweeps_lane(ms, X, qd_s, None, gravity,
                                       f_ext=f_ext)
        uc = [u_s[j] - c[j] for j in range(n)]
        if dense_minv:
            Minv = minv_lane(ms, X)
            qdd = [ls.dot(Minv[i], uc) for i in range(n)]
        else:
            qdd = aba_lane(ms, q_s, [0.0] * n, uc, gravity=0.0, X=X)
    else:
        qdd = aba_lane(ms, q_s, qd_s, u_s, gravity, f_ext=f_ext)
    qd_new = [qd_s[i] + dt * qdd[i] for i in range(n)]
    q_new = _integrate_q_lane(ms, q_s, qd_new, dt)
    return q_new, qd_new


def minv_lane(ms: ModelStatic, X):
    """Lane-scalar direct M^-1 (dense, symmetrised).  X: COMPACT (E, r)
    transform list from ``_body_xc``.  The subtree sparsity of the F
    matrices comes from static-zero folding (columns outside a subtree stay
    python 0.0 and generate no code).  Floating base: the root is one
    6-wide block solved with the unrolled 6x6 lane Cholesky."""
    nb = ms.nb
    n = ms.nv
    Minv = [[0.0] * n for _ in range(n)]
    F = [[ls.vec6(0.0) for _ in range(n)] for _ in range(nb)]
    IA = [[row[:] for row in ms.I[i]] for i in range(nb)]
    U = [None] * nb
    Dinv = [None] * nb
    for i in range(nb - 1, -1, -1):
        p = ms.parent[i]
        if ms.fb and i == 0:
            # root block: U = IA (S = eye), Dinv = IA^-1 via cholesky6
            L6 = ls.cholesky6(IA[0])
            eye_cols = [[1.0 if r == k else 0.0 for r in range(6)]
                        for k in range(6)]
            fbinv_cols = [ls.cholesky6_solve(L6, e) for e in eye_cols]
            fbinv = [[fbinv_cols[k][r] for k in range(6)] for r in range(6)]
            for r in range(6):
                for k in range(6):
                    Minv[r][k] = ls._add(Minv[r][k], fbinv[r][k])
            # Minv[0:6, :] -= fbinv @ (S^T F[0]) with S^T F[0] = F[0]
            for c in range(n):
                col = [F[0][c][j] for j in range(6)]
                corr = [ls.dot(fbinv[r], col) for r in range(6)]
                for r in range(6):
                    Minv[r][c] = ls._add(
                        Minv[r][c], ls._mul(-1.0, corr[r])
                    )
            continue
        S = ms.S[i]
        mi = ms.vi(i)
        Ui = ls.matvec(IA[i], S)
        Dinv_i = 1.0 / ls.dot(S, Ui)
        U[i], Dinv[i] = Ui, Dinv_i
        for c in range(n):
            sF = ls.dot(S, F[i][c])
            if not (ls.is_static(sF) and sF == 0.0):
                Minv[mi][c] = ls._add(Minv[mi][c], ls._mul(-1.0, Dinv_i * sF))
        Minv[mi][mi] = ls._add(Minv[mi][mi], Dinv_i)
        if p != -1:
            for c in range(n):
                Fic = F[i][c]
                if not (ls.is_static(Minv[mi][c]) and Minv[mi][c] == 0.0):
                    Fic = ls.axpy(Minv[mi][c], Ui, Fic)
                F[i][c] = Fic
                F[p][c] = ls.vadd(F[p][c], ls.xc_mtv(X[i], Fic))
            Ia = ls.mat_combine_sym(IA[i], ls.outer_sym(Ui), -Dinv_i)
            IA[p] = ls.mat_add_sym(IA[p], ls.xc_xtax_sym(X[i], Ia))
    for i in range(nb):
        p = ms.parent[i]
        if p == -1:
            if ms.fb and i == 0:
                # S = eye(6): F[0][c] = Minv rows 0:6 at column c
                for c in range(n):
                    F[0][c] = [Minv[r][c] for r in range(6)]
            else:
                for c in range(n):
                    F[i][c] = ls.vscale(Minv[i][c], ms.S[i])
        else:
            mi = ms.vi(i)
            for c in range(n):
                XF = ls.xc_mv(X[i], F[p][c])
                delta = ls._mul(-1.0, ls._mul(Dinv[i], ls.dot(U[i], XF)))
                Minv[mi][c] = ls._add(Minv[mi][c], delta)
                F[i][c] = ls.axpy(Minv[mi][c], ms.S[i], XF)
    # dense symmetrisation (upper triangle is authoritative)
    return [
        [Minv[i][j] if j >= i else Minv[j][i] for j in range(n)]
        for i in range(n)
    ]


def _rnea_sweeps_lane(ms: ModelStatic, X, qd, qdd, gravity, f_ext=None):
    """Forward+backward RNEA given precomputed transforms.  Returns
    (v, a, f_acc, tau): per-body vec6 lists (f accumulated leaf->root),
    tau a length-nv list.  Floating-base aware.  f_ext: optional list of nb
    world-frame wrench 6-lists (subtracted before the backward sweep)."""
    nb = ms.nb
    a_grav = [0.0, 0.0, 0.0, 0.0, 0.0, -gravity]
    v, a, f = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb):
        p = ms.parent[i]
        vJ = _vj(ms, i, qd)
        if p == -1:
            vi = vJ
            ai = ls.xc_mv(X[i], a_grav)
        else:
            vi = ls.vadd(ls.xc_mv(X[i], v[p]), vJ)
            ai = ls.xc_mv(X[i], a[p])
        ai = ls.vadd(ai, ls.cross_motion(vi, vJ))
        if qdd is not None:
            ai = ls.vadd(ai, _vj(ms, i, qdd))
        Iv = ls.matvec(ms.I[i], vi)
        fi = ls.vadd(ls.matvec(ms.I[i], ai), ls.cross_force(vi, Iv))
        v[i], a[i], f[i] = vi, ai, fi
    if f_ext is not None:
        f = _apply_fext_lane(ms, X, f, f_ext)
    tau = [None] * ms.nv
    for i in range(nb - 1, -1, -1):
        p = ms.parent[i]
        if ms.fb and i == 0:
            for k in range(6):
                tau[k] = f[0][k]
        else:
            tau[ms.vi(i)] = ls.dot(ms.S[i], f[i])
        if p != -1:
            f[p] = ls.vadd(f[p], ls.xc_mtv(X[i], f[i]))
    return v, a, f, tau


def _dx_rows(ms: ModelStatic, x, xn):
    """The tangent difference dx (2 nv lane scalars) of the state x from the
    nominal xn (nx-lists): x - xn, or on the quaternion root the manifold
    difference [quat_log_rel, R0^T dp, the flat rows] (rbdtpu
    fused.py:591-608, the lane twin of ``solver.integrate.state_diff``)."""
    nx = ms.nq + ms.nv
    if not (ms.fb and ms.quat):
        return [x[i] - xn[i] for i in range(nx)]
    dth = ls.quat_log_rel(
        (xn[3], xn[4], xn[5], xn[6]), (x[3], x[4], x[5], x[6])
    )
    R0 = ls.quat_R(xn[3], xn[4], xn[5], xn[6])
    d = [x[i] - xn[i] for i in range(3)]
    dp = [
        R0[0][k] * d[0] + R0[1][k] * d[1] + R0[2][k] * d[2]
        for k in range(3)
    ]  # R0^T (p - p_nom): the world delta in the nominal body frame
    return list(dth) + dp + [x[i] - xn[i] for i in range(7, nx)]


def _clamp_lane(u, c):
    """u clamped to [-c, c] for a runtime bound c (a 0-d tensor beside (B,)
    lanes, or the generator's symbolic bound): one operation, NaN staying
    NaN (torch.clamp; rbdtpu's jnp.clip)."""
    if isinstance(u, torch.Tensor):
        return torch.clamp(u, -c, c)
    return u.clamp_sym(c)


def feedback_lane(ms: ModelStatic, x, Xt, Ut, kt, Kt, dt, gravity,
                  u_clip=None, f_ext=None):
    """One knot of the line-search rollout on lane scalars, rbdtpu's
    kernel body (fused.py:695-709): u = U_t + k_t + K_t dx with dx the
    tangent difference from X_t (``_dx_rows``), each u_i clamped to
    [-u_clip_i, u_clip_i] when u_clip is given, then ABA under the
    world wrenches f_ext (nb 6-lists) and the semi-implicit step.  x, Xt:
    nx-lists; Ut, kt: nv-lists; Kt: the nv x 2 nv gain row-major.
    Returns (q', qd', u)."""
    nq, nv = ms.nq, ms.nv
    ndx = 2 * nv
    dx = _dx_rows(ms, x, Xt)
    u = []
    for i in range(nv):
        acc = Ut[i] + kt[i]
        for j in range(ndx):
            acc = acc + Kt[i * ndx + j] * dx[j]
        if u_clip is not None:
            acc = _clamp_lane(acc, u_clip[i])
        u.append(acc)
    q_s, qd_s = x[:nq], x[nq:]
    qdd = aba_lane(ms, q_s, qd_s, u, gravity, f_ext=f_ext)
    qd_new = [qd_s[i] + dt * qdd[i] for i in range(nv)]
    q_new = _integrate_q_lane(ms, q_s, qd_new, dt)
    return q_new, qd_new, u


# ----------------------------------------------------------------------- #
# the model-specialised kernels (``specialize=True``) and their plain      #
# versions, the lane sweeps above on (B,) tensors                          #
# ----------------------------------------------------------------------- #

def _lanes(t):
    """(B, n) -> list of n (B,) lane scalars."""
    return list(t.unbind(-1))


def _stack(vals, ref):
    """List of lane scalars -> (B, n) in ref's dtype on ref's device (a
    static entry filled in)."""
    return torch.stack([v if isinstance(v, torch.Tensor)
                        else ref.new_full((ref.shape[0],), v)
                        for v in vals], -1)


def _fext_lanes(ms: ModelStatic, f_ext, B: int):
    """(nb, 6) or (B, nb, 6) world wrenches -> list of nb 6-lists of (B,)
    lane scalars."""
    return _fext_lists(ms, _lanes(f_ext.expand(B, ms.nb, 6)
                                  .reshape(B, ms.nb * 6)))


def rnea_static_plain(model: RobotModel, q, qd, qdd=None,
                      gravity: float = -9.81):
    """``rnea_lane`` on (B, n) tensors: the plain version of
    ``rnea_static``."""
    tau = rnea_lane(get_static(model), _lanes(q), _lanes(qd),
                    None if qdd is None else _lanes(qdd), gravity)
    return _stack(tau, q)


def fd_step_static_plain(model: RobotModel, x, u, dt: float,
                         gravity: float = -9.81, f_ext=None,
                         route: str = "aba", dense_minv: bool = False):
    """``_step_lane`` on (B, n) tensors: the plain version of
    ``fd_step_static`` (route "aba") and ``fd_step_minv_static`` (route
    "minv", factorised or ``dense_minv``)."""
    ms = get_static(model)
    xs = _lanes(x)
    fe = None if f_ext is None else _fext_lanes(ms, f_ext, x.shape[0])
    q_new, qd_new = _step_lane(ms, xs[:ms.nq], xs[ms.nq:], _lanes(u), dt,
                               gravity, route, dense_minv, fe)
    return _stack(q_new + qd_new, x)


def rollout_static_plain(model: RobotModel, x0, U, dt: float,
                         gravity: float = -9.81, route: str = "aba",
                         f_ext=None):
    """H ``_step_lane`` steps on (B, n) tensors, f_ext None or (H, nb, 6):
    the plain version of ``rollout_multi_static``."""
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    ms = get_static(model)
    B = x0.shape[0]
    xs = _lanes(x0)
    q, qd = xs[:ms.nq], xs[ms.nq:]
    for t in range(U.shape[0]):
        fe = None if f_ext is None else _fext_lanes(ms, f_ext[t], B)
        q, qd = _step_lane(ms, q, qd, _lanes(U[t]), dt, gravity, route,
                           f_ext=fe)
    return _stack(list(q) + list(qd), x0)


def _static_rnea(model: RobotModel, q, qd, qdd, gravity: float):
    """Kernel ``rnea_static``, K10 specialised to the model (kernels/
    codegen.py): one thread a state runs ``rnea_lane``'s straight-line code
    with the model's constants folded in, reading q, qd (and qdd) and
    writing tau.  Replaces rbdtpu's ``rnea_fused`` body (fused.py:391).
    A CPU tensor runs ``rnea_static_plain``."""
    if not q.is_cuda:
        return rnea_static_plain(model, q, qd, qdd, gravity)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    _lib.check(qd, "qd", (B, n), q)
    if qdd is not None:
        _lib.check(qdd, "qdd", (B, n), q)
    tau = torch.empty(B, n, dtype=q.dtype, device=q.device)
    _lib.launch_static("rnea_static", model, q, gravity, q, qd, qdd, tau, B,
                       _lib.STATIC_THREADS)
    return tau


def _static_step(kernel: str, model: RobotModel, x, u, dt: float,
                 gravity: float, f_ext, dense_minv: bool = False):
    """Kernels ``fd_step_static`` (K1) and ``fd_step_minv_static`` (K6, on
    the factorised or the dense route) specialised to the model: one
    thread a state runs ``_step_lane``'s straight-line code (kernels/
    codegen.py), with f_ext (nb, 6) or (B, nb, 6).  Replace the bodies of
    rbdtpu's ``fd_step_fused`` (fused.py:484) and ``fd_step_minv_fused``
    (fused.py:1307).  A CPU tensor runs ``fd_step_static_plain``."""
    minv = kernel == "fd_step_minv_static"
    if not x.is_cuda:
        return fd_step_static_plain(model, x, u, dt, gravity, f_ext,
                                    "minv" if minv else "aba", dense_minv)
    B = x.shape[0]
    _lib.check(x, "x", (B, model.nx), x)
    _lib.check(u, "u", (B, model.nv), x)
    fe, stride = _fext_arg(model, f_ext, B, x)
    xo = torch.empty_like(x)
    _lib.launch_static(kernel, model, x, gravity, x, u, fe, stride, xo, B,
                       *((int(dense_minv),) if minv else ()),
                       _lib.STATIC_THREADS, dt)
    return xo


def _static_rollout(model: RobotModel, x0, U, dt: float, gravity: float,
                    route: str, f_ext):
    """Kernel ``rollout_multi_static``, K5 specialised to the model: one
    thread a trajectory loops over the H steps, each the step body of
    ``fd_step_static`` ("aba") or of ``fd_step_minv_static``'s factorised
    route ("minv") under the knot's wrenches f_ext[t] ((H, nb, 6)), with
    the body inlined and the state in registers between steps, and writes
    the final state.  Replaces
    rbdtpu's ``rollout_fused_multi`` body (fused.py:1111).  A CPU tensor
    runs ``rollout_static_plain``."""
    if not x0.is_cuda:
        return rollout_static_plain(model, x0, U, dt, gravity, route, f_ext)
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    H, B = U.shape[0], x0.shape[0]
    _lib.check(x0, "x0", (B, model.nx), x0)
    _lib.check(U, "U", (H, B, model.nv), x0)
    if f_ext is not None:
        _lib.check(f_ext, "f_ext", (H, model.nb, 6), x0)
    xo = torch.empty_like(x0)
    _lib.launch_static("rollout_multi_static", model, x0, gravity, x0, U,
                       f_ext, xo, B, H, int(route == "minv"),
                       _lib.STATIC_THREADS, dt)
    return xo


def feedback_rollout_static_plain(model: RobotModel, x0, X_nom, U_nom, k_ff,
                                  K_fb, dt: float, gravity: float = -9.81,
                                  u_clip=None, f_ext=None):
    """H ``feedback_lane`` knots on (B, n) tensors, shapes as
    ``feedback_rollout_plain``: the plain version of
    ``feedback_rollout_static``."""
    ms = get_static(model)
    B, H = U_nom.shape[0], U_nom.shape[1]
    uc = None if u_clip is None else list(u_clip.unbind(0))
    x = _lanes(x0)
    xs, us = [], []
    for t in range(H):
        fe = None if f_ext is None else _fext_lanes(ms, f_ext[t], B)
        q_new, qd_new, u = feedback_lane(
            ms, x, _lanes(X_nom[:, t]), _lanes(U_nom[:, t]),
            _lanes(k_ff[:, t]), _lanes(K_fb[:, t].reshape(B, -1)), dt,
            gravity, uc, fe)
        x = list(q_new) + list(qd_new)
        xs.append(_stack(x, x0))
        us.append(_stack(u, x0))
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def _static_feedback(model: RobotModel, x0, X_nom, U_nom, k_ff, K_fb,
                     dt: float, gravity: float, u_clip, f_ext):
    """Kernel ``feedback_rollout_static``, K2 specialised to the model: one
    thread a trajectory loops over the H knots, each ``feedback_lane``'s
    straight-line code (kernels/codegen.py) with K1's ABA step body
    inlined, so the state stays in registers from knot to knot; the gains,
    nominals, the clamp (u_clip, (nv,), read at run time) and the knot's
    world wrenches f_ext[t] ((H, nb, 6)) are read at run time.  Replaces
    rbdtpu's ``feedback_rollout_fused`` body (fused.py:695-709).  A CPU
    tensor runs ``feedback_rollout_static_plain``."""
    if not x0.is_cuda:
        return feedback_rollout_static_plain(model, x0, X_nom, U_nom, k_ff,
                                             K_fb, dt, gravity, u_clip, f_ext)
    _, B, H, Xo, Uo = _feedback_launch_args(
        "feedback_rollout", model, x0, X_nom, U_nom, k_ff, K_fb, u_clip,
        f_ext)
    _lib.launch_static("feedback_rollout_static", model, x0, gravity, x0,
                       X_nom, U_nom, k_ff, K_fb, f_ext, u_clip, Xo, Uo, B, H,
                       _lib.STATIC_THREADS, dt)
    return Xo, Uo
