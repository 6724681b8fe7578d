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

import torch

from ..dynamics.aba import aba
from ..dynamics.fd import forward_dynamics
from ..dynamics.rnea import rnea
from ..model.robot import RobotModel
from ..solver.integrate import euler_semi_implicit, split_state, state_diff
from ..spatial.ops import mv
from . import _lib


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
                  f_ext=None):
    """One forward-dynamics step x (B, nx), u (B, nv) -> x' (B, nx), with
    optional world-frame wrenches f_ext, (nb, 6) shared by the batch or
    (B, nb, 6).  On the quaternion root (nx = 2 nv + 1) the step retracts
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


def rnea_fused(model: RobotModel, q, qd, qdd=None, gravity: float = -9.81):
    """RNEA joint forces in one launch: q, qd and optional qdd (B, n) ->
    tau (B, n).

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
                       f_ext=None):
    """One forward-dynamics step on the M^-1 + RNEA route (BASELINE.json
    configs[1]): x (B, nx), u (B, nv) -> x' (B, nx), with optional wrenches
    f_ext, (nb, 6) or (B, nb, 6).

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
                        f_ext=None):
    """The whole horizon in one launch: x0 (B, nx), U (H, B, nv)
    scan-major -> final state (B, nx).  route "aba" (O(n) articulated
    step) or "minv" (bias RNEA + factorised M^-1 apply, BASELINE.json
    configs[1]); f_ext None or (H, nb, 6) per-knot world wrenches shared by
    the batch.

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
                           f_ext=None):
    """The line-search rollout of ``feedback_rollout_plain``, one launch for
    the whole horizon.

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
