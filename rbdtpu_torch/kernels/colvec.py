"""The DDP linearisation kernel (K3) beside its plain PyTorch version, and
its model-specialised form (K0): rbdtpu's column-vectorised sweeps.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.

rbdtpu's Pallas body (kernels/colvec.py) holds the derivative and M^-1
columns in the sublanes of a (C, L) tile, a "colscalar", beside the
column-independent (1, L) lane scalars, and injects a column with a
one-hot (C, 1) mask, so its generated code stays O(nb) and not O(nb nv)
(colvec.py:1-20).  ``minv_colvec`` and ``grad_pass_colvec`` below are its
sweeps; run on (B, 1) lanes and (C,) masks they give (B, C) colscalars
(``linearize_parts_static_plain``), and run on the generator's symbols with
the mask ``T(col == i)`` of a thread's own column they write
``linearize_parts_static``, one thread a derivative column
(kernels/codegen.py).
"""
from __future__ import annotations

import torch

from ..dynamics.aba import aba
from ..dynamics.minv import minv
from ..dynamics.rnea_grad import rnea_grad
from ..model.robot import RobotModel
from ..solver.integrate import step_jacobians
from . import _lib
from . import lanescalar as ls
from .fused import (ModelStatic, _body_xc, _lanes, _rnea_sweeps_lane,
                    aba_lane, get_static)


def linearize_parts_plain(model: RobotModel, q, qd, u,
                          gravity: float = -9.81):
    """q (B, nq), qd, u (B, n) -> (Minv (B, n, n) symmetric, dc/dq, dc/dqd
    (B, n, n) indexed [b, row, col], qdd (B, n)); the bias-force gradients
    are taken at the ABA acceleration, dc/dq in the solver's chart (the
    quaternion root's tangent columns)."""
    qdd = aba(model, q, qd, u, gravity=gravity)
    dcq, dcd = rnea_grad(model, q, qd, qdd, gravity, split=True)
    return minv(model, q), dcq, dcd, qdd


def linearize_parts_fused(model: RobotModel, q, qd, u,
                          gravity: float = -9.81, specialize: bool = False):
    """The pieces of ``linearize_parts_plain`` in one launch, for
    fixed-base models and both floating roots.  ``specialize=True`` takes
    the model-specialised kernel ``linearize_parts_static``
    (``_static_linearize``).

    Kernel ``linearize_parts`` (csrc/linearize.cu) replaces rbdtpu's
    ``kernels.colvec.linearize_parts_fused`` (Pallas, colvec.py:289): one
    team of lanes (``_lib.TEAM``) per knot computes the base quantities once
    into shared memory (the team ABA step of csrc/rbd_team.cuh, then the
    RNEA accelerations and forces at its qdd), then runs the 2 nv
    derivative columns and the nv columns of M^-1 one column a lane, each
    walking the bodies in depth-first preorder with one shared-memory slot
    a tree level, so no lane keeps a per-body array on its stack (trees of
    up to ``_lib.LIN_LEVELS`` levels).  Bound on the H100: latency (a
    column's walk over the tree is one dependent chain).  On the rpy root
    the kernel seeds the six root-pose columns of dc/dq analytically (the
    pose enters only through the gravity seed, as in rbdtpu's kernel); on
    the quaternion root ("fq32") its three rotation columns seed w x e_j,
    w the linear part of X_0 a_grav, and its translation columns vanish
    (rbdtpu colvec.py:154-170).  The plain version takes them by
    forward-mode AD, so the two agree to rounding.
    """
    if specialize:
        return _static_linearize(model, q, qd, u, gravity)
    if not q.is_cuda:
        return linearize_parts_plain(model, q, qd, u, gravity)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    _lib.check(qd, "qd", (B, n), q)
    _lib.check(u, "u", (B, n), q)
    Minv = torch.empty(B, n, n, dtype=q.dtype, device=q.device)
    dcq = torch.empty_like(Minv)
    dcd = torch.empty_like(Minv)
    qdd = torch.empty_like(qd)
    _, tpb, smem, _ = _lib.linearize_geometry(
        _lib.size_class("linearize_parts", model), q.dtype, B,
        _lib.sm_count(q.device))
    _lib.launch("linearize_parts", model, q, q, qd, u, Minv, dcq, dcd, qdd,
                B, tpb, smem, gravity)
    return Minv, dcq, dcd, qdd


def linearize_fused(model: RobotModel, q, qd, u, dt: float,
                    gravity: float = -9.81, specialize: bool = False):
    """Discrete-step Jacobians from the kernel's pieces:
    q (B, nq), qd/u (B, n) -> A (B, 2n, 2n), B (B, 2n, n).  The assembly
    (dqdd/dq = -Minv dc/dq, then step_jacobians, which on the quaternion
    root takes the post-step twist qd + dt qdd) is plain torch."""
    Mi, dcq, dcd, qdd = linearize_parts_fused(model, q, qd, u, gravity,
                                              specialize)
    qd_new = qd + dt * qdd if model.root_quat else None
    return step_jacobians(model, Mi, -(Mi @ dcq), -(Mi @ dcd), dt,
                          qd_new=qd_new)


# ----------------------------------------------------------------------- #
# K0: rbdtpu's column-vectorised sweeps (colvec.py:40-254) and its kernel  #
# body (:320-343)                                                          #
# ----------------------------------------------------------------------- #

def _pad8(n: int) -> int:
    return ((n + 7) // 8) * 8


def _make_oh(C: int, ref: torch.Tensor):
    """One-hot (C,) mask selecting derivative column i, in ref's dtype on
    ref's device, built once per column (rbdtpu's iota masks)."""
    cache = {}

    def oh(i: int):
        if i not in cache:
            cache[i] = (torch.arange(C, device=ref.device) == i).to(
                ref.dtype)
        return cache[i]

    return oh


def minv_colvec(ms: ModelStatic, X, oh):
    """Direct analytical M^-1 with the columns in a colscalar (rbdtpu
    colvec.py:63-122).  X: the compact (E, r) transforms (``_body_xc``).
    Returns the n rows of the upper-triangle-authoritative M^-1, each a
    colscalar; callers symmetrise."""
    nb, n = ms.nb, ms.nv
    Minv = [0.0] * n
    F = [ls.vec6(0.0) for _ in range(nb)]
    IA = [[row[:] for row in ms.I[i]] for i in range(nb)]
    U, Dinv = [None] * nb, [None] * nb
    for i in range(nb - 1, -1, -1):
        p = ms.parent[i]
        if ms.fb and i == 0:
            # the 6-wide root block by the unrolled Cholesky (S = eye(6)),
            # filled over all nv columns
            L6 = ls.cholesky6(IA[0])
            eye_cols = [[1.0 if r == k else 0.0 for r in range(6)]
                        for k in range(6)]
            fbinv_cols = [ls.cholesky6_solve(L6, e) for e in eye_cols]
            fbinv = [[fbinv_cols[k][r] for k in range(6)] for r in range(6)]
            for r in range(6):
                acc = Minv[r]
                for k in range(6):
                    acc = ls._add(acc, ls._mul(oh(k), fbinv[r][k]))
                corr = ls.dot(fbinv[r], F[0])
                Minv[r] = ls._add(acc, ls._mul(-1.0, corr))
            continue
        S = ms.S[i]
        mi = ms.vi(i)
        Ui = ls.matvec(IA[i], S)
        Dinv_i = 1.0 / ls.dot(S, Ui)
        U[i], Dinv[i] = Ui, Dinv_i
        sF = ls.dot(S, F[i])
        Minv[mi] = ls._add(Minv[mi], ls._mul(-1.0, ls._mul(Dinv_i, sF)))
        Minv[mi] = ls._add(Minv[mi], ls._mul(oh(mi), Dinv_i))
        if p != -1:
            F[i] = [ls._add(F[i][r], ls._mul(Minv[mi], Ui[r]))
                    for r in range(6)]
            F[p] = ls.vadd(F[p], ls.xc_mtv(X[i], F[i]))
            Ia = ls.mat_combine_sym(IA[i], ls.outer_sym(Ui), -Dinv_i)
            IA[p] = ls.mat_add_sym(IA[p], ls.xc_xtax_sym(X[i], Ia))
    for i in range(nb):
        p = ms.parent[i]
        if p == -1:
            if ms.fb and i == 0:
                F[0] = [Minv[r] for r in range(6)]
            else:
                F[i] = [ls._mul(Minv[i], s) for s in ms.S[i]]
        else:
            mi = ms.vi(i)
            XF = ls.xc_mv(X[i], F[p])
            delta = ls._mul(-1.0, ls._mul(Dinv[i], ls.dot(U[i], XF)))
            Minv[mi] = ls._add(Minv[mi], delta)
            F[i] = [ls._add(ls._mul(Minv[mi], ms.S[i][r]), XF[r])
                    for r in range(6)]
    return Minv


def grad_pass_colvec(ms: ModelStatic, X, q, qd, v, a, f, oh, wrt: str,
                     gravity: float):
    """One derivative sweep of the bias forces, wrt "q" or "qd", with the
    columns in a colscalar (rbdtpu colvec.py:129-254): the n rows of
    dc/dq or dc/dqd.  The floating root's pose columns are analytic: the
    pose enters only through the gravity seed, so the translation columns
    vanish and the rotation columns seed da_0 (the rpy root's three Euler
    columns by dR/dtheta_j, :174-192; the quaternion root's tangent
    rotations as w x e_j, :154-172); the root's dqd columns are the
    identity block (:195-201)."""
    nb, n = ms.nb, ms.nv
    a_grav = [0.0, 0.0, 0.0, 0.0, 0.0, -gravity]
    dv, da, df = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb):
        p = ms.parent[i]
        Xi = X[i]
        if ms.fb and i == 0:
            if wrt == "q":
                dv_i = ls.vec6(0.0)
                da_i = ls.vec6(0.0)
                if ms.quat:
                    a0 = ls.xc_mv(Xi, a_grav)
                    w0, w1, w2 = a0[3], a0[4], a0[5]
                    neg = lambda t: ls._mul(-1.0, t)
                    cols = (
                        (0.0, w2, neg(w1)),       # w x e_0
                        (neg(w2), 0.0, w0),       # w x e_1
                        (w1, neg(w0), 0.0),       # w x e_2
                    )
                    for j in range(3):
                        for k in range(3):
                            da_i[3 + k] = ls._add(
                                da_i[3 + k], ls._mul(oh(j), cols[j][k])
                            )
                else:
                    g6 = ls.matvec(ls.mat_from_static(ms.Xtree[0]), a_grav)
                    gl = g6[3:6]
                    sr, cr = ls.sin(q[3]), ls.cos(q[3])
                    sp, cp = ls.sin(q[4]), ls.cos(q[4])
                    sy, cy = ls.sin(q[5]), ls.cos(q[5])
                    dRs = ls.rpy_dR(sr, cr, sp, cp, sy, cy)
                    for j, dR in enumerate(dRs):
                        for k in range(3):
                            u_k = 0.0
                            for m in range(3):
                                u_k = ls._add(u_k, ls._mul(dR[m][k], gl[m]))
                            da_i[3 + k] = ls._add(
                                da_i[3 + k], ls._mul(oh(3 + j), u_k)
                            )
                df_i = ls.matvec(ms.I[i], da_i)
            else:
                dv_i = [oh(r) for r in range(6)]
                da_i = ls.vec6(0.0)
                Iv = ls.matvec(ms.I[i], v[i])
                df_i = ls.vadd(
                    ls.cross_force(dv_i, Iv),
                    ls.cross_force(v[i], ls.matvec(ms.I[i], dv_i)),
                )
            dv[i], da[i], df[i] = dv_i, da_i, df_i
            continue
        S = ms.S[i]
        ci = ms.vi(i)
        qd_i = qd[ci]
        if p == -1:
            dv_i = ls.vec6(0.0)
            da_b = ls.vec6(0.0)
            Xa_ref = ls.xc_mv(Xi, a_grav)
        else:
            dv_i = ls.xc_mv(Xi, dv[p])
            da_b = ls.xc_mv(Xi, da[p])
            Xa_ref = ls.xc_mv(Xi, a[p])
        if wrt == "q":
            if p != -1:
                Xv = ls.xc_mv(Xi, v[p])
                inj = ls.cross_motion(Xv, S)
                dv_i = [ls._add(dv_i[r], ls._mul(oh(ci), inj[r]))
                        for r in range(6)]
        else:
            dv_i = [ls._add(dv_i[r], ls._mul(oh(ci), S[r]))
                    for r in range(6)]
        cm = ls.cross_motion(dv_i, S)
        da_i = [ls._add(da_b[r], ls._mul(qd_i, cm[r])) for r in range(6)]
        inj_a = ls.cross_motion(Xa_ref if wrt == "q" else v[i], S)
        da_i = [ls._add(da_i[r], ls._mul(oh(ci), inj_a[r]))
                for r in range(6)]
        Iv = ls.matvec(ms.I[i], v[i])
        df_i = ls.vadd(
            ls.vadd(ls.matvec(ms.I[i], da_i), ls.cross_force(dv_i, Iv)),
            ls.cross_force(v[i], ls.matvec(ms.I[i], dv_i)),
        )
        dv[i], da[i], df[i] = dv_i, da_i, df_i

    dc = [0.0] * n
    for i in range(nb - 1, -1, -1):
        p = ms.parent[i]
        if ms.fb and i == 0:
            for k in range(6):
                dc[k] = df[0][k]
            continue
        S = ms.S[i]
        ci = ms.vi(i)
        dc[ci] = ls.dot(S, df[i])
        if p != -1:
            df[p] = ls.vadd(df[p], ls.xc_mtv(X[i], df[i]))
            if wrt == "q":
                # crf(S) f (not -f x S: that identity is revolute-only)
                delta = ls.xc_mtv(X[i], ls.cross_force(S, f[i]))
                df[p] = [ls._add(df[p][r], ls._mul(oh(ci), delta[r]))
                         for r in range(6)]
    return dc


def linearize_lane(ms: ModelStatic, q, qd, u, oh, gravity: float):
    """rbdtpu's K3 body (colvec.py:320-330): the compact transforms, ABA's
    qdd, RNEA's v, a, f at that qdd, then ``minv_colvec`` and the two
    ``grad_pass_colvec`` sweeps.  Returns (the n rows of the unsymmetrised
    M^-1, of dc/dq and of dc/dqd, each a colscalar; qdd, nv lane
    scalars)."""
    X = [_body_xc(ms, i, q) for i in range(ms.nb)]
    qdd = aba_lane(ms, q, qd, u, gravity, X=X)
    v, a, f, _ = _rnea_sweeps_lane(ms, X, qd, qdd, gravity)
    Minv = minv_colvec(ms, X, oh)
    dcq = grad_pass_colvec(ms, X, q, qd, v, a, f, oh, "q", gravity)
    dcd = grad_pass_colvec(ms, X, q, qd, v, a, f, oh, "qd", gravity)
    return Minv, dcq, dcd, qdd


def linearize_parts_static_plain(model: RobotModel, q, qd, u,
                                 gravity: float = -9.81):
    """``linearize_lane`` on (B, 1) lanes and (nv,) one-hot masks, so each
    colscalar is a (B, nv) tensor: the plain version of
    ``linearize_parts_static``.  Returns (Minv symmetrised from its upper
    triangle as rbdtpu does (colvec.py:365), dc/dq, dc/dqd, qdd), shapes
    as ``linearize_parts_plain``."""
    ms = get_static(model)
    B, n = q.shape[0], ms.nv
    col = lambda t: [c[:, None] for c in _lanes(t)]
    Minv, dcq, dcd, qdd = linearize_lane(ms, col(q), col(qd), col(u),
                                         _make_oh(n, q), gravity)
    full = lambda rows, C: torch.stack(
        [r.expand(B, C) if isinstance(r, torch.Tensor)
         else q.new_full((B, C), r) for r in rows], 1)
    Mi = full(Minv, n)
    Mi = torch.triu(Mi) + torch.triu(Mi, 1).transpose(-1, -2)
    return Mi, full(dcq, n), full(dcd, n), full(qdd, 1)[:, :, 0]


def _static_linearize(model: RobotModel, q, qd, u, gravity: float):
    """Kernel ``linearize_parts_static``, K3 specialised to the model
    (kernels/codegen.py): one thread a derivative column, nv threads a
    knot, each running ``linearize_lane``'s straight-line code with its
    column's one-hot as the runtime value T(col == i) and computing the
    column-independent transforms, qdd, v, a and f itself; it writes its
    column of dc/dq and dc/dqd and its column of M^-1's upper triangle
    with the mirror entries, and column 0 writes qdd.  Replaces rbdtpu's
    ``linearize_parts_fused`` body (colvec.py:320-343, :365).  A CPU
    tensor runs ``linearize_parts_static_plain``."""
    if not q.is_cuda:
        return linearize_parts_static_plain(model, q, qd, u, gravity)
    B, n = q.shape[0], model.nv
    _lib.check(q, "q", (B, model.nq), q)
    _lib.check(qd, "qd", (B, n), q)
    _lib.check(u, "u", (B, n), q)
    Minv = torch.empty(B, n, n, dtype=q.dtype, device=q.device)
    dcq = torch.empty_like(Minv)
    dcd = torch.empty_like(Minv)
    qdd = torch.empty_like(qd)
    _lib.launch_static("linearize_parts_static", model, q, gravity, q, qd, u,
                       Minv, dcq, dcd, qdd, B, _lib.STATIC_THREADS)
    return Minv, dcq, dcd, qdd
