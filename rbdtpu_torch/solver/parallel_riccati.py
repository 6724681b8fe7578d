"""Parallel-in-time Riccati sweep (``rbdtpu.solver.parallel_riccati``).

Each knot's conditional value function is an associative element
e = (A, b, C, eta, J) (Särkkä & García-Fernández, IEEE TAC 2021), with the
combine of ``_combine``; the suffix combines e_k (x) ... (x) e_H give every
knot's value function V_k(dx) = 0.5 dx' J dx - eta' dx in O(log H) depth,
and the gains then come from one batched pointwise pass.  Cross terms lux
are removed up front by completing the square and the control
regularisation folds into luu, so this solves the EXACT regularised LQR
subproblem (the sequential ``solver.ddp.backward_pass`` uses the mixed
convention: the same solutions at convergence, slightly different
iterates).

rbdtpu runs the suffix combines with ``jax.lax.associative_scan``; torch has
none, so ``_suffix_scan`` is a Hillis-Steele scan over the time axis:
ceil(log2(H + 1)) rounds, each one batched ``_combine`` of every element
with the one ``d`` knots later (7 rounds at H = 100).  Small products are
plain ``@``; the PD flag comes from ``cholesky_small``, whose non-PD result
is NaN, never an error.
"""
from __future__ import annotations

import torch

from ..spatial.ops import (
    cholesky_small, cholesky_solve_small, mtv, mv, solve_small,
)


def _elements(A, B, lx, lu, lxx, luu_reg, lux, lfx, lfxx):
    """Leaf elements for every knot and the terminal element.

    Inputs carry time on axis -3 (matrices) / -2 (vectors) with arbitrary
    leading batch dims; outputs gain a leading time axis of length H+1."""
    # complete the square: remove the lux cross terms
    L = cholesky_small(luu_reg)
    Ki = cholesky_solve_small(L, lux)  # luu^-1 lux
    ki = cholesky_solve_small(L, lu)  # luu^-1 lu
    A_t = A - B @ Ki
    lxx_t = lxx - lux.mT @ Ki
    lx_t = lx - mtv(lux, ki)
    b_t = -mv(B, ki)
    C_t = B @ cholesky_solve_small(L, B.mT)
    eta_t = -lx_t
    J_t = lxx_t

    elems = (A_t.movedim(-3, 0), b_t.movedim(-2, 0), C_t.movedim(-3, 0),
             eta_t.movedim(-2, 0), J_t.movedim(-3, 0))
    # terminal element: pure cost, no dynamics
    zero_m = torch.zeros_like(elems[0][0])
    term = (zero_m, torch.zeros_like(elems[1][0]), zero_m, -lfx, lfxx)
    return tuple(torch.cat([s, t[None]]) for s, t in zip(elems, term))


def _combine(ej, ei):
    """e_i (x) e_j of the EARLIER segment e_i and the LATER e_j (rbdtpu's
    argument order: the later segment first)."""
    A_j, b_j, C_j, eta_j, J_j = ej
    A_i, b_i, C_i, eta_i, J_i = ei
    nx = A_i.shape[-1]
    eye = torch.eye(nx, dtype=A_i.dtype, device=A_i.device)
    # D [A_i, b_i + C_i eta_j, C_i] with D = (I + C_i J_j)^-1, one solve
    D_rhs = torch.cat([A_i, (b_i + mv(C_i, eta_j))[..., None], C_i], -1)
    D_sol = solve_small(eye + C_i @ J_j, D_rhs)
    DA, Db, DC = D_sol[..., :nx], D_sol[..., nx], D_sol[..., nx + 1:]
    A = A_j @ DA
    b = mv(A_j, Db) + b_j
    C = A_j @ DC @ A_j.mT + C_j
    E_rhs = torch.cat([(eta_j - mv(J_j, b_i))[..., None], J_j @ A_i], -1)
    E_sol = solve_small(eye + J_j @ C_i, E_rhs)
    eta = mtv(A_i, E_sol[..., 0]) + eta_i
    J = A_i.mT @ E_sol[..., 1:] + J_i
    return A, b, C, eta, J


def _suffix_scan(elems):
    """Every suffix combine S_k = e_k (x) ... (x) e_H of the time-major
    elements (H+1 along dim 0): after the round with offset d, S_k covers
    knots k .. k + 2d - 1."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        new = _combine(tuple(s[d:] for s in elems),
                       tuple(s[:-d] for s in elems))
        elems = tuple(torch.cat([c, s[n - d:]]) for c, s in zip(new, elems))
        d *= 2
    return elems


def backward_pass_parallel(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg):
    """Drop-in alternative to ``solver.ddp.backward_pass`` with O(log H)
    depth: the same inputs (time on axis -3/-2, arbitrary leading batch;
    lxx/luu/lux per knot or constant) and outputs (k, K, dV1, ok), for the
    exactly regularised LQR subproblem (reg folded into luu)."""
    nu, nx = lu.shape[-1], A.shape[-1]
    batch = lfx.shape[:-1]
    eye_u = torch.eye(nu, dtype=lu.dtype, device=lu.device)
    # constant cost blocks broadcast to the per-knot shape the scan streams
    bh = lu.shape[:-1]
    fix = lambda x, tail: x.expand(bh + tail) if x.dim() == 2 else x
    lxx, luu, lux = fix(lxx, (nx, nx)), fix(luu, (nu, nu)), fix(lux, (nu, nx))
    reg = torch.as_tensor(reg, dtype=lu.dtype, device=lu.device)
    luu_reg = luu + reg.expand(batch)[..., None, None, None] * eye_u

    S = _suffix_scan(_elements(A, B, lx, lu, lxx, luu_reg, lux, lfx, lfxx))
    # the value at k+1 for the gains at k
    Vxx = S[4][1:].movedim(0, -3)  # (..., H, nx, nx)
    Vx = -S[3][1:].movedim(0, -2)  # (..., H, nx)

    Qu = lu + mtv(B, Vx)
    Qux = lux + B.mT @ (Vxx @ A)
    Quu_reg = luu_reg + B.mT @ (Vxx @ B)
    L = cholesky_small(Quu_reg)
    pd = torch.isfinite(L).all(-1).all(-1).all(-1)
    k = -cholesky_solve_small(L, Qu)
    K = -cholesky_solve_small(L, Qux)
    dV1 = (k * Qu).sum((-1, -2))
    return k, K, dV1, pd
