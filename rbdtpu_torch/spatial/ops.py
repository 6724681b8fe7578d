"""Spatial-vector algebra (Featherstone 6-D motion/force operators) on
``(..., 6)`` / ``(..., 6, 6)`` tensors — ``rbdtpu.spatial.ops``, with the
second-order factors (``icrf``, ``factor_inertia``, ``dot_inertia``).

Conventions: motion v = [omega; v_lin], force f = [n; f_lin];
crm(v) m == v x m, crf(v) f == v x* f, crf(v) = -crm(v)^T,
icrf(f) v == crf(v) f.
"""
from __future__ import annotations

import torch


def skew(r):
    """skew(r) @ x == r cross x.  (..., 3) -> (..., 3, 3)."""
    x, y, z = r.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def crm(v):
    """Motion cross-product matrix [[wx, 0], [vx, wx]]: (..., 6) -> (..., 6, 6)."""
    wx = skew(v[..., :3])
    vx = skew(v[..., 3:])
    zero = torch.zeros_like(wx)
    top = torch.cat([wx, zero], dim=-1)
    bot = torch.cat([vx, wx], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crf(v):
    """Force cross-product matrix crf(v) = -crm(v)^T."""
    return -crm(v).transpose(-1, -2)


def icrf(f):
    """Inverse force cross operator: icrf(f) @ v == crf(v) @ f for every
    motion vector v.  (..., 6) -> (..., 6, 6)."""
    nx = skew(f[..., :3])
    fx = skew(f[..., 3:])
    top = torch.cat([nx, fx], dim=-1)
    bot = torch.cat([fx, torch.zeros_like(nx)], dim=-1)
    return -torch.cat([top, bot], dim=-2)


def _cross3(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def cross_motion(v, m):
    """v x m for motion vectors: (..., 6), (..., 6) -> (..., 6)."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    top = _cross3(w, mw)
    bot = _cross3(vl, mw) + _cross3(w, ml)
    return torch.cat([top, bot], dim=-1)


def cross_force(v, f):
    """v x* f for a motion vector v and force vector f: -> (..., 6)."""
    w, vl = v[..., :3], v[..., 3:]
    fn, fl = f[..., :3], f[..., 3:]
    top = _cross3(w, fn) + _cross3(vl, fl)
    bot = _cross3(w, fl)
    return torch.cat([top, bot], dim=-1)


def vxIv(v, I):
    """crf(v) @ (I @ v), the velocity-product bias force: (..., 6),
    (..., 6, 6) -> (..., 6)."""
    return cross_force(v, mv(I, v))


def factor_inertia(I, v):
    """The factor B(I, v) = 1/2 (crf(v) I + icrf(I v) - I crm(v)) of the
    second-order derivatives: (..., 6, 6), (..., 6) -> (..., 6, 6)."""
    return 0.5 * (crf(v) @ I + icrf(mv(I, v)) - I @ crm(v))


def dot_inertia(I, v):
    """crf(v) I - I crm(v): (..., 6, 6), (..., 6) -> (..., 6, 6)."""
    return crf(v) @ I - I @ crm(v)


def mcI(m, c, Ic):
    """Spatial inertia from mass m (...,), COM offset c (..., 3) and the
    rotational inertia about the COM Ic (..., 3, 3):
    [[Ic + m cx cx^T, m cx], [m cx^T, m 1]] -> (..., 6, 6)."""
    cx = skew(c)
    m_ = m[..., None, None]
    cxt = cx.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=Ic.dtype, device=Ic.device).expand(cx.shape)
    top = torch.cat([Ic + m_ * cx @ cxt, m_ * cx], dim=-1)
    bot = torch.cat([m_ * cxt, m_ * eye3], dim=-1)
    return torch.cat([top, bot], dim=-2)


def mv(A, x):
    """A @ x for (..., i, j) x (..., j) -> (..., i)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def mtv(A, x):
    """A^T @ x for (..., j, i) x (..., j) -> (..., i)."""
    return (A.transpose(-1, -2) @ x.unsqueeze(-1)).squeeze(-1)


def xtax(X, A):
    """X^T @ A @ X."""
    return X.transpose(-1, -2) @ A @ X


def cholesky_small(A):
    """Cholesky factor of a small SPD matrix, unrolled over its static size
    (``rbdtpu.spatial.batched.cholesky_small``): (..., n, n) -> L with
    A = L L^T.  A matrix that is not positive definite gives NaN entries
    (the square root of a negative number); it never raises."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], -1)
                        for i in range(n)], -2)


def cholesky_solve_small(L, b):
    """Solve (L L^T) x = b for L = cholesky_small(A) by unrolled forward and
    backward substitution; b (..., n) or (..., n, m)."""
    n = L.shape[-1]
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    y = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def solve_small(A, b):
    """Solve A x = b for a small general A (``rbdtpu.spatial.batched
    .solve_small``): A (..., n, n), b (..., n) or (..., n, m).  rbdtpu
    unrolls Gaussian elimination without pivoting for the TPU's vector
    unit; here one batched LU solve with partial pivoting, which gives the
    same x up to rounding for the well-conditioned systems it is meant for
    (I + PSD PSD in the parallel Riccati combine).  ``solve_ex`` does not
    check for a singular A, so it never waits on the card."""
    vec = b.dim() == A.dim() - 1
    x = torch.linalg.solve_ex(A, b[..., None] if vec else b)[0]
    return x[..., 0] if vec else x
