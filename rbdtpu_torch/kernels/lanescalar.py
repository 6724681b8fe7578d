"""Lane-scalar algebra: the model-specialised form of the tree sweeps.

A lane scalar is one per-state quantity over the batch: a 1-D tensor of
shape (B,), a Python float (a constant of the model, known when the code is
written out), or the generator's symbolic scalar
(``kernels.codegen``).  A spatial vector is a list of 6 lane scalars and a
6x6 matrix a nested list.  All algebra below is written entry-wise, and a
product with a static 0 or a static 1, or a sum with a static 0, generates
nothing (``_add``, ``_mul``): run on tensors this is the plain version of
the specialised kernels, run on symbolic scalars it writes out their
straight-line code with every structural zero of the robot folded away.

The port of rbdtpu's ``kernels/lanescalar.py``, whose Pallas bodies it
mirrors operation for operation.  Where rbdtpu calls ``jnp``/``lax`` (the
trigonometry, square roots, ``maximum``, ``clip`` and ``where``), the
functions ``sin`` ... ``where`` below dispatch on the scalar's type, so one
body of code serves the tensor plain version and the generator.
"""
from __future__ import annotations

import math

import torch

# ----------------------------------------------------------------------- #
# scalars: (B,) tensors, python floats (static constants) or symbols      #
# ----------------------------------------------------------------------- #


def is_static(x) -> bool:
    return isinstance(x, (int, float))


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def sin(x):
    if _is_tensor(x):
        return torch.sin(x)
    return math.sin(x) if is_static(x) else x.call("sin")


def cos(x):
    if _is_tensor(x):
        return torch.cos(x)
    return math.cos(x) if is_static(x) else x.call("cos")


def sqrt(x):
    if _is_tensor(x):
        return torch.sqrt(x)
    return math.sqrt(x) if is_static(x) else x.call("sqrt")


def rsqrt(x):
    if _is_tensor(x):
        return torch.rsqrt(x)
    return 1.0 / math.sqrt(x) if is_static(x) else x.call("rsqrt")


def maximum(x, c: float):
    """max(x, c) for a lane scalar x and a static c (NaN stays NaN)."""
    if _is_tensor(x):
        return torch.clamp_min(x, c)
    return max(x, c) if is_static(x) else x.maximum(c)


def clip(x, lo: float, hi: float):
    """x clamped to [lo, hi] (static bounds)."""
    if _is_tensor(x):
        return torch.clamp(x, lo, hi)
    return min(max(x, lo), hi) if is_static(x) else x.clip(lo, hi)


def where(cond, a, b):
    """a where cond else b, for a comparison ``cond`` of lane scalars (a
    bool tensor, a Python bool, or the generator's symbolic comparison);
    a and b lane scalars or static constants."""
    if isinstance(cond, bool):
        return a if cond else b
    if _is_tensor(cond):
        return torch.where(cond, a, b)
    return cond.select(a, b)


def vec6(fill=0.0):
    return [fill] * 6


def mat66(fill=0.0):
    return [[fill] * 6 for _ in range(6)]


def mat_from_static(M) -> list:
    """6x6 nested list of python floats from an array-like (host constant)."""
    return [[float(M[i][j]) for j in range(6)] for i in range(6)]


def _add(a, b):
    if is_static(a) and a == 0.0:
        return b
    if is_static(b) and b == 0.0:
        return a
    return a + b


def _mul(a, b):
    if (is_static(a) and a == 0.0) or (is_static(b) and b == 0.0):
        return 0.0
    if is_static(a) and a == 1.0:
        return b
    if is_static(b) and b == 1.0:
        return a
    return a * b


def dot(u, v):
    """Inner product of two vec6."""
    acc = 0.0
    for a, b in zip(u, v):
        acc = _add(acc, _mul(a, b))
    return acc


def axpy(alpha, u, v):
    """alpha*u + v entry-wise (alpha scalar)."""
    return [_add(_mul(alpha, a), b) for a, b in zip(u, v)]


def vadd(u, v):
    return [_add(a, b) for a, b in zip(u, v)]


def vsub(u, v):
    return [_add(a, _mul(-1.0, b)) for a, b in zip(u, v)]


def vscale(alpha, u):
    return [_mul(alpha, a) for a in u]


def matvec(M, v):
    """M @ v for 6x6 nested-list M and vec6 v."""
    return [dot(row, v) for row in M]


def matvec_T(M, v):
    """M^T @ v."""
    return [dot([M[j][i] for j in range(6)], v) for i in range(6)]


def matmat(A, B):
    """A @ B for nested lists (any compatible static sizes)."""
    n, m, p = len(A), len(B), len(B[0])
    out = [[0.0] * p for _ in range(n)]
    for i in range(n):
        for j in range(p):
            acc = 0.0
            for k in range(m):
                acc = _add(acc, _mul(A[i][k], B[k][j]))
            out[i][j] = acc
    return out


def matmat_TA(A, B):
    """A^T @ B."""
    n = len(A[0])
    p = len(B[0])
    out = [[0.0] * p for _ in range(n)]
    for i in range(n):
        for j in range(p):
            acc = 0.0
            for k in range(len(A)):
                acc = _add(acc, _mul(A[k][i], B[k][j]))
            out[i][j] = acc
    return out


def outer_vv(u, v):
    return [[_mul(a, b) for b in v] for a in u]


def mat_add(A, B):
    return [[_add(a, b) for a, b in zip(ra, rb)] for ra, rb in zip(A, B)]


def mat_sub(A, B):
    return [[_add(a, _mul(-1.0, b)) for a, b in zip(ra, rb)]
            for ra, rb in zip(A, B)]


def mat_scale(alpha, A):
    return [[_mul(alpha, a) for a in row] for row in A]


def xtax(X, A):
    """X^T @ A @ X."""
    return matmat_TA(X, matmat(A, X))


# ----------------------------------------------------------------------- #
# spatial cross products, entry-wise                                      #
# ----------------------------------------------------------------------- #

def cross_motion(v, m):
    """v x m for motion vectors (crm(v) @ m)."""
    w0, w1, w2, l0, l1, l2 = v
    m0, m1, m2, m3, m4, m5 = m
    return [
        _add(_mul(w1, m2), _mul(-1.0, _mul(w2, m1))),
        _add(_mul(w2, m0), _mul(-1.0, _mul(w0, m2))),
        _add(_mul(w0, m1), _mul(-1.0, _mul(w1, m0))),
        _add(_add(_mul(l1, m2), _mul(-1.0, _mul(l2, m1))),
             _add(_mul(w1, m5), _mul(-1.0, _mul(w2, m4)))),
        _add(_add(_mul(l2, m0), _mul(-1.0, _mul(l0, m2))),
             _add(_mul(w2, m3), _mul(-1.0, _mul(w0, m5)))),
        _add(_add(_mul(l0, m1), _mul(-1.0, _mul(l1, m0))),
             _add(_mul(w0, m4), _mul(-1.0, _mul(w1, m3)))),
    ]


def cross_force(v, f):
    """v x* f for motion v, force f (crf(v) @ f)."""
    w0, w1, w2, l0, l1, l2 = v
    n0, n1, n2, f0, f1, f2 = f
    return [
        _add(_add(_mul(w1, n2), _mul(-1.0, _mul(w2, n1))),
             _add(_mul(l1, f2), _mul(-1.0, _mul(l2, f1)))),
        _add(_add(_mul(w2, n0), _mul(-1.0, _mul(w0, n2))),
             _add(_mul(l2, f0), _mul(-1.0, _mul(l0, f2)))),
        _add(_add(_mul(w0, n1), _mul(-1.0, _mul(w1, n0))),
             _add(_mul(l0, f1), _mul(-1.0, _mul(l1, f0)))),
        _add(_mul(w1, f2), _mul(-1.0, _mul(w2, f1))),
        _add(_mul(w2, f0), _mul(-1.0, _mul(w0, f2))),
        _add(_mul(w0, f1), _mul(-1.0, _mul(w1, f0))),
    ]


# ----------------------------------------------------------------------- #
# joint transform build: X = XJ(q) @ Xtree with static Xtree/axis          #
# ----------------------------------------------------------------------- #

def rot3_coord(axis, s, c):
    """Coordinate rotation E = R(axis, q)^T as a 3x3 nested list with entries
    affine in the lane-scalars s=sin q, c=cos q and STATIC axis coefficients:
    R = I + s K + (1-c) K^2  =>  E = R^T = I - s K + (1-c) K^2."""
    ax, ay, az = (float(axis[0]), float(axis[1]), float(axis[2]))
    K = [[0.0, -az, ay], [az, 0.0, -ax], [-ay, ax, 0.0]]
    K2 = [[sum(K[i][k] * K[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    E = [[0.0] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            e = 1.0 if i == j else 0.0
            # e - s*K[i][j] + (1-c)*K2[i][j]; fold static zeros
            if K[i][j] != 0.0:
                e = _add(e, _mul(-K[i][j], s))
            if K2[i][j] != 0.0:
                e = _add(e, _mul(K2[i][j], _add(1.0, _mul(-1.0, c))))
            E[i][j] = e
    return E


def revolute_x(axis, Xtree_static, s, c):
    """Spatial transform X = XJ_rev(q) @ Xtree for a revolute joint:
    XJ = blockdiag(E, E)."""
    E = rot3_coord(axis, s, c)
    XJ = mat66(0.0)
    for i in range(3):
        for j in range(3):
            XJ[i][j] = E[i][j]
            XJ[3 + i][3 + j] = E[i][j]
    return matmat(XJ, Xtree_static)


def prismatic_x(axis, Xtree_static, q):
    """X = XJ_pris(q) @ Xtree: XJ = [[I,0],[-skew(axis q), I]]."""
    ax, ay, az = (float(axis[0]), float(axis[1]), float(axis[2]))
    XJ = mat66(0.0)
    for i in range(6):
        XJ[i][i] = 1.0
    # -skew(axis*q) into lower-left
    XJ[3][1] = _mul(az, q)
    XJ[3][2] = _mul(-ay, q)
    XJ[4][0] = _mul(-az, q)
    XJ[4][2] = _mul(ax, q)
    XJ[5][0] = _mul(ay, q)
    XJ[5][1] = _mul(-ax, q)
    return matmat(XJ, Xtree_static)


# ----------------------------------------------------------------------- #
# floating-base root support                                              #
# ----------------------------------------------------------------------- #

def rpy_R(sr, cr, sp, cp, sy, cy):
    """Active rotation R = Rz(yaw) Ry(pitch) Rx(roll) as a 3x3 nested list of
    lane-scalars (URDF rpy convention, spatial.transforms.rpy_to_R)."""
    return [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]


def rpy_dR(sr, cr, sp, cp, sy, cy):
    """(dR/droll, dR/dpitch, dR/dyaw) of the active rotation
    R = Rz(yaw) Ry(pitch) Rx(roll) (``rpy_R``), each a 3x3 nested list of
    lane-scalars."""
    dRr = [
        [0.0, cy * sp * cr + sy * sr, -(cy * sp * sr) + sy * cr],
        [0.0, sy * sp * cr - cy * sr, -(sy * sp * sr) - cy * cr],
        [0.0, cp * cr, -(cp * sr)],
    ]
    dRp = [
        [-(cy * sp), cy * cp * sr, cy * cp * cr],
        [-(sy * sp), sy * cp * sr, sy * cp * cr],
        [-cp, -(sp * sr), -(sp * cr)],
    ]
    dRy = [
        [-(sy * cp), -(sy * sp * sr) - cy * cr, -(sy * sp * cr) + cy * sr],
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [0.0, 0.0, 0.0],
    ]
    return dRr, dRp, dRy


def quat_R(w, x, y, z):
    """Active rotation of a quaternion (wxyz lane-scalars) as a 3x3 nested
    list.  Norm-robust form (s = 2/|q|^2), so drift away from unit norm
    during long rollouts stays a rotation."""
    n2 = w * w + x * x + y * y + z * z
    s = 2.0 / n2
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return [
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ]


def quat_step(qw, qx, qy, qz, wx, wy, wz, dt):
    """Manifold Euler update of a root quaternion (lane-scalars):
    q' = normalize(q (x) exp(dt * [wx, wy, wz] / 2)), the lane twin of
    solver.integrate's rotation retraction.  Returns (w, x, y, z).

    The sinc is computed with a small-angle Taylor switch (``where``; both
    branches finite)."""
    ax, ay, az = dt * wx, dt * wy, dt * wz
    n2 = ax * ax + ay * ay + az * az
    n = sqrt(maximum(n2, 1e-24))
    half = 0.5 * n
    small = n2 < 1e-12
    ew = where(small, 1.0 - n2 / 8.0, cos(half))
    es = where(small, 0.5 - n2 / 48.0, sin(half) / n)
    ex, ey, ez = es * ax, es * ay, es * az
    # Hamilton product q (x) e
    nw = qw * ew - qx * ex - qy * ey - qz * ez
    nx = qw * ex + qx * ew + qy * ez - qz * ey
    ny = qw * ey - qx * ez + qy * ew + qz * ex
    nz = qw * ez + qx * ey - qy * ex + qz * ew
    inv = rsqrt(nw * nw + nx * nx + ny * ny + nz * nz)
    return inv * nw, inv * nx, inv * ny, inv * nz


def _atan2_pos(n, w):
    """atan2(n, w) for n >= 0, w >= 0 (first quadrant) from square roots and
    a polynomial, as rbdtpu computes it (its TPU lowering has no atan):
    atan2(n, w) = 2 atan(t), t = n/(w + hypot(w, n)) in [0, 1]; three
    cotangent half-angle reductions t <- t/(1 + sqrt(1 + t^2)) bring the
    argument under tan(pi/32), where the degree-13 odd Taylor polynomial of
    atan is accurate to ~1e-16 relative."""
    t = n / (w + sqrt(w * w + n * n))
    for _ in range(3):
        t = t / (1.0 + sqrt(1.0 + t * t))
    z = t * t
    p = 1.0 / 13.0
    for c in (11.0, 9.0, 7.0, 5.0, 3.0):
        p = 1.0 / c - z * p
    return 16.0 * t * (1.0 - z * p)


def quat_log_rel(q0, q1):
    """Rotation-vector log of conj(q0) (x) q1 on lane-scalars, the lane twin
    of spatial.quat's quat_log(quat_mul(quat_conj(q0), q1)), including the
    minimal-rotation sign fix and the small-angle Taylor branch (the same
    1e-12 squared-angle threshold).  q0/q1 are (w, x, y, z) 4-tuples;
    returns the 3-tuple tangent."""
    aw, ax, ay, az = q0
    bw, bx, by, bz = q1
    # Hamilton product conj(a) (x) b
    rw = aw * bw + ax * bx + ay * by + az * bz
    rx = aw * bx - ax * bw - ay * bz + az * by
    ry = aw * by + ax * bz - ay * bw - az * bx
    rz = aw * bz - ax * by + ay * bx - az * bw
    # the minimal-rotation sign fix by a factor in {-1, 1}, as rbdtpu
    sgn = where(rw < 0, -1.0, 1.0)
    rw, rx, ry, rz = sgn * rw, sgn * rx, sgn * ry, sgn * rz
    w = clip(rw, -1.0, 1.0)
    n2 = rx * rx + ry * ry + rz * rz
    n = sqrt(maximum(n2, 1e-12))
    angle = 2.0 * _atan2_pos(n, w)  # w >= 0 after the sign fix above
    small = n2 < 1e-12
    scale = where(small, 2.0 / maximum(w, 0.5), angle / n)
    return scale * rx, scale * ry, scale * rz


def floating_x(Xtree_static, px, py, pz, R):
    """Spatial motion transform of the floating 6-DoF root:
    X = plux(R^T, p) @ Xtree  (world -> body)."""
    E = [[R[j][i] for j in range(3)] for i in range(3)]
    # -E @ skew(p)
    sk = [[0.0, _mul(-1.0, pz), py],
          [pz, 0.0, _mul(-1.0, px)],
          [_mul(-1.0, py), px, 0.0]]
    Esk = [[0.0] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = 0.0
            for k in range(3):
                acc = _add(acc, _mul(E[i][k], sk[k][j]))
            Esk[i][j] = _mul(-1.0, acc)
    X = mat66(0.0)
    for i in range(3):
        for j in range(3):
            X[i][j] = E[i][j]
            X[3 + i][3 + j] = E[i][j]
            X[3 + i][j] = Esk[i][j]
    return matmat(X, Xtree_static)


# ----------------------------------------------------------------------- #
# compact Plücker transforms: X = plux(E, r) = [[E, 0], [-E r̂, E]]         #
#                                                                         #
# A spatial transform is fully determined by its 3x3 rotation E and        #
# translation r, and for every 1-DoF joint X = XJ(q) @ Xtree has r =       #
# Xtree's STATIC translation (plux(E1,r1) @ plux(E2,r2) = plux(E1 E2,      #
# r2 + E2^T r1); XJ has r1 = 0).  Costs per op (dense -> compact): matvec  #
# 66 -> ~39, matvec_T 66 -> ~39, symmetric congruence X^T A X 1452 ->      #
# ~400, live scalars 36 -> 9.                                             #
# ----------------------------------------------------------------------- #

def plux_split_static(X66):
    """Host-side: static dense 6x6 motion transform -> (E, r) python floats.
    X = [[E, 0], [-E r̂, E]]  =>  r̂ = -E^T @ X[3:6, 0:3]."""
    E = [[float(X66[i][j]) for j in range(3)] for i in range(3)]
    BL = [[float(X66[3 + i][j]) for j in range(3)] for i in range(3)]
    rh = [
        [-sum(E[k][i] * BL[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]
    return E, [rh[2][1], rh[0][2], rh[1][0]]


def cross3(a, b):
    """a x b for 3-lists of lane-scalars/statics (static entries fold)."""
    return [
        _add(_mul(a[1], b[2]), _mul(-1.0, _mul(a[2], b[1]))),
        _add(_mul(a[2], b[0]), _mul(-1.0, _mul(a[0], b[2]))),
        _add(_mul(a[0], b[1]), _mul(-1.0, _mul(a[1], b[0]))),
    ]


def mv3(E, a):
    """E @ a for 3x3 nested E, 3-list a."""
    return [dot(E[i], a) for i in range(3)]


def mtv3(E, a):
    """E^T @ a."""
    return [dot([E[k][i] for k in range(3)], a) for i in range(3)]


def xc_mv(X, m):
    """Compact X @ m (== dense matvec for any 6-vector):
    [E a; E (b - r x a)] with m = [a; b]."""
    E, r = X
    a, b = m[0:3], m[3:6]
    rxa = cross3(r, a)
    t = [_add(bi, _mul(-1.0, ci)) for bi, ci in zip(b, rxa)]
    return mv3(E, a) + mv3(E, t)


def xc_compose(X1, X2):
    """Compact composition plux(E1, r1) @ plux(E2, r2) =
    plux(E1 E2, r2 + E2^T r1): the world->body chain of the external-force
    application (dynamics.rnea.apply_external_forces)."""
    (E1, r1), (E2, r2) = X1, X2
    return matmat(E1, E2), vadd(r2, mtv3(E2, r1))


def xc_fvT(X, w):
    """X^{-T} w: world-frame wrench w = [n; f] into the frame X maps to.
    For X = plux(E, r): X^{-T} = [[E, -E r̂], [0, E]], so
    n' = E (n - r x f), f' = E f (dynamics.xforms.x_force_inv_T, compact)."""
    E, r = X
    n_, fl = w[0:3], w[3:6]
    rxf = cross3(r, fl)
    t = [_add(ni, _mul(-1.0, ci)) for ni, ci in zip(n_, rxf)]
    return mv3(E, t) + mv3(E, fl)


def xc_mtv(X, f):
    """Compact X^T @ f (== dense matvec_T for any 6-vector):
    [E^T n + r x (E^T fl); E^T fl] with f = [n; fl]."""
    E, r = X
    n_, fl = f[0:3], f[3:6]
    t = mtv3(E, fl)
    top = [_add(x, y) for x, y in zip(mtv3(E, n_), cross3(r, t))]
    return top + t


def _rot_sym3(E, S):
    """E^T S E for SYMMETRIC 3x3 S; returns symmetric nested list with
    aliased lower triangle."""
    T = [
        [dot([E[k][i] for k in range(3)], [S[k][j] for k in range(3)])
         for j in range(3)]
        for i in range(3)
    ]
    C = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            C[i][j] = dot(T[i], [E[k][j] for k in range(3)])
            C[j][i] = C[i][j]
    return C


def _rot_full3(E, B):
    """E^T B E for general 3x3 B."""
    T = [
        [dot([E[k][i] for k in range(3)], [B[k][j] for k in range(3)])
         for j in range(3)]
        for i in range(3)
    ]
    return [
        [dot(T[i], [E[k][j] for k in range(3)]) for j in range(3)]
        for i in range(3)
    ]


def xc_xtax_sym(X, A):
    """X^T A X for SYMMETRIC 6x6 A (== dense xtax there), exploiting the
    plux block structure: X = blockdiag(E,E) @ plux(I, r), so
    X^T A X = T^T (R^T A R) T with the r-translation static-folding.
    Returns a symmetric 6x6 nested list (lower triangle aliased)."""
    E, r = X
    A11 = [row[0:3] for row in A[0:3]]
    A12 = [row[3:6] for row in A[0:3]]
    A22 = [row[3:6] for row in A[3:6]]
    C11 = _rot_sym3(E, A11)
    C12 = _rot_full3(E, A12)
    C22 = _rot_sym3(E, A22)
    # row i of (B r̂) = B_i x r ;  col j of (r̂ B) = r x B_col_j
    C12r = [cross3(C12[i], r) for i in range(3)]          # C12 r̂
    C22r = [cross3(C22[i], r) for i in range(3)]          # C22 r̂
    rC22r = [[None] * 3 for _ in range(3)]                # r̂ (C22 r̂)
    for j in range(3):
        col = cross3(r, [C22r[k][j] for k in range(3)])
        for i in range(3):
            rC22r[i][j] = col[i]
    rC22 = [[None] * 3 for _ in range(3)]                 # r̂ C22
    for j in range(3):
        col = cross3(r, [C22[k][j] for k in range(3)])
        for i in range(3):
            rC22[i][j] = col[i]
    D = mat66(0.0)
    # D11 = C11 - C12 r̂ - (C12 r̂)^T - r̂ C22 r̂   (symmetric)
    for i in range(3):
        for j in range(i, 3):
            v = _add(
                C11[i][j],
                _mul(-1.0, _add(_add(C12r[i][j], C12r[j][i]), rC22r[i][j])),
            )
            D[i][j] = v
            D[j][i] = v
    # D12 = C12 + r̂ C22 ; D21 = D12^T ; D22 = C22
    for i in range(3):
        for j in range(3):
            v = _add(C12[i][j], rC22[i][j])
            D[i][3 + j] = v
            D[3 + j][i] = v
            D[3 + i][3 + j] = C22[i][j]
    return D


def outer_sym(u):
    """u u^T with the lower triangle ALIASED to the upper (half the
    products are formed)."""
    n = len(u)
    M = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            M[i][j] = _mul(u[i], u[j])
            M[j][i] = M[i][j]
    return M


def mat_combine_sym(A, B, beta):
    """A + beta * B for SYMMETRIC A, B (upper computed once, lower aliased)."""
    n = len(A)
    M = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            M[i][j] = _add(A[i][j], _mul(beta, B[i][j]))
            M[j][i] = M[i][j]
    return M


def mat_add_sym(A, B):
    """A + B for SYMMETRIC A, B (aliased lower triangle)."""
    n = len(A)
    M = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            M[i][j] = _add(A[i][j], B[i][j])
            M[j][i] = M[i][j]
    return M


def xc_dense(X):
    """Materialize the dense 6x6 from compact (E, r): [[E,0],[-E r̂,E]];
    row i of E r̂ = E_i x r, so BL_i = r x E_i."""
    E, r = X
    M = mat66(0.0)
    for i in range(3):
        BLi = cross3(r, E[i])
        for j in range(3):
            M[i][j] = E[i][j]
            M[3 + i][3 + j] = E[i][j]
            M[3 + i][j] = BLi[j]
    return M


def cholesky6(M):
    """Cholesky of a 6x6 SPD nested list of lane-scalars, fully unrolled."""
    n = len(M)
    L = [[0.0] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = _add(s, _mul(-1.0, _mul(L[i][k], L[j][k])))
            if i == j:
                L[i][j] = sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return L


def cholesky6_solve(L, b):
    """Solve (L L^T) x = b for vec6 b of lane-scalars."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = _add(s, _mul(-1.0, _mul(L[i][k], y[k])))
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = _add(s, _mul(-1.0, _mul(L[k][i], x[k])))
        x[i] = s / L[i][i]
    return x
