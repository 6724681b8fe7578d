"""Operations per state that each kernel's function needs: the operations
side of a kernel's roofline bound (``chip_smoke.py``).

Each function below runs one kernel's algorithm for ONE state on ``Num``, a
number that counts every add, subtract, multiply, divide, sine and cosine it
takes part in.  The model's data (its tables, gravity, dt, the EE target)
stay plain floats: arithmetic between them is folded away, and a product
with a plain 0 or +-1, a sum with a plain 0, or a negation is free.  So the
count is what the algorithm needs on this model, not what the generic
kernels execute:

- transforms are compact (E, r): X m and X^T f cost 42 operations each in
  general;
- an articulated inertia is symmetric: X^T A X rotates its two symmetric
  3x3 blocks and the general one, then shifts them by r (360 operations in
  general, accumulation included), and I_A - U U^T / d updates 21 entries;
- a rigid-body inertia is applied in its compact form (m, h = m c, I_o);
- the structural zeros of the joint subspace, the joint rotation, gravity,
  the tree (M^-1's columns and the derivatives' columns off a subtree) and
  the constant articulated inertias of leaf bodies fall out by the rules
  above;
- intermediate results are shared: the linearisation takes its RNEA
  velocities, accelerations and I v from its ABA pass, M^-1 is formed on
  and above the diagonal only, and J^T J likewise.

The rpy floating root (body 0, six DoFs, S = I) costs its rotation from
three angles, its 6x6 articulated block's Cholesky factorisation and
solves, and in the linearisation its three rotation columns of dc/dq
(seeded analytically, as the kernel does; the position columns are zero).

``riccati_knot`` counts one knot of the iLQR Riccati sweep: the products
whose results are symmetric (Q_xx, Q_uu, the new V_xx) are formed on and
above the diagonal, the Cholesky factor of Q_uu + reg I takes about
nu^3 / 3 operations and each of the nx + 1 right-hand sides two triangular
solves.

Every function also carries the values, so a test holds each against the
port's plain versions (tests/test_torch_opcount.py): what is counted is the
right function.
"""
from __future__ import annotations

import math
import operator

import numpy as np

from .kernels.fused import chunk_geometry


class Num:
    """A value that counts the arithmetic it takes part in (``Num.ops``)."""

    __slots__ = ("v",)
    ops = 0

    def __init__(self, v):
        self.v = float(v)

    def __neg__(self):
        return Num(-self.v)

    def __add__(self, o):
        return add(self, o)

    def __radd__(self, o):
        return add(o, self)

    def __sub__(self, o):
        return sub(self, o)

    def __rsub__(self, o):
        return sub(o, self)

    def __mul__(self, o):
        return mul(self, o)

    def __rmul__(self, o):
        return mul(o, self)

    def __truediv__(self, o):
        return div(self, o)

    def __rtruediv__(self, o):
        return div(o, self)


def _plain(x) -> bool:
    return not isinstance(x, Num)


def value(x) -> float:
    return x.v if isinstance(x, Num) else float(x)


def _fold(a, b, f):
    if _plain(a) and _plain(b):
        return f(a, b)
    Num.ops += 1
    return Num(f(value(a), value(b)))


def add(a, b):
    if _plain(a) and a == 0:
        return b
    if _plain(b) and b == 0:
        return a
    return _fold(a, b, operator.add)


def sub(a, b):
    if _plain(b) and b == 0:
        return a
    if _plain(a) and a == 0:
        return -b
    return _fold(a, b, operator.sub)


def mul(a, b):
    for x, y in ((a, b), (b, a)):
        if _plain(x) and x in (0, 1, -1):
            return 0.0 if x == 0 else (y if x == 1 else -y)
    return _fold(a, b, operator.mul)


def div(a, b):
    if _plain(a) and a == 0:
        return 0.0
    if _plain(b) and b in (1, -1):
        return a if b == 1 else -a
    return _fold(a, b, operator.truediv)


def _unary(x, f):
    if _plain(x):
        return f(x)
    Num.ops += 1
    return Num(f(x.v))


def sin(x):
    return _unary(x, math.sin)


def cos(x):
    return _unary(x, math.cos)


# ---- 3-vectors, 3x3 and 6x6 matrices as lists ----

def dot(a, b):
    s = 0.0
    for x, y in zip(a, b):
        s = s + x * y
    return s


def vadd(a, b):
    return [x + y for x, y in zip(a, b)]


def vsub(a, b):
    return [x - y for x, y in zip(a, b)]


def scale(s, a):
    return [s * x for x in a]


def col(A, j):
    return [row[j] for row in A]


def cross3(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def mv(A, x):
    return [dot(row, x) for row in A]


def mtv(A, x):
    return [dot(col(A, j), x) for j in range(len(A[0]))]


def mm3(A, B, sym=False):
    """A B; with sym, the entries on and above the diagonal, mirrored."""
    out = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a if sym else 0, 3):
            out[a][b] = dot(A[a], col(B, b))
            if sym:
                out[b][a] = out[a][b]
    return out


def hat(r):
    return [[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]]


def crm(v, m):
    """v x m (motion)."""
    w, l = v[:3], v[3:]
    return cross3(w, m[:3]) + vadd(cross3(l, m[:3]), cross3(w, m[3:]))


def crf(v, f):
    """v x* f (force)."""
    w, l = v[:3], v[3:]
    return vadd(cross3(w, f[:3]), cross3(l, f[3:])) + cross3(w, f[3:])


def xmv(X, m):
    """X m for X = plux(E, r): [E w; E (l - r x w)]."""
    E, r = X
    return mv(E, m[:3]) + mv(E, vsub(m[3:], cross3(r, m[:3])))


def xtf(X, f):
    """X^T f: [E^T n + r x (E^T fl); E^T fl]."""
    E, r = X
    t = mtv(E, f[3:])
    return vadd(mtv(E, f[:3]), cross3(r, t)) + t


def sym_update(fn):
    """A 6x6 symmetric matrix whose (r, s) entry is fn(r, s), formed on and
    above the diagonal."""
    out = [[None] * 6 for _ in range(6)]
    for r in range(6):
        for s in range(r, 6):
            out[r][s] = out[s][r] = fn(r, s)
    return out


def xtax(X, A):
    """X^T A X for a symmetric 6x6 A and X = plux(E, r) = diag(E, E) T with
    T = [[1, 0], [-r^, 1]]: B_ij = E^T A_ij E (the diagonal blocks
    symmetric), then T^T B T = [[B11 - M - M^T - r^ B22 r^, B12 + r^ B22],
    [., B22]] with M = B12 r^."""
    E, r = X
    Et = [col(E, j) for j in range(3)]

    def rot(i, j):
        blk = [[A[3 * i + a][3 * j + b] for b in range(3)] for a in range(3)]
        return mm3(Et, mm3(blk, E), sym=i == j)

    B11, B12, B22 = rot(0, 0), rot(0, 1), rot(1, 1)
    rx = hat(r)
    M = mm3(B12, rx)
    N = mm3(rx, B22)
    P = mm3(N, rx, sym=True)
    C12 = [vadd(a, b) for a, b in zip(B12, N)]

    def entry(a, b):
        if a < 3 and b < 3:
            return B11[a][b] - M[a][b] - M[b][a] - P[a][b]
        if a < 3:
            return C12[a][b - 3]
        return B22[a - 3][b - 3]

    return sym_update(entry)


# ---- the model ----

class Model:
    """A RobotModel's data as plain floats: per body the compact Xtree
    (E, r), the joint axis and subspace S, the inertia (dense, and compact
    (m, h, I_o)), Ttree; the EE mount of a fixed frame."""

    def __init__(self, model):
        if model.floating_base and model.root_quat:
            raise NotImplementedError("opcount: the quaternion root is not "
                                      "counted")
        hd = model.host_data
        self.nb = model.nb
        self.fb = model.floating_base
        self.nv = model.nv
        self.parent = model.parent
        self.jtype = model.joint_type
        self.E, self.r, self.I, self.rbi, self.TR, self.Tp = ([] for _ in
                                                              range(6))
        for i in range(self.nb):
            X = hd["Xtree"][i]
            E = X[:3, :3]
            rh = -E.T @ X[3:, :3]
            self.E.append(E.tolist())
            self.r.append([float(rh[2, 1]), float(rh[0, 2]), float(rh[1, 0])])
            Ii = hd["I"][i]
            self.I.append(Ii.tolist())
            h = [float(Ii[2, 4]), float(Ii[0, 5]), float(Ii[1, 3])]
            self.rbi.append((float(Ii[5, 5]), h, Ii[:3, :3].tolist()))
            self.TR.append(hd["Ttree"][i][:3, :3].tolist())
            self.Tp.append(hd["Ttree"][i][:3, 3].tolist())
        self.axis = hd["axis"].tolist()
        self.S = hd["S"].tolist()
        self.T_fixed = hd["T_fixed"]

    def root6(self, i: int) -> bool:
        """Body i is the six-DoF rpy root."""
        return self.fb and i == 0

    def vi(self, i: int) -> int:
        """The DoF of a 1-DoF body."""
        return i + 5 if self.fb else i


def rbi_mv(I, v):
    """Rigid-body inertia (m, h, I_o) times a motion vector:
    [I_o w + h x l; m l - h x w]."""
    m, h, Io = I
    w, l = v[:3], v[3:]
    return vadd(mv(Io, w), cross3(h, l)) + vsub(scale(m, l), cross3(h, w))


def rot_axis(ax, q):
    """Rotation by q about the unit axis: c 1 + s ax^ + (1 - c) ax ax^T."""
    s, c = sin(q), cos(q)
    oc = 1.0 - c
    K = hat(ax)
    return [[(c if a == b else 0.0) + s * K[a][b] + oc * (ax[a] * ax[b])
             for b in range(3)] for a in range(3)]


def rpy_trig(rpy):
    return [f(a) for a in rpy for f in (sin, cos)]


def rpy_R(trig):
    """R = Rz(yaw) Ry(pitch) Rx(roll) from (sin, cos) of the three angles,
    the products cy sp and sy sp shared."""
    sr, cr, sp, cp, sy, cy = trig
    cysp, sysp = cy * sp, sy * sp
    return [[cy * cp, cysp * sr - sy * cr, cysp * cr + sy * sr],
            [sy * cp, sysp * sr + cy * cr, sysp * cr - cy * sr],
            [-sp, cp * sr, cp * cr]]


def rpy_dR(trig, j):
    """d R / d rpy[j]."""
    sr, cr, sp, cp, sy, cy = trig
    if j == 0:
        cysp, sysp = cy * sp, sy * sp
        return [[0.0, cysp * cr + sy * sr, -(cysp * sr) + sy * cr],
                [0.0, sysp * cr - cy * sr, -(sysp * sr) - cy * cr],
                [0.0, cp * cr, -(cp * sr)]]
    if j == 1:
        cycp, sycp = cy * cp, sy * cp
        return [[-(cy * sp), cycp * sr, cycp * cr],
                [-(sy * sp), sycp * sr, sycp * cr],
                [-cp, -(sp * sr), -(sp * cr)]]
    sysp, cysp = sy * sp, cy * sp
    return [[-(sy * cp), -(sysp * sr) - cy * cr, -(sysp * cr) + cy * sr],
            [cy * cp, cysp * sr - sy * cr, cysp * cr + sy * sr],
            [0.0, 0.0, 0.0]]


def joint_transforms(md: Model, q, trig=None):
    """X_i = XJ(q_i) Xtree_i as (E, r): revolute E = R(q)^T Et, r = rt;
    prismatic E = Et, r = rt + Et^T axis q; the rpy root
    plux(R^T, p) Xtree_0 = (R^T Et, rt + Et^T p), from ``trig`` (the root
    angles' rpy_trig) when the caller already has it."""
    X = []
    for i in range(md.nb):
        if md.root6(i):
            R = rpy_R(trig or rpy_trig(q[3:6]))
            X.append((mm3([col(R, j) for j in range(3)], md.E[0]),
                      vadd(md.r[0], mtv(md.E[0], q[0:3]))))
            continue
        qi = q[md.vi(i)]
        if md.jtype[i] == 1:
            d = mtv(md.E[i], md.axis[i])
            X.append((md.E[i], vadd(md.r[i], scale(qi, d))))
        else:
            R = rot_axis(md.axis[i], qi)
            X.append((mm3([col(R, j) for j in range(3)], md.E[i]), md.r[i]))
    return X


def chol_solve(A, rhs_cols):
    """The Cholesky factor of a symmetric A (lower triangle read) and the
    solutions of A x = b for each b of ``rhs_cols``; a pivot that is not
    positive gives NaN, as the kernels' factorisations do."""
    n = len(A)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = _unary(s, lambda v: math.sqrt(v) if v > 0 else math.nan)
        for i in range(j + 1, n):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    out = []
    for b in rhs_cols:
        y = [None] * n
        for i in range(n):
            s = b[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        out.append(x)
    return out


def gravity_accel(gravity):
    return [0.0] * 5 + [-gravity]


def apply_fext(md: Model, X, fext, f):
    """f[i] - Xa[i]^{-T} fext[i] along the world->body chain Xa[i] =
    X[i] Xa[parent]: plux(E1, r1) plux(E2, r2) = plux(E1 E2, r2 + E2^T r1),
    plux(E, r)^{-T} [n; fl] = [E (n - r x fl); E fl]."""
    Xa, out = [], []
    for i in range(md.nb):
        p = md.parent[i]
        if p < 0:
            Xa.append(X[i])
        else:
            Ep, rp = Xa[p]
            Xa.append((mm3(X[i][0], Ep), vadd(rp, mtv(Ep, X[i][1]))))
        E, r = Xa[i]
        w = fext[i]
        o = mv(E, vsub(w[:3], cross3(r, w[3:]))) + mv(E, w[3:])
        out.append(vsub(f[i], o))
    return out


def rnea(md: Model, X, qd, qdd, gravity, fext=None):
    """tau = S^T f after the two sweeps; qdd None means zero."""
    n = md.nb
    v, a, f = [None] * n, [None] * n, [None] * n
    for i in range(n):
        p, S = md.parent[i], md.S[i]
        vJ = list(qd[0:6]) if md.root6(i) else scale(qd[md.vi(i)], S)
        if p < 0:
            v[i] = vJ
            a[i] = xmv(X[i], gravity_accel(gravity))
        else:
            v[i] = vadd(xmv(X[i], v[p]), vJ)
            a[i] = xmv(X[i], a[p])
        if not md.root6(i):  # v x v = 0 at the root
            a[i] = vadd(a[i], crm(v[i], vJ))
        if qdd is not None:
            a[i] = vadd(a[i], list(qdd[0:6]) if md.root6(i)
                        else scale(qdd[md.vi(i)], S))
        f[i] = vadd(rbi_mv(md.rbi[i], a[i]),
                    crf(v[i], rbi_mv(md.rbi[i], v[i])))
    if fext is not None:
        f = apply_fext(md, X, fext, f)
    return _accumulate(md, X, f)


def _accumulate(md: Model, X, f):
    """Leaf->root: tau_i = S_i^T f_i (the root's six rows: f_0),
    f[parent] += X^T f_i."""
    tau = [None] * md.nv
    for i in reversed(range(md.nb)):
        if md.root6(i):
            tau[0:6] = f[0]
            continue
        tau[md.vi(i)] = dot(md.S[i], f[i])
        p = md.parent[i]
        if p >= 0:
            f[p] = vadd(f[p], xtf(X[i], f[i]))
    return tau


def aba(md: Model, X, qd, tau, gravity, fext=None, keep=None):
    """Articulated-body forward dynamics; ``keep`` (a dict) receives the
    velocities, accelerations, X v_parent, X a_parent and I v for reuse."""
    n = md.nb
    v, c, pA, Iv, Xv = ([None] * n for _ in range(5))
    for i in range(n):
        p, S = md.parent[i], md.S[i]
        vJ = list(qd[0:6]) if md.root6(i) else scale(qd[md.vi(i)], S)
        if p < 0:
            Xv[i], v[i], c[i] = [0.0] * 6, vJ, [0.0] * 6
        else:
            Xv[i] = xmv(X[i], v[p])
            v[i] = vadd(Xv[i], vJ)
            c[i] = crm(v[i], vJ)
        Iv[i] = rbi_mv(md.rbi[i], v[i])
        pA[i] = crf(v[i], Iv[i])
    bias = list(pA)
    if fext is not None:
        pA = apply_fext(md, X, fext, pA)
    IA = list(md.I)
    U, dinv, u = [None] * n, [None] * n, [None] * n
    for i in reversed(range(n)):
        p, S = md.parent[i], md.S[i]
        if md.root6(i):  # U = D = IA_0
            u[0] = vsub(tau[0:6], pA[0])
            continue
        U[i] = mv(IA[i], S)
        dinv[i] = 1.0 / dot(S, U[i])
        u[i] = tau[md.vi(i)] - dot(S, pA[i])
        if p >= 0:
            Ud = scale(dinv[i], U[i])
            Ia = sym_update(lambda r, s: IA[i][r][s] - Ud[r] * U[i][s])
            pa = vadd(vadd(pA[i], mv(Ia, c[i])), scale(u[i] * dinv[i], U[i]))
            C = xtax(X[i], Ia)
            IA[p] = sym_update(lambda r, s: IA[p][r][s] + C[r][s])
            pA[p] = vadd(pA[p], xtf(X[i], pa))
    a, Xa, qdd = [None] * n, [None] * n, [None] * md.nv
    for i in range(n):
        p, S = md.parent[i], md.S[i]
        Xa[i] = xmv(X[i], gravity_accel(gravity) if p < 0 else a[p])
        a[i] = vadd(Xa[i], c[i])
        if md.root6(i):
            qdd[0:6] = chol_solve(IA[0], [vsub(u[0], mv(IA[0], a[0]))])[0]
            a[0] = vadd(a[0], qdd[0:6])
            continue
        qdd[md.vi(i)] = (u[i] - dot(U[i], a[i])) * dinv[i]
        a[i] = vadd(a[i], scale(qdd[md.vi(i)], S))
    if keep is not None:
        keep.update(v=v, a=a, Xv=Xv, Xa=Xa, Iv=Iv, bias=bias)
    return qdd


def minv_apply(md: Model, X, rhs):
    """M^-1 rhs: the ABA sweeps at zero velocity and zero gravity."""
    return aba(md, X, [0.0] * md.nv, rhs, 0.0)


def minv_dense(md: Model, X):
    """The analytical M^-1 (rbdtpu dynamics/minv.py): leaf->root over the
    columns of each subtree, root->leaf over the columns on and right of
    the diagonal; returned symmetric.  The rpy root's six rows are
    IA_0^-1 (e_c - F_0[:, c]) over every column c."""
    nb, n = md.nb, md.nv
    M = [[0.0] * n for _ in range(n)]
    F = [[[0.0] * 6 for _ in range(n)] for _ in range(nb)]
    IA = list(md.I)
    U, dinv = [None] * nb, [None] * nb
    for i in reversed(range(nb)):
        p, S = md.parent[i], md.S[i]
        if md.root6(i):
            cols = chol_solve(IA[0], [
                vsub([1.0 if r == c else 0.0 for r in range(6)], F[0][c])
                for c in range(n)])
            for c in range(n):
                for r in range(6):
                    M[r][c] = cols[c][r]
            continue
        mi = md.vi(i)
        U[i] = mv(IA[i], S)
        dinv[i] = 1.0 / dot(S, U[i])
        for c in range(n):
            M[mi][c] = (M[mi][c] - dinv[i] * dot(S, F[i][c])
                        + (dinv[i] if c == mi else 0.0))
        if p >= 0:
            for c in range(n):
                F[i][c] = vadd(F[i][c], scale(M[mi][c], U[i]))
                F[p][c] = vadd(F[p][c], xtf(X[i], F[i][c]))
            Ia = sym_update(lambda r, s: IA[i][r][s]
                            - dinv[i] * U[i][r] * U[i][s])
            C = xtax(X[i], Ia)
            IA[p] = sym_update(lambda r, s: IA[p][r][s] + C[r][s])
    for i in range(nb):
        p, S = md.parent[i], md.S[i]
        if md.root6(i):
            F[0] = [[M[r][c] for r in range(6)] for c in range(n)]
            continue
        mi = md.vi(i)
        for c in range(mi, n):
            if p < 0:
                F[i][c] = scale(M[mi][c], S)
            else:
                XF = xmv(X[i], F[p][c])
                M[mi][c] = M[mi][c] - dinv[i] * dot(U[i], XF)
                F[i][c] = vadd(XF, scale(M[mi][c], S))
    return [[M[min(i, c)][max(i, c)] for c in range(n)] for i in range(n)]


def euler(x, qdd, dt):
    n = len(qdd)
    qd = [x[n + i] + dt * qdd[i] for i in range(n)]
    return [x[i] + dt * qd[i] for i in range(n)] + qd


def fd_step(md: Model, x, u, dt, gravity, fext=None):
    n = md.nv
    X = joint_transforms(md, x[:n])
    return euler(x, aba(md, X, x[n:], u, gravity, fext), dt)


def fd_step_minv(md: Model, x, u, dt, gravity, dense=False, fext=None):
    """Bias RNEA, then qdd = M^-1 (u - c), then Euler."""
    n = md.nv
    X = joint_transforms(md, x[:n])
    rhs = vsub(u, rnea(md, X, x[n:], None, gravity, fext))
    qdd = mv(minv_dense(md, X), rhs) if dense else minv_apply(md, X, rhs)
    return euler(x, qdd, dt)


def rnea_state(md: Model, q, qd, qdd, gravity):
    return rnea(md, joint_transforms(md, q), qd, qdd, gravity)


def feedback_knot(md: Model, x, xn, un, kf, K, dt, gravity, fext=None):
    """u = Un + kf + K (x - Xn), then one ABA step (under the wrenches
    fext when given)."""
    dx = vsub(x, xn)
    u = [un[i] + kf[i] + dot(K[i], dx) for i in range(md.nv)]
    return fd_step(md, x, u, dt, gravity, fext), u


def feedback_knot_chunked(md: Model, x, xn, un, kf, K, dt, gravity,
                          nchunks=2, fext=None):
    """K9's knot: u = Un + kf, then per column chunk u += its partial sum
    (rbdtpu's order; as many operations as ``feedback_knot``), then one ABA
    step (under fext when given)."""
    dx = vsub(x, xn)
    ndx = len(dx)
    cw = chunk_geometry(ndx, nchunks)[0]
    u = [un[i] + kf[i] for i in range(md.nv)]
    for j0 in range(0, ndx, cw):
        u = [u[i] + dot(K[i][j0:j0 + cw], dx[j0:j0 + cw])
             for i in range(md.nv)]
    return fd_step(md, x, u, dt, gravity, fext), u


def rnea_derivatives(md: Model, X, qd, st, f, trig=None, gravity=-9.81):
    """dc/dq and dc/dqd (nv, nv) at the state of ``st`` (aba's ``keep``)
    with the accumulated RNEA forces f, one forward-mode column at a time.
    The rpy root's dqd columns seed dv_0 = e_j; its rotation columns of
    dc/dq seed da_0 = [0; (dR/drpy_j)^T g_l] (``trig``: the root angles'
    rpy_trig; g_l the linear part of Xtree_0 a_grav); its position columns
    are zero."""
    nb, n = md.nb, md.nv
    out = {True: [[None] * n for _ in range(n)],
           False: [[None] * n for _ in range(n)]}
    g_l = xmv((md.E[0], md.r[0]), gravity_accel(gravity))[3:]
    for wrt_q in (True, False):
        for j in range(n):
            dv, da, df = [None] * nb, [None] * nb, [None] * nb
            for i in range(nb):
                p, S = md.parent[i], md.S[i]
                if md.root6(i):
                    dv[0], da[0] = [0.0] * 6, [0.0] * 6
                    if not wrt_q and j < 6:
                        dv[0][j] = 1.0
                    elif wrt_q and 3 <= j < 6:
                        da[0] = [0.0] * 3 + mtv(rpy_dR(trig, j - 3), g_l)
                    df[0] = vadd(vadd(rbi_mv(md.rbi[0], da[0]),
                                      crf(dv[0], st["Iv"][0])),
                                 crf(st["v"][0], rbi_mv(md.rbi[0], dv[0])))
                    continue
                vi = md.vi(i)
                if p < 0:
                    dv[i], dab = [0.0] * 6, [0.0] * 6
                else:
                    dv[i], dab = xmv(X[i], dv[p]), xmv(X[i], da[p])
                if vi == j and not wrt_q:
                    dv[i] = vadd(dv[i], S)
                elif vi == j and p >= 0:
                    dv[i] = vadd(dv[i], crm(st["Xv"][i], S))
                da[i] = vadd(dab, scale(qd[vi], crm(dv[i], S)))
                if vi == j:
                    da[i] = vadd(da[i], crm(
                        st["Xa"][i] if wrt_q else st["v"][i], S))
                df[i] = vadd(vadd(rbi_mv(md.rbi[i], da[i]),
                                  crf(dv[i], st["Iv"][i])),
                             crf(st["v"][i], rbi_mv(md.rbi[i], dv[i])))
            for i in reversed(range(nb)):
                if md.root6(i):
                    for k in range(6):
                        out[wrt_q][k][j] = df[0][k]
                    continue
                p, S, vi = md.parent[i], md.S[i], md.vi(i)
                out[wrt_q][vi][j] = dot(S, df[i])
                if p >= 0:
                    df[p] = vadd(df[p], xtf(X[i], df[i]))
                    if wrt_q and vi == j:  # d(X^T f)/dq_i = X^T (S x* f)
                        df[p] = vadd(df[p], xtf(X[i], crf(S, f[i])))
    return out[True], out[False]


def linearize_parts(md: Model, q, qd, u, gravity):
    """(M^-1, dc/dq, dc/dqd, qdd) of one knot; the RNEA forces at the ABA
    acceleration reuse ABA's velocities, accelerations and v x* I v."""
    trig = rpy_trig(q[3:6]) if md.fb else None
    X = joint_transforms(md, q, trig)
    st = {}
    qdd = aba(md, X, qd, u, gravity, keep=st)
    f = [vadd(rbi_mv(md.rbi[i], st["a"][i]), st["bias"][i])
         for i in range(md.nb)]
    for i in reversed(range(md.nb)):
        p = md.parent[i]
        if p >= 0:
            f[p] = vadd(f[p], xtf(X[i], f[i]))
    dcq, dcd = rnea_derivatives(md, X, qd, st, f, trig, gravity)
    return minv_dense(md, X), dcq, dcd, qdd


def ee(md: Model, jid: int, fid, q, target, gn: bool):
    """EE position error e = p_ee - target and, with gn, J^T e and J^T J
    (upper triangle formed, mirrored) of the position Jacobian along the
    root -> jid chain; q holds nq coordinates.  An rpy root's pose is
    Ttree0 [[Rz Ry Rx, xyz], [0, 1]] and its six columns are its
    translations' (Ttree0's rotation: no operations) and its Euler angles'
    (Rt Rz Ry e_x, Rt Rz e_y, Rt e_z crossed with p_ee - o_root)."""
    mount = np.eye(4) if fid is None else md.T_fixed[fid]
    ee_p = mount[:3, 3].tolist()
    chain = [jid]
    while md.parent[chain[-1]] >= 0:
        chain.append(md.parent[chain[-1]])
    chain.reverse()
    R = np.eye(3).tolist()
    p, axw, org, lin = [0.0] * 3, {}, {}, set()
    for idx, k in enumerate(chain):
        if md.root6(k):
            sr, cr, sp, cp, sy, cy = rpy_trig(q[3:6])
            Rt = md.TR[0]
            RtRz = mm3(Rt, [[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
            RtRzRy = mm3(RtRz, [[cp, 0.0, sp], [0.0, 1.0, 0.0],
                                [-sp, 0.0, cp]])
            R = mm3(RtRzRy, [[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
            p = vadd(mv(Rt, q[0:3]), md.Tp[0])
            for t in range(3):
                axw[t], lin = col(Rt, t), lin | {t}
            axw[3], axw[4], axw[5] = col(RtRzRy, 0), col(RtRz, 1), col(Rt, 2)
            for c in (3, 4, 5):
                org[c] = p
            continue
        c = md.vi(k)
        p = vadd(p, mv(R, md.Tp[k]))
        R1 = mm3(R, md.TR[k])
        axw[c], org[c] = mv(R1, md.axis[k]), p
        if md.jtype[k] == 1:
            p, R, lin = vadd(p, scale(q[c], axw[c])), R1, lin | {c}
        elif idx < len(chain) - 1 or any(ee_p):
            R = mm3(R1, rot_axis(md.axis[k], q[c]))
    pe = vadd(p, mv(R, ee_p))
    e = vsub(pe, [float(t) for t in target])
    if not gn:
        return e, None, None
    J = {c: (a if c in lin else cross3(a, vsub(pe, org[c])))
         for c, a in axw.items()}
    n = md.nv
    Jc = [J.get(i, [0.0] * 3) for i in range(n)]
    g0 = [dot(Jc[i], e) for i in range(n)]
    H0 = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            H0[i][j] = H0[j][i] = dot(Jc[i], Jc[j])
    return e, g0, H0


def counted(fn, *args, **kw):
    """(fn's result, the operations it counted)."""
    Num.ops = 0
    out = fn(*args, **kw)
    return out, Num.ops


def riccati_knot(A, Bm, lx, lu, lxx, luu, lux, Vx, Vxx, reg):
    """One knot of the iLQR Riccati sweep (solver/ddp.py backward_pass):
    (k, K, dV1 term, Vx', Vxx').  Vxx and the cost blocks are symmetric
    where they should be, so Q_xx, Q_uu and Vxx' are formed on and above
    the diagonal; Vx' = Q_x + K^T (Q_uu k + Q_u) + Q_ux^T k."""
    n, m = len(A), len(Bm[0])
    P = [[dot(Vxx[i], col(A, j)) for j in range(n)] for i in range(n)]
    Pb = [[dot(Vxx[i], col(Bm, j)) for j in range(m)] for i in range(n)]
    Qx, Qu = vadd(lx, mtv(A, Vx)), vadd(lu, mtv(Bm, Vx))

    def sym(fn, size):
        out = [[None] * size for _ in range(size)]
        for a in range(size):
            for b in range(a, size):
                out[a][b] = out[b][a] = fn(a, b)
        return out

    Quu = sym(lambda a, b: luu[a][b] + dot(col(Bm, a), col(Pb, b)), m)
    Qux = [[lux[a][j] + dot(col(Bm, a), col(P, j)) for j in range(n)]
           for a in range(m)]
    Qxx = sym(lambda a, b: lxx[a][b] + dot(col(A, a), col(P, b)), n)
    reg_Quu = [[Quu[a][b] + (reg if a == b else 0.0) for b in range(m)]
               for a in range(m)]
    sols = chol_solve(reg_Quu, [Qu] + [col(Qux, j) for j in range(n)])
    k = [-x for x in sols[0]]
    K = [[-sols[1 + j][a] for j in range(n)] for a in range(m)]
    QuuK = [[dot(Quu[a], col(K, j)) for j in range(n)] for a in range(m)]
    Vx_new = vadd(vadd(Qx, mtv(K, vadd(mv(Quu, k), Qu))), mtv(Qux, k))
    Vxx_new = sym(lambda a, b: Qxx[a][b] + dot(col(K, a), col(QuuK, b))
                  + dot(col(K, a), col(Qux, b)) + dot(col(Qux, a), col(K, b)),
                  n)
    return k, K, dot(k, Qu), Vx_new, Vxx_new


def riccati_knot_ops(nx: int, nu: int) -> int:
    """Operations of one ``riccati_knot`` at (nx, nu), every input counted
    (constant cost blocks are read at every knot all the same)."""
    rng = np.random.default_rng(0)
    nums = lambda *s: np.vectorize(Num, otypes=[object])(
        rng.standard_normal(s)).tolist()
    symm = lambda n: (lambda M: [[M[min(a, b)][max(a, b)] for b in range(n)]
                                 for a in range(n)])(nums(n, n))
    return counted(riccati_knot, nums(nx, nx), nums(nx, nu), nums(nx),
                   nums(nu), symm(nx), symm(nu), nums(nu, nx), nums(nx),
                   symm(nx), Num(1e-6))[1]


def per_state(model, target, ee_names=None) -> dict:
    """Operations per state (per knot for the rollouts) of each kernel's
    function on ``model``, keyed as ``chip_smoke.py`` keys its checks:
    those of K1-K3, K6, K10, and K2 and K9 under a wrench set, for any tree
    the port covers, and of K4 at one end effector (the single leaf, or
    ``ee_names``'s)."""
    from .kernels.fk_lane import _single_ee

    md = Model(model)
    n = md.nv
    rng = np.random.default_rng(0)
    nums = lambda *s: np.vectorize(Num, otypes=[object])(
        rng.standard_normal(s)).tolist()
    x, u, qdd, w = nums(2 * n), nums(n), nums(n), nums(md.nb, 6)
    q, qd = x[:n], x[n:]
    dt, g = 0.01, -9.81
    ops = lambda fn, *a, **kw: counted(fn, md, *a, **kw)[1]
    out = {
        "fd_step": ops(fd_step, x, u, dt, g),
        "fd_step+fext": ops(fd_step, x, u, dt, g, fext=w),
        "feedback_rollout": ops(feedback_knot, x, nums(2 * n), u, nums(n),
                                nums(n, 2 * n), dt, g),
        "feedback_chunked": ops(feedback_knot_chunked, x, nums(2 * n), u,
                                nums(n), nums(n, 2 * n), dt, g),
        "feedback_rollout+fext": ops(feedback_knot, x, nums(2 * n), u,
                                     nums(n), nums(n, 2 * n), dt, g, fext=w),
        "feedback_chunked+fext": ops(feedback_knot_chunked, x, nums(2 * n),
                                     u, nums(n), nums(n, 2 * n), dt, g,
                                     fext=w),

        "linearize_parts": ops(linearize_parts, q, qd, u, g),
        "rnea": ops(rnea_state, q, qd, None, g),
        "rnea+qdd": ops(rnea_state, q, qd, qdd, g),
        "fd_step_minv": ops(fd_step_minv, x, u, dt, g),
        "fd_step_minv+dense": ops(fd_step_minv, x, u, dt, g, dense=True),
        "fd_step_minv+fext": ops(fd_step_minv, x, u, dt, g, fext=w),
        "fd_step_minv+dense+fext": ops(fd_step_minv, x, u, dt, g, dense=True,
                                       fext=w),
    }
    if ee_names is not None or len(model.leaves()) == 1:
        jid, fid = _single_ee(model, ee_names)
        out["ee_gn"] = ops(ee, jid, fid, q, target, True)
        out["ee_err"] = ops(ee, jid, fid, q, target, False)
    return out
