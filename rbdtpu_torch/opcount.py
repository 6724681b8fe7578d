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

Every function also carries the values, so a test holds each against the
port's plain versions (tests/test_torch_opcount.py): what is counted is the
right function.
"""
from __future__ import annotations

import math
import operator

import numpy as np


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
        hd = model.host_data
        self.nb = model.nb
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


def joint_transforms(md: Model, q):
    """X_i = XJ(q_i) Xtree_i as (E, r): revolute E = R(q)^T Et, r = rt;
    prismatic E = Et, r = rt + Et^T axis q."""
    X = []
    for i in range(md.nb):
        if md.jtype[i] == 1:
            d = mtv(md.E[i], md.axis[i])
            X.append((md.E[i], vadd(md.r[i], scale(q[i], d))))
        else:
            R = rot_axis(md.axis[i], q[i])
            X.append((mm3([col(R, j) for j in range(3)], md.E[i]), md.r[i]))
    return X


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
        vJ = scale(qd[i], S)
        if p < 0:
            v[i] = vJ
            a[i] = xmv(X[i], gravity_accel(gravity))
        else:
            v[i] = vadd(xmv(X[i], v[p]), vJ)
            a[i] = xmv(X[i], a[p])
        a[i] = vadd(a[i], crm(v[i], vJ))
        if qdd is not None:
            a[i] = vadd(a[i], scale(qdd[i], S))
        f[i] = vadd(rbi_mv(md.rbi[i], a[i]),
                    crf(v[i], rbi_mv(md.rbi[i], v[i])))
    if fext is not None:
        f = apply_fext(md, X, fext, f)
    return _accumulate(md, X, f)


def _accumulate(md: Model, X, f):
    """Leaf->root: tau_i = S_i^T f_i, f[parent] += X^T f_i."""
    tau = [None] * md.nb
    for i in reversed(range(md.nb)):
        tau[i] = dot(md.S[i], f[i])
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
        vJ = scale(qd[i], S)
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
        U[i] = mv(IA[i], S)
        dinv[i] = 1.0 / dot(S, U[i])
        u[i] = tau[i] - dot(S, pA[i])
        if p >= 0:
            Ud = scale(dinv[i], U[i])
            Ia = sym_update(lambda r, s: IA[i][r][s] - Ud[r] * U[i][s])
            pa = vadd(vadd(pA[i], mv(Ia, c[i])), scale(u[i] * dinv[i], U[i]))
            C = xtax(X[i], Ia)
            IA[p] = sym_update(lambda r, s: IA[p][r][s] + C[r][s])
            pA[p] = vadd(pA[p], xtf(X[i], pa))
    a, Xa, qdd = [None] * n, [None] * n, [None] * n
    for i in range(n):
        p, S = md.parent[i], md.S[i]
        Xa[i] = xmv(X[i], gravity_accel(gravity) if p < 0 else a[p])
        a[i] = vadd(Xa[i], c[i])
        qdd[i] = (u[i] - dot(U[i], a[i])) * dinv[i]
        a[i] = vadd(a[i], scale(qdd[i], S))
    if keep is not None:
        keep.update(v=v, a=a, Xv=Xv, Xa=Xa, Iv=Iv, bias=bias)
    return qdd


def minv_apply(md: Model, X, rhs):
    """M^-1 rhs: the ABA sweeps at zero velocity and zero gravity."""
    return aba(md, X, [0.0] * md.nb, rhs, 0.0)


def minv_dense(md: Model, X):
    """The analytical M^-1 (rbdtpu dynamics/minv.py): leaf->root over the
    columns of each subtree, root->leaf over the columns on and right of
    the diagonal; returned symmetric."""
    n = md.nb
    M = [[0.0] * n for _ in range(n)]
    F = [[[0.0] * 6 for _ in range(n)] for _ in range(n)]
    IA = list(md.I)
    U, dinv = [None] * n, [None] * n
    for i in reversed(range(n)):
        p, S = md.parent[i], md.S[i]
        U[i] = mv(IA[i], S)
        dinv[i] = 1.0 / dot(S, U[i])
        for c in range(n):
            M[i][c] = (M[i][c] - dinv[i] * dot(S, F[i][c])
                       + (dinv[i] if c == i else 0.0))
        if p >= 0:
            for c in range(n):
                F[i][c] = vadd(F[i][c], scale(M[i][c], U[i]))
                F[p][c] = vadd(F[p][c], xtf(X[i], F[i][c]))
            Ia = sym_update(lambda r, s: IA[i][r][s]
                            - dinv[i] * U[i][r] * U[i][s])
            C = xtax(X[i], Ia)
            IA[p] = sym_update(lambda r, s: IA[p][r][s] + C[r][s])
    for i in range(n):
        p, S = md.parent[i], md.S[i]
        for c in range(i, n):
            if p < 0:
                F[i][c] = scale(M[i][c], S)
            else:
                XF = xmv(X[i], F[p][c])
                M[i][c] = M[i][c] - dinv[i] * dot(U[i], XF)
                F[i][c] = vadd(XF, scale(M[i][c], S))
    return [[M[min(i, c)][max(i, c)] for c in range(n)] for i in range(n)]


def euler(x, qdd, dt):
    n = len(qdd)
    qd = [x[n + i] + dt * qdd[i] for i in range(n)]
    return [x[i] + dt * qd[i] for i in range(n)] + qd


def fd_step(md: Model, x, u, dt, gravity, fext=None):
    n = md.nb
    X = joint_transforms(md, x[:n])
    return euler(x, aba(md, X, x[n:], u, gravity, fext), dt)


def fd_step_minv(md: Model, x, u, dt, gravity, dense=False, fext=None):
    """Bias RNEA, then qdd = M^-1 (u - c), then Euler."""
    n = md.nb
    X = joint_transforms(md, x[:n])
    rhs = vsub(u, rnea(md, X, x[n:], None, gravity, fext))
    qdd = mv(minv_dense(md, X), rhs) if dense else minv_apply(md, X, rhs)
    return euler(x, qdd, dt)


def rnea_state(md: Model, q, qd, qdd, gravity):
    return rnea(md, joint_transforms(md, q), qd, qdd, gravity)


def feedback_knot(md: Model, x, xn, un, kf, K, dt, gravity):
    """u = Un + kf + K (x - Xn), then one ABA step."""
    dx = vsub(x, xn)
    u = [un[i] + kf[i] + dot(K[i], dx) for i in range(md.nb)]
    return fd_step(md, x, u, dt, gravity), u


def rnea_derivatives(md: Model, X, qd, st, f):
    """dc/dq and dc/dqd (n, n) at the state of ``st`` (aba's ``keep``) with
    the accumulated RNEA forces f, one forward-mode column at a time."""
    n = md.nb
    out = {True: [[None] * n for _ in range(n)],
           False: [[None] * n for _ in range(n)]}
    for wrt_q in (True, False):
        for j in range(n):
            dv, da, df = [None] * n, [None] * n, [None] * n
            for i in range(n):
                p, S = md.parent[i], md.S[i]
                if p < 0:
                    dv[i], dab = [0.0] * 6, [0.0] * 6
                else:
                    dv[i], dab = xmv(X[i], dv[p]), xmv(X[i], da[p])
                if i == j and not wrt_q:
                    dv[i] = vadd(dv[i], S)
                elif i == j and p >= 0:
                    dv[i] = vadd(dv[i], crm(st["Xv"][i], S))
                da[i] = vadd(dab, scale(qd[i], crm(dv[i], S)))
                if i == j:
                    da[i] = vadd(da[i], crm(
                        st["Xa"][i] if wrt_q else st["v"][i], S))
                df[i] = vadd(vadd(rbi_mv(md.rbi[i], da[i]),
                                  crf(dv[i], st["Iv"][i])),
                             crf(st["v"][i], rbi_mv(md.rbi[i], dv[i])))
            for i in reversed(range(n)):
                p, S = md.parent[i], md.S[i]
                out[wrt_q][i][j] = dot(S, df[i])
                if p >= 0:
                    df[p] = vadd(df[p], xtf(X[i], df[i]))
                    if wrt_q and i == j:  # d(X^T f)/dq_i = X^T (S x* f)
                        df[p] = vadd(df[p], xtf(X[i], crf(S, f[i])))
    return out[True], out[False]


def linearize_parts(md: Model, q, qd, u, gravity):
    """(M^-1, dc/dq, dc/dqd, qdd) of one knot; the RNEA forces at the ABA
    acceleration reuse ABA's velocities, accelerations and v x* I v."""
    X = joint_transforms(md, q)
    st = {}
    qdd = aba(md, X, qd, u, gravity, keep=st)
    f = [vadd(rbi_mv(md.rbi[i], st["a"][i]), st["bias"][i])
         for i in range(md.nb)]
    for i in reversed(range(md.nb)):
        p = md.parent[i]
        if p >= 0:
            f[p] = vadd(f[p], xtf(X[i], f[i]))
    dcq, dcd = rnea_derivatives(md, X, qd, st, f)
    return minv_dense(md, X), dcq, dcd, qdd


def ee(md: Model, jid: int, fid, q, target, gn: bool):
    """EE position error e = p_ee - target and, with gn, J^T e and J^T J
    (upper triangle formed, mirrored) of the position Jacobian along the
    root -> jid chain."""
    mount = np.eye(4) if fid is None else md.T_fixed[fid]
    ee_p = mount[:3, 3].tolist()
    chain = [jid]
    while md.parent[chain[-1]] >= 0:
        chain.append(md.parent[chain[-1]])
    chain.reverse()
    R = np.eye(3).tolist()
    p, axw, org = [0.0] * 3, {}, {}
    for idx, k in enumerate(chain):
        p = vadd(p, mv(R, md.Tp[k]))
        R1 = mm3(R, md.TR[k])
        axw[k], org[k] = mv(R1, md.axis[k]), p
        if md.jtype[k] == 1:
            p, R = vadd(p, scale(q[k], axw[k])), R1
        elif idx < len(chain) - 1 or any(ee_p):
            R = mm3(R1, rot_axis(md.axis[k], q[k]))
    pe = vadd(p, mv(R, ee_p))
    e = vsub(pe, [float(t) for t in target])
    if not gn:
        return e, None, None
    J = {k: (axw[k] if md.jtype[k] == 1 else cross3(axw[k], vsub(pe, org[k])))
         for k in chain}
    Jc = [J.get(i, [0.0] * 3) for i in range(md.nb)]
    g0 = [dot(Jc[i], e) for i in range(md.nb)]
    H0 = [[None] * md.nb for _ in range(md.nb)]
    for i in range(md.nb):
        for j in range(i, md.nb):
            H0[i][j] = H0[j][i] = dot(Jc[i], Jc[j])
    return e, g0, H0


def counted(fn, *args, **kw):
    """(fn's result, the operations it counted)."""
    Num.ops = 0
    out = fn(*args, **kw)
    return out, Num.ops


def per_state(model, target) -> dict:
    """Operations per state (per knot for the rollouts) of each kernel's
    function on ``model``, keyed as ``chip_smoke.py`` keys its checks."""
    from .kernels.fk_lane import _single_ee

    md = Model(model)
    n = md.nb
    rng = np.random.default_rng(0)
    nums = lambda *s: np.vectorize(Num, otypes=[object])(
        rng.standard_normal(s)).tolist()
    x, u, qdd, w = nums(2 * n), nums(n), nums(n), nums(n, 6)
    q, qd = x[:n], x[n:]
    dt, g = 0.01, -9.81
    jid, fid = _single_ee(model, None)
    ops = lambda fn, *a, **kw: counted(fn, md, *a, **kw)[1]
    fd = ops(fd_step, x, u, dt, g)
    minv = ops(fd_step_minv, x, u, dt, g)
    return {
        "fd_step": fd,
        "fd_step+fext": ops(fd_step, x, u, dt, g, fext=w),
        "feedback_rollout": ops(feedback_knot, x, nums(2 * n), u, nums(n),
                                nums(n, 2 * n), dt, g),
        "linearize_parts": ops(linearize_parts, q, qd, u, g),
        "ee_gn": ops(ee, jid, fid, q, target, True),
        "ee_err": ops(ee, jid, fid, q, target, False),
        "rnea": ops(rnea_state, q, qd, None, g),
        "rnea+qdd": ops(rnea_state, q, qd, qdd, g),
        "fd_step_minv": minv,
        "fd_step_minv+dense": ops(fd_step_minv, x, u, dt, g, dense=True),
        "fd_step_minv+fext": ops(fd_step_minv, x, u, dt, g, fext=w),
    }
