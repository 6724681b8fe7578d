// Shared device code of the rbdtpu_torch kernels: the per-model tables,
// compact spatial transforms, world-frame wrenches and the tree sweeps (ABA,
// RNEA, M^-1 dense and applied, the two forward-dynamics steps) for ONE
// state, run by one thread.
//
// The model arrives as tables (kernels/_lib.py: model_tables), not as
// constants folded into the code: a generic kernel walks the tree in loops
// over bodies, with every per-body array sized by the compile-time bound of
// its size class (Dims: bodies NB, DoFs NV, and whether body 0 is the rpy
// floating root).  Those arrays are indexed by loop variables, so they live
// in local memory (L1-cached) rather than registers; model-specialised code
// generation that would keep them in registers is later work (rbdtpu's K0).
//
// The rpy floating root (rbdtpu dynamics/*.py, the floating_base branches)
// is body 0 with six DoFs, q[0:6] = [x, y, z, roll, pitch, yaw] and S = I;
// body i > 0 owns DoF i + 5.  Its transform is plux(R^T, xyz) Xtree[0], its
// articulated 6x6 block is solved by an unrolled Cholesky factorisation
// (NaN, never a trap, when it is not positive definite).
//
// Everything here is templated on the scalar type T (float or double) and
// compiles for the host too (RBD_HD), which lets a host build check the
// arithmetic against the plain PyTorch versions.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RBD_HD __host__ __device__ __forceinline__
// a device function kept as a call, with its own stack frame
#define RBD_HD_CALL __host__ __device__ __noinline__
#else
#include <cmath>
#define RBD_HD inline
#define RBD_HD_CALL inline
#endif

namespace rbd {

constexpr int PRISMATIC = 1;

// A size class (kernels/_lib.py SIZE_CLASSES): at most NB bodies; FB marks
// the rpy floating root, whose six DoFs make NV = NB + 5.
template <int NB_, bool FB_>
struct Dims {
  static constexpr int NB = NB_;
  static constexpr bool FB = FB_;
  static constexpr int NV = FB_ ? NB_ + 5 : NB_;
};
using N8 = Dims<8, false>;    // fixed-base trees of up to 8 bodies
using FB16 = Dims<16, true>;  // rpy floating-base trees of up to 16 bodies
using FB32 = Dims<32, true>;  // rpy floating-base trees of up to 32 bodies

// per-body table layout (kernels/_lib.py STRIDE): compact Xtree (E, r),
// joint axis, 6x6 inertia, motion subspace S, Ttree rotation and translation
constexpr int OFF_E = 0, OFF_R = 9, OFF_AXIS = 12, OFF_I = 15, OFF_S = 51,
              OFF_TR = 57, OFF_TP = 66, STRIDE = 69;

RBD_HD float rsin(float x) { return sinf(x); }
RBD_HD double rsin(double x) { return sin(x); }
RBD_HD float rcos(float x) { return cosf(x); }
RBD_HD double rcos(double x) { return cos(x); }
RBD_HD float sqrt_r(float x) { return sqrtf(x); }
RBD_HD double sqrt_r(double x) { return sqrt(x); }

template <typename T, class D>
struct Model {
  const T* tab;     // nb * STRIDE
  const int* itab;  // parent[nb], joint_type[nb]
  int nb;
  RBD_HD const T* body(int i) const { return tab + i * STRIDE; }
  RBD_HD int parent(int i) const { return itab[i]; }
  RBD_HD int jtype(int i) const { return itab[nb + i]; }
  RBD_HD int nv() const { return D::FB ? nb + 5 : nb; }
  // the DoF of a 1-DoF body i (not the floating root)
  RBD_HD int vi(int i) const { return D::FB ? i + 5 : i; }
  // body i is the six-DoF rpy root
  RBD_HD bool root6(int i) const { return D::FB && i == 0; }
};

// Compact Pluecker transform X = [[E, 0], [-E r^, E]] (parent -> child).
template <typename T>
struct Xc {
  T E[9];
  T r[3];
};

template <typename T>
RBD_HD void cross3(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
RBD_HD void mv3(const T* E, const T* a, T* o) {  // E a
  for (int i = 0; i < 3; ++i) o[i] = E[3 * i] * a[0] + E[3 * i + 1] * a[1] + E[3 * i + 2] * a[2];
}

template <typename T>
RBD_HD void mtv3(const T* E, const T* a, T* o) {  // E^T a
  for (int i = 0; i < 3; ++i) o[i] = E[i] * a[0] + E[3 + i] * a[1] + E[6 + i] * a[2];
}

template <typename T>
RBD_HD void mm3(const T* A, const T* B, T* o) {  // A B
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// Joint rotation about a unit axis: R = I + s K + (1 - c) K^2, K = axis^.
// With transpose the coordinate rotation E = R^T = I - s K + (1 - c) K^2.
template <typename T>
RBD_HD void rot_axis(const T* ax, T q, bool transpose, T* R) {
  const T s = rsin(q), c = rcos(q), oc = T(1) - c;
  const T K[9] = {0, -ax[2], ax[1], ax[2], 0, -ax[0], -ax[1], ax[0], 0};
  T K2[9];
  mm3(K, K, K2);
  const T sg = transpose ? -s : s;
  for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0 ? T(1) : T(0)) + sg * K[i] + oc * K2[i];
}

// X = XJ(q) Xtree with Xtree = (Et, rt):
//   revolute:  XJ = plux(R(q)^T, 0)      -> E = R^T Et, r = rt
//   prismatic: XJ = plux(I, axis q)      -> E = Et,     r = rt + Et^T axis q
template <typename T, class D>
RBD_HD void joint_xc(const Model<T, D>& m, int i, T q, Xc<T>& X) {
  const T* b = m.body(i);
  const T* Et = b + OFF_E;
  const T* rt = b + OFF_R;
  const T* ax = b + OFF_AXIS;
  if (m.jtype(i) == PRISMATIC) {
    for (int k = 0; k < 9; ++k) X.E[k] = Et[k];
    T d[3];
    mtv3(Et, ax, d);
    for (int k = 0; k < 3; ++k) X.r[k] = rt[k] + d[k] * q;
  } else {
    T EJ[9];
    rot_axis(ax, q, true, EJ);
    mm3(EJ, Et, X.E);
    for (int k = 0; k < 3; ++k) X.r[k] = rt[k];
  }
}

// X m for a motion vector m = [a; b]: [E a; E (b - r x a)]
template <typename T>
RBD_HD void xc_mv(const Xc<T>& X, const T* m, T* o) {
  T rxa[3], t[3];
  cross3(X.r, m, rxa);
  for (int k = 0; k < 3; ++k) t[k] = m[3 + k] - rxa[k];
  mv3(X.E, m, o);
  mv3(X.E, t, o + 3);
}

// X^T f for a force vector f = [n; fl]: [E^T n + r x (E^T fl); E^T fl]
template <typename T>
RBD_HD void xc_mtv(const Xc<T>& X, const T* f, T* o) {
  T t[3], rxt[3];
  mtv3(X.E, f + 3, t);
  cross3(X.r, t, rxt);
  mtv3(X.E, f, o);
  for (int k = 0; k < 3; ++k) {
    o[k] += rxt[k];
    o[3 + k] = t[k];
  }
}

// Dense 6x6 of X: [[E, 0], [BL, E]] with row i of BL = r x (row i of E).
template <typename T>
RBD_HD void xc_dense(const Xc<T>& X, T* D) {
  for (int k = 0; k < 36; ++k) D[k] = T(0);
  for (int i = 0; i < 3; ++i) {
    T bl[3];
    cross3(X.r, X.E + 3 * i, bl);
    for (int j = 0; j < 3; ++j) {
      D[6 * i + j] = X.E[3 * i + j];
      D[6 * (3 + i) + 3 + j] = X.E[3 * i + j];
      D[6 * (3 + i) + j] = bl[j];
    }
  }
}

// acc += X^T A X for a 6x6 A (dense products; 432 multiply-adds)
template <typename T>
RBD_HD void xtax_add(const Xc<T>& X, const T* A, T* acc) {
  T D[36], AD[36];
  xc_dense(X, D);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      T s = 0;
      for (int k = 0; k < 6; ++k) s += A[6 * i + k] * D[6 * k + j];
      AD[6 * i + j] = s;
    }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      T s = 0;
      for (int k = 0; k < 6; ++k) s += D[6 * k + i] * AD[6 * k + j];
      acc[6 * i + j] += s;
    }
}

template <typename T>
RBD_HD void matvec6(const T* A, const T* x, T* o) {
  for (int i = 0; i < 6; ++i) {
    T s = 0;
    for (int k = 0; k < 6; ++k) s += A[6 * i + k] * x[k];
    o[i] = s;
  }
}

template <typename T>
RBD_HD T dot6(const T* a, const T* b) {
  T s = 0;
  for (int k = 0; k < 6; ++k) s += a[k] * b[k];
  return s;
}

// v x m (motion cross product)
template <typename T>
RBD_HD void cross_motion(const T* v, const T* m, T* o) {
  const T w0 = v[0], w1 = v[1], w2 = v[2], l0 = v[3], l1 = v[4], l2 = v[5];
  o[0] = w1 * m[2] - w2 * m[1];
  o[1] = w2 * m[0] - w0 * m[2];
  o[2] = w0 * m[1] - w1 * m[0];
  o[3] = l1 * m[2] - l2 * m[1] + w1 * m[5] - w2 * m[4];
  o[4] = l2 * m[0] - l0 * m[2] + w2 * m[3] - w0 * m[5];
  o[5] = l0 * m[1] - l1 * m[0] + w0 * m[4] - w1 * m[3];
}

// v x* f (force cross product)
template <typename T>
RBD_HD void cross_force(const T* v, const T* f, T* o) {
  const T w0 = v[0], w1 = v[1], w2 = v[2], l0 = v[3], l1 = v[4], l2 = v[5];
  o[0] = w1 * f[2] - w2 * f[1] + l1 * f[5] - l2 * f[4];
  o[1] = w2 * f[0] - w0 * f[2] + l2 * f[3] - l0 * f[5];
  o[2] = w0 * f[1] - w1 * f[0] + l0 * f[4] - l1 * f[3];
  o[3] = w1 * f[5] - w2 * f[4];
  o[4] = w2 * f[3] - w0 * f[5];
  o[5] = w0 * f[4] - w1 * f[3];
}

// Gravity as a fictitious base acceleration [0, 0, 0, 0, 0, -gravity].
template <typename T>
RBD_HD void gravity_accel(T gravity, T* a) {
  for (int k = 0; k < 5; ++k) a[k] = T(0);
  a[5] = -gravity;
}

// Active rotation R = Rz(yaw) Ry(pitch) Rx(roll) of URDF rpy angles
// (rbdtpu spatial/transforms.py rpy_to_R), row-major.
template <typename T>
RBD_HD void rpy_R(const T* rpy, T* R) {
  const T sr = rsin(rpy[0]), cr = rcos(rpy[0]), sp = rsin(rpy[1]), cp = rcos(rpy[1]),
          sy = rsin(rpy[2]), cy = rcos(rpy[2]);
  R[0] = cy * cp, R[1] = cy * sp * sr - sy * cr, R[2] = cy * sp * cr + sy * sr;
  R[3] = sy * cp, R[4] = sy * sp * sr + cy * cr, R[5] = sy * sp * cr - cy * sr;
  R[6] = -sp, R[7] = cp * sr, R[8] = cp * cr;
}

// d R / d rpy[j] of rpy_R (rbdtpu kernels/lanescalar.py rpy_dR).
template <typename T>
RBD_HD void rpy_dR(const T* rpy, int j, T* dR) {
  const T sr = rsin(rpy[0]), cr = rcos(rpy[0]), sp = rsin(rpy[1]), cp = rcos(rpy[1]),
          sy = rsin(rpy[2]), cy = rcos(rpy[2]);
  if (j == 0) {
    dR[0] = 0, dR[1] = cy * sp * cr + sy * sr, dR[2] = -(cy * sp * sr) + sy * cr;
    dR[3] = 0, dR[4] = sy * sp * cr - cy * sr, dR[5] = -(sy * sp * sr) - cy * cr;
    dR[6] = 0, dR[7] = cp * cr, dR[8] = -(cp * sr);
  } else if (j == 1) {
    dR[0] = -(cy * sp), dR[1] = cy * cp * sr, dR[2] = cy * cp * cr;
    dR[3] = -(sy * sp), dR[4] = sy * cp * sr, dR[5] = sy * cp * cr;
    dR[6] = -cp, dR[7] = -(sp * sr), dR[8] = -(sp * cr);
  } else {
    dR[0] = -(sy * cp), dR[1] = -(sy * sp * sr) - cy * cr, dR[2] = -(sy * sp * cr) + cy * sr;
    dR[3] = cy * cp, dR[4] = cy * sp * sr - sy * cr, dR[5] = cy * sp * cr + sy * sr;
    dR[6] = 0, dR[7] = 0, dR[8] = 0;
  }
}

// The rpy root's X = plux(R^T, p) Xtree[0] = plux(R^T Et, rt + Et^T p) for
// q6 = [p; rpy] (composition: plux(E1, r1) plux(E2, r2) =
// plux(E1 E2, r2 + E2^T r1)).  A real call: inlined into the
// linearize_parts kernel, nvcc 12.9 gave the root's r NaN and overwrote
// q[0] in the kernel's copy of q (float and double, on an H100); as a call,
// or reading a fresh copy of q, it is right.
template <typename T, class D>
RBD_HD_CALL void floating_xc(const Model<T, D>& m, const T* q6, Xc<T>& X) {
  const T* b = m.body(0);
  T R[9], Rt[9], d[3];
  rpy_R(q6 + 3, R);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
  mm3(Rt, b + OFF_E, X.E);
  mtv3(b + OFF_E, q6, d);
  for (int k = 0; k < 3; ++k) X.r[k] = b[OFF_R + k] + d[k];
}

template <typename T, class D>
RBD_HD void joint_transforms(const Model<T, D>& m, const T* q, Xc<T>* X) {
  if constexpr (D::FB) {
    floating_xc(m, q, X[0]);
    for (int i = 1; i < m.nb; ++i) joint_xc(m, i, q[i + 5], X[i]);
  } else {
    for (int i = 0; i < m.nb; ++i) joint_xc(m, i, q[i], X[i]);
  }
}

// Cholesky factor L (row-major, lower) of a symmetric 6x6 A, unrolled
// (rbdtpu kernels/lanescalar.py cholesky6): a block that is not positive
// definite gives NaN entries.
template <typename T>
RBD_HD void chol6(const T* A, T* L) {
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      T s = A[6 * i + j];
      for (int k = 0; k < j; ++k) s -= L[6 * i + k] * L[6 * j + k];
      L[6 * i + j] = i == j ? sqrt_r(s) : s / L[6 * j + j];
    }
}

// x = (L L^T)^-1 b for L from chol6 (cholesky6_solve).
template <typename T>
RBD_HD void chol6_solve(const T* L, const T* b, T* x) {
  T y[6];
  for (int i = 0; i < 6; ++i) {
    T s = b[i];
    for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
    y[i] = s / L[6 * i + i];
  }
  for (int i = 5; i >= 0; --i) {
    T s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
    x[i] = s / L[6 * i + i];
  }
}

// World-frame wrenches into the body forces (rbdtpu dynamics/rnea.py
// apply_external_forces): f[i] -= Xa[i]^{-T} fext[i] along the world->body
// chain Xa[i] = X[i] Xa[parent], composed compactly as
// plux(E1, r1) plux(E2, r2) = plux(E1 E2, r2 + E2^T r1); for Xa = plux(E, r),
// Xa^{-T} [n; fl] = [E (n - r x fl); E fl].  fext is (nb, 6).
template <typename T, class D>
RBD_HD void apply_fext(const Model<T, D>& m, const Xc<T>* X, const T* fext, T (*f)[6]) {
  Xc<T> Xa[D::NB];
  for (int i = 0; i < m.nb; ++i) {
    const int p = m.parent(i);
    if (p < 0) {
      Xa[i] = X[i];
    } else {
      T t[3];
      mm3(X[i].E, Xa[p].E, Xa[i].E);
      mtv3(Xa[p].E, X[i].r, t);
      for (int k = 0; k < 3; ++k) Xa[i].r[k] = Xa[p].r[k] + t[k];
    }
    const T* w = fext + 6 * i;
    T rxf[3], nr[3], o[6];
    cross3(Xa[i].r, w + 3, rxf);
    for (int k = 0; k < 3; ++k) nr[k] = w[k] - rxf[k];
    mv3(Xa[i].E, nr, o);
    mv3(Xa[i].E, w + 3, o + 3);
    for (int k = 0; k < 6; ++k) f[i][k] -= o[k];
  }
}

// ABA on the rpy floating root (rbdtpu dynamics/aba.py, floating branch):
// body 0 is a six-DoF joint (S = I) whose articulated block U = D = IA[0]
// gives its accelerations from IA[0] qdd = u - IA[0]^T a (chol6); body
// i > 0 owns DoF i + 5.  A real call: inlined into the fd_step kernel,
// nvcc 12.9 returned NaN for every acceleration of this instantiation
// (float and double, on an H100), while the same code called, inlined
// into the feedback_rollout kernel's horizon loop, or built by g++ was
// right.
template <typename T, class D>
RBD_HD_CALL void aba_root6(const Model<T, D>& m, const Xc<T>* X, const T* qd, const T* tau,
                           T gravity, T* qdd, const T* fext) {
  T v[D::NB][6], c[D::NB][6], pA[D::NB][6], IA[D::NB][36];
  T U[D::NB][6], d[D::NB], u[D::NB];
  const int nb = m.nb;
  for (int i = 0; i < nb; ++i) {
    const T* b = m.body(i);
    const T* S = b + OFF_S;
    const int p = m.parent(i);
    T vJ[6], Iv[6];
    for (int k = 0; k < 6; ++k) vJ[k] = i == 0 ? qd[k] : S[k] * qd[i + 5];
    if (p < 0) {
      for (int k = 0; k < 6; ++k) {
        v[i][k] = vJ[k];
        c[i][k] = T(0);
      }
    } else {
      xc_mv(X[i], v[p], v[i]);
      for (int k = 0; k < 6; ++k) v[i][k] += vJ[k];
      cross_motion(v[i], vJ, c[i]);
    }
    matvec6(b + OFF_I, v[i], Iv);
    cross_force(v[i], Iv, pA[i]);
    for (int k = 0; k < 36; ++k) IA[i][k] = b[OFF_I + k];
  }
  if (fext != nullptr) apply_fext(m, X, fext, pA);
  for (int i = nb - 1; i > 0; --i) {
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    matvec6(IA[i], S, U[i]);
    d[i] = dot6(S, U[i]);
    u[i] = tau[i + 5] - dot6(S, pA[i]);
    T Ia[36], pa[6], Iac[6], t[6];
    for (int r = 0; r < 6; ++r)
      for (int s = 0; s < 6; ++s) Ia[6 * r + s] = IA[i][6 * r + s] - U[i][r] * U[i][s] / d[i];
    matvec6(Ia, c[i], Iac);
    const T ud = u[i] / d[i];
    for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Iac[k] + U[i][k] * ud;
    xtax_add(X[i], Ia, IA[p]);
    xc_mtv(X[i], pa, t);
    for (int k = 0; k < 6; ++k) pA[p][k] += t[k];
  }
  T a[D::NB][6], ag[6], L[36], rhs[6];
  gravity_accel(gravity, ag);
  xc_mv(X[0], ag, a[0]);
  for (int r = 0; r < 6; ++r) {
    T s = 0;
    for (int k = 0; k < 6; ++k) s += IA[0][6 * k + r] * a[0][k];
    rhs[r] = tau[r] - pA[0][r] - s;
  }
  chol6(IA[0], L);
  chol6_solve(L, rhs, qdd);
  for (int k = 0; k < 6; ++k) a[0][k] += qdd[k];
  for (int i = 1; i < nb; ++i) {
    const T* S = m.body(i) + OFF_S;
    xc_mv(X[i], a[m.parent(i)], a[i]);
    for (int k = 0; k < 6; ++k) a[i][k] += c[i][k];
    qdd[i + 5] = (u[i] - dot6(U[i], a[i])) / d[i];
    for (int k = 0; k < 6; ++k) a[i][k] += S[k] * qdd[i + 5];
  }
}

// Articulated-body forward dynamics (rbdtpu dynamics/aba.py): qdd from
// q (through X), qd and tau; world-frame wrenches fext (nb, 6) enter the
// bias forces after the first sweep when not null.  The rpy root's
// instantiation is aba_root6; the fixed-base body below is kept as it was
// before that root existed, which keeps the fixed-base kernels' registers.
template <typename T, class D>
RBD_HD void aba(const Model<T, D>& m, const Xc<T>* X, const T* qd, const T* tau, T gravity,
                T* qdd, const T* fext = nullptr) {
  if constexpr (D::FB) {
    aba_root6(m, X, qd, tau, gravity, qdd, fext);
  } else {
    T v[D::NB][6], c[D::NB][6], pA[D::NB][6], IA[D::NB][36];
    T U[D::NB][6], d[D::NB], u[D::NB];
    const int nb = m.nb;
    for (int i = 0; i < nb; ++i) {
      const T* b = m.body(i);
      const T* S = b + OFF_S;
      const int p = m.parent(i);
      T vJ[6], Iv[6];
      for (int k = 0; k < 6; ++k) vJ[k] = S[k] * qd[i];
      if (p < 0) {
        for (int k = 0; k < 6; ++k) {
          v[i][k] = vJ[k];
          c[i][k] = T(0);
        }
      } else {
        xc_mv(X[i], v[p], v[i]);
        for (int k = 0; k < 6; ++k) v[i][k] += vJ[k];
        cross_motion(v[i], vJ, c[i]);
      }
      matvec6(b + OFF_I, v[i], Iv);
      cross_force(v[i], Iv, pA[i]);
      for (int k = 0; k < 36; ++k) IA[i][k] = b[OFF_I + k];
    }
    if (fext != nullptr) apply_fext(m, X, fext, pA);
    for (int i = nb - 1; i >= 0; --i) {
      const T* S = m.body(i) + OFF_S;
      const int p = m.parent(i);
      matvec6(IA[i], S, U[i]);
      d[i] = dot6(S, U[i]);
      u[i] = tau[i] - dot6(S, pA[i]);
      if (p >= 0) {
        T Ia[36], pa[6], Iac[6];
        for (int r = 0; r < 6; ++r)
          for (int s = 0; s < 6; ++s) Ia[6 * r + s] = IA[i][6 * r + s] - U[i][r] * U[i][s] / d[i];
        matvec6(Ia, c[i], Iac);
        const T ud = u[i] / d[i];
        for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Iac[k] + U[i][k] * ud;
        xtax_add(X[i], Ia, IA[p]);
        T t[6];
        xc_mtv(X[i], pa, t);
        for (int k = 0; k < 6; ++k) pA[p][k] += t[k];
      }
    }
    T a[D::NB][6], ag[6];
    gravity_accel(gravity, ag);
    for (int i = 0; i < nb; ++i) {
      const T* S = m.body(i) + OFF_S;
      const int p = m.parent(i);
      xc_mv(X[i], p < 0 ? ag : a[p], a[i]);
      for (int k = 0; k < 6; ++k) a[i][k] += c[i][k];
      qdd[i] = (u[i] - dot6(U[i], a[i])) / d[i];
      for (int k = 0; k < 6; ++k) a[i][k] += S[k] * qdd[i];
    }
  }
}

// RNEA forward sweep at the given qdd (null: zero, folded away when the
// caller passes a literal nullptr), world-frame wrenches fext (null: none),
// then the force accumulation of the backward sweep (f[parent] += X^T f[i]).
template <typename T, class D>
RBD_HD void rnea_sweeps(const Model<T, D>& m, const Xc<T>* X, const T* qd, const T* qdd,
                        T gravity, T (*v)[6], T (*a)[6], T (*f)[6], const T* fext = nullptr) {
  T ag[6];
  gravity_accel(gravity, ag);
  for (int i = 0; i < m.nb; ++i) {
    const T* b = m.body(i);
    const T* S = b + OFF_S;
    const int p = m.parent(i);
    T vJ[6], vxvJ[6], Ia[6], Iv[6], vxIv[6];
    if (m.root6(i)) {
      for (int k = 0; k < 6; ++k) vJ[k] = qd[k];
    } else {
      for (int k = 0; k < 6; ++k) vJ[k] = S[k] * qd[m.vi(i)];
    }
    if (p < 0) {
      for (int k = 0; k < 6; ++k) v[i][k] = vJ[k];
      xc_mv(X[i], ag, a[i]);
    } else {
      xc_mv(X[i], v[p], v[i]);
      for (int k = 0; k < 6; ++k) v[i][k] += vJ[k];
      xc_mv(X[i], a[p], a[i]);
    }
    cross_motion(v[i], vJ, vxvJ);
    if (qdd != nullptr && m.root6(i)) {
      for (int k = 0; k < 6; ++k) a[i][k] += vxvJ[k] + qdd[k];
    } else if (qdd != nullptr) {
      for (int k = 0; k < 6; ++k) a[i][k] += vxvJ[k] + S[k] * qdd[m.vi(i)];
    } else {
      for (int k = 0; k < 6; ++k) a[i][k] += vxvJ[k];
    }
    matvec6(b + OFF_I, a[i], Ia);
    matvec6(b + OFF_I, v[i], Iv);
    cross_force(v[i], Iv, vxIv);
    for (int k = 0; k < 6; ++k) f[i][k] = Ia[k] + vxIv[k];
  }
  if (fext != nullptr) apply_fext(m, X, fext, f);
  for (int i = m.nb - 1; i >= 0; --i) {
    const int p = m.parent(i);
    if (p >= 0) {
      T t[6];
      xc_mtv(X[i], f[i], t);
      for (int k = 0; k < 6; ++k) f[p][k] += t[k];
    }
  }
}

// RNEA joint forces tau = S^T f (rbdtpu dynamics/rnea.py rnea(...)[0]); the
// rpy root's six rows are f[0].
template <typename T, class D>
RBD_HD void rnea_tau(const Model<T, D>& m, const Xc<T>* X, const T* qd, const T* qdd, T gravity,
                     const T* fext, T* tau) {
  T v[D::NB][6], a[D::NB][6], f[D::NB][6];
  rnea_sweeps(m, X, qd, qdd, gravity, v, a, f, fext);
  for (int i = 0; i < m.nb; ++i) {
    if (m.root6(i)) {
      for (int k = 0; k < 6; ++k) tau[k] = f[0][k];
    } else {
      tau[m.vi(i)] = dot6(m.body(i) + OFF_S, f[i]);
    }
  }
}

// qdd = M^-1 rhs by the articulated-inertia factorisation: the ABA sweeps
// with zero velocity and zero gravity, whose velocity sweep vanishes (rbdtpu
// kernels/fused.py _step_lane, route "minv": aba_lane(qd=0, gravity=0)).
// Fixed-base trees only (the rpy root's block is not written here).
template <typename T, class D>
RBD_HD void minv_apply(const Model<T, D>& m, const Xc<T>* X, const T* rhs, T* qdd) {
  static_assert(!D::FB, "minv_apply covers fixed-base trees");
  T pA[D::NB][6], IA[D::NB][36], U[D::NB][6], d[D::NB], u[D::NB];
  const int nb = m.nb;
  for (int i = 0; i < nb; ++i) {
    for (int k = 0; k < 6; ++k) pA[i][k] = T(0);
    for (int k = 0; k < 36; ++k) IA[i][k] = m.body(i)[OFF_I + k];
  }
  for (int i = nb - 1; i >= 0; --i) {
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    matvec6(IA[i], S, U[i]);
    d[i] = dot6(S, U[i]);
    u[i] = rhs[i] - dot6(S, pA[i]);
    if (p >= 0) {
      T Ia[36], pa[6], t[6];
      for (int r = 0; r < 6; ++r)
        for (int s = 0; s < 6; ++s) Ia[6 * r + s] = IA[i][6 * r + s] - U[i][r] * U[i][s] / d[i];
      const T ud = u[i] / d[i];
      for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + U[i][k] * ud;
      xtax_add(X[i], Ia, IA[p]);
      xc_mtv(X[i], pa, t);
      for (int k = 0; k < 6; ++k) pA[p][k] += t[k];
    }
  }
  T a[D::NB][6];
  for (int i = 0; i < nb; ++i) {
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    if (p < 0) {
      for (int k = 0; k < 6; ++k) a[i][k] = T(0);
    } else {
      xc_mv(X[i], a[p], a[i]);
    }
    qdd[i] = (u[i] - dot6(U[i], a[i])) / d[i];
    for (int k = 0; k < 6; ++k) a[i][k] += S[k] * qdd[i];
  }
}

// Analytical M^-1 (rbdtpu dynamics/minv.py): leaf->root sweep for the upper
// rows, root->leaf sweep completing them; out (nv, nv) symmetric.  The rpy
// root's six rows are IA[0]^-1 (e_c - F[0][:, c]) over every column c (the
// dense fill over all nv columns, rbdtpu's deviation from its oracle).
// A real call, not inlined: inlined into linearize_knot, nvcc (CUDA 12.8)
// gave the float instantiation's M^-1 locals the storage of the caller's
// still-live RNEA accelerations and forces, corrupting dc/dq (measured on an
// H100; double and the host build were unaffected).
template <typename T, class D>
RBD_HD_CALL void minv_dense(const Model<T, D>& m, const Xc<T>* X, T* out) {
  const int nb = m.nb, n = m.nv();
  T M[D::NV][D::NV], F[D::NB][6][D::NV], IA[D::NB][36], U[D::NB][6], Dinv[D::NB];
  for (int i = 0; i < nb; ++i) {
    for (int c = 0; c < n; ++c) {
      M[i][c] = T(0);
      for (int r = 0; r < 6; ++r) F[i][r][c] = T(0);
    }
    for (int k = 0; k < 36; ++k) IA[i][k] = m.body(i)[OFF_I + k];
  }
  for (int i = nb; i < n; ++i)
    for (int c = 0; c < n; ++c) M[i][c] = T(0);
  for (int i = nb - 1; i >= 0; --i) {
    if (m.root6(i)) {
      T L[36];
      chol6(IA[0], L);
      for (int c = 0; c < n; ++c) {
        T rhs[6], x[6];
        for (int r = 0; r < 6; ++r) rhs[r] = (r == c ? T(1) : T(0)) - F[0][r][c];
        chol6_solve(L, rhs, x);
        for (int r = 0; r < 6; ++r) M[r][c] += x[r];
      }
      continue;
    }
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    const int mi = m.vi(i);
    matvec6(IA[i], S, U[i]);
    Dinv[i] = T(1) / dot6(S, U[i]);
    for (int c = 0; c < n; ++c) {
      T sF = 0;
      for (int r = 0; r < 6; ++r) sF += S[r] * F[i][r][c];
      M[mi][c] += -Dinv[i] * sF + (c == mi ? Dinv[i] : T(0));
    }
    if (p >= 0) {
      for (int c = 0; c < n; ++c) {
        T col[6], t[6];
        for (int r = 0; r < 6; ++r) {
          F[i][r][c] += U[i][r] * M[mi][c];
          col[r] = F[i][r][c];
        }
        xc_mtv(X[i], col, t);
        for (int r = 0; r < 6; ++r) F[p][r][c] += t[r];
      }
      T Ia[36];
      for (int r = 0; r < 6; ++r)
        for (int s = 0; s < 6; ++s) Ia[6 * r + s] = IA[i][6 * r + s] - Dinv[i] * U[i][r] * U[i][s];
      xtax_add(X[i], Ia, IA[p]);
    }
  }
  for (int i = 0; i < nb; ++i) {
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    const int mi = m.root6(i) ? 0 : m.vi(i);
    for (int c = 0; c < n; ++c) {
      if (m.root6(i)) {
        for (int r = 0; r < 6; ++r) F[0][r][c] = M[r][c];
      } else if (p < 0) {
        for (int r = 0; r < 6; ++r) F[i][r][c] = S[r] * M[mi][c];
      } else {
        T col[6], XF[6];
        for (int r = 0; r < 6; ++r) col[r] = F[p][r][c];
        xc_mv(X[i], col, XF);
        M[mi][c] -= Dinv[i] * dot6(U[i], XF);
        for (int r = 0; r < 6; ++r) F[i][r][c] = XF[r] + S[r] * M[mi][c];
      }
    }
  }
  for (int i = 0; i < n; ++i)
    for (int c = 0; c < n; ++c) out[i * n + c] = i <= c ? M[i][c] : M[c][i];
}

// Semi-implicit Euler: qd' = qd + dt qdd, q' = q + dt qd' (flat on the rpy
// root's six coordinates, as rbdtpu integrates them).
template <typename T>
RBD_HD void euler_step(int n, const T* x, const T* qdd, T dt, T* xo) {
  for (int i = 0; i < n; ++i) {
    const T qdn = x[n + i] + dt * qdd[i];
    xo[n + i] = qdn;
    xo[i] = x[i] + dt * qdn;
  }
}

// One ABA + semi-implicit Euler step with optional world-frame wrenches
// fext (nb, 6).  x and xo are [q; qd] of length 2 nv and may not alias.
template <typename T, class D>
RBD_HD void fd_step_state(const Model<T, D>& m, const T* x, const T* u, T dt, T gravity, T* xo,
                          const T* fext = nullptr) {
  Xc<T> X[D::NB];
  T qdd[D::NV];
  joint_transforms(m, x, X);
  aba(m, X, x + m.nv(), u, gravity, qdd, fext);
  euler_step(m.nv(), x, qdd, dt, xo);
}

// One step on the M^-1 + RNEA route (rbdtpu kernels/fused.py _step_lane,
// route "minv"): bias c = RNEA(q, qd, 0) with the wrenches, then
// qdd = M^-1 (u - c) by the factorised apply, or by the dense M^-1 with
// DENSE, then semi-implicit Euler.  x and xo may not alias.
template <typename T, class D, bool DENSE>
RBD_HD void fd_step_minv_state(const Model<T, D>& m, const T* x, const T* u, T dt, T gravity,
                               T* xo, const T* fext = nullptr) {
  static_assert(!D::FB, "fd_step_minv_state covers fixed-base trees");
  const int n = m.nb;
  Xc<T> X[D::NB];
  T c[D::NB], qdd[D::NB];
  joint_transforms(m, x, X);
  rnea_tau(m, X, x + n, static_cast<const T*>(nullptr), gravity, fext, c);
  for (int i = 0; i < n; ++i) c[i] = u[i] - c[i];
  if (DENSE) {
    T Mi[D::NB * D::NB];
    minv_dense(m, X, Mi);
    for (int i = 0; i < n; ++i) {
      T s = 0;
      for (int j = 0; j < n; ++j) s += Mi[i * n + j] * c[j];
      qdd[i] = s;
    }
  } else {
    minv_apply(m, X, c, qdd);
  }
  euler_step(n, x, qdd, dt, xo);
}

}  // namespace rbd

#ifdef __CUDACC__
// Threads per block of the one-thread-per-element kernels.
#define RBD_THREADS 64
#define RBD_GRID(n, threads) (((n) + (threads) - 1) / (threads))
#endif
