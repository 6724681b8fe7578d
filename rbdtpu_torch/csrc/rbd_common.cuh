// Shared device code of the rbdtpu_torch kernels: the per-model tables,
// compact spatial transforms and the tree sweeps (ABA, RNEA, Minv) for ONE
// state, run by one thread.
//
// The model arrives as tables (kernels/_lib.py: model_tables), not as
// constants folded into the code: a generic kernel walks the tree in loops
// over bodies, with every per-body array sized by the compile-time NB_MAX.
// Those arrays are indexed by loop variables, so they live in local memory
// (L1-cached) rather than registers; model-specialised code generation that
// would keep them in registers is later work (rbdtpu's K0).
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

constexpr int NB_MAX = 8;  // kernels/_lib.py NB_MAX
constexpr int PRISMATIC = 1;

// per-body table layout (kernels/_lib.py STRIDE): compact Xtree (E, r),
// joint axis, 6x6 inertia, motion subspace S, Ttree rotation and translation
constexpr int OFF_E = 0, OFF_R = 9, OFF_AXIS = 12, OFF_I = 15, OFF_S = 51,
              OFF_TR = 57, OFF_TP = 66, STRIDE = 69;

RBD_HD float rsin(float x) { return sinf(x); }
RBD_HD double rsin(double x) { return sin(x); }
RBD_HD float rcos(float x) { return cosf(x); }
RBD_HD double rcos(double x) { return cos(x); }

template <typename T>
struct Model {
  const T* tab;     // nb * STRIDE
  const int* itab;  // parent[nb], joint_type[nb]
  int nb;
  RBD_HD const T* body(int i) const { return tab + i * STRIDE; }
  RBD_HD int parent(int i) const { return itab[i]; }
  RBD_HD int jtype(int i) const { return itab[nb + i]; }
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
template <typename T>
RBD_HD void joint_xc(const Model<T>& m, int i, T q, Xc<T>& X) {
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

template <typename T>
RBD_HD void joint_transforms(const Model<T>& m, const T* q, Xc<T>* X) {
  for (int i = 0; i < m.nb; ++i) joint_xc(m, i, q[i], X[i]);
}

// Articulated-body forward dynamics (rbdtpu dynamics/aba.py): qdd from
// q (through X), qd and tau.
template <typename T>
RBD_HD void aba(const Model<T>& m, const Xc<T>* X, const T* qd, const T* tau, T gravity,
                T* qdd) {
  T v[NB_MAX][6], c[NB_MAX][6], pA[NB_MAX][6], IA[NB_MAX][36];
  T U[NB_MAX][6], d[NB_MAX], u[NB_MAX];
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
  T a[NB_MAX][6], ag[6];
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

// One ABA + semi-implicit Euler step: qd' = qd + dt qdd, q' = q + dt qd'.
// x and xo are [q; qd] of length 2 nb and may not alias.
template <typename T>
RBD_HD void fd_step_state(const Model<T>& m, const T* x, const T* u, T dt, T gravity, T* xo) {
  const int n = m.nb;
  Xc<T> X[NB_MAX];
  T qdd[NB_MAX];
  joint_transforms(m, x, X);
  aba(m, X, x + n, u, gravity, qdd);
  for (int i = 0; i < n; ++i) {
    const T qdn = x[n + i] + dt * qdd[i];
    xo[n + i] = qdn;
    xo[i] = x[i] + dt * qdn;
  }
}

}  // namespace rbd

#ifdef __CUDACC__
// Threads per block of the one-thread-per-element kernels.
#define RBD_THREADS 64
#define RBD_GRID(n, threads) (((n) + (threads) - 1) / (threads))
#endif
