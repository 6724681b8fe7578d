// linearize_parts: the pieces of the DDP knot linearisation.
// Replaces rbdtpu kernels/colvec.py linearize_parts_fused (Pallas,
// colvec.py:289).
//
// One thread per knot: ABA for qdd; RNEA velocities, accelerations and
// accumulated forces at that qdd; the analytical M^-1 (upper triangle
// authoritative, mirrored here); then, one derivative column at a time, the
// dc/dq and dc/dqd sweeps (rbdtpu dynamics/rnea_grad.py).
// Outputs (row-major): Minv, dcq, dcd (B, n, n) indexed [b, row, col];
// qdd (B, n); n = nv.  The per-body sweep state and the M^-1 F blocks live in
// local memory; see the build's .ptxas.log.  Instantiated for N8, FB16 and
// FB32.
//
// The rpy root's columns (rbdtpu kernels/colvec.py grad_pass_colvec): its
// dqd columns seed dv_0 = e_j; its pose enters tau only through the gravity
// seed a_0 = X_0 a_grav (v_0 = qd[0:6], the child transforms do not depend
// on it), so the position columns vanish and rotation column 3 + j seeds
// da_0 = [0; (dR/drpy_j)^T g_l], g_l the linear part of Xtree_0 a_grav.
#include "rbd_common.cuh"

namespace rbd {

// Column j of dc/dq (wrt_q) or dc/dqd: forward derivative sweep over the
// bodies, then the backward sweep; dc (n,) receives rows 0..n-1.
template <typename T, class D>
RBD_HD void grad_column(const Model<T, D>& m, const Xc<T>* X, const T* q, const T* qd,
                        T (*v)[6], T (*a)[6], T (*f)[6], int j, bool wrt_q, T gravity, T* dc) {
  T dv[D::NB][6], da[D::NB][6], df[D::NB][6], ag[6];
  gravity_accel(gravity, ag);
  for (int i = 0; i < m.nb; ++i) {
    const T* b = m.body(i);
    const T* S = b + OFF_S;
    const T* I = b + OFF_I;
    const int p = m.parent(i);
    if (m.root6(i)) {
      for (int k = 0; k < 6; ++k) dv[0][k] = da[0][k] = T(0);
      if (j < 6 && !wrt_q) {
        dv[0][j] = T(1);
      } else if (wrt_q && j >= 3 && j < 6) {
        T g6[6], dR[9];
        Xc<T> Xt;
        for (int k = 0; k < 9; ++k) Xt.E[k] = b[OFF_E + k];
        for (int k = 0; k < 3; ++k) Xt.r[k] = b[OFF_R + k];
        xc_mv(Xt, ag, g6);
        rpy_dR(q + 3, j - 3, dR);
        mtv3(dR, g6 + 3, da[0] + 3);
      }
      T Ida[6], Iv[6], Idv[6], t1[6], t2[6];
      matvec6(I, da[0], Ida);
      matvec6(I, v[0], Iv);
      matvec6(I, dv[0], Idv);
      cross_force(dv[0], Iv, t1);
      cross_force(v[0], Idv, t2);
      for (int k = 0; k < 6; ++k) df[0][k] = Ida[k] + t1[k] + t2[k];
      continue;
    }
    const int vi = m.vi(i);
    T dab[6], Xa_ref[6];
    if (p < 0) {
      for (int k = 0; k < 6; ++k) dv[i][k] = dab[k] = T(0);
      xc_mv(X[i], ag, Xa_ref);
    } else {
      xc_mv(X[i], dv[p], dv[i]);
      xc_mv(X[i], da[p], dab);
      xc_mv(X[i], a[p], Xa_ref);
    }
    if (vi == j) {
      if (!wrt_q) {
        for (int k = 0; k < 6; ++k) dv[i][k] += S[k];
      } else if (p >= 0) {
        T Xv[6], inj[6];
        xc_mv(X[i], v[p], Xv);
        cross_motion(Xv, S, inj);
        for (int k = 0; k < 6; ++k) dv[i][k] += inj[k];
      }
    }
    T cm[6];
    cross_motion(dv[i], S, cm);
    for (int k = 0; k < 6; ++k) da[i][k] = dab[k] + qd[vi] * cm[k];
    if (vi == j) {
      T inj[6];
      cross_motion(wrt_q ? Xa_ref : v[i], S, inj);
      for (int k = 0; k < 6; ++k) da[i][k] += inj[k];
    }
    T Ida[6], Iv[6], Idv[6], t1[6], t2[6];
    matvec6(I, da[i], Ida);
    matvec6(I, v[i], Iv);
    matvec6(I, dv[i], Idv);
    cross_force(dv[i], Iv, t1);
    cross_force(v[i], Idv, t2);
    for (int k = 0; k < 6; ++k) df[i][k] = Ida[k] + t1[k] + t2[k];
  }
  for (int i = m.nb - 1; i >= 0; --i) {
    if (m.root6(i)) {  // S = I: the root's six rows
      for (int k = 0; k < 6; ++k) dc[k] = df[0][k];
      continue;
    }
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    dc[m.vi(i)] = dot6(S, df[i]);
    if (p >= 0) {
      T t[6];
      xc_mtv(X[i], df[i], t);
      for (int k = 0; k < 6; ++k) df[p][k] += t[k];
      if (wrt_q && m.vi(i) == j) {  // d(X^T f)/dq_i = X^T (S x* f)
        T Sf[6];
        cross_force(S, f[i], Sf);
        xc_mtv(X[i], Sf, t);
        for (int k = 0; k < 6; ++k) df[p][k] += t[k];
      }
    }
  }
}

// All outputs of one knot: Minv, dcq, dcd (n, n) and qdd (n,).
template <typename T, class D>
RBD_HD void linearize_knot(const Model<T, D>& m, const T* q, const T* qd, const T* u, T gravity,
                           T* Minv, T* dcq, T* dcd, T* qdd) {
  const int n = m.nv();
  Xc<T> X[D::NB];
  T v[D::NB][6], a[D::NB][6], f[D::NB][6], dc[D::NV];
  joint_transforms(m, q, X);
  aba(m, X, qd, u, gravity, qdd);
  rnea_sweeps(m, X, qd, qdd, gravity, v, a, f);
  minv_dense(m, X, Minv);
  for (int w = 0; w < 2; ++w) {
    T* out = w == 0 ? dcq : dcd;
    for (int j = 0; j < n; ++j) {
      grad_column(m, X, q, qd, v, a, f, j, w == 0, gravity, dc);
      for (int i = 0; i < n; ++i) out[i * n + j] = dc[i];
    }
  }
}

}  // namespace rbd

#ifdef __CUDACC__
template <typename T, class D>
__global__ void linearize_parts_kernel(rbd::Model<T, D> m, const T* __restrict__ q,
                                       const T* __restrict__ qd, const T* __restrict__ u,
                                       T* __restrict__ Minv, T* __restrict__ dcq,
                                       T* __restrict__ dcd, T* __restrict__ qdd, int B,
                                       T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nv();
  const size_t o1 = (size_t)b * n, o2 = (size_t)b * n * n;
  T qs[D::NV], qds[D::NV], us[D::NV], qdds[D::NV];
  for (int k = 0; k < n; ++k) {
    qs[k] = q[o1 + k];
    qds[k] = qd[o1 + k];
    us[k] = u[o1 + k];
  }
  rbd::linearize_knot(m, qs, qds, us, gravity, Minv + o2, dcq + o2, dcd + o2, qdds);
  for (int k = 0; k < n; ++k) qdd[o1 + k] = qdds[k];
}

template <typename T, class D>
static int launch_linearize_parts(const T* tab, const int* itab, int nb, const T* q, const T* qd,
                                  const T* u, T* Minv, T* dcq, T* dcd, T* qdd, int B, T gravity,
                                  void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T, D> m{tab, itab, nb};
  linearize_parts_kernel<T, D>
      <<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
          m, q, qd, u, Minv, dcq, dcd, qdd, B, gravity);
  return (int)cudaGetLastError();
}

#define RBD_LINEARIZE_PARTS(CLS, D, T, SFX)                                                    \
  int rbd_linearize_parts_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* q,    \
                                        const T* qd, const T* u, T* Minv, T* dcq, T* dcd,     \
                                        T* qdd, int B, T gravity, void* stream) {             \
    return launch_linearize_parts<T, rbd::D>(tab, itab, nb, q, qd, u, Minv, dcq, dcd, qdd, B, \
                                             gravity, stream);                                \
  }

extern "C" {
RBD_LINEARIZE_PARTS(n8, N8, float, f32)
RBD_LINEARIZE_PARTS(n8, N8, double, f64)
RBD_LINEARIZE_PARTS(fb16, FB16, float, f32)
RBD_LINEARIZE_PARTS(fb16, FB16, double, f64)
RBD_LINEARIZE_PARTS(fb32, FB32, float, f32)
RBD_LINEARIZE_PARTS(fb32, FB32, double, f64)

// The current device's per-thread stack limit (cudaLimitStackSize).  The
// driver raises it to the largest stack frame launched so far (this kernel's
// at FB32 in double is the largest of the library) and keeps local memory of
// that size for every thread the card can hold; setting it lower frees it.
int rbd_stack_limit(size_t* bytes) { return (int)cudaDeviceGetLimit(bytes, cudaLimitStackSize); }
int rbd_set_stack_limit(size_t bytes) {
  return (int)cudaDeviceSetLimit(cudaLimitStackSize, bytes);
}
}
#endif
