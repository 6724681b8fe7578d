// linearize_parts: the pieces of the DDP knot linearisation.
// Replaces rbdtpu kernels/colvec.py linearize_parts_fused (Pallas,
// colvec.py:289).
//
// One thread per knot: ABA for qdd; RNEA velocities, accelerations and
// accumulated forces at that qdd; the analytical M^-1 (upper triangle
// authoritative, mirrored here); then, one derivative column at a time, the
// dc/dq and dc/dqd sweeps (rbdtpu dynamics/rnea_grad.py, fixed base).
// Outputs (row-major): Minv, dcq, dcd (B, n, n) indexed [b, row, col];
// qdd (B, n).  The per-body sweep state and the M^-1 F blocks live in local
// memory; see the build's .ptxas.log.
#include "rbd_common.cuh"

namespace rbd {

// RNEA forward sweep at the given qdd, then the force accumulation of the
// backward sweep (f[parent] += X^T f[i]).
template <typename T>
RBD_HD void rnea_sweeps(const Model<T>& m, const Xc<T>* X, const T* qd, const T* qdd, T gravity,
                        T (*v)[6], T (*a)[6], T (*f)[6]) {
  T ag[6];
  gravity_accel(gravity, ag);
  for (int i = 0; i < m.nb; ++i) {
    const T* b = m.body(i);
    const T* S = b + OFF_S;
    const int p = m.parent(i);
    T vJ[6], vxvJ[6], Ia[6], Iv[6], vxIv[6];
    for (int k = 0; k < 6; ++k) vJ[k] = S[k] * qd[i];
    if (p < 0) {
      for (int k = 0; k < 6; ++k) v[i][k] = vJ[k];
      xc_mv(X[i], ag, a[i]);
    } else {
      xc_mv(X[i], v[p], v[i]);
      for (int k = 0; k < 6; ++k) v[i][k] += vJ[k];
      xc_mv(X[i], a[p], a[i]);
    }
    cross_motion(v[i], vJ, vxvJ);
    for (int k = 0; k < 6; ++k) a[i][k] += vxvJ[k] + S[k] * qdd[i];
    matvec6(b + OFF_I, a[i], Ia);
    matvec6(b + OFF_I, v[i], Iv);
    cross_force(v[i], Iv, vxIv);
    for (int k = 0; k < 6; ++k) f[i][k] = Ia[k] + vxIv[k];
  }
  for (int i = m.nb - 1; i >= 0; --i) {
    const int p = m.parent(i);
    if (p >= 0) {
      T t[6];
      xc_mtv(X[i], f[i], t);
      for (int k = 0; k < 6; ++k) f[p][k] += t[k];
    }
  }
}

// Analytical M^-1 (rbdtpu dynamics/minv.py): leaf->root sweep for the upper
// rows, root->leaf sweep completing them; out (n, n) symmetric.
// A real call, not inlined: inlined into linearize_knot, nvcc (CUDA 12.8)
// gave the float instantiation's M^-1 locals the storage of the caller's
// still-live RNEA accelerations and forces, corrupting dc/dq (measured on an
// H100; double and the host build were unaffected).
template <typename T>
RBD_HD_CALL void minv_dense(const Model<T>& m, const Xc<T>* X, T* out) {
  const int n = m.nb;
  T M[NB_MAX][NB_MAX], F[NB_MAX][6][NB_MAX], IA[NB_MAX][36], U[NB_MAX][6], Dinv[NB_MAX];
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < n; ++c) {
      M[i][c] = T(0);
      for (int r = 0; r < 6; ++r) F[i][r][c] = T(0);
    }
    for (int k = 0; k < 36; ++k) IA[i][k] = m.body(i)[OFF_I + k];
  }
  for (int i = n - 1; i >= 0; --i) {
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    matvec6(IA[i], S, U[i]);
    Dinv[i] = T(1) / dot6(S, U[i]);
    for (int c = 0; c < n; ++c) {
      T sF = 0;
      for (int r = 0; r < 6; ++r) sF += S[r] * F[i][r][c];
      M[i][c] += -Dinv[i] * sF + (c == i ? Dinv[i] : T(0));
    }
    if (p >= 0) {
      for (int c = 0; c < n; ++c) {
        T col[6], t[6];
        for (int r = 0; r < 6; ++r) {
          F[i][r][c] += U[i][r] * M[i][c];
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
  for (int i = 0; i < n; ++i) {
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    for (int c = 0; c < n; ++c) {
      if (p < 0) {
        for (int r = 0; r < 6; ++r) F[i][r][c] = S[r] * M[i][c];
      } else {
        T col[6], XF[6];
        for (int r = 0; r < 6; ++r) col[r] = F[p][r][c];
        xc_mv(X[i], col, XF);
        M[i][c] -= Dinv[i] * dot6(U[i], XF);
        for (int r = 0; r < 6; ++r) F[i][r][c] = XF[r] + S[r] * M[i][c];
      }
    }
  }
  for (int i = 0; i < n; ++i)
    for (int c = 0; c < n; ++c) out[i * n + c] = i <= c ? M[i][c] : M[c][i];
}

// Column j of dc/dq (wrt_q) or dc/dqd: forward derivative sweep over the
// bodies, then the backward sweep; dc (n,) receives rows 0..n-1.
template <typename T>
RBD_HD void grad_column(const Model<T>& m, const Xc<T>* X, const T* qd, T (*v)[6],
                        T (*a)[6], T (*f)[6], int j, bool wrt_q, T gravity, T* dc) {
  T dv[NB_MAX][6], da[NB_MAX][6], df[NB_MAX][6], ag[6];
  gravity_accel(gravity, ag);
  for (int i = 0; i < m.nb; ++i) {
    const T* b = m.body(i);
    const T* S = b + OFF_S;
    const T* I = b + OFF_I;
    const int p = m.parent(i);
    T dab[6], Xa_ref[6];
    if (p < 0) {
      for (int k = 0; k < 6; ++k) dv[i][k] = dab[k] = T(0);
      xc_mv(X[i], ag, Xa_ref);
    } else {
      xc_mv(X[i], dv[p], dv[i]);
      xc_mv(X[i], da[p], dab);
      xc_mv(X[i], a[p], Xa_ref);
    }
    if (i == j) {
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
    for (int k = 0; k < 6; ++k) da[i][k] = dab[k] + qd[i] * cm[k];
    if (i == j) {
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
    const T* S = m.body(i) + OFF_S;
    const int p = m.parent(i);
    dc[i] = dot6(S, df[i]);
    if (p >= 0) {
      T t[6];
      xc_mtv(X[i], df[i], t);
      for (int k = 0; k < 6; ++k) df[p][k] += t[k];
      if (wrt_q && i == j) {  // d(X^T f)/dq_i = X^T (S x* f)
        T Sf[6];
        cross_force(S, f[i], Sf);
        xc_mtv(X[i], Sf, t);
        for (int k = 0; k < 6; ++k) df[p][k] += t[k];
      }
    }
  }
}

// All outputs of one knot: Minv, dcq, dcd (n, n) and qdd (n,).
template <typename T>
RBD_HD void linearize_knot(const Model<T>& m, const T* q, const T* qd, const T* u, T gravity,
                           T* Minv, T* dcq, T* dcd, T* qdd) {
  const int n = m.nb;
  Xc<T> X[NB_MAX];
  T v[NB_MAX][6], a[NB_MAX][6], f[NB_MAX][6], dc[NB_MAX];
  joint_transforms(m, q, X);
  aba(m, X, qd, u, gravity, qdd);
  rnea_sweeps(m, X, qd, qdd, gravity, v, a, f);
  minv_dense(m, X, Minv);
  for (int w = 0; w < 2; ++w) {
    T* out = w == 0 ? dcq : dcd;
    for (int j = 0; j < n; ++j) {
      grad_column(m, X, qd, v, a, f, j, w == 0, gravity, dc);
      for (int i = 0; i < n; ++i) out[i * n + j] = dc[i];
    }
  }
}

}  // namespace rbd

#ifdef __CUDACC__
template <typename T>
__global__ void linearize_parts_kernel(rbd::Model<T> m, const T* __restrict__ q,
                                       const T* __restrict__ qd, const T* __restrict__ u,
                                       T* __restrict__ Minv, T* __restrict__ dcq,
                                       T* __restrict__ dcd, T* __restrict__ qdd, int B,
                                       T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nb;
  const size_t o1 = (size_t)b * n, o2 = (size_t)b * n * n;
  T qs[rbd::NB_MAX], qds[rbd::NB_MAX], us[rbd::NB_MAX], qdds[rbd::NB_MAX];
  for (int k = 0; k < n; ++k) {
    qs[k] = q[o1 + k];
    qds[k] = qd[o1 + k];
    us[k] = u[o1 + k];
  }
  rbd::linearize_knot(m, qs, qds, us, gravity, Minv + o2, dcq + o2, dcd + o2, qdds);
  for (int k = 0; k < n; ++k) qdd[o1 + k] = qdds[k];
}

template <typename T>
static int launch_linearize_parts(const T* tab, const int* itab, int nb, const T* q, const T* qd,
                                  const T* u, T* Minv, T* dcq, T* dcd, T* qdd, int B, T gravity,
                                  void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T> m{tab, itab, nb};
  linearize_parts_kernel<T><<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
      m, q, qd, u, Minv, dcq, dcd, qdd, B, gravity);
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_linearize_parts_f32(const float* tab, const int* itab, int nb, const float* q,
                            const float* qd, const float* u, float* Minv, float* dcq, float* dcd,
                            float* qdd, int B, float gravity, void* stream) {
  return launch_linearize_parts<float>(tab, itab, nb, q, qd, u, Minv, dcq, dcd, qdd, B, gravity,
                                       stream);
}
int rbd_linearize_parts_f64(const double* tab, const int* itab, int nb, const double* q,
                            const double* qd, const double* u, double* Minv, double* dcq,
                            double* dcd, double* qdd, int B, double gravity, void* stream) {
  return launch_linearize_parts<double>(tab, itab, nb, q, qd, u, Minv, dcq, dcd, qdd, B, gravity,
                                        stream);
}
}
#endif
