// ee_gn / ee_err: end-effector position error and its Gauss-Newton terms.
// Replaces rbdtpu kernels/fk_lane.py ee_gn_fused (Pallas, fk_lane.py:203),
// both its gn=True and gn=False variants.
//
// One thread per state walks the chain root -> EE joint with homogeneous
// transforms (T = Ttree TJ(q)), then applies the EE mount (ee: R row-major,
// p).  The position Jacobian is geometric: column k = a_k x (p_ee - o_k) for
// a revolute joint, a_k for a prismatic one (a_k the world joint axis, o_k
// the joint origin); columns off the chain are zero.  Outputs (row-major):
// e (B, 3) = p_ee - target; ee_gn also g0 (B, n) = J^T e and H0 (B, n, n) =
// J^T J.  ee_err writes e alone and never forms J.
#include "rbd_common.cuh"

namespace rbd {

template <typename T, bool GN>
RBD_HD void ee_one(const Model<T, N8>& m, const T* ee, int jid, const T* q, const T* target, T* e,
                   T* g0, T* H0) {
  const int n = m.nb;
  int chain[N8::NB];
  int len = 0;
  for (int k = jid; k >= 0; k = m.parent(k)) chain[len++] = k;  // tip -> root
  T R[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1}, p[3] = {0, 0, 0};
  T axw[N8::NB][3], org[N8::NB][3];
  for (int idx = len - 1; idx >= 0; --idx) {
    const int k = chain[idx];
    const T* b = m.body(k);
    T Rp[3], R1[9];
    mv3(R, b + OFF_TP, Rp);
    for (int r = 0; r < 3; ++r) p[r] += Rp[r];
    mm3(R, b + OFF_TR, R1);
    mv3(R1, b + OFF_AXIS, axw[idx]);
    for (int r = 0; r < 3; ++r) org[idx][r] = p[r];
    if (m.jtype(k) == PRISMATIC) {
      for (int r = 0; r < 3; ++r) p[r] += q[k] * axw[idx][r];
      for (int r = 0; r < 9; ++r) R[r] = R1[r];
    } else {
      T RJ[9];
      rot_axis(b + OFF_AXIS, q[k], false, RJ);
      mm3(R1, RJ, R);
    }
  }
  T Rp[3], pe[3];
  mv3(R, ee + 9, Rp);
  for (int r = 0; r < 3; ++r) {
    pe[r] = p[r] + Rp[r];
    e[r] = pe[r] - target[r];
  }
  if constexpr (GN) {
    T J[3][N8::NB];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < n; ++c) J[r][c] = T(0);
    for (int idx = 0; idx < len; ++idx) {
      const int k = chain[idx];
      T col[3];
      if (m.jtype(k) == PRISMATIC) {
        for (int r = 0; r < 3; ++r) col[r] = axw[idx][r];
      } else {
        T rel[3] = {pe[0] - org[idx][0], pe[1] - org[idx][1], pe[2] - org[idx][2]};
        cross3(axw[idx], rel, col);
      }
      for (int r = 0; r < 3; ++r) J[r][k] = col[r];
    }
    for (int i = 0; i < n; ++i) {
      g0[i] = J[0][i] * e[0] + J[1][i] * e[1] + J[2][i] * e[2];
      for (int j = 0; j < n; ++j) H0[i * n + j] = J[0][i] * J[0][j] + J[1][i] * J[1][j] + J[2][i] * J[2][j];
    }
  }
}

}  // namespace rbd

#ifdef __CUDACC__
template <typename T, bool GN>
__global__ void ee_kernel(rbd::Model<T, rbd::N8> m, const T* __restrict__ ee, int jid,
                          const T* __restrict__ q, T tx, T ty, T tz, T* __restrict__ e,
                          T* __restrict__ g0, T* __restrict__ H0, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nb;
  const T target[3] = {tx, ty, tz};
  T qs[rbd::N8::NB], es[3];
  for (int k = 0; k < n; ++k) qs[k] = q[(size_t)b * n + k];
  if constexpr (GN) {
    T g[rbd::N8::NB], H[rbd::N8::NB * rbd::N8::NB];
    rbd::ee_one<T, true>(m, ee, jid, qs, target, es, g, H);
    for (int i = 0; i < n; ++i) g0[(size_t)b * n + i] = g[i];
    for (int i = 0; i < n * n; ++i) H0[(size_t)b * n * n + i] = H[i];
  } else {
    rbd::ee_one<T, false>(m, ee, jid, qs, target, es, nullptr, nullptr);
  }
  for (int r = 0; r < 3; ++r) e[(size_t)b * 3 + r] = es[r];
}

template <typename T, bool GN>
static int launch_ee(const T* tab, const int* itab, int nb, const T* ee, int jid, const T* q,
                     T tx, T ty, T tz, T* e, T* g0, T* H0, int B, void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T, rbd::N8> m{tab, itab, nb};
  ee_kernel<T, GN><<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
      m, ee, jid, q, tx, ty, tz, e, g0, H0, B);
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_ee_gn_n8_f32(const float* tab, const int* itab, int nb, const float* ee, int jid,
                  const float* q, float tx, float ty, float tz, float* e, float* g0, float* H0,
                  int B, void* stream) {
  return launch_ee<float, true>(tab, itab, nb, ee, jid, q, tx, ty, tz, e, g0, H0, B, stream);
}
int rbd_ee_gn_n8_f64(const double* tab, const int* itab, int nb, const double* ee, int jid,
                  const double* q, double tx, double ty, double tz, double* e, double* g0,
                  double* H0, int B, void* stream) {
  return launch_ee<double, true>(tab, itab, nb, ee, jid, q, tx, ty, tz, e, g0, H0, B, stream);
}
int rbd_ee_err_n8_f32(const float* tab, const int* itab, int nb, const float* ee, int jid,
                   const float* q, float tx, float ty, float tz, float* e, int B, void* stream) {
  return launch_ee<float, false>(tab, itab, nb, ee, jid, q, tx, ty, tz, e, nullptr, nullptr, B,
                                 stream);
}
int rbd_ee_err_n8_f64(const double* tab, const int* itab, int nb, const double* ee, int jid,
                   const double* q, double tx, double ty, double tz, double* e, int B,
                   void* stream) {
  return launch_ee<double, false>(tab, itab, nb, ee, jid, q, tx, ty, tz, e, nullptr, nullptr, B,
                                  stream);
}
}
#endif
