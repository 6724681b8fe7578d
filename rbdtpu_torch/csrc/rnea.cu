// rnea: inverse-dynamics joint forces, with or without joint accelerations.
// Replaces rbdtpu kernels/fused.py rnea_fused (Pallas, fused.py:358).
//
// One thread per state: the compact joint transforms, then the shared RNEA
// sweeps (rbd_common.cuh rnea_sweeps) and tau = S^T f.  q, qd, qdd, tau are
// (B, n) row-major.  Two instantiations: with qdd, and without it, where the
// acceleration term is a compile-time zero rather than a zero array read
// from memory.
// Bound on the H100: arithmetic, 3.4k operations a state for arm7 (3.5k
// with qdd) against 84-112 bytes (float32) of traffic, and latency: each
// thread walks the tree serially with its per-body velocities,
// accelerations and forces in local memory (L1-cached).  The design keeps the traffic at its minimum (each
// input read once, tau written once) and takes one thread per state so that
// large batches fill the card; 64-thread blocks put B=4096 on 64 SMs.
#include "rbd_common.cuh"

#ifdef __CUDACC__
template <typename T, bool HAS_QDD>
__global__ void rnea_kernel(rbd::Model<T, rbd::N8> m, const T* __restrict__ q,
                            const T* __restrict__ qd,
                            const T* __restrict__ qdd, T* __restrict__ tau, int B, T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nb;
  const size_t o = (size_t)b * n;
  T qs[rbd::N8::NB], qds[rbd::N8::NB], qdds[rbd::N8::NB], taus[rbd::N8::NB];
  for (int k = 0; k < n; ++k) {
    qs[k] = q[o + k];
    qds[k] = qd[o + k];
    if (HAS_QDD) qdds[k] = qdd[o + k];
  }
  rbd::Xc<T> X[rbd::N8::NB];
  rbd::joint_transforms(m, qs, X);
  const T* qdd_s = HAS_QDD ? qdds : nullptr;
  rbd::rnea_tau(m, X, qds, qdd_s, gravity, static_cast<const T*>(nullptr), taus);
  for (int k = 0; k < n; ++k) tau[o + k] = taus[k];
}

template <typename T>
static int launch_rnea(const T* tab, const int* itab, int nb, const T* q, const T* qd,
                       const T* qdd, T* tau, int B, T gravity, void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T, rbd::N8> m{tab, itab, nb};
  if (qdd != nullptr) {
    rnea_kernel<T, true><<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
        m, q, qd, qdd, tau, B, gravity);
  } else {
    rnea_kernel<T, false><<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
        m, q, qd, qdd, tau, B, gravity);
  }
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_rnea_n8_f32(const float* tab, const int* itab, int nb, const float* q, const float* qd,
                 const float* qdd, float* tau, int B, float gravity, void* stream) {
  return launch_rnea<float>(tab, itab, nb, q, qd, qdd, tau, B, gravity, stream);
}
int rbd_rnea_n8_f64(const double* tab, const int* itab, int nb, const double* q, const double* qd,
                 const double* qdd, double* tau, int B, double gravity, void* stream) {
  return launch_rnea<double>(tab, itab, nb, q, qd, qdd, tau, B, gravity, stream);
}
}
#endif
