// rollout_multi: a whole forward-dynamics rollout in one launch.
// Replaces rbdtpu kernels/fused.py rollout_fused_multi (Pallas,
// fused.py:1029), whose sequential grid axis carried the state across the
// time steps in a VMEM scratch.  Hopper runs blocks in no order, so the time
// loop moves inside the thread: one thread per trajectory keeps its state in
// the thread for all H steps, reads U[t, b, :] (and the wrench set f_ext[t]
// shared by the batch) per step, and writes only the final state.
// Template MINV picks the route: false is the ABA step (rbd_common.cuh
// fd_step_state, the body of fd_step.cu); true is the M^-1 + RNEA step
// (fd_step_minv_state with the factorised M^-1 apply, the body of
// fd_step_minv.cu); FEXT false compiles the wrench code out.
// Layouts (row-major): x0, xo (B, 2n); U (H, B, n), scan-major as in rbdtpu;
// fext null or (H, nb, 6).
// Bound on the H100: arithmetic and latency.  A step is a serial tree walk
// of 10.4k (ABA) or 11.1k (M^-1) operations for arm7 against 28 bytes of U
// (float32), and the next step
// needs this one's result, so each thread is a long dependent chain.  At
// B=4096 there are only 4096 threads: blocks of 32 spread them over 128 of
// the 132 SMs, one warp per SM, so the card's latency hiding comes from
// instruction-level parallelism inside the step, not from other warps.
#include "rbd_common.cuh"

namespace rbd {

// One trajectory: x0 and xo at its row, U at row b of knot 0 with a knot
// stride of ustride values; fext (H, nb, 6), read only with FEXT.
template <typename T, bool MINV, bool FEXT>
RBD_HD void rollout_one(const Model<T, N8>& m, const T* x0, const T* U, size_t ustride,
                        const T* fext, T* xo, int H, T dt, T gravity) {
  const int n = m.nb, nx = 2 * n;
  T x[2 * N8::NB], xn[2 * N8::NB], u[N8::NB];
  for (int k = 0; k < nx; ++k) x[k] = x0[k];
  for (int t = 0; t < H; ++t) {
    for (int k = 0; k < n; ++k) u[k] = U[t * ustride + k];
    const T* fe = FEXT ? fext + (size_t)t * n * 6 : nullptr;
    if (MINV) {
      fd_step_minv_state<T, N8, false>(m, x, u, dt, gravity, xn, fe);
    } else {
      fd_step_state(m, x, u, dt, gravity, xn, fe);
    }
    for (int k = 0; k < nx; ++k) x[k] = xn[k];
  }
  for (int k = 0; k < nx; ++k) xo[k] = x[k];
}

}  // namespace rbd

#ifdef __CUDACC__
#define RBD_RM_THREADS 32

template <typename T, bool MINV, bool FEXT>
__global__ void rollout_multi_kernel(rbd::Model<T, rbd::N8> m, const T* __restrict__ x0,
                                     const T* __restrict__ U, const T* __restrict__ fext,
                                     T* __restrict__ xo, int B, int H, T dt, T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nb;
  rbd::rollout_one<T, MINV, FEXT>(m, x0 + (size_t)b * 2 * n, U + (size_t)b * n, (size_t)B * n,
                                  fext, xo + (size_t)b * 2 * n, H, dt, gravity);
}

template <typename T>
static int launch_rollout_multi(const T* tab, const int* itab, int nb, const T* x0, const T* U,
                                const T* fext, T* xo, int B, int H, int minv, T dt, T gravity,
                                void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T, rbd::N8> m{tab, itab, nb};
  const dim3 grid(RBD_GRID(B, RBD_RM_THREADS)), block(RBD_RM_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (minv && fext != nullptr) {
    rollout_multi_kernel<T, true, true><<<grid, block, 0, st>>>(m, x0, U, fext, xo, B, H, dt,
                                                                gravity);
  } else if (minv) {
    rollout_multi_kernel<T, true, false><<<grid, block, 0, st>>>(m, x0, U, fext, xo, B, H, dt,
                                                                 gravity);
  } else if (fext != nullptr) {
    rollout_multi_kernel<T, false, true><<<grid, block, 0, st>>>(m, x0, U, fext, xo, B, H, dt,
                                                                 gravity);
  } else {
    rollout_multi_kernel<T, false, false><<<grid, block, 0, st>>>(m, x0, U, fext, xo, B, H, dt,
                                                                  gravity);
  }
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_rollout_multi_n8_f32(const float* tab, const int* itab, int nb, const float* x0,
                          const float* U, const float* fext, float* xo, int B, int H, int minv,
                          float dt, float gravity, void* stream) {
  return launch_rollout_multi<float>(tab, itab, nb, x0, U, fext, xo, B, H, minv, dt, gravity,
                                     stream);
}
int rbd_rollout_multi_n8_f64(const double* tab, const int* itab, int nb, const double* x0,
                          const double* U, const double* fext, double* xo, int B, int H,
                          int minv, double dt, double gravity, void* stream) {
  return launch_rollout_multi<double>(tab, itab, nb, x0, U, fext, xo, B, H, minv, dt, gravity,
                                      stream);
}
}
#endif
