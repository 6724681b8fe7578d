// fd_step_minv: one forward-dynamics step on the M^-1 + RNEA route.
// Replaces rbdtpu kernels/fused.py fd_step_minv_fused (Pallas,
// fused.py:1267).
//
// One thread per element: the bias c = RNEA(q, qd, 0), with world-frame
// wrenches when fext is not null; then qdd = M^-1 (u - c), by default through
// the articulated-inertia factorisation applied to that one vector
// (rbd_common.cuh minv_apply, O(n)), or with DENSE through the explicit
// M^-1 (minv_dense, O(n^2), kept a real call); then semi-implicit Euler.
// x (B, 2n) -> xo (B, 2n); u (B, n); fext (nb, 6) rows at
// fext + b * fext_stride (stride 0: shared by the batch).
// Bound on the H100: arithmetic and latency, as the ABA step (fd_step.cu):
// 11.1k operations a state for arm7 (16.5k dense) against 140 bytes
// (float32), the sweep
// state of every body in local memory.  The design reads each input once and
// writes the new state once; the whole-horizon kernel (rollout_multi.cu)
// runs the same step without the per-step launch.
#include "rbd_common.cuh"

#ifdef __CUDACC__
// FEXT false compiles the wrench code out of the step.
template <typename T, bool DENSE, bool FEXT>
__global__ void fd_step_minv_kernel(rbd::Model<T> m, const T* __restrict__ x,
                                    const T* __restrict__ u, const T* __restrict__ fext,
                                    int fext_stride, T* __restrict__ xo, int B, T dt,
                                    T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nb;
  T xs[2 * rbd::NB_MAX], us[rbd::NB_MAX], out[2 * rbd::NB_MAX];
  for (int k = 0; k < 2 * n; ++k) xs[k] = x[(size_t)b * 2 * n + k];
  for (int k = 0; k < n; ++k) us[k] = u[(size_t)b * n + k];
  rbd::fd_step_minv_state<T, DENSE>(m, xs, us, dt, gravity, out,
                                    FEXT ? fext + (size_t)b * fext_stride : nullptr);
  for (int k = 0; k < 2 * n; ++k) xo[(size_t)b * 2 * n + k] = out[k];
}

template <typename T>
static int launch_fd_step_minv(const T* tab, const int* itab, int nb, const T* x, const T* u,
                               const T* fext, int fext_stride, T* xo, int B, int dense, T dt,
                               T gravity, void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T> m{tab, itab, nb};
  const dim3 grid(RBD_GRID(B, RBD_THREADS)), block(RBD_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (dense && fext != nullptr) {
    fd_step_minv_kernel<T, true, true><<<grid, block, 0, st>>>(m, x, u, fext, fext_stride, xo, B,
                                                               dt, gravity);
  } else if (dense) {
    fd_step_minv_kernel<T, true, false><<<grid, block, 0, st>>>(m, x, u, fext, fext_stride, xo,
                                                                B, dt, gravity);
  } else if (fext != nullptr) {
    fd_step_minv_kernel<T, false, true><<<grid, block, 0, st>>>(m, x, u, fext, fext_stride, xo,
                                                                B, dt, gravity);
  } else {
    fd_step_minv_kernel<T, false, false><<<grid, block, 0, st>>>(m, x, u, fext, fext_stride, xo,
                                                                 B, dt, gravity);
  }
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_fd_step_minv_f32(const float* tab, const int* itab, int nb, const float* x,
                         const float* u, const float* fext, int fext_stride, float* xo, int B,
                         int dense, float dt, float gravity, void* stream) {
  return launch_fd_step_minv<float>(tab, itab, nb, x, u, fext, fext_stride, xo, B, dense, dt,
                                    gravity, stream);
}
int rbd_fd_step_minv_f64(const double* tab, const int* itab, int nb, const double* x,
                         const double* u, const double* fext, int fext_stride, double* xo,
                         int B, int dense, double dt, double gravity, void* stream) {
  return launch_fd_step_minv<double>(tab, itab, nb, x, u, fext, fext_stride, xo, B, dense, dt,
                                     gravity, stream);
}
}
#endif
