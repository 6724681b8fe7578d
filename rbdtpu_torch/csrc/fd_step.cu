// fd_step: one ABA + semi-implicit Euler step per batch element, with
// optional world-frame wrenches.
// Replaces rbdtpu kernels/fused.py fd_step_fused (Pallas, fused.py:450).
// One thread per element; x (B, 2n) -> xo (B, 2n) row-major; fext null (no
// wrenches) or (nb, 6) rows read at fext + b * fext_stride (stride 0: one
// wrench set shared by the batch; nb * 6: one per element).
// Bound on the H100: latency of the serial ABA walk (10.4k operations a
// state for arm7 against 140 bytes in float32) with the per-body ABA state
// in local memory (see the build's .ptxas.log); the design reads each input
// once and writes x' once, and leaves whole rollouts to rollout_multi.cu.
#include "rbd_common.cuh"

#ifdef __CUDACC__
// FEXT false compiles the wrench code out of the step.
template <typename T, bool FEXT>
__global__ void fd_step_kernel(rbd::Model<T> m, const T* __restrict__ x,
                               const T* __restrict__ u, const T* __restrict__ fext,
                               int fext_stride, T* __restrict__ xo, int B, T dt, T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nb;
  T xs[2 * rbd::NB_MAX], us[rbd::NB_MAX], out[2 * rbd::NB_MAX];
  for (int k = 0; k < 2 * n; ++k) xs[k] = x[(size_t)b * 2 * n + k];
  for (int k = 0; k < n; ++k) us[k] = u[(size_t)b * n + k];
  rbd::fd_step_state(m, xs, us, dt, gravity, out,
                     FEXT ? fext + (size_t)b * fext_stride : nullptr);
  for (int k = 0; k < 2 * n; ++k) xo[(size_t)b * 2 * n + k] = out[k];
}

template <typename T>
static int launch_fd_step(const T* tab, const int* itab, int nb, const T* x, const T* u,
                          const T* fext, int fext_stride, T* xo, int B, T dt, T gravity,
                          void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T> m{tab, itab, nb};
  if (fext != nullptr) {
    fd_step_kernel<T, true><<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
        m, x, u, fext, fext_stride, xo, B, dt, gravity);
  } else {
    fd_step_kernel<T, false><<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
        m, x, u, fext, fext_stride, xo, B, dt, gravity);
  }
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_fd_step_f32(const float* tab, const int* itab, int nb, const float* x, const float* u,
                    const float* fext, int fext_stride, float* xo, int B, float dt,
                    float gravity, void* stream) {
  return launch_fd_step<float>(tab, itab, nb, x, u, fext, fext_stride, xo, B, dt, gravity,
                               stream);
}
int rbd_fd_step_f64(const double* tab, const int* itab, int nb, const double* x,
                    const double* u, const double* fext, int fext_stride, double* xo, int B,
                    double dt, double gravity, void* stream) {
  return launch_fd_step<double>(tab, itab, nb, x, u, fext, fext_stride, xo, B, dt, gravity,
                                stream);
}
}
#endif
