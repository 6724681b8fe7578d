// fd_step: one ABA + semi-implicit Euler step per batch element, with
// optional world-frame wrenches.
// Replaces rbdtpu kernels/fused.py fd_step_fused (Pallas, fused.py:450).
// Instantiated for fixed-base trees (N8) and the rpy floating root (FB16,
// FB32).
// One thread per element; x (B, 2nv) -> xo (B, 2nv) row-major; fext null (no
// wrenches) or (nb, 6) rows read at fext + b * fext_stride (stride 0: one
// wrench set shared by the batch; nb * 6: one per element).
// Bound on the H100: latency of the serial ABA walk (10.4k operations a
// state for arm7 against 140 bytes in float32) with the per-body ABA state
// in local memory (see the build's .ptxas.log); the design reads each input
// once and writes x' once, and leaves whole rollouts to rollout_multi.cu.
#include "rbd_common.cuh"

#ifdef __CUDACC__
// FEXT false compiles the wrench code out of the step.
template <typename T, class D, bool FEXT>
__global__ void fd_step_kernel(rbd::Model<T, D> m, const T* __restrict__ x,
                               const T* __restrict__ u, const T* __restrict__ fext,
                               int fext_stride, T* __restrict__ xo, int B, T dt, T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nv();
  T xs[2 * D::NV], us[D::NV], out[2 * D::NV];
  for (int k = 0; k < 2 * n; ++k) xs[k] = x[(size_t)b * 2 * n + k];
  for (int k = 0; k < n; ++k) us[k] = u[(size_t)b * n + k];
  rbd::fd_step_state(m, xs, us, dt, gravity, out,
                     FEXT ? fext + (size_t)b * fext_stride : nullptr);
  for (int k = 0; k < 2 * n; ++k) xo[(size_t)b * 2 * n + k] = out[k];
}

template <typename T, class D>
static int launch_fd_step(const T* tab, const int* itab, int nb, const T* x, const T* u,
                          const T* fext, int fext_stride, T* xo, int B, T dt, T gravity,
                          void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T, D> m{tab, itab, nb};
  if (fext != nullptr) {
    fd_step_kernel<T, D, true>
        <<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
            m, x, u, fext, fext_stride, xo, B, dt, gravity);
  } else {
    fd_step_kernel<T, D, false>
        <<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
            m, x, u, fext, fext_stride, xo, B, dt, gravity);
  }
  return (int)cudaGetLastError();
}

#define RBD_FD_STEP(CLS, D, T, SFX)                                                          \
  int rbd_fd_step_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x,          \
                                const T* u, const T* fext, int fext_stride, T* xo, int B,   \
                                T dt, T gravity, void* stream) {                            \
    return launch_fd_step<T, rbd::D>(tab, itab, nb, x, u, fext, fext_stride, xo, B, dt,     \
                                     gravity, stream);                                      \
  }

extern "C" {
RBD_FD_STEP(n8, N8, float, f32)
RBD_FD_STEP(n8, N8, double, f64)
RBD_FD_STEP(fb16, FB16, float, f32)
RBD_FD_STEP(fb16, FB16, double, f64)
RBD_FD_STEP(fb32, FB32, float, f32)
RBD_FD_STEP(fb32, FB32, double, f64)
}
#endif
