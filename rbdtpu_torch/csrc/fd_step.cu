// fd_step: one ABA + semi-implicit Euler step per batch element.
// Replaces rbdtpu kernels/fused.py fd_step_fused (Pallas, fused.py:450).
// One thread per element; x (B, 2n) -> xo (B, 2n) row-major.  Register and
// local-memory use: see the build's .ptxas.log (the per-thread ABA state
// spills to local memory in double precision).
#include "rbd_common.cuh"

#ifdef __CUDACC__
template <typename T>
__global__ void fd_step_kernel(rbd::Model<T> m, const T* __restrict__ x,
                               const T* __restrict__ u, T* __restrict__ xo, int B, T dt,
                               T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nb;
  T xs[2 * rbd::NB_MAX], us[rbd::NB_MAX], out[2 * rbd::NB_MAX];
  for (int k = 0; k < 2 * n; ++k) xs[k] = x[(size_t)b * 2 * n + k];
  for (int k = 0; k < n; ++k) us[k] = u[(size_t)b * n + k];
  rbd::fd_step_state(m, xs, us, dt, gravity, out);
  for (int k = 0; k < 2 * n; ++k) xo[(size_t)b * 2 * n + k] = out[k];
}

template <typename T>
static int launch_fd_step(const T* tab, const int* itab, int nb, const T* x, const T* u, T* xo,
                          int B, T dt, T gravity, void* stream) {
  if (B <= 0) return 0;
  rbd::Model<T> m{tab, itab, nb};
  fd_step_kernel<T><<<RBD_GRID(B, RBD_THREADS), RBD_THREADS, 0, (cudaStream_t)stream>>>(
      m, x, u, xo, B, dt, gravity);
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_fd_step_f32(const float* tab, const int* itab, int nb, const float* x, const float* u,
                    float* xo, int B, float dt, float gravity, void* stream) {
  return launch_fd_step<float>(tab, itab, nb, x, u, xo, B, dt, gravity, stream);
}
int rbd_fd_step_f64(const double* tab, const int* itab, int nb, const double* x,
                    const double* u, double* xo, int B, double dt, double gravity,
                    void* stream) {
  return launch_fd_step<double>(tab, itab, nb, x, u, xo, B, dt, gravity, stream);
}
}
#endif
