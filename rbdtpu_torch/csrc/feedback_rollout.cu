// feedback_rollout: the DDP line-search rollout, whole horizon per launch.
// Replaces rbdtpu kernels/fused.py feedback_rollout_fused (Pallas,
// fused.py:611), which launched once per knot inside lax.scan.
//
// One thread per trajectory loops over the H knots with its state held in
// the thread:  dx = x - Xn_t;  u = Un_t + kf_t + Kf_t dx  (alpha is already
// folded into kf);  u clamped to [-uclip, uclip] when uclip is given; then
// ABA and semi-implicit Euler.  Writes states 1..H and the applied u.
// Layouts (row-major): x0 (B, nx), Xn/Xo (B, H, nx), Un/kf/Uo (B, H, n),
// Kf (B, H, n, nx), n = nv and nx = 2 nv (the rpy root's dx is the flat
// difference, as rbdtpu's).  Instantiated for N8, FB16 and FB32.  Each
// thread reads its n*nx gains per knot as one contiguous run, uncoalesced
// across the warp; small blocks (32 threads) spread 1024 trajectories over
// 32 SMs.  feedback_chunked.cu stages the gains through shared memory.
#include "rbd_common.cuh"

namespace rbd {

// One trajectory: pointers already offset to it (Xn/Un/kf/Kf/Xo/Uo start at
// its knot 0).
template <typename T, class D>
RBD_HD void feedback_rollout_one(const Model<T, D>& m, const T* x0, const T* Xn, const T* Un,
                                 const T* kf, const T* Kf, const T* uclip, T* Xo, T* Uo, int H,
                                 T dt, T gravity) {
  const int n = m.nv(), nx = 2 * n;
  T x[2 * D::NV], xn[2 * D::NV], dx[2 * D::NV], u[D::NV];
  for (int k = 0; k < nx; ++k) x[k] = x0[k];
  for (int t = 0; t < H; ++t) {
    for (int k = 0; k < nx; ++k) dx[k] = x[k] - Xn[t * nx + k];
    const T* K = Kf + (size_t)t * n * nx;
    for (int i = 0; i < n; ++i) {
      T acc = Un[t * n + i] + kf[t * n + i];
      for (int j = 0; j < nx; ++j) acc += K[i * nx + j] * dx[j];
      if (uclip != nullptr) {  // torch.clamp semantics: NaN stays NaN
        acc = acc < -uclip[i] ? -uclip[i] : (acc > uclip[i] ? uclip[i] : acc);
      }
      u[i] = acc;
    }
    fd_step_state(m, x, u, dt, gravity, xn);
    for (int k = 0; k < nx; ++k) {
      x[k] = xn[k];
      Xo[t * nx + k] = xn[k];
    }
    for (int i = 0; i < n; ++i) Uo[t * n + i] = u[i];
  }
}

}  // namespace rbd

#ifdef __CUDACC__
#define RBD_FB_THREADS 32

template <typename T, class D>
__global__ void feedback_rollout_kernel(rbd::Model<T, D> m, const T* __restrict__ x0,
                                        const T* __restrict__ Xn, const T* __restrict__ Un,
                                        const T* __restrict__ kf, const T* __restrict__ Kf,
                                        const T* __restrict__ uclip, T* __restrict__ Xo,
                                        T* __restrict__ Uo, int B, int H, T dt, T gravity) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = m.nv(), nx = 2 * n;
  const size_t bx = (size_t)b * H * nx, bu = (size_t)b * H * n;
  rbd::feedback_rollout_one(m, x0 + (size_t)b * nx, Xn + bx, Un + bu, kf + bu, Kf + bu * nx,
                            uclip, Xo + bx, Uo + bu, H, dt, gravity);
}

template <typename T, class D>
static int launch_feedback_rollout(const T* tab, const int* itab, int nb, const T* x0,
                                   const T* Xn, const T* Un, const T* kf, const T* Kf,
                                   const T* uclip, T* Xo, T* Uo, int B, int H, T dt, T gravity,
                                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  rbd::Model<T, D> m{tab, itab, nb};
  feedback_rollout_kernel<T, D>
      <<<RBD_GRID(B, RBD_FB_THREADS), RBD_FB_THREADS, 0, (cudaStream_t)stream>>>(
          m, x0, Xn, Un, kf, Kf, uclip, Xo, Uo, B, H, dt, gravity);
  return (int)cudaGetLastError();
}

#define RBD_FEEDBACK_ROLLOUT(CLS, D, T, SFX)                                                 \
  int rbd_feedback_rollout_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x0, \
                                         const T* Xn, const T* Un, const T* kf, const T* Kf, \
                                         const T* uclip, T* Xo, T* Uo, int B, int H, T dt,   \
                                         T gravity, void* stream) {                          \
    return launch_feedback_rollout<T, rbd::D>(tab, itab, nb, x0, Xn, Un, kf, Kf, uclip, Xo,  \
                                              Uo, B, H, dt, gravity, stream);                \
  }

extern "C" {
RBD_FEEDBACK_ROLLOUT(n8, N8, float, f32)
RBD_FEEDBACK_ROLLOUT(n8, N8, double, f64)
RBD_FEEDBACK_ROLLOUT(fb16, FB16, float, f32)
RBD_FEEDBACK_ROLLOUT(fb16, FB16, double, f64)
RBD_FEEDBACK_ROLLOUT(fb32, FB32, float, f32)
RBD_FEEDBACK_ROLLOUT(fb32, FB32, double, f64)
}
#endif
