// fd_step: one ABA + semi-implicit Euler step per batch element, with
// optional world-frame wrenches.
// Replaces rbdtpu kernels/fused.py fd_step_fused (Pallas, fused.py:450).
// Instantiated for fixed-base trees (N8), the rpy floating root (FB16,
// FB32) and the quaternion root (FQ32), with and without wrenches, each
// class and dtype at one team size fixed at build time
// (RBD_TEAM_fd_step_<class>_<f32|f64>, which kernels/_lib.py defines from
// its TEAM table).
//
// One team of NL lanes per element runs the step of rbd_team.cuh with the
// element's state, controls and per-body ABA state in the team's shared
// memory: x (B, nq + nv) and u (B, nv) rows are read with consecutive lanes
// on consecutive addresses, x' (B, nq + nv) written the same way (nq = nv,
// or nv + 1 on the quaternion root, whose pose the step retracts on the
// manifold).  fext is null
// (no wrenches) or (nb, 6) rows read at fext + b * fext_stride (stride 0:
// one wrench set shared by the batch; nb * 6: one per element).
//
// Bound on the H100: latency and instruction issue, not bytes or operations
// (arm7: 10.4k operations a state against 140 bytes in float32).  A small
// batch (B=1 for the MPC plant, B=128 for configs[2]'s initial rollout) is
// one team a block, so it spreads over as many SMs as it has elements and
// its time is one step's chain; a large one (configs[4]'s 2048 sampled
// states) fills the SMs, and its time is the instructions the teams issue:
// there two teams of 16 lanes a warp beat one of 32 at fb32 in float32
// (kernels/_lib.py TEAM, from the times in PERF.md §6).  The bodies are
// walked in order: the level order's tables (feedback_rollout.cu) would
// cost that 2048-state batch its eighth block an SM, and its second wave.
#include "rbd_team.cuh"

namespace rbd {

// The step's layout here: with the wrenches' chain, without the level order
// (the bodies are walked in order: at fb32 the level tables would cost the
// 2048-state batch of configs[4]'s sampling its eighth block an SM).
template <class D>
using FdLayout = TeamLayout<D, true, false>;

// Shared-memory values a team of NL lanes takes: the step's scratch, the
// element's x and u; padded so the teams of a warp start on different banks.
template <class D, int NL>
RBD_HD constexpr int fd_step_team_stride() {
  return (FdLayout<D>::VALUES + D::NQ + 2 * D::NV + 31) / 32 * 32 + NL % 32;
}

}  // namespace rbd

#ifdef __CUDACC__
template <int NL, bool FEXT, typename T, class D>
__global__ void __launch_bounds__(32)
    fd_step_kernel(rbd::Model<T, D> m, const T* __restrict__ x, const T* __restrict__ u,
                   const T* __restrict__ fext, int fext_stride, T* __restrict__ xo, int B,
                   int tpb, T dt, T gravity) {
  extern __shared__ __align__(16) unsigned char fd_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix;
  if (b >= B) return;
  const int n = m.nv();
  T* s = reinterpret_cast<T*>(fd_smem) + (size_t)tix * rbd::fd_step_team_stride<D, NL>();
  T* xs = s + rbd::FdLayout<D>::VALUES;
  T* us = xs + D::NQ + D::NV;
  if constexpr (D::QUAT) {  // x rows of nq + nv values
    const int nx = m.nq() + n;
    for (int k = tm.lane; k < nx; k += NL) xs[k] = x[(size_t)b * nx + k];
    for (int k = tm.lane; k < n; k += NL) us[k] = u[(size_t)b * n + k];
    tm.sync();
    rbd::team_fd_step<NL, FEXT, false, rbd::FdLayout<D>>(tm, m, s, xs, us, dt, gravity,
                                FEXT ? fext + (size_t)b * fext_stride : nullptr,
                                static_cast<T*>(nullptr), xo + (size_t)b * nx);
  } else {
    for (int k = tm.lane; k < 2 * n; k += NL) xs[k] = x[(size_t)b * 2 * n + k];
    for (int k = tm.lane; k < n; k += NL) us[k] = u[(size_t)b * n + k];
    tm.sync();
    rbd::team_fd_step<NL, FEXT, false, rbd::FdLayout<D>>(tm, m, s, xs, us, dt, gravity,
                                FEXT ? fext + (size_t)b * fext_stride : nullptr,
                                static_cast<T*>(nullptr), xo + (size_t)b * 2 * n);
  }
}

template <int NL, typename T, class D>
static int launch_fd_step(const T* tab, const int* itab, int nb, const T* x, const T* u,
                          const T* fext, int fext_stride, T* xo, int B, int tpb, int smem, T dt,
                          T gravity, void* stream) {
  if (B <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32) return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  auto kernel = fext != nullptr ? fd_step_kernel<NL, true, T, D> : fd_step_kernel<NL, false, T, D>;
  const int err =
      team_smem_check(kernel, smem, tpb, rbd::fd_step_team_stride<D, NL>(), sizeof(T));
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(
      m, x, u, fext, fext_stride, xo, B, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

#define RBD_FD_STEP(CLS, D, T, SFX)                                                          \
  int rbd_fd_step_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x,          \
                                const T* u, const T* fext, int fext_stride, T* xo, int B,   \
                                int tpb, int smem, T dt, T gravity, void* stream) {         \
    return launch_fd_step<RBD_TEAM_fd_step_##CLS##_##SFX, T, rbd::D>(                       \
        tab, itab, nb, x, u, fext, fext_stride, xo, B, tpb, smem, dt, gravity, stream);     \
  }

extern "C" {
RBD_FD_STEP(n8, N8, float, f32)
RBD_FD_STEP(n8, N8, double, f64)
RBD_FD_STEP(fb16, FB16, float, f32)
RBD_FD_STEP(fb16, FB16, double, f64)
RBD_FD_STEP(fb32, FB32, float, f32)
RBD_FD_STEP(fb32, FB32, double, f64)
RBD_FD_STEP(fq32, FQ32, float, f32)
RBD_FD_STEP(fq32, FQ32, double, f64)
}
#endif
