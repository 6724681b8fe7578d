// rollout_multi: a whole forward-dynamics rollout in one launch.
// Replaces rbdtpu kernels/fused.py rollout_fused_multi (Pallas,
// fused.py:1029), whose sequential grid axis carried the state across the
// time steps in a VMEM scratch.  Hopper runs blocks in no order, so the time
// loop moves inside the block: one team of NL lanes per trajectory
// (RBD_TEAM_rollout_multi_<class>_<f32|f64>, which kernels/_lib.py defines
// from its TEAM table) keeps the state in its shared memory for all H steps
// and writes only the final state.  Per step t, with u = U[t, b] and, with
// FEXT, the wrench set f_ext[t] shared by the batch:
//   - MINV false, route "aba": the team ABA step of rbd_team.cuh
//     (team_fd_step with the wrenches' chain), then semi-implicit Euler;
//   - MINV true, route "minv": the team's RNEA bias c = RNEA(q, qd, 0) with
//     gravity and the wrenches (team_rnea_bias), then qdd = M^-1 (u - c) by
//     the step's articulated sweeps at zero velocity and gravity
//     (team_fd_step<..., MINV>, K6's factorised step), then Euler with the
//     real qd.
// Step t + 1's u row and wrench set are copied into the other half of a
// two-stage buffer by cp.async while step t computes.  Layouts
// (row-major): x0, xo (B, nq + nv); U (H, B, nv), scan-major as in rbdtpu;
// fext null or (H, nb, 6).  One body for every class: fixed-base trees of
// up to 8 bodies (N8, nq = nv), the rpy floating root (FB16, FB32) and the
// quaternion root (FQ32): on the floating roots the rpy root's six-DoF
// block is solved on lane 0 inside the step, and on the quaternion root x
// rows hold nq = nv + 1 coordinates and Euler is K1's manifold step
// (quat_root_step on lane 0, a real call), on both routes.
//
// Bound on the H100: instruction issue and latency.  A step is a chain of
// about 5 nb team barriers (ABA) or 6 nb (M^-1 + RNEA) over 2.0k
// operations for arm7 (and ~10x that on the humanoid) against 28 bytes of
// U (float32), and the next step needs this one's result.  At B = 4096 the
// batch is one wave on arm7, and the teams' instructions, not their
// barriers, set the time: 16 lanes a team (two teams a warp) beat 32 in
// float32, 32 win in float64 (_lib.TEAM, from the times in PERF.md §6), and
// the step's leaf->root sweep takes over half of an ABA step.
#include "rbd_team.cuh"

namespace rbd {

// The step's layout here: with the wrenches' chain, bodies in order.
template <class D>
using RmLayout = TeamLayout<D, true, false>;

// Shared-memory values a team of NL lanes takes: the step's scratch, x
// (nq + nv), two stages of u and of the wrench set, and the minv route's
// u - c; padded so the teams of a warp start on different banks.
template <class D, int NL>
RBD_HD constexpr int rollout_multi_team_stride() {
  return (RmLayout<D>::VALUES + D::NQ + 4 * D::NV + 12 * D::NB + 31) / 32 * 32 + NL % 32;
}

// Step t's u row (at U + t * ustride) and, with FEXT, wrench set into
// stage buffers bu (n = nv values) and bf (nb x 6).
template <int NL, bool FEXT, typename T>
RBD_HD void rollout_load_step(const Team<NL>& tm, int n, int nb, int t, const T* U,
                              size_t ustride, const T* fext, T* bu, T* bf) {
  for (int k = tm.lane; k < n; k += NL) copy_async(bu + k, U + t * ustride + k);
  if constexpr (FEXT) {
    for (int k = tm.lane; k < 6 * nb; k += NL)
      copy_async(bf + k, fext + (size_t)t * 6 * nb + k);
  }
  copy_async_commit();
}

// One trajectory by the team ``tm`` with shared scratch ``s``
// (rollout_multi_team_stride values) on a tree of the class D: x0 and xo
// at its row (nq + nv = 2 nv values, one more on the quaternion root), U
// at its row of knot 0 with a knot stride of ustride values, fext
// (H, nb, 6).
template <int NL, bool MINV, bool FEXT, typename T, class D>
RBD_HD void rollout_team(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x0,
                         const T* U, size_t ustride, const T* fext, T* xo, int H, T dt,
                         T gravity) {
  using L = RmLayout<D>;
  constexpr int NV = D::NV, NB = D::NB;
  const int n = m.nv(), nx = 2 * n + D::QUAT;
  T* xs = s + L::VALUES;
  T* bu = xs + D::NQ + NV;  // two stages of NV
  T* rhs = bu + 2 * NV;
  T* bf = rhs + NV;  // two stages of 6 NB
  for (int k = tm.lane; k < nx; k += NL) xs[k] = x0[k];
  if (H <= 0) {
    for (int k = tm.lane; k < nx; k += NL) xo[k] = x0[k];
    return;
  }
  rollout_load_step<NL, FEXT>(tm, n, m.nb, 0, U, ustride, fext, bu, bf);
  for (int t = 0; t < H; ++t) {
    copy_async_wait();
    tm.sync();  // step t's inputs and x are in; step t - 1 has left its stage
    const int st = t & 1;
    if (t + 1 < H)
      rollout_load_step<NL, FEXT>(tm, n, m.nb, t + 1, U, ustride, fext, bu + (1 - st) * NV,
                                  bf + (1 - st) * 6 * NB);
    const T* u = bu + st * NV;
    const T* fe = FEXT ? bf + st * 6 * NB : nullptr;
    T* xg = t + 1 == H ? xo : nullptr;
    if constexpr (MINV) {
      team_rnea_bias<NL, FEXT, L>(tm, m, s, xs, u, gravity, fe, rhs);
      team_fd_step<NL, false, false, L, true>(tm, m, s, xs, rhs, dt, gravity,
                                              static_cast<const T*>(nullptr), xs, xg);
    } else {
      team_fd_step<NL, FEXT, false, L>(tm, m, s, xs, u, dt, gravity, fe, xs, xg);
    }
  }
}

}  // namespace rbd

#ifdef __CUDACC__
template <int NL, bool MINV, bool FEXT, typename T, class D>
__global__ void __launch_bounds__(32)
    rollout_multi_kernel(rbd::Model<T, D> m, const T* __restrict__ x0, const T* __restrict__ U,
                         const T* __restrict__ fext, T* __restrict__ xo, int B, int H, int tpb,
                         T dt, T gravity) {
  extern __shared__ __align__(16) unsigned char rm_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix;
  if (b >= B) return;
  const int n = m.nv();
  // the trajectory's x row: 2 nv values, one more on the quaternion root
  const size_t row = (size_t)b * 2 * n + (size_t)b * D::QUAT;
  T* s = reinterpret_cast<T*>(rm_smem) + (size_t)tix * rbd::rollout_multi_team_stride<D, NL>();
  rbd::rollout_team<NL, MINV, FEXT>(tm, m, s, x0 + row, U + (size_t)b * n, (size_t)B * n, fext,
                                    xo + row, H, dt, gravity);
}

template <int NL, typename T, class D>
static int launch_rollout_multi(const T* tab, const int* itab, int nb, const T* x0, const T* U,
                                const T* fext, T* xo, int B, int H, int minv, int tpb,
                                int smem, T dt, T gravity, void* stream) {
  if (B <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32) return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  using K = void (*)(rbd::Model<T, D>, const T*, const T*, const T*, T*, int, int, int, T, T);
  const K kernel = minv ? (fext != nullptr ? rollout_multi_kernel<NL, true, true, T, D>
                                           : rollout_multi_kernel<NL, true, false, T, D>)
                        : (fext != nullptr ? rollout_multi_kernel<NL, false, true, T, D>
                                           : rollout_multi_kernel<NL, false, false, T, D>);
  const int err =
      team_smem_check(kernel, smem, tpb, rbd::rollout_multi_team_stride<D, NL>(), sizeof(T));
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(m, x0, U, fext, xo, B,
                                                                       H, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

#define RBD_ROLLOUT_MULTI(CLS, D, T, SFX)                                                      \
  int rbd_rollout_multi_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x0,     \
                                      const T* U, const T* fext, T* xo, int B, int H,         \
                                      int minv, int tpb, int smem, T dt, T gravity,           \
                                      void* stream) {                                         \
    return launch_rollout_multi<RBD_TEAM_rollout_multi_##CLS##_##SFX, T, rbd::D>(             \
        tab, itab, nb, x0, U, fext, xo, B, H, minv, tpb, smem, dt, gravity, stream);          \
  }

extern "C" {
RBD_ROLLOUT_MULTI(n8, N8, float, f32)
RBD_ROLLOUT_MULTI(n8, N8, double, f64)
RBD_ROLLOUT_MULTI(fb16, FB16, float, f32)
RBD_ROLLOUT_MULTI(fb16, FB16, double, f64)
RBD_ROLLOUT_MULTI(fb32, FB32, float, f32)
RBD_ROLLOUT_MULTI(fb32, FB32, double, f64)
RBD_ROLLOUT_MULTI(fq32, FQ32, float, f32)
RBD_ROLLOUT_MULTI(fq32, FQ32, double, f64)
}
#endif
