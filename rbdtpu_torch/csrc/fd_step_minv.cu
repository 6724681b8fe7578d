// fd_step_minv: one forward-dynamics step on the M^-1 + RNEA route.
// Replaces rbdtpu kernels/fused.py fd_step_minv_fused (Pallas,
// fused.py:1267; its step is _step_lane's route "minv").  Instantiated for
// fixed-base trees (N8), the rpy floating root (FB16, FB32) and the
// quaternion root (FQ32), with and without wrenches, on both routes, each
// class and dtype at one team size fixed at build time
// (RBD_TEAM_fd_step_minv_<class>_<f32|f64>, which kernels/_lib.py defines
// from its TEAM table).
//
// One team of NL lanes per element, with the element's state, controls and
// per-body state in the team's shared memory (rbd_team.cuh):
//   - the bias c = RNEA(q, qd, 0) with gravity and, when fext is not null,
//     the world-frame wrenches (team_rnea_bias), into rhs = u - c;
//   - by default (the factorised route) qdd = M^-1 rhs by the articulated
//     sweeps at zero velocity and gravity (team_fd_step<..., MINV>; the rpy
//     root's block is solved on lane 0), then semi-implicit Euler with the
//     real qd: K5's minv step, one per launch;
//   - with DENSE the same sweeps' factorisation alone (FACTOR), the rpy
//     root's IA0^-1, the explicit M^-1 one column a lane
//     (team_minv_columns, as K3 builds it: one 6-value slot a tree level a
//     lane), then qdd = M^-1 rhs one lane a row and Euler.
// On the quaternion root q has nq = nv + 1 values, the bias's root
// transform is floating_quat_xc's and Euler is the manifold step (the
// root's pose by quat_root_step on lane 0, as K1's; on the dense route
// after qdd is gathered in the step's qdd slots).
// x (B, nq + nv) -> xo (B, nq + nv); u (B, nv); fext (nb, 6) rows at
// fext + b * fext_stride (stride 0: shared by the batch).  Rows are read
// and written with consecutive lanes on consecutive addresses.
//
// Bound on the H100: latency and instruction issue, not bytes or operations
// (arm7: 11.1k operations a state, 16.5k dense, against 140 bytes in
// float32): a step is a chain of about 6 nb team barriers (factorised); the
// dense route adds nv columns' walks of 2 nb bodies, NL at a time.  The
// whole-horizon kernel (rollout_multi.cu) runs the factorised step without
// the per-step launch.
#include "rbd_team.cuh"

namespace rbd {

// K6's shared memory per team, in values of T: the step's scratch with the
// wrenches' chain (TL, bodies in order), the element's x (nq + nv), u and
// u - c; with
// DENSE the rpy root's IA0^-1, the M^-1 columns' slots (6 values a tree
// level a lane) and M^-1 (NV rows of LDM).  STRIDE pads a team so the teams
// of a warp start on different banks (kernels/_lib.py team_values).
template <class D, int NL, bool DENSE>
struct MinvStepLayout {
  using TL = TeamLayout<D, true, false>;
  static constexpr int NV = D::NV, LV = lin_levels<D>(), LDM = NV + 1;
  static constexpr int XS = TL::VALUES, US = XS + D::NQ + NV, RHS = US + NV, FBI = RHS + NV,
                       COL = FBI + 36, MS = COL + 6 * LV * NL,
                       VALUES = DENSE ? MS + NV * LDM : FBI,
                       STRIDE = (VALUES + 31) / 32 * 32 + NL % 32;
};

// One element's step by the team ``tm`` with shared scratch ``s``
// (MinvStepLayout STRIDE values): x, u and xo at its row, fext its wrench
// set (FEXT).  A tree deeper than the layout's levels (which
// _lib.size_class never sends) gives NaN on the dense route.
template <int NL, bool DENSE, bool FEXT, typename T, class D>
RBD_HD void fd_step_minv_team(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x,
                              const T* u, const T* fext, T* xo, T dt, T gravity) {
  using K = MinvStepLayout<D, NL, DENSE>;
  using TL = typename K::TL;
  const int n = m.nv(), nq = m.nq(), nb = m.nb, lane = tm.lane;
  // the preorder and each body's depth (_lib.model_tables), which the dense
  // route's columns walk
  [[maybe_unused]] const int* pre = m.itab + 3 * nb + 2 + m.itab[3 * nb];
  [[maybe_unused]] const int* dep = pre + nb;
  if constexpr (DENSE) {
    bool deep = false;
    for (int i = 0; i < nb; ++i) deep |= dep[i] >= K::LV;
    if (deep) {
      for (int e = lane; e < nq + n; e += NL) xo[e] = T(0) / T(0);
      return;
    }
  }
  T* xs = s + K::XS;
  T* us = s + K::US;
  T* rhs = s + K::RHS;
  // (the other classes keep their own loops, which compile as before)
  if constexpr (D::QUAT) {
    for (int k = lane; k < nq + n; k += NL) xs[k] = x[k];
    for (int k = lane; k < n; k += NL) us[k] = u[k];
  } else {
    for (int k = lane; k < n; k += NL) {
      xs[k] = x[k];
      xs[n + k] = x[n + k];
      us[k] = u[k];
    }
  }
  tm.sync();
  team_rnea_bias<NL, FEXT, TL>(tm, m, s, xs, us, gravity, fext, rhs);
  if constexpr (!DENSE) {
    team_fd_step<NL, false, false, TL, true>(tm, m, s, xs, rhs, dt, gravity,
                                             static_cast<const T*>(nullptr),
                                             static_cast<T*>(nullptr), xo);
  } else {
    team_fd_step<NL, false, false, TL, true, true>(tm, m, s, xs, rhs, dt, gravity,
                                                   static_cast<const T*>(nullptr),
                                                   static_cast<T*>(nullptr),
                                                   static_cast<T*>(nullptr));
    T* fbi = s + K::FBI;
    T* Ms = s + K::MS;
    if constexpr (D::FB) {
      if (lane == NL - 1) inverse6(s + TL::IA, fbi);
    }
    tm.sync();
    team_minv_columns<NL, K::LV, K::LDM>(
        tm, m, pre, dep, reinterpret_cast<const Xc<T>*>(s + TL::X),
        reinterpret_cast<const T(*)[6]>(s + TL::U), s + TL::INVD, fbi, s + K::COL, Ms);
    tm.sync();
    // qdd = M^-1 (u - c) one lane a row (the upper triangle mirrored), then
    // semi-implicit Euler of that coordinate; on the quaternion root qdd
    // goes to the step's qdd slots first, and the root's six rows step on
    // the manifold on lane 0 (team_fd_step's Euler)
    if constexpr (D::QUAT) {
      T* qdd = s + TL::QDD;
      for (int r = lane; r < n; r += NL) {
        T acc = 0;
        for (int c = 0; c < n; ++c)
          acc += (r <= c ? Ms[r * K::LDM + c] : Ms[c * K::LDM + r]) * rhs[c];
        qdd[r] = acc;
      }
      tm.sync();
      if (lane == 0) {
        T qdn[6], pose[7];
        for (int k = 0; k < 6; ++k) qdn[k] = xs[nq + k] + dt * qdd[k];
        quat_root_step(xs, qdn, dt, pose);
        for (int k = 0; k < 7; ++k) xo[k] = pose[k];
        for (int k = 0; k < 6; ++k) xo[nq + k] = qdn[k];
      }
      for (int k = 6 + lane; k < n; k += NL) {
        const T qdn = xs[nq + k] + dt * qdd[k];
        xo[k + 1] = xs[k + 1] + dt * qdn;
        xo[nq + k] = qdn;
      }
    } else {
      for (int r = lane; r < n; r += NL) {
        T acc = 0;
        for (int c = 0; c < n; ++c)
          acc += (r <= c ? Ms[r * K::LDM + c] : Ms[c * K::LDM + r]) * rhs[c];
        const T qdn = xs[n + r] + dt * acc, qn = xs[r] + dt * qdn;
        xo[r] = qn;
        xo[n + r] = qdn;
      }
    }
  }
}

}  // namespace rbd

#ifdef __CUDACC__
// tpb teams of NL lanes a block, one team an element; FEXT false compiles
// the wrench code out of the step.
template <int NL, bool DENSE, bool FEXT, typename T, class D>
__global__ void __launch_bounds__(32)
    fd_step_minv_kernel(rbd::Model<T, D> m, const T* __restrict__ x, const T* __restrict__ u,
                        const T* __restrict__ fext, int fext_stride, T* __restrict__ xo, int B,
                        int tpb, T dt, T gravity) {
  extern __shared__ __align__(16) unsigned char k6_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix;
  if (b >= B) return;
  const int n = m.nv();
  // x's row: 2 nv values, nq + nv on the quaternion root
  const size_t o = D::QUAT ? (size_t)b * (m.nq() + n) : (size_t)b * 2 * n;
  T* s = reinterpret_cast<T*>(k6_smem) +
         (size_t)tix * rbd::MinvStepLayout<D, NL, DENSE>::STRIDE;
  rbd::fd_step_minv_team<NL, DENSE, FEXT>(tm, m, s, x + o, u + (size_t)b * n,
                                          FEXT ? fext + (size_t)b * fext_stride : nullptr,
                                          xo + o, dt, gravity);
}

template <int NL, typename T, class D>
static int launch_fd_step_minv(const T* tab, const int* itab, int nb, const T* x, const T* u,
                               const T* fext, int fext_stride, T* xo, int B, int dense, int tpb,
                               int smem, T dt, T gravity, void* stream) {
  if (B <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32) return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  auto kernel = dense ? (fext != nullptr ? fd_step_minv_kernel<NL, true, true, T, D>
                                         : fd_step_minv_kernel<NL, true, false, T, D>)
                      : (fext != nullptr ? fd_step_minv_kernel<NL, false, true, T, D>
                                         : fd_step_minv_kernel<NL, false, false, T, D>);
  const int stride = dense ? rbd::MinvStepLayout<D, NL, true>::STRIDE
                           : rbd::MinvStepLayout<D, NL, false>::STRIDE;
  const int err = team_smem_check(kernel, smem, tpb, stride, sizeof(T));
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(
      m, x, u, fext, fext_stride, xo, B, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

#define RBD_FD_STEP_MINV(CLS, D, T, SFX)                                                     \
  int rbd_fd_step_minv_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x,     \
                                     const T* u, const T* fext, int fext_stride, T* xo,     \
                                     int B, int dense, int tpb, int smem, T dt, T gravity,  \
                                     void* stream) {                                        \
    return launch_fd_step_minv<RBD_TEAM_fd_step_minv_##CLS##_##SFX, T, rbd::D>(              \
        tab, itab, nb, x, u, fext, fext_stride, xo, B, dense, tpb, smem, dt, gravity,       \
        stream);                                                                            \
  }

extern "C" {
RBD_FD_STEP_MINV(n8, N8, float, f32)
RBD_FD_STEP_MINV(n8, N8, double, f64)
RBD_FD_STEP_MINV(fb16, FB16, float, f32)
RBD_FD_STEP_MINV(fb16, FB16, double, f64)
RBD_FD_STEP_MINV(fb32, FB32, float, f32)
RBD_FD_STEP_MINV(fb32, FB32, double, f64)
RBD_FD_STEP_MINV(fq32, FQ32, float, f32)
RBD_FD_STEP_MINV(fq32, FQ32, double, f64)
}
#endif
