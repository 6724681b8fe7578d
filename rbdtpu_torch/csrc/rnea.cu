// rnea: inverse-dynamics joint forces, with or without joint accelerations.
// Replaces rbdtpu kernels/fused.py rnea_fused (Pallas, fused.py:358).
// Instantiated for fixed-base trees (N8), the rpy floating root (FB16,
// FB32) and the quaternion root (FQ32), with and without qdd, each class
// and dtype at one team size fixed at build time
// (RBD_TEAM_rnea_<class>_<f32|f64>, which kernels/_lib.py defines from its
// TEAM table).
//
// One team of NL lanes per state runs rbd_team.cuh's team_rnea with the
// state's q, qd (and qdd) and the per-body transforms, velocities,
// accelerations and forces in the team's shared memory: the transforms one
// lane a body, the root->leaf recursions one lane a component, the body
// forces one lane a value, the leaf->root sum one lane a component, and tau
// (B, nv) written one lane a row.  q (B, nq), qd, qdd, tau (B, nv) are
// row-major (nq = nv, or nv + 1 on the quaternion root, whose root
// transform is floating_quat_xc's), read and written with consecutive lanes
// on consecutive addresses.  Without
// qdd the acceleration term is compiled out rather than read as zeros.
//
// Bound on the H100: latency and instruction issue, not bytes or operations
// (arm7: 3.4k operations a state against 84-112 bytes in float32).  A state
// is a chain of about 2 nb team barriers; the layout (RneaLayout) holds only
// what RNEA reads, 52 values a body, so a block of one warp of teams takes
// little shared memory and the batch fills the SMs in few waves.
#include "rbd_team.cuh"

namespace rbd {

// team_rnea's scratch in values of T: compact transforms, the dense
// transforms' lower-left blocks, v, a (C), I v (U), the body forces (PA),
// S and the parents (team_transforms and team_rnea name them as
// TeamLayout does); no wrenches.
template <class D>
struct RneaLayout {
  static constexpr bool WRENCH = false;
  static constexpr int NB = D::NB;
  static constexpr int X = 0, XA = X, BL = X + 12 * NB, V = BL + 9 * NB, C = V + 6 * NB,
                       PA = C + 6 * NB, U = PA + 6 * NB, SP = U + 6 * NB, PAR = SP + 6 * NB,
                       VALUES = PAR + NB;
};

// Shared-memory values a team of NL lanes takes: the scratch, then q (nq
// values), qd and qdd; padded so the teams of a warp start on different
// banks (kernels/_lib.py team_values).
template <class D, int NL>
RBD_HD constexpr int rnea_team_stride() {
  return (RneaLayout<D>::VALUES + D::NQ + 2 * D::NV + 31) / 32 * 32 + NL % 32;
}

// One state by the team ``tm`` with shared scratch ``s``
// (rnea_team_stride values): q, qd, qdd (with QDD) and tau at its row.
template <int NL, bool QDD, typename T, class D>
RBD_HD void rnea_team(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* q, const T* qd,
                      const T* qdd, T* tau, T gravity) {
  using L = RneaLayout<D>;
  const int n = m.nv();
  T* xs = s + L::VALUES;
  T* qdds = xs + D::NQ + D::NV;
  // x = [q (nq values); qd]; the other classes keep their own loop, which
  // compiles as before
  if constexpr (D::QUAT) {
    const int nq = m.nq();
    for (int k = tm.lane; k < nq; k += NL) xs[k] = q[k];
    for (int k = tm.lane; k < n; k += NL) {
      xs[nq + k] = qd[k];
      if constexpr (QDD) qdds[k] = qdd[k];
    }
  } else {
    for (int k = tm.lane; k < n; k += NL) {
      xs[k] = q[k];
      xs[n + k] = qd[k];
      if constexpr (QDD) qdds[k] = qdd[k];
    }
  }
  tm.sync();
  team_rnea<NL, false, QDD, false, L>(tm, m, s, xs, qdds, static_cast<const T*>(nullptr), gravity,
                                      static_cast<const T*>(nullptr), tau);
}

}  // namespace rbd

#ifdef __CUDACC__
template <int NL, bool QDD, typename T, class D>
__global__ void __launch_bounds__(32)
    rnea_kernel(rbd::Model<T, D> m, const T* __restrict__ q, const T* __restrict__ qd,
                const T* __restrict__ qdd, T* __restrict__ tau, int B, int tpb, T gravity) {
  extern __shared__ __align__(16) unsigned char rnea_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix;
  if (b >= B) return;
  const size_t o = (size_t)b * m.nv(), oq = D::QUAT ? (size_t)b * m.nq() : o;
  T* s = reinterpret_cast<T*>(rnea_smem) + (size_t)tix * rbd::rnea_team_stride<D, NL>();
  rbd::rnea_team<NL, QDD>(tm, m, s, q + oq, qd + o, QDD ? qdd + o : nullptr, tau + o, gravity);
}

template <int NL, typename T, class D>
static int launch_rnea(const T* tab, const int* itab, int nb, const T* q, const T* qd,
                       const T* qdd, T* tau, int B, int tpb, int smem, T gravity, void* stream) {
  if (B <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32) return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  auto kernel = qdd != nullptr ? rnea_kernel<NL, true, T, D> : rnea_kernel<NL, false, T, D>;
  const int err = team_smem_check(kernel, smem, tpb, rbd::rnea_team_stride<D, NL>(), sizeof(T));
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(m, q, qd, qdd, tau, B, tpb,
                                                                       gravity);
  return (int)cudaGetLastError();
}

#define RBD_RNEA(CLS, D, T, SFX)                                                              \
  int rbd_rnea_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* q, const T* qd,  \
                             const T* qdd, T* tau, int B, int tpb, int smem, T gravity,       \
                             void* stream) {                                                  \
    return launch_rnea<RBD_TEAM_rnea_##CLS##_##SFX, T, rbd::D>(tab, itab, nb, q, qd, qdd, tau, \
                                                               B, tpb, smem, gravity, stream); \
  }

extern "C" {
RBD_RNEA(n8, N8, float, f32)
RBD_RNEA(n8, N8, double, f64)
RBD_RNEA(fb16, FB16, float, f32)
RBD_RNEA(fb16, FB16, double, f64)
RBD_RNEA(fb32, FB32, float, f32)
RBD_RNEA(fb32, FB32, double, f64)
RBD_RNEA(fq32, FQ32, float, f32)
RBD_RNEA(fq32, FQ32, double, f64)
}
#endif
