// The line-search rollout of one trajectory by a team of lanes, shared by
// feedback_rollout.cu (K2) and feedback_chunked.cu (K9), which differ only
// in the order of the feedback sum (the policy S: RowSum, one run over the
// row, or ChunkSum, rbdtpu's column chunks).
//
// Per knot t:  dx = x - Xn_t (the rpy root's dx is the flat difference, as
// rbdtpu's);  u = Un_t + kf_t + Kf_t dx in S's order (alpha is already
// folded into kf);  u clamped to [-uclip, uclip] when uclip is given
// (torch.clamp: NaN stays NaN);  then ABA and semi-implicit Euler.  Writes
// states 1..H and the applied u.  Layouts (row-major): x0 (nx), Xn/Xo
// (H, nx), Un/kf/Uo (H, n), Kf (H, n, nx) of the trajectory, n = nv and
// nx = 2 nv.
//
// The team's state, the knot's gains and the ABA state live in the team's
// shared memory:
//   - the knot's K_t, Xn_t, Un_t and kf_t arrive in a shared buffer by
//     cp.async, consecutive lanes on consecutive addresses (K rows padded
//     to nx + 1 values, so the lanes' rows fall on different banks);
//   - the lanes form dx, then one lane a row of K sums its feedback,
//     clamps, and writes u to shared memory and Uo[t];
//   - the buffer is consumed before the step begins, so the copies of knot
//     t + 1 are issued right then into the same buffer and arrive while the
//     team runs knot t's step: one stage overlaps the loads with the step
//     in half the shared memory of a two-stage ring, which keeps every class
//     and dtype (fb32 in double too) at the same design;
//   - the team step (rbd_team.cuh) writes x' to shared memory and Xo[t].
#pragma once

#include "rbd_team.cuh"

namespace rbd {

// The step's layout here: no wrenches, the level order (for either walk).
template <class D>
using FbLayout = TeamLayout<D, false, true>;

// Shared-memory values a team of NL lanes takes: the step's scratch, x, dx
// and u, and the knot buffer (K with rows of nx + 1, Xn, Un, kf); padded so
// the teams of a warp start on different banks.
template <class D, int NL>
RBD_HD constexpr int feedback_team_stride() {
  constexpr int NV = D::NV;
  return (FbLayout<D>::VALUES + 5 * NV + NV * (2 * NV + 1) + 4 * NV + 31) / 32 * 32 + NL % 32;
}

// The feedback sum of one row of K: acc + K dx, one run over the nx
// columns in ascending order (K2).
struct RowSum {
  template <typename T>
  RBD_HD T operator()(const T* K, const T* dx, int nx, T acc) const {
    for (int j = 0; j < nx; ++j) acc += K[j] * dx[j];
    return acc;
  }
};

// rbdtpu's chunked order (kernels/fused.py:889-901, :955-962; K9): the
// columns in chunks of cw (the last one possibly narrower), each chunk's
// partial sum over ascending columns from its first product, the partials
// added to acc in chunk order.
struct ChunkSum {
  int cw;
  template <typename T>
  RBD_HD T operator()(const T* K, const T* dx, int nx, T acc) const {
    for (int j0 = 0; j0 < nx; j0 += cw) {
      const int j1 = nx - j0 < cw ? nx : j0 + cw;
      T p = K[j0] * dx[j0];
      for (int j = j0 + 1; j < j1; ++j) p += K[j] * dx[j];
      acc += p;
    }
    return acc;
  }
};

// Knot t's gains and nominals of one trajectory (pointers at its knot 0)
// into the buffer: K rows of ld values, then Xn, Un, kf.
template <int NL, typename T>
RBD_HD void feedback_load_knot(const Team<NL>& tm, int n, int t, const T* Xn, const T* Un,
                               const T* kf, const T* Kf, T* bK, T* bXn, T* bUn, T* bkf) {
  const int nx = 2 * n, ld = nx + 1;
  const T* K = Kf + (size_t)t * n * nx;
  for (int i = 0; i < n; ++i)
    for (int j = tm.lane; j < nx; j += NL) copy_async(bK + i * ld + j, K + i * nx + j);
  for (int k = tm.lane; k < nx; k += NL) copy_async(bXn + k, Xn + (size_t)t * nx + k);
  for (int k = tm.lane; k < n; k += NL) {
    copy_async(bUn + k, Un + (size_t)t * n + k);
    copy_async(bkf + k, kf + (size_t)t * n + k);
  }
  copy_async_commit();
}

// One trajectory by the team ``tm`` with shared scratch ``s``
// (feedback_team_stride values), the feedback summed by ``sum``; pointers
// already offset to the trajectory (Xn/Un/kf/Kf/Xo/Uo at its knot 0).
template <int NL, bool LV, typename T, class D, class S = RowSum>
RBD_HD void feedback_rollout_team(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x0,
                                  const T* Xn, const T* Un, const T* kf, const T* Kf,
                                  const T* uclip, T* Xo, T* Uo, int H, T dt, T gravity,
                                  const S& sum = S{}) {
  constexpr int NV = D::NV;
  const int n = m.nv(), nx = 2 * n, ld = nx + 1;
  T* xs = s + FbLayout<D>::VALUES;
  T* dx = xs + 2 * NV;
  T* us = dx + 2 * NV;
  T* bK = us + NV;
  T* bXn = bK + NV * (2 * NV + 1);
  T* bUn = bXn + 2 * NV;
  T* bkf = bUn + NV;
  for (int k = tm.lane; k < nx; k += NL) xs[k] = x0[k];
  feedback_load_knot(tm, n, 0, Xn, Un, kf, Kf, bK, bXn, bUn, bkf);
  for (int t = 0; t < H; ++t) {
    copy_async_wait();
    tm.sync();
    for (int k = tm.lane; k < nx; k += NL) dx[k] = xs[k] - bXn[k];
    tm.sync();
    for (int i = tm.lane; i < n; i += NL) {
      T acc = sum(bK + i * ld, dx, nx, bUn[i] + bkf[i]);
      if (uclip != nullptr) acc = acc < -uclip[i] ? -uclip[i] : (acc > uclip[i] ? uclip[i] : acc);
      us[i] = acc;
      Uo[(size_t)t * n + i] = acc;
    }
    tm.sync();
    if (t + 1 < H) feedback_load_knot(tm, n, t + 1, Xn, Un, kf, Kf, bK, bXn, bUn, bkf);
    team_fd_step<NL, false, LV, FbLayout<D>>(tm, m, s, xs, us, dt, gravity,
                                   static_cast<const T*>(nullptr), xs, Xo + (size_t)t * nx);
  }
}

}  // namespace rbd
