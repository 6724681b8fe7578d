// The line-search rollout of one trajectory by a team of lanes, shared by
// feedback_rollout.cu (K2) and feedback_chunked.cu (K9), which differ only
// in the order of the feedback sum (the policy S: RowSum, one run over the
// row, or ChunkSum, rbdtpu's column chunks).
//
// Per knot t:  dx = x (-) Xn_t, the tangent difference (flat on the fixed
// base and the rpy root, as rbdtpu's; on the quaternion root its six root
// rows are quat_root_dx's, on lane 0, and the rest flat);  u = Un_t + kf_t
// + Kf_t dx in S's order (alpha is already folded into kf);  u clamped to
// [-uclip, uclip] when uclip is given (torch.clamp: NaN stays NaN);  then
// ABA and semi-implicit Euler.  Writes states 1..H and the applied u.
// Layouts (row-major): x0 (nx), Xn/Xo (H, nx), Un/kf/Uo (H, n), Kf (H, n,
// ndx) of the trajectory, n = nv, ndx = 2 nv the tangent's width and
// nx = nq + nv the state's (ndx, or ndx + 1 on the quaternion root).
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
//
// With wrenches (the policy W = BlockWrench: feedback_rollout.cu's and
// feedback_chunked.cu's _fext kernels), fext (H, nb, 6) holds one
// world-frame wrench set a knot, shared by the batch, as rbdtpu's
// feedback kernels take it.  A knot's set is the same for every team of a
// block, so the block keeps one copy: two stages of 6 NB values ahead of
// its teams' scratch, filled by all of the block's threads in the cp.async
// group of the knot's gains, one knot ahead.  The knot's first barrier is
// then the block's (every thread's copies have landed, and every team has
// left the step that read the stage now refilled), and the step's wrench
// chain reads the knot's stage.  A block's teams past the batch run the
// block's last trajectory without writing it, so that they take their
// share of the copies and reach every barrier.  Without wrenches (NoWrench)
// the body compiles to what it was before wrenches existed.
#pragma once

#include "rbd_team.cuh"

namespace rbd {

// The step's layout here: the level order (for either walk), and with W
// the wrenches' chain in IA's values, so a team takes what it takes
// without wrenches (the block's two wrench stages come on top: at fb32 a
// block of its own wrench chain would cost the humanoid's 1,024-trajectory
// line search its eighth block an SM, and a second wave).
template <class D, bool W = false>
using FbLayout = TeamLayout<D, W, true, false, W>;

// Shared-memory values a team of NL lanes takes: the step's scratch, x, dx
// and u, and the knot buffer (K with rows of ndx + 1, Xn, Un, kf); padded
// so the teams of a warp start on different banks.
template <class D, int NL, bool W = false>
RBD_HD constexpr int feedback_team_stride() {
  constexpr int NV = D::NV, NX = D::NQ + D::NV;
  return (FbLayout<D, W>::VALUES + NX + 3 * NV + NV * (2 * NV + 1) + NX + 2 * NV + 31) / 32 *
             32 +
         NL % 32;
}

// Shared-memory values a block of the wrench kernels keeps ahead of its
// teams: two stages of a knot's wrench set (6 NB values each), rounded up
// to 32 so the teams keep their banks.
template <class D>
RBD_HD constexpr int feedback_wrench_values() {
  return (12 * D::NB + 31) / 32 * 32;
}

// The whole block's barrier (its teams share the wrench stages); a host
// build runs one team a block.
RBD_HD void block_sync() {
#if defined(__CUDA_ARCH__)
  __syncthreads();
#elif defined(RBD_TEAM_HOST_SYNC)
  RBD_TEAM_HOST_SYNC();
#endif
}

// No wrenches: nothing to load, the team's own barrier, every write made.
struct NoWrench {
  static constexpr bool ON = false;
  template <int NL>
  RBD_HD void sync(const Team<NL>& tm) const {
    tm.sync();
  }
  RBD_HD void load(int) const {}
  template <typename T>
  RBD_HD const T* at(int, const T*) const {
    return nullptr;
  }
  RBD_HD constexpr bool live() const { return true; }
};

// One wrench set a knot, fext (H, nb, 6), staged once a block: ``tid`` and
// ``nt`` are this thread's index in the block and the block's threads,
// ``stage`` the block's two stages of 6 NB values; ``alive`` is false for
// a team past the batch, which then writes nothing.
template <typename T, class D>
struct BlockWrench {
  static constexpr bool ON = true;
  const T* fext;
  T* stage;
  int tid, nt, nb;
  bool alive;
  template <int NL>
  RBD_HD void sync(const Team<NL>&) const {
    block_sync();
  }
  // knot t's set into stage t mod 2 (this thread's share of the copies;
  // the caller commits them with the knot's gains)
  RBD_HD void load(int t) const {
    T* dst = stage + (t & 1) * 6 * D::NB;
    for (int k = tid; k < 6 * nb; k += nt) copy_async(dst + k, fext + (size_t)t * 6 * nb + k);
  }
  RBD_HD const T* at(int t, const T*) const { return stage + (t & 1) * 6 * D::NB; }
  RBD_HD bool live() const { return alive; }
};

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
// into the buffer: K rows of ld = ndx + 1 values, then Xn (nx values), Un,
// kf; the wrench policy's copies of the knot join the same group.
template <int NL, typename T, class W>
RBD_HD void feedback_load_knot(const Team<NL>& tm, int n, int nx, int t, const T* Xn,
                               const T* Un, const T* kf, const T* Kf, T* bK, T* bXn, T* bUn,
                               T* bkf, const W& w) {
  const int ndx = 2 * n, ld = ndx + 1;
  const T* K = Kf + (size_t)t * n * ndx;
  for (int i = 0; i < n; ++i)
    for (int j = tm.lane; j < ndx; j += NL) copy_async(bK + i * ld + j, K + i * ndx + j);
  for (int k = tm.lane; k < nx; k += NL) copy_async(bXn + k, Xn + (size_t)t * nx + k);
  for (int k = tm.lane; k < n; k += NL) {
    copy_async(bUn + k, Un + (size_t)t * n + k);
    copy_async(bkf + k, kf + (size_t)t * n + k);
  }
  w.load(t);
  copy_async_commit();
}

// One trajectory by the team ``tm`` with shared scratch ``s``
// (feedback_team_stride values), the feedback summed by ``sum`` and the
// wrenches taken by ``w``; pointers already offset to the trajectory
// (Xn/Un/kf/Kf/Xo/Uo at its knot 0).
template <int NL, bool LV, typename T, class D, class S = RowSum, class W = NoWrench>
RBD_HD void feedback_rollout_team(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x0,
                                  const T* Xn, const T* Un, const T* kf, const T* Kf,
                                  const T* uclip, T* Xo, T* Uo, int H, T dt, T gravity,
                                  const S& sum = S{}, const W& w = W{}) {
  constexpr int NV = D::NV, NX = D::NQ + D::NV;
  const int n = m.nv(), nx = m.nq() + n, ndx = 2 * n, ld = ndx + 1;
  T* xs = s + FbLayout<D, W::ON>::VALUES;
  T* dx = xs + NX;
  T* us = dx + 2 * NV;
  T* bK = us + NV;
  T* bXn = bK + NV * (2 * NV + 1);
  T* bUn = bXn + NX;
  T* bkf = bUn + NV;
  for (int k = tm.lane; k < nx; k += NL) xs[k] = x0[k];
  feedback_load_knot(tm, n, nx, 0, Xn, Un, kf, Kf, bK, bXn, bUn, bkf, w);
  // the flat rows of dx: all of them, or on the quaternion root the rows
  // past the root's six, at x's index + 1
  constexpr int J0 = D::QUAT ? 6 : 0, JX = D::QUAT ? 1 : 0;
  for (int t = 0; t < H; ++t) {
    copy_async_wait();
    w.sync(tm);
    if constexpr (D::QUAT) {
      if (tm.lane == 0) quat_root_dx(xs, bXn, dx);
    }
    for (int k = J0 + tm.lane; k < ndx; k += NL) dx[k] = xs[k + JX] - bXn[k + JX];
    tm.sync();
    for (int i = tm.lane; i < n; i += NL) {
      T acc = sum(bK + i * ld, dx, ndx, bUn[i] + bkf[i]);
      if (uclip != nullptr) acc = acc < -uclip[i] ? -uclip[i] : (acc > uclip[i] ? uclip[i] : acc);
      us[i] = acc;
      if (w.live()) Uo[(size_t)t * n + i] = acc;
    }
    tm.sync();
    if (t + 1 < H) feedback_load_knot(tm, n, nx, t + 1, Xn, Un, kf, Kf, bK, bXn, bUn, bkf, w);
    team_fd_step<NL, W::ON, LV, FbLayout<D, W::ON>>(
        tm, m, s, xs, us, dt, gravity, w.at(t, static_cast<const T*>(nullptr)), xs,
        w.live() ? Xo + (size_t)t * nx : static_cast<T*>(nullptr));
  }
}

}  // namespace rbd
