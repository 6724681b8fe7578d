// ee_gn / ee_err: end-effector position error and its Gauss-Newton terms.
// Replaces rbdtpu kernels/fk_lane.py ee_gn_fused (Pallas, fk_lane.py:203),
// both its gn=True and gn=False variants.  Fixed-base trees of up to 8
// bodies (N8), and rpy floating-base trees of up to 16 (FB16, the kernels
// at the end of this file).
//
// A state's chain (the EE joint and its ancestors, ``chain``, and which of
// them are prismatic, ``prism``: one bit a body each, from the host) is
// walked root -> EE joint with homogeneous transforms (T = Ttree TJ(q))
// kept in registers, the loop over bodies unrolled to N8::NB with a guard,
// so no array indexed by a body is left; then the EE mount (ee: R
// row-major, p).  Every joint's sine and cosine are taken before the walk,
// side by side (in ee_gn one lane a joint), and the walk reads what it
// needs of each body
// (ee_row_value: Ttree's rotation and translation, the joint axis) from a
// copy the block stages in shared memory, so only the chain of 3x3
// products stays serial.  The position Jacobian is
// geometric: column k = a_k x (p_ee - o_k) for a revolute joint, a_k for a
// prismatic one (a_k the world joint axis, o_k the joint origin); columns
// off the chain are zero.  Outputs (row-major): e (B, 3) = p_ee - target;
// ee_gn also g0 (B, n) = J^T e and H0 (B, n, n) = J^T J.
//
//   - ee_gn: a team of 8 lanes a state, four states a warp.  Lane c takes
//     joint c's sine and cosine; then every lane walks the chain, and lane
//     c keeps its own joint's world axis and origin
//     as the walk passes it, forms column c of J and g0[c] at the tip,
//     publishes the column to shared memory and, after the team's barrier,
//     forms row c of H0.
//   - ee_err: one thread a state; it writes e alone and never forms J.
//
// A block stages its states' q rows, and its e, g0 and H0 rows, through
// shared memory (ee_state_values a state, after EE_FIXED values of the
// walk's rows and the mount), so every global read and write
// is one contiguous run of the block's states, consecutive threads on
// consecutive addresses, in 16-byte accesses where the run is aligned
// (kernels/_lib.py ee_geometry keeps a block's states a multiple of four).
//
// Bound on the H100: bytes at the paths' large batches (q in, e, g0 and H0
// out: 264 bytes a state in float32, H0 74% of them) and the latency of
// one state's chain (7 joints, then the columns and one row of H0) at the
// small ones (the terminal cost's 128 states, 1,024 line-search states).
#include "rbd_team.cuh"

namespace rbd {

// Shared-memory values a state takes in a block (kernels/_lib.py
// ee_values): the q row and e; with GN also g0, H0 and J's columns.
template <bool GN>
RBD_HD constexpr int ee_state_values() {
  constexpr int NB = N8::NB;
  return GN ? 2 * NB + 3 + NB * NB + 3 * NB : NB + 3;
}

// A body's row of the walk (EE_ROW values: Ttree's rotation, its
// translation, the joint axis) and the block's values ahead of its states
// (kernels/_lib.py EE_FIXED): a row a body of the class and the mount.
constexpr int EE_ROW = 15, EE_FIXED = EE_ROW * N8::NB + 12;

// Entry e of the walk's rows (row e / EE_ROW) from the model's table.
template <typename T, class D>
RBD_HD T ee_row_value(const Model<T, D>& m, int e) {
  const int k = e / EE_ROW, j = e - EE_ROW * k;
  return m.body(k)[j < 9 ? OFF_TR + j : j < 12 ? OFF_TP + j - 9 : OFF_AXIS + j - 12];
}

// Joint k's sine and cosine into sc[k] and sc[NB + k] where it is a
// revolute joint of ``chain`` (0 and 1 elsewhere).
template <typename T>
RBD_HD void ee_sincos(unsigned chain, unsigned prism, const T* q, int k, T* sc) {
  const bool rev = ((chain & ~prism) >> k) & 1u;
  sc[k] = rev ? rsin(q[k]) : T(0);
  sc[N8::NB + k] = rev ? rcos(q[k]) : T(1);
}

// The world pose (R, p) of the EE joint's frame for joint positions q,
// walked root -> tip over the bodies of ``chain`` (``rows``: ee_row_value's
// of every body of the class; ``prism``: the chain's prismatic joints;
// ``sc``: ee_sincos's of every body).  With COL, the world axis and origin
// of body c's joint (and whether it is prismatic) as the walk passes it;
// ``on`` says whether c is on the chain.
template <bool COL, typename T>
RBD_HD void ee_walk(const T* rows, unsigned chain, unsigned prism, const T* q, const T* sc,
                    int c, T* R, T* p, T* ac, T* oc, bool& on, bool& pc) {
  for (int k = 0; k < 9; ++k) R[k] = k % 4 == 0 ? T(1) : T(0);
  for (int k = 0; k < 3; ++k) p[k] = T(0);
#pragma unroll
  for (int k = 0; k < N8::NB; ++k) {
    T b[EE_ROW];  // loaded ahead of the guard, so the loads can issue early
    for (int j = 0; j < EE_ROW; ++j) b[j] = rows[EE_ROW * k + j];
    if (!((chain >> k) & 1u)) continue;
    T Rp[3], R1[9];
    mv3(R, b + 9, Rp);
    for (int r = 0; r < 3; ++r) p[r] += Rp[r];
    mm3(R, b, R1);
    const bool pri = (prism >> k) & 1u;
    if (COL || pri) {
      T ax[3];
      mv3(R1, b + 12, ax);
      if constexpr (COL) {
        if (k == c) {
          for (int r = 0; r < 3; ++r) {
            ac[r] = ax[r];
            oc[r] = p[r];
          }
          on = true;
          pc = pri;
        }
      }
      if (pri)
        for (int r = 0; r < 3; ++r) p[r] += q[k] * ax[r];
    }
    if (pri) {
      for (int r = 0; r < 9; ++r) R[r] = R1[r];
    } else {
      T RJ[9];
      rot_axis_sc(b + 12, sc[k], sc[N8::NB + k], false, RJ);
      mm3(R1, RJ, R);
    }
  }
}

// The EE position pe = p + R ee_p and e = pe - target.
template <typename T>
RBD_HD void ee_tip(const T* R, const T* p, const T* ee, const T* target, T* pe, T* e) {
  T Rp[3];
  mv3(R, ee + 9, Rp);
  for (int r = 0; r < 3; ++r) {
    pe[r] = p[r] + Rp[r];
    e[r] = pe[r] - target[r];
  }
}

// ee_err of one state by one thread: q (n) -> e (3); rows, chain and
// prism as ee_walk takes them.
template <typename T>
RBD_HD void ee_err_one(const T* rows, unsigned chain, unsigned prism, const T* ee, const T* q,
                       const T* target, T* e) {
  T R[9], p[3], pe[3], sc[2 * N8::NB];
  bool on = false, pc = false;
#pragma unroll
  for (int k = 0; k < N8::NB; ++k) ee_sincos(chain, prism, q, k, sc);
  ee_walk<false>(rows, chain, prism, q, sc, 0, R, p, static_cast<T*>(nullptr),
                 static_cast<T*>(nullptr), on, pc);
  ee_tip(R, p, ee, target, pe, e);
}

// ee_gn of one state of an n-DoF tree by the team ``tm`` of 8 lanes, lane
// c column c of J: q (n) -> e (3), g0 (n), H0 (n x n), through J (3 values
// a column, the team's shared memory, which first holds the joints' sines
// and cosines).
template <typename T>
RBD_HD void ee_gn_team(const Team<8>& tm, int n, const T* rows, unsigned chain, unsigned prism,
                       const T* ee, const T* q, const T* target, T* e, T* g0, T* H0, T* J) {
  const int c = tm.lane;
  T R[9], p[3], ac[3], oc[3], pe[3], er[3], col[3] = {0, 0, 0};
  bool on = false, prism_c = false;
  ee_sincos(chain, prism, q, c, J);
  tm.sync();
  ee_walk<true>(rows, chain, prism, q, J, c, R, p, ac, oc, on, prism_c);
  tm.sync();  // every lane's walk has read J
  ee_tip(R, p, ee, target, pe, er);
  if (on && prism_c) {
    for (int r = 0; r < 3; ++r) col[r] = ac[r];
  } else if (on) {
    const T rel[3] = {pe[0] - oc[0], pe[1] - oc[1], pe[2] - oc[2]};
    cross3(ac, rel, col);
  }
  if (c < n) {
    for (int r = 0; r < 3; ++r) J[3 * c + r] = col[r];
    g0[c] = col[0] * er[0] + col[1] * er[1] + col[2] * er[2];
  }
  if (c == 0)
    for (int r = 0; r < 3; ++r) e[r] = er[r];
  tm.sync();
  if (c < n)
    for (int j = 0; j < n; ++j)
      H0[c * n + j] = col[0] * J[3 * j] + col[1] * J[3 * j + 1] + col[2] * J[3 * j + 2];
}

// ---- the rpy floating root (FB16) ----
//
// The same functions on an rpy-root tree (rbdtpu fk_lane.py ee_chain_lane's
// root branch): body 0's transform is Ttree0 [[Rz(y) Ry(p) Rx(r), xyz],
// [0, 1]] with q[0:6] = [x, y, z, roll, pitch, yaw], and body k > 0 reads
// q[k + 5] and owns column k + 5 of J.  The root's six columns are those of
// the configuration coordinates: the translations' are the columns of
// Ttree0's rotation Rt (the same for every state), the Euler angles' are
// a x (p_ee - o_root) with a_roll = Rt Rz Ry e_x, a_pitch = Rt Rz e_y,
// a_yaw = Rt e_z and o_root = Rt xyz + pt.
//
//   - ee_gn: a team of 8 lanes a state (four states a warp), lane c
//     columns c, c + 8 and c + 16 (every column of FB16's 21).  Eight lanes
//     and not one a column: every lane walks the whole chain, so a lane a
//     column would repeat the walk 21 times for the 9 columns a quadruped
//     foot's chain (root, hip, thigh, knee) has, and H0's rows (nv values
//     each) are as many lanes' work either way.  The lanes take their
//     joints' sines and cosines side by side (joints c and c + 8), every
//     lane walks the chain, catching the axes of its columns, forms them and
//     their entries of g0 at the tip, publishes them, and after the team's
//     barrier forms its rows of H0, the zero rows of the columns off the
//     chain included.
//   - ee_err: one thread a state.
// Rows are staged through shared memory as on the fixed base (at FB16's
// bounds: EE_FIXED_RPY ahead of the states, ee_rpy_state_values a state).
// The root's block is a real call: nvcc 12.9 miscompiled two inlined rpy
// root bodies (rbd_team.cuh).

// A block's shared values ahead of its states on the rpy root (kernels/
// _lib.py ee_fixed("fb16")): a walk row a body of FB16 and the mount.
constexpr int EE_FIXED_RPY = EE_ROW * FB16::NB + 12;
// ee_gn's columns a lane on the rpy root (lane c: c + 8 s)
constexpr int EE_RPY_SLOTS = (FB16::NV + 7) / 8;

// Shared-memory values a state takes in a block on the rpy root
// (kernels/_lib.py ee_values(kernel, "fb16")): the q row and e; with GN
// also g0, H0 and J's columns, at FB16's bound NV.
template <bool GN>
RBD_HD constexpr int ee_rpy_state_values() {
  constexpr int NV = FB16::NV;
  return GN ? 2 * NV + 3 + NV * NV + 3 * NV : NV + 3;
}

// Joint k > 0's sine and cosine (its coordinate q[k + 5]) into sc[k] and
// sc[NB + k] where it is a revolute joint of ``chain`` (0 and 1
// elsewhere).
template <typename T>
RBD_HD void ee_sincos_rpy(unsigned chain, unsigned prism, const T* q, int k, T* sc) {
  const bool rev = ((chain & ~prism) >> k) & 1u;
  sc[k] = rev ? rsin(q[k + 5]) : T(0);
  sc[FB16::NB + k] = rev ? rcos(q[k + 5]) : T(1);
}

// The rpy root's world pose (R, p = o_root) from its walk row b (Rt
// row-major, pt) and q[0:6], and its six columns' axes: ax[3 c + r] is
// column c's, the translations' Rt e_c, then a_roll, a_pitch, a_yaw.
template <typename T>
RBD_HD_CALL void ee_root_rpy(const T* b, const T* q, T* R, T* p, T* ax) {
  const T sr = rsin(q[3]), cr = rcos(q[3]), sp = rsin(q[4]), cp = rcos(q[4]);
  const T sy = rsin(q[5]), cy = rcos(q[5]);
  const T Rz[9] = {cy, -sy, 0, sy, cy, 0, 0, 0, 1};
  const T Ry[9] = {cp, 0, sp, 0, 1, 0, -sp, 0, cp};
  const T Rx[9] = {1, 0, 0, 0, cr, -sr, 0, sr, cr};
  T RtRz[9], RtRzRy[9];
  mm3(b, Rz, RtRz);
  mm3(RtRz, Ry, RtRzRy);
  mm3(RtRzRy, Rx, R);
  mv3(b, q, p);
  for (int r = 0; r < 3; ++r) {
    p[r] += b[9 + r];
    for (int c = 0; c < 3; ++c) ax[3 * c + r] = b[3 * r + c];
    ax[9 + r] = RtRzRy[3 * r];
    ax[12 + r] = RtRz[3 * r + 1];
    ax[15 + r] = b[3 * r + 2];
  }
}

// ee_walk on the rpy root: the EE joint frame's world pose (R, p) for the
// state q, walked root -> tip over ``chain`` (rows, prism and sc as ee_walk
// takes them, sc from ee_sincos_rpy).  With SLOTS > 0 it keeps the world
// axis and origin of columns c + 8 s, s < SLOTS, as the walk passes them
// (ac, oc: 3 values a slot); bit s of ``on`` says the column is on the
// chain, bit s of ``lin`` that it is a translation's (a root translation or
// a prismatic joint: the column is the axis itself).
template <int SLOTS, typename T>
RBD_HD void ee_walk_rpy(const T* rows, unsigned chain, unsigned prism, const T* q, const T* sc,
                        int c, T* R, T* p, T* ac, T* oc, unsigned& on, unsigned& lin) {
  constexpr int NB = FB16::NB;
  {
    T rax[18];
    ee_root_rpy(rows, q, R, p, rax);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int col = c + 8 * s;
      if (col < 6) {
        for (int r = 0; r < 3; ++r) {
          ac[3 * s + r] = rax[3 * col + r];
          oc[3 * s + r] = p[r];
        }
        on |= 1u << s;
        if (col < 3) lin |= 1u << s;
      }
    }
  }
#pragma unroll
  for (int k = 1; k < NB; ++k) {
    T b[EE_ROW];  // loaded ahead of the guard, so the loads can issue early
    for (int j = 0; j < EE_ROW; ++j) b[j] = rows[EE_ROW * k + j];
    if (!((chain >> k) & 1u)) continue;
    T Rp[3], R1[9], ax[3];
    mv3(R, b + 9, Rp);
    for (int r = 0; r < 3; ++r) p[r] += Rp[r];
    mm3(R, b, R1);
    const bool pri = (prism >> k) & 1u;
    mv3(R1, b + 12, ax);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (c + 8 * s == k + 5) {
        for (int r = 0; r < 3; ++r) {
          ac[3 * s + r] = ax[r];
          oc[3 * s + r] = p[r];
        }
        on |= 1u << s;
        if (pri) lin |= 1u << s;
      }
    }
    if (pri) {
      for (int r = 0; r < 3; ++r) p[r] += q[k + 5] * ax[r];
      for (int r = 0; r < 9; ++r) R[r] = R1[r];
    } else {
      T RJ[9];
      rot_axis_sc(b + 12, sc[k], sc[NB + k], false, RJ);
      mm3(R1, RJ, R);
    }
  }
}

// ee_err of one state on the rpy root by one thread: q (nq) -> e (3).
template <typename T>
RBD_HD void ee_err_one_rpy(const T* rows, unsigned chain, unsigned prism, const T* ee,
                           const T* q, const T* target, T* e) {
  T R[9], p[3], pe[3], sc[2 * FB16::NB];
  unsigned on = 0, lin = 0;
#pragma unroll
  for (int k = 1; k < FB16::NB; ++k) ee_sincos_rpy(chain, prism, q, k, sc);
  ee_walk_rpy<0>(rows, chain, prism, q, sc, 0, R, p, static_cast<T*>(nullptr),
                 static_cast<T*>(nullptr), on, lin);
  ee_tip(R, p, ee, target, pe, e);
}

// ee_gn of one state on the rpy root by the team ``tm`` of 8 lanes, lane c
// columns c + 8 s of J: q (nq) -> e (3), g0 (n), H0 (n x n), through J (3
// values a column, the team's shared memory, which first holds the joints'
// sines and cosines).
template <typename T>
RBD_HD void ee_gn_team_rpy(const Team<8>& tm, int n, const T* rows, unsigned chain,
                           unsigned prism, const T* ee, const T* q, const T* target, T* e,
                           T* g0, T* H0, T* J) {
  constexpr int S = EE_RPY_SLOTS;
  const int c = tm.lane;
  T R[9], p[3], ac[3 * S], oc[3 * S], pe[3], er[3], col[3 * S];
  unsigned on = 0, lin = 0;
  for (int k = c; k < FB16::NB; k += 8)
    if (k > 0) ee_sincos_rpy(chain, prism, q, k, J);
  tm.sync();
  ee_walk_rpy<S>(rows, chain, prism, q, J, c, R, p, ac, oc, on, lin);
  tm.sync();  // every lane's walk has read J
  ee_tip(R, p, ee, target, pe, er);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T* cs = col + 3 * s;
    if (!((on >> s) & 1u)) {
      for (int r = 0; r < 3; ++r) cs[r] = T(0);
    } else if ((lin >> s) & 1u) {
      for (int r = 0; r < 3; ++r) cs[r] = ac[3 * s + r];
    } else {
      const T rel[3] = {pe[0] - oc[3 * s], pe[1] - oc[3 * s + 1], pe[2] - oc[3 * s + 2]};
      cross3(ac + 3 * s, rel, cs);
    }
    const int j = c + 8 * s;
    if (j < n) {
      for (int r = 0; r < 3; ++r) J[3 * j + r] = cs[r];
      g0[j] = cs[0] * er[0] + cs[1] * er[1] + cs[2] * er[2];
    }
  }
  if (c == 0)
    for (int r = 0; r < 3; ++r) e[r] = er[r];
  tm.sync();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = c + 8 * s;
    const T* cs = col + 3 * s;
    if (j < n)
      for (int i = 0; i < n; ++i)
        H0[j * n + i] = cs[0] * J[3 * i] + cs[1] * J[3 * i + 1] + cs[2] * J[3 * i + 2];
  }
}

}  // namespace rbd

#ifdef __CUDACC__
// Elements 0 .. count - 1 moved by the block's threads (element tid,
// tid + nt, ...) as st(i, ld(i)), four loads in flight before their stores.
template <typename V, class Ld, class St>
__device__ __forceinline__ void ee_pipe(int count, Ld ld, St st) {
  constexpr int DEPTH = 4;
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  for (int base = tid; base < count; base += DEPTH * nt) {
    V r[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
      if (base + j * nt < count) r[j] = ld(base + j * nt);
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
      if (base + j * nt < count) st(base + j * nt, r[j]);
  }
}

// count values from src to dst, the block's threads on consecutive
// addresses, 16 bytes an access where both ranges are 16-byte aligned
template <typename T>
__device__ __forceinline__ void ee_stage(T* dst, const T* src, int count) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if ((((size_t)dst | (size_t)src) & 15) == 0) {
    done = count / V * V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    ee_pipe<uint4>(count / V, [&](int i) { return s4[i]; }, [&](int i, uint4 v) { d4[i] = v; });
  }
  ee_pipe<T>(count - done, [&](int i) { return src[done + i]; },
             [&](int i, T v) { dst[done + i] = v; });
}

// The block's walk rows and mount into ``rows`` (EE_FIXED values, or
// EE_FIXED_RPY on the rpy root: a row a body of the class D, then the
// mount) and its cnt states' q rows (nq = nv values) into sq.
template <typename T, class D>
__device__ __forceinline__ void ee_stage_in(const rbd::Model<T, D>& m,
                                            const T* __restrict__ ee, const T* q, int cnt,
                                            T* rows, T* sq) {
  const int nr = rbd::EE_ROW * m.nb;
  ee_pipe<T>(
      nr + 12, [&](int e) { return e < nr ? rbd::ee_row_value(m, e) : ee[e - nr]; },
      [&](int e, T v) { rows[e < nr ? e : rbd::EE_ROW * D::NB + e - nr] = v; });
  ee_stage(sq, q, cnt * m.nv());
}

// One block: states b0 .. b0 + spb - 1 (fewer in the last block).
template <typename T>
__global__ void __launch_bounds__(256)
    ee_gn_kernel(rbd::Model<T, rbd::N8> m, const T* __restrict__ ee, unsigned chain,
                 unsigned prism, const T* __restrict__ q, T tx, T ty, T tz, T* __restrict__ e,
                 T* __restrict__ g0, T* __restrict__ H0, int B, int spb) {
  constexpr int NB = rbd::N8::NB;
  extern __shared__ __align__(16) unsigned char ee_smem[];
  T* rows = reinterpret_cast<T*>(ee_smem);
  T* sq = rows + rbd::EE_FIXED;
  T* se = sq + spb * NB;
  T* sg = se + spb * 3;
  T* sH = sg + spb * NB;
  T* sJ = sH + spb * NB * NB;
  const int n = m.nb, b0 = blockIdx.x * spb, cnt = min(spb, B - b0);
  ee_stage_in(m, ee, q + (size_t)b0 * n, cnt, rows, sq);
  __syncthreads();
  const int st = (int)threadIdx.x / 8;
  if (st < cnt) {
    const T target[3] = {tx, ty, tz};
    rbd::ee_gn_team(this_team<8>(), n, rows, chain, prism, rows + rbd::EE_ROW * NB,
                    sq + st * n, target, se + 3 * st, sg + st * n, sH + st * n * n,
                    sJ + 3 * NB * st);
  }
  __syncthreads();
  ee_stage(e + (size_t)b0 * 3, se, cnt * 3);
  ee_stage(g0 + (size_t)b0 * n, sg, cnt * n);
  ee_stage(H0 + (size_t)b0 * n * n, sH, cnt * n * n);
}

template <typename T>
__global__ void __launch_bounds__(128)
    ee_err_kernel(rbd::Model<T, rbd::N8> m, const T* __restrict__ ee, unsigned chain,
                  unsigned prism, const T* __restrict__ q, T tx, T ty, T tz,
                  T* __restrict__ e, int B, int spb) {
  extern __shared__ __align__(16) unsigned char ee_smem[];
  T* rows = reinterpret_cast<T*>(ee_smem);
  T* sq = rows + rbd::EE_FIXED;
  T* se = sq + spb * rbd::N8::NB;
  const int n = m.nb, b0 = blockIdx.x * spb, cnt = min(spb, B - b0);
  ee_stage_in(m, ee, q + (size_t)b0 * n, cnt, rows, sq);
  __syncthreads();
  const int st = (int)threadIdx.x;
  if (st < cnt) {
    const T target[3] = {tx, ty, tz};
    rbd::ee_err_one(rows, chain, prism, rows + rbd::EE_ROW * rbd::N8::NB, sq + st * n, target,
                    se + 3 * st);
  }
  __syncthreads();
  ee_stage(e + (size_t)b0 * 3, se, cnt * 3);
}

// Refuses a block of states the layout does not take: spb a positive
// multiple of four whose threads fit the kernel's launch bound, and smem
// exactly EE_FIXED and spb states' ee_state_values.
template <typename T, bool GN>
static int launch_ee(const T* tab, const int* itab, int nb, const T* ee, int chain, int prism,
                     const T* q, T tx, T ty, T tz, T* e, T* g0, T* H0, int B, int spb,
                     int smem, void* stream) {
  if (B <= 0) return 0;
  const int lanes = GN ? 8 : 1, most = GN ? 256 : 128;
  const size_t values = (size_t)rbd::EE_FIXED + (size_t)spb * rbd::ee_state_values<GN>();
  if (nb > rbd::N8::NB || chain <= 0 || (chain >> nb) != 0 || (prism & ~chain) != 0 ||
      spb < 4 || spb % 4 != 0 || spb * lanes > most || (size_t)smem != values * sizeof(T))
    return (int)cudaErrorInvalidValue;
  const rbd::Model<T, rbd::N8> m{tab, itab, nb};
  const int blocks = (B + spb - 1) / spb;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (GN) {
    ee_gn_kernel<T><<<blocks, spb * lanes, smem, st>>>(m, ee, (unsigned)chain, (unsigned)prism,
                                                       q, tx, ty, tz, e, g0, H0, B, spb);
  } else {
    ee_err_kernel<T><<<blocks, spb, smem, st>>>(m, ee, (unsigned)chain, (unsigned)prism, q, tx,
                                                ty, tz, e, B, spb);
  }
  return (int)cudaGetLastError();
}

// The rpy-root kernels (FB16): as ee_gn_kernel and ee_err_kernel, with the
// walk rows of FB16's 16 bodies and its states' rows of nq = nv values.
template <typename T>
__global__ void __launch_bounds__(256)
    ee_gn_rpy_kernel(rbd::Model<T, rbd::FB16> m, const T* __restrict__ ee, unsigned chain,
                     unsigned prism, const T* __restrict__ q, T tx, T ty, T tz,
                     T* __restrict__ e, T* __restrict__ g0, T* __restrict__ H0, int B,
                     int spb) {
  constexpr int NV = rbd::FB16::NV;
  extern __shared__ __align__(16) unsigned char ee_smem[];
  T* rows = reinterpret_cast<T*>(ee_smem);
  T* sq = rows + rbd::EE_FIXED_RPY;
  T* se = sq + spb * NV;
  T* sg = se + spb * 3;
  T* sH = sg + spb * NV;
  T* sJ = sH + spb * NV * NV;
  const int n = m.nv(), b0 = blockIdx.x * spb, cnt = min(spb, B - b0);
  ee_stage_in(m, ee, q + (size_t)b0 * n, cnt, rows, sq);
  __syncthreads();
  const int st = (int)threadIdx.x / 8;
  if (st < cnt) {
    const T target[3] = {tx, ty, tz};
    rbd::ee_gn_team_rpy(this_team<8>(), n, rows, chain, prism,
                        rows + rbd::EE_ROW * rbd::FB16::NB, sq + st * n, target, se + 3 * st,
                        sg + st * n, sH + st * n * n, sJ + 3 * NV * st);
  }
  __syncthreads();
  ee_stage(e + (size_t)b0 * 3, se, cnt * 3);
  ee_stage(g0 + (size_t)b0 * n, sg, cnt * n);
  ee_stage(H0 + (size_t)b0 * n * n, sH, cnt * n * n);
}

template <typename T>
__global__ void __launch_bounds__(128)
    ee_err_rpy_kernel(rbd::Model<T, rbd::FB16> m, const T* __restrict__ ee, unsigned chain,
                      unsigned prism, const T* __restrict__ q, T tx, T ty, T tz,
                      T* __restrict__ e, int B, int spb) {
  extern __shared__ __align__(16) unsigned char ee_smem[];
  T* rows = reinterpret_cast<T*>(ee_smem);
  T* sq = rows + rbd::EE_FIXED_RPY;
  T* se = sq + spb * rbd::FB16::NV;
  const int n = m.nv(), b0 = blockIdx.x * spb, cnt = min(spb, B - b0);
  ee_stage_in(m, ee, q + (size_t)b0 * n, cnt, rows, sq);
  __syncthreads();
  const int st = (int)threadIdx.x;
  if (st < cnt) {
    const T target[3] = {tx, ty, tz};
    rbd::ee_err_one_rpy(rows, chain, prism, rows + rbd::EE_ROW * rbd::FB16::NB, sq + st * n,
                        target, se + 3 * st);
  }
  __syncthreads();
  ee_stage(e + (size_t)b0 * 3, se, cnt * 3);
}

// launch_ee on the rpy root: the same refusals at FB16's bounds, and the
// chain must start at the root (body 0).
template <typename T, bool GN>
static int launch_ee_rpy(const T* tab, const int* itab, int nb, const T* ee, int chain,
                         int prism, const T* q, T tx, T ty, T tz, T* e, T* g0, T* H0, int B,
                         int spb, int smem, void* stream) {
  if (B <= 0) return 0;
  const int lanes = GN ? 8 : 1, most = GN ? 256 : 128;
  const size_t values =
      (size_t)rbd::EE_FIXED_RPY + (size_t)spb * rbd::ee_rpy_state_values<GN>();
  if (nb > rbd::FB16::NB || (chain & 1) == 0 || (chain >> nb) != 0 || (prism & ~chain) != 0 ||
      (prism & 1) != 0 || spb < 4 || spb % 4 != 0 || spb * lanes > most ||
      (size_t)smem != values * sizeof(T) || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const rbd::Model<T, rbd::FB16> m{tab, itab, nb};
  const int blocks = (B + spb - 1) / spb;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (GN) {
    ee_gn_rpy_kernel<T><<<blocks, spb * lanes, smem, st>>>(
        m, ee, (unsigned)chain, (unsigned)prism, q, tx, ty, tz, e, g0, H0, B, spb);
  } else {
    ee_err_rpy_kernel<T><<<blocks, spb, smem, st>>>(m, ee, (unsigned)chain, (unsigned)prism, q,
                                                    tx, ty, tz, e, B, spb);
  }
  return (int)cudaGetLastError();
}

extern "C" {
int rbd_ee_gn_n8_f32(const float* tab, const int* itab, int nb, const float* ee, int chain,
                     int prism, const float* q, float tx, float ty, float tz, float* e,
                     float* g0, float* H0, int B, int spb, int smem, void* stream) {
  return launch_ee<float, true>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e, g0, H0, B,
                                spb, smem, stream);
}
int rbd_ee_gn_n8_f64(const double* tab, const int* itab, int nb, const double* ee, int chain,
                     int prism, const double* q, double tx, double ty, double tz, double* e,
                     double* g0, double* H0, int B, int spb, int smem, void* stream) {
  return launch_ee<double, true>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e, g0, H0, B,
                                 spb, smem, stream);
}
int rbd_ee_err_n8_f32(const float* tab, const int* itab, int nb, const float* ee, int chain,
                      int prism, const float* q, float tx, float ty, float tz, float* e, int B,
                      int spb, int smem, void* stream) {
  return launch_ee<float, false>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e, nullptr,
                                 nullptr, B, spb, smem, stream);
}
int rbd_ee_err_n8_f64(const double* tab, const int* itab, int nb, const double* ee, int chain,
                      int prism, const double* q, double tx, double ty, double tz, double* e,
                      int B, int spb, int smem, void* stream) {
  return launch_ee<double, false>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e, nullptr,
                                  nullptr, B, spb, smem, stream);
}
int rbd_ee_gn_fb16_f32(const float* tab, const int* itab, int nb, const float* ee, int chain,
                       int prism, const float* q, float tx, float ty, float tz, float* e,
                       float* g0, float* H0, int B, int spb, int smem, void* stream) {
  return launch_ee_rpy<float, true>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e, g0, H0,
                                    B, spb, smem, stream);
}
int rbd_ee_gn_fb16_f64(const double* tab, const int* itab, int nb, const double* ee,
                       int chain, int prism, const double* q, double tx, double ty, double tz,
                       double* e, double* g0, double* H0, int B, int spb, int smem,
                       void* stream) {
  return launch_ee_rpy<double, true>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e, g0, H0,
                                     B, spb, smem, stream);
}
int rbd_ee_err_fb16_f32(const float* tab, const int* itab, int nb, const float* ee, int chain,
                        int prism, const float* q, float tx, float ty, float tz, float* e,
                        int B, int spb, int smem, void* stream) {
  return launch_ee_rpy<float, false>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e,
                                     nullptr, nullptr, B, spb, smem, stream);
}
int rbd_ee_err_fb16_f64(const double* tab, const int* itab, int nb, const double* ee,
                        int chain, int prism, const double* q, double tx, double ty,
                        double tz, double* e, int B, int spb, int smem, void* stream) {
  return launch_ee_rpy<double, false>(tab, itab, nb, ee, chain, prism, q, tx, ty, tz, e,
                                      nullptr, nullptr, B, spb, smem, stream);
}
}
#endif
