// ee_gn / ee_err: end-effector position error and its Gauss-Newton terms.
// Replaces rbdtpu kernels/fk_lane.py ee_gn_fused (Pallas, fk_lane.py:203),
// both its gn=True and gn=False variants.  Fixed-base trees of up to 8
// bodies (N8).
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
template <typename T>
RBD_HD T ee_row_value(const Model<T, N8>& m, int e) {
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

// The block's walk rows and mount into ``rows`` (EE_FIXED values) and its
// cnt states' q rows into sq.
template <typename T>
__device__ __forceinline__ void ee_stage_in(const rbd::Model<T, rbd::N8>& m,
                                            const T* __restrict__ ee, const T* q, int cnt,
                                            T* rows, T* sq) {
  const int nr = rbd::EE_ROW * m.nb;
  ee_pipe<T>(
      nr + 12, [&](int e) { return e < nr ? rbd::ee_row_value(m, e) : ee[e - nr]; },
      [&](int e, T v) { rows[e < nr ? e : rbd::EE_ROW * rbd::N8::NB + e - nr] = v; });
  ee_stage(sq, q, cnt * m.nb);
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
}
#endif
