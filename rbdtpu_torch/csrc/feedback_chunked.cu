// feedback_chunked: the DDP line-search rollout with the gain block split
// into column chunks, whole horizon per launch.
// Replaces rbdtpu kernels/fused.py feedback_rollout_fused_chunked (Pallas,
// fused.py:819), which made nchunks + 1 pallas_calls per knot inside
// lax.scan: one partial product K[:, cols] dx per chunk (fused.py:904) and
// one dynamics call (fused.py:945).  That split exists because a
// humanoid-size gain block did not fit the TPU's VMEM in one piece.
//
// Per knot t (rbdtpu's order of sums, so the float32 results agree to
// rounding):  dx = x (-) Xn_t, the tangent difference (flat, the rpy root's
// too; on the quaternion root its six root rows are quat_root_dx's, on lane
// 0, as K2's);  u = Un_t + kf_t (alpha folded into kf);  then for each chunk
// c in order, u += (K_t[:, j0..j0+w) dx[j0..j0+w), summed over ascending
// columns from the first product);  u clamped to [-uclip, uclip] when
// uclip is given (NaN stays NaN);  ABA and semi-implicit Euler.  The caller
// passes the chunk width cw and count nc as rbdtpu splits the columns
// (rbdtpu_torch kernels/fused.py chunk_geometry: every chunk nonempty, the
// last one possibly narrower); the launch refuses a split that does not
// cover the ndx columns exactly.
//
// On this card the whole gain block of a knot fits shared memory in every
// class and dtype, so the chunk is only the order of the sum: K9 runs K2's
// team body (feedback_team.cuh feedback_rollout_team, ChunkSum in place of
// K2's RowSum).  One team of NL lanes a trajectory: the knot's K, Xn, Un
// and kf arrive by cp.async one knot ahead, one lane a row of K sums its
// chunks in rbdtpu's order, and the team ABA step (rbd_team.cuh) runs from
// shared memory, walking its root->leaf recursions level by level on a
// branched tree (LV, kernels/_lib.py level_walk).  Bound on the H100: the
// latency of H dependent steps per trajectory, as K2; the gain bytes are
// read once, coalesced and ahead of use.  Each class and dtype has one team
// size fixed at build time (RBD_TEAM_feedback_chunked_<class>_<f32|f64>,
// from kernels/_lib.py TEAM); a block is one warp or less, halved until the
// batch gives every SM a block, and the grid covers any B down to 1.
// Layouts (row-major): x0 (B, nx), Xn/Xo (B, H, nx), Un/kf/Uo (B, H, n),
// Kf (B, H, n, ndx), n = nv, ndx = 2 nv (the chunks split these columns)
// and nx = nq + nv (ndx + 1 on the quaternion root).  Instantiated for N8,
// FB16, FB32 and FQ32 in both walks.  feedback_chunked_fext takes
// world-frame wrenches, fext (H, nb, 6), as feedback_rollout_fext does
// (feedback_team.cuh BlockWrench), under its own C symbols, at the same
// classes.  rbdtpu pads its lanes with w = 1 quaternions
// (kernels/fused.py:854-858); here a team past the batch returns before it
// reads a state (the wrench kernel's runs the block's last trajectory), so
// quat_root_dx never sees a zero quaternion.
#include "feedback_team.cuh"

#ifdef __CUDACC__
template <int NL, bool LV, typename T, class D>
__global__ void __launch_bounds__(32)
    feedback_chunked_kernel(rbd::Model<T, D> m, const T* __restrict__ x0,
                            const T* __restrict__ Xn, const T* __restrict__ Un,
                            const T* __restrict__ kf, const T* __restrict__ Kf,
                            const T* __restrict__ uclip, T* __restrict__ Xo,
                            T* __restrict__ Uo, int B, int H, int cw, int tpb, T dt,
                            T gravity) {
  extern __shared__ __align__(16) unsigned char fbc_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix;
  if (b >= B) return;
  const int n = m.nv(), nx = D::QUAT ? m.nq() + n : 2 * n, ndx = 2 * n;
  const size_t bx = (size_t)b * H * nx, bu = (size_t)b * H * n;
  T* s = reinterpret_cast<T*>(fbc_smem) + (size_t)tix * rbd::feedback_team_stride<D, NL>();
  rbd::feedback_rollout_team<NL, LV>(tm, m, s, x0 + (size_t)b * nx, Xn + bx, Un + bu, kf + bu,
                                     Kf + bu * ndx, uclip, Xo + bx, Uo + bu, H, dt, gravity,
                                     rbd::ChunkSum{cw});
}

// The wrench variant: fext (H, nb, 6), one set a knot shared by the batch,
// staged once a block ahead of the teams (feedback_team.cuh BlockWrench);
// a team past the batch runs the block's last trajectory and writes nothing.
template <int NL, bool LV, typename T, class D>
__global__ void __launch_bounds__(32)
    feedback_chunked_fext_kernel(rbd::Model<T, D> m, const T* __restrict__ x0,
                                 const T* __restrict__ Xn, const T* __restrict__ Un,
                                 const T* __restrict__ kf, const T* __restrict__ Kf,
                                 const T* __restrict__ fext, const T* __restrict__ uclip,
                                 T* __restrict__ Xo, T* __restrict__ Uo, int B, int H, int cw,
                                 int tpb, T dt, T gravity) {
  extern __shared__ __align__(16) unsigned char fbw_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix, bb = b < B ? b : B - 1;
  const int n = m.nv(), nx = D::QUAT ? m.nq() + n : 2 * n, ndx = 2 * n;
  const size_t bx = (size_t)bb * H * nx, bu = (size_t)bb * H * n;
  T* stage = reinterpret_cast<T*>(fbw_smem);
  T* s = stage + rbd::feedback_wrench_values<D>() +
         (size_t)tix * rbd::feedback_team_stride<D, NL, true>();
  const rbd::BlockWrench<T, D> w{fext, stage, (int)threadIdx.x, (int)blockDim.x, m.nb, b < B};
  rbd::feedback_rollout_team<NL, LV>(tm, m, s, x0 + (size_t)bb * nx, Xn + bx, Un + bu, kf + bu,
                                     Kf + bu * ndx, uclip, Xo + bx, Uo + bu, H, dt, gravity,
                                     rbd::ChunkSum{cw}, w);
}

template <int NL, typename T, class D>
static int launch_feedback_chunked(const T* tab, const int* itab, int nb, const T* x0,
                                   const T* Xn, const T* Un, const T* kf, const T* Kf,
                                   const T* uclip, T* Xo, T* Uo, int B, int H, int cw, int nc,
                                   int levels, int tpb, int smem, T dt, T gravity,
                                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32 || (levels != 0 && levels != 1))
    return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  const int ndx = 2 * m.nv();
  if (cw < 1 || nc < 1 || (nc - 1) * cw >= ndx || nc * cw < ndx)
    return (int)cudaErrorInvalidValue;
  auto kernel = levels ? feedback_chunked_kernel<NL, true, T, D>
                       : feedback_chunked_kernel<NL, false, T, D>;
  const int err =
      team_smem_check(kernel, smem, tpb, rbd::feedback_team_stride<D, NL>(), sizeof(T));
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(
      m, x0, Xn, Un, kf, Kf, uclip, Xo, Uo, B, H, cw, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

template <int NL, typename T, class D>
static int launch_feedback_chunked_fext(const T* tab, const int* itab, int nb, const T* x0,
                                        const T* Xn, const T* Un, const T* kf, const T* Kf,
                                        const T* fext, const T* uclip, T* Xo, T* Uo, int B,
                                        int H, int cw, int nc, int levels, int tpb, int smem,
                                        T dt, T gravity, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32 || (levels != 0 && levels != 1) || fext == nullptr)
    return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  const int ndx = 2 * m.nv();
  if (cw < 1 || nc < 1 || (nc - 1) * cw >= ndx || nc * cw < ndx)
    return (int)cudaErrorInvalidValue;
  auto kernel = levels ? feedback_chunked_fext_kernel<NL, true, T, D>
                       : feedback_chunked_fext_kernel<NL, false, T, D>;
  const int err = team_smem_check(kernel, smem, tpb, rbd::feedback_team_stride<D, NL, true>(),
                                  sizeof(T), rbd::feedback_wrench_values<D>());
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(
      m, x0, Xn, Un, kf, Kf, fext, uclip, Xo, Uo, B, H, cw, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

#define RBD_FEEDBACK_CHUNKED(CLS, D, T, SFX)                                                 \
  int rbd_feedback_chunked_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x0, \
                                         const T* Xn, const T* Un, const T* kf, const T* Kf, \
                                         const T* uclip, T* Xo, T* Uo, int B, int H, int cw, \
                                         int nc, int levels, int tpb, int smem, T dt,        \
                                         T gravity, void* stream) {                          \
    return launch_feedback_chunked<RBD_TEAM_feedback_chunked_##CLS##_##SFX, T, rbd::D>(      \
        tab, itab, nb, x0, Xn, Un, kf, Kf, uclip, Xo, Uo, B, H, cw, nc, levels, tpb, smem,   \
        dt, gravity, stream);                                                                \
  }

#define RBD_FEEDBACK_CHUNKED_FEXT(CLS, D, T, SFX)                                           \
  int rbd_feedback_chunked_fext_##CLS##_##SFX(                                              \
      const T* tab, const int* itab, int nb, const T* x0, const T* Xn, const T* Un,         \
      const T* kf, const T* Kf, const T* fext, const T* uclip, T* Xo, T* Uo, int B, int H,  \
      int cw, int nc, int levels, int tpb, int smem, T dt, T gravity, void* stream) {       \
    return launch_feedback_chunked_fext<RBD_TEAM_feedback_chunked_fext_##CLS##_##SFX, T,    \
                                        rbd::D>(tab, itab, nb, x0, Xn, Un, kf, Kf, fext,    \
                                                uclip, Xo, Uo, B, H, cw, nc, levels, tpb,   \
                                                smem, dt, gravity, stream);                 \
  }

extern "C" {
RBD_FEEDBACK_CHUNKED(n8, N8, float, f32)
RBD_FEEDBACK_CHUNKED(n8, N8, double, f64)
RBD_FEEDBACK_CHUNKED(fb16, FB16, float, f32)
RBD_FEEDBACK_CHUNKED(fb16, FB16, double, f64)
RBD_FEEDBACK_CHUNKED(fb32, FB32, float, f32)
RBD_FEEDBACK_CHUNKED(fb32, FB32, double, f64)
RBD_FEEDBACK_CHUNKED(fq32, FQ32, float, f32)
RBD_FEEDBACK_CHUNKED(fq32, FQ32, double, f64)
RBD_FEEDBACK_CHUNKED_FEXT(n8, N8, float, f32)
RBD_FEEDBACK_CHUNKED_FEXT(n8, N8, double, f64)
RBD_FEEDBACK_CHUNKED_FEXT(fb16, FB16, float, f32)
RBD_FEEDBACK_CHUNKED_FEXT(fb16, FB16, double, f64)
RBD_FEEDBACK_CHUNKED_FEXT(fb32, FB32, float, f32)
RBD_FEEDBACK_CHUNKED_FEXT(fb32, FB32, double, f64)
RBD_FEEDBACK_CHUNKED_FEXT(fq32, FQ32, float, f32)
RBD_FEEDBACK_CHUNKED_FEXT(fq32, FQ32, double, f64)

// The current device's per-thread stack limit (cudaLimitStackSize).  The
// driver raises it to the largest stack frame launched so far and keeps
// local memory of that size for every thread the card can hold; setting
// it lower frees it.  The largest frame of the library is fd_step_minv's
// in double with the dense M^-1 and wrenches (9,792 bytes a thread in the
// build's ptxas report, PERF.md §6), then rnea's (up to 2,160);
// every team kernel (this one and rollout_multi included), the
// end-effector kernels and both Riccati sweeps take under 1,024 bytes.
int rbd_stack_limit(size_t* bytes) { return (int)cudaDeviceGetLimit(bytes, cudaLimitStackSize); }
int rbd_set_stack_limit(size_t bytes) {
  return (int)cudaDeviceSetLimit(cudaLimitStackSize, bytes);
}
}
#endif
