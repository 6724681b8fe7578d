// feedback_rollout: the DDP line-search rollout, whole horizon per launch.
// Replaces rbdtpu kernels/fused.py feedback_rollout_fused (Pallas,
// fused.py:611), which launched once per knot inside lax.scan.
//
// Per knot t:  dx = x (-) Xn_t, the tangent difference (the rpy root's is
// the flat difference, as rbdtpu's; the quaternion root's takes its root
// rows from the quaternion log, rbdtpu fused.py _dx_rows);  u = Un_t + kf_t
// + Kf_t dx  (alpha is already folded into kf); u clamped to [-uclip,
// uclip] when uclip is given (torch.clamp: NaN stays NaN);  then ABA and
// semi-implicit Euler.  Writes states 1..H and the applied u.  Layouts
// (row-major): x0 (B, nx), Xn/Xo (B, H, nx), Un/kf/Uo (B, H, n), Kf (B, H,
// n, ndx), n = nv, ndx = 2 nv and nx = nq + nv (ndx + 1 on the quaternion
// root).  Instantiated for N8, FB16, FB32 and FQ32 in both walks, each
// class and dtype at one team size fixed at build time
// (RBD_TEAM_feedback_rollout_<class>_<f32|f64>, which kernels/_lib.py
// defines from its TEAM table).
//
// One team of NL lanes per trajectory runs feedback_team.cuh's
// feedback_rollout_team (shared with K9, csrc/feedback_chunked.cu): its
// state, the knot's gains (staged by cp.async one knot ahead) and the ABA
// state in the team's shared memory, one lane a row of K for the feedback
// sum, the team ABA step of rbd_team.cuh.
// The step walks its root->leaf recursions level by level where the tree
// branches (LV; the caller decides, kernels/_lib.py level_walk) and body by
// body on a chain.  Bound on the H100: the latency of H dependent steps per
// trajectory (the gain bytes, nv x nx values a knot, are read once,
// coalesced and ahead of use); at the line searches' 1024-6144 trajectories
// 32 lanes a team are fastest in every class (PERF.md §6).  A block is one
// warp or less, halved until the batch gives every SM a block, and the grid
// covers any B down to 1.
//
// feedback_rollout_fext is the same kernel under world-frame wrenches,
// fext (H, nb, 6), one set a knot shared by the batch (rbdtpu's contract,
// kernels/fused.py:686-692): the team step runs its wrench chain, and a
// block keeps one copy of the knot's set in two stages ahead of its teams,
// filled in the cp.async group of the knot's gains (feedback_team.cuh
// BlockWrench).  Own C symbols, instantiated beside the wrench-free ones
// for N8, FB16, FB32 and FQ32 in both walks.
#include "feedback_team.cuh"

#ifdef __CUDACC__
template <int NL, bool LV, typename T, class D>
__global__ void __launch_bounds__(32)
    feedback_rollout_kernel(rbd::Model<T, D> m, const T* __restrict__ x0,
                            const T* __restrict__ Xn, const T* __restrict__ Un,
                            const T* __restrict__ kf, const T* __restrict__ Kf,
                            const T* __restrict__ uclip, T* __restrict__ Xo,
                            T* __restrict__ Uo, int B, int H, int tpb, T dt, T gravity) {
  extern __shared__ __align__(16) unsigned char fb_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix;
  if (b >= B) return;
  const int n = m.nv(), nx = m.nq() + n, ndx = 2 * n;
  const size_t bx = (size_t)b * H * nx, bu = (size_t)b * H * n;
  T* s = reinterpret_cast<T*>(fb_smem) + (size_t)tix * rbd::feedback_team_stride<D, NL>();
  rbd::feedback_rollout_team<NL, LV>(tm, m, s, x0 + (size_t)b * nx, Xn + bx, Un + bu, kf + bu,
                             Kf + bu * ndx, uclip, Xo + bx, Uo + bu, H, dt, gravity);
}

// The wrench variant: fext (H, nb, 6), one set a knot shared by the batch,
// staged once a block ahead of the teams (feedback_team.cuh BlockWrench);
// a team past the batch runs the block's last trajectory and writes nothing.
template <int NL, bool LV, typename T, class D>
__global__ void __launch_bounds__(32)
    feedback_rollout_fext_kernel(rbd::Model<T, D> m, const T* __restrict__ x0,
                                 const T* __restrict__ Xn, const T* __restrict__ Un,
                                 const T* __restrict__ kf, const T* __restrict__ Kf,
                                 const T* __restrict__ fext, const T* __restrict__ uclip,
                                 T* __restrict__ Xo, T* __restrict__ Uo, int B, int H, int tpb,
                                 T dt, T gravity) {
  extern __shared__ __align__(16) unsigned char fbw_smem[];
  const rbd::Team<NL> tm = this_team<NL>();
  const int tix = (int)threadIdx.x / NL;
  const int b = blockIdx.x * tpb + tix, bb = b < B ? b : B - 1;
  const int n = m.nv(), nx = m.nq() + n, ndx = 2 * n;
  const size_t bx = (size_t)bb * H * nx, bu = (size_t)bb * H * n;
  T* stage = reinterpret_cast<T*>(fbw_smem);
  T* s = stage + rbd::feedback_wrench_values<D>() +
         (size_t)tix * rbd::feedback_team_stride<D, NL, true>();
  const rbd::BlockWrench<T, D> w{fext, stage, (int)threadIdx.x, (int)blockDim.x, m.nb, b < B};
  rbd::feedback_rollout_team<NL, LV>(tm, m, s, x0 + (size_t)bb * nx, Xn + bx, Un + bu, kf + bu,
                                     Kf + bu * ndx, uclip, Xo + bx, Uo + bu, H, dt, gravity,
                                     rbd::RowSum{}, w);
}

template <int NL, typename T, class D>
static int launch_feedback_rollout(const T* tab, const int* itab, int nb, const T* x0,
                                   const T* Xn, const T* Un, const T* kf, const T* Kf,
                                   const T* uclip, T* Xo, T* Uo, int B, int H, int levels,
                                   int tpb, int smem, T dt, T gravity, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32 || (levels != 0 && levels != 1))
    return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  auto kernel = levels ? feedback_rollout_kernel<NL, true, T, D>
                       : feedback_rollout_kernel<NL, false, T, D>;
  const int err =
      team_smem_check(kernel, smem, tpb, rbd::feedback_team_stride<D, NL>(), sizeof(T));
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(
      m, x0, Xn, Un, kf, Kf, uclip, Xo, Uo, B, H, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

template <int NL, typename T, class D>
static int launch_feedback_rollout_fext(const T* tab, const int* itab, int nb, const T* x0,
                                        const T* Xn, const T* Un, const T* kf, const T* Kf,
                                        const T* fext, const T* uclip, T* Xo, T* Uo, int B,
                                        int H, int levels, int tpb, int smem, T dt, T gravity,
                                        void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (nb > D::NB || tpb * NL > 32 || (levels != 0 && levels != 1) || fext == nullptr)
    return (int)cudaErrorInvalidValue;
  const rbd::Model<T, D> m{tab, itab, nb};
  auto kernel = levels ? feedback_rollout_fext_kernel<NL, true, T, D>
                       : feedback_rollout_fext_kernel<NL, false, T, D>;
  const int err = team_smem_check(kernel, smem, tpb, rbd::feedback_team_stride<D, NL, true>(),
                                  sizeof(T), rbd::feedback_wrench_values<D>());
  if (err != 0) return err;
  kernel<<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(
      m, x0, Xn, Un, kf, Kf, fext, uclip, Xo, Uo, B, H, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

#define RBD_FEEDBACK_ROLLOUT(CLS, D, T, SFX)                                                 \
  int rbd_feedback_rollout_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x0, \
                                         const T* Xn, const T* Un, const T* kf, const T* Kf, \
                                         const T* uclip, T* Xo, T* Uo, int B, int H,         \
                                         int levels, int tpb, int smem, T dt, T gravity,     \
                                         void* stream) {                                     \
    return launch_feedback_rollout<RBD_TEAM_feedback_rollout_##CLS##_##SFX, T, rbd::D>(      \
        tab, itab, nb, x0, Xn, Un, kf, Kf, uclip, Xo, Uo, B, H, levels, tpb, smem, dt,       \
        gravity, stream);                                                                    \
  }

#define RBD_FEEDBACK_ROLLOUT_FEXT(CLS, D, T, SFX)                                           \
  int rbd_feedback_rollout_fext_##CLS##_##SFX(                                              \
      const T* tab, const int* itab, int nb, const T* x0, const T* Xn, const T* Un,         \
      const T* kf, const T* Kf, const T* fext, const T* uclip, T* Xo, T* Uo, int B, int H,  \
      int levels, int tpb, int smem, T dt, T gravity, void* stream) {                       \
    return launch_feedback_rollout_fext<RBD_TEAM_feedback_rollout_fext_##CLS##_##SFX, T,    \
                                        rbd::D>(tab, itab, nb, x0, Xn, Un, kf, Kf, fext,    \
                                                uclip, Xo, Uo, B, H, levels, tpb, smem, dt, \
                                                gravity, stream);                           \
  }

extern "C" {
RBD_FEEDBACK_ROLLOUT(n8, N8, float, f32)
RBD_FEEDBACK_ROLLOUT(n8, N8, double, f64)
RBD_FEEDBACK_ROLLOUT(fb16, FB16, float, f32)
RBD_FEEDBACK_ROLLOUT(fb16, FB16, double, f64)
RBD_FEEDBACK_ROLLOUT(fb32, FB32, float, f32)
RBD_FEEDBACK_ROLLOUT(fb32, FB32, double, f64)
RBD_FEEDBACK_ROLLOUT(fq32, FQ32, float, f32)
RBD_FEEDBACK_ROLLOUT(fq32, FQ32, double, f64)
RBD_FEEDBACK_ROLLOUT_FEXT(n8, N8, float, f32)
RBD_FEEDBACK_ROLLOUT_FEXT(n8, N8, double, f64)
RBD_FEEDBACK_ROLLOUT_FEXT(fb16, FB16, float, f32)
RBD_FEEDBACK_ROLLOUT_FEXT(fb16, FB16, double, f64)
RBD_FEEDBACK_ROLLOUT_FEXT(fb32, FB32, float, f32)
RBD_FEEDBACK_ROLLOUT_FEXT(fb32, FB32, double, f64)
RBD_FEEDBACK_ROLLOUT_FEXT(fq32, FQ32, float, f32)
RBD_FEEDBACK_ROLLOUT_FEXT(fq32, FQ32, double, f64)
}
#endif
