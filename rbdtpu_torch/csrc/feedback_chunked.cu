// feedback_chunked: the DDP line-search rollout with the gain block split
// into column chunks, whole horizon per launch.
// Replaces rbdtpu kernels/fused.py feedback_rollout_fused_chunked (Pallas,
// fused.py:819), which made nchunks + 1 pallas_calls per knot inside
// lax.scan: one partial product K[:, cols] dx per chunk (fused.py:904) and
// one dynamics call (fused.py:945).  That split exists because a
// humanoid-size gain block did not fit the TPU's VMEM in one piece.
//
// Per knot t (rbdtpu's order of sums, so the float32 results agree to
// rounding):  dx = x - Xn_t (flat; the rpy root's dx is the flat
// difference);  u = Un_t + kf_t (alpha folded into kf);  then for each chunk
// c in order, u += (K_t[:, j0..j0+w) dx[j0..j0+w), summed over ascending
// columns from the first product);  u clamped to [-uclip, uclip] when
// uclip is given (NaN stays NaN);  ABA and semi-implicit Euler through the
// one-thread step (rbd_common.cuh fd_step_state).  The caller passes the
// chunk width cw and count nc as rbdtpu splits the columns (rbdtpu_torch
// kernels/fused.py chunk_geometry: every chunk nonempty, the last one
// possibly narrower); the launch refuses a split that does not cover the
// ndx columns exactly.
//
// On this card the chunk is a shared-memory tile: one warp-sized block owns
// TPB trajectories; per knot and chunk its 32 threads copy the TPB x nv x w
// gain entries into shared memory with neighbouring threads on neighbouring
// columns of a row (K2 reads each trajectory's gains as one contiguous run
// per thread, uncoalesced across the warp), then split the TPB x nv partial
// sums over the 32 threads; each trajectory's owner thread then clamps and
// steps its state.  TPB is the largest power of two <= 32 whose tile, dx and
// u fit 48 KB (so no opt-in is needed: at nv <= 37 and one chunk a
// trajectory takes at most 22.8 KB in double), halved while the batch would
// not give every SM a block.  Bound on the H100: the gain bytes (nv x ndx
// values per trajectory and knot, read once) and the latency of the serial
// ABA walk of each owner thread.
// Layouts (row-major): x0 (B, nx), Xn/Xo (B, H, nx), Un/kf/Uo (B, H, n),
// Kf (B, H, n, nx), n = nv, nx = 2 nv.  Instantiated for N8, FB16 and FB32.
#include "rbd_common.cuh"

#ifdef __CUDA_ARCH__
#define RBD_SYNC() __syncthreads()
#else
#define RBD_SYNC()
#endif

namespace rbd {

// Shared-memory values per trajectory: the chunk tile (n x cw), dx (nx), u.
RBD_HD int chunked_smem_values(int n, int cw) { return n * cw + 3 * n; }

// The block's work on trajectories b0 .. b0 + nt - 1, thread ``lane`` of
// ``nlanes``: tile (nt x n x cw), sdx (nt x nx) and su (nt x n) are the
// block's shared memory.  The state at knot t is read back from Xo (knot
// t - 1, written by the same thread) or x0.  A host loop with lane = 0,
// nlanes = 1 runs the whole block.
template <typename T, class D>
RBD_HD void feedback_chunked_block(const Model<T, D>& m, int lane, int nlanes, int b0, int nt,
                                   const T* x0, const T* Xn, const T* Un, const T* kf,
                                   const T* Kf, const T* uclip, T* Xo, T* Uo, int H, int cw,
                                   int nchunks, T dt, T gravity, T* tile, T* sdx, T* su) {
  const int n = m.nv(), nx = 2 * n;
  for (int t = 0; t < H; ++t) {
    for (int tr = lane; tr < nt; tr += nlanes) {
      const size_t bt = (size_t)(b0 + tr) * H + t;
      const T* x = t == 0 ? x0 + (size_t)(b0 + tr) * nx : Xo + (bt - 1) * nx;
      for (int k = 0; k < nx; ++k) sdx[tr * nx + k] = x[k] - Xn[bt * nx + k];
      for (int i = 0; i < n; ++i) su[tr * n + i] = Un[bt * n + i] + kf[bt * n + i];
    }
    RBD_SYNC();
    for (int c = 0; c < nchunks; ++c) {
      const int j0 = c * cw, w = nx - j0 < cw ? nx - j0 : cw, per = n * w;
      for (int e = lane; e < nt * per; e += nlanes) {
        const int tr = e / per, r = e - tr * per, i = r / w, jj = r - i * w;
        const size_t bt = (size_t)(b0 + tr) * H + t;
        tile[(tr * n + i) * cw + jj] = Kf[(bt * n + i) * nx + j0 + jj];
      }
      RBD_SYNC();
      for (int p = lane; p < nt * n; p += nlanes) {
        const int tr = p / n;
        const T* K = tile + p * cw;
        const T* d = sdx + tr * nx + j0;
        T acc = K[0] * d[0];
        for (int jj = 1; jj < w; ++jj) acc += K[jj] * d[jj];
        su[p] += acc;
      }
      RBD_SYNC();
    }
    for (int tr = lane; tr < nt; tr += nlanes) {
      const size_t bt = (size_t)(b0 + tr) * H + t;
      const T* xp = t == 0 ? x0 + (size_t)(b0 + tr) * nx : Xo + (bt - 1) * nx;
      T x[2 * D::NV], xn[2 * D::NV], u[D::NV];
      for (int k = 0; k < nx; ++k) x[k] = xp[k];
      for (int i = 0; i < n; ++i) {
        T a = su[tr * n + i];
        if (uclip != nullptr) {  // torch.clamp semantics: NaN stays NaN
          a = a < -uclip[i] ? -uclip[i] : (a > uclip[i] ? uclip[i] : a);
        }
        u[i] = a;
      }
      fd_step_state(m, x, u, dt, gravity, xn);
      for (int k = 0; k < nx; ++k) Xo[bt * nx + k] = xn[k];
      for (int i = 0; i < n; ++i) Uo[bt * n + i] = u[i];
    }
  }
}

}  // namespace rbd

#ifdef __CUDACC__
#define RBD_FBC_LANES 32
#define RBD_FBC_SMEM (48 * 1024)

template <typename T, class D>
__global__ void __launch_bounds__(RBD_FBC_LANES)
    feedback_chunked_kernel(rbd::Model<T, D> m, const T* __restrict__ x0,
                            const T* __restrict__ Xn, const T* __restrict__ Un,
                            const T* __restrict__ kf, const T* __restrict__ Kf,
                            const T* __restrict__ uclip, T* __restrict__ Xo,
                            T* __restrict__ Uo, int B, int H, int cw, int nchunks, int tpb,
                            T dt, T gravity) {
  extern __shared__ __align__(16) unsigned char fbc_smem[];
  const int n = m.nv();
  const int b0 = blockIdx.x * tpb;
  const int nt = B - b0 < tpb ? B - b0 : tpb;
  T* tile = reinterpret_cast<T*>(fbc_smem);
  T* sdx = tile + (size_t)tpb * n * cw;
  T* su = sdx + (size_t)tpb * 2 * n;
  rbd::feedback_chunked_block(m, (int)threadIdx.x, RBD_FBC_LANES, b0, nt, x0, Xn, Un, kf, Kf,
                              uclip, Xo, Uo, H, cw, nchunks, dt, gravity, tile, sdx, su);
}

template <typename T, class D>
static int launch_feedback_chunked(const T* tab, const int* itab, int nb, const T* x0,
                                   const T* Xn, const T* Un, const T* kf, const T* Kf,
                                   const T* uclip, T* Xo, T* Uo, int B, int H, int cw, int nc,
                                   T dt, T gravity, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  rbd::Model<T, D> m{tab, itab, nb};
  const int n = m.nv();
  if (cw < 1 || nc < 1 || (nc - 1) * cw >= 2 * n || nc * cw < 2 * n)
    return (int)cudaErrorInvalidValue;
  int dev, nsm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t per = (size_t)rbd::chunked_smem_values(n, cw) * sizeof(T);
  int tpb = RBD_FBC_LANES;
  while (tpb > 1 && tpb * per > RBD_FBC_SMEM) tpb /= 2;
  while (tpb > 1 && (B + tpb - 1) / tpb < nsm) tpb /= 2;
  feedback_chunked_kernel<T, D>
      <<<(B + tpb - 1) / tpb, RBD_FBC_LANES, tpb * per, (cudaStream_t)stream>>>(
          m, x0, Xn, Un, kf, Kf, uclip, Xo, Uo, B, H, cw, nc, tpb, dt, gravity);
  return (int)cudaGetLastError();
}

#define RBD_FEEDBACK_CHUNKED(CLS, D, T, SFX)                                                 \
  int rbd_feedback_chunked_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* x0, \
                                         const T* Xn, const T* Un, const T* kf, const T* Kf, \
                                         const T* uclip, T* Xo, T* Uo, int B, int H, int cw, \
                                         int nc, T dt, T gravity, void* stream) {            \
    return launch_feedback_chunked<T, rbd::D>(tab, itab, nb, x0, Xn, Un, kf, Kf, uclip, Xo,  \
                                              Uo, B, H, cw, nc, dt, gravity, stream);        \
  }

extern "C" {
RBD_FEEDBACK_CHUNKED(n8, N8, float, f32)
RBD_FEEDBACK_CHUNKED(n8, N8, double, f64)
RBD_FEEDBACK_CHUNKED(fb16, FB16, float, f32)
RBD_FEEDBACK_CHUNKED(fb16, FB16, double, f64)
RBD_FEEDBACK_CHUNKED(fb32, FB32, float, f32)
RBD_FEEDBACK_CHUNKED(fb32, FB32, double, f64)

// The current device's per-thread stack limit (cudaLimitStackSize).  The
// driver raises it to the largest stack frame launched so far (this
// kernel's one-thread frame at FB32 in double, ~20 KB, is the largest of
// the library) and keeps local memory of that size for every thread the
// card can hold; setting it lower frees it.
int rbd_stack_limit(size_t* bytes) { return (int)cudaDeviceGetLimit(bytes, cudaLimitStackSize); }
int rbd_set_stack_limit(size_t bytes) {
  return (int)cudaDeviceSetLimit(cudaLimitStackSize, bytes);
}
}
#endif
