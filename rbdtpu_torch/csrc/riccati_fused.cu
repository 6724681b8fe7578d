// riccati_fused: the iLQR Riccati backward sweep at arm-class sizes (nx <=
// 16), whole horizon per launch, one warp per problem.
// Replaces rbdtpu kernels/riccati.py backward_pass_fused (Pallas,
// riccati.py:102, K11).  The TPU kernel was one pallas_call per knot inside
// lax.scan, with the batch in lanes and every matrix unrolled into scalars;
// the carry (Vx, Vxx) went through device memory between knots.  Here one
// warp owns one problem and loops over the H knots itself, with Vx, Vxx,
// the knot's inputs and every intermediate in its own slice of shared
// memory, so a sweep is one launch and the carry never leaves the SM.
// RICCATI_FUSED_WARPS problems share a block; warps never wait for each
// other (only __syncwarp), so a warp past the batch simply returns.
//
// Per knot t = H-1 .. 0 (rbdtpu solver/ddp.py backward_pass, iLQR branch;
// the port's plain version is rbdtpu_torch/solver/ddp.py backward_pass):
//   P  = Vxx A,  Pb = Vxx B,  Qx = lx + A^T Vx,  Qu = lu + B^T Vx
//   Quu = luu + B^T Pb,  Qux = lux + B^T P,  Qxx = lxx + A^T P
//   L L^T = Quu + reg I (left-looking by columns: lane 0 the pivot, the
//           other lanes the column below it; a pivot <= 0 or NaN gives NaN
//           and clears ok: the solver's PD guard)
//   k = -(L L^T)^-1 Qu,  K = -(L L^T)^-1 Qux (one lane per right-hand
//           column, nx + 1 <= 17 columns, in place)
//   Vx  = Qx + K^T (Quu k) + K^T Qu + Qux^T k
//   Vxx = sym(Qxx + K^T (Quu K) + K^T Qux + Qux^T K),  dV1 += k . Qu
// Every product is split over the warp's 32 lanes by output entry.
//
// Layouts (row-major), as csrc/riccati_chunk.cu: A (B, H, nx, nx),
// Bm (B, H, nx, nu), lx (B, H, nx), lu (B, H, nu); lxx/luu/lux at
// base + b * sb + t * st (sb = st = 0 for a constant block, read in place
// at every knot); lfx (B, nx), lfxx (B, nx, nx), reg (B); out k (B, H, nu),
// K (B, H, nu, nx), dV1 (B), ok (B) bytes.
// Shared memory per warp: 4 nx^2 + 5 nx nu + 3 nu^2 + 3 nx + 4 nu values
// (kernels/riccati.py smem_bytes): 11.6 KB at nx = 14, nu = 7 in float64.
// Bound on the H100: at B = 128 there is less than one warp per SM, so
// nothing hides a warp's latency and the sweep is latency-bound: per knot
// about 22.8k operations spread over 32 lanes (some 700 multiply-adds a
// lane, in chains of nx from shared memory), the serial Cholesky (2 nu warp
// barriers) and the triangular solves (nu^2 dependent steps a lane).  So
// every knot's device-memory inputs are staged in one burst of loads before
// its first barrier (one memory latency a knot, not one per product), and
// the product loops are unrolled by 4 so that their shared-memory loads
// issue together; the sums keep their order.  The card's bytes and
// operations bounds are two orders of magnitude below that.
#include "rbd_common.cuh"

#ifdef __CUDA_ARCH__
#define K11_SYNCWARP() __syncwarp()
#else
#define K11_SYNCWARP()
#endif

namespace rbd {
namespace k11 {

template <typename T>
RBD_HD T nan_value() {
  return T(0) / T(0);
}

// Shared-memory values the sweep of one (nx, nu) problem needs.
RBD_HD int smem_values(int n, int m) {
  return 4 * n * n + 5 * n * m + 3 * m * m + 3 * n + 4 * m;
}

// The sweep of problem b by lane `lane` of `nl` (a whole warp; lane 0 of 1
// runs it alone on the host); sm points at smem_values(nx, nu) values of
// this problem's own.  Lane 0 writes dV1 and ok after the last knot.
template <typename T>
RBD_HD void sweep(int lane, int nl, T* sm, int b, const T* A, const T* Bg, const T* lx,
                  const T* lu, const T* lxx, int lxx_sb, int lxx_st, const T* luu, int luu_sb,
                  int luu_st, const T* lux, int lux_sb, int lux_st, const T* lfx,
                  const T* lfxx, const T* reg, T* kout, T* Kout, T* dV1, unsigned char* ok,
                  int H, int n, int m) {
  T* Vxx = sm;          // n n: Vxx, then Qxx
  T* P = Vxx + n * n;   // n n: Vxx A, then the unsymmetrised Vxx
  T* As = P + n * n;    // n n: A
  T* Bs = As + n * n;   // n m: B
  T* Pb = Bs + n * m;   // n m: Vxx B, then Quu K (m n)
  T* Qux = Pb + n * m;  // m n
  T* Ks = Qux + m * n;  // m n: K
  T* Quu = Ks + m * n;  // m m
  T* L = Quu + m * m;   // m m: Cholesky factor (lower)
  T* Vx = L + m * m;    // n
  T* Qx = Vx + n;       // n
  T* Qu = Qx + n;       // m
  T* ks = Qu + m;       // m: k
  T* Quuk = ks + m;     // m: Quu k
  T* lxxs = Quuk + m;   // n n: the knot's lxx, luu, lux, lx, lu
  T* luus = lxxs + n * n;
  T* luxs = luus + m * m;
  T* lxs = luxs + m * n;
  T* lus = lxs + n;
  const size_t bn = (size_t)b;
  for (int e = lane; e < n * n; e += nl) Vxx[e] = lfxx[bn * n * n + e];
  for (int e = lane; e < n; e += nl) Vx[e] = lfx[bn * n + e];
  const T rg = reg[b];
  T dv = T(0);
  int okv = 1;
  for (int t = H - 1; t >= 0; --t) {
    const size_t kt = bn * H + t;
    const T* lxxt = lxx + (size_t)lxx_sb * bn + (size_t)lxx_st * t;
    const T* luut = luu + (size_t)luu_sb * bn + (size_t)luu_st * t;
    const T* luxt = lux + (size_t)lux_sb * bn + (size_t)lux_st * t;
#pragma unroll 4
    for (int e = lane; e < n * n; e += nl) {
      As[e] = A[kt * n * n + e];
      lxxs[e] = lxxt[e];
    }
#pragma unroll 4
    for (int e = lane; e < n * m; e += nl) {
      Bs[e] = Bg[kt * n * m + e];
      luxs[e] = luxt[e];
    }
    for (int e = lane; e < m * m; e += nl) luus[e] = luut[e];
    for (int e = lane; e < n; e += nl) lxs[e] = lx[kt * n + e];
    for (int e = lane; e < m; e += nl) lus[e] = lu[kt * m + e];
    K11_SYNCWARP();
    // P = Vxx A, Pb = Vxx B, Qx = lx + A^T Vx, Qu = lu + B^T Vx
    for (int e = lane; e < n * n; e += nl) {
      const int i = e / n, j = e % n;
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += Vxx[i * n + k] * As[k * n + j];
      P[e] = s;
    }
    for (int e = lane; e < n * m; e += nl) {
      const int i = e / m, j = e % m;
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += Vxx[i * n + k] * Bs[k * m + j];
      Pb[e] = s;
    }
    for (int e = lane; e < n; e += nl) {
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += As[k * n + e] * Vx[k];
      Qx[e] = lxs[e] + s;
    }
    for (int e = lane; e < m; e += nl) {
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += Bs[k * m + e] * Vx[k];
      Qu[e] = lus[e] + s;
    }
    K11_SYNCWARP();
    // Quu = luu + B^T Pb, Qux = lux + B^T P, Qxx = lxx + A^T P (over Vxx)
    for (int e = lane; e < m * m; e += nl) {
      const int i = e / m, j = e % m;
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += Bs[k * m + i] * Pb[k * m + j];
      Quu[e] = luus[e] + s;
    }
    for (int e = lane; e < m * n; e += nl) {
      const int i = e / n, j = e % n;
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += Bs[k * m + i] * P[k * n + j];
      Qux[e] = luxs[e] + s;
    }
    for (int e = lane; e < n * n; e += nl) {
      const int i = e / n, j = e % n;
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += As[k * n + i] * P[k * n + j];
      Vxx[e] = lxxs[e] + s;
    }
    K11_SYNCWARP();
    // Cholesky of Quu + reg I, left-looking by columns
    for (int j = 0; j < m; ++j) {
      if (lane == 0) {
        T s = Quu[j * m + j] + rg;
        for (int k = 0; k < j; ++k) s -= L[j * m + k] * L[j * m + k];
        const bool pd = s > T(0);  // false for NaN too
        L[j * m + j] = pd ? sqrt_r(s) : nan_value<T>();
        if (!pd) okv = 0;
      }
      K11_SYNCWARP();
      for (int i = j + 1 + lane; i < m; i += nl) {
        T s = Quu[i * m + j];
        for (int k = 0; k < j; ++k) s -= L[i * m + k] * L[j * m + k];
        L[i * m + j] = s / L[j * m + j];
      }
      K11_SYNCWARP();
    }
    // k (column c = n) and the columns of K, each solved in place by one
    // lane: forward substitution with L, then backward with L^T
    for (int c = lane; c <= n; c += nl) {
      T* x = c < n ? Ks + c : ks;
      const int st = c < n ? n : 1;
      const T* rhs = c < n ? Qux + c : Qu;
      for (int i = 0; i < m; ++i) {
        T s = rhs[i * st];
        for (int k = 0; k < i; ++k) s -= L[i * m + k] * x[k * st];
        x[i * st] = s / L[i * m + i];
      }
      for (int i = m - 1; i >= 0; --i) {
        T s = x[i * st];
        for (int k = i + 1; k < m; ++k) s -= L[k * m + i] * x[k * st];
        x[i * st] = s / L[i * m + i];
      }
      for (int i = 0; i < m; ++i) x[i * st] = -x[i * st];
    }
    K11_SYNCWARP();
    // Quu K (over Pb), Quu k; k and K to device memory
    for (int e = lane; e < m * n; e += nl) {
      const int i = e / n, j = e % n;
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < m; ++k) s += Quu[i * m + k] * Ks[k * n + j];
      Pb[e] = s;
      Kout[kt * m * n + e] = Ks[e];
    }
    for (int e = lane; e < m; e += nl) {
      T s = 0;
#pragma unroll 4
      for (int k = 0; k < m; ++k) s += Quu[e * m + k] * ks[k];
      Quuk[e] = s;
      kout[kt * m + e] = ks[e];
    }
    K11_SYNCWARP();
    // Vx, the unsymmetrised Vxx (over P), dV1
    for (int e = lane; e < n; e += nl) {
      T s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 4
      for (int r = 0; r < m; ++r) {
        s1 += Ks[r * n + e] * Quuk[r];
        s2 += Ks[r * n + e] * Qu[r];
        s3 += Qux[r * n + e] * ks[r];
      }
      Vx[e] = Qx[e] + s1 + s2 + s3;
    }
    for (int e = lane; e < n * n; e += nl) {
      const int i = e / n, j = e % n;
      T s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 4
      for (int r = 0; r < m; ++r) {
        s1 += Ks[r * n + i] * Pb[r * n + j];
        s2 += Ks[r * n + i] * Qux[r * n + j];
        s3 += Qux[r * n + i] * Ks[r * n + j];
      }
      P[e] = Vxx[e] + s1 + s2 + s3;
    }
    if (lane == 0) {
      T s = 0;
      for (int r = 0; r < m; ++r) s += ks[r] * Qu[r];
      dv += s;
    }
    K11_SYNCWARP();
    for (int e = lane; e < n * n; e += nl) {
      const int i = e / n, j = e % n;
      Vxx[e] = T(0.5) * (P[e] + P[j * n + i]);
    }
    K11_SYNCWARP();
  }
  if (lane == 0) {
    dV1[b] = dv;
    ok[b] = (unsigned char)okv;
  }
}

}  // namespace k11
}  // namespace rbd

#ifdef __CUDACC__
#define RICCATI_FUSED_WARPS 4

template <typename T>
__global__ void __launch_bounds__(32 * RICCATI_FUSED_WARPS)
    riccati_fused_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ lx, const T* __restrict__ lu,
                         const T* __restrict__ lxx, int lxx_sb, int lxx_st,
                         const T* __restrict__ luu, int luu_sb, int luu_st,
                         const T* __restrict__ lux, int lux_sb, int lux_st,
                         const T* __restrict__ lfx, const T* __restrict__ lfxx,
                         const T* __restrict__ reg, T* __restrict__ k, T* __restrict__ K,
                         T* __restrict__ dV1, unsigned char* __restrict__ ok, int B, int H,
                         int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * RICCATI_FUSED_WARPS + warp;
  if (b >= B) return;  // the whole warp: no block-wide barrier follows
  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)warp * rbd::k11::smem_values(nx, nu);
  rbd::k11::sweep<T>(threadIdx.x & 31, 32, sm, b, A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu,
                     luu_sb, luu_st, lux, lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1, ok, H,
                     nx, nu);
}

template <typename T>
static int launch_riccati_fused(const T* A, const T* Bm, const T* lx, const T* lu,
                                const T* lxx, int lxx_sb, int lxx_st, const T* luu,
                                int luu_sb, int luu_st, const T* lux, int lux_sb, int lux_st,
                                const T* lfx, const T* lfxx, const T* reg, T* k, T* K, T* dV1,
                                unsigned char* ok, int B, int H, int nx, int nu,
                                void* stream) {
  if (B <= 0) return 0;
  const size_t bytes =
      sizeof(T) * (size_t)RICCATI_FUSED_WARPS * (size_t)rbd::k11::smem_values(nx, nu);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        riccati_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + RICCATI_FUSED_WARPS - 1) / RICCATI_FUSED_WARPS;
  riccati_fused_kernel<T><<<blocks, 32 * RICCATI_FUSED_WARPS, bytes, (cudaStream_t)stream>>>(
      A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st, lux, lux_sb, lux_st, lfx, lfxx,
      reg, k, K, dV1, ok, B, H, nx, nu);
  return (int)cudaGetLastError();
}

#define RBD_RICCATI_FUSED(T, SFX)                                                             \
  int rbd_riccati_fused_##SFX(const T* A, const T* Bm, const T* lx, const T* lu,             \
                              const T* lxx, int lxx_sb, int lxx_st, const T* luu, int luu_sb, \
                              int luu_st, const T* lux, int lux_sb, int lux_st, const T* lfx, \
                              const T* lfxx, const T* reg, T* k, T* K, T* dV1,                \
                              unsigned char* ok, int B, int H, int nx, int nu,                \
                              void* stream) {                                                 \
    return launch_riccati_fused<T>(A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st,   \
                                   lux, lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1, ok, B, H,  \
                                   nx, nu, stream);                                           \
  }

extern "C" {
RBD_RICCATI_FUSED(float, f32)
RBD_RICCATI_FUSED(double, f64)
}
#endif
