// riccati: the iLQR Riccati backward sweep, whole horizon per launch.
// Replaces rbdtpu kernels/riccati_chunk.py backward_pass_chunked (Pallas,
// riccati_chunk.py:523, lane tiling, K7) and its small-batch variant
// _backward_small (riccati_chunk.py:334, K8): one kernel serves both call
// sites.  The TPU kernel kept Vx/Vxx resident in VMEM across a sequential
// grid over the horizon; here one thread block owns one problem and loops
// over the H knots itself, with Vx, Vxx and every per-knot intermediate in
// shared memory, so the carry never touches device memory and a sweep is
// one launch.
//
// Per knot t = H-1 .. 0 (rbdtpu solver/ddp.py backward_pass, iLQR branch;
// the port's plain version is rbdtpu_torch/solver/ddp.py backward_pass):
//   P  = Vxx A,  Pb = Vxx B,  Qx = lx + A^T Vx,  Qu = lu + B^T Vx
//   Quu = luu + B^T Pb,  Qux = lux + B^T P,  Qxx = lxx + A^T P
//   L L^T = Quu + reg I (one warp; a pivot <= 0 or NaN gives NaN and
//           clears ok: the solver's PD guard)
//   k = -(L L^T)^-1 Qu,  K = -(L L^T)^-1 Qux (one thread per right-hand
//           column, in place)
//   Vx  = Qx + K^T (Quu k) + K^T Qu + Qux^T k
//   Vxx = sym(Qxx + K^T (Quu K) + K^T Qux + Qux^T K),  dV1 += k . Qu
// Every product is split over the block's threads by output entry.
//
// Layouts (row-major): A (B, H, nx, nx), Bm (B, H, nx, nu), lx (B, H, nx),
// lu (B, H, nu); lxx/luu/lux at base + b * sb + t * st (sb = st = 0 for a
// constant block, read in place); lfx (B, nx), lfxx (B, nx, nx), reg (B);
// out k (B, H, nu), K (B, H, nu, nx), dV1 (B), ok (B) bytes.
// Shared memory per block: 2 nx^2 + 4 nx nu + 2 nu^2 + 2 nx + 3 nu values
// (kernels/riccati_chunk.py smem_bytes): 31 KB at nx = 36, nu = 18 in
// float32, 189 KB at nx = 72, nu = 36 in float64 (above 48 KB the launcher
// opts in to Hopper's larger dynamic shared memory).
// Bound on the H100: the operations (~0.5 MFLOP a knot at nx = 36) against
// the shared-memory bandwidth of one operand load per multiply-add; A is
// read from device memory (L1-cached) rather than staged, which keeps the
// nx = 72 float64 problem inside one block's shared memory.
#include "rbd_common.cuh"

#ifdef __CUDA_ARCH__
#define RBD_SYNC() __syncthreads()
#define RBD_SYNCWARP() __syncwarp()
#else
#define RBD_SYNC()
#define RBD_SYNCWARP()
#endif

namespace rbd {

template <typename T>
RBD_HD T nan_() {
  return T(0) / T(0);
}

// Shared-memory values the sweep of one (nx, nu) problem needs.
RBD_HD int riccati_smem_values(int n, int m) {
  return 2 * n * n + 4 * n * m + 2 * m * m + 2 * n + 3 * m;
}

// The sweep of problem b by thread tid of nt (a whole block); sm points at
// riccati_smem_values(nx, nu) values.  Returns dV1 in thread 0; writes ok
// through *ok (thread 0, after the last knot).
template <typename T>
RBD_HD void riccati_problem(int tid, int nt, T* sm, int* ok_s, int b, const T* A, const T* Bg,
                            const T* lx, const T* lu, const T* lxx, int lxx_sb, int lxx_st,
                            const T* luu, int luu_sb, int luu_st, const T* lux, int lux_sb,
                            int lux_st, const T* lfx, const T* lfxx, const T* reg, T* kout,
                            T* Kout, T* dV1, unsigned char* ok, int H, int n, int m) {
  T* Vxx = sm;            // n n: Vxx, then Qxx
  T* P = Vxx + n * n;     // n n: Vxx A, then the unsymmetrised Vxx
  T* Bs = P + n * n;      // n m: B
  T* Pb = Bs + n * m;     // n m: Vxx B, then Quu K (m n)
  T* Qux = Pb + n * m;    // m n
  T* Ks = Qux + m * n;    // m n: K
  T* Quu = Ks + m * n;    // m m
  T* L = Quu + m * m;     // m m: Cholesky factor (lower)
  T* Vx = L + m * m;      // n
  T* Qx = Vx + n;         // n
  T* Qu = Qx + n;         // m
  T* ks = Qu + m;         // m: k
  T* Quuk = ks + m;       // m: Quu k
  const size_t bn = (size_t)b;
  for (int e = tid; e < n * n; e += nt) Vxx[e] = lfxx[bn * n * n + e];
  for (int e = tid; e < n; e += nt) Vx[e] = lfx[bn * n + e];
  if (tid == 0) *ok_s = 1;
  const T rg = reg[b];
  T dv = T(0);
  RBD_SYNC();
  for (int t = H - 1; t >= 0; --t) {
    const size_t kt = bn * H + t;
    const T* At = A + kt * n * n;
    const T* Bt = Bg + kt * n * m;
    const T* lxt = lx + kt * n;
    const T* lut = lu + kt * m;
    const T* lxxt = lxx + (size_t)lxx_sb * bn + (size_t)lxx_st * t;
    const T* luut = luu + (size_t)luu_sb * bn + (size_t)luu_st * t;
    const T* luxt = lux + (size_t)lux_sb * bn + (size_t)lux_st * t;
    for (int e = tid; e < n * m; e += nt) Bs[e] = Bt[e];
    RBD_SYNC();
    // P = Vxx A, Pb = Vxx B, Qx = lx + A^T Vx, Qu = lu + B^T Vx
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      T s = 0;
      for (int k = 0; k < n; ++k) s += Vxx[i * n + k] * At[k * n + j];
      P[e] = s;
    }
    for (int e = tid; e < n * m; e += nt) {
      const int i = e / m, j = e % m;
      T s = 0;
      for (int k = 0; k < n; ++k) s += Vxx[i * n + k] * Bs[k * m + j];
      Pb[e] = s;
    }
    for (int e = tid; e < n; e += nt) {
      T s = 0;
      for (int k = 0; k < n; ++k) s += At[k * n + e] * Vx[k];
      Qx[e] = lxt[e] + s;
    }
    for (int e = tid; e < m; e += nt) {
      T s = 0;
      for (int k = 0; k < n; ++k) s += Bs[k * m + e] * Vx[k];
      Qu[e] = lut[e] + s;
    }
    RBD_SYNC();
    // Quu = luu + B^T Pb, Qux = lux + B^T P, Qxx = lxx + A^T P (over Vxx)
    for (int e = tid; e < m * m; e += nt) {
      const int i = e / m, j = e % m;
      T s = 0;
      for (int k = 0; k < n; ++k) s += Bs[k * m + i] * Pb[k * m + j];
      Quu[e] = luut[e] + s;
    }
    for (int e = tid; e < m * n; e += nt) {
      const int i = e / n, j = e % n;
      T s = 0;
      for (int k = 0; k < n; ++k) s += Bs[k * m + i] * P[k * n + j];
      Qux[e] = luxt[e] + s;
    }
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      T s = 0;
      for (int k = 0; k < n; ++k) s += At[k * n + i] * P[k * n + j];
      Vxx[e] = lxxt[e] + s;
    }
    RBD_SYNC();
    // Cholesky of Quu + reg I by the first warp, left-looking by columns
    if (tid < 32) {
      const int lanes = nt < 32 ? nt : 32;
      for (int j = 0; j < m; ++j) {
        if (tid == 0) {
          T s = Quu[j * m + j] + rg;
          for (int k = 0; k < j; ++k) s -= L[j * m + k] * L[j * m + k];
          const bool pd = s > T(0);  // false for NaN too
          L[j * m + j] = pd ? sqrt_r(s) : nan_<T>();
          if (!pd) *ok_s = 0;
        }
        RBD_SYNCWARP();
        for (int i = j + 1 + tid; i < m; i += lanes) {
          T s = Quu[i * m + j];
          for (int k = 0; k < j; ++k) s -= L[i * m + k] * L[j * m + k];
          L[i * m + j] = s / L[j * m + j];
        }
        RBD_SYNCWARP();
      }
    }
    RBD_SYNC();
    // k (column c = n) and the columns of K, each solved in place by one
    // thread: forward substitution with L, then backward with L^T
    for (int c = tid; c <= n; c += nt) {
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
    RBD_SYNC();
    // Quu K (over Pb), Quu k; k and K to device memory
    for (int e = tid; e < m * n; e += nt) {
      const int i = e / n, j = e % n;
      T s = 0;
      for (int k = 0; k < m; ++k) s += Quu[i * m + k] * Ks[k * n + j];
      Pb[e] = s;
      Kout[kt * m * n + e] = Ks[e];
    }
    for (int e = tid; e < m; e += nt) {
      T s = 0;
      for (int k = 0; k < m; ++k) s += Quu[e * m + k] * ks[k];
      Quuk[e] = s;
      kout[kt * m + e] = ks[e];
    }
    RBD_SYNC();
    // Vx, the unsymmetrised Vxx (over P), dV1
    for (int e = tid; e < n; e += nt) {
      T s1 = 0, s2 = 0, s3 = 0;
      for (int r = 0; r < m; ++r) {
        s1 += Ks[r * n + e] * Quuk[r];
        s2 += Ks[r * n + e] * Qu[r];
        s3 += Qux[r * n + e] * ks[r];
      }
      Vx[e] = Qx[e] + s1 + s2 + s3;
    }
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      T s1 = 0, s2 = 0, s3 = 0;
      for (int r = 0; r < m; ++r) {
        s1 += Ks[r * n + i] * Pb[r * n + j];
        s2 += Ks[r * n + i] * Qux[r * n + j];
        s3 += Qux[r * n + i] * Ks[r * n + j];
      }
      P[e] = Vxx[e] + s1 + s2 + s3;
    }
    if (tid == 0) {
      T s = 0;
      for (int r = 0; r < m; ++r) s += ks[r] * Qu[r];
      dv += s;
    }
    RBD_SYNC();
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e % n;
      Vxx[e] = T(0.5) * (P[e] + P[j * n + i]);
    }
    RBD_SYNC();
  }
  if (tid == 0) {
    dV1[b] = dv;
    ok[b] = (unsigned char)*ok_s;
  }
}

}  // namespace rbd

#ifdef __CUDACC__
#define RBD_RIC_THREADS 256

template <typename T>
__global__ void __launch_bounds__(RBD_RIC_THREADS)
    riccati_kernel(const T* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ lx,
                   const T* __restrict__ lu, const T* __restrict__ lxx, int lxx_sb, int lxx_st,
                   const T* __restrict__ luu, int luu_sb, int luu_st, const T* __restrict__ lux,
                   int lux_sb, int lux_st, const T* __restrict__ lfx,
                   const T* __restrict__ lfxx, const T* __restrict__ reg, T* __restrict__ k,
                   T* __restrict__ K, T* __restrict__ dV1, unsigned char* __restrict__ ok, int H,
                   int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ok_s;
  rbd::riccati_problem<T>(threadIdx.x, blockDim.x, reinterpret_cast<T*>(smem_raw), &ok_s,
                          blockIdx.x, A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st,
                          lux, lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1, ok, H, nx, nu);
}

template <typename T>
static int launch_riccati(const T* A, const T* Bm, const T* lx, const T* lu, const T* lxx,
                          int lxx_sb, int lxx_st, const T* luu, int luu_sb, int luu_st,
                          const T* lux, int lux_sb, int lux_st, const T* lfx, const T* lfxx,
                          const T* reg, T* k, T* K, T* dV1, unsigned char* ok, int B, int H,
                          int nx, int nu, void* stream) {
  if (B <= 0) return 0;
  const size_t bytes = sizeof(T) * (size_t)rbd::riccati_smem_values(nx, nu);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        riccati_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  riccati_kernel<T><<<B, RBD_RIC_THREADS, bytes, (cudaStream_t)stream>>>(
      A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st, lux, lux_sb, lux_st, lfx, lfxx,
      reg, k, K, dV1, ok, H, nx, nu);
  return (int)cudaGetLastError();
}

#define RBD_RICCATI(T, SFX)                                                                   \
  int rbd_riccati_##SFX(const T* A, const T* Bm, const T* lx, const T* lu, const T* lxx,      \
                        int lxx_sb, int lxx_st, const T* luu, int luu_sb, int luu_st,         \
                        const T* lux, int lux_sb, int lux_st, const T* lfx, const T* lfxx,    \
                        const T* reg, T* k, T* K, T* dV1, unsigned char* ok, int B, int H,    \
                        int nx, int nu, void* stream) {                                       \
    return launch_riccati<T>(A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st, lux,    \
                             lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1, ok, B, H, nx, nu,     \
                             stream);                                                         \
  }

extern "C" {
RBD_RICCATI(float, f32)
RBD_RICCATI(double, f64)
}
#endif
