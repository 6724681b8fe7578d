// riccati: the iLQR Riccati backward sweep, whole horizon per launch.
// Replaces rbdtpu kernels/riccati_chunk.py backward_pass_chunked (Pallas,
// riccati_chunk.py:523, lane tiling, K7) and its small-batch variant
// _backward_small (riccati_chunk.py:334, K8): one kernel serves both call
// sites.  The TPU kernel kept Vx/Vxx resident in VMEM across a sequential
// grid over the horizon; here one thread block owns one problem and loops
// over the H knots itself, with the carry and every per-knot intermediate
// in shared memory, so a sweep is one launch.
//
// Per knot t = H-1 .. 0 (rbdtpu solver/ddp.py backward_pass, iLQR branch;
// the port's plain version is rbdtpu_torch/solver/ddp.py backward_pass):
//   P1  [P | Pb] = Vxx [A | B];  [Qx | Qu] = [lx | lu] + [A | B]^T Vx
//   P2  G = [A | B]^T [P | Pb]: Qxx = lxx + A^T P (upper triangle, with
//       lxx's symmetric part), Qux = lux + B^T P, Quu = luu + B^T Pb (its
//       upper triangle, mirrored with luu's own entries)
//   P3  Quu + reg I = L D L^T, L unit lower, and R = L^-1, by m steps of
//       right-looking elimination over the block (one barrier a step); a
//       pivot <= 0 or NaN makes every gain of the knot NaN and clears ok
//   P4  T = D^-1 R [Qux | Qu];  P5  [K | k] = -R^T T
//       (so K = -(Quu + reg I)^-1 Qux and k likewise, with no serial
//       substitution)
//   P6  Z = Quu [K | k] + [2 Qux | Qu]
//   P7  Vxx = sym(Qxx) + sym(K^T Z) (its upper triangle, mirrored), which
//       is the plain sweep's sym(Qxx + K^T Quu K + K^T Qux + Qux^T K);
//       Vx = Qx + K^T (Quu k + Qu) + Qux^T k;  dV1 += k . Qu
// The carry Vxx is taken as symmetric: the plain sweep symmetrises it after
// every knot, and lfxx, the terminal Hessian, is symmetric wherever the
// solver builds it.
//
// Bound on the H100: the operations (~2.7 MFLOP a knot at nx = 72, nu = 36),
// as the products' operand loads from shared memory allow.  The design:
//   - Register tiles.  Every product gives each thread 4 x 4 outputs and
//     walks the depth with a row of each operand in registers (one 16-byte
//     load of four values where the operand is read down a column), so one
//     shared load feeds four multiply-adds.  The tiles are listed row by
//     row, so neighbouring lanes take neighbouring columns and store a tile
//     row in 16 bytes without bank conflicts.  The symmetric outputs (Qxx,
//     Quu, the Vxx update) take only their upper tiles; P7's tile adds its
//     mirror tile's transpose after its own.  Epilogues only store: the cost blocks
//     are added and the symmetric matrices mirrored by element-parallel
//     passes after a barrier (adding them in the tiles' epilogues, each
//     thread loading scattered entries, cost a third of the sweep).  No
//     TF32 and no tensor cores: float32 stays float32 (the paths are held at
//     1e-4 / 1e-3).
//   - The next knot arrives during this one.  A_t and B_t are staged side by
//     side as one [A | B] buffer; once P2 has read it, knot t-1's copies are
//     issued by cp.async and land during P3-P7 (with the per-knot cost
//     blocks prefetched into L2).  One buffer serves both dtypes: at nx = 72,
//     nu = 36 the layout takes 199,616 B in float64, 99,808 B in float32
//     (two blocks an SM).
//   - The solve spread over the block: the elimination's trailing entries
//     and R's entries are one fixed lower-triangle entry each, so a step is
//     one barrier and a few entries a thread; T and [K | k] are products.
//   - Latency, not throughput, decides: a knot is a chain of about m + 9
//     barrier-separated steps, each a few dependent shared-memory round
//     trips a thread.  So the block is as small as keeps the batch in as
//     few waves as any size (kernels/_lib.py riccati_geometry: configs[3]'s
//     1024 problems take 64 threads, eight blocks an SM; the humanoid's 256
//     take 256), within 128 registers a thread.  Splitting a problem of a
//     small batch over a cluster of blocks (distributed shared memory) was
//     measured slower at every size, as every block still holds a tile a
//     thread and the remote stores and cluster barriers add to the chain
//     (PERF.md §6).
//
// Layouts (row-major): A (B, H, nx, nx), Bm (B, H, nx, nu), lx (B, H, nx),
// lu (B, H, nu); lxx/luu/lux at base + b * sb + t * st (sb = st = 0 for a
// constant block, read in place); lfx (B, nx), lfxx (B, nx, nx), reg (B);
// out k (B, H, nu), K (B, H, nu, nx), dV1 (B), ok (B) bytes.  Shared memory:
// riccati_layout (kernels/_lib.py riccati_values mirrors it).
//
// The block code compiles for the host too: riccati_problem with a RicCtx
// of one thread (tid 0, nt 1) runs a whole problem, and a host harness may
// define RBD_RIC_HOST (a RicHost with bar()) to run a block's threads.
#include "rbd_team.cuh"

namespace rbd {

template <typename T>
RBD_HD T nan_() {
  return T(0) / T(0);
}

// Edge of a product's register tile.
constexpr int RT = 4;
// Entries of the elimination a thread keeps in registers (kernels/_lib.py
// riccati_geometry gives a block enough threads for all of them).
constexpr int TRI = 8;

// Row of entry e of a lower triangle listed row by row.
RBD_HD int tri_row(int e) {
  int i = (int)((sqrt_r((float)(8 * e + 1)) - 1.0f) * 0.5f);
  if (i * (i + 1) / 2 > e) --i;
  if ((i + 1) * (i + 2) / 2 <= e) ++i;
  return i;
}

RBD_HD int up4(int x) { return (x + 3) & ~3; }
RBD_HD int cdiv4(int x) { return (x + 3) >> 2; }

// The sweep's shared-memory layout in values of T for an (n, m) problem:
// V (n x LDV; the carry Vxx, Qxx's upper triangle during a knot), Vx and
// Qx (n), AB ([A | B], n x LDAB), the region PP ([P | Pb], n x LDAB; after
// P2 it holds R, then the elimination's entries A2 and T, then Z, and
// [K | k]), QUX ([Qux | Qu], m x LDQ), QUU (Quu in full), DV (the pivots),
// FLAG.  Matrices read along rows by the products (R, Quu) have their rows
// padded to whole tiles; every buffer starts on four values.
struct RicLayout {
  int LDV, LDAB, LDQ, LDM;
  int V, VX, QX, AB, PP, R, A2, TP, KA, QUX, QUU, DV, FLAG, VALUES;
};

RBD_HD RicLayout riccati_layout(int n, int m) {
  RicLayout L;
  L.LDV = up4(n);
  L.LDAB = up4(n + m);
  L.LDQ = up4(n + 1);
  L.LDM = up4(m);
  const int mr = up4(m);
  L.V = 0;
  L.VX = L.V + n * L.LDV;
  L.QX = L.VX + up4(n);
  L.AB = L.QX + up4(n);
  L.PP = L.AB + n * L.LDAB;
  // inside PP once P2 is done: R, then A2 (P3) overlaid by T (P4) and Z
  // (P6), then [K | k]
  L.R = L.PP;
  L.A2 = L.R + mr * L.LDM;
  L.TP = L.A2;
  const int a2 = m * L.LDM > m * L.LDQ ? m * L.LDM : m * L.LDQ;
  L.KA = L.A2 + a2;
  const int pp_after = L.KA + m * L.LDQ - L.PP, pp_before = n * L.LDAB;
  L.QUX = L.PP + (pp_before > pp_after ? pp_before : pp_after);
  L.QUU = L.QUX + m * L.LDQ;
  L.DV = L.QUU + mr * L.LDM;
  L.FLAG = L.DV + up4(m);
  L.VALUES = L.FLAG + 4;
  return L;
}

// kernels/_lib.py riccati_values
RBD_HD int riccati_smem_values(int n, int m) { return riccati_layout(n, m).VALUES; }

// Four consecutive values from shared memory (16-byte aligned on the card).
template <typename T>
RBD_HD void ld4(const T* p, T* o) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
    const double2 v0 = reinterpret_cast<const double2*>(p)[0];
    const double2 v1 = reinterpret_cast<const double2*>(p)[1];
    o[0] = v0.x, o[1] = v0.y, o[2] = v1.x, o[3] = v1.y;
  }
#else
  for (int k = 0; k < 4; ++k) o[k] = p[k];
#endif
}

// acc[a][b] += sum over k in [k0, k1) of Aop(i0 + a, k) Bop(k, j0 + b), with
// Aop(i, k) = A[k * lda + i] when AK (read down a column: one load of four)
// else A[i * lda + k], and Bop(k, j) = B[k * ldb + j].
template <bool AK, typename T>
RBD_HD void mma4(T (&acc)[RT][RT], const T* A, int lda, const T* B, int ldb, int i0, int j0,
                 int k0, int k1) {
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    T a[RT], b[RT];
    if constexpr (AK) {
      ld4(A + k * lda + i0, a);
    } else {
#pragma unroll
      for (int x = 0; x < RT; ++x) a[x] = A[(i0 + x) * lda + k];
    }
    ld4(B + k * ldb + j0, b);
#pragma unroll
    for (int x = 0; x < RT; ++x)
#pragma unroll
      for (int y = 0; y < RT; ++y) acc[x][y] += a[x] * b[y];
  }
}

// Four consecutive values to shared memory (16-byte aligned on the card).
template <typename T>
RBD_HD void st4(T* p, const T* v) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
#else
  for (int k = 0; k < 4; ++k) p[k] = v[k];
#endif
}

template <typename T>
RBD_HD void zero4(T (&acc)[RT][RT]) {
#pragma unroll
  for (int x = 0; x < RT; ++x)
#pragma unroll
    for (int y = 0; y < RT; ++y) acc[x][y] = T(0);
}

// This thread's tiles of a product listed row by row: tile rows tr < ntr,
// each over the tile columns cols(tr, a0, a1, b0, b1) = [a0, a1) then
// [b0, b1), b0 >= a1; the k-th tile of the list goes to thread k mod nt,
// so the lanes of a warp take neighbouring columns of a row (16-byte
// stores of a tile row from neighbouring lanes fill every bank once).
template <class Cols, class Body>
RBD_HD void row_tiles(int tid, int nt, int ntr, Cols cols, Body body) {
  int e = tid;
  for (int tr = 0; tr < ntr; ++tr) {
    int a0, a1, b0, b1;
    cols(tr, a0, a1, b0, b1);
    const int na = a1 - a0, cnt = na + b1 - b0;
    for (; e < cnt; e += nt) body(tr, e < na ? a0 + e : b0 + e - na);
    e -= cnt;
  }
}

// The entries (i, j) of an r x c matrix, row by row, that thread tid of nt
// takes: each thread's k-th entry is tid + k nt, without a division a step.
template <class Body>
RBD_HD void strided_entries(int tid, int nt, int r, int c, Body body) {
  int i = tid / c, j = tid - i * c;
  const int di = nt / c, dj = nt - di * c;
  while (i < r) {
    body(i, j);
    i += di;
    j += dj;
    if (j >= c) {
      j -= c;
      ++i;
    }
  }
}

RBD_HD void prefetch_l2(const void* p) {
#if defined(__CUDA_ARCH__)
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// One thread of the block that sweeps a problem, and the block's barrier.
struct RicCtx {
  int tid, nt;
#if !defined(__CUDA_ARCH__) && defined(RBD_RIC_HOST)
  RicHost* host;  // the host harness's threads
#endif

  RBD_HD void bar() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#elif defined(RBD_RIC_HOST)
    host->bar();
#endif
  }
};

// The sweep of problem b by one thread of the context's block; sm points at
// riccati_layout(n, m).VALUES values.  V keeps Vxx's upper triangle
// through a knot (Qxx's, then the update's) and is mirrored once the knot
// is done.
template <typename T>
RBD_HD void riccati_problem(const RicCtx& cx, T* sm, int b, const T* A, const T* Bg, const T* lx,
                            const T* lu, const T* lxx, int lxx_sb, int lxx_st, const T* luu,
                            int luu_sb, int luu_st, const T* lux, int lux_sb, int lux_st,
                            const T* lfx, const T* lfxx, const T* reg, T* kout, T* Kout, T* dV1,
                            unsigned char* ok, int H, int n, int m) {
  const RicLayout L = riccati_layout(n, m);
  const int tid = cx.tid, nt = cx.nt;
  const int LDV = L.LDV, LDAB = L.LDAB, LDQ = L.LDQ, LDM = L.LDM;
  T* V = sm + L.V;
  T* Vx = sm + L.VX;
  T* Qx = sm + L.QX;
  T* AB = sm + L.AB;
  T* PP = sm + L.PP;
  T* R = sm + L.R;
  T* A2 = sm + L.A2;
  T* TP = sm + L.TP;
  T* ZA = sm + L.TP;
  T* KA = sm + L.KA;
  T* QU = sm + L.QUX;
  T* QUU = sm + L.QUU;
  T* DV = sm + L.DV;
  int* flag = reinterpret_cast<int*>(sm + L.FLAG);
  const size_t bn = (size_t)b;
  const T rg = reg[b];
  const int nm = n + m, ntr = cdiv4(n), ntab = cdiv4(nm), ntq = cdiv4(n + 1), ntm = cdiv4(m);

  // rows x cols values at src (row-major) into dst (leading dimension ldd)
  // by cp.async, in the widest chunks (16, 8 or sizeof(T) bytes) that
  // every row's start on both sides allows
  auto copy_rows = [&](T* dst, int ldd, const T* src, int rows, int cols) {
    auto fits = [&](int bytes) {
      const int v = bytes / (int)sizeof(T);
      return v >= 1 && cols % v == 0 && ldd % v == 0 &&
             (reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) % bytes == 0;
    };
    if (fits(16)) {
      constexpr int v = 16 / sizeof(T);
      strided_entries(tid, nt, rows, cols / v, [&](int k, int c) {
        copy_async_bytes<16>(dst + k * ldd + c * v, src + k * cols + c * v);
      });
    } else if (sizeof(T) == 4 && fits(8)) {
      strided_entries(tid, nt, rows, cols / 2, [&](int k, int c) {
        copy_async_bytes<8>(dst + k * ldd + c * 2, src + k * cols + c * 2);
      });
    } else {
      strided_entries(tid, nt, rows, cols, [&](int k, int j) {
        copy_async_bytes<sizeof(T)>(dst + k * ldd + j, src + k * cols + j);
      });
    }
  };
  // [A_t | B_t] into AB by cp.async, committed
  auto stage = [&](int t) {
    const size_t kt = bn * H + t;
    copy_rows(AB, LDAB, A + kt * n * n, n, n);
    copy_rows(AB + n, LDAB, Bg + kt * n * m, n, m);
    copy_async_commit();
  };
  // the carry: V = lfxx^T (read as Vxx(i, k) = V[k][i]), Vx = lfx
  strided_entries(tid, nt, n, n, [&](int i, int k) { V[k * LDV + i] = lfxx[(bn * n + i) * n + k]; });
  for (int e = tid; e < n; e += nt) Vx[e] = lfx[bn * n + e];
  stage(H - 1);
  copy_async_wait();
  // this thread's first TRI entries of Quu's lower triangle (row-major
  // index tid + k nt) as (row << 16 | column), -1 past its end
  const int ntri = m * (m + 1) / 2;
  int tri[TRI];
#pragma unroll
  for (int k = 0; k < TRI; ++k) {
    const int e = tid + k * nt, i = e < ntri ? tri_row(e) : 0;
    tri[k] = e < ntri ? (i << 16 | (e - i * (i + 1) / 2)) : -1;
  }
  int okacc = 1;
  T dv = T(0);
  cx.bar();
  for (int t = H - 1; t >= 0; --t) {
    const size_t kt = bn * H + t;
    const T* lxt = lx + kt * n;
    const T* lut = lu + kt * m;
    const T* lxxt = lxx + (size_t)lxx_sb * bn + (size_t)lxx_st * t;
    const T* luut = luu + (size_t)luu_sb * bn + (size_t)luu_st * t;
    const T* luxt = lux + (size_t)lux_sb * bn + (size_t)lux_st * t;

    // P1: [P | Pb] = Vxx [A | B] over this block's tile columns; the
    // matvec [Qx | Qu] from the last thread down
    row_tiles(
        tid, nt, ntr, [&](int, int& a0, int& a1, int& b0, int& b1) { a0 = 0, a1 = b0 = b1 = ntab; },
        [&](int tr, int tc) {
          T acc[RT][RT];
          zero4(acc);
          mma4<true>(acc, V, LDV, AB, LDAB, RT * tr, RT * tc, 0, n);
#pragma unroll
          for (int x = 0; x < RT; ++x)
            if (RT * tr + x < n) st4(PP + (RT * tr + x) * LDAB + RT * tc, acc[x]);
        });
    for (int e = nt - 1 - tid; e < nm; e += nt) {
      T s0 = 0, s1 = 0;
      int k = 0;
      for (; k + 1 < n; k += 2) {
        s0 += AB[k * LDAB + e] * Vx[k];
        s1 += AB[(k + 1) * LDAB + e] * Vx[k + 1];
      }
      if (k < n) s0 += AB[k * LDAB + e] * Vx[k];
      if (e < n) {
        Qx[e] = lxt[e] + (s0 + s1);
      } else {
        QU[(e - n) * LDQ + n] = lut[e - n] + (s0 + s1);
      }
    }
    cx.bar();

    // P2: G = [A | B]^T [P | Pb], its tiles stored as they are: the rows
    // of Qxx's upper tiles into V, of Qux's into Qux, of Quu's upper tiles
    // into Quu; then one pass adds lux, and luu with Quu's mirror (lxx is
    // added with Vxx's mirror at the knot's end)
    row_tiles(
        tid, nt, ntab,
        [&](int tr, int& a0, int& a1, int& b0, int& b1) {
          const int ntn = cdiv4(n);
          if (RT * tr + RT <= n) {  // Qxx rows only
            a0 = tr, a1 = b0 = b1 = ntn;
          } else {  // Qux, Quu (and Qxx on a row tile that straddles n)
            a0 = 0, a1 = ntn, b0 = tr < ntn ? ntn : tr, b1 = ntab;
          }
        },
        [&](int tr, int tc) {
          T acc[RT][RT];
          zero4(acc);
          mma4<true>(acc, AB, LDAB, PP, LDAB, RT * tr, RT * tc, 0, n);
          const int j0 = RT * tc;
#pragma unroll
          for (int x = 0; x < RT; ++x) {
            const int i = RT * tr + x;
            T* row = nullptr;  // where the tile row's four entries go
            if (i < n && j0 < n) {
              row = V + i * LDV + j0;
            } else if (i >= n && i < nm && j0 + RT <= n) {
              row = QU + (i - n) * LDQ + j0;
            } else if (i >= n && i < nm && j0 >= n && (n & 3) == 0) {
              row = QUU + (i - n) * LDM + (j0 - n);
            }
            if (row != nullptr) {
              st4(row, acc[x]);
            } else if (i >= n && i < nm) {  // a tile that straddles column n
#pragma unroll
              for (int y = 0; y < RT; ++y) {
                const int j = j0 + y;
                if (j < n) {
                  QU[(i - n) * LDQ + j] = acc[x][y];
                } else if (j < nm) {
                  QUU[(i - n) * LDM + (j - n)] = acc[x][y];
                }
              }
            }
          }
        });
    cx.bar();
    strided_entries(tid, nt, m, n, [&](int r, int j) { QU[r * LDQ + j] += luxt[r * n + j]; });
    strided_entries(tid, nt, m, m, [&](int r, int c) {
      if (r <= c) {
        const T g = QUU[r * LDM + c];
        QUU[r * LDM + c] = g + luut[r * m + c];
        if (r < c) QUU[c * LDM + r] = g + luut[c * m + r];
      }
    });
    cx.bar();

    // knot t-1's [A | B] lands during P3-P7; its cost blocks go to L2
    if (t > 0) {
      stage(t - 1);
      const size_t kp = kt - 1;
      auto l2 = [&](const T* p, int len) {
        for (int e = tid * 128; e < len * (int)sizeof(T); e += nt * 128)
          prefetch_l2(reinterpret_cast<const char*>(p) + e);
      };
      l2(lx + kp * n, n);
      l2(lu + kp * m, m);
      if (lxx_st) l2(lxxt - lxx_st, n * n);
      if (luu_st) l2(luut - luu_st, m * m);
      if (lux_st) l2(luxt - lux_st, m * n);
    }

    // P3: Quu + reg I = L D L^T and R = L^-1 by right-looking elimination.
    // Step j updates, for rows i > j, R[i][c] (c <= j) and the trailing
    // A2[i][c] (j < c <= i) from column j, row j of R and the pivot d_j,
    // which the step before finished.  Each thread keeps its entries of the
    // lower triangle (tri); step 0 reads Quu + reg I.
    auto eliminate = [&](int j, int i, int c, T inv) {
      const T aij = j == 0 ? QUU[i * LDM] : A2[i * LDM + j];
      if (c <= j) {
        const T rjc = c == j ? T(1) : R[j * LDM + c];
        const T old = c == j ? T(0) : R[i * LDM + c];
        R[i * LDM + c] = old - aij * rjc * inv;
      } else {
        const T acj = j == 0 ? QUU[c * LDM] : A2[c * LDM + j];
        const T old = j == 0 ? QUU[i * LDM + c] + (i == c ? rg : T(0)) : A2[i * LDM + c];
        A2[i * LDM + c] = old - aij * acj * inv;
      }
    };
    for (int j = 0; j < m; ++j) {
      if (j > 0) cx.bar();
      const T dj = j == 0 ? QUU[0] + rg : A2[j * LDM + j];
      if (tid == 0) {
        DV[j] = dj;
        const int pd = dj > T(0);  // false for NaN too
        if (j == 0) {
          *flag = pd;
        } else if (!pd) {
          *flag = 0;
        }
      }
      if (j == 0) {  // R's diagonal and upper triangle
        strided_entries(tid, nt, m, m, [&](int i, int c) {
          if (c >= i) R[i * LDM + c] = c == i ? T(1) : T(0);
        });
      }
      const T inv = T(1) / dj;
#pragma unroll
      for (int k = 0; k < TRI; ++k) {
        const int i = tri[k] >> 16, c = tri[k] & 0xffff;
        if (tri[k] >= 0 && i > j) eliminate(j, i, c, inv);
      }
      for (int e = TRI * nt + tid; e < ntri; e += nt) {
        const int i = tri_row(e), c = e - i * (i + 1) / 2;
        if (i > j) eliminate(j, i, c, inv);
      }
    }
    cx.bar();
    const bool pd = *flag != 0;
    okacc &= (int)pd;
    auto all_cols = [&](int, int& a0, int& a1, int& b0, int& b1) { a0 = 0, a1 = b0 = b1 = ntq; };

    // P4: T = D^-1 R [Qux | Qu] (R lower: depth up to the tile's last row)
    row_tiles(tid, nt, ntm, all_cols, [&](int tr, int tc) {
      T acc[RT][RT];
      zero4(acc);
      const int k1 = RT * tr + RT < m ? RT * tr + RT : m;
      mma4<false>(acc, R, LDM, QU, LDQ, RT * tr, RT * tc, 0, k1);
#pragma unroll
      for (int x = 0; x < RT; ++x) {
        const int i = RT * tr + x;
        if (i >= m) continue;
        const T di = pd ? T(1) / DV[i] : nan_<T>();
        T row[RT];
#pragma unroll
        for (int y = 0; y < RT; ++y) row[y] = acc[x][y] * di;
        st4(TP + i * LDQ + RT * tc, row);
      }
    });
    cx.bar();
    // P5: [K | k] = -R^T T (R^T upper: depth from the tile's first row)
    row_tiles(tid, nt, ntm, all_cols, [&](int tr, int tc) {
      T acc[RT][RT];
      zero4(acc);
      mma4<true>(acc, R, LDM, TP, LDQ, RT * tr, RT * tc, RT * tr, m);
#pragma unroll
      for (int x = 0; x < RT; ++x) {
        const int c = RT * tr + x;
        if (c >= m) continue;
        T row[RT];
#pragma unroll
        for (int y = 0; y < RT; ++y) row[y] = -acc[x][y];
        st4(KA + c * LDQ + RT * tc, row);
#pragma unroll
        for (int y = 0; y < RT; ++y) {
          const int j = RT * tc + y;
          if (j < n) {
            Kout[(kt * m + c) * n + j] = row[y];
          } else if (j == n) {
            kout[kt * m + c] = row[y];
          }
        }
      }
    });
    cx.bar();
    // P6: Z = Quu [K | k] + [2 Qux | Qu] (over T); dV1 += k . Qu
    row_tiles(tid, nt, ntm, all_cols, [&](int tr, int tc) {
      T acc[RT][RT];
      zero4(acc);
      mma4<false>(acc, QUU, LDM, KA, LDQ, RT * tr, RT * tc, 0, m);
#pragma unroll
      for (int x = 0; x < RT; ++x) {
        const int r = RT * tr + x;
        if (r >= m) continue;
        T q[RT], row[RT];
        ld4(QU + r * LDQ + RT * tc, q);
#pragma unroll
        for (int y = 0; y < RT; ++y) row[y] = acc[x][y] + (RT * tc + y < n ? T(2) * q[y] : q[y]);
        st4(ZA + r * LDQ + RT * tc, row);
      }
    });
    if (tid == 0) {
      T s = 0;
      for (int r = 0; r < m; ++r) s += KA[r * LDQ + n] * QU[r * LDQ + n];
      dv += s;
    }
    cx.bar();
    // P7: Vxx = sym(Qxx) + sym(K^T Z) (lxx's part added with the mirror)
    // over the upper tiles: the tile of K^T Z, then its mirror tile's
    // transpose, each added at half weight (one loop over both, with one
    // accumulator, measured 6% slower at configs[3]); Vx = Qx +
    // K^T (Quu k + Qu) + Qux^T k
    row_tiles(
        tid, nt, ntr, [&](int tr, int& a0, int& a1, int& b0, int& b1) { a0 = tr, a1 = b0 = b1 = ntr; },
        [&](int tr, int tc) {
          T y[RT][RT];
          const bool full = tr < tc && RT * tc + RT <= n;
          for (int half = 0; half < 2; ++half) {
            zero4(y);
            if (half == 0) {
              mma4<true>(y, KA, LDQ, ZA, LDQ, RT * tr, RT * tc, 0, m);
            } else {
              mma4<true>(y, ZA, LDQ, KA, LDQ, RT * tr, RT * tc, 0, m);
            }
#pragma unroll
            for (int x = 0; x < RT; ++x) {
              const int i = RT * tr + x;
              T* vr = V + i * LDV + RT * tc;
              if (full) {
                T row[RT];
                ld4(vr, row);
#pragma unroll
                for (int k = 0; k < RT; ++k) row[k] += T(0.5) * y[x][k];
                st4(vr, row);
              } else {
#pragma unroll
                for (int k = 0; k < RT; ++k)
                  if (RT * tc + k < n && i <= RT * tc + k) vr[k] += T(0.5) * y[x][k];
              }
            }
          }
        });
    for (int e = nt - 1 - tid; e < n; e += nt) {
      T s0 = 0, s1 = 0;
      for (int r = 0; r < m; ++r) {
        s0 += KA[r * LDQ + e] * ZA[r * LDQ + n];
        s1 += QU[r * LDQ + e] * KA[r * LDQ + n];
      }
      Vx[e] = Qx[e] + (s0 + s1);
    }
    copy_async_wait();
    cx.bar();
    // Vxx = its upper triangle plus lxx's symmetric part, mirrored
    if (t > 0) {
      strided_entries(tid, nt, n, n, [&](int i, int j) {
        if (i <= j) {
          const T v = V[i * LDV + j] + T(0.5) * (lxxt[i * n + j] + lxxt[j * n + i]);
          V[i * LDV + j] = v;
          V[j * LDV + i] = v;
        }
      });
      cx.bar();
    }
  }
  if (tid == 0) {
    dV1[b] = dv;
    ok[b] = (unsigned char)okacc;
  }
}

}  // namespace rbd

#ifdef __CUDACC__
// the most threads a block of the sweep takes (kernels/_lib.py
// riccati_geometry picks 64-256 from the problem's size and batch)
#define RBD_RIC_THREADS 256

// at most 128 registers a thread: two blocks of 256 threads an SM, eight of
// 64 (kernels/_lib.py RIC_REGS)
template <typename T>
__global__ void __launch_bounds__(RBD_RIC_THREADS, 2)
    riccati_kernel(const T* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ lx,
                   const T* __restrict__ lu, const T* __restrict__ lxx, int lxx_sb, int lxx_st,
                   const T* __restrict__ luu, int luu_sb, int luu_st, const T* __restrict__ lux,
                   int lux_sb, int lux_st, const T* __restrict__ lfx,
                   const T* __restrict__ lfxx, const T* __restrict__ reg, T* __restrict__ k,
                   T* __restrict__ K, T* __restrict__ dV1, unsigned char* __restrict__ ok, int H,
                   int nx, int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const rbd::RicCtx cx{(int)threadIdx.x, (int)blockDim.x};
  rbd::riccati_problem<T>(cx, reinterpret_cast<T*>(smem_raw), blockIdx.x, A, Bm, lx, lu, lxx,
                          lxx_sb, lxx_st, luu, luu_sb, luu_st, lux, lux_sb, lux_st, lfx, lfxx, reg,
                          k, K, dV1, ok, H, nx, nu);
}

// One launch: B problems, one block of nt threads each, smem bytes of
// shared memory a block, which must be the layout's.  Returns a cudaError_t.
template <typename T>
static int launch_riccati(const T* A, const T* Bm, const T* lx, const T* lu, const T* lxx,
                          int lxx_sb, int lxx_st, const T* luu, int luu_sb, int luu_st,
                          const T* lux, int lux_sb, int lux_st, const T* lfx, const T* lfxx,
                          const T* reg, T* k, T* K, T* dV1, unsigned char* ok, int B, int H,
                          int nx, int nu, int nt, int smem, void* stream) {
  if (B <= 0) return 0;
  const size_t need = sizeof(T) * (size_t)rbd::riccati_smem_values(nx, nu);
  if (nt < 32 || nt > RBD_RIC_THREADS || nt % 32 != 0 || (size_t)smem != need || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        riccati_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  riccati_kernel<T><<<B, nt, smem, (cudaStream_t)stream>>>(
      A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st, lux, lux_sb, lux_st, lfx, lfxx,
      reg, k, K, dV1, ok, H, nx, nu);
  return (int)cudaGetLastError();
}

#define RBD_RICCATI(T, SFX)                                                                   \
  int rbd_riccati_##SFX(const T* A, const T* Bm, const T* lx, const T* lu, const T* lxx,      \
                        int lxx_sb, int lxx_st, const T* luu, int luu_sb, int luu_st,         \
                        const T* lux, int lux_sb, int lux_st, const T* lfx, const T* lfxx,    \
                        const T* reg, T* k, T* K, T* dV1, unsigned char* ok, int B, int H,    \
                        int nx, int nu, int nt, int smem, void* stream) {                     \
    return launch_riccati<T>(A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st, lux,    \
                             lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1, ok, B, H, nx, nu, nt, \
                             smem, stream);                                                   \
  }

extern "C" {
RBD_RICCATI(float, f32)
RBD_RICCATI(double, f64)
}
#endif
