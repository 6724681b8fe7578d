// riccati_fused: the iLQR Riccati backward sweep at arm-class sizes (nx <=
// 16), whole horizon per launch, one thread block per problem.
// Replaces rbdtpu kernels/riccati.py backward_pass_fused (Pallas,
// riccati.py:102, K11).  The TPU kernel was one pallas_call per knot inside
// lax.scan, with the batch in lanes and every matrix unrolled into scalars;
// the carry (Vx, Vxx) went through device memory between knots.  Here one
// block owns one problem and loops over the H knots itself, with the carry,
// the knot's inputs and every intermediate in shared memory, so a sweep is
// one launch and the carry never leaves the SM.
//
// Per knot t = H-1 .. 0 (rbdtpu solver/ddp.py backward_pass, iLQR branch;
// the port's plain version is rbdtpu_torch/solver/ddp.py backward_pass), in
// phases separated by block barriers:
//   P1  [P | Pb] = Vxx [A | B] and [Qx | Qu] = [lx | lu] + [A | B]^T Vx,
//       one product over the rows of [Vxx; Vx^T]
//   P2  G = [A | B]^T [P | Pb]: Qxx = lxx + A^T P (all of it),
//       Qux = lux + B^T P, Quu = luu + B^T Pb (its upper triangle,
//       mirrored); Quu + reg I beside [Qux | Qu] as the augmented system W
//   P3  (Quu + reg I) X = [Qux | Qu] by Gauss-Jordan on W, one step a
//       barrier (no pivoting: the pivots are those of L D L^T, and a pivot
//       <= 0 or NaN makes every gain of the knot NaN and clears ok, the
//       solver's PD guard); [K | k] = -X to shared and device memory
//   P3' Z = Quu [K | k] + [2 Qux | Qu]
//   P4  Vxx = sym(Qxx) + sym(K^T Z), which is the plain sweep's
//       sym(Qxx + K^T Quu K + K^T Qux + Qux^T K), its upper triangle
//       written to both halves; Vx = Qx + K^T (Quu k + Qu) + Qux^T k;
//       dV1 += k . Qu
// Knot t-1's A, B, lx, lu and cost blocks are copied by cp.async into the
// second of two stage buffers while knot t computes.
//
// Bound on the H100: every matrix is at most 16 x 16, so a knot is a chain
// of short dependent steps (four products of depth nx or nu and the
// solve's nu barrier-separated steps), and latency, not bytes or
// operations, decides.  The design keeps that chain short and the block's
// threads busy on it: one block a problem (kernels/_lib.py
// riccati_fused_geometry gives it 64-256 threads, the most that keep the
// batch in as few waves as any count); one entry a thread in every product
// (two where a product has more entries than threads, as two chains of one
// loop), the operands of eight terms loaded before their products; the
// solve's entries owned by fixed threads; the next knot's inputs arriving
// during this one, one warp a block of them.  Measured on an H100
// (PERF.md §6): the solve's nu steps take about 45% of a knot at arm7's
// nu = 7; solving on one warp by shuffles instead (a row or a column of W
// a lane) was slower at every size tried, by register pressure.  The NaN of
// a failed knot is a constant: 0 / 0 written as a division ran the card's
// slow division path and took over a quarter of a knot's cycles in a draft.
//
// Layouts (row-major), as csrc/riccati_chunk.cu: A (B, H, nx, nx),
// Bm (B, H, nx, nu), lx (B, H, nx), lu (B, H, nu); lxx/luu/lux at
// base + b * sb + t * st (sb = st = 0 for a constant block); lfx (B, nx),
// lfxx (B, nx, nx), reg (B); out k (B, H, nu), K (B, H, nu, nx), dV1 (B),
// ok (B) bytes.  Shared memory: k11::layout (kernels/_lib.py
// riccati_fused_values mirrors it).
//
// The block code compiles for the host too: k11::sweep with tid 0 of nt 1
// runs a whole problem.
#include <limits>

#include "rbd_team.cuh"

#ifdef __CUDA_ARCH__
#define K11_SYNC() __syncthreads()
#else
#define K11_SYNC()
#endif

namespace rbd {
namespace k11 {

// A quiet NaN as a constant (0 / 0 written as a division is evaluated as
// one, on the card's slow division path, wherever it is selected)
template <typename T>
RBD_HD T nan_value() {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4) {
    return __int_as_float(0x7fc00000);
  } else {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
#else
  return std::numeric_limits<T>::quiet_NaN();
#endif
}

// The sweep's shared-memory layout in values of T for an (n, m) problem:
// two stage buffers of a knot's inputs (A, B, lx, lu, lxx, luu, lux, each
// as laid out in device memory, each starting on four values); V (Vxx, n x n, then Qxx) with Vx right
// after it as row n; P ([P | Pb], rows of n + m, with row n = [Qx | Qu]);
// Qux (m x n), Qu (m), Quu (m x m); W (the augmented system, m x (m + n +
// 1)); the pivots; X ([K | k], m x (n + 1)) and Z (the same);
// then the entry tables of P1, P2 and P4, one int a slot.
struct Layout {
  int LDP, NCOL, N1, N2, N4;
  int A, B, LX, LU, LXX, LUU, LUX, STAGE;
  int V, VX, P, QUX, QU, QUU, W, PIV, X, Z, TAB1, TAB2, TAB4, VALUES;
};

RBD_HD int up4(int x) { return (x + 3) & ~3; }

RBD_HD Layout layout(int n, int m) {
  Layout L;
  L.LDP = n + m;
  L.NCOL = m + n + 1;
  L.N1 = (n + 1) * (n + m);
  L.N2 = n * n + m * n + m * (m + 1) / 2;
  L.N4 = n * (n + 1) / 2 + n;
  L.A = 0;
  L.B = L.A + up4(n * n);
  L.LX = L.B + up4(n * m);
  L.LU = L.LX + up4(n);
  L.LXX = L.LU + up4(m);
  L.LUU = L.LXX + up4(n * n);
  L.LUX = L.LUU + up4(m * m);
  L.STAGE = L.LUX + up4(m * n);
  L.V = 2 * L.STAGE;
  L.VX = L.V + n * n;
  L.P = L.VX + n;
  L.QUX = L.P + (n + 1) * L.LDP;
  L.QU = L.QUX + m * n;
  L.QUU = L.QU + m;
  L.W = L.QUU + m * m;
  L.PIV = L.W + m * L.NCOL;
  L.X = L.PIV + m;
  L.Z = L.X + m * (n + 1);
  L.TAB1 = L.Z + m * (n + 1);
  L.TAB2 = L.TAB1 + L.N1;
  L.TAB4 = L.TAB2 + L.N2;
  L.VALUES = L.TAB4 + L.N4;
  return L;
}

// kernels/_lib.py riccati_fused_values
RBD_HD int smem_values(int n, int m) { return layout(n, m).VALUES; }

// len values src -> dst by cp.async, in the widest pieces (16, 8 or 4
// bytes) that both addresses and the length allow, piece e by thread e mod nt
template <typename T>
RBD_HD void copy_flat(int tid, int nt, T* dst, const T* src, int len) {
  const size_t bytes = (size_t)len * sizeof(T);
  const size_t al = reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src) | bytes;
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  if (al % 16 == 0) {
    for (int e = tid; e < (int)(bytes / 16); e += nt) copy_async_bytes<16>(d + 16 * e, s + 16 * e);
  } else if (al % 8 == 0) {
    for (int e = tid; e < (int)(bytes / 8); e += nt) copy_async_bytes<8>(d + 8 * e, s + 8 * e);
  } else {
    for (int e = tid; e < len; e += nt) copy_async_bytes<sizeof(T)>(dst + e, src + e);
  }
}

// The int of table slot e (one slot of T an entry).
template <typename T>
RBD_HD int& slot(T* base, int e) {
  return *reinterpret_cast<int*>(base + e);
}

// 1 / x correctly rounded, the value of T(1) / x, by the card's reciprocal
// rather than its division
RBD_HD float rcp(float x) {
#if defined(__CUDA_ARCH__)
  return __frcp_rn(x);
#else
  return 1.0f / x;
#endif
}

RBD_HD double rcp(double x) {
#if defined(__CUDA_ARCH__)
  return __drcp_rn(x);
#else
  return 1.0 / x;
#endif
}

// Dot products of length len summed in ascending k, s = sum a[k sa]
// b[k sb]: one chain (dot1) or two independent chains of one loop (dot2).
// The operands of DOT_CHUNK terms are loaded before their products, so the
// loads of a chunk are in flight together.
constexpr int DOT_CHUNK = 8;

template <typename T>
RBD_HD T dot1(int len, const T* a, int sa, const T* b, int sb) {
  T x = 0;
  for (int k0 = 0; k0 < len; k0 += DOT_CHUNK) {
    T p[DOT_CHUNK], q[DOT_CHUNK];
#pragma unroll
    for (int k = 0; k < DOT_CHUNK; ++k) {
      if (k0 + k < len) {
        p[k] = a[(k0 + k) * sa];
        q[k] = b[(k0 + k) * sb];
      }
    }
#pragma unroll
    for (int k = 0; k < DOT_CHUNK; ++k)
      if (k0 + k < len) x += p[k] * q[k];
  }
  return x;
}

template <typename T>
RBD_HD void dot2(int len, const T* a0, int sa0, const T* b0, int sb0, const T* a1, int sa1,
                 const T* b1, int sb1, T& s0, T& s1) {
  T x0 = 0, x1 = 0;
  for (int k0 = 0; k0 < len; k0 += DOT_CHUNK) {
    T p[DOT_CHUNK], q[DOT_CHUNK], u[DOT_CHUNK], v[DOT_CHUNK];
#pragma unroll
    for (int k = 0; k < DOT_CHUNK; ++k) {
      if (k0 + k < len) {
        p[k] = a0[(k0 + k) * sa0];
        q[k] = b0[(k0 + k) * sb0];
        u[k] = a1[(k0 + k) * sa1];
        v[k] = b1[(k0 + k) * sb1];
      }
    }
#pragma unroll
    for (int k = 0; k < DOT_CHUNK; ++k) {
      if (k0 + k < len) {
        x0 += p[k] * q[k];
        x1 += u[k] * v[k];
      }
    }
  }
  s0 = x0;
  s1 = x1;
}

// A phase's table entries e = tid, tid + nt, ..., two at a time:
// body(code0, code1, two), the second code the first's again where there is
// no second entry.
template <typename T, class Body>
RBD_HD void pairs(int tid, int nt, int N, T* tab, Body body) {
  for (int e = tid; e < N; e += 2 * nt) {
    const bool two = e + nt < N;
    const int c0 = slot(tab, e), c1 = two ? slot(tab, e + nt) : c0;
    body(c0, c1, two);
  }
}

// The entries (i, j) = (e / c, e mod c) of an r x c matrix for e = tid,
// tid + nt, ...: the first one's given (i0, j0 from before the knot loop),
// the others' divided out.
template <class Body>
RBD_HD void owned(int tid, int nt, int r, int c, int i0, int j0, Body body) {
  if (tid >= r * c) return;
  body(i0, j0);
  for (int e = tid + nt; e < r * c; e += nt) body(e / c, e % c);
}

// The sweep of problem b by thread tid of the block's nt; sm points at
// layout(n, m).VALUES values.  Thread 0 writes ok and thread nt - 1 dV1
// after the last knot.
template <typename T>
RBD_HD void sweep(int tid, int nt, T* sm, int b, const T* A, const T* Bg, const T* lx,
                  const T* lu, const T* lxx, int lxx_sb, int lxx_st, const T* luu, int luu_sb,
                  int luu_st, const T* lux, int lux_sb, int lux_st, const T* lfx,
                  const T* lfxx, const T* reg, T* kout, T* Kout, T* dV1, unsigned char* ok,
                  int H, int n, int m) {
  const Layout L = layout(n, m);
  const int LDP = L.LDP, NCOL = L.NCOL, n1 = n + 1;
  T* V = sm + L.V;
  T* Vx = sm + L.VX;
  T* P = sm + L.P;
  T* QUX = sm + L.QUX;
  T* QU = sm + L.QU;
  T* QUU = sm + L.QUU;
  T* W = sm + L.W;
  T* PIV = sm + L.PIV;
  T* X = sm + L.X;
  T* Z = sm + L.Z;
  T* tab1 = sm + L.TAB1;
  T* tab2 = sm + L.TAB2;
  T* tab4 = sm + L.TAB4;
  const size_t bn = (size_t)b;
  const T rg = reg[b];

  // knot t's inputs into stage buffer t & 1 by cp.async, committed: the
  // seven blocks spread over the block's warps, one warp a block
  const int wl = nt < 32 ? nt : 32, warp = tid / wl, lane = tid - warp * wl, nw = nt / wl;
  auto stage = [&](int t) {
    T* s = sm + (t & 1) * L.STAGE;
    const size_t kt = bn * H + t;
    for (int blk = warp; blk < 7; blk += nw) {
      const T* src;
      int off, len;
      switch (blk) {
        case 0: src = A + kt * n * n, off = L.A, len = n * n; break;
        case 1: src = Bg + kt * n * m, off = L.B, len = n * m; break;
        case 2: src = lxx + (size_t)lxx_sb * bn + (size_t)lxx_st * t, off = L.LXX, len = n * n; break;
        case 3: src = lux + (size_t)lux_sb * bn + (size_t)lux_st * t, off = L.LUX, len = m * n; break;
        case 4: src = luu + (size_t)luu_sb * bn + (size_t)luu_st * t, off = L.LUU, len = m * m; break;
        case 5: src = lx + kt * n, off = L.LX, len = n; break;
        default: src = lu + kt * m, off = L.LU, len = m; break;
      }
      copy_flat(lane, wl, s + off, src, len);
    }
    copy_async_commit();
  };

  // the carry (Vxx = lfxx as it is, Vx = lfx), the last knot's inputs, and
  // the entry tables, each code i << 8 | j: P1's (n + 1) x (n + m) row by
  // row; P2's rows i < n (Qxx, every column) and i = n + r (Qux's n
  // columns, then Quu's columns c >= r at n + c); P4's upper triangle of
  // Vxx row by row, then Vx (j = n); one row of P2's and P4's a thread
  for (int e = tid; e < n * n; e += nt) V[e] = lfxx[bn * n * n + e];
  for (int e = tid; e < n; e += nt) Vx[e] = lfx[bn * n + e];
  stage(H - 1);
  for (int e = tid; e < L.N1; e += nt) slot(tab1, e) = e / (n + m) << 8 | e % (n + m);
  for (int i = tid; i < n + m; i += nt) {
    int off = 0;
    for (int r = 0; r < i; ++r) off += r < n ? n : n + m - (r - n);
    const int j1 = i < n ? n : n + m;
    for (int j = 0; j < j1; ++j)
      if (i < n || j < n || j - n >= i - n) slot(tab2, off++) = i << 8 | j;
  }
  for (int i = tid; i < n; i += nt) {
    int off = 0;
    for (int r = 0; r < i; ++r) off += n - r;
    for (int j = i; j < n; ++j) slot(tab4, off++) = i << 8 | j;
    slot(tab4, n * (n + 1) / 2 + i) = i << 8 | n;
  }
  // this thread's first entry of W (P3's elimination) and of [K | k]
  const int gi = tid / NCOL, gc = tid - gi * NCOL, xr = tid / n1, xc = tid - xr * n1;
  int okacc = 1;
  T dv = T(0);
  copy_async_wait();
  K11_SYNC();

  for (int t = H - 1; t >= 0; --t) {
    const size_t kt = bn * H + t;
    const T* s = sm + (t & 1) * L.STAGE;
    const T* As = s + L.A;
    const T* Bs = s + L.B;
    // column j of [A | B] and its stride
    auto abcol = [&](int j) { return j < n ? As + j : Bs + (j - n); };
    auto abld = [&](int j) { return j < n ? n : m; };
    // knot t-1's inputs land during this knot
    if (t > 0) stage(t - 1);

    // P1: rows i < n of [Vxx; Vx^T] [A | B] into P, row n into [Qx | Qu]
    auto p1 = [&](int i, int j, T acc) {
      if (i < n) {
        P[i * LDP + j] = acc;
      } else if (j < n) {
        P[n * LDP + j] = s[L.LX + j] + acc;
      } else {
        const T q = s[L.LU + j - n] + acc;
        P[n * LDP + j] = q;
        QU[j - n] = q;
        W[(j - n) * NCOL + NCOL - 1] = q;
      }
    };
    pairs(tid, nt, L.N1, tab1, [&](int c0, int c1, bool two) {
      const int i0 = c0 >> 8, j0 = c0 & 255, i1 = c1 >> 8, j1 = c1 & 255;
      if (two) {
        T s0, s1;
        dot2(n, V + i0 * n, 1, abcol(j0), abld(j0), V + i1 * n, 1, abcol(j1), abld(j1), s0, s1);
        p1(i0, j0, s0);
        p1(i1, j1, s1);
      } else {
        p1(i0, j0, dot1(n, V + i0 * n, 1, abcol(j0), abld(j0)));
      }
    });
    K11_SYNC();

    // P2: G = [A | B]^T [P | Pb] over the table's entries
    auto p2 = [&](int i, int j, T acc) {
      if (i < n) {
        V[i * n + j] = s[L.LXX + i * n + j] + acc;
      } else if (j < n) {
        const int r = i - n;
        const T q = s[L.LUX + r * n + j] + acc;
        QUX[r * n + j] = q;
        W[r * NCOL + m + j] = q;
      } else {
        const int r = i - n, c = j - n;
        const T up = s[L.LUU + r * m + c] + acc, lo = s[L.LUU + c * m + r] + acc;
        QUU[r * m + c] = up;
        QUU[c * m + r] = lo;
        W[r * NCOL + c] = r == c ? up + rg : up;
        W[c * NCOL + r] = r == c ? up + rg : lo;
      }
    };
    pairs(tid, nt, L.N2, tab2, [&](int c0, int c1, bool two) {
      const int i0 = c0 >> 8, j0 = c0 & 255, i1 = c1 >> 8, j1 = c1 & 255;
      if (two) {
        T s0, s1;
        dot2(n, abcol(i0), abld(i0), P + j0, LDP, abcol(i1), abld(i1), P + j1, LDP, s0, s1);
        p2(i0, j0, s0);
        p2(i1, j1, s1);
      } else {
        p2(i0, j0, dot1(n, abcol(i0), abld(i0), P + j0, LDP));
      }
    });
    K11_SYNC();

    // P3: (Quu + reg I) X = [Qux | Qu] by Gauss-Jordan on W, by the block,
    // one step a barrier: step j updates every entry (i != j, c > j) from
    // W[i][j], W[j][c] and the pivot W[j][j], each thread its own entries
    // throughout; the pivots go to PIV.  Then [K | k] = -X, NaN for the
    // whole knot unless every pivot was > 0
    for (int j = 0; j < m; ++j) {
      const T d = W[j * NCOL + j];
      const T inv = rcp(d);
      if (tid == 0) PIV[j] = d;
      owned(tid, nt, m, NCOL, gi, gc, [&](int i, int c) {
        if (i != j && c > j) W[i * NCOL + c] -= W[i * NCOL + j] * (W[j * NCOL + c] * inv);
      });
      K11_SYNC();
    }
    int okl = 1;
    for (int j = 0; j < m; ++j)
      if (!(PIV[j] > T(0))) okl = 0;  // false for NaN too
    owned(tid, nt, m, n1, xr, xc, [&](int r, int c) {
      const T x = okl ? -W[r * NCOL + m + c] * rcp(PIV[r]) : nan_value<T>();
      X[r * n1 + c] = x;
      if (c < n) {
        Kout[(kt * m + r) * n + c] = x;
      } else {
        kout[kt * m + r] = x;
      }
    });
    if (tid == 0) okacc &= okl;
    K11_SYNC();
    // Z = Quu [K | k] + [2 Qux | Qu]
    owned(tid, nt, m, n1, xr, xc, [&](int r, int c) {
      Z[r * n1 + c] = dot1(m, QUU + r * m, 1, X + c, n1) + (c < n ? T(2) * QUX[r * n + c] : QU[r]);
    });
    K11_SYNC();

    // P4: Vxx's upper triangle (both halves written) and Vx; dV1 by the
    // last thread
    for (int e = tid; e < L.N4; e += nt) {
      const int code = slot(tab4, e), i = code >> 8, j = code & 255;
      T s1, s2;
      if (j < n) {
        dot2(m, X + i, n1, Z + j, n1, X + j, n1, Z + i, n1, s1, s2);
        const T v = T(0.5) * (V[i * n + j] + V[j * n + i]) + T(0.5) * (s1 + s2);
        V[i * n + j] = v;
        V[j * n + i] = v;
      } else {
        dot2(m, X + i, n1, Z + n, n1, QUX + i, n, X + n, n1, s1, s2);
        Vx[i] = P[n * LDP + i] + (s1 + s2);
      }
    }
    if (tid == nt - 1) {
      T sk = 0;
      for (int r = 0; r < m; ++r) sk += X[r * n1 + n] * QU[r];
      dv += sk;
    }
    copy_async_wait();
    K11_SYNC();
  }
  if (tid == 0) ok[b] = (unsigned char)okacc;
  if (tid == nt - 1) dV1[b] = dv;
}

}  // namespace k11
}  // namespace rbd

#ifdef __CUDACC__
// the most threads a block takes (kernels/_lib.py riccati_fused_geometry
// picks 64-256); at most 128 registers a thread
#define RBD_K11_THREADS 256

template <typename T>
__global__ void __launch_bounds__(RBD_K11_THREADS, 2)
    riccati_fused_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ lx, const T* __restrict__ lu,
                         const T* __restrict__ lxx, int lxx_sb, int lxx_st,
                         const T* __restrict__ luu, int luu_sb, int luu_st,
                         const T* __restrict__ lux, int lux_sb, int lux_st,
                         const T* __restrict__ lfx, const T* __restrict__ lfxx,
                         const T* __restrict__ reg, T* __restrict__ k, T* __restrict__ K,
                         T* __restrict__ dV1, unsigned char* __restrict__ ok, int H, int nx,
                         int nu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  rbd::k11::sweep<T>((int)threadIdx.x, (int)blockDim.x, reinterpret_cast<T*>(smem_raw),
                     blockIdx.x, A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st, lux,
                     lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1, ok, H, nx, nu);
}

// One launch: B problems, one block of nt threads each, smem bytes of
// shared memory a block, which must be the layout's.  Returns a cudaError_t.
template <typename T>
static int launch_riccati_fused(const T* A, const T* Bm, const T* lx, const T* lu,
                                const T* lxx, int lxx_sb, int lxx_st, const T* luu,
                                int luu_sb, int luu_st, const T* lux, int lux_sb, int lux_st,
                                const T* lfx, const T* lfxx, const T* reg, T* k, T* K, T* dV1,
                                unsigned char* ok, int B, int H, int nx, int nu, int nt,
                                int smem, void* stream) {
  if (B <= 0) return 0;
  const size_t need = sizeof(T) * (size_t)rbd::k11::smem_values(nx, nu);
  if (H < 1 || nx < 1 || nx > 16 || nu < 1 || nx + nu > 255 || nt < 32 ||
      nt > RBD_K11_THREADS || nt % 32 != 0 || (size_t)smem != need || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        riccati_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  riccati_fused_kernel<T><<<B, nt, smem, (cudaStream_t)stream>>>(
      A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st, lux, lux_sb, lux_st, lfx, lfxx,
      reg, k, K, dV1, ok, H, nx, nu);
  return (int)cudaGetLastError();
}

#define RBD_RICCATI_FUSED(T, SFX)                                                             \
  int rbd_riccati_fused_##SFX(const T* A, const T* Bm, const T* lx, const T* lu,             \
                              const T* lxx, int lxx_sb, int lxx_st, const T* luu, int luu_sb, \
                              int luu_st, const T* lux, int lux_sb, int lux_st, const T* lfx, \
                              const T* lfxx, const T* reg, T* k, T* K, T* dV1,                \
                              unsigned char* ok, int B, int H, int nx, int nu, int nt,        \
                              int smem, void* stream) {                                       \
    return launch_riccati_fused<T>(A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu, luu_sb, luu_st,   \
                                   lux, lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1, ok, B, H,  \
                                   nx, nu, nt, smem, stream);                                 \
  }

extern "C" {
RBD_RICCATI_FUSED(float, f32)
RBD_RICCATI_FUSED(double, f64)
}
#endif
