// One forward-dynamics step (ABA, then semi-implicit Euler) for ONE state,
// run cooperatively by a team of NL lanes (NL = 8, 16 or 32) of one warp,
// with the per-body state in the team's shared memory: rbdtpu's aba_lane
// step, with the rpy root's six-DoF block and optional world-frame
// wrenches; fd_step.cu (K1), feedback_rollout.cu (K2), linearize.cu (K3)
// and rollout_multi.cu (K5) run it, one team per state, trajectory or knot.
// The team's RNEA (team_rnea) is K10 (rnea.cu); the M^-1 + RNEA step of K5's
// minv route and of K6 (fd_step_minv.cu) runs its bias (team_rnea_bias) and
// then the step's articulated sweeps alone on u - c (MINV: zero velocity,
// no gravity, no wrenches), as rbdtpu's _step_lane does, or (K6's dense
// route) those sweeps' factorisation and then M^-1 one column a lane
// (team_minv_columns, the walk of K3's M^-1 columns).
//
// Why: one thread per state runs the ~10k operations of an arm7 step (and
// ~10x that on the humanoid) as one dependent chain, with its per-body
// arrays indexed by loop variables and therefore in local memory.  Here
//   - the joint transforms (one sin/cos pair a body), the lower-left blocks
//     of the dense transforms, the bias terms (v x vJ, v x* I v) and the
//     inertia copies take one lane a body (or a value);
//   - the root->leaf velocity and acceleration recursions put one lane on
//     each of a 6-vector's components, body after body, and load the next
//     body's transform row, parent and S before the barrier;
//   - in the leaf->root sweep one lane a component forms U = IA S and the
//     partial sums of d = S.U and S.pA, which every lane then adds in the
//     same order; the 36 entries of (IA - U U^T / d) X and the six of the
//     bias force take one lane each, as do the 21 entries of the symmetric
//     X^T (IA - U U^T / d) X and the six of X^T pa.  Each of those is a
//     6-term dot product with a column of the dense X read through the
//     same strided view as a force vector (Col), so the lanes of a step run
//     the same instructions;
// and every array lives in shared memory, so ptxas gives the kernels no
// per-body stack.  A lane carries no value across a team barrier except
// through shared memory (or values every lane computes alike).  Reductions
// are partial sums in shared memory read back in a fixed order, not
// shuffles: the barrier that publishes U is needed anyway, and reading six
// partials after it costs less than a five-step butterfly a sum (measured
// on an H100, PERF.md §6).
//
// Bound: the step is latency- and issue-bound, not by bytes or operations:
// at 32 lanes most phases keep six lanes busy, so instructions per body
// decide its time; the kernels run one warp a block and as many teams per
// SM as shared memory allows.
//
// No tensor cores: the products are 6x6 per state with a serial dependence
// along the tree, and float32 results stay float32 in their arithmetic
// (TF32 would keep ten bits of mantissa).
//
// The rpy root's block (chol6, chol6_solve) and the wrenches' world->body
// chain run on lane 0 as real calls (RBD_HD_CALL): nvcc 12.9 miscompiled
// inlined root bodies twice (the one-thread ABA's root block, and
// floating_xc in rbd_common.cuh).
//
// The code compiles for the host too: a host harness may define
// RBD_TEAM_HOST_SYNC() as a barrier of NL threads and run them as one team
// (the copies then happen at once).
#pragma once

#include "rbd_common.cuh"

namespace rbd {

// A team of NL lanes: this lane's index and the team's lanes in its warp.
template <int NL>
struct Team {
  int lane;
  unsigned mask;

  RBD_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp(mask);
#elif defined(RBD_TEAM_HOST_SYNC)
    RBD_TEAM_HOST_SYNC();
#endif
  }
};

// Asynchronous global -> shared copies of one value (cp.async, 4 or 8
// bytes), the commit of this lane's copies, and the wait for all of them;
// the host copies at once.
template <typename T>
RBD_HD void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

RBD_HD void copy_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

RBD_HD void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Asynchronous copies of BYTES bytes (4, 8 or 16) global -> shared (the
// Riccati sweeps' staging); the host copies at once.
template <int BYTES>
RBD_HD void copy_async_bytes(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
  }
#else
  const char* s = static_cast<const char*>(src);
  char* t = static_cast<char*>(dst);
  for (int k = 0; k < BYTES; ++k) t[k] = s[k];
#endif
}

// The team step's shared-memory layout, in values of T, for size class D:
// compact transforms X (and, with W, the wrenches' chain Xa), the lower-left
// blocks BL of the dense X (row k = r x row k of E), velocities v (reused
// for the accelerations), bias c, articulated bias pA, U, articulated
// inertias IA, the motion subspaces S, 1 / d, u and the parent per body;
// with LEV the bodies in order of tree level, the level count and each
// level's start (copied from the model's int table); one body's
// (IA - U U^T / d) X and bias force; the partial sums of the leaf->root
// sweep's two reductions and of U.a (each body's with LEV, two buffers
// otherwise); qdd; with KEEPV the accelerations A apart from v, which the
// step otherwise overwrites (linearize.cu reads both).  With XIA the
// wrenches' chain takes IA's values instead of its own (XA_IN_IA): the step
// then copies the inertias after the wrenches are applied (feedback_team.cuh's
// wrench kernels, whose teams it keeps at the wrench-free kernels' size).
// kernels/_lib.py team_values and linearize_values mirror these counts.
template <class D, bool W, bool LEV, bool KEEPV = false, bool XIA = false>
struct TeamLayout {
  static constexpr bool WRENCH = W, LEVELS = LEV, XA_IN_IA = W && XIA;
  static constexpr int NB = D::NB, NV = D::NV;
  static constexpr int X = 0, XAO = X + 12 * NB, BL = XAO + (W && !XIA ? 12 * NB : 0),
                       V = BL + 9 * NB,
                       C = V + 6 * NB, PA = C + 6 * NB, U = PA + 6 * NB, IA = U + 6 * NB,
                       SP = IA + 36 * NB, INVD = SP + 6 * NB, UB = INVD + NB, PAR = UB + NB,
                       ORD = PAR + NB, AD = ORD + (LEV ? 2 * NB + 2 : 0), PAS = AD + 36,
                       PART = PAS + 6, PROD = PART + 12, QDD = PROD + (LEV ? 6 * NB : 12),
                       A = KEEPV ? QDD + NV : V, VALUES = QDD + NV + (KEEPV ? 6 * NB : 0),
                       XA = XA_IN_IA ? IA : XAO;
};

// Entry k (row kr = k mod 3 of E, lo = k < 3) of X m for a motion vector
// m = [a; b] (xc_mv): [E a; E (b - r x a)], from that row of E and r.
template <typename T>
RBD_HD T xc_mv_row(const T* e, const T* r, const T* m, bool lo) {
  if (lo) return e[0] * m[0] + e[1] * m[1] + e[2] * m[2];
  const T t0 = m[3] - (r[1] * m[2] - r[2] * m[1]);
  const T t1 = m[4] - (r[2] * m[0] - r[0] * m[2]);
  const T t2 = m[5] - (r[0] * m[1] - r[1] * m[0]);
  return e[0] * t0 + e[1] * t1 + e[2] * t2;
}

// Column c of a body's dense 6x6 X = [[E, 0], [BL, E]], read as
// entries m < 3 from lo[3 m] (zero when c >= 3) and m >= 3 from
// hi[3 (m - 3)]: lo = E + c, hi = BL + c for c < 3 and E + c - 3 otherwise.
// A force vector f read through the same view is lo = f, hi = f + 3 with
// stride 1 (``vector_col``), so the products by columns of X and by the
// bias force run the same instructions in every lane.
template <typename T>
struct Col {
  const T* lo;
  const T* hi;
  int stride;
  bool zlo;
  RBD_HD T operator[](int m) const {
    return m < 3 ? (zlo ? T(0) : lo[stride * m]) : hi[stride * (m - 3)];
  }
};

template <typename T>
RBD_HD Col<T> dense_col(const Xc<T>& X, const T* BL, int c) {
  return c < 3 ? Col<T>{X.E + c, BL + c, 3, false} : Col<T>{X.E + c, X.E + c - 3, 3, true};
}

template <typename T>
RBD_HD Col<T> vector_col(const T* f) {
  return Col<T>{f, f + 3, 1, false};
}

// Row and column of entry e < 21 of a symmetric 6x6's upper triangle, row
// by row, three bits an entry.
constexpr unsigned long long TRI_ROW = 0x591b692449240000ull, TRI_COL = 0x5b2c76356346c688ull;

template <typename T>
RBD_HD T sum6(const T* p) {
  return ((p[0] + p[1]) + (p[2] + p[3])) + (p[4] + p[5]);
}

// Entry k of v x m (cross_motion) for motion vectors v = [w; l], m.
template <typename T>
RBD_HD T cross_motion_row(const T* v, const T* m, int k) {
  const int j = k < 3 ? k : k - 3, j1 = j == 2 ? 0 : j + 1, j2 = j == 0 ? 2 : j - 1;
  const T ang = v[j1] * m[j2] - v[j2] * m[j1];
  if (k < 3) return ang;
  return (v[3 + j1] * m[j2] - v[3 + j2] * m[j1]) + (v[j1] * m[3 + j2] - v[j2] * m[3 + j1]);
}

// Entry k of v x* f (cross_force) for a motion vector v = [w; l] and a
// force vector f = [n; fl].
template <typename T>
RBD_HD T cross_force_row(const T* v, const T* f, int k) {
  const int j = k < 3 ? k : k - 3, j1 = j == 2 ? 0 : j + 1, j2 = j == 0 ? 2 : j - 1;
  const T lin = v[j1] * f[3 + j2] - v[j2] * f[3 + j1];
  if (k >= 3) return lin;
  return (v[j1] * f[j2] - v[j2] * f[j1]) + (v[3 + j1] * f[3 + j2] - v[3 + j2] * f[3 + j1]);
}

// Entry k of X^T f (xc_mtv) for X = (E, r) and a force vector f = [n; fl]:
// [E^T n + r x t; t] with t = E^T fl.
template <typename T>
RBD_HD T xc_mtv_row(const T* E, const T* r, const T* f, int k) {
  const int j = k < 3 ? k : k - 3;
  const T tj = E[j] * f[3] + E[3 + j] * f[4] + E[6 + j] * f[5];
  if (k >= 3) return tj;
  const int j1 = j == 2 ? 0 : j + 1, j2 = j == 0 ? 2 : j - 1;
  const T t1 = E[j1] * f[3] + E[3 + j1] * f[4] + E[6 + j1] * f[5];
  const T t2 = E[j2] * f[3] + E[3 + j2] * f[4] + E[6 + j2] * f[5];
  return (E[j] * f[0] + E[3 + j] * f[1] + E[6 + j] * f[2]) + (r[j1] * t2 - r[j2] * t1);
}

// The world->body chain of the wrenches (rbdtpu dynamics/rnea.py
// apply_external_forces): Xa[i] = X[i] Xa[parent], composed compactly as
// plux(E1, r1) plux(E2, r2) = plux(E1 E2, r2 + E2^T r1).
template <typename T, class D>
RBD_HD_CALL void fext_chain(const Model<T, D>& m, const Xc<T>* X, Xc<T>* Xa) {
  for (int i = 0; i < m.nb; ++i) {
    const int p = m.parent(i);
    if (p < 0) {
      Xa[i] = X[i];
    } else {
      T t[3];
      mm3(X[i].E, Xa[p].E, Xa[i].E);
      mtv3(Xa[p].E, X[i].r, t);
      for (int k = 0; k < 3; ++k) Xa[i].r[k] = Xa[p].r[k] + t[k];
    }
  }
}

// One link of that chain: Xa = X Xap (Xap null at a root: Xa = X).  The
// wrench kernels of the line search (feedback_team.cuh) compose a tree's
// links level by level, one lane a body of the level, each a real call
// like fext_chain.
template <typename T>
RBD_HD_CALL void fext_link(const Xc<T>& X, const Xc<T>* Xap, Xc<T>& Xa) {
  if (Xap == nullptr) {
    Xa = X;
    return;
  }
  T t[3];
  mm3(X.E, Xap->E, Xa.E);
  mtv3(Xap->E, X.r, t);
  for (int k = 0; k < 3; ++k) Xa.r[k] = Xap->r[k] + t[k];
}

// The rpy root's accelerations (rbdtpu aba's root block): a0 = X0 ag, then
// IA0 qdd = tau - pA0 - IA0^T a0 by chol6 (NaN when IA0 is not positive
// definite), a0 += qdd.
template <typename T>
RBD_HD_CALL void root_accel(const Xc<T>& X0, const T* IA0, const T* pA0, const T* tau,
                            T gravity, T* a0, T* qdd) {
  T ag[6], a[6], L[36], rhs[6];
  gravity_accel(gravity, ag);
  xc_mv(X0, ag, a);
  for (int r = 0; r < 6; ++r) {
    T s = 0;
    for (int k = 0; k < 6; ++k) s += IA0[6 * k + r] * a[k];
    rhs[r] = tau[r] - pA0[r] - s;
  }
  chol6(IA0, L);
  chol6_solve(L, rhs, qdd);
  for (int k = 0; k < 6; ++k) a0[k] = a[k] + qdd[k];
}

// The joint transforms X, the lower-left blocks BL of the dense X, the
// motion subspaces and the parents of the state x = [q; qd] into the
// scratch ``s`` of layout L, one lane a body (no barrier).
template <int NL, class L, typename T, class D>
RBD_HD void team_transforms(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x) {
  Xc<T>* X = reinterpret_cast<Xc<T>*>(s + L::X);
  T* BL = s + L::BL;
  T* Sp = s + L::SP;
  int* par = reinterpret_cast<int*>(s + L::PAR);
  for (int i = tm.lane; i < m.nb; i += NL) {
    if (m.root6(i)) {
      floating_xc(m, x, X[0]);
    } else {
      joint_xc(m, i, x[m.vi(i)], X[i]);
    }
    for (int k = 0; k < 6; ++k) Sp[6 * i + k] = m.body(i)[OFF_S + k];
    par[i] = m.parent(i);
    for (int k = 0; k < 3; ++k) cross3(X[i].r, X[i].E + 3 * k, BL + 9 * i + 3 * k);
  }
}

// One ABA + semi-implicit Euler step of the state x = [q; qd] (2 nv values
// in shared memory) under the joint forces tau (nv), by the team ``tm``,
// with the wrenches fext (nb, 6; global or shared memory) when FEXT.  ``s``
// is the team's scratch of layout L (a TeamLayout<D, W, LEV>: W holds the
// wrenches' chain, LEV the level order).  LV walks the root->leaf
// recursions level by level (the layout must hold the level order), else
// body by body; with LV and a layout whose wrench chain sits in IA's
// values (the line search's) the chain too is composed level by level.
// MINV runs the sweeps of qdd = M^-1 tau instead (rbdtpu's
// aba_lane at qd = 0 and gravity 0, no wrenches): it takes the transforms
// team_rnea left in ``s``, skips the velocity recursion and the bias terms
// (c = pA = 0) and ignores ``gravity`` (the rpy root's block then solves
// with a0 = 0), while Euler still integrates the real qd of x.  FACTOR
// (with MINV) stops after the leaf->root sweep, leaving the articulated
// inertias (the rpy root's IA[0] complete), U and 1 / d for a dense M^-1;
// it writes no qdd and no state.  x' is written to xs (shared; may be x
// itself) and to xg (global) where they are not null.  Every lane returns
// after the last write; a caller that reads xs must sync first.
template <int NL, bool FEXT, bool LV, class L, bool MINV = false, bool FACTOR = false, typename T,
          class D>
RBD_HD void team_fd_step(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x,
                         const T* tau, T dt, T gravity, const T* fext, T* xs, T* xg) {
  static_assert(NL >= 8 && NL <= 32 && (NL & (NL - 1)) == 0, "a team is 8, 16 or 32 lanes");
  static_assert(L::NB == D::NB && (L::WRENCH || !FEXT) && (L::LEVELS || !LV),
                "the layout holds the step");
  static_assert(!MINV || (!FEXT && !LV), "MINV: no wrenches, by bodies");
  static_assert(MINV || !FACTOR, "FACTOR: the M^-1 sweeps");
  if constexpr (MINV) gravity = T(0);
  const int nb = m.nb, n = m.nv(), lane = tm.lane;
  Xc<T>* X = reinterpret_cast<Xc<T>*>(s + L::X);
  T(*v)[6] = reinterpret_cast<T(*)[6]>(s + L::V);
  T(*c)[6] = reinterpret_cast<T(*)[6]>(s + L::C);
  T(*pA)[6] = reinterpret_cast<T(*)[6]>(s + L::PA);
  T(*U)[6] = reinterpret_cast<T(*)[6]>(s + L::U);
  T* IA = s + L::IA;
  T* BL = s + L::BL;
  T* Sp = s + L::SP;
  T* invd = s + L::INVD;
  T* ub = s + L::UB;
  int* par = reinterpret_cast<int*>(s + L::PAR);
  T* AD = s + L::AD;
  T* pa = s + L::PAS;
  T* part = s + L::PART;
  T* qdd = s + L::QDD;
  int* ord = reinterpret_cast<int*>(s + L::ORD);
  const T* qd = x + n;

  // joint transforms, motion subspaces and parents, one lane a body
  if constexpr (!MINV) team_transforms<NL, L>(tm, m, s, x);
  if constexpr (LV) {
    const int* lv = m.itab + 2 * nb;  // order, level count, level starts
    for (int e = lane; e < 2 * nb + 2; e += NL) ord[e] = lv[e];
  }
  tm.sync();
  // velocities root -> leaf, one lane a component: with LV level by level,
  // a group of 8 lanes a body of the level (the model's level order,
  // _lib.model_tables); otherwise body by body, lane k < 6 loading the next
  // body's row k mod 3 of E, r, parent and S[k] before the barrier
  const int* loff = ord + nb + 1;
  const int levels = LV ? ord[nb] : 0, grp = lane / 8, kl = lane % 8;
  constexpr int GROUPS = NL / 8;
  if constexpr (MINV) {
    // qd = 0: no velocities
  } else if constexpr (LV) {
    const int k = kl, kr = k < 3 ? k : k - 3;
    for (int l = 0; l < levels; ++l) {
      for (int b = loff[l] + grp; b < loff[l + 1]; b += GROUPS) {
        const int i = ord[b], p = par[i];
        if (k < 6) {
          const T vJ = m.root6(i) ? qd[k] : Sp[6 * i + k] * qd[m.vi(i)];
          v[i][k] = p < 0 ? vJ : xc_mv_row(X[i].E + 3 * kr, X[i].r, v[p], k < 3) + vJ;
        }
      }
      tm.sync();
    }
  } else {
    const int k = lane < 6 ? lane : 0, kr = k < 3 ? k : k - 3;
    T e[3], r[3], sk = Sp[k];
    int p = par[0];
    for (int j = 0; j < 3; ++j) {
      e[j] = X[0].E[3 * kr + j];
      r[j] = X[0].r[j];
    }
    for (int i = 0; i < nb; ++i) {
      T en[3], rn[3], skn = sk;
      int pn = p;
      if (i + 1 < nb) {
        pn = par[i + 1];
        skn = Sp[6 * (i + 1) + k];
        for (int j = 0; j < 3; ++j) {
          en[j] = X[i + 1].E[3 * kr + j];
          rn[j] = X[i + 1].r[j];
        }
      }
      if (lane < 6) {
        const T vJ = m.root6(i) ? qd[k] : sk * qd[m.vi(i)];
        v[i][k] = p < 0 ? vJ : xc_mv_row(e, r, v[p], k < 3) + vJ;
      }
      tm.sync();
      p = pn;
      sk = skn;
      for (int j = 0; j < 3; ++j) {
        e[j] = en[j];
        r[j] = rn[j];
      }
    }
  }
  // bias terms one lane a body (zero with MINV); the inertias one lane a
  // value
  for (int i = lane; i < nb; i += NL) {
    if constexpr (MINV) {
      for (int k = 0; k < 6; ++k) c[i][k] = pA[i][k] = T(0);
      continue;
    }
    T vJ[6], Iv[6];
    for (int k = 0; k < 6; ++k) vJ[k] = m.root6(i) ? qd[k] : Sp[6 * i + k] * qd[m.vi(i)];
    if (par[i] < 0) {
      for (int k = 0; k < 6; ++k) c[i][k] = T(0);
    } else {
      cross_motion(v[i], vJ, c[i]);
    }
    matvec6(m.body(i) + OFF_I, v[i], Iv);
    cross_force(v[i], Iv, pA[i]);
  }
  if constexpr (!L::XA_IN_IA)
    for (int e = lane; e < nb * 36; e += NL) IA[e] = m.body(e / 36)[OFF_I + e % 36];
  tm.sync();
  if constexpr (FEXT) {
    Xc<T>* Xa = reinterpret_cast<Xc<T>*>(s + L::XA);
    if constexpr (LV && L::XA_IN_IA) {  // the line search's: level by level
      for (int l = 0; l < levels; ++l) {
        for (int b = loff[l] + lane; b < loff[l + 1]; b += NL) {
          const int i = ord[b], p = par[i];
          fext_link(X[i], p < 0 ? static_cast<const Xc<T>*>(nullptr) : Xa + p, Xa[i]);
        }
        tm.sync();
      }
    } else {
      if (lane == 0) fext_chain(m, X, Xa);
      tm.sync();
    }
    for (int i = lane; i < nb; i += NL) {
      const T* w = fext + 6 * i;
      T rxf[3], nr[3], o[6];
      cross3(Xa[i].r, w + 3, rxf);
      for (int k = 0; k < 3; ++k) nr[k] = w[k] - rxf[k];
      mv3(Xa[i].E, nr, o);
      mv3(Xa[i].E, w + 3, o + 3);
      for (int k = 0; k < 6; ++k) pA[i][k] -= o[k];
    }
    tm.sync();
  }
  if constexpr (L::XA_IN_IA) {  // the chain is spent: IA's values are free
    for (int e = lane; e < nb * 36; e += NL) IA[e] = m.body(e / 36)[OFF_I + e % 36];
    tm.sync();
  }
  // articulated inertias leaf -> root: U = IA S and the partial sums of
  // d = S.U and S.pA one lane a component; then every lane sums them in
  // the same order.  The body's S and U sit in every lane's registers.
  for (int i = nb - 1; i >= (D::FB ? 1 : 0); --i) {
    const T* Ii = IA + 36 * i;
    const int p = par[i];
    T Si[6];
    for (int k = 0; k < 6; ++k) Si[k] = Sp[6 * i + k];
    if (lane < 6) {
      T u_k = 0;
      for (int j = 0; j < 6; ++j) u_k += Ii[6 * lane + j] * Si[j];
      U[i][lane] = u_k;
      part[lane] = Sp[6 * i + lane] * u_k;
      part[6 + lane] = Sp[6 * i + lane] * pA[i][lane];
    }
    tm.sync();
    T Ui[6];
    for (int k = 0; k < 6; ++k) Ui[k] = U[i][k];
    const T inv = T(1) / sum6(part), ui = tau[m.vi(i)] - sum6(part + 6);
    if (lane == 0) {
      invd[i] = inv;
      ub[i] = ui;
    }
    if (p < 0) {  // a fixed-base root: no parent to accumulate into
      tm.sync();
      continue;
    }
    const T ud = ui * inv;
    // AD = (IA - U U^T / d) X one lane an entry; pa = pA + (IA - U U^T / d) c
    // + U u / d one lane a component
    for (int e = lane; e < 42; e += NL) {
      const bool ad = e < 36;
      const int r = ad ? e / 6 : e - 36;
      const Col<T> col = ad ? dense_col(X[i], BL + 9 * i, e - 6 * r) : vector_col(c[i]);
      const T ur = U[i][r] * inv;
      const T* row = Ii + 6 * r;
      T acc = 0;
      for (int k = 0; k < 6; ++k) acc += (row[k] - ur * Ui[k]) * col[k];
      if (ad) {
        AD[e] = acc;
      } else {
        pa[r] = pA[i][r] + acc + U[i][r] * ud;
      }
    }
    tm.sync();
    // IA[p] += X^T AD (symmetric: 21 entries) and pA[p] += X^T pa, one lane
    // an entry
    T* Ip = IA + 36 * p;
    for (int e = lane; e < 27; e += NL) {
      const bool ia = e < 21;
      const int r = ia ? (int)((TRI_ROW >> (3 * e)) & 7) : e - 21,
                j = ia ? (int)((TRI_COL >> (3 * e)) & 7) : 0;
      const Col<T> xr = dense_col(X[i], BL + 9 * i, r);
      const T* src = ia ? AD + j : pa;
      const int st = ia ? 6 : 1;
      T acc = 0;
      for (int k = 0; k < 6; ++k) acc += xr[k] * src[st * k];
      if (ia) {
        Ip[6 * r + j] += acc;
        if (j != r) Ip[6 * j + r] += acc;
      } else {
        pA[p][r] += acc;
      }
    }
    tm.sync();
  }
  if constexpr (FACTOR) return;
  // accelerations root -> leaf in A (v's storage unless the layout keeps
  // v): a[i] holds X a[p] + c before its own S qdd, which the children add.
  // With LV level by level as the velocities, the children summing the
  // parent's partial sums of U.a (in the same order in every lane, or the
  // group's own qdd kept from the level before); otherwise body by body,
  // the partial sums alternating between two buffers so that one barrier a
  // body separates their writes from every lane's reads
  T(*a)[6] = reinterpret_cast<T(*)[6]>(s + L::A);
  T* pr = s + L::PROD;
  if constexpr (D::FB) {
    if (lane == 0) root_accel(X[0], IA, pA[0], tau, gravity, a[0], qdd);
    tm.sync();
  }
  if constexpr (LV) {
    const int k = kl, kr = k < 3 ? k : k - 3;
    int mine = -1;  // the group's last body, whose qdd its lanes hold
    T qmine = 0;
    for (int l = D::FB ? 1 : 0; l < levels; ++l) {
      int last = -1;
      for (int b = loff[l] + grp; b < loff[l + 1]; b += GROUPS) {
        const int i = ord[b], p = par[i];
        last = i;
        if (k < 6) {
          T ap[6];
          if (p < 0) {
            gravity_accel(gravity, ap);
          } else if (D::FB && p == 0) {  // the root's block is final
            for (int j = 0; j < 6; ++j) ap[j] = a[0][j];
          } else {
            const T qp = p == mine ? qmine : (ub[p] - sum6(pr + 6 * p)) * invd[p];
            for (int j = 0; j < 6; ++j) ap[j] = a[p][j] + Sp[6 * p + j] * qp;
          }
          const T ak = xc_mv_row(X[i].E + 3 * kr, X[i].r, ap, k < 3) + c[i][k];
          a[i][k] = ak;
          pr[6 * i + k] = U[i][k] * ak;
        }
      }
      tm.sync();
      if (last >= 0) {
        mine = last;
        qmine = (ub[last] - sum6(pr + 6 * last)) * invd[last];
      }
    }
    for (int i = lane; i < nb; i += NL)
      if (!m.root6(i)) qdd[m.vi(i)] = (ub[i] - sum6(pr + 6 * i)) * invd[i];
  } else {
    const int i0 = D::FB ? 1 : 0;
    T qprev = 0;  // qdd of body i - 1, in every lane
    const int k = lane < 6 ? lane : 0, kr = k < 3 ? k : k - 3;
    T e[3], r[3], ck = 0, uk = 0;
    int p = 0;
    auto load = [&](int i, T* e_, T* r_, T& c_, T& u_, int& p_) {
      p_ = par[i];
      c_ = c[i][k];
      u_ = U[i][k];
      for (int j = 0; j < 3; ++j) {
        e_[j] = X[i].E[3 * kr + j];
        r_[j] = X[i].r[j];
      }
    };
    if (i0 < nb) load(i0, e, r, ck, uk, p);
    for (int i = i0; i < nb; ++i) {
      T en[3], rn[3], cn = ck, un = uk;
      int pn = p;
      if (i + 1 < nb) load(i + 1, en, rn, cn, un, pn);
      T* pri = pr + 6 * (i & 1);
      if (lane < 6) {
        T ap[6];
        if (p < 0) {
          gravity_accel(gravity, ap);
        } else if (D::FB && p == 0) {  // the root's block is final
          for (int j = 0; j < 6; ++j) ap[j] = a[0][j];
        } else {
          const T qp = p == i - 1 ? qprev : qdd[m.vi(p)];
          for (int j = 0; j < 6; ++j) ap[j] = a[p][j] + Sp[6 * p + j] * qp;
        }
        const T ak = xc_mv_row(e, r, ap, k < 3) + ck;
        a[i][k] = ak;
        pri[k] = uk * ak;
      }
      tm.sync();
      qprev = (ub[i] - sum6(pri)) * invd[i];
      if (lane == 0) qdd[m.vi(i)] = qprev;
      p = pn;
      ck = cn;
      uk = un;
      for (int j = 0; j < 3; ++j) {
        e[j] = en[j];
        r[j] = rn[j];
      }
    }
  }
  tm.sync();
  // semi-implicit Euler, one lane a coordinate
  for (int k = lane; k < n; k += NL) {
    const T qdn = x[n + k] + dt * qdd[k], qn = x[k] + dt * qdn;
    if (xg != nullptr) {
      xg[k] = qn;
      xg[n + k] = qdn;
    }
    if (xs != nullptr) {
      xs[k] = qn;
      xs[n + k] = qdn;
    }
  }
}

// RNEA (rbdtpu dynamics/rnea.py; kernels/fused.py rnea_lane) of the state
// x = [q; qd] (shared) at the joint accelerations qdd (nv values, shared)
// with QDD, at zero without, with gravity and, with FEXT, the world-frame
// wrenches fext (nb, 6), by the team ``tm``: tau = S^T f, the rpy root's
// six rows f_0 (S = I).  With BIAS it writes out = tau_in - tau (K5's and
// K6's u - c, rbdtpu _step_lane's route "minv"), otherwise out = tau (K10);
// out has nv values (shared or global).  In the scratch ``s`` of layout L
// it leaves the transforms, BL, S and parents, which team_fd_step<...,
// MINV> then takes, and uses v, c, U and pA as v, a, I v and the body
// forces f:
//   - the root->leaf recursions one lane a component, the velocities
//     v_i = X_i v_p + S_i qd_i a body ahead of the accelerations
//     a_i = X_i a_p + v_i x S_i qd_i (+ S_i qdd_i) (a_p = gravity at the
//     root; the rpy root's joint velocity and acceleration are qd[0:6] and
//     qdd[0:6]), and with FEXT the wrenches' chain X_a,i = X_i X_a,p one
//     lane an entry beside the velocities, so one barrier a body serves all
//     three;
//   - I v, then f_i = I a_i + v_i x* I v_i - X_a,i^-T fext_i, one lane a
//     value;
//   - the leaf->root sum f_p += X_i^T f_i one lane a component;
//   - the rows of tau one lane a row.
// Every lane returns after its last write; team_fd_step's first barrier
// orders them before its own.
template <int NL, bool FEXT, bool QDD, bool BIAS, class L, typename T, class D>
RBD_HD void team_rnea(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x, const T* qdd,
                      const T* tau, T gravity, const T* fext, T* out) {
  static_assert(L::NB == D::NB && (L::WRENCH || !FEXT), "the layout holds the RNEA");
  const int nb = m.nb, lane = tm.lane;
  const T* qd = x + m.nv();
  const Xc<T>* X = reinterpret_cast<const Xc<T>*>(s + L::X);
  const T* Sp = s + L::SP;
  const int* par = reinterpret_cast<const int*>(s + L::PAR);
  T(*v)[6] = reinterpret_cast<T(*)[6]>(s + L::V);
  T(*a)[6] = reinterpret_cast<T(*)[6]>(s + L::C);
  T(*Iv)[6] = reinterpret_cast<T(*)[6]>(s + L::U);
  T(*f)[6] = reinterpret_cast<T(*)[6]>(s + L::PA);
  Xc<T>* Xa = reinterpret_cast<Xc<T>*>(s + L::XA);
  team_transforms<NL, L>(tm, m, s, x);
  tm.sync();
  T ag[6];
  gravity_accel(gravity, ag);
  // step i: v of body i (entries e < 6), a of body i - 1 (6 <= e < 12),
  // with FEXT X_a of body i (12 <= e < 24: E_a's nine entries, r_a's three)
  for (int i = 0; i <= nb; ++i) {
    for (int e = lane; e < (FEXT ? 24 : 12); e += NL) {
      if (e >= 12) {
        if (i == nb) continue;
        const int p = par[i], x = e - 12;
        if (x < 9) {  // E_a = E_i E_a,p
          const int r = x / 3, c = x - 3 * r;
          Xa[i].E[x] = p < 0 ? X[i].E[x]
                             : X[i].E[3 * r] * Xa[p].E[c] + X[i].E[3 * r + 1] * Xa[p].E[3 + c] +
                                   X[i].E[3 * r + 2] * Xa[p].E[6 + c];
        } else {  // r_a = r_a,p + E_a,p^T r_i
          const int c = x - 9;
          Xa[i].r[c] = p < 0 ? X[i].r[c]
                             : Xa[p].r[c] + (Xa[p].E[c] * X[i].r[0] + Xa[p].E[3 + c] * X[i].r[1] +
                                             Xa[p].E[6 + c] * X[i].r[2]);
        }
        continue;
      }
      const int j = e < 6 ? i : i - 1, k = e < 6 ? e : e - 6, kr = k < 3 ? k : k - 3;
      if (j < 0 || j >= nb) continue;
      const int p = par[j];
      const T* Sj = Sp + 6 * j;
      const T* src = e < 6 ? (p < 0 ? nullptr : v[p]) : (p < 0 ? ag : a[p]);
      const T xm = src == nullptr ? T(0) : xc_mv_row(X[j].E + 3 * kr, X[j].r, src, k < 3);
      // qd[vi(j)] stays inside each branch: hoisted above them it moved
      // K5's registers (on a fixed-base tree root6 is false, vi(j) = j)
      if (e < 6) {
        v[j][k] = xm + (m.root6(j) ? qd[k] : Sj[k] * qd[m.vi(j)]);
      } else {
        T vJ[6];
        for (int r = 0; r < 6; ++r) vJ[r] = m.root6(j) ? qd[r] : Sj[r] * qd[m.vi(j)];
        T ak = xm + cross_motion_row(v[j], vJ, k);
        if constexpr (QDD) ak += m.root6(j) ? qdd[k] : Sj[k] * qdd[m.vi(j)];
        a[j][k] = ak;
      }
    }
    tm.sync();
  }
  for (int e = lane; e < 6 * nb; e += NL) {
    const int i = e / 6, k = e - 6 * i;
    const T* I = m.body(i) + OFF_I + 6 * k;
    T acc = 0;
    for (int r = 0; r < 6; ++r) acc += I[r] * v[i][r];
    Iv[i][k] = acc;
  }
  tm.sync();
  for (int e = lane; e < 6 * nb; e += NL) {
    const int i = e / 6, k = e - 6 * i;
    const T* I = m.body(i) + OFF_I + 6 * k;
    T acc = 0;
    for (int r = 0; r < 6; ++r) acc += I[r] * a[i][r];
    acc += cross_force_row(v[i], Iv[i], k);
    if constexpr (FEXT) {
      // X_a^-T [n; fl] = [E (n - r x fl); E fl] for X_a = (E, r)
      const Xc<T>& Xi = Xa[i];
      const T* w = fext + 6 * i;
      const int kr = k < 3 ? k : k - 3;
      T src[3];
      if (k < 3) {
        T rxf[3];
        cross3(Xi.r, w + 3, rxf);
        for (int r = 0; r < 3; ++r) src[r] = w[r] - rxf[r];
      } else {
        for (int r = 0; r < 3; ++r) src[r] = w[3 + r];
      }
      acc -= Xi.E[3 * kr] * src[0] + Xi.E[3 * kr + 1] * src[1] + Xi.E[3 * kr + 2] * src[2];
    }
    f[i][k] = acc;
  }
  tm.sync();
  for (int i = nb - 1; i >= 0; --i) {
    const int p = par[i];
    if (p < 0) continue;
    if (lane < 6) f[p][lane] += xc_mtv_row(X[i].E, X[i].r, f[i], lane);
    tm.sync();
  }
  if constexpr (D::FB) {
    for (int r = lane; r < m.nv(); r += NL) {
      const int i = r < 6 ? 0 : r - 5;
      const T t = r < 6 ? f[0][r] : dot6(Sp + 6 * i, f[i]);
      out[r] = BIAS ? tau[r] - t : t;
    }
  } else if constexpr (BIAS) {
    for (int i = lane; i < nb; i += NL) out[i] = tau[i] - dot6(Sp + 6 * i, f[i]);
  } else {
    for (int i = lane; i < nb; i += NL) out[i] = dot6(Sp + 6 * i, f[i]);
  }
}

// The most tree levels the column walks of team_minv_columns and K3's
// derivative columns take per size class: one slot a level
// (kernels/_lib.py LIN_LEVELS).
template <class D>
constexpr int lin_levels() {
  return D::NB > 16 ? 12 : 8;
}

// out (row-major 6x6) = IA0^-1 by its Cholesky factor (NaN where IA0 is not
// positive definite), a real call.
template <typename T>
RBD_HD_CALL void inverse6(const T* IA0, T* out) {
  T L[36], e[6], x[6];
  chol6(IA0, L);
  for (int c = 0; c < 6; ++c) {
    for (int r = 0; r < 6; ++r) e[r] = r == c ? T(1) : T(0);
    chol6_solve(L, e, x);
    for (int r = 0; r < 6; ++r) out[6 * r + c] = x[r];
  }
}

// The analytical M^-1 (rbdtpu dynamics/minv.py, kernels/colvec.py
// minv_colvec) one column a lane, NL columns at a time, from the
// articulated sweep's X, U and 1 / d and the rpy root's IA0^-1 (fbi): each
// column walks the bodies in depth-first preorder ``pre`` (``dep``: each
// body's depth), leaf -> root over the preorder backwards with one
// accumulator a tree level (slot values 0..5 of ``col``, LV levels of NL
// lanes, [value][level][lane]), then root -> leaf with the parent's F in
// its level's slot.  Column c of M^-1 lands in column c of Ms (rows of
// LDM >= nv + 1 values; lanes past nv use the pad column nv and write
// nothing); its entries on and above the diagonal are M^-1's.  No barrier:
// the caller syncs before reading Ms.  linearize.cu keeps its own copy of
// this loop: as a call of this function, K3's registers moved (PERF.md §6).
template <int NL, int LV, int LDM, typename T, class D>
RBD_HD void team_minv_columns(const Team<NL>& tm, const Model<T, D>& m, const int* pre,
                              const int* dep, const Xc<T>* X, const T (*U)[6], const T* invd,
                              const T* fbi, T* col, T* Ms) {
  const int nb = m.nb, n = m.nv(), lane = tm.lane;
  auto slot = [&](int d, int k) -> T& { return col[(k * LV + d) * NL + lane]; };
  for (int t0 = 0; t0 < n; t0 += NL) {
    // lanes past n read Ms's pad column and write nothing
    const bool on = t0 + lane < n;
    const int c = on ? t0 + lane : n;
    for (int d = 0; d < LV; ++d)
      for (int k = 0; k < 6; ++k) slot(d, k) = T(0);
    for (int idx = nb - 1; idx >= 0; --idx) {
      const int i = pre[idx], d = dep[i];
      T Fi[6];
      for (int k = 0; k < 6; ++k) {
        Fi[k] = slot(d, k);
        slot(d, k) = T(0);
      }
      if (m.root6(i)) {
        for (int r = 0; r < 6; ++r) {
          T x = 0;
          for (int k = 0; k < 6; ++k) x += fbi[6 * r + k] * ((k == c ? T(1) : T(0)) - Fi[k]);
          if (on) Ms[r * LDM + c] = x;
        }
        continue;
      }
      const T* S = m.body(i) + OFF_S;
      const int mi = m.vi(i), p = m.parent(i);
      const T dinv = invd[i];
      const T Mmi = -dinv * dot6(S, Fi) + (c == mi ? dinv : T(0));
      if (on) Ms[mi * LDM + c] = Mmi;
      if (p >= 0) {
        T t[6];
        for (int k = 0; k < 6; ++k) Fi[k] += U[i][k] * Mmi;
        xc_mtv(X[i], Fi, t);
        for (int k = 0; k < 6; ++k) slot(d - 1, k) += t[k];
      }
    }
    for (int idx = 0; idx < nb; ++idx) {
      const int i = pre[idx], d = dep[i];
      const T* S = m.body(i) + OFF_S;
      const int p = m.parent(i);
      T Fi[6];
      if (m.root6(i)) {
        for (int r = 0; r < 6; ++r) Fi[r] = Ms[r * LDM + c];
      } else if (p < 0) {
        const T Mi = Ms[i * LDM + c];
        for (int r = 0; r < 6; ++r) Fi[r] = S[r] * Mi;
      } else {
        const int mi = m.vi(i);
        T Fp[6], XF[6];
        for (int k = 0; k < 6; ++k) Fp[k] = slot(d - 1, k);
        xc_mv(X[i], Fp, XF);
        const T Mmi = Ms[mi * LDM + c] - invd[i] * dot6(U[i], XF);
        if (on) Ms[mi * LDM + c] = Mmi;
        for (int r = 0; r < 6; ++r) Fi[r] = XF[r] + S[r] * Mmi;
      }
      for (int k = 0; k < 6; ++k) slot(d, k) = Fi[k];
    }
  }
}

// The bias of the M^-1 + RNEA step (rbdtpu kernels/fused.py _step_lane,
// route "minv"): rhs = tau - c with c = RNEA(q, qd, 0), gravity and, with
// FEXT, the wrenches (team_rnea).
template <int NL, bool FEXT, class L, typename T, class D>
RBD_HD void team_rnea_bias(const Team<NL>& tm, const Model<T, D>& m, T* s, const T* x,
                           const T* tau, T gravity, const T* fext, T* rhs) {
  team_rnea<NL, FEXT, false, true, L>(tm, m, s, x, static_cast<const T*>(nullptr), tau, gravity,
                                      fext, rhs);
}

}  // namespace rbd

#ifdef __CUDACC__
// The team of thread ``threadIdx.x`` in a block of whole teams of NL lanes.
template <int NL>
__device__ __forceinline__ rbd::Team<NL> this_team() {
  const int lane = (int)(threadIdx.x % NL);
  const unsigned mask =
      NL == 32 ? 0xffffffffu : ((1u << NL) - 1u) << ((threadIdx.x % 32) / NL * NL);
  return rbd::Team<NL>{lane, mask};
}

// Dynamic shared memory of a block: the caller's byte count must equal
// ``extra`` values the block keeps for itself and tpb teams of ``stride``
// values, at most the H100's 232,448 bytes a block; above 48 KB the kernel
// is opted in.  Returns a cudaError_t.
template <typename K>
static int team_smem_check(K kernel, int smem, int tpb, int stride, size_t value_size,
                           int extra = 0) {
  if (tpb < 1 || (size_t)smem != ((size_t)tpb * stride + extra) * value_size || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return 0;
}
#endif
