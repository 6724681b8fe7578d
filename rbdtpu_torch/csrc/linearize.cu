// linearize_parts: the pieces of the DDP knot linearisation.
// Replaces rbdtpu kernels/colvec.py linearize_parts_fused (Pallas,
// colvec.py:289).
//
// Outputs (row-major): Minv, dcq, dcd (B, n, n) indexed [b, row, col];
// qdd (B, n); n = nv.  Per knot: ABA for qdd; RNEA velocities,
// accelerations and accumulated forces at that qdd; the analytical M^-1
// (rbdtpu dynamics/minv.py; upper triangle authoritative, mirrored here);
// the dc/dq and dc/dqd sweeps (rbdtpu dynamics/rnea_grad.py).
//
// One team of NL lanes (_lib.TEAM) per knot, like the TPU kernel's
// column dimension (minv_colvec and grad_pass_colvec, colvec.py:63,129,
// hold one derivative column per sublane):
//   - the base quantities once, into the team's shared memory: the team's
//     ABA step (rbd_team.cuh team_fd_step, with the velocities kept) gives
//     the transforms, qdd, the articulated inertias, U and 1/d; the RNEA
//     accelerations at qdd are its accelerations plus S qdd, the forces one
//     lane a body, accumulated leaf -> root one lane a component;
//   - then the 2 nv derivative columns and the nv columns of M^-1, one column
//     a lane, NL at a time.  A column walks the bodies in depth-first
//     preorder (the model's int table, _lib.model_tables), so its state is a
//     stack of one slot per tree level (dv, da, df: 18 values) in shared
//     memory, column-fastest: a lane's slot entries sit in consecutive banks
//     from its neighbours'.  A body's forward step reads its parent's slot;
//     when the walk leaves a subtree its nodes are finished deepest first
//     (dc row = S . df, df added into the parent's slot).  M^-1's leaf ->
//     root pass runs the preorder backwards with one accumulator a level.
//     No per-body array lives on a lane's stack.
//   - each dc row is written by the lanes that hold its columns; M^-1 is
//     staged in shared memory and written row by row (mirrored).
// The deepest tree a class takes is lin_levels (8 levels for n8 and fb16,
// 12 for fb32; the humanoid has 11), fixed at build time with the layout;
// _lib.size_class sends a deeper tree on to a larger class or refuses it.
//
// Bound on the H100: latency.  A column's walk is a dependent chain of 6x6
// algebra over the bodies, and the team's ABA step one over the tree; the
// card holds as many teams as shared memory allows (LinLayout), up to one
// warp of teams a block (kernels/_lib.py linearize_geometry).
//
// The rpy root's columns (rbdtpu kernels/colvec.py grad_pass_colvec): its
// dqd columns seed dv_0 = e_j; its pose enters tau only through the gravity
// seed a_0 = X_0 a_grav (v_0 = qd[0:6], the child transforms do not depend
// on it), so the position columns vanish and rotation column 3 + j seeds
// da_0 = [0; (dR/drpy_j)^T g_l], g_l the linear part of Xtree_0 a_grav.
// The quaternion root's columns are the solver chart's tangent ones
// (rbdtpu colvec.py:154-170): its pose enters tau only through the gravity
// seed a0_lin = exp(-dtheta^) E g_l, so rotation column j < 3 seeds
// da_0 = [0; w x e_j] with w the linear part of X_0 a_grav, and its
// translation columns vanish; its dqd columns are the identity block, as on
// the rpy root.  Its q has nq = nv + 1 values, a joint's coordinate at
// q[i + 6].
// The root's 6x6 inverse (chol6) and the root transforms (floating_xc,
// floating_quat_xc) stay real calls (nvcc 12.9 miscompiled inlined root
// bodies, rbd_common.cuh).
#include "rbd_team.cuh"

namespace rbd {

template <typename T>
RBD_HD T nan_q() {
  return T(0) / T(0);
}

// K3's shared memory per team, in values of T (kernels/_lib.py
// linearize_values): what the columns read of the ABA step (the transforms,
// v, the accelerations, U, 1/d per body, and qdd: BASE), I v and the RNEA
// forces per body, the rpy root's IA0^-1, the knot's q, qd and u, the body
// at each level of the walk's current path, then one region that holds the
// team step's scratch (TL, with the velocities kept) during the step and
// the columns' slots after it: 18 values a level a lane ([value][level]
// [lane]); the M^-1 columns use values 0..5 and keep M^-1 (NV x (NV + 1))
// over the rest (MS).  Sharing the region lets more teams onto an SM.  A
// block holds several teams; STRIDE pads a team's values so that the teams
// of a warp start on different banks.
template <class D, int NL>
struct LinLayout {
  using TL = TeamLayout<D, false, false, true>;
  static constexpr int NB = D::NB, NV = D::NV, LV = lin_levels<D>(), LDM = NV + 1;
  static constexpr int BX = 0, BV = BX + 12 * NB, BA = BV + 6 * NB, BU = BA + 6 * NB,
                       BINVD = BU + 6 * NB, BQDD = BINVD + NB, IV = BQDD + NV, F = IV + 6 * NB,
                       FBI = F + 6 * NB, XQ = FBI + 36, US = XQ + D::NQ + NV, PATH = US + NV,
                       SHARED = PATH + LV * NL, TEAM = SHARED, COL = SHARED,
                       END = SHARED + (TL::VALUES > 18 * LV * NL ? TL::VALUES : 18 * LV * NL),
                       // M^-1 beside the M^-1 columns' slots where it fits (every
                       // team size of _lib.TEAM), else after the region
                       MS_IN = 12 * LV * NL >= NV * LDM, MS = MS_IN ? COL + 6 * LV * NL : END,
                       VALUES = END + (MS_IN ? 0 : NV * LDM),
                       STRIDE = (VALUES + 31) / 32 * 32 + NL % 32;
};

// One knot by the team ``tm``: q (nq), qd, u (nv) in global memory;
// outputs as the kernel's, at this knot's offsets.
template <int NL, typename T, class D>
RBD_HD void linearize_team(const Team<NL>& tm, const Model<T, D>& m, T* sm, const T* q,
                           const T* qd, const T* u, T gravity, T* Minv, T* dcq, T* dcd, T* qddo) {
  using LL = LinLayout<D, NL>;
  using TL = typename LL::TL;
  const int nb = m.nb, n = m.nv(), nq = m.nq(), lane = tm.lane;
  const int* pre = m.itab + 3 * nb + 2 + m.itab[3 * nb];  // preorder, then depths
  const int* dep = pre + nb;
  T* s = sm + LL::TEAM;
  T* base = sm;
  T* xq = sm + LL::XQ;
  T* us = sm + LL::US;
  T* Iv = sm + LL::IV;
  T* F = sm + LL::F;
  T* fbi = sm + LL::FBI;
  T* Ms = sm + LL::MS;
  int* path = reinterpret_cast<int*>(sm + LL::PATH);
  T* col = sm + LL::COL;
  bool deep = false;  // a tree deeper than the layout's levels: NaN outputs
  for (int i = 0; i < nb; ++i) deep |= dep[i] >= LL::LV;
  if (deep) {
    for (int e = lane; e < n * n; e += NL) Minv[e] = dcq[e] = dcd[e] = nan_q<T>();
    for (int e = lane; e < n; e += NL) qddo[e] = nan_q<T>();
    return;
  }
  for (int k = lane; k < nq; k += NL) xq[k] = q[k];
  for (int k = lane; k < n; k += NL) {
    xq[nq + k] = qd[k];
    us[k] = u[k];
  }
  tm.sync();
  // ABA (dt = 0, no state written): X, v, the accelerations without the
  // body's own S qdd, IA, U, 1/d and qdd in the team's scratch
  team_fd_step<NL, false, false, TL>(tm, m, s, xq, us, T(0), gravity, static_cast<const T*>(nullptr),
                                    static_cast<T*>(nullptr), static_cast<T*>(nullptr));
  tm.sync();
  // what the columns read of the step, out of the scratch the slots reuse
  for (int e = lane; e < 31 * nb + n; e += NL) {
    const int src = e < 12 * nb ? TL::X + e
                    : e < 18 * nb ? TL::V + e - 12 * nb
                    : e < 24 * nb ? TL::A + e - 18 * nb
                    : e < 30 * nb ? TL::U + e - 24 * nb
                    : e < 31 * nb ? TL::INVD + e - 30 * nb
                                  : TL::QDD + e - 31 * nb;
    const int dst = e < 12 * nb ? LL::BX + e
                    : e < 18 * nb ? LL::BV + e - 12 * nb
                    : e < 24 * nb ? LL::BA + e - 18 * nb
                    : e < 30 * nb ? LL::BU + e - 24 * nb
                    : e < 31 * nb ? LL::BINVD + e - 30 * nb
                                  : LL::BQDD + e - 31 * nb;
    base[dst] = s[src];
  }
  tm.sync();
  const Xc<T>* X = reinterpret_cast<const Xc<T>*>(base + LL::BX);
  T(*v)[6] = reinterpret_cast<T(*)[6]>(base + LL::BV);
  T(*a)[6] = reinterpret_cast<T(*)[6]>(base + LL::BA);
  const T(*U)[6] = reinterpret_cast<const T(*)[6]>(base + LL::BU);
  const T* invd = base + LL::BINVD;
  const T* qdd = base + LL::BQDD;
  // RNEA accelerations at qdd (the rpy root's already hold it) and I v, one
  // lane a value
  for (int e = lane; e < 6 * nb; e += NL) {
    const int i = e / 6, k = e - 6 * i;
    const T* I = m.body(i) + OFF_I;
    if (!m.root6(i)) a[i][k] += m.body(i)[OFF_S + k] * qdd[m.vi(i)];
    T iv = 0;
    for (int j = 0; j < 6; ++j) iv += I[6 * k + j] * v[i][j];
    Iv[6 * i + k] = iv;
  }
  for (int k = lane; k < n; k += NL) qddo[k] = qdd[k];
  tm.sync();
  // forces I a + v x* I v one lane a body; the root's IA0^-1 on the last lane
  for (int i = lane; i < nb; i += NL) {
    T Ia[6], vf[6];
    matvec6(m.body(i) + OFF_I, a[i], Ia);
    cross_force(v[i], Iv + 6 * i, vf);
    for (int k = 0; k < 6; ++k) F[6 * i + k] = Ia[k] + vf[k];
  }
  if constexpr (D::FB) {
    if (lane == NL - 1) inverse6(s + TL::IA, fbi);
  }
  tm.sync();
  // forces accumulated leaf -> root, one lane a component
  for (int i = nb - 1; i >= 0; --i) {
    const int p = m.parent(i);
    if (p < 0) continue;
    if (lane < 6) {
      T t[6], tk = 0;
      xc_mtv(X[i], F + 6 * i, t);
      for (int k = 0; k < 6; ++k) tk = k == lane ? t[k] : tk;
      F[6 * p + lane] += tk;
    }
    tm.sync();
  }

  tm.sync();  // the step's scratch (IA[0] above) is dead: the slots reuse it
  // slot k (0..17: dv, da, df) of level d of this lane's column state
  auto slot = [&](int d, int k) -> T& { return col[(k * LL::LV + d) * NL + lane]; };
  // the derivative columns: dq columns 0..n-1, then dqd columns, NL at a time
  T ag[6];
  gravity_accel(gravity, ag);
  for (int t0 = 0; t0 < 2 * n; t0 += NL) {
    const int task = t0 + lane;
    const bool on = task < 2 * n, wrt_q = task < n;
    const int j = on ? (wrt_q ? task : task - n) : 0;
    T* out = wrt_q ? dcq : dcd;
    // finish the node at level d: its dc row, then df into its parent's slot
    auto finish = [&](int d) {
      const int k = path[d * NL + lane];
      T df[6];
      for (int c = 0; c < 6; ++c) df[c] = slot(d, 12 + c);
      if (m.root6(k)) {  // S = I: the root's six rows
        if (on)
          for (int c = 0; c < 6; ++c) out[c * n + j] = df[c];
      } else {
        const T* S = m.body(k) + OFF_S;
        if (on) out[m.vi(k) * n + j] = dot6(S, df);
        if (d > 0) {
          T tt[6];
          xc_mtv(X[k], df, tt);
          if (wrt_q && m.vi(k) == j) {  // d(X^T f)/dq_k = X^T (S x* f)
            T Sf[6], t2[6];
            cross_force(S, F + 6 * k, Sf);
            xc_mtv(X[k], Sf, t2);
            for (int c = 0; c < 6; ++c) tt[c] += t2[c];
          }
          for (int c = 0; c < 6; ++c) slot(d - 1, 12 + c) += tt[c];
        }
      }
    };
    int cur = -1;
    for (int idx = 0; idx < nb; ++idx) {
      const int i = pre[idx], d = dep[i];
      for (; cur >= d; --cur) finish(cur);
      const T* b = m.body(i);
      const T* S = b + OFF_S;
      const T* I = b + OFF_I;
      T dvi[6], dai[6];
      if (m.root6(i)) {
        for (int k = 0; k < 6; ++k) {
          dvi[k] = !wrt_q && k == j ? T(1) : T(0);
          dai[k] = T(0);
        }
        if constexpr (D::QUAT) {
          if (wrt_q && j < 3) {  // w x e_j, w the linear part of X_0 a_grav
            T a0[6];
            xc_mv(X[0], ag, a0);
            const int j1 = j == 2 ? 0 : j + 1, j2 = j == 0 ? 2 : j - 1;
            dai[3 + j1] = a0[3 + j2];
            dai[3 + j2] = -a0[3 + j1];
          }
        } else if (wrt_q && j >= 3 && j < 6) {
          T g6[6], dR[9];
          Xc<T> Xt;
          for (int k = 0; k < 9; ++k) Xt.E[k] = b[OFF_E + k];
          for (int k = 0; k < 3; ++k) Xt.r[k] = b[OFF_R + k];
          xc_mv(Xt, ag, g6);
          rpy_dR(xq + 3, j - 3, dR);
          mtv3(dR, g6 + 3, dai + 3);
        }
      } else {
        const int p = m.parent(i), vi = m.vi(i);
        T dab[6], Xa[6];
        if (p < 0) {
          for (int k = 0; k < 6; ++k) dvi[k] = dab[k] = T(0);
          xc_mv(X[i], ag, Xa);
        } else {
          T dvp[6], dap[6];
          for (int k = 0; k < 6; ++k) {
            dvp[k] = slot(d - 1, k);
            dap[k] = slot(d - 1, 6 + k);
          }
          xc_mv(X[i], dvp, dvi);
          xc_mv(X[i], dap, dab);
          xc_mv(X[i], a[p], Xa);
        }
        if (vi == j) {
          if (!wrt_q) {
            for (int k = 0; k < 6; ++k) dvi[k] += S[k];
          } else if (p >= 0) {
            T Xv[6], inj[6];
            xc_mv(X[i], v[p], Xv);
            cross_motion(Xv, S, inj);
            for (int k = 0; k < 6; ++k) dvi[k] += inj[k];
          }
        }
        T cm[6];
        cross_motion(dvi, S, cm);
        for (int k = 0; k < 6; ++k) dai[k] = dab[k] + xq[nq + vi] * cm[k];
        if (vi == j) {
          T inj[6];
          cross_motion(wrt_q ? Xa : v[i], S, inj);
          for (int k = 0; k < 6; ++k) dai[k] += inj[k];
        }
      }
      T Ida[6], Idv[6], t1[6], t2[6];
      matvec6(I, dai, Ida);
      matvec6(I, dvi, Idv);
      cross_force(dvi, Iv + 6 * i, t1);
      cross_force(v[i], Idv, t2);
      for (int k = 0; k < 6; ++k) {
        slot(d, k) = dvi[k];
        slot(d, 6 + k) = dai[k];
        slot(d, 12 + k) = Ida[k] + t1[k] + t2[k];
      }
      path[d * NL + lane] = i;
      cur = d;
    }
    for (; cur >= 0; --cur) finish(cur);
  }

  tm.sync();  // every lane's derivative columns done: Ms reuses their slots
  // M^-1 one column a lane (rbdtpu minv_colvec): leaf -> root over the
  // preorder backwards, an accumulator a level (slot k 0..5), then root ->
  // leaf with the parent's F in its level's slot; column c of M^-1 in Ms
  for (int t0 = 0; t0 < n; t0 += NL) {
    // lanes past n read Ms's pad column and write nothing
    const bool on = t0 + lane < n;
    const int c = on ? t0 + lane : n;
    for (int d = 0; d < LL::LV; ++d)
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
          if (on) Ms[r * LL::LDM + c] = x;
        }
        continue;
      }
      const T* S = m.body(i) + OFF_S;
      const int mi = m.vi(i), p = m.parent(i);
      const T dinv = invd[i];
      const T Mmi = -dinv * dot6(S, Fi) + (c == mi ? dinv : T(0));
      if (on) Ms[mi * LL::LDM + c] = Mmi;
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
        for (int r = 0; r < 6; ++r) Fi[r] = Ms[r * LL::LDM + c];
      } else if (p < 0) {
        const T Mi = Ms[i * LL::LDM + c];
        for (int r = 0; r < 6; ++r) Fi[r] = S[r] * Mi;
      } else {
        const int mi = m.vi(i);
        T Fp[6], XF[6];
        for (int k = 0; k < 6; ++k) Fp[k] = slot(d - 1, k);
        xc_mv(X[i], Fp, XF);
        const T Mmi = Ms[mi * LL::LDM + c] - invd[i] * dot6(U[i], XF);
        if (on) Ms[mi * LL::LDM + c] = Mmi;
        for (int r = 0; r < 6; ++r) Fi[r] = XF[r] + S[r] * Mmi;
      }
      for (int k = 0; k < 6; ++k) slot(d, k) = Fi[k];
    }
  }
  tm.sync();
  // M^-1 row by row, the upper triangle mirrored
  for (int e = lane; e < n * n; e += NL) {
    const int r = e / n, c = e - r * n;
    Minv[e] = r <= c ? Ms[r * LL::LDM + c] : Ms[c * LL::LDM + r];
  }
}

}  // namespace rbd

#ifdef __CUDACC__
// tpb teams of NL lanes a block, one team a knot.
template <typename T, class D, int NL>
__global__ void __launch_bounds__(32)
    linearize_parts_kernel(rbd::Model<T, D> m, const T* __restrict__ q, const T* __restrict__ qd,
                           const T* __restrict__ u, T* __restrict__ Minv, T* __restrict__ dcq,
                           T* __restrict__ dcd, T* __restrict__ qdd, int B, int tpb, T gravity) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int team = (int)threadIdx.x / NL, b = blockIdx.x * tpb + team;
  if (b >= B) return;
  const int n = m.nv();
  const size_t o1 = (size_t)b * n, o2 = (size_t)b * n * n;
  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)team * rbd::LinLayout<D, NL>::STRIDE;
  rbd::linearize_team(this_team<NL>(), m, sm, q + (size_t)b * m.nq(), qd + o1, u + o1, gravity,
                      Minv + o2,
                      dcq + o2, dcd + o2, qdd + o1);
}

// B knots, tpb teams of NL lanes a block; smem must be tpb teams' bytes.
template <typename T, class D, int NL>
static int launch_linearize_parts(const T* tab, const int* itab, int nb, const T* q, const T* qd,
                                  const T* u, T* Minv, T* dcq, T* dcd, T* qdd, int B, int tpb,
                                  int smem, T gravity, void* stream) {
  if (B <= 0) return 0;
  if (tpb < 1 || tpb * NL > 32) return (int)cudaErrorInvalidValue;
  const int err = team_smem_check(linearize_parts_kernel<T, D, NL>, smem, tpb,
                                  rbd::LinLayout<D, NL>::STRIDE, sizeof(T));
  if (err != 0) return err;
  rbd::Model<T, D> m{tab, itab, nb};
  linearize_parts_kernel<T, D, NL><<<(B + tpb - 1) / tpb, tpb * NL, smem, (cudaStream_t)stream>>>(
      m, q, qd, u, Minv, dcq, dcd, qdd, B, tpb, gravity);
  return (int)cudaGetLastError();
}

#define RBD_LINEARIZE_PARTS(CLS, D, T, SFX)                                                    \
  int rbd_linearize_parts_##CLS##_##SFX(const T* tab, const int* itab, int nb, const T* q,    \
                                        const T* qd, const T* u, T* Minv, T* dcq, T* dcd,     \
                                        T* qdd, int B, int tpb, int smem, T gravity,          \
                                        void* stream) {                                       \
    return launch_linearize_parts<T, rbd::D, RBD_TEAM_linearize_parts_##CLS##_##SFX>(          \
        tab, itab, nb, q, qd, u, Minv, dcq, dcd, qdd, B, tpb, smem, gravity, stream);         \
  }

extern "C" {
RBD_LINEARIZE_PARTS(n8, N8, float, f32)
RBD_LINEARIZE_PARTS(n8, N8, double, f64)
RBD_LINEARIZE_PARTS(fb16, FB16, float, f32)
RBD_LINEARIZE_PARTS(fb16, FB16, double, f64)
RBD_LINEARIZE_PARTS(fb32, FB32, float, f32)
RBD_LINEARIZE_PARTS(fb32, FB32, double, f64)
RBD_LINEARIZE_PARTS(fq32, FQ32, float, f32)
RBD_LINEARIZE_PARTS(fq32, FQ32, double, f64)
}
#endif
