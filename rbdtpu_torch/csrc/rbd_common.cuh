// Shared device code of the rbdtpu_torch kernels: the per-model tables and
// size classes, compact spatial transforms and their 3x3 and 6-vector
// algebra, the joint transforms, the rpy and quaternion roots' transforms,
// the quaternion root's manifold step and tangent difference, and the root
// block's 6x6 Cholesky solve.  The tree sweeps are rbd_team.cuh's (a team of lanes a
// state, the per-body arrays in shared memory).
//
// The model arrives as tables (kernels/_lib.py: model_tables), not as
// constants folded into the code: a generic kernel walks the tree in loops
// over bodies, its per-body arrays sized by the compile-time bound of its
// size class (Dims: bodies NB, DoFs NV, and whether body 0 is the rpy
// floating root).  Model-specialised code generation is later work
// (rbdtpu's K0).
//
// The rpy floating root (rbdtpu dynamics/*.py, the floating_base branches)
// is body 0 with six DoFs, q[0:6] = [x, y, z, roll, pitch, yaw] and S = I;
// body i > 0 owns DoF i + 5.  Its transform is plux(R^T, xyz) Xtree[0], its
// articulated 6x6 block is solved by an unrolled Cholesky factorisation
// (NaN, never a trap, when it is not positive definite).
//
// The quaternion floating root (rbdtpu's root_quat=True) is the same
// six-DoF body 0 with q[0:7] = [x, y, z, qw, qx, qy, qz] (nq = nv + 1) and
// body i > 0 at q[i + 6]; its transform is plux(R(quat)^T, xyz) Xtree[0]
// with the norm-robust R of rbdtpu's lane kernels, and its Euler step the
// manifold retraction (quat_root_step).
//
// Everything here is templated on the scalar type T (float or double) and
// compiles for the host too (RBD_HD), which lets a host build check the
// arithmetic against the plain PyTorch versions.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RBD_HD __host__ __device__ __forceinline__
// a device function kept as a call, with its own stack frame
#define RBD_HD_CALL __host__ __device__ __noinline__
#else
#include <cmath>
#define RBD_HD inline
#define RBD_HD_CALL inline
#endif

namespace rbd {

constexpr int PRISMATIC = 1;

// A size class (kernels/_lib.py SIZE_CLASSES): at most NB bodies; FB marks
// the rpy floating root, whose six DoFs make NV = NB + 5; NQ = NV values of
// q.  QUAT is false.
template <int NB_, bool FB_>
struct Dims {
  static constexpr int NB = NB_;
  static constexpr bool FB = FB_, QUAT = false;
  static constexpr int NV = FB_ ? NB_ + 5 : NB_, NQ = NV;
};
using N8 = Dims<8, false>;    // fixed-base trees of up to 8 bodies
using FB16 = Dims<16, true>;  // rpy floating-base trees of up to 16 bodies
using FB32 = Dims<32, true>;  // rpy floating-base trees of up to 32 bodies

// A size class of the quaternion root (kernels/_lib.py QUAT_CLASSES): the
// six-DoF root (FB) whose q has one value more, NQ = NV + 1.
template <int NB_>
struct DimsQuat {
  static constexpr int NB = NB_;
  static constexpr bool FB = true, QUAT = true;
  static constexpr int NV = NB_ + 5, NQ = NV + 1;
};
using FQ32 = DimsQuat<32>;  // quaternion-root trees of up to 32 bodies

// per-body table layout (kernels/_lib.py STRIDE): compact Xtree (E, r),
// joint axis, 6x6 inertia, motion subspace S, Ttree rotation and translation
constexpr int OFF_E = 0, OFF_R = 9, OFF_AXIS = 12, OFF_I = 15, OFF_S = 51,
              OFF_TR = 57, OFF_TP = 66, STRIDE = 69;

RBD_HD float rsin(float x) { return sinf(x); }
RBD_HD double rsin(double x) { return sin(x); }
RBD_HD float rcos(float x) { return cosf(x); }
RBD_HD double rcos(double x) { return cos(x); }
RBD_HD float sqrt_r(float x) { return sqrtf(x); }
RBD_HD double sqrt_r(double x) { return sqrt(x); }

template <typename T, class D>
struct Model {
  const T* tab;     // nb * STRIDE
  const int* itab;  // parent[nb], joint_type[nb]
  int nb;
  RBD_HD const T* body(int i) const { return tab + i * STRIDE; }
  RBD_HD int parent(int i) const { return itab[i]; }
  RBD_HD int jtype(int i) const { return itab[nb + i]; }
  RBD_HD int nv() const { return D::FB ? nb + 5 : nb; }
  RBD_HD int nq() const { return D::QUAT ? nb + 6 : nv(); }
  // the DoF of a 1-DoF body i (not the floating root)
  RBD_HD int vi(int i) const { return D::FB ? i + 5 : i; }
  // the coordinate of a 1-DoF body i in q (not the floating root)
  RBD_HD int qi(int i) const { return D::QUAT ? i + 6 : vi(i); }
  // body i is the six-DoF rpy root
  RBD_HD bool root6(int i) const { return D::FB && i == 0; }
};

// Compact Pluecker transform X = [[E, 0], [-E r^, E]] (parent -> child).
template <typename T>
struct Xc {
  T E[9];
  T r[3];
};

template <typename T>
RBD_HD void cross3(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
RBD_HD void mv3(const T* E, const T* a, T* o) {  // E a
  for (int i = 0; i < 3; ++i) o[i] = E[3 * i] * a[0] + E[3 * i + 1] * a[1] + E[3 * i + 2] * a[2];
}

template <typename T>
RBD_HD void mtv3(const T* E, const T* a, T* o) {  // E^T a
  for (int i = 0; i < 3; ++i) o[i] = E[i] * a[0] + E[3 + i] * a[1] + E[6 + i] * a[2];
}

template <typename T>
RBD_HD void mm3(const T* A, const T* B, T* o) {  // A B
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// Joint rotation about a unit axis: R = I + s K + (1 - c) K^2, K = axis^.
// With transpose the coordinate rotation E = R^T = I - s K + (1 - c) K^2.
// rot_axis_sc takes s = sin q and c = cos q.
template <typename T>
RBD_HD void rot_axis_sc(const T* ax, T s, T c, bool transpose, T* R) {
  const T oc = T(1) - c;
  const T K[9] = {0, -ax[2], ax[1], ax[2], 0, -ax[0], -ax[1], ax[0], 0};
  T K2[9];
  mm3(K, K, K2);
  const T sg = transpose ? -s : s;
  for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0 ? T(1) : T(0)) + sg * K[i] + oc * K2[i];
}

template <typename T>
RBD_HD void rot_axis(const T* ax, T q, bool transpose, T* R) {
  rot_axis_sc(ax, rsin(q), rcos(q), transpose, R);
}

// X = XJ(q) Xtree with Xtree = (Et, rt):
//   revolute:  XJ = plux(R(q)^T, 0)      -> E = R^T Et, r = rt
//   prismatic: XJ = plux(I, axis q)      -> E = Et,     r = rt + Et^T axis q
template <typename T, class D>
RBD_HD void joint_xc(const Model<T, D>& m, int i, T q, Xc<T>& X) {
  const T* b = m.body(i);
  const T* Et = b + OFF_E;
  const T* rt = b + OFF_R;
  const T* ax = b + OFF_AXIS;
  if (m.jtype(i) == PRISMATIC) {
    for (int k = 0; k < 9; ++k) X.E[k] = Et[k];
    T d[3];
    mtv3(Et, ax, d);
    for (int k = 0; k < 3; ++k) X.r[k] = rt[k] + d[k] * q;
  } else {
    T EJ[9];
    rot_axis(ax, q, true, EJ);
    mm3(EJ, Et, X.E);
    for (int k = 0; k < 3; ++k) X.r[k] = rt[k];
  }
}

// X m for a motion vector m = [a; b]: [E a; E (b - r x a)]
template <typename T>
RBD_HD void xc_mv(const Xc<T>& X, const T* m, T* o) {
  T rxa[3], t[3];
  cross3(X.r, m, rxa);
  for (int k = 0; k < 3; ++k) t[k] = m[3 + k] - rxa[k];
  mv3(X.E, m, o);
  mv3(X.E, t, o + 3);
}

// X^T f for a force vector f = [n; fl]: [E^T n + r x (E^T fl); E^T fl]
template <typename T>
RBD_HD void xc_mtv(const Xc<T>& X, const T* f, T* o) {
  T t[3], rxt[3];
  mtv3(X.E, f + 3, t);
  cross3(X.r, t, rxt);
  mtv3(X.E, f, o);
  for (int k = 0; k < 3; ++k) {
    o[k] += rxt[k];
    o[3 + k] = t[k];
  }
}

template <typename T>
RBD_HD void matvec6(const T* A, const T* x, T* o) {
  for (int i = 0; i < 6; ++i) {
    T s = 0;
    for (int k = 0; k < 6; ++k) s += A[6 * i + k] * x[k];
    o[i] = s;
  }
}

template <typename T>
RBD_HD T dot6(const T* a, const T* b) {
  T s = 0;
  for (int k = 0; k < 6; ++k) s += a[k] * b[k];
  return s;
}

// v x m (motion cross product)
template <typename T>
RBD_HD void cross_motion(const T* v, const T* m, T* o) {
  const T w0 = v[0], w1 = v[1], w2 = v[2], l0 = v[3], l1 = v[4], l2 = v[5];
  o[0] = w1 * m[2] - w2 * m[1];
  o[1] = w2 * m[0] - w0 * m[2];
  o[2] = w0 * m[1] - w1 * m[0];
  o[3] = l1 * m[2] - l2 * m[1] + w1 * m[5] - w2 * m[4];
  o[4] = l2 * m[0] - l0 * m[2] + w2 * m[3] - w0 * m[5];
  o[5] = l0 * m[1] - l1 * m[0] + w0 * m[4] - w1 * m[3];
}

// v x* f (force cross product)
template <typename T>
RBD_HD void cross_force(const T* v, const T* f, T* o) {
  const T w0 = v[0], w1 = v[1], w2 = v[2], l0 = v[3], l1 = v[4], l2 = v[5];
  o[0] = w1 * f[2] - w2 * f[1] + l1 * f[5] - l2 * f[4];
  o[1] = w2 * f[0] - w0 * f[2] + l2 * f[3] - l0 * f[5];
  o[2] = w0 * f[1] - w1 * f[0] + l0 * f[4] - l1 * f[3];
  o[3] = w1 * f[5] - w2 * f[4];
  o[4] = w2 * f[3] - w0 * f[5];
  o[5] = w0 * f[4] - w1 * f[3];
}

// Gravity as a fictitious base acceleration [0, 0, 0, 0, 0, -gravity].
template <typename T>
RBD_HD void gravity_accel(T gravity, T* a) {
  for (int k = 0; k < 5; ++k) a[k] = T(0);
  a[5] = -gravity;
}

// Active rotation R = Rz(yaw) Ry(pitch) Rx(roll) of URDF rpy angles
// (rbdtpu spatial/transforms.py rpy_to_R), row-major.
template <typename T>
RBD_HD void rpy_R(const T* rpy, T* R) {
  const T sr = rsin(rpy[0]), cr = rcos(rpy[0]), sp = rsin(rpy[1]), cp = rcos(rpy[1]),
          sy = rsin(rpy[2]), cy = rcos(rpy[2]);
  R[0] = cy * cp, R[1] = cy * sp * sr - sy * cr, R[2] = cy * sp * cr + sy * sr;
  R[3] = sy * cp, R[4] = sy * sp * sr + cy * cr, R[5] = sy * sp * cr - cy * sr;
  R[6] = -sp, R[7] = cp * sr, R[8] = cp * cr;
}

// d R / d rpy[j] of rpy_R (rbdtpu kernels/lanescalar.py rpy_dR).
template <typename T>
RBD_HD void rpy_dR(const T* rpy, int j, T* dR) {
  const T sr = rsin(rpy[0]), cr = rcos(rpy[0]), sp = rsin(rpy[1]), cp = rcos(rpy[1]),
          sy = rsin(rpy[2]), cy = rcos(rpy[2]);
  if (j == 0) {
    dR[0] = 0, dR[1] = cy * sp * cr + sy * sr, dR[2] = -(cy * sp * sr) + sy * cr;
    dR[3] = 0, dR[4] = sy * sp * cr - cy * sr, dR[5] = -(sy * sp * sr) - cy * cr;
    dR[6] = 0, dR[7] = cp * cr, dR[8] = -(cp * sr);
  } else if (j == 1) {
    dR[0] = -(cy * sp), dR[1] = cy * cp * sr, dR[2] = cy * cp * cr;
    dR[3] = -(sy * sp), dR[4] = sy * cp * sr, dR[5] = sy * cp * cr;
    dR[6] = -cp, dR[7] = -(sp * sr), dR[8] = -(sp * cr);
  } else {
    dR[0] = -(sy * cp), dR[1] = -(sy * sp * sr) - cy * cr, dR[2] = -(sy * sp * cr) + cy * sr;
    dR[3] = cy * cp, dR[4] = cy * sp * sr - sy * cr, dR[5] = cy * sp * cr + sy * sr;
    dR[6] = 0, dR[7] = 0, dR[8] = 0;
  }
}

// The rpy root's X = plux(R^T, p) Xtree[0] = plux(R^T Et, rt + Et^T p) for
// q6 = [p; rpy] (composition: plux(E1, r1) plux(E2, r2) =
// plux(E1 E2, r2 + E2^T r1)).  A real call: inlined into the
// linearize_parts kernel, nvcc 12.9 gave the root's r NaN and overwrote
// q[0] in the kernel's copy of q (float and double, on an H100); as a call,
// or reading a fresh copy of q, it is right.
template <typename T, class D>
RBD_HD_CALL void floating_xc(const Model<T, D>& m, const T* q6, Xc<T>& X) {
  const T* b = m.body(0);
  T R[9], Rt[9], d[3];
  rpy_R(q6 + 3, R);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
  mm3(Rt, b + OFF_E, X.E);
  mtv3(b + OFF_E, q6, d);
  for (int k = 0; k < 3; ++k) X.r[k] = b[OFF_R + k] + d[k];
}

// Active rotation of a quaternion (w, x, y, z), row-major, in the
// norm-robust form s = 2 / |q|^2 (rbdtpu kernels/lanescalar.py quat_R): a
// quaternion that drifts off unit norm stays a rotation.
template <typename T>
RBD_HD void quat_R(const T* qt, T* R) {
  const T w = qt[0], x = qt[1], y = qt[2], z = qt[3];
  const T s = T(2) / (w * w + x * x + y * y + z * z);
  const T xx = s * x * x, yy = s * y * y, zz = s * z * z;
  const T xy = s * x * y, xz = s * x * z, yz = s * y * z;
  const T wx = s * w * x, wy = s * w * y, wz = s * w * z;
  R[0] = T(1) - (yy + zz), R[1] = xy - wz, R[2] = xz + wy;
  R[3] = xy + wz, R[4] = T(1) - (xx + zz), R[5] = yz - wx;
  R[6] = xz - wy, R[7] = yz + wx, R[8] = T(1) - (xx + yy);
}

// The quaternion root's X = plux(R^T, p) Xtree[0] = plux(R^T Et, rt + Et^T
// p) for q7 = [p; quat]: floating_xc's twin, a real call like it.
template <typename T, class D>
RBD_HD_CALL void floating_quat_xc(const Model<T, D>& m, const T* q7, Xc<T>& X) {
  const T* b = m.body(0);
  T R[9], Rt[9], d[3];
  quat_R(q7 + 3, R);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
  mm3(Rt, b + OFF_E, X.E);
  mtv3(b + OFF_E, q7, d);
  for (int k = 0; k < 3; ++k) X.r[k] = b[OFF_R + k] + d[k];
}

RBD_HD float rsqrt_r(float x) { return 1.0f / sqrtf(x); }
RBD_HD double rsqrt_r(double x) { return 1.0 / sqrt(x); }
RBD_HD float atan2_r(float y, float x) { return atan2f(y, x); }
RBD_HD double atan2_r(double y, double x) { return atan2(y, x); }

// The quaternion root's semi-implicit Euler step on the manifold (rbdtpu
// kernels/fused.py _integrate_q_lane, lanescalar.py quat_step): from q7 =
// [p; quat] and the post-step twist qdn = [w'; v'] (6 values),
// p' = p + dt R(quat) v' and quat' = normalize(quat (x) exp(dt w')), the
// exponential's sinc on its Taylor branch below a squared angle of 1e-12.
// Writes the seven values of the new pose.  A real call.
template <typename T>
RBD_HD_CALL void quat_root_step(const T* q7, const T* qdn, T dt, T* out) {
  T R[9], dv[3];
  quat_R(q7 + 3, R);
  mv3(R, qdn + 3, dv);
  for (int k = 0; k < 3; ++k) out[k] = q7[k] + dt * dv[k];
  const T ax = dt * qdn[0], ay = dt * qdn[1], az = dt * qdn[2];
  const T n2 = ax * ax + ay * ay + az * az;
  const bool small = n2 < T(1e-12);
  const T nn = sqrt_r(n2 > T(1e-24) ? n2 : T(1e-24)), half = T(0.5) * nn;
  const T ew = small ? T(1) - n2 / T(8) : rcos(half);
  const T es = small ? T(0.5) - n2 / T(48) : rsin(half) / nn;
  const T ex = es * ax, ey = es * ay, ez = es * az;
  const T qw = q7[3], qx = q7[4], qy = q7[5], qz = q7[6];
  const T nw = qw * ew - qx * ex - qy * ey - qz * ez;
  const T nx = qw * ex + qx * ew + qy * ez - qz * ey;
  const T ny = qw * ey - qx * ez + qy * ew + qz * ex;
  const T nz = qw * ez + qx * ey - qy * ex + qz * ew;
  const T inv = rsqrt_r(nw * nw + nx * nx + ny * ny + nz * nz);
  out[3] = inv * nw, out[4] = inv * nx, out[5] = inv * ny, out[6] = inv * nz;
}

// The quaternion root's six rows of the tangent difference x (-) xn
// (rbdtpu kernels/fused.py _dx_rows, lanescalar.py quat_log_rel): the
// rotation vector log(conj(quat_n) (x) quat) with the sign fix at w < 0
// and the Taylor branch below a squared angle of 1e-12, then R(quat_n)^T
// (p - p_n).  x and xn hold q7 = [p; quat] first.  A real call.
template <typename T>
RBD_HD_CALL void quat_root_dx(const T* x, const T* xn, T* dx) {
  const T aw = xn[3], ax = xn[4], ay = xn[5], az = xn[6];
  const T bw = x[3], bx = x[4], by = x[5], bz = x[6];
  T rw = aw * bw + ax * bx + ay * by + az * bz;
  T rx = aw * bx - ax * bw - ay * bz + az * by;
  T ry = aw * by + ax * bz - ay * bw - az * bx;
  T rz = aw * bz - ax * by + ay * bx - az * bw;
  if (rw < T(0)) rw = -rw, rx = -rx, ry = -ry, rz = -rz;
  const T w = rw > T(1) ? T(1) : rw;
  const T n2 = rx * rx + ry * ry + rz * rz;
  const bool small = n2 < T(1e-12);
  const T nn = sqrt_r(small ? T(1e-12) : n2);
  const T scale = small ? T(2) / (w > T(0.5) ? w : T(0.5)) : T(2) * atan2_r(nn, w) / nn;
  dx[0] = scale * rx, dx[1] = scale * ry, dx[2] = scale * rz;
  T R0[9], d[3];
  quat_R(xn + 3, R0);
  for (int k = 0; k < 3; ++k) d[k] = x[k] - xn[k];
  mtv3(R0, d, dx + 3);
}

// Cholesky factor L (row-major, lower) of a symmetric 6x6 A, unrolled
// (rbdtpu kernels/lanescalar.py cholesky6): a block that is not positive
// definite gives NaN entries.
template <typename T>
RBD_HD void chol6(const T* A, T* L) {
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      T s = A[6 * i + j];
      for (int k = 0; k < j; ++k) s -= L[6 * i + k] * L[6 * j + k];
      L[6 * i + j] = i == j ? sqrt_r(s) : s / L[6 * j + j];
    }
}

// x = (L L^T)^-1 b for L from chol6 (cholesky6_solve).
template <typename T>
RBD_HD void chol6_solve(const T* L, const T* b, T* x) {
  T y[6];
  for (int i = 0; i < 6; ++i) {
    T s = b[i];
    for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
    y[i] = s / L[6 * i + i];
  }
  for (int i = 5; i >= 0; --i) {
    T s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
    x[i] = s / L[6 * i + i];
  }
}

}  // namespace rbd
