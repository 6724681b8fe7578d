"""The generator of the model-specialised kernels (K0): straight-line CUDA
C++ for one robot, one thread a state.

rbdtpu builds every tree kernel by tracing its lane sweeps with the robot's
constants as Python floats, so that a product with a structural zero
generates no code: the traced Pallas body is model-specialised code
(rbdtpu kernels/lanescalar.py:12-17, fused.py:5-10).  This module does the
same for Hopper.  ``Sym`` is a lane scalar that is never static: each
operation on it appends one ``const T t<k> = ...;`` line and returns the
new name.  The generator runs the port's very lane sweeps
(``kernels.fused``: ``rnea_lane``, ``_step_lane``) on such symbols, so the
model's zeros fold exactly as in their plain version on tensors, and in the
same order; a constant is written at full precision (``float.hex``) and cast
to T where it is used, as torch casts a Python scalar to a float32 tensor's
type.

``generate`` writes, per (model, dtype, gravity), one source a step body
(the K10 bias and with qdd; the K1 ABA step, the K6 factorised and dense
M^-1 steps, each with and without world wrenches), one source a K5 route
(``<step>_rollout.cu``) and ``entry.cu``, whose C functions have the table
kernels' signatures without the tables, the shared memory and the
gravity:

- ``rbd_rnea_static``: q qd qdd tau B threads stream;
- ``rbd_fd_step_static``: x u fext fext_stride xo B threads dt stream;
- ``rbd_fd_step_minv_static``: x u fext fext_stride xo B dense threads dt
  stream;
- ``rbd_rollout_multi_static``: x0 U fext xo B H minv threads dt stream.

Gravity is folded in as rbdtpu folds it (a_grav's one nonzero entry), so
each gravity has its own sources (``_lib.model_library`` keys them by it).
A step body is one ``__noinline__`` device function in its step kernel's
source; K5's source inlines the same statements into its loop over the
knots, so the state stays in registers between steps.  Every source also
compiles as host C++ (the kernels become loops over the states), which the
CPU tests build with g++.  Bound on the H100: a body's operations, one
thread a state; its thousands of live temporaries are the registers' to
hold (ptxas reports the spills).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib, colvec, fk_lane, fused

_CTYPE = {torch.float32: "float", torch.float64: "double"}
_MATH = {"float": {"sin": "sinf", "cos": "cosf", "sqrt": "sqrtf"},
         "double": {"sin": "sin", "cos": "cos", "sqrt": "sqrt"}}
# (source, lane body, world wrenches): the K10 bias and with qdd, and the
# steps of K1 ("aba"), K6's factorised route ("minv", also K5's minv
# route) and its dense route ("dense")
BODIES = (("rnea_bias", "rnea", False), ("rnea_qdd", "rnea", False),
          ("aba", "aba", False), ("aba_fext", "aba", True),
          ("minv", "minv", False), ("minv_fext", "minv", True),
          ("dense", "dense", False), ("dense_fext", "dense", True))
# the steps K5 takes, each from a source of its own
ROLLOUT_BODIES = ("aba", "aba_fext", "minv", "minv_fext")
# K2's knot body (``fused.feedback_lane``), without and with wrenches
FEEDBACK_BODIES = (("feedback", False), ("feedback_fext", True))


def literal(c) -> str:
    """A Python constant as C: its exact binary value, cast to T."""
    return f"T({float(c).hex()})"


class Sym:
    """A lane scalar of the generated code: the name of a C variable.
    Arithmetic with another Sym or a Python float emits one statement."""

    __slots__ = ("em", "name")

    def __init__(self, em: "Emitter", name: str):
        self.em, self.name = em, name

    def __add__(self, o):
        return self.em.binary(self, "+", o)

    def __radd__(self, o):
        return self.em.binary(o, "+", self)

    def __sub__(self, o):
        return self.em.binary(self, "-", o)

    def __rsub__(self, o):
        return self.em.binary(o, "-", self)

    def __mul__(self, o):
        return self.em.binary(self, "*", o)

    def __rmul__(self, o):
        return self.em.binary(o, "*", self)

    def __truediv__(self, o):
        return self.em.binary(self, "/", o)

    def __rtruediv__(self, o):
        return self.em.binary(o, "/", self)

    def __neg__(self):
        return self.em.emit(f"-{self.name}")

    def __lt__(self, o):
        return self.em.compare(self, "<", o)

    def __bool__(self):
        raise TypeError("a generated lane scalar has no truth value")

    def call(self, fn: str):
        """sin, cos, sqrt or rsqrt of this scalar."""
        if fn == "rsqrt":
            return self.em.emit(
                f"T(1) / {_MATH[self.em.ctype]['sqrt']}({self.name})")
        return self.em.emit(f"{_MATH[self.em.ctype][fn]}({self.name})")

    def maximum(self, c):
        """max(self, c), NaN staying NaN (torch.clamp_min)."""
        c = self.em.operand(c)
        return self.em.emit(f"({self.name} < {c}) ? {c} : {self.name}")

    def clip(self, lo, hi):
        """self clamped to [lo, hi], NaN staying NaN (torch.clamp)."""
        lo, hi = self.em.operand(lo), self.em.operand(hi)
        return self.em.emit(f"({self.name} < {lo}) ? {lo} : "
                            f"(({self.name} > {hi}) ? {hi} : {self.name})")

    def clamp_sym(self, c: "Bound"):
        """self clamped to [-c, c] for a runtime bound read through a
        pointer that may be null (then self as it is): one statement."""
        a, b = self.name, c.name
        return self.em.emit(f"{c.guard} ? (({a} < -{b}) ? -{b} : "
                            f"(({a} > {b}) ? {b} : {a})) : {a}")


class Bound(Sym):
    """A clamp bound read at run time through the pointer ``guard``, which
    is null when no clamp is asked for."""

    __slots__ = ("guard",)

    def __init__(self, em: "Emitter", name: str, guard: str):
        super().__init__(em, name)
        self.guard = guard


class SymBool:
    """A comparison of generated lane scalars (``where``'s condition)."""

    __slots__ = ("em", "name")

    def __init__(self, em: "Emitter", name: str):
        self.em, self.name = em, name

    def __bool__(self):
        raise TypeError("a generated comparison has no truth value")

    def select(self, a, b):
        return self.em.emit(f"{self.name} ? {self.em.operand(a)} : "
                            f"{self.em.operand(b)}")


class Emitter:
    """The statements of one straight-line body, in the order the lane code
    computes them."""

    def __init__(self, ctype: str):
        self.ctype = ctype
        self.lines = []
        self.count = 0

    def operand(self, x) -> str:
        if isinstance(x, Sym):
            return x.name
        if isinstance(x, (int, float)):
            return literal(x)
        raise TypeError(f"not a lane scalar: {type(x).__name__}")

    def emit(self, expr: str, ctype: str = "T") -> Sym:
        name = f"t{self.count}"
        self.count += 1
        self.lines.append(f"  const {ctype} {name} = {expr};")
        return (SymBool if ctype == "bool" else Sym)(self, name)

    def binary(self, a, op: str, b) -> Sym:
        return self.emit(f"{self.operand(a)} {op} {self.operand(b)}")

    def compare(self, a, op: str, b) -> SymBool:
        return self.emit(f"{self.operand(a)} {op} {self.operand(b)}",
                         "bool")

    def inputs(self, name: str, n: int) -> list:
        """n scalars loaded from the pointer ``name``_."""
        out = []
        for k in range(n):
            self.lines.append(f"  const T {name}{k} = {name}_[{k}];")
            out.append(Sym(self, f"{name}{k}"))
        return out

    def store(self, name: str, values):
        for k, v in enumerate(values):
            self.lines.append(f"  {name}_[{k}] = {self.operand(v)};")


class Generated(NamedTuple):
    """The sources of one (model, dtype, gravity), by file name, and the
    operations each body emits a state."""
    sources: dict
    ops: dict


_PRELUDE = """\
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RBD_DEV __device__ __noinline__
#define RBD_HD __device__ __forceinline__
typedef cudaStream_t rbd_stream;
#else
#include <math.h>
#define RBD_DEV static
#define RBD_HD static inline
typedef void* rbd_stream;
#endif
#include <stddef.h>
"""


def _body(ms, tag: str, kind: str, fext: bool, ctype: str, gravity: float):
    """(C text of ``<tag>_body`` after its qualifier, operations it
    emits)."""
    em = Emitter(ctype)
    q = em.inputs("q", ms.nq)
    qd = em.inputs("qd", ms.nv)
    if kind == "rnea":
        qdd = em.inputs("qdd", ms.nv) if tag == "rnea_qdd" else None
        start = em.count
        tau = fused.rnea_lane(ms, q, qd, qdd, gravity)
        em.store("tau", tau)
        params = ("const T* q_, const T* qd_, "
                  + ("const T* qdd_, " if qdd is not None else "")
                  + "T* tau_")
    else:
        u = em.inputs("u", ms.nv)
        fe = (fused._fext_lists(ms, em.inputs("fe", ms.nb * 6))
              if fext else None)
        dt = Sym(em, "dt")
        start = em.count
        q_new, qd_new = fused._step_lane(
            ms, q, qd, u, dt, gravity, "aba" if kind == "aba" else "minv",
            dense_minv=kind == "dense", f_ext=fe)
        em.store("qn", q_new)
        em.store("qdn", qd_new)
        params = ("const T* q_, const T* qd_, const T* u_, "
                  + ("const T* fe_, " if fext else "")
                  + "const T dt, T* qn_, T* qdn_")
    text = (f"void {tag}_body({params}) {{\n"
            + "\n".join(em.lines) + "\n}\n")
    return text, em.count - start


def _rnea_kernels(tag: str) -> str:
    qdd = tag == "rnea_qdd"
    call = (f"{tag}_body(q + o, qd + v, {'qdd + v, ' if qdd else ''}"
            "tau + v);")
    return f"""
RBD_HD void {tag}_state(int b, const T* q, const T* qd, const T* qdd,
                        T* tau) {{
  const size_t o = (size_t)b * RBD_NQ, v = (size_t)b * RBD_NV;
  {call}
}}

#ifdef __CUDACC__
__global__ void __launch_bounds__(RBD_THREADS_MAX)
{tag}_kernel(const T* q, const T* qd, const T* qdd, T* tau, int B) {{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {tag}_state(b, q, qd, qdd, tau);
}}
#endif

extern "C" int rbd_static_{tag}(const T* q, const T* qd, const T* qdd,
                                T* tau, int B, int threads, rbd_stream s) {{
  if (B <= 0) return 0;
#ifdef __CUDACC__
  if (threads < 1 || threads > RBD_THREADS_MAX) return 1;
  {tag}_kernel<<<(B + threads - 1) / threads, threads, 0, s>>>(
      q, qd, qdd, tau, B);
  return (int)cudaGetLastError();
#else
  for (int b = 0; b < B; ++b) {tag}_state(b, q, qd, qdd, tau);
  return 0;
#endif
}}
"""


def _step_kernels(tag: str, fext: bool) -> str:
    fe_step = "fe + (size_t)b * stride, " if fext else ""
    return f"""
RBD_HD void {tag}_step_state(int b, const T* x, const T* u, const T* fe,
                             int stride, T* xo, T dt) {{
  const T* xb = x + (size_t)b * RBD_NX;
  T* ob = xo + (size_t)b * RBD_NX;
  {tag}_body(xb, xb + RBD_NQ, u + (size_t)b * RBD_NV, {fe_step}dt, ob,
             ob + RBD_NQ);
}}

#ifdef __CUDACC__
__global__ void __launch_bounds__(RBD_THREADS_MAX)
{tag}_step_kernel(const T* x, const T* u, const T* fe, int stride, T* xo,
                  int B, T dt) {{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {tag}_step_state(b, x, u, fe, stride, xo, dt);
}}
#endif

extern "C" int rbd_static_step_{tag}(const T* x, const T* u, const T* fe,
                                     int stride, T* xo, int B, int threads,
                                     T dt, rbd_stream s) {{
  if (B <= 0) return 0;
#ifdef __CUDACC__
  if (threads < 1 || threads > RBD_THREADS_MAX) return 1;
  {tag}_step_kernel<<<(B + threads - 1) / threads, threads, 0, s>>>(
      x, u, fe, stride, xo, B, dt);
  return (int)cudaGetLastError();
#else
  for (int b = 0; b < B; ++b) {tag}_step_state(b, x, u, fe, stride, xo, dt);
  return 0;
#endif
}}
"""


def _rollout_kernels(tag: str, fext: bool) -> str:
    fe_knot = "fe + (size_t)t * RBD_NB * 6, " if fext else ""
    return f"""
// K5: the whole horizon a thread; the body is inlined and every index of
// x and xn is a constant, so the state stays in registers between steps
RBD_HD void {tag}_rollout_state(int b, const T* x0, const T* U,
                                const T* fe, T* xo, int B, int H, T dt) {{
  T x[RBD_NX], xn[RBD_NX];
#pragma unroll
  for (int i = 0; i < RBD_NX; ++i) x[i] = x0[(size_t)b * RBD_NX + i];
  for (int t = 0; t < H; ++t) {{
    {tag}_body(x, x + RBD_NQ, U + ((size_t)t * B + b) * RBD_NV, {fe_knot}dt,
               xn, xn + RBD_NQ);
#pragma unroll
    for (int i = 0; i < RBD_NX; ++i) x[i] = xn[i];
  }}
#pragma unroll
  for (int i = 0; i < RBD_NX; ++i) xo[(size_t)b * RBD_NX + i] = x[i];
}}

#ifdef __CUDACC__
__global__ void __launch_bounds__(RBD_THREADS_MAX)
{tag}_rollout_kernel(const T* x0, const T* U, const T* fe, T* xo, int B,
                     int H, T dt) {{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {tag}_rollout_state(b, x0, U, fe, xo, B, H, dt);
}}
#endif

extern "C" int rbd_static_rollout_{tag}(const T* x0, const T* U,
                                        const T* fe, T* xo, int B, int H,
                                        int threads, T dt, rbd_stream s) {{
  if (B <= 0) return 0;
#ifdef __CUDACC__
  if (threads < 1 || threads > RBD_THREADS_MAX) return 1;
  {tag}_rollout_kernel<<<(B + threads - 1) / threads, threads, 0, s>>>(
      x0, U, fe, xo, B, H, dt);
  return (int)cudaGetLastError();
#else
  for (int b = 0; b < B; ++b) {tag}_rollout_state(b, x0, U, fe, xo, B, H, dt);
  return 0;
#endif
}}
"""


def _feedback_body(ms, tag: str, fext: bool, ctype: str, gravity: float):
    """(C text of ``<tag>_body`` after its qualifier, operations it emits):
    one knot of K2, ``fused.feedback_lane``, reading the state from x_ and
    writing x' to xo_ and the applied control to uo_."""
    em = Emitter(ctype)
    nx, nv = ms.nq + ms.nv, ms.nv
    x = em.inputs("x", nx)
    xn = em.inputs("xn", nx)
    un = em.inputs("un", nv)
    kf = em.inputs("kf", nv)
    K = em.inputs("K", nv * 2 * nv)
    fe = (fused._fext_lists(ms, em.inputs("fe", ms.nb * 6)) if fext
          else None)
    uc = [Bound(em, f"uc_[{i}]", "uc_") for i in range(nv)]
    dt = Sym(em, "dt")
    start = em.count
    q_new, qd_new, u = fused.feedback_lane(ms, x, xn, un, kf, K, dt, gravity,
                                           uc, fe)
    em.store("xo", list(q_new) + list(qd_new))
    em.store("uo", u)
    params = ("const T* x_, const T* xn_, const T* un_, const T* kf_, "
              "const T* K_, " + ("const T* fe_, " if fext else "")
              + "const T* uc_, const T dt, T* xo_, T* uo_")
    text = (f"void {tag}_body({params}) {{\n"
            + "\n".join(em.lines) + "\n}\n")
    return text, em.count - start


def _feedback_kernels(tag: str, fext: bool) -> str:
    fe_knot = "fe + (size_t)t * RBD_NB * 6, " if fext else ""
    return f"""
// K2: one thread a trajectory loops over the H knots; the knot body is
// inlined and every index of x and xn is a constant, so the state stays in
// registers from knot to knot
RBD_HD void {tag}_state(int b, const T* x0, const T* Xn, const T* Un,
                        const T* kf, const T* K, const T* fe, const T* uc,
                        T* Xo, T* Uo, int H, T dt) {{
  T x[RBD_NX], xn[RBD_NX];
#pragma unroll
  for (int i = 0; i < RBD_NX; ++i) x[i] = x0[(size_t)b * RBD_NX + i];
  for (int t = 0; t < H; ++t) {{
    const size_t bt = (size_t)b * H + t;
    {tag}_body(x, Xn + bt * RBD_NX, Un + bt * RBD_NV, kf + bt * RBD_NV,
               K + bt * RBD_NV * RBD_NDX, {fe_knot}uc, dt, xn,
               Uo + bt * RBD_NV);
#pragma unroll
    for (int i = 0; i < RBD_NX; ++i) {{
      x[i] = xn[i];
      Xo[bt * RBD_NX + i] = xn[i];
    }}
  }}
}}

#ifdef __CUDACC__
__global__ void __launch_bounds__(RBD_THREADS_MAX)
{tag}_kernel(const T* x0, const T* Xn, const T* Un, const T* kf, const T* K,
             const T* fe, const T* uc, T* Xo, T* Uo, int B, int H, T dt) {{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {tag}_state(b, x0, Xn, Un, kf, K, fe, uc, Xo, Uo, H, dt);
}}
#endif

extern "C" int rbd_static_{tag}(const T* x0, const T* Xn, const T* Un,
                                const T* kf, const T* K, const T* fe,
                                const T* uc, T* Xo, T* Uo, int B, int H,
                                int threads, T dt, rbd_stream s) {{
  if (B <= 0 || H <= 0) return 0;
#ifdef __CUDACC__
  if (threads < 1 || threads > RBD_THREADS_MAX) return 1;
  {tag}_kernel<<<(B + threads - 1) / threads, threads, 0, s>>>(
      x0, Xn, Un, kf, K, fe, uc, Xo, Uo, B, H, dt);
  return (int)cudaGetLastError();
#else
  for (int b = 0; b < B; ++b)
    {tag}_state(b, x0, Xn, Un, kf, K, fe, uc, Xo, Uo, H, dt);
  return 0;
#endif
}}
"""


def _lin_body(ms, ctype: str, gravity: float):
    """(C text of ``lin_body`` after its qualifier, operations it emits):
    one derivative column ``col`` of K3's knot, ``colvec.linearize_lane``
    with the column's one-hot the runtime value T(col == i).  It writes its
    column of dc/dq and dc/dqd, its column of M^-1's upper triangle with
    the mirror entries (rbdtpu's symmetrisation, colvec.py:365), and column
    0 writes qdd."""
    em = Emitter(ctype)
    q = em.inputs("q", ms.nq)
    qd = em.inputs("qd", ms.nv)
    u = em.inputs("u", ms.nv)
    masks = {}

    def oh(i: int):
        if i not in masks:
            em.lines.append(f"  const T oh{i} = T(col == {i});")
            masks[i] = Sym(em, f"oh{i}")
        return masks[i]

    start = em.count
    Minv, dcq, dcd, qdd = colvec.linearize_lane(ms, q, qd, u, oh, gravity)
    count = em.count - start
    for r in range(ms.nv):
        v = em.operand(Minv[r])
        em.lines.append(f"  if ({r} <= col) {{ mi_[{r} * RBD_NV + col] = {v};"
                        f" mi_[col * RBD_NV + {r}] = {v}; }}")
        em.lines.append(f"  dq_[{r} * RBD_NV + col] = {em.operand(dcq[r])};")
        em.lines.append(f"  dd_[{r} * RBD_NV + col] = {em.operand(dcd[r])};")
    em.lines.append("  if (col == 0) {")
    em.store("qdd", qdd)
    em.lines.append("  }")
    params = ("const T* q_, const T* qd_, const T* u_, const int col, "
              "T* mi_, T* dq_, T* dd_, T* qdd_")
    text = (f"void lin_body({params}) {{\n"
            + "\n".join(em.lines) + "\n}\n")
    return text, count


_LIN_KERNELS = """
RBD_HD void lin_thread(long long g, const T* q, const T* qd, const T* u,
                       T* mi, T* dq, T* dd, T* qdd) {
  const long long b = g / RBD_NV;
  const int col = (int)(g - b * RBD_NV);
  lin_body(q + b * RBD_NQ, qd + b * RBD_NV, u + b * RBD_NV, col,
           mi + b * RBD_NV * RBD_NV, dq + b * RBD_NV * RBD_NV,
           dd + b * RBD_NV * RBD_NV, qdd + b * RBD_NV);
}

#ifdef __CUDACC__
// K3: one thread a derivative column, RBD_NV threads a knot
__global__ void __launch_bounds__(RBD_THREADS_MAX)
lin_kernel(const T* q, const T* qd, const T* u, T* mi, T* dq, T* dd, T* qdd,
           long long n) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n) lin_thread(g, q, qd, u, mi, dq, dd, qdd);
}
#endif

extern "C" int rbd_linearize_parts_static(const T* q, const T* qd,
                                          const T* u, T* mi, T* dq, T* dd,
                                          T* qdd, int B, int threads,
                                          rbd_stream s) {
  if (B <= 0) return 0;
  const long long n = (long long)B * RBD_NV;
#ifdef __CUDACC__
  if (threads < 1 || threads > RBD_THREADS_MAX) return 1;
  lin_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      q, qd, u, mi, dq, dd, qdd, n);
  return (int)cudaGetLastError();
#else
  for (long long g = 0; g < n; ++g) lin_thread(g, q, qd, u, mi, dq, dd, qdd);
  return 0;
#endif
}
"""


def _ee_body(ms, jid: int, fid, gn: bool, ctype: str):
    """(C text of ``ee_<gn|err>_body`` after its qualifier, operations it
    emits): K4's body, ``fk_lane.ee_lane``, for one state with the target
    (tx, ty, tz) read at run time."""
    em = Emitter(ctype)
    q = em.inputs("q", ms.nq)
    target = [Sym(em, "tx"), Sym(em, "ty"), Sym(em, "tz")]
    start = em.count
    e, g0, H0 = fk_lane.ee_lane(ms, q, jid, fid, target, gn)
    count = em.count - start
    em.store("e", e)
    if gn:
        em.store("g", g0)
        em.store("h", [v for row in H0 for v in row])
    name = "ee_gn" if gn else "ee_err"
    params = ("const T* q_, const T tx, const T ty, const T tz, T* e_"
              + (", T* g_, T* h_" if gn else ""))
    text = (f"void {name}_body({params}) {{\n"
            + "\n".join(em.lines) + "\n}\n")
    return text, count


def _ee_kernels(gn: bool) -> str:
    name = "ee_gn" if gn else "ee_err"
    outs = "T* e, T* g0, T* H0" if gn else "T* e"
    out_args = "e, g0, H0" if gn else "e"
    body_outs = ("e + (size_t)b * 3, g0 + (size_t)b * RBD_NV, "
                 "H0 + (size_t)b * RBD_NV * RBD_NV" if gn
                 else "e + (size_t)b * 3")
    return f"""
RBD_HD void {name}_state(int b, const T* q, T tx, T ty, T tz, {outs}) {{
  {name}_body(q + (size_t)b * RBD_NQ, tx, ty, tz, {body_outs});
}}

#ifdef __CUDACC__
__global__ void __launch_bounds__(RBD_THREADS_MAX)
{name}_kernel(const T* q, T tx, T ty, T tz, {outs}, int B) {{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {name}_state(b, q, tx, ty, tz, {out_args});
}}
#endif

extern "C" int rbd_{name}_static(const T* q, T tx, T ty, T tz, {outs},
                                 int B, int threads, rbd_stream s) {{
  if (B <= 0) return 0;
#ifdef __CUDACC__
  if (threads < 1 || threads > RBD_THREADS_MAX) return 1;
  {name}_kernel<<<(B + threads - 1) / threads, threads, 0, s>>>(
      q, tx, ty, tz, {out_args}, B);
  return (int)cudaGetLastError();
#else
  for (int b = 0; b < B; ++b) {name}_state(b, q, tx, ty, tz, {out_args});
  return 0;
#endif
}}
"""


_ENTRY = """
// the C entry points, with the table kernels' signatures less the tables,
// the shared memory and the gravity (folded into the code)
extern "C" int rbd_static_rnea_bias(const T*, const T*, const T*, T*, int,
                                    int, rbd_stream);
extern "C" int rbd_static_rnea_qdd(const T*, const T*, const T*, T*, int,
                                   int, rbd_stream);
#define RBD_STEP(tag) extern "C" int rbd_static_step_##tag( \\
    const T*, const T*, const T*, int, T*, int, int, T, rbd_stream);
RBD_STEP(aba) RBD_STEP(aba_fext) RBD_STEP(minv) RBD_STEP(minv_fext)
RBD_STEP(dense) RBD_STEP(dense_fext)
#define RBD_ROLLOUT(tag) extern "C" int rbd_static_rollout_##tag( \\
    const T*, const T*, const T*, T*, int, int, int, T, rbd_stream);
RBD_ROLLOUT(aba) RBD_ROLLOUT(aba_fext) RBD_ROLLOUT(minv)
RBD_ROLLOUT(minv_fext)

extern "C" int rbd_rnea_static(const T* q, const T* qd, const T* qdd,
                               T* tau, int B, int threads, rbd_stream s) {
  return qdd ? rbd_static_rnea_qdd(q, qd, qdd, tau, B, threads, s)
             : rbd_static_rnea_bias(q, qd, qdd, tau, B, threads, s);
}

extern "C" int rbd_fd_step_static(const T* x, const T* u, const T* fe,
                                  int stride, T* xo, int B, int threads,
                                  T dt, rbd_stream s) {
  return fe ? rbd_static_step_aba_fext(x, u, fe, stride, xo, B, threads, dt,
                                       s)
            : rbd_static_step_aba(x, u, fe, stride, xo, B, threads, dt, s);
}

extern "C" int rbd_fd_step_minv_static(const T* x, const T* u, const T* fe,
                                       int stride, T* xo, int B, int dense,
                                       int threads, T dt, rbd_stream s) {
  if (dense)
    return fe ? rbd_static_step_dense_fext(x, u, fe, stride, xo, B, threads,
                                           dt, s)
              : rbd_static_step_dense(x, u, fe, stride, xo, B, threads, dt,
                                      s);
  return fe ? rbd_static_step_minv_fext(x, u, fe, stride, xo, B, threads, dt,
                                        s)
            : rbd_static_step_minv(x, u, fe, stride, xo, B, threads, dt, s);
}

#define RBD_FEEDBACK(tag) extern "C" int rbd_static_##tag( \\
    const T*, const T*, const T*, const T*, const T*, const T*, const T*, \\
    T*, T*, int, int, int, T, rbd_stream);
RBD_FEEDBACK(feedback) RBD_FEEDBACK(feedback_fext)

extern "C" int rbd_feedback_rollout_static(const T* x0, const T* Xn,
                                           const T* Un, const T* kf,
                                           const T* K, const T* fe,
                                           const T* uc, T* Xo, T* Uo, int B,
                                           int H, int threads, T dt,
                                           rbd_stream s) {
  return fe ? rbd_static_feedback_fext(x0, Xn, Un, kf, K, fe, uc, Xo, Uo, B,
                                       H, threads, dt, s)
            : rbd_static_feedback(x0, Xn, Un, kf, K, fe, uc, Xo, Uo, B, H,
                                  threads, dt, s);
}

extern "C" int rbd_rollout_multi_static(const T* x0, const T* U,
                                        const T* fe, T* xo, int B, int H,
                                        int minv, int threads, T dt,
                                        rbd_stream s) {
  if (minv)
    return fe ? rbd_static_rollout_minv_fext(x0, U, fe, xo, B, H, threads,
                                             dt, s)
              : rbd_static_rollout_minv(x0, U, fe, xo, B, H, threads, dt, s);
  return fe ? rbd_static_rollout_aba_fext(x0, U, fe, xo, B, H, threads, dt,
                                          s)
            : rbd_static_rollout_aba(x0, U, fe, xo, B, H, threads, dt, s);
}
"""


def _head(model, dtype, what: str) -> tuple:
    """(ModelStatic, C type, the sources' common head)."""
    if dtype not in _CTYPE:
        raise ValueError(f"the specialised kernels take float32 or float64, "
                         f"got {dtype}")
    ms = fused.get_static(model)
    ctype = _CTYPE[dtype]
    root = ("quaternion root" if ms.quat else "rpy root" if ms.fb
            else "fixed base")
    head = (f"// model-specialised kernels of '{model.name}' ({ms.nb} "
            f"bodies, {root}), {ctype}, {what}: generated by "
            f"rbdtpu_torch/kernels/codegen.py\n" + _PRELUDE
            + f"typedef {ctype} T;\n#define RBD_NB {ms.nb}\n"
            f"#define RBD_NQ {ms.nq}\n#define RBD_NV {ms.nv}\n"
            f"#define RBD_NX {ms.nq + ms.nv}\n#define RBD_NDX {2 * ms.nv}\n"
            f"#define RBD_THREADS_MAX {_lib.STATIC_THREADS}\n")
    return ms, ctype, head


def generate(model, dtype, gravity: float = -9.81) -> Generated:
    """The specialised kernels' sources for ``model`` in ``dtype`` (float32
    or float64) under ``gravity``, from the model's ``ModelStatic``: the
    step bodies and K5's routes (``BODIES``), K2's knot body without and
    with wrenches (``feedback.cu``, ``feedback_fext.cu``), K3's column body
    (``linearize.cu``) and ``entry.cu``."""
    ms, ctype, head = _head(model, dtype, f"gravity {gravity!r}")
    sources, ops = {}, {}
    for tag, kind, fext in BODIES:
        body, ops[tag] = _body(ms, tag, kind, fext, ctype, gravity)
        kernels = (_rnea_kernels(tag) if kind == "rnea"
                   else _step_kernels(tag, fext))
        sources[f"{tag}.cu"] = head + "\nRBD_DEV " + body + kernels
        if tag in ROLLOUT_BODIES:
            sources[f"{tag}_rollout.cu"] = (head + "\nRBD_HD " + body
                                            + _rollout_kernels(tag, fext))
    for tag, fext in FEEDBACK_BODIES:
        body, ops[tag] = _feedback_body(ms, tag, fext, ctype, gravity)
        sources[f"{tag}.cu"] = (head + "\nRBD_HD " + body
                                + _feedback_kernels(tag, fext))
    body, ops["linearize"] = _lin_body(ms, ctype, gravity)
    sources["linearize.cu"] = head + "\nRBD_HD " + body + _LIN_KERNELS
    sources["entry.cu"] = head + _ENTRY
    return Generated(sources, ops)


def generate_ee(model, dtype, jid: int, fid) -> Generated:
    """K4's specialised sources for the effector at joint ``jid`` (and
    fixed frame ``fid``, or None) of ``model`` in ``dtype``: ``ee_gn.cu``
    and ``ee_err.cu``, with the C entry points ``rbd_ee_gn_static`` (q tx
    ty tz e g0 H0 B threads stream) and ``rbd_ee_err_static`` (q tx ty tz e
    B threads stream).  The chain takes no gravity."""
    ms, ctype, head = _head(model, dtype,
                            f"effector joint {jid}, fixed frame {fid}")
    sources, ops = {}, {}
    for gn in (True, False):
        name = "ee_gn" if gn else "ee_err"
        body, ops[name] = _ee_body(ms, jid, fid, gn, ctype)
        sources[f"{name}.cu"] = (head + "\nRBD_HD " + body
                                 + _ee_kernels(gn))
    return Generated(sources, ops)
