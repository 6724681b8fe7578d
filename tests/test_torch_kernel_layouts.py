"""Launch geometry and shared-memory layouts of K3 (``linearize_parts``),
K9 (``feedback_chunked``), the Riccati sweep (``riccati``, K7/K8) and K11
(``riccati_fused``): ``rbdtpu_torch.kernels._lib`` gives each launch's
threads, blocks and shared bytes, and the CUDA launch refuses any other
count.  The C layouts are compiled for the host with g++ and held against
their Python twins, and K9's and K11's per-thread code, built for the host,
against the plain versions.  Needs no card and no JAX."""
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rbdtpu_torch.kernels import _lib
from rbdtpu_torch.model import parse_urdf

DTYPES = (torch.float32, torch.float64)
BATCHES = (1, 4, 16, 37, 70, 128, 256, 1024, 8192)
# the sweep's shapes: configs[3], the humanoid paths, arm7, odd sizes
SWEEP_SHAPES = ((36, 18), (72, 36), (14, 7), (13, 5), (6, 1), (10, 4))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("cls", list(_lib.SIZE_CLASSES))
def test_linearize_geometry(cls, dtype):
    """One team a knot, of the class's team size, at most one warp of teams
    a block; a team's shared memory holds what the columns read of the ABA
    step (31 values a body), then the larger of the team step's scratch (96
    a body) and one 18-value slot a tree level for each lane's column, and
    M^-1, padded to the teams' bank offset; the block's is its teams',
    within the H100's 232,448 bytes; the grid covers every batch exactly,
    and a batch that could give every SM a block does."""
    team = _lib.TEAM[("linearize_parts", cls, _lib._SUFFIX[dtype])]
    assert team in _lib.TEAM_SIZES
    nb, fb, kernels = _lib.SIZE_CLASSES[cls]
    assert "linearize_parts" in kernels
    nv = nb + 5 if fb else nb
    values = _lib.linearize_values(cls, team)
    assert values >= 31 * nb + max(96 * nb, 18 * _lib.LIN_LEVELS[cls] * team)
    assert values >= 31 * nb + nv * nv
    assert values % 32 == team % 32
    per = values * torch.finfo(dtype).bits // 8
    for B in BATCHES:
        t, tpb, smem, blocks = _lib.linearize_geometry(cls, dtype, B)
        assert t == team and 1 <= tpb and tpb * team <= 32
        assert smem == tpb * per <= _lib.SMEM_MAX
        assert blocks * tpb >= B > (blocks - 1) * tpb
        if B >= _lib.H100_SMS:
            assert blocks >= _lib.H100_SMS
    assert _lib.linearize_geometry(cls, dtype, 1)[1:] == (1, per, 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("nx,nu", SWEEP_SHAPES,
                         ids=[f"{n}-{m}" for n, m in SWEEP_SHAPES])
def test_riccati_geometry(nx, nu, dtype):
    """One block a problem of whole warps, 64-256 threads, enough for every
    thread's elimination entries to sit in registers; the grid covers every
    problem; the block's shared memory is the layout's, within 232,448
    bytes at every shape the paths take (the humanoid's nx = 72 in double
    included); no count of threads gives fewer waves than the one taken."""
    size = torch.finfo(dtype).bits // 8
    smem = _lib.riccati_values(nx, nu) * size
    per_sm = lambda nt: min(65536 // (_lib.RIC_REGS * nt),
                            _lib.SM_SMEM // (smem + _lib.BLOCK_SMEM_RESERVED),
                            2048 // nt, 32)
    waves = lambda nt, B: -(-B // (_lib.H100_SMS * per_sm(nt)))
    for B in BATCHES:
        nt, sm, blocks = _lib.riccati_geometry(nx, nu, dtype, B)
        assert nt % 32 == 0 and 64 <= nt <= 256 and blocks == B
        assert nt * _lib.RIC_TRI >= nu * (nu + 1) // 2
        assert sm == smem <= _lib.SMEM_MAX
        assert all(waves(nt, B) <= waves(t, B) for t in range(64, 257, 32))
    # configs[3]'s 1024 problems in one wave of eight blocks an SM, path D's
    # 256 in one of two
    if dtype == torch.float32:
        assert _lib.riccati_geometry(36, 18, dtype, 1024)[0] == 64
        assert _lib.riccati_geometry(72, 36, dtype, 256)[0] == 256


def test_riccati_values_hold_the_sweep():
    """The sweep's shared memory holds at least the carry, [A | B], the
    products' region and the Q blocks: n^2 + 2 n (n + m) + m n + m^2."""
    for nx, nu in SWEEP_SHAPES:
        assert _lib.riccati_values(nx, nu) >= (
            nx * nx + 2 * nx * (nx + nu) + nu * nx + nu * nu)


def _chain_urdf(n: int) -> str:
    """A chain of n revolute joints."""
    links = "".join(
        f'<link name="l{i}"><inertial><mass value="1"/><inertia ixx="0.01" '
        f'iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial></link>'
        for i in range(n + 1))
    joints = "".join(
        f'<joint name="j{i}" type="revolute"><origin xyz="0 0 0.1"/>'
        f'<parent link="l{i}"/><child link="l{i + 1}"/><axis xyz="0 1 0"/>'
        f'</joint>' for i in range(n))
    return f'<robot name="chain">{links}{joints}</robot>'


def test_linearize_size_class_counts_levels():
    """K3's column sweeps keep one slot a tree level: a floating chain of 9
    levels skips fb16 (8 levels) for fb32, one of 13 levels is refused by
    name, and the team kernels still take both by bodies alone."""
    deep = parse_urdf(_chain_urdf(8), device="cpu", dtype=torch.float64,
                      floating_base=True)
    assert deep.nb == 9 and max(_lib.tree_depths(deep)) + 1 == 9
    assert _lib.size_class("linearize_parts", deep) == "fb32"
    assert _lib.size_class("fd_step", deep) == "fb16"
    deeper = parse_urdf(_chain_urdf(12), device="cpu", dtype=torch.float64,
                        floating_base=True)
    with pytest.raises(ValueError, match="13 levels"):
        _lib.size_class("linearize_parts", deeper)
    assert _lib.size_class("feedback_rollout", deeper) == "fb16"


_PROGRAM = r"""
#include <cstdio>
#include "riccati_chunk.cu"
#include "linearize.cu"
int main() {
  const int shapes[][2] = {%s};
  for (const auto& s : shapes) std::printf("%%d\n", rbd::riccati_smem_values(s[0], s[1]));
  %s
  return 0;
}
"""


def test_c_layouts_match_python(tmp_path):
    """riccati_layout and LinLayout, compiled for the host from the
    sources in csrc/, give the shared-memory counts that _lib computes:
    the sweep's at every shape above, K3's at every class and team size."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    dims = {"n8": "N8", "fb16": "FB16", "fb32": "FB32"}
    lin = [(cls, team) for cls in _lib.SIZE_CLASSES for team in _lib.TEAM_SIZES]
    src = _PROGRAM % (
        ", ".join(f"{{{n}, {m}}}" for n, m in SWEEP_SHAPES),
        "\n  ".join(f'std::printf("%d\\n", rbd::LinLayout<rbd::{dims[c]}, '
                    f'{t}>::STRIDE);' for c, t in lin))
    (tmp_path / "layouts.cpp").write_text(src)
    exe = tmp_path / "layouts"
    subprocess.run([cxx, "-std=c++17", "-x", "c++", "-I", _lib.CSRC,
                    "-o", str(exe), str(tmp_path / "layouts.cpp")],
                   check=True, capture_output=True, timeout=120)
    got = [int(v) for v in subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True,
        timeout=60).stdout.split()]
    want = ([_lib.riccati_values(n, m) for n, m in SWEEP_SHAPES]
            + [_lib.linearize_values(c, t) for c, t in lin])
    assert got == want


# K9 (feedback_chunked) runs K2's team body: its geometry at every class
# and dtype over the batches of the paths and chip_smoke.py (path D's 1024,
# the quadruped's 6144, odd and single trajectories)
LINE_BATCHES = (1, 37, 67, 142 * 4 - 3, 1024, 1021, 6144, 8192)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("cls", list(_lib.SIZE_CLASSES))
def test_feedback_chunked_geometry(cls, dtype):
    """One team of the class's team size a trajectory, at most one warp of
    teams a block; a team holds what K2's does (one team body), within the
    H100's 232,448 bytes a block; the grid covers every batch exactly, and
    a batch that could give every SM a block does."""
    assert "feedback_chunked" in _lib.SIZE_CLASSES[cls][2]
    team = _lib.TEAM[("feedback_chunked", cls, _lib._SUFFIX[dtype])]
    assert team in _lib.TEAM_SIZES
    assert (_lib.team_values("feedback_chunked", cls, team)
            == _lib.team_values("feedback_rollout", cls, team))
    per = (_lib.team_values("feedback_chunked", cls, team)
           * torch.finfo(dtype).bits // 8)
    for B in LINE_BATCHES:
        t, tpb, smem, blocks = _lib.team_geometry("feedback_chunked", cls,
                                                  dtype, B)
        assert t == team and 1 <= tpb and tpb * team <= 32
        assert smem == tpb * per <= _lib.SMEM_MAX
        assert blocks * tpb >= B > (blocks - 1) * tpb
        if B >= _lib.H100_SMS:
            assert blocks >= _lib.H100_SMS
    assert _lib.team_geometry("feedback_chunked", cls, dtype, 1)[1:] == (
        1, per, 1)


# K11's shapes: configs[2] (arm7), an odd state, the largest it takes,
# one control, and more controls than states
K11_SHAPES = ((14, 7), (13, 5), (16, 16), (6, 1), (10, 20))
K11_BATCHES = (1, 4, 37, 128, 133, 1024)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("nx,nu", K11_SHAPES,
                         ids=[f"{n}-{m}" for n, m in K11_SHAPES])
def test_riccati_fused_geometry(nx, nu, dtype):
    """One block a problem of 64-256 threads in whole warps; the grid covers
    every problem; the block's shared memory is the layout's (two stage
    buffers, the carry, the products, the solve and three entry tables)
    within 232,448 bytes; no count of threads gives fewer waves than the
    one taken, and configs[2]'s 128 problems, path B's one and the parity
    batch's four take 256 threads."""
    size = torch.finfo(dtype).bits // 8
    values = _lib.riccati_fused_values(nx, nu)
    assert values >= (2 * (2 * nx * nx + 2 * nx * nu + nx + nu + nu * nu)
                      + nx * nx + (nx + 1) * (nx + nu) + nu * (nu + nx + 1))
    smem = values * size
    per_sm = lambda nt: min(65536 // (_lib.RIC_REGS * nt),
                            _lib.SM_SMEM // (smem + _lib.BLOCK_SMEM_RESERVED),
                            2048 // nt, 32)
    waves = lambda nt, B: -(-B // (_lib.H100_SMS * per_sm(nt)))
    for B in K11_BATCHES:
        nt, sm, blocks = _lib.riccati_fused_geometry(nx, nu, dtype, B)
        assert nt % 32 == 0 and 64 <= nt <= 256 and blocks == B
        assert sm == smem <= _lib.SMEM_MAX
        assert all(waves(nt, B) <= waves(t, B) for t in range(64, 257, 32))
    if (nx, nu) == (14, 7):
        for B in (1, 4, 128):
            assert _lib.riccati_fused_geometry(nx, nu, dtype, B)[0] == 256


# A host build of K9's team body (feedback_team.cuh, K9's chunked sum) on a
# team of 8 std::threads, and of K11's block body on one thread, each
# behind a plain C entry point.
_HOST = r"""
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

struct HostBarrier {
  std::mutex mu;
  std::condition_variable cv;
  int n, count = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    const int g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
static HostBarrier* g_bar;
#define RBD_TEAM_HOST_SYNC() g_bar->wait()
#include "feedback_chunked.cu"
#include "riccati_fused.cu"

template <class D, bool LV>
static void k9(const double* tab, const int* itab, int nb, const double* x0,
               const double* Xn, const double* Un, const double* kf, const double* Kf,
               const double* uclip, double* Xo, double* Uo, int B, int H, int cw, double dt,
               double g) {
  constexpr int NL = 8;
  const rbd::Model<double, D> m{tab, itab, nb};
  const int n = m.nv(), nx = 2 * n;
  std::vector<double> s(rbd::feedback_team_stride<D, NL>());
  for (int b = 0; b < B; ++b) {
    HostBarrier bar;
    bar.n = NL;
    g_bar = &bar;
    const size_t bx = (size_t)b * H * nx, bu = (size_t)b * H * n;
    std::vector<std::thread> th;
    for (int lane = 0; lane < NL; ++lane)
      th.emplace_back([&, lane] {
        rbd::feedback_rollout_team<NL, LV>(rbd::Team<NL>{lane, 0u}, m, s.data(),
                                           x0 + (size_t)b * nx, Xn + bx, Un + bu, kf + bu,
                                           Kf + bu * nx, uclip, Xo + bx, Uo + bu, H, dt, g,
                                           rbd::ChunkSum{cw});
      });
    for (auto& t : th) t.join();
  }
}

#define HOST_K9(CLS, D)                                                                  \
  extern "C" void host_k9_##CLS(const double* tab, const int* itab, int nb,              \
                                const double* x0, const double* Xn, const double* Un,    \
                                const double* kf, const double* Kf, const double* uclip, \
                                double* Xo, double* Uo, int B, int H, int cw, int lv,    \
                                double dt, double g) {                                   \
    (lv ? k9<rbd::D, true> : k9<rbd::D, false>)(tab, itab, nb, x0, Xn, Un, kf, Kf,      \
                                                 uclip, Xo, Uo, B, H, cw, dt, g);        \
  }
HOST_K9(n8, N8)
HOST_K9(fb16, FB16)

extern "C" void host_k11(const double* A, const double* Bm, const double* lx,
                         const double* lu, const double* lxx, int lxx_sb, int lxx_st,
                         const double* luu, int luu_sb, int luu_st, const double* lux,
                         int lux_sb, int lux_st, const double* lfx, const double* lfxx,
                         const double* reg, double* k, double* K, double* dV1,
                         unsigned char* ok, int B, int H, int nx, int nu) {
  std::vector<double> sm(rbd::k11::smem_values(nx, nu));
  for (int b = 0; b < B; ++b)
    rbd::k11::sweep<double>(0, 1, sm.data(), b, A, Bm, lx, lu, lxx, lxx_sb, lxx_st, luu,
                            luu_sb, luu_st, lux, lux_sb, lux_st, lfx, lfxx, reg, k, K, dV1,
                            ok, H, nx, nu);
}

extern "C" int host_k11_values(int nx, int nu) { return rbd::k11::smem_values(nx, nu); }
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The host build of K9's and K11's bodies, loaded with ctypes."""
    import ctypes

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "host.cpp").write_text(_HOST)
    so = d / "libhost.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    "-I", _lib.CSRC, "-o", str(so), str(d / "host.cpp"),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.host_k9_n8, lib.host_k9_fb16):
        fn.argtypes = [P, P, I] + [P] * 8 + [I, I, I, I, D, D]
    lib.host_k11.argtypes = ([P] * 5 + [I, I, P, I, I, P, I, I] + [P] * 7
                             + [I] * 4)
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("nchunks", [1, 2, 3, "ndx"])
@pytest.mark.parametrize("name", ["arm7", "quadruped12"])
def test_host_feedback_chunked(host_kernels, name, nchunks):
    """K9's team body, built for the host and run by a team of 8 threads,
    against ``feedback_rollout_chunked_plain`` in float64 (1e-9), with and
    without a clamp, on arm7 (n8, body by body) and the rpy quadruped
    (fb16, level by level) at every chunk count up to one a column."""
    from rbdtpu_torch.kernels import fused
    from rbdtpu_torch.model import load_asset

    fb = name == "quadruped12"
    m = load_asset(name, device="cpu", dtype=torch.float64, floating_base=fb)
    nch = m.nx if nchunks == "ndx" else nchunks
    cw, _ = fused.chunk_geometry(m.nx, nch)
    tab, itab = _lib.model_tables(m, "cpu", torch.float64)
    rng = np.random.default_rng(3 + nch)
    B, H = 3, 4
    T = lambda *s: torch.tensor(0.1 * rng.standard_normal(s))
    x0 = T(B, m.nx)
    if fb:
        x0[:, 2] += 0.4
    args = (x0, T(B, H, m.nx), T(B, H, m.nv), T(B, H, m.nv),
            T(B, H, m.nv, m.nx))
    fn = host_kernels.host_k9_fb16 if fb else host_kernels.host_k9_n8
    for clip in (None, torch.full((m.nv,), 0.05, dtype=torch.float64)):
        Xo = torch.empty(B, H, m.nx, dtype=torch.float64)
        Uo = torch.empty(B, H, m.nv, dtype=torch.float64)
        fn(_ptr(tab), _ptr(itab), m.nb, *[_ptr(a) for a in args], _ptr(clip),
           _ptr(Xo), _ptr(Uo), B, H, cw, int(_lib.level_walk(m)), 0.01,
           -9.81)
        Xp, Up = fused.feedback_rollout_chunked_plain(
            m, *args, 0.01, u_clip=clip, nchunks=nch)
        torch.testing.assert_close(Xo, Xp, rtol=0, atol=1e-9)
        torch.testing.assert_close(Uo, Up, rtol=0, atol=1e-9)


@pytest.mark.parametrize("nx,nu,const,non_pd", [
    (14, 7, False, None), (13, 5, True, None), (14, 7, False, (1, 3))],
    ids=["arm7", "odd-constant", "non-pd"])
def test_host_riccati_fused(host_kernels, nx, nu, const, non_pd):
    """K11's block body, built for the host and run by one thread, against
    ``solver.ddp.backward_pass`` in float64 (1e-9 relative to each output's
    scale), with per-knot and constant cost blocks; a non-PD Quu gives the
    plain sweep's NaN pattern and ok; its layout count is
    ``_lib.riccati_fused_values``'s."""
    from riccati_problems import riccati_problem
    from rbdtpu_torch.solver.ddp import backward_pass

    assert all(host_kernels.host_k11_values(n, m)
               == _lib.riccati_fused_values(n, m) for n, m in K11_SHAPES)
    B, H = 3, 6
    prob = [torch.tensor(a) for a in riccati_problem(
        np.random.default_rng(nx + nu), nx, nu, H, B, const, non_pd)]
    A, Bm, lx, lu, lxx, luu, lux, lfx, lfxx, reg = prob
    out = (torch.empty(B, H, nu, dtype=torch.float64),
           torch.empty(B, H, nu, nx, dtype=torch.float64),
           torch.empty(B, dtype=torch.float64),
           torch.empty(B, dtype=torch.bool))
    blocks = []
    for a, r, c in ((lxx, nx, nx), (luu, nu, nu), (lux, nu, nx)):
        blocks += [_ptr(a), 0, 0] if a.dim() == 2 else [_ptr(a), H * r * c,
                                                        r * c]
    host_kernels.host_k11(_ptr(A), _ptr(Bm), _ptr(lx), _ptr(lu), *blocks,
                          _ptr(lfx), _ptr(lfxx), _ptr(reg),
                          *[_ptr(o) for o in out], B, H, nx, nu)
    ref = backward_pass(*prob)
    assert out[3].tolist() == ref[3].tolist() == [
        non_pd is None or i != non_pd[0] for i in range(B)]
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a.isnan(), b.isnan())
        scale = max(1.0, b.nan_to_num(0).abs().max().item())
        assert (a - b).nan_to_num(0).abs().max().item() <= 1e-9 * scale
