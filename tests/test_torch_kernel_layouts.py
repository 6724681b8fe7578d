"""Launch geometry and shared-memory layouts of K3 (``linearize_parts``),
K4 (``ee_gn``, ``ee_err``), K5 (``rollout_multi``), K6 (``fd_step_minv``),
K9 (``feedback_chunked``), K10 (``rnea``), the Riccati sweep (``riccati``,
K7/K8) and K11 (``riccati_fused``): ``rbdtpu_torch.kernels._lib`` gives
each launch's threads, blocks and shared bytes, and the CUDA launch
refuses any other count.  The C layouts are compiled for the host with g++
and held against their Python twins, and K4's, K5's, K6's, K9's, K10's and
K11's per-thread code, built for the host, against the plain versions.
Needs no card and no JAX."""
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
#include "rollout_multi.cu"
#include "ee_gn.cu"
#include "rnea.cu"
#include "fd_step_minv.cu"
int main() {
  const int shapes[][2] = {%s};
  for (const auto& s : shapes) std::printf("%%d\n", rbd::riccati_smem_values(s[0], s[1]));
  %s
  return 0;
}
"""


def test_c_layouts_match_python(tmp_path):
    """riccati_layout, LinLayout, K5's, K6's and K10's team strides and
    K4's staging, compiled for the host from the sources in csrc/, give the
    shared-memory counts that _lib computes: the sweep's at every shape
    above, K3's, K6's (both routes) and K10's at every class and team size,
    K5's at every team size, K4's a state of each kernel."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    dims = {"n8": "N8", "fb16": "FB16", "fb32": "FB32"}
    lin = [(cls, team) for cls in _lib.SIZE_CLASSES for team in _lib.TEAM_SIZES]
    show = lambda expr: f'std::printf("%d\\n", {expr});'
    src = _PROGRAM % (
        ", ".join(f"{{{n}, {m}}}" for n, m in SWEEP_SHAPES),
        "\n  ".join(
            [show(f"rbd::LinLayout<rbd::{dims[c]}, {t}>::STRIDE")
             for c, t in lin]
            + [show(f"rbd::rollout_multi_team_stride<{t}>()")
               for t in _lib.TEAM_SIZES]
            + [show(f"rbd::ee_state_values<{gn}>()")
               for gn in ("true", "false")]
            + [show("rbd::EE_FIXED")]
            + [show(f"rbd::rnea_team_stride<rbd::{dims[c]}, {t}>()")
               for c, t in lin]
            + [show(f"rbd::MinvStepLayout<rbd::{dims[c]}, {t}, {d}>::STRIDE")
               for c, t in lin for d in ("false", "true")]))
    (tmp_path / "layouts.cpp").write_text(src)
    exe = tmp_path / "layouts"
    subprocess.run([cxx, "-std=c++17", "-x", "c++", "-I", _lib.CSRC,
                    "-o", str(exe), str(tmp_path / "layouts.cpp")],
                   check=True, capture_output=True, timeout=120)
    got = [int(v) for v in subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True,
        timeout=60).stdout.split()]
    want = ([_lib.riccati_values(n, m) for n, m in SWEEP_SHAPES]
            + [_lib.linearize_values(c, t) for c, t in lin]
            + [_lib.team_values("rollout_multi", "n8", t)
               for t in _lib.TEAM_SIZES]
            + [_lib.ee_values("ee_gn"), _lib.ee_values("ee_err"),
               _lib.EE_FIXED]
            + [_lib.team_values("rnea", c, t) for c, t in lin]
            + [_lib.team_values("fd_step_minv", c, t, d) for c, t in lin
               for d in (False, True)])
    assert got == want


_PROGRAM_FEXT_RPY = r"""
#include <cstdio>
#include "feedback_chunked.cu"
#include "ee_gn.cu"
int main() {
  %s
  return 0;
}
"""


def test_c_layouts_fext_and_rpy_match_python(tmp_path):
    """K2's and K9's team stride with the wrenches' chain at every class and
    team size, the block's wrench stages at every class, and K4's rpy-root
    staging (its fixed values and a state's of each kernel), compiled for
    the host from csrc/, give the counts _lib computes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    dims = {"n8": "N8", "fb16": "FB16", "fb32": "FB32"}
    lin = [(cls, team) for cls in _lib.SIZE_CLASSES for team in _lib.TEAM_SIZES]
    show = lambda expr: f'std::printf("%d\\n", {expr});'
    src = _PROGRAM_FEXT_RPY % "\n  ".join(
        [show(f"rbd::feedback_team_stride<rbd::{dims[c]}, {t}, true>()")
         for c, t in lin]
        + [show(f"rbd::feedback_wrench_values<rbd::{dims[c]}>()")
           for c in dims]
        + [show(f"rbd::ee_rpy_state_values<{gn}>()")
           for gn in ("true", "false")]
        + [show("rbd::EE_FIXED_RPY")])
    (tmp_path / "layouts.cpp").write_text(src)
    exe = tmp_path / "layouts"
    subprocess.run([cxx, "-std=c++17", "-x", "c++", "-I", _lib.CSRC,
                    "-o", str(exe), str(tmp_path / "layouts.cpp")],
                   check=True, capture_output=True, timeout=120)
    got = [int(v) for v in subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True,
        timeout=60).stdout.split()]
    want = ([_lib.team_values("feedback_rollout_fext", c, t) for c, t in lin]
            + [_lib.block_values("feedback_chunked_fext", c) for c in dims]
            + [_lib.ee_values("ee_gn", "fb16"), _lib.ee_values("ee_err", "fb16"),
               _lib.ee_fixed("fb16")])
    assert got == want


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("cls", list(_lib.SIZE_CLASSES))
def test_feedback_fext_geometry(cls, dtype):
    """K2 and K9 with wrenches, at every class: the wrench-free kernel's
    team size and its team's values (the wrenches' chain reuses the
    articulated inertias' values), both kernels alike; a block keeps two
    stages of the wrench set (12 values a body of the class, rounded to
    32) ahead of at most one warp of teams,
    within 232,448 bytes; the grid covers every batch exactly, and a batch
    that could give every SM a block does."""
    nb = _lib.SIZE_CLASSES[cls][0]
    size = torch.finfo(dtype).bits // 8
    extra = _lib.block_values("feedback_rollout_fext", cls)
    assert extra == _lib.block_values("feedback_chunked_fext", cls)
    assert extra >= 12 * nb and extra % 32 == 0
    assert _lib.block_values("feedback_rollout", cls) == 0
    for kernel in ("feedback_rollout_fext", "feedback_chunked_fext"):
        assert kernel in _lib.SIZE_CLASSES[cls][2]
        team = _lib.TEAM[(kernel, cls, _lib._SUFFIX[dtype])]
        plain = kernel[:-len("_fext")]
        assert team == _lib.TEAM[(plain, cls, _lib._SUFFIX[dtype])]
        values = _lib.team_values(kernel, cls, team)
        assert values == _lib.team_values(plain, cls, team)
        per = values * size
        for B in LINE_BATCHES:
            t, tpb, smem, blocks = _lib.team_geometry(kernel, cls, dtype, B)
            assert t == team and 1 <= tpb and tpb * team <= 32
            assert smem == tpb * per + extra * size <= _lib.SMEM_MAX
            assert blocks * tpb >= B > (blocks - 1) * tpb
            if B >= _lib.H100_SMS:
                assert blocks >= _lib.H100_SMS


@pytest.mark.parametrize("kernel", ["ee_gn", "ee_err"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_ee_rpy_geometry(kernel, dtype):
    """K4 on the rpy root (fb16): a multiple of four states a block, 8
    lanes a state for ee_gn and one for ee_err, within the launch bounds;
    a block stages the walk rows of the class's 16 bodies and the mount,
    then a state's q (nv = 21 at the bound) and e, and for ee_gn g0, H0 and
    J, within 48 KB; the grid covers every batch, and path E's batches
    (51,200 knots, 313,344 line-search states) take the most states a
    block that fit."""
    per = _lib.ee_values(kernel, "fb16")
    assert per == (2 * 21 + 3 + 21 * 21 + 3 * 21 if kernel == "ee_gn"
                   else 21 + 3)
    lanes, most = (8, 256) if kernel == "ee_gn" else (1, 128)
    size = torch.finfo(dtype).bits // 8
    fixed = _lib.ee_fixed("fb16")
    assert fixed == 15 * 16 + 12 and fixed % 4 == 0
    for B in (*EE_BATCHES, 51200, 6 * 1024 * 51):
        spb, threads, smem, blocks = _lib.ee_geometry(kernel, dtype, B,
                                                      cls="fb16")
        assert spb % 4 == 0 and threads == spb * lanes <= most
        assert smem == (fixed + spb * per) * size <= _lib.EE_SMEM_MAX
        assert blocks * spb >= B > (blocks - 1) * spb
    top = _lib.ee_geometry(kernel, dtype, 51200, cls="fb16")[0]
    assert (fixed + 2 * top * per) * size > _lib.EE_SMEM_MAX or (
        top == _lib.EE_STATES_RPY[kernel][0])


# K5's and K4's batches: one state, an odd batch, the rollout path's 4096
# and one more; K4 also the paths' terminal (128), knot (12,800) and line
# search (1,024, 102,400) counts and one past the last
ROLLOUT_BATCHES = (1, 37, 4096, 4097)
EE_BATCHES = (*ROLLOUT_BATCHES, 128, 1024, 12800, 102400, 102401)


@pytest.mark.parametrize("team", _lib.TEAM_SIZES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_rollout_multi_geometry(dtype, team, monkeypatch):
    """K5 is n8 only; at every team size (the table's own among them) one
    team a trajectory, at most one warp of teams a block; a team holds the
    step's scratch with the wrenches' chain (102 values a body), x, two
    stages of u and of the wrench set and u - c, padded to the teams' bank
    offset; the block's memory is its teams', within 232,448 bytes; the
    grid covers every batch exactly, and the path's 4096 fill every SM."""
    sfx = _lib._SUFFIX[dtype]
    assert _lib.TEAM[("rollout_multi", "n8", sfx)] in _lib.TEAM_SIZES
    assert [c for c, (_, _, ks) in _lib.SIZE_CLASSES.items()
            if "rollout_multi" in ks] == ["n8"]
    with pytest.raises(ValueError):
        _lib.team_values("rollout_multi", "fb16", team)
    monkeypatch.setitem(_lib.TEAM, ("rollout_multi", "n8", sfx), team)
    values = _lib.team_values("rollout_multi", "n8", team)
    assert values >= 102 * 8 + 54 + 8 + 12 + 5 * 8 + 12 * 8
    assert values % 32 == team % 32
    per = values * torch.finfo(dtype).bits // 8
    for B in ROLLOUT_BATCHES:
        t, tpb, smem, blocks = _lib.team_geometry("rollout_multi", "n8",
                                                  dtype, B)
        assert t == team and 1 <= tpb and tpb * team <= 32
        assert smem == tpb * per <= _lib.SMEM_MAX
        assert blocks * tpb >= B > (blocks - 1) * tpb
        if B >= 4096:
            assert blocks >= _lib.H100_SMS
    assert _lib.team_geometry("rollout_multi", "n8", dtype, 1)[1:] == (
        1, per, 1)


@pytest.mark.parametrize("kernel", ["ee_gn", "ee_err"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_ee_geometry(kernel, dtype):
    """K4's blocks: a multiple of four states (so every staged row range
    of a block is 16-byte aligned in both dtypes), 8 lanes a state for
    ee_gn and one for ee_err, within the kernels' launch bounds (256 and
    128 threads); a block stages the walk's rows of the class's 8 bodies and
    the mount, then a state's q and e, and for ee_gn g0, H0 and J at the n8
    bound; the grid covers every batch exactly, and a batch that can fill
    every SM does."""
    nb = _lib.SIZE_CLASSES["n8"][0]
    per = _lib.ee_values(kernel)
    assert per == (2 * nb + 3 + nb * nb + 3 * nb if kernel == "ee_gn"
                   else nb + 3)
    lanes, most = (8, 256) if kernel == "ee_gn" else (1, 128)
    size = torch.finfo(dtype).bits // 8
    for B in EE_BATCHES:
        spb, threads, smem, blocks = _lib.ee_geometry(kernel, dtype, B)
        assert spb % 4 == 0 and threads == spb * lanes <= most
        assert threads % 32 == 0
        assert _lib.EE_FIXED % 4 == 0
        assert smem == (_lib.EE_FIXED + spb * per) * size <= 48 * 1024
        assert blocks * spb >= B > (blocks - 1) * spb
        if B >= _lib.H100_SMS * _lib.EE_STATES[kernel][1]:
            assert blocks >= _lib.H100_SMS
    # the path's large batch (12,800 knots, 102,400 line-search states)
    # takes the most states a block
    B = 12800 if kernel == "ee_gn" else 102400
    assert _lib.ee_geometry(kernel, dtype, B)[0] == _lib.EE_STATES[kernel][0]
    with pytest.raises(ValueError):
        _lib.ee_values("rollout_multi")


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


# A host build of K9's team body (feedback_team.cuh, K9's chunked sum, or
# K2's with cw = 0, with or without wrenches) on a team of 8 std::threads, and of K11's block body on one thread, each
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
#include "rollout_multi.cu"
#include "ee_gn.cu"
#include "rnea.cu"
#include "fd_step_minv.cu"

// NL std::threads as one team, lane = the thread's index
template <int NL, class F>
static void run_team(F body) {
  HostBarrier bar;
  bar.n = NL;
  g_bar = &bar;
  std::vector<std::thread> th;
  for (int lane = 0; lane < NL; ++lane)
    th.emplace_back([&, lane] { body(rbd::Team<NL>{lane, 0u}); });
  for (auto& t : th) t.join();
}

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
        if (cw > 0)
          rbd::feedback_rollout_team<NL, LV>(rbd::Team<NL>{lane, 0u}, m, s.data(),
                                             x0 + (size_t)b * nx, Xn + bx, Un + bu, kf + bu,
                                             Kf + bu * nx, uclip, Xo + bx, Uo + bu, H, dt, g,
                                             rbd::ChunkSum{cw});
        else
          rbd::feedback_rollout_team<NL, LV>(rbd::Team<NL>{lane, 0u}, m, s.data(),
                                             x0 + (size_t)b * nx, Xn + bx, Un + bu, kf + bu,
                                             Kf + bu * nx, uclip, Xo + bx, Uo + bu, H, dt, g);
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

// K2 (cw = 0: one run over a row) and K9 with the wrenches of a block of
// one team: the block's two wrench stages, its threads the team's lanes
template <class D, bool LV>
static void k9_fext(const double* tab, const int* itab, int nb, const double* x0,
                    const double* Xn, const double* Un, const double* kf, const double* Kf,
                    const double* fext, const double* uclip, double* Xo, double* Uo, int B,
                    int H, int cw, double dt, double g) {
  constexpr int NL = 8;
  const rbd::Model<double, D> m{tab, itab, nb};
  const int n = m.nv(), nx = 2 * n;
  std::vector<double> s(rbd::feedback_team_stride<D, NL, true>()),
      stage(rbd::feedback_wrench_values<D>());
  for (int b = 0; b < B; ++b) {
    const size_t bx = (size_t)b * H * nx, bu = (size_t)b * H * n;
    run_team<NL>([&](const rbd::Team<NL>& tm) {
      const rbd::BlockWrench<double, D> w{fext, stage.data(), tm.lane, NL, nb, true};
      if (cw > 0)
        rbd::feedback_rollout_team<NL, LV>(tm, m, s.data(), x0 + (size_t)b * nx, Xn + bx,
                                           Un + bu, kf + bu, Kf + bu * nx, uclip, Xo + bx,
                                           Uo + bu, H, dt, g, rbd::ChunkSum{cw}, w);
      else
        rbd::feedback_rollout_team<NL, LV>(tm, m, s.data(), x0 + (size_t)b * nx, Xn + bx,
                                           Un + bu, kf + bu, Kf + bu * nx, uclip, Xo + bx,
                                           Uo + bu, H, dt, g, rbd::RowSum{}, w);
    });
  }
}

#define HOST_K9_FEXT(CLS, D)                                                                 \
  extern "C" void host_k9_fext_##CLS(const double* tab, const int* itab, int nb,             \
                                     const double* x0, const double* Xn, const double* Un,   \
                                     const double* kf, const double* Kf, const double* fext, \
                                     const double* uclip, double* Xo, double* Uo, int B,     \
                                     int H, int cw, int lv, double dt, double g) {           \
    (lv ? k9_fext<rbd::D, true> : k9_fext<rbd::D, false>)(                                   \
        tab, itab, nb, x0, Xn, Un, kf, Kf, fext, uclip, Xo, Uo, B, H, cw, dt, g);            \
  }
HOST_K9_FEXT(n8, N8)
HOST_K9_FEXT(fb16, FB16)

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

template <bool MINV, bool FEXT>
static void k5(const rbd::Model<double, rbd::N8>& m, const double* x0, const double* U,
               const double* fext, double* xo, int B, int H, double dt, double g) {
  constexpr int NL = 8;
  const int nx = 2 * m.nb;
  std::vector<double> s(rbd::rollout_multi_team_stride<NL>());
  for (int b = 0; b < B; ++b)
    run_team<NL>([&](const rbd::Team<NL>& tm) {
      rbd::rollout_team<NL, MINV, FEXT>(tm, m, s.data(), x0 + (size_t)b * nx,
                                        U + (size_t)b * m.nb, (size_t)B * m.nb, fext,
                                        xo + (size_t)b * nx, H, dt, g);
    });
}

extern "C" void host_k5(const double* tab, const int* itab, int nb, const double* x0,
                        const double* U, const double* fext, double* xo, int B, int H,
                        int minv, double dt, double g) {
  const rbd::Model<double, rbd::N8> m{tab, itab, nb};
  auto run = minv ? (fext ? k5<true, true> : k5<true, false>)
                  : (fext ? k5<false, true> : k5<false, false>);
  run(m, x0, U, fext, xo, B, H, dt, g);
}

template <class D, bool QDD>
static void k10(const rbd::Model<double, D>& m, const double* q, const double* qd,
                const double* qdd, double* tau, int B, double g) {
  constexpr int NL = 8;
  const int n = m.nv();
  std::vector<double> s(rbd::rnea_team_stride<D, NL>());
  for (int b = 0; b < B; ++b)
    run_team<NL>([&](const rbd::Team<NL>& tm) {
      rbd::rnea_team<NL, QDD>(tm, m, s.data(), q + (size_t)b * n, qd + (size_t)b * n,
                              QDD ? qdd + (size_t)b * n : nullptr, tau + (size_t)b * n, g);
    });
}

template <class D, bool DENSE, bool FEXT>
static void k6(const rbd::Model<double, D>& m, const double* x, const double* u,
               const double* fext, int fext_stride, double* xo, int B, double dt, double g) {
  constexpr int NL = 8;
  const int n = m.nv();
  std::vector<double> s(rbd::MinvStepLayout<D, NL, DENSE>::STRIDE);
  for (int b = 0; b < B; ++b)
    run_team<NL>([&](const rbd::Team<NL>& tm) {
      rbd::fd_step_minv_team<NL, DENSE, FEXT>(tm, m, s.data(), x + (size_t)b * 2 * n,
                                              u + (size_t)b * n,
                                              FEXT ? fext + (size_t)b * fext_stride : nullptr,
                                              xo + (size_t)b * 2 * n, dt, g);
    });
}

#define HOST_K6_K10(CLS, D)                                                                  \
  extern "C" void host_k10_##CLS(const double* tab, const int* itab, int nb, const double* q, \
                                 const double* qd, const double* qdd, double* tau, int B,    \
                                 double g) {                                                 \
    const rbd::Model<double, rbd::D> m{tab, itab, nb};                                       \
    (qdd ? k10<rbd::D, true> : k10<rbd::D, false>)(m, q, qd, qdd, tau, B, g);                \
  }                                                                                          \
  extern "C" void host_k6_##CLS(const double* tab, const int* itab, int nb, const double* x,  \
                                const double* u, const double* fext, int fext_stride,        \
                                double* xo, int B, int dense, double dt, double g) {         \
    const rbd::Model<double, rbd::D> m{tab, itab, nb};                                       \
    auto run = dense ? (fext ? k6<rbd::D, true, true> : k6<rbd::D, true, false>)             \
                     : (fext ? k6<rbd::D, false, true> : k6<rbd::D, false, false>);          \
    run(m, x, u, fext, fext_stride, xo, B, dt, g);                                           \
  }
HOST_K6_K10(n8, N8)
HOST_K6_K10(fb16, FB16)

extern "C" void host_k4(const double* tab, const int* itab, int nb, const double* ee,
                        int chain, int prism, const double* q, double tx, double ty, double tz,
                        double* e, double* g0, double* H0, int B, int gn) {
  const rbd::Model<double, rbd::N8> m{tab, itab, nb};
  const double target[3] = {tx, ty, tz};
  std::vector<double> J(3 * rbd::N8::NB), rows(rbd::EE_ROW * rbd::N8::NB);
  for (int k = 0; k < rbd::EE_ROW * nb; ++k) rows[k] = rbd::ee_row_value(m, k);
  for (int b = 0; b < B; ++b) {
    const double* qb = q + (size_t)b * nb;
    if (gn) {
      run_team<8>([&](const rbd::Team<8>& tm) {
        rbd::ee_gn_team(tm, nb, rows.data(), (unsigned)chain, (unsigned)prism, ee, qb, target,
                        e + 3 * b, g0 + (size_t)b * nb, H0 + (size_t)b * nb * nb, J.data());
      });
    } else {
      rbd::ee_err_one(rows.data(), (unsigned)chain, (unsigned)prism, ee, qb, target, e + 3 * b);
    }
  }
}

// K4 on the rpy root (FB16): ee_gn by a team of 8, ee_err by one thread
extern "C" void host_k4_fb16(const double* tab, const int* itab, int nb, const double* ee,
                             int chain, int prism, const double* q, double tx, double ty,
                             double tz, double* e, double* g0, double* H0, int B, int gn) {
  const rbd::Model<double, rbd::FB16> m{tab, itab, nb};
  const int n = m.nv();
  const double target[3] = {tx, ty, tz};
  std::vector<double> J(3 * rbd::FB16::NV), rows(rbd::EE_ROW * rbd::FB16::NB);
  for (int k = 0; k < rbd::EE_ROW * nb; ++k) rows[k] = rbd::ee_row_value(m, k);
  for (int b = 0; b < B; ++b) {
    const double* qb = q + (size_t)b * n;
    if (gn) {
      run_team<8>([&](const rbd::Team<8>& tm) {
        rbd::ee_gn_team_rpy(tm, n, rows.data(), (unsigned)chain, (unsigned)prism, ee, qb,
                            target, e + 3 * b, g0 + (size_t)b * n, H0 + (size_t)b * n * n,
                            J.data());
      });
    } else {
      rbd::ee_err_one_rpy(rows.data(), (unsigned)chain, (unsigned)prism, ee, qb, target,
                          e + 3 * b);
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The host build of K4's, K5's, K6's, K9's, K10's and K11's bodies,
    loaded with ctypes."""
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
    for fn in (lib.host_k9_fext_n8, lib.host_k9_fext_fb16):
        fn.argtypes = [P, P, I] + [P] * 9 + [I, I, I, I, D, D]
    lib.host_k11.argtypes = ([P] * 5 + [I, I, P, I, I, P, I, I] + [P] * 7
                             + [I] * 4)
    lib.host_k5.argtypes = [P, P, I, P, P, P, P, I, I, I, D, D]
    lib.host_k4.argtypes = [P, P, I, P, I, I, P, D, D, D, P, P, P, I, I]
    lib.host_k4_fb16.argtypes = lib.host_k4.argtypes
    for cls in ("n8", "fb16"):
        getattr(lib, f"host_k10_{cls}").argtypes = [P, P, I, P, P, P, P, I, D]
        getattr(lib, f"host_k6_{cls}").argtypes = [P, P, I, P, P, P, I, P, I,
                                                   I, D, D]
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


@pytest.mark.parametrize("nchunks", [0, 2, "ndx"], ids=["k2", "k9-2", "k9-ndx"])
@pytest.mark.parametrize("name", ["arm7", "quadruped12"])
def test_host_feedback_fext(host_kernels, name, nchunks):
    """K2's and K9's team body with wrenches (one block of one team, the
    block's two wrench stages), built for the host and run by a team of 8
    threads, against ``feedback_rollout_plain`` (nchunks 0: K2's sum) and
    ``feedback_rollout_chunked_plain`` under the same (H, nb, 6) wrenches in
    float64 (1e-9), with and without a clamp, on arm7 (n8) and the rpy
    quadruped (fb16); all-zero wrenches give the wrench-free body's result
    bit for bit."""
    from rbdtpu_torch.kernels import fused
    from rbdtpu_torch.model import load_asset

    fb = name == "quadruped12"
    m = load_asset(name, device="cpu", dtype=torch.float64, floating_base=fb)
    nch = m.nx if nchunks == "ndx" else nchunks
    cw = fused.chunk_geometry(m.nx, nch)[0] if nch else 0
    tab, itab = _lib.model_tables(m, "cpu", torch.float64)
    rng = np.random.default_rng(31 + nch)
    B, H = 3, 4
    T = lambda sc, *s: torch.tensor(sc * rng.standard_normal(s))
    x0 = T(0.1, B, m.nx)
    if fb:
        x0[:, 2] += 0.4
    args = (x0, T(0.1, B, H, m.nx), T(0.1, B, H, m.nv), T(0.1, B, H, m.nv),
            T(0.1, B, H, m.nv, m.nx))
    cls = "fb16" if fb else "n8"
    lv = int(_lib.level_walk(m))
    for clip in (None, torch.full((m.nv,), 0.05, dtype=torch.float64)):
        for F in (T(5.0, H, m.nb, 6), torch.zeros(H, m.nb, 6,
                                                  dtype=torch.float64)):
            Xo = torch.empty(B, H, m.nx, dtype=torch.float64)
            Uo = torch.empty(B, H, m.nv, dtype=torch.float64)
            getattr(host_kernels, f"host_k9_fext_{cls}")(
                _ptr(tab), _ptr(itab), m.nb, *[_ptr(a) for a in args],
                _ptr(F), _ptr(clip), _ptr(Xo), _ptr(Uo), B, H, cw, lv, 0.01,
                -9.81)
            if nch:
                Xp, Up = fused.feedback_rollout_chunked_plain(
                    m, *args, 0.01, u_clip=clip, nchunks=nch, f_ext=F)
            else:
                Xp, Up = fused.feedback_rollout_plain(m, *args, 0.01,
                                                      u_clip=clip, f_ext=F)
            torch.testing.assert_close(Xo, Xp, rtol=0, atol=1e-9)
            torch.testing.assert_close(Uo, Up, rtol=0, atol=1e-9)
            if not F.any():
                X0 = torch.empty_like(Xo)
                U0 = torch.empty_like(Uo)
                getattr(host_kernels, f"host_k9_{cls}")(
                    _ptr(tab), _ptr(itab), m.nb, *[_ptr(a) for a in args],
                    _ptr(clip), _ptr(X0), _ptr(U0), B, H, cw, lv, 0.01,
                    -9.81)
                assert torch.equal(Xo, X0) and torch.equal(Uo, U0)


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


def _tree(name):
    """arm7 (a chain), the mixed tree (branched, prismatic joints) or the
    rpy quadruped in float64 on the CPU, with the end effector the card
    tests use."""
    from rbdtpu_torch.model import load_asset
    from test_torch_cuda import mixed_tree_urdf

    if name == "arm7":
        return load_asset("arm7", device="cpu", dtype=torch.float64), None
    if name == "quad_rpy":
        return load_asset("quadruped12", device="cpu", dtype=torch.float64,
                          floating_base=True), None
    return (parse_urdf(mixed_tree_urdf(), device="cpu", dtype=torch.float64),
            ("j4",))


@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("wrench", [False, True], ids=["free", "fext"])
@pytest.mark.parametrize("route", ["aba", "minv"])
@pytest.mark.parametrize("name", ["arm7", "mixed"])
def test_host_rollout_multi(host_kernels, name, route, wrench, H):
    """K5's team body, built for the host and run by a team of 8 threads
    a trajectory, against ``rollout_multi_plain`` in float64 (1e-9) on
    arm7 and the mixed tree, on both routes (the minv route through the
    team RNEA bias and the M^-1 sweeps), with and without per-step
    wrenches."""
    from rbdtpu_torch.kernels import fused

    m, _ = _tree(name)
    tab, itab = _lib.model_tables(m, "cpu", torch.float64)
    rng = np.random.default_rng(11 + H)
    B = 3
    T = lambda sc, *s: torch.tensor(sc * rng.standard_normal(s))
    x0, U = T(0.3, B, m.nx), T(0.5, H, B, m.nv)
    F = T(5.0, H, m.nb, 6) if wrench else None
    xo = torch.empty(B, m.nx, dtype=torch.float64)
    host_kernels.host_k5(_ptr(tab), _ptr(itab), m.nb, _ptr(x0), _ptr(U),
                         _ptr(F), _ptr(xo), B, H, int(route == "minv"), 0.01,
                         -9.81)
    want = fused.rollout_multi_plain(m, x0, U, 0.01, route=route, f_ext=F)
    torch.testing.assert_close(xo, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("gn", [True, False], ids=["ee_gn", "ee_err"])
@pytest.mark.parametrize("name", ["arm7", "mixed"])
def test_host_ee_gn(host_kernels, name, gn):
    """K4's bodies built for the host, ee_gn by a team of 8 threads a state
    and ee_err by one thread, against ``ee_gn_plain`` in float64 (1e-9) on
    arm7 and on the mixed tree, whose end effector sits behind both
    prismatic joints."""
    from rbdtpu_torch.kernels import fk_lane

    m, ee_names = _tree(name)
    jid, fid = fk_lane._single_ee(m, ee_names)
    tab, itab = _lib.model_tables(m, "cpu", torch.float64)
    ee = _lib.ee_table(m, fid, "cpu", torch.float64)
    B, n = 5, m.nv
    q = torch.tensor(np.random.default_rng(5).standard_normal((B, n)))
    target = (0.3, 0.2, 0.8)
    e = torch.empty(B, 3, dtype=torch.float64)
    g0 = torch.empty(B, n, dtype=torch.float64)
    H0 = torch.empty(B, n, n, dtype=torch.float64)
    host_kernels.host_k4(_ptr(tab), _ptr(itab), m.nb, _ptr(ee),
                         *fk_lane.ee_chain(m, jid), _ptr(q), *target, _ptr(e),
                         _ptr(g0), _ptr(H0), B, int(gn))
    want = fk_lane.ee_gn_plain(m, q, target, ee_names=ee_names, gn=gn)
    torch.testing.assert_close(e, want[0], rtol=0, atol=1e-9)
    if gn:
        torch.testing.assert_close(g0, want[1], rtol=0, atol=1e-9)
        torch.testing.assert_close(H0, want[2], rtol=0, atol=1e-9)


@pytest.mark.parametrize("gn", [True, False], ids=["ee_gn", "ee_err"])
@pytest.mark.parametrize("ee", ["leaf", "foot", "offset"])
def test_host_ee_gn_rpy(host_kernels, ee, gn):
    """K4's rpy-root bodies (fb16) built for the host, ee_gn by a team of 8
    threads a state and ee_err by one thread, against ``ee_gn_plain`` in
    float64 (1e-9) on the rpy quadruped at a leaf joint, at a foot's fixed
    frame, and at a leaf joint of a copy of the model whose root frame is
    offset and turned (Ttree[0] not the identity)."""
    from rbdtpu_torch.kernels import fk_lane
    from rbdtpu_torch.model import load_asset

    m = load_asset("quadruped12", device="cpu", dtype=torch.float64,
                   floating_base=True)
    ee_names = {"leaf": None, "foot": ("RL_foot_fixed",),
                "offset": ("FR_knee",)}[ee]
    if ee == "offset":
        m = _turned_root(m)
    elif ee == "leaf":
        ee_names = (m.joint_names[m.leaves()[0]],)
    jid, fid = fk_lane._single_ee(m, ee_names)
    tab, itab = _lib.model_tables(m, "cpu", torch.float64)
    table = _lib.ee_table(m, fid, "cpu", torch.float64)
    B, n = 5, m.nv
    q = torch.tensor(np.random.default_rng(7).uniform(-1.0, 1.0, (B, m.nq)))
    target = (0.3, 0.1, 0.1)
    e = torch.empty(B, 3, dtype=torch.float64)
    g0 = torch.empty(B, n, dtype=torch.float64)
    H0 = torch.empty(B, n, n, dtype=torch.float64)
    host_kernels.host_k4_fb16(_ptr(tab), _ptr(itab), m.nb, _ptr(table),
                              *fk_lane.ee_chain(m, jid), _ptr(q), *target,
                              _ptr(e), _ptr(g0), _ptr(H0), B, int(gn))
    want = fk_lane.ee_gn_plain(m, q, target, ee_names=ee_names, gn=gn)
    torch.testing.assert_close(e, want[0], rtol=0, atol=1e-9)
    if gn:
        torch.testing.assert_close(g0, want[1], rtol=0, atol=1e-9)
        torch.testing.assert_close(H0, want[2], rtol=0, atol=1e-9)


def _turned_root(m):
    """``m`` with its root's joint frame moved by (0.1, -0.2, 0.05) and
    turned by rpy (0.3, -0.2, 0.5) (both Ttree[0] and Xtree[0])."""
    import dataclasses

    from rbdtpu_torch.spatial.transforms import hom, plux, rpy_to_R

    R = rpy_to_R(torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64))
    p = torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64)
    Ttree, Xtree = m.Ttree.clone(), m.Xtree.clone()
    Ttree[0] = hom(R, p) @ Ttree[0]
    Xtree[0] = Xtree[0] @ plux(R.T, p)
    host = dict(m.host_data, Ttree=Ttree.numpy(), Xtree=Xtree.numpy())
    return dataclasses.replace(m, Ttree=Ttree, Xtree=Xtree, host_data=host)


def _state(m, rng, B):
    """B float64 states 0.3 N(0,1) (an rpy root 0.4 up) and controls
    N(0,1)."""
    x = torch.tensor(0.3 * rng.standard_normal((B, m.nx)))
    if m.floating_base:
        x[:, 2] += 0.4
    return x, torch.tensor(rng.standard_normal((B, m.nv)))


@pytest.mark.parametrize("qdd", [True, False], ids=["qdd", "bias"])
@pytest.mark.parametrize("name", ["arm7", "mixed", "quad_rpy"])
def test_host_rnea(host_kernels, name, qdd):
    """K10's team body, built for the host and run by a team of 8 threads
    a state, against ``rnea_plain`` in float64 (1e-9 relative to tau's
    scale) on arm7, the mixed tree and the rpy quadruped (fb16), with and
    without qdd."""
    from rbdtpu_torch.kernels import fused

    m, _ = _tree(name)
    tab, itab = _lib.model_tables(m, "cpu", torch.float64)
    B = 3
    x, a = _state(m, np.random.default_rng(21), B)
    q, qd = x[:, :m.nv].contiguous(), x[:, m.nv:].contiguous()
    a = a if qdd else None
    tau = torch.empty(B, m.nv, dtype=torch.float64)
    fn = getattr(host_kernels, f"host_k10_{_lib.size_class('rnea', m)}")
    fn(_ptr(tab), _ptr(itab), m.nb, _ptr(q), _ptr(qd), _ptr(a), _ptr(tau), B,
       -9.81)
    want = fused.rnea_plain(m, q, qd, a)
    torch.testing.assert_close(tau, want, rtol=0,
                               atol=1e-9 * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("wrench", ["free", "shared", "batched"])
@pytest.mark.parametrize("dense", [False, True], ids=["fact", "dense"])
@pytest.mark.parametrize("name", ["arm7", "mixed", "quad_rpy"])
def test_host_fd_step_minv(host_kernels, name, dense, wrench):
    """K6's team body, built for the host and run by a team of 8 threads
    an element, against ``fd_step_minv_plain`` in float64 (1e-9) on arm7,
    the mixed tree and the rpy quadruped (fb16), on the factorised route
    (the M^-1 sweeps, the root's block on the rpy root) and the dense one
    (M^-1 one column a lane), without wrenches, under one set shared by the
    batch and under one set an element."""
    from rbdtpu_torch.kernels import fused

    m, _ = _tree(name)
    tab, itab = _lib.model_tables(m, "cpu", torch.float64)
    rng = np.random.default_rng(23)
    B = 3
    x, u = _state(m, rng, B)
    F = {"free": None,
         "shared": torch.tensor(5.0 * rng.standard_normal((m.nb, 6))),
         "batched": torch.tensor(5.0 * rng.standard_normal((B, m.nb, 6)))}[
        wrench]
    stride = 6 * m.nb if wrench == "batched" else 0
    xo = torch.empty(B, m.nx, dtype=torch.float64)
    fn = getattr(host_kernels,
                 f"host_k6_{_lib.size_class('fd_step_minv', m)}")
    fn(_ptr(tab), _ptr(itab), m.nb, _ptr(x), _ptr(u), _ptr(F), stride,
       _ptr(xo), B, int(dense), 0.01, -9.81)
    want = fused.fd_step_minv_plain(m, x, u, 0.01, f_ext=F)
    torch.testing.assert_close(xo, want, rtol=0, atol=1e-9)
