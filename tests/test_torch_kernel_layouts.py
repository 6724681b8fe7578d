"""Launch geometry and shared-memory layouts of K3 (``linearize_parts``)
and of the Riccati sweep (``riccati``, K7/K8): ``rbdtpu_torch.kernels._lib``
gives each launch's threads, blocks and shared bytes, and the CUDA launch
refuses any other count.  The C layouts are compiled for the host with g++
and held against their Python twins.  Needs no card and no JAX."""
import shutil
import subprocess

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
