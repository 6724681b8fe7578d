"""Launch geometry of the team kernels K1 (``fd_step``), K2
(``feedback_rollout``), K5 (``rollout_multi``), K6 (``fd_step_minv``) and
K10 (``rnea``):
``rbdtpu_torch.kernels._lib`` picks each size class and dtype's team size,
the teams a block and the dynamic shared memory a block, which the CUDA
launch checks again.  Needs no card, no compiler and no JAX."""
import pytest
import torch

from rbdtpu_torch.kernels import _lib

KERNELS = ("fd_step", "feedback_rollout", "fd_step_minv", "rnea",
           "rollout_multi")
CASES = [(k, cls, dt) for k in KERNELS
         for cls, (_, _, kernels) in _lib.SIZE_CLASSES.items() if k in kernels
         for dt in (torch.float32, torch.float64)]
BATCHES = (1, 8, 37, 128, 1024, 2048)


def _id(case):
    k, cls, dt = case
    return f"{k}-{cls}-{str(dt)[6:]}"


def test_every_class_has_both_team_kernels():
    """K1, K2, K5, K6 and K10 are instantiated in every size class."""
    assert {(k, cls) for k, cls, _ in CASES} == {
        (k, cls) for k in KERNELS for cls in _lib.SIZE_CLASSES}


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_team_geometry(case):
    """One team size of 8, 16 or 32 lanes per class and dtype; at most one
    warp of whole teams a block; the block's shared memory is its teams'
    values, within the H100's 232,448 bytes; the grid covers every batch
    exactly, and a batch that could give every SM a block does."""
    kernel, cls, dtype = case
    team = _lib.TEAM[(kernel, cls, _lib._SUFFIX[dtype])]
    assert team in _lib.TEAM_SIZES
    size = torch.finfo(dtype).bits // 8
    per = _lib.team_values(kernel, cls, team) * size
    for B in BATCHES:
        t, tpb, smem, blocks = _lib.team_geometry(kernel, cls, dtype, B)
        assert t == team
        assert 1 <= tpb and tpb * team <= 32
        assert smem == tpb * per <= _lib.SMEM_MAX
        assert blocks * tpb >= B > (blocks - 1) * tpb
        if B >= _lib.H100_SMS:
            assert blocks >= _lib.H100_SMS
    # the smallest batches still spread: one team a block
    assert _lib.team_geometry(kernel, cls, dtype, 1)[1:] == (1, per, 1)


@pytest.mark.parametrize("kernel", KERNELS)
def test_team_defines_fix_every_instantiation(kernel):
    """The build fixes one team size per class and dtype: every C entry
    point of the kernel's source takes its lanes from a define, and the
    build defines each of them once, from TEAM; the same holds for the
    kernel's wrench variant where its source has one (K2's
    ``feedback_rollout_fext``).  The entry points are those of the classes
    that list the kernel."""
    import os
    import re

    with open(os.path.join(_lib.CSRC, f"{kernel}.cu")) as f:
        src = f.read()
    variants = [k for k in (kernel, f"{kernel}_fext")
                if re.search(rf"^RBD_{k.upper()}\(", src, re.M)]
    assert variants[0] == kernel
    for k in variants:
        entries = re.findall(
            rf"^RBD_{k.upper()}\((\w+), \w+, \w+, (f32|f64)\)$", src, re.M)
        assert sorted(entries) == sorted(
            (cls, sfx) for cls, (_, _, ks) in _lib.CLASSES.items() if k in ks
            for sfx in ("f32", "f64"))
        assert f"RBD_TEAM_{k}_##CLS##_##SFX" in src
        classes = "|".join(_lib.CLASSES)
        defines = [d for d in _lib.team_defines()
                   if re.match(rf"-DRBD_TEAM_{k}_({classes})_f(32|64)=", d)]
        assert sorted(defines) == sorted(
            f"-DRBD_TEAM_{k}_{cls}_{sfx}={_lib.TEAM[(k, cls, sfx)]}"
            for cls, sfx in entries)


@pytest.mark.parametrize("team", _lib.TEAM_SIZES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_team_values_hold_the_step(kernel, team):
    """Every class's shared memory holds the step's per-body arrays (at
    least 90 values a body: transform, the dense transform's lower-left
    block, v, c, pA, U, S, IA, 1/d, u, parent; K1's and K6's wrench chain,
    12 more; K5's wrench chain and two stages of wrench sets, 24 more; K2's
    level order and U.a partial sums, 8 more; K10's RNEA alone 52:
    transform, lower-left block, v, a, I v, f, S, parent), is
    padded to the kernels' bank offset, and the largest team of the largest
    class in double fits a block."""
    per_body = {"fd_step": 102, "fd_step_minv": 102, "feedback_rollout": 98,
                "rnea": 52, "rollout_multi": 114}[kernel]
    for cls, (nb, fb, _) in _lib.SIZE_CLASSES.items():
        nv = nb + 5 if fb else nb
        values = _lib.team_values(kernel, cls, team)
        assert values >= per_body * nb + 3 * nv
        assert values % 32 == team % 32
        assert values * 8 <= _lib.SMEM_MAX
    with pytest.raises(ValueError):
        _lib.team_values("linearize_parts", "n8", team)


@pytest.mark.parametrize("name", ["quadruped12", "humanoid30", "arm7"])
def test_level_order(name):
    """The int table's level order, which K2 walks on a branched tree:
    levels hold every body once, each one level below its parent; the
    quadruped's 13 bodies in 4 levels and the humanoid's 31 in 11 are
    walked level by level, the arm's chain of 7 body by body."""
    from rbdtpu_torch.model import load_asset

    m = load_asset(name, device="cpu", dtype=torch.float64,
                   floating_base=name != "arm7")
    it = _lib.model_tables(m, torch.device("cpu"), torch.float64)[1].tolist()
    nb = m.nb
    order, levels = it[2 * nb:3 * nb], it[3 * nb]
    starts = it[3 * nb + 1:3 * nb + 2 + levels]
    assert (nb, levels) == {"quadruped12": (13, 4), "humanoid30": (31, 11),
                            "arm7": (7, 7)}[name]
    assert _lib.level_walk(m) == (name != "arm7")
    assert sorted(order) == list(range(nb)) and starts[-1] == nb
    level = {i: lv for lv in range(levels)
             for i in order[starts[lv]:starts[lv + 1]]}
    for i, p in enumerate(m.parent):
        assert level[i] == (0 if p < 0 else level[p] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("cls", list(_lib.SIZE_CLASSES))
def test_fd_step_minv_dense_geometry(cls, dtype):
    """K6's dense route takes the factorised route's values and, per team,
    the rpy root's 6x6 inverse, one 6-value slot a tree level a lane for
    the M^-1 columns and M^-1 itself (nv rows of nv + 1): fewer teams a
    block where that crosses SMEM_MAX, never none; the grid covers every
    batch exactly and a batch that could give every SM a block does."""
    nb, fb, _ = _lib.SIZE_CLASSES[cls]
    nv = nb + 5 if fb else nb
    team = _lib.TEAM[("fd_step_minv", cls, _lib._SUFFIX[dtype])]
    fact = _lib.team_values("fd_step_minv", cls, team)
    dense = _lib.team_values("fd_step_minv", cls, team, dense=True)
    assert dense - fact >= 36 + 6 * _lib.LIN_LEVELS[cls] * team + nv * nv
    assert dense % 32 == team % 32
    per = dense * torch.finfo(dtype).bits // 8
    for B in BATCHES:
        t, tpb, smem, blocks = _lib.team_geometry("fd_step_minv", cls, dtype,
                                                  B, dense=True)
        assert t == team and 1 <= tpb and tpb * team <= 32
        assert smem == tpb * per <= _lib.SMEM_MAX
        assert blocks * tpb >= B > (blocks - 1) * tpb
        if B >= _lib.H100_SMS:
            assert blocks >= _lib.H100_SMS


def test_fd_step_minv_size_class_counts_levels():
    """K6's dense M^-1 columns keep one slot a tree level, as K3's do, so
    K6 takes the class K3 takes: the humanoid (11 levels) fb32, the rpy
    quadruped fb16; K10 needs no level slots and goes by bodies alone; on
    the quaternion root both, like K1-K4 and K9 (with and without
    wrenches) and K2 with wrenches, map its quadruped and humanoid to its
    own class "fq32", whose 12 level slots hold the humanoid's 11 levels."""
    from rbdtpu_torch.model import load_asset

    load = lambda name, **kw: load_asset(name, device="cpu",
                                         dtype=torch.float64, **kw)
    hum = load("humanoid30", floating_base=True)
    quad = load("quadruped12", floating_base=True)
    for kernel in ("fd_step_minv", "rnea"):
        assert _lib.size_class(kernel, hum) == "fb32"
        assert _lib.size_class(kernel, quad) == "fb16"
        assert _lib.size_class(kernel, load("arm7")) == "n8"
        assert _lib.size_class(kernel, load("quadruped12", floating_base=True,
                                            root_quat=True)) == "fq32"
    for name in ("quadruped12", "humanoid30"):
        quat = load(name, floating_base=True, root_quat=True)
        for kernel in ("fd_step", "feedback_rollout", "linearize_parts",
                       "ee_gn", "ee_err", "fd_step_minv", "rnea",
                       "feedback_chunked", "feedback_rollout_fext",
                       "feedback_chunked_fext"):
            assert _lib.size_class(kernel, quat) == "fq32"
    assert max(_lib.tree_depths(hum)) + 1 <= _lib.LIN_LEVELS["fq32"]
    assert "fd_step_minv" in _lib.LEVEL_KERNELS
    assert "rnea" not in _lib.LEVEL_KERNELS
