"""The Riccati backward-sweep kernel (K7/K8) beside its plain PyTorch
version (``solver.ddp.backward_pass``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import math

import torch

from . import _lib

# batches at or above this size are the lane-tiled call site of rbdtpu's
# kernel (K7), smaller ones its small-batch call site (K8); the CUDA kernel
# is the same, the launch counts apart
LANE_BATCH = 128
# the most dynamic shared memory one block may use on the H100
SMEM_MAX = 232448


def smem_bytes(nx: int, nu: int, dtype) -> int:
    """Shared memory one problem's sweep holds (csrc/riccati_chunk.cu
    riccati_smem_values)."""
    values = 2 * nx * nx + 4 * nx * nu + 2 * nu * nu + 2 * nx + 3 * nu
    return values * torch.empty((), dtype=dtype).element_size()


def _cost_block(arr, name, batch, H, r, c, ref):
    """(tensor, per-problem stride, per-knot stride) of a stage-cost block:
    a constant (r, c) block is read in place with zero strides; a per-knot
    block must be (..., H, r, c) over the whole batch."""
    if arr.dim() == 2:
        _lib.check(arr, name, (r, c), ref)
        return arr, 0, 0
    _lib.check(arr, name, tuple(batch) + (H, r, c), ref)
    return arr, H * r * c, r * c


def backward_pass_chunked(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg):
    """The Riccati sweep of ``solver.ddp.backward_pass`` (iLQR: control
    regularisation Quu + reg I, per-step symmetrisation, dV1 = sum k . Qu),
    one launch for the whole horizon.

    A (..., H, nx, nx), B (..., H, nx, nu), lx (..., H, nx),
    lu (..., H, nu), contiguous; lxx/luu/lux per knot (..., H, r, c) or
    constant (r, c); lfx (..., nx), lfxx (..., nx, nx) and reg (...) are
    broadcast over the batch.  Returns (k (..., H, nu), K (..., H, nu, nx),
    dV1 (...), ok (...)); ok is False where some Quu + reg I was not
    positive definite, whose gains are NaN from that knot back.

    Kernel ``riccati`` (csrc/riccati_chunk.cu) replaces rbdtpu's
    ``kernels.riccati_chunk.backward_pass_chunked`` (Pallas,
    riccati_chunk.py:523) and its small-batch variant ``_backward_small``
    (riccati_chunk.py:334): one thread block per problem loops over the
    horizon with Vx, Vxx and the Q terms in shared memory, the products
    split over its 256 threads, the Quu Cholesky on one warp and the k/K
    solves one thread per right-hand column.  Bound on the H100: the
    operations, issued at the rate of shared-memory operand loads.  Any
    batch is taken as it is, with no padding; launches count as
    ``riccati_chunk`` at batches >= 128 and ``riccati_small`` below.
    """
    if not A.is_cuda:
        from ..solver.ddp import backward_pass
        return backward_pass(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg)
    nx, nu = A.shape[-1], B.shape[-1]
    nbytes = smem_bytes(nx, nu, A.dtype)
    if nbytes > SMEM_MAX:
        raise ValueError(f"riccati: nx={nx}, nu={nu} in {A.dtype} needs "
                         f"{nbytes} bytes of shared memory a block; the "
                         f"H100 has {SMEM_MAX}")
    args, outs = sweep_args(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg)
    Bn = math.prod(outs[2].shape)
    _lib.launch("riccati", None, A, *args, *outs, Bn, A.shape[-3], nx, nu,
                count_as="riccati_chunk" if Bn >= LANE_BATCH
                else "riccati_small")
    return outs


def sweep_args(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg):
    """The C arguments of a Riccati sweep kernel (``riccati`` and
    ``riccati_fused`` share one signature) up to ``reg``, after checking
    them, and its outputs (k, K, dV1, ok), allocated on A's device."""
    nx, nu, H = A.shape[-1], B.shape[-1], A.shape[-3]
    batch = lfx.shape[:-1]
    _lib.check(A, "A", tuple(batch) + (H, nx, nx), A)
    _lib.check(B, "B", tuple(batch) + (H, nx, nu), A)
    _lib.check(lx, "lx", tuple(batch) + (H, nx), A)
    _lib.check(lu, "lu", tuple(batch) + (H, nu), A)
    blocks = [_cost_block(arr, name, batch, H, r, c, A)
              for arr, name, r, c in ((lxx, "lxx", nx, nx),
                                      (luu, "luu", nu, nu),
                                      (lux, "lux", nu, nx))]
    lfx = lfx.expand(tuple(batch) + (nx,)).contiguous()
    lfxx = lfxx.expand(tuple(batch) + (nx, nx)).contiguous()
    reg = torch.as_tensor(reg, dtype=A.dtype, device=A.device).expand(
        batch).contiguous()
    for t, name in ((lfx, "lfx"), (lfxx, "lfxx"), (reg, "reg")):
        _lib.check(t, name, t.shape, A)
    k = torch.empty(tuple(batch) + (H, nu), dtype=A.dtype, device=A.device)
    K = torch.empty(tuple(batch) + (H, nu, nx), dtype=A.dtype,
                    device=A.device)
    dV1 = torch.empty(batch, dtype=A.dtype, device=A.device)
    ok = torch.empty(batch, dtype=torch.bool, device=A.device)
    args = [A, B, lx, lu, *(a for blk in blocks for a in blk), lfx, lfxx, reg]
    return args, (k, K, dV1, ok)
