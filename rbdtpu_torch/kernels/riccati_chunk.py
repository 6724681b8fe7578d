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
    """Shared memory a block of one problem's sweep holds
    (csrc/riccati_chunk.cu riccati_layout, ``_lib.riccati_values``)."""
    return _lib.riccati_values(nx, nu) * torch.empty(
        (), dtype=dtype).element_size()


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
    (riccati_chunk.py:334): a thread block per problem loops over the
    horizon with the carry and the Q terms in shared memory; every product
    gives a thread a 4 x 4 register tile, knot t-1's [A | B] arrives by
    cp.async during knot t, Quu + reg I is factored as L D L^T with L^-1
    by one elimination step a barrier, and k, K come from two products;
    the block's threads are picked to run the batch in as few waves as any
    count (``_lib.riccati_geometry``).  Bound on the H100: the
    operations.  Any batch is taken as it is, with no padding; launches
    count as ``riccati_chunk`` at batches >= 128 and ``riccati_small``
    below.  lfxx is taken as symmetric, as the solver's terminal Hessian
    is (the sweep symmetrises every later Vxx itself).
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
    nt, smem, _ = _lib.riccati_geometry(nx, nu, A.dtype, Bn,
                                        _lib.sm_count(A.device))
    _lib.launch("riccati", None, A, *args, *outs, Bn, A.shape[-3], nx, nu,
                nt, smem, count_as="riccati_chunk" if Bn >= LANE_BATCH
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
