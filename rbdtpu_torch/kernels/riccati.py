"""The Riccati backward-sweep kernel at arm-class sizes (K11) beside its
plain PyTorch version (``solver.ddp.backward_pass``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  A state larger than NX_MAX is refused on both: that is the
chunked sweep's regime (``kernels.backward_pass_chunked``).
"""
from __future__ import annotations

import math

import torch

from . import _lib
from .riccati_chunk import SMEM_MAX, sweep_args

# the largest state the lane-scalar sweep takes (rbdtpu's routing bound,
# solver/ddp.py:539, and its kernel's "nx <= ~16" regime)
NX_MAX = 16


def smem_bytes(nx: int, nu: int, dtype) -> int:
    """Shared memory one block holds (csrc/riccati_fused.cu k11::layout,
    ``_lib.riccati_fused_values``)."""
    return _lib.riccati_fused_values(nx, nu) * torch.empty(
        (), dtype=dtype).element_size()


def backward_pass_fused(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg):
    """The Riccati sweep of ``solver.ddp.backward_pass`` (iLQR: control
    regularisation Quu + reg I, per-step symmetrisation, dV1 = sum k . Qu)
    for nx <= NX_MAX, one launch for the whole horizon.

    Inputs as ``kernels.backward_pass_chunked``: A (..., H, nx, nx),
    B (..., H, nx, nu), lx (..., H, nx), lu (..., H, nu), contiguous;
    lxx/luu/lux per knot (..., H, r, c) or constant (r, c); lfx (..., nx),
    lfxx (..., nx, nx) and reg (...) broadcast over the batch.  Returns
    (k (..., H, nu), K (..., H, nu, nx), dV1 (...), ok (...)); ok is False
    where some Quu + reg I was not positive definite, whose gains are NaN
    from that knot back.

    Kernel ``riccati_fused`` (csrc/riccati_fused.cu) replaces rbdtpu's
    ``kernels.riccati.backward_pass_fused`` (Pallas, riccati.py:102): one
    thread block per problem loops over the horizon with the carry, the
    knot's inputs (the next knot's arriving by cp.async) and the Q terms in
    shared memory, in four barrier-separated phases a knot: [Vxx; Vx^T]
    [A | B], then [A | B]^T [P | Pb], one thread an entry; a Gauss-Jordan
    solve of (Quu + reg I) [K | k] = -[Qux | Qu] on one warp, one lane a
    column; the Vxx/Vx update.  Latency-bound on the H100; the block's
    threads are ``_lib.riccati_fused_geometry``'s.  Any batch is taken as
    it is, with no padding; launches count as ``riccati_fused``.
    """
    nx, nu = A.shape[-1], B.shape[-1]
    if nx > NX_MAX:
        raise ValueError(
            f"backward_pass_fused: nx={nx} > {NX_MAX}; the lane-scalar sweep "
            "is for arm-class states, use the chunked sweep "
            "(kernels.backward_pass_chunked)")
    if not A.is_cuda:
        from ..solver.ddp import backward_pass
        return backward_pass(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg)
    nbytes = smem_bytes(nx, nu, A.dtype)
    if nbytes > SMEM_MAX:
        raise ValueError(f"riccati_fused: nx={nx}, nu={nu} in {A.dtype} "
                         f"needs {nbytes} bytes of shared memory a block; "
                         f"the H100 has {SMEM_MAX}")
    args, outs = sweep_args(A, B, lx, lu, lxx, luu, lux, lfx, lfxx, reg)
    Bn = math.prod(outs[2].shape)
    nt, smem, _ = _lib.riccati_fused_geometry(nx, nu, A.dtype, Bn,
                                              _lib.sm_count(A.device))
    _lib.launch("riccati_fused", None, A, *args, *outs, Bn, A.shape[-3], nx,
                nu, nt, smem)
    return outs
