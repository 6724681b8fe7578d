"""Build, load and feed the CUDA kernels in ``rbdtpu_torch/csrc``.

The ``.cu`` sources are compiled with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface and loaded with ctypes.  The build happens on
first use, from the sources in the package only, into ``rbdtpu_torch/_build``
(named by a hash of the sources and flags, so an edited source rebuilds).

Every C entry point returns the ``cudaError_t`` of its launch; ``launch``
raises on a nonzero code and only then counts the launch in ``launches``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# compile-time bound on bodies per tree; equals rbd::NB_MAX in rbd_common.cuh
NB_MAX = 8
# per-body table stride; equals rbd::STRIDE (E 9, r 3, axis 3, I 36, S 6,
# Ttree rotation 9, Ttree translation 3)
STRIDE = 69

# launches per kernel since the last reset_launches(); a wrapper adds one
# only after its kernel launched without error
launches = {"fd_step": 0, "feedback_rollout": 0, "linearize_parts": 0,
            "ee_gn": 0, "ee_err": 0}

# C signatures after the leading (tab, itab, nb): p pointer, i int,
# s scalar of the kernel's dtype; every function ends with the stream
_SIGNATURES = {
    "fd_step": "pppiss",           # x u xo B dt gravity
    "feedback_rollout": "ppppppppiiss",  # x0 Xn Un kf Kf uclip Xo Uo B H dt g
    "linearize_parts": "pppppppis",  # q qd u Minv dcq dcd qdd B gravity
    "ee_gn": "pipssspppi",         # ee jid q tx ty tz e g0 H0 B
    "ee_err": "pipssspi",          # ee jid q tx ty tz e B
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile the kernels (once per source content); returns the .so path.
    The compiler's register/spill report is kept beside it as .ptxas.log."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"librbdtpu_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[p for p in srcs if p.endswith(".cu")]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{res.stdout}\n"
            f"{res.stderr}")
    with open(so[:-3] + ".ptxas.log", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for kernel, sig in _SIGNATURES.items():
        for dtype, suffix in _SUFFIX.items():
            codes = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "s": _CTYPE[dtype]}
            fn = getattr(lib, f"rbd_{kernel}_{suffix}")
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                           + [codes[c] for c in sig] + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def model_tables(model, device, dtype):
    """The model's kernel tables on ``device`` in ``dtype``, uploaded once
    per (model, device, dtype): per body [E, r, axis, I, S, Ttree R, Ttree p]
    (the compact (E, r) split of Xtree: X = [[E, 0], [-E r^, E]]), and the
    int32 [parent..., joint_type...]."""
    key = ("model", str(device), dtype)
    if key not in model._tables:
        hd = model.host_data
        rows = []
        for i in range(model.nb):
            X = hd["Xtree"][i]
            E = X[:3, :3]
            rh = -E.T @ X[3:, :3]
            T = hd["Ttree"][i]
            rows.append(np.concatenate([
                E.ravel(), [rh[2, 1], rh[0, 2], rh[1, 0]], hd["axis"][i],
                hd["I"][i].ravel(), hd["S"][i], T[:3, :3].ravel(), T[:3, 3],
            ]))
        tab = torch.tensor(np.concatenate(rows), dtype=dtype, device=device)
        itab = torch.tensor(list(model.parent) + list(model.joint_type),
                            dtype=torch.int32, device=device)
        model._tables[key] = (tab, itab)
    return model._tables[key]


def ee_table(model, fid, device, dtype):
    """The end-effector mount [R (row-major), p] of fixed frame ``fid``
    (identity for a joint frame), uploaded once per (model, fid, device,
    dtype)."""
    key = ("ee", fid, str(device), dtype)
    if key not in model._tables:
        T = np.eye(4) if fid is None else model.host_data["T_fixed"][fid]
        model._tables[key] = torch.tensor(
            np.concatenate([T[:3, :3].ravel(), T[:3, 3]]), dtype=dtype,
            device=device)
    return model._tables[key]


def check(t: torch.Tensor, name: str, shape, ref: torch.Tensor):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ref's
    device in ref's dtype."""
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"{name}: expected {ref.dtype} on {ref.device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(kernel: str, model, ref: torch.Tensor, *args):
    """Launch ``kernel`` for ``model`` on ref's device and dtype, on the
    current stream.  ``args`` follow the C signature after (tab, itab, nb):
    tensors (or None for a null pointer), ints and floats."""
    if ref.dtype not in _SUFFIX:
        raise ValueError(f"{kernel}: kernels take float32 or float64, got "
                         f"{ref.dtype}")
    if model.floating_base:
        raise NotImplementedError(
            f"{kernel}: the CUDA kernels cover fixed-base models; the "
            "floating-base root is not ported yet")
    if model.nb > NB_MAX:
        raise ValueError(f"{kernel}: {model.nb} bodies exceed the kernels' "
                         f"NB_MAX={NB_MAX}")
    fn = getattr(library(), f"rbd_{kernel}_{_SUFFIX[ref.dtype]}")
    tab, itab = model_tables(model, ref.device, ref.dtype)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(tab.data_ptr(), itab.data_ptr(), model.nb, *conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    launches[kernel] += 1
