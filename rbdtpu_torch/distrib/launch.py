"""Start N ranks on this machine and run a sharded program on them (the
port's counterpart of rbdtpu's ``tools/launch_multihost.py``):

    python -m rbdtpu_torch.distrib.launch --num-processes N \\
        [--backend nccl|gloo] [--device cpu|cuda] \\
        [--entry MODULE:FUNCTION] [-- ARGS...]

The parent starts N workers with the torchrun environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; the rendezvous on a free port of 127.0.0.1), waits, and
exits nonzero when any worker does (stopping the others).  Each worker
builds the 2-D ("host", "batch") mesh over every rank, of shape (2, N / 2)
for an even N and (1, N) otherwise, and calls ``FUNCTION(mesh, ARGS) -> exit code``.  The default entry,
``self_check``, is rbdtpu's worker: a sharded batch of DDP solves with the
problem batch sharded over both axes, each rank holding its rows against a
process-local solve of the same seeded problems; rank 0 prints one JSON
line.

Backends: NCCL (the default on the card) gives each rank a card of its
own; ranks that share a card run over gloo (``--backend gloo``).  On one
machine with one card, numbers printed by ranks that share it (or the CPU)
check the harness; they are not a scaling result.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
import time

NOTE = ("ranks that share one card or the CPU: a check of the harness, "
        "not a scaling result")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hosts(n: int) -> int:
    """The mesh's host axis: two "hosts" of N / 2 ranks for an even N, so
    that both axes of rbdtpu's 2-D layout are exercised."""
    return 2 if n % 2 == 0 else 1


def parent(args, argv) -> int:
    """Start the workers, wait for all, stop the rest once one fails."""
    n = args.num_processes
    if n < 1:
        raise SystemExit(f"launch: --num-processes {n}")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, os.getcwd(), base.get("PYTHONPATH")) if p)
    base.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    if args.backend == "gloo":
        # every rank is on this machine: gloo's transport on the loopback
        base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for rank in range(n):
        env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rbdtpu_torch.distrib.launch", "--worker",
             *argv], env=env))
    rc = 0
    try:
        # a failed rank leaves the others waiting in a collective: stop them
        while any(p.poll() is None for p in procs) and not any(
                p.returncode not in (None, 0) for p in procs):
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.returncode != 0:
                print(f"launch: rank {rank} exited {p.returncode}",
                      file=sys.stderr)
                rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def _entry(spec: str):
    module, _, name = spec.partition(":")
    if not name:
        raise SystemExit(f"launch: --entry {spec!r} is not MODULE:FUNCTION")
    return getattr(importlib.import_module(module), name)


def worker(args, rest) -> int:
    import torch.distributed as dist

    from .mesh import make_mesh

    hosts = _hosts(args.num_processes)
    mesh = make_mesh(axis_names=("host", "batch"),
                     shape=(hosts, args.num_processes // hosts),
                     device=args.device, backend=args.backend)
    try:
        return int(_entry(args.entry)(mesh, rest))
    finally:
        dist.destroy_process_group()


def self_check(mesh, argv) -> int:
    """rbdtpu's launcher check: arm7 in float64, B = 2 x ranks problems
    from one seed on every rank, H = 6, 3 iterations, sharded over
    ("host", "batch"); each rank's rows and the mean J against a
    process-local solve of all the problems, within 1e-9."""
    import numpy as np
    import torch

    from ..model import load_asset
    from ..solver import DDPConfig, ddp_solve, quadratic_tracking_cost
    from .mesh import replicate, shard_batch
    from .sharded import sharded_ddp_solve

    axes = ("host", "batch")
    model = replicate(mesh, load_asset("arm7", device="cpu",
                                       dtype=torch.float64))
    B, H = 2 * mesh.world_size, 6
    cfg = DDPConfig(iters=3, dt=0.02, n_alphas=3)
    rng = np.random.default_rng(20260819)  # the same problems on every rank
    x0 = torch.tensor(rng.uniform(-0.2, 0.2, (B, model.nx)),
                      dtype=torch.float64, device=mesh.device)
    U0 = torch.zeros((B, H, model.nv), dtype=torch.float64,
                     device=mesh.device)
    cost = quadratic_tracking_cost(
        model, torch.zeros(model.nx, dtype=torch.float64, device=mesh.device))

    t0 = time.perf_counter()
    J_sh, U_sh, mean_J = sharded_ddp_solve(mesh, model, cost, x0, U0, cfg,
                                           axis=axes)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t_sh = time.perf_counter() - t0

    J_loc = ddp_solve(model, cost, x0, U0, cfg)[0].J
    err = (shard_batch(mesh, J_sh, axes)
           - shard_batch(mesh, J_loc, axes)).abs().max().item()
    mean_err = abs(mean_J.item() - J_loc.mean().item())
    ok = err < 1e-9 and mean_err < 1e-9
    print(f"rank {mesh.rank}: shard-vs-local max err {err:.2e}, mean err "
          f"{mean_err:.2e} -> {'OK' if ok else 'FAIL'}", flush=True)
    if mesh.rank == 0:
        print(json.dumps({
            "multihost": "ok" if ok else "fail",
            "processes": mesh.world_size,
            "backend": mesh.backend,
            "mesh": dict(zip(mesh.axis_names, mesh.shape)),
            "device": str(mesh.device),
            "problems": B,
            "sharded_solve_s": round(t_sh, 3),
            "note": NOTE,
        }), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, rest = argv, []
    if "--" in argv:
        i = argv.index("--")
        opts, rest = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(
        prog="python -m rbdtpu_torch.distrib.launch",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--entry", default="rbdtpu_torch.distrib.launch:"
                                       "self_check")
    args = ap.parse_args(opts)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    if args.worker:
        return worker(args, rest)
    return parent(args, [a for a in argv if a != "--worker"])


if __name__ == "__main__":
    sys.exit(main())
