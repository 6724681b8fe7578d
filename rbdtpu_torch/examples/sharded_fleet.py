"""Fleet-scale scenario MPC sharded over ranks: the multi-device
deployment shape of BASELINE.json's north star, on one machine.

    python -m rbdtpu_torch.examples.sharded_fleet                (2 ranks,
        NCCL: needs 2 cards)
    python -m rbdtpu_torch.examples.sharded_fleet --backend gloo   (2 ranks
        sharing the card)
    python -m rbdtpu_torch.examples.sharded_fleet --device cpu

rbdtpu's examples/sharded_fleet.py on the port, started through
``rbdtpu_torch.distrib.launch`` (each rank one process): one nominal arm
state fanned into B disturbance hypotheses, the fan sharded over every
rank by ``sharded_ddp_solve`` (each rank's natively batched solve runs the
kernels on the card), every rank's share checked against a single-process
solve of the whole fan, and the lowest-cost plan pulled out with one
argmin.  It asserts what it prints: the sharded and single-process costs
agree within 1e-5 (float32; the sums of two batch sizes need not round
alike), not bit for bit.  Ranks that share a card or the CPU check the
harness; their times are no scaling result.
"""
from __future__ import annotations

import argparse
import sys
import time

TOL = 1e-5


def run(mesh, argv) -> int:
    """The launcher's entry: ``argv`` holds the fan's sizes."""
    import numpy as np
    import torch

    from rbdtpu_torch.distrib import replicate, sharded_ddp_solve
    from rbdtpu_torch.model import load_asset
    from rbdtpu_torch.solver import (
        DDPConfig, ddp_solve, quadratic_tracking_cost,
    )

    ap = argparse.ArgumentParser(prog="sharded_fleet")
    ap.add_argument("--per-rank", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--iters", type=int, default=6)
    a = ap.parse_args(argv)

    axes = ("host", "batch")
    model = replicate(mesh, load_asset("arm7", device="cpu",
                                       dtype=torch.float32))
    kw = dict(dtype=torch.float32, device=mesh.device)
    nx, nv, H = model.nx, model.nv, a.horizon
    B = a.per_rank * mesh.world_size  # scenarios, divisible by the ranks
    # scenario fan: the nominal reach start plus initial-state noise, the
    # same on every rank
    rng = np.random.default_rng(7)
    x_nom = np.zeros(nx, np.float32)
    x_nom[:model.nq] = 0.3
    x0 = torch.tensor(x_nom + 0.05 * rng.standard_normal((B, nx)), **kw)
    U0 = torch.zeros(B, H, nv, **kw)
    cost = quadratic_tracking_cost(model, torch.zeros(nx, **kw), w_q=1.0,
                                   w_qd=0.01, w_u=1e-4)
    cfg = DDPConfig(iters=a.iters, dt=0.01, fused=mesh.device.type == "cuda")

    t0 = time.perf_counter()
    J, U, mean_J = sharded_ddp_solve(mesh, model, cost, x0, U0, cfg,
                                     axis=axes)
    J_host = J.cpu()
    t1 = time.perf_counter()
    states, _ = ddp_solve(model, cost, x0, U0, cfg)
    dJ = (states.J.cpu() - J_host).abs().max().item()
    ok = dJ < TOL
    if mesh.rank == 0:
        best = int(J_host.argmin())
        print(f"mesh {dict(zip(mesh.axis_names, mesh.shape))} over "
              f"{mesh.world_size} ranks ({mesh.backend}, {mesh.device})")
        print(f"sharded solve: {B} scenarios x H={H} in {t1 - t0:.1f} s "
              f"(first call, kernels included); mean J = {mean_J.item():.3f}")
        print(f"sharded vs single-process |dJ|_max = {dJ:.2e} (bound {TOL:g})")
        print(f"consensus plan: scenario {best}, J = {J_host[best]:.3f} "
              f"(worst {J_host.max():.3f})")
        print("OK" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None) -> int:
    from rbdtpu_torch.distrib import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    a, sizes = ap.parse_known_args(argv)
    opts = ["--num-processes", str(a.num_processes), "--device", a.device,
            "--entry", "rbdtpu_torch.examples.sharded_fleet:run"]
    if a.backend:
        opts += ["--backend", a.backend]
    return launch.main(opts + ["--"] + sizes)


if __name__ == "__main__":
    sys.exit(main())
