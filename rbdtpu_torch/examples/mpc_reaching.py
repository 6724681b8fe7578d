"""Batched DDP reaching and closed-loop MPC with the 7-DoF arm, on the card
by default.

    python -m rbdtpu_torch.examples.mpc_reaching               (CUDA)
    python -m rbdtpu_torch.examples.mpc_reaching --device cpu --batch 4 \\
        --horizon 20 --ticks 5

rbdtpu's examples/mpc_reaching.py on the port: URDF model -> batched
dynamics -> analytic-gradient DDP from a gravity-compensation warm start
(on the card every rollout, linearisation, EE quadratisation and line
search runs its kernel) -> a closed-loop receding-horizon MPC loop from
one of the start states.  It checks what it prints: the batch's mean cost
falls and the loop brings the end effector closer to the target.
"""
from __future__ import annotations

import argparse

import torch

from rbdtpu_torch.dynamics import rnea
from rbdtpu_torch.kinematics import ee_pose
from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import (
    DDPConfig, ddp_solve, ee_reaching_cost, mpc_run, rollout,
    trajectory_cost,
)

TARGET = (0.3, 0.2, 0.8)
WEIGHTS = dict(w_ee=10.0, w_ee_f=2000.0, w_u=1e-6, w_qd=1e-3, w_qd_f=0.1)


def ee_distance(model, x, target):
    return torch.linalg.vector_norm(
        ee_pose(model, x[..., :model.nq])[..., 0, :3] - target, dim=-1)


def run(device: str = "cuda", B: int = 64, H: int = 100, iters: int = 10,
        ticks: int = 50, seed: int = 0):
    """Returns a dict of what the example prints."""
    model = load_asset("arm7", device=device, dtype=torch.float32)
    kw = dict(dtype=torch.float32, device=model.device)
    target = torch.tensor(TARGET, **kw)
    cost = ee_reaching_cost(model, target, **WEIGHTS)
    fused = model.device.type == "cuda"

    # ---- one batch of open-loop solves from B start states -------------- #
    gen = torch.Generator().manual_seed(seed)
    q0 = (0.3 * torch.randn(B, model.nq, generator=gen)).to(**kw)
    zero = torch.zeros(B, model.nv, **kw)
    x0 = torch.cat([q0, zero], -1)
    U0 = rnea(model, q0, zero, zero)[0][:, None].expand(
        B, H, model.nv).contiguous()  # gravity compensation
    cfg = DDPConfig(iters=iters, dt=0.01, n_alphas=8, fused=fused)
    J0 = trajectory_cost(cost, rollout(model, x0, U0, cfg.dt, fused=fused),
                         U0)
    states, _ = ddp_solve(model, cost, x0, U0, cfg)
    dist = ee_distance(model, states.X[:, -1], target)

    # ---- closed-loop receding-horizon MPC from one state ---------------- #
    carry, _ = mpc_run(model, cost, x0[0], U0[0], ticks,
                       DDPConfig(iters=3, dt=0.01, n_alphas=4, fused=fused))
    return dict(J0=J0.mean().item(), J=states.J.mean().item(),
                ee_error=dist.mean().item(),
                mpc_start=ee_distance(model, x0[0], target).item(),
                mpc_end=ee_distance(model, carry.x, target).item(),
                ee_end=ee_pose(model, carry.x[:model.nq])[0, :3].tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    r = run(a.device, a.batch, a.horizon, a.iters, a.ticks, a.seed)
    print(f"batched solve: mean cost {r['J0']:.3f} -> {r['J']:.3f}, mean "
          f"final EE error {r['ee_error'] * 100:.1f} cm")
    print(f"closed-loop MPC after {a.ticks} ticks: EE at "
          f"{[round(v, 3) for v in r['ee_end']]}, target {list(TARGET)}; "
          f"distance {r['mpc_start']:.3f} -> {r['mpc_end']:.3f} m")
    if not r["J"] < r["J0"]:
        raise SystemExit("mpc_reaching: the solve did not lower the cost")
    if not r["mpc_end"] < r["mpc_start"]:
        raise SystemExit("mpc_reaching: the MPC loop did not approach the "
                         "target")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
