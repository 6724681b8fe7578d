"""Robust MPC under a disturbance push: floating-base quadruped balance, on
the card by default.

    python -m rbdtpu_torch.examples.push_recovery            (CUDA)
    python -m rbdtpu_torch.examples.push_recovery --device cpu

rbdtpu's examples/push_recovery.py on the port: a lateral push window is
modelled as per-knot world-frame wrenches on the trunk (``f_ext``), and
the planner line-searches the true disturbed rollouts.  On the card every
rollout of the disturbance-aware solve runs the kernels' wrench variants
(``fd_step`` for the initial rollout, ``feedback_rollout_fext`` for the
line search).  A disturbance-aware plan is compared with an oblivious plan,
both scored under the same push.
"""
from __future__ import annotations

import argparse

import torch

from rbdtpu_torch.model import load_asset
from rbdtpu_torch.solver import (
    DDPConfig, ddp_solve, quadratic_tracking_cost, rollout, trajectory_cost,
)

# rbdtpu's example: 8 problems, 40 knots, 8 iterations of 6 line-search
# steps, 80 N along +y on the trunk for knots 5-15
B, H, DT, ITERS, N_ALPHAS = 8, 40, 0.01, 8, 6
PUSH, PUSH_KNOTS = 80.0, (5, 15)


def push_wrenches(model, H: int, dtype, device):
    """(H, nb, 6) world-frame wrenches [n; f]: PUSH newtons along +y on the
    trunk (body 0) for the knots of PUSH_KNOTS, none elsewhere."""
    F = torch.zeros(H, model.nb, 6, dtype=dtype, device=device)
    F[PUSH_KNOTS[0]:PUSH_KNOTS[1], 0, 4] = PUSH
    return F


def run(device: str = "cuda", B: int = B, H: int = H, iters: int = ITERS,
        seed: int = 0, dtype=torch.float32):
    """Plan B quadrupeds standing at 0.35 m (0.05 N(0,1) on the joint
    angles, from ``seed``) with and without the push; returns (disturbed
    cost of the aware plan, disturbed cost of the oblivious plan), each the
    mean over the problems.  ``fused`` follows the device."""
    model = load_asset("quadruped12", device=device, dtype=dtype,
                       floating_base=True)
    nq, nv = model.nq, model.nv
    kw = dict(dtype=dtype, device=device)
    x_goal = torch.zeros(nq + nv, **kw)
    x_goal[2] = 0.35
    cost = quadratic_tracking_cost(model, x_goal, w_q=2.0, w_qd=0.05,
                                   w_u=1e-5)
    gen = torch.Generator().manual_seed(seed)
    q0 = torch.zeros(B, nq, dtype=dtype)
    q0[:, 2] = 0.35
    q0[:, 6:] += 0.05 * torch.randn(B, nv - 6, generator=gen, dtype=dtype)
    x0 = torch.cat([q0, torch.zeros(B, nv, dtype=dtype)], -1).to(device)
    U0 = torch.zeros(B, H, nv, **kw)
    F = push_wrenches(model, H, dtype, device)
    cfg = DDPConfig(iters=iters, dt=DT, n_alphas=N_ALPHAS,
                    fused=torch.device(device).type == "cuda")
    aware, _ = ddp_solve(model, cost, x0, U0, cfg, f_ext=F)
    oblivious, _ = ddp_solve(model, cost, x0, U0, cfg)
    X_obl = rollout(model, x0, oblivious.U, DT, f_ext=F, fused=cfg.fused)
    J_obl = trajectory_cost(cost, X_obl, oblivious.U)
    return float(aware.J.mean()), float(J_obl.mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    aware, oblivious = run(args.device)
    print(f"disturbed cost, disturbance-aware plan: {aware:.3f}")
    print(f"disturbed cost, oblivious plan:         {oblivious:.3f}")
    if not aware < oblivious:
        raise SystemExit("push-recovery: the robust plan should beat the "
                         "oblivious plan under the push")
    print("push-recovery: disturbance-aware planning wins, as expected")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
