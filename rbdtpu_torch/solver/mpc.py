"""Receding-horizon MPC loop and solver-state checkpointing
(``rbdtpu.solver.mpc``).

rbdtpu's ``mpc_step`` takes one problem and is batched by ``jax.vmap``;
here it is natively batched over the leading dims of the carry (the
kernels are not vmappable), and equals rbdtpu's step on each problem.
``mpc_run`` is a Python loop over ticks in place of ``lax.scan``.  The
plant advances by the plain ``aba`` and the semi-implicit Euler step, as in
rbdtpu.  Checkpoints are numpy ``.npz`` files with one ``leaf<i>`` entry
per field, in field order, the layout rbdtpu writes, so each package reads
the other's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dynamics.aba import aba
from ..model.robot import RobotModel
from .costs import Cost
from .ddp import DDPConfig, ddp_solve
from .integrate import euler_semi_implicit, split_state


class MPCCarry(NamedTuple):
    x: torch.Tensor  # (..., nx) current state
    U: torch.Tensor  # (..., H, nv) warm-start control sequence


def mpc_step(model: RobotModel, cost: Cost, carry: MPCCarry,
             config: DDPConfig = DDPConfig()):
    """One receding-horizon step: solve from the current state
    (warm-started), apply the first control, advance the plant one dt,
    shift the plan.  Returns (new_carry, (u_applied (..., nv), J (...)))."""
    state, _ = ddp_solve(model, cost, carry.x, carry.U, config)
    u0 = state.U[..., 0, :]
    q, qd = split_state(model, carry.x)
    qdd = aba(model, q, qd, u0, gravity=config.gravity)
    x_next = euler_semi_implicit(model, carry.x, qdd, config.dt)
    U_warm = torch.cat([state.U[..., 1:, :], state.U[..., -1:, :]], dim=-2)
    return MPCCarry(x_next, U_warm), (u0, state.J)


def mpc_run(model: RobotModel, cost: Cost, x0, U0, n_steps: int,
            config: DDPConfig = DDPConfig()):
    """Closed-loop MPC for ``n_steps`` plant steps from x0 (..., nx) with
    the warm start U0 (..., H, nv).  Returns (final_carry, (U_applied
    (n_steps, ..., nv), J_hist (n_steps, ...))), tick-major as rbdtpu's
    scan stacks them."""
    carry = MPCCarry(x0, U0)
    us, Js = [], []
    for _ in range(n_steps):
        carry, (u, J) = mpc_step(model, cost, carry, config)
        us.append(u)
        Js.append(J)
    return carry, (torch.stack(us), torch.stack(Js))


def save_solver_state(path: str, state: NamedTuple) -> None:
    """Write a DDPState (or any NamedTuple of tensors) to ``path`` as .npz,
    field i under ``leaf<i>``."""
    np.savez(path, **{f"leaf{i}": t.detach().cpu().numpy()
                      for i, t in enumerate(state)})


def load_solver_state(path: str, like: NamedTuple) -> NamedTuple:
    """Read a state written by ``save_solver_state`` (here or by rbdtpu) as
    ``like``'s type, each field on the device of ``like``'s, in the dtype
    it was saved in."""
    with np.load(path) as data:
        return type(like)(*(
            torch.as_tensor(data[f"leaf{i}"], device=ref.device)
            for i, ref in enumerate(like)))
