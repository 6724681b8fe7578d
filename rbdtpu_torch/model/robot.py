"""RobotModel: the kinematic-tree model consumed by every algorithm.

The torch twin of ``rbdtpu.model.robot``: static topology as tuples (so the
tree sweeps loop over bodies in Python), numeric data as tensors on one
device in one dtype, and a float64 numpy copy (``host_data``) that the CUDA
kernels turn into their per-model tables (``kernels._lib.model_tables``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..spatial.transforms import FLOATING

# numeric fields, in rbdtpu.model.RobotModel's order
LEAVES = (
    "Xtree", "Ttree", "axis", "S", "I", "damping", "T_fixed",
    "effort_limit", "velocity_limit", "q_lower", "q_upper",
)
# the leaves the kernels read (rbdtpu's host_data keys)
HOST_KEYS = ("Xtree", "axis", "S", "I", "damping", "Ttree", "T_fixed")


@dataclasses.dataclass(frozen=True, eq=False)
class RobotModel:
    Xtree: torch.Tensor  # (NB, 6, 6) parent->joint spatial transform
    Ttree: torch.Tensor  # (NB, 4, 4) joint->parent homogeneous transform
    axis: torch.Tensor  # (NB, 3) joint axis in the joint frame
    S: torch.Tensor  # (NB, 6) motion subspace of each 1-DoF joint
    I: torch.Tensor  # (NB, 6, 6) spatial inertia in the body frame
    damping: torch.Tensor  # (NB,)
    T_fixed: torch.Tensor  # (NF, 4, 4) fixed (end-effector) frames
    effort_limit: torch.Tensor  # (NB,)
    velocity_limit: torch.Tensor  # (NB,)
    q_lower: torch.Tensor  # (NB,)
    q_upper: torch.Tensor  # (NB,)

    parent: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    floating_base: bool
    joint_names: Tuple[str, ...]
    body_names: Tuple[str, ...]
    fixed_frame_names: Tuple[str, ...]
    fixed_frame_parent: Tuple[int, ...]
    root_quat: bool = False
    name: str = "robot"
    # float64 numpy copies of HOST_KEYS, the source of the kernel tables
    host_data: dict = dataclasses.field(default_factory=dict, repr=False)
    # per-(device, dtype) kernel tables, filled on first kernel launch
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False)

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def nq(self) -> int:
        if self.floating_base:
            return self.nb + (6 if self.root_quat else 5)
        return self.nb

    @property
    def nv(self) -> int:
        return self.nb + 5 if self.floating_base else self.nb

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def device(self) -> torch.device:
        return self.I.device

    @property
    def dtype(self) -> torch.dtype:
        return self.I.dtype

    def v_index(self, i: int):
        if self.floating_base:
            return slice(0, 6) if i == 0 else i + 5
        return i

    def ancestors(self, i: int) -> Tuple[int, ...]:
        chain = []
        p = self.parent[i]
        while p != -1:
            chain.append(p)
            p = self.parent[p]
        return tuple(reversed(chain))

    def chain(self, i: int) -> Tuple[int, ...]:
        """Root-to-i path including i."""
        return self.ancestors(i) + (i,)

    def leaves(self) -> Tuple[int, ...]:
        has_child = set(self.parent)
        return tuple(i for i in range(self.nb) if i not in has_child)

    def u_limit_vector(self) -> torch.Tensor:
        """Per-velocity-coordinate effort bound (nv,) from URDF <limit effort>."""
        out = torch.full((self.nv,), float("inf"), dtype=self.dtype,
                         device=self.device)
        for i in range(self.nb):
            out[self.v_index(i)] = self.effort_limit[i]
        return out


def make_model(
    *,
    parent,
    joint_type,
    axis,
    Xtree,
    Ttree,
    S,
    I,
    damping=None,
    floating_base=False,
    root_quat=False,
    effort_limit=None,
    velocity_limit=None,
    q_lower=None,
    q_upper=None,
    joint_names=None,
    body_names=None,
    fixed_frame_names=(),
    fixed_frame_parent=(),
    T_fixed=None,
    name="robot",
    device="cpu",
    dtype=torch.float32,
) -> RobotModel:
    """Assemble a RobotModel from numpy arrays, validating topology (the
    checks of ``rbdtpu.model.make_model``)."""
    parent = tuple(int(p) for p in parent)
    joint_type = tuple(int(t) for t in joint_type)
    nb = len(parent)
    for i, p in enumerate(parent):
        if not (-1 <= p < i):
            raise ValueError(
                f"bodies must be topologically ordered: parent[{i}]={p}")
    n_roots = sum(1 for p in parent if p == -1)
    if n_roots < 1:
        raise ValueError("at least one root body expected")
    if floating_base and n_roots != 1:
        raise ValueError("floating_base model must have exactly one root")
    if floating_base and joint_type[0] != FLOATING:
        raise ValueError("floating_base model must have a FLOATING root joint")
    if root_quat and not floating_base:
        raise ValueError("root_quat requires floating_base=True")
    f64 = lambda a: np.asarray(a, dtype=np.float64)
    fill = lambda v, d: np.full((nb,), d) if v is None else f64(v)
    arrays = dict(
        Xtree=f64(Xtree), Ttree=f64(Ttree), axis=f64(axis), S=f64(S),
        I=f64(I),
        damping=fill(damping, 0.0),
        T_fixed=np.zeros((0, 4, 4)) if T_fixed is None else f64(T_fixed),
        effort_limit=fill(effort_limit, np.inf),
        velocity_limit=fill(velocity_limit, np.inf),
        q_lower=fill(q_lower, -np.inf),
        q_upper=fill(q_upper, np.inf),
    )
    tensors = {k: torch.tensor(v, dtype=dtype, device=device)
               for k, v in arrays.items()}
    return RobotModel(
        **tensors,
        parent=parent,
        joint_type=joint_type,
        floating_base=bool(floating_base),
        joint_names=tuple(joint_names or (f"joint{i}" for i in range(nb))),
        body_names=tuple(body_names or (f"body{i}" for i in range(nb))),
        fixed_frame_names=tuple(fixed_frame_names),
        fixed_frame_parent=tuple(int(p) for p in fixed_frame_parent),
        root_quat=bool(root_quat),
        name=name,
        host_data={k: arrays[k] for k in HOST_KEYS},
    )
