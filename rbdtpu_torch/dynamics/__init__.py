"""Dynamics algorithms on torch tensors (fixed-base models and both
floating roots, rpy and quaternion)."""
from .xforms import joint_transforms_list, joint_transforms_hom_list
from .rnea import (
    rnea, rnea_fpass, rnea_bpass, gravity_accel, apply_external_forces,
)
from .minv import minv, minv_bpass, minv_fpass
from .aba import aba
from .rnea_grad import rnea_grad, rnea_grad_fpass, rnea_grad_bpass
from .fd import forward_dynamics, forward_dynamics_full

__all__ = [
    "joint_transforms_list", "joint_transforms_hom_list",
    "rnea", "rnea_fpass", "rnea_bpass", "gravity_accel",
    "apply_external_forces",
    "minv", "minv_bpass", "minv_fpass", "aba",
    "rnea_grad", "rnea_grad_fpass", "rnea_grad_bpass",
    "forward_dynamics", "forward_dynamics_full",
]
