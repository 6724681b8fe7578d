"""Dynamics algorithms on torch tensors (fixed-base models and both
floating roots, rpy and quaternion), first and second order."""
from .xforms import joint_transforms_list, joint_transforms_hom_list
from .rnea import (
    rnea, rnea_fpass, rnea_bpass, gravity_accel, apply_external_forces,
    inverse_dynamics,
)
from .minv import minv, minv_bpass, minv_fpass
from .aba import aba
from .rnea_grad import rnea_grad, rnea_grad_fpass, rnea_grad_bpass
from .fd import forward_dynamics, forward_dynamics_full, forward_dynamics_grad
from .crba import crba
from .idsva import idsva_so, idsva_so_native, idsva_so_ad, fdsva_so

__all__ = [
    "joint_transforms_list", "joint_transforms_hom_list",
    "rnea", "rnea_fpass", "rnea_bpass", "gravity_accel",
    "apply_external_forces", "inverse_dynamics",
    "minv", "minv_bpass", "minv_fpass", "aba",
    "rnea_grad", "rnea_grad_fpass", "rnea_grad_bpass",
    "forward_dynamics", "forward_dynamics_full", "forward_dynamics_grad",
    "crba", "idsva_so", "idsva_so_native", "idsva_so_ad", "fdsva_so",
]
