"""Spatial algebra on torch tensors (the subset of ``rbdtpu.spatial`` the
ported dynamics and kinematics use)."""
from .ops import (
    skew, crm, crf, cross_motion, cross_force, mv, mtv, xtax, cholesky_small,
    cholesky_solve_small, solve_small,
)
from .transforms import (
    REVOLUTE, PRISMATIC, FLOATING, FIXED, rot_axis, drot_axis,
    joint_spatial_x, joint_hom_T, joint_hom_dT, x_force_inv_T, rpy_to_R,
    plux, hom, floating_spatial_x, floating_hom_T,
)

__all__ = [
    "skew", "crm", "crf", "cross_motion", "cross_force", "mv", "mtv", "xtax",
    "REVOLUTE", "PRISMATIC", "FLOATING", "FIXED", "rot_axis", "drot_axis",
    "joint_spatial_x", "joint_hom_T", "joint_hom_dT", "x_force_inv_T",
    "rpy_to_R", "plux", "hom", "floating_spatial_x", "floating_hom_T",
    "cholesky_small", "cholesky_solve_small", "solve_small",
]
