"""Spatial algebra on torch tensors (the subset of ``rbdtpu.spatial`` the
ported dynamics and kinematics use)."""
from .ops import (
    skew, crm, crf, icrf, cross_motion, cross_force, vxIv, factor_inertia,
    dot_inertia, mcI, mv, mtv, xtax, cholesky_small, cholesky_solve_small,
    solve_small,
)
from .transforms import (
    REVOLUTE, PRISMATIC, FLOATING, FIXED, rot_axis, drot_axis, d2rot_axis,
    joint_spatial_x, joint_hom_T, joint_hom_dT, joint_hom_d2T, x_force_inv_T, rpy_to_R,
    plux, hom, floating_spatial_x, floating_hom_T, floating_quat_spatial_x,
    floating_quat_hom_T,
)
from .quat import (
    quat_identity, quat_normalize, quat_mul, quat_conj, quat_to_R, quat_exp,
    quat_log, quat_from_rpy, so3_right_jacobian, so3_right_jacobian_inv,
)

__all__ = [
    "skew", "crm", "crf", "icrf", "cross_motion", "cross_force", "vxIv",
    "factor_inertia", "dot_inertia", "mcI", "mv", "mtv", "xtax",
    "REVOLUTE", "PRISMATIC", "FLOATING", "FIXED", "rot_axis", "drot_axis",
    "d2rot_axis", "joint_spatial_x", "joint_hom_T", "joint_hom_dT",
    "joint_hom_d2T", "x_force_inv_T",
    "rpy_to_R", "plux", "hom", "floating_spatial_x", "floating_hom_T",
    "floating_quat_spatial_x", "floating_quat_hom_T", "quat_identity",
    "quat_normalize", "quat_mul", "quat_conj", "quat_to_R", "quat_exp",
    "quat_log", "quat_from_rpy", "so3_right_jacobian",
    "so3_right_jacobian_inv",
    "cholesky_small", "cholesky_solve_small", "solve_small",
]
