"""Forward kinematics on torch tensors (fixed-base models and both floating
roots)."""
from .fk import (
    fk_world_hom, ee_pose, ee_pose_gradient, ee_pose_hessian,
    ee_position_jacobian_tangent,
)

__all__ = ["fk_world_hom", "ee_pose", "ee_pose_gradient", "ee_pose_hessian",
           "ee_position_jacobian_tangent"]
