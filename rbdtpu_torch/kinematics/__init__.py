"""Forward kinematics on torch tensors (fixed-base models and the rpy root)."""
from .fk import fk_world_hom, ee_pose, ee_position_jacobian_tangent

__all__ = ["fk_world_hom", "ee_pose", "ee_position_jacobian_tangent"]
