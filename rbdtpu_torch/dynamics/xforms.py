"""Per-joint transforms shared by the dynamics sweeps (``rbdtpu.dynamics.xforms``).

Fixed-base models only: the floating roots (rpy and quaternion) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from ..model.robot import RobotModel
from ..spatial.transforms import joint_hom_T, joint_spatial_x


def require_fixed_base(model: RobotModel):
    if model.floating_base:
        raise NotImplementedError(
            "rbdtpu_torch covers fixed-base models; the floating-base root "
            "is not ported yet")


def joint_transforms_list(model: RobotModel, q):
    """Per-body parent->child spatial transforms: list of (..., 6, 6)."""
    require_fixed_base(model)
    return [
        joint_spatial_x(model.joint_type[i], model.axis[i], model.Xtree[i],
                        q[..., i])
        for i in range(model.nb)
    ]


def joint_transforms_hom_list(model: RobotModel, q):
    """Per-body child->parent homogeneous transforms: list of (..., 4, 4)."""
    require_fixed_base(model)
    return [
        joint_hom_T(model.joint_type[i], model.axis[i], model.Ttree[i],
                    q[..., i])
        for i in range(model.nb)
    ]
