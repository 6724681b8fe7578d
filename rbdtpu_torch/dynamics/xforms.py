"""Per-joint transforms shared by the dynamics sweeps
(``rbdtpu.dynamics.xforms``).

Fixed-base models and the rpy floating root (q[0:6] = [x, y, z, roll,
pitch, yaw], joint i > 0 at q[i + 5]).  The quaternion root is not ported
yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

from ..model.robot import RobotModel
from ..spatial.transforms import (
    floating_hom_T, floating_spatial_x, joint_hom_T, joint_spatial_x,
)


def refuse_quat_root(model: RobotModel):
    if model.floating_base and model.root_quat:
        raise NotImplementedError(
            "rbdtpu_torch covers fixed-base models and the rpy floating "
            "root; the quaternion root is not ported yet")


def q_per_joint(model: RobotModel, q):
    """The coordinate of each 1-DoF joint: (..., nq) -> list of NB (...)
    tensors; the rpy root's slot is None (its six coordinates are q[0:6])
    and joint i > 0 reads q[i + 5]."""
    refuse_quat_root(model)
    if model.floating_base:
        return [None] + [q[..., i + 5] for i in range(1, model.nb)]
    return [q[..., i] for i in range(model.nb)]


def joint_transforms_list(model: RobotModel, q):
    """Per-body parent->child spatial transforms: list of (..., 6, 6)."""
    qj = q_per_joint(model, q)
    return [
        floating_spatial_x(model.Xtree[0], q[..., 0:6]) if qj[i] is None
        else joint_spatial_x(model.joint_type[i], model.axis[i],
                             model.Xtree[i], qj[i])
        for i in range(model.nb)
    ]


def joint_transforms_hom_list(model: RobotModel, q):
    """Per-body child->parent homogeneous transforms: list of (..., 4, 4)."""
    qj = q_per_joint(model, q)
    return [
        floating_hom_T(model.Ttree[0], q[..., 0:6]) if qj[i] is None
        else joint_hom_T(model.joint_type[i], model.axis[i], model.Ttree[i],
                         qj[i])
        for i in range(model.nb)
    ]
