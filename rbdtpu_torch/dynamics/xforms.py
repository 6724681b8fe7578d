"""Per-joint transforms shared by the dynamics sweeps
(``rbdtpu.dynamics.xforms``).

Fixed-base models and both floating roots: the rpy root, q[0:6] = [x, y,
z, roll, pitch, yaw], and the quaternion root, q[0:7] = [x, y, z, qw, qx,
qy, qz]; joint i > 0 reads q[model.q_index(i)] (i + 5 or i + 6).
"""
from __future__ import annotations

from ..model.robot import RobotModel
from ..spatial.transforms import (
    floating_hom_T, floating_quat_hom_T, floating_quat_spatial_x,
    floating_spatial_x, joint_hom_T, joint_spatial_x,
)


def q_per_joint(model: RobotModel, q):
    """The coordinate of each 1-DoF joint: (..., nq) -> list of NB (...)
    tensors; a floating root's slot is None (its coordinates are
    q[model.q_index(0)])."""
    if model.floating_base:
        return [None] + [q[..., model.q_index(i)] for i in range(1, model.nb)]
    return [q[..., i] for i in range(model.nb)]


def _root(model: RobotModel, q, quat_fn, rpy_fn, tree):
    if model.root_quat:
        return quat_fn(tree, q[..., 0:7])
    return rpy_fn(tree, q[..., 0:6])


def joint_transforms_list(model: RobotModel, q):
    """Per-body parent->child spatial transforms: list of (..., 6, 6)."""
    qj = q_per_joint(model, q)
    return [
        _root(model, q, floating_quat_spatial_x, floating_spatial_x,
              model.Xtree[0]) if qj[i] is None
        else joint_spatial_x(model.joint_type[i], model.axis[i],
                             model.Xtree[i], qj[i])
        for i in range(model.nb)
    ]


def joint_transforms_hom_list(model: RobotModel, q):
    """Per-body child->parent homogeneous transforms: list of (..., 4, 4)."""
    qj = q_per_joint(model, q)
    return [
        _root(model, q, floating_quat_hom_T, floating_hom_T, model.Ttree[0])
        if qj[i] is None
        else joint_hom_T(model.joint_type[i], model.axis[i], model.Ttree[i],
                         qj[i])
        for i in range(model.nb)
    ]
