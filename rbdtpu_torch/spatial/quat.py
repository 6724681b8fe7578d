"""Unit-quaternion algebra of the quaternion floating root
(``rbdtpu.spatial.quat``).

Quaternions are (..., 4) tensors in wxyz order, Hamilton product, unit
norm, acting as active rotations: R(q) rotates body-frame vectors into the
parent/world frame.  Tangent vectors are body-frame rotation vectors phi
(axis * angle): the retraction is q' = q (x) exp(phi / 2).  The small-angle
branches switch to their Taylor forms below a squared angle of 1e-12 and
are selected with ``torch.where`` on both computed values, as rbdtpu does.
"""
from __future__ import annotations

import torch

from .ops import skew

_EPS2 = 1e-12  # squared-angle threshold of the Taylor branches


def quat_identity(dtype=torch.float32, device="cuda"):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(a, b):
    """Hamilton product a (x) b: (..., 4), (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_to_R(q):
    """Active rotation matrix of a unit quaternion: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_exp(phi):
    """Rotation vector -> unit quaternion [cos(|phi|/2), sin(|phi|/2) n],
    with the sinc's Taylor branch at phi = 0."""
    n2 = (phi * phi).sum(-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=_EPS2))
    half = 0.5 * n
    small = n2 < _EPS2
    w = torch.where(small, 1.0 - n2 / 8.0, torch.cos(half))
    s = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / n)
    return torch.cat([w, s * phi], dim=-1)


def quat_log(q):
    """Unit quaternion -> rotation vector (the inverse of quat_exp),
    (..., 4) -> (..., 3): the minimal rotation (angle in [0, pi]) by the
    sign of the scalar part."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    n2 = (v * v).sum(-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=_EPS2))
    angle = 2.0 * torch.atan2(n, w)
    small = n2 < _EPS2
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / n)
    return scale * v


def quat_from_rpy(rpy):
    """URDF extrinsic-XYZ rpy -> quaternion."""
    r, p, y = (0.5 * a for a in rpy.unbind(-1))
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def so3_right_jacobian_inv(phi):
    """Inverse right Jacobian of SO(3): Jr^-1 = I + phi^/2 + c phi^^2 with
    c = 1/|phi|^2 - (1 + cos)/(2 |phi| sin), Taylor branch at 0:
    (..., 3) -> (..., 3, 3)."""
    n2 = (phi * phi).sum(-1)[..., None, None]
    n = torch.sqrt(torch.clamp(n2, min=_EPS2))
    small = n2 < _EPS2
    s = torch.sin(n)
    c = torch.where(
        small, 1.0 / 12.0 + n2 / 720.0,
        1.0 / n2 - (1.0 + torch.cos(n)) / (2.0 * n * torch.clamp(s, min=_EPS2)))
    K = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + 0.5 * K + c * (K @ K)


def so3_right_jacobian(phi):
    """Right Jacobian of SO(3): Jr = I - c1 phi^ + c2 phi^^2 with
    c1 = (1 - cos)/|phi|^2, c2 = (|phi| - sin)/|phi|^3, Taylor branches at
    0: (..., 3) -> (..., 3, 3)."""
    n2 = (phi * phi).sum(-1)[..., None, None]
    n = torch.sqrt(torch.clamp(n2, min=_EPS2))
    small = n2 < _EPS2
    c1 = torch.where(small, 0.5 - n2 / 24.0, (1.0 - torch.cos(n)) / n2)
    c2 = torch.where(small, 1.0 / 6.0 - n2 / 120.0,
                     (n - torch.sin(n)) / (n2 * n))
    K = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye - c1 * K + c2 * (K @ K)
