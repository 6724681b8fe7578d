"""URDF -> RobotModel parser (stdlib xml; no external deps) — the torch twin
of ``rbdtpu.model.urdf``, identical parse-time float64 numpy math.

Owns the L0 layer that the reference outsources to A2R-Lab's URDFParser package
(SURVEY.md §0, §1.1): it produces the kinematic tree topology, fixed tree
transforms X(tree) / T(tree), motion subspaces S, spatial inertias I, damping and
index maps that every dynamics algorithm consumes.

Design (host-side, parse once):
  - bodies are the child links of *moving* joints, numbered in root-to-leaf
    (topological) order;
  - fixed joints are merged: their child link's inertia is lumped into the parent
    body (I += X^T I_child X) and terminal fixed joints are kept as named
    "fixed frames" for end-effector kinematics (the reference exposes these via
    ``get_fixed_joint_by_name`` / ``get_fixed_joint_by_id``, RBDReference.py:206,269);
  - a ``floating`` root joint (or floating_base=True) yields a 6-DoF root with
    q = [x, y, z, roll, pitch, yaw] and S = eye(6), matching the reference's
    Px,Py,Pz,Rx,Ry,Rz floating-base representation (SURVEY.md §1.1).

All parse-time math is float64 numpy; the returned model's tensors are on the
requested device in the requested dtype.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from .robot import RobotModel, make_model
from ..spatial.transforms import REVOLUTE, PRISMATIC, FLOATING


def _rpy_to_R(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _skew(r):
    return np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])


def _hom(R, p):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def _plux(E, r):
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ _skew(r)
    return X


def _hom_to_spatial(T: np.ndarray) -> np.ndarray:
    """Motion transform parent->child from the child->parent homogeneous T."""
    R, p = T[:3, :3], T[:3, 3]
    return _plux(R.T, p)


def _parse_origin(el: Optional[ET.Element]):
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if el is not None:
        if el.get("xyz"):
            xyz = np.array([float(v) for v in el.get("xyz").split()])
        if el.get("rpy"):
            rpy = np.array([float(v) for v in el.get("rpy").split()])
    return _hom(_rpy_to_R(rpy), xyz)


def _parse_inertial(link: ET.Element):
    """Returns 6x6 spatial inertia of the link in the link frame."""
    inertial = link.find("inertial")
    if inertial is None:
        return np.zeros((6, 6))
    T_com = _parse_origin(inertial.find("origin"))
    R, c = T_com[:3, :3], T_com[:3, 3]
    mass_el = inertial.find("mass")
    m = float(mass_el.get("value")) if mass_el is not None else 0.0
    ine = inertial.find("inertia")
    if ine is not None:
        ixx = float(ine.get("ixx", 0)); iyy = float(ine.get("iyy", 0))
        izz = float(ine.get("izz", 0)); ixy = float(ine.get("ixy", 0))
        ixz = float(ine.get("ixz", 0)); iyz = float(ine.get("iyz", 0))
        I_com = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    else:
        I_com = np.zeros((3, 3))
    I_C = R @ I_com @ R.T  # rotate inertia into link-frame axes
    cx = _skew(c)
    I6 = np.zeros((6, 6))
    I6[:3, :3] = I_C + m * cx @ cx.T
    I6[:3, 3:] = m * cx
    I6[3:, :3] = m * cx.T
    I6[3:, 3:] = m * np.eye(3)
    return I6


class _Joint:
    def __init__(self, el: ET.Element):
        self.name = el.get("name")
        self.type = el.get("type")
        self.parent_link = el.find("parent").get("link")
        self.child_link = el.find("child").get("link")
        self.T_origin = _parse_origin(el.find("origin"))
        ax = el.find("axis")
        self.axis = (
            np.array([float(v) for v in ax.get("xyz").split()])
            if ax is not None
            else np.array([0.0, 0.0, 1.0])
        )
        n = np.linalg.norm(self.axis)
        if n > 0:
            self.axis = self.axis / n
        dyn = el.find("dynamics")
        self.damping = float(dyn.get("damping", 0.0)) if dyn is not None else 0.0
        lim = el.find("limit")
        inf = float("inf")
        self.effort = float(lim.get("effort", inf)) if lim is not None else inf
        self.velocity = (
            float(lim.get("velocity", inf)) if lim is not None else inf
        )
        # continuous joints are unbounded in position regardless of <limit>
        if self.type == "continuous" or lim is None:
            self.lower, self.upper = -inf, inf
        else:
            self.lower = float(lim.get("lower", -inf))
            self.upper = float(lim.get("upper", inf))


def parse_urdf(
    source: str,
    *,
    floating_base: bool = False,
    root_quat: bool = False,
    device="cpu",
    dtype=torch.float32,
) -> RobotModel:
    """Parse a URDF file path or XML string into a RobotModel.

    floating_base: treat the root link as a floating 6-DoF body (also triggered
    by an explicit ``<joint type="floating">`` at the root).
    root_quat: use the singularity-free quaternion root parameterization
    (q = [xyz, wxyz, joints...], nq = nb + 6) instead of the reference's rpy
    root.  Velocity coordinates are identical either way.
    """
    if source.lstrip().startswith("<"):
        root_el = ET.fromstring(source)
    else:
        root_el = ET.parse(source).getroot()
    name = root_el.get("name", "robot")

    links: Dict[str, ET.Element] = {
        l.get("name"): l for l in root_el.findall("link")
    }
    joints = [_Joint(j) for j in root_el.findall("joint")]
    child_links = {j.child_link for j in joints}
    root_links = [ln for ln in links if ln not in child_links]
    if len(root_links) != 1:
        raise ValueError(f"expected one root link, found {root_links}")
    root_link = root_links[0]

    joints_by_parent: Dict[str, List[_Joint]] = {}
    for j in joints:
        joints_by_parent.setdefault(j.parent_link, []).append(j)

    # explicit floating root joint?
    root_joints = joints_by_parent.get(root_link, [])
    if len(root_joints) == 1 and root_joints[0].type == "floating":
        floating_base = True

    # --- accumulators -------------------------------------------------- #
    parent: List[int] = []
    joint_type: List[int] = []
    axes: List[np.ndarray] = []
    Ttree: List[np.ndarray] = []
    S_rows: List[np.ndarray] = []
    I_list: List[np.ndarray] = []
    damping: List[float] = []
    joint_names: List[str] = []
    body_names: List[str] = []
    fixed_names: List[str] = []
    fixed_parent: List[int] = []
    T_fixed: List[np.ndarray] = []
    eff_l: List[float] = []
    vel_l: List[float] = []
    q_lo: List[float] = []
    q_hi: List[float] = []

    _S_AXIS = {
        REVOLUTE: lambda a: np.concatenate([a, np.zeros(3)]),
        PRISMATIC: lambda a: np.concatenate([np.zeros(3), a]),
    }

    def add_body(jname, blink, jtype, ax, T_or, damp, parent_body,
                 limits=None):
        body_id = len(parent)
        parent.append(parent_body)
        joint_type.append(jtype)
        axes.append(ax)
        Ttree.append(T_or)
        S_rows.append(
            np.zeros(6) if jtype == FLOATING else _S_AXIS[jtype](ax)
        )
        I_list.append(_parse_inertial(links[blink]))
        damping.append(damp)
        joint_names.append(jname)
        body_names.append(blink)
        inf = float("inf")
        eff, vel, lo, hi = limits if limits is not None else (inf, inf,
                                                              -inf, inf)
        eff_l.append(eff)
        vel_l.append(vel)
        q_lo.append(lo)
        q_hi.append(hi)
        return body_id

    def descend(link_name: str, body_id: int, T_to_body: np.ndarray):
        """Process all joints hanging off `link_name`, which is rigidly attached
        to moving body `body_id` via homogeneous transform T_to_body
        (link frame -> body frame)."""
        for j in joints_by_parent.get(link_name, []):
            T_joint = T_to_body @ j.T_origin  # joint frame in body-frame coords
            if j.type == "fixed":
                # lump child link inertia into this body, then recurse
                X = _hom_to_spatial(T_joint)  # motion body -> child-link frame
                I_child = _parse_inertial(links[j.child_link])
                I_list[body_id] = I_list[body_id] + X.T @ I_child @ X
                if j.child_link not in joints_by_parent:
                    # terminal fixed joint: keep as a named frame (EE mount)
                    fixed_names.append(j.name)
                    fixed_parent.append(body_id)
                    T_fixed.append(T_joint)
                descend(j.child_link, body_id, T_joint)
            elif j.type in ("revolute", "continuous", "prismatic"):
                jt = PRISMATIC if j.type == "prismatic" else REVOLUTE
                bid = add_body(
                    j.name, j.child_link, jt, j.axis, T_joint, j.damping,
                    body_id, limits=(j.effort, j.velocity, j.lower, j.upper),
                )
                descend(j.child_link, bid, np.eye(4))
            elif j.type == "floating":
                bid = add_body(
                    j.name, j.child_link, FLOATING, np.array([0.0, 0, 1]),
                    T_joint, 0.0, body_id,
                )
                descend(j.child_link, bid, np.eye(4))
            else:
                raise ValueError(f"unsupported joint type: {j.type}")

    if floating_base and not (
        len(root_joints) == 1 and root_joints[0].type == "floating"
    ):
        # implicit floating base: the root link itself becomes body 0
        add_body(
            "root", root_link, FLOATING, np.array([0.0, 0, 1]), np.eye(4), 0.0, -1
        )
        descend(root_link, 0, np.eye(4))
    else:
        # fixed base: root link is the immobile world; its joints start the tree.
        # Worklist of (joint, composed origin from world) handles fixed joints
        # chained off the world before the first moving joint.
        work = [(j, j.T_origin) for j in joints_by_parent.get(root_link, [])]
        while work:
            j, T_or = work.pop(0)
            if j.type == "fixed":
                for sj in joints_by_parent.get(j.child_link, []):
                    work.append((sj, T_or @ sj.T_origin))
                continue
            jt = {
                "revolute": REVOLUTE,
                "continuous": REVOLUTE,
                "prismatic": PRISMATIC,
                "floating": FLOATING,
            }[j.type]
            bid = add_body(
                j.name, j.child_link, jt, j.axis, T_or, j.damping, -1,
                limits=None if jt == FLOATING
                else (j.effort, j.velocity, j.lower, j.upper),
            )
            descend(j.child_link, bid, np.eye(4))

    nb = len(parent)
    Ttree_a = np.stack(Ttree) if nb else np.zeros((0, 4, 4))
    Xtree_a = np.stack([_hom_to_spatial(T) for T in Ttree]) if nb else np.zeros((0, 6, 6))
    fb = bool(joint_type and joint_type[0] == FLOATING)

    return make_model(
        parent=parent,
        joint_type=joint_type,
        axis=np.stack(axes) if nb else np.zeros((0, 3)),
        Xtree=Xtree_a,
        Ttree=Ttree_a,
        S=np.stack(S_rows) if nb else np.zeros((0, 6)),
        I=np.stack(I_list) if nb else np.zeros((0, 6, 6)),
        damping=np.array(damping),
        effort_limit=np.array(eff_l),
        velocity_limit=np.array(vel_l),
        q_lower=np.array(q_lo),
        q_upper=np.array(q_hi),
        floating_base=fb,
        root_quat=root_quat and fb,
        joint_names=joint_names,
        body_names=body_names,
        fixed_frame_names=fixed_names,
        fixed_frame_parent=fixed_parent,
        T_fixed=np.stack(T_fixed) if T_fixed else None,
        name=name,
        device=device,
        dtype=dtype,
    )
