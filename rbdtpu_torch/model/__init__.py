"""Robot model layer: URDF parsing -> RobotModel.

Every entry point here builds its tensors on the card unless the caller
passes ``device="cpu"``.
"""
import os

import numpy as np
import torch

from .robot import LEAVES, RobotModel, make_model
from .urdf import parse_urdf

# the port's own copies of the bundled URDFs
_ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


def load_asset(name: str, *, device="cuda", dtype=torch.float32,
               **kw) -> RobotModel:
    """Load a bundled model by name ('arm7', 'quadruped12', 'humanoid30')."""
    path = os.path.join(_ASSETS,
                        name if name.endswith(".urdf") else name + ".urdf")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bundled URDF at {os.path.normpath(path)}")
    return parse_urdf(path, device=device, dtype=dtype, **kw)


STATIC = ("parent", "joint_type", "floating_base", "joint_names",
          "body_names", "fixed_frame_names", "fixed_frame_parent",
          "root_quat", "name")


def model_from_numpy(leaves: dict, static: dict, device="cuda",
                     dtype=torch.float32) -> RobotModel:
    """Build the port's model from the numpy leaves (``LEAVES``) and static
    fields (``STATIC``) of an ``rbdtpu`` RobotModel, so that both packages
    compute on the same data."""
    missing = [k for k in LEAVES if k not in leaves] + [
        k for k in STATIC if k not in static]
    if missing:
        raise KeyError(f"model_from_numpy: missing fields {missing}")
    arrays = {k: np.asarray(leaves[k], dtype=np.float64) for k in LEAVES}
    return make_model(**arrays, **{k: static[k] for k in STATIC},
                      device=device, dtype=dtype)


__all__ = ["RobotModel", "make_model", "parse_urdf", "load_asset",
           "model_from_numpy", "LEAVES", "STATIC"]
