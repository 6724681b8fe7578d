"""The parity-oracle layer (``rbdtpu.oracle``): the URDFParser-style
adapter, the loader of the numpy reference class, and the serial numpy
DDP that a reference-compatible dynamics object drives."""
import importlib.util
import os

from .adapter import OracleRobotAdapter
from .ddp_numpy import NumpyDDP, QuadTrackingCostNp

# the directory holding the reference's RBDReference.py (read only)
REFERENCE_PATH = os.environ.get("RBD_REFERENCE_PATH")


def load_reference_class():
    """The reference ``RBDReference`` class, loaded from
    ``REFERENCE_PATH/RBDReference.py`` (the ``RBD_REFERENCE_PATH``
    environment variable); None when it is not there.  Nothing is copied
    into this repository."""
    if not REFERENCE_PATH:
        return None
    path = os.path.join(REFERENCE_PATH, "RBDReference.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("rbd_reference_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.RBDReference


__all__ = ["OracleRobotAdapter", "NumpyDDP", "QuadTrackingCostNp",
           "load_reference_class", "REFERENCE_PATH"]
