"""rbdtpu_torch — the PyTorch/CUDA port of rbdtpu.

Mirrors ``rbdtpu``'s layout module for module.  Plain tensor code is PyTorch;
the TPU kernels on the arm end-effector DDP path and on the forward-dynamics
rollout path are CUDA C++ kernels for Hopper (``csrc/``), built on first use
and bound with ctypes (``kernels._lib``).  Model entry points build on the
card unless given ``device="cpu"``.  Imports torch, numpy and the standard
library only.
"""
from . import spatial, model, dynamics, kinematics, solver, kernels

__version__ = "0.1.0"
