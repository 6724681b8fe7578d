"""rbdtpu_torch — the PyTorch/CUDA port of rbdtpu.

Mirrors ``rbdtpu``'s layout module for module.  Plain tensor code is PyTorch;
the four TPU kernels on the arm end-effector DDP path are CUDA C++ kernels for
Hopper (``csrc/``), built on first use and bound with ctypes
(``kernels._lib``).  Imports torch, numpy and the standard library only.
"""
from . import spatial, model, dynamics, kinematics, solver, kernels

__version__ = "0.1.0"
