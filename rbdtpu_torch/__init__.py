"""rbdtpu_torch — the PyTorch/CUDA port of rbdtpu.

Mirrors ``rbdtpu``'s layout module for module.  Plain tensor code is PyTorch;
every TPU kernel of ``rbdtpu`` — on the arm end-effector DDP path and its
receding-horizon MPC loop, the forward-dynamics rollout path, the
floating-base quadruped MPC path and the humanoid MPPI -> DDP hybrid with
its chunked-gain line search — is a CUDA C++ kernel for Hopper
(``csrc/``), built on first use and bound with ctypes (``kernels._lib``).
Model entry points build on the card unless given ``device="cpu"``.
Imports torch, numpy and the standard library only.
"""
from . import spatial, model, dynamics, kinematics, solver, kernels

__version__ = "0.1.0"
