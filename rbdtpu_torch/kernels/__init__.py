"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  ``_lib.launches`` counts the launches of each kernel."""
from ._lib import launches, reset_launches
from .fused import (
    fd_step_fused, fd_step_plain, feedback_rollout_fused,
    feedback_rollout_plain,
)
from .colvec import linearize_parts_fused, linearize_parts_plain, linearize_fused
from .fk_lane import ee_gn_fused, ee_gn_plain

__all__ = [
    "launches", "reset_launches",
    "fd_step_fused", "fd_step_plain",
    "feedback_rollout_fused", "feedback_rollout_plain",
    "linearize_parts_fused", "linearize_parts_plain", "linearize_fused",
    "ee_gn_fused", "ee_gn_plain",
]
