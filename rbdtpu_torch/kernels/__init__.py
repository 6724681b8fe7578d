"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  ``_lib.launches`` counts the launches of each kernel (K2 and K9
with wrenches apart).  The tree kernels K1-K6, K9 and K10 cover
fixed-base models (up to 8 bodies), the rpy floating root and the
quaternion root (up to 32 bodies); the Riccati sweeps (K7/K8 chunked, K11
at nx <= 16) take no model.  With ``specialize=True``, K10, K1, K6, K5,
K2, K3 and K4 launch kernels generated for the model itself (K0:
``lanescalar``, ``codegen``; their plain versions are the lane sweeps of
``fused``, ``colvec`` and ``fk_lane``)."""
from ._lib import launches, reset_launches
from .fused import (
    fd_step_fused, fd_step_plain, feedback_rollout_fused,
    feedback_rollout_plain, feedback_rollout_fused_chunked,
    feedback_rollout_chunked_plain, feedback_fused_ok, feedback_chunks,
    feedback_lane_budget, rnea_fused, rnea_plain,
    fd_step_minv_fused, fd_step_minv_plain, rollout_fused,
    rollout_fused_multi, rollout_multi_plain,
)
from .colvec import linearize_parts_fused, linearize_parts_plain, linearize_fused
from .fk_lane import ee_gn_fused, ee_gn_plain
from .riccati import backward_pass_fused
from .riccati_chunk import backward_pass_chunked

__all__ = [
    "launches", "reset_launches",
    "fd_step_fused", "fd_step_plain",
    "feedback_rollout_fused", "feedback_rollout_plain",
    "feedback_rollout_fused_chunked", "feedback_rollout_chunked_plain",
    "feedback_fused_ok", "feedback_chunks", "feedback_lane_budget",
    "rnea_fused", "rnea_plain", "fd_step_minv_fused", "fd_step_minv_plain",
    "rollout_fused", "rollout_fused_multi", "rollout_multi_plain",
    "linearize_parts_fused", "linearize_parts_plain", "linearize_fused",
    "ee_gn_fused", "ee_gn_plain", "backward_pass_chunked",
    "backward_pass_fused",
]
