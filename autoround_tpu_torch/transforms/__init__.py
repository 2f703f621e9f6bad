"""Preprocessing transforms (counterpart of ``autoround_tpu/transforms``):
Hadamard rotations (QuaRot R1 fused, R4 online), SpinQuant's trained
rotations, AWQ smoothing."""

from .awq import awq_clip_search, awq_smooth_block
from .hadamard import (apply_r1_rotation, apply_r4_rotation,
                       fuse_rms_gains, hadamard_matrix)

__all__ = ["apply_r1_rotation", "apply_r4_rotation", "fuse_rms_gains",
           "hadamard_matrix", "awq_smooth_block", "awq_clip_search"]
