"""Group reshape / padding helpers (counterpart of
``autoround_tpu/dtypes/grouping.py``).

Canonical quantization layout is ``(out_features, in_features)`` with
grouping along the **last** (input-channel) axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["resolve_group_size", "to_groups", "from_groups"]


def resolve_group_size(group_size: int, in_features: int) -> int:
    """-1 → per-channel (whole row), 0 → per-tensor is handled by caller."""
    if group_size == -1:
        return in_features
    if group_size == 0:
        raise ValueError("per-tensor grouping has no row group size")
    return min(group_size, in_features)


def to_groups(w: torch.Tensor, group_size: int) -> Tuple[torch.Tensor, int]:
    """Reshape (O, I) → (O * ceil(I/g), g), zero-padding the tail group.

    Returns (grouped, pad) where pad is the number of zero columns added.
    """
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weight, got {tuple(w.shape)}")
    O, I = w.shape
    g = resolve_group_size(group_size, I)
    pad = (-I) % g
    if pad:
        w = F.pad(w, (0, pad))
    return w.reshape(-1, g), pad


def from_groups(wg: torch.Tensor, orig_shape: Tuple[int, int],
                pad: int) -> torch.Tensor:
    """Inverse of :func:`to_groups`."""
    O, I = orig_shape
    w = wg.reshape(O, I + pad)
    if pad:
        w = w[:, :I]
    return w
