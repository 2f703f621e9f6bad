"""Straight-through estimators (counterpart of ``autoround_tpu/dtypes/ste.py``).

``x + (f(x) - x).detach()``: the forward value is ``f(x)``, the gradient
is the identity.  ``torch.round`` rounds half to even, as ``jnp.round``.
"""

from __future__ import annotations

import torch

__all__ = ["round_ste"]


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """round-to-nearest-even with identity gradient."""
    return x + (torch.round(x) - x).detach()
