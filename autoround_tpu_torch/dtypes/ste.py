"""Straight-through estimators (counterpart of ``autoround_tpu/dtypes/ste.py``).

``x + (f(x) - x).detach()``: the forward value is ``f(x)``, the gradient
is the identity.  ``torch.round`` rounds half to even, as ``jnp.round``.
"""

from __future__ import annotations

import torch

__all__ = ["round_ste", "floor_ste", "ceil_ste", "clip_ste", "cast_ste",
           "pow2"]


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """round-to-nearest-even with identity gradient."""
    return x + (torch.round(x) - x).detach()


def floor_ste(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.floor(x) - x).detach()


def ceil_ste(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.ceil(x) - x).detach()


def clip_ste(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """clamp with identity gradient everywhere (unlike a plain clip, whose
    gradient is zero outside the range)."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def cast_ste(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round-trip through a narrow float dtype (``torch.float8_e4m3fn`` /
    ``torch.float8_e5m2``: round to nearest even, as the JAX package's
    ``astype``), identity gradient.  Callers pre-clip to the format's max,
    so nothing saturates."""
    return x + (x.to(dtype).to(x.dtype) - x).detach()


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as fp32, exactly, for integral ``e`` in [-149, 127] (fp32
    subnormals below -126), built from the exponent bits so that no
    device's ``exp2`` rounding enters.  The gradient is that of
    ``torch.exp2`` (the value is replaced, the graph kept)."""
    ei = e.detach().to(torch.int32)
    bits = torch.where(ei >= -126, (ei + 127) << 23,
                       torch.ones_like(ei) << (ei + 149).clamp_min(0))
    exact = bits.view(torch.float32)
    if not e.requires_grad:
        return exact
    t = torch.exp2(e.float())
    return t + (exact - t).detach()
