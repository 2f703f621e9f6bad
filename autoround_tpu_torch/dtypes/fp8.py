"""FP8 fake-quant: per-tensor / per-channel / 2-D block-wise E4M3 (+E5M2)
(counterpart of ``autoround_tpu/dtypes/fp8.py``).

The qdq round-trips through ``torch.float8_e4m3fn`` / ``torch.float8_e5m2``
(round to nearest even, the JAX package's cast bit for bit); values are
pre-clipped to the format's max so the cast never saturates.

Division by the format max: the JAX package divides where it runs eagerly
(RTN, the final qdq of a tuned layer) and, under ``jit`` (the tuning loss,
the activation quantizer), XLA compiles ``amax / 448`` to a product with
fp32(1 / 448).  ``recip=True`` selects the second form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .intq import QdqResult, _clip
from .ste import cast_ste, clip_ste

__all__ = ["qdq_fp8_sym", "qdq_fp8_block", "FP8_MAX", "MIN_SCALE",
           "div_const"]

FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
_FP8_DTYPE = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
# vLLM-compatible minimum scale
MIN_SCALE = 1.0 / (448.0 * 512.0)


def div_const(x: torch.Tensor, c: float, recip: bool = False) -> torch.Tensor:
    """``x / c`` as the JAX package computes it: a true fp32 division
    (eager JAX), or with ``recip`` a product with fp32(1 / c) (XLA under
    ``jit``).  The divisor rides as a tensor on x's device: PyTorch's CUDA
    division by a host scalar is itself a reciprocal product."""
    if recip:
        return x * (1.0 / c)
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def qdq_fp8_sym(
    w: torch.Tensor,
    group_size: int = -1,
    fp8_format: str = "e4m3",
    max_scale: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    recip: bool = False,
    **_,
) -> QdqResult:
    """Symmetric FP8 qdq.  group_size -1 → per output channel, 0 → per
    tensor.  ``scale`` may be supplied (static activation quantization)."""
    fmax = FP8_MAX[fp8_format]
    cd = torch.promote_types(w.dtype, torch.float32)
    wf = w.to(cd)
    if scale is None:
        if group_size == 0:
            amax = wf.abs().amax()
        else:
            amax = wf.abs().amax(dim=-1, keepdim=True)
        if max_scale is not None:
            amax = amax * _clip(torch.as_tensor(max_scale, dtype=cd,
                                                device=w.device), 0.0, 1.0)
        scale = torch.clamp(div_const(amax, fmax, recip), min=MIN_SCALE)
    q = cast_ste(clip_ste(wf / scale, -fmax, fmax), _FP8_DTYPE[fp8_format])
    qdq = (q * scale).to(w.dtype)
    scale_out = torch.atleast_1d(torch.as_tensor(scale))
    if scale_out.ndim > 1:
        scale_out = scale_out.reshape(w.shape[0], -1)
    return QdqResult(qdq, scale_out, None)


def qdq_fp8_block(
    w: torch.Tensor,
    block: Tuple[int, int] = (128, 128),
    fp8_format: str = "e4m3",
    recip: bool = False,
    **_,
) -> QdqResult:
    """2-D block-wise FP8 ((128, 128) tiles): pads both dims to a multiple
    of the block, one scale per tile."""
    fmax = FP8_MAX[fp8_format]
    O, I = w.shape
    br, bc = block
    cd = torch.promote_types(w.dtype, torch.float32)
    pr, pc = (-O) % br, (-I) % bc
    wf = F.pad(w.to(cd), (0, pc, 0, pr))
    nR, nC = wf.shape[0] // br, wf.shape[1] // bc
    tiles = wf.reshape(nR, br, nC, bc).permute(0, 2, 1, 3)  # (nR, nC, br, bc)
    amax = tiles.abs().amax(dim=(-1, -2), keepdim=True)
    scale = torch.clamp(div_const(amax, fmax, recip), min=MIN_SCALE)
    q = cast_ste(clip_ste(tiles / scale, -fmax, fmax),
                 _FP8_DTYPE[fp8_format])
    dq = (q * scale).permute(0, 2, 1, 3).reshape(wf.shape)
    qdq = dq[:O, :I].to(w.dtype)
    return QdqResult(qdq, scale.reshape(nR, nC), None)
