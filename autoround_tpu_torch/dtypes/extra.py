"""Long-tail dtypes (counterpart of ``autoround_tpu/dtypes/extra.py``):
W4FP8 progressive quantization and the float-zero-point int type.

``w4fp8``: the weight is first snapped to the per-channel FP8-E4M3 grid,
then int4-group-quantized on that grid, so the int4 codes dequantize into
FP8-representable values.  ``int_asym_float_zp`` (q4_1 / q5_1 style): dq =
q * d + m with a float min m, no rounded zero point; the zp slot carries
-m / d.  The registry entries live in ``dtypes.registry``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fp8 import div_const, qdq_fp8_sym
from .grouping import from_groups, to_groups
from .intq import QdqResult, _clip, qdq_int_sym
from .ste import round_ste

__all__ = ["qdq_w4fp8", "qdq_int_asym_float_zp"]

_EPS = 1e-8


def qdq_w4fp8(w: torch.Tensor, bits: int = 4, group_size: int = 128,
              v: Optional[torch.Tensor] = None,
              min_scale: Optional[torch.Tensor] = None,
              max_scale: Optional[torch.Tensor] = None,
              recip: bool = False, **kw) -> QdqResult:
    """Progressive FP8 → INT4: per-channel E4M3 first, then the int sym
    group qdq of that (the clip range from ``clip_lo`` / ``clip_hi``)."""
    fp8_stage = qdq_fp8_sym(w, group_size=-1, recip=recip)
    r = qdq_int_sym(fp8_stage.qdq, bits, group_size, v=v,
                    min_scale=min_scale, max_scale=max_scale,
                    clip_lo=kw.get("clip_lo", 0.0),
                    clip_hi=kw.get("clip_hi", 1.0))
    return QdqResult(r.qdq, r.scale, r.zp)


def qdq_int_asym_float_zp(w: torch.Tensor, bits: int, group_size: int,
                          v: Optional[torch.Tensor] = None,
                          min_scale: Optional[torch.Tensor] = None,
                          max_scale: Optional[torch.Tensor] = None,
                          clip_lo: float = 0.0, clip_hi: float = 1.0,
                          recip: bool = False, **_) -> QdqResult:
    """Asym with a float min: d = (wmax - wmin) / (2^b - 1), m = wmin,
    dq = clip(round((w - m) / d + v), 0, 2^b - 1) * d + m."""
    O, I = w.shape
    f32 = torch.float32
    wg, pad = to_groups(w.to(f32), group_size)
    vg = 0.0
    if v is not None:
        vg, _ = to_groups(v.to(f32), group_size)

    maxq = 2.0 ** bits - 1
    zero = torch.zeros((), dtype=f32, device=w.device)
    wmin = torch.minimum(wg.amin(dim=-1, keepdim=True), zero)
    wmax = torch.maximum(wg.amax(dim=-1, keepdim=True), zero)
    if min_scale is not None:
        wmin = wmin * _clip(min_scale.reshape(-1, 1).to(f32), clip_lo,
                            clip_hi)
    if max_scale is not None:
        wmax = wmax * _clip(max_scale.reshape(-1, 1).to(f32), clip_lo,
                            clip_hi)
    d = torch.maximum(div_const(wmax - wmin, maxq, recip),
                      torch.tensor(_EPS, dtype=f32, device=w.device))
    m = wmin
    q = _clip(round_ste((wg - m) / d + vg), 0, maxq)
    qdq = from_groups((q * d + m).to(w.dtype), (O, I), pad)
    return QdqResult(qdq, d.reshape(O, -1), (-m / d).reshape(O, -1))
