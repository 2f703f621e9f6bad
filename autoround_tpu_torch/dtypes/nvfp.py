"""NVFP4 fake-quant: FP4-E2M1 elements, FP8-E4M3 group scales (g = 16),
an fp32 global scale (counterpart of ``autoround_tpu/dtypes/nvfp.py``);
and ``fp4_v2``: E2M1 elements with unsigned E5M3 (UE5M3) group scales.

The tensor-level global scale places the per-group amax / 6 values inside
the E4M3 range; each group of 16 then carries an E4M3 scale; elements are
E2M1 (max 6.0).  ``recip=True`` divides by 6 as XLA does under ``jit`` (a
product with fp32(1 / 6); see ``fp8.div_const``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .fp8 import div_const
from .grouping import from_groups, to_groups
from .intq import QdqResult, _clip
from .mxfp import MX_FORMATS, quant_fp_elements
from .ste import cast_ste, pow2

__all__ = ["nvfp4_global_scale", "qdq_nvfp4", "rtn_nvfp4", "cast_ue5m3",
           "qdq_fp4_v2", "ue5m3_global_scale"]

_FP4 = MX_FORMATS["mx_fp4"]
_E4M3_MAX = 448.0
_UE5M3_MAX = 114688.0  # (1 + 6/8) * 2^16


def nvfp4_global_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor fp32 global scale: maps the largest group scale
    (tensor amax / 6) onto the top of the E4M3 range."""
    amax = torch.clamp(w.abs().amax().float(), min=1e-30)
    # a tensor numerator: ``scalar / tensor`` is a reciprocal product in
    # PyTorch, the JAX package divides
    return torch.full_like(amax, _E4M3_MAX * _FP4.max_norm) / amax


def qdq_nvfp4(
    w: torch.Tensor,
    group_size: int = 16,
    v: Optional[torch.Tensor] = None,
    max_scale: Optional[torch.Tensor] = None,
    global_scale: Optional[torch.Tensor] = None,
    recip: bool = False,
    **_,
) -> QdqResult:
    """NVFP4 qdq.  ``global_scale`` may be precomputed (static activation
    quantization); otherwise it is derived from this tensor."""
    O, I = w.shape
    wg, pad = to_groups(w.float(), group_size)
    vg = None
    if v is not None:
        vg, _ = to_groups(v.float(), group_size)
    if global_scale is None:
        global_scale = nvfp4_global_scale(w)

    amax = wg.abs().amax(dim=-1, keepdim=True)
    if max_scale is not None:
        amax = amax * _clip(max_scale.reshape(-1, 1).float(), 0.0, 1.0)
    # group decode scale, stored as E4M3: s = e4m3(amax / 6 * gs) / gs;
    # under jit XLA multiplies the (scalar) global scale by fp32(1 / 6)
    # first, and the recip form does the same
    if recip:
        pre = amax * (global_scale * (1.0 / _FP4.max_norm))
    else:
        pre = div_const(amax, _FP4.max_norm) * global_scale
    s_enc = cast_ste(pre, torch.float8_e4m3fn)
    s = torch.clamp(s_enc, min=1e-30) / global_scale

    q = quant_fp_elements(wg / s, _FP4, vg)
    qdq = from_groups(q * s, (O, I), pad).to(w.dtype)
    return QdqResult(qdq, s.reshape(O, -1), None)


def rtn_nvfp4(w, group_size=16, **kw):
    return qdq_nvfp4(w, group_size=group_size, **kw)


# ---- fp4_v2: E2M1 elements with UNSIGNED E5M3 group scales --------------
# UE5M3 is an unsigned 8-bit float: 5 exponent bits (bias 15, min normal
# 2^-14), 3 mantissa bits, max (1 + 6/8) * 2^16 = 114688.


def cast_ue5m3(x: torch.Tensor) -> torch.Tensor:
    """Round positive values onto the UE5M3 grid (frexp, and the power of
    two from its exponent bits: exact on every device)."""
    xf = torch.clamp(x.float(), min=0.0)
    m, e = torch.frexp(xf)  # x = m * 2^e, m in [0.5, 1)
    m3 = torch.clamp(torch.round((m - 0.5) * 16.0), 0.0, 7.0)
    normal = (1.0 + m3 / 8.0) * pow2(torch.clamp(e - 1, -126, 127))
    msub = torch.clamp(torch.round(xf * (8.0 * 2.0 ** 14)), 1.0, 7.0)
    subnormal = (msub / 8.0) * 2.0 ** -14
    zero = torch.zeros_like(xf)
    out = torch.where(xf >= 2.0 ** -14, normal,
                      torch.where(xf > 0.0, subnormal, zero))
    return out.to(x.dtype)


def cast_ue5m3_ste(x: torch.Tensor) -> torch.Tensor:
    return x + (cast_ue5m3(x) - x).detach()


def ue5m3_global_scale(w: torch.Tensor) -> torch.Tensor:
    """fp4_v2 with a global scale: amax / 6 at the top of UE5M3, by a
    product with the reciprocal (the JAX package's form)."""
    amax = w.abs().amax().float()
    return _UE5M3_MAX * _FP4.max_norm * (1.0 / torch.clamp(amax, min=1e-30))


def qdq_fp4_v2(
    w: torch.Tensor,
    group_size: int = 32,
    v: Optional[torch.Tensor] = None,
    max_scale: Optional[torch.Tensor] = None,
    global_scale: Optional[torch.Tensor] = None,
    use_global_scale: bool = False,
    **_,
) -> QdqResult:
    """fp4_v2 qdq: per-group amax / 6 scales cast to UE5M3 (optionally
    placed by a tensor-level global scale), E2M1 elements."""
    if group_size not in (16, 32):
        raise ValueError(f"fp4_v2 takes group_size 16 or 32, got "
                         f"{group_size}")
    O, I = w.shape
    wg, pad = to_groups(w.float(), group_size)
    vg = None
    if v is not None:
        vg, _ = to_groups(v.float(), group_size)
    if global_scale is None:
        global_scale = (ue5m3_global_scale(w) if use_global_scale
                        else torch.ones((), device=w.device))

    amax = wg.abs().amax(dim=-1, keepdim=True)
    if max_scale is not None:
        amax = amax * _clip(max_scale.reshape(-1, 1).float(), 0.0, 1.0)
    s_enc = cast_ue5m3_ste(_clip(global_scale * (amax * (1.0 / _FP4.max_norm)),
                                 0.0, _UE5M3_MAX))
    s = torch.clamp(s_enc, min=1e-30) * (1.0 / global_scale)

    q = quant_fp_elements(wg / s, _FP4, vg)
    qdq = from_groups(q * s, (O, I), pad).to(w.dtype)
    return QdqResult(qdq, s.reshape(O, -1), None)
