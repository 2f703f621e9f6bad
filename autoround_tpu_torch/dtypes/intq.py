"""Integer fake-quant simulators, sym / asym, group-wise (counterpart of
``autoround_tpu/dtypes/intq.py``).

Given a weight ``w (O, I)``, optional rounding offsets ``v`` (same shape as
``w``) and per-group clip multipliers ``min_scale``/``max_scale``, produce
the quantize-dequantize (qdq) weight plus the scale/zero-point needed for
serving and export.  Arithmetic runs in float32 (or wider, if ``w`` is)
and the qdq is cast back to the weight dtype.  ``torch.round`` rounds half
to even, as ``jnp.round`` and ``np.rint`` do.

Symmetric quantization uses the *full-range* trick: the signed extreme of
each group is mapped onto the wider endpoint ``-2^(b-1)`` of the signed
range, flipping the scale sign when the positive side dominates, so no
integer code is wasted.  Scales may therefore be negative.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .grouping import from_groups, to_groups
from .ste import round_ste

__all__ = ["QdqResult", "qdq_int_sym", "qdq_int_asym", "rtn_int_sym",
           "rtn_int_asym"]

_EPS = 1e-8


class QdqResult(NamedTuple):
    """qdq weight (original shape) + per-group scale/zp in row layout
    ``(O, n_groups_per_row)``; zp is None for dtypes without a zero point."""

    qdq: torch.Tensor
    scale: torch.Tensor
    zp: Optional[torch.Tensor]


def _compute_dtype(w: torch.Tensor) -> torch.dtype:
    return torch.promote_types(w.dtype, torch.float32)


def _clip_params(n_groups, min_scale, max_scale, clip_lo, clip_hi, dtype,
                 device):
    """Broadcast + clamp the tunable clip multipliers to per-group columns."""
    one = torch.ones((n_groups, 1), dtype=dtype, device=device)
    mn = one if min_scale is None else torch.clamp(
        min_scale.reshape(-1, 1).to(dtype), clip_lo, clip_hi)
    mx = one if max_scale is None else torch.clamp(
        max_scale.reshape(-1, 1).to(dtype), clip_lo, clip_hi)
    return mn, mx


def _group_v(v, group_size, dtype):
    if v is None:
        return 0.0
    vg, _ = to_groups(v.to(dtype), group_size)
    return vg


def _extremes(wg):
    zero = torch.zeros((), dtype=wg.dtype, device=wg.device)
    wmin = torch.minimum(wg.amin(dim=-1, keepdim=True), zero)
    wmax = torch.maximum(wg.amax(dim=-1, keepdim=True), zero)
    return wmin, wmax


def qdq_int_sym(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    v: Optional[torch.Tensor] = None,
    min_scale: Optional[torch.Tensor] = None,
    max_scale: Optional[torch.Tensor] = None,
    clip_lo: float = 0.0,
    clip_hi: float = 1.0,
) -> QdqResult:
    """Full-range symmetric int qdq.

    q = clamp(round(w/s + v) + 2^(b-1), 0, 2^b - 1);  dq = (q - 2^(b-1)) * s
    where s carries the sign of the dominant group extreme.
    """
    O, I = w.shape
    cd = _compute_dtype(w)
    wg, pad = to_groups(w.to(cd), group_size)
    vg = _group_v(v, group_size, cd)

    maxq = 2 ** (bits - 1)
    wmin, wmax = _extremes(wg)
    mn, mx = _clip_params(wg.shape[0], min_scale, max_scale, clip_lo,
                          clip_hi, cd, w.device)
    wmin = wmin * mn
    wmax = wmax * mx
    # signed dominant extreme → scale sign flip: the extreme always lands
    # on the wider endpoint -2^(b-1)
    extreme = torch.where(-wmin > wmax, wmin, wmax)
    scale = -extreme / maxq  # > 0 iff the negative side dominates
    scale = torch.where(scale.abs() < _EPS,
                        torch.full_like(scale, _EPS), scale)

    q = round_ste(wg / scale + vg)
    q = torch.clamp(q + maxq, 0, 2 ** bits - 1)
    qdq = (q - maxq) * scale

    qdq = from_groups(qdq, (O, I), pad).to(w.dtype)
    return QdqResult(qdq, scale.reshape(O, -1), None)


def qdq_int_asym(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    v: Optional[torch.Tensor] = None,
    min_scale: Optional[torch.Tensor] = None,
    max_scale: Optional[torch.Tensor] = None,
    clip_lo: float = 0.0,
    clip_hi: float = 1.0,
) -> QdqResult:
    """Asymmetric int qdq with rounded zero point:
    s = (wmax-wmin)/(2^b-1), zp = round(-wmin/s)."""
    O, I = w.shape
    cd = _compute_dtype(w)
    wg, pad = to_groups(w.to(cd), group_size)
    vg = _group_v(v, group_size, cd)

    maxq = 2 ** bits - 1
    wmin, wmax = _extremes(wg)
    mn, mx = _clip_params(wg.shape[0], min_scale, max_scale, clip_lo,
                          clip_hi, cd, w.device)
    wmin = wmin * mn
    wmax = wmax * mx

    scale = torch.clamp((wmax - wmin) / maxq, min=_EPS)
    zp = round_ste(-wmin / scale)
    q = round_ste(wg / scale + vg)
    q = torch.clamp(q + zp, 0, maxq)
    qdq = (q - zp) * scale

    qdq = from_groups(qdq, (O, I), pad).to(w.dtype)
    return QdqResult(qdq, scale.reshape(O, -1), zp.reshape(O, -1))


def rtn_int_sym(w, bits, group_size, **_):
    """Zero-shot round-to-nearest (no tuned params)."""
    return qdq_int_sym(w, bits, group_size)


def rtn_int_asym(w, bits, group_size, **_):
    return qdq_int_asym(w, bits, group_size)
