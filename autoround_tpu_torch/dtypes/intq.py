"""Integer fake-quant simulators, sym / asym, group-wise (counterpart of
``autoround_tpu/dtypes/intq.py``).

Given a weight ``w (O, I)``, optional rounding offsets ``v`` (same shape as
``w``) and per-group clip multipliers ``min_scale``/``max_scale``, produce
the quantize-dequantize (qdq) weight plus the scale/zero-point needed for
serving and export.  Arithmetic runs in float32 (or wider, if ``w`` is)
and the qdq is cast back to the weight dtype.  ``torch.round`` rounds half
to even, as ``jnp.round`` and ``np.rint`` do.

Gradients (STE through the rounds) equal the JAX package's, ties
included: a clip is ``minimum(maximum(x, lo), hi)``, which gives half the
gradient to an ``x`` that sits exactly on a bound (``min_scale`` and
``max_scale`` start on ``clip_hi``, and integer codes land on the ends of
the code range), where ``torch.clamp`` would give all of it.

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
           "rtn_int_asym", "search_init_scale_ratio", "opt_rtn_int_sym"]

_EPS = 1e-8


class QdqResult(NamedTuple):
    """qdq weight (original shape) + per-group scale/zp in row layout
    ``(O, n_groups_per_row)``; zp is None for dtypes without a zero point."""

    qdq: torch.Tensor
    scale: torch.Tensor
    zp: Optional[torch.Tensor]


def _compute_dtype(w: torch.Tensor) -> torch.dtype:
    return torch.promote_types(w.dtype, torch.float32)


class _Clip(torch.autograd.Function):
    """``jnp.clip(x, lo, hi)`` for ``lo < hi``: the values of
    ``torch.clamp``; the gradient passes inside the range, is halved for an
    ``x`` exactly on a bound (``minimum(maximum(x, lo), hi)`` splits a tie)
    and is zero outside.  One saved tensor, where the two-op form saves
    four."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        on_bound = torch.where((x == lo) | (x == hi), g * 0.5,
                               torch.zeros_like(g))
        return torch.where((x > lo) & (x < hi), g, on_bound), None, None


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return _Clip.apply(x, float(lo), float(hi))


def _clip_params(n_groups, min_scale, max_scale, clip_lo, clip_hi, dtype,
                 device):
    """Broadcast + clamp the tunable clip multipliers to per-group columns."""
    one = torch.ones((n_groups, 1), dtype=dtype, device=device)
    mn = one if min_scale is None else _clip(
        min_scale.reshape(-1, 1).to(dtype), clip_lo, clip_hi)
    mx = one if max_scale is None else _clip(
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
    q = _clip(q + maxq, 0, 2 ** bits - 1)
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

    scale = torch.maximum((wmax - wmin) / maxq,
                          torch.tensor(_EPS, dtype=cd, device=w.device))
    zp = round_ste(-wmin / scale)
    q = round_ste(wg / scale + vg)
    q = _clip(q + zp, 0, maxq)
    qdq = (q - zp) * scale

    qdq = from_groups(qdq, (O, I), pad).to(w.dtype)
    return QdqResult(qdq, scale.reshape(O, -1), zp.reshape(O, -1))


def rtn_int_sym(w, bits, group_size, **_):
    """Zero-shot round-to-nearest (no tuned params)."""
    return qdq_int_sym(w, bits, group_size)


def rtn_int_asym(w, bits, group_size, **_):
    return qdq_int_asym(w, bits, group_size)


def _base_scale_sym(wg: torch.Tensor, bits: int) -> torch.Tensor:
    """Full-range sym scale of each group at clip multipliers 1."""
    wmin, wmax = _extremes(wg)
    extreme = torch.where(-wmin > wmax, wmin, wmax)
    scale = -extreme / 2 ** (bits - 1)
    return torch.where(scale.abs() < _EPS, torch.full_like(scale, _EPS),
                       scale)


def _search_ratio(wg, base_scale, bits, imatrix, shape, group_size,
                  num_steps, step):
    """Per-group shrink ratio of ``base_scale`` with the least (imatrix-
    weighted) squared qdq error; the first of equal candidates wins."""
    O, I = shape
    if num_steps is None:
        num_steps = 90 if bits <= 2 else 30
    maxq = 2 ** (bits - 1)
    if imatrix is None:
        weight = torch.ones_like(wg)
    else:
        im = imatrix.to(wg.dtype).reshape(1, -1).expand(O, I)
        weight, _ = to_groups(im, group_size)
    ratios = 1.0 - step * torch.arange(num_steps, dtype=wg.dtype,
                                       device=wg.device)
    errs = []
    for ratio in ratios:               # one candidate at a time: the whole
        s = base_scale * ratio         # grid at once is num_steps x |w|
        q = torch.clamp(torch.round(wg / s) + maxq, 0, 2 ** bits - 1)
        dq = (q - maxq) * s
        errs.append(torch.sum(weight * (wg - dq) ** 2, dim=-1))
    return ratios[torch.argmin(torch.stack(errs), dim=0)]


def search_init_scale_ratio(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    num_steps: Optional[int] = None,
    step: float = 0.01,
    imatrix: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-group best scale-shrink ratio (O, groups_per_row): the searched
    init of ``max_scale`` under ``enable_alg_ext``."""
    O, I = w.shape
    wg, _ = to_groups(w.to(_compute_dtype(w)), group_size)
    best = _search_ratio(wg, _base_scale_sym(wg, bits), bits, imatrix,
                         (O, I), group_size, num_steps, step)
    return best.reshape(O, -1)


def opt_rtn_int_sym(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    imatrix: Optional[torch.Tensor] = None,
    num_steps: Optional[int] = None,
    step: float = 0.01,
    **_,
) -> QdqResult:
    """Optimized RTN: grid search over scale shrink ratios, weighted by an
    importance matrix (mean of squared input activations per in-channel;
    W2 uses 90 x 0.01 shrink steps, wider codes 30)."""
    O, I = w.shape
    wg, pad = to_groups(w.to(_compute_dtype(w)), group_size)
    maxq = 2 ** (bits - 1)
    base_scale = _base_scale_sym(wg, bits)
    best = _search_ratio(wg, base_scale, bits, imatrix, (O, I), group_size,
                         num_steps, step)
    scale = base_scale * best[:, None]
    q = torch.clamp(torch.round(wg / scale) + maxq, 0, 2 ** bits - 1)
    qdq = from_groups((q - maxq) * scale, (O, I), pad).to(w.dtype)
    return QdqResult(qdq, scale.reshape(O, -1), None)
