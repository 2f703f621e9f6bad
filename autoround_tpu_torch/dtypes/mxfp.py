"""Microscaling (OCP MX) fake-quant: MXFP4/6/8 and MXINT2/4/8 (counterpart
of ``autoround_tpu/dtypes/mxfp.py``).

Groups of 32 share one power-of-two (E8M0) scale; elements are narrow FP
(e2m1 / e2m3 / e3m2 / e4m3 / e5m2) or fixed-point INT.  The shared exponent
is ``floor(log2(amax)) - emax`` (STE floor, so minmax tuning reaches it),
or with ``rceil`` ``ceil(log2(amax / max_norm))``, or ``rceil_7_25`` with a
7.25 divisor.

Powers of two are built exactly from their exponent bits (``ste.pow2``),
as the MX spec's E8M0 scale is.  The JAX package takes them through XLA's
``exp2``, which on the CPU misses 2^e by up to 4.1e-6 relative for
e = -13, e <= -15 and e = 13, 15, 17, ... (and ``log2`` of such powers by
one ulp); both agree for |e| <= 12, where weights and activations of
normal size put their scales.

Clips of the tunable ``max_scale`` and of the element grid at
``±max_norm`` pass half the gradient on a bound (``intq._clip``), as
``jnp.clip`` does.  ``recip=True`` divides by the rceil divisor as XLA
does under ``jit`` (a product with its fp32 reciprocal; see
``fp8.div_const``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fp8 import div_const
from .grouping import from_groups, to_groups
from .intq import QdqResult, _clip
from .ste import ceil_ste, floor_ste, pow2, round_ste

__all__ = ["MX_FORMATS", "MxFormat", "quant_fp_elements", "qdq_mx",
           "rtn_mx", "opt_rtn_mx"]


class MxFormat(NamedTuple):
    ebits: int      # exponent bits of the element format (0 → fixed-point int)
    mbits: int      # mantissa (fraction) bits
    emax: int       # max unbiased exponent of the element format
    max_norm: float # largest representable magnitude


# Element formats per the OCP MX spec v1.0.
MX_FORMATS = {
    "mx_fp4": MxFormat(2, 1, 2, 6.0),
    "mx_fp6_e2m3": MxFormat(2, 3, 2, 7.5),
    "mx_fp6_e3m2": MxFormat(3, 2, 4, 28.0),
    "mx_fp8": MxFormat(4, 3, 8, 448.0),          # e4m3 default
    "mx_fp8_e4m3": MxFormat(4, 3, 8, 448.0),
    "mx_fp8_e5m2": MxFormat(5, 2, 15, 57344.0),
    # INT elements: two's complement, (bits-2) fraction bits → max (2^(b-1)-1)/2^(b-2)
    "mx_int2": MxFormat(0, 0, 0, 1.0 / 1.0),
    "mx_int4": MxFormat(0, 2, 0, 7.0 / 4.0),
    "mx_int8": MxFormat(0, 6, 0, 127.0 / 64.0),
}

_E8M0_MIN = -127.0
_E8M0_MAX = 127.0


def quant_fp_elements(x: torch.Tensor, fmt: MxFormat,
                      v: Optional[torch.Tensor] = None,
                      rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize (already scale-divided) values to the narrow element format.

    FP formats: per-element private exponent with subnormals, round to
    nearest even (STE) after adding the rounding offset ``v``.  INT
    formats: fixed point with ``mbits`` fraction bits.  ``rand`` (uniform
    [0, 1) per element) switches to stochastic rounding, ``floor(y + u)``.
    """
    vv = 0.0 if v is None else v

    def _round(y):
        if rand is not None:
            return floor_ste(y + rand)
        return round_ste(y + vv)

    if fmt.ebits == 0:
        step = 2.0 ** (-fmt.mbits)
        q = _round(x / step) * step
        return _clip(q, -fmt.max_norm, fmt.max_norm)
    if (fmt.ebits, fmt.mbits) == (2, 1):
        # E2M1: the grid {0, ±.5, ±1, ±1.5, ±2, ±3, ±4, ±6} is three
        # uniform regions, a branchless select
        ax = x.abs()
        lo = _round(2.0 * x) * 0.5            # |x| < 2, step .5
        mid = _round(x)                       # 2 <= |x| < 4, step 1
        hi = _round(0.5 * x) * 2.0            # |x| >= 4, step 2
        q = torch.where(ax < 2.0, lo, torch.where(ax < 4.0, mid, hi))
        return _clip(q, -fmt.max_norm, fmt.max_norm)
    emin = -(2 ** (fmt.ebits - 1) - 2)
    ax = x.detach().abs()
    private_exp = torch.floor(torch.log2(torch.clamp(ax, min=1e-30)))
    private_exp = torch.clamp(private_exp, min=float(emin))
    lsb = pow2(private_exp - fmt.mbits)
    q = _round(x / lsb) * lsb
    return _clip(q, -fmt.max_norm, fmt.max_norm)


def _shared_exp(amax, fmt, rounding, divisor, recip):
    if rounding == "floor":
        return floor_ste(torch.log2(amax)) - fmt.emax
    if rounding == "rceil":
        d = divisor if divisor is not None else fmt.max_norm
        return ceil_ste(torch.log2(div_const(amax, d, recip)))
    if rounding == "rceil_7_25":
        return ceil_ste(torch.log2(div_const(amax, 7.25, recip)))
    raise ValueError(f"unknown mx rounding {rounding!r}")


# Weights above this many elements are done a slice of groups at a time:
# the element-wise work after the group amax holds several fp32 copies of
# its input, 2 GB each over an lm_head of 525 M weights.  Groups are
# independent, so the bits (and, under autograd, the gradients) are the
# same.
_CHUNK_ELEMS = 1 << 24


def _qdq_mx_groups(wg, fmt, vg, max_scale, rounding, divisor, rand, recip):
    """qdq of grouped rows (n, g) in the compute dtype → (qdq, scales)."""
    amax = wg.abs().amax(dim=-1, keepdim=True)
    if max_scale is not None:
        amax = amax * _clip(max_scale.to(wg.dtype), 0.0, 1.0)
    amax = torch.clamp(amax, min=1e-30)
    shared_exp = _clip(_shared_exp(amax, fmt, rounding, divisor, recip),
                       _E8M0_MIN, _E8M0_MAX)
    scale = pow2(shared_exp)
    q = quant_fp_elements(wg / scale, fmt, vg, rand=rand)
    return q * scale, scale


def qdq_mx(
    w: torch.Tensor,
    data_type: str = "mx_fp4",
    group_size: int = 32,
    v: Optional[torch.Tensor] = None,
    max_scale: Optional[torch.Tensor] = None,
    rounding: str = "floor",
    divisor: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    rand: Optional[torch.Tensor] = None,
    recip: bool = False,
    **_,
) -> QdqResult:
    """Shared-exponent MX qdq.

    rounding: 'floor'      → shared_exp = floor(log2(amax)) - emax (spec)
              'rceil'      → shared_exp = ceil(log2(amax / max_norm))
              'rceil_7_25' → like rceil, dividing by 7.25 (FP4 only)
    ``max_scale`` (per group, tunable) multiplies the group amax before the
    exponent is taken.  ``generator`` (a ``torch.Generator``) or ``rand``
    (uniform [0, 1) numbers in the grouped layout ``(O * groups, g)``)
    switches the element rounding to stochastic rounding.
    """
    fmt = MX_FORMATS[data_type]
    O, I = w.shape
    cd = torch.promote_types(w.dtype, torch.float32)
    wg, pad = to_groups(w, group_size)
    vg = None
    if v is not None:
        vg, _ = to_groups(v.to(cd), group_size)
    ms = None if max_scale is None else max_scale.reshape(-1, 1)
    if rand is None and generator is not None:
        rand = torch.rand(wg.shape, generator=generator, dtype=cd,
                          device=w.device)
    n = wg.shape[0]
    step = max(1, _CHUNK_ELEMS // wg.shape[1])
    parts, scales = [], []
    for r in range(0, n, step):
        sl = slice(r, r + step)
        qdq, scale = _qdq_mx_groups(
            wg[sl].to(cd), fmt, None if vg is None else vg[sl],
            None if ms is None else ms[sl], rounding, divisor,
            None if rand is None else rand[sl], recip)
        parts.append(qdq.to(w.dtype))
        scales.append(scale)
    qdq = parts[0] if len(parts) == 1 else torch.cat(parts)
    scale = scales[0] if len(scales) == 1 else torch.cat(scales)
    return QdqResult(from_groups(qdq, (O, I), pad), scale.reshape(O, -1),
                     None)


def rtn_mx(w, data_type="mx_fp4", group_size=32, rounding="rceil", **kw):
    """Zero-shot MX RTN (the rceil variant by default)."""
    return qdq_mx(w, data_type=data_type, group_size=group_size,
                  rounding=rounding, **kw)


def opt_rtn_mx(w, data_type="mx_fp4", group_size=32,
               imatrix: Optional[torch.Tensor] = None, **_):
    """Exponent-offset search per group: the shared exponent floor(log2(
    amax)) - emax moved by -1, 0 or +1, the candidate with the least
    (imatrix-weighted) squared error kept (the first of equal ones)."""
    fmt = MX_FORMATS[data_type]
    O, I = w.shape
    wg, pad = to_groups(w.float(), group_size)
    if imatrix is None:
        weight = torch.ones_like(wg)
    else:
        im = imatrix.float().reshape(1, -1).expand(O, I)
        weight, _ = to_groups(im, group_size)

    amax = torch.clamp(wg.abs().amax(dim=-1, keepdim=True), min=1e-30)
    base_exp = torch.floor(torch.log2(amax)) - fmt.emax
    cands = torch.tensor([-1.0, 0.0, 1.0], device=w.device)

    def err_for(off):
        scale = pow2(torch.clamp(base_exp + off, _E8M0_MIN, _E8M0_MAX))
        q = quant_fp_elements(wg / scale, fmt) * scale
        return torch.sum(weight * (wg - q) ** 2, dim=-1)

    errs = torch.stack([err_for(c) for c in cands])
    best = cands[torch.argmin(errs, dim=0)][:, None]
    scale = pow2(torch.clamp(base_exp + best, _E8M0_MIN, _E8M0_MAX))
    qdq = quant_fp_elements(wg / scale, fmt) * scale
    qdq = from_groups(qdq, (O, I), pad).to(w.dtype)
    return QdqResult(qdq, scale.reshape(O, -1), None)
