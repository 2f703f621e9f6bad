"""GGUF k-quant (double-quant / super-block) fake-quant simulators
(counterpart of ``autoround_tpu/dtypes/gguf.py``).

A super-block of ``group_size * super_group_size`` elements of a row
shares two fp scales; each sub-group's scale (and min, for asym) is itself
quantized to ``super_bits`` codes against them:

  asym (Q2_K/Q4_K/Q5_K):  w ≈ d̂_g * q - m̂_g,  q ∈ [0, 2^bits)
      d̂_g = q_d[g] * d_super,   m̂_g = q_m[g] * m_super
  sym  (Q3_K/Q6_K):       w ≈ d̂_g * q,        q ∈ [-2^(b-1), 2^(b-1))
      d̂_g = q_d[g] * d_super with signed super_bits codes

The tunable forms take the rounding offset ``v`` (STE) and the min/max
clip multipliers; ``frozen_d`` / ``frozen_m`` (a grid from
:func:`search_dq_grid`) replace the min/max derivation.  The RTN forms
search a shrink ratio of the scale per sub-group, imatrix-weighted when
one is given.

The JAX package vmaps that search over the ratios, which XLA fuses; here
the ratios run one at a time with a running best (a strict ``<``, so the
first least error wins, as ``argmin``), and the RTN forms walk the rows in
chunks of at most ``CHUNK_ELEMS`` elements (every quantity is row-local:
a super-block never crosses a row), so a 128256 x 4096 embedding's search
never holds more than a few chunk-sized fp32 temporaries.  The searches'
sums add left to right, as XLA's CPU reduction does.  ``recip=True``
divides by the format's constants as the JAX package's jitted tuning loss
does (``fp8.div_const``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fp8 import div_const
from .intq import QdqResult, _clip
from .ste import round_ste

__all__ = ["qdq_int_dq_sym", "qdq_int_dq_asym", "rtn_int_dq_sym",
           "rtn_int_dq_asym", "search_dq_grid", "DqResult", "CHUNK_ELEMS"]

_EPS = 1e-8
# the RTN forms' row chunk, in elements of the weight
CHUNK_ELEMS = 1 << 24


class DqResult(NamedTuple):
    """Extended payload for GGUF export: quantized sub-scales and supers."""

    qdq: torch.Tensor
    d_super: torch.Tensor       # (n_super, 1) fp
    m_super: Optional[torch.Tensor]
    q_d: torch.Tensor           # (n_super, super_group_size) codes
    q_m: Optional[torch.Tensor]


def _to_super_groups(w, group_size, super_group_size):
    """(O, I) → (n_super, sgs, g).  Requires I % (g * sgs) == 0 (GGUF's
    256-divisibility rule; the layer-config cascade falls back for other
    shapes)."""
    O, I = w.shape
    block = group_size * super_group_size
    if I % block:
        raise ValueError(f"in_features {I} not divisible by super-block "
                         f"{block}")
    return w.reshape(-1, super_group_size, group_size)


def _eps(x):
    return torch.tensor(_EPS, dtype=x.dtype, device=x.device)


def _extremes(wg):
    zero = torch.zeros((), dtype=wg.dtype, device=wg.device)
    return (torch.minimum(wg.amin(dim=-1, keepdim=True), zero),
            torch.maximum(wg.amax(dim=-1, keepdim=True), zero))


def _where_eps(d):
    """``|d| < eps → +eps`` (the sign of a sym scale is kept otherwise)."""
    return torch.where(d.abs() < _EPS, _eps(d), d)


def qdq_int_dq_sym(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    super_bits: int = 6,
    super_group_size: int = 16,
    v: Optional[torch.Tensor] = None,
    min_scale: Optional[torch.Tensor] = None,
    max_scale: Optional[torch.Tensor] = None,
    clip_lo: float = 0.5,
    clip_hi: float = 1.5,
    frozen_d: Optional[torch.Tensor] = None,
    recip: bool = False,
    **_,
) -> QdqResult:
    """Symmetric double-quant (Q3_K/Q6_K family), full-range sub-scales
    (the signed extreme lands on ``-2^(b-1)``).  ``frozen_d``: a searched
    per-sub-group scale grid replaces the min/max derivation; ``max_scale``
    then multiplies it."""
    O, I = w.shape
    f32 = torch.float32
    wg = _to_super_groups(w.to(f32), group_size, super_group_size)
    vg = 0.0
    if v is not None:
        vg = _to_super_groups(v.to(f32), group_size, super_group_size)

    maxq = 2.0 ** (bits - 1)
    if frozen_d is not None:
        d = frozen_d.to(f32).reshape(wg.shape[0], wg.shape[1], 1)
        if max_scale is not None:
            d = d * _clip(max_scale.reshape(d.shape).to(f32), clip_lo,
                          clip_hi)
    else:
        wmin, wmax = _extremes(wg)
        if max_scale is not None:
            ms = _clip(max_scale.reshape(wmax.shape).to(f32), clip_lo,
                       clip_hi)
            wmax = wmax * ms
            wmin = wmin * ms
        extreme = torch.where(-wmin > wmax, wmin, wmax)
        d = div_const(-extreme, maxq, recip)                 # (ns, sgs, 1)

    # the sub-scales as signed super_bits codes against d_super
    smaxq = 2.0 ** (super_bits - 1) - 1
    d_super = torch.maximum(
        div_const(d.abs().amax(dim=1, keepdim=True), smaxq, recip), _eps(d))
    q_d = _clip(round_ste(d / d_super), -smaxq - 1, smaxq)
    d_hat = _where_eps(q_d * d_super)

    q = _clip(round_ste(wg / d_hat + vg), -maxq, maxq - 1)
    qdq = (q * d_hat).reshape(O, I).to(w.dtype)
    extras = {"d_super": d_super[:, 0, 0], "d_hat": d_hat[..., 0],
              "sym": True, "super_bits": super_bits,
              "super_group_size": super_group_size,
              "group_size": group_size}
    return QdqResult(qdq, d_hat.reshape(O, -1), None, extras)


def qdq_int_dq_asym(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    super_bits: int = 6,
    super_group_size: int = 8,
    v: Optional[torch.Tensor] = None,
    min_scale: Optional[torch.Tensor] = None,
    max_scale: Optional[torch.Tensor] = None,
    clip_lo: float = 0.5,
    clip_hi: float = 1.5,
    frozen_d: Optional[torch.Tensor] = None,
    frozen_m: Optional[torch.Tensor] = None,
    recip: bool = False,
    **_,
) -> QdqResult:
    """Asymmetric double-quant (Q2_K/Q4_K/Q5_K family): w ≈ d̂ q - m̂, with
    the fractional zero point m̂ / d̂.  ``frozen_d`` / ``frozen_m``: a
    searched (scale, min) grid replaces the min/max derivation;
    ``max_scale`` / ``min_scale`` then multiply it."""
    O, I = w.shape
    f32 = torch.float32
    wg = _to_super_groups(w.to(f32), group_size, super_group_size)
    vg = 0.0
    if v is not None:
        vg = _to_super_groups(v.to(f32), group_size, super_group_size)

    maxq = 2.0 ** bits - 1
    if frozen_d is not None:
        d = frozen_d.to(f32).reshape(wg.shape[0], wg.shape[1], 1)
        m = frozen_m.to(f32).reshape(wg.shape[0], wg.shape[1], 1)
        if max_scale is not None:
            d = d * _clip(max_scale.reshape(d.shape).to(f32), clip_lo,
                          clip_hi)
        if min_scale is not None:
            m = m * _clip(min_scale.reshape(m.shape).to(f32), clip_lo,
                          clip_hi)
        d = torch.maximum(d, _eps(d))
    else:
        wmin, wmax = _extremes(wg)
        if min_scale is not None:
            wmin = wmin * _clip(min_scale.reshape(wmin.shape).to(f32),
                                clip_lo, clip_hi)
        if max_scale is not None:
            wmax = wmax * _clip(max_scale.reshape(wmax.shape).to(f32),
                                clip_lo, clip_hi)
        d = torch.maximum(div_const(wmax - wmin, maxq, recip), _eps(wg))
        m = -wmin                                            # ≥ 0

    smaxq = 2.0 ** super_bits - 1
    d_super = torch.maximum(
        div_const(d.amax(dim=1, keepdim=True), smaxq, recip), _eps(d))
    m_super = torch.maximum(
        div_const(m.amax(dim=1, keepdim=True), smaxq, recip), _eps(m))
    q_d = _clip(round_ste(d / d_super), 0, smaxq)
    q_m = _clip(round_ste(m / m_super), 0, smaxq)
    d_hat = torch.maximum(q_d * d_super, _eps(d))
    m_hat = q_m * m_super

    q = _clip(round_ste((wg + m_hat) / d_hat + vg), 0, maxq)
    qdq = (q * d_hat - m_hat).reshape(O, I).to(w.dtype)
    extras = {"d_super": d_super[:, 0, 0], "m_super": m_super[:, 0, 0],
              "d_hat": d_hat[..., 0], "m_hat": m_hat[..., 0],
              "sym": False, "super_bits": super_bits,
              "super_group_size": super_group_size,
              "group_size": group_size}
    # the zero point's equivalent: m̂ / d̂ (a float zero point)
    return QdqResult(qdq, d_hat.reshape(O, -1),
                     (m_hat / d_hat).reshape(O, -1), extras)


# --- the weighted searches -------------------------------------------------

def _weight_groups(imatrix, I, group_size, super_group_size, f32, device):
    """The imatrix as (1, I / block, sgs, g), broadcast over the rows (no
    (O, I) copy), or None for unit weights (a product with 1.0 is exact,
    so skipping it changes nothing)."""
    if imatrix is None:
        return None
    block = group_size * super_group_size
    return imatrix.to(device=device, dtype=f32).reshape(
        1, I // block, super_group_size, group_size)


def _rows4(w, group_size, super_group_size):
    """(O, I) fp32 → (O, I / block, sgs, g)."""
    O, I = w.shape
    block = group_size * super_group_size
    if I % block:
        raise ValueError(f"in_features {I} not divisible by super-block "
                         f"{block}")
    return w.float().reshape(O, I // block, super_group_size, group_size)


def _wsum(weight, x):
    """Weighted sum over the last axis, added left to right in fp32 as
    XLA's CPU reduction adds (the least-squares refit cancels, so the
    order shows in its last bits)."""
    x = x if weight is None else weight * x
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _search_sym(wg, weight, bits, num_steps, step):
    """Per-sub-group shrink of the full-range sym scale with the least
    weighted squared error: d (…, sgs, 1)."""
    maxq = 2.0 ** (bits - 1)
    wmin, wmax = _extremes(wg)
    extreme = torch.where(-wmin > wmax, wmin, wmax)
    base_d = _where_eps(div_const(-extreme, maxq))
    ratios = 1.0 - step * torch.arange(num_steps, dtype=torch.float32,
                                       device=wg.device)
    best_err = best_r = None
    for r in ratios:                    # one candidate at a time
        d = base_d * r
        q = torch.clamp(torch.round(wg / d), -maxq, maxq - 1)
        err = _wsum(weight, (wg - q * d) ** 2)
        if best_err is None:
            best_err, best_r = err, r.expand_as(err).clone()
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_r = torch.where(better, r, best_r)
    return base_d * best_r[..., None]


def _search_asym(wg, weight, bits, num_steps):
    """Per-sub-group (scale, min) with the least weighted squared error:
    each shrink ratio's codes, then one weighted least-squares refit of
    (d, m) to them.  Returns (d, m) (…, sgs, 1), m ≥ 0 the stored min."""
    maxq = 2.0 ** bits - 1
    wmin, wmax = _extremes(wg)
    base_d = torch.maximum(div_const(wmax - wmin, maxq), _eps(wg))
    ratios = 1.0 - 0.0125 * torch.arange(num_steps, dtype=torch.float32,
                                         device=wg.device)
    sw = (wg.new_full((), wg.shape[-1]) if weight is None
          else _wsum(None, weight))
    sy = _wsum(weight, wg)
    best = None
    for r in ratios:
        d = base_d * r
        q = torch.clamp(torch.round((wg - wmin) / d), 0, maxq)
        wq = q if weight is None else weight * q      # (weight * q) * …,
        sx = _wsum(None, wq)                         # the JAX order
        sxx = _wsum(None, wq * q)
        sxy = _wsum(None, wq * wg)
        det = sw * sxx - sx * sx
        ok = det.abs() > _EPS
        den = torch.maximum(det, _eps(det))
        d_fit = torch.where(ok, (sw * sxy - sx * sy) / den, d[..., 0])
        m_fit = torch.where(ok, (sxx * sy - sx * sxy) / den, wmin[..., 0])
        d_fit = torch.maximum(d_fit, _eps(d_fit))[..., None]
        m_fit = torch.minimum(m_fit, torch.zeros_like(m_fit))[..., None]
        err = _wsum(weight, (wg - (q * d_fit + m_fit)) ** 2)
        if best is None:
            best = [err, d_fit, m_fit]
        else:
            better = err < best[0]
            best = [torch.where(better, err, best[0]),
                    torch.where(better[..., None], d_fit, best[1]),
                    torch.where(better[..., None], m_fit, best[2])]
    return best[1], -best[2]


def _row_chunks(O, I):
    rows = max(1, CHUNK_ELEMS // max(I, 1))
    return [(s, min(O, s + rows)) for s in range(0, O, rows)]


def search_dq_grid(w, bits, group_size, super_bits, super_group_size,
                   sym: bool, imatrix=None):
    """alg_ext's dq grid: the weighted k-quant scale (and min) search run
    once, its raw grid frozen for the tuning run.  Returns ``{"frozen_d":
    (n_super, sgs)}`` (and ``"frozen_m"`` when asym)."""
    O, I = w.shape
    weight = _weight_groups(imatrix, I, group_size, super_group_size,
                            torch.float32, w.device)
    ds, ms = [], []
    for a, b in _row_chunks(O, I):
        wg = _rows4(w[a:b], group_size, super_group_size)
        if sym:
            ds.append(_search_sym(wg, weight, bits, 20, 0.01)[..., 0])
        else:
            d, m = _search_asym(wg, weight, bits, 16)
            ds.append(d[..., 0])
            ms.append(m[..., 0])
    out = {"frozen_d": torch.cat(ds).reshape(-1, super_group_size)}
    if not sym:
        out["frozen_m"] = torch.cat(ms).reshape(-1, super_group_size)
    return out


def _cat_results(parts, O, sym, super_bits, super_group_size, group_size):
    qdq = torch.cat([p[0] for p in parts])
    d_super = torch.cat([p[1] for p in parts]).reshape(-1)
    d_hat = torch.cat([p[2] for p in parts]).reshape(-1, super_group_size)
    extras = {"d_super": d_super, "d_hat": d_hat}
    zp = None
    if not sym:
        m_super = torch.cat([p[3] for p in parts]).reshape(-1)
        m_hat = torch.cat([p[4] for p in parts]).reshape(-1, super_group_size)
        extras.update(m_super=m_super, m_hat=m_hat)
        zp = (m_hat / d_hat).reshape(O, -1)
    extras.update(sym=sym, super_bits=super_bits,
                  super_group_size=super_group_size, group_size=group_size)
    return QdqResult(qdq, d_hat.reshape(O, -1), zp, extras)


def rtn_int_dq_sym(w, bits, group_size, super_bits=6, super_group_size=16,
                   imatrix=None, num_steps: int = 20, step: float = 0.01,
                   **_):
    """Zero-shot sym k-quant with the weighted scale-shrink search, then
    the double quant of the searched scales."""
    O, I = w.shape
    weight = _weight_groups(imatrix, I, group_size, super_group_size,
                            torch.float32, w.device)
    maxq = 2.0 ** (bits - 1)
    smaxq = 2.0 ** (super_bits - 1) - 1
    parts = []
    for a, b in _row_chunks(O, I):
        wg = _rows4(w[a:b], group_size, super_group_size)
        d = _search_sym(wg, weight, bits, num_steps, step)
        d_super = torch.maximum(
            div_const(d.abs().amax(dim=-2, keepdim=True), smaxq), _eps(d))
        q_d = torch.clamp(torch.round(d / d_super), -smaxq - 1, smaxq)
        d_hat = _where_eps(q_d * d_super)
        del d, q_d
        q = torch.clamp(torch.round(wg / d_hat), -maxq, maxq - 1)
        parts.append(((q * d_hat).reshape(b - a, I).to(w.dtype),
                      d_super, d_hat))
        del wg, q
    return _cat_results(parts, O, True, super_bits, super_group_size,
                        group_size)


def rtn_int_dq_asym(w, bits, group_size, super_bits=6, super_group_size=8,
                    imatrix=None, num_steps: int = 16, **_):
    """Zero-shot asym k-quant with the joint (scale, min) candidate search,
    then the double quant of the searched scales and mins."""
    O, I = w.shape
    weight = _weight_groups(imatrix, I, group_size, super_group_size,
                            torch.float32, w.device)
    maxq = 2.0 ** bits - 1
    smaxq = 2.0 ** super_bits - 1
    parts = []
    for a, b in _row_chunks(O, I):
        wg = _rows4(w[a:b], group_size, super_group_size)
        d, m = _search_asym(wg, weight, bits, num_steps)
        d_super = torch.maximum(
            div_const(d.amax(dim=-2, keepdim=True), smaxq), _eps(d))
        m_super = torch.maximum(
            div_const(m.amax(dim=-2, keepdim=True), smaxq), _eps(m))
        d_hat = torch.maximum(
            torch.clamp(torch.round(d / d_super), 0, smaxq) * d_super,
            _eps(d))
        m_hat = torch.clamp(torch.round(m / m_super), 0, smaxq) * m_super
        del d, m
        q = torch.clamp(torch.round((wg + m_hat) / d_hat), 0, maxq)
        parts.append(((q * d_hat - m_hat).reshape(b - a, I).to(w.dtype),
                      d_super, d_hat, m_super, m_hat))
        del wg, q
    return _cat_results(parts, O, False, super_bits, super_group_size,
                        group_size)
