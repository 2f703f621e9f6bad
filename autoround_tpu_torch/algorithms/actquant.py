"""Activation fake-quant, dynamic and static, per scheme (counterpart of
``autoround_tpu/algorithms/actquant.py``).

A ``linear_fn`` interceptor qdq's the activation in front of the matmul,
and stats passes return per-layer amax / second moments from one forward
with a tapping ``linear_fn``.

Activation grouping (the scheme's act fields):
  * act_group_size 0  → per-tensor
  * act_group_size -1 → per-token (row)
  * act_group_size n  → groups of n along the channel axis (MX / NVFP)

Every activation qdq of the JAX package runs under ``jit`` (the tuning
loss, the quantized chain), where XLA turns a division by a constant into
a product with its fp32 reciprocal; the port computes that form
(``recip=True`` for the float types).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..dtypes import fp8 as fp8_mod
from ..dtypes import mxfp as mxfp_mod
from ..dtypes import nvfp as nvfp_mod
from ..dtypes.intq import _clip
from ..dtypes.ste import round_ste
from ..schemes import QuantizationScheme

__all__ = ["qdq_act", "make_act_quant_linear_fn", "collect_act_stats",
           "collect_output_stats", "collect_imatrix",
           "build_static_act_scales"]


def _qdq_act_int(x, bits, group_size, sym, static_scale=None):
    """Dynamic (or static per-tensor) int activation qdq.  The sym code
    range is [-qmax - 1, qmax]; the scale's floor is 1e-8.  The dynamic
    scale is ``amax * fp32(1 / qmax)``: that is what XLA compiles the JAX
    package's jitted ``amax / qmax`` to, and the tuning loss and the
    quantized chain run there under jit."""
    dt = x.dtype
    xf = x.float()
    if sym:
        qmax = 2.0 ** (bits - 1) - 1
        if static_scale is not None:
            scale = static_scale
        elif group_size == 0:
            scale = xf.abs().amax() * (1.0 / qmax)
        else:  # per-token
            scale = xf.abs().amax(dim=-1, keepdim=True) * (1.0 / qmax)
        scale = torch.clamp(scale, min=1e-8)
        q = _clip(round_ste(xf / scale), -qmax - 1, qmax)
        return (q * scale).to(dt)
    qmax = 2.0 ** bits - 1
    if group_size == 0:
        lo, hi = xf.amin(), xf.amax()
    else:
        lo = xf.amin(dim=-1, keepdim=True)
        hi = xf.amax(dim=-1, keepdim=True)
    scale = torch.clamp((hi - lo) * (1.0 / qmax), min=1e-8)
    zp = torch.round(-lo / scale)
    q = _clip(round_ste(xf / scale) + zp, 0, qmax)
    return ((q - zp) * scale).to(dt)


def qdq_act(x: torch.Tensor, scheme: QuantizationScheme,
            static_scale: Optional[torch.Tensor] = None,
            global_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qdq an activation tensor (..., H) according to the scheme's act_*
    fields; a scheme that does not quantize activations passes it
    through."""
    s = scheme.effective_act()
    if not s.is_act_quantized:
        return x
    adt = s.act_data_type
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    if adt.startswith("mx_"):
        name = adt if adt in mxfp_mod.MX_FORMATS else {
            ("mx_fp", 4): "mx_fp4", ("mx_fp", 6): "mx_fp6_e2m3",
            ("mx_fp", 8): "mx_fp8", ("mx_int", 8): "mx_int8",
            ("mx_int", 4): "mx_int4",
        }[(adt, s.act_bits)]
        r = mxfp_mod.qdq_mx(x2, name, group_size=s.act_group_size or 32,
                            rounding="rceil", recip=True)
        return r.qdq.reshape(shp)
    if adt.startswith("nv_fp"):
        r = nvfp_mod.qdq_nvfp4(x2, group_size=s.act_group_size or 16,
                               global_scale=global_scale, recip=True)
        return r.qdq.reshape(shp)
    if "fp8" in adt:
        gs = 0 if not s.act_dynamic else (s.act_group_size
                                          if s.act_group_size in (0, -1) else 0)
        r = fp8_mod.qdq_fp8_sym(x2, group_size=gs, scale=static_scale,
                                recip=True)
        return r.qdq.reshape(shp)
    return _qdq_act_int(x, s.act_bits, s.act_group_size or 0, bool(s.act_sym),
                        static_scale=static_scale)


def make_act_quant_linear_fn(
    schemes: Dict[str, QuantizationScheme],
    static_scales: Optional[Dict[str, torch.Tensor]] = None,
    global_scales: Optional[Dict[str, torch.Tensor]] = None,
) -> Callable:
    """A block ``linear_fn(name, x, w, b=None)`` that act-quantizes the
    inputs of the layers whose scheme asks for it; the others pass
    through.  The bias adds after the product."""
    act_layers = {n: s for n, s in schemes.items()
                  if s.effective_act().is_act_quantized}

    def linear_fn(name, x, w, b=None):
        if name in act_layers:
            ss = static_scales.get(name) if static_scales else None
            gs = global_scales.get(name) if global_scales else None
            x = qdq_act(x, act_layers[name], static_scale=ss, global_scale=gs)
        y = torch.einsum("...i,oi->...o", x, w)
        return y if b is None else y + b

    return linear_fn


def _stats_pass(fwd: Callable, kind: str, weights, inputs,
                layer_names) -> Dict[str, torch.Tensor]:
    """One forward of ``fwd(weights, inputs, linear_fn)`` with a tapping
    ``linear_fn``; ``kind`` is ``in_amax``, ``out_amax`` (the output with
    its bias) or ``imatrix``."""
    names = set(layer_names)
    stats: Dict[str, torch.Tensor] = {}

    def tap(name, xx, ww, b=None):
        if name in names:
            if kind == "in_amax":
                stats[name] = xx.float().abs().amax()
            elif kind == "imatrix":
                flat = xx.float().reshape(-1, xx.shape[-1])
                stats[name] = (flat * flat).mean(dim=0)
        y = torch.einsum("...i,oi->...o", xx, ww)
        if b is not None:
            y = y + b
        if kind == "out_amax" and name in names:
            stats[name] = y.float().abs().amax()
        return y

    with torch.no_grad():
        fwd(weights, inputs, tap)
    return stats


def collect_act_stats(fwd: Callable, weights: Dict[str, Any],
                      inputs: torch.Tensor,
                      layer_names) -> Dict[str, torch.Tensor]:
    """Per-layer input amax.  ``fwd(weights, x, linear_fn)`` applies the
    block with the interceptor."""
    return _stats_pass(fwd, "in_amax", weights, inputs, layer_names)


def collect_output_stats(fwd: Callable, weights: Dict[str, Any],
                         inputs: torch.Tensor,
                         layer_names) -> Dict[str, torch.Tensor]:
    """Per-layer output amax (the q/k/v scale collection of static
    attention quantization)."""
    return _stats_pass(fwd, "out_amax", weights, inputs, layer_names)


def collect_imatrix(fwd: Callable, weights: Dict[str, Any],
                    inputs: torch.Tensor,
                    layer_names) -> Dict[str, torch.Tensor]:
    """Per-layer importance matrix: the mean of the squared inputs per
    input channel."""
    return _stats_pass(fwd, "imatrix", weights, inputs, layer_names)


def build_static_act_scales(
    schemes: Dict[str, QuantizationScheme],
    act_amax: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Static act scales / NVFP global scales from collected amax (fp8
    static scale = amax / 448, int static scale = amax / qmax, the NVFP4
    global scale formula)."""
    static_scales: Dict[str, torch.Tensor] = {}
    global_scales: Dict[str, torch.Tensor] = {}
    for name, scheme in schemes.items():
        s = scheme.effective_act()
        if not s.is_act_quantized or name not in act_amax:
            continue
        amax = torch.clamp(act_amax[name], min=1e-12)
        adt = s.act_data_type
        # the JAX package runs these eagerly: true divisions
        if adt.startswith("nv_fp"):
            global_scales[name] = torch.full_like(amax, 448.0 * 6.0) / amax
        elif "fp8" in adt and not s.act_dynamic:
            static_scales[name] = fp8_mod.div_const(amax, 448.0)
        elif adt.startswith("int") and not s.act_dynamic:
            static_scales[name] = fp8_mod.div_const(
                amax, 2.0 ** (s.act_bits - 1) - 1)
    return static_scales, global_scales
