"""AWQ activation-aware smoothing (counterpart of
``autoround_tpu/transforms/awq.py``).

Channels with large activations get their weights scaled up, and the
producer of those activations scaled down, so the quantization error lands
on easy channels.  The mappings of a Llama-shaped block:

  input_layernorm  → {q,k,v}:      gain /= s,  W[:, c] *= s
  post_attn_norm   → {gate,up}:    gain /= s,  W[:, c] *= s
  up_proj          → {down}:       up rows /= s, down[:, c] *= s

with s = amax_x^α normalized by its geometric mean, α searched per mapping
on the grid against MSE(block with RTN'd layers, FP block).  A mapping
whose site or targets the block lacks (MoE experts, MLA) is skipped, as in
the JAX package.  :func:`awq_clip_search` then picks a per-group clip
ratio that seeds the tuner's min / max scales.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from ..algorithms.rtn import rtn_quantize_layer
from ..dtypes.fp8 import div_const
from ..dtypes.registry import get_quant_func
from ..schemes import QuantizationScheme
from ..utils.logger import logger
from ..utils.pytree import get_by_path

__all__ = ["collect_channel_amax", "awq_smooth_block", "awq_clip_search"]


def collect_channel_amax(fwd: Callable, weights, x, layer_names
                         ) -> Dict[str, torch.Tensor]:
    """Per-layer, per-input-channel activation amax, from one forward
    ``fwd(weights, x, linear_fn)`` with a tapping linear."""
    names = set(layer_names)
    stats: Dict[str, torch.Tensor] = {}

    def tap(name, xi, wi, b=None):
        if name in names:
            flat = xi.float().abs().reshape(-1, xi.shape[-1])
            stats[name] = flat.amax(dim=0)
        y = torch.einsum("...i,oi->...o", xi, wi)
        return y if b is None else y + b

    with torch.no_grad():
        fwd(weights, x, tap)
    return stats


# (scale site, kind, target linears): kind "norm" divides a gain vector,
# kind "linear_out" divides the producer's output rows
_MAPPINGS = [
    ("input_layernorm", "norm", ("q_proj", "k_proj", "v_proj")),
    ("post_attention_layernorm", "norm", ("gate_proj", "up_proj")),
    ("up_proj", "linear_out", ("down_proj",)),
]


def _apply_scale(block: Dict[str, Any], site: str, kind: str,
                 targets: Sequence[str], s: torch.Tensor) -> Dict[str, Any]:
    b = dict(block)
    sf = s.float()
    if kind == "norm":
        b[site] = (b[site].float() / sf).to(b[site].dtype)
    else:
        b[site] = (b[site].float() / sf[:, None]).to(b[site].dtype)
    for t in targets:
        b[t] = (b[t].float() * sf[None, :]).to(b[t].dtype)
    return b


def awq_smooth_block(
    block: Dict[str, Any],
    block_fwd: Callable,        # (weights, x, linear_fn=None) -> out
    x_calib: torch.Tensor,
    schemes: Dict[str, QuantizationScheme],
    alphas: Sequence[float] = (0.0, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9),
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Search the smoothing α per mapping.  Returns (block', chosen α)."""
    with torch.no_grad():
        amax = collect_channel_amax(block_fwd, block, x_calib,
                                    [m[2][0] for m in _MAPPINGS])
        ref_out = block_fwd(block, x_calib).float()

        def quantized_mse(b):
            qb = dict(b)
            for lname, scheme in schemes.items():
                if lname in qb:
                    qb[lname] = rtn_quantize_layer(qb[lname], scheme).qdq.to(
                        qb[lname].dtype)
            out = block_fwd(qb, x_calib)
            return float(((out.float() - ref_out) ** 2).mean())

        chosen = {}
        cur = block
        for site, kind, targets in _MAPPINGS:
            if site not in block or not any(
                    t in schemes and t in block for t in targets):
                continue
            ax = torch.clamp(amax[targets[0]], min=1e-5)
            best_alpha, best_loss, best_block = 0.0, None, cur
            for alpha in alphas:
                if alpha == 0.0:
                    cand = cur
                else:
                    s = ax ** alpha
                    s = s / torch.exp(torch.log(s).mean())  # geo-mean 1
                    s = torch.clamp(s, 1e-3, 1e3)
                    cand = _apply_scale(cur, site, kind, targets, s)
                loss = quantized_mse(cand)
                if best_loss is None or loss < best_loss:
                    best_alpha, best_loss, best_block = alpha, loss, cand
            chosen[site] = best_alpha
            cur = best_block
    logger.info("AWQ smoothing: chosen alphas %s", chosen)
    return cur, chosen


def awq_clip_search(
    block: Dict[str, Any],
    schemes: Dict[str, QuantizationScheme],
    imatrix: Dict[str, torch.Tensor],
    n_grid: int = 10,
    max_shrink: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Per-group clip ratio r in [max_shrink, 1] (through the scheme's own
    qdq as min / max scale) of the least activation-weighted error
    ``sum_i E[x_i^2] (qdq_ij - w_ij)^2``; the first least candidate wins.
    Returns {layer: (O, n_groups) ratios}, the clip-scale starts."""
    out: Dict[str, torch.Tensor] = {}
    for lname, scheme in schemes.items():
        g = scheme.group_size
        if isinstance(g, tuple):
            continue                 # 2-D block FP8: no row-group clip
        try:
            w = get_by_path(block, lname)
        except (KeyError, IndexError, TypeError):
            continue
        O, I = w.shape
        dev = w.device
        gg = I if g in (-1, 0) else min(g, I)
        pad = (-I) % gg
        ratios = 1.0 - div_const(torch.arange(n_grid, dtype=torch.float32,
                                              device=dev), n_grid) \
            * (1.0 - max_shrink)
        im = imatrix.get(lname)
        weight = (torch.ones((I,), dtype=torch.float32, device=dev)
                  if im is None else torch.clamp(im.float(), min=1e-12))
        fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
        kw = ({} if scheme.super_bits is None else dict(
            super_bits=scheme.super_bits,
            super_group_size=scheme.super_group_size))
        wf = w.float()
        best_err = best_r = None
        for r in ratios:             # one candidate at a time
            ms = torch.full((O, -(-I // gg)), float(r), dtype=torch.float32,
                            device=dev)
            qdq = fn(w, bits=scheme.bits, group_size=scheme.group_size,
                     min_scale=ms, max_scale=ms, clip_lo=0.0, clip_hi=1.0,
                     **kw).qdq
            d = (qdq.float() - wf) ** 2 * weight[None, :]
            if pad:
                d = torch.nn.functional.pad(d, (0, pad))
            err = d.reshape(O, -1, gg).sum(-1)
            if best_err is None:
                best_err, best_r = err, r.expand_as(err).clone()
            else:
                better = err < best_err
                best_err = torch.where(better, err, best_err)
                best_r = torch.where(better, r, best_r)
        out[lname] = best_r
    return out
