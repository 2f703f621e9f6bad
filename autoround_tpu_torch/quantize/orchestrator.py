"""Block-chain quantization driver, ``iters == 0`` (RTN) path
(counterpart of ``autoround_tpu/quantize/orchestrator.py``).

Cache the block-0 inputs, then walk the blocks: per block run the FP
reference forward on the FP input cache (the calibration chain), RTN each
of the block's linears and write the qdq weights back into the block, and
advance the chain.  The lm_head is RTN-quantized at the end when the plan
holds it.  SignRound tuning (``iters > 0``) comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..algorithms.rtn import rtn_quantize_layer
from ..models import llama
from ..schemes import QuantizationScheme

__all__ = ["QuantizeConfig", "QuantizedLayer", "QuantizeResult",
           "quantize_model"]


@dataclass(frozen=True)
class QuantizeConfig:
    """Run-level knobs (the fields of the JAX config this slice reads)."""

    iters: int = 200
    cache_batch: int = 8  # batch size for cache-advance forwards
    # free each original block as soon as its qdq replacement exists.
    # MUTATES the caller's params["blocks"] entries to None — opt in only
    # when the FP params are not needed afterwards.
    donate_params: bool = False


@dataclass
class QuantizedLayer:
    """Export payload for one layer: qdq weight + scale/zp + scheme."""

    name: str
    scheme: QuantizationScheme
    qdq: torch.Tensor
    scale: torch.Tensor
    zp: Optional[torch.Tensor]


@dataclass
class QuantizeResult:
    params: Dict[str, Any]               # model params with qdq weights baked
    layers: Dict[str, QuantizedLayer]    # per-layer export payloads


def _batched_block_apply(block_weights, x, cos, sin, cfg, batch: int):
    """Advance a cache through one block, ``batch`` samples at a time."""
    outs = [llama.block_fwd(block_weights, x[s:s + batch], cos, sin, cfg)
            for s in range(0, x.shape[0], batch)]
    return torch.cat(outs, dim=0)


def quantize_model(
    params: Dict[str, Any],
    model_cfg: llama.LlamaConfig,
    layer_schemes: Dict[str, QuantizationScheme],
    input_ids: torch.Tensor,
    cfg: QuantizeConfig = QuantizeConfig(),
) -> QuantizeResult:
    """Quantize a Llama-family model block by block.

    input_ids: (nsamples, seqlen) calibration tokens on the params' device.
    ``iters == 0`` is the RTN zero-shot path, the only one ported so far.
    """
    if cfg.iters > 0:
        raise NotImplementedError(
            "SignRound tuning (iters > 0) is not ported yet: ROADMAP "
            "'A3. SignRound' (next slice); use iters=0 for RTN")
    per_block: Dict[int, Dict[str, QuantizationScheme]] = {}
    for flat, scheme in layer_schemes.items():
        parts = flat.split(".", 2)
        if parts[0] == "blocks":
            per_block.setdefault(int(parts[1]), {})[parts[2]] = scheme
        elif flat != "lm_head":
            raise NotImplementedError(
                f"quantizing {flat!r} is not ported yet (only blocks.* "
                f"linears and lm_head)")

    seqlen = input_ids.shape[1]
    x_fp = llama.embed_fwd(params, input_ids, model_cfg)
    cos, sin = llama.rope_tables(model_cfg, seqlen, device=x_fp.device)

    new_blocks = []
    layers: Dict[str, QuantizedLayer] = {}
    for bi, block in enumerate(params["blocks"]):
        schemes = per_block.get(bi, {})
        ref_out = _batched_block_apply(block, x_fp, cos, sin, model_cfg,
                                       cfg.cache_batch)
        qdq_block = dict(block)
        for lname, scheme in schemes.items():
            w_orig = block[lname]
            r = rtn_quantize_layer(w_orig, scheme)
            qdq_block[lname] = r.qdq.to(w_orig.dtype)
            layers[f"blocks.{bi}.{lname}"] = QuantizedLayer(
                name=f"blocks.{bi}.{lname}", scheme=scheme,
                qdq=qdq_block[lname], scale=r.scale, zp=r.zp)
        new_blocks.append(qdq_block)
        if cfg.donate_params:
            params["blocks"][bi] = None   # free the FP block
        x_fp = ref_out

    new_params = dict(params)
    new_params["blocks"] = new_blocks
    if "lm_head" in layer_schemes:
        head_name = "lm_head" if params.get("lm_head") is not None \
            else "embed_tokens"
        w = params[head_name]
        r = rtn_quantize_layer(w, layer_schemes["lm_head"])
        new_params[head_name] = r.qdq.to(w.dtype)
        layers["lm_head"] = QuantizedLayer(
            name="lm_head", scheme=layer_schemes["lm_head"],
            qdq=new_params[head_name], scale=r.scale, zp=r.zp)
    return QuantizeResult(params=new_params, layers=layers)
