"""Block-chain quantization loop (counterpart of
``autoround_tpu/quantize/orchestrator.py``), ``nblocks=1``, for every
family of ``models.registry``.

Cache the block-0 inputs, then walk the blocks.  Per block: run the FP
reference forward on the FP input cache; tune the block's linears with
SignRound (``iters > 0``) on the quantized-input cache against that
reference, or RTN them (``iters == 0``); write the qdq weights back into
the block (layer names may be dotted paths into nested leaves, e.g.
``experts.3.w1`` of a MoE block); and advance both caches, the FP one
through the original block and the quantized one through the qdq block
(the dual chains).  The lm_head, when the plan holds it, is tuned against
the final hidden states or RTN'd (its activations are never quantized).

A scheme that quantizes activations adds, per block: the input amax of
every such layer on the FP pass, static (and global) activation scales from
it, and a ``linear_fn`` that qdq's those layers' inputs in the tuning loss
and on the quantized chain.  ``enable_act_minmax_tuning`` also tunes a
shrink factor on each static scale.

Everything but the tuning step runs without autograd; ``tune_block``
switches gradients on for its own loss.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..algorithms.actquant import (build_static_act_scales,
                                   collect_act_stats, collect_imatrix,
                                   collect_output_stats,
                                   make_act_quant_linear_fn)
from ..algorithms.rtn import rtn_quantize_layer
from ..algorithms.signround import TuneConfig, tune_block
from ..dtypes.registry import get_quant_func
from ..models.llama import (LlamaConfig, dual_rope_tables, layer_is_sliding,
                            rms_norm, sliding_mask)
from ..models.registry import get_model_fns
from ..schemes import QuantizationScheme
from ..utils.pytree import get_by_path, set_by_path

__all__ = ["QuantizeConfig", "QuantizedLayer", "QuantizeResult",
           "quantize_model"]

logger = logging.getLogger("autoround_tpu_torch")


@dataclass(frozen=True)
class QuantizeConfig:
    """Run-level knobs (the JAX config's fields; the options this slice
    leaves out raise ``NotImplementedError`` in :func:`quantize_model`)."""

    iters: int = 200
    lr: Optional[float] = None
    minmax_lr: Optional[float] = None
    batch_size: int = 8
    seed: int = 42
    enable_quanted_input: bool = True
    enable_minmax_tuning: bool = True
    enable_round_tuning: bool = True
    use_best_params: bool = True
    dynamic_max_gap: int = -1
    gradient_accumulate_steps: int = 1
    cache_batch: int = 8  # batch size for cache-advance forwards
    enable_alg_ext: bool = False
    use_imatrix: bool = False
    enable_awq: bool = False
    optimizer: str = "signsgd"
    quant_attention: bool = False
    enable_norm_bias_tuning: bool = False
    nblocks: int = 1
    enable_lfq: bool = False
    resume_dir: Optional[str] = None
    immediate_save_dir: Optional[str] = None
    # free each original block as soon as its qdq replacement exists.
    # MUTATES the caller's params["blocks"] entries to None — opt in only
    # when the FP params are not needed afterwards.
    donate_params: bool = False
    offload_params: bool = False
    # recompute the tuning forward in the backward pass instead of holding
    # its activations
    use_remat: bool = False
    # tune a shrink factor on the static activation scales (the JAX
    # package reads this switch from the environment)
    enable_act_minmax_tuning: bool = False

    def tune_config(self) -> TuneConfig:
        return TuneConfig(
            iters=self.iters, lr=self.lr, minmax_lr=self.minmax_lr,
            batch_size=self.batch_size, seed=self.seed,
            enable_minmax_tuning=self.enable_minmax_tuning,
            enable_round_tuning=self.enable_round_tuning,
            use_best_params=self.use_best_params,
            dynamic_max_gap=self.dynamic_max_gap,
            gradient_accumulate_steps=self.gradient_accumulate_steps,
            enable_alg_ext=self.enable_alg_ext,
            optimizer=self.optimizer,
            enable_norm_bias_tuning=self.enable_norm_bias_tuning,
            use_remat=self.use_remat,
            tune_act_scales=self.enable_act_minmax_tuning,
        )


# QuantizeConfig options of the JAX package this slice leaves out:
# (field, its "off" value, what it is, ROADMAP item)
_UNPORTED = (
    ("nblocks", 1, "joint tuning of several blocks", "A5"),
    ("enable_awq", False, "AWQ smoothing", "A12"),
    ("enable_lfq", False, "last-block LM loss", "A5"),
    ("resume_dir", None, "crash resume", "A12"),
    ("immediate_save_dir", None, "immediate streaming pack", "A5"),
    ("offload_params", False, "host offload of the params", "A5"),
)


@dataclass
class QuantizedLayer:
    """Export payload for one layer: qdq weight + scale/zp + scheme, plus
    the static activation scales when the scheme quantizes activations."""

    name: str
    scheme: QuantizationScheme
    qdq: torch.Tensor
    scale: torch.Tensor
    zp: Optional[torch.Tensor]
    act_scale: Optional[torch.Tensor] = None         # static act scale
    act_global_scale: Optional[torch.Tensor] = None  # NVFP4 global scale


@dataclass
class QuantizeResult:
    params: Dict[str, Any]               # model params with qdq weights baked
    layers: Dict[str, QuantizedLayer]    # per-layer export payloads
    # per-block loss trace of the tuning run (numpy, one loss per iteration)
    loss_traces: Dict[int, np.ndarray] = field(default_factory=dict)
    # per-block attention scales {block: {"q_proj" / "k_proj" / "v_proj": s}}
    # (``quant_attention``: output amax / 448)
    attention_scales: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    # per-layer input second moments collected under ``use_imatrix``
    imatrices: Dict[str, np.ndarray] = field(default_factory=dict)


def _batched_block_apply(block_fn, block_weights, x, batch: int,
                         linear_fn=None):
    """Advance a cache through one block, ``batch`` samples at a time."""
    outs = [block_fn(block_weights, x[s:s + batch], linear_fn)
            for s in range(0, x.shape[0], batch)]
    return torch.cat(outs, dim=0)


def _finalize_layer(name: str, w: torch.Tensor, scheme: QuantizationScheme,
                    tune_params, tcfg: TuneConfig,
                    inner_name: Optional[str] = None) -> QuantizedLayer:
    """Re-run the qdq once with the best params to harvest scale/zp."""
    fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
    key = inner_name if inner_name is not None else name.split(".")[-1]
    p = tune_params.get(key, {}) if tune_params else {}
    r = fn(w, bits=scheme.bits, group_size=scheme.group_size,
           v=p.get("v"), min_scale=p.get("min_scale"),
           max_scale=p.get("max_scale"),
           clip_lo=tcfg.clip_lo, clip_hi=tcfg.clip_hi)
    return QuantizedLayer(name=name, scheme=scheme, qdq=r.qdq, scale=r.scale,
                          zp=r.zp)


def _head_fwd(ws, xb):
    return torch.einsum("bsi,oi->bso", xb, ws["head"])


def quantize_model(
    params: Dict[str, Any],
    model_cfg: LlamaConfig,
    layer_schemes: Dict[str, QuantizationScheme],
    input_ids: torch.Tensor,
    cfg: QuantizeConfig = QuantizeConfig(),
    mask: Optional[torch.Tensor] = None,
) -> QuantizeResult:
    """Quantize a model of a registered family block by block.

    input_ids: (nsamples, seqlen) calibration tokens on the params' device.
    mask: optional (nsamples, seqlen) valid-token mask (pad → 0).
    ``iters == 0`` is the RTN zero-shot path; ``iters > 0`` tunes with
    SignRound.  Call it under ``torch.no_grad()`` or not, alike.
    """
    for name, off, what, item in _UNPORTED:
        if getattr(cfg, name) != off:
            raise NotImplementedError(
                f"QuantizeConfig.{name}={getattr(cfg, name)!r} ({what}) is "
                f"not ported yet (ROADMAP {item})")
    per_block: Dict[int, Dict[str, QuantizationScheme]] = {}
    for flat, scheme in layer_schemes.items():
        try:
            get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
        except KeyError:
            raise NotImplementedError(
                f"{flat}: weight data type {scheme.data_type!r} is not ported "
                f"yet (ROADMAP A9); the port quantizes the int, MX, NVFP4, "
                f"fp4_v2 and FP8 data types") from None
        parts = flat.split(".", 2)
        if parts[0] == "blocks":
            per_block.setdefault(int(parts[1]), {})[parts[2]] = scheme
        elif flat != "lm_head":
            raise NotImplementedError(
                f"quantizing {flat!r} is not ported yet (only blocks.* "
                f"linears and lm_head)")
    tcfg = cfg.tune_config()
    with torch.no_grad():
        return _quantize_blocks(params, model_cfg, layer_schemes, per_block,
                                input_ids, cfg, tcfg, mask)


def _quantize_blocks(params, model_cfg, layer_schemes, per_block, input_ids,
                     cfg, tcfg, mask) -> QuantizeResult:
    mfns = get_model_fns(model_cfg)
    seqlen = input_ids.shape[1]
    x_fp = mfns.embed_fwd(params, input_ids, model_cfg)
    x_q = x_fp if (cfg.enable_quanted_input and cfg.iters > 0) else None
    (cos, sin), (cosl, sinl) = dual_rope_tables(model_cfg, seqlen,
                                                device=x_fp.device)
    # a sliding layer takes the local tables and, past the window, the
    # sliding mask: in the FP reference, the stats passes and the tuning
    # loss alike (the JAX orchestrator's guard against tuning a sliding
    # layer toward a full-causal reference)
    smask = (sliding_mask(model_cfg, seqlen, x_fp.device)
             if model_cfg.sliding_window is not None
             and seqlen > model_cfg.sliding_window else None)

    def block_fn_for(bi: int):
        c, s, m = ((cosl, sinl, smask) if layer_is_sliding(model_cfg, bi)
                   else (cos, sin, None))

        def block_fn(w, xb, linear_fn=None):
            return mfns.block_fwd(w, xb, c, s, model_cfg, mask=m,
                                  linear_fn=linear_fn)
        return block_fn

    new_blocks = []
    layers: Dict[str, QuantizedLayer] = {}
    traces: Dict[int, np.ndarray] = {}
    attention_scales: Dict[int, Dict[str, Any]] = {}
    imatrices: Dict[str, np.ndarray] = {}
    for bi, block in enumerate(params["blocks"]):
        t_block = time.time()
        schemes = per_block.get(bi, {})
        block_fn = block_fn_for(bi)
        ref_out = _batched_block_apply(block_fn, block, x_fp,
                                       cfg.cache_batch)
        qdq_block = block         # set_by_path copies the branches it edits
        if schemes and cfg.quant_attention:
            qkv_amax = collect_output_stats(
                block_fn, block, x_fp[:cfg.cache_batch],
                ("q_proj", "k_proj", "v_proj"))
            attention_scales[bi] = {k: v / 448.0 for k, v in qkv_amax.items()}

        # activation quantization: per-layer amax on the FP pass, static
        # and global scales from it, and the interceptor
        act_lf = None
        static_scales: Dict[str, torch.Tensor] = {}
        global_scales: Dict[str, torch.Tensor] = {}
        if any(s.effective_act().is_act_quantized for s in schemes.values()):
            amax = collect_act_stats(block_fn, block, x_fp[:cfg.cache_batch],
                                     set(schemes))
            static_scales, global_scales = build_static_act_scales(schemes,
                                                                   amax)
            act_lf = make_act_quant_linear_fn(schemes, static_scales,
                                              global_scales)

        if schemes and cfg.iters > 0:
            tune_in = x_q if x_q is not None else x_fp
            tune_fn, tune_weights = block_fn, block
            if act_lf is not None:
                # the scales ride in the weights under a reserved key, so
                # the tuner can put its shrink factors on them
                tune_weights = dict(block)
                tune_weights["_act_scales"] = {"static": static_scales,
                                               "global": global_scales}

                def tune_fn(w, xb, _schemes=schemes):
                    scales = w["_act_scales"]
                    lf = make_act_quant_linear_fn(
                        _schemes, scales.get("static") or None,
                        scales.get("global") or None)
                    inner = {k: v for k, v in w.items()
                             if k != "_act_scales"}
                    return block_fn(inner, xb, lf)
            best, info = tune_block(tune_fn, tune_weights, tune_in, ref_out,
                                    schemes, tcfg, mask=mask)
            traces[bi] = info["loss_trace"]
            logger.info("block %d: loss iter0 %.6f -> best %.6f (%.1fs)", bi,
                        info["first_loss"], info["best_loss"],
                        time.time() - t_block)
            if "_act" in best:
                # bake the tuned shrink into the static scales
                for lname, p in best["_act"].items():
                    if lname in static_scales:
                        static_scales[lname] = static_scales[lname] \
                            * torch.clamp(p["scale"], tcfg.clip_lo,
                                          tcfg.clip_hi)
                act_lf = make_act_quant_linear_fn(schemes, static_scales,
                                                  global_scales)
            for lname, scheme in schemes.items():
                w_orig = get_by_path(block, lname)
                ql = _finalize_layer(f"blocks.{bi}.{lname}", w_orig, scheme,
                                     best, tcfg, inner_name=lname)
                qdq_block = set_by_path(qdq_block, lname,
                                        ql.qdq.to(w_orig.dtype))
                layers[ql.name] = ql
            del best
        else:
            im: Dict[str, torch.Tensor] = {}
            if schemes and cfg.use_imatrix:
                im = collect_imatrix(block_fn, block, x_fp[:cfg.cache_batch],
                                     set(schemes))
                for ln, v in im.items():
                    imatrices[f"blocks.{bi}.{ln}"] = v.cpu().numpy()
            for lname, scheme in schemes.items():
                w_orig = get_by_path(block, lname)
                r = rtn_quantize_layer(w_orig, scheme, imatrix=im.get(lname))
                qdq = r.qdq.to(w_orig.dtype)
                qdq_block = set_by_path(qdq_block, lname, qdq)
                layers[f"blocks.{bi}.{lname}"] = QuantizedLayer(
                    name=f"blocks.{bi}.{lname}", scheme=scheme, qdq=qdq,
                    scale=r.scale, zp=r.zp)
        for lname in schemes:
            ql = layers[f"blocks.{bi}.{lname}"]
            ql.act_scale = static_scales.get(lname)
            ql.act_global_scale = global_scales.get(lname)
        new_blocks.append(qdq_block)
        if cfg.donate_params:
            params["blocks"][bi] = None   # free the FP block
        block = None
        # advance the chains: FP through the original block (done above),
        # the quantized one through the qdq block with the activation
        # interceptor still on
        x_fp = ref_out
        if x_q is not None:
            x_q = _batched_block_apply(block_fn, qdq_block, x_q,
                                       cfg.cache_batch, linear_fn=act_lf)

    new_params = dict(params)
    new_params["blocks"] = new_blocks
    if "lm_head" in layer_schemes:
        head_name = "lm_head" if params.get("lm_head") is not None \
            else "embed_tokens"
        w = params[head_name]
        scheme = layer_schemes["lm_head"]
        if cfg.iters > 0:
            # tuned against the final hidden states; the fp32 reference
            # logits are computed cache_batch samples at a time.  The JAX
            # orchestrator norms them without the Gemma offset and tunes
            # against uncapped logits; the port does the same
            h_src = x_q if x_q is not None else x_fp
            normed = rms_norm(h_src, params["norm"], model_cfg.rms_eps)
            wf = w.float()
            ref = torch.cat([
                torch.einsum("bsi,oi->bso", normed[s:s + cfg.cache_batch]
                             .float(), wf).to(normed.dtype)
                for s in range(0, normed.shape[0], cfg.cache_batch)])
            del wf
            best, info = tune_block(_head_fwd, {"head": w}, normed, ref,
                                    {"head": scheme}, tcfg, mask=mask)
            del ref
            logger.info("lm_head: loss iter0 %.6f -> best %.6f",
                        info["first_loss"], info["best_loss"])
            ql = _finalize_layer("lm_head", w, scheme, best, tcfg,
                                 inner_name="head")
        else:
            r = rtn_quantize_layer(w, scheme)
            ql = QuantizedLayer(name="lm_head", scheme=scheme, qdq=r.qdq,
                                scale=r.scale, zp=r.zp)
        ql.qdq = ql.qdq.to(w.dtype)
        new_params[head_name] = ql.qdq
        layers["lm_head"] = ql
    return QuantizeResult(params=new_params, layers=layers,
                          loss_traces=traces,
                          attention_scales=attention_scales,
                          imatrices=imatrices)
