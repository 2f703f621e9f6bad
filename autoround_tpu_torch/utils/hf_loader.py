"""HF checkpoint ↔ parameter tree (counterpart of
``autoround_tpu/utils/hf_loader.py``) for the families the port has:
``llama`` (with Llama-3.1 ``rope_scaling``), ``mistral``, ``qwen2``,
``qwen3``, ``gemma2``, ``gemma3_text``, ``phi3``, ``mixtral``,
``qwen2_moe``, ``qwen3_moe``, ``deepseek_v2``, ``deepseek_v3``,
``glm4_moe_lite`` (GLM-4.6-Lite, a DeepSeek-V2 architecture), ``glm4_moe``
(GLM-4.5: GQA with partial rotary and the DeepSeek router), ``glm_moe_dsa``
(GLM-5: DeepSeek MLA + MoE with the DSA lightning indexer), ``gpt_oss``,
``llama4_text``, ``qwen3_next``, ``qwen3_5_moe``, ``qwen3_5``,
``minimax`` and, for the config alone, ``step3p5``.  GPT-OSS
and Llama 4 store their experts fused (``gate_up_proj`` (E, H, 2I),
``down_proj`` (E, I, H)), Qwen3.5 as (E, 2I, H) / (E, H, I) stacks; they
split into per-expert (O, I) leaves at load (GPT-OSS's gate / up columns
interleaved, the others' in halves), so each expert quantizes alone.
Qwen3-Next's ``linear_attn.*`` keys become the DeltaNet leaves (the
depthwise conv (conv_dim, 1, K) as (conv_dim, K); ``dt_bias`` and ``A_log``
in fp32), and Qwen3.5's ``mtp.*`` draft tensors are skipped.  A DeepSeek
checkpoint's ``self_attn.indexer.{q_proj,k_proj,weights_proj}`` go into the
block's ``indexer`` dict (the JAX loader's rule, for any DeepSeek config);
a GLM-5 layer without one takes a copy of its governing layer's.
MiniMax's lightning layers keep ``self_attn.qkv_proj`` fused (it is not
Phi-3's split), ``out_proj``, ``output_gate`` and ``self_attn.norm`` (as
``attn_norm``); its decay buffers are skipped and each linear block's
``slope_rate`` is computed from the config after the load, in fp32.

``load_hf_checkpoint`` reads a local safetensors checkpoint (one file, or
shards through ``model.safetensors.index.json``) with the port's own
reader (``utils/safetensors_io.py``) straight onto the caller's device, one
tensor at a time: nothing holds a second full copy on the host.
``save_hf_checkpoint`` writes one, byte-equal to the JAX package's for the
same weights.  Weights keep the HF (out, in) layout, which is the port's.

A published GLM-4.5 or DeepSeek-V3 checkpoint also holds its draft layer
(``num_nextn_predict_layers``) as ``model.layers.<num_hidden_layers>.*``;
the JAX loader stops there with an ``IndexError``, and this one raises a
``ValueError`` naming the key (ROADMAP C).

Step-3.5 (``step3p5``) has its config read, field by field as the JAX
loader's (``num_attention_groups``, the ``[theta, theta_local]`` pair,
``moe_layers_enum``, the first nonzero ``swiglu_limits[_shared]``, the
sliding layers' ``attention_other_setting``; the MTP layers are not
counted).  Its weights are not read: the JAX loader maps none of its
own leaves (it drops ``g_proj`` and every ``moe.*`` / ``share_expert.*``
tensor without a word, and stops with an ``IndexError`` at the first MTP
layer), so :func:`load_hf_checkpoint` raises ``NotImplementedError``
naming the family (ROADMAP A, item 5).  An FP8-source checkpoint (F8
weights with ``weight_scale_inv`` / ``weight_scale`` tensors: DeepSeek-V3's
published files) is dequantized on the device as it loads, as the JAX
loader does (:func:`_iter_shards`). The JAX
package has no HF writer for GPT-OSS, Llama 4 or Qwen3-Next (its
``save_hf_checkpoint`` writes their trees with Llama / Mixtral / Qwen2-MoE
keys and drops the sinks, the biases and the DeltaNet leaves), for GLM-5
it writes ``deepseek_v3`` and drops the indexer, and for MiniMax it writes
``mixtral`` and drops the lightning leaves; :func:`save_hf_checkpoint`
refuses all five, and ERNIE-4.5, LongCat and Step-3.5, which have no HF
layout in either package, and GPT-OSS's native MXFP4 expert tensors
(``*_blocks`` / ``*_scales``) are not read, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from .._device import resolve_device
import numpy as np

from ..models.deepseek import DeepseekConfig
from ..models.ernie45 import Ernie45Config
from ..models.glm4moe import Glm4MoeConfig, GlmMoeLiteConfig
from ..models.glmdsa import GlmMoeDsaConfig
from ..models.gptoss import GptOssConfig
from ..models.llama import LlamaConfig
from ..models.llama4 import Llama4Config
from ..models.longcat import LongcatConfig
from ..models.minimax import MiniMaxConfig, layer_is_linear, slope_rate
from ..models.mixtral import MixtralConfig
from ..models.qwen3next import Qwen35MoeConfig, Qwen3NextConfig
from ..models.step35 import Step35Config
from .logger import logger
from .safetensors_io import SafeOpen, save_file

__all__ = ["load_hf_checkpoint", "save_hf_checkpoint", "config_from_hf",
           "shard_files"]

_BLOCK_MAP = {
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "self_attn.q_proj.bias": "q_bias",
    "self_attn.k_proj.bias": "k_bias",
    "self_attn.v_proj.bias": "v_bias",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
    "input_layernorm.weight": "input_layernorm",
    "post_attention_layernorm.weight": "post_attention_layernorm",
    # Qwen3 per-head qk-norm gains
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    # Gemma2 sandwich norms
    "pre_feedforward_layernorm.weight": "pre_feedforward_layernorm",
    "post_feedforward_layernorm.weight": "post_feedforward_layernorm",
}
_TOP_MAP = {
    "model.embed_tokens.weight": "embed_tokens",
    "model.norm.weight": "norm",
    "lm_head.weight": "lm_head",
}

_QWEN3NEXT_TYPES = ("qwen3_next", "qwen3_5_moe", "qwen3_5")
_FP8_SCALES = (".weight_scale_inv", ".weight_scale")


def config_from_hf(cfg: Dict[str, Any], dtype=torch.bfloat16) -> LlamaConfig:
    """HF config.json dict → ``LlamaConfig`` (per-family quirks by
    ``model_type``), a ``MixtralConfig`` for Mixtral-style
    (``num_local_experts``) and Qwen2/3-MoE configs, a ``DeepseekConfig``
    for ``deepseek_v2`` / ``deepseek_v3``, a ``GlmMoeLiteConfig`` for
    ``glm4_moe_lite``, a ``Glm4MoeConfig`` for ``glm4_moe``, a
    ``GlmMoeDsaConfig`` for ``glm_moe_dsa`` (the indexer's defaults are
    DeepSeek-V3.2's: 64 heads of 128, top 2048, every layer its own), a
    ``Llama4Config`` for ``llama4_text``, a
    ``GptOssConfig`` for ``gpt_oss``, a ``Qwen3NextConfig`` for
    ``qwen3_next``, a ``Qwen35MoeConfig`` for ``qwen3_5_moe`` /
    ``qwen3_5``, a ``MiniMaxConfig`` for ``minimax`` and a
    ``Step35Config`` for ``step3p5``."""
    mt = cfg.get("model_type", "llama")
    # before the Qwen-MoE branch: these configs hold num_experts too
    if mt in _QWEN3NEXT_TYPES:
        return _qwen3next_config_from_hf(cfg, mt, dtype)
    if mt == "minimax":
        return _minimax_config_from_hf(cfg, dtype)
    if mt == "step3p5":
        return _step35_config_from_hf(cfg, dtype)
    if mt in ("deepseek_v2", "deepseek_v3"):
        return _deepseek_config_from_hf(cfg, mt, dtype)
    if mt == "glm4_moe_lite":
        # GLM-4.6-Lite: DeepSeek-V2 architecture, V3 routing defaults
        return _deepseek_config_from_hf(cfg, "deepseek_v3", dtype,
                                        cls=GlmMoeLiteConfig)
    if mt == "glm_moe_dsa":
        return _deepseek_config_from_hf(
            cfg, "deepseek_v3", dtype, cls=GlmMoeDsaConfig,
            extra=dict(index_n_heads=cfg.get("index_n_heads", 64),
                       index_head_dim=cfg.get("index_head_dim", 128),
                       index_topk=cfg.get("index_topk", 2048),
                       index_layers=tuple(cfg.get("index_layers") or ())))
    if mt == "glm4_moe":
        return _glm4moe_config_from_hf(cfg, dtype)
    if mt == "llama4_text":
        return _llama4_config_from_hf(cfg, dtype)
    if mt == "gpt_oss":
        return _gptoss_config_from_hf(cfg, dtype)
    gemma = mt.startswith("gemma")
    qpas = cfg.get("query_pre_attn_scalar")
    cls = LlamaConfig
    moe_kw: Dict[str, Any] = {}
    intermediate = cfg["intermediate_size"]
    if cfg.get("num_local_experts") or mt == "mixtral":
        cls = MixtralConfig
        moe_kw = dict(num_experts=cfg.get("num_local_experts", 8),
                      top_k=cfg.get("num_experts_per_tok", 2))
    elif mt in ("qwen2_moe", "qwen3_moe") or cfg.get("num_experts"):
        # Qwen2-MoE: routed experts at moe_intermediate_size + an
        # always-on sigmoid-gated shared expert.  Qwen3-MoE: the same
        # experts, no shared expert, per-head q/k RMSNorm.
        cls = MixtralConfig
        intermediate = cfg.get("moe_intermediate_size", intermediate)
        shared = cfg.get("shared_expert_intermediate_size", 0) or 0
        moe_kw = dict(
            num_experts=cfg.get("num_experts", 8),
            top_k=cfg.get("num_experts_per_tok", 2),
            shared_expert_intermediate=shared,
            shared_expert_gate=shared > 0,
            norm_topk_prob=cfg.get("norm_topk_prob", True))
    rs = cfg.get("rope_scaling") or {}
    return cls(
        **moe_kw,
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=intermediate,
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", gemma),
        attn_bias=cfg.get("attention_bias", mt in ("qwen2", "qwen2_moe")),
        qk_norm=mt in ("qwen3", "qwen3_moe", "gemma3_text"),
        norm_offset=1.0 if gemma else 0.0,
        # Gemma2 names the field hidden_activation; others hidden_act
        hidden_act=("gelu_tanh" if cfg.get(
            "hidden_activation", cfg.get("hidden_act", "silu"))
            in ("gelu_pytorch_tanh", "gelu_tanh") else "silu"),
        embed_scale=gemma,
        sandwich_norms=mt in ("gemma2", "gemma3_text"),
        attn_logit_softcap=cfg.get("attn_logit_softcapping") or 0.0,
        final_logit_softcap=cfg.get("final_logit_softcapping") or 0.0,
        attn_scale=(float(qpas) ** 0.5 if qpas else None),
        sliding_window=(cfg.get("sliding_window")
                        if mt in ("gemma2", "gemma3_text") else None),
        # Gemma3: a sliding pattern and dual rope (the local base
        # frequency on sliding layers, linear scaling on global ones)
        layer_types=(tuple(cfg["layer_types"])
                     if mt == "gemma3_text" and cfg.get("layer_types")
                     else None),
        rope_local_theta=(cfg.get("rope_local_base_freq", 0.0)
                          if mt == "gemma3_text" else 0.0),
        rope_scaling_factor=(rs.get("factor", 1.0)
                             if mt == "gemma3_text"
                             and rs.get("rope_type") == "linear" else 1.0),
        rope_llama3=_llama3_rope(cfg),
        dtype=dtype,
    )


def _llama3_rope(cfg: Dict[str, Any]):
    """HF rope_scaling rope_type 'llama3' → (factor, low, high, orig)
    (Llama-3.1+)."""
    rs = cfg.get("rope_scaling") or {}
    if rs.get("rope_type", rs.get("type")) != "llama3":
        return None
    return (rs.get("factor", 8.0), rs.get("low_freq_factor", 1.0),
            rs.get("high_freq_factor", 4.0),
            rs.get("original_max_position_embeddings", 8192))


def _llama4_config_from_hf(cfg: Dict[str, Any], dtype) -> Llama4Config:
    """Llama 4 text HF config → ``Llama4Config``: the chunk size rides on
    ``sliding_window`` with ``chunked_attention`` (the default), HF's
    ``chunked_attention`` layer type maps to ``sliding_attention``, and
    ``moe_layers`` defaults to every ``interleave_moe_layer_step``-th
    layer."""
    lt = cfg.get("layer_types")
    step = cfg.get("interleave_moe_layer_step", 1)
    return Llama4Config(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        intermediate_size_mlp=cfg.get("intermediate_size_mlp",
                                      cfg["intermediate_size"]),
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 500000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        attn_bias=cfg.get("attention_bias", False),
        num_experts=cfg.get("num_local_experts", 16),
        top_k=cfg.get("num_experts_per_tok", 1),
        moe_layers=tuple(cfg.get("moe_layers")
                         or range(step - 1, cfg["num_hidden_layers"], step)),
        no_rope_layers=tuple(cfg.get("no_rope_layers") or ()),
        sliding_window=cfg.get("attention_chunk_size", 8192),
        layer_types=(tuple("sliding_attention" if t == "chunked_attention"
                           else t for t in lt) if lt else None),
        use_qk_norm=cfg.get("use_qk_norm", True),
        attn_temperature_tuning=bool(cfg.get("attn_temperature_tuning",
                                             True)),
        floor_scale=cfg.get("floor_scale", 8192.0),
        temp_attn_scale=cfg.get("attn_scale", 0.1),
        rope_llama3=_llama3_rope(cfg),
        dtype=dtype,
    )


def _qwen3next_config_from_hf(cfg: Dict[str, Any], mt: str,
                              dtype) -> Qwen3NextConfig:
    """Qwen3-Next / Qwen3.5(-MoE) HF config → ``Qwen3NextConfig`` /
    ``Qwen35MoeConfig``: every norm zero-centred (offset 1), partial rotary
    (0.25 by default), the layer kinds from ``layer_types`` (the JAX loader
    reads no ``full_attention_interval``; a config without
    ``layer_types`` raises here, where the JAX loader fails later with an
    ``IndexError``), and ``decoder_sparse_step`` > 1 adds every layer
    whose (index + 1) it does not divide to ``mlp_only_layers``.
    Text-only positions collapse Qwen3.5's interleaved MRoPE to standard
    rope."""
    if not cfg.get("layer_types"):
        raise ValueError(
            f"model_type {mt!r}: config.json has no layer_types (the "
            f"linear_attention / full_attention kind of each layer)")
    cls = Qwen3NextConfig if mt == "qwen3_next" else Qwen35MoeConfig
    step = cfg.get("decoder_sparse_step", 1)
    mlp_only = set(cfg.get("mlp_only_layers") or ())
    if cfg.get("num_experts", 0) and step > 1:
        mlp_only |= {li for li in range(cfg["num_hidden_layers"])
                     if (li + 1) % step != 0}
    shared = cfg.get("shared_expert_intermediate_size", 0) or 0
    return cls(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        norm_offset=1.0,
        partial_rotary_factor=cfg.get("partial_rotary_factor", 0.25),
        layer_types=tuple(cfg["layer_types"]),
        linear_num_key_heads=cfg.get("linear_num_key_heads", 16),
        linear_num_value_heads=cfg.get("linear_num_value_heads", 32),
        linear_key_head_dim=cfg.get("linear_key_head_dim", 128),
        linear_value_head_dim=cfg.get("linear_value_head_dim", 128),
        linear_conv_kernel_dim=cfg.get("linear_conv_kernel_dim", 4),
        num_experts=cfg.get("num_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 2),
        shared_expert_intermediate=shared,
        shared_expert_gate=shared > 0,
        norm_topk_prob=cfg.get("norm_topk_prob", True),
        mlp_only_layers=tuple(sorted(mlp_only)),
        dtype=dtype,
    )


# MiniMaxDecoderLayer's residual scales (1.0 where the config has none)
_MINIMAX_FACTORS = ("full_attn_alpha_factor", "full_attn_beta_factor",
                    "linear_attn_alpha_factor", "linear_attn_beta_factor",
                    "mlp_alpha_factor", "mlp_beta_factor")


def _minimax_config_from_hf(cfg: Dict[str, Any], dtype) -> MiniMaxConfig:
    """MiniMax HF config → ``MiniMaxConfig``: the layer kinds from
    ``layer_types`` (a config without it raises here; the JAX loader then
    builds an all-full model, which fails later on a missing ``q_proj``),
    the scaled-residual factors, the router's top-k renormalized
    (``MiniMaxSparseMoeBlock``)."""
    if not cfg.get("layer_types"):
        raise ValueError(
            "model_type 'minimax': config.json has no layer_types (the "
            "linear_attention / full_attention kind of each layer)")
    return MiniMaxConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 1e7),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        num_experts=cfg.get("num_local_experts", 8),
        top_k=cfg.get("num_experts_per_tok", 2),
        norm_topk_prob=True,
        layer_types=tuple(cfg["layer_types"]),
        block_size=cfg.get("block_size", 256),
        **{f: cfg.get(f, 1.0) for f in _MINIMAX_FACTORS},
        dtype=dtype,
    )


def _step35_config_from_hf(cfg: Dict[str, Any], dtype) -> Step35Config:
    """Step-3.5 HF config → ``Step35Config``, as the JAX loader reads it:
    ``num_attention_groups`` KV heads, ``rope_theta`` a ``[theta,
    theta_local]`` pair (or one value), the MoE layers from the
    comma-separated ``moe_layers_enum``, each clamp the first nonzero
    entry of ``swiglu_limits`` / ``swiglu_limits_shared``, the sliding
    layers' head counts from ``attention_other_setting``, the (1 + w) norm
    and the rotated fractions 0.5 (full) / 1.0 (sliding) fixed;
    ``layer_types`` cut to ``num_hidden_layers`` (the MTP layers' entries
    dropped)."""
    other = cfg.get("attention_other_setting") or {}
    theta = cfg.get("rope_theta", 10000.0)
    theta_local = 0.0
    if isinstance(theta, list):
        theta, theta_local = float(theta[0]), float(theta[1])
    moe_layers: Tuple[int, ...] = ()
    enum = cfg.get("moe_layers_enum")
    if isinstance(enum, str) and enum.strip():
        moe_layers = tuple(sorted(int(i) for i in enum.strip().split(",")))
    limits = [v for v in (cfg.get("swiglu_limits") or []) if v]
    limits_sh = [v for v in (cfg.get("swiglu_limits_shared") or []) if v]
    n = cfg["num_hidden_layers"]
    return Step35Config(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=n,
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_attention_groups",
                             cfg.get("num_key_value_heads",
                                     cfg["num_attention_heads"])),
        head_dim=cfg.get("head_dim"),
        rope_theta=theta, rope_local_theta=theta_local,
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        norm_offset=1.0,
        partial_rotary_factor=0.5,
        partial_rotary_factor_local=1.0,
        sliding_window=cfg.get("sliding_window"),
        layer_types=tuple(cfg.get("layer_types") or ())[:n] or None,
        swa_num_heads=other.get("num_attention_heads", 0),
        swa_num_kv_heads=other.get("num_attention_groups", 0),
        moe_layers=moe_layers,
        moe_num_experts=cfg.get("moe_num_experts", 0),
        moe_top_k=cfg.get("moe_top_k", 1),
        moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
        share_expert_dim=cfg.get("share_expert_dim", 0),
        moe_router_scaling_factor=cfg.get("moe_router_scaling_factor", 1.0),
        norm_expert_weight=cfg.get("norm_expert_weight", True),
        use_moe_router_bias=cfg.get("use_moe_router_bias", False),
        swiglu_limit=float(limits[0]) if limits else 0.0,
        swiglu_limit_shared=float(limits_sh[0]) if limits_sh else 0.0,
        dtype=dtype,
    )


def _gptoss_config_from_hf(cfg: Dict[str, Any], dtype) -> GptOssConfig:
    """GPT-OSS HF config → ``GptOssConfig`` (YaRN from ``rope_scaling``;
    ``layer_types`` is not read: the even layers slide, as in the JAX
    loader)."""
    rs = cfg.get("rope_scaling") or {}
    return GptOssConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 150000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        attn_bias=cfg.get("attention_bias", True),
        sliding_window=cfg.get("sliding_window"),
        num_experts=cfg.get("num_local_experts", 32),
        top_k=cfg.get("num_experts_per_tok", 4),
        yarn_factor=(rs.get("factor", 0.0)
                     if rs.get("rope_type") == "yarn" else 0.0),
        yarn_beta_fast=rs.get("beta_fast", 32.0),
        yarn_beta_slow=rs.get("beta_slow", 1.0),
        yarn_original_max_pos=rs.get(
            "original_max_position_embeddings",
            cfg.get("max_position_embeddings", 4096)),
        yarn_truncate=rs.get("truncate", True),
        yarn_attention_factor=rs.get("attention_factor") or 0.0,
        dtype=dtype,
    )


def _glm4moe_config_from_hf(cfg: Dict[str, Any], dtype) -> Glm4MoeConfig:
    """GLM-4.5 HF config → ``Glm4MoeConfig``: GQA (``head_dim``, biases,
    ``use_qk_norm``, ``partial_rotary_factor`` 0.5 by default) and the
    DeepSeek-V3 router (sigmoid, group limiting)."""
    return Glm4MoeConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        attn_bias=cfg.get("attention_bias", False),
        qk_norm=cfg.get("use_qk_norm", False),
        partial_rotary_factor=cfg.get("partial_rotary_factor", 0.5),
        n_routed_experts=cfg.get("n_routed_experts") or 0,
        num_experts_per_tok=cfg.get("num_experts_per_tok", 8),
        moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
        n_shared_experts=cfg.get("n_shared_experts") or 0,
        first_k_dense=cfg.get("first_k_dense_replace", 1),
        routed_scaling_factor=cfg.get("routed_scaling_factor", 1.0),
        scoring_func="sigmoid",
        n_group=cfg.get("n_group", 1),
        topk_group=cfg.get("topk_group", 1),
        norm_topk_prob=cfg.get("norm_topk_prob", True),
        dtype=dtype,
    )


def _deepseek_config_from_hf(cfg: Dict[str, Any], mt: str, dtype,
                             cls=DeepseekConfig,
                             extra: Optional[Dict[str, Any]] = None
                             ) -> DeepseekConfig:
    """DeepSeek V2 / V3 (MLA + DeepSeek-MoE) HF config → ``cls``.  V3
    routers score with sigmoid and the aux-free bias and group by the top-2
    sum (``noaux_tc``); V2 with softmax (``greedy`` /
    ``group_limited_greedy``).  Yarn's ``mscale_all_dim`` folds into the
    score scale (``mscale``), its frequency interpolation into the yarn
    fields (``deepseek.rope_tables``).  ``extra`` holds a subclass's own
    fields (GLM-5's indexer)."""
    v3 = mt == "deepseek_v3"
    rs = cfg.get("rope_scaling") or {}
    is_yarn = rs.get("rope_type", rs.get("type")) == "yarn"
    mscale = 1.0
    if rs.get("mscale_all_dim") and rs.get("factor", 1.0) > 1.0:
        mscale = 0.1 * rs["mscale_all_dim"] * float(
            np.log(rs["factor"])) + 1.0
    topk_method = cfg.get("topk_method", "noaux_tc" if v3 else "greedy")
    grouped = topk_method in ("noaux_tc", "group_limited_greedy")
    return cls(
        **(extra or {}),
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        q_lora_rank=cfg.get("q_lora_rank") or 0,
        kv_lora_rank=cfg.get("kv_lora_rank", 512),
        qk_nope_head_dim=cfg.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=cfg.get("qk_rope_head_dim", 64),
        v_head_dim=cfg.get("v_head_dim", 128),
        # V2's complex-pair rope is score-equivalent to the interleaved
        # permutation (q and k share it)
        rope_interleave=cfg.get("rope_interleave", True),
        mscale=mscale,
        yarn_factor=rs.get("factor", 0.0) if is_yarn else 0.0,
        yarn_beta_fast=rs.get("beta_fast", 32.0),
        yarn_beta_slow=rs.get("beta_slow", 1.0),
        yarn_original_max_pos=rs.get("original_max_position_embeddings",
                                     4096),
        yarn_mscale=rs.get("mscale", 1.0),
        yarn_mscale_all_dim=rs.get("mscale_all_dim", 0.0),
        n_routed_experts=cfg.get("n_routed_experts") or 0,
        num_experts_per_tok=cfg.get("num_experts_per_tok", 6),
        moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
        n_shared_experts=cfg.get("n_shared_experts") or 0,
        first_k_dense=cfg.get("first_k_dense_replace", 1),
        routed_scaling_factor=cfg.get("routed_scaling_factor", 1.0),
        scoring_func=cfg.get("scoring_func", "sigmoid" if v3 else "softmax"),
        n_group=cfg.get("n_group", 1) if grouped else 1,
        topk_group=cfg.get("topk_group", 1) if grouped else 1,
        norm_topk_prob=cfg.get("norm_topk_prob", v3),
        dtype=dtype,
    )


def shard_files(path: str) -> List[str]:
    """The safetensors files of a checkpoint directory: the shards named
    by ``model.safetensors.index.json`` (sorted), else
    ``model.safetensors``."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    return ["model.safetensors"]


def _iter_shards(path: str, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (key, tensor on ``device``) over every shard, one tensor at a
    time.  An FP8-source checkpoint (DeepSeek-V3 / R1: e4m3 / e5m2 weights
    with a ``weight_scale_inv`` or ``weight_scale``) is dequantized on the
    device as it streams, so it enters the whole pipeline: every scale
    tensor is read first (a weight and its scale may sit in different
    shards) and none is yielded; an FP8 weight comes out in fp32 times its
    scale (a 2-D weight by its grid or number, any other by a single
    number, as the JAX loader does), every other tensor as stored."""
    from ..quantize.model_free import _dequant_fp8_source
    files = [os.path.join(path, s) for s in shard_files(path)]
    scales: Dict[str, torch.Tensor] = {}
    for sp in files:
        with SafeOpen(sp, device=device) as f:
            for key in f.keys():
                if key.endswith(_FP8_SCALES):
                    scales[key] = f.get_tensor(key)
    for sp in files:
        with SafeOpen(sp, device=device) as f:
            for key in f.keys():
                if key in scales:
                    continue
                t = f.get_tensor(key)
                if f.dtype_code(key) in ("F8_E4M3", "F8_E5M2"):
                    t = t.float()
                    base = key[:-len(".weight")] if key.endswith(
                        ".weight") else key
                    s = scales.get(base + ".weight_scale_inv",
                                   scales.get(base + ".weight_scale"))
                    if t.ndim == 2:
                        t = _dequant_fp8_source(t, s)
                    elif s is not None and s.ndim <= 1 and s.numel() == 1:
                        t = t * float(s.float().reshape(()))
                yield key, t


def _map_key(sub: str, block: Dict[str, Any], arr: torch.Tensor,
             cfg: LlamaConfig) -> bool:
    """Put one ``model.layers.<i>.<sub>`` tensor into its block; False
    when the key has no place in the port's tree."""
    if sub in _BLOCK_MAP:
        block[_BLOCK_MAP[sub]] = arr
        return True
    # Mixtral: block_sparse_moe.gate → router, experts.E.w{1,2,3}
    if sub == "block_sparse_moe.gate.weight":
        block["router"] = arr
        return True
    if sub.startswith("block_sparse_moe.experts."):
        parts = sub.split(".")
        if parts[3] in ("w1", "w2", "w3"):
            block["experts"][int(parts[2])][parts[3]] = arr
            return True
        return False
    # Phi-3 fused projections, split on load so each quantizes alone
    if sub == "self_attn.qkv_proj.weight":
        qd = cfg.num_heads * cfg.hd
        kvd = cfg.num_kv_heads * cfg.hd
        block["q_proj"] = arr[:qd]
        block["k_proj"] = arr[qd: qd + kvd]
        block["v_proj"] = arr[qd + kvd:]
        return True
    if sub == "mlp.gate_up_proj.weight":
        half = arr.shape[0] // 2
        block["gate_proj"] = arr[:half]
        block["up_proj"] = arr[half:]
        return True
    # Qwen2/3-MoE: mlp.gate → router, experts' gate/up/down → w1/w3/w2,
    # the shared expert and its gate
    qmap = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
    if sub == "mlp.gate.weight":
        block["router"] = arr
        return True
    if sub.startswith("mlp.experts."):
        parts = sub.split(".")
        wname = qmap.get(parts[3]) if len(parts) > 3 else None
        if wname:
            block["experts"][int(parts[2])][wname] = arr
            return True
        return False
    if sub.startswith("mlp.shared_expert."):
        wname = qmap.get(sub.split(".")[2])
        if wname:
            block.setdefault("shared_expert", {})[wname] = arr
            return True
        return False
    if sub == "mlp.shared_expert_gate.weight":
        block["shared_expert_gate"] = arr
        return True
    return False


_DS_MAP = {
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.q_a_proj.weight": "q_a_proj",
    "self_attn.q_a_layernorm.weight": "q_a_layernorm",
    "self_attn.q_b_proj.weight": "q_b_proj",
    "self_attn.kv_a_proj_with_mqa.weight": "kv_a_proj_with_mqa",
    "self_attn.kv_a_layernorm.weight": "kv_a_layernorm",
    "self_attn.kv_b_proj.weight": "kv_b_proj",
    "self_attn.o_proj.weight": "o_proj",
    "input_layernorm.weight": "input_layernorm",
    "post_attention_layernorm.weight": "post_attention_layernorm",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
    "mlp.gate.weight": "gate",
    "mlp.gate.e_score_correction_bias": "e_score_correction_bias",
}
_DS_MLP = ("gate_proj", "up_proj", "down_proj")


_INDEXER = ("q_proj", "k_proj", "weights_proj")


def _map_deepseek_key(sub: str, block: Dict[str, Any],
                      arr: torch.Tensor) -> bool:
    """Put one DeepSeek ``model.layers.<i>.<sub>`` tensor into its block
    (routed experts into a dict by index, made a list after the load; the
    lightning indexer's q / k / weights into ``indexer``); then GLM-4.5's
    Llama-style keys (k / v projections, biases, q / k norms), as the JAX
    loader falls through to them.  False when the key has no place in the
    port's tree."""
    if sub in _DS_MAP:
        block[_DS_MAP[sub]] = arr
        return True
    if sub.startswith("self_attn.indexer."):
        wname = sub[len("self_attn.indexer."):].rsplit(".weight", 1)[0]
        if wname in _INDEXER:
            block.setdefault("indexer", {})[wname] = arr
            return True
        return False
    if sub in _BLOCK_MAP:
        block[_BLOCK_MAP[sub]] = arr
        return True
    for prefix in ("mlp.experts.", "mlp.shared_experts."):
        if not sub.startswith(prefix):
            continue
        rest = sub[len(prefix):]
        if prefix == "mlp.experts.":
            e, rest = rest.split(".", 1)
            tgt = block.setdefault("experts", {}).setdefault(int(e), {})
        else:
            tgt = block.setdefault("shared_experts", {})
        wname = rest.rsplit(".weight", 1)[0]
        if wname in _DS_MLP:
            tgt[wname] = arr
            return True
    return False


def _map_llama4_key(sub: str, block: Dict[str, Any], arr: torch.Tensor,
                    n_experts: int) -> bool:
    """Llama 4 ``feed_forward`` keys; the fused expert tensors split into
    per-expert (O, I) leaves (``gate_up_proj`` (E, H, 2I) in gate / up
    halves, ``down_proj`` (E, I, H): HF ``Llama4TextExperts``)."""
    simple = {"feed_forward.gate_proj.weight": "gate_proj",
              "feed_forward.up_proj.weight": "up_proj",
              "feed_forward.down_proj.weight": "down_proj",
              "feed_forward.router.weight": "router"}
    if sub in simple:
        block[simple[sub]] = arr
        return True
    if sub.startswith("feed_forward.shared_expert."):
        wname = sub.split(".")[2]
        if wname in ("gate_proj", "up_proj", "down_proj"):
            block.setdefault("shared_expert", {})[wname] = arr
            return True
        return False
    if not sub.startswith("feed_forward.experts."):
        return False
    exps = block.setdefault("experts", [dict() for _ in range(n_experts)])
    name = sub[len("feed_forward.experts."):]
    if name == "gate_up_proj":                 # (E, H, 2I) in halves
        I = arr.shape[2] // 2
        for e in range(n_experts):
            exps[e]["gate_proj"] = arr[e, :, :I].t().contiguous()
            exps[e]["up_proj"] = arr[e, :, I:].t().contiguous()
    elif name == "down_proj":                  # (E, I, H)
        for e in range(n_experts):
            exps[e]["down_proj"] = arr[e].t().contiguous()
    else:
        return False
    return True


def _map_gptoss_key(sub: str, block: Dict[str, Any], arr: torch.Tensor,
                    n_experts: int) -> bool:
    """GPT-OSS's own keys: the sinks, the router and its bias, o_proj's
    bias, and the fused experts split into per-expert leaves
    (``gate_up_proj`` (E, H, 2I) with gate / up columns interleaved, gate
    even and up odd, HF ``GptOssExperts``; their biases likewise)."""
    simple = {"self_attn.sinks": "sinks",
              "mlp.router.weight": "router",
              "mlp.router.bias": "router_bias",
              "self_attn.o_proj.bias": "o_bias"}
    if sub in simple:
        block[simple[sub]] = arr
        return True
    if not sub.startswith("mlp.experts."):
        return False
    exps = block.setdefault("experts", [dict() for _ in range(n_experts)])
    name = sub[len("mlp.experts."):]
    if name == "gate_up_proj":                 # (E, H, 2I)
        for e in range(n_experts):
            exps[e]["gate_proj"] = arr[e, :, 0::2].t().contiguous()
            exps[e]["up_proj"] = arr[e, :, 1::2].t().contiguous()
    elif name == "gate_up_proj_bias":          # (E, 2I)
        for e in range(n_experts):
            exps[e]["gate_bias"] = arr[e, 0::2].contiguous()
            exps[e]["up_bias"] = arr[e, 1::2].contiguous()
    elif name == "down_proj":                  # (E, I, H)
        for e in range(n_experts):
            exps[e]["down_proj"] = arr[e].t().contiguous()
    elif name == "down_proj_bias":             # (E, H)
        for e in range(n_experts):
            exps[e]["down_bias"] = arr[e].clone()
    else:
        return False
    return True


_Q3N_MAP = {"linear_attn.in_proj_qkvz.weight": "in_proj_qkvz",
            "linear_attn.in_proj_ba.weight": "in_proj_ba",
            "linear_attn.out_proj.weight": "out_proj",
            "linear_attn.norm.weight": "linear_norm",
            "linear_attn.dt_bias": "dt_bias",
            "linear_attn.A_log": "A_log"}


def _map_qwen3next_key(sub: str, block: Dict[str, Any], arr: torch.Tensor,
                       n_experts: int) -> bool:
    """Qwen3-Next's own keys: the DeltaNet's ``linear_attn.*`` (the
    depthwise conv (conv_dim, 1, K) → (conv_dim, K)) and Qwen3.5's fused
    expert stacks (``gate_up_proj`` (E, 2I, H): w1 the first half, w3 the
    second; ``down_proj`` (E, H, I) → w2).  Everything else is
    :func:`_map_key`'s."""
    if sub in _Q3N_MAP:
        block[_Q3N_MAP[sub]] = arr
        return True
    if sub == "linear_attn.conv1d.weight":
        block["conv1d"] = arr[:, 0, :].contiguous()
        return True
    if sub in ("mlp.experts.gate_up_proj", "mlp.experts.down_proj") \
            and arr.ndim == 3:
        exps = block["experts"]
        if sub.endswith("gate_up_proj"):
            half = arr.shape[1] // 2
            for e in range(arr.shape[0]):
                exps[e]["w1"] = arr[e, :half]
                exps[e]["w3"] = arr[e, half:]
        else:
            for e in range(arr.shape[0]):
                exps[e]["w2"] = arr[e]
        return True
    return False


_MINIMAX_MAP = {"self_attn.qkv_proj.weight": "qkv_proj",
                "self_attn.out_proj.weight": "out_proj",
                "self_attn.output_gate.weight": "output_gate",
                "self_attn.norm.weight": "attn_norm"}
_MINIMAX_DECAYS = ("slope_rate", "query_decay", "key_decay",
                   "diagonal_decay")


def _map_minimax_key(sub: str, block: Dict[str, Any], arr: torch.Tensor,
                     n_experts: int) -> bool:
    """MiniMax's lightning keys (``qkv_proj`` fused); its decay buffers
    are taken and dropped (``slope_rate`` is computed after the load).
    Everything else is :func:`_map_key`'s."""
    if sub in _MINIMAX_MAP:
        block[_MINIMAX_MAP[sub]] = arr
        return True
    return sub.startswith("self_attn.") and sub.endswith(_MINIMAX_DECAYS)


# the fp32 leaves of each family (loaded in fp32 whatever ``dtype``)
_FP32_KEYS = (".e_score_correction_bias", ".self_attn.sinks",
              ".mlp.router.bias", ".linear_attn.dt_bias",
              ".linear_attn.A_log")


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device=None
                       ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """Load a local HF checkpoint directory (``config.json`` and
    safetensors) → (params on ``device`` in ``dtype``, config).
    ``device=None`` means the CUDA card and raises without one."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, dtype)
    if isinstance(cfg, Step35Config):
        raise NotImplementedError(
            f"{path}: the weights of a step3p5 (Step-3.5) checkpoint are not "
            f"read: the JAX loader maps none of its own leaves (it drops "
            f"g_proj and the moe.* / share_expert.* tensors, and stops at "
            f"the first MTP layer), so no reference tree exists; its config "
            f"reads through config_from_hf")
    deepseek = isinstance(cfg, DeepseekConfig)
    q3n = isinstance(cfg, Qwen3NextConfig)
    mm = isinstance(cfg, MiniMaxConfig)
    family_map = (_map_gptoss_key if isinstance(cfg, GptOssConfig)
                  else _map_llama4_key if isinstance(cfg, Llama4Config)
                  else _map_qwen3next_key if q3n
                  else _map_minimax_key if mm else None)
    n_experts = getattr(cfg, "num_experts", 0)
    blocks = [({"experts": [dict() for _ in range(n_experts)]}
               if n_experts else dict()) for _ in range(cfg.num_layers)]
    params: Dict[str, Any] = {"blocks": blocks}
    n = 0
    for key, tensor in _iter_shards(path, dev):
        # DeepSeek's aux-free bias, GPT-OSS's sinks and router bias,
        # Qwen3-Next's dt_bias and A_log stay fp32, as in the JAX package
        arr = tensor.to(torch.float32 if key.endswith(_FP32_KEYS)
                        else dtype)
        del tensor
        if key in _TOP_MAP:
            params[_TOP_MAP[key]] = arr
            n += 1
            continue
        if key.startswith("model.layers."):
            li, sub = key[len("model.layers."):].split(".", 1)
            if int(li) >= cfg.num_layers:
                raise ValueError(
                    f"{key}: layer {li} is past num_hidden_layers = "
                    f"{cfg.num_layers} (a draft layer, "
                    f"num_nextn_predict_layers = "
                    f"{hf_cfg.get('num_nextn_predict_layers', 0)}); neither "
                    f"package loads it: drop its tensors from the "
                    f"checkpoint (ROADMAP C)")
            block = blocks[int(li)]
            mapped = (_map_deepseek_key(sub, block, arr) if deepseek else
                      (family_map is not None
                       and family_map(sub, block, arr, n_experts))
                      or _map_key(sub, block, arr, cfg))
            if mapped:
                n += 1
                continue
        logger.debug("skipping unmapped tensor %s", key)
    if cfg.tie_embeddings:
        params.pop("lm_head", None)
    for b in blocks:
        if isinstance(b.get("experts"), dict):  # DeepSeek's, by index
            b["experts"] = [b["experts"][e] for e in sorted(b["experts"])]
        elif (isinstance(cfg, (Llama4Config, Qwen3NextConfig))
              and not any(b.get("experts", ()))):
            b.pop("experts", None)      # a dense layer's empty expert list
    if isinstance(cfg, GlmMoeDsaConfig):
        # a shared-indexer layer carries a copy of its governing layer's
        # indexer, so block-wise calibration stays self-contained
        governing = None
        for b in blocks:
            if "indexer" in b:
                governing = b["indexer"]
            elif governing is not None:
                b["indexer"] = dict(governing)
    if mm:
        for li, b in enumerate(blocks):
            if layer_is_linear(cfg, li):
                b["slope_rate"] = slope_rate(cfg, li).to(dev)
    q_key = ("q_a_proj" if deepseek and cfg.q_lora_rank else "q_proj")
    missing = [i for i, b in enumerate(blocks)
               if q_key not in b and not (q3n and "in_proj_qkvz" in b)
               and not (mm and "qkv_proj" in b)]
    if missing:
        raise ValueError(f"blocks missing attention weights: {missing}")
    logger.info("loaded %d tensors from %s", n, path)
    return params, cfg


def save_hf_checkpoint(params: Dict[str, Any], cfg: LlamaConfig, path: str,
                       hf_extra: Optional[Dict[str, Any]] = None) -> str:
    """Write params as an HF-layout single-file safetensors checkpoint
    (tensors on any device; each crosses to the host alone while the file
    is written).  A DeepSeek config writes ``deepseek_v3`` (sigmoid
    routing) or ``deepseek_v2`` keys and config, a ``Glm4MoeConfig``
    ``glm4_moe`` (its q / k / v biases and norms among the keys, the GQA
    fields in the config); ``hf_extra`` overrides
    config fields (``{"model_type": "glm4_moe_lite"}`` for GLM-4.6-Lite)."""
    if isinstance(cfg, (GptOssConfig, Llama4Config, Qwen3NextConfig,
                        GlmMoeDsaConfig, MiniMaxConfig, Ernie45Config,
                        LongcatConfig, Step35Config)):
        raise NotImplementedError(
            f"save_hf_checkpoint: no HF writer for {type(cfg).__name__} (the "
            f"JAX package has none either: its writer drops the sinks, the "
            f"biases, the DeltaNet leaves, GLM-5's indexer and MiniMax's "
            f"lightning leaves, fuses nothing and names GLM-5 deepseek_v3 "
            f"and MiniMax mixtral; ERNIE-4.5, LongCat and Step-3.5 have no "
            f"HF layout in either package)")
    os.makedirs(path, exist_ok=True)
    if isinstance(cfg, DeepseekConfig):
        return _save_deepseek_checkpoint(params, cfg, path, hf_extra)
    inv_block = {v: k for k, v in _BLOCK_MAP.items()}
    qwen_moe = bool(getattr(cfg, "shared_expert_intermediate", 0))
    inv_q = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}
    tensors: Dict[str, torch.Tensor] = {}
    for hf_key, ours in _TOP_MAP.items():
        if params.get(ours) is not None:
            tensors[hf_key] = params[ours]
    for li, block in enumerate(params["blocks"]):
        pre = f"model.layers.{li}."
        for ours, arr in block.items():
            if ours in inv_block:
                tensors[pre + inv_block[ours]] = arr
            elif ours == "router":
                key = ("mlp.gate.weight" if qwen_moe
                       else "block_sparse_moe.gate.weight")
                tensors[pre + key] = arr
            elif ours == "experts":
                for e, ew in enumerate(arr):
                    for wn, wv in ew.items():
                        key = (f"mlp.experts.{e}.{inv_q[wn]}.weight"
                               if qwen_moe else
                               f"block_sparse_moe.experts.{e}.{wn}.weight")
                        tensors[pre + key] = wv
            elif ours == "shared_expert":
                for wn, wv in arr.items():
                    tensors[f"{pre}mlp.shared_expert.{inv_q[wn]}.weight"] \
                        = wv
            elif ours == "shared_expert_gate":
                tensors[f"{pre}mlp.shared_expert_gate.weight"] = arr
    save_file(tensors, os.path.join(path, "model.safetensors"))

    n_experts = getattr(cfg, "num_experts", 0)
    hf_cfg = {
        "model_type": ("qwen2_moe" if qwen_moe else "mixtral" if n_experts
                       else "qwen2" if cfg.attn_bias else "llama"),
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": cfg.attn_bias,
        "torch_dtype": "bfloat16",
    }
    if qwen_moe:
        hf_cfg["num_experts"] = n_experts
        hf_cfg["num_experts_per_tok"] = getattr(cfg, "top_k", 2)
        hf_cfg["moe_intermediate_size"] = cfg.intermediate_size
        hf_cfg["shared_expert_intermediate_size"] = \
            cfg.shared_expert_intermediate
        hf_cfg["norm_topk_prob"] = cfg.norm_topk_prob
    elif n_experts:
        hf_cfg["num_local_experts"] = n_experts
        hf_cfg["num_experts_per_tok"] = getattr(cfg, "top_k", 2)
    if hf_extra:
        hf_cfg.update(hf_extra)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return path


def _save_deepseek_checkpoint(params: Dict[str, Any], cfg: DeepseekConfig,
                              path: str,
                              hf_extra: Optional[Dict[str, Any]] = None
                              ) -> str:
    """The DeepSeek writer: the JAX package's keys, their order and its
    ``config.json`` (``glm4_moe`` for GLM-4.5, ``deepseek_v3`` for sigmoid
    routing, else ``deepseek_v2``)."""
    inv = {v: k for k, v in _DS_MAP.items()}
    # GLM-4.5's blocks hold Llama-style leaves too (q / k / v biases, norms)
    inv.update({v: k for k, v in _BLOCK_MAP.items() if v not in inv})
    tensors: Dict[str, torch.Tensor] = {}
    for hf_key, ours in _TOP_MAP.items():
        if params.get(ours) is not None:
            tensors[hf_key] = params[ours]
    for li, block in enumerate(params["blocks"]):
        pre = f"model.layers.{li}."
        for ours, arr in block.items():
            if ours in inv:
                tensors[pre + inv[ours]] = arr
            elif ours == "experts":
                for e, ew in enumerate(arr):
                    for wn, wv in ew.items():
                        tensors[f"{pre}mlp.experts.{e}.{wn}.weight"] = wv
            elif ours == "shared_experts":
                for wn, wv in arr.items():
                    tensors[f"{pre}mlp.shared_experts.{wn}.weight"] = wv
    save_file(tensors, os.path.join(path, "model.safetensors"))
    glm = isinstance(cfg, Glm4MoeConfig)
    v3 = cfg.scoring_func == "sigmoid"
    hf_cfg = {
        "model_type": ("glm4_moe" if glm
                       else "deepseek_v3" if v3 else "deepseek_v2"),
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "moe_intermediate_size": cfg.moe_intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "q_lora_rank": cfg.q_lora_rank or None,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim,
        "n_routed_experts": cfg.n_routed_experts or None,
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "n_shared_experts": cfg.n_shared_experts or None,
        "first_k_dense_replace": cfg.first_k_dense,
        "routed_scaling_factor": cfg.routed_scaling_factor,
        "scoring_func": cfg.scoring_func,
        "n_group": cfg.n_group,
        "topk_group": cfg.topk_group,
        "norm_topk_prob": cfg.norm_topk_prob,
        "topk_method": "noaux_tc" if v3 else (
            "group_limited_greedy" if cfg.n_group > 1 else "greedy"),
        "torch_dtype": "bfloat16",
    }
    if glm:
        hf_cfg.update(
            head_dim=cfg.head_dim, attention_bias=cfg.attn_bias,
            use_qk_norm=cfg.qk_norm,
            partial_rotary_factor=cfg.partial_rotary_factor)
        for k in ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
                  "qk_rope_head_dim", "v_head_dim", "topk_method",
                  "scoring_func"):
            hf_cfg.pop(k, None)
    elif v3:
        hf_cfg["rope_interleave"] = cfg.rope_interleave
    if hf_extra:
        hf_cfg.update(hf_extra)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return path
