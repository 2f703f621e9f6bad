"""GLM-4.5 / GLM-4.5-Air and GLM-4.6-Lite in PyTorch (counterpart of
``autoround_tpu/models/glm4moe.py``).

* **GLM-4.5** (``Glm4MoeConfig``, HF ``Glm4MoeForCausalLM``, ``model_type``
  ``glm4_moe``): plain GQA attention with q/k/v biases, per-head q/k
  RMSNorm, then rope on the leading ``partial_rotary_factor · hd`` dims of
  each head (the tables of ``llama.rope_tables`` are that wide), and the
  DeepSeek-V3 router and MoE (sigmoid scores, the aux-free bias, group
  limiting, ``routed_scaling_factor``, the shared experts, ``first_k_dense``
  dense blocks), reused from :mod:`.deepseek`.  ``kv_lora_rank = 0`` keeps
  it off the MLA paths: the serving engine caches its K / V as a Llama's
  and decodes them through the int8-KV kernel (GLM-4.5-Air: G = 12 query
  heads a KV head).
* **GLM-4.6-Lite** (``GlmMoeLiteConfig``, ``glm4_moe_lite``): a DeepSeek-V2
  architecture, MLA and DeepSeek-MoE; everything runs through
  :mod:`.deepseek` and this subclass is the registry's and the loader's
  marker.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import llama
from .deepseek import DeepseekConfig, _mlp, _moe_mlp
from .llama import rms_norm

__all__ = ["Glm4MoeConfig", "GlmMoeLiteConfig", "CONFIG_PRESETS",
           "init_params", "block_fwd", "model_fwd", "block_linear_names"]


@dataclass(frozen=True)
class Glm4MoeConfig(DeepseekConfig):
    # no MLA: plain GQA projections (kv_lora_rank = 0 is what the registry
    # and the serving engine dispatch on)
    kv_lora_rank: int = 0
    partial_rotary_factor: float = 0.5


@dataclass(frozen=True)
class GlmMoeLiteConfig(DeepseekConfig):
    """GLM-4.6-Lite: a DeepSeek-V2 architecture (the JAX package's
    subclass adds no field)."""


CONFIG_PRESETS: Dict[str, DeepseekConfig] = {
    "tiny-glmlite": GlmMoeLiteConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=4, rope_theta=10000.0,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        n_shared_experts=1, first_k_dense=1, routed_scaling_factor=1.8,
        scoring_func="sigmoid", n_group=2, topk_group=1,
        norm_topk_prob=True, dtype=torch.float32),
    "tiny-glm4moe": Glm4MoeConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, qk_norm=True, attn_bias=True,
        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        n_shared_experts=1, first_k_dense=1, routed_scaling_factor=1.0,
        scoring_func="sigmoid", n_group=2, topk_group=1,
        norm_topk_prob=True, dtype=torch.float32),
    "glm-4.5-air": Glm4MoeConfig(
        vocab_size=151552, hidden_size=4096, intermediate_size=10944,
        num_layers=46, num_heads=96, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, rms_eps=1e-5, qk_norm=True, attn_bias=True,
        n_routed_experts=128, num_experts_per_tok=8,
        moe_intermediate_size=1408, n_shared_experts=1, first_k_dense=1,
        routed_scaling_factor=1.0, scoring_func="sigmoid",
        norm_topk_prob=True),
}

_MLP = ("gate_proj", "up_proj", "down_proj")


def block_linear_names(cfg: Glm4MoeConfig) -> Tuple[str, ...]:
    """Union of the quantizable linear names over the blocks (the dense
    first-k blocks lack the expert leaves; the API prunes the plan per
    block)."""
    names = ("q_proj", "k_proj", "v_proj", "o_proj") + _MLP
    if cfg.n_routed_experts:
        names += tuple(f"experts.{e}.{w}"
                       for e in range(cfg.n_routed_experts) for w in _MLP)
        if cfg.n_shared_experts:
            names += tuple(f"shared_experts.{w}" for w in _MLP)
    return names


def init_params(cfg: Glm4MoeConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree and scales (biases at
    zero, norm gains at one, the fp32 ``e_score_correction_bias`` at zero);
    the numbers differ (another generator).  ``park(block)``, when given,
    takes each block as it is made and returns what the tree holds (see
    ``llama.init_params``)."""
    dev = resolve_device(device)
    H, hd = cfg.hidden_size, cfg.hd
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(std)

    def full(n, value):
        return torch.full((n,), value, dtype=cfg.dtype, device=dev)

    def mlp(width):
        return {"gate_proj": normal((width, H)), "up_proj": normal((width, H)),
                "down_proj": normal((H, width), down_std)}

    blocks = []
    for li in range(cfg.num_layers):
        b: Dict[str, Any] = {
            "q_proj": normal((qd, H)), "k_proj": normal((kvd, H)),
            "v_proj": normal((kvd, H)), "o_proj": normal((H, qd), down_std),
            "input_layernorm": full(H, 1.0),
            "post_attention_layernorm": full(H, 1.0),
        }
        if cfg.attn_bias:
            b["q_bias"] = full(qd, 0.0)
            b["k_bias"] = full(kvd, 0.0)
            b["v_bias"] = full(kvd, 0.0)
        if cfg.qk_norm:
            b["q_norm"] = full(hd, 1.0)
            b["k_norm"] = full(hd, 1.0)
        if cfg.layer_is_moe(li):
            mi = cfg.moe_intermediate_size
            b["gate"] = normal((cfg.n_routed_experts, H))
            b["e_score_correction_bias"] = torch.zeros(
                (cfg.n_routed_experts,), dtype=torch.float32, device=dev)
            b["experts"] = [mlp(mi) for _ in range(cfg.n_routed_experts)]
            if cfg.n_shared_experts:
                b["shared_experts"] = mlp(mi * cfg.n_shared_experts)
        else:
            b.update(mlp(cfg.intermediate_size))
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": full(H, 1.0), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: Glm4MoeConfig, mask=None,
              linear_fn=None) -> torch.Tensor:
    """One decoder block: pre-norm GQA attention (biased q/k/v, per-head
    q/k norm, then partial rope: ``cos`` / ``sin`` are rd wide) + pre-norm
    dense MLP or DeepSeek-routed experts (dense-then-mask)."""
    lf = linear_fn or llama._plain_linear
    B, S, H = x.shape
    hd = cfg.hd
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    q = lf("q_proj", h, weights["q_proj"], weights.get("q_bias"))
    k = lf("k_proj", h, weights["k_proj"], weights.get("k_bias"))
    v = lf("v_proj", h, weights["v_proj"], weights.get("v_bias"))
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, weights["q_norm"], cfg.rms_eps)
        k = rms_norm(k, weights["k_norm"], cfg.rms_eps)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)
    attn = llama.attention(q, k, v, mask, cfg)
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    if "experts" in weights:
        return x + _moe_mlp(weights, h, cfg, lf)
    return x + _mlp(weights, h, cfg, lf)


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: Glm4MoeConfig) -> torch.Tensor:
    """Full forward → logits."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = llama.rope_tables(cfg, input_ids.shape[1], device=x.device)
    for b in params["blocks"]:
        x = block_fwd(b, x, cos, sin, cfg)
    return llama.final_fwd(params, x, cfg)
