"""ERNIE-4.5 MoE decoder in PyTorch (counterpart of
``autoround_tpu/models/ernie45.py``, HF ``Ernie4_5_MoeForCausalLM``).

What sets it apart from the other MoE families:

* **Interleaved rope**: the rotated pairs are ``(x[2i], x[2i+1])``, both
  at frequency i (HF ``Ernie4_5_Moe.rotate_half``), not Llama's halves.
  The tables are ``llama.rope_tables``' own; their leading half holds the
  pair angles.
* **The router**: fp32 logits (through ``lf("router", ...)``, so a hook on
  the linear interceptor sees it as the JAX package's does), a softmax over
  every expert; the top-k *selects* on ``probs + e_score_correction_bias``
  (fp32, the "moe statics" bias) but *combines* the original probs at the
  selected experts, over their sum clamped below at ``moe_norm_min``.  The
  top-k is a stable sort, the lower index first on a tie, as
  ``jax.lax.top_k`` (``deepseek._top_k``).
* **MoE by interval**: layer ``li`` is MoE when ``(li + 1) %
  moe_layer_interval == 0`` and ``moe_layer_start_index <= li <=
  moe_layer_end_index``; the others have a dense SwiGLU MLP (their blocks
  lack the expert leaves; the API prunes the plan per block).
* Always-on shared experts, ``moe_num_shared_experts *
  moe_intermediate_size`` wide, added after the routed ones; optional q /
  k / v biases (``use_bias``).

Experts run dense-then-mask (every expert on every token, the top-k weight
gating the fp32 sum in expert order), the JAX package's only route.  The
JAX engine serves no ERNIE model, so the port's does not either
(``serve.engine`` refuses the class by name).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from . import llama
from .deepseek import _top_k
from .llama import LlamaConfig, rms_norm

__all__ = ["Ernie45Config", "CONFIG_PRESETS", "init_params", "block_fwd",
           "model_fwd", "block_linear_names", "layer_is_moe"]

_MLP = ("gate_proj", "up_proj", "down_proj")


@dataclass(frozen=True)
class Ernie45Config(LlamaConfig):
    moe_num_experts: int = 64
    moe_k: int = 6
    moe_intermediate_size: int = 1536
    moe_num_shared_experts: int = 2
    moe_layer_start_index: int = 1
    moe_layer_end_index: int = 10 ** 9   # HF default: the last layer
    moe_layer_interval: int = 1
    moe_norm_min: float = 1e-12
    use_bias: bool = False


CONFIG_PRESETS: Dict[str, Ernie45Config] = {
    "tiny-ernie45": Ernie45Config(
        vocab_size=256, hidden_size=64, intermediate_size=160,
        num_layers=3, num_heads=4, num_kv_heads=2, rope_theta=5e5,
        moe_num_experts=4, moe_k=2, moe_intermediate_size=48,
        moe_num_shared_experts=1, moe_layer_start_index=1,
        moe_layer_interval=1, tie_embeddings=True, dtype=torch.float32),
    # ERNIE-4.5-21B-A3B: 28 layers, 20 query heads over 4 KV heads of 128
    # (G = 5), 64 experts top 6 and 2 shared, the dense layer 0
    "ernie4.5-21b-a3b": Ernie45Config(
        vocab_size=103424, hidden_size=2560, intermediate_size=12288,
        num_layers=28, num_heads=20, num_kv_heads=4, rope_theta=5e5,
        moe_num_experts=64, moe_k=6, moe_intermediate_size=1536,
        moe_num_shared_experts=2, moe_layer_start_index=1,
        moe_layer_interval=1, tie_embeddings=True),
}


def layer_is_moe(cfg: Ernie45Config, li: int) -> bool:
    return ((li + 1) % cfg.moe_layer_interval == 0
            and cfg.moe_layer_start_index <= li <= cfg.moe_layer_end_index)


def block_linear_names(cfg: Ernie45Config) -> Tuple[str, ...]:
    """Union over the blocks; the dense blocks lack the expert leaves (the
    API prunes the plan per block)."""
    attn = ("q_proj", "k_proj", "v_proj", "o_proj")
    experts = tuple(f"experts.{e}.{w}"
                    for e in range(cfg.moe_num_experts) for w in _MLP)
    shared = (tuple(f"shared_experts.{w}" for w in _MLP)
              if cfg.moe_num_shared_experts else ())
    return attn + _MLP + experts + shared


def init_params(cfg: Ernie45Config, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree and scales (the fp32
    router and ``e_score_correction_bias``, the latter at zero; biases at
    zero, gains at one); the numbers differ (another generator).
    ``park(block)``, when given, takes each block as it is made and returns
    what the tree holds (see ``llama.init_params``)."""
    dev = resolve_device(device)
    H, hd = cfg.hidden_size, cfg.hd
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02, dtype=cfg.dtype):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
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
            "v_proj": normal((kvd, H)), "o_proj": normal((H, qd)),
            "input_layernorm": full(H, 1.0),
            "post_attention_layernorm": full(H, 1.0),
        }
        if cfg.use_bias:
            b["q_bias"] = full(qd, 0.0)
            b["k_bias"] = full(kvd, 0.0)
            b["v_bias"] = full(kvd, 0.0)
        if layer_is_moe(cfg, li):
            E = cfg.moe_num_experts
            b["router"] = normal((E, H), dtype=torch.float32)
            b["e_score_correction_bias"] = torch.zeros(
                (E,), dtype=torch.float32, device=dev)
            b["experts"] = [mlp(cfg.moe_intermediate_size) for _ in range(E)]
            if cfg.moe_num_shared_experts:
                b["shared_experts"] = mlp(cfg.moe_intermediate_size
                                          * cfg.moe_num_shared_experts)
        else:
            b.update(mlp(cfg.intermediate_size))
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": full(H, 1.0), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def _apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                            sin: torch.Tensor) -> torch.Tensor:
    """Interleaved rope on (B, S, n, hd) in fp32: pair i is ``(x[2i],
    x[2i+1])`` at the angle of ``cos`` / ``sin``'s column i (the standard
    (S, hd) tables)."""
    hd = x.shape[-1]
    c = cos[None, :, None, :hd // 2].float()
    s = sin[None, :, None, :hd // 2].float()
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _swiglu(weights, h, lf, prefix: str):
    gate = F.silu(lf(f"{prefix}gate_proj", h, weights["gate_proj"]))
    up = lf(f"{prefix}up_proj", h, weights["up_proj"])
    return lf(f"{prefix}down_proj", gate * up, weights["down_proj"])


def _route(weights, h: torch.Tensor, cfg: Ernie45Config, lf=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k expert ids, their combine weights) per token: selection on
    the biased softmax, weights the unbiased probs over their clamped sum
    (the module docstring)."""
    lf = lf or llama._plain_linear
    logits = lf("router", h.float(), weights["router"].float())
    probs = torch.softmax(logits, dim=-1)
    biased = probs + weights["e_score_correction_bias"].float()
    topi = _top_k(biased, cfg.moe_k)[1]
    topv = torch.gather(probs, -1, topi)
    topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True),
                              min=cfg.moe_norm_min)
    return topi, topv


def _ernie_moe(weights, h: torch.Tensor, cfg: Ernie45Config,
               lf) -> torch.Tensor:
    """Routed experts dense-then-mask, then the shared experts."""
    topi, topv = _route(weights, h, cfg, lf)
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e, ew in enumerate(weights["experts"]):
        y = _swiglu(ew, h, lf, f"experts.{e}.").float()
        w_e = torch.where(topi == e, topv, torch.zeros_like(topv)).sum(dim=-1)
        out = out + y * w_e[..., None]
    if "shared_experts" in weights:
        out = out + _swiglu(weights["shared_experts"], h, lf,
                            "shared_experts.").float()
    return out.to(h.dtype)


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: Ernie45Config, mask=None,
              linear_fn=None) -> torch.Tensor:
    """One decoder block: pre-norm GQA attention (optional q / k / v
    biases, interleaved rope) + pre-norm dense MLP or routed experts."""
    lf = linear_fn or llama._plain_linear
    B, S, H = x.shape
    hd = cfg.hd
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    q = lf("q_proj", h, weights["q_proj"], weights.get("q_bias")
           ).reshape(B, S, cfg.num_heads, hd)
    k = lf("k_proj", h, weights["k_proj"], weights.get("k_bias")
           ).reshape(B, S, cfg.num_kv_heads, hd)
    v = lf("v_proj", h, weights["v_proj"], weights.get("v_bias")
           ).reshape(B, S, cfg.num_kv_heads, hd)
    q = _apply_rope_interleaved(q, cos, sin)
    k = _apply_rope_interleaved(k, cos, sin)
    attn = llama.attention(q, k, v, mask, cfg).reshape(B, S, -1)
    x = x + lf("o_proj", attn, weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    if "experts" in weights:
        return x + _ernie_moe(weights, h, cfg, lf)
    return x + _swiglu(weights, h, lf, "")


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: Ernie45Config) -> torch.Tensor:
    """Full forward → logits."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = llama.rope_tables(cfg, input_ids.shape[1], device=x.device)
    for b in params["blocks"]:
        x = block_fwd(b, x, cos, sin, cfg)
    return llama.final_fwd(params, x, cfg)
