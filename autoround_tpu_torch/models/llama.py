"""Llama-family decoder in PyTorch (counterpart of ``autoround_tpu/models/llama.py``).

Parameters are a plain dictionary with the JAX package's structure::

    {"embed_tokens": (V, H), "norm": (H,), "lm_head": (V, H),
     "blocks": [{"q_proj": (O, I), ..., "input_layernorm": (H,), ...}]}

Every linear weight is stored ``(out_features, in_features)``.  Block
functions are plain functions on tensors, as in the JAX package, so
block-wise calibration is calling them in order.

This slice covers what Llama-3 configs use (GQA, head_dim, tied
embeddings, Llama-3.1 rope scaling).  The JAX config's other flags (Qwen
biases / qk-norm, Gemma norms, softcaps and sliding windows, Llama4
chunked attention, online R4, partial or linear-scaled rope) are not
ported: ``utils.convert.config_from_jax`` raises ``NotImplementedError``
for a config that sets one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.flash_attention import flash_attention

__all__ = ["LlamaConfig", "CONFIG_PRESETS", "init_params", "rms_norm",
           "rope_tables", "apply_rope", "attention", "block_fwd",
           "embed_fwd", "final_fwd", "model_fwd", "block_linear_names",
           "LINEAR_KEYS"]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # Llama-3.1+ NTK-by-parts rope scaling:
    # (factor, low_freq_factor, high_freq_factor, original_max_pos)
    rope_llama3: Optional[Tuple[float, float, float, int]] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.hidden_size // self.num_heads


CONFIG_PRESETS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        rope_theta=10000.0, dtype=torch.float32),
    "llama3.2-1b": LlamaConfig(vocab_size=128256, hidden_size=2048,
                               intermediate_size=8192, num_layers=16,
                               num_heads=32, num_kv_heads=8, head_dim=64,
                               tie_embeddings=True),
    "llama3-8b": LlamaConfig(vocab_size=128256, hidden_size=4096,
                             intermediate_size=14336, num_layers=32,
                             num_heads=32, num_kv_heads=8),
}

# The 2-D linear weights inside one decoder block, in (O, I) layout.
LINEAR_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj",
               "gate_proj", "up_proj", "down_proj")

# JAX LlamaConfig fields this slice does not port, with their "off" value
UNSUPPORTED_FIELDS = {
    "attn_bias": False, "qk_norm": False, "norm_offset": 0.0,
    "hidden_act": "silu", "embed_scale": False, "sandwich_norms": False,
    "attn_logit_softcap": 0.0, "final_logit_softcap": 0.0,
    "sliding_window": None, "layer_types": None, "chunked_attention": False,
    "rope_local_theta": 0.0, "partial_rotary_factor_local": 0.0,
    "rope_scaling_factor": 1.0, "attn_scale": None, "online_r4": False,
    "partial_rotary_factor": 1.0}


def block_linear_names(cfg: LlamaConfig) -> Tuple[str, ...]:
    return LINEAR_KEYS


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``).  Same scales as the JAX package's
    ``init_params``; the numbers differ (another generator)."""
    dev = resolve_device(device)
    H, hd = cfg.hidden_size, cfg.hd
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shapes = {
        "q_proj": (qd, H), "k_proj": (kvd, H), "v_proj": (kvd, H),
        "o_proj": (H, qd),
        "gate_proj": (cfg.intermediate_size, H),
        "up_proj": (cfg.intermediate_size, H),
        "down_proj": (H, cfg.intermediate_size),
    }

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(std)

    blocks = []
    for _ in range(cfg.num_layers):
        b = {name: normal(shp, 0.02 if name != "down_proj"
                          else 0.02 / np.sqrt(2 * cfg.num_layers))
             for name, shp in shapes.items()}
        b["input_layernorm"] = torch.ones((H,), dtype=cfg.dtype, device=dev)
        b["post_attention_layernorm"] = torch.ones((H,), dtype=cfg.dtype,
                                                   device=dev)
        blocks.append(b)
    params = {
        "embed_tokens": normal((cfg.vocab_size, H), 0.02),
        "norm": torch.ones((H,), dtype=cfg.dtype, device=dev),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H), 0.02)
    return params


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * g.float()).to(dt)


def rope_tables(cfg: LlamaConfig, seqlen: int,
                positions: Optional[torch.Tensor] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (seqlen, hd) in fp32, HF half-split convention.
    ``positions`` (S,) overrides ``arange(seqlen)``; the tables land on
    ``positions``' device, else on ``device``."""
    hd = cfg.hd
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd))
    if cfg.rope_llama3 is not None:
        factor, lo_f, hi_f, orig = cfg.rope_llama3
        wavelen = 2.0 * np.pi / inv_freq
        lo_wl, hi_wl = orig / lo_f, orig / hi_f
        smooth = np.clip((orig / wavelen - lo_f) / (hi_f - lo_f), 0.0, 1.0)
        blended = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(wavelen < hi_wl, inv_freq,
                            np.where(wavelen > lo_wl, inv_freq / factor,
                                     blended))
    if positions is None:
        positions = torch.arange(seqlen, device=device)
    inv = torch.as_tensor(inv_freq.astype(np.float32), device=positions.device)
    ang = positions[:, None].float() * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, n, hd); cos/sin: (S, hd)."""
    c = cos[None, :, None, :].float()
    s = sin[None, :, None, :].float()
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def _plain_linear(name, x, w):
    return torch.einsum("...i,oi->...o", x, w)


def _flash_eligible(q, k, mask) -> bool:
    """The JAX package's routing gate (``llama.py:342-345``; its softcap
    and attn_scale conditions always hold for the configs ported)."""
    S, hd = q.shape[1], q.shape[3]
    return (mask is None and hd % 128 == 0 and S >= 512 and S % 256 == 0
            and k.shape[1] % 256 == 0)


def attention(q, k, v, mask: Optional[torch.Tensor], cfg: LlamaConfig):
    """Batched GQA attention; causal (bottom-right) unless mask given.

    q: (B,S,nh,hd)  k,v: (B,T,nkv,hd).  Where the routing gate passes, the
    flash kernel runs (a CUDA tensor launches it, a CPU tensor takes its
    plain version); elsewhere this is plain math with softmax in fp32.
    """
    B, S, nh, hd = q.shape
    if _flash_eligible(q, k, mask):
        out, _ = flash_attention(q.transpose(1, 2).contiguous(),
                                 k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(), causal=True)
        return out.transpose(1, 2)
    T = k.shape[1]
    rep = nh // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q.float(),
                          k.float()) / math.sqrt(hd)
    if mask is None:
        causal = torch.ones((S, T), dtype=torch.bool,
                            device=q.device).tril(T - S)
        scores = torch.where(causal, scores, torch.full_like(scores, -1e30))
    else:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def block_fwd(weights: Dict[str, torch.Tensor], x: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor, cfg: LlamaConfig,
              mask: Optional[torch.Tensor] = None,
              linear_fn=None) -> torch.Tensor:
    """One decoder block: pre-norm attention + pre-norm gated MLP.

    ``linear_fn(name, x, w) -> y`` intercepts every linear application
    (serving substitutes the packed kernels here)."""
    lf = linear_fn or _plain_linear
    B, S, H = x.shape
    hd = cfg.hd
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    q = lf("q_proj", h, weights["q_proj"]).reshape(B, S, cfg.num_heads, hd)
    k = lf("k_proj", h, weights["k_proj"]).reshape(B, S, cfg.num_kv_heads,
                                                   hd)
    v = lf("v_proj", h, weights["v_proj"]).reshape(B, S, cfg.num_kv_heads,
                                                   hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attention(q, k, v, mask, cfg).reshape(B, S, -1)
    x = x + lf("o_proj", attn, weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    gate = F.silu(lf("gate_proj", h, weights["gate_proj"]))
    up = lf("up_proj", h, weights["up_proj"])
    return x + lf("down_proj", gate * up, weights["down_proj"])


def embed_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: LlamaConfig) -> torch.Tensor:
    return F.embedding(input_ids.long(), params["embed_tokens"])


def final_fwd(params: Dict[str, Any], x: torch.Tensor,
              cfg: LlamaConfig) -> torch.Tensor:
    """Final norm + lm_head → logits."""
    x = rms_norm(x, params["norm"], cfg.rms_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed_tokens"]
    return _plain_linear("lm_head", x, head)


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: LlamaConfig) -> torch.Tensor:
    """Full forward → logits."""
    x = embed_fwd(params, input_ids, cfg)
    cos, sin = rope_tables(cfg, input_ids.shape[1], device=x.device)
    for b in params["blocks"]:
        x = block_fwd(b, x, cos, sin, cfg)
    return final_fwd(params, x, cfg)
