"""Llama-family decoder in PyTorch (counterpart of ``autoround_tpu/models/llama.py``).

Parameters are a plain dictionary with the JAX package's structure::

    {"embed_tokens": (V, H), "norm": (H,), "lm_head": (V, H),
     "blocks": [{"q_proj": (O, I), ..., "input_layernorm": (H,), ...}]}

Every linear weight is stored ``(out_features, in_features)``.  Block
functions are plain functions on tensors, as in the JAX package, so
block-wise calibration is calling them in order.

One decoder serves the family through config flags, as in the JAX package:
Llama 2/3 (GQA, head_dim, tied embeddings, Llama-3.1 rope scaling),
Qwen2.5 (q/k/v biases), Qwen3 (per-head q/k RMSNorm), Gemma2 / Gemma3 (the
``(offset + g)`` norm weight, GeGLU, the embedding normalizer, sandwich
norms, attention and final logit softcaps, a score divisor, sliding-window
layers, local rope tables), Llama4's chunked attention (``chunked_attention``:
the sliding layers attend within ``sliding_window``-sized chunks),
partial or linear-scaled rope, and QuaRot's ``online_r4``: a
block-diagonal Hadamard on the down_proj input (:func:`r4_rotate`; the
weights pre-rotated by ``transforms.hadamard.apply_r4_rotation``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.flash_attention import flash_attention

__all__ = ["LlamaConfig", "CONFIG_PRESETS", "init_params", "rms_norm",
           "rope_tables", "dual_rope_tables", "apply_rope", "attention",
           "block_fwd", "embed_fwd", "final_fwd", "model_fwd",
           "layer_is_sliding", "sliding_mask", "block_linear_names",
           "LINEAR_KEYS", "r4_rotate", "hadamard_block"]


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
    attn_bias: bool = False          # Qwen2-style q/k/v bias
    qk_norm: bool = False            # Qwen3 / Gemma3: per-head RMSNorm on q/k
    norm_offset: float = 0.0         # Gemma: RMSNorm weight is (offset + g)
    hidden_act: str = "silu"         # "gelu_tanh" for Gemma GeGLU
    embed_scale: bool = False        # Gemma: embeddings * sqrt(hidden)
    sandwich_norms: bool = False     # Gemma2: post-attn/ffw norms + pre-ffw
    attn_logit_softcap: float = 0.0  # Gemma2: tanh soft capping on scores
    final_logit_softcap: float = 0.0
    # sliding-window attention layers: even layer indices slide (Gemma2),
    # or the pattern of layer_types ("sliding_attention" / "full_attention")
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None
    # Llama4: the sliding layers attend block-diagonally within
    # sliding_window-sized chunks (causal inside a chunk), not a window
    chunked_attention: bool = False
    # Gemma3 dual rope: sliding layers use a local base frequency and no
    # scaling; global layers use rope_theta / linear rope_scaling_factor
    rope_local_theta: float = 0.0
    # the head fraction sliding layers rotate, when it differs (0: same)
    partial_rotary_factor_local: float = 0.0
    rope_scaling_factor: float = 1.0
    # Llama-3.1+ NTK-by-parts rope scaling:
    # (factor, low_freq_factor, high_freq_factor, original_max_pos)
    rope_llama3: Optional[Tuple[float, float, float, int]] = None
    attn_scale: Optional[float] = None  # score divisor (Gemma2:
    #                                      query_pre_attn_scalar ** 0.5)
    # QuaRot online R4: rotate the down_proj input with an r4_block-wide
    # block-diagonal Hadamard (the weights pre-rotated to match)
    online_r4: bool = False
    r4_block: int = 128
    # only the leading hd * factor dims of each head rotate
    partial_rotary_factor: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.hidden_size // self.num_heads


CONFIG_PRESETS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        rope_theta=10000.0, dtype=torch.float32),
    "tiny-qwen": LlamaConfig(vocab_size=256, hidden_size=64,
                             intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2, attn_bias=True,
                             rope_theta=10000.0, dtype=torch.float32),
    "llama3.2-1b": LlamaConfig(vocab_size=128256, hidden_size=2048,
                               intermediate_size=8192, num_layers=16,
                               num_heads=32, num_kv_heads=8, head_dim=64,
                               tie_embeddings=True),
    "llama3-8b": LlamaConfig(vocab_size=128256, hidden_size=4096,
                             intermediate_size=14336, num_layers=32,
                             num_heads=32, num_kv_heads=8),
    "qwen2.5-7b": LlamaConfig(vocab_size=152064, hidden_size=3584,
                              intermediate_size=18944, num_layers=28,
                              num_heads=28, num_kv_heads=4, attn_bias=True,
                              rope_theta=1000000.0, rms_eps=1e-6),
    "qwen3-4b": LlamaConfig(vocab_size=151936, hidden_size=2560,
                            intermediate_size=9728, num_layers=36,
                            num_heads=32, num_kv_heads=8, head_dim=128,
                            qk_norm=True, rope_theta=1000000.0,
                            rms_eps=1e-6, tie_embeddings=True),
    "gemma2-2b": LlamaConfig(vocab_size=256000, hidden_size=2304,
                             intermediate_size=9216, num_layers=26,
                             num_heads=8, num_kv_heads=4, head_dim=256,
                             rope_theta=10000.0, rms_eps=1e-6,
                             tie_embeddings=True, norm_offset=1.0,
                             hidden_act="gelu_tanh", embed_scale=True,
                             sandwich_norms=True, attn_logit_softcap=50.0,
                             final_logit_softcap=30.0,
                             attn_scale=256.0 ** 0.5, sliding_window=4096),
    "tiny-qwen3": LlamaConfig(vocab_size=256, hidden_size=64,
                              intermediate_size=128, num_layers=2,
                              num_heads=4, num_kv_heads=2, qk_norm=True,
                              rope_theta=10000.0, dtype=torch.float32),
    "tiny-gemma3": LlamaConfig(vocab_size=256, hidden_size=64,
                               intermediate_size=128, num_layers=3,
                               num_heads=4, num_kv_heads=2, head_dim=16,
                               qk_norm=True, rope_theta=1000000.0,
                               rope_local_theta=10000.0,
                               rope_scaling_factor=8.0, rms_eps=1e-6,
                               norm_offset=1.0, hidden_act="gelu_tanh",
                               embed_scale=True, sandwich_norms=True,
                               attn_scale=16.0 ** 0.5, sliding_window=8,
                               layer_types=("sliding_attention",
                                            "sliding_attention",
                                            "full_attention"),
                               tie_embeddings=True, dtype=torch.float32),
    "gemma3-12b": LlamaConfig(vocab_size=262208, hidden_size=3840,
                              intermediate_size=15360, num_layers=48,
                              num_heads=16, num_kv_heads=8, head_dim=256,
                              qk_norm=True, rope_theta=1000000.0,
                              rope_local_theta=10000.0,
                              rope_scaling_factor=8.0, rms_eps=1e-6,
                              norm_offset=1.0, hidden_act="gelu_tanh",
                              embed_scale=True, sandwich_norms=True,
                              attn_scale=256.0 ** 0.5, sliding_window=1024,
                              layer_types=tuple(
                                  "full_attention" if (i + 1) % 6 == 0
                                  else "sliding_attention"
                                  for i in range(48)),
                              tie_embeddings=True),
    "tiny-gemma2": LlamaConfig(vocab_size=256, hidden_size=64,
                               intermediate_size=128, num_layers=2,
                               num_heads=4, num_kv_heads=2,
                               rope_theta=10000.0, rms_eps=1e-6,
                               norm_offset=1.0, hidden_act="gelu_tanh",
                               embed_scale=True, sandwich_norms=True,
                               attn_logit_softcap=50.0,
                               final_logit_softcap=30.0,
                               dtype=torch.float32),
}

# The 2-D linear weights inside one decoder block, in (O, I) layout.
LINEAR_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj",
               "gate_proj", "up_proj", "down_proj")

def block_linear_names(cfg: LlamaConfig) -> Tuple[str, ...]:
    return LINEAR_KEYS


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``).  Same scales and leaves as the JAX package's
    ``init_params``; the numbers differ (another generator).
    ``park(block)``, when given, takes each block as it is made and
    returns what the tree holds (e.g. the block moved to host memory), so
    the whole model is never on ``device`` at once; the numbers are the
    same."""
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

    def full(n, value):
        return torch.full((n,), value, dtype=cfg.dtype, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        b = {name: normal(shp, 0.02 if name != "down_proj"
                          else 0.02 / np.sqrt(2 * cfg.num_layers))
             for name, shp in shapes.items()}
        # norm gains start at identity: 1, or 0 under a +offset fold
        gain0 = 1.0 - cfg.norm_offset
        b["input_layernorm"] = full(H, gain0)
        b["post_attention_layernorm"] = full(H, gain0)
        if cfg.sandwich_norms:
            b["pre_feedforward_layernorm"] = full(H, gain0)
            b["post_feedforward_layernorm"] = full(H, gain0)
        if cfg.qk_norm:
            b["q_norm"] = full(hd, 1.0)
            b["k_norm"] = full(hd, 1.0)
        if cfg.attn_bias:
            b["q_bias"] = full(qd, 0.0)
            b["k_bias"] = full(kvd, 0.0)
            b["v_bias"] = full(kvd, 0.0)
        blocks.append(b if park is None else park(b))
    params = {
        "embed_tokens": normal((cfg.vocab_size, H), 0.02),
        "norm": full(H, 1.0),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H), 0.02)
    return params


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype; ``offset`` is the Gemma
    ``(offset + g)`` weight fold."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    w = g.float() + offset if offset else g.float()   # no launch for 0
    return (x * w).to(dt)


def _act(name: str):
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    return F.silu


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


@functools.lru_cache(maxsize=None)
def _inv_freq(rd: int, theta: float, scaling: float,
              rope_llama3: Optional[Tuple[float, float, float, int]],
              device: torch.device) -> torch.Tensor:
    """The rope frequencies (rd / 2,) fp32 on ``device`` for ``rd``
    rotated dims, computed in float64 with numpy (linear ``scaling``
    divides, then the Llama-3.1 parts apply) and copied once per
    (frequencies, device): a decode step then makes its tables on the
    device alone (a host-to-device copy cannot be captured in a CUDA
    graph)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, rd, 2) / rd))
    if scaling != 1.0:
        inv_freq = inv_freq / scaling              # HF linear scaling
    if rope_llama3 is not None:
        factor, lo_f, hi_f, orig = rope_llama3
        wavelen = 2.0 * np.pi / inv_freq
        lo_wl, hi_wl = orig / lo_f, orig / hi_f
        smooth = np.clip((orig / wavelen - lo_f) / (hi_f - lo_f), 0.0, 1.0)
        blended = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(wavelen < hi_wl, inv_freq,
                            np.where(wavelen > lo_wl, inv_freq / factor,
                                     blended))
    return torch.as_tensor(inv_freq.astype(np.float32), device=device)


def rope_tables(cfg: LlamaConfig, seqlen: int,
                positions: Optional[torch.Tensor] = None,
                device=None, local: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (seqlen, rd) in fp32, HF half-split convention, with
    ``rd = hd * partial_rotary_factor`` rotated dims.  ``local=True``
    builds a sliding layer's tables (Gemma3: the local base frequency,
    unscaled; its own rotated fraction where one is set).  ``positions``
    (S,) overrides ``arange(seqlen)``; the tables land on ``positions``'
    device, else on ``device``.  A decode step passes its (B,) per-slot
    positions and gets one row per slot."""
    frac = (cfg.partial_rotary_factor_local
            if local and cfg.partial_rotary_factor_local
            else cfg.partial_rotary_factor)
    theta = (cfg.rope_local_theta if local and cfg.rope_local_theta
             else cfg.rope_theta)
    if positions is None:
        positions = torch.arange(seqlen, device=device)
    inv = _inv_freq(int(cfg.hd * frac), float(theta),
                    1.0 if local else float(cfg.rope_scaling_factor),
                    None if local else cfg.rope_llama3, positions.device)
    ang = positions[:, None].float() * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def dual_rope_tables(cfg: LlamaConfig, seqlen: int,
                     positions: Optional[torch.Tensor] = None, device=None):
    """((cos, sin) global, (cos, sin) local): the same pair unless the
    config carries a Gemma3-style local base frequency."""
    glob = rope_tables(cfg, seqlen, positions, device)
    if cfg.rope_local_theta:
        return glob, rope_tables(cfg, seqlen, positions, device, local=True)
    return glob, glob


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, n, hd); cos/sin: (S, rd), or (B, S, rd) with a row per
    slot (per-slot decode positions).  When rd < hd only the leading rd
    dims rotate."""
    if cos.ndim == 3:
        c, s = cos[:, :, None, :].float(), sin[:, :, None, :].float()
    else:
        c = cos[None, :, None, :].float()
        s = sin[None, :, None, :].float()
    rd = cos.shape[-1]
    if rd < x.shape[-1]:
        xr = x[..., :rd].float()
        rot = (xr * c + _rotate_half(xr) * s).to(x.dtype)
        return torch.cat([rot, x[..., rd:]], dim=-1)
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def _plain_linear(name, x, w, b=None):
    y = torch.einsum("...i,oi->...o", x, w)
    return y if b is None else y + b


def _flash_eligible(q, k, mask) -> bool:
    """The JAX package's shape gate (``llama.py:338-340``): causal, hd a
    multiple of 128, S >= 512 and S, T multiples of 256.  ``attention``
    adds the gate's config conditions: no softcap, the default score
    scale."""
    S, hd = q.shape[1], q.shape[3]
    return (mask is None and hd % 128 == 0 and S >= 512 and S % 256 == 0
            and k.shape[1] % 256 == 0)


def attention(q, k, v, mask: Optional[torch.Tensor], cfg: LlamaConfig):
    """Batched GQA attention; causal (bottom-right) unless mask given.

    q: (B,S,nh,hd)  k,v: (B,T,nkv,hd).  Where the routing gate passes, the
    flash kernel runs (a CUDA tensor launches it, a CPU tensor takes its
    plain version); elsewhere this is plain math with softmax in fp32:
    scores over ``attn_scale`` (default sqrt(hd)), then the softcap.
    """
    B, S, nh, hd = q.shape
    if (_flash_eligible(q, k, mask) and cfg.attn_logit_softcap == 0.0
            and cfg.attn_scale is None):
        out, _ = flash_attention(q.transpose(1, 2).contiguous(),
                                 k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(), causal=True)
        return out.transpose(1, 2)
    T = k.shape[1]
    rep = nh // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) / (
        cfg.attn_scale if cfg.attn_scale is not None else math.sqrt(hd))
    if cfg.attn_logit_softcap:
        scores = _softcap(scores, cfg.attn_logit_softcap)
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
    """One decoder block: pre-norm attention + pre-norm gated MLP (with
    Gemma2's sandwich norms when set).

    ``linear_fn(name, x, w, b=None) -> y`` intercepts every linear
    application and adds the bias when one is given (serving substitutes
    the packed kernels here, activation quantization its qdq)."""
    lf = linear_fn or _plain_linear
    B, S, H = x.shape
    hd = cfg.hd
    off = cfg.norm_offset
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps, off)
    q = lf("q_proj", h, weights["q_proj"], weights.get("q_bias"))
    k = lf("k_proj", h, weights["k_proj"], weights.get("k_bias"))
    v = lf("v_proj", h, weights["v_proj"], weights.get("v_bias"))
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:          # per-head RMS before rope
        q = rms_norm(q, weights["q_norm"], cfg.rms_eps, off)
        k = rms_norm(k, weights["k_norm"], cfg.rms_eps, off)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attention(q, k, v, mask, cfg).reshape(B, S, -1)
    attn_out = lf("o_proj", attn, weights["o_proj"])
    x, h = _post_attention(weights, x, attn_out, cfg)
    gate = _act(cfg.hidden_act)(lf("gate_proj", h, weights["gate_proj"]))
    up = lf("up_proj", h, weights["up_proj"])
    mlp_in = gate * up
    if cfg.online_r4:
        mlp_in = r4_rotate(mlp_in, cfg.r4_block)
    return _residual_mlp(weights, x, lf("down_proj", mlp_in,
                                        weights["down_proj"]), cfg)


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    if h.shape[0] != n:
        raise ValueError(f"r4_block={n} must be a power of 2")
    return h / np.sqrt(n)


_HADAMARD: Dict[Tuple[int, str, torch.dtype], torch.Tensor] = {}


def hadamard_block(n: int, device, dtype: torch.dtype) -> torch.Tensor:
    """The scaled (n, n) Sylvester Hadamard in ``dtype`` on ``device``,
    made once and kept: a captured decode step reads this device tensor
    (it is made by the eager step before the capture), never a host
    value."""
    key = (n, str(torch.device(device)), dtype)
    h = _HADAMARD.get(key)
    if h is None:
        h = torch.tensor(_hadamard_np(n), dtype=torch.float32).to(
            device=device, dtype=dtype)
        _HADAMARD[key] = h
    return h


def r4_rotate(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Online block-diagonal Hadamard rotation of the trailing axis, a
    product in ``x``'s dtype (the JAX package's ``r4_rotate``)."""
    shp = x.shape
    h = hadamard_block(block, x.device, x.dtype)
    y = x.reshape(*shp[:-1], shp[-1] // block, block) @ h
    return y.reshape(shp)


def _post_attention(weights, x, attn_out, cfg: LlamaConfig):
    """The attention residual and the MLP's input norm: (x, h)."""
    off = cfg.norm_offset
    if cfg.sandwich_norms:   # Gemma2: norm the branch output, then pre-ffw
        attn_out = rms_norm(attn_out, weights["post_attention_layernorm"],
                            cfg.rms_eps, off)
        x = x + attn_out
        return x, rms_norm(x, weights["pre_feedforward_layernorm"],
                           cfg.rms_eps, off)
    x = x + attn_out
    return x, rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps,
                       off)


def _residual_mlp(weights, x, mlp_out, cfg: LlamaConfig):
    """x + the MLP branch (normed first under sandwich norms)."""
    if cfg.sandwich_norms:
        mlp_out = rms_norm(mlp_out, weights["post_feedforward_layernorm"],
                           cfg.rms_eps, cfg.norm_offset)
    return x + mlp_out


def embed_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: LlamaConfig) -> torch.Tensor:
    x = F.embedding(input_ids.long(), params["embed_tokens"])
    if cfg.embed_scale:      # Gemma normalizer
        x = (x.float() * math.sqrt(cfg.hidden_size)).to(x.dtype)
    return x


def _final_softcap(logits: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    if not cfg.final_logit_softcap:
        return logits
    return _softcap(logits.float(), cfg.final_logit_softcap).to(logits.dtype)


def final_fwd(params: Dict[str, Any], x: torch.Tensor,
              cfg: LlamaConfig) -> torch.Tensor:
    """Final norm + lm_head → logits (soft-capped where the config asks)."""
    x = rms_norm(x, params["norm"], cfg.rms_eps, cfg.norm_offset)
    head = params.get("lm_head")
    if head is None:
        head = params["embed_tokens"]
    return _final_softcap(_plain_linear("lm_head", x, head), cfg)


def layer_is_sliding(cfg: LlamaConfig, layer_idx: int) -> bool:
    """Gemma2: even layers use the sliding window (HF convention); a
    Gemma3-style pattern rides in ``cfg.layer_types``."""
    if cfg.sliding_window is None:
        return False
    if cfg.layer_types is not None:
        return cfg.layer_types[layer_idx] == "sliding_attention"
    return layer_idx % 2 == 0


def sliding_mask(cfg: LlamaConfig, S: int, device=None) -> torch.Tensor:
    """(1, 1, S, S) fp32 additive bias: causal and within the rolling
    window, or within the same chunk under ``chunked_attention`` (0 where a
    key is seen, -1e30 elsewhere)."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    w = cfg.sliding_window
    if cfg.chunked_attention:
        ok = (cols <= rows) & (rows // w == cols // w)
    else:
        ok = (cols <= rows) & (cols > rows - w)
    return torch.where(ok, 0.0, -1e30)[None, None]


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: LlamaConfig) -> torch.Tensor:
    """Full forward → logits."""
    x = embed_fwd(params, input_ids, cfg)
    S = input_ids.shape[1]
    (cos, sin), (cosl, sinl) = dual_rope_tables(cfg, S, device=x.device)
    smask = (sliding_mask(cfg, S, x.device) if cfg.sliding_window is not None
             and S > cfg.sliding_window else None)
    for li, b in enumerate(params["blocks"]):
        if layer_is_sliding(cfg, li):
            x = block_fwd(b, x, cosl, sinl, cfg, mask=smask)
        else:
            x = block_fwd(b, x, cos, sin, cfg)
    return final_fwd(params, x, cfg)
