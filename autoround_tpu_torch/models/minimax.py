"""MiniMax-Text-01 / M1 in PyTorch (counterpart of
``autoround_tpu/models/minimax.py``): a hybrid of lightning (linear) and
softmax attention under a Mixtral MoE, layer kinds by ``layer_types``.

* **linear_attention** (7 of every 8 published layers): lightning
  attention.  ``qkv_proj`` stays fused (3 · nh · hd outputs, each head's q
  / k / v side by side), SiLU over it, then per-head exponential-decay
  linear attention at the rate ``slope_rate`` (ALiBi-like geometric slopes
  scaled down with depth), computed in fp32 chunks of ``block_size``
  tokens: the intra-chunk Q Kᵀ with the diagonal decay, the inter-chunk
  read of a (hd, hd) state per head, and the state's decayed update; the
  full chunks run in a Python loop, a shorter last chunk as an epilogue,
  so the final state is exact for any S.  The heads' outputs concatenate,
  go through an RMSNorm (``attn_norm``) in the model dtype and a sigmoid
  ``output_gate`` in fp32, then ``out_proj``.
* **full_attention**: rope GQA attention over q / k / v / o (the flash
  kernel where its gate passes).
* **residuals** (``MiniMaxDecoderLayer``): the residual stream is the
  *normed* hidden ``h``, scaled: ``x = h · α + y · β`` after attention
  (the linear or full factors by the layer's kind) and ``h · α_mlp + moe ·
  β_mlp`` after the MoE, whose input ``h`` is ``x`` normed again.
* **MoE** on every layer: :func:`.mixtral._moe_mlp` with w1 / w2 / w3
  expert leaves; the serving block follows ``capacity_factor``.

``slope_rate`` is an fp32 leaf of every linear block, computed in float64
numpy and cast, as the JAX package does; ``attn_norm`` and the norms are
fp32 leaves of ``init_params``.  The lightning attention has no Pallas
kernel in the JAX package; it runs as PyTorch ops here too.

Serving (``serve/engine.py``) rides the hybrid protocol of
``models/qwen3next.py``: K / V for the full layers, the fp32 (nh, hd, hd)
state per head for the linear ones, updated in O(1) a token by
:func:`lightning_step`; MiniMax has no conv window, so its tail is a
zero-width placeholder.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import llama, mixtral
from .llama import rms_norm
from .mixtral import MixtralConfig

__all__ = ["MiniMaxConfig", "CONFIG_PRESETS", "init_params", "block_fwd",
           "block_fwd_for", "model_fwd", "block_with_cache",
           "block_linear_names", "lightning_attention", "lightning_step",
           "slope_rate", "layer_is_linear", "linear_cache_shapes"]


@dataclass(frozen=True)
class MiniMaxConfig(MixtralConfig):
    # "linear_attention" / "full_attention" per layer (HF layer_types)
    layer_types: Tuple[str, ...] = ()
    block_size: int = 256
    # the scaled residuals of MiniMaxDecoderLayer
    full_attn_alpha_factor: float = 1.0
    full_attn_beta_factor: float = 1.0
    linear_attn_alpha_factor: float = 1.0
    linear_attn_beta_factor: float = 1.0
    mlp_alpha_factor: float = 1.0
    mlp_beta_factor: float = 1.0


def _mk_types(n: int) -> Tuple[str, ...]:
    """The published 7 : 1 pattern: every 8th layer full attention."""
    return tuple("full_attention" if (i + 1) % 8 == 0
                 else "linear_attention" for i in range(n))


CONFIG_PRESETS: Dict[str, MiniMaxConfig] = {
    "tiny-minimax": MiniMaxConfig(
        vocab_size=256, hidden_size=64, intermediate_size=64,
        num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, num_experts=4, top_k=2, norm_topk_prob=True,
        layer_types=("linear_attention", "full_attention",
                     "linear_attention", "full_attention"),
        block_size=8, dtype=torch.float32),
    # MiniMax-Text-01 / M1 class (456B-A45.9B): 7 linear : 1 full
    "minimax-text-01": MiniMaxConfig(
        vocab_size=200064, hidden_size=6144, intermediate_size=9216,
        num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
        rope_theta=10000000.0, num_experts=32, top_k=2,
        norm_topk_prob=True, layer_types=_mk_types(80), block_size=256),
}


def slope_rate(cfg: MiniMaxConfig, layer_idx: int) -> torch.Tensor:
    """Per-head decay rates (nh,) fp32 on the CPU (HF ``get_slope_rate``):
    ALiBi-style geometric slopes scaled down for deeper layers, in float64
    then cast, as the JAX package computes them."""
    nh = cfg.num_heads
    base = 1.0 / (2.0 ** (8.0 / nh))
    rate = base ** (np.arange(nh, dtype=np.float64) + 1)
    factor = 1.0 - layer_idx / (cfg.num_layers - 1 + 1e-5) + 1e-5
    return torch.from_numpy((rate * factor).astype(np.float32))


def layer_is_linear(cfg: MiniMaxConfig, li: int) -> bool:
    return bool(cfg.layer_types) and cfg.layer_types[li] == "linear_attention"


def linear_cache_shapes(cfg: MiniMaxConfig):
    """Per-slot shapes of a linear layer's serving cache: the conv tail
    (none: zero-width) and the fp32 state (nh, hd, hd)."""
    return (0, 0), (cfg.num_heads, cfg.hd, cfg.hd)


_LIN = ("qkv_proj", "out_proj", "output_gate")
_FULL = ("q_proj", "k_proj", "v_proj", "o_proj")


def block_linear_names(cfg: MiniMaxConfig) -> Tuple[str, ...]:
    """The union over the layer kinds; the API prunes the plan per block."""
    experts = tuple(f"experts.{e}.{w}" for e in range(cfg.num_experts)
                    for w in ("w1", "w2", "w3"))
    return _LIN + _FULL + experts


def init_params(cfg: MiniMaxConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree, scales and dtypes (the
    norms, ``attn_norm`` and ``slope_rate`` fp32; every weight N(0, 0.02)
    in the model dtype); the numbers differ (another generator).  ``park``
    as in ``mixtral.init_params``."""
    dev = resolve_device(device)
    H, hd, nh = cfg.hidden_size, cfg.hd, cfg.num_heads
    kvd = cfg.num_kv_heads * hd

    def lin(o, i):
        t = torch.randn((o, i), generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(0.02)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    blocks = []
    for li in range(cfg.num_layers):
        b: Dict[str, Any] = {
            "input_layernorm": ones(H), "post_attention_layernorm": ones(H),
            "router": lin(cfg.num_experts, H),
            "experts": [{"w1": lin(cfg.intermediate_size, H),
                         "w3": lin(cfg.intermediate_size, H),
                         "w2": lin(H, cfg.intermediate_size)}
                        for _ in range(cfg.num_experts)]}
        if layer_is_linear(cfg, li):
            b["qkv_proj"] = lin(nh * hd * 3, H)
            b["out_proj"] = lin(H, nh * hd)
            b["output_gate"] = lin(nh * hd, H)
            b["attn_norm"] = ones(nh * hd)
            b["slope_rate"] = slope_rate(cfg, li).to(dev)
        else:
            b["q_proj"] = lin(nh * hd, H)
            b["k_proj"] = lin(kvd, H)
            b["v_proj"] = lin(kvd, H)
            b["o_proj"] = lin(H, nh * hd)
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": lin(cfg.vocab_size, H),
                              "blocks": blocks, "norm": ones(H)}
    params["lm_head"] = lin(cfg.vocab_size, H)
    return params


# ------------------------------------------------------- lightning attention

def _decays(rate: torch.Tensor, C: int):
    """(query (C, nh), key (C, nh), diagonal (nh, C, C), block (nh,))
    decays of a C-token chunk."""
    r = torch.arange(1, C + 1, dtype=torch.float32, device=rate.device)
    qd = torch.exp(-rate[None, :] * r[:, None])
    kd = torch.exp(-rate[None, :] * (C - r)[:, None])
    dd = r[:, None] - r[None, :]                          # i - j
    dd = torch.where(dd >= 0, torch.exp(-rate[:, None, None] * dd[None]),
                     torch.zeros((), device=rate.device))
    return qd, kd, dd, torch.exp(-rate * C)


def _lightning_block(q, k, v, state, decays):
    """One chunk: q / k / v (B, C, nh, d) fp32, state (B, nh, d, d) fp32
    → (out (B, C, nh, d), the new state)."""
    qd, kd, dd, bd = decays
    inter = torch.einsum("bcnd,bnde->bcne", q * qd[None, :, :, None], state)
    s = torch.einsum("bcnd,bknd->bnck", q, k) * dd[None]
    intra = torch.einsum("bnck,bknd->bcnd", s, v)
    new_state = (state * bd[None, :, None, None]
                 + torch.einsum("bcnd,bcne->bnde", k * kd[None, :, :, None],
                                v))
    return inter + intra, new_state


def lightning_attention(q, k, v, rate, block: int,
                        state: Optional[torch.Tensor] = None,
                        return_state: bool = False):
    """Chunked decay-linear attention: q / k / v (B, S, nh, d) → (B, S, nh,
    d) fp32 (and the final state (B, nh, d, d) with ``return_state``),
    from ``state`` (zeros by default).  HF's block recursion: each chunk's
    intra Q Kᵀ · decay · V plus the inter Q · state with per-position
    query / key decays; the full chunks in order, a shorter remainder as
    an epilogue with its own decays."""
    B, S, nh, d = q.shape
    q, k, v = q.float(), k.float(), v.float()
    rate = rate.float()
    if state is None:
        state = q.new_zeros((B, nh, d, d))
    n_full, rem = divmod(S, block)
    outs = []
    if n_full:
        dec = _decays(rate, block)
        for c in range(n_full):
            sl = slice(c * block, (c + 1) * block)
            o, state = _lightning_block(q[:, sl], k[:, sl], v[:, sl], state,
                                        dec)
            outs.append(o)
    if rem:
        sl = slice(n_full * block, S)
        o, state = _lightning_block(q[:, sl], k[:, sl], v[:, sl], state,
                                    _decays(rate, rem))
        outs.append(o)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return (out, state) if return_state else out


def lightning_step(q, k, v, rate, state):
    """O(1) decode: q / k / v (B, 1, nh, d), state (B, nh, d, d) fp32 →
    (out (B, 1, nh, d) fp32, the new state): the state decays by e^-rate,
    takes kᵀ v, then q reads it."""
    q, k, v = q.float(), k.float(), v.float()
    ratio = torch.exp(-rate.float())[None, :, None, None]
    state = state * ratio + torch.einsum("bnd,bne->bnde", k[:, 0], v[:, 0])
    out = torch.einsum("bnd,bnde->bne", q[:, 0], state)[:, None]
    return out, state


def _lightning_qkv(weights, h, cfg: MiniMaxConfig, lf):
    """SiLU over the fused ``qkv_proj`` → q, k, v (B, S, nh, hd), each
    head's three slices side by side."""
    B, S, _ = h.shape
    hd = cfg.hd
    qkv = llama._act(cfg.hidden_act)(lf("qkv_proj", h, weights["qkv_proj"]))
    qkv = qkv.reshape(B, S, cfg.num_heads, 3 * hd)
    return qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]


def _lightning_attn_out(weights, h, cfg: MiniMaxConfig, lf, o):
    """The heads' outputs concatenated and RMS-normed in the model dtype,
    times the sigmoid ``output_gate`` in fp32, through ``out_proj``."""
    B, S = h.shape[:2]
    y = rms_norm(o.reshape(B, S, -1).to(h.dtype), weights["attn_norm"],
                 cfg.rms_eps)
    gate = torch.sigmoid(lf("output_gate", h, weights["output_gate"]).float())
    return lf("out_proj", (y.float() * gate).to(h.dtype),
              weights["out_proj"])


def _full_qkv(weights, h, cos, sin, cfg: MiniMaxConfig, lf, fused=None):
    """Roped q (B, S, nh, hd), k, v (B, S, nkv, hd) of a full layer;
    ``fused(name, h)`` (the serving engine's) returns the members of a
    fused projection group, or None."""
    B, S, _ = h.shape
    hd = cfg.hd
    out = fused("qkv", h) if fused is not None else None
    if out is None:
        out = [lf(n, h, weights[n]) for n in ("q_proj", "k_proj", "v_proj")]
    q = out[0].reshape(B, S, cfg.num_heads, hd)
    k = out[1].reshape(B, S, cfg.num_kv_heads, hd)
    v = out[2].reshape(B, S, cfg.num_kv_heads, hd)
    return llama.apply_rope(q, cos, sin), llama.apply_rope(k, cos, sin), v


def _residual_moe(weights, x, cfg: MiniMaxConfig, lf,
                  capacity_factor: float = 0.0):
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    moe = mixtral._moe_mlp(weights, h, cfg, lf,
                           capacity_factor=capacity_factor)
    return h * cfg.mlp_alpha_factor + moe * cfg.mlp_beta_factor


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: MiniMaxConfig,
              mask: Optional[torch.Tensor] = None, linear_fn=None,
              linear_attn: bool = False) -> torch.Tensor:
    """One decoder block; ``linear_attn`` is the layer's kind (lightning or
    full attention), bound per layer by :func:`block_fwd_for`.  The
    residual branch is the normed hidden, scaled by the alpha / beta
    factors."""
    lf = linear_fn or llama._plain_linear
    B, S, _ = x.shape
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    if linear_attn:
        q, k, v = _lightning_qkv(weights, h, cfg, lf)
        o = lightning_attention(q, k, v, weights["slope_rate"],
                                cfg.block_size)
        y = _lightning_attn_out(weights, h, cfg, lf, o)
        a, b = cfg.linear_attn_alpha_factor, cfg.linear_attn_beta_factor
    else:
        q, k, v = _full_qkv(weights, h, cos, sin, cfg, lf)
        attn = llama.attention(q, k, v, mask, cfg)
        y = lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
        a, b = cfg.full_attn_alpha_factor, cfg.full_attn_beta_factor
    return _residual_moe(weights, h * a + y * b, cfg, lf)


@functools.lru_cache(maxsize=None)
def _variant_fn(linear_attn: bool):
    def fn(w, x, cos, sin, cfg, mask=None, linear_fn=None):
        return block_fwd(w, x, cos, sin, cfg, mask=mask,
                         linear_fn=linear_fn, linear_attn=linear_attn)
    return fn


def block_fwd_for(cfg: MiniMaxConfig, li: int):
    """Layer ``li``'s forward: one of two stable callables (lightning or
    full attention), with :func:`block_fwd`'s signature otherwise."""
    return _variant_fn(layer_is_linear(cfg, li))


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: MiniMaxConfig) -> torch.Tensor:
    """Full forward → logits."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = llama.rope_tables(cfg, input_ids.shape[1], device=x.device)
    for li, b in enumerate(params["blocks"]):
        x = block_fwd(b, x, cos, sin, cfg,
                      linear_attn=layer_is_linear(cfg, li))
    return llama.final_fwd(params, x, cfg)


def block_with_cache(weights, x, cos, sin, cfg: MiniMaxConfig, cache_in,
                     pos, lf, fused: Optional[Callable] = None,
                     capacity_factor: float = 0.0):
    """The serving block, ``qwen3next.block_with_cache``'s protocol: (out,
    cache pieces).  ``cache_in`` None (the prompt pass) or ("lin", tail,
    state) / ("full", k_all, v_all) at decode; the pieces are ("lin",
    tail, state), the tail zero-width (B, 0, 0), or ("full", k, v) with
    the new token's (or the prompt's) k / v.  At decode a full layer
    writes its token at ``pos[b]`` (``pos`` (B,) int32 on the device) in
    place and attends over [0, pos[b]].  ``fused`` as in
    :func:`_full_qkv`; the MoE route follows ``capacity_factor``."""
    B, S, _ = x.shape
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    if "qkv_proj" in weights:
        q, k, v = _lightning_qkv(weights, h, cfg, lf)
        if cache_in is None:
            o, state = lightning_attention(q, k, v, weights["slope_rate"],
                                           cfg.block_size, return_state=True)
            tail = x.new_zeros((B, 0, 0))
        else:
            o, state = lightning_step(q, k, v, weights["slope_rate"],
                                      cache_in[2])
            tail = cache_in[1]
        y = _lightning_attn_out(weights, h, cfg, lf, o)
        pieces = ("lin", tail, state)
        a, b = cfg.linear_attn_alpha_factor, cfg.linear_attn_beta_factor
    else:
        q, k, v = _full_qkv(weights, h, cos, sin, cfg, lf, fused)
        if cache_in is None:
            attn = llama.attention(q, k, v, None, cfg)
        else:
            k_all, v_all = cache_in[1], cache_in[2]
            slots = torch.arange(B, device=x.device)
            k_all[slots, pos] = k[:, 0].to(k_all.dtype)
            v_all[slots, pos] = v[:, 0].to(v_all.dtype)
            idx = torch.arange(k_all.shape[1], device=x.device)
            bias = torch.where(idx[None, :] <= pos[:, None], 0.0, -1e30)
            attn = llama.attention(q, k_all, v_all, bias[:, None, None, :],
                                   cfg)
        y = lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
        pieces = ("full", k, v)
        a, b = cfg.full_attn_alpha_factor, cfg.full_attn_beta_factor
    return _residual_moe(weights, h * a + y * b, cfg, lf,
                         capacity_factor), pieces
