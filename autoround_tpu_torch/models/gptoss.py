"""GPT-OSS decoder in PyTorch (counterpart of
``autoround_tpu/models/gptoss.py``): attention sinks, alternating sliding
window, MoE with clamped SwiGLU experts carrying biases, YaRN rope.

* **Attention sinks**: a learnable per-head logit (fp32, ``sinks``) joins
  the softmax denominator and is dropped after it, so attention mass may go
  nowhere instead of onto a real token.
* **Sliding window on the even layers** (``llama.layer_is_sliding``).
* **Clamped SwiGLU**: gate clipped above at ``swiglu_limit``, up to
  ±limit, ``glu = gate * sigmoid(alpha * gate)``, output ``(up + 1) * glu``;
  the clips pass half the gradient on a bound, as ``jnp.clip`` does
  (``dtypes.intq._clip``).
* **YaRN rope**: NTK-by-parts frequencies (``yarn_truncate`` floors and
  ceils the correction range) and the attention factor ``0.1 ln(factor) +
  1`` on cos / sin.  This is not DeepSeek's YaRN (no ``mscale`` pair).

The router is a biased linear (``router``, fp32 ``router_bias``): top-k of
its logits, softmax over the k.  Experts are separate ``(O, I)`` leaves
``experts.<e>.<gate_proj|up_proj|down_proj>`` with biases ``gate_bias``,
``up_bias``, ``down_bias``; the router, the biases and the sinks are not
quantized.  Expert compute takes the three routes of :mod:`.mixtral`; the
grouped one adds the experts' stacked biases (E, 1, O) after each grouped
product (the grouped kernel carries no bias), and since the biases make an
unselected expert's output nonzero, its combine is masked by the top-k
weights: each token's k rows are gathered and summed in slot order
(``mixtral._combine_slots``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..dtypes.intq import _clip
from . import llama
from .deepseek import _top_k
from .llama import LlamaConfig, rms_norm
from .mixtral import _combine_slots, capacity_dispatch

__all__ = ["GptOssConfig", "CONFIG_PRESETS", "init_params", "block_fwd",
           "model_fwd", "block_linear_names", "rope_tables",
           "sink_attention"]


@dataclass(frozen=True)
class GptOssConfig(LlamaConfig):
    num_experts: int = 32
    top_k: int = 4
    swiglu_limit: float = 7.0
    swiglu_alpha: float = 1.702
    # YaRN (0 → plain rope)
    yarn_factor: float = 0.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_original_max_pos: int = 4096
    yarn_truncate: bool = False
    yarn_attention_factor: float = 0.0   # 0 → 0.1 ln(factor) + 1


CONFIG_PRESETS: Dict[str, GptOssConfig] = {
    "tiny-gptoss": GptOssConfig(
        vocab_size=256, hidden_size=64, intermediate_size=64,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, attn_bias=True, sliding_window=8,
        num_experts=4, top_k=2, dtype=torch.float32),
    "gpt-oss-20b": GptOssConfig(
        vocab_size=201088, hidden_size=2880, intermediate_size=2880,
        num_layers=24, num_heads=64, num_kv_heads=8, head_dim=64,
        rope_theta=150000.0, rms_eps=1e-5, attn_bias=True,
        sliding_window=128, num_experts=32, top_k=4,
        yarn_factor=32.0, yarn_original_max_pos=4096),
    "gpt-oss-120b": GptOssConfig(
        vocab_size=201088, hidden_size=2880, intermediate_size=2880,
        num_layers=36, num_heads=64, num_kv_heads=8, head_dim=64,
        rope_theta=150000.0, rms_eps=1e-5, attn_bias=True,
        sliding_window=128, num_experts=128, top_k=4,
        yarn_factor=32.0, yarn_original_max_pos=4096),
}

_MLP = ("gate_proj", "up_proj", "down_proj")


def block_linear_names(cfg: GptOssConfig) -> Tuple[str, ...]:
    attn = ("q_proj", "k_proj", "v_proj", "o_proj")
    return attn + tuple(f"experts.{e}.{w}"
                        for e in range(cfg.num_experts) for w in _MLP)


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: GptOssConfig, device: torch.device
              ) -> Tuple[torch.Tensor, float]:
    """(inv_freq (hd / 2,) fp32 on ``device``, the cos / sin factor): built
    in float64 with numpy as the JAX package does (HF
    ``_compute_yarn_parameters`` when ``yarn_factor > 1``), cast to fp32 and
    copied once per (config, device), so a captured decode step makes its
    tables on the device alone."""
    hd = cfg.hd
    inv_extra = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd))
    att = 1.0
    if cfg.yarn_factor and cfg.yarn_factor > 1.0:
        inv_inter = inv_extra / cfg.yarn_factor

        def corr_dim(n_rot):
            return (hd * math.log(cfg.yarn_original_max_pos
                                  / (n_rot * 2 * math.pi))
                    ) / (2 * math.log(cfg.rope_theta))

        low = corr_dim(cfg.yarn_beta_fast)
        high = corr_dim(cfg.yarn_beta_slow)
        if cfg.yarn_truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, hd - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(hd // 2) - low) / (high - low), 0, 1)
        extra_f = 1.0 - ramp
        inv_freq = inv_inter * (1 - extra_f) + inv_extra * extra_f
        att = (cfg.yarn_attention_factor
               or 0.1 * math.log(cfg.yarn_factor) + 1.0)
    else:
        inv_freq = inv_extra
    return torch.as_tensor(inv_freq.astype(np.float32), device=device), att


def rope_tables(cfg: GptOssConfig, seqlen: int,
                positions: Optional[torch.Tensor] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin (seqlen, hd) fp32, half-split convention, YaRN
    NTK-by-parts with the attention factor on both when ``yarn_factor`` is
    set.  ``positions`` (S,) overrides ``arange(seqlen)``; a decode step
    passes its (B,) per-slot positions and gets a row a slot."""
    if positions is None:
        positions = torch.arange(seqlen, device=device)
    inv, att = _inv_freq(cfg, positions.device)
    ang = positions[..., None].float() * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if att != 1.0:
        cos, sin = cos * att, sin * att
    return cos, sin


def init_params(cfg: GptOssConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree and scales, the biases
    at zero, the sinks and the router bias fp32 zeros; the numbers differ
    (another generator).  ``park(block)``, when given, takes each block as
    it is made and returns what the tree holds (see ``llama.init_params``)."""
    dev = resolve_device(device)
    H, hd, I = cfg.hidden_size, cfg.hd, cfg.intermediate_size
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(std)

    def full(n, value, dtype=None):
        return torch.full((n,), value, dtype=dtype or cfg.dtype, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        b: Dict[str, Any] = {
            "q_proj": normal((qd, H)), "k_proj": normal((kvd, H)),
            "v_proj": normal((kvd, H)), "o_proj": normal((H, qd)),
            "q_bias": full(qd, 0.0), "k_bias": full(kvd, 0.0),
            "v_bias": full(kvd, 0.0), "o_bias": full(H, 0.0),
            "sinks": full(cfg.num_heads, 0.0, torch.float32),
            "router": normal((cfg.num_experts, H)),
            "router_bias": full(cfg.num_experts, 0.0, torch.float32),
            "input_layernorm": full(H, 1.0),
            "post_attention_layernorm": full(H, 1.0),
            "experts": [{"gate_proj": normal((I, H)),
                         "up_proj": normal((I, H)),
                         "down_proj": normal((H, I), down_std),
                         "gate_bias": full(I, 0.0), "up_bias": full(I, 0.0),
                         "down_bias": full(H, 0.0)}
                        for _ in range(cfg.num_experts)],
        }
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": full(H, 1.0), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def sink_attention(q, k, v, mask: Optional[torch.Tensor],
                   sinks: torch.Tensor, cfg: GptOssConfig) -> torch.Tensor:
    """GQA attention with a per-head sink logit in the softmax
    denominator (HF ``eager_attention_forward``): the sink joins the fp32
    scores as an extra column, the softmax runs over (positions + sink),
    then the sink column is dropped.  q (B, S, nh, hd), k / v (B, T, nkv,
    hd); ``mask`` None is causal (bottom-right), else an additive bias
    broadcastable to (B, nh, S, T).  Plain PyTorch: no kernel takes the
    sink column at prefill, as in the JAX package."""
    B, S, nh, hd = q.shape
    T = k.shape[1]
    rep = nh // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) / (
        math.sqrt(hd))
    if mask is None:
        causal = torch.ones((S, T), dtype=torch.bool,
                            device=q.device).tril(T - S)
        scores = torch.where(causal, scores, torch.full_like(scores, -1e30))
    else:
        scores = scores + mask.float()
    sinkcol = sinks.float().reshape(1, nh, 1, 1).expand(B, nh, S, 1)
    comb = torch.cat([scores, sinkcol], dim=-1)
    comb = comb - comb.amax(dim=-1, keepdim=True)
    probs = torch.softmax(comb, dim=-1)[..., :-1]
    out = torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _clamped_swiglu(gate: torch.Tensor, up: torch.Tensor,
                    cfg: GptOssConfig) -> torch.Tensor:
    """(up + 1) * gate * sigmoid(alpha * gate) in fp32, gate clipped above
    and up both ways at ``swiglu_limit``."""
    lim = cfg.swiglu_limit
    gate = _clip(gate.float(), -math.inf, lim)
    up = _clip(up.float(), -lim, lim)
    glu = gate * torch.sigmoid(gate * cfg.swiglu_alpha)
    return (up + 1.0) * glu


def _route(weights, h: torch.Tensor, cfg: GptOssConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k expert ids, softmax over their logits): the fp32 router
    logits with the fp32 bias; the top-k is a stable sort, the lower index
    first on a tie, as ``jax.lax.top_k``."""
    logits = (torch.einsum("...h,eh->...e", h.float(),
                           weights["router"].float())
              + weights["router_bias"].float())
    topv, topi = _top_k(logits, cfg.top_k)
    return topi, torch.softmax(topv, dim=-1)


def _moe_mlp(weights: Dict[str, Any], h: torch.Tensor, cfg: GptOssConfig,
             lf, capacity_factor: float = 0.0) -> torch.Tensor:
    """Routed clamped-SwiGLU experts with biases (the module docstring
    names the three routes).  ``capacity_factor == 0``: dense-then-mask,
    exact; ``> 0``: capacity dispatch.  The grouped forms are taken when
    ``lf.grouped_names`` holds gate / up / down."""
    if any(hasattr(lf, a) for a in ("expert_offset", "local_experts",
                                    "expert_combine")):
        raise NotImplementedError(
            "_moe_mlp: expert parallelism (expert_offset / local_experts / "
            "expert_combine) is not ported yet (ROADMAP A15)")
    topi, topw = _route(weights, h, cfg)
    B, S, H = h.shape
    E, k = cfg.num_experts, cfg.top_k
    use_grouped = set(_MLP) <= set(getattr(lf, "grouped_names", frozenset()))
    experts = weights["experts"]

    def bias_stack(name):                         # (E, 1, O) or None
        if experts and experts[0].get(name) is not None:
            return torch.stack([ew[name] for ew in experts])[:, None, :]
        return None

    def grouped_clamped_swiglu(buf):              # (E, C, H) → (E, C, H)
        gate = lf.grouped("gate_proj", buf)
        up = lf.grouped("up_proj", buf)
        gb, ub = bias_stack("gate_bias"), bias_stack("up_bias")
        if gb is not None:
            gate = gate + gb.to(gate.dtype)
        if ub is not None:
            up = up + ub.to(up.dtype)
        mid = _clamped_swiglu(gate, up, cfg).to(buf.dtype)
        y = lf.grouped("down_proj", mid)
        db = bias_stack("down_bias")
        return y + db.to(y.dtype) if db is not None else y

    def apply_expert(e, xb):
        ew = experts[e]
        p = f"experts.{e}."
        gate = lf(p + "gate_proj", xb, ew["gate_proj"], ew.get("gate_bias"))
        up = lf(p + "up_proj", xb, ew["up_proj"], ew.get("up_bias"))
        mid = _clamped_swiglu(gate, up, cfg).to(xb.dtype)
        return lf(p + "down_proj", mid, ew["down_proj"], ew.get("down_bias"))

    if capacity_factor and capacity_factor > 0:
        out = capacity_dispatch(
            h, topi, topw, E, capacity_factor, apply_expert,
            grouped_apply=grouped_clamped_swiglu if use_grouped else None)
    elif use_grouped:
        # every expert runs the full token slab (shared, expert stride 0);
        # an unselected expert's row is nonzero (its biases), so only each
        # token's k routed rows are gathered, weighted and summed in slot
        # order
        N = B * S
        ys = grouped_clamped_swiglu(h.reshape(1, N, H).expand(E, N, H))
        n_idx = torch.arange(N, device=h.device).repeat_interleave(k)
        out = _combine_slots(ys[topi.reshape(N * k), n_idx].float(),
                             topw.reshape(N * k), k).reshape(B, S, H)
    else:
        out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e in range(E):
            y = apply_expert(e, h).float()
            w_e = torch.where(topi == e, topw,
                              torch.zeros_like(topw)).sum(dim=-1)
            out = out + y * w_e[..., None]
    return out.to(h.dtype)


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: GptOssConfig,
              mask: Optional[torch.Tensor] = None,
              linear_fn=None) -> torch.Tensor:
    """One decoder block: pre-norm biased GQA attention with sinks +
    pre-norm routed clamped-SwiGLU experts (dense-then-mask)."""
    lf = linear_fn or llama._plain_linear
    B, S, H = x.shape
    hd = cfg.hd
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    q = lf("q_proj", h, weights["q_proj"], weights.get("q_bias"))
    k = lf("k_proj", h, weights["k_proj"], weights.get("k_bias"))
    v = lf("v_proj", h, weights["v_proj"], weights.get("v_bias"))
    q = llama.apply_rope(q.reshape(B, S, cfg.num_heads, hd), cos, sin)
    k = llama.apply_rope(k.reshape(B, S, cfg.num_kv_heads, hd), cos, sin)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    attn = sink_attention(q, k, v, mask, weights["sinks"], cfg)
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"],
               weights.get("o_bias"))
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    return x + _moe_mlp(weights, h, cfg, lf)


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: GptOssConfig) -> torch.Tensor:
    """Full forward → logits (the even layers slide past the window)."""
    x = llama.embed_fwd(params, input_ids, cfg)
    S = input_ids.shape[1]
    cos, sin = rope_tables(cfg, S, device=x.device)
    smask = (llama.sliding_mask(cfg, S, x.device)
             if cfg.sliding_window is not None and S > cfg.sliding_window
             else None)
    for li, b in enumerate(params["blocks"]):
        mask = smask if llama.layer_is_sliding(cfg, li) else None
        x = block_fwd(b, x, cos, sin, cfg, mask=mask)
    return llama.final_fwd(params, x, cfg)
