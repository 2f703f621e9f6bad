"""LongCat-Flash decoder in PyTorch (counterpart of
``autoround_tpu/models/longcat.py``, Meituan ``LongcatFlashForCausalLM``):
shortcut-connected MoE (ScMoE) with zero-computation experts over MLA.

* **Two sublayer pairs a block**: each block holds two MLA attention
  sublayers and two dense SwiGLU MLPs (leaves suffixed ``_0`` / ``_1``).
  The MoE runs on the first post-attention stream and its output rides a
  shortcut over the second attention + MLP pair, joining the residual at
  the block's end.
* **Zero-computation experts**: ``zero_expert_num`` of the routed slots
  are identities; a token routed to one adds ``w · h`` (one fused term).
* **The router**: an fp32 einsum (not the linear interceptor) over real
  plus zero experts, softmax scores, the top-k selecting on ``scores +
  e_score_correction_bias`` (fp32), the weights the unbiased scores,
  *not* renormalised, times ``routed_scaling_factor``.  The top-k is a
  stable sort, the lower index first on a tie (``deepseek._top_k``).
* **The MLA corrections**: the queries are multiplied by ``(H /
  q_lora_rank)^0.5`` and the normed latent by ``(H / kv_lora_rank)^0.5``;
  the score scale is ``sqrt(qk_head_dim)`` with no mscale (DeepSeek's
  ``_attn_cfg`` divides by ``mscale²``, so it is not used here).

The attention is the plain one (the score scale is set, so the flash gate
refuses it), as in the JAX package.  Experts run dense-then-mask.  The JAX
engine serves no LongCat model, so the port's does not either.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import deepseek, llama
from .deepseek import DeepseekConfig, _rope_rotate, _top_k
from .llama import rms_norm

__all__ = ["LongcatConfig", "CONFIG_PRESETS", "init_params", "block_fwd",
           "model_fwd", "block_linear_names"]

_MLP = ("gate_proj", "up_proj", "down_proj")
_ATTN = ("q_a_proj", "q_b_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj")
_SUBS = ("_0", "_1")


@dataclass(frozen=True)
class LongcatConfig(DeepseekConfig):
    zero_expert_num: int = 256

    @property
    def total_experts(self) -> int:
        return self.n_routed_experts + self.zero_expert_num


CONFIG_PRESETS: Dict[str, LongcatConfig] = {
    "tiny-longcat": LongcatConfig(
        vocab_size=256, hidden_size=96, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=4, rope_theta=1e7,
        q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=4, zero_expert_num=2, num_experts_per_tok=2,
        moe_intermediate_size=48, n_shared_experts=0, first_k_dense=0,
        routed_scaling_factor=1.5, scoring_func="softmax",
        norm_topk_prob=False, rope_interleave=True, dtype=torch.float32),
}


def block_linear_names(cfg: LongcatConfig) -> Tuple[str, ...]:
    names: Tuple[str, ...] = ()
    for s in _SUBS:
        names += tuple(n + s for n in _ATTN) + tuple(w + s for w in _MLP)
    names += tuple(f"experts.{e}.{w}"
                   for e in range(cfg.n_routed_experts) for w in _MLP)
    return names


def init_params(cfg: LongcatConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree and scales (the fp32
    router over real plus zero experts, the fp32
    ``e_score_correction_bias`` at zero); the numbers differ (another
    generator).  ``park(block)``, when given, takes each block as it is
    made and returns what the tree holds (see ``llama.init_params``)."""
    dev = resolve_device(device)
    H, nh = cfg.hidden_size, cfg.num_heads
    r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                     cfg.qk_nope_head_dim, cfg.v_head_dim)
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02, dtype=cfg.dtype):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return t.mul_(std)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=dev)

    def mlp(width):
        return {"gate_proj": normal((width, H)), "up_proj": normal((width, H)),
                "down_proj": normal((H, width), down_std)}

    blocks = []
    for _ in range(cfg.num_layers):
        b: Dict[str, Any] = {}
        for s in _SUBS:
            b[f"input_layernorm{s}"] = ones(H)
            b[f"post_attention_layernorm{s}"] = ones(H)
            b[f"q_a_proj{s}"] = normal((cfg.q_lora_rank, H))
            b[f"q_a_layernorm{s}"] = ones(cfg.q_lora_rank)
            b[f"q_b_proj{s}"] = normal((nh * (dn + dr), cfg.q_lora_rank))
            b[f"kv_a_proj_with_mqa{s}"] = normal((r + dr, H))
            b[f"kv_a_layernorm{s}"] = ones(r)
            b[f"kv_b_proj{s}"] = normal((nh * (dn + dv), r))
            b[f"o_proj{s}"] = normal((H, nh * dv))
            for w, t in mlp(cfg.intermediate_size).items():
                b[w + s] = t
        b["router"] = normal((cfg.total_experts, H), dtype=torch.float32)
        b["e_score_correction_bias"] = torch.zeros(
            (cfg.total_experts,), dtype=torch.float32, device=dev)
        b["experts"] = [mlp(cfg.moe_intermediate_size)
                        for _ in range(cfg.n_routed_experts)]
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": ones(H), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def _mla_sub(weights, h, cos, sin, cfg: LongcatConfig, lf, s: str,
             mask=None):
    """One MLA sublayer with the low-rank scale corrections."""
    B, S, H = h.shape
    nh, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    sq = float(np.sqrt(H / cfg.q_lora_rank))
    skv = float(np.sqrt(H / r))
    qa = lf(f"q_a_proj{s}", h, weights[f"q_a_proj{s}"])
    qa = rms_norm(qa, weights[f"q_a_layernorm{s}"], cfg.rms_eps)
    q = lf(f"q_b_proj{s}", qa, weights[f"q_b_proj{s}"])
    q = q.reshape(B, S, nh, dn + dr) * sq
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = _rope_rotate(q_rope, cos, sin, cfg.rope_interleave)
    ckv = lf(f"kv_a_proj_with_mqa{s}", h, weights[f"kv_a_proj_with_mqa{s}"])
    c_kv = rms_norm(ckv[..., :r], weights[f"kv_a_layernorm{s}"],
                    cfg.rms_eps) * skv
    k_rope = _rope_rotate(ckv[..., r:].reshape(B, S, 1, dr), cos, sin,
                          cfg.rope_interleave)
    kv = lf(f"kv_b_proj{s}", c_kv, weights[f"kv_b_proj{s}"])
    kv = kv.reshape(B, S, nh, dn + cfg.v_head_dim)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(B, S, nh, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    acfg = dataclasses.replace(cfg, attn_scale=float(np.sqrt(
        cfg.qk_head_dim)))
    attn = llama.attention(q, k, v, mask, acfg).reshape(B, S, -1)
    return lf(f"o_proj{s}", attn, weights[f"o_proj{s}"])


def _route(h: torch.Tensor, weights, cfg: LongcatConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k slot ids over real plus zero experts, their weights) per
    token (the module docstring)."""
    logits = torch.einsum("...h,eh->...e", h.float(),
                          weights["router"].float())
    scores = torch.softmax(logits, dim=-1)
    choice = scores + weights["e_score_correction_bias"].float()
    topi = _top_k(choice, cfg.num_experts_per_tok)[1]
    return topi, torch.gather(scores, -1, topi) * cfg.routed_scaling_factor


def _sc_moe(weights, h: torch.Tensor, cfg: LongcatConfig, lf):
    """The routed experts dense-then-mask, plus the zero experts' ``w · h``
    term for the slots routed at ids >= ``n_routed_experts``."""
    topi, topw = _route(h, weights, cfg)
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e, ew in enumerate(weights["experts"]):
        y = deepseek._mlp(ew, h, cfg, lf, prefix=f"experts.{e}.").float()
        w_e = torch.where(topi == e, topw, torch.zeros_like(topw)).sum(dim=-1)
        out = out + y * w_e[..., None]
    w_zero = torch.where(topi >= cfg.n_routed_experts, topw,
                         torch.zeros_like(topw)).sum(dim=-1)
    out = out + h.float() * w_zero[..., None]
    return out.to(h.dtype)


def _dense_mlp(weights, h, cfg, lf, s: str):
    act = llama._act(cfg.hidden_act)
    gate = act(lf(f"gate_proj{s}", h, weights[f"gate_proj{s}"]))
    up = lf(f"up_proj{s}", h, weights[f"up_proj{s}"])
    return lf(f"down_proj{s}", gate * up, weights[f"down_proj{s}"])


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: LongcatConfig, mask=None,
              linear_fn=None) -> torch.Tensor:
    """One block: MLA → MLP (the MoE taken on the same stream as a
    shortcut) → MLA → MLP, the shortcut added at the end."""
    lf = linear_fn or llama._plain_linear
    h = rms_norm(x, weights["input_layernorm_0"], cfg.rms_eps)
    x = x + _mla_sub(weights, h, cos, sin, cfg, lf, "_0", mask)
    h = rms_norm(x, weights["post_attention_layernorm_0"], cfg.rms_eps)
    shortcut = _sc_moe(weights, h, cfg, lf)
    x = x + _dense_mlp(weights, h, cfg, lf, "_0")
    h = rms_norm(x, weights["input_layernorm_1"], cfg.rms_eps)
    x = x + _mla_sub(weights, h, cos, sin, cfg, lf, "_1", mask)
    h = rms_norm(x, weights["post_attention_layernorm_1"], cfg.rms_eps)
    return x + _dense_mlp(weights, h, cfg, lf, "_1") + shortcut


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: LongcatConfig) -> torch.Tensor:
    """Full forward → logits (DeepSeek's rope tables)."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = deepseek.rope_tables(cfg, input_ids.shape[1], device=x.device)
    for b in params["blocks"]:
        x = block_fwd(b, x, cos, sin, cfg)
    return llama.final_fwd(params, x, cfg)
