"""GLM-5 ``GlmMoeDsa`` in PyTorch (counterpart of
``autoround_tpu/models/glmdsa.py``): DeepSeek MLA + MoE with DSA (DeepSeek
Sparse Attention), a lightning indexer that picks a per-query subset of the
keys before the main attention.

* **Indexer** (the DeepSeek-V3.2 lightning indexer): per query ``t`` and
  indexer head ``h``, ``score(t, j) = sum_h w[t, h] * relu(q_idx[t, h] ·
  k_idx[j])`` with one shared key head, rope on the leading
  ``qk_rope_head_dim`` dims of each head, ``w = weights_proj · h``.  All in
  fp32.
* **Mask** (:func:`dsa_mask`): a query keeps the causal keys whose score is
  at least its ``index_topk``-th largest causal score, plus the diagonal.
  It compares against the k-th value, so a tie at that value keeps every
  tied key (more than k): it is not an index top-k.
* **Index sharing**: ``index_layers`` lists the layers that own an indexer
  (empty: every layer); :func:`model_fwd` threads their masks to the layers
  after them.  A shared layer stores a copy of its governing layer's
  indexer, so block-wise calibration, which carries hidden states only,
  recomputes its mask from the block's own input (the JAX package's
  documented approximation; exact when every layer indexes).

The indexer's ``q_proj`` / ``k_proj`` quantize like any linear;
``weights_proj`` stays full precision and is not in
:func:`block_linear_names`.  The main attention runs masked, so neither
package reaches a flash kernel here.  The serving engine serves the family
with dense MLA over the latent cache (``serve/engine.py``), as the JAX
engine does, and says so in a warning.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .._device import resolve_device
from . import deepseek, llama
from .deepseek import DeepseekConfig, _ffn, mla_attention_inputs
from .llama import rms_norm

__all__ = ["GlmMoeDsaConfig", "CONFIG_PRESETS", "init_params", "block_fwd",
           "model_fwd", "block_linear_names", "indexer_scores", "dsa_mask"]


@dataclass(frozen=True)
class GlmMoeDsaConfig(DeepseekConfig):
    index_n_heads: int = 4
    index_head_dim: int = 32
    index_topk: int = 64
    # () → every layer owns an indexer (DeepSeek-V3.2 layout); otherwise the
    # layers that do, the others reusing the latest one's mask
    index_layers: Tuple[int, ...] = ()

    def layer_has_indexer(self, li: int) -> bool:
        return not self.index_layers or li in self.index_layers


CONFIG_PRESETS: Dict[str, GlmMoeDsaConfig] = {
    "tiny-glmdsa": GlmMoeDsaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=4, rope_theta=10000.0,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        n_shared_experts=1, first_k_dense=1, routed_scaling_factor=1.8,
        scoring_func="sigmoid", n_group=2, topk_group=1,
        norm_topk_prob=True, index_n_heads=2, index_head_dim=16,
        index_topk=8, dtype=torch.float32),
}


def block_linear_names(cfg: GlmMoeDsaConfig) -> Tuple[str, ...]:
    """DeepSeek's names and the indexer's q / k (``weights_proj`` stays
    full precision)."""
    return deepseek.block_linear_names(cfg) + ("indexer.q_proj",
                                               "indexer.k_proj")


def init_params(cfg: GlmMoeDsaConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """:func:`deepseek.init_params` with an indexer added to each block as
    it is made: N(0, 0.02) weights for a layer that owns one, a copy of the
    governing layer's (the same tensors) for a shared layer.  ``park``
    takes each block once its indexer is in place."""
    dev = resolve_device(device)
    H = cfg.hidden_size
    nI, dI = cfg.index_n_heads, cfg.index_head_dim
    made = {"layers": 0, "governing": None}

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=cfg.dtype).mul_(0.02)

    def with_indexer(b):
        li = made["layers"]
        made["layers"] += 1
        if cfg.layer_has_indexer(li):
            b["indexer"] = {"q_proj": normal((nI * dI, H)),
                            "k_proj": normal((dI, H)),
                            "weights_proj": normal((nI, H))}
        elif made["governing"] is not None:
            b["indexer"] = dict(made["governing"])
        b = b if park is None else park(b)
        if cfg.layer_has_indexer(li):
            made["governing"] = b["indexer"]
        return b

    return deepseek.init_params(cfg, generator, dev, park=with_indexer)


def indexer_scores(weights, h: torch.Tensor, cos, sin, cfg: GlmMoeDsaConfig,
                   lf) -> torch.Tensor:
    """(B, S, H) normed hidden states → (B, S, S) fp32 indexer scores
    (before the mask)."""
    B, S, _ = h.shape
    nI, dI, dr = cfg.index_n_heads, cfg.index_head_dim, cfg.qk_rope_head_dim
    ix = weights["indexer"]
    q = lf("indexer.q_proj", h, ix["q_proj"]).reshape(B, S, nI, dI)
    k = lf("indexer.k_proj", h, ix["k_proj"]).reshape(B, S, 1, dI)
    if dI >= dr:
        def rot(t):
            return torch.cat([deepseek._rope_rotate(t[..., :dr], cos, sin,
                                                    cfg.rope_interleave),
                              t[..., dr:]], dim=-1)
        q, k = rot(q), rot(k)
    w = torch.einsum("bsh,nh->bsn", h.float(), ix["weights_proj"].float())
    logits = torch.einsum("bsnd,btd->bnst", q.float(), k[:, :, 0].float())
    return torch.einsum("bnst,bsn->bst", torch.clamp(logits, min=0.0), w)


def dsa_mask(scores: torch.Tensor, topk: int) -> torch.Tensor:
    """(B, S, T) indexer scores → (B, 1, S, T) fp32 additive bias: 0 where
    a query keeps a key (causal, and a score at least its k-th largest
    causal score, or the diagonal), -1e30 elsewhere.  A tie at the k-th
    value keeps every tied key."""
    B, S, T = scores.shape
    rows = torch.arange(S, device=scores.device)[:, None]
    cols = torch.arange(T, device=scores.device)[None, :]
    causal = cols <= rows + (T - S)
    s = scores.float()
    s = torch.where(causal[None], s, torch.full_like(s, float("-inf")))
    kth = torch.topk(s, min(topk, T), dim=-1).values[..., -1:]
    keep = ((s >= kth) | (cols == rows + (T - S))[None]) & causal[None]
    return torch.where(keep, 0.0, -1e30)[:, None]


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: GlmMoeDsaConfig,
              mask: Optional[torch.Tensor] = None, linear_fn=None,
              idx_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DeepSeek MLA block with its attention masked to the DSA subset.
    ``idx_mask`` is a mask threaded from an earlier indexer layer
    (:func:`model_fwd`); without it the block's own indexer runs (every
    block stores one).  ``mask``, when given, adds to it."""
    lf = linear_fn or llama._plain_linear
    B, S, _ = x.shape
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    if idx_mask is None:
        idx_mask = dsa_mask(indexer_scores(weights, h, cos, sin, cfg, lf),
                            cfg.index_topk)
    if mask is not None:
        idx_mask = idx_mask + mask.float()
    q, k, v, _, _ = mla_attention_inputs(weights, h, cos, sin, cfg, lf)
    attn = llama.attention(q, k, v, idx_mask, deepseek._attn_cfg(cfg))
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    return x + _ffn(weights, h, cfg, lf)


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: GlmMoeDsaConfig) -> torch.Tensor:
    """Full forward with the masks threaded: an indexer layer computes and
    publishes its mask, the layers after it reuse it."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = deepseek.rope_tables(cfg, input_ids.shape[1], device=x.device)
    carry = None
    for li, b in enumerate(params["blocks"]):
        if cfg.layer_has_indexer(li) and "indexer" in b:
            h = rms_norm(x, b["input_layernorm"], cfg.rms_eps)
            carry = dsa_mask(indexer_scores(b, h, cos, sin, cfg,
                                            llama._plain_linear),
                             cfg.index_topk)
        x = block_fwd(b, x, cos, sin, cfg, idx_mask=carry)
    return llama.final_fwd(params, x, cfg)
