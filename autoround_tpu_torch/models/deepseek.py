"""DeepSeek V2 / V3 decoder in PyTorch (counterpart of
``autoround_tpu/models/deepseek.py``): MLA attention and DeepSeek-MoE.

* **MLA (multi-head latent attention)**: queries optionally LoRA-compressed
  (``q_a_proj`` / ``q_b_proj``), keys and values jointly compressed to
  ``kv_lora_rank`` plus one shared rope sub-head.  Every projection is an
  ordinary ``(O, I)`` linear leaf, so the whole MLA stack quantizes and
  tunes through the linear interceptor like any other layer.
* **DeepSeek-MoE**: ``first_k_dense`` dense blocks, then routed experts
  with sigmoid (V3) or softmax (V2) scores, the aux-free bias
  (``e_score_correction_bias``, fp32, selection only), group-limited top-k
  (``n_group`` / ``topk_group``), ``routed_scaling_factor`` and always-on
  shared experts.  Expert compute takes the three routes of
  :mod:`.mixtral`: per expert dense-then-mask, grouped dense-then-mask
  (``lf.grouped``) and capacity dispatch.

The serving block (:func:`block_with_cache`) caches the compressed latents
(``c_kv`` and the roped ``k_rope``, ``r + dr`` values a token) and decodes
by weight absorption: ``q_nope`` is pushed through ``kv_b_proj``'s key half
once a step, so attention runs in latent space over the compressed cache.
The prompt pass decompresses and runs the plain attention; neither form
reaches the flash kernel (q/k heads are 192 wide, v heads 128, and the
score scale is set), as in the JAX package.

Top-k: ``jax.lax.top_k`` returns the lower index first on a tie, which
``torch.topk`` does not promise; :func:`_top_k` sorts stably instead, so
the group and expert choices equal the JAX package's even where the
masked groups' zeros tie.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import llama
from .llama import LlamaConfig, rms_norm
from .mixtral import _combine_slots, capacity_dispatch

__all__ = ["DeepseekConfig", "CONFIG_PRESETS", "init_params", "block_fwd",
           "block_with_cache", "model_fwd", "block_linear_names",
           "rope_tables", "mla_attention_inputs", "is_mla"]


@dataclass(frozen=True)
class DeepseekConfig(LlamaConfig):
    # --- MLA ---
    q_lora_rank: int = 0             # 0 → plain q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_interleave: bool = True     # HF DeepseekV3 default
    mscale: float = 1.0              # yarn mscale (squared into the scale)
    # --- yarn rope_scaling (HF DeepseekV2YarnRotaryEmbedding) ---
    yarn_factor: float = 0.0         # 0 → plain rope (no interpolation)
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_original_max_pos: int = 4096
    yarn_mscale: float = 1.0         # rope_scaling["mscale"]
    yarn_mscale_all_dim: float = 0.0  # rope_scaling["mscale_all_dim"]
    # --- MoE ---
    n_routed_experts: int = 0        # 0 → dense MLP every layer
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0        # shared width = n * moe_intermediate
    first_k_dense: int = 1
    routed_scaling_factor: float = 1.0
    scoring_func: str = "sigmoid"    # V3 "sigmoid" | V2 "softmax"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def layer_is_moe(self, li: int) -> bool:
        return self.n_routed_experts > 0 and li >= self.first_k_dense


CONFIG_PRESETS: Dict[str, DeepseekConfig] = {
    # V3-style: sigmoid router + bias, group-limited top-k, q lora
    "tiny-deepseek": DeepseekConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=4, rope_theta=10000.0,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        n_shared_experts=1, first_k_dense=1, routed_scaling_factor=2.5,
        scoring_func="sigmoid", n_group=2, topk_group=1,
        norm_topk_prob=True, dtype=torch.float32),
    # V2-style: softmax router, no q lora, no grouping
    "tiny-deepseek-v2": DeepseekConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=4, rope_theta=10000.0,
        q_lora_rank=0, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        n_shared_experts=2, first_k_dense=1, routed_scaling_factor=1.0,
        scoring_func="softmax", norm_topk_prob=False, dtype=torch.float32),
    "deepseek-v2-lite": DeepseekConfig(
        vocab_size=102400, hidden_size=2048, intermediate_size=10944,
        num_layers=27, num_heads=16, num_kv_heads=16, rope_theta=10000.0,
        rms_eps=1e-6, q_lora_rank=0, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        n_routed_experts=64, num_experts_per_tok=6,
        moe_intermediate_size=1408, n_shared_experts=2, first_k_dense=1,
        routed_scaling_factor=1.0, scoring_func="softmax",
        norm_topk_prob=False),
    "deepseek-v3": DeepseekConfig(
        vocab_size=129280, hidden_size=7168, intermediate_size=18432,
        num_layers=61, num_heads=128, num_kv_heads=128, rope_theta=10000.0,
        rms_eps=1e-6, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        n_routed_experts=256, num_experts_per_tok=8,
        moe_intermediate_size=2048, n_shared_experts=1, first_k_dense=3,
        routed_scaling_factor=2.5, scoring_func="sigmoid", n_group=8,
        topk_group=4, norm_topk_prob=True),
}

_MLP = ("gate_proj", "up_proj", "down_proj")


def is_mla(cfg) -> bool:
    """Whether ``cfg`` serves through the MLA latent cache."""
    return isinstance(cfg, DeepseekConfig) and bool(cfg.kv_lora_rank)


def block_linear_names(cfg: DeepseekConfig) -> Tuple[str, ...]:
    """Union of the quantizable linear names over the blocks (the dense
    first-k blocks lack the expert leaves: the API prunes the plan per
    block, ``quantize.layer_config.prune_missing_layers``)."""
    attn = (("q_a_proj", "q_b_proj") if cfg.q_lora_rank else ("q_proj",))
    attn += ("kv_a_proj_with_mqa", "kv_b_proj", "o_proj")
    names = attn + _MLP
    if cfg.n_routed_experts:
        names += tuple(f"experts.{e}.{w}"
                       for e in range(cfg.n_routed_experts) for w in _MLP)
        if cfg.n_shared_experts:
            names += tuple(f"shared_experts.{w}" for w in _MLP)
    return names


def init_params(cfg: DeepseekConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree and scales, with the
    fp32 ``e_score_correction_bias`` at zero; the numbers differ (another
    generator).  ``park(block)``, when given, takes each block as it is
    made and returns what the tree holds (see ``llama.init_params``)."""
    dev = resolve_device(device)
    H = cfg.hidden_size
    nh, dq, dv = cfg.num_heads, cfg.qk_head_dim, cfg.v_head_dim
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(std)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=dev)

    def mlp(width):
        return {"gate_proj": normal((width, H)), "up_proj": normal((width, H)),
                "down_proj": normal((H, width), down_std)}

    blocks = []
    for li in range(cfg.num_layers):
        b: Dict[str, Any] = {
            "kv_a_proj_with_mqa": normal((r + dr, H)),
            "kv_a_layernorm": ones(r),
            "kv_b_proj": normal((nh * (cfg.qk_nope_head_dim + dv), r)),
            "o_proj": normal((H, nh * dv), down_std),
            "input_layernorm": ones(H),
            "post_attention_layernorm": ones(H),
        }
        if cfg.q_lora_rank:
            b["q_a_proj"] = normal((cfg.q_lora_rank, H))
            b["q_a_layernorm"] = ones(cfg.q_lora_rank)
            b["q_b_proj"] = normal((nh * dq, cfg.q_lora_rank))
        else:
            b["q_proj"] = normal((nh * dq, H))
        if cfg.layer_is_moe(li):
            mi = cfg.moe_intermediate_size
            b["gate"] = normal((cfg.n_routed_experts, H))
            if cfg.scoring_func == "sigmoid":
                b["e_score_correction_bias"] = torch.zeros(
                    (cfg.n_routed_experts,), dtype=torch.float32, device=dev)
            b["experts"] = [mlp(mi) for _ in range(cfg.n_routed_experts)]
            if cfg.n_shared_experts:
                b["shared_experts"] = mlp(mi * cfg.n_shared_experts)
        else:
            b.update(mlp(cfg.intermediate_size))
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": ones(H), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    """HF ``yarn_get_mscale``: 0.1 * mscale * ln(scale) + 1 for scale > 1."""
    if scale <= 1.0 or not mscale:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: DeepseekConfig, device: torch.device
              ) -> Tuple[torch.Tensor, float]:
    """(inv_freq (dr / 2,) fp32 on ``device``, the cos / sin factor): built
    in float64 with numpy as the JAX package does (yarn NTK-by-parts when
    ``yarn_factor > 1``), cast to fp32 and copied once per (config,
    device), so a captured decode step makes its tables on the device
    alone."""
    dr = cfg.qk_rope_head_dim
    inv_extra = 1.0 / (cfg.rope_theta ** (np.arange(0, dr, 2) / dr))
    att = 1.0
    if cfg.yarn_factor and cfg.yarn_factor > 1.0:
        inv_inter = inv_extra / cfg.yarn_factor

        def corr_dim(n_rot):
            return (dr * math.log(cfg.yarn_original_max_pos
                                  / (n_rot * 2 * math.pi))
                    ) / (2 * math.log(cfg.rope_theta))

        low = max(math.floor(corr_dim(cfg.yarn_beta_fast)), 0)
        high = min(math.ceil(corr_dim(cfg.yarn_beta_slow)), dr - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(dr // 2) - low) / (high - low), 0, 1)
        extra_f = 1.0 - ramp                     # 1 → keep original freq
        inv_freq = inv_inter * (1 - extra_f) + inv_extra * extra_f
        att = (_yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale)
               / _yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    else:
        inv_freq = inv_extra
    return torch.as_tensor(inv_freq.astype(np.float32), device=device), att


def rope_tables(cfg: DeepseekConfig, seqlen: int,
                positions: Optional[torch.Tensor] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin (seqlen, dr) fp32 over the rope sub-head
    (``qk_rope_head_dim`` wide), half-split convention.  With ``yarn_factor
    > 1`` the frequencies are HF ``DeepseekV2YarnRotaryEmbedding``'s
    NTK-by-parts blend and the tables carry ``yarn_get_mscale(factor,
    mscale) / yarn_get_mscale(factor, mscale_all_dim)`` (1 for the
    published configs); the ``mscale_all_dim`` score correction rides in
    ``cfg.mscale``.  ``positions`` (S,) overrides ``arange(seqlen)``; a
    decode step passes its (B,) per-slot positions and gets a row a slot."""
    if positions is None:
        positions = torch.arange(seqlen, device=device)
    inv, att = _inv_freq(cfg, positions.device)
    ang = positions[..., None].float() * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if att != 1.0:
        cos, sin = cos * att, sin * att
    return cos, sin


def _rope_rotate(x: torch.Tensor, cos, sin, interleave: bool) -> torch.Tensor:
    """Rope on (B, S, n, dr); ``interleave`` first permutes the even / odd
    element pairs into halves (HF ``apply_rotary_pos_emb_interleave``: q and
    k get the same permutation, so scores are invariant)."""
    if interleave:
        x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return llama.apply_rope(x, cos, sin)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first on a tie (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(h: torch.Tensor, weights, cfg: DeepseekConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek router → (top-k expert ids, their weights) per token.

    V3 (``sigmoid``): scores = sigmoid(logits); the selection adds the
    aux-free ``e_score_correction_bias`` and is group-limited (keep
    ``topk_group`` groups by the sum of their top 2), but the mixing
    weights are the unbiased scores.  V2 (``softmax``): softmax scores,
    groups by their max.  Logits, scores and weights are fp32; a masked
    group's choices are 0 (not -inf), as in the JAX package."""
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    logits = torch.einsum("...h,eh->...e", h.float(),
                          weights["gate"].float())
    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    choice = scores
    if "e_score_correction_bias" in weights:
        choice = choice + weights["e_score_correction_bias"].float()
    if cfg.n_group > 1:
        gsz = E // cfg.n_group
        grouped = choice.reshape(*choice.shape[:-1], cfg.n_group, gsz)
        k_g = 2 if cfg.scoring_func == "sigmoid" else 1
        g_scores = _top_k(grouped, k_g)[0].sum(dim=-1)
        g_idx = _top_k(g_scores, cfg.topk_group)[1]
        # the kept groups by comparison (no host-side range check)
        g_mask = (g_idx[..., None] == torch.arange(
            cfg.n_group, device=h.device)).any(dim=-2)
        keep = g_mask.repeat_interleave(gsz, dim=-1)
        choice = torch.where(keep, choice, torch.zeros_like(choice))
    topi = _top_k(choice, k)[1]
    topw = torch.gather(scores, -1, topi)
    if cfg.norm_topk_prob:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
    return topi, topw * cfg.routed_scaling_factor


def _mlp(weights, h, cfg, lf, prefix: str = ""):
    act = llama._act(cfg.hidden_act)
    gate = act(lf(f"{prefix}gate_proj", h, weights["gate_proj"]))
    up = lf(f"{prefix}up_proj", h, weights["up_proj"])
    return lf(f"{prefix}down_proj", gate * up, weights["down_proj"])


def _moe_mlp(weights, h: torch.Tensor, cfg: DeepseekConfig, lf,
             capacity_factor: float = 0.0) -> torch.Tensor:
    """Routed experts plus the always-on shared experts.

    ``capacity_factor == 0``: dense-then-mask (exact; the calibration
    default), grouped when ``lf.grouped_names`` holds the whole gate / up /
    down triple: every expert runs the token slab (shared, expert stride
    0) and each token's k routed rows are gathered and summed in slot order
    (``mixtral._combine_slots``; the JAX package contracts a scatter-added
    (N, E) weight table over the expert axis: the same sum in another
    order, and deterministic here, so a replayed step gives the eager
    step's bits).  ``> 0``: capacity dispatch (``mixtral.
    capacity_dispatch``)."""
    if any(hasattr(lf, a) for a in ("expert_offset", "local_experts",
                                    "expert_combine")):
        raise NotImplementedError(
            "_moe_mlp: expert parallelism (expert_offset / local_experts / "
            "expert_combine) is not ported yet (ROADMAP A15)")
    topi, topw = _route(h, weights, cfg)
    B, S, H = h.shape
    E, k = cfg.n_routed_experts, topi.shape[-1]
    use_grouped = set(_MLP) <= set(getattr(lf, "grouped_names", frozenset()))
    act = llama._act(cfg.hidden_act)

    def grouped_mlp(buf):                         # (E, C, H) → (E, C, H)
        mid = act(lf.grouped("gate_proj", buf)) * lf.grouped("up_proj", buf)
        return lf.grouped("down_proj", mid)

    if capacity_factor and capacity_factor > 0:
        out = capacity_dispatch(
            h, topi, topw, E, capacity_factor,
            lambda e, xb: _mlp(weights["experts"][e], xb[None], cfg, lf,
                               prefix=f"experts.{e}.")[0],
            grouped_apply=grouped_mlp if use_grouped else None)
    elif use_grouped:
        N = B * S
        ys = grouped_mlp(h.reshape(1, N, H).expand(E, N, H))
        n_idx = torch.arange(N, device=h.device).repeat_interleave(k)
        out = _combine_slots(ys[topi.reshape(N * k), n_idx].float(),
                             topw.reshape(N * k), k).reshape(B, S, H)
    else:
        out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e, ew in enumerate(weights["experts"]):
            y = _mlp(ew, h, cfg, lf, prefix=f"experts.{e}.").float()
            w_e = torch.where(topi == e, topw,
                              torch.zeros_like(topw)).sum(dim=-1)
            out = out + y * w_e[..., None]
    if "shared_experts" in weights:
        out = out + _mlp(weights["shared_experts"], h, cfg, lf,
                         prefix="shared_experts.").float()
    return out.to(h.dtype)


def _queries(weights, h, cfg: DeepseekConfig, lf):
    """h → q (B, S, nh, dn + dr), through the q LoRA when the config has
    one."""
    B, S, _ = h.shape
    if cfg.q_lora_rank:
        qa = lf("q_a_proj", h, weights["q_a_proj"])
        qa = rms_norm(qa, weights["q_a_layernorm"], cfg.rms_eps)
        q = lf("q_b_proj", qa, weights["q_b_proj"])
    else:
        q = lf("q_proj", h, weights["q_proj"])
    return q.reshape(B, S, cfg.num_heads, cfg.qk_head_dim)


def _latents(weights, h, cos, sin, cfg: DeepseekConfig, lf):
    """h → (c_kv (B, S, r) normed latent, k_rope (B, S, 1, dr) roped
    shared sub-head): what the serving cache stores."""
    B, S, _ = h.shape
    r = cfg.kv_lora_rank
    ckv = lf("kv_a_proj_with_mqa", h, weights["kv_a_proj_with_mqa"])
    c_kv = rms_norm(ckv[..., :r], weights["kv_a_layernorm"], cfg.rms_eps)
    k_rope = _rope_rotate(ckv[..., r:].reshape(B, S, 1, -1), cos, sin,
                          cfg.rope_interleave)
    return c_kv, k_rope


def mla_attention_inputs(weights, h, cos, sin, cfg: DeepseekConfig, lf):
    """The MLA head math: h → (q, k, v, c_kv, k_rope); q and k are
    (B, S, nh, dn + dr), v (B, S, nh, dv)."""
    B, S, _ = h.shape
    nh, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q = _queries(weights, h, cfg, lf)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = _rope_rotate(q_rope, cos, sin, cfg.rope_interleave)
    c_kv, k_rope = _latents(weights, h, cos, sin, cfg, lf)
    kv = lf("kv_b_proj", c_kv, weights["kv_b_proj"]).reshape(B, S, nh,
                                                             dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(B, S, nh, k_rope.shape[-1])],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, c_kv, k_rope


def _attn_cfg(cfg: DeepseekConfig):
    """``llama.attention`` divides the scores by ``attn_scale``; MLA
    multiplies them by mscale² / sqrt(qk_head_dim)."""
    return dataclasses.replace(
        cfg, attn_scale=float(np.sqrt(cfg.qk_head_dim)) / (cfg.mscale ** 2))


def _ffn(weights, h, cfg: DeepseekConfig, lf, capacity_factor: float = 0.0):
    if "experts" in weights:
        return _moe_mlp(weights, h, cfg, lf, capacity_factor)
    return _mlp(weights, h, cfg, lf)


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: DeepseekConfig,
              mask: Optional[torch.Tensor] = None,
              linear_fn=None) -> torch.Tensor:
    """One decoder block: pre-norm MLA attention (decompressed, plain
    attention) + pre-norm dense MLP or routed experts (dense-then-mask)."""
    lf = linear_fn or llama._plain_linear
    B, S, H = x.shape
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    q, k, v, _, _ = mla_attention_inputs(weights, h, cos, sin, cfg, lf)
    attn = llama.attention(q, k, v, mask, _attn_cfg(cfg))
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    return x + _ffn(weights, h, cfg, lf)


def _latent_codes(t: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """clip(t / s, ±qmax), rounded for int8, cast to the cache's dtype (the
    JAX block's in-step quantization of the new token's latents)."""
    qmax = 127.0 if dtype == torch.int8 else 448.0
    y = torch.clamp(t.float() / s, -qmax, qmax)
    if dtype == torch.int8:
        y = torch.round(y)
    return y.to(dtype)


def block_with_cache(weights, x: torch.Tensor, cos, sin, cfg: DeepseekConfig,
                     kv, pos, lf, moe_capacity_factor: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decoder block for serving: ``(out, c_kv (B, S, r), k_rope (B, S, 1,
    dr))``, the JAX ``block_with_cache``.

    ``kv`` None: the prompt pass (decompressed plain causal attention).
    Otherwise one decode token per slot over the latent cache: ``kv`` is
    ``(ckv_all (B, T, 1, r), kr_all (B, T, 1, dr))`` in the model dtype, or
    ``(kv_quant, ckv_all, kr_all, cs, rs)`` with int8 / e4m3 latents and
    per-layer scalar scales, folded into the score terms and the context
    (no dequantized copy).  The step's latents are written into the cache
    in place at ``pos`` (a (B,) int32 tensor on the device, slot b at
    ``pos[b]``; a 0-d position is every slot's), quantized with the same
    scales where the cache is, and slot b attends over [0, pos[b]].

    The absorbed decode: ``q_lat = q_nope · W_k`` (``kv_b_proj``'s key
    half, per head), scores ``(q_lat · c_kv + q_rope · k_rope) * mscale² /
    sqrt(qk_head_dim)`` (a product here, a division in :func:`block_fwd`, as
    in the JAX package), softmax in fp32, the context ``probs · c_kv``
    through ``W_v``.  ``kv_b_proj`` is read as a dense weight."""
    B, S, H = x.shape
    nh, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    if kv is None:
        q, k, v, c_kv, k_rope = mla_attention_inputs(weights, h, cos, sin,
                                                     cfg, lf)
        attn = llama.attention(q, k, v, None, _attn_cfg(cfg))
    else:
        if isinstance(kv[0], str):
            _, ckv_all, kr_all, cs, rs = kv
        else:
            ckv_all, kr_all = kv
            cs = rs = None
        T = ckv_all.shape[1]
        q = _queries(weights, h, cfg, lf)
        q_nope = q[..., :dn]
        q_rope = _rope_rotate(q[..., dn:], cos, sin, cfg.rope_interleave)
        c_kv, k_rope = _latents(weights, h, cos, sin, cfg, lf)
        if cs is not None:
            c_tok = _latent_codes(c_kv, cs, ckv_all.dtype)
            r_tok = _latent_codes(k_rope[:, :, 0], rs, kr_all.dtype)
        else:
            c_tok = c_kv.to(ckv_all.dtype)
            r_tok = k_rope[:, :, 0].to(kr_all.dtype)
        slots = torch.arange(B, device=x.device)
        if pos.ndim == 0:
            pos = pos.expand(B)
        ckv_all[slots, pos] = c_tok[:, :1]          # (B, 1, r)
        kr_all[slots, pos] = r_tok[:, :1]
        f32 = torch.float32
        wkb = weights["kv_b_proj"].reshape(nh, dn + dv, r)
        ckv_f = ckv_all[:, :, 0].to(f32)            # (B, T, r)
        q_lat = torch.einsum("bnd,ndr->bnr", q_nope[:, 0].to(f32),
                             wkb[:, :dn].to(f32))
        s_lat = torch.einsum("bnr,btr->bnt", q_lat, ckv_f)
        s_rope = torch.einsum("bnd,btd->bnt", q_rope[:, 0].to(f32),
                              kr_all[:, :, 0].to(f32))
        if cs is not None:
            s_lat = s_lat * cs
            s_rope = s_rope * rs
        scale = (cfg.mscale ** 2) / float(np.sqrt(cfg.qk_head_dim))
        scores = (s_lat + s_rope) * scale
        valid = (torch.arange(T, device=x.device)[None, :]
                 <= pos[:, None])[:, None, :]
        scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)       # (B, nh, T)
        ctx = torch.einsum("bnt,btr->bnr", probs, ckv_f)
        if cs is not None:
            ctx = ctx * cs
        attn = torch.einsum("bnr,nvr->bnv", ctx, wkb[:, dn:].to(f32))
        attn = attn[:, None].to(x.dtype)            # (B, 1, nh, dv)
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    return x + _ffn(weights, h, cfg, lf, moe_capacity_factor), c_kv, k_rope


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: DeepseekConfig) -> torch.Tensor:
    """Full forward → logits."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = rope_tables(cfg, input_ids.shape[1], device=x.device)
    for b in params["blocks"]:
        x = block_fwd(b, x, cos, sin, cfg)
    return llama.final_fwd(params, x, cfg)
