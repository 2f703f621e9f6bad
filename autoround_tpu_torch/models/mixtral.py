"""Mixtral-family MoE decoder in PyTorch (counterpart of
``autoround_tpu/models/mixtral.py``): sparse top-k routed SwiGLU experts,
optionally a shared expert (Qwen2-MoE) and per-head q/k norms (Qwen3-MoE).

Experts are separate ``(O, I)`` leaves addressed as
``experts.<e>.<w1|w2|w3>``, so each quantizes on its own.  The router is a
plain linear and stays dense.

Expert compute takes one of three routes, as in the JAX package:

* per expert, dense-then-mask (the calibration default): every expert runs
  on every token through ``lf`` and the router's top-k weights gate the sum,
  accumulated in fp32 in expert order;
* grouped, dense-then-mask (serving with stacked experts): all experts run
  on the same token slab through ``lf.grouped`` (one grouped kernel launch
  per projection); each token's k routed rows are gathered, weighted and
  summed in fp32 in slot order (the JAX package contracts over the expert
  axis with an einsum whose other terms are zeros: the same sum in another
  order);
* capacity dispatch (``capacity_factor > 0``): tokens gather into fixed
  (E, C, H) slabs, C = ceil(N * k / E * factor); slots beyond an expert's
  capacity drop.  The combine sums each token's k kept contributions in
  slot order.

The three agree up to the order of fp32 sums.  The two grouped forms share
one combine (``_combine_slots``), so where the grouped kernel gives a token's
row the same bits whatever slab it sits in, and nothing drops, they give
the same bits.

Not ported: expert parallelism (``expert_offset`` / ``local_experts`` /
``expert_combine`` on the linear interceptor) raises
``NotImplementedError`` naming ROADMAP A15.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from . import llama
from .llama import LlamaConfig, rms_norm

__all__ = ["MixtralConfig", "CONFIG_PRESETS", "init_params", "block_fwd",
           "model_fwd", "block_linear_names", "capacity_slots",
           "capacity_dispatch"]


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    # Qwen2-MoE / DeepSeek-style always-on shared expert (0 = none);
    # ``intermediate_size`` is the routed experts' width
    shared_expert_intermediate: int = 0
    # sigmoid gate on the shared expert output (Qwen2-MoE)
    shared_expert_gate: bool = False
    # renormalize top-k router probs (Mixtral yes; Qwen2-MoE
    # norm_topk_prob=False)
    norm_topk_prob: bool = True


CONFIG_PRESETS: Dict[str, MixtralConfig] = {
    "tiny-moe": MixtralConfig(vocab_size=256, hidden_size=64,
                              intermediate_size=128, num_layers=2,
                              num_heads=4, num_kv_heads=2, num_experts=4,
                              top_k=2, rope_theta=10000.0,
                              dtype=torch.float32),
    "mixtral-8x7b": MixtralConfig(vocab_size=32000, hidden_size=4096,
                                  intermediate_size=14336, num_layers=32,
                                  num_heads=32, num_kv_heads=8,
                                  num_experts=8, top_k=2,
                                  rope_theta=1000000.0),
}

_EXPERT_WEIGHTS = ("w1", "w2", "w3")


def block_linear_names(cfg: MixtralConfig) -> Tuple[str, ...]:
    attn = ("q_proj", "k_proj", "v_proj", "o_proj")
    experts = tuple(f"experts.{e}.{w}" for e in range(cfg.num_experts)
                    for w in _EXPERT_WEIGHTS)
    shared = (tuple(f"shared_expert.{w}" for w in _EXPERT_WEIGHTS)
              if cfg.shared_expert_intermediate else ())
    return attn + experts + shared


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``).  The JAX package's tree and scales; the
    numbers differ (another generator).
    ``park(block)``, when given, takes each block as it is made and
    returns what the tree holds (e.g. the block moved to host memory), so
    the whole model is never on ``device`` at once; the numbers are the
    same."""
    dev = resolve_device(device)
    H, hd, I = cfg.hidden_size, cfg.hd, cfg.intermediate_size
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(std)

    def ones(n):
        return torch.ones((n,), dtype=cfg.dtype, device=dev)

    def mlp(width):
        return {"w1": normal((width, H)), "w2": normal((H, width), down_std),
                "w3": normal((width, H))}

    blocks = []
    for _ in range(cfg.num_layers):
        b = {"q_proj": normal((qd, H)), "k_proj": normal((kvd, H)),
             "v_proj": normal((kvd, H)), "o_proj": normal((H, qd)),
             "router": normal((cfg.num_experts, H)),
             "input_layernorm": ones(H),
             "post_attention_layernorm": ones(H)}
        if cfg.qk_norm:
            b["q_norm"], b["k_norm"] = ones(hd), ones(hd)
        b["experts"] = [mlp(I) for _ in range(cfg.num_experts)]
        if cfg.shared_expert_intermediate:
            b["shared_expert"] = mlp(cfg.shared_expert_intermediate)
            if cfg.shared_expert_gate:
                b["shared_expert_gate"] = normal((1, H))
        blocks.append(b if park is None else park(b))
    params = {"embed_tokens": normal((cfg.vocab_size, H)), "norm": ones(H),
              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def capacity_slots(topi: torch.Tensor, E: int,
                   C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each routing slot lands in its expert's slab.

    ``topi`` (..., k) expert ids; the N * k slots are taken flattened in
    token-major order and ranked first-come within their expert by a
    cumulative count.  Returns ``(keep, pos_c)``, both (N * k,): ``keep``
    is False for a slot ranked at or beyond the capacity ``C``; ``pos_c``
    is the slot's row in the slab, ``C`` (the spill row) for a dropped
    slot."""
    e_idx = topi.reshape(-1)
    # one-hot by comparison: F.one_hot may check its input's range on the
    # host, which a captured CUDA graph cannot do
    oh = (e_idx[:, None] == torch.arange(E, device=e_idx.device)).to(
        torch.int32)                                       # (N*k, E)
    pos_e = (torch.cumsum(oh, dim=0) * oh).sum(dim=1) - 1
    keep = pos_e < C
    return keep, torch.where(keep, pos_e, torch.full_like(pos_e, C))


def _combine_slots(rows: torch.Tensor, weights: torch.Tensor,
                   k: int) -> torch.Tensor:
    """(N * k, H) fp32 expert rows in token-major slot order, (N * k,)
    weights → (N, H): each token's k weighted rows summed in slot order."""
    contrib = rows * weights[:, None]
    return contrib.reshape(-1, k, rows.shape[-1]).sum(dim=1)


def capacity_dispatch(h: torch.Tensor, topi: torch.Tensor,
                      topv: torch.Tensor, E: int, capacity_factor: float,
                      apply_expert: Callable,
                      grouped_apply: Optional[Callable] = None,
                      expert_offset: int = 0, n_global_experts: int = 0,
                      scale_input: bool = False) -> torch.Tensor:
    """Capacity-based MoE dispatch: tokens gather into fixed (E, C, H)
    slabs, each expert runs on C tokens instead of all N (C = ceil(N * k / E
    * factor)); slots beyond an expert's capacity drop (the standard MoE
    capacity approximation).

    ``apply_expert(e, xb) -> yb`` runs expert ``e`` on its (C, H) slab;
    ``grouped_apply(buf (E, C, H)) -> (E, C, H)``, when given, runs all
    experts in one grouped call instead.  The slab handed to either is a
    view of the (E, C + 1, H) buffer without its spill row.  Returns the
    routed output (B, S, H) in fp32: each token's k contributions, weighted
    by ``topv`` (0 for a dropped slot), summed in slot order (the JAX
    package scatter-adds them; for k = 2 the two sums are the same
    number).  ``scale_input=True`` (Llama4 routing) multiplies each slot's
    input row by its ``topv`` in fp32 instead, and the combine weights the
    kept slots by 1."""
    if expert_offset or n_global_experts not in (0, E):
        raise NotImplementedError(
            "capacity_dispatch: expert parallelism (expert_offset / "
            "n_global_experts) is not ported yet (ROADMAP A15)")
    B, S, H = h.shape
    k = topi.shape[-1]
    N = B * S
    C = max(1, int(np.ceil(N * k / E * capacity_factor)))
    e_idx = topi.reshape(N * k)
    keep, pos_c = capacity_slots(topi, E, C)
    n_idx = torch.arange(N, device=h.device).repeat_interleave(k)
    w_slot = topv.reshape(N * k).float()
    vals = h.reshape(N, H)[n_idx]
    if scale_input:
        vals = (vals.float() * w_slot[:, None]).to(h.dtype)
    buf = h.new_zeros((E, C + 1, H))                 # row C: the spill row
    buf[e_idx, pos_c] = vals
    if grouped_apply is not None:
        ys = grouped_apply(buf[:, :C])
    else:
        ys = torch.stack([apply_expert(e, buf[e, :C]) for e in range(E)])
    w_comb = keep.float() if scale_input else w_slot * keep.float()
    return _combine_slots(ys[e_idx, pos_c.clamp(0, C - 1)].float(), w_comb,
                          k).reshape(B, S, H)


def _swiglu(lf, prefix: str, w: Dict[str, torch.Tensor], x: torch.Tensor):
    gate = F.silu(lf(f"{prefix}.w1", x, w["w1"]))
    up = lf(f"{prefix}.w3", x, w["w3"])
    return lf(f"{prefix}.w2", gate * up, w["w2"])


def _moe_mlp(weights: Dict[str, Any], h: torch.Tensor, cfg: MixtralConfig,
             lf: Callable, capacity_factor: float = 0.0) -> torch.Tensor:
    """Top-k routed SwiGLU experts (the module docstring names the three
    routes).  ``capacity_factor == 0``: dense-then-mask, exact;
    ``> 0``: capacity dispatch.  The grouped forms are taken when
    ``lf.grouped_names`` holds all of w1 / w2 / w3.

    Router logits go through ``lf("router", ...)`` in the model dtype, the
    softmax runs in fp32.  Ties: ``torch.topk`` does not promise which of
    two equal probabilities it returns first, while ``jax.lax.top_k``
    returns the lower index; with equal probabilities at the k-th place the
    two packages may route a token to different experts (fp32 softmax
    outputs of real activations do not tie)."""
    if any(hasattr(lf, a) for a in ("expert_offset", "local_experts",
                                    "expert_combine")):
        raise NotImplementedError(
            "_moe_mlp: expert parallelism (expert_offset / local_experts / "
            "expert_combine) is not ported yet (ROADMAP A15)")
    B, S, H = h.shape
    E, k = cfg.num_experts, cfg.top_k
    router_logits = lf("router", h, weights["router"])           # (B, S, E)
    probs = torch.softmax(router_logits.float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)

    use_grouped = set(_EXPERT_WEIGHTS) <= set(
        getattr(lf, "grouped_names", frozenset()))

    def grouped_swiglu(buf):                      # (E, C, H) → (E, C, H)
        mid = F.silu(lf.grouped("w1", buf)) * lf.grouped("w3", buf)
        return lf.grouped("w2", mid)

    if capacity_factor and capacity_factor > 0:
        out = capacity_dispatch(
            h, topi, topv, E, capacity_factor,
            lambda e, xb: _swiglu(lf, f"experts.{e}", weights["experts"][e],
                                  xb),
            grouped_apply=grouped_swiglu if use_grouped else None)
    elif use_grouped:
        # every expert runs the full token slab; the slab is shared (expert
        # stride 0), not copied E times
        N = B * S
        ys = grouped_swiglu(h.reshape(1, N, H).expand(E, N, H))
        n_idx = torch.arange(N, device=h.device).repeat_interleave(k)
        out = _combine_slots(ys[topi.reshape(N * k), n_idx].float(),
                             topv.reshape(N * k).float(), k).reshape(B, S, H)
    else:
        out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e, ew in enumerate(weights["experts"]):
            y = _swiglu(lf, f"experts.{e}", ew, h).float()
            # weight of expert e per token (0 when not in its top-k)
            w_e = torch.where(topi == e, topv,
                              torch.zeros_like(topv)).sum(dim=-1)
            out = out + y * w_e[..., None]
    if "shared_expert" in weights:
        y = _swiglu(lf, "shared_expert", weights["shared_expert"], h).float()
        if "shared_expert_gate" in weights:
            y = y * torch.sigmoid(
                lf("shared_expert_gate", h,
                   weights["shared_expert_gate"]).float())
        out = out + y
    return out.to(h.dtype)


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: MixtralConfig,
              mask: Optional[torch.Tensor] = None,
              linear_fn=None) -> torch.Tensor:
    """One decoder block: pre-norm attention + pre-norm routed experts
    (dense-then-mask: calibration semantics)."""
    lf = linear_fn or llama._plain_linear
    B, S, H = x.shape
    hd = cfg.hd
    off = cfg.norm_offset                    # 0 for this family
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps, off)
    q = lf("q_proj", h, weights["q_proj"], weights.get("q_bias"))
    k = lf("k_proj", h, weights["k_proj"], weights.get("k_bias"))
    v = lf("v_proj", h, weights["v_proj"], weights.get("v_bias"))
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:                          # Qwen3-MoE
        q = rms_norm(q, weights["q_norm"], cfg.rms_eps, off)
        k = rms_norm(k, weights["k_norm"], cfg.rms_eps, off)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)
    attn = llama.attention(q, k, v, mask, cfg).reshape(B, S, -1)
    x = x + lf("o_proj", attn, weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps, off)
    return x + _moe_mlp(weights, h, cfg, lf)


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: MixtralConfig) -> torch.Tensor:
    """Full forward → logits."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = llama.rope_tables(cfg, input_ids.shape[1], device=x.device)
    for b in params["blocks"]:
        x = block_fwd(b, x, cos, sin, cfg)
    return llama.final_fwd(params, x, cfg)
