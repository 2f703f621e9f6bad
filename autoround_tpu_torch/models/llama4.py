"""Llama 4 text decoder in PyTorch (counterpart of
``autoround_tpu/models/llama4.py``): interleaved rope / NoPE layers, chunked
attention, the L2 q/k norm, temperature-tuned NoPE queries and input-scaled
MoE.

* **NoPE layers**: a layer whose ``no_rope_layers`` entry is 0 skips rope;
  with ``attn_temperature_tuning`` its queries scale by
  ``log1p(floor((pos + 1) / floor_scale)) * temp_attn_scale + 1`` at each
  token's position (HF ``Llama4TextAttention``).
* **Chunked attention**: rope layers attend block-diagonally within
  ``sliding_window``-sized chunks, causal inside a chunk
  (``chunked_attention=True`` on the shared sliding-window machinery, so a
  rope layer is a "sliding" layer of ``llama.layer_is_sliding``).
* **L2 q/k norm** (weightless) after rope, on rope layers only.
* **Input-scaled MoE**: the router's selected experts (``logits >= `` the
  k-th largest logit, so a tie selects more than k) take sigmoid scores
  that scale each expert's *input*; an unselected expert sees zeros and
  gives zeros (SwiGLU without bias).  A dense shared expert always adds.
  Dense layers (not in ``moe_layers``) run an MLP of
  ``intermediate_size_mlp``.
* Rope is the complex-pair form, applied as the interleave permutation
  followed by half-split rope (q and k share the permutation, and the L2
  norm does not see it).

Expert compute takes the three routes of :mod:`.mixtral`: per expert, the
grouped kernel over the (E, N, H) slab of scaled inputs summed over the
experts, and capacity dispatch with ``scale_input``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import llama
from .deepseek import _top_k
from .llama import LlamaConfig, rms_norm
from .mixtral import capacity_dispatch

__all__ = ["Llama4Config", "CONFIG_PRESETS", "init_params", "block_fwd",
           "block_fwd_for", "model_fwd", "block_linear_names",
           "layer_uses_rope", "nope_temperature", "attention_inputs"]


@dataclass(frozen=True)
class Llama4Config(LlamaConfig):
    num_experts: int = 16
    top_k: int = 1
    # dense layers (and nothing else) use intermediate_size_mlp;
    # intermediate_size is the routed / shared expert width
    intermediate_size_mlp: int = 16384
    moe_layers: Tuple[int, ...] = ()
    # 1 = rope layer, 0 = NoPE (HF no_rope_layers); rope layers attend
    # chunked (the chunk size rides on sliding_window)
    no_rope_layers: Tuple[int, ...] = ()
    chunked_attention: bool = True
    use_qk_norm: bool = True            # weightless L2 norm on rope layers
    attn_temperature_tuning: bool = True
    floor_scale: float = 8192.0
    temp_attn_scale: float = 0.1


def _mk_layers(n, nope_every=4, moe_step=1):
    no_rope = tuple(0 if (i + 1) % nope_every == 0 else 1 for i in range(n))
    moe = tuple(i for i in range(n) if (i + 1) % moe_step == 0)
    return no_rope, moe


CONFIG_PRESETS: Dict[str, Llama4Config] = {
    "tiny-llama4": Llama4Config(
        vocab_size=256, hidden_size=64, intermediate_size=64,
        intermediate_size_mlp=128, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=16, rope_theta=10000.0, rms_eps=1e-5,
        num_experts=4, top_k=2, moe_layers=(0, 2),
        no_rope_layers=(1, 1, 1, 0), sliding_window=8,
        layer_types=("sliding_attention", "sliding_attention",
                     "sliding_attention", "full_attention"),
        dtype=torch.float32),
    "llama4-scout-16e": Llama4Config(
        vocab_size=202048, hidden_size=5120, intermediate_size=8192,
        intermediate_size_mlp=16384, num_layers=48, num_heads=40,
        num_kv_heads=8, head_dim=128, rope_theta=500000.0, rms_eps=1e-5,
        num_experts=16, top_k=1,
        moe_layers=tuple(range(48)),
        no_rope_layers=_mk_layers(48)[0], sliding_window=8192,
        layer_types=tuple(
            "sliding_attention" if r else "full_attention"
            for r in _mk_layers(48)[0])),
}

_MLP = ("gate_proj", "up_proj", "down_proj")


def block_linear_names(cfg: Llama4Config) -> Tuple[str, ...]:
    """Union of the quantizable linear names over the blocks (a dense
    block has the MLP, a MoE block the experts and the shared expert: the
    API prunes the plan per block)."""
    names = ("q_proj", "k_proj", "v_proj", "o_proj") + _MLP
    if cfg.moe_layers:
        names += tuple(f"experts.{e}.{w}"
                       for e in range(cfg.num_experts) for w in _MLP)
        names += tuple(f"shared_expert.{w}" for w in _MLP)
    return names


def init_params(cfg: Llama4Config, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree and scales (a block in
    ``moe_layers`` holds ``router``, ``experts`` and ``shared_expert``, any
    other the dense MLP); the numbers differ (another generator).
    ``park(block)``, when given, takes each block as it is made and returns
    what the tree holds (see ``llama.init_params``)."""
    dev = resolve_device(device)
    H, hd = cfg.hidden_size, cfg.hd
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
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
            "q_proj": normal((qd, H)), "k_proj": normal((kvd, H)),
            "v_proj": normal((kvd, H)), "o_proj": normal((H, qd), down_std),
            "input_layernorm": ones(H), "post_attention_layernorm": ones(H),
        }
        if li in cfg.moe_layers:
            b["router"] = normal((cfg.num_experts, H))
            b["experts"] = [mlp(cfg.intermediate_size)
                            for _ in range(cfg.num_experts)]
            b["shared_expert"] = mlp(cfg.intermediate_size)
        else:
            b.update(mlp(cfg.intermediate_size_mlp))
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": ones(H), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def _interleave(x: torch.Tensor) -> torch.Tensor:
    """Even / odd element pairs → halves (the complex rope basis; q and k
    share the permutation, so the scores are exact)."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                             + eps)).to(x.dtype)


def nope_temperature(cfg: Llama4Config, pos: torch.Tensor) -> torch.Tensor:
    """The NoPE query scale at positions ``pos`` (any shape, on the
    device): log1p(floor((pos + 1) / floor_scale)) * temp_attn_scale + 1,
    fp32.  A captured decode step computes it from its device positions."""
    return (torch.log1p(torch.floor((pos.float() + 1.0) / cfg.floor_scale))
            * cfg.temp_attn_scale + 1.0)


def attention_inputs(q, k, cfg: Llama4Config, use_rope: bool, cos, sin,
                     pos: Optional[torch.Tensor] = None):
    """q (B, S, nh, hd), k (B, S, nkv, hd) after the layer's position
    treatment: a rope layer interleaves, ropes and L2-norms both; a NoPE
    layer scales q by :func:`nope_temperature` at ``pos`` (None: the
    prompt's arange(S); (B,): one position a slot, S = 1)."""
    if use_rope:
        q = llama.apply_rope(_interleave(q), cos, sin)
        k = llama.apply_rope(_interleave(k), cos, sin)
        if cfg.use_qk_norm:
            q = _l2_norm(q, cfg.rms_eps)
            k = _l2_norm(k, cfg.rms_eps)
    elif cfg.attn_temperature_tuning:
        S = q.shape[1]
        if pos is None:
            ts = nope_temperature(cfg, torch.arange(S, device=q.device))
            ts = ts.reshape(1, S, 1, 1)
        else:
            ts = nope_temperature(cfg, pos).reshape(-1, 1, 1, 1)
        q = (q.float() * ts).to(q.dtype)
    return q, k


def _swiglu(lf, prefix: str, w, x, act):
    gate = act(lf(f"{prefix}gate_proj", x, w["gate_proj"]))
    up = lf(f"{prefix}up_proj", x, w["up_proj"])
    return lf(f"{prefix}down_proj", gate * up, w["down_proj"])


def _route(weights, h: torch.Tensor, cfg: Llama4Config):
    """(top-k ids, top-k logits, (..., E) input scores): the fp32 router
    logits' top-k (a stable sort, the lower index first on a tie, as
    ``jax.lax.top_k``), and the sigmoid of every logit at least the k-th
    largest (zero elsewhere)."""
    logits = torch.einsum("...h,eh->...e", h.float(),
                          weights["router"].float())
    topv, topi = _top_k(logits, cfg.top_k)
    selected = logits >= topv[..., -1:]          # the smallest kept logit
    return topi, topv, torch.where(selected, torch.sigmoid(logits),
                                   torch.zeros_like(logits))


def _moe_mlp(weights: Dict[str, Any], h: torch.Tensor, cfg: Llama4Config,
             lf, capacity_factor: float = 0.0) -> torch.Tensor:
    """The Llama4 router: every expert whose logit is at least the k-th
    largest is selected (a tie selects more than k), its sigmoid score
    scales its input, the rest see zeros; plus the shared expert.
    ``capacity_factor > 0`` dispatches the top-k slots by capacity with
    ``scale_input``; otherwise dense, grouped when ``lf.grouped_names``
    holds gate / up / down (the (E, N, H) slab of scaled inputs, summed
    over the experts in fp32)."""
    if any(hasattr(lf, a) for a in ("expert_offset", "local_experts",
                                    "expert_combine")):
        raise NotImplementedError(
            "_moe_mlp: expert parallelism (expert_offset / local_experts / "
            "expert_combine) is not ported yet (ROADMAP A15)")
    act = llama._act(cfg.hidden_act)
    topi, topv, scores = _route(weights, h, cfg)
    E = cfg.num_experts
    use_grouped = set(_MLP) <= set(getattr(lf, "grouped_names", frozenset()))

    def grouped_swiglu(buf):                      # (E, C, H) → (E, C, H)
        mid = act(lf.grouped("gate_proj", buf)) * lf.grouped("up_proj", buf)
        return lf.grouped("down_proj", mid)

    if capacity_factor and capacity_factor > 0:
        out = capacity_dispatch(
            h, topi, torch.sigmoid(topv), E, capacity_factor,
            lambda e, xb: _swiglu(lf, f"experts.{e}.",
                                  weights["experts"][e], xb, act),
            grouped_apply=grouped_swiglu if use_grouped else None,
            scale_input=True)
    elif use_grouped:
        B, S, H = h.shape
        N = B * S
        buf = (h.float().reshape(1, N, H)
               * scores.reshape(N, E).t()[:, :, None]).to(h.dtype).contiguous()
        out = grouped_swiglu(buf).float().sum(dim=0).reshape(B, S, H)
    else:
        out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e, ew in enumerate(weights["experts"]):
            xe = (h.float() * scores[..., e:e + 1]).to(h.dtype)
            out = out + _swiglu(lf, f"experts.{e}.", ew, xe, act).float()
    out = out + _swiglu(lf, "shared_expert.", weights["shared_expert"], h,
                        act).float()
    return out.to(h.dtype)


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: Llama4Config,
              mask: Optional[torch.Tensor] = None, linear_fn=None,
              use_rope: bool = True) -> torch.Tensor:
    """One decoder block; ``use_rope`` is the layer's kind (rope + chunked
    vs NoPE + temperature), bound per layer by :func:`block_fwd_for`."""
    lf = linear_fn or llama._plain_linear
    B, S, H = x.shape
    hd = cfg.hd
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    q = lf("q_proj", h, weights["q_proj"]).reshape(B, S, cfg.num_heads, hd)
    k = lf("k_proj", h, weights["k_proj"]).reshape(B, S, cfg.num_kv_heads,
                                                   hd)
    v = lf("v_proj", h, weights["v_proj"]).reshape(B, S, cfg.num_kv_heads,
                                                   hd)
    q, k = attention_inputs(q, k, cfg, use_rope, cos, sin)
    attn = llama.attention(q, k, v, mask, cfg)
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    if "experts" in weights:
        return x + _moe_mlp(weights, h, cfg, lf)
    return x + _swiglu(lf, "", weights, h, llama._act(cfg.hidden_act))


def layer_uses_rope(cfg: Llama4Config, li: int) -> bool:
    return cfg.no_rope_layers[li] != 0 if cfg.no_rope_layers else True


@functools.lru_cache(maxsize=None)
def _variant_fn(use_rope: bool):
    def fn(w, x, cos, sin, cfg, mask=None, linear_fn=None):
        return block_fwd(w, x, cos, sin, cfg, mask=mask,
                         linear_fn=linear_fn, use_rope=use_rope)
    return fn


def block_fwd_for(cfg: Llama4Config, li: int):
    """Layer ``li``'s forward: one of two stable callables (rope or NoPE),
    with :func:`block_fwd`'s signature otherwise."""
    return _variant_fn(layer_uses_rope(cfg, li))


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: Llama4Config) -> torch.Tensor:
    """Full forward → logits: rope layers chunk past the chunk size, NoPE
    layers attend causally over everything."""
    x = llama.embed_fwd(params, input_ids, cfg)
    S = input_ids.shape[1]
    cos, sin = llama.rope_tables(cfg, S, device=x.device)
    cmask = (llama.sliding_mask(cfg, S, x.device)
             if cfg.sliding_window is not None and S > cfg.sliding_window
             else None)
    for li, b in enumerate(params["blocks"]):
        mask = cmask if llama.layer_is_sliding(cfg, li) else None
        x = block_fwd(b, x, cos, sin, cfg, mask=mask,
                      use_rope=layer_uses_rope(cfg, li))
    return llama.final_fwd(params, x, cfg)
