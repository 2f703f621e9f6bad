"""Step-3.5 decoder in PyTorch (counterpart of
``autoround_tpu/models/step35.py``, StepFun ``Step3p5ForCausalLM``).

* **Full and sliding layers with their own head counts**: a sliding
  layer has ``swa_num_heads`` query heads over ``swa_num_kv_heads`` KV
  heads (HF ``attention_other_setting``; 0: the full layers' counts), its
  local rope base (``rope_local_theta``) and rotated fraction
  (``partial_rotary_factor_local``, 1.0 against the full layers' 0.5), and
  past the window the sliding mask.  :func:`block_fwd_for` gives each
  layer its variant.
* **The sigmoid output gate**: ``g_proj`` (nh, H) gives each head a
  sigmoid gate on its attention output, computed in fp32 and kept FP (not
  in :func:`block_linear_names`, as the reference's ignore rule has it).
* **The (1 + w) norm**: ``norm_offset = 1.0``, the gains start at zero.
* **Clamped SwiGLU**: after the activation the gate is capped at
  ``+limit``, and ``up`` is clipped to ``±limit`` (0: no clamp); the
  routed experts take ``swiglu_limit``, the shared expert and the dense
  layers ``swiglu_limit_shared`` (a quirk of the JAX package, mirrored).
  The clips pass half the gradient on a bound, as ``jnp.minimum`` and
  ``jnp.clip`` do (``dtypes.intq._clip``).
* **The router**: fp32 logits of ``gate``; sigmoid scores with the fp32
  ``router_bias`` added for the selection (``use_moe_router_bias``), else
  softmax scores; the mixing weights are the unbiased scores at the
  selected experts, renormalised (``+ 1e-20``) under
  ``norm_expert_weight``, times ``moe_router_scaling_factor``.  The top-k
  is a stable sort, the lower index first on a tie (``deepseek._top_k``).
* ``moe_layers`` lists the MoE layers; the others have a dense MLP.  A MoE
  layer adds a shared expert ``share_expert_dim`` wide.

Experts run dense-then-mask, the JAX package's only route.  MTP draft
layers are not modelled (the loaders skip them).  The JAX engine serves no
Step-3.5 model, so the port's does not either.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..dtypes.intq import _clip
from . import llama
from .deepseek import _top_k
from .llama import LlamaConfig, rms_norm

__all__ = ["Step35Config", "CONFIG_PRESETS", "init_params", "block_fwd",
           "block_fwd_for", "model_fwd", "block_linear_names"]

_MLP = ("gate_proj", "up_proj", "down_proj")


@dataclass(frozen=True)
class Step35Config(LlamaConfig):
    # the sliding layers' head counts (0: the full layers')
    swa_num_heads: int = 0
    swa_num_kv_heads: int = 0
    attn_out_gate: bool = True       # per-head sigmoid gate (g_proj)
    moe_layers: Tuple[int, ...] = ()
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_intermediate_size: int = 0
    share_expert_dim: int = 0
    moe_router_scaling_factor: float = 1.0
    norm_expert_weight: bool = True
    use_moe_router_bias: bool = False
    # SwiGLU clamps (0: none): the routed experts', the shared expert's
    swiglu_limit: float = 0.0
    swiglu_limit_shared: float = 0.0

    def heads_for(self, li: int) -> Tuple[int, int]:
        if llama.layer_is_sliding(self, li):
            return (self.swa_num_heads or self.num_heads,
                    self.swa_num_kv_heads or self.num_kv_heads)
        return self.num_heads, self.num_kv_heads

    def layer_is_moe(self, li: int) -> bool:
        return li in self.moe_layers


CONFIG_PRESETS: Dict[str, Step35Config] = {
    "tiny-step35": Step35Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=100000.0, rope_local_theta=10000.0,
        partial_rotary_factor=0.5, partial_rotary_factor_local=1.0,
        norm_offset=1.0, sliding_window=8,
        layer_types=("full_attention", "sliding_attention",
                     "full_attention", "sliding_attention"),
        moe_layers=(1, 2, 3), moe_num_experts=8, moe_top_k=2,
        moe_intermediate_size=32, share_expert_dim=64,
        moe_router_scaling_factor=1.5, norm_expert_weight=True,
        use_moe_router_bias=True, swiglu_limit=7.0,
        swiglu_limit_shared=7.0, dtype=torch.float32),
}


def block_linear_names(cfg: Step35Config) -> Tuple[str, ...]:
    """Union over the blocks (the dense blocks lack the expert leaves);
    ``g_proj`` and the router ``gate`` stay FP."""
    names = ("q_proj", "k_proj", "v_proj", "o_proj") + _MLP
    if cfg.moe_num_experts:
        names += tuple(f"experts.{e}.{w}"
                       for e in range(cfg.moe_num_experts) for w in _MLP)
        if cfg.share_expert_dim:
            names += tuple(f"shared_expert.{w}" for w in _MLP)
    return names


def init_params(cfg: Step35Config, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree and scales (each
    layer's q / k / v / o / g_proj at its own head counts, the (1 + w)
    gains at zero, the fp32 ``router_bias`` at zero); the numbers differ
    (another generator).  ``park(block)``, when given, takes each block as
    it is made and returns what the tree holds (see
    ``llama.init_params``)."""
    dev = resolve_device(device)
    H, hd = cfg.hidden_size, cfg.hd
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(std)

    def zeros(n, dtype=cfg.dtype):
        return torch.zeros((n,), dtype=dtype, device=dev)

    def mlp(width):
        return {"gate_proj": normal((width, H)), "up_proj": normal((width, H)),
                "down_proj": normal((H, width), down_std)}

    blocks = []
    for li in range(cfg.num_layers):
        nh, nkv = cfg.heads_for(li)
        b: Dict[str, Any] = {
            "q_proj": normal((nh * hd, H)), "k_proj": normal((nkv * hd, H)),
            "v_proj": normal((nkv * hd, H)),
            "o_proj": normal((H, nh * hd), down_std),
            "input_layernorm": zeros(H),
            "post_attention_layernorm": zeros(H),
        }
        if cfg.attn_out_gate:
            b["g_proj"] = normal((nh, H))
        if cfg.layer_is_moe(li):
            b["gate"] = normal((cfg.moe_num_experts, H))
            if cfg.use_moe_router_bias:
                b["router_bias"] = zeros(cfg.moe_num_experts, torch.float32)
            b["experts"] = [mlp(cfg.moe_intermediate_size)
                            for _ in range(cfg.moe_num_experts)]
            if cfg.share_expert_dim:
                b["shared_expert"] = mlp(cfg.share_expert_dim)
        else:
            b.update(mlp(cfg.intermediate_size))
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": zeros(H), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def _clamped_mlp(weights, h, cfg: Step35Config, lf, limit: float,
                 prefix: str = ""):
    """SwiGLU with the Step-3.5 clamp: the gate capped at +limit after the
    activation, up clipped to ±limit (the model dtype, as in JAX)."""
    gate = llama._act(cfg.hidden_act)(lf(f"{prefix}gate_proj", h,
                                         weights["gate_proj"]))
    up = lf(f"{prefix}up_proj", h, weights["up_proj"])
    if limit:
        gate = _clip(gate, -math.inf, limit)
        up = _clip(up, -limit, limit)
    return lf(f"{prefix}down_proj", gate * up, weights["down_proj"])


def _route(h: torch.Tensor, weights, cfg: Step35Config
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k expert ids, their mixing weights) per token (the module
    docstring)."""
    logits = torch.einsum("...h,eh->...e", h.float(),
                          weights["gate"].float())
    if cfg.use_moe_router_bias or "router_bias" in weights:
        scores = torch.sigmoid(logits)
        choice = scores + weights["router_bias"]
    else:
        scores = torch.softmax(logits, dim=-1)
        choice = scores
    topi = _top_k(choice, cfg.moe_top_k)[1]
    topw = torch.gather(scores, -1, topi)
    if cfg.norm_expert_weight:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
    return topi, topw * cfg.moe_router_scaling_factor


def _moe_mlp(weights, h: torch.Tensor, cfg: Step35Config, lf):
    topi, topw = _route(h, weights, cfg)
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e, ew in enumerate(weights["experts"]):
        y = _clamped_mlp(ew, h, cfg, lf, cfg.swiglu_limit,
                         prefix=f"experts.{e}.").float()
        w_e = torch.where(topi == e, topw, torch.zeros_like(topw)).sum(dim=-1)
        out = out + y * w_e[..., None]
    if "shared_expert" in weights:
        out = out + _clamped_mlp(
            weights["shared_expert"], h, cfg, lf, cfg.swiglu_limit_shared,
            prefix="shared_expert.").float()
    return out.to(h.dtype)


def _block_impl(weights, x, cos, sin, cfg: Step35Config, nh: int, nkv: int,
                mask, lf):
    B, S, H = x.shape
    hd = cfg.hd
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps, cfg.norm_offset)
    q = lf("q_proj", h, weights["q_proj"]).reshape(B, S, nh, hd)
    k = lf("k_proj", h, weights["k_proj"]).reshape(B, S, nkv, hd)
    v = lf("v_proj", h, weights["v_proj"]).reshape(B, S, nkv, hd)
    q = llama.apply_rope(q, cos, sin)     # partial where cos is rd < hd
    k = llama.apply_rope(k, cos, sin)
    attn = llama.attention(q, k, v, mask, cfg)
    if "g_proj" in weights:
        g = torch.sigmoid(torch.einsum("bsh,nh->bsn", h.float(),
                                       weights["g_proj"].float()))
        attn = attn * g[..., None].to(attn.dtype)
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps,
                 cfg.norm_offset)
    if "experts" in weights:
        return x + _moe_mlp(weights, h, cfg, lf)
    return x + _clamped_mlp(weights, h, cfg, lf, cfg.swiglu_limit_shared)


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: Step35Config, mask=None,
              linear_fn=None) -> torch.Tensor:
    """A full-attention block (``num_heads`` / ``num_kv_heads``)."""
    lf = linear_fn or llama._plain_linear
    return _block_impl(weights, x, cos, sin, cfg, cfg.num_heads,
                       cfg.num_kv_heads, mask, lf)


def _swa_block_fwd(weights, x, cos, sin, cfg: Step35Config, mask=None,
                   linear_fn=None):
    """A sliding block (``swa_num_heads`` / ``swa_num_kv_heads``)."""
    lf = linear_fn or llama._plain_linear
    return _block_impl(weights, x, cos, sin, cfg,
                       cfg.swa_num_heads or cfg.num_heads,
                       cfg.swa_num_kv_heads or cfg.num_kv_heads, mask, lf)


def block_fwd_for(cfg: Step35Config, li: int):
    """The layer's forward: one function for every full layer, one for
    every sliding layer."""
    return _swa_block_fwd if llama.layer_is_sliding(cfg, li) else block_fwd


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: Step35Config) -> torch.Tensor:
    """Full forward → logits."""
    x = llama.embed_fwd(params, input_ids, cfg)
    S = input_ids.shape[1]
    cos, sin = llama.rope_tables(cfg, S, device=x.device)
    cosl, sinl = llama.rope_tables(cfg, S, device=x.device, local=True)
    smask = (llama.sliding_mask(cfg, S, x.device)
             if cfg.sliding_window and S > cfg.sliding_window else None)
    for li, b in enumerate(params["blocks"]):
        if llama.layer_is_sliding(cfg, li):
            x = _swa_block_fwd(b, x, cosl, sinl, cfg, mask=smask)
        else:
            x = block_fwd(b, x, cos, sin, cfg)
    return llama.final_fwd(params, x, cfg)
