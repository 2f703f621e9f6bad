"""Qwen3-Next and Qwen3.5-MoE decoders in PyTorch (counterpart of
``autoround_tpu/models/qwen3next.py``): gated DeltaNet linear attention,
gated full attention and Qwen-MoE, layer kinds by ``layer_types``.

* **linear_attention** (3 of every 4 layers): the gated DeltaNet.  The
  fused ``in_proj_qkvz`` / ``in_proj_ba`` projections (per-k-head
  interleaved layouts), a depthwise causal conv (kernel K) and SiLU over
  the concatenated q / k / v stream, L2-normed q / k, and the gated delta
  rule ``S_t = α_t S_{t-1} + β_t k_t (v_t − k_tᵀ S_{t-1})`` in chunks of
  ``delta_chunk`` tokens: the per-chunk UT transform ``(I − A)⁻¹`` is one
  batched unit-lower triangular solve and the chunks are scanned by a
  Python loop over the state (B, H, dk, dv), all in fp32.  The output
  goes through a gated RMSNorm (``norm(x) · silu(z)``, no norm offset)
  and ``out_proj``.
* **full_attention** (every 4th): ``q_proj`` emits the query and a
  per-head output gate (per-head halves); per-head q / k RMSNorm with
  offset 1, partial rotary, GQA attention (the flash kernel where its gate
  passes), then ``attn · sigmoid(gate)`` in fp32 before ``o_proj``.
* **MoE** on every layer but ``mlp_only_layers`` (a dense gate / up / down
  MLP there): Qwen2-MoE semantics, :func:`.mixtral._moe_mlp` with w1 / w2
  / w3 expert leaves and the sigmoid-gated shared expert.

``in_proj_ba`` stays unquantized like the router (it parametrizes the
decay and β); ``conv1d``, ``A_log``, ``dt_bias`` and ``linear_norm`` are
not linears.  ``A_log`` and ``dt_bias`` are fp32 leaves whatever the model
dtype.  The delta rule, the conv and the recurrent step have no Pallas
kernel in the JAX package; they run as PyTorch ops here too.

Serving (``serve/engine.py``) keeps a hybrid cache: K / V for the full
layers, the conv tail (the last K − 1 raw pre-conv inputs) and the fp32
recurrent state for the linear ones, updated in O(1) a token by
:func:`gated_delta_step`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from . import llama, mixtral
from .llama import rms_norm
from .mixtral import MixtralConfig

__all__ = ["Qwen3NextConfig", "Qwen35MoeConfig", "CONFIG_PRESETS",
           "init_params", "block_fwd", "block_fwd_for", "model_fwd",
           "block_linear_names", "chunk_gated_delta_rule",
           "gated_delta_step", "full_attention_with_cache",
           "block_with_cache", "is_linear_layer", "linear_cache_shapes"]


@dataclass(frozen=True)
class Qwen3NextConfig(MixtralConfig):
    # layer_types: "linear_attention" / "full_attention" per layer
    linear_num_key_heads: int = 16
    linear_num_value_heads: int = 32
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4
    # the routed experts' width; mlp_only_layers run a dense MLP of
    # intermediate_size
    moe_intermediate_size: int = 0
    mlp_only_layers: Tuple[int, ...] = ()
    delta_chunk: int = 64


@dataclass(frozen=True)
class Qwen35MoeConfig(Qwen3NextConfig):
    """Qwen3.5-MoE: the Qwen3-Next model; its checkpoints store the experts
    as fused (E, 2I, H) / (E, H, I) stacks and carry an ``mtp.*`` draft
    namespace, which the HF loader splits and skips."""


CONFIG_PRESETS: Dict[str, Qwen3NextConfig] = {
    "tiny-qwen35moe": Qwen35MoeConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=64, num_layers=3, num_heads=4,
        num_kv_heads=2, head_dim=16, partial_rotary_factor=0.25,
        rope_theta=10000.0, rms_eps=1e-6, qk_norm=True, norm_offset=1.0,
        layer_types=("linear_attention", "full_attention",
                     "linear_attention"),
        linear_num_key_heads=2, linear_num_value_heads=4,
        linear_key_head_dim=16, linear_value_head_dim=16,
        num_experts=4, top_k=2, shared_expert_intermediate=64,
        shared_expert_gate=True, norm_topk_prob=True, delta_chunk=8,
        dtype=torch.float32),
    "tiny-qwen3next": Qwen3NextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=64, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=16, partial_rotary_factor=0.25,
        rope_theta=10000.0, rms_eps=1e-6, qk_norm=True, norm_offset=1.0,
        layer_types=("linear_attention", "linear_attention",
                     "linear_attention", "full_attention"),
        linear_num_key_heads=2, linear_num_value_heads=4,
        linear_key_head_dim=16, linear_value_head_dim=16,
        num_experts=4, top_k=2, shared_expert_intermediate=64,
        shared_expert_gate=True, norm_topk_prob=True, delta_chunk=8,
        dtype=torch.float32),
}

_MLP = ("w1", "w2", "w3")
_DENSE = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}


def is_linear_layer(cfg: Qwen3NextConfig, li: int) -> bool:
    return (cfg.layer_types or ())[li] == "linear_attention"


def linear_cache_shapes(cfg: Qwen3NextConfig):
    """Per-slot shapes of a DeltaNet layer's serving cache: the conv tail
    (K - 1, conv_dim) and the fp32 recurrent state (nv, dk, dv)."""
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    return ((cfg.linear_conv_kernel_dim - 1, 2 * nk * dk + nv * dv),
            (nv, dk, dv))


def _is_moe_layer(cfg: Qwen3NextConfig, li: int) -> bool:
    return cfg.num_experts > 0 and li not in cfg.mlp_only_layers


def block_linear_names(cfg: Qwen3NextConfig) -> Tuple[str, ...]:
    """The union over the layer kinds (the API prunes the plan per block);
    ``in_proj_ba`` is left out, as the router is."""
    names = ("q_proj", "k_proj", "v_proj", "o_proj", "in_proj_qkvz",
             "out_proj", "gate_proj", "up_proj", "down_proj")
    if cfg.num_experts:
        names += tuple(f"experts.{e}.{w}"
                       for e in range(cfg.num_experts) for w in _MLP)
        if cfg.shared_expert_intermediate:
            names += tuple(f"shared_expert.{w}" for w in _MLP)
    return names


def init_params(cfg: Qwen3NextConfig, generator: torch.Generator,
                device=None, park=None) -> Dict[str, Any]:
    """Random-init parameters from a seeded ``torch.Generator`` (which
    must live on ``device``): the JAX package's tree, scales and dtypes (a
    linear layer holds the DeltaNet leaves with fp32 ``dt_bias`` and
    ``A_log``, a full layer the gated attention; a MoE layer the router,
    the experts and the gated shared expert, an ``mlp_only_layers`` layer
    the dense MLP); the numbers differ (another generator).  ``park``
    as in ``llama.init_params``."""
    dev = resolve_device(device)
    H, hd = cfg.hidden_size, cfg.hd
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    Kd, Vd = nk * dk, nv * dv
    down_std = 0.02 / np.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=cfg.dtype)
        return t.mul_(std)

    def ones(n, dtype=cfg.dtype):
        return torch.ones((n,), dtype=dtype, device=dev)

    def mlp(width):
        return {"w1": normal((width, H)), "w3": normal((width, H)),
                "w2": normal((H, width), down_std)}

    blocks = []
    for li in range(cfg.num_layers):
        b: Dict[str, Any] = {"input_layernorm": ones(H),
                             "post_attention_layernorm": ones(H)}
        if is_linear_layer(cfg, li):
            b["in_proj_qkvz"] = normal((2 * Kd + 2 * Vd, H))
            b["in_proj_ba"] = normal((2 * nv, H))
            b["conv1d"] = normal((2 * Kd + Vd, cfg.linear_conv_kernel_dim),
                                 0.1)
            b["dt_bias"] = ones(nv, torch.float32)
            u = torch.rand((nv,), generator=generator, device=dev,
                           dtype=torch.float32)
            b["A_log"] = torch.log(1e-3 + u * (16.0 - 1e-3))
            b["linear_norm"] = ones(dv)
            b["out_proj"] = normal((H, Vd))
        else:
            qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
            b["q_proj"] = normal((2 * qd, H))
            b["k_proj"] = normal((kvd, H))
            b["v_proj"] = normal((kvd, H))
            b["o_proj"] = normal((H, qd))
            b["q_norm"], b["k_norm"] = ones(hd), ones(hd)
        if _is_moe_layer(cfg, li):
            b["router"] = normal((cfg.num_experts, H))
            b["experts"] = [mlp(cfg.moe_intermediate_size)
                            for _ in range(cfg.num_experts)]
            if cfg.shared_expert_intermediate:
                b["shared_expert"] = mlp(cfg.shared_expert_intermediate)
                if cfg.shared_expert_gate:
                    b["shared_expert_gate"] = normal((1, H))
        else:
            b.update({_DENSE[k]: v
                      for k, v in mlp(cfg.intermediate_size).items()})
        blocks.append(b if park is None else park(b))
    params: Dict[str, Any] = {"embed_tokens": normal((cfg.vocab_size, H)),
                              "norm": ones(H), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.vocab_size, H))
    return params


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(Σx² + eps) in fp32 (not ``F.normalize``, which clamps the
    norm instead)."""
    xf = x.float()
    return xf * torch.rsqrt(torch.sum(xf * xf, dim=-1, keepdim=True) + eps)


def chunk_gated_delta_rule(q, k, v, g, beta, chunk: int = 64,
                           return_state: bool = False):
    """The chunked gated delta rule: q / k (B, S, H, dk), v (B, S, H, dv),
    g / beta (B, S, H) → (B, S, H, dv) fp32 (and the final state (B, H,
    dk, dv) with ``return_state``).  S pads to the chunk (a padded token
    has k = 0 and g = 0, so the state is exact).  The intra-chunk UT
    transform ``(I − A)⁻¹`` is one batched unit-lower triangular solve; the
    chunks are scanned in order."""
    q = _l2norm(q)
    k = _l2norm(k)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    q, k, v = (x.transpose(1, 2).float() for x in (q, k, v))   # (B, H, S, d)
    g = g.transpose(1, 2).float()
    beta = beta.transpose(1, 2).float()
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        g = F.pad(g, (0, pad))
        beta = F.pad(beta, (0, pad))
    N, C = (S + pad) // chunk, chunk
    q = q * (dk ** -0.5)
    v_beta = v * beta[..., None]
    k_beta = k * beta[..., None]
    q, k, v, k_beta, v_beta = (x.reshape(B, H, N, C, -1)
                               for x in (q, k, v, k_beta, v_beta))
    g = torch.cumsum(g.reshape(B, H, N, C), dim=-1)
    dev = q.device
    tril = torch.ones((C, C), dtype=torch.bool, device=dev).tril()
    strict = tril.tril(-1)
    zero = torch.zeros((), device=dev)
    decay = torch.where(tril, torch.exp(torch.where(
        tril, g[..., :, None] - g[..., None, :], zero)), zero)
    A = torch.where(strict, -(torch.einsum("bhncd,bhnkd->bhnck", k_beta, k)
                              * decay), zero)
    eye = torch.eye(C, dtype=torch.float32, device=dev)
    T = torch.linalg.solve_triangular(eye - A, eye.expand(A.shape),
                                      upper=False, unitriangular=True)
    v_t = torch.einsum("bhnck,bhnkd->bhncd", T, v_beta)
    k_cumdecay = torch.einsum("bhnck,bhnkd->bhncd", T,
                              k_beta * torch.exp(g)[..., None])
    state = q.new_zeros((B, H, dk, dv))
    outs = []
    for n in range(N):
        q_i, k_i, g_i = q[:, :, n], k[:, :, n], g[:, :, n]
        attn = torch.where(tril, torch.einsum("bhcd,bhkd->bhck", q_i, k_i)
                           * decay[:, :, n], zero)
        v_new = v_t[:, :, n] - torch.einsum("bhcd,bhdv->bhcv",
                                            k_cumdecay[:, :, n], state)
        inter = torch.einsum("bhcd,bhdv->bhcv",
                             q_i * torch.exp(g_i)[..., None], state)
        outs.append(inter + torch.einsum("bhck,bhkv->bhcv", attn, v_new))
        g_last = g_i[..., -1:]
        state = (state * torch.exp(g_last)[..., None]
                 + torch.einsum("bhcd,bhcv->bhdv",
                                k_i * torch.exp(g_last - g_i)[..., None],
                                v_new))
    out = torch.stack(outs, dim=2).reshape(B, H, N * C, dv)
    out = out[:, :, :S].transpose(1, 2)                  # (B, S, H, dv)
    return (out, state) if return_state else out


def _split_qkvz(qkvz, ba, cfg: Qwen3NextConfig, B: int, S: int):
    """The per-k-head interleaved projections → (mixed raw q / k / v stream
    (B, S, conv_dim), z (B, S, nv, dv), b, a (B, S, nv))."""
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    r = nv // nk
    qkvz = qkvz.reshape(B, S, nk, 2 * dk + 2 * r * dv)
    qh = qkvz[..., :dk]
    kh = qkvz[..., dk:2 * dk]
    vh = qkvz[..., 2 * dk:2 * dk + r * dv].reshape(B, S, nv, dv)
    z = qkvz[..., 2 * dk + r * dv:].reshape(B, S, nv, dv)
    ba = ba.reshape(B, S, nk, 2 * r)
    b = ba[..., :r].reshape(B, S, nv)
    a = ba[..., r:].reshape(B, S, nv)
    mixed = torch.cat([qh.reshape(B, S, -1), kh.reshape(B, S, -1),
                       vh.reshape(B, S, -1)], dim=-1)
    return mixed, z, b, a


def _qkv_heads(mixed_c, cfg: Qwen3NextConfig, lead):
    """The conv output (lead..., conv_dim) → q, k (lead..., nv, dk) with each
    k-head repeated r = nv / nk times in place (``jnp.repeat``), v
    (lead..., nv, dv)."""
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    Kd, r = nk * dk, nv // nk
    q = mixed_c[..., :Kd].reshape(*lead, nk, dk)
    k = mixed_c[..., Kd:2 * Kd].reshape(*lead, nk, dk)
    v = mixed_c[..., 2 * Kd:].reshape(*lead, nv, dv)
    if r > 1:
        q = q.repeat_interleave(r, dim=-2)
        k = k.repeat_interleave(r, dim=-2)
    return q, k, v


def _gates(weights, b, a):
    """β = sigmoid(b) and the log decay g = −exp(A_log) · softplus(a +
    dt_bias), fp32."""
    beta = torch.sigmoid(b.float())
    g = (-torch.exp(weights["A_log"].float())
         * F.softplus(a.float() + weights["dt_bias"].float()))
    return beta, g


def _gated_out(weights, core, z, cfg: Qwen3NextConfig, dtype):
    """The gated RMSNorm ``rms_norm(core, linear_norm) · silu(z)`` (no norm
    offset on ``linear_norm``), in ``dtype``."""
    xn = rms_norm(core.to(cfg.dtype), weights["linear_norm"],
                  cfg.rms_eps).float()
    return (xn * F.silu(z.float())).to(dtype)


def _gated_delta_net(weights, h, cfg: Qwen3NextConfig, lf,
                     return_cache: bool = False):
    """The DeltaNet token mixer over a whole sequence (tuning, eval and
    the prompt pass).  ``return_cache`` also returns the conv tail (B, K −
    1, conv_dim): the raw pre-conv inputs of the last K − 1 tokens,
    left-padded with zeros when S < K − 1, and the recurrent state (B, nv,
    dk, dv) fp32."""
    B, S, _ = h.shape
    nv, dv = cfg.linear_num_value_heads, cfg.linear_value_head_dim
    mixed_raw, z, b, a = _split_qkvz(
        lf("in_proj_qkvz", h, weights["in_proj_qkvz"]),
        lf("in_proj_ba", h, weights["in_proj_ba"]), cfg, B, S)
    w = weights["conv1d"].float()                       # (conv_dim, K)
    K = w.shape[1]
    xpad = F.pad(mixed_raw.float(), (0, 0, K - 1, 0))
    conv = sum(xpad[:, i:i + S, :] * w[:, i] for i in range(K))
    q, k, v = _qkv_heads(F.silu(conv), cfg, (B, S))
    beta, g = _gates(weights, b, a)
    res = chunk_gated_delta_rule(q, k, v, g, beta, cfg.delta_chunk,
                                 return_state=return_cache)
    core = res[0] if return_cache else res
    out = _gated_out(weights, core, z, cfg, h.dtype)
    y = lf("out_proj", out.reshape(B, S, nv * dv), weights["out_proj"])
    if return_cache:
        tail = F.pad(mixed_raw, (0, 0, K - 1, 0))[:, S:S + K - 1]
        return y, tail, res[1]
    return y


def _gated_qkv(weights, h, cfg: Qwen3NextConfig, lf, fused=None):
    """(q, gate (B, S, nh, hd), k, v (B, S, nkv, hd)) of the gated
    attention: ``q_proj`` emits each head's query and gate halves.
    ``fused(name, h)`` (the serving engine's) returns the members of a
    fused projection group, or None; q / k / v then come from one fused
    product."""
    B, S, _ = h.shape
    hd = cfg.hd
    out = fused("qkv", h) if fused is not None else None
    if out is None:
        out = [lf(n, h, weights[n]) for n in ("q_proj", "k_proj", "v_proj")]
    qg = out[0].reshape(B, S, cfg.num_heads, 2 * hd)
    k = out[1].reshape(B, S, cfg.num_kv_heads, hd)
    v = out[2].reshape(B, S, cfg.num_kv_heads, hd)
    return qg[..., :hd], qg[..., hd:], k, v


def _qk_rope(weights, q, k, cos, sin, cfg: Qwen3NextConfig):
    q = rms_norm(q, weights["q_norm"], cfg.rms_eps, cfg.norm_offset)
    k = rms_norm(k, weights["k_norm"], cfg.rms_eps, cfg.norm_offset)
    return llama.apply_rope(q, cos, sin), llama.apply_rope(k, cos, sin)


def _gate_attn(attn, gate, dtype):
    return (attn.float() * torch.sigmoid(gate.float())).to(dtype)


def _full_attention(weights, h, cos, sin, cfg: Qwen3NextConfig, lf):
    """The gated full attention over the sequence (causal)."""
    return full_attention_with_cache(weights, h, cos, sin, cfg, lf, None,
                                     None)[0]


def _dense_mlp(weights, h, cfg: Qwen3NextConfig, lf, fused=None):
    act = llama._act(cfg.hidden_act)
    gu = fused("gate_up", h) if fused is not None else None
    if gu is None:
        gu = [lf(n, h, weights[n]) for n in ("gate_proj", "up_proj")]
    return lf("down_proj", act(gu[0]) * gu[1], weights["down_proj"])


def _mlp(weights, h, cfg: Qwen3NextConfig, lf, fused=None,
         capacity_factor: float = 0.0):
    if "experts" in weights:
        return mixtral._moe_mlp(weights, h, cfg, lf,
                                capacity_factor=capacity_factor)
    return _dense_mlp(weights, h, cfg, lf, fused)


def block_fwd(weights: Dict[str, Any], x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, cfg: Qwen3NextConfig,
              mask: Optional[torch.Tensor] = None, linear_fn=None,
              linear_attn: bool = True) -> torch.Tensor:
    """One decoder block; ``linear_attn`` is the layer's kind (DeltaNet or
    gated full attention), bound per layer by :func:`block_fwd_for`.
    ``mask`` is unused: the full layers attend causally."""
    lf = linear_fn or llama._plain_linear
    off = cfg.norm_offset
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps, off)
    if linear_attn:
        x = x + _gated_delta_net(weights, h, cfg, lf)
    else:
        x = x + _full_attention(weights, h, cos, sin, cfg, lf)
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps, off)
    return x + _mlp(weights, h, cfg, lf)


@functools.lru_cache(maxsize=None)
def _variant_fn(linear_attn: bool):
    def fn(w, x, cos, sin, cfg, mask=None, linear_fn=None):
        return block_fwd(w, x, cos, sin, cfg, mask=mask,
                         linear_fn=linear_fn, linear_attn=linear_attn)
    return fn


def block_fwd_for(cfg: Qwen3NextConfig, li: int):
    """Layer ``li``'s forward: one of two stable callables (DeltaNet or
    full attention), with :func:`block_fwd`'s signature otherwise."""
    return _variant_fn(is_linear_layer(cfg, li))


def model_fwd(params: Dict[str, Any], input_ids: torch.Tensor,
              cfg: Qwen3NextConfig) -> torch.Tensor:
    """Full forward → logits."""
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = llama.rope_tables(cfg, input_ids.shape[1], device=x.device)
    for li, b in enumerate(params["blocks"]):
        x = block_fwd(b, x, cos, sin, cfg,
                      linear_attn=is_linear_layer(cfg, li))
    return llama.final_fwd(params, x, cfg)


def gated_delta_step(weights, h, cfg: Qwen3NextConfig, lf, conv_tail,
                     state):
    """One token of the DeltaNet (the O(1) decode step): h (B, 1, H);
    conv_tail (B, K − 1, conv_dim) raw pre-conv inputs; state (B, nv, dk,
    dv) fp32.  The tail and the new token join in fp32 for the conv; q is
    L2-normed and scaled by dk^-½; the state decays, takes the delta update,
    then q reads it.  Returns (out (B, 1, H), the new tail in the tail's
    dtype, the new state)."""
    B = h.shape[0]
    nv, dk, dv = (cfg.linear_num_value_heads, cfg.linear_key_head_dim,
                  cfg.linear_value_head_dim)
    mixed, z, b, a = _split_qkvz(
        lf("in_proj_qkvz", h, weights["in_proj_qkvz"]),
        lf("in_proj_ba", h, weights["in_proj_ba"]), cfg, B, 1)
    window = torch.cat([conv_tail.float(), mixed.float()], dim=1)  # (B, K, cd)
    conv = torch.einsum("bkc,ck->bc", window, weights["conv1d"].float())
    q, k, v = _qkv_heads(F.silu(conv), cfg, (B,))
    q = _l2norm(q) * (dk ** -0.5)
    k = _l2norm(k)
    beta, g = _gates(weights, b.reshape(B, nv), a.reshape(B, nv))
    state = state * torch.exp(g)[..., None, None]
    kv_mem = torch.einsum("bhdv,bhd->bhv", state, k)
    delta = (v.float() - kv_mem) * beta[..., None]
    state = state + torch.einsum("bhd,bhv->bhdv", k, delta)
    core = torch.einsum("bhdv,bhd->bhv", state, q)          # (B, nv, dv)
    out = _gated_out(weights, core[:, None], z, cfg, h.dtype)
    y = lf("out_proj", out.reshape(B, 1, nv * dv), weights["out_proj"])
    return y, window[:, 1:].to(conv_tail.dtype), state


def full_attention_with_cache(weights, h, cos, sin, cfg: Qwen3NextConfig,
                              lf, kv, pos, fused=None):
    """The gated full attention: q / k RMSNorm (offset 1), partial rope,
    GQA attention, ``attn · sigmoid(gate)`` in fp32, ``o_proj``.  ``kv``
    None: over the sequence (causal; tuning and the prompt pass).  Else ``kv = (k_all, v_all)`` (B, T,
    nkv, hd) and ``pos`` (B,) int32 on the device: slot b writes its token
    at ``pos[b]`` in place and attends over [0, pos[b]].  Returns (out, k,
    v) with the new token's (or the prompt's) k / v."""
    B, S, _ = h.shape
    q, gate, k, v = _gated_qkv(weights, h, cfg, lf, fused)
    q, k = _qk_rope(weights, q, k, cos, sin, cfg)
    if kv is None:
        attn = llama.attention(q, k, v, None, cfg)
    else:
        k_all, v_all = kv
        slots = torch.arange(B, device=h.device)
        k_all[slots, pos] = k[:, 0].to(k_all.dtype)
        v_all[slots, pos] = v[:, 0].to(v_all.dtype)
        idx = torch.arange(k_all.shape[1], device=h.device)
        bias = torch.where(idx[None, :] <= pos[:, None], 0.0, -1e30)
        attn = llama.attention(q, k_all, v_all, bias[:, None, None, :], cfg)
    attn = _gate_attn(attn, gate, h.dtype)
    return lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"]), k, v


def block_with_cache(weights, x, cos, sin, cfg: Qwen3NextConfig, cache_in,
                     pos, lf, fused: Optional[Callable] = None,
                     capacity_factor: float = 0.0):
    """The serving block: (out, cache pieces).  ``cache_in`` None (the
    prompt pass) or ("lin", conv_tail, state) / ("full", k_all, v_all) at
    decode; the pieces mirror the layer kind: ("lin", tail, state) or
    ("full", k, v).  ``fused`` as in :func:`_gated_qkv` (q / k / v and a
    dense layer's gate / up); the MoE route follows ``capacity_factor``."""
    off = cfg.norm_offset
    h = rms_norm(x, weights["input_layernorm"], cfg.rms_eps, off)
    if "in_proj_qkvz" in weights:
        if cache_in is None:
            y, tail, state = _gated_delta_net(weights, h, cfg, lf,
                                              return_cache=True)
        else:
            y, tail, state = gated_delta_step(weights, h, cfg, lf,
                                              cache_in[1], cache_in[2])
        pieces = ("lin", tail, state)
    else:
        kv = None if cache_in is None else (cache_in[1], cache_in[2])
        y, k, v = full_attention_with_cache(weights, h, cos, sin, cfg, lf,
                                            kv, pos, fused)
        pieces = ("full", k, v)
    x = x + y
    h = rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps, off)
    return x + _mlp(weights, h, cfg, lf, fused, capacity_factor), pieces
