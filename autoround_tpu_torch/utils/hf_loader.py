"""HF checkpoint ↔ parameter tree (counterpart of
``autoround_tpu/utils/hf_loader.py``) for the families the port has:
``llama`` (with Llama-3.1 ``rope_scaling``), ``mistral``, ``qwen2``,
``qwen3``, ``gemma2``, ``gemma3_text``, ``phi3``, ``mixtral``,
``qwen2_moe`` and ``qwen3_moe``.

``load_hf_checkpoint`` reads a local safetensors checkpoint (one file, or
shards through ``model.safetensors.index.json``) with the port's own
reader (``utils/safetensors_io.py``) straight onto the caller's device, one
tensor at a time: nothing holds a second full copy on the host.
``save_hf_checkpoint`` writes one, byte-equal to the JAX package's for the
same weights.  Weights keep the HF (out, in) layout, which is the port's.

Not ported: the other ``model_type``s the JAX function knows (DeepSeek,
GLM, Step-3.5, Llama4, Qwen3-Next / 3.5, MiniMax, GPT-OSS) raise naming
ROADMAP A11, and an FP8-source checkpoint (a ``weight_scale_inv`` /
``weight_scale`` key, or an F8 weight) raises naming A12
(``quantize/model_free.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from .._device import resolve_device
from ..models.llama import LlamaConfig
from ..models.mixtral import MixtralConfig
from .logger import logger
from .safetensors_io import SafeOpen, save_file

__all__ = ["load_hf_checkpoint", "save_hf_checkpoint", "config_from_hf",
           "shard_files"]

_BLOCK_MAP = {
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "self_attn.q_proj.bias": "q_bias",
    "self_attn.k_proj.bias": "k_bias",
    "self_attn.v_proj.bias": "v_bias",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
    "input_layernorm.weight": "input_layernorm",
    "post_attention_layernorm.weight": "post_attention_layernorm",
    # Qwen3 per-head qk-norm gains
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    # Gemma2 sandwich norms
    "pre_feedforward_layernorm.weight": "pre_feedforward_layernorm",
    "post_feedforward_layernorm.weight": "post_feedforward_layernorm",
}
_TOP_MAP = {
    "model.embed_tokens.weight": "embed_tokens",
    "model.norm.weight": "norm",
    "lm_head.weight": "lm_head",
}

# model_types of the JAX loader whose models are not ported yet
_UNPORTED_TYPES = ("deepseek_v2", "deepseek_v3", "glm4_moe_lite",
                   "glm_moe_dsa", "step3p5", "glm4_moe", "llama4_text",
                   "qwen3_next", "qwen3_5_moe", "qwen3_5", "minimax",
                   "gpt_oss")
_FP8_SCALES = (".weight_scale_inv", ".weight_scale")


def config_from_hf(cfg: Dict[str, Any], dtype=torch.bfloat16) -> LlamaConfig:
    """HF config.json dict → ``LlamaConfig`` (per-family quirks by
    ``model_type``), or a ``MixtralConfig`` for Mixtral-style
    (``num_local_experts``) and Qwen2/3-MoE configs."""
    mt = cfg.get("model_type", "llama")
    if mt in _UNPORTED_TYPES:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported yet (ROADMAP A11: the MoE "
            f"and MLA families)")
    gemma = mt.startswith("gemma")
    qpas = cfg.get("query_pre_attn_scalar")
    cls = LlamaConfig
    moe_kw: Dict[str, Any] = {}
    intermediate = cfg["intermediate_size"]
    if cfg.get("num_local_experts") or mt == "mixtral":
        cls = MixtralConfig
        moe_kw = dict(num_experts=cfg.get("num_local_experts", 8),
                      top_k=cfg.get("num_experts_per_tok", 2))
    elif mt in ("qwen2_moe", "qwen3_moe") or cfg.get("num_experts"):
        # Qwen2-MoE: routed experts at moe_intermediate_size + an
        # always-on sigmoid-gated shared expert.  Qwen3-MoE: the same
        # experts, no shared expert, per-head q/k RMSNorm.
        cls = MixtralConfig
        intermediate = cfg.get("moe_intermediate_size", intermediate)
        shared = cfg.get("shared_expert_intermediate_size", 0) or 0
        moe_kw = dict(
            num_experts=cfg.get("num_experts", 8),
            top_k=cfg.get("num_experts_per_tok", 2),
            shared_expert_intermediate=shared,
            shared_expert_gate=shared > 0,
            norm_topk_prob=cfg.get("norm_topk_prob", True))
    rs = cfg.get("rope_scaling") or {}
    return cls(
        **moe_kw,
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=intermediate,
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        head_dim=cfg.get("head_dim"),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", gemma),
        attn_bias=cfg.get("attention_bias", mt in ("qwen2", "qwen2_moe")),
        qk_norm=mt in ("qwen3", "qwen3_moe", "gemma3_text"),
        norm_offset=1.0 if gemma else 0.0,
        # Gemma2 names the field hidden_activation; others hidden_act
        hidden_act=("gelu_tanh" if cfg.get(
            "hidden_activation", cfg.get("hidden_act", "silu"))
            in ("gelu_pytorch_tanh", "gelu_tanh") else "silu"),
        embed_scale=gemma,
        sandwich_norms=mt in ("gemma2", "gemma3_text"),
        attn_logit_softcap=cfg.get("attn_logit_softcapping") or 0.0,
        final_logit_softcap=cfg.get("final_logit_softcapping") or 0.0,
        attn_scale=(float(qpas) ** 0.5 if qpas else None),
        sliding_window=(cfg.get("sliding_window")
                        if mt in ("gemma2", "gemma3_text") else None),
        # Gemma3: a sliding pattern and dual rope (the local base
        # frequency on sliding layers, linear scaling on global ones)
        layer_types=(tuple(cfg["layer_types"])
                     if mt == "gemma3_text" and cfg.get("layer_types")
                     else None),
        rope_local_theta=(cfg.get("rope_local_base_freq", 0.0)
                          if mt == "gemma3_text" else 0.0),
        rope_scaling_factor=(rs.get("factor", 1.0)
                             if mt == "gemma3_text"
                             and rs.get("rope_type") == "linear" else 1.0),
        rope_llama3=_llama3_rope(cfg),
        dtype=dtype,
    )


def _llama3_rope(cfg: Dict[str, Any]):
    """HF rope_scaling rope_type 'llama3' → (factor, low, high, orig)
    (Llama-3.1+)."""
    rs = cfg.get("rope_scaling") or {}
    if rs.get("rope_type", rs.get("type")) != "llama3":
        return None
    return (rs.get("factor", 8.0), rs.get("low_freq_factor", 1.0),
            rs.get("high_freq_factor", 4.0),
            rs.get("original_max_position_embeddings", 8192))


def shard_files(path: str) -> List[str]:
    """The safetensors files of a checkpoint directory: the shards named
    by ``model.safetensors.index.json`` (sorted), else
    ``model.safetensors``."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    return ["model.safetensors"]


def _iter_shards(path: str, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (key, tensor on ``device``) over every shard, one tensor at a
    time.  An FP8-source checkpoint raises before any tensor is read."""
    files = [os.path.join(path, s) for s in shard_files(path)]
    for sp in files:
        with SafeOpen(sp, device=device) as f:
            for key in f.keys():
                if key.endswith(_FP8_SCALES) or f.dtype_code(key) in (
                        "F8_E4M3", "F8_E5M2"):
                    raise NotImplementedError(
                        f"{sp}: {key} marks an FP8-source checkpoint; "
                        f"dequantizing FP8 sources is not ported yet "
                        f"(ROADMAP A12, quantize/model_free.py)")
    for sp in files:
        with SafeOpen(sp, device=device) as f:
            for key in f.keys():
                yield key, f.get_tensor(key)


def _map_key(sub: str, block: Dict[str, Any], arr: torch.Tensor,
             cfg: LlamaConfig) -> bool:
    """Put one ``model.layers.<i>.<sub>`` tensor into its block; False
    when the key has no place in the port's tree."""
    if sub in _BLOCK_MAP:
        block[_BLOCK_MAP[sub]] = arr
        return True
    # Mixtral: block_sparse_moe.gate → router, experts.E.w{1,2,3}
    if sub == "block_sparse_moe.gate.weight":
        block["router"] = arr
        return True
    if sub.startswith("block_sparse_moe.experts."):
        parts = sub.split(".")
        if parts[3] in ("w1", "w2", "w3"):
            block["experts"][int(parts[2])][parts[3]] = arr
            return True
        return False
    # Phi-3 fused projections, split on load so each quantizes alone
    if sub == "self_attn.qkv_proj.weight":
        qd = cfg.num_heads * cfg.hd
        kvd = cfg.num_kv_heads * cfg.hd
        block["q_proj"] = arr[:qd]
        block["k_proj"] = arr[qd: qd + kvd]
        block["v_proj"] = arr[qd + kvd:]
        return True
    if sub == "mlp.gate_up_proj.weight":
        half = arr.shape[0] // 2
        block["gate_proj"] = arr[:half]
        block["up_proj"] = arr[half:]
        return True
    # Qwen2/3-MoE: mlp.gate → router, experts' gate/up/down → w1/w3/w2,
    # the shared expert and its gate
    qmap = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
    if sub == "mlp.gate.weight":
        block["router"] = arr
        return True
    if sub.startswith("mlp.experts."):
        parts = sub.split(".")
        wname = qmap.get(parts[3]) if len(parts) > 3 else None
        if wname:
            block["experts"][int(parts[2])][wname] = arr
            return True
        return False
    if sub.startswith("mlp.shared_expert."):
        wname = qmap.get(sub.split(".")[2])
        if wname:
            block.setdefault("shared_expert", {})[wname] = arr
            return True
        return False
    if sub == "mlp.shared_expert_gate.weight":
        block["shared_expert_gate"] = arr
        return True
    return False


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device=None
                       ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """Load a local HF checkpoint directory (``config.json`` and
    safetensors) → (params on ``device`` in ``dtype``, config).
    ``device=None`` means the CUDA card and raises without one."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, dtype)
    n_experts = getattr(cfg, "num_experts", 0)
    blocks = [({"experts": [dict() for _ in range(n_experts)]}
               if n_experts else dict()) for _ in range(cfg.num_layers)]
    params: Dict[str, Any] = {"blocks": blocks}
    n = 0
    for key, tensor in _iter_shards(path, dev):
        arr = tensor.to(dtype)
        del tensor
        if key in _TOP_MAP:
            params[_TOP_MAP[key]] = arr
            n += 1
            continue
        if key.startswith("model.layers."):
            li, sub = key[len("model.layers."):].split(".", 1)
            if _map_key(sub, blocks[int(li)], arr, cfg):
                n += 1
                continue
        logger.debug("skipping unmapped tensor %s", key)
    if cfg.tie_embeddings:
        params.pop("lm_head", None)
    missing = [i for i, b in enumerate(blocks) if "q_proj" not in b]
    if missing:
        raise ValueError(f"blocks missing attention weights: {missing}")
    logger.info("loaded %d tensors from %s", n, path)
    return params, cfg


def save_hf_checkpoint(params: Dict[str, Any], cfg: LlamaConfig, path: str,
                       hf_extra: Optional[Dict[str, Any]] = None) -> str:
    """Write params as an HF-layout single-file safetensors checkpoint
    (tensors on any device; each crosses to the host alone while the file
    is written)."""
    os.makedirs(path, exist_ok=True)
    inv_block = {v: k for k, v in _BLOCK_MAP.items()}
    qwen_moe = bool(getattr(cfg, "shared_expert_intermediate", 0))
    inv_q = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}
    tensors: Dict[str, torch.Tensor] = {}
    for hf_key, ours in _TOP_MAP.items():
        if params.get(ours) is not None:
            tensors[hf_key] = params[ours]
    for li, block in enumerate(params["blocks"]):
        pre = f"model.layers.{li}."
        for ours, arr in block.items():
            if ours in inv_block:
                tensors[pre + inv_block[ours]] = arr
            elif ours == "router":
                key = ("mlp.gate.weight" if qwen_moe
                       else "block_sparse_moe.gate.weight")
                tensors[pre + key] = arr
            elif ours == "experts":
                for e, ew in enumerate(arr):
                    for wn, wv in ew.items():
                        key = (f"mlp.experts.{e}.{inv_q[wn]}.weight"
                               if qwen_moe else
                               f"block_sparse_moe.experts.{e}.{wn}.weight")
                        tensors[pre + key] = wv
            elif ours == "shared_expert":
                for wn, wv in arr.items():
                    tensors[f"{pre}mlp.shared_expert.{inv_q[wn]}.weight"] \
                        = wv
            elif ours == "shared_expert_gate":
                tensors[f"{pre}mlp.shared_expert_gate.weight"] = arr
    save_file(tensors, os.path.join(path, "model.safetensors"))

    n_experts = getattr(cfg, "num_experts", 0)
    hf_cfg = {
        "model_type": ("qwen2_moe" if qwen_moe else "mixtral" if n_experts
                       else "qwen2" if cfg.attn_bias else "llama"),
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": cfg.attn_bias,
        "torch_dtype": "bfloat16",
    }
    if qwen_moe:
        hf_cfg["num_experts"] = n_experts
        hf_cfg["num_experts_per_tok"] = getattr(cfg, "top_k", 2)
        hf_cfg["moe_intermediate_size"] = cfg.intermediate_size
        hf_cfg["shared_expert_intermediate_size"] = \
            cfg.shared_expert_intermediate
        hf_cfg["norm_topk_prob"] = cfg.norm_topk_prob
    elif n_experts:
        hf_cfg["num_local_experts"] = n_experts
        hf_cfg["num_experts_per_tok"] = getattr(cfg, "top_k", 2)
    if hf_extra:
        hf_cfg.update(hf_extra)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return path
