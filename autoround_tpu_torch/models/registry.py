"""Model-family dispatch: config type → model functions (counterpart of
``autoround_tpu/models/registry.py``).  The orchestrator, the API and the
serving engine stay model-agnostic by looking the family up here; a family
ported later adds its branch above the ones it subclasses.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

from . import (deepseek, ernie45, glm4moe, glmdsa, gptoss, llama, llama4,
               longcat, minimax, mixtral, qwen3next, step35)

__all__ = ["get_model_fns", "ALL_PRESETS"]


def get_model_fns(cfg) -> SimpleNamespace:
    """The namespace of model functions for a config.  Every family has:
    init_params, block_fwd, embed_fwd, final_fwd, rope_tables, model_fwd,
    block_linear_names; a family whose layers differ in kind (Llama 4's
    rope and NoPE layers, the hybrids' linear and full attention) adds
    ``block_fwd_for(cfg, li)``, the layer's own forward; a hybrid family
    (Qwen3-Next, MiniMax) adds ``block_with_cache``, its serving block,
    ``layer_is_linear(cfg, li)`` and ``linear_cache_shapes(cfg)``, the
    per-slot shapes of a linear layer's conv tail and state."""
    # DeepseekConfig and MixtralConfig subclass LlamaConfig: test them
    # first, and the DeepSeek subclasses before DeepseekConfig (GLM-4.5's
    # GQA form, GLM-5 DSA, LongCat; GlmMoeLiteConfig is DeepSeek's own)
    if isinstance(cfg, glm4moe.Glm4MoeConfig):
        return SimpleNamespace(
            init_params=glm4moe.init_params,
            block_fwd=glm4moe.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,       # partial rotary
            model_fwd=glm4moe.model_fwd,
            block_linear_names=glm4moe.block_linear_names,
        )
    if isinstance(cfg, glmdsa.GlmMoeDsaConfig):
        return SimpleNamespace(
            init_params=glmdsa.init_params,
            block_fwd=glmdsa.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=deepseek.rope_tables,
            model_fwd=glmdsa.model_fwd,
            block_linear_names=glmdsa.block_linear_names,
        )
    if isinstance(cfg, longcat.LongcatConfig):
        return SimpleNamespace(
            init_params=longcat.init_params,
            block_fwd=longcat.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=deepseek.rope_tables,
            model_fwd=longcat.model_fwd,
            block_linear_names=longcat.block_linear_names,
        )
    if isinstance(cfg, deepseek.DeepseekConfig):
        return SimpleNamespace(
            init_params=deepseek.init_params,
            block_fwd=deepseek.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=deepseek.rope_tables,
            model_fwd=deepseek.model_fwd,
            block_linear_names=deepseek.block_linear_names,
        )
    # Qwen3NextConfig (and Qwen35MoeConfig) subclass MixtralConfig
    if isinstance(cfg, qwen3next.Qwen3NextConfig):
        return SimpleNamespace(
            init_params=qwen3next.init_params,
            block_fwd=qwen3next.block_fwd,
            block_fwd_for=qwen3next.block_fwd_for,  # DeltaNet vs full attn
            block_with_cache=qwen3next.block_with_cache,  # hybrid serving
            layer_is_linear=qwen3next.is_linear_layer,
            linear_cache_shapes=qwen3next.linear_cache_shapes,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,
            model_fwd=qwen3next.model_fwd,
            block_linear_names=qwen3next.block_linear_names,
        )
    # MiniMaxConfig subclasses MixtralConfig
    if isinstance(cfg, minimax.MiniMaxConfig):
        return SimpleNamespace(
            init_params=minimax.init_params,
            block_fwd=minimax.block_fwd,
            block_fwd_for=minimax.block_fwd_for,  # lightning vs full attn
            block_with_cache=minimax.block_with_cache,  # hybrid serving
            layer_is_linear=minimax.layer_is_linear,
            linear_cache_shapes=minimax.linear_cache_shapes,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,
            model_fwd=minimax.model_fwd,
            block_linear_names=minimax.block_linear_names,
        )
    if isinstance(cfg, mixtral.MixtralConfig):
        return SimpleNamespace(
            init_params=mixtral.init_params,
            block_fwd=mixtral.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,
            model_fwd=mixtral.model_fwd,
            block_linear_names=mixtral.block_linear_names,
        )
    # GPT-OSS, Llama 4, Step-3.5 and ERNIE-4.5 subclass LlamaConfig: test
    # them before it
    if isinstance(cfg, step35.Step35Config):
        return SimpleNamespace(
            init_params=step35.init_params,
            block_fwd=step35.block_fwd,
            block_fwd_for=step35.block_fwd_for,   # full vs sliding heads
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,
            model_fwd=step35.model_fwd,
            block_linear_names=step35.block_linear_names,
        )
    if isinstance(cfg, ernie45.Ernie45Config):
        return SimpleNamespace(
            init_params=ernie45.init_params,
            block_fwd=ernie45.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,
            model_fwd=ernie45.model_fwd,
            block_linear_names=ernie45.block_linear_names,
        )
    if isinstance(cfg, llama4.Llama4Config):
        return SimpleNamespace(
            init_params=llama4.init_params,
            block_fwd=llama4.block_fwd,
            block_fwd_for=llama4.block_fwd_for,   # rope vs NoPE layers
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,
            model_fwd=llama4.model_fwd,
            block_linear_names=llama4.block_linear_names,
        )
    if isinstance(cfg, gptoss.GptOssConfig):
        return SimpleNamespace(
            init_params=gptoss.init_params,
            block_fwd=gptoss.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=gptoss.rope_tables,
            model_fwd=gptoss.model_fwd,
            block_linear_names=gptoss.block_linear_names,
        )
    if isinstance(cfg, llama.LlamaConfig):
        return SimpleNamespace(
            init_params=llama.init_params,
            block_fwd=llama.block_fwd,
            embed_fwd=llama.embed_fwd,
            final_fwd=llama.final_fwd,
            rope_tables=llama.rope_tables,
            model_fwd=llama.model_fwd,
            block_linear_names=llama.block_linear_names,
        )
    raise TypeError(f"unknown model config type {type(cfg)}")


ALL_PRESETS: Dict[str, Any] = {}
ALL_PRESETS.update(llama.CONFIG_PRESETS)
ALL_PRESETS.update(mixtral.CONFIG_PRESETS)
ALL_PRESETS.update(deepseek.CONFIG_PRESETS)
ALL_PRESETS.update(glm4moe.CONFIG_PRESETS)
ALL_PRESETS.update(glmdsa.CONFIG_PRESETS)
ALL_PRESETS.update(gptoss.CONFIG_PRESETS)
ALL_PRESETS.update(llama4.CONFIG_PRESETS)
ALL_PRESETS.update(qwen3next.CONFIG_PRESETS)
ALL_PRESETS.update(minimax.CONFIG_PRESETS)
ALL_PRESETS.update(ernie45.CONFIG_PRESETS)
ALL_PRESETS.update(longcat.CONFIG_PRESETS)
ALL_PRESETS.update(step35.CONFIG_PRESETS)
