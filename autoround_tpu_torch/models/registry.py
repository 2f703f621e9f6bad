"""Model-family dispatch: config type → model functions (counterpart of
``autoround_tpu/models/registry.py``).  The orchestrator, the API and the
serving engine stay model-agnostic by looking the family up here; a family
ported later adds its branch above the ones it subclasses.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

from . import llama, mixtral

__all__ = ["get_model_fns", "ALL_PRESETS"]


def get_model_fns(cfg) -> SimpleNamespace:
    """The namespace of model functions for a config.  Every family has:
    init_params, block_fwd, embed_fwd, final_fwd, rope_tables, model_fwd,
    block_linear_names."""
    # MixtralConfig subclasses LlamaConfig: test it first
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
