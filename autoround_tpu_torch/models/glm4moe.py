"""GLM-4.6-Lite in PyTorch (the ``GlmMoeLiteConfig`` of
``autoround_tpu/models/glm4moe.py``).

GLM-4.6-Lite (HF ``Glm4MoeLiteForCausalLM``, ``model_type``
``glm4_moe_lite``) is DeepSeek-V2 in architecture: MLA attention and
DeepSeek-MoE with sigmoid scores, the aux-free bias, group limiting and
shared experts.  Everything runs through :mod:`.deepseek`; this subclass is
the registry's and the loader's marker, with the GLM preset.

Not ported: ``Glm4MoeConfig`` (GLM-4.5 / 4.5-Air: GQA attention with
partial rotary and the DeepSeek router), ROADMAP A item 5.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from .deepseek import DeepseekConfig

__all__ = ["GlmMoeLiteConfig", "CONFIG_PRESETS"]


@dataclass(frozen=True)
class GlmMoeLiteConfig(DeepseekConfig):
    """GLM-4.6-Lite: a DeepSeek-V2 architecture (the JAX package's
    subclass adds no field)."""


CONFIG_PRESETS: Dict[str, GlmMoeLiteConfig] = {
    "tiny-glmlite": GlmMoeLiteConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=4, rope_theta=10000.0,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        n_shared_experts=1, first_k_dense=1, routed_scaling_factor=1.8,
        scoring_func="sigmoid", n_group=2, topk_group=1,
        norm_topk_prob=True, dtype=torch.float32),
}
