"""Token sampling for the serving engine (counterpart of
``autoround_tpu/serve/sampling.py``): greedy, or temperature / top-k /
top-p with an explicit ``torch.Generator``.

  * ``temperature == 0`` → greedy argmax (the default);
  * ``temperature > 0``  → logits / temperature;
  * ``top_k > 0``        → keep the k highest logits;
  * ``top_p < 1``        → keep the smallest prefix of the descending
    distribution whose mass reaches top_p (the head token always stays).

The same generator state gives the same tokens; the numbers differ from
the JAX package's (another generator).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["SamplingParams", "sample_token"]


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 → greedy
    top_k: int = 0               # 0 → no top-k truncation
    top_p: float = 1.0           # 1 → no nucleus truncation
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _mask_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = cum_before < top_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
    return logits.masked_fill(~keep, float("-inf"))


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 sp: Optional[SamplingParams]) -> torch.Tensor:
    """(B, V) logits → (B,) int32 token ids.  Greedy when ``sp`` is None
    or has temperature 0 (``generator`` may be None then)."""
    if sp is None or sp.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / max(sp.temperature, 1e-6)
    if sp.top_k and sp.top_k > 0:
        x = _mask_top_k(x, int(sp.top_k))
    if sp.top_p < 1.0:
        x = _mask_top_p(x, sp.top_p)
    probs = torch.softmax(x, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
