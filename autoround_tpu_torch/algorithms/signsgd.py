"""Sign-SGD as a small functional optimizer (counterpart of
``autoround_tpu/algorithms/signsgd.py``).

``param += -lr_t * sign(grad)`` with the linear decay
``lr_t = lr * max(1 - t / total, 0)`` (t starts at 0) and a per-leaf LR
multiplier, so the clip scales (``min_scale`` / ``max_scale``) can train at
``minmax_lr`` while the rounding offsets ``v`` train at ``lr``.

``sign(0) == 0``, so parameters a dtype ignores (zero gradient) never move.
The step counter lives on the host: the learning rate is a Python number,
computed in float32 as the JAX package computes it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.pytree import tree_map

__all__ = ["SignSGDState", "sign_sgd", "linear_decay_schedule"]


class SignSGDState(NamedTuple):
    step: int
    momentum: Optional[Any]  # tree like params, or None


def linear_decay_schedule(lr: float, total_steps: int) -> Callable:
    """lr_t = lr * (1 - t / total), in float32."""
    def schedule(step: int) -> np.float32:
        frac = np.float32(1.0) - np.float32(step) / np.float32(
            max(total_steps, 1))
        return np.float32(lr) * np.maximum(frac, np.float32(0.0))
    return schedule


def _signed_steps(node: Dict[str, Any], cur_lr, lr_scale_fn,
                  in_place: bool) -> Dict[str, Any]:
    """``-lr * scale(name) * sign(g)`` for every leaf, over the gradients
    themselves when ``in_place``.  (Module level: a nested function that
    calls itself would be a reference cycle.)"""
    out = {}
    for name, g in node.items():
        if isinstance(g, dict):
            out[name] = _signed_steps(g, cur_lr, lr_scale_fn, in_place)
            continue
        scale = lr_scale_fn(name) if lr_scale_fn is not None else 1.0
        step = float(np.float32(-cur_lr) * np.float32(scale))
        out[name] = g.sign_().mul_(step) if in_place \
            else torch.sign(g) * step
    return out


def sign_sgd(
    lr: float,
    total_steps: int,
    momentum: float = 0.0,
    lr_scale_fn: Optional[Callable[[str], float]] = None,
):
    """Build (init, update) for sign-SGD with linear decay.

    ``lr_scale_fn(leaf_name) -> float`` multiplies the LR per leaf, by the
    leaf's own key in its dict (used for minmax_lr).  ``update`` returns
    parameter *deltas* to add; without momentum it writes them over the
    gradients it was given (no second copy of the largest tensors).
    """
    schedule = linear_decay_schedule(lr, total_steps)

    def init(params) -> SignSGDState:
        mom = tree_map(torch.zeros_like, params) if momentum > 0.0 else None
        return SignSGDState(step=0, momentum=mom)

    def update(grads, state: SignSGDState, params=None):
        del params
        cur_lr = schedule(state.step)
        if state.momentum is not None:
            new_mom = tree_map(lambda m, g: momentum * m + g, state.momentum,
                               grads)
            eff_grads = new_mom
        else:
            new_mom = None
            eff_grads = grads

        return (_signed_steps(eff_grads, cur_lr, lr_scale_fn,
                              in_place=new_mom is None),
                SignSGDState(step=state.step + 1, momentum=new_mom))

    return init, update
