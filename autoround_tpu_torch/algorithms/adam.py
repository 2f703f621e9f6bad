"""AdamRound's optimizer as a small functional optimizer (the JAX
package's ``optax.chain(scale_by_adam(), scale_by_schedule(-lr * max(1 -
t / iters, 0)))``, written out as tensor code).

Per leaf, with the step count ``c`` incremented before the bias
correction (``c = 1`` on the first step) and the schedule's ``t`` starting
at 0::

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    update = -lr * max(1 - t / iters, 0)
             * (mu / (1 - b1**c)) / (sqrt(nu / (1 - b2**c)) + eps)

b1 0.9, b2 0.999, eps 1e-8 outside the root, nothing inside it.  The
moments are fp32 like the parameters and are updated in place; the scalar
factors are computed on the host in float32.  There is no per-leaf
learning-rate multiplier and no momentum: the JAX package's Adam branch
takes neither, so ``minmax_lr`` and ``momentum`` do nothing under Adam.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..utils.pytree import tree_map

__all__ = ["AdamState", "adam"]


class AdamState(NamedTuple):
    count: int        # Adam's step count, before this step's increment
    mu: Any           # tree like params
    nu: Any


def _update(grads, mu, nu, b1, b2, one_b1, one_b2, bc1, bc2, eps, step):
    """The update of every leaf, written over its gradient.  (Module level:
    a nested function that calls itself would be a reference cycle.)"""
    if isinstance(grads, dict):
        return {k: _update(grads[k], mu[k], nu[k], b1, b2, one_b1, one_b2,
                           bc1, bc2, eps, step) for k in grads}
    g = grads
    mu.mul_(b1).add_(g * one_b1)
    nu.mul_(b2).add_(g * g * one_b2)
    # step * mu_hat / (sqrt(nu_hat) + eps), the denominator in g's storage
    denom = torch.div(nu, bc2, out=g).sqrt_().add_(eps)
    return torch.div(mu, bc1).div_(denom).mul_(step)


B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.scale_by_adam's defaults


def adam(lr: float, total_steps: int):
    """Build (init, update) with :func:`signsgd.sign_sgd`'s interface:
    ``update(grads, state)`` returns the parameter deltas (written over the
    gradients) and the next state."""
    f32 = np.float32
    b1, b2, eps = B1, B2, EPS
    one_b1, one_b2 = float(f32(1 - b1)), float(f32(1 - b2))

    def init(params) -> AdamState:
        return AdamState(count=0, mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def update(grads, state: AdamState, params=None):
        del params
        t = state.count                  # the schedule's count, from 0
        c = t + 1                        # Adam's count after its increment
        bc1 = float(f32(1) - f32(b1) ** f32(c))
        bc2 = float(f32(1) - f32(b2) ** f32(c))
        frac = np.maximum(f32(1) - f32(t) / f32(max(total_steps, 1)), f32(0))
        step = float(f32(-lr) * frac)
        updates = _update(grads, state.mu, state.nu, float(f32(b1)),
                          float(f32(b2)), one_b1, one_b2, bc1, bc2,
                          float(f32(eps)), step)
        return updates, AdamState(count=c, mu=state.mu, nu=state.nu)

    return init, update
