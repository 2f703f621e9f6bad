"""SignRound: block-wise sign-SGD tuning of rounding offsets + clip scales
(counterpart of ``autoround_tpu/algorithms/signround.py``).

The tunable state is one tree ``{layer: {v, min_scale, max_scale}}`` of
fp32 tensors; with ``tune_act_scales`` and static activation scales in the
weights' reserved ``_act_scales`` entry it also holds ``_act: {layer:
{scale}}``, one shrink factor per static scale, trained with the clip
scales.  Each step substitutes the block's quantized layers with
their qdq'd weights, runs the caller's pure ``block_fwd(weights, inputs)``
on a batch, takes MSE(pred, fp_ref) x ``loss_scale`` and moves the state
by sign-SGD.  The step loop is a Python loop (the JAX package scans); it
never reads a loss back to the host: the best-loss snapshot is kept on the
device with ``torch.where``, ``dynamic_max_gap`` is a device flag that
freezes further updates, and the loss trace is fetched once at the end.
The tuned tensors are updated in place.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item): ``enable_alg_ext``, ``optimizer="adam"``,
``enable_norm_bias_tuning``, ``lfq_fn``, ``extras``, ``init_scales``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..dtypes.intq import _clip
from ..dtypes.registry import get_quant_func
from ..schemes import QuantizationScheme
from ..utils.pytree import get_by_path, set_by_path, tree_map
from .signsgd import sign_sgd

__all__ = ["TuneConfig", "init_tune_params", "make_qdq_weights",
           "tune_block", "mse_loss", "batch_indices"]


@dataclass(frozen=True)
class TuneConfig:
    """Tuning hyper-parameters (the JAX package's field surface)."""

    iters: int = 200
    lr: Optional[float] = None          # None → 1/iters
    minmax_lr: Optional[float] = None   # None → lr
    batch_size: int = 8
    seed: int = 42
    enable_minmax_tuning: bool = True
    enable_round_tuning: bool = True
    use_best_params: bool = True
    dynamic_max_gap: int = -1           # >0 → freeze updates after no-improve gap
    momentum: float = 0.0
    clip_lo: float = 0.0                # min/max_scale clamp range
    clip_hi: float = 1.0
    loss_scale: float = 1000.0
    gradient_accumulate_steps: int = 1
    enable_alg_ext: bool = False        # not ported (ROADMAP A3)
    outlier_mask_frac: float = 0.001
    optimizer: str = "signsgd"          # "adam" not ported (ROADMAP A3)
    # recompute the block forward in the backward pass instead of holding
    # its activations (trades FLOPs for device memory)
    use_remat: bool = False
    # tune a per-layer shrink on the static activation scales, clamped to
    # [clip_lo, clip_hi] like the clip scales
    tune_act_scales: bool = False
    enable_norm_bias_tuning: bool = False  # not ported (ROADMAP A3)

    def resolved_lr(self) -> float:
        return self.lr if self.lr is not None else 1.0 / max(self.iters, 1)

    def resolved_minmax_lr(self) -> float:
        return self.minmax_lr if self.minmax_lr is not None else self.resolved_lr()


def _check_ported(cfg: TuneConfig, extras=None, lfq_fn=None,
                  init_scales=None) -> None:
    """Raise for every option of the JAX ``tune_block`` this slice leaves
    out."""
    unported = [
        (cfg.enable_alg_ext, "enable_alg_ext (SignRoundV2 searched init and "
         "outlier-masked loss)", "A3"),
        (cfg.optimizer != "signsgd", f"optimizer={cfg.optimizer!r} "
         "(AdamRound)", "A3"),
        (cfg.enable_norm_bias_tuning, "enable_norm_bias_tuning", "A3"),
        (lfq_fn is not None, "lfq_fn (last-block LM loss)", "A5"),
        (extras is not None, "extras (per-layer statics: imatrix, frozen "
         "double-quant grids)", "A9"),
        (init_scales is not None, "init_scales (AWQ clip search)", "A12"),
    ]
    for on, what, item in unported:
        if on:
            raise NotImplementedError(
                f"tune_block: {what} is not ported yet (ROADMAP {item})")


def init_tune_params(
    weights: Dict[str, Any],
    schemes: Dict[str, QuantizationScheme],
    cfg: TuneConfig,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """V = 0 (shape of W), min/max_scale = 1.0 per group, (O, groups) in the
    weight's row layout.  fp32 tensors on the weight's device."""
    params = {}
    for name, scheme in schemes.items():
        w = get_by_path(weights, name)
        O, I = w.shape
        g = scheme.group_size if scheme.group_size not in (-1, 0) else I
        # 2-D block groups (block FP8): per-tensor clip scales
        groups_shape = (1, 1) if isinstance(g, tuple) else (O, -(-I // g))
        layer = {}
        if cfg.enable_round_tuning:
            layer["v"] = torch.zeros((O, I), dtype=torch.float32,
                                     device=w.device)
        if cfg.enable_minmax_tuning:
            for key in ("min_scale", "max_scale"):
                layer[key] = torch.ones(groups_shape, dtype=torch.float32,
                                        device=w.device)
        params[name] = layer
    if (cfg.tune_act_scales and isinstance(weights, dict)
            and "_act_scales" in weights):
        static = weights["_act_scales"].get("static") or {}
        # the leaf key "scale" puts these into the min/max learning-rate
        # group
        act = {n: {"scale": torch.ones((), dtype=torch.float32,
                                       device=static[n].device)}
               for n in static if n in schemes}
        if act:
            params["_act"] = act
    return params


def make_qdq_weights(
    weights: Dict[str, Any],
    tune_params: Dict[str, Dict[str, torch.Tensor]],
    schemes: Dict[str, QuantizationScheme],
    cfg: TuneConfig,
) -> Dict[str, Any]:
    """Substitute qdq'd weights for every tuned layer; pass the rest
    through.  Layer names may be dotted paths into nested structures.
    This is the tuning loss's qdq, which the JAX package runs under
    ``jit``: the float types divide by their constants as XLA compiles it
    (``recip``)."""
    out = weights
    if ("_act" in tune_params and isinstance(weights, dict)
            and "_act_scales" in weights):
        sc = dict(weights["_act_scales"])
        static = dict(sc.get("static") or {})
        for n, m in tune_params["_act"].items():
            if n in static:
                static[n] = static[n] * _clip(m["scale"], cfg.clip_lo,
                                              cfg.clip_hi)
        sc["static"] = static
        out = dict(out)
        out["_act_scales"] = sc
    for name, scheme in schemes.items():
        fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
        p = tune_params.get(name, {})
        r = fn(get_by_path(weights, name), bits=scheme.bits,
               group_size=scheme.group_size, v=p.get("v"),
               min_scale=p.get("min_scale"), max_scale=p.get("max_scale"),
               clip_lo=cfg.clip_lo, clip_hi=cfg.clip_hi, recip=True)
        out = set_by_path(out, name, r.qdq)
    return out


def mse_loss(pred: torch.Tensor, ref: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE in fp32; optional valid-token mask (leading axes of ``pred``)."""
    diff = (pred.float() - ref.float()) ** 2
    if mask is None:
        return diff.mean()
    m = mask.float()
    while m.ndim < diff.ndim:
        m = m[..., None]
    denom = torch.clamp(m.sum() * (diff.numel() / m.numel()), min=1.0)
    return (diff * m).sum() / denom


def batch_indices(nsamples: int, cfg: TuneConfig) -> np.ndarray:
    """(iters, gradient_accumulate_steps, bs) sample indices: cyclic
    shuffled epochs from ``np.random.default_rng(cfg.seed)``, the JAX
    package's order to the index."""
    bs = min(cfg.batch_size, nsamples)
    rng = np.random.default_rng(cfg.seed)
    n_batches_per_epoch = max(nsamples // bs, 1)
    idx_epochs = []
    total_draws = cfg.iters * cfg.gradient_accumulate_steps
    while len(idx_epochs) * n_batches_per_epoch < total_draws:
        perm = rng.permutation(nsamples)[: n_batches_per_epoch * bs]
        idx_epochs.append(perm.reshape(n_batches_per_epoch, bs))
    all_idx = np.concatenate(idx_epochs)[:total_draws]
    return all_idx.reshape(cfg.iters, cfg.gradient_accumulate_steps, bs)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _like(tree, leaves):
    """``tree`` with its leaves replaced by ``leaves``, in ``_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tune_block(
    block_fwd: Callable[[Dict[str, Any], Any], torch.Tensor],
    weights: Dict[str, Any],
    inputs: Any,
    ref_outputs: torch.Tensor,
    schemes: Dict[str, QuantizationScheme],
    cfg: TuneConfig,
    mask: Optional[torch.Tensor] = None,
    extras=None,
    lfq_fn: Optional[Callable] = None,
    init_scales=None,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
    """Tune one block's rounding params.  Returns (best_params, info).

    inputs: tensor (or tree of tensors) batched along axis 0 with nsamples
    (cached block inputs); ref_outputs: (nsamples, ...) FP block outputs.
    mask: optional (nsamples, seqlen) validity mask.  ``info`` holds
    ``loss_trace`` (numpy, one loss per iteration), ``first_loss`` and
    ``best_loss``.  Gradients are taken here under ``torch.enable_grad()``
    whatever the caller's mode; the returned tensors carry no graph.
    """
    _check_ported(cfg, extras, lfq_fn, init_scales)
    fwd = block_fwd
    if cfg.use_remat:
        def fwd(w, x):
            return checkpoint(block_fwd, w, x, use_reentrant=False)

    nsamples = _leaves(inputs)[0].shape[0]
    device = ref_outputs.device
    batch_idx = torch.as_tensor(batch_indices(nsamples, cfg), device=device)
    accum = cfg.gradient_accumulate_steps

    params = init_tune_params(weights, schemes, cfg)
    leaves = _leaves(params)
    lr_scale = cfg.resolved_minmax_lr() / max(cfg.resolved_lr(), 1e-12)
    opt_init, opt_update = sign_sgd(
        cfg.resolved_lr(), cfg.iters, momentum=cfg.momentum,
        lr_scale_fn=lambda n: lr_scale if "scale" in n else 1.0)
    opt_state = opt_init(params)

    def loss_fn(idx):
        qweights = make_qdq_weights(weights, params, schemes, cfg)
        batch_in = tree_map(lambda a: a.index_select(0, idx), inputs)
        batch_ref = ref_outputs.index_select(0, idx)
        batch_mask = None if mask is None else mask.index_select(0, idx)
        out = fwd(qweights, batch_in)
        return mse_loss(out, batch_ref, batch_mask) * cfg.loss_scale

    def loss_and_grads(idx):
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = loss_fn(idx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    best_leaves = [p.clone() for p in leaves]
    best_loss = torch.full((), float("inf"), dtype=torch.float32,
                           device=device)
    since_best = torch.zeros((), dtype=torch.int32, device=device)
    losses = []
    with torch.no_grad():
        for it in range(cfg.iters):
            loss, grads = loss_and_grads(batch_idx[it, 0])
            for a in range(1, accum):
                l_a, g_a = loss_and_grads(batch_idx[it, a])
                loss = loss + l_a
                for g, ga in zip(grads, g_a):
                    g.add_(ga)
            if accum > 1:
                loss = loss / float(accum)
                for g in grads:
                    g.div_(float(accum))
            losses.append(loss)

            is_best = loss < best_loss
            for b, p in zip(best_leaves, leaves):
                torch.where(is_best, p, b, out=b)
            best_loss = torch.minimum(best_loss, loss)
            since_best = torch.where(is_best, torch.zeros_like(since_best),
                                     since_best + 1)

            updates, opt_state = opt_update(_like(params, grads), opt_state)
            if cfg.dynamic_max_gap > 0:
                frozen = since_best >= cfg.dynamic_max_gap
                for p, u in zip(leaves, _leaves(updates)):
                    p.copy_(torch.where(frozen, p, p + u))
            else:
                for p, u in zip(leaves, _leaves(updates)):
                    p.add_(u)
            del grads, updates        # not held through the next step

    if cfg.use_best_params:
        params = _like(params, best_leaves)
    trace = (torch.stack(losses).float().cpu().numpy() if losses
             else np.zeros((0,), np.float32))
    info = {
        "loss_trace": trace,
        "first_loss": float(trace[0]) if len(trace) else float("nan"),
        "best_loss": float(best_loss),
    }
    return params, info
