"""SignRound: block-wise sign-SGD tuning of rounding offsets + clip scales
(counterpart of ``autoround_tpu/algorithms/signround.py``).

The tunable state is one tree ``{layer: {v, min_scale, max_scale}}`` of
fp32 tensors; with ``tune_act_scales`` and static activation scales in the
weights' reserved ``_act_scales`` entry it also holds ``_act: {layer:
{scale}}``, one shrink factor per static scale, trained with the clip
scales; with ``enable_norm_bias_tuning`` and ``norm_bias_leaves`` it holds
``_nb: {leaf: {v}}``, a round-free offset per norm gain and bias
(``dtypes.intq.qdq_asym_wo_round``), trained at the main learning rate.
Each step substitutes the block's quantized layers with their qdq'd
weights, runs the caller's pure ``block_fwd(weights, inputs)`` on a batch,
takes MSE(pred, fp_ref) x ``loss_scale`` (or the caller's ``lfq_fn``) and
moves the state by sign-SGD or, with ``optimizer="adam"``, by Adam
(``adam.py``).  ``enable_alg_ext`` seeds the clip scales from a per-group
search (but for the GGUF double-quant schemes, whose clip scales start at
1.0 on the frozen grid the caller passes in ``extras``), widens their
clamp to (0, 2) and, for schemes under 4 bits (or with activations at 4
bits or fewer), drops the largest ``outlier_mask_frac`` of the squared
errors from the loss.  ``init_scales`` (AWQ's clip search) seeds the clip
scales of the layers it names.  ``extras`` holds per-layer statics passed
to each layer's qdq as keywords; the registry's double-quant entries take
the JAX package's set of them, which leaves a frozen grid out.  The step
loop is a Python loop (the JAX package scans); it never reads a loss back
to the host: the best-loss snapshot is kept on the device with
``torch.where``, ``dynamic_max_gap`` is a device flag that freezes further
updates, and the loss trace is fetched once at the end.  The tuned tensors
are updated in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..dtypes.intq import _clip, qdq_asym_wo_round, search_init_scale_ratio
from ..dtypes.registry import get_quant_func
from ..schemes import QuantizationScheme
from ..utils.pytree import get_by_path, set_by_path, tree_map
from .adam import adam
from .signsgd import sign_sgd

__all__ = ["TuneConfig", "init_tune_params", "make_qdq_weights",
           "tune_block", "mse_loss", "batch_indices", "outlier_threshold"]


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
    # SignRoundV2: searched per-group init scale, clamp widened to (0, 2),
    # outlier-masked loss under 4 bits
    enable_alg_ext: bool = False
    outlier_mask_frac: float = 0.001
    optimizer: str = "signsgd"          # or "adam" (AdamRound)
    # recompute the block forward in the backward pass instead of holding
    # its activations (trades FLOPs for device memory)
    use_remat: bool = False
    # tune a per-layer shrink on the static activation scales, clamped to
    # [clip_lo, clip_hi] like the clip scales
    tune_act_scales: bool = False
    # tune norm gains and linear biases with a round-free asym-grid offset
    enable_norm_bias_tuning: bool = False

    def resolved_lr(self) -> float:
        return self.lr if self.lr is not None else 1.0 / max(self.iters, 1)

    def resolved_minmax_lr(self) -> float:
        return self.minmax_lr if self.minmax_lr is not None else self.resolved_lr()


def _search_init_max_scale(w: torch.Tensor, scheme: QuantizationScheme
                           ) -> torch.Tensor:
    """alg_ext's searched init: the per-group ``max_scale`` with the least
    qdq error, (O, groups).  Int sym uses ``search_init_scale_ratio``;
    every other type sweeps ``1 - 0.05 k`` (k = 0..9; MX also ``1 + 0.25 k``,
    k = 1..4) through its own qdq with the clamp at (0, 2), as the JAX
    package's jitted sweep (the float types divide as ``recip``), and takes
    the first candidate of least error per group."""
    g = scheme.group_size
    if (scheme.data_type == "int" and scheme.sym and isinstance(g, int)
            and scheme.super_bits is None):
        return search_init_scale_ratio(w, scheme.bits, g)
    fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
    O, I = w.shape
    dev = w.device
    cands = 1.0 - 0.05 * torch.arange(10, dtype=torch.float32, device=dev)
    if scheme.data_type.startswith("mx"):
        cands = torch.cat([cands, 1.0 + 0.25 * torch.arange(
            1, 5, dtype=torch.float32, device=dev)])
    gg = I if (not isinstance(g, int) or g in (-1, 0)) else min(g, I)
    pad = (-I) % gg
    wf = w.float()
    kw = ({} if scheme.super_bits is None else dict(
        super_bits=scheme.super_bits,
        super_group_size=scheme.super_group_size))
    errs = []
    for c in cands:                    # one candidate at a time
        ms = torch.full((O, -(-I // gg)), float(c), dtype=torch.float32,
                        device=dev)
        qdq = fn(w, bits=scheme.bits, group_size=g, max_scale=ms,
                 clip_lo=0.0, clip_hi=2.0, recip=True, **kw).qdq
        d = (qdq.float() - wf) ** 2
        if pad:
            d = torch.nn.functional.pad(d, (0, pad))
        errs.append(d.reshape(O, -1, gg).sum(-1))
    return cands[torch.argmin(torch.stack(errs), dim=0)]


def init_tune_params(
    weights: Dict[str, Any],
    schemes: Dict[str, QuantizationScheme],
    cfg: TuneConfig,
    init_scales: Optional[Dict[str, torch.Tensor]] = None,
    norm_bias_leaves: Optional[Tuple[str, ...]] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """V = 0 (shape of W), min/max_scale = 1.0 per group, (O, groups) in the
    weight's row layout (under ``enable_alg_ext`` both start at the
    searched scale, but for the double-quant schemes; ``init_scales``
    names a layer's start).  fp32 tensors on the weight's device."""
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
            if (cfg.enable_alg_ext and not isinstance(g, tuple)
                    and not (scheme.super_bits is not None
                             and scheme.data_type == "int_dq")):
                init = _search_init_max_scale(w, scheme).reshape(
                    groups_shape).float()
            else:
                init = torch.ones(groups_shape, dtype=torch.float32,
                                  device=w.device)
            if init_scales and name in init_scales:
                init = init_scales[name].to(
                    device=w.device, dtype=torch.float32).reshape(
                        groups_shape)
            layer["min_scale"] = init
            layer["max_scale"] = init.clone()   # tuned in place apart
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
    if cfg.enable_norm_bias_tuning and norm_bias_leaves:
        # the leaf key "v" puts these into the main learning-rate group
        params["_nb"] = {
            n: {"v": torch.zeros(get_by_path(weights, n).shape,
                                 dtype=torch.float32,
                                 device=get_by_path(weights, n).device)}
            for n in norm_bias_leaves}
    return params


def make_qdq_weights(
    weights: Dict[str, Any],
    tune_params: Dict[str, Dict[str, torch.Tensor]],
    schemes: Dict[str, QuantizationScheme],
    cfg: TuneConfig,
    extras: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Substitute qdq'd weights for every tuned layer; pass the rest
    through.  Layer names may be dotted paths into nested structures;
    ``extras[name]`` are keywords for that layer's qdq.  This is the
    tuning loss's qdq, which the JAX package runs under ``jit``: the types
    divide by their constants as XLA compiles it (``recip``)."""
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
    for name, p in tune_params.get("_nb", {}).items():
        out = set_by_path(out, name, qdq_asym_wo_round(
            get_by_path(weights, name), p["v"], recip=True))
    for name, scheme in schemes.items():
        fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
        p = tune_params.get(name, {})
        kw = dict(extras.get(name, {})) if extras else {}
        if scheme.super_bits is not None:
            kw.setdefault("super_bits", scheme.super_bits)
            kw.setdefault("super_group_size", scheme.super_group_size)
        r = fn(get_by_path(weights, name), bits=scheme.bits,
               group_size=scheme.group_size, v=p.get("v"),
               min_scale=p.get("min_scale"), max_scale=p.get("max_scale"),
               clip_lo=cfg.clip_lo, clip_hi=cfg.clip_hi, recip=True, **kw)
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


def outlier_threshold(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x.ravel(), q)`` (linear interpolation) of an fp32
    tensor of any size (``torch.quantile`` refuses more than 2^24
    elements).  The positions are the JAX package's float32 arithmetic on
    the host (``q * (n - 1)`` with ``n`` as float32, floor / ceil, the
    weights ``1 - h`` and ``h``); the two order statistics come from one
    ``topk`` of the largest ``n - low`` values."""
    f32 = np.float32
    x = x.reshape(-1)
    n = x.numel()
    last = f32(n) - f32(1)
    pos = f32(q) * last
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = f32(1) - w_hi
    lo = int(np.clip(lo, f32(0), last))
    hi = int(np.clip(hi, f32(0), last))
    top = torch.topk(x, n - lo, largest=True, sorted=True).values
    lo_v, hi_v = top[n - 1 - lo], top[n - 1 - hi]
    return lo_v * float(w_lo) + hi_v * float(w_hi)


def _outlier_masked_loss(out, ref, mask, cfg: TuneConfig) -> torch.Tensor:
    """MSE over the squared errors at or below their ``1 -
    outlier_mask_frac`` quantile (the threshold and the kept set carry no
    gradient), x ``loss_scale``."""
    diff2 = (out.float() - ref.float()) ** 2
    with torch.no_grad():
        keep = (diff2 <= outlier_threshold(
            diff2, 1.0 - cfg.outlier_mask_frac)).float()
    d = diff2 * keep
    if mask is not None:
        m = mask.float()
        while m.ndim < d.ndim:
            m = m[..., None]
        d = d * m
        denom = torch.clamp((keep * m).sum(), min=1.0)
    else:
        denom = torch.clamp(keep.sum(), min=1.0)
    return d.sum() / denom * cfg.loss_scale


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
    extras: Optional[Dict[str, Dict[str, Any]]] = None,
    lfq_fn: Optional[Callable] = None,
    init_scales: Optional[Dict[str, torch.Tensor]] = None,
    norm_bias_leaves: Optional[Tuple[str, ...]] = None,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
    """Tune one block's rounding params.  Returns (best_params, info).

    inputs: tensor (or tree of tensors) batched along axis 0 with nsamples
    (cached block inputs); ref_outputs: (nsamples, ...) FP block outputs.
    mask: optional (nsamples, seqlen) validity mask.  lfq_fn: optional
    ``(block_output, idx) -> scalar`` that replaces the MSE loss (the last
    block's LM loss).  norm_bias_leaves: block paths of the norm gains and
    biases ``enable_norm_bias_tuning`` tunes.  extras: per-layer keywords
    for the qdq; init_scales: per-layer clip-scale starts (O, groups).  ``info`` holds
    ``loss_trace`` (numpy, one loss per iteration), ``first_loss`` and
    ``best_loss``.  Gradients are taken here under ``torch.enable_grad()``
    whatever the caller's mode; the returned tensors carry no graph.
    """
    if cfg.enable_alg_ext and cfg.clip_hi <= 1.0:
        cfg = dataclasses.replace(cfg, clip_lo=0.0, clip_hi=2.0)
    mask_outliers = cfg.enable_alg_ext and any(
        s.bits < 4 or (s.act_bits <= 4 and s.is_act_quantized)
        for s in schemes.values())
    fwd = block_fwd
    if cfg.use_remat:
        def fwd(w, x):
            return checkpoint(block_fwd, w, x, use_reentrant=False)

    nsamples = _leaves(inputs)[0].shape[0]
    device = ref_outputs.device
    batch_idx = torch.as_tensor(batch_indices(nsamples, cfg), device=device)
    accum = cfg.gradient_accumulate_steps

    params = init_tune_params(weights, schemes, cfg,
                              init_scales=init_scales,
                              norm_bias_leaves=norm_bias_leaves)
    leaves = _leaves(params)
    if cfg.optimizer == "adam":
        # the JAX package's Adam branch: no minmax_lr, no momentum
        opt_init, opt_update = adam(cfg.resolved_lr(), cfg.iters)
    else:
        lr_scale = cfg.resolved_minmax_lr() / max(cfg.resolved_lr(), 1e-12)
        opt_init, opt_update = sign_sgd(
            cfg.resolved_lr(), cfg.iters, momentum=cfg.momentum,
            lr_scale_fn=lambda n: lr_scale if "scale" in n else 1.0)
    opt_state = opt_init(params)

    def loss_fn(idx):
        qweights = make_qdq_weights(weights, params, schemes, cfg, extras)
        batch_in = tree_map(lambda a: a.index_select(0, idx), inputs)
        out = fwd(qweights, batch_in)
        if lfq_fn is not None:
            return lfq_fn(out, idx)
        batch_ref = ref_outputs.index_select(0, idx)
        batch_mask = None if mask is None else mask.index_select(0, idx)
        if mask_outliers:
            return _outlier_masked_loss(out, batch_ref, batch_mask, cfg)
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
