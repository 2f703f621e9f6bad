"""AutoScheme: one scheme per layer under an average-bits budget
(counterpart of ``autoround_tpu/quantize/auto_scheme.py``).

Every quantizable layer is scored under each candidate scheme by a
first-order estimate of the damage to the LM loss,

    score(layer, scheme) = sum | dL/dW * (W - qdq_scheme(W)) |

(plus ``| dL/dx * (x - qdq_act(x)) |`` over the layer's input for a
scheme that quantizes activations), and :func:`select_plan` picks one
scheme per layer that minimizes the summed damage within the budget: a
Lagrangian bisection over the bits / loss trade-off, then a greedy
refinement, in float64 numpy as the JAX package does.

The gradient pass is ``torch.autograd`` over the cross-entropy of
``get_model_fns(cfg).model_fwd``; on the card its attention is the flash
forward and the two backward kernels.  The activation side adds zero
probes to each quantized linear's input through the model's
``linear_fn`` and reads their gradients.  The scores are computed on the
device, one (shape, option) group at a time, and cross to the host in one
transfer (:func:`_to_host`).
"""

from __future__ import annotations

import hashlib
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import envs
from ..algorithms.actquant import qdq_act
from ..dtypes.registry import get_quant_func
from ..schemes import QuantizationScheme, parse_scheme
from ..utils.logger import logger
from ..utils.pytree import get_by_path, set_by_path

__all__ = ["AutoScheme", "gen_auto_scheme", "scheme_storage_bits",
           "select_plan"]


@dataclass(frozen=True)
class AutoScheme:
    """The search: the average bits a weight may take (scales included)
    and the candidate schemes."""
    avg_bits: float
    options: Tuple[Union[str, QuantizationScheme], ...]
    nsamples: int = 8
    seed: int = 42
    # cache the score matrices under AR_WORK_SPACE, so a run with another
    # avg_bits skips the scoring passes
    enable_cache: bool = False
    # score GGUF k-quant options with the imatrix-weighted search (one
    # calibration forward collects each input channel's mean x^2)
    use_imatrix: bool = False


def scheme_storage_bits(scheme: QuantizationScheme, shape) -> float:
    """Stored bits a weight, the scales' and zero points' share
    included."""
    O, I = shape
    g = scheme.group_size
    if isinstance(g, tuple):
        n_groups = (-(-O // g[0])) * (-(-I // g[1]))
        return scheme.bits + n_groups * 16 / (O * I)
    if g in (0,):
        return float(scheme.bits)
    if g == -1:
        g = I
    n_groups = O * (-(-I // g))
    scale_bits = 16.0
    zp_bits = 0.0 if scheme.sym else scheme.bits
    if scheme.super_bits is not None:
        # k-quant: sub-scales of super_bits and an fp16 super a group
        sgs = scheme.super_group_size or 8
        scale_bits = scheme.super_bits + 16.0 / sgs
        zp_bits = 0.0 if scheme.sym else scheme.super_bits + 16.0 / sgs
    return scheme.bits + n_groups * (scale_bits + zp_bits) / (O * I)


def _lm_loss(params, cfg, ids):
    from ..models.registry import get_model_fns
    logits = get_model_fns(cfg).model_fwd(params, ids[:, :-1], cfg).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, ids[:, 1:, None].long()).mean()


# a k-quant option on a layer whose input width its 256-wide super-block
# does not divide takes the Q8_0-grid int8 scheme instead
_GGUF_FALLBACK = QuantizationScheme(bits=8, group_size=32, sym=True,
                                    data_type="int")


def _effective_option(opt: QuantizationScheme, shape) -> QuantizationScheme:
    if opt.super_bits is not None:
        block = (opt.group_size or 1) * (opt.super_group_size or 1)
        if shape[1] % block:
            return _GGUF_FALLBACK
    return opt


def _leaf(params, flat: str) -> torch.Tensor:
    """The weight of layer ``flat`` (the head: ``lm_head``, or the tied
    embedding)."""
    if flat == "lm_head":
        return params["lm_head"] if params.get("lm_head") is not None \
            else params["embed_tokens"]
    return get_by_path(params["blocks"], flat.split(".", 1)[1])


def _to_host(scores: List[torch.Tensor]) -> List[np.ndarray]:
    """Every score tensor to the host in one transfer."""
    if not scores:
        return []
    flat = torch.cat([s.reshape(-1).double() for s in scores]).cpu().numpy()
    out, i = [], 0
    for s in scores:
        out.append(flat[i:i + s.numel()])
        i += s.numel()
    return out


def _cache_path(params, model_cfg, auto_scheme, layer_names, options, ids):
    """The score cache's file: keyed on the config, the layers, the
    options, nsamples, use_imatrix, the tokens and the embedding's first
    rows (not on avg_bits, so another budget reuses it)."""
    h = hashlib.sha1()
    h.update(repr((type(model_cfg).__name__,
                   {k: str(v) for k, v in model_cfg.__dict__.items()
                    if k != "dtype"},
                   tuple(layer_names),
                   tuple(o.key() for o in options),
                   int(auto_scheme.nsamples),
                   bool(auto_scheme.use_imatrix))).encode())
    h.update(ids.detach().cpu().numpy().tobytes())
    h.update(params["embed_tokens"][:4].detach().float().cpu().numpy()
             .tobytes())
    return os.path.join(envs.AR_WORK_SPACE, "auto_scheme_cache",
                        h.hexdigest() + ".npz")


def _weight_grads(params, model_cfg, ids, layer_names):
    """dL/dW of every layer of ``layer_names`` (the head's as the loss
    sees the head leaf, through the embedding too when tied), in one
    backward pass."""
    head_name = "lm_head" if params.get("lm_head") is not None \
        else "embed_tokens"
    p = dict(params)
    p["blocks"] = list(params["blocks"])
    leaves = {}
    for flat in layer_names:
        if flat == "lm_head":
            leaf = params[head_name].detach().requires_grad_(True)
            p[head_name] = leaf
        else:
            _, bi, path = flat.split(".", 2)
            leaf = get_by_path(p["blocks"][int(bi)], path).detach() \
                .requires_grad_(True)
            p["blocks"][int(bi)] = set_by_path(p["blocks"][int(bi)], path,
                                               leaf)
        leaves[flat] = leaf
    with torch.enable_grad():
        loss = _lm_loss(p, model_cfg, ids)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))


def _act_probes(params, model_cfg, ids, layer_names, with_grad):
    """Each quantized linear's input x (a zero probe added through the
    model's ``linear_fn``) and, ``with_grad``, dL/dx."""
    from ..models.registry import get_model_fns
    mfns = get_model_fns(model_cfg)
    S = ids.shape[1] - 1
    dev = params["embed_tokens"].device
    cos, sin = mfns.rope_tables(model_cfg, S, device=dev)
    probes = {}
    for flat in layer_names:
        if flat.startswith("blocks."):
            w = get_by_path(params["blocks"], flat.split(".", 1)[1])
            probes[flat] = torch.zeros(
                (ids.shape[0], S, w.shape[1]),
                dtype=params["embed_tokens"].dtype, device=dev,
                requires_grad=with_grad)
    captured = {}
    with torch.set_grad_enabled(with_grad):
        x = mfns.embed_fwd(params, ids[:, :-1], model_cfg)
        for bi, b in enumerate(params["blocks"]):
            def lf(name, xx, ww, bias=None, bi=bi):
                key = f"blocks.{bi}.{name}"
                if key in probes:
                    xx = xx + probes[key]
                    captured[key] = xx
                y = torch.einsum("...i,oi->...o", xx, ww)
                return y if bias is None else y + bias
            x = mfns.block_fwd(b, x, cos, sin, model_cfg, linear_fn=lf)
        logits = mfns.final_fwd(params, x, model_cfg).float()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, ids[:, 1:, None].long()).mean()
        grads = {}
        if with_grad:
            keys = [k for k in probes if k in captured]
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [probes[k] for k in keys])))
    return {k: v.detach() for k, v in captured.items()}, grads


def _score_matrices(params, model_cfg, auto_scheme, ids, layer_names,
                    options):
    """(scores, bits_cost, nparams) of every (layer, option): the weight
    side by shape and option on the device, the activation side per layer,
    all fetched in one transfer."""
    act_options = [o for o in options if o.effective_act().is_act_quantized]
    grads = _weight_grads(params, model_cfg, ids, layer_names)
    act_x, act_g, imatrices = {}, {}, {}
    if act_options or auto_scheme.use_imatrix:
        act_x, act_g = _act_probes(params, model_cfg, ids, layer_names,
                                   with_grad=bool(act_options))
        if auto_scheme.use_imatrix:
            imatrices = {k: v.float().square().mean(dim=(0, 1))
                         for k, v in act_x.items()}

    n_l, n_o = len(layer_names), len(options)
    bits_cost = np.zeros((n_l, n_o))
    nparams = np.zeros(n_l)
    by_shape = defaultdict(list)
    for li, flat in enumerate(layer_names):
        w = _leaf(params, flat)
        nparams[li] = w.numel()
        by_shape[tuple(w.shape)].append(li)

    pending = []     # (layer indices, option index, (n,) device scores)
    with torch.no_grad():
        for shape, lis in by_shape.items():
            for oi, opt in enumerate(options):
                eff = _effective_option(opt, shape)
                fn = get_quant_func(eff.data_type, eff.bits, eff.sym,
                                    mode="rtn")
                kw = {}
                if eff.super_bits is not None:
                    kw = dict(super_bits=eff.super_bits,
                              super_group_size=eff.super_group_size)
                vals = []
                for li in lis:
                    w = _leaf(params, layer_names[li])
                    ikw = dict(kw)
                    if imatrices and eff.super_bits is not None:
                        ikw["imatrix"] = imatrices.get(
                            layer_names[li],
                            torch.ones(shape[1], device=w.device))
                    qdq = fn(w, bits=eff.bits, group_size=eff.group_size,
                             **ikw).qdq
                    vals.append((grads[layer_names[li]].float()
                                 * (w.float() - qdq.float())).abs().sum())
                pending.append((lis, oi, torch.stack(vals)))
                for li in lis:
                    bits_cost[li, oi] = scheme_storage_bits(eff, shape)
        act_pending = []
        for li, flat in enumerate(layer_names):
            if flat not in act_x:
                continue
            for oi, opt in enumerate(options):
                if opt.effective_act().is_act_quantized:
                    x = act_x[flat]
                    dq = qdq_act(x, opt)
                    act_pending.append((li, oi, (act_g[flat].float() * (
                        x.float() - dq.float())).abs().sum().reshape(1)))
    fetched = _to_host([p[2] for p in pending] + [p[2] for p in act_pending])
    scores = np.zeros((n_l, n_o))
    for (lis, oi, _), vals in zip(pending, fetched[:len(pending)]):
        for j, li in enumerate(lis):
            scores[li, oi] = float(vals[j])
    for (li, oi, _), v in zip(act_pending, fetched[len(pending):]):
        scores[li, oi] += float(v[0])
    return scores, bits_cost, nparams


def select_plan(scores: np.ndarray, bits_cost: np.ndarray,
                nparams: np.ndarray, options: Sequence[QuantizationScheme],
                avg_bits: float, head_index: Optional[int] = None
                ) -> Tuple[np.ndarray, float, np.ndarray]:
    """(the option index of each layer, the weighted bits used, the scores
    as the head trick left them), from the
    (layers, options) score and bits matrices (float64): the lm-head trick
    (the head, row ``head_index``, restricted to the options of 6 bits or
    more, relaxed when that makes the budget infeasible), the Lagrangian
    bisection (80 steps), then greedy upgrades by loss per bit while the
    budget lasts.  The JAX package's arithmetic step for step; raises
    ``ValueError`` when ``avg_bits`` is out of reach."""
    scores = np.array(scores, dtype=np.float64)
    n_l, n_o = scores.shape
    head_restricted = None
    if head_index is not None:
        hl = head_index
        high = [oi for oi, o in enumerate(options) if o.bits >= 6]
        if len(high) == 1:
            allowed = high
        elif len(high) > 1 and avg_bits > 6:
            allowed = [max(high, key=lambda oi: options[oi].bits)]
        elif high:
            allowed = high
        else:
            allowed = [int(np.argmin(scores[hl]))]
        head_restricted = (hl, scores[hl].copy())
        for oi in range(n_o):
            if oi not in allowed:
                scores[hl, oi] = np.inf

    budget = avg_bits * nparams.sum()
    weighted_bits = bits_cost * nparams[:, None]

    def feasible_min():
        # (a restricted entry is NaN here, and np.min propagates it: the
        # JAX package's sum is then NaN and the relax never fires)
        wb = weighted_bits.copy()
        wb[scores == np.inf] = np.inf
        return float(np.where(np.isfinite(wb), wb, np.nan).min(1).sum())

    if head_restricted is not None and feasible_min() > budget:
        hl, saved = head_restricted
        scores[hl] = saved

    lo_bits = float((weighted_bits.min(1)).sum())
    hi_bits = float((weighted_bits.max(1)).sum())
    if not (lo_bits <= budget <= hi_bits):
        raise ValueError(
            f"avg_bits={avg_bits} outside reachable range "
            f"[{lo_bits/nparams.sum():.3f}, {hi_bits/nparams.sum():.3f}]")

    rows = np.arange(n_l)

    def assign(lam):
        return np.argmin(scores + lam * weighted_bits, axis=1)

    lam_lo, lam_hi = 0.0, 1.0
    while weighted_bits[rows, assign(lam_hi)].sum() > budget \
            and lam_hi < 1e12:
        lam_hi *= 4.0
    for _ in range(80):
        lam = 0.5 * (lam_lo + lam_hi)
        if weighted_bits[rows, assign(lam)].sum() > budget:
            lam_lo = lam
        else:
            lam_hi = lam
    choice = assign(lam_hi)

    # spend what is left on the best loss-per-bit upgrades
    used = weighted_bits[rows, choice].sum()
    improved = True
    while improved:
        improved = False
        best = None
        for li in range(n_l):
            cur = choice[li]
            for oi in range(n_o):
                extra = weighted_bits[li, oi] - weighted_bits[li, cur]
                gain = scores[li, cur] - scores[li, oi]
                if gain > 0 and used + extra <= budget:
                    rate = gain / max(extra, 1e-9) if extra > 0 else np.inf
                    if best is None or rate > best[0]:
                        best = (rate, li, oi, extra)
        if best is not None:
            _, li, oi, extra = best
            choice[li] = oi
            used += extra
            improved = True
    return choice, float(used), scores


def gen_auto_scheme(
    params,
    model_cfg,
    auto_scheme: AutoScheme,
    input_ids: torch.Tensor,
    layer_names: Optional[Sequence[str]] = None,
) -> Dict[str, QuantizationScheme]:
    """{flat layer name: scheme} within the avg-bits budget, on the device
    of ``params`` (its first ``nsamples`` rows of ``input_ids`` go to
    it)."""
    from ..models.registry import get_model_fns
    from .layer_config import prune_missing_layers
    options = [parse_scheme(o) for o in auto_scheme.options]
    if layer_names is None:
        layer_names = [
            f"blocks.{i}.{ln}" for i in range(model_cfg.num_layers)
            for ln in get_model_fns(model_cfg).block_linear_names(model_cfg)]
        layer_names = list(prune_missing_layers(
            {n: None for n in layer_names}, params))
    layer_names = list(layer_names)
    dev = params["embed_tokens"].device
    ids = torch.as_tensor(input_ids)[: auto_scheme.nsamples].to(dev).long()

    cache_path = None
    cached = None
    if auto_scheme.enable_cache:
        cache_path = _cache_path(params, model_cfg, auto_scheme, layer_names,
                                 options, ids)
        if os.path.exists(cache_path):
            z = np.load(cache_path)
            cached = (z["scores"], z["bits_cost"], z["nparams"])
            logger.info("AutoScheme: score cache hit %s", cache_path)
    if cached is not None:
        scores, bits_cost, nparams = cached
    else:
        scores, bits_cost, nparams = _score_matrices(
            params, model_cfg, auto_scheme, ids, layer_names, options)
        if cache_path is not None:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.savez(cache_path, scores=scores, bits_cost=bits_cost,
                     nparams=nparams)
            logger.info("AutoScheme: scores cached -> %s", cache_path)

    head = layer_names.index("lm_head") if "lm_head" in layer_names else None
    choice, used, final = select_plan(scores, bits_cost, nparams, options,
                                      auto_scheme.avg_bits, head)
    plan = {}
    for li, flat in enumerate(layer_names):
        shape = tuple(_leaf(params, flat).shape)
        plan[flat] = _effective_option(options[choice[li]], shape)
    logger.info("AutoScheme: avg_bits target %.3f -> achieved %.3f "
                "(est. loss damage %.4g)", auto_scheme.avg_bits,
                used / nparams.sum(),
                float(final[np.arange(len(layer_names)), choice].sum()))
    return plan
