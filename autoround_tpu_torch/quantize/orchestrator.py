"""Block-chain quantization loop (counterpart of
``autoround_tpu/quantize/orchestrator.py``) for every family of
``models.registry``.

Cache the block-0 inputs, then walk the blocks.  Per block: run the FP
reference forward on the FP input cache; tune the block's linears with
SignRound (``iters > 0``) on the quantized-input cache against that
reference, or RTN them (``iters == 0``); write the qdq weights back into
the block (layer names may be dotted paths into nested leaves, e.g.
``experts.3.w1`` of a MoE block); and advance both caches, the FP one
through the original block and the quantized one through the qdq block
(the dual chains).  The lm_head, when the plan holds it, is tuned against
the final hidden states or RTN'd (its activations are never quantized).

A scheme that quantizes activations adds, per block: the input amax of
every such layer on the FP pass, static (and global) activation scales from
it, and a ``linear_fn`` that qdq's those layers' inputs in the tuning loss
and on the quantized chain.  ``enable_act_minmax_tuning`` also tunes a
shrink factor on each static scale.

A GGUF plan (``quantize.layer_config.apply_gguf_cascade``) may hold
``embed_tokens``: the embedding is RTN-quantized up front and the quantized
chain restarts from the qdq embedding, while the FP chain keeps the FP
one.  A double-quant layer's payload carries its supers and sub-scales in
``QuantizedLayer.extras``.

The driver options: ``enable_awq`` smooths each block's activation
outliers into its weights and seeds the clip scales from a clip search
(``transforms/awq.py``) before the block tunes; ``enable_alg_ext`` runs
the double-quant grid search before a block with GGUF layers tunes
(imatrix-weighted under ``use_imatrix``);
``enable_norm_bias_tuning`` tunes and bakes each block's norm gains and
biases; ``enable_lfq`` tunes the last block against
the LM loss of the next token; ``nblocks > 1`` tunes groups of blocks
jointly (:func:`_quantize_grouped`); ``immediate_save_dir`` streams each
block's packed layers to sharded safetensors as it finishes;
``offload_params`` keeps the FP blocks in host memory, brings one block
(and, on a side stream, the next) to the card for its window and parks its
qdq replacement back on the host (``utils/offload.py``); under RTN each
qdq layer goes to the host as it is made, so a block as large as half the
card (LongCat-Flash's 40 GB) still quantizes; ``resume_dir`` (or
``AR_RESUME_DIR``) persists each finished block's payloads and both chains
(``utils/resume.py``) and a later run with the same signature restarts at
the first unfinished block (at a group boundary under ``nblocks > 1``),
the chains restored verbatim.

Observability, read from the environment as the JAX package reads it:
``AR_TRACE_DIR`` traces the block loop with ``torch.profiler``
(``utils/profiling.py``, a ``block <i>`` range a block), ``AR_LOG_MEMORY``
logs the peak host and device memory and the live device tensors after
each block (``utils/memory.py``), and ``AR_PROFILE_PHASES`` adds up the
seconds of each phase of the per-block loop in ``QuantizeResult.profile``
under the JAX package's names (``upload``, ``fp_ref``, ``tune``,
``finalize``, ``qchain``, ``pull``, ``pull_wait``, ``gc``), each ended by a
device sync where the JAX package blocks on its result, so a bucket is
device time and host time together; without it nothing syncs.

Everything but the tuning step runs without autograd; ``tune_block``
switches gradients on for its own loss.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import envs
from ..algorithms.actquant import (build_static_act_scales,
                                   collect_act_stats, collect_imatrix,
                                   collect_output_stats,
                                   make_act_quant_linear_fn)
from ..algorithms.rtn import rtn_quantize_layer
from ..algorithms.signround import TuneConfig, tune_block
from ..dtypes.gguf import search_dq_grid
from ..dtypes.intq import qdq_asym_wo_round
from ..dtypes.registry import get_quant_func
from ..models.llama import (LlamaConfig, dual_rope_tables, layer_is_sliding,
                            rms_norm, rope_tables, sliding_mask)
from ..models.registry import get_model_fns
from ..schemes import QuantizationScheme
from ..transforms.awq import awq_clip_search, awq_smooth_block
from ..utils.logger import logger
from ..utils.memory import MemoryMonitor, log_live_arrays
from ..utils.offload import BlockPrefetcher, tree_to_host
from ..utils.profiling import block_step, maybe_trace
from ..utils.pytree import get_by_path, set_by_path
from ..utils.resume import ResumeState, run_signature

__all__ = ["QuantizeConfig", "QuantizedLayer", "QuantizeResult",
           "quantize_model"]


@dataclass(frozen=True)
class QuantizeConfig:
    """Run-level knobs (the JAX config's fields)."""

    iters: int = 200
    lr: Optional[float] = None
    minmax_lr: Optional[float] = None
    batch_size: int = 8
    seed: int = 42
    enable_quanted_input: bool = True
    enable_minmax_tuning: bool = True
    enable_round_tuning: bool = True
    use_best_params: bool = True
    dynamic_max_gap: int = -1
    gradient_accumulate_steps: int = 1
    cache_batch: int = 8  # batch size for cache-advance forwards
    enable_alg_ext: bool = False
    use_imatrix: bool = False
    enable_awq: bool = False
    optimizer: str = "signsgd"
    quant_attention: bool = False
    enable_norm_bias_tuning: bool = False
    nblocks: int = 1
    enable_lfq: bool = False
    resume_dir: Optional[str] = None
    immediate_save_dir: Optional[str] = None
    shard_size_bytes: int = 4 << 30
    # free each original block as soon as its qdq replacement exists.
    # MUTATES the caller's params["blocks"] entries to None — opt in only
    # when the FP params are not needed afterwards.
    donate_params: bool = False
    offload_params: bool = False
    # recompute the tuning forward in the backward pass instead of holding
    # its activations
    use_remat: bool = False
    # tune a shrink factor on the static activation scales (the JAX
    # package reads this switch from the environment)
    enable_act_minmax_tuning: bool = False

    def tune_config(self) -> TuneConfig:
        return TuneConfig(
            iters=self.iters, lr=self.lr, minmax_lr=self.minmax_lr,
            batch_size=self.batch_size, seed=self.seed,
            enable_minmax_tuning=self.enable_minmax_tuning,
            enable_round_tuning=self.enable_round_tuning,
            use_best_params=self.use_best_params,
            dynamic_max_gap=self.dynamic_max_gap,
            gradient_accumulate_steps=self.gradient_accumulate_steps,
            enable_alg_ext=self.enable_alg_ext,
            optimizer=self.optimizer,
            enable_norm_bias_tuning=self.enable_norm_bias_tuning,
            use_remat=self.use_remat,
            tune_act_scales=self.enable_act_minmax_tuning,
        )


@dataclass
class QuantizedLayer:
    """Export payload for one layer: qdq weight + scale/zp + scheme, plus
    the static activation scales when the scheme quantizes activations and
    a double-quant scheme's supers and sub-scales (``extras``)."""

    name: str
    scheme: QuantizationScheme
    qdq: torch.Tensor
    scale: torch.Tensor
    zp: Optional[torch.Tensor]
    act_scale: Optional[torch.Tensor] = None         # static act scale
    act_global_scale: Optional[torch.Tensor] = None  # NVFP4 global scale
    extras: Optional[Dict[str, Any]] = None          # GGUF dq payload


@dataclass
class QuantizeResult:
    params: Dict[str, Any]               # model params with qdq weights baked
    layers: Dict[str, QuantizedLayer]    # per-layer export payloads
    # per-block loss trace of the tuning run (numpy, one loss per iteration)
    loss_traces: Dict[int, np.ndarray] = field(default_factory=dict)
    # per-block attention scales {block: {"q_proj" / "k_proj" / "v_proj": s}}
    # (``quant_attention``: output amax / 448)
    attention_scales: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    # per-layer input second moments collected under ``use_imatrix``
    imatrices: Dict[str, np.ndarray] = field(default_factory=dict)
    # seconds by phase of the per-block loop under AR_PROFILE_PHASES=1
    profile: Dict[str, float] = field(default_factory=dict)


def _batched_block_apply(block_fn, block_weights, x, batch: int,
                         linear_fn=None):
    """Advance a cache through one block, ``batch`` samples at a time."""
    outs = [block_fn(block_weights, x[s:s + batch], linear_fn)
            for s in range(0, x.shape[0], batch)]
    return torch.cat(outs, dim=0)


def _finalize_layer(name: str, w: torch.Tensor, scheme: QuantizationScheme,
                    tune_params, tcfg: TuneConfig,
                    inner_name: Optional[str] = None,
                    extra_kw=None) -> QuantizedLayer:
    """Re-run the qdq once with the best params to harvest scale/zp;
    ``extra_kw`` are the per-layer statics the tuning loss's qdq saw."""
    fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
    key = inner_name if inner_name is not None else name.split(".")[-1]
    p = tune_params.get(key, {}) if tune_params else {}
    kw = dict(extra_kw or {})
    if scheme.super_bits is not None:
        kw.update(super_bits=scheme.super_bits,
                  super_group_size=scheme.super_group_size)
    r = fn(w, bits=scheme.bits, group_size=scheme.group_size,
           v=p.get("v"), min_scale=p.get("min_scale"),
           max_scale=p.get("max_scale"),
           clip_lo=tcfg.clip_lo, clip_hi=tcfg.clip_hi, **kw)
    return _layer(name, scheme, r)


def _layer(name: str, scheme: QuantizationScheme, r, qdq=None
           ) -> QuantizedLayer:
    """A QdqResult's payload (``qdq`` replaces its weight when given)."""
    return QuantizedLayer(name=name, scheme=scheme,
                          qdq=r.qdq if qdq is None else qdq, scale=r.scale,
                          zp=r.zp, extras=r.extras)


def _head_fwd(ws, xb):
    return torch.einsum("bsi,oi->bso", xb, ws["head"])


def _norm_bias_leaves_for(block: Dict[str, Any]) -> Tuple[str, ...]:
    """Block paths of the tunable norm gains (1-D leaves whose key holds
    ``norm``) and biases (keys ending in ``_bias``), sorted."""
    out = []
    for k, v in block.items():
        if not isinstance(v, torch.Tensor):
            continue
        if ("norm" in k and v.ndim == 1) or k.endswith("_bias"):
            out.append(k)
    return tuple(sorted(out))


def _make_lfq_fn(params, model_cfg, ids, mask):
    """The last block's LM loss: the next token's log-softmax NLL of the
    fp32 logits of the normed block output against the fp32 head, masked by
    ``mask[:, 1:]``.  The norm takes no Gemma offset and the logits no
    softcap, as in the JAX package."""
    head = params["lm_head"] if params.get("lm_head") is not None \
        else params["embed_tokens"]
    norm_g = params["norm"]

    def lfq_fn(pred, idx):
        h = rms_norm(pred, norm_g, model_cfg.rms_eps)
        logits = torch.matmul(h.float(), head.float().t())
        labels = ids.index_select(0, idx)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, labels[:, 1:, None].long())[..., 0]
        m = (mask.index_select(0, idx)[:, 1:].float() if mask is not None
             else torch.ones_like(nll))
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return lfq_fn


class _ShardStream:
    """``immediate_save_dir``: each finished layer packed (int layers that
    are not 2-D-block: ``autoround`` words, zeros and fp16 scales; every
    other layer its fp32 qdq) and added to a :class:`ShardWriter` in the
    JAX package's order; :meth:`finish` adds the non-quantized params and
    the packed lm_head and writes the index."""

    def __init__(self, out_dir: str, shard_size_bytes: int):
        from ..export.shard_writer import ShardWriter
        self.writer = ShardWriter(out_dir, shard_size_bytes=shard_size_bytes)

    def add_layer(self, ql: QuantizedLayer) -> None:
        from ..export.packing import (codes_from_qdq_torch,
                                      pack_quantized_torch)
        s = ql.scheme
        if s.data_type != "int" or isinstance(s.group_size, tuple):
            self.writer.add(ql.name, ql.qdq.float())
            return
        g = s.group_size if s.group_size > 0 else ql.qdq.shape[1]
        scale = ql.scale.float()
        codes = codes_from_qdq_torch(ql.qdq.float(), scale, ql.zp, s.bits, g)
        payload = pack_quantized_torch(codes, scale, ql.zp, s.bits)
        del codes
        self.writer.add_many({f"{ql.name}.{k}": v
                              for k, v in payload.items()})

    def finish(self, new_params, layers) -> None:
        from ..export import _flatten_params
        for k, v in _flatten_params(new_params).items():
            if k not in layers:
                self.writer.add(k, v)
        if "lm_head" in layers:
            self.add_layer(layers["lm_head"])
        self.writer.finalize()


def quantize_model(
    params: Dict[str, Any],
    model_cfg: LlamaConfig,
    layer_schemes: Dict[str, QuantizationScheme],
    input_ids: torch.Tensor,
    cfg: QuantizeConfig = QuantizeConfig(),
    mask: Optional[torch.Tensor] = None,
) -> QuantizeResult:
    """Quantize a model of a registered family block by block.

    input_ids: (nsamples, seqlen) calibration tokens on the compute device
    (the card, or the CPU in tests), where the non-block params live too.
    mask: optional (nsamples, seqlen) valid-token mask (pad → 0).
    ``iters == 0`` is the RTN zero-shot path; ``iters > 0`` tunes with
    SignRound.  Under ``offload_params`` the blocks may live in host memory
    and the result's blocks and layer payloads do.  Call it under
    ``torch.no_grad()`` or not, alike.
    """
    per_block: Dict[int, Dict[str, QuantizationScheme]] = {}
    for flat, scheme in layer_schemes.items():
        try:
            get_quant_func(scheme.data_type, scheme.bits, scheme.sym)
        except KeyError:
            raise NotImplementedError(
                f"{flat}: weight data type {scheme.data_type!r} is not ported "
                f"yet (ROADMAP A9); the port quantizes the int, GGUF "
                f"double-quant, MX, NVFP4, fp4_v2, FP8, W4FP8 and "
                f"float-zero-point data types") from None
        parts = flat.split(".", 2)
        if parts[0] == "blocks":
            per_block.setdefault(int(parts[1]), {})[parts[2]] = scheme
        elif flat not in ("lm_head", "embed_tokens"):
            raise NotImplementedError(
                f"quantizing {flat!r} is not ported yet (only blocks.* "
                f"linears, lm_head and embed_tokens)")
    tcfg = cfg.tune_config()
    if tcfg.enable_alg_ext and tcfg.clip_hi <= 1.0:
        # tune_block widens the clamp to (0, 2) under alg_ext; the bake in
        # _finalize_layer must use the same clamp
        tcfg = dataclasses.replace(tcfg, clip_lo=0.0, clip_hi=2.0)
    if cfg.nblocks > 1 and cfg.iters > 0:
        if cfg.enable_awq:
            # the smoothing statistics of a group's later blocks would move
            # as its earlier blocks tune
            raise ValueError("enable_awq is not supported with nblocks>1; "
                             "use nblocks=1 (reference tunes AWQ per "
                             "block too)")
        dropped = [n for n, on in (
            ("enable_lfq", cfg.enable_lfq),
            ("enable_norm_bias_tuning", cfg.enable_norm_bias_tuning),
            ("quant_attention", cfg.quant_attention),
            ("activation quantization in the loss", any(
                s.effective_act().is_act_quantized
                for s in layer_schemes.values()))) if on]
        if dropped:
            # the JAX package's grouped tuner takes none of these
            logger.warning("nblocks=%d: %s not applied (the grouped tuner "
                           "does not take them)", cfg.nblocks,
                           ", ".join(dropped))
    with torch.no_grad():
        return _quantize_blocks(params, model_cfg, layer_schemes, per_block,
                                input_ids, cfg, tcfg, mask)


def _quantize_blocks(params, model_cfg, layer_schemes, per_block, input_ids,
                     cfg, tcfg, mask) -> QuantizeResult:
    mfns = get_model_fns(model_cfg)
    seqlen = input_ids.shape[1]
    x_fp = mfns.embed_fwd(params, input_ids, model_cfg)
    x_q = x_fp if (cfg.enable_quanted_input and cfg.iters > 0) else None
    dev = x_fp.device
    if mfns.rope_tables is rope_tables:
        (cos, sin), (cosl, sinl) = dual_rope_tables(model_cfg, seqlen,
                                                    device=dev)
    else:                      # a family's own tables (DeepSeek, GPT-OSS)
        cos, sin = cosl, sinl = mfns.rope_tables(model_cfg, seqlen,
                                                 device=dev)
    # a sliding layer takes the local tables and, past the window, the
    # sliding mask (Llama 4's rope layers: the chunked mask past the
    # chunk): in the FP reference, the stats passes and the tuning loss
    # alike (the JAX orchestrator's guard against tuning a sliding layer
    # toward a full-causal reference)
    smask = (sliding_mask(model_cfg, seqlen, dev)
             if model_cfg.sliding_window is not None
             and seqlen > model_cfg.sliding_window else None)

    # a family whose layers differ in kind (Llama 4's rope and NoPE
    # layers) gives each layer its own forward
    fwd_for = getattr(mfns, "block_fwd_for", None)

    def block_fn_for(bi: int):
        c, s, m = ((cosl, sinl, smask) if layer_is_sliding(model_cfg, bi)
                   else (cos, sin, None))
        fwd = fwd_for(model_cfg, bi) if fwd_for else mfns.block_fwd

        def block_fn(w, xb, linear_fn=None):
            return fwd(w, xb, c, s, model_cfg, mask=m, linear_fn=linear_fn)
        return block_fn

    layers: Dict[str, QuantizedLayer] = {}
    if "embed_tokens" in layer_schemes:
        # GGUF: the embedding RTN'd up front; the quantized chain restarts
        # from the qdq embedding, the FP chain keeps the FP one
        w_emb = params["embed_tokens"]
        r = rtn_quantize_layer(w_emb, layer_schemes["embed_tokens"])
        layers["embed_tokens"] = _layer("embed_tokens",
                                        layer_schemes["embed_tokens"], r)
        params = dict(params)
        params["embed_tokens"] = r.qdq.to(w_emb.dtype)
        del r
        if x_q is not None:
            x_q = mfns.embed_fwd(params, input_ids, model_cfg)
        logger.info("embed_tokens quantized (%s); q-chain re-cached",
                    layer_schemes["embed_tokens"].key())

    stream = (_ShardStream(cfg.immediate_save_dir, cfg.shard_size_bytes)
              if cfg.immediate_save_dir else None)
    loader = BlockPrefetcher(dev) if cfg.offload_params else None
    traces: Dict[int, np.ndarray] = {}
    attention_scales: Dict[int, Dict[str, Any]] = {}
    imatrices: Dict[str, np.ndarray] = {}
    run = _Run(dev, cfg, model_cfg, layer_schemes, input_ids)
    grouped = cfg.nblocks > 1 and cfg.iters > 0
    loop = _quantize_grouped if grouped else _quantize_each
    with maybe_trace():
        new_blocks, x_fp, x_q = loop(
            params, model_cfg, per_block, x_fp, x_q, block_fn_for, cfg,
            tcfg, mask, input_ids, layers, traces, attention_scales,
            imatrices, stream, loader, run)

    new_params = dict(params)
    new_params["blocks"] = new_blocks
    tied = params.get("lm_head") is None
    # a tied head whose embedding is quantized already reuses it
    if "lm_head" in layer_schemes and not (tied and "embed_tokens" in layers):
        head_name = "embed_tokens" if tied else "lm_head"
        w = params[head_name]
        scheme = layer_schemes["lm_head"]
        if cfg.iters > 0 and not grouped:
            # tuned against the final hidden states; the fp32 reference
            # logits are computed cache_batch samples at a time.  The JAX
            # orchestrator norms them without the Gemma offset and tunes
            # against uncapped logits; the port does the same.  (The
            # grouped path RTNs the head, as the JAX package's does.)
            h_src = x_q if x_q is not None else x_fp
            normed = rms_norm(h_src, params["norm"], model_cfg.rms_eps)
            wf = w.float()
            ref = torch.cat([
                torch.einsum("bsi,oi->bso", normed[s:s + cfg.cache_batch]
                             .float(), wf).to(normed.dtype)
                for s in range(0, normed.shape[0], cfg.cache_batch)])
            del wf
            best, info = tune_block(_head_fwd, {"head": w}, normed, ref,
                                    {"head": scheme}, tcfg, mask=mask)
            del ref
            logger.info("lm_head: loss iter0 %.6f -> best %.6f",
                        info["first_loss"], info["best_loss"])
            ql = _finalize_layer("lm_head", w, scheme, best, tcfg,
                                 inner_name="head")
        else:
            ql = _layer("lm_head", scheme, rtn_quantize_layer(w, scheme))
        ql.qdq = ql.qdq.to(w.dtype)
        new_params[head_name] = ql.qdq
        layers["lm_head"] = ql
    if stream is not None:
        stream.finish(new_params, layers)
    if run.prof is not None:
        logger.info("phase profile (%.1fs attributed): %s",
                    sum(run.prof.values()),
                    {k: round(v, 1) for k, v in sorted(
                        run.prof.items(), key=lambda kv: -kv[1])})
    return QuantizeResult(params=new_params, layers=layers,
                          loss_traces=traces,
                          attention_scales=attention_scales,
                          imatrices=imatrices, profile=dict(run.prof or {}))


class _Run:
    """The per-run state the environment switches on: the crash-resume
    directory (``resume_dir`` or ``AR_RESUME_DIR``) and the block it starts
    at, the phase seconds (``AR_PROFILE_PHASES``), the memory monitor
    (``AR_LOG_MEMORY``) and the trace's per-block range (``AR_TRACE_DIR``)."""

    def __init__(self, dev, cfg, model_cfg, layer_schemes, input_ids):
        self.dev = dev
        self.resume = None
        self.start_block = 0
        resume_dir = cfg.resume_dir or envs.AR_RESUME_DIR
        if resume_dir:
            self.resume = ResumeState(resume_dir, run_signature(
                model_cfg, layer_schemes, input_ids, cfg))
            self.start_block = self.resume.next_block()
        self.prof: Optional[Dict[str, float]] = (
            {} if envs.AR_PROFILE_PHASES else None)
        self.monitor = MemoryMonitor(dev) if envs.AR_LOG_MEMORY else None
        self.tracing = bool(envs.AR_TRACE_DIR)
        self._step = None

    def phase(self, key: str, t0: float, sync: bool = True) -> None:
        """Add the seconds since ``t0`` to bucket ``key`` (a device sync
        first, unless ``sync`` is off)."""
        if self.prof is None:
            return
        if sync and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof[key] = self.prof.get(key, 0.0) + (time.time() - t0)

    def block_start(self, bi: int) -> None:
        """The trace's range of block ``bi`` (the previous one closed)."""
        if not self.tracing:
            return
        self.block_end()
        self._step = block_step(bi)
        self._step.__enter__()

    def block_end(self) -> None:
        if self._step is not None:
            self._step.__exit__(None, None, None)
            self._step = None

    def after_block(self, bi: int) -> None:
        if self.monitor is not None:
            self.monitor.log_summary(f"block {bi}")
            log_live_arrays(f"block {bi}")

    def restore(self, bi: int, block, schemes, layers, device):
        """Block ``bi`` as an earlier run finished it: its qdq leaves (in
        each weight's dtype) and its layers' payloads (fp32, as saved)
        from the resume directory."""
        payload = self.resume.load_block(bi, device)
        qdq_block = block
        for lname, scheme in schemes.items():
            w = get_by_path(block, lname)
            qdq = payload[f"{lname}.qdq"]
            qdq_block = set_by_path(qdq_block, lname, qdq.to(w.dtype))
            layers[f"blocks.{bi}.{lname}"] = QuantizedLayer(
                name=f"blocks.{bi}.{lname}", scheme=scheme, qdq=qdq,
                scale=payload[f"{lname}.scale"],
                zp=payload.get(f"{lname}.zp"))
        return qdq_block

    def save(self, bi: int, schemes, layers, x_fp, x_q,
             empty: bool = False, drop=None) -> None:
        """Persist block ``bi``: its layers' qdq / scale / zp in fp32 (a
        block with nothing quantized: ``_empty``) and the chains after it
        as they are (``drop``: ``ResumeState.mark_block_done``'s)."""
        payload = {}
        for lname in schemes:
            ql = layers[f"blocks.{bi}.{lname}"]
            payload[f"{lname}.qdq"] = ql.qdq.float()
            payload[f"{lname}.scale"] = ql.scale.float()
            if ql.zp is not None:
                payload[f"{lname}.zp"] = ql.zp.float()
        if empty:
            payload = {"_empty": torch.zeros(1, dtype=torch.int8)}
        self.resume.mark_block_done(bi, payload, x_fp, x_q, drop)


def _park(qdq_block, layer_names, layers):
    """Offload: the qdq block and its layers' payloads to host memory (a
    qdq leaf and its layer's ``qdq`` share one host tensor)."""
    memo: Dict[int, Any] = {}
    host_block = tree_to_host(qdq_block, memo)
    for name in layer_names:
        ql = layers[name]
        ql.qdq, ql.scale, ql.zp = tree_to_host([ql.qdq, ql.scale, ql.zp],
                                               memo)
        if ql.extras is not None:
            ql.extras = {k: tree_to_host(v, memo)
                         if isinstance(v, torch.Tensor) else v
                         for k, v in ql.extras.items()}
    return host_block


def _quantize_each(params, model_cfg, per_block, x_fp, x_q, block_fn_for,
                   cfg, tcfg, mask, input_ids, layers, traces,
                   attention_scales, imatrices, stream, loader, run):
    """``nblocks == 1``: one block at a time.  Returns (new blocks, x_fp,
    x_q) after the last block."""
    blocks = params["blocks"]
    n_blocks = len(blocks)
    new_blocks = []
    for bi in range(n_blocks):
        run.block_start(bi)
        t_block = time.time()
        schemes = per_block.get(bi, {})
        if bi < run.start_block:
            # finished by an earlier run; the chains resume after the last
            # such block, restored as they were saved
            new_blocks.append(run.restore(
                bi, blocks[bi], schemes, layers,
                "cpu" if loader is not None else x_fp.device))
            if bi == run.start_block - 1:
                x_fp, x_q = run.resume.load_chain(bi, x_fp.device)
            continue
        block_fn = block_fn_for(bi)
        block = blocks[bi]
        t0 = time.time()
        if loader is not None:
            block = loader.get(bi, block)
        run.phase("upload", t0)
        if cfg.donate_params:
            # free the FP block: under offload its host copy goes as soon
            # as the card holds the block, so the host holds one copy of a
            # block, not the block and its qdq replacement
            blocks[bi] = None
        t0 = time.time()
        ref_out = _batched_block_apply(block_fn, block, x_fp,
                                       cfg.cache_batch)
        run.phase("fp_ref", t0)
        if loader is not None and bi + 1 < n_blocks:
            # the next block's upload overlaps this block's window
            loader.prefetch(bi + 1, blocks[bi + 1])
        qdq_block = block         # set_by_path copies the branches it edits
        if schemes and cfg.quant_attention:
            qkv_amax = collect_output_stats(
                block_fn, block, x_fp[:cfg.cache_batch],
                ("q_proj", "k_proj", "v_proj"))
            attention_scales[bi] = {k: v / 448.0 for k, v in qkv_amax.items()}

        init_scales = None
        if schemes and cfg.enable_awq:
            # AWQ: smooth before tuning (an exact reparameterization of the
            # FP block); its clip search seeds the clip scales
            block, _ = awq_smooth_block(block, block_fn,
                                        x_fp[:cfg.cache_batch], schemes)
            qdq_block = block
            im_clip = collect_imatrix(block_fn, block,
                                      x_fp[:cfg.cache_batch], set(schemes))
            init_scales = awq_clip_search(block, schemes, im_clip)

        # activation quantization: per-layer amax on the FP pass, static
        # and global scales from it, and the interceptor
        act_lf = None
        static_scales: Dict[str, torch.Tensor] = {}
        global_scales: Dict[str, torch.Tensor] = {}
        if any(s.effective_act().is_act_quantized for s in schemes.values()):
            amax = collect_act_stats(block_fn, block, x_fp[:cfg.cache_batch],
                                     set(schemes))
            static_scales, global_scales = build_static_act_scales(schemes,
                                                                   amax)
            act_lf = make_act_quant_linear_fn(schemes, static_scales,
                                              global_scales)

        if schemes and cfg.iters > 0:
            tune_in = x_q if x_q is not None else x_fp
            tune_fn, tune_weights = block_fn, block
            if act_lf is not None:
                # the scales ride in the weights under a reserved key, so
                # the tuner can put its shrink factors on them
                tune_weights = dict(block)
                tune_weights["_act_scales"] = {"static": static_scales,
                                               "global": global_scales}

                def tune_fn(w, xb, _schemes=schemes):
                    scales = w["_act_scales"]
                    lf = make_act_quant_linear_fn(
                        _schemes, scales.get("static") or None,
                        scales.get("global") or None)
                    inner = {k: v for k, v in w.items()
                             if k != "_act_scales"}
                    return block_fn(inner, xb, lf)
            lfq_fn = (_make_lfq_fn(params, model_cfg, input_ids, mask)
                      if cfg.enable_lfq and bi == n_blocks - 1 else None)
            nb_leaves = (_norm_bias_leaves_for(block)
                         if tcfg.enable_norm_bias_tuning else None)
            tune_extras = (_dq_grids(block_fn, block, x_fp, schemes, cfg,
                                     bi, imatrices)
                           if tcfg.enable_alg_ext else None)
            t0 = time.time()
            best, info = tune_block(tune_fn, tune_weights, tune_in, ref_out,
                                    schemes, tcfg, mask=mask, lfq_fn=lfq_fn,
                                    init_scales=init_scales,
                                    norm_bias_leaves=nb_leaves,
                                    extras=tune_extras)
            run.phase("tune", t0)
            traces[bi] = info["loss_trace"]
            logger.info("block %d: loss iter0 %.6f -> best %.6f (%.1fs)", bi,
                        info["first_loss"], info["best_loss"],
                        time.time() - t_block)
            if "_act" in best:
                # bake the tuned shrink into the static scales
                for lname, p in best["_act"].items():
                    if lname in static_scales:
                        static_scales[lname] = static_scales[lname] \
                            * torch.clamp(p["scale"], tcfg.clip_lo,
                                          tcfg.clip_hi)
                act_lf = make_act_quant_linear_fn(schemes, static_scales,
                                                  global_scales)
            for nname, p in best.get("_nb", {}).items():
                # bake the tuned norm / bias offsets
                leaf = get_by_path(block, nname)
                qdq_block = set_by_path(qdq_block, nname, qdq_asym_wo_round(
                    leaf, p["v"]).to(leaf.dtype))
            t0 = time.time()
            for lname, scheme in schemes.items():
                w_orig = get_by_path(block, lname)
                ql = _finalize_layer(f"blocks.{bi}.{lname}", w_orig, scheme,
                                     best, tcfg, inner_name=lname,
                                     extra_kw=(tune_extras or {}).get(lname))
                qdq_block = set_by_path(qdq_block, lname,
                                        ql.qdq.to(w_orig.dtype))
                layers[ql.name] = ql
            run.phase("finalize", t0)
            del best, tune_extras
        else:
            im: Dict[str, torch.Tensor] = {}
            if schemes and cfg.use_imatrix:
                im = collect_imatrix(block_fn, block, x_fp[:cfg.cache_batch],
                                     set(schemes))
                for ln, v in im.items():
                    imatrices[f"blocks.{bi}.{ln}"] = v.cpu().numpy()
            for lname, scheme in schemes.items():
                w_orig = get_by_path(block, lname)
                r = rtn_quantize_layer(w_orig, scheme, imatrix=im.get(lname))
                ql = _layer(f"blocks.{bi}.{lname}", scheme, r,
                            qdq=r.qdq.to(w_orig.dtype))
                del r
                if loader is not None and x_q is None:
                    # offload with no quantized chain to advance: each qdq
                    # goes to the host as it is made, so the card holds one
                    # block, not the block and its replacement
                    ql.qdq, ql.scale, ql.zp = tree_to_host(
                        [ql.qdq, ql.scale, ql.zp])
                qdq_block = set_by_path(qdq_block, lname, ql.qdq)
                layers[ql.name] = ql
        names = [f"blocks.{bi}.{lname}" for lname in schemes]
        for lname in schemes:
            ql = layers[f"blocks.{bi}.{lname}"]
            ql.act_scale = static_scales.get(lname)
            ql.act_global_scale = global_scales.get(lname)
        block = None
        # advance the chains: FP through the original block (done above),
        # the quantized one through the qdq block with the activation
        # interceptor still on
        x_fp = ref_out
        if x_q is not None:
            t0 = time.time()
            x_q = _batched_block_apply(block_fn, qdq_block, x_q,
                                       cfg.cache_batch, linear_fn=act_lf)
            run.phase("qchain", t0)
        if stream is not None:
            for name in names:
                stream.add_layer(layers[name])
        if loader is not None:
            t0 = time.time()
            qdq_block = _park(qdq_block, names, layers)
            run.phase("pull", t0, sync=False)
            # the JAX package waits here for its host unpack of the block
            # before; the port's park copies synchronously, so this is the
            # wait for the card's queue to drain
            t0 = time.time()
            run.phase("pull_wait", t0)
            # drop the device copies now, not at the cyclic collector's
            # leisure (the JAX package collects once a block too)
            t0 = time.time()
            gc.collect()
            run.phase("gc", t0, sync=False)
        new_blocks.append(qdq_block)
        run.after_block(bi)
        if run.resume is not None:
            # durable before the manifest names the block
            run.save(bi, schemes, layers, x_fp, x_q, empty=not schemes)
    run.block_end()
    return new_blocks, x_fp, x_q


def _dq_grids(block_fn, block, x_fp, schemes, cfg, bi, imatrices):
    """alg_ext: each double-quant layer's searched grid (imatrix-weighted
    under ``use_imatrix``, the imatrices kept in ``imatrices``), as the
    tuning run's per-layer extras, or None without such a layer."""
    dq_names = {ln for ln, s in schemes.items()
                if s.super_bits is not None and s.data_type == "int_dq"}
    im: Dict[str, torch.Tensor] = {}
    if dq_names and cfg.use_imatrix:
        im = collect_imatrix(block_fn, block, x_fp[:cfg.cache_batch],
                             dq_names)
        for ln, v in im.items():
            imatrices[f"blocks.{bi}.{ln}"] = v.cpu().numpy()
    ex = {}
    for ln in dq_names:
        s = schemes[ln]
        ex[ln] = search_dq_grid(get_by_path(block, ln), s.bits, s.group_size,
                                s.super_bits, s.super_group_size, s.sym,
                                imatrix=im.get(ln))
    return ex or None


def _quantize_grouped(params, model_cfg, per_block, x_fp, x_q, block_fn_for,
                      cfg, tcfg, mask, input_ids, layers, traces,
                      attention_scales, imatrices, stream, loader, run):
    """``nblocks > 1``: tune each group of ``nblocks`` consecutive blocks
    jointly.  The tuning tree is ``{"blocks": [block, ...]}`` with dotted
    scheme paths ``blocks.<j>.<linear>``, and one forward chains the group,
    each member with its own rope tables and sliding mask.  As in the JAX
    package the group's tuning takes no activation quantization, lm loss or
    norm / bias tuning, and no attention scales are collected (the caller
    warns); the blocks are not donated.  A resumed run restarts at a group
    boundary: every member of a tuned group is saved with the group's
    end chain (a group with nothing to quantize is not saved, as in the
    JAX package)."""
    blocks = params["blocks"]
    n = len(blocks)
    new_blocks = []
    start = (run.start_block // cfg.nblocks) * cfg.nblocks
    for gstart in range(0, n, cfg.nblocks):
        t_group = time.time()
        group = list(blocks[gstart:gstart + cfg.nblocks])
        if gstart + len(group) <= start:
            new_blocks.extend(run.restore(
                gstart + j, b, per_block.get(gstart + j, {}), layers,
                "cpu" if loader is not None else x_fp.device)
                for j, b in enumerate(group))
            if gstart + len(group) == start:
                x_fp, x_q = run.resume.load_chain(start - 1, x_fp.device)
            continue
        if loader is not None:
            group = [loader.get(gstart + j, b) for j, b in enumerate(group)]
        fns = [block_fn_for(gstart + j) for j in range(len(group))]
        schemes = {f"blocks.{j}.{lname}": s for j in range(len(group))
                   for lname, s in per_block.get(gstart + j, {}).items()}
        ref = x_fp
        for fn, b in zip(fns, group):
            ref = _batched_block_apply(fn, b, ref, cfg.cache_batch)
        qdq_group = list(group)
        if schemes:
            def group_fwd(weights, xb, _fns=fns):
                for fn, b in zip(_fns, weights["blocks"]):
                    xb = fn(b, xb)
                return xb
            tune_in = x_q if x_q is not None else x_fp
            best, info = tune_block(group_fwd, {"blocks": group}, tune_in,
                                    ref, schemes, tcfg, mask=mask)
            traces[gstart] = info["loss_trace"]
            logger.info("blocks %d-%d: loss iter0 %.6f -> best %.6f "
                        "(%.1fs)", gstart, gstart + len(group) - 1,
                        info["first_loss"], info["best_loss"],
                        time.time() - t_group)
            for path, scheme in schemes.items():
                j, lname = int(path.split(".")[1]), path.split(".", 2)[2]
                w_orig = get_by_path(group[j], lname)
                ql = _finalize_layer(f"blocks.{gstart + j}.{lname}", w_orig,
                                     scheme, best, tcfg, inner_name=path)
                qdq_group[j] = set_by_path(qdq_group[j], lname,
                                           ql.qdq.to(w_orig.dtype))
                layers[ql.name] = ql
            del best
        x_fp = ref
        if x_q is not None:
            for fn, b in zip(fns, qdq_group):
                x_q = _batched_block_apply(fn, b, x_q, cfg.cache_batch)
        for j in range(len(group)):
            names = [f"blocks.{gstart + j}.{lname}"
                     for lname in per_block.get(gstart + j, {})]
            if stream is not None:
                for name in names:
                    stream.add_layer(layers[name])
            if loader is not None:
                qdq_group[j] = _park(qdq_group[j], names, layers)
        group = None
        if loader is not None:
            gc.collect()
        new_blocks.extend(qdq_group)
        if run.resume is not None and schemes:
            # the chain before the group stays until its last member is
            # saved, so a stop inside the group restarts at its start
            last = gstart + len(qdq_group) - 1
            for j in range(len(qdq_group)):
                run.save(gstart + j, per_block.get(gstart + j, {}), layers,
                         x_fp, x_q, drop=(range(gstart - 1, last)
                                          if gstart + j == last else ()))
    return new_blocks, x_fp, x_q
