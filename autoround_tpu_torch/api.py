"""Public API: the ``AutoRound`` entry point (counterpart of
``autoround_tpu/api.py``): normalize the scheme, resolve the per-layer
plan, run block-chain SignRound tuning (or RTN when ``iters=0``) and hand
the result to the export writers."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union

import os
import re

import torch

from ._device import resolve_device
from .models.registry import ALL_PRESETS, get_model_fns
from .quantize.layer_config import (apply_gguf_cascade,
                                    handle_special_scheme,
                                    prune_missing_layers,
                                    resolve_layer_schemes)
from .quantize.auto_scheme import AutoScheme, gen_auto_scheme
from .quantize.orchestrator import QuantizeConfig, QuantizeResult, quantize_model
from .schemes import QuantizationScheme, parse_scheme
from .utils.logger import logger
from .utils.offload import tree_to_host

__all__ = ["AutoRound", "AutoRoundLLM", "AutoRoundMLLM",
           "AutoRoundDiffusion", "AutoRoundAdam"]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _rotate(params, cfg, enable_rotation, scheme, seed):
    """``enable_rotation`` as the JAX package parses and applies it:
    SpinQuant's trained R1 (``spin``) and R2 (``r2``) first, then the
    Hadamard R1 (refused beside ``spin``: both rotate the residual
    stream) and the online R4; unknown modes raise after that."""
    from .transforms.hadamard import apply_r1_rotation, apply_r4_rotation
    modes = (("r1",) if enable_rotation is True
             else tuple(m.strip() for m in
                        str(enable_rotation).lower().split(",")))
    if "spin" in modes or "r2" in modes:
        from .transforms.spinquant import (apply_trained_r2,
                                           apply_trained_rotation,
                                           train_r1_rotation,
                                           train_r2_rotations)
        sq_scheme = parse_scheme(
            scheme if isinstance(scheme, (str, QuantizationScheme))
            else "W4A16")
        if "spin" in modes:
            R = train_r1_rotation(params, cfg, sq_scheme, seed=seed)
            params = apply_trained_rotation(params, cfg, R)
        if "r2" in modes:
            R2s = train_r2_rotations(params, cfg, sq_scheme, seed=seed)
            params = apply_trained_r2(params, cfg, R2s)
    if "r1" in modes:
        if "spin" in modes:
            raise ValueError("rotation modes r1 and spin both rotate the "
                             "residual stream; pick one")
        params = apply_r1_rotation(params, cfg, seed=seed)
    if "r4" in modes:
        params, cfg = apply_r4_rotation(params, cfg)
    unknown = set(modes) - {"r1", "r2", "r4", "spin"}
    if unknown:
        raise ValueError(f"unknown rotation modes {sorted(unknown)}; "
                         f"supported: r1, r2, r4, spin")
    return params, cfg


class AutoRound:
    """AutoRound quantizer for the families of ``models.registry``.

    Example::

        ar = AutoRound((params, cfg), scheme="W4A16", iters=200)
        result = ar.quantize(input_ids)        # (nsamples, seqlen) tokens
        ar.save_quantized("out/", format="fake")

    ``model`` is ``(params, cfg)`` or a preset name of
    ``models.registry.ALL_PRESETS`` (random weights from ``seed``); an HF
    checkpoint is ``utils.hf_loader.load_hf_checkpoint(path)``'s pair.
    ``device=None`` means the CUDA card and raises without one; params
    not already there are moved.  ``iters=0`` is zero-shot RTN.
    ``dataset`` (with ``tokenizer``, ``nsamples``, ``seqlen``,
    ``apply_chat_template`` and ``system_prompt``) is what ``quantize()``
    calibrates on when it is given no ids (``quantize.calib_data.
    get_calib_batch``).  Extra keyword arguments naming ``QuantizeConfig``
    fields pass through (e.g. ``cache_batch``, ``use_remat``,
    ``enable_act_minmax_tuning``, ``nblocks``, ``enable_lfq``,
    ``optimizer``, ``enable_alg_ext``, ``use_imatrix``, ``enable_awq``); an
    option the port leaves out raises ``NotImplementedError`` when
    ``quantize`` runs.  ``enable_rotation`` rotates the model first, as
    the JAX package parses it: ``True`` is ``"r1"``, or a comma-separated
    list of ``r1`` (Hadamard R1), ``r4`` (online block Hadamard before
    down_proj), ``spin`` (a trained R1) and ``r2`` (trained value / output
    head rotations).  ``offload_params=True`` keeps the blocks in host memory
    (pinned where the host allows it): a preset is then made block by
    block, each block parked on the host as it is made, and the blocks of
    a given model move there; the other params go to the device.
    ``scheme="W4A16_MIXED"`` quantizes the routed experts W4A16 and the
    rest W8A16, ``"GGUF:Q2_K_MIXED"`` the routed experts Q2_K, the rest
    Q4_K_S and the lm_head and embedding Q8_0
    (``quantize.layer_config.handle_special_scheme``; an explicit
    ``layer_config`` entry wins over the recipe).  A ``GGUF:`` scheme goes
    through the export's per-layer type cascade and quantizes the token
    embedding (``quantize.layer_config.apply_gguf_cascade``).
    ``scheme=AutoScheme(avg_bits, options)`` picks one option per block
    linear within the budget when ``quantize()`` runs
    (``quantize.auto_scheme``: its gradient pass needs the calibration
    tokens); as in the JAX package ``ignore_layers`` then drops names from
    its plan, and ``layer_config`` and ``quant_lm_head`` are kept but not
    applied.
    """

    def __init__(
        self,
        model,
        scheme: Union[str, dict, QuantizationScheme] = "W4A16",
        tokenizer=None,
        dataset=None,
        nsamples: int = 128,
        seqlen: int = 2048,
        apply_chat_template: bool = False,
        system_prompt: Optional[str] = None,
        iters: int = 200,
        lr: Optional[float] = None,
        minmax_lr: Optional[float] = None,
        batch_size: int = 8,
        seed: int = 42,
        layer_config: Optional[Dict[str, Any]] = None,
        ignore_layers: Optional[Iterable[str]] = None,
        quant_lm_head: bool = False,
        enable_quanted_input: bool = True,
        enable_minmax_tuning: bool = True,
        donate_params: bool = False,
        dynamic_max_gap: int = -1,
        gradient_accumulate_steps: int = 1,
        enable_rotation=False,
        device=None,
        **kw,
    ):
        self.device = resolve_device(device)
        offload = bool(kw.get("offload_params", False))
        if isinstance(model, str):
            cfg = ALL_PRESETS[model]
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = get_model_fns(cfg).init_params(
                cfg, gen, self.device, park=tree_to_host if offload else None)
        else:
            params, cfg = model
            blocks = params["blocks"]
            params = _to_device({k: v for k, v in params.items()
                                 if k != "blocks"}, self.device)
            params["blocks"] = ([tree_to_host(b) for b in blocks] if offload
                                else _to_device(blocks, self.device))
        if enable_rotation:
            params, cfg = _rotate(params, cfg, enable_rotation, scheme, seed)
        self.params = params
        self.model_cfg = cfg
        if isinstance(scheme, AutoScheme):
            # the search runs in quantize(), on the calibration tokens
            self.scheme = scheme
            self.layer_schemes = None
            self._auto_layer_kwargs = dict(
                layer_config=layer_config, ignore_layers=ignore_layers,
                quant_lm_head=quant_lm_head)
        else:
            self._resolve_plan(scheme, layer_config, ignore_layers,
                               quant_lm_head)
        cfg_fields = QuantizeConfig.__dataclass_fields__
        for k in kw:
            if k not in cfg_fields:
                logger.warning("AutoRound: ignoring unknown kwarg %r", k)
        self.cfg = QuantizeConfig(
            iters=iters, lr=lr, minmax_lr=minmax_lr, batch_size=batch_size,
            seed=seed, enable_quanted_input=enable_quanted_input,
            enable_minmax_tuning=enable_minmax_tuning,
            donate_params=donate_params, dynamic_max_gap=dynamic_max_gap,
            gradient_accumulate_steps=gradient_accumulate_steps,
            **{k: v for k, v in kw.items() if k in cfg_fields})
        self.tokenizer = tokenizer
        self._dataset_spec = dict(
            dataset=dataset, nsamples=nsamples, seqlen=seqlen,
            apply_chat_template=apply_chat_template,
            system_prompt=system_prompt)
        self.result: Optional[QuantizeResult] = None

    def _resolve_plan(self, scheme, layer_config, ignore_layers,
                      quant_lm_head) -> None:
        """The per-layer plan of a scheme (a recipe expanded first; a GGUF
        scheme through the export's type cascade)."""
        params, cfg = self.params, self.model_cfg
        lnames = get_model_fns(cfg).block_linear_names(cfg)
        special = handle_special_scheme(scheme, lnames, quant_lm_head)
        pinned = ()
        if special is not None:
            # the recipe's overrides lose to an explicit layer_config
            scheme, overrides, quant_lm_head, _ = special
            pinned = tuple(overrides)
            layer_config = {**overrides, **(layer_config or {})}
        self.scheme = parse_scheme(scheme)
        self.layer_schemes = resolve_layer_schemes(
            cfg.num_layers, lnames, self.scheme,
            layer_config=layer_config, ignore_layers=ignore_layers,
            quant_lm_head=quant_lm_head)
        # heterogeneous blocks (DeepSeek's dense first-k): drop the names a
        # block lacks
        self.layer_schemes = prune_missing_layers(self.layer_schemes, params)
        if isinstance(scheme, str) and scheme.upper().startswith("GGUF:"):
            # each layer tunes on the grid the GGUF writer will store
            self.layer_schemes = apply_gguf_cascade(
                self.layer_schemes, params, cfg.num_layers, scheme,
                quant_lm_head=quant_lm_head, pinned=pinned, model_cfg=cfg)
            if special is not None and "embed_tokens" in self.layer_schemes:
                # Q2_K_MIXED pins the embedding at Q8_0
                self.layer_schemes["embed_tokens"] = parse_scheme(
                    "GGUF:Q8_0")

    def quantize(self, input_ids=None, mask=None) -> QuantizeResult:
        """input_ids: (nsamples, seqlen) token ids (tensor or array), or
        None to build them from the constructor's ``dataset``; mask:
        optional (nsamples, seqlen) valid-token mask."""
        if input_ids is None:
            spec = self._dataset_spec
            if spec["dataset"] is None:
                raise ValueError("quantize() needs input_ids, or construct "
                                 "AutoRound with dataset=...")
            from .quantize.calib_data import get_calib_batch
            input_ids, mask = get_calib_batch(
                spec["dataset"], nsamples=spec["nsamples"],
                seqlen=spec["seqlen"], tokenizer=self.tokenizer,
                vocab_size=self.model_cfg.vocab_size, seed=self.cfg.seed,
                apply_chat_template=spec["apply_chat_template"],
                system_prompt=spec["system_prompt"])
        if isinstance(input_ids, dict) and self.layer_schemes is None:
            raise NotImplementedError(
                "AutoScheme search over multimodal batches is not "
                "supported yet; pass text-only calibration tokens")
        ids = torch.as_tensor(input_ids, device=self.device).long()
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        if self.layer_schemes is None:
            plan = gen_auto_scheme(self.params, self.model_cfg, self.scheme,
                                   ids)
            for pattern in self._auto_layer_kwargs["ignore_layers"] or ():
                plan = {n: s for n, s in plan.items()
                        if not (n == pattern or n.split(".")[-1] == pattern
                                or re.fullmatch(pattern, n))}
            self.layer_schemes = plan
        logger.info("quantizing %d layers, scheme=%s, iters=%d, nsamples=%d "
                    "seqlen=%d", len(self.layer_schemes),
                    self.scheme.key() if hasattr(self.scheme, "key")
                    else "auto", self.cfg.iters, ids.shape[0], ids.shape[1])
        self.result = quantize_model(self.params, self.model_cfg,
                                     self.layer_schemes, ids, self.cfg,
                                     mask=mask)
        return self.result

    def save_quantized(self, output_dir: str, format: str = "fake") -> str:
        """Write the quantized checkpoint.  ``format`` may be a
        comma-separated list: each then lands in its own subdirectory."""
        if self.result is None:
            raise RuntimeError("call quantize() first")
        from .export import save_quantized
        fmts = [f.strip() for f in format.split(",") if f.strip()]

        def with_tokenizer(path):
            # the tokenizer goes into every output directory, so the
            # checkpoint loads on its own
            if self.tokenizer is not None and hasattr(self.tokenizer,
                                                      "save_pretrained"):
                try:
                    self.tokenizer.save_pretrained(path)
                except Exception as e:
                    logger.warning("tokenizer save failed: %s", e)
            return path

        if len(fmts) == 1:
            return with_tokenizer(save_quantized(
                self.result, self.model_cfg, output_dir, fmts[0]))
        for f in fmts:
            with_tokenizer(save_quantized(
                self.result, self.model_cfg,
                os.path.join(output_dir, f.replace(":", "_")), f))
        return output_dir

    def quantize_and_save(self, input_ids, output_dir: str,
                          format: str = "fake", mask=None) -> str:
        self.quantize(input_ids, mask=mask)
        return self.save_quantized(output_dir, format=format)


# The JAX package's legacy entry names: the one front door routes every
# model, and these keep call sites written against the old names working.
class AutoRoundLLM(AutoRound):
    pass


class AutoRoundMLLM(AutoRound):
    pass


class AutoRoundDiffusion(AutoRound):
    pass


class AutoRoundAdam(AutoRound):
    """``AutoRound`` with ``optimizer="adam"`` unless given."""

    def __init__(self, *args, **kw):
        kw.setdefault("optimizer", "adam")
        super().__init__(*args, **kw)
