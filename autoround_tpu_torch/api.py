"""Public API: the ``AutoRound`` entry point (counterpart of
``autoround_tpu/api.py``): normalize the scheme, resolve the per-layer
plan, run block-chain SignRound tuning (or RTN when ``iters=0``) and hand
the result to the export writers."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union

import os

import torch

from ._device import resolve_device
from .models.registry import ALL_PRESETS, get_model_fns
from .quantize.layer_config import resolve_layer_schemes
from .quantize.orchestrator import QuantizeConfig, QuantizeResult, quantize_model
from .schemes import QuantizationScheme, parse_scheme
from .utils.logger import logger

__all__ = ["AutoRound"]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class AutoRound:
    """AutoRound quantizer for the families of ``models.registry``
    (Llama, Mixtral-style MoE).

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
    ``enable_act_minmax_tuning``); an option this slice leaves out raises
    ``NotImplementedError`` when ``quantize`` runs, ``enable_rotation``
    at once.
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
        if enable_rotation:
            raise NotImplementedError(
                f"enable_rotation={enable_rotation!r} (Hadamard / SpinQuant "
                f"rotations) is not ported yet (ROADMAP A12, "
                f"transforms/hadamard.py, transforms/spinquant.py)")
        self.device = resolve_device(device)
        if isinstance(model, str):
            cfg = ALL_PRESETS[model]
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = get_model_fns(cfg).init_params(cfg, gen, self.device)
        else:
            params, cfg = model
            params = _to_device(params, self.device)
        self.params = params
        self.model_cfg = cfg
        self.scheme = parse_scheme(scheme)
        self.layer_schemes = resolve_layer_schemes(
            cfg.num_layers, get_model_fns(cfg).block_linear_names(cfg),
            self.scheme,
            layer_config=layer_config, ignore_layers=ignore_layers,
            quant_lm_head=quant_lm_head)
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
        ids = torch.as_tensor(input_ids, device=self.device).long()
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        logger.info("quantizing %d layers, scheme=%s, iters=%d, nsamples=%d "
                    "seqlen=%d", len(self.layer_schemes), self.scheme.key(),
                    self.cfg.iters, ids.shape[0], ids.shape[1])
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
