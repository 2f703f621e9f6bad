"""Public API: the ``AutoRound`` entry point (counterpart of
``autoround_tpu/api.py``): normalize the scheme, resolve the per-layer
plan, run block-chain SignRound tuning (or RTN when ``iters=0``) and hand
the result to the export writers."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union

import logging
import os

import torch

from ._device import resolve_device
from .models.registry import ALL_PRESETS, get_model_fns
from .quantize.layer_config import resolve_layer_schemes
from .quantize.orchestrator import QuantizeConfig, QuantizeResult, quantize_model
from .schemes import QuantizationScheme, parse_scheme

__all__ = ["AutoRound"]

logger = logging.getLogger("autoround_tpu_torch")


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
    ``models.registry.ALL_PRESETS`` (random weights from ``seed``).
    ``device=None`` means the CUDA card and raises without one; params
    not already there are moved.  ``iters=0`` is zero-shot RTN.  Extra
    keyword arguments naming ``QuantizeConfig`` fields pass through (e.g.
    ``cache_batch``, ``use_remat``); an option this slice leaves out raises
    ``NotImplementedError`` when ``quantize`` runs.
    """

    def __init__(
        self,
        model,
        scheme: Union[str, dict, QuantizationScheme] = "W4A16",
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
        device=None,
        **kw,
    ):
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
        self.result: Optional[QuantizeResult] = None

    def quantize(self, input_ids, mask=None) -> QuantizeResult:
        """input_ids: (nsamples, seqlen) token ids (tensor or array);
        mask: optional (nsamples, seqlen) valid-token mask."""
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
        if len(fmts) == 1:
            return save_quantized(self.result, self.model_cfg, output_dir,
                                  fmts[0])
        for f in fmts:
            save_quantized(self.result, self.model_cfg,
                           os.path.join(output_dir, f.replace(":", "_")), f)
        return output_dir

    def quantize_and_save(self, input_ids, output_dir: str,
                          format: str = "fake", mask=None) -> str:
        self.quantize(input_ids, mask=mask)
        return self.save_quantized(output_dir, format=format)
