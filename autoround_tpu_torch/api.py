"""Public API: the ``AutoRound`` entry point (counterpart of
``autoround_tpu/api.py``), limited to ``iters=0`` (RTN) in this slice."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union

import torch

from ._device import resolve_device
from .models import llama
from .quantize.layer_config import resolve_layer_schemes
from .quantize.orchestrator import QuantizeConfig, QuantizeResult, quantize_model
from .schemes import QuantizationScheme, parse_scheme

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
    """AutoRound quantizer for Llama-family models.

    Example::

        ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                       quant_lm_head=True)
        result = ar.quantize(input_ids)        # (nsamples, seqlen) tokens

    ``model`` is ``(params, cfg)`` or a preset name of
    ``models.llama.CONFIG_PRESETS`` (random weights from ``seed``).
    ``device=None`` means the CUDA card and raises without one; params
    not already there are moved.  ``iters > 0`` (SignRound) is not ported
    yet and raises ``NotImplementedError``.
    """

    def __init__(
        self,
        model,
        scheme: Union[str, dict, QuantizationScheme] = "W4A16",
        iters: int = 200,
        seed: int = 42,
        layer_config: Optional[Dict[str, Any]] = None,
        ignore_layers: Optional[Iterable[str]] = None,
        quant_lm_head: bool = False,
        donate_params: bool = False,
        device=None,
    ):
        if iters > 0:
            raise NotImplementedError(
                "SignRound tuning (iters > 0) is not ported yet: ROADMAP "
                "'A3. SignRound' (next slice); use iters=0 for RTN")
        self.device = resolve_device(device)
        if isinstance(model, str):
            cfg = llama.CONFIG_PRESETS[model]
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(cfg, gen, self.device)
        else:
            params, cfg = model
            params = _to_device(params, self.device)
        self.params = params
        self.model_cfg = cfg
        self.scheme = parse_scheme(scheme)
        self.layer_schemes = resolve_layer_schemes(
            cfg.num_layers, llama.block_linear_names(cfg), self.scheme,
            layer_config=layer_config, ignore_layers=ignore_layers,
            quant_lm_head=quant_lm_head)
        self.cfg = QuantizeConfig(iters=iters, donate_params=donate_params)
        self.result: Optional[QuantizeResult] = None

    def quantize(self, input_ids) -> QuantizeResult:
        """input_ids: (nsamples, seqlen) token ids (tensor or array)."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        with torch.no_grad():
            self.result = quantize_model(self.params, self.model_cfg,
                                         self.layer_schemes, ids, self.cfg)
        return self.result
