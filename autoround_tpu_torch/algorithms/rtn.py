"""Zero-shot RTN layer quantization (counterpart of
``autoround_tpu/algorithms/rtn.py``).  The imatrix-weighted ``opt_rtn``
variant comes with a later slice."""

from __future__ import annotations

from typing import Optional

import torch

from ..dtypes.intq import QdqResult
from ..dtypes.registry import get_quant_func
from ..schemes import QuantizationScheme

__all__ = ["rtn_quantize_layer"]


def rtn_quantize_layer(
    w: torch.Tensor,
    scheme: QuantizationScheme,
    imatrix: Optional[torch.Tensor] = None,
) -> QdqResult:
    """Quantize one weight zero-shot, round to nearest."""
    if imatrix is not None:
        raise NotImplementedError(
            "imatrix-weighted opt-RTN is not ported yet (ROADMAP A2)")
    fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym, mode="rtn")
    return fn(w, bits=scheme.bits, group_size=scheme.group_size)
