"""Zero-shot RTN layer quantization (counterpart of
``autoround_tpu/algorithms/rtn.py``): plain round-to-nearest, or the
imatrix-weighted scale search (``opt_rtn``) when an imatrix is given and
the data type has one registered."""

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
    """Quantize one weight zero-shot."""
    if imatrix is not None:
        try:
            fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym,
                                mode="opt_rtn")
            return fn(w, bits=scheme.bits, group_size=scheme.group_size,
                      imatrix=imatrix)
        except KeyError:
            pass
    fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym, mode="rtn")
    return fn(w, bits=scheme.bits, group_size=scheme.group_size)
