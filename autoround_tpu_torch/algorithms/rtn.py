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
    **extras,
) -> QdqResult:
    """Quantize one weight zero-shot; ``extras`` are keywords for the qdq
    (a double-quant scheme adds its ``super_bits`` / ``super_group_size``)."""
    if scheme.super_bits is not None:
        extras.setdefault("super_bits", scheme.super_bits)
        extras.setdefault("super_group_size", scheme.super_group_size)
    if imatrix is not None:
        try:
            fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym,
                                mode="opt_rtn")
            return fn(w, bits=scheme.bits, group_size=scheme.group_size,
                      imatrix=imatrix, **extras)
        except KeyError:
            pass
    fn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym, mode="rtn")
    return fn(w, bits=scheme.bits, group_size=scheme.group_size, **extras)
