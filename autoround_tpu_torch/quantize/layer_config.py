"""Per-layer quantization plan resolution (counterpart of
``autoround_tpu/quantize/layer_config.py``, ``resolve_layer_schemes``).

Layer names are ``blocks.<i>.<linear>`` plus ``lm_head``; ``<linear>`` may
itself be a dotted path (``experts.3.w1`` in a MoE block).  The special
mixed recipes (``GGUF:Q2_K_MIXED``, ``W4A16_MIXED``) and the GGUF cascade
come with later slices of the port.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Union

from ..schemes import QuantizationScheme, parse_scheme

__all__ = ["resolve_layer_schemes"]


def _matches(name: str, pattern: str) -> bool:
    return (name == pattern or name.split(".")[-1] == pattern
            or name.endswith("." + pattern) or re.fullmatch(pattern, name)
            is not None)


def resolve_layer_schemes(
    num_layers: int,
    linear_names: Iterable[str],
    scheme: Union[str, QuantizationScheme],
    layer_config: Optional[Dict[str, Union[str, dict, QuantizationScheme]]] = None,
    ignore_layers: Optional[Iterable[str]] = None,
    quant_lm_head: bool = False,
) -> Dict[str, QuantizationScheme]:
    """Build {flat_layer_name: scheme} for every quantizable linear.

    ``layer_config`` keys may be exact flat names (``blocks.3.q_proj``),
    name suffixes applying wherever they end a name (``down_proj``,
    ``experts.0.w1``, or ``w1`` for every expert), or regexes.
    Values may be partial dicts — unset fields inherit the base scheme.
    """
    base = parse_scheme(scheme)
    names = [f"blocks.{i}.{ln}" for i in range(num_layers)
             for ln in linear_names]
    if quant_lm_head:
        names.append("lm_head")

    plan = {n: base for n in names}

    for pattern, override in (layer_config or {}).items():
        if isinstance(override, (str, QuantizationScheme)):
            ov_scheme, merge = parse_scheme(override), False
        else:
            ov_scheme, merge = override, True
        matched = False
        for n in names:
            if _matches(n, pattern):
                matched = True
                plan[n] = (plan[n].with_overrides(**ov_scheme)
                           if merge else ov_scheme)
        if not matched:
            raise ValueError(
                f"layer_config pattern {pattern!r} matched no layer")

    for pattern in ignore_layers or ():
        for n in list(plan):
            if _matches(n, pattern):
                del plan[n]

    # drop unquantized entries
    return {n: s for n, s in plan.items() if s.is_weight_quantized}
