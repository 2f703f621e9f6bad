"""Per-layer quantization plan resolution (counterpart of
``autoround_tpu/quantize/layer_config.py``, ``resolve_layer_schemes``).

Layer names are ``blocks.<i>.<linear>`` plus ``lm_head``; ``<linear>`` may
itself be a dotted path (``experts.3.w1`` in a MoE block).  The special
mixed recipes ``W4A16_MIXED`` and ``GGUF:Q2_K_MIXED`` expand in
:func:`handle_special_scheme`; :func:`apply_gguf_cascade` rewrites a GGUF
plan with the export's per-layer types and adds the token embedding.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Union

from ..schemes import QuantizationScheme, parse_scheme
from ..utils.pytree import get_by_path

__all__ = ["resolve_layer_schemes", "handle_special_scheme",
           "prune_missing_layers", "apply_gguf_cascade"]


def handle_special_scheme(scheme, linear_names, quant_lm_head: bool):
    """Expand a special recipe into (base scheme, per-layer overrides,
    effective quant_lm_head, GGUF base), or None for any other scheme.
    ``GGUF:Q2_K_MIXED``: the routed experts on the Q2_K grid, everything
    else Q4_K_S, the lm_head (and, in the API, the embedding) Q8_0.
    ``W4A16_MIXED``: the routed experts W4A16, everything else W8A16, the
    lm_head W8A16 when ``quant_lm_head``."""
    if not isinstance(scheme, str):
        return None
    s = scheme.lower()
    if s == "gguf:q2_k_mixed":
        overrides = {ln: "GGUF:Q2_K_S" for ln in linear_names
                     if "experts." in ln and "shared" not in ln}
        overrides["lm_head"] = QuantizationScheme(
            bits=8, group_size=32, sym=True, data_type="int")
        return "GGUF:Q4_K_S", overrides, True, "GGUF:Q4_K_S"
    if s == "w4a16_mixed":
        overrides = {ln: "W4A16" for ln in linear_names
                     if "experts." in ln and "shared" not in ln}
        return "W8A16", overrides, quant_lm_head, None
    return None


def prune_missing_layers(plan: Dict[str, QuantizationScheme],
                         params) -> Dict[str, QuantizationScheme]:
    """Drop the ``blocks.*`` entries whose path is not in the params tree.
    Models whose blocks differ (DeepSeek: the ``first_k_dense`` blocks have
    a dense MLP, the rest expert leaves) list the union of their linear
    names for every block; the entries a block lacks are expected, not
    errors.  ``lm_head`` stays."""
    out = {}
    for n, s in plan.items():
        if n.startswith("blocks."):
            try:
                get_by_path(params, n)
            except (KeyError, IndexError, TypeError, ValueError):
                continue
        out[n] = s
    return out


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


_Q8_0 = QuantizationScheme(bits=8, group_size=32, sym=True, data_type="int")


def apply_gguf_cascade(
    plan: Dict[str, QuantizationScheme],
    params,
    num_layers: int,
    gguf_name: str,
    quant_lm_head: bool = False,
    pinned: Iterable[str] = (),
    model_cfg=None,
) -> Dict[str, QuantizationScheme]:
    """Rewrite a uniform GGUF plan with the export's per-layer type
    cascade, so each layer tunes on the grid the file will store: the
    ``_M`` mixed-rule upgrades (``export.gguf.select_layer_qtype``), the
    256-divisibility fallback (to Q8_0's int8 g32 grid, or FP), and the
    token embedding's entry.  A ``pinned`` layer (a special recipe's) keeps
    its type but for the fallback.  Non-k-quant names (``Q4_0``, ``Q8_0``)
    come back unchanged."""
    from ..export.gguf import BLOCK_ELEMS, GGMLType, QK, select_layer_qtype
    from ..schemes import PRESET_SCHEMES

    name = gguf_name.split(":", 1)[-1].lower()
    base_map = {"q2_k": GGMLType.Q2_K, "q2_k_s": GGMLType.Q2_K,
                "q3_k": GGMLType.Q3_K, "q3_k_s": GGMLType.Q3_K,
                "q3_k_m": GGMLType.Q3_K, "q4_k": GGMLType.Q4_K,
                "q4_k_s": GGMLType.Q4_K, "q4_k_m": GGMLType.Q4_K,
                "q5_k": GGMLType.Q5_K, "q5_k_s": GGMLType.Q5_K,
                "q5_k_m": GGMLType.Q5_K, "q6_k": GGMLType.Q6_K}
    base_t = base_map.get(name)
    if base_t is None:
        return plan
    mixed = name.endswith("_m")
    n_gqa, n_expert = 1, 0
    if model_cfg is not None:
        nh = getattr(model_cfg, "num_heads", 0)
        nkv = getattr(model_cfg, "num_kv_heads", 0) or nh
        n_gqa = max(1, nh // nkv) if nh else 1
        n_expert = (getattr(model_cfg, "num_experts", 0)
                    or getattr(model_cfg, "n_routed_experts", 0) or 0)
    type2scheme = {GGMLType.Q2_K: PRESET_SCHEMES["GGUF:Q2_K_S"],
                   GGMLType.Q3_K: PRESET_SCHEMES["GGUF:Q3_K_S"],
                   GGMLType.Q4_K: PRESET_SCHEMES["GGUF:Q4_K_S"],
                   GGMLType.Q5_K: PRESET_SCHEMES["GGUF:Q5_K_S"],
                   GGMLType.Q6_K: PRESET_SCHEMES["GGUF:Q6_K"]}
    kind_map = {"q_proj": "attn_q", "k_proj": "attn_k", "v_proj": "attn_v",
                "o_proj": "attn_output", "gate_proj": "ffn_gate",
                "up_proj": "ffn_up", "down_proj": "ffn_down"}
    scheme2type = {sch.key(): t for t, sch in type2scheme.items()}
    pinned = set(pinned)

    def shape_of(flat):
        return get_by_path(params, flat).shape

    def fallback(t, I):
        if I % BLOCK_ELEMS.get(t, 1):
            return GGMLType.Q8_0 if I % QK == 0 else None
        return t

    has_head = params.get("lm_head") is not None
    out: Dict[str, QuantizationScheme] = {}
    for flat, s in plan.items():
        parts = flat.split(".")
        if flat == "lm_head":
            kind, bi = "output", 0
        elif parts[0] == "blocks":
            kind, bi = kind_map.get(parts[-1], "other"), int(parts[1])
        else:
            kind, bi = "other", 0
        try:
            O, I = shape_of(flat if flat != "lm_head" or has_head
                            else "embed_tokens")
        except (KeyError, IndexError, TypeError, ValueError,
                AttributeError):
            out[flat] = s
            continue
        if flat in pinned or any(flat.endswith("." + p) or flat == p
                                 for p in pinned):
            t = scheme2type.get(s.key())
            if t is None:
                out[flat] = s
                continue
            t = fallback(t, I)
        elif mixed:
            t = select_layer_qtype(base_t, bi, num_layers, kind, I,
                                   n_gqa=n_gqa, n_expert=n_expert)
        else:
            t = fallback(base_t, I)
        if t is None or t == GGMLType.F16:
            continue                               # stays FP
        out[flat] = _Q8_0 if t == GGMLType.Q8_0 else type2scheme[t]

    # GGUF files quantize the token embedding too: the orchestrator
    # quantizes it up front and re-caches the quantized chain from it
    if "embed_tokens" not in out:
        try:
            _, H = shape_of("embed_tokens")
        except (KeyError, IndexError, TypeError, ValueError,
                AttributeError):
            H = 0
        if H:
            t = (select_layer_qtype(base_t, 0, num_layers, "token_embd", H)
                 if mixed else base_t)
            if H % BLOCK_ELEMS.get(t, 1):
                t = GGMLType.Q8_0 if H % QK == 0 else GGMLType.F16
            if t == GGMLType.Q8_0:
                out["embed_tokens"] = _Q8_0
            elif t in type2scheme:
                out["embed_tokens"] = type2scheme[t]
    return out
