"""Carry weights and configs from the JAX package into the port.

``params_from_jax`` takes the JAX parameter tree with its leaves already
converted to numpy arrays (``jax.tree.map(np.asarray, params)``) and
``config_from_jax`` the fields of a JAX config of a text family
(``dataclasses.asdict(cfg)``, or an export's ``model_config``), so this
module needs neither JAX nor the JAX package: both sides then compute
on the same weights.  ``tune_params_from_jax`` carries a tuned state the
same way, and ``quantize_result_to_numpy`` goes the other way: a port
result as the numpy tree the JAX package's results can be compared with.
``packed_from_jax`` turns one packed payload of the JAX serving engine
(numpy) into the port's, for every kind of the JAX engine but the stacked
experts.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.deepseek import DeepseekConfig
from ..models.ernie45 import Ernie45Config
from ..models.glm4moe import Glm4MoeConfig, GlmMoeLiteConfig
from ..models.glmdsa import GlmMoeDsaConfig
from ..models.gptoss import GptOssConfig
from ..models.llama import LlamaConfig
from ..models.llama4 import Llama4Config
from ..models.longcat import LongcatConfig
from ..models.minimax import MiniMaxConfig
from ..models.mixtral import MixtralConfig
from ..models.qwen3next import Qwen35MoeConfig, Qwen3NextConfig
from ..models.step35 import Step35Config
from ..ops.qmatmul import pack_w4
from ..ops.qmatmul_ext import pack_w2

__all__ = ["params_from_jax", "config_from_jax", "tune_params_from_jax",
           "quantize_result_to_numpy", "unpack_w4_bytes", "unpack_planes",
           "packed_from_jax"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _torch_dtype(dt) -> torch.dtype:
    name = np.dtype(dt).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported parameter dtype {dt!r}")
    return _DTYPES[name]


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


# leaves the JAX package keeps in fp32 whatever the model dtype
_FP32_LEAVES = ("e_score_correction_bias", "sinks", "router_bias", "A_log",
                "dt_bias", "slope_rate", "attn_norm")


def params_from_jax(tree: Any, cfg: LlamaConfig, device=None) -> Any:
    """Numpy parameter tree (dicts / lists of arrays, as the JAX package
    lays it out: a MoE block's per-expert list, DeepSeek's
    ``shared_experts`` and ``gate``, LongCat's ``_0`` / ``_1`` leaves) →
    the same tree of tensors on ``device``, in ``cfg``'s dtype for
    floating leaves but the ones the JAX package keeps in fp32 (the
    ``e_score_correction_bias`` of DeepSeek, ERNIE-4.5 and LongCat,
    GPT-OSS's ``sinks``, the ``router_bias`` of GPT-OSS and Step-3.5,
    Qwen3-Next's ``A_log`` and ``dt_bias``, MiniMax's ``slope_rate`` and
    ``attn_norm``, and the ``router`` of ERNIE-4.5 and LongCat, whose JAX
    ``init_params`` make it fp32 where every other family's router is in
    the model dtype)."""
    dev = resolve_device(device)
    fp32 = _FP32_LEAVES + (("router",) if isinstance(
        cfg, (Ernie45Config, LongcatConfig)) else ())

    def rec(node, key=None):
        if isinstance(node, Mapping):
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        if node is None:
            return None
        t = _leaf(node, dev)
        if not t.is_floating_point():
            return t
        return t.to(torch.float32 if key in fp32 else cfg.dtype)

    return rec(tree)


# the port's config classes, by the JAX class each one rebuilds
_PORT_CLASSES = {c.__name__: c for c in (
    LlamaConfig, MixtralConfig, DeepseekConfig, GlmMoeLiteConfig,
    Glm4MoeConfig, GlmMoeDsaConfig, LongcatConfig, GptOssConfig,
    Llama4Config, Qwen3NextConfig, Qwen35MoeConfig, MiniMaxConfig,
    Ernie45Config, Step35Config)}
# every VLM, omni and diffusion class of the JAX package (ROADMAP A14)
# holds ``patch_size``, which no text family has
_A14_FIELD = "patch_size"
# an export's model_config names no class: a field that only one family
# holds names it, tested in this order (a subclass before its base)
_DISTINCTIVE = (
    ("zero_expert_num", LongcatConfig),
    ("index_topk", GlmMoeDsaConfig),
    ("kv_lora_rank", DeepseekConfig),      # GLM-4.5's is 0: see below
    ("moe_layer_interval", Ernie45Config),
    ("swa_num_heads", Step35Config),
    ("full_attn_alpha_factor", MiniMaxConfig),
    ("linear_num_key_heads", Qwen3NextConfig),
    ("no_rope_layers", Llama4Config),
    ("swiglu_alpha", GptOssConfig),
    ("num_experts", MixtralConfig),
)


def _config_class(fields: Mapping[str, Any], cls_name: Optional[str]):
    """The port's class for a JAX config: the one of the same name, or,
    for an export's ``model_config`` (no name), the one its distinctive
    fields imply."""
    if cls_name is not None:
        if cls_name not in _PORT_CLASSES:
            raise NotImplementedError(
                f"{cls_name} is not a config class of the JAX package's "
                f"text families the port has (ROADMAP A14 holds the rest)")
        return _PORT_CLASSES[cls_name]
    for field, cls in _DISTINCTIVE:
        if field in fields:
            if cls is DeepseekConfig and not fields["kv_lora_rank"]:
                return Glm4MoeConfig       # no MLA: GLM-4.5's GQA form
            return cls
    return LlamaConfig


def config_from_jax(fields: Mapping[str, Any],
                    cls_name: Optional[str] = None) -> LlamaConfig:
    """JAX config fields (``dataclasses.asdict(cfg)``, or an export's
    ``model_config``) → the port's config of the same class.  ``cls_name``
    (the JAX class's name) names the class; without it the fields do: a
    ``LongcatConfig`` for ``zero_expert_num``, a ``GlmMoeDsaConfig`` for
    ``index_topk``, a ``DeepseekConfig`` for ``kv_lora_rank`` (a
    ``Glm4MoeConfig`` when it is 0; GLM-4.6-Lite's export comes back as a
    ``DeepseekConfig``, which serves it the same), an ``Ernie45Config``
    for ``moe_layer_interval``, a ``Step35Config`` for ``swa_num_heads``, a
    ``MiniMaxConfig`` for ``full_attn_alpha_factor``, a
    ``Qwen3NextConfig`` for ``linear_num_key_heads`` (Qwen3.5-MoE's export
    too), a ``Llama4Config`` for ``no_rope_layers``, a ``GptOssConfig`` for
    ``swiglu_alpha``, a ``MixtralConfig`` for ``num_experts``, else a
    ``LlamaConfig``; the tuple fields come back as tuples.

    No field is dropped: one the chosen class lacks raises
    ``NotImplementedError``, as do the VLM, omni and diffusion classes
    (ROADMAP A14)."""
    if _A14_FIELD in fields:
        raise NotImplementedError(
            f"{cls_name or 'a config'} with {_A14_FIELD!r} is a vision / "
            f"omni / diffusion model, not ported yet (ROADMAP A14: the VLM, "
            f"omni and DiT / MMDiT models)")
    cls = _config_class(fields, cls_name)
    known = cls.__dataclass_fields__
    odd = sorted(k for k in fields if k not in known and k != "dtype")
    if odd:
        raise NotImplementedError(
            f"{cls_name or 'a config'}: fields {odd} have no place in the "
            f"port's {cls.__name__}; a family that holds them is not ported "
            f"(ROADMAP A14 holds the models left)")
    kw: Dict[str, Any] = {k: v for k, v in fields.items()
                          if k in known and k != "dtype"}
    for name in ("rope_llama3", "layer_types", "moe_layers",
                 "no_rope_layers", "mlp_only_layers", "index_layers"):
        if kw.get(name) is not None:
            kw[name] = tuple(kw[name])
    if "dtype" in fields:
        kw["dtype"] = _torch_dtype(fields["dtype"])
    return cls(**kw)


def tune_params_from_jax(tree: Mapping[str, Mapping[str, Any]],
                         device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Numpy tuning state ``{layer: {v, min_scale, max_scale}}`` → the
    same tree of fp32 tensors on ``device``."""
    dev = resolve_device(device)
    return {name: {k: _leaf(a, dev).float() for k, a in layer.items()}
            for name, layer in tree.items()}


def quantize_result_to_numpy(result) -> Dict[str, Any]:
    """A port ``QuantizeResult`` as numpy: ``{"params": tree, "layers":
    {name: {qdq, scale, zp, act_scale}}, "loss_traces": {...}}``, floats
    widened to fp32 (exact from bf16)."""
    def arr(t):
        if t is None:
            return None
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def rec(node):
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return arr(node)

    return {"params": rec(result.params),
            "layers": {n: {"qdq": arr(q.qdq), "scale": arr(q.scale),
                           "zp": arr(q.zp), "act_scale": arr(q.act_scale),
                           "act_global_scale": arr(q.act_global_scale)}
                       for n, q in result.layers.items()},
            "loss_traces": dict(result.loss_traces)}


def unpack_w4_bytes(packed: np.ndarray) -> np.ndarray:
    """The JAX package's W4A8 byte pairs (O, K // 2) int8 → (O, K) int32
    codes in [0, 15]: in each tile of 2 x 128 columns, byte column c holds
    the first group's code in its low nibble and the second group's code
    XOR 8 in its high nibble."""
    O, Kb = packed.shape
    g = 128
    b = np.asarray(packed).astype(np.int32) & 0xFF
    lo = b & 0xF
    hi = ((b >> 4) & 0xF) ^ 8
    c = np.stack([lo.reshape(O, Kb // g, g), hi.reshape(O, Kb // g, g)],
                 axis=2)
    return c.reshape(O, 2 * Kb)


def unpack_planes(words: np.ndarray, bits: int,
                  group_size: int) -> np.ndarray:
    """The JAX package's bit-plane words (O, K * bits // 32) int32 → (O, K)
    int32 codes: in K-tile t of width (32 // bits) * g, column ``t * (32 //
    bits) * g + j * g + i`` sits in field j (of ``bits`` bits) of word ``t *
    g + i`` (``pack_w4_planes`` for 4 bits, ``pack_w2_planes`` for 2)."""
    planes = 32 // bits
    O, Kw = words.shape
    g = group_size
    w = np.asarray(words).astype(np.uint32).reshape(O, Kw // g, 1, g)
    shifts = (np.arange(planes, dtype=np.uint32) * bits)[None, None, :, None]
    codes = (w >> shifts) & ((1 << bits) - 1)
    return codes.reshape(O, Kw * planes).astype(np.int32)


def packed_from_jax(entry, kind: str, device=None):
    """One packed payload of the JAX engine (a tuple of numpy arrays) →
    the port's, on ``device``: ``w4a8`` byte pairs and the nibble planes of
    ``w4a16``, ``w4a16_asym`` and ``mxfp4`` become the packed words of
    ``pack_w4``, the ``w2a16`` planes those of ``pack_w2``; the int8 codes and the scales of ``w8a8`` and
    ``w8a16`` and the e4m3 bytes and scales of ``fp8`` cross as they are.
    The ``mxfp4_g*`` scales lose the JAX engine's lane padding, by the g of
    the kind (two paddings can give one column count: K = 2048 holds 128
    columns at g = 16 exact and at g = 32 padded)."""
    dev = resolve_device(device)
    if kind == "w4a8":
        codes = torch.from_numpy(unpack_w4_bytes(entry[0])).to(dev)
        return (pack_w4(codes), _leaf(entry[1], dev).float())
    if kind in ("w8a8", "w8a16"):
        return (_leaf(entry[0], dev).to(torch.int8),
                _leaf(entry[1], dev).float())
    if kind == "fp8":
        raw = np.array(entry[0]).view(np.uint8)    # a writable copy
        return (torch.from_numpy(raw).to(dev).view(torch.float8_e4m3fn),
                _leaf(entry[1], dev).float())
    if kind.startswith("mxfp4_g"):
        g = int(kind[len("mxfp4_g"):])
        codes = unpack_planes(entry[0], 4, 128)
        K = codes.shape[1]
        return (pack_w4(torch.from_numpy(codes).to(dev)),
                _leaf(np.asarray(entry[1])[:, :K // g], dev).float()
                .contiguous())
    if kind == "w2a16":
        scales = np.asarray(entry[1])
        K = entry[0].shape[1] * 16
        codes = unpack_planes(entry[0], 2, K // scales.shape[1])
        return (pack_w2(torch.from_numpy(codes).to(dev)),
                _leaf(scales, dev).float())
    if kind in ("w4a16", "w4a16_asym"):
        scales = np.asarray(entry[1])
        K = entry[0].shape[1] * 8
        codes = unpack_planes(entry[0], 4, K // scales.shape[1])
        return (pack_w4(torch.from_numpy(codes).to(dev)),
                _leaf(scales, dev).float()) + tuple(
                    _leaf(e, dev).float() for e in entry[2:])
    raise ValueError(f"unknown packed kind {kind!r}")
