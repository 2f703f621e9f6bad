"""Load HF-layout GPTQ and AWQ checkpoints for serving (counterpart of
``autoround_tpu/serve/gptq_loader.py``).

The layout comes from the ``quantization_config`` of ``config.json``:

  * GPTQ v1: qweight (I*bits/32, O), qzeros storing zp - 1, g_idx;
  * AWQ gemm: qweight (I, O/8) with the outputs interleaved in each word,
    real zero points.

A GPTQ layer that is 4-bit, centred (every zero point 8, i.e. symmetric),
contiguous (``g_idx`` absent or ``arange(I) // g``) at g >= 128 packs as
``w4a16``; an AWQ 4-bit layer at g >= 128 packs as ``w4a16_asym`` with its
zero points; each only where the kernels take its shape (``w4_tileable``).
Every other layer serves dense as ``(codes - zp) * scale`` in the model
dtype, an act-order layer with its ``g_idx``-indexed scales (logged).
A packed layer keeps no dense leaf (``None``); the JAX loader keeps a zero
placeholder of the full (O, I) shape there, which on the card would hold a
bf16 copy of every packed weight.

Tensors are read one at a time with ``utils/safetensors_io.py`` straight
to the device, where the packed words are unpacked
(``export.formats.*_unpack_layer``) and repacked in the port's
layout.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .._device import resolve_device
from ..export.formats import awq_unpack_layer, gptq_unpack_layer
from ..ops.qmatmul import pack_w4, w4_tileable
from ..utils.hf_loader import _BLOCK_MAP, _TOP_MAP, config_from_hf, shard_files
from ..utils.logger import logger
from ..utils.safetensors_io import SafeOpen

__all__ = ["load_quantized_checkpoint"]


class _Tensors:
    """Every tensor of a checkpoint's shards by name, read on demand."""

    def __init__(self, path: str, device):
        self._files = [SafeOpen(os.path.join(path, s), device=device)
                       for s in shard_files(path)]
        self._where = {k: f for f in self._files for k in f.keys()}

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def get(self, key: str) -> torch.Tensor:
        return self._where[key].get_tensor(key)

    def close(self) -> None:
        for f in self._files:
            f.close()


def _dense(codes, scale, zp, cols, dtype) -> torch.Tensor:
    """(codes - zp[:, cols]) * scale[:, cols] in fp32, cast to dtype."""
    return ((codes.float() - zp[:, cols].float()) * scale[:, cols]).to(dtype)


def load_quantized_checkpoint(path: str, dtype=torch.bfloat16,
                              method: Optional[str] = None, device=None):
    """HF-layout GPTQ / AWQ checkpoint → (params, cfg, packed, kinds) on
    ``device`` (``None``: the card; raises without one).  ``packed`` maps
    flat layer names to the engine's payloads ((qweight, scales) for
    ``w4a16``, (qweight, scales, zps) for ``w4a16_asym``), ``kinds`` names
    each one's kernel."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    qcfg = hf_cfg.get("quantization_config", {})
    if method is None:
        method = str(qcfg.get("quant_method", "gptq")).lower()
        if method not in ("gptq", "awq"):
            method = "awq" if qcfg.get("version") == "gemm" else "gptq"
    bits = int(qcfg.get("bits", qcfg.get("w_bit", 4)))
    group_size = int(qcfg.get("group_size", qcfg.get("q_group_size", 128)))
    cfg = config_from_hf(hf_cfg, dtype)

    blocks = [dict() for _ in range(cfg.num_layers)]
    params: Dict[str, Any] = {"blocks": blocks}
    packed: Dict[str, Tuple[torch.Tensor, ...]] = {}
    kinds: Dict[str, str] = {}
    tensors = _Tensors(path, dev)

    def pack(name, codes, kind, *rest):
        packed[name] = (pack_w4(codes),) + tuple(
            r.float().contiguous() for r in rest)
        kinds[name] = kind

    def ingest(name, hf_prefix):
        """The dense leaf of one layer, or None when it packed (or the
        checkpoint lacks it)."""
        qn = f"{hf_prefix}.qweight"
        if qn not in tensors:
            wn = f"{hf_prefix}.weight"
            return tensors.get(wn).to(dtype) if wn in tensors else None
        payload = {s: tensors.get(f"{hf_prefix}.{s}")
                   for s in ("qweight", "qzeros", "scales")}
        if method == "awq":
            I = payload["qweight"].shape[0]
            O = payload["qweight"].shape[1] * (32 // bits)
            codes, scale, zp = awq_unpack_layer(payload, O, I)
            g = group_size if group_size > 0 else I
            if bits == 4 and group_size >= 128 and w4_tileable(I, g):
                pack(name, codes, "w4a16_asym", scale, zp)
                return None
            cols = torch.arange(I, device=dev) // g
            return _dense(codes, scale, zp, cols, dtype)
        O = payload["qweight"].shape[1]
        I = payload["qweight"].shape[0] * 32 // bits
        codes, scale, zp = gptq_unpack_layer(payload, bits, O, I)
        g = group_size if group_size > 0 else I
        # act-order (desc_act) layers carry a g_idx that is not
        # arange(I) // g: the kernel's groups are contiguous, so they
        # serve dense with their g_idx-indexed scales
        gn = f"{hf_prefix}.g_idx"
        cols = torch.arange(I, device=dev) // g
        contiguous = True
        if gn in tensors:
            gi = tensors.get(gn).long()
            contiguous = torch.equal(gi, cols)
            cols = gi
        centered = bool((zp == 2 ** (bits - 1)).all())
        if (contiguous and bits == 4 and centered and group_size >= 128
                and w4_tileable(I, g)):
            pack(name, codes, "w4a16", scale)
            return None
        if not contiguous:
            logger.info("gptq loader: %s has act-order g_idx; serving dense",
                        name)
        return _dense(codes, scale, zp, cols, dtype)

    try:
        for hf_key, ours in _TOP_MAP.items():
            leaf = ingest(ours, hf_key[: -len(".weight")])
            if leaf is not None or ours in packed:
                params[ours] = leaf
        for li in range(cfg.num_layers):
            for hf_sub, ours in _BLOCK_MAP.items():
                pre = f"model.layers.{li}.{hf_sub}"
                name = f"blocks.{li}.{ours}"
                if hf_sub.endswith(".weight"):
                    leaf = ingest(name, pre[: -len(".weight")])
                else:
                    leaf = tensors.get(pre).to(dtype) if pre in tensors \
                        else None
                if leaf is not None or name in packed:
                    blocks[li][ours] = leaf
    finally:
        tensors.close()
    if cfg.tie_embeddings:
        params.pop("lm_head", None)
    logger.info("%s loader: %d packed layers, bits=%d g=%d", method,
                len(packed), bits, group_size)
    return params, cfg, packed, kinds
