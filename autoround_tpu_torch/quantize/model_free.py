"""Model-free streaming quantization (counterpart of
``autoround_tpu/quantize/model_free.py``; its files equal the JAX
package's byte for byte).

Quantize a safetensors checkpoint without building the model: stream each
shard, RTN every eligible 2-D weight tensor by tensor on the device, and
write the output shards, their index and a ``quantization_config.json``
(``config.json`` is copied through with the config added).  No forward
pass runs, so any architecture goes.

Two special inputs, as in the JAX package:

* FP8-source checkpoints (DeepSeek-V3 / R1: e4m3 or e5m2 weights with a
  ``weight_scale_inv`` or ``weight_scale`` that is one number or a 128 x
  128 block grid): each weight is dequantized on the device first
  (:func:`_dequant_fp8_source`) and its scale tensor is consumed, not
  copied (a scale is looked up in its weight's shard only, as in the JAX
  package).  ``utils.hf_loader.load_hf_checkpoint`` shares the dequant.
* Fused-MoE expert stacks (E, O, I): each expert's slice is quantized on
  its own, named ``<base>.<e>``.

Files are read and written by ``utils/safetensors_io.py`` (the card's
machine has no ``safetensors`` package).  ``num_workers`` (default
``AR_MODEL_FREE_SHARD_PARALLELISM``, else 1) shards run at once, in
threads of this process that share the device: one CUDA context, whose
default stream orders their kernels, while one thread's file reads and
writes overlap another's RTN.  Each shard's output depends on that shard
alone, so the files of a parallel run equal a serial run's byte for byte.
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Union

import torch

from .. import envs
from .._device import resolve_device
from ..schemes import QuantizationScheme, parse_scheme
from ..utils.logger import logger
from ..utils.safetensors_io import SafeOpen, save_file

__all__ = ["model_free_quantize"]

# default eligibility: 2-D weights that look like projection / linear
# kernels, skipping norms and embeddings
_DEFAULT_INCLUDE = r".*(proj|fc\d*|w\d|dense|gate|up|down|qkv|out|o)\.weight$"
_DEFAULT_EXCLUDE = r".*(embed|norm|ln|layernorm|lm_head|rotary).*"
_FP8_CODES = ("F8_E4M3", "F8_E5M2")
_SCALE_SUFFIXES = (".weight_scale_inv", ".weight_scale")


def _dequant_fp8_source(w: torch.Tensor, scale: Optional[torch.Tensor]
                        ) -> torch.Tensor:
    """An FP8 source weight (fp32 values) times its ``weight_scale_inv``:
    one number, or a grid of blocks, on the weight's device.  A grid of
    (ceil(O/128), ceil(I/128)) is DeepSeek's 128 x 128 blocks, the last
    ones cut; any other grid splits the weight evenly (ceil(O/rows) x
    ceil(I/cols)), as the JAX package splits every grid.  The two agree
    where 128 divides the weight; where it does not (DeepSeek-V3's
    576-row ``kv_a_proj_with_mqa``) the JAX package's blocks are 116 rows
    and scale the wrong rows (ROADMAP C)."""
    if scale is None:
        return w
    s = scale.to(w.device, torch.float32)
    if s.ndim <= 1 and s.numel() == 1:
        return w * float(s.reshape(()))
    O, I = w.shape
    if tuple(s.shape) == (-(-O // 128), -(-I // 128)):
        bo = bi = 128
    else:
        bo, bi = -(-O // s.shape[0]), -(-I // s.shape[1])
    s_full = s.repeat_interleave(bo, dim=0).repeat_interleave(
        bi, dim=1)[:O, :I]
    return w * s_full


def _quantize_tensor(name: str, w: torch.Tensor, scheme: QuantizationScheme,
                     pack: bool) -> Dict[str, torch.Tensor]:
    """RTN one tensor in fp32: its packed ``autoround`` payload, or (not
    packed, or not an int scheme) the qdq in the tensor's dtype under the
    name without ``.weight``."""
    from ..algorithms.rtn import rtn_quantize_layer
    from ..export.packing import codes_from_qdq_torch, pack_quantized_torch

    r = rtn_quantize_layer(w.float(), scheme)
    if not pack or scheme.data_type != "int":
        return {name: r.qdq.float().to(w.dtype)}
    g = scheme.group_size if scheme.group_size > 0 else w.shape[1]
    scale = r.scale.float()
    codes = codes_from_qdq_torch(r.qdq.float(), scale, r.zp, scheme.bits, g)
    payload = pack_quantized_torch(codes, scale, r.zp, scheme.bits)
    return {f"{name}.{k}": v for k, v in payload.items()}


def _process_shard(shard_path: str, out_dir: str, scheme, include: str,
                   exclude: str, pack: bool, device):
    """Quantize the eligible tensors of one shard and write its output
    shard → (file name, {tensor: file name}, quantized names)."""
    inc = re.compile(include)
    exc = re.compile(exclude)
    out: Dict[str, torch.Tensor] = {}
    quantized: List[str] = []
    with SafeOpen(shard_path, device=device) as f:
        keys = set(f.keys())

        def scale_for(key):
            base = key[: -len(".weight")] if key.endswith(".weight") else key
            for suffix in _SCALE_SUFFIXES:
                if base + suffix in keys:
                    return f.get_tensor(base + suffix)
            return None

        consumed = {k for k in keys if k.endswith(_SCALE_SUFFIXES)
                    and (k.rsplit(".", 1)[0] + ".weight" in keys
                         or k.rsplit(".", 1)[0] in keys)}
        for key in sorted(keys):
            if key in consumed:
                continue
            t = f.get_tensor(key)
            fp8_src = f.dtype_code(key) in _FP8_CODES
            if fp8_src:
                t = t.float()
            eligible = (t.ndim >= 2 and inc.fullmatch(key)
                        and not exc.fullmatch(key)
                        and t.shape[-1] >= 32 and t.shape[-2] >= 32)
            base = key[: -len(".weight")] if key.endswith(".weight") else key
            if t.ndim == 2 and eligible:
                if fp8_src:
                    t = _dequant_fp8_source(t, scale_for(key))
                out.update(_quantize_tensor(base, t, scheme, pack))
                quantized.append(base)
            elif t.ndim == 3 and eligible:
                # a fused MoE stack: each expert's slice on its own
                s3 = scale_for(key) if fp8_src else None
                for e in range(t.shape[0]):
                    we = t[e]
                    if fp8_src:
                        se = (s3[e] if s3 is not None and s3.ndim == 3
                              else s3)
                        we = _dequant_fp8_source(we, se)
                    out.update(_quantize_tensor(f"{base}.{e}", we, scheme,
                                                pack))
                    quantized.append(f"{base}.{e}")
            else:
                out[key] = t
    fname = os.path.basename(shard_path)
    save_file(out, os.path.join(out_dir, fname))
    return fname, {k: fname for k in out}, quantized


def model_free_quantize(
    model_path: str,
    output_dir: str,
    scheme: Union[str, QuantizationScheme] = "W4A16",
    include: str = _DEFAULT_INCLUDE,
    exclude: str = _DEFAULT_EXCLUDE,
    pack: bool = True,
    num_workers: Optional[int] = None,
    device=None,
) -> str:
    """Stream-quantize a safetensors checkpoint directory into
    ``output_dir`` (returned).  ``num_workers=None`` reads
    ``AR_MODEL_FREE_SHARD_PARALLELISM``; ``device=None`` is the CUDA card
    (it raises without one)."""
    dev = resolve_device(device)
    scheme = parse_scheme(scheme)
    scheme_dict = {k: getattr(scheme, k) for k in (
        "bits", "group_size", "sym", "data_type", "super_bits",
        "super_group_size")}
    os.makedirs(output_dir, exist_ok=True)
    from ..utils.hf_loader import shard_files
    shards = shard_files(model_path)
    if num_workers is None:
        num_workers = envs.AR_MODEL_FREE_SHARD_PARALLELISM
    num_workers = max(1, min(num_workers, len(shards)))

    def one(shard):
        return _process_shard(os.path.join(model_path, shard), output_dir,
                              scheme, include, exclude, pack, dev)

    if num_workers == 1:
        results = [one(s) for s in shards]
    else:
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(one, shards))
    weight_map: Dict[str, str] = {}
    all_quantized: List[str] = []
    for fname, wmap, quantized in results:
        weight_map.update(wmap)
        all_quantized.extend(quantized)

    with open(os.path.join(output_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"weight_map": weight_map}, f, indent=2)
    qcfg = {
        "quant_method": "auto-round",
        "provider": "autoround_tpu.model_free",
        "packed": pack,
        "scheme": scheme_dict,
        "quantized_layers": sorted(all_quantized),
    }
    with open(os.path.join(output_dir, "quantization_config.json"), "w") as f:
        json.dump(qcfg, f, indent=2)
    src_cfg = os.path.join(model_path, "config.json")
    if os.path.exists(src_cfg):
        with open(src_cfg) as f:
            cfg = json.load(f)
        cfg["quantization_config"] = qcfg
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
    logger.info("model-free: quantized %d tensors across %d shards -> %s",
                len(all_quantized), len(shards), output_dir)
    return output_dir
