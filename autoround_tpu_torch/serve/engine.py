"""Quantized serving engine: packed W4A16 weights + KV cache + decode loop
(counterpart of ``autoround_tpu/serve/engine.py``, Llama family, the
``w4a16`` kind, ``kv_quant`` None or ``"int8"``).

Packed int4 weights stay resident on the card and every packed projection
runs the W4A16 kernel (``ops/qmatmul``); q/k/v and gate/up are fused along
O so one launch serves each group.  Prefill attention takes the flash
kernel where the routing gate passes; every decode step with the int8
cache attends through the int8-KV decode kernel (``ops/decode_attention``).

Unlike the JAX package, the cache is updated in place: ``decode_step``
returns the same buffers it was given, with one more token written.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..models import llama
from ..ops.decode_attention import decode_attention
from ..ops.qmatmul import PLANES, pack_w4, w4a16_matmul
from ..quantize.orchestrator import QuantizeResult
from .sampling import SamplingParams, sample_token

__all__ = ["KVCache", "QuantizedLlama"]

logger = logging.getLogger("autoround_tpu_torch")


class KVCache(NamedTuple):
    """KV cache; optionally int8 storage with per-(layer, head) static
    scales calibrated at prefill."""

    k: torch.Tensor  # (L, B, T, n_kv, hd) — cfg dtype, or int8 storage
    v: torch.Tensor
    length: int      # tokens filled so far
    k_scale: Optional[torch.Tensor] = None  # (L, 1, 1, n_kv, 1) when int8
    v_scale: Optional[torch.Tensor] = None


_KV_QMAX = {"int8": 127.0}


def _init_cache(cfg: llama.LlamaConfig, batch: int, max_seq: int,
                n_layers: int, kv_quant: Optional[str], device) -> KVCache:
    shape = (n_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    store = torch.int8 if kv_quant == "int8" else cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=store, device=device),
                   v=torch.zeros(shape, dtype=store, device=device),
                   length=0)


def _kv_quantize(x: torch.Tensor, scale: torch.Tensor,
                 kv_quant: str) -> torch.Tensor:
    """x (..., n_kv, hd) → int8 storage with a per-head scale."""
    qmax = _KV_QMAX[kv_quant]
    y = torch.clamp(x.float() / scale, -qmax, qmax)
    return torch.round(y).to(torch.int8)


_FUSE_GROUPS = (("qkv", ("q_proj", "k_proj", "v_proj")),
                ("gate_up", ("gate_proj", "up_proj")))


def _fuse_packed(packed: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 cfg: llama.LlamaConfig):
    """Concatenate q/k/v and gate/up packed weights along O so one kernel
    launch replaces three / two (the shared activation is read once).
    Members of a fused group are dropped (the weights are held once).
    Returns (packed', splits) with ``splits`` the static table of member
    widths per fused entry."""
    out = dict(packed)
    splits: Dict[str, Tuple[int, ...]] = {}
    for bi in range(cfg.num_layers):
        for fused_name, members in _FUSE_GROUPS:
            keys = [f"blocks.{bi}.{m}" for m in members]
            if not all(k in packed for k in keys):
                continue
            entries = [packed[k] for k in keys]
            if len({e[1].shape[1] for e in entries}) != 1:
                continue   # different group counts: cannot share a call
            key = f"blocks.{bi}.{fused_name}"
            out[key] = tuple(torch.cat([e[c] for e in entries], dim=0)
                             for c in range(2))
            splits[key] = tuple(int(e[0].shape[0]) for e in entries)
            for k in keys:
                del out[k]
    return out, splits


def _is_w4a16(s) -> bool:
    """Whether the JAX engine serves scheme ``s`` with its w4a16 kernel
    (its ``_serving_kind``): sym int codes of at most 4 bits (3- and 2-bit
    codes fit the int4 layout), groups of 16 or more, bf16 activations."""
    g = s.group_size if isinstance(s.group_size, int) else 0
    act_int8 = s.act_bits == 8 and s.act_data_type == "int" and s.act_sym
    return (s.data_type == "int" and s.sym and g >= 16
            and (s.bits == 3 or (s.bits == 4 and not (act_int8 and g >= 128))
                 or (s.bits == 2 and g < 128)))


def w4_codes_from_qdq(qdq: torch.Tensor, scale: torch.Tensor,
                      group_size: int) -> torch.Tensor:
    """Exact int4 codes of a sym full-range qdq: clip(rint(qdq / scale) +
    8, 0, 15) in fp32, the JAX engine's recovery (``engine.py:390-396``).
    Exact for bits <= 4 even from a bf16 qdq (|code - 8| <= 8)."""
    K = qdq.shape[1]
    srep = scale.float().repeat_interleave(group_size, dim=1)[:, :K]
    return torch.clamp(torch.round(qdq.float() / srep) + 8, 0, 15).to(
        torch.int32)


def _packed_matmul(x: torch.Tensor, entry) -> torch.Tensor:
    """One packed w4a16 projection; the group size follows from shapes."""
    qw, scales = entry
    group_size = (qw.shape[1] * PLANES) // scales.shape[1]
    return w4a16_matmul(x.contiguous(), qw, scales, group_size)


def _make_linear_fn(packed, block_idx: int):
    def lf(name, x, w):
        entry = packed.get(f"blocks.{block_idx}.{name}")
        return (_packed_matmul(x, entry) if entry is not None
                else torch.einsum("...i,oi->...o", x, w))
    return lf


def _fused_call(packed, splits, block_idx: int, fused_name: str, x):
    """Member outputs of a fused projection group, or None."""
    key = f"blocks.{block_idx}.{fused_name}"
    entry = packed.get(key)
    if entry is None:
        return None
    y = _packed_matmul(x, entry)
    return list(torch.split(y, splits[key], dim=-1))


def _final_fwd_packed(params, packed, x, cfg):
    """Final norm + lm_head, through the packed kernel when the head was
    quantized (at 128K vocab the head is the largest weight of a step)."""
    entry = packed.get("lm_head")
    if entry is None:
        return llama.final_fwd(params, x, cfg)
    h = llama.rms_norm(x, params["norm"], cfg.rms_eps)
    return _packed_matmul(h, entry)


def _block_with_cache(weights, x, cos, sin, cfg, kv, pos, lf, packed,
                      block_idx, splits):
    """Decoder block returning (out, k_new, v_new).

    ``kv`` None: prompt pass (causal attention over the prompt).
    ``kv = ("int8_cache", k_all, v_all, k_scale, v_scale, pos_v)``: decode
    over the int8 cache (``pos_v`` the (B,) int32 position vector) — the
    new token is quantized and written at ``pos`` in place, then the
    decode kernel attends over [0, pos].
    ``kv = (k_all, v_all)``: decode over a dense cache (plain math)."""
    B, S, H = x.shape
    hd = cfg.hd
    h = llama.rms_norm(x, weights["input_layernorm"], cfg.rms_eps)
    fused = _fused_call(packed, splits, block_idx, "qkv", h)
    if fused is not None:
        q, k, v = fused
    else:
        q = lf("q_proj", h, weights["q_proj"])
        k = lf("k_proj", h, weights["k_proj"])
        v = lf("v_proj", h, weights["v_proj"])
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)

    if kv is None:
        attn = llama.attention(q, k, v, None, cfg)
    elif isinstance(kv[0], str):               # the "int8_cache" tuple
        _, k_all, v_all, ks, vs, pos_v = kv    # int8 (B, T, n_kv, hd)
        k_all[:, pos] = _kv_quantize(k[:, 0], ks[0], "int8")
        v_all[:, pos] = _kv_quantize(v[:, 0], vs[0], "int8")
        attn = decode_attention(q[:, 0].contiguous(), k_all, v_all, pos_v,
                                ks.reshape(-1), vs.reshape(-1),
                                1.0 / math.sqrt(hd))[:, None]
    else:
        k_all, v_all = kv                      # (B, T, n_kv, hd)
        k_all[:, pos] = k[:, 0].to(k_all.dtype)
        v_all[:, pos] = v[:, 0].to(v_all.dtype)
        idx = torch.arange(k_all.shape[1], device=x.device)
        bias = torch.where(idx <= pos, 0.0, -1e30)[None, None, None, :]
        attn = llama.attention(q, k_all, v_all, bias, cfg)
    x = x + lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"])
    h = llama.rms_norm(x, weights["post_attention_layernorm"], cfg.rms_eps)
    fused_gu = _fused_call(packed, splits, block_idx, "gate_up", h)
    if fused_gu is not None:
        gate, up = fused_gu
    else:
        gate = lf("gate_proj", h, weights["gate_proj"])
        up = lf("up_proj", h, weights["up_proj"])
    return x + lf("down_proj", F.silu(gate) * up, weights["down_proj"]), k, v


def _prefill_core(params, packed, splits, input_ids, *, cfg, max_seq,
                  kv_quant):
    """Prompt pass: fill the cache (int8: per-(layer, head) scales
    calibrated on the prompt as max(amax over (B, S, hd), 1e-6) / 127) and
    return the last position's logits."""
    B, S = input_ids.shape
    if S > max_seq:
        raise ValueError(f"prompt length {S} exceeds max_seq {max_seq}")
    cache = _init_cache(cfg, B, max_seq, cfg.num_layers, kv_quant,
                        input_ids.device)
    x = llama.embed_fwd(params, input_ids, cfg)
    cos, sin = llama.rope_tables(cfg, S, device=x.device)
    k_scales, v_scales = [], []
    for i in range(cfg.num_layers):
        x, k_new, v_new = _block_with_cache(
            params["blocks"][i], x, cos, sin, cfg, None, None,
            _make_linear_fn(packed, i), packed, i, splits)
        if kv_quant is not None:
            qmax = _KV_QMAX[kv_quant]
            ks = torch.clamp(k_new.float().abs().amax(dim=(0, 1, 3),
                                                      keepdim=True),
                             min=1e-6) / qmax          # (1, 1, n_kv, 1)
            vs = torch.clamp(v_new.float().abs().amax(dim=(0, 1, 3),
                                                      keepdim=True),
                             min=1e-6) / qmax
            k_scales.append(ks)
            v_scales.append(vs)
            k_new = _kv_quantize(k_new, ks, kv_quant)
            v_new = _kv_quantize(v_new, vs, kv_quant)
        cache.k[i, :, :S] = k_new.to(cache.k.dtype)
        cache.v[i, :, :S] = v_new.to(cache.v.dtype)
    cache = cache._replace(length=S)
    if kv_quant is not None:
        cache = cache._replace(k_scale=torch.stack(k_scales),
                               v_scale=torch.stack(v_scales))
    logits = _final_fwd_packed(params, packed, x[:, -1:], cfg)
    return logits[:, 0], cache


def _decode_core(params, packed, splits, token, cache, *, cfg, kv_quant):
    """One decode step for the whole batch at position ``cache.length``."""
    pos = cache.length
    if pos >= cache.k.shape[2]:
        raise ValueError(f"KV cache full ({cache.k.shape[2]} positions)")
    x = llama.embed_fwd(params, token[:, None], cfg)
    cos, sin = llama.rope_tables(
        cfg, 1, positions=torch.full((1,), pos, device=x.device))
    pos_v = torch.full((x.shape[0],), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.num_layers):
        if kv_quant is None:
            kv = (cache.k[i], cache.v[i])
        else:
            kv = ("int8_cache", cache.k[i], cache.v[i], cache.k_scale[i],
                  cache.v_scale[i], pos_v)
        x, _, _ = _block_with_cache(
            params["blocks"][i], x, cos, sin, cfg, kv, pos,
            _make_linear_fn(packed, i), packed, i, splits)
    logits = _final_fwd_packed(params, packed, x, cfg)
    return logits[:, 0], cache._replace(length=pos + 1)


@dataclass(eq=False)
class QuantizedLlama:
    """Serving-side model: packed quantized layers + dense residue.

    Build with :meth:`from_quantize_result` and run :meth:`prefill` /
    :meth:`decode_step` / :meth:`generate`."""

    cfg: llama.LlamaConfig
    params: Dict[str, Any]                 # non-packed leaves
    packed: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    max_seq: int = 2048
    kv_quant: Optional[str] = None         # None | "int8"
    fused_splits: Optional[Dict[str, Tuple[int, ...]]] = None
    device: Optional[torch.device] = None

    @classmethod
    def from_quantize_result(cls, result: QuantizeResult,
                             cfg: llama.LlamaConfig, max_seq: int = 2048,
                             kv_quant: Optional[str] = None,
                             device=None) -> "QuantizedLlama":
        """Derive int4 codes from each layer's qdq and scale (exactly the
        JAX engine's codes), pack them in the port's layout and fuse
        q/k/v and gate/up.  Layers whose shapes the kernel cannot take
        serve their dense qdq weights (as in the JAX engine)."""
        if kv_quant not in (None, "int8"):
            raise NotImplementedError(
                f"kv_quant={kv_quant!r} is not ported yet (None or 'int8')")
        dev = resolve_device(device)
        params = {k: v for k, v in result.params.items() if k != "blocks"}
        params["blocks"] = [dict(b) for b in result.params["blocks"]]
        packed: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        dense = 0
        for name, ql in result.layers.items():
            s = ql.scheme
            if not _is_w4a16(s):
                raise NotImplementedError(
                    f"{name}: scheme w{s.bits}a{s.act_bits} (sym={s.sym}, "
                    f"group_size={s.group_size}) needs a packed kernel not "
                    f"ported yet (ROADMAP A10); this slice serves w4a16")
            O, K = ql.qdq.shape
            g = s.group_size
            if g % 32 or K % g:
                dense += 1
                continue
            codes = w4_codes_from_qdq(ql.qdq.to(dev), ql.scale.to(dev), g)
            packed[name] = (pack_w4(codes),
                            ql.scale.to(device=dev, dtype=torch.float32)
                            .contiguous())
            del codes
            parts = name.split(".", 2)
            if parts[0] == "blocks":
                params["blocks"][int(parts[1])][parts[2]] = None
            elif name == "lm_head" and params.get("lm_head") is not None:
                params["lm_head"] = None
        if dense:
            logger.warning("serving engine: %d quantized layer(s) serve as "
                           "dense qdq weights (no packed kernel)", dense)

        def to_dev(t):
            return None if t is None else t.to(dev)

        params = {k: (to_dev(v) if k != "blocks"
                      else [{n: to_dev(w) for n, w in b.items()} for b in v])
                  for k, v in params.items()}
        fused, splits = _fuse_packed(packed, cfg)
        return cls(cfg=cfg, params=params, packed=fused, max_seq=max_seq,
                   kv_quant=kv_quant, fused_splits=splits, device=dev)

    @torch.no_grad()
    def prefill(self, input_ids) -> Tuple[torch.Tensor, KVCache]:
        """Run the prompt (B, S), return (logits of the last position
        (B, V), cache)."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        return _prefill_core(self.params, self.packed, self.fused_splits,
                             ids, cfg=self.cfg, max_seq=self.max_seq,
                             kv_quant=self.kv_quant)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: KVCache
                    ) -> Tuple[torch.Tensor, KVCache]:
        """One token for the whole batch: token (B,) → (logits (B, V),
        cache).  The cache buffers are updated in place."""
        return _decode_core(self.params, self.packed, self.fused_splits,
                            token.to(self.device), cache, cfg=self.cfg,
                            kv_quant=self.kv_quant)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 sampling: Optional[SamplingParams] = None) -> torch.Tensor:
        """Greedy by default, temperature/top-k/top-p with a generator
        seeded from ``sampling.seed`` otherwise.  Returns (B,
        max_new_tokens) int32 token ids."""
        gen = None
        if sampling is not None and not sampling.is_greedy:
            gen = torch.Generator(device=self.device).manual_seed(
                sampling.seed)
        logits, cache = self.prefill(input_ids)
        tok = sample_token(logits, gen, sampling)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode_step(tok, cache)
            tok = sample_token(logits, gen, sampling)
            out.append(tok)
        return torch.stack(out, dim=1)
