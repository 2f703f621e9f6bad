"""Continuous batching: slot-based scheduling over one shared KV cache
(counterpart of ``autoround_tpu/serve/batching.py``).

Requests join and leave a fixed-size batch independently: a prompt pass
fills a free slot's KV region while the other slots keep their state, and
every decode step advances all active slots, each at its own position.

  * fixed ``max_batch`` / ``max_seq``: one static cache, dense in
    ``cfg.dtype`` as in the JAX engine (there is no int8 batcher there);
    for an MLA config (DeepSeek, GLM-4.6-Lite) it holds the compressed
    latents, ``k`` (L, B, T, 1, kv_lora_rank) and ``v`` (L, B, T, 1,
    qk_rope_head_dim), and the steps run the engine's MLA block;
  * per-slot lengths are a (B,) int32 tensor on the device: RoPE
    positions, causal, window and chunk masks, GPT-OSS's sinks, Llama 4's
    NoPE temperature and KV appends are vectorized over slots through the
    engine's per-slot ``_block_with_cache``, so an idle slot costs a
    masked lane, not a branch;
  * prompts pad to buckets (powers of two by default), as in JAX;
  * on the card the decode step runs over static buffers (the cache, the
    lengths, the last tokens, the active mask) and is captured once per
    batcher as a CUDA graph, then replayed; each prompt pass runs eagerly.

Sampling draws from one ``torch.Generator`` seeded from ``sampling.seed``
(the JAX batcher splits a key per call: other numbers, same distribution).

A hybrid config (Qwen3-Next, Qwen3.5-MoE, MiniMax) raises
``NotImplementedError`` with the JAX batcher's wording: its conv tails and
recurrent states would need per-slot buffers.  No batcher takes an
ERNIE-4.5, LongCat or Step-3.5 model: its ``QuantizedLlama`` refuses them
at construction (the JAX engine serves none of them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models import deepseek, llama
from .engine import (QuantizedLlama, _block_with_cache, _final_fwd_packed,
                     _is_hybrid, _make_linear_fn, _StepReplay, decode_core,
                     rope_pair)
from .sampling import SamplingParams, sample_token

__all__ = ["ContinuousBatchingEngine", "Request"]


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    slot: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False


class _BatchCache(NamedTuple):
    k: torch.Tensor           # (L, B, T, n_kv, hd) in cfg.dtype (MLA: c_kv)
    v: torch.Tensor
    lengths: torch.Tensor     # (B,) int32: where each slot writes next
    last_token: torch.Tensor  # (B,) int32: the token each slot embeds next


class ContinuousBatchingEngine:
    """Wraps a ``QuantizedLlama`` with slot scheduling.

    Usage::

        eng = ContinuousBatchingEngine(qmodel, max_batch=8, max_seq=256)
        rid = eng.submit([1, 2, 3], max_new_tokens=16)
        while eng.pending():
            for rid, tok in eng.step():
                ...
        tokens = eng.result(rid)

    ``last_logits[s]`` holds the logits that gave slot ``s`` its newest
    token (its prompt pass, then each decode step while it is active)."""

    def __init__(self, model: QuantizedLlama, max_batch: int = 8,
                 max_seq: int = 512,
                 prompt_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256),
                 eos_token: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None):
        cfg = model.cfg
        # the JAX batcher's rule is by class name (JAX serve/batching.py:80)
        if _is_hybrid(cfg) or type(cfg).__name__ in ("Qwen3NextConfig",
                                                     "MiniMaxConfig"):
            raise NotImplementedError(
                f"continuous batching for {type(cfg).__name__} needs "
                "per-slot conv/recurrent state buffers — use the "
                "single-batch engine (QuantizedLlama.generate); per-slot "
                "hybrid state is ROADMAP A item 5")
        self.m = model
        self.cfg = cfg
        self.B = max_batch
        self.T = max_seq
        self.buckets = tuple(sorted(prompt_buckets))
        self.eos = eos_token
        self.sampling = sampling
        dev = model.device
        self._gen = None
        if sampling is not None and not sampling.is_greedy:
            self._gen = torch.Generator(device=dev).manual_seed(sampling.seed)
        self._mla = deepseek.is_mla(cfg)
        if self._mla:
            kshape = (cfg.num_layers, self.B, self.T, 1, cfg.kv_lora_rank)
            vshape = (cfg.num_layers, self.B, self.T, 1,
                      cfg.qk_rope_head_dim)
        else:
            kshape = vshape = (cfg.num_layers, self.B, self.T,
                               cfg.num_kv_heads, cfg.hd)
        self.cache = _BatchCache(
            k=torch.zeros(kshape, dtype=cfg.dtype, device=dev),
            v=torch.zeros(vshape, dtype=cfg.dtype, device=dev),
            lengths=torch.zeros((self.B,), dtype=torch.int32, device=dev),
            last_token=torch.zeros((self.B,), dtype=torch.int32, device=dev))
        self.last_logits = torch.zeros((self.B, cfg.vocab_size),
                                       dtype=cfg.dtype, device=dev)
        self._active = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        self._toks = torch.zeros((self.B,), dtype=torch.int32, device=dev)
        self._decode = _StepReplay(self._decode_impl, dev, self._gen)
        self._free = list(range(self.B))
        self._slot_req: Dict[int, Request] = {}
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0

    # ------------------------------------------------------------- device
    @torch.no_grad()
    def _prefill_impl(self, tokens: torch.Tensor, true_len: int,
                      slot: int) -> int:
        """Run one prompt (1, bucket), insert its KV at ``slot`` and return
        the token sampled from the last real position's logits."""
        m, cfg = self.m, self.cfg
        bucket = tokens.shape[1]
        x = llama.embed_fwd(m.params, tokens, cfg)
        tables = rope_pair(cfg, bucket, device=x.device)
        for i in range(cfg.num_layers):
            cos, sin = tables[llama.layer_is_sliding(cfg, i)]
            lf = _make_linear_fn(m.packed, m.packed_kinds, i)
            if self._mla:
                x, k_new, v_new = deepseek.block_with_cache(
                    m.params["blocks"][i], x, cos, sin, cfg, None, None, lf,
                    m.moe_capacity_factor)
                k_new = k_new[:, :, None, :]        # (1, bucket, 1, r)
            else:
                x, k_new, v_new = _block_with_cache(
                    m.params["blocks"][i], x, cos, sin, cfg, None, None, lf,
                    m.packed, m.packed_kinds, i, m.fused_splits,
                    m.moe_capacity_factor)
            self.cache.k[i, slot, :bucket] = k_new[0].to(cfg.dtype)
            self.cache.v[i, slot, :bucket] = v_new[0].to(cfg.dtype)
        h_last = x[:, true_len - 1:true_len]
        logits = _final_fwd_packed(m.params, m.packed, m.packed_kinds,
                                   h_last, cfg)[:, 0]
        tok = sample_token(logits, self._gen, self.sampling)
        self.cache.lengths[slot] = true_len
        self.cache.last_token[slot] = tok[0]
        self.last_logits[slot] = logits[0]
        return int(tok[0])

    def _decode_impl(self) -> None:
        """One decode step for every slot over the static buffers; the
        inactive slots' lengths and last tokens stay as they are."""
        c = self.cache
        logits = decode_core(self.cfg)(
            self.m.params, self.m.packed, self.m.packed_kinds,
            self.m.fused_splits, c.last_token, c.k, c.v, c.lengths,
            cfg=self.cfg, kv_quant=None,
            moe_capacity_factor=self.m.moe_capacity_factor)
        toks = sample_token(logits, self._gen, self.sampling)
        act = self._active
        self._toks.copy_(toks)
        self.last_logits.copy_(torch.where(act[:, None], logits,
                                           self.last_logits))
        c.lengths.add_(act.to(torch.int32))
        c.last_token.copy_(torch.where(act, toks, c.last_token))

    # --------------------------------------------------------- scheduling
    def submit(self, prompt, max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(map(int, prompt)),
                      max_new_tokens=max_new_tokens)
        self._requests[rid] = req
        if not self._free:
            raise RuntimeError("no free slots (increase max_batch)")
        n = len(req.prompt)
        bucket = next((b for b in self.buckets if b >= n), None)
        # positions written: the bucket at prefill, then one a step up to
        # n + max_new_tokens - 1 (the slot's write once it has finished)
        if bucket is None or max(bucket, n + max_new_tokens) > self.T:
            raise ValueError(
                f"prompt of {n} tokens with {max_new_tokens} new does not "
                f"fit: buckets {self.buckets}, max_seq {self.T}")
        slot = self._free.pop(0)
        req.slot = slot
        self._slot_req[slot] = req
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n] = torch.as_tensor(req.prompt)
        req.generated.append(self._prefill_impl(
            tokens.to(self.m.device), n, slot))
        self._maybe_finish(req)
        return rid

    def _maybe_finish(self, req: Request) -> None:
        if req.done:
            return
        if (len(req.generated) >= req.max_new_tokens
                or (self.eos is not None and req.generated
                    and req.generated[-1] == self.eos)):
            req.done = True
            self._free.append(req.slot)
            del self._slot_req[req.slot]
            req.slot = None

    def pending(self) -> bool:
        return bool(self._slot_req)

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One decode step; returns [(rid, new_token)] for active slots."""
        if not self._slot_req:
            return []
        active = torch.zeros((self.B,), dtype=torch.bool)
        active[list(self._slot_req)] = True
        self._active.copy_(active)
        self._decode.run(1)
        toks = self._toks.tolist()
        out = []
        for slot, req in list(self._slot_req.items()):
            t = toks[slot]
            req.generated.append(t)
            out.append((req.rid, t))
            self._maybe_finish(req)
        return out

    def result(self, rid: int) -> List[int]:
        return self._requests[rid].generated
