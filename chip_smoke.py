#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autoround_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 is
the target).  It needs no arguments and no network, and imports neither
JAX nor the JAX package.  Phases, each of which fails the run on error:

1. build   — compile the CUDA sources of ``autoround_tpu_torch/csrc`` (one
             nvcc per source, in parallel); print the seconds, the
             compiler's register / spill / warning lines by kernel, and the
             flash forward's, the backward pair's (dQ, dK/dV at D = 128
             and 256), the nine GEMM bodies', the seven A16 GEMVs' and
             the two int8 GEMVs' (per M tier, with their plans at the main
             path's shapes), the
             int8-QK attention's and its key pre-pass's, and the decode
             split and combine kernels' registers, spill bytes, dynamic
             shared memory and blocks per SM.
2. kernels — run each of the fourteen kernels (flash forward, flash
             backward dQ and dK/dV, W4A16 matmul, grouped W4A16 matmul, asym
             W4A16 matmul, int8-KV decode attention, W4A8, W8A8, W8A16, W2A16,
             FP8 and MXFP4 / NVFP4 matmul, int8-QK attention) at the
             main paths' shapes (flash also at D = 256; W4A16 and asym
             also at g = 16; decode
             also at head dims 64 and 256 and G = 7; int8-QK at row 1's
             shapes and at S = T = 2048, beside row 1's time in the same
             call) against its plain PyTorch version on the
             card (bf16), check the stated tolerance (and, for the
             backward pair, that two launches give the same bits), and
             time kernel, plain version and one library call (a yardstick
             the port never calls) with CUDA events, the L2 cache flushed
             before every timed launch (median of several runs), beside
             the least time the card could take and the achieved rate.
             The decode and int8 kernels (split + combine, quantize_rows +
             product), the backward pair (each kernel, and the whole
             ``flash_attention_bwd``: delta + dQ + dK/dV, against SDPA's
             backward), the A16 GEMV at M = 8 (C = 8 grouped), the
             int8-QK attention (beside row 1 and SDPA) and their
             library calls also get ``device_ms``: the kernels' own time
             by torch.profiler.  The int8 kinds also
             check ``quantize_rows`` (codes and scales bit-equal, its own
             device time at M = 1, 8, 32) and say whether the fp32 result
             before the cast is bit-equal (it must be for W8A8, and for
             W4A8 in the GEMM body and where the GEMV's plan splits no
             K); the int8 GEMV runs at M = 1, 8 and 32, with the A16 GEMV
             on the same packed words beside W4A8 at M = 8.
3. rtn     — the RTN → serve path at the full width of ``llama3-8b``
             (random weights from a seeded generator, all 32 layers):
             ``AutoRound(scheme="W4A16", iters=0, quant_lm_head=True)`` on
             8 x 512 calibration ids → ``QuantizedLlama.from_quantize_
             result(max_seq=1024, kv_quant="int8")`` → ``generate`` for 8
             prompts of 512 tokens, 32 new tokens.  Kernel launch counts
             are zeroed just before and read just after; each must be > 0.
             Then prefill and decode steps are timed, and a 2-layer copy of
             the same engine runs once on the card (kernels) and once on
             the CPU (plain versions): step-1 logits must agree within the
             stated tolerance and greedy tokens must match.
             Every serving path below (and this one) then runs
             ``generate_scan`` on the same engine and prompts: its tokens
             must equal ``generate``'s and its launches ``generate``'s
             (the loops' counts), and its replayed step ms prints beside
             the eager step ms of the same call.
   scan    — on this engine (32 layers, int8 KV, ``max_seq`` 1024), 512-
             token prompts at batch 1, 8 and 32 (``bench.py``'s batch):
             ``generate_scan`` against ``generate``, the capture ms alone,
             the median replayed step ms (CUDA events between replays),
             tok/s, the step's bound, the busy share (torch.profiler's
             kernel time over replays against the unprofiled step) and the
             step's top kernels beside the eager step; at batch 8 a second
             call with new prompts must replay without a recapture, and
             sampled decoding (temperature 0.7, top-p 0.95) must give
             ``generate``'s tokens.  The same at batch 1 and 8 for W4A8,
             W8A8 and llama3.2-1b, and at batch 8 for mixtral-8x7b.
   fp8 kv  — the first 4 layers of this engine with ``kv_quant="fp8"``
             (e4m3 cache): ``generate_scan`` equal to ``generate``, and a
             2-layer copy on the card against the CPU (prefill and first
             decode step logits within the copy limit).
   batching — ``ContinuousBatchingEngine`` over this engine (max_batch 8,
             max_seq 1024): 12 requests, prompts of 16–256 tokens over the
             buckets, 8–32 new tokens, late joins and slot reuse; each
             request's prompt-pass and first decode step logits within
             the copy limit of the same prompt alone at batch 1; prints
             the share of greedy tokens equal to batch 1's and the
             replayed step ms at 8 active slots.
4. grads   — one full-width block, one batch of 8 x 512: the gradients of
             the tuning loss w.r.t. ``v``, ``min_scale``, ``max_scale``
             through the flash kernels (forward and backward) against the
             same through the plain attention under autograd, on the card;
             then the time of a tuning step, its bound and its profile.
5. tune    — the SignRound → serve path at the full width of
             ``llama3-8b``: ``AutoRound(scheme="W4A16", iters=20,
             batch_size=8, quant_lm_head=True)`` on 16 x 512 calibration
             ids, every block and the lm_head tuned → the same engine →
             ``generate``.  All five kernels' counts are zeroed just
             before and read just after; each must equal what the loop
             implies.  Every loss must be finite and no block's best loss
             above its first.
6. moe     — the MoE path at the full width of ``mixtral-8x7b`` (8 experts
             of 4096 x 14336, top-2; random weights from a seeded
             generator; ``--moe-layers`` of the 32 blocks, because 32
             blocks in bf16 are more than the card holds): RTN W4A16 g128
             → ``from_quantize_result`` (experts stacked) → ``generate``
             for 8 prompts of 512 tokens, 32 new tokens, int8 KV,
             dense-then-mask routing; launch counts must equal what the
             loops imply (grouped kernel: 3 per block per forward).  Then
             the same engine with ``moe_capacity_factor = E / top_k``
             (nothing can drop): its prefill logits must agree with the
             default route's.  Then timings, a profile, and a 2-layer copy
             run once through the kernels and once through their plain
             versions, both on the card.
7. moe tune — one tuning step of one full-width Mixtral block timed and
             profiled, then SignRound (``iters=20``) on ``--moe-tune-layers``
             full-width blocks (dense-then-mask: every expert sees every
             token) → the same engine → ``generate``; every tuned block's
             best loss must be below its first.
8. asym    — ``llama3-8b`` width, ``--asym-layers`` layers, int4 asym g128
             RTN → the ``w4a16_asym`` engine → ``generate``; launch counts
             checked; 2-layer copy against the plain versions.
9. a8      — the int8 serving kinds at ``llama3-8b`` width, each RTN
             (``quant_lm_head=True``, 8 x 512 calibration ids) → engine →
             ``generate`` (8 x 512 prompts, 32 new tokens, int8 KV):
             ``W4A8`` (``--a8-layers``), ``W8A8`` (``--w8a8-layers``),
             ``W8A16`` (``--w8a16-layers``); every packed kind checked,
             launch counts equal to what the loops imply, the W4A16
             kernels at 0, timings with bounds at the int8 peak, 2-layer
             copy against the plain versions.
10. a8 modes — a W4A16 result (``--a8-modes-layers``) served with
             ``serve_a8=True`` (kinds ``w4a8`` on the same packed words)
             and with ``prefill_a8=True`` (W4A8 kernel in the prompt pass,
             W4A16 kernel in decode): prefill logits against exact-A16
             serving.
11. a8 tune — SignRound (``iters=20``) with ``W4A8`` on ``--a8-tune-layers``
             blocks, once with dynamic activations and once with static
             int8 activations and act-scale tuning → serve.
12. float  — the float and 2-bit serving kinds at ``llama3-8b`` width, each
             RTN (``quant_lm_head=True``; the scheme's activation
             quantization in calibration) → engine (weight-only, bf16
             activations) → ``generate``: ``FP8_STATIC`` (kind ``fp8``,
             ``--fp8-layers``), ``MXFP4`` (``mxfp4_g32``,
             ``--mxfp4-layers``), ``NVFP4`` (``mxfp4_g16``,
             ``--nvfp4-layers``), ``W2A16`` (``w2a16``, ``--w2-layers``);
             launch counts, timings, 2-layer copy against the plain
             versions.
13. mx tune — SignRound (``iters=20``) with ``MXFP4`` (MX activations in the
             loss) on ``--mx-tune-layers`` blocks → serve, timed, with a
             2-layer copy against the plain versions.
             The MXFP4 path's peak memory (quantize, pack, generate) must
             not pass the FP8 path's.
14. llama3.2-1b — full width and depth (16 layers, head dim 64, tied
             embeddings): RTN W4A16 g128 → engine → ``generate`` with the
             int8 KV cache, every decode step through the decode kernel at
             hd 64 (launches = layers x steps); then the same at g = 16,
             where no layer may serve dense; timings and a 2-layer copy
             against the plain versions for each.
15. sage    — the int8-QK op through its entry point for the prefill
             attention of ``--sage-layers`` llama3-8b layers; launch count
             checked, each output within 5e-3 mean |diff| of the flash
             kernel (the op rides no engine path, as in the JAX package).
16. family  — the Llama-family flags at full width (random weights, every
             norm gain and bias moved off its initial value; W4A16 g128,
             lm_head quantized, int8 KV, 32 new tokens, greedy):
             ``qwen2.5-7b`` RTN at all 28 layers (8 x 512 prompts: q/k/v
             biases, G = 7 through flash and decode; timed, and its
             replayed step measured at batch 1 and 8), ``qwen3-4b``
             SignRound (``iters=20``, 16 x 512 ids) on 2 blocks (qk-norm
             inside the tuning loss through flash forward and backward),
             ``gemma2-2b`` RTN at 4 layers (8 x 512: attention and final
             softcaps, GeGLU, sandwich norms, hd 256) and ``gemma3-12b``
             RTN at 6 layers, five sliding and one global (2 x 1280
             prompts, ``max_seq`` 2048: the 1024 window bites at prefill
             and at every decode step; local and global rope).  Each
             checks its launch counts against its loops, runs the 2-layer
             copy against the plain versions on the card and
             ``generate_scan`` against ``generate``.
17. report — the card's name and power limit (nvidia-smi), a JSON line of
             per-kernel numbers, and last the line
             {"ok": true, "device": {"platform": "gpu", ...}}.

``--rtn-layers``, ``--tune-layers``, ``--moe-layers``, ``--moe-tune-layers``,
``--asym-layers``, ``--a8-layers``, ``--w8a8-layers``, ``--w8a16-layers``,
``--a8-modes-layers``, ``--a8-tune-layers``, ``--fp8-layers``,
``--mxfp4-layers``, ``--nvfp4-layers``, ``--w2-layers``,
``--mx-tune-layers``, ``--llama1b-layers``, ``--sage-layers``,
``--qwen25-layers``, ``--qwen3-tune-layers``, ``--gemma2-layers`` and
``--gemma3-layers`` cut the depth of the paths for a quicker run.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import logging
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s,
# int8 OP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 1513e12),
         "H100": (3.35e12, 989e12, 1979e12)}

# Kernel vs plain version on the card, bf16 out on both sides.  Error
# measure: in each output row (last axis) max |kernel - plain| over the RMS
# of the plain row, worst row counted.  Rows are held to their own scale
# because attention rows differ in size: row 0 of a causal output is one
# value row, rows that average hundreds of keys are ~10x smaller.  Each
# limit is about 3x the worst row error measured on an H100 (flash 0.034,
# the same as SDPA's against the plain version; W4A16 0.037; decode
# attention 0.0072; PERF.md).
ROW_TOL = {"flash_attention": 0.1, "w4a16_matmul": 0.1,
           # bf16 out against the plain version's bf16: W8A8 and the W4A8
           # GEMM are bit-equal in fp32 before the cast (row error 0), as is
           # the W4A8 GEMV where its plan splits no K; split over a cluster
           # it adds the ranks' sums in rank order (fp32 row error 2.1e-6),
           # which moves a few outputs by one bf16 ulp: 0.0099 of the row's
           # RMS at worst (measured, down_proj M = 32); W8A16 rounds
           # float(wi) * s to bf16 as the plain version
           # does in both bodies (the GEMV: worst row 0.0124 at M = 8;
           # the GEMM per channel at K = 14336, M = 4096: 0.0503, the sums'
           # order over 14336 products)
           "w4a8_matmul": 0.06, "w8a8_matmul": 0.06, "w8a16_matmul": 0.15,
           "decode_attention": 0.025,
           # the tile bodies of w4a16_matmul with an expert grid axis / a
           # zero point: the same limit
           "w4a16_matmul_grouped": 0.1, "w4a16_asym_matmul": 0.1,
           # backward pair vs flash_attention_bwd_plain: measured worst rows
           # dQ 0.027, dK / dV 0.023 (S = T = 512 and S = 256, T = 512)
           "flash_attention_bwd_dq": 0.07, "flash_attention_bwd_dkv": 0.07,
           # the W4A16 bodies in their INT2 and E2M1 formats (measured 0.035
           # and 0.036); FP8 applies the channel scale to the fp32 sum where
           # the plain version rounds e4m3 * s to bf16 first (measured 0.056
           # in the GEMM, 0.029 in the GEMV at M = 8)
           "w2a16_matmul": 0.1, "mxfp4_matmul": 0.1, "fp8_matmul": 0.15,
           # int8-QK attention against its plain version on the same mean
           # key: the same codes, scores and softmax on both sides up to
           # the order of fp32 sums; P rounded to bf16 as in flash
           "sage_attention": 0.1}
# int8-QK attention against the bf16 flash kernel, mean |diff| over all
# outputs: the JAX test's limit for the int8 path against the fp path (the
# JAX docstring measured 4.7e-4 on the TPU)
SAGE_FLASH_MAE = 5e-3
# A gradient row may be zero in exact arithmetic (row 0 of dQ when S = T: one
# visible key, P = 1, dS = 0), so rows smaller than this share of the whole
# tensor's RMS are held to that scale instead of their own.
BWD_ROW_FLOOR = 0.01
LSE_ATOL = 1e-5          # lse is fp32 on both sides (~1e-6 measured)
# fp32 result of W4A8 before the cast, same row measure (measured 2.1e-6)
W4A8_F32_ROW_TOL = 1e-5
# a8 serving modes: prefill logits against exact-A16 serving, max |diff| over
# max |exact| (the JAX package's own measure; its test's limit of 0.06 is for
# fp32 at hidden 1024).  At llama3-8b width in bf16 with random weights the
# int8 activation noise of 2 blocks and their 8 products measures 0.064
# (serve_a8) and 0.066 (prefill_a8) on an H100; limit about 3x.  A product
# that computed something else would give about 1.4.
A8_MODE_TOL = 0.2
# the library yardstick must compute the same function: a wrong causal
# anchor (top-left instead of bottom-right) gives row errors of order 10
LIB_ROW_TOL = 0.1
# step-1 logits of the 2-layer engine copy, kernels on the card vs plain
# versions (on the CPU, or on the card for the MoE and asym paths; bf16
# activations through 2 blocks and the lm_head); same row measure, about
# 3x the measured error (0.049, llama3-8b W4A16)
COPY_ROW_TOL = 0.15
# the same for a MoE engine: besides the rounding above, a top-2 near-tie of
# the router (random weights: near-uniform probabilities) may fall the other
# way under the kernels' and the plain versions' different bf16 roundings,
# and such a token's row moves as a whole; measured 0.085 and 0.107 with two
# sets of weights on an H100, limit about 3x
MOE_COPY_ROW_TOL = 0.3


def log(*a):
    print(*a, flush=True)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    log(f"unknown card {name!r}: bounds use the H100 SXM peaks")
    return PEAKS["H100"]


class Timer:
    """CUDA-event timing of single launches, L2 flushed before each; and
    device time by the profiler."""

    def __init__(self, reps: int = 7):
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()                                   # warm-up
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def device(self, fn, reps: int = 20):
        """(ms, how): the device time of one call of `fn`, the kernels it
        launches summed (split + combine, quantize_rows + GEMM, a library
        call's own kernels), from torch.profiler's CUDA activity over `reps`
        calls; `how` names the source and each kernel's share.  Before each
        call the L2 is flushed by reading 128 MB (the max of the flush
        buffer, left out of the sum): it holds no line of the call's inputs
        and no dirty line, as after a decode step's weight reads (the event
        timer's flush writes, and the write-back of its dirty lines lands
        in the kernels after it).  If three profiles see no kernel,
        CUDA events around `reps` back-to-back calls over the count (then
        the host's time per call where the host is the slower)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(3):          # a profile now and then sees no kernel
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.amax()
                    fn()
                torch.cuda.synchronize()
            parts = {name: ms / reps
                     for name, (ms, _) in _kernel_times(prof).items()
                     if "MaxNanFunctor<unsigned char>" not in name
                     and not name.startswith(("Memset", "Memcpy"))}
            total = sum(parts.values())
            if total > 0:
                return total, "profiler: " + " + ".join(
                    f"{_short(name)} {ms:.4f}" for name, ms in parts.items())
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps, "events"


def row_err(out, ref, floor: float = 0.0):
    """(max |out - ref|, worst row's max |out - ref| over its ref RMS).
    With ``floor``, a row's RMS counts as at least that share of the whole
    tensor's RMS."""
    d = (out.float() - ref.float()).abs()
    ref2 = ref.float().pow(2)
    rms = ref2.mean(-1).sqrt().clamp_min(1e-30)
    if floor:
        rms = rms.clamp_min(floor * ref2.mean().sqrt().item())
    return d.max().item(), (d.amax(-1) / rms).max().item()


def tflops(n_ops, ms, unit="TFLOP/s") -> str:
    """Achieved rate of `n_ops` operations in `ms` milliseconds."""
    return f"achieved={n_ops / ms / 1e9:.1f} {unit}"


def device_pair(timer, fn, lib):
    """(device ms of `fn`, of its library call `lib`, the text the kernel
    lines print for them)."""
    dev_ms, how = timer.device(fn)
    lib_dev_ms, _ = timer.device(lib)
    return dev_ms, lib_dev_ms, (f" device_ms={dev_ms:.4f} ({how}) "
                                f"library_device_ms={lib_dev_ms:.4f}")


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def kernel_phase(timer, bw, flops_peak):
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_plain,
        flash_attention_plain)
    from autoround_tpu_torch.ops.qmatmul import (
        pack_w4, unpack_w4, w4a16_matmul, w4a16_matmul_grouped,
        w4a16_matmul_grouped_plain, w4a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_ext import (w4a16_asym_matmul,
                                                     w4a16_asym_matmul_plain)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    bwd_shapes = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    # K1 flash attention, forward then backward: calibration / tuning /
    # prefill shapes, and D = 256 (Gemma's heads)
    for (B, H, Hkv, S, T, D, rep_row) in [(8, 32, 8, 512, 512, 128, True),
                                          (8, 32, 8, 256, 512, 128, False),
                                          (8, 32, 8, 512, 512, 256, False)]:
        q = torch.randn(B, H, S, D, generator=g, device=dev).bfloat16()
        k = torch.randn(B, Hkv, T, D, generator=g, device=dev).bfloat16()
        v = torch.randn(B, Hkv, T, D, generator=g, device=dev).bfloat16()
        out, lse = flash_attention(q, k, v, True)
        pout, plse = flash_attention_plain(q, k, v, True)
        torch.cuda.synchronize()
        err, rel = row_err(out, pout)
        lerr = (lse - plse).abs().max().item()
        tol = ROW_TOL["flash_attention"]
        check(rel <= tol and lerr <= LSE_ATOL,
              f"flash S={S} T={T}: row err {rel} lse err {lerr}")

        # SDPA's is_causal is top-left: bottom-right needs a bias
        def lib_fwd(q_, k_, v_):
            if S == T:
                return F.scaled_dot_product_attention(
                    q_, k_, v_, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=causal_lower_right(S, T),
                enable_gqa=True)

        def lib():
            return lib_fwd(q, k, v)
        _, lib_rel = row_err(lib(), pout)
        check(lib_rel <= LIB_ROW_TOL,
              f"flash S={S} T={T}: library call computes another function "
              f"(row err {lib_rel})")
        ms = timer(lambda: flash_attention(q, k, v, True))
        plain_ms = timer(lambda: flash_attention_plain(q, k, v, True))
        lib_ms = timer(lib)
        valid = sum(min(T, i + T - S + 1) for i in range(S))
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
            + 4 * lse.numel()
        n_ops = 4 * B * H * valid * D
        b_ms, b_by = bound(nbytes, n_ops)
        shape = f"B={B} H={H} Hkv={Hkv} S={S} T={T} D={D} causal"
        log(f"kernel flash_attention [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) lse_err={lerr:.3g} "
            f"(tol {LSE_ATOL}) library_row_err={lib_rel:.3g} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(n_ops, ms)} library {tflops(n_ops, lib_ms)}")
        if rep_row:
            rows["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="autoround_tpu_torch/csrc/flash_attention.cu",
                replaces="autoround_tpu/ops/flash_attention.py:328",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del pout, plse

        # the backward pair on the same tensors: dQ and dK/dV against the
        # plain version, bit-equal run to run; library = SDPA's backward
        do = torch.randn(B, H, S, D, generator=g, device=dev).bfloat16()
        delta = (out.float() * do.float()).sum(-1)
        got = {"flash_attention_bwd_dq":
               (flash_attention_bwd_dq(q, k, v, do, lse, delta, True),),
               "flash_attention_bwd_dkv":
               flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)}
        again = (flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
                 *flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))
        torch.cuda.synchronize()
        first = got["flash_attention_bwd_dq"] + got["flash_attention_bwd_dkv"]
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"flash backward S={S} T={T}: two launches differ")
        pdq, pdk, pdv = flash_attention_bwd_plain(q, k, v, out, lse, do, True)
        plain = {"flash_attention_bwd_dq": (pdq,),
                 "flash_attention_bwd_dkv": (pdk, pdv)}
        ql = q.clone().requires_grad_(True)
        kl = k.clone().requires_grad_(True)
        vl = v.clone().requires_grad_(True)
        lib_out = lib_fwd(ql, kl, vl)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                       retain_graph=True)
        lib_rel = max(row_err(a, b, BWD_ROW_FLOOR)[1]
                      for a, b in zip(lib_bwd(), (pdq, pdk, pdv)))
        check(lib_rel <= LIB_ROW_TOL,
              f"flash backward S={S} T={T}: library call computes another "
              f"function (row err {lib_rel})")
        lib_ms = timer(lib_bwd)
        lib_dev_ms, lib_how = timer.device(lib_bwd)
        plain_ms = timer(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, True))
        # the whole backward as the autograd route runs it: delta, dQ, dK/dV
        bwd_dev_ms, bwd_how = timer.device(lambda: flash_attention_bwd(
            q, k, v, out, lse, do, True))
        n_bwd = 2 * 7 * B * H * valid * D
        log(f"kernel flash_attention_bwd [{shape}] (delta + dQ + dK/dV) "
            f"device_ms={bwd_dev_ms:.4f} ({bwd_how}) "
            f"library_device_ms(SDPA backward)={lib_dev_ms:.4f} ({lib_how}) "
            f"over_library={bwd_dev_ms / lib_dev_ms:.3f} "
            f"{tflops(n_bwd, bwd_dev_ms)} (7 products) library "
            f"{tflops(2 * 5 * B * H * valid * D, lib_dev_ms)} (5 products)")
        runs = {"flash_attention_bwd_dq": lambda: flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, True),
                "flash_attention_bwd_dkv": lambda: flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, True)}
        in_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4 * (lse.numel() + delta.numel())
        work = {"flash_attention_bwd_dq": (in_bytes + 2 * q.numel(), 3),
                "flash_attention_bwd_dkv":
                (in_bytes + 2 * (k.numel() + v.numel()), 4)}
        for name, line in (("flash_attention_bwd_dq", 262),
                           ("flash_attention_bwd_dkv", 286)):
            errs = [row_err(a, b, BWD_ROW_FLOOR)
                    for a, b in zip(got[name], plain[name])]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            tol = ROW_TOL[name]
            check(rel <= tol, f"{name} S={S} T={T}: row err {rel}")
            ms = timer(runs[name])
            dev_ms, how = timer.device(runs[name])
            nbytes, n_prod = work[name]
            n_ops = 2 * n_prod * B * H * valid * D
            b_ms, b_by = bound(nbytes, n_ops)
            log(f"kernel {name} [{shape}] max_abs_err={err:.3g} "
                f"row_err={rel:.3g} (tol {tol}, row floor {BWD_ROW_FLOOR}) "
                f"run_to_run=equal library_row_err={lib_rel:.3g} "
                f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} ({how}) "
                f"plain_ms(dq+dk+dv)={plain_ms:.4f} "
                f"library_ms(dq+dk+dv)={lib_ms:.4f} "
                f"library_device_ms(dq+dk+dv)={lib_dev_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) device "
                f"{tflops(n_ops, dev_ms)}")
            bwd_shapes[name].append(dict(
                shape=shape, max_abs_err=err, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                bwd_device_ms=bwd_dev_ms))
            if rep_row:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="autoround_tpu_torch/csrc/flash_attention_bwd.cu",
                    replaces=f"autoround_tpu/ops/flash_attention.py:{line}",
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms,
                    bwd_device_ms=bwd_dev_ms)
        del q, k, v, out, lse, do, delta, got, again, first, plain, pdq, pdk
        del pdv, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    # every shape of the backward pair in its row (the row's own first)
    for name, shapes in bwd_shapes.items():
        rows[name]["shapes"] = shapes

    # K2 W4A16: fused qkv, down_proj, lm_head at decode and prefill M, at
    # g = 128 and g = 16 (the GEMV reads a second scale half way through a
    # 32-column chunk)
    for (M, O, K, name, G) in [(M, O, K, name, G) for G in (128, 16)
                               for (M, O, K, name) in [
                                   (8, 6144, 4096, "qkv"),
                                   (8, 4096, 14336, "down_proj"),
                                   (8, 128256, 4096, "lm_head"),
                                   (4096, 6144, 4096, "qkv"),
                                   (4096, 4096, 14336, "down_proj"),
                                   (4096, 128256, 4096, "lm_head")]]:
        codes = torch.randint(0, 16, (O, K), generator=g, device=dev)
        sc = (torch.rand(O, K // G, generator=g, device=dev) - 0.5) * 0.02
        qw = pack_w4(codes)
        del codes
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        y = w4a16_matmul(x, qw, sc, G)
        yp = w4a16_matmul_plain(x, qw, sc, G)
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del yp
        tol = ROW_TOL["w4a16_matmul"]
        check(rel <= tol, f"w4a16 M={M} O={O} K={K} g={G}: row err {rel}")
        ms = timer(lambda: w4a16_matmul(x, qw, sc, G))
        plain_ms = timer(lambda: w4a16_matmul_plain(x, qw, sc, G))
        w_bf16 = ((unpack_w4(qw) - 8).float()
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_txt = ""
        if M == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, lambda: w4a16_matmul(x, qw, sc, G),
                lambda: torch.matmul(x, w_bf16.T))
        del w_bf16
        nbytes = 2 * M * K + O * K // 2 + 4 * sc.numel() + 2 * M * O
        b_ms, b_by = bound(nbytes, 2 * M * O * K)
        shape = f"{name} M={M} O={O} K={K} g={G}"
        log(f"kernel w4a16_matmul [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * M * O * K, ms)} library "
            f"{tflops(2 * M * O * K, lib_ms)}")
        if M == 8 and name == "qkv" and G == 128:
            rows["w4a16_matmul"] = dict(
                name="w4a16_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w4a16_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul.py:168",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, x, y
        torch.cuda.empty_cache()

    # K4 grouped W4A16 (mixtral-8x7b experts, E = 8): decode C = 8 and
    # prefill C = 4096 for w1/w3 (K, O) = (4096, 14336), where dense-then-
    # mask routing hands all experts one shared slab (expert stride 0), and
    # for w2 (14336, 4096) on contiguous slabs; one ragged case (C = 5, O
    # not a multiple of any tile, the first C rows of a taller buffer, as
    # capacity dispatch hands it over)
    E = 8
    for (C, K, O, name, layout) in [
            (8, 4096, 14336, "w1", "shared"),
            (8, 14336, 4096, "w2", "contiguous"),
            (4096, 4096, 14336, "w1", "shared"),
            (4096, 14336, 4096, "w2", "contiguous"),
            (5, 4096, 1000, "ragged", "slice")]:
        qw = torch.stack([pack_w4(torch.randint(
            0, 16, (O, K), generator=g, device=dev)) for _ in range(E)])
        sc = (torch.rand(E, O, K // 128, generator=g, device=dev) - 0.5) * 0.02
        if layout == "shared":
            x = torch.randn(C, K, generator=g, device=dev).bfloat16() \
                .expand(E, C, K)
        elif layout == "slice":
            x = torch.randn(E, C + 1, K, generator=g,
                            device=dev).bfloat16()[:, :C]
        else:
            x = torch.randn(E, C, K, generator=g, device=dev).bfloat16()
        y = w4a16_matmul_grouped(x, qw, sc, 128)
        yp = w4a16_matmul_grouped_plain(x, qw, sc, 128)
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del yp
        tol = ROW_TOL["w4a16_matmul_grouped"]
        check(rel <= tol, f"grouped C={C} O={O} K={K}: row err {rel}")
        ms = timer(lambda: w4a16_matmul_grouped(x, qw, sc, 128))
        plain_ms = timer(lambda: w4a16_matmul_grouped_plain(x, qw, sc, 128))
        w_bf16 = torch.stack([
            ((unpack_w4(qw[e]) - 8).float()
             * sc[e].repeat_interleave(128, dim=1)).bfloat16()
            for e in range(E)])
        lib_ms = timer(lambda: torch.bmm(x, w_bf16.transpose(1, 2)))
        dev_txt = ""
        if C == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, lambda: w4a16_matmul_grouped(x, qw, sc, 128),
                lambda: torch.bmm(x, w_bf16.transpose(1, 2)))
        del w_bf16
        x_slabs = 1 if layout == "shared" else E
        nbytes = (2 * x_slabs * C * K + E * O * K // 2 + 4 * sc.numel()
                  + 2 * E * C * O)
        b_ms, b_by = bound(nbytes, 2 * E * C * O * K)
        shape = f"{name} E={E} C={C} O={O} K={K} g=128 x {layout}"
        log(f"kernel w4a16_matmul_grouped [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * E * C * O * K, ms)} library "
            f"{tflops(2 * E * C * O * K, lib_ms)}")
        if C == 8 and name == "w1":
            rows["w4a16_matmul_grouped"] = dict(
                name="w4a16_matmul_grouped", route="cuda",
                source="autoround_tpu_torch/csrc/w4a16_matmul_grouped.cu",
                replaces="autoround_tpu/ops/qmatmul.py:280",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, x, y
        torch.cuda.empty_cache()

    # K5 asym W4A16: the llama3-8b projections of K2, fractional zero
    # points, g = 128 and g = 16
    for (M, O, K, name, G) in [(M, O, K, name, G) for G in (128, 16)
                               for (M, O, K, name) in [
                                   (8, 6144, 4096, "qkv"),
                                   (8, 4096, 14336, "down_proj"),
                                   (8, 128256, 4096, "lm_head"),
                                   (4096, 6144, 4096, "qkv"),
                                   (4096, 4096, 14336, "down_proj"),
                                   (4096, 128256, 4096, "lm_head")]]:
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=g, device=dev))
        sc = torch.rand(O, K // G, generator=g, device=dev) * 0.01 + 0.002
        zp = torch.rand(O, K // G, generator=g, device=dev) * 15
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        y = w4a16_asym_matmul(x, qw, sc, zp, G)
        yp = w4a16_asym_matmul_plain(x, qw, sc, zp, G)
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del yp
        tol = ROW_TOL["w4a16_asym_matmul"]
        check(rel <= tol, f"asym M={M} O={O} K={K} g={G}: row err {rel}")
        ms = timer(lambda: w4a16_asym_matmul(x, qw, sc, zp, G))
        plain_ms = timer(lambda: w4a16_asym_matmul_plain(x, qw, sc, zp, G))
        w_bf16 = ((unpack_w4(qw).float() - zp.repeat_interleave(G, dim=1))
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_txt = ""
        if M == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, lambda: w4a16_asym_matmul(x, qw, sc, zp, G),
                lambda: torch.matmul(x, w_bf16.T))
        del w_bf16
        nbytes = 2 * M * K + O * K // 2 + 8 * sc.numel() + 2 * M * O
        b_ms, b_by = bound(nbytes, 2 * M * O * K)
        shape = f"{name} M={M} O={O} K={K} g={G} fractional zp"
        log(f"kernel w4a16_asym_matmul [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * M * O * K, ms)} library "
            f"{tflops(2 * M * O * K, lib_ms)}")
        if M == 8 and name == "qkv" and G == 128:
            rows["w4a16_asym_matmul"] = dict(
                name="w4a16_asym_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w4a16_asym_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul_ext.py:162",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, zp, x, y
        torch.cuda.empty_cache()

    return rows


def decode_kernel_phase(timer, bw, flops_peak):
    """Row 6, the int8-KV decode attention: B=8, T=1024; llama3-8b's heads
    (hd 128, G = 4), llama3.2-1b's (hd 64), hd 256 (Gemma) and G = 7
    (qwen2.5-7b's 28 / 4).  Library: SDPA on the dequantized bf16 cache up
    to pos, with the window as a boolean mask where there is one (no single
    call adds the sinks: that yardstick leaves them out and is checked
    against the plain version without sinks).  Event times include the
    wrapper's Python; device times (`device_ms`) are the kernels' own, split
    plus combine, and the comparison with SDPA and the bound is made on
    them."""
    import torch.nn.functional as F

    from autoround_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain, decode_splits)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    B, T = 8, 1024
    for (hd, nkv, G, cases) in [
            (128, 8, 4, [(511, None, False), (700, None, False),
                         (700, 256, True)]),
            (64, 8, 4, [(511, None, False), (700, 256, True)]),
            (256, 8, 4, [(511, None, False), (700, 256, True)]),
            (128, 4, 7, [(511, None, False)])]:
        nh = nkv * G
        q = torch.randn(B, nh, hd, generator=g, device=dev).bfloat16()
        kc = torch.randint(-127, 128, (B, T, nkv, hd), generator=g,
                           device=dev).to(torch.int8)
        vc = torch.randint(-127, 128, (B, T, nkv, hd), generator=g,
                           device=dev).to(torch.int8)
        ks = torch.rand(nkv, generator=g, device=dev) * 0.02 + 0.01
        vs = torch.rand(nkv, generator=g, device=dev) * 0.02 + 0.01
        sinks = torch.randn(nh, generator=g, device=dev)
        sm = hd ** -0.5
        for pos, window, use_sinks in cases:
            sk = sinks if use_sinks else None
            pv = torch.full((B,), pos, dtype=torch.int32, device=dev)
            o = decode_attention(q, kc, vc, pv, ks, vs, sm, window=window,
                                 sinks=sk)
            op = decode_attention_plain(q, kc, vc, pv, ks, vs, sm,
                                        window=window, sinks=sk)
            torch.cuda.synchronize()
            err, rel = row_err(o, op)
            tol = ROW_TOL["decode_attention"]
            check(rel <= tol, f"decode hd={hd} G={G} pos={pos}: row err "
                  f"{rel}")
            ms = timer(lambda: decode_attention(q, kc, vc, pv, ks, vs, sm,
                                                window=window, sinks=sk))
            plain_ms = timer(lambda: decode_attention_plain(
                q, kc, vc, pv, ks, vs, sm, window=window, sinks=sk))
            kd = (kc[:, :pos + 1].float() * ks.view(1, 1, nkv, 1)) \
                .bfloat16().transpose(1, 2).contiguous()
            vd = (vc[:, :pos + 1].float() * vs.view(1, 1, nkv, 1)) \
                .bfloat16().transpose(1, 2).contiguous()
            q4 = q[:, :, None]
            mask = None
            if window is not None:
                idx = torch.arange(pos + 1, device=dev)
                mask = (idx > pos - window)[None, None, None, :]

            def lib():
                return F.scaled_dot_product_attention(
                    q4, kd, vd, attn_mask=mask, scale=sm, enable_gqa=True)
            _, lib_rel = row_err(lib()[:, :, 0], decode_attention_plain(
                q, kc, vc, pv, ks, vs, sm, window=window))
            check(lib_rel <= LIB_ROW_TOL,
                  f"decode hd={hd} pos={pos}: library call computes another "
                  f"function (row err {lib_rel})")
            lib_ms = timer(lib)
            dev_ms, how = timer.device(lambda: decode_attention(
                q, kc, vc, pv, ks, vs, sm, window=window, sinks=sk))
            lib_dev_ms, _ = timer.device(lib)
            del kd, vd
            n_tok = min(pos + 1, window or pos + 1)
            nbytes = 2 * q.numel() * 2 + 2 * B * n_tok * nkv * hd + 8 * nkv
            b_ms, b_by = bound(nbytes, 4 * B * nh * n_tok * hd)
            shape = (f"B={B} T={T} nh={nh} nkv={nkv} hd={hd} pos={pos}"
                     + (f" window={window} sinks" if window else ""))
            log(f"kernel decode_attention [{shape} splits="
                f"{decode_splits(B, nkv, T)}] max_abs_err={err:.3g} "
                f"row_err={rel:.3g} (tol {tol}) library_row_err="
                f"{lib_rel:.3g}{' (no sinks)' if use_sinks else ''} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} device_ms={dev_ms:.4f} ({how}) "
                f"library_device_ms={lib_dev_ms:.4f} bound_ms={b_ms:.4f} "
                f"({b_by})")
            if hd == 128 and G == 4 and pos == 511:
                rows["decode_attention"] = dict(
                    name="decode_attention", route="cuda",
                    source="autoround_tpu_torch/csrc/decode_attention.cu",
                    replaces="autoround_tpu/ops/decode_attention.py:240",
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del q, kc, vc
        torch.cuda.empty_cache()
    return rows


def a8_gemv_info(src, M, K, O, g=128):
    """{registers, spill bytes, dynamic shared bytes, blocks per SM, rw,
    kc} of the int8 GEMV of `src` (``w8a8_matmul`` or ``w4a8_matmul``) at
    (M, K, O[, g]): its resources and its plan."""
    import ctypes

    from autoround_tpu_torch.ops import _build
    fn = getattr(_build.load(src), f"{src}_gemv_info")
    args = (M, K, O) if src == "w8a8_matmul" else (M, K, O, g)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 6)()
    _build.check(fn(*args, info), f"{src}_gemv_info")
    return list(info)


def a8_kernel_phase(timer, bw, flops_peak, int8_peak):
    """The int8 kinds at the llama3-8b projections: quantize_rows, W8A8,
    W4A8 (g = 128) and W8A16 (g = 128 and per channel) against their plain
    versions, plus two edge shapes; kernel, plain, library and bound times.
    Library: for W8A8 at M > 32 ``torch._int_mm`` on rows quantized
    beforehand plus the epilogue in torch ops; elsewhere ``torch.matmul``
    on the dequantized bf16 weight.  The decode shapes (the int8 GEMV) at
    M = 1, 8 and 32 with device times (W8A16 not at M = 1 and 32); at M =
    8 the A16 SYM4 GEMV (row 4) on the W4A8 case's packed words beside it,
    and ``quantize_rows`` alone at M = 1, 8 and 32."""
    from autoround_tpu_torch.ops.qmatmul import (pack_w4, unpack_w4,
                                                 w4a16_matmul)
    from autoround_tpu_torch.ops.qmatmul_ext import (w8a16_matmul,
                                                     w8a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_int8 import (
        quantize_rows, quantize_rows_plain, w4a8_matmul, w4a8_matmul_plain,
        w8a8_matmul, w8a8_matmul_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = {}

    def bound(nbytes, nops, peak):
        t_b, t_f = nbytes / bw * 1e3, nops / peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    def report(kernel, shape, err, rel, extra, ms, plain_ms, lib_ms, b_ms,
               b_by):
        tol = ROW_TOL[kernel]
        unit = "TFLOP/s" if kernel == "w8a16_matmul" else "TOP/s"
        log(f"kernel {kernel} [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}){extra} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) {tflops(2 * M * O * K, ms, unit)}")
        check(rel <= tol, f"{kernel} {shape}: row err {rel}")

    for (M, K) in [(1, 4096), (8, 4096), (32, 4096), (4096, 4096),
                   (1, 14336), (8, 14336), (32, 14336), (4096, 14336)]:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        x[0] = 0
        xi, xs = quantize_rows(x)
        pi, ps = quantize_rows_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(xi, pi) and torch.equal(xs, ps),
              f"quantize_rows M={M} K={K}: codes or scales differ from the "
              f"plain version")
        ms = timer(lambda: quantize_rows(x))
        plain_ms = timer(lambda: quantize_rows_plain(x))
        dev_ms, _ = timer.device(lambda: quantize_rows(x))
        b_ms, _ = bound(3 * M * K + 4 * M, 0, 1.0)
        log(f"kernel quantize_rows [M={M} K={K}] codes and scales bit-equal "
            f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms="
            f"{plain_ms:.4f} bound_ms={b_ms:.4f} (bytes); it runs inside "
            f"every w4a8_matmul / w8a8_matmul call")

    # the last: ragged M and O on the GEMM body, and a K (a multiple of 32,
    # not of the int8 GEMM's 64-column tile) whose last tile is half empty
    decode = [(6144, 4096, "qkv"), (4096, 14336, "down_proj"),
              (128256, 4096, "lm_head")]
    cases = [(M, O, K, name, 128) for M in (1, 8, 32)
             for (O, K, name) in decode]
    cases += [(4096, O, K, name, 128) for (O, K, name) in decode]
    cases += [(5, 1000, 4096, "ragged", 128), (200, 1000, 1056, "K edge", 96)]
    for (M, O, K, name, G) in cases:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        out_bytes = 2 * M * K + 2 * M * O

        # row 7, W8A8: per-channel signed scales
        wi = torch.randint(-128, 128, (O, K), generator=gen,
                           device=dev).to(torch.int8)
        ws = (torch.rand(O, generator=gen, device=dev) - 0.5) * 0.002
        y = w8a8_matmul(x, wi, ws)
        y32 = w8a8_matmul(x, wi, ws, torch.float32)
        p32 = w8a8_matmul_plain(x, wi, ws, torch.float32)
        torch.cuda.synchronize()
        err, rel = row_err(y, p32.bfloat16())
        equal = torch.equal(y32, p32)
        check(equal, f"w8a8 M={M} O={O} K={K}: fp32 result differs from the "
              f"plain version's (both are exact integers times two scales)")
        del y32, p32
        ms = timer(lambda: w8a8_matmul(x, wi, ws))
        plain_ms = timer(lambda: w8a8_matmul_plain(x, wi, ws))
        if M > 32:
            xi, xs = quantize_rows(x)
            wt = wi.T

            def lib():
                return (torch._int_mm(xi, wt).float() * xs[:, None]
                        * ws[None, :]).bfloat16()
            lib_what = "int_mm+epilogue"
        else:
            w_bf16 = (wi.float() * ws[:, None]).bfloat16()

            def lib():
                return torch.matmul(x, w_bf16.T)
            lib_what = "matmul(bf16 dequant)"
        lib_ms = timer(lib)
        dev_ms, how = timer.device(lambda: w8a8_matmul(x, wi, ws))
        lib_dev_ms, _ = timer.device(lib)
        b_ms, b_by = bound(out_bytes + O * K + 4 * O, 2 * M * O * K,
                           int8_peak)
        shape = f"{name} M={M} O={O} K={K} per channel"
        report("w8a8_matmul", shape, err, rel,
               f" f32_bit_equal={equal} library={lib_what} device_ms="
               f"{dev_ms:.4f} ({how}, quantize_rows + product) "
               f"library_device_ms={lib_dev_ms:.4f} device "
               f"{tflops(2 * M * O * K, dev_ms, 'TOP/s')}", ms, plain_ms,
               lib_ms, b_ms, b_by)
        if M == 8 and name == "qkv":
            rows["w8a8_matmul"] = dict(
                name="w8a8_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w8a8_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul_int8.py:130",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        lib = None
        xi = xs = wt = w_bf16 = None

        # row 11, W8A16 on the same codes: per group and per channel
        for g in (G, 0) if M not in (1, 32) else ():
            sc = (torch.rand(O, K // g if g else 1, generator=gen,
                             device=dev) - 0.5) * 0.002
            y = w8a16_matmul(x, wi, sc, g)
            yp = w8a16_matmul_plain(x, wi, sc, g)
            torch.cuda.synchronize()
            err, rel = row_err(y, yp)
            del yp
            ms = timer(lambda: w8a16_matmul(x, wi, sc, g))
            plain_ms = timer(lambda: w8a16_matmul_plain(x, wi, sc, g))
            w_bf16 = (wi.float() * sc.repeat_interleave(
                g if g else K, dim=1)).bfloat16()
            lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
            extra = ""
            if M == 8:
                dev_ms, lib_dev_ms, extra = device_pair(
                    timer, lambda: w8a16_matmul(x, wi, sc, g),
                    lambda: torch.matmul(x, w_bf16.T))
            del w_bf16
            b_ms, b_by = bound(out_bytes + O * K + 4 * sc.numel(),
                               2 * M * O * K, flops_peak)
            shape = f"{name} M={M} O={O} K={K} " + (
                f"g={g}" if g else "per channel")
            report("w8a16_matmul", shape, err, rel, extra, ms, plain_ms,
                   lib_ms, b_ms, b_by)
            if M == 8 and name == "qkv" and g:
                rows["w8a16_matmul"] = dict(
                    name="w8a16_matmul", route="cuda",
                    source="autoround_tpu_torch/csrc/w8a16_matmul.cu",
                    replaces="autoround_tpu/ops/qmatmul_ext.py:330",
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del wi, ws, y
        sc = None
        torch.cuda.empty_cache()

        # row 8, W4A8: the packed words of the W4A16 kernel
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        sc = (torch.rand(O, K // G, generator=gen, device=dev) - 0.5) * 0.02
        y = w4a8_matmul(x, qw, sc, G)
        y32 = w4a8_matmul(x, qw, sc, G, torch.float32)
        p32 = w4a8_matmul_plain(x, qw, sc, G, torch.float32)
        torch.cuda.synchronize()
        err, rel = row_err(y, p32.bfloat16())
        equal = torch.equal(y32, p32)
        _, rel32 = row_err(y32, p32)
        kc = a8_gemv_info("w4a8_matmul", M, K, O, G)[5] if M <= 32 else 1
        check(rel32 <= W4A8_F32_ROW_TOL and (equal or kc > 1),
              f"w4a8 M={M} O={O} K={K}: fp32 row err {rel32}, bit-equal "
              f"{equal} (the GEMM body and a GEMV that splits no K must "
              f"be)")
        del y32, p32
        ms = timer(lambda: w4a8_matmul(x, qw, sc, G))
        plain_ms = timer(lambda: w4a8_matmul_plain(x, qw, sc, G))
        w_bf16 = ((unpack_w4(qw) - 8).float()
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_ms, how = timer.device(lambda: w4a8_matmul(x, qw, sc, G))
        lib_dev_ms, _ = timer.device(lambda: torch.matmul(x, w_bf16.T))
        del w_bf16
        a16 = ""
        if M == 8 and name in ("qkv", "down_proj", "lm_head"):
            # the A16 SYM4 GEMV reads the same packed words
            a16_ms, a16_how = timer.device(lambda: w4a16_matmul(x, qw, sc, G))
            a16 = f" a16_sym4_gemv_device_ms={a16_ms:.4f} ({a16_how})"
        b_ms, b_by = bound(out_bytes + O * K // 2 + 4 * sc.numel(),
                           2 * M * O * K, int8_peak)
        shape = f"{name} M={M} O={O} K={K} g={G}"
        report("w4a8_matmul", shape, err, rel,
               f" f32_bit_equal={equal} (kc={kc}) f32_row_err="
               f"{rel32:.3g} (tol {W4A8_F32_ROW_TOL}) device_ms="
               f"{dev_ms:.4f} ({how}, "
               f"quantize_rows + product) library_device_ms="
               f"{lib_dev_ms:.4f} device "
               f"{tflops(2 * M * O * K, dev_ms, 'TOP/s')}{a16}", ms,
               plain_ms, lib_ms, b_ms, b_by)
        if M == 8 and name == "qkv":
            rows["w4a8_matmul"] = dict(
                name="w4a8_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w4a8_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul_int8.py:295",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, x, y
        torch.cuda.empty_cache()
    return rows


def float_kernel_phase(timer, bw, flops_peak):
    """The float and 2-bit weight-only kinds at the llama3-8b projections:
    W2A16 (g = 128), FP8 (per channel) and MXFP4 (g = 32, powers of two)
    / NVFP4 (g = 16, any positive scale) against their plain versions, plus
    one K-edge shape each (K = 1056: a multiple of 32, not of 64); kernel,
    plain, library (``torch.matmul`` on the dequantized bf16 weight) and
    bound times."""
    from autoround_tpu_torch.ops.qmatmul import pack_w4, unpack_w4
    from autoround_tpu_torch.ops.qmatmul_ext import (
        decode_e2m1, fp8_matmul, fp8_matmul_plain, mxfp4_matmul,
        mxfp4_matmul_plain, pack_w2, unpack_w2, w2a16_matmul,
        w2a16_matmul_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}

    def run(kernel, shape, fn, plain, w_bf16, x, nbytes, replaces, source):
        M, K = x.shape
        O = w_bf16.shape[0]
        y, yp = fn(), plain()
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del y, yp
        ms = timer(fn)
        plain_ms = timer(plain)
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_txt = ""
        if M == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, fn, lambda: torch.matmul(x, w_bf16.T))
        t_b = (nbytes + 2 * M * K + 2 * M * O) / bw * 1e3
        t_f = 2 * M * O * K / flops_peak * 1e3
        b_ms, b_by = max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
        tol = ROW_TOL[kernel]
        log(f"kernel {kernel} [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * M * O * K, ms)} library "
            f"{tflops(2 * M * O * K, lib_ms)}")
        check(rel <= tol, f"{kernel} {shape}: row err {rel}")
        if M == 8 and shape.startswith("qkv") and kernel not in rows:
            rows[kernel] = dict(
                name=kernel, route="cuda", source=source, replaces=replaces,
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)

    cases = [(8, 6144, 4096, "qkv"), (8, 4096, 14336, "down_proj"),
             (8, 128256, 4096, "lm_head"), (4096, 6144, 4096, "qkv"),
             (4096, 4096, 14336, "down_proj"),
             (4096, 128256, 4096, "lm_head"), (200, 1000, 1056, "K edge")]
    for (M, O, K, name) in cases:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()

        # row 10, W2A16: signed group scales
        G = 96 if K == 1056 else 128
        qw = pack_w2(torch.randint(0, 4, (O, K), generator=gen, device=dev))
        sc = (torch.rand(O, K // G, generator=gen, device=dev) - 0.5) * 0.02
        w_bf16 = ((unpack_w2(qw) - 2).float()
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        run("w2a16_matmul", f"{name} M={M} O={O} K={K} g={G}",
            lambda: w2a16_matmul(x, qw, sc, G),
            lambda: w2a16_matmul_plain(x, qw, sc, G), w_bf16, x,
            O * K // 4 + 4 * sc.numel(), "autoround_tpu/ops/qmatmul_ext.py:247",
            "autoround_tpu_torch/csrc/w2a16_matmul.cu")
        del qw, sc, w_bf16
        torch.cuda.empty_cache()

        # row 12, FP8: e4m3 weights, one scale per output channel
        wf = (torch.randn(O, K, generator=gen, device=dev) * 60).clamp(
            -448, 448).to(torch.float8_e4m3fn)
        sc = torch.rand(O, generator=gen, device=dev) * 0.002 + 1e-4
        w_bf16 = (wf.float() * sc[:, None]).bfloat16()
        run("fp8_matmul", f"{name} M={M} O={O} K={K} per channel",
            lambda: fp8_matmul(x, wf, sc), lambda: fp8_matmul_plain(x, wf, sc),
            w_bf16, x, O * K + 4 * O, "autoround_tpu/ops/qmatmul_ext.py:407",
            "autoround_tpu_torch/csrc/fp8_matmul.cu")
        del wf, sc, w_bf16
        torch.cuda.empty_cache()

        # row 13, MXFP4 (g = 32) and NVFP4 (g = 16) on the same codes
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        vals = decode_e2m1(unpack_w4(qw))
        for G in (32, 16):
            if G == 32:
                sc = torch.exp2(torch.randint(-10, -4, (O, K // G),
                                              generator=gen,
                                              device=dev).float())
            else:
                sc = torch.rand(O, K // G, generator=gen, device=dev) * 0.004
            w_bf16 = (vals * sc.repeat_interleave(G, dim=1)).bfloat16()
            run("mxfp4_matmul", f"{name} M={M} O={O} K={K} g={G}",
                lambda: mxfp4_matmul(x, qw, sc, G),
                lambda: mxfp4_matmul_plain(x, qw, sc, G), w_bf16, x,
                O * K // 2 + 4 * sc.numel(),
                "autoround_tpu/ops/qmatmul_ext.py:559",
                "autoround_tpu_torch/csrc/mxfp4_matmul.cu")
            del sc, w_bf16
        del qw, vals, x
        torch.cuda.empty_cache()
    return rows


def sage_kernel_phase(timer, bw, flops_peak, int8_peak):
    """Row 14, the int8-QK attention, at row 1's shapes (B8 H32 Hkv8 S=T=512
    and S=256 T=512, D128, causal) and the JAX docstring's B4 H32 Hkv8
    S=T=2048: against its plain version in the jitted form it follows (the
    same mean key), timed beside its bound, SDPA on the same bf16 q/k/v
    (the library yardstick) and row 1's flash kernel in the same call, by
    event and by device time (``Timer.device``).
    Bound: the bytes of q, k, v and the output, or QK^T's operations over
    the int8 peak plus P.V's over the bf16 peak (the causal pairs)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from autoround_tpu_torch.ops.flash_attention import flash_attention
    from autoround_tpu_torch.ops.sage_attention import (sage_attention,
                                                        sage_attention_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = {}
    for (B, H, Hkv, S, T) in [(8, 32, 8, 512, 512), (8, 32, 8, 256, 512),
                              (4, 32, 8, 2048, 2048)]:
        D = 128
        q = torch.randn(B, H, S, D, generator=gen, device=dev).bfloat16()
        k = (torch.randn(B, Hkv, T, D, generator=gen, device=dev)
             + 2).bfloat16()
        v = torch.randn(B, Hkv, T, D, generator=gen, device=dev).bfloat16()
        o = sage_attention(q, k, v, True)
        op = sage_attention_plain(q, k, v, True, recip=True)
        torch.cuda.synchronize()
        err, rel = row_err(o, op)
        tol = ROW_TOL["sage_attention"]
        check(bool(torch.isfinite(o).all()) and rel <= tol,
              f"sage S={S} T={T}: row err {rel}")
        # the JAX docstring's accuracy claim: against the bf16 flash kernel
        fo, _ = flash_attention(q, k, v, True)
        flash_mae = (o.float() - fo.float()).abs().mean().item()
        check(flash_mae < SAGE_FLASH_MAE,
              f"sage S={S} T={T}: mean abs err vs flash {flash_mae}")
        del op, fo

        def lib():
            if S == T:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=causal_lower_right(S, T), enable_gqa=True)
        ms = timer(lambda: sage_attention(q, k, v, True))
        plain_ms = timer(lambda: sage_attention_plain(q, k, v, True,
                                                      recip=True))
        lib_ms = timer(lib)
        flash_ms = timer(lambda: flash_attention(q, k, v, True))
        # device times: the op's kernels summed (the mean key's reduction,
        # the key pre-pass, the attention kernel), row 1's, SDPA's
        dev_ms, how = timer.device(lambda: sage_attention(q, k, v, True))
        flash_dev_ms, _ = timer.device(lambda: flash_attention(q, k, v,
                                                               True))
        lib_dev_ms, _ = timer.device(lib)
        valid = sum(min(T, i + T - S + 1) for i in range(S))
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel())
        t_b = nbytes / bw * 1e3
        ops = 2 * B * H * valid * D
        t_f = (ops / int8_peak + ops / flops_peak) * 1e3
        b_ms, b_by = max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
        shape = f"B={B} H={H} Hkv={Hkv} S={S} T={T} D={D} causal"
        log(f"kernel sage_attention [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) mean_abs_err_vs_flash="
            f"{flash_mae:.3g} (tol {SAGE_FLASH_MAE}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"flash_ms={flash_ms:.4f} (sage / flash {ms / flash_ms:.3f}) "
            f"device_ms={dev_ms:.4f} ({how}) flash_device_ms="
            f"{flash_dev_ms:.4f} (sage / flash {dev_ms / flash_dev_ms:.3f}) "
            f"library_device_ms={lib_dev_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by})")
        if S == T == 512:
            rows["sage_attention"] = dict(
                name="sage_attention", route="cuda",
                source="autoround_tpu_torch/csrc/sage_attention.cu",
                replaces="autoround_tpu/ops/sage_attention.py:176",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                flash_ms=flash_ms, device_ms=dev_ms,
                flash_device_ms=flash_dev_ms, library_device_ms=lib_dev_ms)
        del q, k, v, o
        torch.cuda.empty_cache()
    return rows


def sage_path(n_layers):
    """The int8-QK op through its entry point, as a user calls it: the
    attention of a llama3-8b prefill (8 x 512 tokens, 32 heads, 8 kv heads,
    hd 128, causal) for each of ``n_layers`` layers, fresh q/k/v per layer
    from a seeded generator.  Counts are read right after; then the same
    q/k/v, drawn again, go through the flash kernel, and each output must
    be within the JAX docstring's accuracy of it.  No engine path routes to
    the op (as in the JAX package); returns the launches."""
    from autoround_tpu_torch.ops.flash_attention import flash_attention
    from autoround_tpu_torch.ops.sage_attention import sage_attention

    kernels = _kernel_fns()
    B, H, Hkv, S, D = 8, 32, 8, 512, 128

    def layer_inputs(gen):
        q = torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
        k = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
             + 2).bfloat16()
        v = torch.randn(B, Hkv, S, D, generator=gen, device="cuda").bfloat16()
        return q, k, v

    gen = torch.Generator(device="cuda").manual_seed(18)
    for fn in kernels.values():
        fn.launches = 0
    outs = [sage_attention(*layer_inputs(gen), True)
            for _ in range(n_layers)]
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    gen = torch.Generator(device="cuda").manual_seed(18)
    worst = 0.0
    for o in outs:
        q, k, v = layer_inputs(gen)
        check(bool(torch.isfinite(o).all()) and o.shape == q.shape,
              "sage path: output not finite or of another shape")
        fo, _ = flash_attention(q, k, v, True)
        worst = max(worst, (o.float() - fo.float()).abs().mean().item())
    log(f"sage path ({n_layers} layers of llama3-8b prefill attention): "
        f"worst mean_abs_err_vs_flash={worst:.3g} (tol {SAGE_FLASH_MAE})")
    log(f"sage path kernels {json.dumps(launches)}")
    check(worst < SAGE_FLASH_MAE, "sage path: output far from flash")
    want = {n: 0 for n in kernels}
    want["sage_attention"] = n_layers
    for n, c in want.items():
        check(launches[n] == c, f"sage path: {n} launched {launches[n]} "
              f"times, the loop implies {c}")
    return launches


def copy_engine(eng, n_layers, device):
    """The first ``n_layers`` blocks of an engine, on ``device``."""
    import dataclasses

    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(eng.cfg, num_layers=n_layers)

    def mv(t):
        return t.to(device)

    params = tree_map(mv, {k: v for k, v in eng.params.items()
                           if k != "blocks"})
    params["blocks"] = tree_map(mv, eng.params["blocks"][:n_layers])
    keep = {f"blocks.{i}." for i in range(n_layers)}
    packed = {k: tuple(mv(t) for t in e) for k, e in eng.packed.items()
              if k == "lm_head" or any(k.startswith(p) for p in keep)}
    return QuantizedLlama(cfg=cfg, params=params, packed=packed,
                          max_seq=eng.max_seq, kv_quant=eng.kv_quant,
                          fused_splits=eng.fused_splits,
                          device=torch.device(device),
                          packed_kinds={k: eng.packed_kinds[k]
                                        for k in packed},
                          moe_capacity_factor=eng.moe_capacity_factor,
                          prefill_a8=eng.prefill_a8)


def _kernel_times(prof, after=None):
    """{kernel name: (total ms, launches)} over the device-side events of a
    profile (each kernel counted once; CUPTI's own overhead markers out),
    those that start at ``after`` or later on the trace's clock if given."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "Command Buffer" in e.name:
            continue
        if after is not None and e.time_range.start < after:
            continue
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


def _short(name: str) -> str:
    """`split_kernel<128, 4>` for a profiler's kernel name (its function
    name and template arguments, without the signature)."""
    head = name.replace("(anonymous namespace)", "").split("(")[0]
    return re.sub(r"^.*?(\w+(<[^()]*>)?)$", r"\1",
                  head.replace("void ", "").strip())[:40]


def _top(times, per=1):
    rows = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    return "; ".join(f"{name[:60]} {ms / per:.3f} ms x{n // per}"
                     for name, (ms, n) in rows)


def profile_serving(eng, prompts, prefill_ms, step_ms):
    """Kernel time on the card for one prefill and for 3 decode steps
    (torch.profiler, CUDA activity).  Busy share = kernel time over the
    unprofiled wall time of the same work."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values())
    log(f"profile prefill: kernel_ms={total:.2f} of prefill_ms="
        f"{prefill_ms:.2f} busy_share={total / prefill_ms:.3f}; top: "
        + _top(times))
    tok = logits.argmax(-1).to(torch.int32)
    n = 3
    with profile(activities=acts) as prof:
        for _ in range(n):
            logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values()) / n
    # the GEMV family (A16 and int8 bodies) and the int8 quantizer a step
    gemv = sum(ms for name, (ms, _) in times.items()
               if "gemv_kernel" in name) / n
    quant = sum(ms for name, (ms, _) in times.items()
                if "quantize_rows_kernel" in name) / n
    log(f"profile decode step: kernel_ms={total:.3f} of step_ms="
        f"{step_ms:.3f} busy_share={total / step_ms:.3f} gemv_ms="
        f"{gemv:.3f} quantize_rows_ms={quant:.3f}; top per step: "
        + _top(times, n))


def serve_bounds(eng, B, S, bw, flops_peak, int8_peak=None):
    """Least times the card could take for one prefill of B x S tokens and
    for the first decode step after it (pos = S): the larger of bytes over
    bandwidth and operations over their peak: the bf16 peak, or with
    ``int8_peak`` (an engine whose packed projections all run int8
    products: the kinds w4a8 and w8a8) the int8 peak for the projections
    and the bf16 peak for attention.  Prefill FLOPs: every block
    weight for all B*S tokens, the lm_head for the last position only (the
    engine runs it there alone), causal attention; a MoE block counts
    all its experts for every token (dense-then-mask routing, which is what
    the engine runs by default) and the router.  Bytes: the packed
    weights and scales and the dense leaves once, the embedding rows
    used, the int8 cache written (prefill) or read up to pos (decode).
    A sliding layer's attention counts the keys of its window alone
    (``_attended``)."""
    from autoround_tpu_torch.utils.pytree import tree_map

    cfg = eng.cfg
    L, hid, hd, V = cfg.num_layers, cfg.hidden_size, cfg.hd, cfg.vocab_size
    H, Hkv, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    n_exp = getattr(cfg, "num_experts", 0)
    w_block = (hid * (H + 2 * Hkv) * hd + H * hd * hid
               + max(n_exp, 1) * 3 * hid * inter + n_exp * hid)

    def nbytes(t):
        return 0 if t is None else t.numel() * t.element_size()
    w_bytes = sum(nbytes(t) for e in eng.packed.values() for t in e)
    w_bytes += sum(nbytes(t) for k, t in eng.params.items()
                   if k not in ("blocks", "embed_tokens"))
    leaves = []
    tree_map(leaves.append, eng.params["blocks"])
    w_bytes += sum(nbytes(t) for t in leaves)
    row = hid * eng.params["embed_tokens"].element_size()
    kv_key = 2 * B * Hkv * hd                # int8 k and v of one key
    step_keys, pre_keys = _attended(cfg, S)  # summed over the layers
    lin_peak = int8_peak or flops_peak
    pre_ops_s = ((2 * B * S * w_block * L + 2 * B * hid * V) / lin_peak
                 + 4 * B * H * hd * pre_keys / flops_peak)
    pre_bytes = w_bytes + B * S * row + S * L * kv_key
    step_ops_s = (2 * B * (w_block * L + hid * V) / lin_peak
                  + 4 * B * H * hd * step_keys / flops_peak)
    step_bytes = w_bytes + B * row + step_keys * kv_key
    return (max(pre_bytes / bw, pre_ops_s) * 1e3,
            max(step_bytes / bw, step_ops_s) * 1e3)


def _kernel_fns():
    from autoround_tpu_torch.ops.decode_attention import decode_attention
    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from autoround_tpu_torch.ops.qmatmul import (w4a16_matmul,
                                                 w4a16_matmul_grouped)
    from autoround_tpu_torch.ops.qmatmul_ext import (fp8_matmul,
                                                     mxfp4_matmul,
                                                     w2a16_matmul,
                                                     w4a16_asym_matmul,
                                                     w8a16_matmul)
    from autoround_tpu_torch.ops.qmatmul_int8 import (w4a8_matmul,
                                                      w8a8_matmul)
    from autoround_tpu_torch.ops.sage_attention import sage_attention

    return {"flash_attention": flash_attention,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "w4a16_matmul": w4a16_matmul,
            "w4a16_matmul_grouped": w4a16_matmul_grouped,
            "w4a16_asym_matmul": w4a16_asym_matmul,
            "decode_attention": decode_attention,
            "w4a8_matmul": w4a8_matmul, "w8a8_matmul": w8a8_matmul,
            "w8a16_matmul": w8a16_matmul, "w2a16_matmul": w2a16_matmul,
            "fp8_matmul": fp8_matmul, "mxfp4_matmul": mxfp4_matmul,
            "sage_attention": sage_attention}


@contextlib.contextmanager
def plain_versions(attention=True):
    """Inside the block, every kernel wrapper the engine and the model call
    is its plain PyTorch version (on whatever device the tensors lie);
    with ``attention=False`` only the packed products are, and the two
    attention kernels stay."""
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.ops.decode_attention import decode_attention_plain
    from autoround_tpu_torch.ops.flash_attention import flash_attention_plain
    from autoround_tpu_torch.ops.qmatmul import (w4a16_matmul_grouped_plain,
                                                 w4a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_ext import (fp8_matmul_plain,
                                                     mxfp4_matmul_plain,
                                                     w2a16_matmul_plain,
                                                     w4a16_asym_matmul_plain,
                                                     w8a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_int8 import (w4a8_matmul_plain,
                                                      w8a8_matmul_plain)
    from autoround_tpu_torch.serve import engine

    patches = [
        (llama, "flash_attention",
         lambda q, k, v, causal=True: flash_attention_plain(q, k, v, causal)),
        (engine, "decode_attention", decode_attention_plain),
        (engine, "w4a16_matmul", w4a16_matmul_plain),
        (engine, "w4a16_matmul_grouped", w4a16_matmul_grouped_plain),
        (engine, "w4a16_asym_matmul", w4a16_asym_matmul_plain),
        (engine, "w4a8_matmul", w4a8_matmul_plain),
        (engine, "w8a8_matmul", w8a8_matmul_plain),
        (engine, "w8a16_matmul", w8a16_matmul_plain),
        (engine, "w2a16_matmul", w2a16_matmul_plain),
        (engine, "fp8_matmul", fp8_matmul_plain),
        (engine, "mxfp4_matmul", mxfp4_matmul_plain)]
    if not attention:
        patches = patches[2:]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def time_serving(eng, prompts, n_new, bw, flops_peak, int8_peak=None):
    """Time one prefill and the decode steps after it, print them beside
    their bounds and a profile; returns (prefill ms, median step ms)."""
    B, S = prompts.shape
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.time() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    tok = logits.argmax(-1).to(torch.int32)
    steps = []
    for _ in range(n_new - 1):
        t0 = time.time()
        logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
        steps.append((time.time() - t0) * 1e3)
        tok = logits.argmax(-1).to(torch.int32)
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    step_ms = statistics.median(steps)
    log(f"serve: prefill_ms={prefill_ms:.2f} (B={B} S={S}) "
        f"decode_step_ms_median={step_ms:.3f} "
        f"decode_tok_s={B / step_ms * 1e3:.1f} "
        f"(steps {min(steps):.3f}..{max(steps):.3f} ms)")
    pre_bound, step_bound = serve_bounds(eng, B, S, bw, flops_peak,
                                         int8_peak)
    log(f"serve bounds: prefill_bound_ms={pre_bound:.3f} "
        f"({'int8 OPs, attention bf16' if int8_peak else 'FLOPs'}) "
        f"decode_step_bound_ms={step_bound:.4f} (bytes, pos={S})")
    del cache, logits
    profile_serving(eng, prompts, prefill_ms, step_ms)
    return prefill_ms, step_ms


def check_copy(eng, prompts, reference, tol=COPY_ROW_TOL, attention=True):
    """A 2-layer copy of the engine, 2 prompts, 8 greedy tokens: once through
    the kernels on the card, once through the plain versions — on the CPU
    (``reference="cpu"``) or, where the CPU would take minutes (MoE: every
    step dequantizes 2 x 24 expert matrices), on the card
    (``reference="card"``).  Step-1 logits must agree within ``tol`` and
    the greedy tokens must match.

    ``attention=False`` (card only) keeps the attention kernels in the
    reference run too.  The int8-activation kinds need it: the per-token
    quantizer rounds bf16 activations onto a grid whose step (1 / 127 of a
    row's amax) is about one bf16 ulp, so the bf16-level difference between
    an attention kernel and its plain version flips many codes and moves
    the logits by 0.26 of a row's RMS (measured, W4A8) whatever the
    products do; with the same attention on both sides the check holds the
    int8 products alone, which are exact."""
    p2 = prompts[:2]
    gpu = copy_engine(eng, 2, "cuda")
    lg_gpu, _ = gpu.prefill(p2)
    tok_gpu = gpu.generate(p2, max_new_tokens=8).cpu()
    ref = gpu if reference == "card" else copy_engine(eng, 2, "cpu")
    t0 = time.time()
    with plain_versions(attention) if reference == "card" \
            else contextlib.nullcontext():
        logits, cache = ref.prefill(p2)
        ref_logits = [logits.cpu()]
        tok_ref = [logits.argmax(-1).to(torch.int32)]
        for _ in range(7):
            logits, cache = ref.decode_step(tok_ref[-1], cache)
            ref_logits.append(logits.cpu())
            tok_ref.append(logits.argmax(-1).to(torch.int32))
    tok_ref = torch.stack(tok_ref, 1).cpu()
    t_ref = time.time() - t0
    err, rel = row_err(lg_gpu.cpu(), ref_logits[0])
    log(f"2-layer copy (plain versions on the {reference}): step-1 logits "
        f"max_abs_err={err:.4g} row_err={rel:.4g} (tol {tol}) "
        f"reference_s={t_ref:.1f}")
    check(rel <= tol, "2-layer copy: step-1 logits disagree")
    if not attention:
        # reported, not held: the same prefill with every kernel plain, so
        # that a drift of the flips' size shows from run to run
        with plain_versions(True):
            full, _ = ref.prefill(p2)
        err, rel = row_err(lg_gpu.cpu(), full.cpu())
        log(f"2-layer copy (attention plain too, not held): step-1 logits "
            f"max_abs_err={err:.4g} row_err={rel:.4g}")
    # greedy tokens: equal step by step; at the first step where they
    # differ (if any), the card's token must be a near-tie of the plain
    # choice — within the row tolerance of the plain maximum — and the
    # comparison stops there (the two sequences' contexts diverge)
    n_equal = 0
    for i, lg in enumerate(ref_logits):
        if torch.equal(tok_gpu[:, i], tok_ref[:, i]):
            n_equal = i + 1
            continue
        lg = lg.float()
        picked = lg.gather(1, tok_gpu[:, i:i + 1].long())[:, 0]
        gap = (lg.max(-1).values - picked) / lg.pow(2).mean(-1).sqrt()
        check(gap.max().item() <= tol,
              f"2-layer copy: step {i} card token is {gap.tolist()} row "
              f"RMS below the plain maximum (tol {tol})")
        break
    log(f"2-layer copy tokens: kernels {tok_gpu.tolist()} plain "
        f"{tok_ref.tolist()} equal for {n_equal} of {len(ref_logits)} steps")


# ----------------------------------------------------------- the decode loop
#
# ``generate_scan`` runs the decode loop as a replayed CUDA graph.  Its tokens
# must equal ``generate``'s (the same kernels, plans and order) and its
# launches ``generate``'s, which the paths hold to what their loops imply.

SCAN_REPLAYS = 32          # replays timed after a generate_scan call
SCAN_PROFILE_REPLAYS = 3   # replays under the profiler
EAGER_STEPS = 4            # eager decode steps timed beside them
SCAN_NEW = 16              # new tokens of the scan phase's own calls


def launch_counts():
    """{wrapper name: launches} over every kernel wrapper of the port."""
    from autoround_tpu_torch.ops._build import COUNTED
    return {f.__name__: f.launches for f in COUNTED}


@contextlib.contextmanager
def counts_kept():
    """Launches inside the block (timing, profiling) leave every count as
    it was."""
    from autoround_tpu_torch.ops._build import COUNTED
    saved = [(f, f.launches) for f in COUNTED]
    try:
        yield
    finally:
        for f, c in saved:
            f.launches = c


def generate_counted(eng, prompts, n_new, sampling=None, step_ms=None):
    """``eng.generate`` and the launches it made: (tokens, {name: count}).
    With a list ``step_ms``, each of its decode steps is synchronised and
    its host ms appended (the eager step of this call)."""
    c0 = launch_counts()
    if step_ms is not None:
        decode_step = eng.decode_step

        def timed(tok, cache):
            torch.cuda.synchronize()
            t0 = time.time()
            out = decode_step(tok, cache)
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
            return out
        eng.decode_step = timed
    try:
        toks = eng.generate(prompts, max_new_tokens=n_new, sampling=sampling)
    finally:
        if step_ms is not None:
            del eng.decode_step
    torch.cuda.synchronize()
    c1 = launch_counts()
    return toks, {n: c1[n] - c0[n] for n in c0}


def _scan_step(eng, B, sampling=None):
    how = (None if sampling is None or sampling.is_greedy
           else (sampling.temperature, sampling.top_k, sampling.top_p))
    return eng._scan_steps[(B, eng.kv_quant, how, eng.prefill_a8)]


def scan_against(eng, prompts, toks, gen_counts, label, sampling=None):
    """``generate_scan`` on the prompts ``generate`` ran (giving ``toks``
    and ``gen_counts``): equal tokens and equal launches, or the run fails.
    Returns (seconds of the call, graphs it captured)."""
    caps = eng.captures
    c0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    got = eng.generate_scan(prompts, max_new_tokens=toks.shape[1],
                            sampling=sampling)   # synchronises at its end
    secs = time.time() - t0
    c1 = launch_counts()
    diff = {n: (c1[n] - c0[n], gen_counts[n]) for n in c0
            if c1[n] - c0[n] != gen_counts[n]}
    check(torch.equal(got, toks), f"{label}: generate_scan tokens "
          f"{got.tolist()} differ from generate's {toks.tolist()}")
    check(not diff, f"{label}: generate_scan launches differ from "
          f"generate's (scan, generate): {diff}")
    return secs, eng.captures - caps


def eager_step_times(eng, prompts, n=EAGER_STEPS):
    """Host ms of n eager decode steps after a prefill (synchronised each)."""
    logits, cache = eng.prefill(prompts)
    tok = logits.argmax(-1).to(torch.int32)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        tok = logits.argmax(-1).to(torch.int32)
    return times


def replay_times(eng, B, n, sampling=None):
    """ms of each of n replays of the engine's captured step at batch B
    (CUDA events between replays), continuing from its last generate_scan."""
    step = _scan_step(eng, B, sampling)
    st = eng._scan_states[B]
    check(step.graph is not None, "replay_times: no graph captured")
    check(int(st.step) + n <= eng.max_seq
          and int(st.cache.pos.max()) + n <= eng.max_seq,
          "replay_times: the replays would pass max_seq")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(n):
        step.run(1)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]


def scan_path(eng, prompts, toks, gen_counts, label, eager=None):
    """A serving path's check of ``generate_scan`` (tokens and launches
    equal to ``generate``'s; the replayed launches measured, see
    :func:`profile_replays`) and its replayed step beside the eager step,
    both timed in this call (``eager``: the path's own median eager step
    ms, else 4 steps are timed here); returns (graph step ms, eager step
    ms)."""
    t0 = time.time()
    B = prompts.shape[0]
    secs, captured = scan_against(eng, prompts, toks, gen_counts, label)
    with counts_kept():
        if eager is None:
            eager = statistics.median(eager_step_times(eng, prompts, 4))
        graph = statistics.median(replay_times(eng, B, 16))
        prof = profile_replays(_scan_step(eng, B), label, n=2)
    log(f"{label} generate_scan: tokens and launches equal to generate's "
        f"(B={B}, {toks.shape[1]} new) generate_scan_s={secs:.3f} "
        f"captured={captured} capture_ms="
        f"{_scan_step(eng, B).capture_ms:.2f} graph_step_ms={graph:.4f} "
        f"eager_step_ms={eager:.4f}; replayed launches measured per step "
        f"{json.dumps(prof['launches'])}; scan_path_s={time.time() - t0:.1f}")
    return graph, eager


def _kernel_key(name: str) -> str:
    """The port's kernel a profiler's kernel name is ("w4a16<fmt>": the A16
    GEMV or GEMM of one weight format, "a8<w4>" / "a8<w8>": the int8 GEMV or
    GEMM, "quantize_rows", "decode split" / "decode combine", "flash"), or
    "torch" for PyTorch's own kernels."""
    m = re.search(r"w4a16::ge[mv]+_kernel<(\d)", name)
    if m:
        return f"w4a16<{m.group(1)}>"
    m = re.search(r"a8::(gemv_kernel<(true|false)|gemm_kernel<(\d))", name)
    if m:
        w4 = m.group(2) == "true" if m.group(2) else m.group(3) != "0"
        return "a8<w4>" if w4 else "a8<w8>"
    for key, k in (("quantize_rows_kernel", "quantize_rows"),
                   ("split_kernel<", "decode split"),
                   ("combine_kernel<", "decode combine"),
                   ("flash_fwd_kernel<", "flash")):
        if key in name:
            return k
    return "torch"


# The port's kernels one call of each wrapper that a decode step can reach
# launches (the A16 formats by csrc/w4a16_tiles.cuh's FMT: SYM4 0, ASYM4 1,
# INT8 2, INT2 3, E4M3 4, E2M1 5); wrappers that share a kernel add up.
WRAPPER_KERNELS = {
    "w4a16_matmul": ("w4a16<0>",), "w4a16_matmul_grouped": ("w4a16<0>",),
    "w4a16_asym_matmul": ("w4a16<1>",), "w8a16_matmul": ("w4a16<2>",),
    "w2a16_matmul": ("w4a16<3>",), "fp8_matmul": ("w4a16<4>",),
    "mxfp4_matmul": ("w4a16<5>",),
    "w4a8_matmul": ("quantize_rows", "a8<w4>"),
    "w8a8_matmul": ("quantize_rows", "a8<w8>"),
    "quantize_rows": ("quantize_rows",),
    "decode_attention": ("decode split", "decode combine"),
    "flash_attention": ("flash",)}


def _trace_busy(prof, after=None):
    """(kernel ms, span ms) of one profile: the union of its device
    kernels' intervals, and the time from the first kernel's start to the
    last one's end, both on the trace's own clock (the kernels that start
    at ``after`` or later if given)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "Command Buffer" not in e.name
                   and (after is None or e.time_range.start >= after))
    if not spans:
        return 0.0, 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy / 1e3, (max(b for _, b in spans) - spans[0][0]) / 1e3


# the marker between a profile's warm-up replay and its recorded ones: a
# ``torch.cuda._sleep`` spin kernel of about 30 us
MARK_CYCLES = 1 << 16


def _mark_end(prof):
    """The end of a profile's last marker kernel on the trace's clock, or
    None when the trace lost it."""
    from torch.autograd import DeviceType

    ends = [e.time_range.end for e in prof.events()
            if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name]
    return max(ends) if ends else None


def profile_replays(step, label, n=SCAN_PROFILE_REPLAYS):
    """torch.profiler over n replays of a captured step (a ``_StepReplay``):
    the port's kernels counted per replay must equal what the capture's
    launch counters imply (each wrapper's increase over the capture times
    ``WRAPPER_KERNELS``), so the replayed counts are measured on the card.
    Returns per step the kernel ms, the span ms (first kernel start to last
    kernel end, over n), busy = kernel / span from the same trace, kernel
    ms by family, the measured launches and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    check(step.graph is not None, f"{label}: no graph to profile")
    want = {}
    for fn, d in step.deltas:
        check(fn.__name__ in WRAPPER_KERNELS, f"{label}: no kernel table "
              f"for wrapper {fn.__name__} (WRAPPER_KERNELS)")
        for key in WRAPPER_KERNELS[fn.__name__]:
            want[key] = want.get(key, 0) + d * n
    # A trace has lost kernel records on an H100, from the start of its
    # window: all of them, many, or the first (the same one in three takes
    # running).  One replay goes first and a marker kernel after it; only
    # the kernels after the marker count.  A trace that still lost records
    # (or the marker) is taken again, and says so; the last one is held.
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step.run(1)
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(n):
                step.run(1)
            torch.cuda.synchronize()
        mark = _mark_end(prof)
        times = {} if mark is None else _kernel_times(prof, after=mark)
        fam, seen = {}, {}
        for name, (ms, k) in times.items():
            key = _kernel_key(name)
            fam[key] = fam.get(key, 0.0) + ms / n
            if key != "torch":
                seen[key] = seen.get(key, 0) + k
        if seen == want:
            break
        log(f"{label}: profile {attempt + 1} of the replays held the "
            f"port's kernels {seen}, not {want}: taken again")
    check(bool(times), f"{label}: the profiler saw no kernel of the graph")
    check(seen == want, f"{label}: the port's kernels in {n} replays "
          f"{seen} differ from the capture's counts x {n} {want}")
    kernel_ms, span_ms = _trace_busy(prof, after=mark)
    return dict(kernel_ms=kernel_ms / n, span_ms=span_ms / n,
                busy=kernel_ms / span_ms, fam=fam,
                launches={k: v // n for k, v in sorted(seen.items())},
                top=_top(times, n))


def scan_measure(eng, B, S, bw, flops_peak, int8_peak, seed, label,
                 n_new=SCAN_NEW, second=False, sampled=False, ran=None):
    """The scan phase at one batch size: ``generate_scan`` against
    ``generate`` (tokens, launches), the capture ms alone, the median
    replayed step ms (CUDA events over the replays), tok/s, the step's
    bound, the busy share (kernel time over the span of the same replays,
    both from one profile), the replayed launches measured by that profile
    and the step's top kernels, beside the eager step of this call (the
    median of ``generate``'s own decode steps, each synchronised).
    ``second``: a second call with new prompts must replay without a
    recapture; ``sampled``: temperature 0.7, top-p 0.95 must give
    ``generate``'s tokens.  ``ran`` = (prompts, eager step ms) of a path
    whose ``scan_path`` already held this batch's ``generate_scan``
    against ``generate`` in this call: that check and eager step are
    reused."""
    from autoround_tpu_torch import SamplingParams

    t0 = time.time()
    gen = torch.Generator().manual_seed(seed)
    if ran is None:
        prompts = torch.randint(0, eng.cfg.vocab_size, (B, S), generator=gen)
        eager = []
        toks, counts = generate_counted(eng, prompts, n_new, step_ms=eager)
        secs, captured = scan_against(eng, prompts, toks, counts, label)
    else:
        (prompts, eager_ms), secs, captured = ran, float("nan"), 0
        eager = [eager_ms]
    step = _scan_step(eng, B)
    with counts_kept():
        times = replay_times(eng, B, SCAN_REPLAYS)
        prof = profile_replays(step, f"{label} scan B={B}")
    med, eager_med = statistics.median(times), statistics.median(eager)
    bound = serve_bounds(eng, B, S, bw, flops_peak, int8_peak)[1]
    log(f"{label} scan B={B} S={S}: capture_ms={step.capture_ms:.2f} "
        f"(captured {captured}) generate_scan_s={secs:.3f} "
        f"graph_step_ms_median={med:.4f} (replays {min(times):.4f}.."
        f"{max(times):.4f}) tok_s={B / med * 1e3:.1f} "
        f"eager_step_ms_median={eager_med:.4f} eager_tok_s="
        f"{B / eager_med * 1e3:.1f} step_bound_ms={bound:.4f} "
        f"graph/bound={med / bound:.2f}")
    log(f"{label} scan B={B} profile (torch.profiler over "
        f"{SCAN_PROFILE_REPLAYS} replays): kernel_ms={prof['kernel_ms']:.4f} "
        f"of span_ms={prof['span_ms']:.4f} a step on the trace's clock, "
        f"busy_share={prof['busy']:.3f}; by family "
        + json.dumps({k: round(v, 4) for k, v in sorted(prof["fam"].items())})
        + f"; launches measured per step {json.dumps(prof['launches'])}"
        + f"; top per step: {prof['top']}")
    if second:
        new = torch.randint(0, eng.cfg.vocab_size, (B, S), generator=gen)
        toks2, counts2 = generate_counted(eng, new, n_new)
        caps = eng.captures
        scan_against(eng, new, toks2, counts2, label + " second call")
        check(eng.captures == caps, f"{label}: the second call recaptured")
        log(f"{label} scan B={B}: a second call with new prompts replayed "
            f"the same graph (captures {eng.captures}) with generate's "
            f"tokens")
    if sampled:
        sp = SamplingParams(temperature=0.7, top_p=0.95, seed=seed)
        toks3, counts3 = generate_counted(eng, prompts, n_new, sp)
        scan_against(eng, prompts, toks3, counts3, label + " sampled", sp)
        log(f"{label} scan B={B}: sampled (temperature 0.7, top-p 0.95, "
            f"seed {seed}) tokens equal to generate's")
    log(f"{label} scan B={B}: scan_measure_s={time.time() - t0:.1f}")
    return dict(B=B, capture_ms=step.capture_ms, step_ms=med,
                eager_step_ms=eager_med, bound_ms=bound, busy=prof["busy"])


FP8_COPY_SEQ = 128     # prompt tokens of the fp8 copy's CPU reference


def fp8_kv_phase(eng, prompts, n_layers=4):
    """The fp8 KV cache: the first ``n_layers`` of a W4A16 engine with
    ``kv_quant="fp8"`` (sharing its packed weights): ``generate`` and
    ``generate_scan`` give equal tokens and launches, the cache is e4m3,
    and a 2-layer copy on the card holds its prefill and first decode
    step logits within ``COPY_ROW_TOL`` of the same copy on the CPU."""
    t_phase = time.time()
    fp8 = dataclasses.replace(copy_engine(eng, n_layers, "cuda"),
                              kv_quant="fp8")
    NEW = 16
    toks, counts = generate_counted(fp8, prompts, NEW)
    scan_against(fp8, prompts, toks, counts, "fp8 kv")
    st = fp8._scan_states[prompts.shape[0]]
    check(st.cache.k.dtype == torch.float8_e4m3fn
          and st.cache.v.dtype == torch.float8_e4m3fn,
          f"fp8 kv: cache dtype {st.cache.k.dtype}")
    with counts_kept():
        eager = statistics.median(eager_step_times(fp8, prompts))
        graph = statistics.median(replay_times(fp8, prompts.shape[0], 16))
        prof = profile_replays(_scan_step(fp8, prompts.shape[0]), "fp8 kv",
                               n=2)
    p2 = prompts[:2, :FP8_COPY_SEQ]
    gpu = copy_engine(fp8, 2, "cuda")
    cpu = copy_engine(fp8, 2, "cpu")
    lg_gpu, c_gpu = gpu.prefill(p2)
    tok = lg_gpu.argmax(-1).to(torch.int32)
    step_gpu, _ = gpu.decode_step(tok, c_gpu)
    t0 = time.time()
    lg_cpu, c_cpu = cpu.prefill(p2)
    step_cpu, _ = cpu.decode_step(tok.cpu(), c_cpu)
    _, rel_pre = row_err(lg_gpu.cpu(), lg_cpu)
    _, rel_step = row_err(step_gpu.cpu(), step_cpu)
    log(f"fp8 kv llama3-8b W4A16 ({n_layers} layers, kv_quant fp8, e4m3 "
        f"cache): tokens and launches of generate_scan equal generate's "
        f"({prompts.shape[0]}x{NEW}), replayed launches measured per step "
        f"{json.dumps(prof['launches'])}; graph_step_ms={graph:.4f} "
        f"eager_step_ms={eager:.4f}; 2-layer copy card vs CPU: prefill "
        f"row_err={rel_pre:.4g} decode step row_err={rel_step:.4g} (2 x "
        f"{FP8_COPY_SEQ} prompt tokens; tol "
        f"{COPY_ROW_TOL}, reference_s={time.time() - t0:.1f}); "
        f"fp8_kv_s={time.time() - t_phase:.1f}")
    check(rel_pre <= COPY_ROW_TOL and rel_step <= COPY_ROW_TOL,
          "fp8 kv: the 2-layer copy disagrees with the CPU")
    del fp8, gpu, cpu


# (prompt length, new tokens) of the batching phase: 12 requests over the
# buckets 16..256; the first 8 fill the batch, the rest join as slots free
BATCH_REQUESTS = [(16, 8), (200, 32), (64, 12), (31, 20), (256, 16),
                  (100, 24), (17, 10), (128, 32), (48, 8), (250, 12),
                  (90, 16), (20, 24)]


def batching_phase(eng, seed=21):
    """``ContinuousBatchingEngine`` over the engine (max_batch 8, max_seq
    1024): 12 requests of BATCH_REQUESTS, late joins and slot reuse.  Each
    request's prompt-pass logits and first decode step logits must be
    within ``COPY_ROW_TOL`` row error of the same prompt alone through
    ``prefill`` and ``decode_step`` at batch 1; prints the share of greedy
    tokens equal to batch 1's and the replayed step ms at 8 active
    slots."""
    from autoround_tpu_torch.serve import ContinuousBatchingEngine

    t_phase = time.time()
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, eng.cfg.vocab_size, (n,),
                             generator=gen).tolist()
               for n, _ in BATCH_REQUESTS]
    be = ContinuousBatchingEngine(eng, max_batch=8, max_seq=1024)
    first = {}          # rid → [prompt-pass logits, first step logits]
    joined = {}         # rid → slot, for requests that have not stepped yet
    waiting = list(range(len(BATCH_REQUESTS)))
    rid_of = {}
    step_ms_full, steps = [], 0
    t0 = time.time()
    while waiting or be.pending():
        while waiting and be._free:
            i = waiting.pop(0)
            rid = be.submit(prompts[i], max_new_tokens=BATCH_REQUESTS[i][1])
            rid_of[i] = rid
            joined[rid] = be._requests[rid].slot
            first[rid] = [be.last_logits[joined[rid]].float().cpu()]
        full = len(be._slot_req) == 8
        torch.cuda.synchronize()
        s0 = time.time()
        be.step()
        if full and be._decode.graph is not None and steps > 0:
            step_ms_full.append((time.time() - s0) * 1e3)
        steps += 1
        for rid, slot in joined.items():
            first[rid].append(be.last_logits[slot].float().cpu())
        joined.clear()
    run_s = time.time() - t0
    check(be._decode.graph is not None, "batching: the step was not captured")
    worst = 0.0
    agree = total = 0
    for i, (n, n_new) in enumerate(BATCH_REQUESTS):
        rid = rid_of[i]
        ids = torch.tensor([prompts[i]])
        logits, cache = eng.prefill(ids)
        tok = logits.argmax(-1).to(torch.int32)
        step_logits, _ = eng.decode_step(tok, cache)
        _, r0 = row_err(first[rid][0], logits[0].float().cpu())
        _, r1 = row_err(first[rid][1], step_logits[0].float().cpu())
        worst = max(worst, r0, r1)
        check(r0 <= COPY_ROW_TOL and r1 <= COPY_ROW_TOL,
              f"batching: request {i} (prompt {n}) logits row_err {r0:.4g} / "
              f"{r1:.4g} against batch 1 (tol {COPY_ROW_TOL})")
        got = be.result(rid)
        check(len(got) == n_new, f"batching: request {i} gave {len(got)} "
              f"tokens, asked {n_new}")
        want = eng.generate_scan(ids, max_new_tokens=n_new)[0].tolist()
        agree += sum(a == b for a, b in zip(got, want))
        total += n_new
    full_ms = (statistics.median(step_ms_full) if step_ms_full
               else float("nan"))
    log(f"batching llama3-8b W4A16 ({eng.cfg.num_layers} layers, max_batch "
        f"8, max_seq 1024): {len(BATCH_REQUESTS)} requests (prompts "
        f"{min(n for n, _ in BATCH_REQUESTS)}.."
        f"{max(n for n, _ in BATCH_REQUESTS)}, "
        f"{sum(k for _, k in BATCH_REQUESTS)} new tokens) in {steps} steps, "
        f"run_s={run_s:.2f}; prompt-pass and first-step logits vs batch 1: "
        f"worst row_err={worst:.4g} (tol {COPY_ROW_TOL}); greedy tokens "
        f"equal to batch 1's (generate_scan, whose tokens equal "
        f"generate's): {agree} of {total} ({agree / total:.3f}); "
        f"replayed step at 8 active slots (host, step() with its token "
        f"read-back): median {full_ms:.4f} ms over {len(step_ms_full)} "
        f"steps; capture_ms="
        f"{be._decode.capture_ms:.2f}")
    # where the batcher's step goes: its graph replayed with every slot
    # idle (the same kernels; idle slots only rewrite their next position)
    with counts_kept():
        prof = profile_replays(be._decode, "batching", n=4)
    log(f"batching step profile (4 graph replays, slots idle): kernel_ms="
        f"{prof['kernel_ms']:.4f} of span_ms={prof['span_ms']:.4f} a step, "
        f"busy_share={prof['busy']:.3f}; launches measured per step "
        f"{json.dumps(prof['launches'])}; top per step: {prof['top']}; "
        f"batching_s={time.time() - t_phase:.1f}")
    del be


def rtn_path(bw, flops_peak, n_layers):
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    on_path = ("flash_attention", "w4a16_matmul", "decode_attention")
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(1)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"rtn path llama3-8b ({n_layers} layers, random weights): "
        f"init_s={t_init:.2f}"
        f" quantize_s={t_quant:.2f} pack_s={t_pack:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f}")
    log(f"rtn path kernels {json.dumps(launches)}")
    for n in on_path:
        check(launches[n] > 0, f"kernel {n} was not launched on the rtn path")
    check(toks.shape == (B, NEW), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "tokens out of range")

    prefill_ms, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "cpu")
    scan_path(eng, prompts, toks, gen_counts, "rtn path", step_ms)
    # the scan phase: bench.py's configuration (batch 32, W4A16 g128, int8
    # KV) beside batch 1 and 8
    for b in (1, 8, 32):
        scan_measure(eng, b, S, bw, flops_peak, None, seed=30 + b,
                     label="rtn", second=b == 8, sampled=b == 8,
                     ran=(prompts, step_ms) if b == B else None)
    free_device_memory()
    fp8_kv_phase(eng, prompts)
    free_device_memory()
    batching_phase(eng)
    return launches, dict(quantize_s=t_quant, prefill_ms=prefill_ms,
                          decode_step_ms=step_ms, peak_mem_gb=peak_gb)


# Gradients of the tuning loss of one full-width block w.r.t. the tuned
# leaves, flash kernels (forward + backward) against the plain attention
# under autograd, both on the card in bf16.  The two attentions differ by
# bf16 rounding; the loss gradient carries that through the block, and a
# scale's gradient is a sum of rounding residues of random sign, so its rows
# are noisier than those of v.  Over the seven linears, measured on an H100:
# least share of equal signs 0.9937 (v), 0.9951 (scales); worst row error
# 0.17 (v), 0.20 (min_scale), 0.28 (max_scale).  Limits: about 3x the
# measured share of unequal signs, about 3x the row error.
GRAD_ROW_FLOOR = 0.01
GRAD_LIMITS = {          # kind: (least share of equal signs, row err limit)
    "v": (0.98, 0.5),
    "min_scale": (0.985, 0.6),
    "max_scale": (0.985, 0.85),
}


def tuning_step_phase(bw, flops_peak):
    """Gradient check and the time of one tuning step on one full-width
    llama3-8b block with a batch of 8 x 512."""
    from torch.profiler import ProfilerActivity, profile

    from autoround_tpu_torch.algorithms.signround import (
        TuneConfig, init_tune_params, make_qdq_weights, mse_loss, tune_block)
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.ops.flash_attention import flash_attention_plain
    from autoround_tpu_torch.schemes import parse_scheme

    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"], num_layers=1)
    B, S, NS = 8, 512, 16
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    block = params["blocks"][0]
    ids = torch.randint(0, cfg.vocab_size, (NS, S),
                        generator=torch.Generator().manual_seed(2)).cuda()
    cos, sin = llama.rope_tables(cfg, S, device="cuda")

    def block_fn(w, xb):
        return llama.block_fwd(w, xb, cos, sin, cfg)

    with torch.no_grad():
        x = llama.embed_fwd(params, ids, cfg)
        ref = torch.cat([block_fn(block, x[i:i + B])
                         for i in range(0, NS, B)])
    del params
    schemes = {n: parse_scheme("W4A16") for n in llama.LINEAR_KEYS}
    tcfg = TuneConfig(iters=20, batch_size=B)

    def grads():
        tp = init_tune_params(block, schemes, tcfg)
        leaves = [t.requires_grad_(True) for lp in tp.values()
                  for t in lp.values()]
        with torch.enable_grad():
            out = block_fn(make_qdq_weights(block, tp, schemes, tcfg), x[:B])
            loss = mse_loss(out, ref[:B]) * tcfg.loss_scale
            g = torch.autograd.grad(loss, leaves)
        it = iter(g)
        return loss.item(), {n: {k: next(it) for k in lp}
                             for n, lp in tp.items()}

    loss_k, g_kernel = grads()
    routed = llama.flash_attention
    llama.flash_attention = lambda q, k, v, causal=True: \
        flash_attention_plain(q, k, v, causal)
    try:
        loss_p, g_plain = grads()
    finally:
        llama.flash_attention = routed
    torch.cuda.synchronize()
    check(abs(loss_k - loss_p) <= 0.02 * abs(loss_p),
          f"gradient check: loss {loss_k} (kernels) vs {loss_p} (plain)")
    for kind, (min_sign, max_row) in GRAD_LIMITS.items():
        agree, rel = [], []
        for n in g_plain:
            a, b = g_kernel[n][kind], g_plain[n][kind]
            nz = b != 0
            agree.append((torch.sign(a)[nz] == torch.sign(b)[nz])
                         .float().mean().item())
            rel.append(row_err(a, b, GRAD_ROW_FLOOR)[1])
        log(f"gradient check {kind}: loss kernels={loss_k:.6f} "
            f"plain={loss_p:.6f}; equal signs, least layer "
            f"{min(agree):.4f} (limit {min_sign}) per layer "
            f"{json.dumps([round(a, 4) for a in agree])}; row_err worst "
            f"layer {max(rel):.4g} (limit {max_row}, row floor "
            f"{GRAD_ROW_FLOOR}) per layer "
            f"{json.dumps([round(r, 4) for r in rel])}")
        check(min(agree) >= min_sign and max(rel) <= max_row,
              f"gradient check {kind}: signs {min(agree)} row err {max(rel)}")
    del g_kernel, g_plain

    # one tuning step: long run minus short run over the extra steps
    def run(iters):
        torch.cuda.synchronize()
        t0 = time.time()
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=iters))
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3
    run(2)                                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    steps = sorted((run(8) - run(2)) / 6 for _ in range(3))
    step_ms = steps[1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_w = sum(block[n].numel() for n in schemes)
    valid = S * (S + 1) // 2
    attn = (4 + 14) * B * cfg.num_heads * valid * cfg.hd
    t_f = (3 * 2 * n_w * B * S + attn) / flops_peak * 1e3
    t_b = n_w * (2 + 4 + 4) / bw * 1e3
    log(f"tuning step (1 block, B={B} S={S}, W4A16 g128): tune_step_ms="
        f"{step_ms:.2f} (3 runs {steps[0]:.2f}..{steps[2]:.2f}) "
        f"tune_step_bound_ms={max(t_f, t_b):.3f} (operations {t_f:.3f}, "
        f"bytes of one qdq pass over W, v, grad {t_b:.3f}) "
        f"peak_mem_gb={peak_gb:.2f}")
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=n))
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values()) / n
    family = {"flash kernels": 0.0, "pytorch elementwise and reductions": 0.0,
              "matrix products and the rest": 0.0}
    for kname, (ms, _) in times.items():
        key = ("flash kernels" if "flash_" in kname else
               "pytorch elementwise and reductions" if "at::native" in kname
               else "matrix products and the rest")
        family[key] += ms / n
    log(f"profile tuning step: kernel_ms={total:.2f} of tune_step_ms="
        f"{step_ms:.2f} busy_share={total / step_ms:.3f}; ms per step by "
        f"family {json.dumps({k: round(v, 3) for k, v in family.items()})}; "
        f"top per step: " + _top(times, n))
    return step_ms


class _HeadLosses(logging.Handler):
    """Collects (first, best) of the orchestrator's lm_head log record."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = None

    def emit(self, record):
        if str(record.msg).startswith("lm_head: loss"):
            self.losses = tuple(float(a) for a in record.args)


def tune_path(n_layers):
    """SignRound → pack → serve at llama3-8b width; returns the launches
    and the seconds of the quantize call (tune_s)."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(3)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    head = _HeadLosses()
    pkg_log = logging.getLogger("autoround_tpu_torch")
    pkg_log.addHandler(head)
    pkg_log.setLevel(logging.INFO)
    t0 = time.time()
    try:
        ar = AutoRound((params, cfg), scheme="W4A16", iters=ITERS,
                       batch_size=B, quant_lm_head=True, donate_params=True,
                       cache_batch=CB)
        del params
        result = ar.quantize(calib)
        torch.cuda.synchronize()
    finally:
        pkg_log.removeHandler(head)
    t_tune = time.time() - t0
    traces = result.loss_traces
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    first = [float(traces[b][0]) for b in range(n_layers)]
    best = [float(traces[b].min()) for b in range(n_layers)]
    n_better = sum(b < f for b, f in zip(best, first))
    log(f"tune path llama3-8b ({n_layers} layers + lm_head, random weights, "
        f"{NS} x {S} ids, iters={ITERS}, batch {B}): tune_s={t_tune:.2f} "
        f"pack_s={t_pack:.2f} generate_s={t_gen:.2f} "
        f"peak_mem_gb={peak_gb:.2f}")
    log("tune path losses (first -> best per block): "
        + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best))
        + f"; lm_head {head.losses}; best < first in {n_better} of "
        f"{n_layers} blocks")
    log(f"tune path kernels {json.dumps(launches)}")
    check(len(traces) == n_layers and all(
        len(traces[b]) == ITERS and bool((traces[b] == traces[b]).all())
        and bool(abs(traces[b]).max() < float("inf"))
        for b in range(n_layers)), "tune path: a loss is missing or not finite")
    check(all(b <= f for b, f in zip(best, first)),
          "tune path: a block's best loss is above its first")
    check(4 * n_better >= 3 * n_layers,
          f"tune path: best < first in only {n_better} of {n_layers} blocks")
    check(head.losses is not None and head.losses[1] <= head.losses[0]
          and head.losses[0] < float("inf"),
          f"tune path: lm_head losses {head.losses}")
    # per block: the FP chain and the quantized chain each run NS / CB
    # forwards, every tuning step one forward and one backward; generate's
    # prefill adds one forward per layer
    fwd = n_layers * (2 * (NS // CB) + ITERS) + n_layers
    bwd = n_layers * ITERS
    want = {"flash_attention": fwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd}
    for n, c in want.items():
        check(launches[n] == c,
              f"tune path: {n} launched {launches[n]} times, the loop "
              f"implies {c}")
    for n in ("w4a16_matmul", "decode_attention"):
        check(launches[n] > 0, f"kernel {n} was not launched on the tune path")
    check(toks.shape == (B, NEW), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "tokens out of range")
    scan_path(eng, prompts, toks, gen_counts, "tune path")
    del eng
    torch.cuda.empty_cache()
    return launches, t_tune


# Prefill logits (last position, 8 prompts) of the MoE engine through capacity
# dispatch with factor E / top_k (C = N, nothing drops) against the default
# dense-then-mask route.  The grouped kernel gives a token's row the same
# bits in whatever slab and row it sits, and the two routes share one
# combine, so the logits are expected to be equal; the limit is far below
# what a wrong dispatch gives (a token sent to another expert, dropped or
# weighted wrongly moves its row by order 1) and leaves room for one bf16
# ulp.  (With another summation order in the combine alone, last-bit
# differences in fp32 flip top-k near-ties of the random router in later
# blocks and the row error grows with depth: 0.025 at 2 blocks, 0.061 at 6,
# measured on an H100.)  Same row measure as above.
CAPACITY_ROW_TOL = 0.01


def _serve_counts(n_layers, forwards, decode_steps, per_block, head=True):
    """Launches an RTN run on one calibration batch and one ``generate``
    imply: ``per_block`` packed projections per block per forward (+ the
    lm_head), flash once per block in the calibration forward and once in
    prefill, decode attention once per block per decode step."""
    return dict(matmul=(per_block * n_layers + (1 if head else 0)) * forwards,
                flash_attention=2 * n_layers,
                decode_attention=n_layers * decode_steps)


def _check_tokens(toks, B, n_new, vocab):
    check(toks.shape == (B, n_new), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < vocab)).all()), "tokens out of range")


def moe_path(bw, flops_peak, n_layers):
    """RTN → stack → serve at mixtral-8x7b width; returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import mixtral

    kernels = _kernel_fns()
    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(4)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    def stage_peak():
        """Peak memory since the last call, in GB."""
        gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        return gb

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    peaks_gb = {"quantize": stage_peak()}
    check(len(result.layers) == n_layers * (4 + 3 * cfg.num_experts) + 1,
          f"moe path: {len(result.layers)} quantized layers")
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    peaks_gb["pack"] = stage_peak()
    for i in range(n_layers):
        stacked = sorted(k for k in eng.packed
                         if k.startswith(f"blocks.{i}.experts_stack."))
        check(stacked == [f"blocks.{i}.experts_stack.w{j}" for j in (1, 2, 3)],
              f"moe path: block {i} stacked {stacked}")
    check(not any(".experts." in k for k in eng.packed),
          "moe path: a per-expert entry is left beside the stacks")
    check(eng.moe_capacity_factor == 0.0, "moe path: default routing")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peaks_gb["generate"] = stage_peak()
    torch.cuda.empty_cache()
    log(f"moe path mixtral-8x7b ({n_layers} of 32 layers, random weights, "
        f"E={cfg.num_experts} top_k={cfg.top_k}): init_s={t_init:.2f} "
        f"quantize_s={t_quant:.2f} pack_s={t_pack:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={max(peaks_gb.values()):.2f} "
        f"(by stage {json.dumps({k: round(v, 2) for k, v in peaks_gb.items()})}) "
        f"resident_after_pack_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
    log(f"moe path kernels {json.dumps(launches)}")
    # per block and forward: qkv + o_proj through the ungrouped kernel,
    # w1 / w3 / w2 of all experts through 3 grouped launches
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=2)
    want["w4a16_matmul"] = want.pop("matmul")
    want["w4a16_matmul_grouped"] = 3 * n_layers * NEW
    want.update(w4a16_asym_matmul=0, flash_attention_bwd_dq=0,
                flash_attention_bwd_dkv=0)
    for n, c in want.items():
        check(launches[n] == c, f"moe path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)

    # capacity dispatch with C = N on the same packed weights
    factor = cfg.num_experts / cfg.top_k
    cap = dataclasses.replace(eng, moe_capacity_factor=factor)
    before = kernels["w4a16_matmul_grouped"].launches
    lg_dense, _ = eng.prefill(prompts)
    lg_cap, _ = cap.prefill(prompts)
    torch.cuda.synchronize()
    check(kernels["w4a16_matmul_grouped"].launches - before
          == 2 * 3 * n_layers, "moe path: capacity route left the grouped "
          "kernel")
    err, rel = row_err(lg_cap, lg_dense)
    log(f"moe capacity route (factor {factor}, C = N = {B * S}): prefill "
        f"logits vs dense-then-mask max_abs_err={err:.4g} row_err={rel:.4g} "
        f"(tol {CAPACITY_ROW_TOL}), argmax equal "
        f"{int((lg_cap.argmax(-1) == lg_dense.argmax(-1)).sum())} of {B}")
    check(bool(torch.isfinite(lg_cap).all()) and rel <= CAPACITY_ROW_TOL,
          "moe path: capacity-route logits disagree with the default route")
    t0 = time.time()
    cap.prefill(prompts)
    torch.cuda.synchronize()
    log(f"moe capacity route: prefill_ms={(time.time() - t0) * 1e3:.2f}")
    del cap, lg_dense, lg_cap

    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card", MOE_COPY_ROW_TOL)
    scan_path(eng, prompts, toks, gen_counts, "moe path", step_ms)
    scan_measure(eng, B, S, bw, flops_peak, None, seed=40, label="moe",
                 ran=(prompts, step_ms))
    del eng
    torch.cuda.empty_cache()
    return launches


def moe_tuning_step(bw, flops_peak):
    """Time, peak memory and profile of one SignRound step on one full-width
    Mixtral block (4 + 3 x 8 linears, dense-then-mask), batch 8 x 512."""
    from torch.profiler import ProfilerActivity, profile

    from autoround_tpu_torch.algorithms.signround import TuneConfig, tune_block
    from autoround_tpu_torch.models import llama, mixtral
    from autoround_tpu_torch.schemes import parse_scheme
    from autoround_tpu_torch.utils.pytree import get_by_path

    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=1)
    B, S = 8, 512
    torch.cuda.empty_cache()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    block = params["blocks"][0]
    ids = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(5)).cuda()
    cos, sin = llama.rope_tables(cfg, S, device="cuda")

    def block_fn(w, xb):
        return mixtral.block_fwd(w, xb, cos, sin, cfg)

    with torch.no_grad():
        x = llama.embed_fwd(params, ids, cfg)
        ref = block_fn(block, x)
    del params
    schemes = {n: parse_scheme("W4A16")
               for n in mixtral.block_linear_names(cfg)}
    tcfg = TuneConfig(iters=20, batch_size=B)

    def run(iters):
        torch.cuda.synchronize()
        t0 = time.time()
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=iters))
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    run(1)                                       # warm-up; the peak of a step
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = (run(5) - run(2)) / 3
    n_w = sum(get_by_path(block, n).numel() for n in schemes)
    n_exp_w = 3 * cfg.num_experts * cfg.hidden_size * cfg.intermediate_size
    attn = (4 + 14) * B * cfg.num_heads * (S * (S + 1) // 2) * cfg.hd
    # dense-then-mask: every expert's three products for all B * S tokens
    t_f = (3 * 2 * n_w * B * S + attn) / flops_peak * 1e3
    t_b = n_w * (2 + 4 + 4) / bw * 1e3
    log(f"moe tuning step (1 mixtral-8x7b block, {len(schemes)} linears, "
        f"{n_w / 1e9:.3f}e9 weights of which experts {n_exp_w / 1e9:.3f}e9, "
        f"B={B} S={S}, W4A16 g128): tune_step_ms={step_ms:.2f} "
        f"tune_step_bound_ms={max(t_f, t_b):.3f} (operations {t_f:.3f}, "
        f"bytes of one qdq pass over W, v, grad {t_b:.3f}) "
        f"peak_mem_gb={peak_gb:.2f}")
    n = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=n))
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values()) / n
    family = {"flash kernels": 0.0, "pytorch elementwise and reductions": 0.0,
              "matrix products and the rest": 0.0}
    for kname, (ms, _) in times.items():
        key = ("flash kernels" if "flash_" in kname else
               "pytorch elementwise and reductions" if "at::native" in kname
               else "matrix products and the rest")
        family[key] += ms / n
    log(f"profile moe tuning step: kernel_ms={total:.2f} of tune_step_ms="
        f"{step_ms:.2f} busy_share={total / step_ms:.3f}; ms per step by "
        f"family {json.dumps({k: round(v, 3) for k, v in family.items()})}; "
        f"top per step: " + _top(times, n))


def moe_tune_path(n_layers):
    """SignRound → stack → serve at mixtral-8x7b width."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import mixtral

    kernels = _kernel_fns()
    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(6)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=ITERS, batch_size=B,
                   donate_params=True, cache_batch=CB)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_tune = time.time() - t0
    traces = result.loss_traces
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    toks = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = [float(traces[b][0]) for b in range(n_layers)]
    best = [float(traces[b].min()) for b in range(n_layers)]
    log(f"moe tune path mixtral-8x7b ({n_layers} of 32 layers, random "
        f"weights, {NS} x {S} ids, iters={ITERS}, batch {B}): "
        f"tune_s={t_tune:.2f} peak_mem_gb={peak_gb:.2f}; losses (first -> "
        f"best per block): "
        + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best)))
    log(f"moe tune path kernels {json.dumps(launches)}")
    check(len(traces) == n_layers and all(
        len(traces[b]) == ITERS and bool(abs(traces[b]).max() < float("inf"))
        and bool((traces[b] == traces[b]).all()) for b in range(n_layers)),
        "moe tune path: a loss is missing or not finite")
    check(all(b < f for b, f in zip(best, first)),
          "moe tune path: a block's best loss is not below its first")
    fwd = n_layers * (2 * (NS // CB) + ITERS) + n_layers
    want = {"flash_attention": fwd, "flash_attention_bwd_dq": n_layers * ITERS,
            "flash_attention_bwd_dkv": n_layers * ITERS,
            "w4a16_matmul_grouped": 3 * n_layers * NEW,
            "w4a16_matmul": 2 * n_layers * NEW,      # the lm_head stays dense
            "decode_attention": n_layers * (NEW - 1)}
    for n, c in want.items():
        check(launches[n] == c, f"moe tune path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    del eng
    torch.cuda.empty_cache()


def asym_path(n_layers):
    """int4 asym RTN → the w4a16_asym engine → serve at llama3-8b width;
    returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(7)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    scheme = dict(bits=4, group_size=128, sym=False, data_type="int")
    ar = AutoRound((params, cfg), scheme=scheme, iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    zp = result.layers["blocks.0.q_proj"].zp
    check(zp is not None and float(zp.min()) >= 0 and float(zp.max()) <= 15,
          "asym path: zero points missing or out of range")
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    check(set(eng.packed_kinds.values()) == {"w4a16_asym"}
          and len(eng.packed) == 4 * n_layers + 1
          and all(len(e) == 3 for e in eng.packed.values()),
          f"asym path: packed kinds {sorted(set(eng.packed_kinds.values()))}")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    log(f"asym path llama3-8b ({n_layers} layers, random weights, int4 asym "
        f"g128): generate_s={t_gen:.2f}")
    log(f"asym path kernels {json.dumps(launches)}")
    # per block and forward: qkv, o_proj, gate_up, down_proj
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=4)
    want["w4a16_asym_matmul"] = want.pop("matmul")
    want.update(w4a16_matmul=0, w4a16_matmul_grouped=0)
    for n, c in want.items():
        check(launches[n] == c, f"asym path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    check_copy(eng, prompts, "card")
    scan_path(eng, prompts, toks, gen_counts, "asym path")
    del eng
    torch.cuda.empty_cache()
    return launches


# The static int8 activation scheme of the a8 tune path: W4A8's fields with
# one static scale per layer (amax of the FP pass / 127) instead of a dynamic
# per-tensor one.
STATIC_W4A8 = dict(bits=4, group_size=128, sym=True, data_type="int",
                   act_bits=8, act_group_size=0, act_sym=True,
                   act_data_type="int", act_dynamic=False)


# preset → (serving kind, the wrapper that kind launches)
SERVE_KINDS = {"W4A8": ("w4a8", "w4a8_matmul"), "W8A8": ("w8a8", "w8a8_matmul"),
               "W8A16": ("w8a16", "w8a16_matmul"),
               "W2A16": ("w2a16", "w2a16_matmul"),
               "FP8_STATIC": ("fp8", "fp8_matmul"),
               "MXFP4": ("mxfp4_g32", "mxfp4_matmul"),
               "NVFP4": ("mxfp4_g16", "mxfp4_matmul")}


def serve_path(bw, flops_peak, int8_peak, scheme, n_layers, seed):
    """RTN with a preset that serves through a kind of its own (the 8-bit,
    2-bit and float presets) → that kind → serve at llama3-8b width;
    returns the launches.  The float presets quantize their activations in
    calibration only and serve weight-only, with bf16 activations."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama, parse_scheme
    from autoround_tpu_torch.models import llama

    kind, kernel = SERVE_KINDS[scheme]
    sch = parse_scheme(scheme)
    act = sch.is_act_quantized              # an amax pass in calibration
    int8_act = kind in ("w4a8", "w8a8")     # int8 activations in serving
    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme=scheme, iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    for n, q in result.layers.items():
        block = n != "lm_head"
        check((q.act_scale is not None) == (block and act
                                            and not sch.act_dynamic)
              and (q.act_global_scale is not None)
              == (block and (sch.act_data_type or "").startswith("nv_fp")),
              f"{scheme} path: {n} act scales {q.act_scale} "
              f"{q.act_global_scale}")
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    pack_gb = torch.cuda.max_memory_allocated() / 1e9
    del ar, result
    torch.cuda.reset_peak_memory_stats()
    check(set(eng.packed_kinds.values()) == {kind}
          and len(eng.packed) == 4 * n_layers + 1,
          f"{scheme} path: packed kinds "
          f"{sorted(set(eng.packed_kinds.values()))}, {len(eng.packed)} "
          f"entries")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    gen_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_gb = max(quant_gb, pack_gb, gen_gb)
    log(f"{scheme} path llama3-8b ({n_layers} layers, random weights, kind "
        f"{kind}): quantize_s={t_quant:.2f} pack_s={t_pack:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f} (quantize "
        f"{quant_gb:.2f}, pack {pack_gb:.2f}, generate {gen_gb:.2f})")
    log(f"{scheme} path kernels {json.dumps(launches)}")
    # per block and forward: qkv, o_proj, gate_up, down_proj; an
    # act-quantized scheme adds the amax pass over the FP block (flash once
    # more per block)
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=4)
    want[kernel] = want.pop("matmul")
    if act:
        want["flash_attention"] += n_layers
    for n in kernels:
        want.setdefault(n, 0)
    for n, c in want.items():
        check(launches[n] == c, f"{scheme} path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak,
                              int8_peak if int8_act else None)
    check_copy(eng, prompts, "card", attention=not int8_act)
    scan_path(eng, prompts, toks, gen_counts, f"{scheme} path", step_ms)
    if int8_act:
        for b in (1, 8):
            scan_measure(eng, b, S, bw, flops_peak, int8_peak,
                         seed=seed + 50 + b, label=scheme,
                         ran=(prompts, step_ms) if b == B else None)
    del eng
    torch.cuda.empty_cache()
    return launches, peak_gb


def llama1b_path(bw, flops_peak, n_layers, group_size, seed):
    """llama3.2-1b at full width (hidden 2048, 32 heads, 8 kv heads, head
    dim 64, tied embeddings), RTN W4A16 at ``group_size`` with the lm_head
    quantized → engine → ``generate`` (8 x 512 prompts, 32 new tokens)
    with the int8 KV cache, whose every decode step runs the decode kernel
    at hd 64.  The prompt passes take the plain attention: the flash gate
    needs hd 128 or 256, as the JAX model's needs hd % 128 == 0.  Every
    quantized layer must serve packed (g = 16 too), the launch counts equal
    what the loops imply; timings, and a 2-layer copy against the plain
    versions on the card; returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3.2-1b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    scheme = dict(bits=4, group_size=group_size, sym=True, data_type="int")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme=scheme, iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    dense = [f"blocks.{i}.{n}" for i, blk in enumerate(eng.params["blocks"])
             for n in llama.LINEAR_KEYS if blk.get(n) is not None]
    if eng.params.get("lm_head") is not None:
        dense.append("lm_head")
    check(not dense and set(eng.packed_kinds.values()) == {"w4a16"}
          and len(eng.packed) == 4 * n_layers + 1,
          f"llama3.2-1b g{group_size}: dense layers {dense}, packed kinds "
          f"{sorted(set(eng.packed_kinds.values()))}, {len(eng.packed)} "
          f"entries")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"llama3.2-1b path ({n_layers} layers, random weights, W4A16 "
        f"g{group_size}, hd {cfg.hd}): quantize_s={t_quant:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f} dense_layers=0")
    log(f"llama3.2-1b g{group_size} path kernels {json.dumps(launches)}")
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=4)
    want["w4a16_matmul"] = want.pop("matmul")
    want["flash_attention"] = 0              # hd 64: plain prompt attention
    for n in kernels:
        want.setdefault(n, 0)
    for n, c in want.items():
        check(launches[n] == c, f"llama3.2-1b g{group_size} path: {n} "
              f"launched {launches[n]} times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card")
    label = f"llama3.2-1b g{group_size}"
    scan_path(eng, prompts, toks, gen_counts, label + " path", step_ms)
    if group_size == 128:
        for b in (1, 8):
            scan_measure(eng, b, S, bw, flops_peak, None, seed=seed + 60 + b,
                         label=label, ran=(prompts, step_ms) if b == B
                         else None)
    del eng
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- the Llama family
#
# Four public configurations of the family flags at full width, random
# weights from a seed with every norm gain and bias moved off its initial
# value, W4A16 g128 with the lm_head quantized, the int8 KV cache, greedy.
# preset: (batch, prompt tokens, max_seq, what the path holds on the card)
FAMILY_PATHS = {
    "qwen2.5-7b": (8, 512, 1024, "q/k/v biases after the fused qkv GEMV, "
                   "G = 7 through flash (prefill) and decode"),
    "qwen3-4b": (8, 512, 1024, "qk-norm inside the tuning loss through "
                 "flash forward and backward, G = 4, tied lm_head"),
    "gemma2-2b": (8, 512, 1024, "attention softcap (plain prefill, decode "
                  "kernel), final softcap after the packed lm_head, "
                  "GeGLU, sandwich norms, embed scale, hd 256"),
    "gemma3-12b": (2, 1280, 2048, "the 1024 window biting at prefill (the "
                   "sliding mask) and at every decode step (the decode "
                   "kernel's window), local / global rope, qk-norm with "
                   "the norm offset, hd 256"),
}
FAMILY_NEW = 32


def perturb_gains(params, seed):
    """Move every 1-D leaf (norm gains, q/k norms, biases) of the blocks
    and the final norm by N(0, 0.1), from a seeded generator on the card,
    so each of them counts in the run."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def move(t):
        t.add_(torch.randn(t.shape, generator=gen, device=t.device,
                           dtype=t.dtype), alpha=0.1)

    move(params["norm"])
    for b in params["blocks"]:
        for t in b.values():
            if isinstance(t, torch.Tensor) and t.ndim == 1:
                move(t)


def _attended(cfg, S):
    """Keys each decode query at position S sees, summed over the layers
    (a sliding layer sees at most its window), and the same summed over
    a causal prefill of S rows."""
    from autoround_tpu_torch.models import llama

    step = prefill = 0
    for i in range(cfg.num_layers):
        w = (cfg.sliding_window if llama.layer_is_sliding(cfg, i)
             else None) or S + 1
        step += min(S + 1, w)
        n = min(S, w)                    # rows r < w see r + 1 keys
        prefill += n * (n + 1) // 2 + (S - n) * w
    return step, prefill


def family_path(bw, flops_peak, preset, n_layers, seed, iters=0):
    """RTN (or SignRound with ``iters``) W4A16 g128, the lm_head quantized,
    at the full width of a Llama-family preset and ``n_layers`` of its
    depth → the int8-KV engine → ``generate`` (32 new tokens); launch
    counts equal what the loops imply, the 2-layer copy against the plain
    versions on the card, ``generate_scan`` against ``generate``; the main
    path (qwen2.5-7b) is timed and its replayed step measured at batch 1
    and 8.  Returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    t_path = time.time()
    B, S, max_seq, holds = FAMILY_PATHS[preset]
    NEW, NS, CB = FAMILY_NEW, 16 if iters else B, 8
    kernels = _kernel_fns()
    full = llama.CONFIG_PRESETS[preset]
    cfg = dataclasses.replace(full, num_layers=n_layers)
    ids_gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    perturb_gains(params, seed)
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=iters,
                   batch_size=B, quant_lm_head=True, donate_params=True,
                   cache_batch=CB)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    traces = result.loss_traces
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=max_seq,
                                              kv_quant="int8")
    del ar, result
    dense = [f"blocks.{i}.{n}" for i, blk in enumerate(eng.params["blocks"])
             for n in llama.LINEAR_KEYS if blk.get(n) is not None]
    check(not dense and set(eng.packed_kinds.values()) == {"w4a16"}
          and len(eng.packed) == 4 * n_layers + 1,
          f"{preset} path: dense layers {dense}, packed kinds "
          f"{sorted(set(eng.packed_kinds.values()))}, {len(eng.packed)} "
          f"entries")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    sliding = [i for i in range(n_layers) if llama.layer_is_sliding(cfg, i)]
    flash = (hd % 128 == 0 and S >= 512 and S % 256 == 0
             and not cfg.attn_logit_softcap and cfg.attn_scale is None)
    log(f"{preset} path ({n_layers} of {full.num_layers} layers, full "
        f"width: hidden {cfg.hidden_size}, {nh} / {nkv} heads (G = "
        f"{nh // nkv}), hd {hd}, inter {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}; random weights, gains and biases moved; "
        f"{'SignRound iters=%d' % iters if iters else 'RTN'} W4A16 g128, "
        f"lm_head quantized; {B} x {S} prompts, {NEW} new, int8 KV, max_seq "
        f"{max_seq}): quantize_s={t_quant:.2f} generate_s={t_gen:.2f} "
        f"peak_mem_gb={peak_gb:.2f}; holds: {holds}")
    log(f"{preset} path kernels {json.dumps(launches)}")
    log(f"{preset} path attention: flash (row 1) "
        f"{'at G = %d hd %d' % (nh // nkv, hd) if flash else 'not taken (softcap or attn_scale: the JAX gate)'}"
        f"; decode (row 6) at hd {hd} G {nh // nkv} sm_scale 1/"
        f"{cfg.attn_scale or hd ** 0.5:g} softcap "
        f"{cfg.attn_logit_softcap or 0.0:g}; sliding layers {sliding} of "
        f"{n_layers} with window {cfg.sliding_window} at decode positions "
        f"{S}..{S + NEW - 2} (keys older than pos - window dropped: "
        f"{'yes' if sliding and S > cfg.sliding_window else 'no'})")
    # per block and forward: qkv, o_proj, gate_up, down_proj (+ the lm_head
    # once a forward); calibration runs NS / CB forwards a chain (two chains
    # and a forward and a backward a step when tuning), the prompt pass one
    if iters:
        fwd = n_layers * (2 * (NS // CB) + iters) + n_layers
        bwd = n_layers * iters
    else:
        fwd, bwd = n_layers * (-(-NS // CB)) + n_layers, 0
    want = {"w4a16_matmul": (4 * n_layers + 1) * NEW,
            "decode_attention": n_layers * (NEW - 1),
            "flash_attention": fwd if flash else 0,
            "flash_attention_bwd_dq": bwd if flash else 0,
            "flash_attention_bwd_dkv": bwd if flash else 0}
    for n in kernels:
        want.setdefault(n, 0)
    for n, c in want.items():
        check(launches[n] == c, f"{preset} path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    if iters:
        first = [float(traces[b][0]) for b in range(n_layers)]
        best = [float(traces[b].min()) for b in range(n_layers)]
        check(len(traces) == n_layers and all(
            len(traces[b]) == iters and bool(torch.isfinite(
                torch.as_tensor(traces[b])).all()) for b in range(n_layers)),
            f"{preset} tune: a loss is missing or not finite")
        check(all(b <= f for b, f in zip(best, first)),
              f"{preset} tune: a block's best loss is above its first")
        log(f"{preset} tune path ({NS} x {S} ids, iters={iters}, batch {B}, "
            f"qk_norm={cfg.qk_norm}): tune_s={t_quant:.2f}; losses (first "
            f"-> best per block): "
            + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best))
            + f"; flash forward {launches['flash_attention']}, dQ "
            f"{launches['flash_attention_bwd_dq']}, dK/dV "
            f"{launches['flash_attention_bwd_dkv']} launches")
    step_ms = None
    if preset == "qwen2.5-7b":
        _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card")
    scan_path(eng, prompts, toks, gen_counts, f"{preset} path", step_ms)
    if preset == "qwen2.5-7b":
        for b in (1, 8):
            scan_measure(eng, b, S, bw, flops_peak, None, seed=seed + 70 + b,
                         label=preset, ran=(prompts, step_ms) if b == B
                         else None)
    log(f"{preset} path: path_s={time.time() - t_path:.1f}")
    del eng
    torch.cuda.empty_cache()
    return launches


def a8_modes_path(n_layers):
    """A W4A16 result on the int8 kernel: ``serve_a8`` and ``prefill_a8``;
    returns the launches of the ``prefill_a8`` engine's prefill and decode
    step."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, MAX_SEQ = 8, 512, 1024
    ids_gen = torch.Generator().manual_seed(11)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    exact = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                                kv_quant="int8")
    a8 = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                             kv_quant="int8", serve_a8=True)
    del ar, result
    check(set(exact.packed_kinds.values()) == {"w4a16"}
          and set(a8.packed_kinds.values()) == {"w4a8"},
          "a8 modes: packed kinds")
    check(all(torch.equal(a8.packed[k][0], e[0])
              and torch.equal(a8.packed[k][1], e[1])
              for k, e in exact.packed.items()),
          "a8 modes: serve_a8 packed other words than the exact engine")
    pa8 = dataclasses.replace(exact, prefill_a8=True)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-6)).item()

    def rel_rms(a, b):
        return ((a.float() - b.float()).pow(2).mean().sqrt()
                / b.float().pow(2).mean().sqrt()).item()

    for fn in kernels.values():
        fn.launches = 0
    le, _ = exact.prefill(prompts)
    check(kernels["w4a8_matmul"].launches == 0
          and kernels["w4a16_matmul"].launches == 4 * n_layers + 1,
          "a8 modes: exact engine's prefill launches")
    for fn in kernels.values():
        fn.launches = 0
    la, _ = a8.prefill(prompts)
    check(kernels["w4a16_matmul"].launches == 0
          and kernels["w4a8_matmul"].launches == 4 * n_layers + 1,
          "a8 modes: serve_a8 engine's prefill launches")
    for fn in kernels.values():
        fn.launches = 0
    lp, cache = pa8.prefill(prompts)
    pre = {n: fn.launches for n, fn in kernels.items()}
    # the blocks' projections on the int8 kernel, the lm_head exact
    check(pre["w4a8_matmul"] == 4 * n_layers and pre["w4a16_matmul"] == 1,
          f"a8 modes: prefill_a8 prefill launched {pre}")
    tok = lp.argmax(-1).to(torch.int32)
    step_logits, cache = pa8.decode_step(tok, cache)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    check(launches["w4a8_matmul"] == 4 * n_layers
          and launches["w4a16_matmul"] == 4 * n_layers + 2
          and launches["decode_attention"] == n_layers,
          f"a8 modes: prefill_a8 decode step launched {launches} after {pre}")
    check(bool(torch.isfinite(step_logits).all()), "a8 modes: decode logits")
    r_a8, r_pa8 = rel(la, le), rel(lp, le)
    log(f"a8 modes llama3-8b ({n_layers} layers, W4A16 g128 result): "
        f"prefill logits vs exact A16, max|diff|/max|exact|: serve_a8 "
        f"{r_a8:.4g}, prefill_a8 {r_pa8:.4g} (tol {A8_MODE_TOL}); rms(diff)/"
        f"rms(exact): {rel_rms(la, le):.4g}, {rel_rms(lp, le):.4g}; prefill_a8 "
        f"kernels prefill + 1 decode step {json.dumps(launches)}")
    check(r_a8 < A8_MODE_TOL and r_pa8 < A8_MODE_TOL,
          "a8 modes: prefill logits too far from exact-A16 serving")
    check(r_a8 > 0 and r_pa8 > 0, "a8 modes: the a8 logits equal the exact "
          "ones (the int8 kernel did not run)")
    del cache
    for name, e in (("serve_a8", a8), ("prefill_a8", pa8)):
        toks, gen_counts = generate_counted(e, prompts, 16)
        scan_path(e, prompts, toks, gen_counts, f"a8 modes {name}")
    del exact, a8, pa8
    torch.cuda.empty_cache()
    return launches


def a8_tune_path(n_layers):
    """SignRound with int8 activations in the loss → serve at llama3-8b
    width: W4A8 as shipped (dynamic per-tensor), then static scales with
    act-scale tuning."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(12)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    def init():
        return llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")

    # the static scales before any tuning: amax of the FP pass / 127
    rtn = AutoRound((init(), cfg), scheme=dict(STATIC_W4A8), iters=0,
                    donate_params=True).quantize(calib)
    fixed = {n: q.act_scale for n, q in rtn.layers.items()}
    del rtn
    for label, scheme, kw in (
            ("dynamic", "W4A8", {}),
            ("static + act-scale tuning", dict(STATIC_W4A8),
             dict(enable_act_minmax_tuning=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.time()
        ar = AutoRound((init(), cfg), scheme=scheme, iters=ITERS,
                       batch_size=B, donate_params=True, cache_batch=CB, **kw)
        result = ar.quantize(calib)
        torch.cuda.synchronize()
        t_tune = time.time() - t0
        traces = result.loss_traces
        first = [float(traces[b][0]) for b in range(n_layers)]
        best = [float(traces[b].min()) for b in range(n_layers)]
        check(len(traces) == n_layers and all(
            len(traces[b]) == ITERS and bool((traces[b] == traces[b]).all())
            and bool(abs(traces[b]).max() < float("inf"))
            for b in range(n_layers)),
            f"a8 tune ({label}): a loss is missing or not finite")
        check(all(b <= f for b, f in zip(best, first)),
              f"a8 tune ({label}): a block's best loss is above its first")
        shrink = None
        if kw:
            tcfg = ar.cfg.tune_config()
            ratios = [float(q.act_scale / fixed[n])
                      for n, q in result.layers.items()]
            check(all(q.act_scale is not None and q.act_scale.ndim == 0
                      for q in result.layers.values()),
                  "a8 tune: a static act scale is missing")
            check(all(tcfg.clip_lo <= r <= tcfg.clip_hi * (1 + 1e-6)
                      for r in ratios),
                  f"a8 tune: act scales outside [clip_lo, clip_hi] x amax / "
                  f"127: ratios {ratios}")
            shrink = (min(ratios), max(ratios))
        else:
            check(all(q.act_scale is None for q in result.layers.values()),
                  "a8 tune: a dynamic scheme left a static act scale")
        eng = QuantizedLlama.from_quantize_result(result, cfg,
                                                  max_seq=MAX_SEQ,
                                                  kv_quant="int8")
        del ar, result
        check(set(eng.packed_kinds.values()) == {"w4a8"},
              f"a8 tune ({label}): packed kinds")
        toks = eng.generate(prompts, max_new_tokens=NEW)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in kernels.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"a8 tune path ({label}) llama3-8b ({n_layers} layers, {NS} x "
            f"{S} ids, iters={ITERS}, batch {B}): tune_s={t_tune:.2f} "
            f"peak_mem_gb={peak_gb:.2f}; losses (first -> best per block): "
            + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best))
            + (f"; act scale over amax / 127, least and most: "
               f"{shrink[0]:.4f} {shrink[1]:.4f}" if shrink else ""))
        log(f"a8 tune path ({label}) kernels {json.dumps(launches)}")
        # per block: the amax pass, the FP chain and the quantized chain
        # (NS / CB forwards each), one forward and one backward per step;
        # generate's prefill adds one forward per layer
        fwd = n_layers * (1 + 2 * (NS // CB) + ITERS) + n_layers
        want = {"flash_attention": fwd,
                "flash_attention_bwd_dq": n_layers * ITERS,
                "flash_attention_bwd_dkv": n_layers * ITERS,
                "w4a8_matmul": 4 * n_layers * NEW,   # the lm_head stays dense
                "decode_attention": n_layers * (NEW - 1),
                "w4a16_matmul": 0}
        for n, c in want.items():
            check(launches[n] == c, f"a8 tune ({label}): {n} launched "
                  f"{launches[n]} times, the loops imply {c}")
        _check_tokens(toks, B, NEW, cfg.vocab_size)
        del eng
    torch.cuda.empty_cache()


def mx_tune_path(bw, flops_peak, n_layers):
    """SignRound with MXFP4 (the shared exponent and the rounding offsets
    tuned through the MX qdq, MX activations in the loss) → serve at
    llama3-8b width, timed, and a 2-layer copy against the plain versions;
    returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(17)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="MXFP4", iters=ITERS, batch_size=B,
                   donate_params=True, cache_batch=CB)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_tune = time.time() - t0
    traces = result.loss_traces
    first = [float(traces[b][0]) for b in range(n_layers)]
    best = [float(traces[b].min()) for b in range(n_layers)]
    check(len(traces) == n_layers and all(
        len(traces[b]) == ITERS and bool((traces[b] == traces[b]).all())
        and bool(abs(traces[b]).max() < float("inf"))
        for b in range(n_layers)), "mx tune: a loss is missing or not finite")
    check(all(b <= f for b, f in zip(best, first)),
          "mx tune: a block's best loss is above its first")
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    check(set(eng.packed_kinds.values()) == {"mxfp4_g32"},
          "mx tune: packed kinds")
    t0 = time.time()
    toks = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"mx tune path llama3-8b ({n_layers} layers, {NS} x {S} ids, "
        f"iters={ITERS}, batch {B}): tune_s={t_tune:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f}; losses (first "
        f"-> best per block): "
        + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best)))
    log(f"mx tune path kernels {json.dumps(launches)}")
    # per block: the amax pass, the FP chain and the quantized chain (NS /
    # CB forwards each), one forward and one backward per step; generate's
    # prefill adds one forward per layer
    fwd = n_layers * (1 + 2 * (NS // CB) + ITERS) + n_layers
    want = {"flash_attention": fwd,
            "flash_attention_bwd_dq": n_layers * ITERS,
            "flash_attention_bwd_dkv": n_layers * ITERS,
            "mxfp4_matmul": 4 * n_layers * NEW,   # the lm_head stays dense
            "decode_attention": n_layers * (NEW - 1),
            "w4a16_matmul": 0}
    for n, c in want.items():
        check(launches[n] == c, f"mx tune: {n} launched {launches[n]} times, "
              f"the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card")
    del eng
    torch.cuda.empty_cache()
    return launches


GEMM_SOURCES = ("w4a16_matmul", "w4a16_matmul_grouped", "w4a16_asym_matmul",
                "w8a16_matmul", "w2a16_matmul", "fp8_matmul", "mxfp4_matmul")


def _kernel_name(mangled: str) -> str:
    """`gemm_kernel<0>` for the mangled name of a kernel (template
    instance): the last of its length-prefixed names, then its integer
    template arguments."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.match(r"I((?:L[ij]\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ",".join(re.findall(r"L[ij](\d+)E", args[1])) + ">"
    return name


def build_report(build):
    """The compiler's register and spill lines of every kernel, by function,
    then the flash forward's and backward pair's, the GEMM bodies' and the
    decode kernels' registers, spill bytes, dynamic shared memory and
    resident blocks per SM as the runtime reports them."""
    import ctypes

    for p in sorted(build.BUILD_DIR.glob("*.log")):
        fn = "?"
        for line in p.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = _kernel_name(m[1])
            elif ("registers" in line or "spill stores" in line
                  or "warning" in line):
                log(f"  {p.stem.split('-')[0]} {fn}: {line.strip()}")
    info = (ctypes.c_int * 8)()
    entries = [("flash_attention", f"D={D}", D) for D in (128, 256)]
    entries += [(src, "gemm body", None)
                for src in GEMM_SOURCES + ("w8a8_matmul", "w4a8_matmul")]
    entries.append(("w4a8_matmul", "gemm body g != 128", "any"))
    for src, what, arg in entries:
        if arg is None or arg == "any":
            fn = getattr(build.load(src),
                         f"{src}_gemm_{'any_' if arg else ''}info")
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            build.check(fn(info), f"{src}_gemm_info")
        else:
            fn = build.load(src).flash_attention_fwd_info
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            build.check(fn(arg, info), "flash_attention_fwd_info")
        log(f"  resources {src} {what}: {info[0]} registers, {info[1]} "
            f"spill bytes, {info[2]} bytes of dynamic shared memory, "
            f"{info[3]} blocks per SM")
    fn = build.load("flash_attention_bwd").flash_attention_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for D in (128, 256):
        for which, what in enumerate(("dQ", "dK/dV")):
            build.check(fn(D, which, info), "flash_attention_bwd_info")
            log(f"  resources flash_attention_bwd {what} D={D}: {info[0]} "
                f"registers, {info[1]} spill bytes, {info[2]} bytes of "
                f"dynamic shared memory, {info[3]} blocks per SM")
    # the A16 GEMV (M <= 32) of each format, per n-tile tier (M 8, 16,
    # 32), with its plan (rw row tiles a block, K split over a cluster of
    # kc blocks) at the main path's shapes
    shapes = {"w4a16_matmul_grouped": (("w1", 8, 4096, 14336),
                                       ("w2", 8, 14336, 4096))}
    llama = (("qkv", 1, 4096, 6144), ("down", 1, 14336, 4096),
             ("lm_head", 1, 4096, 128256))
    for src in GEMM_SOURCES:
        fn = getattr(build.load(src), f"{src}_gemv_info")
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        for M in (8, 16, 32):
            plans = []
            for name, E, K, O in shapes.get(src, llama):
                build.check(fn(E, M, K, O, info), f"{src}_gemv_info")
                plans.append(f"{name} rw={info[4]} kc={info[5]}")
            log(f"  resources {src} gemv M<={M}: {info[0]} registers, "
                f"{info[1]} spill bytes, {info[2]} bytes of dynamic shared "
                f"memory, {info[3]} blocks per SM (at the last plan's "
                f"block); plan {', '.join(plans)}")
    # the int8 GEMV (M <= 32) of W8A8 and W4A8 (g = 128) per n-tile tier,
    # with its plan at the decode launches of llama3-8b
    llama8 = llama + (("o_proj", 1, 4096, 4096), ("gate_up", 1, 4096, 28672))
    for src in ("w8a8_matmul", "w4a8_matmul"):
        for M in (1, 8, 16, 32):
            plans = []
            for name, _, K, O in llama8:
                info = a8_gemv_info(src, M, K, O)
                plans.append(f"{name} rw={info[4]} kc={info[5]}")
            log(f"  resources {src} gemv M<={M}: {info[0]} registers, "
                f"{info[1]} spill bytes, {info[2]} bytes of dynamic shared "
                f"memory, {info[3]} blocks per SM (at the last plan's "
                f"block); plan {', '.join(plans)}")
    info = (ctypes.c_int * 8)()
    fn = build.load("sage_attention").sage_attention_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for D in (128, 256):
        for which, what in enumerate(("attention", "key pre-pass")):
            build.check(fn(D, which, info), "sage_attention_info")
            log(f"  resources sage_attention {what} D={D}: {info[0]} "
                f"registers, {info[1]} spill bytes, {info[2]} bytes of "
                f"dynamic shared memory, {info[3]} blocks per SM")
    fn = build.load("decode_attention").decode_attention_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for hd, G in ((128, 4), (128, 7), (64, 4), (256, 4), (256, 8)):
        build.check(fn(hd, G, info), "decode_attention_info")
        for what, i in (("split", 0), ("combine", 4)):
            log(f"  resources decode_attention {what} hd={hd} G={G}: "
                f"{info[i]} registers, {info[i + 1]} spill bytes, "
                f"{info[i + 2]} bytes of dynamic shared memory, "
                f"{info[i + 3]} blocks per SM")


def free_device_memory():
    """Between phases: the moe path peaks at 72 of the card's 80 GB, and
    tensors kept alive by a reference cycle of the phase before (seen once:
    22 GB, until a collection happened to run) would push it over."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rtn-layers", type=int, default=32,
                    help="depth of the RTN -> serve path (default 32)")
    ap.add_argument("--tune-layers", type=int, default=32,
                    help="depth of the SignRound -> serve path (default 32)")
    ap.add_argument("--moe-layers", type=int, default=16,
                    help="depth of the Mixtral RTN -> serve path (default "
                         "16 of 32: the bf16 blocks must fit the card "
                         "beside their packed copies)")
    ap.add_argument("--moe-tune-layers", type=int, default=2,
                    help="depth of the Mixtral SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--asym-layers", type=int, default=4,
                    help="depth of the int4 asym -> serve path (default 4)")
    ap.add_argument("--a8-layers", type=int, default=32,
                    help="depth of the W4A8 -> serve path (default 32)")
    ap.add_argument("--w8a8-layers", type=int, default=32,
                    help="depth of the W8A8 -> serve path (default 32)")
    ap.add_argument("--w8a16-layers", type=int, default=4,
                    help="depth of the W8A16 -> serve path (default 4)")
    ap.add_argument("--a8-modes-layers", type=int, default=4,
                    help="depth of the W4A16 result served with serve_a8 and "
                         "prefill_a8 (default 4)")
    ap.add_argument("--a8-tune-layers", type=int, default=2,
                    help="depth of the W4A8 SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--fp8-layers", type=int, default=32,
                    help="depth of the FP8_STATIC -> serve path (default 32)")
    ap.add_argument("--mxfp4-layers", type=int, default=32,
                    help="depth of the MXFP4 -> serve path (default 32)")
    ap.add_argument("--nvfp4-layers", type=int, default=4,
                    help="depth of the NVFP4 -> serve path (default 4)")
    ap.add_argument("--w2-layers", type=int, default=4,
                    help="depth of the W2A16 -> serve path (default 4)")
    ap.add_argument("--mx-tune-layers", type=int, default=2,
                    help="depth of the MXFP4 SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--llama1b-layers", type=int, default=16,
                    help="depth of the two llama3.2-1b paths (W4A16 g128 "
                         "and g16; default 16, all of them)")
    ap.add_argument("--sage-layers", type=int, default=32,
                    help="layers of prefill attention on the int8-QK path "
                         "(default 32)")
    ap.add_argument("--qwen25-layers", type=int, default=28,
                    help="depth of the qwen2.5-7b RTN -> serve path "
                         "(default 28, all of them)")
    ap.add_argument("--qwen3-tune-layers", type=int, default=2,
                    help="depth of the qwen3-4b SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--gemma2-layers", type=int, default=4,
                    help="depth of the gemma2-2b RTN -> serve path "
                         "(default 4)")
    ap.add_argument("--gemma3-layers", type=int, default=6,
                    help="depth of the gemma3-12b RTN -> serve path "
                         "(default 6: five sliding layers and one global)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (HERE / "autoround_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {HERE} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from autoround_tpu_torch._device import resolve_device
    from autoround_tpu_torch.ops import _build

    resolve_device(None)   # the card; switches TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name}")

    t_run = time.time()

    def mark(phase):
        log(f"phase {phase} ended at run_s={time.time() - t_run:.1f}")

    t0 = time.time()
    secs = _build.build_all()
    log(f"build_s={time.time() - t0:.2f} per source {json.dumps(secs)}")
    build_report(_build)

    bw, fl, i8 = peaks(name)
    timer = Timer()
    rows = kernel_phase(timer, bw, fl)
    rows.update(decode_kernel_phase(timer, bw, fl))
    rows.update(a8_kernel_phase(timer, bw, fl, i8))
    rows.update(float_kernel_phase(timer, bw, fl))
    rows.update(sage_kernel_phase(timer, bw, fl, i8))
    del timer
    mark("kernels")
    rtn_launches, _ = rtn_path(bw, fl, args.rtn_layers)
    free_device_memory()
    mark("rtn, scan, fp8 kv, batching")
    tuning_step_phase(bw, fl)
    free_device_memory()
    launches, _ = tune_path(args.tune_layers)
    free_device_memory()
    mark("grads, tune")
    moe_launches = moe_path(bw, fl, args.moe_layers)
    free_device_memory()
    moe_tuning_step(bw, fl)
    free_device_memory()
    moe_tune_path(args.moe_tune_layers)
    free_device_memory()
    mark("moe, moe tune")
    asym_launches = asym_path(args.asym_layers)
    free_device_memory()
    a8_launches, _ = serve_path(bw, fl, i8, "W4A8", args.a8_layers,
                                seed=8)
    free_device_memory()
    w8a8_launches, _ = serve_path(bw, fl, i8, "W8A8", args.w8a8_layers,
                                  seed=9)
    free_device_memory()
    w8a16_launches, _ = serve_path(bw, fl, i8, "W8A16",
                                   args.w8a16_layers, seed=10)
    free_device_memory()
    modes_launches = a8_modes_path(args.a8_modes_layers)
    free_device_memory()
    a8_tune_path(args.a8_tune_layers)
    free_device_memory()
    mark("asym, a8, a8 modes, a8 tune")
    fp8_launches, fp8_gb = serve_path(bw, fl, i8, "FP8_STATIC",
                                      args.fp8_layers, seed=13)
    free_device_memory()
    mxfp4_launches, mxfp4_gb = serve_path(bw, fl, i8, "MXFP4",
                                          args.mxfp4_layers, seed=14)
    log(f"peak memory: MXFP4 path {mxfp4_gb:.2f} GB, FP8_STATIC path "
        f"{fp8_gb:.2f} GB ({args.mxfp4_layers} / {args.fp8_layers} layers)")
    if args.mxfp4_layers == args.fp8_layers:
        check(mxfp4_gb <= fp8_gb, "the MXFP4 path peaks above the FP8 path")
    free_device_memory()
    nvfp4_launches, _ = serve_path(bw, fl, i8, "NVFP4",
                                   args.nvfp4_layers, seed=15)
    free_device_memory()
    w2_launches, _ = serve_path(bw, fl, i8, "W2A16", args.w2_layers,
                                seed=16)
    free_device_memory()
    mx_tune_launches = mx_tune_path(bw, fl, args.mx_tune_layers)
    free_device_memory()
    mark("float, mx tune")
    l1b_launches = llama1b_path(bw, fl, args.llama1b_layers, 128, seed=19)
    free_device_memory()
    l1b_g16_launches = llama1b_path(bw, fl, args.llama1b_layers, 16,
                                    seed=20)
    free_device_memory()
    sage_launches = sage_path(args.sage_layers)
    mark("llama3.2-1b, sage")
    fam = {}
    for preset, n_layers, seed, iters in (
            ("qwen2.5-7b", args.qwen25_layers, 23, 0),
            ("qwen3-4b", args.qwen3_tune_layers, 24, 20),
            ("gemma2-2b", args.gemma2_layers, 25, 0),
            ("gemma3-12b", args.gemma3_layers, 26, 0)):
        fam[preset] = family_path(bw, fl, preset, n_layers, seed, iters)
        free_device_memory()
    mark("llama family")
    # each kernel's count on the path that is its own: the Llama tune path
    # runs the first five, the moe path the grouped one, the asym path and
    # the three 8-bit paths their kernels; the counts of the other paths
    # ride along where not zero
    launches["w4a16_matmul_grouped"] = moe_launches["w4a16_matmul_grouped"]
    launches["w4a16_asym_matmul"] = asym_launches["w4a16_asym_matmul"]
    launches["w4a8_matmul"] = a8_launches["w4a8_matmul"]
    launches["w8a8_matmul"] = w8a8_launches["w8a8_matmul"]
    launches["w8a16_matmul"] = w8a16_launches["w8a16_matmul"]
    launches["fp8_matmul"] = fp8_launches["fp8_matmul"]
    launches["mxfp4_matmul"] = mxfp4_launches["mxfp4_matmul"]
    launches["w2a16_matmul"] = w2_launches["w2a16_matmul"]
    launches["sage_attention"] = sage_launches["sage_attention"]
    for n, row in rows.items():
        row["launches"] = launches[n]
        for key, other in (("launches_rtn_path", rtn_launches),
                           ("launches_moe_path", moe_launches),
                           ("launches_asym_path", asym_launches),
                           ("launches_a8_modes_path", modes_launches),
                           ("launches_nvfp4_path", nvfp4_launches),
                           ("launches_mx_tune_path", mx_tune_launches),
                           ("launches_llama1b_path", l1b_launches),
                           ("launches_llama1b_g16_path", l1b_g16_launches),
                           ("launches_qwen2.5-7b_path", fam["qwen2.5-7b"]),
                           ("launches_qwen3-4b_tune_path", fam["qwen3-4b"]),
                           ("launches_gemma2-2b_path", fam["gemma2-2b"]),
                           ("launches_gemma3-12b_path", fam["gemma3-12b"])):
            if other[n] and other[n] != row["launches"]:
                row[key] = other[n]
    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
