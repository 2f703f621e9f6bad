#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autoround_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 is
the target).  It needs no arguments and no network, and imports neither
JAX nor the JAX package.  Phases, each of which fails the run on error:

1. build   — compile the CUDA sources of ``autoround_tpu_torch/csrc`` (one
             nvcc per source, in parallel); print the seconds and the
             compiler's register / spill report.
2. kernels — run each of the five kernels (flash forward, flash backward
             dQ and dK/dV, W4A16 matmul, int8-KV decode attention) at the
             main paths' shapes against its plain PyTorch version on the
             card (bf16), check the stated tolerance (and, for the
             backward pair, that two launches give the same bits), and
             time kernel, plain version and one library call (a yardstick
             the port never calls) with CUDA events, the L2 cache flushed
             before every timed launch (median of several runs), beside
             the least time the card could take.
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
6. report  — the card's name and power limit (nvidia-smi), a JSON line of
             per-kernel numbers, and last the line
             {"ok": true, "device": {"platform": "gpu", ...}}.

``--rtn-layers N`` and ``--tune-layers N`` cut the depth of the two paths
for a quicker run; with no arguments both run all 32 layers.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100": (3.35e12, 989e12)}

# Kernel vs plain version on the card, bf16 out on both sides.  Error
# measure: in each output row (last axis) max |kernel - plain| over the RMS
# of the plain row, worst row counted.  Rows are held to their own scale
# because attention rows differ in size: row 0 of a causal output is one
# value row, rows that average hundreds of keys are ~10x smaller.  Each
# limit is about 3x the worst row error measured on an H100 (flash 0.034,
# the same as SDPA's against the plain version; W4A16 0.037; decode
# attention 0.0072; PERF.md).
ROW_TOL = {"flash_attention": 0.1, "w4a16_matmul": 0.1,
           "decode_attention": 0.025,
           # backward pair vs flash_attention_bwd_plain: measured worst rows
           # dQ 0.027, dK / dV 0.023 (S = T = 512 and S = 256, T = 512)
           "flash_attention_bwd_dq": 0.07, "flash_attention_bwd_dkv": 0.07}
# A gradient row may be zero in exact arithmetic (row 0 of dQ when S = T: one
# visible key, P = 1, dS = 0), so rows smaller than this share of the whole
# tensor's RMS are held to that scale instead of their own.
BWD_ROW_FLOOR = 0.01
LSE_ATOL = 1e-5          # lse is fp32 on both sides (~1e-6 measured)
# the library yardstick must compute the same function: a wrong causal
# anchor (top-left instead of bottom-right) gives row errors of order 10
LIB_ROW_TOL = 0.1
# step-1 logits of the 2-layer engine copy, kernels on the card vs plain
# versions on the CPU (bf16 activations through 2 blocks and the lm_head);
# same row measure, about 3x the measured error (0.049)
COPY_ROW_TOL = 0.15


def log(*a):
    print(*a, flush=True)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    log(f"unknown card {name!r}: bounds use the H100 SXM peaks")
    return PEAKS["H100"]


class Timer:
    """CUDA-event timing of single launches, L2 flushed before each."""

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


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def kernel_phase(timer, bw, flops_peak):
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from autoround_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_plain, flash_attention_plain)
    from autoround_tpu_torch.ops.qmatmul import (pack_w4, unpack_w4,
                                                 w4a16_matmul,
                                                 w4a16_matmul_plain)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    # K1 flash attention, forward then backward: calibration / tuning /
    # prefill shapes
    for (B, H, Hkv, S, T, rep_row) in [(8, 32, 8, 512, 512, True),
                                       (8, 32, 8, 256, 512, False)]:
        q = torch.randn(B, H, S, 128, generator=g, device=dev).bfloat16()
        k = torch.randn(B, Hkv, T, 128, generator=g, device=dev).bfloat16()
        v = torch.randn(B, Hkv, T, 128, generator=g, device=dev).bfloat16()
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
        b_ms, b_by = bound(nbytes, 4 * B * H * valid * 128)
        shape = f"B={B} H={H} Hkv={Hkv} S={S} T={T} D=128 causal"
        log(f"kernel flash_attention [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) lse_err={lerr:.3g} "
            f"(tol {LSE_ATOL}) library_row_err={lib_rel:.3g} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
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
        do = torch.randn(B, H, S, 128, generator=g, device=dev).bfloat16()
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
        plain_ms = timer(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, True))
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
            nbytes, n_prod = work[name]
            b_ms, b_by = bound(nbytes, 2 * n_prod * B * H * valid * 128)
            log(f"kernel {name} [{shape}] max_abs_err={err:.3g} "
                f"row_err={rel:.3g} (tol {tol}, row floor {BWD_ROW_FLOOR}) "
                f"run_to_run=equal library_row_err={lib_rel:.3g} "
                f"kernel_ms={ms:.4f} plain_ms(dq+dk+dv)={plain_ms:.4f} "
                f"library_ms(dq+dk+dv)={lib_ms:.4f} bound_ms={b_ms:.4f} "
                f"({b_by})")
            if rep_row:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="autoround_tpu_torch/csrc/flash_attention_bwd.cu",
                    replaces=f"autoround_tpu/ops/flash_attention.py:{line}",
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, k, v, out, lse, do, delta, got, again, first, plain, pdq, pdk
        del pdv, ql, kl, vl, lib_out
        torch.cuda.empty_cache()

    # K2 W4A16: fused qkv, down_proj, lm_head at decode and prefill M
    for (M, O, K, name) in [(8, 6144, 4096, "qkv"),
                            (8, 4096, 14336, "down_proj"),
                            (8, 128256, 4096, "lm_head"),
                            (4096, 6144, 4096, "qkv"),
                            (4096, 4096, 14336, "down_proj"),
                            (4096, 128256, 4096, "lm_head")]:
        codes = torch.randint(0, 16, (O, K), generator=g, device=dev)
        sc = (torch.rand(O, K // 128, generator=g, device=dev) - 0.5) * 0.02
        qw = pack_w4(codes)
        del codes
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        y = w4a16_matmul(x, qw, sc, 128)
        yp = w4a16_matmul_plain(x, qw, sc, 128)
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del yp
        tol = ROW_TOL["w4a16_matmul"]
        check(rel <= tol, f"w4a16 M={M} O={O} K={K}: row err {rel}")
        ms = timer(lambda: w4a16_matmul(x, qw, sc, 128))
        plain_ms = timer(lambda: w4a16_matmul_plain(x, qw, sc, 128))
        w_bf16 = ((unpack_w4(qw) - 8).float()
                  * sc.repeat_interleave(128, dim=1)).bfloat16()
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        del w_bf16
        nbytes = 2 * M * K + O * K // 2 + 4 * sc.numel() + 2 * M * O
        b_ms, b_by = bound(nbytes, 2 * M * O * K)
        shape = f"{name} M={M} O={O} K={K} g=128"
        log(f"kernel w4a16_matmul [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if M == 8 and name == "qkv":
            rows["w4a16_matmul"] = dict(
                name="w4a16_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w4a16_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul.py:168",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del qw, sc, x, y
        torch.cuda.empty_cache()

    # K3 int8-KV decode attention: B=8, T=1024, G=4 (llama3-8b heads)
    B, T, nkv, G = 8, 1024, 8, 4
    nh = nkv * G
    q = torch.randn(B, nh, 128, generator=g, device=dev).bfloat16()
    kc = torch.randint(-127, 128, (B, T, nkv, 128), generator=g,
                       device=dev).to(torch.int8)
    vc = torch.randint(-127, 128, (B, T, nkv, 128), generator=g,
                       device=dev).to(torch.int8)
    ks = torch.rand(nkv, generator=g, device=dev) * 0.02 + 0.01
    vs = torch.rand(nkv, generator=g, device=dev) * 0.02 + 0.01
    sinks = torch.randn(nh, generator=g, device=dev)
    sm = 128 ** -0.5
    for pos, window, use_sinks in [(511, None, False), (700, None, False),
                                   (700, 256, True)]:
        sk = sinks if use_sinks else None
        pv = torch.full((B,), pos, dtype=torch.int32, device=dev)
        o = decode_attention(q, kc, vc, pv, ks, vs, sm, window=window,
                             sinks=sk)
        op = decode_attention_plain(q, kc, vc, pv, ks, vs, sm, window=window,
                                    sinks=sk)
        torch.cuda.synchronize()
        err, rel = row_err(o, op)
        tol = ROW_TOL["decode_attention"]
        check(rel <= tol, f"decode pos={pos}: row err {rel}")
        ms = timer(lambda: decode_attention(q, kc, vc, pv, ks, vs, sm,
                                            window=window, sinks=sk))
        plain_ms = timer(lambda: decode_attention_plain(
            q, kc, vc, pv, ks, vs, sm, window=window, sinks=sk))
        lib_ms = None
        if window is None and not use_sinks:
            kd = (kc[:, :pos + 1].float() * ks.view(1, 1, nkv, 1)) \
                .bfloat16().transpose(1, 2).contiguous()
            vd = (vc[:, :pos + 1].float() * vs.view(1, 1, nkv, 1)) \
                .bfloat16().transpose(1, 2).contiguous()
            q4 = q[:, :, None]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q4, kd, vd, enable_gqa=True))
            del kd, vd
        n_tok = min(pos + 1, window or pos + 1)
        nbytes = 2 * q.numel() * 2 + 2 * B * n_tok * nkv * 128 + 8 * nkv
        b_ms, b_by = bound(nbytes, 4 * B * nh * n_tok * 128)
        shape = (f"B={B} T={T} nh={nh} nkv={nkv} pos={pos}"
                 + (f" window={window} sinks" if window else ""))
        log(f"kernel decode_attention [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if pos == 511 and window is None:
            rows["decode_attention"] = dict(
                name="decode_attention", route="cuda",
                source="autoround_tpu_torch/csrc/decode_attention.cu",
                replaces="autoround_tpu/ops/decode_attention.py:240",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    del q, kc, vc
    torch.cuda.empty_cache()
    return rows


def copy_engine(eng, n_layers, device):
    """The first ``n_layers`` blocks of an engine, on ``device``."""
    import dataclasses

    from autoround_tpu_torch import QuantizedLlama

    cfg = dataclasses.replace(eng.cfg, num_layers=n_layers)

    def mv(t):
        return None if t is None else t.to(device)

    params = {k: mv(v) for k, v in eng.params.items() if k != "blocks"}
    params["blocks"] = [{k: mv(v) for k, v in b.items()}
                        for b in eng.params["blocks"][:n_layers]]
    keep = {f"blocks.{i}." for i in range(n_layers)}
    packed = {k: tuple(mv(t) for t in e) for k, e in eng.packed.items()
              if k == "lm_head" or any(k.startswith(p) for p in keep)}
    return QuantizedLlama(cfg=cfg, params=params, packed=packed,
                          max_seq=eng.max_seq, kv_quant=eng.kv_quant,
                          fused_splits=eng.fused_splits,
                          device=torch.device(device))


def _kernel_times(prof):
    """{kernel name: (total ms, launches)} over the device-side events of a
    profile (each kernel counted once; CUPTI's own overhead markers out)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "Command Buffer" in e.name:
            continue
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


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
    log(f"profile decode step: kernel_ms={total:.3f} of step_ms="
        f"{step_ms:.3f} busy_share={total / step_ms:.3f}; top per step: "
        + _top(times, n))


def serve_bounds(eng, B, S, bw, flops_peak):
    """Least times the card could take for one prefill of B x S tokens and
    for the first decode step after it (pos = S): the larger of bytes over
    bandwidth and FLOPs over the bf16 peak.  Prefill FLOPs: every block
    weight for all B*S tokens, the lm_head for the last position only (the
    engine runs it there alone), causal attention.  Bytes: the packed
    weights and scales and the dense leaves once, the embedding rows
    used, the int8 cache written (prefill) or read up to pos (decode)."""
    cfg = eng.cfg
    L, hid, hd, V = cfg.num_layers, cfg.hidden_size, cfg.hd, cfg.vocab_size
    H, Hkv, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    w_block = hid * (H + 2 * Hkv) * hd + H * hd * hid + 3 * hid * inter

    def nbytes(t):
        return 0 if t is None else t.numel() * t.element_size()
    w_bytes = sum(nbytes(t) for e in eng.packed.values() for t in e)
    w_bytes += sum(nbytes(t) for k, t in eng.params.items()
                   if k not in ("blocks", "embed_tokens"))
    w_bytes += sum(nbytes(t) for b in eng.params["blocks"] for t in b.values())
    row = hid * eng.params["embed_tokens"].element_size()
    kv_tok = 2 * L * B * Hkv * hd            # int8 k and v of one position
    pre_flops = (2 * B * S * w_block * L + 2 * B * hid * V
                 + 4 * B * H * hd * (S * (S + 1) // 2) * L)
    pre_bytes = w_bytes + B * S * row + S * kv_tok
    step_flops = 2 * B * (w_block * L + hid * V) + 4 * B * H * hd * (S + 1) * L
    step_bytes = w_bytes + B * row + (S + 1) * kv_tok
    return (max(pre_bytes / bw, pre_flops / flops_peak) * 1e3,
            max(step_bytes / bw, step_flops / flops_peak) * 1e3)


def _kernel_fns():
    from autoround_tpu_torch.ops.decode_attention import decode_attention
    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from autoround_tpu_torch.ops.qmatmul import w4a16_matmul

    return {"flash_attention": flash_attention,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "w4a16_matmul": w4a16_matmul,
            "decode_attention": decode_attention}


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
    toks = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
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

    # timing of the same path: prefill, then decode steps
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.time() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    tok = logits.argmax(-1).to(torch.int32)
    steps = []
    for _ in range(NEW - 1):
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
    pre_bound, step_bound = serve_bounds(eng, B, S, bw, flops_peak)
    log(f"serve bounds: prefill_bound_ms={pre_bound:.3f} (FLOPs) "
        f"decode_step_bound_ms={step_bound:.4f} (bytes, pos={S})")
    del cache, logits
    profile_serving(eng, prompts, prefill_ms, step_ms)

    # 2-layer copy: kernels on the card vs plain versions on the CPU
    n_cmp = 2
    p2 = prompts[:n_cmp]
    gpu = copy_engine(eng, 2, "cuda")
    lg_gpu, _ = gpu.prefill(p2)
    tok_gpu = gpu.generate(p2, max_new_tokens=8).cpu()
    cpu = copy_engine(eng, 2, "cpu")
    t0 = time.time()
    lg_cpu, cache = cpu.prefill(p2)
    logits = lg_cpu
    ref_logits = [logits]
    tok_cpu = [logits.argmax(-1).to(torch.int32)]
    for _ in range(7):
        logits, cache = cpu.decode_step(tok_cpu[-1], cache)
        ref_logits.append(logits)
        tok_cpu.append(logits.argmax(-1).to(torch.int32))
    tok_cpu = torch.stack(tok_cpu, 1)
    t_cpu = time.time() - t0
    err, rel = row_err(lg_gpu.cpu(), lg_cpu)
    log(f"2-layer copy: step-1 logits max_abs_err={err:.4g} row_err="
        f"{rel:.4g} (tol {COPY_ROW_TOL}) cpu_s={t_cpu:.1f}")
    check(rel <= COPY_ROW_TOL, "2-layer copy: step-1 logits disagree")
    # greedy tokens: equal step by step; at the first step where they
    # differ (if any), the card's token must be a near-tie of the plain
    # choice — within the row tolerance of the CPU maximum — and the
    # comparison stops there (the two sequences' contexts diverge)
    n_equal = 0
    for i, lg in enumerate(ref_logits):
        if torch.equal(tok_gpu[:, i], tok_cpu[:, i]):
            n_equal = i + 1
            continue
        lg = lg.float()
        picked = lg.gather(1, tok_gpu[:, i:i + 1].long())[:, 0]
        gap = (lg.max(-1).values - picked) / lg.pow(2).mean(-1).sqrt()
        check(gap.max().item() <= COPY_ROW_TOL,
              f"2-layer copy: step {i} card token is {gap.tolist()} row "
              f"RMS below the plain maximum (tol {COPY_ROW_TOL})")
        break
    log(f"2-layer copy tokens: card {tok_gpu.tolist()} cpu {tok_cpu.tolist()}"
        f" equal for {n_equal} of {len(ref_logits)} steps")
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
    """SignRound → pack → serve at llama3-8b width; returns the launches."""
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
    toks = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
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
    del eng
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rtn-layers", type=int, default=32,
                    help="depth of the RTN -> serve path (default 32)")
    ap.add_argument("--tune-layers", type=int, default=32,
                    help="depth of the SignRound -> serve path (default 32)")
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

    t0 = time.time()
    secs = _build.build_all()
    log(f"build_s={time.time() - t0:.2f} per source {json.dumps(secs)}")
    for p in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in p.read_text().splitlines():
            if "registers" in line or "spill stores" in line:
                log(f"  {p.stem.split('-')[0]}: {line.strip()}")

    bw, fl = peaks(name)
    rows = kernel_phase(Timer(), bw, fl)
    rtn_launches, _ = rtn_path(bw, fl, args.rtn_layers)
    torch.cuda.empty_cache()
    tuning_step_phase(bw, fl)
    torch.cuda.empty_cache()
    launches = tune_path(args.tune_layers)
    for n, row in rows.items():
        # counts of this slice's path, which runs all five kernels; the RTN
        # path's counts of the three it runs ride along
        row["launches"] = launches[n]
        if rtn_launches[n]:
            row["launches_rtn_path"] = rtn_launches[n]
    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
