#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autoround_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 is
the target).  It needs no arguments and no network, and imports neither
JAX nor the JAX package.  Phases, each of which fails the run on error:

1. build   — compile the three CUDA kernels from ``autoround_tpu_torch/
             csrc`` (one nvcc per source, in parallel); print the seconds
             and the compiler's register / spill report.
2. kernels — run each kernel at the main path's shapes against its plain
             PyTorch version on the card (bf16), check the stated
             tolerance, and time kernel, plain version and one library
             call (a yardstick the port never calls) with CUDA events,
             the L2 cache flushed before every timed launch (median of
             several runs), beside the least time the card could take.
3. main    — the port's main path at the full width of ``llama3-8b``
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
4. report  — the card's name and power limit (nvidia-smi), a JSON line of
             per-kernel numbers, and last the line
             {"ok": true, "device": {"platform": "gpu", ...}}.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
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
           "decode_attention": 0.025}
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


def row_err(out, ref):
    """(max |out - ref|, worst row's max |out - ref| over its ref RMS)."""
    d = (out.float() - ref.float()).abs()
    rms = ref.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)
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
        flash_attention, flash_attention_plain)
    from autoround_tpu_torch.ops.qmatmul import (pack_w4, unpack_w4,
                                                 w4a16_matmul,
                                                 w4a16_matmul_plain)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    # K1 flash attention forward: calibration / prefill shapes
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

        def lib():   # SDPA's is_causal is top-left: bottom-right needs a bias
            if S == T:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=causal_lower_right(S, T), enable_gqa=True)
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
        del q, k, v, out, lse, pout, plse

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


def main_path(bw, flops_peak):
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.ops.decode_attention import decode_attention
    from autoround_tpu_torch.ops.flash_attention import flash_attention
    from autoround_tpu_torch.ops.qmatmul import w4a16_matmul

    kernels = {"flash_attention": flash_attention,
               "w4a16_matmul": w4a16_matmul,
               "decode_attention": decode_attention}
    cfg = llama.CONFIG_PRESETS["llama3-8b"]
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
    log(f"main path llama3-8b (32 layers, random weights): init_s={t_init:.2f}"
        f" quantize_s={t_quant:.2f} pack_s={t_pack:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f}")
    log(f"kernels {json.dumps(launches)}")
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was not launched on the main path")
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


def main() -> int:
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
    launches, _ = main_path(bw, fl)
    for n, row in rows.items():
        row["launches"] = launches[n]
    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
