#!/usr/bin/env python3
"""Host cost of the port's packed-matmul wrappers and of a decode step.

    python3 scripts/torch_decode_host_cost.py [--layers 32] [--rounds 3]

Run from the repository root on a machine with one CUDA card.  Two
measurements, both on the host's clock around CUDA work:

1. calls — 2000 back-to-back calls of each packed-matmul wrapper (W4A16,
   W4A8, W8A8, W8A16) at the llama3-8b qkv shape with M = 8: microseconds
   per call to enqueue, and per call once the device has drained.
2. steps — llama3-8b (random weights, ``--layers`` blocks) RTN-quantized
   with W4A16, W4A8 and W8A8, the three engines resident together and run
   in turns (31 decode steps each after a prefill of 8 x 512 tokens,
   ``--rounds`` rounds): per engine the median time to enqueue a step and
   the median, least and largest time of a step; then cProfile's top
   entries over 10 steps of the W4A16 and the W4A8 engine.

The engines run in turns because host times on a shared machine drift by
tens of percent within minutes: only numbers of one round compare.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import pstats
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from autoround_tpu_torch import AutoRound, QuantizedLlama  # noqa: E402
from autoround_tpu_torch._device import resolve_device  # noqa: E402
from autoround_tpu_torch.models import llama  # noqa: E402
from autoround_tpu_torch.ops import _build  # noqa: E402
from autoround_tpu_torch.ops.qmatmul import pack_w4, w4a16_matmul  # noqa: E402
from autoround_tpu_torch.ops.qmatmul_ext import w8a16_matmul  # noqa: E402
from autoround_tpu_torch.ops.qmatmul_int8 import (  # noqa: E402
    w4a8_matmul, w8a8_matmul)


def calls():
    g = torch.Generator(device="cuda").manual_seed(0)
    M, O, K, N = 8, 6144, 4096, 2000
    x = torch.randn(M, 1, K, generator=g, device="cuda").bfloat16()
    qw = pack_w4(torch.randint(0, 16, (O, K), generator=g, device="cuda"))
    sc = torch.rand(O, K // 128, generator=g, device="cuda") * 0.01
    wi = torch.randint(-128, 128, (O, K), generator=g,
                       device="cuda").to(torch.int8)
    ws = torch.rand(O, generator=g, device="cuda") * 0.01
    fns = {"w4a16": lambda: w4a16_matmul(x, qw, sc, 128),
           "w4a8": lambda: w4a8_matmul(x, qw, sc, 128),
           "w8a8": lambda: w8a8_matmul(x, wi, ws),
           "w8a16": lambda: w8a16_matmul(x, wi, sc, 128)}
    for rep in range(3):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N):
                fn()
            t_host = (time.perf_counter() - t0) / N * 1e6
            torch.cuda.synchronize()
            t_all = (time.perf_counter() - t0) / N * 1e6
            print(f"calls round {rep} {name} (M={M} O={O} K={K}): enqueue "
                  f"{t_host:.1f} us/call, drained {t_all:.1f} us/call",
                  flush=True)


def steps(n_layers: int, rounds: int):
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    gen = torch.Generator().manual_seed(1)
    calib = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    engines = {}
    for scheme in ("W4A16", "W4A8", "W8A8"):
        params = llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        res = AutoRound((params, cfg), scheme=scheme, iters=0,
                        quant_lm_head=True,
                        donate_params=True).quantize(calib)
        del params
        engines[scheme] = QuantizedLlama.from_quantize_result(
            res, cfg, max_seq=1024, kv_quant="int8")
        del res
        torch.cuda.empty_cache()

    def run(eng, n):
        logits, cache = eng.prefill(prompts)
        tok = logits.argmax(-1).to(torch.int32)
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = eng.decode_step(tok, cache)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
            tok = logits.argmax(-1).to(torch.int32)
        return out

    for rnd in range(rounds):
        for name, eng in engines.items():
            o = run(eng, 31)
            print(f"steps round {rnd} {name} ({n_layers} layers): enqueue "
                  f"median {statistics.median(a for a, _ in o):.2f} ms, step "
                  f"median {statistics.median(b for _, b in o):.2f} ms (least "
                  f"{min(b for _, b in o):.2f}, largest "
                  f"{max(b for _, b in o):.2f})", flush=True)
    for name in ("W4A16", "W4A8"):
        eng = engines[name]
        logits, cache = eng.prefill(prompts)
        tok = logits.argmax(-1).to(torch.int32)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(10):
            logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
        prof.disable()
        print(f"cProfile, 10 decode steps, {name}:")
        pstats.Stats(prof).sort_stats("tottime").print_stats(12)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    resolve_device(None)
    _build.build_all()
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    calls()
    steps(args.layers, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
