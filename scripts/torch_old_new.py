#!/usr/bin/env python3
"""Time two builds of the port's CUDA kernels against each other on one card.

    python3 scripts/torch_old_new.py OLD_DIR

OLD_DIR holds another version of ``autoround_tpu_torch/csrc`` (for example
the parent commit's: ``git archive HEAD autoround_tpu_torch/csrc | tar -x
--strip-components=2 -C OLD_DIR``).  Every source the cases below use is
built from it with the port's own nvcc flags, next to the sources, and the
wrappers are pointed at the old or the new library in turns by swapping
``_build._libs`` (a wrapper fetches its entry point on every call).  For
each case the two outputs are compared (bit-equal, or the worst row's max
|new - old| over the row's RMS), then each version is timed in the order
old, new, new, old: event time of one call with the L2 flushed (as
``chip_smoke.py`` times, the wrapper's Python included) and device time
(the kernels' own, torch.profiler).  Cases: rows 2 and 3 (the flash
backward pair, dQ and dK/dV) at the three shapes of ``chip_smoke.py``'s
flash phase (B8 H32 Hkv8 causal: S=T=512 D128, S=256 T=512 D128, S=T=512
D256; their outputs are compared by row error with the backward's row
floor: the summation order differs), row 6 (decode) at every shape of
``chip_smoke.py``'s decode phase, rows 7 and 8 (W8A8, W4A8 g128) at M =
4096 for llama3-8b's qkv, down_proj and lm_head, the seven A16 GEMM
bodies at M = 4096 qkv (bit-equality of the shared tiles), the A16 GEMV
(M <= 32) of all seven sources at M = 8 for qkv, down_proj and lm_head
(the grouped one: mixtral-8x7b's w1 and w2 at E = 8, C = 8), rows 4 and 5
at M = 1 (batch-1 decode) for every projection of llama3-8b, mixtral-8x7b
and llama3.2-1b (``DECODE_SHAPES``) beside the library call on the
dequantized bf16 weight (``torch.matmul``; the experts ``torch.bmm``), row
4 also at M = 16 and 32 for qkv and lm_head, rows 7 and 8 (the int8 GEMV,
W8A8 and W4A8 g128, fp32 out: W8A8 must stay bit-equal, W4A8 within
``chip_smoke.W4A8_F32_ROW_TOL``) at M = 1, 8, 16 and 32 for every decode
launch of llama3-8b, and row 14 (int8-QK attention) at ``chip_smoke.py``'s three
shapes.  Then, with every
kernel above old and then new, ``chip_smoke.py``'s tuning step (gradient
check, step ms; turns old, new, new, old), its llama3-8b tune path at 32
layers (old, new) for ``tune_s``, and the mixtral-8x7b decode step at
``MOE_LAYERS`` layers (RTN W4A16 g128, 8 x 512 prompts, int8 KV; turns
old, new, new, old of 8 steps each, their median, and the device time of
one profiled step: all kernels and the GEMVs').  ``--only gemv,sage,moe``
runs just those groups (``a8gemv``: rows 7 and 8 at decode).  Prints one JSON line per case, the card's name
and power limit, and writes all of it to ``chiprun_out/old_new.json``.
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from autoround_tpu_torch._device import resolve_device  # noqa: E402
from autoround_tpu_torch.ops import _build  # noqa: E402

NAMES = ("flash_attention_bwd", "decode_attention", "w8a8_matmul",
         "w4a8_matmul", "w4a16_matmul", "w4a16_matmul_grouped",
         "w4a16_asym_matmul", "w8a16_matmul", "w2a16_matmul", "fp8_matmul",
         "mxfp4_matmul", "sage_attention")
GROUPS = ("flash", "decode", "int8", "gemm", "gemv", "a8gemv", "sage", "tune",
          "moe")
# mixtral-8x7b blocks of the decode step: 4 of 32 fit the card with room
# to spare beside both builds and keep the RTN pass that packs them short;
# a block's share of the step does not depend on the depth
MOE_LAYERS = 4
# the GEMV launches of one decode step, (model, projection, E, O, K): the
# engine fuses q/k/v and gate/up along O; mixtral's experts run as one
# grouped launch each of w1, w3 (x shared) and w2 (x an expert's own), its
# qkv and o_proj are llama3-8b's
DECODE_SHAPES = (
    ("llama3-8b", "qkv", 1, 6144, 4096),
    ("llama3-8b", "o_proj", 1, 4096, 4096),
    ("llama3-8b", "gate_up", 1, 28672, 4096),
    ("llama3-8b", "down_proj", 1, 4096, 14336),
    ("llama3-8b", "lm_head", 1, 128256, 4096),
    ("mixtral-8x7b", "w1 / w3", 8, 14336, 4096),
    ("mixtral-8x7b", "w2", 8, 4096, 14336),
    ("mixtral-8x7b", "lm_head", 1, 32000, 4096),
    ("llama3.2-1b", "qkv", 1, 3072, 2048),
    ("llama3.2-1b", "o_proj", 1, 2048, 2048),
    ("llama3.2-1b", "gate_up", 1, 16384, 2048),
    ("llama3.2-1b", "down_proj", 1, 2048, 8192),
    ("llama3.2-1b", "lm_head", 1, 128256, 2048))


def build_old(old: Path) -> dict:
    procs = {}
    for n in NAMES:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(old / f"{n}.so"),
               str(old / f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"old {n} failed to build:\n{out}")
    return {n: ctypes.CDLL(str(old / f"{n}.so")) for n in NAMES}


def moe_decode(n_layers, use) -> dict:
    """The mixtral-8x7b decode step (RTN W4A16 g128 at ``n_layers`` of 32
    blocks, 8 prompts of 512 tokens, int8 KV) with the old and the new
    kernels in turns: the median of 8 steps a turn (host clock around each
    synchronised step), and one profiled step a turn (kernel time, its
    share of the step, and the GEMVs' part: the grouped experts', the
    attention projections' and the lm_head's)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile

    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=n_layers)
    ids = torch.Generator().manual_seed(4)
    calib = torch.randint(0, cfg.vocab_size, (8, 512), generator=ids)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), generator=ids)
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=1024,
                                              kv_quant="int8")
    del ar, result
    cs.free_device_memory()
    use("new")
    logits, cache = eng.prefill(prompts)
    tok = logits.argmax(-1).to(torch.int32)
    out = {w: {"step_ms": [], "kernel_ms": [], "gemv_ms": []}
           for w in ("old", "new")}
    for w in ("old", "new", "new", "old"):
        use(w)
        logits, cache = eng.decode_step(tok, cache)      # warm-up
        torch.cuda.synchronize()
        steps = []
        for _ in range(8):
            t0 = time.time()
            logits, cache = eng.decode_step(tok, cache)
            torch.cuda.synchronize()
            steps.append((time.time() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            logits, cache = eng.decode_step(tok, cache)
            torch.cuda.synchronize()
        times = cs._kernel_times(prof)
        out[w]["step_ms"].append(statistics.median(steps))
        out[w]["kernel_ms"].append(sum(ms for ms, _ in times.values()))
        out[w]["gemv_ms"].append(sum(ms for n, (ms, _) in times.items()
                                     if "gemv_kernel" in n))
    finite = bool(torch.isfinite(logits).all())
    del eng, cache, logits
    cs.free_device_memory()
    return dict(case=f"mixtral-8x7b decode step ({n_layers} layers, W4A16 "
                     f"g128, B8 after 512, int8 KV)", finite=finite, **out)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated groups of {GROUPS}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    only = set(args.only.split(","))
    old_dir = Path(args.old_dir).resolve()
    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    _build.build_all(list(NAMES))
    libs = {"old": build_old(old_dir),
            "new": {n: _build.load(n) for n in NAMES}}
    print(f"builds {time.time() - t0:.1f} s", flush=True)

    def use(which):
        for n in NAMES:
            _build._libs[n] = libs[which][n]

    timer = cs.Timer()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []

    def run(case, fn, n_ops=None, floor=0.0, fn_old=None, tol=None,
            lib=None):
        """`fn_old`: the old version's call where its C interface differs;
        `tol`: the row error new against old must stay within it (None:
        not checked); `lib`: one PyTorch call computing the same function,
        whose device time is recorded beside."""
        use("old")
        y0 = (fn_old or fn)()
        use("new")
        y1 = fn()
        torch.cuda.synchronize()
        if not isinstance(y0, tuple):
            y0, y1 = (y0,), (y1,)
        equal = all(torch.equal(a, b) for a, b in zip(y0, y1))
        rel = 0.0 if equal else max(cs.row_err(b, a, floor)[1]
                                    for a, b in zip(y0, y1))
        ms = {"old": [], "new": []}
        device_ms = {"old": [], "new": []}
        for w in ("old", "new", "new", "old"):
            use(w)
            f = fn_old if fn_old and w == "old" else fn
            ms[w].append(timer(f))
            device_ms[w].append(timer.device(f)[0])
        use("new")
        o, n = (statistics.mean(device_ms[v]) for v in ("old", "new"))
        r = dict(case=case, bit_equal=equal, row_err_new_vs_old=rel,
                 ms=ms, device_ms=device_ms, device_speedup=o / n)
        if tol is not None:
            r["within_tol"] = rel <= tol
        if lib is not None:
            r["library_device_ms"] = timer.device(lib)[0]
        if n_ops:
            r["device_tops"] = {v: n_ops / statistics.mean(t) / 1e9
                                for v, t in device_ms.items()}
        print(json.dumps(r), flush=True)
        results.append(r)
        return r

    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    B, H, Hkv = 8, 32, 8
    for (S, T, D) in ([(512, 512, 128), (256, 512, 128), (512, 512, 256)]
                      if "flash" in only else []):
        q = torch.randn(B, H, S, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Hkv, T, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Hkv, T, D, generator=gen, device=dev).bfloat16()
        do = torch.randn(B, H, S, D, generator=gen, device=dev).bfloat16()
        out, lse = flash_attention(q, k, v, True)
        delta = (out.float() * do.float()).sum(-1)
        n_ops = 2 * B * H * sum(min(T, i + T - S + 1) for i in range(S)) * D
        shape = f"B{B} H{H} Hkv{Hkv} S{S} T{T} D{D} causal"
        run(f"row2 flash dQ {shape}", lambda: flash_attention_bwd_dq(
            q, k, v, do, lse, delta, True), 3 * n_ops, cs.BWD_ROW_FLOOR)
        run(f"row3 flash dK/dV {shape}", lambda: flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, True), 4 * n_ops, cs.BWD_ROW_FLOOR)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()

    from autoround_tpu_torch.ops.decode_attention import decode_attention
    B, T = 8, 1024
    for (hd, nkv, G, cases) in [] if "decode" not in only else [
            (128, 8, 4, [(511, None), (700, None), (700, 256)]),
            (64, 8, 4, [(511, None), (700, 256)]),
            (256, 8, 4, [(511, None), (700, 256)]),
            (128, 4, 7, [(511, None)])]:
        nh = nkv * G
        q = torch.randn(B, nh, hd, generator=gen, device=dev).bfloat16()
        kc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                           device=dev).to(torch.int8)
        vc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                           device=dev).to(torch.int8)
        ks = torch.rand(nkv, generator=gen, device=dev) * 0.02 + 0.01
        vs = torch.rand(nkv, generator=gen, device=dev) * 0.02 + 0.01
        sinks = torch.randn(nh, generator=gen, device=dev)
        for pos, window in cases:
            pv = torch.full((B,), pos, dtype=torch.int32, device=dev)
            sk = sinks if window else None
            run(f"row6 decode B{B} T{T} nh{nh} nkv{nkv} hd{hd} pos{pos}"
                + (f" window{window} sinks" if window else ""),
                lambda: decode_attention(q, kc, vc, pv, ks, vs, hd ** -0.5,
                                         window=window, sinks=sk))
        del q, kc, vc

    from autoround_tpu_torch.ops.qmatmul import pack_w4, w4a16_matmul
    from autoround_tpu_torch.ops.qmatmul_ext import (
        fp8_matmul, mxfp4_matmul, pack_w2, w2a16_matmul, w4a16_asym_matmul,
        w8a16_matmul)
    from autoround_tpu_torch.ops.qmatmul_int8 import w4a8_matmul, w8a8_matmul
    M = 4096
    for (O, K, nm) in [] if not {"int8", "gemm"} & only else [
            (6144, 4096, "qkv"), (4096, 14336, "down"),
            (128256, 4096, "lm_head")]:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        n_ops = 2 * M * O * K
        wi = torch.randint(-128, 128, (O, K), generator=gen,
                           device=dev).to(torch.int8)
        ws = (torch.rand(O, generator=gen, device=dev) - 0.5) * 0.002
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        sc = (torch.rand(O, K // 128, generator=gen, device=dev) - .5) * .02
        if "int8" in only:
            run(f"row7 w8a8 {nm} M{M} (fp32 out)",
                lambda: w8a8_matmul(x, wi, ws, torch.float32), n_ops)
            run(f"row8 w4a8 g128 {nm} M{M} (fp32 out)",
                lambda: w4a8_matmul(x, qw, sc, 128, torch.float32), n_ops)
        if nm == "qkv" and "gemm" in only:   # the A16 bodies sharing helpers
            run(f"row4 w4a16 {nm} M{M}", lambda: w4a16_matmul(x, qw, sc, 128))
            zp = torch.rand(O, K // 128, generator=gen, device=dev) * 15
            run(f"row9 asym {nm} M{M}",
                lambda: w4a16_asym_matmul(x, qw, sc.abs(), zp, 128))
            sc32 = torch.exp2(torch.randint(-10, -4, (O, K // 32),
                                            generator=gen, device=dev).float())
            run(f"row13 mxfp4 g32 {nm} M{M}",
                lambda: mxfp4_matmul(x, qw, sc32, 32))
            q2 = pack_w2(torch.randint(0, 4, (O, K), generator=gen,
                                       device=dev))
            run(f"row10 w2a16 {nm} M{M}", lambda: w2a16_matmul(x, q2, sc, 128))
            run(f"row11 w8a16 {nm} M{M}", lambda: w8a16_matmul(x, wi, sc, 128))
            wf = (torch.randn(O, K, generator=gen, device=dev) * 60).clamp(
                -448, 448).to(torch.float8_e4m3fn)
            s8 = torch.rand(O, generator=gen, device=dev) * .002 + 1e-4
            run(f"row12 fp8 {nm} M{M}", lambda: fp8_matmul(x, wf, s8))
            from autoround_tpu_torch.ops.qmatmul import w4a16_matmul_grouped
            xe = x[:256].expand(2, 256, K)
            qwe = torch.stack([qw, qw])
            sce = torch.stack([sc, -sc])
            run(f"row5 grouped E2 C256 {nm}",
                lambda: w4a16_matmul_grouped(xe, qwe, sce, 128))
            del zp, sc32, q2, wf, s8, xe, qwe, sce
        del x, wi, ws, qw, sc
        torch.cuda.empty_cache()

    # the A16 GEMV (M <= 32) of every source at M = 8: outputs compared by
    # row error (the new one rounds each weight to bf16 as the plain
    # version does, the old one kept it in fp32)
    M = 8
    for (O, K, nm) in [] if "gemv" not in only else [
            (6144, 4096, "qkv"), (4096, 14336, "down"),
            (128256, 4096, "lm_head")]:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        for G in (128, 16):
            sc = (torch.rand(O, K // G, generator=gen, device=dev) - .5) * .02
            run(f"row4 w4a16 gemv g{G} {nm} M{M}",
                lambda: w4a16_matmul(x, qw, sc, G))
            zp = torch.rand(O, K // G, generator=gen, device=dev) * 15
            run(f"row9 asym gemv g{G} {nm} M{M}",
                lambda: w4a16_asym_matmul(x, qw, sc.abs(), zp, G))
            del sc, zp
        for G in (32, 16):
            sc = torch.rand(O, K // G, generator=gen, device=dev) * .004
            if G == 32:
                sc = torch.exp2(torch.randint(-10, -4, (O, K // G),
                                              generator=gen, device=dev)
                                .float())
            run(f"row13 mxfp4 gemv g{G} {nm} M{M}",
                lambda: mxfp4_matmul(x, qw, sc, G))
            del sc
        del qw
        sc = (torch.rand(O, K // 128, generator=gen, device=dev) - .5) * .02
        q2 = pack_w2(torch.randint(0, 4, (O, K), generator=gen, device=dev))
        run(f"row10 w2a16 gemv {nm} M{M}",
            lambda: w2a16_matmul(x, q2, sc, 128))
        del q2
        wi = torch.randint(-128, 128, (O, K), generator=gen,
                           device=dev).to(torch.int8)
        run(f"row11 w8a16 gemv g128 {nm} M{M}",
            lambda: w8a16_matmul(x, wi, sc, 128))
        del wi
        wf = (torch.randn(O, K, generator=gen, device=dev) * 60).clamp(
            -448, 448).to(torch.float8_e4m3fn)
        s8 = torch.rand(O, generator=gen, device=dev) * .002 + 1e-4
        run(f"row12 fp8 gemv {nm} M{M}", lambda: fp8_matmul(x, wf, s8))
        del wf, s8, sc, x
        torch.cuda.empty_cache()
    # rows 4 and 5 at M = 1, every decode launch, beside the library call
    # on the dequantized bf16 weight (torch.matmul; the experts torch.bmm)
    from autoround_tpu_torch.ops.qmatmul import unpack_w4, w4a16_matmul_grouped
    for (model, nm, E, O, K) in [] if "gemv" not in only else DECODE_SHAPES:
        qw = torch.stack([pack_w4(torch.randint(0, 16, (O, K), generator=gen,
                                                device=dev))
                          for _ in range(E)])
        sc = (torch.rand(E, O, K // 128, generator=gen, device=dev) - .5) * .02
        x = torch.randn(E, 1, K, generator=gen, device=dev).bfloat16()
        wb = torch.stack([((unpack_w4(qw[e]) - 8).float()
                           * sc[e].repeat_interleave(128, dim=1)).bfloat16()
                          for e in range(E)])
        if E == 1:
            run(f"row4 w4a16 gemv g128 {model} {nm} M1",
                lambda: w4a16_matmul(x[0], qw[0], sc[0], 128),
                lib=lambda: torch.matmul(x[0], wb[0].T))
        else:
            if nm.startswith("w1"):
                x = x[0].expand(E, 1, K)
            run(f"row5 grouped gemv {model} {nm} E{E} C1",
                lambda: w4a16_matmul_grouped(x, qw, sc, 128),
                lib=lambda: torch.bmm(x, wb.transpose(1, 2)))
        del qw, sc, x, wb
        torch.cuda.empty_cache()
    # rows 7 and 8 (the int8 GEMV) at M = 1, 8, 16 and 32, every decode
    # launch of llama3-8b, fp32 out: W8A8 bit-equal, W4A8 within
    # W4A8_F32_ROW_TOL (the parent closed each 32-column chunk, the new
    # body each group)
    for M in [] if "a8gemv" not in only else (1, 8, 16, 32):
        for (model, nm, E, O, K) in DECODE_SHAPES:
            if model != "llama3-8b":
                continue
            x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
            wi = torch.randint(-128, 128, (O, K), generator=gen,
                               device=dev).to(torch.int8)
            ws = (torch.rand(O, generator=gen, device=dev) - .5) * .002
            r = run(f"row7 w8a8 gemv {model} {nm} M{M} (fp32 out)",
                    lambda: w8a8_matmul(x, wi, ws, torch.float32),
                    2 * M * O * K, tol=0.0)
            cs.check(r["bit_equal"], f"{r['case']}: new differs from old")
            del wi, ws
            qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen,
                                       device=dev))
            sc = (torch.rand(O, K // 128, generator=gen, device=dev)
                  - .5) * .02
            r = run(f"row8 w4a8 gemv g128 {model} {nm} M{M} (fp32 out)",
                    lambda: w4a8_matmul(x, qw, sc, 128, torch.float32),
                    2 * M * O * K, tol=cs.W4A8_F32_ROW_TOL)
            cs.check(r["within_tol"], f"{r['case']}: row err "
                     f"{r['row_err_new_vs_old']}")
            del qw, sc, x
            torch.cuda.empty_cache()
    # row 4 at the other M tiers (two n-tiles at 16, four at 32) for qkv
    # and lm_head
    for (M, O, K, nm) in [] if "gemv" not in only else [
            (M, O, K, nm) for M in (16, 32)
            for (O, K, nm) in [(6144, 4096, "qkv"),
                               (128256, 4096, "lm_head")]]:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        sc = (torch.rand(O, K // 128, generator=gen, device=dev) - .5) * .02
        run(f"row4 w4a16 gemv g128 {nm} M{M}",
            lambda: w4a16_matmul(x, qw, sc, 128))
        del x, qw, sc
        torch.cuda.empty_cache()
    if "gemv" in only:
        E, C = 8, 8
        for (K, O, nm) in [(4096, 14336, "w1 x shared"),
                           (14336, 4096, "w2 x contiguous")]:
            qwe = torch.stack([pack_w4(torch.randint(
                0, 16, (O, K), generator=gen, device=dev)) for _ in range(E)])
            sce = (torch.rand(E, O, K // 128, generator=gen, device=dev)
                   - .5) * .02
            xe = torch.randn(E, C, K, generator=gen, device=dev).bfloat16()
            if nm.startswith("w1"):
                xe = xe[0].expand(E, C, K)
            run(f"row5 grouped gemv {nm} E{E} C{C}",
                lambda: w4a16_matmul_grouped(xe, qwe, sce, 128))
            del qwe, sce, xe
            torch.cuda.empty_cache()

    # row 14 at chip_smoke.py's three shapes (the same mean key both ways;
    # the old kernel took k and the mean key, the new one the pre-pass's
    # codes)
    import math

    from autoround_tpu_torch.ops.sage_attention import (key_mean,
                                                        sage_attention)
    old_sage = libs["old"]["sage_attention"].sage_attention_fwd
    old_sage.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                         + [ctypes.c_float, ctypes.c_void_p])

    def sage_old(q, k, v):
        B, H, S, D = q.shape
        km = key_mean(k).contiguous()
        out = torch.empty_like(q)
        _build.check(old_sage(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(),
            out.data_ptr(), B, H, k.shape[1], S, k.shape[2], D, 1,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream),
            "old sage_attention")
        return out
    for (B, S, T) in [] if "sage" not in only else [
            (8, 512, 512), (8, 256, 512), (4, 2048, 2048)]:
        q = torch.randn(B, 32, S, 128, generator=gen, device=dev).bfloat16()
        k = (torch.randn(B, 8, T, 128, generator=gen, device=dev)
             + 2).bfloat16()
        v = torch.randn(B, 8, T, 128, generator=gen, device=dev).bfloat16()
        run(f"row14 sage B{B} H32 Hkv8 S{S} T{T} D128 causal",
            lambda: sage_attention(q, k, v, True),
            fn_old=lambda: sage_old(q, k, v))
        del q, k, v
        torch.cuda.empty_cache()

    # the tuning step and the tune path, every kernel above old then new
    bw, fl, _ = cs.peaks(torch.cuda.get_device_name(0))
    del timer
    cs.free_device_memory()
    if "tune" in only:
        steps = {"old": [], "new": []}
        for w in ("old", "new", "new", "old"):
            use(w)
            print(f"tuning step, {w} kernels", flush=True)
            steps[w].append(cs.tuning_step_phase(bw, fl))
            cs.free_device_memory()
        r = dict(case="llama3-8b tuning step (1 block, B8 S512, W4A16)",
                 tune_step_ms=steps)
        print(json.dumps(r), flush=True)
        results.append(r)
        tune_s = {}
        for w in ("old", "new"):
            use(w)
            print(f"tune path, {w} kernels", flush=True)
            tune_s[w] = cs.tune_path(32)[1]
            cs.free_device_memory()
        r = dict(case="llama3-8b tune path (32 layers + lm_head, iters 20)",
                 tune_s=tune_s)
        print(json.dumps(r), flush=True)
        results.append(r)
    if "moe" in only:
        r = moe_decode(MOE_LAYERS, use)
        print(json.dumps(r), flush=True)
        results.append(r)
    use("new")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "old_new.json").write_text(json.dumps(
        {"card": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
