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
4096 for llama3-8b's qkv, down_proj and lm_head, and the seven A16 GEMM
bodies at M = 4096 qkv (bit-equality of the shared tiles).  Then, with
every kernel above old and then new, ``chip_smoke.py``'s tuning step
(gradient check, step ms; turns old, new, new, old) and its llama3-8b tune
path at 32 layers (old, new) for ``tune_s``.  Prints one JSON line per case, the card's name and power
limit, and writes all of it to ``chiprun_out/old_new.json``.  Needs a
CUDA card.
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

NAMES = ("flash_attention_bwd", "decode_attention", "w8a8_matmul", "w4a8_matmul", "w4a16_matmul",
         "w4a16_matmul_grouped", "w4a16_asym_matmul", "w8a16_matmul",
         "w2a16_matmul", "fp8_matmul", "mxfp4_matmul")


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


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old_dir = Path(sys.argv[1]).resolve()
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

    def run(case, fn, n_ops=None, floor=0.0):
        use("old")
        y0 = fn()
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
            ms[w].append(timer(fn))
            device_ms[w].append(timer.device(fn)[0])
        use("new")
        o, n = (statistics.mean(device_ms[v]) for v in ("old", "new"))
        r = dict(case=case, bit_equal=equal, row_err_new_vs_old=rel,
                 ms=ms, device_ms=device_ms, device_speedup=o / n)
        if n_ops:
            r["device_tops"] = {v: n_ops / statistics.mean(t) / 1e9
                                for v, t in device_ms.items()}
        print(json.dumps(r), flush=True)
        results.append(r)

    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    B, H, Hkv = 8, 32, 8
    for (S, T, D) in [(512, 512, 128), (256, 512, 128), (512, 512, 256)]:
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
    for (hd, nkv, G, cases) in [
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
    for (O, K, nm) in [(6144, 4096, "qkv"), (4096, 14336, "down"),
                       (128256, 4096, "lm_head")]:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        n_ops = 2 * M * O * K
        wi = torch.randint(-128, 128, (O, K), generator=gen,
                           device=dev).to(torch.int8)
        ws = (torch.rand(O, generator=gen, device=dev) - 0.5) * 0.002
        run(f"row7 w8a8 {nm} M{M} (fp32 out)",
            lambda: w8a8_matmul(x, wi, ws, torch.float32), n_ops)
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        sc = (torch.rand(O, K // 128, generator=gen, device=dev) - .5) * .02
        run(f"row8 w4a8 g128 {nm} M{M} (fp32 out)",
            lambda: w4a8_matmul(x, qw, sc, 128, torch.float32), n_ops)
        if nm == "qkv":      # the A16 bodies that share the helpers
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

    # the tuning step and the tune path, every kernel above old then new
    bw, fl, _ = cs.peaks(torch.cuda.get_device_name(0))
    del timer
    cs.free_device_memory()
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
    use("new")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "old_new.json").write_text(json.dumps(
        {"card": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
