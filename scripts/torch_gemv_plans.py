#!/usr/bin/env python3
"""Time the A16 GEMV at every decode launch with K split every way.

    python3 scripts/torch_gemv_plans.py

``gemv_plan`` (``csrc/w4a16_tiles.cuh``) picks from host shapes how many
blocks of a thread-block cluster split K (kc).  This script builds a copy
of the W4A16 and grouped sources in ``autoround_tpu_torch/_build/plans/``
whose plan takes kc from a setter, then times (``Timer.device``: the
kernel's device time, L2 flushed) every launch of ``torch_old_new.py``'s
``DECODE_SHAPES`` at M = 1 and 8 with the shipped plan and with kc = 1, 2,
4, 8 and 16 wherever the steps of K and the block's staged x allow it
(turns in order, then reversed; their mean).  The copy at the shipped kc
must give the shipped kernel's bits.  Prints one JSON line per launch and
M, and writes them with the card's name and power limit to
``chiprun_out/gemv_plans.json``.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from autoround_tpu_torch._device import resolve_device  # noqa: E402
from autoround_tpu_torch.ops import _build  # noqa: E402
from torch_old_new import DECODE_SHAPES  # noqa: E402

NAMES = ("w4a16_matmul", "w4a16_matmul_grouped")
PLAN = ("template <int FMT>\n"
        "GemvPlan gemv_plan(int E, int M, int K, int O, int sms) {\n")
FORCED = """  if (g_force_kc > 0) {
    const int steps = (K + STEP_K<FMT> - 1) / STEP_K<FMT>;
    return {min(GEMV_MAX_WARPS, (O + 15) / 16), g_force_kc,
            (steps + g_force_kc - 1) / g_force_kc};
  }
"""


def build_forced() -> dict:
    """The two sources with a plan whose kc `set_force_kc` fixes (0: the
    shipped plan), built next to a copy of the sources."""
    src = ROOT / "autoround_tpu_torch" / "csrc"
    out = ROOT / "autoround_tpu_torch" / "_build" / "plans"
    out.mkdir(parents=True, exist_ok=True)
    for f in src.iterdir():
        shutil.copy(f, out / f.name)
    tiles = (out / "w4a16_tiles.cuh").read_text()
    if PLAN not in tiles:
        raise RuntimeError("gemv_plan's signature changed: update PLAN")
    (out / "w4a16_tiles.cuh").write_text(tiles.replace(
        PLAN, "inline int g_force_kc = 0;\n\n" + PLAN + FORCED))
    procs = {}
    for n in NAMES:
        cu = out / f"{n}.cu"
        cu.write_text(cu.read_text() + '\nextern "C" void set_force_kc(int v)'
                      ' { w4a16::g_force_kc = v; }\n')
        procs[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{n}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"forced-plan {n} failed to build:\n{log}")
    return {n: ctypes.CDLL(str(out / f"{n}.so")) for n in NAMES}


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from autoround_tpu_torch.ops.qmatmul import (pack_w4, w4a16_matmul,
                                                 w4a16_matmul_grouped)
    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all(list(NAMES))
    shipped = {n: _build.load(n) for n in NAMES}
    forced = build_forced()
    info = (ctypes.c_int * 6)()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for (model, nm, E, O, K) in DECODE_SHAPES:
        src = NAMES[E > 1]
        qw = torch.stack([pack_w4(torch.randint(
            0, 16, (O, K), generator=gen, device="cuda")) for _ in range(E)])
        sc = (torch.rand(E, O, K // 128, generator=gen, device="cuda")
              - .5) * .02
        plan_info = getattr(shipped[src], f"{src}_gemv_info")
        plan_info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(
            ctypes.c_int)]
        for M in (1, 8):
            x = torch.randn(E, M, K, generator=gen, device="cuda").bfloat16()
            if nm.startswith("w1"):
                x = x[0].expand(E, M, K)
            if E == 1:
                fn = lambda: w4a16_matmul(x[0], qw[0], sc[0], 128)
            else:
                fn = lambda: w4a16_matmul_grouped(x, qw, sc, 128)
            _build.check(plan_info(E, M, K, O, info), f"{src}_gemv_info")
            kc_shipped, steps = info[5], K // 128
            turns = ["shipped"] + [kc for kc in (1, 2, 4, 8, 16)
                                   if kc <= steps
                                   and -(-steps // kc) * 128 * 8 * 2
                                   <= 32 << 10]
            ms = {t: [] for t in turns}
            want = None
            for order in (turns, turns[::-1]):
                for t in order:
                    if t == "shipped":
                        _build._libs[src] = shipped[src]
                    else:
                        _build._libs[src] = forced[src]
                        forced[src].set_force_kc(t)
                    y = fn()
                    if t == "shipped":
                        want = y
                    elif t == kc_shipped and not torch.equal(y, want):
                        raise RuntimeError(f"{model} {nm} M{M}: the forced "
                                           f"plan at kc {t} differs")
                    ms[t].append(timer.device(fn)[0])
            _build._libs[src] = shipped[src]
            r = dict(case=f"{model} {nm} E{E} O{O} K{K} M{M}",
                     kc_shipped=kc_shipped,
                     device_ms={str(t): statistics.mean(v)
                                for t, v in ms.items()})
            print(json.dumps(r), flush=True)
            results.append(r)
        del qw, sc, x
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gemv_plans.json").write_text(json.dumps(
        {"card": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
