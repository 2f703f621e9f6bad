#!/usr/bin/env python3
"""Run chosen paths of ``chip_smoke.py`` alone on the card, at depths
other than its defaults.

    python3 scripts/torch_smoke_paths.py offload_phase=32 longcat_path=1 \\
        qwen3next_tune_path glm45_path=2

Run from the repository root on a machine with one CUDA card.  Each
argument names a function of ``chip_smoke.py``, and after ``=`` the depth
it is given; one that takes the card's peak rates (its first parameter is
``bw``) gets them first, as ``chip_smoke.py`` passes them.  The kernels
are built first, as ``chip_smoke.py`` builds them.  The paths run in the
order given, each with the checks it holds in ``chip_smoke.py``; a failed
check stops the run with its message.  Prints the card's name and power
limit, then each path's log and its seconds.
"""

from __future__ import annotations

import inspect
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_smoke_paths: no CUDA device", file=sys.stderr)
        return 2
    paths = []
    for arg in sys.argv[1:]:
        name, _, depth = arg.partition("=")
        fn = getattr(cs, name, None)
        if not callable(fn):
            print(f"torch_smoke_paths: chip_smoke has no path {name!r}",
                  file=sys.stderr)
            return 2
        paths.append((name, fn, [int(depth)] if depth else []))
    from autoround_tpu_torch._device import resolve_device
    from autoround_tpu_torch.ops import _build

    resolve_device(None)   # the card; switches TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    t0 = time.time()
    _build.build_all()
    cs.log(f"build_s={time.time() - t0:.2f}")
    bw, fl, _ = cs.peaks(torch.cuda.get_device_name(0))
    for name, fn, depth in paths:
        rates = ([bw, fl] if next(iter(inspect.signature(fn).parameters),
                                  None) == "bw" else [])
        t0 = time.time()
        fn(*rates, *depth)
        cs.free_device_memory()
        cs.log(f"{name} {depth}: path_s={time.time() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
