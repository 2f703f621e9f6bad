"""Seconds a CLI subprocess of the PyTorch port spends before its work, on
the machine it runs on: ``import torch``, the first CUDA tensor,
``from transformers import AutoTokenizer`` and one failed
``AutoTokenizer.from_pretrained`` on a directory that holds only a
``config.json``, each in a fresh interpreter, then the ten modules with
the largest cumulative import time under ``-X importtime``.

    python3 scripts/torch_cli_import_times.py

Run from the repository root (the port's CLI module is imported from
there); it needs a CUDA card for the CUDA cases and no network
(``HF_HUB_OFFLINE``).
"""
import os
import subprocess
import sys
import tempfile
import time

tk = tempfile.mkdtemp(prefix="tk_")
with open(os.path.join(tk, "config.json"), "w") as f:
    f.write('{"model_type": "llama", "vocab_size": 64}')
env = dict(os.environ, PYTHONPATH=".", HF_HUB_OFFLINE="1",
           TRANSFORMERS_OFFLINE="1")
cases = {
    "import torch": "import torch",
    "torch + cuda init": "import torch; torch.zeros(1, device='cuda')",
    "import AutoTokenizer": "from transformers import AutoTokenizer",
    "AutoTokenizer on a dir without one": (
        "from transformers import AutoTokenizer\n"
        "import time; t=time.time()\n"
        f"try:\n    AutoTokenizer.from_pretrained({tk!r})\n"
        "except Exception as e:\n    print(type(e).__name__)\n"
        "print('call_s', time.time() - t)"),
    "cli import + 1 GB on card": (
        "import time; t=time.time()\nimport torch\n"
        "import autoround_tpu_torch.cli\n"
        "x = torch.zeros((1 << 28,), device='cuda')\n"
        "print('in_s', time.time() - t)"),
}
for name, code in cases.items():
    t0 = time.time()
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True)
    print(f"{name}: {time.time() - t0:.2f} s rc={p.returncode} "
          f"out={p.stdout.strip()[-200:]!r} err={p.stderr.strip()[-300:]!r}",
          flush=True)
p = subprocess.run([sys.executable, "-X", "importtime", "-c",
                    "from transformers import AutoTokenizer"],
                   env=env, capture_output=True, text=True)
rows = []
for line in p.stderr.splitlines():
    parts = line.split("|")
    if len(parts) == 3 and parts[1].strip().isdigit():
        rows.append((int(parts[1]), parts[2].rstrip()))
for us, mod in sorted(rows, reverse=True)[:10]:
    print(f"importtime cumulative {us / 1e6:.2f} s {mod}")
