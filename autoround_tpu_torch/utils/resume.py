"""Crash resume for block-wise quantization (counterpart of
``autoround_tpu/utils/resume.py``).

Each finished block persists its layers' payloads and both input chains
after it, so a run that stops restarts at the first unfinished block.  The
chains are restored verbatim, in the dtype and bits they were saved in:
the JAX package's reference measured a 20x loss regression when they were
regenerated instead.

Layout under ``resume_dir`` (the JAX package's)::

    manifest.json                    {signature, done: [block indices]}
    block_<i>.safetensors            <layer>.qdq / .scale / .zp (fp32)
    chain_<i>.safetensors            x_fp / x_q after block i

Every file is written to a temp file, ``fsync``-ed and renamed over its
name (``os.replace``), and the manifest lists a block only after its
payload and chain are on disk; a block's chain replaces the one before
(under ``nblocks > 1`` the group's last member's replaces the group's:
the JAX package drops the previous group's chain with the first member's
save, so a run stopped inside a group cannot resume there, ROADMAP C).
The files go through the port's own safetensors writer, a tensor on the
card crossing to the host one at a time.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .logger import logger
from .safetensors_io import load_file, save_file

__all__ = ["ResumeState", "run_signature"]


def run_signature(model_cfg, layer_schemes, input_ids, cfg) -> str:
    """A hash over everything the saved caches depend on: the plan, the
    model config, the calibration tokens and the run's iters, seed, batch
    size, quantized-input and alg_ext switches."""
    h = hashlib.sha256()
    h.update(repr(sorted((k, repr(v)) for k, v in
                         layer_schemes.items())).encode())
    h.update(repr(model_cfg).encode())
    ids = torch.as_tensor(input_ids).detach().cpu().contiguous()
    h.update(ids.numpy().tobytes())
    for field in ("iters", "seed", "batch_size", "enable_quanted_input",
                  "enable_alg_ext"):
        h.update(f"{field}={getattr(cfg, field)}".encode())
    return h.hexdigest()[:32]


def _fsync_replace(tmp: str, path: str) -> None:
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_save(tensors: Dict[str, torch.Tensor], path: str) -> None:
    tmp = path + ".tmp"
    save_file(tensors, tmp)
    _fsync_replace(tmp, path)


class ResumeState:
    """The manifest of ``resume_dir``: blocks finished by an earlier run
    with the same signature (another signature starts afresh)."""

    def __init__(self, resume_dir: str, signature: str):
        self.dir = resume_dir
        self.signature = signature
        os.makedirs(resume_dir, exist_ok=True)
        self.manifest_path = os.path.join(resume_dir, "manifest.json")
        self.done: List[int] = []
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                m = json.load(f)
            if m.get("signature") == signature:
                self.done = sorted(m.get("done", []))
                logger.info("resume: found %d finished blocks in %s",
                            len(self.done), resume_dir)
            else:
                logger.warning(
                    "resume: signature mismatch in %s — starting fresh",
                    resume_dir)

    def next_block(self) -> int:
        """The first block that still needs work (``done`` from 0 on)."""
        n = 0
        for i in self.done:
            if i != n:
                break
            n += 1
        return n

    def mark_block_done(self, i: int, block_payload: Dict[str, torch.Tensor],
                        x_fp: torch.Tensor, x_q: Optional[torch.Tensor],
                        drop: Optional[Sequence[int]] = None) -> None:
        """Persist block ``i``'s payload and the chains after it, then list
        it in the manifest and delete the chains of ``drop`` (default: the
        one before it, which this one supersedes)."""
        _atomic_save(block_payload,
                     os.path.join(self.dir, f"block_{i}.safetensors"))
        chain = {"x_fp": x_fp}
        if x_q is not None:
            chain["x_q"] = x_q
        _atomic_save(chain, os.path.join(self.dir, f"chain_{i}.safetensors"))
        if i not in self.done:
            self.done.append(i)
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"signature": self.signature,
                       "done": sorted(self.done)}, f)
            f.flush()
        _fsync_replace(tmp, self.manifest_path)
        for j in ((i - 1,) if drop is None else drop):
            prev = os.path.join(self.dir, f"chain_{j}.safetensors")
            if j >= 0 and os.path.exists(prev):
                os.remove(prev)

    def load_block(self, i: int, device="cpu") -> Dict[str, torch.Tensor]:
        return load_file(os.path.join(self.dir, f"block_{i}.safetensors"),
                         device)

    def load_chain(self, i: int, device="cpu"
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        t = load_file(os.path.join(self.dir, f"chain_{i}.safetensors"),
                      device)
        return t["x_fp"], t.get("x_q")

    def clear(self) -> None:
        """Remove the manifest, payloads and chains (the JAX package
        defines this for after a successful export and never calls it;
        neither does the port)."""
        for f in os.listdir(self.dir):
            if f.startswith(("block_", "chain_", "manifest")):
                os.remove(os.path.join(self.dir, f))
