"""Memory observability (counterpart of ``autoround_tpu/utils/memory.py``):
the peak host RSS and device memory, logged per block under
``AR_LOG_MEMORY=1``, and the live device tensors grouped by shape and
dtype (the JAX package's ``jax.live_arrays()`` census; here the CUDA
tensors the garbage collector tracks)."""

from __future__ import annotations

import gc
import os
import resource
from typing import Dict

import torch

from .logger import logger

__all__ = ["MemoryMonitor", "device_memory_stats", "log_live_arrays"]


def device_memory_stats(device=None) -> Dict[str, int]:
    """``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit`` of a CUDA
    device (the caching allocator's allocated bytes, their peak, the card's
    total memory); zeros for the CPU, as the JAX package returns for a
    backend without statistics."""
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {k: 0 for k in keys}
    s = torch.cuda.memory_stats(device)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory}


class MemoryMonitor:
    """Peak host RSS and peak device bytes in GB, updated on each read."""

    def __init__(self, device=None):
        self.device = device
        self.peak_rss_gb = 0.0
        self.peak_device_gb = 0.0
        self.update()

    def update(self) -> None:
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.peak_rss_gb = max(self.peak_rss_gb, rss_kb / 1024 / 1024)
        dev = device_memory_stats(self.device)
        self.peak_device_gb = max(self.peak_device_gb,
                                  dev["peak_bytes_in_use"] / 1024 ** 3)

    def log_summary(self, tag: str = "") -> None:
        self.update()
        cur = device_memory_stats(self.device)["bytes_in_use"] / 1024 ** 3
        logger.info("memory%s: peak RSS %.2f GB, device cur %.2f GB "
                    "peak %.2f GB",
                    f" [{tag}]" if tag else "", self.peak_rss_gb, cur,
                    self.peak_device_gb)


def _live_tensors(min_bytes: int = 0):
    """The tensors on a CUDA device that the garbage collector tracks (a
    tensor held only by C++ code, e.g. an autograd buffer, is not seen),
    each storage once."""
    seen = set()
    out = []
    for o in gc.get_objects():
        try:
            # type(), not isinstance: the latter reads ``__class__``,
            # which some deprecated module objects warn on
            if not (issubclass(type(o), torch.Tensor) and o.is_cuda):
                continue
            key = o.untyped_storage().data_ptr()
            nb = o.untyped_storage().nbytes()
        except Exception:
            continue
        if key in seen or nb < min_bytes:
            continue
        seen.add(key)
        out.append((o, nb))
    return out


def log_live_arrays(tag: str = "", top: int = 8) -> None:
    """The live CUDA tensors grouped by (shape, dtype): the ``top``
    heaviest groups and the total bytes (the leak finder).  Under
    ``AR_LEAK_PROBE=1`` also :func:`_leak_probe`."""
    groups: Dict[tuple, list] = {}
    total = 0
    for t, nb in _live_tensors():
        total += nb
        g = groups.setdefault((tuple(t.shape), str(t.dtype)), [0, 0])
        g[0] += 1
        g[1] += nb
    rows = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
    desc = ", ".join(f"{n}x{s}:{d}={b/1024**2:.0f}MB"
                     for (s, d), (n, b) in rows)
    logger.info("live arrays%s: total %.2f GB | %s",
                f" [{tag}]" if tag else "", total / 1024 ** 3, desc)
    if os.environ.get("AR_LEAK_PROBE") == "1":
        _leak_probe(tag)


_SEEN_IDS: set = set()


def _leak_probe(tag: str, min_mb: float = 16.0) -> None:
    """For tensors alive across two calls (long-lived), log who refers to
    them (``gc.get_referrers``, two levels): the leak finder's second
    stage."""
    global _SEEN_IDS
    now = {id(t): t for t, _ in _live_tensors(int(min_mb * 1024 ** 2))}
    old = [t for i, t in now.items() if i in _SEEN_IDS]
    _SEEN_IDS = set(now)
    shapes = set()
    probes = []
    for t in old:                # up to 3 survivors of distinct shapes
        if tuple(t.shape) not in shapes:
            shapes.add(tuple(t.shape))
            probes.append(t)
        if len(probes) == 3:
            break
    for t in probes:
        refs = [r for r in gc.get_referrers(t)
                if r is not now and r is not old and r is not probes]
        lines = []
        for r in refs[:6]:
            if isinstance(r, dict):
                keys = [k for k, v in r.items() if v is t]
                lines.append(f"dict(keys={keys[:3]})")
                for rr in gc.get_referrers(r)[:3]:
                    lines.append(f"  <- {type(rr).__name__}"
                                 + (f" {getattr(rr, '__name__', '')}"
                                    if callable(rr) else ""))
            elif isinstance(r, list):
                lines.append(f"list(len={len(r)})")
                for rr in gc.get_referrers(r)[:3]:
                    lines.append(f"  <- {type(rr).__name__}")
            else:
                lines.append(type(r).__name__)
        logger.info("leak probe [%s] %s %s: %s", tag, tuple(t.shape),
                    t.dtype, " | ".join(lines))
