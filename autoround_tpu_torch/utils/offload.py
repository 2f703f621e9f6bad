"""Host residency for ``offload_params``: park tensors in host memory
(pinned where the host allows it) and bring a block to the card on a side
stream ahead of its use.

Pinned memory comes from PyTorch's caching host allocator, which rounds
every request up to a power of two: one pinned buffer a weight would cost
Mixtral's 117 MB expert matrices 14% more host memory.  :class:`HostArena`
asks for 1 GiB chunks instead (a power of two, so nothing is rounded) and
carves tensors out of them in order, 256-byte aligned; a tensor larger
than a chunk gets a buffer of its own.  A chunk is freed, back to the
allocator's cache, when the last tensor carved from it dies, and the cache
hands it to the next chunk request: parking a block's qdq replacement
reuses the memory of a donated block.  When a pinned allocation fails
(the host will not lock more memory) the arena logs it once and parks in
pageable memory from then on.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .logger import logger
from .pytree import tree_map

__all__ = ["HostArena", "to_host", "tree_to_host", "BlockPrefetcher"]

_CHUNK = 1 << 30
_ALIGN = 256


class HostArena:
    """Carves host tensors out of pinned 1 GiB chunks (see the module
    docstring)."""

    def __init__(self):
        self.pin = torch.cuda.is_available()
        self._chunk: Optional[torch.Tensor] = None
        self._off = 0

    def _pinned(self, nbytes: int) -> Optional[torch.Tensor]:
        if not self.pin:
            return None
        try:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        except RuntimeError as e:
            logger.warning("host offload: pinning failed (%s); parking in "
                           "pageable memory from here on", e)
            self.pin = False
            return None

    def empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        numel = 1
        for n in shape:
            numel *= int(n)
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        if nbytes == 0 or not self.pin:
            return torch.empty(shape, dtype=dtype)
        if nbytes > _CHUNK:
            buf = self._pinned(nbytes)
            if buf is None:
                return torch.empty(shape, dtype=dtype)
            return buf.view(dtype).view(shape)
        if self._chunk is None or self._off + nbytes > _CHUNK:
            self._chunk = self._pinned(_CHUNK)
            self._off = 0
            if self._chunk is None:
                return torch.empty(shape, dtype=dtype)
        view = self._chunk[self._off:self._off + nbytes]
        self._off += -(-nbytes // _ALIGN) * _ALIGN
        return view.view(dtype).view(shape)


_ARENA: Optional[HostArena] = None


def _arena() -> HostArena:
    global _ARENA
    if _ARENA is None:
        _ARENA = HostArena()
    return _ARENA


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to host memory from the process's arena; a CPU tensor
    is returned as it is."""
    if t.device.type == "cpu":
        return t
    out = _arena().empty(tuple(t.shape), t.dtype)
    out.copy_(t)
    return out


def tree_to_host(tree: Any, memo: Optional[dict] = None) -> Any:
    """:func:`to_host` over a tree; ``memo`` (id of a device tensor → its
    host copy) keeps a tensor that several trees share one host copy."""
    memo = {} if memo is None else memo

    def one(t):
        key = id(t)
        if key not in memo:
            memo[key] = (t, to_host(t))   # t held: its id stays unique
        return memo[key][1]
    return tree_map(one, tree)


class BlockPrefetcher:
    """Uploads host blocks to ``device``: :meth:`prefetch` issues a block's
    copies on a side stream, :meth:`get` makes the current stream wait for
    them (``wait_stream``) and marks the tensors as used by it
    (``record_stream``), or uploads a block that was not prefetched.  A
    device that is not CUDA copies in :meth:`get` (a CPU run: no copy)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)
        self._ready = {}

    def _upload(self, block):
        return tree_map(lambda t: t.to(self.device, non_blocking=True),
                        block)

    def prefetch(self, key, block) -> None:
        if self.side is None or key in self._ready or block is None:
            return
        with torch.cuda.stream(self.side):
            self._ready[key] = self._upload(block)

    def get(self, key, block):
        dev = self._ready.pop(key, None)
        if dev is None:
            return self._upload(block)
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(self.side)
        tree_map(lambda t: t.record_stream(cur), dev)
        return dev
