"""Streaming sharded safetensors writer (counterpart of
``autoround_tpu/export/shard_writer.py``).

Buffers tensors, flushes at a shard-size budget, and ``finalize`` renames
the shards to the ``-of-`` convention and writes the index, so a large
export never holds more than one shard in memory.  Shards are written by
``utils/safetensors_io.py``, byte-equal to the ``safetensors`` package's.
Tensors may be numpy arrays or torch tensors (a card tensor is copied to
the host as it is added).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..utils.logger import logger
from ..utils.safetensors_io import save_file

__all__ = ["ShardWriter"]


class ShardWriter:
    def __init__(self, output_dir: str, shard_size_bytes: int = 4 << 30,
                 prefix: str = "model"):
        self.dir = output_dir
        self.budget = shard_size_bytes
        self.prefix = prefix
        os.makedirs(output_dir, exist_ok=True)
        self._buffer: Dict[str, Union[np.ndarray, torch.Tensor]] = {}
        self._buffered_bytes = 0
        self._shard_idx = 0
        self._weight_map: Dict[str, str] = {}
        self._shard_files = []
        self._finalized = False

    def add(self, name: str, tensor: Union[np.ndarray, torch.Tensor]
            ) -> None:
        assert not self._finalized, "writer already finalized"
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().to("cpu").contiguous()
            nbytes = tensor.numel() * tensor.element_size()
        else:
            tensor = np.ascontiguousarray(tensor)
            nbytes = tensor.nbytes
        self._buffer[name] = tensor
        self._buffered_bytes += nbytes
        if self._buffered_bytes >= self.budget:
            self.flush()

    def add_many(self, tensors) -> None:
        for k, v in tensors.items():
            self.add(k, v)

    def flush(self) -> Optional[str]:
        """Write the current buffer as one shard."""
        if not self._buffer:
            return None
        self._shard_idx += 1
        fname = f"{self.prefix}-{self._shard_idx:05d}.safetensors"
        tmp = os.path.join(self.dir, fname + ".tmp")
        save_file(self._buffer, tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, fname))
        for k in self._buffer:
            self._weight_map[k] = fname
        self._shard_files.append(fname)
        logger.info("shard writer: wrote %s (%.1f MB, %d tensors)", fname,
                    self._buffered_bytes / 1e6, len(self._buffer))
        self._buffer = {}
        self._buffered_bytes = 0
        return fname

    def finalize(self) -> str:
        """Flush remainder, rename shards to -of- convention, write index."""
        self.flush()
        self._finalized = True
        total = len(self._shard_files)
        final_names = {}
        for i, fname in enumerate(self._shard_files, 1):
            new = f"{self.prefix}-{i:05d}-of-{total:05d}.safetensors"
            os.replace(os.path.join(self.dir, fname),
                       os.path.join(self.dir, new))
            final_names[fname] = new
        self._weight_map = {k: final_names[v]
                            for k, v in self._weight_map.items()}
        index = {"metadata": {"total_shards": total},
                 "weight_map": self._weight_map}
        with open(os.path.join(self.dir,
                               f"{self.prefix}.safetensors.index.json"),
                  "w") as f:
            json.dump(index, f, indent=2)
        return self.dir
