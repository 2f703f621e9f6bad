"""Device resolution for every entry point of the port.

``device=None`` means the CUDA card.  On a machine without CUDA it raises:
the port never quietly runs on the CPU.  Callers that want the CPU (the
tests) pass ``device="cpu"`` explicitly.

Precision: the first time a CUDA device is resolved, TF32 is switched off
for both matmuls and cuDNN (``torch.backends.cuda.matmul.allow_tf32 =
False``, ``torch.backends.cudnn.allow_tf32 = False``), so float32 work on
the card runs in full float32 like the JAX reference on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "autoround_tpu_torch: device=None means the CUDA card, and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
