"""autoround_tpu_torch: the PyTorch / CUDA port of ``autoround_tpu``.

The JAX package stays the reference; this package runs the same
quantize-then-serve path on an NVIDIA H100, with hand-written CUDA kernels
(``csrc/``) where the JAX package had Pallas TPU kernels.  It imports
``torch``, ``numpy`` and the standard library only — never JAX and never
the JAX package.

Ported so far: SignRound (``iters > 0``) and RTN (``iters=0``) quantization
of Llama-family and Mixtral models with the int and float (FP8, MX, NVFP4)
data types and their activation quantization, the serving engine for every
packed kind of the JAX engine with an int8 or fp8 KV cache, its decode loop
as a replayed CUDA graph (``generate_scan``) and continuous batching
(``serve.ContinuousBatchingEngine``), the ``fake`` / ``autoround``
export formats, and loading and user entry: local HF checkpoints
(``utils.hf_loader``), ``QuantizedLlama.from_pretrained`` / ``from_gptq`` /
``from_awq``, calibration data (``quantize.calib_data``) and the CLI
(``python -m autoround_tpu_torch``), on the port's own safetensors reader
and writer (``utils.safetensors_io``)::

    ar = AutoRound((params, cfg), scheme="W4A16", iters=200,
                   quant_lm_head=True)
    res = ar.quantize(calib_ids)
    ar.save_quantized("out/", format="autoround")
    eng = QuantizedLlama.from_quantize_result(res, cfg, max_seq=1024,
                                              kv_quant="int8")
    tokens = eng.generate_scan(prompts, max_new_tokens=32)

Every entry point takes ``device=None``, meaning the CUDA card; without
one it raises.  Pass ``device="cpu"`` for the plain PyTorch path.
"""

from .api import AutoRound
from .schemes import PRESET_SCHEMES, QuantizationScheme, parse_scheme
from .serve.engine import KVCache, QuantizedLlama
from .serve.sampling import SamplingParams

__all__ = ["AutoRound", "QuantizedLlama", "KVCache", "SamplingParams",
           "QuantizationScheme", "PRESET_SCHEMES", "parse_scheme"]
__version__ = "0.1.0"
