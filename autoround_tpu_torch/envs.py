"""Environment flags (counterpart of ``autoround_tpu/envs.py``): every
``AR_*`` knob of the JAX package is a lazy accessor under the same name, so
``envs.AR_LOG_LEVEL`` reads the process environment when it is read.

The library takes explicit arguments and reads these where the JAX
package reads them:

* ``AR_RESUME_DIR`` → the quantize driver's crash resume when
  ``resume_dir`` is not given (``utils/resume.py``);
* ``AR_TRACE_DIR`` → a ``torch.profiler`` Chrome trace of the block loop
  (``utils/profiling.py``);
* ``AR_LOG_MEMORY`` → the memory monitor and live-tensor census after each
  block (``utils/memory.py``; ``AR_LEAK_PROBE=1`` adds the referrer
  probe);
* ``AR_PROFILE_PHASES`` → ``QuantizeResult.profile``, the seconds by phase
  of the block loop;
* ``AR_WORK_SPACE`` → AutoScheme's score cache
  (``quantize/auto_scheme.py``);
* ``AR_MODEL_FREE_SHARD_PARALLELISM`` → ``model_free_quantize``'s
  ``num_workers`` when not given.

The entry point (``cli.py``) maps two onto its arguments:

* ``AR_LOG_LEVEL`` → ``utils.logger.setup``;
* ``AR_ENABLE_ACT_MINMAX_TUNING`` → ``AutoRound(...,
  enable_act_minmax_tuning=...)`` (``QuantizeConfig``).

``AR_MOE_CAPACITY_FACTOR`` is the serving engine's ``moe_capacity_factor``
(``QuantizedLlama.from_quantize_result`` / ``from_pretrained`` /
``from_gptq``); the CLI quantizes and exports and builds no engine, so the
code that builds one passes ``envs.AR_MOE_CAPACITY_FACTOR`` itself.

Read and ignored, because they have no meaning in the port:

* ``AR_COMPILE_CACHE_DIR``: XLA's persistent compilation cache; the port
  compiles no XLA programs (its CUDA builds are cached under
  ``autoround_tpu_torch/_build/``);
* ``AR_PREFILL_DEQUANT_TOKENS``: the JAX engine's dequantize-once prefill
  path; the port always runs the kernel (an accepted deviation, ROADMAP C).

Kept for a feature not ported yet:

* ``AR_CALIB_SUBPROCESS`` / ``AR_CALIB_SUBPROCESS_TIMEOUT`` → the hub
  datasets of ``quantize/calib_data.py`` (A8), which the port leaves out:
  it reads local files only.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict

environment_variables: Dict[str, Callable[[], Any]] = {
    "AR_LOG_LEVEL": lambda: os.environ.get("AR_LOG_LEVEL", "INFO"),
    "AR_RESUME_DIR": lambda: os.environ.get("AR_RESUME_DIR"),
    "AR_MODEL_FREE_SHARD_PARALLELISM": lambda: int(
        os.environ.get("AR_MODEL_FREE_SHARD_PARALLELISM", "1")),
    "AR_ENABLE_ACT_MINMAX_TUNING": lambda: os.environ.get(
        "AR_ENABLE_ACT_MINMAX_TUNING", "0") == "1",
    "AR_WORK_SPACE": lambda: os.environ.get("AR_WORK_SPACE", "/tmp/ar_tpu"),
    "AR_LOG_MEMORY": lambda: os.environ.get("AR_LOG_MEMORY", "0") == "1",
    "AR_TRACE_DIR": lambda: os.environ.get("AR_TRACE_DIR"),
    "AR_MOE_CAPACITY_FACTOR": lambda: float(os.environ.get(
        "AR_MOE_CAPACITY_FACTOR", "0")),
    "AR_PREFILL_DEQUANT_TOKENS": lambda: int(os.environ.get(
        "AR_PREFILL_DEQUANT_TOKENS", "0")),
    "AR_COMPILE_CACHE_DIR": lambda: os.environ.get("AR_COMPILE_CACHE_DIR"),
    "AR_PROFILE_PHASES": lambda: os.environ.get(
        "AR_PROFILE_PHASES", "0") == "1",
    "AR_CALIB_SUBPROCESS": lambda: os.environ.get(
        "AR_CALIB_SUBPROCESS", "0") == "1",
    "AR_CALIB_SUBPROCESS_TIMEOUT": lambda: float(os.environ.get(
        "AR_CALIB_SUBPROCESS_TIMEOUT", "300")),
}


def __getattr__(name: str):
    if name in environment_variables:
        return environment_variables[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return list(environment_variables)
