"""``torch.profiler`` tracing of the tuning run (counterpart of
``autoround_tpu/utils/profiling.py``).

``AR_TRACE_DIR=/path`` captures one trace of the block loop, written as a
Chrome trace (``trace_<pid>_<time>.json``, viewable in Perfetto or
``chrome://tracing``); each block is a ``block <i>`` range in it.  The
orchestrator does this by itself when the variable is set::

    with maybe_trace():                     # no-op unless AR_TRACE_DIR
        for bi, block in enumerate(blocks):
            with block_step(bi):
                ...

A profiler that fails to start or to write only logs: tracing never
breaks a run.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .logger import logger

__all__ = ["maybe_trace", "block_step"]


@contextlib.contextmanager
def maybe_trace(trace_dir=None):
    """``torch.profiler.profile`` over the body, its trace written into
    ``trace_dir`` (default ``AR_TRACE_DIR``) when one is configured, else a
    no-op.  Yields whether a trace runs."""
    from .. import envs
    trace_dir = trace_dir or envs.AR_TRACE_DIR
    if not trace_dir:
        yield False
        return
    prof = None
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        logger.info("profiler trace -> %s", trace_dir)
    except Exception as e:
        logger.warning("profiler trace failed to start: %s", e)
        prof = None
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                path = os.path.join(
                    trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
                prof.export_chrome_trace(path)
                logger.info("profiler trace written to %s", path)
            except Exception as e:
                logger.warning("profiler trace failed to write: %s", e)


def block_step(block_idx: int):
    """The ``block <i>`` range of one block in the trace."""
    return torch.profiler.record_function(f"block {block_idx}")
