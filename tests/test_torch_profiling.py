"""Port parity for the driver's observability (``autoround_tpu_torch/
utils/profiling.py``, ``utils/memory.py`` and ``AR_PROFILE_PHASES``)
against the JAX package.

``tiny`` preset, fp32, CPU.  What is held: the trace file exists under
``AR_TRACE_DIR`` and names each block, and nothing is traced without it;
``QuantizeResult.profile`` has the JAX package's key set for the same run
(seconds differ by nature); the memory helpers run on the CPU, where the
device statistics are zeros as the JAX package reports for a backend
without them.
"""

import dataclasses
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.utils import memory as jmemory
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch.utils import memory, profiling
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

JCFG = jl.CONFIG_PRESETS["tiny"]


@pytest.fixture(scope="module")
def tiny():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(JCFG))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ids = np.random.default_rng(1).integers(0, JCFG.vocab_size, (8, 32))
    return jp, tcfg, tp, ids


def test_trace_under_ar_trace_dir(tiny, tmp_path, monkeypatch):
    _, tcfg, tp, ids = tiny
    with profiling.maybe_trace() as on:
        assert on is False                     # no AR_TRACE_DIR: no trace
    monkeypatch.setenv("AR_TRACE_DIR", str(tmp_path))
    AutoRound((tp, tcfg), iters=0, device="cpu").quantize(ids)
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"block 0", "block 1"} <= names


@pytest.mark.parametrize("kw", [
    dict(scheme="W4A16G32", iters=2, batch_size=4),
    dict(scheme="W4A16G32", iters=0),
    # 8 bits: the JAX offload pull packs no int4 planes (that path's
    # compiles are not what this holds)
    dict(scheme={"bits": 8, "group_size": 32}, iters=0,
         offload_params=True)],
    ids=["tune", "rtn", "offload"])
def test_profile_keys_like_jax(tiny, monkeypatch, kw):
    jp, tcfg, tp, ids = tiny
    monkeypatch.setenv("AR_PROFILE_PHASES", "1")
    kw = dict(seed=0, **kw)
    jres = JAutoRound((jp, JCFG), **kw).quantize(jnp.asarray(ids))
    tres = AutoRound((tp, tcfg), device="cpu", **kw).quantize(ids)
    assert sorted(tres.profile) == sorted(jres.profile)
    assert all(v >= 0.0 for v in tres.profile.values())
    monkeypatch.delenv("AR_PROFILE_PHASES")
    assert AutoRound((tp, tcfg), device="cpu", **kw).quantize(
        ids).profile == {}


def test_memory_helpers_on_the_cpu(tiny, monkeypatch, caplog):
    _, tcfg, tp, ids = tiny
    assert memory.device_memory_stats("cpu") == dict(
        bytes_in_use=0, peak_bytes_in_use=0, bytes_limit=0)
    assert sorted(memory.device_memory_stats("cpu")) == sorted(
        jmemory.device_memory_stats())
    mon = memory.MemoryMonitor("cpu")
    assert mon.peak_rss_gb > 0 and mon.peak_device_gb == 0.0
    monkeypatch.setenv("AR_LOG_MEMORY", "1")
    with caplog.at_level("INFO", logger="autoround_tpu_torch"):
        AutoRound((tp, tcfg), iters=0, device="cpu").quantize(ids)
        monkeypatch.setenv("AR_LEAK_PROBE", "1")
        memory.log_live_arrays("again")
    assert "memory [block 1]: peak RSS" in caplog.text
    assert "live arrays [block 0]: total 0.00 GB" in caplog.text
