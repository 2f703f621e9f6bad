"""Port parity for crash resume (``autoround_tpu_torch/utils/resume.py``
and its wiring in ``quantize/orchestrator.py``) against the JAX package.

``tiny`` preset (and a 4-layer copy for ``nblocks=2``), fp32, CPU,
SignRound at 4 iterations.  A run is stopped by a hook that raises after
block k is saved, then run again on the same directory.  Tolerances: the
resumed result equals the uninterrupted port run bit for bit (every
layer's qdq, scale and zero point, every block param, the remaining loss
traces: the restored chains are the saved ones, so the tuned blocks see
the same numbers); against the JAX package's uninterrupted run, the
tolerances of ``tests/test_torch_e2e.py`` (traces rtol 5e-6, scales 5e-7,
at least 99.8% of a layer's codes equal); the files' layout (names,
manifest keys, tensor keys and dtypes) equals the JAX package's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.models import llama as jl
from autoround_tpu.quantize.layer_config import \
    resolve_layer_schemes as j_resolve
from autoround_tpu.quantize.orchestrator import QuantizeConfig as JQC
from autoround_tpu.quantize.orchestrator import quantize_model as j_quantize
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu_torch.export import codes_from_qdq
from autoround_tpu_torch.quantize.layer_config import resolve_layer_schemes
from autoround_tpu_torch.quantize.orchestrator import (QuantizeConfig,
                                                       quantize_model)
from autoround_tpu_torch.schemes import parse_scheme
from autoround_tpu_torch.utils import resume as tresume
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import SafeOpen
from _port_threads import one_torch_thread  # noqa: F401

JCFG = jl.CONFIG_PRESETS["tiny"]
SCHEME = "W4A16G32"
KW = dict(iters=4, batch_size=4, seed=0)
BEST_LOSS_RTOL = 5e-6
SCALE_RTOL = 5e-7
CODES_EQUAL_MIN = 0.998


def _model(num_layers):
    jcfg = dataclasses.replace(JCFG, num_layers=num_layers)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    names = jl.block_linear_names(jcfg)
    tplan = resolve_layer_schemes(num_layers, names, parse_scheme(SCHEME))
    jplan = j_resolve(num_layers, names, j_parse(SCHEME))
    return jcfg, jp, tcfg, tp, jplan, tplan


@pytest.fixture(scope="module")
def tiny():
    return _model(2)


@pytest.fixture(scope="module")
def ids():
    return torch.as_tensor(
        np.random.default_rng(1).integers(0, JCFG.vocab_size, (8, 32)))


@pytest.fixture(scope="module")
def jax_run(tiny, ids, tmp_path_factory):
    """The JAX package's uninterrupted run, with a resume directory (its
    files are the layout the port's must match)."""
    jcfg, jp, _, _, jplan, _ = tiny
    d = str(tmp_path_factory.mktemp("jres") / "r")
    res = j_quantize(jp, jcfg, jplan, jnp.asarray(ids.numpy()),
                     JQC(resume_dir=d, **KW))
    return res, d


@pytest.fixture(scope="module")
def plain(tiny, ids):
    """The port's uninterrupted run, no resume directory."""
    _, _, tcfg, tp, _, tplan = tiny
    return quantize_model(tp, tcfg, tplan, ids, QuantizeConfig(**KW))


def _run(model, ids, rdir, stop_after=None, monkeypatch=None, **kw):
    """One port run on ``rdir``; ``stop_after=k`` raises once block k is
    saved, as a crash after it would."""
    _, _, tcfg, tp, _, tplan = model
    if stop_after is not None:
        orig = tresume.ResumeState.mark_block_done

        def crash(self, i, *a):
            orig(self, i, *a)
            if i == stop_after:
                raise KeyboardInterrupt(f"stopped after block {i}")
        monkeypatch.setattr(tresume.ResumeState, "mark_block_done", crash)
        with pytest.raises(KeyboardInterrupt):
            quantize_model(tp, tcfg, tplan, ids,
                           QuantizeConfig(resume_dir=rdir, **KW, **kw))
        monkeypatch.undo()
    return quantize_model(tp, tcfg, tplan, ids,
                          QuantizeConfig(resume_dir=rdir, **KW, **kw))


def _bit_equal(a, b, tuned_from=0):
    assert sorted(a.layers) == sorted(b.layers)
    for name, qa in a.layers.items():
        qb = b.layers[name]
        for x, y in ((qa.qdq, qb.qdq), (qa.scale, qb.scale), (qa.zp, qb.zp)):
            assert (x is None) == (y is None), name
            if x is not None:
                assert torch.equal(x.float(), y.float()), name
    for li, blk in enumerate(a.params["blocks"]):
        for k, v in blk.items():
            assert torch.equal(v, b.params["blocks"][li][k]), (li, k)
    for bi, tr in b.loss_traces.items():
        if bi >= tuned_from:
            np.testing.assert_array_equal(a.loss_traces[bi], tr)


@pytest.mark.parametrize("stop_after", [0, 1])
def test_resumed_equals_uninterrupted_and_jax(tiny, ids, plain, jax_run,
                                              tmp_path, monkeypatch,
                                              stop_after):
    res = _run(tiny, ids, str(tmp_path / "r"), stop_after, monkeypatch)
    # blocks up to stop_after came from disk: no traces for them
    assert sorted(res.loss_traces) == list(range(stop_after + 1, 2))
    _bit_equal(plain, res, tuned_from=stop_after + 1)
    jres, _ = jax_run
    for bi, tt in res.loss_traces.items():
        np.testing.assert_allclose(tt, np.asarray(jres.loss_traces[bi]),
                                   rtol=BEST_LOSS_RTOL)
    for name, jq in jres.layers.items():
        tq = res.layers[name]
        jc = codes_from_qdq(np.asarray(jq.qdq), np.asarray(jq.scale), None,
                            4, 32)
        tc = codes_from_qdq(tq.qdq.float().numpy(), tq.scale.numpy(), None,
                            4, 32)
        assert np.mean(jc == tc) >= CODES_EQUAL_MIN, name
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=SCALE_RTOL, err_msg=name)


def test_signature_mismatch_restarts(tiny, ids, plain, tmp_path,
                                     monkeypatch, caplog):
    """A directory of another run (here: other calibration tokens) is not
    resumed: the run starts afresh, and ``AR_RESUME_DIR`` names the
    directory when ``resume_dir`` is not given."""
    rdir = str(tmp_path / "r")
    _, _, tcfg, tp, _, tplan = tiny
    quantize_model(tp, tcfg, tplan, ids.flip(0), QuantizeConfig(
        resume_dir=rdir, **KW))
    old = json.load(open(os.path.join(rdir, "manifest.json")))
    monkeypatch.setenv("AR_RESUME_DIR", rdir)
    with caplog.at_level("WARNING", logger="autoround_tpu_torch"):
        res = quantize_model(tp, tcfg, tplan, ids, QuantizeConfig(**KW))
    assert "signature mismatch" in caplog.text
    new = json.load(open(os.path.join(rdir, "manifest.json")))
    assert new["signature"] != old["signature"] and new["done"] == [0, 1]
    _bit_equal(plain, res)


@pytest.mark.parametrize("stop_after", [1, 2])
def test_nblocks_resumes_at_a_group_boundary(ids, tmp_path, monkeypatch,
                                             stop_after):
    """``nblocks=2`` over 4 layers: every member of a tuned group is saved
    with the group's end chain; a stop after block 1 (group 0 whole)
    restarts at block 2, a stop after block 2 (group 1 half saved) too."""
    model = _model(4)
    _, _, tcfg, tp, _, tplan = model
    want = quantize_model(tp, tcfg, tplan, ids,
                          QuantizeConfig(nblocks=2, **KW))
    res = _run(model, ids, str(tmp_path / "r"), stop_after, monkeypatch,
               nblocks=2)
    assert sorted(res.loss_traces) == [2]
    _bit_equal(want, res, tuned_from=2)


def test_resume_under_offload(tiny, ids, plain, tmp_path, monkeypatch):
    """Host-offloaded blocks: the restored block stays on the host, and
    the result equals the on-device uninterrupted run."""
    res = _run(tiny, ids, str(tmp_path / "r"), 0, monkeypatch,
               offload_params=True)
    _bit_equal(plain, res, tuned_from=1)


def test_layout_equals_jax(tiny, ids, jax_run, tmp_path):
    """The files under the resume directory: the same names, manifest,
    payload keys and dtypes (fp32 layers, the chains in the model's
    dtype) as the JAX package's."""
    _, jdir = jax_run
    tdir = str(tmp_path / "r")
    _run(tiny, ids, tdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "block_0.safetensors", "block_1.safetensors", "chain_1.safetensors",
        "manifest.json"]
    jm = json.load(open(os.path.join(jdir, "manifest.json")))
    tm = json.load(open(os.path.join(tdir, "manifest.json")))
    assert sorted(tm) == sorted(jm) == ["done", "signature"]
    assert tm["done"] == jm["done"] == [0, 1]
    for f in ("block_0.safetensors", "block_1.safetensors",
              "chain_1.safetensors"):
        with SafeOpen(os.path.join(jdir, f)) as j, \
                SafeOpen(os.path.join(tdir, f)) as t:
            assert sorted(t.keys()) == sorted(j.keys()), f
            for k in j.keys():
                assert t.dtype_code(k) == j.dtype_code(k), (f, k)
                assert t.shape(k) == j.shape(k), (f, k)
    with SafeOpen(os.path.join(tdir, "chain_1.safetensors")) as t:
        assert sorted(t.keys()) == ["x_fp", "x_q"]
    st = tresume.ResumeState(tdir, tm["signature"])
    assert st.next_block() == 2
    st.clear()
    assert os.listdir(tdir) == []
