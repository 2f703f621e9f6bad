"""Port parity for the float schemes end to end: ``AutoRound`` with MXFP4,
NVFP4 and FP8_STATIC (their activation quantization in calibration and in
the tuning loss included), RTN and a short tuned run, and the ``fake``
export of the results, against the JAX package from the same weights.

``tiny`` preset, fp32, CPU, 6 iterations.  Tolerances:
  * RTN qdq and weight scales: exact; static activation scales and NVFP4
    global scales rtol 1e-5 (their amax comes from a block forward whose
    products sum in other orders);
  * tuned runs: measured loss traces equal to 1.9e-6 relative and every
    qdq value and scale equal; limits, about 3x: traces rtol 6e-6, at
    least 99.8% of each layer's codes equal (e2m1 codes or e4m3 bytes
    recovered from qdq / scale), scales rtol 5e-7 (one fp32 ulp of a tuned
    clip scale, as in ``tests/test_torch_e2e.py``);
  * NVFP4 tuning with its activations quantized: in the JAX package the
    division's gradient squares an e4m3 group scale that underflowed (a
    zero group, or one far below the static global scale), so its losses
    turn NaN from the third step on; the port's stay finite.  Held: the
    first two losses of block 0 agree (rtol 6e-6) and the port's trace is
    finite.  The weight-only NVFP4 run is held to JAX like the others;
  * ``fake`` export: files byte-identical; the packed ``autoround`` format
    raises for float types in both packages.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.export import save_quantized as j_save
from autoround_tpu.models import llama as jl
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch.serve.engine import e2m1_codes_from_qdq, fp8_from_qdq
from autoround_tpu_torch.utils.convert import (config_from_jax,
                                               params_from_jax,
                                               quantize_result_to_numpy)

JCFG = jl.CONFIG_PRESETS["tiny"]
ACT_RTOL = 1e-5
TRACE_RTOL = 6e-6
SCALE_RTOL = 5e-7
CODES_EQUAL_MIN = 0.998
NV_WEIGHT_ONLY = dict(bits=4, group_size=16, sym=True, data_type="nv_fp")


@pytest.fixture(scope="module")
def model():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(JCFG))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ids = np.random.default_rng(1).integers(0, JCFG.vocab_size, (16, 32))
    return dict(jp=jp, tp=tp, tcfg=tcfg, ids=ids)


def _both(model, **kw):
    jres = JAutoRound((model["jp"], JCFG), **kw).quantize(
        jnp.asarray(model["ids"]))
    ar = AutoRound((model["tp"], model["tcfg"]), device="cpu", **kw)
    return jres, ar.quantize(model["ids"]), ar


@pytest.fixture(scope="module")
def rtn_runs(model):
    built = {}

    def get(scheme):
        if scheme not in built:
            built[scheme] = _both(model, scheme=scheme, iters=0,
                                  quant_lm_head=True)
        return built[scheme]
    return get


def _act_close(jq, tq, attr, name):
    ja, ta = getattr(jq, attr), getattr(tq, attr)
    assert (ja is None) == (ta is None), (name, attr)
    if ja is not None:
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=ACT_RTOL,
                                   err_msg=f"{name} {attr}")


@pytest.mark.parametrize("scheme", ["MXFP4", "NVFP4", "FP8_STATIC"])
def test_rtn_float_schemes_against_jax(rtn_runs, scheme):
    jres, tres, _ = rtn_runs(scheme)
    assert sorted(jres.layers) == sorted(tres.layers)
    assert len(tres.layers) == JCFG.num_layers * 7 + 1
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        np.testing.assert_array_equal(tq.qdq.numpy(), np.asarray(jq.qdq),
                                      err_msg=name)
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale),
                                      err_msg=name)
        _act_close(jq, tq, "act_scale", name)
        _act_close(jq, tq, "act_global_scale", name)
    q0 = tres.layers["blocks.0.q_proj"]
    assert (q0.act_global_scale is not None) == (scheme == "NVFP4")
    assert (q0.act_scale is not None) == (scheme == "FP8_STATIC")
    out = quantize_result_to_numpy(tres)["layers"]["blocks.0.q_proj"]
    assert (out["act_global_scale"] is not None) == (scheme == "NVFP4")


@pytest.mark.parametrize("scheme", ["MXFP4", "NVFP4", "FP8_STATIC"])
def test_fake_export_bytes_of_the_float_schemes(rtn_runs, tmp_path, scheme):
    jres, _, ar = rtn_runs(scheme)
    jd = j_save(jres, JCFG, str(tmp_path / "j"), "fake")
    td = ar.save_quantized(str(tmp_path / "t"), "fake")
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd, f), os.path.join(td, f),
                           shallow=False), f
    with pytest.raises(NotImplementedError):
        j_save(jres, JCFG, str(tmp_path / "ja"), "autoround")
    with pytest.raises(NotImplementedError):
        ar.save_quantized(str(tmp_path / "ta"), "autoround")


def _codes(ql):
    qdq = torch.as_tensor(np.asarray(ql.qdq, np.float32))
    scale = torch.as_tensor(np.asarray(ql.scale, np.float32))
    if ql.scheme.data_type == "fp8":
        return fp8_from_qdq(qdq, scale)[0].view(torch.uint8).numpy()
    return e2m1_codes_from_qdq(qdq, scale.reshape(qdq.shape[0], -1),
                               ql.scheme.group_size).numpy()


@pytest.mark.parametrize("scheme", ["MXFP4", "NV_WEIGHT_ONLY", "FP8_STATIC"])
def test_tuned_float_schemes_against_jax(model, scheme):
    spec = dict(NV_WEIGHT_ONLY) if scheme == "NV_WEIGHT_ONLY" else scheme
    jres, tres, _ = _both(model, scheme=spec, iters=6, batch_size=4, seed=0,
                          lr=5e-3, quant_lm_head=True)
    assert sorted(jres.loss_traces) == sorted(tres.loss_traces) == [0, 1]
    for bi, jt in jres.loss_traces.items():
        tt = tres.loss_traces[bi]
        assert tt.shape == jt.shape == (6,) and np.isfinite(tt).all()
        np.testing.assert_allclose(tt, jt, rtol=TRACE_RTOL)
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        same = np.mean(_codes(jq) == _codes(tq))
        assert same >= CODES_EQUAL_MIN, (name, same)
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=SCALE_RTOL, err_msg=name)
        _act_close(jq, tq, "act_scale", name)


def test_nvfp4_tuning_with_act_quant_stays_finite(model):
    jres, tres, _ = _both(model, scheme="NVFP4", iters=6, batch_size=4,
                          seed=0, lr=5e-3)
    jt, tt = jres.loss_traces[0], tres.loss_traces[0]
    np.testing.assert_allclose(tt[:2], jt[:2], rtol=TRACE_RTOL)
    assert all(np.isfinite(t).all() for t in tres.loss_traces.values())
    assert np.isnan(jt).any()           # the JAX package's, recorded above
