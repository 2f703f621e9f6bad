"""Port parity of the quantize driver's options: ``nblocks > 1``,
``enable_lfq``, ``immediate_save_dir``, ``offload_params``,
``enable_norm_bias_tuning``, ``enable_alg_ext`` / AdamRound end to end,
``W4A16_MIXED``, and the JAX package's quirks the port mirrors, against
the JAX package from the same weights (``tiny`` presets, fp32, CPU).

Tolerances are ``test_torch_e2e.py``'s (``_compare_tuned``: first loss rtol
1e-3, traces and best loss rtol 5e-6, scales rtol 5e-7, at least 99.8% of
each layer's codes equal), and for the tuned norm gains and biases rtol
1e-5 (a baked leaf is one round-free qdq of an offset that sign-SGD moved
by the same steps); RTN results and streamed shards are bit- and
byte-equal.  tiny-qwen3 with its gains moved is the exception stated in
``test_norm_bias_tuning_against_jax``.  The offloaded run is held to the
on-device run of the port exactly (the same arithmetic on the same
device).
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
from autoround_tpu.models import llama as jl
from autoround_tpu.models import mixtral as jm
from autoround_tpu.quantize import orchestrator as jorch
from autoround_tpu.quantize import QuantizeConfig as JQuantizeConfig
from autoround_tpu.quantize import quantize_model as j_quantize_model
from autoround_tpu.quantize import resolve_layer_schemes as j_resolve
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.quantize import orchestrator as torch_orch
from autoround_tpu_torch.quantize.layer_config import resolve_layer_schemes
from autoround_tpu_torch.quantize.orchestrator import (QuantizeConfig,
                                                       quantize_model)
from autoround_tpu_torch.schemes import parse_scheme
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.pytree import tree_map
from test_torch_e2e import _compare_tuned
from _port_threads import one_torch_thread  # noqa: F401

NB_RTOL = 1e-5


def _pair(jcfg, seed=0, perturb=False):
    jp = jax.tree.map(np.asarray, (jm if hasattr(jcfg, "num_experts")
                                   else jl).init_params(
        jcfg, jax.random.PRNGKey(seed)))
    if perturb:
        # move every 1-D leaf (gains, biases) off its initial value, so the
        # norm / bias offsets have something to bake
        rng = np.random.default_rng(seed)
        jp = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)
                                     ).astype(a.dtype) if a.ndim == 1 else a,
                          jp)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, tcfg, "cpu"), \
        tcfg


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.CONFIG_PRESETS["tiny"]
    jp, tp, tcfg = _pair(jcfg)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (8, 16))
    return dict(jcfg=jcfg, jp=jp, tp=tp, tcfg=tcfg, ids=ids)


def _both(m, mask=None, **kw):
    jres = JAutoRound((m["jp"], m["jcfg"]), **kw).quantize(
        jnp.asarray(m["ids"]), mask=None if mask is None
        else jnp.asarray(mask))
    tres = AutoRound((m["tp"], m["tcfg"]), device="cpu", **kw).quantize(
        m["ids"], mask=mask)
    return jres, tres


def _n_linear(m):
    return m["jcfg"].num_layers * 7


# ------------------------------------------------------ tuned options

@pytest.mark.parametrize("kw", [
    dict(scheme="W2A16G64", enable_alg_ext=True),
    dict(scheme="W4A16G32", optimizer="adam", lr=0.005),
    dict(scheme="W2A16G64", nblocks=2),
    dict(scheme="W4A16G32", enable_lfq=True),
])
def test_driver_options_against_jax(tiny, kw):
    jres, tres = _both(tiny, iters=6, batch_size=4, seed=0,
                       quant_lm_head=True, **kw)
    _compare_tuned(jres, tres, _n_linear(tiny) + 1)
    head = tres.layers["lm_head"]
    assert torch.equal(tres.params["lm_head"], head.qdq)
    if kw.get("nblocks"):
        # one trace per group, and the grouped path RTNs the head
        assert sorted(tres.loss_traces) == [0]
        rtn = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu",
                        scheme=kw["scheme"], iters=0,
                        quant_lm_head=True).quantize(tiny["ids"])
        assert torch.equal(head.qdq, rtn.layers["lm_head"].qdq)
    if kw.get("enable_lfq"):
        last = tres.loss_traces[tiny["jcfg"].num_layers - 1]
        # the LM loss of a random model, near ln(vocab), not MSE x 1000
        assert abs(last[0] - np.log(tiny["jcfg"].vocab_size)) < 1.0
    if kw.get("enable_alg_ext"):
        ms = [float(q.scale.abs().max()) for q in tres.layers.values()]
        assert all(np.isfinite(ms))


def test_lfq_respects_mask(tiny):
    mask = np.ones(tiny["ids"].shape, np.float32)
    mask[:, 8:] = 0
    jres, tres = _both(tiny, mask=mask, scheme="W4A16G32", iters=4,
                       batch_size=4, enable_lfq=True)
    _compare_tuned(jres, tres, _n_linear(tiny))


@pytest.mark.parametrize("preset", ["tiny-qwen", "tiny-qwen3"])
def test_norm_bias_tuning_against_jax(preset):
    jcfg = jl.CONFIG_PRESETS[preset]
    jp, tp, tcfg = _pair(jcfg, perturb=True)
    # the same leaves are tuned
    for jb, tb in zip(jp["blocks"], tp["blocks"]):
        assert torch_orch._norm_bias_leaves_for(tb) \
            == jorch._norm_bias_leaves_for(jb)
    leaves = torch_orch._norm_bias_leaves_for(tp["blocks"][0])
    want = ("input_layernorm", "post_attention_layernorm") + (
        ("k_bias", "q_bias", "v_bias") if preset == "tiny-qwen"
        else ("k_norm", "q_norm"))
    assert sorted(leaves) == sorted(want)
    m = dict(jcfg=jcfg, jp=jp, tp=tp, tcfg=tcfg,
             ids=np.random.default_rng(2).integers(0, 256, (8, 16)))
    jres, tres = _both(m, scheme="W4A16G32", iters=6, batch_size=4,
                       enable_norm_bias_tuning=True)
    moved = 0
    for bi, tb in enumerate(tres.params["blocks"]):
        for leaf in leaves:
            moved += not np.array_equal(tb[leaf].numpy(),
                                        tp["blocks"][bi][leaf].numpy())
    assert moved > 0
    if preset == "tiny-qwen3":
        # On these weights block 0's trace leaves the 5e-6 band at step 2
        # with or without norm / bias tuning (a sign flip of sign-SGD: the
        # plain run differs by 1.0e-4 there, the tuned one by 2.3e-2 at
        # step 5; ROADMAP C): the first losses are held, and the best
        # losses to 5%.
        for bi, jt in jres.loss_traces.items():
            tt = tres.loss_traces[bi]
            np.testing.assert_allclose(tt[0], jt[0], rtol=1e-3)
            np.testing.assert_allclose(tt.min(), jt.min(), rtol=0.05)
        return
    _compare_tuned(jres, tres, _n_linear(m))
    for bi, tb in enumerate(tres.params["blocks"]):
        for leaf in leaves:
            np.testing.assert_allclose(
                tb[leaf].numpy(), np.asarray(jres.params["blocks"][bi][leaf]),
                rtol=NB_RTOL, atol=1e-7, err_msg=f"{bi} {leaf}")


# ------------------------------------------------------ mirrored quirks

def test_grouped_path_drops_options_as_jax_does(tiny, caplog):
    """nblocks > 1 takes no lm loss and no norm / bias tuning in the JAX
    package; the port computes the same (and says so), and under Adam the
    clip scales' learning rate and the momentum are not used."""
    kw = dict(scheme="W4A16G32", iters=4, batch_size=4, seed=0, nblocks=2)
    base = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu", **kw) \
        .quantize(tiny["ids"])
    with caplog.at_level("WARNING", logger="autoround_tpu_torch"):
        quirk = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu",
                          enable_lfq=True, enable_norm_bias_tuning=True,
                          **kw).quantize(tiny["ids"])
    assert "enable_lfq, enable_norm_bias_tuning" in caplog.text
    jq = JAutoRound((tiny["jp"], tiny["jcfg"]), enable_lfq=True,
                    enable_norm_bias_tuning=True, **kw).quantize(
        jnp.asarray(tiny["ids"]))
    _compare_tuned(jq, quirk, _n_linear(tiny))
    for name, q in base.layers.items():
        assert torch.equal(q.qdq, quirk.layers[name].qdq), name
    np.testing.assert_array_equal(base.loss_traces[0], quirk.loss_traces[0])
    adam = dict(scheme="W4A16G32", iters=4, batch_size=4, optimizer="adam")
    a = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu", **adam) \
        .quantize(tiny["ids"])
    b = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu", minmax_lr=0.5,
                  **adam).quantize(tiny["ids"])
    for name, q in a.layers.items():
        assert torch.equal(q.qdq, b.layers[name].qdq), name


# ------------------------------------------------------ immediate save

@pytest.mark.parametrize("nblocks", [1, 2])
def test_immediate_save_shards_equal_jax(tiny, tmp_path, nblocks):
    """RTN (nblocks 1): every shard and the index byte-equal to the JAX
    package's under a budget that splits them; tuned with nblocks 2: the
    same tensor names in the same shards."""
    plan_j = j_resolve(2, jl.block_linear_names(tiny["jcfg"]), "W4A16G32",
                       quant_lm_head=True)
    plan_t = resolve_layer_schemes(2, tl.block_linear_names(tiny["tcfg"]),
                                   parse_scheme("W4A16G32"),
                                   quant_lm_head=True)
    iters = 0 if nblocks == 1 else 2
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    j_quantize_model(tiny["jp"], tiny["jcfg"], plan_j,
                     jnp.asarray(tiny["ids"]),
                     JQuantizeConfig(iters=iters, batch_size=4,
                                     nblocks=nblocks, immediate_save_dir=jd,
                                     shard_size_bytes=20_000))
    res = quantize_model(tiny["tp"], tiny["tcfg"], plan_t,
                         torch.as_tensor(tiny["ids"]),
                         QuantizeConfig(iters=iters, batch_size=4,
                                        nblocks=nblocks,
                                        immediate_save_dir=td,
                                        shard_size_bytes=20_000))
    files = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == files and len(files) >= 3
    import json
    with open(os.path.join(td, "model.safetensors.index.json")) as f:
        wm = json.load(f)["weight_map"]
    for name in res.layers:
        assert f"{name}.qweight" in wm and name not in wm
    assert "embed_tokens" in wm and "blocks.0.input_layernorm" in wm
    if iters == 0:
        for fn in files:
            assert filecmp.cmp(os.path.join(jd, fn), os.path.join(td, fn),
                               shallow=False), fn
    else:
        with open(os.path.join(jd, "model.safetensors.index.json")) as f:
            assert json.load(f)["weight_map"] == wm
        # with its quantization_config.json beside it the stream loads as
        # an export: the words of the in-memory engine's, fp16 scales
        from autoround_tpu_torch.export import quantization_config
        with open(os.path.join(td, "quantization_config.json"), "w") as f:
            json.dump(quantization_config(res, tiny["tcfg"]), f)
        loaded = QuantizedLlama.from_pretrained(td, max_seq=32, device="cpu")
        mem = QuantizedLlama.from_quantize_result(res, tiny["tcfg"],
                                                  max_seq=32, device="cpu")
        assert sorted(loaded.packed) == sorted(mem.packed)
        for k, e in loaded.packed.items():
            assert torch.equal(e[0], mem.packed[k][0]), k
            assert torch.equal(e[1], mem.packed[k][1].half().float()), k


# ------------------------------------------------------ offload

@pytest.fixture(scope="module")
def offload_pair(tiny):
    kw = dict(scheme="W4A16G32", iters=3, batch_size=4, seed=7,
              quant_lm_head=True)
    dev = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu", **kw) \
        .quantize(tiny["ids"])
    ar = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu",
                   offload_params=True, **kw)
    return dev, ar.quantize(tiny["ids"]), ar


def test_offload_matches_on_device_run(offload_pair):
    dev, off, _ = offload_pair
    assert sorted(dev.layers) == sorted(off.layers)
    for name, q in dev.layers.items():
        assert torch.equal(q.qdq, off.layers[name].qdq), name
        assert torch.equal(q.scale, off.layers[name].scale), name
    for bi, b in enumerate(dev.params["blocks"]):
        for k, v in b.items():
            assert torch.equal(v, off.params["blocks"][bi][k]), (bi, k)
    for bi in dev.loss_traces:
        np.testing.assert_array_equal(dev.loss_traces[bi],
                                      off.loss_traces[bi])


def test_offload_result_is_host_resident(offload_pair):
    _, off, _ = offload_pair
    leaf = off.params["blocks"][0]["q_proj"]
    assert leaf.device.type == "cpu"
    ql = off.layers["blocks.0.q_proj"]
    assert ql.qdq.device.type == "cpu"
    # the block leaf and the layer payload are one host tensor
    assert ql.qdq is leaf


def test_offload_save_and_serve(offload_pair, tiny, tmp_path):
    dev, off, ar = offload_pair
    ar.save_quantized(str(tmp_path / "m"), format="fake")
    eng = QuantizedLlama.from_quantize_result(off, tiny["tcfg"], max_seq=32,
                                              device="cpu")
    ref = QuantizedLlama.from_quantize_result(dev, tiny["tcfg"], max_seq=32,
                                              device="cpu")
    q = torch.as_tensor(tiny["ids"][:2, :8])
    l1, _ = eng.prefill(q)
    l2, _ = ref.prefill(q)
    assert torch.equal(l1, l2) and bool(torch.isfinite(l1).all())
    logits = tl.model_fwd(off.params, q, tiny["tcfg"])
    assert bool(torch.isfinite(logits).all())


def test_offload_caller_params_not_mutated(tiny):
    before = tree_map(lambda t: t.clone(), tiny["tp"])
    AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu", scheme="W4A16G32",
              iters=0, offload_params=True).quantize(tiny["ids"])
    assert len(tiny["tp"]["blocks"]) == 2
    for bi, b in enumerate(tiny["tp"]["blocks"]):
        for k, v in b.items():
            assert torch.equal(v, before["blocks"][bi][k]), (bi, k)


def test_offload_donates_blocks(tiny):
    params = tree_map(lambda t: t.clone(), tiny["tp"])
    ar = AutoRound((params, tiny["tcfg"]), device="cpu", scheme="W4A16G32",
                   iters=0, offload_params=True, donate_params=True)
    res = ar.quantize(tiny["ids"])
    assert ar.params["blocks"] == [None, None]
    assert len(res.params["blocks"]) == 2
    # a preset made block by block and parked equals one made at once
    made = AutoRound("tiny", device="cpu", iters=0, seed=3,
                     offload_params=True).params
    whole = tl.init_params(tl.CONFIG_PRESETS["tiny"],
                           torch.Generator().manual_seed(3), "cpu")
    for bi, b in enumerate(whole["blocks"]):
        for k, v in b.items():
            assert torch.equal(v, made["blocks"][bi][k]), (bi, k)


# ------------------------------------------------------ W4A16_MIXED

def test_w4a16_mixed_plan_and_rtn_against_jax():
    jcfg = jm.CONFIG_PRESETS["tiny-moe"]
    jp, tp, tcfg = _pair(jcfg)
    ids = np.random.default_rng(4).integers(0, 256, (4, 16))
    for kw in (dict(), dict(quant_lm_head=True),
               dict(layer_config={"blocks.0.experts.0.w1": "W2A16G64"})):
        jar = JAutoRound((jp, jcfg), scheme="W4A16_MIXED", iters=0, **kw)
        tar = AutoRound((tp, tcfg), scheme="W4A16_MIXED", iters=0,
                        device="cpu", **kw)
        assert sorted(jar.layer_schemes) == sorted(tar.layer_schemes)
        for name, js in jar.layer_schemes.items():
            ts = tar.layer_schemes[name]
            assert (ts.bits, ts.group_size, ts.sym, ts.data_type) == (
                js.bits, js.group_size, js.sym, js.data_type), name
    assert tar.layer_schemes["blocks.0.experts.0.w1"].bits == 2
    assert tar.layer_schemes["blocks.0.experts.1.w1"].bits == 4
    assert tar.layer_schemes["blocks.1.q_proj"].bits == 8
    kw = dict(scheme="W4A16_MIXED", iters=0, quant_lm_head=True)
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
    tres = AutoRound((tp, tcfg), device="cpu", **kw).quantize(ids)
    assert tres.layers["lm_head"].scheme.bits == 8
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(tres.layers[name].qdq.numpy(),
                                      np.asarray(jq.qdq), err_msg=name)
        np.testing.assert_array_equal(tres.layers[name].scale.numpy(),
                                      np.asarray(jq.scale), err_msg=name)
    # GGUF:Q2_K_MIXED expands too: the routed experts Q2_K, the rest
    # Q4_K_S where the width takes a k-quant (Q8_0 at 64), head Q8_0
    plan = AutoRound((tp, tcfg), scheme="GGUF:Q2_K_MIXED", iters=0,
                     device="cpu").layer_schemes
    assert plan["lm_head"].bits == 8 and plan["lm_head"].group_size == 32
    assert "embed_tokens" in plan


def test_left_out_options_name_their_items(tiny, tmp_path):
    """Resume runs through ``AutoRound`` now (its JAX-held checks are in
    ``tests/test_torch_resume.py``): a finished run's directory restores
    every block.  alg_ext on a GGUF double-quant scheme runs, straight into
    ``tune_block`` too (its clip scales start at 1.0; the JAX-held traces
    are in ``tests/test_torch_gguf_e2e.py``)."""
    from autoround_tpu_torch.algorithms.signround import TuneConfig, tune_block
    ids = tiny["ids"][:4]
    kw = dict(device="cpu", iters=2, resume_dir=str(tmp_path / "r"))
    first = AutoRound((tiny["tp"], tiny["tcfg"]), **kw).quantize(ids)
    again = AutoRound((tiny["tp"], tiny["tcfg"]), **kw).quantize(ids)
    assert sorted(first.loss_traces) == [0, 1] and again.loss_traces == {}
    for name, ql in first.layers.items():
        assert torch.equal(again.layers[name].scale, ql.scale), name
    res = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu", iters=2,
                    scheme="GGUF:Q4_K_S", enable_alg_ext=True).quantize(ids)
    assert all(np.isfinite(t).all() for t in res.loss_traces.values())
    w = torch.randn(8, 256, generator=torch.Generator().manual_seed(0))
    best, info = tune_block(lambda ws, x: x @ ws["w"].t(), {"w": w},
                            torch.randn(4, 2, 256, generator=torch.Generator()
                                        .manual_seed(1)),
                            torch.zeros(4, 2, 8),
                            {"w": parse_scheme("GGUF:Q4_K_S")},
                            TuneConfig(iters=1, enable_alg_ext=True))
    assert best["w"]["max_scale"].shape == (8, 8)
    assert np.isfinite(info["loss_trace"]).all()
