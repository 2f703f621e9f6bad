"""Port parity for the slice as a whole: ``AutoRound(iters > 0)`` (SignRound
block by block, dual chains, lm_head tuned), serving a tuned result, and
export, against the JAX package from the same weights.

``tiny`` preset, fp32, CPU, at most 10 iterations.  Tolerances:
  * per-block first loss: rtol 1e-3 (block 0 reads the same numbers to
    ~1e-6; later blocks start from chains that went through tuned blocks);
  * per-block best loss and the lm_head's: sign-SGD turns last-bit
    differences into different updates, so there is no bitwise target.
    Measured over these runs: best loss equal to 1.4e-6 relative, loss traces
    to 1.6e-6 at every step, every integer code equal, tuned scales equal to
    1.2e-7 relative (one float32 ulp: XLA fuses the parameter update into a
    multiply-add, so a tuned clip scale may differ in its last bit and with
    it the last bit of that group's qdq values).  Limits, about 3x: best
    loss and traces rtol 5e-6, scales rtol 5e-7, at least 99.8% of each
    layer's codes equal;
  * export on an RTN run: files byte-identical.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.export import load_fake as j_load_fake
from autoround_tpu.models import llama as jl
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.export import (codes_from_qdq, load_fake,
                                        pack_quantized, save_quantized,
                                        unpack_quantized)
from autoround_tpu_torch.export.shard_writer import ShardWriter
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.quantize.orchestrator import (QuantizeConfig,
                                                       quantize_model)
from autoround_tpu_torch.utils.convert import (config_from_jax,
                                               params_from_jax,
                                               quantize_result_to_numpy,
                                               tune_params_from_jax)
from _port_threads import one_torch_thread  # noqa: F401

JCFG = jl.CONFIG_PRESETS["tiny"]
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6
SCALE_RTOL = 5e-7
CODES_EQUAL_MIN = 0.998


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
def tuned_w2(model):
    return _both(model, scheme="W2A16G64", iters=10, batch_size=4, seed=0,
                 quant_lm_head=True)


def _compare_tuned(jres, tres, n_layers):
    assert sorted(jres.loss_traces) == sorted(tres.loss_traces)
    for bi, jt in jres.loss_traces.items():
        tt = tres.loss_traces[bi]
        assert tt.shape == jt.shape and np.isfinite(tt).all()
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt.min(), jt.min(), rtol=BEST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
    assert sorted(jres.layers) == sorted(tres.layers)
    assert len(tres.layers) == n_layers
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        s = jq.scheme
        jzp = None if jq.zp is None else np.asarray(jq.zp)
        tzp = None if tq.zp is None else tq.zp.numpy()
        jc = codes_from_qdq(np.asarray(jq.qdq), np.asarray(jq.scale), jzp,
                            s.bits, s.group_size)
        tc = codes_from_qdq(tq.qdq.numpy(), tq.scale.numpy(), tzp, s.bits,
                            s.group_size)
        same = np.mean(jc == tc)
        assert same >= CODES_EQUAL_MIN, (name, same)
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=SCALE_RTOL, err_msg=name)


def test_tuned_result_against_jax(tuned_w2):
    jres, tres, _ = tuned_w2
    _compare_tuned(jres, tres, JCFG.num_layers * 7 + 1)
    # the lm_head went through tune_block and its qdq is baked
    head = tres.layers["lm_head"]
    assert head.qdq.shape == (JCFG.vocab_size, JCFG.hidden_size)
    assert torch.equal(tres.params["lm_head"], head.qdq)


def test_tuned_beats_rtn_w2(model, tuned_w2):
    _, tres, _ = tuned_w2
    rtn = AutoRound((model["tp"], model["tcfg"]), scheme="W2A16G64", iters=0,
                    quant_lm_head=True, device="cpu").quantize(model["ids"])
    ids = torch.as_tensor(model["ids"][:8])

    def err(p):
        with torch.no_grad():
            d = tl.model_fwd(p, ids, model["tcfg"]) \
                - tl.model_fwd(model["tp"], ids, model["tcfg"])
        return float((d ** 2).mean())
    assert err(tres.params) < err(rtn.params)
    for trace in tres.loss_traces.values():
        assert trace.min() < trace[0]


@pytest.mark.parametrize("kw", [
    dict(scheme="W4A16", iters=5, batch_size=4, enable_quanted_input=False),
    dict(scheme="W4A16G32", iters=6, batch_size=8, minmax_lr=0.05,
         gradient_accumulate_steps=2, dynamic_max_gap=3),
    dict(scheme="GGUF:Q4_1", iters=4, batch_size=4,
         enable_minmax_tuning=False, ignore_layers=["blocks.1.q_proj"]),
])
def test_tuning_options_against_jax(model, kw):
    jres, tres, _ = _both(model, **kw)
    n = JCFG.num_layers * 7 - len(kw.get("ignore_layers", ()))
    _compare_tuned(jres, tres, n)
    if "ignore_layers" in kw:
        assert torch.equal(tres.params["blocks"][1]["q_proj"],
                           model["tp"]["blocks"][1]["q_proj"])


def test_mask_is_carried_through(model):
    mask = np.ones(model["ids"].shape, np.float32)
    mask[:, 20:] = 0
    kw = dict(scheme="W4A16", iters=4, batch_size=4, quant_lm_head=True)
    jres = JAutoRound((model["jp"], JCFG), **kw).quantize(
        jnp.asarray(model["ids"]), mask=jnp.asarray(mask))
    tres = AutoRound((model["tp"], model["tcfg"]), device="cpu", **kw) \
        .quantize(model["ids"], mask=mask)
    _compare_tuned(jres, tres, JCFG.num_layers * 7 + 1)
    free = AutoRound((model["tp"], model["tcfg"]), device="cpu", **kw) \
        .quantize(model["ids"])
    assert abs(free.loss_traces[1][0] - tres.loss_traces[1][0]) \
        > 1e-3 * free.loss_traces[1][0]


def test_quantize_model_entry_and_unported_options(model, tmp_path):
    from autoround_tpu_torch.quantize.layer_config import (
        resolve_layer_schemes)
    from autoround_tpu_torch.schemes import parse_scheme
    plan = resolve_layer_schemes(JCFG.num_layers, tl.LINEAR_KEYS,
                                 parse_scheme("W4A16"))
    ids = torch.as_tensor(model["ids"][:4])
    res = quantize_model(model["tp"], model["tcfg"], plan, ids,
                         QuantizeConfig(iters=2, batch_size=2))
    assert sorted(res.loss_traces) == [0, 1]
    assert all(not q.qdq.requires_grad for q in res.layers.values())
    assert model["tp"]["blocks"][0] is not None      # nothing donated
    # crash resume runs (tests/test_torch_resume.py holds it against the
    # JAX package): every block listed done, and a second run on the same
    # directory restores them all, equal to the first
    rdir = str(tmp_path / "resume")
    first = quantize_model(model["tp"], model["tcfg"], plan, ids,
                           QuantizeConfig(iters=2, batch_size=2,
                                          resume_dir=rdir))
    with open(os.path.join(rdir, "manifest.json")) as f:
        assert json.load(f)["done"] == [0, 1]
    again = quantize_model(model["tp"], model["tcfg"], plan, ids,
                           QuantizeConfig(iters=2, batch_size=2,
                                          resume_dir=rdir))
    assert again.loss_traces == {}
    for name, ql in first.layers.items():
        assert torch.equal(again.layers[name].qdq.float(), ql.qdq.float())
    # AWQ runs (its JAX-held checks: tests/test_torch_transforms.py); it
    # refuses nblocks > 1 as the JAX package does
    res = quantize_model(model["tp"], model["tcfg"], plan, ids,
                         QuantizeConfig(iters=2, batch_size=2,
                                        enable_awq=True))
    assert sorted(res.layers) == sorted(plan)
    with pytest.raises(ValueError, match="enable_awq"):
        quantize_model(model["tp"], model["tcfg"], plan, ids,
                       QuantizeConfig(iters=2, enable_awq=True, nblocks=2))
    # ported since (tests/test_torch_driver_opts.py holds them against the
    # JAX package): each runs and quantizes every layer
    for kw in (dict(nblocks=2), dict(enable_lfq=True),
               dict(offload_params=True), dict(enable_alg_ext=True),
               dict(optimizer="adam"), dict(enable_norm_bias_tuning=True)):
        res = quantize_model(model["tp"], model["tcfg"], plan, ids,
                             QuantizeConfig(iters=2, batch_size=2, **kw))
        assert sorted(res.layers) == sorted(plan), kw
        assert all(np.isfinite(t).all() for t in res.loss_traces.values())
    # ported since: imatrix collection, static attention scales and a
    # plan that quantizes activations
    res = quantize_model(model["tp"], model["tcfg"], plan, ids,
                         QuantizeConfig(iters=0, use_imatrix=True,
                                        quant_attention=True))
    assert len(res.imatrices) == len(plan) and sorted(
        res.attention_scales) == [0, 1]
    assert res.imatrices["blocks.0.q_proj"].shape == (JCFG.hidden_size,)
    act = resolve_layer_schemes(JCFG.num_layers, tl.LINEAR_KEYS,
                                parse_scheme("W4A8"))
    res = quantize_model(model["tp"], model["tcfg"], act, ids,
                         QuantizeConfig(iters=2, batch_size=2))
    assert sorted(res.loss_traces) == [0, 1] and len(res.layers) == len(act)
    assert all(q.act_scale is None for q in res.layers.values())
    # the GGUF double-quant types quantize (64 is no multiple of the
    # 256-wide super-block, so tiny's plan drops to Q8_0 under
    # apply_gguf_cascade; the raw plan here asks the double quant of a
    # layer it cannot group and raises, as the JAX package's assert does)
    dq = resolve_layer_schemes(JCFG.num_layers, tl.LINEAR_KEYS,
                               parse_scheme("GGUF:Q4_K_S"))
    with pytest.raises(ValueError, match="super-block"):
        quantize_model(model["tp"], model["tcfg"], dq, ids,
                       QuantizeConfig(iters=0))


def test_engine_serves_a_tuned_result(model):
    """W4A16 g32 (every tiny layer packs): greedy tokens from the packed
    engine equal those of ``model_fwd`` on the tuned qdq params, and the
    int4 codes the engine recovers reproduce the tuned qdq exactly."""
    from autoround_tpu_torch.ops.qmatmul import unpack_w4
    res = AutoRound((model["tp"], model["tcfg"]), scheme="W4A16G32", iters=8,
                    batch_size=4, quant_lm_head=True,
                    device="cpu").quantize(model["ids"])
    assert any(t.min() < t[0] for t in res.loss_traces.values())
    eng = QuantizedLlama.from_quantize_result(res, model["tcfg"], max_seq=48,
                                              device="cpu")
    assert "lm_head" in eng.packed and "blocks.0.qkv" in eng.packed
    qw, scales = eng.packed["blocks.1.down_proj"]
    ql = res.layers["blocks.1.down_proj"]
    deq = (unpack_w4(qw).float() - 8) * scales.repeat_interleave(32, dim=1)
    assert torch.equal(deq, ql.qdq)
    assert torch.equal(scales, ql.scale)
    prompts = torch.as_tensor(model["ids"][:3, :16])
    toks = eng.generate(prompts, max_new_tokens=6)
    seq = prompts
    with torch.no_grad():
        for i in range(6):
            nxt = tl.model_fwd(res.params, seq, model["tcfg"])[:, -1].argmax(-1)
            assert torch.equal(nxt.to(toks.dtype), toks[:, i]), i
            seq = torch.cat([seq, nxt[:, None]], dim=1)


# ------------------------------------------------------------------ export

@pytest.fixture(scope="module")
def rtn_pair(model):
    return _both(model, scheme="W4A16G32", iters=0, quant_lm_head=True)


@pytest.fixture(scope="module")
def rtn_pairs(model, rtn_pair):
    """scheme → (JAX result, port result, port AutoRound) of an RTN run."""
    built = {"W4A16G32": rtn_pair}

    def get(scheme):
        if scheme not in built:
            built[scheme] = _both(model, scheme=scheme, iters=0,
                                  quant_lm_head=True)
        return built[scheme]
    return get


@pytest.mark.parametrize("scheme", ["W8A16", "W8A8"])
@pytest.mark.parametrize("fmt", ["fake", "autoround"])
def test_export_bytes_of_the_8bit_schemes(rtn_pairs, tmp_path, fmt, scheme):
    """8-bit codes (per group and per channel) through the packed export,
    and the qdq weights of an act-quantized scheme through ``fake``: the
    files equal the JAX package's byte for byte."""
    jres, tres, ar = rtn_pairs(scheme)
    from autoround_tpu.export import save_quantized as j_save
    jd = j_save(jres, JCFG, str(tmp_path / "j"), fmt)
    td = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd, f), os.path.join(td, f),
                           shallow=False), f
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    if fmt == "autoround":
        from safetensors.numpy import load_file
        t = load_file(os.path.join(td, "model.safetensors"))
        ql = tres.layers["blocks.0.q_proj"]
        O, I = ql.qdq.shape
        g = ql.scheme.group_size if ql.scheme.group_size > 0 else I
        q, s, zp = unpack_quantized(
            {k: t[f"blocks.0.q_proj.{k}"]
             for k in ("qweight", "qzeros", "scales")}, 8, O, I)
        np.testing.assert_array_equal(
            q, codes_from_qdq(ql.qdq.numpy(), ql.scale.numpy(), None, 8, g))
        assert (zp == 128).all() and s.shape == (O, -(-I // g))


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
def test_export_bytes_equal_the_jax_package(rtn_pair, tmp_path, fmt):
    jres, tres, ar = rtn_pair
    from autoround_tpu.export import save_quantized as j_save
    jd = j_save(jres, JCFG, str(tmp_path / "j"), fmt)
    td = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd, f), os.path.join(td, f),
                           shallow=False), f
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))


def test_fake_save_load_roundtrip(model, rtn_pair, tmp_path):
    _, tres, ar = rtn_pair
    out = ar.quantize_and_save(model["ids"], str(tmp_path / "ckpt"), "fake")
    tres = ar.result
    loaded, qcfg = load_fake(out)
    assert qcfg["quant_method"] == "auto-round" and qcfg["fmt"] == "fake"
    assert qcfg["layers"]["blocks.0.q_proj"] == {
        "bits": 4, "group_size": 32, "sym": True, "data_type": "int"}
    ids = torch.as_tensor(model["ids"][:2])
    with torch.no_grad():
        assert torch.equal(tl.model_fwd(loaded, ids, model["tcfg"]),
                           tl.model_fwd(tres.params, ids, model["tcfg"]))
    # the JAX package loads the port's checkpoint
    jloaded, jq = j_load_fake(out)
    assert jq == qcfg
    l0 = jl.model_fwd(jloaded, jnp.asarray(model["ids"][:2]), JCFG)
    np.testing.assert_allclose(
        np.asarray(l0), tl.model_fwd(tres.params, ids, model["tcfg"])
        .detach().numpy(), rtol=1e-5, atol=1e-5)


def test_autoround_packed_export_roundtrip(rtn_pair, tmp_path):
    from safetensors.numpy import load_file
    _, tres, ar = rtn_pair
    out = ar.save_quantized(str(tmp_path / "multi"), "fake, autoround")
    assert sorted(os.listdir(out)) == ["autoround", "fake"]
    t = load_file(os.path.join(out, "autoround", "model.safetensors"))
    assert "blocks.0.q_proj" not in t and "lm_head" not in t
    assert t["blocks.0.input_layernorm"].shape == (JCFG.hidden_size,)
    for name in ("blocks.0.q_proj", "blocks.1.down_proj", "lm_head"):
        ql = tres.layers[name]
        O, I = ql.qdq.shape
        payload = {k: t[f"{name}.{k}"] for k in ("qweight", "qzeros", "scales")}
        assert payload["qweight"].shape == (I * 4 // 32, O)
        assert payload["scales"].dtype == np.float16
        q, s, zp = unpack_quantized(payload, 4, O, I)
        np.testing.assert_array_equal(
            q, codes_from_qdq(ql.qdq.numpy(), ql.scale.numpy(), None, 4, 32))
        assert (zp == 8).all()
        dq = (q.astype(np.float32) - 8) * np.repeat(s, 32, 1)[:, :I]
        np.testing.assert_allclose(dq, ql.qdq.numpy(), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("bits,shape", [(2, (6, 70)), (4, (5, 64)),
                                        (8, (3, 33))])
def test_pack_unpack_equal_the_jax_package(bits, shape):
    from autoround_tpu.export.packing import pack_quantized as j_pack
    rng = np.random.default_rng(bits)
    O, I = shape
    q = rng.integers(0, 2 ** bits, (O, I)).astype(np.uint32)
    scale = rng.uniform(-0.1, 0.1, (O, 2)).astype(np.float32)
    for zp in (None, rng.integers(0, 2 ** bits, (O, 2)).astype(np.float32)):
        a, b = j_pack(q, scale, zp, bits), pack_quantized(q, scale, zp, bits)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        uq, us, uzp = unpack_quantized(b, bits, O, I)
        np.testing.assert_array_equal(uq, q)
        np.testing.assert_array_equal(us, scale.astype(np.float16))
        if zp is not None:
            np.testing.assert_array_equal(uzp, zp)


def test_unported_formats_raise(rtn_pair, tmp_path):
    """The GGUF file writer is left out (A13); the gptq / awq /
    llm_compressor / mlx writers run (their files against the JAX
    package's: ``tests/test_torch_export_formats.py``)."""
    _, tres, ar = rtn_pair
    for fmt in ("gptq", "awq", "llm_compressor", "mlx"):
        out = ar.save_quantized(str(tmp_path / fmt), fmt)
        assert os.path.exists(os.path.join(out, "model.safetensors")), fmt
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ar.save_quantized(str(tmp_path / "x"), "gguf:q4_k_m")
    with pytest.raises(ValueError, match="unknown export format"):
        save_quantized(tres, ar.model_cfg, str(tmp_path / "x"), "nope")
    assert not (tmp_path / "x").exists()
    with pytest.raises(RuntimeError, match="quantize"):
        AutoRound((ar.params, ar.model_cfg), iters=0,
                  device="cpu").save_quantized(str(tmp_path / "y"))


def test_shard_writer_equals_the_jax_package(tmp_path):
    from autoround_tpu.export.shard_writer import ShardWriter as JShardWriter
    rng = np.random.default_rng(0)
    tensors = {f"t{i}": rng.standard_normal((8, 16)).astype(np.float32)
               for i in range(5)}
    for cls, sub in ((JShardWriter, "j"), (ShardWriter, "t")):
        w = cls(str(tmp_path / sub), shard_size_bytes=1024)
        w.add_many(tensors)
        w.finalize()
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 4
    for f in names:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f
    index = json.loads((tmp_path / "t" / "model.safetensors.index.json")
                       .read_text())
    assert index["metadata"] == {"total_shards": 3}
    assert sorted(index["weight_map"]) == sorted(tensors)


def test_convert_helpers(model, tuned_w2):
    _, tres, _ = tuned_w2
    tree = {"q_proj": {"v": np.full((2, 4), 0.25, np.float32),
                       "min_scale": np.ones((2, 1), np.float32),
                       "max_scale": np.asarray(jnp.full((2, 1), 0.5,
                                                        jnp.bfloat16))}}
    tp = tune_params_from_jax(tree, "cpu")
    assert tp["q_proj"]["v"].dtype == torch.float32
    assert float(tp["q_proj"]["max_scale"][0, 0]) == 0.5
    out = quantize_result_to_numpy(tres)
    assert sorted(out) == ["layers", "loss_traces", "params"]
    np.testing.assert_array_equal(out["layers"]["lm_head"]["qdq"],
                                  tres.layers["lm_head"].qdq.numpy())
    assert out["layers"]["lm_head"]["zp"] is None
    assert out["params"]["blocks"][1]["q_proj"].dtype == np.float32
    np.testing.assert_array_equal(out["loss_traces"][0], tres.loss_traces[0])
