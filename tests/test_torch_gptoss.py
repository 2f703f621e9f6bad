"""Port parity for GPT-OSS (``models/gptoss.py``): YaRN rope, sink
attention, the clamped SwiGLU and its gradient on a bound, the biased
router, the routed MLP on its three routes, the block and the model, RTN
and SignRound, export, the HF reader (fused, interleaved experts) and the
CLI, then serving: the engine (int8 / fp32 / fp8 KV past the window, sinks
in every softmax), ``generate_scan``, the batcher, capacity dispatch,
``from_pretrained`` and the dense fallback's warning, each against the JAX
package on the same numpy inputs, on ``tiny-gptoss``.  Every norm gain
and every bias is moved off its initial value by N(0, 0.1), the sinks are
drawn from N(0, 1) and the router bias from N(0, 0.5), so each counts.

Tolerances (fp32 throughout, CPU; those of ``tests/test_torch_deepseek.py``):
  * rope tables: 1e-6; router: indices equal, weights 1e-6;
  * routed MLP on each route and the sink attention: 1e-5;
  * block, model and engine logits: 1e-4 (the port packs every projection
    at g = 32, the JAX engine's TPU tiles take none of these shapes and
    serve the same qdq weights dense: the products agree to fp32 order);
  * RTN: at least 99.8% of each layer's codes equal, scales rtol 5e-7;
  * SignRound (4 iterations a block): first loss rtol 1e-3, best loss and
    trace rtol 5e-6;
  * export, the CLI's export: bytes equal; HF load: leaves equal;
  * KV codes: at least 99.9% equal, the rest one step apart; tokens equal;
  * ``from_pretrained`` against the in-memory engine: 1e-2 (the files
    store fp16 scales).
"""

import dataclasses
import filecmp
import functools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu import cli as jcli
from autoround_tpu import envs as jenvs
from autoround_tpu.export import save_quantized as j_save
from autoround_tpu.models import gptoss as jg
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import ContinuousBatchingEngine as JCB
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import gptoss as tg
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import save_file
from test_torch_deepseek import _layers_close, _leaves_equal
from test_torch_deepseek_serve import _codes_close
from _port_threads import one_torch_thread  # noqa: F401

ROPE_TOL = 1e-6
ROUTE_TOL = 1e-6
MLP_TOL = 1e-5
LOGIT_TOL = 1e-4
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6
FP16_SCALE_TOL = 1e-2
MAX_SEQ = 32

JCFG = jg.CONFIG_PRESETS["tiny-gptoss"]
IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def make_pair(seed=0, jcfg=JCFG):
    """(jcfg, JAX params, port cfg, port params): JAX ``init_params`` with
    every 1-D leaf moved (norms and biases by N(0, 0.1), the sinks drawn
    from N(0, 1), the router bias from N(0, 0.5)), carried to the port."""
    tree = jax.tree.map(np.asarray, jg.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def move(d):
        for k, v in d.items():
            if isinstance(v, np.ndarray) and v.ndim == 1:
                std = {"sinks": 1.0, "router_bias": 0.5}.get(k, 0.1)
                d[k] = (v + rng.normal(0, std, v.shape)).astype(v.dtype)

    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        move(b)
        for ew in b["experts"]:
            move(ew)
    tcfg = port_config(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(
        tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair()


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    for name, jcfg in jg.CONFIG_PRESETS.items():
        cfg = ALL_PRESETS[name]
        assert type(cfg) is tg.GptOssConfig
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        fns = get_model_fns(cfg)
        assert fns.block_fwd is tg.block_fwd
        assert fns.rope_tables is tg.rope_tables
        assert not hasattr(fns, "block_fwd_for")
        assert fns.block_linear_names(cfg) == jg.block_linear_names(jcfg)
    assert type(port_config(JCFG)) is tg.GptOssConfig
    jp = jg.init_params(JCFG, jax.random.PRNGKey(0))
    tp = tg.init_params(ALL_PRESETS["tiny-gptoss"],
                        torch.Generator().manual_seed(0), "cpu")
    meta = lambda t: (tuple(t.shape), str(t.dtype))
    assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
        jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp))
    # the sinks and the router bias stay fp32 under a bf16 model
    bf = dataclasses.replace(ALL_PRESETS["tiny-gptoss"], dtype=torch.bfloat16)
    b0 = tg.init_params(bf, torch.Generator().manual_seed(0), "cpu")[
        "blocks"][0]
    assert b0["sinks"].dtype == b0["router_bias"].dtype == torch.float32
    assert b0["q_bias"].dtype == torch.bfloat16
    bb = params_from_jax(jax.tree.map(np.asarray, jp), bf, "cpu")[
        "blocks"][0]
    assert bb["sinks"].dtype == bb["router_bias"].dtype == torch.float32


# ------------------------------------------------------------------- rope

ROPES = {
    "plain": {},
    "yarn": dict(yarn_factor=32.0, yarn_original_max_pos=4096),
    "yarn-truncate": dict(yarn_factor=32.0, yarn_truncate=True),
    "yarn-att": dict(yarn_factor=4.0, yarn_attention_factor=1.25,
                     yarn_original_max_pos=16),
    "yarn-20b": dict(rope_theta=150000.0, head_dim=64, yarn_factor=32.0,
                     yarn_original_max_pos=4096),
}


@pytest.mark.parametrize("rope", sorted(ROPES))
def test_rope_tables_match_jax(rope):
    jcfg = dataclasses.replace(JCFG, **ROPES[rope])
    tcfg = port_config(jcfg)
    for S in (1, 37):
        for j, t in zip(jg.rope_tables(jcfg, S),
                        tg.rope_tables(tcfg, S, device="cpu")):
            assert t.shape == (S, jcfg.hd)
            _close(j, t, ROPE_TOL)
    pos = np.array([0, 5, 4095, 70000], np.int32)
    for j, t in zip(jg.rope_tables(jcfg, 1, positions=jnp.asarray(pos)),
                    tg.rope_tables(tcfg, 1, positions=torch.from_numpy(pos))):
        _close(j, t, ROPE_TOL)


# ------------------------------------------------------- attention, SwiGLU

@pytest.mark.parametrize("masked", [False, True])
def test_sink_attention_matches_jax(masked, pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(2)
    B, S, nh, nkv, hd = 2, 12, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (nh, nkv, nkv))
    sinks = jp["blocks"][0]["sinks"]
    jm = jg.llama.sliding_mask(jcfg, S) if masked else None
    tm = tl.sliding_mask(tcfg, S) if masked else None
    want = jg.sink_attention(*map(jnp.asarray, (q, k, v)), jm, sinks, jcfg)
    got = tg.sink_attention(*map(torch.from_numpy, (q, k, v)), tm,
                            tp["blocks"][0]["sinks"], tcfg)
    _close(want, got, MLP_TOL)
    # the sinks take mass: without them the output differs
    plain = tl.attention(*map(torch.from_numpy, (q, k, v)), tm, tcfg)
    assert (plain - got).abs().max() > 1e-2


def test_clamped_swiglu_and_its_gradient_on_a_bound():
    """Values, and the gradient of ``jnp.clip``: half on a bound (gate at
    +7, up at ±7), whole inside, zero outside."""
    lim = JCFG.swiglu_limit
    gate = np.array([-9.0, -1.0, 0.5, lim, 9.0, 3.0], np.float32)
    up = np.array([-lim, -9.0, 0.25, lim, 9.0, -3.0], np.float32)
    f = lambda g, u: jnp.sum(jg._clamped_swiglu(g, u, JCFG)
                             * jnp.arange(1.0, 7.0))
    jgg, jgu = jax.grad(f, argnums=(0, 1))(jnp.asarray(gate),
                                           jnp.asarray(up))
    tgate = torch.tensor(gate, requires_grad=True)
    tup = torch.tensor(up, requires_grad=True)
    out = tg._clamped_swiglu(tgate, tup, port_config(JCFG))
    _close(jg._clamped_swiglu(jnp.asarray(gate), jnp.asarray(up), JCFG),
           out, MLP_TOL)
    (out * torch.arange(1.0, 7.0)).sum().backward()
    _close(jgg, tgate.grad, MLP_TOL)
    _close(jgu, tup.grad, MLP_TOL)
    assert tgate.grad[3] != 0 and tup.grad[0] != 0     # halved, not zero


# ---------------------------------------------------------------- routing

def test_route_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    h = np.random.default_rng(4).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    blk = jp["blocks"][1]
    logits = (jnp.einsum("...h,eh->...e", jnp.asarray(h), blk["router"])
              + blk["router_bias"])
    jv, ji = jax.lax.top_k(logits, jcfg.top_k)
    ti, tw = tg._route(tp["blocks"][1], torch.from_numpy(h), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(jax.nn.softmax(jv, axis=-1), tw, ROUTE_TOL)
    assert len({tuple(r) for r in ti.reshape(-1, 2).tolist()}) > 1


def _lfs(jblk, tblk, grouped):
    """Linear interceptors for both packages (adding the bias when given),
    and (with ``grouped``) a grouped form over the stacked expert
    weights."""
    def jlf(name, x, w, b=None):
        y = jnp.einsum("...i,oi->...o", x, w)
        return y if b is None else y + b

    def tlf(name, x, w, b=None):
        y = torch.einsum("...i,oi->...o", x, w)
        return y if b is None else y + b

    if grouped:
        names = ("gate_proj", "up_proj", "down_proj")
        jst = {n: jnp.stack([e[n] for e in jblk["experts"]]) for n in names}
        tst = {n: torch.stack([e[n] for e in tblk["experts"]])
               for n in names}
        jlf.grouped = lambda n, buf: jnp.einsum("eck,eok->eco", buf, jst[n])
        tlf.grouped = lambda n, buf: torch.einsum("eck,eok->eco", buf,
                                                  tst[n])
        jlf.grouped_names = tlf.grouped_names = frozenset(names)
    return jlf, tlf


def test_moe_mlp_three_forms_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    jblk, tblk = jp["blocks"][1], tp["blocks"][1]
    h = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    full = jcfg.num_experts / jcfg.top_k              # C = N: nothing drops
    outs = {}
    for grouped in (False, True):
        jlf, tlf = _lfs(jblk, tblk, grouped)
        for factor in (0.0, full):
            want = jg._moe_mlp(jblk, jnp.asarray(h), jcfg, jlf,
                               capacity_factor=factor)
            got = tg._moe_mlp(tblk, torch.from_numpy(h), tcfg, tlf,
                              capacity_factor=factor)
            assert got.shape == h.shape and got.dtype == torch.float32
            _close(want, got, MLP_TOL)
            outs[grouped, factor] = got
    for key in ((True, 0.0), (False, full), (True, full)):
        torch.testing.assert_close(outs[key], outs[False, 0.0], rtol=MLP_TOL,
                                   atol=MLP_TOL)


def test_block_and_model_fwd_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    ids = np.random.default_rng(7).integers(0, 256, (2, 12))   # S > window
    x = jg.llama.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jg.rope_tables(jcfg, 12)
    tc, ts = tg.rope_tables(tcfg, 12, device="cpu")
    tx = torch.from_numpy(np.array(x))
    jm, tm = jg.llama.sliding_mask(jcfg, 12), tl.sliding_mask(tcfg, 12)
    for mask in (False, True):
        _close(jg.block_fwd(jp["blocks"][0], x, jc, js, jcfg,
                            mask=jm if mask else None),
               tg.block_fwd(tp["blocks"][0], tx, tc, ts, tcfg,
                            mask=tm if mask else None), LOGIT_TOL)
    _close(jg.model_fwd(jp, jnp.asarray(ids), jcfg),
           tg.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


# ------------------------------------------------------ quantize and export

def _both(pair, **kw):
    jcfg, jp, tcfg, tp = pair
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(IDS))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(IDS), ar


@pytest.fixture(scope="module")
def rtn(pair):
    return _both(pair, scheme="W4A16G32", iters=0, quant_lm_head=True)




def test_rtn_like_jax(pair, rtn):
    jres, tres, ar = rtn
    _layers_close(jres, tres)
    E = JCFG.num_experts
    assert len(tres.layers) == JCFG.num_layers * (4 + 3 * E) + 1
    assert set(ar.layer_schemes) == set(tres.layers)
    # the router, its bias, the sinks and the biases stay as they were
    blk, orig = tres.params["blocks"][1], pair[3]["blocks"][1]
    for k in ("router", "router_bias", "sinks", "q_bias", "o_bias"):
        assert blk[k] is orig[k], k
    assert blk["experts"][2]["up_bias"] is orig["experts"][2]["up_bias"]
    assert not any(n.endswith(("router", "bias", "sinks"))
                   for n in tres.layers)


def test_signround_traces_like_jax(pair):
    jres, tres, _ = _both(pair, scheme="W4A16G32", iters=4, batch_size=4,
                          seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
        np.testing.assert_allclose(tt.min(), jt.min(), rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
def test_export_bytes_equal_the_jax_package(fmt, pair, rtn, tmp_path):
    jres, _, ar = rtn
    jd_ = j_save(jres, JCFG, str(tmp_path / "j"), fmt)
    td_ = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd_, f), os.path.join(td_, f),
                           shallow=False), f
    if fmt == "fake":
        params, qcfg = load_fake(td_)
        cfg = config_from_jax(qcfg["model_config"])
        assert type(cfg) is tg.GptOssConfig
        assert dataclasses.replace(cfg, dtype=torch.float32) == pair[2]
        assert params["blocks"][0]["sinks"].dtype == torch.float32
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(tg.model_fwd(params, ids, cfg),
                                   tg.model_fwd(ar.result.params, ids, cfg),
                                   rtol=0, atol=0)


# --------------------------------------------------------------------- HF

def write_hf(tree, cfg, path):
    """An HF ``gpt_oss`` directory from a numpy tree: the experts fused
    (``gate_up_proj`` (E, H, 2I), gate columns even and up odd; its bias
    likewise; ``down_proj`` (E, I, H)), as the published checkpoints
    store them (bf16 files, fp32 sinks and router bias)."""
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16()
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    t = {"model.embed_tokens.weight": bf(tree["embed_tokens"]),
         "model.norm.weight": bf(tree["norm"]),
         "lm_head.weight": bf(tree["lm_head"])}
    for li, b in enumerate(tree["blocks"]):
        p = f"model.layers.{li}."
        for n in ("q", "k", "v", "o"):
            t[f"{p}self_attn.{n}_proj.weight"] = bf(b[f"{n}_proj"])
            t[f"{p}self_attn.{n}_proj.bias"] = bf(b[f"{n}_bias"])
        t[p + "self_attn.sinks"] = f32(b["sinks"])
        t[p + "input_layernorm.weight"] = bf(b["input_layernorm"])
        t[p + "post_attention_layernorm.weight"] = bf(
            b["post_attention_layernorm"])
        t[p + "mlp.router.weight"] = bf(b["router"])
        t[p + "mlp.router.bias"] = f32(b["router_bias"])
        ex = b["experts"]
        E, (I, H) = len(ex), np.shape(ex[0]["gate_proj"])
        gu = np.zeros((E, H, 2 * I), np.float32)
        gub = np.zeros((E, 2 * I), np.float32)
        for e, ew in enumerate(ex):
            gu[e, :, 0::2] = np.asarray(ew["gate_proj"]).T
            gu[e, :, 1::2] = np.asarray(ew["up_proj"]).T
            gub[e, 0::2], gub[e, 1::2] = ew["gate_bias"], ew["up_bias"]
        t[p + "mlp.experts.gate_up_proj"] = bf(gu)
        t[p + "mlp.experts.gate_up_proj_bias"] = bf(gub)
        t[p + "mlp.experts.down_proj"] = bf(np.stack(
            [np.asarray(ew["down_proj"]).T for ew in ex]))
        t[p + "mlp.experts.down_proj_bias"] = bf(np.stack(
            [ew["down_bias"] for ew in ex]))
    os.makedirs(path, exist_ok=True)
    save_file(t, os.path.join(path, "model.safetensors"))
    hf = dict(model_type="gpt_oss", vocab_size=cfg.vocab_size,
              hidden_size=cfg.hidden_size,
              intermediate_size=cfg.intermediate_size,
              num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads,
              num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
              sliding_window=cfg.sliding_window,
              num_local_experts=cfg.num_experts,
              num_experts_per_tok=cfg.top_k, tie_word_embeddings=False,
              rope_scaling=dict(rope_type="yarn", factor=4.0, beta_fast=32.0,
                                beta_slow=1.0, truncate=False,
                                original_max_position_embeddings=16))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return path



def test_load_hf_checkpoint_like_jax(pair, tmp_path):
    tree = jax.tree.map(np.asarray, pair[1])
    path = write_hf(tree, JCFG, str(tmp_path / "hf"))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        tp, tcfg = th.load_hf_checkpoint(path, dt, device="cpu")
        jp, jcfg = jh.load_hf_checkpoint(path, jdt)
        assert type(tcfg) is tg.GptOssConfig
        assert tcfg == config_from_jax(dataclasses.asdict(jcfg))
        assert tcfg.yarn_factor == 4.0 and tcfg.sliding_window == 8
        _leaves_equal(jax.tree.map(lambda t: t.float().numpy(), tp), jp)
        b = tp["blocks"][1]
        assert b["sinks"].dtype == b["router_bias"].dtype == torch.float32
        assert b["experts"][0]["gate_bias"].dtype == dt
    with pytest.raises(NotImplementedError, match="no HF writer"):
        th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "out"))


def test_cli_on_a_gpt_oss_directory(pair, tmp_path, capsys, monkeypatch):
    """An HF ``gpt_oss`` directory through both CLIs: the exports are
    byte-equal."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    write_hf(jax.tree.map(np.asarray, pair[1]), JCFG, str(tmp_path / "m"))
    np.save(tmp_path / "ids.npy", IDS)
    argv = ["--model", str(tmp_path / "m"), "--recipe", "rtn", "--iters",
            "0", "--dataset", str(tmp_path / "ids.npy"), "--nsamples", "8",
            "--seqlen", "16", "--format", "autoround", "--group-size", "32",
            "--device", "cpu", "--quant-lm-head"]
    assert jcli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + ["--output", str(tmp_path / "t")]) == 0
    trep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trep["layers"] == jrep["layers"] == 2 * (4 + 3 * 4) + 1
    for f in ("model.safetensors", "quantization_config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f


# ---------------------------------------------------------------- serving

# one JAX engine per result and cache kind, shared by the tests that read
# it (each compiles its prefill / decode once); a keyword (a capacity run,
# which the JAX engine reads from its environment as it traces) builds anew
_JAX_ENGINES = {}


def _jax_engine(jres, jcfg, kv_quant, fresh):
    if fresh:
        return JQuantizedLlama.from_quantize_result(
            jres, jcfg, max_seq=MAX_SEQ, kv_quant=kv_quant)
    key = (id(jres), kv_quant)
    hit = _JAX_ENGINES.get(key)
    if hit is None or hit[0] is not jres:
        eng = JQuantizedLlama.from_quantize_result(
            jres, jcfg, max_seq=MAX_SEQ, kv_quant=kv_quant)
        hit = _JAX_ENGINES[key] = (jres, eng)
    return hit[1]


def _engines(rtn, kv_quant=None, **kw):
    """(JAX engine, port engine) over the RTN results of ``rtn``."""
    return (_jax_engine(rtn[0], JCFG, kv_quant, bool(kw)),
            QuantizedLlama.from_quantize_result(
                rtn[1], make_pair()[2], max_seq=MAX_SEQ, kv_quant=kv_quant,
                device="cpu", **kw))



def test_engine_stacks_the_biased_experts(rtn):
    _, te = _engines(rtn)
    stacked = sorted(k for k in te.packed if "experts_stack" in k)
    assert stacked == [f"blocks.{b}.experts_stack.{w}" for b in (0, 1)
                       for w in ("down_proj", "gate_proj", "up_proj")]
    assert not any(".experts." in k for k in te.packed)
    assert "blocks.0.qkv" in te.packed and "lm_head" in te.packed
    # the biases stay dense leaves beside the stacks
    assert te.params["blocks"][0]["experts"][3]["down_bias"] is not None
    assert te.params["blocks"][0]["experts"][3]["down_proj"] is None


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_prefill_and_decode_match_the_jax_engine(kv_quant, rtn):
    """A 12-token prompt (the even layer's 8-token window bites at
    prefill) and three decode steps past it."""
    je, te = _engines(rtn, kv_quant)
    p = np.random.default_rng(2).integers(0, 256, (2, 12))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    if kv_quant is None:
        _close(jc.k[:, :, :12], tc.k[:, :, :12], LOGIT_TOL)
    else:
        np.testing.assert_allclose(tc.k_scale.numpy(),
                                   np.asarray(jc.k_scale), rtol=1e-6)
        _codes_close(jc.k[:, :, :12], tc.k[:, :, :12])
        _codes_close(jc.v[:, :, :12], tc.v[:, :, :12])
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(3):
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)
        _close(jlog, tlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_scan_equals_generate_and_jax(kv_quant, rtn):
    je, te = _engines(rtn, kv_quant)
    rng = np.random.default_rng(3)
    for _ in range(2):           # a second call with new prompts replays
        p = rng.integers(0, 256, (2, 10))
        want = np.asarray(je.generate_scan(jnp.asarray(p), max_new_tokens=6))
        got = te.generate_scan(p, max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(te.generate(p, max_new_tokens=6),
                                      want)


def test_batcher_schedule_equals_jax(rtn):
    """The JAX ``test_continuous_batching`` case (a 10- and a 3-token
    prompt in 16-token buckets), with a late join after two steps: each
    request's tokens equal ``generate`` alone and the JAX batcher's."""
    je, te = _engines(rtn)
    te.max_seq = je.max_seq = 64
    cb = ContinuousBatchingEngine(te, max_batch=3, max_seq=64,
                                  prompt_buckets=(16,))
    jcb = JCB(je, max_batch=3, max_seq=64, prompt_buckets=(16,))
    prompts = [[3, 5, 7, 2, 9, 11, 1, 8, 6, 4], [12, 4, 9],
               [7, 7, 1, 2, 9, 9, 3, 1, 4, 4, 2]]
    rids = [cb.submit(p, max_new_tokens=6) for p in prompts[:2]]
    jrids = [jcb.submit(p, max_new_tokens=6) for p in prompts[:2]]
    steps = 0
    while cb.pending() or jcb.pending():
        cb.step()
        jcb.step()
        steps += 1
        if steps == 2:
            rids.append(cb.submit(prompts[2], max_new_tokens=5))
            jrids.append(jcb.submit(prompts[2], max_new_tokens=5))
    for p, rid, jrid in zip(prompts, rids, jrids):
        got = cb.result(rid)
        want = te.generate(torch.tensor([p]), max_new_tokens=len(got))
        assert got == want[0].tolist()
        assert got == list(map(int, jcb.result(jrid)))


def test_capacity_dispatch_in_the_engine(rtn, monkeypatch):
    full = JCFG.num_experts / JCFG.top_k
    _, base = _engines(rtn)
    monkeypatch.setattr(jenvs, "AR_MOE_CAPACITY_FACTOR", full)
    je, te = _engines(rtn, moe_capacity_factor=full)
    p = np.random.default_rng(5).integers(0, 256, (2, 12))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    torch.testing.assert_close(tlog, base.prefill(p)[0], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close(je.decode_step(jnp.asarray(tok), jc)[0],
           te.decode_step(torch.from_numpy(tok), tc)[0], LOGIT_TOL)


def test_from_pretrained_of_a_gpt_oss_export(rtn, tmp_path):
    out = rtn[2].save_quantized(str(tmp_path / "e"), "autoround")
    le = QuantizedLlama.from_pretrained(out, max_seq=MAX_SEQ, device="cpu",
                                        kv_quant="int8")
    _, te = _engines(rtn, "int8")
    assert type(le.cfg) is tg.GptOssConfig and le.cfg == make_pair()[2]
    assert sorted(le.packed) == sorted(te.packed)
    assert le.params["blocks"][1]["sinks"].dtype == torch.float32
    p = np.random.default_rng(6).integers(0, 256, (2, 12))
    llog, lc = le.prefill(p)
    tlog, tc = te.prefill(p)
    torch.testing.assert_close(llog, tlog, rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
    tok = tlog.argmax(-1).to(torch.int32)
    torch.testing.assert_close(le.decode_step(tok, lc)[0],
                               te.decode_step(tok, tc)[0],
                               rtol=FP16_SCALE_TOL, atol=FP16_SCALE_TOL)


def test_g128_serves_dense_and_names_why(caplog):
    """K = 160 is 1.25 x 128 (as 2880 is 22.5 x 128 in the published
    widths): at g = 128 no projection packs; the engine's warning names the
    shapes, and its logits still equal the JAX engine's."""
    jcfg = dataclasses.replace(JCFG, hidden_size=160, intermediate_size=160)
    jcfg, jp, tcfg, tp = make_pair(seed=1, jcfg=jcfg)
    kw = dict(scheme="W4A16", iters=0)
    ids = IDS[:4]
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
    tres = AutoRound((tp, tcfg), device="cpu", **kw).quantize(ids)
    logger = logging.getLogger("autoround_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="autoround_tpu_torch"):
            te = QuantizedLlama.from_quantize_result(tres, tcfg,
                                                     max_seq=MAX_SEQ,
                                                     device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    assert te.packed == {}
    msg = caplog.text
    assert "not kernel-tileable at g=128" in msg and "(64,160)" in msg
    assert f"{len(tres.layers)} quantized layer(s)" in msg
    je = JQuantizedLlama.from_quantize_result(jres, jcfg, max_seq=MAX_SEQ)
    p = np.random.default_rng(8).integers(0, 256, (2, 12))
    _close(je.prefill(jnp.asarray(p))[0], te.prefill(p)[0], LOGIT_TOL)
