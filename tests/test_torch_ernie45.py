"""Port parity for ERNIE-4.5 (``models/ernie45.py``): the interleaved
rope, the router (selection steered by ``e_score_correction_bias``, the
combine on the unbiased probs over a clamped sum, a tie taken lower index
first), the blocks and the model, RTN, SignRound, ``nblocks``, the norm /
bias leaves, offload, export and the CLI by preset, each against the JAX
package on the same numpy inputs; and the refusals of the engine,
``from_pretrained`` and the batcher (the JAX engine serves no ERNIE
model).

Two configs: ``tiny-ernie45`` (the dense layer 0, MoE from layer 1, the
tied lm_head) and a variant made by ``dataclasses.replace`` on both sides
with q / k / v biases and MoE on every second layer of four (the
interval), 5 query heads over 1 KV head (ERNIE-4.5-21B-A3B's G = 5).
Every norm gain and bias is moved by N(0, 0.1) and the router biases are
drawn from N(0, 0.1), so each counts.

Tolerances (fp32 throughout, CPU):
  * rope, blocks and model logits: 1e-5;
  * RTN: every code equal, scales rtol 5e-7;
  * SignRound (4 iterations a block): first loss rtol 1e-3, best loss and
    trace rtol 5e-6;
  * norm / bias leaves after tuning: rtol 1e-5;
  * export: bytes equal; the CLI's quantization_config.json: bytes equal
    (a preset's random weights differ between the packages).
"""

import dataclasses
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu import cli as jcli
from autoround_tpu.export import save_quantized as j_save
from autoround_tpu.models import ernie45 as je
from autoround_tpu.models import llama as jl
from autoround_tpu.quantize import orchestrator as jorch
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import ernie45 as te
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.quantize import orchestrator as torch_orch
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from test_torch_deepseek import _codes, SCALE_RTOL
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-5
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6
LEAF_RTOL = 1e-5

BASE = je.CONFIG_PRESETS["tiny-ernie45"]
JPRESETS = {"tiny-ernie45": BASE,
            # biases, MoE at layers 1 and 3 of 4, G = 5
            "tiny-ernie45-g5": dataclasses.replace(
                BASE, num_layers=4, num_heads=5, num_kv_heads=1, head_dim=16,
                use_bias=True, moe_layer_interval=2, tie_embeddings=False)}
NAMES = sorted(JPRESETS)
IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg), type(jcfg).__name__)


def moved_tree(tree, seed):
    rng = np.random.default_rng(seed + 100)
    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        for k, v in b.items():
            if "norm" in k or k.endswith("_bias"):
                b[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def make_pair(name, seed=0):
    """(jcfg, JAX params, port cfg, port params), gains and biases moved;
    made once per process (no test writes into them)."""
    jcfg = JPRESETS[name]
    tree = moved_tree(jax.tree.map(
        np.asarray, je.init_params(jcfg, jax.random.PRNGKey(seed))), seed)
    tcfg = port_config(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def pairs():
    return {n: make_pair(n) for n in NAMES}


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    for name, jcfg in je.CONFIG_PRESETS.items():
        cfg = ALL_PRESETS[name]
        assert type(cfg) is te.Ernie45Config
        assert [f.name for f in dataclasses.fields(cfg)] == [
            f.name for f in dataclasses.fields(jcfg)]
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert port_config(jcfg) == cfg
        fns = get_model_fns(cfg)
        assert fns.block_fwd is te.block_fwd
        assert fns.model_fwd is te.model_fwd
        assert fns.block_linear_names(cfg) == je.block_linear_names(jcfg)
        assert [te.layer_is_moe(cfg, i) for i in range(cfg.num_layers)] == \
            [je.layer_is_moe(jcfg, i) for i in range(cfg.num_layers)]
    big = ALL_PRESETS["ernie4.5-21b-a3b"]
    assert big.num_heads // big.num_kv_heads == 5 and big.hd == 128
    for name, jcfg in JPRESETS.items():
        jp = je.init_params(jcfg, jax.random.PRNGKey(0))
        tp = te.init_params(port_config(jcfg),
                            torch.Generator().manual_seed(0), "cpu")
        meta = lambda t: (tuple(t.shape), str(t.dtype))
        assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
            jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp)), name
    bf = dataclasses.replace(BASE, dtype=jnp.bfloat16)
    carried = params_from_jax(jax.tree.map(np.asarray, je.init_params(
        bf, jax.random.PRNGKey(0))), port_config(bf), "cpu")
    b1 = carried["blocks"][1]
    assert b1["e_score_correction_bias"].dtype == torch.float32
    assert b1["router"].dtype == torch.float32       # as JAX makes it
    assert b1["q_proj"].dtype == torch.bfloat16


# ------------------------------------------------------------------ model

def test_interleaved_rope_matches_jax():
    cos, sin = jl.rope_tables(BASE, 9)
    x = np.random.default_rng(3).standard_normal((2, 9, 4, 16)).astype(
        np.float32)
    tc, ts = tl.rope_tables(port_config(BASE), 9, device="cpu")
    _close(je._apply_rope_interleaved(jnp.asarray(x), cos, sin),
           te._apply_rope_interleaved(torch.from_numpy(x), tc, ts), LOGIT_TOL)
    # the pairs, not the halves, rotate: position 0 leaves x as it is, and
    # one step turns (x[0], x[1]) by the first angle
    y = te._apply_rope_interleaved(torch.from_numpy(x), tc, ts)
    torch.testing.assert_close(y[:, 0], torch.from_numpy(x[:, 0]))
    c, s = float(tc[1, 0]), float(ts[1, 0])
    torch.testing.assert_close(
        y[0, 1, 0, 1], torch.tensor(x[0, 1, 0, 1] * c + x[0, 1, 0, 0] * s))


def test_router_steered_by_the_bias_not_the_weights(pairs):
    """A bias lifts expert 3 into every token's top 2 while the combine
    keeps its unbiased prob; on a flat router (every prob equal, no bias)
    the lower index wins the tie, as ``jax.lax.top_k``; the MoE output on
    both routers against JAX's."""
    jcfg, jp, tcfg, tp = pairs["tiny-ernie45"]
    h = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(
        np.float32)
    w = dict(tp["blocks"][1])
    w["e_score_correction_bias"] = torch.tensor([0.0, 0.0, 0.0, 10.0])
    topi, topv = te._route(w, torch.from_numpy(h), tcfg)
    probs = torch.softmax(torch.from_numpy(h) @ w["router"].T, dim=-1)
    assert (topi == 3).any(-1).all()
    want = torch.gather(probs, -1, topi)
    torch.testing.assert_close(topv, want / want.sum(-1, keepdim=True))
    flat = dict(w, router=torch.zeros_like(w["router"]),
                e_score_correction_bias=torch.zeros(4))
    topi, topv = te._route(flat, torch.from_numpy(h), tcfg)
    assert topi.tolist() == [[[0, 1]] * 5] * 2
    torch.testing.assert_close(topv, torch.full((2, 5, 2), 0.5))
    for tw in (w, flat):
        jw = dict(jp["blocks"][1], router=jnp.asarray(tw["router"].numpy()),
                  e_score_correction_bias=jnp.asarray(
                      tw["e_score_correction_bias"].numpy()))
        _close(je._ernie_moe(jw, jnp.asarray(h), jcfg, jl._plain_linear),
               te._ernie_moe(tw, torch.from_numpy(h), tcfg,
                             tl._plain_linear), LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_blocks_and_model_fwd_match_jax(name, pairs):
    """Each block teacher forced on JAX's input, then the model."""
    jcfg, jp, tcfg, tp = pairs[name]
    ids = np.random.default_rng(7).integers(0, 256, (2, 10))
    x = jl.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jl.rope_tables(jcfg, 10)
    tc, ts = tl.rope_tables(tcfg, 10, device="cpu")
    for bi in range(jcfg.num_layers):
        tx = torch.from_numpy(np.array(x))
        jy = je.block_fwd(jp["blocks"][bi], x, jc, js, jcfg)
        _close(jy, te.block_fwd(tp["blocks"][bi], tx, tc, ts, tcfg),
               LOGIT_TOL)
        x = jy
    _close(je.model_fwd(jp, jnp.asarray(ids), jcfg),
           te.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


# ------------------------------------------------------ quantize and export

def _both(pair, ids=IDS, **kw):
    jcfg, jp, tcfg, tp = pair
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(ids), ar


@pytest.fixture(scope="module")
def rtn(pairs):
    return {n: _both(pairs[n], scheme="W4A16G32", iters=0,
                     quant_lm_head=True) for n in NAMES}


def _codes_equal(jres, tres):
    assert list(tres.layers) == list(jres.layers)
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(_codes(tres.layers[name], True),
                                      _codes(jq, False), err_msg=name)
        np.testing.assert_allclose(tres.layers[name].scale.numpy(),
                                   np.asarray(jq.scale), rtol=SCALE_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_rtn_codes_equal_jax(name, pairs, rtn):
    """Every code equal; the plan pruned per block (the dense blocks lack
    the expert leaves, the MoE blocks the dense MLP); the tied lm_head
    quantizes ``embed_tokens``; the router and its bias stay dense."""
    jres, tres, ar = rtn[name]
    jcfg = pairs[name][0]
    _codes_equal(jres, tres)
    E = jcfg.moe_num_experts
    n_moe = sum(je.layer_is_moe(jcfg, i) for i in range(jcfg.num_layers))
    n_dense = jcfg.num_layers - n_moe
    assert len(tres.layers) == 4 * jcfg.num_layers + 3 * n_dense \
        + n_moe * 3 * (E + 1) + 1
    assert "blocks.0.gate_proj" in tres.layers
    assert not any(k.startswith("blocks.0.experts") for k in tres.layers)
    assert "blocks.1.shared_experts.down_proj" in tres.layers
    assert set(ar.layer_schemes) == set(tres.layers)
    head = "embed_tokens" if jcfg.tie_embeddings else "lm_head"
    assert tres.params[head] is tres.layers["lm_head"].qdq
    blk = tres.params["blocks"][1]
    assert blk["router"] is pairs[name][3]["blocks"][1]["router"]
    assert blk["e_score_correction_bias"].dtype == torch.float32


def test_signround_traces_like_jax(pairs):
    """``tiny-ernie45`` (the G = 5 variant tunes in the ``nblocks`` and
    norm / bias runs below)."""
    jres, tres, _ = _both(pairs["tiny-ernie45"], scheme="W4A16G32",
                          iters=4, batch_size=4, seed=0)
    n = pairs["tiny-ernie45"][0].num_layers
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == list(
        range(n))
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)


def test_nblocks_like_jax(pairs):
    """nblocks = 2 over the interval variant: (dense, MoE) twice."""
    jres, tres, _ = _both(pairs["tiny-ernie45-g5"], scheme="W4A16G32",
                          iters=4, batch_size=4, seed=0, nblocks=2)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 2]
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], jt,
                                   rtol=BEST_LOSS_RTOL)


def test_norm_bias_tuning_takes_every_bias_leaf(pairs):
    """The JAX rule takes every 1-D ``*norm*`` leaf and every ``*_bias``
    leaf: the q / k / v biases and the router's
    ``e_score_correction_bias``.  The tuned leaves against JAX's."""
    jcfg, jp, tcfg, tp = pairs["tiny-ernie45-g5"]
    for jb, tb in zip(jp["blocks"], tp["blocks"]):
        assert torch_orch._norm_bias_leaves_for(tb) \
            == jorch._norm_bias_leaves_for(jb)
    assert torch_orch._norm_bias_leaves_for(tp["blocks"][1]) == (
        "e_score_correction_bias", "input_layernorm", "k_bias",
        "post_attention_layernorm", "q_bias", "v_bias")
    jres, tres, _ = _both(pairs["tiny-ernie45-g5"], ids=IDS[:4],
                          scheme="W4A16G32", iters=4, batch_size=4, seed=0,
                          enable_norm_bias_tuning=True)
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], jt,
                                   rtol=BEST_LOSS_RTOL)
    moved = 0
    for bi, tb in enumerate(tres.params["blocks"]):
        for leaf in torch_orch._norm_bias_leaves_for(tp["blocks"][bi]):
            want = np.asarray(jres.params["blocks"][bi][leaf])
            assert tb[leaf].dtype == tp["blocks"][bi][leaf].dtype
            np.testing.assert_allclose(tb[leaf].numpy(), want,
                                       rtol=LEAF_RTOL, atol=1e-7,
                                       err_msg=f"{bi} {leaf}")
            moved += leaf == "e_score_correction_bias" and not \
                np.array_equal(want, np.asarray(jp["blocks"][bi][leaf]))
    assert moved > 0


def test_offload_and_donate_equal_the_on_device_run(rtn):
    """``offload_params`` with ``donate_params``: every qdq equal to the
    plain run's, the donated blocks released, the qdq on the host."""
    _, tres, _ = rtn["tiny-ernie45"]
    tcfg = make_pair("tiny-ernie45")[2]
    ref = AutoRound((te.init_params(tcfg, torch.Generator().manual_seed(3),
                                    "cpu"), tcfg), scheme="W4A16G32",
                    iters=0, device="cpu", quant_lm_head=True).quantize(IDS)
    ar = AutoRound((te.init_params(tcfg, torch.Generator().manual_seed(3),
                                   "cpu"), tcfg), scheme="W4A16G32", iters=0,
                   device="cpu", quant_lm_head=True, offload_params=True,
                   donate_params=True)
    off = ar.quantize(IDS)
    assert all(b is None for b in ar.params["blocks"])
    assert list(off.layers) == list(ref.layers) == list(tres.layers)
    for n, ql in ref.layers.items():
        assert torch.equal(off.layers[n].qdq, ql.qdq), n


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
@pytest.mark.parametrize("name", NAMES)
def test_export_bytes_equal_the_jax_package(name, fmt, pairs, rtn, tmp_path):
    jres, _, ar = rtn[name]
    jd_ = j_save(jres, pairs[name][0], str(tmp_path / "j"), fmt)
    td_ = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd_, f), os.path.join(td_, f),
                           shallow=False), f
    qcfg = json.loads((tmp_path / "t" / "quantization_config.json"
                       ).read_text())
    cfg = config_from_jax(qcfg["model_config"])
    assert type(cfg) is te.Ernie45Config
    assert cfg == dataclasses.replace(pairs[name][2], dtype=cfg.dtype)
    if fmt == "fake":
        params, _ = load_fake(td_)
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(te.model_fwd(params, ids, cfg),
                                   te.model_fwd(ar.result.params, ids, cfg),
                                   rtol=0, atol=0)


def test_engine_from_pretrained_and_batcher_refuse(rtn, tmp_path):
    """Nothing serves ERNIE-4.5, as in the JAX package: the engine and the
    export's ``from_pretrained`` raise naming the class, so no batcher can
    be given one."""
    _, tres, ar = rtn["tiny-ernie45"]
    cfg = ar.model_cfg
    with pytest.raises(NotImplementedError, match="Ernie45Config"):
        QuantizedLlama.from_quantize_result(tres, cfg, device="cpu")
    out = ar.save_quantized(str(tmp_path / "e"), "autoround")
    with pytest.raises(NotImplementedError, match="Ernie45Config"):
        QuantizedLlama.from_pretrained(out, device="cpu")
    with pytest.raises(NotImplementedError, match="Ernie45Config"):
        QuantizedLlama(cfg=cfg, params={}, packed={})
    # no batcher can be built: its engine refuses at construction
    with pytest.raises(NotImplementedError, match="Ernie45Config"):
        ContinuousBatchingEngine(QuantizedLlama(cfg=cfg, params={},
                                                packed={}),
                                 max_batch=2, max_seq=32)


def test_cli_quantizes_a_preset_like_jax(tmp_path, capsys):
    """``--model tiny-ernie45`` through both CLIs: the same layers and the
    same quantization_config.json (the preset's weights are each
    package's own random numbers)."""
    argv = ["--model", "tiny-ernie45", "--recipe", "rtn", "--iters", "0",
            "--nsamples", "4", "--seqlen", "16", "--format", "autoround",
            "--group-size", "32", "--device", "cpu", "--dataset",
            str(tmp_path / "ids.npy")]
    np.save(tmp_path / "ids.npy", IDS[:4])
    assert jcli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + ["--output", str(tmp_path / "t")]) == 0
    trep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trep["layers"] == jrep["layers"] == 4 * 3 + 3 + 2 * 3 * 5
    f = "quantization_config.json"
    assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f
                                                 ).read_bytes()
