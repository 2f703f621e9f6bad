"""Port parity for LongCat-Flash (``models/longcat.py``): the MLA sublayer
with its low-rank scale corrections and the plain ``sqrt(qk_head_dim)``
score scale (no mscale), the router over real plus zero experts (selection
steered by the bias, unnormalised weights, a tie taken lower index first),
the zero experts' identity term, the two-pair block with the MoE shortcut
and the model, RTN, SignRound, ``nblocks``, the norm / bias leaves, offload,
export and the CLI by preset, each against the JAX package on the same
numpy inputs; and the refusals of the engine, ``from_pretrained`` and the
batcher (the JAX engine serves no LongCat model).

Two configs: ``tiny-longcat`` and a variant made by
``dataclasses.replace`` on both sides with ``mscale = 1.3`` (which the
LongCat attention ignores, where DeepSeek's squares it into the score
scale) and 3 zero experts over a top 3.  Every norm gain is moved by N(0,
0.1) and the router biases are drawn from N(0, 0.1), so each counts.

Tolerances (fp32 throughout, CPU):
  * MLA sublayer, MoE, blocks and model logits: 1e-5;
  * RTN: every code equal, scales rtol 5e-7;
  * SignRound (4 iterations a block): first loss rtol 1e-3, best loss and
    trace rtol 5e-6;
  * norm / bias leaves after tuning: rtol 1e-5;
  * export: bytes equal; the CLI's quantization_config.json: bytes equal.
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
from autoround_tpu.models import deepseek as jd
from autoround_tpu.models import llama as jl
from autoround_tpu.models import longcat as jlc
from autoround_tpu.quantize import orchestrator as jorch
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import deepseek as td
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models import longcat as tlc
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

BASE = jlc.CONFIG_PRESETS["tiny-longcat"]
JPRESETS = {"tiny-longcat": BASE,
            "tiny-longcat-mscale": dataclasses.replace(
                BASE, mscale=1.3, zero_expert_num=3, num_experts_per_tok=3)}
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
    """(jcfg, JAX params, port cfg, port params), gains and router biases
    moved."""
    jcfg = JPRESETS[name]
    tree = moved_tree(jax.tree.map(
        np.asarray, jlc.init_params(jcfg, jax.random.PRNGKey(seed))), seed)
    tcfg = port_config(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def pairs():
    return {n: make_pair(n) for n in NAMES}


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    cfg, jcfg = ALL_PRESETS["tiny-longcat"], BASE
    assert type(cfg) is tlc.LongcatConfig
    assert isinstance(cfg, td.DeepseekConfig)
    assert [f.name for f in dataclasses.fields(cfg)] == [
        f.name for f in dataclasses.fields(jcfg)]
    assert port_config(jcfg) == cfg and cfg.total_experts == 6
    assert "total_experts" not in dataclasses.asdict(jcfg)
    fns = get_model_fns(cfg)
    assert fns.block_fwd is tlc.block_fwd and fns.model_fwd is tlc.model_fwd
    assert fns.rope_tables is td.rope_tables
    assert fns.block_linear_names(cfg) == jlc.block_linear_names(jcfg)
    # an export's model_config: zero_expert_num names LongCat (it used to
    # be refused as an unported DeepSeek subclass)
    fields = {k: v for k, v in dataclasses.asdict(jcfg).items()
              if k != "dtype"}
    assert type(config_from_jax(fields)) is tlc.LongcatConfig
    for name, jc in JPRESETS.items():
        jp = jlc.init_params(jc, jax.random.PRNGKey(0))
        tp = tlc.init_params(port_config(jc),
                             torch.Generator().manual_seed(0), "cpu")
        meta = lambda t: (tuple(t.shape), str(t.dtype))
        assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
            jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp)), name
    bf = dataclasses.replace(BASE, dtype=jnp.bfloat16)
    carried = params_from_jax(jax.tree.map(np.asarray, jlc.init_params(
        bf, jax.random.PRNGKey(0))), port_config(bf), "cpu")
    b0 = carried["blocks"][0]
    assert b0["e_score_correction_bias"].dtype == torch.float32
    assert b0["router"].dtype == torch.float32       # as JAX makes it
    assert b0["q_a_proj_1"].dtype == torch.bfloat16


# ------------------------------------------------------------------ model

def _h(seed, H=96, S=6):
    return np.random.default_rng(seed).standard_normal((2, S, H)).astype(
        np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_mla_sublayer_matches_jax(name, pairs):
    """Both sublayers: the (H / q_lora_rank)^0.5 and (H / kv_lora_rank)^0.5
    corrections and the sqrt(qk_head_dim) score scale (mscale 1.3 left
    out, as in JAX)."""
    jcfg, jp, tcfg, tp = pairs[name]
    h = _h(3)
    jc, js = jd.rope_tables(jcfg, 6)
    tc, ts = td.rope_tables(tcfg, 6, device="cpu")
    for s in ("_0", "_1"):
        _close(jlc._mla_sub(jp["blocks"][0], jnp.asarray(h), jc, js, jcfg,
                            jl._plain_linear, s),
               tlc._mla_sub(tp["blocks"][0], torch.from_numpy(h), tc, ts,
                            tcfg, tl._plain_linear, s), LOGIT_TOL)


def test_router_and_zero_experts(pairs):
    """A bias that sends both slots of every token to the zero experts
    (ids 4 and 5) leaves only the identity term ``(w_4 + w_5) · h`` with
    the unnormalised weights x 1.5; a flat router (all scores equal, no
    bias) takes ids 0 and 1, the lower index on the tie; the MoE on both
    routers against JAX's."""
    jcfg, jp, tcfg, tp = pairs["tiny-longcat"]
    h = torch.from_numpy(_h(4))
    w = dict(tp["blocks"][0])
    w["e_score_correction_bias"] = torch.tensor([0, 0, 0, 0, 9.0, 8.0])
    topi, topw = tlc._route(h, w, tcfg)
    scores = torch.softmax(h @ w["router"].T, dim=-1)
    assert topi.tolist() == [[[4, 5]] * 6] * 2
    torch.testing.assert_close(topw, scores[..., 4:] * 1.5)
    out = tlc._sc_moe(w, h, tcfg, tl._plain_linear)
    torch.testing.assert_close(out, h * topw.sum(-1, keepdim=True))
    flat = dict(w, router=torch.zeros_like(w["router"]),
                e_score_correction_bias=torch.zeros(6))
    topi, topw = tlc._route(h, flat, tcfg)
    assert topi.tolist() == [[[0, 1]] * 6] * 2
    torch.testing.assert_close(topw, torch.full((2, 6, 2), 1.5 / 6))
    for tw in (w, flat, tp["blocks"][1]):
        jw = dict(jp["blocks"][0], router=jnp.asarray(tw["router"].numpy()),
                  e_score_correction_bias=jnp.asarray(
                      tw["e_score_correction_bias"].numpy()))
        _close(jlc._sc_moe(jw, jnp.asarray(h.numpy()), jcfg,
                           jl._plain_linear),
               tlc._sc_moe(dict(tp["blocks"][0], router=tw["router"],
                                e_score_correction_bias=tw[
                                    "e_score_correction_bias"]),
                           h, tcfg, tl._plain_linear), LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_blocks_and_model_fwd_match_jax(name, pairs):
    jcfg, jp, tcfg, tp = pairs[name]
    ids = np.random.default_rng(7).integers(0, 256, (2, 10))
    x = jl.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jd.rope_tables(jcfg, 10)
    tc, ts = td.rope_tables(tcfg, 10, device="cpu")
    for bi in range(jcfg.num_layers):
        tx = torch.from_numpy(np.array(x))
        jy = jlc.block_fwd(jp["blocks"][bi], x, jc, js, jcfg)
        _close(jy, tlc.block_fwd(tp["blocks"][bi], tx, tc, ts, tcfg),
               LOGIT_TOL)
        x = jy
    _close(jlc.model_fwd(jp, jnp.asarray(ids), jcfg),
           tlc.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


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


@pytest.mark.parametrize("name", NAMES)
def test_rtn_codes_equal_jax(name, pairs, rtn):
    """Every code equal: both sublayer pairs' MLA projections and MLPs and
    the routed experts (no zero expert has a weight); the router and its
    bias stay FP."""
    jres, tres, ar = rtn[name]
    assert list(tres.layers) == list(jres.layers)
    for n, jq in jres.layers.items():
        np.testing.assert_array_equal(_codes(tres.layers[n], True),
                                      _codes(jq, False), err_msg=n)
        np.testing.assert_allclose(tres.layers[n].scale.numpy(),
                                   np.asarray(jq.scale), rtol=SCALE_RTOL,
                                   err_msg=n)
    assert len(tres.layers) == 2 * (2 * 8 + 3 * 4) + 1
    assert {"blocks.0.q_a_proj_0", "blocks.1.kv_b_proj_1",
            "blocks.1.down_proj_0", "blocks.0.experts.3.up_proj"} \
        <= set(tres.layers)
    assert set(ar.layer_schemes) == set(tres.layers)
    blk = tres.params["blocks"][0]
    assert blk["router"] is pairs[name][3]["blocks"][0]["router"]


def test_signround_traces_like_jax(pairs):
    """The ``mscale`` variant (its score scale without mscale, 3 zero
    experts, a top 3); ``tiny-longcat`` tunes in the ``nblocks`` and norm /
    bias runs below."""
    jres, tres, _ = _both(pairs["tiny-longcat-mscale"], scheme="W4A16G32",
                          iters=4, batch_size=4, seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)


def test_nblocks_like_jax(pairs):
    jres, tres, _ = _both(pairs["tiny-longcat"], scheme="W4A16G32", iters=4,
                          batch_size=4, seed=0, nblocks=2)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0]
    np.testing.assert_allclose(tres.loss_traces[0], jres.loss_traces[0],
                               rtol=BEST_LOSS_RTOL)


def test_norm_bias_tuning_like_jax(pairs):
    """Both pairs' norms (the q / kv LoRA norms too) and the router's
    ``e_score_correction_bias``."""
    jcfg, jp, tcfg, tp = pairs["tiny-longcat"]
    for jb, tb in zip(jp["blocks"], tp["blocks"]):
        assert torch_orch._norm_bias_leaves_for(tb) \
            == jorch._norm_bias_leaves_for(jb)
    leaves = torch_orch._norm_bias_leaves_for(tp["blocks"][0])
    assert len(leaves) == 9 and "e_score_correction_bias" in leaves
    jres, tres, _ = _both(pairs["tiny-longcat"], ids=IDS[:4],
                          scheme="W4A16G32", iters=4, batch_size=4, seed=0,
                          enable_norm_bias_tuning=True)
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], jt,
                                   rtol=BEST_LOSS_RTOL)
    for bi, tb in enumerate(tres.params["blocks"]):
        for leaf in leaves:
            np.testing.assert_allclose(
                tb[leaf].numpy(), np.asarray(jres.params["blocks"][bi][leaf]),
                rtol=LEAF_RTOL, atol=1e-7, err_msg=f"{bi} {leaf}")


def test_offload_and_donate_equal_the_on_device_run(rtn):
    _, tres, _ = rtn["tiny-longcat"]
    tcfg = make_pair("tiny-longcat")[2]

    def fresh():
        return tlc.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    ref = AutoRound((fresh(), tcfg), scheme="W4A16G32", iters=0,
                    device="cpu", quant_lm_head=True).quantize(IDS)
    ar = AutoRound((fresh(), tcfg), scheme="W4A16G32", iters=0, device="cpu",
                   quant_lm_head=True, offload_params=True,
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
    assert type(cfg) is tlc.LongcatConfig
    assert cfg == dataclasses.replace(pairs[name][2], dtype=cfg.dtype)
    if fmt == "fake":
        params, _ = load_fake(td_)
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(tlc.model_fwd(params, ids, cfg),
                                   tlc.model_fwd(ar.result.params, ids, cfg),
                                   rtol=0, atol=0)


def test_engine_from_pretrained_and_batcher_refuse(rtn, tmp_path):
    _, tres, ar = rtn["tiny-longcat"]
    cfg = ar.model_cfg
    with pytest.raises(NotImplementedError, match="LongcatConfig"):
        QuantizedLlama.from_quantize_result(tres, cfg, device="cpu")
    out = ar.save_quantized(str(tmp_path / "e"), "autoround")
    with pytest.raises(NotImplementedError, match="LongcatConfig"):
        QuantizedLlama.from_pretrained(out, device="cpu")
    # no batcher can be built: its engine refuses at construction
    with pytest.raises(NotImplementedError, match="LongcatConfig"):
        ContinuousBatchingEngine(QuantizedLlama(cfg=cfg, params={},
                                                packed={}),
                                 max_batch=2, max_seq=32)


def test_cli_quantizes_a_preset_like_jax(tmp_path, capsys):
    argv = ["--model", "tiny-longcat", "--recipe", "rtn", "--iters", "0",
            "--nsamples", "4", "--seqlen", "16", "--format", "autoround",
            "--group-size", "32", "--device", "cpu", "--dataset",
            str(tmp_path / "ids.npy")]
    np.save(tmp_path / "ids.npy", IDS[:4])
    assert jcli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + ["--output", str(tmp_path / "t")]) == 0
    trep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trep["layers"] == jrep["layers"] == 2 * (2 * 8 + 3 * 4)
    f = "quantization_config.json"
    assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f
                                                 ).read_bytes()
