"""Port parity for GLM-4.5 / GLM-4.5-Air (``models/glm4moe.py``'s
``Glm4MoeConfig``): GQA attention with q/k/v biases, per-head q/k norm and
partial rotary (0.5), the DeepSeek-V3 router and MoE over a dense block 0,
RTN, SignRound and ``nblocks``, export, the HF files of ``glm4_moe`` both
ways, the draft layer's refusal and the CLI, each against the JAX package
on the same numpy inputs, on ``tiny-glm4moe`` and its G = 12 variant (12
query heads over 1 KV head of 16, made with ``dataclasses.replace`` on
both sides: GLM-4.5-Air's grouping at a tiny width).  Serving is
``tests/test_torch_glm4moe_serve.py``.

Every norm gain and q/k/v bias is moved off its initial value by N(0, 0.1)
and the routers' ``e_score_correction_bias`` drawn from N(0, 0.5), so each
counts.

Tolerances (fp32 throughout, CPU):
  * blocks and model logits: 1e-5 (fp32 sums in other orders; measured
    2e-7);
  * RTN: at least 99.8% of each layer's codes equal, scales rtol 5e-7;
  * SignRound (4 iterations a block): first loss rtol 1e-3, best loss and
    trace rtol 5e-6;
  * export, HF files, the CLI's export: bytes equal; HF load: leaves
    equal.
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
from autoround_tpu.models import glm4moe as jg
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import deepseek as td
from autoround_tpu_torch.models import glm4moe as tg
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import load_file, save_file
from test_torch_deepseek import _layers_close, _leaves_equal
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-5
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6

BASE = jg.CONFIG_PRESETS["tiny-glm4moe"]
# GLM-4.5-Air's G = 12 at a tiny width
JPRESETS = {"tiny-glm4moe": BASE,
            "tiny-glm4moe-g12": dataclasses.replace(BASE, num_heads=12,
                                                    num_kv_heads=1)}
NAMES = sorted(JPRESETS)
IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg), type(jcfg).__name__)


def moved_tree(tree, seed):
    """The numpy tree with the norm gains and biases moved by N(0, 0.1) and
    the router biases drawn from N(0, 0.5)."""
    rng = np.random.default_rng(seed + 100)
    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        for k, v in b.items():
            if k == "e_score_correction_bias":
                b[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif "norm" in k or k.endswith("_bias"):
                b[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def make_pair(name, seed=0):
    """(jcfg, JAX params, port cfg, port params), gains, biases and router
    biases moved; made once per process (no test writes into them)."""
    jcfg = JPRESETS[name]
    tree = moved_tree(jax.tree.map(
        np.asarray, jg.init_params(jcfg, jax.random.PRNGKey(seed))), seed)
    tcfg = port_config(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def pairs():
    return {n: make_pair(n) for n in NAMES}


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    for name in ("tiny-glm4moe", "glm-4.5-air"):
        cfg, jcfg = ALL_PRESETS[name], jg.CONFIG_PRESETS[name]
        assert type(cfg) is tg.Glm4MoeConfig
        # the JAX order (the export's model_config follows it), less the
        # QuaRot fields the port does not have
        assert [f.name for f in dataclasses.fields(cfg)] == [
            f.name for f in dataclasses.fields(jcfg)]
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        fns = get_model_fns(cfg)
        assert fns.block_fwd is tg.block_fwd
        assert fns.rope_tables is tl.rope_tables      # partial rotary
        assert fns.block_linear_names(cfg) == jg.block_linear_names(jcfg)
        assert not td.is_mla(cfg)
    air = ALL_PRESETS["glm-4.5-air"]
    assert air.num_heads // air.num_kv_heads == 12
    cfg = ALL_PRESETS["tiny-glm4moe"]
    jp = jg.init_params(BASE, jax.random.PRNGKey(0))
    tp = tg.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = lambda t: (tuple(t.shape), str(t.dtype))
    assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
        jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp))
    logits = tg.model_fwd(tp, torch.zeros((1, 4), dtype=torch.long), cfg)
    assert logits.shape == (1, 4, 256) and torch.isfinite(logits).all()


def test_config_from_jax_classes():
    fields = dataclasses.asdict(BASE)
    assert type(config_from_jax(fields, "Glm4MoeConfig")) is \
        tg.Glm4MoeConfig
    # an export's model_config has no class name: kv_lora_rank = 0 names it
    cfg = config_from_jax({k: v for k, v in fields.items() if k != "dtype"})
    assert type(cfg) is tg.Glm4MoeConfig and cfg.partial_rotary_factor == 0.5


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("name", NAMES)
def test_block_and_model_fwd_match_jax(name, pairs):
    jcfg, jp, tcfg, tp = pairs[name]
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 10))
    x = jg.llama.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jg.llama.rope_tables(jcfg, 10)
    tc, ts = tl.rope_tables(tcfg, 10, device="cpu")
    assert tc.shape == (10, tcfg.hd // 2)         # rd = 0.5 hd
    _close(jc, tc, 1e-6)
    tx = torch.from_numpy(np.array(x))
    for bi in (0, 1):                          # the dense block, a MoE one
        _close(jg.block_fwd(jp["blocks"][bi], x, jc, js, jcfg),
               tg.block_fwd(tp["blocks"][bi], tx, tc, ts, tcfg), LOGIT_TOL)
    _close(jg.model_fwd(jp, jnp.asarray(ids), jcfg),
           tg.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


# ------------------------------------------------------ quantize and export

def _both(pair, **kw):
    jcfg, jp, tcfg, tp = pair
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(IDS))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(IDS), ar


@pytest.fixture(scope="module")
def rtn(pairs):
    return {n: _both(pairs[n], scheme="W4A16G32", iters=0,
                     quant_lm_head=True) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_rtn_like_jax(name, pairs, rtn):
    jres, tres, ar = rtn[name]
    _layers_close(jres, tres)
    E = pairs[name][0].n_routed_experts
    # the dense block 0 quantizes its MLP, the MoE blocks their experts
    assert len(tres.layers) == 7 + 2 * (4 + 3 * E + 3) + 1
    assert "blocks.0.gate_proj" in tres.layers
    assert not any(k.startswith("blocks.0.experts") for k in tres.layers)
    assert "blocks.2.shared_experts.down_proj" in tres.layers
    assert set(ar.layer_schemes) == set(tres.layers)
    blk = tres.params["blocks"][1]
    # the router, its fp32 bias, the q/k/v biases and the norms stay dense
    assert blk["gate"] is pairs[name][3]["blocks"][1]["gate"]
    assert blk["e_score_correction_bias"].dtype == torch.float32
    assert blk["q_bias"] is pairs[name][3]["blocks"][1]["q_bias"]


def test_signround_traces_like_jax(pairs):
    """G = 12 through the tuning loss (the MoE blocks' routed experts and
    the dense block 0)."""
    jres, tres, _ = _both(pairs["tiny-glm4moe-g12"], scheme="W4A16G32",
                          iters=4, batch_size=4, seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1, 2]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


def test_nblocks_pair_dense_and_moe_like_jax(pairs):
    """nblocks = 2 over (dense block 0, MoE block 1), then block 2 alone."""
    jres, tres, _ = _both(pairs["tiny-glm4moe"], scheme="W4A16G32", iters=4,
                          batch_size=4, seed=0, nblocks=2)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 2]
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], jt,
                                   rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
@pytest.mark.parametrize("name", NAMES)
def test_export_bytes_equal_the_jax_package(name, fmt, pairs, rtn, tmp_path):
    jres, _, ar = rtn[name]
    jd_ = j_save(jres, pairs[name][0], str(tmp_path / "j"), fmt)
    td_ = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd_, f), os.path.join(td_, f),
                           shallow=False), f
    if fmt == "fake":
        params, qcfg = load_fake(td_)
        cfg = config_from_jax(qcfg["model_config"])
        assert type(cfg) is tg.Glm4MoeConfig
        assert cfg == dataclasses.replace(pairs[name][2],
                                          dtype=torch.bfloat16)
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(
            tg.model_fwd(params, ids, cfg),
            tg.model_fwd(ar.result.params, ids, cfg), rtol=0, atol=0)


# --------------------------------------------------------------------- HF

@pytest.mark.parametrize("name", NAMES)
def test_hf_round_trips_both_ways(name, pairs, tmp_path):
    jcfg, jp, tcfg, tp = pairs[name]
    jh.save_hf_checkpoint(jp, jcfg, str(tmp_path / "j"))
    th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "t"))
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    hf = json.loads((tmp_path / "t" / "config.json").read_text())
    assert hf["model_type"] == "glm4_moe" and "kv_lora_rank" not in hf
    tp2, tcfg2 = th.load_hf_checkpoint(str(tmp_path / "j"), torch.float32,
                                       device="cpu")
    jp2, jcfg2 = jh.load_hf_checkpoint(str(tmp_path / "t"), jnp.float32)
    assert type(tcfg2).__name__ == type(jcfg2).__name__ == "Glm4MoeConfig"
    for f in dataclasses.fields(tcfg2):
        if f.name != "dtype":
            assert getattr(tcfg2, f.name) == getattr(jcfg2, f.name), f.name
    assert tcfg2 == dataclasses.replace(tcfg, dtype=torch.float32)
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp2), jp2)
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp), jp2)
    assert tp2["blocks"][1]["e_score_correction_bias"].dtype == torch.float32


def test_a_draft_layer_raises_by_name(pairs, tmp_path):
    """A published GLM-4.5 / DeepSeek-V3 checkpoint holds its draft layer
    (``num_nextn_predict_layers``) as ``model.layers.<num_hidden_layers>``:
    the JAX loader stops with an IndexError, the port names the key."""
    jcfg, jp, tcfg, tp = pairs["tiny-glm4moe"]
    th.save_hf_checkpoint(tp, tcfg, str(tmp_path),
                          hf_extra={"num_nextn_predict_layers": 1})
    flat = load_file(str(tmp_path / "model.safetensors"))
    key = f"model.layers.{tcfg.num_layers}.eh_proj.weight"
    flat[key] = torch.zeros(4, 8)
    save_file(flat, str(tmp_path / "model.safetensors"))
    with pytest.raises(IndexError):
        jh.load_hf_checkpoint(str(tmp_path), jnp.float32)
    with pytest.raises(ValueError, match=rf"{key}.*num_nextn_predict_layers"
                                         rf" = 1"):
        th.load_hf_checkpoint(str(tmp_path), torch.float32, device="cpu")


def test_cli_on_a_glm4_moe_directory(pairs, tmp_path, capsys, monkeypatch):
    """An HF ``glm4_moe`` directory through both CLIs: the exports are
    byte-equal."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    jcfg, jp, _, _ = pairs["tiny-glm4moe-g12"]
    jh.save_hf_checkpoint(jp, jcfg, str(tmp_path / "m"))
    np.save(tmp_path / "ids.npy", IDS)
    argv = ["--model", str(tmp_path / "m"), "--recipe", "rtn", "--iters",
            "0", "--dataset", str(tmp_path / "ids.npy"), "--nsamples", "8",
            "--seqlen", "16", "--format", "autoround", "--group-size", "32",
            "--device", "cpu", "--quant-lm-head"]
    assert jcli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + ["--output", str(tmp_path / "t")]) == 0
    trep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trep["layers"] == jrep["layers"] == 7 + 2 * (4 + 3 * 8 + 3) + 1
    for f in ("model.safetensors", "quantization_config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
