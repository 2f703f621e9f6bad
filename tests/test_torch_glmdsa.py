"""Port parity for GLM-5 DSA (``models/glmdsa.py``): the lightning
indexer's scores, the DSA mask (random scores, a tie at the k-th score,
``index_topk >= S``, more keys than queries), the block with its own
indexer and with a threaded mask, the model with ``index_layers=(0,)``
sharing, RTN and SignRound (the indexer's q / k quantized, ``weights_proj``
left full precision), export, a ``glm_moe_dsa`` directory written here and
read by both loaders, the HF writer's refusal and the CLI, each against the
JAX package on the same numpy inputs, on ``tiny-glmdsa`` (every layer its
own indexer) and ``tiny-glmdsa`` with ``index_layers=(0,)``.  Serving is
``tests/test_torch_glmdsa_serve.py``.

Every norm gain is moved off its initial value by N(0, 0.1) and the
routers' ``e_score_correction_bias`` drawn from N(0, 0.5).

Tolerances (fp32 throughout, CPU):
  * indexer scores: 1e-5 (fp32 einsums summed in other orders);
  * masks: equal (a score within rounding of the k-th value would flip a
    key: the random cases have none, the tie case ties exactly);
  * blocks and model logits: 1e-5;
  * RTN: at least 99.8% of each layer's codes equal, scales rtol 5e-7;
  * SignRound (4 iterations a block): first loss rtol 1e-3, best loss and
    trace rtol 5e-6;
  * export, the CLI's export: bytes equal; HF load: leaves equal.
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
from autoround_tpu.models import glmdsa as jdsa
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import deepseek as td
from autoround_tpu_torch.models import glmdsa as tdsa
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import save_file
from test_torch_deepseek import _layers_close, _leaves_equal
from _port_threads import one_torch_thread  # noqa: F401

SCORE_TOL = 1e-5
LOGIT_TOL = 1e-5
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6

BASE = jdsa.CONFIG_PRESETS["tiny-glmdsa"]
JPRESETS = {"tiny-glmdsa": BASE,
            "tiny-glmdsa-shared": dataclasses.replace(BASE,
                                                      index_layers=(0,))}
NAMES = sorted(JPRESETS)
# 16 tokens against index_topk 8: the mask bites from the ninth query on
IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg), type(jcfg).__name__)


@functools.lru_cache(maxsize=None)
def make_pair(name, seed=0):
    """(jcfg, JAX params, port cfg, port params), gains and router biases
    moved; a shared layer's indexer stays the same arrays as its governing
    layer's on both sides."""
    jcfg = JPRESETS[name]
    tree = jax.tree.map(np.asarray,
                        jdsa.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        for k, v in b.items():
            if k == "e_score_correction_bias":
                b[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif "norm" in k:
                b[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    tcfg = port_config(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def pairs():
    return {n: make_pair(n) for n in NAMES}


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    cfg = ALL_PRESETS["tiny-glmdsa"]
    assert type(cfg) is tdsa.GlmMoeDsaConfig
    assert [f.name for f in dataclasses.fields(cfg)] == [
        f.name for f in dataclasses.fields(BASE)]
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(BASE, f.name), f.name
    fns = get_model_fns(cfg)
    assert fns.block_fwd is tdsa.block_fwd
    assert fns.rope_tables is td.rope_tables
    names = fns.block_linear_names(cfg)
    assert names == jdsa.block_linear_names(BASE)
    assert "indexer.q_proj" in names and "indexer.weights_proj" not in names
    assert td.is_mla(cfg)
    for name, jcfg in JPRESETS.items():
        tcfg = port_config(jcfg)
        jp = jdsa.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tdsa.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        meta = lambda t: (tuple(t.shape), str(t.dtype))
        assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
            jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp))
        if jcfg.index_layers:            # a shared layer holds a copy
            for li in (1, 2):
                for n, w in tp["blocks"][0]["indexer"].items():
                    assert tp["blocks"][li]["indexer"][n] is w
        ids = torch.zeros((1, 4), dtype=torch.long)
        assert torch.isfinite(tdsa.model_fwd(tp, ids, tcfg)).all()
    # an export's model_config has no class name: index_topk names it
    fields = {k: v for k, v in dataclasses.asdict(JPRESETS[
        "tiny-glmdsa-shared"]).items() if k != "dtype"}
    back = config_from_jax(json.loads(json.dumps(fields)))
    assert type(back) is tdsa.GlmMoeDsaConfig and back.index_layers == (0,)


# ---------------------------------------------------------------- indexer

@pytest.mark.parametrize("head_dim", [16, 4])     # with rope, below dr
def test_indexer_scores_match_jax(head_dim):
    jcfg = dataclasses.replace(BASE, index_head_dim=head_dim, num_layers=1,
                               n_routed_experts=0)
    tcfg = port_config(jcfg)
    tree = jax.tree.map(np.asarray,
                        jdsa.init_params(jcfg, jax.random.PRNGKey(3)))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg,
                                                              "cpu")
    h = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(
        np.float32)
    jc, js = jd.rope_tables(jcfg, 12)
    tc, ts = td.rope_tables(tcfg, 12, device="cpu")
    want = jdsa.indexer_scores(jp["blocks"][0], jnp.asarray(h), jc, js,
                               jcfg, jd.llama._plain_linear)
    got = tdsa.indexer_scores(tp["blocks"][0], torch.from_numpy(h), tc, ts,
                              tcfg, tl._plain_linear)
    assert got.shape == (2, 12, 12) and got.dtype == torch.float32
    _close(want, got, SCORE_TOL)


def _tie_scores():
    """Integer scores 0..2: every row ties at its k-th value."""
    return np.random.default_rng(6).integers(0, 3, (2, 12, 12)).astype(
        np.float32)


MASKS = {"random": (lambda: np.random.default_rng(5).standard_normal(
                        (2, 12, 12)).astype(np.float32), 4),
         "tie": (_tie_scores, 4),
         "topk_at_least_S": (lambda: np.random.default_rng(7)
                             .standard_normal((1, 12, 12))
                             .astype(np.float32), 12),
         "more_keys": (lambda: np.random.default_rng(8).standard_normal(
                          (2, 5, 12)).astype(np.float32), 3)}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_dsa_mask_matches_jax(case):
    make, k = MASKS[case]
    sc = make()
    want = np.asarray(jdsa.dsa_mask(jnp.asarray(sc), k))
    got = tdsa.dsa_mask(torch.from_numpy(sc), k)
    assert got.shape == (sc.shape[0], 1) + sc.shape[1:]
    np.testing.assert_array_equal(got.numpy(), want)
    kept = (got.numpy()[:, 0] == 0.0).sum(-1)          # (B, S)
    S, T = sc.shape[1:]
    causal = np.arange(S) + (T - S) + 1
    if case == "topk_at_least_S":                     # every causal key
        np.testing.assert_array_equal(kept, np.broadcast_to(causal,
                                                            kept.shape))
    elif case == "tie":                  # a tie at the k-th keeps them all
        assert (kept > k + 1).any()
    else:
        assert (kept <= k + 1).all() and (kept[:, -1] >= k).all()


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("name", NAMES)
def test_block_and_model_fwd_match_jax(name, pairs):
    jcfg, jp, tcfg, tp = pairs[name]
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 16))
    x = jd.llama.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jd.rope_tables(jcfg, 16)
    tc, ts = td.rope_tables(tcfg, 16, device="cpu")
    tx = torch.from_numpy(np.array(x))
    for bi in (0, 1):                       # the dense block, a MoE one
        _close(jdsa.block_fwd(jp["blocks"][bi], x, jc, js, jcfg),
               tdsa.block_fwd(tp["blocks"][bi], tx, tc, ts, tcfg), LOGIT_TOL)
    # a threaded mask (block 0's) in block 1
    h = jd.llama.rms_norm(x, jp["blocks"][0]["input_layernorm"], jcfg.rms_eps)
    jm = jdsa.dsa_mask(jdsa.indexer_scores(jp["blocks"][0], h, jc, js, jcfg,
                                           jd.llama._plain_linear),
                       jcfg.index_topk)
    tm = torch.from_numpy(np.array(jm))
    _close(jdsa.block_fwd(jp["blocks"][1], x, jc, js, jcfg, idx_mask=jm),
           tdsa.block_fwd(tp["blocks"][1], tx, tc, ts, tcfg, idx_mask=tm),
           LOGIT_TOL)
    _close(jdsa.model_fwd(jp, jnp.asarray(ids), jcfg),
           tdsa.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)
    # index_topk >= S: the dense MLA block, exactly as the JAX test holds it
    dense = dataclasses.replace(tcfg, index_topk=64)
    torch.testing.assert_close(
        tdsa.block_fwd(tp["blocks"][1], tx, tc, ts, dense),
        td.block_fwd(tp["blocks"][1], tx, tc, ts, dense), rtol=1e-5,
        atol=1e-5)


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
    for bi in range(3):               # every block quantizes its copy
        assert f"blocks.{bi}.indexer.q_proj" in tres.layers
        assert f"blocks.{bi}.indexer.k_proj" in tres.layers
        assert f"blocks.{bi}.indexer.weights_proj" not in tres.layers
    blk = tres.params["blocks"][1]["indexer"]
    assert blk["weights_proj"] is pairs[name][3]["blocks"][1]["indexer"][
        "weights_proj"]
    assert set(ar.layer_schemes) == set(tres.layers)


def test_signround_traces_like_jax(pairs):
    jres, tres, _ = _both(pairs["tiny-glmdsa"], scheme="W4A16G32", iters=4,
                          batch_size=4, seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1, 2]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
def test_export_bytes_equal_the_jax_package(fmt, pairs, rtn, tmp_path):
    name = "tiny-glmdsa-shared"
    jres, _, ar = rtn[name]
    jd_ = j_save(jres, pairs[name][0], str(tmp_path / "j"), fmt)
    td_ = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd_, f), os.path.join(td_, f),
                           shallow=False), f
    if fmt == "fake":
        params, qcfg = load_fake(td_)
        cfg = config_from_jax(qcfg["model_config"])
        assert cfg == dataclasses.replace(pairs[name][2],
                                          dtype=torch.bfloat16)
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(
            tdsa.model_fwd(params, ids, cfg),
            tdsa.model_fwd(ar.result.params, ids, cfg), rtol=0, atol=0)


# --------------------------------------------------------------------- HF

def write_hf(tree, cfg, path):
    """A ``glm_moe_dsa`` directory from a numpy tree (fp32 tensors): the
    DeepSeek keys, and ``self_attn.indexer.*`` for the layers that own an
    indexer only, as a published checkpoint stores them."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    inv = {v: k for k, v in th._DS_MAP.items()}
    t = {"model.embed_tokens.weight": f32(tree["embed_tokens"]),
         "model.norm.weight": f32(tree["norm"]),
         "lm_head.weight": f32(tree["lm_head"])}
    for li, b in enumerate(tree["blocks"]):
        p = f"model.layers.{li}."
        for ours, arr in b.items():
            if ours == "indexer":
                if cfg.layer_has_indexer(li):
                    for n, w in arr.items():
                        t[f"{p}self_attn.indexer.{n}.weight"] = f32(w)
            elif ours == "experts":
                for e, ew in enumerate(arr):
                    for n, w in ew.items():
                        t[f"{p}mlp.experts.{e}.{n}.weight"] = f32(w)
            elif ours == "shared_experts":
                for n, w in arr.items():
                    t[f"{p}mlp.shared_experts.{n}.weight"] = f32(w)
            else:
                t[p + inv[ours]] = f32(arr)
    os.makedirs(path, exist_ok=True)
    save_file(t, os.path.join(path, "model.safetensors"))
    hf = {"model_type": "glm_moe_dsa", "vocab_size": cfg.vocab_size,
          "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "q_lora_rank": cfg.q_lora_rank, "kv_lora_rank": cfg.kv_lora_rank,
          "qk_nope_head_dim": cfg.qk_nope_head_dim,
          "qk_rope_head_dim": cfg.qk_rope_head_dim,
          "v_head_dim": cfg.v_head_dim,
          "n_routed_experts": cfg.n_routed_experts,
          "num_experts_per_tok": cfg.num_experts_per_tok,
          "moe_intermediate_size": cfg.moe_intermediate_size,
          "n_shared_experts": cfg.n_shared_experts,
          "first_k_dense_replace": cfg.first_k_dense,
          "routed_scaling_factor": cfg.routed_scaling_factor,
          "n_group": cfg.n_group, "topk_group": cfg.topk_group,
          "norm_topk_prob": cfg.norm_topk_prob,
          "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
          "index_n_heads": cfg.index_n_heads,
          "index_head_dim": cfg.index_head_dim,
          "index_topk": cfg.index_topk,
          "index_layers": list(cfg.index_layers) or None}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return path


@pytest.mark.parametrize("name", NAMES)
def test_hf_directory_read_by_both_loaders(name, pairs, tmp_path):
    jcfg, jp, tcfg, tp = pairs[name]
    write_hf(jax.tree.map(np.asarray, jp), jcfg, str(tmp_path))
    tp2, tcfg2 = th.load_hf_checkpoint(str(tmp_path), torch.float32,
                                       device="cpu")
    jp2, jcfg2 = jh.load_hf_checkpoint(str(tmp_path), jnp.float32)
    assert type(tcfg2).__name__ == type(jcfg2).__name__ == "GlmMoeDsaConfig"
    for f in dataclasses.fields(tcfg2):
        if f.name != "dtype":
            assert getattr(tcfg2, f.name) == getattr(jcfg2, f.name), f.name
    assert tcfg2.index_layers == jcfg.index_layers
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp2), jp2)
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp), jp2)
    # the governing indexer's copy in the shared layers
    for n in ("q_proj", "k_proj", "weights_proj"):
        assert torch.equal(tp2["blocks"][2]["indexer"][n],
                           tp2["blocks"][0 if jcfg.index_layers else 2][
                               "indexer"][n])
    with pytest.raises(NotImplementedError, match="GlmMoeDsaConfig"):
        th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "w"))
    # the HF defaults are DeepSeek-V3.2's indexer (64 x 128, top 2048)
    hf = json.loads((tmp_path / "config.json").read_text())
    for k in ("index_n_heads", "index_head_dim", "index_topk"):
        hf.pop(k)
    d = th.config_from_hf(hf)
    assert (d.index_n_heads, d.index_head_dim, d.index_topk) == (64, 128,
                                                                 2048)


def test_cli_on_a_glm_moe_dsa_directory(pairs, tmp_path, capsys,
                                        monkeypatch):
    """A ``glm_moe_dsa`` directory through both CLIs: the exports are
    byte-equal."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    jcfg, jp = pairs["tiny-glmdsa-shared"][:2]
    write_hf(jax.tree.map(np.asarray, jp), jcfg, str(tmp_path / "m"))
    np.save(tmp_path / "ids.npy", IDS)
    argv = ["--model", str(tmp_path / "m"), "--recipe", "rtn", "--iters",
            "0", "--dataset", str(tmp_path / "ids.npy"), "--nsamples", "8",
            "--seqlen", "16", "--format", "autoround", "--group-size", "32",
            "--device", "cpu", "--quant-lm-head"]
    assert jcli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + ["--output", str(tmp_path / "t")]) == 0
    trep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trep["layers"] == jrep["layers"] == (
        3 * 2 + (5 + 3) + 2 * (5 + 3 * 8 + 3) + 1)
    for f in ("model.safetensors", "quantization_config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
