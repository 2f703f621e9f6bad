"""Port parity for Llama 4 (``models/llama4.py``): the interleave and the
L2 q/k norm, the NoPE temperature, the chunked mask, the input-scaled
router (a tie selects more than k), the routed MLP on its three routes and
capacity dispatch with ``scale_input``, the rope and NoPE blocks and the
model past the chunk, RTN, SignRound and ``nblocks`` over dense and MoE,
rope and NoPE blocks, export, the HF reader (fused experts in halves) and
the CLI, then serving: the engine (int8 / fp32 / fp8 KV past the chunk),
``generate_scan``, the batcher, capacity dispatch and ``from_pretrained``,
each against the JAX package on the same numpy inputs.

The config is ``tiny-llama4`` (MoE blocks 0 and 2, dense blocks 1 and 3,
block 3 NoPE, an 8-token chunk) with ``floor_scale = 4`` and
``temp_attn_scale = 0.5``, so the NoPE temperature moves from position 3
on (at the published 8192 it is 1 below position 8191); every norm gain
is moved off 1 by N(0, 0.1).

Tolerances (fp32 throughout, CPU; those of ``tests/test_torch_deepseek.py``):
  * router: selections equal, scores 1e-6;
  * routed MLP on each route, capacity dispatch: 1e-5;
  * block, model and engine logits: 1e-4 (the port packs every projection
    at g = 32, the JAX engine serves the same qdq weights dense);
  * RTN: at least 99.8% of each layer's codes equal, scales rtol 5e-7;
  * SignRound (4 iterations a block): first loss rtol 1e-3, best loss and
    trace rtol 5e-6;
  * export, the CLI's export: bytes equal; HF load: leaves equal;
  * KV codes: at least 99.9% equal, the rest one step apart; tokens equal;
  * ``from_pretrained`` against the in-memory engine: 1e-2 (fp16 scales
    in the files).
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
from autoround_tpu import envs as jenvs
from autoround_tpu.export import save_quantized as j_save
from autoround_tpu.models import llama as jl
from autoround_tpu.models import llama4 as j4
from autoround_tpu.models import mixtral as jm
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import ContinuousBatchingEngine as JCB
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models import llama4 as t4
from autoround_tpu_torch.models import mixtral as tm
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from autoround_tpu_torch.serve.engine import _make_linear_fn
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import save_file
from test_torch_deepseek import _layers_close, _leaves_equal, _lfs
from test_torch_deepseek_serve import _codes_close
from _port_threads import one_torch_thread  # noqa: F401

ROUTE_TOL = 1e-6
MLP_TOL = 1e-5
LOGIT_TOL = 1e-4
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6
FP16_SCALE_TOL = 1e-2
MAX_SEQ = 32

JCFG = dataclasses.replace(j4.CONFIG_PRESETS["tiny-llama4"], floor_scale=4.0,
                           temp_attn_scale=0.5)
IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def make_pair(seed=0):
    """(jcfg, JAX params, port cfg, port params): JAX ``init_params`` with
    every norm gain moved by N(0, 0.1), carried to the port."""
    tree = jax.tree.map(np.asarray, j4.init_params(JCFG,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        for k, v in b.items():
            if "norm" in k:
                b[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    tcfg = port_config(JCFG)
    return JCFG, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(
        tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair()


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    for name, jcfg in j4.CONFIG_PRESETS.items():
        cfg = ALL_PRESETS[name]
        assert type(cfg) is t4.Llama4Config
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        fns = get_model_fns(cfg)
        assert fns.block_fwd is t4.block_fwd
        assert fns.rope_tables is tl.rope_tables
        assert fns.block_linear_names(cfg) == j4.block_linear_names(jcfg)
        # at most two stable callables: one per layer kind
        kinds = {t4.layer_uses_rope(cfg, i): fns.block_fwd_for(cfg, i)
                 for i in range(cfg.num_layers)}
        assert len(set(map(id, kinds.values()))) == len(kinds) == 2
        assert all(fns.block_fwd_for(cfg, i) is kinds[
            j4.layer_uses_rope(jcfg, i)] for i in range(cfg.num_layers))
    jp = j4.init_params(JCFG, jax.random.PRNGKey(0))
    tp = t4.init_params(port_config(JCFG), torch.Generator().manual_seed(0),
                        "cpu")
    meta = lambda t: (tuple(t.shape), str(t.dtype))
    assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
        jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp))
    assert "experts" not in tp["blocks"][1] and "router" in tp["blocks"][0]


def test_config_from_jax_and_the_chunked_mask():
    assert type(port_config(JCFG)) is t4.Llama4Config
    assert port_config(JCFG).moe_layers == (0, 2)
    # a Llama config may chunk its sliding layers too
    jcfg = dataclasses.replace(jl.CONFIG_PRESETS["tiny"], sliding_window=4,
                               chunked_attention=True)
    tcfg = port_config(jcfg)
    assert type(tcfg) is tl.LlamaConfig and tcfg.chunked_attention
    for cfg_j, cfg_t in ((jcfg, tcfg), (JCFG, port_config(JCFG))):
        for S in (8, 13):
            _close(jl.sliding_mask(cfg_j, S), tl.sliding_mask(cfg_t, S), 0)


def test_interleave_l2_norm_and_temperature_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    _close(j4._interleave(jnp.asarray(x)), t4._interleave(
        torch.from_numpy(x)), 0)
    _close(j4._l2_norm(jnp.asarray(x), 1e-5),
           t4._l2_norm(torch.from_numpy(x), 1e-5), MLP_TOL)
    pos = np.array([0, 2, 3, 7, 8190, 8191, 70000], np.int32)
    for cfg in (JCFG, j4.CONFIG_PRESETS["llama4-scout-16e"]):
        want = (jnp.log1p(jnp.floor((jnp.asarray(pos, jnp.float32) + 1.0)
                                    / cfg.floor_scale))
                * cfg.temp_attn_scale + 1.0)
        got = t4.nope_temperature(port_config(cfg), torch.from_numpy(pos))
        _close(want, got, 0)
    assert got[4] == 1.0 and got[5] > 1.0      # Scout: from position 8191


# ---------------------------------------------------------------- routing


def _tie_router(jblk, tblk, h):
    """Router weights giving logits (x, x, x, x / 2), x = h[..., 0] > 1
    (``h`` is moved in place): a tie at the k = 2 threshold."""
    h[..., 0] = np.abs(h[..., 0]) + 1.0
    r = np.zeros(np.shape(jblk["router"]), np.float32)
    r[:3, 0], r[3, 0] = 1.0, 0.5
    jblk["router"], tblk["router"] = jnp.asarray(r), torch.from_numpy(r)


@pytest.mark.parametrize("router", ["random", "tied"])
def test_route_matches_jax(router, pair):
    """The selection ``logits >= `` the k-th largest (JAX
    ``models/llama4.py:176-181``): equal selections and top-k ids, scores
    1e-6; a tie selects all three tied experts."""
    jcfg, jp, tcfg, tp = pair
    jblk, tblk = dict(jp["blocks"][0]), dict(tp["blocks"][0])
    h = np.random.default_rng(4).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    if router == "tied":
        _tie_router(jblk, tblk, h)
    logits = jnp.einsum("...h,eh->...e", jnp.asarray(h), jblk["router"])
    jv, ji = jax.lax.top_k(logits, jcfg.top_k)
    want = jnp.where(logits >= jv[..., -1:], jax.nn.sigmoid(logits), 0.0)
    ti, tv, scores = t4._route(tblk, torch.from_numpy(h), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal((scores > 0).numpy(),
                                  np.asarray(want > 0))
    _close(want, scores, ROUTE_TOL)
    n_sel = (scores > 0).sum(-1)
    assert (n_sel == 3).all() if router == "tied" else (n_sel == 2).all()


@pytest.mark.parametrize("router", ["random", "tied"])
def test_moe_mlp_three_forms_match_jax(router, pair):
    """Each route against JAX's, and the dense routes against each other.
    ``tied``: three router rows equal and largest, so the k = 2 threshold
    selects three experts (capacity dispatch takes the top-k slots only,
    as in the JAX package, so it is held to JAX's alone there)."""
    jcfg, jp, tcfg, tp = pair
    jblk, tblk = dict(jp["blocks"][0]), dict(tp["blocks"][0])
    h = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    if router == "tied":
        _tie_router(jblk, tblk, h)
    full = jcfg.num_experts / jcfg.top_k
    outs = {}
    for grouped in (False, True):
        jlf, tlf = _lfs(jblk, tblk, grouped)
        for factor in (0.0, full):
            want = j4._moe_mlp(jblk, jnp.asarray(h), jcfg, jlf,
                               capacity_factor=factor)
            got = t4._moe_mlp(tblk, torch.from_numpy(h), tcfg, tlf,
                              capacity_factor=factor)
            assert got.shape == h.shape and got.dtype == torch.float32
            _close(want, got, MLP_TOL)
            outs[grouped, factor] = got
    torch.testing.assert_close(outs[True, 0.0], outs[False, 0.0],
                               rtol=MLP_TOL, atol=MLP_TOL)
    same = torch.allclose(outs[False, full], outs[False, 0.0], rtol=MLP_TOL,
                          atol=MLP_TOL)
    assert same == (router == "random")


@pytest.mark.parametrize("factor", [0.5, 2.0])
@pytest.mark.parametrize("grouped", [False, True])
def test_capacity_dispatch_scale_input_like_jax(factor, grouped):
    """``capacity_dispatch(scale_input=True)`` against the JAX package's,
    with slots dropped (factor 0.5) and none (2.0)."""
    rng = np.random.default_rng(6)
    B, S, H, E, k = 2, 7, 8, 4, 2
    h = rng.standard_normal((B, S, H)).astype(np.float32)
    topi = np.argsort(-rng.standard_normal((B, S, E)), axis=-1)[..., :k]
    topv = rng.uniform(0.1, 1.0, (B, S, k)).astype(np.float32)
    w = rng.standard_normal((E, H, H)).astype(np.float32)
    tw = torch.from_numpy(w)
    want = jm.capacity_dispatch(
        jnp.asarray(h), jnp.asarray(topi), jnp.asarray(topv), E, factor,
        lambda e, xb: jnp.tanh(xb @ w[e].T),
        grouped_apply=(lambda buf: jnp.tanh(
            jnp.einsum("eck,eok->eco", buf, w))) if grouped else None,
        scale_input=True)
    got = tm.capacity_dispatch(
        torch.from_numpy(h), torch.from_numpy(topi).long(),
        torch.from_numpy(topv), E, factor,
        lambda e, xb: torch.tanh(xb @ tw[e].T),
        grouped_apply=(lambda buf: torch.tanh(
            torch.einsum("eck,eok->eco", buf, tw))) if grouped else None,
        scale_input=True)
    assert got.shape == (B, S, H) and got.dtype == torch.float32
    _close(want, got, MLP_TOL)


def test_blocks_and_model_fwd_match_jax(pair):
    """Past the chunk (S = 12 > 8): each block as its own variant, the
    rope blocks with the chunked mask, and the model."""
    jcfg, jp, tcfg, tp = pair
    ids = np.random.default_rng(7).integers(0, 256, (2, 12))
    x = jl.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jl.rope_tables(jcfg, 12)
    tc, ts = tl.rope_tables(tcfg, 12, device="cpu")
    tx = torch.from_numpy(np.array(x))
    jmask, tmask = jl.sliding_mask(jcfg, 12), tl.sliding_mask(tcfg, 12)
    for bi in range(jcfg.num_layers):
        sl = jl.layer_is_sliding(jcfg, bi)
        _close(j4.block_fwd_for(jcfg, bi)(jp["blocks"][bi], x, jc, js, jcfg,
                                          mask=jmask if sl else None),
               t4.block_fwd_for(tcfg, bi)(tp["blocks"][bi], tx, tc, ts, tcfg,
                                          mask=tmask if sl else None),
               LOGIT_TOL)
    _close(j4.model_fwd(jp, jnp.asarray(ids), jcfg),
           t4.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


# ------------------------------------------------------ quantize and export

def _both(pair, **kw):
    jcfg, jp, tcfg, tp = pair
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(IDS))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(IDS), ar


@pytest.fixture(scope="module")
def rtn(pair):
    return _both(pair, scheme="W4A16G32", iters=0, quant_lm_head=True)




def test_rtn_dense_and_moe_blocks_like_jax(pair, rtn):
    jres, tres, ar = rtn
    _layers_close(jres, tres)
    E = JCFG.num_experts
    # MoE blocks 0, 2: attention, experts, shared expert; dense 1, 3
    assert len(tres.layers) == 2 * (4 + 3 * E + 3) + 2 * (4 + 3) + 1
    assert "blocks.1.gate_proj" in tres.layers
    assert not any(k.startswith("blocks.1.experts") for k in tres.layers)
    assert "blocks.2.shared_expert.down_proj" in tres.layers
    assert set(ar.layer_schemes) == set(tres.layers)
    assert tres.params["blocks"][0]["router"] is pair[3]["blocks"][0][
        "router"]


def test_signround_traces_like_jax(pair):
    jres, tres, _ = _both(pair, scheme="W4A16G32", iters=4, batch_size=4,
                          seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1, 2,
                                                                    3]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
        np.testing.assert_allclose(tt.min(), jt.min(), rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


def test_nblocks_groups_each_member_its_variant(pair):
    """nblocks = 2 over (MoE rope, dense NoPE) pairs, each member
    forwarding through its own variant, against the JAX package; then on
    tiny-llama4's own pattern ((rope, rope), (rope, NoPE)) the port's
    groups call each block's variant.  (The JAX grouped tuner caches one
    group forward per (gstart % 2, group length) with the first group's
    ``gstart`` bound in it, so there its second group runs blocks 0-1's
    variants and block 3 tunes as a rope layer: ROADMAP C records it.)"""
    jcfg = dataclasses.replace(JCFG, no_rope_layers=(1, 0, 1, 0),
                               layer_types=("sliding_attention",
                                            "full_attention") * 2)
    tree = jax.tree.map(np.asarray, pair[1])
    tcfg = port_config(jcfg)
    alt = (jcfg, pair[1], tcfg, params_from_jax(tree, tcfg, "cpu"))
    jres, tres, _ = _both(alt, scheme="W4A16G32", iters=4, batch_size=4,
                          seed=0, nblocks=2)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 2]
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], jt,
                                   rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)
    calls = []
    orig = t4.block_fwd_for

    def spy(cfg, li):
        calls.append(li)
        return orig(cfg, li)
    t4.block_fwd_for = spy
    try:
        AutoRound((pair[3], pair[2]), device="cpu", scheme="W4A16G32",
                  iters=1, batch_size=4, nblocks=2).quantize(IDS)
    finally:
        t4.block_fwd_for = orig
    assert calls == [0, 1, 2, 3]


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
        assert type(cfg) is t4.Llama4Config
        assert dataclasses.replace(cfg, dtype=torch.float32) == pair[2]
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(t4.model_fwd(params, ids, cfg),
                                   t4.model_fwd(ar.result.params, ids, cfg),
                                   rtol=0, atol=0)


# --------------------------------------------------------------------- HF

def write_hf(tree, cfg, path):
    """An HF ``llama4_text`` directory from a numpy tree, the experts fused
    as the published checkpoints store them (``feed_forward.experts.
    gate_up_proj`` (E, H, 2I): gate in the first half, up in the second;
    ``down_proj`` (E, I, H)), bf16."""
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16()
    t = {"model.embed_tokens.weight": bf(tree["embed_tokens"]),
         "model.norm.weight": bf(tree["norm"]),
         "lm_head.weight": bf(tree["lm_head"])}
    for li, b in enumerate(tree["blocks"]):
        p = f"model.layers.{li}."
        for n in ("q", "k", "v", "o"):
            t[f"{p}self_attn.{n}_proj.weight"] = bf(b[f"{n}_proj"])
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{n}.weight"] = bf(b[n])
        if "experts" not in b:
            for n in ("gate_proj", "up_proj", "down_proj"):
                t[f"{p}feed_forward.{n}.weight"] = bf(b[n])
            continue
        t[p + "feed_forward.router.weight"] = bf(b["router"])
        ex = b["experts"]
        t[p + "feed_forward.experts.gate_up_proj"] = bf(np.stack(
            [np.concatenate([np.asarray(ew["gate_proj"]).T,
                             np.asarray(ew["up_proj"]).T], axis=1)
             for ew in ex]))
        t[p + "feed_forward.experts.down_proj"] = bf(np.stack(
            [np.asarray(ew["down_proj"]).T for ew in ex]))
        for n in ("gate_proj", "up_proj", "down_proj"):
            t[f"{p}feed_forward.shared_expert.{n}.weight"] = bf(
                b["shared_expert"][n])
    os.makedirs(path, exist_ok=True)
    save_file(t, os.path.join(path, "model.safetensors"))
    hf = dict(model_type="llama4_text", vocab_size=cfg.vocab_size,
              hidden_size=cfg.hidden_size,
              intermediate_size=cfg.intermediate_size,
              intermediate_size_mlp=cfg.intermediate_size_mlp,
              num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads,
              num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
              num_local_experts=cfg.num_experts,
              num_experts_per_tok=cfg.top_k, moe_layers=list(cfg.moe_layers),
              no_rope_layers=list(cfg.no_rope_layers),
              attention_chunk_size=cfg.sliding_window,
              layer_types=["chunked_attention" if t == "sliding_attention"
                           else t for t in cfg.layer_types],
              floor_scale=cfg.floor_scale, attn_scale=cfg.temp_attn_scale,
              tie_word_embeddings=False)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return path



def test_load_hf_checkpoint_like_jax(pair, tmp_path):
    path = write_hf(jax.tree.map(np.asarray, pair[1]), JCFG,
                    str(tmp_path / "hf"))
    tp, tcfg = th.load_hf_checkpoint(path, torch.float32, device="cpu")
    jp, jcfg = jh.load_hf_checkpoint(path, jnp.float32)
    assert type(tcfg) is t4.Llama4Config
    assert tcfg == config_from_jax(dataclasses.asdict(jcfg))
    assert tcfg.layer_types == JCFG.layer_types
    assert tcfg.floor_scale == 4.0 and tcfg.moe_layers == (0, 2)
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp), jp)
    # the dense layers' empty expert lists are gone
    assert "experts" not in tp["blocks"][1]
    assert len(tp["blocks"][2]["experts"]) == JCFG.num_experts
    with pytest.raises(NotImplementedError, match="no HF writer"):
        th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "out"))


def test_cli_on_a_llama4_text_directory(pair, tmp_path, capsys, monkeypatch):
    """An HF ``llama4_text`` directory through both CLIs: the exports are
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
    assert trep["layers"] == jrep["layers"] == 2 * (7 + 12) + 2 * 7 + 1
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



def test_engine_stacks_the_moe_blocks_only(rtn):
    """The grouped route's triple: the MoE blocks' experts stack, the
    dense blocks fuse gate / up, the shared expert packs per projection."""
    _, te = _engines(rtn)
    stacked = sorted(k for k in te.packed if "experts_stack" in k)
    assert stacked == [f"blocks.{b}.experts_stack.{w}" for b in (0, 2)
                       for w in ("down_proj", "gate_proj", "up_proj")]
    assert not any(".experts." in k for k in te.packed)
    assert {"blocks.1.gate_up", "blocks.3.gate_up", "blocks.0.qkv",
            "blocks.2.shared_expert.up_proj"} <= set(te.packed)
    lf = _make_linear_fn(te.packed, te.packed_kinds, 2)
    assert lf.grouped_names == {"gate_proj", "up_proj", "down_proj"}


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_prefill_and_decode_match_the_jax_engine(kv_quant, rtn):
    """A 12-token prompt (the 8-token chunk bites at prefill, the NoPE
    temperature from position 3) and four decode steps into the second
    chunk."""
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
    for _ in range(4):
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)
        _close(jlog, tlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_scan_equals_generate_and_jax(kv_quant, rtn):
    """A second call with new prompts replays the same step: its NoPE
    temperature comes from the device positions, not the first call's."""
    je, te = _engines(rtn, kv_quant)
    rng = np.random.default_rng(3)
    for S in (10, 5):
        p = rng.integers(0, 256, (2, S))
        want = np.asarray(je.generate_scan(jnp.asarray(p), max_new_tokens=6))
        got = te.generate_scan(p, max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(te.generate(p, max_new_tokens=6),
                                      want)


def test_batcher_schedule_equals_jax(rtn):
    """The JAX ``test_continuous_batching`` case, with a late join: the
    slots sit at their own positions (their own chunks and temperatures);
    each request's tokens equal ``generate`` alone and the JAX
    batcher's."""
    je, te = _engines(rtn)
    te.max_seq = je.max_seq = 64
    cb = ContinuousBatchingEngine(te, max_batch=3, max_seq=64,
                                  prompt_buckets=(16,))
    jcb = JCB(je, max_batch=3, max_seq=64, prompt_buckets=(16,))
    prompts = [[3, 5, 7, 2, 9, 11, 1, 8, 6, 4], [12, 4, 9],
               [7, 7, 1, 2, 9, 9, 3, 1, 4, 4, 2, 5, 6]]
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
    """``moe_capacity_factor = E / k`` (nothing drops) against the JAX
    engine at the same factor."""
    full = JCFG.num_experts / JCFG.top_k
    monkeypatch.setattr(jenvs, "AR_MOE_CAPACITY_FACTOR", full)
    je, te = _engines(rtn, moe_capacity_factor=full)
    p = np.random.default_rng(5).integers(0, 256, (2, 12))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close(je.decode_step(jnp.asarray(tok), jc)[0],
           te.decode_step(torch.from_numpy(tok), tc)[0], LOGIT_TOL)


def test_from_pretrained_of_a_llama4_export(rtn, tmp_path):
    out = rtn[2].save_quantized(str(tmp_path / "e"), "autoround")
    le = QuantizedLlama.from_pretrained(out, max_seq=MAX_SEQ, device="cpu",
                                        kv_quant="int8")
    _, te = _engines(rtn, "int8")
    assert type(le.cfg) is t4.Llama4Config and le.cfg == make_pair()[2]
    assert sorted(le.packed) == sorted(te.packed)
    assert "experts" not in le.params["blocks"][3]
    p = np.random.default_rng(6).integers(0, 256, (2, 12))
    llog, lc = le.prefill(p)
    tlog, tc = te.prefill(p)
    torch.testing.assert_close(llog, tlog, rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
    tok = tlog.argmax(-1).to(torch.int32)
    torch.testing.assert_close(le.decode_step(tok, lc)[0],
                               te.decode_step(tok, tc)[0],
                               rtol=FP16_SCALE_TOL, atol=FP16_SCALE_TOL)
