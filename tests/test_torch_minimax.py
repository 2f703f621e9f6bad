"""Port parity for MiniMax-Text-01 / M1 (``models/minimax.py``): the decay
rates, the chunked lightning attention (S below, at and above the chunk,
with an initial state, chunk invariance), the O(1) recurrent step, both
block kinds and the model on ``tiny-minimax``, RTN, SignRound and
``nblocks`` over the hybrid stack, the norm / bias leaves (``attn_norm``,
not ``slope_rate``), export, an HF ``minimax`` directory (written here:
neither package has a writer for it), the writer's refusal and the CLI,
each against the JAX package on the same numpy inputs.  Serving is
``tests/test_torch_minimax_serve.py``.

The six residual factors are moved off 1.0 on both sides (a swapped
factor shows), every norm gain by N(0, 0.1).

Tolerances (fp32 throughout, CPU):
  * ``slope_rate``: bit-equal;
  * lightning attention, its state and the recurrent step: 1e-5 relative
    to the output's scale (einsums summed in another order; the fast
    heads' decays underflow to zero in both);
  * chunk invariance (the port against itself): 2e-5;
  * blocks and model logits: 1e-5;
  * RTN: every code equal, scales rtol 5e-7;
  * SignRound (4 iterations a block): first loss rtol 1e-3, best loss and
    trace rtol 5e-6, but for the steps of ``NOISE_FLIP`` (the published
    pattern's blocks 2 and 3 from their fourth and second steps) and
    ``NBLOCKS_FLIP`` (``nblocks = 2``'s second group from its fourth step),
    held to 2e-3, and of ``NORM_BIAS_FLIP`` (block 0 of the norm / bias
    run from its third step), held to 1e-4: a gradient entry that cancels
    to rounding noise takes another sign, and a one-ulp change of the
    input moves the port's own traces there as far;
  * norm / bias leaves after tuning: rtol 1e-5;
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
from autoround_tpu.models import llama as jl
from autoround_tpu.models import minimax as jm
from autoround_tpu.quantize import orchestrator as jorch
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models import minimax as tm
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.quantize import orchestrator as torch_orch
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import save_file
from test_torch_deepseek import _codes, _leaves_equal, SCALE_RTOL
from _port_threads import one_torch_thread  # noqa: F401

RULE_TOL = 1e-5
CHUNK_TOL = 2e-5
LOGIT_TOL = 1e-5
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6
LEAF_RTOL = 1e-5

# the residual factors off 1.0, each its own value
FACTORS = dict(full_attn_alpha_factor=1.7, full_attn_beta_factor=0.8,
               linear_attn_alpha_factor=1.3, linear_attn_beta_factor=0.9,
               mlp_alpha_factor=1.5, mlp_beta_factor=1.1)
# tiny-minimax's widths over the published 7 : 1 pattern's layers 4-7
PUBLISHED = ("linear_attention",) * 3 + ("full_attention",)
IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg), type(jcfg).__name__)


def jax_config(layer_types=None):
    cfg = dataclasses.replace(jm.CONFIG_PRESETS["tiny-minimax"], **FACTORS)
    if layer_types is not None:
        cfg = dataclasses.replace(cfg, layer_types=layer_types)
    return cfg


@functools.lru_cache(maxsize=None)
def make_pair(layer_types=None, seed=0):
    """(jcfg, JAX params, port cfg, port params): ``tiny-minimax`` with
    the factors moved (``layer_types`` replaced where given), JAX
    ``init_params`` with every norm gain moved by N(0, 0.1), carried to
    the port."""
    jcfg = jax_config(layer_types)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        for k, v in b.items():
            if "norm" in k:
                b[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    tcfg = port_config(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(
        tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair()


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    for name, jcfg in jm.CONFIG_PRESETS.items():
        cfg = ALL_PRESETS[name]
        assert type(cfg) is tm.MiniMaxConfig
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert port_config(jcfg) == cfg
        fns = get_model_fns(cfg)
        assert fns.block_fwd is tm.block_fwd
        assert fns.block_with_cache is tm.block_with_cache
        assert fns.layer_is_linear is tm.layer_is_linear
        assert fns.block_linear_names(cfg) == jm.block_linear_names(jcfg)
        kinds = {tm.layer_is_linear(cfg, i): fns.block_fwd_for(cfg, i)
                 for i in range(cfg.num_layers)}
        assert len(set(map(id, kinds.values()))) == len(kinds) == 2
        assert [tm.layer_is_linear(cfg, i) for i in range(cfg.num_layers)] \
            == [jm.layer_is_linear(jcfg, i) for i in range(jcfg.num_layers)]
    cfg = ALL_PRESETS["tiny-minimax"]
    jp = jm.init_params(jm.CONFIG_PRESETS["tiny-minimax"],
                        jax.random.PRNGKey(0))
    tp = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = lambda t: (tuple(t.shape), str(t.dtype))
    assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
        jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp))
    # a bf16 model keeps its norms, attn_norm and slope_rate fp32
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    tb = tm.init_params(bf, torch.Generator().manual_seed(0), "cpu")
    assert tb["blocks"][0]["qkv_proj"].dtype == torch.bfloat16
    assert {tb["blocks"][0][k].dtype for k in (
        "attn_norm", "slope_rate", "input_layernorm")} == {torch.float32}
    carried = params_from_jax(jax.tree.map(np.asarray, jp), bf, "cpu")
    assert carried["blocks"][0]["slope_rate"].dtype == torch.float32
    assert carried["blocks"][0]["attn_norm"].dtype == torch.float32
    # an export's model_config carries no class name: still MiniMax
    assert type(config_from_jax(dataclasses.asdict(
        jm.CONFIG_PRESETS["tiny-minimax"]))) is tm.MiniMaxConfig


@pytest.mark.parametrize("preset,layers", [("tiny-minimax", 4),
                                           ("minimax-text-01", 80),
                                           ("minimax-text-01", 4)])
def test_slope_rate_bit_equal(preset, layers):
    """Every layer's rates bit-equal to JAX's; a depth cut moves them
    (they depend on ``num_layers``) in both packages alike."""
    jcfg = dataclasses.replace(jm.CONFIG_PRESETS[preset], num_layers=layers)
    tcfg = port_config(jcfg)
    for li in range(layers):
        t = tm.slope_rate(tcfg, li)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), jm.slope_rate(jcfg, li))


# --------------------------------------------------- lightning attention

def _qkv(seed, S, B=2, nh=4, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, nh, d)).astype(np.float32)
            for _ in range(3)]


def _rel_close(j, t, tol):
    j = np.asarray(j, np.float32)
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [5, 8, 21])
def test_lightning_attention_matches_jax(S, with_state):
    """S below, at and above the 8-token chunk (21: two chunks and a
    remainder), from zeros or from a random initial state: the output and
    the final state.  Layer 0's rates (fast heads: e^(-rate · 8) is
    small, the decays between reach denormals at the published chunk)."""
    jcfg = jax_config()
    rate = jm.slope_rate(jcfg, 0)
    q, k, v = _qkv(3, S)
    st = (np.random.default_rng(4).standard_normal((2, 4, 16, 16)).astype(
        np.float32) * 0.1 if with_state else None)
    jo, js = jm.lightning_attention(
        *map(jnp.asarray, (q, k, v, rate)), 8,
        state=None if st is None else jnp.asarray(st), return_state=True)
    to, ts = tm.lightning_attention(
        *map(torch.from_numpy, (q, k, v, rate)), 8,
        state=None if st is None else torch.from_numpy(st),
        return_state=True)
    assert to.shape == (2, S, 4, 16) and to.dtype == torch.float32
    assert ts.shape == (2, 4, 16, 16) and ts.dtype == torch.float32
    _rel_close(jo, to, RULE_TOL)
    _rel_close(js, ts, RULE_TOL)
    torch.testing.assert_close(tm.lightning_attention(
        *map(torch.from_numpy, (q, k, v, rate)), 8,
        state=None if st is None else torch.from_numpy(st)), to,
        rtol=0, atol=0)


def test_lightning_chunk_invariance():
    """The chunk is a reformulation only: chunks of 4 / 8 / 32 agree."""
    q, k, v = map(torch.from_numpy, _qkv(5, 24, nh=4))
    rate = tm.slope_rate(tm.CONFIG_PRESETS["tiny-minimax"], 1)
    y8, s8 = tm.lightning_attention(q, k, v, rate, 8, return_state=True)
    for c in (4, 32):
        yc, sc = tm.lightning_attention(q, k, v, rate, c, return_state=True)
        torch.testing.assert_close(yc, y8, rtol=CHUNK_TOL, atol=CHUNK_TOL)
        torch.testing.assert_close(sc, s8, rtol=CHUNK_TOL, atol=CHUNK_TOL)


def test_lightning_step_matches_jax_and_the_chunked_form():
    """Five steps against JAX's from a random state, then the port's steps
    from zero against its own chunked pass over 11 tokens: each token's
    output and the final state."""
    jcfg = jax_config()
    rate = jm.slope_rate(jcfg, 2)
    rng = np.random.default_rng(6)
    st = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 0.1
    js, ts = jnp.asarray(st), torch.from_numpy(st)
    for i in range(5):
        q, k, v = _qkv(10 + i, 1)
        jo, js = jm.lightning_step(*map(jnp.asarray, (q, k, v, rate)), js)
        to, ts = tm.lightning_step(*map(torch.from_numpy, (q, k, v, rate)),
                                   ts)
        _rel_close(jo, to, RULE_TOL)
        _rel_close(js, ts, RULE_TOL)
    q, k, v = map(torch.from_numpy, _qkv(7, 11))
    rate = torch.from_numpy(rate)
    y, s_chunked = tm.lightning_attention(q, k, v, rate, 8,
                                          return_state=True)
    s = torch.zeros((2, 4, 16, 16))
    for t in range(11):
        o, s = tm.lightning_step(q[:, t:t + 1], k[:, t:t + 1],
                                 v[:, t:t + 1], rate, s)
        torch.testing.assert_close(o, y[:, t:t + 1], rtol=RULE_TOL,
                                   atol=RULE_TOL * float(y.abs().max()))
    torch.testing.assert_close(s, s_chunked, rtol=RULE_TOL,
                               atol=RULE_TOL * float(s_chunked.abs().max()))


@pytest.mark.parametrize("layer_types", [None, PUBLISHED])
def test_blocks_and_model_fwd_match_jax(layer_types):
    """Each block through its own variant and the model at S = 13 (a
    chunk and a remainder), on the alternating preset and on the
    published pattern's layers 4-7."""
    jcfg, jp, tcfg, tp = make_pair(layer_types)
    ids = np.random.default_rng(9).integers(0, 256, (2, 13))
    x = jl.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jl.rope_tables(jcfg, 13)
    tc, ts = tl.rope_tables(tcfg, 13, device="cpu")
    tx = torch.from_numpy(np.array(x))
    for bi in range(jcfg.num_layers):
        jy = jm.block_fwd_for(jcfg, bi)(jp["blocks"][bi], x, jc, js, jcfg)
        ty = tm.block_fwd_for(tcfg, bi)(tp["blocks"][bi], tx, tc, ts, tcfg)
        _close(jy, ty, LOGIT_TOL)
        x, tx = jy, torch.from_numpy(np.array(jy))
    _close(jm.model_fwd(jp, jnp.asarray(ids), jcfg),
           tm.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


# ------------------------------------------------------ quantize and export

def _both(pair, ids=IDS, **kw):
    jcfg, jp, tcfg, tp = pair
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(ids), ar


@pytest.fixture(scope="module")
def rtn(pair):
    return _both(pair, scheme="W4A16G32", iters=0, quant_lm_head=True)


def test_rtn_codes_equal_jax(pair, rtn):
    """Every code of every layer equal to JAX's: the lightning layers'
    qkv_proj / out_proj / output_gate, the full layers' q / k / v / o, the
    experts and the lm_head; ``slope_rate`` and ``attn_norm`` are left as
    they were, fp32."""
    jres, tres, ar = rtn
    jcfg = pair[0]
    assert list(tres.layers) == list(jres.layers)
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(_codes(tres.layers[name], True),
                                      _codes(jq, False), err_msg=name)
        np.testing.assert_allclose(tres.layers[name].scale.numpy(),
                                   np.asarray(jq.scale), rtol=SCALE_RTOL,
                                   err_msg=name)
    E = jcfg.num_experts
    assert len(tres.layers) == 2 * 3 + 2 * 4 + 4 * 3 * E + 1
    assert {"blocks.0.qkv_proj", "blocks.0.output_gate", "blocks.0.out_proj",
            "blocks.1.q_proj", "blocks.1.o_proj"} <= set(tres.layers)
    assert not any(k.startswith("blocks.0.q_proj") for k in tres.layers)
    assert set(ar.layer_schemes) == set(tres.layers)
    blk = tres.params["blocks"][0]
    for leaf in ("slope_rate", "attn_norm", "router"):
        assert blk[leaf] is pair[3]["blocks"][0][leaf], leaf


# (layer_types, block): (first step held to the band, band).  On the
# published pattern a 2^-23 relative change of the embedding (N(0, 1) a
# entry) moves the port's own traces of blocks 2 and 3 by up to 7.2e-4
# and 1.0e-4 from those steps on (measured, seed 0 of three), the size of
# their distance from JAX's: sign-SGD follows a gradient entry that
# cancels to rounding noise the other way
NOISE_FLIP = {(PUBLISHED, 2): (3, 2e-3), (PUBLISHED, 3): (1, 2e-3)}
# nblocks = 2 on the alternating preset, group 2 from its fourth step: the
# same change of the embedding moves the port's own trace there by up to
# 3.2e-3 (measured, four seeds)
NBLOCKS_FLIP = {2: (3, 2e-3)}
# norm / bias tuning, block 0 from its third step: the same change moves
# the port's own traces there by up to 3.3e-5 (measured, three seeds)
NORM_BIAS_FLIP = {0: (2, 1e-4)}


def test_offload_and_donate_equal_the_on_device_run(rtn):
    """``offload_params`` with ``donate_params`` (how a 456B model is
    quantized on one card): every qdq equal to the plain run's, the donated
    blocks released, ``slope_rate`` and ``attn_norm`` fp32 as they were."""
    _, tres, _ = rtn
    tcfg = make_pair()[2]
    bf = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    for cfg in (tcfg, bf):
        own = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        ref = AutoRound((tm.init_params(cfg, torch.Generator().manual_seed(
            3), "cpu"), cfg), scheme="W4A16G32", iters=0, device="cpu",
            quant_lm_head=True).quantize(IDS)
        ar = AutoRound((own, cfg), scheme="W4A16G32", iters=0, device="cpu",
                       quant_lm_head=True, offload_params=True,
                       donate_params=True)
        off = ar.quantize(IDS)
        assert all(b is None for b in ar.params["blocks"])
        assert list(off.layers) == list(ref.layers) == list(tres.layers)
        for n, ql in ref.layers.items():
            assert torch.equal(off.layers[n].qdq, ql.qdq), n
        b0 = off.params["blocks"][0]
        assert b0["slope_rate"].dtype == b0["attn_norm"].dtype \
            == torch.float32
        assert torch.equal(b0["slope_rate"], tm.slope_rate(cfg, 0))


@pytest.mark.parametrize("layer_types", [None, PUBLISHED])
def test_signround_traces_like_jax(layer_types):
    jres, tres, _ = _both(make_pair(layer_types), scheme="W4A16G32",
                          iters=4, batch_size=4, seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1,
                                                                    2, 3]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        step, band = NOISE_FLIP.get((layer_types, bi), (len(jt), 0.0))
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt[:step], jt[:step], rtol=BEST_LOSS_RTOL)
        np.testing.assert_allclose(tt[step:], jt[step:], rtol=band)
        np.testing.assert_allclose(
            tt.min(), jt.min(),
            rtol=BEST_LOSS_RTOL if jt.argmin() < step else band)


def test_nblocks_against_jax_and_each_member_its_variant(pair):
    """nblocks = 2 on the alternating preset ((lin, full) x 2, where the
    JAX grouped tuner's reuse of group 0's variants is harmless) against
    JAX; on the published pattern's layers 4-7 ((lin, lin), (lin, full))
    the port's groups call each member's own variant."""
    jres, tres, _ = _both(pair, scheme="W4A16G32", iters=4, batch_size=4,
                          seed=0, nblocks=2)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 2]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        step, band = NBLOCKS_FLIP.get(bi, (len(jt), 0.0))
        np.testing.assert_allclose(tt[:step], jt[:step], rtol=BEST_LOSS_RTOL)
        np.testing.assert_allclose(tt[step:], jt[step:], rtol=band)
    tcfg, tp = make_pair(PUBLISHED)[2:]
    calls = []
    orig = tm.block_fwd_for

    def spy(cfg, li):
        calls.append((li, tm.layer_is_linear(cfg, li)))
        return orig(cfg, li)
    tm.block_fwd_for = spy
    try:
        res = AutoRound((tp, tcfg), device="cpu", scheme="W4A16G32",
                        iters=1, batch_size=4, nblocks=2).quantize(IDS)
    finally:
        tm.block_fwd_for = orig
    assert calls == [(0, True), (1, True), (2, True), (3, False)]
    assert sorted(res.loss_traces) == [0, 2]


def test_norm_bias_tuning_takes_attn_norm_not_slope_rate(pair):
    """The JAX rule takes every 1-D ``*norm*`` leaf and every ``*_bias``
    leaf: ``attn_norm`` tunes, ``slope_rate`` stays.  The tuned leaves
    against JAX's after 4 steps."""
    jcfg, jp, tcfg, tp = pair
    for jb, tb in zip(jp["blocks"], tp["blocks"]):
        assert torch_orch._norm_bias_leaves_for(tb) \
            == jorch._norm_bias_leaves_for(jb)
    assert torch_orch._norm_bias_leaves_for(tp["blocks"][0]) == (
        "attn_norm", "input_layernorm", "post_attention_layernorm")
    assert torch_orch._norm_bias_leaves_for(tp["blocks"][1]) == (
        "input_layernorm", "post_attention_layernorm")
    jres, tres, _ = _both(pair, ids=IDS[:4], scheme="W4A16G32", iters=4,
                          batch_size=4, seed=0,
                          enable_norm_bias_tuning=True)
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        step, band = NORM_BIAS_FLIP.get(bi, (len(jt), 0.0))
        np.testing.assert_allclose(tt[:step], jt[:step], rtol=BEST_LOSS_RTOL)
        np.testing.assert_allclose(tt[step:], jt[step:], rtol=band)
    moved = 0
    for bi, tb in enumerate(tres.params["blocks"]):
        for leaf in torch_orch._norm_bias_leaves_for(tp["blocks"][bi]):
            want = np.asarray(jres.params["blocks"][bi][leaf])
            assert tb[leaf].dtype == tp["blocks"][bi][leaf].dtype
            np.testing.assert_allclose(tb[leaf].numpy(), want,
                                       rtol=LEAF_RTOL, atol=1e-7,
                                       err_msg=f"{bi} {leaf}")
            moved += leaf == "attn_norm" and not np.array_equal(
                want, np.asarray(jp["blocks"][bi][leaf]))
        if "slope_rate" in tb:
            assert torch.equal(tb["slope_rate"],
                               tp["blocks"][bi]["slope_rate"])
    assert moved > 0                        # an attn_norm moved


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
def test_export_bytes_equal_the_jax_package(fmt, pair, rtn, tmp_path):
    jres, _, ar = rtn
    jd_ = j_save(jres, pair[0], str(tmp_path / "j"), fmt)
    td_ = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd_, f), os.path.join(td_, f),
                           shallow=False), f
    if fmt == "fake":
        params, qcfg = load_fake(td_)
        assert params["blocks"][0]["slope_rate"].dtype == torch.float32
        cfg = config_from_jax(qcfg["model_config"])
        assert type(cfg) is tm.MiniMaxConfig
        assert cfg == dataclasses.replace(pair[2], dtype=cfg.dtype)
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(tm.model_fwd(params, ids, cfg),
                                   tm.model_fwd(ar.result.params, ids, cfg),
                                   rtol=0, atol=0)


# --------------------------------------------------------------------- HF

def hf_config(cfg):
    hf = dict(model_type="minimax", vocab_size=cfg.vocab_size,
              hidden_size=cfg.hidden_size,
              intermediate_size=cfg.intermediate_size,
              num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads,
              num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.hd,
              rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
              tie_word_embeddings=False, num_local_experts=cfg.num_experts,
              num_experts_per_tok=cfg.top_k,
              layer_types=list(cfg.layer_types), block_size=cfg.block_size)
    hf.update({f: getattr(cfg, f) for f in FACTORS})
    return hf


def write_hf(tree, cfg, path):
    """An HF ``minimax`` directory from a numpy tree, bf16: the lightning
    layers' fused ``self_attn.qkv_proj``, ``out_proj``, ``output_gate``,
    ``norm`` and the four decay buffers (which both loaders skip), the full
    layers' q / k / v / o, Mixtral's ``block_sparse_moe`` keys."""
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16()
    t = {"model.embed_tokens.weight": bf(tree["embed_tokens"]),
         "model.norm.weight": bf(tree["norm"]),
         "lm_head.weight": bf(tree["lm_head"])}
    for li, b in enumerate(tree["blocks"]):
        p = f"model.layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{n}.weight"] = bf(b[n])
        if "qkv_proj" in b:
            for n in ("qkv_proj", "out_proj", "output_gate"):
                t[f"{p}self_attn.{n}.weight"] = bf(b[n])
            t[p + "self_attn.norm.weight"] = bf(b["attn_norm"])
            for n in ("slope_rate", "query_decay", "key_decay",
                      "diagonal_decay"):
                t[f"{p}self_attn.{n}"] = torch.ones((cfg.num_heads, 1, 1))
        else:
            for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
                t[f"{p}self_attn.{n}.weight"] = bf(b[n])
        t[p + "block_sparse_moe.gate.weight"] = bf(b["router"])
        for e, ew in enumerate(b["experts"]):
            for wn in ("w1", "w2", "w3"):
                t[f"{p}block_sparse_moe.experts.{e}.{wn}.weight"] = bf(
                    ew[wn])
    os.makedirs(path, exist_ok=True)
    save_file(t, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    return path


def test_load_hf_checkpoint_like_jax(pair, tmp_path):
    """A ``minimax`` directory loads to the JAX loader's tree (qkv fused,
    the decay buffers skipped, ``slope_rate`` recomputed fp32, the config
    field by field); the writer refuses the class."""
    jcfg, jp = pair[:2]
    path = write_hf(jax.tree.map(np.asarray, jp), jcfg, str(tmp_path / "hf"))
    tp, tcfg = th.load_hf_checkpoint(path, torch.float32, device="cpu")
    jp2, jcfg2 = jh.load_hf_checkpoint(path, jnp.float32)
    assert type(tcfg) is tm.MiniMaxConfig
    assert tcfg == port_config(jcfg2) == pair[2]
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp), jp2)
    b0 = tp["blocks"][0]
    assert "q_proj" not in b0 and b0["qkv_proj"].shape == (3 * 64, 64)
    assert b0["slope_rate"].dtype == torch.float32
    np.testing.assert_array_equal(b0["slope_rate"].numpy(),
                                  jm.slope_rate(jcfg, 0))
    bf, _ = th.load_hf_checkpoint(path, torch.bfloat16, device="cpu")
    assert bf["blocks"][0]["slope_rate"].dtype == torch.float32
    assert bf["blocks"][0]["qkv_proj"].dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="no HF writer"):
        th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "out"))


def test_config_from_hf_needs_layer_types():
    """The config field by field against the JAX loader's; without
    ``layer_types`` the port raises naming it (the JAX loader builds an
    all-full model and fails later on a missing ``q_proj``)."""
    hf = hf_config(jax_config(PUBLISHED))
    t = th.config_from_hf(hf, torch.float32)
    j = jh.config_from_hf(hf, jnp.float32)
    assert type(t) is tm.MiniMaxConfig and t == port_config(j)
    assert t.layer_types == PUBLISHED and t.mlp_alpha_factor == 1.5
    hf.pop("layer_types")
    with pytest.raises(ValueError, match="layer_types"):
        th.config_from_hf(hf)
    assert not jh.config_from_hf(hf).layer_types


def test_cli_on_a_minimax_directory(pair, tmp_path, capsys, monkeypatch):
    """An HF ``minimax`` directory through both CLIs: the exports are
    byte-equal."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    jcfg, jp = pair[:2]
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
    assert trep["layers"] == jrep["layers"] == 2 * 3 + 2 * 4 + 4 * 3 * 4 + 1
    for f in ("model.safetensors", "quantization_config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
