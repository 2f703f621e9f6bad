"""Port parity for Qwen3-Next and Qwen3.5-MoE (``models/qwen3next.py``):
the L2 norm, the chunked gated delta rule (padded and not, its final state,
chunk invariance), the recurrent decode step, the DeltaNet mixer with its
conv tail, the gated full attention, both block variants and the model on
``tiny-qwen3next`` and ``tiny-qwen35moe``, RTN, SignRound and ``nblocks``
over the hybrid stack, the norm / bias leaves (``dt_bias`` among them, as
in the JAX package), export, both HF layouts (per-expert keys and Qwen3.5's
fused stacks with an ``mtp.*`` tensor), the HF writer's refusal and the
CLI, each against the JAX package on the same numpy inputs.  Serving is
``tests/test_torch_qwen3next_serve.py``.

Every norm gain is moved off its initial value by N(0, 0.1) and
``dt_bias`` by N(0, 0.5), so the offsets and the decay's bias count.

Tolerances (fp32 throughout, CPU):
  * L2 norm, conv, gates: 1e-6;
  * delta rule, recurrent step and its state: 1e-5 (einsums and a
    triangular solve summed in another order);
  * chunk invariance (the port against itself): 2e-4, the JAX test's;
  * DeltaNet, attention, blocks and model logits: 1e-5;
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
from autoround_tpu.models import llama as jl
from autoround_tpu.models import qwen3next as jq
from autoround_tpu.quantize import orchestrator as jorch
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import load_fake
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models import qwen3next as tq
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.quantize import orchestrator as torch_orch
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import save_file
from test_torch_deepseek import _layers_close, _leaves_equal
from _port_threads import one_torch_thread  # noqa: F401

EXACT_TOL = 1e-6
RULE_TOL = 1e-5
CHUNK_TOL = 2e-4
LOGIT_TOL = 1e-5
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6

NAMES = ("tiny-qwen3next", "tiny-qwen35moe")
IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg), type(jcfg).__name__)


@functools.lru_cache(maxsize=None)
def make_pair(name, seed=0):
    """(jcfg, JAX params, port cfg, port params): JAX ``init_params`` with
    every norm gain moved by N(0, 0.1) and ``dt_bias`` by N(0, 0.5),
    carried to the port."""
    jcfg = jq.CONFIG_PRESETS[name]
    tree = jax.tree.map(np.asarray, jq.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        for k, v in b.items():
            if "norm" in k:
                b[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
            elif k == "dt_bias":
                b[k] = (v + rng.normal(0, 0.5, v.shape)).astype(v.dtype)
    tcfg = port_config(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(
        tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    return {n: make_pair(n) for n in NAMES}


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    for name, jcfg in jq.CONFIG_PRESETS.items():
        cfg = ALL_PRESETS[name]
        assert type(cfg).__name__ == type(jcfg).__name__
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert port_config(jcfg) == cfg
        fns = get_model_fns(cfg)
        assert fns.block_fwd is tq.block_fwd
        assert fns.block_with_cache is tq.block_with_cache
        assert fns.rope_tables is tl.rope_tables
        assert fns.block_linear_names(cfg) == jq.block_linear_names(jcfg)
        assert "in_proj_ba" not in fns.block_linear_names(cfg)
        # two stable callables: one per layer kind
        kinds = {tq.is_linear_layer(cfg, i): fns.block_fwd_for(cfg, i)
                 for i in range(cfg.num_layers)}
        assert len(set(map(id, kinds.values()))) == len(kinds) == 2
        jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tq.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        meta = lambda t: (tuple(t.shape), str(t.dtype))
        assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
            jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp))
        assert tp["blocks"][0]["A_log"].dtype == torch.float32
        a = torch.exp(tp["blocks"][0]["A_log"])
        assert bool(((a >= 1e-3) & (a <= 16.0)).all())
    # an export's model_config carries no class name: a Qwen3NextConfig
    fields = dataclasses.asdict(jq.CONFIG_PRESETS["tiny-qwen35moe"])
    assert type(config_from_jax(fields)) is tq.Qwen3NextConfig


def test_config_from_jax_refuses_minimax():
    """MiniMax (a MixtralConfig subclass in the JAX package) was refused
    until the port had it; its fields now build a ``MiniMaxConfig``, never
    a plain MixtralConfig or a Qwen3-Next one, with or without the class
    name."""
    from autoround_tpu.models import minimax as jmm
    from autoround_tpu_torch.models import minimax as tmm

    jcfg = jmm.MiniMaxConfig(vocab_size=256, hidden_size=64,
                             intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2,
                             mlp_beta_factor=0.5)
    for name in (None, "MiniMaxConfig"):
        cfg = config_from_jax(dataclasses.asdict(jcfg), name)
        assert type(cfg) is tmm.MiniMaxConfig
        assert cfg.mlp_beta_factor == 0.5 and cfg.num_experts == 8


def test_mlp_only_layers_init_and_convert():
    jcfg = dataclasses.replace(jq.CONFIG_PRESETS["tiny-qwen3next"],
                               mlp_only_layers=(1, 3))
    cfg = port_config(jcfg)
    assert cfg.mlp_only_layers == (1, 3)
    tp = tq.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "experts" not in tp["blocks"][1] and "gate_proj" in tp["blocks"][3]
    assert tp["blocks"][1]["gate_proj"].shape == (cfg.intermediate_size,
                                                  cfg.hidden_size)
    assert "experts" in tp["blocks"][0]


# ------------------------------------------------------------ delta rule

def _rule_inputs(seed, B=2, S=16, H=4, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    g = -np.log1p(np.exp(f(B, S, H)))                    # -softplus
    beta = 1 / (1 + np.exp(-f(B, S, H)))
    return f(B, S, H, dk), f(B, S, H, dk), f(B, S, H, dv), g, beta


def test_l2norm_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 5, 16)).astype(
        np.float32)
    x[0, 0] = 0.0                      # the eps term, not a clamp
    _close(jq._l2norm(jnp.asarray(x)), tq._l2norm(torch.from_numpy(x)),
           EXACT_TOL)


@pytest.mark.parametrize("S", [16, 13])
def test_chunk_gated_delta_rule_matches_jax(S):
    """S = 16: two whole chunks of 8; S = 13: the last chunk padded.  The
    output and the final state (``return_state``)."""
    q, k, v, g, beta = _rule_inputs(3, S=S)
    j = [jnp.asarray(a) for a in (q, k, v, g, beta)]
    t = [torch.from_numpy(a) for a in (q, k, v, g, beta)]
    jo, js = jq.chunk_gated_delta_rule(*j, chunk=8, return_state=True)
    to, ts = tq.chunk_gated_delta_rule(*t, chunk=8, return_state=True)
    assert to.shape == (2, S, 4, 8) and to.dtype == torch.float32
    assert ts.shape == (2, 4, 8, 8)
    _close(jo, to, RULE_TOL)
    _close(js, ts, RULE_TOL)
    _close(jq.chunk_gated_delta_rule(*j, chunk=8),
           tq.chunk_gated_delta_rule(*t, chunk=8), RULE_TOL)


def test_delta_rule_chunk_invariance():
    """The JAX test's case on the port: the chunk size is an algebraic
    reformulation only."""
    q, k, v, g, beta = (torch.from_numpy(a)
                        for a in _rule_inputs(4, S=24, H=3))
    y8, s8 = tq.chunk_gated_delta_rule(q, k, v, g, beta, chunk=8,
                                       return_state=True)
    for c in (4, 24, 64):
        yc, sc = tq.chunk_gated_delta_rule(q, k, v, g, beta, chunk=c,
                                           return_state=True)
        torch.testing.assert_close(yc, y8, rtol=CHUNK_TOL, atol=CHUNK_TOL)
        torch.testing.assert_close(sc, s8, rtol=CHUNK_TOL, atol=CHUNK_TOL)


def _h(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.hidden_size)).astype(np.float32)


@pytest.mark.parametrize("S", [13, 2])
def test_gated_delta_net_and_its_cache_match_jax(S, pairs):
    """The mixer's output, conv tail and state; at S = 2 < K - 1 the tail
    is left-padded with zeros."""
    jcfg, jp, tcfg, tp = pairs["tiny-qwen3next"]
    h = _h(jcfg, 2, S, 5)
    jy, jt, js = jq._gated_delta_net(jp["blocks"][0], jnp.asarray(h), jcfg,
                                     jl._plain_linear, return_cache=True)
    ty, tt, ts = tq._gated_delta_net(tp["blocks"][0], torch.from_numpy(h),
                                     tcfg, tl._plain_linear,
                                     return_cache=True)
    assert tt.shape == (2, tcfg.linear_conv_kernel_dim - 1,
                        2 * 2 * 16 + 4 * 16)
    _close(jy, ty, LOGIT_TOL)
    _close(jt, tt, EXACT_TOL)
    _close(js, ts, RULE_TOL)
    if S == 2:
        assert bool((tt[:, 0] == 0).all())
    _close(jq._gated_delta_net(jp["blocks"][0], jnp.asarray(h), jcfg,
                               jl._plain_linear),
           tq._gated_delta_net(tp["blocks"][0], torch.from_numpy(h), tcfg,
                               tl._plain_linear), LOGIT_TOL)


def test_gated_delta_step_matches_jax_and_the_chunked_rule(pairs):
    """Five recurrent steps against JAX's from a random tail and state,
    then the port's steps from zero against its own chunked pass: the
    state and the tail after S tokens, each token's output."""
    jcfg, jp, tcfg, tp = pairs["tiny-qwen3next"]
    blk_j, blk_t = jp["blocks"][1], tp["blocks"][1]
    rng = np.random.default_rng(6)
    cd = 2 * 2 * 16 + 4 * 16
    tail = rng.standard_normal((2, 3, cd)).astype(np.float32)
    state = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 0.1
    jt, js = jnp.asarray(tail), jnp.asarray(state)
    tt, ts = torch.from_numpy(tail), torch.from_numpy(state)
    for i in range(5):
        h = _h(jcfg, 2, 1, 10 + i)
        jy, jt, js = jq.gated_delta_step(blk_j, jnp.asarray(h), jcfg,
                                         jl._plain_linear, jt, js)
        ty, tt, ts = tq.gated_delta_step(blk_t, torch.from_numpy(h), tcfg,
                                         tl._plain_linear, tt, ts)
        _close(jy, ty, RULE_TOL)
        _close(jt, tt, EXACT_TOL)
        _close(js, ts, RULE_TOL)
    h = torch.from_numpy(_h(jcfg, 2, 11, 7))
    y, tail_c, state_c = tq._gated_delta_net(blk_t, h, tcfg,
                                             tl._plain_linear,
                                             return_cache=True)
    tt = torch.zeros((2, 3, cd))
    ts = torch.zeros((2, 4, 16, 16))
    for s in range(11):
        ys, tt, ts = tq.gated_delta_step(blk_t, h[:, s:s + 1], tcfg,
                                         tl._plain_linear, tt, ts)
        torch.testing.assert_close(ys, y[:, s:s + 1], rtol=RULE_TOL,
                                   atol=RULE_TOL)
    # the per-token products round apart from the sequence's in the last bit
    torch.testing.assert_close(tt, tail_c, rtol=EXACT_TOL, atol=EXACT_TOL)
    torch.testing.assert_close(ts, state_c, rtol=RULE_TOL, atol=RULE_TOL)


def test_full_attention_matches_jax(pairs):
    jcfg, jp, tcfg, tp = pairs["tiny-qwen3next"]
    h = _h(jcfg, 2, 9, 8)
    jc, js = jl.rope_tables(jcfg, 9)
    tc, ts = tl.rope_tables(tcfg, 9, device="cpu")
    assert tc.shape == (9, 4)                 # hd 16 x 0.25 rotates
    _close(jq._full_attention(jp["blocks"][3], jnp.asarray(h), jc, js, jcfg,
                              jl._plain_linear),
           tq._full_attention(tp["blocks"][3], torch.from_numpy(h), tc, ts,
                              tcfg, tl._plain_linear), LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_blocks_and_model_fwd_match_jax(name, pairs):
    """Each block through its own variant (DeltaNet or full attention),
    and the model, at S = 13 (the delta rule pads its last chunk)."""
    jcfg, jp, tcfg, tp = pairs[name]
    ids = np.random.default_rng(9).integers(0, 256, (2, 13))
    x = jl.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jl.rope_tables(jcfg, 13)
    tc, ts = tl.rope_tables(tcfg, 13, device="cpu")
    tx = torch.from_numpy(np.array(x))
    for bi in range(jcfg.num_layers):
        _close(jq.block_fwd_for(jcfg, bi)(jp["blocks"][bi], x, jc, js, jcfg),
               tq.block_fwd_for(tcfg, bi)(tp["blocks"][bi], tx, tc, ts,
                                          tcfg), LOGIT_TOL)
    _close(jq.model_fwd(jp, jnp.asarray(ids), jcfg),
           tq.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


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
def test_rtn_hybrid_stack_like_jax(name, pairs, rtn):
    jres, tres, ar = rtn[name]
    jcfg = pairs[name][0]
    _layers_close(jres, tres)
    E = jcfg.num_experts
    n_lin = sum(t == "linear_attention" for t in jcfg.layer_types)
    n_full = jcfg.num_layers - n_lin
    # linear: in_proj_qkvz, out_proj; full: q / k / v / o; every block its
    # experts and shared expert
    assert len(tres.layers) == (2 * n_lin + 4 * n_full
                                + jcfg.num_layers * 3 * (E + 1) + 1)
    assert "blocks.0.in_proj_qkvz" in tres.layers
    assert "blocks.0.in_proj_ba" not in tres.layers
    assert not any(k.startswith("blocks.0.q_proj") for k in tres.layers)
    assert set(ar.layer_schemes) == set(tres.layers)
    blk = tres.params["blocks"][0]
    for leaf in ("conv1d", "A_log", "dt_bias", "linear_norm", "in_proj_ba"):
        assert blk[leaf] is pairs[name][3]["blocks"][0][leaf], leaf
    assert blk["A_log"].dtype == blk["dt_bias"].dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_signround_traces_like_jax(name, pairs):
    jres, tres, _ = _both(pairs[name], scheme="W4A16G32", iters=4,
                          batch_size=4, seed=0)
    jcfg = pairs[name][0]
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == list(
        range(jcfg.num_layers))
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


def test_nblocks_groups_each_member_its_variant(pairs):
    """nblocks = 2 on tiny-qwen3next ((lin, lin), (lin, full)) against the
    JAX package, and the port's groups call each block's variant.  (The
    JAX grouped tuner reuses one group forward per (gstart % 2, length):
    its second group would forward blocks 0-1's kinds, so the JAX side
    runs the period-2 pattern (lin, full) x 2, where that is the same.)"""
    jcfg, jp, tcfg, tp = pairs["tiny-qwen3next"]
    alt = ("linear_attention", "full_attention") * 2
    jcfg2 = dataclasses.replace(jcfg, layer_types=alt)
    tree = jax.tree.map(np.asarray, jq.init_params(jcfg2,
                                                   jax.random.PRNGKey(3)))
    tcfg2 = port_config(jcfg2)
    pair = (jcfg2, jax.tree.map(jnp.asarray, tree), tcfg2,
            params_from_jax(tree, tcfg2, "cpu"))
    jres, tres, _ = _both(pair, scheme="W4A16G32", iters=4, batch_size=4,
                          seed=0, nblocks=2)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 2]
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], jt,
                                   rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)
    calls = []
    orig = tq.block_fwd_for

    def spy(cfg, li):
        calls.append(li)
        return orig(cfg, li)
    tq.block_fwd_for = spy
    try:
        AutoRound((tp, tcfg), device="cpu", scheme="W4A16G32", iters=1,
                  batch_size=4, nblocks=2).quantize(IDS)
    finally:
        tq.block_fwd_for = orig
    assert calls == [0, 1, 2, 3]


def test_norm_bias_tuning_takes_dt_bias_as_jax_does(pairs):
    """The JAX rule takes every 1-D ``*norm*`` leaf and every ``*_bias``
    leaf, so it tunes ``linear_norm`` and the decay's fp32 ``dt_bias``
    (a quirk of the reference, mirrored: ROADMAP C); ``A_log`` stays.
    The tuned leaves against JAX's after 4 steps."""
    jcfg, jp, tcfg, tp = pairs["tiny-qwen3next"]
    for jb, tb in zip(jp["blocks"], tp["blocks"]):
        assert torch_orch._norm_bias_leaves_for(tb) \
            == jorch._norm_bias_leaves_for(jb)
    assert torch_orch._norm_bias_leaves_for(tp["blocks"][0]) == (
        "dt_bias", "input_layernorm", "linear_norm",
        "post_attention_layernorm")
    assert torch_orch._norm_bias_leaves_for(tp["blocks"][3]) == (
        "input_layernorm", "k_norm", "post_attention_layernorm", "q_norm")
    jres, tres, _ = _both(pairs["tiny-qwen3next"], ids=IDS[:4],
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
            np.testing.assert_allclose(tb[leaf].numpy(), want, rtol=1e-5,
                                       atol=1e-7, err_msg=f"{bi} {leaf}")
            moved += leaf == "dt_bias" and not np.array_equal(
                want, np.asarray(jp["blocks"][bi][leaf]))
        assert torch.equal(tb.get("A_log", torch.zeros(1)),
                           tp["blocks"][bi].get("A_log", torch.zeros(1)))
    assert moved > 0                        # a dt_bias moved


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
@pytest.mark.parametrize("name", NAMES)
def test_export_bytes_equal_the_jax_package(name, fmt, pairs, rtn,
                                            tmp_path):
    jres, _, ar = rtn[name]
    jcfg = pairs[name][0]
    jd_ = j_save(jres, jcfg, str(tmp_path / "j"), fmt)
    td_ = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd_, f), os.path.join(td_, f),
                           shallow=False), f
    if fmt == "fake":
        params, qcfg = load_fake(td_)
        assert params["blocks"][0]["A_log"].dtype == torch.float32
        assert params["blocks"][0]["conv1d"].shape == (128, 4)
        cfg = config_from_jax(qcfg["model_config"])
        assert type(cfg) is tq.Qwen3NextConfig
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            dataclasses.replace(pairs[name][2], dtype=cfg.dtype))
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(tq.model_fwd(params, ids, cfg),
                                   tq.model_fwd(ar.result.params, ids, cfg),
                                   rtol=0, atol=0)


# --------------------------------------------------------------------- HF

def _hf_config(cfg, model_type, **extra):
    hf = dict(model_type=model_type, vocab_size=cfg.vocab_size,
              hidden_size=cfg.hidden_size,
              intermediate_size=cfg.intermediate_size,
              moe_intermediate_size=cfg.moe_intermediate_size,
              num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads,
              num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.hd,
              rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
              tie_word_embeddings=False,
              partial_rotary_factor=cfg.partial_rotary_factor,
              layer_types=list(cfg.layer_types),
              linear_num_key_heads=cfg.linear_num_key_heads,
              linear_num_value_heads=cfg.linear_num_value_heads,
              linear_key_head_dim=cfg.linear_key_head_dim,
              linear_value_head_dim=cfg.linear_value_head_dim,
              linear_conv_kernel_dim=cfg.linear_conv_kernel_dim,
              num_experts=cfg.num_experts,
              num_experts_per_tok=cfg.top_k,
              shared_expert_intermediate_size=cfg.shared_expert_intermediate,
              norm_topk_prob=cfg.norm_topk_prob)
    hf.update(extra)
    return hf


def write_hf(tree, cfg, path, model_type, fused):
    """An HF directory from a numpy tree: ``qwen3_next`` with per-expert
    keys, or ``qwen3_5_moe`` with the experts fused as (E, 2I, H)
    ``gate_up_proj`` / (E, H, I) ``down_proj`` stacks and an ``mtp.*``
    draft tensor; bf16 but the fp32 ``dt_bias`` / ``A_log``."""
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16()
    t = {"model.embed_tokens.weight": bf(tree["embed_tokens"]),
         "model.norm.weight": bf(tree["norm"]),
         "lm_head.weight": bf(tree["lm_head"])}
    if fused:
        t["mtp.layers.0.mlp.gate_proj.weight"] = bf(np.ones((8, 8)))
    for li, b in enumerate(tree["blocks"]):
        p = f"model.layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{n}.weight"] = bf(b[n])
        if "in_proj_qkvz" in b:
            la = p + "linear_attn."
            for n in ("in_proj_qkvz", "in_proj_ba", "out_proj"):
                t[f"{la}{n}.weight"] = bf(b[n])
            t[la + "conv1d.weight"] = bf(np.asarray(b["conv1d"])[:, None])
            t[la + "norm.weight"] = bf(b["linear_norm"])
            for n in ("dt_bias", "A_log"):
                t[la + n] = torch.from_numpy(np.array(b[n], np.float32))
        else:
            for n in ("q_proj", "k_proj", "v_proj", "o_proj", "q_norm",
                      "k_norm"):
                t[f"{p}self_attn.{n}.weight"] = bf(b[n])
        if "experts" not in b:
            for n in ("gate_proj", "up_proj", "down_proj"):
                t[f"{p}mlp.{n}.weight"] = bf(b[n])
            continue
        t[p + "mlp.gate.weight"] = bf(b["router"])
        inv = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}
        ex = b["experts"]
        if fused:
            t[p + "mlp.experts.gate_up_proj"] = bf(np.stack(
                [np.concatenate([e["w1"], e["w3"]]) for e in ex]))
            t[p + "mlp.experts.down_proj"] = bf(np.stack([e["w2"]
                                                          for e in ex]))
        else:
            for ei, e in enumerate(ex):
                for wn, hf in inv.items():
                    t[f"{p}mlp.experts.{ei}.{hf}.weight"] = bf(e[wn])
        for wn, hf in inv.items():
            t[f"{p}mlp.shared_expert.{hf}.weight"] = bf(
                b["shared_expert"][wn])
        t[p + "mlp.shared_expert_gate.weight"] = bf(b["shared_expert_gate"])
    os.makedirs(path, exist_ok=True)
    save_file(t, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config(cfg, model_type), f)
    return path


@pytest.mark.parametrize("model_type", ["qwen3_next", "qwen3_5_moe"])
def test_load_hf_checkpoint_like_jax(model_type, pairs, tmp_path):
    """Each layout loads to the JAX loader's tree (``mtp.*`` skipped, the
    conv (conv_dim, K), ``dt_bias`` / ``A_log`` fp32), and the two layouts
    to the same experts; the writer refuses the class."""
    name = "tiny-qwen3next" if model_type == "qwen3_next" else \
        "tiny-qwen35moe"
    jcfg, jp = pairs[name][:2]
    tree = jax.tree.map(np.asarray, jp)
    path = write_hf(tree, jcfg, str(tmp_path / "hf"), model_type,
                    fused=model_type != "qwen3_next")
    tp, tcfg = th.load_hf_checkpoint(path, torch.float32, device="cpu")
    jp2, jcfg2 = jh.load_hf_checkpoint(path, jnp.float32)
    assert type(tcfg).__name__ == type(jcfg2).__name__ == type(jcfg).__name__
    # the loader sets neither qk_norm (the family always norms q / k) nor
    # delta_chunk (64), as the JAX one
    assert tcfg == port_config(jcfg2) == dataclasses.replace(
        pairs[name][2], dtype=torch.float32, qk_norm=False, delta_chunk=64)
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp), jp2)
    assert tp["blocks"][0]["dt_bias"].dtype == torch.float32
    assert "mtp" not in json.dumps(jax.tree.map(lambda t: 0, tp))
    if model_type == "qwen3_5_moe":
        other = write_hf(tree, jcfg, str(tmp_path / "per"), model_type,
                         fused=False)
        _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp),
                      jax.tree.map(lambda t: t.numpy(), th.load_hf_checkpoint(
                          other, torch.float32, device="cpu")[0]))
    with pytest.raises(NotImplementedError, match="no HF writer"):
        th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "out"))


def test_config_from_hf_sparse_step_and_layer_types():
    """``decoder_sparse_step`` adds mlp-only layers as in JAX; a config
    without ``layer_types`` raises naming it (JAX fails later with an
    IndexError); ``qwen3_5`` builds a ``Qwen35MoeConfig``."""
    cfg = jq.CONFIG_PRESETS["tiny-qwen3next"]
    hf = _hf_config(cfg, "qwen3_5", decoder_sparse_step=2,
                    mlp_only_layers=[0])
    t = th.config_from_hf(hf, torch.float32)
    j = jh.config_from_hf(hf, jnp.float32)
    assert type(t) is tq.Qwen35MoeConfig and type(j).__name__ == \
        "Qwen35MoeConfig"
    assert t.mlp_only_layers == j.mlp_only_layers == (0, 2)
    assert t == port_config(j)
    hf.pop("layer_types")
    with pytest.raises(ValueError, match="layer_types"):
        th.config_from_hf(hf)


def test_cli_offers_only_a_directory_with_other_files_to_autotokenizer(
        tmp_path):
    """A weights-only directory (config, safetensors, their index) has no
    tokenizer, so the CLI does not import ``AutoTokenizer`` for it; any
    other file, or a name that is not a local directory, is offered."""
    d = tmp_path / "m"
    d.mkdir()
    for f in ("config.json", "model-00001-of-00002.safetensors",
              "model.safetensors.index.json", "generation_config.json"):
        (d / f).write_text("{}")
    assert not tcli._may_hold_tokenizer(str(d))
    (d / "tokenizer.json").write_text("{}")
    assert tcli._may_hold_tokenizer(str(d))
    assert tcli._may_hold_tokenizer("Qwen/Qwen3-Next-80B-A3B-Instruct")


def test_cli_on_a_qwen3_5_moe_directory(pairs, tmp_path, capsys,
                                        monkeypatch):
    """An HF ``qwen3_5_moe`` directory (fused stacks, an ``mtp.*`` tensor)
    through both CLIs: the exports are byte-equal."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    jcfg, jp = pairs["tiny-qwen35moe"][:2]
    write_hf(jax.tree.map(np.asarray, jp), jcfg, str(tmp_path / "m"),
             "qwen3_5_moe", fused=True)
    np.save(tmp_path / "ids.npy", IDS)
    argv = ["--model", str(tmp_path / "m"), "--recipe", "rtn", "--iters",
            "0", "--dataset", str(tmp_path / "ids.npy"), "--nsamples", "8",
            "--seqlen", "16", "--format", "autoround", "--group-size", "32",
            "--device", "cpu", "--quant-lm-head"]
    assert jcli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + ["--output", str(tmp_path / "t")]) == 0
    trep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trep["layers"] == jrep["layers"] == 2 * 2 + 4 + 3 * 3 * 5 + 1
    for f in ("model.safetensors", "quantization_config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
