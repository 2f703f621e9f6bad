"""Port parity for the DeepSeek family (``models/deepseek.py``,
``models/glm4moe.py``'s GLM-4.6-Lite): rope with yarn, the router, the
routed MLP on its three routes, the blocks and the model, RTN and
SignRound over heterogeneous blocks (a dense block 0, MoE blocks after it),
the plan's pruning and ``W4A16_MIXED``, ``nblocks``, ``offload_params``,
export, the HF reader and writer and the CLI, each against the JAX package
on the same numpy inputs, on ``tiny-deepseek`` (V3: sigmoid router, the
aux-free bias, groups, q LoRA), ``tiny-deepseek-v2`` (softmax router, no
q LoRA) and ``tiny-glmlite``.  Every norm gain is moved off 1 by N(0,
0.1) and the V3 routers' ``e_score_correction_bias`` drawn from N(0, 0.5),
so each counts; random weights give distinct router scores (the masked
groups' zeros tie, and ``deepseek._top_k`` breaks those ties as
``jax.lax.top_k`` does).

Tolerances (fp32 throughout, CPU):
  * rope tables: 1e-6 (the same fp32 products; the float64 frequencies
    cast once on both sides);
  * router: indices equal, weights 1e-6 (fp32 logits summed in other
    orders);
  * routed MLP on each route: 1e-5 (fp32 sums in other orders, outputs
    O(0.01..1)); the grouped combine sums a token's k rows in slot order,
    the JAX package contracts over all experts;
  * block and model logits: 1e-4;
  * RTN: at least 99.8% of each layer's codes equal, scales rtol 5e-7 (in
    practice exact);
  * SignRound, 4 iterations a block (the limits of
    ``tests/test_torch_moe.py``): first loss rtol 1e-3, best loss and trace
    rtol 5e-6, but for the steps of ``NOISE_FLIP`` (block 0 of the q-LoRA
    presets from its third step: a gradient that cancels to rounding noise
    takes another sign, named there), held to 1e-2;
  * export of an RTN result, HF files and the CLI's export: bytes equal.
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
from autoround_tpu.models import glm4moe as jg
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.export import codes_from_qdq, load_fake
from autoround_tpu_torch.models import deepseek as td
from autoround_tpu_torch.models import glm4moe as tg
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

ROPE_TOL = 1e-6
ROUTE_TOL = 1e-6
MLP_TOL = 1e-5
LOGIT_TOL = 1e-4
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6
SCALE_RTOL = 5e-7
CODES_EQUAL_MIN = 0.998

JPRESETS = {"tiny-deepseek": jd.CONFIG_PRESETS["tiny-deepseek"],
            "tiny-deepseek-v2": jd.CONFIG_PRESETS["tiny-deepseek-v2"],
            "tiny-glmlite": jg.CONFIG_PRESETS["tiny-glmlite"]}
NAMES = sorted(JPRESETS)


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def port_config(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg), type(jcfg).__name__)


@functools.lru_cache(maxsize=None)
def make_pair(name, seed=0, jcfg=None):
    """(jcfg, JAX params, port cfg, port params): JAX ``init_params`` with
    the norm gains moved by N(0, 0.1) and the router biases drawn from
    N(0, 0.5), carried to the port.  Made once per process (the trees are
    shared; no test writes into them)."""
    jcfg = jcfg or JPRESETS[name]
    tree = jax.tree.map(np.asarray, jd.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    tree["norm"] = (tree["norm"] + rng.normal(0, 0.1, tree["norm"].shape)
                    ).astype(np.float32)
    for b in tree["blocks"]:
        for k, v in b.items():
            if "norm" in k:
                b[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
            elif k == "e_score_correction_bias":
                b[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tcfg = port_config(jcfg)
    return jcfg, jp, tcfg, params_from_jax(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    return {n: make_pair(n) for n in NAMES}


# ------------------------------------------------------ configs and params

def test_registry_presets_and_init_params():
    for name in ("tiny-deepseek", "tiny-deepseek-v2", "deepseek-v2-lite",
                 "deepseek-v3", "tiny-glmlite"):
        cfg = ALL_PRESETS[name]
        jcfg = {**jd.CONFIG_PRESETS, **jg.CONFIG_PRESETS}[name]
        assert type(cfg).__name__ == type(jcfg).__name__
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        fns = get_model_fns(cfg)
        assert fns.block_fwd is td.block_fwd
        assert fns.rope_tables is td.rope_tables
        assert fns.block_linear_names(cfg) == jd.block_linear_names(jcfg)
    assert isinstance(ALL_PRESETS["tiny-glmlite"], tg.GlmMoeLiteConfig)
    assert td.is_mla(ALL_PRESETS["deepseek-v3"])
    assert not td.is_mla(tl.CONFIG_PRESETS["tiny"])
    for name in NAMES:
        jcfg = JPRESETS[name]
        jp = jd.init_params(jcfg, jax.random.PRNGKey(0))
        tp = td.init_params(ALL_PRESETS[name],
                            torch.Generator().manual_seed(0), "cpu")
        meta = lambda t: (tuple(t.shape), str(t.dtype))
        assert jax.tree.map(lambda a: meta(np.asarray(a)), jp) == \
            jax.tree.map(meta, jax.tree.map(lambda t: t.numpy(), tp))
        logits = td.model_fwd(tp, torch.zeros((1, 4), dtype=torch.long),
                              ALL_PRESETS[name])
        assert logits.shape == (1, 4, 256) and torch.isfinite(logits).all()


def test_config_from_jax_classes():
    assert type(port_config(JPRESETS["tiny-glmlite"])) is tg.GlmMoeLiteConfig
    # an export's model_config has no class name: a DeepseekConfig
    fields = dataclasses.asdict(JPRESETS["tiny-glmlite"])
    assert type(config_from_jax(fields)) is td.DeepseekConfig
    # GLM-4.5's GQA form and GLM-5 DSA are ported since: their classes
    glm45 = dataclasses.asdict(jg.CONFIG_PRESETS["tiny-glm4moe"])
    assert type(config_from_jax(glm45, "Glm4MoeConfig")).__name__ == \
        "Glm4MoeConfig"
    assert type(config_from_jax(dict(fields, index_topk=64))).__name__ == \
        "GlmMoeDsaConfig"
    # LongCat is ported since: its zero experts name its class
    assert type(config_from_jax(dict(fields, zero_expert_num=2))).__name__ \
        == "LongcatConfig"


# ------------------------------------------------------------------- rope

_YARN = dict(yarn_factor=40.0, yarn_beta_fast=32.0, yarn_beta_slow=1.0,
             yarn_original_max_pos=4096, yarn_mscale=0.707,
             yarn_mscale_all_dim=0.707, mscale=0.1 * 0.707 * float(
                 np.log(40.0)) + 1.0)
ROPES = {
    "plain": {},
    "yarn-v2": dict(_YARN, qk_rope_head_dim=64),
    "yarn-att": dict(_YARN, yarn_mscale=1.0, qk_rope_head_dim=64),
    "yarn-tiny": dict(_YARN, yarn_original_max_pos=64),
}


@pytest.mark.parametrize("rope", sorted(ROPES))
def test_rope_tables_match_jax(rope):
    jcfg = dataclasses.replace(JPRESETS["tiny-deepseek"], **ROPES[rope])
    tcfg = port_config(jcfg)
    for S in (1, 37):
        for j, t in zip(jd.rope_tables(jcfg, S),
                        td.rope_tables(tcfg, S, device="cpu")):
            assert t.shape == (S, jcfg.qk_rope_head_dim)
            _close(j, t, ROPE_TOL)
    pos = np.array([0, 5, 4095, 70000], np.int32)
    for j, t in zip(jd.rope_tables(jcfg, 1, positions=jnp.asarray(pos)),
                    td.rope_tables(tcfg, 1,
                                   positions=torch.from_numpy(pos))):
        _close(j, t, ROPE_TOL)
    x = np.random.default_rng(2).standard_normal(
        (2, 5, 3, jcfg.qk_rope_head_dim)).astype(np.float32)
    jc, js = jd.rope_tables(jcfg, 5)
    tc, ts = td.rope_tables(tcfg, 5, device="cpu")
    for inter in (False, True):
        _close(jd._rope_rotate(jnp.asarray(x), jc, js, inter),
               td._rope_rotate(torch.from_numpy(x), tc, ts, inter),
               ROPE_TOL)


# ---------------------------------------------------------------- routing

ROUTES = {
    "v3-grouped": ("tiny-deepseek", {}),
    "v3-ungrouped": ("tiny-deepseek", dict(n_group=1, topk_group=1)),
    "v2-softmax": ("tiny-deepseek-v2", {}),
    "v2-group-limited": ("tiny-deepseek-v2", dict(n_group=4, topk_group=2,
                                                  norm_topk_prob=True)),
    "glmlite": ("tiny-glmlite", {}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(route):
    name, over = ROUTES[route]
    jcfg = dataclasses.replace(JPRESETS[name], num_layers=2, **over)
    jcfg, jp, tcfg, tp = make_pair(name, seed=3, jcfg=jcfg)
    jblk, tblk = jp["blocks"][1], tp["blocks"][1]
    h = np.random.default_rng(4).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    ji, jw = jd._route(jnp.asarray(h), jblk, jcfg)
    ti, tw = td._route(torch.from_numpy(h), tblk, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(jw, tw, ROUTE_TOL)
    # the tokens do not all take the same experts
    assert len({tuple(r) for r in ti.reshape(-1, ti.shape[-1]).tolist()}) > 1


def _lfs(jblk, tblk, grouped):
    """Linear interceptors for both packages: plain products, and (with
    ``grouped``) a grouped form over the stacked dense expert weights."""
    def jlf(name, x, w, b=None):
        return jnp.einsum("...i,oi->...o", x, w)

    def tlf(name, x, w, b=None):
        return torch.einsum("...i,oi->...o", x, w)

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


@pytest.mark.parametrize("name", NAMES)
def test_moe_mlp_three_forms_match_jax(name, pairs):
    jcfg, jp, tcfg, tp = pairs[name]
    jblk, tblk = jp["blocks"][1], tp["blocks"][1]
    h = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    full = jcfg.n_routed_experts / jcfg.num_experts_per_tok  # C = N
    outs = {}
    for grouped in (False, True):
        jlf, tlf = _lfs(jblk, tblk, grouped)
        for factor in (0.0, full):
            want = jd._moe_mlp(jblk, jnp.asarray(h), jcfg, jlf,
                               capacity_factor=factor)
            got = td._moe_mlp(tblk, torch.from_numpy(h), tcfg, tlf,
                              capacity_factor=factor)
            assert got.shape == h.shape and got.dtype == torch.float32
            _close(want, got, MLP_TOL)
            outs[grouped, factor] = got
    for key in ((True, 0.0), (False, full), (True, full)):
        torch.testing.assert_close(outs[key], outs[False, 0.0], rtol=MLP_TOL,
                                   atol=MLP_TOL)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("name", NAMES)
def test_block_and_model_fwd_match_jax(name, pairs):
    jcfg, jp, tcfg, tp = pairs[name]
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 10))
    x = jd.llama.embed_fwd(jp, jnp.asarray(ids), jcfg)
    jc, js = jd.rope_tables(jcfg, 10)
    tc, ts = td.rope_tables(tcfg, 10, device="cpu")
    tx = torch.from_numpy(np.array(x))
    for bi in (0, 1):                          # the dense block, a MoE one
        _close(jd.block_fwd(jp["blocks"][bi], x, jc, js, jcfg),
               td.block_fwd(tp["blocks"][bi], tx, tc, ts, tcfg), LOGIT_TOL)
    # the serving block's prompt pass: the same output and latents
    jo, jckv, jkr = jd.block_with_cache(jp["blocks"][1], x, jc, js, jcfg,
                                        None, None, jd.llama._plain_linear)
    to, tckv, tkr = td.block_with_cache(tp["blocks"][1], tx, tc, ts, tcfg,
                                        None, None, tl._plain_linear)
    for j, t in ((jo, to), (jckv, tckv), (jkr, tkr)):
        _close(j, t, LOGIT_TOL)
    _close(jd.model_fwd(jp, jnp.asarray(ids), jcfg),
           td.model_fwd(tp, torch.from_numpy(ids), tcfg), LOGIT_TOL)


# ------------------------------------------------------ quantize and export

IDS = np.random.default_rng(1).integers(0, 256, (8, 16))


def _both(pair, **kw):
    jcfg, jp, tcfg, tp = pair
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(IDS))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(IDS), ar


@pytest.fixture(scope="module")
def rtn(pairs):
    return {n: _both(pairs[n], scheme="W4A16G32", iters=0,
                     quant_lm_head=True) for n in NAMES}


def _codes(ql, torch_side):
    s = ql.scheme
    qdq = ql.qdq.numpy() if torch_side else np.asarray(ql.qdq)
    sc = ql.scale.numpy() if torch_side else np.asarray(ql.scale)
    return codes_from_qdq(qdq, sc, None, s.bits, s.group_size)


def _layers_close(jres, tres):
    assert list(tres.layers) == list(jres.layers)
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        assert np.mean(_codes(jq, False) == _codes(tq, True)) \
            >= CODES_EQUAL_MIN, name
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=SCALE_RTOL, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_rtn_heterogeneous_blocks_like_jax(name, pairs, rtn):
    jres, tres, ar = rtn[name]
    jcfg = pairs[name][0]
    _layers_close(jres, tres)
    E = jcfg.n_routed_experts
    attn = 5 if jcfg.q_lora_rank else 4
    # the dense block 0 quantizes its MLP, the MoE blocks their experts
    assert len(tres.layers) == (attn + 3) + 2 * (attn + 3 * E + 3) + 1
    assert "blocks.0.gate_proj" in tres.layers
    assert "blocks.0.kv_b_proj" in tres.layers
    assert not any(k.startswith("blocks.0.experts") for k in tres.layers)
    assert "blocks.2.shared_experts.down_proj" in tres.layers
    assert "blocks.1.experts.7.up_proj" in tres.layers
    assert set(ar.layer_schemes) == set(tres.layers)
    # the router and its bias stay dense, the bias fp32
    blk = tres.params["blocks"][1]
    assert blk["gate"] is pairs[name][3]["blocks"][1]["gate"]
    if jcfg.scoring_func == "sigmoid":
        assert blk["e_score_correction_bias"].dtype == torch.float32


# (preset, block): the first step whose loss leaves the 5e-6 band, and the
# band after it.  The q-LoRA presets share block 0's weights; at its second
# step the two packages disagree on the sign of one gradient of
# kv_b_proj's rounding offsets (v[37, 1]: 1.1e-14 in JAX, -6.0e-15 here,
# where the layer's median |gradient| is 1.4e-8: a sum that cancels to
# rounding noise), so sign-SGD moves that offset the other way and the
# losses of steps 2 and 3 differ by 4.1e-3 (measured)
NOISE_FLIP = {("tiny-deepseek", 0): (2, 1e-2), ("tiny-glmlite", 0): (2, 1e-2)}


@pytest.mark.parametrize("name", NAMES)
def test_signround_traces_like_jax(name, pairs):
    jres, tres, _ = _both(pairs[name], scheme="W4A16G32", iters=4,
                          batch_size=4, seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1, 2]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        step, band = NOISE_FLIP.get((name, bi), (len(jt), 0.0))
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt[:step], jt[:step], rtol=BEST_LOSS_RTOL)
        np.testing.assert_allclose(tt[step:], jt[step:], rtol=band)
        np.testing.assert_allclose(tt.min(), jt.min(), rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


def test_nblocks_pair_dense_and_moe_like_jax(pairs):
    """nblocks = 2 over (dense block 0, MoE block 1), then block 2 alone."""
    jres, tres, _ = _both(pairs["tiny-deepseek"], scheme="W4A16G32",
                          iters=4, batch_size=4, seed=0, nblocks=2)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 2]
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], jt,
                                   rtol=BEST_LOSS_RTOL)
    _layers_close(jres, tres)


def test_offload_equals_on_device(pairs, rtn):
    _, tres, _ = rtn["tiny-deepseek-v2"]
    _, _, tcfg, tp = pairs["tiny-deepseek-v2"]
    off = AutoRound((tp, tcfg), scheme="W4A16G32", iters=0,
                    quant_lm_head=True, device="cpu",
                    offload_params=True).quantize(IDS)
    assert list(off.layers) == list(tres.layers)
    for n, ql in tres.layers.items():
        assert torch.equal(off.layers[n].qdq, ql.qdq), n


def test_prune_and_w4a16_mixed_like_jax(pairs):
    jcfg, jp, tcfg, tp = pairs["tiny-deepseek"]
    jar = JAutoRound((jp, jcfg), scheme="W4A16_MIXED", iters=0,
                     quant_lm_head=True)
    tar = AutoRound((tp, tcfg), scheme="W4A16_MIXED", iters=0,
                    quant_lm_head=True, device="cpu")
    assert list(tar.layer_schemes) == list(jar.layer_schemes)
    for n, s in jar.layer_schemes.items():
        assert tar.layer_schemes[n].key() == s.key(), n
    plan = tar.layer_schemes
    assert plan["blocks.1.experts.0.down_proj"].bits == 4
    assert plan["blocks.1.shared_experts.up_proj"].bits == 8
    assert plan["blocks.0.gate_proj"].bits == 8
    assert plan["blocks.0.kv_b_proj"].bits == 8 and plan["lm_head"].bits == 8
    assert not any(n.startswith("blocks.0.experts") for n in plan)


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
        assert type(cfg) is td.DeepseekConfig
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(pairs[name][2],
                                                       f.name), f.name
        ids = torch.from_numpy(IDS[:2])
        torch.testing.assert_close(
            td.model_fwd(params, ids, cfg),
            td.model_fwd(ar.result.params, ids, cfg), rtol=0, atol=0)


# --------------------------------------------------------------------- HF

HF_TYPES = {"tiny-deepseek": "deepseek_v3", "tiny-deepseek-v2": "deepseek_v2",
            "tiny-glmlite": "glm4_moe_lite"}


def _leaves_equal(a, b):
    flat = lambda t: {k: np.asarray(v, np.float32) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


@pytest.mark.parametrize("name", NAMES)
def test_hf_round_trips_both_ways(name, pairs, tmp_path):
    jcfg, jp, tcfg, tp = pairs[name]
    mt = HF_TYPES[name]
    extra = {"model_type": mt} if mt == "glm4_moe_lite" else None
    jh.save_hf_checkpoint(jp, jcfg, str(tmp_path / "j"), hf_extra=extra)
    th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "t"), hf_extra=extra)
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    assert json.loads((tmp_path / "t" / "config.json").read_text())[
        "model_type"] == mt
    # the JAX package's files read by the port, the port's by the JAX one
    tp2, tcfg2 = th.load_hf_checkpoint(str(tmp_path / "j"), torch.float32,
                                       device="cpu")
    jp2, jcfg2 = jh.load_hf_checkpoint(str(tmp_path / "t"), jnp.float32)
    assert type(tcfg2).__name__ == type(jcfg2).__name__ == (
        "GlmMoeLiteConfig" if mt == "glm4_moe_lite" else "DeepseekConfig")
    for f in dataclasses.fields(tcfg2):
        if f.name != "dtype":
            assert getattr(tcfg2, f.name) == getattr(jcfg2, f.name), f.name
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp2), jp2)
    _leaves_equal(jax.tree.map(lambda t: t.numpy(), tp), jp2)
    if jcfg.scoring_func == "sigmoid":
        assert tp2["blocks"][1]["e_score_correction_bias"].dtype == \
            torch.float32


def test_hf_loader_refusals(pairs, tmp_path):
    jcfg, jp, tcfg, tp = pairs["tiny-deepseek"]
    th.save_hf_checkpoint(tp, tcfg, str(tmp_path))
    from autoround_tpu_torch.utils.safetensors_io import load_file, save_file
    flat = load_file(str(tmp_path / "model.safetensors"))
    # an indexer key in a DeepSeek checkpoint goes into the block's
    # ``indexer`` dict, as the JAX loader puts it (GLM-5 DSA is ported)
    flat["model.layers.0.self_attn.indexer.k_proj.weight"] = torch.zeros(4, 4)
    save_file(flat, str(tmp_path / "model.safetensors"))
    tp2, _ = th.load_hf_checkpoint(str(tmp_path), device="cpu")
    jp2, _ = jh.load_hf_checkpoint(str(tmp_path))
    assert tuple(tp2["blocks"][0]["indexer"]["k_proj"].shape) == \
        jp2["blocks"][0]["indexer"]["k_proj"].shape == (4, 4)
    flat.pop("model.layers.0.self_attn.indexer.k_proj.weight")
    # a scale tensor beside a weight that is not FP8 (the FP8 read is
    # ported): both loaders drop the scale and keep the weight as stored
    flat["model.layers.0.self_attn.o_proj.weight_scale_inv"] = \
        torch.ones(1, 1) * 2.0
    save_file(flat, str(tmp_path / "model.safetensors"))
    tp3, _ = th.load_hf_checkpoint(str(tmp_path), device="cpu")
    jp3, _ = jh.load_hf_checkpoint(str(tmp_path))
    for li, jb in enumerate(jp3["blocks"]):
        for k in ("o_proj", "kv_a_proj_with_mqa"):
            np.testing.assert_array_equal(
                tp3["blocks"][li][k].float().numpy(),
                np.asarray(jb[k], np.float32), err_msg=(li, k))
    assert torch.equal(tp3["blocks"][0]["o_proj"], tp2["blocks"][0]["o_proj"])


def test_cli_on_a_deepseek_directory(pairs, tmp_path, capsys, monkeypatch):
    """An HF ``deepseek_v2`` directory through both CLIs: the exports are
    byte-equal."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    jcfg, jp, _, _ = pairs["tiny-deepseek-v2"]
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
    assert trep["layers"] == jrep["layers"] > 3 * 8
    for f in ("model.safetensors", "quantization_config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
