"""Port parity for the Mixtral (MoE) slice: the plain version of the
grouped W4A16 product, capacity dispatch, the routed MLP on its three
routes, the model, RTN and SignRound through dotted expert names, export,
and the serving engine with stacked experts, each against the JAX package
on the same numpy inputs.

Everything runs on the CPU in fp32 (the wrappers take their plain versions
there; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA
kernel against the plain version on the card).

Tolerances:
  * grouped product: both sides sum K fp32 products in different orders:
    1e-4 of an O(1) output (as ``tests/test_torch_ops.py``);
  * ``capacity_slots``: exact against a first-come loop in numpy;
  * routed MLP, block, model, same route on both sides: 1e-5 (fp32 sums in
    different orders; outputs are O(0.01..1));
  * one route against another inside the port: dense-then-mask per expert
    sums experts in index order, the grouped form contracts over the expert
    axis at once, capacity dispatch sums a token's k slots in slot order:
    equal to a few fp32 ulps, 1e-5; with a capacity factor that drops
    slots the routes differ by the dropped contributions and only the same
    route is compared across packages;
  * RTN: qdq, scales, codes exact.  SignRound (the limits of
    ``tests/test_torch_e2e.py``): first loss rtol 1e-3, best loss and trace
    rtol 5e-6, scales rtol 5e-7, at least 99.8% of each layer's codes;
  * export on an RTN run: files byte-identical;
  * engine logits: 1e-4; greedy tokens equal.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu import envs as jenvs
from autoround_tpu.models import llama as jl
from autoround_tpu.models import mixtral as jm
from autoround_tpu.ops.qmatmul import (pack_w4_planes, unpack_w4_planes,
                                       w4a16_matmul_grouped_ref)
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.export import codes_from_qdq
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models import mixtral as tm
from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
from autoround_tpu_torch.ops.qmatmul import (pack_w4, unpack_w4,
                                             w4a16_matmul_grouped,
                                             w4a16_matmul_grouped_plain)
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax

TOL = 1e-5
LOGIT_TOL = 1e-4
FIRST_LOSS_RTOL = 1e-3
BEST_LOSS_RTOL = 5e-6
SCALE_RTOL = 5e-7
CODES_EQUAL_MIN = 0.998
JTINY = jm.CONFIG_PRESETS["tiny-moe"]


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _to_port(jcfg, jparams):
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    return tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 "cpu")


# ---------------------------------------------------------- grouped kernel

@pytest.mark.parametrize("E,C,K,O,g", [(4, 8, 1024, 96, 128),
                                       (2, 5, 2048, 64, 256),
                                       (3, 37, 1024, 40, 128),
                                       (8, 1, 1024, 16, 128)])
def test_grouped_plain_matches_ref(E, C, K, O, g):
    rng = np.random.default_rng(E * C)
    codes = rng.integers(0, 16, (E, O, K)).astype(np.int32)
    scales = (rng.uniform(0.005, 0.02, (E, O, K // g))
              * rng.choice([-1.0, 1.0], (E, O, K // g))).astype(np.float32)
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    jqw = jnp.stack([pack_w4_planes(jnp.asarray(codes[e]), g)
                     for e in range(E)])
    want = w4a16_matmul_grouped_ref(jnp.asarray(x), jqw, jnp.asarray(scales),
                                    g)
    tqw = torch.stack([pack_w4(torch.from_numpy(codes[e])) for e in range(E)])
    got = w4a16_matmul_grouped(torch.from_numpy(x), tqw,
                               torch.from_numpy(scales), g)
    assert got.shape == (E, C, O)
    _close(want, got, 1e-4)
    # one slab shared by all experts (expert stride 0), as dense-then-mask
    # routing hands it over
    shared = torch.from_numpy(x[0]).expand(E, C, K)
    assert shared.stride(0) == 0
    got0 = w4a16_matmul_grouped_plain(shared, tqw, torch.from_numpy(scales),
                                      g)
    want0 = w4a16_matmul_grouped_ref(
        jnp.broadcast_to(jnp.asarray(x[0]), (E, C, K)), jqw,
        jnp.asarray(scales), g)
    _close(want0, got0, 1e-4)


# ------------------------------------------------------- capacity dispatch

def _routing(rng, B, S, E, k):
    """Distinct router probabilities (no top-k ties) → (topi, topv)."""
    logits = rng.standard_normal((B, S, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    topi = np.argsort(-probs, axis=-1)[..., :k]
    topv = np.take_along_axis(probs, topi, -1)
    return topi.astype(np.int32), topv.astype(np.float32)


@pytest.mark.parametrize("factor", [1.0, 4.0])
def test_capacity_slots_are_first_come(factor):
    rng = np.random.default_rng(3)
    B, S, E, k = 2, 12, 4, 2
    topi, _ = _routing(rng, B, S, E, k)
    N = B * S
    C = max(1, int(np.ceil(N * k / E * factor)))
    keep, pos_c = tm.capacity_slots(torch.from_numpy(topi).long(), E, C)
    seen = [0] * E
    want_keep, want_pos = [], []
    for e in topi.reshape(-1):             # token-major slot order
        want_keep.append(seen[e] < C)
        want_pos.append(seen[e] if seen[e] < C else C)
        seen[e] += 1
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(pos_c.numpy(), want_pos)
    assert keep.all() == (factor == 4.0)   # factor 1.0 drops on these seeds


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("factor", [1.0, 4.0])
def test_capacity_dispatch_matches_jax(factor, grouped):
    rng = np.random.default_rng(4)
    B, S, H, E, k = 2, 12, 16, 4, 2
    topi, topv = _routing(rng, B, S, E, k)
    h = rng.standard_normal((B, S, H)).astype(np.float32)
    w = rng.standard_normal((E, H, H)).astype(np.float32) * 0.3
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    want = jm.capacity_dispatch(
        jnp.asarray(h), jnp.asarray(topi), jnp.asarray(topv), E, factor,
        lambda e, xb: jnp.tanh(xb @ jw[e].T),
        grouped_apply=(lambda buf: jnp.tanh(
            jnp.einsum("eck,eok->eco", buf, jw))) if grouped else None)
    got = tm.capacity_dispatch(
        torch.from_numpy(h), torch.from_numpy(topi).long(),
        torch.from_numpy(topv), E, factor,
        lambda e, xb: torch.tanh(xb @ tw[e].T),
        grouped_apply=(lambda buf: torch.tanh(
            torch.einsum("eck,eok->eco", buf, tw))) if grouped else None)
    assert got.shape == (B, S, H) and got.dtype == torch.float32
    _close(want, got)


def test_capacity_dispatch_unported_options_raise():
    h = torch.zeros((1, 2, 4))
    topi = torch.zeros((1, 2, 1), dtype=torch.long)
    topv = torch.ones((1, 2, 1))
    for kw, item in ((dict(expert_offset=2), "A15"),
                     (dict(n_global_experts=8), "A15"),
                     (dict(scale_input=True), "A11")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            tm.capacity_dispatch(h, topi, topv, 2, 1.0, lambda e, x: x, **kw)

    def lf(name, x, w):
        return x @ w.T
    lf.expert_offset = 2
    cfg = tm.CONFIG_PRESETS["tiny-moe"]
    blk = tm.init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu")["blocks"][0]
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        tm._moe_mlp(blk, torch.zeros((1, 2, cfg.hidden_size)), cfg, lf)


# -------------------------------------------------------------- routed MLP

def _lfs(jblk, tblk, grouped):
    """Linear interceptors for both packages: plain products, and (with
    ``grouped``) a grouped form over the stacked dense expert weights."""
    def jlf(name, x, w, b=None):
        return jnp.einsum("...i,oi->...o", x, w)

    def tlf(name, x, w):
        return torch.einsum("...i,oi->...o", x, w)

    if grouped:
        jst = {n: jnp.stack([e[n] for e in jblk["experts"]])
               for n in ("w1", "w2", "w3")}
        tst = {n: torch.stack([e[n] for e in tblk["experts"]])
               for n in ("w1", "w2", "w3")}
        jlf.grouped = lambda n, buf: jnp.einsum("eck,eok->eco", buf, jst[n])
        tlf.grouped = lambda n, buf: torch.einsum("eck,eok->eco", buf, tst[n])
        jlf.grouped_names = tlf.grouped_names = frozenset(jst)
    return jlf, tlf


_VARIANTS = {
    "mixtral": {},
    "shared_expert": dict(shared_expert_intermediate=96),
    "shared_expert_gate": dict(shared_expert_intermediate=96,
                               shared_expert_gate=True),
    "no_topk_norm": dict(norm_topk_prob=False),
    "top1_of_3": dict(num_experts=3, top_k=1),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_moe_mlp_routes_match_jax(variant):
    jcfg = dataclasses.replace(JTINY, num_layers=1, **_VARIANTS[variant])
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg, tparams = _to_port(jcfg, jparams)
    jblk, tblk = jparams["blocks"][0], tparams["blocks"][0]
    assert ("shared_expert" in tblk) == variant.startswith("shared")
    assert ("shared_expert_gate" in tblk) == (variant == "shared_expert_gate")
    h = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    full = jcfg.num_experts / jcfg.top_k      # C = N: nothing can drop
    outs = {}
    for grouped in (False, True):
        jlf, tlf = _lfs(jblk, tblk, grouped)
        for factor in (0.0, full, 1.0):
            want = jm._moe_mlp(jblk, jnp.asarray(h), jcfg, jlf,
                               capacity_factor=factor)
            got = tm._moe_mlp(tblk, torch.from_numpy(h), tcfg, tlf,
                              capacity_factor=factor)
            assert got.shape == h.shape and got.dtype == torch.float32
            _close(want, got)
            outs[grouped, factor] = got
    # the exact routes agree with each other; dropping changes the output
    base = outs[False, 0.0]
    for key in ((True, 0.0), (False, full), (True, full)):
        torch.testing.assert_close(outs[key], base, rtol=TOL, atol=TOL)
    torch.testing.assert_close(outs[True, 1.0], outs[False, 1.0], rtol=TOL,
                               atol=TOL)
    assert (outs[False, 1.0] - base).abs().max() > 100 * TOL


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("qk_norm", [False, True])
def test_block_and_model_fwd_match_jax(qk_norm):
    jcfg = dataclasses.replace(JTINY, qk_norm=qk_norm)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    if qk_norm:      # norms off their init of ones, so that they count
        rng = np.random.default_rng(6)
        for b in jparams["blocks"]:
            for n in ("q_norm", "k_norm"):
                b[n] = jnp.asarray(rng.uniform(0.5, 1.5, b[n].shape),
                                   jnp.float32)
    tcfg, tparams = _to_port(jcfg, jparams)
    assert isinstance(tcfg, tm.MixtralConfig) and tcfg.qk_norm == qk_norm
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 10))
    x = jl.embed_fwd(jparams, jnp.asarray(ids), jcfg)
    cos, sin = jl.rope_tables(jcfg, 10)
    want = jm.block_fwd(jparams["blocks"][0], x, cos, sin, jcfg)
    tcos, tsin = tl.rope_tables(tcfg, 10, device="cpu")
    got = tm.block_fwd(tparams["blocks"][0],
                       torch.from_numpy(np.array(x)), tcos, tsin, tcfg)
    _close(want, got)
    _close(jm.model_fwd(jparams, jnp.asarray(ids), jcfg),
           tm.model_fwd(tparams, torch.from_numpy(ids), tcfg))


def test_registry_presets_and_init_params():
    cfg = ALL_PRESETS["tiny-moe"]
    assert ALL_PRESETS["mixtral-8x7b"].intermediate_size == 14336
    assert "llama3-8b" in ALL_PRESETS
    fns = get_model_fns(cfg)
    assert fns.block_fwd is tm.block_fwd and fns.embed_fwd is tl.embed_fwd
    assert get_model_fns(tl.CONFIG_PRESETS["tiny"]).block_fwd is tl.block_fwd
    with pytest.raises(TypeError):
        get_model_fns(object())
    assert fns.block_linear_names(cfg) == jm.block_linear_names(JTINY)
    full = dataclasses.replace(cfg, shared_expert_intermediate=32,
                               shared_expert_gate=True, qk_norm=True)
    jfull = dataclasses.replace(JTINY, shared_expert_intermediate=32,
                                shared_expert_gate=True, qk_norm=True)
    assert tm.block_linear_names(full) == jm.block_linear_names(jfull)
    p = tm.init_params(full, torch.Generator().manual_seed(0), "cpu")
    jp = jm.init_params(jfull, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape),
                                  jax.tree.map(lambda t: t.numpy(), p))
    logits = tm.model_fwd(p, torch.zeros((1, 4), dtype=torch.long), full)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert torch.isfinite(logits).all()


# ------------------------------------------------------ quantize and export

@pytest.fixture(scope="module")
def tiny():
    jp = jm.init_params(JTINY, jax.random.PRNGKey(0))
    tcfg, tp = _to_port(JTINY, jp)
    ids = np.random.default_rng(1).integers(0, JTINY.vocab_size, (8, 16))
    return dict(jp=jp, tp=tp, tcfg=tcfg, ids=ids)


def _both(tiny, **kw):
    jres = JAutoRound((tiny["jp"], JTINY), **kw).quantize(
        jnp.asarray(tiny["ids"]))
    ar = AutoRound((tiny["tp"], tiny["tcfg"]), device="cpu", **kw)
    return jres, ar.quantize(tiny["ids"]), ar


@pytest.fixture(scope="module")
def rtn_pair(tiny):
    return _both(tiny, scheme="W4A16G32", iters=0)


def test_rtn_quantizes_every_expert_like_jax(tiny, rtn_pair):
    jres, tres, _ = rtn_pair
    assert list(tres.layers) == list(jres.layers)
    assert len(tres.layers) == JTINY.num_layers * (4 + JTINY.num_experts * 3)
    assert "blocks.1.experts.3.w2" in tres.layers
    assert not any("router" in n for n in tres.layers)
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        np.testing.assert_array_equal(tq.qdq.numpy(), np.asarray(jq.qdq),
                                      err_msg=name)
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale),
                                      err_msg=name)
    # the qdq weights are baked into the result's tree, the router is not
    # touched, the caller's tree is left as it was
    e2 = tres.params["blocks"][1]["experts"][2]
    assert torch.equal(e2["w3"], tres.layers["blocks.1.experts.2.w3"].qdq)
    assert tres.params["blocks"][0]["router"] is \
        tiny["tp"]["blocks"][0]["router"]
    assert not torch.equal(tiny["tp"]["blocks"][1]["experts"][2]["w3"],
                           e2["w3"])


def test_tuned_moe_against_jax(tiny):
    jres, tres, _ = _both(tiny, scheme="W2A16G64", iters=8, batch_size=4,
                          seed=0)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1]
    for bi, jt in jres.loss_traces.items():
        tt = tres.loss_traces[bi]
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
        assert tt.min() < tt[0]
    assert list(tres.layers) == list(jres.layers)
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        s = jq.scheme
        jc = codes_from_qdq(np.asarray(jq.qdq), np.asarray(jq.scale), None,
                            s.bits, s.group_size)
        tc = codes_from_qdq(tq.qdq.numpy(), tq.scale.numpy(), None, s.bits,
                            s.group_size)
        assert np.mean(jc == tc) >= CODES_EQUAL_MIN, name
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=SCALE_RTOL, err_msg=name)


def test_layer_config_reaches_single_experts(tiny):
    ar = AutoRound((tiny["tp"], tiny["tcfg"]), scheme="W4A16G32", iters=0,
                   device="cpu",
                   layer_config={"blocks.0.experts.1.w2": "W2A16G64",
                                 "experts.3.w1": {"bits": 3}},
                   ignore_layers=["blocks.1.experts.0.w3"])
    plan = ar.layer_schemes
    assert plan["blocks.0.experts.1.w2"].bits == 2
    assert plan["blocks.1.experts.1.w2"].bits == 4
    assert plan["blocks.0.experts.3.w1"].bits == 3
    assert plan["blocks.1.experts.3.w1"].bits == 3
    assert "blocks.1.experts.0.w3" not in plan
    res = ar.quantize(tiny["ids"])
    assert res.layers["blocks.0.experts.1.w2"].scheme.group_size == 64
    assert res.params["blocks"][1]["experts"][0]["w3"] is \
        tiny["tp"]["blocks"][1]["experts"][0]["w3"]


@pytest.mark.parametrize("fmt", ["fake", "autoround"])
def test_export_bytes_equal_the_jax_package(rtn_pair, tmp_path, fmt):
    from autoround_tpu.export import save_quantized as j_save
    jres, _, ar = rtn_pair
    jd = j_save(jres, JTINY, str(tmp_path / "j"), fmt)
    td = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd, f), os.path.join(td, f),
                           shallow=False), f
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))


# ------------------------------------------------------------------- engine

def _serving_pair(num_layers, num_experts, top_k, layer_config=None):
    """A packable MoE (K % 1024 == 0 for the JAX engine's layout), RTN
    W4A16 g128 in both packages."""
    jcfg = jm.MixtralConfig(
        vocab_size=128, hidden_size=1024, intermediate_size=1024,
        num_layers=num_layers, num_heads=4, num_kv_heads=2,
        num_experts=num_experts, top_k=top_k, rope_theta=1e4,
        dtype=jnp.float32)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg, tp = _to_port(jcfg, jp)
    ids = np.random.default_rng(1).integers(0, 128, (4, 8))
    kw = dict(scheme="W4A16", iters=0, layer_config=layer_config)
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
    tres = AutoRound((tp, tcfg), device="cpu", **kw).quantize(ids)
    return dict(jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres)


@pytest.fixture(scope="module")
def moe4():
    return _serving_pair(1, 4, 2)


def _prefill_and_decode(je, te, seed):
    """Prefill and one decode step in both engines; logits compared."""
    p = np.random.default_rng(seed).integers(0, 128, (2, 8))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jlog2, _ = je.decode_step(jnp.asarray(tok), jc)
    tlog2, tc2 = te.decode_step(torch.from_numpy(tok), tc)
    _close(jlog2, tlog2, LOGIT_TOL)
    assert tc2.length == 9
    return tlog, tlog2


def test_experts_stack_and_serve_like_jax(moe4):
    je = JQuantizedLlama.from_quantize_result(moe4["jres"], moe4["jcfg"],
                                              max_seq=32)
    te = QuantizedLlama.from_quantize_result(moe4["tres"], moe4["tcfg"],
                                             max_seq=32, device="cpu")
    stacked = sorted(k for k in te.packed if "experts_stack" in k)
    assert stacked == [f"blocks.0.experts_stack.w{i}" for i in (1, 2, 3)]
    assert stacked == sorted(k for k in je.packed if "experts_stack" in k)
    assert not any(".experts." in k for k in te.packed)
    assert sorted(te.packed) == stacked + ["blocks.0.o_proj", "blocks.0.qkv"]
    for k in stacked:
        assert te.packed_kinds[k] == je.packed_kinds[k] == "w4a16_grouped"
        jqw, jsc = je.packed[k]
        tqw, tsc = te.packed[k]
        assert tqw.shape == (4, 1024, 128) and tsc.shape == (4, 1024, 8)
        for e in range(4):
            np.testing.assert_array_equal(
                np.asarray(unpack_w4_planes(jqw[e], 128)),
                unpack_w4(tqw[e]).numpy())
        np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy())
    # packed experts carry no dense copy; the router stays dense
    blk = te.params["blocks"][0]
    assert all(w is None for e in blk["experts"] for w in e.values())
    assert blk["router"].shape == (4, 1024)
    _prefill_and_decode(je, te, 2)


def test_capacity_factor_through_the_grouped_route(moe4, monkeypatch):
    """``moe_capacity_factor = E / top_k``: C = N, nothing drops, the
    logits are the default route's; the JAX engine takes the same factor
    from its environment setting."""
    te0 = QuantizedLlama.from_quantize_result(moe4["tres"], moe4["tcfg"],
                                              max_seq=32, device="cpu")
    te = QuantizedLlama.from_quantize_result(
        moe4["tres"], moe4["tcfg"], max_seq=32, device="cpu",
        moe_capacity_factor=2.0)
    assert te0.moe_capacity_factor == 0.0 and te.moe_capacity_factor == 2.0
    monkeypatch.setattr(jenvs, "AR_MOE_CAPACITY_FACTOR", 2.0)
    je = JQuantizedLlama.from_quantize_result(moe4["jres"], moe4["jcfg"],
                                              max_seq=32)
    tlog, tlog2 = _prefill_and_decode(je, te, 3)
    p = np.random.default_rng(3).integers(0, 128, (2, 8))
    base, cache = te0.prefill(p)
    torch.testing.assert_close(tlog, base, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    base2, _ = te0.decode_step(base.argmax(-1).to(torch.int32), cache)
    torch.testing.assert_close(tlog2, base2, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # a factor that drops slots serves too, with other logits
    tight = QuantizedLlama.from_quantize_result(
        moe4["tres"], moe4["tcfg"], max_seq=32, device="cpu",
        moe_capacity_factor=0.5)
    dropped, _ = tight.prefill(p)
    assert torch.isfinite(dropped).all()
    assert (dropped - base).abs().max() > LOGIT_TOL


def test_partially_stackable_block_serves_per_expert():
    """One expert of block 0 gets another scheme: that block must not
    stack (all of w1/w2/w3 or none) and serves its experts one by one
    through the ungrouped kernel; block 1 stacks."""
    pair = _serving_pair(2, 2, 1,
                         layer_config={"blocks.0.experts.1.w2": {"group_size": 256}})
    je = JQuantizedLlama.from_quantize_result(pair["jres"], pair["jcfg"],
                                              max_seq=32)
    te = QuantizedLlama.from_quantize_result(pair["tres"], pair["tcfg"],
                                             max_seq=32, device="cpu")
    per_expert = sorted(f"blocks.0.experts.{e}.w{i}" for e in range(2)
                        for i in (1, 2, 3))
    assert sorted(k for k in te.packed if ".experts." in k) == per_expert
    assert sorted(k for k in te.packed if "experts_stack" in k) == [
        f"blocks.1.experts_stack.w{i}" for i in (1, 2, 3)]
    assert te.packed["blocks.0.experts.1.w2"][1].shape == (1024, 4)
    assert all(te.packed_kinds[k] == "w4a16" for k in per_expert)
    _prefill_and_decode(je, te, 4)
    # greedy tokens equal model_fwd's on the baked qdq params
    prompt = torch.tensor([[3, 5, 7]])
    toks = te.generate(prompt, max_new_tokens=4)[0]
    seq = prompt
    for i in range(4):
        nxt = tm.model_fwd(pair["tres"].params, seq, pair["tcfg"])[:, -1] \
            .argmax(-1)
        assert int(nxt) == int(toks[i]), i
        seq = torch.cat([seq, nxt[:, None]], dim=1)
