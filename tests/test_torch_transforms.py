"""Port parity of the rotations and AWQ against the JAX package: the
Hadamard matrix, R1 / R4 and the online R4 in the model and every serving
path, SpinQuant's trained R1 / R2, AWQ's smoothing and clip search, and
``enable_rotation`` as the API parses it.

``tiny`` (hidden 64, MLP 128) with its norm gains moved off 1; the engine
checks at hidden 1024 / MLP 1024 (W4A16 g128 packs there), fp32, CPU.
Tolerances:
  * ``hadamard_matrix``: bit-equal (the same numpy arithmetic and draw);
  * rotated weights: fp32 within 2e-6 of the largest, bf16 within one
    bf16 ulp (the products sum in other orders);
  * logits of the rotated FP model against the unrotated: the JAX tests'
    (R1 2e-3, R4 1e-4; ``tests/test_transforms.py``);
  * the online-R4 engine against the JAX engine: 1e-4, the engine tests'
    ``LOGIT_TOL``; greedy tokens equal up to the first near tie;
  * AWQ: every chosen α and every clip ratio equal; the tuned traces
    within 5e-6;
  * SpinQuant: the losses within 1e-5 step for step, the trained R within
    1e-5 (steps 1e-3: a sign-SGD step that went the other way would move
    an entry of A by 2e-3) and orthogonal to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import \
    ContinuousBatchingEngine as JContinuousBatchingEngine
from autoround_tpu.transforms import awq as jawq
from autoround_tpu.transforms import hadamard as jh
from autoround_tpu.transforms import spinquant as jsq
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models.registry import ALL_PRESETS
from autoround_tpu_torch.schemes import parse_scheme as t_parse
from autoround_tpu_torch.serve import ContinuousBatchingEngine
from autoround_tpu_torch.transforms import awq as tawq
from autoround_tpu_torch.transforms import hadamard as th
from autoround_tpu_torch.transforms import spinquant as tsq
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401
from test_torch_batching import GAP_TOL, SCHEDULE, _run_schedule

JCFG = jl.CONFIG_PRESETS["tiny"]
LOGIT_TOL = 1e-4
TRACE_RTOL = 5e-6


def _moved(jcfg):
    """JAX params with the norm gains moved off 1 (so the gain fusion
    counts) and the port's copy."""
    p = jl.init_params(jcfg, jax.random.PRNGKey(0))
    blocks = []
    for i, b in enumerate(p["blocks"]):
        b = dict(b)
        key = jax.random.PRNGKey(10 + i)
        for j, n in enumerate(("input_layernorm", "post_attention_layernorm")):
            b[n] = (1.0 + 0.1 * jax.random.normal(
                jax.random.fold_in(key, j), b[n].shape)).astype(b[n].dtype)
        blocks.append(b)
    p["blocks"] = blocks
    p["norm"] = (1.0 + 0.1 * jax.random.normal(
        jax.random.PRNGKey(99), p["norm"].shape)).astype(p["norm"].dtype)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    return p, tcfg, params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")


@pytest.fixture(scope="module")
def tiny():
    jp, tcfg, tp = _moved(JCFG)
    ids = np.random.default_rng(1).integers(0, JCFG.vocab_size, (8, 16))
    return jp, tcfg, tp, ids


def _close_tree(jtree, ttree, tol):
    for a, b in zip(jax.tree.leaves(jtree), _leaves(ttree)):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------- Hadamard

@pytest.mark.parametrize("n,seed", [(64, None), (96, None), (128, 3),
                                    (96, 0), (1024, 0)])
def test_hadamard_matrix_bit_equal(n, seed):
    a, b = jh.hadamard_matrix(n, seed), th.hadamard_matrix(n, seed)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(b @ b.T, np.eye(n), atol=1e-10)
    np.testing.assert_array_equal(np.asarray(jl._hadamard_block(64)),
                                  tl.hadamard_block(64, "cpu",
                                                    torch.float32).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r1_and_r4_rotated_weights_like_jax(tiny, dtype):
    jp, tcfg, tp, ids = tiny
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype))
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tcfg = config_from_jax(dataclasses.asdict(jcfg))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jr = jh.apply_r1_rotation(jp, jcfg, seed=0)
    tr = th.apply_r1_rotation(tp, tcfg, seed=0)
    j4, jc4 = jh.apply_r4_rotation(jp, jcfg, block=32)
    t4, tc4 = th.apply_r4_rotation(tp, tcfg, block=32)
    assert tc4.online_r4 and tc4.r4_block == 32
    assert config_from_jax(dataclasses.asdict(jc4)) == tc4
    for jt, tt in ((jr, tr), (j4, t4)):
        for a, b in zip(jax.tree.leaves(jt), _leaves(tt)):
            a = np.asarray(a.astype(jnp.float32))
            b = b.float().numpy()
            if dtype == "float32":
                assert np.abs(a - b).max() <= 2e-6 * np.abs(a).max()
            else:        # one bf16 ulp of the larger magnitude
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(a), np.abs(b)) + 1e-30)) - 7)
                assert (np.abs(a - b) <= ulp).all()


def test_rotations_preserve_the_fp_logits(tiny):
    jp, tcfg, tp, ids = tiny
    x = torch.as_tensor(ids[:2])
    with torch.no_grad():
        l0 = tl.model_fwd(tp, x, tcfg).numpy()
        l1 = tl.model_fwd(th.apply_r1_rotation(tp, tcfg, seed=0), x,
                          tcfg).numpy()
        p4, c4 = th.apply_r4_rotation(tp, tcfg, block=128)
        l4 = tl.model_fwd(p4, x, c4).numpy()
        fused = tl.model_fwd(th.fuse_rms_gains(tp, tcfg), x, tcfg).numpy()
    np.testing.assert_allclose(l1, l0, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(l4, l0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fused, l0, rtol=1e-4, atol=1e-4)
    # the model's online R4 equals the JAX model's on the same weights
    j4, jc4 = jh.apply_r4_rotation(jp, JCFG, block=128)
    want = np.asarray(jl.model_fwd(j4, jnp.asarray(ids[:2]), jc4))
    np.testing.assert_allclose(l4, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    y = tl.r4_rotate(torch.zeros(1, 1, 128).index_fill_(
        2, torch.tensor([7]), 100.0), 128)
    assert float(y.abs().max()) == pytest.approx(100.0 / np.sqrt(128),
                                                 rel=1e-5)


def test_non_llama_blocks_raise_naming_the_family():
    cfg = ALL_PRESETS["tiny-moe"]
    from autoround_tpu_torch.models.registry import get_model_fns
    p = get_model_fns(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
    for fn in (lambda: th.apply_r1_rotation(p, cfg),
               lambda: th.apply_r4_rotation(p, cfg),
               lambda: tsq.train_r1_rotation(p, cfg, t_parse("W4A16"))):
        with pytest.raises(NotImplementedError, match="MixtralConfig"):
            fn()


# ------------------------------------------------------- the online engine

ECFG = dataclasses.replace(JCFG, hidden_size=1024, intermediate_size=1024)


@pytest.fixture(scope="module")
def r4_engines():
    """W4A16 RTN of the R1 + R4 rotated model (the JAX package's rotated
    weights on both sides, so the engines read the same codes), both
    engines."""
    jp = jl.init_params(ECFG, jax.random.PRNGKey(0))
    jp, jcfg = jh.apply_r4_rotation(jh.apply_r1_rotation(jp, ECFG, seed=42),
                                    ECFG)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    assert tcfg.online_r4
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ids = np.random.default_rng(2).integers(0, 256, (2, 16))
    jar = JAutoRound((jp, jcfg), scheme="W4A16", iters=0)
    jres = jar.quantize(jnp.asarray(ids))
    ar = AutoRound((tp, tcfg), scheme="W4A16", iters=0, device="cpu")
    tres = ar.quantize(ids)
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(tres.layers[name].qdq.numpy(),
                                      np.asarray(jq.qdq), err_msg=name)
    je = JQuantizedLlama.from_quantize_result(jres, jar.model_cfg,
                                              max_seq=64)
    te = QuantizedLlama.from_quantize_result(tres, ar.model_cfg, max_seq=64,
                                             device="cpu")
    return je, te, ids, (jar, jres, ar, tres)


def test_online_r4_prefill_and_decode_like_the_jax_engine(r4_engines):
    je, te, ids, _ = r4_engines
    assert te.packed_kinds["blocks.0.down_proj"] == "w4a16"
    logits, cache = je.prefill(jnp.asarray(ids))
    tlog, tcache = te.prefill(ids)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(logits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    toks = []
    for step in range(3):
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
        toks.append(tok)
        logits, cache = je.decode_step(jnp.asarray(tok), cache)
        tlog, tcache = te.decode_step(torch.from_numpy(tok), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(logits),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # generate_scan (the CUDA graph's loop on the card) equals generate
    # and the JAX engine's generate_scan
    got = te.generate_scan(ids, max_new_tokens=4).numpy()
    assert (got == te.generate(ids, max_new_tokens=4).numpy()).all()
    want = np.asarray(je.generate_scan(jnp.asarray(ids), max_new_tokens=4))
    assert (got[:, :3] == want[:, :3]).all()


def test_online_r4_batcher_like_the_jax_batcher(r4_engines):
    je, te, _, _ = r4_engines
    kw = dict(max_batch=2, max_seq=64, prompt_buckets=(8, 16))
    want, _ = _run_schedule(JContinuousBatchingEngine(je, **kw))
    got, _ = _run_schedule(ContinuousBatchingEngine(te, **kw))
    for (_, prompt, n), w, g in zip(SCHEDULE, want, got):
        assert len(g) == n
        logits, cache = je.prefill(jnp.asarray([prompt]))
        gaps = []
        for step in range(n):
            lg = np.sort(np.asarray(logits, np.float32)[0])
            gaps.append(lg[-1] - lg[-2])
            if step < n - 1:
                logits, cache = je.decode_step(
                    jnp.asarray([w[step]], jnp.int32), cache)
        first_close = next((i for i, gap in enumerate(gaps)
                            if gap < GAP_TOL), n)
        assert g[:first_close] == w[:first_close]


def test_online_r4_export_loads_through_from_pretrained(r4_engines,
                                                       tmp_path):
    """The JAX package's autoround export of the rotated result carries
    ``online_r4`` / ``r4_block`` in its model_config; ``from_pretrained``
    reads it into an engine that serves as the in-memory one."""
    from autoround_tpu.export import save_quantized as j_save
    _, te, ids, (jar, jres, ar, tres) = r4_engines
    j_save(jres, jar.model_cfg, str(tmp_path), format="autoround")
    loaded = QuantizedLlama.from_pretrained(str(tmp_path), max_seq=64,
                                            device="cpu")
    assert loaded.cfg.online_r4 and loaded.cfg.r4_block == 128
    want, _ = te.prefill(ids)
    got, _ = loaded.prefill(ids)
    # the files store fp16 scales: the loaded engine reads those
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


# --------------------------------------------------------------------- AWQ

def _fwds(tcfg, S=8):
    jc, js = jl.rope_tables(JCFG, S)
    tc, ts = tl.rope_tables(tcfg, S, device="cpu")

    def jf(w, xx, linear_fn=None):
        return jl.block_fwd(w, xx, jc, js, JCFG, linear_fn=linear_fn)

    def tf(w, xx, linear_fn=None):
        return tl.block_fwd(w, xx, tc, ts, tcfg, linear_fn=linear_fn)
    return jf, tf


def test_awq_alphas_and_clip_search_like_jax(tiny):
    """The smoothing's chosen α and smoothed block, and the clip search's
    ratios, at 2 and 4 bits.  Both schemes group by 32 (the 2-bit one was
    W2A16G64): the JAX side, op by op, then compiles its grouped ops for
    one group shape, not two; the bit widths still differ."""
    jp, tcfg, tp, _ = tiny
    x = np.array(jax.random.normal(jax.random.PRNGKey(3),
                                   (4, 8, JCFG.hidden_size)))
    x[..., 0] *= 30.0                       # an outlier channel
    jf, tf = _fwds(tcfg)
    names = jl.block_linear_names(JCFG)
    for scheme in ({"bits": 2, "group_size": 32}, "W4A16G32"):
        js = {n: j_parse(scheme) for n in names}
        ts = {n: t_parse(scheme) for n in names}
        jb, jalpha = jawq.awq_smooth_block(jp["blocks"][0], jf,
                                           jnp.asarray(x), js)
        tb, talpha = tawq.awq_smooth_block(tp["blocks"][0], tf,
                                           torch.from_numpy(x), ts)
        assert talpha == jalpha
        _close_tree(jb, tb, 2e-6)
        rng = np.random.default_rng(4)
        im = {n: rng.random(jb[n].shape[1]).astype(np.float32)
              for n in names}
        jr = jawq.awq_clip_search(jb, js, {k: jnp.asarray(v)
                                           for k, v in im.items()})
        tr = tawq.awq_clip_search(
            {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
             jb.items()}, ts, {k: torch.from_numpy(v) for k, v in
                               im.items()})
        for n in names:
            np.testing.assert_array_equal(tr[n].numpy(), np.asarray(jr[n]),
                                          err_msg=n)


def test_awq_tuned_like_jax_and_nblocks_refused(tiny):
    jp, tcfg, tp, ids = tiny
    kw = dict(scheme="W4A16G32", iters=4, batch_size=4, seed=0,
              enable_awq=True)
    jres = JAutoRound((jp, JCFG), **kw).quantize(jnp.asarray(ids))
    tres = AutoRound((tp, tcfg), device="cpu", **kw).quantize(ids)
    for bi, jt in jres.loss_traces.items():
        np.testing.assert_allclose(tres.loss_traces[bi], np.asarray(jt),
                                   rtol=TRACE_RTOL)
    # the smoothed norm gains are the result's
    np.testing.assert_allclose(
        tres.params["blocks"][0]["input_layernorm"].numpy(),
        np.asarray(jres.params["blocks"][0]["input_layernorm"]), rtol=2e-6)
    with pytest.raises(ValueError, match="enable_awq"):
        JAutoRound((jp, JCFG), nblocks=2, **kw).quantize(jnp.asarray(ids))
    with pytest.raises(ValueError, match="enable_awq"):
        AutoRound((tp, tcfg), device="cpu", nblocks=2, **kw).quantize(ids)


# --------------------------------------------------------------- SpinQuant

@pytest.mark.parametrize("objective", ["weights", "block_output"])
def test_spinquant_r1_like_jax(tiny, objective):
    jp, tcfg, tp, ids = tiny
    sq = dict(steps=4, max_blocks=1)
    calib = None
    if objective == "block_output":
        calib = np.asarray(jl.embed_fwd(jp, jnp.asarray(ids[:2]), JCFG))
    jR = jsq.train_r1_rotation(
        jp, JCFG, j_parse("W4A16G32"), jsq.SpinQuantConfig(**sq), seed=0,
        calib_x=None if calib is None else jnp.asarray(calib))
    tR = tsq.train_r1_rotation(
        tp, tcfg, t_parse("W4A16G32"), tsq.SpinQuantConfig(**sq), seed=0,
        calib_x=None if calib is None else torch.from_numpy(calib))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose((tR @ tR.t()).numpy(),
                               np.eye(JCFG.hidden_size), atol=1e-5)
    x = torch.as_tensor(ids[:2])
    with torch.no_grad():
        l0 = tl.model_fwd(tp, x, tcfg).numpy()
        l1 = tl.model_fwd(tsq.apply_trained_rotation(tp, tcfg, tR), x,
                          tcfg).numpy()
    np.testing.assert_allclose(l1, l0, rtol=2e-3, atol=2e-3)


def test_spinquant_r2_like_jax(tiny):
    jp, tcfg, tp, ids = tiny
    sq = dict(steps=4)
    jR2 = jsq.train_r2_rotations(jp, JCFG, j_parse("W4A16G32"),
                                 jsq.SpinQuantConfig(**sq), seed=0)
    tR2 = tsq.train_r2_rotations(tp, tcfg, t_parse("W4A16G32"),
                                 tsq.SpinQuantConfig(**sq), seed=0)
    np.testing.assert_allclose(tR2.numpy(), np.asarray(jR2), atol=1e-5)
    eye = np.broadcast_to(np.eye(tcfg.hd), tR2.shape)
    np.testing.assert_allclose((tR2 @ tR2.transpose(1, 2)).numpy(), eye,
                               atol=1e-5)
    jb = jsq.apply_trained_r2(jp, JCFG, jR2)
    tb = tsq.apply_trained_r2(tp, tcfg, tR2)
    _close_tree(jb["blocks"], tb["blocks"], 2e-5)
    x = torch.as_tensor(ids[:2])
    with torch.no_grad():
        np.testing.assert_allclose(tl.model_fwd(tb, x, tcfg).numpy(),
                                   tl.model_fwd(tp, x, tcfg).numpy(),
                                   rtol=2e-3, atol=2e-3)


# ------------------------------------------------------ the API's parsing

@pytest.mark.parametrize("mode", [True, "r1", "r1,r4", "spin", "r2",
                                  "spin,r2,r4"])
def test_enable_rotation_modes_like_jax(tiny, mode):
    """Each mode rotates as the JAX API does (SpinQuant at its default
    steps), the config's online R4 included."""
    jp, tcfg, tp, ids = tiny
    jar = JAutoRound((jp, JCFG), scheme="W4A16G32", iters=0,
                     enable_rotation=mode)
    ar = AutoRound((tp, tcfg), scheme="W4A16G32", iters=0,
                   enable_rotation=mode, device="cpu")
    assert ar.model_cfg.online_r4 == jar.model_cfg.online_r4 == (
        "r4" in str(mode))
    tol = 1e-3 if ("spin" in str(mode) or "r2" in str(mode)) else 2e-6
    _close_tree(jar.params, ar.params, tol)


def test_enable_rotation_refusals_like_jax(tiny):
    jp, tcfg, tp, _ = tiny
    for mode, match in (("r1,spin", "pick one"), ("r9", "unknown rotation")):
        with pytest.raises(ValueError, match=match):
            JAutoRound((jp, JCFG), iters=0, enable_rotation=mode)
        with pytest.raises(ValueError, match=match):
            AutoRound((tp, tcfg), iters=0, enable_rotation=mode,
                      device="cpu")
