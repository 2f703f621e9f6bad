"""Port parity for the engine's decode loop: the per-slot decode block, the
fp8 KV cache through ``generate_scan``, and ``generate_scan`` itself,
against the JAX package on the same weights.

``generate_scan`` on a CPU engine runs the same static-buffer step that the
card captures as a CUDA graph, eagerly; ``tests/test_torch_cuda.py`` holds
the replayed graph against ``generate`` on the card.

Tolerances (fp32 throughout, as in ``tests/test_torch_engine.py``):
  * the per-slot block's outputs and the dense cache entries it writes:
    the same fp32 products summed in other orders, ~1e-6 of their O(1)
    size; 1e-4 (``LOGIT_TOL``) leaves margin;
  * int8 cache entries: a code may differ by one where x / scale lies
    within rounding noise of a .5 boundary — at most 1 in 10^4 entries of
    the cache, never by more; the int8 block's outputs within 1e-3
    (``INT8_LOGIT_TOL``);
  * tokens: the port's ``generate_scan`` equals the port's ``generate``
    exactly (same ops in the same order on the same data); against the
    JAX package, equal up to the first step whose JAX top-2 logit gap is
    below ``GAP_TOL`` (either choice is within the logit tolerance there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.engine import _block_with_cache as j_block
from autoround_tpu.serve.engine import _kv_quantize as j_kv_quantize
from autoround_tpu_torch import AutoRound, QuantizedLlama, SamplingParams
from autoround_tpu_torch.serve.engine import _block_with_cache as t_block
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
# the pair / engines fixtures are shared with test_torch_engine
from test_torch_engine import (GAP_TOL, INT8_LOGIT_TOL, LOGIT_TOL,  # noqa
                               MAX_SEQ, SEQ, engines, pair)
from _port_threads import one_torch_thread  # noqa: F401


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=tol, atol=tol)


def _jax_greedy(je, prompts, n_new):
    """JAX greedy tokens (B, n_new) and each step's least top-2 gap."""
    logits, cache = je.prefill(jnp.asarray(prompts))
    toks, gaps = [], []
    for step in range(n_new):
        lg = np.asarray(logits, np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append((top2[:, 1] - top2[:, 0]).min())
        toks.append(lg.argmax(-1).astype(np.int32))
        if step < n_new - 1:
            logits, cache = je.decode_step(jnp.asarray(toks[-1]), cache)
    return np.stack(toks, axis=1), gaps


def _equal_until_close(want, got, gaps):
    first_close = next((i for i, g in enumerate(gaps) if g < GAP_TOL),
                       len(gaps))
    assert first_close >= 1, gaps
    np.testing.assert_array_equal(want[:, :first_close],
                                  got[:, :first_close])


# ------------------------------------------------------- per-slot decode

BLOCK_CFG = dict(vocab_size=128, hidden_size=256, intermediate_size=512,
                 num_layers=1, num_heads=4, num_kv_heads=2, head_dim=64,
                 rope_theta=1e4)
SLOT_POS = np.array([3, 11, 23], np.int32)     # distinct positions, T = 24
T_CACHE = 24


@pytest.fixture(scope="module")
def block():
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **BLOCK_CFG)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(3)
    B, H = len(SLOT_POS), jcfg.hidden_size
    shape = (B, T_CACHE, jcfg.num_kv_heads, jcfg.hd)
    return dict(
        jcfg=jcfg, tcfg=tcfg, jw=jp["blocks"][0], tw=tp["blocks"][0],
        x=rng.standard_normal((B, 1, H)).astype(np.float32),
        k=rng.standard_normal(shape).astype(np.float32),
        v=rng.standard_normal(shape).astype(np.float32),
        k8=rng.integers(-127, 128, shape).astype(np.int8),
        v8=rng.integers(-127, 128, shape).astype(np.int8),
        ks=rng.uniform(0.02, 0.05, (1, 1, shape[2], 1)).astype(np.float32),
        vs=rng.uniform(0.02, 0.05, (1, 1, shape[2], 1)).astype(np.float32))


def _j_lf(name, x, w, bias=None):
    y = jnp.einsum("...i,oi->...o", x, w)
    return y if bias is None else y + bias


def _t_lf(name, x, w, bias=None):
    y = torch.einsum("...i,oi->...o", x, w)
    return y if bias is None else y + bias


def _run_both(block, kv_j, kv_t):
    jcfg, tcfg = block["jcfg"], block["tcfg"]
    jcos, jsin = jl.rope_tables(jcfg, 1, positions=jnp.asarray(SLOT_POS))
    tcos, tsin = tl.rope_tables(tcfg, 1, positions=torch.from_numpy(SLOT_POS))
    jout, jk, jv = j_block(block["jw"], jnp.asarray(block["x"]),
                           jcos[:, None], jsin[:, None], jcfg, kv_j,
                           jnp.asarray(SLOT_POS), _j_lf)
    tout, _, _ = t_block(block["tw"], torch.from_numpy(block["x"]),
                         tcos[:, None], tsin[:, None], tcfg, kv_t,
                         torch.from_numpy(SLOT_POS), _t_lf, {}, {}, 0, {})
    return jout, jk, jv, tout


def test_per_slot_block_dense_cache(block):
    """Each slot writes its K/V at its own position and attends over [0,
    pos]: the JAX block with the same (B,) vector, the cache written as
    JAX's batcher writes it."""
    tk, tv = torch.from_numpy(block["k"].copy()), torch.from_numpy(
        block["v"].copy())
    jout, jk, jv, tout = _run_both(
        block, (jnp.asarray(block["k"]), jnp.asarray(block["v"])), (tk, tv))
    _close(jout, tout, LOGIT_TOL)
    bidx = np.arange(len(SLOT_POS))
    want_k = jnp.asarray(block["k"]).at[bidx, SLOT_POS].set(jk[:, 0])
    want_v = jnp.asarray(block["v"]).at[bidx, SLOT_POS].set(jv[:, 0])
    _close(want_k, tk, LOGIT_TOL)
    _close(want_v, tv, LOGIT_TOL)
    # nothing else in the cache moved
    mask = np.ones(tk.shape[:2], bool)
    mask[bidx, SLOT_POS] = False
    assert torch.equal(tk[torch.from_numpy(mask)],
                       torch.from_numpy(block["k"])[torch.from_numpy(mask)])


def test_per_slot_block_int8_cache(block):
    """The int8 branch: the quantized token written at each slot's
    position, then the decode kernel's plain version over [0, pos]."""
    ks, vs = jnp.asarray(block["ks"]), jnp.asarray(block["vs"])
    tk = torch.from_numpy(block["k8"].copy())
    tv = torch.from_numpy(block["v8"].copy())
    jout, jk, jv, tout = _run_both(
        block, ("int8_cache", jnp.asarray(block["k8"]),
                jnp.asarray(block["v8"]), ks, vs),
        ("int8_cache", tk, tv, torch.from_numpy(block["ks"]),
         torch.from_numpy(block["vs"])))
    _close(jout, tout, INT8_LOGIT_TOL)
    bidx = np.arange(len(SLOT_POS))
    for src, new, scale, got in ((block["k8"], jk, ks, tk),
                                 (block["v8"], jv, vs, tv)):
        want = np.asarray(jnp.asarray(src).at[bidx, SLOT_POS].set(
            j_kv_quantize(new, scale, "int8")[:, 0])).astype(np.int32)
        got = got.numpy().astype(np.int32)
        assert np.abs(want - got).max() <= 1
        assert (want != got).sum() <= want.size // 10_000


# -------------------------------------------------------- generate_scan

@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_generate_scan_greedy(pair, engines, kv_quant):
    je, te = engines(kv_quant)
    prompts = pair["prompts"]
    n_new = 6
    got = te.generate_scan(prompts, max_new_tokens=n_new).numpy()
    assert got.shape == (2, n_new) and got.dtype == np.int32
    np.testing.assert_array_equal(
        got, te.generate(prompts, max_new_tokens=n_new).numpy())
    want, gaps = _jax_greedy(je, prompts, n_new)
    _equal_until_close(want, got, gaps)
    assert te.captures == 0           # a CPU engine runs its step eagerly
    if kv_quant == "fp8":
        st = te._scan_states[2]
        assert st.cache.k.dtype == torch.float8_e4m3fn


def test_generate_scan_sampled_reuses_the_step(pair, engines):
    """Sampled decoding: with one seed the tokens equal ``generate``'s; a
    second call with new prompts and another seed runs the same step
    object (on the card: the same graph, ``captures`` unchanged)."""
    _, te = engines("int8")
    prompts = pair["prompts"]
    sp = SamplingParams(temperature=0.7, top_p=0.95, seed=5)
    got = te.generate_scan(prompts, max_new_tokens=5, sampling=sp)
    np.testing.assert_array_equal(
        got.numpy(), te.generate(prompts, max_new_tokens=5,
                                 sampling=sp).numpy())
    steps = dict(te._scan_steps)
    key = (2, "int8", (0.7, 0, 0.95), False)
    assert key in steps
    new = np.random.default_rng(9).integers(0, 256, (2, SEQ - 8))
    sp2 = dataclasses.replace(sp, seed=6)
    got2 = te.generate_scan(new, max_new_tokens=9, sampling=sp2)
    assert te._scan_steps[key] is steps[key] and len(te._scan_steps) == len(
        steps)
    np.testing.assert_array_equal(
        got2.numpy(), te.generate(new, max_new_tokens=9,
                                  sampling=sp2).numpy())
    assert te.captures == 0


def test_generate_scan_checks_the_length(engines):
    _, te = engines(None)
    ids = np.zeros((1, SEQ), np.int64)
    with pytest.raises(ValueError, match="max_seq"):
        te.generate_scan(ids, max_new_tokens=MAX_SEQ - SEQ + 2)
    assert te.generate_scan(ids, MAX_SEQ - SEQ + 1).shape == (
        1, MAX_SEQ - SEQ + 1)


def test_other_kv_quant_raises(pair):
    with pytest.raises(NotImplementedError, match="kv_quant='int4'"):
        QuantizedLlama.from_quantize_result(pair["tres"], pair["tcfg"],
                                            max_seq=MAX_SEQ, kv_quant="int4",
                                            device="cpu")


def test_generate_scan_matches_jax_generate_scan():
    """JAX's own ``generate_scan`` (one compiled on-device loop), on the
    ``tiny`` preset with the int8 cache, against the port's."""
    jcfg = jl.CONFIG_PRESETS["tiny"]
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(4)
    calib = rng.integers(0, jcfg.vocab_size, (2, 16))
    prompts = rng.integers(0, jcfg.vocab_size, (2, 12))
    jres = JAutoRound((jp, jcfg), scheme="W4A16", iters=0).quantize(
        jnp.asarray(calib))
    tres = AutoRound((tp, tcfg), scheme="W4A16", iters=0,
                     device="cpu").quantize(calib)
    je = JQuantizedLlama.from_quantize_result(jres, jcfg, max_seq=32,
                                              kv_quant="int8")
    te = QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=32,
                                             kv_quant="int8", device="cpu")
    n_new = 8
    jscan = np.asarray(je.generate_scan(jnp.asarray(prompts), n_new))
    want, gaps = _jax_greedy(je, prompts, n_new)
    np.testing.assert_array_equal(jscan, want)   # JAX's own pair agrees
    got = te.generate_scan(prompts, max_new_tokens=n_new).numpy()
    _equal_until_close(jscan, got, gaps)


# ------------------------------------------- launch counts under replay
#
# Under a replayed CUDA graph a wrapper's Python count moves by its
# increase over the capture times the replays; chip_smoke.py measures the
# replayed kernels with torch.profiler and holds them to those counts.
# These tests keep the two sides of that check whole on the CPU.

def test_every_wrapper_registers_its_count():
    import importlib
    import pkgutil

    import autoround_tpu_torch.ops as ops
    from autoround_tpu_torch.ops._build import COUNTED

    found = set()
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"autoround_tpu_torch.ops.{m.name}")
        found |= {id(f) for f in vars(mod).values()
                  if callable(f) and hasattr(f, "launches")}
    assert len({id(f) for f in COUNTED}) == len(COUNTED)
    assert found == {id(f) for f in COUNTED}


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replayed_kernels_map_to_wrappers():
    from autoround_tpu_torch.ops._build import COUNTED

    cs = _chip_smoke()
    names = {f.__name__ for f in COUNTED}
    assert set(cs.WRAPPER_KERNELS) <= names
    # every wrapper an engine's decode step can reach has a kernel table
    serving = {"w4a16_matmul", "w4a16_matmul_grouped", "w4a16_asym_matmul",
               "w8a16_matmul", "w2a16_matmul", "fp8_matmul", "mxfp4_matmul",
               "w4a8_matmul", "w8a8_matmul", "decode_attention"}
    assert serving <= set(cs.WRAPPER_KERNELS)
    key = cs._kernel_key
    assert key("void w4a16::gemv_kernel<4, 1>(__nv_bfloat16 const*, "
               "unsigned") == "w4a16<4>"
    assert key("void w4a16::gemm_kernel<0>(__nv_bfloat16 const*") == \
        "w4a16<0>"
    assert key("void a8::gemv_kernel<true, 2>(signed char") == "a8<w4>"
    assert key("void a8::gemv_kernel<false, 1>(signed char") == "a8<w8>"
    assert key("void a8::gemm_kernel<0>(signed char") == "a8<w8>"
    assert key("void a8::gemm_kernel<1>(signed char") == "a8<w4>"
    assert key("void a8::quantize_rows_kernel(__nv_bfloat16 const*") == \
        "quantize_rows"
    assert key("void (anonymous namespace)::split_kernel<128, 4>(") == \
        "decode split"
    assert key("void (anonymous namespace)::combine_kernel<64>(") == \
        "decode combine"
    assert key("void at::native::elementwise_kernel<128, 2>(") == "torch"


def test_busy_share_from_one_trace():
    """Kernel time is the union of the kernels' intervals, the span runs
    from the first start to the last end, both on the trace's clock."""
    import types

    from torch.autograd import DeviceType

    cs = _chip_smoke()

    def ev(a, b, dev=DeviceType.CUDA, name="k"):
        return types.SimpleNamespace(
            device_type=dev, name=name,
            time_range=types.SimpleNamespace(start=a, end=b))

    prof = types.SimpleNamespace(events=lambda: [
        ev(20, 30), ev(0, 10), ev(5, 15), ev(-50, 100, DeviceType.CPU),
        ev(40, 90, name="Command Buffer Full")])
    kernel_ms, span_ms = cs._trace_busy(prof)
    assert kernel_ms == pytest.approx(0.025)
    assert span_ms == pytest.approx(0.030)


def test_profile_counts_only_after_the_marker():
    """``profile_replays`` counts the kernels that start after its marker
    kernel (the warm-up replay before it may lose records), and a trace
    that lost the marker counts nothing."""
    import types

    from torch.autograd import DeviceType

    cs = _chip_smoke()

    def ev(a, b, name):
        return types.SimpleNamespace(
            device_type=DeviceType.CUDA, name=name,
            time_range=types.SimpleNamespace(start=a, end=b,
                                             elapsed_us=lambda: b - a))

    gemv = "void w4a16::gemv_kernel<0, 1>(__nv_bfloat16 const*)"
    events = [ev(0, 5, gemv),
              ev(6, 9, "void at::cuda::(anonymous namespace)::"
                       "spin_kernel(long)"),
              ev(10, 12, gemv), ev(13, 14, "split_kernel<128, 4>")]
    prof = types.SimpleNamespace(events=lambda: events)
    mark = cs._mark_end(prof)
    assert mark == 9
    times = cs._kernel_times(prof, after=mark)
    assert times == {gemv: (pytest.approx(0.002), 1),
                     "split_kernel<128, 4>": (pytest.approx(0.001), 1)}
    assert cs._trace_busy(prof, after=mark) == (pytest.approx(0.003),
                                                pytest.approx(0.004))
    assert cs._mark_end(types.SimpleNamespace(
        events=lambda: events[:1])) is None

