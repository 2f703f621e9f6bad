#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autoround_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 is
the target).  It needs no arguments and no network, and imports neither
JAX nor the JAX package.  Phases, each of which fails the run on error:

1. build   — compile the CUDA sources of ``autoround_tpu_torch/csrc`` (one
             nvcc per source, in parallel); print the seconds, the
             compiler's register / spill / warning lines by kernel, and the
             flash forward's, the backward pair's (dQ, dK/dV at D = 128
             and 256), the nine GEMM bodies', the seven A16 GEMVs' and
             the two int8 GEMVs' (per M tier, with their plans at the main
             path's shapes), the
             int8-QK attention's and its key pre-pass's, and the decode
             split and combine kernels' registers, spill bytes, dynamic
             shared memory and blocks per SM.
2. kernels — run each of the fourteen kernels (flash forward, flash
             backward dQ and dK/dV, W4A16 matmul, grouped W4A16 matmul, asym
             W4A16 matmul, int8-KV decode attention, W4A8, W8A8, W8A16, W2A16,
             FP8 and MXFP4 / NVFP4 matmul, int8-QK attention) at the
             main paths' shapes (flash also at D = 256 and at
             Qwen3-Next's 16 heads over 2 of D = 256, GLM-4.5-Air's
             96 over 8, MiniMax's 64 over 8 and ERNIE-4.5's 20 over 4
             (G = 5); W4A16 and asym
             also at g = 16, W4A16 also at Qwen3-Next's in_proj_qkvz,
             GLM-4.5-Air's q / k / v and o_proj and MiniMax's qkv_proj;
             grouped W4A16 also at E = 512, E = 128 and MiniMax's E = 32;
             decode
             also at head dims 64 and 256, G = 7, GLM-4.5-Air's G = 12
             and every G from 9 to 16; int8-QK at row 1's
             shapes and at S = T = 2048, beside row 1's time in the same
             call) against its plain PyTorch version on the
             card (bf16), check the stated tolerance (and, for the
             backward pair, that two launches give the same bits), and
             time kernel, plain version and one library call (a yardstick
             the port never calls) with CUDA events, the L2 cache flushed
             before every timed launch (median of several runs), beside
             the least time the card could take and the achieved rate.
             The decode and int8 kernels (split + combine, quantize_rows +
             product), the backward pair (each kernel, and the whole
             ``flash_attention_bwd``: delta + dQ + dK/dV, against SDPA's
             backward), the A16 GEMV at M = 8 (C = 8 grouped), the
             int8-QK attention (beside row 1 and SDPA) and their
             library calls also get ``device_ms``: the kernels' own time
             by torch.profiler.  The int8 kinds also
             check ``quantize_rows`` (codes and scales bit-equal, its own
             device time at M = 1, 8, 32) and say whether the fp32 result
             before the cast is bit-equal (it must be for W8A8, and for
             W4A8 in the GEMM body and where the GEMV's plan splits no
             K); the int8 GEMV runs at M = 1, 8 and 32, with the A16 GEMV
             on the same packed words beside W4A8 at M = 8.
3. rtn     — the RTN → serve path at the full width of ``llama3-8b``
             (random weights from a seeded generator, all 32 layers):
             ``AutoRound(scheme="W4A16", iters=0, quant_lm_head=True)`` on
             8 x 512 calibration ids → ``QuantizedLlama.from_quantize_
             result(max_seq=1024, kv_quant="int8")`` → ``generate`` for 8
             prompts of 512 tokens, 32 new tokens.  Kernel launch counts
             are zeroed just before and read just after; each must be > 0.
             Then prefill and decode steps are timed, and a 2-layer copy of
             the same engine runs once through the kernels and once through
             their plain versions, both on the card: step-1 logits must
             agree within the stated tolerance and greedy tokens must
             match.
             Every serving path below (and this one) then runs
             ``generate_scan`` on the same engine and prompts: its tokens
             must equal ``generate``'s and its launches ``generate``'s
             (the loops' counts), and its replayed step ms prints beside
             the eager step ms of the same call.
   scan    — on this engine (32 layers, int8 KV, ``max_seq`` 1024), 512-
             token prompts at batch 1, 8 and 32 (``bench.py``'s batch):
             ``generate_scan`` against ``generate``, the capture ms alone,
             the median replayed step ms (CUDA events between replays),
             tok/s, the step's bound, the busy share (torch.profiler's
             kernel time over replays against the unprofiled step) and the
             step's top kernels beside the eager step; at batch 8 a second
             call with new prompts must replay without a recapture, and
             sampled decoding (temperature 0.7, top-p 0.95) must give
             ``generate``'s tokens.  The same at batch 1 and 8 for W4A8,
             W8A8 and llama3.2-1b, and at batch 8 for mixtral-8x7b.
   fp8 kv  — the first 4 layers of this engine with ``kv_quant="fp8"``
             (e4m3 cache): ``generate_scan`` equal to ``generate``, and a
             2-layer copy on the card against the CPU (prefill and first
             decode step logits within the copy limit).
   batching — ``ContinuousBatchingEngine`` over this engine (max_batch 8,
             max_seq 1024): 12 requests, prompts of 16–256 tokens over the
             buckets, 8–32 new tokens, late joins and slot reuse; each
             request's prompt-pass and first decode step logits within
             the copy limit of the same prompt alone at batch 1; prints
             the share of greedy tokens equal to batch 1's and the
             replayed step ms at 8 active slots.
4. grads   — one full-width block, one batch of 8 x 512: the gradients of
             the tuning loss w.r.t. ``v``, ``min_scale``, ``max_scale``
             through the flash kernels (forward and backward) against the
             same through the plain attention under autograd, on the card;
             then the time of a tuning step, its bound and its profile.
5. tune    — the SignRound → serve path at the full width of
             ``llama3-8b``: ``AutoRound(scheme="W4A16", iters=20,
             batch_size=8, quant_lm_head=True)`` on 16 x 512 calibration
             ids, every block and the lm_head tuned → the same engine →
             ``generate``.  All five kernels' counts are zeroed just
             before and read just after; each must equal what the loop
             implies.  Every loss must be finite and no block's best loss
             above its first.
6. moe     — the MoE path at the full width of ``mixtral-8x7b`` (8 experts
             of 4096 x 14336, top-2; random weights from a seeded
             generator; ``--moe-layers`` of the 32 blocks, because 32
             blocks in bf16 are more than the card holds): RTN W4A16 g128
             → ``from_quantize_result`` (experts stacked) → ``generate``
             for 8 prompts of 512 tokens, 32 new tokens, int8 KV,
             dense-then-mask routing; launch counts must equal what the
             loops imply (grouped kernel: 3 per block per forward).  Then
             the same engine with ``moe_capacity_factor = E / top_k``
             (nothing can drop): its prefill logits must agree with the
             default route's.  Then timings, a profile, and a 2-layer copy
             run once through the kernels and once through their plain
             versions, both on the card.
7. moe tune — one tuning step of one full-width Mixtral block timed and
             profiled, then SignRound (``iters=20``) on ``--moe-tune-layers``
             full-width blocks (dense-then-mask: every expert sees every
             token) → the same engine → ``generate``; every tuned block's
             best loss must be below its first.
8. asym    — ``llama3-8b`` width, ``--asym-layers`` layers, int4 asym g128
             RTN → the ``w4a16_asym`` engine → ``generate``; launch counts
             checked; 2-layer copy against the plain versions.
9. a8      — the int8 serving kinds at ``llama3-8b`` width, each RTN
             (``quant_lm_head=True``, 8 x 512 calibration ids) → engine →
             ``generate`` (8 x 512 prompts, 32 new tokens, int8 KV):
             ``W4A8`` (``--a8-layers``), ``W8A8`` (``--w8a8-layers``),
             ``W8A16`` (``--w8a16-layers``); every packed kind checked,
             launch counts equal to what the loops imply, the W4A16
             kernels at 0, timings with bounds at the int8 peak, 2-layer
             copy against the plain versions.
10. a8 modes — a W4A16 result (``--a8-modes-layers``) served with
             ``serve_a8=True`` (kinds ``w4a8`` on the same packed words)
             and with ``prefill_a8=True`` (W4A8 kernel in the prompt pass,
             W4A16 kernel in decode): prefill logits against exact-A16
             serving.
11. a8 tune — SignRound (``iters=20``) with ``W4A8`` on ``--a8-tune-layers``
             blocks, once with dynamic activations and once with static
             int8 activations and act-scale tuning → serve.
12. float  — the float and 2-bit serving kinds at ``llama3-8b`` width, each
             RTN (``quant_lm_head=True``; the scheme's activation
             quantization in calibration) → engine (weight-only, bf16
             activations) → ``generate``: ``FP8_STATIC`` (kind ``fp8``,
             ``--fp8-layers``), ``MXFP4`` (``mxfp4_g32``,
             ``--mxfp4-layers``), ``NVFP4`` (``mxfp4_g16``,
             ``--nvfp4-layers``), ``W2A16`` (``w2a16``, ``--w2-layers``);
             launch counts, timings, 2-layer copy against the plain
             versions.
13. mx tune — SignRound (``iters=20``) with ``MXFP4`` (MX activations in the
             loss) on ``--mx-tune-layers`` blocks → serve, timed, with a
             2-layer copy against the plain versions.
             The MXFP4 path's peak memory (quantize, pack, generate) must
             not pass the FP8 path's.
14. llama3.2-1b — full width, ``--llama1b-layers`` of 16 (head dim 64,
             tied embeddings): RTN W4A16 g128 → engine → ``generate`` with the
             int8 KV cache, every decode step through the decode kernel at
             hd 64 (launches = layers x steps); then the same at g = 16,
             where no layer may serve dense; timings and a 2-layer copy
             against the plain versions for each.
15. sage    — the int8-QK op through its entry point for the prefill
             attention of ``--sage-layers`` llama3-8b layers; launch count
             checked, each output within 5e-3 mean |diff| of the flash
             kernel (the op rides no engine path, as in the JAX package).
16. family  — the Llama-family flags at full width (random weights, every
             norm gain and bias moved off its initial value; W4A16 g128,
             lm_head quantized, int8 KV, 32 new tokens, greedy):
             ``qwen2.5-7b`` RTN at ``--qwen25-layers`` of 28 (8 x 512
             prompts: q/k/v biases, G = 7 through flash and decode;
             timed, and its
             replayed step measured at batch 1 and 8), ``qwen3-4b``
             SignRound (``iters=20``, 16 x 512 ids) on 2 blocks (qk-norm
             inside the tuning loss through flash forward and backward),
             ``gemma2-2b`` RTN at 4 layers (8 x 512: attention and final
             softcaps, GeGLU, sandwich norms, hd 256) and ``gemma3-12b``
             RTN at 6 layers, five sliding and one global (2 x 1280
             prompts, ``max_seq`` 2048: the 1024 window bites at prefill
             and at every decode step; local and global rope).  Each
             checks its launch counts against its loops, runs the 2-layer
             copy against the plain versions on the card and
             ``generate_scan`` against ``generate``.
17. load    — loading and user entry, everything written to one
             temporary directory that the phase removes (it prints the
             bytes and seconds of each write and load).  (a) llama3-8b at
             full width, ``--load-layers`` layers, Llama-3.1 rope scaling,
             random bf16 weights with every norm gain moved: written with
             ``save_hf_checkpoint``, read back with ``load_hf_checkpoint``
             (leaves bit-equal; GB/s beside a plain read of the file and
             one ``.to("cuda")`` of its bytes), then ``python -m
             autoround_tpu_torch --model <dir> --scheme W4A16 --iters 0
             --quant-lm-head --dataset <ids.npy> --format autoround`` in a
             subprocess on the card, whose every file must equal an
             in-process ``AutoRound(load_hf_checkpoint(dir))`` RTN +
             ``save_quantized`` byte for byte (the export's two files; the
             CLI may save a tokenizer beside them); ``from_pretrained`` of
             the export packs all 7 x L + 1 layers (words bit-equal to the
             in-memory engine's, scales its fp16 scales), prefill and
             first-step logits within the copy limit of the in-memory
             engine with its scales rounded to fp16 (what the files store;
             the distance to its fp32 scales printed), launches equal to
             the loops', ``generate_scan``
             equal to ``generate``, the replayed step at batch 8 in turns
             with the in-memory engine's, beside its bound, and the 2-layer
             copy against the plain versions on the card (the rtn path
             holds the kernels against the CPU's).  (b)
             phase 14's llama3.2-1b g128 result (tied) exported
             and served the same way.  (c) the results of (a), W4A16 and
             W4A16 asym, packed by ``gptq_pack_layer`` / ``awq_pack_layer``
             into HF-layout directories: ``from_gptq`` on row 4,
             ``from_awq`` on row 9 (row 4 at 0), and a GPTQ copy whose
             block-0 ``o_proj`` is act-order, which must serve dense and
             say so in the log.  The engines of (b) and (c) each hold a
             2-layer copy against the plain versions on the card.
18. options — the SignRound and driver options at full width, each
             SignRound with iters=20 on 16 x 512 ids at batch 8, every loss
             trace finite with its best at or below its first, the tuned
             clip scales inside their clamp, then served (launches equal to
             the loops', ``generate_scan`` equal to ``generate``, a 2-layer
             copy against the plain versions on the card): alg_ext on
             llama3-8b x ``--options-layers`` at W2A16 with ``use_remat``
             (the outlier mask over 2^24 elements a batch; some clip scale
             above 1; served through row 10) beside the same run without
             it; AdamRound with norm / bias tuning and gradient
             accumulation on qwen2.5-7b (its gains and biases moved; the
             engine must serve each tuned leaf as the bake of its offset);
             nblocks = 2 on llama3-8b x ``--nblocks-layers`` with
             ``dynamic_max_gap`` and ``immediate_save_dir`` (one trace per
             group; the streamed shards load through ``from_pretrained``
             with words bit-equal to the ``from_quantize_result`` engine's);
             and ``enable_lfq`` (the last block's loss the LM cross-entropy
             over the 128256-entry vocabulary, near ln 128256).
19. offload — mixtral-8x7b at ``--offload-layers`` (8 by default; cut to
             what the host's MemAvailable holds, failing where it holds
             fewer than asked or 28): the blocks made on the card
             one at a time and parked in host memory (pinned where the host
             allows), ``W4A16_MIXED`` with the lm_head, RTN,
             ``offload_params`` and ``donate_params``; the device peaks
             while quantizing and packing, the process's peak RSS and the
             host <-> card rates printed; the first two blocks bit-equal to
             an on-device RTN of the same blocks; the host-resident result
             packed (experts through row 5, attention and the lm_head
             through row 11, row 4 at 0) and served, its replayed step at
             batch 8 beside its bound, a 2-layer copy on the card.
20. deepseek — the DeepSeek family (MLA with its latent cache, DeepSeek-MoE
             routing; attention is plain PyTorch, as in the JAX package):
             row 5 against its plain version at E = 64 / 256, O or K =
             1408 and K = 7168; (a) deepseek-v2-lite at full width and
             ``--deepseek-layers`` of 27 (random weights, gains moved):
             RTN W4A16 g128 with the lm_head → engine (int8 latent cache,
             ``max_seq`` 1024, experts stacked) → ``generate`` for 8 x 512
             prompts, 32 new tokens, rows 4 and 5 launched as the loops
             imply; timings beside bounds; a 2-layer copy (dense + MoE) on
             the plain versions; ``generate_scan`` against ``generate``;
             the replayed step at batch 8 and 1 (profiled: busy share and
             launches measured per replay); the fp8 latent cache on 4
             layers against the bf16 one; the batcher at 8 slots against
             each request alone.  (b) SignRound (iters 10, 16 x 512 ids) on
             2 V2-Lite blocks (dense + MoE) → serve.  (c) deepseek-v3 at
             full width, ``--deepseek-v3-layers`` of 61 (256 experts, the
             sigmoid router's bias from N(0, 0.5), groups 8 / 4): RTN →
             serve 2 x 128 prompts, a copy of the last dense and first MoE
             block on the plain versions, the replayed step at batch 8.
             (d) V2-Lite x 2 as an HF ``deepseek_v2`` directory → the CLI
             (in process)
             → ``from_pretrained`` against the in-memory engine.
21. gpt-oss / llama4 — GPT-OSS and Llama 4 (random weights moved off their
             initial values: gains, attention and expert biases, the sinks
             from N(0, 1), the router bias).  (a) gpt-oss-20b at full
             width, ``--gptoss-layers`` of 24 (4 by default): RTN W4A16
             g32 (K = 2880 is
             22.5 x 128) with the lm_head → engine (int8 KV: row 6 with the
             sinks and the 128 window on the even layers; experts stacked
             for row 5) → ``generate`` 8 x 512, 32 new, launches as the
             loops imply; timings beside bounds; a 2-layer copy on the
             plain versions; ``generate_scan``; the replayed step at batch
             8 and 1; the fp8 cache on 4 layers; the batcher.  (b)
             gpt-oss-120b x ``--gptoss120-layers`` (row 5 at E = 128), the
             replayed step at batch 8.  (c) SignRound (iters 10) on 1
             gpt-oss-20b block.  (d) llama4-scout at full width,
             ``--llama4-layers`` of 48 (NoPE layers 3, 7, ...): RTN W4A16
             g128, served as (a) (rows 1, 4, 5, 6).  (e) its first 4 blocks
             past the 8192 chunk: one 8320-token prompt, 32 new tokens (row
             6 with ``chunk``), the prefill's device peak, a copy on the
             plain versions.  (f) SignRound (iters 10) on Scout's blocks
             2-3 (rows 1-3, both layer variants).  (g) each family x 1 as
             an HF directory
             with fused experts → the CLI (in process) →
             ``from_pretrained``.
22. qwen3-next — Qwen3-Next and Qwen3.5-MoE at the published widths of
             Qwen3-Next-80B-A3B (``QWEN3_NEXT_HF``: hidden 2048, 16 heads
             over 2 KV heads of 256, partial rotary 0.25; DeltaNet 16 k-
             and 32 v-heads of 128, conv 4; 512 experts of 512, top 10, a
             gated shared expert; one full layer in 4; random weights,
             gains moved).  (a) ``--qwen3next-layers`` of 48: RTN W4A16
             g128 with the lm_head → engine (the hybrid cache; experts
             stacked for row 5 at E = 512, q(+gate) / k / v fused for row
             4) → ``generate`` 8 x 512, 32 new, launches as the loops imply
             (row 1 at prefill on the full layers); timings beside bounds;
             prefill and 3 decode steps against ``model_fwd`` on the qdq
             weights; layer 0's state after the prompt against 512
             recurrent steps from zero; a 2-layer copy (a DeltaNet and a
             full layer) on the plain versions; ``generate_scan``; the
             replayed step at batch 8 and 1, each with a second call of
             new prompts.  (b) SignRound (iters 2, 2 x 512 a step) on
             the published layers 2-3 (a DeltaNet layer, the chunked delta
             rule's backward in its loss, and the first full layer, rows
             1-3 in its loss) → serve.  (c) a
             ``qwen3_5_moe`` HF directory x ``--qwen35-load-layers`` (fused
             expert stacks, an ``mtp.*`` tensor) → the CLI (in process) →
             ``from_pretrained``, logits equal to the in-memory engine's.
23. glm     — GLM-4.5-Air and GLM-5 DSA (random weights, gains, q / k / v
             biases and router biases moved).  (a) glm-4.5-air at full
             width (hidden 4096, 96 heads over 8 KV heads of 128: row 6 at
             G = 12; partial rotary 0.5, qk norm; a dense layer 0, then
             128 experts of 1408 under the DeepSeek router) x
             ``--glm45-layers`` of 46: RTN W4A16 g128 with the lm_head →
             the int8-KV engine (q / k / v fused with the biases after the
             product, experts stacked) → ``generate`` 8 x 512, 32 new,
             launches as the loops imply (rows 1, 4, 5, 6); each block
             teacher forced and the prefill against ``model_fwd`` on the
             qdq weights; a 2-layer copy on the plain versions;
             ``generate_scan``; the replayed step at batch 8 and 1; the
             fp8 cache; the batcher.  (b) SignRound (iters 2, 2 x 512) on
             blocks 0-1 (rows 1-3 at G = 12) → serve.  (c) a ``glm4_moe``
             HF directory x 2 → the CLI (in process) →
             ``from_pretrained``.  (d) GLM-5
             DSA at the deepseek-v3 widths with DeepSeek-V3.2's indexer
             (64 heads of 128, top 2048) x ``--glm5-layers`` of 61: RTN
             (the indexer's q / k quantized, ``weights_proj`` bf16); block
             0 at 1 x 4096 tokens, where the DSA mask bites, against an
             index top-k reference; the MLA engine with its dense-MLA
             warning, its logits and tokens equal to a DeepSeek engine's
             on the same weights; a 2-layer copy; ``generate_scan``; the
             replayed step at batch 8.  (e) a ``glm_moe_dsa`` HF
             directory x 2 → the CLI (in process) →
             ``from_pretrained``.
24. minimax — MiniMax-Text-01 at its published widths (``MINIMAX_HF``:
             hidden 6144, 64 heads over 8 KV heads of 128; lightning
             attention on 7 layers of 8, chunk 256; the residual alphas
             3.557; 32 experts of 9216, top 2; random weights, gains
             moved, each block's decay rates the published layer's).  (a)
             ``--minimax-layers`` of 80 from the published layer 4 on: the
             blocks made on the card and parked on the host, RTN W4A16
             g128 with the lm_head through ``offload_params`` and
             ``donate_params`` (device peak, process RSS) → engine (the
             hybrid cache: zero-width tails, fp32 (64, 128, 128) states;
             experts stacked for row 5 at E = 32, every projection on row
             4, the full layer's q / k / v fused) → ``generate`` 8 x 512,
             32 new, launches as the loops imply (row 1 at prefill on the
             full layer); timings beside bounds; each block teacher forced
             against ``block_fwd`` on the qdq weights; layer 0's state
             after the prompt against ``lightning_attention`` and 512
             steps; a 2-layer copy (lightning and full) on the plain
             versions; ``generate_scan``; the replayed step at batch 8 and
             1, each with a second call of new prompts.  (b) SignRound
             (iters 4, 2 x 512) on the published layers 6-7 with 8 of the
             32 experts (rows 1-3 in the loss) → serve.  (c) a ``minimax``
             HF directory x 2 (layers 6-7, 4 experts) → the CLI (in
             process) →
             ``from_pretrained``, logits equal to the in-memory engine's.
25. ernie / longcat / step35 — three families the port quantizes and
             exports and no engine serves (as in the JAX package), random
             weights, gains moved, router biases drawn.  (a)
             ERNIE-4.5-21B-A3B at full width (20 query heads over 4 KV
             heads of 128: G = 5), ``--ernie-layers`` of 28 (the dense
             layer 0, then 64 experts of 1536 and 2 shared): RTN W4A16
             g128 with the tied lm_head, launches as the chain implies,
             blocks 0-1 teacher forced on the qdq weights (kernels
             against the plain versions), an ``autoround`` export read
             back (``model_config`` through ``config_from_jax``, words /
             zeros / scales against the result); (b) SignRound (iters 4,
             2 x 512) on layers 0-1: rows 1-3 at G = 5 in the loss.  (c)
             LongCat-Flash at its published widths (``LONGCAT_FLASH``:
             hidden 6144, 512 experts of 2048 + 256 zero experts, 40 GB
             of bf16 a layer), ``--longcat-layers`` of 28 through
             ``offload_params`` and ``donate_params`` (device peak, RSS),
             block 0 on the qdq weights against the FP block's output
             (MLA keeps the plain attention: no kernel runs), and on W8
             g128 weights, the rounding's share of that distance; a copy
             with 8 of the 512 routed experts exported and read back.
             (d) Step-3.5-Flash at its published widths (``STEP35_HF``
             through ``config_from_hf``: full layers 64 / 8 heads,
             sliding 96 / 8 with a 512 window, 288 experts of 1280),
             ``--step35-layers`` of 45: RTN W4A16 g128 (row 1 at both
             head counts), every block teacher forced, export read back.
26. gguf / rotation — the GGUF data types and the rotations, at
             ``llama3-8b`` width unless named: (a) ``GGUF:Q4_K_M`` RTN with
             ``use_imatrix`` and the lm_head on ``--gguf-layers`` (the
             embedding's and the head's dq search on the card, its device
             peak printed; Q4_K layers through the asym kernel at g32 with
             the fractional zero point, Q6_K ones dense; the cascade's
             count follows the depth) → serve at batch 8; (b)
             ``GGUF:Q4_K_S`` SignRound with ``enable_alg_ext`` and
             ``use_imatrix`` on ``--gguf-tune-layers`` (the flash kernels
             in the loss; ``tune_s`` and the step ms); (c) ``GGUF:Q3_K_S``
             (W4A16 kernel, signed 3-bit codes at g16) and ``GGUF:Q2_K_S``
             (asym kernel at g16) on ``--gguf-small-layers``, 32 tokens
             each; (d) mixtral-8x7b ``GGUF:Q2_K_MIXED`` on
             ``--gguf-moe-layers`` (experts one by one through the asym
             kernel, the Q8_0 head through W8A16 at g32); (e) W4A16 g128
             with ``enable_rotation="r1,r4"`` and ``enable_awq`` on
             ``--rotation-layers`` (fp32 logits rotated vs not held, bf16
             printed; the online block Hadamard inside the captured step);
             (f) SpinQuant's trained R1 (3 steps) on the same depth.  Every
             engine runs ``generate``, a copy on the plain versions on the
             card and ``generate_scan``.
27. driver utilities / formats — at ``llama3-8b`` width: (a)
             ``AutoScheme(avg_bits=4.5, options=W2A16 / W4A16 / W8A16)``
             on ``--autoscheme-layers`` with 8 x 513 calibration tokens
             (the gradient pass through rows 1-3, its device peak, its
             scores against the same pass on the plain attention), the
             plan RTN'd and served (each kind through its kernel, a copy
             on the plain versions, ``generate_scan``), and a 3.0-bit plan
             from the cached scores with W2A16 layers through row 10; (b)
             SignRound on ``--resume-layers`` with ``AR_PROFILE_PHASES``,
             ``AR_TRACE_DIR`` and ``AR_LOG_MEMORY`` on, then on a resume
             directory stopped after block 1 and run again (the restored
             blocks equal to their payloads, the result to the
             uninterrupted run; the durable save's seconds and bytes); (c)
             ``model_free_quantize`` of a two-shard ``--model-free-layers``
             directory (each layer against the RTN of its tensor on the
             card) and of DeepSeek-V3's dense layer 0 at full width as an
             FP8 source with 128 x 128 scale grids, which
             ``load_hf_checkpoint`` reads too (the dequantized weights
             against the host product); (d) the ``gptq``, ``awq``,
             ``llm_compressor`` and ``mlx`` writers on a
             ``--writers-layers`` RTN result with the head, every layer
             read back and unpacked on the card.
28. report — the card's name and power limit (nvidia-smi), a JSON line of
             per-kernel numbers, and last the line
             {"ok": true, "device": {"platform": "gpu", ...}}.

``--rtn-layers``, ``--tune-layers``, ``--moe-layers``, ``--moe-tune-layers``,
``--asym-layers``, ``--a8-layers``, ``--w8a8-layers``, ``--w8a16-layers``,
``--a8-modes-layers``, ``--a8-tune-layers``, ``--fp8-layers``,
``--mxfp4-layers``, ``--nvfp4-layers``, ``--w2-layers``,
``--mx-tune-layers``, ``--llama1b-layers``, ``--sage-layers``,
``--qwen25-layers``, ``--qwen3-tune-layers``, ``--gemma2-layers``,
``--gemma3-layers``, ``--load-layers``, ``--options-layers``,
``--nblocks-layers``, ``--offload-layers``, ``--deepseek-layers``,
``--deepseek-v3-layers``, ``--gptoss-layers``, ``--gptoss120-layers``,
``--llama4-layers``, ``--qwen3next-layers``, ``--qwen35-load-layers``,
``--glm45-layers``, ``--glm5-layers``, ``--minimax-layers``,
``--ernie-layers``, ``--longcat-layers``, ``--step35-layers``,
``--gguf-layers``, ``--gguf-tune-layers``, ``--gguf-small-layers``,
``--gguf-moe-layers``, ``--rotation-layers``, ``--autoscheme-layers``,
``--resume-layers``, ``--model-free-layers`` and ``--writers-layers`` cut
the depth of the paths for a quicker run.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s,
# int8 OP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 1513e12),
         "H100": (3.35e12, 989e12, 1979e12)}

# Kernel vs plain version on the card, bf16 out on both sides.  Error
# measure: in each output row (last axis) max |kernel - plain| over the RMS
# of the plain row, worst row counted.  Rows are held to their own scale
# because attention rows differ in size: row 0 of a causal output is one
# value row, rows that average hundreds of keys are ~10x smaller.  Each
# limit is about 3x the worst row error measured on an H100 (flash 0.034,
# the same as SDPA's against the plain version; W4A16 0.037; decode
# attention 0.0072; PERF.md).
ROW_TOL = {"flash_attention": 0.1, "w4a16_matmul": 0.1,
           # bf16 out against the plain version's bf16: W8A8 and the W4A8
           # GEMM are bit-equal in fp32 before the cast (row error 0), as is
           # the W4A8 GEMV where its plan splits no K; split over a cluster
           # it adds the ranks' sums in rank order (fp32 row error 2.1e-6),
           # which moves a few outputs by one bf16 ulp: 0.0099 of the row's
           # RMS at worst (measured, down_proj M = 32); W8A16 rounds
           # float(wi) * s to bf16 as the plain version
           # does in both bodies (the GEMV: worst row 0.0124 at M = 8;
           # the GEMM per channel at K = 14336, M = 4096: 0.0503, the sums'
           # order over 14336 products)
           "w4a8_matmul": 0.06, "w8a8_matmul": 0.06, "w8a16_matmul": 0.15,
           "decode_attention": 0.025,
           # the tile bodies of w4a16_matmul with an expert grid axis / a
           # zero point: the same limit
           "w4a16_matmul_grouped": 0.1, "w4a16_asym_matmul": 0.1,
           # backward pair vs flash_attention_bwd_plain: measured worst rows
           # dQ 0.027, dK / dV 0.023 (S = T = 512 and S = 256, T = 512)
           "flash_attention_bwd_dq": 0.07, "flash_attention_bwd_dkv": 0.07,
           # the W4A16 bodies in their INT2 and E2M1 formats (measured 0.035
           # and 0.036); FP8 applies the channel scale to the fp32 sum where
           # the plain version rounds e4m3 * s to bf16 first (measured 0.056
           # in the GEMM, 0.029 in the GEMV at M = 8)
           "w2a16_matmul": 0.1, "mxfp4_matmul": 0.1, "fp8_matmul": 0.15,
           # int8-QK attention against its plain version on the same mean
           # key: the same codes, scores and softmax on both sides up to
           # the order of fp32 sums; P rounded to bf16 as in flash
           "sage_attention": 0.1}
# int8-QK attention against the bf16 flash kernel, mean |diff| over all
# outputs: the JAX test's limit for the int8 path against the fp path (the
# JAX docstring measured 4.7e-4 on the TPU)
SAGE_FLASH_MAE = 5e-3
# A gradient row may be zero in exact arithmetic (row 0 of dQ when S = T: one
# visible key, P = 1, dS = 0), so rows smaller than this share of the whole
# tensor's RMS are held to that scale instead of their own.
BWD_ROW_FLOOR = 0.01
LSE_ATOL = 1e-5          # lse is fp32 on both sides (~1e-6 measured)
# fp32 result of W4A8 before the cast, same row measure (measured 2.1e-6)
W4A8_F32_ROW_TOL = 1e-5
# a8 serving modes: prefill logits against exact-A16 serving, max |diff| over
# max |exact| (the JAX package's own measure; its test's limit of 0.06 is for
# fp32 at hidden 1024).  At llama3-8b width in bf16 with random weights the
# int8 activation noise of 2 blocks and their 8 products measures 0.064
# (serve_a8) and 0.066 (prefill_a8) on an H100; limit about 3x.  A product
# that computed something else would give about 1.4.
A8_MODE_TOL = 0.2
# the library yardstick must compute the same function: a wrong causal
# anchor (top-left instead of bottom-right) gives row errors of order 10
LIB_ROW_TOL = 0.1
# step-1 logits of the 2-layer engine copy, kernels on the card vs plain
# versions (on the CPU, or on the card for the MoE and asym paths; bf16
# activations through 2 blocks and the lm_head); same row measure, about
# 3x the measured error (0.049, llama3-8b W4A16)
COPY_ROW_TOL = 0.15
# the same for a MoE engine: besides the rounding above, a top-2 near-tie of
# the router (random weights: near-uniform probabilities) may fall the other
# way under the kernels' and the plain versions' different bf16 roundings,
# and such a token's row moves as a whole; measured 0.085 and 0.107 with two
# sets of weights on an H100, limit about 3x
MOE_COPY_ROW_TOL = 0.3


def log(*a):
    print(*a, flush=True)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    log(f"unknown card {name!r}: bounds use the H100 SXM peaks")
    return PEAKS["H100"]


class Timer:
    """CUDA-event timing of single launches, L2 flushed before each; and
    device time by the profiler."""

    def __init__(self, reps: int = 7):
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()                                   # warm-up
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def device(self, fn, reps: int = 20):
        """(ms, how): the device time of one call of `fn`, the kernels it
        launches summed (split + combine, quantize_rows + GEMM, a library
        call's own kernels), from torch.profiler's CUDA activity over `reps`
        calls; `how` names the source and each kernel's share.  Before each
        call the L2 is flushed by reading 128 MB (the max of the flush
        buffer, left out of the sum): it holds no line of the call's inputs
        and no dirty line, as after a decode step's weight reads (the event
        timer's flush writes, and the write-back of its dirty lines lands
        in the kernels after it).  If three profiles see no kernel,
        CUDA events around `reps` back-to-back calls over the count (then
        the host's time per call where the host is the slower)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(3):          # a profile now and then sees no kernel
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.amax()
                    fn()
                torch.cuda.synchronize()
            parts = {name: ms / reps
                     for name, (ms, _) in _kernel_times(prof).items()
                     if "MaxNanFunctor<unsigned char>" not in name
                     and not name.startswith(("Memset", "Memcpy"))}
            total = sum(parts.values())
            if total > 0:
                return total, "profiler: " + " + ".join(
                    f"{_short(name)} {ms:.4f}" for name, ms in parts.items())
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps, "events"


def row_err(out, ref, floor: float = 0.0):
    """(max |out - ref|, worst row's max |out - ref| over its ref RMS).
    With ``floor``, a row's RMS counts as at least that share of the whole
    tensor's RMS."""
    d = (out.float() - ref.float()).abs()
    ref2 = ref.float().pow(2)
    rms = ref2.mean(-1).sqrt().clamp_min(1e-30)
    if floor:
        rms = rms.clamp_min(floor * ref2.mean().sqrt().item())
    return d.max().item(), (d.amax(-1) / rms).max().item()


def tflops(n_ops, ms, unit="TFLOP/s") -> str:
    """Achieved rate of `n_ops` operations in `ms` milliseconds."""
    return f"achieved={n_ops / ms / 1e9:.1f} {unit}"


def device_pair(timer, fn, lib):
    """(device ms of `fn`, of its library call `lib`, the text the kernel
    lines print for them)."""
    dev_ms, how = timer.device(fn)
    lib_dev_ms, _ = timer.device(lib)
    return dev_ms, lib_dev_ms, (f" device_ms={dev_ms:.4f} ({how}) "
                                f"library_device_ms={lib_dev_ms:.4f}")


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def kernel_phase(timer, bw, flops_peak):
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_plain,
        flash_attention_plain)
    from autoround_tpu_torch.ops.qmatmul import (
        pack_w4, unpack_w4, w4a16_matmul, w4a16_matmul_grouped,
        w4a16_matmul_grouped_plain, w4a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_ext import (w4a16_asym_matmul,
                                                     w4a16_asym_matmul_plain)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    bwd_shapes = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    # K1 flash attention, forward then backward: calibration / tuning /
    # prefill shapes, D = 256 (Gemma's heads), Qwen3-Next's full
    # attention (D = 256, 16 query heads over 2 KV heads: G = 8),
    # GLM-4.5-Air's (96 query heads over 8 KV heads: G = 12, the dK / dV
    # group sum over 12 heads), MiniMax-Text-01's (64 over 8 of D = 128;
    # these two are also Step-3.5-Flash's sliding and full layers) and
    # ERNIE-4.5-21B-A3B's (20 over 4: G = 5, an odd group)
    for (B, H, Hkv, S, T, D, rep_row) in [(8, 32, 8, 512, 512, 128, True),
                                          (8, 32, 8, 256, 512, 128, False),
                                          (8, 32, 8, 512, 512, 256, False),
                                          (8, 16, 2, 512, 512, 256, False),
                                          (8, 96, 8, 512, 512, 128, False),
                                          (8, 64, 8, 512, 512, 128, False),
                                          (8, 20, 4, 512, 512, 128, False)]:
        q = torch.randn(B, H, S, D, generator=g, device=dev).bfloat16()
        k = torch.randn(B, Hkv, T, D, generator=g, device=dev).bfloat16()
        v = torch.randn(B, Hkv, T, D, generator=g, device=dev).bfloat16()
        out, lse = flash_attention(q, k, v, True)
        pout, plse = flash_attention_plain(q, k, v, True)
        torch.cuda.synchronize()
        err, rel = row_err(out, pout)
        lerr = (lse - plse).abs().max().item()
        tol = ROW_TOL["flash_attention"]
        check(rel <= tol and lerr <= LSE_ATOL,
              f"flash S={S} T={T}: row err {rel} lse err {lerr}")

        # SDPA's is_causal is top-left: bottom-right needs a bias
        def lib_fwd(q_, k_, v_):
            if S == T:
                return F.scaled_dot_product_attention(
                    q_, k_, v_, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=causal_lower_right(S, T),
                enable_gqa=True)

        def lib():
            return lib_fwd(q, k, v)
        _, lib_rel = row_err(lib(), pout)
        check(lib_rel <= LIB_ROW_TOL,
              f"flash S={S} T={T}: library call computes another function "
              f"(row err {lib_rel})")
        ms = timer(lambda: flash_attention(q, k, v, True))
        plain_ms = timer(lambda: flash_attention_plain(q, k, v, True))
        lib_ms = timer(lib)
        valid = sum(min(T, i + T - S + 1) for i in range(S))
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
            + 4 * lse.numel()
        n_ops = 4 * B * H * valid * D
        b_ms, b_by = bound(nbytes, n_ops)
        shape = f"B={B} H={H} Hkv={Hkv} S={S} T={T} D={D} causal"
        log(f"kernel flash_attention [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) lse_err={lerr:.3g} "
            f"(tol {LSE_ATOL}) library_row_err={lib_rel:.3g} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(n_ops, ms)} library {tflops(n_ops, lib_ms)}")
        if rep_row:
            rows["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="autoround_tpu_torch/csrc/flash_attention.cu",
                replaces="autoround_tpu/ops/flash_attention.py:328",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del pout, plse

        # the backward pair on the same tensors: dQ and dK/dV against the
        # plain version, bit-equal run to run; library = SDPA's backward
        do = torch.randn(B, H, S, D, generator=g, device=dev).bfloat16()
        delta = (out.float() * do.float()).sum(-1)
        got = {"flash_attention_bwd_dq":
               (flash_attention_bwd_dq(q, k, v, do, lse, delta, True),),
               "flash_attention_bwd_dkv":
               flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)}
        again = (flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
                 *flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))
        torch.cuda.synchronize()
        first = got["flash_attention_bwd_dq"] + got["flash_attention_bwd_dkv"]
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"flash backward S={S} T={T}: two launches differ")
        pdq, pdk, pdv = flash_attention_bwd_plain(q, k, v, out, lse, do, True)
        plain = {"flash_attention_bwd_dq": (pdq,),
                 "flash_attention_bwd_dkv": (pdk, pdv)}
        ql = q.clone().requires_grad_(True)
        kl = k.clone().requires_grad_(True)
        vl = v.clone().requires_grad_(True)
        lib_out = lib_fwd(ql, kl, vl)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                       retain_graph=True)
        lib_rel = max(row_err(a, b, BWD_ROW_FLOOR)[1]
                      for a, b in zip(lib_bwd(), (pdq, pdk, pdv)))
        check(lib_rel <= LIB_ROW_TOL,
              f"flash backward S={S} T={T}: library call computes another "
              f"function (row err {lib_rel})")
        lib_ms = timer(lib_bwd)
        lib_dev_ms, lib_how = timer.device(lib_bwd)
        plain_ms = timer(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, True))
        # the whole backward as the autograd route runs it: delta, dQ, dK/dV
        bwd_dev_ms, bwd_how = timer.device(lambda: flash_attention_bwd(
            q, k, v, out, lse, do, True))
        n_bwd = 2 * 7 * B * H * valid * D
        log(f"kernel flash_attention_bwd [{shape}] (delta + dQ + dK/dV) "
            f"device_ms={bwd_dev_ms:.4f} ({bwd_how}) "
            f"library_device_ms(SDPA backward)={lib_dev_ms:.4f} ({lib_how}) "
            f"over_library={bwd_dev_ms / lib_dev_ms:.3f} "
            f"{tflops(n_bwd, bwd_dev_ms)} (7 products) library "
            f"{tflops(2 * 5 * B * H * valid * D, lib_dev_ms)} (5 products)")
        runs = {"flash_attention_bwd_dq": lambda: flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, True),
                "flash_attention_bwd_dkv": lambda: flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, True)}
        in_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4 * (lse.numel() + delta.numel())
        work = {"flash_attention_bwd_dq": (in_bytes + 2 * q.numel(), 3),
                "flash_attention_bwd_dkv":
                (in_bytes + 2 * (k.numel() + v.numel()), 4)}
        for name, line in (("flash_attention_bwd_dq", 262),
                           ("flash_attention_bwd_dkv", 286)):
            errs = [row_err(a, b, BWD_ROW_FLOOR)
                    for a, b in zip(got[name], plain[name])]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            tol = ROW_TOL[name]
            check(rel <= tol, f"{name} S={S} T={T}: row err {rel}")
            ms = timer(runs[name])
            dev_ms, how = timer.device(runs[name])
            nbytes, n_prod = work[name]
            n_ops = 2 * n_prod * B * H * valid * D
            b_ms, b_by = bound(nbytes, n_ops)
            log(f"kernel {name} [{shape}] max_abs_err={err:.3g} "
                f"row_err={rel:.3g} (tol {tol}, row floor {BWD_ROW_FLOOR}) "
                f"run_to_run=equal library_row_err={lib_rel:.3g} "
                f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} ({how}) "
                f"plain_ms(dq+dk+dv)={plain_ms:.4f} "
                f"library_ms(dq+dk+dv)={lib_ms:.4f} "
                f"library_device_ms(dq+dk+dv)={lib_dev_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) device "
                f"{tflops(n_ops, dev_ms)}")
            bwd_shapes[name].append(dict(
                shape=shape, max_abs_err=err, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                bwd_device_ms=bwd_dev_ms))
            if rep_row:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="autoround_tpu_torch/csrc/flash_attention_bwd.cu",
                    replaces=f"autoround_tpu/ops/flash_attention.py:{line}",
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms,
                    bwd_device_ms=bwd_dev_ms)
        del q, k, v, out, lse, do, delta, got, again, first, plain, pdq, pdk
        del pdv, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    # every shape of the backward pair in its row (the row's own first)
    for name, shapes in bwd_shapes.items():
        rows[name]["shapes"] = shapes

    # K2 W4A16: fused qkv, down_proj, lm_head at decode and prefill M, at
    # g = 128 and g = 16 (the GEMV reads a second scale half way through a
    # 32-column chunk); then Qwen3-Next's DeltaNet input projection
    # in_proj_qkvz (O = 12288, K = 2048), GLM-4.5-Air's fused q / k / v
    # (O = 14336, K = 4096) and o_proj (O = 4096, K = 12288) and
    # MiniMax-Text-01's lightning qkv_proj (O = 24576, K = 6144) at g = 128
    for (M, O, K, name, G) in [(M, O, K, name, G) for G in (128, 16)
                               for (M, O, K, name) in [
                                   (8, 6144, 4096, "qkv"),
                                   (8, 4096, 14336, "down_proj"),
                                   (8, 128256, 4096, "lm_head"),
                                   (4096, 6144, 4096, "qkv"),
                                   (4096, 4096, 14336, "down_proj"),
                                   (4096, 128256, 4096, "lm_head")]] + [
            (8, 12288, 2048, "qwen3-next in_proj_qkvz", 128),
            (4096, 12288, 2048, "qwen3-next in_proj_qkvz", 128),
            (8, 14336, 4096, "glm-4.5-air qkv", 128),
            (4096, 14336, 4096, "glm-4.5-air qkv", 128),
            (8, 4096, 12288, "glm-4.5-air o_proj", 128),
            (4096, 4096, 12288, "glm-4.5-air o_proj", 128),
            (8, 24576, 6144, "minimax qkv_proj", 128),
            (4096, 24576, 6144, "minimax qkv_proj", 128)]:
        codes = torch.randint(0, 16, (O, K), generator=g, device=dev)
        sc = (torch.rand(O, K // G, generator=g, device=dev) - 0.5) * 0.02
        qw = pack_w4(codes)
        del codes
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        y = w4a16_matmul(x, qw, sc, G)
        yp = w4a16_matmul_plain(x, qw, sc, G)
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del yp
        tol = ROW_TOL["w4a16_matmul"]
        check(rel <= tol, f"w4a16 M={M} O={O} K={K} g={G}: row err {rel}")
        ms = timer(lambda: w4a16_matmul(x, qw, sc, G))
        plain_ms = timer(lambda: w4a16_matmul_plain(x, qw, sc, G))
        w_bf16 = ((unpack_w4(qw) - 8).float()
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_txt = ""
        if M == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, lambda: w4a16_matmul(x, qw, sc, G),
                lambda: torch.matmul(x, w_bf16.T))
        del w_bf16
        nbytes = 2 * M * K + O * K // 2 + 4 * sc.numel() + 2 * M * O
        b_ms, b_by = bound(nbytes, 2 * M * O * K)
        shape = f"{name} M={M} O={O} K={K} g={G}"
        log(f"kernel w4a16_matmul [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * M * O * K, ms)} library "
            f"{tflops(2 * M * O * K, lib_ms)}")
        if M == 8 and name == "qkv" and G == 128:
            rows["w4a16_matmul"] = dict(
                name="w4a16_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w4a16_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul.py:168",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, x, y
        torch.cuda.empty_cache()

    # K4 grouped W4A16 (mixtral-8x7b experts, E = 8): decode C = 8 and
    # prefill C = 4096 for w1/w3 (K, O) = (4096, 14336), where dense-then-
    # mask routing hands all experts one shared slab (expert stride 0), and
    # for w2 (14336, 4096) on contiguous slabs; one ragged case (C = 5, O
    # not a multiple of any tile, the first C rows of a taller buffer, as
    # capacity dispatch hands it over); then gpt-oss-20b's experts (E = 32,
    # 2880 x 2880 at g = 32: K is 22.5 x 128) and llama4-scout's (E = 16,
    # gate / up 8192 x 5120 on the shared slab, down 5120 x 8192); then
    # Qwen3-Next's (E = 512: w1 / w3 512 x 2048 on the shared slab, w2
    # 2048 x 512; C = 4096 is 8 x 512 tokens of dense-then-mask prefill,
    # a 8.6 GB w2 output slab); then GLM-4.5-Air's (E = 128: gate / up
    # 1408 x 4096 on the shared slab, down 4096 x 1408, 11 groups of 128);
    # then MiniMax-Text-01's (E = 32: w1 / w3 9216 x 6144 on the shared
    # slab, w2 6144 x 9216)
    for (E, C, K, O, name, layout, gs) in [
            (8, 8, 4096, 14336, "w1", "shared", 128),
            (8, 8, 14336, 4096, "w2", "contiguous", 128),
            (8, 4096, 4096, 14336, "w1", "shared", 128),
            (8, 4096, 14336, 4096, "w2", "contiguous", 128),
            (8, 5, 4096, 1000, "ragged", "slice", 128),
            (32, 8, 2880, 2880, "gpt-oss gate/up", "shared", 32),
            (32, 4096, 2880, 2880, "gpt-oss gate/up", "shared", 32),
            (16, 8, 5120, 8192, "scout gate/up", "shared", 128),
            (16, 8, 8192, 5120, "scout down", "contiguous", 128),
            (16, 4096, 5120, 8192, "scout gate/up", "shared", 128),
            (16, 4096, 8192, 5120, "scout down", "contiguous", 128),
            (512, 8, 2048, 512, "qwen3-next w1/w3", "shared", 128),
            (512, 8, 512, 2048, "qwen3-next w2", "contiguous", 128),
            (512, 4096, 2048, 512, "qwen3-next w1/w3", "shared", 128),
            (512, 4096, 512, 2048, "qwen3-next w2", "contiguous", 128),
            (128, 8, 4096, 1408, "glm-4.5-air gate/up", "shared", 128),
            (128, 8, 1408, 4096, "glm-4.5-air down", "contiguous", 128),
            (128, 4096, 4096, 1408, "glm-4.5-air gate/up", "shared", 128),
            (128, 4096, 1408, 4096, "glm-4.5-air down", "contiguous",
             128),
            (32, 8, 6144, 9216, "minimax w1/w3", "shared", 128),
            (32, 8, 9216, 6144, "minimax w2", "contiguous", 128),
            (32, 4096, 6144, 9216, "minimax w1/w3", "shared", 128),
            (32, 4096, 9216, 6144, "minimax w2", "contiguous", 128)]:
        qw = torch.stack([pack_w4(torch.randint(
            0, 16, (O, K), generator=g, device=dev)) for _ in range(E)])
        sc = (torch.rand(E, O, K // gs, generator=g, device=dev) - 0.5) * 0.02
        if layout == "shared":
            x = torch.randn(C, K, generator=g, device=dev).bfloat16() \
                .expand(E, C, K)
        elif layout == "slice":
            x = torch.randn(E, C + 1, K, generator=g,
                            device=dev).bfloat16()[:, :C]
        else:
            x = torch.randn(E, C, K, generator=g, device=dev).bfloat16()
        y = w4a16_matmul_grouped(x, qw, sc, gs)
        yp = w4a16_matmul_grouped_plain(x, qw, sc, gs)
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del yp
        tol = ROW_TOL["w4a16_matmul_grouped"]
        check(rel <= tol, f"grouped E={E} C={C} O={O} K={K}: row err {rel}")
        ms = timer(lambda: w4a16_matmul_grouped(x, qw, sc, gs))
        plain_ms = timer(lambda: w4a16_matmul_grouped_plain(x, qw, sc, gs))
        w_bf16 = torch.stack([
            ((unpack_w4(qw[e]) - 8).float()
             * sc[e].repeat_interleave(gs, dim=1)).bfloat16()
            for e in range(E)])
        lib_ms = timer(lambda: torch.bmm(x, w_bf16.transpose(1, 2)))
        dev_txt = ""
        if C == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, lambda: w4a16_matmul_grouped(x, qw, sc, gs),
                lambda: torch.bmm(x, w_bf16.transpose(1, 2)))
        del w_bf16
        x_slabs = 1 if layout == "shared" else E
        nbytes = (2 * x_slabs * C * K + E * O * K // 2 + 4 * sc.numel()
                  + 2 * E * C * O)
        b_ms, b_by = bound(nbytes, 2 * E * C * O * K)
        shape = f"{name} E={E} C={C} O={O} K={K} g={gs} x {layout}"
        log(f"kernel w4a16_matmul_grouped [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * E * C * O * K, ms)} library "
            f"{tflops(2 * E * C * O * K, lib_ms)}")
        if E == 8 and C == 8 and name == "w1":
            rows["w4a16_matmul_grouped"] = dict(
                name="w4a16_matmul_grouped", route="cuda",
                source="autoround_tpu_torch/csrc/w4a16_matmul_grouped.cu",
                replaces="autoround_tpu/ops/qmatmul.py:280",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, x, y
        torch.cuda.empty_cache()

    # K5 asym W4A16: the llama3-8b projections of K2, fractional zero
    # points, g = 128 and g = 16
    for (M, O, K, name, G) in [(M, O, K, name, G) for G in (128, 16)
                               for (M, O, K, name) in [
                                   (8, 6144, 4096, "qkv"),
                                   (8, 4096, 14336, "down_proj"),
                                   (8, 128256, 4096, "lm_head"),
                                   (4096, 6144, 4096, "qkv"),
                                   (4096, 4096, 14336, "down_proj"),
                                   (4096, 128256, 4096, "lm_head")]]:
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=g, device=dev))
        sc = torch.rand(O, K // G, generator=g, device=dev) * 0.01 + 0.002
        zp = torch.rand(O, K // G, generator=g, device=dev) * 15
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        y = w4a16_asym_matmul(x, qw, sc, zp, G)
        yp = w4a16_asym_matmul_plain(x, qw, sc, zp, G)
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del yp
        tol = ROW_TOL["w4a16_asym_matmul"]
        check(rel <= tol, f"asym M={M} O={O} K={K} g={G}: row err {rel}")
        ms = timer(lambda: w4a16_asym_matmul(x, qw, sc, zp, G))
        plain_ms = timer(lambda: w4a16_asym_matmul_plain(x, qw, sc, zp, G))
        w_bf16 = ((unpack_w4(qw).float() - zp.repeat_interleave(G, dim=1))
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_txt = ""
        if M == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, lambda: w4a16_asym_matmul(x, qw, sc, zp, G),
                lambda: torch.matmul(x, w_bf16.T))
        del w_bf16
        nbytes = 2 * M * K + O * K // 2 + 8 * sc.numel() + 2 * M * O
        b_ms, b_by = bound(nbytes, 2 * M * O * K)
        shape = f"{name} M={M} O={O} K={K} g={G} fractional zp"
        log(f"kernel w4a16_asym_matmul [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * M * O * K, ms)} library "
            f"{tflops(2 * M * O * K, lib_ms)}")
        if M == 8 and name == "qkv" and G == 128:
            rows["w4a16_asym_matmul"] = dict(
                name="w4a16_asym_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w4a16_asym_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul_ext.py:162",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, zp, x, y
        torch.cuda.empty_cache()

    return rows


def decode_kernel_phase(timer, bw, flops_peak):
    """Row 6, the int8-KV decode attention: B=8, T=1024; llama3-8b's heads
    (hd 128, G = 4; also with Llama 4's chunk, 256 here), llama3.2-1b's (hd
    64), hd 256 (Gemma), G = 7 (qwen2.5-7b's 28 / 4), gpt-oss's (hd 64,
    G = 8, its 128 window and the sinks), GLM-4.5-Air's (hd 128, G = 12:
    96 query heads over 8 KV heads; pos 511, 700, and a 256 window with
    sinks) and every G from 9 to 16 at hd 64 / 128 / 256 (pos 511; the
    instances above G = 8).  Library: SDPA on the
    dequantized bf16 cache up to pos, with the window or the chunk as a
    boolean mask where there is one; no single call adds the sinks, so at
    gpt-oss's shape there is no library time, and at the other sink cases
    the yardstick leaves them out and is checked against the plain version
    without sinks.  Event times include the
    wrapper's Python; device times (`device_ms`) are the kernels' own, split
    plus combine, and the comparison with SDPA and the bound is made on
    them."""
    import torch.nn.functional as F

    from autoround_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain, decode_splits)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    B, T = 8, 1024
    # (pos, window, chunk, sinks) per head shape
    for (hd, nkv, G, cases) in [
            (128, 8, 4, [(511, None, None, False), (700, None, None, False),
                         (700, 256, None, True), (700, None, 256, False)]),
            (64, 8, 4, [(511, None, None, False), (700, 256, None, True)]),
            (256, 8, 4, [(511, None, None, False), (700, 256, None, True)]),
            (128, 4, 7, [(511, None, None, False)]),
            (64, 8, 8, [(511, 128, None, True)]),
            (128, 8, 12, [(511, None, None, False), (700, None, None, False),
                          (700, 256, None, True)])] + [
            (hd, 8, G, [(511, None, None, False)]) for G in range(9, 17)
            for hd in (64, 128, 256) if (hd, G) != (128, 12)]:
        nh = nkv * G
        q = torch.randn(B, nh, hd, generator=g, device=dev).bfloat16()
        kc = torch.randint(-127, 128, (B, T, nkv, hd), generator=g,
                           device=dev).to(torch.int8)
        vc = torch.randint(-127, 128, (B, T, nkv, hd), generator=g,
                           device=dev).to(torch.int8)
        ks = torch.rand(nkv, generator=g, device=dev) * 0.02 + 0.01
        vs = torch.rand(nkv, generator=g, device=dev) * 0.02 + 0.01
        sinks = torch.randn(nh, generator=g, device=dev)
        sm = hd ** -0.5
        for pos, window, chunk, use_sinks in cases:
            sk = sinks if use_sinks else None
            pv = torch.full((B,), pos, dtype=torch.int32, device=dev)
            kw = dict(window=window, chunk=chunk, sinks=sk)
            o = decode_attention(q, kc, vc, pv, ks, vs, sm, **kw)
            op = decode_attention_plain(q, kc, vc, pv, ks, vs, sm, **kw)
            torch.cuda.synchronize()
            err, rel = row_err(o, op)
            tol = ROW_TOL["decode_attention"]
            check(rel <= tol, f"decode hd={hd} G={G} pos={pos}: row err "
                  f"{rel}")
            ms = timer(lambda: decode_attention(q, kc, vc, pv, ks, vs, sm,
                                                **kw))
            plain_ms = timer(lambda: decode_attention_plain(
                q, kc, vc, pv, ks, vs, sm, **kw))
            # the keys attended: the window's, or the chunk's from its start
            start = (pos - window + 1 if window is not None
                     else pos // chunk * chunk if chunk is not None else 0)
            n_tok = pos + 1 - max(start, 0)
            dev_ms, how = timer.device(lambda: decode_attention(
                q, kc, vc, pv, ks, vs, sm, **kw))
            # no single PyTorch call adds the sinks: at gpt-oss's shape the
            # library cell is empty
            no_lib = use_sinks and G == 8
            lib_ms = lib_dev_ms = lib_rel = None
            if not no_lib:
                kd = (kc[:, :pos + 1].float() * ks.view(1, 1, nkv, 1)) \
                    .bfloat16().transpose(1, 2).contiguous()
                vd = (vc[:, :pos + 1].float() * vs.view(1, 1, nkv, 1)) \
                    .bfloat16().transpose(1, 2).contiguous()
                q4 = q[:, :, None]
                mask = None
                if window is not None or chunk is not None:
                    idx = torch.arange(pos + 1, device=dev)
                    mask = (idx >= start)[None, None, None, :]

                def lib():
                    return F.scaled_dot_product_attention(
                        q4, kd, vd, attn_mask=mask, scale=sm,
                        enable_gqa=True)
                _, lib_rel = row_err(lib()[:, :, 0], decode_attention_plain(
                    q, kc, vc, pv, ks, vs, sm, window=window, chunk=chunk))
                check(lib_rel <= LIB_ROW_TOL,
                      f"decode hd={hd} pos={pos}: library call computes "
                      f"another function (row err {lib_rel})")
                lib_ms = timer(lib)
                lib_dev_ms, _ = timer.device(lib)
                del kd, vd
            nbytes = 2 * q.numel() * 2 + 2 * B * n_tok * nkv * hd + 8 * nkv
            b_ms, b_by = bound(nbytes, 4 * B * nh * n_tok * hd)
            shape = (f"B={B} T={T} nh={nh} nkv={nkv} hd={hd} pos={pos}"
                     + (f" window={window}" if window else "")
                     + (f" chunk={chunk}" if chunk else "")
                     + (" sinks" if use_sinks else ""))
            lib_txt = ("library_ms=- (no single PyTorch call takes the "
                       "sinks)" if no_lib else
                       f"library_row_err={lib_rel:.3g}"
                       f"{' (no sinks)' if use_sinks else ''} library_ms="
                       f"{lib_ms:.4f} library_device_ms={lib_dev_ms:.4f}")
            log(f"kernel decode_attention [{shape} splits="
                f"{decode_splits(B, nkv, T)}] max_abs_err={err:.3g} "
                f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} {lib_txt} device_ms={dev_ms:.4f} "
                f"({how}) bound_ms={b_ms:.4f} ({b_by}) keys={n_tok}")
            if hd == 128 and G == 12 and pos == 511:
                glm_row = dict(shape=shape, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib_ms,
                               device_ms=dev_ms,
                               library_device_ms=lib_dev_ms)
            if hd == 128 and G == 4 and pos == 511:
                rows["decode_attention"] = dict(
                    name="decode_attention", route="cuda",
                    source="autoround_tpu_torch/csrc/decode_attention.cu",
                    replaces="autoround_tpu/ops/decode_attention.py:240",
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del q, kc, vc
        torch.cuda.empty_cache()
    # GLM-4.5-Air's shape (G = 12) beside the row's own
    rows["decode_attention"]["glm45_g12"] = glm_row
    return rows


def a8_gemv_info(src, M, K, O, g=128):
    """{registers, spill bytes, dynamic shared bytes, blocks per SM, rw,
    kc} of the int8 GEMV of `src` (``w8a8_matmul`` or ``w4a8_matmul``) at
    (M, K, O[, g]): its resources and its plan."""
    import ctypes

    from autoround_tpu_torch.ops import _build
    fn = getattr(_build.load(src), f"{src}_gemv_info")
    args = (M, K, O) if src == "w8a8_matmul" else (M, K, O, g)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 6)()
    _build.check(fn(*args, info), f"{src}_gemv_info")
    return list(info)


def a8_kernel_phase(timer, bw, flops_peak, int8_peak):
    """The int8 kinds at the llama3-8b projections: quantize_rows, W8A8,
    W4A8 (g = 128) and W8A16 (g = 128 and per channel) against their plain
    versions, plus two edge shapes; kernel, plain, library and bound times.
    Library: for W8A8 at M > 32 ``torch._int_mm`` on rows quantized
    beforehand plus the epilogue in torch ops; elsewhere ``torch.matmul``
    on the dequantized bf16 weight.  The decode shapes (the int8 GEMV) at
    M = 1, 8 and 32 with device times (W8A16 not at M = 1 and 32); at M =
    8 the A16 SYM4 GEMV (row 4) on the W4A8 case's packed words beside it,
    and ``quantize_rows`` alone at M = 1, 8 and 32."""
    from autoround_tpu_torch.ops.qmatmul import (pack_w4, unpack_w4,
                                                 w4a16_matmul)
    from autoround_tpu_torch.ops.qmatmul_ext import (w8a16_matmul,
                                                     w8a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_int8 import (
        quantize_rows, quantize_rows_plain, w4a8_matmul, w4a8_matmul_plain,
        w8a8_matmul, w8a8_matmul_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = {}

    def bound(nbytes, nops, peak):
        t_b, t_f = nbytes / bw * 1e3, nops / peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    def report(kernel, shape, err, rel, extra, ms, plain_ms, lib_ms, b_ms,
               b_by):
        tol = ROW_TOL[kernel]
        unit = "TFLOP/s" if kernel == "w8a16_matmul" else "TOP/s"
        log(f"kernel {kernel} [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}){extra} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) {tflops(2 * M * O * K, ms, unit)}")
        check(rel <= tol, f"{kernel} {shape}: row err {rel}")

    for (M, K) in [(1, 4096), (8, 4096), (32, 4096), (4096, 4096),
                   (1, 14336), (8, 14336), (32, 14336), (4096, 14336)]:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        x[0] = 0
        xi, xs = quantize_rows(x)
        pi, ps = quantize_rows_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(xi, pi) and torch.equal(xs, ps),
              f"quantize_rows M={M} K={K}: codes or scales differ from the "
              f"plain version")
        ms = timer(lambda: quantize_rows(x))
        plain_ms = timer(lambda: quantize_rows_plain(x))
        dev_ms, _ = timer.device(lambda: quantize_rows(x))
        b_ms, _ = bound(3 * M * K + 4 * M, 0, 1.0)
        log(f"kernel quantize_rows [M={M} K={K}] codes and scales bit-equal "
            f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms="
            f"{plain_ms:.4f} bound_ms={b_ms:.4f} (bytes); it runs inside "
            f"every w4a8_matmul / w8a8_matmul call")

    # the last: ragged M and O on the GEMM body, and a K (a multiple of 32,
    # not of the int8 GEMM's 64-column tile) whose last tile is half empty
    decode = [(6144, 4096, "qkv"), (4096, 14336, "down_proj"),
              (128256, 4096, "lm_head")]
    cases = [(M, O, K, name, 128) for M in (1, 8, 32)
             for (O, K, name) in decode]
    cases += [(4096, O, K, name, 128) for (O, K, name) in decode]
    cases += [(5, 1000, 4096, "ragged", 128), (200, 1000, 1056, "K edge", 96)]
    for (M, O, K, name, G) in cases:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        out_bytes = 2 * M * K + 2 * M * O

        # row 7, W8A8: per-channel signed scales
        wi = torch.randint(-128, 128, (O, K), generator=gen,
                           device=dev).to(torch.int8)
        ws = (torch.rand(O, generator=gen, device=dev) - 0.5) * 0.002
        y = w8a8_matmul(x, wi, ws)
        y32 = w8a8_matmul(x, wi, ws, torch.float32)
        p32 = w8a8_matmul_plain(x, wi, ws, torch.float32)
        torch.cuda.synchronize()
        err, rel = row_err(y, p32.bfloat16())
        equal = torch.equal(y32, p32)
        check(equal, f"w8a8 M={M} O={O} K={K}: fp32 result differs from the "
              f"plain version's (both are exact integers times two scales)")
        del y32, p32
        ms = timer(lambda: w8a8_matmul(x, wi, ws))
        plain_ms = timer(lambda: w8a8_matmul_plain(x, wi, ws))
        if M > 32:
            xi, xs = quantize_rows(x)
            wt = wi.T

            def lib():
                return (torch._int_mm(xi, wt).float() * xs[:, None]
                        * ws[None, :]).bfloat16()
            lib_what = "int_mm+epilogue"
        else:
            w_bf16 = (wi.float() * ws[:, None]).bfloat16()

            def lib():
                return torch.matmul(x, w_bf16.T)
            lib_what = "matmul(bf16 dequant)"
        lib_ms = timer(lib)
        dev_ms, how = timer.device(lambda: w8a8_matmul(x, wi, ws))
        lib_dev_ms, _ = timer.device(lib)
        b_ms, b_by = bound(out_bytes + O * K + 4 * O, 2 * M * O * K,
                           int8_peak)
        shape = f"{name} M={M} O={O} K={K} per channel"
        report("w8a8_matmul", shape, err, rel,
               f" f32_bit_equal={equal} library={lib_what} device_ms="
               f"{dev_ms:.4f} ({how}, quantize_rows + product) "
               f"library_device_ms={lib_dev_ms:.4f} device "
               f"{tflops(2 * M * O * K, dev_ms, 'TOP/s')}", ms, plain_ms,
               lib_ms, b_ms, b_by)
        if M == 8 and name == "qkv":
            rows["w8a8_matmul"] = dict(
                name="w8a8_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w8a8_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul_int8.py:130",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        lib = None
        xi = xs = wt = w_bf16 = None

        # row 11, W8A16 on the same codes: per group and per channel
        for g in (G, 0) if M not in (1, 32) else ():
            sc = (torch.rand(O, K // g if g else 1, generator=gen,
                             device=dev) - 0.5) * 0.002
            y = w8a16_matmul(x, wi, sc, g)
            yp = w8a16_matmul_plain(x, wi, sc, g)
            torch.cuda.synchronize()
            err, rel = row_err(y, yp)
            del yp
            ms = timer(lambda: w8a16_matmul(x, wi, sc, g))
            plain_ms = timer(lambda: w8a16_matmul_plain(x, wi, sc, g))
            w_bf16 = (wi.float() * sc.repeat_interleave(
                g if g else K, dim=1)).bfloat16()
            lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
            extra = ""
            if M == 8:
                dev_ms, lib_dev_ms, extra = device_pair(
                    timer, lambda: w8a16_matmul(x, wi, sc, g),
                    lambda: torch.matmul(x, w_bf16.T))
            del w_bf16
            b_ms, b_by = bound(out_bytes + O * K + 4 * sc.numel(),
                               2 * M * O * K, flops_peak)
            shape = f"{name} M={M} O={O} K={K} " + (
                f"g={g}" if g else "per channel")
            report("w8a16_matmul", shape, err, rel, extra, ms, plain_ms,
                   lib_ms, b_ms, b_by)
            if M == 8 and name == "qkv" and g:
                rows["w8a16_matmul"] = dict(
                    name="w8a16_matmul", route="cuda",
                    source="autoround_tpu_torch/csrc/w8a16_matmul.cu",
                    replaces="autoround_tpu/ops/qmatmul_ext.py:330",
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del wi, ws, y
        sc = None
        torch.cuda.empty_cache()

        # row 8, W4A8: the packed words of the W4A16 kernel
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        sc = (torch.rand(O, K // G, generator=gen, device=dev) - 0.5) * 0.02
        y = w4a8_matmul(x, qw, sc, G)
        y32 = w4a8_matmul(x, qw, sc, G, torch.float32)
        p32 = w4a8_matmul_plain(x, qw, sc, G, torch.float32)
        torch.cuda.synchronize()
        err, rel = row_err(y, p32.bfloat16())
        equal = torch.equal(y32, p32)
        _, rel32 = row_err(y32, p32)
        kc = a8_gemv_info("w4a8_matmul", M, K, O, G)[5] if M <= 32 else 1
        check(rel32 <= W4A8_F32_ROW_TOL and (equal or kc > 1),
              f"w4a8 M={M} O={O} K={K}: fp32 row err {rel32}, bit-equal "
              f"{equal} (the GEMM body and a GEMV that splits no K must "
              f"be)")
        del y32, p32
        ms = timer(lambda: w4a8_matmul(x, qw, sc, G))
        plain_ms = timer(lambda: w4a8_matmul_plain(x, qw, sc, G))
        w_bf16 = ((unpack_w4(qw) - 8).float()
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_ms, how = timer.device(lambda: w4a8_matmul(x, qw, sc, G))
        lib_dev_ms, _ = timer.device(lambda: torch.matmul(x, w_bf16.T))
        del w_bf16
        a16 = ""
        if M == 8 and name in ("qkv", "down_proj", "lm_head"):
            # the A16 SYM4 GEMV reads the same packed words
            a16_ms, a16_how = timer.device(lambda: w4a16_matmul(x, qw, sc, G))
            a16 = f" a16_sym4_gemv_device_ms={a16_ms:.4f} ({a16_how})"
        b_ms, b_by = bound(out_bytes + O * K // 2 + 4 * sc.numel(),
                           2 * M * O * K, int8_peak)
        shape = f"{name} M={M} O={O} K={K} g={G}"
        report("w4a8_matmul", shape, err, rel,
               f" f32_bit_equal={equal} (kc={kc}) f32_row_err="
               f"{rel32:.3g} (tol {W4A8_F32_ROW_TOL}) device_ms="
               f"{dev_ms:.4f} ({how}, "
               f"quantize_rows + product) library_device_ms="
               f"{lib_dev_ms:.4f} device "
               f"{tflops(2 * M * O * K, dev_ms, 'TOP/s')}{a16}", ms,
               plain_ms, lib_ms, b_ms, b_by)
        if M == 8 and name == "qkv":
            rows["w4a8_matmul"] = dict(
                name="w4a8_matmul", route="cuda",
                source="autoround_tpu_torch/csrc/w4a8_matmul.cu",
                replaces="autoround_tpu/ops/qmatmul_int8.py:295",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)
        del qw, sc, x, y
        torch.cuda.empty_cache()
    return rows


def float_kernel_phase(timer, bw, flops_peak):
    """The float and 2-bit weight-only kinds at the llama3-8b projections:
    W2A16 (g = 128), FP8 (per channel) and MXFP4 (g = 32, powers of two)
    / NVFP4 (g = 16, any positive scale) against their plain versions, plus
    one K-edge shape each (K = 1056: a multiple of 32, not of 64); kernel,
    plain, library (``torch.matmul`` on the dequantized bf16 weight) and
    bound times."""
    from autoround_tpu_torch.ops.qmatmul import pack_w4, unpack_w4
    from autoround_tpu_torch.ops.qmatmul_ext import (
        decode_e2m1, fp8_matmul, fp8_matmul_plain, mxfp4_matmul,
        mxfp4_matmul_plain, pack_w2, unpack_w2, w2a16_matmul,
        w2a16_matmul_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}

    def run(kernel, shape, fn, plain, w_bf16, x, nbytes, replaces, source):
        M, K = x.shape
        O = w_bf16.shape[0]
        y, yp = fn(), plain()
        torch.cuda.synchronize()
        err, rel = row_err(y, yp)
        del y, yp
        ms = timer(fn)
        plain_ms = timer(plain)
        lib_ms = timer(lambda: torch.matmul(x, w_bf16.T))
        dev_txt = ""
        if M == 8:
            dev_ms, lib_dev_ms, dev_txt = device_pair(
                timer, fn, lambda: torch.matmul(x, w_bf16.T))
        t_b = (nbytes + 2 * M * K + 2 * M * O) / bw * 1e3
        t_f = 2 * M * O * K / flops_peak * 1e3
        b_ms, b_by = max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
        tol = ROW_TOL[kernel]
        log(f"kernel {kernel} [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) kernel_ms={ms:.4f}{dev_txt} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) "
            f"{tflops(2 * M * O * K, ms)} library "
            f"{tflops(2 * M * O * K, lib_ms)}")
        check(rel <= tol, f"{kernel} {shape}: row err {rel}")
        if M == 8 and shape.startswith("qkv") and kernel not in rows:
            rows[kernel] = dict(
                name=kernel, route="cuda", source=source, replaces=replaces,
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                device_ms=dev_ms, library_device_ms=lib_dev_ms)

    cases = [(8, 6144, 4096, "qkv"), (8, 4096, 14336, "down_proj"),
             (8, 128256, 4096, "lm_head"), (4096, 6144, 4096, "qkv"),
             (4096, 4096, 14336, "down_proj"),
             (4096, 128256, 4096, "lm_head"), (200, 1000, 1056, "K edge")]
    for (M, O, K, name) in cases:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()

        # row 10, W2A16: signed group scales
        G = 96 if K == 1056 else 128
        qw = pack_w2(torch.randint(0, 4, (O, K), generator=gen, device=dev))
        sc = (torch.rand(O, K // G, generator=gen, device=dev) - 0.5) * 0.02
        w_bf16 = ((unpack_w2(qw) - 2).float()
                  * sc.repeat_interleave(G, dim=1)).bfloat16()
        run("w2a16_matmul", f"{name} M={M} O={O} K={K} g={G}",
            lambda: w2a16_matmul(x, qw, sc, G),
            lambda: w2a16_matmul_plain(x, qw, sc, G), w_bf16, x,
            O * K // 4 + 4 * sc.numel(), "autoround_tpu/ops/qmatmul_ext.py:247",
            "autoround_tpu_torch/csrc/w2a16_matmul.cu")
        del qw, sc, w_bf16
        torch.cuda.empty_cache()

        # row 12, FP8: e4m3 weights, one scale per output channel
        wf = (torch.randn(O, K, generator=gen, device=dev) * 60).clamp(
            -448, 448).to(torch.float8_e4m3fn)
        sc = torch.rand(O, generator=gen, device=dev) * 0.002 + 1e-4
        w_bf16 = (wf.float() * sc[:, None]).bfloat16()
        run("fp8_matmul", f"{name} M={M} O={O} K={K} per channel",
            lambda: fp8_matmul(x, wf, sc), lambda: fp8_matmul_plain(x, wf, sc),
            w_bf16, x, O * K + 4 * O, "autoround_tpu/ops/qmatmul_ext.py:407",
            "autoround_tpu_torch/csrc/fp8_matmul.cu")
        del wf, sc, w_bf16
        torch.cuda.empty_cache()

        # row 13, MXFP4 (g = 32) and NVFP4 (g = 16) on the same codes
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        vals = decode_e2m1(unpack_w4(qw))
        for G in (32, 16):
            if G == 32:
                sc = torch.exp2(torch.randint(-10, -4, (O, K // G),
                                              generator=gen,
                                              device=dev).float())
            else:
                sc = torch.rand(O, K // G, generator=gen, device=dev) * 0.004
            w_bf16 = (vals * sc.repeat_interleave(G, dim=1)).bfloat16()
            run("mxfp4_matmul", f"{name} M={M} O={O} K={K} g={G}",
                lambda: mxfp4_matmul(x, qw, sc, G),
                lambda: mxfp4_matmul_plain(x, qw, sc, G), w_bf16, x,
                O * K // 2 + 4 * sc.numel(),
                "autoround_tpu/ops/qmatmul_ext.py:559",
                "autoround_tpu_torch/csrc/mxfp4_matmul.cu")
            del sc, w_bf16
        del qw, vals, x
        torch.cuda.empty_cache()
    return rows


def sage_kernel_phase(timer, bw, flops_peak, int8_peak):
    """Row 14, the int8-QK attention, at row 1's shapes (B8 H32 Hkv8 S=T=512
    and S=256 T=512, D128, causal) and the JAX docstring's B4 H32 Hkv8
    S=T=2048: against its plain version in the jitted form it follows (the
    same mean key), timed beside its bound, SDPA on the same bf16 q/k/v
    (the library yardstick) and row 1's flash kernel in the same call, by
    event and by device time (``Timer.device``).
    Bound: the bytes of q, k, v and the output, or QK^T's operations over
    the int8 peak plus P.V's over the bf16 peak (the causal pairs)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from autoround_tpu_torch.ops.flash_attention import flash_attention
    from autoround_tpu_torch.ops.sage_attention import (sage_attention,
                                                        sage_attention_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = {}
    for (B, H, Hkv, S, T) in [(8, 32, 8, 512, 512), (8, 32, 8, 256, 512),
                              (4, 32, 8, 2048, 2048)]:
        D = 128
        q = torch.randn(B, H, S, D, generator=gen, device=dev).bfloat16()
        k = (torch.randn(B, Hkv, T, D, generator=gen, device=dev)
             + 2).bfloat16()
        v = torch.randn(B, Hkv, T, D, generator=gen, device=dev).bfloat16()
        o = sage_attention(q, k, v, True)
        op = sage_attention_plain(q, k, v, True, recip=True)
        torch.cuda.synchronize()
        err, rel = row_err(o, op)
        tol = ROW_TOL["sage_attention"]
        check(bool(torch.isfinite(o).all()) and rel <= tol,
              f"sage S={S} T={T}: row err {rel}")
        # the JAX docstring's accuracy claim: against the bf16 flash kernel
        fo, _ = flash_attention(q, k, v, True)
        flash_mae = (o.float() - fo.float()).abs().mean().item()
        check(flash_mae < SAGE_FLASH_MAE,
              f"sage S={S} T={T}: mean abs err vs flash {flash_mae}")
        del op, fo

        def lib():
            if S == T:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=causal_lower_right(S, T), enable_gqa=True)
        ms = timer(lambda: sage_attention(q, k, v, True))
        plain_ms = timer(lambda: sage_attention_plain(q, k, v, True,
                                                      recip=True))
        lib_ms = timer(lib)
        flash_ms = timer(lambda: flash_attention(q, k, v, True))
        # device times: the op's kernels summed (the mean key's reduction,
        # the key pre-pass, the attention kernel), row 1's, SDPA's
        dev_ms, how = timer.device(lambda: sage_attention(q, k, v, True))
        flash_dev_ms, _ = timer.device(lambda: flash_attention(q, k, v,
                                                               True))
        lib_dev_ms, _ = timer.device(lib)
        valid = sum(min(T, i + T - S + 1) for i in range(S))
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel())
        t_b = nbytes / bw * 1e3
        ops = 2 * B * H * valid * D
        t_f = (ops / int8_peak + ops / flops_peak) * 1e3
        b_ms, b_by = max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
        shape = f"B={B} H={H} Hkv={Hkv} S={S} T={T} D={D} causal"
        log(f"kernel sage_attention [{shape}] max_abs_err={err:.3g} "
            f"row_err={rel:.3g} (tol {tol}) mean_abs_err_vs_flash="
            f"{flash_mae:.3g} (tol {SAGE_FLASH_MAE}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"flash_ms={flash_ms:.4f} (sage / flash {ms / flash_ms:.3f}) "
            f"device_ms={dev_ms:.4f} ({how}) flash_device_ms="
            f"{flash_dev_ms:.4f} (sage / flash {dev_ms / flash_dev_ms:.3f}) "
            f"library_device_ms={lib_dev_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by})")
        if S == T == 512:
            rows["sage_attention"] = dict(
                name="sage_attention", route="cuda",
                source="autoround_tpu_torch/csrc/sage_attention.cu",
                replaces="autoround_tpu/ops/sage_attention.py:176",
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                flash_ms=flash_ms, device_ms=dev_ms,
                flash_device_ms=flash_dev_ms, library_device_ms=lib_dev_ms)
        del q, k, v, o
        torch.cuda.empty_cache()
    return rows


def sage_path(n_layers):
    """The int8-QK op through its entry point, as a user calls it: the
    attention of a llama3-8b prefill (8 x 512 tokens, 32 heads, 8 kv heads,
    hd 128, causal) for each of ``n_layers`` layers, fresh q/k/v per layer
    from a seeded generator.  Counts are read right after; then the same
    q/k/v, drawn again, go through the flash kernel, and each output must
    be within the JAX docstring's accuracy of it.  No engine path routes to
    the op (as in the JAX package); returns the launches."""
    from autoround_tpu_torch.ops.flash_attention import flash_attention
    from autoround_tpu_torch.ops.sage_attention import sage_attention

    kernels = _kernel_fns()
    B, H, Hkv, S, D = 8, 32, 8, 512, 128

    def layer_inputs(gen):
        q = torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
        k = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
             + 2).bfloat16()
        v = torch.randn(B, Hkv, S, D, generator=gen, device="cuda").bfloat16()
        return q, k, v

    gen = torch.Generator(device="cuda").manual_seed(18)
    for fn in kernels.values():
        fn.launches = 0
    outs = [sage_attention(*layer_inputs(gen), True)
            for _ in range(n_layers)]
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    gen = torch.Generator(device="cuda").manual_seed(18)
    worst = 0.0
    for o in outs:
        q, k, v = layer_inputs(gen)
        check(bool(torch.isfinite(o).all()) and o.shape == q.shape,
              "sage path: output not finite or of another shape")
        fo, _ = flash_attention(q, k, v, True)
        worst = max(worst, (o.float() - fo.float()).abs().mean().item())
    log(f"sage path ({n_layers} layers of llama3-8b prefill attention): "
        f"worst mean_abs_err_vs_flash={worst:.3g} (tol {SAGE_FLASH_MAE})")
    log(f"sage path kernels {json.dumps(launches)}")
    check(worst < SAGE_FLASH_MAE, "sage path: output far from flash")
    want = {n: 0 for n in kernels}
    want["sage_attention"] = n_layers
    for n, c in want.items():
        check(launches[n] == c, f"sage path: {n} launched {launches[n]} "
              f"times, the loop implies {c}")
    return launches


def copy_engine(eng, n_layers, device, first=0):
    """``n_layers`` blocks of an engine from block ``first`` on (renumbered
    from 0, the config's per-layer tuples with them), on ``device``."""
    import dataclasses

    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.utils.pytree import tree_map

    # the per-layer tuples of the config follow the copied blocks
    kw = dict(num_layers=n_layers)
    for f in ("layer_types", "no_rope_layers"):
        if getattr(eng.cfg, f, None):
            kw[f] = tuple(getattr(eng.cfg, f)[first:first + n_layers])
    for f in ("moe_layers", "mlp_only_layers"):
        if getattr(eng.cfg, f, None):
            kw[f] = tuple(i - first for i in getattr(eng.cfg, f)
                          if first <= i < first + n_layers)
    cfg = dataclasses.replace(eng.cfg, **kw)

    def mv(t):
        return t.to(device)

    params = tree_map(mv, {k: v for k, v in eng.params.items()
                           if k != "blocks"})
    params["blocks"] = tree_map(
        mv, eng.params["blocks"][first:first + n_layers])
    renum = {f"blocks.{first + i}.": f"blocks.{i}." for i in range(n_layers)}
    packed = {}
    for k, e in eng.packed.items():
        pre = next((p for p in renum if k.startswith(p)), None)
        if k == "lm_head" or pre is not None:
            name = k if pre is None else renum[pre] + k[len(pre):]
            packed[name] = tuple(mv(t) for t in e)
    kinds = {}
    for k, v in eng.packed_kinds.items():
        pre = next((p for p in renum if k.startswith(p)), None)
        if k == "lm_head" or pre is not None:
            kinds[k if pre is None else renum[pre] + k[len(pre):]] = v
    splits = {}
    for k, v in (eng.fused_splits or {}).items():
        pre = next((p for p in renum if k.startswith(p)), None)
        if pre is not None:
            splits[renum[pre] + k[len(pre):]] = v
    return QuantizedLlama(cfg=cfg, params=params, packed=packed,
                          max_seq=eng.max_seq, kv_quant=eng.kv_quant,
                          fused_splits=splits,
                          device=torch.device(device),
                          packed_kinds=kinds,
                          moe_capacity_factor=eng.moe_capacity_factor,
                          prefill_a8=eng.prefill_a8)


def _kernel_times(prof, after=None):
    """{kernel name: (total ms, launches)} over the device-side events of a
    profile (each kernel counted once; CUPTI's own overhead markers out),
    those that start at ``after`` or later on the trace's clock if given."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "Command Buffer" in e.name:
            continue
        if after is not None and e.time_range.start < after:
            continue
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


def _short(name: str) -> str:
    """`split_kernel<128, 4>` for a profiler's kernel name (its function
    name and template arguments, without the signature)."""
    head = name.replace("(anonymous namespace)", "").split("(")[0]
    return re.sub(r"^.*?(\w+(<[^()]*>)?)$", r"\1",
                  head.replace("void ", "").strip())[:40]


def _top(times, per=1):
    rows = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
    return "; ".join(f"{name[:60]} {ms / per:.3f} ms x{n // per}"
                     for name, (ms, n) in rows)


def profile_serving(eng, prompts, prefill_ms, step_ms):
    """Kernel time on the card for one prefill and for 3 decode steps
    (torch.profiler, CUDA activity).  Busy share = kernel time over the
    unprofiled wall time of the same work."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values())
    log(f"profile prefill: kernel_ms={total:.2f} of prefill_ms="
        f"{prefill_ms:.2f} busy_share={total / prefill_ms:.3f}; top: "
        + _top(times))
    tok = logits.argmax(-1).to(torch.int32)
    n = 3
    with profile(activities=acts) as prof:
        for _ in range(n):
            logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values()) / n
    # the GEMV family (A16 and int8 bodies) and the int8 quantizer a step
    gemv = sum(ms for name, (ms, _) in times.items()
               if "gemv_kernel" in name) / n
    quant = sum(ms for name, (ms, _) in times.items()
                if "quantize_rows_kernel" in name) / n
    log(f"profile decode step: kernel_ms={total:.3f} of step_ms="
        f"{step_ms:.3f} busy_share={total / step_ms:.3f} gemv_ms="
        f"{gemv:.3f} quantize_rows_ms={quant:.3f}; top per step: "
        + _top(times, n))


def serve_bounds(eng, B, S, bw, flops_peak, int8_peak=None):
    """Least times the card could take for one prefill of B x S tokens and
    for the first decode step after it (pos = S): the larger of bytes over
    bandwidth and operations over their peak: the bf16 peak, or with
    ``int8_peak`` (an engine whose packed projections all run int8
    products: the kinds w4a8 and w8a8) the int8 peak for the projections
    and the bf16 peak for attention.  Prefill FLOPs: every block
    weight for all B*S tokens, the lm_head for the last position only (the
    engine runs it there alone), causal attention; a MoE block counts
    all its experts for every token (dense-then-mask routing, which is what
    the engine runs by default) and the router.  Bytes: the packed
    weights and scales and the dense leaves once, the embedding rows
    used, the int8 cache written (prefill) or read up to pos (decode).
    A sliding layer's attention counts the keys of its window alone, a
    chunked one those of its chunk (``_attended``); a block's weights are
    its own (``_block_weights``: Llama 4's dense and MoE blocks differ).
    An MLA engine takes :func:`_mla_bounds`, a hybrid (Qwen3-Next,
    MiniMax) one :func:`_hybrid_bounds`."""
    if getattr(eng.cfg, "kv_lora_rank", 0):
        return _mla_bounds(eng, B, S, bw, flops_peak)
    if (getattr(eng.cfg, "linear_num_key_heads", 0)
            or hasattr(eng.cfg, "full_attn_alpha_factor")):
        return _hybrid_bounds(eng, B, S, bw, flops_peak)
    cfg = eng.cfg
    L, hid, hd, V = cfg.num_layers, cfg.hidden_size, cfg.hd, cfg.vocab_size
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    w_layers = sum(_block_weights(cfg, i) for i in range(L))

    w_bytes = _weight_bytes(eng)
    row = hid * eng.params["embed_tokens"].element_size()
    kv_key = 2 * B * Hkv * hd                # int8 k and v of one key
    step_keys, pre_keys = _attended(cfg, S)  # summed over the layers
    lin_peak = int8_peak or flops_peak
    pre_ops_s = ((2 * B * S * w_layers + 2 * B * hid * V) / lin_peak
                 + 4 * B * H * hd * pre_keys / flops_peak)
    pre_bytes = w_bytes + B * S * row + S * L * kv_key
    step_ops_s = (2 * B * (w_layers + hid * V) / lin_peak
                  + 4 * B * H * hd * step_keys / flops_peak)
    step_bytes = w_bytes + B * row + step_keys * kv_key
    return (max(pre_bytes / bw, pre_ops_s) * 1e3,
            max(step_bytes / bw, step_ops_s) * 1e3)


def _block_weights(cfg, li):
    """Weights of block ``li`` that each token multiplies: attention, and
    the MLP, every routed expert of a MoE block (dense-then-mask, what the
    engines run), its router and a shared expert (Llama 4's, of the routed
    width; GLM-4.5's, n_shared_experts of the routed width), or a dense
    MLP (Llama 4's dense blocks: intermediate_size_mlp; GLM-4.5's first-k
    blocks: intermediate_size)."""
    hid, hd, inter = cfg.hidden_size, cfg.hd, cfg.intermediate_size
    attn = hid * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
        + cfg.num_heads * hd * hid
    n_exp = getattr(cfg, "num_experts", 0)
    moe_layers = getattr(cfg, "moe_layers", None)
    routed = getattr(cfg, "n_routed_experts", 0)
    if routed:                                     # GLM-4.5
        if not cfg.layer_is_moe(li):
            return attn + 3 * hid * inter
        return (attn + (routed + cfg.n_shared_experts) * 3 * hid
                * cfg.moe_intermediate_size + routed * hid)
    if moe_layers is not None:                     # Llama 4
        if li not in moe_layers:
            return attn + 3 * hid * cfg.intermediate_size_mlp
        return attn + (n_exp + 1) * 3 * hid * inter + n_exp * hid
    return attn + max(n_exp, 1) * 3 * hid * inter + n_exp * hid


def _weight_bytes(eng):
    """Bytes of every weight an engine holds but the embedding table and
    GLM-5's indexer: the packed entries and the dense leaves (a step reads
    them all once)."""
    from autoround_tpu_torch.utils.pytree import tree_map

    def nbytes(t):
        return 0 if t is None else t.numel() * t.element_size()
    # GLM-5's lightning indexer is held but never read by a serving step
    leaves = []
    tree_map(leaves.append, [{k: v for k, v in b.items() if k != "indexer"}
                             for b in eng.params["blocks"]])
    return (sum(nbytes(t) for k, e in eng.packed.items()
                if ".indexer." not in k for t in e)
            + sum(nbytes(t) for k, t in eng.params.items()
                  if k not in ("blocks", "embed_tokens"))
            + sum(nbytes(t) for t in leaves))


def _mla_bounds(eng, B, S, bw, flops_peak):
    """``serve_bounds`` for an MLA (DeepSeek) engine: (prefill bound ms,
    decode step bound ms at pos = S).  FLOPs: every linear weight of a
    block for each token (a MoE block all its routed experts:
    dense-then-mask, what the engine runs, and the router), the lm_head
    for the last position; prefill attention decompressed (q·k over
    qk_head_dim and p·v over v_head_dim, causal), a decode step's absorbed
    attention (q_nope through W_k, scores over r + dr per key, the context
    over r per key, through W_v) over the S + 1 keys it needs.  Bytes: the
    weights once (:func:`_weight_bytes`), the embedding rows used, the
    latent cache written (prefill) or read for S + 1 keys (decode), in its
    element size."""
    cfg = eng.cfg
    L, hid, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    nh, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim, cfg.v_head_dim)
    r, ql, dq = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.qk_head_dim
    attn = ((hid * ql + ql * nh * dq) if ql else hid * nh * dq) \
        + hid * (r + dr) + r * nh * (dn + dv) + nh * dv * hid
    E, mi = cfg.n_routed_experts, cfg.moe_intermediate_size
    moe = 3 * hid * mi * (E + cfg.n_shared_experts) + E * hid
    w_elems = sum(attn + (moe if cfg.layer_is_moe(i)
                          else 3 * hid * cfg.intermediate_size)
                  for i in range(L))
    elt = eng.params["embed_tokens"].element_size()
    row = hid * elt
    kv_elt = 1 if eng.kv_quant else elt
    w_bytes = _weight_bytes(eng)
    pre_ops = (2 * B * S * w_elems + 2 * B * hid * V
               + 2 * B * nh * (dq + dv) * (S * (S + 1) // 2) * L)
    pre_bytes = w_bytes + B * S * row + L * B * S * (r + dr) * kv_elt
    step_ops = (2 * B * (w_elems + hid * V)
                + 2 * B * nh * L * (dn * r + (S + 1) * (2 * r + dr) + r * dv))
    step_bytes = (w_bytes + B * row
                  + L * B * (S + 1) * (r + dr) * kv_elt)
    return (max(pre_bytes / bw, pre_ops / flops_peak) * 1e3,
            max(step_bytes / bw, step_ops / flops_peak) * 1e3)


def _hybrid_bounds(eng, B, S, bw, flops_peak):
    """``serve_bounds`` for a hybrid (Qwen3-Next, MiniMax) engine:
    (prefill bound ms, decode step bound ms at pos = S).  FLOPs: every
    linear weight of a block for each token (a MoE block all its routed
    experts: dense-then-mask, what the engine runs, its router, a shared
    expert and its gate; a DeltaNet layer ``in_proj_qkvz``,
    ``in_proj_ba``, ``out_proj`` and the conv taps; a lightning layer
    ``qkv_proj``, ``output_gate`` and ``out_proj``), the lm_head for the
    last position; a full layer's causal attention over the prompt or over
    the S + 1 keys of the step; a linear layer's recurrence (DeltaNet: a
    step's decay, key read, update and query read, 2 dk dv a head each;
    the prompt in chunks of C: Q Kᵀ, A, the solve, T V, T K, P V over the
    chunk and the state's read and update.  Lightning: a step's decay and
    kᵀ v update and the query's read, 4 hd² a head; the prompt in chunks of
    C as the engine computes them, whole: Q Kᵀ and S V over the C x C
    block, the query's read of the state and the state's update, 4 C hd +
    4 hd² a token and head).  Bytes: the weights once
    (:func:`_weight_bytes`), the embedding rows used, the full layers' K /
    V written (prefill) or read for S + 1 keys (decode) in the model
    dtype, and each linear layer's recurrent state (fp32: DeltaNet's nv
    dk dv, lightning's nh hd hd, B · nh · hd · hd · 4 bytes) and conv tail
    (DeltaNet's; lightning has none) read and written once a step
    (written once by the prompt pass)."""
    from autoround_tpu_torch.models.registry import get_model_fns

    cfg = eng.cfg
    L, hid, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    lin = [get_model_fns(cfg).layer_is_linear(cfg, i) for i in range(L)]
    L_lin = sum(lin)
    L_full = L - L_lin
    elt = eng.params["embed_tokens"].element_size()
    w_full = hid * (H + 2 * Hkv) * hd + H * hd * hid
    E = cfg.num_experts
    if hasattr(cfg, "linear_num_key_heads"):          # Qwen3-Next
        nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
        dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
        Kc, C = cfg.linear_conv_kernel_dim, cfg.delta_chunk
        conv_dim = 2 * nk * dk + nv * dv
        w_lin = hid * (2 * nk * dk + 2 * nv * dv) + hid * 2 * nv \
            + nv * dv * hid + conv_dim * Kc
        mi = cfg.moe_intermediate_size
        w_moe = 3 * hid * mi * E + E * hid + 3 * hid * \
            cfg.shared_expert_intermediate + hid
        w_mlp = [3 * hid * cfg.intermediate_size
                 if i in cfg.mlp_only_layers else w_moe for i in range(L)]
        rec = nv * dk * dv * 4 + (Kc - 1) * conv_dim * elt   # state + tail
        tok_ops = 2 * nv * (3 * C * dk + 2 * C * dv + C * C + 3 * dk * dv)
        step_rec_ops = 8 * nv * dk * dv
    else:                                             # MiniMax
        C = cfg.block_size
        w_lin = hid * 3 * H * hd + 2 * H * hd * hid
        w_mlp = [3 * hid * cfg.intermediate_size * E + E * hid] * L
        rec = H * hd * hd * 4                        # the state, no tail
        tok_ops = H * (4 * min(C, S) * hd + 4 * hd * hd)
        step_rec_ops = 4 * H * hd * hd
    w_elems = sum((w_lin if lin[i] else w_full) + w_mlp[i] for i in range(L))
    row = hid * elt
    kv_tok = 2 * Hkv * hd * elt
    w_bytes = _weight_bytes(eng)
    pre_ops = (2 * B * S * w_elems + 2 * B * hid * V
               + 4 * B * H * hd * (S * (S + 1) // 2) * L_full
               + B * S * tok_ops * L_lin)
    pre_bytes = (w_bytes + B * S * row + L_full * B * S * kv_tok
                 + L_lin * B * rec)
    step_ops = (2 * B * (w_elems + hid * V)
                + 4 * B * H * hd * (S + 1) * L_full
                + B * step_rec_ops * L_lin)
    step_bytes = (w_bytes + B * row + L_full * B * (S + 1) * kv_tok
                  + 2 * L_lin * B * rec)
    return (max(pre_bytes / bw, pre_ops / flops_peak) * 1e3,
            max(step_bytes / bw, step_ops / flops_peak) * 1e3)


def _kernel_fns():
    from autoround_tpu_torch.ops.decode_attention import decode_attention
    from autoround_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from autoround_tpu_torch.ops.qmatmul import (w4a16_matmul,
                                                 w4a16_matmul_grouped)
    from autoround_tpu_torch.ops.qmatmul_ext import (fp8_matmul,
                                                     mxfp4_matmul,
                                                     w2a16_matmul,
                                                     w4a16_asym_matmul,
                                                     w8a16_matmul)
    from autoround_tpu_torch.ops.qmatmul_int8 import (w4a8_matmul,
                                                      w8a8_matmul)
    from autoround_tpu_torch.ops.sage_attention import sage_attention

    return {"flash_attention": flash_attention,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "w4a16_matmul": w4a16_matmul,
            "w4a16_matmul_grouped": w4a16_matmul_grouped,
            "w4a16_asym_matmul": w4a16_asym_matmul,
            "decode_attention": decode_attention,
            "w4a8_matmul": w4a8_matmul, "w8a8_matmul": w8a8_matmul,
            "w8a16_matmul": w8a16_matmul, "w2a16_matmul": w2a16_matmul,
            "fp8_matmul": fp8_matmul, "mxfp4_matmul": mxfp4_matmul,
            "sage_attention": sage_attention}


@contextlib.contextmanager
def plain_versions(attention=True):
    """Inside the block, every kernel wrapper the engine and the model call
    is its plain PyTorch version (on whatever device the tensors lie);
    with ``attention=False`` only the packed products are, and the two
    attention kernels stay."""
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.ops.decode_attention import decode_attention_plain
    from autoround_tpu_torch.ops.flash_attention import flash_attention_plain
    from autoround_tpu_torch.ops.qmatmul import (w4a16_matmul_grouped_plain,
                                                 w4a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_ext import (fp8_matmul_plain,
                                                     mxfp4_matmul_plain,
                                                     w2a16_matmul_plain,
                                                     w4a16_asym_matmul_plain,
                                                     w8a16_matmul_plain)
    from autoround_tpu_torch.ops.qmatmul_int8 import (w4a8_matmul_plain,
                                                      w8a8_matmul_plain)
    from autoround_tpu_torch.serve import engine

    patches = [
        (llama, "flash_attention",
         lambda q, k, v, causal=True: flash_attention_plain(q, k, v, causal)),
        (engine, "decode_attention", decode_attention_plain),
        (engine, "w4a16_matmul", w4a16_matmul_plain),
        (engine, "w4a16_matmul_grouped", w4a16_matmul_grouped_plain),
        (engine, "w4a16_asym_matmul", w4a16_asym_matmul_plain),
        (engine, "w4a8_matmul", w4a8_matmul_plain),
        (engine, "w8a8_matmul", w8a8_matmul_plain),
        (engine, "w8a16_matmul", w8a16_matmul_plain),
        (engine, "w2a16_matmul", w2a16_matmul_plain),
        (engine, "fp8_matmul", fp8_matmul_plain),
        (engine, "mxfp4_matmul", mxfp4_matmul_plain)]
    if not attention:
        patches = patches[2:]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def time_serving(eng, prompts, n_new, bw, flops_peak, int8_peak=None):
    """Time one prefill and the decode steps after it, print them beside
    their bounds and a profile; returns (prefill ms, median step ms)."""
    B, S = prompts.shape
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.time() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    tok = logits.argmax(-1).to(torch.int32)
    steps = []
    for _ in range(n_new - 1):
        t0 = time.time()
        logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
        steps.append((time.time() - t0) * 1e3)
        tok = logits.argmax(-1).to(torch.int32)
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    step_ms = statistics.median(steps)
    log(f"serve: prefill_ms={prefill_ms:.2f} (B={B} S={S}) "
        f"decode_step_ms_median={step_ms:.3f} "
        f"decode_tok_s={B / step_ms * 1e3:.1f} "
        f"(steps {min(steps):.3f}..{max(steps):.3f} ms)")
    pre_bound, step_bound = serve_bounds(eng, B, S, bw, flops_peak,
                                         int8_peak)
    log(f"serve bounds: prefill_bound_ms={pre_bound:.3f} "
        f"({'int8 OPs, attention bf16' if int8_peak else 'FLOPs'}) "
        f"decode_step_bound_ms={step_bound:.4f} (bytes, pos={S})")
    del cache, logits
    profile_serving(eng, prompts, prefill_ms, step_ms)
    return prefill_ms, step_ms


def check_copy(eng, prompts, reference, tol=COPY_ROW_TOL, attention=True,
               first=0, layers=2):
    """A 2-layer copy of the engine, 2 prompts, 8 greedy tokens: once through
    the kernels on the card, once through the plain versions — on the CPU
    (``reference="cpu"``) or, where the CPU would take minutes (MoE: every
    step dequantizes 2 x 24 expert matrices), on the card
    (``reference="card"``).  Step-1 logits must agree within ``tol`` and
    the greedy tokens must match.

    ``attention=False`` (card only) keeps the attention kernels in the
    reference run too.  The int8-activation kinds need it: the per-token
    quantizer rounds bf16 activations onto a grid whose step (1 / 127 of a
    row's amax) is about one bf16 ulp, so the bf16-level difference between
    an attention kernel and its plain version flips many codes and moves
    the logits by 0.26 of a row's RMS (measured, W4A8) whatever the
    products do; with the same attention on both sides the check holds the
    int8 products alone, which are exact.  ``first``: the copy's blocks
    start there (a DeepSeek copy that holds a dense and a MoE block);
    ``layers``: the copy's depth (1 for a one-layer engine)."""
    p2 = prompts[:2]
    gpu = copy_engine(eng, layers, "cuda", first)
    lg_gpu, _ = gpu.prefill(p2)
    tok_gpu = gpu.generate(p2, max_new_tokens=8).cpu()
    ref = gpu if reference == "card" else copy_engine(eng, layers, "cpu",
                                                      first)
    t0 = time.time()
    with plain_versions(attention) if reference == "card" \
            else contextlib.nullcontext():
        logits, cache = ref.prefill(p2)
        ref_logits = [logits.cpu()]
        tok_ref = [logits.argmax(-1).to(torch.int32)]
        for _ in range(7):
            logits, cache = ref.decode_step(tok_ref[-1], cache)
            ref_logits.append(logits.cpu())
            tok_ref.append(logits.argmax(-1).to(torch.int32))
    tok_ref = torch.stack(tok_ref, 1).cpu()
    t_ref = time.time() - t0
    err, rel = row_err(lg_gpu.cpu(), ref_logits[0])
    log(f"2-layer copy (plain versions on the {reference}): step-1 logits "
        f"max_abs_err={err:.4g} row_err={rel:.4g} (tol {tol}) "
        f"reference_s={t_ref:.1f}")
    check(rel <= tol, "2-layer copy: step-1 logits disagree")
    if not attention:
        # reported, not held: the same prefill with every kernel plain, so
        # that a drift of the flips' size shows from run to run
        with plain_versions(True):
            full, _ = ref.prefill(p2)
        err, rel = row_err(lg_gpu.cpu(), full.cpu())
        log(f"2-layer copy (attention plain too, not held): step-1 logits "
            f"max_abs_err={err:.4g} row_err={rel:.4g}")
    # greedy tokens: equal step by step; at the first step where they
    # differ (if any), the card's token must be a near-tie of the plain
    # choice — within the row tolerance of the plain maximum — and the
    # comparison stops there (the two sequences' contexts diverge)
    n_equal = 0
    for i, lg in enumerate(ref_logits):
        if torch.equal(tok_gpu[:, i], tok_ref[:, i]):
            n_equal = i + 1
            continue
        lg = lg.float()
        picked = lg.gather(1, tok_gpu[:, i:i + 1].long())[:, 0]
        gap = (lg.max(-1).values - picked) / lg.pow(2).mean(-1).sqrt()
        check(gap.max().item() <= tol,
              f"2-layer copy: step {i} card token is {gap.tolist()} row "
              f"RMS below the plain maximum (tol {tol})")
        break
    log(f"2-layer copy tokens: kernels {tok_gpu.tolist()} plain "
        f"{tok_ref.tolist()} equal for {n_equal} of {len(ref_logits)} steps")


# ----------------------------------------------------------- the decode loop
#
# ``generate_scan`` runs the decode loop as a replayed CUDA graph.  Its tokens
# must equal ``generate``'s (the same kernels, plans and order) and its
# launches ``generate``'s, which the paths hold to what their loops imply.

SCAN_REPLAYS = 32          # replays timed after a generate_scan call
SCAN_PROFILE_REPLAYS = 3   # replays under the profiler
EAGER_STEPS = 4            # eager decode steps timed beside them
SCAN_NEW = 16              # new tokens of the scan phase's own calls


def launch_counts():
    """{wrapper name: launches} over every kernel wrapper of the port."""
    from autoround_tpu_torch.ops._build import COUNTED
    return {f.__name__: f.launches for f in COUNTED}


@contextlib.contextmanager
def counts_kept():
    """Launches inside the block (timing, profiling) leave every count as
    it was."""
    from autoround_tpu_torch.ops._build import COUNTED
    saved = [(f, f.launches) for f in COUNTED]
    try:
        yield
    finally:
        for f, c in saved:
            f.launches = c


def generate_counted(eng, prompts, n_new, sampling=None, step_ms=None):
    """``eng.generate`` and the launches it made: (tokens, {name: count}).
    With a list ``step_ms``, each of its decode steps is synchronised and
    its host ms appended (the eager step of this call)."""
    c0 = launch_counts()
    if step_ms is not None:
        decode_step = eng.decode_step

        def timed(tok, cache):
            torch.cuda.synchronize()
            t0 = time.time()
            out = decode_step(tok, cache)
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
            return out
        eng.decode_step = timed
    try:
        toks = eng.generate(prompts, max_new_tokens=n_new, sampling=sampling)
    finally:
        if step_ms is not None:
            del eng.decode_step
    torch.cuda.synchronize()
    c1 = launch_counts()
    return toks, {n: c1[n] - c0[n] for n in c0}


def _scan_step(eng, B, sampling=None):
    how = (None if sampling is None or sampling.is_greedy
           else (sampling.temperature, sampling.top_k, sampling.top_p))
    return eng._scan_steps[(B, eng.kv_quant, how, eng.prefill_a8)]


def scan_against(eng, prompts, toks, gen_counts, label, sampling=None):
    """``generate_scan`` on the prompts ``generate`` ran (giving ``toks``
    and ``gen_counts``): equal tokens and equal launches, or the run fails.
    Returns (seconds of the call, graphs it captured)."""
    caps = eng.captures
    c0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    got = eng.generate_scan(prompts, max_new_tokens=toks.shape[1],
                            sampling=sampling)   # synchronises at its end
    secs = time.time() - t0
    c1 = launch_counts()
    diff = {n: (c1[n] - c0[n], gen_counts[n]) for n in c0
            if c1[n] - c0[n] != gen_counts[n]}
    check(torch.equal(got, toks), f"{label}: generate_scan tokens "
          f"{got.tolist()} differ from generate's {toks.tolist()}")
    check(not diff, f"{label}: generate_scan launches differ from "
          f"generate's (scan, generate): {diff}")
    return secs, eng.captures - caps


def eager_step_times(eng, prompts, n=EAGER_STEPS):
    """Host ms of n eager decode steps after a prefill (synchronised each)."""
    logits, cache = eng.prefill(prompts)
    tok = logits.argmax(-1).to(torch.int32)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        tok = logits.argmax(-1).to(torch.int32)
    return times


def replay_times(eng, B, n, sampling=None):
    """ms of each of n replays of the engine's captured step at batch B
    (CUDA events between replays), continuing from its last generate_scan."""
    step = _scan_step(eng, B, sampling)
    st = eng._scan_states[B]
    check(step.graph is not None, "replay_times: no graph captured")
    check(int(st.step) + n <= eng.max_seq
          and int(st.cache.pos.max()) + n <= eng.max_seq,
          "replay_times: the replays would pass max_seq")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(n):
        step.run(1)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]


def scan_path(eng, prompts, toks, gen_counts, label, eager=None):
    """A serving path's check of ``generate_scan`` (tokens and launches
    equal to ``generate``'s; the replayed launches measured, see
    :func:`profile_replays`) and its replayed step beside the eager step,
    both timed in this call (``eager``: the path's own median eager step
    ms, else 4 steps are timed here); returns (graph step ms, eager step
    ms)."""
    t0 = time.time()
    B = prompts.shape[0]
    secs, captured = scan_against(eng, prompts, toks, gen_counts, label)
    with counts_kept():
        if eager is None:
            eager = statistics.median(eager_step_times(eng, prompts, 4))
        graph = statistics.median(replay_times(eng, B, 16))
        prof = profile_replays(_scan_step(eng, B), label, n=2)
    log(f"{label} generate_scan: tokens and launches equal to generate's "
        f"(B={B}, {toks.shape[1]} new) generate_scan_s={secs:.3f} "
        f"captured={captured} capture_ms="
        f"{_scan_step(eng, B).capture_ms:.2f} graph_step_ms={graph:.4f} "
        f"eager_step_ms={eager:.4f}; replayed launches measured per step "
        f"{json.dumps(prof['launches'])}; scan_path_s={time.time() - t0:.1f}")
    return graph, eager


def _kernel_key(name: str) -> str:
    """The port's kernel a profiler's kernel name is ("w4a16<fmt>": the A16
    GEMV or GEMM of one weight format, "a8<w4>" / "a8<w8>": the int8 GEMV or
    GEMM, "quantize_rows", "decode split" / "decode combine", "flash"), or
    "torch" for PyTorch's own kernels."""
    m = re.search(r"w4a16::ge[mv]+_kernel<(\d)", name)
    if m:
        return f"w4a16<{m.group(1)}>"
    m = re.search(r"a8::(gemv_kernel<(true|false)|gemm_kernel<(\d))", name)
    if m:
        w4 = m.group(2) == "true" if m.group(2) else m.group(3) != "0"
        return "a8<w4>" if w4 else "a8<w8>"
    for key, k in (("quantize_rows_kernel", "quantize_rows"),
                   ("split_kernel<", "decode split"),
                   ("combine_kernel<", "decode combine"),
                   ("flash_fwd_kernel<", "flash")):
        if key in name:
            return k
    return "torch"


# The port's kernels one call of each wrapper that a decode step can reach
# launches (the A16 formats by csrc/w4a16_tiles.cuh's FMT: SYM4 0, ASYM4 1,
# INT8 2, INT2 3, E4M3 4, E2M1 5); wrappers that share a kernel add up.
WRAPPER_KERNELS = {
    "w4a16_matmul": ("w4a16<0>",), "w4a16_matmul_grouped": ("w4a16<0>",),
    "w4a16_asym_matmul": ("w4a16<1>",), "w8a16_matmul": ("w4a16<2>",),
    "w2a16_matmul": ("w4a16<3>",), "fp8_matmul": ("w4a16<4>",),
    "mxfp4_matmul": ("w4a16<5>",),
    "w4a8_matmul": ("quantize_rows", "a8<w4>"),
    "w8a8_matmul": ("quantize_rows", "a8<w8>"),
    "quantize_rows": ("quantize_rows",),
    "decode_attention": ("decode split", "decode combine"),
    "flash_attention": ("flash",)}


def _trace_busy(prof, after=None):
    """(kernel ms, span ms) of one profile: the union of its device
    kernels' intervals, and the time from the first kernel's start to the
    last one's end, both on the trace's own clock (the kernels that start
    at ``after`` or later if given)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "Command Buffer" not in e.name
                   and (after is None or e.time_range.start >= after))
    if not spans:
        return 0.0, 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy / 1e3, (max(b for _, b in spans) - spans[0][0]) / 1e3


# the marker between a profile's warm-up replay and its recorded ones: a
# ``torch.cuda._sleep`` spin kernel of about 30 us
MARK_CYCLES = 1 << 16


def _mark_end(prof):
    """The end of a profile's last marker kernel on the trace's clock, or
    None when the trace lost it."""
    from torch.autograd import DeviceType

    ends = [e.time_range.end for e in prof.events()
            if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name]
    return max(ends) if ends else None


def profile_replays(step, label, n=SCAN_PROFILE_REPLAYS):
    """torch.profiler over n replays of a captured step (a ``_StepReplay``):
    the port's kernels counted per replay must equal what the capture's
    launch counters imply (each wrapper's increase over the capture times
    ``WRAPPER_KERNELS``), so the replayed counts are measured on the card.
    Returns per step the kernel ms, the span ms (first kernel start to last
    kernel end, over n), busy = kernel / span from the same trace, kernel
    ms by family, the measured launches and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    check(step.graph is not None, f"{label}: no graph to profile")
    want = {}
    for fn, d in step.deltas:
        check(fn.__name__ in WRAPPER_KERNELS, f"{label}: no kernel table "
              f"for wrapper {fn.__name__} (WRAPPER_KERNELS)")
        for key in WRAPPER_KERNELS[fn.__name__]:
            want[key] = want.get(key, 0) + d * n
    # A trace has lost kernel records on an H100, from the start of its
    # window: all of them, many, or the first (the same one in three takes
    # running).  One replay goes first and a marker kernel after it; only
    # the kernels after the marker count.  A trace that still lost records
    # (or the marker) is taken again, and says so; the last one is held.
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step.run(1)
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(n):
                step.run(1)
            torch.cuda.synchronize()
        mark = _mark_end(prof)
        times = {} if mark is None else _kernel_times(prof, after=mark)
        fam, seen = {}, {}
        for name, (ms, k) in times.items():
            key = _kernel_key(name)
            fam[key] = fam.get(key, 0.0) + ms / n
            if key != "torch":
                seen[key] = seen.get(key, 0) + k
        if seen == want:
            break
        log(f"{label}: profile {attempt + 1} of the replays held the "
            f"port's kernels {seen}, not {want}: taken again")
    check(bool(times), f"{label}: the profiler saw no kernel of the graph")
    check(seen == want, f"{label}: the port's kernels in {n} replays "
          f"{seen} differ from the capture's counts x {n} {want}")
    kernel_ms, span_ms = _trace_busy(prof, after=mark)
    return dict(kernel_ms=kernel_ms / n, span_ms=span_ms / n,
                busy=kernel_ms / span_ms, fam=fam,
                launches={k: v // n for k, v in sorted(seen.items())},
                top=_top(times, n))


def scan_measure(eng, B, S, bw, flops_peak, int8_peak, seed, label,
                 n_new=SCAN_NEW, second=False, sampled=False, ran=None):
    """The scan phase at one batch size: ``generate_scan`` against
    ``generate`` (tokens, launches), the capture ms alone, the median
    replayed step ms (CUDA events over the replays), tok/s, the step's
    bound, the busy share (kernel time over the span of the same replays,
    both from one profile), the replayed launches measured by that profile
    and the step's top kernels, beside the eager step of this call (the
    median of ``generate``'s own decode steps, each synchronised).
    ``second``: a second call with new prompts must replay without a
    recapture; ``sampled``: temperature 0.7, top-p 0.95 must give
    ``generate``'s tokens.  ``ran`` = (prompts, eager step ms) of a path
    whose ``scan_path`` already held this batch's ``generate_scan``
    against ``generate`` in this call: that check and eager step are
    reused."""
    from autoround_tpu_torch import SamplingParams

    t0 = time.time()
    gen = torch.Generator().manual_seed(seed)
    if ran is None:
        prompts = torch.randint(0, eng.cfg.vocab_size, (B, S), generator=gen)
        eager = []
        toks, counts = generate_counted(eng, prompts, n_new, step_ms=eager)
        secs, captured = scan_against(eng, prompts, toks, counts, label)
    else:
        (prompts, eager_ms), secs, captured = ran, float("nan"), 0
        eager = [eager_ms]
    step = _scan_step(eng, B)
    with counts_kept():
        times = replay_times(eng, B, SCAN_REPLAYS)
        prof = profile_replays(step, f"{label} scan B={B}")
    med, eager_med = statistics.median(times), statistics.median(eager)
    bound = serve_bounds(eng, B, S, bw, flops_peak, int8_peak)[1]
    log(f"{label} scan B={B} S={S}: capture_ms={step.capture_ms:.2f} "
        f"(captured {captured}) generate_scan_s={secs:.3f} "
        f"graph_step_ms_median={med:.4f} (replays {min(times):.4f}.."
        f"{max(times):.4f}) tok_s={B / med * 1e3:.1f} "
        f"eager_step_ms_median={eager_med:.4f} eager_tok_s="
        f"{B / eager_med * 1e3:.1f} step_bound_ms={bound:.4f} "
        f"graph/bound={med / bound:.2f}")
    log(f"{label} scan B={B} profile (torch.profiler over "
        f"{SCAN_PROFILE_REPLAYS} replays): kernel_ms={prof['kernel_ms']:.4f} "
        f"of span_ms={prof['span_ms']:.4f} a step on the trace's clock, "
        f"busy_share={prof['busy']:.3f}; by family "
        + json.dumps({k: round(v, 4) for k, v in sorted(prof["fam"].items())})
        + f"; launches measured per step {json.dumps(prof['launches'])}"
        + f"; top per step: {prof['top']}")
    if second:
        new = torch.randint(0, eng.cfg.vocab_size, (B, S), generator=gen)
        toks2, counts2 = generate_counted(eng, new, n_new)
        caps = eng.captures
        scan_against(eng, new, toks2, counts2, label + " second call")
        check(eng.captures == caps, f"{label}: the second call recaptured")
        log(f"{label} scan B={B}: a second call with new prompts replayed "
            f"the same graph (captures {eng.captures}) with generate's "
            f"tokens")
    if sampled:
        sp = SamplingParams(temperature=0.7, top_p=0.95, seed=seed)
        toks3, counts3 = generate_counted(eng, prompts, n_new, sp)
        scan_against(eng, prompts, toks3, counts3, label + " sampled", sp)
        log(f"{label} scan B={B}: sampled (temperature 0.7, top-p 0.95, "
            f"seed {seed}) tokens equal to generate's")
    log(f"{label} scan B={B}: scan_measure_s={time.time() - t0:.1f}")
    return dict(B=B, capture_ms=step.capture_ms, step_ms=med,
                eager_step_ms=eager_med, bound_ms=bound, busy=prof["busy"])


FP8_COPY_SEQ = 128     # prompt tokens of the fp8 copy's reference


def fp8_kv_phase(eng, prompts, n_layers=4):
    """The fp8 KV cache: the first ``n_layers`` of a W4A16 engine with
    ``kv_quant="fp8"`` (sharing its packed weights): ``generate`` and
    ``generate_scan`` give equal tokens and launches, the cache is e4m3,
    and a 2-layer copy on the card holds its prefill and first decode
    step logits within ``COPY_ROW_TOL`` of the same copy on the plain
    versions on the card (on the CPU until the ernie / longcat / step35
    phase came: 14-17 s)."""
    t_phase = time.time()
    fp8 = dataclasses.replace(copy_engine(eng, n_layers, "cuda"),
                              kv_quant="fp8")
    NEW = 16
    toks, counts = generate_counted(fp8, prompts, NEW)
    scan_against(fp8, prompts, toks, counts, "fp8 kv")
    st = fp8._scan_states[prompts.shape[0]]
    check(st.cache.k.dtype == torch.float8_e4m3fn
          and st.cache.v.dtype == torch.float8_e4m3fn,
          f"fp8 kv: cache dtype {st.cache.k.dtype}")
    with counts_kept():
        eager = statistics.median(eager_step_times(fp8, prompts))
        graph = statistics.median(replay_times(fp8, prompts.shape[0], 16))
        prof = profile_replays(_scan_step(fp8, prompts.shape[0]), "fp8 kv",
                               n=2)
    p2 = prompts[:2, :FP8_COPY_SEQ]
    gpu = copy_engine(fp8, 2, "cuda")
    lg_gpu, c_gpu = gpu.prefill(p2)
    tok = lg_gpu.argmax(-1).to(torch.int32)
    step_gpu, _ = gpu.decode_step(tok, c_gpu)
    t0 = time.time()
    with plain_versions():
        lg_ref, c_ref = gpu.prefill(p2)
        step_ref, _ = gpu.decode_step(tok, c_ref)
    _, rel_pre = row_err(lg_gpu, lg_ref)
    _, rel_step = row_err(step_gpu, step_ref)
    log(f"fp8 kv llama3-8b W4A16 ({n_layers} layers, kv_quant fp8, e4m3 "
        f"cache): tokens and launches of generate_scan equal generate's "
        f"({prompts.shape[0]}x{NEW}), replayed launches measured per step "
        f"{json.dumps(prof['launches'])}; graph_step_ms={graph:.4f} "
        f"eager_step_ms={eager:.4f}; 2-layer copy against the plain "
        f"versions on the card: prefill "
        f"row_err={rel_pre:.4g} decode step row_err={rel_step:.4g} (2 x "
        f"{FP8_COPY_SEQ} prompt tokens; tol "
        f"{COPY_ROW_TOL}, reference_s={time.time() - t0:.1f}); "
        f"fp8_kv_s={time.time() - t_phase:.1f}")
    check(rel_pre <= COPY_ROW_TOL and rel_step <= COPY_ROW_TOL,
          "fp8 kv: the 2-layer copy disagrees with its plain versions")
    del fp8, gpu


# (prompt length, new tokens) of the batching phase: 12 requests over the
# buckets 16..256; the first 8 fill the batch, the rest join as slots free
BATCH_REQUESTS = [(16, 8), (200, 32), (64, 12), (31, 20), (256, 16),
                  (100, 24), (17, 10), (128, 32), (48, 8), (250, 12),
                  (90, 16), (20, 24)]


def batching_phase(eng, seed=21):
    """``ContinuousBatchingEngine`` over the engine (max_batch 8, max_seq
    1024): 12 requests of BATCH_REQUESTS, late joins and slot reuse.  Each
    request's prompt-pass logits and first decode step logits must be
    within ``COPY_ROW_TOL`` row error of the same prompt alone through
    ``prefill`` and ``decode_step`` at batch 1; prints the share of greedy
    tokens equal to batch 1's and the replayed step ms at 8 active
    slots."""
    from autoround_tpu_torch.serve import ContinuousBatchingEngine

    t_phase = time.time()
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, eng.cfg.vocab_size, (n,),
                             generator=gen).tolist()
               for n, _ in BATCH_REQUESTS]
    be = ContinuousBatchingEngine(eng, max_batch=8, max_seq=1024)
    first = {}          # rid → [prompt-pass logits, first step logits]
    joined = {}         # rid → slot, for requests that have not stepped yet
    waiting = list(range(len(BATCH_REQUESTS)))
    rid_of = {}
    step_ms_full, steps = [], 0
    t0 = time.time()
    while waiting or be.pending():
        while waiting and be._free:
            i = waiting.pop(0)
            rid = be.submit(prompts[i], max_new_tokens=BATCH_REQUESTS[i][1])
            rid_of[i] = rid
            joined[rid] = be._requests[rid].slot
            first[rid] = [be.last_logits[joined[rid]].float().cpu()]
        full = len(be._slot_req) == 8
        torch.cuda.synchronize()
        s0 = time.time()
        be.step()
        if full and be._decode.graph is not None and steps > 0:
            step_ms_full.append((time.time() - s0) * 1e3)
        steps += 1
        for rid, slot in joined.items():
            first[rid].append(be.last_logits[slot].float().cpu())
        joined.clear()
    run_s = time.time() - t0
    check(be._decode.graph is not None, "batching: the step was not captured")
    worst = 0.0
    agree = total = 0
    for i, (n, n_new) in enumerate(BATCH_REQUESTS):
        rid = rid_of[i]
        ids = torch.tensor([prompts[i]])
        logits, cache = eng.prefill(ids)
        tok = logits.argmax(-1).to(torch.int32)
        step_logits, _ = eng.decode_step(tok, cache)
        _, r0 = row_err(first[rid][0], logits[0].float().cpu())
        _, r1 = row_err(first[rid][1], step_logits[0].float().cpu())
        worst = max(worst, r0, r1)
        check(r0 <= COPY_ROW_TOL and r1 <= COPY_ROW_TOL,
              f"batching: request {i} (prompt {n}) logits row_err {r0:.4g} / "
              f"{r1:.4g} against batch 1 (tol {COPY_ROW_TOL})")
        got = be.result(rid)
        check(len(got) == n_new, f"batching: request {i} gave {len(got)} "
              f"tokens, asked {n_new}")
        want = eng.generate_scan(ids, max_new_tokens=n_new)[0].tolist()
        agree += sum(a == b for a, b in zip(got, want))
        total += n_new
    full_ms = (statistics.median(step_ms_full) if step_ms_full
               else float("nan"))
    log(f"batching llama3-8b W4A16 ({eng.cfg.num_layers} layers, max_batch "
        f"8, max_seq 1024): {len(BATCH_REQUESTS)} requests (prompts "
        f"{min(n for n, _ in BATCH_REQUESTS)}.."
        f"{max(n for n, _ in BATCH_REQUESTS)}, "
        f"{sum(k for _, k in BATCH_REQUESTS)} new tokens) in {steps} steps, "
        f"run_s={run_s:.2f}; prompt-pass and first-step logits vs batch 1: "
        f"worst row_err={worst:.4g} (tol {COPY_ROW_TOL}); greedy tokens "
        f"equal to batch 1's (generate_scan, whose tokens equal "
        f"generate's): {agree} of {total} ({agree / total:.3f}); "
        f"replayed step at 8 active slots (host, step() with its token "
        f"read-back): median {full_ms:.4f} ms over {len(step_ms_full)} "
        f"steps; capture_ms="
        f"{be._decode.capture_ms:.2f}")
    # where the batcher's step goes: its graph replayed with every slot
    # idle (the same kernels; idle slots only rewrite their next position)
    with counts_kept():
        prof = profile_replays(be._decode, "batching", n=4)
    log(f"batching step profile (4 graph replays, slots idle): kernel_ms="
        f"{prof['kernel_ms']:.4f} of span_ms={prof['span_ms']:.4f} a step, "
        f"busy_share={prof['busy']:.3f}; launches measured per step "
        f"{json.dumps(prof['launches'])}; top per step: {prof['top']}; "
        f"batching_s={time.time() - t_phase:.1f}")
    del be


def rtn_path(bw, flops_peak, n_layers):
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    on_path = ("flash_attention", "w4a16_matmul", "decode_attention")
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(1)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"rtn path llama3-8b ({n_layers} layers, random weights): "
        f"init_s={t_init:.2f}"
        f" quantize_s={t_quant:.2f} pack_s={t_pack:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f}")
    log(f"rtn path kernels {json.dumps(launches)}")
    for n in on_path:
        check(launches[n] > 0, f"kernel {n} was not launched on the rtn path")
    check(toks.shape == (B, NEW), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "tokens out of range")

    prefill_ms, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    # the plain versions on the card (on the CPU until the GLM phase came:
    # 45-70 s of the run's 1200 s limit)
    check_copy(eng, prompts, "card")
    scan_path(eng, prompts, toks, gen_counts, "rtn path", step_ms)
    # the scan phase: bench.py's configuration (batch 32, W4A16 g128, int8
    # KV) beside batch 1 and 8
    for b in (1, 8, 32):
        scan_measure(eng, b, S, bw, flops_peak, None, seed=30 + b,
                     label="rtn", second=b == 8, sampled=b == 8,
                     ran=(prompts, step_ms) if b == B else None)
    free_device_memory()
    fp8_kv_phase(eng, prompts)
    free_device_memory()
    batching_phase(eng)
    return launches, dict(quantize_s=t_quant, prefill_ms=prefill_ms,
                          decode_step_ms=step_ms, peak_mem_gb=peak_gb)


# Gradients of the tuning loss of one full-width block w.r.t. the tuned
# leaves, flash kernels (forward + backward) against the plain attention
# under autograd, both on the card in bf16.  The two attentions differ by
# bf16 rounding; the loss gradient carries that through the block, and a
# scale's gradient is a sum of rounding residues of random sign, so its rows
# are noisier than those of v.  Over the seven linears, measured on an H100:
# least share of equal signs 0.9937 (v), 0.9951 (scales); worst row error
# 0.17 (v), 0.20 (min_scale), 0.28 (max_scale).  Limits: about 3x the
# measured share of unequal signs, about 3x the row error.
GRAD_ROW_FLOOR = 0.01
GRAD_LIMITS = {          # kind: (least share of equal signs, row err limit)
    "v": (0.98, 0.5),
    "min_scale": (0.985, 0.6),
    "max_scale": (0.985, 0.85),
}


def tuning_step_phase(bw, flops_peak):
    """Gradient check and the time of one tuning step on one full-width
    llama3-8b block with a batch of 8 x 512."""
    from torch.profiler import ProfilerActivity, profile

    from autoround_tpu_torch.algorithms.signround import (
        TuneConfig, init_tune_params, make_qdq_weights, mse_loss, tune_block)
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.ops.flash_attention import flash_attention_plain
    from autoround_tpu_torch.schemes import parse_scheme

    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"], num_layers=1)
    B, S, NS = 8, 512, 16
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    block = params["blocks"][0]
    ids = torch.randint(0, cfg.vocab_size, (NS, S),
                        generator=torch.Generator().manual_seed(2)).cuda()
    cos, sin = llama.rope_tables(cfg, S, device="cuda")

    def block_fn(w, xb):
        return llama.block_fwd(w, xb, cos, sin, cfg)

    with torch.no_grad():
        x = llama.embed_fwd(params, ids, cfg)
        ref = torch.cat([block_fn(block, x[i:i + B])
                         for i in range(0, NS, B)])
    del params
    schemes = {n: parse_scheme("W4A16") for n in llama.LINEAR_KEYS}
    tcfg = TuneConfig(iters=20, batch_size=B)

    def grads():
        tp = init_tune_params(block, schemes, tcfg)
        leaves = [t.requires_grad_(True) for lp in tp.values()
                  for t in lp.values()]
        with torch.enable_grad():
            out = block_fn(make_qdq_weights(block, tp, schemes, tcfg), x[:B])
            loss = mse_loss(out, ref[:B]) * tcfg.loss_scale
            g = torch.autograd.grad(loss, leaves)
        it = iter(g)
        return loss.item(), {n: {k: next(it) for k in lp}
                             for n, lp in tp.items()}

    loss_k, g_kernel = grads()
    routed = llama.flash_attention
    llama.flash_attention = lambda q, k, v, causal=True: \
        flash_attention_plain(q, k, v, causal)
    try:
        loss_p, g_plain = grads()
    finally:
        llama.flash_attention = routed
    torch.cuda.synchronize()
    check(abs(loss_k - loss_p) <= 0.02 * abs(loss_p),
          f"gradient check: loss {loss_k} (kernels) vs {loss_p} (plain)")
    for kind, (min_sign, max_row) in GRAD_LIMITS.items():
        agree, rel = [], []
        for n in g_plain:
            a, b = g_kernel[n][kind], g_plain[n][kind]
            nz = b != 0
            agree.append((torch.sign(a)[nz] == torch.sign(b)[nz])
                         .float().mean().item())
            rel.append(row_err(a, b, GRAD_ROW_FLOOR)[1])
        log(f"gradient check {kind}: loss kernels={loss_k:.6f} "
            f"plain={loss_p:.6f}; equal signs, least layer "
            f"{min(agree):.4f} (limit {min_sign}) per layer "
            f"{json.dumps([round(a, 4) for a in agree])}; row_err worst "
            f"layer {max(rel):.4g} (limit {max_row}, row floor "
            f"{GRAD_ROW_FLOOR}) per layer "
            f"{json.dumps([round(r, 4) for r in rel])}")
        check(min(agree) >= min_sign and max(rel) <= max_row,
              f"gradient check {kind}: signs {min(agree)} row err {max(rel)}")
    del g_kernel, g_plain

    # one tuning step: long run minus short run over the extra steps
    def run(iters):
        torch.cuda.synchronize()
        t0 = time.time()
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=iters))
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3
    run(2)                                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    steps = sorted((run(8) - run(2)) / 6 for _ in range(3))
    step_ms = steps[1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_w = sum(block[n].numel() for n in schemes)
    valid = S * (S + 1) // 2
    attn = (4 + 14) * B * cfg.num_heads * valid * cfg.hd
    t_f = (3 * 2 * n_w * B * S + attn) / flops_peak * 1e3
    t_b = n_w * (2 + 4 + 4) / bw * 1e3
    log(f"tuning step (1 block, B={B} S={S}, W4A16 g128): tune_step_ms="
        f"{step_ms:.2f} (3 runs {steps[0]:.2f}..{steps[2]:.2f}) "
        f"tune_step_bound_ms={max(t_f, t_b):.3f} (operations {t_f:.3f}, "
        f"bytes of one qdq pass over W, v, grad {t_b:.3f}) "
        f"peak_mem_gb={peak_gb:.2f}")
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=n))
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values()) / n
    family = {"flash kernels": 0.0, "pytorch elementwise and reductions": 0.0,
              "matrix products and the rest": 0.0}
    for kname, (ms, _) in times.items():
        key = ("flash kernels" if "flash_" in kname else
               "pytorch elementwise and reductions" if "at::native" in kname
               else "matrix products and the rest")
        family[key] += ms / n
    log(f"profile tuning step: kernel_ms={total:.2f} of tune_step_ms="
        f"{step_ms:.2f} busy_share={total / step_ms:.3f}; ms per step by "
        f"family {json.dumps({k: round(v, 3) for k, v in family.items()})}; "
        f"top per step: " + _top(times, n))
    return step_ms


class _HeadLosses(logging.Handler):
    """Collects (first, best) of the orchestrator's lm_head log record."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = None

    def emit(self, record):
        if str(record.msg).startswith("lm_head: loss"):
            self.losses = tuple(float(a) for a in record.args)


def tune_path(n_layers):
    """SignRound → pack → serve at llama3-8b width; returns the launches
    and the seconds of the quantize call (tune_s)."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(3)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    head = _HeadLosses()
    pkg_log = logging.getLogger("autoround_tpu_torch")
    pkg_log.addHandler(head)
    pkg_log.setLevel(logging.INFO)
    t0 = time.time()
    try:
        ar = AutoRound((params, cfg), scheme="W4A16", iters=ITERS,
                       batch_size=B, quant_lm_head=True, donate_params=True,
                       cache_batch=CB)
        del params
        result = ar.quantize(calib)
        torch.cuda.synchronize()
    finally:
        pkg_log.removeHandler(head)
    t_tune = time.time() - t0
    traces = result.loss_traces
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    first = [float(traces[b][0]) for b in range(n_layers)]
    best = [float(traces[b].min()) for b in range(n_layers)]
    n_better = sum(b < f for b, f in zip(best, first))
    log(f"tune path llama3-8b ({n_layers} layers + lm_head, random weights, "
        f"{NS} x {S} ids, iters={ITERS}, batch {B}): tune_s={t_tune:.2f} "
        f"pack_s={t_pack:.2f} generate_s={t_gen:.2f} "
        f"peak_mem_gb={peak_gb:.2f}")
    log("tune path losses (first -> best per block): "
        + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best))
        + f"; lm_head {head.losses}; best < first in {n_better} of "
        f"{n_layers} blocks")
    log(f"tune path kernels {json.dumps(launches)}")
    check(len(traces) == n_layers and all(
        len(traces[b]) == ITERS and bool((traces[b] == traces[b]).all())
        and bool(abs(traces[b]).max() < float("inf"))
        for b in range(n_layers)), "tune path: a loss is missing or not finite")
    check(all(b <= f for b, f in zip(best, first)),
          "tune path: a block's best loss is above its first")
    check(4 * n_better >= 3 * n_layers,
          f"tune path: best < first in only {n_better} of {n_layers} blocks")
    check(head.losses is not None and head.losses[1] <= head.losses[0]
          and head.losses[0] < float("inf"),
          f"tune path: lm_head losses {head.losses}")
    # per block: the FP chain and the quantized chain each run NS / CB
    # forwards, every tuning step one forward and one backward; generate's
    # prefill adds one forward per layer
    fwd = n_layers * (2 * (NS // CB) + ITERS) + n_layers
    bwd = n_layers * ITERS
    want = {"flash_attention": fwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd}
    for n, c in want.items():
        check(launches[n] == c,
              f"tune path: {n} launched {launches[n]} times, the loop "
              f"implies {c}")
    for n in ("w4a16_matmul", "decode_attention"):
        check(launches[n] > 0, f"kernel {n} was not launched on the tune path")
    check(toks.shape == (B, NEW), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "tokens out of range")
    scan_path(eng, prompts, toks, gen_counts, "tune path")
    del eng
    torch.cuda.empty_cache()
    return launches, t_tune


# Prefill logits (last position, 8 prompts) of the MoE engine through capacity
# dispatch with factor E / top_k (C = N, nothing drops) against the default
# dense-then-mask route.  The grouped kernel gives a token's row the same
# bits in whatever slab and row it sits, and the two routes share one
# combine, so the logits are expected to be equal; the limit is far below
# what a wrong dispatch gives (a token sent to another expert, dropped or
# weighted wrongly moves its row by order 1) and leaves room for one bf16
# ulp.  (With another summation order in the combine alone, last-bit
# differences in fp32 flip top-k near-ties of the random router in later
# blocks and the row error grows with depth: 0.025 at 2 blocks, 0.061 at 6,
# measured on an H100.)  Same row measure as above.
CAPACITY_ROW_TOL = 0.01


def _serve_counts(n_layers, forwards, decode_steps, per_block, head=True):
    """Launches an RTN run on one calibration batch and one ``generate``
    imply: ``per_block`` packed projections per block per forward (+ the
    lm_head), flash once per block in the calibration forward and once in
    prefill, decode attention once per block per decode step."""
    return dict(matmul=(per_block * n_layers + (1 if head else 0)) * forwards,
                flash_attention=2 * n_layers,
                decode_attention=n_layers * decode_steps)


def _check_tokens(toks, B, n_new, vocab):
    check(toks.shape == (B, n_new), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < vocab)).all()), "tokens out of range")


def moe_path(bw, flops_peak, n_layers):
    """RTN → stack → serve at mixtral-8x7b width; returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import mixtral

    kernels = _kernel_fns()
    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(4)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    def stage_peak():
        """Peak memory since the last call, in GB."""
        gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        return gb

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    peaks_gb = {"quantize": stage_peak()}
    check(len(result.layers) == n_layers * (4 + 3 * cfg.num_experts) + 1,
          f"moe path: {len(result.layers)} quantized layers")
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    peaks_gb["pack"] = stage_peak()
    for i in range(n_layers):
        stacked = sorted(k for k in eng.packed
                         if k.startswith(f"blocks.{i}.experts_stack."))
        check(stacked == [f"blocks.{i}.experts_stack.w{j}" for j in (1, 2, 3)],
              f"moe path: block {i} stacked {stacked}")
    check(not any(".experts." in k for k in eng.packed),
          "moe path: a per-expert entry is left beside the stacks")
    check(eng.moe_capacity_factor == 0.0, "moe path: default routing")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peaks_gb["generate"] = stage_peak()
    torch.cuda.empty_cache()
    log(f"moe path mixtral-8x7b ({n_layers} of 32 layers, random weights, "
        f"E={cfg.num_experts} top_k={cfg.top_k}): init_s={t_init:.2f} "
        f"quantize_s={t_quant:.2f} pack_s={t_pack:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={max(peaks_gb.values()):.2f} "
        f"(by stage {json.dumps({k: round(v, 2) for k, v in peaks_gb.items()})}) "
        f"resident_after_pack_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
    log(f"moe path kernels {json.dumps(launches)}")
    # per block and forward: qkv + o_proj through the ungrouped kernel,
    # w1 / w3 / w2 of all experts through 3 grouped launches
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=2)
    want["w4a16_matmul"] = want.pop("matmul")
    want["w4a16_matmul_grouped"] = 3 * n_layers * NEW
    want.update(w4a16_asym_matmul=0, flash_attention_bwd_dq=0,
                flash_attention_bwd_dkv=0)
    for n, c in want.items():
        check(launches[n] == c, f"moe path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)

    # capacity dispatch with C = N on the same packed weights
    factor = cfg.num_experts / cfg.top_k
    cap = dataclasses.replace(eng, moe_capacity_factor=factor)
    before = kernels["w4a16_matmul_grouped"].launches
    lg_dense, _ = eng.prefill(prompts)
    lg_cap, _ = cap.prefill(prompts)
    torch.cuda.synchronize()
    check(kernels["w4a16_matmul_grouped"].launches - before
          == 2 * 3 * n_layers, "moe path: capacity route left the grouped "
          "kernel")
    err, rel = row_err(lg_cap, lg_dense)
    log(f"moe capacity route (factor {factor}, C = N = {B * S}): prefill "
        f"logits vs dense-then-mask max_abs_err={err:.4g} row_err={rel:.4g} "
        f"(tol {CAPACITY_ROW_TOL}), argmax equal "
        f"{int((lg_cap.argmax(-1) == lg_dense.argmax(-1)).sum())} of {B}")
    check(bool(torch.isfinite(lg_cap).all()) and rel <= CAPACITY_ROW_TOL,
          "moe path: capacity-route logits disagree with the default route")
    t0 = time.time()
    cap.prefill(prompts)
    torch.cuda.synchronize()
    log(f"moe capacity route: prefill_ms={(time.time() - t0) * 1e3:.2f}")
    del cap, lg_dense, lg_cap

    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card", MOE_COPY_ROW_TOL)
    scan_path(eng, prompts, toks, gen_counts, "moe path", step_ms)
    scan_measure(eng, B, S, bw, flops_peak, None, seed=40, label="moe",
                 ran=(prompts, step_ms))
    del eng
    torch.cuda.empty_cache()
    return launches


def moe_tuning_step(bw, flops_peak):
    """Time, peak memory and profile of one SignRound step on one full-width
    Mixtral block (4 + 3 x 8 linears, dense-then-mask), batch 8 x 512."""
    from torch.profiler import ProfilerActivity, profile

    from autoround_tpu_torch.algorithms.signround import TuneConfig, tune_block
    from autoround_tpu_torch.models import llama, mixtral
    from autoround_tpu_torch.schemes import parse_scheme
    from autoround_tpu_torch.utils.pytree import get_by_path

    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=1)
    B, S = 8, 512
    torch.cuda.empty_cache()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    block = params["blocks"][0]
    ids = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(5)).cuda()
    cos, sin = llama.rope_tables(cfg, S, device="cuda")

    def block_fn(w, xb):
        return mixtral.block_fwd(w, xb, cos, sin, cfg)

    with torch.no_grad():
        x = llama.embed_fwd(params, ids, cfg)
        ref = block_fn(block, x)
    del params
    schemes = {n: parse_scheme("W4A16")
               for n in mixtral.block_linear_names(cfg)}
    tcfg = TuneConfig(iters=20, batch_size=B)

    def run(iters):
        torch.cuda.synchronize()
        t0 = time.time()
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=iters))
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    run(1)                                       # warm-up; the peak of a step
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = (run(5) - run(2)) / 3
    n_w = sum(get_by_path(block, n).numel() for n in schemes)
    n_exp_w = 3 * cfg.num_experts * cfg.hidden_size * cfg.intermediate_size
    attn = (4 + 14) * B * cfg.num_heads * (S * (S + 1) // 2) * cfg.hd
    # dense-then-mask: every expert's three products for all B * S tokens
    t_f = (3 * 2 * n_w * B * S + attn) / flops_peak * 1e3
    t_b = n_w * (2 + 4 + 4) / bw * 1e3
    log(f"moe tuning step (1 mixtral-8x7b block, {len(schemes)} linears, "
        f"{n_w / 1e9:.3f}e9 weights of which experts {n_exp_w / 1e9:.3f}e9, "
        f"B={B} S={S}, W4A16 g128): tune_step_ms={step_ms:.2f} "
        f"tune_step_bound_ms={max(t_f, t_b):.3f} (operations {t_f:.3f}, "
        f"bytes of one qdq pass over W, v, grad {t_b:.3f}) "
        f"peak_mem_gb={peak_gb:.2f}")
    n = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tune_block(block_fn, block, x, ref, schemes,
                   dataclasses.replace(tcfg, iters=n))
        torch.cuda.synchronize()
    times = _kernel_times(prof)
    total = sum(ms for ms, _ in times.values()) / n
    family = {"flash kernels": 0.0, "pytorch elementwise and reductions": 0.0,
              "matrix products and the rest": 0.0}
    for kname, (ms, _) in times.items():
        key = ("flash kernels" if "flash_" in kname else
               "pytorch elementwise and reductions" if "at::native" in kname
               else "matrix products and the rest")
        family[key] += ms / n
    log(f"profile moe tuning step: kernel_ms={total:.2f} of tune_step_ms="
        f"{step_ms:.2f} busy_share={total / step_ms:.3f}; ms per step by "
        f"family {json.dumps({k: round(v, 3) for k, v in family.items()})}; "
        f"top per step: " + _top(times, n))


def moe_tune_path(n_layers):
    """SignRound → stack → serve at mixtral-8x7b width."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import mixtral

    kernels = _kernel_fns()
    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(6)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=ITERS, batch_size=B,
                   donate_params=True, cache_batch=CB)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_tune = time.time() - t0
    traces = result.loss_traces
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    toks = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = [float(traces[b][0]) for b in range(n_layers)]
    best = [float(traces[b].min()) for b in range(n_layers)]
    log(f"moe tune path mixtral-8x7b ({n_layers} of 32 layers, random "
        f"weights, {NS} x {S} ids, iters={ITERS}, batch {B}): "
        f"tune_s={t_tune:.2f} peak_mem_gb={peak_gb:.2f}; losses (first -> "
        f"best per block): "
        + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best)))
    log(f"moe tune path kernels {json.dumps(launches)}")
    check(len(traces) == n_layers and all(
        len(traces[b]) == ITERS and bool(abs(traces[b]).max() < float("inf"))
        and bool((traces[b] == traces[b]).all()) for b in range(n_layers)),
        "moe tune path: a loss is missing or not finite")
    check(all(b < f for b, f in zip(best, first)),
          "moe tune path: a block's best loss is not below its first")
    fwd = n_layers * (2 * (NS // CB) + ITERS) + n_layers
    want = {"flash_attention": fwd, "flash_attention_bwd_dq": n_layers * ITERS,
            "flash_attention_bwd_dkv": n_layers * ITERS,
            "w4a16_matmul_grouped": 3 * n_layers * NEW,
            "w4a16_matmul": 2 * n_layers * NEW,      # the lm_head stays dense
            "decode_attention": n_layers * (NEW - 1)}
    for n, c in want.items():
        check(launches[n] == c, f"moe tune path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    del eng
    torch.cuda.empty_cache()


def asym_path(n_layers):
    """int4 asym RTN → the w4a16_asym engine → serve at llama3-8b width;
    returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(7)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    scheme = dict(bits=4, group_size=128, sym=False, data_type="int")
    ar = AutoRound((params, cfg), scheme=scheme, iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    zp = result.layers["blocks.0.q_proj"].zp
    check(zp is not None and float(zp.min()) >= 0 and float(zp.max()) <= 15,
          "asym path: zero points missing or out of range")
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    check(set(eng.packed_kinds.values()) == {"w4a16_asym"}
          and len(eng.packed) == 4 * n_layers + 1
          and all(len(e) == 3 for e in eng.packed.values()),
          f"asym path: packed kinds {sorted(set(eng.packed_kinds.values()))}")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    log(f"asym path llama3-8b ({n_layers} layers, random weights, int4 asym "
        f"g128): generate_s={t_gen:.2f}")
    log(f"asym path kernels {json.dumps(launches)}")
    # per block and forward: qkv, o_proj, gate_up, down_proj
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=4)
    want["w4a16_asym_matmul"] = want.pop("matmul")
    want.update(w4a16_matmul=0, w4a16_matmul_grouped=0)
    for n, c in want.items():
        check(launches[n] == c, f"asym path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    check_copy(eng, prompts, "card")
    scan_path(eng, prompts, toks, gen_counts, "asym path")
    del eng
    torch.cuda.empty_cache()
    return launches


# The static int8 activation scheme of the a8 tune path: W4A8's fields with
# one static scale per layer (amax of the FP pass / 127) instead of a dynamic
# per-tensor one.
STATIC_W4A8 = dict(bits=4, group_size=128, sym=True, data_type="int",
                   act_bits=8, act_group_size=0, act_sym=True,
                   act_data_type="int", act_dynamic=False)


# preset → (serving kind, the wrapper that kind launches)
SERVE_KINDS = {"W4A8": ("w4a8", "w4a8_matmul"), "W8A8": ("w8a8", "w8a8_matmul"),
               "W8A16": ("w8a16", "w8a16_matmul"),
               "W2A16": ("w2a16", "w2a16_matmul"),
               "FP8_STATIC": ("fp8", "fp8_matmul"),
               "MXFP4": ("mxfp4_g32", "mxfp4_matmul"),
               "NVFP4": ("mxfp4_g16", "mxfp4_matmul")}


def serve_path(bw, flops_peak, int8_peak, scheme, n_layers, seed):
    """RTN with a preset that serves through a kind of its own (the 8-bit,
    2-bit and float presets) → that kind → serve at llama3-8b width;
    returns the launches.  The float presets quantize their activations in
    calibration only and serve weight-only, with bf16 activations."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama, parse_scheme
    from autoround_tpu_torch.models import llama

    kind, kernel = SERVE_KINDS[scheme]
    sch = parse_scheme(scheme)
    act = sch.is_act_quantized              # an amax pass in calibration
    int8_act = kind in ("w4a8", "w8a8")     # int8 activations in serving
    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme=scheme, iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    for n, q in result.layers.items():
        block = n != "lm_head"
        check((q.act_scale is not None) == (block and act
                                            and not sch.act_dynamic)
              and (q.act_global_scale is not None)
              == (block and (sch.act_data_type or "").startswith("nv_fp")),
              f"{scheme} path: {n} act scales {q.act_scale} "
              f"{q.act_global_scale}")
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    pack_gb = torch.cuda.max_memory_allocated() / 1e9
    del ar, result
    torch.cuda.reset_peak_memory_stats()
    check(set(eng.packed_kinds.values()) == {kind}
          and len(eng.packed) == 4 * n_layers + 1,
          f"{scheme} path: packed kinds "
          f"{sorted(set(eng.packed_kinds.values()))}, {len(eng.packed)} "
          f"entries")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    gen_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_gb = max(quant_gb, pack_gb, gen_gb)
    log(f"{scheme} path llama3-8b ({n_layers} layers, random weights, kind "
        f"{kind}): quantize_s={t_quant:.2f} pack_s={t_pack:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f} (quantize "
        f"{quant_gb:.2f}, pack {pack_gb:.2f}, generate {gen_gb:.2f})")
    log(f"{scheme} path kernels {json.dumps(launches)}")
    # per block and forward: qkv, o_proj, gate_up, down_proj; an
    # act-quantized scheme adds the amax pass over the FP block (flash once
    # more per block)
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=4)
    want[kernel] = want.pop("matmul")
    if act:
        want["flash_attention"] += n_layers
    for n in kernels:
        want.setdefault(n, 0)
    for n, c in want.items():
        check(launches[n] == c, f"{scheme} path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak,
                              int8_peak if int8_act else None)
    check_copy(eng, prompts, "card", attention=not int8_act)
    scan_path(eng, prompts, toks, gen_counts, f"{scheme} path", step_ms)
    if int8_act:
        for b in (1, 8):
            scan_measure(eng, b, S, bw, flops_peak, int8_peak,
                         seed=seed + 50 + b, label=scheme,
                         ran=(prompts, step_ms) if b == B else None)
    del eng
    torch.cuda.empty_cache()
    return launches, peak_gb


def llama1b_path(bw, flops_peak, n_layers, group_size, seed, keep=False):
    """llama3.2-1b at full width (hidden 2048, 32 heads, 8 kv heads, head
    dim 64, tied embeddings), RTN W4A16 at ``group_size`` with the lm_head
    quantized → engine → ``generate`` (8 x 512 prompts, 32 new tokens)
    with the int8 KV cache, whose every decode step runs the decode kernel
    at hd 64.  The prompt passes take the plain attention: the flash gate
    needs hd 128 or 256, as the JAX model's needs hd % 128 == 0.  Every
    quantized layer must serve packed (g = 16 too), the launch counts equal
    what the loops imply; timings, and a 2-layer copy against the plain
    versions on the card; returns the launches and, with ``keep``, the
    result, config, engine and prompts for the load phase (else None)."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3.2-1b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    scheme = dict(bits=4, group_size=group_size, sym=True, data_type="int")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme=scheme, iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    kept = (result, cfg, eng, prompts) if keep else None
    del ar, result
    dense = _dense_linears(eng)
    check(not dense and set(eng.packed_kinds.values()) == {"w4a16"}
          and len(eng.packed) == 4 * n_layers + 1,
          f"llama3.2-1b g{group_size}: dense layers {dense}, packed kinds "
          f"{sorted(set(eng.packed_kinds.values()))}, {len(eng.packed)} "
          f"entries")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"llama3.2-1b path ({n_layers} layers, random weights, W4A16 "
        f"g{group_size}, hd {cfg.hd}): quantize_s={t_quant:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f} dense_layers=0")
    log(f"llama3.2-1b g{group_size} path kernels {json.dumps(launches)}")
    want = _serve_counts(n_layers, NEW, NEW - 1, per_block=4)
    want["w4a16_matmul"] = want.pop("matmul")
    want["flash_attention"] = 0              # hd 64: plain prompt attention
    for n in kernels:
        want.setdefault(n, 0)
    for n, c in want.items():
        check(launches[n] == c, f"llama3.2-1b g{group_size} path: {n} "
              f"launched {launches[n]} times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card")
    label = f"llama3.2-1b g{group_size}"
    scan_path(eng, prompts, toks, gen_counts, label + " path", step_ms)
    if group_size == 128:
        for b in (1, 8):
            scan_measure(eng, b, S, bw, flops_peak, None, seed=seed + 60 + b,
                         label=label, ran=(prompts, step_ms) if b == B
                         else None)
    del eng
    torch.cuda.empty_cache()
    return launches, kept


# ------------------------------------------------------- the Llama family
#
# Four public configurations of the family flags at full width, random
# weights from a seed with every norm gain and bias moved off its initial
# value, W4A16 g128 with the lm_head quantized, the int8 KV cache, greedy.
# preset: (batch, prompt tokens, max_seq, what the path holds on the card)
FAMILY_PATHS = {
    "qwen2.5-7b": (8, 512, 1024, "q/k/v biases after the fused qkv GEMV, "
                   "G = 7 through flash (prefill) and decode"),
    "qwen3-4b": (8, 512, 1024, "qk-norm inside the tuning loss through "
                 "flash forward and backward, G = 4, tied lm_head"),
    "gemma2-2b": (8, 512, 1024, "attention softcap (plain prefill, decode "
                  "kernel), final softcap after the packed lm_head, "
                  "GeGLU, sandwich norms, embed scale, hd 256"),
    "gemma3-12b": (2, 1280, 2048, "the 1024 window biting at prefill (the "
                   "sliding mask) and at every decode step (the decode "
                   "kernel's window), local / global rope, qk-norm with "
                   "the norm offset, hd 256"),
}
FAMILY_NEW = 32


def perturb_gains(params, seed):
    """Move every 1-D leaf (norm gains, q/k norms, biases) of the blocks
    and the final norm by N(0, 0.1), from a seeded generator on the card,
    so each of them counts in the run; MiniMax's ``slope_rate`` is a decay
    rate, not a gain, and stays."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def move(t):
        t.add_(torch.randn(t.shape, generator=gen, device=t.device,
                           dtype=t.dtype), alpha=0.1)

    move(params["norm"])
    for b in params["blocks"]:
        for k, t in b.items():
            if (isinstance(t, torch.Tensor) and t.ndim == 1
                    and k != "slope_rate"):
                move(t)


def _attended(cfg, S):
    """Keys each decode query at position S sees, summed over the layers
    (a sliding layer sees at most its window; a chunked layer the keys of
    its chunk so far, position r sees r % w + 1), and the same summed over
    a causal prefill of S rows."""
    from autoround_tpu_torch.models import llama

    step = prefill = 0
    for i in range(cfg.num_layers):
        w = (cfg.sliding_window if llama.layer_is_sliding(cfg, i)
             else None) or S + 1
        if cfg.chunked_attention and w <= S:
            step += S % w + 1
            full, part = divmod(S, w)
            prefill += full * w * (w + 1) // 2 + part * (part + 1) // 2
            continue
        step += min(S + 1, w)
        n = min(S, w)                    # rows r < w see r + 1 keys
        prefill += n * (n + 1) // 2 + (S - n) * w
    return step, prefill


def family_path(bw, flops_peak, preset, n_layers, seed, iters=0):
    """RTN (or SignRound with ``iters``) W4A16 g128, the lm_head quantized,
    at the full width of a Llama-family preset and ``n_layers`` of its
    depth → the int8-KV engine → ``generate`` (32 new tokens); launch
    counts equal what the loops imply, the 2-layer copy against the plain
    versions on the card, ``generate_scan`` against ``generate``; the main
    path (qwen2.5-7b) is timed and its replayed step measured at batch 1
    and 8.  Returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    t_path = time.time()
    B, S, max_seq, holds = FAMILY_PATHS[preset]
    NEW, NS, CB = FAMILY_NEW, 16 if iters else B, 8
    kernels = _kernel_fns()
    full = llama.CONFIG_PRESETS[preset]
    cfg = dataclasses.replace(full, num_layers=n_layers)
    ids_gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    perturb_gains(params, seed)
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=iters,
                   batch_size=B, quant_lm_head=True, donate_params=True,
                   cache_batch=CB)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    traces = result.loss_traces
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=max_seq,
                                              kv_quant="int8")
    del ar, result
    dense = _dense_linears(eng)
    check(not dense and set(eng.packed_kinds.values()) == {"w4a16"}
          and len(eng.packed) == 4 * n_layers + 1,
          f"{preset} path: dense layers {dense}, packed kinds "
          f"{sorted(set(eng.packed_kinds.values()))}, {len(eng.packed)} "
          f"entries")
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    sliding = [i for i in range(n_layers) if llama.layer_is_sliding(cfg, i)]
    flash = (hd % 128 == 0 and S >= 512 and S % 256 == 0
             and not cfg.attn_logit_softcap and cfg.attn_scale is None)
    log(f"{preset} path ({n_layers} of {full.num_layers} layers, full "
        f"width: hidden {cfg.hidden_size}, {nh} / {nkv} heads (G = "
        f"{nh // nkv}), hd {hd}, inter {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}; random weights, gains and biases moved; "
        f"{'SignRound iters=%d' % iters if iters else 'RTN'} W4A16 g128, "
        f"lm_head quantized; {B} x {S} prompts, {NEW} new, int8 KV, max_seq "
        f"{max_seq}): quantize_s={t_quant:.2f} generate_s={t_gen:.2f} "
        f"peak_mem_gb={peak_gb:.2f}; holds: {holds}")
    log(f"{preset} path kernels {json.dumps(launches)}")
    log(f"{preset} path attention: flash (row 1) "
        f"{'at G = %d hd %d' % (nh // nkv, hd) if flash else 'not taken (softcap or attn_scale: the JAX gate)'}"
        f"; decode (row 6) at hd {hd} G {nh // nkv} sm_scale 1/"
        f"{cfg.attn_scale or hd ** 0.5:g} softcap "
        f"{cfg.attn_logit_softcap or 0.0:g}; sliding layers {sliding} of "
        f"{n_layers} with window {cfg.sliding_window} at decode positions "
        f"{S}..{S + NEW - 2} (keys older than pos - window dropped: "
        f"{'yes' if sliding and S > cfg.sliding_window else 'no'})")
    # per block and forward: qkv, o_proj, gate_up, down_proj (+ the lm_head
    # once a forward); calibration runs NS / CB forwards a chain (two chains
    # and a forward and a backward a step when tuning), the prompt pass one
    if iters:
        fwd = n_layers * (2 * (NS // CB) + iters) + n_layers
        bwd = n_layers * iters
    else:
        fwd, bwd = n_layers * (-(-NS // CB)) + n_layers, 0
    want = {"w4a16_matmul": (4 * n_layers + 1) * NEW,
            "decode_attention": n_layers * (NEW - 1),
            "flash_attention": fwd if flash else 0,
            "flash_attention_bwd_dq": bwd if flash else 0,
            "flash_attention_bwd_dkv": bwd if flash else 0}
    for n in kernels:
        want.setdefault(n, 0)
    for n, c in want.items():
        check(launches[n] == c, f"{preset} path: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    if iters:
        first = [float(traces[b][0]) for b in range(n_layers)]
        best = [float(traces[b].min()) for b in range(n_layers)]
        check(len(traces) == n_layers and all(
            len(traces[b]) == iters and bool(torch.isfinite(
                torch.as_tensor(traces[b])).all()) for b in range(n_layers)),
            f"{preset} tune: a loss is missing or not finite")
        check(all(b <= f for b, f in zip(best, first)),
              f"{preset} tune: a block's best loss is above its first")
        log(f"{preset} tune path ({NS} x {S} ids, iters={iters}, batch {B}, "
            f"qk_norm={cfg.qk_norm}): tune_s={t_quant:.2f}; losses (first "
            f"-> best per block): "
            + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best))
            + f"; flash forward {launches['flash_attention']}, dQ "
            f"{launches['flash_attention_bwd_dq']}, dK/dV "
            f"{launches['flash_attention_bwd_dkv']} launches")
    step_ms = None
    if preset == "qwen2.5-7b":
        _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card")
    scan_path(eng, prompts, toks, gen_counts, f"{preset} path", step_ms)
    if preset == "qwen2.5-7b":
        for b in (1, 8):
            scan_measure(eng, b, S, bw, flops_peak, None, seed=seed + 70 + b,
                         label=preset, ran=(prompts, step_ms) if b == B
                         else None)
    log(f"{preset} path: path_s={time.time() - t_path:.1f}")
    del eng
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- loading and user entry
#
# The load phase writes checkpoints to a temporary directory and serves them
# back: an HF checkpoint through the CLI (a subprocess) and
# ``from_pretrained``, the llama3.2-1b export of phase 14, and GPTQ / AWQ
# directories written with the port's packers.  Every loaded engine is held
# against the in-memory engine of the same result.

LOAD_NEW = 32
# Llama-3.1's rope scaling, so that ``config_from_hf`` builds rope_llama3
LOAD_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
             "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}


def _dense_linears(eng):
    """The quantizable linears an engine serves dense (block linears with a
    dense leaf, and a dense lm_head)."""
    from autoround_tpu_torch.models import llama

    dense = [f"blocks.{i}.{n}" for i, blk in enumerate(eng.params["blocks"])
             for n in llama.LINEAR_KEYS if blk.get(n) is not None]
    if eng.params.get("lm_head") is not None:
        dense.append("lm_head")
    return dense


def _flat(tree, prefix=""):
    """{dotted path: tensor} over a parameter tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


EXPORT_FILES = ("model.safetensors", "quantization_config.json")


def _same_files(a, b, label):
    """The export files of directories a and b are equal byte for byte;
    returns the other files of a (a tokenizer the CLI saved beside the
    export, when ``transformers`` built one)."""
    import filecmp

    for n in EXPORT_FILES:
        check(filecmp.cmp(Path(a) / n, Path(b) / n, shallow=False),
              f"{label}: {n} differs")
    return sorted(p.name for p in Path(a).iterdir()
                  if p.name not in EXPORT_FILES)


def _packed_equal(eng, mem, label):
    """Every packed entry of ``eng`` against the in-memory engine's: the
    words bit-equal, the scales equal to the in-memory fp32 scales rounded
    to fp16 (the files store fp16), the zero points equal; all of them
    contiguous on the card (they reach the captured step)."""
    check(sorted(eng.packed) == sorted(mem.packed)
          and eng.packed_kinds == mem.packed_kinds,
          f"{label}: packed entries {sorted(eng.packed_kinds.items())} "
          f"against {sorted(mem.packed_kinds.items())}")
    for k, e in eng.packed.items():
        m = mem.packed[k]
        check(torch.equal(e[0], m[0]), f"{label}: {k} words differ")
        check(torch.equal(e[1], m[1].half().float()),
              f"{label}: {k} scales are not the fp16 in-memory scales")
        check(len(e) == len(m) and all(torch.equal(a, b)
                                       for a, b in zip(e[2:], m[2:])),
              f"{label}: {k} zero points differ")
        check(all(t.device.type == eng.device.type and t.is_contiguous()
                  for t in e),
              f"{label}: {k} has a tensor off the card or not contiguous")


def _fp16_scales(eng):
    """The engine with every packed scale rounded to fp16, the precision
    the autoround, GPTQ and AWQ files store (the rest shared)."""
    from autoround_tpu_torch import QuantizedLlama

    packed = {k: (e[0], e[1].half().float()) + tuple(e[2:])
              for k, e in eng.packed.items()}
    return QuantizedLlama(cfg=eng.cfg, params=eng.params, packed=packed,
                          max_seq=eng.max_seq, kv_quant=eng.kv_quant,
                          fused_splits=eng.fused_splits, device=eng.device,
                          packed_kinds=dict(eng.packed_kinds),
                          moe_capacity_factor=eng.moe_capacity_factor)


def _step_logits(eng, prompts, tok=None):
    """(prefill logits, first decode step logits on ``tok``, or on the
    engine's own greedy token)."""
    lg, c = eng.prefill(prompts)
    if tok is None:
        tok = lg.argmax(-1).to(torch.int32)
    lg2, _ = eng.decode_step(tok, c)
    return lg.cpu(), lg2.cpu(), tok


def _logits_against(eng, mem, prompts, label):
    """Prefill logits and the first decode step's (on one greedy token)
    against the in-memory engine with its scales rounded to fp16, the
    engine the file stores, within COPY_ROW_TOL; the distance to the
    in-memory engine itself is printed beside it (fp16 scales alone: the
    sym RTN scales are fp16 already, the asym ones are not)."""
    r1, r2, tok = _step_logits(_fp16_scales(mem), prompts)
    m1, m2, _ = _step_logits(mem, prompts, tok)
    l1, l2, _ = _step_logits(eng, prompts, tok)
    e1, q1 = row_err(l1, r1)
    e2, q2 = row_err(l2, r2)
    f1, f2 = row_err(l1, m1)[1], row_err(l2, m2)[1]
    log(f"{label}: prefill logits max_abs_err={e1:.4g} row_err={q1:.4g}, "
        f"first step max_abs_err={e2:.4g} row_err={q2:.4g} against the "
        f"in-memory engine with fp16 scales (tol {COPY_ROW_TOL}); against "
        f"its fp32 scales row_err={f1:.4g} / {f2:.4g}")
    check(q1 <= COPY_ROW_TOL and q2 <= COPY_ROW_TOL,
          f"{label}: logits disagree with the in-memory engine's")


def _loaded_counts(eng, prompts, label, want):
    """``generate`` on a loaded engine with every count zeroed just before
    and read just after; each count must equal what the loops imply
    (``want``, the rest 0).  Returns (tokens, counts)."""
    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    toks, counts = generate_counted(eng, prompts, LOAD_NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    log(f"{label} kernels {json.dumps(launches)} generate_s={t_gen:.2f}")
    for n in kernels:
        c = want.get(n, 0)
        check(launches[n] == c, f"{label}: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, prompts.shape[0], LOAD_NEW, eng.cfg.vocab_size)
    return toks, counts, launches


def _read_rates(path):
    """Seconds to read a file into host memory, and to copy those bytes to
    the card in one ``.to("cuda")`` (the two halves of a load)."""
    size = Path(path).stat().st_size
    buf = bytearray(size)
    view = memoryview(buf)
    t0 = time.time()
    with open(path, "rb", buffering=0) as f:
        got = 0
        while got < size:
            n = f.readinto(view[got:])
            check(n > 0, f"short read of {path}")
            got += n
    t_read = time.time() - t0
    host = torch.frombuffer(buf, dtype=torch.uint8)
    torch.cuda.synchronize()
    t0 = time.time()
    dev = host.to("cuda")
    torch.cuda.synchronize()
    t_h2d = time.time() - t0
    del dev, host, view, buf
    return size, t_read, t_h2d


def load_path(bw, flops_peak, n_layers, root, seed=41):
    """HF checkpoint → CLI → export → ``from_pretrained`` → serve at the
    full width of llama3-8b (Llama-3.1 rope scaling, ``n_layers`` layers,
    random bf16 weights with every norm gain moved).  Returns the launches
    of the loaded engine's ``generate`` and, for the GPTQ / AWQ step, the
    in-process W4A16 and W4A16-asym results, their config, the in-memory
    W4A16 engine and the prompts."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.export import save_quantized
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.utils.hf_loader import (load_hf_checkpoint,
                                                     save_hf_checkpoint)

    t_path = time.time()
    B, S, NEW, MAX_SEQ = 8, 512, LOAD_NEW, 1024
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers,
                              rope_llama3=(8.0, 1.0, 4.0, 8192))
    gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    perturb_gains(params, seed)
    hf = root / "hf"
    torch.cuda.synchronize()
    t0 = time.time()
    save_hf_checkpoint(params, cfg, str(hf), hf_extra={
        "rope_scaling": LOAD_ROPE})
    t_write = time.time() - t0
    hf_bytes = _dir_bytes(hf)
    size, t_read, t_h2d = _read_rates(hf / "model.safetensors")
    torch.cuda.synchronize()
    t0 = time.time()
    lparams, lcfg = load_hf_checkpoint(str(hf))
    torch.cuda.synchronize()
    t_load = time.time() - t0
    check(lcfg == cfg, f"load: config {lcfg} is not the written {cfg}")
    want, got = _flat(params), _flat(lparams)
    check(sorted(want) == sorted(got)
          and all(torch.equal(want[k], got[k]) for k in want),
          "load: the loaded leaves differ from the written ones")
    del params, want, got
    log(f"load path llama3-8b ({n_layers} of 32 layers, full width, "
        f"Llama-3.1 rope scaling, random bf16 weights, gains moved): "
        f"save_hf_checkpoint wrote {hf_bytes} bytes in {t_write:.2f} s "
        f"({hf_bytes / t_write / 1e9:.2f} GB/s); load_hf_checkpoint "
        f"{t_load:.2f} s ({size / t_load / 1e9:.2f} GB/s from the file to "
        f"the card); the same file read into host memory {t_read:.2f} s "
        f"({size / t_read / 1e9:.2f} GB/s) and its bytes copied to the card "
        f"in one .to('cuda') {t_h2d:.2f} s ({size / t_h2d / 1e9:.2f} GB/s)")

    np_ids = root / "ids.npy"
    import numpy as np
    np.save(np_ids, calib.numpy())
    cli_out = root / "cli"
    cmd = [sys.executable, "-m", "autoround_tpu_torch", "--model", str(hf),
           "--scheme", "W4A16", "--iters", "0", "--quant-lm-head",
           "--dataset", str(np_ids), "--format", "autoround", "--output",
           str(cli_out)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=HERE, stdout=subprocess.PIPE, text=True,
                          env=dict(os.environ, PYTHONPATH=str(HERE)),
                          timeout=600)
    t_cli = time.time() - t0
    check(proc.returncode == 0, f"load: the CLI exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}")
    report = proc.stdout.strip().splitlines()[-1]
    check(json.loads(report) == {"output": str(cli_out),
                                 "layers": 7 * n_layers + 1},
          f"load: the CLI reported {report}")
    log(f"load: python -m autoround_tpu_torch {' '.join(cmd[3:])}: exit 0 "
        f"in {t_cli:.2f} s, report {report}")

    t0 = time.time()
    ar = AutoRound((lparams, lcfg), scheme="W4A16", iters=0, batch_size=8,
                   quant_lm_head=True, seed=42)
    result = ar.quantize(calib, mask=torch.ones(calib.shape))
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    mem_out = root / "mem"
    t0 = time.time()
    save_quantized(result, lcfg, str(mem_out), "autoround")
    t_save = time.time() - t0
    extra = _same_files(cli_out, mem_out, "load: the CLI's export against "
                        "the in-process one")
    asym = dict(bits=4, group_size=128, sym=False, data_type="int")
    ares = AutoRound((lparams, lcfg), scheme=asym, iters=0,
                     quant_lm_head=True).quantize(calib)
    del ar, lparams
    shutil.rmtree(hf)
    log(f"load: in-process AutoRound(load_hf_checkpoint(dir)) RTN "
        f"{t_quant:.2f} s, save_quantized {t_save:.2f} s "
        f"({_dir_bytes(mem_out)} bytes); {' and '.join(EXPORT_FILES)} "
        f"equal to the CLI's byte for byte (the CLI also saved {extra})")
    shutil.rmtree(mem_out)

    mem = QuantizedLlama.from_quantize_result(result, lcfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    torch.cuda.synchronize()
    t0 = time.time()
    disk = QuantizedLlama.from_pretrained(str(cli_out), max_seq=MAX_SEQ,
                                          kv_quant="int8")
    torch.cuda.synchronize()
    t_fp = time.time() - t0
    dense = _dense_linears(disk)
    check(disk.cfg == lcfg and not dense
          and set(disk.packed_kinds.values()) == {"w4a16"}
          and len(disk.packed) == 4 * n_layers + 1,
          f"load: from_pretrained dense layers {dense}, kinds "
          f"{sorted(set(disk.packed_kinds.values()))}, {len(disk.packed)} "
          f"entries")
    _packed_equal(disk, mem, "load: from_pretrained")
    log(f"load: from_pretrained {t_fp:.2f} s: {7 * n_layers + 1} layers "
        f"packed (fused into {len(disk.packed)} entries), none dense; words "
        f"bit-equal to the in-memory engine's, scales its fp16 scales")
    _logits_against(disk, mem, prompts, "load: from_pretrained")
    toks, counts, launches = _loaded_counts(
        disk, prompts, "load: from_pretrained engine",
        {"w4a16_matmul": (4 * n_layers + 1) * NEW,
         "flash_attention": n_layers,
         "decode_attention": n_layers * (NEW - 1)})
    with counts_kept():
        mtoks, _ = generate_counted(mem, prompts, NEW)
    share = (toks == mtoks).float().mean().item()
    log(f"load: greedy tokens equal to the in-memory engine's: "
        f"{share:.4f} of {toks.numel()}")
    scan_path(disk, prompts, toks, counts, "load: from_pretrained engine")
    # the replayed step at batch 8: loaded and in-memory engines in turns
    with counts_kept():
        mem.generate_scan(prompts, max_new_tokens=NEW)
        d1 = replay_times(disk, B, 16)
        m1 = replay_times(mem, B, 16)
        m2 = replay_times(mem, B, 16)
        d2 = replay_times(disk, B, 16)
    dmed = statistics.median(d1 + d2)
    mmed = statistics.median(m1 + m2)
    bound = serve_bounds(disk, B, S, bw, flops_peak)[1]
    log(f"load: replayed step B={B} (median of 32 replays each, in turns "
        f"loaded, in-memory, in-memory, loaded): loaded {dmed:.4f} ms "
        f"({statistics.median(d1):.4f} / {statistics.median(d2):.4f}), "
        f"in-memory {mmed:.4f} ms ({statistics.median(m1):.4f} / "
        f"{statistics.median(m2):.4f}), step_bound_ms={bound:.4f}")
    check_copy(disk, prompts, "card")
    del disk
    shutil.rmtree(cli_out)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"load path: peak_mem_gb={peak_gb:.2f} path_s="
        f"{time.time() - t_path:.1f}")
    stats = dict(write_gbs=hf_bytes / t_write / 1e9,
                 load_gbs=size / t_load / 1e9, read_gbs=size / t_read / 1e9,
                 h2d_gbs=size / t_h2d / 1e9, cli_s=t_cli,
                 save_s=t_save, from_pretrained_s=t_fp, step_ms=dmed,
                 mem_step_ms=mmed, bound_ms=bound)
    return launches, (result, ares, lcfg, mem, prompts), stats


def load_llama1b_path(kept, root):
    """Phase 14's llama3.2-1b g128 RTN result (tied embeddings)
    exported, loaded with ``from_pretrained`` and served; held against the
    engine phase 14 built from the same result.  Returns the launches."""
    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.export import save_quantized

    result, cfg, mem, prompts = kept
    L, NEW = cfg.num_layers, LOAD_NEW
    out = root / "l1b"
    t0 = time.time()
    save_quantized(result, cfg, str(out), "autoround")
    t_save = time.time() - t0
    n_bytes = _dir_bytes(out)
    del result
    torch.cuda.synchronize()
    t0 = time.time()
    disk = QuantizedLlama.from_pretrained(str(out), max_seq=mem.max_seq,
                                          kv_quant="int8")
    torch.cuda.synchronize()
    t_fp = time.time() - t0
    dense = _dense_linears(disk)
    check(disk.cfg == cfg and not dense and cfg.tie_embeddings
          and set(disk.packed_kinds.values()) == {"w4a16"}
          and len(disk.packed) == 4 * L + 1,
          f"load llama3.2-1b: dense layers {dense}, kinds "
          f"{sorted(set(disk.packed_kinds.values()))}")
    check(torch.equal(disk.params["embed_tokens"], mem.params["embed_tokens"])
          and disk.params.get("lm_head") is None,
          "load llama3.2-1b: the tied embedding differs")
    _packed_equal(disk, mem, "load llama3.2-1b")
    log(f"load llama3.2-1b ({L} layers, tied embeddings, W4A16 g128): "
        f"save_quantized {t_save:.2f} s ({n_bytes} bytes), from_pretrained "
        f"{t_fp:.2f} s; {7 * L + 1} layers packed, words bit-equal, scales "
        f"fp16, the tied embedding and the packed head as in memory")
    _logits_against(disk, mem, prompts, "load llama3.2-1b")
    toks, counts, launches = _loaded_counts(
        disk, prompts, "load llama3.2-1b engine",
        {"w4a16_matmul": (4 * L + 1) * NEW,
         "decode_attention": L * (NEW - 1)})
    scan_path(disk, prompts, toks, counts, "load llama3.2-1b engine")
    check_copy(disk, prompts, "card")
    del disk
    shutil.rmtree(out)
    return launches


# the GPTQ layer given group ids out of order (the act-order layer)
def _act_order(payload):
    """An act-order copy of a GPTQ payload that computes the same weight:
    group j becomes group j + 1 (the last the first; its scales and zero
    points move with it) and g_idx says so, so g_idx is not arange(I) //
    g.  A copy of ``_permute_groups`` in
    ``tests/test_torch_from_pretrained.py``: the script stands without the
    tests."""
    import numpy as np

    G = payload["scales"].shape[0]
    perm = np.roll(np.arange(G), 1)
    out = dict(payload)
    for k in ("scales", "qzeros"):
        moved = np.empty_like(payload[k])
        moved[perm] = payload[k]
        out[k] = moved
    out["g_idx"] = perm[payload["g_idx"]].astype(np.int32)
    return out


class _LogLines(logging.Handler):
    """Collects the messages of the port's log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _quant_dir(path, result, payloads, cfg, qcfg):
    """An HF-layout directory: the packed payloads of every quantized
    layer, the norms and the embedding, a config.json with its
    quantization_config (and Llama-3.1's rope scaling)."""
    from autoround_tpu_torch.utils.hf_loader import _BLOCK_MAP
    from autoround_tpu_torch.utils.safetensors_io import save_file

    inv = {v: k[: -len(".weight")] for k, v in _BLOCK_MAP.items()
           if k.endswith(".weight")}
    tensors = {}
    for name, payload in payloads.items():
        if name == "lm_head":
            pre = "lm_head"
        else:
            _, li, short = name.split(".")
            pre = f"model.layers.{li}.{inv[short]}"
        for k, v in payload.items():
            tensors[f"{pre}.{k}"] = v
    p = result.params
    tensors["model.embed_tokens.weight"] = p["embed_tokens"]
    tensors["model.norm.weight"] = p["norm"]
    for li, b in enumerate(p["blocks"]):
        for short in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"model.layers.{li}.{short}.weight"] = b[short]
    path.mkdir()
    save_file(tensors, str(path / "model.safetensors"))
    hf_cfg = {"model_type": "llama", "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads,
              "num_key_value_heads": cfg.num_kv_heads,
              "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
              "tie_word_embeddings": False, "rope_scaling": LOAD_ROPE,
              "quantization_config": qcfg}
    (path / "config.json").write_text(json.dumps(hf_cfg, indent=2))
    return _dir_bytes(path)


def load_gptq_awq_path(kept, root):
    """The 4-layer results of the load path packed with the port's GPTQ and
    AWQ packers into HF-layout directories and served with ``from_gptq`` /
    ``from_awq``: GPTQ on row 4, AWQ on row 9 (row 4 at 0), a GPTQ copy
    with one act-order layer served dense (and logged so); each held
    against the in-memory engine of its source result.  Returns the
    launches of the GPTQ and the AWQ engines' ``generate``."""
    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.export.formats import (awq_pack_layer,
                                                    gptq_pack_layer)
    from autoround_tpu_torch.ops.qmatmul import unpack_w4

    result, ares, cfg, mem, prompts = kept
    L, NEW, MAX_SEQ = cfg.num_layers, LOAD_NEW, mem.max_seq
    serve = {"flash_attention": L, "decode_attention": L * (NEW - 1)}
    out = {}

    t0 = time.time()
    gptq = {n: gptq_pack_layer(ql) for n, ql in result.layers.items()}
    t_pack = time.time() - t0
    qcfg = {"quant_method": "gptq", "bits": 4, "group_size": 128,
            "sym": True, "desc_act": False}
    n_bytes = _quant_dir(root / "gptq", result, gptq, cfg, qcfg)
    t0 = time.time()
    eng = QuantizedLlama.from_gptq(str(root / "gptq"), max_seq=MAX_SEQ,
                                   kv_quant="int8")
    t_load = time.time() - t0
    check(eng.cfg == cfg and not _dense_linears(eng),
          f"load gptq: config {eng.cfg} / dense {_dense_linears(eng)}")
    _packed_equal(eng, mem, "load gptq")
    log(f"load gptq: gptq_pack_layer x {len(gptq)} {t_pack:.2f} s, "
        f"{n_bytes} bytes, from_gptq {t_load:.2f} s; every layer packed "
        f"w4a16, words bit-equal to the in-memory engine's")
    _logits_against(eng, mem, prompts, "load gptq")
    toks, counts, out["gptq"] = _loaded_counts(
        eng, prompts, "load gptq engine",
        dict(serve, w4a16_matmul=(4 * L + 1) * NEW))
    scan_path(eng, prompts, toks, counts, "load gptq engine")
    check_copy(eng, prompts, "card")
    del eng

    # in block 0, so that the 2-layer copy below holds the dense layer too
    name = "blocks.0.o_proj"
    gptq[name] = _act_order(gptq[name])
    shutil.rmtree(root / "gptq")
    _quant_dir(root / "gptq", result, gptq, cfg, dict(qcfg, desc_act=True))
    del gptq
    lines = _LogLines()
    pkg_log = logging.getLogger("autoround_tpu_torch")
    pkg_log.addHandler(lines)
    pkg_log.setLevel(logging.INFO)
    try:
        eng = QuantizedLlama.from_gptq(str(root / "gptq"), max_seq=MAX_SEQ,
                                       kv_quant="int8")
    finally:
        pkg_log.removeHandler(lines)
    msg = f"gptq loader: {name} has act-order g_idx; serving dense"
    check(msg in lines.lines, f"load gptq act-order: no log line {msg!r} "
          f"in {lines.lines}")
    check(_dense_linears(eng) == [name] and set(eng.packed)
          == set(mem.packed) - {name},
          f"load gptq act-order: dense {_dense_linears(eng)}")
    qw, sc = mem.packed[name]
    want = ((unpack_w4(qw) - 8).float() * sc.half().float()
            .repeat_interleave(128, 1)).to(cfg.dtype)
    check(torch.equal(eng.params["blocks"][0]["o_proj"], want),
          "load gptq act-order: the dense layer is not the source's weight")
    log(f"load gptq act-order: {name} (its 32 groups moved round by one in g_idx) serves "
        f"dense, equal to the source's weight; log line {msg!r}")
    _logits_against(eng, mem, prompts, "load gptq act-order")
    toks, counts, _ = _loaded_counts(
        eng, prompts, "load gptq act-order engine",
        dict(serve, w4a16_matmul=4 * L * NEW))
    scan_path(eng, prompts, toks, counts, "load gptq act-order engine")
    check_copy(eng, prompts, "card")
    del eng
    shutil.rmtree(root / "gptq")

    t0 = time.time()
    awq = {n: awq_pack_layer(ql) for n, ql in ares.layers.items()}
    t_pack = time.time() - t0
    qcfg = {"quant_method": "awq", "bits": 4, "group_size": 128,
            "version": "gemm", "zero_point": True}
    n_bytes = _quant_dir(root / "awq", ares, awq, cfg, qcfg)
    del awq
    amem = QuantizedLlama.from_quantize_result(ares, cfg, max_seq=MAX_SEQ,
                                               kv_quant="int8")
    t0 = time.time()
    eng = QuantizedLlama.from_awq(str(root / "awq"), max_seq=MAX_SEQ,
                                  kv_quant="int8")
    t_load = time.time() - t0
    check(eng.cfg == cfg and not _dense_linears(eng)
          and set(eng.packed_kinds.values()) == {"w4a16_asym"},
          f"load awq: dense {_dense_linears(eng)}, kinds "
          f"{sorted(set(eng.packed_kinds.values()))}")
    _packed_equal(eng, amem, "load awq")
    log(f"load awq: awq_pack_layer x {len(ares.layers)} {t_pack:.2f} s, "
        f"{n_bytes} bytes, from_awq {t_load:.2f} s; every layer packed "
        f"w4a16_asym, words and zero points equal to the in-memory "
        f"engine's")
    _logits_against(eng, amem, prompts, "load awq")
    toks, counts, out["awq"] = _loaded_counts(
        eng, prompts, "load awq engine",
        dict(serve, w4a16_asym_matmul=(4 * L + 1) * NEW))
    check(out["awq"]["w4a16_asym_matmul"] > 0
          and out["awq"]["w4a16_matmul"] == 0,
          "load awq: row 9 not launched or row 4 launched")
    scan_path(eng, prompts, toks, counts, "load awq engine")
    check_copy(eng, prompts, "card")
    del eng, amem
    shutil.rmtree(root / "awq")
    return out


def load_phase(bw, flops_peak, n_layers, l1b_kept):
    """Phase 17: every checkpoint the phase writes lies in one temporary
    directory, removed at the end; prints its bytes and seconds."""
    import tempfile

    t0 = time.time()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_load_"))
    try:
        launches, kept, stats = load_path(bw, flops_peak, n_layers, root)
        free_device_memory()
        l1b = load_llama1b_path(l1b_kept, root)
        del l1b_kept
        free_device_memory()
        qa = load_gptq_awq_path(kept, root)
        del kept
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    log(f"load phase: {json.dumps({k: round(v, 4) for k, v in stats.items()})}"
        f" load_phase_s={time.time() - t0:.1f}")
    return dict(load=launches, load_llama1b=l1b, load_gptq=qa["gptq"],
                load_awq=qa["awq"])


def a8_modes_path(n_layers):
    """A W4A16 result on the int8 kernel: ``serve_a8`` and ``prefill_a8``;
    returns the launches of the ``prefill_a8`` engine's prefill and decode
    step."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, MAX_SEQ = 8, 512, 1024
    ids_gen = torch.Generator().manual_seed(11)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    exact = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                                kv_quant="int8")
    a8 = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                             kv_quant="int8", serve_a8=True)
    del ar, result
    check(set(exact.packed_kinds.values()) == {"w4a16"}
          and set(a8.packed_kinds.values()) == {"w4a8"},
          "a8 modes: packed kinds")
    check(all(torch.equal(a8.packed[k][0], e[0])
              and torch.equal(a8.packed[k][1], e[1])
              for k, e in exact.packed.items()),
          "a8 modes: serve_a8 packed other words than the exact engine")
    pa8 = dataclasses.replace(exact, prefill_a8=True)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-6)).item()

    def rel_rms(a, b):
        return ((a.float() - b.float()).pow(2).mean().sqrt()
                / b.float().pow(2).mean().sqrt()).item()

    for fn in kernels.values():
        fn.launches = 0
    le, _ = exact.prefill(prompts)
    check(kernels["w4a8_matmul"].launches == 0
          and kernels["w4a16_matmul"].launches == 4 * n_layers + 1,
          "a8 modes: exact engine's prefill launches")
    for fn in kernels.values():
        fn.launches = 0
    la, _ = a8.prefill(prompts)
    check(kernels["w4a16_matmul"].launches == 0
          and kernels["w4a8_matmul"].launches == 4 * n_layers + 1,
          "a8 modes: serve_a8 engine's prefill launches")
    for fn in kernels.values():
        fn.launches = 0
    lp, cache = pa8.prefill(prompts)
    pre = {n: fn.launches for n, fn in kernels.items()}
    # the blocks' projections on the int8 kernel, the lm_head exact
    check(pre["w4a8_matmul"] == 4 * n_layers and pre["w4a16_matmul"] == 1,
          f"a8 modes: prefill_a8 prefill launched {pre}")
    tok = lp.argmax(-1).to(torch.int32)
    step_logits, cache = pa8.decode_step(tok, cache)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    check(launches["w4a8_matmul"] == 4 * n_layers
          and launches["w4a16_matmul"] == 4 * n_layers + 2
          and launches["decode_attention"] == n_layers,
          f"a8 modes: prefill_a8 decode step launched {launches} after {pre}")
    check(bool(torch.isfinite(step_logits).all()), "a8 modes: decode logits")
    r_a8, r_pa8 = rel(la, le), rel(lp, le)
    log(f"a8 modes llama3-8b ({n_layers} layers, W4A16 g128 result): "
        f"prefill logits vs exact A16, max|diff|/max|exact|: serve_a8 "
        f"{r_a8:.4g}, prefill_a8 {r_pa8:.4g} (tol {A8_MODE_TOL}); rms(diff)/"
        f"rms(exact): {rel_rms(la, le):.4g}, {rel_rms(lp, le):.4g}; prefill_a8 "
        f"kernels prefill + 1 decode step {json.dumps(launches)}")
    check(r_a8 < A8_MODE_TOL and r_pa8 < A8_MODE_TOL,
          "a8 modes: prefill logits too far from exact-A16 serving")
    check(r_a8 > 0 and r_pa8 > 0, "a8 modes: the a8 logits equal the exact "
          "ones (the int8 kernel did not run)")
    del cache
    for name, e in (("serve_a8", a8), ("prefill_a8", pa8)):
        toks, gen_counts = generate_counted(e, prompts, 16)
        scan_path(e, prompts, toks, gen_counts, f"a8 modes {name}")
    del exact, a8, pa8
    torch.cuda.empty_cache()
    return launches


def a8_tune_path(n_layers):
    """SignRound with int8 activations in the loss → serve at llama3-8b
    width: W4A8 as shipped (dynamic per-tensor), then static scales with
    act-scale tuning."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(12)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)

    def init():
        return llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")

    # the static scales before any tuning: amax of the FP pass / 127
    rtn = AutoRound((init(), cfg), scheme=dict(STATIC_W4A8), iters=0,
                    donate_params=True).quantize(calib)
    fixed = {n: q.act_scale for n, q in rtn.layers.items()}
    del rtn
    for label, scheme, kw in (
            ("dynamic", "W4A8", {}),
            ("static + act-scale tuning", dict(STATIC_W4A8),
             dict(enable_act_minmax_tuning=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.time()
        ar = AutoRound((init(), cfg), scheme=scheme, iters=ITERS,
                       batch_size=B, donate_params=True, cache_batch=CB, **kw)
        result = ar.quantize(calib)
        torch.cuda.synchronize()
        t_tune = time.time() - t0
        traces = result.loss_traces
        first = [float(traces[b][0]) for b in range(n_layers)]
        best = [float(traces[b].min()) for b in range(n_layers)]
        check(len(traces) == n_layers and all(
            len(traces[b]) == ITERS and bool((traces[b] == traces[b]).all())
            and bool(abs(traces[b]).max() < float("inf"))
            for b in range(n_layers)),
            f"a8 tune ({label}): a loss is missing or not finite")
        check(all(b <= f for b, f in zip(best, first)),
              f"a8 tune ({label}): a block's best loss is above its first")
        shrink = None
        if kw:
            tcfg = ar.cfg.tune_config()
            ratios = [float(q.act_scale / fixed[n])
                      for n, q in result.layers.items()]
            check(all(q.act_scale is not None and q.act_scale.ndim == 0
                      for q in result.layers.values()),
                  "a8 tune: a static act scale is missing")
            check(all(tcfg.clip_lo <= r <= tcfg.clip_hi * (1 + 1e-6)
                      for r in ratios),
                  f"a8 tune: act scales outside [clip_lo, clip_hi] x amax / "
                  f"127: ratios {ratios}")
            shrink = (min(ratios), max(ratios))
        else:
            check(all(q.act_scale is None for q in result.layers.values()),
                  "a8 tune: a dynamic scheme left a static act scale")
        eng = QuantizedLlama.from_quantize_result(result, cfg,
                                                  max_seq=MAX_SEQ,
                                                  kv_quant="int8")
        del ar, result
        check(set(eng.packed_kinds.values()) == {"w4a8"},
              f"a8 tune ({label}): packed kinds")
        toks = eng.generate(prompts, max_new_tokens=NEW)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in kernels.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"a8 tune path ({label}) llama3-8b ({n_layers} layers, {NS} x "
            f"{S} ids, iters={ITERS}, batch {B}): tune_s={t_tune:.2f} "
            f"peak_mem_gb={peak_gb:.2f}; losses (first -> best per block): "
            + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best))
            + (f"; act scale over amax / 127, least and most: "
               f"{shrink[0]:.4f} {shrink[1]:.4f}" if shrink else ""))
        log(f"a8 tune path ({label}) kernels {json.dumps(launches)}")
        # per block: the amax pass, the FP chain and the quantized chain
        # (NS / CB forwards each), one forward and one backward per step;
        # generate's prefill adds one forward per layer
        fwd = n_layers * (1 + 2 * (NS // CB) + ITERS) + n_layers
        want = {"flash_attention": fwd,
                "flash_attention_bwd_dq": n_layers * ITERS,
                "flash_attention_bwd_dkv": n_layers * ITERS,
                "w4a8_matmul": 4 * n_layers * NEW,   # the lm_head stays dense
                "decode_attention": n_layers * (NEW - 1),
                "w4a16_matmul": 0}
        for n, c in want.items():
            check(launches[n] == c, f"a8 tune ({label}): {n} launched "
                  f"{launches[n]} times, the loops imply {c}")
        _check_tokens(toks, B, NEW, cfg.vocab_size)
        del eng
    torch.cuda.empty_cache()


def mx_tune_path(bw, flops_peak, n_layers):
    """SignRound with MXFP4 (the shared exponent and the rounding offsets
    tuned through the MX qdq, MX activations in the loss) → serve at
    llama3-8b width, timed, and a 2-layer copy against the plain versions;
    returns the launches."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ, NS, ITERS, CB = 8, 512, 32, 1024, 16, 20, 8
    ids_gen = torch.Generator().manual_seed(17)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="MXFP4", iters=ITERS, batch_size=B,
                   donate_params=True, cache_batch=CB)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_tune = time.time() - t0
    traces = result.loss_traces
    first = [float(traces[b][0]) for b in range(n_layers)]
    best = [float(traces[b].min()) for b in range(n_layers)]
    check(len(traces) == n_layers and all(
        len(traces[b]) == ITERS and bool((traces[b] == traces[b]).all())
        and bool(abs(traces[b]).max() < float("inf"))
        for b in range(n_layers)), "mx tune: a loss is missing or not finite")
    check(all(b <= f for b, f in zip(best, first)),
          "mx tune: a block's best loss is above its first")
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    del ar, result
    check(set(eng.packed_kinds.values()) == {"mxfp4_g32"},
          "mx tune: packed kinds")
    t0 = time.time()
    toks = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"mx tune path llama3-8b ({n_layers} layers, {NS} x {S} ids, "
        f"iters={ITERS}, batch {B}): tune_s={t_tune:.2f} "
        f"generate_s={t_gen:.2f} peak_mem_gb={peak_gb:.2f}; losses (first "
        f"-> best per block): "
        + " ".join(f"{f:.4g}->{b:.4g}" for f, b in zip(first, best)))
    log(f"mx tune path kernels {json.dumps(launches)}")
    # per block: the amax pass, the FP chain and the quantized chain (NS /
    # CB forwards each), one forward and one backward per step; generate's
    # prefill adds one forward per layer
    fwd = n_layers * (1 + 2 * (NS // CB) + ITERS) + n_layers
    want = {"flash_attention": fwd,
            "flash_attention_bwd_dq": n_layers * ITERS,
            "flash_attention_bwd_dkv": n_layers * ITERS,
            "mxfp4_matmul": 4 * n_layers * NEW,   # the lm_head stays dense
            "decode_attention": n_layers * (NEW - 1),
            "w4a16_matmul": 0}
    for n, c in want.items():
        check(launches[n] == c, f"mx tune: {n} launched {launches[n]} times, "
              f"the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    time_serving(eng, prompts, NEW, bw, flops_peak)
    check_copy(eng, prompts, "card")
    del eng
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- the driver options
#
# Each tuned path of the options phase runs iters=20 on 16 x 512 ids at
# batch 8, as the tune path does, holds every loss trace finite with its best
# at or below its first, and serves the result (generate, generate_scan, the
# launches its loops imply, a 2-layer copy against the plain versions on the
# card).

OPT_NS, OPT_ITERS, OPT_CB = 16, 20, 8


@contextlib.contextmanager
def tuned_params_seen():
    """Inside the block, every ``tune_block`` call of the quantize loop
    records its best params (the clip scales' least and most, and the
    norm / bias offsets): a list of dicts, one per call."""
    from autoround_tpu_torch.quantize import orchestrator

    seen = []
    inner = orchestrator.tune_block

    def recording(*a, **kw):
        best, info = inner(*a, **kw)
        cfg = a[5]        # the orchestrator's TuneConfig, alg_ext widened
        # the scales the qdq uses: the tuned values under the clamp
        used = [p[k].clamp(cfg.clip_lo, cfg.clip_hi)
                for n, p in best.items() if n not in ("_nb", "_act")
                for k in ("min_scale", "max_scale") if k in p]
        seen.append({
            "scale_min": min(float(s.min()) for s in used),
            "scale_max": max(float(s.max()) for s in used),
            "nb": {n: p["v"].clone() for n, p in best.get("_nb", {}).items()},
            "clip": (cfg.clip_lo, cfg.clip_hi)})
        return best, info
    orchestrator.tune_block = recording
    try:
        yield seen
    finally:
        orchestrator.tune_block = inner


def _frozen_at(trace, gap):
    """The first step at which ``dynamic_max_gap`` froze the updates (the
    tuner's own rule on the loss trace), or None."""
    best, since = float("inf"), 0
    for i, loss in enumerate(trace):
        if loss < best:
            best, since = loss, 0
        else:
            since += 1
        if since >= gap:
            return i
    return None


def options_path(bw, flops_peak, label, preset, n_layers, scheme, seed, kw,
                 kind, fwd_per_step=1, bwd_per_step=1, gains=False,
                 stream=False):
    """One tuned path of the options phase; returns (launches, the
    result's loss traces, the clip-scale records, tune_s)."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    kernels = _kernel_fns()
    cfg = dataclasses.replace(llama.CONFIG_PRESETS[preset],
                              num_layers=n_layers)
    B, S, NEW, MAX_SEQ = 8, 512, 32, 1024
    ids_gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (OPT_NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    fp_leaves = None
    if gains:
        perturb_gains(params, seed)
        fp_leaves = [{k: t.clone() for k, t in b.items() if t.ndim == 1}
                     for b in params["blocks"]]
    root = tempfile.mkdtemp(prefix="opt_stream_") if stream else None
    if stream:
        kw = dict(kw, immediate_save_dir=root)
    t0 = time.time()
    with tuned_params_seen() as seen:
        ar = AutoRound((params, cfg), scheme=scheme, iters=OPT_ITERS,
                       batch_size=B, donate_params=True, cache_batch=OPT_CB,
                       **kw)
        del params
        result = ar.quantize(calib)
        torch.cuda.synchronize()
    t_tune = time.time() - t0
    tune_peak = torch.cuda.max_memory_allocated() / 1e9
    traces = dict(result.loss_traces)
    check(all(len(t) == OPT_ITERS and bool((t == t).all())
              and bool(abs(t).max() < float("inf")) for t in traces.values()),
          f"{label}: a loss is missing or not finite")
    check(all(t.min() <= t[0] for t in traces.values()),
          f"{label}: a best loss is above its first")
    check(all(r["clip"][0] <= r["scale_min"]
              and r["scale_max"] <= r["clip"][1] for r in seen),
          f"{label}: tuned clip scales outside the clamp: "
          f"{[(r['scale_min'], r['scale_max']) for r in seen]}")
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    check(set(eng.packed_kinds.values()) == {kind},
          f"{label}: packed kinds {sorted(set(eng.packed_kinds.values()))}")
    if stream:
        from autoround_tpu_torch.export import quantization_config
        with open(os.path.join(root, "quantization_config.json"), "w") as f:
            json.dump(quantization_config(result, cfg), f)
        shards = sorted(f for f in os.listdir(root)
                        if f.endswith(".safetensors"))
        loaded = QuantizedLlama.from_pretrained(root, max_seq=MAX_SEQ,
                                                kv_quant="int8")
        _packed_equal(loaded, eng, f"{label} streamed shards")
        log(f"{label}: {len(shards)} streamed shards "
            f"({_dir_bytes(root) / 1e9:.2f} GB) load through "
            f"from_pretrained; words bit-equal to the from_quantize_result "
            f"engine's, scales its fp16 scales")
        del loaded
        shutil.rmtree(root)
    del ar, result
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    launches = {n: fn.launches for n, fn in kernels.items()}
    first = {b: float(t[0]) for b, t in traces.items()}
    best = {b: float(t.min()) for b, t in traces.items()}
    shown = {k: v for k, v in kw.items() if k != "immediate_save_dir"}
    log(f"{label} ({preset} x {n_layers}, {scheme}, {json.dumps(shown)}"
        f"{', immediate save' if stream else ''}, {OPT_NS} x {S} ids, "
        f"iters={OPT_ITERS}, batch {B}): "
        f"tune_s={t_tune:.2f} tune_step_ms="
        f"{t_tune / max(len(traces), 1) / OPT_ITERS * 1e3:.1f} (the "
        f"block's chains included) peak_mem_gb={tune_peak:.2f}; losses "
        f"(first -> best per trace): "
        + " ".join(f"{b}:{first[b]:.4g}->{best[b]:.4g}" for b in traces)
        + f"; clip scales (clamped) least / most "
        f"{min(r['scale_min'] for r in seen):.4f} / "
        f"{max(r['scale_max'] for r in seen):.4f} in {seen[0]['clip']}")
    log(f"{label} kernels {json.dumps(launches)}")
    # per block: the FP chain and the quantized chain (NS / CB forwards
    # each), fwd_per_step forwards and bwd_per_step backwards a step;
    # generate's prefill adds one forward per layer
    want = {"flash_attention": n_layers * (2 * (OPT_NS // OPT_CB)
                                           + fwd_per_step * OPT_ITERS)
            + n_layers,
            "flash_attention_bwd_dq": n_layers * bwd_per_step * OPT_ITERS,
            "flash_attention_bwd_dkv": n_layers * bwd_per_step * OPT_ITERS,
            "decode_attention": n_layers * (NEW - 1)}
    for n, c in want.items():
        check(launches[n] == c, f"{label}: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    check(launches[{"w4a16": "w4a16_matmul",
                    "w2a16": "w2a16_matmul"}[kind]] == 4 * n_layers * NEW,
          f"{label}: the {kind} kernel launched "
          f"{launches}, the loops imply {4 * n_layers * NEW}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    if gains:
        # the served engine holds the tuned gains and biases: off the FP
        # values, and each the bake of its tuned offset
        from autoround_tpu_torch.dtypes.intq import qdq_asym_wo_round
        moved = 0
        for bi, rec in enumerate(seen):
            for name, v in rec["nb"].items():
                got = eng.params["blocks"][bi][name]
                fp = fp_leaves[bi][name]
                want_leaf = qdq_asym_wo_round(fp, v).to(fp.dtype)
                check(torch.equal(got, want_leaf),
                      f"{label}: block {bi} {name} is not its baked value")
                moved += not torch.equal(got, fp)
        n_nb = sum(len(r["nb"]) for r in seen)
        check(n_nb == sum(len(f) for f in fp_leaves) and moved > 0,
              f"{label}: {n_nb} tuned gains / biases, {moved} moved")
        log(f"{label}: the engine serves {n_nb} tuned gains and biases "
            f"({', '.join(sorted(seen[0]['nb']))} per block), each the "
            f"bake of its best offset; {moved} of them off the FP value")
    scan_path(eng, prompts, toks, gen_counts, label)
    check_copy(eng, prompts, "card")
    del eng
    torch.cuda.empty_cache()
    return launches, traces, seen, t_tune


def options_phase(bw, flops_peak, n_layers, nb_layers):
    """The SignRound and driver options at llama3-8b / qwen2.5-7b width:
    alg_ext (W2A16, the outlier mask over 2^24 elements a batch, use_remat)
    beside a plain run, AdamRound with norm / bias tuning and gradient
    accumulation, nblocks = 2 with dynamic_max_gap and the immediate save,
    and the LM loss on the last block; returns {path: launches}."""
    out = {}
    options_step_phase()
    free_device_memory()
    # alg_ext, W2A16 g128: the searched init, the clamp at (0, 2), the
    # outlier-masked loss (bits < 4); use_remat recomputes each step's
    # forward in its backward
    out["alg_ext"], traces, seen, _ = options_path(
        bw, flops_peak, "options alg_ext", "llama3-8b", n_layers, "W2A16",
        31, dict(enable_alg_ext=True, use_remat=True), "w2a16",
        fwd_per_step=2)
    check(max(r["scale_max"] for r in seen) > 1.0,
          "options alg_ext: no tuned max scale above 1")
    free_device_memory()
    _, plain, _, _ = options_path(
        bw, flops_peak, "options alg_ext's plain twin", "llama3-8b",
        n_layers, "W2A16", 31, {}, "w2a16")
    log("options alg_ext: best loss per block, alg_ext / plain (printed, "
        "not held): " + " ".join(
            f"{b}:{traces[b].min():.5g}/{plain[b].min():.5g}"
            for b in traces))
    free_device_memory()
    # AdamRound + norm / bias tuning on qwen2.5-7b (q/k/v biases), with
    # gradient accumulation
    out["adam_nb"], _, _, _ = options_path(
        bw, flops_peak, "options adam + norm/bias", "qwen2.5-7b", n_layers,
        "W4A16", 32, dict(optimizer="adam", enable_norm_bias_tuning=True,
                          gradient_accumulate_steps=2), "w4a16",
        fwd_per_step=2, bwd_per_step=2, gains=True)
    free_device_memory()
    # nblocks = 2: two groups of two chained blocks, dynamic_max_gap, the
    # shards streamed as each group finishes
    gap = 5
    out["nblocks"], traces, _, _ = options_path(
        bw, flops_peak, "options nblocks=2", "llama3-8b", nb_layers,
        "W4A16", 33, dict(nblocks=2, dynamic_max_gap=gap), "w4a16",
        stream=True)
    check(sorted(traces) == list(range(0, nb_layers, 2)),
          f"options nblocks=2: traces {sorted(traces)}, one per group wanted")
    log("options nblocks=2: dynamic_max_gap=5 froze " + ", ".join(
        f"group {g} at step {_frozen_at(traces[g], gap)}" for g in traces))
    free_device_memory()
    # the LM loss on the last block: fp32 logits over the 128256-entry
    # vocabulary
    out["lfq"], traces, _, _ = options_path(
        bw, flops_peak, "options enable_lfq", "llama3-8b", n_layers,
        "W4A16", 34, dict(enable_lfq=True), "w4a16")
    last = traces[n_layers - 1]
    ln_v = math.log(128256)
    check(0.8 * ln_v < last[0] < 1.2 * ln_v,
          f"options enable_lfq: the last block's first loss {last[0]} is "
          f"not at the scale of ln(128256) = {ln_v:.2f}")
    log(f"options enable_lfq: the last block's LM loss {last[0]:.4f} -> "
        f"{last.min():.4f} (ln 128256 = {ln_v:.4f}); the other blocks' MSE "
        f"x 1000 " + " ".join(f"{traces[b][0]:.4g}" for b in traces
                              if b != n_layers - 1))
    free_device_memory()
    return out


def options_step_phase():
    """The tuning step of each option on full-width blocks, 8 x 512 a batch
    (16 x 512 cached inputs): ``tune_block``'s seconds at 15 iterations less
    its seconds at 5, over 10, after a 2-iteration run that warms the path
    up (its seconds printed: the first ``use_remat`` call pays PyTorch's
    one-time set-up of non-reentrant checkpointing)."""
    from autoround_tpu_torch.algorithms.signround import (TuneConfig,
                                                          tune_block)
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.quantize.orchestrator import (
        _make_lfq_fn, _norm_bias_leaves_for)
    from autoround_tpu_torch.schemes import parse_scheme

    B, S, NS = 8, 512, 16

    def setup(preset, n_blocks, seed, gains=False):
        cfg = dataclasses.replace(llama.CONFIG_PRESETS[preset],
                                  num_layers=n_blocks)
        params = llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        if gains:
            perturb_gains(params, seed)
        ids = torch.randint(0, cfg.vocab_size, (NS, S),
                            generator=torch.Generator().manual_seed(seed)
                            ).cuda()
        cos, sin = llama.rope_tables(cfg, S, device="cuda")

        def fwd(w, xb):
            for b in w["blocks"]:
                xb = llama.block_fwd(b, xb, cos, sin, cfg)
            return xb
        with torch.no_grad():
            x = llama.embed_fwd(params, ids, cfg)
            ref = torch.cat([fwd(params, x[i:i + B])
                             for i in range(0, NS, B)])
        return cfg, params, ids, x, ref, fwd

    def step_ms(label, fwd, weights, x, ref, schemes, kw, **tb_kw):
        def run(iters):
            torch.cuda.synchronize()
            t0 = time.time()
            _, info = tune_block(fwd, weights, x, ref, schemes,
                                 TuneConfig(iters=iters, batch_size=B, **kw),
                                 **tb_kw)
            torch.cuda.synchronize()
            check(all(math.isfinite(v) for v in info["loss_trace"].tolist()),
                  f"options step {label}: a loss is not finite")
            return time.time() - t0
        warm = run(2)
        t5, t15 = run(5), run(15)
        ms = (t15 - t5) / 10 * 1e3
        log(f"options step {label}: tune_step_ms={ms:.2f} (warm-up "
            f"{warm:.2f} s)")
        return ms

    out = {}
    cfg, params, ids, x, ref, fwd = setup("llama3-8b", 2, 0)
    one = {"blocks": params["blocks"][:1]}
    with torch.no_grad():
        ref1 = torch.cat([fwd(one, x[i:i + B]) for i in range(0, NS, B)])

    def sch(name, n=1):
        return {f"blocks.{j}.{k}": parse_scheme(name) for j in range(n)
                for k in llama.LINEAR_KEYS}
    out["W4A16"] = step_ms("llama3-8b W4A16 (plain)", fwd, one, x, ref1,
                           sch("W4A16"), {})
    out["W2A16"] = step_ms("llama3-8b W2A16 (plain)", fwd, one, x, ref1,
                           sch("W2A16"), {})
    out["alg_ext"] = step_ms("llama3-8b W2A16 alg_ext", fwd, one, x, ref1,
                             sch("W2A16"), dict(enable_alg_ext=True))
    out["alg_ext_remat"] = step_ms(
        "llama3-8b W2A16 alg_ext + use_remat", fwd, one, x, ref1,
        sch("W2A16"), dict(enable_alg_ext=True, use_remat=True))
    out["nblocks"] = step_ms("llama3-8b W4A16 nblocks=2 (a group of two "
                             "blocks)", fwd, params, x, ref, sch("W4A16", 2),
                             {})
    last = {"blocks": params["blocks"][-1:]}
    out["lfq"] = step_ms(
        "llama3-8b W4A16 LM loss (vocab 128256)", fwd, last, x, ref1,
        sch("W4A16"), {}, lfq_fn=_make_lfq_fn(params, cfg, ids, None))
    del params, one, last, x, ref, ref1
    torch.cuda.empty_cache()
    cfg, params, ids, x, ref, fwd = setup("qwen2.5-7b", 1, 1, gains=True)
    nb = tuple(f"blocks.0.{k}" for k in _norm_bias_leaves_for(
        params["blocks"][0]))
    out["adam_nb"] = step_ms(
        "qwen2.5-7b W4A16 Adam + norm/bias, accumulation 2", fwd,
        {"blocks": params["blocks"]}, x, ref, sch("W4A16"),
        dict(optimizer="adam", enable_norm_bias_tuning=True,
             gradient_accumulate_steps=2), norm_bias_leaves=nb)
    out["qwen_W4A16"] = step_ms("qwen2.5-7b W4A16 (plain)", fwd,
                                {"blocks": params["blocks"]}, x, ref,
                                sch("W4A16"), {})
    del params, x, ref
    torch.cuda.empty_cache()
    return out



def _meminfo(key):
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    return 0


def offload_phase(bw, flops_peak, n_layers):
    """Mixtral-8x7b quantized through host offload: the blocks made on the
    card one at a time and parked on the host, W4A16_MIXED with the
    lm_head, RTN, ``offload_params`` and ``donate_params``; the first two
    blocks' codes and scales against an on-device RTN of the same blocks;
    the host-resident result packed and served; returns the launches."""
    import resource

    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import mixtral
    from autoround_tpu_torch.utils.offload import tree_to_host

    kernels = _kernel_fns()
    full = mixtral.CONFIG_PRESETS["mixtral-8x7b"]
    H, I, E = full.hidden_size, full.intermediate_size, full.num_experts
    block_bytes = 2 * (H * (full.num_heads + 2 * full.num_kv_heads) * full.hd
                       + full.num_heads * full.hd * H + E * 3 * H * I
                       + E * H + 2 * H)
    avail = _meminfo("MemAvailable")
    # the parked blocks, one qdq block in flight, and 8 GB for the process
    fits = int((avail - 8e9) // block_bytes) - 1
    depth = min(n_layers, fits)
    log(f"offload: host MemAvailable {avail / 1e9:.2f} GB, a Mixtral block "
        f"{block_bytes / 1e9:.3f} GB: {fits} blocks fit, depth {depth} of "
        f"{n_layers} asked")
    check(depth >= min(n_layers, 28),
          f"offload: the host holds only {depth} Mixtral blocks (28 wanted)")
    cfg = dataclasses.replace(full, num_layers=depth)
    B, S, NEW, MAX_SEQ, NS = 8, 512, 32, 1024, 8
    ids_gen = torch.Generator().manual_seed(35)
    calib = torch.randint(0, cfg.vocab_size, (NS, S), generator=ids_gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=ids_gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0

    t0 = time.time()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        park=tree_to_host)
    torch.cuda.synchronize()
    t_make = time.time() - t0
    make_peak = torch.cuda.max_memory_allocated() / 1e9
    leaf = params["blocks"][0]["experts"][0]["w1"]
    pinned = leaf.is_pinned()
    # one parked block up and back, timed alone
    t0 = time.time()
    up = [t.to("cuda", non_blocking=True) for t in _tensors(
        params["blocks"][1])]
    torch.cuda.synchronize()
    h2d = block_bytes / (time.time() - t0) / 1e9
    del up
    gb = depth * block_bytes / 1e9
    log(f"offload: made and parked {depth} blocks ({gb:.1f} GB, pinned="
        f"{pinned}) in {t_make:.1f} s ({gb / t_make:.2f} GB/s, the "
        f"generator and the pinning included), device peak "
        f"{make_peak:.2f} GB; one block host -> card {h2d:.2f} GB/s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16_MIXED", iters=0,
                   quant_lm_head=True, offload_params=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    quant_peak = torch.cuda.max_memory_allocated() / 1e9
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    check(all(b is None for b in ar.params["blocks"]),
          "offload: a donated FP block is still held")
    check(result.params["blocks"][0]["experts"][0]["w1"].device.type
          == "cpu" and result.layers["blocks.0.q_proj"].qdq.device.type
          == "cpu", "offload: the result's blocks are not on the host")
    log(f"offload quantize: {depth} blocks in {t_quant:.1f} s, device peak "
        f"{quant_peak:.2f} GB, process peak RSS {rss:.1f} GB, "
        f"{2 * depth * block_bytes / t_quant / 1e9:.2f} GB/s of blocks "
        f"up and qdq back (the RTN and the FP chain included)")

    # the first two blocks again, made on the card from the same seed (the
    # other blocks' numbers drawn and dropped), RTN'd there
    keep = iter(range(depth))
    with counts_kept():     # a comparison: its launches do not count
        kept = mixtral.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
            park=lambda b: b if next(keep) < 2 else None)
        kept["blocks"] = kept["blocks"][:2]
        ref = AutoRound((kept, dataclasses.replace(cfg, num_layers=2)),
                        scheme="W4A16_MIXED", iters=0,
                        donate_params=True).quantize(calib)
        del kept
    n_cmp = 0
    for name, ql in ref.layers.items():
        got = result.layers[name]
        check(torch.equal(got.qdq.cuda(), ql.qdq)
              and torch.equal(got.scale.cuda(), ql.scale),
              f"offload: {name} differs from the on-device RTN")
        n_cmp += 1
    log(f"offload: the first 2 blocks' {n_cmp} layers (qdq, so the codes, "
        f"and scales) bit-equal to an on-device RTN of the same blocks")
    del ref
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    pack_peak = torch.cuda.max_memory_allocated() / 1e9
    del ar, result
    gc.collect()
    resident = torch.cuda.memory_allocated() / 1e9
    kinds = sorted(set(eng.packed_kinds.values()))
    check(kinds == ["w4a16_grouped", "w8a16"],
          f"offload: packed kinds {kinds}")
    log(f"offload: packed the host-resident result in {t_pack:.1f} s, "
        f"device peak {pack_peak:.2f} GB, resident {resident:.2f} GB")
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    launches = {n: fn.launches for n, fn in kernels.items()}
    log(f"offload kernels {json.dumps(launches)}")
    want = _serve_counts(depth, NEW, NEW - 1, per_block=2)
    want["w8a16_matmul"] = want.pop("matmul")
    want.update(w4a16_matmul_grouped=3 * depth * NEW, w4a16_matmul=0,
                flash_attention_bwd_dq=0, flash_attention_bwd_dkv=0)
    for n, c in want.items():
        check(launches[n] == c, f"offload: {n} launched {launches[n]} "
              f"times, the loops imply {c}")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    graph, eager = scan_path(eng, prompts, toks, gen_counts, "offload")
    _, step_bound = serve_bounds(eng, B, S, bw, flops_peak)
    log(f"offload mixtral-8x7b x {depth}: replayed step {graph:.4f} ms at "
        f"batch 8 (eager {eager:.4f}), bound {step_bound:.4f} ms (bytes)")
    check_copy(eng, prompts, "card", MOE_COPY_ROW_TOL)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the pinned chunks the allocator caches go back to the host
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    return launches


# ------------------------------------------------------------ the DeepSeek family
#
# MLA serves through the latent cache with plain PyTorch attention (no
# kernel, as in the JAX package); the projections run row 4, the stacked
# routed experts row 5.

DS_NEW = 32
# a DeepSeek copy on the plain versions: the router's top-k near-ties of a
# random model (softmax over 64 experts, top 6) fall either way as for
# Mixtral, so the MoE copy limit
DS_COPY_ROW_TOL = MOE_COPY_ROW_TOL
# the fp8 (e4m3) latent cache against the bf16 one, first decode step's
# logits over 4 layers: e4m3 keeps 3 mantissa bits (2^-4 relative rounding
# of each latent), scores and context move by that share of their size
DS_FP8_ROW_TOL = 0.3
# a GQA decode step over the e4m3 cache against the same step over a bf16
# cache that holds its dequantized values: the engine dequantizes into such
# a bf16 copy itself, so the two are the same computation (0 measured on an
# H100, gpt-oss-20b and llama4-scout); the limit leaves room for the last
# bits of a reordered sum
FP8_READ_ROW_TOL = 0.02
# (label, E, O, K, token counts) of the grouped kernel at the DeepSeek
# shapes: V2-Lite's experts (1408 = 11 x 128), V3's (K = 7168, E = 256)
DS_GROUPED_SHAPES = (("v2-lite gate/up", 64, 1408, 2048, (8, 4096)),
                     ("v2-lite down", 64, 2048, 1408, (8, 4096)),
                     ("v3 gate/up", 256, 2048, 7168, (8, 256)),
                     ("v3 down", 256, 7168, 2048, (8, 256)))
# (prompt length, new tokens) of the DeepSeek batcher check: 8 requests
# over the buckets 16..256, all in the batch at once, then 2 late joins
DS_BATCH_REQUESTS = [(16, 8), (200, 12), (64, 10), (31, 12), (256, 8),
                     (100, 12), (17, 10), (128, 8), (48, 6), (90, 8)]


def ds_grouped_shapes():
    """Row 5 at the DeepSeek shapes (E = 64 and 256, O or K = 1408, K =
    7168) against its plain version on the card, the expert slab shared
    (stride 0) as dense-then-mask routing hands it over; the launches are
    not counted."""
    from autoround_tpu_torch.ops.qmatmul import (pack_w4,
                                                 w4a16_matmul_grouped,
                                                 w4a16_matmul_grouped_plain)

    gen = torch.Generator(device="cuda").manual_seed(71)
    tol = ROW_TOL["w4a16_matmul_grouped"]
    with counts_kept():
        for label, E, O, K, Ms in DS_GROUPED_SHAPES:
            codes = torch.randint(0, 16, (E, O, K), generator=gen,
                                  device="cuda", dtype=torch.int32)
            qw = torch.stack([pack_w4(codes[e]) for e in range(E)])
            del codes
            sc = torch.rand((E, O, K // 128), generator=gen,
                            device="cuda") * 0.01 + 0.005
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device="cuda",
                                dtype=torch.bfloat16).expand(E, M, K)
                y = w4a16_matmul_grouped(x, qw, sc, 128)
                yp = w4a16_matmul_grouped_plain(x, qw, sc, 128)
                torch.cuda.synchronize()
                err, rel = row_err(y, yp)
                log(f"deepseek row 5 [{label} E={E} C={M} K={K} O={O}] "
                    f"max_abs_err={err:.3g} row_err={rel:.4g} (tol {tol})")
                check(rel <= tol, f"deepseek row 5 {label} C={M}: row err "
                      f"{rel}")
            del qw, sc, x, y, yp


def _ds_dense(eng, result):
    """The quantized layers an MLA engine serves dense, by reason:
    ``kv_b_proj`` (the absorbed decode reads it per head) and any other
    (a shape the kernel does not take)."""
    packed = set(eng.packed)
    kvb, other = [], []
    for name in result.layers:
        if name.endswith(".kv_b_proj"):
            kvb.append(name)
        elif ".experts." not in name and name not in packed:
            other.append(name)
    return kvb, other


def _ds_want(eng, n_fwd):
    """Launches of ``n_fwd`` forwards of an engine: each packed ``w4a16``
    entry once (row 4), each stacked projection once (row 5), no
    attention kernel."""
    kinds = list(eng.packed_kinds.values())
    return {"w4a16_matmul": kinds.count("w4a16") * n_fwd,
            "w4a16_matmul_grouped": kinds.count("w4a16_grouped") * n_fwd}


def _ds_counts(launches, want, label):
    for n, c in launches.items():
        check(c == want.get(n, 0), f"{label}: {n} launched {c} times, the "
              f"loops imply {want.get(n, 0)}")


def _tokens_and_logits(eng, ids, n_new):
    """Greedy tokens of one request alone and the logits behind each."""
    logits, cache = eng.prefill(ids)
    out, lgs = [], []
    for i in range(n_new):
        lgs.append(logits[0].float().cpu())
        tok = logits.argmax(-1).to(torch.int32)
        out.append(int(tok[0]))
        if i + 1 < n_new:
            logits, cache = eng.decode_step(tok, cache)
    return out, lgs


def moe_batching(eng, label, seed=62):
    """``ContinuousBatchingEngine`` over a MoE engine (max_batch 8, max_seq
    512, the slot cache in bf16: an MLA engine's holds the latents):
    DS_BATCH_REQUESTS, 8 at once and 2 joining as slots free.  Each
    request's prompt-pass and first step logits within DS_COPY_ROW_TOL of
    the same prompt alone (the engine at batch 1, bf16 cache; the first
    step fed the batcher's token on both sides), and its tokens equal to
    the request alone step by step; where they first differ the batcher's
    token must be a near-tie of the lone request's logits (within the same
    limit of their maximum), and the comparison of that request stops
    there.  Prints the share of tokens equal."""
    from autoround_tpu_torch.serve import ContinuousBatchingEngine

    t0 = time.time()
    single = dataclasses.replace(eng, kv_quant=None)
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, eng.cfg.vocab_size, (n,),
                             generator=gen).tolist()
               for n, _ in DS_BATCH_REQUESTS]
    be = ContinuousBatchingEngine(single, max_batch=8, max_seq=512)
    if getattr(eng.cfg, "kv_lora_rank", 0):
        check(be.cache.k.shape[-1] == eng.cfg.kv_lora_rank
              and be.cache.v.shape[-1] == eng.cfg.qk_rope_head_dim,
              f"{label} batching: slot cache {tuple(be.cache.k.shape)}")
    first, joined, rid_of = {}, {}, {}
    waiting = list(range(len(DS_BATCH_REQUESTS)))
    steps = 0
    while waiting or be.pending():
        while waiting and be._free:
            i = waiting.pop(0)
            rid = be.submit(prompts[i], max_new_tokens=DS_BATCH_REQUESTS[i][1])
            rid_of[i] = rid
            joined[rid] = be._requests[rid].slot
            first[rid] = [be.last_logits[joined[rid]].float().cpu()]
        be.step()
        steps += 1
        for rid, slot in joined.items():
            first[rid].append(be.last_logits[slot].float().cpu())
        joined.clear()
    check(be._decode.graph is not None, f"{label} batching: not captured")
    worst, agree, total, fed = 0.0, 0, 0, 0
    for i, (n, n_new) in enumerate(DS_BATCH_REQUESTS):
        rid = rid_of[i]
        ids = torch.tensor([prompts[i]])
        want, lgs = _tokens_and_logits(single, ids, n_new)
        got = be.result(rid)
        r0 = row_err(first[rid][0], lgs[0])[1]
        if got[0] != want[0]:
            # a near-tie of the prompt pass (held below) fed the batcher's
            # first step another token: hold that step against the
            # request alone fed the same token
            fed += 1
            lgs1 = _step_logits(single, ids, torch.tensor(
                [got[0]], dtype=torch.int32))[1][0]
        else:
            lgs1 = lgs[1]
        r1 = row_err(first[rid][1], lgs1)[1]
        worst = max(worst, r0, r1)
        check(r0 <= DS_COPY_ROW_TOL and r1 <= DS_COPY_ROW_TOL,
              f"{label} batching: request {i} logits row_err {r0:.4g} / "
              f"{r1:.4g} against the request alone")
        check(len(got) == n_new, f"{label} batching: request {i} gave "
              f"{len(got)} tokens")
        for j, (a, b) in enumerate(zip(got, want)):
            if a != b:
                lg = lgs[j]
                gap = (lg.max() - lg[a]) / lg.pow(2).mean().sqrt()
                check(gap.item() <= DS_COPY_ROW_TOL,
                      f"{label} batching: request {i} step {j} token {a} "
                      f"is {gap.item():.4g} row RMS below the lone "
                      f"request's maximum ({b})")
                break
            agree += 1
        total += n_new
    log(f"{label} batching (max_batch 8, max_seq 512, bf16 slots): "
        f"{len(DS_BATCH_REQUESTS)} requests in {steps} steps; prompt-pass "
        f"and first-step logits against each request alone worst "
        f"row_err={worst:.4g} (tol {DS_COPY_ROW_TOL}; {fed} first steps fed "
        f"the batcher's own near-tie token on both sides); tokens equal to "
        f"the request alone up to any near-tie: {agree} of {total}; "
        f"capture_ms={be._decode.capture_ms:.2f} "
        f"batching_s={time.time() - t0:.1f}")
    del be, single


def moe_fp8_cache(eng, prompts, n_layers=4, label="deepseek fp8 latents"):
    """The fp8 (e4m3) cache on the first ``n_layers`` blocks of a MoE
    engine (an MLA engine's latents, or the K / V heads): ``generate_scan``
    equal to ``generate`` (tokens and launches); the cache e4m3 with a
    scale per layer (per layer and KV head for K / V); what the prompt
    pass stores within half an e4m3 step of the bf16 cache; and the first
    decode step.  An MLA engine's step quantizes its own token's latents
    before it attends (the JAX block's order): its logits are held within
    DS_FP8_ROW_TOL of the same copy with the bf16 cache.  A GQA engine's
    step dequantizes the cache into a bf16 copy and writes its own token
    unquantized there (the JAX engine's order): its logits are held within
    FP8_READ_ROW_TOL of the same copy decoding over a bf16 cache that holds
    the dequantized e4m3 values, and their distance to the plain bf16 cache
    is printed: GQA heads at full width move it by a share that the random
    weights set, not the code (measured on an H100: llama4-scout 0.37-0.44
    of a row's RMS, and whole rows where a top-1 router's near-tie fell the
    other way)."""
    from autoround_tpu_torch.models import deepseek

    t0 = time.time()
    bf = dataclasses.replace(copy_engine(eng, n_layers, "cuda"),
                             kv_quant=None)
    fp8 = dataclasses.replace(bf, kv_quant="fp8")
    toks, counts = generate_counted(fp8, prompts, 16)
    scan_against(fp8, prompts, toks, counts, label)
    st = fp8._scan_states[prompts.shape[0]]
    heads = 1 if getattr(eng.cfg, "kv_lora_rank", 0) else eng.cfg.num_kv_heads
    check(st.cache.k.dtype == torch.float8_e4m3fn
          and st.cache.k_scale.shape == (n_layers, 1, 1, heads, 1),
          f"{label}: cache {st.cache.k.dtype} scales "
          f"{tuple(st.cache.k_scale.shape)}")
    S = prompts.shape[1]
    with counts_kept():
        b1, cb = bf.prefill(prompts)
        f1, cf = fp8.prefill(prompts)
        tok = b1.argmax(-1).to(torch.int32)
        # the prompt's cache: e4m3 codes times their scale within half an
        # e4m3 step of the bf16 cache (2^-4 of a normal value, 2^-10 of
        # the scale below the normals)
        cache_ok = all(
            bool(((q[:, :, :S].float() * sc - ref[:, :, :S].float()).abs()
                  <= ref[:, :, :S].float().abs() / 16 + sc / 1024
                  + 1e-6).all())
            for q, sc, ref in ((cf.k, cf.k_scale, cb.k),
                               (cf.v, cf.v_scale, cb.v)))
        b2 = bf.decode_step(tok, cb)[0].cpu()
        # the same bf16 copy, its cache holding the dequantized e4m3 values
        _, cd = bf.prefill(prompts)
        for q, sc, ref in ((cf.k, cf.k_scale, cd.k), (cf.v, cf.v_scale,
                                                       cd.v)):
            ref[:, :, :S] = (q[:, :, :S].float() * sc).to(ref.dtype)
        d2 = bf.decode_step(tok, cd)[0].cpu()
        f2 = fp8.decode_step(tok, cf)[0].cpu()
    del cb, cf, cd
    r1 = row_err(f1.cpu(), b1.cpu())[1]
    r_read = row_err(f2, d2)[1]
    d = (f2.float() - b2.float()).abs().amax(-1)
    rows = d / b2.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)
    mla = deepseek.is_mla(eng.cfg)
    log(f"{label} ({n_layers} layers): generate_scan tokens "
        f"and launches equal generate's; prompt cache within half an e4m3 "
        f"step of the bf16 cache: {cache_ok}; first decode step against the "
        f"bf16 cache holding the dequantized codes row_err={r_read:.4g} "
        f"({'printed: the step quantizes its own token' if mla else 'tol %g' % FP8_READ_ROW_TOL}); "
        f"against the plain bf16 cache: prefill "
        f"row_err={r1:.4g} (the cache is written, not read), first decode "
        f"step row_err={rows.max().item():.4g} "
        f"({'tol %g' % DS_FP8_ROW_TOL if mla else 'printed'}; rows "
        f"{[round(r, 4) for r in rows.tolist()]}); "
        f"fp8_s={time.time() - t0:.1f}")
    check(cache_ok, f"{label}: the e4m3 cache is not the bf16 cache rounded")
    check(r1 <= FP8_READ_ROW_TOL and (mla or r_read <= FP8_READ_ROW_TOL),
          f"{label}: the step does not read the e4m3 cache as stored")
    check(not mla or rows.max().item() <= DS_FP8_ROW_TOL,
          f"{label}: logits disagree with the bf16 cache")
    del bf, fp8


def perturb_moe(params, seed):
    """A MoE family's random weights moved off their initial values:
    ``perturb_gains`` (every 1-D block leaf by N(0, 0.1)), then a router's
    bias drawn from N(0, 0.5) (DeepSeek's ``e_score_correction_bias``,
    GPT-OSS's ``router_bias``), GPT-OSS's sinks from N(0, 1), so that the
    sink column changes the softmax, and each expert's biases moved by
    N(0, 0.1)."""
    perturb_gains(params, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for b in params["blocks"]:
        for k, std in (("e_score_correction_bias", 0.5),
                       ("router_bias", 0.5), ("sinks", 1.0)):
            if k in b:
                b[k].normal_(0.0, std, generator=gen)
        for ew in b.get("experts", ()):
            for k, t in ew.items():
                if k.endswith("_bias"):
                    t.add_(torch.randn(t.shape, generator=gen,
                                       device=t.device, dtype=t.dtype),
                           alpha=0.1)


def _moe_quantize(cfg, calib, seed, label, **kw):
    """Random weights of ``cfg``'s family on the card, moved by
    ``perturb_moe``, quantized by AutoRound with the blocks donated;
    returns the result."""
    from autoround_tpu_torch import AutoRound
    from autoround_tpu_torch.models.registry import get_model_fns

    t0 = time.time()
    params = get_model_fns(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    perturb_moe(params, seed)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    ar = AutoRound((params, cfg), donate_params=True, **kw)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    log(f"{label}: init_s={t_init:.2f} quantize_s={t_quant:.2f} "
        f"({len(result.layers)} layers, {json.dumps(kw)})")
    return result


def deepseek_v2lite_path(bw, flops_peak, n_layers):
    """(a) deepseek-v2-lite at full width, ``n_layers`` of 27 layers: RTN
    W4A16 g128 with the lm_head → engine (int8 latent cache, max_seq 1024)
    → ``generate`` for 8 x 512 prompts, 32 new tokens, launches equal to
    the loops'; timings and bounds; a 2-layer copy (dense + MoE) on the
    plain versions; ``generate_scan`` against ``generate``; the replayed
    step at batch 8 and 1; the fp8 latent cache on 4 layers; the batcher
    at 8 slots.  Returns the launches of ``generate``."""
    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.models import deepseek

    t_path = time.time()
    kernels = _kernel_fns()
    cfg = dataclasses.replace(deepseek.CONFIG_PRESETS["deepseek-v2-lite"],
                              num_layers=n_layers)
    B, S, MAX_SEQ = 8, 512, 1024
    gen = torch.Generator().manual_seed(63)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = _moe_quantize(cfg, calib, 64, f"deepseek-v2-lite x {n_layers}",
                          scheme="W4A16", iters=0, quant_lm_head=True)
    E = cfg.n_routed_experts
    check(len(result.layers) == 4 * n_layers + 3 + (n_layers - 1)
          * 3 * (E + 1) + 1, f"deepseek-v2-lite: {len(result.layers)} "
          f"quantized layers")
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=MAX_SEQ,
                                              kv_quant="int8")
    torch.cuda.synchronize()
    t_pack = time.time() - t0
    kvb, other = _ds_dense(eng, result)
    del result
    free_device_memory()
    for i in range(1, n_layers):
        stacked = sorted(k for k in eng.packed
                         if k.startswith(f"blocks.{i}.experts_stack."))
        check(stacked == [f"blocks.{i}.experts_stack.{w}"
                          for w in ("down_proj", "gate_proj", "up_proj")],
              f"deepseek-v2-lite: block {i} stacked {stacked}")
    # the dense block's MLP is 10944 = 85.5 x 128 wide: its down_proj
    # (K = 10944) is not tileable at g = 128 and serves dense
    check(len(kvb) == n_layers and other == ["blocks.0.down_proj"],
          f"deepseek-v2-lite: dense layers {other}")
    log(f"deepseek-v2-lite engine: pack_s={t_pack:.2f} {len(eng.packed)} "
        f"packed entries ({sum(v == 'w4a16_grouped' for v in eng.packed_kinds.values())} "
        f"expert stacks); dense: {len(kvb)} kv_b_proj (absorbed decode), "
        f"{other} (K = {cfg.intermediate_size}, not a multiple of 128); "
        f"resident_gb={torch.cuda.memory_allocated() / 1e9:.2f} "
        f"quantize_peak_gb={quant_gb:.2f} weight_gb="
        f"{_weight_bytes(eng) / 1e9:.3f}")
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, DS_NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    log(f"deepseek-v2-lite kernels {json.dumps(launches)} "
        f"generate_s={t_gen:.2f}")
    _ds_counts(launches, _ds_want(eng, DS_NEW), "deepseek-v2-lite")
    _check_tokens(toks, B, DS_NEW, cfg.vocab_size)
    prefill_ms, step_ms = time_serving(eng, prompts, DS_NEW, bw, flops_peak)
    check_copy(eng, prompts, "card", DS_COPY_ROW_TOL)
    scan_path(eng, prompts, toks, gen_counts, "deepseek-v2-lite", step_ms)
    s8 = scan_measure(eng, B, S, bw, flops_peak, None, seed=65,
                      label="deepseek-v2-lite", ran=(prompts, step_ms))
    s1 = scan_measure(eng, 1, S, bw, flops_peak, None, seed=66,
                      label="deepseek-v2-lite")
    moe_fp8_cache(eng, prompts, min(4, n_layers))
    moe_batching(eng, "deepseek-v2-lite")
    log(f"deepseek-v2-lite path ({n_layers} of 27 layers): prefill_ms="
        f"{prefill_ms:.2f} graph step B=8 {s8['step_ms']:.4f} ms (bound "
        f"{s8['bound_ms']:.4f}, busy {s8['busy']:.3f}), B=1 "
        f"{s1['step_ms']:.4f} ms (bound {s1['bound_ms']:.4f}, busy "
        f"{s1['busy']:.3f}); peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} path_s="
        f"{time.time() - t_path:.1f}")
    del eng
    return launches


class _BlockLosses(logging.Handler):
    """Collects each block's (first, best, seconds) from the orchestrator's
    log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.blocks = {}

    def emit(self, record):
        if str(record.msg).startswith("block %d: loss"):
            bi, first, best, secs = record.args
            self.blocks[bi] = (float(first), float(best), float(secs))


def deepseek_tune_path(n_layers=2, iters=10):
    """(b) SignRound (``iters``, 16 x 512 ids, batch 8) on the first
    ``n_layers`` deepseek-v2-lite blocks (block 0 dense, block 1 MoE:
    64 experts tuned dense-then-mask), then served (int8 latent cache):
    ``generate_scan`` equal to ``generate``.  Prints each block's first
    and best loss and its ms a tuning step."""
    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.models import deepseek
    from autoround_tpu_torch.utils.logger import logger as ar_logger

    t_path = time.time()
    cfg = dataclasses.replace(deepseek.CONFIG_PRESETS["deepseek-v2-lite"],
                              num_layers=n_layers)
    gen = torch.Generator().manual_seed(67)
    calib = torch.randint(0, cfg.vocab_size, (16, 512), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    torch.cuda.reset_peak_memory_stats()
    h = _BlockLosses()
    level = ar_logger.level
    ar_logger.addHandler(h)
    ar_logger.setLevel(logging.INFO)
    try:
        result = _moe_quantize(cfg, calib, 68, f"deepseek-v2-lite tune x "
                              f"{n_layers}", scheme="W4A16", iters=iters,
                              batch_size=8)
    finally:
        ar_logger.removeHandler(h)
        ar_logger.setLevel(level)
    check(sorted(h.blocks) == list(range(n_layers)),
          f"deepseek tune: losses of blocks {sorted(h.blocks)}")
    for bi, (first, best, secs) in sorted(h.blocks.items()):
        trace = result.loss_traces[bi]
        check(bool(torch.isfinite(torch.as_tensor(trace)).all())
              and best <= first,
              f"deepseek tune: block {bi} first {first} best {best}")
        log(f"deepseek tune block {bi} ({'MoE' if cfg.layer_is_moe(bi) else 'dense'}): "
            f"loss first {first:.6g} best {best:.6g} "
            f"tune_step_ms={secs / iters * 1e3:.1f} (block seconds over "
            f"{iters} steps)")
    tune_gb = torch.cuda.max_memory_allocated() / 1e9
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=256,
                                              kv_quant="int8")
    del result
    toks, counts = generate_counted(eng, prompts, 8)
    _check_tokens(toks, 2, 8, cfg.vocab_size)
    scan_against(eng, prompts, toks, counts, "deepseek tune")
    log(f"deepseek tune path: served, generate_scan tokens and launches "
        f"equal generate's; tune_peak_gb={tune_gb:.2f} path_s="
        f"{time.time() - t_path:.1f}")
    del eng


def deepseek_v3_path(bw, flops_peak, n_layers):
    """(c) deepseek-v3 at full width, ``n_layers`` of 61 layers (3 dense
    blocks, then MoE: 256 experts, sigmoid router with its bias from N(0,
    0.5), groups 8 / 4, q LoRA 1536): RTN W4A16 g128 with the lm_head →
    engine (int8 latent cache) → ``generate`` for 2 x 128 prompts, 16 new
    tokens, launches equal to the loops'; ``generate_scan`` against it; a
    2-layer copy holding the last dense block and the first MoE block on
    the plain versions; the replayed step at batch 8.  Returns the
    launches."""
    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.models import deepseek

    t_path = time.time()
    kernels = _kernel_fns()
    cfg = dataclasses.replace(deepseek.CONFIG_PRESETS["deepseek-v3"],
                              num_layers=n_layers)
    B, S, NEW = 2, 128, 16
    gen = torch.Generator().manual_seed(69)
    calib = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = _moe_quantize(cfg, calib, 70, f"deepseek-v3 x {n_layers}",
                          scheme="W4A16", iters=0, quant_lm_head=True)
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=512,
                                              kv_quant="int8")
    kvb, other = _ds_dense(eng, result)
    del result
    free_device_memory()
    n_moe = sum(cfg.layer_is_moe(i) for i in range(n_layers))
    check(not other and len(kvb) == n_layers
          and sum(v == "w4a16_grouped" for v in eng.packed_kinds.values())
          == 3 * n_moe, f"deepseek-v3: dense {other}, kinds "
          f"{sorted(set(eng.packed_kinds.values()))}")
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    log(f"deepseek-v3 ({n_layers} of 61 layers, {n_moe} MoE) kernels "
        f"{json.dumps(launches)} generate_s={t_gen:.2f} resident_gb="
        f"{torch.cuda.memory_allocated() / 1e9:.2f} weight_gb="
        f"{_weight_bytes(eng) / 1e9:.3f}")
    _ds_counts(launches, _ds_want(eng, NEW), "deepseek-v3")
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    if n_moe:
        check_copy(eng, prompts, "card", DS_COPY_ROW_TOL,
                   first=cfg.first_k_dense - 1)
    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    scan_path(eng, prompts, toks, gen_counts, "deepseek-v3", step_ms)
    s8 = scan_measure(eng, 8, S, bw, flops_peak, None, seed=72,
                      label="deepseek-v3")
    log(f"deepseek-v3 path: graph step B=8 {s8['step_ms']:.4f} ms (bound "
        f"{s8['bound_ms']:.4f}, busy {s8['busy']:.3f}) peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} path_s="
        f"{time.time() - t_path:.1f}")
    del eng
    return launches


def deepseek_load_path(root, n_layers=2):
    """(d) deepseek-v2-lite x ``n_layers`` written as an HF ``deepseek_v2``
    directory, read back (leaves bit-equal, the router's bias fp32), RTN'd
    by the CLI (``_cli_in_process``; its export equal byte for byte to the
    one of ``AutoRound``), loaded by ``from_pretrained``
    (a ``DeepseekConfig``, words bit-equal to the in-memory engine's,
    ``kv_b_proj`` dense); prefill and first-step logits within the copy
    limit of the in-memory engine with its scales rounded to fp16 (what
    the files store), ``generate_scan`` equal to ``generate``."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.export import save_quantized
    from autoround_tpu_torch.models import deepseek
    from autoround_tpu_torch.utils.hf_loader import (load_hf_checkpoint,
                                                     save_hf_checkpoint)

    import numpy as np

    t_path = time.time()
    cfg = dataclasses.replace(deepseek.CONFIG_PRESETS["deepseek-v2-lite"],
                              num_layers=n_layers)
    gen = torch.Generator().manual_seed(73)
    calib = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    params = deepseek.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(74), "cuda")
    perturb_gains(params, 74)
    hf = root / "ds_hf"
    save_hf_checkpoint(params, cfg, str(hf))
    hf_cfg = json.loads((hf / "config.json").read_text())
    lparams, lcfg = load_hf_checkpoint(str(hf))
    want, got = _flat(params), _flat(lparams)
    check(hf_cfg["model_type"] == "deepseek_v2" and lcfg == cfg
          and sorted(want) == sorted(got)
          and all(torch.equal(want[k], got[k]) for k in want),
          "deepseek load: the loaded checkpoint differs from the written one")
    del params, want, got
    np.save(root / "ds_ids.npy", calib.numpy())
    cli_out = root / "ds_cli"
    t0 = time.time()
    rc, cli_stdout = _cli_in_process([
        "--model", str(hf), "--scheme", "W4A16", "--iters", "0",
        "--quant-lm-head", "--dataset", str(root / "ds_ids.npy"),
        "--nsamples", "4", "--seqlen", "256", "--format", "autoround",
        "--output", str(cli_out)])
    t_cli = time.time() - t0
    check(rc == 0, f"deepseek load: the CLI exited {rc}: "
          f"{cli_stdout[-2000:]}")
    result = AutoRound((lparams, lcfg), scheme="W4A16", iters=0,
                       quant_lm_head=True).quantize(
        calib, mask=torch.ones(calib.shape))
    del lparams
    mem_out = root / "ds_mem"
    save_quantized(result, lcfg, str(mem_out), "autoround")
    _same_files(cli_out, mem_out, "deepseek load: the CLI's export against "
                "the in-process one")
    shutil.rmtree(hf)
    shutil.rmtree(mem_out)
    mem = QuantizedLlama.from_quantize_result(result, lcfg, max_seq=512,
                                              kv_quant="int8")
    del result
    disk = QuantizedLlama.from_pretrained(str(cli_out), max_seq=512,
                                          kv_quant="int8")
    check(type(disk.cfg) is deepseek.DeepseekConfig
          and disk.cfg == lcfg
          and not any("kv_b_proj" in k for k in disk.packed),
          f"deepseek load: from_pretrained config {disk.cfg}")
    _packed_equal(disk, mem, "deepseek load: from_pretrained")
    _logits_against(disk, mem, prompts, "deepseek load: from_pretrained")
    toks, counts = generate_counted(disk, prompts, 8)
    scan_against(disk, prompts, toks, counts, "deepseek load")
    log(f"deepseek load path (v2-lite x {n_layers}, HF deepseek_v2 dir): "
        f"CLI (in process) exit 0 in {t_cli:.2f} s, export equal to the "
        f"in-process one, "
        f"from_pretrained a DeepseekConfig with {len(disk.packed)} packed "
        f"entries, generate_scan equal to generate; path_s="
        f"{time.time() - t_path:.1f}")
    shutil.rmtree(cli_out)
    del disk, mem


def deepseek_phase(bw, flops_peak, n_layers, v3_layers):
    """The DeepSeek family: row 5 at its shapes, then paths (a)-(d)
    (deepseek_v2lite_path, deepseek_tune_path, deepseek_v3_path,
    deepseek_load_path); returns {"v2lite": launches, "v3": launches}."""
    t0 = time.time()
    ds_grouped_shapes()
    out = {"v2lite": deepseek_v2lite_path(bw, flops_peak, n_layers)}
    free_device_memory()
    deepseek_tune_path()
    free_device_memory()
    out["v3"] = deepseek_v3_path(bw, flops_peak, v3_layers)
    free_device_memory()
    root = Path(tempfile.mkdtemp(prefix="ds_load_"))
    try:
        deepseek_load_path(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    log(f"deepseek phase: deepseek_s={time.time() - t0:.1f}")
    return out


# ------------------------------------------------------ GPT-OSS and Llama 4
#
# The seventeenth slice's families at their published widths (random
# weights from a seed, moved off their initial values by ``perturb_moe``):
# gpt-oss-20b (sinks in every softmax, the 128 window on the even layers,
# 32 biased clamped-SwiGLU experts, YaRN) at W4A16 g32 (2880 is 22.5 x
# 128: no g128 group packs), gpt-oss-120b's 128 experts, llama4-scout (16
# input-scaled experts and a shared one, chunked rope layers and NoPE
# layers 3, 7, ...) at W4A16 g128, Scout past its 8192 chunk, SignRound on
# both, and both loaded from HF directories with fused expert tensors.

OSS_NEW = 32
# (prompt length, new tokens) of the 8192-chunk path: the prompt crosses
# the chunk at prefill, the decode positions sit in the second chunk
CHUNK_PROMPT, CHUNK_MAX_SEQ = 8320, 8448


def _fam_want(eng, S, n_new):
    """Launches of ``generate`` (one prompt pass of S tokens, ``n_new`` - 1
    decode steps over the int8 cache) on a GPT-OSS, Llama 4 or GLM-4.5
    engine: each
    packed ``w4a16`` entry and each expert stack once a forward, the decode
    kernel once a layer a step, and the flash kernel once a layer at
    prefill where its gate takes the prompt (Llama 4 below the chunk,
    GLM-4.5 from 512 tokens; never GPT-OSS: its sinks take the plain
    attention)."""
    cfg = eng.cfg
    flash = (not hasattr(cfg, "swiglu_limit") and cfg.hd % 128 == 0
             and S >= 512 and S % 256 == 0
             and (cfg.sliding_window is None or S <= cfg.sliding_window))
    return dict(_ds_want(eng, n_new),
                decode_attention=cfg.num_layers * (n_new - 1),
                flash_attention=cfg.num_layers if flash else 0)


def _experts_stacked(eng, label):
    """Every MoE block's gate / up / down triple stacked for row 5, no
    expert served per expert by row 4 or dense."""
    cfg = eng.cfg
    moe = [i for i, b in enumerate(eng.params["blocks"]) if "experts" in b]
    for i in moe:
        stacked = sorted(k for k in eng.packed
                         if k.startswith(f"blocks.{i}.experts_stack."))
        check(stacked == [f"blocks.{i}.experts_stack.{w}"
                          for w in ("down_proj", "gate_proj", "up_proj")],
              f"{label}: block {i} stacked {stacked}")
        check(all(ew.get(w) is None for ew in eng.params["blocks"][i][
            "experts"] for w in ("gate_proj", "up_proj", "down_proj")),
              f"{label}: block {i} holds a dense expert")
    check(not any(".experts." in k for k in eng.packed),
          f"{label}: an expert is packed alone (row 4)")
    check(not any(eng.params["blocks"][i].get(n) is not None
                  for i in range(cfg.num_layers)
                  for n in ("q_proj", "o_proj", "gate_proj"))
          and eng.params.get("lm_head") is None,
          f"{label}: a projection serves dense")
    return moe


def _moe_serve_path(bw, flops_peak, cfg, label, seed, scheme, B, S, new,
                    max_seq, copy_first=0, full=True, keep=False,
                    model_check=None):
    """RTN ``scheme`` with the lm_head → the int8-KV engine → ``generate``
    (B x S prompts, ``new`` tokens) with launches equal to ``_fam_want``;
    timings and bounds; ``model_check(eng, qdq params, prompts, label)``
    where given; a 2-layer copy from block ``copy_first`` on the plain
    versions on the card; ``generate_scan`` against ``generate`` (its
    launches, the replayed step's, in ``summary["scan_launches"]``); the
    replayed step at batch 8 (and, with ``full``, at batch 1 with a
    second call of new prompts, the fp8 cache on 4 layers and the batcher).
    Returns (launches, summary[, engine with ``keep``])."""
    from autoround_tpu_torch import QuantizedLlama

    t_path = time.time()
    kernels = _kernel_fns()
    gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = _moe_quantize(cfg, calib, seed + 1, label, scheme=scheme,
                           iters=0, quant_lm_head=True)
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=max_seq,
                                              kv_quant="int8")
    torch.cuda.synchronize()
    t_pack, pack_gb = time.time() - t0, torch.cuda.max_memory_allocated() / 1e9
    n_layers = len(result.layers)
    qdq_params = result.params if model_check is not None else None
    del result
    free_device_memory()
    moe = _experts_stacked(eng, label)
    log(f"{label} engine: {n_layers} quantized layers, pack_s={t_pack:.2f} "
        f"{len(eng.packed)} packed entries "
        f"({sum(v == 'w4a16_grouped' for v in eng.packed_kinds.values())} "
        f"expert stacks, MoE blocks {moe}); resident_gb="
        f"{torch.cuda.memory_allocated() / 1e9:.2f} quantize_peak_gb="
        f"{quant_gb:.2f} pack_peak_gb={pack_gb:.2f} weight_gb="
        f"{_weight_bytes(eng) / 1e9:.3f}")
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, new)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    log(f"{label} kernels {json.dumps(launches)} generate_s={t_gen:.2f}")
    _ds_counts(launches, _fam_want(eng, S, new), label)
    _check_tokens(toks, B, new, cfg.vocab_size)
    prefill_ms, step_ms = time_serving(eng, prompts, new, bw, flops_peak)
    if model_check is not None:
        model_check(eng, qdq_params, prompts, label)
        del qdq_params
        free_device_memory()
    check_copy(eng, prompts, "card", MOE_COPY_ROW_TOL, first=copy_first)
    c0 = launch_counts()
    scan_path(eng, prompts, toks, gen_counts, label, step_ms)
    c1 = launch_counts()
    summary = dict(prefill_ms=prefill_ms)
    scan_launches = {n: c1[n] - c0[n] for n in launches}
    summary["B8"] = scan_measure(eng, 8, S, bw, flops_peak, None,
                                 seed=seed + 2, label=label,
                                 ran=(prompts, step_ms) if B == 8 else None)
    if full:
        summary["B1"] = scan_measure(eng, 1, S, bw, flops_peak, None,
                                     seed=seed + 3, label=label, second=True)
        moe_fp8_cache(eng, prompts, min(4, cfg.num_layers),
                       label=f"{label} fp8 kv")
        moe_batching(eng, label)
    log(f"{label} path: prefill_ms={prefill_ms:.2f} graph step B=8 "
        + "; ".join(f"{b}: {m['step_ms']:.4f} ms (bound {m['bound_ms']:.4f}"
                    f", busy {m['busy']:.3f})"
                    for b, m in summary.items() if b != "prefill_ms")
        + f"; peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"path_s={time.time() - t_path:.1f}")
    summary["scan_launches"] = scan_launches
    if keep:
        return launches, summary, eng
    del eng
    return launches, summary


def gptoss_path(bw, flops_peak, n_layers):
    """(a) gpt-oss-20b at full width, ``n_layers`` of 24: RTN W4A16 g32
    with the lm_head, 8 x 512 prompts (the 128 window bites on the even
    layers), 32 new tokens, int8 KV (row 6 with the sinks and the window),
    max_seq 1024; everything of ``_moe_serve_path``."""
    from autoround_tpu_torch.models import gptoss

    cfg = dataclasses.replace(gptoss.CONFIG_PRESETS["gpt-oss-20b"],
                              num_layers=n_layers)
    return _moe_serve_path(bw, flops_peak, cfg, f"gpt-oss-20b x {n_layers}",
                           81, "W4A16G32", 8, 512, OSS_NEW, 1024)


def gptoss120_path(bw, flops_peak, n_layers):
    """(b) gpt-oss-120b at full width, ``n_layers`` of 36 (row 5 at E =
    128): 2 x 128 prompts, 16 new tokens; the replayed step at batch 8."""
    from autoround_tpu_torch.models import gptoss

    cfg = dataclasses.replace(gptoss.CONFIG_PRESETS["gpt-oss-120b"],
                              num_layers=n_layers)
    return _moe_serve_path(bw, flops_peak, cfg,
                           f"gpt-oss-120b x {n_layers}", 85, "W4A16G32", 2,
                           128, 16, 512, full=False)[0]


def _moe_tune_path(cfg, label, seed, scheme, n_layers, batch, iters=20,
                   nsamples=16):
    """SignRound (``iters``, ``nsamples`` x 512 ids, ``batch`` a step) on
    the first ``n_layers`` blocks, then served (int8 KV; a hybrid engine
    warns and keeps its dense cache): ``generate_scan`` equal to
    ``generate``.  Prints each block's first and best loss and its ms a
    tuning step; returns the launches of the tuning."""
    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.utils.logger import logger as ar_logger

    t_path = time.time()
    kernels = _kernel_fns()
    gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (nsamples, 512), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    h = _BlockLosses()
    level = ar_logger.level
    ar_logger.addHandler(h)
    ar_logger.setLevel(logging.INFO)
    try:
        result = _moe_quantize(cfg, calib, seed + 1, label, scheme=scheme,
                               iters=iters, batch_size=batch)
    finally:
        ar_logger.removeHandler(h)
        ar_logger.setLevel(level)
    launches = {n: fn.launches for n, fn in kernels.items()}
    check(sorted(h.blocks) == list(range(n_layers)),
          f"{label}: losses of blocks {sorted(h.blocks)}")
    for bi, (first, best, secs) in sorted(h.blocks.items()):
        trace = result.loss_traces[bi]
        check(bool(torch.isfinite(torch.as_tensor(trace)).all())
              and best <= first, f"{label}: block {bi} first {first} best "
              f"{best}")
        kind = ({"linear_attention": "DeltaNet" if hasattr(
                    cfg, "linear_num_key_heads") else "lightning",
                 "full_attention": "full"}[cfg.layer_types[bi]]
                if "linear_attention" in (cfg.layer_types or ()) else
                ("MoE" if cfg.layer_is_moe(bi) else "dense")
                if hasattr(cfg, "layer_is_moe") else
                "rope" if getattr(cfg, "no_rope_layers", None) is None
                or cfg.no_rope_layers[bi] else "NoPE")
        log(f"{label} block {bi} ({kind}): loss first {first:.6g} best "
            f"{best:.6g} tune_step_ms={secs / iters * 1e3:.1f} (block "
            f"seconds over {iters} steps)")
    tune_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label} tuning kernels {json.dumps(launches)}")
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=256,
                                              kv_quant="int8")
    del result
    toks, counts = generate_counted(eng, prompts, 8)
    _check_tokens(toks, 2, 8, cfg.vocab_size)
    scan_against(eng, prompts, toks, counts, label)
    log(f"{label} path: served, generate_scan tokens and launches equal "
        f"generate's; tune_peak_gb={tune_gb:.2f} path_s="
        f"{time.time() - t_path:.1f}")
    del eng
    return launches


def gptoss_tune_path(n_layers=1):
    """(c) SignRound W4A16 g32 (iters 10) on the first ``n_layers``
    gpt-oss-20b blocks (32 experts tuned dense-then-mask each)."""
    from autoround_tpu_torch.models import gptoss

    cfg = dataclasses.replace(gptoss.CONFIG_PRESETS["gpt-oss-20b"],
                              num_layers=n_layers)
    return _moe_tune_path(cfg, f"gpt-oss tune x {n_layers}", 87,
                          "W4A16G32", n_layers, 8, iters=10)


def _scout(n_layers, first=0):
    """llama4-scout-16e cut to ``n_layers`` from layer ``first`` on (its
    per-layer tuples cut with it)."""
    from autoround_tpu_torch.models import llama4

    full = llama4.CONFIG_PRESETS["llama4-scout-16e"]
    end = first + n_layers
    return dataclasses.replace(
        full, num_layers=n_layers,
        no_rope_layers=full.no_rope_layers[first:end],
        layer_types=full.layer_types[first:end],
        moe_layers=tuple(i - first for i in full.moe_layers
                         if first <= i < end))


def scout_path(bw, flops_peak, n_layers):
    """(d) llama4-scout at full width, ``n_layers`` of 48 (layers 3, 7, ...
    NoPE): RTN W4A16 g128 with the lm_head, served as (a), the 2-layer
    copy holding blocks 2-3 (a rope and a NoPE layer).  Returns
    (launches, summary, engine) for the chunk path."""
    return _moe_serve_path(bw, flops_peak, _scout(n_layers),
                           f"llama4-scout x {n_layers}", 91, "W4A16", 8, 512,
                           OSS_NEW, 1024, copy_first=2, keep=True)


def llama4_chunk_path(eng):
    """(e) The first 4 blocks of the Scout engine (3 chunked rope layers,
    NoPE layer 3) past the 8192 chunk: one prompt of 8320 tokens (the
    chunked mask at prefill, plain attention: 8320 is not a multiple of
    256), max_seq 8448, 32 new tokens over the int8 cache (row 6 with
    ``chunk``: positions 8320.. see the keys from 8192 on); launches as
    the loops imply; the prefill's device peak; the 2-layer copy of blocks
    2-3 (the NoPE temperature above 1 from position 8191) on the plain
    versions on the card.  Returns the launches."""
    t_path = time.time()
    kernels = _kernel_fns()
    ce = dataclasses.replace(copy_engine(eng, 4, "cuda"),
                             max_seq=CHUNK_MAX_SEQ)
    gen = torch.Generator().manual_seed(95)
    prompt = torch.randint(0, ce.cfg.vocab_size, (1, CHUNK_PROMPT),
                           generator=gen)
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    with counts_kept():
        logits, cache = ce.prefill(prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.time() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(logits).all()), "llama4 chunk: prefill logits")
    del logits, cache
    for fn in kernels.values():
        fn.launches = 0
    toks, _ = generate_counted(ce, prompt, OSS_NEW)
    launches = {n: fn.launches for n, fn in kernels.items()}
    _ds_counts(launches, _fam_want(ce, CHUNK_PROMPT, OSS_NEW), "llama4 chunk")
    _check_tokens(toks, 1, OSS_NEW, ce.cfg.vocab_size)
    log(f"llama4 chunk (scout x 4, 1 x {CHUNK_PROMPT} prompt, chunk "
        f"{ce.cfg.sliding_window}, max_seq {CHUNK_MAX_SEQ}, int8 KV): "
        f"prefill_ms={prefill_ms:.2f} prefill device peak_gb={peak_gb:.2f} "
        f"(resident before {base_gb:.2f}); kernels {json.dumps(launches)}; "
        f"decode positions {CHUNK_PROMPT}..{CHUNK_PROMPT + OSS_NEW - 2} "
        f"attend the keys from {CHUNK_PROMPT // ce.cfg.sliding_window * ce.cfg.sliding_window}")
    check_copy(ce, prompt, "card", MOE_COPY_ROW_TOL, first=2)
    log(f"llama4 chunk path: path_s={time.time() - t_path:.1f}")
    del ce
    return launches


def llama4_tune_path(n_layers=2):
    """(f) SignRound W4A16 g128 (iters 10) on Scout's blocks 2-3 (a rope
    layer and NoPE layer 3: both ``block_fwd_for`` variants; rows 1-3 in
    the tuning loss; blocks 0-3 and iters 20 until the ernie / longcat /
    step35 phase came), 4 sequences a step: at 8 a step the tuning peaked
    at 78.86 of the card's 85.9 GB (measured on an H100; a block's 2.2 B
    weights carry their fp32 tuning state)."""
    return _moe_tune_path(_scout(n_layers, first=4 - n_layers),
                          f"llama4 tune x {n_layers}", 97, "W4A16", n_layers,
                          4, iters=10)


def write_hf_fused(params, cfg, path, hf_config=None):
    """An HF ``gpt_oss``, ``llama4_text`` or ``qwen3_5_moe`` directory of a
    port parameter tree (on any device), the experts fused as the
    published checkpoints store them: ``gate_up_proj`` (E, H, 2I),
    GPT-OSS's gate / up columns interleaved (gate even) with its biases
    likewise, Llama 4's in halves, ``down_proj`` (E, I, H); Qwen3.5's
    ``gate_up_proj`` (E, 2I, H) in halves and ``down_proj`` (E, H, I), its
    DeltaNet leaves under ``linear_attn.*`` (the conv (conv_dim, 1, K),
    ``dt_bias`` / ``A_log`` fp32) and one ``mtp.*`` draft tensor that the
    loader skips; its ``config.json`` is ``hf_config``.  Written with the
    port's safetensors writer; the JAX package has no writer for these
    families."""
    from autoround_tpu_torch.utils.safetensors_io import save_file

    oss = hasattr(cfg, "swiglu_limit")
    t = {"model.embed_tokens.weight": params["embed_tokens"],
         "model.norm.weight": params["norm"],
         "lm_head.weight": params["lm_head"]}
    if hf_config is not None:
        _qwen35_tensors(params, t)
        path.mkdir(parents=True, exist_ok=True)
        save_file({k: v.contiguous() for k, v in t.items()},
                  str(path / "model.safetensors"))
        (path / "config.json").write_text(json.dumps(hf_config, indent=2))
        return
    for li, b in enumerate(params["blocks"]):
        p = f"model.layers.{li}."
        for n in ("q", "k", "v", "o"):
            t[f"{p}self_attn.{n}_proj.weight"] = b[f"{n}_proj"]
            if oss:
                t[f"{p}self_attn.{n}_proj.bias"] = b[f"{n}_bias"]
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{n}.weight"] = b[n]
        ex = b.get("experts")
        if oss:
            t[p + "self_attn.sinks"] = b["sinks"]
            t[p + "mlp.router.weight"] = b["router"]
            t[p + "mlp.router.bias"] = b["router_bias"]
            t[p + "mlp.experts.gate_up_proj"] = torch.stack([torch.stack(
                [e["gate_proj"].t(), e["up_proj"].t()], dim=-1).flatten(1)
                for e in ex])
            t[p + "mlp.experts.gate_up_proj_bias"] = torch.stack([
                torch.stack([e["gate_bias"], e["up_bias"]], -1).flatten()
                for e in ex])
            t[p + "mlp.experts.down_proj"] = torch.stack(
                [e["down_proj"].t() for e in ex])
            t[p + "mlp.experts.down_proj_bias"] = torch.stack(
                [e["down_bias"] for e in ex])
        elif ex is None:
            for n in ("gate_proj", "up_proj", "down_proj"):
                t[f"{p}feed_forward.{n}.weight"] = b[n]
        else:
            t[p + "feed_forward.router.weight"] = b["router"]
            t[p + "feed_forward.experts.gate_up_proj"] = torch.stack([
                torch.cat([e["gate_proj"].t(), e["up_proj"].t()], dim=1)
                for e in ex])
            t[p + "feed_forward.experts.down_proj"] = torch.stack(
                [e["down_proj"].t() for e in ex])
            for n in ("gate_proj", "up_proj", "down_proj"):
                t[f"{p}feed_forward.shared_expert.{n}.weight"] = \
                    b["shared_expert"][n]
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.contiguous() for k, v in t.items()},
              str(path / "model.safetensors"))
    hf = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
              intermediate_size=cfg.intermediate_size,
              num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads,
              num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
              num_local_experts=cfg.num_experts,
              num_experts_per_tok=cfg.top_k, tie_word_embeddings=False,
              torch_dtype="bfloat16")
    if oss:
        hf.update(model_type="gpt_oss", sliding_window=cfg.sliding_window,
                  rope_scaling=dict(
                      rope_type="yarn", factor=cfg.yarn_factor,
                      beta_fast=cfg.yarn_beta_fast,
                      beta_slow=cfg.yarn_beta_slow,
                      truncate=cfg.yarn_truncate,
                      original_max_position_embeddings=
                          cfg.yarn_original_max_pos))
    else:
        hf.update(model_type="llama4_text",
                  intermediate_size_mlp=cfg.intermediate_size_mlp,
                  moe_layers=list(cfg.moe_layers),
                  no_rope_layers=list(cfg.no_rope_layers),
                  attention_chunk_size=cfg.sliding_window,
                  layer_types=["chunked_attention"
                               if x == "sliding_attention" else x
                               for x in cfg.layer_types],
                  floor_scale=cfg.floor_scale,
                  attn_scale=cfg.temp_attn_scale)
    (path / "config.json").write_text(json.dumps(hf, indent=2))


def _qwen35_tensors(params, t):
    """The HF ``qwen3_5_moe`` keys of a Qwen3-Next parameter tree, into
    ``t`` (see :func:`write_hf_fused`)."""
    t["mtp.layers.0.mlp.gate_proj.weight"] = torch.ones(
        (64, 64), dtype=params["norm"].dtype, device=params["norm"].device)
    for li, b in enumerate(params["blocks"]):
        p = f"model.layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{n}.weight"] = b[n]
        if "in_proj_qkvz" in b:
            la = p + "linear_attn."
            for n in ("in_proj_qkvz", "in_proj_ba", "out_proj"):
                t[f"{la}{n}.weight"] = b[n]
            t[la + "conv1d.weight"] = b["conv1d"][:, None, :]
            t[la + "norm.weight"] = b["linear_norm"]
            t[la + "dt_bias"] = b["dt_bias"]
            t[la + "A_log"] = b["A_log"]
        else:
            for n in ("q_proj", "k_proj", "v_proj", "o_proj", "q_norm",
                      "k_norm"):
                t[f"{p}self_attn.{n}.weight"] = b[n]
        if "experts" not in b:
            for n in ("gate_proj", "up_proj", "down_proj"):
                t[f"{p}mlp.{n}.weight"] = b[n]
            continue
        ex = b["experts"]
        t[p + "mlp.gate.weight"] = b["router"]
        t[p + "mlp.experts.gate_up_proj"] = torch.stack(
            [torch.cat([e["w1"], e["w3"]]) for e in ex])
        t[p + "mlp.experts.down_proj"] = torch.stack([e["w2"] for e in ex])
        for w, n in (("w1", "gate_proj"), ("w3", "up_proj"),
                     ("w2", "down_proj")):
            t[f"{p}mlp.shared_expert.{n}.weight"] = b["shared_expert"][w]
        t[p + "mlp.shared_expert_gate.weight"] = b["shared_expert_gate"]


def _cli_in_process(argv):
    """``autoround_tpu_torch.cli.main(argv)`` in this process: (exit code,
    its standard output).  The family load paths run the CLI so (the load
    phase runs ``python -m autoround_tpu_torch`` in a subprocess; a second
    interpreter, its torch import and its CUDA context took 10-15 s a
    path); the logger's handlers and level come back as they were."""
    import io

    from autoround_tpu_torch import cli
    from autoround_tpu_torch.utils.logger import logger as ar_logger

    handlers, level = list(ar_logger.handlers), ar_logger.level
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        for h in list(ar_logger.handlers):
            if h not in handlers:
                ar_logger.removeHandler(h)
        ar_logger.setLevel(level)
    return rc, out.getvalue()


def oss_llama4_load_path(root, cfg, label, seed, group_size, hf_config=None,
                         write=None):
    """(g) ``cfg`` written as an HF directory with fused experts
    (``write_hf_fused``; ``hf_config``: a Qwen3.5 ``config.json``), read
    back (leaves bit-equal, the sinks, the router bias, ``A_log`` and
    ``dt_bias`` fp32), RTN'd by the CLI (``_cli_in_process``; its export
    equal byte for byte to the one of ``AutoRound``),
    loaded by ``from_pretrained`` (the family's config, words bit-equal to
    the in-memory engine's); prefill and first-step logits within the copy
    limit of the in-memory engine with fp16 scales (a Qwen3.5 export's
    equal to them), ``generate_scan`` equal to ``generate``.  ``write(params,
    cfg, path, hf_config)`` writes the directory instead where given (GLM-4.5
    through ``save_hf_checkpoint``, GLM-5 through ``write_hf_dsa``, MiniMax
    through ``write_hf_minimax``, whose export's logits are held equal as
    Qwen3.5's)."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.export import save_quantized
    from autoround_tpu_torch.models.registry import get_model_fns
    from autoround_tpu_torch.utils.hf_loader import load_hf_checkpoint

    import numpy as np

    t_path = time.time()
    gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    params = get_model_fns(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    perturb_moe(params, seed)
    hf = root / f"{label}_hf"
    t0 = time.time()
    (write or write_hf_fused)(params, cfg, hf, hf_config)
    t_write = time.time() - t0
    lparams, lcfg = load_hf_checkpoint(str(hf))
    want, got = _flat(params), _flat(lparams)
    check(type(lcfg) is type(cfg) and lcfg == cfg
          and sorted(want) == sorted(got)
          and all(torch.equal(want[k], got[k]) for k in want),
          f"{label} load: the loaded checkpoint differs from the written "
          f"one ({lcfg})")
    check(all(got[k].dtype == torch.float32 for k in got
              if k.endswith(("sinks", "router_bias", "A_log", "dt_bias",
                             "e_score_correction_bias", "slope_rate"))),
          f"{label} load: a sink, router bias, A_log, dt_bias or slope "
          f"rate is not fp32")
    del params, want, got
    np.save(root / f"{label}_ids.npy", calib.numpy())
    cli_out = root / f"{label}_cli"
    argv = ["--model", str(hf), "--iters", "0", "--quant-lm-head",
            "--dataset", str(root / f"{label}_ids.npy"), "--nsamples", "4",
            "--seqlen", "256", "--format", "autoround", "--output",
            str(cli_out), "--scheme", "W4A16", "--group-size",
            str(group_size)]
    result = AutoRound((lparams, lcfg),
                       scheme={128: "W4A16", 32: "W4A16G32"}[group_size],
                       iters=0, quant_lm_head=True).quantize(
        calib, mask=torch.ones(calib.shape))
    del lparams
    mem_out = root / f"{label}_mem"
    save_quantized(result, lcfg, str(mem_out), "autoround")
    t0 = time.time()
    rc, cli_stdout = _cli_in_process(argv)
    t_cli = time.time() - t0
    check(rc == 0, f"{label} load: the CLI exited {rc}: "
          f"{cli_stdout[-2000:]}")
    _same_files(cli_out, mem_out, f"{label} load: the CLI's export against "
                "the in-process one")
    shutil.rmtree(hf)
    shutil.rmtree(mem_out)
    mem = QuantizedLlama.from_quantize_result(result, lcfg, max_seq=512,
                                              kv_quant="int8")
    del result
    disk = QuantizedLlama.from_pretrained(str(cli_out), max_seq=512,
                                          kv_quant="int8")
    # an export's model_config names no class: Qwen3.5 comes back as the
    # Qwen3-Next class it subclasses, with the same fields
    check(isinstance(lcfg, type(disk.cfg))
          and dataclasses.asdict(disk.cfg) == dataclasses.asdict(lcfg),
          f"{label} load: from_pretrained config {disk.cfg}")
    if hasattr(cfg, "full_attn_alpha_factor"):         # MiniMax
        _mm_structure(disk, f"{label} load")
    elif hf_config is None:
        _experts_stacked(disk, f"{label} load")
    else:
        _q3n_structure(disk, f"{label} load")
    _packed_equal(disk, mem, f"{label} load: from_pretrained")
    _logits_against(disk, mem, prompts, f"{label} load: from_pretrained")
    if hf_config is not None:
        # the same words, fp16 scales and leaves through the same kernels
        same = [torch.equal(a, b) for a, b in zip(
            _step_logits(disk, prompts), _step_logits(_fp16_scales(mem),
                                                      prompts))]
        check(all(same), f"{label} load: logits not equal to the in-memory "
              f"engine's with fp16 scales (prefill, first step, token: "
              f"{same})")
        log(f"{label} load: prefill and first-step logits equal to the "
            f"in-memory engine's with fp16 scales, bit for bit; "
            f"hf_write_s={t_write:.2f}")
    toks, counts = generate_counted(disk, prompts, 8)
    scan_against(disk, prompts, toks, counts, f"{label} load")
    n_exp = getattr(cfg, "num_experts", 0) or getattr(cfg,
                                                      "n_routed_experts", 0)
    log(f"{label} load path (x {cfg.num_layers}, HF, {n_exp} experts"
        f"{' fused' if write is None else ''}): "
        f"CLI (in process) exit 0 in {t_cli:.2f} s, "
        f"export equal to the in-process one, "
        f"from_pretrained a {type(disk.cfg).__name__} with "
        f"{len(disk.packed)} packed entries, generate_scan equal to "
        f"generate; path_s={time.time() - t_path:.1f}")
    shutil.rmtree(cli_out)
    del disk, mem


def oss_llama4_phase(bw, flops_peak, oss_layers, oss120_layers, l4_layers):
    """GPT-OSS and Llama 4: paths (a)-(g) (gptoss_path, gptoss120_path,
    gptoss_tune_path, scout_path, llama4_chunk_path, llama4_tune_path, and
    oss_llama4_load_path for each family); returns their launches."""
    from autoround_tpu_torch.models import gptoss

    t0 = time.time()
    out = {}
    out["gpt_oss_20b"], s_oss = gptoss_path(bw, flops_peak, oss_layers)
    free_device_memory()
    out["gpt_oss_120b"] = gptoss120_path(bw, flops_peak, oss120_layers)
    free_device_memory()
    out["gpt_oss_tune"] = gptoss_tune_path()
    free_device_memory()
    out["llama4_scout"], s_l4, eng = scout_path(bw, flops_peak, l4_layers)
    out["llama4_chunk"] = llama4_chunk_path(eng)
    del eng
    free_device_memory()
    out["llama4_tune"] = llama4_tune_path()
    free_device_memory()
    root = Path(tempfile.mkdtemp(prefix="oss_l4_load_"))
    try:
        oss1 = dataclasses.replace(gptoss.CONFIG_PRESETS["gpt-oss-20b"],
                                   num_layers=1)
        oss_llama4_load_path(root, oss1, "gpt-oss", 99, 32)
        free_device_memory()
        oss_llama4_load_path(root, _scout(1), "llama4", 100, 128)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    log(f"gpt-oss / llama4 phase: gpt-oss-20b prefill_ms="
        f"{s_oss['prefill_ms']:.2f} B=8 {s_oss['B8']['step_ms']:.4f} ms "
        f"(bound {s_oss['B8']['bound_ms']:.4f}) B=1 "
        f"{s_oss['B1']['step_ms']:.4f} ms (bound {s_oss['B1']['bound_ms']:.4f}"
        f"); llama4-scout prefill_ms={s_l4['prefill_ms']:.2f} B=8 "
        f"{s_l4['B8']['step_ms']:.4f} ms (bound {s_l4['B8']['bound_ms']:.4f})"
        f" B=1 {s_l4['B1']['step_ms']:.4f} ms (bound "
        f"{s_l4['B1']['bound_ms']:.4f}); oss_llama4_s={time.time() - t0:.1f}")
    return out


# Qwen/Qwen3-Next-80B-A3B-Instruct's config.json (the published widths; 48
# layers, one full-attention layer in every 4: full_attention_interval 4).
# The file gives the pattern by full_attention_interval, which neither the
# JAX loader nor the port's reads (both take layer_types, and refuse or
# fail without it), so the layer_types written here are what transformers'
# Qwen3NextConfig derives from the interval and writes on save.
QWEN3_NEXT_HF = dict(
    model_type="qwen3_next", vocab_size=151936, hidden_size=2048,
    intermediate_size=5120, num_hidden_layers=48, num_attention_heads=16,
    num_key_value_heads=2, head_dim=256, partial_rotary_factor=0.25,
    rope_theta=10000000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
    hidden_act="silu", attention_bias=False, full_attention_interval=4,
    layer_types=["full_attention" if (i + 1) % 4 == 0 else "linear_attention"
                 for i in range(48)],
    linear_num_key_heads=16, linear_num_value_heads=32,
    linear_key_head_dim=128, linear_value_head_dim=128,
    linear_conv_kernel_dim=4, num_experts=512, num_experts_per_tok=10,
    moe_intermediate_size=512, shared_expert_intermediate_size=512,
    norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
    torch_dtype="bfloat16")
Q3N_NEW = 32
# prompts of the qwen3-next path (8 x 512; the dense-then-mask prefill's
# (E, N, H) bf16 slab of the 512 experts' w2 is 512 x 4096 x 2048 x 2 B)
Q3N_BATCH, Q3N_SEQ = 8, 512
# layer 0's recurrent state after the prompt pass (the chunked delta rule)
# against ``gated_delta_step`` token by token from zero, fed the prompt
# pass's own projections: both fp32, so they differ by the order of fp32
# sums alone (measured on an H100: 8e-5 of a head's state at worst);
# relative Frobenius error per head.  Fed the steps' own projections (the
# GEMV at M = 8 where the prompt ran the GEMM at M = 4096, bf16 outputs
# that differ in the last bit) the whole state moves by 1.3e-4 relative
# (measured), held to Q3N_STATE_OWN_TOL.
Q3N_STATE_TOL = 1e-3
Q3N_STATE_OWN_TOL = 0.01


def _qwen3next(n_layers, model_type="qwen3_next", first=0):
    """The published Qwen3-Next config (``QWEN3_NEXT_HF``) through the
    port's HF config reader, cut to ``n_layers`` from layer ``first`` on
    (``layer_types`` cut with it), and the HF dict of that cut."""
    from autoround_tpu_torch.utils.hf_loader import config_from_hf

    hf = dict(QWEN3_NEXT_HF, model_type=model_type,
              num_hidden_layers=n_layers,
              layer_types=QWEN3_NEXT_HF["layer_types"][first:first
                                                        + n_layers])
    return config_from_hf(hf), hf


def _q3n_structure(eng, label):
    """The hybrid engine's packing: each MoE block's w1 / w2 / w3 stacked
    for row 5 (no expert packed alone for row 4, none dense), each full
    layer's q(+gate) / k / v fused into one row-4 entry split 2·nh·hd /
    nkv·hd / nkv·hd, the DeltaNet projections and the shared experts
    packed but ``in_proj_ba`` (dense, as the router), the lm_head
    packed."""
    from autoround_tpu_torch.models import qwen3next

    cfg = eng.cfg
    q = (2 * cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd,
         cfg.num_kv_heads * cfg.hd)
    for i, b in enumerate(eng.params["blocks"]):
        stacked = sorted(k for k in eng.packed
                         if k.startswith(f"blocks.{i}.experts_stack."))
        check(stacked == [f"blocks.{i}.experts_stack.{w}"
                          for w in ("w1", "w2", "w3")]
              and all(v is None for ew in b["experts"] for v in ew.values()),
              f"{label}: block {i} experts {stacked}")
        if qwen3next.is_linear_layer(cfg, i):
            names = ("in_proj_qkvz", "out_proj")
            check(b["in_proj_ba"] is not None, f"{label}: block {i} "
                  f"in_proj_ba is not dense")
        else:
            names = ("qkv", "o_proj")
            check(eng.fused_splits.get(f"blocks.{i}.qkv") == q,
                  f"{label}: block {i} q(+gate) / k / v not fused as {q}")
        names += tuple(f"shared_expert.{w}" for w in ("w1", "w2", "w3"))
        check(all(f"blocks.{i}.{n}" in eng.packed for n in names),
              f"{label}: block {i} lacks a packed entry of {names}")
    check(not any(".experts." in k for k in eng.packed)
          and "lm_head" in eng.packed,
          f"{label}: an expert packed alone, or the lm_head dense")


def _q3n_state_check(eng, prompts, label):
    """Layer 0's conv tail and recurrent state after the prompt pass
    against ``gated_delta_step`` token by token from zero on the same
    engine, once fed the prompt pass's own projections (the tail must be
    bit-equal, each head's state within Q3N_STATE_TOL) and once computing
    its own (Q3N_STATE_OWN_TOL on the whole state); the counts kept."""
    from autoround_tpu_torch.models import llama, qwen3next
    from autoround_tpu_torch.serve.engine import _make_linear_fn

    cfg = eng.cfg
    S = prompts.shape[1]
    with counts_kept(), torch.no_grad():
        _, cache = eng.prefill(prompts)
        blk = eng.params["blocks"][0]
        x = llama.embed_fwd(eng.params, prompts.cuda(), cfg)
        h = llama.rms_norm(x, blk["input_layernorm"], cfg.rms_eps,
                           cfg.norm_offset)
        lf = _make_linear_fn(eng.packed, eng.packed_kinds, 0)
        pre = {n: lf(n, h, blk[n]) for n in ("in_proj_qkvz", "in_proj_ba")}
        got = {}
        t0 = time.time()
        for mode in ("replayed", "own"):
            tail = torch.zeros_like(cache.conv[0])
            state = torch.zeros_like(cache.state[0])
            for s in range(S):
                def lf_s(name, xs, w, b=None, _s=s):
                    if mode == "replayed" and name in pre:
                        return pre[name][:, _s:_s + 1]
                    return lf(name, xs, w, b)
                _, tail, state = qwen3next.gated_delta_step(
                    blk, h[:, s:s + 1], cfg, lf_s, tail, state)
            got[mode] = (tail, state)
        torch.cuda.synchronize()
        t_steps = time.time() - t0
    ref = cache.state[0]

    def rel(st):
        d = (st - ref).flatten(2).norm(dim=-1)
        return (d / ref.flatten(2).norm(dim=-1)).max().item(), \
            ((st - ref).norm() / ref.norm()).item()
    (rt, rs), (ot, os_) = got["replayed"], got["own"]
    r_head, r_all = rel(rs)
    o_head, o_all = rel(os_)
    log(f"{label}: layer 0 after the {S}-token prompt pass against {S} "
        f"recurrent steps from zero: fed the prompt pass's projections, "
        f"tail bit-equal {torch.equal(rt, cache.conv[0])}, state relative "
        f"error worst head {r_head:.4g} whole {r_all:.4g} (tol "
        f"{Q3N_STATE_TOL} a head); computing their own, tail row_err "
        f"{row_err(ot, cache.conv[0])[1]:.4g}, state worst head "
        f"{o_head:.4g} whole {o_all:.4g} (tol {Q3N_STATE_OWN_TOL} whole); "
        f"state rms {ref.pow(2).mean().sqrt().item():.4g}; steps_s="
        f"{t_steps:.2f}")
    check(torch.equal(rt, cache.conv[0]) and r_head <= Q3N_STATE_TOL
          and o_all <= Q3N_STATE_OWN_TOL,
          f"{label}: the prompt pass's state disagrees with the steps'")


def _q3n_params(params, first, n):
    """A parameter tree of ``n`` blocks from block ``first`` on (the
    embedding, the final norm and the head shared)."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = params["blocks"][first:first + n]
    return out


def _q3n_model_check(eng, params, prompts, label):
    """The engine against the port's ``model_fwd`` on the same qdq weights
    (dense products; the flash kernel where its gate takes the prompt):
    (1) each block on the model's own input (teacher forced: the engine's
    block, packed and fused, against ``block_fwd``), within
    MOE_COPY_ROW_TOL; (2) the prefill logits of all layers, within
    MOE_COPY_ROW_TOL; (3) a 2-layer copy (blocks 2-3, a DeltaNet and a
    full layer): its prefill and 3 decode steps against ``model_fwd`` of
    the extended sequence (the JAX test's form), within MOE_COPY_ROW_TOL;
    (4) the same 3 decode steps of all layers, held to the larger of that
    limit and what a one-ulp change of the model's input does: random
    weights make the stack amplify last-bit differences layer by layer
    (a bf16 ulp on 16% of the embedding entries moved model_fwd's
    logits by a row error of 1.318 on an H100), so the engine's distance
    from the model at depth is printed beside that floor.  The counts are
    kept."""
    from autoround_tpu_torch.models import llama, qwen3next
    from autoround_tpu_torch.serve.engine import _fuser, _make_linear_fn

    cfg = eng.cfg
    seq = prompts.cuda()
    t0 = time.time()
    blk_errs = []
    with counts_kept(), torch.no_grad():
        x = llama.embed_fwd(params, seq, cfg)
        cos, sin = llama.rope_tables(cfg, seq.shape[1], device=x.device)
        for i in range(cfg.num_layers):
            ye, _ = qwen3next.block_with_cache(
                eng.params["blocks"][i], x, cos, sin, cfg, None, None,
                _make_linear_fn(eng.packed, eng.packed_kinds, i),
                _fuser(eng.packed, eng.packed_kinds, eng.fused_splits, i))
            x = qwen3next.block_fwd_for(cfg, i)(params["blocks"][i], x, cos,
                                                sin, cfg)
            blk_errs.append(row_err(ye, x)[1])

        def steps(e, p, c):
            """(prefill row error, decode steps' row errors) of engine e
            against model_fwd(p, ., c)."""
            sq = seq
            logits, cache = e.prefill(prompts)
            errs = [row_err(logits, qwen3next.model_fwd(p, sq, c)[:, -1])]
            for _ in range(3):
                tok = logits.argmax(-1).to(torch.int32)
                logits, cache = e.decode_step(tok, cache)
                sq = torch.cat([sq, tok[:, None].long()], dim=1)
                errs.append(row_err(logits, qwen3next.model_fwd(
                    p, sq, c)[:, -1]))
            return [r for _, r in errs]
        deep = steps(eng, params, cfg)
        ce = copy_engine(eng, 2, "cuda", first=2)
        two = steps(ce, _q3n_params(params, 2, 2), ce.cfg)
        del ce
        # the noise floor: model_fwd with a one-ulp change of the input
        gen = torch.Generator(device="cuda").manual_seed(117)
        emb = params["embed_tokens"]
        noisy = dict(params, embed_tokens=(emb.float() * (1 + 2.0 ** -9 * (
            torch.randn(emb.shape, generator=gen, device=emb.device)))
        ).to(emb.dtype))
        floor = row_err(qwen3next.model_fwd(noisy, seq, cfg)[:, -1],
                        qwen3next.model_fwd(params, seq, cfg)[:, -1])[1]
        changed = (noisy["embed_tokens"] != emb).float().mean().item()
        del noisy
        torch.cuda.synchronize()
    fmt = lambda v: " / ".join(f"{r:.4g}" for r in v)
    log(f"{label}: engine against model_fwd on the qdq weights: each block "
        f"teacher forced row_err {fmt(blk_errs)}; blocks 2-3 copy prefill "
        f"and 3 decode steps {fmt(two)}; all {cfg.num_layers} layers "
        f"prefill and 3 decode steps {fmt(deep)} (tol {MOE_COPY_ROW_TOL}; "
        f"the decode steps of all layers beside the noise floor {floor:.4g}"
        f": one bf16 ulp on {changed:.3g} of the embedding entries); "
        f"check_s={time.time() - t0:.1f}")
    check(all(r <= MOE_COPY_ROW_TOL for r in blk_errs + two + deep[:1]),
          f"{label}: the engine's logits disagree with model_fwd's")
    check(all(r <= max(MOE_COPY_ROW_TOL, floor) for r in deep[1:]),
          f"{label}: the engine's decode steps leave model_fwd by more than "
          f"a one-ulp change of the input does")


def qwen3next_path(bw, flops_peak, n_layers):
    """(a) Qwen3-Next-80B-A3B at full width, ``n_layers`` of 48 (layers 3,
    7, ... full attention, the rest DeltaNet): RTN W4A16 g128 with the
    lm_head (blocks donated) → engine (the hybrid cache: K / V of the full
    layers, conv tails and fp32 states of the DeltaNet layers; experts
    stacked for row 5, q(+gate) / k / v fused for row 4) → ``generate``
    for 8 x 512 prompts, 32 new tokens, launches as the loops imply
    (row 1 at prefill on the full layers); timings beside bounds; the
    engine against ``model_fwd`` on the qdq weights (prefill and 3 decode
    steps); layer 0's state against token-by-token steps; a 2-layer copy
    (blocks 2-3: a DeltaNet and a full layer) on the plain versions on
    the card; ``generate_scan``; the replayed step at batch 8 and 1, each
    with a second call of new prompts.  Returns (launches, summary)."""
    from autoround_tpu_torch import QuantizedLlama

    t_path = time.time()
    cfg, _ = _qwen3next(n_layers)
    label = f"qwen3-next x {n_layers}"
    kernels = _kernel_fns()
    gen = torch.Generator().manual_seed(111)
    B, S = Q3N_BATCH, Q3N_SEQ
    calib = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = _moe_quantize(cfg, calib, 112, label, scheme="W4A16", iters=0,
                           quant_lm_head=True)
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=1024)
    torch.cuda.synchronize()
    t_pack, pack_gb = time.time() - t0, torch.cuda.max_memory_allocated() / 1e9
    _q3n_structure(eng, label)
    log(f"{label} engine: {len(result.layers)} quantized layers, pack_s="
        f"{t_pack:.2f} {len(eng.packed)} packed entries "
        f"({sum(v == 'w4a16_grouped' for v in eng.packed_kinds.values())} "
        f"expert stacks of {cfg.num_experts}); resident_gb="
        f"{torch.cuda.memory_allocated() / 1e9:.2f} quantize_peak_gb="
        f"{quant_gb:.2f} pack_peak_gb={pack_gb:.2f} weight_gb="
        f"{_weight_bytes(eng) / 1e9:.3f}")
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, Q3N_NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    gen_gb = torch.cuda.max_memory_allocated() / 1e9
    n_full = sum(t == "full_attention" for t in cfg.layer_types)
    want = dict(_ds_want(eng, Q3N_NEW),
                flash_attention=n_full if S >= 512 and S % 256 == 0 else 0)
    log(f"{label} kernels {json.dumps(launches)} generate_s={t_gen:.2f} "
        f"generate device peak_gb={gen_gb:.2f}")
    _ds_counts(launches, want, label)
    check(all(launches[n] > 0 for n in ("w4a16_matmul",
                                        "w4a16_matmul_grouped",
                                        "flash_attention")),
          f"{label}: rows 1, 4 and 5 must all launch")
    _check_tokens(toks, B, Q3N_NEW, cfg.vocab_size)
    prefill_ms, step_ms = time_serving(eng, prompts, Q3N_NEW, bw, flops_peak)
    _q3n_model_check(eng, result.params, prompts, label)
    del result
    free_device_memory()
    _q3n_state_check(eng, prompts, label)
    check_copy(eng, prompts, "card", MOE_COPY_ROW_TOL, first=2)
    scan_path(eng, prompts, toks, gen_counts, label, step_ms)
    summary = dict(prefill_ms=prefill_ms)
    summary["B8"] = scan_measure(eng, 8, S, bw, flops_peak, None,
                                 seed=113, label=label,
                                 ran=(prompts, step_ms), second=True)
    summary["B1"] = scan_measure(eng, 1, S, bw, flops_peak, None, seed=114,
                                 label=label, second=True)
    log(f"{label} path: prefill_ms={prefill_ms:.2f} graph step "
        + "; ".join(f"{b}: {m['step_ms']:.4f} ms (bound {m['bound_ms']:.4f}"
                    f", busy {m['busy']:.3f})"
                    for b, m in summary.items() if b != "prefill_ms")
        + f"; peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"path_s={time.time() - t_path:.1f}")
    del eng
    return launches, summary


def qwen3next_tune_path():
    """(b) SignRound W4A16 (``iters`` 2, 2 x 512 ids, 2 sequences a step)
    on Qwen3-Next's published layers 2-3 (a DeltaNet layer, whose tuning
    loss runs the chunked delta rule's backward, and the first
    full-attention layer, rows 1-3 in its loss; 512 experts
    dense-then-mask; blocks 0-3 until the glm phase came, ~90 s), then
    served: ``generate_scan`` equal to ``generate``.  Returns the tuning's
    launches."""
    cfg, _ = _qwen3next(2, first=2)
    launches = _moe_tune_path(cfg, "qwen3-next tune x 2", 115, "W4A16", 2,
                              2, iters=2, nsamples=2)
    check(all(launches[n] > 0 for n in ("flash_attention",
                                        "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")),
          f"qwen3-next tune: rows 1-3 must launch ({launches})")
    return launches


def qwen3next_phase(bw, flops_peak, n_layers, load_layers):
    """Qwen3-Next and Qwen3.5-MoE: paths (a) ``qwen3next_path``, (b)
    ``qwen3next_tune_path`` and (c) a ``qwen3_5_moe`` HF directory at the
    same widths x ``load_layers`` (the published layers up to the first
    full one; fused expert stacks, an ``mtp.*`` tensor) → the CLI →
    ``from_pretrained``; returns their launches."""
    t0 = time.time()
    out = {}
    out["qwen3_next"], summ = qwen3next_path(bw, flops_peak, n_layers)
    free_device_memory()
    out["qwen3_next_tune"] = qwen3next_tune_path()
    free_device_memory()
    root = Path(tempfile.mkdtemp(prefix="qwen35_load_"))
    try:
        # the published layers ending at the first full one (2-3 at the
        # default depth: a DeltaNet and a full layer)
        cfg, hf = _qwen3next(load_layers, "qwen3_5_moe",
                             first=max(0, 4 - load_layers))
        oss_llama4_load_path(root, cfg, "qwen3.5", 116, 128, hf_config=hf)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    log(f"qwen3-next phase: prefill_ms={summ['prefill_ms']:.2f} B=8 "
        f"{summ['B8']['step_ms']:.4f} ms (bound {summ['B8']['bound_ms']:.4f}"
        f") B=1 {summ['B1']['step_ms']:.4f} ms (bound "
        f"{summ['B1']['bound_ms']:.4f}); qwen3next_s={time.time() - t0:.1f}")
    return out


# ------------------------------------------------------------- the GLM family
#
# The GLM family at published widths (random weights from a seed, moved
# off their initial values by ``perturb_moe``): glm-4.5-air (96
# query heads over 8 KV heads, so the int8 cache decodes through row 6 at
# G = 12; partial rotary 0.5, per-head q / k norm, q / k / v biases; a dense
# layer 0 of 10944, then 128 experts of 1408 and a shared one under the
# DeepSeek router) at W4A16 g128, SignRound on its first two blocks, an HF
# ``glm4_moe`` directory through the CLI; and GLM-5 DSA at the deepseek-v3
# preset's widths with DeepSeek-V3.2's published indexer (the HF loader's
# defaults: 64 heads of 128, top 2048, every layer its own), served by the
# MLA engine with dense attention as the JAX engine serves it, its mask held
# at 4096 tokens where it bites, and an HF ``glm_moe_dsa`` directory through
# the CLI.

GLM_NEW = 32
GLM5_INDEXER = dict(index_n_heads=64, index_head_dim=128, index_topk=2048)
# the mask check's one block runs 1 x DSA_SEQ tokens: past token 2048 a
# query keeps fewer keys than the causal ones
DSA_SEQ = 4096
# a block on the DSA mask against the same block on the reference mask (the
# index top-k's keys and the diagonal), on the queries whose masks agree
# (all but those with a tie at the k-th score): the same keys, so the same
# sums (0 expected)
DSA_BLOCK_TOL = 1e-6


def _glm45(n_layers):
    from autoround_tpu_torch.models import glm4moe

    return dataclasses.replace(glm4moe.CONFIG_PRESETS["glm-4.5-air"],
                               num_layers=n_layers)


def _glm5(n_layers):
    """GLM-5 DSA at the port's deepseek-v3 preset widths with the HF
    loader's indexer defaults, ``n_layers`` deep (every layer its own
    indexer)."""
    from autoround_tpu_torch.models import deepseek, glmdsa

    v3 = deepseek.CONFIG_PRESETS["deepseek-v3"]
    kw = {f.name: getattr(v3, f.name) for f in dataclasses.fields(v3)}
    kw.update(GLM5_INDEXER, num_layers=n_layers)
    return glmdsa.GlmMoeDsaConfig(**kw)


def _glm45_model_check(eng, params, prompts, label):
    """The GLM-4.5 engine's layout (q / k / v fused as nh·hd / nkv·hd /
    nkv·hd with the biases left dense, the dense block's gate / up fused,
    each MoE block's experts stacked) and the engine against the port's
    ``model_fwd`` on the qdq weights (dense products; the flash kernel where
    its gate takes the prompt): each block on the model's own input
    (teacher forced: the engine's ``_block_with_cache``, packed and fused,
    against ``glm4moe.block_fwd``) and the prefill logits of all layers,
    within MOE_COPY_ROW_TOL (the router's near-ties).  The counts are
    kept."""
    from autoround_tpu_torch.models import glm4moe, llama
    from autoround_tpu_torch.serve.engine import (_block_with_cache,
                                                  _make_linear_fn)

    cfg = eng.cfg
    qkv = (cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd,
           cfg.num_kv_heads * cfg.hd)
    for i, b in enumerate(eng.params["blocks"]):
        check(eng.fused_splits.get(f"blocks.{i}.qkv") == qkv
              and b["q_bias"] is not None and b["k_norm"] is not None,
              f"{label}: block {i} q / k / v not fused as {qkv}")
    check(eng.fused_splits.get("blocks.0.gate_up") == (
        cfg.intermediate_size,) * 2, f"{label}: block 0 gate / up not fused")
    seq = prompts.to("cuda")
    t0 = time.time()
    errs = []
    with counts_kept(), torch.no_grad():
        x = llama.embed_fwd(params, seq, cfg)
        cos, sin = llama.rope_tables(cfg, seq.shape[1], device=x.device)
        for i in range(cfg.num_layers):
            ye, _, _ = _block_with_cache(
                eng.params["blocks"][i], x, cos, sin, cfg, None, None,
                _make_linear_fn(eng.packed, eng.packed_kinds, i), eng.packed,
                eng.packed_kinds, i, eng.fused_splits)
            x = glm4moe.block_fwd(params["blocks"][i], x, cos, sin, cfg)
            errs.append(row_err(ye, x)[1])
            del ye
        del x
        logits, _ = eng.prefill(prompts)
        deep = row_err(logits, glm4moe.model_fwd(params, seq, cfg)[:, -1])[1]
        torch.cuda.synchronize()
    log(f"{label}: engine against model_fwd on the qdq weights: each block "
        f"teacher forced row_err "
        f"{' / '.join(f'{r:.4g}' for r in errs)}; all {cfg.num_layers} "
        f"layers prefill logits row_err={deep:.4g} (tol {MOE_COPY_ROW_TOL});"
        f" check_s={time.time() - t0:.1f}")
    check(all(r <= MOE_COPY_ROW_TOL for r in errs + [deep]),
          f"{label}: the engine disagrees with model_fwd")


def glm45_path(bw, flops_peak, n_layers):
    """(a) glm-4.5-air at full width, ``n_layers`` of 46 (layer 0 dense,
    the rest MoE): RTN W4A16 g128 with the lm_head (gains, q / k / v
    biases and the router's bias moved), the int8-KV engine (row 6 at
    G = 12; block 0's down_proj, K = 10944 = 85.5 x 128, serves dense),
    8 x 512 prompts, 32 new tokens, launches equal to the loops' (row 1 at
    prefill, row 6 every decode step of every layer); timings; each block
    teacher forced against ``model_fwd`` on the qdq weights; a 2-layer copy
    (dense + MoE) on the plain versions; ``generate_scan``; the replayed
    step at batch 8 and 1; the fp8 cache; the batcher."""
    cfg = _glm45(n_layers)
    return _moe_serve_path(bw, flops_peak, cfg, f"glm-4.5-air x {n_layers}",
                           121, "W4A16", 8, 512, GLM_NEW, 1024,
                           model_check=_glm45_model_check)


def glm45_tune_path():
    """(b) SignRound W4A16 (iters 2, 2 x 512 ids, 2 sequences a step) on
    glm-4.5-air's blocks 0-1 (the dense block and a 128-expert block: rows
    1-3 at G = 12 in the tuning loss), then served."""
    launches = _moe_tune_path(_glm45(2), "glm-4.5-air tune x 2", 124,
                              "W4A16", 2, 2, iters=2, nsamples=2)
    check(all(launches[n] > 0 for n in ("flash_attention",
                                        "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")),
          f"glm-4.5-air tune: rows 1-3 must launch ({launches})")
    return launches


def _glm45_write_hf(params, cfg, path, hf_config=None):
    from autoround_tpu_torch.utils.hf_loader import save_hf_checkpoint

    save_hf_checkpoint(params, cfg, str(path))
    check(json.loads((path / "config.json").read_text())["model_type"]
          == "glm4_moe", "glm-4.5 load: the writer's model_type")


def write_hf_dsa(params, cfg, path, hf_config=None):
    """An HF ``glm_moe_dsa`` directory (neither package has a writer for
    GLM-5): the DeepSeek keys, ``self_attn.indexer.{q_proj,k_proj,
    weights_proj}`` for the layers that own an indexer, the indexer fields
    in ``config.json``."""
    from autoround_tpu_torch.utils.hf_loader import _DS_MAP
    from autoround_tpu_torch.utils.safetensors_io import save_file

    inv = {v: k for k, v in _DS_MAP.items()}
    t = {"model.embed_tokens.weight": params["embed_tokens"],
         "model.norm.weight": params["norm"],
         "lm_head.weight": params["lm_head"]}
    for li, b in enumerate(params["blocks"]):
        pre = f"model.layers.{li}."
        for ours, arr in b.items():
            if ours == "indexer":
                if cfg.layer_has_indexer(li):
                    for n, w in arr.items():
                        t[f"{pre}self_attn.indexer.{n}.weight"] = w
            elif ours == "experts":
                for e, ew in enumerate(arr):
                    for n, w in ew.items():
                        t[f"{pre}mlp.experts.{e}.{n}.weight"] = w
            elif ours == "shared_experts":
                for n, w in arr.items():
                    t[f"{pre}mlp.shared_experts.{n}.weight"] = w
            else:
                t[pre + inv[ours]] = arr
    path.mkdir(parents=True, exist_ok=True)
    save_file(t, str(path / "model.safetensors"))
    hf = {"model_type": "glm_moe_dsa", "vocab_size": cfg.vocab_size,
          "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
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
          "index_n_heads": cfg.index_n_heads,
          "index_head_dim": cfg.index_head_dim,
          "index_topk": cfg.index_topk,
          "index_layers": list(cfg.index_layers) or None}
    (path / "config.json").write_text(json.dumps(hf, indent=2))


def _dsa_mask_check(params, cfg, label):
    """One block (block 0) at 1 x DSA_SEQ tokens, where the mask bites: its
    DSA mask against a reference built another way (the index top-k of the
    causal scores, ``torch.topk``'s indices scattered, and the diagonal),
    equal but at ties with the k-th score (the threshold keeps every tied
    key); every query up to index_topk keeps all its causal keys and every
    later one fewer (index_topk, or index_topk + 1 with the diagonal);
    ``block_fwd`` on its own mask against the same block on the reference
    mask (DSA_BLOCK_TOL) and against the dense DeepSeek block (printed:
    the rows past index_topk move).  Returns the kept-key counts."""
    from autoround_tpu_torch.models import deepseek, glmdsa, llama

    t0 = time.time()
    S, k = DSA_SEQ, cfg.index_topk
    blk = params["blocks"][0]
    gen = torch.Generator(device="cuda").manual_seed(127)
    ids = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                        device="cuda")
    with counts_kept(), torch.no_grad():
        x = llama.embed_fwd(params, ids, cfg)
        cos, sin = deepseek.rope_tables(cfg, S, device="cuda")
        h = llama.rms_norm(x, blk["input_layernorm"], cfg.rms_eps)
        sc = glmdsa.indexer_scores(blk, h, cos, sin, cfg,
                                   llama._plain_linear)[0]
        keep = glmdsa.dsa_mask(sc[None], k)[0, 0] == 0.0
        rows = torch.arange(S, device="cuda")
        causal = rows[None, :] <= rows[:, None]
        s = torch.where(causal, sc, torch.full_like(sc, float("-inf")))
        top = torch.topk(s, k, dim=-1)
        ref = torch.zeros_like(keep).scatter_(1, top.indices, True) & causal
        ref |= torch.eye(S, dtype=torch.bool, device="cuda")
        diff = keep != ref
        kth = top.values[:, -1:].expand(S, S)
        n_diff = int(diff.sum())
        ties_only = bool((s[diff] == kth[diff]).all()) if n_diff else True
        kept = keep.sum(-1)
        n_causal = rows + 1
        early_all = bool((kept[:k] == n_causal[:k]).all())
        late = kept[k:]
        # at least the k keys; more than k + 1 (the diagonal) only through
        # a tie, which ``ties_only`` holds
        late_ok = bool((late >= k).all() and (late < n_causal[k:]).all())
        n_wide = int((late > k + 1).sum())
        same = ~diff.any(-1)                   # queries whose masks agree
        del s, top, kth, sc, h
        y = glmdsa.block_fwd(blk, x, cos, sin, cfg)
        yr = glmdsa.block_fwd(blk, x, cos, sin, cfg, idx_mask=torch.where(
            ref, 0.0, -1e30)[None, None])
        r_ref = row_err(y[:, same], yr[:, same])[1]
        del yr
        yd = deepseek.block_fwd(blk, x, cos, sin, cfg)
        r_dense_early = row_err(y[:, :k], yd[:, :k])[1]
        r_dense_late = row_err(y[:, k:], yd[:, k:])[1]
        del y, yd, x
        torch.cuda.synchronize()
    log(f"{label} DSA mask (block 0, 1 x {S} tokens, top {k}): keys kept "
        f"per query: all causal up to query {k - 1} ({early_all}), then "
        f"{int(late.min())}..{int(late.max())} of {k + 1}..{S} causal "
        f"({late_ok}; {n_wide} queries keep more than {k + 1}: a tie at "
        f"the k-th score); mask against the index top-k reference: {n_diff} "
        f"keys differ (ties with the k-th score only: {ties_only}); "
        f"block_fwd on its mask against the reference mask, the "
        f"{int(same.sum())} queries whose masks agree, row_err="
        f"{r_ref:.4g} (tol {DSA_BLOCK_TOL}); against the dense DeepSeek "
        f"block: queries < {k} row_err={r_dense_early:.4g}, later "
        f"{r_dense_late:.4g}; mask_check_s={time.time() - t0:.1f}")
    check(early_all and late_ok and ties_only,
          f"{label}: the DSA mask keeps the wrong keys")
    check(r_ref <= DSA_BLOCK_TOL,
          f"{label}: block_fwd disagrees with the reference mask's block")
    check(r_dense_late > 0.0, f"{label}: the sparse path did not change "
          f"the attention past token {k}")
    return kept


def glm5_path(bw, flops_peak, n_layers):
    """(d) GLM-5 DSA at the deepseek-v3 widths with DeepSeek-V3.2's indexer,
    ``n_layers`` of 61 (3 dense blocks, then 256 experts): RTN W4A16 g128
    with the lm_head, the indexer's q / k quantized and ``weights_proj``
    left bf16; the DSA mask at 4096 tokens (``_dsa_mask_check``); the MLA
    engine (int8 latents) with its dense-MLA warning; ``generate`` for
    2 x 128 prompts, 16 new tokens, launches equal to the loops' (the
    indexer's packed q / k never launch); its logits and tokens equal to a
    DeepSeek engine on the same packed weights (the dense path it takes);
    a 2-layer copy (the last dense block and the first MoE block) on the
    plain versions; ``generate_scan``; the replayed step at batch 8.
    Returns the launches."""
    from autoround_tpu_torch import QuantizedLlama
    from autoround_tpu_torch.models import deepseek
    from autoround_tpu_torch.utils.logger import logger as ar_logger

    t_path = time.time()
    kernels = _kernel_fns()
    cfg = _glm5(n_layers)
    label = f"glm5-dsa x {n_layers}"
    B, S, NEW = 2, 128, 16
    gen = torch.Generator().manual_seed(125)
    calib = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = _moe_quantize(cfg, calib, 126, label, scheme="W4A16", iters=0,
                           quant_lm_head=True)
    idx = [n for n in result.layers if ".indexer." in n]
    check(sorted(idx) == sorted(f"blocks.{i}.indexer.{w}"
                                for i in range(n_layers)
                                for w in ("k_proj", "q_proj"))
          and all(b["indexer"]["weights_proj"].dtype == cfg.dtype
                  for b in result.params["blocks"]),
          f"{label}: indexer layers quantized {idx}")
    kept = _dsa_mask_check(result.params, cfg, label)
    h = _LogLines()
    ar_logger.addHandler(h)
    try:
        eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=512,
                                                  kv_quant="int8")
    finally:
        ar_logger.removeHandler(h)
    warned = [m for m in h.lines if "DENSE MLA" in m]
    check(len(warned) == 1, f"{label}: the dense-MLA warning {h.lines}")
    kvb, other = _ds_dense(eng, result)
    del result
    free_device_memory()
    n_moe = sum(cfg.layer_is_moe(i) for i in range(n_layers))
    check(not other and len(kvb) == n_layers
          and sum(v == "w4a16_grouped" for v in eng.packed_kinds.values())
          == 3 * n_moe, f"{label}: dense {other}")
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    n_idx = sum(".indexer." in k for k in eng.packed)
    want = _ds_want(eng, NEW)
    want["w4a16_matmul"] -= n_idx * NEW
    log(f"{label} ({n_moe} MoE) kernels {json.dumps(launches)} "
        f"generate_s={t_gen:.2f} ({n_idx} indexer entries packed, never "
        f"launched) resident_gb={torch.cuda.memory_allocated() / 1e9:.2f} "
        f"weight_gb={_weight_bytes(eng) / 1e9:.3f}; warning: {warned[0]}")
    _ds_counts(launches, want, label)
    _check_tokens(toks, B, NEW, cfg.vocab_size)
    # the same packed weights served as DeepSeek: the dense path, exactly
    ds_cfg = deepseek.DeepseekConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(deepseek.DeepseekConfig)})
    ds = dataclasses.replace(eng, cfg=ds_cfg)
    with counts_kept():
        same = [torch.equal(a, b) for a, b in zip(
            _step_logits(eng, prompts), _step_logits(ds, prompts))]
        ds_toks = ds.generate(prompts, max_new_tokens=NEW)
    check(all(same) and torch.equal(ds_toks, toks),
          f"{label}: not the DeepSeek engine's logits / tokens ({same})")
    del ds
    check_copy(eng, prompts, "card", DS_COPY_ROW_TOL,
               first=cfg.first_k_dense - 1)
    _, step_ms = time_serving(eng, prompts, NEW, bw, flops_peak)
    c0 = launch_counts()
    scan_path(eng, prompts, toks, gen_counts, label, step_ms)
    c1 = launch_counts()
    s8 = scan_measure(eng, 8, S, bw, flops_peak, None, seed=128,
                      label=label)
    log(f"{label} path: logits and tokens equal to the DeepSeek engine's "
        f"on the same weights; graph step B=8 {s8['step_ms']:.4f} ms (bound "
        f"{s8['bound_ms']:.4f}, busy {s8['busy']:.3f}); peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} path_s="
        f"{time.time() - t_path:.1f}")
    del eng
    return launches, {n: c1[n] - c0[n] for n in launches}, kept


def glm_phase(bw, flops_peak, glm45_layers, glm5_layers):
    """GLM-4.5 and GLM-5: paths (a) ``glm45_path``, (b) ``glm45_tune_path``,
    (c) an HF ``glm4_moe`` directory of 2 layers (dense + MoE) → the CLI →
    ``from_pretrained``, (d) ``glm5_path`` and (e) an HF ``glm_moe_dsa``
    directory of 2 layers (the first two deepseek-v3 blocks, dense, each
    with its indexer) → the CLI → ``from_pretrained``; returns their
    launches."""
    t0 = time.time()
    out = {}
    t1 = time.time()
    out["glm4.5-air"], summ = glm45_path(bw, flops_peak, glm45_layers)
    out["glm4.5-air_scan"] = summ["scan_launches"]
    free_device_memory()
    out["glm4.5-air_tune"] = glm45_tune_path()
    free_device_memory()
    root = Path(tempfile.mkdtemp(prefix="glm_load_"))
    try:
        oss_llama4_load_path(root, _glm45(2), "glm-4.5-air", 129, 128,
                             write=_glm45_write_hf)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    t_glm45 = time.time() - t1
    t1 = time.time()
    out["glm5-dsa"], out["glm5-dsa_scan"], _ = glm5_path(bw, flops_peak,
                                                         glm5_layers)
    free_device_memory()
    root = Path(tempfile.mkdtemp(prefix="glm5_load_"))
    try:
        oss_llama4_load_path(root, _glm5(2), "glm5-dsa", 130, 128,
                             write=write_hf_dsa)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    log(f"glm phase: glm-4.5-air prefill_ms={summ['prefill_ms']:.2f} B=8 "
        f"{summ['B8']['step_ms']:.4f} ms (bound {summ['B8']['bound_ms']:.4f}"
        f") B=1 {summ['B1']['step_ms']:.4f} ms (bound "
        f"{summ['B1']['bound_ms']:.4f}); glm45_s={t_glm45:.1f} glm5_s="
        f"{time.time() - t1:.1f} glm_s={time.time() - t0:.1f}")
    return out


# ------------------------------------------------------------ MiniMax
#
# MiniMax-Text-01 at its published widths (random weights from a seed):
# lightning attention with its per-head decay state on 7 layers of 8, the
# scaled residuals, 32 experts of 9216 under a top-2 router.  The whole
# model is 456B parameters, ~11.4 GB of bf16 a layer: it is quantized
# through host offload (``offload_params``, ``donate_params``), as a user
# with one card must.

# MiniMax-Text-01's config.json in the transformers ``minimax`` layout (the
# published widths; 80 layers, every 8th full attention; the residual
# alphas (2 · 80)^(1/4) of the DeepNorm rule, the betas 1).  No published
# config.json is in the repository: these are its fields, written here.
MINIMAX_HF = dict(
    model_type="minimax", vocab_size=200064, hidden_size=6144,
    intermediate_size=9216, num_hidden_layers=80, num_attention_heads=64,
    num_key_value_heads=8, head_dim=128, rope_theta=10000000.0,
    rms_norm_eps=1e-5, tie_word_embeddings=False, hidden_act="silu",
    num_local_experts=32, num_experts_per_tok=2, block_size=256,
    layer_types=["full_attention" if (i + 1) % 8 == 0 else "linear_attention"
                 for i in range(80)],
    full_attn_alpha_factor=3.5565588200778455, full_attn_beta_factor=1.0,
    linear_attn_alpha_factor=3.5565588200778455,
    linear_attn_beta_factor=1.0, mlp_alpha_factor=3.5565588200778455,
    mlp_beta_factor=1.0, torch_dtype="bfloat16")
MM_NEW = 32
MM_BATCH, MM_SEQ = 8, 512
# the published layers the serving path keeps: the 7 : 1 pattern's last
# four before its first full layer (lightning x 3, full)
MM_FIRST = 4
# experts of the tuning copy: V and its gradient are fp32, 2 x 4 B a
# weight, so a whole published block (5.69e9 weights, 45.5 GB of them)
# does not fit the card beside the bf16 block and the qdq graph; 8 of 32
# do (the widths kept)
MM_TUNE_EXPERTS = 8
# experts of the HF directory of the load path (its size on disk; widths
# kept)
MM_LOAD_EXPERTS = 4
# layer 0's lightning state after the prompt pass against ``lightning_step``
# token by token from zero on the same projections: both fp32, they differ
# by the order of fp32 sums alone; relative Frobenius error per (slot,
# head)
MM_STATE_TOL = 1e-3


def _minimax(n_layers, first=0, experts=None):
    """The published MiniMax config (``MINIMAX_HF``) through the port's HF
    config reader, cut to ``n_layers`` from layer ``first`` on
    (``layer_types`` cut with it; ``experts`` of 32 where given), and the
    HF dict of that cut."""
    from autoround_tpu_torch.utils.hf_loader import config_from_hf

    hf = dict(MINIMAX_HF, num_hidden_layers=n_layers,
              layer_types=MINIMAX_HF["layer_types"][first:first + n_layers])
    if experts is not None:
        hf["num_local_experts"] = experts
    return config_from_hf(hf), hf


def _mm_published_rates(n_layers, first):
    """The decay rates of the published layers ``first`` ..
    ``first + n_layers - 1`` of 80 (a depth cut changes them: they depend
    on ``num_hidden_layers``)."""
    from autoround_tpu_torch.models import minimax

    full, _ = _minimax(80)
    return [minimax.slope_rate(full, first + i) for i in range(n_layers)]


def _mm_structure(eng, label):
    """The MiniMax engine's packing: each block's w1 / w2 / w3 stacked for
    row 5 (no expert packed alone, none dense); a lightning layer's
    ``qkv_proj``, ``output_gate`` and ``out_proj`` packed for row 4; a full
    layer's q / k / v fused into one row-4 entry split nh·hd / nkv·hd /
    nkv·hd and its ``o_proj`` packed; the lm_head packed; no quantized
    layer left dense; ``slope_rate`` fp32."""
    from autoround_tpu_torch.models import minimax

    cfg = eng.cfg
    q = (cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd,
         cfg.num_kv_heads * cfg.hd)
    for i, b in enumerate(eng.params["blocks"]):
        stacked = sorted(k for k in eng.packed
                         if k.startswith(f"blocks.{i}.experts_stack."))
        check(stacked == [f"blocks.{i}.experts_stack.{w}"
                          for w in ("w1", "w2", "w3")]
              and all(v is None for ew in b["experts"] for v in ew.values()),
              f"{label}: block {i} experts {stacked}")
        if minimax.layer_is_linear(cfg, i):
            names = ("qkv_proj", "output_gate", "out_proj")
            check(b["slope_rate"].dtype == torch.float32,
                  f"{label}: block {i} slope_rate is not fp32")
        else:
            names = ("qkv", "o_proj")
            check(eng.fused_splits.get(f"blocks.{i}.qkv") == q,
                  f"{label}: block {i} q / k / v not fused as {q}")
        check(all(f"blocks.{i}.{n}" in eng.packed for n in names)
              and all(b.get(n) is None for n in (
                  "qkv_proj", "output_gate", "out_proj", "q_proj", "k_proj",
                  "v_proj", "o_proj")),
              f"{label}: block {i} lacks a packed entry of {names} or "
              f"serves a projection dense")
    check(not any(".experts." in k for k in eng.packed)
          and "lm_head" in eng.packed and eng.params.get("lm_head") is None
          and set(eng.packed_kinds.values()) == {"w4a16", "w4a16_grouped"},
          f"{label}: an expert packed alone, the lm_head dense, or kinds "
          f"{sorted(set(eng.packed_kinds.values()))}")


def _mm_block_check(eng, qdq, prompts, label):
    """Each block teacher forced on the model's own input: the engine's
    block (packed, fused, stacked) against ``block_fwd`` on the qdq
    weights, both from the same input, the qdq block brought up from the
    host alone; within MOE_COPY_ROW_TOL.  The prefill logits of the
    chain's end against the engine's are printed, not held: random weights
    under a top-2 router at a 3.56 alpha make the stack amplify last-bit
    differences.  The counts are kept."""
    from autoround_tpu_torch.models import llama, minimax
    from autoround_tpu_torch.serve.engine import _fuser, _make_linear_fn
    from autoround_tpu_torch.utils.pytree import tree_map

    cfg = eng.cfg
    seq = prompts.cuda()
    t0 = time.time()
    errs, seen = [], []
    with counts_kept(), torch.no_grad():
        x = llama.embed_fwd(eng.params, seq, cfg)
        cos, sin = llama.rope_tables(cfg, seq.shape[1], device=x.device)
        for i in range(cfg.num_layers):
            ye, _ = minimax.block_with_cache(
                eng.params["blocks"][i], x, cos, sin, cfg, None, None,
                _make_linear_fn(eng.packed, eng.packed_kinds, i),
                _fuser(eng.packed, eng.packed_kinds, eng.fused_splits, i))
            blk = tree_map(lambda t: t.cuda(), qdq["blocks"][i])
            x = minimax.block_fwd_for(cfg, i)(blk, x, cos, sin, cfg)
            del blk
            errs.append(row_err(ye, x)[1])
            seen.append(f"{(ye != x).float().mean().item():.3g} of "
                        f"entries differ, max {row_err(ye, x)[0]:.3g}, "
                        f"rms {x.float().pow(2).mean().sqrt().item():.4g}")
            del ye
        head = {"norm": qdq["norm"].cuda(), "lm_head": qdq["lm_head"].cuda()}
        want = llama.final_fwd(head, x[:, -1:], cfg)[:, 0]
        del head, x
        got, _ = eng.prefill(prompts)
        e2e = row_err(got, want)[1]
        torch.cuda.synchronize()
    log(f"{label}: engine against block_fwd on the qdq weights, each block "
        f"teacher forced row_err "
        f"{' / '.join(f'{r:.4g}' for r in errs)} (tol {MOE_COPY_ROW_TOL}; "
        f"{' / '.join(seen)}); "
        f"prefill logits of the chain against the engine's row_err "
        f"{e2e:.4g} (printed, not held); check_s={time.time() - t0:.1f}")
    check(all(r <= MOE_COPY_ROW_TOL for r in errs),
          f"{label}: a block of the engine disagrees with block_fwd")


def _mm_state_check(eng, prompts, label):
    """Layer 0's lightning state after the prompt pass: equal bit for bit
    to ``lightning_attention``'s ``return_state`` on the same engine's
    projections, and within MM_STATE_TOL (a head) of ``lightning_step``
    token by token from zero; the counts kept."""
    from autoround_tpu_torch.models import llama, minimax
    from autoround_tpu_torch.serve.engine import _make_linear_fn

    cfg = eng.cfg
    S = prompts.shape[1]
    with counts_kept(), torch.no_grad():
        _, cache = eng.prefill(prompts)
        blk = eng.params["blocks"][0]
        x = llama.embed_fwd(eng.params, prompts.cuda(), cfg)
        h = llama.rms_norm(x, blk["input_layernorm"], cfg.rms_eps)
        lf = _make_linear_fn(eng.packed, eng.packed_kinds, 0)
        q, k, v = minimax._lightning_qkv(blk, h, cfg, lf)
        rate = blk["slope_rate"]
        _, chunked = minimax.lightning_attention(q, k, v, rate,
                                                 cfg.block_size,
                                                 return_state=True)
        t0 = time.time()
        st = torch.zeros_like(chunked)
        for t in range(S):
            _, st = minimax.lightning_step(q[:, t:t + 1], k[:, t:t + 1],
                                           v[:, t:t + 1], rate, st)
        torch.cuda.synchronize()
        t_steps = time.time() - t0
    ref = cache.state[0]
    d = (st - ref).flatten(2).norm(dim=-1) / ref.flatten(2).norm(dim=-1)
    same = torch.equal(chunked, ref)
    log(f"{label}: layer 0's state after the {S}-token prompt pass equal to "
        f"lightning_attention's return_state bit for bit {same}; against "
        f"{S} lightning steps from zero worst (slot, head) relative error "
        f"{d.max().item():.4g} (tol {MM_STATE_TOL}), state rms "
        f"{ref.pow(2).mean().sqrt().item():.4g}, rates "
        f"{rate.min().item():.4g}..{rate.max().item():.4g}; steps_s="
        f"{t_steps:.2f}")
    check(same and d.max().item() <= MM_STATE_TOL,
          f"{label}: the prompt pass's lightning state disagrees")


def _mm_params(cfg, seed, rates):
    """Random MiniMax weights made on the card from ``seed``, each block
    parked on the host as it is made: the 1-D gains moved by N(0, 0.1),
    ``slope_rate`` set to the published layer's (``rates``); the final
    norm moved on the card.  Returns the tree."""
    from autoround_tpu_torch.models import minimax
    from autoround_tpu_torch.utils.offload import tree_to_host

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    li = iter(range(cfg.num_layers))

    def park(b):
        i = next(li)
        perturb_gains({"norm": torch.zeros(1, device="cuda"),
                       "blocks": [b]}, seed + 2 + i)
        if "slope_rate" in b:
            b["slope_rate"] = rates[i].cuda()
        return tree_to_host(b)

    params = minimax.init_params(cfg, gen, "cuda", park=park)
    params["norm"].add_(torch.randn(params["norm"].shape, generator=gen,
                                    device="cuda"), alpha=0.1)
    return params


def _rss_gb():
    """(resident GB of this process now (``VmRSS``), its lifetime peak
    (``ru_maxrss``))."""
    import resource

    rss = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024 / 1e9
    return rss, resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def minimax_path(bw, flops_peak, n_layers):
    """(a) MiniMax-Text-01 at full width, ``n_layers`` of 80 from the
    published layer 4 on (lightning, lightning, lightning, full at the
    default 4), each block's ``slope_rate`` the published layer's, the
    alphas 3.557: random weights made on the card and parked on the host →
    RTN W4A16 g128 with the lm_head through ``offload_params`` and
    ``donate_params`` (device peak, resident and peak RSS) → the engine
    (the hybrid cache: K / V of the full layer, fp32 (nh, hd, hd) states
    of the lightning layers; experts stacked for row 5, every projection
    on row 4, the full layer's q / k / v fused) → ``generate`` 8 x 512, 32
    new, launches as the loops imply (row 1 at prefill on the full layer);
    timings beside bounds; each block teacher forced against ``block_fwd``
    on the qdq weights; layer 0's state after the prompt; a 2-layer copy
    (blocks 2-3: lightning and full) on the plain versions on the card;
    ``generate_scan``; the replayed step at batch 8 and 1, each with a
    second call of new prompts.  Returns (launches, summary)."""
    from autoround_tpu_torch import AutoRound, QuantizedLlama

    t_path = time.time()
    cfg, _ = _minimax(n_layers, first=MM_FIRST)
    label = f"minimax-text-01 x {n_layers}"
    kernels = _kernel_fns()
    gen = torch.Generator().manual_seed(141)
    B, S = MM_BATCH, MM_SEQ
    calib = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = _mm_params(cfg, 142, _mm_published_rates(n_layers, MM_FIRST))
    torch.cuda.synchronize()
    t_make = time.time() - t0
    make_gb = torch.cuda.max_memory_allocated() / 1e9
    block_gb = sum(t.numel() * t.element_size()
                   for b in params["blocks"] for t in _tensors(b)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, offload_params=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    rss, hwm = _rss_gb()
    check(all(b is None for b in ar.params["blocks"])
          and result.layers["blocks.0.qkv_proj"].qdq.device.type == "cpu",
          f"{label}: a donated block is held, or the result is not on the "
          f"host")
    del ar
    log(f"{label} quantize: {n_layers} blocks of {block_gb / n_layers:.2f} "
        f"GB bf16 ({block_gb:.1f} GB) made and parked in {t_make:.1f} s "
        f"(device peak {make_gb:.2f} GB), RTN through offload in "
        f"{t_quant:.1f} s ({len(result.layers)} layers), device peak "
        f"{quant_gb:.2f} GB, process resident {rss:.1f} GB after it "
        f"(lifetime peak {hwm:.1f} GB)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=1024)
    torch.cuda.synchronize()
    t_pack, pack_gb = time.time() - t0, torch.cuda.max_memory_allocated() / 1e9
    _mm_structure(eng, label)
    log(f"{label} engine: pack_s={t_pack:.2f} {len(eng.packed)} packed "
        f"entries ({sum(v == 'w4a16_grouped' for v in eng.packed_kinds.values())}"
        f" expert stacks of {cfg.num_experts}); resident_gb="
        f"{torch.cuda.memory_allocated() / 1e9:.2f} pack_peak_gb="
        f"{pack_gb:.2f} weight_gb={_weight_bytes(eng) / 1e9:.3f}")
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    toks, gen_counts = generate_counted(eng, prompts, MM_NEW)
    t_gen = time.time() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    gen_gb = torch.cuda.max_memory_allocated() / 1e9
    n_full = sum(t == "full_attention" for t in cfg.layer_types)
    want = dict(_ds_want(eng, MM_NEW), flash_attention=n_full)
    log(f"{label} kernels {json.dumps(launches)} generate_s={t_gen:.2f} "
        f"generate device peak_gb={gen_gb:.2f}")
    _ds_counts(launches, want, label)
    check(all(launches[n] > 0 for n in ("w4a16_matmul",
                                        "w4a16_matmul_grouped",
                                        "flash_attention")),
          f"{label}: rows 1, 4 and 5 must all launch")
    _check_tokens(toks, B, MM_NEW, cfg.vocab_size)
    prefill_ms, step_ms = time_serving(eng, prompts, MM_NEW, bw, flops_peak)
    _mm_block_check(eng, result.params, prompts, label)
    del result
    gc.collect()
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    free_device_memory()
    _mm_state_check(eng, prompts, label)
    check_copy(eng, prompts, "card", MOE_COPY_ROW_TOL, first=2)
    scan_path(eng, prompts, toks, gen_counts, label, step_ms)
    summary = dict(prefill_ms=prefill_ms, quantize_s=t_quant,
                   quant_gb=quant_gb, rss_gb=rss)
    summary["B8"] = scan_measure(eng, 8, S, bw, flops_peak, None,
                                 seed=143, label=label,
                                 ran=(prompts, step_ms), second=True)
    summary["B1"] = scan_measure(eng, 1, S, bw, flops_peak, None, seed=144,
                                 label=label, second=True)
    log(f"{label} path: prefill_ms={prefill_ms:.2f} graph step "
        + "; ".join(f"{b}: {summary[b]['step_ms']:.4f} ms (bound "
                    f"{summary[b]['bound_ms']:.4f}, busy "
                    f"{summary[b]['busy']:.3f})" for b in ("B8", "B1"))
        + f"; peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"path_s={time.time() - t_path:.1f}")
    del eng
    return launches, summary


def minimax_tune_path():
    """(b) SignRound W4A16 (``iters`` 4, 2 x 512 ids, 2 sequences a step)
    on the published layers 6-7 (a lightning layer and the full one: rows
    1-3 in the full layer's loss) at full width with MM_TUNE_EXPERTS of
    the 32 experts, then served: ``generate_scan`` equal to ``generate``.
    Returns the tuning's launches."""
    cfg, _ = _minimax(2, first=6, experts=MM_TUNE_EXPERTS)
    launches = _moe_tune_path(cfg, f"minimax tune x 2 ({MM_TUNE_EXPERTS} "
                              f"experts)", 145, "W4A16", 2, 2, iters=4,
                              nsamples=2)
    check(all(launches[n] > 0 for n in ("flash_attention",
                                        "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")),
          f"minimax tune: rows 1-3 must launch ({launches})")
    return launches


def write_hf_minimax(params, cfg, path, hf_config):
    """An HF ``minimax`` directory of a port parameter tree (on any
    device): the lightning layers' fused ``self_attn.qkv_proj``,
    ``out_proj``, ``output_gate`` and ``norm`` with the four decay buffers
    the loaders skip, the full layers' q / k / v / o, Mixtral's
    ``block_sparse_moe`` keys, every leaf in the model dtype as a
    published checkpoint stores it (the tree's fp32 gains are cast in
    place, so the tree is what a load gives back; ``slope_rate`` is not
    written: the loader computes it); its ``config.json`` is
    ``hf_config``.  The JAX package has no writer for the family."""
    from autoround_tpu_torch.utils.safetensors_io import save_file

    for b in [params] + params["blocks"]:
        for k, t in b.items():
            if (isinstance(t, torch.Tensor) and t.ndim == 1
                    and k != "slope_rate"):
                b[k] = t.to(cfg.dtype)
    t = {"model.embed_tokens.weight": params["embed_tokens"],
         "model.norm.weight": params["norm"],
         "lm_head.weight": params["lm_head"]}
    for li, b in enumerate(params["blocks"]):
        p = f"model.layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{n}.weight"] = b[n]
        if "qkv_proj" in b:
            for n in ("qkv_proj", "out_proj", "output_gate"):
                t[f"{p}self_attn.{n}.weight"] = b[n]
            t[p + "self_attn.norm.weight"] = b["attn_norm"]
            for n in ("slope_rate", "query_decay", "key_decay",
                      "diagonal_decay"):
                t[f"{p}self_attn.{n}"] = torch.ones(
                    (cfg.num_heads, 1, 1), device=b["attn_norm"].device)
        else:
            for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
                t[f"{p}self_attn.{n}.weight"] = b[n]
        t[p + "block_sparse_moe.gate.weight"] = b["router"]
        for e, ew in enumerate(b["experts"]):
            for wn in ("w1", "w2", "w3"):
                t[f"{p}block_sparse_moe.experts.{e}.{wn}.weight"] = ew[wn]
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.contiguous() for k, v in t.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(hf_config, indent=2))


def minimax_phase(bw, flops_peak, n_layers):
    """MiniMax-Text-01: paths (a) ``minimax_path``, (b)
    ``minimax_tune_path`` and (c) a ``minimax`` HF directory at the
    published widths x 2 (layers 6-7: lightning and full;
    MM_LOAD_EXPERTS experts) → the CLI → ``from_pretrained``, logits equal
    to the in-memory engine's; returns their launches."""
    t0 = time.time()
    out = {}
    out["minimax"], summ = minimax_path(bw, flops_peak, n_layers)
    free_device_memory()
    t1 = time.time()
    out["minimax_tune"] = minimax_tune_path()
    free_device_memory()
    t_tune = time.time() - t1
    t1 = time.time()
    root = Path(tempfile.mkdtemp(prefix="minimax_load_"))
    try:
        cfg, hf = _minimax(2, first=6, experts=MM_LOAD_EXPERTS)
        oss_llama4_load_path(root, cfg, "minimax", 146, 128, hf_config=hf,
                             write=write_hf_minimax)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory()
    log(f"minimax phase: quantize_s={summ['quantize_s']:.1f} (device peak "
        f"{summ['quant_gb']:.2f} GB, resident {summ['rss_gb']:.1f} GB) "
        f"prefill_ms={summ['prefill_ms']:.2f} B=8 "
        f"{summ['B8']['step_ms']:.4f} ms (bound {summ['B8']['bound_ms']:.4f}"
        f") B=1 {summ['B1']['step_ms']:.4f} ms (bound "
        f"{summ['B1']['bound_ms']:.4f}); tune_s={t_tune:.1f} load_s="
        f"{time.time() - t1:.1f} minimax_s={time.time() - t0:.1f}")
    return out


# ------------------------------------------------ ERNIE-4.5, LongCat, Step-3.5
#
# Three families the port quantizes and exports but does not serve (the JAX
# engine serves none of them), at full width with random weights from a
# seed: ERNIE-4.5-21B-A3B (20 query heads over 4 KV heads of 128: rows 1-3
# at G = 5 in its tuning loss), LongCat-Flash (one 40 GB layer, through
# host offload) and Step-3.5-Flash (full and sliding layers at their own
# head counts).

EL_BATCH, EL_SEQ = 8, 512
# LongCat-Flash-Chat's published widths (meituan-longcat/LongCat-Flash-Chat
# config.json): hidden 6144, 64 heads, q / kv LoRA ranks 1536 / 512, qk
# 128 + 64, v 128, dense FFN 12288, 512 experts of 2048 plus 256 zero
# experts, top 12, routed_scaling_factor 6.0, vocab 131072, 28 layers.  No
# published config.json is in the repository: these are its fields,
# written here.
LONGCAT_FLASH = dict(
    vocab_size=131072, hidden_size=6144, intermediate_size=12288,
    num_layers=28, num_heads=64, num_kv_heads=64, rope_theta=10000000.0,
    rms_eps=1e-5, q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=512,
    zero_expert_num=256, num_experts_per_tok=12, moe_intermediate_size=2048,
    n_shared_experts=0, first_k_dense=0, routed_scaling_factor=6.0,
    scoring_func="softmax", norm_topk_prob=False, rope_interleave=True)
# block 0 of LongCat-Flash on the W4A16 g128 RTN weights against the FP
# block, the FP run's experts pinned: the distance of the two updates over
# the FP update's norm (Frobenius).  A block that computed another function
# of the same size gives ~1.4; this one reads 0.686-0.689 on an H100
LC_UPDATE_TOL = 0.8
# the same distance with every linear of the block RTN'd at W8 g128
# instead: int8's step is ~18x finer than int4's, so where the W4 distance
# is rounding the W8 one is about that much smaller (0.0583 on an H100,
# 11.8x: the W4 error is past the linear range of the attention's softmax)
LC_W8_TOL = 0.08
# the layers of the offloaded LongCat result held bit-equal to an
# on-device RTN of the same weights
LC_HELD = ("blocks.0.q_a_proj_0", "blocks.0.q_b_proj_1",
           "blocks.0.kv_b_proj_0", "blocks.0.o_proj_1",
           "blocks.0.down_proj_0", "blocks.0.experts.0.gate_proj",
           "blocks.0.experts.511.down_proj", "lm_head")
# routed experts of the LongCat copy that is exported (its size on disk;
# the widths and the 256 zero experts kept)
LC_EXPORT_EXPERTS = 8
# Step-3.5-Flash in the ``step3p5`` config layout, after the published
# stepfun-ai/Step-3.5-Flash config.json but not checked against it (no
# copy of the file is in the repository; PERF.md §7 lists every field as
# unverified): hidden 4096, 45 layers and one MTP layer,
# full attention every 4th layer at 64 query heads over 8 groups, the
# sliding layers (window 512) at 96 over 8, rope theta 5e6 full / 1e4
# sliding, MoE from layer 3 on: 288 experts of 1280, top 8, a shared
# expert of 1280, the sigmoid router with its bias, scaling 3.0; the
# clamps set on the last layers.
STEP35_HF = dict(
    model_type="step3p5", vocab_size=128896, hidden_size=4096,
    intermediate_size=11264, num_hidden_layers=45, num_attention_heads=64,
    num_attention_groups=8, head_dim=128, rope_theta=[5000000.0, 10000.0],
    rms_norm_eps=1e-5, tie_word_embeddings=False, sliding_window=512,
    layer_types=["full_attention" if i % 4 == 0 else "sliding_attention"
                 for i in range(46)],
    attention_other_setting={"num_attention_heads": 96,
                             "num_attention_groups": 8},
    moe_layers_enum=",".join(str(i) for i in range(3, 45)),
    moe_num_experts=288, moe_top_k=8, moe_intermediate_size=1280,
    share_expert_dim=1280, moe_router_scaling_factor=3.0,
    norm_expert_weight=True, use_moe_router_bias=True,
    swiglu_limits=[0.0] * 43 + [7.0, 7.0],
    swiglu_limits_shared=[0.0] * 43 + [16.0, 16.0],
    num_nextn_predict_layers=1, torch_dtype="bfloat16")


def _step35(n_layers):
    """The published Step-3.5 config (``STEP35_HF``) through the port's HF
    config reader, cut to its first ``n_layers`` (``layer_types`` and the
    MoE layers cut with it)."""
    from autoround_tpu_torch.utils.hf_loader import config_from_hf

    cfg = config_from_hf(STEP35_HF)
    check(cfg.num_layers == 45 and cfg.heads_for(0) == (64, 8)
          and cfg.heads_for(1) == (96, 8) and cfg.moe_layers[0] == 3
          and (cfg.rope_theta, cfg.rope_local_theta) == (5e6, 1e4)
          and (cfg.swiglu_limit, cfg.swiglu_limit_shared) == (7.0, 16.0)
          and len(cfg.layer_types) == 45,
          f"step3p5 config read wrongly: {cfg}")
    return dataclasses.replace(
        cfg, num_layers=n_layers, layer_types=cfg.layer_types[:n_layers],
        moe_layers=tuple(i for i in cfg.moe_layers if i < n_layers))


# the router of each family of the phase: its module's ``_route`` (which
# returns (top-k ids, weights) per token) and the selection-bias leaf that
# ``_route`` adds to the scores before its top-k
_ROUTERS = {"Ernie45Config": ("ernie45", "e_score_correction_bias"),
            "LongcatConfig": ("longcat", "e_score_correction_bias"),
            "Step35Config": ("step35", "router_bias")}


@contextlib.contextmanager
def _recorded_routes(cfg, into):
    """Inside the block, each call of the family's ``_route`` appends its
    top-k ids to ``into``."""
    import importlib

    mod = importlib.import_module("autoround_tpu_torch.models."
                                  + _ROUTERS[type(cfg).__name__][0])
    orig = mod._route

    def spy(*a, **k):
        out = orig(*a, **k)
        into.append(out[0])
        return out
    mod._route = spy
    try:
        yield
    finally:
        mod._route = orig


def _pinned(blk, cfg, topi):
    """``blk`` with its selection bias made per token: 1e4 on the experts
    ``topi`` (B, S, k) chose, so the router selects them whatever its
    scores, while its weights stay this run's scores at those experts."""
    leaf = _ROUTERS[type(cfg).__name__][1]
    bias = blk[leaf].float()
    pin = torch.zeros(topi.shape[:-1] + bias.shape, device=bias.device)
    pin.scatter_(-1, topi, 1e4)
    return dict(blk, **{leaf: bias + pin})


def _flipped(a, b):
    """(B, S) bool: the tokens whose top-k sets differ."""
    return (a.sort(-1).values != b.sort(-1).values).any(-1)


def _held_blocks(params, cfg, prompts, label, n_blocks, tol):
    """The first ``n_blocks`` blocks on the qdq weights (brought up from
    the host one at a time where they live there), teacher forced: each
    block through the kernels as the quantizer runs it against
    ``block_fwd`` on the plain versions, on the same input, within ``tol``
    (row error); the counts kept.  A MoE block's router may take another
    expert for a token whose k-th and (k+1)-th choices are a last-bit
    near-tie, which moves that token's row as a whole: its kernel run is
    held with the plain run's selections pinned (``_pinned``), and the
    tokens whose free selection flipped are counted and printed.  Returns
    the row errors."""
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.models.registry import get_model_fns
    from autoround_tpu_torch.utils.pytree import tree_map

    fns = get_model_fns(cfg)
    fwd_for = getattr(fns, "block_fwd_for", lambda c, i: fns.block_fwd)
    seq = prompts.cuda()
    S = seq.shape[1]
    errs, notes = [], []
    with counts_kept(), torch.no_grad():
        x = fns.embed_fwd({"embed_tokens": params["embed_tokens"].cuda()},
                          seq, cfg)
        # the orchestrator's tables and mask
        if fns.rope_tables is llama.rope_tables:
            glob, loc = llama.dual_rope_tables(cfg, S, device="cuda")
        else:
            glob = loc = fns.rope_tables(cfg, S, device="cuda")
        smask = (llama.sliding_mask(cfg, S, "cuda")
                 if cfg.sliding_window is not None
                 and S > cfg.sliding_window else None)
        for i in range(n_blocks):
            blk = tree_map(lambda t: t.cuda(), params["blocks"][i])
            sl = llama.layer_is_sliding(cfg, i)
            cos, sin = loc if sl else glob
            m = smask if sl else None
            fwd = fwd_for(cfg, i)
            moe = "experts" in blk
            ref_routes, routes = [], []
            with plain_versions(), (_recorded_routes(cfg, ref_routes) if moe
                                    else contextlib.nullcontext()):
                ref = fwd(blk, x, cos, sin, cfg, mask=m)
            with (_recorded_routes(cfg, routes) if moe
                  else contextlib.nullcontext()):
                y = fwd(blk, x, cos, sin, cfg, mask=m)
            check(bool(torch.isfinite(y).all()) and y.shape == x.shape,
                  f"{label}: block {i} output not finite or misshapen")
            note = f"{row_err(y, ref)[1]:.4g}"
            if moe:
                flips = _flipped(routes[0], ref_routes[0])
                y = fwd(_pinned(blk, cfg, ref_routes[0]), x, cos, sin, cfg,
                        mask=m)
                note += (f" free, {int(flips.sum())} of {flips.numel()} "
                         f"tokens' experts flipped, pinned")
            errs.append(row_err(y, ref)[1])
            notes.append(f"{note} {errs[-1]:.4g}" if moe else note)
            x = ref
            del blk, y, ref
        torch.cuda.synchronize()
    log(f"{label}: blocks 0-{n_blocks - 1} on the qdq weights teacher "
        f"forced, kernels against block_fwd on the plain versions row_err "
        f"{' / '.join(notes)} (tol {tol})")
    check(all(r <= tol for r in errs),
          f"{label}: a block through the kernels disagrees with block_fwd "
          f"on the plain versions")
    return errs


def _el_params(cfg, seed, park=None):
    """Random weights of ``cfg``'s family made on the card from ``seed``
    (each block given to ``park`` as it is made, where given), moved by
    ``perturb_moe``; a softmax router's ``e_score_correction_bias`` (ERNIE,
    LongCat) then scaled to N(0, 0.5 / E), the size of its probabilities,
    so that both the scores and the bias steer the selection."""
    from autoround_tpu_torch.models.registry import get_model_fns

    def moved(b):
        perturb_moe({"norm": torch.zeros(1, device="cuda"), "blocks": [b]},
                    seed + len(made))
        if "e_score_correction_bias" in b:
            bias = b["e_score_correction_bias"]
            bias.mul_(1.0 / bias.numel())
        made.append(None)
        return b if park is None else park(b)

    made = []
    params = get_model_fns(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda",
        park=moved)
    params["norm"].add_(torch.randn(
        params["norm"].shape, device="cuda", dtype=params["norm"].dtype,
        generator=torch.Generator(device="cuda").manual_seed(seed)),
        alpha=0.1)
    return params


def _export_readback(result, cfg, label, names):
    """An ``autoround`` export of ``result`` into a temporary directory,
    read back: ``model_config`` through ``config_from_jax`` to ``cfg``'s
    class and fields, and each of ``names``' packed words, zeros and fp16
    scales unpacked equal to the codes of its qdq weight and its scales.
    Returns the seconds of the export."""
    from autoround_tpu_torch.export import save_quantized
    from autoround_tpu_torch.export.packing import (codes_from_qdq_torch,
                                                    unpack_quantized_torch)
    from autoround_tpu_torch.utils.convert import config_from_jax
    from autoround_tpu_torch.utils.safetensors_io import SafeOpen

    root = Path(tempfile.mkdtemp(prefix="export_"))
    try:
        t0 = time.time()
        save_quantized(result, cfg, str(root), "autoround")
        t_save = time.time() - t0
        size = sum(p.stat().st_size for p in root.iterdir()) / 1e9
        qcfg = json.loads((root / "quantization_config.json").read_text())
        back = config_from_jax(qcfg["model_config"])
        check(type(back) is type(cfg)
              and back == dataclasses.replace(cfg, dtype=back.dtype),
              f"{label}: the export's model_config reads back as {back}")
        with SafeOpen(str(root / "model.safetensors"), device="cuda") as f:
            for name in names:
                ql = result.layers[name]
                O, I = ql.qdq.shape
                payload = {s: f.get_tensor(f"{name}.{s}")
                           for s in ("qweight", "qzeros", "scales")}
                codes, scales, zp = unpack_quantized_torch(payload, 4, O, I)
                want = codes_from_qdq_torch(ql.qdq.cuda(), ql.scale.cuda(),
                                            None, 4, ql.scheme.group_size)
                check(torch.equal(codes, want)
                      and torch.equal(scales,
                                      ql.scale.cuda().half().float())
                      and bool((zp == 8).all()),
                      f"{label}: {name} read back from the export differs")
        log(f"{label} export: autoround, {len(result.layers)} layers, "
            f"{size:.2f} GB in {t_save:.1f} s; model_config read back as a "
            f"{type(back).__name__} equal to the run's; {len(names)} "
            f"layers' words, zeros and scales equal to the result's")
        return t_save
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ernie_path(n_layers):
    """(a) ERNIE-4.5-21B-A3B at full width, ``n_layers`` of 28 (layer 0
    dense, the others MoE at E = 64): random weights made on the card,
    gains moved, the router biases drawn → RTN W4A16 g128 with the tied
    lm_head (``embed_tokens``) → blocks 0-1 teacher forced on the qdq
    weights (kernels against the plain versions: row 1 at G = 5) → an
    ``autoround`` export read back.  (b) SignRound (iters 4, 2 x 512, 2 a
    step) on layers 0-1: rows 1-3 at G = 5 in the loss.  Returns the
    launches of the RTN and of the tuning."""
    from autoround_tpu_torch import AutoRound
    from autoround_tpu_torch.models import ernie45
    from autoround_tpu_torch.utils.logger import logger as ar_logger

    t_path = time.time()
    cfg = dataclasses.replace(ernie45.CONFIG_PRESETS["ernie4.5-21b-a3b"],
                              num_layers=n_layers)
    label = f"ernie4.5-21b-a3b x {n_layers}"
    kernels = _kernel_fns()
    gen = torch.Generator().manual_seed(151)
    calib = torch.randint(0, cfg.vocab_size, (EL_BATCH, EL_SEQ),
                          generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, EL_SEQ), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    params = _el_params(cfg, 152)
    gb = sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    rtn = {n: fn.launches for n, fn in kernels.items()}
    check(rtn["flash_attention"] == n_layers,
          f"{label}: the RTN chain launched row 1 {rtn['flash_attention']} "
          f"times, one a block implied (its FP pass over 8 x 512)")
    n_moe = sum(ernie45.layer_is_moe(cfg, i) for i in range(n_layers))
    want = 4 * n_layers + 3 * (n_layers - n_moe) + 3 * 65 * n_moe + 1
    check(len(result.layers) == want
          and result.params["embed_tokens"] is result.layers["lm_head"].qdq,
          f"{label}: {len(result.layers)} layers ({want} implied) or the "
          f"tied head not quantized in embed_tokens")
    log(f"{label} quantize: {gb:.2f} GB of bf16 made and RTN'd in "
        f"{t_quant:.1f} s ({len(result.layers)} layers, {n_moe} MoE blocks "
        f"of 64 experts), device peak {quant_gb:.2f} GB; RTN kernels "
        f"{json.dumps(rtn)}")
    _held_blocks(result.params, cfg, prompts, label, 2, COPY_ROW_TOL)
    _export_readback(result, cfg, label, [
        "blocks.0.q_proj", "blocks.0.down_proj", "blocks.1.experts.63.up_proj",
        "blocks.1.shared_experts.down_proj", "lm_head"])
    del ar, result
    free_device_memory()

    t1 = time.time()
    tcfg = dataclasses.replace(cfg, num_layers=2)
    for fn in kernels.values():
        fn.launches = 0
    h = _BlockLosses()
    level = ar_logger.level
    ar_logger.addHandler(h)
    ar_logger.setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats()
    try:
        params = _el_params(tcfg, 153)
        res = AutoRound((params, tcfg), scheme="W4A16", iters=4,
                        batch_size=2, donate_params=True).quantize(calib[:2])
        del params
    finally:
        ar_logger.removeHandler(h)
        ar_logger.setLevel(level)
    tune = {n: fn.launches for n, fn in kernels.items()}
    check(sorted(h.blocks) == [0, 1]
          and all(best <= first for first, best, _ in h.blocks.values())
          and all(bool(torch.isfinite(torch.as_tensor(t)).all())
                  for t in res.loss_traces.values()),
          f"ernie tune: losses {h.blocks}")
    check(all(tune[n] > 0 for n in ("flash_attention",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")),
          f"ernie tune: rows 1-3 must launch at G = 5 ({tune})")
    log(f"ernie tune x 2 (dense, MoE E=64; G = 5): "
        + "; ".join(f"block {bi} loss first {f:.6g} best {b:.6g} "
                    f"tune_step_ms={s / 4 * 1e3:.1f}"
                    for bi, (f, b, s) in sorted(h.blocks.items()))
        + f"; kernels {json.dumps(tune)} tune_peak_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} tune_s="
        f"{time.time() - t1:.1f}")
    del res
    log(f"{label} path: path_s={time.time() - t_path:.1f}")
    return rtn, tune


def _longcat(n_layers, experts=None):
    from autoround_tpu_torch.models.longcat import LongcatConfig

    cfg = LongcatConfig(**dict(LONGCAT_FLASH, num_layers=n_layers))
    if experts is not None:
        cfg = dataclasses.replace(cfg, n_routed_experts=experts)
    return cfg


def longcat_path(n_layers):
    """(c) LongCat-Flash at its published widths, ``n_layers`` of 28 (one
    block is 40 GB of bf16): the blocks made on the card and parked on the
    host, the output of block 0 on the FP weights kept → RTN W4A16 g128
    with the lm_head through ``offload_params`` and ``donate_params``
    (device peak, process RSS) → block 0 on the qdq weights teacher forced
    against the FP block's output with the FP run's experts pinned (MLA
    keeps the plain attention, so no kernel runs), and the same block on
    W8 g128 weights (each linear qdq'd in place on the card) against it
    too, which shows how much of the W4 distance is rounding → LC_HELD layers
    bit-equal to an on-device RTN of their FP weights (kept on the card as
    the block was made) → a copy with
    LC_EXPORT_EXPERTS of the 512 routed experts (widths and zero experts
    kept) RTN'd on the card, exported and read back.  Returns no
    launches (none is expected)."""
    from autoround_tpu_torch import AutoRound
    from autoround_tpu_torch.algorithms.rtn import rtn_quantize_layer
    from autoround_tpu_torch.models import longcat
    from autoround_tpu_torch.models.deepseek import rope_tables
    from autoround_tpu_torch.models.llama import embed_fwd
    from autoround_tpu_torch.schemes import parse_scheme
    from autoround_tpu_torch.utils.offload import tree_to_host
    from autoround_tpu_torch.utils.pytree import get_by_path, tree_map

    t_path = time.time()
    cfg = _longcat(n_layers)
    label = f"longcat-flash x {n_layers}"
    kernels = _kernel_fns()
    gen = torch.Generator().manual_seed(161)
    calib = torch.randint(0, cfg.vocab_size, (EL_BATCH, EL_SEQ),
                          generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, EL_SEQ), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    # the held layers' FP weights, kept on the card as the blocks are made
    held = {}

    def park(b):
        for name in LC_HELD:
            if name.startswith("blocks.0."):
                held[name] = get_by_path(b, name[len("blocks.0."):]).clone()
        return tree_to_host(b)
    params = _el_params(cfg, 162, park=park)
    held["lm_head"] = params["lm_head"].clone()
    torch.cuda.synchronize()
    t_make = time.time() - t0
    block_gb = sum(t.numel() * t.element_size()
                   for b in params["blocks"] for t in _tensors(b)) / 1e9
    with torch.no_grad():
        x0 = embed_fwd(params, prompts.cuda(), cfg)
        cos, sin = rope_tables(cfg, EL_SEQ, device="cuda")
        blk = tree_map(lambda t: t.cuda(), params["blocks"][0])
        fp_routes = []
        with _recorded_routes(cfg, fp_routes):
            y_fp = longcat.block_fwd(blk, x0, cos, sin, cfg)
        # the rounding's share: each linear of the card's copy qdq'd in
        # place at W8 g128, the FP run's experts pinned
        w8 = parse_scheme("W8A16")
        for name in longcat.block_linear_names(cfg):
            w = get_by_path(blk, name)
            w.copy_(rtn_quantize_layer(w, w8).qdq)
        y_w8 = longcat.block_fwd(_pinned(blk, cfg, fp_routes[0]), x0, cos,
                                 sin, cfg)
        del blk
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, offload_params=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    rss, hwm = _rss_gb()
    launches = {n: fn.launches for n, fn in kernels.items()}
    check(all(b is None for b in ar.params["blocks"])
          and result.layers["blocks.0.experts.511.up_proj"].qdq.device.type
          == "cpu" and not any(launches.values()),
          f"{label}: a donated block held, the result not on the host, or "
          f"a kernel launched ({launches})")
    del ar
    log(f"{label} quantize: {n_layers} block(s) of {block_gb / n_layers:.2f}"
        f" GB bf16 made and parked in {t_make:.1f} s, RTN through offload "
        f"in {t_quant:.1f} s ({len(result.layers)} layers), device peak "
        f"{quant_gb:.2f} GB, process resident {rss:.1f} GB (lifetime peak "
        f"{hwm:.1f} GB)")
    with torch.no_grad():
        blk = tree_map(lambda t: t.cuda(), result.params["blocks"][0])
        q_routes = []
        with _recorded_routes(cfg, q_routes):
            y_free = longcat.block_fwd(blk, x0, cos, sin, cfg)
        y_q = longcat.block_fwd(_pinned(blk, cfg, fp_routes[0]), x0, cos,
                                sin, cfg)
        del blk
        d_fp = (y_fp - x0).float()
        rel = ((y_q - y_fp).float().norm() / d_fp.norm()).item()
        rel_w8 = ((y_w8 - y_fp).float().norm() / d_fp.norm()).item()
        rel_free = ((y_free - y_fp).float().norm() / d_fp.norm()).item()
        flips = _flipped(q_routes[0], fp_routes[0])
    check(bool(torch.isfinite(y_q).all()) and y_q.shape == x0.shape
          and rel <= LC_UPDATE_TOL and rel_w8 <= LC_W8_TOL,
          f"{label}: block 0 on the qdq weights not finite, or its update "
          f"{rel} (W8 g128: {rel_w8}) of the FP block's from it")
    log(f"{label}: block 0 teacher forced on the qdq weights against the FP "
        f"block, the FP run's experts pinned: its update moves by {rel:.4g} "
        f"of its norm (tol {LC_UPDATE_TOL}), on W8 g128 weights by "
        f"{rel_w8:.4g} (tol {LC_W8_TOL}; W4 / W8 {rel / rel_w8:.3g}); free "
        f"routing {rel_free:.4g}, {int(flips.sum())} of {flips.numel()} "
        f"tokens' top-12 flipped")
    # the held layers RTN'd on the card from their FP weights: the
    # offloaded result's must be bit-equal
    for name, w in held.items():
        ql = result.layers[name]
        r = rtn_quantize_layer(w, ql.scheme)
        check(torch.equal(ql.qdq.cuda(), r.qdq.to(ql.qdq.dtype))
              and torch.equal(ql.scale.cuda(), r.scale),
              f"{label}: {name} differs from an on-device RTN")
    del result, x0, y_fp, y_q, y_w8, y_free, d_fp, held
    log(f"{label}: {len(LC_HELD)} layers of the offloaded result (qdq, so "
        f"the codes, and scales) bit-equal to an on-device RTN of the same "
        f"weights: {', '.join(LC_HELD)}")
    gc.collect()
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    free_device_memory()

    ecfg = _longcat(1, LC_EXPORT_EXPERTS)
    t0 = time.time()
    params = _el_params(ecfg, 163)
    res = AutoRound((params, ecfg), scheme="W4A16", iters=0,
                    quant_lm_head=True, donate_params=True).quantize(calib)
    del params
    t_rtn = time.time() - t0
    _export_readback(res, ecfg, f"longcat-flash x 1 ({LC_EXPORT_EXPERTS} "
                     f"experts)", ["blocks.0.q_b_proj_0",
                                   "blocks.0.kv_b_proj_1",
                                   "blocks.0.experts.7.down_proj", "lm_head"])
    del res
    free_device_memory()
    log(f"{label} path: copy RTN s={t_rtn:.1f} path_s="
        f"{time.time() - t_path:.1f}")
    return launches


def step35_path(n_layers):
    """(d) Step-3.5-Flash at its published widths (``STEP35_HF`` through
    ``config_from_hf``), its first ``n_layers`` of 45 (full layer 0 at 64
    heads over 8, sliding layers 1-3 at 96 over 8 with a 512 window, MoE
    layer 3 with 288 experts): random weights, gains moved, router biases
    drawn → RTN W4A16 g128 with the lm_head (the 512-token calibration
    sits at the window: no mask, so row 1 runs at both head counts) →
    blocks 0-3 teacher forced on the qdq weights, kernels against the
    plain versions → an ``autoround`` export read back.  Returns the
    launches of the RTN."""
    from autoround_tpu_torch import AutoRound

    t_path = time.time()
    cfg = _step35(n_layers)
    label = f"step-3.5-flash x {n_layers}"
    kernels = _kernel_fns()
    gen = torch.Generator().manual_seed(171)
    calib = torch.randint(0, cfg.vocab_size, (EL_BATCH, EL_SEQ),
                          generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, EL_SEQ), generator=gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    params = _el_params(cfg, 172)
    gb = sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    quant_gb = torch.cuda.max_memory_allocated() / 1e9
    rtn = {n: fn.launches for n, fn in kernels.items()}
    check(rtn["flash_attention"] == n_layers,
          f"{label}: the RTN chain launched row 1 {rtn['flash_attention']} "
          f"times, one a block implied (full and sliding layers alike)")
    n_moe = len(cfg.moe_layers)
    want = (4 * n_layers + 3 * (n_layers - n_moe)
            + 3 * (cfg.moe_num_experts + 1) * n_moe + 1)
    check(len(result.layers) == want
          and not any("g_proj" in n for n in result.layers),
          f"{label}: {len(result.layers)} layers ({want} implied)")
    log(f"{label} quantize: {gb:.2f} GB of bf16 made and RTN'd in "
        f"{t_quant:.1f} s ({len(result.layers)} layers; heads "
        f"{[cfg.heads_for(i) for i in range(n_layers)]}, MoE layers "
        f"{cfg.moe_layers} of {cfg.moe_num_experts} experts), device peak "
        f"{quant_gb:.2f} GB; RTN kernels {json.dumps(rtn)}")
    _held_blocks(result.params, cfg, prompts, label, n_layers,
                 COPY_ROW_TOL)
    last = n_layers - 1
    _export_readback(result, cfg, label, [
        "blocks.0.q_proj", "blocks.1.q_proj", "blocks.0.down_proj",
        f"blocks.{last}.experts.287.gate_proj",
        f"blocks.{last}.shared_expert.down_proj", "lm_head"])
    del ar, result
    free_device_memory()
    log(f"{label} path: path_s={time.time() - t_path:.1f}")
    return rtn


def ernie_longcat_step35_phase(ernie_layers, longcat_layers, step35_layers):
    """ERNIE-4.5, LongCat-Flash and Step-3.5: paths (a)-(b)
    ``ernie_path``, (c) ``longcat_path``, (d) ``step35_path``; returns
    their launches."""
    t0 = time.time()
    out = {}
    out["ernie"], out["ernie_tune"] = ernie_path(ernie_layers)
    free_device_memory()
    t1 = time.time()
    out["longcat"] = longcat_path(longcat_layers)
    free_device_memory()
    t_lc = time.time() - t1
    t1 = time.time()
    out["step35"] = step35_path(step35_layers)
    free_device_memory()
    log(f"ernie / longcat / step35 phase: longcat_s={t_lc:.1f} step35_s="
        f"{time.time() - t1:.1f} device peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the last path's)"
        f" phase_s={time.time() - t0:.1f}")
    return out

# --------------------------------------------------------- GGUF / rotation

def _llama8b(n_layers, seed):
    """llama3-8b at full width, ``n_layers`` deep, random weights made on
    the card from ``seed``."""
    from autoround_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"],
                              num_layers=n_layers)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    return cfg, params


def _gguf_serve(label, cfg, result, prompts, new, want, copy_layers):
    """The int8-KV engine of a GGUF (or rotated) result → ``generate`` with
    every kernel of ``want`` launched → a ``copy_layers``-deep copy on the
    plain versions on the card → ``generate_scan`` (tokens and launches
    equal, the replayed step's launches measured).  Logs the packed layers
    by kind and the dense ones; returns generate's launches."""
    from autoround_tpu_torch import QuantizedLlama

    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=1024,
                                              kv_quant="int8")
    kinds = {}
    for k in eng.packed_kinds.values():
        kinds[k] = kinds.get(k, 0) + 1
    dense = _dense_linears(eng)
    toks, counts = generate_counted(eng, prompts, new)
    _check_tokens(toks, prompts.shape[0], new, cfg.vocab_size)
    for n in want:
        check(counts[n] > 0, f"{label}: {n} not launched ({counts})")
    log(f"{label}: packed entries by kind {json.dumps(kinds)} (q/k/v and "
        f"gate/up fused where all are packed), dense linears {len(dense)} "
        f"{dense[:6]}; generate kernels {json.dumps(counts)}")
    check_copy(eng, prompts, "card", layers=copy_layers)
    scan_path(eng, prompts, toks, counts, label)
    del eng
    torch.cuda.empty_cache()
    return counts


def gguf_q4km_path(n_layers):
    """(a) llama3-8b × ``n_layers``, ``GGUF:Q4_K_M`` RTN with
    ``use_imatrix`` and the lm_head: the cascade (Q6_K head and embedding,
    Q6_K attn_v / ffn_down on the more-bits blocks of this depth), the
    128256 x 4096 embedding's and the head's dq search on the card at a
    device peak far below a materialised search's 33 GB → serve at batch
    8.  Returns the launches."""
    from autoround_tpu_torch import AutoRound
    from autoround_tpu_torch.dtypes import gguf

    B, S, NEW = 8, 512, 32
    torch.cuda.empty_cache()
    cfg, params = _llama8b(n_layers, 70)
    gen = torch.Generator().manual_seed(71)
    calib = torch.randint(0, cfg.vocab_size, (8, S), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="GGUF:Q4_K_M", iters=0,
                   use_imatrix=True, quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    t_quant = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    plan = {k: v.key() for k, v in ar.layer_schemes.items()}
    q6 = sorted(k for k, v in plan.items() if v.startswith("w6"))
    check(plan["embed_tokens"] == plan["lm_head"] == "w6_g16_sym_int_dq",
          f"gguf q4km: embedding / head plan {plan.get('embed_tokens')} "
          f"{plan.get('lm_head')}")
    emb = result.layers["embed_tokens"]
    check(emb.extras is not None
          and emb.qdq.shape == (cfg.vocab_size, cfg.hidden_size)
          and bool(torch.isfinite(emb.extras["d_hat"]).all()),
          "gguf q4km: the embedding's payload")
    check(peak - base_gb < 20.0, f"gguf q4km: quantize peak {peak:.2f} GB "
          f"over {base_gb:.2f} GB of weights")
    log(f"gguf q4km llama3-8b ({n_layers} layers, random weights, "
        f"use_imatrix): quantize_s={t_quant:.2f} device peak {peak:.2f} GB "
        f"(weights {base_gb:.2f} GB: the dq search of the 128256 x 4096 "
        f"embedding and head walks {gguf.CHUNK_ELEMS // 4096}-row chunks, "
        f"a materialised 16-ratio search would hold ~33 GB); Q6_K layers "
        f"at this depth (the cascade follows it) {q6}")
    del ar
    counts = _gguf_serve("gguf q4km path", cfg, result, prompts, NEW,
                         ("w4a16_asym_matmul", "flash_attention",
                          "decode_attention"), 2)
    del result
    return counts


def gguf_tune_path(n_layers, iters=4):
    """(b) llama3-8b × ``n_layers``, ``GGUF:Q4_K_S`` SignRound with
    ``enable_alg_ext`` and ``use_imatrix`` (the dq grid searched before
    each block tunes): rows 1-3 in the loss.  Returns the launches."""
    from autoround_tpu_torch import AutoRound

    kernels = _kernel_fns()
    cfg, params = _llama8b(n_layers, 72)
    calib = torch.randint(0, cfg.vocab_size, (8, 512),
                          generator=torch.Generator().manual_seed(73))
    c0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="GGUF:Q4_K_S", iters=iters,
                   batch_size=8, lr=5e-3, enable_alg_ext=True,
                   use_imatrix=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    tune_s = time.time() - t0
    c1 = launch_counts()
    counts = {n: c1[n] - c0[n] for n in kernels}
    for n in ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        check(counts[n] > 0, f"gguf tune: {n} not launched")
    for bi, tr in result.loss_traces.items():
        check(all(math.isfinite(float(x)) for x in tr),
              f"gguf tune: block {bi} losses")
    check(len(result.imatrices) == 7 * n_layers,
          f"gguf tune: {len(result.imatrices)} imatrices")
    log(f"gguf tune llama3-8b ({n_layers} layers, Q4_K_S, alg_ext + "
        f"imatrix, {iters} iters at lr 5e-3, 8 x 512): tune_s={tune_s:.2f} "
        f"step_ms={tune_s / (iters * n_layers) * 1e3:.1f} (the embedding's "
        f"RTN and the dq searches included) losses "
        f"{json.dumps({b: [round(float(x), 5) for x in t] for b, t in result.loss_traces.items()})}; "
        f"kernels {json.dumps(counts)}")
    del ar, result
    torch.cuda.empty_cache()
    return counts


def gguf_small_path(scheme, n_layers, seed):
    """(c) llama3-8b × ``n_layers``, RTN with the lm_head: ``GGUF:Q3_K_S``
    serves through row 4 with signed 3-bit codes at g16, ``GGUF:Q2_K_S``
    through row 9 at g16 with the fractional zero point m̂ / d̂.  Returns
    the launches."""
    from autoround_tpu_torch import AutoRound

    cfg, params = _llama8b(n_layers, seed)
    gen = torch.Generator().manual_seed(seed)
    calib = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme=scheme, iters=0, quant_lm_head=True,
                   donate_params=True)
    del params
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    log(f"{scheme} llama3-8b ({n_layers} layer): quantize_s="
        f"{time.time() - t0:.2f}")
    kernel = ("w4a16_matmul" if scheme == "GGUF:Q3_K_S"
              else "w4a16_asym_matmul")
    del ar
    counts = _gguf_serve(f"{scheme} path", cfg, result, prompts, 32,
                         (kernel, "flash_attention", "decode_attention"),
                         n_layers)
    del result
    return counts


def gguf_mixed_moe_path(n_layers):
    """(d) mixtral-8x7b × ``n_layers``, ``GGUF:Q2_K_MIXED`` RTN: the
    experts Q2_K, one by one through row 9 (asym experts stack no
    weights), the Q8_0 head through row 11 at g32.  Returns the
    launches."""
    from autoround_tpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["mixtral-8x7b"],
                              num_layers=n_layers)
    gen = torch.Generator().manual_seed(75)
    calib = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    result = _moe_quantize(cfg, calib, 76, "gguf q2_k_mixed mixtral",
                           scheme="GGUF:Q2_K_MIXED", iters=0)
    check(result.layers["blocks.0.experts.0.w1"].scheme.bits == 2
          and result.layers["lm_head"].scheme.bits == 8
          and result.layers["embed_tokens"].scheme.bits == 8,
          "gguf q2_k_mixed: the recipe's types")
    counts = _gguf_serve("gguf q2_k_mixed mixtral path", cfg, result,
                         prompts, 8, ("w4a16_asym_matmul", "w8a16_matmul",
                                      "flash_attention", "decode_attention"),
                         n_layers)
    del result
    return counts


def rotation_path(n_layers, iters=4):
    """(e) llama3-8b × ``n_layers``, W4A16 g128 with
    ``enable_rotation="r1,r4"`` and ``enable_awq``, SignRound: the FP
    logits before and after the rotation on the card (in fp32, where the
    rotation is exact to rounding, held to 1e-3 of a row's RMS; the bf16
    model's, whose rotated weights round to bf16 again, printed), then the
    engine whose down_proj input goes through the online block Hadamard,
    its decode step captured and replayed (``profile_replays`` counts the
    replayed launches).  Returns the launches."""
    from autoround_tpu_torch import AutoRound
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.transforms import hadamard
    from autoround_tpu_torch.utils.pytree import tree_map

    cfg, params = _llama8b(n_layers, 78)
    gen = torch.Generator().manual_seed(77)
    calib = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    perturb_gains(params, 79)
    x = prompts[:2, :128].cuda()
    with torch.no_grad():
        before = llama.model_fwd(params, x, cfg)
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = tree_map(lambda t: t.float(), params)
        l0 = llama.model_fwd(p32, x, c32)
        p32, c32 = hadamard.apply_r4_rotation(
            hadamard.apply_r1_rotation(p32, c32, seed=42), c32)
        _, rel32 = row_err(llama.model_fwd(p32, x, c32), l0)
        del p32, l0
    check(rel32 < 1e-3, f"rotation: fp32 logits moved by {rel32:.2e} of a "
          f"row's RMS")
    t0 = time.time()
    ar = AutoRound((params, cfg), scheme="W4A16", iters=iters, batch_size=8,
                   enable_rotation="r1,r4", enable_awq=True)
    t_rot = time.time() - t0
    del params
    check(ar.model_cfg.online_r4, "rotation: online_r4 not set")
    with torch.no_grad():
        after = llama.model_fwd(ar.params, x, ar.model_cfg)
    abs_err, rel = row_err(after, before)
    check(rel < 0.5, f"rotation: bf16 logits moved by {rel:.4f} of a "
          f"row's RMS")
    del before, after
    t0 = time.time()
    result = ar.quantize(calib)
    torch.cuda.synchronize()
    log(f"rotation llama3-8b ({n_layers} layers, r1 + r4, AWQ, W4A16 g128, "
        f"{iters} iters): rotate_s={t_rot:.2f} FP logits rotated vs not: "
        f"fp32 row_err={rel32:.2e}, bf16 max_abs={abs_err:.4f} row_err="
        f"{rel:.5f}; tune_s="
        f"{time.time() - t0:.2f}")
    cfg = ar.model_cfg
    del ar
    counts = _gguf_serve("rotation path", cfg, result, prompts, 32,
                         ("w4a16_matmul", "flash_attention",
                          "decode_attention"), 2)
    del result
    return counts


def spinquant_path(n_layers, steps=3):
    """(f) SpinQuant's trained R1 (``"spin"``'s weight-space objective) on
    llama3-8b × ``n_layers`` with its steps cut: seconds a step, R
    orthogonal, the FP logits kept."""
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.schemes import parse_scheme
    from autoround_tpu_torch.transforms import spinquant

    cfg, params = _llama8b(n_layers, 80)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128),
                            generator=torch.Generator().manual_seed(81))
    torch.cuda.synchronize()
    t0 = time.time()
    R = spinquant.train_r1_rotation(
        params, cfg, parse_scheme("W4A16"),
        spinquant.SpinQuantConfig(steps=steps), seed=0)
    torch.cuda.synchronize()
    secs = time.time() - t0
    eye = torch.eye(R.shape[0], device=R.device)
    orth = float((R @ R.t() - eye).abs().max())
    check(orth < 1e-3, f"spinquant: R R^T - I up to {orth}")
    from autoround_tpu_torch.utils.pytree import tree_map
    with torch.no_grad():      # in fp32: the rotation exact to rounding
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        params = tree_map(lambda t: t.float(), params)
        before = llama.model_fwd(params, prompts.cuda(), c32)
        rotated = spinquant.apply_trained_rotation(params, c32, R)
        after = llama.model_fwd(rotated, prompts.cuda(), c32)
    abs_err, rel = row_err(after, before)
    check(rel < 1e-3, f"spinquant: fp32 logits moved by {rel:.2e}")
    log(f"spinquant llama3-8b ({n_layers} layers, hidden 4096): {steps} "
        f"steps in {secs:.2f} s ({secs / steps:.2f} s a step, the Cayley "
        f"solve and the {5 * n_layers} rotated read weights' qdq); "
        f"|R R^T - I| max {orth:.2e}; fp32 logits rotated vs not row_err="
        f"{rel:.2e}")
    del params, rotated, R
    torch.cuda.empty_cache()


def gguf_rotation_phase(q4km_layers, tune_layers, small_layers,
                        moe_layers, rot_layers):
    """The GGUF data types and the rotations: paths (a)-(f) above; returns
    their launches."""
    t0 = time.time()
    out = {}
    out["gguf_q4km"] = gguf_q4km_path(q4km_layers)
    free_device_memory()
    out["gguf_tune"] = gguf_tune_path(tune_layers)
    free_device_memory()
    out["gguf_q3k"] = gguf_small_path("GGUF:Q3_K_S", small_layers, 82)
    free_device_memory()
    out["gguf_q2k"] = gguf_small_path("GGUF:Q2_K_S", small_layers, 83)
    free_device_memory()
    out["gguf_q2k_mixed_moe"] = gguf_mixed_moe_path(moe_layers)
    free_device_memory()
    out["rotation"] = rotation_path(rot_layers)
    free_device_memory()
    spinquant_path(rot_layers)
    free_device_memory()
    log(f"gguf / rotation phase: phase_s={time.time() - t0:.1f}")
    return out


# --------------------------------------- driver utilities / formats

AS_OPTIONS = ("W2A16", "W4A16", "W8A16")
AS_AVG_BITS = 4.5
# calibration rows of 513 tokens: the LM loss reads ids[:, :-1], so the
# model sees 512 positions, where the flash gate (S >= 512, S % 256 == 0)
# takes the attention
AS_SEQ = 513
# the gradient pass's scores through the flash kernels against the same
# pass on the plain attention, per (layer, option) entry, relative: about
# 3x the 5.19e-05 measured on an H100 80GB HBM3 at 700 W (median 1.37e-05)
AS_SCORE_RTOL = 2e-4
# a second budget searched from the same cached scores (no gradient pass):
# at 4.5 bits the plan takes W4 and W8 only, at 3.0 W2 layers too, served
# through row 10
AS_LOW_BITS = 3.0
KIND_OF_BITS = {2: "w2a16_matmul", 4: "w4a16_matmul", 8: "w8a16_matmul"}


@contextlib.contextmanager
def _env(**kv):
    """The environment variables set inside the block, restored after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _served_plan(label, cfg, result, prompts, new, want):
    """The int8-KV engine of a mixed-kind result → ``generate`` with every
    kernel of ``want`` launched → a copy on the plain versions on the card
    → ``generate_scan``; returns (generate's launches, replayed step ms)."""
    from autoround_tpu_torch import QuantizedLlama

    eng = QuantizedLlama.from_quantize_result(result, cfg, max_seq=1024,
                                              kv_quant="int8")
    kinds = {}
    for k in eng.packed_kinds.values():
        kinds[k] = kinds.get(k, 0) + 1
    toks, counts = generate_counted(eng, prompts, new)
    _check_tokens(toks, prompts.shape[0], new, cfg.vocab_size)
    for n in want:
        check(counts[n] > 0, f"{label}: {n} not launched ({counts})")
    log(f"{label}: packed entries by kind {json.dumps(kinds)}, dense "
        f"linears {len(_dense_linears(eng))}; generate kernels "
        f"{json.dumps(counts)}")
    check_copy(eng, prompts, "card", layers=cfg.num_layers)
    graph_ms, _ = scan_path(eng, prompts, toks, counts, label)
    del eng
    torch.cuda.empty_cache()
    return counts, graph_ms


def autoscheme_path(n_layers):
    """(a) ``AutoScheme(avg_bits=4.5, options=W2A16 / W4A16 / W8A16)`` on
    llama3-8b x ``n_layers`` with 8 x 513 calibration tokens: the gradient
    pass (rows 1-3 in the LM loss) timed with its device peak, its scores
    held against the same pass on the plain attention, the plan within the
    budget, RTN of the plan, then the engine serving each layer through its
    kind's kernel; then a 3.0-bit plan from the cached scores, with W2A16
    layers served through row 10.  Returns (the search's launches, the
    served launches at 4.5 and at 3.0 bits)."""
    import numpy as np

    from autoround_tpu_torch import AutoRound, AutoScheme
    from autoround_tpu_torch.quantize import auto_scheme as tas

    cfg, params = _llama8b(n_layers, 84)
    gen = torch.Generator().manual_seed(85)
    calib = torch.randint(0, cfg.vocab_size, (8, AS_SEQ), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    ws = tempfile.mkdtemp()
    scheme = AutoScheme(avg_bits=AS_AVG_BITS, options=AS_OPTIONS,
                        enable_cache=True)
    try:
        with _env(AR_WORK_SPACE=ws):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_gb = torch.cuda.memory_allocated() / 1e9
            c0 = launch_counts()
            t0 = time.time()
            ar = AutoRound((params, cfg), scheme=scheme, iters=0)
            plan = tas.gen_auto_scheme(ar.params, cfg, scheme, calib)
            torch.cuda.synchronize()
            search_s = time.time() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            c1 = launch_counts()
            t0 = time.time()
            result = ar.quantize(calib)      # reads the cached scores
            torch.cuda.synchronize()
            quant_s = time.time() - t0
            (path,) = list(Path(ws).rglob("*.npz"))
            z = np.load(path)
            scores, bits_cost, nparams = z["scores"], z["bits_cost"], \
                z["nparams"]
        grad = {n: c1[n] - c0[n] for n in c0}
        for n in ("flash_attention", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            check(grad[n] > 0, f"autoscheme: {n} not launched in the "
                  f"gradient pass ({grad})")
        check({k: v.key() for k, v in ar.layer_schemes.items()}
              == {k: v.key() for k, v in plan.items()},
              "autoscheme: AutoRound's plan differs from the search's")
        names = list(plan)
        opts = [tas.parse_scheme(o) for o in AS_OPTIONS]
        with counts_kept(), plain_versions():
            t0 = time.time()
            ps, pb, _ = tas._score_matrices(
                params, cfg, scheme, calib.cuda(), names, opts)
            plain_s = time.time() - t0
        rel = np.abs(ps - scores) / np.abs(ps)
        check(bool((pb == bits_cost).all()), "autoscheme: bits differ")
        check(float(rel.max()) < AS_SCORE_RTOL, f"autoscheme: scores "
              f"through the kernels off the plain attention's by "
              f"{float(rel.max()):.3e} relative")
        used = sum(tas.scheme_storage_bits(s, tuple(
            tas._leaf(params, n).shape)) * nparams[i]
            for i, (n, s) in enumerate(plan.items()))
        achieved = used / nparams.sum()
        check(achieved <= AS_AVG_BITS, f"autoscheme: {achieved:.4f} bits "
              f"over the {AS_AVG_BITS} budget")
        by_bits = {}
        for s in plan.values():
            by_bits[s.bits] = by_bits.get(s.bits, 0) + 1
        log(f"autoscheme llama3-8b ({n_layers} layers, 8 x {AS_SEQ - 1} "
            f"positions, options {AS_OPTIONS}, avg_bits {AS_AVG_BITS}): "
            f"search_s={search_s:.2f} (the gradient pass, the scoring of "
            f"{len(names)} layers x {len(opts)} options and the selector) "
            f"device peak {peak_gb:.2f} GB over {base_gb:.2f} GB of weights;"
            f" plain-attention pass {plain_s:.2f} s; scores through the "
            f"kernels vs the plain attention: max rel {float(rel.max()):.3e}"
            f" median {float(np.median(rel)):.3e}; plan by bits "
            f"{json.dumps(by_bits)}, achieved {achieved:.4f} bits; "
            f"quantize_s={quant_s:.2f} (the cached scores, RTN); gradient "
            f"pass kernels {json.dumps({n: v for n, v in grad.items() if v})}")
        want = [KIND_OF_BITS[b] for b in sorted(by_bits)] + [
            "flash_attention", "decode_attention"]
        served, graph_ms = _served_plan("autoscheme plan", cfg, result,
                                        prompts, 32, want)
        log(f"autoscheme plan: replayed step at batch 8 graph_step_ms="
            f"{graph_ms:.4f}")
        with _env(AR_WORK_SPACE=ws):
            low = AutoRound((params, cfg), scheme=AutoScheme(
                avg_bits=AS_LOW_BITS, options=AS_OPTIONS, enable_cache=True),
                iters=0)
            c0 = launch_counts()
            res_low = low.quantize(calib)
            c1 = launch_counts()
        check(c1["flash_attention_bwd_dq"] == c0["flash_attention_bwd_dq"],
              "autoscheme: the second budget ran a gradient pass")
        low_bits = {}
        for s in low.layer_schemes.values():
            low_bits[s.bits] = low_bits.get(s.bits, 0) + 1
        check(2 in low_bits, f"autoscheme: no W2A16 layer at "
              f"{AS_LOW_BITS} bits ({low_bits})")
        from autoround_tpu_torch import QuantizedLlama
        eng = QuantizedLlama.from_quantize_result(res_low, cfg, max_seq=1024,
                                                  kv_quant="int8")
        toks, served_low = generate_counted(eng, prompts, 32)
        _check_tokens(toks, prompts.shape[0], 32, cfg.vocab_size)
        for b in low_bits:
            check(served_low[KIND_OF_BITS[b]] > 0, f"autoscheme: "
                  f"{KIND_OF_BITS[b]} not launched at {AS_LOW_BITS} bits")
        check_copy(eng, prompts, "card", layers=cfg.num_layers)
        log(f"autoscheme at {AS_LOW_BITS} bits (the cached scores): plan by "
            f"bits {json.dumps(low_bits)}; generate kernels "
            f"{json.dumps({n: v for n, v in served_low.items() if v})}")
        del eng, low, res_low
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    del ar, result, params
    torch.cuda.empty_cache()
    return grad, served, served_low


class _Stop(Exception):
    """Raised by the resume path's hook after a block is saved."""


def resume_path(n_layers, iters=4):
    """(b) SignRound W4A16 on llama3-8b x ``n_layers`` (``iters`` steps,
    8 x 512): an uninterrupted run with ``AR_PROFILE_PHASES``,
    ``AR_TRACE_DIR`` and ``AR_LOG_MEMORY`` set; a run on a resume directory
    stopped by a hook after block 1 is saved, then run again: its restored
    blocks equal to the saved payloads bit for bit, and the whole result
    held against the uninterrupted run (bit-equal, or within the spread of
    two uninterrupted runs).  Logs the durable save's seconds and bytes a
    block.  Returns the resumed run's launches."""
    from autoround_tpu_torch import AutoRound
    from autoround_tpu_torch.utils import resume as rs

    cfg, params = _llama8b(n_layers, 86)
    calib = torch.randint(0, cfg.vocab_size, (8, 512),
                          generator=torch.Generator().manual_seed(87))
    kw = dict(scheme="W4A16", iters=iters, batch_size=8, lr=5e-3, seed=0)
    root = Path(tempfile.mkdtemp())
    logger = logging.getLogger("autoround_tpu_torch")
    level = logger.level
    lines = _LogLines()
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    try:
        with _env(AR_PROFILE_PHASES=1, AR_TRACE_DIR=root / "trace",
                  AR_LOG_MEMORY=1):
            torch.cuda.synchronize()
            t0 = time.time()
            u1 = AutoRound((params, cfg), **kw).quantize(calib)
            torch.cuda.synchronize()
            wall = time.time() - t0
        logger.removeHandler(lines)
        logger.setLevel(level)
        mem = [m for m in lines.lines if m.startswith("memory [block")]
        traces = list((root / "trace").glob("trace_*.json"))
        check(len(traces) == 1, f"resume: trace files {traces}")
        check(len(mem) == n_layers, f"resume: memory lines {mem}")
        prof = u1.profile
        check(set(prof) == {"upload", "fp_ref", "tune", "finalize",
                            "qchain"}, f"resume: profile keys {sorted(prof)}")
        saves = []
        orig = rs.ResumeState.mark_block_done

        def timed(self, i, *a, **k):
            torch.cuda.synchronize()
            t = time.time()
            orig(self, i, *a, **k)
            nbytes = sum(os.path.getsize(os.path.join(self.dir, f))
                         for f in (f"block_{i}.safetensors",
                                   f"chain_{i}.safetensors"))
            saves.append((i, time.time() - t, nbytes))
            if i == 1 and getattr(self, "stop", False):
                raise _Stop(f"stopped after block {i}")
        rs.ResumeState.mark_block_done = timed
        rdir = str(root / "resume")
        try:
            rs.ResumeState.stop = True
            try:
                AutoRound((params, cfg), resume_dir=rdir,
                          **kw).quantize(calib)
                check(False, "resume: the hook did not stop the run")
            except _Stop:
                pass
            rs.ResumeState.stop = False
            with open(os.path.join(rdir, "manifest.json")) as f:
                manifest = json.load(f)
            done = manifest["done"]
            check(done == [0, 1], f"resume: manifest done {done}")
            c0 = launch_counts()
            t0 = time.time()
            res = AutoRound((params, cfg), resume_dir=rdir,
                            **kw).quantize(calib)
            torch.cuda.synchronize()
            resumed_s = time.time() - t0
            c1 = launch_counts()
        finally:
            rs.ResumeState.mark_block_done = orig
            del rs.ResumeState.stop
        launches = {n: c1[n] - c0[n] for n in c0}
        for n in ("flash_attention", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            check(launches[n] > 0, f"resume: {n} not launched")
        check(sorted(res.loss_traces) == list(range(2, n_layers)),
              f"resume: tuned blocks {sorted(res.loss_traces)}")
        state = rs.ResumeState(rdir, manifest["signature"])
        for bi in (0, 1):
            payload = state.load_block(bi, "cuda")
            for lname in ("q_proj", "down_proj"):
                ql = res.layers[f"blocks.{bi}.{lname}"]
                check(torch.equal(ql.qdq, payload[f"{lname}.qdq"])
                      and torch.equal(ql.scale, payload[f"{lname}.scale"]),
                      f"resume: block {bi} {lname} differs from its saved "
                      f"payload")

        def dist(a, b):
            return max(float((a.layers[n].qdq.float()
                              - b.layers[n].qdq.float()).abs().max())
                       for n in a.layers)
        d_res = dist(res, u1)
        spread = None
        if d_res != 0.0:
            u2 = AutoRound((params, cfg), **kw).quantize(calib)
            spread = dist(u2, u1)
            check(d_res <= spread, f"resume: the resumed result is "
                  f"{d_res} from the uninterrupted one, two uninterrupted "
                  f"runs {spread} apart")
            del u2
        per_block = [s for s in saves if s[0] < n_layers]
        log(f"resume llama3-8b ({n_layers} layers, W4A16, {iters} iters, "
            f"8 x 512): uninterrupted wall_s={wall:.2f} (profiler and "
            f"memory monitor on) phase profile {json.dumps({k: round(v, 3) for k, v in prof.items()})} "
            f"sum {sum(prof.values()):.2f} s of it; trace "
            f"{os.path.getsize(traces[0]) / 1e6:.1f} MB; memory lines "
            f"{mem}; durable saves (block, s, bytes) "
            f"{[(i, round(s, 3), b) for i, s, b in per_block]}; resumed run "
            f"(blocks 0-1 from disk) resumed_s={resumed_s:.2f}; max |qdq| "
            f"distance resumed vs uninterrupted {d_res}"
            + ("" if spread is None else
               f", two uninterrupted runs {spread} apart"))
    finally:
        logger.removeHandler(lines)
        logger.setLevel(level)
        shutil.rmtree(root, ignore_errors=True)
    del u1, res, params
    torch.cuda.empty_cache()
    return launches


def _shard_llama_dir(params, cfg, root):
    """A two-shard HF directory of a Llama tree (the embedding and the
    first half of the layers, then the rest, the norm and the head) with
    its index and config; returns its source bytes."""
    from autoround_tpu_torch.utils import hf_loader as th
    from autoround_tpu_torch.utils.safetensors_io import SafeOpen

    n = cfg.num_layers
    half = max(1, n // 2)
    parts = ({"embed_tokens": params["embed_tokens"],
              "blocks": params["blocks"][:half]},
             {"blocks": [{}] * half + params["blocks"][half:],
              "norm": params["norm"], "lm_head": params["lm_head"]})
    wmap = {}
    for k, part in enumerate(parts):
        sub = root / f"part{k}"
        th.save_hf_checkpoint(part, cfg, str(sub))
        name = f"model-0000{k + 1}-of-00002.safetensors"
        os.replace(sub / "model.safetensors", root / name)
        os.replace(sub / "config.json", root / "config.json")
        shutil.rmtree(sub)
        with SafeOpen(str(root / name)) as f:
            wmap.update({key: name for key in f.keys()})
    with open(root / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": wmap}, f)
    return _dir_bytes(root)


def _fp8_v3_dir(root):
    """DeepSeek-V3's dense layer 0 at its published widths as an FP8
    source: each 2-D weight e4m3 with a 128 x 128 ``weight_scale_inv``
    grid (block amax / 448), the norms bf16, two shards and an index.
    Returns ({HF key: (e4m3 weight, grid)} on the host, source bytes)."""
    from autoround_tpu_torch.models import deepseek
    from autoround_tpu_torch.utils import hf_loader as th
    from autoround_tpu_torch.utils.safetensors_io import SafeOpen, save_file

    cfg = dataclasses.replace(deepseek.CONFIG_PRESETS["deepseek-v3"],
                              num_layers=1)
    params = deepseek.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(90), "cuda")
    th.save_hf_checkpoint({"blocks": params["blocks"]}, cfg, str(root))
    del params
    src = root / "model.safetensors"
    shards = ({}, {})
    host = {}
    with SafeOpen(str(src), device="cuda") as f:
        for i, key in enumerate(sorted(f.keys())):
            t = f.get_tensor(key)
            shard = shards[i % 2]
            if t.ndim == 2 and key.endswith(".weight"):
                O, I = t.shape
                w = t.float()
                amax = torch.nn.functional.max_pool2d(
                    w.abs()[None], 128, ceil_mode=True)[0]
                grid = (amax / 448.0).clamp_min(1e-12)
                full = grid.repeat_interleave(128, 0).repeat_interleave(
                    128, 1)[:O, :I]
                w8 = (w / full).to(torch.float8_e4m3fn)
                shard[key] = w8
                shard[key[:-len(".weight")] + ".weight_scale_inv"] = grid
                host[key] = (w8.cpu(), grid.cpu())
            else:
                shard[key] = t
    os.remove(src)
    wmap = {}
    for k, shard in enumerate(shards):
        name = f"model-0000{k + 1}-of-00002.safetensors"
        save_file(shard, str(root / name))
        wmap.update({key: name for key in shard})
    with open(root / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": wmap}, f)
    return host, _dir_bytes(root)


def model_free_path(n_layers):
    """(c) ``model_free_quantize`` on the card: a llama3-8b x ``n_layers``
    bf16 directory in two shards, each packed layer unpacked on the card
    against ``rtn_quantize_layer`` of the same tensor there; then
    DeepSeek-V3's dense layer 0 at full width as an FP8 source (e4m3, 128
    x 128 scale grids) through model-free and through
    ``load_hf_checkpoint``, the dequantized weights against the host
    product of the e4m3 values and the grid.  Logs GB/s."""
    from autoround_tpu_torch.algorithms.rtn import rtn_quantize_layer
    from autoround_tpu_torch.export.packing import (codes_from_qdq_torch,
                                                    unpack_quantized_torch)
    from autoround_tpu_torch.quantize.model_free import model_free_quantize
    from autoround_tpu_torch.schemes import parse_scheme
    from autoround_tpu_torch.utils import hf_loader as th
    from autoround_tpu_torch.utils.safetensors_io import SafeOpen

    root = Path(tempfile.mkdtemp())
    scheme = parse_scheme("W4A16")
    try:
        cfg, params = _llama8b(n_layers, 88)
        src = root / "llama"
        src.mkdir()
        src_bytes = _shard_llama_dir(params, cfg, src)
        torch.cuda.synchronize()
        t0 = time.time()
        model_free_quantize(str(src), str(root / "llama_q"), scheme="W4A16")
        torch.cuda.synchronize()
        mf_s = time.time() - t0
        out_bytes = _dir_bytes(root / "llama_q")
        q = json.loads((root / "llama_q" / "quantization_config.json")
                       .read_text())["quantized_layers"]
        check(len(q) == 7 * n_layers, f"model-free: {len(q)} layers")
        idx = json.loads((root / "llama_q" / "model.safetensors.index.json")
                         .read_text())["weight_map"]
        inv = {v: k for k, v in th._BLOCK_MAP.items()}
        for li in range(n_layers):
            for lname in ("q_proj", "k_proj", "gate_proj", "down_proj"):
                base = f"model.layers.{li}.{inv[lname][:-len('.weight')]}"
                w = params["blocks"][li][lname]
                r = rtn_quantize_layer(w.float(), scheme)
                want = codes_from_qdq_torch(r.qdq.float(), r.scale.float(),
                                            None, 4, 128)
                with SafeOpen(str(root / "llama_q" / idx[base + ".qweight"]),
                              device="cuda") as f:
                    payload = {k: f.get_tensor(f"{base}.{k}")
                               for k in ("qweight", "qzeros", "scales")}
                codes, scales, _ = unpack_quantized_torch(
                    payload, 4, *w.shape)
                check(torch.equal(codes, want)
                      and torch.equal(scales,
                                      r.scale.float().half().float()),
                      f"model-free: {base} differs from the RTN of its "
                      f"tensor on the card")
        del params
        torch.cuda.empty_cache()
        v3 = root / "v3"
        v3.mkdir()
        host, v3_bytes = _fp8_v3_dir(v3)
        torch.cuda.synchronize()
        t0 = time.time()
        model_free_quantize(str(v3), str(root / "v3_q"), scheme="W4A16")
        torch.cuda.synchronize()
        v3_mf_s = time.time() - t0
        idx = json.loads((root / "v3_q" / "model.safetensors.index.json")
                         .read_text())["weight_map"]
        check(not any(k.endswith("_scale_inv") for k in idx),
              "model-free: an FP8 scale was copied, not consumed")
        t0 = time.time()
        lp, lcfg = th.load_hf_checkpoint(str(v3))
        torch.cuda.synchronize()
        load_s = time.time() - t0
        worst = 0
        for key, (w8, grid) in host.items():
            O, I = w8.shape
            full = grid.repeat_interleave(128, 0).repeat_interleave(
                128, 1)[:O, :I]
            want = (w8.float() * full).to(torch.bfloat16)
            got = lp["blocks"][0][th._DS_MAP[key.split("layers.0.", 1)[1]]]
            check(torch.equal(got.cpu(), want), f"fp8 source: {key} loaded "
                  f"differs from the host product")
            worst = max(worst, O * I)
        base = "model.layers.0.self_attn.o_proj"
        w8, grid = host[base + ".weight"]
        O, I = w8.shape
        deq = (w8.float() * grid.repeat_interleave(128, 0)
               .repeat_interleave(128, 1)[:O, :I]).cuda()
        r = rtn_quantize_layer(deq, scheme)
        want = codes_from_qdq_torch(r.qdq.float(), r.scale.float(), None, 4,
                                    128)
        with SafeOpen(str(root / "v3_q" / idx[base + ".qweight"]),
                      device="cuda") as f:
            payload = {k: f.get_tensor(f"{base}.{k}")
                       for k in ("qweight", "qzeros", "scales")}
        codes, _, _ = unpack_quantized_torch(payload, 4, O, I)
        check(torch.equal(codes, want), "model-free: the FP8 o_proj's codes "
              "differ from the RTN of its dequantized weight")
        log(f"model-free llama3-8b ({n_layers} layers, 2 shards, "
            f"{src_bytes / 1e9:.2f} GB bf16): model_free_s={mf_s:.2f} "
            f"({src_bytes / 1e9 / mf_s:.2f} GB/s of source, "
            f"{out_bytes / 1e9:.2f} GB written, warm page cache); "
            f"deepseek-v3 layer 0 FP8 source ({v3_bytes / 1e9:.2f} GB, "
            f"{len(host)} e4m3 weights with 128 x 128 grids, the largest "
            f"{worst / 1e6:.1f} M values): model_free_s={v3_mf_s:.2f} "
            f"({v3_bytes / 1e9 / v3_mf_s:.2f} GB/s), load_hf_checkpoint_s="
            f"{load_s:.2f} ({v3_bytes / 1e9 / load_s:.2f} GB/s), every "
            f"dequantized weight equal to the host product")
        del lp, host
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def writers_path(n_layers):
    """(d) RTN W4A16 g128 with the lm_head on llama3-8b x ``n_layers``,
    written as ``gptq``, ``awq``, ``llm_compressor`` and ``mlx``: each
    file's layers read and unpacked on the card equal the result's codes
    and (fp16) scales.  Logs seconds and bytes a format."""
    from autoround_tpu_torch import AutoRound
    from autoround_tpu_torch.export import formats, mlx, save_quantized
    from autoround_tpu_torch.export.packing import codes_from_qdq_torch
    from autoround_tpu_torch.utils.safetensors_io import SafeOpen

    cfg, params = _llama8b(n_layers, 89)
    calib = torch.randint(0, cfg.vocab_size, (8, 512),
                          generator=torch.Generator().manual_seed(89))
    ar = AutoRound((params, cfg), scheme="W4A16", iters=0,
                   quant_lm_head=True, donate_params=True)
    del params
    result = ar.quantize(calib)
    root = Path(tempfile.mkdtemp())
    stats = {}
    try:
        for fmt in ("gptq", "awq", "llm_compressor", "mlx"):
            d = root / fmt
            torch.cuda.synchronize()
            t0 = time.time()
            save_quantized(result, cfg, str(d), fmt)
            secs = time.time() - t0
            dev = "cpu" if fmt == "mlx" else "cuda"
            with SafeOpen(str(d / "model.safetensors"), device=dev) as f:
                for name, ql in result.layers.items():
                    O, I = ql.qdq.shape
                    want = codes_from_qdq_torch(ql.qdq, ql.scale, None, 4,
                                                128)
                    s16 = ql.scale.float().half().float()
                    if fmt == "mlx":
                        hf = mlx._hf_name(name)
                        words = f.get_tensor(f"{hf}.weight").view(
                            torch.int32).cuda()
                        codes = mlx.unpack_mlx_weight(words, 4, I)
                        scale = f.get_tensor(f"{hf}.scales").cuda().float()
                        bias = f.get_tensor(f"{hf}.biases").cuda()
                        zp_ok = torch.equal(
                            bias, (-ql.scale.float() * 8.0).half())
                    else:
                        keys = [k for k in f.keys()
                                if k.startswith(name + ".")]
                        t = {k[len(name) + 1:]: f.get_tensor(k)
                             for k in keys}
                        if fmt == "gptq":
                            codes, scale, zp = formats.gptq_unpack_layer(
                                t, 4, O, I)
                        elif fmt == "awq":
                            codes, scale, zp = formats.awq_unpack_layer(
                                t, O, I)
                        else:
                            codes, scale, zp = formats.ct_unpack_layer(t, 4)
                        zp_ok = zp is None or bool((zp == 8).all())
                    check(torch.equal(codes.to(want.dtype), want)
                          and torch.equal(scale, s16) and zp_ok,
                          f"writers: {fmt} {name} read back differs from "
                          f"the result")
            stats[fmt] = (round(secs, 2), _dir_bytes(d))
        log(f"writers llama3-8b ({n_layers} layers + lm_head, W4A16 g128 "
            f"RTN): (seconds to write, bytes) by format {json.dumps(stats)};"
            f" every layer read back and unpacked on the card equal to the "
            f"result's codes and fp16 scales")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del ar, result
    torch.cuda.empty_cache()


def driver_formats_phase(as_layers, resume_layers, mf_layers,
                         writers_layers):
    """Queue A item 6b and the gptq / awq / llm_compressor / mlx writers:
    paths (a)-(d) above; returns their launches."""
    t0 = time.time()
    out = {}
    (out["autoscheme_grad"], out["autoscheme_serve"],
     out["autoscheme_low_serve"]) = autoscheme_path(as_layers)
    free_device_memory()
    t1 = time.time()
    out["resume"] = resume_path(resume_layers)
    free_device_memory()
    t2 = time.time()
    model_free_path(mf_layers)
    free_device_memory()
    t3 = time.time()
    writers_path(writers_layers)
    free_device_memory()
    log(f"driver utilities / formats phase: autoscheme_s={t1 - t0:.1f} "
        f"resume_s={t2 - t1:.1f} model_free_s={t3 - t2:.1f} writers_s="
        f"{time.time() - t3:.1f} phase_s={time.time() - t0:.1f}")
    return out


def _tensors(tree):
    out = []
    from autoround_tpu_torch.utils.pytree import tree_map
    tree_map(out.append, tree)
    return out


GEMM_SOURCES = ("w4a16_matmul", "w4a16_matmul_grouped", "w4a16_asym_matmul",
                "w8a16_matmul", "w2a16_matmul", "fp8_matmul", "mxfp4_matmul")


def _kernel_name(mangled: str) -> str:
    """`gemm_kernel<0>` for the mangled name of a kernel (template
    instance): the last of its length-prefixed names, then its integer
    template arguments."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.match(r"I((?:L[ij]\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ",".join(re.findall(r"L[ij](\d+)E", args[1])) + ">"
    return name


def build_report(build):
    """The compiler's register and spill lines of every kernel, by function,
    then the flash forward's and backward pair's, the GEMM bodies' and the
    decode kernels' registers, spill bytes, dynamic shared memory and
    resident blocks per SM as the runtime reports them."""
    import ctypes

    for p in sorted(build.BUILD_DIR.glob("*.log")):
        fn = "?"
        for line in p.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = _kernel_name(m[1])
            elif ("registers" in line or "spill stores" in line
                  or "warning" in line):
                log(f"  {p.stem.split('-')[0]} {fn}: {line.strip()}")
    info = (ctypes.c_int * 8)()
    entries = [("flash_attention", f"D={D}", D) for D in (128, 256)]
    entries += [(src, "gemm body", None)
                for src in GEMM_SOURCES + ("w8a8_matmul", "w4a8_matmul")]
    entries.append(("w4a8_matmul", "gemm body g != 128", "any"))
    for src, what, arg in entries:
        if arg is None or arg == "any":
            fn = getattr(build.load(src),
                         f"{src}_gemm_{'any_' if arg else ''}info")
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            build.check(fn(info), f"{src}_gemm_info")
        else:
            fn = build.load(src).flash_attention_fwd_info
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            build.check(fn(arg, info), "flash_attention_fwd_info")
        log(f"  resources {src} {what}: {info[0]} registers, {info[1]} "
            f"spill bytes, {info[2]} bytes of dynamic shared memory, "
            f"{info[3]} blocks per SM")
    fn = build.load("flash_attention_bwd").flash_attention_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for D in (128, 256):
        for which, what in enumerate(("dQ", "dK/dV")):
            build.check(fn(D, which, info), "flash_attention_bwd_info")
            log(f"  resources flash_attention_bwd {what} D={D}: {info[0]} "
                f"registers, {info[1]} spill bytes, {info[2]} bytes of "
                f"dynamic shared memory, {info[3]} blocks per SM")
    # the A16 GEMV (M <= 32) of each format, per n-tile tier (M 8, 16,
    # 32), with its plan (rw row tiles a block, K split over a cluster of
    # kc blocks) at the main path's shapes
    shapes = {"w4a16_matmul_grouped": (("w1", 8, 4096, 14336),
                                       ("w2", 8, 14336, 4096))}
    llama = (("qkv", 1, 4096, 6144), ("down", 1, 14336, 4096),
             ("lm_head", 1, 4096, 128256))
    for src in GEMM_SOURCES:
        fn = getattr(build.load(src), f"{src}_gemv_info")
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        for M in (8, 16, 32):
            plans = []
            for name, E, K, O in shapes.get(src, llama):
                build.check(fn(E, M, K, O, info), f"{src}_gemv_info")
                plans.append(f"{name} rw={info[4]} kc={info[5]}")
            log(f"  resources {src} gemv M<={M}: {info[0]} registers, "
                f"{info[1]} spill bytes, {info[2]} bytes of dynamic shared "
                f"memory, {info[3]} blocks per SM (at the last plan's "
                f"block); plan {', '.join(plans)}")
    # the int8 GEMV (M <= 32) of W8A8 and W4A8 (g = 128) per n-tile tier,
    # with its plan at the decode launches of llama3-8b
    llama8 = llama + (("o_proj", 1, 4096, 4096), ("gate_up", 1, 4096, 28672))
    for src in ("w8a8_matmul", "w4a8_matmul"):
        for M in (1, 8, 16, 32):
            plans = []
            for name, _, K, O in llama8:
                info = a8_gemv_info(src, M, K, O)
                plans.append(f"{name} rw={info[4]} kc={info[5]}")
            log(f"  resources {src} gemv M<={M}: {info[0]} registers, "
                f"{info[1]} spill bytes, {info[2]} bytes of dynamic shared "
                f"memory, {info[3]} blocks per SM (at the last plan's "
                f"block); plan {', '.join(plans)}")
    info = (ctypes.c_int * 8)()
    fn = build.load("sage_attention").sage_attention_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for D in (128, 256):
        for which, what in enumerate(("attention", "key pre-pass")):
            build.check(fn(D, which, info), "sage_attention_info")
            log(f"  resources sage_attention {what} D={D}: {info[0]} "
                f"registers, {info[1]} spill bytes, {info[2]} bytes of "
                f"dynamic shared memory, {info[3]} blocks per SM")
    fn = build.load("decode_attention").decode_attention_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for hd, G in ((128, 4), (128, 7), (64, 4), (256, 4), (256, 8),
                  (64, 12), (128, 12), (256, 12), (64, 16), (128, 16),
                  (256, 16)):
        build.check(fn(hd, G, info), "decode_attention_info")
        for what, i in (("split", 0), ("combine", 4)):
            log(f"  resources decode_attention {what} hd={hd} G={G}: "
                f"{info[i]} registers, {info[i + 1]} spill bytes, "
                f"{info[i + 2]} bytes of dynamic shared memory, "
                f"{info[i + 3]} blocks per SM")


def free_device_memory():
    """Between phases: the moe path peaks at 72 of the card's 80 GB, and
    tensors kept alive by a reference cycle of the phase before (seen once:
    22 GB, until a collection happened to run) would push it over."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rtn-layers", type=int, default=32,
                    help="depth of the RTN -> serve path (default 32)")
    # the run's time limit is 1200 s: the defaults below 32 layers of the
    # tune, moe, W4A8, W8A8, FP8, MXFP4, qwen2.5-7b and deepseek-v2-lite
    # paths were cut for time when the whole run reached 936-1065 s on an
    # H100, those of the load, deepseek-v2-lite, gpt-oss-20b,
    # llama4-scout and qwen3.5 load paths when the qwen3-next phase (267
    # s) came, and those of the sage (32 -> 8) and qwen3-next (8 -> 4)
    # paths when the glm phase (113 s) came, and those of the offload (32
    # -> 8; MiniMax and LongCat hold offload at 45 and 40 GB) and
    # gpt-oss-20b (8 -> 4) paths when the ernie / longcat / step35 phase
    # came, and those of the gpt-oss-120b and glm-4.5-air paths (4 -> 2)
    # when the qwen3-next tune took its DeltaNet layer back, and those of
    # the W4A8, W8A8, FP8_STATIC, MXFP4 (8 -> 4) and qwen2.5-7b (8 -> 4)
    # paths when the gguf / rotation phase came, and those of the
    # llama3.2-1b (16 -> 8) and offload (8 -> 4) paths when the driver
    # utilities / formats phase came (the rtn path keeps the main path's
    # full depth)
    ap.add_argument("--tune-layers", type=int, default=8,
                    help="depth of the SignRound -> serve path (default 8)")
    ap.add_argument("--moe-layers", type=int, default=8,
                    help="depth of the Mixtral RTN -> serve path (default "
                         "8 of 32; at most 17: the bf16 blocks must fit the "
                         "card beside their packed copies)")
    ap.add_argument("--moe-tune-layers", type=int, default=2,
                    help="depth of the Mixtral SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--asym-layers", type=int, default=4,
                    help="depth of the int4 asym -> serve path (default 4)")
    ap.add_argument("--a8-layers", type=int, default=4,
                    help="depth of the W4A8 -> serve path (default 4)")
    ap.add_argument("--w8a8-layers", type=int, default=4,
                    help="depth of the W8A8 -> serve path (default 4)")
    ap.add_argument("--w8a16-layers", type=int, default=4,
                    help="depth of the W8A16 -> serve path (default 4)")
    ap.add_argument("--a8-modes-layers", type=int, default=4,
                    help="depth of the W4A16 result served with serve_a8 and "
                         "prefill_a8 (default 4)")
    ap.add_argument("--a8-tune-layers", type=int, default=2,
                    help="depth of the W4A8 SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--fp8-layers", type=int, default=4,
                    help="depth of the FP8_STATIC -> serve path (default 4)")
    ap.add_argument("--mxfp4-layers", type=int, default=4,
                    help="depth of the MXFP4 -> serve path (default 4)")
    ap.add_argument("--nvfp4-layers", type=int, default=4,
                    help="depth of the NVFP4 -> serve path (default 4)")
    ap.add_argument("--w2-layers", type=int, default=4,
                    help="depth of the W2A16 -> serve path (default 4)")
    ap.add_argument("--mx-tune-layers", type=int, default=2,
                    help="depth of the MXFP4 SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--llama1b-layers", type=int, default=8,
                    help="depth of the two llama3.2-1b paths (W4A16 g128 "
                         "and g16; default 8 of 16)")
    ap.add_argument("--sage-layers", type=int, default=8,
                    help="layers of prefill attention on the int8-QK path "
                         "(default 8)")
    ap.add_argument("--qwen25-layers", type=int, default=4,
                    help="depth of the qwen2.5-7b RTN -> serve path "
                         "(default 4 of 28)")
    ap.add_argument("--qwen3-tune-layers", type=int, default=2,
                    help="depth of the qwen3-4b SignRound -> serve path "
                         "(default 2)")
    ap.add_argument("--gemma2-layers", type=int, default=4,
                    help="depth of the gemma2-2b RTN -> serve path "
                         "(default 4)")
    ap.add_argument("--gemma3-layers", type=int, default=6,
                    help="depth of the gemma3-12b RTN -> serve path "
                         "(default 6: five sliding layers and one global)")
    ap.add_argument("--options-layers", type=int, default=2,
                    help="depth of the alg_ext, Adam + norm/bias and LM-loss "
                         "paths of the options phase (default 2)")
    ap.add_argument("--nblocks-layers", type=int, default=4,
                    help="depth of the nblocks=2 path (default 4: two "
                         "groups)")
    ap.add_argument("--offload-layers", type=int, default=4,
                    help="depth of the Mixtral-8x7b offload path (default "
                         "4; a larger depth is cut to what the host holds, "
                         "at least 28)")
    ap.add_argument("--load-layers", type=int, default=2,
                    help="depth of the llama3-8b HF checkpoint of the load "
                         "phase (default 2)")
    ap.add_argument("--deepseek-layers", type=int, default=4,
                    help="depth of the deepseek-v2-lite RTN -> serve path "
                         "(default 4 of 27; at least 2)")
    ap.add_argument("--deepseek-v3-layers", type=int, default=4,
                    help="depth of the deepseek-v3 RTN -> serve path "
                         "(default 4 of 61: the 3 dense blocks and the "
                         "first MoE block)")
    ap.add_argument("--gptoss-layers", type=int, default=4,
                    help="depth of the gpt-oss-20b RTN -> serve path "
                         "(default 4 of 24)")
    ap.add_argument("--gptoss120-layers", type=int, default=2,
                    help="depth of the gpt-oss-120b RTN -> serve path "
                         "(default 2 of 36: a sliding and a full layer)")
    ap.add_argument("--llama4-layers", type=int, default=4,
                    help="depth of the llama4-scout RTN -> serve path "
                         "(default 4 of 48: NoPE layer 3; at least 4, "
                         "the chunk path's)")
    ap.add_argument("--qwen3next-layers", type=int, default=4,
                    help="depth of the qwen3-next RTN -> serve path "
                         "(default 4 of 48: layer 3 full attention; at "
                         "least 4, the copy holds layers 2-3)")
    ap.add_argument("--glm45-layers", type=int, default=2,
                    help="depth of the glm-4.5-air RTN -> serve path "
                         "(default 2 of 46: the dense layer 0 and a "
                         "128-expert layer; at least 2)")
    ap.add_argument("--glm5-layers", type=int, default=4,
                    help="depth of the GLM-5 DSA RTN -> serve path at the "
                         "deepseek-v3 widths (default 4 of 61: the 3 dense "
                         "blocks and the first MoE block)")
    ap.add_argument("--minimax-layers", type=int, default=4,
                    help="depth of the minimax-text-01 RTN (host offload) "
                         "-> serve path (default 4 of 80: the published "
                         "layers 4-7, three lightning and the first full "
                         "one; at least 4, the copy holds layers 2-3)")
    ap.add_argument("--ernie-layers", type=int, default=4,
                    help="depth of the ernie4.5-21b-a3b RTN -> export path "
                         "(default 4 of 28: the dense layer 0 and three "
                         "64-expert layers; at least 2)")
    ap.add_argument("--longcat-layers", type=int, default=1,
                    help="depth of the longcat-flash RTN (host offload) "
                         "path (default 1 of 28: 40 GB of bf16 a layer)")
    ap.add_argument("--step35-layers", type=int, default=4,
                    help="depth of the step-3.5-flash RTN -> export path "
                         "(default 4 of 45: full layer 0, sliding layers "
                         "1-3, the MoE layer 3; at least 4)")
    ap.add_argument("--gguf-layers", type=int, default=4,
                    help="depth of the llama3-8b GGUF:Q4_K_M RTN -> serve "
                         "path (default 4)")
    ap.add_argument("--gguf-tune-layers", type=int, default=2,
                    help="depth of the GGUF:Q4_K_S SignRound path "
                         "(default 2)")
    ap.add_argument("--gguf-small-layers", type=int, default=1,
                    help="depth of the GGUF:Q3_K_S and GGUF:Q2_K_S paths "
                         "(default 1)")
    ap.add_argument("--gguf-moe-layers", type=int, default=1,
                    help="depth of the mixtral-8x7b GGUF:Q2_K_MIXED path "
                         "(default 1)")
    ap.add_argument("--rotation-layers", type=int, default=2,
                    help="depth of the r1 + r4 + AWQ and the SpinQuant "
                         "paths (default 2)")
    ap.add_argument("--autoscheme-layers", type=int, default=2,
                    help="depth of the llama3-8b AutoScheme -> serve path "
                         "(default 2)")
    ap.add_argument("--resume-layers", type=int, default=3,
                    help="depth of the llama3-8b SignRound crash-resume "
                         "path (default 3; at least 3: the stop comes "
                         "after block 1)")
    ap.add_argument("--model-free-layers", type=int, default=2,
                    help="depth of the llama3-8b model-free directory "
                         "(default 2)")
    ap.add_argument("--writers-layers", type=int, default=2,
                    help="depth of the llama3-8b result the gptq / awq / "
                         "llm_compressor / mlx writers write (default 2)")
    ap.add_argument("--qwen35-load-layers", type=int, default=2,
                    help="depth of the qwen3_5_moe HF directory of the "
                         "load path (default 2: the published layers 2-3, "
                         "a DeltaNet and a full one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (HERE / "autoround_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {HERE} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from autoround_tpu_torch._device import resolve_device
    from autoround_tpu_torch.ops import _build

    resolve_device(None)   # the card; switches TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name}")

    t_run = time.time()

    def mark(phase):
        log(f"phase {phase} ended at run_s={time.time() - t_run:.1f}")

    t0 = time.time()
    secs = _build.build_all()
    log(f"build_s={time.time() - t0:.2f} per source {json.dumps(secs)}")
    build_report(_build)

    bw, fl, i8 = peaks(name)
    timer = Timer()
    rows = kernel_phase(timer, bw, fl)
    rows.update(decode_kernel_phase(timer, bw, fl))
    rows.update(a8_kernel_phase(timer, bw, fl, i8))
    rows.update(float_kernel_phase(timer, bw, fl))
    rows.update(sage_kernel_phase(timer, bw, fl, i8))
    del timer
    mark("kernels")
    rtn_launches, _ = rtn_path(bw, fl, args.rtn_layers)
    free_device_memory()
    mark("rtn, scan, fp8 kv, batching")
    tuning_step_phase(bw, fl)
    free_device_memory()
    launches, _ = tune_path(args.tune_layers)
    free_device_memory()
    mark("grads, tune")
    moe_launches = moe_path(bw, fl, args.moe_layers)
    free_device_memory()
    moe_tuning_step(bw, fl)
    free_device_memory()
    moe_tune_path(args.moe_tune_layers)
    free_device_memory()
    mark("moe, moe tune")
    asym_launches = asym_path(args.asym_layers)
    free_device_memory()
    a8_launches, _ = serve_path(bw, fl, i8, "W4A8", args.a8_layers,
                                seed=8)
    free_device_memory()
    w8a8_launches, _ = serve_path(bw, fl, i8, "W8A8", args.w8a8_layers,
                                  seed=9)
    free_device_memory()
    w8a16_launches, _ = serve_path(bw, fl, i8, "W8A16",
                                   args.w8a16_layers, seed=10)
    free_device_memory()
    modes_launches = a8_modes_path(args.a8_modes_layers)
    free_device_memory()
    a8_tune_path(args.a8_tune_layers)
    free_device_memory()
    mark("asym, a8, a8 modes, a8 tune")
    fp8_launches, fp8_gb = serve_path(bw, fl, i8, "FP8_STATIC",
                                      args.fp8_layers, seed=13)
    free_device_memory()
    mxfp4_launches, mxfp4_gb = serve_path(bw, fl, i8, "MXFP4",
                                          args.mxfp4_layers, seed=14)
    log(f"peak memory: MXFP4 path {mxfp4_gb:.2f} GB, FP8_STATIC path "
        f"{fp8_gb:.2f} GB ({args.mxfp4_layers} / {args.fp8_layers} layers)")
    if args.mxfp4_layers == args.fp8_layers:
        check(mxfp4_gb <= fp8_gb, "the MXFP4 path peaks above the FP8 path")
    free_device_memory()
    nvfp4_launches, _ = serve_path(bw, fl, i8, "NVFP4",
                                   args.nvfp4_layers, seed=15)
    free_device_memory()
    w2_launches, _ = serve_path(bw, fl, i8, "W2A16", args.w2_layers,
                                seed=16)
    free_device_memory()
    mx_tune_launches = mx_tune_path(bw, fl, args.mx_tune_layers)
    free_device_memory()
    mark("float, mx tune")
    l1b_launches, l1b_kept = llama1b_path(bw, fl, args.llama1b_layers, 128,
                                          seed=19, keep=True)
    free_device_memory()
    l1b_g16_launches, _ = llama1b_path(bw, fl, args.llama1b_layers, 16,
                                       seed=20)
    free_device_memory()
    sage_launches = sage_path(args.sage_layers)
    mark("llama3.2-1b, sage")
    fam = {}
    for preset, n_layers, seed, iters in (
            ("qwen2.5-7b", args.qwen25_layers, 23, 0),
            ("qwen3-4b", args.qwen3_tune_layers, 24, 20),
            ("gemma2-2b", args.gemma2_layers, 25, 0),
            ("gemma3-12b", args.gemma3_layers, 26, 0)):
        fam[preset] = family_path(bw, fl, preset, n_layers, seed, iters)
        free_device_memory()
    mark("llama family")
    loads = load_phase(bw, fl, args.load_layers, l1b_kept)
    del l1b_kept
    free_device_memory()
    mark("load")
    opts = options_phase(bw, fl, args.options_layers, args.nblocks_layers)
    free_device_memory()
    mark("options")
    off_launches = offload_phase(bw, fl, args.offload_layers)
    free_device_memory()
    mark("offload")
    ds = deepseek_phase(bw, fl, args.deepseek_layers,
                        args.deepseek_v3_layers)
    mark("deepseek")
    oss = oss_llama4_phase(bw, fl, args.gptoss_layers, args.gptoss120_layers,
                           args.llama4_layers)
    mark("gpt-oss / llama4")
    oss.update(qwen3next_phase(bw, fl, args.qwen3next_layers,
                               args.qwen35_load_layers))
    mark("qwen3-next")
    oss.update(glm_phase(bw, fl, args.glm45_layers, args.glm5_layers))
    mark("glm")
    oss.update(minimax_phase(bw, fl, args.minimax_layers))
    mark("minimax")
    oss.update(ernie_longcat_step35_phase(args.ernie_layers,
                                          args.longcat_layers,
                                          args.step35_layers))
    mark("ernie / longcat / step35")
    oss.update(gguf_rotation_phase(args.gguf_layers, args.gguf_tune_layers,
                                   args.gguf_small_layers,
                                   args.gguf_moe_layers,
                                   args.rotation_layers))
    mark("gguf / rotation")
    oss.update(driver_formats_phase(args.autoscheme_layers,
                                    args.resume_layers,
                                    args.model_free_layers,
                                    args.writers_layers))
    mark("driver utilities / formats")
    # each kernel's count on the path that is its own: the Llama tune path
    # runs the first five, the moe path the grouped one, the asym path and
    # the three 8-bit paths their kernels; the counts of the other paths
    # ride along where not zero
    launches["w4a16_matmul_grouped"] = moe_launches["w4a16_matmul_grouped"]
    launches["w4a16_asym_matmul"] = asym_launches["w4a16_asym_matmul"]
    launches["w4a8_matmul"] = a8_launches["w4a8_matmul"]
    launches["w8a8_matmul"] = w8a8_launches["w8a8_matmul"]
    launches["w8a16_matmul"] = w8a16_launches["w8a16_matmul"]
    launches["fp8_matmul"] = fp8_launches["fp8_matmul"]
    launches["mxfp4_matmul"] = mxfp4_launches["mxfp4_matmul"]
    launches["w2a16_matmul"] = w2_launches["w2a16_matmul"]
    launches["sage_attention"] = sage_launches["sage_attention"]
    for n, row in rows.items():
        row["launches"] = launches[n]
        for key, other in (("launches_rtn_path", rtn_launches),
                           ("launches_moe_path", moe_launches),
                           ("launches_asym_path", asym_launches),
                           ("launches_a8_modes_path", modes_launches),
                           ("launches_nvfp4_path", nvfp4_launches),
                           ("launches_mx_tune_path", mx_tune_launches),
                           ("launches_llama1b_path", l1b_launches),
                           ("launches_llama1b_g16_path", l1b_g16_launches),
                           ("launches_qwen2.5-7b_path", fam["qwen2.5-7b"]),
                           ("launches_qwen3-4b_tune_path", fam["qwen3-4b"]),
                           ("launches_gemma2-2b_path", fam["gemma2-2b"]),
                           ("launches_gemma3-12b_path", fam["gemma3-12b"]),
                           ("launches_load_path", loads["load"]),
                           ("launches_load_llama1b_path",
                            loads["load_llama1b"]),
                           ("launches_load_gptq_path", loads["load_gptq"]),
                           ("launches_load_awq_path", loads["load_awq"]),
                           ("launches_options_alg_ext_path",
                            opts["alg_ext"]),
                           ("launches_options_adam_nb_path",
                            opts["adam_nb"]),
                           ("launches_options_nblocks_path",
                            opts["nblocks"]),
                           ("launches_options_lfq_path", opts["lfq"]),
                           ("launches_offload_path", off_launches),
                           ("launches_deepseek_v2_lite_path", ds["v2lite"]),
                           ("launches_deepseek_v3_path", ds["v3"])) + tuple(
                (f"launches_{k}_path", v) for k, v in oss.items()):
            if other[n] and other[n] != row["launches"]:
                row[key] = other[n]
    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
