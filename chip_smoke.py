#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``microscopiq_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and this checkout. It
exits non-zero, printing no result, when no CUDA device is present or when
the package is missing. Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``) and the device count;
2. build the nine CUDA sources of ``microscopiq_tpu_torch/ops/cuda/csrc``
   (the GEMV and GEMM with a decode per transport, the W8A8 GEMV, the block
   quantizer, the quantized-KV attention, the NB and side-band GEMV and
   GEMM, the prefill-GEMM and the decode-GEMV experiments), one ``nvcc``
   each, all at once; then ``build_sm90``: the registers and spills of the
   pf6, pf4, sb4, sb2, fp16-container, emi8/emi8m, int8-container, float8,
   side-band and compact-NB GEMMs on the wgmma + TMA mainloop (``csrc/gemm_sm90.cuh``, every
   compiled block and slot class) and the shared memory of their rings;
3. the GEMV and GEMM against their plain PyTorch version at every shape of
   Llama-3-8B (qkv, o, gate_up, down, lm_head): the GEMV at M = 1, 8, 64 and
   the GEMM at M = 128, 1024, with CUDA-event times beside the bound, the
   plain version's time and ``torch.matmul`` on the dense bf16 weight;
4. the main path: Llama-3-8B architecture at full width and 32 layers,
   seeded random weights packed on the card (MX-FP6 emi8, block 32, lm_head
   included, fused projections), a ``last_only`` prefill of 8 x 128 tokens
   and 32 greedy decode steps, the first eager and the rest replayed from a
   CUDA graph (``DecodeStep``, as ``generate`` runs them), held bit for
   bit (tokens, last logits, launches) to an eager run of the same prompt
   (``graph_vs_eager``, one line per dense arm of every main path), with
   launch counts held to what the path implies (the captured step's counts
   times the replays); a dense bf16 arm at the same depth for the ratio;
   ``decode_profile``: the device-busy share of the replayed steps; and a
   2-layer full-width model through the kernels against the same model
   through the plain versions;
5. a ``BatchEngine`` (dense slots, buckets 32/64/128) answering six requests
   of mixed lengths, one admitted mid-flight, compared token by token with
   single-sequence decode;
6. ``quant_attention_vs_plain``: the quantized-KV decode attention kernel
   against its plain versions, as ``chunk_attention`` (the chunks' flash
   state) and as the one-launch ``quant_attention_decode`` (chunks,
   residual window, combine), at the Llama-3-8B geometry (B = 4 at 3136
   live tokens, B = 8 at 1024, timed beside the byte bound, the plain
   versions and ``scaled_dot_product_attention`` on the dequantized bf16
   K/V), and untimed at 2 and 8 bits, grouped V scales, GEAR-L rank 2,
   ragged per-slot lengths and LLaVA-1.5-7B's multi-head decode (32 KV
   heads, rep 1, 10 chunks and 19 residual tokens). Its times are device times (torch.profiler)
   and CUDA-graph times: the wrapper's host time per call exceeds the
   kernel's, and CUDA events around back-to-back calls would time the
   host; that wrapper time is printed beside them;
7. ``quant_kv_main_path``: the 32-layer model of phase 4 through a 4-bit
   KIVI cache (``QuantKVConfig(bits=4, gap=64, v_group=128)``), a
   ``last_only`` prefill of 4 x 3072 tokens and 64 greedy decode steps, with
   exact launch counts, interleaved with a dense bf16 KV arm at the same
   context;
8. ``quant_two_layer_logits``: a 2-layer full-width model over a quantized
   cache, 120-token prompt and 8 decode steps (one fold), through the
   kernels against the plain versions;
9. ``quant_engine``: ``BatchEngine(cache_kind="quant")`` answering six
   requests, each compared token by token with a 1-slot quant engine;
10. ``outlier_kernels_vs_plain``: the MicroScopiQ outlier formats (int2
    inliers, fp4 outliers, block 16, 2-sigma rule) on N(0, 0.02) weights
    with 3% of the elements scaled by 10, at every Llama-3-8B shape: the
    compact NB (budget 2) and side-band (budget 4) GEMVs at M = 8, 64,
    255, and 1 at gate_up (the side-band one with its HBM rate, plan and occupancy) and their
    GEMMs at M = 256, 1024, and the merged emi8m stream
    through the GEMV (M = 1, 8, 64) and the GEMM (M = 128, 1024), each
    against its plain version, timed beside the bound, the plain version
    and ``torch.matmul`` on the dequantized bf16 weight;
11. ``outlier_main_path``: the 32-layer full-width model in each transport
    that ``nn.pack_params`` makes (compact NB from RTN decisions, fused;
    side-band, unfused; emi8m, fused), one after the other, with the main
    path's prefill and decode and exact launch counts, each timed
    interleaved with the MX-FP6 model; ``outlier_engine``: a dense-slot
    ``BatchEngine`` over the NB model, each request token-identical to
    single-sequence decode; ``outlier_decode_profile`` of the NB and
    side-band arms;
12. ``outlier_two_layer_logits``: per transport, a 2-layer full-width
    model, 4 x 120-token prompt (a GEMM prefill) and 8 decode steps,
    through the kernels against the plain versions;
13. ``int_kernels_vs_plain``: the GEMV (M = 8, 64; 1 at gate_up) and GEMM
    (M = 128, 1024) in every other transport of the TPU kernels at the Llama-3-8B
    shapes (int4/sb4, int8 and int2 in the int8 container, int2/sb2 at
    block 16, fp6/pf6, fp4/pf4; the bf16 and fp16 containers (qkv and
    gate_up), 2-D
    ``native2d`` int8 codes, and the float8 containers (fp8_e4m3, fp8_e5m2,
    fp6 in ``float8_e4m3fn``, 2-D fp8_e4m3 codes) at some shapes), each
    against
    ``dequant_matmul_reference``, timed beside the bound, the plain
    version and ``torch.matmul`` on the dequantized bf16 weight;
14. ``int_main_path``: the 32-layer full-width model with every linear
    packed by ``nn.pack_params`` as int4 (sb4) and as int8 (the int8
    container), one after the other, with the main path's prefill and
    decode, exact launch counts, weight bytes, bits per weight and peak
    memory (every prefill GEMM of both arms on the sm90 loop's counter,
    none on a ``_tile`` one), each timed interleaved with the MX-FP6
    model; ``int_engine``: a
    dense-slot ``BatchEngine`` over the int4 model, each request
    token-identical to single-sequence decode;
15. ``int_two_layer_logits``: per case of phase 13 (of the float8 ones,
    the ``pack_params`` models in fp8_e4m3 and fp8_e5m2), a 2-layer
    full-width model, 4 x 120-token prompt and 8 decode steps, through the
    kernels against the plain versions;
16. ``gemm_block_routes``: the GEMMs at the MX blocks that the JAX
    packers take and no other phase packs (pf6 at 64 and 128, pf4 at 16,
    64 and 48, the fp16 and bf16 containers at 8, 64 and 48, the side-band
    format at 8, 64 and 48 with 4 slots and at 8 with 8, emi8 at 8, 64, 48
    and 128, sb4 at 2, 8, 64 and 48, sb2 at 4, 64, 48 and 12, the int8
    container and the float8 containers at 8, 64, 2 and 48), at gate_up,
    M = 1024, each on the kernel that ``dequant_matmul.gemm_route`` names
    (the sm90 loop: compiled for the block, or ``csrc/gemm_any.cu``'s
    kernel, which takes it at run time) and held to its plain twin, timed;
    ``gemv_block_routes``, the GEMV at M = 8 at the same blocks (held to
    its twin, 1e-5; timed on ``csrc/gemv_any.cu``'s kernel, the blocks no
    multiple of 16), and ``s8_block_routes``, the W8A8 call at those
    blocks and at sb4 4 and sb2 8 (every one on gemv_any.cu's
    ``gemv_s8_any``; timed as CUDA-graph device time), then each of their
    decodes at block 16 on the tensor-core GEMVs as yardsticks (rows with
    ``yardstick``); then one call a case (not the yardsticks) as the entry
    point's run, with exact launch counts (gemm_any.cu's apart);
17. ``sad_s8_vs_plain`` (run right after the build, while the profiler's
    windows are whole): the W8A8 GEMV (int8, int4/sb4, int2/sb2) at every
    shape, M = 8, 64 (1 at gate_up), against
    ``dequant_matmul_sad_s8_reference``, the
    whole call and its GEMV alone (a profiler window checked against the
    wrappers' launch counts), beside the bf16-activation GEMV,
    ``torch.matmul`` and ``torch._int_mm``; the one-launch activation
    quantizer bit-equal to its twin;
18. ``mx_quant_vs_plain``: the MX block quantizer in five formats on every
    weight shape (block 32) and a ragged one (block 16), bit-equal to
    ``pack_mx(exact_scale=True)``, timed beside the byte bound;
19. ``gptq_main_path``: Llama-3-8B at full width, 1 layer (2 until PR
    17, cut for the run's time), GPTQ-calibrated
    on the card (``quant.calibrate.gptq_quantize_model``: int2 inliers, fp4
    outliers, block 16, at most 2 outliers a block, decisions collected; its
    column loop replayed from CUDA graphs) on 16 synthetic crops of 512
    tokens, each linear's Hessian proxy loss beside round-to-nearest's;
    packed from GPTQ's decisions into the compact NB transport (4.0 bits a
    weight), its perplexity over 8 windows of 512 tokens (NB GEMMs) within
    1e-3 of the fake-quant model's and its last logits within 4e-2, and a
    prefill with 32 graph-replayed decode steps (NB GEMVs), launch counts
    held exactly; the seconds a layer by stage and the column loop's
    seconds a column eagerly and replayed;
20. ``prefill_experiments``: the port's four prefill-GEMM experiment
    scripts (``microscopiq_tpu_torch.scripts.exp_prefill_floor``,
    ``_tiles2``, ``_overlap``, ``_pipe``) through their ``main()`` at
    gate_up, M = 1024, on one seeded setup: one line per arm (the
    predecoded, tile-swept, sub-chunked, pipelined and resident-x GEMMs of
    ``csrc/exp_prefill.cu``, the shipped GEMM and ``torch.matmul``), each
    held to its plain version and timed in three interleaved passes, then
    ``prefill_decomposition``: dense, tile loop, convert, decode, best
    tiles, pipelining and resident x side by side;
21. ``gemv_experiments``: the port's three decode-GEMV experiment scripts
    (``microscopiq_tpu_torch.scripts.exp_decode_variants``,
    ``exp_sad_tiles``, ``exp_nb_variants``) through their ``main()`` on
    their own setups (M = 8): one line per arm (the decode variants, the
    tile sweep and the NB modes of ``csrc/exp_gemv.cu``, the shipped GEMVs
    and ``torch.matmul``), each held to its own plain version, i16, ebf8
    and f32dot bit-equal to i32, timed in three interleaved passes, then
    ``gemv_decomposition``: dense, the zero-decode floor, the decodes, the
    shipped GEMV, the best tile, the shipped NB GEMV and the best NB mode
    side by side.

Run right after phase 9, on phase 4's 32-layer MX-FP6 model (no second
model is built; each path's launch counts join the ``kernels`` line):

22. ``trace_stats``: ``utils.observability.trace`` around 7 replays of the
    decode step (B = 8): ``device_kernel_stats`` holds exactly the GEMV
    launches the captured step implies, ``device_busy_us`` lies between
    the GEMV's device time and the replays' wall time, the filler kept at
    both ends; ``decode_token_stats`` of 22 replayed steps; the busy share
    beside ``decode_device_profile``'s;
23. ``h2o_engine``: ``BatchEngine(cache_kind="h2o")``, 4 slots, buckets up
    to 128, a 192-token budget, 16 recent tokens, six requests of 96-128
    prompt tokens asking for 128 new ones (every slot evicts), each
    answered in full, one of them token-identical to a 1-slot H2O engine,
    and at a budget no request outgrows token-identical to the dense
    engine (the depth cut for the run's time: PERF.md section 4);
24. ``h2o_main_path``: B = 4, a 128-token prompt and 96 eager greedy steps
    through ``H2OCache``: at the dense run's length the dense cache's
    tokens; at a 160-token budget (64 evictions a layer) the slots and
    scores of layers 0 and 31 equal to a CPU replay fed the (k, v, probs)
    recorded on the card; ``QuantH2OCache`` (4 bits) beside it, with KV
    bytes;
25. ``sink_main_path``: B = 4, ``SinkDecodeCache`` with 4 sink tokens and
    256 slots, a 128-token prompt and 192 steps at the clamped slot
    positions (64 evictions), the first eviction's re-rotated keys against
    ``_rope_delta`` on the CPU;
26. ``gear_codecs``: ``compress_insert`` in its nine methods and
    ``true_gear_compress``/``true_gear_decompress`` on bf16 K/V of shape
    (4, 8, 3072, 128), on the card against the same calls on the CPU
    (restored tensors), timed, beside ``CompressionConfig.compress_ratio``;
27. ``host_codec``: the g++-built ``native.pack_mx_native`` bit-equal to
    ``pack_mx`` at gate_up, fp6_e3m2, block 32, with its seconds;
    ``kv_policy_phases`` logs the six phases' seconds.

Then, still on that model:

28. ``frontends``: the serving stack over loopback HTTP (127.0.0.1, port
    0): a controller, an engine-backed worker (``engine_generate_stream_fn``,
    4 dense slots), a ``generate``-backed worker under a second model name
    (``torch_generate_stream_fn``, holding the engine's lock around each
    capture), the web server and the OpenAI gateway; six concurrent chat
    completions (three as SSE), two web chats and one ``cli.test_message``
    of 32 new tokens, prompts of 16-120 words under the crc32 stand-in
    tokenizer; every engine-backed answer equal to a 1-slot engine's
    tokens for its prompt, every ``generate``-backed one to ``generate`` at
    B = 1; requests/s, tokens/s and the time to the first streamed chunk;
29. ``cot_evals``: ``evaluate_gsm8k`` (synthetic rows, limit 4, 48 new
    tokens) over ``engine_generate_fn`` with the dense engine and with the
    4-bit quantized one, and ``evaluate_cot_task`` for bbh, mmlu and aqua
    (limit 4); an oracle scores 1.0 on each; two prompts' generations equal
    a 1-slot engine's; the accuracies (random weights: ~0).

After phase 4's model is freed:

30. ``kv_accuracy``: ``scripts/kv_accuracy.py`` on the card at its own size
    (trained 400 steps there): the ten arms' copy accuracy and its five
    ordering checks; the dense and KIVI-2bit arms' predictions on one
    batch of 16 rows against the port's CPU run on the same weights
    (>= 99% of tokens equal);
31. ``families``: Llama-2-7B, Mistral-7B, Mixtral-8x7B and MPT-7B at full
    published width, 2 layers, every linear MX-FP6 emi8 block 32 by
    ``nn.pack_params`` (the router too): B = 4, a 128-token prompt and 32
    greedy steps replayed from a CUDA graph, held to the eager decode
    (``graph_vs_eager``), the prefill's logits through the kernels against
    the plain twins (Mistral: a cacheless 256-token forward under a
    64-token window) within LOGIT_REL_TOL, Mixtral's router choices on the
    card against the twin's on the same inputs (and, between the two
    forwards, a token whose expert choice flips must be a near-tie of the
    twin's router logits, within LOGIT_REL_TOL of max; it is counted and
    left out of the logits' check); TTFT, ms a replayed step, weight GB
    and the launches by kernel;
32. ``hf_loading``: the seeded 2-layer Llama-2-7B-width tree exported
    (``export_llama_state_dict``) to a ``.bin`` file and a BF16
    ``.safetensors`` file, each in a directory with a ``config.json``,
    loaded by ``cli.llm_cli.build_model``: the trees equal to the export
    after the bf16 round trip, greedy tokens equal to the in-memory
    model's.

The training path (MX fake-quant layers, no kernel of their own: the
reference computes their products in XLA), then ``slice18_phases`` with
the three phases' seconds:

33. ``mx_layers``: the fake-quant quantizers (``quantize_elemwise_op``,
    ``quantize_mx_op``, ``quantize_mx_outlier_op``, dither with given
    draws) on the card bit for bit against the CPU (NaN as NaN); every
    layer of ``nn`` (the straight-through primitives, vector and SIMD ops,
    activations, softmax, MX linear, matmul, bmm, ``mx_op_table``,
    ``MXLinear``, the norms, GroupNorm, BatchNorm, the convs, pooling,
    ``Conv2d``, LSTM) forward and backward on the card and on the CPU under
    the canonical spec (fp6_e3m2, scale_bits 4, block 32, bfloat16),
    ``quantize_backprop`` on and off: outputs and gradients within 2^-7 of
    max |CPU|, the share of differing elements reported;
    ``nn.QuantizedLinear`` on packed MX-FP6 and NB weights equal to
    ``dequant_matmul`` / ``dequant_matmul_nb``, one GEMV launch at M = 8;
34. ``actquant_ppl``: OPT-125M at its published size, seeded weights,
    under the reference's activation-quantization config (fp4 weights,
    int4 activations, block 128, ``a_axes=1``, only the linears MX): the
    perplexity over 4 x 512 tokens of the synthetic stream beside the
    dense model's; window 0 against the port's CPU run (1e-3 a reported
    target: the int4 quantizer amplifies float32 ulps), and all 72 MX
    linears against the CPU's on the inputs the card gave them (1e-5 of
    max);
35. ``train_main_path``: ``scripts.mx_ffn`` 200 steps on the card against
    the CPU from one start (mse at steps 0, 50, 100, 150, 199 within 1%,
    falling by half); Llama-3-8B width cut to 2 layers, float32 weights,
    fake-quant fp6_e3m2 (scale_bits 8, block 32, bfloat16,
    ``quantize_backprop`` on), 3 SGD steps on 1 x 512 tokens: seconds of
    forward, backward and step, peak memory, the loss finite and falling,
    every gradient finite, and the gate_up linear's autograd gradients
    equal to nn/linear.py's backward formula (``mx_linear_backward``, from
    ``quantize_mx_op`` on the card) on the operands its forward saves,
    within 1e-6 of max.
36. ``tp_main_path``: Llama-3-8B at full width, 32 layers, seeded MX-FP6
    emi8 weights, over two ranks in two processes on the one card joined
    by gloo (``--tp-rank``): (data=2, model=1), half the batch a rank,
    stitched by ``global_batch`` and compared with the one-process rows;
    then (data=1, model=2), each rank on its shards (``shard_params``),
    against a one-process run of the same weights here: every linear of
    all 32 layers (and the lm_head) fed the one-process input of it, in
    the prefill and a decode step, within 2^-7 of max with at most 1% of
    its elements differing (the row-parallel sums' bf16 roundings);
    a prefill of 4 x 128 tokens and 16 eager steps teacher-forced on the
    one-process tokens over the dense and the 4-bit KIVI cache (KVH 4 a
    rank), at 32 layers (logits and tokens reported beside the plain
    versions' own distance: the seeded reference is chaotic there) and at
    the first 2 layers (prefill and step logits within 4e-2 of max, the
    plain versions there too, every differing token a near-tie, >= 90%
    equal); 129 GEMVs a step (+ 32 attention launches) and 128 GEMMs + 1
    GEMV a prefill on each rank; weight and peak GB, eager ms a step and
    the collectives' share (host clock).
37. ``tp_check``: ``scripts.check_tp``'s check at world 1 (NCCL, in this
    process) and world 2 (gloo, in the two ranks of ``tp_main_path``): the
    TP GEMV, GEMM and quantized attention against the plain versions
    (1e-5, 2e-3, 2e-2 of max).
38. ``posit_vq``: posit8 (es 0, 1, 2) and posit16 (es 1, 2) encode,
    decode and fake-quant on a full-width activation and the gate_up
    weight, card = CPU bit for bit; VQQuantizer (bits 3, vec_dim 2) on a
    4096 x 4096 q_proj with the CPU's k-means++ draws: equal assignments
    (>= 99%), MSE within 1%. The CPU side runs in a second background
    process (``--cpu-references-19``).

Slice 20, the LLaVA-1.5 stack at LLaVA-1.5-7B width (``LlavaConfig()``:
the Vicuna-7B text tower in bf16 with fused projections, its linears
MX-FP6 emi8 block 32 by ``pack_llava_lm``, the lm_head dense; the
ViT-L/14-336 tower and the 2-linear GELU projector float32, TF32 off;
seeded N(0, 0.02) weights, the tower's drawn on the host so that the CPU
reference draws the same), then ``slice20_phases`` with each phase's
seconds. The prompt is the ``llava_v1`` template around ``"<image>\n"``
and a question, tokenized by ``serve.stack.Crc32Tok(32000)`` and expanded
to 576 image slots; the image a seeded uint8 480 x 640 x 3 array
(``process_images`` pads it square, then resizes it to 336):

39. ``vlm_tower``: one image through the tower and the projector on the
    card against the port's CPU run of the same weights and pixels (the
    second background process, ``--cpu-references-19``, makes it after
    the slice-19 references): features within 1e-4, projected features
    within 2^-7 of max |CPU|; their CUDA-event times;
40. ``vlm_main_path``: 32 layers, B = 1, a prefill with the image and 32
    greedy decode steps replayed from a CUDA graph (``DecodeStep``), held
    bit for bit to an eager run (``graph_vs_eager``, arm ``llava``) and to
    ``vlm.generate_mm`` (the entry point: its tokens, and its launches as
    the wrappers count them, 128 GEMMs and 2 x 128 GEMVs: the eager step
    and the captured one); exact launches (prefill 128 emi8 GEMMs and no
    GEMV, 128 emi8 GEMVs a step); TTFT split into tower + projector and
    the language model's prefill, image-prefill tokens/s, ms a step (graph
    and eager), packed GB and bits a weight, peak GB, the dense bf16
    language model's prefill; the 4-bit KV arm (``QuantKVConfig(bits=4,
    gap=64)``): 32 quantized attention launches a step more, its tokens
    equal to ``generate_mm``'s over the same cache, agreement with the
    dense arm's;
41. ``vlm_eval``: ``vlm.eval_vqa`` on that model, 3 seeded questions and
    images, 8 new tokens, ``num_chunks=2`` merged by
    ``merge_answer_chunks``: each answer's tokens equal to a
    ``generate_mm`` call of its own;
42. ``vlm_two_layer_logits``: its first 2 layers through the kernels
    against the plain versions: the prefill's logits with the image and
    one teacher-forced decode step over the dense cache and over the 4-bit
    one (the kernels' step 8 GEMVs and 2 quantized attentions, the plain
    model's ``cache.update``) within LOGIT_REL_TOL; doubled pixels move
    the last logits; a text-only forward is finite;
43. ``vlm_gptq``: ``vlm.llava_sequential`` on one layer of the full-width
    model (float32 text tower, 2 calibration prompts with images,
    ``nsamples_batch=2``): tower and projector bit-unchanged, every layer-0
    kernel changed, the result's forward finite, seconds by stage;
44. ``vlm_probe``: ``scripts.vlm_probe`` on the card at its 1200 steps: six
    accuracies, five ordering checks (a check that fails there fails the
    phase only where the CPU run of the same seed passes it; that run is
    made only then, on every core), seconds.

Slice 21, the parity models' trainer and the KV-method comparison, then
``slice21_phases`` with each phase's seconds:

45. ``parity_train`` (logged right after ``build``): ``scripts.parity.
    prepare`` on the card: the grid's OPT (vocabulary 4096, hidden 512,
    FFN 2048, 12 layers) and Llama (intermediate 1536, 4 KV heads) trained
    from ``seeded_state_dicts(0)`` for 800 AdamW steps each on the Markov
    stream's training split (16 crops of 256 tokens a step,
    ``parity_ref.py prepare``'s recipe), in a process of its own
    (``--parity-train DIR``) started before the build, so that it trains
    on the card while nvcc runs (plain PyTorch: no kernel of the port's
    own); the run waits for it before its first card phase. Each model's
    loss every 100 steps, its seconds and the wait; the weights go to a
    temporary directory, where a third background process
    (``--cpu-references-21 DIR``, started with the slice-21 phases)
    computes the grid's held configs on them on the CPU, and
    ``gear_compare``'s CPU run.
46. ``parity_grid``: ``scripts.parity``'s eight configs on the card on
    the trained weights: dense, Llama dense and RTN MX-FP6 (fake and
    packed) at 12 layers within 0.1 perplexity of the CPU on the same
    weights; the canonical GPTQ config (int2 + fp4 outliers, block 16) at
    12 layers, its emi8m GEMM and compact-NB GEMM serving trees within 0.1
    of its fake-quant perplexity (the dequantized weights, plain matmuls);
    act-order, g128 static groups, activation quantization and Llama GPTQ
    reported, finite, at their first PARITY_REPORTED_LAYERS layers; the
    trained dense perplexities beside ``PARITY_r05.json``'s (other
    weights: a report); launches by kernel.
47. ``gear_compare``: ``scripts.gear_compare`` at its toy size (eight KV
    methods, teacher-forced decode through ``DecodeStep``, the GSM8K
    pipeline) on the card against its CPU run on the same seeded weights:
    each decode perplexity within GEAR_PPL_RTOL, both compression ratios
    and every route equal, the quantized attention launched exactly by
    the methods whose route is ``fused``, both GSM8K runs complete.

The line before the last is the card's name and power limit, the one before
it ``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --gemm-times

times only the pf6, side-band, pf4, fp16-container, emi8, emi8m,
compact-NB, sb4, sb2, int8-container, fp8_e4m3, fp8_e5m2 and
bf16-container GEMMs (and ``torch.matmul`` on a bf16 weight) at
M = 1024 at every Llama-3-8B shape on seeded operands and prints them as
one JSON line (``sm90_gemm_times``), to compare two checkouts on one
card.

    python3 chip_smoke.py --route-times

times only the GEMMs of ``gemm_block_routes`` (ROUTE_CASES at gate_up,
M = 1024, on seeded operands) and prints them as one JSON line
(``route_times``); it calls only wrappers that the previous tree has too:
copy it into a parent checkout to compare the two on one card.

    python3 chip_smoke.py --gemv-route-times

times only the GEMVs of ``gemv_block_routes`` and ``s8_block_routes``
(GEMV_ROUTE_TIME_CASES at gate_up, M = 1, 8, 64: the dequant GEMV and the
W8A8 call at the blocks no multiple of 16, the 16-bit containers at 256,
and each decode at block 16 on the tensor-core GEMVs) and prints them as
one JSON line (``gemv_route_times``); it calls only wrappers that the
previous tree has too (a block that tree refuses is a ``refused`` row):
copy it into a parent checkout to compare the two on one card.

    python3 chip_smoke.py --qattn-times

times only the quantized-KV decode attention (``chunk_attention`` and the
whole layer's ``quant_attention_decode`` at B = 4 x 3136 and B = 8 x 1024
live tokens: device, CUDA-graph and wrapper times, launches a call), the
W8A8 call at gate_up (int8, sb4, sb2; M = 8, 64: the whole call and its
GEMV alone) and the quant-KV arm's replayed decode step (ms a step, the
attention kernels' device time and the kernel launches a step), and
prints them as one JSON line (``qattn_times``). It calls only wrappers
that the previous tree has too: copy it into a parent checkout to compare
the two on one card.

    python3 chip_smoke.py --gemv-times

times only the GEMVs: every decode of the dequant GEMV (M = 1, 8, 64) and
the NB GEMV (M = 1, 8, 64, 255) at every Llama-3-8B shape, and the
side-band GEMV at the side-band arm's decode shapes (q, k, v, o, gate, up,
down, lm_head; M = 1, 8, 64, 255), each beside its bound, ``torch.matmul``
and its HBM rate, and prints them as one JSON line (``gemv_times``), to
compare two checkouts on one card.

    python3 chip_smoke.py --quant-times

times only the MX block quantizer (gate_up in five formats at block 32,
the ragged shape at block 16) beside its byte bound and prints one JSON
line (``quant_times``); it calls only the wrapper, which the previous tree
has too, so copy it into a parent checkout to compare the two on one card.

    python3 chip_smoke.py --cpu-references

computes only the CPU runs that ``actquant_ppl`` and ``train_main_path``
hold the card against and prints them as one JSON line; the whole run
starts it in a process of its own after the build, on 2 of the host's
cores, so that it overlaps the card's phases (``--cpu-references-19
DIR`` likewise for the slice-19 phases and the slice-20 tower;
``--cpu-references-21 DIR`` for the slice-21 phases, started once the
trained weights are in DIR).

    python3 chip_smoke.py --only slice17|slice18|slice19|slice20|slice21 [--tests]

runs one slice's phases alone (quicker than the whole script while
iterating): builds the sources they launch, starts the CPU references
they read, and logs their lines and seconds; with ``--tests``, first that
slice's card tests in ``tests/test_torch_kernels_gpu.py``. It prints no
kernels line and no ``ok`` line.

"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

# the timing helpers, shared with the experiment scripts (this import fails
# where the package is missing, and the script with it)
from microscopiq_tpu_torch.utils.observability import (card_line, copies_for,
                                                       cuda_ms)

# the script's start, for the ``t_s`` of every logged line
_START = time.perf_counter()

# Tolerances of kernel vs plain version, relative to max |plain|:
# - GEMV: both sum exact f32 products of bf16 x and emi8 integers in f32 and
#   differ only in summation order -> the 1e-5 bound of
#   tests/test_pallas_kernels.py::test_sad_matches_reference.
# - GEMM: the tensor cores' f32 accumulation differs from a CUDA-core f32 sum
#   in order and internal rounding -> the 2e-3 bound of
#   tests/test_pallas_kernels.py::test_dq_matmul_prefill_fused_decode.
GEMV_REL_TOL = 1e-5
GEMM_REL_TOL = 2e-3
# 2-layer bf16 logits, kernels vs plain versions: the linears round their
# bf16 outputs after f32 sums taken in different orders; a flip of one bf16
# rounding (2^-8 relative) propagates through RMSNorm, attention and the MLP
# of two layers, so logits are held to 4% of max |logit|.
LOGIT_REL_TOL = 4e-2
# quantized-KV attention kernel vs plain version, relative to max |plain|:
# float32 sums in other orders, split over blocks and merged -> the 2e-2
# bound of tests/test_quant_attention.py:47.
QATTN_REL_TOL = 2e-2

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
INT8_OPS = 1979e12               # dense int8 tensor-core peak
F32_FLOPS = 67e12                # float32 outside the tensor cores

SHAPES = [("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 28672),
          ("down", 14336, 4096), ("lm_head", 4096, 128256)]
GEMV_M = (1, 8, 64)
# the W8A8, integer and outlier GEMV rows take M = 1 at one shape a kernel
# (M1_LINEAR): it runs M = 8's plan (one n8 tile of x rows), masking seven
# of its rows, and the other shapes' M = 1 rows are left out for the run's
# time
S8_M = (8, 64)
M1_LINEAR = "gate_up"
GEMM_M = (128, 1024)


def with_m1(lin: str, ms) -> tuple:
    """``ms``, with M = 1 first at the M1_LINEAR shape."""
    return ((1,) + tuple(ms)) if lin == M1_LINEAR else tuple(ms)


def at_m1_linear(lin: str, ms, m_record: int) -> tuple:
    """``ms`` at the M1_LINEAR shape, else ``m_record`` alone (the M that
    the kernels line's records read): the integer and outlier phases' other
    rows at one shape a kernel, for the run's time."""
    return tuple(ms) if lin == M1_LINEAR else (m_record,)


def log(**rec):
    """One JSON line, with ``t_s``: the seconds since the script started
    (the run's timeline, phase by phase)."""
    print(json.dumps({**rec, "t_s": time.perf_counter() - _START}),
          flush=True)


def _wrappers():
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import exp_gemv as eg
    from microscopiq_tpu_torch.ops.cuda import exp_prefill as ep
    from microscopiq_tpu_torch.ops.cuda import mx_quant as mq
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om
    from microscopiq_tpu_torch.ops.cuda import quant_attention as qa

    return dm, qa, om, mq, ep, eg


def reset_counts() -> None:
    for mod in _wrappers():
        mod.reset_launch_counts()


def launches() -> dict:
    """Every kernel wrapper's launch count, by kernel and decode."""
    out = {}
    for mod in _wrappers():
        out.update(mod.launch_counts)
    return out


def want_counts(**nonzero) -> dict:
    """A launch-count dict over every kernel wrapper: ``nonzero``, else 0."""
    unknown = set(nonzero) - set(launches())
    if unknown:
        raise KeyError(f"no kernel wrapper counts {sorted(unknown)}")
    return {n: nonzero.get(n, 0) for n in launches()}


def card_info():
    import torch

    return card_line(), torch.cuda.get_device_name(0), torch.cuda.device_count()


def device_ms(fn, n_args: int, calls: int = 16, phase: str = "") -> float:
    """Device time per call of fn(i), i cycling over n_args operand copies:
    the CUDA kernels' time in a whole torch.profiler window over ``calls``
    calls (:func:`kernel_split_ms`, which raises on a short one), over
    their number. For a call whose host time exceeds its device time,
    where back-to-back CUDA events would time the host."""
    by_name, _ = kernel_split_ms(fn, n_args, calls, phase=phase)
    return sum(by_name.values())


def graph_ms(fn, n_args: int, calls: int = 16, replays: int = 3) -> float:
    """Device time per call of fn(i), i cycling over n_args operand copies:
    ``calls`` calls captured in one CUDA graph, so that no host time lies
    between their kernels, replayed between CUDA events. For a call whose
    host time exceeds its device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)                               # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % n_args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


PROFILE_FILLER = 4096     # spin kernels on each side of the timed calls
filler_lost = []          # per window: filler records the profiler lost


def profile_window(fn, n_args: int, calls: int):
    """One torch.profiler window over ``calls`` calls of fn(i), i cycling
    over n_args operand copies: [(CUDA kernel name, device us, events)]
    for every kernel with device time. The calls sit between
    PROFILE_FILLER one-cycle spin kernels (``torch.cuda._sleep``) on each
    side, which are left out of the result; how many of their records the
    window lost goes to ``filler_lost``. On the H100 machines a window
    loses the kernel records of its first N launches, N growing through
    the process (one more every ~15 s in a probe, 170 in one full run),
    and, in some windows, the records of its last launches, those whose
    kernel times fall past the window's end (a few hundred us of them):
    the filler takes both losses (``_dev/profiler_clock.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FILLER):
            torch.cuda._sleep(1)
        for i in range(calls):
            fn(i % n_args)
        for _ in range(PROFILE_FILLER):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    events, spin = [], 0
    for e in prof.key_averages():
        if getattr(e, "self_device_time_total", 0.0) <= 0:
            continue
        if "spin_kernel" in e.key:
            spin += e.count
        else:
            events.append((e.key, e.self_device_time_total, e.count))
    filler_lost.append(2 * PROFILE_FILLER - spin)
    return events


def kernel_split_ms(fn, n_args: int, calls: int = 16, phase: str = "",
                    window=None, sync=None):
    """Device time per call of fn(i), i cycling over n_args operand copies,
    by CUDA kernel name, and the kernel launches per call, from a whole
    torch.profiler window (``window``, :func:`profile_window` unless a
    test gives another): ({name: ms}, launches).

    A window is whole when it holds, over its calls, at least as many kernel
    events as the wrappers' ``launch_counts`` rose by over the same calls
    (a wrapper counts one of the kernels it launches) and a multiple of the
    calls (every call launches the same kernels). A short window is taken
    again over half the calls; a second short one raises, naming the phase
    and both counts."""
    import torch

    sync = sync or torch.cuda.synchronize
    window = window or profile_window
    fn(0)
    sync()
    for n in (calls, max(1, calls // 2)):
        before = sum(launches().values())
        events = window(fn, n_args, n)
        want = sum(launches().values()) - before
        got = sum(c for _, _, c in events)
        if events and got >= want and got % n == 0:
            return {k: t / 1e3 / n for k, t, _ in events}, got / n
        print(f"chip_smoke: {phase}: the profiler window held {got} kernel "
              f"events over {n} calls, the wrappers counted {want}: "
              f"{[(k[:48], c) for k, _, c in events]}",
              file=sys.stderr, flush=True)
    raise AssertionError(
        f"{phase}: the profiler window held {got} kernel events over {n} "
        f"calls (twice short); the wrappers counted {want} launches")


def kernel_phase(card: str):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for lin, K, N in SHAPES:
        W = torch.randn((K, N), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 0.02
        p = pk.to_serving_layout(pk.pack_mx(W.float(), 8, "fp6_e3m2", 32,
                                            axis=0, transport="emi8"))
        del W
        dense = pk.dequantize_mx(p, dtype=torch.bfloat16)
        nc = copies_for(p.nbytes())
        ps = [p] + [dataclasses.replace(p, codes=p.codes.clone(),
                                        scale_exp=p.scale_exp.clone())
                    for _ in range(nc - 1)]
        nd = copies_for(dense.numel() * 2)
        ds = [dense] + [dense.clone() for _ in range(nd - 1)]
        for kname, Ms, fn, tol in (
                ("dequant_gemv_emi8", GEMV_M, dm.dequant_gemv, GEMV_REL_TOL),
                ("dequant_matmul_emi8", GEMM_M, dm.dequant_gemm,
                 GEMM_REL_TOL)):
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                got = fn(x, p, torch.float32)
                ref = dm.dequant_matmul_reference(x, p, torch.float32)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                if not (np.isfinite(rel) and rel < tol):
                    raise AssertionError(
                        f"{kname} {lin} M={M}: rel err {rel} >= {tol}")
                ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), nc)
                plain_ms = cuda_ms(
                    lambda i: dm.dequant_matmul_reference(x, p,
                                                          torch.float32),
                    1, target_ms=100.0)
                lib_ms = cuda_ms(lambda i: torch.matmul(x, ds[i]), nd)
                nbytes = (p.nbytes() + x.numel() * 2 + M * N * 4)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = 2 * M * N * K / BF16_FLOPS * 1e3
                row = dict(kernel=kname, linear=lin, M=M, K=K, N=N,
                           max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations",
                           plain_ms=plain_ms, library_ms=lib_ms, card=card)
                if kname == "dequant_gemv_emi8":
                    row.update(gemv_stats(p, M, K, N, ms))
                rows.append(row)
                log(phase="kernel_vs_plain", **row)
                del x, got, ref
        del ps, ds, p, dense
        torch.cuda.empty_cache()
    return rows


def prefill_decode(model, ids, steps: int, max_len: int,
                   decode_ctx=contextlib.nullcontext, quant_cfg=None,
                   feed=None, graph=True, info=None, prefill_kw=None):
    """bench.py's main path: last_only prefill, then greedy decode steps,
    over a dense bf16 KV cache or, with ``quant_cfg``, a quantized one.
    ``feed`` (B, steps) replaces the greedy tokens fed to the decode steps.
    ``prefill_kw`` goes to the prefill's call only (a LLaVA model's
    ``pixel_values`` and ``image_token_mask``; its decode steps are text
    steps), and a model whose config has a ``text`` part sizes the cache
    by it.

    The decode runs as ``generate`` runs it (``DecodeStep``): the first step
    eagerly (the warm-up that builds the kernels; its token is kept), then
    the step captured in CUDA graphs and replayed for every later step: one
    graph over the dense cache; over the quantized cache the plain step's
    and, where a later step folds a chunk, the fold step's (recorded before
    the timed window, so that its replays fall inside it).
    ``graph=False`` runs every step eagerly. ``decode_ctx`` wraps, and the
    host clock times, the replays (with the graph) or every step:
    ``decode_s`` is that window's time a step times ``steps``; ``info``, a
    dict, receives ``graph``, ``timed_steps`` and ``fold_replays``. The
    kernel wrappers count their launches when they launch, at the eager
    steps and at the captures, never at a replay: the decode's launches
    are the eager step's plus each captured step's times its replays.

    Returns (decoded tokens, ttft_s, decode_s, last logits, kernel launches
    of the prefill, kernel launches of the decode steps, final cache state,
    logits of every step)."""
    import torch

    from microscopiq_tpu_torch.eval.generate import DecodeStep
    from microscopiq_tpu_torch.kv.cache import (DenseDecodeCache,
                                                QuantizedDecodeCache,
                                                init_dense_cache,
                                                init_quant_cache,
                                                quant_fold_step)

    cfg = getattr(model.cfg, "text", model.cfg)
    B, S0 = ids.shape
    dims = (cfg.num_hidden_layers, B, max_len, cfg.num_key_value_heads,
            cfg.head_dim)
    if quant_cfg is None:
        state = init_dense_cache(*dims, device="cuda")
        wrap = DenseDecodeCache
    else:
        state = init_quant_cache(*dims, quant_cfg, device="cuda")
        wrap = lambda st: QuantizedDecodeCache(st, quant_cfg)
    pos = torch.arange(S0, device="cuda")[None, :].expand(B, S0)
    torch.cuda.synchronize()
    all_logits = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        cache = wrap(state)
        logits = model(ids, positions=pos, cache=cache, last_only=True,
                       **(prefill_kw or {}))
        tok = torch.argmax(logits[:, -1], dim=-1)
        state = cache.finalize()
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        at_prefill = launches()
        all_logits.append(logits)
        toks = []
        step = DecodeStep(model, state, tok, quant_cfg)

        def one(i):
            if feed is not None:
                step.tok.copy_(feed[:, i])
            out = step.replay() if graph and i > 0 else step.eager()
            toks.append(out.clone())
            if feed is not None:
                all_logits.append(step.logits.clone())

        # the variant of each step after the first, from the host mirror
        # (every step advances it by one)
        folds = sum(quant_fold_step(quant_cfg, S0 + i) for i in
                    range(1, steps)) if quant_cfg is not None else 0
        lead, captured = 0, {}
        if graph and steps > 1:
            one(0)                              # the warm-up: a real step
            warm = launches()
            for variant, n in (("plain", steps - 1 - folds), ("fold", folds)):
                if n:
                    before = launches()
                    step.capture(variant)
                    captured[variant] = (
                        {k: v - before[k] for k, v in launches().items()}, n)
            lead = 1
        with decode_ctx():
            t0 = time.perf_counter()
            for i in range(lead, steps):
                one(i)
            torch.cuda.synchronize()
            dec = time.perf_counter() - t0
        timed = steps - lead
        dec = dec / timed * steps if timed else 0.0
        logits = step.logits.clone()
    if not captured:
        in_decode = {k: v - at_prefill[k] for k, v in launches().items()}
    else:
        in_decode = {k: warm[k] - at_prefill[k]
                     + sum(c[k] * n for c, n in captured.values())
                     for k in warm}
    if info is not None:
        info.update(graph=bool(captured), timed_steps=timed,
                    fold_replays=folds if captured else 0)
    del step
    return (torch.stack(toks, 1), ttft, dec, logits, at_prefill, in_decode,
            state, all_logits)


def graph_vs_eager(model, ids, steps: int, max_len: int, arm: str,
                   graph_run, card: str, quant_cfg=None,
                   prefill_kw=None) -> float:
    """The decode (over the dense cache, or the quantized one of
    ``quant_cfg``) run eagerly, in this process and on the prompt of
    ``graph_run`` (a graph run's prefill_decode result): its tokens and
    last logits must equal the graph run's bit for bit, fold steps
    included, and its decode launches the graph run's (the warm-up step's
    plus each captured step's times its replays). Logs one line; returns
    the eager ms/step."""
    import torch

    eager = prefill_decode(model, ids, steps, max_len, graph=False,
                           quant_cfg=quant_cfg, prefill_kw=prefill_kw)
    same = dict(tokens_identical=bool(torch.equal(eager[0], graph_run[0])),
                logits_identical=bool(torch.equal(eager[3], graph_run[3])),
                launches_equal=eager[5] == graph_run[5])
    ms = eager[2] / steps * 1e3
    log(phase="graph_vs_eager", arm=arm, steps=steps, **same,
        eager_decode_ms_per_step=ms,
        graph_decode_ms_per_step=graph_run[2] / steps * 1e3,
        launches_decode={k: v for k, v in graph_run[5].items() if v},
        card=card)
    if not all(same.values()):
        raise AssertionError(f"{arm}: graph and eager decode differ: {same}")
    return ms


def decode_device_profile(model, ids, max_len: int, step_ms: float,
                          steps: int = 8, quant_cfg=None):
    """Device time of decode steps: the union of the CUDA kernels'
    intervals in a torch.profiler window over the timed decode steps (the
    graph's replays over the dense cache, ``steps - 1`` of them; every
    step over the quantized one), its share of the window's wall time
    (which the profiler inflates) and of ``step_ms``, the unprofiled step
    time, the kernel launches a step, the device time a step of the
    quantized attention's kernels (ATTENTION_KERNELS), and the kernels that
    take most device time. None where the profiler records no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box, info = {}, {}

    @contextlib.contextmanager
    def window():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
        box["prof"] = prof

    dec = prefill_decode(model, ids, steps, max_len, decode_ctx=window,
                         quant_cfg=quant_cfg, info=info)[2]
    prof = box["prof"]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    n = info["timed_steps"]
    per_kernel = sorted(
        ((e.key, getattr(e, "self_device_time_total", 0.0))
         for e in prof.key_averages()
         if getattr(e, "self_device_time_total", 0.0) > 0),
        key=lambda kv: -kv[1])
    busy_ms = busy / 1e3 / n
    wall_ms = dec / steps * 1e3
    launches_total = sum(e.count for e in prof.key_averages()
                         if getattr(e, "self_device_time_total", 0.0) > 0)
    attention = sum(t for k, t in per_kernel
                    if any(a in k for a in ATTENTION_KERNELS))
    return dict(steps=n, graph=info["graph"], profiled_wall_ms_per_step=wall_ms,
                device_busy_ms_per_step=busy_ms,
                kernel_launches_per_step=launches_total / n,
                attention_kernels_ms_per_step=attention / 1e3 / n,
                busy_share_of_profiled_wall=busy_ms / wall_ms,
                busy_share_of_unprofiled_step=busy_ms / step_ms,
                top_kernels_ms_per_step=[
                    (k[:60], t / 1e3 / n) for k, t in per_kernel[:8]])


def build(packed, layers=32, seed=0, use_kernels=True, tree=None):
    """Llama-3-8B at full width and ``layers`` deep, seeded random weights,
    fused projections; packed MX-FP6 emi8 (block 32, lm_head included) or
    dense bf16. Returns (model, weight tree)."""
    import torch

    from microscopiq_tpu_torch.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM,
                                                    build_params)
    from microscopiq_tpu_torch.nn import fuse_projections
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    specs = finalize_mx_specs({"w_elem_format": "fp6_e3m2",
                               "scale_bits": 8, "block_size": 32})
    c = LlamaConfig.llama3_8b(num_hidden_layers=layers, dtype=torch.bfloat16,
                              fused_projections=True)
    if tree is None:
        tree = fuse_projections(build_params(
            c, seed=seed, packed_specs=specs if packed else None,
            device="cuda")["params"])
    return LlamaForCausalLM(c, use_kernels=use_kernels,
                            device="cuda").load_params(tree), tree


def model_phase(card: str):
    """Phase 4: the 32-layer main path, the dense arm and the 2-layer
    kernels-vs-plain logits."""
    import torch

    L, B, S0, STEPS = 32, 8, 128, 32
    max_len = S0 + STEPS + 8
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, 128256, (B, S0)), device="cuda")

    t0 = time.perf_counter()
    packed, _ = build(True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_bytes = sum(
        m.kernel.nbytes() for m in packed.modules()
        if hasattr(m, "kernel") and hasattr(m.kernel, "nbytes"))
    prefill_decode(packed, ids, 2, max_len)              # warm-up
    torch.cuda.reset_peak_memory_stats()

    # the main path's run: counts zeroed just before, read just after
    reset_counts()
    main = prefill_decode(packed, ids, STEPS, max_len)
    toks, ttft, dec, last, pre_counts, dec_counts, *_ = main
    peak = torch.cuda.max_memory_allocated()
    want_pre = want_counts(dequant_matmul_emi8=4 * L, dequant_gemv_emi8=1)
    want_dec = want_counts(dequant_gemv_emi8=STEPS * (4 * L + 1))
    if pre_counts != want_pre or dec_counts != want_dec:
        raise AssertionError(f"launch counts prefill {pre_counts} (want "
                             f"{want_pre}), decode {dec_counts} (want "
                             f"{want_dec})")
    if not torch.isfinite(last.float()).all():
        raise AssertionError("non-finite logits on the main path")
    if not ((toks >= 0) & (toks < packed.cfg.vocab_size)).all():
        raise AssertionError("token ids out of range")
    eager_ms = graph_vs_eager(packed, ids, STEPS, max_len, "mxfp6", main,
                              card)

    # dense bf16 arm at the same depth, interleaved with the packed arm
    dense, _ = build(False, seed=0)
    prefill_decode(dense, ids, 2, max_len)
    dense_eager_ms = graph_vs_eager(
        dense, ids, STEPS, max_len, "bf16",
        prefill_decode(dense, ids, STEPS, max_len), card)
    best = {"packed": (ttft, dec), "dense": (9e9, 9e9)}
    for _ in range(2):
        for tag, m in (("dense", dense), ("packed", packed)):
            _, t, d, *_ = prefill_decode(m, ids, STEPS, max_len)
            best[tag] = (min(best[tag][0], t), min(best[tag][1], d))
    del dense
    torch.cuda.empty_cache()
    tps = B * STEPS / best["packed"][1]
    tps_dense = B * STEPS / best["dense"][1]
    path = dict(layers=L, batch=B, prompt=S0, steps=STEPS, graph=True,
                decode_tokens_per_s=tps,
                decode_ms_per_step=best["packed"][1] / STEPS * 1e3,
                eager_decode_ms_per_step=eager_ms,
                ttft_ms=best["packed"][0] * 1e3,
                dense_decode_tokens_per_s=tps_dense,
                dense_decode_ms_per_step=best["dense"][1] / STEPS * 1e3,
                dense_eager_decode_ms_per_step=dense_eager_ms,
                dense_ttft_ms=best["dense"][0] * 1e3,
                packed_vs_dense_decode=tps / tps_dense,
                packed_weight_gb=weight_bytes / 1e9,
                peak_mem_gb=peak / 1e9, build_s=build_s,
                launches_prefill=pre_counts, launches_decode=dec_counts,
                card=card)
    log(phase="main_path", **path)
    prof = decode_device_profile(packed, ids, max_len,
                                 path["decode_ms_per_step"])
    log(phase="decode_profile", profile=prof if prof else "not measured",
        card=card)

    # 2 layers at full width: through the kernels vs the plain versions
    two_k, tree = build(True, layers=2, seed=1)
    two_p, _ = build(True, layers=2, use_kernels=False, tree=tree)
    with torch.inference_mode():
        a = two_k(ids).float()
        b = two_p(ids).float()
    prefill_err = (a - b).abs().max().item()
    prefill_rel = prefill_err / b.abs().max().item()
    la = prefill_decode(two_k, ids, 1, max_len)[3]
    lb = prefill_decode(two_p, ids, 1, max_len)[3]
    decode_err = (la.float() - lb.float()).abs().max().item()
    decode_rel = decode_err / lb.float().abs().max().item()
    log(phase="two_layer_logits", prefill_max_abs_err=prefill_err,
        prefill_rel_err=prefill_rel, decode_max_abs_err=decode_err,
        decode_rel_err=decode_rel, tol=LOGIT_REL_TOL, card=card)
    if not (prefill_rel < LOGIT_REL_TOL and decode_rel < LOGIT_REL_TOL):
        raise AssertionError(f"2-layer logits: kernels vs plain rel err "
                             f"{prefill_rel}, {decode_rel}")
    del two_k, two_p, tree, a, b
    torch.cuda.empty_cache()
    return packed, {"prefill": pre_counts, "decode": dec_counts}, path


ENGINE_LENS, ENGINE_NEWS = (20, 50, 100, 40, 120, 10), (8, 12, 6, 10, 8, 12)


def serve_six(eng, vocab: int):
    """Six requests of mixed lengths through ``eng``, the last admitted
    while the others decode; each must be answered in full. Returns
    (requests, max_new_tokens of each, wall seconds)."""
    import torch

    from microscopiq_tpu_torch.serve.engine import Request

    rng = np.random.default_rng(7)
    reqs = [Request(rng.integers(0, vocab, (n,)).astype(np.int64), t)
            for n, t in zip(ENGINE_LENS, ENGINE_NEWS)]
    t0 = time.perf_counter()
    for r in reqs[:-1]:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.submit(reqs[-1])                 # admitted while others decode
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, t in zip(reqs, ENGINE_NEWS):
        if r.error is not None or len(r.out_tokens) != t:
            raise AssertionError(f"request of {len(r.prompt_ids)} tokens: "
                                 f"{len(r.out_tokens)}/{t} tokens, "
                                 f"error {r.error}")
    return reqs, ENGINE_NEWS, wall


def engine_phase(model, card: str):
    """Phase 5: continuous batching with both kernels serving prefills."""
    import torch

    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.serve.engine import BatchEngine

    eng = BatchEngine(model, n_slots=4, max_len=256,
                      prompt_buckets=(32, 64, 128), device="cuda")
    dm.reset_launch_counts()
    reqs, news, wall = serve_six(eng, model.cfg.vocab_size)
    counts = {k: v for k, v in dm.launch_counts.items() if v}
    if set(counts) != {"dequant_gemv_emi8", "dequant_matmul_emi8"}:
        raise AssertionError(f"engine did not use both kernels: {counts}")
    agree = total = 0
    first = 0
    for r, t in zip(reqs, news):
        ref = generate(model, [r.prompt_ids.tolist()], t)[0].tolist()
        agree += sum(a == b for a, b in zip(r.out_tokens, ref))
        first += int(r.out_tokens[0] == ref[0])
        total += t
    log(phase="engine", requests=len(reqs), tokens=total,
        wall_s=wall, tokens_per_s=total / wall, launches=counts,
        token_agreement_with_single_sequence=agree / total,
        first_token_agreement=first / len(reqs), card=card)


# quantized-KV flash-decode kernel configurations: Llama-3-8B geometry
# (H = 32, KVH = 8, hd = 128, gap = 64), timed at the main path's B = 4 x
# 3136 live tokens and at B = 8 x 1024; the rest check correctness only
QATTN_TIMED = {
    "b4_3136": dict(B=4, C=51, bits=4, v_group=128, rank=0,
                    lengths=[3136] * 4),
    "b8_1024": dict(B=8, C=17, bits=4, v_group=128, rank=0,
                    lengths=[1024] * 8),
}
QATTN_CHECKED = {
    "bits2": dict(B=2, C=6, bits=2, v_group=128, rank=0, lengths=[320, 384]),
    "bits8": dict(B=2, C=6, bits=8, v_group=128, rank=0, lengths=[320, 200]),
    "v_group32": dict(B=2, C=6, bits=4, v_group=32, rank=0,
                      lengths=[384, 130]),
    "gearl_rank2": dict(B=2, C=6, bits=4, v_group=128, rank=2,
                        lengths=[260, 384]),
    # 0, gap - 1 (residual only), exact multiples of gap (residual empty)
    "ragged": dict(B=6, C=8, bits=4, v_group=128, rank=0,
                   lengths=[0, 63, 192, 337, 1, 448]),
    # LLaVA-1.5-7B's 4-bit KV decode (vlm_main_path): multi-head attention
    # (KVH = H = 32, rep 1) at the last step's 659 live tokens, 10 chunks
    # and 19 in the residual window, in the arm's 12-chunk cache
    "llava_mha_rep1": dict(B=1, C=12, bits=4, v_group=128, rank=0,
                           lengths=[659], KVH=32, H=32),
}
QKV_GAP, QKV_KVH, QKV_H, QKV_HD = 64, 8, 32, 128


def qattn_state(B, C, bits, v_group, rank, lengths, seed, KVH=QKV_KVH,
                **_):
    """One layer of a quantized cache on the card, as the decode path holds
    it: random K/V quantized by the port's chunk codec (``_compress_chunks``)
    into C chunks of KVH heads, a bf16 residual window, and per-slot live
    lengths. Returns (state_full tuple with a leading layer axis of 1,
    lengths)."""
    import torch

    from microscopiq_tpu_torch.kv.cache import (QuantKVConfig,
                                                _compress_chunks,
                                                _FUSED_FIELDS,
                                                _LOWRANK_FIELDS)

    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    cfg = QuantKVConfig(bits=bits, gap=QKV_GAP, v_group=v_group, rank=rank)
    shape = (B, KVH, C, QKV_GAP, QKV_HD)
    # channel-wise magnitudes, as real keys have (KIVI's premise)
    kc = rn(*shape) * torch.exp(rn(B, KVH, 1, 1, QKV_HD))
    pieces = _compress_chunks(kc, rn(*shape), cfg)
    del kc
    res = lambda: rn(B, QKV_GAP, KVH, QKV_HD).to(torch.bfloat16)
    pieces.update(res_k=res(), res_v=res())
    names = _FUSED_FIELDS + (_LOWRANK_FIELDS if rank else ())
    full = tuple(pieces[n][None].contiguous() for n in names)
    return full, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def qattn_bound(B, C, bits, v_group, lengths, **_):
    """(bound ms, bound_by) of one chunk_attention call: the bytes of the
    folded chunks this call's lengths need (codes and scales read once, q
    read and (o, m, l) written once) over HBM, against its float32
    operations (dequantize K and V, q.k and p.v per query row) over the
    card's float32 rate."""
    rep = QKV_H // QKV_KVH
    chunks = sum(n // QKV_GAP for n in lengths)
    per_chunk = (2 * QKV_GAP * QKV_HD * bits // 8            # kq + vq
                 + 2 * QKV_HD * 4                            # k_mn, k_sc
                 + 2 * QKV_GAP * (QKV_HD // min(v_group, QKV_HD)) * 4)
    nbytes = (chunks * QKV_KVH * per_chunk + B * QKV_H * QKV_HD * 2
              + B * QKV_H * (QKV_HD + 2) * 4)
    tokens = chunks * QKV_GAP * QKV_KVH
    ops = tokens * (4 * QKV_HD + rep * (4 * QKV_HD + 4))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def qattn_errors(got, want, live):
    """(max abs err of o / l, max over o / l, m and l of |kernel - plain|
    relative to max |plain|), on slots with a folded chunk."""
    (o, m, l), (o2, m2, l2) = got, want
    out = lambda o_, l_: o_ / l_.clamp(min=1e-30)
    abs_err, rel = 0.0, 0.0
    for i, (a, b) in enumerate(((out(o, l), out(o2, l2)), (m, m2),
                                (l, l2))):
        a, b = a[live].double(), b[live].double()
        d = (a - b).abs().max().item()
        abs_err = d if i == 0 else abs_err
        rel = max(rel, d / b.abs().max().item())
    return abs_err, rel


# kernels of the quantized decode attention, by name: this kernel, and the
# one-chunk-a-block kernel and its merge that it replaced (for profiles of
# either tree)
ATTENTION_KERNELS = ("quant_attention", "chunk_partial", "chunk_merge")


def qattn_timing(c, full, lengths, q) -> dict:
    """Times of one layer's quantized decode attention at a QATTN_TIMED
    configuration (every slot at the same length):

    - ``ms`` (device time, torch.profiler) and ``graph_ms`` (a CUDA graph
      of 16 calls, between events) of ``chunk_attention``, the chunks'
      flash state; ``wrapper_ms``: its CUDA-event time back to back (the
      host's);
    - ``decode_ms`` / ``decode_graph_ms``: the same for
      ``quant_attention_decode``, the whole layer's attention as the decode
      step runs it (chunks, residual window, combine, normalisation), its
      kernel launches a call and the device time of the attention kernels
      among them;
    - ``plain_ms``, ``decode_plain_ms``: the plain twins;
    - ``library_ms``: ``scaled_dot_product_attention`` over the
      dequantized bf16 K/V of the same live tokens;
    - ``bound_ms``, ``bound_by``: :func:`qattn_bound`.
    It calls only wrappers that the previous tree has too, so that
    ``--qattn-times`` runs in a parent checkout."""
    import torch
    import torch.nn.functional as F

    from microscopiq_tpu_torch.kv.cache import _dequant_k, _dequant_v
    from microscopiq_tpu_torch.ops.cuda import quant_attention as qa

    B, rep, scale = c["B"], QKV_H // QKV_KVH, QKV_HD ** -0.5
    qg = q.reshape(B, QKV_KVH, rep, QKV_HD).contiguous()
    nfull = (lengths // QKV_GAP).to(torch.int32)
    per_call = sum(t.numel() * t.element_size() for t in full)
    nc = copies_for(per_call)
    fulls = [full] + [tuple(t.clone() for t in full) for _ in range(nc - 1)]
    chunk = lambda j: qa.chunk_attention(                    # noqa: E731
        qg, *(t[0] for t in fulls[j][:6]), nfull, scale, QKV_GAP, c["bits"])
    decode = lambda j: qa.quant_attention_decode(            # noqa: E731
        q, fulls[j], 0, lengths, c["v_group"], scale)
    tag = f"quant_attention B={c['B']} C={c['C']}"
    out = {"ms": device_ms(chunk, nc, phase=f"{tag} chunk"),
           "graph_ms": graph_ms(chunk, nc),
           "wrapper_ms": cuda_ms(chunk, nc),
           "decode_ms": device_ms(decode, nc, phase=f"{tag} decode"),
           "decode_graph_ms": graph_ms(decode, nc)}
    by_name, per_call_launches = kernel_split_ms(decode, nc, phase=tag)
    out["decode_launches_per_call"] = per_call_launches
    out["decode_attention_kernels_ms"] = sum(
        t for k, t in by_name.items()
        if any(a in k for a in ATTENTION_KERNELS))
    args = tuple(t[0] for t in full[:6])
    out["plain_ms"] = device_ms(
        lambda j: qa.chunk_attention_reference(qg, *args, nfull, scale,
                                               QKV_GAP, c["bits"]), 1,
        calls=4, phase=f"{tag} chunk plain")
    out["decode_plain_ms"] = device_ms(
        lambda j: qa.quant_attention_decode_reference(
            q, full, 0, lengths, c["v_group"], scale), 1, calls=4,
        phase=f"{tag} decode plain")
    # yardstick: SDPA over the dequantized bf16 K/V of the same live
    # chunk tokens
    kq, kmn, ksc, vq, vmn, vsc = args
    T = int(nfull[0]) * QKV_GAP
    deq = lambda x: x[:, :, :T // QKV_GAP].reshape(          # noqa: E731
        B, QKV_KVH, T, QKV_HD).to(torch.bfloat16).contiguous()
    kd = deq(_dequant_k(kq, kmn, ksc, torch.float32, c["bits"]))
    vd = deq(_dequant_v(vq, vmn, vsc, c["v_group"], torch.float32,
                        c["bits"]))
    nd = copies_for(2 * kd.numel() * 2)
    kvs = [(kd, vd)] + [(kd.clone(), vd.clone()) for _ in range(nd - 1)]
    q4 = q.to(torch.bfloat16)[:, :, None]
    out["library_ms"] = device_ms(
        lambda j: F.scaled_dot_product_attention(
            q4, *kvs[j], scale=scale, enable_gqa=True), nd,
        phase=f"{tag} sdpa")
    out["bound_ms"], out["bound_by"] = qattn_bound(**c)
    return out


def quant_attention_phase(card: str):
    """Phase 6: the quantized-KV decode attention kernel against its plain
    versions, as chunk_attention (the chunks' unnormalised state) and as
    the one-launch quant_attention_decode; timed at the Llama-3-8B decode
    shapes (:func:`qattn_timing`)."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import quant_attention as qa

    rows = []
    scale = QKV_HD ** -0.5
    cases = {**QATTN_TIMED, **QATTN_CHECKED}
    for i, (name, c) in enumerate(cases.items()):
        full, lengths = qattn_state(**c, seed=100 + i)
        kq, kmn, ksc, vq, vmn, vsc = (t[0] for t in full[:6])
        lowrank = tuple(t[0] for t in full[8:]) or None
        B, KVH, H = c["B"], c.get("KVH", QKV_KVH), c.get("H", QKV_H)
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q = torch.randn((B, H, QKV_HD), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        qg = q.reshape(B, KVH, H // KVH, QKV_HD).contiguous()
        nfull = (lengths // QKV_GAP).to(torch.int32)
        args = (kq, kmn, ksc, vq, vmn, vsc, nfull, scale, QKV_GAP, c["bits"])
        got = qa.chunk_attention(qg, *args, lowrank=lowrank)
        want = qa.chunk_attention_reference(qg, *args, lowrank=lowrank)
        torch.cuda.synchronize()
        live = nfull > 0
        abs_err, rel = qattn_errors(got, want, live)
        o, m, l = got
        if not (np.isfinite(rel) and rel < QATTN_REL_TOL):
            raise AssertionError(f"quant_attention {name}: rel err {rel}")
        if (not torch.isfinite(o).all() or o[~live].any() or l[~live].any()
                or not (m[~live] == qa.NEG_INF).all()):
            raise AssertionError(f"quant_attention {name}: empty slots are "
                                 "not finite zeros")
        # the whole decode attention (chunks + residual window + combine)
        dec = qa.quant_attention_decode(q, full, 0, lengths, c["v_group"],
                                        scale).float()
        ref = qa.quant_attention_decode_reference(
            q.float(), full, 0, lengths, c["v_group"], scale)
        on = lengths > 0
        dec_abs = (dec[on] - ref[on]).abs().max().item()
        dec_rel = dec_abs / ref[on].abs().max().item()
        if dec[~on].any() or not torch.isfinite(dec).all():
            raise AssertionError(f"quant_attention_decode {name}: empty "
                                 "slots are not finite zeros")
        if not (np.isfinite(dec_rel) and dec_rel < QATTN_REL_TOL):
            raise AssertionError(f"quant_attention_decode {name}: rel err "
                                 f"{dec_rel}")
        row = dict(kernel="quant_attention", config=name, B=B,
                   kv_heads=KVH, rep=H // KVH,
                   live_tokens=c["lengths"], chunks=c["C"], bits=c["bits"],
                   v_group=c["v_group"], rank=c["rank"],
                   max_abs_err=abs_err, rel_err=rel,
                   decode_max_abs_err=dec_abs, decode_rel_err=dec_rel,
                   tol=QATTN_REL_TOL, card=card)
        if name in QATTN_TIMED:
            row.update(qattn_timing(c, full, lengths, q))
        rows.append(row)
        log(phase="quant_attention_vs_plain", **row)
        del full, got, want
        torch.cuda.empty_cache()
    return rows


QKV_CFG = dict(bits=4, gap=64, v_group=128)


def kv_bytes(state) -> int:
    """Device bytes of a KV-cache state's buffers (length, its host mirror
    and offset left out)."""
    total = 0
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if f.name not in ("length", "offset") and hasattr(t, "numel"):
            total += t.numel() * t.element_size()
    return total


def quant_kv_main_path(packed, card: str):
    """Phase 7: the 32-layer model through a 4-bit KIVI cache at 3k context,
    interleaved with a dense bf16 KV arm at the same context."""
    import torch

    from microscopiq_tpu_torch.kv.cache import (QuantizedDecodeCache,
                                                QuantKVConfig)

    L, B, S0, STEPS = 32, 4, 3072, 64
    qcfg = QuantKVConfig(**QKV_CFG)
    # as scripts/bench_quant_kv.py: 3264 slots, 51 chunks
    max_len = ((S0 + STEPS) // qcfg.gap + 2) * qcfg.gap
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, packed.cfg.vocab_size, (B, S0)), device="cuda")
    for arm in (qcfg, None):                                    # warm-up
        prefill_decode(packed, ids, 2, max_len, quant_cfg=arm)

    # the main path's run: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    info = {}
    main = prefill_decode(packed, ids, STEPS, max_len, quant_cfg=qcfg,
                          info=info)
    toks, ttft, dec, last, pre_counts, dec_counts, state, _ = main
    peak = {"quant": torch.cuda.max_memory_allocated()}
    want_pre = want_counts(dequant_matmul_emi8=4 * L, dequant_gemv_emi8=1)
    want_dec = want_counts(dequant_gemv_emi8=STEPS * (4 * L + 1),
                           quant_attention=STEPS * L)
    if pre_counts != want_pre or dec_counts != want_dec:
        raise AssertionError(f"quant KV launch counts prefill {pre_counts} "
                             f"(want {want_pre}), decode {dec_counts} (want "
                             f"{want_dec})")
    if not torch.isfinite(last.float()).all():
        raise AssertionError("non-finite logits on the quant KV path")
    if not ((toks >= 0) & (toks < packed.cfg.vocab_size)).all():
        raise AssertionError("token ids out of range on the quant KV path")
    if not (int(state.length) == state.host_length == S0 + STEPS):
        raise AssertionError(f"cache length {int(state.length)}, mirror "
                             f"{state.host_length}")
    if not (info["graph"] and info["fold_replays"] == 1):
        raise AssertionError(f"quant KV decode not replayed with its fold "
                             f"graph: {info}")
    quant_eager_ms = graph_vs_eager(packed, ids, STEPS, max_len, "quant_kv",
                                    main, card, quant_cfg=qcfg)
    del main
    ratio = QuantizedDecodeCache(state, qcfg).compression_ratio
    quant_bytes = kv_bytes(state)
    del state

    best = {"quant": (ttft, dec), "dense": (9e9, 9e9)}
    dense_bytes, dense_eager_ms = 0, None
    for arm in ("dense", "quant", "dense", "quant", "dense"):
        torch.cuda.reset_peak_memory_stats()
        out = prefill_decode(packed, ids, STEPS, max_len,
                             quant_cfg=qcfg if arm == "quant" else None)
        peak[arm] = max(peak.get(arm, 0), torch.cuda.max_memory_allocated())
        best[arm] = (min(best[arm][0], out[1]), min(best[arm][1], out[2]))
        if arm == "dense":
            dense_bytes = kv_bytes(out[6])
            if dense_eager_ms is None:
                dense_eager_ms = graph_vs_eager(packed, ids, STEPS, max_len,
                                                "quant_kv_dense", out, card)
        del out
    tps = {a: B * STEPS / best[a][1] for a in best}
    path = dict(layers=L, batch=B, prompt=S0, steps=STEPS, max_len=max_len,
                quant_cfg=QKV_CFG, graph=True, dense_graph=True,
                fold_replays=info["fold_replays"],
                eager_decode_ms_per_step=quant_eager_ms,
                decode_tokens_per_s=tps["quant"],
                decode_ms_per_step=best["quant"][1] / STEPS * 1e3,
                ttft_ms=best["quant"][0] * 1e3,
                dense_decode_tokens_per_s=tps["dense"],
                dense_decode_ms_per_step=best["dense"][1] / STEPS * 1e3,
                dense_eager_decode_ms_per_step=dense_eager_ms,
                dense_ttft_ms=best["dense"][0] * 1e3,
                quant_vs_dense_decode=tps["quant"] / tps["dense"],
                quant_kv_bytes=quant_bytes, dense_kv_bytes=dense_bytes,
                dense_over_quant_kv_bytes=dense_bytes / quant_bytes,
                compression_ratio=ratio,
                peak_mem_gb_quant=peak["quant"] / 1e9,
                peak_mem_gb_dense=peak["dense"] / 1e9,
                launches_prefill=pre_counts, launches_decode=dec_counts,
                card=card)
    log(phase="quant_kv_main_path", **path)
    prof = decode_device_profile(packed, ids, max_len,
                                 path["decode_ms_per_step"], quant_cfg=qcfg)
    log(phase="quant_decode_profile",
        profile=prof if prof else "not measured", card=card)
    torch.cuda.empty_cache()
    return {"prefill": pre_counts, "decode": dec_counts}, path


def quant_kv_step_times() -> dict:
    """The quant-KV arm's replayed decode alone (quant_kv_main_path's
    32-layer MX-FP6 model, B = 4, 3072-token prompt, 64 steps): the best of
    two runs' ms a step and the replayed steps' decode profile."""
    import torch

    from microscopiq_tpu_torch.kv.cache import QuantKVConfig

    packed, _ = build(True, layers=32, seed=0)
    B, S0, STEPS = 4, 3072, 64
    qcfg = QuantKVConfig(**QKV_CFG)
    max_len = ((S0 + STEPS) // qcfg.gap + 2) * qcfg.gap
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, packed.cfg.vocab_size, (B, S0)), device="cuda")
    prefill_decode(packed, ids, 2, max_len, quant_cfg=qcfg)       # warm-up
    best = min(prefill_decode(packed, ids, STEPS, max_len,
                              quant_cfg=qcfg)[2] for _ in range(2))
    step_ms = best / STEPS * 1e3
    prof = decode_device_profile(packed, ids, max_len, step_ms,
                                 quant_cfg=qcfg)
    del packed
    torch.cuda.empty_cache()
    return dict(decode_ms_per_step=step_ms,
                profile=prof if prof else "not measured")


def qattn_times() -> dict:
    """``python3 chip_smoke.py --qattn-times``: the attention rows of
    :func:`qattn_timing` at QATTN_TIMED, the W8A8 rows of
    :func:`s8_timing` at gate_up (M = 8, 64; int8, sb4, sb2) and the
    quant-KV arm's replayed step (:func:`quant_kv_step_times`). It calls
    only wrappers that the previous tree has too: copy this script into a
    parent checkout to compare the two on one card."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk

    attention = []
    for i, (name, c) in enumerate(QATTN_TIMED.items()):
        full, lengths = qattn_state(**c, seed=100 + i)
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q = torch.randn((c["B"], QKV_H, QKV_HD), generator=gen,
                        device="cuda").to(torch.bfloat16)
        attention.append(dict(config=name,
                              **qattn_timing(c, full, lengths, q)))
        del full
        torch.cuda.empty_cache()
    w8a8, K, N = [], 4096, 28672
    gen = torch.Generator(device="cuda").manual_seed(4008)
    for case, (fmt, transport, bs) in S8_CASES.items():
        W = int_weight(fmt, (K, N), gen)
        p = pk.to_serving_layout(pk.pack_mx(W.float(), 8, fmt, bs, axis=0,
                                            transport=transport))
        del W
        nc = copies_for(p.nbytes())
        ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
        for M in (8, 64):
            x = torch.randn((M, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            w8a8.append(dict(case=case, linear="gate_up", M=M,
                             **s8_timing(x, ps, nc)))
        del ps, p
        torch.cuda.empty_cache()
    return dict(attention=attention, w8a8=w8a8,
                quant_kv=quant_kv_step_times())


def quant_two_layer_phase(card: str):
    """Phase 8: a 2-layer full-width model over a quantized cache, through
    the kernels against the plain versions (cache.update), on the same
    token stream: a 120-token prompt and 8 decode steps, one of which
    folds a chunk."""
    import torch

    from microscopiq_tpu_torch.kv.cache import QuantKVConfig

    B, S0, STEPS, max_len = 4, 120, 8, 192
    qcfg = QuantKVConfig(**QKV_CFG)
    two_k, tree = build(True, layers=2, seed=2)
    two_p, _ = build(True, layers=2, use_kernels=False, tree=tree)
    ids = torch.as_tensor(np.random.default_rng(4).integers(
        0, two_k.cfg.vocab_size, (B, S0)), device="cuda")
    toks, *_, first = prefill_decode(two_k, ids, STEPS, max_len,
                                     quant_cfg=qcfg)
    feed = torch.cat([torch.argmax(first[0][:, -1], -1)[:, None],
                      toks[:, :-1]], 1)
    run = prefill_decode(two_k, ids, STEPS, max_len, quant_cfg=qcfg,
                         feed=feed)
    got, counts = run[7], {k: v for k, v in run[5].items() if v}
    want = prefill_decode(two_p, ids, STEPS, max_len, quant_cfg=qcfg,
                          feed=feed)[7]
    # the cache.update route (the plain model) replayed from its graphs,
    # the fold step's included, against its eager run
    info = {}
    plain = prefill_decode(two_p, ids, STEPS, max_len, quant_cfg=qcfg,
                           info=info)
    if not (info["graph"] and info["fold_replays"] == 1):
        raise AssertionError(f"2-layer quant decode not replayed with its "
                             f"fold graph: {info}")
    graph_vs_eager(two_p, ids, STEPS, max_len, "quant_two_layer_update",
                   plain, card, quant_cfg=qcfg)
    if counts.get("quant_attention") != 2 * STEPS:
        raise AssertionError(f"2-layer quant decode launches {counts}")
    errs = []
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        errs.append(((a - b).abs().max() / b.abs().max()).item())
    log(phase="quant_two_layer_logits", rel_err_per_call=errs,
        max_rel_err=max(errs), tol=LOGIT_REL_TOL, launches=counts, card=card)
    if not all(np.isfinite(e) and e < LOGIT_REL_TOL for e in errs):
        raise AssertionError(f"2-layer quant logits: rel err {errs}")
    del two_k, two_p, tree
    torch.cuda.empty_cache()


def quant_engine_phase(model, card: str):
    """Phase 9: continuous batching over the quantized slot cache; each
    request against the same request alone in a 1-slot quant engine."""
    import torch

    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.serve.engine import BatchEngine

    qcfg = QuantKVConfig(**QKV_CFG)
    mk = lambda n: BatchEngine(model, n_slots=n, max_len=256,
                               prompt_buckets=(32, 64, 128),
                               cache_kind="quant", quant_cfg=qcfg,
                               device="cuda")
    eng = mk(4)
    reset_counts()
    reqs, news, wall = serve_six(eng, model.cfg.vocab_size)
    counts = {k: v for k, v in launches().items()
              if k in ("dequant_gemv_emi8", "dequant_matmul_emi8",
                       "quant_attention")}
    if min(counts.values()) == 0:
        raise AssertionError(f"quant engine did not use every kernel: "
                             f"{counts}")
    del eng
    one = mk(1)
    agree = total = 0
    for r, t in zip(reqs, news):
        alone = one.generate([r.prompt_ids], max_new_tokens=t)[0]
        if alone != r.out_tokens:
            raise AssertionError(f"request of {len(r.prompt_ids)} tokens: "
                                 f"4-slot {r.out_tokens} vs 1-slot {alone}")
        ref = generate(model, [r.prompt_ids.tolist()], t, cache_kind="quant",
                       quant_cfg=qcfg)[0].tolist()
        agree += sum(a == b for a, b in zip(r.out_tokens, ref))
        total += t
    log(phase="quant_engine", requests=len(reqs), tokens=total, wall_s=wall,
        tokens_per_s=total / wall, launches=counts,
        identical_to_one_slot_engine=len(reqs),
        token_agreement_with_single_sequence_generate=agree / total,
        card=card)
    del one
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# H2O and sink caches, the GEAR codecs, the trace readers and the
# host codec, on the 32-layer MX-FP6 model of phase 4
# ---------------------------------------------------------------------------
H2O_BUDGET, H2O_RECENT = 144, 16     # main path: 128 + 48 tokens, 32 evicted
H2O_ENGINE = dict(n_slots=4, budget=144, recent=16, new=64, requests=6,
                  prompt=(96, 128))  # 160-192 tokens a request: all evict
SINK_TOKENS, SINK_SLOTS = 4, 192     # 128 + 96 tokens: 32 evictions
GEAR_SHAPE = (4, 8, 3072, 128)       # the quant-KV arm's K/V, (B, H, S, D)
GEAR_CFG = dict(quantize_bit=4, group_size=64, rank=2, loop=3, left=0.02)
GEAR_METHODS = ("channelQfixed", "tokenQfixed", "kcvtQfixed", "KIVI",
                "GEARL-KIVI", "GEARS-KIVI", "Flexgen", None, "None")
# GEAR codecs, card against CPU, of max |CPU|: their element-wise float32
# arithmetic is IEEE on both and their top-k a stable sort; the low-rank
# products sum in other orders, and a bf16 output may round one ulp
# (2^-8 of the largest value) apart; two allowed
GEAR_REL_TOL = 2 ** -7
HOST_CODEC_SHAPE = (4096, 28672)     # gate_up


class CacheRecorder:
    """Passes every call on to ``cache``; records device copies of the
    (k, v, positions) of ``update`` and the probs of ``observe`` at
    ``layers`` into ``log``."""

    def __init__(self, cache, log):
        self.cache, self.log = cache, log

    def update(self, li, k, v, positions, mask):
        if li in self.log:
            self.log[li].append(("update", k.clone(), v.clone(),
                                 positions.clone()))
        return self.cache.update(li, k, v, positions, mask)

    def observe(self, li, probs):
        if li in self.log:
            self.log[li].append(("observe", probs.clone()))
        self.cache.observe(li, probs)

    def finalize(self):
        return self.cache.finalize()


def cache_decode(model, ids, steps: int, state, wrap, positions=None,
                 on_step=None):
    """A ``last_only`` prefill, then ``steps`` eager greedy decode steps,
    each through a fresh ``wrap(state)``. A step's query positions are
    ``positions(cache, t)`` (default: its token's index t); ``on_step(t,
    state)`` runs before step t. Returns (tokens (B, 1 + steps), the
    prefill's first, host ms a decode step, final state, last logits, the
    prefill's logits)."""
    import torch

    B, S0 = ids.shape
    pos_of = positions or (lambda c, t: torch.full((B, 1), t, device="cuda"))
    with torch.inference_mode():
        cache = wrap(state)
        logits = model(ids, positions=torch.arange(
            S0, device="cuda").expand(B, S0), cache=cache, last_only=True)
        state = cache.finalize()
        first = logits
        tok = torch.argmax(logits[:, -1], dim=-1)
        toks = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(S0, S0 + steps):
            if on_step is not None:
                on_step(t, state)
            cache = wrap(state)
            logits = model(tok[:, None], positions=pos_of(cache, t),
                           cache=cache)
            state = cache.finalize()
            tok = torch.argmax(logits[:, -1], dim=-1)
            toks.append(tok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3 if steps else None
    return torch.stack(toks, 1), ms, state, logits, first


def _check_tokens(name, toks, logits, vocab):
    import torch

    if not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{name}: non-finite logits")
    if not ((toks >= 0) & (toks < vocab)).all():
        raise AssertionError(f"{name}: token ids out of range")


def h2o_engine_phase(model, card: str):
    """``BatchEngine(cache_kind="h2o")``: six requests of 96-128 prompt
    tokens asking for 64 new ones through 4 slots of a 144-token budget
    (every slot evicts), each answered in full; one of them token-identical
    to a 1-slot H2O engine; and with a budget no request outgrows, the H2O
    engine token-identical to the dense one. Returns the launch counts."""
    import torch

    from microscopiq_tpu_torch.serve.engine import BatchEngine, Request
    from microscopiq_tpu_torch.utils.observability import metrics

    c = H2O_ENGINE
    rng = np.random.default_rng(16)
    lens = rng.integers(c["prompt"][0], c["prompt"][1] + 1, c["requests"])
    reqs = [Request(rng.integers(0, model.cfg.vocab_size, (n,)).astype(
        np.int64), c["new"]) for n in lens]
    mk = lambda n, **kw: BatchEngine(
        model, n_slots=n, max_len=512, prompt_buckets=(32, 64, 128),
        device="cuda", **kw)
    h2o = dict(cache_kind="h2o", h2o_budget=c["budget"],
               h2o_recent=c["recent"])
    eng = mk(c["n_slots"], **h2o)
    torch.cuda.reset_peak_memory_stats()
    steps0 = len(metrics.timers["engine.decode_step"])
    reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    steps = len(metrics.timers["engine.decode_step"]) - steps0
    peak = torch.cuda.max_memory_allocated()
    kv = kv_bytes(eng.state)
    evicted = int((eng.state.pos >= c["budget"]).sum())
    for r in reqs:
        if r.error is not None or len(r.out_tokens) != c["new"]:
            raise AssertionError(f"h2o engine: a request of "
                                 f"{len(r.prompt_ids)} tokens got "
                                 f"{len(r.out_tokens)}/{c['new']} tokens, "
                                 f"error {r.error}")
    del eng
    one = mk(1, **h2o)
    for r in reqs[:1]:
        alone = one.generate([r.prompt_ids], max_new_tokens=c["new"])[0]
        if alone != r.out_tokens:
            raise AssertionError("h2o engine: 4-slot and 1-slot tokens "
                                 "differ")
    del one
    # a budget that no request outgrows keeps every token: dense tokens
    prompts, new = [r.prompt_ids for r in reqs[:2]], 64
    kw = dict(cache_kind="h2o", h2o_budget=256)
    got = BatchEngine(model, n_slots=2, max_len=256, device="cuda",
                      prompt_buckets=(32, 64, 128), **kw).generate(
        prompts, max_new_tokens=new)
    want = BatchEngine(model, n_slots=2, max_len=256, device="cuda",
                       prompt_buckets=(32, 64, 128)).generate(
        prompts, max_new_tokens=new)
    if got != want:
        raise AssertionError("h2o engine with an unconstrained budget "
                             "differs from the dense engine")
    counts = {k: counts[k] + v for k, v in launches().items()}
    if not (counts["dequant_gemv_emi8"] and counts["dequant_matmul_emi8"]):
        raise AssertionError(f"h2o engine did not use both kernels: {counts}")
    tokens = c["requests"] * c["new"]
    log(phase="h2o_engine", requests=len(reqs), slots=c["n_slots"],
        prompt_tokens=[int(n) for n in lens], new_tokens=c["new"],
        budget=c["budget"], recent=c["recent"], wall_s=wall,
        decode_steps=steps, tokens_per_s=tokens / wall,
        ms_per_step=wall / steps * 1e3, kv_bytes=kv,
        slots_holding_evicting_writes=evicted, peak_mem_gb=peak / 1e9,
        identical_to_one_slot_engine=1,
        unconstrained_equal_to_dense=len(prompts),
        launches={k: v for k, v in counts.items() if v}, card=card)
    return {"prefill": want_counts(), "decode": counts}


def h2o_main_path(model, card: str):
    """B = 4, a 128-token prompt and 48 eager greedy steps through
    ``H2OCache``: with the budget at the dense run's length, the dense
    cache's tokens; at a budget of 144 (32 evictions a layer), the slots
    kept in layers 0 and 31 equal a CPU replay of the cache fed the (k, v,
    probs) recorded on the card; ``QuantH2OCache`` (4 bits) at that budget
    beside it. Returns the launch counts."""
    import torch

    from microscopiq_tpu_torch.kv import h2o

    cfg = model.cfg
    L, B, S0, STEPS = cfg.num_hidden_layers, 4, 128, 48
    kv = (cfg.num_key_value_heads, cfg.head_dim)
    ids = torch.as_tensor(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (B, S0)), device="cuda")
    max_len = S0 + STEPS
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dense = prefill_decode(model, ids, STEPS, max_len)
    pre, dec = dense[4], dense[5]
    reset_counts()
    wrap = lambda st: h2o.H2OCache(st, H2O_RECENT)
    full, full_ms, *_ = cache_decode(
        model, ids, STEPS,
        h2o.init_h2o_cache(L, B, max_len, *kv, device="cuda"), wrap)
    as_dense = bool(torch.equal(full[:, 1:], dense[0]))
    rec = {0: [], L - 1: []}
    toks, ms, state, logits, first = cache_decode(
        model, ids, STEPS,
        h2o.init_h2o_cache(L, B, H2O_BUDGET, *kv, device="cuda"),
        lambda st: CacheRecorder(wrap(st), rec))
    _check_tokens("h2o_main_path", toks, logits, cfg.vocab_size)
    qtoks, qms, qstate, qlogits, qfirst = cache_decode(
        model, ids, STEPS,
        h2o.init_quant_h2o_cache(L, B, H2O_BUDGET, *kv, bits=4,
                                 device="cuda"),
        lambda st: h2o.QuantH2OCache(st, H2O_RECENT))
    _check_tokens("quant h2o", qtoks, qlogits, cfg.vocab_size)
    eager = launches()
    peak = torch.cuda.max_memory_allocated()
    want = want_counts(dequant_matmul_emi8=3 * 4 * L,
                       dequant_gemv_emi8=3 * (1 + STEPS * (4 * L + 1)))
    if eager != want:
        raise AssertionError(f"h2o main path launches {eager}, want {want}")
    replay = {}
    for li, events in rec.items():
        st = h2o.init_h2o_cache(1, B, H2O_BUDGET, *kv, device="cpu")
        for ev in events:
            if ev[0] == "update":
                c = h2o.H2OCache(st, H2O_RECENT)
                c.update(0, *(t.cpu() for t in ev[1:]), None)
            else:
                c.observe(0, ev[1].cpu())
                st = c.finalize()
        replay[li] = dict(
            positions_equal=bool(torch.equal(st.pos[0],
                                             state.pos[li].cpu())),
            scores_equal=bool(torch.equal(st.score[0],
                                          state.score[li].cpu())),
            kept_from_evicting_steps=int((state.pos[li] >= H2O_BUDGET).sum()),
            slots_full=bool((state.pos[li] >= 0).all()))
    dense_bytes = kv_bytes(dense[6])
    log(phase="h2o_main_path", layers=L, batch=B, prompt=S0, steps=STEPS,
        budget=H2O_BUDGET, recent=H2O_RECENT,
        evictions_per_row_and_layer=S0 + STEPS - H2O_BUDGET,
        tokens_equal_dense_at_full_budget=as_dense,
        full_budget_ms_per_step=full_ms, ms_per_step=ms,
        dense_graph_ms_per_step=dense[2] / STEPS * 1e3,
        cpu_replay=replay, quant_bits=4, quant_ms_per_step=qms,
        quant_token_agreement=(qtoks == toks).float().mean().item(),
        quant_prefill_logits_rel_err=((qfirst.float() - first.float()).abs(
        ).max() / first.float().abs().max()).item(),
        kv_bytes=kv_bytes(state), quant_kv_bytes=kv_bytes(qstate),
        dense_kv_bytes=dense_bytes, peak_mem_gb=peak / 1e9,
        launches_eager=eager, card=card)
    if not as_dense:
        raise AssertionError("H2O at the dense length differs from dense")
    if not all(r["positions_equal"] and r["scores_equal"] and r["slots_full"]
               for r in replay.values()):
        raise AssertionError(f"H2O slots differ from the CPU replay: "
                             f"{replay}")
    return {"prefill": pre, "decode": {k: dec[k] + eager[k] for k in dec}}


def sink_main_path(model, card: str):
    """B = 4, ``SinkDecodeCache`` (4 sink tokens, 192 slots), a 128-token
    prompt and 96 decode steps at the clamped slot positions (32
    evictions): the first evicting step's re-rotated keys (layer 0) against
    ``_rope_delta`` of the same keys on the CPU. Returns the launch
    counts."""
    import torch

    from microscopiq_tpu_torch.kv import sink as sk

    cfg = model.cfg
    L, B, S0, STEPS = cfg.num_hidden_layers, 4, 128, 96
    C, ns = SINK_SLOTS, SINK_TOKENS
    ids = torch.as_tensor(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (B, S0)), device="cuda")
    snaps = {}

    def on_step(t, st):
        if t in (C, C + 1):               # before and after the first evict
            snaps[t] = st.k[0].clone()

    reset_counts()
    toks, ms, state, logits, _ = cache_decode(
        model, ids, STEPS,
        sk.init_sink_cache(L, B, ns, C - ns, cfg.num_key_value_heads,
                           cfg.head_dim, device="cuda"),
        lambda st: sk.SinkDecodeCache(st, ns, cfg.rope_theta),
        positions=lambda c, t: c.slot_positions(1)[None, :].expand(B, 1),
        on_step=on_step)
    counts = launches()
    _check_tokens("sink_main_path", toks, logits, cfg.vocab_size)
    want = sk._rope_delta(snaps[C][:, ns + 1:].cpu(), -1.0,
                          cfg.rope_theta).float()
    got = snaps[C + 1][:, ns:C - 1].cpu().float()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    sinks = bool(torch.equal(snaps[C + 1][:, :ns], snaps[C][:, :ns]))
    log(phase="sink_main_path", layers=L, batch=B, prompt=S0, steps=STEPS,
        sink_tokens=ns, slots=C, evictions=S0 + STEPS - C,
        length=state.host_length, ms_per_step=ms,
        rerotation_max_abs_err=err, rerotation_rel_err=rel,
        rerotation_equal_share=(got == want).float().mean().item(),
        tol=GEAR_REL_TOL, sinks_kept=sinks,
        launches={k: v for k, v in counts.items() if v}, card=card)
    if not (sinks and rel <= GEAR_REL_TOL
            and state.host_length == int(state.length) == S0 + STEPS):
        raise AssertionError(f"sink cache: rel err {rel}, sinks kept {sinks}")
    if counts != want_counts(dequant_matmul_emi8=4 * L,
                             dequant_gemv_emi8=1 + STEPS * (4 * L + 1)):
        raise AssertionError(f"sink main path launches {counts}")
    return {"prefill": want_counts(), "decode": counts}


def gear_codecs_phase(card: str):
    """``compress_insert`` in each of its nine methods and
    ``true_gear_compress``/``true_gear_decompress`` on bf16 K/V of the
    quant-KV arm's shape, on the card against the same calls on the CPU
    (restored tensors, never the factors), timed, beside
    ``CompressionConfig.compress_ratio``."""
    import torch

    from microscopiq_tpu_torch.kv import CompressionConfig, gear

    gen = torch.Generator(device="cuda").manual_seed(16)
    k, v = (torch.randn(GEAR_SHAPE, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    kc, vc = k.cpu(), v.cpu()
    B, H, S, D = GEAR_SHAPE

    def compare(got, want):
        got, want = got.cpu().float(), want.float()
        err = (got - want).abs().max().item()
        return err, err / want.abs().max().item(), (
            got == want).float().mean().item()

    rows = []
    for method in GEAR_METHODS:
        cfg = CompressionConfig(compress_method=method, attention_number=1,
                                **GEAR_CFG).copy_for_all_attention()
        gk, gv = gear.compress_insert(k, v, cfg, 0)
        t0 = time.perf_counter()
        ck, cv = gear.compress_insert(kc, vc, cfg, 0)
        cpu_s = time.perf_counter() - t0
        ek, rk, fk = compare(gk, ck)
        ev, rv, fv = compare(gv, cv)
        ms = cuda_ms(lambda i: gear.compress_insert(k, v, cfg, 0), 1,
                     target_ms=20.0)
        rows.append(dict(method=method, ms=ms, cpu_s=cpu_s,
                         max_abs_err=max(ek, ev), rel_err=max(rk, rv),
                         equal_share=min(fk, fv),
                         config_ratio=cfg.compress_ratio(S, H * D)))
    bits, left, rank, loop = 4, GEAR_CFG["left"], GEAR_CFG["rank"], 3
    g = gear.true_gear_compress(k, bits, left, rank, loop)
    restored = gear.true_gear_decompress(g, torch.bfloat16)
    t0 = time.perf_counter()
    gc = gear.true_gear_compress(kc, bits, left, rank, loop)
    cpu_s = time.perf_counter() - t0
    err, rel, eq = compare(restored, gear.true_gear_decompress(
        gc, torch.bfloat16))
    ms = cuda_ms(lambda i: gear.true_gear_compress(k, bits, left, rank,
                                                   loop), 1, target_ms=20.0)
    dms = cuda_ms(lambda i: gear.true_gear_decompress(g, torch.bfloat16), 1,
                  target_ms=20.0)
    nbytes = sum(t.numel() * t.element_size() for t in (
        g.base.codes, g.base.mn, g.base.scale, g.out_values, g.out_indices,
        g.p, g.q))
    cfg = CompressionConfig(compress_method="GEAR", quantize_bit=bits,
                            group_size=0, rank=rank, left=left)
    rows.append(dict(method="true_gear", ms=ms, decompress_ms=dms,
                     cpu_s=cpu_s, max_abs_err=err, rel_err=rel,
                     equal_share=eq, ratio=nbytes / (k.numel() * 2),
                     config_ratio=cfg.compress_ratio(S, H * D)))
    for r in rows:
        log(phase="gear_codecs", shape=list(GEAR_SHAPE), dtype="bfloat16",
            tol=GEAR_REL_TOL, **r, card=card)
    bad = [r["method"] for r in rows
           if not (np.isfinite(r["rel_err"]) and r["rel_err"] <= GEAR_REL_TOL)]
    if bad:
        raise AssertionError(f"GEAR codecs differ on the card: {bad}")


def trace_stats_phase(model, card: str):
    """``utils.observability.trace`` around 7 replays of the 32-layer MX-FP6
    decode step (B = 8): ``device_kernel_stats`` counts the GEMV launches
    that the captured step implies, ``device_busy_us`` lies between the
    GEMV's total and the replays' wall time; ``decode_token_stats`` of 22
    replayed steps timed one by one; the busy share beside
    ``decode_device_profile``'s. Returns the launch counts."""
    import functools
    import tempfile

    import torch

    from microscopiq_tpu_torch.eval.generate import DecodeStep
    from microscopiq_tpu_torch.utils import observability as ob

    B, S0, STEPS, CALLS = 8, 128, 8, 24
    max_len = S0 + 32 + 8
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (B, S0)), device="cuda")
    reset_counts()
    info = {}
    with tempfile.TemporaryDirectory() as d:
        run = prefill_decode(model, ids, STEPS, max_len, info=info,
                             decode_ctx=functools.partial(ob.trace, d))
        pre, dec = run[4], run[5]
        replays = info["timed_steps"]
        per_step = {k: n // STEPS for k, n in dec.items()}
        want = per_step["dequant_gemv_emi8"] * replays
        stats = ob.device_kernel_stats(d, min_events=want)
        gemv = {k: a for k, a in stats.items() if "gemv_tc" in k}
        gemv_n = sum(a["count"] for a in gemv.values())
        gemv_us = sum(a["total_us"] for a in gemv.values())
        busy = ob.device_busy_us(d)
        lead, tail = ob.filler_kept(d)
        rows = sorted({proc for proc, ev in ob._iter_trace_events(d)
                       if ev.get("cat") == "kernel"})
        top = sorted(stats.items(), key=lambda kv: -kv[1]["total_us"])[:6]
    wall_us = run[2] / STEPS * replays * 1e6
    before = launches()
    out = prefill_decode(model, ids, 1, max_len)
    step = DecodeStep(model, out[6], out[0][:, -1])
    times = []
    with torch.inference_mode():
        for _ in range(CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    # the step's kernels launch once eagerly and once at its capture; the
    # later replays launch what the capture recorded
    timed = {k: n - before[k] + per_step[k] * (CALLS - 2)
             for k, n in launches().items()}
    tok_stats = ob.decode_token_stats(times[2:], B)
    prof = decode_device_profile(model, ids, max_len,
                                 tok_stats["median_s"] * 1e3)
    log(phase="trace_stats", replays=replays, batch=B,
        gemv_events=gemv_n, gemv_launches_implied=want,
        gemv_device_us=gemv_us, device_busy_us=busy, window_wall_us=wall_us,
        busy_share=busy / wall_us,
        decode_profile_busy_share=(prof["busy_share_of_profiled_wall"]
                                   if prof else "not measured"),
        filler_kept=[lead, tail], kernel_rows=rows,
        top_kernels_us=[(k[:60], a["total_us"]) for k, a in top],
        decode_token_stats=tok_stats, card=card)
    if not (gemv_n == want and gemv_us <= busy <= wall_us
            and lead > 0 and tail > 0):
        raise AssertionError(f"trace: {gemv_n} GEMV events of {want}, busy "
                             f"{busy} us of {wall_us}, GEMV {gemv_us} us, "
                             f"filler kept {lead}/{tail}")
    return {"prefill": pre, "decode": {k: dec[k] + timed[k] for k in dec}}


def host_codec_phase(card: str):
    """The port's g++-built ``pack_mx_native`` against ``pack_mx``
    (exact scales, on the card) at gate_up, fp6_e3m2, block 32: codes and
    scales bit-equal; seconds a call."""
    import torch

    from microscopiq_tpu_torch import native
    from microscopiq_tpu_torch.ops import packing as pk

    K, N = HOST_CODEC_SHAPE
    t0 = time.perf_counter()
    native.get_lib()                        # builds here; raises on failure
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(18)
    W = torch.randn((K, N), generator=gen, device="cuda") * 0.02
    p = pk.pack_mx(W, 8, "fp6_e3m2", 32, exact_scale=True)
    card_ms = cuda_ms(lambda i: pk.pack_mx(W, 8, "fp6_e3m2", 32,
                                           exact_scale=True), 1)
    Wc = W.cpu().numpy()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        codes, scales = native.pack_mx_native(Wc, 8, "fp6_e3m2", 32)
        secs.append(time.perf_counter() - t0)
    same = (np.array_equal(codes, p.codes.view(torch.uint8).cpu().numpy())
            and np.array_equal(scales, p.scale_exp.cpu().numpy()))
    log(phase="host_codec", shape=[K, N], format="fp6_e3m2", block=32,
        bit_equal=bool(same), native_s=min(secs), native_s_runs=secs,
        threads=min(16, os.cpu_count() or 1),
        build_s=build_s, pack_mx_card_ms=card_ms, card=card)
    if not same:
        raise AssertionError("pack_mx_native differs from pack_mx")


# ---------------------------------------------------------------------------
# Slice 3: the MicroScopiQ outlier weight formats
# ---------------------------------------------------------------------------
# int2 inliers, fp4 outliers, block 16, 8-bit scales at both levels,
# outliers at 2 sigma; every linear quantized, the lm_head included
OUTLIER_SPECS = {"w_elem_format": "int2", "w_outlier_elem_format": "fp4_e2m1",
                 "scale_bits": 8, "block_size": 16, "outlier_std_dev": 2.0}
NB_BUDGET, SIDEBAND_BUDGET = 2, 4
# the three transports pack_params can produce: (keywords, fused projections)
OUTLIER_ARMS = {
    "nb": (dict(outlier_transport="compact", outlier_budget=NB_BUDGET), True),
    "sideband": (dict(outlier_transport="sideband",
                      outlier_budget=SIDEBAND_BUDGET), False),
    "emi8m": (dict(outlier_budget=SIDEBAND_BUDGET), True)}
OUTLIER_M = (1, 8, 64, 255)
OUTLIER_PHASE_M = (8, 64, 255)   # and M = 1 at M1_LINEAR (with_m1)
OUTLIER_GEMM_M = (256, 1024)
# outlier GEMVs vs plain: exact weights and products, f32 sums in another
# order -> the GEMV's 1e-5 (no tensor cores); the outlier GEMMs feed the
# same bf16 weights to the tensor cores -> the GEMM's 2e-3
OUTLIER_REL_TOL = 1e-5


def outlier_weight(shape, gen):
    """N(0, 0.02) bf16 weights with 3% of the elements scaled by 10, as
    scripts/bench_outlier_gemv.py:77-78 makes its outlier mass."""
    import torch

    w = torch.randn(shape, generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.02
    hit = torch.rand(shape, generator=gen, device="cuda") < 0.03
    return torch.where(hit, w * 10, w)


def nb_decisions(w):
    """RTN decisions of a (K, N) kernel for the compact transport, as
    scripts/nb_capacity.py:94-99 makes them: on the (N, K) transpose with
    axes=[0], block 16, at most NB_BUDGET outliers per block. Blocks run
    along N, so chunks of whole blocks along N give the same decisions and
    bound the quantizer's float32 temporaries."""
    import torch

    from microscopiq_tpu_torch.ops.outlier import (
        quantize_mx_outlier_hessian_decisions)

    wt = w.T
    N, K = wt.shape
    step = max(16, (1 << 25) // K // 16 * 16)
    parts = []
    for i in range(0, N, step):
        _, _, d = quantize_mx_outlier_hessian_decisions(
            wt[i:i + step].to(torch.float32), 8, 8, "int2", "fp4_e2m1",
            "max", 2.0, [0], 16, max_outliers_per_block=NB_BUDGET)
        d["mask"] = d["mask"] != 0
        parts.append(d)
    dec = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    dec["block_size"] = 16
    return dec


def outlier_tree(arm, layers, seed):
    """Llama-3-8B weights at full width and ``layers`` deep, seeded on the
    card, every linear packed by the port's ``nn.pack_params`` in ``arm``'s
    transport (layer by layer, so that only one layer's bf16 weights and
    decisions exist at a time), then ``nn.fuse_projections`` where the arm
    fuses. Returns (config, tree)."""
    import torch

    from microscopiq_tpu_torch.models.llama import LlamaConfig
    from microscopiq_tpu_torch.nn import (find_linear_params,
                                          fuse_projections, pack_params)
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    kw, fused = OUTLIER_ARMS[arm]
    specs = finalize_mx_specs(OUTLIER_SPECS)
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers,
                                dtype=torch.bfloat16,
                                fused_projections=fused)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def pack(sub):
        dec = None
        if arm == "nb":
            dec = {path: nb_decisions(w) for path, w in
                   find_linear_params(sub, skip=()).items()}
        return pack_params(sub, specs, skip=(), decisions=dec, **kw)

    k = lambda shape: {"kernel": outlier_weight(shape, gen)}
    ones = lambda: torch.ones(D, dtype=cfg.dtype, device="cuda")
    model = {"embed_tokens": (torch.randn((V, D), generator=gen,
                                          device="cuda",
                                          dtype=torch.bfloat16) * 0.02)}
    for i in range(layers):
        model[f"layers_{i}"] = {
            **pack({"self_attn": {"q_proj": k((D, H * hd)),
                                  "k_proj": k((D, KVH * hd)),
                                  "v_proj": k((D, KVH * hd)),
                                  "o_proj": k((H * hd, D))},
                    "mlp": {"gate_proj": k((D, I)), "up_proj": k((D, I)),
                            "down_proj": k((I, D))}}),
            "input_layernorm": {"scale": ones()},
            "post_attention_layernorm": {"scale": ones()}}
    model["norm"] = {"scale": ones()}
    tree = {"model": model, "lm_head": pack({"lm_head": k((D, V))})["lm_head"]}
    return cfg, (fuse_projections(tree) if fused else tree)


def outlier_model(arm, layers, seed, use_kernels=True, tree=None):
    """(model, tree, transport of its kernels) for one arm."""
    from microscopiq_tpu_torch.models.llama import LlamaForCausalLM
    from microscopiq_tpu_torch.ops import packing as pk

    cfg, built = outlier_tree(arm, layers, seed) if tree is None else tree
    model = LlamaForCausalLM(cfg, use_kernels=use_kernels,
                             device="cuda").load_params(built)
    kinds = set()
    for m in model.modules():
        w = getattr(m, "kernel", None)
        if isinstance(w, pk.PackedMX):
            kinds.add(w.transport)
        elif w is not None:
            kinds.add(type(w).__name__)
    want = {"nb": {"PackedOutlierNB"}, "sideband": {"PackedMXOutlier"},
            "emi8m": {"emi8m"}}[arm]
    if kinds != want:
        raise AssertionError(f"{arm} arm packed to {kinds}, want {want}")
    return model, (cfg, built)


def weight_stats(model):
    """(packed bytes of the linears, their bits per weight element); dense
    kernels are left out."""
    import torch

    total = elems = 0
    for m in model.modules():
        w = getattr(m, "kernel", None)
        if w is None or isinstance(w, torch.Tensor):
            continue
        total += w.nbytes()
        if hasattr(w, "orig_n"):
            elems += w.orig_n * w.orig_k
        else:
            inl = getattr(w, "inlier", w)
            elems += inl.orig_dim * inl.codes.shape[-1]
    return total, total * 8 / elems


def outlier_kernel_phase(card: str):
    """The NB and side-band GEMVs against their plain twins at every
    Llama-3-8B shape and M = 8, 64, 255 (and 1 at M1_LINEAR), their GEMMs
    at M = 256, 1024;
    the emi8m stream at block 16 through the GEMV (M = 1, 8, 64) and the
    GEMM (M = 128, 1024)."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for lin, K, N in SHAPES:
        W = outlier_weight((K, N), gen)
        nb = pk.pack_outlier_nb(nb_decisions(W), budget=NB_BUDGET)
        sb = pk.pack_mx_outlier(W, 8, 8, "int2", "fp4_e2m1", std_dev=2.0,
                                block_size=16, outlier_budget=SIDEBAND_BUDGET,
                                axis=0)
        em = pk.to_serving_layout(pk.merge_outlier_emi8(sb))
        del W
        nb_dense = lambda: pk.dequantize_outlier_nb(nb, torch.bfloat16).T
        sb_dense = lambda: pk.dequantize_mx_outlier(sb, torch.bfloat16)
        arms = (
            ("dequant_gemv_nb", "nb", nb,
             with_m1(lin, at_m1_linear(lin, OUTLIER_PHASE_M, 8)),
             om.dequant_gemv_nb,
             om.dequant_matmul_nb_reference, OUTLIER_REL_TOL, nb_dense),
            ("dequant_gemm_nb", "nb", nb,
             at_m1_linear(lin, OUTLIER_GEMM_M, 1024), om.dequant_gemm_nb,
             om.dequant_matmul_nb_reference, GEMM_REL_TOL, nb_dense),
            ("dequant_gemv_outlier", "sideband", sb,
             with_m1(lin, at_m1_linear(lin, OUTLIER_PHASE_M, 8)),
             om.dequant_gemv_outlier, om.dequant_matmul_outlier_reference,
             OUTLIER_REL_TOL, sb_dense),
            ("dequant_gemm_outlier", "sideband", sb,
             at_m1_linear(lin, OUTLIER_GEMM_M, 1024),
             om.dequant_gemm_outlier, om.dequant_matmul_outlier_reference,
             GEMM_REL_TOL, sb_dense),
            ("dequant_gemv_emi8", "emi8m", em, GEMV_M, dm.dequant_gemv,
             dm.dequant_matmul_reference, GEMV_REL_TOL,
             lambda: pk.dequantize_mx(em, torch.bfloat16)),
            ("dequant_matmul_emi8", "emi8m", em, GEMM_M, dm.dequant_gemm,
             dm.dequant_matmul_reference, GEMM_REL_TOL,
             lambda: pk.dequantize_mx(em, torch.bfloat16)))
        for kname, transport, p, Ms, fn, ref_fn, tol, dense_fn in arms:
            nc = copies_for(p.nbytes())
            ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
            dense = dense_fn().contiguous()
            nd = copies_for(dense.numel() * 2)
            ds = [dense] + [dense.clone() for _ in range(nd - 1)]
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                got = fn(x, p, torch.float32)
                ref = ref_fn(x, p, torch.float32)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                if not (np.isfinite(rel) and rel < tol):
                    raise AssertionError(
                        f"{kname} {transport} {lin} M={M}: rel err {rel} "
                        f">= {tol}")
                ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), nc)
                plain_ms = cuda_ms(lambda i: ref_fn(x, p, torch.float32), 1,
                                   target_ms=100.0)
                lib_ms = cuda_ms(lambda i: torch.matmul(x, ds[i]), nd)
                t_bytes = ((p.nbytes() + x.numel() * 2 + M * N * 4)
                           / HBM_BYTES_PER_S * 1e3)
                t_ops = 2 * M * N * K / BF16_FLOPS * 1e3
                row = dict(kernel=kname, transport=transport, linear=lin,
                           M=M, K=K, N=N, weight_bytes=p.nbytes(),
                           max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations",
                           plain_ms=plain_ms, library_ms=lib_ms, card=card)
                if kname == "dequant_gemv_outlier":
                    row.update(sideband_gemv_stats(p, M, K, N, ms))
                elif kname in ("dequant_gemv_nb", "dequant_gemv_emi8"):
                    row.update(gemv_stats(p, M, K, N, ms))
                rows.append(row)
                log(phase="outlier_kernels_vs_plain", **row)
                del x, got, ref
            del ps, ds, dense
        del nb, sb, em, arms, nb_dense, sb_dense
        torch.cuda.empty_cache()
    return rows


def sideband_gemv_stats(w, M: int, K: int, N: int, ms: float) -> dict:
    """The side-band GEMV's achieved HBM rate (the bytes its bound counts:
    weight, x, f32 out, over its time), its plan (ring, split, tiles) and
    its occupancy: CTAs an SM by the card's occupancy query, 12 warps each
    (9 of them working), of the SM's 64."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    plan = om.outlier_gemv_plan(N, w.inlier.codes.shape[0],
                                w.inlier.block_size, w.budget, M)
    ctas = om.outlier_gemv_occupancy(
        M, w.inlier.codes.dtype != torch.int8, plan["smem_bytes"])
    nbytes = w.nbytes() + M * K * 2 + M * N * 4
    return dict(hbm_GBps=nbytes / ms / 1e6,
                hbm_share=nbytes / ms / 1e-3 / HBM_BYTES_PER_S,
                ctas_per_sm=ctas, occupancy=ctas * 12 / 64,
                ring_bytes=plan["stages"] * plan["stage_bytes"],
                stages=plan["stages"], ksplit=plan["ksplit"],
                tiles=plan["tiles"], smem_bytes=plan["smem_bytes"])


def gemv_stats(w, M: int, K: int, N: int, ms: float) -> dict:
    """A GEMV's achieved HBM rate (the bytes its bound counts: weight, x,
    f32 out, over its time) and, on the tensor-core routes (the dequant
    GEMV's ``gemv_tc``, the NB GEMV), its plan and occupancy: CTAs an SM by
    the card's occupancy query, 12 warps each (9 of them working), of the
    SM's 64. ``w`` is a PackedMX or a PackedOutlierNB; a checkout without
    these routes gives the rate alone."""
    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    nbytes = w.nbytes() + M * K * 2 + M * N * 4
    out = dict(hbm_GBps=nbytes / ms / 1e6,
               hbm_share=nbytes / ms / 1e-3 / HBM_BYTES_PER_S)
    if isinstance(w, pk.PackedOutlierNB):
        if not hasattr(om, "nb_gemv_plan"):
            return out
        plan = om.nb_gemv_plan(4 * w.codes.shape[0], K, w.budget, M)
        ctas = om.nb_gemv_occupancy(M, plan["smem_bytes"])
        route = "tc"
    else:
        if not hasattr(dm, "gemv_route"):
            return out
        decode = dm.sad_decode_params(w)[0]
        ww = pk.to_serving_layout(w)
        route = dm.gemv_route(decode, ww.block_size)
        if route != "tc":
            return dict(out, route=route)
        plan = dm.gemv_plan(decode, N, K, ww.block_size, M)
        ctas = dm.gemv_occupancy(decode, M, plan["smem_bytes"])
    return dict(out, route=route, ctas_per_sm=ctas, occupancy=ctas * 12 / 64,
                stages=plan["stages"], ksplit=plan["ksplit"],
                tiles=plan["tiles"], smem_bytes=plan["smem_bytes"])


def _clone_packed(p):
    """A copy of a packed weight with its own device buffers."""
    import torch

    if isinstance(p, torch.Tensor):
        return p.clone()
    return dataclasses.replace(p, **{
        f.name: _clone_packed(getattr(p, f.name))
        for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)
        or dataclasses.is_dataclass(getattr(p, f.name))})


def outlier_main_path(card: str):
    """The three transports at 32 layers and full width, one after the
    other, each freed before the next: a last_only prefill of 8 x 128
    tokens and 32 greedy decode steps, launch counts held exactly. Host
    time sets the decode step and drifts between calls, so after its main
    run each arm is timed interleaved with the slice-1 MX-FP6 model (built
    for the window, then freed). The NB model also serves the engine phase;
    the NB and side-band models' decode steps are profiled. Returns {arm:
    counts}."""
    import torch

    L, B, S0, STEPS = 32, 8, 128, 32
    max_len = S0 + STEPS + 8
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, 128256, (B, S0)), device="cuda")
    per_layer = {"nb": 4, "sideband": 7, "emi8m": 4}
    out = {}
    for arm in OUTLIER_ARMS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = outlier_model(arm, L, seed=10)[0]
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weight_bytes, bpe = weight_stats(model)
        prefill_decode(model, ids, 2, max_len)                # warm-up
        torch.cuda.reset_peak_memory_stats()
        # the main path's run: counts zeroed just before, read just after
        reset_counts()
        main = prefill_decode(model, ids, STEPS, max_len)
        toks, ttft, dec, last, pre, dcounts, *_ = main
        peak = torch.cuda.max_memory_allocated()
        n = per_layer[arm] * L + 1
        if arm == "nb":
            want_pre = want_counts(dequant_gemm_nb=4 * L, dequant_gemv_nb=1)
            want_dec = want_counts(dequant_gemv_nb=STEPS * n)
        elif arm == "sideband":
            want_pre = want_counts(dequant_gemm_outlier=7 * L,
                                   dequant_gemv_outlier=1)
            want_dec = want_counts(dequant_gemv_outlier=STEPS * n)
        else:
            want_pre = want_counts(dequant_matmul_emi8=4 * L,
                                   dequant_gemv_emi8=1)
            want_dec = want_counts(dequant_gemv_emi8=STEPS * n)
        if pre != want_pre or dcounts != want_dec:
            raise AssertionError(f"{arm} launch counts prefill {pre} (want "
                                 f"{want_pre}), decode {dcounts} (want "
                                 f"{want_dec})")
        if not torch.isfinite(last.float()).all():
            raise AssertionError(f"non-finite logits on the {arm} arm")
        if not ((toks >= 0) & (toks < model.cfg.vocab_size)).all():
            raise AssertionError(f"token ids out of range on the {arm} arm")
        eager_ms = graph_vs_eager(model, ids, STEPS, max_len, arm, main,
                                  card)
        del toks, last, main
        mxfp6 = build(True)[0]
        prefill_decode(mxfp6, ids, 2, max_len)
        best = {arm: (ttft, dec), "mxfp6": (9e9, 9e9)}
        for _ in range(3):
            for tag in ("mxfp6", arm):
                m = mxfp6 if tag == "mxfp6" else model
                _, t, d, *_ = prefill_decode(m, ids, STEPS, max_len)
                best[tag] = (min(best[tag][0], t), min(best[tag][1], d))
        del mxfp6, m             # m holds a model: free both before the next
        torch.cuda.empty_cache()
        ms = {k: v[1] / STEPS * 1e3 for k, v in best.items()}
        log(phase="outlier_main_path", arm=arm, layers=L, batch=B,
            prompt=S0, steps=STEPS, graph=True,
            decode_tokens_per_s=B * STEPS / best[arm][1],
            decode_ms_per_step=ms[arm], eager_decode_ms_per_step=eager_ms,
            ttft_ms=best[arm][0] * 1e3,
            mxfp6_decode_ms_per_step=ms["mxfp6"],
            mxfp6_ttft_ms=best["mxfp6"][0] * 1e3,
            vs_mxfp6_decode=ms["mxfp6"] / ms[arm],
            weight_bytes=weight_bytes, bits_per_element=bpe,
            peak_mem_gb=peak / 1e9, build_s=build_s,
            launches_prefill=pre, launches_decode=dcounts, card=card)
        out[arm] = {"prefill": pre, "decode": dcounts}
        if arm == "nb":
            outlier_engine_phase(model, card)
        if arm in ("nb", "sideband"):
            prof = decode_device_profile(model, ids, max_len, ms[arm])
            log(phase="outlier_decode_profile", arm=arm,
                profile=prof if prof else "not measured", card=card)
        del model
        torch.cuda.empty_cache()
    return out


def outlier_engine_phase(model, card: str):
    """A dense-slot BatchEngine over the 32-layer NB model answers the six
    requests; each is held token for token to single-sequence generate."""
    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.serve.engine import BatchEngine

    eng = BatchEngine(model, n_slots=4, max_len=256,
                      prompt_buckets=(32, 64, 128), device="cuda")
    reset_counts()
    reqs, news, wall = serve_six(eng, model.cfg.vocab_size)
    counts = launches()
    if counts != want_counts(dequant_gemv_nb=counts["dequant_gemv_nb"]) \
            or counts["dequant_gemv_nb"] == 0:
        raise AssertionError(f"NB engine launches {counts}")
    total = 0
    for r, t in zip(reqs, news):
        ref = generate(model, [r.prompt_ids.tolist()], t)[0].tolist()
        if r.out_tokens != ref:
            raise AssertionError(f"NB engine, request of {len(r.prompt_ids)} "
                                 f"tokens: {r.out_tokens} vs single-sequence "
                                 f"{ref}")
        total += t
    log(phase="outlier_engine", requests=len(reqs), tokens=total,
        wall_s=wall, tokens_per_s=total / wall, launches=counts,
        identical_to_single_sequence=len(reqs), card=card)
    del eng


def outlier_two_layer_phase(card: str):
    """For each transport, a 2-layer full-width model through the kernels
    against the same model through the plain twins, on the same token
    stream: B = 4 x 120-token prompt (480 tokens: a prefill through the
    GEMMs) and 8 decode steps through the GEMVs."""
    import torch

    B, S0, STEPS, max_len = 4, 120, 8, 192
    ids = torch.as_tensor(np.random.default_rng(5).integers(
        0, 128256, (B, S0)), device="cuda")
    for arm in OUTLIER_ARMS:
        two_k, tree = outlier_model(arm, 2, seed=20)
        two_p, _ = outlier_model(arm, 2, seed=20, use_kernels=False,
                                 tree=tree)
        toks, *_, first = prefill_decode(two_k, ids, STEPS, max_len)
        feed = torch.cat([torch.argmax(first[0][:, -1], -1)[:, None],
                          toks[:, :-1]], 1)
        reset_counts()
        got = prefill_decode(two_k, ids, STEPS, max_len, feed=feed)
        counts = {k: got[4][k] + got[5][k] for k in got[4]}
        got = got[7]
        want = prefill_decode(two_p, ids, STEPS, max_len, feed=feed,
                              graph=False)[7]
        per_layer = {"nb": 4, "sideband": 7, "emi8m": 4}[arm]
        gemv, gemm = {"nb": ("dequant_gemv_nb", "dequant_gemm_nb"),
                      "sideband": ("dequant_gemv_outlier",
                                   "dequant_gemm_outlier"),
                      "emi8m": ("dequant_gemv_emi8",
                                "dequant_matmul_emi8")}[arm]
        wc = want_counts(**{gemm: 2 * per_layer,
                            gemv: 1 + (2 * per_layer + 1) * STEPS})
        if counts != wc:
            raise AssertionError(f"2-layer {arm} launches {counts}, want "
                                 f"{wc}")
        errs = []
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            errs.append(((a - b).abs().max() / b.abs().max()).item())
        log(phase="outlier_two_layer_logits", arm=arm, rel_err_per_call=errs,
            max_rel_err=max(errs), tol=LOGIT_REL_TOL, launches=counts,
            card=card)
        if not all(np.isfinite(e) and e < LOGIT_REL_TOL for e in errs):
            raise AssertionError(f"2-layer {arm} logits: rel err {errs}")
        del two_k, two_p, tree, got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Slice 4: MX integer weights and the other transports of the GEMV and GEMM,
# the W8A8 GEMV, the block quantizer
# ---------------------------------------------------------------------------
# kernel-phase cases: (format, transport, block, 2-D codes, linears); every
# decode of _sad_kernel, the int8 container also as 2-D native2d codes
INT_CASES = {
    "int4_sb4": ("int4", "sb4", 32, False, None),
    "int8_native": ("int8", "native", 32, False, None),
    "int2_native": ("int2", "native", 32, False, None),
    "int2_sb2": ("int2", "sb2", 16, False, None),
    "fp6_pf6": ("fp6_e3m2", "pf6", 32, False, None),
    "fp4_pf4": ("fp4_e2m1", "pf4", 32, False, None),
    "bf16_container": ("bfloat16", "native", 32, False, ("qkv", "gate_up")),
    "fp16_container": ("fp16", "native", 32, False, ("qkv", "gate_up")),
    "int8_native2d": ("int8", "native", 32, True, ("qkv", "gate_up")),
    # the float8 containers: fp8_e4m3 and fp8_e5m2 as pack_params makes
    # them, fp6 codes in float8_e4m3fn, and 2-D codes (the TPU's native2d)
    "fp8_e4m3_native": ("fp8_e4m3", "native", 32, False,
                        ("qkv", "gate_up", "down")),
    "fp8_e5m2_native": ("fp8_e5m2", "native", 32, False, ("qkv", "gate_up")),
    "fp6_native": ("fp6_e3m2", "native", 32, False, ("qkv", "gate_up")),
    "fp8_e4m3_native2d": ("fp8_e4m3", "native", 32, True, ("qkv", "gate_up")),
}
# kernel-phase cases that run no 2-layer model (pack_params makes emi8 for
# fp6; the 2-D float8 codes take the kernels by the view that int8_native2d
# already drives)
INT_KERNEL_ONLY = ("fp6_native", "fp8_e4m3_native2d")
# the 32-layer arms and their cases (the transports pack_params gives them)
INT_ARMS = {"int4": "int4_sb4", "int8": "int8_native"}
INT_ARM_BITS = {"int4": 4.25, "int8": 8.25}   # codes + one exponent a block
# the bfloat16 MX format's shared exponent is floor(log2 amax) - 127: it
# clamps at -127 for amax < 2, where the kernels' scale floor (2^-126, as the
# TPU kernels) departs from the twin. Its weights are scaled by BF16_GAIN
# (amax > 2 in every block) and its models' RMSNorm scales by 1 / BF16_GAIN,
# so that q, k, v, gate, up and the logits keep their usual size.
BF16_GAIN = 256.0
S8_CASES = {"int8_native": ("int8", "native", 32),
            "int4_sb4": ("int4", "sb4", 16),
            "int2_sb2": ("int2", "sb2", 16)}
QUANT_FORMATS = ("fp6_e3m2", "fp4_e2m1", "int8", "int4", "int2")
QUANT_RAGGED = (4000, 4100)          # the block-16 ragged shape


def int_weight(fmt, shape, gen):
    """N(0, 0.02) bf16 weights as bench.py makes them, times BF16_GAIN for
    the bfloat16 MX format."""
    import torch

    std = 0.02 * (BF16_GAIN if fmt == "bfloat16" else 1.0)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16) * std


def int_packed(case, W):
    """W packed as a kernel-phase case: serving layout, or 2-D codes."""
    from microscopiq_tpu_torch.ops import packing as pk

    fmt, transport, bs, flat, _ = INT_CASES[case]
    p = pk.pack_mx(W.float(), 8, fmt, bs, axis=0, transport=transport)
    return p if flat else pk.to_serving_layout(p)


def row_bound(nbytes, M, N, K, peak=None):
    """(bound ms, bound_by): bytes over HBM against 2MNK over the operands'
    peak rate (bf16 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K / (peak or BF16_FLOPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def int_kernel_phase(card: str):
    """The GEMV (M = 8, 64; 1 at M1_LINEAR) and GEMM (M = 128, 1024) in
    every other transport at the Llama-3-8B shapes, each against
    dequant_matmul_reference, timed beside the bound, the plain version and
    torch.matmul on the dequantized bf16 weight."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    gen = torch.Generator(device="cuda").manual_seed(4004)
    rows = []
    for case, (fmt, transport, bs, flat, lins) in INT_CASES.items():
        for lin, K, N in SHAPES:
            if lins is not None and lin not in lins:
                continue
            p = int_packed(case, int_weight(fmt, (K, N), gen))
            decode = dm.sad_decode_params(p)[0]
            if flat != (p.codes.ndim == 2):
                raise AssertionError(f"{case}: codes {tuple(p.codes.shape)}")
            dense = pk.dequantize_mx(p, dtype=torch.bfloat16)
            nc = copies_for(p.nbytes())
            ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
            nd = copies_for(dense.numel() * 2)
            ds = [dense] + [dense.clone() for _ in range(nd - 1)]
            for kind, Ms, fn, tol in (
                    ("gemv", with_m1(lin, at_m1_linear(lin, S8_M, 8)),
                     dm.dequant_gemv, GEMV_REL_TOL),
                    ("matmul", at_m1_linear(lin, GEMM_M, 1024),
                     dm.dequant_gemm, GEMM_REL_TOL)):
                kname = f"dequant_{kind}_{decode}"
                for M in Ms:
                    x = torch.randn((M, K), generator=gen, device="cuda",
                                    dtype=torch.bfloat16)
                    dm.reset_launch_counts()
                    got = fn(x, p, torch.float32)
                    ref = dm.dequant_matmul_reference(x, p, torch.float32)
                    torch.cuda.synchronize()
                    if dm.launch_counts[kname] != 1:
                        raise AssertionError(f"{case} {lin} M={M} did not "
                                             f"launch {kname}")
                    err = (got - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    if not (np.isfinite(rel) and rel < tol):
                        raise AssertionError(f"{kname} {case} {lin} M={M}: "
                                             f"rel err {rel} >= {tol}")
                    ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), nc)
                    plain_ms = cuda_ms(
                        lambda i: dm.dequant_matmul_reference(
                            x, p, torch.float32), 1, target_ms=20.0)
                    lib_ms = cuda_ms(lambda i: torch.matmul(x, ds[i]), nd)
                    bound, by = row_bound(
                        p.nbytes() + x.numel() * 2 + M * N * 4, M, N, K)
                    row = dict(kernel=kname, case=case, format=fmt,
                               transport=transport, block=bs,
                               codes_2d=flat, linear=lin, M=M, K=K, N=N,
                               weight_bytes=p.nbytes(), max_abs_err=err,
                               rel_err=rel, tol=tol, ms=ms, bound_ms=bound,
                               bound_by=by, plain_ms=plain_ms,
                               library_ms=lib_ms, card=card)
                    if kind == "gemv":
                        row.update(gemv_stats(p, M, K, N, ms))
                    rows.append(row)
                    log(phase="int_kernels_vs_plain", **row)
                    del x, got, ref
            del ps, ds, p, dense
            torch.cuda.empty_cache()
    return rows


def int_tree(case, layers, seed):
    """Llama-3-8B weights at full width and ``layers`` deep, seeded on the
    card, every linear (the lm_head included) packed by the port's
    ``nn.pack_params`` (scale_bits 8, the case's block size, its transport
    as ``gemm_transport`` where it is not the default) layer by layer, so
    that one layer's bf16 weights exist at a time; fused projections.
    2-D cases keep each leaf's codes 2-D; the bfloat16 case scales its
    RMSNorms (see BF16_GAIN). Returns (config, tree)."""
    import torch

    from microscopiq_tpu_torch.models.llama import LlamaConfig
    from microscopiq_tpu_torch.nn import fuse_projections, pack_params
    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    fmt, transport, bs, flat, _ = INT_CASES[case]
    specs = finalize_mx_specs({"w_elem_format": fmt, "scale_bits": 8,
                               "block_size": bs})
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers,
                                dtype=torch.bfloat16, fused_projections=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    default = {"int4": "sb4"}.get(fmt, "native")
    override = None if transport == default else transport

    def pack(sub):
        out = pack_params(sub, specs, skip=(), gemm_transport=override)
        if flat:
            out = _map_packed(out, pk.from_serving_layout)
        return out

    k = lambda shape: {"kernel": int_weight(fmt, shape, gen)}
    gain = 1.0 / BF16_GAIN if fmt == "bfloat16" else 1.0
    ones = lambda: torch.full((D,), gain, dtype=cfg.dtype, device="cuda")
    model = {"embed_tokens": (torch.randn((V, D), generator=gen,
                                          device="cuda",
                                          dtype=torch.bfloat16) * 0.02)}
    for i in range(layers):
        model[f"layers_{i}"] = {
            **pack({"self_attn": {"q_proj": k((D, H * hd)),
                                  "k_proj": k((D, KVH * hd)),
                                  "v_proj": k((D, KVH * hd)),
                                  "o_proj": k((H * hd, D))},
                    "mlp": {"gate_proj": k((D, I)), "up_proj": k((D, I)),
                            "down_proj": k((I, D))}}),
            "input_layernorm": {"scale": ones()},
            "post_attention_layernorm": {"scale": ones()}}
    model["norm"] = {"scale": ones()}
    tree = {"model": model, "lm_head": pack({"lm_head": k((D, V))})["lm_head"]}
    return cfg, fuse_projections(tree)


def _map_packed(tree, fn):
    from microscopiq_tpu_torch.ops import packing as pk

    if isinstance(tree, dict):
        return {k: _map_packed(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, pk.PackedMX) else tree


def int_model(case, layers, seed, use_kernels=True, tree=None):
    """(model, (config, tree)) of one case; checks what it packed to."""
    from microscopiq_tpu_torch.models.llama import LlamaForCausalLM
    from microscopiq_tpu_torch.ops import packing as pk

    cfg, built = int_tree(case, layers, seed) if tree is None else tree
    model = LlamaForCausalLM(cfg, use_kernels=use_kernels,
                             device="cuda").load_params(built)
    fmt, transport, bs, flat, _ = INT_CASES[case]
    kinds = {(type(m.kernel).__name__, getattr(m.kernel, "transport", None),
              getattr(m.kernel, "block_size", None),
              m.kernel.codes.ndim if hasattr(m.kernel, "codes") else None)
             for m in model.modules() if getattr(m, "kernel", None)
             is not None}
    want = {("PackedMX", transport, bs, 2 if flat else 3)}
    if kinds != want:
        raise AssertionError(f"{case} packed to {kinds}, want {want}")
    return model, (cfg, built)


def int_main_path(card: str):
    """The int4 (sb4) and int8 (int8 container) arms at 32 layers and full
    width, one after the other: the main path's prefill and decode with
    exact launch counts (every prefill GEMM of the int4 arm on
    ``dequant_matmul_sb4``, of the int8 arm on ``dequant_matmul_native``:
    the sm90 loop at block 32, and none on a ``_tile`` counter), weight
    bytes and bits per weight, peak memory (the
    arm's model alone on the card); then each arm timed interleaved with the
    slice-1 MX-FP6 model, built for each window and freed after it. The int4
    model then serves the engine phase. Returns {arm: counts}."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    L, B, S0, STEPS = 32, 8, 128, 32
    max_len = S0 + STEPS + 8
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, 128256, (B, S0)), device="cuda")
    out = {}
    for arm, case in INT_ARMS.items():
        fmt, transport = INT_CASES[case][:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = int_model(case, L, seed=40)[0]
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weight_bytes, bpe = weight_stats(model)
        prefill_decode(model, ids, 2, max_len)                # warm-up
        torch.cuda.reset_peak_memory_stats()
        # the main path's run: counts zeroed just before, read just after
        reset_counts()
        main = prefill_decode(model, ids, STEPS, max_len)
        toks, ttft, dec, last, pre, dcounts, *_ = main
        peak = torch.cuda.max_memory_allocated()
        gemm = dm.gemm_counter(transport, INT_CASES[case][2])
        if gemm != f"dequant_matmul_{transport}":
            raise AssertionError(f"{arm} arm's GEMM counts as {gemm}, not "
                                 "on the sm90 loop")
        want_pre = want_counts(**{gemm: 4 * L,
                                  f"dequant_gemv_{transport}": 1})
        want_dec = want_counts(**{f"dequant_gemv_{transport}":
                                  STEPS * (4 * L + 1)})
        if pre != want_pre or dcounts != want_dec:
            raise AssertionError(f"{arm} launch counts prefill {pre} (want "
                                 f"{want_pre}), decode {dcounts} (want "
                                 f"{want_dec})")
        if not torch.isfinite(last.float()).all():
            raise AssertionError(f"non-finite logits on the {arm} arm")
        if not ((toks >= 0) & (toks < model.cfg.vocab_size)).all():
            raise AssertionError(f"token ids out of range on the {arm} arm")
        eager_ms = graph_vs_eager(model, ids, STEPS, max_len, arm, main,
                                  card)
        del toks, last, main
        mxfp6 = build(True)[0]
        prefill_decode(mxfp6, ids, 2, max_len)
        best = {arm: (ttft, dec), "mxfp6": (9e9, 9e9)}
        for _ in range(3):
            for tag in ("mxfp6", arm):
                m = mxfp6 if tag == "mxfp6" else model
                _, t, d, *_ = prefill_decode(m, ids, STEPS, max_len)
                best[tag] = (min(best[tag][0], t), min(best[tag][1], d))
        del mxfp6, m             # m holds a model: free both before the next
        torch.cuda.empty_cache()
        ms = {k: v[1] / STEPS * 1e3 for k, v in best.items()}
        log(phase="int_main_path", arm=arm, format=fmt, transport=transport,
            layers=L, batch=B, prompt=S0, steps=STEPS, graph=True,
            decode_tokens_per_s=B * STEPS / best[arm][1],
            decode_ms_per_step=ms[arm], eager_decode_ms_per_step=eager_ms,
            ttft_ms=best[arm][0] * 1e3,
            mxfp6_decode_ms_per_step=ms["mxfp6"],
            mxfp6_ttft_ms=best["mxfp6"][0] * 1e3,
            vs_mxfp6_decode=ms["mxfp6"] / ms[arm],
            weight_bytes=weight_bytes, weight_gb=weight_bytes / 1e9,
            bits_per_element=bpe, peak_mem_gb=peak / 1e9, build_s=build_s,
            launches_prefill=pre, launches_decode=dcounts, card=card)
        out[arm] = {"prefill": pre, "decode": dcounts}
        if abs(bpe - INT_ARM_BITS[arm]) > 1e-9:
            raise AssertionError(f"{arm} arm at {bpe} bits per weight, want "
                                 f"{INT_ARM_BITS[arm]}")
        if arm == "int4":
            int_engine_phase(model, card)
        del model
        torch.cuda.empty_cache()
    return out


def int_engine_phase(model, card: str):
    """A dense-slot BatchEngine over the 32-layer int4 model answers the six
    requests (the 100- and 120-token prompts pad to the 128 bucket: the
    GEMM); each is held token for token to single-sequence generate."""
    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.serve.engine import BatchEngine

    eng = BatchEngine(model, n_slots=4, max_len=256,
                      prompt_buckets=(32, 64, 128), device="cuda")
    reset_counts()
    reqs, news, wall = serve_six(eng, model.cfg.vocab_size)
    counts = launches()
    used = {k for k, v in counts.items() if v}
    if used != {"dequant_gemv_sb4", "dequant_matmul_sb4"}:
        raise AssertionError(f"int4 engine launches {counts}")
    total = 0
    for r, t in zip(reqs, news):
        ref = generate(model, [r.prompt_ids.tolist()], t)[0].tolist()
        if r.out_tokens != ref:
            raise AssertionError(f"int4 engine, request of "
                                 f"{len(r.prompt_ids)} tokens: "
                                 f"{r.out_tokens} vs single-sequence {ref}")
        total += t
    log(phase="int_engine", requests=len(reqs), tokens=total, wall_s=wall,
        tokens_per_s=total / wall,
        launches={k: counts[k] for k in sorted(used)},
        identical_to_single_sequence=len(reqs), card=card)
    del eng


def int_two_layer_phase(card: str):
    """For each case, a 2-layer full-width model through the kernels
    against the same model through the plain twin, on the same token
    stream: B = 4 x 120-token prompt (480 tokens: the GEMM) and 8 decode
    steps (the GEMV). The kernel run is also these decodes' model path:
    its launch counts are returned by case."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    B, S0, STEPS, max_len = 4, 120, 8, 192
    ids = torch.as_tensor(np.random.default_rng(6).integers(
        0, 128256, (B, S0)), device="cuda")
    out = {}
    for case in (c for c in INT_CASES if c not in INT_KERNEL_ONLY):
        two_k, tree = int_model(case, 2, seed=41)
        two_p, _ = int_model(case, 2, seed=41, use_kernels=False, tree=tree)
        toks, *_, first = prefill_decode(two_k, ids, STEPS, max_len)
        feed = torch.cat([torch.argmax(first[0][:, -1], -1)[:, None],
                          toks[:, :-1]], 1)
        reset_counts()
        got = prefill_decode(two_k, ids, STEPS, max_len, feed=feed)
        counts = {k: got[4][k] + got[5][k] for k in got[4]}
        got = got[7]
        want = prefill_decode(two_p, ids, STEPS, max_len, feed=feed,
                              graph=False)[7]
        d = dm.sad_decode_params(two_k.lm_head.kernel)[0]
        wc = want_counts(**{f"dequant_matmul_{d}": 2 * 4,
                            f"dequant_gemv_{d}": 1 + (2 * 4 + 1) * STEPS})
        if counts != wc:
            raise AssertionError(f"2-layer {case} launches {counts}, want "
                                 f"{wc}")
        errs = []
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            errs.append(((a - b).abs().max() / b.abs().max()).item())
        log(phase="int_two_layer_logits", case=case, rel_err_per_call=errs,
            max_rel_err=max(errs), tol=LOGIT_REL_TOL,
            launches={k: v for k, v in counts.items() if v}, card=card)
        if not all(np.isfinite(e) and e < LOGIT_REL_TOL for e in errs):
            raise AssertionError(f"2-layer {case} logits: rel err {errs}")
        out[case] = {k: v for k, v in counts.items() if v}
        del two_k, two_p, tree, got, want
        torch.cuda.empty_cache()
    return out


# the W8A8 call's GEMV and reduce kernels, by name (this tree's and the
# previous one's): what is left of the call is the activation quantizer
W8A8_KERNELS = ("gemv_s8_tc", "s8_partial", "split_reduce")


def s8_timing(x, ps, nc) -> dict:
    """Times of the W8A8 call dequant_matmul_sad_s8(x, w), w cycling over
    the weight copies ps: ``ms``, the whole call's device time (a CUDA
    graph of 16 calls: activation quantization, GEMV, reduce);
    ``kernel_ms``, the device time of its GEMV and reduce kernels alone
    (W8A8_KERNELS, torch.profiler), ``quantize_ms`` the rest of the call's
    device time, and its kernel launches a call; ``wrapper_ms``, the
    call's CUDA-event time back to back (the host's). It calls only the
    wrapper, which the previous tree has too."""
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    s8 = lambda i: dm.dequant_matmul_sad_s8(x, ps[i])       # noqa: E731
    out = {"ms": graph_ms(s8, nc), "wrapper_ms": cuda_ms(s8, nc)}
    by_name, per_call = kernel_split_ms(s8, nc, phase="sad_s8_vs_plain")
    out["launches_per_call"] = per_call
    kern = sum(t for k, t in by_name.items()
               if any(a in k for a in W8A8_KERNELS))
    out["kernel_ms"] = kern
    out["quantize_ms"] = sum(by_name.values()) - kern
    return out


def s8_phase(card: str):
    """The W8A8 GEMV against dequant_matmul_sad_s8_reference at every
    Llama-3-8B shape and M = 8, 64 (S8_M; M = 1 too at M1_LINEAR), beside
    the bf16-activation GEMV on the same weight, torch.matmul on the
    dequantized bf16 weight and, where
    it takes the shape (M > 16), torch._int_mm on int8 operands of the same
    shape. The W8A8 times are :func:`s8_timing`'s (whole call and
    kernel-only device times); the bf16 GEMV's a CUDA graph's. Then the
    entry point's own run: one call per shape at M = 8, a decode step's
    linears and the lm_head, and the activation quantizer's rows
    (:func:`quantize_x_rows`). Returns (rows, launches)."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    gen = torch.Generator(device="cuda").manual_seed(4008)
    rows, weights = [], {}
    for case, (fmt, transport, bs) in S8_CASES.items():
        kname = f"dequant_gemv_s8_{transport}"
        for lin, K, N in SHAPES:
            W = int_weight(fmt, (K, N), gen)
            p = pk.to_serving_layout(pk.pack_mx(W.float(), 8, fmt, bs,
                                                axis=0, transport=transport))
            del W
            dense = pk.dequantize_mx(p, dtype=torch.bfloat16)
            nc = copies_for(p.nbytes())
            ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
            nd = copies_for(dense.numel() * 2)
            ds = [dense] + [dense.clone() for _ in range(nd - 1)]
            wi8 = [torch.randint(-127, 128, (K, N), generator=gen,
                                 device="cuda", dtype=torch.int8)
                   for _ in range(copies_for(K * N))]
            for M in with_m1(lin, S8_M):
                x = torch.randn((M, K), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                dm.reset_launch_counts()
                got = dm.dequant_matmul_sad_s8(x, p)
                ref = dm.dequant_matmul_sad_s8_reference(x, p)
                torch.cuda.synchronize()
                if dm.launch_counts[kname] != 1:
                    raise AssertionError(f"{case} {lin} M={M}: no {kname}")
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                if not (np.isfinite(rel) and rel < GEMV_REL_TOL):
                    raise AssertionError(f"{kname} {lin} M={M}: rel err "
                                         f"{rel}")
                times = s8_timing(x, ps, nc)
                bf16_ms = graph_ms(lambda i: dm.dequant_gemv(x, ps[i]), nc)
                plain_ms = cuda_ms(
                    lambda i: dm.dequant_matmul_sad_s8_reference(x, p), 1,
                    target_ms=20.0)
                lib_ms = cuda_ms(lambda i: torch.matmul(x, ds[i]), nd)
                xi = torch.randint(-127, 128, (M, K), generator=gen,
                                   device="cuda", dtype=torch.int8)
                int_mm_ms = (cuda_ms(lambda i: torch._int_mm(
                    xi, wi8[i % len(wi8)]), len(wi8))
                    if M > 16 and K % 8 == 0 and N % 8 == 0 else None)
                bound, by = row_bound(p.nbytes() + M * K * 2 + M * N * 4,
                                      M, N, K, INT8_OPS)
                row = dict(kernel=kname, case=case, format=fmt,
                           transport=transport, block=bs, linear=lin, M=M,
                           K=K, N=N, max_abs_err=err, rel_err=rel,
                           tol=GEMV_REL_TOL, **times, bf16_gemv_ms=bf16_ms,
                           bound_ms=bound, bound_by=by, plain_ms=plain_ms,
                           library_ms=lib_ms, int_mm_ms=int_mm_ms, card=card)
                rows.append(row)
                log(phase="sad_s8_vs_plain", **row)
                del x, xi, got, ref
            weights[(case, lin)] = p
            del ps, ds, dense, wi8
            torch.cuda.empty_cache()
    # the entry point's run: counts zeroed just before, read just after
    x8 = {K: torch.randn((8, K), generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _, K, _ in SHAPES}
    reset_counts()
    for (case, lin), p in weights.items():
        dm.dequant_matmul_sad_s8(x8[p.orig_dim], p, torch.bfloat16)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    want = {f"dequant_gemv_s8_{t}": len(SHAPES) for _, t, _ in
            S8_CASES.values()}
    want["quantize_x_int8"] = len(SHAPES) * len(S8_CASES)
    if counts != want:
        raise AssertionError(f"W8A8 entry point launches {counts}")
    del weights
    torch.cuda.empty_cache()
    return rows + quantize_x_rows(card, gen), counts


def quantize_x_rows(card: str, gen):
    """The one-launch activation quantizer (quantize_x_int8) against its
    plain twin, bit for bit (codes and scales), at the K of the W8A8 GEMV's
    shapes and M = 8, 64, timed beside its byte bound (x read once, codes
    and scales written once) and the twin."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    rows = []
    for K in sorted({K for _, K, _ in SHAPES}):
        for M in (8, 64):
            x = torch.randn((M, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])   # ties
            codes, scale = dm.quantize_x_int8(x)
            want = dm.quantize_activations_int8(x)
            torch.cuda.synchronize()
            if not (torch.equal(codes, want[0])
                    and torch.equal(scale.view(torch.int32),
                                    want[1].view(torch.int32))):
                raise AssertionError(f"quantize_x_int8 K={K} M={M} is not "
                                     "its twin's")
            nbytes = M * K * 2 + M * K + M * 4
            row = dict(kernel="quantize_x_int8", K=K, M=M, max_abs_err=0.0,
                       ms=device_ms(lambda i: dm.quantize_x_int8(x), 1,
                                    phase=f"quantize_x_int8 K={K} M={M}"),
                       plain_ms=device_ms(
                           lambda i: dm.quantize_activations_int8(x), 1,
                           phase=f"quantize_x_int8 plain K={K} M={M}"),
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes", library_ms=None, card=card)
            rows.append(row)
            log(phase="sad_s8_vs_plain", **row)
    return rows


def quant_phase(card: str):
    """The MX block quantizer against its plain version (pack_mx with the
    exact scale) on every Llama-3-8B weight shape at block 32 and one
    ragged shape at block 16, in each format: codes and exponents must be
    bit-equal. Timed beside the byte bound (f32 in, codes and exponents
    out) and the plain version; no single PyTorch call computes it. Then
    the entry point's own run: each weight of a layer and the lm_head
    quantized once in MX-FP6. Returns (rows, launches)."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import mx_quant as mq

    gen = torch.Generator(device="cuda").manual_seed(4016)
    shapes = [(lin, K, N, 32) for lin, K, N in SHAPES] + [
        ("ragged",) + QUANT_RAGGED + (16,)]
    raw = lambda t: t.view(torch.uint8)
    rows = []
    for lin, K, N, bs in shapes:
        W = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        W[::97] *= 30.0                   # spread the block exponents
        nc = copies_for(W.numel() * 4)
        Ws = [W] + [W.clone() for _ in range(nc - 1)]
        for fmt in QUANT_FORMATS:
            mq.reset_launch_counts()
            got = mq.quantize_mx_block(W, 8, fmt, bs)
            want = mq.quantize_mx_reference(W, 8, fmt, bs)
            torch.cuda.synchronize()
            if mq.launch_counts["quantize_mx"] != 1:
                raise AssertionError(f"quantize_mx {lin} {fmt}: no launch")
            same_codes = bool(torch.equal(raw(got.codes), raw(want.codes)))
            same_se = bool(torch.equal(got.scale_exp, want.scale_exp))
            mism = int((raw(got.codes) != raw(want.codes)).sum().item())
            del want
            if not (same_codes and same_se):
                raise AssertionError(f"quantize_mx {lin} {fmt} block {bs}: "
                                     f"{mism} codes differ, exponents "
                                     f"equal: {same_se}")
            ms = cuda_ms(lambda i: mq.quantize_mx_block(Ws[i], 8, fmt, bs),
                         nc)
            plain_ms = cuda_ms(lambda i: mq.quantize_mx_reference(
                W, 8, fmt, bs), 1, target_ms=20.0)
            nbytes = (W.numel() * 4 + got.codes.numel()
                      + got.scale_exp.numel())
            row = dict(kernel="quantize_mx", format=fmt, block=bs,
                       linear=lin, K=K, N=N, max_abs_err=0.0,
                       bit_exact=True, ms=ms,
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes", plain_ms=plain_ms,
                       library_ms=None, card=card)
            rows.append(row)
            log(phase="mx_quant_vs_plain", **row)
            del got
        del Ws, W
        torch.cuda.empty_cache()
    # the entry point's run: counts zeroed just before, read just after
    layer = [torch.randn((K, N), generator=gen, device="cuda") * 0.02
             for _, K, N in SHAPES]
    reset_counts()
    for W in layer:
        mq.quantize_mx_block(W, 8, "fp6_e3m2", 32)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    if counts != {"quantize_mx": len(SHAPES)}:
        raise AssertionError(f"quantizer entry point launches {counts}")
    del layer
    torch.cuda.empty_cache()
    return rows, counts


def quant_times() -> list:
    """The MX block quantizer's time at gate_up (4096 x 28672, f32) in the
    five formats at block 32, and at the ragged block-16 shape in fp6:
    CUDA events over L2-cold copies, as quant_phase times it, beside the
    byte bound (f32 in, codes and exponents out) and its share. It calls
    only the wrapper, which the previous tree has too."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import mx_quant as mq

    gen = torch.Generator(device="cuda").manual_seed(4016)
    cases = [("gate_up", 4096, 28672, 32, f) for f in QUANT_FORMATS] + [
        ("ragged",) + QUANT_RAGGED + (16, "fp6_e3m2")]
    rows = []
    for lin, K, N, bs, fmt in cases:
        W = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        W[::97] *= 30.0
        nc = copies_for(W.numel() * 4)
        Ws = [W] + [W.clone() for _ in range(nc - 1)]
        got = mq.quantize_mx_block(W, 8, fmt, bs)
        nbytes = W.numel() * 4 + got.codes.numel() * got.codes.element_size() \
            + got.scale_exp.numel()
        ms = cuda_ms(lambda i: mq.quantize_mx_block(Ws[i], 8, fmt, bs), nc)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(format=fmt, block=bs, linear=lin, K=K, N=N, ms=ms,
                         bound_ms=bound, share_of_bound=bound / ms))
        del Ws, W, got
        torch.cuda.empty_cache()
    return rows


GPTQ_LAYERS = 1                 # of Llama-3-8B's 32: calibration is per
                                # layer (2 until PR 17, cut for time)
GPTQ_CALIB = (16, 512)          # crops x tokens (the reference: 128 x 2048)
GPTQ_PPL = (8, 512)             # windows x tokens
GPTQ_BUDGET = 2                 # outliers a block: the compact NB slots
# packed against fake-quant perplexity: the same weights (the NB decode is
# exact), bf16 sums in another order
GPTQ_PPL_REL_TOL = 1e-3
GPTQ_PATHS = ("self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj",
              "self_attn/o_proj", "mlp/gate_proj", "mlp/up_proj",
              "mlp/down_proj")


def gptq_tree(cfg, seed):
    """Llama-3-8B weights at full width and ``cfg.num_hidden_layers`` deep
    for calibration, seeded on the card: the linears outlier_weight's (bf16,
    N(0, 0.02) with 3% of the elements x10), the embeddings float32, the
    norms ones, the lm_head N(0, 0.02) bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    k = lambda shape: {"kernel": outlier_weight(shape, gen)}  # noqa: E731
    ones = lambda: {"scale": torch.ones(D, device="cuda")}  # noqa: E731
    model = {"embed_tokens": torch.randn((V, D), generator=gen,
                                         device="cuda") * 0.02,
             "norm": ones()}
    for i in range(cfg.num_hidden_layers):
        model[f"layers_{i}"] = {
            "self_attn": {"q_proj": k((D, H * hd)), "k_proj": k((D, KVH * hd)),
                          "v_proj": k((D, KVH * hd)), "o_proj": k((H * hd, D))},
            "mlp": {"gate_proj": k((D, I)), "up_proj": k((D, I)),
                    "down_proj": k((I, D))},
            "input_layernorm": ones(), "post_attention_layernorm": ones()}
    lm_head = torch.randn((D, V), generator=gen, device="cuda",
                          dtype=torch.bfloat16) * 0.02
    return {"params": {"model": model, "lm_head": {"kernel": lm_head}}}


def _serving(tree):
    """The tree with its dense leaves in bf16 and its projections fused."""
    import torch

    from microscopiq_tpu_torch.nn import fuse_projections

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node.to(torch.bfloat16) if isinstance(node, torch.Tensor) \
            else node

    return fuse_projections(conv(tree))


def gptq_column_loop_times(W, H, qz, blocks: int = 2) -> dict:
    """Seconds a column of the block step at W's rows (one linear's W and
    H), eagerly and replayed from its CUDA graph, over ``blocks`` blocks of
    128 columns."""
    import torch

    from microscopiq_tpu_torch.quant import gptq as gq

    g = gq.GPTQ(W)
    g.H = H
    W_, Hinv, _ = g.inverse_hessian()
    step = gq.mx_block_step(gq.quantizer_config(qz), "mx_prune", True)
    parts = [(W_[:, b * 128:(b + 1) * 128],
              Hinv[b * 128:(b + 1) * 128, b * 128:(b + 1) * 128])
             for b in range(blocks)]
    out = {}
    for tag in ("eager", "graph"):
        run = step if tag == "eager" else gq.GraphedStep(step, parts[0])
        run(*parts[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in parts:
            run(*p)
        torch.cuda.synchronize()
        out[tag] = (time.perf_counter() - t0) / (128 * blocks)
        del run
    return out


def gptq_main_path(card: str):
    """The GPTQ path at Llama-3-8B width, GPTQ_LAYERS deep: calibration
    (``gptq_quantize_model``, the canonical quantizer with at most
    GPTQ_BUDGET outliers a block, decisions collected) on the synthetic
    corpus's GPTQ_CALIB crops, each linear's Hessian proxy loss beside
    round-to-nearest's on the same H (printed, not held: prune-and-
    redistribute zeroes weights that RTN keeps); the compact NB packing from
    GPTQ's decisions (4.0 bits a weight) and fused projections; the packed
    model's perplexity over GPTQ_PPL windows (NB GEMMs) within
    GPTQ_PPL_REL_TOL of the fake-quant model's, last-position logits within
    LOGIT_REL_TOL; a last_only prefill of 8 x 128 tokens and 32 greedy
    decode steps replayed from a CUDA graph (NB GEMVs), launch counts held
    exactly. Returns the path's launches ({"prefill": ppl and prefill,
    "decode": decode})."""
    import torch

    from microscopiq_tpu_torch.eval.data import get_loaders
    from microscopiq_tpu_torch.eval.ppl import perplexity
    from microscopiq_tpu_torch.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)
    from microscopiq_tpu_torch.nn import pack_params
    from microscopiq_tpu_torch.quant import MXQuantizer
    from microscopiq_tpu_torch.quant import gptq as gq
    from microscopiq_tpu_torch.quant.calibrate import gptq_quantize_model
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    L, (NC, SC), (NW, SW) = GPTQ_LAYERS, GPTQ_CALIB, GPTQ_PPL
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=L)     # float32 calibration
    V = cfg.vocab_size
    tree = gptq_tree(cfg, seed=15)
    crops, test_ids = get_loaders("synthetic", NC, seed=0, seqlen=SC)
    calib = torch.as_tensor(np.concatenate(crops) % V, device="cuda").long()
    test_ids = np.asarray(test_ids)[:NW * SW] % V
    if len(test_ids) != NW * SW:
        raise AssertionError(f"test stream of {len(test_ids)} tokens")
    qz = MXQuantizer(8, 8, "int2", "fp4_e2m1", std_dev=2.0, axes=(0,),
                     block_size=16, max_outliers_per_block=GPTQ_BUDGET)
    proxy, kept = {}, {}

    def on_quantized(i, path, g, Q):
        rtn = qz.quantize(g.W)
        loss = lambda q: float((((q - g.W) @ g.H) * (q - g.W)).sum())  # noqa
        proxy[f"layers_{i}/{path}"] = {"gptq": loss(Q), "rtn": loss(rtn)}
        if i == 0 and path == "self_attn/q_proj":
            kept["q_proj"] = (g.W.clone(), g.H.clone())

    timer = gq.StageTimer("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qtree, dec = gptq_quantize_model("llama", cfg, tree, calib, quantizer=qz,
                                     collect_decisions=True, verbose=False,
                                     timer=timer, on_quantized=on_quantized)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    calib_peak = torch.cuda.max_memory_allocated()
    gq.clear_graphs()
    want = {("model", f"layers_{i}") + tuple(p.split("/")) + ("kernel",)
            for i in range(L) for p in GPTQ_PATHS}
    if set(dec) != want or len(proxy) != len(want):
        raise AssertionError(f"calibrated {sorted(dec)}, want {sorted(want)}")
    for key in want:
        q = qtree["params"]
        w = tree["params"]
        for k in key:
            q, w = q[k], w[k]
        if not (torch.isfinite(q).all() and (q != w.float()).any()):
            raise AssertionError(f"{key}: not calibrated")
    if not all(np.isfinite(v["gptq"]) and np.isfinite(v["rtn"])
               for v in proxy.values()):
        raise AssertionError(f"proxy losses {proxy}")
    st = timer.seconds
    per_layer = {"capture": (st["capture"] - st["hessian"]) / L,
                 "hessian": st["hessian"] / L,
                 "cholesky": st["cholesky"] / L,
                 "column_loop": st["column_loop"] / L,
                 "of_which_graph_capture": st.get("graph_capture", 0.0) / L,
                 "propagate": st["propagate"] / L}
    cols = kept["q_proj"][0].shape[1]
    columns_a_layer = (3 * cols + cfg.num_attention_heads * cfg.head_dim
                       + 2 * cols + cfg.intermediate_size)
    loop = gptq_column_loop_times(*kept.pop("q_proj"), qz)
    del tree
    torch.cuda.empty_cache()

    specs = finalize_mx_specs(OUTLIER_SPECS)
    packed = _serving(pack_params(qtree["params"], specs,
                                  outlier_transport="compact",
                                  outlier_budget=GPTQ_BUDGET, decisions=dec))
    fake = _serving(qtree["params"])
    del qtree, dec
    scfg = LlamaConfig.llama3_8b(num_hidden_layers=L, dtype=torch.bfloat16,
                                 fused_projections=True)
    m_packed = LlamaForCausalLM(scfg, device="cuda").load_params(packed)
    m_fake = LlamaForCausalLM(scfg, device="cuda").load_params(fake)
    weight_bytes, bits = weight_stats(m_packed)
    if bits != 4.0:
        raise AssertionError(f"compact NB at {bits} bits a weight")

    # perplexity: counts zeroed just before the packed run, read just after
    perplexity(m_packed, test_ids[:2 * SW], seqlen=SW)        # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ppl_packed = perplexity(m_packed, test_ids, seqlen=SW)
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    ppl_counts = launches()
    if ppl_counts != want_counts(dequant_gemm_nb=NW * 4 * L):
        raise AssertionError(f"perplexity launches {ppl_counts}")
    reset_counts()
    ppl_fake = perplexity(m_fake, test_ids, seqlen=SW)
    if any(launches().values()):
        raise AssertionError(f"the fake-quant model launched {launches()}")
    ppl_rel = abs(ppl_packed - ppl_fake) / ppl_fake
    # how often the NB GEMM's bf16 outputs equal the dense bf16 product's
    x = torch.randn((SW, cfg.hidden_size), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1),
                    dtype=torch.bfloat16)
    gu = (m_packed.model.layers[0].mlp.gate_up_proj(x)
          == m_fake.model.layers[0].mlp.gate_up_proj(x)).float().mean()
    nb_equal_share = gu.item()
    ids = torch.as_tensor(test_ids[:SW][None].astype(np.int64), device="cuda")
    lp = m_packed(ids, last_only=True).float()
    lf = m_fake(ids, last_only=True).float()
    logit_rel = ((lp - lf).abs().max() / lf.abs().max()).item()
    if not (np.isfinite(ppl_packed) and ppl_rel <= GPTQ_PPL_REL_TOL):
        raise AssertionError(f"perplexity packed {ppl_packed}, fake-quant "
                             f"{ppl_fake}: rel {ppl_rel}")
    if not (np.isfinite(logit_rel) and logit_rel <= LOGIT_REL_TOL):
        raise AssertionError(f"last-position logits rel err {logit_rel}")
    del m_fake, fake
    torch.cuda.empty_cache()

    # decode: the main path's prefill and graph-replayed steps
    B, S0, STEPS = 8, 128, 32
    max_len = S0 + STEPS + 8
    dids = torch.as_tensor(np.random.default_rng(0).integers(0, V, (B, S0)),
                           device="cuda")
    prefill_decode(m_packed, dids, 2, max_len)               # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    toks, ttft, dec_s, last, pre, dcounts, *_ = prefill_decode(
        m_packed, dids, STEPS, max_len)
    serve_peak = torch.cuda.max_memory_allocated()
    want_pre = want_counts(dequant_gemm_nb=4 * L)
    want_dec = want_counts(dequant_gemv_nb=STEPS * 4 * L)
    if pre != want_pre or dcounts != want_dec:
        raise AssertionError(f"GPTQ path launches prefill {pre}, decode "
                             f"{dcounts}")
    if not (torch.isfinite(last.float()).all()
            and ((toks >= 0) & (toks < V)).all()):
        raise AssertionError("non-finite logits or tokens out of range")
    log(phase="gptq_main_path", layers=L, calib_crops=NC, calib_tokens=SC,
        seconds_a_layer=per_layer, calibration_wall_s=wall_s,
        calibration_tokens_per_s=NC * SC / wall_s,
        column_loop_s_a_column={**loop, "rows": cfg.hidden_size},
        column_loop_s_a_layer_from_columns={
            k: v * columns_a_layer for k, v in loop.items()},
        columns_a_layer=columns_a_layer, proxy_loss=proxy,
        ppl_windows=NW, ppl_seqlen=SW, ppl_packed=ppl_packed,
        ppl_fake_quant=ppl_fake, ppl_rel=ppl_rel, ppl_tol=GPTQ_PPL_REL_TOL,
        nb_gemm_equal_to_dense_share=nb_equal_share,
        ppl_tokens_per_s=NW * SW / ppl_s, logits_rel_err=logit_rel,
        logits_tol=LOGIT_REL_TOL, weight_bytes=weight_bytes,
        bits_per_weight=bits, decode_ms_per_step=dec_s / STEPS * 1e3,
        ttft_ms=ttft * 1e3, launches_ppl={k: v for k, v in ppl_counts.items()
                                          if v},
        launches_prefill={k: v for k, v in pre.items() if v},
        launches_decode={k: v for k, v in dcounts.items() if v},
        peak_mem_gb_calibration=calib_peak / 1e9,
        peak_mem_gb_serving=serve_peak / 1e9, card=card)
    del m_packed, packed, toks, last
    torch.cuda.empty_cache()
    return {"prefill": {k: pre[k] + ppl_counts[k] for k in pre},
            "decode": dcounts}


PREFILL_SCRIPTS = ("exp_prefill_floor", "exp_prefill_tiles2",
                   "exp_prefill_overlap", "exp_prefill_pipe")
# a bf16 output against the f32 plain output: its own rounding, half an ulp
# (2^-8 of |y|), as tests/test_torch_kernels_gpu.py::test_kernel_bf16_output
BF16_OUT_REL_TOL = 2 ** -8


def prefill_decomposition(recs) -> dict:
    """The prefill GEMM taken apart, from the four scripts' records: each
    piece's arm, ms, share of the bound and ratio to its run's dense arm."""
    def arm(script, name):
        return next(r for r in recs if r["script"] == f"exp_prefill_{script}"
                    and r["arm"] == name)

    def best(kernel):
        return min((r for r in recs if r["kernel"].startswith(kernel)
                    and r["out"] == "f32"), key=lambda r: r["ms"])

    pieces = {"dense": arm("floor", "dense"),
              "predecoded": arm("floor", "predecoded"),
              "native_int8": arm("floor", "native_int8"),
              "native_floor": arm("overlap", "native_floor"),
              "inkernel": arm("floor", "inkernel"),
              "tiles_best_pre": best("exp_gemm_tiles_pre"),
              "tiles_best_emi8": best("exp_gemm_tiles_emi8"),
              "overlap_best": best("exp_gemm_unroll"),
              "pipe_best": best("exp_gemm_pipe"),
              "rx_best": best("exp_gemm_rx")}
    return {k: {f: r[f] for f in ("script", "arm", "tiles", "ms",
                                  "bound_share", "vs_dense")}
            for k, r in pieces.items()}


def prefill_experiments_phase(card: str):
    """The four prefill-GEMM experiment scripts of the port
    (``microscopiq_tpu_torch.scripts.exp_prefill_*``), each through its
    ``main()``, on one setup (gate_up, M = 1024, seeded weights made once on
    the card with their plain outputs): every arm is held to its plain
    version and timed in three interleaved passes beside ``torch.matmul``.
    Counts are zeroed just before the four runs and read just after: every
    kernel of ``csrc/exp_prefill.cu`` (each compiled configuration of the
    tile sweep) must have launched. Returns (records, launches)."""
    import importlib
    import io

    import torch

    from microscopiq_tpu_torch.ops.cuda import exp_prefill as ep
    from microscopiq_tpu_torch.scripts import _prefill

    t0 = time.perf_counter()
    setup = _prefill.make_setup("cuda")
    mods = [importlib.import_module(f"microscopiq_tpu_torch.scripts.{n}")
            for n in PREFILL_SCRIPTS]
    reset_counts()
    recs = []
    for mod in mods:
        with contextlib.redirect_stdout(io.StringIO()):
            recs += mod.main([], setup=setup)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    misses = []
    for r in recs:
        tol = GEMM_REL_TOL if r["out"] == "f32" else BF16_OUT_REL_TOL
        rel = r["rel_err"]
        if rel is not None and not (np.isfinite(rel) and rel < tol):
            misses.append(f"{r['script']} {r['arm']}: rel err {rel} >= {tol}")
        log(phase="prefill_experiments", **r, tol=tol if rel is not None
            else None)
    missing = [k for k in ep.launch_counts if not counts.get(k)]
    log(phase="prefill_decomposition", pieces=prefill_decomposition(recs),
        launches=counts, seconds=time.perf_counter() - t0, card=card)
    if misses or missing:
        raise AssertionError(f"prefill experiments: {misses}; kernels not "
                             f"launched: {missing}")
    del setup
    torch.cuda.empty_cache()
    return recs, counts


GEMV_SCRIPTS = ("exp_decode_variants", "exp_sad_tiles", "exp_nb_variants")


def gemv_decomposition(recs) -> dict:
    """The decode GEMV taken apart, from the three scripts' records: each
    piece's arm, ms, GB/s of codes, share of the byte bound and ratio to
    its run's dense arm (torch.matmul on bf16 at the script's shape)."""
    from microscopiq_tpu_torch.ops.cuda import exp_gemv as eg

    def arm(script, name):
        return next(r for r in recs if r["script"] == script
                    and r["arm"] == name)

    def best(script, names):
        return min((r for r in recs if r["script"] == script
                    and r["arm"] in names), key=lambda r: r["ms"])

    dv, st, nb = GEMV_SCRIPTS
    tiles = [f"tm{mt}_tn{tn}_kb{kb}" for mt, tn, kb in eg.TILES]
    nb_full = list(eg.FULL_MODES) + [f"{m}_k1024" for m in ("pdot", "pdot3")]
    pieces = {"dense": arm(dv, "dense"), "zero": arm(dv, "zero"),
              "i32": arm(dv, "i32"), "f32dot": arm(dv, "f32dot"),
              "ebf8": arm(dv, "ebf8"), "i16": arm(dv, "i16"),
              "shipped_gemv": arm(dv, "shipped"),
              "tiles_dense": arm(st, "dense"),
              "tiles_shipped": arm(st, "tm0_tn0_kb0"),
              "tiles_best": best(st, tiles),
              "nb_dense": arm(nb, "dense"), "nb_cur": arm(nb, "cur"),
              "nb_best_mode": best(nb, nb_full)}
    return {k: {f: r[f] for f in ("script", "arm", "tiles", "N", "ms",
                                  "codes_GBps", "bound_share", "vs_dense")}
            for k, r in pieces.items()}


def gemv_experiments_phase(card: str):
    """The three decode-GEMV experiment scripts of the port
    (``microscopiq_tpu_torch.scripts.exp_decode_variants``,
    ``exp_sad_tiles``, ``exp_nb_variants``), each through its ``main()`` on
    its own setup (seeded weights made once on the card with their plain
    outputs, M = 8): every arm is held to its own plain version within the
    GEMV tolerance, i16, ebf8 and f32dot to i32 bit for bit, and each is
    timed in three interleaved passes beside ``torch.matmul``. Counts are
    zeroed just before the three runs and read just after: every kernel of
    ``csrc/exp_gemv.cu`` (each variant, tile configuration and NB mode) and
    the shipped emi8 and NB GEMVs must have launched. Returns (records,
    launches)."""
    import importlib
    import io

    import torch

    from microscopiq_tpu_torch.ops.cuda import exp_gemv as eg
    from microscopiq_tpu_torch.scripts import _gemv

    t0 = time.perf_counter()
    makers = dict(zip(GEMV_SCRIPTS, (_gemv.decode_setup, _gemv.tiles_setup,
                                     _gemv.nb_setup)))
    setups = {n: make("cuda") for n, make in makers.items()}
    mods = {n: importlib.import_module(f"microscopiq_tpu_torch.scripts.{n}")
            for n in GEMV_SCRIPTS}
    reset_counts()
    recs = []
    for name in GEMV_SCRIPTS:
        with contextlib.redirect_stdout(io.StringIO()):
            recs += mods[name].main([], setup=setups[name])
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    misses = []
    for r in recs:
        rel = r["rel_err"]
        if rel is not None and not (np.isfinite(rel) and rel < GEMV_REL_TOL):
            misses.append(f"{r['script']} {r['arm']}: rel err {rel}")
        if r.get("parity_exact") is False:
            misses.append(f"{r['arm']} is not bit-equal to i32: "
                          f"{r['parity_max_delta']}")
        log(phase="gemv_experiments", **r,
            tol=GEMV_REL_TOL if rel is not None else None)
    parity = {r["arm"]: r["parity_exact"] for r in recs if "parity_exact" in r}
    if set(parity) != {"i16", "ebf8", "f32dot"}:
        misses.append(f"parity not checked: {parity}")
    missing = [k for k in list(eg.launch_counts)
               + ["dequant_gemv_emi8", "dequant_gemv_nb"] if not counts.get(k)]
    log(phase="gemv_decomposition", pieces=gemv_decomposition(recs),
        parity_exact=parity, launches=counts,
        seconds=time.perf_counter() - t0, card=card)
    if misses or missing:
        raise AssertionError(f"gemv experiments: {misses}; kernels not "
                             f"launched: {missing}")
    del setups
    torch.cuda.empty_cache()
    return recs, counts


def _shape_rows(rows, keys=("linear", "M", "K", "N", "ms", "bound_ms",
                              "plain_ms", "library_ms", "max_abs_err",
                              "rel_err")):
    return [{k: r[k] for k in keys} for r in rows]


def launches_by_path(paths, flat, name) -> dict:
    """A kernel's nonzero launches by path: ``paths`` map a path to its
    prefill and decode counts, ``flat`` a path to its counts; a name that a
    path does not count (gemm_any.cu's kernels, which only the block
    routes' ``by_route_kernel`` names) has none there."""
    got = {p: c["prefill"].get(name, 0) + c["decode"].get(name, 0)
           for p, c in paths.items()}
    got.update({p: c.get(name, 0) for p, c in flat.items()})
    return {p: n for p, n in got.items() if n}


def kernels_line(rows, counts, qrows, qcounts, orows, ocounts, irows,
                 icounts, tcounts, srows, scounts, mrows, mcounts, prows,
                 pcounts, grows, gcounts, rrows, rcounts, extra_flat=None):
    """One record per kernel (and per decode of the GEMV and GEMM), at its
    heaviest main-path call (gate_up: M = 8 for the GEMVs, M = 1024 for the
    GEMMs; B = 4 x 3136 live tokens for the quantized-KV attention), with
    every shape kept. ``launches`` is the kernel's count over the paths
    that run it, split by path in ``launches_by_path``: the 32-layer main
    paths; for the decodes that no 32-layer arm packs (sb2, pf4, pf6, the
    16-bit containers, int2 in the int8 container), the 2-layer
    full-width model runs (``two_layer_<case>``); for the W8A8 GEMV and the
    quantizer, which no model path calls, their entry point's own run; the
    GPTQ-calibrated 2-layer path (``gptq``: perplexity and prefill, decode)
    for the NB kernels; the KV-policy and trace paths on the 32-layer
    MX-FP6 model (``trace_stats``, ``h2o_engine``, ``h2o_main_path``,
    ``sink_main_path``, ``frontends``, ``cot_evals``) and the 2-layer
    full-width families (``family_<name>``) for the emi8 GEMV and GEMM
    (``cot_evals`` for the quantized-KV attention too); for
    the GEMMs at the MX blocks that no model path packs (gemm_any.cu's
    kernels, which take the block at run time, records of their own:
    ANY_KERNELS, their launches gemm_any.cu's alone; and the kernels
    compiled per block at the other blocks of ROUTE_CASES), the block-route
    entry point's run. The GEMMs that run on the wgmma + TMA mainloop
    (pf6, pf4, sb4, sb2, the fp16 and bf16 containers, emi8/emi8m, int8,
    float8, side-band, compact NB, gemm_any.cu's) carry ``mainloop``.
    The emi8 GEMV and GEMM run on three paths: their timed numbers and
    ``shapes`` are MX-FP6 emi8 at block 32, ``shapes_emi8m_block16`` the
    emi8m stream."""
    paths = {"mxfp6": counts, "quant_kv": qcounts, **ocounts, **icounts}
    flat = {**{f"two_layer_{c}": n for c, n in tcounts.items()},
            "w8a8_entry_point": scounts, "quantizer_entry_point": mcounts,
            "block_routes_entry_point": rcounts, **(extra_flat or {})}

    def by_path(name):
        return launches_by_path(paths, flat, name)

    meta = (
        ("dequant_gemv_emi8", "dequant_gemv.cu", 162, 8),
        ("dequant_matmul_emi8", "dequant_matmul.cu", 71, 1024),
        ("dequant_gemv_nb", "nb_matmul.cu", 821, 8),
        ("dequant_gemm_nb", "nb_matmul.cu", 821, 1024),
        ("dequant_gemv_outlier", "outlier_matmul.cu", 111, 8),
        ("dequant_gemm_outlier", "outlier_matmul.cu", 111, 1024))
    out = []
    for name, src, line, m_at in meta:
        emi8 = name.endswith("_emi8")
        mine = [r for r in (rows if emi8 else orows) if r["kernel"] == name]
        at = next(r for r in mine if r["linear"] == "gate_up"
                  and r["M"] == m_at)
        launches = by_path(name)
        rec = {
            "name": name, "route": "cuda",
            "source": f"microscopiq_tpu_torch/ops/cuda/csrc/{src}",
            "replaces": f"microscopiq_tpu/ops/pallas/dequant_matmul.py:{line}",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "at": f"gate_up (4096, 28672) M={m_at}"
                  + (", MX-FP6 emi8 block 32" if emi8 else ""),
            "shapes": _shape_rows(mine)}
        if name in ("dequant_gemm_outlier", "dequant_matmul_emi8",
                    "dequant_gemm_nb"):
            rec["mainloop"] = SM90_SOURCE
        if name in ("dequant_gemm_outlier", "dequant_matmul_emi8"):
            rec["blocks"] = _route_rows(rrows, name)
            rec["block_keys"] = list(ROUTE_KEYS)
        if emi8:
            em = [r for r in orows if r["kernel"] == name]
            rec["max_abs_err_emi8m_block16"] = max(r["max_abs_err"]
                                                   for r in em)
            rec["shapes_emi8m_block16"] = _shape_rows(em)
        out.append(rec)
    timed = [r for r in qrows if "ms" in r]
    at = next(r for r in timed if r["config"] == "b4_3136")
    launches = by_path("quant_attention")
    out.append({
        "name": "quant_attention", "route": "cuda",
        "source": "microscopiq_tpu_torch/ops/cuda/csrc/quant_attention.cu",
        "replaces": "microscopiq_tpu/ops/pallas/quant_attention.py:49",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max(max(r["max_abs_err"], r["decode_max_abs_err"])
                           for r in qrows),
        "ms": at["decode_ms"], "plain_ms": at["decode_plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "chunk_attention_ms": at["ms"],
        "at": "B=4, 3136 live tokens, H=32, KVH=8, hd=128, gap=64, 4 bits; "
              "ms: quant_attention_decode (one launch a layer, as the main "
              "path calls it), device time; chunk_attention_ms: the same "
              "kernel's chunks alone",
        "shapes": [{k: r[k] for k in ("config", "B", "live_tokens", "ms",
                                      "graph_ms", "wrapper_ms", "decode_ms",
                                      "decode_graph_ms",
                                      "decode_launches_per_call",
                                      "bound_ms", "plain_ms",
                                      "decode_plain_ms", "library_ms",
                                      "max_abs_err", "rel_err",
                                      "decode_rel_err")}
                   for r in timed]})

    short = ("case", "linear", "M", "ms", "bound_ms", "plain_ms",
             "library_ms", "rel_err")
    # (decode, the case timed in the record, the linear it is timed at)
    timed_case = {"sb4": ("int4_sb4", "gate_up"),
                  "native": ("int8_native", "gate_up"),
                  "sb2": ("int2_sb2", "gate_up"), "pf4": ("fp4_pf4", "gate_up"),
                  "pf6": ("fp6_pf6", "gate_up"),
                  "bf16": ("bf16_container", "gate_up"),
                  "fp16": ("fp16_container", "gate_up"),
                  "fp8_e4m3": ("fp8_e4m3_native", "gate_up"),
                  "fp8_e5m2": ("fp8_e5m2_native", "gate_up")}
    for kind, src, line, m_at in (("gemv", "dequant_gemv.cu", 162, 8),
                                  ("matmul", "dequant_matmul.cu", 71, 1024)):
        for decode, (case, lin) in timed_case.items():
            name = f"dequant_{kind}_{decode}"
            mine = [r for r in irows if r["kernel"] == name]
            at = next(r for r in mine if r["case"] == case
                      and r["linear"] == lin and r["M"] == m_at)
            launches = by_path(name)
            fmt = INT_CASES[case]
            out.append({
                "name": name, "route": "cuda",
                "source": f"microscopiq_tpu_torch/ops/cuda/csrc/{src}",
                "replaces": "microscopiq_tpu/ops/pallas/dequant_matmul.py:"
                            + str(80 if case.endswith("2d")
                                  or decode.startswith("fp8") else line),
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": at["ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                "library_ms": at["library_ms"],
                "at": f"{lin} (K={at['K']}, N={at['N']}) M={m_at}, "
                      f"{fmt[0]} {fmt[1]} block {fmt[2]}",
                "shapes": [[r[k] for k in short] for r in mine],
                "shape_keys": list(short)})
            if kind == "matmul" and decode in ("pf6", "pf4", "fp16", "bf16",
                                               "sb4", "sb2", "native",
                                               "fp8_e4m3", "fp8_e5m2"):
                out[-1]["mainloop"] = SM90_SOURCE
                out[-1]["blocks"] = _route_rows(rrows, name)
                out[-1]["block_keys"] = list(ROUTE_KEYS)
    s8_keys = ("wrapper_ms", "kernel_ms", "quantize_ms", "bf16_gemv_ms",
               "int_mm_ms")
    for transport in ("native", "sb4", "sb2"):
        name = f"dequant_gemv_s8_{transport}"
        mine = [r for r in srows if r["kernel"] == name]
        at = next(r for r in mine if r["linear"] == "gate_up" and r["M"] == 8)
        launches = by_path(name)
        out.append({
            "name": name, "route": "cuda",
            "source": "microscopiq_tpu_torch/ops/cuda/csrc/dequant_gemv_s8.cu",
            "replaces": "microscopiq_tpu/ops/pallas/dequant_matmul.py:267",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "kernel_ms": at["kernel_ms"], "quantize_ms": at["quantize_ms"],
            "at": f"gate_up (4096, 28672) M=8, {at['format']} {transport} "
                  f"block {at['block']}; ms: device time of the call "
                  "(activation quantization, kernel, reduce); kernel_ms: "
                  "the GEMV and reduce alone; library: torch.matmul on bf16",
            "shapes": [[r[k] for k in short[1:] + s8_keys] for r in mine],
            "shape_keys": list(short[1:] + s8_keys)})
    mine = [r for r in srows if r["kernel"] == "quantize_x_int8"]
    at = next(r for r in mine if r["K"] == 4096 and r["M"] == 8)
    launches = by_path("quantize_x_int8")
    out.append({
        "name": "quantize_x_int8", "route": "cuda",
        "source": "microscopiq_tpu_torch/ops/cuda/csrc/dequant_gemv_s8.cu",
        "replaces": "microscopiq_tpu/ops/pallas/dequant_matmul.py:304 "
                    "(quantize_activations_int8, XLA beside the kernel)",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": 0.0, "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": None,
        "at": "x (8, 4096) bf16; bit-equal to its twin at every row",
        "shapes": [[r[k] for k in ("K", "M", "ms", "plain_ms", "bound_ms")]
                   for r in mine],
        "shape_keys": ["K", "M", "ms", "plain_ms", "bound_ms"]})
    at = next(r for r in mrows if r["linear"] == "gate_up"
              and r["format"] == "fp6_e3m2")
    launches = by_path("quantize_mx")
    qkeys = ("format", "block", "linear", "K", "N", "ms", "bound_ms",
             "plain_ms")
    out.append({
        "name": "quantize_mx", "route": "cuda",
        "source": "microscopiq_tpu_torch/ops/cuda/csrc/mx_quant.cu",
        "replaces": "microscopiq_tpu/ops/pallas/mx_quant.py:51",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": 0.0, "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": None,
        "at": "gate_up (4096, 28672) f32, fp6_e3m2 block 32; bit-exact in "
              "every format and shape; no single PyTorch call computes it",
        "shapes": [[r[k] for k in qkeys] for r in mrows],
        "shape_keys": list(qkeys)})
    out += block_route_records(rrows, by_path)
    out += prefill_kernel_records(prows, pcounts)
    out += gemv_kernel_records(grows, gcounts)
    return {"kernels": out}


def block_route_records(rrows, by_path) -> list:
    """The kernels line's records of the block-route entry point's kernels
    (``route_phase`` rows ``rrows``; ``by_path(name)`` their launches by
    path): gemm_any.cu's kernels (ANY_KERNELS), then gemv_any.cu's W8A8
    and bf16-x GEMVs at the blocks no multiple of 16, each beside its
    yardstick (``yardstick_ms``: the same decode at block 16 on the
    tensor-core GEMV of its kind)."""
    out = []
    for kind, (name, line) in ANY_KERNELS.items():
        mine = [r for r in rrows if r.get("any") and r["kind"] == kind
                and r["M"] == SM90_M]
        at = mine[0]
        launches = by_path(name)
        out.append({
            "name": name, "route": "cuda",
            "source": "microscopiq_tpu_torch/ops/cuda/csrc/gemm_any.cu",
            "replaces": f"microscopiq_tpu/ops/pallas/dequant_matmul.py:{line}",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "mainloop": SM90_SOURCE,
            "at": f"gate_up (4096, 28672) M={SM90_M}, {at['kind']} block "
                  f"{at['block']}" + (f", budget {at['budget']}"
                                      if at["kind"] == "sideband" else "")
                  + "; the block taken at run time",
            "blocks": [[r[k] for k in ROUTE_KEYS] for r in mine],
            "block_keys": list(ROUTE_KEYS)})
    for s8, decodes, line in ((True, S8_ANY_DECODES, None),
                              (False, GEMV_ANY_DECODES, 162)):
        for decode in decodes:
            name = (f"dequant_gemv_s8_{decode}_any" if s8
                    else f"dequant_gemv_{decode}_any")
            mine = [r for r in rrows if r["kernel"] == name]
            at = mine[0]
            yard = next(r for r in rrows if r.get("yardstick")
                        and r["kernel"] == name[:-len("_any")])
            launches = by_path(name)
            what = ("gemv_s8_any on the tensor cores after the activation "
                    "quantizer (the whole call)" if s8 else
                    "gemv_any on the tensor cores")
            out.append({
                "name": name, "route": "cuda",
                "source": "microscopiq_tpu_torch/ops/cuda/csrc/gemv_any.cu",
                "replaces": "microscopiq_tpu/ops/pallas/dequant_matmul.py:"
                            + str(267 if s8 else 80 if
                                  decode.startswith("fp8") else line),
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": at["ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                "library_ms": at["library_ms"],
                "yardstick_ms": yard["ms"],
                "at": f"gate_up (4096, 28672) M=8, {at['format']} "
                      f"{at['kind']} block {at['block']}: {what}, the "
                      "block taken at run time; yardstick_ms: the same "
                      f"decode at block {YARDSTICK_BLOCK} on "
                      + ("gemv_s8_tc" if s8 else "gemv_tc")
                      + "; library: torch.matmul on bf16",
                "blocks": [[r[k] for k in ROUTE_KEYS] for r in mine],
                "block_keys": list(ROUTE_KEYS)})
    return out


def script_kernel_records(rows, counts, meta, source, path, shape):
    """The kernels line's records of one experiment source: per kernel (per
    compiled configuration), timed at the arm that ``meta`` names (kernel ->
    (the TPU kernel's file:line, script, arm)), every arm that launches it
    listed in ``arms``; launches are the experiment path's."""
    akeys = ("arm", "tiles", "out", "ms", "ms_min", "ms_max", "rel_err")
    out = []
    for name, (replaces, script, timed) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        at = next(r for r in mine if r["arm"] == timed
                  and r["script"] == script)
        out.append({
            "name": name, "route": "cuda",
            "source": f"microscopiq_tpu_torch/ops/cuda/csrc/{source}",
            "replaces": replaces, "launches": counts.get(name, 0),
            "launches_by_path": {path: counts.get(name, 0)},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "at": f"{shape(at)}, arm {timed} {at['tiles']}; library: "
                  "torch.matmul on bf16, same passes",
            "arms": [[r[k] for k in akeys] for r in mine],
            "arm_keys": list(akeys)})
    return out


def prefill_kernel_records(prows, pcounts):
    """The kernels line's records of ``csrc/exp_prefill.cu``."""
    from microscopiq_tpu_torch.ops.cuda import exp_prefill as ep

    meta = {"exp_gemm_pre": ("exp_prefill_floor.py:77", "floor",
                             "predecoded"),
            "exp_gemm_unroll": ("exp_prefill_overlap.py:93", "overlap",
                                "unroll4"),
            "exp_gemm_pipe": ("exp_prefill_pipe.py:68", "pipe", "pipe_tn256"),
            "exp_gemm_rx": ("exp_prefill_pipe.py:150", "pipe",
                            "residentx_tn256")}
    for src, bm, bn, bk in ep.TILES:
        meta[ep.tiles_key(src, bm, bn, bk)] = (
            "exp_prefill_tiles2.py:52", "tiles2", f"{src}_bm{bm}_bn{bn}_bk{bk}")
    meta = {k: (f"scripts/{line}", f"exp_prefill_{script}", arm)
            for k, (line, script, arm) in meta.items()}
    return script_kernel_records(
        prows, pcounts, meta, "exp_prefill.cu", "prefill_experiments",
        lambda r: "gate_up (4096, 28672) M=1024")


def gemv_kernel_records(grows, gcounts):
    """The kernels line's records of ``csrc/exp_gemv.cu``: each decode
    variant, tile configuration and NB mode at its scripts' shape, M = 8."""
    from microscopiq_tpu_torch.ops.cuda import exp_gemv as eg

    meta = {eg.variant_key(v): ("scripts/exp_decode_variants.py:82",
                                "exp_decode_variants", v)
            for v in eg.VARIANTS}
    # the tile sweep's GEMV is _sad_kernel's, swept by scripts/exp_sad_tiles
    for mt, tn, kb in eg.TILES:
        meta[eg.tiles_key(mt, tn, kb)] = (
            "microscopiq_tpu/ops/pallas/dequant_matmul.py:162",
            "exp_sad_tiles", f"tm{mt}_tn{tn}_kb{kb}")
    meta.update({eg.fd_key(m): ("scripts/exp_nb_variants.py:55",
                                "exp_nb_variants", m) for m in eg.MODES})
    return script_kernel_records(
        grows, gcounts, meta, "exp_gemv.cu", "gemv_experiments",
        lambda r: f"{r['script']} (K={r['K']}, N={r['N']}) M={r['M']}")


# ---------------------------------------------------------------------------
# Slice 7: the pf6 and side-band GEMMs on the wgmma + TMA mainloop
# ---------------------------------------------------------------------------
SM90_M = 1024
SM90_SOURCE = "microscopiq_tpu_torch/ops/cuda/csrc/gemm_sm90.cuh"


def sm90_build_line(card: str) -> None:
    """The wgmma + TMA GEMMs' ptxas lines (registers, spills: pf6, pf4,
    fp16, emi8, sb4, sb2, int8 and float8 in dequant_matmul.cu, with the
    B-tile test hook's kernels, the side-band GEMM in
    outlier_matmul.cu, the compact NB GEMM in nb_matmul.cu, gemm_any.cu's
    kernels at the blocks taken at run time) and the dynamic shared memory
    that their host-side plan gives each compiled ring (ptxas reports
    static shared memory only)."""
    from microscopiq_tpu_torch.ops.cuda import build
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    lines = [ln for ln in build.ptxas_report(("dequant_matmul",
                                              "outlier_matmul", "nb_matmul",
                                              "gemm_any"))
             if "_sm90" in ln]
    slot_classes = {"sideband": (1, 2, 4, 8), "nb": dm.NB_SLOT_CLASSES}
    smem = {}
    for kind, blocks in dm.SM90_BLOCKS.items():
        for b in blocks:
            for slots in slot_classes.get(kind, (0,)):
                if dm.gemm_route(kind, b, slots) == "sm90":
                    key = f"{kind}_block{b}" + (f"_slots{slots}" if slots
                                                else "")
                    smem[key] = dm.sm90_plan(kind, 4096, 4096, b,
                                             slots)["smem_bytes"]
    for kind, block, slots in (("emi8", 48, 0), ("fp16", 48, 0),
                               ("pf6", 128, 0), ("sideband", 8, 8)):
        smem[f"{kind}_any"] = dm.sm90_plan(kind, 4096, 4096, block,
                                           slots)["smem_bytes"]
    log(phase="build_sm90", ptxas=lines, smem_bytes=smem, card=card)


def sm90_gemm_times() -> list:
    """The pf6 (MX-FP6 fp6_e3m2, block 32), side-band (int2 + fp4 outliers,
    block 16, budget 4), pf4 (fp4_e2m1, block 32), fp16-container (block
    32), emi8 (MX-FP6 fp6_e3m2, block 32, the main path's), emi8m (block
    16, the emi8m arm's merged stream of a side-band weight), compact NB
    (budget 2, the NB arm's), sb4 (int4, block 32, the int4 arm's), sb2
    (int2, block 16), int8-container (int8, block 32, the int8 arm's),
    float8 (fp8_e4m3, fp8_e5m2, block 32) and bf16-container (block 32)
    GEMMs at M = 1024 at every Llama-3-8B shape,
    beside torch.matmul on a bf16 weight of the same shape, CUDA events
    over L2-cold operand copies, on weights and x made from fixed seeds:
    two checkouts time the same operands. ``python3 chip_smoke.py
    --gemm-times`` prints the rows as one JSON line; run it in two
    checkouts in one call (this script copied into the other one) to
    compare their kernels."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    gen = torch.Generator(device="cuda").manual_seed(707)
    rows = []
    for lin, K, N in SHAPES:
        x = torch.randn((SM90_M, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for kind in ("pf6", "sideband", "pf4", "fp16", "torch_matmul",
                     "emi8", "emi8m", "nb", "sb4", "sb2", "int8",
                     "fp8_e4m3", "fp8_e5m2", "bf16"):
            if kind in ("sideband", "emi8m"):
                p = pk.pack_mx_outlier(outlier_weight((K, N), gen), 8, 8,
                                       "int2", "fp4_e2m1", std_dev=2.0,
                                       block_size=16,
                                       outlier_budget=SIDEBAND_BUDGET, axis=0)
                fn = om.dequant_gemm_outlier
                if kind == "emi8m":
                    p = pk.to_serving_layout(pk.merge_outlier_emi8(p))
                    fn = dm.dequant_gemm
            elif kind == "emi8":
                p = pk.to_serving_layout(pk.pack_mx(
                    int_weight("fp6_e3m2", (K, N), gen).float(), 8,
                    "fp6_e3m2", 32, axis=0, transport="emi8"))
                fn = dm.dequant_gemm
            elif kind == "nb":
                p = pk.pack_outlier_nb(nb_decisions(outlier_weight((K, N),
                                                                   gen)),
                                       budget=NB_BUDGET)
                fn = om.dequant_gemm_nb
            elif kind == "torch_matmul":
                p = int_weight("bfloat16", (K, N), gen) / BF16_GAIN
                fn = lambda x, w, _: torch.matmul(x, w)   # noqa: E731
            else:
                case = {"pf6": "fp6_pf6", "pf4": "fp4_pf4",
                        "fp16": "fp16_container", "bf16": "bf16_container",
                        "sb4": "int4_sb4",
                        "sb2": "int2_sb2", "int8": "int8_native",
                        "fp8_e4m3": "fp8_e4m3_native",
                        "fp8_e5m2": "fp8_e5m2_native"}[kind]
                p = int_packed(case, int_weight(INT_CASES[case][0], (K, N),
                                                gen))
                fn = dm.dequant_gemm
            nbytes = p.numel() * 2 if kind == "torch_matmul" else p.nbytes()
            nc = copies_for(nbytes)
            ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
            ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), nc)
            bound, by = row_bound(nbytes + x.numel() * 2 + SM90_M * N * 4,
                                  SM90_M, N, K)
            rows.append(dict(kernel=kind, linear=lin, M=SM90_M, K=K, N=N,
                             ms=ms, bound_ms=bound, bound_by=by))
            del ps, p
            torch.cuda.empty_cache()
    return rows


# the side-band arm's decode linears (unfused, as nn.pack_params leaves the
# side-band format): q, k, v, o, gate, up, down a layer, and the lm_head
SIDEBAND_ARM_SHAPES = (("q", 4096, 4096, 32), ("k", 4096, 1024, 32),
                       ("v", 4096, 1024, 32), ("o", 4096, 4096, 32),
                       ("gate", 4096, 14336, 32), ("up", 4096, 14336, 32),
                       ("down", 14336, 4096, 32), ("lm_head", 4096, 128256, 1))
SIDEBAND_GEMV_M = (1, 8, 64, 255)


def sideband_gemv_times() -> list:
    """The side-band GEMV (int2 + fp4 outliers, block 16, budget 4) at the
    side-band arm's decode shapes and M = 1, 8, 64, 255, beside its byte
    bound and torch.matmul on the dequantized bf16 weight, CUDA events over
    L2-cold operand copies, on weights and x made from fixed seeds: two
    checkouts time the same operands. Each row carries the launches a
    32-layer decode step makes at that shape (``per_step``), so that two
    checkouts' rows give the GEMV device time of a step. ``python3
    chip_smoke.py --gemv-times`` prints them as one JSON line; run it in
    two checkouts in one call (this script copied into the other one)."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    gen = torch.Generator(device="cuda").manual_seed(909)
    rows = []
    for lin, K, N, per_step in SIDEBAND_ARM_SHAPES:
        p = pk.pack_mx_outlier(outlier_weight((K, N), gen), 8, 8, "int2",
                               "fp4_e2m1", std_dev=2.0, block_size=16,
                               outlier_budget=SIDEBAND_BUDGET, axis=0)
        dense = pk.dequantize_mx_outlier(p, torch.bfloat16)
        nc, nd = copies_for(p.nbytes()), copies_for(dense.numel() * 2)
        ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
        ds = [dense] + [dense.clone() for _ in range(nd - 1)]
        for M in SIDEBAND_GEMV_M:
            x = torch.randn((M, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            got = om.dequant_gemv_outlier(x, p, torch.float32)
            ref = om.dequant_matmul_outlier_reference(x, p, torch.float32)
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not (np.isfinite(rel) and rel < OUTLIER_REL_TOL):
                raise AssertionError(f"side-band GEMV {lin} M={M}: rel err "
                                     f"{rel}")
            ms = cuda_ms(lambda i: om.dequant_gemv_outlier(
                x, ps[i], torch.float32), nc)
            lib_ms = cuda_ms(lambda i: torch.matmul(x, ds[i]), nd)
            nbytes = p.nbytes() + M * K * 2 + M * N * 4
            rows.append(dict(linear=lin, K=K, N=N, M=M, per_step=per_step,
                             ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             library_ms=lib_ms, rel_err=rel))
        del ps, ds, p, dense
        torch.cuda.empty_cache()
    return rows


# (decode, format, transport, block) of --gemv-times: every decode of the
# dequant GEMV, packed as the main paths and kernel phases pack it
GEMV_TIME_CASES = (("emi8", "fp6_e3m2", "emi8", 32),
                   ("native", "int8", "native", 32),
                   ("sb4", "int4", "sb4", 32), ("sb2", "int2", "sb2", 16),
                   ("pf4", "fp4_e2m1", "pf4", 32),
                   ("pf6", "fp6_e3m2", "pf6", 32),
                   ("bf16", "bfloat16", "native", 32),
                   ("fp16", "fp16", "native", 16),
                   ("fp8_e4m3", "fp8_e4m3", "native", 32),
                   ("fp8_e5m2", "fp8_e5m2", "native", 32))


def gemv_times() -> list:
    """Every decode of the dequant GEMV (M = 1, 8, 64) and the NB GEMV
    (budget 2, M = 1, 8, 64, 255) at the five Llama-3-8B shapes, then the
    side-band GEMV's rows (``sideband_gemv_times``): each held to its plain
    twin, timed with CUDA events over L2-cold operand copies beside its
    byte bound, ``torch.matmul`` on a bf16 weight of the shape and its HBM
    rate (and, in a checkout that has them, the tensor-core GEMVs' plan and
    occupancy), on weights and x made from fixed seeds: two checkouts time
    the same operands. ``python3 chip_smoke.py --gemv-times`` prints them
    as one JSON line; run it in two checkouts in one call (this script
    copied into the other one), alternated."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    gen = torch.Generator(device="cuda").manual_seed(808)
    rows = []

    def timed(kernel, tag, w, ps, fn, ref_fn, xs, lib, K, N):
        for M, x in xs.items():
            got = fn(x, w, torch.float32)
            ref = ref_fn(x, w, torch.float32)
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not (np.isfinite(rel) and rel < GEMV_REL_TOL):
                raise AssertionError(f"{kernel} {tag} M={M}: rel err {rel}")
            ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), len(ps))
            nbytes = w.nbytes() + M * K * 2 + M * N * 4
            rows.append(dict(kernel=kernel, **tag, M=M, K=K, N=N, ms=ms,
                             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             library_ms=lib[M], rel_err=rel,
                             **gemv_stats(w, M, K, N, ms)))

    for lin, K, N in SHAPES:
        dense = torch.randn((K, N), generator=gen, device="cuda",
                            dtype=torch.bfloat16) * 0.02
        ds = [dense] + [dense.clone()
                        for _ in range(copies_for(dense.numel() * 2) - 1)]
        xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for M in OUTLIER_M}
        lib = {M: cuda_ms(lambda i: torch.matmul(x, ds[i]), len(ds))
               for M, x in xs.items()}
        del ds, dense
        for decode, fmt, transport, bs in GEMV_TIME_CASES:
            p = pk.to_serving_layout(pk.pack_mx(
                int_weight(fmt, (K, N), gen).float(), 8, fmt, bs, axis=0,
                transport=transport))
            if dm.sad_decode_params(p)[0] != decode:
                raise AssertionError(f"{fmt} {transport}: not {decode}")
            ps = [p] + [_clone_packed(p)
                        for _ in range(copies_for(p.nbytes()) - 1)]
            timed("dequant_gemv", dict(decode=decode, block=bs, linear=lin),
                  p, ps, dm.dequant_gemv, dm.dequant_matmul_reference,
                  {M: xs[M] for M in GEMV_M}, lib, K, N)
            del p, ps
        nb = pk.pack_outlier_nb(nb_decisions(outlier_weight((K, N), gen)),
                                budget=NB_BUDGET)
        ps = [nb] + [_clone_packed(nb)
                     for _ in range(copies_for(nb.nbytes()) - 1)]
        timed("dequant_gemv_nb", dict(decode="nb", budget=NB_BUDGET,
                                      linear=lin),
              nb, ps, om.dequant_gemv_nb, om.dequant_matmul_nb_reference, xs,
              lib, K, N)
        del nb, ps, xs
        torch.cuda.empty_cache()
    return rows + [dict(kernel="dequant_gemv_outlier", **r)
                   for r in sideband_gemv_times()]


# ---------------------------------------------------------------------------
# Slice 8: every MX block the JAX packers take, on its GEMM route
# ---------------------------------------------------------------------------
# (kind, format, block, budget): the blocks that no other phase packs, for
# pf6 (fp6_e3m2; packers: block % 32 == 0), pf4 (fp4_e2m1; % 16), the fp16
# and bf16 containers, emi8 (fp6_e3m2, any block), the side-band format
# (int2 + fp4, any block), sb4 (int4; % 2), sb2 (int2; % 4), the int8
# container (kind "native", its decode) and the float8 containers (any
# block), every one on the sm90 loop: compiled for the block at 8 and 64
# (sb4 also at 2, sb2 at 4, pf4 at 16), gemm_any.cu's kernel, which takes
# the block at run time, at 48 and 128 (emi8 at both, sb2 also at 12; int8
# and float8 at 2 and 48) and for the side-band format at block 8 with 8
# slots. The compact NB format (block 16) takes the sm90 loop at every
# budget its packer makes (up to 16): it has no case here.
ROUTE_CASES = (("pf6", "fp6_e3m2", 64, 0), ("pf6", "fp6_e3m2", 128, 0),
               ("pf4", "fp4_e2m1", 16, 0), ("pf4", "fp4_e2m1", 64, 0),
               ("pf4", "fp4_e2m1", 48, 0), ("fp16", "fp16", 8, 0),
               ("fp16", "fp16", 64, 0), ("fp16", "fp16", 48, 0),
               ("bf16", "bfloat16", 8, 0), ("bf16", "bfloat16", 64, 0),
               ("bf16", "bfloat16", 48, 0),
               ("sideband", "int2", 8, 4), ("sideband", "int2", 64, 4),
               ("sideband", "int2", 48, 4), ("sideband", "int2", 8, 8),
               ("emi8", "fp6_e3m2", 8, 0), ("emi8", "fp6_e3m2", 64, 0),
               ("emi8", "fp6_e3m2", 48, 0), ("emi8", "fp6_e3m2", 128, 0),
               ("sb4", "int4", 2, 0), ("sb4", "int4", 8, 0),
               ("sb4", "int4", 64, 0), ("sb4", "int4", 48, 0),
               ("sb2", "int2", 4, 0), ("sb2", "int2", 64, 0),
               ("sb2", "int2", 48, 0), ("sb2", "int2", 12, 0))
ROUTE_CASES += tuple((kind, fmt, block, 0)
                     for kind, fmt in (("native", "int8"),
                                       ("fp8_e4m3", "fp8_e4m3"),
                                       ("fp8_e5m2", "fp8_e5m2"))
                     for block in (8, 64, 2, 48))
# gemm_any.cu's kernels' records: kind -> (record name, TPU kernel line);
# each launch counts under its wrapper's counter, and by_route_kernel
# gives it to these names by its row's ``any`` (the route is the weight's)
ANY_KERNELS = {**{k: (f"gemm_any_sm90_{k}", 80 if k.startswith("fp8")
                      else 71)
                  for k in ("pf6", "pf4", "fp16", "bf16", "emi8", "sb4",
                            "sb2", "native", "fp8_e4m3", "fp8_e5m2")},
               "sideband": ("sideband_any_sm90", 111)}
ROUTE_KEYS = ("kind", "block", "budget", "ms", "bound_ms", "plain_ms",
              "library_ms", "rel_err")
# the decodes whose GEMV takes gemv_any.cu's kernel (the block at run
# time) at a block of ROUTE_CASES (blocks no multiple of 16): emi8 and the
# 16-bit containers at 8, sb4 at 2 and 8, sb2 at 4 and 12, the int8 and
# float8 containers at 8 and 2
GEMV_ANY_DECODES = ("emi8", "fp16", "bf16", "sb4", "sb2", "native",
                    "fp8_e4m3", "fp8_e5m2")
# the W8A8 GEMV's decodes, on gemv_any.cu's gemv_s8_any at the blocks of
# ROUTE_CASES no multiple of 16 (int8 at 8 and 2, sb4 at 2 and 8, sb2 at 4
# and 12) and at S8_EXTRA_CASES (sb4 at 4, sb2 at 8), which no GEMM case
# packs
S8_ANY_DECODES = ("native", "sb4", "sb2")
S8_EXTRA_CASES = (("sb4", "int4", 4, 0), ("sb2", "int2", 8, 0))
# the yardstick of the block routes' GEMVs: the same decodes at block 16,
# on the tensor-core GEMVs (gemv_tc, gemv_s8_tc), in the same phase
YARDSTICK_BLOCK = 16


def _route_case(kind, fmt, block, budget, shape, gen):
    """A ROUTE_CASES weight of ``shape`` from ``gen`` and (GEMM wrapper,
    plain twin, dense bf16 weight, launch counter)."""
    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    import torch

    if kind == "sideband":
        p = pk.pack_mx_outlier(outlier_weight(shape, gen), 8, 8, fmt,
                               "fp4_e2m1", std_dev=2.0, block_size=block,
                               outlier_budget=budget, axis=0)
        return (p, om.dequant_gemm_outlier,
                om.dequant_matmul_outlier_reference,
                pk.dequantize_mx_outlier(p, dtype=torch.bfloat16),
                om.gemm_counter(block, budget))
    transport = ("native" if kind in ("fp16", "bf16", "native", "fp8_e4m3",
                                      "fp8_e5m2") else kind)
    # bfloat16 blocks of 8 need 16x BF16_GAIN for amax > 2 in every block
    # (none at the -127 exponent the kernels clamp)
    W = int_weight(fmt, shape, gen).float()
    p = pk.to_serving_layout(pk.pack_mx(
        W * 16 if fmt == "bfloat16" and block < 32 else W, 8, fmt, block,
        axis=0, transport=transport))
    del W
    return (p, dm.dequant_gemm, dm.dequant_matmul_reference,
            pk.dequantize_mx(p, dtype=torch.bfloat16),
            dm.gemm_counter(kind, block))


def route_times() -> list:
    """Each case of ROUTE_CASES at gate_up, M = 1024, through its GEMM
    wrapper alone (the route that ``gemm_route`` names), CUDA events over
    L2-cold operand copies, on weights and x made from fixed seeds, beside
    the operation bound: ``python3 chip_smoke.py --route-times`` prints
    the rows as one JSON line; it calls only wrappers that the previous
    tree has too, so run it in two checkouts in one call (this script
    copied into the other one) to compare their kernels."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    _, K, N = next(s for s in SHAPES if s[0] == "gate_up")
    gen = torch.Generator(device="cuda").manual_seed(808)
    x = torch.randn((SM90_M, K), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    rows = []
    for kind, fmt, block, budget in ROUTE_CASES:
        p, fn, _, dense, name = _route_case(kind, fmt, block, budget, (K, N),
                                            gen)
        del dense
        nc = copies_for(p.nbytes())
        ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
        ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), nc)
        bound, by = row_bound(p.nbytes() + x.numel() * 2 + SM90_M * N * 4,
                              SM90_M, N, K)
        any_block = getattr(dm, "block_is_any", lambda *a: False)
        rows.append(dict(kind=kind, block=block, budget=budget, kernel=name,
                         route=dm.gemm_route(kind, block, budget),
                         any=any_block(kind, block, budget), ms=ms,
                         bound_ms=bound, bound_by=by))
        del ps, p
        torch.cuda.empty_cache()
    return rows


# (kind, format, block) of --gemv-route-times: the GEMVs of the block
# routes at the blocks no multiple of 16 (ROUTE_CASES, S8_EXTRA_CASES) and
# the 16-bit containers at 256 (gemv_partial's and s8_partial's before
# gemv_any.cu, or refused by the W8A8 wrapper), and each decode at block 16
# on the tensor-core GEMVs
GEMV_ROUTE_TIME_CASES = tuple(
    (k, f, b) for k, f, b, _ in ROUTE_CASES + S8_EXTRA_CASES
    if k in GEMV_ANY_DECODES and b % 16) + (
    ("bf16", "bfloat16", 256), ("fp16", "fp16", 256)) + tuple(
    (k, next(f for kk, f, _, _ in ROUTE_CASES if kk == k), YARDSTICK_BLOCK)
    for k in GEMV_ANY_DECODES)
GEMV_ROUTE_TIME_M = (1, 8, 64)


def gemv_route_times() -> list:
    """Each case of GEMV_ROUTE_TIME_CASES at gate_up, M = 1, 8, 64: the
    dequant GEMV and, for the int decodes, the W8A8 call (activation
    quantizer, GEMV, reduce), each through its wrapper alone (the route
    that ``gemv_route`` / ``s8_route`` names), CUDA events over L2-cold
    operand copies (the W8A8 call replayed from a CUDA graph of 16 calls,
    ``graph_ms``: its host time exceeds its device time), on weights and
    x made from fixed seeds, beside the
    byte bound and torch.matmul on a bf16 weight of the shape; a call that
    the wrapper refuses, or whose launch fails, is a row with ``refused``
    (the previous tree: the W8A8 wrapper below 4 packed rows a block,
    gemv_partial's 64 KB of x above block 192 at M >= 8). ``python3 chip_smoke.py
    --gemv-route-times`` prints the rows as one JSON line; it calls only
    wrappers that the previous tree has too, so run it in two checkouts
    in one call (this script copied into the other one) to compare their
    kernels."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    _, K, N = next(s for s in SHAPES if s[0] == "gate_up")
    gen = torch.Generator(device="cuda").manual_seed(808)
    xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                         dtype=torch.bfloat16) for M in GEMV_ROUTE_TIME_M}
    dense = torch.randn((K, N), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 0.02
    ds = [dense] + [dense.clone()
                    for _ in range(copies_for(dense.numel() * 2) - 1)]
    lib = {M: cuda_ms(lambda i: torch.matmul(x, ds[i]), len(ds))
           for M, x in xs.items()}
    del ds, dense
    rows = []
    for kind, fmt, block in GEMV_ROUTE_TIME_CASES:
        p, _, _, dense, _ = _route_case(kind, fmt, block, 0, (K, N), gen)
        del dense
        ps = [p] + [_clone_packed(p)
                    for _ in range(copies_for(p.nbytes()) - 1)]
        calls = [("dequant_gemv", dm.gemv_route(kind, block),
                  dm.dequant_gemv, 2, cuda_ms)]
        if kind in S8_ANY_DECODES:
            calls.append(("dequant_matmul_sad_s8", dm.s8_route(kind, block),
                          dm.dequant_matmul_sad_s8, 1, graph_ms))
        for call, route, fn, xb, timer in calls:
            for M, x in xs.items():
                row = dict(call=call, kind=kind, format=fmt, block=block,
                           M=M, route=route, library_ms=lib[M],
                           bound_ms=(p.nbytes() + M * K * xb + M * N * 4)
                           / HBM_BYTES_PER_S * 1e3)
                try:
                    row["ms"] = timer(
                        lambda i: fn(x, ps[i], torch.float32), len(ps))
                except (ValueError, RuntimeError) as e:
                    # the previous tree's refusal or failed launch
                    row["refused"] = f"{type(e).__name__}: {e}"
                rows.append(row)
        del ps, p
        torch.cuda.empty_cache()
    return rows


def _route_rows(rrows, name):
    """The block-route rows of the kernel compiled per block that counts
    under ``name`` (gemm_any.cu's rows have records of their own)."""
    return [[r[k] for k in ROUTE_KEYS] for r in rrows
            if r["kernel"] == name and not r.get("any")]


def _block_gemv_row(p, fmt, xg, ps, ds, card, mode="full") -> dict:
    """One GEMV row of the block routes: the dequant GEMV of ``p`` at M =
    len(xg) on the kernel that ``gemv_route`` names, one launch of its
    counter, held to the plain twin (1e-5); ``mode`` "full": the kernel
    timed over the L2-cold copies ``ps`` beside the bound, the plain
    version and torch.matmul over the dense copies ``ds``; "yardstick":
    the kernel alone (the row's ``yardstick``); "check": no time."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    decode, M, K, N = (dm.sad_decode_params(p)[0], len(xg), p.orig_dim,
                       p.codes.shape[-1])
    block = p.block_size
    name = dm.gemv_counter(decode, block)
    reset_counts()
    got = dm.dequant_gemv(xg, p, torch.float32)
    want = dm.dequant_matmul_reference(xg, p, torch.float32)
    torch.cuda.synchronize()
    if launches()[name] != 1:
        raise AssertionError(f"{decode} block {block}: no {name}")
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    if not (np.isfinite(rel) and rel < GEMV_REL_TOL):
        raise AssertionError(f"{name} block {block}: rel err {rel}")
    bound, by = row_bound(p.nbytes() + xg.numel() * 2 + M * N * 4, M, N, K)
    row = dict(kernel=name, route=dm.gemv_route(decode, block), kind=decode,
               format=fmt, block=block, budget=0, linear="gate_up", M=M,
               K=K, N=N, max_abs_err=err, rel_err=rel, tol=GEMV_REL_TOL,
               bound_ms=bound, bound_by=by, card=card)
    if mode == "check":
        return row
    ms = cuda_ms(lambda i: dm.dequant_gemv(xg, ps[i], torch.float32),
                 len(ps))
    row.update(ms=ms, **gemv_stats(p, M, K, N, ms))
    if mode == "yardstick":
        return dict(row, yardstick=True)
    return dict(row, plain_ms=cuda_ms(
        lambda i: dm.dequant_matmul_reference(xg, p, torch.float32), 1,
        target_ms=20.0),
        library_ms=cuda_ms(lambda i: torch.matmul(xg, ds[i]), len(ds)))


def _block_s8_row(p, fmt, xg, ps, ds, card, mode="full") -> dict:
    """One W8A8 row of the block routes: dequant_matmul_sad_s8 of ``p`` at M
    = len(xg) (the activation quantizer, then the GEMV that ``s8_route``
    names: one launch of each), held to its plain twin (1e-5); the whole
    call's device time (``graph_ms``: its host time exceeds it) over the
    L2-cold copies ``ps``, and in ``mode`` "full" the plain version and
    torch.matmul beside it."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    decode, M, K, N = (dm.sad_decode_params(p)[0], len(xg), p.orig_dim,
                       p.codes.shape[-1])
    block = p.block_size
    name = dm.s8_counter(decode, block)
    reset_counts()
    got = dm.dequant_matmul_sad_s8(xg, p, torch.float32)
    want = dm.dequant_matmul_sad_s8_reference(xg, p, torch.float32)
    torch.cuda.synchronize()
    if launches()[name] != 1 or launches()["quantize_x_int8"] != 1:
        raise AssertionError(f"{decode} block {block}: no {name}")
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    if not (np.isfinite(rel) and rel < GEMV_REL_TOL):
        raise AssertionError(f"{name} block {block}: rel err {rel}")
    ms = graph_ms(lambda i: dm.dequant_matmul_sad_s8(xg, ps[i],
                                                     torch.float32), len(ps))
    bound, by = row_bound(p.nbytes() + M * K + M * N * 4, M, N, K)
    row = dict(kernel=name, route=dm.s8_route(decode, block), kind=decode,
               format=fmt, block=block, budget=0, linear="gate_up", M=M,
               K=K, N=N, max_abs_err=err, rel_err=rel, tol=GEMV_REL_TOL,
               ms=ms, bound_ms=bound, bound_by=by, card=card)
    if mode == "yardstick":
        return dict(row, yardstick=True)
    return dict(row, plain_ms=cuda_ms(
        lambda i: dm.dequant_matmul_sad_s8_reference(xg, p, torch.float32),
        1, target_ms=20.0),
        library_ms=cuda_ms(lambda i: torch.matmul(xg, ds[i]), len(ds)))


def _copies(p, dense):
    """L2-cold copies of a packed weight and of its dense bf16 weight."""
    ps = [p] + [_clone_packed(p) for _ in range(copies_for(p.nbytes()) - 1)]
    ds = [dense] + [dense.clone()
                    for _ in range(copies_for(dense.numel() * 2) - 1)]
    return ps, ds


def route_phase(card: str):
    """Each case of ROUTE_CASES at gate_up, M = 1024, through the GEMM
    wrapper against its plain twin (2e-3 of max |twin|), on the kernel that
    ``gemm_route`` names (always the sm90 loop: compiled for the block, or
    gemm_any.cu's kernel, ``block_is_any``), and (all but the side-band
    format) at M = 8 through the GEMV on the kernel that ``gemv_route``
    names (1e-5: ``_block_gemv_row``; timed where it is gemv_any.cu's
    kernel, the blocks no multiple of 16), and for the decodes of
    S8_ANY_DECODES at the blocks that ``s8_route`` gives gemv_any.cu's
    kernel the W8A8 GEMV at M = 8 (1e-5: ``_block_s8_row``), with
    S8_EXTRA_CASES besides, each timed beside the bound, the plain version
    and torch.matmul on the dequantized bf16 weight; then the same decodes
    at block 16 on the tensor-core GEMVs, timed as yardsticks (rows with
    ``yardstick``); then the entry point's own run: one call a case (not
    the yardsticks), counts zeroed just before and read just after, each
    launch of a case on gemm_any.cu's kernel (its row's ``any``) given to
    its ANY_KERNELS name. Returns (rows, launches)."""
    import torch

    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    _, K, N = next(s for s in SHAPES if s[0] == "gate_up")
    gen = torch.Generator(device="cuda").manual_seed(808)
    x = torch.randn((SM90_M, K), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    xg = x[:8]
    rows, weights = [], []
    for kind, fmt, block, budget in ROUTE_CASES + S8_EXTRA_CASES:
        gemm = (kind, fmt, block, budget) in ROUTE_CASES
        p, fn, ref, dense, name = _route_case(kind, fmt, block, budget,
                                              (K, N), gen)
        ps, ds = _copies(p, dense)
        if gemm:
            route = dm.gemm_route(kind, block, budget)
            if route != "sm90":
                raise AssertionError(f"{kind} block {block}: route {route}")
            reset_counts()
            got = fn(x, p, torch.float32)
            want = ref(x, p, torch.float32)
            torch.cuda.synchronize()
            if launches()[name] != 1:
                raise AssertionError(f"{kind} block {block}: no {name}")
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not (np.isfinite(rel) and rel < GEMM_REL_TOL):
                raise AssertionError(f"{name} block {block}: rel err {rel}")
            ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), len(ps))
            plain_ms = cuda_ms(lambda i: ref(x, p, torch.float32), 1,
                               target_ms=20.0)
            lib_ms = cuda_ms(lambda i: torch.matmul(x, ds[i]), len(ds))
            bound, by = row_bound(
                p.nbytes() + x.numel() * 2 + SM90_M * N * 4, SM90_M, N, K)
            any_block = dm.block_is_any(kind, block, budget)
            row = dict(kernel=name, route=route, any=any_block, kind=kind,
                       format=fmt, block=block, budget=budget,
                       linear="gate_up", M=SM90_M, K=K, N=N,
                       max_abs_err=err, rel_err=rel, tol=GEMM_REL_TOL, ms=ms,
                       bound_ms=bound, bound_by=by, plain_ms=plain_ms,
                       library_ms=lib_ms, card=card)
            rows.append(row)
            log(phase="gemm_block_routes", **row)
            weights.append((fn, p, x))
            del got, want
        if gemm and kind != "sideband":
            # the GEMV at the same block, on the kernel gemv_route names
            # (gemv_tc, timed at block 32 by the other phases, not here;
            # or gemv_any.cu's: its "_any" counter, timed)
            row = _block_gemv_row(p, fmt, xg, ps, ds, card,
                                  "full" if dm.gemv_route(kind, block)
                                  == "any" else "check")
            rows.append(row)
            log(phase="gemv_block_routes", **row)
            weights.append((dm.dequant_gemv, p, xg))
        if kind in S8_ANY_DECODES and dm.s8_route(kind, block) == "any":
            # the W8A8 GEMV at the same block on gemv_any.cu's gemv_s8_any,
            # after the one-launch activation quantizer
            row = _block_s8_row(p, fmt, xg, ps, ds, card)
            rows.append(row)
            log(phase="s8_block_routes", **row)
            weights.append((dm.dequant_matmul_sad_s8, p, xg))
        del ps, ds, dense
        torch.cuda.empty_cache()
    # the yardsticks: each decode at block 16 on gemv_tc (and gemv_s8_tc)
    for decode in GEMV_ANY_DECODES:
        fmt = next(f for k, f, _, _ in ROUTE_CASES if k == decode)
        p, _, _, dense, _ = _route_case(decode, fmt, YARDSTICK_BLOCK, 0,
                                        (K, N), gen)
        ps, _ = _copies(p, dense[:1])
        row = _block_gemv_row(p, fmt, xg, ps, None, card, "yardstick")
        rows.append(row)
        log(phase="gemv_block_routes", **row)
        if decode in S8_ANY_DECODES:
            row = _block_s8_row(p, fmt, xg, ps, None, card, "yardstick")
            rows.append(row)
            log(phase="s8_block_routes", **row)
        del p, ps, dense
        torch.cuda.empty_cache()
    reset_counts()
    for fn, p, xi in weights:
        fn(xi, p, torch.bfloat16)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    want = {}
    for r in rows:
        if r.get("yardstick"):
            continue
        want[r["kernel"]] = want.get(r["kernel"], 0) + 1
        if r["kernel"].startswith("dequant_gemv_s8_"):
            want["quantize_x_int8"] = want.get("quantize_x_int8", 0) + 1
    if counts != want:
        raise AssertionError(f"block-route entry point launches {counts}, "
                             f"want {want}")
    del weights
    torch.cuda.empty_cache()
    return rows, by_route_kernel(rows, counts)


def by_route_kernel(rows, counts) -> dict:
    """The block-route entry point's launch ``counts`` (one a row of
    ``rows``, under the wrappers' counters) with each launch of a row on
    gemm_any.cu's kernel (``any``) moved from its counter to its
    ANY_KERNELS name: the route is chosen from the weight alone, so the
    row says which kernel its one launch ran."""
    out = dict(counts)
    for r in rows:
        if r.get("any"):
            name = ANY_KERNELS[r["kind"]][0]
            out[r["kernel"]] -= 1
            out[name] = out.get(name, 0) + 1
    return {k: v for k, v in out.items() if v}


# ---------------------------------------------------------------------------
# Serving front-ends, generation evals, the KV accuracy probe, the other
# model families and local HF checkpoints
# ---------------------------------------------------------------------------
FRONT_NEW = 32                 # new tokens a front-end request
FRONT_WORDS = (16, 120)        # words a prompt
FRONT_MODELS = ("llama3-8b-mxfp6", "llama3-8b-mxfp6-loop")


def _words(rng, n: int) -> str:
    from microscopiq_tpu_torch.eval.data import _WORDS

    return " ".join(rng.choice(np.asarray(_WORDS), n))


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def frontends_phase(model, card: str):
    """The serving stack over loopback HTTP on the 32-layer MX-FP6 model:
    nine concurrent requests through the OpenAI gateway (chat, three as
    SSE), the web server and the CLI, every answer held to a 1-slot engine
    (engine-backed) or to ``generate`` at B = 1 (decode-loop worker).
    Returns the launch counts."""
    import io
    import tempfile
    import threading
    import urllib.request

    import torch

    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.serve import cli, stack, worker
    from microscopiq_tpu_torch.serve.engine import BatchEngine
    from microscopiq_tpu_torch.serve.openai_api import OpenAIGateway
    from microscopiq_tpu_torch.serve.web_server import WebServer

    tok = stack.Crc32Tok(model.cfg.vocab_size)
    eng_kw = dict(n_slots=4, max_len=320, prompt_buckets=(64, 128, 256))
    logs = tempfile.TemporaryDirectory()           # the web server's log
    reset_counts()
    st = stack.start_stack(model, tok, FRONT_MODELS[0], log_dir=logs.name,
                           **eng_kw)
    urls = st["urls"]
    loop = worker.serve_worker(worker.ModelWorker(
        urls["controller"], "PENDING", [FRONT_MODELS[1]],
        worker.torch_generate_stream_fn(model, tok, cache_kind="dense"),
        register=False), "127.0.0.1", 0)
    loop.worker.worker_addr = f"http://127.0.0.1:{loop.server_address[1]}"
    threading.Thread(target=loop.serve_forever, daemon=True).start()
    loop.worker.register_to_controller()

    rng = np.random.default_rng(28)
    lens = rng.integers(FRONT_WORDS[0], FRONT_WORDS[1] + 1, 9)
    # (kind, model): six chats (the odd ones streamed), two web chats, one
    # CLI message; the decode-loop worker takes a chat, the SSE chat after
    # it and a web chat
    plan = [("chat", 0), ("sse", 0), ("chat", 1), ("sse", 1), ("chat", 0),
            ("sse", 0), ("web", 0), ("web", 1), ("cli", 0)]
    jobs = [dict(kind=k, model=FRONT_MODELS[m], text=_words(rng, int(n)))
            for (k, m), n in zip(plan, lens)]

    def post(url, body, stream):
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        t0 = time.perf_counter()
        first, out = None, b""
        with urllib.request.urlopen(req, timeout=600) as r:
            while True:
                chunk = r.read(1 if stream else 65536)
                if not chunk:
                    break
                if stream and first is None and (
                        b"content" in out + chunk or b'"text"' in out + chunk):
                    first = time.perf_counter() - t0
                out += chunk
        return out.decode(), first

    def run(job):
        try:
            msgs = [{"role": "user", "content": job["text"]}]
            if job["kind"] in ("chat", "sse"):
                body = {"model": job["model"], "messages": msgs,
                        "max_tokens": FRONT_NEW, "temperature": 0.0,
                        "stream": job["kind"] == "sse"}
                raw, first = post(urls["openai"] + "/v1/chat/completions",
                                  body, job["kind"] == "sse")
                if job["kind"] == "sse":
                    evs = [json.loads(l[6:]) for l in raw.splitlines()
                           if l.startswith("data: ") and l != "data: [DONE]"]
                    job["answer"] = "".join(
                        e["choices"][0]["delta"].get("content", "")
                        for e in evs)
                else:
                    job["answer"] = json.loads(raw)["choices"][0][
                        "message"]["content"]
                job["prompt"] = OpenAIGateway(urls["controller"]
                                              ).chat_prompt(msgs)
            elif job["kind"] == "web":
                body = {"model": job["model"], "messages": msgs,
                        "temperature": 0.0, "max_new_tokens": FRONT_NEW}
                raw, first = post(urls["web"] + "/api/chat", body, True)
                last = [json.loads(l) for l in raw.splitlines() if l][-1]
                if "error" in last:
                    raise RuntimeError(last["error"])
                job["answer"] = last["text"]
                job["prompt"] = WebServer(urls["controller"]).build_prompt(
                    msgs)
            else:
                t0 = time.perf_counter()
                job["answer"] = cli.test_message(
                    urls["controller"], job["model"], job["text"],
                    FRONT_NEW, out=io.StringIO())
                first = None
                job["prompt"] = job["text"]
                job["seconds"] = time.perf_counter() - t0
            job["first_s"] = first
        except Exception as e:                       # reported below
            job["error"] = f"{type(e).__name__}: {e}"

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    counts = launches()
    stack.stop_stack(st)
    loop.shutdown()
    loop.server_close()
    loop.worker.shutdown()
    logs.cleanup()
    errors = [j["error"] for j in jobs if "error" in j]
    if errors:
        raise AssertionError(f"frontends: request errors {errors}")

    # the references: a 1-slot engine (engine-backed), generate at B = 1
    one = BatchEngine(model, device="cuda", **{**eng_kw, "n_slots": 1})
    equal = 0
    for j in jobs:
        ids = np.asarray(tok.encode(j["prompt"]), np.int64)
        if j["model"] == FRONT_MODELS[0]:
            want = tok.decode(one.generate([ids], FRONT_NEW)[0])
        else:
            want = tok.decode(generate(model, ids[None], FRONT_NEW)[0]
                              .tolist())
        if j["answer"] != want:
            raise AssertionError(f"frontends: a {j['kind']} answer of "
                                 f"{j['model']} differs from its reference")
        equal += 1
    del one
    for name in ("dequant_gemv_emi8", "dequant_matmul_emi8"):
        if not counts[name]:
            raise AssertionError(f"frontends: {name} never launched")
    firsts = [j["first_s"] for j in jobs if j.get("first_s") is not None]
    new_tokens = sum(j["answer"].count("<") for j in jobs)
    log(phase="frontends", requests=len(jobs), wall_s=wall,
        requests_per_s=len(jobs) / wall, tokens=new_tokens,
        tokens_per_s=new_tokens / wall, streamed=len(firsts),
        first_chunk_p50_s=_pct(firsts, 50), first_chunk_p90_s=_pct(firsts, 90),
        prompt_words=[int(n) for n in lens],
        kinds=[f"{j['kind']}:{j['model']}" for j in jobs],
        answers_equal_to_reference=equal, loopback="127.0.0.1, port 0",
        launches={k: v for k, v in counts.items() if v}, card=card)
    return {"prefill": want_counts(), "decode": counts}


COT_LIMIT, COT_NEW = 4, 48


def cot_evals_phase(model, card: str):
    """GSM8K (synthetic rows) over the dense and the 4-bit quantized engine
    and BBH/MMLU/AQuA over the dense one, on the 32-layer MX-FP6 model; an
    oracle scores 1.0 on each task; two prompts' generations equal a
    1-slot engine's. Returns the launch counts."""
    import torch

    from microscopiq_tpu_torch.eval import cot_tasks, gsm8k
    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.serve import stack
    from microscopiq_tpu_torch.serve.engine import BatchEngine

    tok = stack.Crc32Tok(model.cfg.vocab_size)
    kw = dict(n_slots=8, max_len=256, prompt_buckets=(64, 128, 192),
              device="cuda")
    # the oracle: the answer read back from the rows
    rows = gsm8k.load_gsm8k(COT_LIMIT)
    by_q = {r["question"]: r["answer"] for r in rows}
    for task in ("bbh", "mmlu", "aqua"):
        by_q.update({r["question"]: f"The answer is ({r['answer']})."
                     for r in cot_tasks.load_task(task, COT_LIMIT)})

    def oracle(prompts):
        qs = [p.split("Question: ")[-1].split("\nLet's think")[0]
              for p in prompts]
        return [by_q[q] for q in qs]

    oracle_acc = {"gsm8k": gsm8k.evaluate_gsm8k(oracle, COT_LIMIT)[
        "accuracy"]}
    for task in ("bbh", "mmlu", "aqua"):
        oracle_acc[task] = cot_tasks.evaluate_cot_task(
            task, oracle, COT_LIMIT)["accuracy"]
    if set(oracle_acc.values()) != {1.0}:
        raise AssertionError(f"cot_evals: the oracle scored {oracle_acc}")

    seen = []

    def keep(fn):
        def run(prompts):
            outs = fn(prompts)
            seen.extend(zip(prompts, outs))
            return outs
        return run

    reset_counts()
    t0 = time.perf_counter()
    dense = BatchEngine(model, **kw)
    fn = keep(gsm8k.engine_generate_fn(dense, tok, COT_NEW))
    acc = {"gsm8k_dense": gsm8k.evaluate_gsm8k(fn, COT_LIMIT)["accuracy"]}
    for task in ("bbh", "mmlu", "aqua"):
        acc[task] = cot_tasks.evaluate_cot_task(task, fn, COT_LIMIT)[
            "accuracy"]
    del dense
    quant = BatchEngine(model, cache_kind="quant",
                        quant_cfg=QuantKVConfig(**QKV_CFG), **kw)
    qfn = gsm8k.engine_generate_fn(quant, tok, COT_NEW)
    acc["gsm8k_quant4"] = gsm8k.evaluate_gsm8k(qfn, COT_LIMIT)["accuracy"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches()
    del quant
    one = BatchEngine(model, **{**kw, "n_slots": 1})
    for prompt, out in (seen[0], seen[-1]):
        ids = np.asarray(tok.encode(prompt), np.int32)
        if tok.decode(one.generate([ids], COT_NEW)[0]) != out:
            raise AssertionError("cot_evals: a generation differs from the "
                                 "1-slot engine's")
    del one
    for name in ("dequant_gemv_emi8", "dequant_matmul_emi8",
                 "quant_attention"):
        if not counts[name]:
            raise AssertionError(f"cot_evals: {name} never launched")
    log(phase="cot_evals", limit=COT_LIMIT, new_tokens=COT_NEW,
        accuracy=acc, oracle_accuracy=oracle_acc, seconds=seconds,
        identical_to_one_slot_engine=2,
        note="random weights: the accuracies are expected near 0",
        launches={k: v for k, v in counts.items() if v}, card=card)
    return {"prefill": want_counts(), "decode": counts}


KV_ACC_AGREE = 0.99            # card vs CPU predictions, dense and KIVI-2bit
KV_ACC_STEPS = 400             # the script's training steps


def kv_accuracy_phase(card: str):
    """The copy probe (``scripts/kv_accuracy.py``) trained and evaluated on
    the card; its ordering checks; dense and KIVI-2bit predictions on 16
    rows against the port's CPU run on the same weights."""
    import torch

    from microscopiq_tpu_torch.eval.retrieval import (copy_predictions,
                                                      sample_copy)
    from microscopiq_tpu_torch.models import LlamaForCausalLM
    from microscopiq_tpu_torch.scripts import kv_accuracy as ka

    t0 = time.perf_counter()
    model, task, train_s, tree = ka.trained(KV_ACC_STEPS, device="cuda",
                                            retrain=True, log_every=0)
    results = ka.evaluate(model, task)
    checks = ka.ordering_checks(results)
    eval_s = time.perf_counter() - t0 - train_s

    def to_cpu(t):
        return ({k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict)
                else t.cpu())

    cpu = LlamaForCausalLM(model.cfg, device="cpu").load_params(
        to_cpu(tree))
    ids = sample_copy(np.random.default_rng(99), task, 16)
    agree = {}
    for arm in ("dense", "KIVI-2bit"):
        kw = ka.arm_kwargs(arm, model, task)
        a = copy_predictions(model, task, ids, **kw)
        b = copy_predictions(cpu, task, ids, **kw)
        agree[arm] = float((a == b).mean())
    log(phase="kv_accuracy", train_steps=KV_ACC_STEPS, train_s=train_s,
        eval_s=eval_s,
        accuracy={k: v["accuracy"] for k, v in results.items()},
        ordering_checks=checks, card_vs_cpu_agreement=agree,
        agreement_rows=16, tol=KV_ACC_AGREE, card=card)
    if not all(checks.values()):
        raise AssertionError(f"kv_accuracy: ordering checks {checks}")
    if min(agree.values()) < KV_ACC_AGREE:
        raise AssertionError(f"kv_accuracy: card vs CPU agreement {agree}")


FAMILIES = (("llama2_7b", {}), ("mistral_7b", {"sliding_window": 64}),
            ("mixtral_8x7b", {}), ("mpt_7b", {}))
FAMILY_B, FAMILY_S0, FAMILY_STEPS = 4, 128, 32


def family_gemv_checks(model, name: str) -> list:
    """Every distinct packed linear of a family (by K and N: its
    projections, experts, router and lm_head) through ``dequant_matmul`` at
    the decode's M = FAMILY_B, against its plain version on the same input
    within GEMV_REL_TOL; each call must launch the GEMV once and nothing
    else. These are the decode's shapes (the router's N = 8 on plain
    copies), which the prefill's logits, taken through the GEMM, do not
    reach. Returns one row a linear."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    gen = torch.Generator(device=model.device).manual_seed(4321)
    rows, shapes = [], set()
    for lin, m in model.named_modules():
        w = getattr(m, "kernel", None)
        if not isinstance(w, pk.PackedMX):
            continue
        K, N = w.orig_dim, pk.to_serving_layout(w).codes.shape[-1]
        if (K, N) in shapes:
            continue
        shapes.add((K, N))
        x = torch.randn((FAMILY_B, K), generator=gen, device=model.device,
                        dtype=torch.bfloat16)
        before = launches()
        got = dm.dequant_matmul(x, w, torch.float32)
        ran = {k: v - before.get(k, 0) for k, v in launches().items()
               if v != before.get(k, 0)}
        ref = dm.dequant_matmul_reference(x, w, torch.float32)
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        decode = dm.sad_decode_params(w)[0]
        counter = dm.gemv_counter(decode, w.block_size)
        tma = (dm.gemv_plan(decode, N, K, w.block_size, FAMILY_B)["tma"]
               if dm.gemv_route(decode, w.block_size) == "tc" else None)
        rows.append(dict(linear=lin, K=K, N=N, M=FAMILY_B, kernel=counter,
                         tma=tma, max_abs_err=err, rel_err=rel))
        if ran != {counter: 1}:
            raise AssertionError(f"{name} {lin} (K={K}, N={N}): launched "
                                 f"{ran}, not {counter} once")
        if not (np.isfinite(rel) and rel < GEMV_REL_TOL):
            raise AssertionError(f"{name} {lin} (K={K}, N={N}) GEMV at "
                                 f"M={FAMILY_B}: rel err {rel} >= "
                                 f"{GEMV_REL_TOL}")
        del x, got, ref
    return rows


def families_phase(card: str):
    """Llama-2-7B, Mistral-7B, Mixtral-8x7B and MPT-7B at full published
    width, 2 layers, MX-FP6 emi8 block 32 by ``pack_params`` (every linear,
    the lm_head and the router included): the graph decode against eager,
    kernel logits against the plain twins, Mixtral's router choices, and
    each distinct linear's GEMV at the decode's M against its plain version
    (:func:`family_gemv_checks`).
    Returns {family: launch counts}."""
    import torch

    from microscopiq_tpu_torch.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM,
                                                    build_params)
    from microscopiq_tpu_torch.nn import fuse_projections, pack_params
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    specs = finalize_mx_specs({"w_elem_format": "fp6_e3m2",
                               "scale_bits": 8, "block_size": 32})
    out = {}
    for seed, (name, kw) in enumerate(FAMILIES):
        t0 = time.perf_counter()
        moe = name.startswith("mixtral")
        cfg = getattr(LlamaConfig, name)(num_hidden_layers=2,
                                         dtype=torch.bfloat16,
                                         fused_projections=not moe, **kw)
        tree = pack_params(build_params(cfg, seed=20 + seed, device="cuda")[
            "params"], specs, skip=())
        if not moe:
            tree = fuse_projections(tree)
        model = LlamaForCausalLM(cfg, device="cuda").load_params(tree)
        twin = LlamaForCausalLM(cfg, use_kernels=False,
                                device="cuda").load_params(tree)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weight_bytes = sum(m.kernel.nbytes() for m in model.modules()
                           if hasattr(getattr(m, "kernel", None), "nbytes")
                           and callable(m.kernel.nbytes))
        weight_bytes += model.model.embed_tokens.nbytes
        ids = torch.as_tensor(np.random.default_rng(30 + seed).integers(
            0, cfg.vocab_size, (FAMILY_B, FAMILY_S0)), device="cuda")
        max_len = FAMILY_S0 + FAMILY_STEPS + 8
        prefill_decode(model, ids, 2, max_len)              # warm-up
        reset_counts()
        run = prefill_decode(model, ids, FAMILY_STEPS, max_len)
        toks, ttft, dec, last, pre, decc, *_ = run
        _check_tokens(name, toks, last, cfg.vocab_size)
        for k, want in (("dequant_matmul_emi8", pre),
                        ("dequant_gemv_emi8", decc)):
            if not want[k]:
                raise AssertionError(f"{name}: {k} never launched")
        graph_vs_eager(model, ids, FAMILY_STEPS, max_len, f"family_{name}",
                       run, card)
        # the prefill's logits, kernels vs plain twins (Mistral: a
        # cacheless 256-token forward under its 64-token window)
        fids = ids
        if cfg.sliding_window is not None:
            fids = torch.as_tensor(np.random.default_rng(40).integers(
                0, cfg.vocab_size, (FAMILY_B, 256)), device="cuda")
        router, hooks, seen = {}, [], []
        logs = {"kernels": [], "plain": []}
        if moe:
            # the router's inputs (kernel run) and logits (both runs)
            for tag, m in (("kernels", model), ("plain", twin)):
                for layer in m.model.layers:
                    hooks.append(layer.block_sparse_moe.gate.
                                 register_forward_hook(
                                     lambda mod, args, out, tag=tag:
                                     logs[tag].append(out.detach().float())))
            hooks += [layer.block_sparse_moe.register_forward_pre_hook(
                lambda mod, args: seen.append(args[0].detach().clone()))
                for layer in model.model.layers]
        with torch.inference_mode():
            a = model(fids).float()
            b = twin(fids).float()
            for h in hooks:
                h.remove()
            keep = torch.ones(fids.shape, dtype=torch.bool, device="cuda")
            if moe:
                K = cfg.num_experts_per_tok
                agree, distinct, gaps = [], [], []
                for li, x in enumerate(seen):
                    # the same input through the router's GEMM and its twin
                    got = model.model.layers[li].block_sparse_moe.route(x)[1]
                    ref_mod = twin.model.layers[li].block_sparse_moe
                    top = torch.topk(ref_mod.gate(x).float(), K + 1,
                                     dim=-1).values
                    clear = (top[..., K - 1] - top[..., K]) > 1e-3 * top.abs(
                    ).amax(-1)
                    want = ref_mod.route(x)[1]
                    same = (got.sort(-1).values == want.sort(-1).values
                            ).all(-1)
                    agree.append(same[clear].float().mean().item())
                    distinct.append(clear.float().mean().item())
                    # the two forwards: a token whose choice differs at a
                    # layer (its first) must be a near-tie of the twin's
                    # logits there; it is left out of the logits' check
                    la, lb = logs["kernels"][li], logs["plain"][li]
                    ca = torch.topk(la, K, dim=-1).indices.sort(-1).values
                    cb = torch.topk(lb, K, dim=-1).indices.sort(-1).values
                    first = (ca != cb).any(-1) & keep
                    tb = torch.topk(lb, K + 1, dim=-1).values
                    gap = (tb[..., K - 1] - tb[..., K]) / lb.abs().amax(-1)
                    gaps += gap[first].tolist()
                    keep &= ~first
                router = dict(
                    router_agreement_same_input_by_layer=agree,
                    router_distinct_share_by_layer=distinct,
                    tokens_routed_differently=int((~keep).sum()),
                    tokens=int(keep.numel()),
                    their_router_gap_max=max(gaps, default=0.0),
                    all_tokens_rel_err=((a - b).abs().max()
                                        / b.abs().max()).item())
                del seen, logs
        err = (a - b)[keep].abs().max().item()
        rel = err / b[keep].abs().max().item()
        counts = {k: pre[k] + decc[k] for k in pre}
        gemv = family_gemv_checks(model, name)
        log(phase="families", family=name, layers=2, batch=FAMILY_B,
            prompt=FAMILY_S0, steps=FAMILY_STEPS,
            hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
            heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
            vocab=cfg.vocab_size, experts=cfg.num_local_experts,
            pos_emb=cfg.pos_emb, norm=cfg.norm_type, mlp=cfg.mlp_type,
            tied=cfg.tie_word_embeddings, window=cfg.sliding_window,
            logits_tokens=int(fids.shape[1]), prefill_max_abs_err=err,
            prefill_rel_err=rel, tol=LOGIT_REL_TOL, ttft_ms=ttft * 1e3,
            decode_ms_per_step=dec / FAMILY_STEPS * 1e3,
            weight_gb=weight_bytes / 1e9, build_s=build_s,
            launches={k: v for k, v in counts.items() if v}, **router,
            gemv_vs_plain=gemv, gemv_tol=GEMV_REL_TOL, card=card)
        if not rel < LOGIT_REL_TOL:
            raise AssertionError(f"{name}: kernel vs plain logits rel err "
                                 f"{rel}")
        if moe and (min(router["router_agreement_same_input_by_layer"])
                    < 1.0 or router["their_router_gap_max"] >= LOGIT_REL_TOL
                    or router["tokens_routed_differently"]
                    > router["tokens"] // 20):
            raise AssertionError(f"{name}: router choices differ beyond "
                                 f"near-ties: {router}")
        out[f"family_{name}"] = {"prefill": pre, "decode": decc}
        del model, twin, tree, a, b, run
        torch.cuda.empty_cache()
    return out


def _write_bf16_safetensors(state, path) -> None:
    """A BF16 ``.safetensors`` file of ``state`` (8-byte little-endian
    header length, JSON header, raw bytes), written here so that the
    package needs no writer."""
    import struct

    import torch

    header, blobs, at = {}, [], 0
    for k, v in state.items():
        b = v.detach().to(torch.bfloat16).contiguous().cpu().view(
            torch.int16).numpy().tobytes()
        header[k] = {"dtype": "BF16", "shape": list(v.shape),
                     "data_offsets": [at, at + len(b)]}
        blobs.append(b)
        at += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for b in blobs:
            f.write(b)


def hf_loading_phase(card: str):
    """The seeded 2-layer Llama-2-7B-width tree exported, written as a
    ``.bin`` and a BF16 ``.safetensors`` checkpoint, loaded back by the
    CLI's ``build_model``: trees and greedy tokens equal."""
    import tempfile

    import torch

    from microscopiq_tpu_torch.cli.llm_cli import build_model
    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.models import loading
    from microscopiq_tpu_torch.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM,
                                                    build_params)

    t0 = time.perf_counter()
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
    tree = build_params(cfg, seed=7, device="cuda")
    state = loading.export_llama_state_dict(tree, cfg)
    want = {k: v.to(torch.bfloat16).float() for k, v in state.items()}
    hf_cfg = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "num_key_value_heads": cfg.num_key_value_heads,
              "max_position_embeddings": cfg.max_position_embeddings,
              "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
              "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 24))
    ref = LlamaForCausalLM(cfg, device="cuda").load_params(tree)
    ref_toks = generate(ref, prompt, 16)
    del ref
    rec = {}
    for kind in ("bin", "safetensors"):
        # one checkpoint on disk at a time
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(hf_cfg, f)
            w0 = time.perf_counter()
            if kind == "bin":
                torch.save({k: v.to(torch.bfloat16).cpu()
                            for k, v in state.items()},
                           os.path.join(d, "pytorch_model.bin"))
            else:
                _write_bf16_safetensors(state, os.path.join(
                    d, "model.safetensors"))
            write_s = time.perf_counter() - w0
            file_gb = sum(os.path.getsize(os.path.join(d, f))
                          for f in os.listdir(d)) / 1e9
            l0 = time.perf_counter()
            _, c, cls, params, tok = build_model(d, "cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - l0
            got = loading.load_hf_state_dict(d, device="cuda")
        if got.keys() != want.keys() or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"hf_loading: the {kind} checkpoint's "
                                 "tensors differ from the export")
        m = cls(c, device="cuda").load_params(params)
        toks = generate(m, prompt, 16)
        if not np.array_equal(toks, ref_toks):
            raise AssertionError(f"hf_loading: greedy tokens of the {kind} "
                                 "checkpoint differ")
        rec[kind] = dict(file_gb=file_gb, write_s=write_s,
                         build_model_s=load_s, tokenizer=tok is not None,
                         tensors=len(got), tokens_equal=True)
        del m, params, got
        torch.cuda.empty_cache()
    # build_model imports transformers where it is installed, for its
    # optional tokenizer; the port must not pull JAX in through it
    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "flax")))
    log(phase="hf_loading", config="llama2_7b, 2 layers", files=rec,
        seconds=time.perf_counter() - t0, jax_modules=len(jax_loaded),
        card=card)
    if jax_loaded:
        raise AssertionError(f"hf_loading: JAX was imported: "
                             f"{jax_loaded[:5]}")


# --------------------------------------------------------------- slice 18
# MX fake-quant layers, card against CPU: the same float32 inputs and
# seeded cotangents; outputs and gradients within one bfloat16 step
# (2^-7) of max |CPU| (the layers round to bfloat16 containers after
# exp/tanh/sums whose last float32 ulp differs between the two devices)
MX_LAYER_REL_TOL = 2.0 ** -7
# the activation-quantized OPT, card against CPU. Its int4 activation
# quantizer turns float32 ulps into flipped roundings and outlier choices,
# which 12 layers amplify: 1e-7 relative noise on the weights moves the CPU's
# own perplexity by 0.14-0.85% at 6 layers (PERF.md), more than the 0.4%
# between the actquant and dense perplexities, so window 0's perplexity is
# reported against 1e-3 as a target and bounds nothing. The check is per
# linear: each of the 72 MX linears of the card's forward against the CPU's
# on the input the card gave it (the quantizers are bit-equal, only the
# float32 sums' order differs), so a forward that skipped the activation
# quantizer fails it
ACTQUANT_REL_TOL = 1e-3
ACTQUANT_LINEAR_REL_TOL = 1e-5
# scripts.mx_ffn's mse at the logged steps, card against CPU
MX_FFN_REL_TOL = 1e-2
# the gate_up linear's autograd gradients against their formula, of max
GRAD_FORMULA_REL_TOL = 1e-6
# the reference's activation-quantization config (scripts/parity_ref.py
# ACT_CFG, with a_axes=1 as its actquant run sets it)
ACT_CFG = dict(w_elem_format="fp4", a_elem_format="int4", block_size=128,
               quantize_backprop=False, a_axes=1)


def _canonical_specs(qbp: bool, **kw):
    """The reference's canonical MX config: fp6_e3m2 weights and
    activations, scale_bits 4, block 32, bfloat16 containers (``kw``
    overrides)."""
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    return finalize_mx_specs(dict(dict(
        w_elem_format="fp6_e3m2", a_elem_format="fp6_e3m2", scale_bits=4,
        block_size=32, bfloat=16, quantize_backprop=qbp), **kw))


def _bits_differ(a, b):
    """Mask of the elements whose float32 bits differ, NaN equal to NaN
    (the devices propagate NaN payloads and signs differently)."""
    import torch

    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    nan = torch.isnan(a) & torch.isnan(b)
    return (a.view(torch.int32) != b.view(torch.int32)) & ~nan


def mx_quantizer_checks() -> list:
    """The fake-quant quantizers on the card against the port's CPU run on
    the same float32 inputs: bit for bit."""
    import torch

    from microscopiq_tpu_torch.formats import get_format_params
    from microscopiq_tpu_torch.ops import elemwise as te
    from microscopiq_tpu_torch.ops.mx import quantize_mx_op
    from microscopiq_tpu_torch.ops.outlier import quantize_mx_outlier_op
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    rng = np.random.default_rng(1800)
    x = (rng.standard_normal((1024, 1024)) * np.exp(
        rng.uniform(-4, 4, (1024, 1024)))).astype(np.float32)
    x.flat[:6] = [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-42]
    xc = torch.from_numpy(x)
    draws = torch.from_numpy(rng.random(x.shape, dtype=np.float32))
    # scale_bits 8 (at 4 most blocks of this range overflow to NaN), and
    # the canonical 4 once
    s = _canonical_specs(True, scale_bits=8)
    cases = []
    for rnd in ("nearest", "floor", "even"):
        for knob in ({"bfloat": 16}, {"fp": 16}, {"bfloat": 12,
                                                  "bfloat_subnorms": False}):
            sp = finalize_mx_specs(dict(knob, w_elem_format="int8"))
            cases.append((f"quantize_elemwise_op {knob} {rnd}",
                          lambda t, sp=sp, r=rnd: te.quantize_elemwise_op(
                              t, sp, round=r)))
    for fmt in ("fp6_e3m2", "int4", "fp8_e4m3", "fp4_e2m1"):
        for axes in ([-1], [0]):
            cases.append((f"quantize_mx_op {fmt} axes={axes}",
                          lambda t, f=fmt, a=axes: quantize_mx_op(
                              t, s, elem_format=f, axes=a)))
    cases.append(("quantize_mx_op fp6_e3m2 axes=[-1] scale_bits 4",
                  lambda t: quantize_mx_op(t, _canonical_specs(True),
                                           elem_format="fp6_e3m2",
                                           axes=[-1])))
    for inl, out in (("fp6_e3m2", "fp6_e3m2"), ("int4", "fp8_e4m3")):
        cases.append((f"quantize_mx_outlier_op {inl}+{out}",
                      lambda t, i=inl, o=out: quantize_mx_outlier_op(
                          t, s, inlier_elem_format=i, outlier_elem_format=o,
                          axes=[-1])))
    for fmt in ("fp6_e3m2", "int4"):
        ebits, mbits, _, max_norm, _ = get_format_params(fmt)
        cases.append((f"dither {fmt} (given draws)",
                      lambda t, e=ebits, m=mbits, mn=max_norm:
                      te.quantize_elemwise_core(
                          t, m, e, mn, round="dither",
                          rand=draws.to(t.device))))
    rows = []
    for name, fn in cases:
        want = fn(xc)
        got = fn(xc.cuda())
        torch.cuda.synchronize()
        diff = int(_bits_differ(got, want).sum())
        rows.append(dict(quantizer=name, elements=int(xc.numel()),
                         nan_share=float(torch.isnan(want).float().mean()),
                         bits_differ=diff))
        if diff:
            raise AssertionError(f"mx_layers: {name} on the card differs "
                                 f"from the CPU in {diff} of "
                                 f"{xc.numel()} elements")
    return rows


def _layer_cases():
    """(name, make(spec, device) -> (fn, inputs)) of every MX layer: fn
    takes the inputs (the parameters of a module among them) and returns
    a tensor or a tuple of them."""
    import copy

    import torch

    from microscopiq_tpu_torch import nn as tnn
    from microscopiq_tpu_torch.nn import norms, vector_ops

    gen = torch.Generator().manual_seed(1801)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=gen) * scale
    pos = lambda *shape: torch.rand(shape, generator=gen) + 0.25
    x3 = rnd(4, 128, 256, scale=2.0)
    cases = []

    def add(name, fn_of_spec, inputs):
        cases.append((name, fn_of_spec, inputs))

    def module_case(name, module, x):
        """A copy of the module a call, on the device with the spec, its
        parameters passed as inputs so that their gradients are compared
        too."""
        names = [n for n, _ in module.named_parameters()]
        params = [p.detach().clone() for _, p in module.named_parameters()]

        def fn_of_spec(spec, dev):
            m = copy.deepcopy(module)
            for sub in m.modules():
                if hasattr(sub, "mx_specs"):
                    sub.mx_specs = spec
            m = m.to(dev)
            return lambda a, *p: torch.func.functional_call(
                m, dict(zip(names, p)), (a,))
        add(name, fn_of_spec, [x] + params)

    add("ste_elemwise", lambda s, d: lambda a: tnn.ste_elemwise(
        a, s, "nearest"), [x3])
    add("ste_mx", lambda s, d: lambda a: tnn.ste_mx(
        a, s, "fp6_e3m2", (-1,)), [x3])
    add("ste_mx_outlier", lambda s, d: lambda a: tnn.ste_mx_outlier(
        a, s, "int4", "fp6_e3m2", (-1,)), [x3])
    for name in ("exp", "exp2", "recip", "sqrt", "tanh"):
        f = getattr(vector_ops, "vec_" + name)
        add("vec_" + name, lambda s, d, f=f: lambda a: f(a, s),
            [pos(4, 128, 256)])
    add("vec_div", lambda s, d: lambda a, b: vector_ops.vec_div(a, b, s),
        [pos(4, 128, 256), pos(4, 128, 256)])
    for name in ("add", "sub", "mul", "div"):
        f = getattr(tnn, "simd_" + name)
        add("simd_" + name, lambda s, d, f=f: lambda a, b: f(a, b, s),
            [x3, pos(4, 128, 256)])
    for name in ("sqrt", "square", "exp", "log"):
        f = getattr(tnn, "simd_" + name)
        add("simd_" + name, lambda s, d, f=f: lambda a: f(a, s),
            [pos(4, 128, 256)])
    for name in ("reduce_sum", "reduce_mean", "norm"):
        f = getattr(tnn, "simd_" + name)
        add("simd_" + name, lambda s, d, f=f: lambda a: (
            f(a, axis=-1, keepdims=True, mx_specs=s), f(a, mx_specs=s)),
            [pos(4, 128, 256)])
    add("simd_split", lambda s, d: lambda a: tuple(tnn.simd_split(
        a, 4, axis=-1, mx_specs=s)), [x3])
    for name in ("relu", "relu6", "gelu", "tanh", "sigmoid", "silu"):
        f = getattr(tnn, name)
        add(name, lambda s, d, f=f: lambda a: f(a, s), [x3])
    add("leaky_relu", lambda s, d: lambda a: tnn.leaky_relu(a, 0.1, s),
        [x3])
    add("softmax", lambda s, d: lambda a: tnn.softmax(a, -1, s), [x3])
    add("softmax_exp2", lambda s, d: lambda a: tnn.softmax(
        a, -1, s.replace(softmax_exp2=True)), [x3])
    w = rnd(512, 256, scale=256 ** -0.5)
    add("mx_linear", lambda s, d: lambda a, w, b: tnn.mx_linear(a, w, b, s),
        [x3, w, rnd(512, scale=0.1)])
    add("matmul aw", lambda s, d: lambda a, b: tnn.matmul(a, b, s, "aw"),
        [x3, rnd(256, 192, scale=0.0625)])
    add("bmm", lambda s, d: lambda a, b: tnn.bmm(a, b, s),
        [x3, rnd(4, 256, 64, scale=0.0625)])
    add("mx_op_table", lambda s, d: lambda a, b: (
        tnn.mx_op_table(s)["add"](a, b), tnn.mx_op_table(s)["gelu"](a),
        tnn.mx_op_table(s)["linear"](a, b[:64])), [x3, rnd(128, 256)])
    module_case("MXLinear", tnn.MXLinear(256, 384, device="cpu",
                                         generator=gen), x3)
    # the norms' mx branch: norm_forward of the quantized input
    add("LayerNorm", lambda s, d: lambda a, w, b: norms.norm_forward(
        tnn.ste_elemwise(a, s, None), (-1,), w, b, 1e-5, s),
        [x3, 1 + rnd(256, scale=0.1), rnd(256, scale=0.1)])
    add("RMSNorm", lambda s, d: lambda a, w: norms.norm_forward(
        tnn.ste_elemwise(a, s, None), (-1,), w, None, 1e-6, s,
        use_mean=False), [x3, 1 + rnd(256, scale=0.1)])
    module_case("GroupNorm", tnn.GroupNorm(4, 32, device="cpu"),
                rnd(4, 32, 12, 12))
    module_case("BatchNorm (training)",
                tnn.BatchNorm(32, use_running_average=False,
                              device="cpu").train(),
                rnd(4, 32, 12, 12) + 1)
    add("conv1d", lambda s, d: lambda a, w, b: tnn.conv1d(
        a, w, b, stride=2, padding=1, mx_specs=s),
        [rnd(4, 64, 100), rnd(96, 64, 3, scale=0.1), rnd(96)])
    add("conv2d", lambda s, d: lambda a, w, b: tnn.conv2d(
        a, w, b, stride=2, padding=1, groups=2, mx_specs=s),
        [rnd(4, 64, 24, 24), rnd(96, 32, 3, 3, scale=0.1), rnd(96)])
    add("conv3d", lambda s, d: lambda a, w, b: tnn.conv3d(
        a, w, b, stride=1, padding=1, mx_specs=s),
        [rnd(2, 32, 8, 8, 8), rnd(32, 32, 3, 3, 3, scale=0.1), rnd(32)])
    add("conv_transpose2d", lambda s, d: lambda a, w, b: tnn.conv_transpose2d(
        a, w, b, stride=2, padding=1, mx_specs=s),
        [rnd(4, 64, 12, 12), rnd(64, 32, 3, 3, scale=0.1), rnd(32)])
    add("adaptive_avg_pool2d", lambda s, d: lambda a: tnn.adaptive_avg_pool2d(
        a, (6, 4), s), [rnd(4, 64, 24, 24)])
    module_case("Conv2d", tnn.Conv2d(64, 64, 3, padding=1, device="cpu",
                                     generator=gen),
                rnd(4, 64, 16, 16))
    module_case("LSTM", tnn.LSTM(64, 64, device="cpu", generator=gen),
                rnd(6, 8, 64))
    return cases


def _flat(out) -> list:
    """The tensors of a (nested) tuple, in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def mx_layer_checks() -> list:
    """Every MX layer forward and backward on the card and on the CPU
    (``quantize_backprop`` on and off), same inputs and cotangents:
    outputs and input/parameter gradients within MX_LAYER_REL_TOL of max
    |CPU|; the share of elements that differ is reported."""
    import torch

    rows = []
    for name, fn_of_spec, inputs in _layer_cases():
        for qbp in (True, False):
            spec = _canonical_specs(qbp)
            got = {}
            for dev in ("cpu", "cuda"):
                args = [a.detach().to(dev, copy=True).requires_grad_()
                        for a in inputs]
                outs = _flat(fn_of_spec(spec, dev)(*args))
                gen = torch.Generator().manual_seed(1802)
                cots = [torch.randn(o.shape, generator=gen).to(dev)
                        for o in outs]
                torch.autograd.backward(outs, cots)
                got[dev] = ([o.detach().cpu() for o in outs]
                            + [a.grad.cpu() for a in args])
            worst, differ, total = 0.0, 0, 0
            for c, g in zip(got["cpu"], got["cuda"]):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"mx_layers: {name} (qbp={qbp}) "
                                         "is not finite on the card")
                scale = float(c.abs().max()) or 1.0
                worst = max(worst, float((g - c).abs().max()) / scale)
                differ += int((g != c).sum())
                total += c.numel()
            rows.append(dict(layer=name, quantize_backprop=qbp,
                             tensors=len(got["cpu"]), max_rel_err=worst,
                             differ_share=differ / total))
            if worst > MX_LAYER_REL_TOL:
                raise AssertionError(
                    f"mx_layers: {name} (qbp={qbp}) card against CPU: "
                    f"{worst} of max > {MX_LAYER_REL_TOL}")
    return rows


def quantized_linear_checks() -> list:
    """``nn.QuantizedLinear`` on packed MX-FP6 (emi8, block 32) and compact
    NB weights at the o shape: equal to ``dequant_matmul`` /
    ``dequant_matmul_nb`` on the same operands, one GEMV launch at M = 8
    and nothing else, and within GEMV_REL_TOL of the plain twin."""
    import torch

    from microscopiq_tpu_torch import nn as tnn
    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    gen = torch.Generator(device="cuda").manual_seed(1803)
    K, N, M = 4096, 4096, 8
    W = outlier_weight((K, N), gen)
    packs = {
        "mx_fp6": (pk.to_serving_layout(pk.pack_mx(
            W.float(), 8, "fp6_e3m2", 32, axis=0, transport="emi8")),
            dm.dequant_matmul, dm.dequant_matmul_reference),
        "nb": (pk.pack_outlier_nb(nb_decisions(W), budget=NB_BUDGET),
               om.dequant_matmul_nb, om.dequant_matmul_nb_reference)}
    x = torch.randn((M, K), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    layer = tnn.QuantizedLinear(out_dtype=torch.float32)
    rows = []
    for name, (w, direct, plain) in packs.items():
        before = launches()
        got = layer(x, w)
        ran = {k: v - before.get(k, 0) for k, v in launches().items()
               if v != before.get(k, 0)}
        want = direct(x, w, out_dtype=torch.float32)
        ref = plain(x, w, out_dtype=torch.float32)
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        rows.append(dict(weight=name, K=K, N=N, M=M, launched=ran,
                         equal_to_wrapper=bool(torch.equal(got, want)),
                         rel_err_vs_plain=rel))
        if len(ran) != 1 or not next(iter(ran)).startswith("dequant_gemv") \
                or next(iter(ran.values())) != 1:
            raise AssertionError(f"mx_layers: QuantizedLinear {name} "
                                 f"launched {ran}, not one GEMV")
        if not rows[-1]["equal_to_wrapper"]:
            raise AssertionError(f"mx_layers: QuantizedLinear {name} differs "
                                 "from its wrapper")
        if not rel < GEMV_REL_TOL:
            raise AssertionError(f"mx_layers: QuantizedLinear {name}: rel "
                                 f"err {rel} against the plain twin")
    return rows


def mx_layers_phase(card: str) -> None:
    t0 = time.perf_counter()
    quant = mx_quantizer_checks()
    layers = mx_layer_checks()
    qlin = quantized_linear_checks()
    log(phase="mx_layers", spec="fp6_e3m2 w/a, scale_bits 4, block 32, "
        "bfloat16; quantize_backprop on and off", quantizers=quant,
        layers=layers, layer_tol=MX_LAYER_REL_TOL,
        layers_max_rel_err=max(r["max_rel_err"] for r in layers),
        layers_differ_share_max=max(r["differ_share"] for r in layers),
        quantized_linear=qlin, seconds=time.perf_counter() - t0, card=card)


ACTQUANT_SEQLEN, ACTQUANT_WINDOWS = 512, 4
def actquant_inputs():
    """(cfg, spec, the seeded OPT-125M tree on the CPU, the token
    stream)."""
    from microscopiq_tpu_torch.eval.data import get_loaders
    from microscopiq_tpu_torch.models import opt
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    cfg = opt.OPTConfig.opt_125m()
    tree = opt.build_params(cfg, seed=18, device="cpu")
    _, test_ids = get_loaders("synthetic", 0, seqlen=ACTQUANT_SEQLEN,
                              allow_synthetic=True)
    return (cfg, finalize_mx_specs(ACT_CFG), tree,
            test_ids[:ACTQUANT_WINDOWS * ACTQUANT_SEQLEN])


# threads of the process that computes the CPU references (of 8 cores)
CPU_REFERENCE_THREADS = 2


def cpu_references() -> dict:
    """The CPU runs the training-path phases hold the card against:
    ``scripts.mx_ffn``'s 200 steps from its start and the activation-
    quantized OPT-125M's window-0 perplexity, with their seconds."""
    from microscopiq_tpu_torch.eval.ppl import perplexity
    from microscopiq_tpu_torch.models import opt
    from microscopiq_tpu_torch.scripts import mx_ffn

    t0 = time.perf_counter()
    ffn = mx_ffn.train(mx_ffn.numpy_start(128, 0), 200, device="cpu")
    t1 = time.perf_counter()
    cfg, spec, tree, ids = actquant_inputs()
    ppl = perplexity(
        opt.OPTForCausalLM(cfg, mx_specs=spec, mx_linear_only=True,
                           device="cpu").load_params(tree),
        ids[:ACTQUANT_SEQLEN], ACTQUANT_SEQLEN)
    return dict(mx_ffn=ffn, mx_ffn_s=t1 - t0, actquant_window0_ppl=ppl,
                actquant_window0_s=time.perf_counter() - t1,
                threads=CPU_REFERENCE_THREADS)


def start_cpu_references():
    """Start ``chip_smoke.py --cpu-references`` in a process of its own,
    so that the CPU references overlap the card's phases; it is killed
    at exit if it is still running."""
    import atexit
    import subprocess

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-references"],
        stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS=str(CPU_REFERENCE_THREADS)))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def await_cpu_references(proc, what: str = "the CPU references") -> dict:
    """The JSON line of a process that :func:`start_cpu_references` (or
    another ``start_*``) began, with the seconds waited; raises if it
    failed."""
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{what} exited {proc.returncode}")
    ref = json.loads(out.strip().splitlines()[-1])
    ref["waited_s"] = time.perf_counter() - t0
    return ref


def actquant_ppl_phase(card: str, ref: dict) -> None:
    """OPT-125M at its published size, seeded weights, under the
    reference's activation-quantization config (fp4 weights, int4
    activations, block 128, a_axes=1, only the linears MX): perplexity on
    the card over 4 windows of 512 tokens of the synthetic stream, beside
    the dense model's; window 0's against the port's CPU run (reported),
    and every MX linear against the CPU's on the input the card gave it
    (:func:`actquant_linear_checks`)."""
    import torch

    from microscopiq_tpu_torch.eval.ppl import perplexity
    from microscopiq_tpu_torch.models import opt

    t0 = time.perf_counter()
    cfg, spec, cpu_tree, ids = actquant_inputs()
    tree = _tree_to(cpu_tree, "cuda")
    seqlen = ACTQUANT_SEQLEN
    dense = opt.OPTForCausalLM(cfg, device="cuda").load_params(tree)
    aq = opt.OPTForCausalLM(cfg, mx_specs=spec, mx_linear_only=True,
                            device="cuda").load_params(tree)
    d0 = time.perf_counter()
    ppl_dense = perplexity(dense, ids, seqlen)
    torch.cuda.synchronize()
    a0 = time.perf_counter()
    ppl_aq = perplexity(aq, ids, seqlen)
    torch.cuda.synchronize()
    a1 = time.perf_counter()
    one_card = perplexity(aq, ids[:seqlen], seqlen)
    linears = actquant_linear_checks(aq, cpu_tree, ids[:seqlen])
    one_cpu = ref["actquant_window0_ppl"]
    rel = abs(one_card - one_cpu) / one_cpu
    log(phase="actquant_ppl", config="opt_125m (12 layers, hidden 768, "
        "vocab 50272), seeded weights", spec=dict(ACT_CFG,
                                                  mx_linear_only=True),
        stream=f"synthetic, {len(ids) // seqlen} x {seqlen} tokens",
        ppl_actquant=ppl_aq, ppl_dense=ppl_dense,
        window0_ppl_card=one_card, window0_ppl_cpu=one_cpu,
        window0_rel_err=rel, window0_target=ACTQUANT_REL_TOL,
        window0_target_met=rel <= ACTQUANT_REL_TOL, linears=linears,
        linears_max_rel_err=max(r["rel_err"] for r in linears),
        linear_tol=ACTQUANT_LINEAR_REL_TOL,
        actquant_s=a1 - a0, dense_s=a0 - d0,
        cpu_window_s=ref["actquant_window0_s"],
        seconds=time.perf_counter() - t0, card=card)
    if not (np.isfinite(ppl_aq) and np.isfinite(ppl_dense)):
        raise AssertionError("actquant_ppl: a perplexity is not finite")
    bad = [r for r in linears if not r["rel_err"] <= ACTQUANT_LINEAR_REL_TOL]
    if bad:
        raise AssertionError(f"actquant_ppl: MX linears on the card differ "
                             f"from the CPU's on the same input: {bad}")
    del dense, aq, tree
    torch.cuda.empty_cache()


def actquant_linear_checks(model, cpu_tree, window) -> list:
    """Every layer's MX linears (q, k, v, out, fc1, fc2) of one forward of
    ``window`` on the card, each against the same linear on the CPU
    (``cpu_tree``'s weights) on the input the card gave it: within
    ACTQUANT_LINEAR_REL_TOL of max |CPU|."""
    import torch

    from microscopiq_tpu_torch.nn import linear

    seen, hooks = [], []
    for i, layer in enumerate(model.layers):
        for name in ("self_attn.q_proj", "self_attn.k_proj",
                     "self_attn.v_proj", "self_attn.out_proj", "fc1", "fc2"):
            mod = layer.get_submodule(name)
            hooks.append(mod.register_forward_hook(
                lambda m, inp, out, key=(i, name): seen.append(
                    (key, m.mx_specs, inp[0].detach(), out.detach()))))
    with torch.no_grad():
        model(torch.as_tensor(window[None].astype(np.int64),
                              device="cuda"))
    for h in hooks:
        h.remove()
    rows = []
    for (i, name), specs, x, y in seen:
        node = cpu_tree["params"][f"layers_{i}"]
        for part in name.split("."):
            node = node[part]
        with torch.no_grad():
            want = linear(x.cpu(), node["kernel"].T, node["bias"], specs)
        err = float((y.cpu() - want).abs().max())
        rows.append(dict(layer=i, linear=name, a_axes=specs.a_axes,
                         rel_err=err / float(want.abs().max())))
    return rows


def _tree_to(node, dev):
    if isinstance(node, dict):
        return {k: _tree_to(v, dev) for k, v in node.items()}
    return node.to(dev)


def mx_ffn_check(ref: dict) -> dict:
    """scripts.mx_ffn, 200 steps from its start on the card against the
    CPU's (:func:`cpu_references`): the mse at steps 0, 50, 100, 150, 199
    within MX_FFN_REL_TOL, and a fall by at least half."""
    from microscopiq_tpu_torch.scripts import mx_ffn

    t0 = time.perf_counter()
    card = mx_ffn.train(mx_ffn.numpy_start(128, 0), 200, device="cuda")
    card_s = time.perf_counter() - t0
    cpu, cpu_s = ref["mx_ffn"], ref["mx_ffn_s"]
    steps = (0, 50, 100, 150, 199)
    rel = max(abs(card[i] - cpu[i]) / cpu[i] for i in steps)
    rec = dict(mse_card={i: card[i] for i in steps},
               mse_cpu={i: cpu[i] for i in steps}, max_rel_err=rel,
               tol=MX_FFN_REL_TOL, card_s=card_s,
               ms_per_step=card_s / 200 * 1e3, cpu_s=cpu_s)
    if not rel <= MX_FFN_REL_TOL:
        raise AssertionError(f"train_main_path: mx_ffn's mse on the card "
                             f"differs from the CPU's by {rel}")
    if not card[199] <= 0.5 * card[0]:
        raise AssertionError(f"train_main_path: mx_ffn's mse fell from "
                             f"{card[0]} to {card[199]}, not by half")
    return rec


def gate_up_formula(x, w, g, specs):
    """(grad_w, grad_in) of the MX linear y = mx_linear(x, w, None, specs)
    (w (out, in)) for the output gradient g: nn/linear.py's backward
    formula on the operands its forward saves with quantize_backprop on
    (the bfloat-quantized ones), outside autograd."""
    from microscopiq_tpu_torch.nn.linear import (mx_linear_backward,
                                                 mx_linear_forward)

    _, bf_x, bf_w = mx_linear_forward(x, w, None, specs)
    grad_in, grad_w, _ = mx_linear_backward(g, bf_x, bf_w, False, specs)
    return grad_w, grad_in


def llama_train_check(layers: int = 2, steps: int = 3, seq: int = 512,
                      lr: float = 0.1) -> dict:
    """Llama-3-8B at full width, ``layers`` deep, float32 seeded weights,
    fused projections, fake-quant MX (fp6_e3m2 weights and activations,
    scale_bits 8, block 32, bfloat16, quantize_backprop on): ``steps`` SGD
    steps on one batch of 1 x ``seq`` tokens. The loss must be finite and
    fall, every gradient finite, and the first layer's gate_up linear's
    autograd gradients (the first step's) equal to :func:`gate_up_formula`
    within GRAD_FORMULA_REL_TOL of max."""
    import torch
    import torch.nn.functional as F

    from microscopiq_tpu_torch.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM,
                                                    build_params,
                                                    trainable_leaves)
    from microscopiq_tpu_torch.nn import fuse_projections
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    specs = finalize_mx_specs(dict(
        w_elem_format="fp6_e3m2", a_elem_format="fp6_e3m2", scale_bits=8,
        block_size=32, bfloat=16, quantize_backprop=True))
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers,
                                fused_projections=True)
    tree = _tree_float(fuse_projections(build_params(
        cfg, seed=18, device="cuda")["params"]))
    torch.cuda.empty_cache()
    leaves = trainable_leaves(tree)
    weight_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    model = LlamaForCausalLM(cfg, mx_specs=specs,
                             device="cuda").load_params(tree)
    gate_up = model.model.layers[0].mlp.gate_up_proj
    w0 = gate_up.kernel.detach().clone()
    seen = {}
    forward = gate_up.forward

    def traced(x):
        # the first call's input, its gradient and the output's gradient
        first = not seen
        if first:
            seen["x"] = x.detach()
            x.register_hook(lambda g: seen.setdefault("grad_in", g.detach()))
        y = forward(x)
        if first:
            y.register_hook(lambda g: seen.setdefault("g", g.detach()))
        return y

    gate_up.forward = traced
    ids = torch.as_tensor(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (1, seq)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        logits = model(ids)
        loss = F.cross_entropy(logits[0, :-1].float(), ids[0, 1:])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bad = sum(t.grad is None or not bool(torch.isfinite(t.grad).all())
                  for t in leaves)
        if bad:
            raise AssertionError(f"train_main_path: {bad} of {len(leaves)} "
                                 "gradients missing or not finite")
        if step == 0:
            grad_w = gate_up.kernel.grad.T.clone()
        t3 = time.perf_counter()
        with torch.no_grad():
            for t in leaves:
                t -= lr * t.grad
                t.grad = None
        torch.cuda.synchronize()
        losses.append(float(loss.detach()))
        times.append(dict(forward_s=t1 - t0, backward_s=t2 - t1,
                          step_s=time.perf_counter() - t3))
        del logits, loss
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gate_up.forward = forward
    want_w, want_in = gate_up_formula(seen["x"], w0.T, seen["g"], specs)
    err_w = float((grad_w - want_w).abs().max()) / float(
        want_w.abs().max())
    err_in = float((seen["grad_in"] - want_in).abs().max()) / float(
        want_in.abs().max())
    rec = dict(config=f"llama3_8b width, {layers} layers, float32 weights, "
               "fused projections", tokens=seq, lr=lr, losses=losses,
               times=times, peak_gb=peak_gb, weight_gb=weight_gb,
               gate_up_grad_w_rel_err=err_w, gate_up_grad_in_rel_err=err_in,
               tol=GRAD_FORMULA_REL_TOL)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train_main_path: the loss did not fall: "
                             f"{losses}")
    if not (err_w <= GRAD_FORMULA_REL_TOL and err_in <= GRAD_FORMULA_REL_TOL):
        raise AssertionError(f"train_main_path: gate_up's gradients differ "
                             f"from the formula (grad_w {err_w}, grad_in "
                             f"{err_in})")
    del model, tree, leaves, seen, w0, grad_w
    torch.cuda.empty_cache()
    return rec


def _tree_float(node):
    if isinstance(node, dict):
        return {k: _tree_float(v) for k, v in node.items()}
    return node.float()


def train_main_path(card: str, ref: dict) -> None:
    t0 = time.perf_counter()
    llama = llama_train_check()
    ffn = mx_ffn_check(ref)
    log(phase="train_main_path", mx_ffn=ffn, llama=llama,
        seconds=time.perf_counter() - t0, card=card)


def slice18_phases(card: str, refs) -> dict:
    """``mx_layers``, ``actquant_ppl`` and ``train_main_path``, against
    the CPU references computed by ``refs`` (the process
    :func:`start_cpu_references` began); returns each phase's seconds and
    the wait for the references."""
    secs = {}
    t0 = time.perf_counter()
    mx_layers_phase(card)
    secs["mx_layers"] = time.perf_counter() - t0
    ref = await_cpu_references(refs)
    log(phase="cpu_references", mx_ffn_s=ref["mx_ffn_s"],
        actquant_window0_s=ref["actquant_window0_s"],
        threads=ref["threads"], waited_s=ref["waited_s"], card=card)
    secs["cpu_references_wait"] = ref["waited_s"]
    for name, phase in (("actquant_ppl", actquant_ppl_phase),
                        ("train_main_path", train_main_path)):
        t0 = time.perf_counter()
        phase(card, ref)
        secs[name] = time.perf_counter() - t0
    return secs


# ---------------------------------------------------------------------------
# Slice 19: tensor- and data-parallel serving, the TP kernel check, posit
# and VQ, the parity grid
# ---------------------------------------------------------------------------
TP_SEED = 19
TP_B, TP_S0, TP_STEPS = 4, 128, 16
TP_QKV = dict(bits=4, gap=64, v_group=128)
TP_TIMEOUT_S = 600
# Every linear of the TP model fed the one-process run's input of it
# (prefill and a decode step, all 32 layers): a row-parallel product is two
# f32 partial sums over the K halves, summed and rounded once to bf16,
# against one f32 sum rounded once. The two f32 sums differ in their last
# bits, so a bf16 rounding flips only where a sum lies that close to a
# rounding boundary: on N(0, 1) activations and N(0, 0.02) weights ~0.02%
# of the elements flip, 1.1e-3 of max (a float64 model of both sums on the
# CPU). A bf16 all-reduce of the partials flips ~37% at 4.6e-3 of max,
# which 2^-7 alone would let pass: the share is held too. Column-parallel
# products (this rank's columns, the lm_head's gathered) take the same
# path a column as one process.
TP_LINEAR_REL_TOL = 2.0 ** -7
TP_LINEAR_DIFFER_MAX = 1e-2
# The logits: at 32 seeded layers the one-process reference is chaotic (the
# same weights through the plain versions in one process lie 0.058 of max
# from the kernels over the dense cache, 0.15 over the 4-bit one), so there
# they are reported. At TP_SHALLOW layers of the same tree, where that
# control stays within LOGIT_REL_TOL (held), the TP logits of the prefill
# and of every step, teacher-forced on the one-process tokens, are held to
# LOGIT_REL_TOL, every token that differs must be a near-tie of the
# one-process logits (within LOGIT_REL_TOL of max, as the families phase
# holds Mixtral's router), and at least TP_TOKENS_AGREE of them equal.
TP_SHALLOW = 2
TP_TOKENS_AGREE = 0.9
POSIT_CONFIGS = ((8, 0), (8, 1), (8, 2), (16, 1), (16, 2))
POSIT_ACT = (512, 4096)              # a prefill's activations, 4 x 128 rows
POSIT_WEIGHT = (4096, 28672)         # gate_up
VQ_SHAPE = (4096, 4096)              # q_proj
VQ_AGREE = 0.99                      # share of equal assignments, card/CPU
VQ_MSE_REL_TOL = 1e-2
PARITY_DPPL = 0.1
# configs held to the CPU's perplexity on the card, on the same weights
PARITY_HELD = ("dense", "rtn_mxfp6_block32", "rtn_mxfp6_block32_packed",
               "llama_dense")
# the configs (``scripts.parity`` names) the CPU reference computes and the
# card runs at the grid's 12 layers: the held ones
PARITY_RUN = ("dense", "rtn_mxfp6_block32", "llama_dense")
# the canonical GPTQ config, at 12 layers on the card: its serving trees
# (emi8m GEMM, compact-NB GEMM) held to its fake-quant perplexity
PARITY_CANONICAL = "gptq_int2_fp4_block16"
PARITY_SERVING = ("_packed", "_nb_packed")
# the others, only reported (act-order, static groups, actquant, Llama
# GPTQ), run on the card at the first PARITY_REPORTED_LAYERS layers, cut
# for the run's time: on an H100 these four took 53.4 s at 4 layers and
# 32.6 s at 2 in whole runs (the five GPTQ and actquant configs ~163 s at
# 12)
PARITY_REPORTED = ("gptq_int2_fp4_block16_actorder",
                   "gptq_int2_fp4_g128_static",
                   "actquant_fp4w_int4a_block128",
                   "llama_gptq_int2_fp4_block16")
PARITY_REPORTED_LAYERS = 1
# the JAX package's trained dense perplexities (PARITY_r05.json; its own
# trained weights, so a report beside the card's, not a bound)
PARITY_R05_DENSE = {"dense": 274.88, "llama_dense": 25.20}
GEAR_SEED = 0
# gear_compare's decode perplexities, card against CPU (relative): float32
# sums in other orders, the fused route's query in bf16 on both
GEAR_PPL_RTOL = 1e-4


def tp_config(layers: int = 32):
    import torch

    from microscopiq_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(dtype=torch.bfloat16, fused_projections=True,
                                 num_hidden_layers=layers)


def tp_ids(cfg) -> np.ndarray:
    return np.random.default_rng(TP_SEED).integers(
        0, cfg.vocab_size, (TP_B, TP_S0)).astype(np.int64)


def tp_weights(cfg):
    """The seeded MX-FP6 emi8 (block 32) Llama-3-8B tree (TP_SEED) on the
    card, fused. Returns (tree, GB of the linears' packed weights)."""
    from microscopiq_tpu_torch.models.llama import build_params
    from microscopiq_tpu_torch.nn import fuse_projections
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    specs = finalize_mx_specs({"w_elem_format": "fp6_e3m2",
                               "scale_bits": 8, "block_size": 32})
    tree = fuse_projections(build_params(cfg, seed=TP_SEED,
                                         packed_specs=specs,
                                         device="cuda")["params"])
    return tree, _linear_gb(tree)


def first_layers(tree: dict, n: int) -> dict:
    """``tree`` with its first ``n`` decoder layers only (the same
    leaves)."""
    return {**tree, "model": {
        k: v for k, v in tree["model"].items()
        if not k.startswith("layers_") or int(k[len("layers_"):]) < n}}


def _linear_gb(tree) -> float:
    return sum(leaf.nbytes() for leaf in _tree_leaves(tree)
               if hasattr(leaf, "nbytes") and callable(leaf.nbytes)) / 1e9


def _tree_leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _tree_leaves(v)
    else:
        yield node


def tp_decode(model, ids: np.ndarray, quant_cfg, steps: int,
              keep_logits: bool = False, force=None) -> dict:
    """A ``last_only`` prefill and ``steps`` eager greedy steps over a dense
    or quantized cache of the model's (local) KV heads; returns the
    prefill's last logits (float32, host), the tokens (B, steps + 1), the
    launches of the prefill and of the steps, the eager ms a step and, with
    ``keep_logits``, every step's logits (float32, host). ``force`` (B,
    steps + 1) teacher-forces the steps: step i is fed ``force[:, i]``
    instead of the token before it, so each token out is the model's
    choice after the history that ``force`` gives."""
    import torch

    from microscopiq_tpu_torch.eval.generate import DecodeStep
    from microscopiq_tpu_torch.kv.cache import (DenseDecodeCache,
                                                QuantizedDecodeCache,
                                                init_dense_cache,
                                                init_quant_cache)

    cfg = model.cfg
    B, S0 = ids.shape
    gap = quant_cfg.gap if quant_cfg is not None else 64
    max_len = -(-(S0 + steps) // gap) * gap + gap
    dims = (cfg.num_hidden_layers, B, max_len, model.kv_heads, cfg.head_dim)
    if quant_cfg is None:
        state, wrap = init_dense_cache(*dims, device="cuda"), DenseDecodeCache
    else:
        state = init_quant_cache(*dims, quant_cfg, device="cuda")
        wrap = lambda st: QuantizedDecodeCache(st, quant_cfg)  # noqa: E731
    x = torch.as_tensor(ids, device="cuda")
    pos = torch.arange(S0, device="cuda")[None, :].expand(B, S0)
    fed = None if force is None else torch.as_tensor(force, device="cuda")
    reset_counts()
    with torch.inference_mode():
        cache = wrap(state)
        logits = model(x, positions=pos, cache=cache, last_only=True)
        state = cache.finalize()
        tok = torch.argmax(logits[:, -1], dim=-1)
        prefill = logits[:, -1].float().cpu()
        at_prefill = launches()
        toks, steps_logits = [tok.clone()], []
        step = DecodeStep(model, state, tok, quant_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            if fed is not None:
                step.tok.copy_(fed[:, i])
            toks.append(step.eager().clone())
            if keep_logits:
                steps_logits.append(step.logits[:, -1].float())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3 if steps else None
    after = launches()
    out = dict(prefill_logits=prefill,
               tokens=torch.stack(toks, 1).cpu().numpy(),
               launches_prefill={k: v for k, v in at_prefill.items() if v},
               launches_decode={k: after[k] - at_prefill[k] for k in after
                                if after[k] - at_prefill[k]},
               eager_ms_per_step=ms)
    if keep_logits:
        out["step_logits"] = [t.cpu() for t in steps_logits]
    return out


def _linears(model) -> dict:
    from microscopiq_tpu_torch.models.llama import QLinear

    return {n: m for n, m in model.named_modules() if isinstance(m, QLinear)}


def capture_linears(model, ids: np.ndarray):
    """The one-process model's prefill and first decode step over the dense
    cache, keeping every linear's input and output (on the card); returns
    ({module name: [(x, y) of the prefill, of the step]}, tp_decode's
    result)."""
    caps = {}

    def keep(name):
        def hook(mod, inp, out):        # returns None: the output stays
            caps.setdefault(name, []).append((inp[0].clone(), out.clone()))
        return hook

    hooks = [m.register_forward_hook(keep(n))
             for n, m in _linears(model).items()]
    try:
        res = tp_decode(model, ids, None, 1)
    finally:
        for h in hooks:
            h.remove()
    return caps, res


def tp_linear_check(model, caps) -> dict:
    """Each linear of this rank's TP ``model`` fed the one-process input of
    it from ``caps`` (a row-parallel one this rank's K slice of it), its
    output against the one-process output (a column-parallel one's columns
    of this rank, section by section): {"name|phase": (max |diff| / max
    |one process|, share of elements that differ)}. Row-parallel linears
    all-reduce: every rank runs the same calls in the same order."""
    import torch

    mods, out = _linears(model), {}
    tp = model.tp
    with torch.inference_mode():
        for name, calls in caps.items():
            mod = mods[name]
            for phase, (x, ref) in zip(("prefill", "decode"), calls):
                if mod.parallel == "row":
                    k = x.shape[-1] // tp.size
                    x = x[..., tp.rank * k:(tp.rank + 1) * k].contiguous()
                y = mod(x)
                if mod.parallel == "column":
                    parts, s0 = [], 0
                    for n in mod.sections or [ref.shape[-1]]:
                        w = n // tp.size
                        parts.append(ref[..., s0 + tp.rank * w:
                                         s0 + (tp.rank + 1) * w])
                        s0 += n
                    ref = torch.cat(parts, dim=-1)
                d = (y.float() - ref.float()).abs().max()
                out[f"{name}|{phase}"] = (
                    float(d / ref.float().abs().max()),
                    float((y != ref).float().mean()))
    return out


def _linear_summary(checks: dict) -> dict:
    """{"kind|phase": worst rel err, worst share, linears, bit-equal ones}
    over the layers, ``kind`` the module's last name (``o_proj``, ...)."""
    out = {}
    for key, (rel, share) in checks.items():
        name, phase = key.split("|")
        s = out.setdefault(f"{name.split('.')[-1]}|{phase}",
                           dict(rel_err_max=0.0, differ_share_max=0.0,
                                linears=0, bit_equal=0))
        s["rel_err_max"] = max(s["rel_err_max"], rel)
        s["differ_share_max"] = max(s["differ_share_max"], share)
        s["linears"] += 1
        s["bit_equal"] += share == 0.0
    return out


class CollectiveClock:
    """Host seconds inside the model's collectives (``all_reduce``,
    ``all_gather`` of ``models/llama.py``): the wrapped calls include the
    wait for the other rank and, under gloo, the copies through the host
    (which wait for the card's queued work, so the clock cannot tell the
    collectives' own time from the card's)."""

    def __init__(self):
        from microscopiq_tpu_torch.models import llama

        self.mod, self.seconds, self.calls = llama, 0.0, 0
        self.orig = (llama.all_reduce, llama.all_gather)

        def timed(fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1
            return call

        llama.all_reduce, llama.all_gather = (timed(f) for f in self.orig)

    def reset(self):
        self.seconds, self.calls = 0.0, 0

    def close(self):
        self.mod.all_reduce, self.mod.all_gather = self.orig


def tp_rank_main(rank: int, port: int, out_dir: str) -> int:
    """One rank of ``tp_main_path`` (``chip_smoke.py --tp-rank R PORT
    DIR``): joins a 2-rank gloo group, builds the seeded tree, runs the
    (data=2, model=1) arm over the dense cache on half of the batch, then
    the one-process model on the whole batch keeping every linear's input
    and output (:func:`capture_linears`); keeps its shards of the tree for
    the (data=1, model=2) arm: each linear fed those inputs
    (:func:`tp_linear_check`), then over the dense and the 4-bit cache the
    32-layer model and its first TP_SHALLOW layers, teacher-forced on the
    one-process tokens of DIR/force.npz; runs ``scripts.check_tp``'s check
    on the group, and writes its record (rank 0: logits and tokens too)
    into DIR."""
    import torch

    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.models.llama import LlamaForCausalLM
    from microscopiq_tpu_torch.parallel import (Mesh, global_batch,
                                                init_distributed,
                                                shard_params, sync)
    from microscopiq_tpu_torch.scripts import check_tp

    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    cfg = tp_config()
    ids = tp_ids(cfg)
    force = dict(np.load(os.path.join(out_dir, "force.npz")))
    rec, arrays = {"rank": rank}, {}
    clock = CollectiveClock()
    try:
        t0 = time.perf_counter()
        tree, full_gb = tp_weights(cfg)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        # (data=2, model=1): the whole model, half of the batch a rank
        mesh = Mesh(2, 1)
        rows = TP_B // 2
        model = LlamaForCausalLM(cfg, device="cuda",
                                 tp_group=mesh.group("model")
                                 ).load_params(tree)
        res = tp_decode(model, ids[rank * rows:(rank + 1) * rows], None,
                        TP_STEPS, keep_logits=True)
        rec["dp"] = dict(weight_gb=full_gb,
                         eager_ms_per_step=res["eager_ms_per_step"],
                         launches_prefill=res["launches_prefill"],
                         launches_decode=res["launches_decode"])
        arrays["dp_logits"] = global_batch(res["prefill_logits"],
                                           mesh).numpy()
        arrays["dp_last_logits"] = global_batch(res["step_logits"][-1],
                                                mesh).numpy()
        arrays["dp_tokens"] = global_batch(res["tokens"], mesh)
        # the same whole model on the whole batch: every linear's input
        # and output, the references of the linears' check
        t0 = time.perf_counter()
        caps, res = capture_linears(model, ids)
        arrays["capture_logits"] = res["prefill_logits"].numpy()
        rec["capture_gb"] = sum(x.nbytes + y.nbytes for calls in
                                caps.values() for x, y in calls) / 1e9
        del model
        # (data=1, model=2): this rank's shards of the same tree
        mesh = Mesh(1, 2)
        tree = shard_params(tree, mesh, cfg=cfg)
        torch.cuda.empty_cache()
        group = mesh.group("model")
        model = LlamaForCausalLM(cfg, device="cuda",
                                 tp_group=group).load_params(tree)
        shallow = LlamaForCausalLM(
            tp_config(TP_SHALLOW), device="cuda", tp_group=group
        ).load_params(first_layers(tree, TP_SHALLOW))
        torch.cuda.synchronize()
        rec["tp_weight_gb"] = _linear_gb(tree)
        rec["tp_build_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["linears"] = tp_linear_check(model, caps)
        torch.cuda.synchronize()
        rec["capture_shard_check_s"] = time.perf_counter() - t0
        del caps
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for arm, qcfg in (("dense", None),
                          ("quant", QuantKVConfig(**TP_QKV))):
            tp_decode(model, ids, qcfg, 2)                  # warm-up
            sync()
            clock.reset()
            t0 = time.perf_counter()
            res = tp_decode(model, ids, qcfg, TP_STEPS, keep_logits=True,
                            force=force[arm])
            wall = time.perf_counter() - t0
            rec[arm] = dict(
                eager_ms_per_step=res["eager_ms_per_step"],
                collective_s=clock.seconds, collective_calls=clock.calls,
                collective_share=clock.seconds / wall, wall_s=wall,
                launches_prefill=res["launches_prefill"],
                launches_decode=res["launches_decode"])
            res2 = tp_decode(shallow, ids, qcfg, TP_STEPS, keep_logits=True,
                             force=force[f"{arm}_shallow"])
            for key, r in ((f"tp_{arm}", res), (f"tp2_{arm}", res2)):
                arrays[f"{key}_logits"] = r["prefill_logits"].numpy()
                arrays[f"{key}_step_logits"] = np.stack(
                    [t.numpy() for t in r["step_logits"]])
                arrays[f"{key}_tokens"] = r["tokens"]
        rec["tp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, shallow, tree
        torch.cuda.empty_cache()
        # scripts/check_tp.py's check on this 2-rank gloo group
        t0 = time.perf_counter()
        rec["tp_check"] = check_tp.check(torch.device("cuda"), 2)
        rec["tp_check_s"] = time.perf_counter() - t0
        sync()
    finally:
        clock.close()
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _divergences(got, want, ref_logits):
    """(share of equal tokens, every (row, step) where they differ with the
    one-process logits' gap there between its token and the other's,
    relative to max |logits|). ``ref_logits[t]`` are the one-process logits
    that chose token t."""
    rows = []
    for b, t in zip(*np.nonzero(got != want)):
        lg = ref_logits[t][b].numpy().astype(np.float64)
        gap = (lg[want[b, t]] - lg[got[b, t]]) / np.abs(lg).max()
        rows.append(dict(row=int(b), step=int(t), gap=float(gap)))
    return float((got == want).mean()), rows


def _forced(got, key: str, want: dict) -> dict:
    """The teacher-forced TP run ``key`` of rank0.npz against the
    one-process run ``want``: the prefill's and the steps' logits, the
    share of equal tokens and every divergence."""
    ref = [want["prefill_logits"]] + want["step_logits"]
    mine = [got[f"{key}_logits"]] + list(got[f"{key}_step_logits"])
    rels = [_rel(g, w.numpy()) for g, w in zip(mine, ref)]
    share, div = _divergences(got[f"{key}_tokens"], want["tokens"], ref)
    return dict(prefill_logits_rel_err=rels[0],
                step_logits_rel_err_max=max(rels[1:]),
                tokens_equal_share=share, divergences=div,
                divergence_gap_max=max((d["gap"] for d in div), default=0.0))


def tp_main_path(card: str) -> dict:
    """Llama-3-8B at full width, 32 layers, seeded MX-FP6 emi8 weights,
    over two ranks in two processes on the one card, joined by gloo (NCCL
    takes no two ranks on one device): (data=2, model=1), then (data=1,
    model=2) over the dense and the 4-bit cache (KVH 4 a rank); each
    against a one-process run of the same weights here (and its first
    TP_SHALLOW layers). The ranks also run ``scripts.check_tp``'s check on
    their group. Returns (the ranks' launch counts by path, their check_tp
    records, its seconds)."""
    import subprocess
    import tempfile

    import torch

    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.models.llama import LlamaForCausalLM

    t0 = time.perf_counter()
    cfg = tp_config()
    ids = tp_ids(cfg)
    tree, gb = tp_weights(cfg)
    cfg2, tree2 = tp_config(TP_SHALLOW), first_layers(tree, TP_SHALLOW)
    ref, control = {}, {}
    for depth, c, t in (("", cfg, tree), ("_shallow", cfg2, tree2)):
        one = LlamaForCausalLM(c, device="cuda").load_params(t)
        plain = LlamaForCausalLM(c, use_kernels=False,
                                 device="cuda").load_params(t)
        for arm, qcfg in (("dense", None),
                          ("quant", QuantKVConfig(**TP_QKV))):
            ref[arm + depth] = tp_decode(one, ids, qcfg, TP_STEPS,
                                         keep_logits=True)
            control[arm + depth] = tp_decode(plain, ids, qcfg, 0)[
                "prefill_logits"].numpy()
        del one, plain
    del tree, tree2
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    out_dir = tempfile.mkdtemp(prefix="tp_main_path_")
    np.savez(os.path.join(out_dir, "force.npz"),
             **{k: v["tokens"] for k, v in ref.items()})
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         str(port), out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError("tp_main_path: a rank failed: " + " | ".join(
            e[-2000:] for _, e in outs))
    ranks_s = time.perf_counter() - t1
    recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in range(2)]
    got = np.load(os.path.join(out_dir, "rank0.npz"))

    L = cfg.num_hidden_layers
    line, bad = dict(config="llama3_8b, 32 layers, MX-FP6 emi8 b32, fused",
                     batch=TP_B, prompt=TP_S0, steps=TP_STEPS,
                     shallow_layers=TP_SHALLOW,
                     backend="gloo (host copies around each collective)",
                     one_process_weight_gb=gb), []
    # the ranks' one-process reference of the linears is this process's
    if not np.array_equal(got["capture_logits"],
                          ref["dense"]["prefill_logits"].numpy()):
        bad.append("the ranks' one-process prefill differs from this "
                   "process's")
    linears = {}
    for r in recs:
        for key, (rel, share) in r["linears"].items():
            if not (rel <= TP_LINEAR_REL_TOL
                    and share <= TP_LINEAR_DIFFER_MAX):
                bad.append(f"rank {r['rank']} {key}: {rel} of max, "
                           f"{share} of the elements differ")
        linears[f"rank{r['rank']}"] = _linear_summary(r["linears"])
    line["linears"] = dict(summary=linears, tol=TP_LINEAR_REL_TOL,
                           differ_max=TP_LINEAR_DIFFER_MAX,
                           capture_shard_check_s=[
                               r["capture_shard_check_s"] for r in recs],
                           capture_gb=recs[0]["capture_gb"])
    for arm in ("dense", "quant"):
        want, want2 = ref[arm], ref[f"{arm}_shallow"]
        deep, shallow = _forced(got, f"tp_{arm}", want), _forced(
            got, f"tp2_{arm}", want2)
        ctl = _rel(control[arm], want["prefill_logits"].numpy())
        ctl2 = _rel(control[f"{arm}_shallow"],
                    want2["prefill_logits"].numpy())
        steps = {k: v / TP_STEPS for k, v in
                 recs[0][arm]["launches_decode"].items()}
        want_steps = {"dequant_gemv_emi8": 4 * L + 1.0}
        if arm == "quant":
            want_steps["quant_attention"] = float(L)
        want_pre = {"dequant_matmul_emi8": 4 * L, "dequant_gemv_emi8": 1}
        for r in recs:
            got_steps = {k: v / TP_STEPS for k, v in
                         r[arm]["launches_decode"].items()}
            if got_steps != want_steps or r[arm]["launches_prefill"] != \
                    want_pre:
                bad.append(f"{arm} rank {r['rank']} launches "
                           f"{r[arm]['launches_prefill']} / {got_steps}")
        if not ctl2 <= LOGIT_REL_TOL:
            bad.append(f"{arm} {TP_SHALLOW}-layer control {ctl2}")
        if not max(shallow["prefill_logits_rel_err"],
                   shallow["step_logits_rel_err_max"]) <= LOGIT_REL_TOL:
            bad.append(f"{arm} {TP_SHALLOW}-layer logits {shallow}")
        if not (shallow["divergence_gap_max"] <= LOGIT_REL_TOL
                and shallow["tokens_equal_share"] >= TP_TOKENS_AGREE):
            bad.append(f"{arm} {TP_SHALLOW}-layer tokens {shallow}")
        line[arm] = dict(
            shallow=dict(shallow, plain_prefill_logits_rel_err=ctl2,
                         tol=LOGIT_REL_TOL, tokens_agree=TP_TOKENS_AGREE),
            deep_reported=dict(deep, plain_prefill_logits_rel_err=ctl),
            launches_per_step=steps,
            eager_ms_per_step=[r[arm]["eager_ms_per_step"] for r in recs],
            one_process_eager_ms_per_step=want["eager_ms_per_step"],
            collective_share=[r[arm]["collective_share"] for r in recs],
            collective_calls=recs[0][arm]["collective_calls"])
    want = ref["dense"]
    dp_tok = np.array_equal(got["dp_tokens"], want["tokens"])
    dp_pre = np.array_equal(got["dp_logits"],
                            want["prefill_logits"].numpy())
    dp_last = np.array_equal(got["dp_last_logits"],
                             want["step_logits"][-1].numpy())
    dp_rel = _rel(got["dp_logits"], want["prefill_logits"].numpy())
    share, div = _divergences(got["dp_tokens"], want["tokens"],
                              [want["prefill_logits"]] + want["step_logits"])
    if not dp_rel <= LOGIT_REL_TOL or any(d["gap"] > LOGIT_REL_TOL
                                          for d in div):
        bad.append(f"data-parallel rows {dp_rel} {div}")
    line["data_parallel"] = dict(
        tokens_identical=dp_tok, prefill_logits_identical=dp_pre,
        last_step_logits_identical=dp_last, prefill_logits_rel_err=dp_rel,
        tokens_equal_share=share, divergences=div,
        eager_ms_per_step=[r["dp"]["eager_ms_per_step"] for r in recs],
        weight_gb=recs[0]["dp"]["weight_gb"])
    line.update(
        tp_weight_gb=[r["tp_weight_gb"] for r in recs],
        tp_peak_gb=[r["tp_peak_gb"] for r in recs],
        tp_build_peak_gb=[r["tp_build_peak_gb"] for r in recs],
        build_s=[r["build_s"] for r in recs],
        one_process_s=ref_s, ranks_s=ranks_s,
        seconds=time.perf_counter() - t0, card=card)
    log(phase="tp_main_path", **line)
    if bad:
        raise AssertionError(f"tp_main_path: {bad}")
    every = launches()
    full = lambda c: {k: c.get(k, 0) for k in every}  # noqa: E731
    counts = {}
    for r in recs:
        for arm in ("dense", "quant"):
            counts[f"tp_{arm}_rank{r['rank']}"] = {
                "prefill": full(r[arm]["launches_prefill"]),
                "decode": full(r[arm]["launches_decode"])}
        counts[f"dp_rank{r['rank']}"] = {
            "prefill": full(r["dp"]["launches_prefill"]),
            "decode": full(r["dp"]["launches_decode"])}
    return counts, [r["tp_check"] for r in recs], recs[0]["tp_check_s"]


def tp_check_phase(card: str, world2: list, world2_s: float) -> dict:
    """``scripts.check_tp`` at world 1 (NCCL, the degenerate mesh, in this
    process) and world 2 (gloo, the records the two ranks of
    ``tp_main_path`` made on their group); returns the launches of both,
    by rank."""
    from microscopiq_tpu_torch.scripts import check_tp

    t0 = time.perf_counter()
    one = check_tp.run_rank(0, 1, _free_port(), "nccl", "cuda")
    one.pop("card", None)
    log(phase="tp_check", seconds=time.perf_counter() - t0, card=card, **one)
    two = check_tp.merge(world2, 2, "gloo", "cuda")
    two.pop("card", None)
    log(phase="tp_check", seconds=world2_s, card=card, **two)
    bad = [r["world"] for r in (one, two) if not r["ok"]]
    if bad:
        raise AssertionError(f"tp_check: bounds missed at world {bad}")
    return {f"tp_check_w{r['world']}_rank{i}": c for r in (one, two)
            for i, c in enumerate(r["launches_by_rank"])}


def posit_inputs():
    """(activation (512, 4096), gate_up weight (4096, 28672)) float32 from
    seeded CPU generators, each with zeros, -0, NaN, +-inf and values past
    maxpos and below minpos of every config at its head."""
    import torch

    g = torch.Generator().manual_seed(TP_SEED)
    act = torch.randn(POSIT_ACT, generator=g) * torch.exp(
        torch.rand(POSIT_ACT, generator=g) * 8 - 4)
    w = torch.randn(POSIT_WEIGHT, generator=g) * 0.02
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            -float("inf"), 1e30, -1e30, 1e-30, -1e-30,
                            2.0 ** 60, 2.0 ** -60, 3.0e38])
    for t in (act, w):
        t.view(-1)[:special.numel()] = special
    return act, w


def _digest(t) -> str:
    """Two position-weighted int64 checksums (wrapping) of a tensor's bits,
    NaN canonical, computed where the tensor lies: equal bits give equal
    checksums on the card and the CPU, and a change of any element or a
    swap of two changes them."""
    import torch

    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
        t = t.view(torch.int32) if t.dtype == torch.float32 else t
    b = t.reshape(-1).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, dtype=torch.int64, device=b.device)
    s1 = int((b * w).sum())
    s2 = int((b * ((w * 2654435761) % 4294967296 + 1)).sum())
    return f"{s1}:{s2}"


def posit_digests(device) -> dict:
    """Per config and input, the digests of ``quantize_posit``,
    ``encode_posit`` and ``decode_posit(encode_posit(x))`` on ``device``
    (the CPU computes the codes once: its fake-quant values are the decoded
    codes bit for bit, tests/test_torch_posit.py)."""
    from microscopiq_tpu_torch.posit import (decode_posit, encode_posit,
                                             quantize_posit)

    out = {}
    for name, x in zip(("act", "gate_up"), posit_inputs()):
        x = x.to(device)
        for nb, es in POSIT_CONFIGS:
            c = encode_posit(x, nb, es)
            d = decode_posit(c, nb, es)
            rec = {"encode": _digest(c), "decode": _digest(d)}
            if device != "cpu":
                rec["quantize"] = _digest(quantize_posit(x, nb, es))
            out[f"{name}_{nb}_{es}"] = rec
    return out


def vq_weight():
    import torch

    return torch.randn(VQ_SHAPE, generator=torch.Generator().manual_seed(
        TP_SEED + 1)) * 0.02


def vq_run(device, draws=None) -> dict:
    """VQQuantizer (bits 3, vec_dim 2, whole rows) on the seeded q_proj:
    with ``draws`` the k-means++ draws given, else a CPU generator's."""
    import torch

    from microscopiq_tpu_torch.quant.vq import VQQuantizer

    W = vq_weight().to(device)
    q = VQQuantizer(vec_dim=2, bits=3)
    t0 = time.perf_counter()
    Wq = q.quantize(W, generator=torch.Generator().manual_seed(TP_SEED),
                    draws=draws)
    if device != "cpu":
        torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return dict(assign=q.assignments, centroids=q.centroids.cpu(),
                draws=q.draws, seconds=s, mse=float(((Wq - W) ** 2).mean()))


def cpu_references_19(out_dir: str) -> dict:
    """The CPU runs the slice-19 phases hold the card against: the posit
    digests and VQ on the q_proj (its draws, centroids, MSE; the
    assignments as ``vq_assign.npy`` in ``out_dir``), with their seconds;
    then the slice-20 tower's (:func:`vlm_tower_reference`, in ``out_dir``
    too)."""
    t0 = time.perf_counter()
    posit = posit_digests("cpu")
    t1 = time.perf_counter()
    vq = vq_run("cpu")
    np.save(os.path.join(out_dir, "vq_assign.npy"),
            vq["assign"].numpy().astype(np.uint8))
    return dict(posit=posit, posit_s=t1 - t0, vq_draws=vq["draws"],
                vq_centroids=vq["centroids"].tolist(), vq_mse=vq["mse"],
                vq_s=vq["seconds"], vlm_tower_s=vlm_tower_reference(out_dir),
                threads=CPU_REFERENCE_THREADS)


def start_cpu_references_19():
    """``chip_smoke.py --cpu-references-19 DIR`` in a process of its own,
    on CPU_REFERENCE_THREADS threads; returns (process, DIR)."""
    import atexit
    import subprocess
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="cpu_references_19_")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-references-19",
         out_dir], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS=str(CPU_REFERENCE_THREADS)))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out_dir


def posit_vq_phase(card: str, ref: dict, ref_dir: str) -> None:
    """Posit codecs on the card against the CPU bit for bit (checksums of
    the bits, :func:`_digest`; NaN as NaN): posit8 es 0, 1, 2 and posit16 es 1, 2 on a full-width
    activation and the gate_up weight, the card's fake-quant values against
    the CPU's decoded codes too. VQQuantizer (bits 3, vec_dim 2) on a
    4096 x 4096 q_proj on the card with the CPU's k-means++ draws: the
    share of equal assignments (>= VQ_AGREE) and the MSE (within 1%)."""
    import torch

    t0 = time.perf_counter()
    card_d = posit_digests("cuda")
    torch.cuda.synchronize()
    posit_s = time.perf_counter() - t0
    bad = []
    for key, c in card_d.items():
        cpu = ref["posit"][key]
        for what in ("encode", "decode"):
            if c[what] != cpu[what]:
                bad.append(f"{key} {what}")
        if c["quantize"] != cpu["decode"]:
            bad.append(f"{key} quantize")
    t1 = time.perf_counter()
    vq = vq_run("cuda", draws=ref["vq_draws"])
    cpu_assign = np.load(os.path.join(ref_dir, "vq_assign.npy"))
    agree = float((vq["assign"].cpu().numpy() == cpu_assign).mean())
    mse_rel = abs(vq["mse"] - ref["vq_mse"]) / ref["vq_mse"]
    cpu_c = np.asarray(ref["vq_centroids"], np.float32)
    card_c = vq["centroids"].numpy()
    log(phase="posit_vq", posit_configs=[list(c) for c in POSIT_CONFIGS],
        posit_inputs={"act": list(POSIT_ACT), "gate_up": list(POSIT_WEIGHT)},
        posit_equal=not bad, posit_card_s=posit_s,
        posit_cpu_s=ref["posit_s"], vq_shape=list(VQ_SHAPE),
        vq_assign_equal_share=agree, vq_mse_card=vq["mse"],
        vq_mse_cpu=ref["vq_mse"], vq_mse_rel=mse_rel,
        vq_centroids_card=card_c.tolist(), vq_centroids_cpu=cpu_c.tolist(),
        vq_centroids_max_abs_diff=float(np.abs(card_c - cpu_c).max()),
        vq_card_s=vq["seconds"], vq_cpu_s=ref["vq_s"],
        vq_phase_s=time.perf_counter() - t1, card=card)
    if bad:
        raise AssertionError(f"posit_vq: card differs from the CPU: {bad}")
    if not (agree >= VQ_AGREE and mse_rel <= VQ_MSE_REL_TOL):
        raise AssertionError(f"posit_vq: VQ assignments {agree} equal, MSE "
                             f"{mse_rel} apart")


def slice19_phases(card: str, refs19) -> tuple:
    """``tp_main_path``, ``tp_check`` and ``posit_vq``;
    returns (each phase's seconds, the launch counts by path for the
    kernels line, flat launch counts)."""
    secs, paths, flat = {}, {}, {}
    t0 = time.perf_counter()
    tp_paths, world2, world2_s = tp_main_path(card)
    paths.update(tp_paths)
    secs["tp_main_path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat.update(tp_check_phase(card, world2, world2_s))
    secs["tp_check"] = time.perf_counter() - t0
    proc, ref_dir = refs19
    t0 = time.perf_counter()
    ref = await_cpu_references(proc)
    secs["cpu_references_19_wait"] = time.perf_counter() - t0
    log(phase="cpu_references_19", posit_s=ref["posit_s"], vq_s=ref["vq_s"],
        vlm_tower_s=ref["vlm_tower_s"],
        threads=ref["threads"],
        waited_s=ref["waited_s"], card=card)
    t0 = time.perf_counter()
    posit_vq_phase(card, ref, ref_dir)
    secs["posit_vq"] = time.perf_counter() - t0
    return secs, paths, flat


# ---------------------------------------------------------------------------
# Slice 20: the LLaVA-1.5 stack at LLaVA-1.5-7B width
# ---------------------------------------------------------------------------
VLM_SEED = 20
VLM_STEPS = 32                    # greedy decode steps after the prefill
VLM_QKV = dict(bits=4, gap=64)    # the 4-bit KV arm (v_group 128 = head_dim)
VLM_IMAGE = (480, 640, 3)         # uint8: expand2square pads it first
VLM_QUESTIONS = (
    "Describe the picture in detail and say which objects lie on the left "
    "side of the table and what colour each of them has",
    "How many people can you see in this image and what are they doing",
    "Is there any text written on the sign near the door and what does "
    "it say",
    "Which animal is closest to the camera")
VLM_EVAL_NEW = 8                  # new tokens an eval_vqa answer
# tower card vs CPU, float32 with TF32 off: sums in other orders
VLM_TOWER_REL_TOL = 1e-4
# the projector runs in the text dtype (bf16): a flipped bf16 rounding of
# an element (2^-8) through the GELU and the second linear
VLM_PROJ_REL_TOL = 2.0 ** -7
VLM_EOS = 1                       # Crc32Tok.eos_token_id


def vlm_config(layers: int = 32, dtype=None, fused: bool = True):
    """LLaVA-1.5-7B (``LlavaConfig()``) with the text tower ``layers`` deep,
    in ``dtype`` (bf16), projections fused."""
    import torch

    from microscopiq_tpu_torch.models.llama import LlamaConfig
    from microscopiq_tpu_torch.vlm import LlavaConfig

    return LlavaConfig(text=LlamaConfig(num_hidden_layers=layers,
                                        dtype=dtype or torch.bfloat16,
                                        fused_projections=fused))


def vlm_image(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, VLM_IMAGE,
                                                dtype=np.uint8)


def vlm_inputs(question: str, seed: int, pad_to=None, cfg=None):
    """(ids (1, S), image mask (1, S), pixels (1, 336, 336, 3)) of the
    llava_v1 prompt around ``question`` and the seeded image, as numpy,
    for ``cfg`` (default :func:`vlm_config`'s)."""
    from microscopiq_tpu_torch.serve.stack import Crc32Tok
    from microscopiq_tpu_torch.vlm import (conv_templates,
                                           expand_image_tokens,
                                           process_images,
                                           tokenizer_image_token)

    conv = conv_templates["llava_v1"].copy()
    conv.append_message(conv.roles[0], "<image>\n" + question)
    conv.append_message(conv.roles[1], None)
    cfg = cfg or vlm_config()
    ids = tokenizer_image_token(conv.get_prompt(),
                                Crc32Tok(cfg.text.vocab_size))
    input_ids, mask = expand_image_tokens(ids, cfg.num_image_tokens,
                                          pad_to=pad_to)
    return input_ids[None], mask[None], process_images(
        [vlm_image(seed)], cfg.vision.image_size)


def _vlm_cuda(ids, mask, pix):
    import torch

    return (torch.as_tensor(ids, device="cuda").long(),
            torch.as_tensor(mask, device="cuda"),
            torch.as_tensor(pix, device="cuda"))


def vlm_tower_reference(out_dir: str) -> float:
    """The CPU run ``vlm_tower`` holds the card against: the tower and the
    projector of LLaVA-1.5-7B (weights drawn on the host, as
    :func:`vlm_build` draws them) on the main path's image, their outputs
    saved as ``tower.npy`` and ``proj.npy`` in ``out_dir``; returns its
    seconds."""
    import torch

    from microscopiq_tpu_torch.models.llama import install_tree
    from microscopiq_tpu_torch.vlm.llava import (_vision_modules,
                                                 build_vision_params)

    t0 = time.perf_counter()
    cfg = vlm_config()
    tower, proj = _vision_modules(cfg)
    w = build_vision_params(cfg, VLM_SEED + 1, device="cpu")
    cpu = torch.device("cpu")
    install_tree(tower, w["vision_tower"], cpu)
    install_tree(proj, w["mm_projector"], cpu)
    pix = vlm_inputs(VLM_QUESTIONS[0], VLM_SEED)[2]
    with torch.inference_mode():
        f = tower(torch.as_tensor(pix))
        p = proj(f)
    np.save(os.path.join(out_dir, "tower.npy"), f.numpy())
    np.save(os.path.join(out_dir, "proj.npy"), p.float().numpy())
    return time.perf_counter() - t0


def vlm_build(card: str):
    """The 32-layer LLaVA-1.5-7B on the card: (model, tree, build record)."""
    import torch

    from microscopiq_tpu_torch.nn import fuse_projections
    from microscopiq_tpu_torch.parallel.mesh import packed_kn
    from microscopiq_tpu_torch.specs import finalize_mx_specs
    from microscopiq_tpu_torch.vlm import LlavaForCausalLM
    from microscopiq_tpu_torch.vlm.llava import build_llava_params

    t0 = time.perf_counter()
    cfg = vlm_config()
    specs = finalize_mx_specs({"w_elem_format": "fp6_e3m2",
                               "scale_bits": 8, "block_size": 32})
    tree = build_llava_params(cfg, VLM_SEED, packed_specs=specs,
                              device="cuda", vision_device="cpu")["params"]
    tree = fuse_projections(tree)
    model = LlavaForCausalLM(cfg).load_params(tree)
    torch.cuda.synchronize()
    packed = [w for w in _tree_leaves(tree["model"]) if hasattr(w, "codes")]
    elems = sum(int(np.prod(packed_kn(w))) for w in packed)
    lm_bytes = sum(w.nbytes() for w in packed)

    def gb(node):
        return sum(t.nbytes for t in _tree_leaves(node)
                   if isinstance(t, torch.Tensor)) / 1e9

    rec = dict(build_s=time.perf_counter() - t0,
               packed_lm_gb=lm_bytes / 1e9,
               bits_per_weight=8 * lm_bytes / elems,
               packed_linears=len(packed),
               embed_lm_head_gb=(tree["model"]["embed_tokens"].nbytes
                                 + tree["lm_head"]["kernel"].nbytes) / 1e9,
               tower_gb=gb(tree["vision_tower"]),
               projector_gb=gb(tree["mm_projector"]))
    return model, tree, rec


def vlm_tower_phase(model, card: str, ref_dir: str) -> dict:
    """The tower and the projector on the card against the CPU reference;
    their CUDA-event times. Returns (tower ms, projector ms)."""
    import torch

    pix = _vlm_cuda(*vlm_inputs(VLM_QUESTIONS[0], VLM_SEED))[2]
    with torch.inference_mode():
        f = model.vision_tower(pix)
        p = model.mm_projector(f)
        tower_ms = cuda_ms(lambda i: model.vision_tower(pix), 1)
        proj_ms = cuda_ms(lambda i: model.mm_projector(f), 1)
    fc = np.load(os.path.join(ref_dir, "tower.npy"))
    pc = np.load(os.path.join(ref_dir, "proj.npy"))
    f_err = float(np.abs(f.cpu().numpy() - fc).max())
    p_err = float(np.abs(p.float().cpu().numpy() - pc).max())
    f_rel = f_err / float(np.abs(fc).max())
    p_rel = p_err / float(np.abs(pc).max())
    log(phase="vlm_tower", features=list(f.shape), projected=list(p.shape),
        tower_max_abs_err=f_err, tower_rel_err=f_rel,
        tower_tol=VLM_TOWER_REL_TOL, projector_max_abs_err=p_err,
        projector_rel_err=p_rel, projector_tol=VLM_PROJ_REL_TOL,
        tower_ms=tower_ms, projector_ms=proj_ms, card=card)
    cfg = model.cfg
    want = (1, cfg.num_image_tokens, cfg.vision.hidden_size)
    if tuple(f.shape) != want or tuple(p.shape) != want[:2] + (
            cfg.text.hidden_size,):
        raise AssertionError(f"vlm_tower: shapes {f.shape}, {p.shape}")
    if not (f_rel <= VLM_TOWER_REL_TOL and p_rel <= VLM_PROJ_REL_TOL):
        raise AssertionError(f"vlm_tower: card vs CPU {f_rel}, {p_rel}")
    return {"tower_ms": tower_ms, "projector_ms": proj_ms}


def _lm_prefill_ms(model, ids, mask, pix, max_len, reps: int = 3) -> float:
    """Host-clock ms (synchronized, best of ``reps``, as TTFT is timed) of
    the language model's prefill alone: the embedded prompt with the image
    features spliced in, through a dense cache, the last position's
    logits."""
    import torch

    from microscopiq_tpu_torch.kv.cache import (DenseDecodeCache,
                                                init_dense_cache)
    from microscopiq_tpu_torch.vlm.llava import splice_image_features

    tc = model.cfg.text
    with torch.inference_mode():
        feats = model.image_features(pix)
        x = splice_image_features(
            model.model.embed_tokens[torch.where(mask, 0, ids)], feats, mask)
        state = init_dense_cache(tc.num_hidden_layers, 1, max_len,
                                 tc.num_key_value_heads, tc.head_dim,
                                 device="cuda")
        pos = torch.arange(ids.shape[1], device="cuda")[None]
        best = float("inf")
        for _ in range(reps + 1):            # the first call warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(None, positions=pos, cache=DenseDecodeCache(state),
                  inputs_embeds=x, last_only=True)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0) if _ else best
        return best * 1e3


def vlm_main_path(model, tree, card: str, build: dict, tower: dict):
    """Phase ``vlm_main_path``; returns the launches by path."""
    import torch

    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.models.llama import build_params
    from microscopiq_tpu_torch.nn import fuse_projections
    from microscopiq_tpu_torch.vlm import LlavaForCausalLM, generate_mm
    from microscopiq_tpu_torch.vlm.eval_vqa import mm_cache_len

    L, STEPS = model.cfg.text.num_hidden_layers, VLM_STEPS
    ids_np, mask_np, pix_np = vlm_inputs(VLM_QUESTIONS[0], VLM_SEED)
    ids, mask, pix = _vlm_cuda(ids_np, mask_np, pix_np)
    S = ids.shape[1]
    kw = dict(pixel_values=pix, image_token_mask=mask)
    max_len = mm_cache_len(S, STEPS + 1)
    prefill_decode(model, ids, 2, max_len, prefill_kw=kw)        # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    main = prefill_decode(model, ids, STEPS, max_len, prefill_kw=kw)
    toks, ttft, dec, last, pre_counts, dec_counts, _, logits = main
    peak = torch.cuda.max_memory_allocated()
    first = torch.argmax(logits[0][:, -1], dim=-1)
    want_pre = want_counts(dequant_matmul_emi8=4 * L)
    want_dec = want_counts(dequant_gemv_emi8=STEPS * 4 * L)
    if pre_counts != want_pre or dec_counts != want_dec:
        raise AssertionError(f"vlm_main_path: launches prefill "
                             f"{pre_counts} (want {want_pre}), decode "
                             f"{dec_counts} (want {want_dec})")
    if not torch.isfinite(last.float()).all():
        raise AssertionError("vlm_main_path: non-finite logits")
    eager_ms = graph_vs_eager(model, ids, STEPS, max_len, "llava", main,
                              card, prefill_kw=kw)
    best_ttft, best_dec = ttft, dec
    _, t, d, *_ = prefill_decode(model, ids, STEPS, max_len, prefill_kw=kw)
    best_ttft, best_dec = min(best_ttft, t), min(best_dec, d)

    # the entry point: generate_mm's tokens and launches
    reset_counts()
    gm = generate_mm(model, ids_np, mask_np, pix_np, STEPS + 1)
    gm_all = launches()
    gm_counts = {k: v for k, v in gm_all.items() if v}
    want_gm = want_counts(dequant_matmul_emi8=4 * L,
                          dequant_gemv_emi8=2 * 4 * L)
    ours = np.concatenate([first.cpu().numpy()[:, None],
                           toks.cpu().numpy()], axis=1)
    if not np.array_equal(gm, ours) or gm_all != want_gm:
        raise AssertionError(f"vlm_main_path: generate_mm {gm.tolist()} "
                             f"{gm_counts} against {ours.tolist()} "
                             f"{want_gm}")
    lm_ms = _lm_prefill_ms(model, ids, mask, pix, max_len)

    # the 4-bit KV arm
    qcfg = QuantKVConfig(**VLM_QKV)
    qmax = mm_cache_len(S, STEPS + 1, qcfg.gap)
    prefill_decode(model, ids, 2, qmax, quant_cfg=qcfg, prefill_kw=kw)
    reset_counts()
    qrun = prefill_decode(model, ids, STEPS, qmax, quant_cfg=qcfg,
                          prefill_kw=kw)
    qtoks, qttft, qdec, qlast, qpre, qdecc, _, qlogits = qrun
    want_qdec = want_counts(dequant_gemv_emi8=STEPS * 4 * L,
                            quant_attention=STEPS * L)
    if qpre != want_pre or qdecc != want_qdec:
        raise AssertionError(f"vlm_main_path 4-bit KV: launches prefill "
                             f"{qpre} (want {want_pre}), decode {qdecc} "
                             f"(want {want_qdec})")
    qfirst = torch.argmax(qlogits[0][:, -1], dim=-1)
    qours = np.concatenate([qfirst.cpu().numpy()[:, None],
                            qtoks.cpu().numpy()], axis=1)
    qgm = generate_mm(model, ids_np, mask_np, pix_np, STEPS + 1,
                      cache_kind="quant", quant_cfg=qcfg)
    if not np.array_equal(qgm, qours):
        raise AssertionError(f"vlm_main_path 4-bit KV: generate_mm "
                             f"{qgm.tolist()} against {qours.tolist()}")
    agree = float((qours == ours).mean())

    # the dense bf16 language model's prefill: the same prompt and tower
    t0 = time.perf_counter()
    dtree = fuse_projections(build_params(vlm_config().text, VLM_SEED,
                                          device="cuda")["params"])
    dtree.update({k: tree[k] for k in ("vision_tower", "mm_projector")})
    dense = LlavaForCausalLM(vlm_config()).load_params(dtree)
    dense_lm_ms = _lm_prefill_ms(dense, ids, mask, pix, max_len)
    dense_s = time.perf_counter() - t0
    del dense, dtree
    torch.cuda.empty_cache()

    T = model.cfg.num_image_tokens
    rec = dict(layers=L, batch=1, prompt=S, image_tokens=T,
               text_tokens=S - T, steps=STEPS, graph=True,
               ttft_ms=best_ttft * 1e3, tower_projector_ms=(
                   tower["tower_ms"] + tower["projector_ms"]),
               lm_prefill_ms=lm_ms,
               image_prefill_tokens_per_s=S / best_ttft,
               decode_ms_per_step=best_dec / STEPS * 1e3,
               eager_decode_ms_per_step=eager_ms,
               decode_tokens_per_s=STEPS / best_dec,
               quant_kv_decode_ms_per_step=qdec / STEPS * 1e3,
               quant_kv_ttft_ms=qttft * 1e3,
               quant_kv_tokens_agree_with_dense=agree,
               dense_bf16_lm_prefill_ms=dense_lm_ms,
               dense_bf16_arm_s=dense_s, peak_mem_gb=peak / 1e9,
               tokens=ours.tolist(), quant_kv_tokens=qours.tolist(),
               launches_prefill={k: v for k, v in pre_counts.items() if v},
               launches_decode={k: v for k, v in dec_counts.items() if v},
               launches_decode_quant_kv={k: v for k, v in qdecc.items()
                                         if v},
               launches_generate_mm=gm_counts, **build, card=card)
    log(phase="vlm_main_path", **rec)
    return ({"vlm_main_path": {"prefill": pre_counts, "decode": dec_counts},
             "vlm_quant_kv": {"prefill": qpre, "decode": qdecc}},
            {"vlm_generate_mm": gm_counts})


def vlm_eval_phase(model, card: str) -> dict:
    """``eval_vqa`` over 3 seeded questions and images in two chunks,
    merged; each answer's tokens equal to a ``generate_mm`` call of its
    own. Returns the launches of the eval_vqa calls."""
    import tempfile

    from microscopiq_tpu_torch.serve.stack import Crc32Tok
    from microscopiq_tpu_torch.vlm import (eval_vqa, generate_mm,
                                           merge_answer_chunks)

    t0 = time.perf_counter()
    qs = [{"question_id": i, "image": f"img{i}",
           "text": VLM_QUESTIONS[1 + i]} for i in range(3)]
    loader = lambda name: vlm_image(VLM_SEED + 1 + int(name[3:]))  # noqa
    tok = Crc32Tok(model.cfg.text.vocab_size)
    with tempfile.TemporaryDirectory() as d:
        parts = [os.path.join(d, f"chunk{k}.jsonl") for k in range(2)]
        reset_counts()
        for k, part in enumerate(parts):
            eval_vqa(model, tok, qs, loader, part,
                     max_new_tokens=VLM_EVAL_NEW, num_chunks=2, chunk_idx=k)
        counts = {k: v for k, v in launches().items() if v}
        merged = os.path.join(d, "answers.jsonl")
        merge_answer_chunks(parts, merged)
        with open(merged) as f:
            recs = [json.loads(line) for line in f]
    eval_s = time.perf_counter() - t0
    bad = []
    for q, rec in zip(qs, recs):
        ids, mask, pix = vlm_inputs(q["text"], VLM_SEED + 1 + q["question_id"])
        out = generate_mm(model, ids, mask, pix, VLM_EVAL_NEW,
                          eos_token_id=VLM_EOS)
        want = tok.decode([int(t) for t in out[0] if t != VLM_EOS]).strip()
        if rec["question_id"] != q["question_id"] or rec["text"] != want:
            bad.append((q["question_id"], rec["text"], want))
    log(phase="vlm_eval", questions=len(qs), records=len(recs), chunks=2,
        new_tokens=VLM_EVAL_NEW, equal_to_generate_mm=not bad,
        answer_keys=sorted(recs[0]) if recs else [],
        answers=[r["text"] for r in recs], eval_s=eval_s,
        s_per_question=eval_s / len(qs), launches=counts, card=card)
    if bad or len(recs) != len(qs):
        raise AssertionError(f"vlm_eval: {len(recs)} answers, {bad}")
    return counts


def vlm_two_layer_phase(tree, card: str) -> dict:
    """The first 2 layers of the main model through the kernels against
    the plain versions: the prefill's logits with the image, and one
    teacher-forced decode step over the dense cache and over the 4-bit one
    (VLM_QKV: the kernel model's step takes quant_attention, rep 1; the
    plain model's ``cache.update`` and its own attention); returns the
    kernel run's launches."""
    import torch

    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.vlm import LlavaForCausalLM
    from microscopiq_tpu_torch.vlm.eval_vqa import mm_cache_len

    cfg = dataclasses.replace(vlm_config(), text=dataclasses.replace(
        vlm_config().text, num_hidden_layers=2))
    two = first_layers(tree, 2)
    two_k = LlavaForCausalLM(cfg).load_params(two)
    two_p = LlavaForCausalLM(cfg, use_kernels=False).load_params(two)
    ids, mask, pix = _vlm_cuda(*vlm_inputs(VLM_QUESTIONS[0], VLM_SEED))
    kw = dict(pixel_values=pix, image_token_mask=mask)
    S = ids.shape[1]
    max_len = mm_cache_len(S, 2)
    reset_counts()
    with torch.inference_mode():
        a = two_k(ids, **kw).float()
        all_counts = launches()
        counts = {k: v for k, v in all_counts.items() if v}
        b = two_p(ids, **kw).float()
        moved = two_k(ids, pixel_values=pix * 2, image_token_mask=mask)
        text_only = two_k(ids)
    prefill_rel = ((a - b).abs().max() / b.abs().max()).item()
    # the decode step teacher-forced on the kernel prefill's token: at a
    # near-tie of the seeded model's logits the plain prefill may pick
    # another, and the step's logits would then compare two tokens
    feed = a[:, -1].argmax(-1)[:, None]
    la = prefill_decode(two_k, ids, 1, max_len, prefill_kw=kw,
                        feed=feed)[3].float()
    lb = prefill_decode(two_p, ids, 1, max_len, prefill_kw=kw,
                        feed=feed)[3].float()
    decode_rel = ((la - lb).abs().max() / lb.abs().max()).item()
    qcfg = QuantKVConfig(**VLM_QKV)
    qmax = mm_cache_len(S, 2, qcfg.gap)
    reset_counts()
    qk = prefill_decode(two_k, ids, 1, qmax, quant_cfg=qcfg, prefill_kw=kw,
                        feed=feed)
    qla = qk[3].float()
    qlb = prefill_decode(two_p, ids, 1, qmax, quant_cfg=qcfg, prefill_kw=kw,
                         feed=feed)[3].float()
    quant_rel = ((qla - qlb).abs().max() / qlb.abs().max()).item()
    want_qstep = want_counts(dequant_gemv_emi8=8, quant_attention=2)
    move = ((moved[:, -1].float() - a[:, -1]).abs().max()
            / a[:, -1].abs().max()).item()
    finite = bool(torch.isfinite(text_only.float()).all())
    log(phase="vlm_two_layer_logits", prompt=S, prefill_rel_err=prefill_rel,
        decode_rel_err=decode_rel, quant_kv_decode_rel_err=quant_rel,
        quant_kv=VLM_QKV, tol=LOGIT_REL_TOL,
        doubled_pixels_last_logit_move=move, text_only_finite=finite,
        launches_prefill=counts,
        launches_quant_kv_step={k: v for k, v in qk[5].items() if v},
        card=card)
    if not (prefill_rel < LOGIT_REL_TOL and decode_rel < LOGIT_REL_TOL
            and quant_rel < LOGIT_REL_TOL and move > 0 and finite
            and all_counts == want_counts(dequant_matmul_emi8=8)
            and qk[5] == want_qstep):
        raise AssertionError(f"vlm_two_layer_logits: {prefill_rel}, "
                             f"{decode_rel}, 4-bit KV {quant_rel}, move "
                             f"{move}, finite {finite}, launches {counts}, "
                             f"4-bit step {qk[5]}")
    return counts


def vlm_gptq_phase(card: str) -> None:
    """``llava_sequential`` on one layer of the full-width model."""
    import torch

    from microscopiq_tpu_torch.quant.gptq import StageTimer
    from microscopiq_tpu_torch.vlm import LlavaForCausalLM, llava_sequential
    from microscopiq_tpu_torch.vlm.llava import build_llava_params

    t0 = time.perf_counter()
    cfg = vlm_config(1, dtype=torch.float32, fused=False)
    tree = build_llava_params(cfg, VLM_SEED + 2, device="cuda")["params"]
    model = LlavaForCausalLM(cfg).load_params(tree)
    lens = [vlm_inputs(q, 0, cfg=cfg)[0].shape[1]
            for q in VLM_QUESTIONS[:2]]
    parts = [vlm_inputs(q, VLM_SEED + 10 + i, pad_to=max(lens), cfg=cfg)
             for i, q in enumerate(VLM_QUESTIONS[:2])]
    ids, mask, pix = (np.concatenate([p[j] for p in parts])
                      for j in range(3))
    timer = StageTimer("cuda")
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    q = llava_sequential(model, {"params": tree}, ids, mask, pix,
                         nsamples_batch=2, verbose=False, timer=timer)
    gptq_s = time.perf_counter() - t1
    qt = q["params"]
    same_vision = all(
        torch.equal(a, b) for k in ("vision_tower", "mm_projector")
        for a, b in zip(_tree_leaves(tree[k]), _tree_leaves(qt[k])))
    layer0 = {path: (old, new) for (path, old), (_, new) in zip(
        _named_leaves(tree["model"]["layers_0"]),
        _named_leaves(qt["model"]["layers_0"])) if path.endswith("kernel")}
    changed = {p: not torch.equal(o, n) for p, (o, n) in layer0.items()}
    cids, cmask, cpix = _vlm_cuda(ids, mask, pix)
    with torch.inference_mode():
        logits = LlavaForCausalLM(cfg).load_params(q)(
            cids, pixel_values=cpix, image_token_mask=cmask, last_only=True)
    finite = bool(torch.isfinite(logits).all())
    log(phase="vlm_gptq", layers=1, calib=list(ids.shape), nsamples_batch=2,
        vision_unchanged=same_vision, layer0_kernels_changed=changed,
        forward_finite=finite, seconds_by_stage=timer.seconds,
        gptq_s=gptq_s, build_s=build_s, card=card)
    if not (same_vision and len(changed) == 7 and all(changed.values())
            and finite):
        raise AssertionError(f"vlm_gptq: vision {same_vision}, changed "
                             f"{changed}, finite {finite}")


def _named_leaves(node, path=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _named_leaves(node[k], f"{path}/{k}")
    else:
        yield path, node


def vlm_probe_phase(card: str) -> None:
    """``scripts.vlm_probe`` on the card at its default steps. A check that
    fails there fails the phase only where the CPU run of the same seed
    passes it: the CPU run (minutes, on every core of the host) is made
    then, and not when every check passes on the card."""
    import torch

    from microscopiq_tpu_torch.scripts import vlm_probe

    rec = vlm_probe.run("cuda", log=lambda s: None)
    failed, cpu = {}, None
    if not all(rec["ordering_checks"].values()):
        threads = torch.get_num_threads()
        torch.set_num_threads(os.cpu_count() or threads)
        try:
            cpu = vlm_probe.run("cpu", log=lambda s: None)
        finally:
            torch.set_num_threads(threads)
        failed = {k: v for k, v in rec["ordering_checks"].items()
                  if not v and cpu["ordering_checks"][k]}
    log(phase="vlm_probe", steps=rec["train_steps"],
        accuracies={k: v["accuracy"] for k, v in rec["results"].items()},
        ordering_checks=rec["ordering_checks"],
        cpu_ordering_checks=(cpu["ordering_checks"] if cpu else
                             "not run: every check passed on the card"),
        cpu_accuracies=({k: v["accuracy"] for k, v in cpu["results"].items()}
                        if cpu else None),
        train_s=rec["train_s"], eval_s=rec["eval_s"],
        final_loss=rec["final_loss"], card=card)
    if failed:
        raise AssertionError(f"vlm_probe: checks {sorted(failed)} fail on "
                             "the card and pass on the CPU")


def slice20_phases(card: str, ref_dir: str) -> tuple:
    """The slice-20 phases, the tower's CPU reference in ``ref_dir``;
    returns (each phase's seconds, the launch counts by path for the
    kernels line, flat launch counts)."""
    import torch

    secs, paths, flat = {}, {}, {}
    t0 = time.perf_counter()
    model, tree, build_rec = vlm_build(card)
    secs["vlm_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tower = vlm_tower_phase(model, card, ref_dir)
    secs["vlm_tower"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_paths, gm = vlm_main_path(model, tree, card, build_rec, tower)
    paths.update(main_paths)
    flat.update(gm)
    secs["vlm_main_path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat["vlm_eval"] = vlm_eval_phase(model, card)
    secs["vlm_eval"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat["vlm_two_layer"] = vlm_two_layer_phase(tree, card)
    secs["vlm_two_layer_logits"] = time.perf_counter() - t0
    del model, tree
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vlm_gptq_phase(card)
    secs["vlm_gptq"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vlm_probe_phase(card)
    secs["vlm_probe"] = time.perf_counter() - t0
    return secs, paths, flat


# ---------------------------------------------------------------------------
# Slice 21: the parity models' trainer and the KV-method comparison
# ---------------------------------------------------------------------------
def parity_train(out_dir: str) -> dict:
    """``chip_smoke.py --parity-train DIR``: ``scripts.parity.prepare`` on
    the card into ``out_dir`` (both grid models, TRAIN_STEPS steps each);
    returns prepare's record."""
    import torch

    from microscopiq_tpu_torch.scripts import parity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return parity.prepare(out_dir, "cuda",
                          log=lambda s: print(s, file=sys.stderr, flush=True))


def start_parity_train():
    """:func:`parity_train` in a process of its own, started before the
    kernels build: the training runs plain PyTorch only, on a card that
    is idle while nvcc runs. Returns (process, its directory)."""
    import atexit
    import subprocess
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="parity_trained_")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parity-train",
         out_dir], stdout=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out_dir


def parity_train_phase(card: str, started) -> tuple:
    """Waits for :func:`start_parity_train`'s process and logs each
    model's loss every 100 steps (and at the last), its seconds and the
    wait; raises unless both losses fell. Returns (the weights' directory,
    the seconds waited)."""
    from microscopiq_tpu_torch.scripts import parity

    proc, out_dir = started
    rec = await_cpu_references(proc, "the parity training")
    every = {}
    for name in ("opt", "llama"):
        losses = rec[name + "_losses"]
        every[name] = {i: losses[i] for i in (*range(0, len(losses), 100),
                                               len(losses) - 1)}
    log(phase="parity_train", steps=rec["steps"], batch=parity.TRAIN_BATCH,
        seqlen=parity.SEQLEN, opt_s=rec["opt_s"], llama_s=rec["llama_s"],
        loss_every_100=every, waited_s=rec["waited_s"],
        overlapped="the kernels' build", card=card)
    bad = [n for n in every if not (np.isfinite(list(every[n].values())).all()
                                    and every[n][rec["steps"] - 1]
                                    < every[n][0])]
    if bad:
        raise AssertionError(f"parity_train: {bad} did not train: {every}")
    return out_dir, rec["waited_s"]


def cpu_references_21(weights_dir: str) -> dict:
    """The CPU runs the slice-21 phases hold the card against: the grid's
    held configs (PARITY_RUN, 12 layers) on the trained weights in
    ``weights_dir``, and ``scripts.gear_compare`` on its seeded weights,
    with their seconds."""
    from microscopiq_tpu_torch.scripts import gear_compare, parity

    t0 = time.perf_counter()
    _, calib, eval_ids = parity.make_tokens()
    grid = parity.run(parity.load_state_dicts(weights_dir), calib, eval_ids,
                      "cpu", only=PARITY_RUN, log=lambda s: None)
    t1 = time.perf_counter()
    gear = gear_compare.run("cpu", GEAR_SEED)
    return dict(parity=grid, parity_s=t1 - t0, gear=gear,
                gear_s=time.perf_counter() - t1,
                threads=CPU_REFERENCE_THREADS)


def start_cpu_references_21(weights_dir: str):
    """``chip_smoke.py --cpu-references-21 DIR`` in a process of its own,
    on CPU_REFERENCE_THREADS threads."""
    import atexit
    import subprocess

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-references-21",
         weights_dir], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS=str(CPU_REFERENCE_THREADS)))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def gear_compare_card() -> tuple:
    """``scripts.gear_compare`` on the card: (its result, each method's
    launches by kernel, the launches of the whole run)."""
    from microscopiq_tpu_torch.scripts import gear_compare

    by_method = {}

    def after(name):
        by_method[name] = {k: v for k, v in launches().items() if v}
        reset_counts()

    reset_counts()
    res = gear_compare.run("cuda", GEAR_SEED, after=after)
    total = {}
    for counts in (*by_method.values(), launches()):
        for k, v in counts.items():
            if v:
                total[k] = total.get(k, 0) + v
    return res, by_method, total


def gear_compare_phase(card: str, run: tuple, ref: dict) -> dict:
    """Holds :func:`gear_compare_card`'s run to the CPU's (decode
    perplexities within GEAR_PPL_RTOL, compression ratios and routes
    equal, the quantized attention launched by exactly the ``fused``
    methods, both GSM8K runs complete); returns its launches."""
    res, by_method, total = run
    card_rows = res["teacher_forced_decode"]
    cpu_rows = ref["gear"]["teacher_forced_decode"]
    rel = {m: abs(r["decode_ppl"] - cpu_rows[m]["decode_ppl"])
           / cpu_rows[m]["decode_ppl"] for m, r in card_rows.items()}
    qattn = {m: c.get("quant_attention", 0) for m, c in by_method.items()}
    bad = [m for m in cpu_rows if m not in card_rows]
    for m, r in card_rows.items():
        c = cpu_rows[m]
        if not rel[m] <= GEAR_PPL_RTOL:
            bad.append(f"{m} decode_ppl")
        for k in ("kv_compression_ratio", "ratio_at_llama8b_dims", "route"):
            if r[k] != c[k]:
                bad.append(f"{m} {k}")
        if (qattn.get(m, 0) > 0) != (r["route"] == "fused"):
            bad.append(f"{m} quant_attention launches {qattn.get(m)}")
    gsm = res["gsm8k_synthetic"]
    if sorted(gsm) != sorted(ref["gear"]["gsm8k_synthetic"]) or any(
            g["n"] != ref["gear"]["gsm8k_synthetic"][m]["n"]
            for m, g in gsm.items()):
        bad.append(f"gsm8k {gsm}")
    log(phase="gear_compare", card_rows=card_rows, cpu_rows=cpu_rows,
        decode_ppl_rel=rel, tol=GEAR_PPL_RTOL,
        routes={m: r["route"] for m, r in card_rows.items()},
        quant_attention_launches=qattn, launches_by_method=by_method,
        gsm8k_card=gsm, gsm8k_cpu=ref["gear"]["gsm8k_synthetic"],
        decode_s=res["decode_s"], gsm8k_s=res["gsm8k_s"],
        cpu_s=ref["gear_s"], card=card)
    if bad:
        raise AssertionError(f"gear_compare: {bad}")
    return total


def parity_grid_card(weights_dir: str) -> dict:
    """The grid on the card on the trained weights in ``weights_dir``: the
    held configs and the canonical GPTQ config at 12 layers, the others
    at PARITY_REPORTED_LAYERS; with the launches and the seconds."""
    from microscopiq_tpu_torch.scripts import parity

    sds = parity.load_state_dicts(weights_dir)
    _, calib, eval_ids = parity.make_tokens()
    out = {}
    reset_counts()
    for key, only, layers in (("held", PARITY_RUN, None),
                              ("canonical", (PARITY_CANONICAL,), None),
                              ("reported", PARITY_REPORTED,
                               PARITY_REPORTED_LAYERS)):
        t0 = time.perf_counter()
        out[key] = parity.run(sds, calib, eval_ids, "cuda", only=only,
                              log=lambda s: None, layers=layers)
        out[key + "_s"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in launches().items() if v}
    return out


def parity_grid_phase(card: str, grid: dict, ref: dict) -> dict:
    """Holds :func:`parity_grid_card`'s run: the held configs within
    PARITY_DPPL of the CPU's on the same weights; the canonical config's
    emi8m and compact-NB serving trees within PARITY_DPPL of its
    fake-quant perplexity; every perplexity finite. Returns the
    launches."""
    cpu, held = ref["parity"], grid["held"]
    deltas = {k: held[k] - cpu[k] for k in cpu if not k.endswith("_s")}
    bad = {k: d for k, d in deltas.items() if k in PARITY_HELD
           and not abs(d) <= PARITY_DPPL}
    if set(PARITY_HELD) - set(deltas):
        bad["missing"] = sorted(set(PARITY_HELD) - set(deltas))
    canon = grid["canonical"]
    fake = canon[PARITY_CANONICAL]
    serving = {k: canon[PARITY_CANONICAL + k] - fake for k in PARITY_SERVING}
    bad.update({k: d for k, d in serving.items()
                if not abs(d) <= PARITY_DPPL})
    ppls = [v for part in ("held", "canonical", "reported")
            for k, v in grid[part].items()
            if not k.endswith("_s") and not k.endswith("_per_element")]
    log(phase="parity_grid", weights="trained on the card (parity_train)",
        ppl_card=held, ppl_cpu=cpu, delta=deltas, held=list(PARITY_HELD),
        tol=PARITY_DPPL, canonical=canon, serving_minus_fake=serving,
        ppl_card_reported=grid["reported"],
        reported_layers=PARITY_REPORTED_LAYERS,
        trained_dense={k: held[k] for k in PARITY_R05_DENSE},
        jax_r05_dense=PARITY_R05_DENSE, launches=grid["launches"],
        held_s=grid["held_s"], canonical_s=grid["canonical_s"],
        reported_s=grid["reported_s"], cpu_s=ref["parity_s"], card=card)
    if bad or not all(np.isfinite(v) for v in ppls):
        raise AssertionError(f"parity_grid: {bad}, {grid}")
    return grid["launches"]


def slice21_phases(card: str, trained: tuple) -> tuple:
    """On the card ``gear_compare`` and the grid on the weights that
    :func:`parity_train_phase` gave (``trained``: their directory and the
    seconds waited for them), while the CPU references of both run in a
    third process on those weights, then the checks of both; returns
    (each phase's seconds, flat launch counts for the kernels line)."""
    import torch

    weights_dir, waited = trained
    secs, flat = {"parity_train_wait": waited}, {}
    proc = start_cpu_references_21(weights_dir)
    t0 = time.perf_counter()
    gear = gear_compare_card()
    secs["gear_compare_card"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grid = parity_grid_card(weights_dir)
    secs["parity_grid_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = await_cpu_references(proc)
    secs["cpu_references_21_wait"] = time.perf_counter() - t0
    log(phase="cpu_references_21", parity_s=ref["parity_s"],
        gear_s=ref["gear_s"], threads=ref["threads"],
        waited_s=ref["waited_s"], card=card)
    flat["gear_compare"] = gear_compare_phase(card, gear, ref)
    flat["parity_grid"] = parity_grid_phase(card, grid, ref)
    return secs, flat


def slice17_served_phases(packed, card: str) -> tuple:
    """``frontends`` and ``cot_evals`` on the 32-layer MX-FP6 model;
    returns (each phase's seconds, their launches by path)."""
    secs, counts = {}, {}
    for name, fn in (("frontends", frontends_phase),
                     ("cot_evals", cot_evals_phase)):
        t0 = time.perf_counter()
        counts[name] = fn(packed, card)
        secs[name] = time.perf_counter() - t0
    return secs, counts


def slice17_model_phases(card: str, secs: dict, counts: dict) -> None:
    """``kv_accuracy``, ``families`` and ``hf_loading``, each on models of
    its own: their seconds join ``secs``, the families' launches
    ``counts``; then the ``slice17_phases`` line."""
    for name, fn in (("kv_accuracy", kv_accuracy_phase),
                     ("families", families_phase),
                     ("hf_loading", hf_loading_phase)):
        t0 = time.perf_counter()
        out = fn(card)
        secs[name] = time.perf_counter() - t0
        if name == "families":
            counts.update(out)
    log(phase="slice17_phases", seconds=secs, total_s=sum(secs.values()),
        card=card)


# ``--only``: the sources each slice's phases launch, and the -k expression
# of its card tests in tests/test_torch_kernels_gpu.py
ONLY_SLICES = {
    "slice17": (("dequant_gemv", "dequant_matmul", "quant_attention"),
                "moe_router or alibi or safetensors"),
    "slice18": (("dequant_gemv", "dequant_matmul", "nb_matmul"), "mx_"),
    "slice19": (("dequant_gemv", "dequant_matmul", "nb_matmul",
                 "quant_attention"), "posit or vq or tp_wrappers"),
    "slice20": (("dequant_gemv", "dequant_matmul", "quant_attention"),
                "llava"),
    "slice21": (("dequant_gemv", "dequant_matmul", "nb_matmul",
                 "quant_attention", "mx_quant"),
                "parity_train or gear_compare"),
}


def only_main(which: str, tests: bool) -> int:
    """``chip_smoke.py --only SLICE [--tests]``: one slice's phases alone
    on the card, after its sources' build and, with ``tests``, its card
    tests (their last lines printed)."""
    import subprocess
    import tempfile

    import torch

    from microscopiq_tpu_torch.ops.cuda import build as cuda_build

    sources, k = ONLY_SLICES[which]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    refs = start_cpu_references() if which == "slice18" else None
    refs19 = start_cpu_references_19() if which == "slice19" else None
    train21 = start_parity_train() if which == "slice21" else None
    log(phase="build", seconds=cuda_build.build_all(sources), card=card)
    trained = parity_train_phase(card, train21) if train21 else None
    if tests:
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-k", k,
             "-p", "no:cacheprovider", "tests/test_torch_kernels_gpu.py"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True)
        print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    if which == "slice17":
        packed, _ = build(True)
        secs, counts = slice17_served_phases(packed, card)
        del packed
        torch.cuda.empty_cache()
        slice17_model_phases(card, secs, counts)
        return 0
    if which == "slice18":
        secs = slice18_phases(card, refs)
    elif which == "slice19":
        secs = slice19_phases(card, refs19)[0]
    elif which == "slice21":
        secs = slice21_phases(card, trained)[0]
    else:
        ref_dir = tempfile.mkdtemp(prefix="vlm_tower_reference_")
        log(phase="vlm_tower_reference",
            seconds=vlm_tower_reference(ref_dir))
        secs = slice20_phases(card, ref_dir)[0]
    log(phase=f"{which}_phases", seconds=secs, total_s=sum(secs.values()),
        card=card)
    return 0


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--tp-rank"] and len(argv) == 4:
        return tp_rank_main(int(argv[1]), int(argv[2]), argv[3])
    if (argv[:1] == ["--only"] and len(argv) in (2, 3)
            and argv[1] in ONLY_SLICES and argv[2:] in ([], ["--tests"])):
        return only_main(argv[1], argv[2:] == ["--tests"])
    for flag, fn in (("--cpu-references-19", cpu_references_19),
                     ("--cpu-references-21", cpu_references_21),
                     ("--parity-train", parity_train)):
        if argv[:1] == [flag] and len(argv) == 2:
            torch.set_num_threads(CPU_REFERENCE_THREADS)
            print(json.dumps(fn(argv[1])), flush=True)
            return 0
    if argv not in ([], ["--gemm-times"], ["--gemv-times"],
                    ["--route-times"], ["--gemv-route-times"],
                    ["--qattn-times"], ["--quant-times"],
                    ["--cpu-references"]):
        print("usage: chip_smoke.py [--gemm-times | --gemv-times | "
              "--route-times | --gemv-route-times | --qattn-times | "
              "--quant-times | "
              "--cpu-references | "
              "--only slice17|slice18|slice19|slice20|slice21 [--tests]]",
              file=sys.stderr)
        return 2
    if argv == ["--cpu-references"]:
        torch.set_num_threads(CPU_REFERENCE_THREADS)
        print(json.dumps(cpu_references()), flush=True)
        return 0
    from microscopiq_tpu_torch.ops.cuda import build

    if argv:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        if argv == ["--gemm-times"]:
            log(phase="sm90_gemm_times", rows=sm90_gemm_times(), card=card)
        elif argv == ["--route-times"]:
            log(phase="route_times", rows=route_times(), card=card)
        elif argv == ["--gemv-route-times"]:
            log(phase="gemv_route_times", rows=gemv_route_times(),
                card=card)
        elif argv == ["--qattn-times"]:
            log(phase="qattn_times", **qattn_times(), card=card)
        elif argv == ["--quant-times"]:
            log(phase="quant_times", rows=quant_times(), card=card)
        else:
            log(phase="gemv_times", rows=gemv_times(), card=card)
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False      # plain twins: f32
    torch.backends.cudnn.allow_tf32 = False
    smi, name, count = card_info()
    card = f"{smi}"
    print(smi, flush=True)
    log(phase="device", name=name, count=count,
        torch=torch.__version__, cuda=torch.version.cuda)

    train21 = start_parity_train()      # on the card while nvcc runs
    build_s = build.build_all()
    log(phase="build", seconds=build_s, ptxas=build.ptxas_report(),
        card=card)
    refs = start_cpu_references()       # read by the slice-18 phases
    refs19 = start_cpu_references_19()  # read by the slice-19 phases
    trained21 = parity_train_phase(card, train21)
    sm90_build_line(card)
    # first, while the process is young: the profiler's windows lose
    # more kernel records at their start the older the process is
    # (profile_window's filler takes them; kernel_split_ms raises on a
    # short window)
    srows, scounts = s8_phase(card)

    rows = kernel_phase(card)
    packed, counts, _ = model_phase(card)
    engine_phase(packed, card)
    qrows = quant_attention_phase(card)
    qcounts, _ = quant_kv_main_path(packed, card)
    quant_two_layer_phase(card)
    quant_engine_phase(packed, card)
    t0 = time.perf_counter()
    kvcounts = {"trace_stats": trace_stats_phase(packed, card),
                 "h2o_engine": h2o_engine_phase(packed, card),
                 "h2o_main_path": h2o_main_path(packed, card),
                 "sink_main_path": sink_main_path(packed, card)}
    gear_codecs_phase(card)
    host_codec_phase(card)
    log(phase="kv_policy_phases", seconds=time.perf_counter() - t0, card=card)
    secs, newcounts = slice17_served_phases(packed, card)
    del packed
    torch.cuda.empty_cache()
    slice17_model_phases(card, secs, newcounts)
    secs18 = slice18_phases(card, refs)
    log(phase="slice18_phases", seconds=secs18,
        total_s=sum(secs18.values()), card=card)
    torch.cuda.empty_cache()
    secs19, tp_paths, flat19 = slice19_phases(card, refs19)
    log(phase="slice19_phases", seconds=secs19,
        total_s=sum(secs19.values()), card=card)
    torch.cuda.empty_cache()
    secs20, vlm_paths, flat20 = slice20_phases(card, refs19[1])
    log(phase="slice20_phases", seconds=secs20,
        total_s=sum(secs20.values()), card=card)
    torch.cuda.empty_cache()
    secs21, flat21 = slice21_phases(card, trained21)
    log(phase="slice21_phases", seconds=secs21,
        total_s=sum(secs21.values()), card=card)
    torch.cuda.empty_cache()

    orows = outlier_kernel_phase(card)
    ocounts = outlier_main_path(card)
    outlier_two_layer_phase(card)

    irows = int_kernel_phase(card)
    icounts = int_main_path(card)
    tcounts = int_two_layer_phase(card)
    rrows, rcounts = route_phase(card)
    mrows, mcounts = quant_phase(card)
    gptq_counts = gptq_main_path(card)
    prows, pcounts = prefill_experiments_phase(card)
    grows, gcounts = gemv_experiments_phase(card)
    log(phase="profiler_windows", windows=len(filler_lost),
        filler=PROFILE_FILLER, filler_lost_max=max(filler_lost),
        filler_lost_by_window=filler_lost, card=card)

    print(json.dumps(kernels_line(rows, counts, qrows, qcounts, orows,
                                  {**ocounts, "gptq": gptq_counts,
                                   **kvcounts, **newcounts, **tp_paths,
                                   **vlm_paths},
                                  irows, icounts, tcounts, srows,
                                  scounts, mrows, mcounts, prows, pcounts,
                                  grows, gcounts, rrows, rcounts,
                                  {**flat19, **flat20, **flat21})),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
