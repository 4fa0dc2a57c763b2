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
   K/V), and untimed at 2 and 8 bits, grouped V scales, GEAR-L rank 2 and
   ragged per-slot lengths. Its times are device times (torch.profiler)
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
    compact NB (budget 2) and side-band (budget 4) GEMVs at M = 1, 8, 64,
    255 (the side-band one with its HBM rate, plan and occupancy) and their
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
13. ``int_kernels_vs_plain``: the GEMV (M = 1, 8, 64) and GEMM (M = 128,
    1024) in every other transport of the TPU kernels at the Llama-3-8B
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
    64 and 48, the fp16 container at 8, 64 and 48, the side-band format at
    8, 64 and 48 with 4 slots and at 8 with 8, emi8 at 8, 64 and 48, sb4
    at 2, 8, 64 and 48, sb2 at 4, 64 and 48, the int8 container and the
    float8 containers at 8, 64, 2 and 48), at gate_up, M = 1024, each
    on the kernel that ``dequant_matmul.gemm_route`` names (the sm90 loop,
    or ``gemm_tile`` where the block does not divide its K step) and held
    to its plain twin, timed; then one call a case as the entry point's
    run, with exact launch counts;
17. ``sad_s8_vs_plain`` (run right after the build, while the profiler's
    windows are whole): the W8A8 GEMV (int8, int4/sb4, int2/sb2) at every
    shape, M = 1, 8, 64, against ``dequant_matmul_sad_s8_reference``, the
    whole call and its GEMV alone (a profiler window checked against the
    wrappers' launch counts), beside the bf16-activation GEMV,
    ``torch.matmul`` and ``torch._int_mm``; the one-launch activation
    quantizer bit-equal to its twin;
18. ``mx_quant_vs_plain``: the MX block quantizer in five formats on every
    weight shape (block 32) and a ragged one (block 16), bit-equal to
    ``pack_mx(exact_scale=True)``, timed beside the byte bound;
19. ``gptq_main_path``: Llama-3-8B at full width, 2 layers, GPTQ-calibrated
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

The line before the last is the card's name and power limit, the one before
it ``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --gemm-times

times only the pf6, side-band, pf4, fp16-container, emi8, emi8m,
compact-NB, sb4, sb2, int8-container, fp8_e4m3, fp8_e5m2 and
bf16-container GEMMs (and ``torch.matmul`` on a bf16 weight) at
M = 1024 at every Llama-3-8B shape on seeded operands and prints them as
one JSON line (``sm90_gemm_times``), to compare two checkouts on one
card.

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
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time

import numpy as np

# the timing helpers, shared with the experiment scripts (this import fails
# where the package is missing, and the script with it)
from microscopiq_tpu_torch.utils.observability import (card_line, copies_for,
                                                       cuda_ms)

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
GEMM_M = (128, 1024)


def log(**rec):
    print(json.dumps(rec), flush=True)


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
                   feed=None, graph=True, info=None):
    """bench.py's main path: last_only prefill, then greedy decode steps,
    over a dense bf16 KV cache or, with ``quant_cfg``, a quantized one.
    ``feed`` (B, steps) replaces the greedy tokens fed to the decode steps.

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

    cfg = model.cfg
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
        logits = model(ids, positions=pos, cache=cache, last_only=True)
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
                   graph_run, card: str, quant_cfg=None) -> float:
    """The decode (over the dense cache, or the quantized one of
    ``quant_cfg``) run eagerly, in this process and on the prompt of
    ``graph_run`` (a graph run's prefill_decode result): its tokens and
    last logits must equal the graph run's bit for bit, fold steps
    included, and its decode launches the graph run's (the warm-up step's
    plus each captured step's times its replays). Logs one line; returns
    the eager ms/step."""
    import torch

    eager = prefill_decode(model, ids, steps, max_len, graph=False,
                           quant_cfg=quant_cfg)
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
}
QKV_GAP, QKV_KVH, QKV_H, QKV_HD = 64, 8, 32, 128


def qattn_state(B, C, bits, v_group, rank, lengths, seed):
    """One layer of a quantized cache on the card, as the decode path holds
    it: random K/V quantized by the port's chunk codec (``_compress_chunks``)
    into C chunks, a bf16 residual window, and per-slot live lengths.
    Returns (state_full tuple with a leading layer axis of 1, lengths)."""
    import torch

    from microscopiq_tpu_torch.kv.cache import (QuantKVConfig,
                                                _compress_chunks,
                                                _FUSED_FIELDS,
                                                _LOWRANK_FIELDS)

    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    cfg = QuantKVConfig(bits=bits, gap=QKV_GAP, v_group=v_group, rank=rank)
    shape = (B, QKV_KVH, C, QKV_GAP, QKV_HD)
    # channel-wise magnitudes, as real keys have (KIVI's premise)
    kc = rn(*shape) * torch.exp(rn(B, QKV_KVH, 1, 1, QKV_HD))
    pieces = _compress_chunks(kc, rn(*shape), cfg)
    del kc
    res = lambda: rn(B, QKV_GAP, QKV_KVH, QKV_HD).to(torch.bfloat16)
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
    rep, scale = QKV_H // QKV_KVH, QKV_HD ** -0.5
    cases = {**QATTN_TIMED, **QATTN_CHECKED}
    for i, (name, c) in enumerate(cases.items()):
        full, lengths = qattn_state(**c, seed=100 + i)
        kq, kmn, ksc, vq, vmn, vsc = (t[0] for t in full[:6])
        lowrank = tuple(t[0] for t in full[8:]) or None
        B = c["B"]
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q = torch.randn((B, QKV_H, QKV_HD), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        qg = q.reshape(B, QKV_KVH, rep, QKV_HD).contiguous()
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
    Llama-3-8B shape and M = 1, 8, 64, 200, their GEMMs at M = 256, 1024;
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
            ("dequant_gemv_nb", "nb", nb, OUTLIER_M, om.dequant_gemv_nb,
             om.dequant_matmul_nb_reference, OUTLIER_REL_TOL, nb_dense),
            ("dequant_gemm_nb", "nb", nb, OUTLIER_GEMM_M, om.dequant_gemm_nb,
             om.dequant_matmul_nb_reference, GEMM_REL_TOL, nb_dense),
            ("dequant_gemv_outlier", "sideband", sb, OUTLIER_M,
             om.dequant_gemv_outlier, om.dequant_matmul_outlier_reference,
             OUTLIER_REL_TOL, sb_dense),
            ("dequant_gemm_outlier", "sideband", sb, OUTLIER_GEMM_M,
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
    """The GEMV (M = 1, 8, 64) and GEMM (M = 128, 1024) in every other
    transport at the Llama-3-8B shapes, each against dequant_matmul_reference,
    timed beside the bound, the plain version and torch.matmul on the
    dequantized bf16 weight."""
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
                    ("gemv", GEMV_M, dm.dequant_gemv, GEMV_REL_TOL),
                    ("matmul", GEMM_M, dm.dequant_gemm, GEMM_REL_TOL)):
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
    Llama-3-8B shape and M = 1, 8, 64, beside the bf16-activation GEMV on
    the same weight, torch.matmul on the dequantized bf16 weight and, where
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
            for M in GEMV_M:
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


GPTQ_LAYERS = 2                 # of Llama-3-8B's 32: calibration is per layer
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


def kernels_line(rows, counts, qrows, qcounts, orows, ocounts, irows,
                 icounts, tcounts, srows, scounts, mrows, mcounts, prows,
                 pcounts, grows, gcounts, rrows, rcounts):
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
    for the NB kernels; for
    the GEMMs at the MX blocks that no model path packs (the gemm_tile
    routes of pf6, pf4, fp16, emi8, sb4, sb2, int8, float8 and the
    side-band format, and the sm90 ones at the other blocks of
    ROUTE_CASES), the block-route entry point's run. The GEMMs that run on
    the wgmma + TMA mainloop (pf6, pf4, sb4, sb2, fp16, emi8/emi8m, int8,
    float8, side-band, compact NB) carry ``mainloop``; the bf16 GEMM runs
    on ``gemm_tile``.
    The emi8 GEMV and GEMM run on three paths: their timed numbers and
    ``shapes`` are MX-FP6 emi8 at block 32, ``shapes_emi8m_block16`` the
    emi8m stream."""
    paths = {"mxfp6": counts, "quant_kv": qcounts, **ocounts, **icounts}
    flat = {**{f"two_layer_{c}": n for c, n in tcounts.items()},
            "w8a8_entry_point": scounts, "quantizer_entry_point": mcounts,
            "block_routes_entry_point": rcounts}

    def by_path(name):
        got = {p: c["prefill"][name] + c["decode"][name]
               for p, c in paths.items()}
        got.update({p: c.get(name, 0) for p, c in flat.items()})
        return {p: n for p, n in got.items() if n}

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
    for name, (src, line) in ROUTE_KERNELS.items():
        mine = [r for r in rrows if r["kernel"] == name]
        at = mine[0]
        launches = by_path(name)
        out.append({
            "name": name, "route": "cuda",
            "source": f"microscopiq_tpu_torch/ops/cuda/csrc/{src}",
            "replaces": f"microscopiq_tpu/ops/pallas/dequant_matmul.py:{line}",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "at": f"gate_up (4096, 28672) M={SM90_M}, {at['kind']} block "
                  f"{at['block']}" + (f", budget {at['budget']}"
                                      if at["kind"] == "sideband" else ""),
            "blocks": _route_rows(rrows, name),
            "block_keys": list(ROUTE_KEYS)})
    for decode in GEMV_CC_DECODES:
        name = f"dequant_gemv_{decode}_cc"
        mine = [r for r in rrows if r["kernel"] == name]
        at = mine[0]
        launches = by_path(name)
        out.append({
            "name": name, "route": "cuda",
            "source": "microscopiq_tpu_torch/ops/cuda/csrc/dequant_gemv.cu",
            "replaces": "microscopiq_tpu/ops/pallas/dequant_matmul.py:"
                        + str(80 if decode.startswith("fp8") else 162),
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "at": f"gate_up (4096, 28672) M=8, {at['kind']} block "
                  f"{at['block']}: gemv_partial on CUDA cores, the blocks "
                  "that are no multiple of 16",
            "blocks": _route_rows(rrows, name),
            "block_keys": list(ROUTE_KEYS)})
    out += prefill_kernel_records(prows, pcounts)
    out += gemv_kernel_records(grows, gcounts)
    return {"kernels": out}


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
    outlier_matmul.cu, the compact NB GEMM in nb_matmul.cu) and the dynamic
    shared memory that their host-side plan gives each compiled ring
    (ptxas reports static shared memory only)."""
    from microscopiq_tpu_torch.ops.cuda import build
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    lines = [ln for ln in build.ptxas_report(("dequant_matmul",
                                              "outlier_matmul", "nb_matmul"))
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
# container, emi8 (fp6_e3m2, any block), the side-band format (int2 +
# fp4, any block), sb4 (int4; % 2), sb2 (int2; % 4), the int8 container
# (kind "native", its decode) and the float8 containers (any block): the
# sm90 loop at 8 and 64 (sb4 also at 2, sb2 at 4), gemm_tile at 48 and 128
# (int8 and float8 at 2 and 48) and for the side-band format at block 8
# with 8 slots. The compact NB format
# (block 16) takes the sm90 loop at every budget its packer makes (up to
# 16): it has no gemm_tile case here.
ROUTE_CASES = (("pf6", "fp6_e3m2", 64, 0), ("pf6", "fp6_e3m2", 128, 0),
               ("pf4", "fp4_e2m1", 16, 0), ("pf4", "fp4_e2m1", 64, 0),
               ("pf4", "fp4_e2m1", 48, 0), ("fp16", "fp16", 8, 0),
               ("fp16", "fp16", 64, 0), ("fp16", "fp16", 48, 0),
               ("bf16", "bfloat16", 8, 0), ("bf16", "bfloat16", 64, 0),
               ("bf16", "bfloat16", 48, 0),
               ("sideband", "int2", 8, 4), ("sideband", "int2", 64, 4),
               ("sideband", "int2", 48, 4), ("sideband", "int2", 8, 8),
               ("emi8", "fp6_e3m2", 8, 0), ("emi8", "fp6_e3m2", 64, 0),
               ("emi8", "fp6_e3m2", 48, 0), ("sb4", "int4", 2, 0),
               ("sb4", "int4", 8, 0), ("sb4", "int4", 64, 0),
               ("sb4", "int4", 48, 0), ("sb2", "int2", 4, 0),
               ("sb2", "int2", 64, 0), ("sb2", "int2", 48, 0))
ROUTE_CASES += tuple((kind, fmt, block, 0)
                     for kind, fmt in (("native", "int8"),
                                       ("fp8_e4m3", "fp8_e4m3"),
                                       ("fp8_e5m2", "fp8_e5m2"))
                     for block in (8, 64, 2, 48))
# the gemm_tile routes' kernel records: counter -> (source, TPU kernel line)
ROUTE_KERNELS = {"dequant_matmul_pf6_tile": ("dequant_matmul.cu", 71),
                 "dequant_matmul_pf4_tile": ("dequant_matmul.cu", 71),
                 "dequant_matmul_fp16_tile": ("dequant_matmul.cu", 71),
                 "dequant_matmul_bf16_tile": ("dequant_matmul.cu", 71),
                 "dequant_gemm_outlier_tile": ("outlier_matmul.cu", 111),
                 "dequant_matmul_emi8_tile": ("dequant_matmul.cu", 71),
                 "dequant_matmul_sb4_tile": ("dequant_matmul.cu", 71),
                 "dequant_matmul_sb2_tile": ("dequant_matmul.cu", 71),
                 "dequant_matmul_native_tile": ("dequant_matmul.cu", 71),
                 "dequant_matmul_fp8_e4m3_tile": ("dequant_matmul.cu", 80),
                 "dequant_matmul_fp8_e5m2_tile": ("dequant_matmul.cu", 80)}
ROUTE_KEYS = ("kind", "block", "budget", "ms", "bound_ms", "plain_ms",
              "library_ms", "rel_err")
# the decodes whose GEMV takes the CUDA-core kernel at a block of
# ROUTE_CASES (blocks no multiple of 16): emi8 and the 16-bit containers at
# 8, sb4 at 2 and 8, sb2 at 4, the int8 and float8 containers at 8 and 2
GEMV_CC_DECODES = ("emi8", "fp16", "bf16", "sb4", "sb2", "native",
                   "fp8_e4m3", "fp8_e5m2")


def _route_rows(rrows, name):
    return [[r[k] for k in ROUTE_KEYS] for r in rrows
            if r["kernel"] == name]


def route_phase(card: str):
    """Each case of ROUTE_CASES at gate_up, M = 1024, through the GEMM
    wrapper against its plain twin (2e-3 of max |twin|), on the kernel that
    ``gemm_route`` names, and (all but the side-band format) at M = 8
    through the GEMV on the kernel that ``gemv_route`` names (1e-5), timed
    beside the bound, the plain version and torch.matmul on the
    dequantized bf16 weight; then the entry point's own run: one call a
    case, counts zeroed just before and read just after. Returns (rows,
    launches)."""
    import torch

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

    _, K, N = next(s for s in SHAPES if s[0] == "gate_up")
    gen = torch.Generator(device="cuda").manual_seed(808)
    x = torch.randn((SM90_M, K), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    rows, weights = [], []
    for kind, fmt, block, budget in ROUTE_CASES:
        route = dm.gemm_route(kind, block, budget)
        if kind == "sideband":
            p = pk.pack_mx_outlier(outlier_weight((K, N), gen), 8, 8, fmt,
                                   "fp4_e2m1", std_dev=2.0,
                                   block_size=block, outlier_budget=budget,
                                   axis=0)
            fn, ref = om.dequant_gemm_outlier, \
                om.dequant_matmul_outlier_reference
            dense = pk.dequantize_mx_outlier(p, dtype=torch.bfloat16)
            name = om.gemm_counter(block, budget)
        else:
            transport = ("native" if kind in ("fp16", "bf16", "native",
                                              "fp8_e4m3", "fp8_e5m2")
                         else kind)
            # bfloat16 blocks of 8 need 16x BF16_GAIN for amax > 2 in every
            # block (none at the -127 exponent the kernels clamp)
            W = int_weight(fmt, (K, N), gen).float()
            p = pk.to_serving_layout(pk.pack_mx(
                W * 16 if fmt == "bfloat16" and block < 32 else W, 8, fmt,
                block, axis=0, transport=transport))
            del W
            fn, ref = dm.dequant_gemm, dm.dequant_matmul_reference
            dense = pk.dequantize_mx(p, dtype=torch.bfloat16)
            name = dm.gemm_counter(kind, block)
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
        nc = copies_for(p.nbytes())
        ps = [p] + [_clone_packed(p) for _ in range(nc - 1)]
        nd = copies_for(dense.numel() * 2)
        ds = [dense] + [dense.clone() for _ in range(nd - 1)]
        ms = cuda_ms(lambda i: fn(x, ps[i], torch.float32), nc)
        plain_ms = cuda_ms(lambda i: ref(x, p, torch.float32), 1,
                           target_ms=20.0)
        lib_ms = cuda_ms(lambda i: torch.matmul(x, ds[i]), nd)
        bound, by = row_bound(p.nbytes() + x.numel() * 2 + SM90_M * N * 4,
                              SM90_M, N, K)
        row = dict(kernel=name, route=route, kind=kind, format=fmt,
                   block=block, budget=budget, linear="gate_up", M=SM90_M,
                   K=K, N=N, max_abs_err=err, rel_err=rel,
                   tol=GEMM_REL_TOL, ms=ms, bound_ms=bound, bound_by=by,
                   plain_ms=plain_ms, library_ms=lib_ms, card=card)
        rows.append(row)
        log(phase="gemm_block_routes", **row)
        weights.append((fn, p, x))
        if kind != "sideband":
            # the GEMV at the same block, on the kernel gemv_route names
            # (gemv_tc, or the CUDA-core one: its "_cc" counter)
            xg = x[:8]
            gname = dm.gemv_counter(kind, block)
            reset_counts()
            got = dm.dequant_gemv(xg, p, torch.float32)
            want = ref(xg, p, torch.float32)
            torch.cuda.synchronize()
            if launches()[gname] != 1:
                raise AssertionError(f"{kind} block {block}: no {gname}")
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not (np.isfinite(rel) and rel < GEMV_REL_TOL):
                raise AssertionError(f"{gname} block {block}: rel err {rel}")
            ms = cuda_ms(lambda i: dm.dequant_gemv(xg, ps[i], torch.float32),
                         nc)
            plain_ms = cuda_ms(lambda i: ref(xg, p, torch.float32), 1,
                               target_ms=20.0)
            lib_ms = cuda_ms(lambda i: torch.matmul(xg, ds[i]), nd)
            bound, by = row_bound(p.nbytes() + xg.numel() * 2 + 8 * N * 4,
                                  8, N, K)
            row = dict(kernel=gname, kind=kind, format=fmt, block=block,
                       budget=0,
                       linear="gate_up", M=8, K=K, N=N, max_abs_err=err,
                       rel_err=rel, tol=GEMV_REL_TOL, ms=ms, bound_ms=bound,
                       bound_by=by, plain_ms=plain_ms, library_ms=lib_ms,
                       **gemv_stats(p, 8, K, N, ms), card=card)
            rows.append(row)
            log(phase="gemv_block_routes", **row)
            weights.append((dm.dequant_gemv, p, xg))
        del ps, ds, dense, got, want
        torch.cuda.empty_cache()
    reset_counts()
    for fn, p, xi in weights:
        fn(xi, p, torch.bfloat16)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    want = {}
    for r in rows:
        want[r["kernel"]] = want.get(r["kernel"], 0) + 1
    if counts != want:
        raise AssertionError(f"block-route entry point launches {counts}, "
                             f"want {want}")
    del weights
    torch.cuda.empty_cache()
    return rows, counts


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv not in ([], ["--gemm-times"], ["--gemv-times"],
                    ["--qattn-times"], ["--quant-times"]):
        print("usage: chip_smoke.py [--gemm-times | --gemv-times | "
              "--qattn-times | --quant-times]", file=sys.stderr)
        return 2
    from microscopiq_tpu_torch.ops.cuda import build

    if argv:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        if argv == ["--gemm-times"]:
            log(phase="sm90_gemm_times", rows=sm90_gemm_times(), card=card)
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

    build_s = build.build_all()
    log(phase="build", seconds=build_s, ptxas=build.ptxas_report(),
        card=card)
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
    del packed
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
                                  {**ocounts, "gptq": gptq_counts}, irows,
                                  icounts, tcounts, srows,
                                  scounts, mrows, mcounts, prows, pcounts,
                                  grows, gcounts, rrows, rcounts)),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
