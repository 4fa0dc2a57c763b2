"""``csrc/gemv_any.cu``'s GEMVs (the "any" route: the blocks that are no
multiple of 16) on the CPU: their host side and their arithmetic.

- ``dequant_matmul.any_plan`` for every decode and every block 1-256 that
  ``gemv_route`` / ``s8_route`` give the new kernels: within the 227 KB
  (232,448 bytes) a block may use, a split of whole blocks and a stage that
  do not depend on M; the plan's constants and formulas are the kernel
  source's.
- The positions of an mma step: a thread's decode reads, for each of its K
  positions, the packed row and field that the position order names (field
  f of packed row pr is position pr * F + f), and that order is the
  packers' layout (field f of packed row pr holds K row pr + f * B / F).
- A CPU model of each kernel's arithmetic, stage by stage and step by step
  as the kernel walks them: per block, the masked slices' dots summed into
  the block's accumulator (f32, or exact int for W8A8), then the block's
  2^(se - fold) and the add into the split's f32 sum; the splits added in
  order; and the bf16-x kernel's folded steps (blocks dividing 8, every
  scale of a 32-column warp's blocks in a full step within
  ``fold_range``): x times the weights already scaled, exact, into the
  sum. The fold range keeps every decoded value times its scale a normal
  bf16 (checked over each transport's codes). It agrees with the JAX ``dequant_matmul_sad`` (Pallas interpret
  mode) at blocks 2, 4 and 8, with ``dequant_matmul_reference`` at 6, 12,
  20 and 24 (where the JAX kernel's K tile is no multiple of the block),
  and the W8A8 model with ``dequant_matmul_sad_s8`` at int8 2, 4, 8; sb4 2,
  4, 8; sb2 4, 8: within 1e-5 of max |JAX|, the GEMV tolerance (exact
  products, f32 sums in another order).

The CUDA kernels are held to their plain twins on a card by
tests/test_torch_kernels_gpu.py (``-k "gemv_any or gemv_route_block or
w8a8"``).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul_reference as j_ref, dequant_matmul_sad as j_sad,
    dequant_matmul_sad_s8 as j_sad_s8)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

CSRC = Path(dm.__file__).resolve().parent / "csrc"
SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
          "down": (14336, 4096), "lm_head": (4096, 128256)}
PLAN_M = (1, 7, 8, 9, 16, 33, 64)
# (format, transport) of every decode the bf16-x kernel takes, with the
# weight scale of tests/test_torch_tc_gemv.py's DECODE_CASES (the bf16
# container at 8, so that no block exponent meets the 2^-126 floor)
ANY_CASES = [("fp6_e3m2", "emi8"), ("int8", "native"), ("int4", "sb4"),
             ("int2", "sb2"), ("bfloat16", "native"), ("fp16", "native"),
             ("fp8_e4m3", "native"), ("fp8_e5m2", "native"),
             ("fp6_e3m2", "native")]


def _packer_blocks(decode):
    """The blocks 1-256 that a packer makes for ``decode``'s transport."""
    return [B for B in range(1, 257) if B % dm._FIELDS.get(decode, 1) == 0
            and not (decode == "pf4" and B % 16)
            and not (decode == "pf6" and B % 32)]


# ---------------------------------------------------------------------------
# the routes and the plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decode", sorted(dm._DECODES))
def test_every_packer_block_has_a_tensor_core_route(decode):
    """gemv_route names gemv_tc or gemv_any.cu's kernel for every block a
    packer makes; "cc" (gemv_partial) is left to blocks no packer makes;
    s8_route likewise for the W8A8 decodes."""
    for B in _packer_blocks(decode):
        assert dm.gemv_route(decode, B) in ("tc", "any"), B
        if decode in dm._S8_DECODES:
            assert dm.s8_route(decode, B) in ("tc", "any"), B
    for B in range(1, 257):
        if B not in _packer_blocks(decode):
            assert dm.gemv_route(decode, B) in ("tc", "cc"), B


def _check_any_plan(plan, decode, N, K, B, M, xb):
    NB = -(-K // B)
    nbps = plan["split_blocks"]
    assert plan["smem_bytes"] <= 232448
    assert 2 <= plan["stages"] <= 8
    assert plan["ksplit"] * nbps >= NB > (plan["ksplit"] - 1) * nbps
    assert nbps * B <= max(1024, B)           # GEMV_SPLIT_ROWS, or a block
    cb = 2 if decode in ("bf16", "fp16") else 1
    F = dm._FIELDS.get(decode, 1)
    assert plan["stage_rows"] == 128 // cb
    assert plan["stage_positions"] == 128 // cb * F
    S, E = plan["stage_positions"], plan["exp_rows"]
    # E covers the blocks that any S positions from a block edge touch
    starts = range(0, nbps * B, S)
    assert max((q + S - 1) // B - q // B + 1 for q in starts) <= E <= 256
    assert plan["n8_tiles"] == dm.gemv_n8_tiles(M)
    assert plan["col_tiles"] == -(-N // 256)
    assert plan["tiles"] == plan["col_tiles"] * plan["ksplit"]
    assert plan["ctas"] == min(plan["tiles"], 132)
    assert plan["tma"] == (N % 16 == 0)
    pad = 16 if xb == 2 else 32
    assert plan["x_pitch"] == -(-nbps * B // pad) * pad * xb + 16
    x_bytes = -(-8 * plan["n8_tiles"] * plan["x_pitch"] // 128) * 128
    assert plan["stage_bytes"] == (2 * cb * 128 // cb * 128
                                   + -(-E * 256 // 1024) * 1024)
    assert plan["smem_bytes"] == (2048 + x_bytes
                                  + plan["stages"] * plan["stage_bytes"])


@pytest.mark.parametrize("decode,xb",
                         [(d, 2) for d in sorted(dm._ANY_DECODES)]
                         + [(d, 1) for d in dm._S8_DECODES])
def test_any_plan_fits_and_its_split_ignores_m(decode, xb):
    """Every block 1-256 that the route gives the new kernel, at the
    Llama-3-8B shapes and a ragged one: the plan fits 232,448 bytes, and
    its split and stage do not depend on M."""
    route = dm.gemv_route if xb == 2 else dm.s8_route
    blocks = [B for B in range(1, 257) if route(decode, B) == "any"]
    assert blocks
    for B in blocks:
        for K, N in list(SHAPES.values()) + [(200, 130)]:
            plans = [dm.any_plan(decode, N, K, B, M, xb) for M in PLAN_M]
            for M, plan in zip(PLAN_M, plans):
                _check_any_plan(plan, decode, N, K, B, M, xb)
            assert len({(p["ksplit"], p["split_blocks"], p["exp_rows"],
                         p["stage_bytes"], p["x_pitch"])
                        for p in plans}) == 1


@pytest.mark.parametrize("decode", sorted(dm._DECODES))
def test_gemv_routes_and_counters(decode):
    for B in range(1, 257):
        route = dm.gemv_route(decode, B)
        suffix = {"tc": "", "any": "_any", "cc": "_cc"}[route]
        assert dm.gemv_counter(decode, B) == f"dequant_gemv_{decode}{suffix}"
        assert dm.gemv_counter(decode, B) in dm.launch_counts
        if route != "cc" and decode in dm._ANY_DECODES:   # tc blocks too
            dm.any_plan(decode, 1040, 520, B, 8)
        else:
            with pytest.raises(ValueError, match="no gemv_any.cu"):
                dm.any_plan(decode, 1040, 520, B, 8)
    if decode in dm._S8_DECODES:
        for B in range(1, 257):
            route = dm.s8_route(decode, B)
            suffix = {"tc": "", "any": "_any", "cc": "_cc"}[route]
            assert dm.s8_counter(decode, B) == \
                f"dequant_gemv_s8_{decode}{suffix}"
            assert dm.s8_counter(decode, B) in dm.launch_counts


def test_any_plan_at_the_main_path_shape():
    """emi8 at gate_up, block 8, M = 8: stages of 128 rows in two 16 KB
    sub-tiles and 16 exponent rows (4 KB), 8 splits of 64 blocks (512
    rows), six stages, 896 tiles over 132 persistent CTAs."""
    plan = dm.any_plan("emi8", 28672, 4096, 8, 8)
    assert plan == {"n8_tiles": 1, "stage_positions": 128, "stage_rows": 128,
                    "exp_rows": 16, "stage_bytes": 36864, "ksplit": 8,
                    "split_blocks": 64, "x_pitch": 1040, "stages": 6,
                    "smem_bytes": 2048 + 8320 + 6 * 36864,
                    "col_tiles": 112, "tiles": 896, "ctas": 132,
                    "tma": True}


def test_any_plan_mirrors_the_kernel_source():
    from microscopiq_tpu_torch.ops.cuda import build

    assert "gemv_any" in build.SOURCES     # built with the others, at once
    src = (CSRC / "gemv_any.cu").read_text()
    for line in ("p.rows_s = kSubW / CB;", "p.S = p.rows_s * F;",
                 "p.E = p.S % p.B == 0 ? p.S / p.B : (p.S + p.B - 2) / p.B "
                 "+ 1;",
                 "p.sub_stride = align_up(p.rows_s * kSubW, 1024);",
                 "p.se_off = 2 * CB * p.sub_stride;",
                 "p.stage_bytes = p.se_off + align_up(p.E * kTN, 1024);",
                 "p.x_pitch = XB == 2 ? align_up(p.nbps * p.B, 16) * 2 + 16",
                 ": align_up(p.nbps * p.B, 32) + 16;",
                 "return kAlign + kBarBytes + p.stages * p.stage_bytes\n"
                 "         + align_up(8 * nt * p.x_pitch, 128);",
                 "p.tma = N % 16 == 0",
                 "if (p.E > 256 || smem != smem_bytes(p, n8_tiles(p.M)))",
                 "if (p.B % F != 0) return"):
        assert line in src, line
    # the decodes the bf16-x entry takes are _ANY_DECODES
    entry = src.split('extern "C" int dequant_gemv_any')[1].split(
        'extern "C"')[0]
    names = {"emi8": "kEmi8", "native": "kInt8", "sb4": "kSb4",
             "sb2": "kSb2", "pf4": "kPf4", "pf6": "kPf6", "bf16": "kBf16",
             "fp16": "kFp16", "fp8_e4m3": "kFp8E4m3",
             "fp8_e5m2": "kFp8E5m2"}
    for d, k in names.items():
        assert (f"case mxq::{k}:" in entry) == (d in dm._ANY_DECODES), d


# ---------------------------------------------------------------------------
# the positions of an mma step
# ---------------------------------------------------------------------------
def krow(j, B, F):
    """gemv_any.cu's krow: the K row (in its block) of position j."""
    return j // F + (j % F) * (B // F)


def bf16_step_reads(decode):
    """{position of a step: (packed row, field)} as decode_step reads them,
    for step s = 0: thread t, value i at position 2t + (i & 1) + 8 (i >> 1)."""
    out = {}
    for t in range(4):
        for i in range(4):
            h, q = i & 1, i >> 1
            pos = 2 * t + h + 8 * q
            if decode == "sb4":
                out[pos] = (t + 4 * q, h)
            elif decode == "sb2":
                out[pos] = (2 * q + (t >> 1), 2 * (t & 1) + h)
            else:
                out[pos] = (2 * t + h + 8 * q, 0)
    return out


def s8_step_reads(decode):
    """The same for step_words (W8A8): thread t, byte e at position 4t + e."""
    out = {}
    for t in range(4):
        for e in range(4):
            if decode == "sb4":
                out[4 * t + e] = (2 * t + (e >> 1), e & 1)
            elif decode == "sb2":
                out[4 * t + e] = (t, e)
            else:
                out[4 * t + e] = (4 * t + e, 0)
    return out


@pytest.mark.parametrize("decode", ["emi8", "native", "sb4", "sb2", "bf16"])
def test_step_reads_the_positions_packed_order(decode):
    F = dm._FIELDS.get(decode, 1)
    for reads in (bf16_step_reads(decode), s8_step_reads(decode)):
        assert sorted(reads) == list(range(16))
        for pos, (row, f) in reads.items():
            assert (row, f) == (pos // F, pos % F), (pos, row, f)


def test_fold_range_mirrors_the_kernel_source():
    """The folded steps' exponent range is the kernel's, and every decoded
    value times 2^e over that range is a normal bf16 (exact)."""
    src = (CSRC / "gemv_any.cu").read_text()
    for line in ("hi = 127 - 7;", "hi = 127 - 3;", "hi = 127 - 1;",
                 "lo = -126 + 9;", "hi = 127 - 8;", "lo = -126 + 16;",
                 "hi = 127 - 15;", "hi = 127 - (6 - sh + (1 << sh));",
                 "const bool fold_any = p.B <= 8 && 8 % p.B == 0 && p.fold >= 0",
                 "if constexpr (!S8 && D != mxq::kBf16 && D != mxq::kFp16) {",
                 "const uint32_t e = bw[i] - bias4;    // se - fold + 127"):
        assert line in src, line
    fmts = {"native": ("int8", "native"), "sb4": ("int4", "sb4"),
            "sb2": ("int2", "sb2"), "fp8_e4m3": ("fp8_e4m3", "native"),
            "fp8_e5m2": ("fp8_e5m2", "native"),
            "emi8": ("fp6_e3m2", "emi8")}
    for decode, (fmt, tr) in fmts.items():
        # every code the transport holds, decoded, at the range's ends
        K = 256
        W = torch.linspace(-1, 1, K)[:, None].repeat(1, 4) * 1e3
        pk = tpk.to_serving_layout(tpk.pack_mx(W, 8, fmt, 32, axis=0,
                                               transport=tr))
        d, fold, mw, _ = dm.sad_decode_params(pk)
        assert d == decode
        lo, hi = fold_range(decode, mw)
        unit = dataclasses.replace(pk, scale_exp=torch.full_like(
            pk.scale_exp, fold))
        v = tpk.dequantize_mx(unit, dtype=torch.float32)
        v = v[v != 0].abs().double()
        for e in (lo, hi):
            prod = v * 2.0 ** e
            assert prod.min() >= 2.0 ** -126 and prod.max() < 2.0 ** 128


def test_step_reads_mirror_the_kernel_source():
    src = (CSRC / "gemv_any.cu").read_text()
    for line in ("row_word(sub, 4 * s + 2 * q + (t >> 1), byte);",
                 "const int f0 = 2 * (t & 1);",
                 "((w >> (2 * (f0 + h))) & 0x03030303u) ^ 0x02020202u;",
                 "row_word(sub, 8 * s + t + 4 * q, byte);",
                 "const int row = 16 * s + 2 * t + (i & 1) + 8 * (i >> 1);",
                 "row_word(sub, 16 * s + 4 * t + e, byte);",
                 "row_word(sub, 8 * s + 2 * t, byte);",
                 "row_word(sub, 8 * s + 2 * t + 1, byte);",
                 "w[1] = field_bytes<D>(w0, 1);",
                 "w[2] = field_bytes<D>(w1, 0);",
                 "row_word(sub, 4 * s + t, byte);",
                 "return j / F + (j % F) * (B / F);"):
        assert line in src, line


@pytest.mark.parametrize("fmt,transport,B", [("int4", "sb4", 2),
                                             ("int4", "sb4", 6),
                                             ("int2", "sb2", 4),
                                             ("int2", "sb2", 12),
                                             ("int4", "sb4", 26)])
def test_position_order_is_the_packed_layout(fmt, transport, B):
    """Field f of packed row pr of a block holds the code of K row krow(pr
    * F + f), so the stage's S / F packed rows are its S positions."""
    K, N = 4 * B, 8
    rng = np.random.default_rng(B)
    W = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    p = tpk.to_serving_layout(tpk.pack_mx(W, 8, fmt, B, axis=0,
                                          transport=transport))
    native = tpk.to_serving_layout(tpk.pack_mx(W, 8, fmt, B, axis=0))
    F = dm._FIELDS[transport]
    bits = 8 // F
    packed = p.codes.to(torch.int32) & 0xFF                 # (NB, B/F, N)
    for j in range(B):
        field = (packed[:, j // F] >> (bits * (j % F))) & ((1 << bits) - 1)
        signed = field - ((field >> (bits - 1)) << bits)
        assert torch.equal(signed.to(torch.int8),
                           native.codes[:, krow(j, B, F)])


# ---------------------------------------------------------------------------
# a CPU model of the kernels' arithmetic
# ---------------------------------------------------------------------------
def _exp2(e):
    return torch.exp2(torch.clamp(e, -126, 127).to(torch.float32))


def fold_range(decode, mw):
    """gemv_any.cu's fold_range: the unclamped scale exponents e for which
    every decoded value times 2^e is a normal bf16 (None: no folding)."""
    if decode in ("bf16", "fp16"):
        return None
    if decode == "emi8":
        sh = 8 - mw
        return -126, 127 - (6 - sh + (1 << sh))
    return {"native": (-126, 120), "sb4": (-126, 124), "sb2": (-126, 126),
            "fp8_e4m3": (-117, 119), "fp8_e5m2": (-110, 112)}[decode]


def any_model(x, w, M, s8=False, nbps=None):
    """gemv_any.cu's arithmetic in float32 (s8: exact int block sums),
    for each 32-column warp apart: for each split of whole blocks, x staged
    in position order, the stages of S positions, their 16-position steps,
    and per step one slice a block it touches (the block's positions of
    the step), summed into the block's accumulator; where the block ends,
    times its 2^(se - fold) (exp2_i32's clamp) into the split's f32 sum,
    read from the stage's exponent rows; the splits added in order. A
    folded step (bf16 x, blocks dividing 8, a full step whose every scale
    in the warp lies in ``fold_range``) adds x times the weights already
    scaled (exact) to the sum instead. ``nbps`` overrides the plan's
    blocks a split (the arithmetic of any split)."""
    decode, fold, mw, _ = dm.sad_decode_params(w)
    NB, _, N = w.codes.shape
    B = w.block_size
    K = x.shape[1]
    F = dm._FIELDS.get(decode, 1)
    plan = dm.any_plan(decode, N, K, B, M, 1 if s8 else 2)
    S, E = plan["stage_positions"], plan["exp_rows"]
    nbps = nbps or plan["split_blocks"]
    ksplit = -(-NB // nbps)
    frange = None if s8 else fold_range(decode, mw)
    fold_any = (frange is not None and B <= 8 and 8 % B == 0 and fold >= 0
                and frange[0] + fold <= 0 and frange[1] + fold >= -1)
    # the unscaled decoded weights (the code's value: scale 2^0), (NB*B, N)
    unit = dataclasses.replace(w, scale_exp=torch.full_like(w.scale_exp,
                                                            fold))
    codes = tpk.dequantize_mx(unit, dtype=torch.bfloat16).float()
    codes = torch.nn.functional.pad(codes, (0, 0, 0, NB * B - codes.shape[0]))
    if s8:
        xq, xscale = dm.quantize_activations_int8(x)
        xk = xq.to(torch.float64)
        codes = codes.to(torch.float64)
    else:
        xk = x.to(torch.bfloat16).to(torch.float32)
    xk = torch.nn.functional.pad(xk, (0, NB * B - K))
    se = w.scale_exp.to(torch.int32) - fold              # unclamped e
    perm = torch.tensor([krow(j, B, F) for j in range(B)])
    out = torch.zeros((M, N), dtype=torch.float32)
    for c0 in range(0, N, 32):
        cols = slice(c0, min(N, c0 + 32))
        for sp in range(ksplit):
            nb_begin, nb_end = sp * nbps, min(NB, (sp + 1) * nbps)
            length = (nb_end - nb_begin) * B
            # positions of the split -> K rows
            rows = torch.cat([bl * B + perm
                              for bl in range(nb_begin, nb_end)])
            xs, ws = xk[:, rows], codes[rows][:, cols]
            part = torch.zeros((M, ws.shape[1]), dtype=torch.float32)
            acc = torch.zeros((M, ws.shape[1]), dtype=xs.dtype)
            blk, end = nb_begin, B
            for q in range(0, length, S):
                e0 = blk
                for k in range(q, min(q + S, length), 16):
                    if fold_any and length - k >= 16:
                        es = se[blk:blk + 16 // B, cols]
                        if bool(((es >= frange[0])
                                 & (es <= frange[1])).all()):
                            sc = torch.exp2(es.to(torch.float32))
                            wsc = ws[k:k + 16] * sc.repeat_interleave(B, 0)
                            part += xs[:, k:k + 16] @ wsc
                            blk += 16 // B
                            end += 16
                            continue
                    lo = 0
                    while True:
                        hi = min(16, end - k)
                        sl = slice(k + lo, k + hi)
                        acc = acc + xs[:, sl] @ ws[sl]
                        if end - k > 16:
                            break
                        assert blk - e0 < E
                        part += (acc.to(torch.float32)
                                 * _exp2(se[blk, cols])[None, :])
                        acc = torch.zeros_like(acc)
                        blk += 1
                        end += B
                        if hi == 16 or blk == nb_end:
                            break
                        lo = hi
            assert blk == nb_end
            out[:, cols] += part
    return out * xscale if s8 else out


def _weights(K, N, fmt, seed):
    rng = np.random.default_rng(seed)
    if fmt == "bfloat16":          # block exponents above the 2^-126 floor
        return (rng.standard_normal((K, N)) * 8.0).astype(np.float32)
    return (rng.standard_normal((K, N))
            * np.exp(rng.uniform(-2, 2, (1, N)))).astype(np.float32)


def _pair(fmt, transport, B, K, N, seed, serving=True):
    W = _weights(K, N, fmt, seed)
    j = jpk.pack_mx(jnp.asarray(W), 8, fmt, B, axis=0, transport=transport)
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt, B,
                                          axis=0, transport=transport))
    return (jpk.to_serving_layout(j) if serving else j), t


def _close(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _cases(blocks):
    return [(fmt, tr, B) for fmt, tr in ANY_CASES for B in blocks
            if B % dm._FIELDS.get(tr, 1) == 0]


@pytest.mark.parametrize("fmt,transport,B", _cases((2, 4, 8)))
@pytest.mark.parametrize("M", [1, 9])
def test_any_model_matches_the_jax_kernel(fmt, transport, B, M):
    """At the blocks the JAX kernel takes (K = 160, so some splits end
    inside a step), at the plan's split and at one split of every block
    (stages of S positions, blocks straddling them)."""
    K, N = 160, 96
    j, t = _pair(fmt, transport, B, K, N, seed=B + M)
    decode = dm.sad_decode_params(t)[0]
    assert dm.gemv_route(decode, B) == "any"
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    want = j_sad(jnp.asarray(x), j, interpret=True)
    _close(any_model(torch.from_numpy(x), t, M), want)
    _close(any_model(torch.from_numpy(x), t, M, nbps=K // B), want)


@pytest.mark.parametrize("fmt,transport,B", _cases((6, 12, 20, 24)))
def test_any_model_matches_the_jax_reference(fmt, transport, B):
    """At blocks whose K tile the JAX kernel cannot cut: against
    dequant_matmul_reference (the same bf16 dot, f32 sums), with a K no
    multiple of the block. The reference does not clamp the scale, so no
    block exponent may meet the clamp: the bf16 container's last block of
    3 rows would (its amax is below 2), and it takes whole blocks."""
    M, N = 9, 96
    K = 6 * B if fmt == "bfloat16" else 5 * B + 3
    j, t = _pair(fmt, transport, B, K, N, seed=B, serving=False)
    fold = dm.sad_decode_params(t)[1]
    assert int(t.scale_exp.min()) - fold >= -126
    x = np.random.default_rng(B).standard_normal((M, K)).astype(np.float32)
    want = j_ref(jnp.asarray(x), j)
    _close(any_model(torch.from_numpy(x), t, M), want)
    _close(any_model(torch.from_numpy(x), t, M, nbps=-(-K // B)), want)


@pytest.mark.parametrize("fmt,transport,B", [
    ("int8", "native", 2), ("int8", "native", 4), ("int8", "native", 8),
    ("int4", "sb4", 2), ("int4", "sb4", 4), ("int4", "sb4", 8),
    ("int2", "sb2", 4), ("int2", "sb2", 8)])
@pytest.mark.parametrize("M", [1, 8])
def test_s8_model_matches_the_jax_kernel(fmt, transport, B, M):
    """The W8A8 model (exact int block sums) against JAX's
    dequant_matmul_sad_s8 in interpret mode, at the blocks that the card
    refused before this kernel."""
    K, N = 256, 96
    rng = np.random.default_rng(B + M)
    W = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    j = jpk.pack_mx(jnp.asarray(W), 8, fmt, B, axis=0, transport=transport)
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt, B,
                                          axis=0, transport=transport))
    assert dm.s8_route(transport, B) == "any"
    x = rng.standard_normal((M, K)).astype(np.float32)
    want = j_sad_s8(jnp.asarray(x), j, interpret=True)
    _close(any_model(torch.from_numpy(x), t, M, s8=True), want)
    _close(any_model(torch.from_numpy(x), t, M, s8=True, nbps=K // B), want)
