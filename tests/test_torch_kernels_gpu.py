"""The port's CUDA kernels against their plain twin, on a CUDA card.

Every test is marked ``gpu`` and skips, from inside the test, where no card
is present (the kernels have no CPU mode). This module imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch and the
CUDA toolkit:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Tolerances (relative to max |twin|): GEMV 1e-5 (exact float32 products,
only the summation order differs), GEMM 2e-3 (bf16 MMA with float32
accumulation), the bounds of tests/test_pallas_kernels.py; quantized-KV
attention 2e-2, the bound of tests/test_quant_attention.py:47 (float32 sums
in another order, split across blocks and merged); the outlier GEMVs (NB
and side-band) 1e-5: their weights and products are exact in float32 and
only the order of the sums differs; the outlier GEMMs 2e-3, as the emi8
GEMM (the same bf16 weights through bf16 MMA with float32 accumulation);
the prefill-GEMM experiments 2e-3 against the f32 plain output (2^-8 with
a bf16 output, its rounding), at a small shape and at the scripts' own
(gate_up, M = 1024); the decode-GEMV experiments 1e-5 (GEMVs: exact
products, f32 sums in another order), each against its own plain version,
the decode variants i16, ebf8 and f32dot bit-equal to i32; the side-band
GEMV (a persistent TMA stream whose slots are added as corrections) 1e-5;
the bf16-container GEMM's B tile gemm_tile's bit for bit; a dense decode
replayed from a CUDA graph bit-identical to the eager one, and a decode
over the quantized cache replayed from its plain and fold graphs likewise;
the tensor-core GEMVs (every decode of the dequant GEMV, the NB GEMV) 1e-5,
at the scale clamps against the clamped scales in float64.
"""

import dataclasses

import numpy as np
import pytest
import torch

from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops import outlier as tol
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
from microscopiq_tpu_torch.ops.cuda import exp_gemv as eg
from microscopiq_tpu_torch.ops.cuda import exp_prefill as ep
from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om
from microscopiq_tpu_torch.ops.cuda import quant_attention as qa
from microscopiq_tpu_torch.scripts import (_gemv, _prefill,
                                           exp_decode_variants,
                                           exp_nb_variants,
                                           exp_prefill_floor,
                                           exp_prefill_overlap,
                                           exp_prefill_pipe,
                                           exp_prefill_tiles2, exp_sad_tiles)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(K, N, seed, device):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-2, 2, (1, N)))).astype(np.float32)
    return tpk.to_serving_layout(tpk.pack_mx(
        torch.from_numpy(W).to(device), 8, "fp6_e3m2", 32, axis=0,
        transport="emi8"))


def _x(M, K, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                            ).to(device)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("K,N,M", [(256, 384, 1), (256, 384, 3),
                                   (256, 384, 8), (256, 384, 64),
                                   (200, 130, 3), (256, 384, 128),
                                   (256, 384, 513), (200, 130, 200)])
def test_kernel_matches_twin(cuda, K, N, M):
    w = _packed(K, N, M, cuda)
    x = _x(M, K, M, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_matmul(x, w)
    want = dm.dequant_matmul_reference(x, w)
    torch.cuda.synchronize()
    name = "dequant_gemv_emi8" if M <= 64 else "dequant_matmul_emi8"
    assert dm.launch_counts[name] == 1
    assert got.shape == (M, N)
    assert _rel(got, want) < (1e-5 if M <= 64 else 2e-3)


@pytest.mark.parametrize("M", [8, 256])
def test_kernel_bf16_output(cuda, M):
    w = _packed(512, 256, 7, cuda)
    x = _x(M, 512, 8, cuda).to(torch.bfloat16)
    got = dm.dequant_matmul(x, w, out_dtype=torch.bfloat16)
    want = dm.dequant_matmul_reference(x, w, out_dtype=torch.float32)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) < 2 ** -8


def test_gemv_rows_do_not_depend_on_batch(cuda):
    w = _packed(4096, 1024, 1, cuda)
    x = _x(64, 4096, 2, cuda)
    full = dm.dequant_gemv(x, w)
    for M in (1, 5, 8, 33):
        assert torch.equal(dm.dequant_gemv(x[:M], w), full[:M])


def test_gemm_rows_do_not_depend_on_batch(cuda):
    w = _packed(512, 384, 3, cuda)
    x = _x(300, 512, 4, cuda)
    full = dm.dequant_gemm(x, w)
    assert torch.equal(dm.dequant_gemm(x[:130], w), full[:130])


def test_exponent_floor_edge_matches_tpu_kernel_semantics(cuda):
    """Where se - fold < -126 the kernels clamp the scale to 2^-126, as the
    TPU kernel's _exp2_i32 does (tests/test_torch_dequant_matmul.py shows
    that JAX's kernel is 32x its twin there); the twin is exact."""
    rng = np.random.default_rng(11)
    W = rng.standard_normal((64, 8)).astype(np.float32)
    W[:32, 3] = np.float32(2.0 ** -125) * (1 + np.arange(32) % 5)
    w = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W).to(cuda), 8,
                                          "fp6_e3m2", 32, axis=0,
                                          transport="emi8"))
    assert int(w.scale_exp[0, 3]) == -127
    x = torch.zeros((2, 64), device=cuda)
    x[:, :32] = 1.0
    got = dm.dequant_gemv(x, w)
    twin = dm.dequant_matmul_reference(x, w)
    clamped = twin.clone()
    clamped[:, 3] *= 32
    assert _rel(got, clamped) < 1e-5
    gemm = dm.dequant_gemm(x.repeat(40, 1), w)
    assert _rel(gemm[:2], clamped) < 2e-3


def test_wrappers_check_operands(cuda):
    w = _packed(256, 128, 0, cuda)
    with pytest.raises(ValueError, match="K="):
        dm.dequant_gemv(_x(2, 128, 0, cuda), w)
    cpu_w = dataclasses.replace(w, codes=w.codes.cpu(),
                                scale_exp=w.scale_exp.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        dm.dequant_gemm(_x(100, 256, 0, cuda), cpu_w)
    # float8 containers: the GEMV and the GEMM decode them (fp6 and fp4
    # codes packed "native" sit in float8_e4m3fn)
    for fmt, decode in (("fp6_e3m2", "fp8_e4m3"), ("fp8_e4m3", "fp8_e4m3"),
                        ("fp8_e5m2", "fp8_e5m2")):
        f8 = tpk.to_serving_layout(tpk.pack_mx(
            torch.randn(256, 128, device=cuda), 8, fmt, 32, axis=0))
        for M, kind in ((4, "gemv"), (100, "matmul")):
            dm.reset_launch_counts()
            x = _x(M, 256, 0, cuda)
            got = dm.dequant_matmul(x, f8)
            assert dm.launch_counts[f"dequant_{kind}_{decode}"] == 1
            assert _rel(got, dm.dequant_matmul_reference(x, f8)) < (
                1e-5 if kind == "gemv" else 2e-3)
    sb4 = tpk.to_serving_layout(tpk.pack_mx(
        torch.randn(256, 128, device=cuda), 8, "int4", 32, axis=0,
        transport="sb4"))
    with pytest.raises(ValueError, match="do not match"):
        dm.dequant_gemv(_x(4, 256, 0, cuda), dataclasses.replace(
            sb4, transport="sb2"))
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.empty(sb4.codes.numel() + 1, dtype=torch.int8,
                              device=cuda)[1:].view(sb4.codes.shape)
        dm.dequant_gemv(_x(4, 256, 0, cuda), dataclasses.replace(
            sb4, codes=shifted))


# ---------------------------------------------------------------------------
# every other transport of the GEMV and GEMM, the W8A8 GEMV, the quantizer
# ---------------------------------------------------------------------------
# (format, transport, block, weight scale): every decode of _sad_kernel; the
# bfloat16 weights are N(0, 64) so that no block exponent clamps at -127
TRANSPORTS = [("int4", "sb4", 32, 1.0), ("int2", "sb2", 16, 1.0),
              ("int8", "native", 32, 1.0), ("int2", "native", 32, 1.0),
              ("fp4_e2m1", "pf4", 32, 1.0), ("fp6_e3m2", "pf6", 32, 1.0),
              ("fp6_e2m3", "pf6", 32, 1.0), ("bfloat16", "native", 32, 8.0),
              ("fp16", "native", 16, 1.0), ("fp6_e3m2", "emi8", 16, 1.0),
              # the float8 containers
              ("fp8_e4m3", "native", 32, 1.0), ("fp8_e5m2", "native", 32, 1.0),
              ("fp6_e3m2", "native", 32, 1.0), ("fp4_e2m1", "native", 16, 1.0)]


def _packed_as(K, N, fmt, transport, bs, scale, seed, device, serving=True):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((K, N)) * scale
         * np.exp(rng.uniform(-2, 2, (1, N)) * (scale == 1.0))
         ).astype(np.float32)
    p = tpk.pack_mx(torch.from_numpy(W).to(device), 8, fmt, bs, axis=0,
                    transport=transport)
    return tpk.to_serving_layout(p) if serving else p


@pytest.mark.parametrize("fmt,transport,bs,scale", TRANSPORTS)
@pytest.mark.parametrize("K,N,M", [(256, 384, 1), (256, 384, 8),
                                   (200, 130, 3), (4096, 1040, 64),
                                   (256, 384, 65), (200, 130, 300),
                                   (4096, 1040, 256)])
def test_every_transport_matches_twin(cuda, fmt, transport, bs, scale, K, N,
                                      M):
    w = _packed_as(K, N, fmt, transport, bs, scale, M, cuda)
    x = _x(M, K, M + 1, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_matmul(x, w)
    want = dm.dequant_matmul_reference(x, w)
    torch.cuda.synchronize()
    decode = dm.sad_decode_params(w)[0]
    kind = "gemv" if M <= 64 else "matmul"
    assert dm.launch_counts[f"dequant_{kind}_{decode}"] == 1
    assert sum(dm.launch_counts.values()) == 1
    assert got.shape == (M, N)
    assert _rel(got, want) < (1e-5 if M <= 64 else 2e-3)


@pytest.mark.parametrize("M", [4, 300])
def test_native2d_codes_go_to_the_kernel_by_a_view(cuda, M):
    w = _packed_as(256, 384, "int8", "native", 32, 1.0, 5, cuda,
                   serving=False)
    assert w.codes.ndim == 2
    x = _x(M, 256, 6, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_matmul(x, w)
    kind = "gemv" if M <= 64 else "matmul"
    assert dm.launch_counts[f"dequant_{kind}_native"] == 1
    assert torch.equal(got, dm.dequant_matmul(x, tpk.to_serving_layout(w)))
    assert _rel(got, dm.dequant_matmul_reference(x, w)) < (
        1e-5 if M <= 64 else 2e-3)


@pytest.mark.parametrize("fmt,decode", [("fp8_e4m3", "fp8_e4m3"),
                                        ("fp8_e5m2", "fp8_e5m2"),
                                        ("fp6_e3m2", "fp8_e4m3"),
                                        ("int8", "native")])
@pytest.mark.parametrize("M", [4, 300])
def test_native2d_float8_codes_go_to_the_kernel_by_a_view(cuda, fmt, decode,
                                                         M):
    """2-D float8 and int8 codes (the TPU kernel's native2d branch) reach
    the serving-layout kernels by a view; above 64 rows the GEMM on the
    sm90 loop (block 32), none on gemm_tile."""
    w = _packed_as(200, 130, fmt, "native", 32, 1.0, M, cuda, serving=False)
    assert w.codes.ndim == 2
    x = _x(M, 200, 7, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_matmul(x, w)
    kind = "gemv" if M <= 64 else "matmul"
    assert dm.launch_counts[f"dequant_{kind}_{decode}"] == 1
    assert sum(dm.launch_counts.values()) == 1
    assert dm.gemm_route(decode, 32) == "sm90"
    assert torch.equal(got, dm.dequant_matmul(x, tpk.to_serving_layout(w)))
    assert _rel(got, dm.dequant_matmul_reference(x, w)) < (
        1e-5 if M <= 64 else 2e-3)


@pytest.mark.parametrize("fmt,transport,bs", [("int8", "native", 32),
                                              ("int4", "sb4", 16),
                                              ("int2", "sb2", 16),
                                              ("int4", "native", 32)])
@pytest.mark.parametrize("K,N,M", [(256, 384, 1), (4096, 1040, 8),
                                   (200, 130, 3), (512, 256, 64)])
def test_w8a8_kernel_matches_twin(cuda, fmt, transport, bs, K, N, M):
    w = _packed_as(K, N, fmt, transport, bs, 1.0, K + M, cuda)
    x = _x(M, K, M, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_matmul_sad_s8(x, w)
    want = dm.dequant_matmul_sad_s8_reference(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_gemv_s8_{transport}"] == 1
    assert got.shape == (M, N)
    assert _rel(got, want) < 1e-5


def test_w8a8_rows_do_not_depend_on_batch(cuda):
    w = _packed_as(4096, 1024, "int4", "sb4", 32, 1.0, 1, cuda)
    x = _x(64, 4096, 2, cuda)
    full = dm.dequant_matmul_sad_s8(x, w)
    for M in (1, 5, 8, 33):
        assert torch.equal(dm.dequant_matmul_sad_s8(x[:M], w), full[:M])


@pytest.mark.parametrize("fmt,transport,bs", [("int8", "native", 32),
                                              ("int4", "sb4", 16),
                                              ("int2", "sb2", 16)])
@pytest.mark.parametrize("M", [1, 8, 13, 64, 100])
def test_w8a8_tc_route_at_every_m(cuda, fmt, transport, bs, M):
    """The int8 tensor-core GEMV at chip_smoke's W8A8 cases, 64 rows a
    launch, after one launch of the activation quantizer."""
    w = _packed_as(4096, 1024, fmt, transport, bs, 1.0, M, cuda)
    x = _x(M, 4096, M + 1, cuda).to(torch.bfloat16)
    assert dm.s8_route(transport, bs) == "tc"
    dm.reset_launch_counts()
    got = dm.dequant_matmul_sad_s8(x, w, torch.bfloat16)
    want = dm.dequant_matmul_sad_s8_reference(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_gemv_s8_{transport}"] == -(-M // 64)
    assert dm.launch_counts["quantize_x_int8"] == 1
    assert sum(dm.launch_counts.values()) == 1 + -(-M // 64)
    f32 = dm.dequant_matmul_sad_s8(x, w)
    assert _rel(f32, want) < 1e-5
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_w8a8_cc_route_takes_the_other_blocks(cuda):
    for fmt, transport, bs in (("int8", "native", 8), ("int4", "sb4", 8)):
        w = _packed_as(512, 384, fmt, transport, bs, 1.0, 3, cuda)
        x = _x(5, 512, 4, cuda)
        assert dm.s8_route(transport, bs) == "cc"
        dm.reset_launch_counts()
        got = dm.dequant_matmul_sad_s8(x, w)
        torch.cuda.synchronize()
        assert dm.launch_counts[f"dequant_gemv_s8_{transport}_cc"] == 1
        assert _rel(got, dm.dequant_matmul_sad_s8_reference(x, w)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_x_int8_is_bit_exact(cuda, dtype):
    """One launch, bit-equal to quantize_activations_int8 (on the card and
    on the CPU): ties at .5 round to even, an all-zero row gives zeros."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((9, 4100))
         * np.exp(rng.uniform(-3, 3, (9, 1)))).astype(np.float32)
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]     # scale 1: ties
    x[0, 6:] = np.clip(x[0, 6:], -100, 100)
    x[1] = 0.0
    x[2, :4] = [254.0, 1.0, 3.0, -5.0]                # scale 2: ties
    x[2, 4:] = np.clip(x[2, 4:], -200, 200)
    xt = torch.from_numpy(x).to(dtype).to(cuda)
    dm.reset_launch_counts()
    codes, scale = dm.quantize_x_int8(xt)
    torch.cuda.synchronize()
    assert dm.launch_counts["quantize_x_int8"] == 1
    for wc, ws in (dm.quantize_activations_int8(xt),
                   dm.quantize_activations_int8(xt.cpu())):
        assert torch.equal(codes.cpu(), wc.cpu())
        assert torch.equal(scale.cpu().view(torch.int32),
                           ws.cpu().view(torch.int32))
    assert codes[0, :6].tolist() == [127, 0, 2, 2, -2, 0]
    assert codes[2, :4].tolist() == [127, 0, 2, -2]
    assert not codes[1].any()


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1", "int8", "int4",
                                 "int2", "fp8_e4m3", "fp8_e5m2", "fp16",
                                 "bfloat16"])
@pytest.mark.parametrize("shape,bs", [((64, 512), 32), ((10, 200), 16),
                                      ((3, 5, 96), 32), ((7, 300), 64),
                                      ((4096, 1024), 32), ((33, 130), 8)])
def test_quantizer_is_bit_exact(cuda, fmt, shape, bs):
    from microscopiq_tpu_torch.ops.cuda import mx_quant as mq

    rng = np.random.default_rng(len(shape) * bs)
    x = (rng.standard_normal(shape)
         * np.exp(rng.uniform(-3, 3, shape[:-1] + (1,)))).astype(np.float32)
    x.reshape(-1)[:bs] = 0.0                      # a zero block
    x.reshape(-1)[-bs // 2:] = 1e-40              # a subnormal amax
    xt = torch.from_numpy(x).to(cuda)
    mq.reset_launch_counts()
    got = mq.quantize_mx_block(xt, 8, fmt, bs)
    want = mq.quantize_mx_reference(xt, 8, fmt, bs)
    torch.cuda.synchronize()
    assert mq.launch_counts["quantize_mx"] == 1
    raw = lambda t: t.view(torch.uint8 if t.element_size() == 1
                           else torch.int16)
    assert got.codes.dtype == want.codes.dtype
    assert torch.equal(raw(got.codes), raw(want.codes))
    assert torch.equal(got.scale_exp, want.scale_exp)


def _quant_edges(M, K, bs, fmt, seed):
    """Rows that reach the quantizer's edges: all-zero blocks, subnormal
    blocks, +-max_norm times the block scale, and (bfloat16) magnitudes
    whose shared exponents pass +-126."""
    from microscopiq_tpu_torch.formats import get_format_params

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K))
         * np.exp2(rng.integers(-20, 4, (M, 1)))).astype(np.float32)
    _, _, emax, max_norm, _ = get_format_params(fmt)
    x[0] = 0.0
    if M > 1:
        x[1] = rng.standard_normal(K).astype(np.float32) * np.float32(1e-41)
    if M > 2:
        x[2, ::3] = np.float32(max_norm * 2.0 ** -emax)
        x[2, 1::3] = -np.float32(max_norm * 2.0 ** -emax)
    if M > 3:
        x[3] = (rng.standard_normal(K) * 2.0 ** 120).astype(np.float32)
    if M > 4:
        x[4] = (rng.standard_normal(K) * 2.0 ** -130).astype(np.float32)
    return x


def _quant_check(xt, fmt, bs, scale_bits=8):
    from microscopiq_tpu_torch.ops.cuda import mx_quant as mq

    mq.reset_launch_counts()
    got = mq.quantize_mx_block(xt, scale_bits, fmt, bs)
    want = mq.quantize_mx_reference(xt.contiguous(), scale_bits, fmt, bs)
    torch.cuda.synchronize()
    assert mq.launch_counts["quantize_mx"] == 1
    raw = lambda t: t.view(torch.uint8 if t.element_size() == 1
                           else torch.int16)
    assert got.codes.shape == want.codes.shape
    assert torch.equal(raw(got.codes), raw(want.codes))
    assert torch.equal(got.scale_exp, want.scale_exp)


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1", "int8", "int4",
                                 "int2", "fp8_e5m2", "float16", "bfloat16"])
@pytest.mark.parametrize("bs", [1, 2, 16, 32, 64, 96, 256])
@pytest.mark.parametrize("K", [1021, 1022, 1023, 1024])
def test_quantizer_blocks_ragged_k_and_edges(cuda, fmt, bs, K):
    """Every block width the kernel's geometry distinguishes, K = 1, 2, 3
    and 0 (mod 4) (rows whose 16-byte loads and 4-byte stores do not line
    up take the scalar head/tail), and the edge rows of _quant_edges."""
    x = _quant_edges(37, K, bs, fmt, seed=bs * 4 + K % 4)
    _quant_check(torch.from_numpy(x).to(cuda), fmt, bs)


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "int8", "bfloat16"])
@pytest.mark.parametrize("bs", [2, 16, 32, 256])
def test_quantizer_misaligned_row_base(cuda, fmt, bs):
    """A contiguous input whose base is 4 bytes past a 16-byte boundary."""
    x = _quant_edges(9, 512, bs, fmt, seed=bs)
    flat = torch.zeros(9 * 512 + 1, device=cuda)
    flat[1:] = torch.from_numpy(x).to(cuda).reshape(-1)
    xt = flat[1:].view(9, 512)
    assert xt.data_ptr() % 16 == 4
    _quant_check(xt, fmt, bs)


def test_quantizer_bfloat16_shared_exponents_past_126(cuda):
    """bfloat16 elements at 2^-140 .. 2^126: shared exponents reach the
    int8 clamp at both ends, where the plain version's half factors and a
    single clamped 2^e differ."""
    rng = np.random.default_rng(5)
    rows = [rng.standard_normal(256) * 2.0 ** e for e in
            (-140, -133, -127, -126, -100, 0, 100, 120, 125, 126)]
    x = np.stack(rows).astype(np.float32)
    for scale_bits in (8, 6):
        _quant_check(torch.from_numpy(x).to(cuda), "bfloat16", 32,
                     scale_bits)


@pytest.mark.parametrize("mode", ["mx_prune", "mx_v1", "uniform"])
def test_gptq_fasterquant_on_card_matches_cpu(cuda, mode):
    """GPTQ on the card, its block step captured once in a CUDA graph and
    replayed (two runs bit-identical); against the CPU's run, a proxy loss
    tr((W-Q) H (W-Q)^T) within 2% and, in the MX modes, >= 95% of Q's
    entries identical (the card's Cholesky and sums differ in the last
    bits, and a flipped rounding feeds forward: on the uniform 4-bit grid
    one flip moves the rest of its row, so there the loss is the measure);
    with decisions, which rebuild Q exactly."""
    from microscopiq_tpu_torch.quant import GPTQ, MXQuantizer
    from microscopiq_tpu_torch.quant import UniformQuantizer
    from microscopiq_tpu_torch.quant import gptq as gq

    rng = np.random.default_rng(17)
    W = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    W[rng.random(W.shape) < 0.03] *= 10.0
    mix = np.eye(384) + 0.2 * rng.standard_normal((384, 384))
    X = (rng.standard_normal((4, 64, 384)) @ mix).astype(np.float32)
    collect = mode == "mx_prune"

    def proxy(Q):
        E = Q.double() - torch.from_numpy(W).double()
        Xf = torch.from_numpy(X.reshape(-1, 384)).double()
        return float(((E @ Xf.T) ** 2).sum())

    def run(dev):
        if mode == "uniform":
            qz = UniformQuantizer()
            qz.configure(4, perchannel=True, sym=False)
        else:
            qz = MXQuantizer(8, 8, "int2", "fp4_e2m1", std_dev=2.0,
                             axes=(0,), block_size=16,
                             max_outliers_per_block=2)
        g = GPTQ(torch.from_numpy(W).to(dev), mode=mode)
        g.quantizer = qz
        for xb in X:
            g.add_batch(torch.from_numpy(xb).to(dev))
        Q, _ = g.fasterquant(blocksize=128, collect_decisions=collect)
        return Q.cpu(), g.decisions

    gq.clear_graphs()
    q_cpu, _ = run("cpu")
    q_graph, dec = run(cuda)
    assert len(gq._GRAPHS) == 1          # one geometry, captured once
    q_replay, _ = run(cuda)
    gq.clear_graphs()
    assert torch.equal(q_graph, q_replay)
    same = (q_graph == q_cpu).float().mean().item()
    assert abs(proxy(q_graph) - proxy(q_cpu)) <= 0.02 * proxy(q_cpu), same
    if mode != "uniform":
        assert same >= 0.95, same
    if collect:
        rep = lambda se: se.repeat_interleave(16, dim=0)  # noqa: E731
        recon = (dec["inl_code"] * torch.exp2(rep(dec["se_in"]))
                 + dec["out_code"] * torch.exp2(rep(dec["se_out"])
                                                - rep(dec["se_in"])))
        assert torch.equal(recon.cpu(), q_graph)


def test_gptq_graphed_block_step_is_the_eager_step(cuda):
    """One block step replayed from its CUDA graph gives the eager step's
    Q, errors, losses and decisions bit for bit, on new inputs too."""
    from microscopiq_tpu_torch.quant import MXQuantizer
    from microscopiq_tpu_torch.quant import gptq as gq

    rng = np.random.default_rng(3)
    qz = MXQuantizer(8, 8, "int2", "fp4_e2m1", std_dev=2.0, axes=(0,),
                     block_size=16, max_outliers_per_block=2)
    step = gq.mx_block_step(gq.quantizer_config(qz), "mx_prune", True)
    blocks = []
    for _ in range(2):
        W = torch.from_numpy((rng.standard_normal((512, 128)) * 0.05
                              ).astype(np.float32)).to(cuda)
        A = torch.from_numpy(rng.standard_normal((128, 128)).astype(
            np.float32)).to(cuda)
        H = A @ A.T + 128 * torch.eye(128, device=cuda)
        blocks.append((W, torch.linalg.cholesky(torch.cholesky_inverse(
            torch.linalg.cholesky(H))).T.contiguous()))
    graphed = gq.GraphedStep(step, blocks[0])
    for W1, Hinv1 in blocks:
        want = step(W1, Hinv1)
        got = graphed(W1, Hinv1)
        for a, b in zip(want[:3] + tuple(want[3]), got[:3] + tuple(got[3])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# quantized-KV flash-decode attention
# ---------------------------------------------------------------------------
def qattn_operands(B, KVH, rep, hd, C, gap, bits, Gh, rank, seed, device,
                   lr_dtype=torch.bfloat16):
    """Random operands of chunk_attention in the cache's layouts."""
    g = torch.Generator().manual_seed(seed)
    rows = gap // (8 // bits)
    rn = lambda *s: torch.randn(s, generator=g)
    ru = lambda *s: torch.rand(s, generator=g)
    codes = lambda: torch.randint(0, 256, (B, KVH, C, rows, hd), generator=g,
                                  dtype=torch.uint8)
    ops = [rn(B, KVH, rep, hd).to(torch.bfloat16), codes(),
           rn(B, KVH, C, hd), 0.05 + 0.2 * ru(B, KVH, C, hd) / 2 ** bits,
           codes(), rn(B, KVH, C, gap, Gh),
           0.05 + 0.2 * ru(B, KVH, C, gap, Gh) / 2 ** bits]
    lowrank = None
    if rank:
        lowrank = tuple((0.1 * t).to(lr_dtype).to(device) for t in (
            rn(B, KVH, C, rank, hd), rn(B, C, rank, gap),
            rn(B, KVH, C, rank, hd), rn(B, C, rank, gap)))
    return [t.to(device) for t in ops], lowrank


def qattn_rel_err(got, want, live):
    """Max over o / l, m and l of |kernel - twin| relative to max |twin|,
    on slots with a folded chunk."""
    (o, m, l), (o2, m2, l2) = got, want
    out = lambda o_, l_: o_ / l_.clamp(min=1e-30)
    err = 0.0
    for a, b in ((out(o, l), out(o2, l2)), (m, m2), (l, l2)):
        a, b = a[live].double(), b[live].double()
        err = max(err, ((a - b).abs().max() / b.abs().max()).item())
    return err


QATTN_CASES = {
    "llama3_b4": dict(B=4, KVH=8, rep=4, hd=128, C=51, gap=64, bits=4,
                      Gh=1, rank=0, nfull=[49] * 4),
    "bits2": dict(B=2, KVH=2, rep=4, hd=128, C=6, gap=64, bits=2, Gh=1,
                  rank=0, nfull=[5, 6]),
    "bits8": dict(B=2, KVH=2, rep=4, hd=128, C=6, gap=64, bits=8, Gh=1,
                  rank=0, nfull=[5, 3]),
    "grouped_v": dict(B=2, KVH=2, rep=4, hd=128, C=6, gap=64, bits=4, Gh=4,
                      rank=0, nfull=[6, 2]),
    "gearl_rank2": dict(B=2, KVH=2, rep=4, hd=128, C=6, gap=64, bits=4,
                        Gh=1, rank=2, nfull=[4, 6]),
    "ragged": dict(B=4, KVH=2, rep=2, hd=64, C=9, gap=16, bits=4, Gh=2,
                   rank=0, nfull=[0, 1, 8, 0]),
    "head_dim_256": dict(B=1, KVH=1, rep=8, hd=256, C=3, gap=8, bits=2,
                         Gh=2, rank=0, nfull=[3]),
    "rep3_head_dim_96": dict(B=2, KVH=3, rep=3, hd=96, C=5, gap=32, bits=4,
                             Gh=3, rank=1, nfull=[5, 2]),
    "rep16_gap128": dict(B=1, KVH=2, rep=16, hd=64, C=3, gap=128, bits=8,
                         Gh=1, rank=8, nfull=[3]),
}


@pytest.mark.parametrize("case", sorted(QATTN_CASES))
def test_quant_attention_matches_twin(cuda, case):
    c = dict(QATTN_CASES[case])
    nfull = torch.tensor(c.pop("nfull"), dtype=torch.int32, device=cuda)
    ops, lowrank = qattn_operands(**c, seed=len(case), device=cuda)
    args = (*ops, nfull, c["hd"] ** -0.5, c["gap"], c["bits"])
    qa.reset_launch_counts()
    got = qa.chunk_attention(*args, lowrank=lowrank)
    want = qa.chunk_attention_reference(*args, lowrank=lowrank)
    torch.cuda.synchronize()
    assert qa.launch_counts["quant_attention"] == 1
    live = nfull > 0
    assert qattn_rel_err(got, want, live) < 2e-2
    o, m, l = got
    assert torch.isfinite(o).all() and torch.isfinite(l).all()
    assert not o[~live].any() and not l[~live].any()
    assert (m[~live] == qa.NEG_INF).all()


def test_quant_attention_f32_bases(cuda):
    ops, lowrank = qattn_operands(2, 2, 4, 64, 5, 32, 4, 1, 3, 9, cuda,
                                  lr_dtype=torch.float32)
    nfull = torch.tensor([5, 2], dtype=torch.int32, device=cuda)
    args = (*ops, nfull, 0.125, 32, 4)
    got = qa.chunk_attention(*args, lowrank=lowrank)
    want = qa.chunk_attention_reference(*args, lowrank=lowrank)
    assert qattn_rel_err(got, want, nfull > 0) < 2e-2


def test_quant_attention_rows_do_not_depend_on_batch(cuda):
    ops, _ = qattn_operands(6, 8, 4, 128, 17, 64, 4, 1, 0, 3, cuda)
    nfull = torch.tensor([16, 0, 3, 17, 9, 1], dtype=torch.int32,
                         device=cuda)
    full = qa.chunk_attention(*ops, nfull, 128 ** -0.5, 64, 4)
    for lo, hi in ((0, 1), (2, 5), (3, 4)):
        part = qa.chunk_attention(*[t[lo:hi] for t in ops], nfull[lo:hi],
                                  128 ** -0.5, 64, 4)
        for a, b in zip(part, full):
            assert torch.equal(a, b[lo:hi])


def test_quant_attention_empty_slots_are_finite_zeros(cuda):
    ops, lowrank = qattn_operands(3, 2, 4, 128, 4, 64, 4, 1, 2, 5, cuda)
    nfull = torch.zeros(3, dtype=torch.int32, device=cuda)
    o, m, l = qa.chunk_attention(*ops, nfull, 0.1, 64, 4, lowrank=lowrank)
    assert not o.any() and not l.any() and (m == qa.NEG_INF).all()


def test_quant_attention_wrapper_checks_operands(cuda):
    ops, _ = qattn_operands(2, 2, 4, 128, 4, 64, 4, 1, 0, 1, cuda)
    nfull = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    call = lambda o, n=nfull, **kw: qa.chunk_attention(
        *o, n, 0.1, 64, 4, **kw)
    with pytest.raises(ValueError, match="q must be bf16"):
        call([ops[0].float()] + ops[1:])
    with pytest.raises(ValueError, match="one CUDA device"):
        call(ops[:2] + [ops[2].cpu()] + ops[3:])
    with pytest.raises(ValueError, match="contiguous"):
        call(ops[:4] + [ops[4].transpose(-1, -2).contiguous()
                        .transpose(-1, -2)] + ops[5:])
    with pytest.raises(ValueError, match="nfull"):
        call(ops, nfull.long())
    with pytest.raises(ValueError, match="kq must be uint8"):
        qa.chunk_attention(*ops, nfull, 0.1, 64, 2)      # wrong bits
    with pytest.raises(ValueError, match="head_dim"):
        bad, _ = qattn_operands(2, 2, 4, 48, 4, 64, 4, 1, 0, 1, cuda)
        call(bad)
    with pytest.raises(ValueError, match="query heads per KV head"):
        bad, _ = qattn_operands(1, 1, 17, 64, 2, 64, 4, 1, 0, 1, cuda)
        call(bad, nfull[:1])
    with pytest.raises(ValueError, match="shared memory"):
        bad, _ = qattn_operands(1, 1, 1, 256, 1, 1024, 8, 1, 0, 1, cuda)
        qa.chunk_attention(*bad, nfull[:1], 0.1, 1024, 8)
    with pytest.raises(ValueError, match="exceed 8 at head_dim 256"):
        bad, _ = qattn_operands(1, 1, 9, 256, 2, 64, 4, 1, 0, 1, cuda)
        call(bad, nfull[:1])
    with pytest.raises(ValueError, match="aligned"):
        kq = torch.empty(ops[1].numel() + 1, dtype=torch.uint8,
                         device=cuda)[1:].view(ops[1].shape)
        call(ops[:1] + [kq] + ops[2:])
    with pytest.raises(ValueError, match="one K group"):
        call(ops[:2] + [ops[2][:, :, :, None].expand(-1, -1, -1, 2, -1)
                        .contiguous()] + ops[3:])



def test_quant_attention_smem_mirror_is_the_kernel_s(cuda):
    """decode_route's and the plan's shared-memory count is the kernel's
    own (quant_attention_smem_bytes) at every geometry it may be asked,
    with ring depths and scaled-q slots."""
    from microscopiq_tpu_torch.ops.cuda import build

    fn = build.load("quant_attention").quant_attention_smem_bytes
    for rep in range(1, 17):
        for hd in range(32, 257, 32):
            for gap in (8, 64, 256, 1024):
                for bits in (2, 4, 8):
                    for Gh in (1, hd // 8):
                        for stages, slots in ((1, 2), (4, 4), (4, 8)):
                            args = (rep, hd, gap, bits, Gh, stages, slots)
                            assert qa.smem_bytes(*args) == fn(*args), args


def qattn_decode_state(B, KVH, rep, hd, C, gap, bits, Gh, rank, seed, device,
                       res_dtype=torch.bfloat16, lr_dtype=torch.bfloat16):
    """A one-layer cache (leading layer axis 1) in the fused layout: random
    chunk operands as qattn_operands, a residual window of gap rows."""
    ops, lowrank = qattn_operands(B, KVH, rep, hd, C, gap, bits, Gh, rank,
                                  seed, device, lr_dtype)
    g = torch.Generator().manual_seed(seed + 1)
    res = lambda: torch.randn((B, gap, KVH, hd), generator=g).to(  # noqa
        res_dtype).to(device)
    full = tuple(t[None].contiguous() for t in ops[1:]) + (
        res()[None].contiguous(), res()[None].contiguous())
    if lowrank is not None:
        full += tuple(t[None].contiguous() for t in lowrank)
    return full


def _decode_lengths(c):
    """Live lengths of a QATTN_CASES case: its folded chunks plus a
    residual count that varies by slot (0 included)."""
    return [n * c["gap"] + (5 * i) % c["gap"]
            for i, n in enumerate(c["nfull"])]


@pytest.mark.parametrize("case", sorted(QATTN_CASES))
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
def test_quant_decode_matches_twin(cuda, case, qdtype):
    """The one-launch decode (chunks, residual window, combine) against
    quant_attention_decode_reference at 2e-2, with (B,), 0-d and int
    lengths; one launch a call."""
    c = dict(QATTN_CASES[case])
    B, KVH, rep, hd = c["B"], c["KVH"], c["rep"], c["hd"]
    full = qattn_decode_state(**{k: v for k, v in c.items() if k != "nfull"},
                              seed=len(case) + 7, device=cuda)
    q = torch.randn((B, KVH * rep, hd), generator=torch.Generator(
        ).manual_seed(3)).to(qdtype).to(cuda)
    v_group, scale = hd // c["Gh"], hd ** -0.5
    lens = _decode_lengths(c)
    for length in (torch.tensor(lens, dtype=torch.int32, device=cuda),
                   torch.tensor(lens[-1], dtype=torch.int32, device=cuda),
                   lens[-1]):
        qa.reset_launch_counts()
        got = qa.quant_attention_decode(q, full, 0, length, v_group, scale)
        want = qa.quant_attention_decode_reference(q.float(), full, 0,
                                                   length, v_group, scale)
        torch.cuda.synchronize()
        assert qa.launch_counts["quant_attention"] == 1
        assert got.dtype == qdtype and got.shape == (B, KVH * rep, hd)
        live = torch.as_tensor(length, device=cuda).reshape(-1).expand(B) > 0
        assert torch.isfinite(got).all()
        assert _rel(got[live].float(), want[live]) < 2e-2
        assert not got[~live].any()


def test_quant_decode_long_splits_prep_each_chunk(cuda):
    """With 64 KV heads a (b, g) takes 9 splits of 23 of its 200 chunks,
    more than the scaled-q slots hold, so the kernel makes each chunk's
    scaled q from its stage as it lands; it matches the twin as the short
    splits do."""
    full = qattn_decode_state(2, 64, 4, 32, 200, 64, 4, 1, 0, 13, cuda)
    plan = qa.attention_plan(200, 64, 4, 32, 64, 4, 1)
    assert plan["cps"] > qa.MAX_SLOTS and plan["slots"] == 2
    q = torch.randn((2, 256, 32), device=cuda).to(torch.bfloat16)
    length = torch.tensor([200 * 64, 123 * 64 + 17], dtype=torch.int32,
                          device=cuda)
    got = qa.quant_attention_decode(q, full, 0, length, 32, 32 ** -0.5)
    want = qa.quant_attention_decode_reference(q.float(), full, 0, length,
                                               32, 32 ** -0.5)
    assert _rel(got.float(), want) < 2e-2


def test_quant_decode_f32_window_and_bases(cuda):
    full = qattn_decode_state(2, 2, 4, 64, 5, 32, 4, 1, 3, 9, cuda,
                              res_dtype=torch.float32,
                              lr_dtype=torch.float32)
    q = torch.randn((2, 8, 64), device=cuda)
    length = torch.tensor([5 * 32, 2 * 32 + 31], dtype=torch.int32,
                          device=cuda)
    got = qa.quant_attention_decode(q, full, 0, length, 64, 0.125)
    want = qa.quant_attention_decode_reference(q, full, 0, length, 64, 0.125)
    assert _rel(got, want) < 2e-2


def test_quant_decode_rows_do_not_depend_on_batch_and_repeat(cuda):
    """A slot's row is the same in a batch of any size, and two runs give
    the same bits."""
    full = qattn_decode_state(6, 8, 4, 128, 17, 64, 4, 1, 0, 3, cuda)
    q = torch.randn((6, 32, 128), device=cuda).to(torch.bfloat16)
    length = torch.tensor([16 * 64 + 3, 0, 3 * 64, 17 * 64, 9 * 64 + 63, 40],
                          dtype=torch.int32, device=cuda)
    out = qa.quant_attention_decode(q, full, 0, length, 128, 128 ** -0.5)
    assert torch.equal(out, qa.quant_attention_decode(q, full, 0, length,
                                                      128, 128 ** -0.5))
    for lo, hi in ((0, 1), (2, 5), (3, 4)):
        part = qa.quant_attention_decode(
            q[lo:hi], tuple(t[:, lo:hi].contiguous() for t in full), 0,
            length[lo:hi], 128, 128 ** -0.5)
        assert torch.equal(part, out[lo:hi])
    assert not out[1].any()                        # length 0: zeros


def test_quant_decode_empty_slots_are_finite_zeros(cuda):
    full = qattn_decode_state(3, 2, 4, 128, 4, 64, 4, 1, 2, 5, cuda)
    q = torch.randn((3, 8, 128), device=cuda)
    out = qa.quant_attention_decode(q, full, 0, torch.zeros(
        3, dtype=torch.int32, device=cuda), 128, 0.1)
    assert torch.isfinite(out).all() and not out.any()


def test_quant_decode_graph_replays_bit_identical(cuda):
    """Captured in a CUDA graph (a device length advanced in place between
    replays, as the decode step's cache does) and replayed twice, the
    one-launch decode gives eager's bits."""
    full = qattn_decode_state(4, 8, 4, 128, 51, 64, 4, 1, 0, 11, cuda)
    q = torch.randn((4, 32, 128), device=cuda).to(torch.bfloat16)
    length = torch.tensor(3136, dtype=torch.int32, device=cuda)
    call = lambda: qa.quant_attention_decode(  # noqa: E731
        q, full, 0, length, 128, 128 ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for step in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, call())
        length.add_(1)


def _tiny_tree(cfg, seed, device):
    """Unfused float32 weights, kernels N(0, 1/K) so that greedy logits
    are well apart."""
    g = torch.Generator(device=device).manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    k = lambda K, N: {"kernel": torch.randn(  # noqa: E731
        (K, N), generator=g, device=device) / K ** 0.5}
    one = lambda: {"scale": torch.ones(D, device=device)}   # noqa: E731
    m = {"embed_tokens": torch.randn((V, D), generator=g, device=device)}
    for i in range(cfg.num_hidden_layers):
        m[f"layers_{i}"] = {
            "self_attn": {"q_proj": k(D, H * hd), "k_proj": k(D, KVH * hd),
                          "v_proj": k(D, KVH * hd), "o_proj": k(H * hd, D)},
            "mlp": {"gate_proj": k(D, I), "up_proj": k(D, I),
                    "down_proj": k(I, D)},
            "input_layernorm": one(), "post_attention_layernorm": one()}
    m["norm"] = one()
    return {"model": m, "lm_head": k(D, V)}


@pytest.mark.parametrize("hidden", [64, 128])
def test_tiny_quant_cache_decodes_on_its_route(cuda, hidden):
    """LlamaConfig.tiny (head_dim 16), whose geometry the kernel does not
    take, decodes over the quantized cache through cache.update; at
    hidden 128 (head_dim 32) through the fused kernel, captured in the
    plain and the fold step's graphs. The greedy tokens equal
    use_kernels=False's."""
    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=hidden, dtype=torch.float32)
    qcfg = QuantKVConfig(bits=4, gap=8, v_group=8)
    route = qa.decode_route(cfg.head_dim, 2, qcfg.gap, qcfg.bits,
                            qcfg.v_group, qcfg.rank)
    assert route == {64: "update", 128: "fused"}[hidden]
    tree = _tiny_tree(cfg, 3, cuda)
    prompts = np.random.default_rng(62).integers(0, 256, (3, 10))
    qa.reset_launch_counts()
    got = generate(LlamaForCausalLM(cfg, device="cuda").load_params(tree),
                   prompts, 24, cache_kind="quant", quant_cfg=qcfg)
    # on the fused route one launch a layer at each eager step (the first
    # plain and the first fold step) and at each capture (the plain and
    # the fold graph); the 19 other steps replay the graphs
    assert qa.launch_counts["quant_attention"] == (
        2 * 4 if route == "fused" else 0)
    want = generate(LlamaForCausalLM(cfg, use_kernels=False,
                                     device="cuda").load_params(tree),
                    prompts, 24, cache_kind="quant", quant_cfg=qcfg)
    assert got.shape == (3, 24)
    np.testing.assert_array_equal(got, want)

# ---------------------------------------------------------------------------
# outlier formats: compact NB, side-band, emi8m through the GEMV and GEMM
# ---------------------------------------------------------------------------
def _outlier_weight(K, N, seed, device):
    """N(0, 0.02) weights with 3% of the elements scaled by 10."""
    g = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn((K, N), generator=g, device=device) * 0.02
    hit = torch.rand((K, N), generator=g, device=device) < 0.03
    return torch.where(hit, W * 10, W)


def _nb(K, N, budget, seed, device):
    """The compact transport from the port's own RTN decisions on the
    (N, K) transpose, outliers capped at ``budget`` per block; for large
    weights in chunks of whole N-blocks (the same decisions, bounded
    temporaries), as chip_smoke.nb_decisions."""
    W = _outlier_weight(K, N, seed, device)
    step = N if N * K <= 1 << 26 else max(16, (1 << 25) // K // 16 * 16)
    parts = []
    for i in range(0, N, step):
        _, _, d = tol.quantize_mx_outlier_hessian_decisions(
            W.T[i:i + step].contiguous(), 8, 8, "int2", "fp4_e2m1", "max",
            2.0, [0], 16, max_outliers_per_block=budget)
        parts.append(d)
    dec = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    dec["block_size"] = 16
    return tpk.pack_outlier_nb(dec, budget=budget)


def _sideband(K, N, budget, seed, device, ifmt="int2", ofmt="fp4_e2m1",
              block=16):
    return tpk.pack_mx_outlier(_outlier_weight(K, N, seed, device), 8, 8,
                               ifmt, ofmt, std_dev=2.0, block_size=block,
                               outlier_budget=budget, axis=0)


def _outlier_kernel(M, fmt):
    """(launch-count name, tolerance) of the kernel that M rows reach."""
    if M < om.GEMM_FROM_M:
        return f"dequant_gemv_{fmt}", 1e-5
    return f"dequant_gemm_{fmt}", 2e-3


@pytest.mark.parametrize("K,N,M,budget", [
    (256, 384, 1, 2), (256, 384, 3, 2), (256, 384, 8, 1), (256, 384, 64, 2),
    (200, 40, 3, 2), (202, 48, 5, 2), (256, 384, 200, 2),
    (4096, 1024, 8, 2), (256, 384, 256, 2), (200, 40, 300, 2),
    (202, 48, 513, 1), (4096, 1024, 300, 2)])
def test_nb_kernel_matches_twin(cuda, K, N, M, budget):
    w = _nb(K, N, budget, M, cuda)
    x = _x(M, K, M, cuda)
    om.reset_launch_counts()
    got = om.dequant_matmul_nb(x, w)
    want = om.dequant_matmul_nb_reference(x, w)
    torch.cuda.synchronize()
    name, tol = _outlier_kernel(M, "nb")
    assert om.launch_counts[name] == 1
    assert sum(om.launch_counts.values()) == 1
    assert got.shape == (M, N)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("K,N,M,budget,ifmt,ofmt", [
    (256, 384, 1, 4, "int2", "fp4_e2m1"), (256, 384, 3, 2, "int2", "fp4_e2m1"),
    (256, 384, 64, 1, "int2", "fp4_e2m1"),
    (256, 130, 200, 4, "int2", "fp4_e2m1"),
    (200, 384, 8, 4, "fp6_e3m2", "fp8_e4m3"),
    (4096, 1024, 8, 4, "int2", "fp4_e2m1"),
    (256, 130, 300, 4, "int2", "fp4_e2m1"),
    (200, 384, 256, 4, "fp6_e3m2", "fp8_e4m3"),
    (4096, 1024, 513, 2, "int2", "fp4_e2m1")])
def test_sideband_kernel_matches_twin(cuda, K, N, M, budget, ifmt, ofmt):
    w = _sideband(K, N, budget, M, cuda, ifmt, ofmt)
    x = _x(M, K, M, cuda)
    om.reset_launch_counts()
    got = om.dequant_matmul_outlier(x, w)
    want = om.dequant_matmul_outlier_reference(x, w)
    torch.cuda.synchronize()
    name, tol = _outlier_kernel(M, "outlier")
    assert om.launch_counts[name] == 1
    assert sum(om.launch_counts.values()) == 1
    assert got.shape == (M, N)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("M", [8, 300])
def test_outlier_kernels_bf16_output(cuda, M):
    x = _x(M, 512, 8, cuda).to(torch.bfloat16)
    for fn, ref, w in ((om.dequant_matmul_nb, om.dequant_matmul_nb_reference,
                        _nb(512, 256, 2, 1, cuda)),
                       (om.dequant_matmul_outlier,
                        om.dequant_matmul_outlier_reference,
                        _sideband(512, 256, 4, 1, cuda))):
        got = fn(x, w, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert _rel(got.float(), ref(x, w)) < 2 ** -8


def test_outlier_kernels_rows_do_not_depend_on_batch(cuda):
    x = _x(400, 4096, 5, cuda)
    for gemv, gemm, w in ((om.dequant_gemv_nb, om.dequant_gemm_nb,
                           _nb(4096, 1024, 2, 2, cuda)),
                          (om.dequant_gemv_outlier, om.dequant_gemm_outlier,
                           _sideband(4096, 1024, 4, 2, cuda)),
                          (om.dequant_gemv_outlier, om.dequant_gemm_outlier,
                           _sideband(4096, 1040, 8, 3, cuda, "fp6_e3m2",
                                     "fp8_e4m3", block=32))):
        full = gemv(x[:255], w)
        for lo, hi in ((0, 1), (3, 8), (8, 72), (1, 130), (0, 7), (5, 6),
                       (100, 255), (0, 255)):
            assert torch.equal(gemv(x[lo:hi], w), full[lo:hi])
        full = gemm(x, w)
        for lo, hi in ((0, 1), (3, 130), (128, 400)):
            assert torch.equal(gemm(x[lo:hi], w), full[lo:hi])


def _no_fold_dense(w):
    """The dense (K, N) weight of the TPU side-band kernel: the outlier
    code scaled by 2^(seo - se) with no fold, rounded to bf16 (see
    tests/test_torch_outlier_matmul.py::
    test_int_outlier_format_kernel_does_not_fold_the_code)."""
    inl = w.inlier
    B = inl.block_size
    fold = om._scale_fold(inl.elem_format)
    se = inl.scale_exp.float().repeat_interleave(B, 0)
    seo = w.out_scale_exp.float().repeat_interleave(B, 0)
    dense = inl.codes.float() * torch.exp2(se - fold)
    rows = torch.arange(dense.shape[0], device=dense.device)[:, None] % B
    for s in range(w.budget):
        hit = rows == w.out_pos[..., s].repeat_interleave(B, 0)
        oc = w.out_codes[..., s].float().repeat_interleave(B, 0)
        dense = dense + torch.where(hit, oc, 0.0) * torch.exp2(seo - se)
    return dense.to(torch.bfloat16)


def test_int_outlier_format_follows_the_tpu_kernel(cuda):
    """int8 outliers: the kernel follows the TPU kernel (no fold on the
    outlier code, ROADMAP queue 3), so it matches the no-fold weight and
    not the twin."""
    w = _sideband(256, 128, 4, 21, cuda, "int2", "int8")
    for M in (4, 300):
        x = _x(M, 256, 22, cuda)
        got = om.dequant_matmul_outlier(x, w)
        want = x.to(torch.bfloat16).float() @ _no_fold_dense(w).float()
        assert _rel(got, want) < _outlier_kernel(M, "outlier")[1]
        assert _rel(got, om.dequant_matmul_outlier_reference(x, w)) > 0.5


# the side-band GEMV: (inlier format, outlier format) of its int8 and
# float8 code containers
GEMV_CODES = {"int": ("int2", "fp4_e2m1"), "fp8": ("fp6_e3m2", "fp8_e4m3")}


@pytest.mark.parametrize("codes", sorted(GEMV_CODES))
@pytest.mark.parametrize("budget", [1, 2, 4, 8])
@pytest.mark.parametrize("block", [8, 16, 32, 48, 64])
def test_sideband_gemv_matches_twin(cuda, block, budget, codes):
    """The GEMV against the twin within 1e-5 of max |twin| at M = 1, 7, 8,
    64 and 255, at N = 1040 (TMA copies; a last tile of 16 columns) and
    N = 200 (no multiple of 16: plain copies), K = 520 (ragged in the last
    block); one launch a call, on the plan of outlier_gemv_plan."""
    ifmt, ofmt = GEMV_CODES[codes]
    for N in (1040, 200):
        w = _sideband(520, N, budget, block + budget, cuda, ifmt, ofmt,
                      block=block)
        assert w.inlier.codes.dtype == (torch.int8 if codes == "int"
                                        else torch.float8_e4m3fn)
        for M in (1, 7, 8, 64, 255):
            x = _x(M, 520, M, cuda)
            om.reset_launch_counts()
            got = om.dequant_matmul_outlier(x, w)
            want = om.dequant_matmul_outlier_reference(x, w)
            torch.cuda.synchronize()
            assert om.launch_counts["dequant_gemv_outlier"] == 1
            assert sum(om.launch_counts.values()) == 1
            assert got.shape == (M, N)
            assert _rel(got, want) < 1e-5, (N, M)


@pytest.mark.parametrize("codes", sorted(GEMV_CODES))
def test_sideband_gemv_rows_named_twice(cuda, codes):
    """Slots naming a row another slot of the column names (the packers
    make distinct positions; the format allows repeats): the row's weight
    is the inlier and both slots in slot order, rounded once, as the twin
    adds them, M = 1, 8 and 64."""
    ifmt, ofmt = GEMV_CODES[codes]
    w = _sideband(512, 384, 4, 9, cuda, ifmt, ofmt)
    pos = w.out_pos.clone()
    pos[..., 1] = torch.where(pos[..., 0] >= 0, pos[..., 0], pos[..., 1])
    pos[..., 3] = torch.where(pos[..., 2] >= 0, pos[..., 2], pos[..., 3])
    w = dataclasses.replace(w, out_pos=pos.contiguous())
    for M in (1, 8, 64):
        x = _x(M, 512, M, cuda)
        got = om.dequant_gemv_outlier(x, w)
        want = om.dequant_matmul_outlier_reference(x, w)
        torch.cuda.synchronize()
        assert _rel(got, want) < 1e-5, M


@pytest.mark.parametrize("lin", ["down", "gate_up", "lm_head", "o", "qkv"])
def test_sideband_gemv_at_llama_shapes(cuda, lin):
    """Block 16, 4 slots (the side-band arm's weight) at M = 8 and 1 at
    every Llama-3-8B shape; one CTA an SM (the occupancy the plan
    assumes)."""
    K, N = LLAMA3_8B[lin]
    w = _sideband(K, N, 4, 5, cuda)
    for M in (8, 1):
        x = _x(M, K, 6, cuda)
        got = om.dequant_gemv_outlier(x, w)
        want = om.dequant_matmul_outlier_reference(x, w)
        torch.cuda.synchronize()
        assert _rel(got, want) < 1e-5
        plan = om.outlier_gemv_plan(N, K, 16, 4, M)
        assert om.outlier_gemv_occupancy(M, False, plan["smem_bytes"]) == 1


@pytest.mark.parametrize("M", [1, 8, 64, 128, 300])
def test_emi8m_block16_through_gemv_and_gemm(cuda, M):
    """The merged-outlier stream at block 16 with its own (mw, fold)."""
    m = tpk.to_serving_layout(tpk.merge_outlier_emi8(
        _sideband(512, 384, 4, M, cuda)))
    assert m.transport == "emi8m" and m.block_size == 16
    x = _x(M, 512, M, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_matmul(x, m)
    want = dm.dequant_matmul_reference(x, m)
    torch.cuda.synchronize()
    name = "dequant_gemv_emi8" if M <= 64 else "dequant_matmul_emi8"
    assert dm.launch_counts[name] == 1
    assert _rel(got, want) < (1e-5 if M <= 64 else 2e-3)


def test_outlier_wrappers_check_operands(cuda):
    w = _nb(256, 128, 2, 0, cuda)
    with pytest.raises(ValueError, match="K="):
        om.dequant_matmul_nb(_x(2, 128, 0, cuda), w)
    cpu_w = dataclasses.replace(w, codes=w.codes.cpu())
    with pytest.raises(ValueError, match="one device"):
        om.dequant_matmul_nb(_x(2, 256, 0, cuda), cpu_w)
    s = _sideband(256, 128, 4, 0, cuda)
    cpu_s = dataclasses.replace(s, out_pos=s.out_pos.cpu())
    with pytest.raises(ValueError, match="one device"):
        om.dequant_matmul_outlier(_x(2, 256, 0, cuda), cpu_s)
    big = _sideband(64, 32, 9, 0, cuda)
    for M in (2, 300):
        with pytest.raises(ValueError, match="budget 9"):
            om.dequant_matmul_outlier(_x(M, 64, 0, cuda), big)
        with pytest.raises(ValueError, match="one device"):
            om.dequant_matmul_nb(_x(M, 256, 0, cuda), cpu_w)


# ---------------------------------------------------------------------------
# prefill-GEMM experiments (ops/cuda/exp_prefill.py, scripts/exp_prefill_*)
# ---------------------------------------------------------------------------
_EXP_SCRIPTS = {m.NAME: m for m in (exp_prefill_floor, exp_prefill_tiles2,
                                    exp_prefill_overlap, exp_prefill_pipe)}
# (script, arm) of every arm that runs a kernel of csrc/exp_prefill.cu: every
# compiled configuration of each kernel
_EXP_ARMS = [(name, a.name) for name, m in _EXP_SCRIPTS.items()
             for a in m.arms() if a.kernel.startswith("exp_gemm")]


def _exp_setup(**shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return _prefill.make_setup("cuda", **shape)


@pytest.fixture(scope="module")
def exp_small():
    return _exp_setup(K=256, N=512, M=256)


@pytest.fixture(scope="module")
def exp_gate_up():
    return _exp_setup()            # K 4096, N 28672, M 1024, as the scripts


def _exp_check(setup, script, arm_name):
    """The arm's kernel, launched once, against the f32 plain output: 2e-3
    of max |plain| (bf16 MMA, f32 sums in another order), 2^-8 for a bf16
    output (its own rounding, half an ulp, as test_kernel_bf16_output)."""
    arm = next(a for a in _EXP_SCRIPTS[script].arms() if a.name == arm_name)
    ep.reset_launch_counts()
    got = arm.call(setup.x, setup.weights[arm.weight][0])
    torch.cuda.synchronize()
    assert ep.launch_counts[arm.kernel] == 1
    assert sum(ep.launch_counts.values()) == 1
    assert got.dtype == arm.out_dtype and got.shape == setup.plain(
        arm.weight).shape
    tol = 2e-3 if arm.out_dtype == torch.float32 else 2 ** -8
    assert _rel(got.float(), setup.plain(arm.weight)) < tol


@pytest.mark.parametrize("script,arm", _EXP_ARMS)
def test_exp_prefill_kernel_matches_plain_small(exp_small, script, arm):
    _exp_check(exp_small, script, arm)


@pytest.mark.parametrize("script,arm", _EXP_ARMS)
def test_exp_prefill_kernel_matches_plain_gate_up(exp_gate_up, script, arm):
    _exp_check(exp_gate_up, script, arm)


def test_exp_prefill_wrappers_check_operands(exp_small):
    w = exp_small.weights["emi8"][0]
    x = exp_small.x
    cpu_w = dataclasses.replace(w, codes=w.codes.cpu(),
                                scale_exp=w.scale_exp.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        ep.gemm_pipe(x, cpu_w, bm=128, bn=128, bk=32)
    with pytest.raises(ValueError, match="shared memory"):
        ep.gemm_rx(x, w, tn=512, bk=256)
    with pytest.raises(ValueError, match="not compiled"):
        ep.gemm_tiles(x, w, bm=64, bn=64, bk=32)
    with pytest.raises(ValueError, match="does not divide"):
        ep.gemm_tiles(x[:100], w, bm=128, bn=128, bk=32)


# ---------------------------------------------------------------------------
# decode-GEMV experiments (ops/cuda/exp_gemv.py, scripts/exp_decode_variants,
# exp_sad_tiles, exp_nb_variants)
# ---------------------------------------------------------------------------
_GEMV_SCRIPTS = {exp_decode_variants.NAME: (exp_decode_variants,
                                            _gemv.decode_setup),
                 exp_sad_tiles.NAME: (exp_sad_tiles, _gemv.tiles_setup),
                 exp_nb_variants.NAME: (exp_nb_variants, _gemv.nb_setup)}
_GEMV_SMALL = {exp_decode_variants.NAME: dict(K=256, N=512),
               exp_sad_tiles.NAME: dict(K=256, N=512),
               exp_nb_variants.NAME: dict(K=256, N=256)}
# (script, arm) of every arm that runs a kernel of csrc/exp_gemv.cu: every
# variant, tile configuration and NB mode
_GEMV_ARMS = [(name, a.name) for name, (m, _) in _GEMV_SCRIPTS.items()
              for a in m.arms() if a.kernel.startswith("exp_")]


@pytest.fixture(scope="module")
def gemv_setup():
    """setup(script, small): the script's setup on the card, made once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    made = {}

    def get(script, small):
        if (script, small) not in made:
            shape = _GEMV_SMALL[script] if small else {}
            made[(script, small)] = _GEMV_SCRIPTS[script][1]("cuda", **shape)
        return made[(script, small)]

    yield get
    made.clear()


def _gemv_check(setup, script, arm_name):
    """The arm's kernel, launched once, within 1e-5 of max |plain| of its
    own plain version."""
    arm = next(a for a in _GEMV_SCRIPTS[script][0].arms()
               if a.name == arm_name)
    eg.reset_launch_counts()
    got = arm.call(setup.x, setup.weights[arm.weight][0])
    torch.cuda.synchronize()
    assert eg.launch_counts[arm.kernel] == 1
    assert sum(eg.launch_counts.values()) == 1
    want = setup.plain(arm.plain_key)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("script,arm", _GEMV_ARMS)
def test_exp_gemv_kernel_matches_plain_small(gemv_setup, script, arm):
    _gemv_check(gemv_setup(script, True), script, arm)


@pytest.mark.parametrize("script,arm", _GEMV_ARMS)
def test_exp_gemv_kernel_matches_plain_full(gemv_setup, script, arm):
    _gemv_check(gemv_setup(script, False), script, arm)


@pytest.mark.parametrize("small", [True, False])
def test_decode_variants_bit_equal_to_i32(gemv_setup, small):
    par = exp_decode_variants.parity(
        gemv_setup(exp_decode_variants.NAME, small))
    assert par["exact"], par


def _cc_gemv(x, w):
    """The CUDA-core GEMV (dequant_gemv.cu's gemv_partial: the shipped GEMV
    until the tensor-core one, now the route of the blocks that are no
    multiple of 16) on any block, through its C entry."""
    x2 = x.to(torch.bfloat16).contiguous()
    M, K = x2.shape
    decode, fold, mw, ebits = dm.sad_decode_params(w)
    NB, _, N = w.codes.shape
    ksplit, _ = dm.gemv_ksplit(N, NB)
    ws = torch.empty((ksplit, M, N), device=x.device)
    out = torch.empty((M, N), device=x.device)
    assert dm._kernel("dequant_gemv_cc")(
        x2.data_ptr(), w.codes.data_ptr(), w.scale_exp.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, K, N, NB, w.block_size,
        dm._DECODES[decode], mw, ebits, fold, ksplit, 0,
        torch.cuda.current_stream().cuda_stream) == 0
    return out


def test_shipped_tile_repeats_the_shipped_gemv(gemv_setup):
    """At (4096, 28672) the CUDA-core GEMV splits K into 7-block splits:
    tile (8, 512, 7) does its arithmetic in its order."""
    s = gemv_setup(exp_sad_tiles.NAME, False)
    w = s.weights["emi8"][0]
    assert dm.gemv_ksplit(w.codes.shape[2], w.codes.shape[0])[1] == 7
    assert torch.equal(eg.gemv_tiles(s.x, w, mt=8, tn=512, kb=7),
                       _cc_gemv(s.x, w))


@pytest.mark.parametrize("mode", list(eg.MODES))
def test_nb_fd_rows_by_field_and_slot(cuda, mode):
    """x rows are unit vectors, so y[m] is column k_m of the mode's weight,
    exactly: every row 16b + 4i + r of every N-block (each field i of each
    code byte r) and every slot row lands in its place."""
    w = _nb(256, 256, 2, 5, cuda)
    ks = [0, 3, 64, 97, 130, 131, 200, 255]
    x = torch.zeros((8, 256), device=cuda)
    x[torch.arange(8), torch.tensor(ks)] = 1.0
    parts = tpk.outlier_nb_parts(w)
    assert (parts["outliers"][:, ks] != 0).sum() >= 8
    part = eg.ABLATIONS.get(mode)
    want = (parts[part] if part else parts["inliers"] + parts["outliers"])
    got = eg.fd_matmul(x, w, mode)
    assert torch.equal(got, want[:, ks].T)


def test_exp_gemv_wrappers_check_operands(gemv_setup):
    s = gemv_setup(exp_decode_variants.NAME, True)
    w = s.weights["emi8"][0]
    cpu_w = dataclasses.replace(w, codes=w.codes.cpu(),
                                scale_exp=w.scale_exp.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        eg.gemv_variant(s.x, cpu_w, "i32")
    with pytest.raises(ValueError, match="one CUDA device"):
        eg.gemv_tiles(s.x, cpu_w, mt=8, tn=512, kb=7)
    with pytest.raises(ValueError, match="ebf8_weight"):
        eg.gemv_variant(s.x, w, "ebf8")
    nb = gemv_setup(exp_nb_variants.NAME, True).weights["nb"][0]
    with pytest.raises(ValueError, match="one device"):
        eg.fd_matmul(s.x[:, :256], dataclasses.replace(
            nb, out_byte=nb.out_byte.cpu()), "pdot")


# ---------------------------------------------------------------------------
# the wgmma + TMA GEMMs (csrc/gemm_sm90.cuh): pf6, pf4, sb4, sb2, the fp16,
# int8 and float8 containers, emi8/emi8m, the side-band and the compact NB
# format, and the gemm_tile kernels that take their other blocks and
# budgets
# ---------------------------------------------------------------------------
LLAMA3_8B = {"qkv": (4096, 6144), "o": (4096, 4096),
             "gate_up": (4096, 28672), "down": (14336, 4096),
             "lm_head": (4096, 128256)}
# kind -> (format, transport) of the GEMMs of dequant_matmul.cu
SM90_DQ = {"pf6": ("fp6_e3m2", "pf6"), "pf4": ("fp4_e2m1", "pf4"),
           "fp16": ("fp16", "native"), "emi8": ("fp6_e3m2", "emi8"),
           "sb4": ("int4", "sb4"), "sb2": ("int2", "sb2"),
           "int8": ("int8", "native"), "fp8_e4m3": ("fp8_e4m3", "native"),
           "fp8_e5m2": ("fp8_e5m2", "native")}
# the sm90 plans' names of the kinds whose decode is named otherwise
SM90_KIND = {"emi8m": "emi8", "int8": "native"}


def _sideband_dense(w):
    """The side-band twin's bf16 weight, made on the CPU, where
    scatter_add adds the slots in slot order."""
    return tpk.dequantize_mx_outlier(dataclasses.replace(
        w, inlier=dataclasses.replace(w.inlier, codes=w.inlier.codes.cpu(),
                                      scale_exp=w.inlier.scale_exp.cpu()),
        out_codes=w.out_codes.cpu(), out_pos=w.out_pos.cpu(),
        out_scale_exp=w.out_scale_exp.cpu()), dtype=torch.bfloat16)


def _nb_dense(w):
    """The NB twin's bf16 weight as (K, N), made on the CPU."""
    return tpk.dequantize_outlier_nb(dataclasses.replace(w, **{
        f: getattr(w, f).cpu() for f in ("codes", "scale_exp", "out_byte",
                                         "out_scale_exp")}),
        dtype=torch.bfloat16).T


def _nb_slots(K, N, budget, seed, device):
    """A compact NB weight of exactly ``budget`` slot planes: the
    packer's (which makes 1 to 16) with its planes removed for 0, or
    empty planes (byte 0) added above 16."""
    w = _nb(K, N, min(max(budget, 1), 16), seed, device)
    ob = w.out_byte[:budget]
    if budget > ob.shape[0]:
        ob = torch.cat([ob, ob.new_zeros((budget - ob.shape[0],)
                                         + ob.shape[1:])])
    return dataclasses.replace(w, out_byte=ob.contiguous())


def _sm90_weight(kind, K, N, seed, device, block=32, budget=4,
                 dense=True):
    """A ``kind`` weight and (GEMM wrapper, plain twin, dense bf16 weight
    as the twin makes it on the CPU); ``emi8m`` is the merged stream of a
    side-band weight of ``block``, ``nb`` the compact format (block 16)
    with ``budget`` slots; no dense weight with ``dense=False``."""
    if kind == "sideband":
        w = _sideband(K, N, budget, seed, device, block=block)
        return (w, om.dequant_gemm_outlier,
                om.dequant_matmul_outlier_reference,
                _sideband_dense(w) if dense else None)
    if kind == "nb":
        w = _nb_slots(K, N, budget, seed, device)
        return (w, om.dequant_gemm_nb, om.dequant_matmul_nb_reference,
                _nb_dense(w) if dense else None)
    if kind == "emi8m":
        w = tpk.to_serving_layout(tpk.merge_outlier_emi8(
            _sideband(K, N, 4, seed, device, block=block)))
        return (w, dm.dequant_gemm, dm.dequant_matmul_reference,
                tpk.dequantize_mx(w, dtype=torch.bfloat16))
    fmt, transport = SM90_DQ[kind]
    w = _packed_as(K, N, fmt, transport, block, 1.0, seed, device)
    return (w, dm.dequant_gemm, dm.dequant_matmul_reference,
            tpk.dequantize_mx(w, dtype=torch.bfloat16))




@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
def test_sm90_pf6_gemm_at_llama_shapes(cuda, lin):
    K, N = LLAMA3_8B[lin]
    w = _packed_as(K, N, "fp6_e3m2", "pf6", 32, 1.0, 7, cuda)
    x = _x(1024, K, 8, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_gemm(x, w)
    want = dm.dequant_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts["dequant_matmul_pf6"] == 1
    assert _rel(got, want) < 2e-3


@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
@pytest.mark.parametrize("kind", ["pf4", "fp16"])
def test_sm90_pf4_and_fp16_gemm_at_llama_shapes(cuda, kind, lin):
    K, N = LLAMA3_8B[lin]
    w, fn, ref, _ = _sm90_weight(kind, K, N, 17, cuda)
    x = _x(1024, K, 18, cuda)
    dm.reset_launch_counts()
    got = fn(x, w)
    want = ref(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_matmul_{kind}"] == 1
    assert sum(dm.launch_counts.values()) == 1
    assert _rel(got, want) < 2e-3


@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
@pytest.mark.parametrize("kind,block", [("sb4", 32), ("sb2", 16)])
def test_sm90_sb4_and_sb2_gemm_at_llama_shapes(cuda, kind, block, lin):
    """int4 sb4 at block 32 (the int4 arm's) and int2 sb2 at block 16, on
    the sm90 loop's counter, within 2e-3 of the twin."""
    K, N = LLAMA3_8B[lin]
    w, fn, ref, _ = _sm90_weight(kind, K, N, 19, cuda, block=block,
                                 dense=False)
    x = _x(1024, K, 20, cuda)
    dm.reset_launch_counts()
    got = fn(x, w)
    want = ref(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_matmul_{kind}"] == 1
    assert sum(dm.launch_counts.values()) == 1
    assert _rel(got, want) < 2e-3


@pytest.mark.parametrize("budget", [1, 2, 4, 8])
@pytest.mark.parametrize("lin", ["qkv", "gate_up"])
def test_sm90_sideband_gemm_budgets(cuda, lin, budget):
    K, N = LLAMA3_8B[lin]
    w = _sideband(K, N, budget, budget, cuda)
    assert w.budget == budget
    x = _x(1024, K, 9, cuda)
    om.reset_launch_counts()
    got = om.dequant_gemm_outlier(x, w)
    want = om.dequant_matmul_outlier_reference(x, w)
    torch.cuda.synchronize()
    assert om.launch_counts["dequant_gemm_outlier"] == 1
    assert _rel(got, want) < 2e-3


# (kind, block, budget) of the emi8 and compact-NB GEMMs on the sm90 loop:
# MX-FP6 emi8 (block 32), the emi8m stream (block 16) and the compact NB
# format at budgets 0 (no slot planes) to 16
SM90_EMI8_NB = [("emi8", 32, 0), ("emi8m", 16, 0)] + [
    ("nb", 16, b) for b in (0, 1, 2, 4, 16)]


@pytest.mark.parametrize("kind,block,budget", SM90_EMI8_NB)
@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
def test_sm90_emi8_and_nb_gemm_at_llama_shapes(cuda, lin, kind, block,
                                               budget):
    K, N = LLAMA3_8B[lin]
    w, fn, ref, _ = _sm90_weight(kind, K, N, 29, cuda, block=block,
                                 budget=budget, dense=False)
    if kind == "nb":
        assert w.budget == budget
        counter, counts = "dequant_gemm_nb", om.launch_counts
    else:
        counter, counts = "dequant_matmul_emi8", dm.launch_counts
    x = _x(1024, K, 30, cuda)
    dm.reset_launch_counts()
    om.reset_launch_counts()
    got = fn(x, w)
    want = ref(x, w)
    torch.cuda.synchronize()
    assert counts[counter] == 1 and sum(counts.values()) == 1
    assert _rel(got, want) < 2e-3


def _emi8_bytes(mw):
    """Every byte whose decode m̂ · 2^e' is an int32 (|m̂| · 2^e' < 2^31,
    as the packers keep it; m̂ in the high mw bits, e' in the low 8 - mw)."""
    b = torch.arange(256, dtype=torch.int32)
    c = torch.where(b > 127, b - 256, b)
    m, e = c >> (8 - mw), c & ((1 << (8 - mw)) - 1)
    keep = m.abs().double() * torch.exp2(e.double()) < 2.0 ** 31
    return c[keep].to(torch.int8)


@pytest.mark.parametrize("block", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("mw", [2, 3, 4, 5, 6, 7])
def test_sm90_emi8_b_tile_is_gemm_tile_s_on_every_byte(cuda, monkeypatch,
                                                       mw, block):
    """An emi8m weight (fold 0) that holds every byte of the field split mw
    in every column, under block exponents at both ends of the int8 range
    (-128 to -120, where the scale clamps at 2^-126, and 118 to 127):
    through x = I the sm90 GEMM's output is gemm_tile's bit for bit. A
    byte whose value would pass the f32 range at its block's scale is
    replaced by 0 there (x = I would turn its inf into NaN); it stays in
    the blocks of lower scale."""
    codes = _emi8_bytes(mw)
    K, N = 256, 128
    exps = torch.tensor(list(range(-128, -119)) + list(range(118, 128)))
    kk = torch.arange(K)[:, None]
    nn = torch.arange(N)[None, :]
    c = codes[(kk + 7 * nn) % len(codes)].to(torch.int32)
    se = exps[(torch.arange(K // block)[:, None] + nn) % len(exps)]
    s = se.repeat_interleave(block, 0).clamp(-126, 127).double()
    m, e = c >> (8 - mw), c & ((1 << (8 - mw)) - 1)
    val = m.double() * torch.exp2(e.double() + s)
    c = torch.where(val.abs().log2() < 128, c, 0).to(torch.int8)
    w = tpk.to_serving_layout(tpk.PackedMX(
        codes=c.to(cuda), scale_exp=se.to(torch.int8).to(cuda),
        elem_format="int2", block_size=block, scale_bits=8, orig_dim=K,
        axis=0, transport="emi8m", transport_mw=mw, transport_fold=0))
    x = torch.eye(K, device=cuda)
    dm.reset_launch_counts()
    got = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts["dequant_matmul_emi8"] == 1
    monkeypatch.setattr(dm, "gemm_route", lambda *a, **k: "tile")
    tile = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts["dequant_matmul_emi8_tile"] == 1
    assert (tile.abs() == 2.0 ** -126).any()
    assert (tile.abs() >= 2.0 ** 126).any() and tile.isfinite().all()
    assert torch.equal(got.cpu(), tile.cpu())



@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_sm90_int8_and_float8_gemm_at_llama_shapes(cuda, kind, lin):
    """The int8 container (the int8 arm's weight) and both float8
    containers at block 32, on the sm90 loop's counter, within 2e-3 of the
    twin."""
    K, N = LLAMA3_8B[lin]
    w, fn, ref, _ = _sm90_weight(kind, K, N, 21, cuda, dense=False)
    decode = dm.sad_decode_params(w)[0]
    x = _x(1024, K, 22, cuda)
    dm.reset_launch_counts()
    got = fn(x, w)
    want = ref(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_matmul_{decode}"] == 1
    assert sum(dm.launch_counts.values()) == 1
    assert _rel(got, want) < 2e-3


# int8 and float8: (format, code dtype, scale fold)
BYTE_KINDS = {"int8": ("int8", torch.int8, 6),
              "fp8_e4m3": ("fp8_e4m3", torch.float8_e4m3fn, 0),
              "fp8_e5m2": ("fp8_e5m2", torch.float8_e5m2, 0)}


@pytest.mark.parametrize("block", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("kind", sorted(BYTE_KINDS))
def test_sm90_int8_and_float8_b_tile_is_gemm_tile_s_on_every_byte(
        cuda, monkeypatch, kind, block):
    """A weight that holds every one of the 256 bytes in every column,
    under block exponents at both ends of the int8 range (-128 to -120,
    where the scale clamps at 2^-126, and 118 to 127): the sm90 decoder's
    B tile is gemm_tile's as 16-bit patterns, NaN and inf codes and
    overflows included (dm.decoded_b_tile); and through x = I, with the
    codes whose value is no finite f32 at their block's scale set to 0
    (x = I would turn them into NaN columns), the sm90 GEMM's output is
    gemm_tile's bit for bit."""
    fmt, dtype, fold = BYTE_KINDS[kind]
    assert dm.scale_fold(fmt) == fold
    K, N = 256, 128
    exps = torch.tensor(list(range(-128, -119)) + list(range(118, 128)))
    kk = torch.arange(K)[:, None]
    nn = torch.arange(N)[None, :]
    c = ((kk + 7 * nn) % 256 - 128).to(torch.int8)
    se = exps[(torch.arange(K // block)[:, None] + nn) % len(exps)]
    s = (se.repeat_interleave(block, 0) - fold).clamp(-126, 127).double()

    def weight(codes):
        return tpk.to_serving_layout(tpk.PackedMX(
            codes=codes.view(dtype).to(cuda),
            scale_exp=se.to(torch.int8).to(cuda), elem_format=fmt,
            block_size=block, scale_bits=8, orig_dim=K, axis=0,
            transport="native"))

    w = weight(c)
    decode = dm.sad_decode_params(w)[0]
    assert dm.gemm_route(decode, block) == "sm90"
    sm90 = dm.decoded_b_tile(w, "sm90")
    tile = dm.decoded_b_tile(w, "tile")
    torch.cuda.synchronize()
    assert sm90.shape == (K, N) and torch.equal(sm90.cpu(), tile.cpu())
    # values under the clamped 2^-126 scale; float8's NaN codes
    v = tile.cpu().view(torch.bfloat16).float()
    assert ((v != 0) & (v.abs() < 2.0 ** -118)).any()
    assert kind == "int8" or v.isnan().any()
    val = c.view(dtype).double() * torch.exp2(s)
    finite = val.isfinite() & (val.abs() < 2.0 ** 128)
    w = weight(torch.where(finite, c, 0))
    x = torch.eye(K, device=cuda)
    dm.reset_launch_counts()
    got = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_matmul_{decode}"] == 1
    monkeypatch.setattr(dm, "gemm_route", lambda *a, **k: "tile")
    ref = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_matmul_{decode}_tile"] == 1
    assert ref.isfinite().all() and (ref.abs() >= 2.0 ** 120).any()
    assert torch.equal(got.cpu(), ref.cpu())

@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
def test_sm90_bf16_gemm_at_llama_shapes(cuda, lin):
    """The bf16 container at block 32 on the sm90 loop's counter (no
    gemm_tile launch), within 2e-3 of the twin."""
    K, N = LLAMA3_8B[lin]
    w = _packed_as(K, N, "bfloat16", "native", 32, 64.0, 23, cuda)
    assert dm.sad_decode_params(w)[0] == "bf16"
    assert dm.gemm_route("bf16", 32) == "sm90"
    x = _x(1024, K, 24, cuda)
    dm.reset_launch_counts()
    got = dm.dequant_gemm(x, w)
    want = dm.dequant_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts["dequant_matmul_bf16"] == 1
    assert sum(dm.launch_counts.values()) == 1
    assert _rel(got, want) < 2e-3


@pytest.mark.parametrize("block", [8, 16, 32, 64])
def test_sm90_bf16_b_tile_is_gemm_tile_s_on_every_code(cuda, monkeypatch,
                                                        block):
    """A (512, 128) bf16-container weight that holds all 65536 bf16 bit
    patterns, under block exponents at both ends of the int8 range (-128
    to -120, where the scale clamps at 2^-126 and products fall to f32 and
    bf16 subnormals, and 118 to 127): the sm90 decoder's B tile is
    gemm_tile's as 16-bit patterns, NaN, inf, subnormal codes and
    overflows included (dm.decoded_b_tile); and through x = I, with the
    codes whose value is no finite f32 at their block's scale set to 0,
    the sm90 GEMM's output is gemm_tile's bit for bit."""
    K, N = 512, 128
    exps = torch.tensor(list(range(-128, -119)) + list(range(118, 128)))
    c = torch.arange(K * N, dtype=torch.int32).reshape(K, N)
    c = ((c + 32768) % 65536 - 32768).to(torch.int16)
    nn = torch.arange(N)[None, :]
    se = exps[(torch.arange(K // block)[:, None] + nn) % len(exps)]
    s = se.repeat_interleave(block, 0).clamp(-126, 127).double()

    def weight(codes):
        return tpk.to_serving_layout(tpk.PackedMX(
            codes=codes.view(torch.bfloat16).to(cuda),
            scale_exp=se.to(torch.int8).to(cuda), elem_format="bfloat16",
            block_size=block, scale_bits=8, orig_dim=K, axis=0,
            transport="native"))

    w = weight(c)
    assert dm.sad_decode_params(w)[0] == "bf16"
    assert dm.gemm_route("bf16", block) == "sm90"
    sm90 = dm.decoded_b_tile(w, "sm90")
    tile = dm.decoded_b_tile(w, "tile")
    torch.cuda.synchronize()
    assert sm90.shape == (K, N) and torch.equal(sm90.cpu(), tile.cpu())
    v = tile.cpu().view(torch.bfloat16).float()
    assert ((v != 0) & (v.abs() < 2.0 ** -126)).any()      # subnormals
    assert v.isnan().any() and v.isinf().any()
    val = c.view(torch.bfloat16).double() * torch.exp2(s)
    finite = val.isfinite() & (val.abs() < 2.0 ** 128)
    w = weight(torch.where(finite, c, torch.zeros_like(c)))
    x = torch.eye(K, device=cuda)
    dm.reset_launch_counts()
    got = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts["dequant_matmul_bf16"] == 1
    monkeypatch.setattr(dm, "gemm_route", lambda *a, **k: "tile")
    ref = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts["dequant_matmul_bf16_tile"] == 1
    assert torch.equal(got.cpu(), ref.cpu())


# sb4 and sb2: (format, codes a byte, bits a code, scale fold)
SUBBYTE = {"sb4": ("int4", 2, 4, 2), "sb2": ("int2", 4, 2, 0)}


@pytest.mark.parametrize("kind,block",
                         [("sb4", b) for b in (2, 4, 8, 16, 32, 64)]
                         + [("sb2", b) for b in (4, 8, 16, 32, 64)])
def test_sm90_sb_b_tile_is_gemm_tile_s_on_every_code(cuda, monkeypatch, kind,
                                                     block):
    """An sb4 (sb2) weight that holds every 4-bit (2-bit) code in every
    field of its packed rows, under block exponents at both ends of the
    int8 range (-128 to -120, where the scale clamps at 2^-126, and 118 to
    127): through x = I the sm90 GEMM's output is gemm_tile's bit for bit.
    A code whose value would pass the f32 range at its block's scale is
    replaced by 0 there (x = I would turn its inf into NaN)."""
    fmt, per, bits, fold = SUBBYTE[kind]
    assert dm.scale_fold(fmt) == fold
    codes = torch.arange(-(1 << (bits - 1)), 1 << (bits - 1))
    K, N = 256, 128
    exps = torch.tensor(list(range(-128, -119)) + list(range(118, 128)))
    kk = torch.arange(K)[:, None]
    nn = torch.arange(N)[None, :]
    c = codes[(kk + 7 * nn) % len(codes)]
    se = exps[(torch.arange(K // block)[:, None] + nn) % len(exps)]
    s = (se.repeat_interleave(block, 0) - fold).clamp(-126, 127).double()
    val = c.double() * torch.exp2(s)
    c = torch.where(val.abs().log2() < 128, c, 0)
    packed = tpk._subbyte_pack(c.T.contiguous(), block, per, bits).T
    w = tpk.to_serving_layout(tpk.PackedMX(
        codes=packed.contiguous().to(cuda),
        scale_exp=se.to(torch.int8).to(cuda), elem_format=fmt,
        block_size=block, scale_bits=8, orig_dim=K, axis=0, transport=kind))
    x = torch.eye(K, device=cuda)
    dm.reset_launch_counts()
    got = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_matmul_{kind}"] == 1
    monkeypatch.setattr(dm, "gemm_route", lambda *a, **k: "tile")
    tile = dm.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert dm.launch_counts[f"dequant_matmul_{kind}_tile"] == 1
    assert (tile.abs() == 2.0 ** -126).any()
    assert (tile.abs() >= 2.0 ** 126).any() and tile.isfinite().all()
    assert torch.equal(got.cpu(), tile.cpu())


def _sideband_shared_rows(K, N, seed, device, block=16):
    """Budget 4, and in every block whose first slot is filled a second
    slot that names the same row with its own code: the kernel must add
    both in slot order."""
    w = _sideband(K, N, 4, seed, device, block=block)
    pos, oc = w.out_pos.clone(), w.out_codes.clone()
    hit = pos[..., 0] >= 0
    pos[..., 1] = torch.where(hit, pos[..., 0], pos[..., 1])
    oc[..., 1] = torch.where(hit, oc[..., 0], oc[..., 1])
    assert hit.any()
    return dataclasses.replace(w, out_pos=pos, out_codes=oc)


@pytest.mark.parametrize("N", [384, 130])
@pytest.mark.parametrize("K", [256, 512])
@pytest.mark.parametrize("kind", ["pf6", "sideband", "pf4", "fp16", "emi8",
                                  "emi8m", "nb", "sb4", "sb2", "int8",
                                  "fp8_e4m3", "fp8_e5m2"])
def test_sm90_b_tile_is_the_twin_weight_bit_for_bit(cuda, kind, K, N):
    """x = I: every output row is one row of the decoded B tile (products
    with 1 and 0 are exact in f32), so the GEMM's f32 output is the twin's
    bf16 weight at every element; a swizzle or fragment-layout error shows
    where it occurs. torch.equal, since the f32 sum turns -0 into +0."""
    x = torch.eye(K, device=cuda)
    if kind == "sideband":
        w = _sideband_shared_rows(K, N, K + N, cuda)
        got = om.dequant_gemm_outlier(x, w)
        dense = _sideband_dense(w)
    else:
        w, fn, _, dense = _sm90_weight(kind, K, N, K + N, cuda)
        got = fn(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), dense.float().cpu())


@pytest.mark.parametrize("kind", ["pf6", "sideband", "pf4", "fp16", "emi8",
                                  "emi8m", "nb", "sb4", "sb2", "int8",
                                  "fp8_e4m3", "fp8_e5m2"])
def test_sm90_k_not_a_multiple_of_8_pads_x(cuda, kind):
    K, N, M = 203, 384, 300
    block = 16 if kind in ("sideband", "nb", "emi8m") else 32
    w, fn, ref, _ = _sm90_weight(kind, K, N, 3, cuda, block=block)
    plan = dm.sm90_plan(SM90_KIND.get(kind, kind), K, N, block,
                        4 if kind in ("sideband", "nb") else 0)
    assert plan["pad_x"] and plan["k_x"] == 208
    for out_dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2 ** -8)):
        x = _x(M, K, 4, cuda)
        got = fn(x, w, out_dtype=out_dtype)
        assert got.dtype == out_dtype and got.shape == (M, N)
        assert _rel(got.float(), ref(x, w)) < tol


# every block the JAX packers take for these formats, on its route: the
# sm90 kernel where the block divides the K step and its ring fits (pf4 48,
# pf6 128, fp16 48, emi8 48, sb4 48, sb2 48, int8 and float8 at 2 and 48,
# and the side-band format at 48, or at 8 with 8 slots: gemm_tile); the NB
# format at its largest budget
SM90_BLOCK_CASES = [("pf4", 16, 0), ("pf4", 32, 0), ("pf4", 64, 0),
                    ("pf4", 48, 0), ("pf6", 64, 0), ("pf6", 128, 0),
                    ("fp16", 8, 0), ("fp16", 64, 0), ("fp16", 48, 0),
                    ("sideband", 8, 4), ("sideband", 8, 8),
                    ("sideband", 64, 4), ("sideband", 64, 8),
                    ("sideband", 48, 4), ("emi8", 4, 0), ("emi8", 8, 0),
                    ("emi8", 64, 0), ("emi8", 48, 0), ("nb", 16, 16),
                    ("sb4", 2, 0), ("sb4", 8, 0), ("sb4", 64, 0),
                    ("sb4", 48, 0), ("sb2", 4, 0), ("sb2", 64, 0),
                    ("sb2", 48, 0), ("int8", 8, 0), ("int8", 64, 0),
                    ("int8", 2, 0), ("int8", 48, 0), ("fp8_e4m3", 8, 0),
                    ("fp8_e4m3", 64, 0), ("fp8_e4m3", 2, 0),
                    ("fp8_e4m3", 48, 0), ("fp8_e5m2", 8, 0),
                    ("fp8_e5m2", 64, 0), ("fp8_e5m2", 2, 0),
                    ("fp8_e5m2", 48, 0)]


@pytest.mark.parametrize("kind,block,budget", SM90_BLOCK_CASES)
def test_sm90_every_packer_block_runs_its_route(cuda, kind, block, budget):
    """The GEMM at M = 300 (and K % 8 != 0) within 2e-3 of the twin, on
    the route that gemm_route names, and its B tile (x = I) bit-equal to
    the twin's bf16 weight."""
    K, N, M = 389, 384, 300
    w, fn, ref, dense = _sm90_weight(kind, K, N, block, cuda, block=block,
                                     budget=budget)
    if kind == "sideband":
        counter, counts = om.gemm_counter(block, budget), om.launch_counts
    elif kind == "nb":
        counter, counts = om.nb_gemm_counter(budget), om.launch_counts
    else:
        counter = dm.gemm_counter(dm.sad_decode_params(w)[0], block)
        counts = dm.launch_counts
    x = _x(M, K, 5, cuda)
    dm.reset_launch_counts()
    om.reset_launch_counts()
    got = fn(x, w)
    want = ref(x, w)
    torch.cuda.synchronize()
    assert counts[counter] == 1 and sum(counts.values()) == 1
    assert _rel(got, want) < 2e-3
    eye = fn(torch.eye(K, device=cuda), w)
    torch.cuda.synchronize()
    assert torch.equal(eye.cpu(), dense.float().cpu())


def test_sm90_nb_budget_above_16_takes_gemm_tile(cuda):
    """No packer makes more than 16 slots; a weight with 17 (one empty
    plane added) runs on gemm_tile's nb_gemm, within 2e-3 of the twin,
    its B tile the twin's weight."""
    K, N, M = 389, 384, 300
    w, fn, ref, dense = _sm90_weight("nb", K, N, 31, cuda, budget=17)
    assert w.budget == 17 and dm.gemm_route("nb", 16, 17) == "tile"
    x = _x(M, K, 32, cuda)
    om.reset_launch_counts()
    got = fn(x, w)
    torch.cuda.synchronize()
    assert om.launch_counts["dequant_gemm_nb_tile"] == 1
    assert sum(om.launch_counts.values()) == 1
    assert _rel(got, ref(x, w)) < 2e-3
    eye = fn(torch.eye(K, device=cuda), w)
    torch.cuda.synchronize()
    assert torch.equal(eye.cpu(), dense.float().cpu())


@pytest.mark.parametrize("arm", ["mxfp6", "int4", "nb", "sideband"])
def test_graph_decode_is_bit_identical_to_eager(cuda, arm):
    """2 layers of Llama-3-8B at full width (chip_smoke's models: MX-FP6
    emi8, int4 sb4, the compact NB and the side-band formats), B = 8, a
    64-token prompt, 8 greedy steps over the dense cache: the decode
    replayed from a CUDA graph (DecodeStep, as generate and the main
    paths run it) gives the eager loop's tokens and last logits bit for
    bit, and its launches (the warm-up step's plus the captured step's
    times the replays) equal the eager loop's; generate's tokens are the
    same."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from microscopiq_tpu_torch.eval.generate import generate

    model = {"mxfp6": lambda: cs.build(True, layers=2, seed=3),
             "int4": lambda: cs.int_model("int4_sb4", 2, seed=3),
             "nb": lambda: cs.outlier_model("nb", 2, seed=3),
             "sideband": lambda: cs.outlier_model("sideband", 2, seed=3)
             }[arm]()[0]
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (8, 64)), device=cuda)
    info = {}
    cs.reset_counts()
    graph = cs.prefill_decode(model, ids, 8, 80, info=info)
    eager = cs.prefill_decode(model, ids, 8, 80, graph=False)
    torch.cuda.synchronize()
    assert info == {"graph": True, "timed_steps": 7, "fold_replays": 0}
    assert torch.equal(graph[0], eager[0])
    assert torch.equal(graph[3], eager[3])
    assert graph[5] == eager[5] and sum(graph[5].values()) > 0
    assert int(graph[6].length) == graph[6].host_length == 72
    got = generate(model, ids.cpu().numpy(), 9, max_len=80)
    want = torch.cat([graph[7][0][:, -1].argmax(-1)[:, None], graph[0]], 1)
    np.testing.assert_array_equal(got, want.cpu().numpy())


def test_sm90_kernels_do_not_spill(cuda):
    from microscopiq_tpu_torch.ops.cuda import build

    sources = ("dequant_matmul", "outlier_matmul", "nb_matmul")
    build.build_all(sources)
    lines = [ln for ln in build.ptxas_report(sources) if "_sm90" in ln]
    assert sum("gemm_dq_sm90" in ln for ln in lines) == 45
    assert sum("b_tile_sm90" in ln for ln in lines) == 45
    assert sum("outlier_gemm_sm90" in ln for ln in lines) == 15
    assert sum("nb_gemm_sm90" in ln for ln in lines) == 5
    gemv = [ln for ln in build.ptxas_report(("outlier_matmul",))
            if "sideband_gemv" in ln]
    assert len(gemv) == 16     # MT 1, 2, 4, 8; int8, float8; TMA, plain
    for ln in lines + gemv:
        assert "0 bytes spill stores, 0 bytes spill loads" in ln, ln


# ---------------------------------------------------------------------------
# the tensor-core GEMVs: dequant_gemv.cu's gemv_tc (every decode) and
# nb_matmul.cu's nb_gemv, 1e-5 of max |twin| (exact bf16 weights and
# products; f32 sums in another order, the tensor core summing at most one
# K-block or one 128-column stage)
# ---------------------------------------------------------------------------
# (format, transport, weight scale) of every decode of the dequant GEMV
TC_GEMV_DECODES = [("fp6_e3m2", "emi8", 1.0), ("int8", "native", 1.0),
                   ("int4", "sb4", 1.0), ("int2", "sb2", 1.0),
                   ("fp4_e2m1", "pf4", 1.0), ("fp6_e3m2", "pf6", 1.0),
                   ("bfloat16", "native", 8.0), ("fp16", "native", 1.0),
                   ("fp8_e4m3", "native", 1.0), ("fp8_e5m2", "native", 1.0)]


def _tc_blocks(transport):
    return (32, 64, 128) if transport == "pf6" else (16, 32, 64)


@pytest.mark.parametrize("fmt,transport,scale", TC_GEMV_DECODES)
def test_tc_gemv_matches_twin(cuda, fmt, transport, scale):
    """Every decode at blocks 16, 32 and 64 (pf6: 32, 64, 128), M = 1, 7,
    8, 9, 64, on a TMA shape (N % 16 == 0) and on a ragged one (N = 1000:
    plain copies; K no multiple of the block)."""
    for block in _tc_blocks(transport):
        for K, N in ((520, 1040), (200, 1000)):
            w = _packed_as(K, N, fmt, transport, block, scale, block + N,
                           cuda)
            decode = dm.sad_decode_params(w)[0]
            assert dm.gemv_route(decode, block) == "tc"
            for M in (1, 7, 8, 9, 64):
                x = _x(M, K, M + block, cuda)
                dm.reset_launch_counts()
                got = dm.dequant_gemv(x, w)
                want = dm.dequant_matmul_reference(x, w)
                torch.cuda.synchronize()
                assert dm.launch_counts[f"dequant_gemv_{decode}"] == 1
                assert sum(dm.launch_counts.values()) == 1
                assert _rel(got, want) < 1e-5, (fmt, block, K, N, M)


# (format, transport, block) at the blocks where gemv_route names the
# CUDA-core kernel ("_cc") and at other packer blocks of the tc kernel
GEMV_ROUTE_BLOCKS = [("fp6_e3m2", "emi8", 8), ("fp6_e3m2", "emi8", 48),
                     ("int4", "sb4", 2), ("int4", "sb4", 8),
                     ("int2", "sb2", 4), ("int2", "sb2", 48),
                     ("int8", "native", 8), ("int8", "native", 2),
                     ("fp8_e4m3", "native", 8), ("fp8_e5m2", "native", 2),
                     ("fp16", "native", 8), ("bfloat16", "native", 8),
                     ("fp4_e2m1", "pf4", 48), ("fp6_e3m2", "pf6", 96),
                     ("fp6_e3m2", "emi8", 256)]


@pytest.mark.parametrize("fmt,transport,block", GEMV_ROUTE_BLOCKS)
def test_every_gemv_route_block_runs_its_kernel(cuda, fmt, transport, block):
    K, N = 4 * block if block >= 64 else 480, 528
    w = _packed_as(K, N, fmt, transport, block,
                   8.0 if fmt == "bfloat16" else 1.0, block, cuda)
    decode = dm.sad_decode_params(w)[0]
    counter = dm.gemv_counter(decode, block)
    assert counter.endswith("_cc") == (block % 16 != 0)
    for M in (1, 8, 64):
        x = _x(M, K, M, cuda)
        dm.reset_launch_counts()
        got = dm.dequant_gemv(x, w)
        want = dm.dequant_matmul_reference(x, w)
        torch.cuda.synchronize()
        assert dm.launch_counts[counter] == 1
        assert sum(dm.launch_counts.values()) == 1
        assert _rel(got, want) < 1e-5, (fmt, block, M)


@pytest.mark.parametrize("fmt,transport,scale", TC_GEMV_DECODES)
@pytest.mark.parametrize("side", ["low", "high"])
def test_tc_gemv_at_the_scale_clamps(cuda, fmt, transport, scale, side):
    """Block exponents -128..-120 (the scale clamps to 2^-126, as the TPU
    kernel's _exp2_i32) and 118..127 (the largest scales), against the
    unscaled decoded weight times the clamped scales, in float64; x scaled
    so that the sums stay normal floats."""
    K, N, M, block = 256, 528, 8, 32
    w = _packed_as(K, N, fmt, transport, block, scale, 5, cuda)
    decode, fold, _, _ = dm.sad_decode_params(w)
    lo, hi = (-128, -119) if side == "low" else (118, 128)
    gen = torch.Generator(device=cuda).manual_seed(6)
    se = torch.randint(lo, hi, w.scale_exp.shape, generator=gen,
                       device=cuda).to(torch.int8)
    unit = dataclasses.replace(w, scale_exp=torch.full_like(w.scale_exp,
                                                            fold))
    U = tpk.dequantize_mx(unit, dtype=torch.bfloat16).double()
    w = dataclasses.replace(w, scale_exp=se.contiguous())
    e = torch.clamp(se.double() - fold, -126, 127).repeat_interleave(block,
                                                                     0)
    x = _x(M, K, 7, cuda) * (2.0 ** (100 if side == "low" else -120))
    xb = x.to(torch.bfloat16).double()
    want = xb @ (U * torch.exp2(e[:K]))
    got = dm.dequant_gemv(x, w)
    assert torch.isfinite(got).all()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("budget", [1, 2, 4, 8, 16])
def test_nb_gemv_matches_twin(cuda, budget):
    """Budgets 1-16 at M = 1, 8, 64, 255, on a TMA shape and at K % 16 !=
    0 (plain copies)."""
    for K, N in ((520, 384), (200, 160)):
        w = _nb_slots(K, N, budget, budget + K, cuda)
        assert w.budget == budget
        for M in (1, 8, 64, 255):
            x = _x(M, K, M, cuda)
            om.reset_launch_counts()
            got = om.dequant_matmul_nb(x, w)
            want = om.dequant_matmul_nb_reference(x, w)
            torch.cuda.synchronize()
            assert om.launch_counts["dequant_gemv_nb"] == 1
            assert _rel(got, want) < 1e-5, (budget, K, M)


@pytest.mark.parametrize("fmt,transport,scale", TC_GEMV_DECODES)
def test_tc_gemv_rows_do_not_depend_on_batch(cuda, fmt, transport, scale):
    w = _packed_as(4096, 1040, fmt, transport, 32, scale, 9, cuda)
    x = _x(64, 4096, 2, cuda)
    full = dm.dequant_gemv(x, w)
    for lo, hi in ((0, 1), (0, 5), (3, 8), (8, 17), (1, 33), (0, 64)):
        assert torch.equal(dm.dequant_gemv(x[lo:hi], w), full[lo:hi])


def test_tc_gemv_plan_and_occupancy_on_the_card(cuda):
    """The C entry refuses a plan whose shared memory is not its own, and
    the card holds one CTA an SM at the main path's plans."""
    w = _packed(4096, 1024, 1, cuda)
    for M in (1, 8, 64):
        plan = dm.gemv_plan("emi8", 1024, 4096, 32, M)
        assert dm.gemv_occupancy("emi8", M, plan["smem_bytes"]) == 1
        nb = om.nb_gemv_plan(28672, 4096, 2, M)
        assert om.nb_gemv_occupancy(M, nb["smem_bytes"]) == 1
    x = _x(8, 4096, 1, cuda).to(torch.bfloat16)
    plan = dm.gemv_plan("emi8", 1024, 4096, 32, 8)
    ws = torch.empty((plan["ksplit"], 8, 1024), device=cuda)
    out = torch.empty((8, 1024), device=cuda)
    err = dm._kernel("dequant_gemv")(
        x.data_ptr(), w.codes.data_ptr(), w.scale_exp.data_ptr(),
        ws.data_ptr(), out.data_ptr(), 8, 4096, 1024, 128, 32, 0, 4, 0, 4,
        plan["ksplit"], plan["split_blocks"], plan["stage_blocks"],
        plan["stages"], plan["ctas"], plan["smem_bytes"] + 128, 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1                         # cudaErrorInvalidValue


def test_tc_gemvs_do_not_spill(cuda):
    from microscopiq_tpu_torch.ops.cuda import build

    build.build_all(("dequant_gemv", "nb_matmul"))
    lines = build.ptxas_report(("dequant_gemv", "nb_matmul"))
    tc = [ln for ln in lines if "gemv_tc" in ln]
    nb = [ln for ln in lines if "nb_gemv" in ln]
    assert len(tc) == 40 and len(nb) == 4     # NT 1, 2, 4, 8 x decodes
    for ln in tc + nb:
        assert "0 bytes spill stores, 0 bytes spill loads" in ln, ln


# ---------------------------------------------------------------------------
# the quantized cache's decode step as CUDA graphs
# ---------------------------------------------------------------------------
def test_quant_graph_decode_is_bit_identical_to_eager(cuda):
    """2 layers of Llama-3-8B at full width (MX-FP6 emi8, the fused decode
    attention), B = 4, a 120-token prompt, 8 greedy steps over the 4-bit
    KIVI cache of chip_smoke's quantized arm (gap 64): the last step folds
    a chunk, and the decode replayed from the plain and the fold graphs
    gives the eager loop's tokens and last logits bit for bit, with its
    launches (the warm-up step's plus each captured step's times its
    replays) equal to the eager loop's; generate's tokens are the same."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.kv.cache import QuantKVConfig

    qcfg = QuantKVConfig(**cs.QKV_CFG)
    model = cs.build(True, layers=2, seed=3)[0]
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (4, 120)), device=cuda)
    info = {}
    cs.reset_counts()
    graph = cs.prefill_decode(model, ids, 8, 192, quant_cfg=qcfg, info=info)
    eager = cs.prefill_decode(model, ids, 8, 192, quant_cfg=qcfg,
                              graph=False)
    torch.cuda.synchronize()
    assert info == {"graph": True, "timed_steps": 7, "fold_replays": 1}
    assert torch.equal(graph[0], eager[0])
    assert torch.equal(graph[3], eager[3])
    assert graph[5] == eager[5] and graph[5]["quant_attention"] == 2 * 8
    st = graph[6]
    assert int(st.length) == st.host_length == 128
    assert torch.equal(st.kq, eager[6].kq) and torch.equal(st.res_k,
                                                           eager[6].res_k)
    got = generate(model, ids.cpu().numpy(), 9, cache_kind="quant",
                   quant_cfg=qcfg, max_len=192)
    want = torch.cat([graph[7][0][:, -1].argmax(-1)[:, None], graph[0]], 1)
    np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.parametrize("kw", [dict(), dict(rank=2), dict(out_k=2),
                                dict(residual_len=3, k_group=4)])
def test_tiny_quant_update_route_graph_is_bit_identical(cuda, kw):
    """LlamaConfig.tiny (head_dim 16: the cache.update route) over quantized
    caches of gap 8, ragged prompts, 20 steps (two folds), GEAR-L
    (rank 2, its QR captured), GEAR-S, a protected residual and sub-chunk
    K groups: generate on the card (plain and fold graphs) gives the
    tokens of the same decode run eagerly step by step."""
    import sys

    from microscopiq_tpu_torch.eval.generate import DecodeStep, generate
    from microscopiq_tpu_torch.kv import cache as kvc
    from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cuda").load_params(
        _tiny_tree(cfg, 3, cuda))
    qcfg = kvc.QuantKVConfig(bits=4, gap=8, v_group=8, **kw)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist()
               for n in (5, 11, 9)]
    got = generate(model, prompts, 20, cache_kind="quant", quant_cfg=qcfg)

    class Eager(DecodeStep):
        def __call__(self):
            return self.eager()

    gen_mod = sys.modules[generate.__module__]
    orig = gen_mod.DecodeStep
    gen_mod.DecodeStep = Eager
    try:
        want = generate(model, prompts, 20, cache_kind="quant",
                        quant_cfg=qcfg)
    finally:
        gen_mod.DecodeStep = orig
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# KV policies, packers and traces on the card (no kernel of their own: their
# PyTorch ops on CUDA tensors against the same calls on the CPU)
# ---------------------------------------------------------------------------
def _h2o_stream(seed, T, B, KVH, hd, budget):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16)
    return (f(T, B, KVH, hd), f(T, B, KVH, hd),
            torch.from_numpy(rng.random((T, B, budget)).astype(np.float32)))


def test_h2o_slot_caches_card_equal_cpu(cuda):
    """Per-slot prefills (one right-padded) and decode steps that evict,
    with an inactive slot: every field equal on the card and the CPU."""
    from microscopiq_tpu_torch.kv import h2o

    L, B, budget, KVH, hd, recent, S = 1, 3, 16, 8, 128, 4, 12
    ks, vs, sc = _h2o_stream(0, 40, B, KVH, hd, budget)
    states = {d: h2o.init_slot_h2o_cache(L, B, budget, KVH, hd,
                                         device=d) for d in ("cpu", cuda)}
    for d in states:
        for b, tl in enumerate((12, 9, 12)):
            c = h2o.SlotH2OPrefillCache(states[d], b, tl)
            c.update(0, ks[:S, b][None].to(d), vs[:S, b][None].to(d),
                     torch.arange(S, device=d)[None], None)
            c.observe(0, sc[b, b:b + 1].to(d))
            states[d] = c.finalize(tl)
        active = torch.tensor([True, True, False], device=d)
        for t in range(S, 40):
            st = states[d]
            c = h2o.SlotH2ODecodeCache(st, active, recent)
            _, _, m = c.update(0, ks[t][:, None].to(d), vs[t][:, None].to(d),
                               st.lengths[:, None], None)
            c.observe(0, sc[t].to(d))
            states[d] = c.finalize()
    for f in ("k", "v", "pos", "score", "lengths"):
        assert torch.equal(getattr(states[cuda], f).cpu(),
                           getattr(states["cpu"], f)), f
    assert int(states["cpu"].pos.max()) == 39         # slots were evicted


def test_h2o_argmin_ties_on_the_card(cuda):
    """torch.argmin on CUDA returns the first minimal index, as on the CPU
    and as jnp.argmin: rows all inf but one, rows of zeros, equal minima,
    at the budgets of the main path."""
    from microscopiq_tpu_torch.kv import h2o

    for budget in (8, 192, 256, 1000):
        score = torch.zeros((6, budget))
        pos = torch.arange(budget).repeat(6, 1)
        pos[0] = budget + 5                              # all protected...
        pos[0, budget // 3] = 0                          # ...but one
        score[2, budget // 2:] = -1.0                    # equal minima
        score[3] = torch.linspace(1, 0, budget)
        score[3, -1] = score[3, 0] = -2.0
        score[4, 5:] = 0.5                               # zeros then halves
        seen = budget + 4
        want = h2o._victims(pos, score, seen, 4)
        got = h2o._victims(pos.to(cuda), score.to(cuda), seen, 4)
        assert torch.equal(got.cpu(), want), budget
        assert want[0] == budget // 3 and want[1] == 0
        assert want[2] == budget // 2 and want[3] == 0 and want[4] == 0


def test_h2o_cache_card_equal_cpu(cuda):
    """H2OCache and QuantH2OCache (4 bits): victims, stores and views on the
    card equal the CPU's, fed the same tokens and scores."""
    from microscopiq_tpu_torch.kv import h2o

    B, KVH, hd, budget, T, S0 = 2, 8, 128, 24, 48, 16
    ks, vs, sc = _h2o_stream(1, T, B, KVH, hd, budget)
    for quant in (False, True):
        out = {}
        for d in ("cpu", cuda):
            st = (h2o.init_quant_h2o_cache(1, B, budget, KVH, hd, bits=4,
                                           device=d) if quant else
                  h2o.init_h2o_cache(1, B, budget, KVH, hd, device=d))
            mk = h2o.QuantH2OCache if quant else h2o.H2OCache
            views = []
            for t0, t1 in [(0, S0)] + [(t, t + 1) for t in range(S0, T)]:
                c = mk(st, 4)
                k, v, _ = c.update(
                    0, ks[t0:t1].transpose(0, 1).to(d),
                    vs[t0:t1].transpose(0, 1).to(d),
                    torch.arange(t0, t1, device=d).expand(B, t1 - t0), None)
                c.observe(0, sc[t0].to(d))
                st = c.finalize()
                views.append(k.float().cpu())
            out[d] = (st, views)
        (sc_, vc), (sg, vg) = out["cpu"], out[cuda]
        assert torch.equal(sg.pos.cpu(), sc_.pos)
        assert torch.equal(sg.score.cpu(), sc_.score)
        assert all(torch.equal(a, b) for a, b in zip(vg, vc))
        assert sg.host_length == int(sg.length) == T


def test_rope_delta_card_equal_cpu(cuda):
    from microscopiq_tpu_torch.kv.sink import _rope_delta

    g = torch.Generator().manual_seed(2)
    k = torch.randn((4, 252, 8, 128), generator=g).to(torch.bfloat16)
    for delta, theta in ((-1.0, 500000.0), (-1.0, 10000.0), (7.0, 1e6)):
        want = _rope_delta(k, delta, theta).float()
        got = _rope_delta(k.to(cuda), delta, theta).float().cpu()
        # cos and sin may differ by an ulp on the card; the bf16 rounding
        # hides it but for a value at a rounding boundary (one bf16 ulp)
        assert ((got - want).abs() <= 2 ** -7 * want.abs().clamp(
            min=2 ** -7)).all()
        assert (got == want).float().mean() > 0.99


def test_packers_round_trip_on_the_card(cuda):
    g = torch.Generator().manual_seed(3)
    for name, lo, hi in (("int4", -8, 7), ("int2", -2, 1)):
        codes = torch.randint(lo, hi + 1, (64, 256), generator=g,
                              dtype=torch.int8)
        pack = getattr(tpk, f"pack_{name}")
        unpack = getattr(tpk, f"unpack_{name}")
        packed = pack(codes.to(cuda))
        assert torch.equal(packed.cpu(), pack(codes))
        assert torch.equal(unpack(packed).cpu(), codes)
    for fmt, nbits in (("fp4_e2m1", 4), ("fp6_e3m2", 6), ("fp6_e2m3", 6)):
        grid = tpk.decode_fp_bits(torch.arange(2 ** nbits,
                                               dtype=torch.uint8), fmt)
        vals = grid[torch.randint(0, 2 ** nbits, (32, 96), generator=g)]
        if nbits == 4:
            packed, back = tpk.pack_fp4(vals.to(cuda)), tpk.unpack_fp4
            assert torch.equal(packed.cpu(), tpk.pack_fp4(vals))
            assert torch.equal(back(packed).cpu(), vals)
        else:
            packed = tpk.pack_fp6(vals.to(cuda), fmt)
            assert torch.equal(packed.cpu(), tpk.pack_fp6(vals, fmt))
            assert torch.equal(tpk.unpack_fp6(packed, fmt).cpu(), vals)


def test_trace_window_whole_and_counts_equal_launches(cuda, tmp_path):
    """trace() around GEMV launches: the filler kept at both ends and left
    out of the stats, the GEMV's events equal to the wrapper's launches,
    the busy time at least the GEMV's and at most the window's."""
    import time

    from microscopiq_tpu_torch.utils import observability as ob

    p = _packed(4096, 4096, 4, cuda)
    x = _x(8, 4096, 5, cuda).to(torch.bfloat16)
    dm.dequant_gemv(x, p, torch.float32)
    torch.cuda.synchronize()
    for n in (5, 40):
        d = str(tmp_path / f"tr{n}")
        dm.reset_launch_counts()
        with ob.trace(d):
            t0 = time.perf_counter()
            for _ in range(n):
                dm.dequant_gemv(x, p, torch.float32)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = sum(dm.launch_counts.values())
        assert launched == n
        stats = ob.device_kernel_stats(d, min_events=launched)
        assert not any(ob.FILLER_KERNEL in k for k in stats)
        gemv = sum(a["count"] for k, a in stats.items() if "gemv_tc" in k)
        assert gemv == launched
        lead, tail = ob.filler_kept(d)
        assert lead > 0 and tail > 0
        busy = ob.device_busy_us(d)
        gemv_us = sum(a["total_us"] for k, a in stats.items()
                      if "gemv_tc" in k)
        assert gemv_us <= busy <= wall_us
        with pytest.raises(AssertionError, match="lost records"):
            ob.device_kernel_stats(d, min_events=sum(
                a["count"] for a in stats.values()) + 1)


@pytest.mark.parametrize("M", [1, 8, 64, 128])
def test_moe_router_n8_runs_its_kernel(cuda, M):
    """Mixtral's router (K = 4096, N = 8 experts) packed MX-FP6 emi8 block
    32: the tensor-core GEMV (plain copies: N % 16 != 0) at M <= 64 and the
    sm90 GEMM above, each launched once and within its tolerance of the
    plain twin."""
    p = _packed(4096, 8, 11, cuda)
    assert not dm.gemv_plan("emi8", 8, 4096, 32, min(M, 64))["tma"]
    assert not dm.sm90_plan("emi8", 4096, 8, 32)["tma"]
    x = _x(M, 4096, 12, cuda).to(torch.bfloat16)
    dm.reset_launch_counts()
    got = dm.dequant_matmul(x, p, torch.float32)
    want = dm.dequant_matmul_reference(x, p, torch.float32)
    counter = "dequant_gemv_emi8" if M <= dm.GEMV_MAX_M else \
        "dequant_matmul_emi8"
    assert {k: v for k, v in dm.launch_counts.items() if v} == {counter: 1}
    assert got.shape == (M, 8)
    assert _rel(got, want) < (1e-5 if M <= dm.GEMV_MAX_M else 2e-3)


def test_alibi_attention_matches_cpu(cuda):
    """MPT's ALiBi attention (tiny MPT, float32, the dense KV cache): the
    prefill and three decode steps on the card within 1e-4 of max |logit|
    of the same model on the CPU."""
    from microscopiq_tpu_torch.kv.cache import (DenseDecodeCache,
                                                init_dense_cache)
    from microscopiq_tpu_torch.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM,
                                                    build_params)

    cfg = LlamaConfig.tiny_mpt()
    tree = build_params(cfg, seed=3, device="cpu")
    to_cuda = lambda t: ({k: to_cuda(v) for k, v in t.items()}
                         if isinstance(t, dict) else t.to(cuda))
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, 12)))
    outs = []
    for dev, params in (("cpu", tree), (cuda, to_cuda(tree))):
        m = LlamaForCausalLM(cfg, device=dev).load_params(params)
        st = init_dense_cache(2, 2, 32, cfg.num_key_value_heads,
                              cfg.head_dim, dtype=torch.float32, device=dev)
        logits = []
        with torch.inference_mode():
            x = ids.to(dev)
            for t0, t1 in ((0, 9), (9, 10), (10, 11), (11, 12)):
                c = DenseDecodeCache(st)
                pos = torch.arange(t0, t1, device=dev)[None].expand(2, -1)
                logits.append(m(x[:, t0:t1], positions=pos, cache=c
                                ).float().cpu())
                st = c.finalize()
            logits.append(m(x).float().cpu())
        outs.append(torch.cat([l.reshape(-1) for l in logits]))
    assert _rel(outs[1], outs[0]) < 1e-4


def test_safetensors_reader_onto_the_card(cuda, tmp_path):
    """read_safetensors / load_hf_state_dict straight onto the card: F32,
    F16 and BF16 tensors bit for bit, float32 out of the loader."""
    import json
    import struct

    from microscopiq_tpu_torch.models import loading

    g = torch.Generator().manual_seed(0)
    ts = {"a": torch.randn(4, 6, generator=g),
          "b": torch.randn(7, generator=g).half(),
          "c": torch.randn(3, 5, generator=g).bfloat16()}
    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, blobs, at = {}, [], 0
    for k, v in ts.items():
        b = v.contiguous().view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": names[v.dtype], "shape": list(v.shape),
                     "data_offsets": [at, at + len(b)]}
        blobs.append(b)
        at += len(b)
    h = json.dumps(header).encode()
    with open(tmp_path / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))
    got = loading.read_safetensors(str(tmp_path / "model.safetensors"),
                                   device=cuda)
    for k, v in ts.items():
        assert got[k].is_cuda and got[k].dtype == v.dtype
        assert torch.equal(got[k].cpu().view(torch.uint8),
                           v.view(torch.uint8))
    state = loading.load_hf_state_dict(str(tmp_path), device=cuda)
    for k, v in ts.items():
        assert state[k].is_cuda and state[k].dtype == torch.float32
        assert torch.equal(state[k].cpu(), v.float())


# ---------------------------------------------------------------------------
# the MX fake-quant layers (the training path): the quantizers on the card
# bit for bit against the CPU, and mx_linear's backward against its formula


def _mx_specs(qbp=True, **kw):
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    return finalize_mx_specs(dict(dict(
        w_elem_format="fp6_e3m2", a_elem_format="fp6_e3m2", scale_bits=4,
        block_size=32, bfloat=16, quantize_backprop=qbp), **kw))


def _mx_input(seed, shape=(256, 512), span=10):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-span, span, shape))
         ).astype(np.float32)
    x.flat[:6] = [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-42]
    return torch.from_numpy(x)


def _same_bits(a, b):
    """Bit for bit, NaN equal to NaN (the devices propagate NaN payloads
    and signs differently)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a) & torch.isnan(b)
    return not bool(((a.view(torch.int32) != b.view(torch.int32))
                     & ~nan).any())


@pytest.mark.parametrize("round", ["nearest", "floor", "even"])
@pytest.mark.parametrize("knob", [{"bfloat": 16}, {"fp": 16},
                                  {"bfloat": 12, "bfloat_subnorms": False}])
def test_mx_quantize_elemwise_op_card_is_cpu(cuda, round, knob):
    from microscopiq_tpu_torch.ops.elemwise import quantize_elemwise_op
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    s = finalize_mx_specs(dict(knob, w_elem_format="int8"))
    x = _mx_input(1)
    assert _same_bits(quantize_elemwise_op(x.to(cuda), s, round=round),
                      quantize_elemwise_op(x, s, round=round))


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1", "int4", "int8",
                                 "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("axes", [[-1], [0]])
def test_mx_quantize_mx_op_card_is_cpu(cuda, fmt, axes):
    from microscopiq_tpu_torch.ops.mx import quantize_mx_op

    x = _mx_input(2, span=4)
    for s in (_mx_specs(scale_bits=8), _mx_specs()):
        assert _same_bits(quantize_mx_op(x.to(cuda), s, fmt, axes=axes),
                          quantize_mx_op(x, s, fmt, axes=axes))


@pytest.mark.parametrize("fmts", [("fp6_e3m2", "fp6_e3m2"),
                                  ("int4", "fp8_e4m3"), ("int2", "fp4_e2m1")])
def test_mx_quantize_mx_outlier_op_card_is_cpu(cuda, fmts):
    from microscopiq_tpu_torch.ops.outlier import quantize_mx_outlier_op

    s = _mx_specs()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, 512)).astype(np.float32))
    f = lambda t: quantize_mx_outlier_op(t, s, *fmts, axes=[-1])
    assert _same_bits(f(x.to(cuda)), f(x))


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "int4", "bfloat16"])
def test_mx_dither_with_given_draws_card_is_cpu(cuda, fmt):
    from microscopiq_tpu_torch.formats import get_format_params
    from microscopiq_tpu_torch.ops.elemwise import quantize_elemwise_core

    ebits, mbits, _, max_norm, _ = get_format_params(fmt)
    x = _mx_input(4)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(4))
    f = lambda t: quantize_elemwise_core(t, mbits, ebits, max_norm,
                                         "dither", rand=u.to(t.device))
    assert _same_bits(f(x.to(cuda)), f(x))


@pytest.mark.parametrize("qbp", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_mx_linear_backward_on_card_is_its_formula(cuda, qbp, bias):
    """grad_in, grad_w and grad_b of nn.mx_linear through torch.autograd on
    the card, against nn/linear.py's backward formula
    (``mx_linear_backward``, which the CPU tests hold to JAX's VJP) on the
    operands its forward saves: the bfloat-quantized ones under
    quantize_backprop, else the raw ones. Within 1e-6 of max."""
    from microscopiq_tpu_torch.nn import mx_linear
    from microscopiq_tpu_torch.nn.linear import (mx_linear_backward,
                                                 mx_linear_forward)

    s = _mx_specs(qbp, scale_bits=8)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 64, 512, generator=gen, device=cuda,
                    requires_grad=True)
    w = (torch.randn(768, 512, generator=gen, device=cuda) * 0.05
         ).requires_grad_()
    b = (torch.randn(768, generator=gen, device=cuda) if bias else None)
    if b is not None:
        b.requires_grad_()
    g = torch.randn(2, 64, 768, generator=gen, device=cuda)
    mx_linear(x, w, b, s).backward(g)

    xs, ws = x.detach(), w.detach()
    if qbp:
        _, xs, ws = mx_linear_forward(xs, ws, None, s)
    want_in, want_w, want_b = mx_linear_backward(g, xs, ws, bias, s)
    pairs = [(w.grad, want_w), (x.grad, want_in)]
    if bias:
        pairs.append((b.grad, want_b))
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), err


def test_mx_ffn_trains_on_the_card(cuda):
    """scripts.mx_ffn, 20 steps from one numpy start on the card against
    the CPU: the mse within 1% each step."""
    from microscopiq_tpu_torch.scripts import mx_ffn

    start = mx_ffn.numpy_start(64, 3, rows=128)
    card = mx_ffn.train(start, 20, device=cuda)
    cpu = mx_ffn.train(start, 20, device="cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-2)
    assert card[-1] < card[0]


# ---------------------------------------------------------------------------
# Posit, VQ and the tensor-parallel wrappers (slice 19)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nbits,es", [(8, 0), (8, 1), (8, 2), (16, 1),
                                      (16, 2)])
def test_posit_card_equals_cpu_bit_for_bit(cuda, nbits, es):
    """Codes, fake-quant values, decoded values and the sigmoid of seeded
    values (ties, +-0, NaN, +-inf, past maxpos, below minpos) on the card
    equal the CPU's, NaN as NaN."""
    from microscopiq_tpu_torch import posit

    vals = posit.posit_table(nbits, es)
    v = np.sort(vals[~np.isnan(vals)])
    x = np.concatenate([
        v, (v[1:] + v[:-1]) / 2,
        np.random.default_rng(0).standard_normal(8192) * 10,
        [0.0, -0.0, np.nan, np.inf, -np.inf, v[-1] * 4, v[v > 0][0] / 4]
    ]).astype(np.float32)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(cuda)

    def same(a, b):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            a, b = a[~torch.isnan(a)], b[~torch.isnan(b)]
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a.to(torch.int64), b.to(torch.int64))

    same(posit.quantize_posit(xg, nbits, es), posit.quantize_posit(xc, nbits,
                                                                   es))
    cg, cc = posit.encode_posit(xg, nbits, es), posit.encode_posit(xc, nbits,
                                                                   es)
    same(cg, cc)
    same(posit.decode_posit(cg, nbits, es), posit.decode_posit(cc, nbits,
                                                               es))
    same(posit.posit_sigmoid(xg, nbits, es), posit.posit_sigmoid(xc, nbits,
                                                                 es))
    same(posit.posit_mul(xg, xg.flip(0), nbits, es),
         posit.posit_mul(xc, xc.flip(0), nbits, es))


def test_vq_assignments_on_the_card(cuda):
    """get_assignments and a k-means from the CPU's draws on the card: the
    assignments as the CPU's (>= 99.9% on a 2^18-point set); the k-means++
    centroids within 1e-5, the EM's within 1e-3 (the card's ``index_add_``
    sums each cluster by atomics in another order, and the points it
    reassigns at the margins move a centroid by ~1e-4)."""
    from microscopiq_tpu_torch.quant import vq

    g = torch.Generator().manual_seed(0)
    X = torch.randn((1 << 18, 2), generator=g)
    C = torch.randn((64, 2), generator=g)
    W = torch.rand((1 << 18, 2), generator=g) + 0.5
    for w in (None, W):
        a = vq.get_assignments(X, C, w, chunk=1 << 16)
        b = vq.get_assignments(X.to(cuda), C.to(cuda),
                               None if w is None else w.to(cuda)).cpu()
        assert (a == b).float().mean() >= 0.999
    c_cpu, draws = vq.kpp_init(X, 16, torch.Generator().manual_seed(1),
                               return_draws=True)
    c_card = vq.kpp_init(X.to(cuda), 16, draws=draws)
    assert float((c_card.cpu() - c_cpu).abs().max()) <= 1e-5
    cc, ac = vq.kmeans_vq(X, 16, 5, draws=draws)
    cg, ag = vq.kmeans_vq(X.to(cuda), 16, 5, draws=draws)
    assert (ac == ag.cpu()).float().mean() >= 0.999
    assert float((cg.cpu() - cc).abs().max()) <= 1e-3


@pytest.fixture
def nccl_world1(cuda):
    """A one-rank NCCL group (the degenerate mesh), torn down after."""
    import socket

    import torch.distributed as dist

    from microscopiq_tpu_torch.parallel import distributed as dd

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dd.init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    yield cuda
    dist.destroy_process_group()


def test_tp_wrappers_at_world1_over_nccl(nccl_world1):
    """tp_dequant_matmul (GEMV and GEMM) and tp_quant_attention_decode on
    the (1, 1) mesh launch their kernels and meet their bounds (GEMV 1e-5,
    GEMM 2e-3, attention 2e-2 of max)."""
    from microscopiq_tpu_torch.scripts import check_tp

    rec = check_tp.check(nccl_world1, 1)
    assert rec["gemv_rel_err"] <= check_tp.GEMV_TOL
    assert rec["gemm_rel_err"] <= check_tp.GEMM_TOL
    assert rec["attention_rel_err"] <= check_tp.ATTN_TOL
    assert rec["launches"]["dequant_gemv_emi8"] == 1
    assert rec["launches"]["dequant_matmul_emi8"] == 1
    assert rec["launches"]["quant_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tp_wrappers_dense_row_partial_in_float32(cuda, dtype):
    """A dense half-precision row-parallel partial product (QLinear's
    float32 product) multiplies on the tensor cores and returns the
    accumulator unrounded: within f32 sums of the exact product, its dtype
    float32, not rounded to ``dtype``."""
    from microscopiq_tpu_torch.models.llama import QLinear

    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(3, 5, 2048, generator=g, device=cuda).to(dtype)
    w = (torch.randn(2048, 4096, generator=g, device=cuda) * 0.02).to(dtype)
    lin = QLinear(dtype)
    lin.kernel = w
    y = lin._product(x, torch.float32)
    want = (x.double() @ w.double())
    assert y.dtype == torch.float32 and y.shape == (3, 5, 4096)
    assert float((y.double() - want).abs().max()
                 / want.abs().max()) <= 1e-5
    # unrounded: most values are no half-precision number
    assert float((y.to(dtype).float() != y).float().mean()) > 0.5
