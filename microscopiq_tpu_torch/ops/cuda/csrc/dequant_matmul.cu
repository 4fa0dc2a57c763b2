// Tiled GEMM with the MX decode inside the kernel: y = x @ dequant(W) for
// M > 64 tokens.
//
// Replaces the serving-layout branches of
// microscopiq_tpu/ops/pallas/dequant_matmul.py::_dq_matmul_kernel (emi8,
// emi8m and the int8 container, launched from dequant_matmul) and its legacy
// `native2d` branch: 2-D (K, N) int8 and float8 (e4m3, e5m2) codes reach the
// (NB, B, N) serving layout by a view (packing.to_serving_layout, no copy),
// so this same kernel serves them; serving-layout float8 codes, which the
// JAX package sends to XLA, come here too. Float8 codes decode exactly to
// f16 in hardware (common.cuh's decode_fp8). The sb4, sb2, pf4, pf6, bf16
// and fp16 transports, which the
// JAX package sends to XLA's dequantize-then-dot at this size, come here too
// with their own B-tile decode. It carries every linear of a prefill of more
// than 64 tokens (the bench shape is M = 8 x 128 = 1024).
//
// What bounds it on the H100: operations. At M = 1024 each weight byte feeds
// at least 1024 flops, far above the ~295 flop/byte balance point, so the
// bound is 2*M*N*K / 989 TFLOP/s (bf16 tensor cores, dense).
//
// Design (simple and right first; wgmma/TMA and a cp.async pipeline are later
// work):
// - the bf16 wmma tile loop of common.cuh (128 x 128 output tile per block
//   of 8 warps, 32-deep K steps);
// - per K step the block stages x (bf16, straight copy) and decodes the
//   weights into shared memory: K row k of the tile is block k / B, row
//   j = k % B of it, which sits in field j / (B/F) of packed row j % (B/F)
//   (common.cuh's decode_row; the codes are not a flat (K, N) matrix when a
//   packed row holds several K rows). Each decoded code is multiplied by
//   2^(se - fold) and stored as bf16. Integer codes have at most 7
//   significant bits (pf6: 3, float8: 4) and bf16/fp16 containers are
//   rounded to bf16 first, so the product is exact in bf16 and matches the
//   plain twin's
//   dequantized bf16 weight bit for bit.
// - ragged M, N and K are masked: x columns k >= K and rows m >= M load as
//   zeros, code columns n >= N decode to zero, and the epilogue stores only
//   in-range elements. 16-byte vector loads are used when N % 16 == 0 and
//   K % 8 == 0, element loads otherwise.
#include "common.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

template <int D>
__global__ void __launch_bounds__(mxq::kGemmThreads)
gemm_dq(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
        const int8_t* __restrict__ se, void* out, int M, int K, int N, int Kp,
        int B, int mw, int ebits, int fold, int out_bf16) {
  constexpr int F = mxq::fields<D>();
  const bool nvec = (N % 16) == 0;
  const int per = B / F;
  // B tile: thread -> row tid/8, 16 columns
  const int b_r = threadIdx.x >> 3, b_c = (threadIdx.x & 7) * 16;
  const int n_blk = blockIdx.x * mxq::kGemmBN;
  auto decode = [&](BTile Bs, int k0) {
    const int gk = k0 + b_r;
    const int gn = n_blk + b_c;
    float w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = 0.f;
    if (gk < Kp && gn < N) {
      const int nb = gk / B, j = gk - nb * B;
      const int f = j / per;
      // the exponents' load is issued before the codes' so that both are in
      // flight together
      const int8_t* srow = se + static_cast<size_t>(nb) * N;
      int4 sv = make_int4(0, 0, 0, 0);
      if (nvec) sv = __ldg(reinterpret_cast<const int4*>(srow + gn));
      mxq::decode_row<D, 16>(codes, nb, j - f * per, f, B, gn, N, nvec, mw,
                             ebits, w);
      if (nvec) {
        const int8_t* sb = reinterpret_cast<const int8_t*>(&sv);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] *= exp2_i32(static_cast<int>(sb[i]) - fold);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (gn + i < N) w[i] *= exp2_i32(static_cast<int>(srow[gn + i]) - fold);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[b_r][b_c + j] = __float2bfloat16(w[j]);
  };
  mxq::gemm_tile(x, out, M, K, N, Kp, out_bf16, decode);
}

}  // namespace

// x: (M, K) bf16; codes: (NB, rows, N) in the transport's container, with
// Kp = NB * B >= K; se: (NB, N) int8; out: (M, N) bf16 or f32; decode: an
// mxq::Decode. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an unknown decode).
extern "C" int dequant_matmul(const void* x, const void* codes,
                              const void* se, void* out, int M, int K, int N,
                              int Kp, int B, int decode, int mw, int ebits,
                              int fold, int out_bf16, void* stream) {
  const dim3 grid = mxq::gemm_grid(M, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
#define MXQ_GEMM(D)                                                     \
  gemm_dq<D><<<grid, mxq::kGemmThreads, 0, st>>>(xp, cp, sp, out, M, K, N, \
                                                 Kp, B, mw, ebits, fold,  \
                                                 out_bf16)
  switch (decode) {
    case mxq::kEmi8: MXQ_GEMM(mxq::kEmi8); break;
    case mxq::kInt8: MXQ_GEMM(mxq::kInt8); break;
    case mxq::kSb4: MXQ_GEMM(mxq::kSb4); break;
    case mxq::kSb2: MXQ_GEMM(mxq::kSb2); break;
    case mxq::kPf4: MXQ_GEMM(mxq::kPf4); break;
    case mxq::kPf6: MXQ_GEMM(mxq::kPf6); break;
    case mxq::kBf16: MXQ_GEMM(mxq::kBf16); break;
    case mxq::kFp16: MXQ_GEMM(mxq::kFp16); break;
    case mxq::kFp8E4m3: MXQ_GEMM(mxq::kFp8E4m3); break;
    case mxq::kFp8E5m2: MXQ_GEMM(mxq::kFp8E5m2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_GEMM
  return static_cast<int>(cudaGetLastError());
}
