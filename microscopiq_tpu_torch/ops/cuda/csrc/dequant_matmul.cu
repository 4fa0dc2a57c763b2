// Tiled GEMM with the emi8 MX decode inside the kernel: y = x @ dequant(W)
// for M > 64 tokens.
//
// Replaces the emi8 serving-layout branch of
// microscopiq_tpu/ops/pallas/dequant_matmul.py::_dq_matmul_kernel (launched
// from dequant_matmul). It carries every linear of a prefill of more than 64
// tokens (the bench shape is M = 8 x 128 = 1024).
//
// What bounds it on the H100: operations. At M = 1024 each weight byte feeds
// 2048 flops, far above the ~295 flop/byte balance point, so the bound is
// 2*M*N*K / 989 TFLOP/s (bf16 tensor cores, dense).
//
// Design (simple and right first; wgmma/TMA and a cp.async pipeline are later
// work):
// - the bf16 wmma tile loop of common.cuh (128 x 128 output tile per block
//   of 8 warps, 32-deep K steps);
// - per K step the block stages x (bf16, straight copy) and the
//   codes in shared memory; codes and their exponents are decoded on the way
//   in as m̂·2^e' · 2^(se - fold) and stored as bf16. The product has at
//   most 3 significant bits times a power of two, so it is exact in bf16 and
//   matches the JAX kernel's bf16 tile bit for bit.
// - codes (NB, B, N) are read as the flat (NB*B, N) matrix they are in
//   memory; row k's exponent row is k / B.
// - ragged M, N and K are masked: x columns k >= K and rows m >= M load as
//   zeros, code columns n >= N decode to zero, and the epilogue stores only
//   in-range elements. 16-byte vector loads are used when N % 16 == 0 and
//   K % 8 == 0, element loads otherwise.
#include "common.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

__device__ __forceinline__ float decode_emi8(int c, int mw) {
  const int sh = 8 - mw;
  const int mhat = c >> sh;
  const int ep = c & ((1 << sh) - 1);
  return static_cast<float>(mhat * (1 << ep));
}

__global__ void __launch_bounds__(mxq::kGemmThreads)
gemm_emi8(const __nv_bfloat16* __restrict__ x,
          const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
          void* out, int M, int K, int N, int Kp, int B, int mw, int fold,
          int out_bf16) {
  const bool nvec = (N % 16) == 0;
  // B tile: thread -> row tid/8, 16 columns
  const int b_r = threadIdx.x >> 3, b_c = (threadIdx.x & 7) * 16;
  const int n_blk = blockIdx.x * mxq::kGemmBN;
  auto decode = [&](BTile Bs, int k0) {
    const int gk = k0 + b_r;
    const int gn = n_blk + b_c;
    float w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = 0.f;
    if (gk < Kp) {
      const int8_t* crow = codes + static_cast<size_t>(gk) * N;
      const int8_t* srow = se + static_cast<size_t>(gk / B) * N;
      if (nvec) {
        if (gn < N) {
          const int4 cv = __ldg(reinterpret_cast<const int4*>(crow + gn));
          const int4 sv = __ldg(reinterpret_cast<const int4*>(srow + gn));
          const int8_t* cb = reinterpret_cast<const int8_t*>(&cv);
          const int8_t* sb = reinterpret_cast<const int8_t*>(&sv);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            w[j] = decode_emi8(cb[j], mw) *
                   exp2_i32(static_cast<int>(sb[j]) - fold);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gn + j < N)
            w[j] = decode_emi8(crow[gn + j], mw) *
                   exp2_i32(static_cast<int>(srow[gn + j]) - fold);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[b_r][b_c + j] = __float2bfloat16(w[j]);
  };
  mxq::gemm_tile(x, out, M, K, N, Kp, out_bf16, decode);
}

}  // namespace

// x: (M, K) bf16; codes: (NB, B, N) int8 with Kp = NB * B >= K;
// se: (NB, N) int8; out: (M, N) bf16 or f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dequant_matmul_emi8(const void* x, const void* codes,
                                   const void* se, void* out, int M, int K,
                                   int N, int Kp, int B, int mw, int fold,
                                   int out_bf16, void* stream) {
  gemm_emi8<<<mxq::gemm_grid(M, N), mxq::kGemmThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const int8_t*>(se), out, M, K, N, Kp, B, mw, fold, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
