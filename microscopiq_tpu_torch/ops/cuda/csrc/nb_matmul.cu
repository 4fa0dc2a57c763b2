// Compact int2 + fp4 outlier matmuls over the N-blocked transport:
// y = x @ W^T with W the (N, K) weight of a PackedOutlierNB. Two kernels:
// - dequant_gemv_nb, for M < 256 tokens: every linear of a decode step of
//   the compact MicroScopiQ format, the last_only lm_head and engine
//   prefills;
// - dequant_gemm_nb, for M >= 256: every linear of a long prefill.
//
// Both replace microscopiq_tpu/ops/pallas/dequant_matmul.py::_nb_kernel
// (wrapper dequant_matmul_nb). The JAX QLinear sends 256 tokens and more to
// a plain dequantize-then-matmul in XLA; here the same token count chooses
// between the two hand-written kernels.
//
// Storage (block 16 along N, K contiguous):
// - codes (Np/4, K) int8: byte row 4b + r of N-block b holds the int2
//   inlier codes of rows 16b + r + 4i at bits 2i (i = 0..3), sign-extended;
// - se, seo (NB, K) int8: level-1 (inlier) and level-2 (outlier) exponents;
// - ob (budget, NB, K) int8: pos << 4 | fp4 bits (s e e m); an empty slot
//   is byte 0, which decodes to +0.
// W[16b + j, k] = int2 · 2^(se - fold), plus at row j = pos of each slot the
// fp4 value sign·(m + 2·min(e,1)) << max(e-1,0) times 2^(seo - se - 1)
// (the -1 is fp4's grid step). Both exponents go through exp2_i32, which
// clamps to [-126, 127] as the TPU kernel's _exp2_i32 does. Inliers at
// outlier rows are zero, so each weight is exact in f32 (and in bf16), and
// each product with the bf16 x is exact: the kernels and their plain twin
// differ only in the order of the f32 sums.
//
// What bounds the GEMV on the H100: bytes. At budget 2 a weight costs 0.5
// byte (2 bits of code, 2 x 8 bits of exponents and 2 x 8 bits of slot
// bytes per 16 weights); at M = 8 every byte feeds 64 flops, far below the
// ~295 flop/byte balance point. The bound is (weight bytes + x + out) /
// 3.35 TB/s. The GEMM at M = 1024 does 4096 flops per weight byte: the bound
// is 2*M*N*K / 989 TFLOP/s (bf16 tensor cores).
//
// GEMV design (simple and right first):
// - one block of 128 threads per (N-block b, K-split, M-tile). A thread owns
//   groups of 4 consecutive columns k, strided by 128 groups, so a warp's
//   loads of a code row, of se/seo and of each slot row are 128 contiguous
//   bytes (one 32-bit load per thread); x[m, k..k+3] comes from L2 as 8
//   bytes a row.
// - the thread decodes the 16 weights of each column in registers and adds
//   x[m, k]·w into MT x 16 f32 sums (MT rows of x per block).
// - the 128 threads' sums are reduced by warp shuffles in a fixed butterfly
//   and then over the 4 warps in order; each K-split writes an f32 partial
//   and split_reduce adds the partials in split order. The split count
//   depends on (NB, K) only, never on M, so a row's result does not depend
//   on the batch it came in (the engine then matches single-sequence decode).
// - N is padded to a multiple of 16 in storage; the reduce writes only the
//   orig_n real columns.
//
// GEMM design: the bf16 wmma tile loop of common.cuh (128 x 128 output
// tile, 32-deep K steps). Per K step warp w decodes N-block (tile's 8
// blocks) w and lane l column k0 + l: 16 weights in registers, written to
// the shared B tile as two 16-byte rows of bf16; the decoded tile then
// serves all 128 rows of x. Weights are exact in bf16, so the tensor cores
// see the twin's weights; their f32 accumulation differs from a CUDA-core
// sum in order and internal rounding (the emi8 GEMM's 2e-3 tolerance).
#include "common.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                     // N-block

// fp4 e2m1 bits (s e e m) -> signed integer value 2·fp4 (exact).
__device__ __forceinline__ float fp4_twice(int b) {
  const int e = (b >> 1) & 3, m = b & 1;
  const int mag = (m + 2 * min(e, 1)) << max(e - 1, 0);
  return static_cast<float>((b & 8) ? -mag : mag);
}

__device__ __forceinline__ int byte_of(uint32_t word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xFF));
}

// The 16 weights of one column of an N-block: c0..c3 are its 4 code bytes
// (rows r, r + 4, r + 8, r + 12 at bits 2i of byte r), s_in / s_out its se
// and seo, slot s's byte at ob[s * nbk].
__device__ __forceinline__ void decode_column(int c0, int c1, int c2, int c3,
                                              int s_in, int s_out,
                                              const int8_t* ob, size_t nbk,
                                              int budget, int fold,
                                              float (&w)[kRows]) {
  const float sc = exp2_i32(s_in - fold);
  const int c[4] = {c0, c1, c2, c3};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[r + 4 * i] = static_cast<float>(
          static_cast<int>(static_cast<uint32_t>(c[r]) << (30 - 2 * i)) >> 30)
          * sc;
  // 2^(seo - se - 1) · (2·fp4): the slot's value
  const float osc = exp2_i32(s_out - s_in - 1);
  for (int s = 0; s < budget; ++s) {
    const int byte = static_cast<int>(static_cast<uint8_t>(__ldg(ob + s * nbk)));
    const int pos = byte >> 4;
    const float val = fp4_twice(byte & 0xF) * osc;
#pragma unroll
    for (int j = 0; j < kRows; ++j) w[j] += (j == pos) ? val : 0.f;
  }
}

// grid: (NB, ksplit, ceil(M / MT)); ws: (ksplit, M, Np) f32 partials.
template <int MT>
__global__ void __launch_bounds__(kThreads)
nb_partial(const __nv_bfloat16* __restrict__ x,
           const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
           const int8_t* __restrict__ seo, const int8_t* __restrict__ ob,
           float* __restrict__ ws, int M, int K, int Np, int NB, int budget,
           int fold, int groups_per_split) {
  __shared__ float red[kWarps][MT * kRows];
  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int ngroups = (K + 3) / 4;
  const int g_end = min(ngroups, (split + 1) * groups_per_split);
  const bool vec = (K % 4) == 0;
  const size_t nbk = static_cast<size_t>(NB) * K;

  float acc[MT][kRows];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[m][j] = 0.f;

  for (int g = split * groups_per_split + threadIdx.x; g < g_end;
       g += kThreads) {
    const int k0 = 4 * g;
    uint32_t cw[4], sw, ow;
    const size_t bk = static_cast<size_t>(b) * K + k0;
    if (vec) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cw[r] = __ldg(reinterpret_cast<const uint32_t*>(
            codes + (static_cast<size_t>(4 * b + r)) * K + k0));
      sw = __ldg(reinterpret_cast<const uint32_t*>(se + bk));
      ow = __ldg(reinterpret_cast<const uint32_t*>(seo + bk));
    } else {
      sw = ow = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) cw[r] = 0;
      for (int kk = 0; kk < 4 && k0 + kk < K; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cw[r] |= static_cast<uint32_t>(static_cast<uint8_t>(
                       codes[static_cast<size_t>(4 * b + r) * K + k0 + kk]))
                   << (8 * kk);
        sw |= static_cast<uint32_t>(static_cast<uint8_t>(se[bk + kk])) << (8 * kk);
        ow |= static_cast<uint32_t>(static_cast<uint8_t>(seo[bk + kk])) << (8 * kk);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      if (k >= K) break;
      float w[kRows];
      decode_column(byte_of(cw[0], kk), byte_of(cw[1], kk), byte_of(cw[2], kk),
                    byte_of(cw[3], kk), byte_of(sw, kk), byte_of(ow, kk),
                    ob + bk + kk, nbk, budget, fold, w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = (m0 + m < M)
            ? __bfloat162float(x[static_cast<size_t>(m0 + m) * K + k])
            : 0.f;
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
    }
  }

  // fixed-order reduction: butterfly within each warp, then warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][m * kRows + j] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kRows; i += kThreads) {
    const int m = i / kRows, j = i - m * kRows;
    if (m0 + m >= M) continue;
    float v = red[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][i];
    ws[(static_cast<size_t>(split) * M + m0 + m) * Np + kRows * b + j] = v;
  }
}

// grid: mxq::gemm_grid(M, N); warp w of the block decodes N-block
// n_blk/16 + w of each K step, lane l its column k0 + l.
__global__ void __launch_bounds__(mxq::kGemmThreads)
nb_gemm(const __nv_bfloat16* __restrict__ x,
        const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
        const int8_t* __restrict__ seo, const int8_t* __restrict__ ob,
        void* out, int M, int K, int N, int NB, int budget, int fold,
        int out_bf16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (mxq::kGemmBN / kRows) + warp;
  const size_t nbk = static_cast<size_t>(NB) * K;
  auto decode = [&](BTile Bs, int k0) {
    const int k = k0 + lane;
    float w[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) w[j] = 0.f;
    if (b < NB && k < K) {
      const size_t bk = static_cast<size_t>(b) * K + k;
      const int8_t* cr = codes + static_cast<size_t>(4 * b) * K + k;
      decode_column(__ldg(cr), __ldg(cr + K), __ldg(cr + 2 * K),
                    __ldg(cr + 3 * K), __ldg(se + bk), __ldg(seo + bk),
                    ob + bk, nbk, budget, fold, w);
    }
    uint32_t u[kRows / 2];
#pragma unroll
    for (int j = 0; j < kRows / 2; ++j) {
      __nv_bfloat162 h = __floats2bfloat162_rn(w[2 * j], w[2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    uint4* dst = reinterpret_cast<uint4*>(&Bs[lane][kRows * warp]);
    dst[0] = make_uint4(u[0], u[1], u[2], u[3]);
    dst[1] = make_uint4(u[4], u[5], u[6], u[7]);
  };
  mxq::gemm_tile(x, out, M, K, N, K, out_bf16, decode);
}

template <int MT>
void launch_partial(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                    const int8_t* codes, const int8_t* se, const int8_t* seo,
                    const int8_t* ob, float* ws, int M, int K, int Np, int NB,
                    int budget, int fold, int gps) {
  nb_partial<MT><<<grid, kThreads, 0, st>>>(x, codes, se, seo, ob, ws, M, K,
                                            Np, NB, budget, fold, gps);
}

}  // namespace

// x: (M, K) bf16; codes: (Np/4, K) int8; se, seo: (NB, K) int8 with
// NB = Np/16; ob: (budget, NB, K) int8; ws: (ksplit, M, Np) f32 scratch;
// out: (M, N) bf16 or f32 with N <= Np. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int dequant_gemv_nb(const void* x, const void* codes,
                                 const void* se, const void* seo,
                                 const void* ob, void* ws, void* out, int M,
                                 int K, int Np, int N, int budget, int fold,
                                 int ksplit, int groups_per_split,
                                 int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NB = Np / kRows;
  const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  const dim3 grid(NB, ksplit, (M + mt - 1) / mt);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  const auto* op = static_cast<const int8_t*>(seo);
  const auto* bp = static_cast<const int8_t*>(ob);
  auto* wp = static_cast<float*>(ws);
  switch (mt) {
    case 8: launch_partial<8>(grid, st, xp, cp, sp, op, bp, wp, M, K, Np, NB, budget, fold, groups_per_split); break;
    case 4: launch_partial<4>(grid, st, xp, cp, sp, op, bp, wp, M, K, Np, NB, budget, fold, groups_per_split); break;
    case 2: launch_partial<2>(grid, st, xp, cp, sp, op, bp, wp, M, K, Np, NB, budget, fold, groups_per_split); break;
    default: launch_partial<1>(grid, st, xp, cp, sp, op, bp, wp, M, K, Np, NB, budget, fold, groups_per_split); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mxq::launch_split_reduce(wp, out, M, Np, N, ksplit, out_bf16, st);
}

// x: (M, K) bf16; codes, se, seo, ob as above with NB = Np/16 N-blocks;
// out: (M, N) bf16 or f32 with N <= Np. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dequant_gemm_nb(const void* x, const void* codes,
                               const void* se, const void* seo,
                               const void* ob, void* out, int M, int K,
                               int Np, int N, int budget, int fold,
                               int out_bf16, void* stream) {
  nb_gemm<<<mxq::gemm_grid(M, N), mxq::kGemmThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const int8_t*>(se), static_cast<const int8_t*>(seo),
      static_cast<const int8_t*>(ob), out, M, K, N, Np / kRows, budget, fold,
      out_bf16);
  return static_cast<int>(cudaGetLastError());
}
