// Two-level outlier side-band matmuls: y = x @ dequant(W) for a
// PackedMXOutlier (K, N) weight blocked along K. Two kernels:
// - dequant_gemv_outlier, for M < 256 tokens: every linear of a decode step
//   of the side-band format, the last_only lm_head and engine prefills;
// - dequant_gemm_outlier, for M >= 256: every linear of a long prefill.
//
// Both replace microscopiq_tpu/ops/pallas/dequant_matmul.py::
// _dq_matmul_outlier_kernel (wrapper dequant_matmul_outlier). The JAX
// QLinear sends 256 tokens and more to a plain dequantize-then-matmul in
// XLA; here the same token count chooses between the two kernels.
//
// Operands:
// - codes (Kp, N): inlier codes in their container, int8 for int formats or
//   float8_e4m3fn bits for fp formats;
// - se, seo (Kp/B, N) int8: level-1 and level-2 exponents;
// - oc (Kp/B, N, budget): outlier codes in their container (int8 or
//   float8_e4m3fn bits); pos (Kp/B, N, budget) int32: row in the block, -1
//   for an empty slot.
// w[k, n] = code · 2^(se - fold) + sum over slots with pos == k % B of
// oc · 2^(seo - se), computed in f32 and rounded to bf16, then multiplied
// with the bf16-rounded x and summed in f32, as the TPU kernel does. Like
// it, the outlier code is scaled with no fold: for an int outlier format of
// more than 2 bits the twin, which decodes int codes by 2^-(mbits-2), gives
// another value (ROADMAP queue 3).
//
// What bounds the GEMV on the H100: bytes. At budget 4 a weight costs 2.375
// bytes (the int8 code, two exponents per 16, and per 16 weights four
// 1-byte codes and four 4-byte positions); at M = 8 every byte feeds under
// 7 flops. The bound is (weight bytes + x + out) / 3.35 TB/s. The GEMM at
// M = 1024 does ~860 flops per weight byte: the bound is 2*M*N*K / 989
// TFLOP/s (bf16 tensor cores).
//
// GEMV design (simple and right first), after dequant_gemv.cu:
// - a thread owns 4 neighbouring columns n (one 32-bit load of a code row;
//   a warp reads 128 contiguous bytes); a block of 128 threads covers 512
//   columns;
// - per K-block the thread loads the block's exponents and its 4 x budget
//   slots once, then walks the 16 rows, decoding each weight in registers;
// - x (M, K) is staged in shared memory as f32, a chunk of K-blocks at a
//   time, and broadcast to the block's threads;
// - K is split across blocks (grid.y) by a count that depends only on
//   (N, K-blocks); each split writes an f32 partial and split_reduce adds
//   them in split order, so a row's result does not depend on M.
//
// GEMM design: the bf16 wmma tile loop of common.cuh (128 x 128 output
// tile, 32-deep K steps). Per K step the 32 x 128 weight tile is built in
// f32 in shared memory: the inliers with 16-byte loads of codes and
// exponents, then the slots, one thread per (K-block, column) adding them
// in slot order to the rows they name, then rounded to the bf16 B tile,
// which serves all 128 rows of x. The weights are the GEMV's bf16 weights;
// the tensor cores' f32 accumulation differs from a CUDA-core sum in order
// and internal rounding (the emi8 GEMM's 2e-3 tolerance).
#include "common.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kTileN = kThreads * kCols;
constexpr int kChunkBlocks = 8;
constexpr int kMaxBudget = 8;

// float8_e4m3fn bits -> f32 (exact; the formats here never store NaN).
__device__ __forceinline__ float e4m3_to_f32(int b) {
  const int e = (b >> 3) & 15, m = b & 7;
  const float mag = e ? static_cast<float>(8 + m) * exp2_i32(e - 10)
                      : static_cast<float>(m) * exp2_i32(-9);
  return (b & 0x80) ? -mag : mag;
}

__device__ __forceinline__ float decode(int8_t c, int fp8) {
  return fp8 ? e4m3_to_f32(static_cast<uint8_t>(c)) : static_cast<float>(c);
}

// The inlier scale and the slots of K-block element e = nb * N + n: slot s
// adds oval[s] at in-block row opos[s] (-1, adding nothing, past budget).
__device__ __forceinline__ void load_slots(
    const int8_t* __restrict__ se, const int8_t* __restrict__ seo,
    const int8_t* __restrict__ oc, const int* __restrict__ pos, size_t e,
    int budget, int fold, int oc_fp8, float& sc_in,
    int (&opos)[kMaxBudget], float (&oval)[kMaxBudget]) {
  const int s_in = se[e];
  sc_in = exp2_i32(s_in - fold);
  const float sc_out = exp2_i32(static_cast<int>(seo[e]) - s_in);
#pragma unroll
  for (int s = 0; s < kMaxBudget; ++s) {
    opos[s] = -1;
    oval[s] = 0.f;
    if (s < budget) {
      opos[s] = __ldg(pos + e * budget + s);
      oval[s] = decode(__ldg(oc + e * budget + s), oc_fp8) * sc_out;
    }
  }
}

// The bf16-rounded weight at in-block row r: code · scale plus the slots
// at row r, added in slot order.
__device__ __forceinline__ float weight(int8_t code, int codes_fp8,
                                        float sc_in,
                                        const int (&opos)[kMaxBudget],
                                        const float (&oval)[kMaxBudget],
                                        int r) {
  float v = decode(code, codes_fp8) * sc_in;
#pragma unroll
  for (int s = 0; s < kMaxBudget; ++s) v += (opos[s] == r) ? oval[s] : 0.f;
  return __bfloat162float(__float2bfloat16(v));
}

// grid: (ceil(N / kTileN), ksplit, ceil(M / MT)); dynamic shared memory
// holds MT x (kChunkBlocks * B) floats of x.
template <int MT>
__global__ void __launch_bounds__(kThreads)
outlier_partial(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ codes,
                const int8_t* __restrict__ se, const int8_t* __restrict__ seo,
                const int8_t* __restrict__ oc, const int* __restrict__ pos,
                float* __restrict__ ws, int M, int K, int N, int NB, int B,
                int budget, int fold, int codes_fp8, int oc_fp8,
                int nb_per_split) {
  extern __shared__ float xs[];
  const int col0 = blockIdx.x * kTileN + threadIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int nb_begin = split * nb_per_split;
  const int nb_end = min(NB, nb_begin + nb_per_split);
  const int chunk_k = kChunkBlocks * B;
  const bool vec = (N % 4) == 0;
  const bool live = col0 < N;

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int cb = nb_begin; cb < nb_end; cb += kChunkBlocks) {
    const int nblk = min(kChunkBlocks, nb_end - cb);
    const int span = nblk * B;
    const int k0 = cb * B;
    __syncthreads();
    for (int i = threadIdx.x; i < MT * span; i += kThreads) {
      const int m = i / span, kk = i - m * span, k = k0 + kk;
      float v = 0.f;
      if (m0 + m < M && k < K)
        v = __bfloat162float(x[static_cast<size_t>(m0 + m) * K + k]);
      xs[m * chunk_k + kk] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int bi = 0; bi < nblk; ++bi) {
      const int nb = cb + bi;
      float sc_in[kCols], oval[kCols][kMaxBudget];
      int opos[kCols][kMaxBudget];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int n = min(col0 + j, N - 1);     // columns >= N are not stored
        load_slots(se, seo, oc, pos, static_cast<size_t>(nb) * N + n, budget,
                   fold, oc_fp8, sc_in[j], opos[j], oval[j]);
      }
      const int8_t* blk = codes + static_cast<size_t>(nb) * B * N;
      for (int r = 0; r < B; ++r) {
        const int8_t* row = blk + static_cast<size_t>(r) * N;
        int8_t c[kCols];
        if (vec) {
          const char4 v = __ldg(reinterpret_cast<const char4*>(row + col0));
          c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            c[j] = (col0 + j < N) ? __ldg(row + col0 + j) : 0;
        }
        float w[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          w[j] = weight(c[j], codes_fp8, sc_in[j], opos[j], oval[j], r);
        const float* xr = xs + bi * B + r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m * chunk_k];
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[m][j] = fmaf(xv, w[j], acc[m][j]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
    float* dst = ws + (static_cast<size_t>(split) * M + m0 + m) * N;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (col0 + j < N) dst[col0 + j] = acc[m][j];
  }
}

// grid: mxq::gemm_grid(M, N). Per K step the weight tile is built in f32
// in wf and then rounded into the bf16 B tile, in three passes:
// 1. thread t decodes the inliers of row t / 8 and 16 columns from
//    16 * (t % 8), one 16-byte load each of codes and exponents;
// 2. one thread per (K-block, column) of the step adds its slots, in slot
//    order, to the rows they name;
// 3. each thread rounds its 16 weights to bf16.
__global__ void __launch_bounds__(mxq::kGemmThreads)
outlier_gemm(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
             const int8_t* __restrict__ seo, const int8_t* __restrict__ oc,
             const int* __restrict__ pos, void* out, int M, int K, int N,
             int Kp, int B, int budget, int fold, int codes_fp8, int oc_fp8,
             int out_bf16) {
  constexpr int BK = mxq::kGemmBK, BN = mxq::kGemmBN;
  __shared__ __align__(16) float wf[BK][BN];
  const int n_blk = blockIdx.x * BN;
  const bool nvec = (N % 16) == 0;
  const int b_r = threadIdx.x >> 3, b_c = (threadIdx.x & 7) * 16;
  auto decode_b = [&](BTile Bs, int k0) {
    const int k = k0 + b_r, n = n_blk + b_c;
    float w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = 0.f;
    if (k < Kp) {
      const int8_t* crow = codes + static_cast<size_t>(k) * N;
      const int8_t* srow = se + static_cast<size_t>(k / B) * N;
      if (nvec) {
        if (n < N) {
          const int4 cv = __ldg(reinterpret_cast<const int4*>(crow + n));
          const int4 sv = __ldg(reinterpret_cast<const int4*>(srow + n));
          const int8_t* cb = reinterpret_cast<const int8_t*>(&cv);
          const int8_t* sb = reinterpret_cast<const int8_t*>(&sv);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            w[j] = decode(cb[j], codes_fp8) *
                   exp2_i32(static_cast<int>(sb[j]) - fold);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < N)
            w[j] = decode(crow[n + j], codes_fp8) *
                   exp2_i32(static_cast<int>(srow[n + j]) - fold);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(&wf[b_r][b_c + j]) =
          make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]);
    __syncthreads();
    const int nb0 = k0 / B;                   // K-blocks of rows k0..
    const int nbs = (min(k0 + BK, Kp) - 1) / B - nb0 + 1;
    for (int p = threadIdx.x; p < nbs * BN; p += mxq::kGemmThreads) {
      const int nb = nb0 + p / BN, c = p % BN, nc = n_blk + c;
      if (nc >= N) continue;
      float sc_in, oval[kMaxBudget];
      int opos[kMaxBudget];
      load_slots(se, seo, oc, pos, static_cast<size_t>(nb) * N + nc, budget,
                 fold, oc_fp8, sc_in, opos, oval);
#pragma unroll
      for (int s = 0; s < kMaxBudget; ++s) {
        const int r = nb * B + opos[s] - k0;
        if (opos[s] >= 0 && r >= 0 && r < BK) wf[r][c] += oval[s];
      }
    }
    __syncthreads();
    uint32_t u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      __nv_bfloat162 h = __floats2bfloat162_rn(wf[b_r][b_c + 2 * j],
                                               wf[b_r][b_c + 2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    uint4* dst = reinterpret_cast<uint4*>(&Bs[b_r][b_c]);
    dst[0] = make_uint4(u[0], u[1], u[2], u[3]);
    dst[1] = make_uint4(u[4], u[5], u[6], u[7]);
  };
  mxq::gemm_tile(x, out, M, K, N, K, out_bf16, decode_b);
}

template <int MT>
void launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                    const __nv_bfloat16* x, const int8_t* codes,
                    const int8_t* se, const int8_t* seo, const int8_t* oc,
                    const int* pos, float* ws, int M, int K, int N, int NB,
                    int B, int budget, int fold, int codes_fp8, int oc_fp8,
                    int nbps) {
  outlier_partial<MT><<<grid, kThreads, smem, st>>>(
      x, codes, se, seo, oc, pos, ws, M, K, N, NB, B, budget, fold,
      codes_fp8, oc_fp8, nbps);
}

}  // namespace

// x: (M, K) bf16; codes: (NB*B, N) int8 or float8_e4m3fn bits; se, seo:
// (NB, N) int8; oc: (NB, N, budget) int8 or float8_e4m3fn bits; pos: (NB,
// N, budget) int32; ws: (ksplit, M, N) f32 scratch; out: (M, N) bf16 or f32.
// budget <= 8. Returns the cudaError_t of the launches (0 on success).
extern "C" int dequant_gemv_outlier(
    const void* x, const void* codes, const void* se, const void* seo,
    const void* oc, const void* pos, void* ws, void* out, int M, int K, int N,
    int NB, int B, int budget, int fold, int codes_fp8, int oc_fp8,
    int ksplit, int out_bf16, void* stream) {
  if (budget < 0 || budget > kMaxBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbps = (NB + ksplit - 1) / ksplit;
  const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  const dim3 grid((N + kTileN - 1) / kTileN, ksplit, (M + mt - 1) / mt);
  const size_t smem = static_cast<size_t>(mt) * kChunkBlocks * B * sizeof(float);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  const auto* op = static_cast<const int8_t*>(seo);
  const auto* ocp = static_cast<const int8_t*>(oc);
  const auto* pp = static_cast<const int*>(pos);
  auto* wp = static_cast<float*>(ws);
  switch (mt) {
    case 8: launch_partial<8>(grid, smem, st, xp, cp, sp, op, ocp, pp, wp, M, K, N, NB, B, budget, fold, codes_fp8, oc_fp8, nbps); break;
    case 4: launch_partial<4>(grid, smem, st, xp, cp, sp, op, ocp, pp, wp, M, K, N, NB, B, budget, fold, codes_fp8, oc_fp8, nbps); break;
    case 2: launch_partial<2>(grid, smem, st, xp, cp, sp, op, ocp, pp, wp, M, K, N, NB, B, budget, fold, codes_fp8, oc_fp8, nbps); break;
    default: launch_partial<1>(grid, smem, st, xp, cp, sp, op, ocp, pp, wp, M, K, N, NB, B, budget, fold, codes_fp8, oc_fp8, nbps); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st);
}

// x: (M, K) bf16; codes, se, seo, oc, pos as above with Kp = NB * B >= K;
// out: (M, N) bf16 or f32. budget <= 8. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dequant_gemm_outlier(
    const void* x, const void* codes, const void* se, const void* seo,
    const void* oc, const void* pos, void* out, int M, int K, int N, int Kp,
    int B, int budget, int fold, int codes_fp8, int oc_fp8, int out_bf16,
    void* stream) {
  if (budget < 0 || budget > kMaxBudget) return static_cast<int>(cudaErrorInvalidValue);
  outlier_gemm<<<mxq::gemm_grid(M, N), mxq::kGemmThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const int8_t*>(se), static_cast<const int8_t*>(seo),
      static_cast<const int8_t*>(oc), static_cast<const int*>(pos), out, M, K,
      N, Kp, B, budget, fold, codes_fp8, oc_fp8, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
