// Scale-after-dot GEMV over emi8 MX codes: y = x @ dequant(W) for M <= 64.
//
// Replaces microscopiq_tpu/ops/pallas/dequant_matmul.py::_sad_kernel (emi8
// decode; wrapper dequant_matmul_sad). It carries every linear of a decode
// step, the last_only lm_head and engine prefills of <= 64 tokens.
//
// What bounds it on the H100: bytes. At M = 8 the codes (1 byte/weight) and
// exponents (1 byte/32 weights) are ~99% of the traffic and every byte is
// used for 2*M flops, far below the ~295 flop/byte where the tensor cores
// would become the limit. The bound is (codes + scales + x + out) / 3.35 TB/s.
//
// Design:
// - codes are pre-blocked (NB, B, N) int8 with N contiguous. A thread owns 4
//   neighbouring columns and reads them as one char4, so a warp reads 128
//   contiguous bytes of a row.
// - x (M, K) arrives as bf16 and is staged in shared memory as f32, a chunk
//   of K-blocks at a time; each value is broadcast to all threads of a block.
// - per K-block the raw-code dot is accumulated in f32 (every product of a
//   bf16 value and an emi8 integer is exact), then scaled once by
//   2^(se - fold), built from exponent bits with the exponent clamped to
//   [-126, 127] as _exp2_i32 does, and added to the row's f32 sum.
// - N = 4096 gives only 8 column tiles for 132 SMs, so K is split across
//   blocks (grid.y). Each split writes an f32 partial; a second kernel adds
//   the partials in a fixed order and casts once to the output dtype. No
//   float atomics: row m's result depends neither on the other rows nor on
//   M, and the split count depends only on (N, NB), which the wrapper picks.
// - the ragged N edge (lm_head, N = 128256) is masked per column.
// - mw and fold are run-time arguments, so the emi8m merged-outlier stream
//   can reuse the kernel with its own field split.
#include "common.cuh"

namespace {

using mxq::exp2_i32;

constexpr int kThreads = 128;
constexpr int kCols = 4;                      // columns per thread
constexpr int kTileN = kThreads * kCols;      // columns per block
constexpr int kChunkBlocks = 8;               // K-blocks of x staged at once

// emi8 byte -> integer value m̂ · 2^e' (exact in f32).
__device__ __forceinline__ float decode_emi8(int c, int mw) {
  const int sh = 8 - mw;
  const int mhat = c >> sh;                   // c is sign-extended int8
  const int ep = c & ((1 << sh) - 1);
  return static_cast<float>(mhat * (1 << ep));
}

__device__ __forceinline__ void load_decode4(const int8_t* row, int col0,
                                             int N, bool vec, int mw,
                                             float w[kCols]) {
  if (vec) {            // N % 4 == 0 and col0 % 4 == 0: all four in range
    const char4 c = __ldg(reinterpret_cast<const char4*>(row + col0));
    w[0] = decode_emi8(c.x, mw);
    w[1] = decode_emi8(c.y, mw);
    w[2] = decode_emi8(c.z, mw);
    w[3] = decode_emi8(c.w, mw);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      w[j] = (col0 + j < N) ? decode_emi8(__ldg(row + col0 + j), mw) : 0.f;
  }
}

// grid: (ceil(N / kTileN), ksplit, ceil(M / MT)); dynamic shared memory
// holds MT x (kChunkBlocks * B) floats of x.
template <int MT>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ codes,
             const int8_t* __restrict__ se, float* __restrict__ ws, int M,
             int K, int N, int NB, int B, int mw, int fold,
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

  float sum[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) sum[m][j] = 0.f;

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
    for (int b = 0; b < nblk; ++b) {
      const int nb = cb + b;
      const int8_t* blk = codes + static_cast<size_t>(nb) * B * N;
      float part[MT][kCols];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) part[m][j] = 0.f;
#pragma unroll 8
      for (int r = 0; r < B; ++r) {
        float w[kCols];
        load_decode4(blk + static_cast<size_t>(r) * N, col0, N, vec, mw, w);
        const float* xr = xs + b * B + r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m * chunk_k];
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            part[m][j] = fmaf(xv, w[j], part[m][j]);
        }
      }
      const int8_t* srow = se + static_cast<size_t>(nb) * N;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float sc = (col0 + j < N)
                             ? exp2_i32(static_cast<int>(srow[col0 + j]) - fold)
                             : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) sum[m][j] = fmaf(part[m][j], sc, sum[m][j]);
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
      if (col0 + j < N) dst[col0 + j] = sum[m][j];
  }
}

template <int MT>
void launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                    const __nv_bfloat16* x, const int8_t* codes,
                    const int8_t* se, float* ws, int M, int K, int N, int NB,
                    int B, int mw, int fold, int nbps) {
  gemv_partial<MT><<<grid, kThreads, smem, st>>>(x, codes, se, ws, M, K, N,
                                                 NB, B, mw, fold, nbps);
}

}  // namespace

// x: (M, K) bf16; codes: (NB, B, N) int8; se: (NB, N) int8;
// ws: (ksplit, M, N) f32 scratch; out: (M, N) bf16 or f32.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int dequant_gemv_emi8(const void* x, const void* codes,
                                 const void* se, void* ws, void* out, int M,
                                 int K, int N, int NB, int B, int mw,
                                 int fold, int ksplit, int out_bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbps = (NB + ksplit - 1) / ksplit;
  const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  const int mt_tiles = (M + mt - 1) / mt;
  const dim3 grid((N + kTileN - 1) / kTileN, ksplit, mt_tiles);
  const size_t smem = static_cast<size_t>(mt) * kChunkBlocks * B * sizeof(float);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* wp = static_cast<float*>(ws);
  switch (mt) {
    case 8: launch_partial<8>(grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, mw, fold, nbps); break;
    case 4: launch_partial<4>(grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, mw, fold, nbps); break;
    case 2: launch_partial<2>(grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, mw, fold, nbps); break;
    default: launch_partial<1>(grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, mw, fold, nbps); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st);
}
