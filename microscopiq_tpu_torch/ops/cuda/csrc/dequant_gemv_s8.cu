// W8A8 scale-after-dot GEMV: y = xscale * (xq @ dequant(W)) for M <= 64
// rows, with per-token int8 activations xq and integer MX weight codes.
//
// Replaces microscopiq_tpu/ops/pallas/dequant_matmul.py::_sad_s8_kernel
// (wrapper dequant_matmul_sad_s8). It takes the int weight transports of the
// serving path: the int8 container and sb4, and sb2, which it decodes in the
// kernel (the TPU wrapper unpacks sb2 into an int8 copy first; the s32 block
// sums are exact, so the result is the same).
//
// What bounds it on the H100: bytes, as the bf16-activation GEMV: the codes
// (1, 1/2 or 1/4 byte a weight) and the exponents are ~99% of the traffic at
// M = 8, and each weight byte feeds at most 16*M integer operations.
//
// Design:
// - the grid and K split of dequant_gemv.cu: a thread owns 4 neighbouring
//   columns; K is split over blocks by the same shape-only rule, and each
//   split writes f32 partials that common.cuh's split_reduce adds in a
//   fixed order, then multiplies by the row's activation scale.
// - xq is staged in shared memory as 32-bit words of 4 consecutive K values.
// - per group of 4 packed rows the thread loads one 4-column word a row,
//   extracts each field (sub-byte codes sign-extended per byte with __vsub4)
//   and transposes the 4 x 4 bytes with __byte_perm into one word of 4
//   consecutive K values per column, which __dp4a multiplies with x's word
//   into s32 sums.
// - per K-block the s32 sum (|sum| <= B * 127 * 127 < 2^24, exact in f32) is
//   scaled by 2^(se - fold) and added to the row's f32 sum, as the TPU
//   kernel scales its s32 block partials.
#include "common.cuh"

namespace {

using mxq::exp2_i32;

constexpr int kThreads = 128;
constexpr int kCols = 4;                      // columns per thread
constexpr int kTileN = kThreads * kCols;      // columns per block
constexpr int kChunkBlocks = 8;               // K-blocks of x staged at once

// 4 bytes of one packed row at columns col0..col0+3 (0 past N), column col0
// in the low byte.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ row,
                                         int col0, int N, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const int*>(row + col0));
  int w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col0 + j < N)
      w |= (static_cast<int>(__ldg(row + col0 + j)) & 0xFF) << (8 * j);
  return w;
}

// Field f of every byte of p, sign-extended to a byte (int8 container: p).
template <int D>
__device__ __forceinline__ int field_bytes(int p, int f) {
  if constexpr (D == mxq::kInt8) {
    return p;
  } else {
    constexpr int bits = D == mxq::kSb4 ? 4 : 2;
    constexpr unsigned mask = D == mxq::kSb4 ? 0x0F0F0F0Fu : 0x03030303u;
    constexpr unsigned sign = D == mxq::kSb4 ? 0x08080808u : 0x02020202u;
    const unsigned v = (static_cast<unsigned>(p) >> (bits * f)) & mask;
    return static_cast<int>(__vsub4(v ^ sign, sign));
  }
}

// a[r] holds row r's bytes for columns 0..3; on return a[c] holds column
// c's bytes for rows 0..3 (row 0 in the low byte).
__device__ __forceinline__ void transpose4x4(int a[4]) {
  const unsigned lo01 = __byte_perm(a[0], a[1], 0x5140);
  const unsigned hi01 = __byte_perm(a[0], a[1], 0x7362);
  const unsigned lo23 = __byte_perm(a[2], a[3], 0x5140);
  const unsigned hi23 = __byte_perm(a[2], a[3], 0x7362);
  a[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  a[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  a[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  a[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

// grid: (ceil(N / kTileN), ksplit, ceil(M / MT)); dynamic shared memory
// holds MT x (kChunkBlocks * B / 4) words of xq.
template <int MT, int D>
__global__ void __launch_bounds__(kThreads)
s8_partial(const int8_t* __restrict__ xq, const int8_t* __restrict__ codes,
           const int8_t* __restrict__ se, float* __restrict__ ws, int M,
           int K, int N, int NB, int B, int fold, int nb_per_split) {
  constexpr int F = mxq::fields<D>();
  extern __shared__ int xw[];
  const int per = B / F;                      // packed rows a block
  const int col0 = blockIdx.x * kTileN + threadIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int nb_begin = split * nb_per_split;
  const int nb_end = min(NB, nb_begin + nb_per_split);
  const int chunk_w = kChunkBlocks * B / 4;
  const bool vec = (N % 4) == 0;
  const bool live = col0 < N;

  float sum[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) sum[m][j] = 0.f;

  for (int cb = nb_begin; cb < nb_end; cb += kChunkBlocks) {
    const int nblk = min(kChunkBlocks, nb_end - cb);
    const int span_w = nblk * B / 4;
    const int k0 = cb * B;
    __syncthreads();
    for (int i = threadIdx.x; i < MT * span_w; i += kThreads) {
      const int m = i / span_w, wi = i - m * span_w, k = k0 + 4 * wi;
      int v = 0;
      if (m0 + m < M) {
        const int8_t* xr = xq + static_cast<size_t>(m0 + m) * K;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k + t < K) v |= (static_cast<int>(xr[k + t]) & 0xFF) << (8 * t);
      }
      xw[m * chunk_w + wi] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int b = 0; b < nblk; ++b) {
      const int nb = cb + b;
      const int8_t* blk = codes + static_cast<size_t>(nb) * per * N;
      int acc[MT][kCols];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = 0;
      for (int g = 0; g < per; g += 4) {
        int p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[r] = load_word(blk + static_cast<size_t>(g + r) * N, col0, N, vec);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          int t[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) t[r] = field_bytes<D>(p[r], f);
          transpose4x4(t);             // t[j]: column j, K rows f*per+g..+3
          const int* xr = xw + (b * B + f * per + g) / 4;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int xv = xr[m * chunk_w];
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[m][j] = __dp4a(t[j], xv, acc[m][j]);
          }
        }
      }
      const int8_t* srow = se + static_cast<size_t>(nb) * N;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float sc = (col0 + j < N)
                             ? exp2_i32(static_cast<int>(srow[col0 + j]) - fold)
                             : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m)
          sum[m][j] = fmaf(static_cast<float>(acc[m][j]), sc, sum[m][j]);
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

template <int D>
void launch_s8(int mt, dim3 grid, size_t smem, cudaStream_t st,
               const int8_t* xq, const int8_t* codes, const int8_t* se,
               float* ws, int M, int K, int N, int NB, int B, int fold,
               int nbps) {
  switch (mt) {
    case 8:
      s8_partial<8, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
    case 4:
      s8_partial<4, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
    case 2:
      s8_partial<2, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
    default:
      s8_partial<1, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
  }
}

}  // namespace

// xq: (M, K) int8; xscale: (M,) f32; codes: (NB, rows, N) int8 with rows =
// B (int8 container), B/2 (sb4) or B/4 (sb2), rows % 4 == 0; se: (NB, N)
// int8; ws: (ksplit, M, N) f32 scratch; out: (M, N) bf16 or f32; decode:
// mxq::kInt8, kSb4 or kSb2. Returns the cudaError_t of the launches (0 on
// success; cudaErrorInvalidValue for another decode).
extern "C" int dequant_gemv_s8(const void* xq, const void* xscale,
                               const void* codes, const void* se, void* ws,
                               void* out, int M, int K, int N, int NB, int B,
                               int decode, int fold, int ksplit, int out_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbps = (NB + ksplit - 1) / ksplit;
  const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  const int mt_tiles = (M + mt - 1) / mt;
  const dim3 grid((N + kTileN - 1) / kTileN, ksplit, mt_tiles);
  const size_t smem = static_cast<size_t>(mt) * kChunkBlocks * B / 4 * sizeof(int);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* wp = static_cast<float*>(ws);
  switch (decode) {
    case mxq::kInt8:
      launch_s8<mxq::kInt8>(mt, grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, fold, nbps);
      break;
    case mxq::kSb4:
      launch_s8<mxq::kSb4>(mt, grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, fold, nbps);
      break;
    case mxq::kSb2:
      launch_s8<mxq::kSb2>(mt, grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, fold, nbps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st,
                                  static_cast<const float*>(xscale));
}
