// Scale-after-dot GEMV over packed MX codes: y = x @ dequant(W) for M <= 64.
//
// Replaces microscopiq_tpu/ops/pallas/dequant_matmul.py::_sad_kernel (wrapper
// dequant_matmul_sad) in every decode it has: emi8 and emi8m, the int8
// container, sb4 and sb2, pf4 and pf6, and the bf16 and fp16 containers. It
// carries every linear of a decode step, the last_only lm_head and engine
// prefills of <= 64 tokens. It also takes the float8 containers (e4m3: the
// fp8_e4m3 codes and fp6/fp4 packed "native"; e5m2), which the JAX package
// sends to _dq_matmul_kernel's native2d branch (2-D codes) or to XLA
// (serving layout) at every M; one byte a weight, as the int8 container.
//
// What bounds it on the H100: bytes. At M = 8 the codes (1 byte/weight for
// emi8 and int8, 1/2 for sb4 and pf4, 3/4 for pf6, 1/4 for sb2, 2 for the
// bf16/fp16 containers) and the exponents (1 byte/B weights) are ~99% of the
// traffic and every byte is used for at most 16*M flops, far below the ~295
// flop/byte where the tensor cores would become the limit. The bound is
// (codes + scales + x + out) / 3.35 TB/s.
//
// Design:
// - codes are pre-blocked (NB, rows, N) with N contiguous, rows =
//   transport_rows_per_block. A thread owns 4 neighbouring columns and reads
//   them as one 4- or 8-byte load, so a warp reads 128 (256) contiguous
//   bytes of a packed row. Sub-byte K row j of a block is field j / (B/F) of
//   packed row j % (B/F): common.cuh's decode_group loads each packed row
//   once and decodes all F of its fields (pf6: two low-plane rows and one
//   high-plane row give four K rows).
// - x (M, K) arrives as bf16 and is staged in shared memory as f32, a chunk
//   of K-blocks at a time; each value is broadcast to all threads of a block.
// - per K-block the dot of x with the decoded integers (or bf16 values) is
//   accumulated in f32 (every product is exact), then scaled once by
//   2^(se - fold), built from exponent bits with the exponent clamped to
//   [-126, 127] as _exp2_i32 does, and added to the row's f32 sum.
// - N = 4096 gives only 8 column tiles for 132 SMs, so K is split across
//   blocks (grid.y). Each split writes an f32 partial; a second kernel adds
//   the partials in a fixed order and casts once to the output dtype. No
//   float atomics: row m's result depends neither on the other rows nor on
//   M, and the split count depends only on (N, NB), which the wrapper picks.
// - the ragged N edge (lm_head, N = 128256) is masked per column.
// - the decode is a template argument; mw, ebits and fold are run-time
//   arguments, so the emi8m merged-outlier stream reuses the emi8 decode
//   with its own field split.
#include "common.cuh"

namespace {

using mxq::exp2_i32;

constexpr int kThreads = 128;
constexpr int kCols = 4;                      // columns per thread
constexpr int kTileN = kThreads * kCols;      // columns per block
constexpr int kChunkBlocks = 8;               // K-blocks of x staged at once

// grid: (ceil(N / kTileN), ksplit, ceil(M / MT)); dynamic shared memory
// holds MT x (kChunkBlocks * B) floats of x.
template <int MT, int D>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ codes,
             const int8_t* __restrict__ se, float* __restrict__ ws, int M,
             int K, int N, int NB, int B, int mw, int ebits, int fold,
             int nb_per_split) {
  constexpr int F = mxq::fields<D>();           // K rows per packed row
  extern __shared__ float xs[];
  const int per = B / F;                        // groups of a block
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
      float part[MT][kCols];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) part[m][j] = 0.f;
#pragma unroll 8
      for (int g = 0; g < per; ++g) {
        float w[F][kCols];
        mxq::decode_group<D, kCols>(codes, nb, g, B, col0, N, vec, mw, ebits,
                                    w);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float* xr = xs + b * B + f * per + g;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xr[m * chunk_k];
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              part[m][j] = fmaf(xv, w[f][j], part[m][j]);
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

template <int D>
void launch_partial(int mt, dim3 grid, size_t smem, cudaStream_t st,
                    const __nv_bfloat16* x, const int8_t* codes,
                    const int8_t* se, float* ws, int M, int K, int N, int NB,
                    int B, int mw, int ebits, int fold, int nbps) {
  switch (mt) {
    case 8:
      gemv_partial<8, D><<<grid, kThreads, smem, st>>>(
          x, codes, se, ws, M, K, N, NB, B, mw, ebits, fold, nbps);
      break;
    case 4:
      gemv_partial<4, D><<<grid, kThreads, smem, st>>>(
          x, codes, se, ws, M, K, N, NB, B, mw, ebits, fold, nbps);
      break;
    case 2:
      gemv_partial<2, D><<<grid, kThreads, smem, st>>>(
          x, codes, se, ws, M, K, N, NB, B, mw, ebits, fold, nbps);
      break;
    default:
      gemv_partial<1, D><<<grid, kThreads, smem, st>>>(
          x, codes, se, ws, M, K, N, NB, B, mw, ebits, fold, nbps);
      break;
  }
}

}  // namespace

// x: (M, K) bf16; codes: (NB, rows, N) in the transport's container (int8,
// or 16-bit for the bf16/fp16 containers); se: (NB, N) int8; ws: (ksplit,
// M, N) f32 scratch; out: (M, N) bf16 or f32; decode: an mxq::Decode.
// Returns the cudaError_t of the launches (0 on success; cudaErrorInvalidValue
// for an unknown decode).
extern "C" int dequant_gemv(const void* x, const void* codes, const void* se,
                            void* ws, void* out, int M, int K, int N, int NB,
                            int B, int decode, int mw, int ebits, int fold,
                            int ksplit, int out_bf16, void* stream) {
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
#define MXQ_GEMV(D)                                                        \
  launch_partial<D>(mt, grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, mw, \
                    ebits, fold, nbps)
  switch (decode) {
    case mxq::kEmi8: MXQ_GEMV(mxq::kEmi8); break;
    case mxq::kInt8: MXQ_GEMV(mxq::kInt8); break;
    case mxq::kSb4: MXQ_GEMV(mxq::kSb4); break;
    case mxq::kSb2: MXQ_GEMV(mxq::kSb2); break;
    case mxq::kPf4: MXQ_GEMV(mxq::kPf4); break;
    case mxq::kPf6: MXQ_GEMV(mxq::kPf6); break;
    case mxq::kBf16: MXQ_GEMV(mxq::kBf16); break;
    case mxq::kFp16: MXQ_GEMV(mxq::kFp16); break;
    case mxq::kFp8E4m3: MXQ_GEMV(mxq::kFp8E4m3); break;
    case mxq::kFp8E5m2: MXQ_GEMV(mxq::kFp8E5m2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_GEMV
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st);
}
