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
// GEMM design: gemm_sm90.cuh's wgmma + TMA mainloop (256 x 128 output
// tile, 64-deep K steps, two decode warpgroups feeding two wgmma
// warpgroups) with NbSm90's decode. A 128-column output tile is 8 N-blocks
// of the (N, K) weight; a step's raw copy holds their 32 code rows, 8 se
// and 8 seo rows and, slot by slot, 8 rows of slot bytes, 64 K columns
// each (one TMA box a stream and slot; plain copies where K % 16 != 0).
// Decode thread (b, p) forms the 16 weights of N-block b at K columns 2p
// and 2p + 1 in registers, in decode_column's order and arithmetic (the
// inliers, then the slots in slot order, both exponent clamps), rounds
// them once to bf16 and writes them to the K-major B tile: the B tile is
// nb_gemm's bit for bit. The kernel is templated on the slots its ring
// holds (1, 2, 4, 8, 16; a smaller budget reads its own); every budget the
// format takes (<= 16: a slot's row is 4 bits) fits a 4-stage ring.
// nb_gemm, the bf16 wmma tile loop of
// common.cuh (128 x 128 output tile, 32-deep K steps; warp w decodes
// N-block w of a step, lane l column k0 + l), takes a budget above 16,
// which no packer makes. outlier_matmul.py::dequant_gemm_nb chooses by
// budget before the launch (dequant_matmul.py::gemm_route). Weights are
// exact in bf16, so the tensor cores see the twin's weights; their f32
// accumulation differs from a CUDA-core sum in order and internal rounding
// (the emi8 GEMM's 2e-3 tolerance).
#include "common.cuh"
#include "gemm_sm90.cuh"

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

// The compact NB decoder of gemm_sm90.cuh's mainloop, MAXB slots in its
// ring (budget <= MAXB). Raw copy of a 64-column K step of a 128-column
// output tile (8 N-blocks from nb0 = n0 / 16): the code rows 4 nb0..
// [32][64], se and seo [8][64] each, then slot s's bytes [8][64] for each
// s < budget. Decode thread t = 32b + p owns the 16 rows of N-block b at
// K columns 2p and 2p + 1: one exponent pair and one slot byte pair a
// slot serve all 16 (a thread of 4 rows at 8 K columns forms every scale
// four times over, and was slower on the H100). Each row's two weights go
// to the B tile as one 4-byte word; a warp's 32 words of a row fill its
// 128 bytes, conflict-free.
template <int MAXB>
struct NbSm90 {
  static_assert(MAXB == 1 || MAXB == 2 || MAXB == 4 || MAXB == 8
                || MAXB == 16, "1, 2, 4, 8 or 16 slots");
  static constexpr int kK = mxq::sm90::kBK;               // 64 K columns
  static constexpr int kBlocks = mxq::sm90::kBN / kRows;  // 8 N-blocks
  static constexpr int kCodeRows = 4 * kBlocks;           // 32
  static constexpr int kSeOff = kCodeRows * kK;           // 2048
  static constexpr int kSeoOff = kSeOff + kBlocks * kK;
  static constexpr int kObOff = kSeoOff + kBlocks * kK;   // 3072
  static constexpr int kSlotBytes = kBlocks * kK;         // 512
  static constexpr int kRawBytes = kObOff + MAXB * kSlotBytes;
  // 4 stages and 3 raw buffers: 208,472-231,512 bytes
  static constexpr int kStages = 4, kRawBufs = 3, kDwg = 2;

  const int8_t* __restrict__ codes;     // (Np/4, K)
  const int8_t* __restrict__ se;        // (NB, K)
  const int8_t* __restrict__ seo;       // (NB, K)
  const int8_t* __restrict__ ob;        // (budget, NB, K)
  const CUtensorMap* codes_map;         // box 64 x 32
  const CUtensorMap* se_map;            // se, seo: box 64 x 8
  const CUtensorMap* seo_map;
  const CUtensorMap* ob_map;            // ob as (budget * NB, K), 64 x 8
  int K, NB, budget, fold;
  bool tma;          // K % 16 == 0 and 16-byte aligned operands

  __device__ __forceinline__ int tx_bytes() const {
    return kObOff + budget * kSlotBytes;
  }

  __device__ __forceinline__ void copy_tma(int8_t* raw, int k0, int n0,
                                           uint32_t bar) const {
    using mxq::sm90::tma_load_2d;
    const int nb0 = n0 / kRows;
    tma_load_2d(raw, codes_map, k0, 4 * nb0, bar);
    tma_load_2d(raw + kSeOff, se_map, k0, nb0, bar);
    tma_load_2d(raw + kSeoOff, seo_map, k0, nb0, bar);
    // rows past NB of slot s are slot s + 1's; decode reads no slot of an
    // N-block past NB
    for (int s = 0; s < budget; ++s)
      tma_load_2d(raw + kObOff + s * kSlotBytes, ob_map, k0, s * NB + nb0,
                  bar);
  }

  template <int DWG>
  __device__ __forceinline__ void copy(int8_t* raw, int k0, int n0,
                                       int t) const {
    const int nb0 = n0 / kRows;
    for (int c = t; c < tx_bytes(); c += 128 * DWG) {
      const int row = c / kK, k = k0 + c % kK;
      int8_t v = 0;
      if (k < K) {
        if (c < kSeOff) {
          if (4 * nb0 + row < 4 * NB)
            v = codes[static_cast<size_t>(4 * nb0 + row) * K + k];
        } else if (c < kObOff) {
          const int i = row - kCodeRows, nb = nb0 + i % kBlocks;
          if (nb < NB)
            v = (i < kBlocks ? se : seo)[static_cast<size_t>(nb) * K + k];
        } else {
          const int i = row - kCodeRows - 2 * kBlocks;
          const int s = i / kBlocks, nb = nb0 + i % kBlocks;
          if (nb < NB)
            v = ob[(static_cast<size_t>(s) * NB + nb) * K + k];
        }
      }
      raw[c] = v;
    }
  }

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* bt,
                                         int t) const {
    static_assert(DWG == 2, "256 decode threads: 8 N-blocks x 32 K pairs");
    const int b = t >> 5, p = t & 31;     // N-block b, K columns 2p, 2p + 1
    // no slot of an N-block past the weight (its rows are another slot's)
    const int slots = blockIdx.y * kBlocks + b < NB ? budget : 0;
    uint32_t cw[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cw[r] = *reinterpret_cast<const uint16_t*>(raw + (4 * b + r) * kK
                                                 + 2 * p);
    const uint32_t sw = *reinterpret_cast<const uint16_t*>(
        raw + kSeOff + b * kK + 2 * p);
    const uint32_t ow = *reinterpret_cast<const uint16_t*>(
        raw + kSeoOff + b * kK + 2 * p);
    // w[j][h]: row 16b + j at K column 2p + h; decode_column's inliers
    // (the int2 code as an f32 through the 1.5 · 2^23 bias: exact)
    float w[kRows][2], osc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s_in = static_cast<int8_t>(sw >> (8 * h));
      const float sc = exp2_i32(s_in - fold);
      osc[h] = exp2_i32(static_cast<int8_t>(ow >> (8 * h)) - s_in - 1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t code = static_cast<uint32_t>(
            static_cast<int>(static_cast<int8_t>(cw[r] >> (8 * h))));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int v = static_cast<int>(code << (30 - 2 * i)) >> 30;
          w[r + 4 * i][h] = (__int_as_float(0x4B400000 + v) - 12582912.f)
                            * sc;
        }
      }
    }
    // the slots in slot order: 2·fp4 placed as f32 bits (exponent field e,
    // mantissa m: a subnormal for e = 0) times 2^127 is fp4_twice exactly
    // (-0 for the code 8, which adds as fp4_twice's +0 does); decode_column
    // adds +0 at every other row, which changes no weight (none is -0)
#pragma unroll 1
    for (int s = 0; s < slots && s < MAXB; ++s) {
      const uint32_t bw = *reinterpret_cast<const uint16_t*>(
          raw + kObOff + s * kSlotBytes + b * kK + 2 * p);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t ub = (bw >> (8 * h)) & 0xFF;
        const int pos = ub >> 4;
        const float val =
            __uint_as_float(((ub & 7) << 22) | ((ub & 8) << 28)) * 0x1p127f
            * osc[h];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (pos == j) w[j][h] += val;
      }
    }
    // row n's K columns 2p, 2p + 1: word p % 4 of its swizzled chunk p / 4
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int n = kRows * b + j;
      *reinterpret_cast<uint32_t*>(
          bt + n * 128 + (((p >> 2) ^ (j & 7)) << 4) + (p & 3) * 4) =
          mxq::sm90::pack_bf16(w[j][0], w[j][1]);
    }
  }
};

// grid: M tiles x N tiles of 256 x 128 (gemm_sm90.cuh); x (M, Kx) bf16
// with Kx % 8 == 0 (K rounded up) through xmap; the weight's streams
// through the four maps where tma is set.
template <int MAXB>
__global__ void __launch_bounds__(mxq::sm90::threads(NbSm90<MAXB>::kDwg), 1)
nb_gemm_sm90(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap codes_map,
             const __grid_constant__ CUtensorMap se_map,
             const __grid_constant__ CUtensorMap seo_map,
             const __grid_constant__ CUtensorMap ob_map,
             const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
             const int8_t* __restrict__ seo, const int8_t* __restrict__ ob,
             void* out, int M, int Kx, int N, int K, int NB, int budget,
             int fold, int out_bf16, int tma) {
  using Dec = NbSm90<MAXB>;
  Dec dec{codes, se, seo, ob, &codes_map, &se_map, &seo_map, &ob_map, K, NB,
          budget, fold, tma != 0};
  mxq::sm90::gemm<Dec::kStages, Dec::kRawBufs, Dec::kDwg>(&xmap, out, M, N,
                                                         Kx, out_bf16, dec);
}

template <int MAXB>
int launch_nb_sm90(const void* x, const int8_t* codes, const int8_t* se,
                   const int8_t* seo, const int8_t* ob, void* out, int M,
                   int K, int Kx, int N, int NB, int budget, int fold,
                   int out_bf16, int tma, cudaStream_t st) {
  using Dec = NbSm90<MAXB>;
  constexpr int smem =
      mxq::sm90::Ring<Dec::kStages, Dec::kRawBytes, Dec::kRawBufs>::kBytes;
  CUtensorMap maps[4] = {};
  if (tma) {
    using mxq::sm90::raw_tensor_map;
    int err = raw_tensor_map(&maps[0], codes, 1, K, 4LL * NB, Dec::kK,
                             Dec::kCodeRows);
    if (err == 0)
      err = raw_tensor_map(&maps[1], se, 1, K, NB, Dec::kK, Dec::kBlocks);
    if (err == 0)
      err = raw_tensor_map(&maps[2], seo, 1, K, NB, Dec::kK, Dec::kBlocks);
    if (err == 0 && budget > 0)
      err = raw_tensor_map(&maps[3], ob, 1, K,
                           static_cast<long long>(budget) * NB, Dec::kK,
                           Dec::kBlocks);
    if (err != 0) return err;
  }
  return mxq::sm90::launch<Dec::kDwg>(
      nb_gemm_sm90<MAXB>, smem, x, M, N, Kx, st, maps[0], maps[1], maps[2],
      maps[3], codes, se, seo, ob, out, M, Kx, N, K, NB, budget, fold,
      out_bf16, tma);
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

// x: (M, Kx) bf16, Kx >= K; codes, se, seo, ob as above with NB = Np/16
// N-blocks and K columns; out: (M, N) bf16 or f32 with N <= Np; sm90: the
// route that dequant_matmul.py::gemm_route chose, 1 for nb_gemm_sm90
// (budget <= 16; Kx = K rounded up to a multiple of 8, x 16-byte
// aligned), 0 for nb_gemm (Kx = K, any budget). Returns the cudaError_t of
// the launch (0 on success; cudaErrorInvalidValue for a budget no sm90
// kernel takes).
extern "C" int dequant_gemm_nb(const void* x, const void* codes,
                               const void* se, const void* seo,
                               const void* ob, void* out, int M, int K,
                               int Kx, int Np, int N, int budget, int fold,
                               int out_bf16, int sm90, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  const auto* op = static_cast<const int8_t*>(seo);
  const auto* bp = static_cast<const int8_t*>(ob);
  const int NB = Np / kRows;
  if (!sm90) {
    nb_gemm<<<mxq::gemm_grid(M, N), mxq::kGemmThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cp, sp, op, bp, out, M, K, N,
        NB, budget, fold, out_bf16);
    return static_cast<int>(cudaGetLastError());
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int tma = K % 16 == 0 && aligned(codes) && aligned(se)
                  && aligned(seo) && (budget == 0 || aligned(ob));
#define MXQ_NB(MB)                                                          \
  if (budget <= MB)                                                         \
  return launch_nb_sm90<MB>(x, cp, sp, op, bp, out, M, K, Kx, N, NB, budget, \
                            fold, out_bf16, tma, st)
  MXQ_NB(1); MXQ_NB(2); MXQ_NB(4); MXQ_NB(8); MXQ_NB(16);
#undef MXQ_NB
  return static_cast<int>(cudaErrorInvalidValue);
}
