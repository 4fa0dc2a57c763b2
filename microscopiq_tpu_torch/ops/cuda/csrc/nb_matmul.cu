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
// 3.35 TB/s; its f32 FMAs on CUDA cores would take longer, so the dot runs
// on the tensor cores. The GEMM at M = 1024 does 4096 flops per weight
// byte: the bound is 2*M*N*K / 989 TFLOP/s (bf16 tensor cores).
//
// GEMV design (gv::nb_gemv, planned by outlier_matmul.py::nb_gemv_plan;
// csrc/gemv_tc.cuh's pattern, as dequant_gemv.cu's gemv_tc):
// - one persistent CTA an SM walks over a contiguous range of (8 N-blocks
//   = 128 output columns, row group of up to 64 rows of x, K split)
//   tiles; warp 8 keeps a ring of 128-column stages in flight (32 code
//   rows, 8 se and 8 seo rows, 8 rows a slot: 2-D TMA boxes behind
//   mbarriers, plain copies where K % 16 != 0); x stays in shared memory
//   as bf16 for the split.
// - consumer warp w owns N-block w of the tile: per half stage (64 K
//   columns) lane p forms the 16 weights of K columns 2p, 2p + 1 with
//   decode_pair (one exponent pair and one slot byte pair a slot serve all
//   16), rounds them once to bf16 into the warp's 16 x 64 tile in shared
//   memory (the B tile of NbSm90, bit for bit), and the warp runs 4
//   mma.m16n8k16 steps on it (A fragments by ldmatrix: an N-block's 16 rows
//   are exactly the 16-row operand, its K pairs neighbours in memory).
//   The scale varies along K, so the dot cannot come before it: fresh
//   accumulators every stage (128 K columns) are added to an f32 sum.
// - each tile writes an f32 partial; split_reduce adds the splits in
//   order. The split depends on (NB, K) only, never on M, so a row's
//   result does not depend on the batch (the engine then matches
//   single-sequence decode). N is padded to a multiple of 16 in storage;
//   the reduce writes only the orig_n real columns.
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
#include "gemv_tc.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

constexpr int kRows = 16;                     // N-block

// fp4 e2m1 bits (s e e m) -> signed integer value 2·fp4 (exact).
__device__ __forceinline__ float fp4_twice(int b) {
  const int e = (b >> 1) & 3, m = b & 1;
  const int mag = (m + 2 * min(e, 1)) << max(e - 1, 0);
  return static_cast<float>((b & 8) ? -mag : mag);
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

// w[j][h]: the weight of row j of an N-block at the K column of half h
// of a pair of neighbouring K columns, from the pair's code bytes (cw[r]:
// byte row r, the lower column in the low byte), exponents (sw: se, ow:
// seo) and slot bytes (slot s's pair at ob + s * ob_stride), in
// decode_column's order and arithmetic: the inliers (the int2 code as an
// f32 through the 1.5 * 2^23 bias: exact), then the slots in slot order.
// 2 * fp4 placed as f32 bits (exponent field e, mantissa m: a subnormal
// for e = 0) times 2^127 is fp4_twice exactly (-0 for the code 8, which
// adds as fp4_twice's +0 does); decode_column adds +0 at every other row,
// which changes no weight (none is -0). At most MAXB slots are read.
template <int MAXB>
__device__ __forceinline__ void decode_pair(const uint32_t (&cw)[4],
                                            uint32_t sw, uint32_t ow,
                                            const int8_t* ob, int ob_stride,
                                            int slots, int fold,
                                            float (&w)[kRows][2]) {
  float osc[2];
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
        w[r + 4 * i][h] = (__int_as_float(0x4B400000 + v) - 12582912.f) * sc;
      }
    }
  }
#pragma unroll 1
  for (int s = 0; s < slots && s < MAXB; ++s) {
    const uint32_t bw = *reinterpret_cast<const uint16_t*>(ob + s * ob_stride);
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
    float w[kRows][2];
    decode_pair<MAXB>(cw, sw, ow, raw + kObOff + b * kK + 2 * p, kSlotBytes,
                      slots, fold, w);
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

// ---------------------------------------------------------------------------
// The GEMV (M < 256): nb_gemv
// ---------------------------------------------------------------------------
namespace gv {

using mxq::gemv_tc::align_up;
using mxq::gemv_tc::bar_wait;
using mxq::gemv_tc::consumer_sync;
using mxq::gemv_tc::init_ring;
using mxq::gemv_tc::kAlign;
using mxq::gemv_tc::kBarBytes;
using mxq::gemv_tc::kConsumers;
using mxq::gemv_tc::kMaxStages;
using mxq::gemv_tc::kThreads;
using mxq::gemv_tc::mma_bf16;
using mxq::gemv_tc::n8_tiles;
using mxq::gemv_tc::Ring;
using mxq::gemv_tc::take_role;
using mxq::gemv_tc::tile_range;
using mxq::gemv_tc::x_frag;

constexpr int kK = 128;                       // K columns a stage
constexpr int kBlocks = 8;                    // N-blocks a tile, one a warp
constexpr int kSeOff = 4 * kBlocks * kK;      // 4096: after 32 code rows
constexpr int kSeoOff = kSeOff + kBlocks * kK;
constexpr int kObOff = kSeoOff + kBlocks * kK;   // 6144
constexpr int kSlotBytes = kBlocks * kK;      // 1024 a slot
constexpr int kTileBytes = kRows * 128;       // a warp's bf16 tile: 16 x 64
constexpr int kMaxSlots = 1 << 20;            // decode_pair's bound: none

struct Plan {
  int M, K, NB, budget, fold;
  int ksplit, sps, stages, mgroups, n_tiles, tiles, tma;
  int stage_bytes, x_pitch;
};

// outlier_matmul.py::nb_gemv_plan mirrors these.
__host__ __device__ inline int stage_bytes(int budget) {
  return align_up(kObOff + budget * kSlotBytes, 1024);
}
__host__ __device__ inline int smem_bytes(const Plan& p, int nt) {
  return kAlign + kBarBytes + p.stages * p.stage_bytes
         + (kConsumers / 32) * kTileBytes + align_up(8 * nt * p.x_pitch, 128);
}

// Where tile t lies: 8 N-blocks from nb0, row group mg, K split.
struct Tile {
  int nb0, mg, split, x_key;
  __device__ __forceinline__ Tile(int t, const Plan& p) {
    nb0 = (t % p.n_tiles) * kBlocks;
    x_key = t / p.n_tiles;
    mg = x_key % p.mgroups;
    split = x_key / p.mgroups;
  }
};

// The consumers' x of a tile (rows 8 NT mg.., the split's K columns,
// zeros past M and K), bf16 in K order, row pitch x_pitch bytes.
template <int NT>
__device__ __forceinline__ void load_x(uint8_t* xs,
                                       const __nv_bfloat16* __restrict__ x,
                                       const Plan& p, const Tile& tl) {
  consumer_sync();                  // every warp is done with the last x
  const int m0 = tl.mg * 8 * NT, k0 = tl.split * p.sps * kK;
  const int chunks = p.sps * kK / 8;
  const bool vec = (p.K % 8) == 0;
  for (int i = threadIdx.x; i < 8 * NT * chunks; i += kConsumers) {
    const int m = i / chunks, kc = (i - m * chunks) * 8, k = k0 + kc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + m < p.M && k < p.K) {
      const __nv_bfloat16* src = x + static_cast<size_t>(m0 + m) * p.K + k;
      if (vec && k + 8 <= p.K) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint16_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = k + j < p.K ? __bfloat16_as_ushort(src[j]) : 0;
        v = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                       e[4] | (e[5] << 16), e[6] | (e[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(xs + m * p.x_pitch + 2 * kc) = v;
  }
  consumer_sync();
}

// Lane `lane`'s two K columns kc, kc + 1 of N-block `b` of a stage (raw),
// the 16 rows of each, into the warp's bf16 tile bt (row j: 128 bytes of
// 64 K columns, 16-byte chunk c at c ^ (j % 8)): decode_pair's weights
// (NbSm90's), rounded once to bf16, a row's two columns a word.
__device__ __forceinline__ void tile_pair(const int8_t* raw, int b, int kc,
                                          int slots, int fold, uint8_t* bt) {
  const int lane = threadIdx.x & 31;
  uint32_t cw[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    cw[r] = *reinterpret_cast<const uint16_t*>(raw + (4 * b + r) * kK + kc);
  const uint32_t sw = *reinterpret_cast<const uint16_t*>(
      raw + kSeOff + b * kK + kc);
  const uint32_t ow = *reinterpret_cast<const uint16_t*>(
      raw + kSeoOff + b * kK + kc);
  float w[kRows][2];
  decode_pair<kMaxSlots>(cw, sw, ow, raw + kObOff + b * kK + kc, kSlotBytes,
                         slots, fold, w);
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    *reinterpret_cast<uint32_t*>(bt + j * 128
                                 + (((lane >> 2) ^ (j & 7)) << 4)
                                 + (lane & 3) * 4) =
        mxq::sm90::pack_bf16(w[j][0], w[j][1]);
}

// Consumer warp w: N-block nb0 + w of each tile. Per stage and half of it
// (64 K columns), lane p forms the 16 weights of K columns 2p, 2p + 1
// (decode_pair: one exponent pair and one slot byte pair a slot serve all
// 16), writes them as bf16 to the warp's 16 x 64 tile (row j: 128 bytes,
// 16-byte chunk c at c ^ (j % 8)), and the warp runs 4 mma steps, the A
// fragments by ldmatrix. Fresh accumulators each stage (128 K columns),
// added to the f32 sums.
template <int NT>
__device__ __forceinline__ void consume(const Ring& ring, uint8_t* tiles,
                                        uint8_t* xs,
                                        const __nv_bfloat16* __restrict__ x,
                                        float* __restrict__ ws,
                                        const Plan& p, int Np) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* bt = tiles + warp * kTileBytes;
  // ldmatrix.x4: lane l names row (l % 8) + 8 ((l / 8) % 2) of chunk
  // 2 kk + l / 16
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lhalf = lane >> 4;
  const uint32_t bt_s = mxq::sm90::smem_u32(bt);
  int lo, hi;
  tile_range(p.tiles, lo, hi);
  int it = 0, x_key = -1;
  for (int tt = lo; tt < hi; ++tt) {
    const Tile tl(tt, p);
    if (tl.x_key != x_key) {
      load_x<NT>(xs, x, p, tl);
      x_key = tl.x_key;
    }
    const int nb = tl.nb0 + warp;
    const bool live = nb < p.NB;
    const int slots = live ? p.budget : 0;
    const int s_begin = tl.split * p.sps;
    const int s_end = min(s_begin + p.sps, (p.K + kK - 1) / kK);
    float sum[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[n][r] = 0.f;
    for (int ks = s_begin; ks < s_end; ++ks, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.full(s), (it / ring.stages) & 1);
      const int8_t* raw = reinterpret_cast<const int8_t*>(ring.stage(s));
      if (live) {
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          __syncwarp();                // the last half's ldmatrix reads
          tile_pair(raw, warp, h * 64 + 2 * lane, slots, p.fold, bt);
          __syncwarp();
          const int kx = (ks - s_begin) * kK + h * 64;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t a[4];
            const int chunk = 2 * kk + lhalf;
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
                "[%4];"
                : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                : "r"(bt_s + lrow * 128 + ((chunk ^ (lrow & 7)) << 4))
                : "memory");
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              uint32_t b0, b1;
              x_frag(xs, p.x_pitch, n, kx + 16 * kk, b0, b1);
              mma_bf16(acc[n], a, b0, b1);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) sum[n][r] += acc[n][r];
      }
      __syncwarp();                  // the warp's reads of the stage are done
      if (lane == 0) mxq::sm90::mbar_arrive(ring.empty(s));
    }
    if (!live) continue;
    // d0, d1: column 16 nb + g, rows 2t, 2t + 1; d2, d3: column + 8
    const int m0 = tl.mg * 8 * NT;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 8 * n + 2 * t + (r & 1);
        if (m < p.M)
          ws[(static_cast<size_t>(tl.split) * p.M + m) * Np + kRows * nb + g
             + 8 * (r >> 1)] = sum[n][r];
      }
  }
}

// Warp 8: the copies of each tile's K columns into the ring.
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* codes_map,
                                        const CUtensorMap* se_map,
                                        const CUtensorMap* seo_map,
                                        const CUtensorMap* ob_map,
                                        const int8_t* __restrict__ codes,
                                        const int8_t* __restrict__ se,
                                        const int8_t* __restrict__ seo,
                                        const int8_t* __restrict__ ob,
                                        const Plan& p) {
  const int lane = threadIdx.x & 31;
  const int tx = kObOff + p.budget * kSlotBytes;
  int lo, hi;
  tile_range(p.tiles, lo, hi);
  int it = 0;
  for (int tt = lo; tt < hi; ++tt) {
    const Tile tl(tt, p);
    const int s_begin = tl.split * p.sps;
    const int s_end = min(s_begin + p.sps, (p.K + kK - 1) / kK);
    for (int ks = s_begin; ks < s_end; ++ks, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.empty(s), ((it / ring.stages) & 1) ^ 1);
      int8_t* raw = reinterpret_cast<int8_t*>(ring.stage(s));
      const int k0 = ks * kK;
      if (p.tma) {
        if (lane == 0) {
          using mxq::sm90::tma_load_2d;
          mxq::sm90::mbar_expect_tx(ring.full(s), tx);
          tma_load_2d(raw, codes_map, k0, 4 * tl.nb0, ring.full(s));
          tma_load_2d(raw + kSeOff, se_map, k0, tl.nb0, ring.full(s));
          tma_load_2d(raw + kSeoOff, seo_map, k0, tl.nb0, ring.full(s));
          // rows past NB of slot s are slot s + 1's; no warp reads a slot
          // of an N-block past NB
          for (int sl = 0; sl < p.budget; ++sl)
            tma_load_2d(raw + kObOff + sl * kSlotBytes, ob_map, k0,
                        sl * p.NB + tl.nb0, ring.full(s));
        }
      } else {
        // plain copies, zeros outside the weight
#pragma unroll 1
        for (int c = lane; c < tx; c += 32) {
          const int row = c / kK, k = k0 + c % kK;
          int8_t v = 0;
          if (k < p.K) {
            if (c < kSeOff) {
              if (4 * tl.nb0 + row < 4 * p.NB)
                v = codes[static_cast<size_t>(4 * tl.nb0 + row) * p.K + k];
            } else if (c < kObOff) {
              const int i = row - 4 * kBlocks, nb = tl.nb0 + i % kBlocks;
              if (nb < p.NB)
                v = (i < kBlocks ? se : seo)[static_cast<size_t>(nb) * p.K
                                             + k];
            } else {
              const int i = row - 6 * kBlocks;
              const int sl = i / kBlocks, nb = tl.nb0 + i % kBlocks;
              if (nb < p.NB)
                v = ob[(static_cast<size_t>(sl) * p.NB + nb) * p.K + k];
            }
          }
          raw[c] = v;
        }
        mxq::sm90::mbar_arrive(ring.full(s));
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
nb_gemv(const __grid_constant__ CUtensorMap codes_map,
        const __grid_constant__ CUtensorMap se_map,
        const __grid_constant__ CUtensorMap seo_map,
        const __grid_constant__ CUtensorMap ob_map,
        const __nv_bfloat16* __restrict__ x,
        const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
        const int8_t* __restrict__ seo, const int8_t* __restrict__ ob,
        float* __restrict__ ws, const Plan p, int Np) {
  extern __shared__ uint8_t gemv_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gemv_smem) + kAlign - 1)
      & ~uintptr_t(kAlign - 1));
  const Ring ring{base + kBarBytes, mxq::sm90::smem_u32(base), p.stages,
                  p.stage_bytes};
  uint8_t* tiles = base + kBarBytes + p.stages * p.stage_bytes;
  uint8_t* xs = tiles + (kConsumers / 32) * kTileBytes;
  init_ring(ring, p.tma != 0);
  if (take_role())
    consume<NT>(ring, tiles, xs, x, ws, p, Np);
  else if (threadIdx.x / 32 == kConsumers / 32)
    produce(ring, &codes_map, &se_map, &seo_map, &ob_map, codes, se, seo, ob,
            p);
}

template <int NT>
int launch(const void* x, const int8_t* codes, const int8_t* se,
           const int8_t* seo, const int8_t* ob, float* ws, const Plan& p,
           int Np, int ctas, int smem, cudaStream_t st) {
  auto kernel = nb_gemv<NT>;
  CUtensorMap maps[4] = {};
  if (p.tma) {
    using mxq::sm90::raw_tensor_map;
    int err = raw_tensor_map(&maps[0], codes, 1, p.K, 4LL * p.NB, kK,
                             4 * kBlocks);
    if (err == 0)
      err = raw_tensor_map(&maps[1], se, 1, p.K, p.NB, kK, kBlocks);
    if (err == 0)
      err = raw_tensor_map(&maps[2], seo, 1, p.K, p.NB, kK, kBlocks);
    if (err == 0 && p.budget > 0)
      err = raw_tensor_map(&maps[3], ob, 1, p.K,
                           static_cast<long long>(p.budget) * p.NB, kK,
                           kBlocks);
    if (err != 0) return err;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3],
      static_cast<const __nv_bfloat16*>(x), codes, se, seo, ob, ws, p, Np);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int occupancy(int smem, int* blocks) {
  auto kernel = nb_gemv<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kThreads, smem);
  return static_cast<int>(e);
}

}  // namespace gv

}  // namespace

// x: (M, K) bf16, 16-byte aligned; codes: (Np/4, K) int8; se, seo: (NB, K)
// int8 with NB = Np/16; ob: (budget, NB, K) int8; ws: (ksplit, M, Np) f32
// scratch; out: (M, N) bf16 or f32 with N <= Np. The plan (ksplit, sps
// 128-column stages a split, stages, ctas, smem) is outlier_matmul.py::
// nb_gemv_plan's; smem must be the bytes that it implies here. Returns the
// cudaError_t of the launches (0 on success; cudaErrorInvalidValue for a
// plan or operands the kernel refuses).
extern "C" int dequant_gemv_nb(const void* x, const void* codes,
                               const void* se, const void* seo,
                               const void* ob, void* ws, void* out, int M,
                               int K, int Np, int N, int budget, int fold,
                               int ksplit, int sps, int stages, int ctas,
                               int smem, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  gv::Plan p{};
  p.M = M; p.K = K; p.NB = Np / kRows; p.budget = budget; p.fold = fold;
  p.ksplit = ksplit; p.sps = sps; p.stages = stages;
  const int nt = mxq::gemv_tc::n8_tiles(M);
  p.mgroups = (M + 8 * nt - 1) / (8 * nt);
  p.n_tiles = (p.NB + gv::kBlocks - 1) / gv::kBlocks;
  p.tiles = p.mgroups * p.n_tiles * ksplit;
  p.tma = K % 16 == 0 && aligned(codes) && aligned(se) && aligned(seo)
          && (budget == 0 || aligned(ob));
  p.stage_bytes = gv::stage_bytes(budget);
  p.x_pitch = sps * gv::kK * 2 + 16;
  if (M < 1 || budget < 0 || Np % kRows != 0 || sps < 1 || stages < 2
      || stages > gv::kMaxStages || ctas < 1
      || static_cast<long long>(ksplit) * sps * gv::kK < K || !aligned(x)
      || smem != gv::smem_bytes(p, nt))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  const auto* op = static_cast<const int8_t*>(seo);
  const auto* bp = static_cast<const int8_t*>(ob);
  auto* wp = static_cast<float*>(ws);
  int err;
#define MXQ_NB_GEMV(NT) \
  err = gv::launch<NT>(x, cp, sp, op, bp, wp, p, Np, ctas, smem, st)
  switch (nt) {
    case 1: MXQ_NB_GEMV(1); break;
    case 2: MXQ_NB_GEMV(2); break;
    case 4: MXQ_NB_GEMV(4); break;
    default: MXQ_NB_GEMV(8); break;
  }
#undef MXQ_NB_GEMV
  if (err != 0) return err;
  return mxq::launch_split_reduce(wp, out, M, Np, N, ksplit, out_bf16, st);
}

// Blocks of nb_gemv that one SM holds at once for M rows and smem bytes of
// dynamic shared memory, into *blocks. Returns the cudaError_t of the query.
extern "C" int nb_gemv_occupancy(int M, int smem, void* blocks) {
  int* b = static_cast<int*>(blocks);
  switch (mxq::gemv_tc::n8_tiles(M)) {
    case 1: return gv::occupancy<1>(smem, b);
    case 2: return gv::occupancy<2>(smem, b);
    case 4: return gv::occupancy<4>(smem, b);
    default: return gv::occupancy<8>(smem, b);
  }
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
