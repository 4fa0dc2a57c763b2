// Two-level outlier side-band matmuls: y = x @ dequant(W) for a
// PackedMXOutlier (K, N) weight blocked along K. Two kernels:
// - dequant_gemv_outlier, for M < 256 tokens: every linear of a decode step
//   of the side-band format, the last_only lm_head and engine prefills;
// - dequant_gemm_outlier, for M >= 256: every linear of a long prefill
//   (outlier_gemm_sm90; gemm_any.cu's sideband_any_sm90 at the blocks it
//   does not take; outlier_gemm where a test forces it).
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
// GEMV design (for the H100): the weight is streamed, nothing else.
// - A persistent CTA an SM (384 threads: 8 consumer warps and a copying
//   warpgroup, one warp of which works; setmaxnreg gives the others'
//   registers to the consumers) walks over tiles of 128 columns x one K
//   split x up to 8 rows of x. The producer keeps a ring of 2-8 stages (up to ~150 KB) of raw
//   operands in flight: the code and exponent rows by 2-D TMA, each
//   K-block's outlier codes and int32 positions by 1-D bulk copies, behind
//   mbarriers (plain copies where N % 16 != 0).
// - The consumers keep the split's x in shared memory (f32, loaded once a
//   tile, no barrier per stage) and read 16-byte vectors of codes: a
//   thread sums 16 columns of some rows of one K-block of each stage for
//   up to 8 rows of x. The inliers are code · 2^(se - fold) (bf16-exact
//   for int8 codes; float8 ones rounded once to bf16). The slots cost no
//   compare per weight: for each row that slots name, one thread adds
//   x · (w - w0), w being the side-band weight (the bf16 sum of the
//   inlier and the row's slots in slot order) and w0 the inlier that the
//   sweep added. Only the order of the f32 sum differs from the plain
//   twin.
// - K is split by a count that depends only on (N, K-blocks): enough
//   splits to give ~4 tiles an SM and at most 1024 K rows of x a split.
//   Each split's f32 partial sums the tile's row groups in a fixed order,
//   and split_reduce adds the splits in split order, so a row's result
//   does not depend on M. outlier_matmul.py::outlier_gemv_plan chooses
//   the stage size, the ring and the split before the launch.
//
// GEMM design: gemm_sm90.cuh's wgmma + TMA mainloop (256 x 128 output
// tile, 64-deep K steps, a decode warpgroup feeding two wgmma
// warpgroups), with the side-band decode: the raw copy of a step holds the
// step's 64 inlier code rows, the exponents, the outlier codes and the
// positions of its K-blocks. Each decode thread owns one column and forms
// the B weights of each K-block in registers with the side-band weight's
// arithmetic, code · 2^(se - fold), then the slots added in slot order,
// one bf16 rounding, and writes them to the K-major B tile, so no f32 tile
// and no extra barrier lie between the decode and the MMA. The kernel is
// templated on the budget (1, 2, 4 or 8 slots read; a smaller budget
// reads its own slots and adds nothing for the rest, as the TPU kernel
// does)
// and on the block (8, 16, 32 or 64, which divide the K step). At B = 64
// a step holds one K-block, so the second of two decode warpgroups idles:
// splitting a column between two threads would make each scan every slot
// for the rows of its half, and no configuration that the port serves uses
// the side-band format at block 64. Blocks that do not divide the K step
// (48, 96, 128, ...), and B = 8 with 8 slots, whose raw copy (51 KB a
// step) leaves no room for a ring, run on gemm_any.cu's sideband_any_sm90
// (the block at run time, smaller copies). outlier_gemm, common.cuh's bf16
// wmma tile loop (128 x 128 output tile, 32-deep K steps) with the weight
// tile built in f32 in shared memory, the slots added by one thread per
// (K-block, column), then rounded to the bf16 B tile, is left to the tests
// that force it. outlier_matmul.py::dequant_gemm_outlier chooses the
// kernel by block and slot count before the launch
// (dequant_matmul.py::gemm_route, sm90_plan's "any").
// The weights are the GEMV's bf16 weights; the tensor cores' f32
// accumulation differs from a CUDA-core sum in order and internal rounding
// (the emi8 GEMM's 2e-3 tolerance).
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

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

// decode() for the GEMM's decoder (whose own decode() would hide it), with
// Hopper's float8 -> f16 convert for float8_e4m3fn codes: exact, and equal
// to e4m3_to_f32 for every code but NaN, which the formats never store.
__device__ __forceinline__ float decode_code(int8_t c, int fp8) {
  if (!fp8) return static_cast<float>(c);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(c), __NV_E4M3)));
}

// The side-band decoder of gemm_sm90.cuh's mainloop, for K-blocks of B
// rows and MAXB slots read (budget <= MAXB). Raw copy of a 64-row step,
// 128 columns: the inlier codes [64][128], se and seo [64/B][128], then
// the outlier codes and the positions (int32): the 128 * budget slots of a
// block row in boxes of sbox (128 or 256), [box][64/B][sbox], each region
// sized for MAXB slots. A decode thread
// owns one column of a block: it writes the inliers' bf16 weights
// (code · 2^(se - fold)), then, for each row that a slot names, the sum of
// the side-band weight: the inlier, then every slot naming the row in slot
// order, one rounding. The TPU kernel's adding +0 for the other slots
// changes no nonzero value and turns -0 into +0, which the final + 0.f
// does here.
template <int MAXB, int B>
struct SidebandSm90 {
  static_assert(B == 8 || B == 16 || B == 32 || B == 64,
                "block of 8, 16, 32 or 64");
  static constexpr int kN = mxq::sm90::kBN, kBlocks = mxq::sm90::kBK / B;
  static constexpr int kSeOff = mxq::sm90::kBK * kN;
  static constexpr int kSeoOff = kSeOff + kBlocks * kN;
  static constexpr int kOcOff = kSeoOff + kBlocks * kN;
  static constexpr int kPosOff = kOcOff + kBlocks * kN * MAXB;
  static constexpr int kRawBytes = kPosOff + kBlocks * kN * MAXB * 4;
  // the ring (within 227 KB): 3 stages; 3 raw buffers up to 4 slots where
  // they fit (not at B = 8 with 4 slots), else 2
  static constexpr bool kThreeRaw =
      MAXB <= 4
      && mxq::sm90::ring_bytes(3, kRawBytes, 3) <= mxq::sm90::kMaxSmem;
  static constexpr int kStages = 3, kRawBufs = kThreeRaw ? 3 : 2;
  // two decode warpgroups (96 registers each) up to 4 slots; eight slots'
  // operands need one warpgroup's 136
  static constexpr int kDwg = MAXB <= 4 ? 2 : 1;

  const int8_t* __restrict__ codes;     // (Kp, N)
  const int8_t* __restrict__ se;        // (NB, N)
  const int8_t* __restrict__ seo;       // (NB, N)
  const int8_t* __restrict__ oc;        // (NB, N, budget)
  const int* __restrict__ pos;          // (NB, N, budget)
  const CUtensorMap* codes_map;         // codes, box 64 x 128
  const CUtensorMap* se_map;            // se and seo, box 64/B x 128
  const CUtensorMap* seo_map;
  const CUtensorMap* oc_map;            // oc and pos as (NB, N * budget),
  const CUtensorMap* pos_map;           // boxes of 64/B rows x sbox
  int N, NB, budget, fold, codes_fp8, oc_fp8, sbox_log2;
  bool tma;          // N % 16 == 0 and 16-byte aligned operands

  // index of slot e (= column * budget + slot) of block blk in the oc and
  // pos regions
  __device__ __forceinline__ int slot_at(int blk, int e) const {
    const int sbox = 1 << sbox_log2;
    return (e >> sbox_log2) * (kBlocks * sbox) + blk * sbox
           + (e & (sbox - 1));
  }

  __device__ __forceinline__ int tx_bytes() const {
    return kN * (mxq::sm90::kBK + kBlocks * (2 + 5 * budget));
  }

  __device__ __forceinline__ void copy_tma(int8_t* raw, int k0, int n0,
                                           uint32_t bar) const {
    using mxq::sm90::tma_load_2d;
    const int nb0 = k0 / B;
    tma_load_2d(raw, codes_map, n0, k0, bar);
    tma_load_2d(raw + kSeOff, se_map, n0, nb0, bar);
    tma_load_2d(raw + kSeoOff, seo_map, n0, nb0, bar);
    const int span = kN * budget, sbox = 1 << sbox_log2;
    for (int e = 0; e < span; e += sbox) {      // [box][64/B][sbox]
      tma_load_2d(raw + kOcOff + kBlocks * e, oc_map, n0 * budget + e, nb0,
                  bar);
      tma_load_2d(raw + kPosOff + 4 * kBlocks * e, pos_map, n0 * budget + e,
                  nb0, bar);
    }
  }

  template <int DWG>
  __device__ __forceinline__ void copy(int8_t* raw, int k0, int n0,
                                       int t) const {
    constexpr int nt = 128 * DWG;
    const int nb0 = k0 / B, span = kN * budget;
    for (int c = t; c < mxq::sm90::kBK * kN; c += nt) {         // codes
      const int k = k0 + c / kN, n = n0 + c % kN;
      raw[c] = (k < NB * B && n < N) ? codes[static_cast<size_t>(k) * N + n]
                                     : static_cast<int8_t>(0);
    }
    for (int c = t; c < 2 * kBlocks * kN; c += nt) {           // se, seo
      const int i = c / kN, nb = nb0 + i % kBlocks, n = n0 + c % kN;
      const int8_t* src = i < kBlocks ? se : seo;
      raw[kSeOff + c] = (nb < NB && n < N)
                            ? src[static_cast<size_t>(nb) * N + n]
                            : static_cast<int8_t>(0);
    }
    int* rpos = reinterpret_cast<int*>(raw + kPosOff);
    for (int c = t; c < kBlocks * span; c += nt) {             // oc, pos
      const int blk = c / span, e = c % span, nb = nb0 + blk;
      const bool live = nb < NB && n0 + e / budget < N;
      const size_t g = (static_cast<size_t>(nb) * N + n0) * budget + e;
      raw[kOcOff + slot_at(blk, e)] = live ? oc[g] : static_cast<int8_t>(0);
      rpos[slot_at(blk, e)] = live ? pos[g] : 0;
    }
  }

  template <bool CF8, int DWG>
  __device__ __forceinline__ void decode_col(const int8_t* raw, uint8_t* b,
                                             int t) const {
    const int col = t % kN;
#pragma unroll 1
    for (int blk = t / kN; blk < kBlocks; blk += DWG) {
      const int s_in = raw[kSeOff + blk * kN + col];
      const float sc_in = exp2_i32(s_in - fold);
      const int8_t* cr = raw + blk * B * kN + col;
      // the inliers, 8 rows a chunk (an fp8 -0 code gives +0, as in the TPU
      // kernel)
#pragma unroll
      for (int c8 = 0; c8 < B / 8; ++c8) {
        uint32_t u[4];
#pragma unroll
        for (int r = 0; r < 8; r += 2) {
          float lo = decode_code(cr[(8 * c8 + r) * kN], CF8) * sc_in;
          float hi = decode_code(cr[(8 * c8 + r + 1) * kN], CF8) * sc_in;
          if (CF8) {
            lo += 0.f;
            hi += 0.f;
          }
          u[r / 2] = mxq::sm90::pack_bf16(lo, hi);
        }
        mxq::sm90::store_b_chunk(b, col, blk * B / 8 + c8,
                                 make_uint4(u[0], u[1], u[2], u[3]));
      }
      // the rows that slots name: every slot's operands loaded first
      const float sc_out =
          exp2_i32(static_cast<int>(raw[kSeoOff + blk * kN + col]) - s_in);
      const int8_t* ocb = raw + kOcOff;
      const int* pb = reinterpret_cast<const int*>(raw + kPosOff);
      int opos[MAXB];
      float oval[MAXB], inl[MAXB];
#pragma unroll
      for (int s = 0; s < MAXB; ++s) {
        const bool in = s < budget;
        const int at = slot_at(blk, col * budget + s);
        opos[s] = in ? pb[at] : -1;
        oval[s] = in ? decode_code(ocb[at], oc_fp8) * sc_out : 0.f;
        const int r = min(max(opos[s], 0), B - 1);
        inl[s] = decode_code(cr[r * kN], CF8) * sc_in;
      }
#pragma unroll
      for (int s = 0; s < MAXB; ++s) {
        const int r = opos[s];
        bool first = r >= 0 && r < B;
#pragma unroll
        for (int p = 0; p < s; ++p) first = first && opos[p] != r;
        if (first) {
          float v = inl[s];
#pragma unroll
          for (int p = s; p < MAXB; ++p) v += (opos[p] == r) ? oval[p] : 0.f;
          mxq::sm90::store_b_elem(b, col, blk * B + r, v + 0.f);
        }
      }
    }
  }

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    if (codes_fp8)
      decode_col<true, DWG>(raw, b, t);
    else
      decode_col<false, DWG>(raw, b, t);
  }
};

// grid: M tiles x N tiles of 256 x 128 (gemm_sm90.cuh); x (M, K) bf16 with
// K % 8 == 0 through xmap; the raw operands through the five maps where
// tma is set.
template <int MAXB, int B>
__global__ void __launch_bounds__(
    mxq::sm90::threads(SidebandSm90<MAXB, B>::kDwg), 1)
outlier_gemm_sm90(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap codes_map,
                  const __grid_constant__ CUtensorMap se_map,
                  const __grid_constant__ CUtensorMap seo_map,
                  const __grid_constant__ CUtensorMap oc_map,
                  const __grid_constant__ CUtensorMap pos_map,
                  const int8_t* __restrict__ codes,
                  const int8_t* __restrict__ se,
                  const int8_t* __restrict__ seo,
                  const int8_t* __restrict__ oc, const int* __restrict__ pos,
                  void* out, int M, int K, int N, int NB, int budget,
                  int fold, int codes_fp8, int oc_fp8, int out_bf16,
                  int sbox_log2, int tma) {
  using Dec = SidebandSm90<MAXB, B>;
  Dec dec{codes, se, seo, oc, pos, &codes_map, &se_map, &seo_map, &oc_map,
          &pos_map, N, NB, budget, fold, codes_fp8, oc_fp8, sbox_log2,
          tma != 0};
  mxq::sm90::gemm<Dec::kStages, Dec::kRawBufs, Dec::kDwg>(&xmap, out, M, N,
                                                         K, out_bf16, dec);
}

template <int MAXB, int B>
int launch_sideband(const void* x, const int8_t* codes, const int8_t* se,
                    const int8_t* seo, const int8_t* oc, const int* pos,
                    void* out, int M, int K, int N, int NB, int budget,
                    int fold, int codes_fp8, int oc_fp8, int out_bf16,
                    int tma, cudaStream_t st) {
  using Dec = SidebandSm90<MAXB, B>;
  constexpr int smem =
      mxq::sm90::Ring<Dec::kStages, Dec::kRawBytes, Dec::kRawBufs>::kBytes;
  // oc / pos boxes of 64/B rows and sbox slots: 128 * budget where that is
  // <= 256, else 256 (even budgets) or 128 (odd ones), which divide it
  const int span = Dec::kN * budget;
  const int sbox = span <= 256 ? span : budget % 2 == 0 ? 256 : 128;
  const int sbox_log2 = sbox == 256 ? 8 : 7;
  CUtensorMap maps[5] = {};
  if (tma) {
    using mxq::sm90::raw_tensor_map;
    const long long nsb = static_cast<long long>(N) * budget;
    int err = raw_tensor_map(&maps[0], codes, 1, N,
                             static_cast<long long>(NB) * B, Dec::kN,
                             mxq::sm90::kBK);
    if (err == 0)
      err = raw_tensor_map(&maps[1], se, 1, N, NB, Dec::kN, Dec::kBlocks);
    if (err == 0)
      err = raw_tensor_map(&maps[2], seo, 1, N, NB, Dec::kN, Dec::kBlocks);
    if (err == 0 && budget > 0)
      err = raw_tensor_map(&maps[3], oc, 1, nsb, NB, sbox, Dec::kBlocks);
    if (err == 0 && budget > 0)
      err = raw_tensor_map(&maps[4], pos, 4, nsb, NB, sbox, Dec::kBlocks);
    if (err != 0) return err;
  }
  return mxq::sm90::launch<Dec::kDwg>(
      outlier_gemm_sm90<MAXB, B>, smem, x, M, N, K, st, maps[0], maps[1],
      maps[2], maps[3], maps[4], codes, se, seo, oc, pos, out, M, K, N, NB,
      budget, fold, codes_fp8, oc_fp8, out_bf16, sbox_log2, tma);
}

// ---------------------------------------------------------------------------
// The side-band GEMV (M < 256): a persistent, warp-specialised stream
// ---------------------------------------------------------------------------
// Work: tiles of 128 columns x one K split (nbps K-blocks) x one group of
// MT rows of x; tile t is (m group t % mgroups, column tile, split), so the
// M groups of one weight tile run side by side and share it in L2. One CTA
// an SM (384 threads: two consumer warpgroups and a copying one) walks
// over the tiles gridDim.x apart.
// - Warp 8 streams each tile's K-blocks through a ring of `stages` stages
//   in shared memory, sb K-blocks a stage: the inlier code rows and the
//   se / seo rows by 2-D TMA boxes (128 columns; rows past the weight
//   zero-filled), each K-block's outlier codes and positions (contiguous,
//   128 x budget slots) by 1-D bulk copies, all on the stage's "full"
//   mbarrier with their byte count. Where the rows are no multiple of 16
//   bytes (N % 16 != 0) or an operand is not 16-byte aligned, its 32 lanes
//   copy with plain loads (the kernel's TMA = false instance) and each
//   arrives on "full". It waits on the
//   stage's "empty" mbarrier (one arrival a consumer warp) before reuse.
//   Warps 9-11 exit after setmaxnreg has given their registers to the
//   consumers.
// - The consumers (warps 0-7) hold the tile's x (MT rows, the split's K
//   rows, f32) in shared memory, loaded once a tile whose (m group,
//   split) differs from the last: no barrier per stage.
// - The inlier sweep: thread (warp w, lane l) owns the 16 columns
//   16 (l % 8).. of the tile (one 16-byte read of a code row) and row group
//   g = 4 w + l / 8 of 32: group g reads K-block g / (32 / sb) of a stage,
//   rows rpt (g % (32 / sb)).. of it. A weight is code · 2^(se - fold)
//   (int8 codes through the 2^23 bias, exact; float8 codes through the
//   paired convert, then one bf16 rounding), summed in f32 against x, MT
//   rows at a time.
// - The slots need no compare per weight: thread t takes column t % 128
//   of every other K-block of a stage (t / 128 picks which) and, for each
//   row that a slot names (first occurrence), adds x · (w(row) - w0(row)),
//   w(row) being the side-band weight, the bf16 sum of the inlier and
//   every slot naming the row in slot order, and w0 the inlier alone,
//   which the sweep added.
// - At the tile's end the four row lanes of a column chunk are summed by
//   shuffles, then the 8 warps' sums and the 2 slot sums of each (row,
//   column) in that fixed order into the split's f32 partial; split_reduce
//   adds the splits in order. Nothing of this order depends on M.
namespace gemv {

constexpr int kTN = 128;                 // columns a tile
constexpr int kConsumers = 256;          // warpgroups 0-1
constexpr int kThreads = kConsumers + 128;    // + warpgroup 2: the copies
// registers a thread after setmaxnreg (384 threads start with 168): the
// consumers' 16 x MT sums need more; the copying warpgroup (one warp of it
// works) gives them its own. The consumers take no more than the copiers
// release.
constexpr int kConsumeRegs = 224, kCopyRegs = 48;
static_assert(256 * (kConsumeRegs - 168) <= 128 * (168 - kCopyRegs),
              "the consumers take more registers than the copiers give");
constexpr int kRowGroups = 32;
constexpr int kBarBytes = 256;           // full and empty barriers, <= 16
constexpr int kAlign = 128;              // slack for aligning the base

struct Plan {
  int M, K, N, NB, B, budget, fold, oc_fp8;
  int ksplit, nbps, sb, rpt, stages, mgroups, col_tiles, tiles, tma;
  int x_pad, stage_bytes;
};

// Dynamic shared memory of a plan (outlier_matmul.py::outlier_gemv_plan
// mirrors it): alignment slack, barriers, x, the reduction, the ring.
__host__ __device__ inline int red_bytes(int mt) {
  return (8 + 2) * mt * kTN * 4;
}
__host__ __device__ inline int smem_bytes(const Plan& p, int mt) {
  return kAlign + kBarBytes + p.x_pad + red_bytes(mt)
         + p.stages * p.stage_bytes;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(mxq::sm90::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
        "r"(bytes), "r"(bar)
      : "memory");
}

// mbar_wait that traps after ~2^26 polls (seconds) instead of spinning
// forever, so that a byte count that never completes ends the launch with
// an error rather than hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (int i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (i > (1 << 26)) __trap();
  }
}

// Barrier 1 over the consumers.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 codes (one 16-byte read) times their columns' scales: int8 codes are
// exact in bf16 after the power-of-two scale (at most 8 significant bits,
// the scale at least 2^-126), float8 ones are rounded once to bf16.
template <bool FP8>
__device__ __forceinline__ void decode16(uint4 cv, const float (&sc)[16],
                                         float (&w)[16]) {
  const uint32_t wd[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (FP8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const auto pair = static_cast<__nv_fp8x2_storage_t>(
            (wd[q] >> (16 * h)) & 0xFFFF);
        const float2 f = __half22float2(
            __half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
        const uint32_t u = mxq::sm90::pack_bf16(f.x * sc[4 * q + 2 * h],
                                                f.y * sc[4 * q + 2 * h + 1]);
        w[4 * q + 2 * h] = __uint_as_float(u << 16);
        w[4 * q + 2 * h + 1] = __uint_as_float(u & 0xFFFF0000u);
      }
    } else {
      const uint32_t ux = wd[q] ^ 0x80808080u;     // byte b: code + 128
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // the f32 2^23 + code + 128, less 2^23 + 128: the code, exactly
        const float f =
            __uint_as_float(__byte_perm(ux, 0x4B000000u, 0x7540u | b))
            - 8388736.f;
        w[4 * q + b] = f * sc[4 * q + b];
      }
    }
  }
}

template <bool FP8>
__device__ __forceinline__ float code_value(int8_t c) {
  return decode_code(c, FP8);
}

// x rows (MT floats, 16-byte aligned for MT >= 4) into registers.
template <int MT>
__device__ __forceinline__ void load_x(const float* xr, float (&xv)[MT]) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int m = 0; m < MT; m += 4) {
      const float4 f = *reinterpret_cast<const float4*>(xr + m);
      xv[m] = f.x; xv[m + 1] = f.y; xv[m + 2] = f.z; xv[m + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) xv[m] = xr[m];
  }
}

// The budget slots of one (K-block, column) of a stage: positions (-1
// past the budget) and outlier codes, by the widest loads that the budget
// allows.
__device__ __forceinline__ void stage_slots(const int* ps, const int8_t* os,
                                            int budget,
                                            int (&pr)[kMaxBudget],
                                            int8_t (&oc)[kMaxBudget]) {
#pragma unroll
  for (int s = 0; s < kMaxBudget; ++s) {
    pr[s] = -1;
    oc[s] = 0;
  }
  if (budget % 4 == 0) {
#pragma unroll
    for (int h = 0; h < kMaxBudget / 4; ++h) {
      if (4 * h >= budget) break;
      const int4 v = reinterpret_cast<const int4*>(ps)[h];
      const uint32_t c = reinterpret_cast<const uint32_t*>(os)[h];
      pr[4 * h] = v.x; pr[4 * h + 1] = v.y;
      pr[4 * h + 2] = v.z; pr[4 * h + 3] = v.w;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        oc[4 * h + i] = static_cast<int8_t>((c >> (8 * i)) & 0xFF);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kMaxBudget; ++s) {
      if (s >= budget) break;
      pr[s] = ps[s];
      oc[s] = os[s];
    }
  }
}

// Block b's slots in column sn, each row that they name corrected once:
// corr += x[row] · (w - w0), w the side-band weight (the inlier and every
// slot naming the row in slot order, rounded once to bf16), w0 the inlier
// that the sweep added. Rows named once (the packers' positions are
// distinct) take one add; a row named twice takes the general sum.
template <int MT, bool FP8>
__device__ __forceinline__ void correct_slots(
    const uint8_t* st, int b, int sn, int se_off, int seo_off, int oc_off,
    int pos_off, const float* xb, const Plan& p, float (&corr)[MT]) {
  const int e = (b * kTN + sn) * p.budget;
  int pr[kMaxBudget];
  int8_t oc[kMaxBudget];
  stage_slots(reinterpret_cast<const int*>(st + pos_off) + e,
              reinterpret_cast<const int8_t*>(st + oc_off) + e, p.budget, pr,
              oc);
  bool twice = false;
#pragma unroll
  for (int s1 = 1; s1 < kMaxBudget; ++s1) {
    if (s1 >= p.budget) break;
#pragma unroll
    for (int s0 = 0; s0 < s1; ++s0)
      twice = twice || (pr[s1] >= 0 && pr[s0] == pr[s1]);
  }
  const int s_in = static_cast<int8_t>(st[se_off + b * kTN + sn]);
  const float sc_in = exp2_i32(s_in - p.fold);
  const float sc_out = exp2_i32(
      static_cast<int>(static_cast<int8_t>(st[seo_off + b * kTN + sn]))
      - s_in);
  // rows named once: branch-free in groups of four slots (the budget's
  // test is the same in every thread), so that the slots' loads overlap;
  // an empty slot, or any slot of a column where a row is named twice,
  // reads row 0 and adds 0
#pragma unroll
  for (int h = 0; h < kMaxBudget / 4; ++h) {
    if (4 * h >= p.budget) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s1 = 4 * h + i, r = pr[s1];
      const bool live = !twice && r >= 0 && r < p.B;
      const int rr = live ? r : 0;
      const float v0 = code_value<FP8>(static_cast<int8_t>(
                           st[(b * p.B + rr) * kTN + sn])) * sc_in;
      const float o = p.oc_fp8 ? code_value<true>(oc[s1])
                               : static_cast<float>(oc[s1]);
      const uint32_t u = mxq::sm90::pack_bf16(v0 + o * sc_out, v0);
      const float d = live ? __uint_as_float(u << 16)
                                 - __uint_as_float(u & 0xFFFF0000u)
                           : 0.f;
      float xv[MT];
      load_x<MT>(xb + rr * MT, xv);
#pragma unroll
      for (int m = 0; m < MT; ++m) corr[m] = fmaf(xv[m], d, corr[m]);
    }
  }
  if (!twice) return;
#pragma unroll
  for (int s1 = 0; s1 < kMaxBudget; ++s1) {
    if (s1 >= p.budget) break;
    const int r = pr[s1];
    if (r < 0 || r >= p.B) continue;
    bool first = true;
#pragma unroll
    for (int s0 = 0; s0 < s1; ++s0) first = first && pr[s0] != r;
    if (!first) continue;
    const float v0 = code_value<FP8>(static_cast<int8_t>(
                         st[(b * p.B + r) * kTN + sn])) * sc_in;
    float v = v0;
#pragma unroll
    for (int s2 = s1; s2 < kMaxBudget; ++s2)
      if (s2 < p.budget && pr[s2] == r)
        v += decode_code(oc[s2], p.oc_fp8) * sc_out;
    const float d = bf16_round(v) - bf16_round(v0);
    float xv[MT];
    load_x<MT>(xb + r * MT, xv);
#pragma unroll
    for (int m = 0; m < MT; ++m) corr[m] = fmaf(xv[m], d, corr[m]);
  }
}

// Where tile t lies: its m group, first column, split and K-blocks.
struct Tile {
  int mg, n0, split, nb_begin, nb_end;
  __device__ __forceinline__ Tile(int t, const Plan& p) {
    mg = t % p.mgroups;
    const int rest = t / p.mgroups;
    n0 = (rest % p.col_tiles) * kTN;
    split = rest / p.col_tiles;
    nb_begin = split * p.nbps;
    nb_end = min(p.NB, nb_begin + p.nbps);
  }
  __device__ __forceinline__ int x_key(const Plan& p) const {
    return mg + p.mgroups * split;
  }
};

// The ring's stage pointers and barriers.
struct Ring {
  uint8_t* base;
  uint32_t bars;
  int stages, stage_bytes;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (stages + s);
  }
  __device__ __forceinline__ uint8_t* stage(int s) const {
    return base + s * stage_bytes;
  }
};

// The consumers' x of a tile (MT rows, the split's K rows), f32, [k][MT],
// loaded by all of them between two barriers when (m group, split)
// changes.
template <int MT>
__device__ __forceinline__ void load_tile_x(float* xs,
                                            const __nv_bfloat16* x,
                                            const Plan& p, const Tile& tl,
                                            int& x_key) {
  if (x_key == tl.x_key(p)) return;
  consumer_sync();
  const int m0 = tl.mg * MT, k0 = tl.nb_begin * p.B;
  const int span = (tl.nb_end - tl.nb_begin) * p.B;
  for (int i = threadIdx.x; i < MT * span; i += kConsumers) {
    const int m = i / span, k = i % span;
    float v = 0.f;
    if (m0 + m < p.M && k0 + k < p.K)
      v = __bfloat162float(x[static_cast<size_t>(m0 + m) * p.K + k0 + k]);
    xs[k * MT + m] = v;
  }
  consumer_sync();
  x_key = tl.x_key(p);
}

// The tile's f32 partial: per (row, column) the 8 consumer warps' sums of
// the inliers, then the two slot sums, in that order (after the barrier
// that publishes them), by all the consumers.
template <int MT>
__device__ __forceinline__ void store_tile(const float* red, float* ws,
                                           const Plan& p, const Tile& tl) {
  consumer_sync();
  const int m0 = tl.mg * MT;
  for (int i = threadIdx.x; i < MT * kTN; i += kConsumers) {
    const int m = i / kTN, c = i % kTN;
    float sum = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 10; ++w8) sum += red[(w8 * MT + m) * kTN + c];
    if (m0 + m < p.M && tl.n0 + c < p.N)
      ws[(static_cast<size_t>(tl.split) * p.M + m0 + m) * p.N + tl.n0 + c] =
          sum;
  }
}

// The consumers (warpgroups 0-1). The inlier sweep: thread (warp w, lane
// l) owns the 16 columns 16 (l % 8).. of the tile and row group
// g = 4 w + l / 8: rows rpt (g % (32 / sb)).. of block g / (32 / sb) of
// each stage. The slots: thread t takes column t % 128 of the stage's
// blocks t / 128, t / 128 + 2, ...
template <int MT, bool FP8>
__device__ __forceinline__ void consume(const Ring& ring, float* xs,
                                        float* red, float* ws,
                                        const __nv_bfloat16* x,
                                        const Plan& p, int se_off,
                                        int seo_off, int oc_off,
                                        int pos_off) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int cc = lane & 7, g = warp * 4 + (lane >> 3);
  const int groups = kRowGroups / p.sb;         // row groups of a block
  const int kb = g / groups;                    // its block in a stage
  const int r_lo = (g % groups) * p.rpt;
  const int r_hi = min(p.B, r_lo + p.rpt);
  const int sn = t % kTN, sp = t / kTN;         // slot column, block parity
  int it = 0, x_key = -1;
  for (int tt = blockIdx.x; tt < p.tiles; tt += gridDim.x) {
    const Tile tl(tt, p);
    load_tile_x<MT>(xs, x, p, tl, x_key);
    float acc[MT][16], corr[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      corr[m] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
    }
    for (int nb0 = tl.nb_begin; nb0 < tl.nb_end; nb0 += p.sb, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.full(s), (it / ring.stages) & 1);
      const uint8_t* st = ring.stage(s);
      const int nvalid = min(p.sb, tl.nb_end - nb0);
      if (kb < nvalid) {
        const uint4 sv = *reinterpret_cast<const uint4*>(
            st + se_off + kb * kTN + cc * 16);
        const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
        float sc[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          sc[j] = exp2_i32(static_cast<int>(static_cast<int8_t>(
                               (sw[j / 4] >> (8 * (j % 4))) & 0xFF))
                           - p.fold);
        const float* xb = xs + (nb0 - tl.nb_begin + kb) * p.B * MT;
#pragma unroll 2
        for (int r = r_lo; r < r_hi; ++r) {
          const uint4 cv = *reinterpret_cast<const uint4*>(
              st + (kb * p.B + r) * kTN + cc * 16);
          float xv[MT];
          load_x<MT>(xb + r * MT, xv);
          float w[16];
          decode16<FP8>(cv, sc, w);
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][j] = fmaf(xv[m], w[j], acc[m][j]);
        }
      }
      if (p.budget > 0 && tl.n0 + sn < p.N) {
#pragma unroll 1
        for (int b = sp; b < nvalid; b += 2)
          correct_slots<MT, FP8>(st, b, sn, se_off, seo_off, oc_off, pos_off,
                                 xs + (nb0 - tl.nb_begin + b) * p.B * MT, p,
                                 corr);
      }
      __syncwarp();                  // the warp's reads of the stage are done
      if (lane == 0) mxq::sm90::mbar_arrive(ring.empty(s));
    }
    // the four row lanes of a column chunk, then one row of red a warp and
    // one a block parity of the slots
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[m][j] += __shfl_xor_sync(0xFFFFFFFFu, acc[m][j], 8);
        acc[m][j] += __shfl_xor_sync(0xFFFFFFFFu, acc[m][j], 16);
      }
    consumer_sync();               // the last tile's sums have been read
    if ((lane >> 3) == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 16; j += 4)
          *reinterpret_cast<float4*>(red + (warp * MT + m) * kTN + cc * 16
                                     + j) =
              make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                          acc[m][j + 3]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      red[((8 + sp) * MT + m) * kTN + sn] = corr[m];
    store_tile<MT>(red, ws, p, tl);
  }
}

// Warp 8: the copies of each tile's K-blocks into the ring.
template <bool TMA>
__device__ __forceinline__ void produce(
    const Ring& ring, const CUtensorMap* codes_map,
    const CUtensorMap* se_map, const CUtensorMap* seo_map,
    const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
    const int8_t* __restrict__ seo, const int8_t* __restrict__ oc,
    const int* __restrict__ pos, const Plan& p, int se_off, int seo_off,
    int oc_off, int pos_off) {
  const int lane = threadIdx.x & 31;
  const int rows = p.sb * p.B;
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl(t, p);
    const int tnv = min(kTN, p.N - tl.n0);
    for (int nb0 = tl.nb_begin; nb0 < tl.nb_end; nb0 += p.sb, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.empty(s), ((it / ring.stages) & 1) ^ 1);
      uint8_t* st = ring.stage(s);
      const int nvalid = min(p.sb, tl.nb_end - nb0);
      if constexpr (TMA) {
        if (lane == 0) {
          mxq::sm90::mbar_expect_tx(
              ring.full(s),
              kTN * (rows + 2 * p.sb) + 5 * nvalid * tnv * p.budget);
          mxq::sm90::tma_load_2d(st, codes_map, tl.n0, nb0 * p.B,
                                 ring.full(s));
          mxq::sm90::tma_load_2d(st + se_off, se_map, tl.n0, nb0,
                                 ring.full(s));
          mxq::sm90::tma_load_2d(st + seo_off, seo_map, tl.n0, nb0,
                                 ring.full(s));
        }
        __syncwarp();
        if (p.budget > 0 && lane < nvalid) {
          const size_t e =
              (static_cast<size_t>(nb0 + lane) * p.N + tl.n0) * p.budget;
          bulk_load(st + oc_off + lane * kTN * p.budget, oc + e,
                    tnv * p.budget, ring.full(s));
          bulk_load(st + pos_off + lane * kTN * p.budget * 4, pos + e,
                    tnv * p.budget * 4, ring.full(s));
        }
      } else {
        // plain copies, zeros outside the weight; index math kept narrow so
        // that this warp fits the copying warpgroup's registers
        const int live_rows = min(rows, (p.NB - nb0) * p.B);
        const int8_t* src = codes + static_cast<size_t>(nb0) * p.B * p.N
                            + tl.n0;
#pragma unroll 1
        for (int i = lane; i < rows * kTN; i += 32) {
          const int r = i / kTN, c = i % kTN;
          st[i] = (r < live_rows && c < tnv)
                      ? src[static_cast<size_t>(r) * p.N + c] : 0;
        }
        const size_t e0 = static_cast<size_t>(nb0) * p.N + tl.n0;
        const int live_blocks = min(p.sb, p.NB - nb0);
#pragma unroll 1
        for (int i = lane; i < p.sb * kTN; i += 32) {
          const int b = i / kTN, c = i % kTN;
          const bool live = b < live_blocks && c < tnv;
          const size_t e = e0 + static_cast<size_t>(b) * p.N + c;
          st[se_off + i] = live ? se[e] : 0;
          st[seo_off + i] = live ? seo[e] : 0;
        }
        int* ps = reinterpret_cast<int*>(st + pos_off);
        const int span = kTN * p.budget;
#pragma unroll 1
        for (int i = lane; i < nvalid * span; i += 32) {
          const int b = i / span, c = (i % span) / p.budget;
          const size_t e = (e0 + static_cast<size_t>(b) * p.N) * p.budget
                           + (i % span);
          const bool live = c < tnv;
          st[oc_off + i] = live ? oc[e] : 0;
          ps[i] = live ? pos[e] : -1;
        }
        mxq::sm90::mbar_arrive(ring.full(s));
      }
    }
  }
}

template <int MT, bool FP8, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
sideband_gemv(const __grid_constant__ CUtensorMap codes_map,
              const __grid_constant__ CUtensorMap se_map,
              const __grid_constant__ CUtensorMap seo_map,
              const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ codes,
              const int8_t* __restrict__ se, const int8_t* __restrict__ seo,
              const int8_t* __restrict__ oc, const int* __restrict__ pos,
              float* __restrict__ ws, const Plan p) {
  extern __shared__ uint8_t gemv_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gemv_smem) + kAlign - 1)
      & ~uintptr_t(kAlign - 1));
  float* xs = reinterpret_cast<float*>(base + kBarBytes);
  float* red = reinterpret_cast<float*>(base + kBarBytes + p.x_pad);
  const Ring ring{base + kBarBytes + p.x_pad + red_bytes(MT),
                  mxq::sm90::smem_u32(base), p.stages, p.stage_bytes};
  const int rows = p.sb * p.B;                 // K rows of a stage
  const int se_off = rows * kTN, seo_off = se_off + p.sb * kTN;
  const int oc_off = seo_off + p.sb * kTN;
  const int pos_off = oc_off + p.sb * kTN * p.budget;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mxq::sm90::mbar_init(ring.full(s), TMA ? 1 : 32);
      mxq::sm90::mbar_init(ring.empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kCopyRegs));
    if (threadIdx.x / 32 == kConsumers / 32)
      produce<TMA>(ring, &codes_map, &se_map, &seo_map, codes, se, seo, oc,
                   pos, p, se_off, seo_off, oc_off, pos_off);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 ::"n"(kConsumeRegs));
    consume<MT, FP8>(ring, xs, red, ws, x, p, se_off, seo_off, oc_off,
                     pos_off);
  }
}

template <int MT, bool FP8, bool TMA>
int launch(const void* x, const int8_t* codes, const int8_t* se,
           const int8_t* seo, const int8_t* oc, const int* pos, float* ws,
           const Plan& p, int ctas, int smem, cudaStream_t st) {
  auto kernel = sideband_gemv<MT, FP8, TMA>;
  CUtensorMap maps[3] = {};
  if (TMA) {
    using mxq::sm90::raw_tensor_map;
    int err = raw_tensor_map(&maps[0], codes, 1, p.N,
                             static_cast<long long>(p.NB) * p.B, kTN,
                             p.sb * p.B);
    if (err == 0) err = raw_tensor_map(&maps[1], se, 1, p.N, p.NB, kTN, p.sb);
    if (err == 0)
      err = raw_tensor_map(&maps[2], seo, 1, p.N, p.NB, kTN, p.sb);
    if (err != 0) return err;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(x), codes,
      se, seo, oc, pos, ws, p);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool FP8>
int occupancy(int smem, int* blocks) {
  auto kernel = sideband_gemv<MT, FP8, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kThreads, smem);
  return static_cast<int>(e);
}

}  // namespace gemv

}  // namespace

// x: (M, K) bf16; codes: (NB*B, N) int8 or float8_e4m3fn bits; se, seo:
// (NB, N) int8; oc: (NB, N, budget) int8 or float8_e4m3fn bits; pos: (NB,
// N, budget) int32; ws: (ksplit, M, N) f32 scratch; out: (M, N) bf16 or f32.
// budget <= 8. The plan (ksplit, nbps K-blocks a split, sb K-blocks a
// stage, rpt rows a row group, stages, ctas, smem) is
// outlier_matmul.py::outlier_gemv_plan's; smem must be the bytes that it
// implies here. Returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for a plan or operands the kernel refuses).
extern "C" int dequant_gemv_outlier(
    const void* x, const void* codes, const void* se, const void* seo,
    const void* oc, const void* pos, void* ws, void* out, int M, int K, int N,
    int NB, int B, int budget, int fold, int codes_fp8, int oc_fp8,
    int ksplit, int nbps, int sb, int rpt, int stages, int ctas, int smem,
    int out_bf16, void* stream) {
  const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  if (budget < 0 || budget > kMaxBudget || M < 1 || sb < 1 || sb > 32
      || (sb & (sb - 1)) != 0 || stages < 2 || stages > 8 || ctas < 1
      || rpt * (gemv::kRowGroups / sb) < B || ksplit * nbps < NB
      || nbps % sb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  gemv::Plan p{};
  p.M = M; p.K = K; p.N = N; p.NB = NB; p.B = B; p.budget = budget;
  p.fold = fold; p.oc_fp8 = oc_fp8; p.ksplit = ksplit; p.nbps = nbps;
  p.sb = sb; p.rpt = rpt; p.stages = stages;
  p.mgroups = (M + mt - 1) / mt;
  p.col_tiles = (N + gemv::kTN - 1) / gemv::kTN;
  p.tiles = p.mgroups * p.col_tiles * ksplit;
  p.tma = N % 16 == 0 && sb * B <= 256 && aligned(codes) && aligned(se)
          && aligned(seo) && (budget == 0 || (aligned(oc) && aligned(pos)));
  p.x_pad = (mt * nbps * B * 4 + 127) / 128 * 128;
  p.stage_bytes = gemv::kTN * (sb * B + 2 * sb + 5 * sb * budget);
  if (smem != gemv::smem_bytes(p, mt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  const auto* op = static_cast<const int8_t*>(seo);
  const auto* ocp = static_cast<const int8_t*>(oc);
  const auto* pp = static_cast<const int*>(pos);
  auto* wp = static_cast<float*>(ws);
  int err;
#define MXQ_GEMV_TMA(MT, FP8)                                              \
  err = p.tma ? gemv::launch<MT, FP8, true>(x, cp, sp, op, ocp, pp, wp, p, \
                                            ctas, smem, st)                \
              : gemv::launch<MT, FP8, false>(x, cp, sp, op, ocp, pp, wp, p, \
                                             ctas, smem, st)
#define MXQ_GEMV(MT)                                                       \
  if (codes_fp8) {                                                         \
    MXQ_GEMV_TMA(MT, true);                                                \
  } else {                                                                 \
    MXQ_GEMV_TMA(MT, false);                                               \
  }
  switch (mt) {
    case 8: MXQ_GEMV(8); break;
    case 4: MXQ_GEMV(4); break;
    case 2: MXQ_GEMV(2); break;
    default: MXQ_GEMV(1); break;
  }
#undef MXQ_GEMV
#undef MXQ_GEMV_TMA
  if (err != 0) return err;
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st);
}

// Blocks of the side-band GEMV that one SM holds at once for M rows, codes
// in float8 (codes_fp8) or int8, and smem bytes of dynamic shared memory,
// into *blocks. Returns the cudaError_t of the query.
extern "C" int outlier_gemv_occupancy(int M, int codes_fp8, int smem,
                                      void* blocks) {
  const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  int* b = static_cast<int*>(blocks);
  int err;
#define MXQ_OCC(MT)                                                        \
  err = codes_fp8 ? gemv::occupancy<MT, true>(smem, b)                     \
                  : gemv::occupancy<MT, false>(smem, b)
  switch (mt) {
    case 8: MXQ_OCC(8); break;
    case 4: MXQ_OCC(4); break;
    case 2: MXQ_OCC(2); break;
    default: MXQ_OCC(1); break;
  }
#undef MXQ_OCC
  return err;
}

// x: (M, K) bf16; codes, se, seo, oc, pos as above with Kp = NB * B >= K;
// out: (M, N) bf16 or f32; budget <= 8; sm90: the route that
// dequant_matmul.py::gemm_route chose, 1 for outlier_gemm_sm90 (B = 8, 16,
// 32 or 64, not 8 slots at B = 8; x with K % 8 == 0, 16-byte aligned), 0
// for outlier_gemm (any B; gemm_any.cu takes the blocks that the first
// does not). Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for operands the kernel refuses).
extern "C" int dequant_gemm_outlier(
    const void* x, const void* codes, const void* se, const void* seo,
    const void* oc, const void* pos, void* out, int M, int K, int N, int Kp,
    int B, int budget, int fold, int codes_fp8, int oc_fp8, int out_bf16,
    int sm90, void* stream) {
  if (budget < 0 || budget > kMaxBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  const auto* op = static_cast<const int8_t*>(seo);
  const auto* ocp = static_cast<const int8_t*>(oc);
  const auto* pp = static_cast<const int*>(pos);
  if (!sm90) {
    outlier_gemm<<<mxq::gemm_grid(M, N), mxq::kGemmThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cp, sp, op, ocp, pp, out, M, K,
        N, Kp, B, budget, fold, codes_fp8, oc_fp8, out_bf16);
    return static_cast<int>(cudaGetLastError());
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int tma = N % 16 == 0 && aligned(codes) && aligned(se)
                  && aligned(seo) && (budget == 0
                                      || (aligned(oc) && aligned(pos)));
  const int maxb = budget <= 1 ? 1 : budget <= 2 ? 2 : budget <= 4 ? 4 : 8;
#define MXQ_SIDEBAND(MB, BS)                                               \
  if (maxb == MB && B == BS)                                               \
  return launch_sideband<MB, BS>(x, cp, sp, op, ocp, pp, out, M, K, N,     \
                                 Kp / B, budget, fold, codes_fp8, oc_fp8,  \
                                 out_bf16, tma, st)
  MXQ_SIDEBAND(1, 8); MXQ_SIDEBAND(2, 8); MXQ_SIDEBAND(4, 8);
  MXQ_SIDEBAND(1, 16); MXQ_SIDEBAND(2, 16); MXQ_SIDEBAND(4, 16);
  MXQ_SIDEBAND(8, 16); MXQ_SIDEBAND(1, 32); MXQ_SIDEBAND(2, 32);
  MXQ_SIDEBAND(4, 32); MXQ_SIDEBAND(8, 32); MXQ_SIDEBAND(1, 64);
  MXQ_SIDEBAND(2, 64); MXQ_SIDEBAND(4, 64); MXQ_SIDEBAND(8, 64);
#undef MXQ_SIDEBAND
  return static_cast<int>(cudaErrorInvalidValue);
}
