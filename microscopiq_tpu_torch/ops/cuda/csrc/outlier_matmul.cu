// Two-level outlier side-band matmuls: y = x @ dequant(W) for a
// PackedMXOutlier (K, N) weight blocked along K. Two kernels:
// - dequant_gemv_outlier, for M < 256 tokens: every linear of a decode step
//   of the side-band format, the last_only lm_head and engine prefills;
// - dequant_gemm_outlier, for M >= 256: every linear of a long prefill
//   (outlier_gemm_sm90, or outlier_gemm at the blocks it does not take).
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
// GEMM design: gemm_sm90.cuh's wgmma + TMA mainloop (256 x 128 output
// tile, 64-deep K steps, a decode warpgroup feeding two wgmma
// warpgroups), with the side-band decode: the raw copy of a step holds the
// step's 64 inlier code rows, the exponents, the outlier codes and the
// positions of its K-blocks. Each decode thread owns one column and forms
// the B weights of each K-block in registers with weight()'s arithmetic,
// code · 2^(se - fold), then the slots added in slot order, one bf16
// rounding, and writes them to the K-major B tile, so no f32 tile and no
// extra barrier lie between the decode and the MMA. The kernel is
// templated on the budget (1, 2, 4 or 8 slots read; a smaller budget
// reads its own slots and adds nothing for the rest, as weight() does)
// and on the block (8, 16, 32 or 64, which divide the K step). At B = 64
// a step holds one K-block, so the second of two decode warpgroups idles:
// splitting a column between two threads would make each scan every slot
// for the rows of its half, and no configuration that the port serves uses
// the side-band format at block 64. Blocks that do not divide the K step
// (48, 96, 128, ...), and B = 8 with 8 slots, whose raw copy (51 KB a
// step) leaves no room for a ring, take outlier_gemm: common.cuh's bf16
// wmma tile loop (128 x 128 output tile, 32-deep K steps) with the weight
// tile built in f32 in shared memory, the slots added by one thread per
// (K-block, column), then rounded to the bf16 B tile.
// outlier_matmul.py::dequant_gemm_outlier chooses the kernel by block and
// slot count before the launch (dequant_matmul.py::gemm_route).
// The weights are the GEMV's bf16 weights; the tensor cores' f32
// accumulation differs from a CUDA-core sum in order and internal rounding
// (the emi8 GEMM's 2e-3 tolerance).
#include "common.cuh"
#include "gemm_sm90.cuh"

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
// weight(): the inlier, then every slot naming the row in slot order, one
// rounding. Adding weight()'s +0 for the other slots changes no nonzero
// value and turns -0 into +0, which the final + 0.f does here.
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
      // the inliers, 8 rows a chunk (an fp8 -0 code gives +0, as weight())
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
// out: (M, N) bf16 or f32; budget <= 8; sm90: the route that
// dequant_matmul.py::gemm_route chose, 1 for outlier_gemm_sm90 (B = 8, 16,
// 32 or 64, not 8 slots at B = 8; x with K % 8 == 0, 16-byte aligned), 0
// for outlier_gemm (any B). Returns the cudaError_t of the launch (0 on
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
