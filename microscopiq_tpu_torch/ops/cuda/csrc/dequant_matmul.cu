// Tiled GEMM with the MX decode inside the kernel: y = x @ dequant(W) for
// M > 64 tokens.
//
// Replaces the serving-layout branches of
// microscopiq_tpu/ops/pallas/dequant_matmul.py::_dq_matmul_kernel (emi8,
// emi8m and the int8 container, launched from dequant_matmul) and its legacy
// `native2d` branch: 2-D (K, N) int8 and float8 (e4m3, e5m2) codes reach the
// (NB, B, N) serving layout by a view (packing.to_serving_layout, no copy),
// so this same kernel serves them; serving-layout float8 codes, which the
// JAX package sends to XLA, come here too. Float8 codes decode exactly to
// f16 in hardware (common.cuh's decode_fp8). The sb4, sb2, pf4, pf6, bf16
// and fp16 transports, which the
// JAX package sends to XLA's dequantize-then-dot at this size, come here too
// with their own B-tile decode. It carries every linear of a prefill of more
// than 64 tokens (the bench shape is M = 8 x 128 = 1024).
//
// What bounds it on the H100: operations. At M = 1024 each weight byte feeds
// at least 1024 flops, far above the ~295 flop/byte balance point, so the
// bound is 2*M*N*K / 989 TFLOP/s (bf16 tensor cores, dense).
//
// Design (simple and right first; wgmma/TMA and a cp.async pipeline are later
// work):
// - the bf16 wmma tile loop of common.cuh (128 x 128 output tile per block
//   of 8 warps, 32-deep K steps);
// - per K step the block stages x (bf16, straight copy) and decodes the
//   weights into shared memory: K row k of the tile is block k / B, row
//   j = k % B of it, which sits in field j / (B/F) of packed row j % (B/F)
//   (common.cuh's decode_row; the codes are not a flat (K, N) matrix when a
//   packed row holds several K rows). Each decoded code is multiplied by
//   2^(se - fold) and stored as bf16. Integer codes have at most 7
//   significant bits (pf6: 3, float8: 4) and bf16/fp16 containers are
//   rounded to bf16 first, so the product is exact in bf16 and matches the
//   plain twin's
//   dequantized bf16 weight bit for bit.
// - ragged M, N and K are masked: x columns k >= K and rows m >= M load as
//   zeros, code columns n >= N decode to zero, and the epilogue stores only
//   in-range elements. 16-byte vector loads are used when N % 16 == 0 and
//   K % 8 == 0, element loads otherwise.
//
// The pf6, pf4, sb4 and sb2 transports, the fp16 and bf16 containers,
// emi8 / emi8m, the int8 container and the float8 containers run on
// gemm_sm90.cuh's wgmma + TMA mainloop instead (gemm_dq_sm90), at every MX
// block that divides its 64-deep K step and whose ring fits (pf6: 16, 32,
// 64; pf4: 16, 32, 64; sb4: 2 to 64; sb2: 4 to 64; fp16 and bf16: 8, 16,
// 32, 64; emi8, int8 and float8: 4, 8, 16, 32, 64); other blocks (48, 96,
// 128, ...) run on gemm_any.cu's kernels, which take the block at run
// time, and gemm_dq's tile loop is left to the tests that force it (and
// the oracle of the b_tile hook). dequant_matmul.py::gemm_route chooses by
// block size before the launch and passes the choice here. Each decoder reads the TMA-loaded raw copy of
// a step's packed rows and exponents in shared memory and writes the bf16
// B tile, every value being the twin's bf16 weight bit for bit:
// - pf6: a column of one MX block a thread (half a block at B = 64): one
//   read of the two low-plane rows and the high-plane row of packed-row
//   group g gives K rows g, g + B/4, g + B/2 and g + 3B/4 (common.cuh's
//   decode_group order), each times 2^(se - fold): at most 3 significant
//   bits times a power of two, exact in bf16;
// - pf4: 16 of the step's 32 packed rows of a column a thread: one read of
//   packed row g gives K rows g (low nibble) and g + B/2 (high nibble);
//   at most 2 significant bits times a power of two, exact in bf16;
// - fp16: 32 of the step's 64 K rows of a column a thread, each code
//   rounded to bf16 and then scaled, decode_half<kFp16>'s order;
// - bf16: the same share, each code's value times 2^(se - fold) in f32 and
//   rounded once to bf16, as gemm_dq computes it;
// - emi8, int8 and float8: the same share, each byte's value (emi8's m̂
//   and 2^e' formed as f32 bits, int8's code, float8's pair convert) times
//   2^(se - fold) as gemm_dq multiplies it;
// - sb4 and sb2: pf4's share of packed rows (8 of sb2's 16 a thread), each
//   field's integer code times 2^(se - fold) as gemm_dq multiplies it.
// The wgmma k16 steps sum in gemm_dq's order.
#include <type_traits>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

// gemm_dq's B-tile decode of K step k0 (32 rows) and the 128 columns from
// n_blk on: thread t decodes row t / 8, 16 columns.
template <int D>
struct TileDec {
  const int8_t* __restrict__ codes;
  const int8_t* __restrict__ se;
  int N, Kp, B, mw, ebits, fold, n_blk;

  __device__ __forceinline__ void operator()(BTile Bs, int k0) const {
    constexpr int F = mxq::fields<D>();
    const bool nvec = (N % 16) == 0;
    const int per = B / F;
    const int b_r = threadIdx.x >> 3, b_c = (threadIdx.x & 7) * 16;
    const int gk = k0 + b_r;
    const int gn = n_blk + b_c;
    float w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = 0.f;
    if (gk < Kp && gn < N) {
      const int nb = gk / B, j = gk - nb * B;
      const int f = j / per;
      // the exponents' load is issued before the codes' so that both are in
      // flight together
      const int8_t* srow = se + static_cast<size_t>(nb) * N;
      int4 sv = make_int4(0, 0, 0, 0);
      if (nvec) sv = __ldg(reinterpret_cast<const int4*>(srow + gn));
      mxq::decode_row<D, 16>(codes, nb, j - f * per, f, B, gn, N, nvec, mw,
                             ebits, w);
      if (nvec) {
        const int8_t* sb = reinterpret_cast<const int8_t*>(&sv);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] *= exp2_i32(static_cast<int>(sb[i]) - fold);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (gn + i < N) w[i] *= exp2_i32(static_cast<int>(srow[gn + i]) - fold);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[b_r][b_c + j] = __float2bfloat16(w[j]);
  }
};

template <int D>
__global__ void __launch_bounds__(mxq::kGemmThreads)
gemm_dq(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
        const int8_t* __restrict__ se, void* out, int M, int K, int N, int Kp,
        int B, int mw, int ebits, int fold, int out_bf16) {
  const TileDec<D> decode{codes, se, N, Kp, B, mw, ebits, fold,
                          static_cast<int>(blockIdx.x) * mxq::kGemmBN};
  mxq::gemm_tile(x, out, M, K, N, Kp, out_bf16, decode);
}


// ---------------------------------------------------------------------------
// pf6, pf4, fp16, bf16, emi8, sb4, sb2, int8 and float8 on the sm90
// mainloop
// ---------------------------------------------------------------------------
// The raw operands of a 64-row step that the decoders here read: the ROWS
// packed rows of each of its 64/B blocks (CB-byte codes), then one exponent
// row a block, 128 columns a row; TMA copies where N % 16 == 0, else plain
// loads by every decode thread.
template <int CB, int ROWS, int B>
struct Sm90Raw {
  static constexpr int kN = mxq::sm90::kBN;
  static constexpr int kRows = ROWS;                    // of a block
  static constexpr int kBlocks = mxq::sm90::kBK / B;
  static constexpr int kCodeRows = kBlocks * kRows;     // of a step
  static constexpr int kCodeBytes = CB;
  static constexpr int kSeOff = kCodeRows * kN * CB;
  static constexpr int kRawBytes = kSeOff + kBlocks * kN;

  const int8_t* __restrict__ codes;     // (NB, ROWS, N) codes of CB bytes
  const int8_t* __restrict__ se;        // (NB, N)
  const CUtensorMap* codes_map;         // codes as (NB * ROWS, N) rows
  const CUtensorMap* se_map;
  int N, NB, mw, ebits, fold;
  bool tma;                             // N % 16 == 0: TMA copies

  __device__ __forceinline__ int tx_bytes() const { return kRawBytes; }

  __device__ __forceinline__ void copy_tma(int8_t* raw, int k0, int n0,
                                           uint32_t bar) const {
    const int nb0 = k0 / B;
    mxq::sm90::tma_load_2d(raw, codes_map, n0, nb0 * kRows, bar);
    mxq::sm90::tma_load_2d(raw + kSeOff, se_map, n0, nb0, bar);
  }

  template <int DWG>
  __device__ __forceinline__ void copy(int8_t* raw, int k0, int n0,
                                       int t) const {
    constexpr int kRowBytes = kN * CB;
    const int nb0 = k0 / B;
    for (int c = t; c < kRawBytes; c += 128 * DWG) {
      int8_t v = 0;
      if (c < kSeOff) {
        const int i = c / kRowBytes, j = c % kRowBytes;
        const int nb = nb0 + i / kRows;
        if (nb < NB && n0 + j / CB < N)
          v = codes[((static_cast<size_t>(nb) * kRows + i % kRows) * N + n0)
                        * CB + j];
      } else {
        const int nb = nb0 + (c - kSeOff) / kN, n = n0 + (c - kSeOff) % kN;
        if (nb < NB && n < N) v = se[static_cast<size_t>(nb) * N + n];
      }
      raw[c] = v;
    }
  }

  // se - fold of column col of the step's block blk, clamped as exp2_i32
  __device__ __forceinline__ int scale_exp(const int8_t* raw, int blk,
                                           int col) const {
    return max(-126, min(127, static_cast<int>(raw[kSeOff + blk * kN + col])
                                  - fold));
  }
};

// pf6: a decode thread owns one column of a block (two threads, one half
// each, at B = 64, where a step holds one block). One read of the two
// low-plane rows and the high-plane row of packed-row group g gives K rows
// g, g + B/4, g + B/2 and g + 3B/4.
template <int B>
struct Pf6Sm90 : Sm90Raw<1, 3 * B / 4, B> {
  static_assert(B == 16 || B == 32 || B == 64, "block of 16, 32 or 64");
  using Raw = Sm90Raw<1, 3 * B / 4, B>;
  static constexpr int kStages = 4, kRawBufs = 3, kDwg = 2;   // 213 KB
  static constexpr int kParts = B == 64 ? 2 : 1;   // threads a block column

  // The B / kParts weights of part h of one column of a block, in bf16
  // pairs: u[i] holds the part's rows 2i, 2i + 1, its rows being the
  // packed-row groups h * n.. h * n + n - 1 of each quarter of the block in
  // turn; wt(lo, flo, hi, fhi) decodes one field.
  template <class Wt>
  __device__ __forceinline__ void decode_part(const int8_t* cb, int h,
                                              uint32_t (&u)[B / 2 / kParts],
                                              Wt wt) const {
    constexpr int kN = Raw::kN, q = B / 4, n = q / kParts;
#pragma unroll
    for (int gl = 0; gl < n; gl += 2) {
      const int g = h * n + gl;
      const int lo0 = cb[g * kN], lo1 = cb[(g + q) * kN];
      const int hi = cb[(2 * q + g) * kN];
      const int lo0b = cb[(g + 1) * kN], lo1b = cb[(g + 1 + q) * kN];
      const int hib = cb[(2 * q + g + 1) * kN];
      u[gl / 2] = mxq::sm90::pack_bf16(wt(lo0, 0, hi, 0), wt(lo0b, 0, hib, 0));
      u[(gl + n) / 2] =
          mxq::sm90::pack_bf16(wt(lo1, 0, hi, 1), wt(lo1b, 0, hib, 1));
      u[(gl + 2 * n) / 2] =
          mxq::sm90::pack_bf16(wt(lo0, 1, hi, 2), wt(lo0b, 1, hib, 2));
      u[(gl + 3 * n) / 2] =
          mxq::sm90::pack_bf16(wt(lo1, 1, hi, 3), wt(lo1b, 1, hib, 3));
    }
  }

  __device__ __forceinline__ void decode_block(const int8_t* raw, uint8_t* b,
                                               int col, int blk,
                                               int h) const {
    const int8_t* cb = raw + blk * Raw::kRows * Raw::kN + col;
    const int s = this->scale_exp(raw, blk, col);
    const int mw = this->mw, ebits = this->ebits;
    uint32_t u[B / 2 / kParts];
    if (mw + ebits == 5 && s + 62 + mw <= 127) {
      // The code's 5 e/m bits placed as an f32 with exponent field e and
      // mantissa m (a subnormal for e = 0) are its decode_pf magnitude
      // times 2^-(126 + mw) for every e, so two exact products, by 2^64
      // and by 2^(62 + mw + s), give decode_pf(c) · 2^s with one rounding,
      // as decode_pf's float(mag) · exp2_i32(s); a negative zero code
      // gives +0, as decode_pf.
      const float scale = __int_as_float((s + 62 + mw + 127) << 23);
      const int sh = 23 - mw;
      decode_part(cb, h, u, [&](int lo, int flo, int hi, int fhi) {
        const int e = hi >> (2 * fhi);
        const uint32_t c5 = ((lo >> (4 * flo)) & 0xF) | ((e & 1) << 4);
        const uint32_t bits = (static_cast<uint32_t>(e & 2) << 30)
                              | (c5 << sh);
        return __uint_as_float(c5 ? bits : 0u) * 0x1p64f * scale;
      });
    } else {                            // scales near the f32 limits
      const float sc = mxq::exp2_i32(s);
      decode_part(cb, h, u, [&](int lo, int flo, int hi, int fhi) {
        return mxq::decode_pf6(lo, flo, hi, fhi, mw, ebits) * sc;
      });
    }
    if constexpr (kParts == 1) {
      mxq::sm90::store_b_words<B>(b, col, blk * B / 8, u);
    } else {                            // rows 8h.. 8h + 7 of each quarter
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mxq::sm90::store_b_chunk(
            b, col, (blk * B + r * (B / 4)) / 8 + h,
            make_uint4(u[4 * r], u[4 * r + 1], u[4 * r + 2], u[4 * r + 3]));
    }
  }

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    constexpr int kJobs = Raw::kBlocks * kParts;   // (block, part) pairs
    const int col = t % Raw::kN;
#pragma unroll
    for (int i = 0; i < (kJobs + DWG - 1) / DWG; ++i) {
      const int job = t / Raw::kN + i * DWG;
      if (job >= kJobs) break;
      decode_block(raw, b, col, job / kParts, job % kParts);
    }
  }
};

// pf4: a step holds 32 packed rows at every B (B/2 a block); a decode
// thread owns 32 / DWG of them in one column, 8 at a time: one read of
// packed row g of a block gives K rows g (low nibble) and g + B/2 (high
// nibble), each times 2^(se - fold).
template <int B>
struct Pf4Sm90 : Sm90Raw<1, B / 2, B> {
  static_assert(B == 16 || B == 32 || B == 64, "block of 16, 32 or 64");
  using Raw = Sm90Raw<1, B / 2, B>;
  static constexpr int kStages = 4, kRawBufs = 3, kDwg = 2;   // 211 KB

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    constexpr int kN = Raw::kN, kHalf = B / 2;
    constexpr int P = Raw::kCodeRows / DWG;     // packed rows a thread
    static_assert(P % 8 == 0 && kHalf % 8 == 0, "whole 16-byte chunks");
    const int col = t % kN, p0 = (t / kN) * P;
    const int mw = this->mw, ebits = this->ebits;
#pragma unroll
    for (int i = 0; i < P; i += 8) {
      const int p = p0 + i, blk = p / kHalf, g = p % kHalf;
      const int s = this->scale_exp(raw, blk, col);
      int c[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = raw[(p + j) * kN + col];
      uint32_t lo[4], hi[4];
      if (mw + ebits == 3 && s + 62 + mw <= 127) {
        // pf6's exact f32 placement (Pf6Sm90) of the 3 e/m bits of a
        // nibble, its sign bit as the f32 sign
        const float scale = __int_as_float((s + 62 + mw + 127) << 23);
        const int sh = 23 - mw;
        auto wt = [&](int nib) {
          const uint32_t c3 = nib & 7;
          const uint32_t bits = (static_cast<uint32_t>(nib & 8) << 28)
                                | (c3 << sh);
          return __uint_as_float(c3 ? bits : 0u) * 0x1p64f * scale;
        };
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = mxq::sm90::pack_bf16(wt(c[2 * j]), wt(c[2 * j + 1]));
          hi[j] = mxq::sm90::pack_bf16(wt(c[2 * j] >> 4),
                                       wt(c[2 * j + 1] >> 4));
        }
      } else {                          // scales near the f32 limits
        const float sc = mxq::exp2_i32(s);
        auto wt = [&](int code, int f) {
          return mxq::decode_field<mxq::kPf4>(code, f, mw, ebits) * sc;
        };
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = mxq::sm90::pack_bf16(wt(c[2 * j], 0), wt(c[2 * j + 1], 0));
          hi[j] = mxq::sm90::pack_bf16(wt(c[2 * j], 1), wt(c[2 * j + 1], 1));
        }
      }
      const int k = blk * B + g;
      mxq::sm90::store_b_chunk(b, col, k / 8,
                               make_uint4(lo[0], lo[1], lo[2], lo[3]));
      mxq::sm90::store_b_chunk(b, col, (k + kHalf) / 8,
                               make_uint4(hi[0], hi[1], hi[2], hi[3]));
    }
  }
};

// The fp16 container: a decode thread owns 64 / DWG of a step's K rows in
// one column, 8 at a time, each code rounded to bf16 and then times
// 2^(se - fold), as decode_half<kFp16>. The 16 KB raw copy of a step takes
// a ring of 3 stages and 3 raw buffers (196-201 KB; 4 stages and 3 would
// need 247 KB).
template <int B>
struct Fp16Sm90 : Sm90Raw<2, B, B> {
  static_assert(B == 8 || B == 16 || B == 32 || B == 64,
                "block of 8, 16, 32 or 64");
  using Raw = Sm90Raw<2, B, B>;
  static constexpr int kStages = 3, kRawBufs = 3, kDwg = 2;

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    constexpr int kN = Raw::kN, C = 8 / DWG;    // chunks of 8 rows a thread
    const uint16_t* w = reinterpret_cast<const uint16_t*>(raw);
    const int col = t % kN, c0 = (t / kN) * C;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = c0 + i;
      const int s = this->scale_exp(raw, 8 * c / B, col);
      const float sc = mxq::exp2_i32(s);
      uint32_t u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t pair = w[(8 * c + 2 * j) * kN + col]
                              | (static_cast<uint32_t>(
                                     w[(8 * c + 2 * j + 1) * kN + col])
                                 << 16);
        if (s >= -102) {
          // Every nonzero fp16 value is at least 2^-24 in size, so its
          // product with 2^s (s >= -102) is exact in f32 and no bf16
          // subnormal: one rounding of the product gives the rounded
          // value times 2^s, bit for bit.
          const float2 f = __half22float2(
              *reinterpret_cast<const __half2*>(&pair));
          u[j] = mxq::sm90::pack_bf16(f.x * sc, f.y * sc);
        } else {
          u[j] = mxq::sm90::pack_bf16(
              mxq::decode_half<mxq::kFp16>(pair & 0xFFFF) * sc,
              mxq::decode_half<mxq::kFp16>(pair >> 16) * sc);
        }
      }
      mxq::sm90::store_b_chunk(b, col, c, make_uint4(u[0], u[1], u[2], u[3]));
    }
  }
};

// The bf16 container: Fp16Sm90's ring and share (a decode thread owns
// 64 / DWG of a step's K rows in one column, 8 at a time) with no convert.
// Each code's value (its 16 bits as the high half of an f32,
// decode_half<kBf16>) is multiplied by the clamped 2^(se - fold) in f32
// and rounded once to bf16, as gemm_dq computes it, so the B tile is
// gemm_tile's bit for bit. No fast path skips that multiply: a bf16 code
// can be as small as 2^-133, so its product with 2^s can fall below 2^-126,
// where the f32 product and its bf16 rounding each round (Fp16Sm90's
// s >= -102 argument rests on every fp16 value being at least 2^-24).
// The multiply and one paired convert are also all the decode costs.
template <int B>
struct Bf16Sm90 : Sm90Raw<2, B, B> {
  static_assert(B == 8 || B == 16 || B == 32 || B == 64,
                "block of 8, 16, 32 or 64");
  using Raw = Sm90Raw<2, B, B>;
  static constexpr int kStages = 3, kRawBufs = 3, kDwg = 2;

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    constexpr int kN = Raw::kN, C = 8 / DWG;    // chunks of 8 rows a thread
    const uint16_t* w = reinterpret_cast<const uint16_t*>(raw);
    const int col = t % kN, c0 = (t / kN) * C;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = c0 + i;
      const float sc = mxq::exp2_i32(this->scale_exp(raw, 8 * c / B, col));
      uint32_t u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = w[(8 * c + 2 * j) * kN + col];
        const uint32_t hi = w[(8 * c + 2 * j + 1) * kN + col];
        u[j] = mxq::sm90::pack_bf16(__uint_as_float(lo << 16) * sc,
                                    __uint_as_float(hi << 16) * sc);
      }
      mxq::sm90::store_b_chunk(b, col, c, make_uint4(u[0], u[1], u[2], u[3]));
    }
  }
};

// The one-byte decodes: emi8 and emi8m, the int8 container and the float8
// containers (fp8_e4m3, fp8_e5m2; fp6 and fp4 codes in float8_e4m3fn). A
// decode thread owns 64 / DWG of a step's K rows in one column, 8 at a time
// (Fp16Sm90's share), each byte's value times 2^(se - fold), clamped as
// exp2_i32, in f32 and rounded once to bf16, as gemm_dq multiplies it, so
// the B tile is gemm_tile's bit for bit:
// - emi8: m̂ · 2^e' (decode_emi8). m̂ becomes an f32 through the 1.5 · 2^23
//   bias (exact for |m̂| < 2^22, two full-rate operations instead of a
//   quarter-rate convert) and 2^e' is placed as exponent bits (e' <=
//   2^(8 - mw) - 1 <= 127), so their product is decode_emi8's integer
//   m̂ · 2^e' converted, exactly (at most 7 significant bits; the packers
//   keep |m̂| · 2^e' < 2^31);
// - int8: emi8 with mw = 8, no exponent field: m̂ is the code (the bias is
//   exact for |code| <= 128) and 2^e' is 1;
// - float8: four pairs of K rows through common.cuh's decode_fp8, Hopper's
//   paired float8 -> f16 convert, exact (every e4m3 and e5m2 value is an
//   f16 value, NaN and inf included).
// At B = 4 a chunk of 8 rows spans two blocks; B = 2's 12 KB raw step
// leaves no 4-stage ring (dequant_matmul.py::_sm90_ring).
template <int D, int B>
struct ByteSm90 : Sm90Raw<1, B, B> {
  static_assert(D == mxq::kEmi8 || D == mxq::kInt8 || mxq::is_fp8<D>(),
                "emi8, int8 or float8 codes");
  static_assert(B == 4 || B == 8 || B == 16 || B == 32 || B == 64,
                "block of 4, 8, 16, 32 or 64");
  using Raw = Sm90Raw<1, B, B>;
  static constexpr int kStages = 4, kRawBufs = 3, kDwg = 2;   // 218-223 KB

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    constexpr int kN = Raw::kN, C = 8 / DWG;    // chunks of 8 rows a thread
    constexpr int R = B < 8 ? B : 8;            // rows under one scale
    const int col = t % kN, c0 = (t / kN) * C;
    [[maybe_unused]] const int sh = 8 - this->mw, emask = (1 << sh) - 1;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = c0 + i;
      float sc[8 / R];
#pragma unroll
      for (int h = 0; h < 8 / R; ++h)
        sc[h] = mxq::exp2_i32(this->scale_exp(raw, (8 * c + h * R) / B, col));
      int code[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) code[j] = raw[(8 * c + j) * kN + col];
      float v[8];
      if constexpr (mxq::is_fp8<D>()) {
        mxq::decode_fp8<D, 8>(code, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (D == mxq::kEmi8) {
            const float m = __int_as_float(0x4B400000 + (code[j] >> sh))
                            - 12582912.f;
            const float p = __int_as_float(((code[j] & emask) + 127) << 23);
            v[j] = m * p;
          } else {
            v[j] = __int_as_float(0x4B400000 + code[j]) - 12582912.f;
          }
        }
      }
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = v[j] * sc[j / R];
      mxq::sm90::store_b_chunk(
          b, col, c,
          make_uint4(mxq::sm90::pack_bf16(w[0], w[1]),
                     mxq::sm90::pack_bf16(w[2], w[3]),
                     mxq::sm90::pack_bf16(w[4], w[5]),
                     mxq::sm90::pack_bf16(w[6], w[7])));
    }
  }
};

template <int B>
using Emi8Sm90 = ByteSm90<mxq::kEmi8, B>;
template <int B>
using Int8Sm90 = ByteSm90<mxq::kInt8, B>;
template <int D, int B>
using Fp8Sm90 = ByteSm90<D, B>;

// sb4 and sb2: F sign-extended integer codes of 8 / F bits a byte (F = 2,
// 4); K row j of a block sits in field j / R of packed row j % R, R = B / F
// (common.cuh's fields). A decode thread owns 64 / F / DWG of the step's
// packed rows in one column, 8 at a time. Each code becomes an f32 through
// the 1.5 · 2^23 bias (exact for |code| <= 8: two full-rate operations
// instead of a quarter-rate convert) and is multiplied once by the clamped
// scale, gemm_dq's float(code) · exp2_i32(se - fold), so the B tile is
// gemm_tile's bit for bit. Where a block holds 8 packed rows or more
// (R >= 8), 8 rows g.. g + 7 give one 16-byte chunk a field, K rows
// g + f R.. under one scale (pf4's traversal); below, they hold 8 / R whole
// blocks, the 8F consecutive K rows F p.. under 8 / R scales.
template <int F, int B>
struct SubbyteSm90 : Sm90Raw<1, B / F, B> {
  static_assert((F == 2 && (B == 2 || B == 4 || B == 8 || B == 16
                            || B == 32 || B == 64))
                    || (F == 4 && (B == 4 || B == 8 || B == 16 || B == 32
                                   || B == 64)),
                "sb4 at blocks 2 to 64, sb2 at 4 to 64");
  using Raw = Sm90Raw<1, B / F, B>;
  static constexpr int kStages = 4, kRawBufs = 3, kDwg = 2;   // 204-222 KB

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    constexpr int kN = Raw::kN, R = B / F, kBits = 8 / F;
    constexpr int P = Raw::kCodeRows / DWG;     // packed rows a thread
    static_assert(P % 8 == 0, "whole groups of 8 packed rows");
    const int col = t % kN, p0 = (t / kN) * P;
#pragma unroll
    for (int i = 0; i < P; i += 8) {
      const int p = p0 + i;
      float v[F][8];                    // field f of packed row p + r
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int c = raw[(p + r) * kN + col];
#pragma unroll
        for (int f = 0; f < F; ++f)
          v[f][r] = __int_as_float(0x4B400000
                                   + mxq::sext(c >> (kBits * f), kBits))
                    - 12582912.f;
      }
      if constexpr (R >= 8) {
        const int blk = p / R, g = p % R;
        const float sc = mxq::exp2_i32(this->scale_exp(raw, blk, col));
#pragma unroll
        for (int f = 0; f < F; ++f) {
          uint32_t u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            u[j] = mxq::sm90::pack_bf16(v[f][2 * j] * sc,
                                        v[f][2 * j + 1] * sc);
          mxq::sm90::store_b_chunk(b, col, (blk * B + g + f * R) / 8,
                                   make_uint4(u[0], u[1], u[2], u[3]));
        }
      } else {
        float sc[8 / R];
#pragma unroll
        for (int q = 0; q < 8 / R; ++q)
          sc[q] = mxq::exp2_i32(this->scale_exp(raw, p / R + q, col));
        // K row k of the group: block k / B, field (k % B) / R of packed
        // row (k / B) R + k % R
        auto w = [&](int k) {
          return v[(k % B) / R][(k / B) * R + k % R] * sc[k / B];
        };
#pragma unroll
        for (int c = 0; c < F; ++c) {
          uint32_t u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            u[j] = mxq::sm90::pack_bf16(w(8 * c + 2 * j),
                                        w(8 * c + 2 * j + 1));
          mxq::sm90::store_b_chunk(b, col, F * p / 8 + c,
                                   make_uint4(u[0], u[1], u[2], u[3]));
        }
      }
    }
  }
};

template <int B>
using Sb4Sm90 = SubbyteSm90<2, B>;
template <int B>
using Sb2Sm90 = SubbyteSm90<4, B>;

// Named for a decode that has no sm90 decoder: using it fails to compile.
template <int D>
struct NoSm90Dec {
  static_assert(D < 0, "no sm90 decoder for this decode");
};

template <int D, int B>
using Sm90Dec = std::conditional_t<
    D == mxq::kPf6, Pf6Sm90<B>,
    std::conditional_t<
        D == mxq::kPf4, Pf4Sm90<B>,
        std::conditional_t<
            D == mxq::kEmi8, Emi8Sm90<B>,
            std::conditional_t<
                D == mxq::kSb4, Sb4Sm90<B>,
                std::conditional_t<
                    D == mxq::kSb2, Sb2Sm90<B>,
                    std::conditional_t<
                        D == mxq::kFp16, Fp16Sm90<B>,
                        std::conditional_t<
                            D == mxq::kBf16, Bf16Sm90<B>,
                            std::conditional_t<
                                D == mxq::kInt8, Int8Sm90<B>,
                                std::conditional_t<mxq::is_fp8<D>(),
                                                   Fp8Sm90<D, B>,
                                                   NoSm90Dec<D>>>>>>>>>>;

// grid: M tiles x N tiles of 256 x 128 (gemm_sm90.cuh); x (M, K) bf16 with
// K % 8 == 0 through xmap.
template <int D, int B>
__global__ void __launch_bounds__(mxq::sm90::threads(Sm90Dec<D, B>::kDwg), 1)
gemm_dq_sm90(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap codes_map,
             const __grid_constant__ CUtensorMap se_map,
             const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
             void* out, int M, int K, int N, int NB, int mw, int ebits,
             int fold, int out_bf16, int tma) {
  static_assert(D == mxq::kPf6 || D == mxq::kPf4 || D == mxq::kFp16
                    || D == mxq::kBf16 || D == mxq::kEmi8 || D == mxq::kSb4
                    || D == mxq::kSb2 || D == mxq::kInt8 || mxq::is_fp8<D>(),
                "the sm90 mainloop decodes pf6, pf4, fp16, bf16, emi8, sb4, "
                "sb2, int8 and float8");
  using Dec = Sm90Dec<D, B>;
  Dec dec{{codes, se, &codes_map, &se_map, N, NB, mw, ebits, fold,
           tma != 0}};
  mxq::sm90::gemm<Dec::kStages, Dec::kRawBufs, Dec::kDwg>(&xmap, out, M, N,
                                                         K, out_bf16, dec);
}

template <int D, int B>
int launch_sm90(const void* x, const int8_t* codes, const int8_t* se,
                void* out, int M, int K, int N, int NB, int mw, int ebits,
                int fold, int out_bf16, cudaStream_t st) {
  using Dec = Sm90Dec<D, B>;
  constexpr int smem =
      mxq::sm90::Ring<Dec::kStages, Dec::kRawBytes, Dec::kRawBufs>::kBytes;
  // TMA copies of the raw operands where their rows are 16-byte multiples
  CUtensorMap codes_map{}, se_map{};
  const int tma = N % 16 == 0;
  if (tma) {
    const long long rows = static_cast<long long>(NB) * Dec::kRows;
    int err = mxq::sm90::raw_tensor_map(&codes_map, codes, Dec::kCodeBytes,
                                        N, rows, Dec::kN, Dec::kCodeRows);
    if (err == 0)
      err = mxq::sm90::raw_tensor_map(&se_map, se, 1, N, NB, Dec::kN,
                                      Dec::kBlocks);
    if (err != 0) return err;
  }
  return mxq::sm90::launch<Dec::kDwg>(gemm_dq_sm90<D, B>, smem, x, M, N, K,
                                      st, codes_map, se_map, codes, se, out,
                                      M, K, N, NB, mw, ebits, fold, out_bf16,
                                      tma);
}

// ---------------------------------------------------------------------------
// Test hook: the B tile that a decode writes
// ---------------------------------------------------------------------------
// bits (Kp, N): the bf16 weight that the decode of a GEMM writes into its B
// tile, as 16-bit patterns, K step by K step, one block a step and 128
// columns; so two decoders can be held to each other where a product with
// x cannot show them (x = I turns an inf or NaN weight into a NaN column).
template <int D>
__global__ void __launch_bounds__(mxq::kGemmThreads)
b_tile_dq(const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
          uint16_t* bits, int N, int Kp, int B, int mw, int ebits,
          int fold) {
  __shared__ __align__(128)
      __nv_bfloat16 Bs[mxq::kGemmBK][mxq::kGemmBN + mxq::kGemmPad];
  const int k0 = blockIdx.y * mxq::kGemmBK, n0 = blockIdx.x * mxq::kGemmBN;
  const TileDec<D> decode{codes, se, N, Kp, B, mw, ebits, fold, n0};
  decode(Bs, k0);
  __syncthreads();
  for (int i = threadIdx.x; i < mxq::kGemmBK * mxq::kGemmBN;
       i += mxq::kGemmThreads) {
    const int k = i / mxq::kGemmBN, n = i % mxq::kGemmBN;
    if (k0 + k < Kp && n0 + n < N)
      bits[static_cast<size_t>(k0 + k) * N + n0 + n] =
          __bfloat16_as_ushort(Bs[k][n]);
  }
}

template <int D, int B>
__global__ void __launch_bounds__(128 * Sm90Dec<D, B>::kDwg)
b_tile_sm90(const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
            uint16_t* bits, int N, int NB, int mw, int ebits, int fold) {
  using Dec = Sm90Dec<D, B>;
  constexpr int kBK = mxq::sm90::kBK, kBN = mxq::sm90::kBN;
  __shared__ __align__(128) int8_t raw[mxq::sm90::raw_pad(Dec::kRawBytes)];
  __shared__ __align__(128) uint8_t b[mxq::sm90::kBBytes];
  const Dec dec{{codes, se, nullptr, nullptr, N, NB, mw, ebits, fold,
                 false}};
  const int k0 = blockIdx.y * kBK, n0 = blockIdx.x * kBN, t = threadIdx.x;
  dec.template copy<Dec::kDwg>(raw, k0, n0, t);
  __syncthreads();
  dec.template decode<Dec::kDwg>(raw, b, t);
  __syncthreads();
  for (int i = t; i < kBK * kBN; i += 128 * Dec::kDwg) {
    const int k = i / kBN, n = i % kBN;
    if (k0 + k < NB * B && n0 + n < N)
      bits[static_cast<size_t>(k0 + k) * N + n0 + n] =
          *reinterpret_cast<const uint16_t*>(
              b + n * 128 + (((k >> 3) ^ (n & 7)) << 4) + (k & 7) * 2);
  }
}

}  // namespace

// Every (decode, block) that gemm_dq_sm90 is compiled for, as
// MXQ_SM90(D, B);
#define MXQ_SM90_KERNELS(MXQ_SM90)                                          \
  MXQ_SM90(mxq::kPf6, 16); MXQ_SM90(mxq::kPf6, 32); MXQ_SM90(mxq::kPf6, 64); \
  MXQ_SM90(mxq::kPf4, 16); MXQ_SM90(mxq::kPf4, 32); MXQ_SM90(mxq::kPf4, 64); \
  MXQ_SM90(mxq::kFp16, 8); MXQ_SM90(mxq::kFp16, 16);                        \
  MXQ_SM90(mxq::kFp16, 32); MXQ_SM90(mxq::kFp16, 64);                       \
  MXQ_SM90(mxq::kBf16, 8); MXQ_SM90(mxq::kBf16, 16);                        \
  MXQ_SM90(mxq::kBf16, 32); MXQ_SM90(mxq::kBf16, 64);                       \
  MXQ_SM90(mxq::kEmi8, 4); MXQ_SM90(mxq::kEmi8, 8);                         \
  MXQ_SM90(mxq::kEmi8, 16); MXQ_SM90(mxq::kEmi8, 32);                       \
  MXQ_SM90(mxq::kEmi8, 64);                                                \
  MXQ_SM90(mxq::kSb4, 2); MXQ_SM90(mxq::kSb4, 4); MXQ_SM90(mxq::kSb4, 8);    \
  MXQ_SM90(mxq::kSb4, 16); MXQ_SM90(mxq::kSb4, 32);                         \
  MXQ_SM90(mxq::kSb4, 64);                                                 \
  MXQ_SM90(mxq::kSb2, 4); MXQ_SM90(mxq::kSb2, 8); MXQ_SM90(mxq::kSb2, 16);  \
  MXQ_SM90(mxq::kSb2, 32); MXQ_SM90(mxq::kSb2, 64);                         \
  MXQ_SM90(mxq::kInt8, 4); MXQ_SM90(mxq::kInt8, 8);                         \
  MXQ_SM90(mxq::kInt8, 16); MXQ_SM90(mxq::kInt8, 32);                       \
  MXQ_SM90(mxq::kInt8, 64);                                                \
  MXQ_SM90(mxq::kFp8E4m3, 4); MXQ_SM90(mxq::kFp8E4m3, 8);                   \
  MXQ_SM90(mxq::kFp8E4m3, 16); MXQ_SM90(mxq::kFp8E4m3, 32);                 \
  MXQ_SM90(mxq::kFp8E4m3, 64);                                             \
  MXQ_SM90(mxq::kFp8E5m2, 4); MXQ_SM90(mxq::kFp8E5m2, 8);                   \
  MXQ_SM90(mxq::kFp8E5m2, 16); MXQ_SM90(mxq::kFp8E5m2, 32);                 \
  MXQ_SM90(mxq::kFp8E5m2, 64)
// Every decode that gemm_dq is compiled for, as MXQ_GEMM(D) in a switch.
#define MXQ_GEMM_DECODES(MXQ_GEMM)                                         \
  case mxq::kEmi8: MXQ_GEMM(mxq::kEmi8); break;                            \
  case mxq::kInt8: MXQ_GEMM(mxq::kInt8); break;                            \
  case mxq::kSb4: MXQ_GEMM(mxq::kSb4); break;                              \
  case mxq::kSb2: MXQ_GEMM(mxq::kSb2); break;                              \
  case mxq::kPf4: MXQ_GEMM(mxq::kPf4); break;                              \
  case mxq::kPf6: MXQ_GEMM(mxq::kPf6); break;                              \
  case mxq::kBf16: MXQ_GEMM(mxq::kBf16); break;                            \
  case mxq::kFp16: MXQ_GEMM(mxq::kFp16); break;                            \
  case mxq::kFp8E4m3: MXQ_GEMM(mxq::kFp8E4m3); break;                      \
  case mxq::kFp8E5m2: MXQ_GEMM(mxq::kFp8E5m2); break

// x: (M, K) bf16; codes: (NB, rows, N) in the transport's container, with
// Kp = NB * B >= K; se: (NB, N) int8; out: (M, N) bf16 or f32; decode: an
// mxq::Decode; sm90: the route that dequant_matmul.py::gemm_route chose,
// 1 for gemm_dq_sm90 (pf6 and pf4 at B = 16, 32, 64; fp16 and bf16 at
// B = 8, 16, 32, 64; emi8, int8 and float8 at B = 4, 8, 16, 32, 64; sb4 at B = 2 to
// 64; sb2 at B = 4 to 64; x with K % 8 == 0, 16-byte aligned), 0 for
// gemm_dq (every decode, any B). Returns the cudaError_t of the launch (0
// on success; cudaErrorInvalidValue for an unknown decode or an sm90
// decode and block with no kernel).
extern "C" int dequant_matmul(const void* x, const void* codes,
                              const void* se, void* out, int M, int K, int N,
                              int Kp, int B, int decode, int mw, int ebits,
                              int fold, int out_bf16, int sm90,
                              void* stream) {
  const dim3 grid = mxq::gemm_grid(M, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  if (sm90) {
#define MXQ_SM90(D, BS)                                                    \
  if (decode == D && B == BS)                                              \
  return launch_sm90<D, BS>(x, cp, sp, out, M, K, N, Kp / B, mw, ebits,    \
                            fold, out_bf16, st)
    MXQ_SM90_KERNELS(MXQ_SM90);
#undef MXQ_SM90
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define MXQ_GEMM(D)                                                     \
  gemm_dq<D><<<grid, mxq::kGemmThreads, 0, st>>>(xp, cp, sp, out, M, K, N, \
                                                 Kp, B, mw, ebits, fold,  \
                                                 out_bf16)
  switch (decode) {
    MXQ_GEMM_DECODES(MXQ_GEMM);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_GEMM
  return static_cast<int>(cudaGetLastError());
}

// The test hook's entry: bits (Kp, N) uint16 from the decode of the GEMM
// that sm90 names (1: gemm_dq_sm90's decoder, 0: gemm_dq's), on the
// operands of dequant_matmul. Returns the cudaError_t of the launch.
extern "C" int dequant_b_tile(const void* codes, const void* se, void* bits,
                              int N, int Kp, int B, int decode, int mw,
                              int ebits, int fold, int sm90, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* out = static_cast<uint16_t*>(bits);
  const int n_tiles = (N + mxq::kGemmBN - 1) / mxq::kGemmBN;
  if (sm90) {
    const dim3 grid(n_tiles, (Kp + mxq::sm90::kBK - 1) / mxq::sm90::kBK);
#define MXQ_SM90(D, BS)                                                    \
  if (decode == D && B == BS) {                                            \
    b_tile_sm90<D, BS><<<grid, 128 * Sm90Dec<D, BS>::kDwg, 0, st>>>(       \
        cp, sp, out, N, Kp / B, mw, ebits, fold);                          \
    return static_cast<int>(cudaGetLastError());                           \
  }
    MXQ_SM90_KERNELS(MXQ_SM90);
#undef MXQ_SM90
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_tiles, (Kp + mxq::kGemmBK - 1) / mxq::kGemmBK);
#define MXQ_GEMM(D)                                                      \
  b_tile_dq<D><<<grid, mxq::kGemmThreads, 0, st>>>(cp, sp, out, N, Kp, B, \
                                                   mw, ebits, fold)
  switch (decode) {
    MXQ_GEMM_DECODES(MXQ_GEMM);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_GEMM
  return static_cast<int>(cudaGetLastError());
}
