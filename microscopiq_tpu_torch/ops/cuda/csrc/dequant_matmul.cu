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
// The pf6 transport runs on gemm_sm90.cuh's wgmma + TMA mainloop instead
// (gemm_dq_sm90): its decode reads the TMA-loaded raw copy of the packed
// rows in shared memory, a column of one MX block per thread. One read of
// the two low-plane rows and the high-plane row of packed-row group g gives
// K rows g, g + B/4, g + B/2 and g + 3B/4 (common.cuh's decode_group
// order), each times 2^(se - fold): at most 3 significant bits times a
// power of two, exact in bf16, so the B tile is the twin's bf16 weight bit
// for bit. The wgmma k16 steps sum in gemm_dq's order; the shipped digests
// of the pf6 GEMM stayed equal.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

using mxq::BTile;
using mxq::exp2_i32;

template <int D>
__global__ void __launch_bounds__(mxq::kGemmThreads)
gemm_dq(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
        const int8_t* __restrict__ se, void* out, int M, int K, int N, int Kp,
        int B, int mw, int ebits, int fold, int out_bf16) {
  constexpr int F = mxq::fields<D>();
  const bool nvec = (N % 16) == 0;
  const int per = B / F;
  // B tile: thread -> row tid/8, 16 columns
  const int b_r = threadIdx.x >> 3, b_c = (threadIdx.x & 7) * 16;
  const int n_blk = blockIdx.x * mxq::kGemmBN;
  auto decode = [&](BTile Bs, int k0) {
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
  };
  mxq::gemm_tile(x, out, M, K, N, Kp, out_bf16, decode);
}

// ---------------------------------------------------------------------------
// pf6 on the sm90 mainloop
// ---------------------------------------------------------------------------
// The pf6 decoder of gemm_sm90.cuh's mainloop for blocks of B K rows. Raw
// copy of a 64-row step: the 3B/4 packed rows of each of its 64/B blocks,
// then one exponent row a block, 128 bytes (columns) a row. A decode
// thread owns one column of a block: one read of the two low-plane rows and
// the high-plane row of packed-row group g gives K rows g, g + B/4,
// g + B/2 and g + 3B/4.
template <int B>
struct Pf6Sm90 {
  static_assert(B == 16 || B == 32, "block of 16 or 32");
  static constexpr int kN = mxq::sm90::kBN;
  static constexpr int kRows = 3 * B / 4;
  static constexpr int kBlocks = mxq::sm90::kBK / B;
  static constexpr int kCodeRows = kBlocks * kRows;
  static constexpr int kRawBytes = (kCodeRows + kBlocks) * kN;
  static constexpr int kStages = 4, kRawBufs = 3, kDwg = 2;   // 213 KB

  const int8_t* __restrict__ codes;     // (NB, 3B/4, N)
  const int8_t* __restrict__ se;        // (NB, N)
  const CUtensorMap* codes_map;         // codes as (NB * 3B/4, N) rows
  const CUtensorMap* se_map;
  int N, NB, mw, ebits, fold;
  bool tma;                             // N % 16 == 0: TMA copies

  __device__ __forceinline__ int tx_bytes() const { return kRawBytes; }

  __device__ __forceinline__ void copy_tma(int8_t* raw, int k0, int n0,
                                           uint32_t bar) const {
    const int nb0 = k0 / B;
    mxq::sm90::tma_load_2d(raw, codes_map, n0, nb0 * kRows, bar);
    mxq::sm90::tma_load_2d(raw + kCodeRows * kN, se_map, n0, nb0, bar);
  }

  template <int DWG>
  __device__ __forceinline__ void copy(int8_t* raw, int k0, int n0,
                                       int t) const {
    const int nb0 = k0 / B;
    for (int c = t; c < (kCodeRows + kBlocks) * kN; c += 128 * DWG) {
      const int i = c / kN, n = n0 + c % kN;
      const bool code_row = i < kCodeRows;
      const int nb = nb0 + (code_row ? i / kRows : i - kCodeRows);
      int8_t v = 0;
      if (nb < NB && n < N)
        v = code_row ? codes[(static_cast<size_t>(nb) * kRows + i % kRows)
                             * N + n]
                     : se[static_cast<size_t>(nb) * N + n];
      raw[c] = v;
    }
  }

  // The B weights of one column of a block, in bf16 pairs (K rows 2i,
  // 2i + 1 in u[i]); wt(lo, flo, hi, fhi) decodes one field.
  template <class Wt>
  __device__ __forceinline__ void decode_block(const int8_t* cb,
                                               uint32_t (&u)[B / 2],
                                               Wt wt) const {
    constexpr int q = B / 4;
#pragma unroll
    for (int g = 0; g < q; g += 2) {
      const int lo0 = cb[g * kN], lo1 = cb[(g + q) * kN];
      const int hi = cb[(2 * q + g) * kN];
      const int lo0b = cb[(g + 1) * kN], lo1b = cb[(g + 1 + q) * kN];
      const int hib = cb[(2 * q + g + 1) * kN];
      u[g / 2] = mxq::sm90::pack_bf16(wt(lo0, 0, hi, 0), wt(lo0b, 0, hib, 0));
      u[(g + q) / 2] =
          mxq::sm90::pack_bf16(wt(lo1, 0, hi, 1), wt(lo1b, 0, hib, 1));
      u[(g + 2 * q) / 2] =
          mxq::sm90::pack_bf16(wt(lo0, 1, hi, 2), wt(lo0b, 1, hib, 2));
      u[(g + 3 * q) / 2] =
          mxq::sm90::pack_bf16(wt(lo1, 1, hi, 3), wt(lo1b, 1, hib, 3));
    }
  }

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    const int col = t % kN;
#pragma unroll
    for (int i = 0; i < (kBlocks + DWG - 1) / DWG; ++i) {
      const int blk = t / kN + i * DWG;
      if (blk >= kBlocks) break;
      const int8_t* cb = raw + blk * kRows * kN + col;
      const int s = max(-126, min(127, static_cast<int>(
                                           raw[(kCodeRows + blk) * kN + col])
                                           - fold));
      uint32_t u[B / 2];
      if (mw + ebits == 5 && s + 62 + mw <= 127) {
        // The code's 5 e/m bits placed as an f32 with exponent field e and
        // mantissa m (a subnormal for e = 0) are its decode_pf magnitude
        // times 2^-(126 + mw) for every e, so two exact products, by 2^64
        // and by 2^(62 + mw + s), give decode_pf(c) · 2^s with one
        // rounding, as decode_pf's float(mag) · exp2_i32(s); a negative
        // zero code gives +0, as decode_pf.
        const float scale = __int_as_float((s + 62 + mw + 127) << 23);
        const int sh = 23 - mw;
        decode_block(cb, u, [&](int lo, int flo, int hi, int fhi) {
          const int h = hi >> (2 * fhi);
          const uint32_t c5 = ((lo >> (4 * flo)) & 0xF) | ((h & 1) << 4);
          const uint32_t bits = (static_cast<uint32_t>(h & 2) << 30)
                                | (c5 << sh);
          return __uint_as_float(c5 ? bits : 0u) * 0x1p64f * scale;
        });
      } else {                          // scales near the f32 limits
        const float sc = mxq::exp2_i32(s);
        decode_block(cb, u, [&](int lo, int flo, int hi, int fhi) {
          return mxq::decode_pf6(lo, flo, hi, fhi, mw, ebits) * sc;
        });
      }
      mxq::sm90::store_b_words<B>(b, col, blk * B / 8, u);
    }
  }
};

// grid: M tiles x N tiles of 256 x 128 (gemm_sm90.cuh); x (M, K) bf16 with
// K % 8 == 0 through xmap.
template <int D, int B>
__global__ void __launch_bounds__(mxq::sm90::threads(Pf6Sm90<B>::kDwg), 1)
gemm_dq_sm90(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap codes_map,
             const __grid_constant__ CUtensorMap se_map,
             const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
             void* out, int M, int K, int N, int NB, int mw, int ebits,
             int fold, int out_bf16, int tma) {
  static_assert(D == mxq::kPf6, "the sm90 mainloop decodes pf6");
  using Dec = Pf6Sm90<B>;
  Dec dec{codes, se, &codes_map, &se_map, N, NB, mw, ebits, fold, tma != 0};
  mxq::sm90::gemm<Dec::kStages, Dec::kRawBufs, Dec::kDwg>(&xmap, out, M, N,
                                                         K, out_bf16, dec);
}

template <int B>
int launch_pf6(const void* x, const int8_t* codes, const int8_t* se,
               void* out, int M, int K, int N, int NB, int mw, int ebits,
               int fold, int out_bf16, cudaStream_t st) {
  using Dec = Pf6Sm90<B>;
  constexpr int smem =
      mxq::sm90::Ring<Dec::kStages, Dec::kRawBytes, Dec::kRawBufs>::kBytes;
  // TMA copies of the raw operands where their rows are 16-byte multiples
  CUtensorMap codes_map{}, se_map{};
  const int tma = N % 16 == 0;
  if (tma) {
    const long long rows = static_cast<long long>(NB) * Dec::kRows;
    int err = mxq::sm90::raw_tensor_map(&codes_map, codes, 1, N, rows,
                                        Dec::kN, Dec::kCodeRows);
    if (err == 0)
      err = mxq::sm90::raw_tensor_map(&se_map, se, 1, N, NB, Dec::kN,
                                      Dec::kBlocks);
    if (err != 0) return err;
  }
  return mxq::sm90::launch<Dec::kDwg>(gemm_dq_sm90<mxq::kPf6, B>, smem, x,
                                      M, N, K, st, codes_map, se_map, codes,
                                      se, out, M, K, N, NB, mw, ebits, fold,
                                      out_bf16, tma);
}

}  // namespace

// x: (M, K) bf16; codes: (NB, rows, N) in the transport's container, with
// Kp = NB * B >= K; se: (NB, N) int8; out: (M, N) bf16 or f32; decode: an
// mxq::Decode. pf6 (gemm_dq_sm90) needs K % 8 == 0, x 16-byte aligned and
// B = 16 or 32. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an unknown decode or operands pf6 refuses).
extern "C" int dequant_matmul(const void* x, const void* codes,
                              const void* se, void* out, int M, int K, int N,
                              int Kp, int B, int decode, int mw, int ebits,
                              int fold, int out_bf16, void* stream) {
  const dim3 grid = mxq::gemm_grid(M, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
#define MXQ_GEMM(D)                                                     \
  gemm_dq<D><<<grid, mxq::kGemmThreads, 0, st>>>(xp, cp, sp, out, M, K, N, \
                                                 Kp, B, mw, ebits, fold,  \
                                                 out_bf16)
  switch (decode) {
    case mxq::kEmi8: MXQ_GEMM(mxq::kEmi8); break;
    case mxq::kInt8: MXQ_GEMM(mxq::kInt8); break;
    case mxq::kSb4: MXQ_GEMM(mxq::kSb4); break;
    case mxq::kSb2: MXQ_GEMM(mxq::kSb2); break;
    case mxq::kPf4: MXQ_GEMM(mxq::kPf4); break;
    case mxq::kPf6:
      if (B == 32)
        return launch_pf6<32>(x, cp, sp, out, M, K, N, Kp / B, mw, ebits,
                              fold, out_bf16, st);
      if (B == 16)
        return launch_pf6<16>(x, cp, sp, out, M, K, N, Kp / B, mw, ebits,
                              fold, out_bf16, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case mxq::kBf16: MXQ_GEMM(mxq::kBf16); break;
    case mxq::kFp16: MXQ_GEMM(mxq::kFp16); break;
    case mxq::kFp8E4m3: MXQ_GEMM(mxq::kFp8E4m3); break;
    case mxq::kFp8E5m2: MXQ_GEMM(mxq::kFp8E5m2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_GEMM
  return static_cast<int>(cudaGetLastError());
}
