// The wgmma + TMA GEMMs (gemm_sm90.cuh) at the MX blocks that the
// compiled-per-block decoders of dequant_matmul.cu and outlier_matmul.cu do
// not take: y = x @ dequant(W) for M > 64 tokens (the side-band format from
// 256), with the block taken at run time.
//
// Replaces, at those blocks, microscopiq_tpu/ops/pallas/dequant_matmul.py::
// _dq_matmul_kernel (emi8, emi8m, the int8 and float8 containers; the pf6,
// pf4, sb4, sb2, bf16 and fp16 transports, which the JAX package sends to
// XLA at this size) and ::_dq_matmul_outlier_kernel (the side-band
// PackedMXOutlier; JAX: XLA). The TPU kernel takes any block in one design
// (a K tile that is a multiple of the block); here one kernel a decode
// takes every block through "units", the raw copies of gemm_sm90.cuh's
// UnitDecoder mainloop:
// - RowAny (a byte or two a K row: emi8, the int8 container in emi8's
//   kernel (mw = 8, its own decode path), float8, fp16, bf16): a unit is
//   one 64-row stage; its raw copy holds the stage's 64 code rows and the
//   exponent rows of every block they touch (exp_rows: 64 / B where B
//   divides 64, else at most ceil(63 / B) + 1, so up to 64 at block 1). A
//   chunk of 8 K rows of a column takes one scale (B a multiple of 8), two
//   (other B >= 8) or a scale a row (B < 8), the case chosen once a call.
//   One-byte codes: 4 stages, 2 raw buffers; two-byte: 3 and 3.
// - PlanarAny (pf6, pf4, sb4, sb2, planar within a block: a packed row
//   holds K rows of several quarters or halves of its block): a unit is
//   lcm(B, 64) K rows, whole blocks (pf4 at 48: 4 blocks of 24 packed
//   rows; pf6 at 128: one block of 96), decoded into lcm / 64 stages, so
//   every packed byte is copied once; where that copy would not fit (sb4
//   at 18: lcm 576), one 64-row stage and the whole blocks that hold it
//   (a block straddling two stages is copied for both). pf6 and pf4
//   chunks never cross a block or a plane (B % 32, B % 16); sb4 and sb2
//   chunks cross at most one block edge. 3 stages, 2 raw buffers of up to
//   327 rows of 128 columns.
// - SidebandAny: a unit is the largest of 64, 32, 16 and 8 K rows whose
//   raw copy (code rows, se and seo rows, then the outlier codes and int32
//   positions of its blocks in boxes of up to 256 slots) fits 41,856 bytes:
//   64 at block 48 with 4 slots, 32 (two units a stage) at block 8 with 8
//   slots, whose 51,200-byte step left no ring, 8 at block 2 with 8. Each
//   row's side-band weight is its inlier plus, in slot order, the slots
//   that name it (+0 for the others), then one bf16 rounding (B <= 8: a
//   chunk's rows in registers; B > 8: the inlier chunks, then each named
//   row rewritten once a block). Slots that name none of a warp's rows
//   cost their loads alone. 3 stages, 2 raw buffers.
// Each decode writes gemm_tile's bf16 weight bit for bit: the code's value
// times the clamped 2^(se - fold) in f32, rounded once (fp16 codes rounded
// to bf16 first, decode_half's order, but where every scale is >= 2^-102,
// where one rounding of the product is the same); the pf6 and pf4 fast
// paths are Pf6Sm90's exact f32 placement. One kernel a decode (the block,
// the unit and the exponent rows at run time): 9 gemm_any_sm90, 9
// b_tile_any test hooks, 1 sideband_any_sm90. dequant_matmul.py::sm90_unit
// mirrors the units, and the C entries refuse a unit that differs from the
// caller's.
//
// What bounds it on the H100: operations, as every sm90 GEMM at M = 1024
// (2*M*N*K / 989 TFLOP/s).
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

namespace sm90 = mxq::sm90;
using mxq::exp2_i32;
constexpr int kN = sm90::kBN, kBK = sm90::kBK;

// exponent rows that a unit of U K rows (starting at a multiple of U) of
// blocks of B reads: U / B where B divides U, else at most ceil((U-1)/B)+1
__host__ __device__ inline int exp_rows(int U, int B) {
  return U % B == 0 ? U / B : (U + B - 2) / B + 1;
}
__host__ __device__ inline int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// n / d for 0 <= n < 2^22 and d >= 1 through inv = 1 / d as an f32 (the
// product is within one of the quotient; one correction), where a division
// by an int taken at run time costs ~25 instructions.
__device__ __forceinline__ int div_by(int n, int d, float inv) {
  int q = __float2int_rz(__int2float_rn(n) * inv);
  const int r = n - q * d;
  return q + (r >= d) - (r < 0);
}

// How a chunk of 8 K rows takes its scales: one block (B a multiple of 8:
// chunks never cross an edge), at most two (other B >= 8), 8 / B whole
// blocks (B = 1, 2, 4: kWhole + B; RowAny) or a scale a row (other B < 8).
// Chosen once a call: a branch over them in every chunk costs the
// decoders ~14% (emi8 at block 64 on the H100), and a scale a row at B = 2
// ~24% (float8 at block 2).
enum Scales { kOneBlock = 0, kTwoBlocks = 1, kSmallBlocks = 2, kWhole = 8 };
__device__ __forceinline__ Scales scales_of(int B) {
  return B % 8 == 0 ? kOneBlock : B >= 8 ? kTwoBlocks : kSmallBlocks;
}

// A thread's walk over consecutive chunks of 8 K rows of one column: the
// block of the chunk's first row (blk, from the copy's first exponent row)
// and its row in that block (off); none of it divides a chunk after the
// first.
struct RowWalk {
  int blk, off;
  __device__ __forceinline__ RowWalk(int k0, int k, int B, float inv) {
    const int q = div_by(k, B, inv);
    blk = q - div_by(k0, B, inv);
    off = k - q * B;
  }
  // The 8 scales 2^(se - fold) (clamped as exp2_i32) of the chunk, from
  // the exponent rows se, then on to the next chunk (M: scales_of(B), or
  // kWhole + B).
  template <int M>
  __device__ __forceinline__ void scales(const int8_t* se, int B, int col,
                                         int fold, float (&sc)[8]) {
    if constexpr (M == kOneBlock) {
      const float s0 = exp2_i32(se[blk * kN + col] - fold);
#pragma unroll
      for (int r = 0; r < 8; ++r) sc[r] = s0;
      off += 8;
      if (off == B) {
        off = 0;
        ++blk;
      }
    } else if constexpr (M == kTwoBlocks) {
      const float s0 = exp2_i32(se[blk * kN + col] - fold);
      const float s1 =
          B - off < 8 ? exp2_i32(se[(blk + 1) * kN + col] - fold) : s0;
#pragma unroll
      for (int r = 0; r < 8; ++r) sc[r] = r < B - off ? s0 : s1;
      off += 8;
      if (off >= B) {
        off -= B;
        ++blk;
      }
    } else if constexpr (M > kWhole) {      // 8 / B whole blocks
      constexpr int kB = M - kWhole;
      float s[8 / kB];
#pragma unroll
      for (int h = 0; h < 8 / kB; ++h)
        s[h] = exp2_i32(se[(blk + h) * kN + col] - fold);
#pragma unroll
      for (int r = 0; r < 8; ++r) sc[r] = s[r / kB];
      blk += 8 / kB;
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        sc[r] = exp2_i32(se[blk * kN + col] - fold);
        if (++off == B) {
          off = 0;
          ++blk;
        }
      }
    }
  }
};

__device__ __forceinline__ uint4 pack8(const float (&w)[8]) {
  return make_uint4(sm90::pack_bf16(w[0], w[1]), sm90::pack_bf16(w[2], w[3]),
                    sm90::pack_bf16(w[4], w[5]), sm90::pack_bf16(w[6], w[7]));
}

// The raw copy of a PackedMX unit: CR code rows of CB-byte codes (flat rows
// of the (NB * R, N) codes from code_row0), then E exponent rows from block
// k0 / B, 128 columns a row; TMA copies where N % 16 == 0, else plain
// loads by every decode thread.
template <int CB, bool PLANAR>
struct AnyRaw : sm90::UnitDecoder {
  static constexpr int kCB = CB;
  const int8_t* __restrict__ codes;     // (NB, R, N) codes of CB bytes
  const int8_t* __restrict__ se;        // (NB, N)
  const CUtensorMap* codes_map;         // codes as (NB * R, N), box CR rows
  const CUtensorMap* se_map;            // box E rows
  int N, NB, B, R, U, CR, E, mw, ebits, fold;
  bool tma;
  float inv_b;                          // 1 / B (div_by)

  __device__ __forceinline__ int unit_rows() const { return U; }
  __device__ __forceinline__ int se_off() const { return CR * kN * CB; }
  __device__ __forceinline__ int tx_bytes() const {
    return se_off() + E * kN;
  }
  // a row transport's unit starts at its K row; a planar one's at its
  // first block
  __device__ __forceinline__ int code_row0(int k0) const {
    return PLANAR ? k0 / B * R : k0;
  }

  __device__ __forceinline__ void copy_tma(int8_t* raw, int k0, int n0,
                                           uint32_t bar) const {
    sm90::tma_load_2d(raw, codes_map, n0, code_row0(k0), bar);
    sm90::tma_load_2d(raw + se_off(), se_map, n0, k0 / B, bar);
  }

  template <int DWG>
  __device__ __forceinline__ void copy(int8_t* raw, int k0, int n0,
                                       int t) const {
    constexpr int kRowBytes = kN * CB;
    const int r0 = code_row0(k0), e0 = k0 / B, so = se_off();
    for (int c = t; c < so + E * kN; c += 128 * DWG) {
      int8_t v = 0;
      if (c < so) {
        const int row = r0 + c / kRowBytes, j = c % kRowBytes;
        if (row < NB * R && n0 + j / CB < N)
          v = codes[(static_cast<size_t>(row) * N + n0) * CB + j];
      } else {
        const int nb = e0 + (c - so) / kN, n = n0 + (c - so) % kN;
        if (nb < NB && n < N) v = se[static_cast<size_t>(nb) * N + n];
      }
      raw[c] = v;
    }
  }
};

// emi8 (and the int8 container: emi8 with mw = 8), float8, fp16 and bf16:
// a thread owns 64 / DWG of the unit's K rows in one column, 8 at a time.
// Each value is ByteSm90's (emi8's m̂ and 2^e' as f32 bits, float8's pair
// convert), decode_half's (fp16) or the code's 16 bits as the high half of
// an f32 (bf16), times its row's scale in f32, rounded once.
template <int D>
struct RowAny : AnyRaw<mxq::code_bytes<D>(), false> {
  static_assert(D == mxq::kEmi8 || mxq::is_fp8<D>() || D == mxq::kFp16
                    || D == mxq::kBf16, "emi8, float8, fp16 or bf16 codes");
  static constexpr int kMaxExp = kBK;             // exponent rows at block 1
  static constexpr int kRawBytes =
      kBK * kN * mxq::code_bytes<D>() + kMaxExp * kN;
  // one-byte codes: 4 stages, 2 raw buffers (225 KB); two-byte: 3 and 3
  static constexpr int kStages = mxq::code_bytes<D>() == 1 ? 4 : 3;
  static constexpr int kRawBufs = mxq::code_bytes<D>() == 1 ? 2 : 3;
  static constexpr int kDwg = 2;

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t, int k0, int) const {
    if constexpr (D == mxq::kEmi8) {
      if (this->mw == 8) {                      // the int8 container
        this->template decode_by<true, DWG>(raw, b, t, k0);
        return;
      }
    }
    this->template decode_by<false, DWG>(raw, b, t, k0);
  }

  template <bool INT8, int DWG>
  __device__ __forceinline__ void decode_by(const int8_t* raw, uint8_t* b,
                                            int t, int k0) const {
    switch (scales_of(this->B)) {
      case kOneBlock:
        this->template decode_as<kOneBlock, INT8, DWG>(raw, b, t, k0);
        break;
      case kTwoBlocks:
        this->template decode_as<kTwoBlocks, INT8, DWG>(raw, b, t, k0);
        break;
      default:
        if (this->B == 1)
          this->template decode_as<kWhole + 1, INT8, DWG>(raw, b, t, k0);
        else if (this->B == 2)
          this->template decode_as<kWhole + 2, INT8, DWG>(raw, b, t, k0);
        else if (this->B == 4)
          this->template decode_as<kWhole + 4, INT8, DWG>(raw, b, t, k0);
        else
          this->template decode_as<kSmallBlocks, INT8, DWG>(raw, b, t, k0);
    }
  }

  // INT8: the code itself through the bias (ByteSm90's int8 decode), not
  // emi8's field split
  template <int M, bool INT8, int DWG>
  __device__ __forceinline__ void decode_as(const int8_t* raw, uint8_t* b,
                                            int t, int k0) const {
    constexpr int C = 8 / DWG;                  // chunks of 8 rows a thread
    const int col = t % kN, c0 = (t / kN) * C;
    const int8_t* se = raw + this->se_off();
    [[maybe_unused]] const int sh = 8 - this->mw, emask = (1 << sh) - 1;
    RowWalk walk(k0, k0 + 8 * c0, this->B, this->inv_b);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = c0 + i;
      float sc[8], v[8];
      walk.template scales<M>(se, this->B, col, this->fold, sc);
      if constexpr (mxq::code_bytes<D>() == 2) {
        const uint16_t* w = reinterpret_cast<const uint16_t*>(raw) + col;
        if constexpr (D == mxq::kBf16) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __uint_as_float(
                static_cast<uint32_t>(w[(8 * c + j) * kN]) << 16);
        } else {
          // Fp16Sm90's fast path where every scale is at least 2^-102 (an
          // f16 value times it is exact in f32 and no bf16 subnormal, so
          // one rounding of the product is the rounded value times the
          // scale), else decode_half's rounding first
          float smin = sc[0];
#pragma unroll
          for (int j = 1; j < 8; ++j) smin = fminf(smin, sc[j]);
          if (smin >= 0x1p-102f) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              __half_raw r;
              r.x = w[(8 * c + j) * kN];
              v[j] = __half2float(__half(r));
            }
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = mxq::decode_half<mxq::kFp16>(w[(8 * c + j) * kN]);
          }
        }
      } else {
        int code[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) code[j] = raw[(8 * c + j) * kN + col];
        if constexpr (mxq::is_fp8<D>()) {
          mxq::decode_fp8<D, 8>(code, v);
        } else if constexpr (INT8) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __int_as_float(0x4B400000 + code[j]) - 12582912.f;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float m = __int_as_float(0x4B400000 + (code[j] >> sh))
                            - 12582912.f;
            const float p = __int_as_float(((code[j] & emask) + 127) << 23);
            v[j] = m * p;
          }
        }
      }
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = v[j] * sc[j];
      sm90::store_b_chunk(b, col, c, pack8(w));
    }
  }
};

// pf6, pf4, sb4, sb2: a unit of lcm(B, 64) K rows holds U / B whole
// blocks; call `part` decodes its K rows 64 part.. 64 part + 63, a thread
// owning 64 / DWG of them in one column, 8 at a time.
// - pf6 (B % 32 == 0): a chunk lies in one quarter f of one block, rows
//   g.. g + 7 of it: low-plane rows g (+ B/4 for odd f), nibble f / 2, and
//   high-plane rows B/2 + g, field f (common.cuh's decode_row order);
// - pf4 (B % 16 == 0): in one half f of one block: nibble f of packed rows
//   g.. g + 7;
// - sb4, sb2: K row j of a block is field j / R of packed row j % R
//   (R = B / F); a chunk walks the fields and crosses at most one block
//   edge (dq_unit and sm90_unit take B >= 6).
template <int D>
struct PlanarAny : AnyRaw<1, true> {
  static_assert(D == mxq::kPf6 || D == mxq::kPf4 || D == mxq::kSb4
                    || D == mxq::kSb2, "pf6, pf4, sb4 or sb2 codes");
  static constexpr int F = mxq::fields<D>();
  static constexpr int kRawBytes = 327 * kN;      // 2 buffers beside 3 stages
  static constexpr int kStages = 3, kRawBufs = 2, kDwg = 2;

  // sb4 and sb2 walk runs of L packed rows of one field, L the largest of
  // 8, 4, 2 and 1 that divides a field's rows (chosen once a call); pf6
  // and pf4 runs of 8
  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t, int k0, int part) const {
    const int q = B / (D == mxq::kPf6 ? 4 : F);
    // K rows of the copy before the unit's (a straddling unit's copy
    // starts at the block that holds k0)
    const int off0 = k0 - div_by(k0, B, inv_b) * B;
    if (q % 8 == 0)
      this->template decode_as<8, DWG>(raw, b, t, off0 + 64 * part);
    else if constexpr (D == mxq::kSb4 || D == mxq::kSb2) {
      if (q % 4 == 0)
        this->template decode_as<4, DWG>(raw, b, t, off0 + 64 * part);
      else if (q % 2 == 0)
        this->template decode_as<2, DWG>(raw, b, t, off0 + 64 * part);
      else
        this->template decode_as<1, DWG>(raw, b, t, off0 + 64 * part);
    }
  }

  // j: the stage's first K row, counted from the copy's first block
  template <int L, int DWG>
  __device__ __forceinline__ void decode_as(const int8_t* raw, uint8_t* b,
                                            int t, int j) const {
    constexpr int C = 8 / DWG;
    const int col = t % kN, c0 = (t / kN) * C;
    const int B = this->B, R = this->R, mw = this->mw, ebits = this->ebits;
    const int8_t* se = raw + this->se_off();
    auto scale_exp = [&](int blk) {
      return max(-126, min(127, se[blk * kN + col] - this->fold));
    };
    const int8_t* cb = raw + col;               // packed row r: cb[r * kN]
    // the chunk's K rows: block blk, plane (quarter or half; sb4 and sb2:
    // field) f, rows g.. of it; q rows a plane
    constexpr int kPlanes = D == mxq::kPf6 ? 4 : F;
    const int q = D == mxq::kPf6 ? B / 4 : B / kPlanes;
    const int j0 = j + 8 * c0;
    int blk = div_by(j0, B, this->inv_b), f = 0, g = j0 - blk * B;
#pragma unroll
    for (int i = 1; i < kPlanes; ++i) f += g >= i * q;
    g -= f * q;
    auto next = [&](int rows) {       // on by `rows` K rows (rows | q)
      g += rows;
      if (g >= q) {
        g -= q;
        if (++f == kPlanes) {
          f = 0;
          ++blk;
        }
      }
    };
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = c0 + i;
      float w[8];
      if constexpr (D == mxq::kPf6 || D == mxq::kPf4) {
        const int s = scale_exp(blk);
        const int lo = blk * R + g + (D == mxq::kPf6 ? (f & 1) * q : 0);
        const int hi = blk * R + 2 * q + g;       // pf6's high plane
        const int flo = D == mxq::kPf6 ? f >> 1 : f;
        if (mw + ebits == (D == mxq::kPf6 ? 5 : 3) && s + 62 + mw <= 127) {
          // Pf6Sm90's exact placement of the e/m bits as an f32
          const float scale = __int_as_float((s + 62 + mw + 127) << 23);
          const int sh = 23 - mw;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int nib = cb[(lo + r) * kN] >> (4 * flo);
            uint32_t cm, sign;
            if constexpr (D == mxq::kPf6) {
              const int e = cb[(hi + r) * kN] >> (2 * f);
              cm = (nib & 0xF) | ((e & 1) << 4);
              sign = static_cast<uint32_t>(e & 2) << 30;
            } else {
              cm = nib & 7;
              sign = static_cast<uint32_t>(nib & 8) << 28;
            }
            w[r] = __uint_as_float(cm ? sign | (cm << sh) : 0u) * 0x1p64f
                   * scale;
          }
        } else {                                  // scales near the limits
          const float sc = exp2_i32(s);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if constexpr (D == mxq::kPf6)
              w[r] = mxq::decode_pf6(cb[(lo + r) * kN], flo,
                                     cb[(hi + r) * kN], f, mw, ebits) * sc;
            else
              w[r] = mxq::decode_field<mxq::kPf4>(cb[(lo + r) * kN], flo, mw,
                                                  ebits) * sc;
          }
        }
        next(8);
      } else {
        constexpr int kBits = 8 / F;
        auto value = [&](int row, int fld) {
          return __int_as_float(
                     0x4B400000
                     + mxq::sext(cb[row * kN] >> (kBits * fld), kBits))
                 - 12582912.f;
        };
        // runs of L packed rows of one field, across at most one block
        // edge (none for L = 8)
        const int blk0 = blk;
        const float s0 = exp2_i32(scale_exp(blk));
        const float s1 =
            L < 8 && B - f * q - g < 8 ? exp2_i32(scale_exp(blk + 1)) : s0;
#pragma unroll
        for (int h = 0; h < 8 / L; ++h) {
          const int row = blk * R + g;
          const float sc = blk == blk0 ? s0 : s1;
#pragma unroll
          for (int r = 0; r < L; ++r) w[h * L + r] = value(row + r, f) * sc;
          next(L);
        }
      }
      sm90::store_b_chunk(b, col, c, pack8(w));
    }
  }
};

template <int D>
constexpr bool is_planar() {
  return D == mxq::kPf6 || D == mxq::kPf4 || D == mxq::kSb4
         || D == mxq::kSb2;
}
template <int D>
using DqAny = std::conditional_t<is_planar<D>(), PlanarAny<D>, RowAny<D>>;

// grid: M tiles x N tiles of 256 x 128 (gemm_sm90.cuh); x (M, K) bf16 with
// K % 8 == 0 through xmap.
template <int D>
__global__ void __launch_bounds__(sm90::threads(DqAny<D>::kDwg), 1)
gemm_any_sm90(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap codes_map,
              const __grid_constant__ CUtensorMap se_map,
              const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
              void* out, int M, int K, int N, int NB, int B, int R, int U,
              int CR, int E, int mw, int ebits, int fold, int out_bf16,
              int tma) {
  using Dec = DqAny<D>;
  Dec dec{{{}, codes, se, &codes_map, &se_map, N, NB, B, R, U, CR, E, mw,
           ebits, fold, tma != 0, 1.f / B}};
  sm90::gemm<Dec::kStages, Dec::kRawBufs, Dec::kDwg>(&xmap, out, M, N, K,
                                                     out_bf16, dec);
}

// bits (NB * B, N): the bf16 weight that gemm_any_sm90's decoder writes
// into its B tile, as 16-bit patterns, a 64-row stage of 128 columns a
// block (the unit copied by plain loads).
template <int D>
__global__ void __launch_bounds__(128 * DqAny<D>::kDwg)
b_tile_any(const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
           uint16_t* bits, int N, int NB, int B, int R, int U, int CR, int E,
           int mw, int ebits, int fold) {
  using Dec = DqAny<D>;
  extern __shared__ __align__(128) uint8_t any_smem[];
  int8_t* raw = reinterpret_cast<int8_t*>(any_smem);
  uint8_t* b = any_smem + sm90::raw_pad(Dec::kRawBytes);
  const Dec dec{{{}, codes, se, nullptr, nullptr, N, NB, B, R, U, CR, E, mw,
                 ebits, fold, false, 1.f / B}};
  const int d = blockIdx.y, S = U / kBK, n0 = blockIdx.x * kN;
  const int t = threadIdx.x, k0 = d / S * U;
  dec.template copy<Dec::kDwg>(raw, k0, n0, t);
  __syncthreads();
  dec.template decode<Dec::kDwg>(raw, b, t, k0, d % S);
  __syncthreads();
  for (int i = t; i < kBK * kN; i += 128 * Dec::kDwg) {
    const int k = d * kBK + i / kN, n = i % kN;
    if (k < NB * B && n0 + n < N)
      bits[static_cast<size_t>(k) * N + n0 + n] =
          *reinterpret_cast<const uint16_t*>(
              b + n * 128 + ((((k % kBK) >> 3) ^ (n & 7)) << 4)
              + (k & 7) * 2);
  }
}

// The unit of a PackedMX decode at block B (PlanarAny: R packed rows a
// block): (U, code rows, exponent rows) a unit, or U = 0 where no
// PlanarAny unit fits (code rows and exponent rows at most 256, a TMA
// box; their 128-column rows within the raw buffer).
struct Unit {
  int U, CR, E;
};
template <int D>
Unit dq_unit(int B, int R) {
  if constexpr (!is_planar<D>()) {
    const int E = exp_rows(kBK, B);
    return E <= RowAny<D>::kMaxExp ? Unit{kBK, kBK, E} : Unit{0, 0, 0};
  } else {
    // whole blocks over lcm(B, 64) rows where they fit, else a straddling
    // 64-row unit: the blocks that hold its rows
    const bool ok = (D != mxq::kPf6 || B % 32 == 0)
                    && (D != mxq::kPf4 || B % 16 == 0)
                    && (D != mxq::kSb4 || (B % 2 == 0 && B >= 6))
                    && (D != mxq::kSb2 || (B % 4 == 0 && B >= 8));
    const long long lcm = static_cast<long long>(B) / gcd(B, kBK) * kBK;
    for (const long long U : {lcm, static_cast<long long>(kBK)}) {
      const long long nb = U == lcm ? U / B : exp_rows(kBK, B);
      const long long cr = nb * R;
      if (ok && cr <= 256 && nb <= 256
          && (cr + nb) * kN <= PlanarAny<D>::kRawBytes)
        return Unit{static_cast<int>(U), static_cast<int>(cr),
                    static_cast<int>(nb)};
    }
    return Unit{0, 0, 0};
  }
}

template <int D>
int launch_any(const void* x, const int8_t* codes, const int8_t* se,
               void* out, int M, int K, int N, int NB, int B, int mw,
               int ebits, int fold, int out_bf16, int unit_rows,
               cudaStream_t st) {
  using Dec = DqAny<D>;
  const int R = mxq::packed_rows<D>(B);
  const Unit u = dq_unit<D>(B, R);
  if (u.U == 0 || u.U != unit_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem =
      sm90::Ring<Dec::kStages, Dec::kRawBytes, Dec::kRawBufs>::kBytes;
  CUtensorMap codes_map{}, se_map{};
  const int tma = N % 16 == 0;
  if (tma) {
    int err = sm90::raw_tensor_map(&codes_map, codes, Dec::kCB, N,
                                   static_cast<long long>(NB) * R, kN, u.CR);
    if (err == 0)
      err = sm90::raw_tensor_map(&se_map, se, 1, N, NB, kN, u.E);
    if (err != 0) return err;
  }
  return sm90::launch<Dec::kDwg>(gemm_any_sm90<D>, smem, x, M, N, K, st,
                                 codes_map, se_map, codes, se, out, M, K, N,
                                 NB, B, R, u.U, u.CR, u.E, mw, ebits, fold,
                                 out_bf16, tma);
}

template <int D>
int launch_b_tile_any(const int8_t* codes, const int8_t* se, uint16_t* bits,
                      int N, int NB, int B, int mw, int ebits, int fold,
                      cudaStream_t st) {
  using Dec = DqAny<D>;
  const int R = mxq::packed_rows<D>(B);
  const Unit u = dq_unit<D>(B, R);
  if (u.U == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sm90::raw_pad(Dec::kRawBytes) + sm90::kBBytes;
  cudaError_t e = cudaFuncSetAttribute(
      b_tile_any<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kN - 1) / kN, (NB * B + kBK - 1) / kBK);
  b_tile_any<D><<<grid, 128 * Dec::kDwg, smem, st>>>(
      codes, se, bits, N, NB, B, R, u.U, u.CR, u.E, mw, ebits, fold);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The side-band format
// ---------------------------------------------------------------------------
// float8_e4m3fn bits or an int8 code -> its value (Hopper's exact convert;
// the formats never store NaN).
// An int8 code becomes an f32 through the 1.5 · 2^23 bias (exact, two
// full-rate operations instead of a quarter-rate convert).
template <bool FP8>
__device__ __forceinline__ float code_value(int8_t c) {
  if constexpr (FP8)
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(c), __NV_E4M3)));
  else
    return __int_as_float(0x4B400000 + c) - 12582912.f;
}

// Raw copy of a unit of U K rows, 128 columns: the inlier codes [U][128],
// se and seo [E][128], then the outlier codes and the int32 positions of
// the E blocks' 128 * budget slots, each in boxes of sbox slots
// [box][E][sbox].
struct SidebandAny : sm90::UnitDecoder {
  static constexpr int kMaxSlots = 8;
  static constexpr int kRawBytes = 327 * kN;      // 2 buffers beside 3 stages
  static constexpr int kStages = 3, kRawBufs = 2, kDwg = 2;

  const int8_t* __restrict__ codes;     // (Kp, N)
  const int8_t* __restrict__ se;        // (NB, N)
  const int8_t* __restrict__ seo;       // (NB, N)
  const int8_t* __restrict__ oc;        // (NB, N, budget)
  const int* __restrict__ pos;          // (NB, N, budget)
  const CUtensorMap* codes_map;         // box U x 128
  const CUtensorMap* se_map;            // se and seo, box E x 128
  const CUtensorMap* seo_map;
  const CUtensorMap* oc_map;            // oc and pos as (NB, N * budget),
  const CUtensorMap* pos_map;           // boxes of E rows x sbox
  int N, NB, B, U, E, budget, fold, codes_fp8, oc_fp8, sbox_log2;
  bool tma;
  float inv_b;                          // 1 / B (div_by)

  __device__ __forceinline__ int block_of(int k) const {
    return div_by(k, B, inv_b);
  }

  __device__ __forceinline__ int unit_rows() const { return U; }
  __device__ __forceinline__ int se_off() const { return U * kN; }
  __device__ __forceinline__ int seo_off() const { return (U + E) * kN; }
  __device__ __forceinline__ int oc_off() const { return (U + 2 * E) * kN; }
  __device__ __forceinline__ int pos_off() const {
    return oc_off() + E * kN * budget;
  }
  __device__ __forceinline__ int tx_bytes() const {
    return kN * (U + E * (2 + 5 * budget));
  }
  // index of slot e (= column * budget + slot) of block blk in the oc and
  // pos regions
  __device__ __forceinline__ int slot_at(int blk, int e) const {
    return (e >> sbox_log2) * (E << sbox_log2) + (blk << sbox_log2)
           + (e & ((1 << sbox_log2) - 1));
  }

  __device__ __forceinline__ void copy_tma(int8_t* raw, int k0, int n0,
                                           uint32_t bar) const {
    using sm90::tma_load_2d;
    const int nb0 = k0 / B;
    tma_load_2d(raw, codes_map, n0, k0, bar);
    tma_load_2d(raw + se_off(), se_map, n0, nb0, bar);
    tma_load_2d(raw + seo_off(), seo_map, n0, nb0, bar);
    const int span = kN * budget, sbox = 1 << sbox_log2;
    for (int e = 0; e < span; e += sbox) {
      tma_load_2d(raw + oc_off() + E * e, oc_map, n0 * budget + e, nb0, bar);
      tma_load_2d(raw + pos_off() + 4 * E * e, pos_map, n0 * budget + e, nb0,
                  bar);
    }
  }

  template <int DWG>
  __device__ __forceinline__ void copy(int8_t* raw, int k0, int n0,
                                       int t) const {
    constexpr int nt = 128 * DWG;
    const int nb0 = k0 / B, span = kN * budget;
    for (int c = t; c < U * kN; c += nt) {                     // codes
      const int k = k0 + c / kN, n = n0 + c % kN;
      raw[c] = (k < NB * B && n < N) ? codes[static_cast<size_t>(k) * N + n]
                                     : static_cast<int8_t>(0);
    }
    for (int c = t; c < 2 * E * kN; c += nt) {                 // se, seo
      const int i = c / kN, nb = nb0 + i % E, n = n0 + c % kN;
      const int8_t* src = i < E ? se : seo;
      raw[se_off() + c] = (nb < NB && n < N)
                              ? src[static_cast<size_t>(nb) * N + n]
                              : static_cast<int8_t>(0);
    }
    int* rpos = reinterpret_cast<int*>(raw + pos_off());
    for (int c = t; c < E * span; c += nt) {                   // oc, pos
      const int blk = c / span, e = c % span, nb = nb0 + blk;
      const bool live = nb < NB && n0 + e / budget < N;
      const size_t g = (static_cast<size_t>(nb) * N + n0) * budget + e;
      raw[oc_off() + slot_at(blk, e)] = live ? oc[g] : static_cast<int8_t>(0);
      rpos[slot_at(blk, e)] = live ? pos[g] : 0;
    }
  }

  // The slots of block blk (of the copy), column col: positions (-1 past
  // the budget) and outlier codes. VEC: budget == MAXB (4 or 8), whose
  // slots of a column lie together in one box, 16-byte aligned: vector
  // loads (scalar ones would meet MAXB-way bank conflicts, a column's
  // slots being MAXB words apart).
  template <int MAXB, bool VEC>
  __device__ __forceinline__ void load_slots(const int8_t* raw, int blk,
                                             int col, int (&p)[MAXB],
                                             int (&c)[MAXB]) const {
    const int* pb = reinterpret_cast<const int*>(raw + pos_off());
    const int8_t* ocb = raw + oc_off();
    if constexpr (VEC) {
      const int at = slot_at(blk, col * MAXB);
#pragma unroll
      for (int h = 0; h < MAXB / 4; ++h) {
        const int4 v = reinterpret_cast<const int4*>(pb + at)[h];
        p[4 * h] = v.x;
        p[4 * h + 1] = v.y;
        p[4 * h + 2] = v.z;
        p[4 * h + 3] = v.w;
      }
      uint32_t w[MAXB / 4];
      if constexpr (MAXB == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(ocb + at);
        w[0] = v.x;
        w[1] = v.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(ocb + at);
      }
#pragma unroll
      for (int s = 0; s < MAXB; ++s)
        c[s] = static_cast<int8_t>(w[s / 4] >> (8 * (s % 4)));
    } else {
#pragma unroll
      for (int s = 0; s < MAXB; ++s) {
        const int at = slot_at(blk, col * budget + s);
        p[s] = s < budget ? pb[at] : -1;
        c[s] = s < budget ? ocb[at] : 0;
      }
    }
  }

  __device__ __forceinline__ float outlier(int c) const {
    return oc_fp8 ? code_value<true>(static_cast<int8_t>(c))
                  : code_value<false>(static_cast<int8_t>(c));
  }

  // The 8 inliers of chunk c of the unit (code · 2^(se - fold); an fp8 -0
  // code gives +0, as the TPU kernel's + 0 of the empty slots).
  template <int M>
  __device__ __forceinline__ void inliers(const int8_t* raw, int c, int col,
                                          RowWalk& walk,
                                          float (&v)[8]) const {
    float sc[8];
    walk.scales<M>(raw + se_off(), B, col, fold, sc);
    if (codes_fp8) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        v[r] = code_value<true>(raw[(8 * c + r) * kN + col]) * sc[r] + 0.f;
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        v[r] = code_value<false>(raw[(8 * c + r) * kN + col]) * sc[r];
    }
  }

  // A thread's consecutive chunks of 8 K rows of one column, the side-band
  // weight of each row: its inlier plus, in slot order, every slot of its
  // block that names it (+0 for the others), one rounding.
  // - B <= 8 (a chunk holds whole blocks or crosses one edge): for each
  //   block the chunk touches, each slot added to the chunk's rows (a
  //   compare a row) unless it names no row of the chunk in any lane of
  //   the warp (the lanes of a warp share their chunks);
  // - B > 8 (a block spans chunks): the chunks' inliers first; then once
  //   for each block that the thread's rows touch, each row that a slot
  //   names among them (its first slot) rewritten with its side-band
  //   weight, where a slot of the warp names one.
  template <int MAXB, bool VEC, int M, int DWG>
  __device__ __forceinline__ void decode_cols(const int8_t* raw, uint8_t* b,
                                              int t, int k0,
                                              int part) const {
    const int col = t % kN, nb0 = block_of(k0);
    const int per = (U / 8 + DWG - 1) / DWG;            // chunks a thread
    const int c0 = (t / kN) * per, c1 = min(c0 + per, U / 8);
    if (c0 >= c1) return;
    const int8_t* se = raw + se_off();
    const int8_t* seo = raw + seo_off();
    RowWalk walk(k0, k0 + 8 * c0, B, inv_b);
    if (M == kSmallBlocks || (M == kOneBlock && B == 8)) {
#pragma unroll 1
      for (int c = c0; c < c1; ++c) {
        const int k = k0 + 8 * c;
        float v[8];
        inliers<M>(raw, c, col, walk, v);
#pragma unroll 1
        for (int q = block_of(k), q1 = block_of(k + 7); q <= q1; ++q) {
          const int blk = q - nb0, base = q * B - k;
          int p[MAXB], oc[MAXB];
          load_slots<MAXB, VEC>(raw, blk, col, p, oc);
          int rr[MAXB];
          unsigned mine = 0;
#pragma unroll
          for (int s = 0; s < MAXB; ++s) {
            rr[s] = (p[s] >= 0 && p[s] < B) ? base + p[s] : -1;
            if (static_cast<unsigned>(rr[s]) < 8u) mine |= 1u << s;
          }
          const unsigned any = __reduce_or_sync(0xFFFFFFFFu, mine);
          if (any == 0) continue;
          const int s_in = se[blk * kN + col];
          const float sc_out = exp2_i32(seo[blk * kN + col] - s_in);
#pragma unroll
          for (int s = 0; s < MAXB; ++s) {
            if (!((any >> s) & 1)) continue;
            const float os = outlier(oc[s]) * sc_out;
#pragma unroll
            for (int r = 0; r < 8; ++r) v[r] += rr[s] == r ? os : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] += 0.f;
        sm90::store_b_chunk(b, col, part * (U / 8) + c, pack8(v));
      }
      return;
    }
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      float v[8];
      inliers<M>(raw, c, col, walk, v);
      sm90::store_b_chunk(b, col, part * (U / 8) + c, pack8(v));
    }
    const int a0 = k0 + 8 * c0, a1 = k0 + 8 * c1;      // my K rows
#pragma unroll 1
    for (int q = block_of(a0), q1 = block_of(a1 - 1); q <= q1; ++q) {
      const int blk = q - nb0;
      const int lo = max(a0 - q * B, 0), hi = min(a1 - q * B, B);
      int p[MAXB], oc[MAXB];
      load_slots<MAXB, VEC>(raw, blk, col, p, oc);
      unsigned mine = 0;
#pragma unroll
      for (int s = 0; s < MAXB; ++s)
        if (p[s] >= lo && p[s] < hi) mine |= 1u << s;
      const unsigned any = __reduce_or_sync(0xFFFFFFFFu, mine);
      if (any == 0) continue;
      const int s_in = se[blk * kN + col];
      const float sc_in = exp2_i32(s_in - fold);
      const float sc_out = exp2_i32(seo[blk * kN + col] - s_in);
      float o[MAXB];
#pragma unroll
      for (int s = 0; s < MAXB; ++s) o[s] = outlier(oc[s]) * sc_out;
#pragma unroll
      for (int s = 0; s < MAXB; ++s) {
        if (!((any >> s) & 1)) continue;
        bool first = (mine >> s) & 1;
#pragma unroll
        for (int u = 0; u < s; ++u) first = first && p[u] != p[s];
        if (first) {
          const int row = q * B + p[s] - k0;            // of the unit
          const int8_t code = raw[row * kN + col];
          float w = (codes_fp8 ? code_value<true>(code)
                               : code_value<false>(code)) * sc_in;
#pragma unroll
          for (int u = s; u < MAXB; ++u) w += p[u] == p[s] ? o[u] : 0.f;
          sm90::store_b_elem(b, col, part * U + row, w + 0.f);
        }
      }
    }
  }

  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t, int k0, int part) const {
    if (budget == 8)
      decode_as<8, true, DWG>(raw, b, t, k0, part);
    else if (budget == 4)
      decode_as<4, true, DWG>(raw, b, t, k0, part);
    else
      decode_as<kMaxSlots, false, DWG>(raw, b, t, k0, part);
  }

  template <int MAXB, bool VEC, int DWG>
  __device__ __forceinline__ void decode_as(const int8_t* raw, uint8_t* b,
                                            int t, int k0, int part) const {
    switch (scales_of(B)) {
      case kOneBlock:
        decode_cols<MAXB, VEC, kOneBlock, DWG>(raw, b, t, k0, part);
        break;
      case kTwoBlocks:
        decode_cols<MAXB, VEC, kTwoBlocks, DWG>(raw, b, t, k0, part);
        break;
      default:
        decode_cols<MAXB, VEC, kSmallBlocks, DWG>(raw, b, t, k0, part);
    }
  }
};

__global__ void __launch_bounds__(sm90::threads(SidebandAny::kDwg), 1)
sideband_any_sm90(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap codes_map,
                  const __grid_constant__ CUtensorMap se_map,
                  const __grid_constant__ CUtensorMap seo_map,
                  const __grid_constant__ CUtensorMap oc_map,
                  const __grid_constant__ CUtensorMap pos_map,
                  const int8_t* __restrict__ codes,
                  const int8_t* __restrict__ se,
                  const int8_t* __restrict__ seo,
                  const int8_t* __restrict__ oc, const int* __restrict__ pos,
                  void* out, int M, int K, int N, int NB, int B, int U, int E,
                  int budget, int fold, int codes_fp8, int oc_fp8,
                  int out_bf16, int sbox_log2, int tma) {
  SidebandAny dec{{}, codes, se, seo, oc, pos, &codes_map, &se_map, &seo_map,
                  &oc_map, &pos_map, N, NB, B, U, E, budget, fold, codes_fp8,
                  oc_fp8, sbox_log2, tma != 0, 1.f / B};
  sm90::gemm<SidebandAny::kStages, SidebandAny::kRawBufs, SidebandAny::kDwg>(
      &xmap, out, M, N, K, out_bf16, dec);
}

// The side-band unit at block B with `budget` slots: the largest of 64, 32,
// 16 and 8 K rows whose raw copy fits, or U = 0.
Unit sideband_unit(int B, int budget) {
  for (int U = kBK; U >= 8; U /= 2) {
    const int E = exp_rows(U, B);
    if (E <= 256 && kN * (U + E * (2 + 5 * budget)) <= SidebandAny::kRawBytes)
      return {U, U, E};
  }
  return {0, 0, 0};
}

}  // namespace

// x: (M, K) bf16, K % 8 == 0, 16-byte aligned; codes: (NB, R, N) in the
// transport's container, with Kp = NB * B >= K; se: (NB, N) int8; out:
// (M, N) bf16 or f32; decode: an mxq::Decode; unit_rows: the caller's unit
// (dequant_matmul.py::sm90_plan), which must be the kernel's. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for an
// unknown decode, a block that no unit takes or another unit).
extern "C" int dequant_matmul_any(const void* x, const void* codes,
                                  const void* se, void* out, int M, int K,
                                  int N, int Kp, int B, int decode, int mw,
                                  int ebits, int fold, int out_bf16,
                                  int unit_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  const int NB = Kp / B;
#define MXQ_ANY(D, MW)                                                     \
  return launch_any<D>(x, cp, sp, out, M, K, N, NB, B, MW, ebits, fold,    \
                       out_bf16, unit_rows, st)
  switch (decode) {
    case mxq::kEmi8: MXQ_ANY(mxq::kEmi8, mw);
    case mxq::kInt8: MXQ_ANY(mxq::kEmi8, 8);       // m̂ = the code, 2^e' = 1
    case mxq::kFp8E4m3: MXQ_ANY(mxq::kFp8E4m3, mw);
    case mxq::kFp8E5m2: MXQ_ANY(mxq::kFp8E5m2, mw);
    case mxq::kFp16: MXQ_ANY(mxq::kFp16, mw);
    case mxq::kBf16: MXQ_ANY(mxq::kBf16, mw);
    case mxq::kPf6: MXQ_ANY(mxq::kPf6, mw);
    case mxq::kPf4: MXQ_ANY(mxq::kPf4, mw);
    case mxq::kSb4: MXQ_ANY(mxq::kSb4, mw);
    case mxq::kSb2: MXQ_ANY(mxq::kSb2, mw);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_ANY
}

// The test hook's entry: bits (Kp, N) uint16, the B tile that
// dequant_matmul_any's decoder writes, on its operands. Returns the
// cudaError_t of the launch.
extern "C" int dequant_b_tile_any(const void* codes, const void* se,
                                  void* bits, int N, int Kp, int B,
                                  int decode, int mw, int ebits, int fold,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* out = static_cast<uint16_t*>(bits);
#define MXQ_ANY(D, MW)                                                     \
  return launch_b_tile_any<D>(cp, sp, out, N, Kp / B, B, MW, ebits, fold, st)
  switch (decode) {
    case mxq::kEmi8: MXQ_ANY(mxq::kEmi8, mw);
    case mxq::kInt8: MXQ_ANY(mxq::kEmi8, 8);
    case mxq::kFp8E4m3: MXQ_ANY(mxq::kFp8E4m3, mw);
    case mxq::kFp8E5m2: MXQ_ANY(mxq::kFp8E5m2, mw);
    case mxq::kFp16: MXQ_ANY(mxq::kFp16, mw);
    case mxq::kBf16: MXQ_ANY(mxq::kBf16, mw);
    case mxq::kPf6: MXQ_ANY(mxq::kPf6, mw);
    case mxq::kPf4: MXQ_ANY(mxq::kPf4, mw);
    case mxq::kSb4: MXQ_ANY(mxq::kSb4, mw);
    case mxq::kSb2: MXQ_ANY(mxq::kSb2, mw);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_ANY
}

// The side-band GEMM: operands as outlier_matmul.cu's dequant_gemm_outlier
// (x (M, K) bf16, K % 8 == 0, 16-byte aligned; Kp = NB * B >= K; budget <=
// 8); unit_rows: the caller's unit (outlier_matmul.py through sm90_plan),
// which must be the kernel's. Returns the cudaError_t of the launch.
extern "C" int dequant_gemm_outlier_any(
    const void* x, const void* codes, const void* se, const void* seo,
    const void* oc, const void* pos, void* out, int M, int K, int N, int Kp,
    int B, int budget, int fold, int codes_fp8, int oc_fp8, int out_bf16,
    int unit_rows, void* stream) {
  if (budget < 0 || budget > 8) return static_cast<int>(cudaErrorInvalidValue);
  const Unit u = sideband_unit(B, budget);
  if (u.U == 0 || u.U != unit_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int tma = N % 16 == 0 && aligned(codes) && aligned(se)
                  && aligned(seo) && (budget == 0
                                      || (aligned(oc) && aligned(pos)));
  const int NB = Kp / B;
  // oc / pos boxes of E rows and sbox slots: 128 * budget where that is
  // <= 256, else 256 (even budgets) or 128 (odd ones), which divide it
  const int span = kN * budget;
  const int sbox = span <= 256 ? (span ? span : 128)
                               : budget % 2 == 0 ? 256 : 128;
  const int sbox_log2 = sbox == 256 ? 8 : 7;
  CUtensorMap maps[5] = {};
  if (tma) {
    using sm90::raw_tensor_map;
    const long long nsb = static_cast<long long>(N) * budget;
    int err = raw_tensor_map(&maps[0], codes, 1, N,
                             static_cast<long long>(NB) * B, kN, u.U);
    if (err == 0) err = raw_tensor_map(&maps[1], se, 1, N, NB, kN, u.E);
    if (err == 0) err = raw_tensor_map(&maps[2], seo, 1, N, NB, kN, u.E);
    if (err == 0 && budget > 0)
      err = raw_tensor_map(&maps[3], oc, 1, nsb, NB, sbox, u.E);
    if (err == 0 && budget > 0)
      err = raw_tensor_map(&maps[4], pos, 4, nsb, NB, sbox, u.E);
    if (err != 0) return err;
  }
  constexpr int smem = sm90::Ring<SidebandAny::kStages, SidebandAny::kRawBytes,
                                  SidebandAny::kRawBufs>::kBytes;
  return sm90::launch<SidebandAny::kDwg>(
      sideband_any_sm90, smem, x, M, N, K, static_cast<cudaStream_t>(stream),
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(se),
      static_cast<const int8_t*>(seo), static_cast<const int8_t*>(oc),
      static_cast<const int*>(pos), out, M, K, N, NB, B, u.U, u.E, budget,
      fold, codes_fp8, oc_fp8, out_bf16, sbox_log2, tma);
}
