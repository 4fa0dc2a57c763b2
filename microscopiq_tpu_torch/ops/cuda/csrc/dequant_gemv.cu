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
// (codes + scales + x + out) / 3.35 TB/s. The f32 FMAs of that dot on CUDA
// cores alone (0.94 G at gate_up, M = 8) take 0.028 ms at 67 TFLOP/s, so
// the dot runs on the tensor cores.
//
// Two kernels, chosen before the launch by dequant_matmul.py::gemv_route:
//
// gemv_tc (blocks that are a multiple of 16, up to 256; every block a
// model arm packs), planned by dequant_matmul.py::gemv_plan:
// - One persistent CTA an SM walks over a contiguous range of (256-column
//   tile, K split) tiles. Warp 8 keeps a ring of stages in flight: each
//   stage holds sb K-blocks of packed code rows (sb * rows <= 256) in
//   128-byte-wide sub-tiles (two for one-byte codes, four for two-byte
//   ones), each one 2-D TMA box with the 128-byte swizzle, and the blocks'
//   exponent rows (one box of 256 columns), on a "full" mbarrier with
//   their byte count; plain copies where N % 16 != 0.
// - x (M rows padded to 8, 16, 32 or 64, the split's K) is staged once a
//   split in shared memory as bf16, its K order permuted within each
//   16-row mma step to the order in which a thread's codes arrive.
// - Consumer warp w owns columns 32w.. 32w + 31 of the tile; thread
//   (g = lane / 4, t = lane % 4) reads 4 neighbouring columns 32w + 4g.. of
//   the packed rows that its K positions name (one 4-byte read a row, 8
//   for two-byte codes; the swizzle makes a warp's reads conflict-free),
//   decodes them to the values of common.cuh's decodes and packs them as
//   bf16 pairs: the A fragments of two mma.m16n8k16 (columns 4g, 4g + 1 as
//   rows g and g + 8 of one, 4g + 2, 4g + 3 of the other). Every decode is
//   exact in bf16 (int codes of <= 8 significant bits, fp6/fp4/float8
//   codes, the bf16 container, the fp16 container rounded to bf16 as the
//   TPU kernel does), so a pair is the upper halves of two floats, and
//   every bf16 x bf16 product is exact in f32. The integer decodes go
//   through a float's mantissa (no conversion instruction: conversions
//   run at a quarter of the integer rate). The decode and its chain into
//   the mma, not the bytes, hold this kernel (PERF.md §6), so two k-steps
//   run side by side: with up to 16 rows of x two blocks into two accumulator
//   chains, else a block's steps in pairs.
// - Per K-block the accumulators start at zero and run over the block's
//   B/16 mma steps (one n8 tile per 8 rows of x on the same A fragment),
//   then each column's accumulator is scaled by 2^(se - fold) (exp2_i32's
//   clamp to [-126, 127]) and added to the f32 sum: the TPU kernel's
//   scale-after-dot, the tensor core never summing past one block.
// - Each tile writes an f32 partial; split_reduce adds the splits in
//   order. The plan (stage size, split) depends only on (decode, N, K, B),
//   never on M, so a row's result does not depend on the batch.
//
// gemv_partial (other blocks: 2, 4, 8, 6, 12, 20, ...; the "cc" route, on
// CUDA cores): a thread owns 4 neighbouring columns, x is staged in shared
// memory as f32 a chunk of K-blocks at a time, per K-block the dot with
// the decoded integers (or bf16 values) is accumulated in f32, scaled once
// and added to the row's sum; K split over grid.y (dequant_matmul.py::
// gemv_ksplit), f32 partials reduced in split order.
//
// Both mask the ragged N edge (lm_head, N = 128256) per column. The decode
// is a template argument; mw, ebits and fold are run-time arguments, so the
// emi8m merged-outlier stream reuses the emi8 decode with its own field
// split.
#include "gemv_tc.cuh"

namespace {

using mxq::exp2_i32;

// ---------------------------------------------------------------------------
// gemv_tc
// ---------------------------------------------------------------------------
namespace tc {

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
using mxq::gemv_tc::kSubW;
using mxq::gemv_tc::kTN;
using mxq::gemv_tc::n8_tiles;
using mxq::gemv_tc::Plan;
using mxq::gemv_tc::produce;
using mxq::gemv_tc::Ring;
using mxq::gemv_tc::ring_maps;
using mxq::gemv_tc::smem_bytes;
using mxq::gemv_tc::stage_layout;
using mxq::gemv_tc::swz;
using mxq::gemv_tc::take_role;
using mxq::gemv_tc::tile_range;
using mxq::gemv_tc::x_frag;

// The x rows of a split: bf16, plus 16 bytes (dequant_matmul.py's
// _gemv_x_bytes mirrors it).
template <int D>
__host__ __device__ inline void layout(Plan& p) {
  stage_layout<mxq::code_bytes<D>()>(p);
  p.x_pitch = p.nbps * p.B * 2 + 16;
}

// The position in a block's x row (mma order) of K row kb of the block.
// Mma step s of a block takes, for thread t, the K positions 16s + 2t + h
// + 8q (h, q in {0, 1}), which hold:
// - one code a row (F = 1): packed row 16s + 2t + h + 8q, K row the same;
// - sb4, pf4 (F = 2, P = B/2 packed rows): field h of packed row
//   8s + 2t + q, K row 8s + 2t + q + hP;
// - sb2 and pf6 (F = 4, P = B/4 rows or groups): field f = 2q + h of
//   packed row (group) 4s + t, K row 4s + t + fP.
template <int D>
__device__ __forceinline__ int kpos(int kb, int B) {
  constexpr int F = mxq::fields<D>();
  if constexpr (F == 1) {
    return kb;
  } else if constexpr (F == 2) {
    const int P = B / 2, h = kb / P, p = kb - h * P, r = p & 7;
    return 16 * (p >> 3) + (r & 6) + h + 8 * (r & 1);
  } else {
    const int P = B / 4, f = kb / P, p = kb - f * P;
    return 16 * (p >> 2) + 2 * (p & 3) + (f & 1) + 8 * (f >> 1);
  }
}

// The 32-bit word of a packed one-byte-code row at `byte` of a sub-tile:
// the codes of the thread's 4 columns, column j in byte j.
__device__ __forceinline__ uint32_t row_word(const uint8_t* sub, int row,
                                             int byte) {
  return *reinterpret_cast<const uint32_t*>(sub + swz(row, byte));
}

// f32 of an int |v| < 2^22, exactly, by the 1.5 * 2^23 bias (two
// full-rate instructions instead of a quarter-rate conversion).
__device__ __forceinline__ float small_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.f;
}

// Byte j of u (an unsigned field value plus `bias`) as the f32 of the
// field value: the byte placed in a 2^23 float's mantissa, less 2^23 + bias.
__device__ __forceinline__ float biased_byte(uint32_t u, int j, float bias) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j))
         - (8388608.f + bias);
}

// Byte j of w, sign-extended.
__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return static_cast<int8_t>((w >> (8 * j)) & 0xFF);
}

// decode_pf's signed integer (m | implicit << mw) << (e - implicit).
__device__ __forceinline__ int pf_int(int c, int mw, int ebits) {
  const int e = (c >> mw) & ((1 << ebits) - 1);
  const int m = c & ((1 << mw) - 1);
  const int ne = min(e, 1);
  const int mag = (m | (ne << mw)) << (e - ne);
  return c < 0 ? -mag : mag;
}

// A bf16 pair (lo in the low half) of two floats that bf16 holds exactly:
// their upper halves.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// v[i][j]: the decoded weight of the thread's column j at K position
// 16s + 2t + (i & 1) + 8 (i >> 1) of the block whose packed rows start at
// stage row brow, as common.cuh's decodes give it (every one exact in
// bf16), formed without conversion instructions where the code is an
// integer: int8, sb4 and sb2 through biased bytes in a float's mantissa,
// emi8 as m̂ times the float 2^e', pf4 and pf6 as decode_pf's integer.
template <int D>
__device__ __forceinline__ void decode_step(const uint8_t* sub, int brow,
                                            int s, int t, int byte, int B,
                                            int mw, int ebits,
                                            float (&v)[4][4]) {
  constexpr int F = mxq::fields<D>();
  if constexpr (D == mxq::kPf6) {
    // group 4s + t: low-plane rows g and g + B/4, high-plane row B/2 + g;
    // K row g + f B/4 is low field f / 2 of row g + (f % 2) B/4 and high
    // field f
    const int gi = brow + 4 * s + t;
    const uint32_t lo[2] = {row_word(sub, gi, byte),
                            row_word(sub, gi + B / 4, byte)};
    const uint32_t hi = row_word(sub, gi + B / 2, byte);
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (mxq::sext(static_cast<int>(hi >> (8 * j + 2 * f)), 2)
                       << 4)
                      | ((lo[f & 1] >> (8 * j + 4 * (f >> 1))) & 0xF);
        v[f][j] = small_float(pf_int(c, mw, ebits));
      }
  } else if constexpr (D == mxq::kSb2) {
    const uint32_t w = row_word(sub, brow + 4 * s + t, byte);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const uint32_t u = ((w >> (2 * f)) & 0x03030303u) ^ 0x02020202u;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[f][j] = biased_byte(u, j, 2.f);
    }
  } else if constexpr (F == 2) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t w = row_word(sub, brow + 8 * s + 2 * t + q, byte);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t nib = (w >> (4 * h)) & 0x0F0F0F0Fu;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (D == mxq::kSb4)
            v[2 * q + h][j] = biased_byte(nib ^ 0x08080808u, j, 8.f);
          else
            v[2 * q + h][j] = small_float(pf_int(
                mxq::sext(static_cast<int>(nib >> (8 * j)), 4), mw, ebits));
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = brow + 16 * s + 2 * t + (i & 1) + 8 * (i >> 1);
      if constexpr (mxq::code_bytes<D>() == 2) {
        const uint2 w = *reinterpret_cast<const uint2*>(sub + swz(row, byte));
        const int c[4] = {static_cast<int>(w.x & 0xFFFF),
                          static_cast<int>(w.x >> 16),
                          static_cast<int>(w.y & 0xFFFF),
                          static_cast<int>(w.y >> 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = mxq::decode_half<D>(c[j]);
      } else {
        const uint32_t w = row_word(sub, row, byte);
        if constexpr (mxq::is_fp8<D>()) {
          const int c[4] = {sbyte(w, 0), sbyte(w, 1), sbyte(w, 2),
                            sbyte(w, 3)};
          mxq::decode_fp8<D, 4>(c, v[i]);
        } else if constexpr (D == mxq::kInt8) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[i][j] = biased_byte(w ^ 0x80808080u, j, 128.f);
        } else {
          // emi8: m̂ · 2^e', the byte (m̂ << sh) | e'. Four bytes at a
          // time: (byte ^ 0x80) >> sh is m̂ + 2^(7 - sh), biased into a
          // float's mantissa; e' becomes the exponent bits of 2^e'
          const int sh = 8 - mw;
          const uint32_t lo = (0xFFu >> sh) * 0x01010101u;
          const uint32_t mb = ((w ^ 0x80808080u) >> sh) & lo;
          const uint32_t eb = w & ((1u << sh) - 1) * 0x01010101u;
          const float bias = static_cast<float>(128 >> sh);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[i][j] = biased_byte(mb, j, bias)
                      * __uint_as_float(
                          ((__byte_perm(eb, 0u, 0x4440u | j)) << 23)
                          + 0x3F800000u);
        }
      }
    }
  }
}

// The consumers' x of a split (rows 0.. 8 NT - 1, zeros past M and K),
// bf16, row pitch x_pitch bytes, in mma order within each block.
template <int NT, int D>
__device__ __forceinline__ void load_x(uint8_t* xs,
                                       const __nv_bfloat16* __restrict__ x,
                                       const Plan& p, int nb_begin,
                                       int nb_end) {
  consumer_sync();                  // every warp is done with the last x
  const int chunks = (nb_end - nb_begin) * p.B / 8, k0 = nb_begin * p.B;
  const bool vec = (p.K % 8) == 0;
  for (int i = threadIdx.x; i < 8 * NT * chunks; i += kConsumers) {
    const int m = i / chunks, kc = (i - m * chunks) * 8, k = k0 + kc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < p.M) {
      const __nv_bfloat16* src = x + static_cast<size_t>(m) * p.K + k;
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
    uint8_t* row = xs + m * p.x_pitch;
    if constexpr (mxq::fields<D>() == 1) {
      *reinterpret_cast<uint4*>(row + 2 * kc) = v;
    } else {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = kc + j, bl = kk / p.B;
        reinterpret_cast<uint16_t*>(row)[bl * p.B
                                         + kpos<D>(kk - bl * p.B, p.B)] = e[j];
      }
    }
  }
  consumer_sync();
}

template <int NT, int D>
__device__ __forceinline__ void consume(const Ring& ring, uint8_t* xs,
                                        const __nv_bfloat16* __restrict__ x,
                                        float* __restrict__ ws,
                                        const Plan& p) {
  constexpr int cb = mxq::code_bytes<D>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int c = 32 * warp + 4 * (lane >> 2);   // the thread's first column
  const int sub_i = (c * cb) / kSubW, byte = (c * cb) % kSubW;
  const int steps = p.B / 16;
  int lo, hi;
  tile_range(p.tiles, lo, hi);
  int it = 0, x_split = -1;
  for (int tt = lo; tt < hi; ++tt) {
    const int split = tt / p.col_tiles, n0 = (tt % p.col_tiles) * kTN;
    const int nb_begin = split * p.nbps;
    const int nb_end = min(p.NB, nb_begin + p.nbps);
    if (split != x_split) {
      load_x<NT, D>(xs, x, p, nb_begin, nb_end);
      x_split = split;
    }
    float sum[NT][2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum[n][mm][r] = 0.f;
    for (int nb0 = nb_begin; nb0 < nb_end; nb0 += p.sb, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.full(s), (it / ring.stages) & 1);
      const uint8_t* st = ring.stage(s);
      const uint8_t* sub = st + sub_i * p.sub_stride;
      const int nvalid = min(p.sb, nb_end - nb0);
      // one mma step: k-step ks of block b into acc
      auto kstep = [&](float (&acc)[NT][2][4], int b, int ks) {
        float v[4][4];
        decode_step<D>(sub, b * p.rows, ks, t, byte, p.B, p.mw, p.ebits, v);
        uint32_t a[2][4];
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const int j0 = 2 * mm, j1 = 2 * mm + 1;
          a[mm][0] = pack_exact(v[0][j0], v[1][j0]);
          a[mm][1] = pack_exact(v[0][j1], v[1][j1]);
          a[mm][2] = pack_exact(v[2][j0], v[3][j0]);
          a[mm][3] = pack_exact(v[2][j1], v[3][j1]);
        }
        const int kp = (nb0 - nb_begin + b) * p.B + 16 * ks;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          x_frag(xs, p.x_pitch, n, kp, b0, b1);
          mma_bf16(acc[n][0], a[0], b0, b1);
          mma_bf16(acc[n][1], a[1], b0, b1);
        }
      };
      // block b's scale a column, 2^(se - fold), times acc into the sum
      auto flush = [&](float (&acc)[NT][2][4], int b) {
        const uint32_t sw = *reinterpret_cast<const uint32_t*>(
            st + p.se_off + b * kTN + c);
        float sc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[j] = exp2_i32(static_cast<int>(static_cast<int8_t>(
                               (sw >> (8 * j)) & 0xFF)) - p.fold);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int mm = 0; mm < 2; ++mm)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              sum[n][mm][r] = fmaf(acc[n][mm][r], sc[2 * mm + (r >> 1)],
                                   sum[n][mm][r]);
              acc[n][mm][r] = 0.f;
            }
      };
      float acc[NT][2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[n][mm][r] = 0.f;
      // two k-steps in one straight run, so that one's loads and decode
      // overlap the other's: up to 16 rows of x, two blocks side by side
      // into two accumulator chains; else a block's steps in pairs into
      // its one chain. Each block's chain and its place in the sum are the
      // single steps' either way.
      if (NT <= 2) {
        float acc2[NT][2][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int mm = 0; mm < 2; ++mm)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc2[n][mm][r] = 0.f;
#pragma unroll 1
        for (int b = 0; b < nvalid; b += 2) {
          const int b2 = min(b + 1, nvalid - 1);
#pragma unroll 1
          for (int ks = 0; ks < steps; ++ks) {
            kstep(acc, b, ks);
            kstep(acc2, b2, ks);
          }
          flush(acc, b);
          if (b + 1 < nvalid) flush(acc2, b2);
        }
      } else {
#pragma unroll 1
        for (int b = 0; b < nvalid; ++b) {
#pragma unroll 1
          for (int ks = 0; ks + 1 < steps; ks += 2) {
            kstep(acc, b, ks);
            kstep(acc, b, ks + 1);
          }
          if (steps & 1) kstep(acc, b, steps - 1);
          flush(acc, b);
        }
      }
      __syncwarp();                  // the warp's reads of the stage are done
      if (lane == 0) mxq::sm90::mbar_arrive(ring.empty(s));
    }
    // d0, d1: column c + 2mm, rows 2t, 2t + 1; d2, d3: column c + 2mm + 1
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = 8 * n + 2 * t + (r & 1);
          const int col = n0 + c + 2 * mm + (r >> 1);
          if (m < p.M && col < p.N)
            ws[(static_cast<size_t>(split) * p.M + m) * p.N + col] =
                sum[n][mm][r];
        }
  }
}

template <int NT, int D>
__global__ void __launch_bounds__(kThreads, 1)
gemv_tc(const __grid_constant__ CUtensorMap codes_map,
        const __grid_constant__ CUtensorMap se_map,
        const __nv_bfloat16* __restrict__ x,
        const int8_t* __restrict__ codes, const int8_t* __restrict__ se,
        float* __restrict__ ws, const Plan p) {
  extern __shared__ uint8_t gemv_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gemv_smem) + kAlign - 1)
      & ~uintptr_t(kAlign - 1));
  const Ring ring{base + kBarBytes, mxq::sm90::smem_u32(base), p.stages,
                  p.stage_bytes};
  uint8_t* xs = base + kBarBytes + p.stages * p.stage_bytes;
  init_ring(ring, p.tma != 0);
  if (take_role())
    consume<NT, D>(ring, xs, x, ws, p);
  else if (threadIdx.x / 32 == kConsumers / 32)
    produce<mxq::code_bytes<D>()>(ring, &codes_map, &se_map, codes, se, p);
}

template <int NT, int D>
int launch(const void* x, const int8_t* codes, const int8_t* se, float* ws,
           const Plan& p, int ctas, int smem, cudaStream_t st) {
  auto kernel = gemv_tc<NT, D>;
  CUtensorMap maps[2] = {};
  const int err = ring_maps<mxq::code_bytes<D>()>(maps, codes, se, p);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, st>>>(
      maps[0], maps[1], static_cast<const __nv_bfloat16*>(x), codes, se, ws,
      p);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int D>
int occupancy(int smem, int* blocks) {
  auto kernel = gemv_tc<NT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kThreads, smem);
  return static_cast<int>(e);
}

// The entry points' work for decode D: the layout of its plan, the plan's
// checks, and the kernel for the n8 tiles of M rows.
template <int D>
int run(const void* x, const int8_t* codes, const int8_t* se, float* ws,
        Plan p, int ctas, int smem, cudaStream_t st) {
  p.rows = mxq::packed_rows<D>(p.B);
  layout<D>(p);
  if (p.sb * p.rows > 256 || smem != smem_bytes(p, n8_tiles(p.M)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n8_tiles(p.M)) {
    case 1: return launch<1, D>(x, codes, se, ws, p, ctas, smem, st);
    case 2: return launch<2, D>(x, codes, se, ws, p, ctas, smem, st);
    case 4: return launch<4, D>(x, codes, se, ws, p, ctas, smem, st);
    default: return launch<8, D>(x, codes, se, ws, p, ctas, smem, st);
  }
}

template <int D>
int occupancy_of(int M, int smem, int* blocks) {
  switch (n8_tiles(M)) {
    case 1: return occupancy<1, D>(smem, blocks);
    case 2: return occupancy<2, D>(smem, blocks);
    case 4: return occupancy<4, D>(smem, blocks);
    default: return occupancy<8, D>(smem, blocks);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// gemv_partial (the "cc" route)
// ---------------------------------------------------------------------------
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

// `case id: return FN<id>(args...);` for every mxq::Decode.
#define MXQ_DECODE_CASES(FN, ...)                                          \
  case mxq::kEmi8: return FN<mxq::kEmi8>(__VA_ARGS__);                     \
  case mxq::kInt8: return FN<mxq::kInt8>(__VA_ARGS__);                     \
  case mxq::kSb4: return FN<mxq::kSb4>(__VA_ARGS__);                       \
  case mxq::kSb2: return FN<mxq::kSb2>(__VA_ARGS__);                       \
  case mxq::kPf4: return FN<mxq::kPf4>(__VA_ARGS__);                       \
  case mxq::kPf6: return FN<mxq::kPf6>(__VA_ARGS__);                       \
  case mxq::kBf16: return FN<mxq::kBf16>(__VA_ARGS__);                     \
  case mxq::kFp16: return FN<mxq::kFp16>(__VA_ARGS__);                     \
  case mxq::kFp8E4m3: return FN<mxq::kFp8E4m3>(__VA_ARGS__);               \
  case mxq::kFp8E5m2: return FN<mxq::kFp8E5m2>(__VA_ARGS__);               \
  default: return static_cast<int>(cudaErrorInvalidValue);

namespace {
// gemv_partial's launch for decode D; the cudaError_t of the launch.
template <int D>
int run_cc(int mt, dim3 grid, size_t smem, cudaStream_t st,
           const __nv_bfloat16* x, const int8_t* codes, const int8_t* se,
           float* ws, int M, int K, int N, int NB, int B, int mw, int ebits,
           int fold, int nbps) {
  launch_partial<D>(mt, grid, smem, st, x, codes, se, ws, M, K, N, NB, B, mw,
                    ebits, fold, nbps);
  return static_cast<int>(cudaGetLastError());
}
int tc_gemv(int decode, const void* x, const int8_t* codes, const int8_t* se,
            float* ws, const tc::Plan& p, int ctas, int smem,
            cudaStream_t st) {
  switch (decode) {
    MXQ_DECODE_CASES(tc::run, x, codes, se, ws, p, ctas, smem, st)
  }
}
int tc_occupancy(int decode, int M, int smem, int* blocks) {
  switch (decode) {
    MXQ_DECODE_CASES(tc::occupancy_of, M, smem, blocks)
  }
}
int cc_gemv(int decode, int mt, dim3 grid, size_t smem, cudaStream_t st,
            const __nv_bfloat16* x, const int8_t* codes, const int8_t* se,
            float* ws, int M, int K, int N, int NB, int B, int mw, int ebits,
            int fold, int nbps) {
  switch (decode) {
    MXQ_DECODE_CASES(run_cc, mt, grid, smem, st, x, codes, se, ws, M, K, N,
                     NB, B, mw, ebits, fold, nbps)
  }
}
}  // namespace
#undef MXQ_DECODE_CASES

// x: (M, K) bf16, 16-byte aligned; codes: (NB, rows, N) in the transport's
// container (int8, or 16-bit for the bf16/fp16 containers); se: (NB, N)
// int8; ws: (ksplit, M, N) f32 scratch; out: (M, N) bf16 or f32; decode: an
// mxq::Decode; B a multiple of 16 with sb * rows <= 256. The plan (ksplit,
// nbps K-blocks a split, sb K-blocks a stage, stages, ctas, smem) is
// dequant_matmul.py::gemv_plan's; smem must be the bytes that it implies
// here. Returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for a plan or operands the kernel refuses).
extern "C" int dequant_gemv(const void* x, const void* codes, const void* se,
                            void* ws, void* out, int M, int K, int N, int NB,
                            int B, int decode, int mw, int ebits, int fold,
                            int ksplit, int nbps, int sb, int stages,
                            int ctas, int smem, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::Plan p{};
  p.M = M; p.K = K; p.N = N; p.NB = NB; p.B = B; p.mw = mw; p.ebits = ebits;
  p.fold = fold; p.ksplit = ksplit; p.nbps = nbps; p.sb = sb;
  p.stages = stages;
  p.col_tiles = (N + tc::kTN - 1) / tc::kTN;
  p.tiles = p.col_tiles * ksplit;
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.tma = N % 16 == 0 && aligned(codes) && aligned(se);
  if (M < 1 || M > 64 || B % 16 != 0 || sb < 1 || stages < 2
      || stages > tc::kMaxStages || ctas < 1 || ksplit * nbps < NB
      || nbps % sb != 0 || !aligned(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = tc_gemv(decode, x, static_cast<const int8_t*>(codes),
                          static_cast<const int8_t*>(se),
                          static_cast<float*>(ws), p, ctas, smem, st);
  if (err != 0) return err;
  return mxq::launch_split_reduce(static_cast<float*>(ws), out, M, N, N,
                                  ksplit, out_bf16, st);
}

// Blocks of gemv_tc that one SM holds at once for M rows, decode `decode`
// and smem bytes of dynamic shared memory, into *blocks. Returns the
// cudaError_t of the query.
extern "C" int dequant_gemv_occupancy(int M, int decode, int smem,
                                      void* blocks) {
  return tc_occupancy(decode, M, smem, static_cast<int*>(blocks));
}

// The "cc" route (gemv_partial): x: (M, K) bf16; codes, se, ws, out as
// above, any block; ksplit from dequant_matmul.py::gemv_ksplit.
extern "C" int dequant_gemv_cc(const void* x, const void* codes,
                               const void* se, void* ws, void* out, int M,
                               int K, int N, int NB, int B, int decode,
                               int mw, int ebits, int fold, int ksplit,
                               int out_bf16, void* stream) {
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
  const int err = cc_gemv(decode, mt, grid, smem, st, xp, cp, sp, wp, M, K,
                          N, NB, B, mw, ebits, fold, nbps);
  if (err != 0) return err;
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st);
}
