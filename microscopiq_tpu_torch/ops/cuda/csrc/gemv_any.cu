// The tensor-core GEMVs at the MX blocks that gemv_tc and gemv_s8_tc do
// not take: y = x @ dequant(W) for M <= 64 rows with the block taken at run
// time, with bf16 activations (gemv_any) and with per-token int8 ones
// (gemv_s8_any, after dequant_gemv_s8.cu's quantize_rows).
//
// Replaces, at those blocks, microscopiq_tpu/ops/pallas/dequant_matmul.py::
// _sad_kernel (wrapper dequant_matmul_sad: emi8 and emi8m, the int8
// container, sb4, sb2, the bf16 and fp16 containers, and the float8
// containers, which JAX sends to _dq_matmul_kernel or XLA) and
// ::_sad_s8_kernel (wrapper dequant_matmul_sad_s8: the int8 container, sb4
// and sb2). dequant_matmul.py::gemv_route and ::s8_route name these kernels
// ("any") at every block a packer makes that is no multiple of 16 (2, 4,
// 8, 6, 12, 20, ...), and the bf16 and fp16 containers at 208-256, whose
// gemv_tc ring does not fit. pf4 and pf6 (blocks % 16, % 32) are all
// gemv_tc's; dequant_gemv.cu's gemv_partial and dequant_gemv_s8.cu's
// s8_partial are left to blocks no packer makes and to the tests that
// force them.
//
// What bounds it on the H100, by the bound's count: bytes, as gemv_tc: at
// M = 8 the codes and the exponents (one byte a block, half the codes'
// bytes at block 2) are ~99% of the traffic. The TPU kernel's arithmetic has to hold: per block, the
// dot first, then the scale 2^(se - fold) (exp2_i32's clamp), then the add
// in f32; the tensor core never sums past one block. Folding the scale into
// a bf16 weight everywhere would overflow at the largest scales (and
// underflow float8 codes at the smallest), and W8A8 has no such weight at
// all: the bf16-x kernel folds only where that is exact (below).
//
// Design (gemv_tc.cuh's pattern: one persistent CTA an SM over (256-column
// tile, K split) tiles, 8 consumer warps, one copying warp, setmaxnreg,
// mma.sync.m16n8k16 with the weight as the 16-row operand):
// - K positions. Within a block the K rows are taken in the order of the
//   packed bytes: position pr * F + f is field f of packed row pr (K row pr
//   + f * B / F), the identity where a packed row holds one code (F = 1).
//   A block is then a contiguous run of B positions, and S positions are S
//   / F consecutive packed rows of the (NB * rows, N) codes, whatever the
//   block. x is staged in shared memory once a split in that order.
// - A ring stage is S positions (128 / code bytes packed rows: 128 for
//   one-byte codes, 64 for two-byte ones, so 256 positions for sb4 and 512
//   for sb2) in 128-byte-wide swizzled sub-tiles, and the E exponent rows
//   of the blocks those positions touch (S / B where B divides S, else at
//   most ceil((S - 1) / B) + 1), each one 2-D TMA box (plain copies where N
//   % 16 != 0). A block may straddle two stages: its sum is carried over.
// - A split is whole blocks (gemv_split's rule over blocks: ~1024 K rows,
//   ~6 tiles an SM), so no block is summed in two splits; x of a split
//   takes ceil(len / 16) * 16 positions, zeros past the split and past K.
// - Per 16-position mma step a thread decodes its A fragment once (no
//   conversion instructions, as dequant_gemv.cu's decode_step; W8A8: the
//   codes sign-extended in registers, as gemv_s8_tc) and reads x's B
//   fragments once. Each block that the step touches takes one "slice":
//   the A fragment ANDed with the mask of that block's positions (computed
//   from the slice's bounds: a few integer instructions), the mmas into the
//   block's accumulator; where the block ends, the accumulator is scaled by
//   its columns' 2^(se - fold) and added to the f32 sum, then restarts at
//   zero. A step spans j blocks in j slices: 16 / B at blocks that divide
//   16, at most two at B > 16. Masking the weight, not x, keeps a NaN or
//   inf code of another block out of a block's sum. Blocks of 1, 2 and 4
//   rows (and 8 and 16 at NT = 8) take their slices two at a time, into
//   two accumulators that start from zero (an mma with a zero C), so that
//   two mma chains run side by side: faster there on the H100, slower at
//   B = 8 below NT = 8 than the one-slice walk (scratch A/B builds).
// - The cost that bounds the walk at small blocks is per block, not per
//   byte: a slice's mask and mmas and a block's flush (4 scales, 8 NT
//   FMAs), the same for every decode; at block 2 a step is 8 of them
//   (PERF.md §6). So at blocks dividing 8 the bf16-x kernel folds a step
//   where it may: if every scale of the warp's blocks in a full step keeps
//   every decoded weight a normal bf16 (fold_range; every decode but the
//   16-bit containers, whose codes may take any value), the scales are
//   multiplied into the decoded weights, exactly (at most 8 significant
//   bits), and the step is one mma chain into the f32 sum, with no mask
//   and no flush; the other steps (extreme exponents, the clamp) walk.
//   Every product is exact either way: only the order of the f32 sums
//   differs from the walk's (and the TPU kernel's).
// - Each tile writes an f32 partial; split_reduce adds the splits in order
//   (W8A8: times the row's activation scale). The plan (stage, split)
//   depends on (decode, N, K, B) alone, never on M, so a row's result does
//   not depend on the batch. dequant_matmul.py::any_plan mirrors it; the C
//   entries refuse a plan whose shared memory differs.
//
// One kernel a decode and n8-tile count NT (1, 2, 4, 8): 8 gemv_any (32
// instantiations) and 3 gemv_s8_any (12).
#include <type_traits>

#include "gemv_tc.cuh"

namespace {

using mxq::exp2_i32;
using mxq::gemv_tc::align_up;
using mxq::gemv_tc::bar_wait;
using mxq::gemv_tc::consumer_sync;
using mxq::gemv_tc::init_ring;
using mxq::gemv_tc::kAlign;
using mxq::gemv_tc::kBarBytes;
using mxq::gemv_tc::kConsumers;
using mxq::gemv_tc::kMaxStages;
using mxq::gemv_tc::kSubW;
using mxq::gemv_tc::kThreads;
using mxq::gemv_tc::kTN;
using mxq::gemv_tc::mma_bf16;
using mxq::gemv_tc::n8_tiles;
using mxq::gemv_tc::Ring;
using mxq::gemv_tc::swz;
using mxq::gemv_tc::take_role;
using mxq::gemv_tc::tile_range;
using mxq::gemv_tc::x_frag;

// The plan (dequant_matmul.py::any_plan mirrors it).
struct Plan {
  int M, K, N, NB, B, mw, ebits, fold;
  int R;                          // packed rows a block
  int ksplit, nbps, stages, col_tiles, tiles, tma;
  int S, rows_s, E;               // positions, packed rows, exponent rows
  int sub_stride, se_off, stage_bytes, x_pitch;
};

// Stage layout of CB-byte codes, F positions a packed row, x of XB bytes:
// 2 * CB sub-tiles of 128 / CB rows of 128 bytes, each 1024-aligned, then
// E exponent rows of 256 columns; x rows of the split's positions rounded
// up to 16 (bf16) or 32 (int8) plus 16 bytes, which keeps a warp's x reads
// conflict-free.
template <int CB, int F, int XB>
__host__ __device__ inline void layout(Plan& p) {
  p.rows_s = kSubW / CB;
  p.S = p.rows_s * F;
  p.E = p.S % p.B == 0 ? p.S / p.B : (p.S + p.B - 2) / p.B + 1;
  p.sub_stride = align_up(p.rows_s * kSubW, 1024);
  p.se_off = 2 * CB * p.sub_stride;
  p.stage_bytes = p.se_off + align_up(p.E * kTN, 1024);
  p.x_pitch = XB == 2 ? align_up(p.nbps * p.B, 16) * 2 + 16
                      : align_up(p.nbps * p.B, 32) + 16;
}
__host__ __device__ inline int smem_bytes(const Plan& p, int nt) {
  return kAlign + kBarBytes + p.stages * p.stage_bytes
         + align_up(8 * nt * p.x_pitch, 128);
}

// The K row (within its block) of position j of a block of B rows.
template <int F>
__device__ __forceinline__ int krow(int j, int B) {
  return j / F + (j % F) * (B / F);
}

// The tile's split: its first block, its blocks' positions and the split.
struct Split {
  int split, n0, nb_begin, nb_end, len;
  __device__ __forceinline__ Split(int tt, const Plan& p) {
    split = tt / p.col_tiles;
    n0 = (tt % p.col_tiles) * kTN;
    nb_begin = split * p.nbps;
    nb_end = min(p.NB, nb_begin + p.nbps);
    len = (nb_end - nb_begin) * p.B;
  }
};

// The copying warp (warp 8): each tile's stages of S positions (S / F
// packed rows from the split's first one) and the E exponent rows from the
// block of the stage's first position, by TMA (p.tma) or plain copies.
template <int CB, int F>
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* codes_map,
                                        const CUtensorMap* se_map,
                                        const int8_t* __restrict__ codes,
                                        const int8_t* __restrict__ se,
                                        const Plan& p) {
  constexpr int subs = 2 * CB;
  const int lane = threadIdx.x & 31;
  const int live_rows = p.NB * p.R;
  int lo, hi;
  tile_range(p.tiles, lo, hi);
  int it = 0;
  for (int tt = lo; tt < hi; ++tt) {
    const Split sp(tt, p);
    const int q_s = sp.nb_begin * p.B;
    for (int q = 0; q < sp.len; q += p.S, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.empty(s), ((it / ring.stages) & 1) ^ 1);
      uint8_t* st = ring.stage(s);
      const int r0 = (q_s + q) / F, e0 = (q_s + q) / p.B;
      if (p.tma) {
        if (lane == 0) {
          mxq::sm90::mbar_expect_tx(ring.full(s),
                                    subs * p.rows_s * kSubW + p.E * kTN);
#pragma unroll
          for (int h = 0; h < subs; ++h)
            mxq::sm90::tma_load_2d(st + h * p.sub_stride, codes_map,
                                   sp.n0 + h * (kSubW / CB), r0,
                                   ring.full(s));
          mxq::sm90::tma_load_2d(st + p.se_off, se_map, sp.n0, e0,
                                 ring.full(s));
        }
      } else {
        // plain copies in the swizzled layout, zeros outside the weight
#pragma unroll 1
        for (int i = lane; i < subs * p.rows_s * kSubW; i += 32) {
          const int h = i / (p.rows_s * kSubW), rem = i - h * p.rows_s * kSubW;
          const int r = rem / kSubW, bt = rem % kSubW;
          const int col = sp.n0 + h * (kSubW / CB) + bt / CB;
          const int grow = r0 + r;
          st[h * p.sub_stride + swz(r, bt)] =
              (col < p.N && grow < live_rows)
                  ? codes[(static_cast<size_t>(grow) * p.N + col) * CB
                          + bt % CB]
                  : 0;
        }
#pragma unroll 1
        for (int i = lane; i < p.E * kTN; i += 32) {
          const int b = i / kTN, col = sp.n0 + i % kTN;
          st[p.se_off + i] = (e0 + b < p.NB && col < p.N)
                                 ? se[static_cast<size_t>(e0 + b) * p.N + col]
                                 : 0;
        }
        mxq::sm90::mbar_arrive(ring.full(s));
      }
    }
  }
}

// The consumers' x of a split (rows 0.. 8 NT - 1; zeros past M, past the
// split's len positions and past K), elements of XB bytes (bf16 or int8),
// in position order: position bl * B + j is K row q_s + bl * B + krow(j).
template <int NT, int F, int XB>
__device__ __forceinline__ void load_x(uint8_t* xs, const void* __restrict__ x,
                                       const Plan& p, int q_s, int len) {
  using T = typename std::conditional<XB == 2, uint16_t, uint8_t>::type;
  consumer_sync();                  // every warp is done with the last x
  const int width = align_up(len, 16);
  const T* src0 = static_cast<const T*>(x);
  constexpr int kVec = 16 / XB;     // elements of a 16-byte load
  const bool vec = F == 1 && p.K % kVec == 0 && q_s % kVec == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0;
#pragma unroll 1
  for (int m = 0; m < 8 * NT; ++m) {
    T* row = reinterpret_cast<T*>(xs + m * p.x_pitch);
    const T* src = src0 + static_cast<size_t>(m) * p.K + q_s;
    const bool live = m < p.M;
    if (vec) {
#pragma unroll 1
      for (int j = kVec * threadIdx.x; j < width; j += kVec * kConsumers) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (live && j + kVec <= len && q_s + j + kVec <= p.K) {
          v = __ldg(reinterpret_cast<const uint4*>(src + j));
        } else if (live) {
          alignas(16) T e[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            e[i] = j + i < len && q_s + j + i < p.K ? src[j + i] : T(0);
          v = *reinterpret_cast<const uint4*>(e);
        }
        *reinterpret_cast<uint4*>(row + j) = v;
      }
    } else {
      // position j = bl * B + jb, walked kConsumers at a time
      const int qb = kConsumers / p.B, rb = kConsumers - qb * p.B;
      int bl = threadIdx.x / p.B, jb = threadIdx.x - bl * p.B;
#pragma unroll 1
      for (int j = threadIdx.x; j < width; j += kConsumers) {
        const int k = bl * p.B + krow<F>(jb, p.B);
        row[j] = live && j < len && q_s + k < p.K ? src[k] : T(0);
        bl += qb;
        jb += rb;
        if (jb >= p.B) {
          jb -= p.B;
          ++bl;
        }
      }
    }
  }
  consumer_sync();
}

// ---------------------------------------------------------------------------
// Decodes (dequant_gemv.cu's, without conversion instructions)
// ---------------------------------------------------------------------------
// The 32-bit word of a packed one-byte-code row at `byte` of a sub-tile:
// the codes of the thread's 4 columns, column j in byte j.
__device__ __forceinline__ uint32_t row_word(const uint8_t* sub, int row,
                                             int byte) {
  return *reinterpret_cast<const uint32_t*>(sub + swz(row, byte));
}

// Byte j of u (an unsigned field value plus `bias`) as the f32 of the
// field value: the byte placed in a 2^23 float's mantissa, less 2^23 + bias.
__device__ __forceinline__ float biased_byte(uint32_t u, int j, float bias) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j))
         - (8388608.f + bias);
}

// A bf16 pair (lo in the low half) of two floats that bf16 holds exactly:
// their upper halves.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// v[i][j]: the decoded weight of the thread's column j at position 16s +
// 2t + (i & 1) + 8 (i >> 1) of the stage, exact in bf16:
// - one code a row: packed row 16s + 2t + (i & 1) + 8 (i >> 1);
// - sb4: field i & 1 of packed row 8s + t + 4 (i >> 1);
// - sb2: field 2 (t & 1) + (i & 1) of packed row 4s + 2 (i >> 1) + t / 2.
template <int D>
__device__ __forceinline__ void decode_step(const uint8_t* sub, int s, int t,
                                            int byte, int mw,
                                            float (&v)[4][4]) {
  if constexpr (D == mxq::kSb2) {
    const int f0 = 2 * (t & 1);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t w = row_word(sub, 4 * s + 2 * q + (t >> 1), byte);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t u = ((w >> (2 * (f0 + h))) & 0x03030303u) ^ 0x02020202u;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[2 * q + h][j] = biased_byte(u, j, 2.f);
      }
    }
  } else if constexpr (D == mxq::kSb4) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t w = row_word(sub, 8 * s + t + 4 * q, byte);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t nib = ((w >> (4 * h)) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[2 * q + h][j] = biased_byte(nib, j, 8.f);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * s + 2 * t + (i & 1) + 8 * (i >> 1);
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
          int c[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            c[j] = static_cast<int8_t>((w >> (8 * j)) & 0xFF);
          mxq::decode_fp8<D, 4>(c, v[i]);
        } else if constexpr (D == mxq::kInt8) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[i][j] = biased_byte(w ^ 0x80808080u, j, 128.f);
        } else {
          // emi8: m̂ · 2^e', the byte (m̂ << sh) | e'
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

// Field f of every byte of p, sign-extended to a byte (int8 container: p).
template <int D>
__device__ __forceinline__ uint32_t field_bytes(uint32_t p, int f) {
  if constexpr (D == mxq::kInt8) {
    return p;
  } else {
    constexpr int bits = D == mxq::kSb4 ? 4 : 2;
    constexpr unsigned mask = D == mxq::kSb4 ? 0x0F0F0F0Fu : 0x03030303u;
    constexpr unsigned sign = D == mxq::kSb4 ? 0x08080808u : 0x02020202u;
    const unsigned v = (p >> (bits * f)) & mask;
    return __vsub4(v ^ sign, sign);
  }
}

// w[j]: column j's 4 int8 weights at positions 16s + 4t + e of the stage
// (byte e): the int8 container's rows 16s + 4t + e; sb4's fields e & 1 of
// rows 8s + 2t + (e >> 1); sb2's fields e of row 4s + t.
template <int D>
__device__ __forceinline__ void step_words(const uint8_t* sub, int s, int t,
                                           int byte, uint32_t (&w)[4]) {
  constexpr int F = mxq::fields<D>();
  if constexpr (F == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = row_word(sub, 16 * s + 4 * t + e, byte);
  } else if constexpr (F == 2) {
    const uint32_t w0 = row_word(sub, 8 * s + 2 * t, byte);
    const uint32_t w1 = row_word(sub, 8 * s + 2 * t + 1, byte);
    w[0] = field_bytes<D>(w0, 0);
    w[1] = field_bytes<D>(w0, 1);
    w[2] = field_bytes<D>(w1, 0);
    w[3] = field_bytes<D>(w1, 1);
  } else {
    const uint32_t w0 = row_word(sub, 4 * s + t, byte);
#pragma unroll
    for (int f = 0; f < 4; ++f) w[f] = field_bytes<D>(w0, f);
  }
  // 4 x 4 byte transpose: w[r] held row r's bytes of columns 0..3; now
  // w[c] holds column c's bytes of rows 0..3 (row 0 in the low byte)
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// d (16 x 8 s32) += a (16 x 16 s8) . b (16 x 8 s8); thread (g, t) holds
// a0: (row g, k 4t..4t + 3), a1: (row g + 8, the same), b0: (k 4t..; g).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The positions [lo, hi) of a step as a 16-bit set.
__device__ __forceinline__ uint32_t slice_bits(int lo, int hi) {
  return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// ---------------------------------------------------------------------------
// The consumers: one loop for both kernels
// ---------------------------------------------------------------------------
// d (16 x 8 f32) = a . b (mma_bf16 with a zero accumulator: no moves).
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
__device__ __forceinline__ void mma_s8_first(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0));
}

// f32 of an int |v| < 2^22, exactly, by the 1.5 * 2^23 bias (a W8A8 block
// sum: |v| <= 256 * 127 * 127).
__device__ __forceinline__ float small_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.f;
}

// The scale exponents e (2^e = 2^(se - fold) unclamped) for which every
// decoded value of D times 2^e is a normal bf16, so exact (every decoded
// value has at most 8 significant bits): [lo, hi], from the largest
// magnitude 2^vmax (hi = 127 - vmax) and the smallest nonzero one 2^vmin
// (lo = -126 - vmin). emi8's magnitudes reach 2^(6 - sh + 2^sh), sh = 8 -
// mw; the bf16 and fp16 containers hold any value and fold none.
template <int D>
__device__ __forceinline__ void fold_range(int mw, int& lo, int& hi) {
  lo = -126;
  if constexpr (D == mxq::kInt8) {
    hi = 127 - 7;
  } else if constexpr (D == mxq::kSb4) {
    hi = 127 - 3;
  } else if constexpr (D == mxq::kSb2) {
    hi = 127 - 1;
  } else if constexpr (D == mxq::kFp8E4m3) {
    lo = -126 + 9;
    hi = 127 - 8;
  } else if constexpr (D == mxq::kFp8E5m2) {
    lo = -126 + 16;
    hi = 127 - 15;
  } else {
    const int sh = 8 - mw;
    hi = 127 - (6 - sh + (1 << sh));
  }
}

// Whether the 4 exponent bytes of sw (biased: b = se + 128) all lie in
// [n_lo, n_hi] (n_lo in 1..128, n_hi in 127..254): no byte below n_lo and
// none of ~b below 255 - n_hi (bytewise borrow tests, exact for bounds of
// at most 128).
__device__ __forceinline__ bool bytes_within(uint32_t b, uint32_t lo4,
                                             uint32_t hi4) {
  const uint32_t c = ~b;
  return ((((b - lo4) & ~b) | ((c - hi4) & ~c)) & 0x80808080u) == 0;
}

// S8 false: bf16 x, f32 accumulators; true: int8 x, s32 accumulators.
template <int NT, int D, bool S8>
__device__ __forceinline__ void consume(const Ring& ring, uint8_t* xs,
                                        const void* __restrict__ x,
                                        float* __restrict__ ws,
                                        const Plan& p) {
  using Acc = typename std::conditional<S8, int, float>::type;
  constexpr int cb = mxq::code_bytes<D>(), F = mxq::fields<D>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int c = 32 * warp + 4 * (lane >> 2);   // the thread's first column
  const int sub_i = (c * cb) / kSubW, byte = (c * cb) % kSubW;
  // blocks that divide the mma step: every slice is one whole block, in
  // pairs into zero accumulators (B <= 4, and B = 8, 16 at NT = 8, where
  // that was faster on the H100 than the general walk below)
  const bool whole =
      p.B <= 16 && 16 % p.B == 0 && (p.B <= 4 || NT == 8);
  // the folded steps (bf16 x; blocks dividing 8, so that the thread's
  // positions 2t, 2t + 1 share a block at B >= 2 and no block leaves its
  // step): where every scale of the warp's blocks in the step keeps its
  // weights normal bf16 (fold_range, unclamped), the scales are folded into
  // the decoded weights (exact) and the step is one mma chain into the
  // sum, no mask and no flush; else the step takes the walk below. The
  // byte bounds of bytes_within, and the bias that turns b = se + 128 into
  // the scale's exponent field, b - (fold + 1); fold < 0 or bounds out of
  // the tests' range take the walk everywhere.
  int f_lo = 0, f_hi = 0;
  if constexpr (!S8) fold_range<D>(p.mw, f_lo, f_hi);
  const int n_lo = max(0, f_lo + p.fold + 128);
  const int n_hi = min(255, f_hi + p.fold + 128);
  const bool fold_any = p.B <= 8 && 8 % p.B == 0 && p.fold >= 0
                        && n_lo <= 128 && n_hi >= 127;
  const uint32_t lo4 = static_cast<uint32_t>(n_lo) * 0x01010101u;
  const uint32_t hi4 = static_cast<uint32_t>(255 - n_hi) * 0x01010101u;
  const uint32_t bias4 = static_cast<uint32_t>(p.fold + 1) * 0x01010101u;
  int lb = 0;                        // log2(B) where B divides 8
  while ((1 << lb) < p.B) ++lb;
  int lo, hi;
  tile_range(p.tiles, lo, hi);
  int it = 0, x_split = -1;
  for (int tt = lo; tt < hi; ++tt) {
    const Split sp(tt, p);
    if (sp.split != x_split) {
      load_x<NT, F, S8 ? 1 : 2>(xs, x, p, sp.nb_begin * p.B, sp.len);
      x_split = sp.split;
    }
    float sum[NT][2][4];
    Acc acc[NT][2][4], acc2[NT][2][4];   // acc2: a whole pair's second
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sum[n][mm][r] = 0.f;
          acc[n][mm][r] = 0;
        }
    int blk = sp.nb_begin, end = p.B;  // the open block and its end position
    for (int q = 0; q < sp.len; q += p.S, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.full(s), (it / ring.stages) & 1);
      const uint8_t* st = ring.stage(s);
      const uint8_t* sub = st + sub_i * p.sub_stride;
      const uint8_t* se_st = st + p.se_off + c;
      const int e0 = blk;                  // the stage's first exponent row
      const int steps = (min(p.S, sp.len - q) + 15) / 16;
      // block b's scale a column, 2^(se - fold), times its sums in a
      // into the f32 sum
      auto flush_to = [&](Acc (&a)[NT][2][4], int b) {
        const uint32_t sw =
            *reinterpret_cast<const uint32_t*>(se_st + (b - e0) * kTN);
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
              float v;
              if constexpr (S8)
                v = small_float(a[n][mm][r]);
              else
                v = a[n][mm][r];
              sum[n][mm][r] = fmaf(v, sc[2 * mm + (r >> 1)], sum[n][mm][r]);
            }
      };
      auto flush = [&]() { flush_to(acc, blk); };
      // the stage's steps; FOLD: with the folded steps (a kernel whose
      // block and decode take none compiles its walk without them)
      auto run_steps = [&](auto fold_c) {
        constexpr bool kFold = decltype(fold_c)::value;
#pragma unroll 1
        for (int ss = 0; ss < steps; ++ss) {
          const int k = q + 16 * ss;        // the step's first position
          uint32_t a4[4], xb[NT][2];        // S8: the 4 columns' words
          uint32_t af[2][4];                // bf16: the two mmas' A fragments
          bool folded = false;              // bf16: a folded step
          if constexpr (S8) {
            step_words<D>(sub, ss, t, byte, a4);
#pragma unroll
            for (int n = 0; n < NT; ++n)
              xb[n][0] = *reinterpret_cast<const uint32_t*>(
                  xs + (8 * n + (lane >> 2)) * p.x_pitch + k + 4 * t);
          } else {
            float v[4][4];
            decode_step<D>(sub, ss, t, byte, p.mw, v);
            if (kFold && sp.len - k >= 16) {
              // the exponent words of the blocks of positions 2t (i = 0, 1
              // at B >= 2) and 2t + 8 (i = 2, 3), and at B = 1 of 2t + 1
              // and 2t + 9, biased: b = se + 128
              auto word = [&](int pos) {
                return *reinterpret_cast<const uint32_t*>(
                           se_st + (blk - e0 + (pos >> lb)) * kTN)
                       ^ 0x80808080u;
              };
              uint32_t bw[4];
              bw[0] = word(2 * t);
              bw[2] = word(2 * t + 8);
              bw[1] = p.B == 1 ? word(2 * t + 1) : bw[0];
              bw[3] = p.B == 1 ? word(2 * t + 9) : bw[2];
              const bool ok = bytes_within(bw[0], lo4, hi4)
                              && bytes_within(bw[2], lo4, hi4)
                              && (p.B > 1 || (bytes_within(bw[1], lo4, hi4)
                                              && bytes_within(bw[3], lo4, hi4)));
              folded = __all_sync(0xffffffffu, ok);
              if (folded) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const uint32_t e = bw[i] - bias4;    // se - fold + 127
#pragma unroll
                  for (int j = 0; j < 4; ++j)
                    v[i][j] *= __uint_as_float(
                        __byte_perm(e, 0u, 0x0444u | (j << 12)) >> 1);
                }
              }
            }
#pragma unroll
            for (int mm = 0; mm < 2; ++mm) {
              const int j0 = 2 * mm, j1 = 2 * mm + 1;
              af[mm][0] = pack_exact(v[0][j0], v[1][j0]);
              af[mm][1] = pack_exact(v[0][j1], v[1][j1]);
              af[mm][2] = pack_exact(v[2][j0], v[3][j0]);
              af[mm][3] = pack_exact(v[2][j1], v[3][j1]);
            }
#pragma unroll
            for (int n = 0; n < NT; ++n)
              x_frag(xs, p.x_pitch, n, k, xb[n][0], xb[n][1]);
          }
          if (folded) {
            // the folded weights of the step's 16 / B blocks, into the sum
#pragma unroll
            for (int mm = 0; mm < 2; ++mm)
#pragma unroll
              for (int n = 0; n < NT; ++n)
                mma_bf16(sum[n][mm], af[mm], xb[n][0], xb[n][1]);
            blk += 16 >> lb;
            end += 16;
            continue;
          }
          // the mmas of the step's positions [from, to) into acc; FIRST: the
          // block's first, into a zero accumulator
          auto slice = [&](Acc (&a)[NT][2][4], int from, int to, auto first_c) {
            constexpr bool kFirst = decltype(first_c)::value;
            const uint32_t bits = slice_bits(from, to);
            if constexpr (S8) {
              const uint32_t nib = (bits >> (4 * t)) & 0xFu;
              const uint32_t m = ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                if constexpr (kFirst) {
                  mma_s8_first(a[n][0], a4[0] & m, a4[1] & m, xb[n][0]);
                  mma_s8_first(a[n][1], a4[2] & m, a4[3] & m, xb[n][0]);
                } else {
                  mma_s8(a[n][0], a4[0] & m, a4[1] & m, xb[n][0]);
                  mma_s8(a[n][1], a4[2] & m, a4[3] & m, xb[n][0]);
                }
              }
            } else {
              const uint32_t b01 = (bits >> (2 * t)) & 3u;
              const uint32_t b89 = (bits >> (2 * t + 8)) & 3u;
              const uint32_t m01 =
                  (b01 & 1u) * 0xFFFFu | (b01 >> 1) * 0xFFFF0000u;
              const uint32_t m89 =
                  (b89 & 1u) * 0xFFFFu | (b89 >> 1) * 0xFFFF0000u;
#pragma unroll
              for (int mm = 0; mm < 2; ++mm) {
                const uint32_t am[4] = {af[mm][0] & m01, af[mm][1] & m01,
                                        af[mm][2] & m89, af[mm][3] & m89};
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                  if constexpr (kFirst)
                    mma_bf16_first(a[n][mm], am, xb[n][0], xb[n][1]);
                  else
                    mma_bf16(a[n][mm], am, xb[n][0], xb[n][1]);
                }
              }
            }
          };
          if (whole) {
            // whole blocks, two at a time into two accumulators (their mmas
            // side by side, then their flushes in block order); at NT = 8
            // one at a time (two sets would not fit the registers)
            constexpr int kPair = NT <= 4 ? 2 : 1;
            const int nblk = min(16, sp.len - k) / p.B;
#pragma unroll 1
            for (int j = 0; j < nblk; j += kPair) {
              slice(acc, j * p.B, (j + 1) * p.B, std::true_type());
              if (kPair == 2 && j + 1 < nblk)
                slice(acc2, (j + 1) * p.B, (j + 2) * p.B, std::true_type());
              flush_to(acc, blk);
              if (kPair == 2 && j + 1 < nblk) flush_to(acc2, blk + 1);
              blk += min(kPair, nblk - j);
            }
            continue;
          }
          // one slice a block that the step touches
          int from = 0;
#pragma unroll 1
          while (true) {
            const int to = min(16, end - k);
            slice(acc, from, to, std::false_type());
            if (end - k > 16) break;        // the block goes on past the step
            flush();
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int mm = 0; mm < 2; ++mm)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[n][mm][r] = 0;
            ++blk;
            end += p.B;
            if (to == 16 || blk == sp.nb_end) break;
            from = to;
          }
        }
      };
      if constexpr (!S8 && D != mxq::kBf16 && D != mxq::kFp16) {
        if (fold_any)
          run_steps(std::true_type());
        else
          run_steps(std::false_type());
      } else {
        run_steps(std::false_type());
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
          const int col = sp.n0 + c + 2 * mm + (r >> 1);
          if (m < p.M && col < p.N)
            ws[(static_cast<size_t>(sp.split) * p.M + m) * p.N + col] =
                sum[n][mm][r];
        }
  }
}

template <int NT, int D, bool S8>
__global__ void __launch_bounds__(kThreads, 1)
gemv_any(const __grid_constant__ CUtensorMap codes_map,
         const __grid_constant__ CUtensorMap se_map,
         const void* __restrict__ x, const int8_t* __restrict__ codes,
         const int8_t* __restrict__ se, float* __restrict__ ws,
         const Plan p) {
  extern __shared__ uint8_t any_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(any_smem) + kAlign - 1)
      & ~uintptr_t(kAlign - 1));
  const Ring ring{base + kBarBytes, mxq::sm90::smem_u32(base), p.stages,
                  p.stage_bytes};
  uint8_t* xs = base + kBarBytes + p.stages * p.stage_bytes;
  init_ring(ring, p.tma != 0);
  if (take_role())
    consume<NT, D, S8>(ring, xs, x, ws, p);
  else if (threadIdx.x / 32 == kConsumers / 32)
    produce<mxq::code_bytes<D>(), mxq::fields<D>()>(ring, &codes_map,
                                                     &se_map, codes, se, p);
}

template <int NT, int D, bool S8>
int launch(const void* x, const int8_t* codes, const int8_t* se, float* ws,
           const Plan& p, int ctas, int smem, cudaStream_t st) {
  constexpr int CB = mxq::code_bytes<D>();
  auto kernel = gemv_any<NT, D, S8>;
  CUtensorMap maps[2] = {};
  if (p.tma) {
    int err = mxq::sm90::tensor_map_2d(
        &maps[0],
        CB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : CU_TENSOR_MAP_DATA_TYPE_UINT16,
        CB, codes, p.N, static_cast<long long>(p.NB) * p.R, kSubW / CB,
        p.rows_s, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = mxq::sm90::raw_tensor_map(&maps[1], se, 1, p.N, p.NB, kTN, p.E);
    if (err != 0) return err;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, st>>>(maps[0], maps[1], x, codes, se, ws,
                                       p);
  return static_cast<int>(cudaGetLastError());
}

// The layout of decode D's plan, its checks (a block of whole packed rows,
// at most 256 exponent rows a stage, the caller's shared memory), and the
// kernel for the n8 tiles of M rows.
template <int D, bool S8>
int run(const void* x, const int8_t* codes, const int8_t* se, float* ws,
        Plan p, int ctas, int smem, cudaStream_t st) {
  constexpr int F = mxq::fields<D>();
  if (p.B % F != 0) return static_cast<int>(cudaErrorInvalidValue);
  p.R = mxq::packed_rows<D>(p.B);
  layout<mxq::code_bytes<D>(), F, S8 ? 1 : 2>(p);
  if (p.E > 256 || smem != smem_bytes(p, n8_tiles(p.M)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n8_tiles(p.M)) {
    case 1: return launch<1, D, S8>(x, codes, se, ws, p, ctas, smem, st);
    case 2: return launch<2, D, S8>(x, codes, se, ws, p, ctas, smem, st);
    case 4: return launch<4, D, S8>(x, codes, se, ws, p, ctas, smem, st);
    default: return launch<8, D, S8>(x, codes, se, ws, p, ctas, smem, st);
  }
}

// The plan's common fields and checks; false for one the kernels refuse.
bool make_plan(Plan& p, const void* codes, const void* se,
               int M, int K, int N, int NB, int B, int fold, int ksplit,
               int nbps, int stages, int ctas) {
  p.M = M; p.K = K; p.N = N; p.NB = NB; p.B = B; p.fold = fold;
  p.ksplit = ksplit; p.nbps = nbps; p.stages = stages;
  p.col_tiles = (N + kTN - 1) / kTN;
  p.tiles = p.col_tiles * ksplit;
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.tma = N % 16 == 0 && aligned(codes) && aligned(se);
  return M >= 1 && M <= 64 && B >= 1 && nbps >= 1 && stages >= 2
         && stages <= kMaxStages && ctas >= 1 && ksplit * nbps >= NB
         && (ksplit - 1) * nbps < NB;
}

}  // namespace

// x: (M, K) bf16; codes: (NB, rows, N) in the transport's
// container (int8, or 16-bit for the bf16/fp16 containers); se: (NB, N)
// int8; ws: (ksplit, M, N) f32 scratch; out: (M, N) bf16 or f32; decode: an
// mxq::Decode other than pf4 and pf6; any block B >= 1 of whole packed
// rows. The plan (ksplit, nbps blocks a split, stages, ctas, smem) is
// dequant_matmul.py::any_plan's; smem must be the bytes that it implies
// here. Returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for a plan or operands the kernel refuses).
extern "C" int dequant_gemv_any(const void* x, const void* codes,
                                const void* se, void* ws, void* out, int M,
                                int K, int N, int NB, int B, int decode,
                                int mw, int ebits, int fold, int ksplit,
                                int nbps, int stages, int ctas, int smem,
                                int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p{};
  if (!make_plan(p, codes, se, M, K, N, NB, B, fold, ksplit, nbps,
                 stages, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  p.mw = mw;
  p.ebits = ebits;
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* wp = static_cast<float*>(ws);
  int err;
  switch (decode) {
    case mxq::kEmi8:
      err = run<mxq::kEmi8, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kInt8:
      err = run<mxq::kInt8, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kSb4:
      err = run<mxq::kSb4, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kSb2:
      err = run<mxq::kSb2, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kBf16:
      err = run<mxq::kBf16, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kFp16:
      err = run<mxq::kFp16, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kFp8E4m3:
      err = run<mxq::kFp8E4m3, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kFp8E5m2:
      err = run<mxq::kFp8E5m2, false>(x, cp, sp, wp, p, ctas, smem, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st);
}

// The W8A8 route: xq (M, K) int8 and xscale (M,) f32 from quantize_x_int8,
// codes, se, ws, out as for dequant_gemv_any; decode mxq::kInt8, kSb4 or
// kSb2 at any block of whole packed rows; the plan is any_plan's with int8
// x. Returns the cudaError_t of the launches.
extern "C" int dequant_gemv_s8_any(const void* xq, const void* xscale,
                                   const void* codes, const void* se,
                                   void* ws, void* out, int M, int K, int N,
                                   int NB, int B, int decode, int fold,
                                   int ksplit, int nbps, int stages, int ctas,
                                   int smem, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p{};
  if (!make_plan(p, codes, se, M, K, N, NB, B, fold, ksplit, nbps,
                 stages, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* wp = static_cast<float*>(ws);
  int err;
  switch (decode) {
    case mxq::kInt8:
      err = run<mxq::kInt8, true>(xq, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kSb4:
      err = run<mxq::kSb4, true>(xq, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kSb2:
      err = run<mxq::kSb2, true>(xq, cp, sp, wp, p, ctas, smem, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st,
                                  static_cast<const float*>(xscale));
}
