// The decode attention of one layer over a quantized KV cache, in one launch.
//
// Replaces microscopiq_tpu/ops/pallas/quant_attention.py::_chunk_kernel
// (wrapper _chunk_attention) together with what quant_attention_decode
// computes around it in XLA: the split of the live length into folded
// chunks and a residual count, the attention over the bf16 residual window
// (_residual_attention), and the flash combine with the normalisation
// (max(l, 1e-30)). 2/4/8-bit KIVI chunk codes, per-chunk per-channel K
// scales, per-token (Gh = 1) or grouped (Gh > 1) V scales, an optional
// GEAR-L rank-r correction, a per-slot length.
//
// What bounds it on the H100: bytes. The codes (half a byte an element at 4
// bits) and scales of every folded chunk are read once, for ~4 flops each
// a query row; the bound is (codes + scales + q + out) / 3.35 TB/s. What
// keeps a kernel from it is latency: a split's chunks are reduced one after
// another, each through a chain of loads, mma and shuffles.
//
// Design:
// - grid (nsplit, KVH, B). Split s takes chunks [s * cps, (s + 1) * cps)
//   of slot b, head group g, up to the slot's folded count; cps (about
//   five) and nsplit <= 32 come from (C, KVH) alone
//   (quant_attention.py::chunk_splits), so a slot's result does not depend
//   on the batch; at the Llama-3-8B decode (B = 4) the CTAs run in one wave
//   at three an SM. No clusters: the H100 holds fewer clusters of 8 CTAs at
//   once (cudaOccupancyMaxActiveClusters) than that decode needs.
// - 160 threads: four consumer warps and a copying warp. The copying warp
//   first bulk-copies q and (where the split's chunks fit the 8 slots) all
//   its chunks' K scales and offsets (contiguous), then fills a ring of up
//   to four stages, one chunk each, behind full/empty mbarriers: K and V
//   codes and the K scales by bulk copies (TMA, one arrive.expect_tx), the
//   V scales by 4-byte cp.async (their rows need not be 16-byte
//   multiples).
// - The consumers make the scaled q of every chunk of the split once, from
//   those copies, while the chunks are in flight (a longer split: each
//   chunk's from its stage, behind a barrier of the consumers).
// - Scales are folded out of the dots, so the raw codes are the mma
//   operand (integers of at most 255, exact in bf16):
//     logit[t] = sum_d (q_d ksc_d) kc[t, d] + sum_d q_d kmn_d
//     p @ V    = (p vsc) @ vc + p @ vmn          (Gh = 1)
//   with the scaled side split into two bf16 terms (hi + lo, ~2^-16
//   relative), two mma.m16n8k16 each. With grouped V scales the V codes
//   are dequantized in registers and split likewise (three mmas).
// - A consumer warp owns 16-token tiles of each chunk (tile j of a chunk
//   to warp j % 4) and keeps its own online-softmax state: S^T (tokens x
//   rep) = K (tokens x d) . QS^T in four mma chains, then O^T (d x rep) +=
//   V^T . PS^T, with P moved from the C layout of the first product to the
//   B layout of the second by movmatrix. Token order inside a tile follows
//   the packing, so a thread's codes of both products come from whole
//   bytes.
// - GEAR-L on both sides: K as q . (Q_k^T P_k) into the logits, V as
//   (p @ Q_v^T) @ P_v into O; the bases are read from device memory.
// - The warps' states (in the mma fragment layout) are merged in warp
//   order, the last split adds the residual window (q as the caller holds
//   it, f32 sums). Each split writes its (O, m, l) to a scratch row and
//   counts itself in on its (b, g) counter; the CTA that counts last
//   merges the rows in split order, writes (B, H, hd) in q's dtype, or,
//   for chunk_attention, the unnormalised (o, m, l), and resets the
//   counter, so that the next launch and every CUDA graph replay find it at
//   zero. Every order is fixed: results are the same from run to run. One
//   split writes straight from shared memory.
#include "gemv_tc.cuh"

#include <cuda_fp16.h>

namespace {

using mxq::gemv_tc::bar_wait;
using mxq::gemv_tc::mma_bf16;
using mxq::sm90::mbar_arrive;
using mxq::sm90::mbar_expect_tx;
using mxq::sm90::mbar_init;
using mxq::sm90::smem_u32;

constexpr int kWarps = 4;                     // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;     // + the copying warp
constexpr int kMaxStages = 4;
// blocks an SM must hold at once (the registers a thread may take): the
// splits' CTAs of the Llama-3-8B decode (4 x 8 x 13) in one wave
constexpr int kMinBlocks = 3;
constexpr int kMaxSplits = 32;
constexpr int kMaxSlots = 8;                  // chunks' scaled q made ahead
constexpr int kBarBytes = 128;
constexpr int kAlign = 128;
constexpr float kNegInf = -1e30f;

enum Kind { kF32 = 0, kBf16 = 1, kF16 = 2 };

__host__ __device__ constexpr int up(int v, int a) { return (v + a - 1) / a * a; }

// One ring stage, in bytes: one chunk's K codes (at 0), V codes, K scales
// and offsets, V scales and offsets.
struct Stage {
  int vq, ksc, kmn, vsc, vmn, bytes;
  __host__ __device__ Stage(int hd, int gap, int bits, int Gh) {
    const int codes = gap / (8 / bits) * hd;
    vq = codes;
    ksc = 2 * codes;
    kmn = ksc + 4 * hd;
    vsc = kmn + 4 * hd;
    vmn = vsc + up(4 * gap * Gh, 16);
    bytes = up(vmn + up(4 * gap * Gh, 16), 128);
  }
};

// Query rows of a state in the mma fragment layout: 8 or 16.
__host__ __device__ constexpr int frag_rows(int rep) { return rep > 8 ? 16 : 8; }

// Shared memory, in bytes: the barriers, q (rep rows of hd + 4 floats),
// `slots` chunks' scaled-q fragments (hi, lo bf16 pairs: hd / 16 k-steps of
// 32 lanes x 16 bytes per 8 query rows) and q . k_mn (16 floats each), q
// as the caller holds it and the slots' K scales and offsets (one bulk copy
// each),
// then the scratch: the ring while chunks stream, then the merge area (the
// warps' O in the fragment layout, their (m, l), the block's (m, l), the
// residual window's rescales and logits, the splits' weights and l).
struct Smem {
  int q, qf, qm, pre_q, pre_k, scratch, merge, total;
  __host__ __device__ Smem(int rep, int hd, int gap, int bits, int Gh,
                           int stages, int slots) {
    const int ring = stages * Stage(hd, gap, bits, Gh).bytes;
    q = kBarBytes;
    qf = q + up(4 * rep * (hd + 4), 128);
    qm = qf + slots * frag_rows(rep) * hd * 4;
    pre_q = qm + up(slots * 64, 128);          // q as it is (up to f32)
    pre_k = pre_q + up(4 * rep * hd, 128);     // the slots' k_sc, k_mn
    scratch = pre_k + 8 * slots * hd;
    merge = 4 * (kWarps * frag_rows(rep) * hd
                 + (2 * kWarps + 2 * kMaxSplits + 7) * rep + rep * gap);
    total = kAlign + scratch + (ring > merge ? ring : merge);
  }
};

// The index in a state of the mma fragment layout (consumer_state's) of
// query row qr, column d: d-tile i, query tile n, lane 4 g + t, register
// 2 dr + j, where d = 4 hw g + 2 i + dr and qr = 8 n + 2 t + j.
__device__ __forceinline__ int frag_idx(int qr, int d, int hw, int nt) {
  const int n = qr >> 3, j = qr & 1, t = (qr & 7) >> 1;
  const int g = d / (4 * hw), rem = d - 4 * hw * g, i = rem >> 1;
  return ((i * nt + n) * 32 + 4 * g + t) * 4 + 2 * (rem & 1) + j;
}

// The (query row, column) of index x of a state in the fragment layout.
__device__ __forceinline__ void frag_at(int x, int hw, int nt, int& qr,
                                        int& d) {
  const int rr = x & 3, lane = (x >> 2) & 31, n = (x >> 7) % nt;
  const int i = (x >> 7) / nt;
  qr = 8 * n + 2 * (lane & 3) + (rr & 1);
  d = 4 * hw * (lane >> 2) + 2 * i + (rr >> 1);
}

struct Args {
  const void* q;                // (B, KVH, rep, hd), q_kind
  const uint8_t* kq;            // (B, KVH, C, rows, hd)
  const float* kmn;             // (B, KVH, C, hd)
  const float* ksc;
  const uint8_t* vq;            // (B, KVH, C, rows, hd)
  const float* vmn;             // (B, KVH, C, gap, Gh)
  const float* vsc;
  const void* kp;               // (B, KVH, C, rank, hd), bf16 or f32
  const void* kqb;              // (B, C, rank, gap)
  const void* vp;
  const void* vqb;
  const int* len;               // lengths (decode) or nfull; null: len_const
  const void* res_k;            // (B, gap, KVH, hd), res_kind
  const void* res_v;
  void* out;                    // decode: (B, KVH, rep, hd) out_kind;
  float* m_out;                 // else o, m, l (B, KVH, rep[, hd]) f32
  float* l_out;
  float* ws;                    // (B, KVH, nsplit, rep hd + 2 rep (to 4))
  int* cnt;                     // (B, KVH) int32, zero between launches
  int B, KVH, C, rep, hd, gap, bits, Gh, rank, lr_f32;
  int nsplit, cps, stages, slots;
  int len_stride, len_const, decode, q_kind, res_kind, out_kind;
  float scale;
};

__device__ __forceinline__ float load_as(const void* p, size_t i, int kind) {
  if (kind == kF32) return static_cast<const float*>(p)[i];
  if (kind == kBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ void store_as(void* p, size_t i, float v,
                                         int kind) {
  if (kind == kF32)
    static_cast<float*>(p)[i] = v;
  else if (kind == kBf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<__half*>(p)[i] = __float2half(v);
}

__device__ __forceinline__ float lr_at(const void* p, size_t i, int f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// An arrive on bar once this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               ::"r"(bar) : "memory");
}

// The 8 x 8 b16 matrix of the fragment x, transposed: thread (g, t) holds
// row g, columns 2t, 2t + 1 of it.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y) : "r"(x));
  return y;
}

// Bytes 0 and 2 of u, ints in [0, 128), as a bf16 pair (byte 0 in the low
// half), exactly: 128 + v has v as its mantissa, and the subtraction is
// exact. Bytes 1 and 3 are ignored.
__device__ __forceinline__ uint32_t small_pair(uint32_t u) {
  uint32_t r = (u & 0x00FF00FFu) | 0x43004300u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&r);
  h = __hsub2(h, __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte j of w (0..255) as a float, exactly (the byte in a 2^23 mantissa).
__device__ __forceinline__ float byte_float(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | j))
         - 8388608.f;
}

// The bf16 pair (lo in the low half) of two floats that bf16 holds exactly.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// (hi, lo) bf16 pairs of two floats: hi their rounding, lo the rounding of
// what is left, so that hi + lo holds each to ~2^-16.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  const float r0 = x0 - __uint_as_float(hi << 16);
  const float r1 = x1 - __uint_as_float(hi & 0xFFFF0000u);
  __nv_bfloat162 l = __floats2bfloat162_rn(r0, r1);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// __byte_perm selector putting byte p of a in byte 0 and byte p of b in
// byte 2 (for small_pair).
__host__ __device__ constexpr uint32_t lanes(int p) {
  return static_cast<uint32_t>(p | ((4 + p) << 8));
}

// ---------------------------------------------------------------------------
// token order inside a 16-token tile: tile token j is (byte row, field)
//   8 bits: (R0 + j, 0);  4 bits: (R0 + (j & 7), j >> 3);
//   2 bits: (R0 + ((j & 7) >> 1), 2 (j >> 3) + (j & 1)),
// R0 = tile * 16 / per, token index in the chunk = row + field * rows, so
// that a thread's codes of both products come from whole bytes: tokens g
// and g + 8 (rows of S^T) share a byte at 4 and 2 bits, as do tokens 2t,
// 2t + 8 (and 2t + 1, 2t + 9 at 2 bits), the k slots of PS^T.
// ---------------------------------------------------------------------------
template <int kPer>
__device__ __forceinline__ void tile_token(int j, int R0, int rows, int& row,
                                           int& tok) {
  int f;
  if constexpr (kPer == 1) {
    row = R0 + j, f = 0;
  } else if constexpr (kPer == 2) {
    row = R0 + (j & 7), f = j >> 3;
  } else {
    row = R0 + ((j & 7) >> 1), f = 2 * (j >> 3) + (j & 1);
  }
  tok = row + f * rows;
}

// The A fragment (16 tokens x 16 permuted d) of K for k-step s of a 32-d
// block: the thread's 4 bytes (d = 32 bb + 8 t + 4 s + e) of the rows of
// tokens g and g + 8, word wg (and wg8 at 8 bits).
template <int kPer>
__device__ __forceinline__ void k_frag(uint32_t wg, uint32_t wg8, int g,
                                       uint32_t (&a)[4]) {
  if constexpr (kPer == 1) {
    a[0] = pack_exact(byte_float(wg, 0), byte_float(wg, 1));
    a[1] = pack_exact(byte_float(wg8, 0), byte_float(wg8, 1));
    a[2] = pack_exact(byte_float(wg, 2), byte_float(wg, 3));
    a[3] = pack_exact(byte_float(wg8, 2), byte_float(wg8, 3));
  } else {
    uint32_t lo, hi;
    if constexpr (kPer == 2) {
      lo = wg & 0x0F0F0F0Fu;
      hi = (wg >> 4) & 0x0F0F0F0Fu;
    } else {
      lo = (wg >> (2 * (g & 1))) & 0x03030303u;
      hi = (wg >> (4 + 2 * (g & 1))) & 0x03030303u;
    }
    a[0] = small_pair(__byte_perm(lo, 0, 0x0100u));
    a[1] = small_pair(__byte_perm(hi, 0, 0x0100u));
    a[2] = small_pair(__byte_perm(lo, 0, 0x0302u));
    a[3] = small_pair(__byte_perm(hi, 0, 0x0302u));
  }
}

// Code of PV k slot k (tile tokens 2t, 2t + 1, 2t + 8, 2t + 9) at byte p of
// the thread's words: w[i] is the word of the i-th row it loaded (8 bits:
// rows of tokens 2t, 2t+1, 2t+8, 2t+9; 4 bits: 2t, 2t+1; 2 bits: t).
template <int kPer>
__device__ __forceinline__ int v_code(const uint32_t (&w)[4], int k, int p) {
  if constexpr (kPer == 1) {
    return (w[k] >> (8 * p)) & 0xFF;
  } else if constexpr (kPer == 2) {
    return (w[k & 1] >> (8 * p + 4 * (k >> 1))) & 0xF;
  } else {
    return (w[0] >> (8 * p + 2 * k)) & 0x3;
  }
}

// The A fragment of V^T (d rows g -> byte p0, g + 8 -> p0 + 1; k slots as
// v_code) from the codes alone (the folded path).
template <int kPer>
__device__ __forceinline__ void v_frag(const uint32_t (&w)[4], int p0,
                                       uint32_t (&a)[4]) {
  const int p1 = p0 + 1;
  if constexpr (kPer == 1) {
    a[0] = pack_exact(byte_float(w[0], p0), byte_float(w[1], p0));
    a[1] = pack_exact(byte_float(w[0], p1), byte_float(w[1], p1));
    a[2] = pack_exact(byte_float(w[2], p0), byte_float(w[3], p0));
    a[3] = pack_exact(byte_float(w[2], p1), byte_float(w[3], p1));
  } else {
    uint32_t x0, x1, x2, x3;             // the fields of slots 0..3
    if constexpr (kPer == 2) {
      x0 = w[0] & 0x0F0F0F0Fu;
      x1 = w[1] & 0x0F0F0F0Fu;
      x2 = (w[0] >> 4) & 0x0F0F0F0Fu;
      x3 = (w[1] >> 4) & 0x0F0F0F0Fu;
    } else {
      x0 = w[0] & 0x03030303u;
      x1 = (w[0] >> 2) & 0x03030303u;
      x2 = (w[0] >> 4) & 0x03030303u;
      x3 = (w[0] >> 6) & 0x03030303u;
    }
    a[0] = small_pair(__byte_perm(x0, x1, lanes(p0)));
    a[1] = small_pair(__byte_perm(x0, x1, lanes(p1)));
    a[2] = small_pair(__byte_perm(x2, x3, lanes(p0)));
    a[3] = small_pair(__byte_perm(x2, x3, lanes(p1)));
  }
}

// ---------------------------------------------------------------------------
// The copying warp: chunk i of (b, g) (chunk0 + i) into stage i % stages.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void fill_stage(const Args& a, uint8_t* ring,
                                           uint32_t bars, const Stage& stg,
                                           size_t chunk0, int i) {
  const int lane = threadIdx.x & 31;
  const int codes = a.gap / (8 / a.bits) * a.hd;
  const int nv = a.gap * a.Gh;
  const int s = i % a.stages;
  const uint32_t full = bars + 8 * s;
  uint8_t* st = ring + s * stg.bytes;
  const size_t ch = chunk0 + i;
  if (lane == 0) {
    mbar_expect_tx(full, 2 * codes + 8 * a.hd);
    bulk_copy(st, a.kq + ch * codes, codes, full);
    bulk_copy(st + stg.vq, a.vq + ch * codes, codes, full);
    bulk_copy(st + stg.ksc, a.ksc + ch * a.hd, 4 * a.hd, full);
    bulk_copy(st + stg.kmn, a.kmn + ch * a.hd, 4 * a.hd, full);
  }
  for (int j = lane; j < nv; j += 32) {
    cp_async4(st + stg.vsc + 4 * j, a.vsc + ch * nv + j);
    cp_async4(st + stg.vmn + 4 * j, a.vmn + ch * nv + j);
  }
  cp_async_arrive(full);
}

// ---------------------------------------------------------------------------
// A consumer warp's online-softmax state over the tiles it owns.
// kNT n8 tiles of query rows (rep <= 8 or <= 16), kW 32-d blocks at most
// (hd <= 32 kW), kGrouped: grouped V scales.
// ---------------------------------------------------------------------------
template <int kPer, int kNT, int kW, bool kGrouped>
struct Consumer {
  float m[kNT][2], l[kNT][2], pm[kNT][2];   // query rows 8n + 2t + j
  float o[2 * kW][kNT][4];                  // O^T: d-tile, query tile

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) m[n][j] = kNegInf, l[n][j] = pm[n][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * kW; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[i][n][r] = 0.f;
  }

  // One 16-token tile of chunk `ch` (stage st, its tile index jt); qf and
  // qm the chunk's scaled-q fragments and q . k_mn (prep_q).
  __device__ __forceinline__ void tile(const Args& a, const uint8_t* st,
                                       const Stage& stg, const float* q_s,
                                       const uint4* qf, const float* qm,
                                       size_t ch, int jt) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int hd = a.hd, hw = hd / 32, rows = a.gap / kPer;
    const int R0 = jt * (16 / kPer);
    const float* vsc = reinterpret_cast<const float*>(st + stg.vsc);
    const float* vmn = reinterpret_cast<const float*>(st + stg.vmn);

    // ---- S^T = K . QS^T: tokens g, g + 8 of the tile, query rows 2t..
    int row_g, tok_g, row_g8, tok_g8;
    tile_token<kPer>(g, R0, rows, row_g, tok_g);
    tile_token<kPer>(g + 8, R0, rows, row_g8, tok_g8);
    const bool ok_g = row_g < rows, ok_g8 = row_g8 < rows;
    float s[kNT][4], sc[3][kNT][4];         // four mma chains
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[n][r] = sc[0][n][r] = sc[1][n][r] = sc[2][n][r] = 0.f;
#pragma unroll
    for (int bb = 0; bb < kW; ++bb) {
      if (bb >= hw) break;
      const int d0 = 32 * bb + 8 * t;
      uint2 kg = make_uint2(0, 0), kg8 = make_uint2(0, 0);
      if (ok_g)
        kg = *reinterpret_cast<const uint2*>(st + row_g * hd + d0);
      if (kPer == 1 && ok_g8)
        kg8 = *reinterpret_cast<const uint2*>(st + row_g8 * hd + d0);
#pragma unroll
      for (int ss = 0; ss < 2; ++ss) {
        uint32_t af[4];
        k_frag<kPer>(ss ? kg.y : kg.x, ss ? kg8.y : kg8.x, g, af);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const uint4 f = qf[(n * 2 * hw + 2 * bb + ss) * 32 + lane];
          mma_bf16(ss ? sc[1][n] : s[n], af, f.x, f.y);
          mma_bf16(sc[2 * ss][n], af, f.z, f.w);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[n][r] = (s[n][r] + sc[1][n][r]) + (sc[0][n][r] + sc[2][n][r]);
    // GEAR-L, K side: logit += sum_i q_k[i, tok] (q . P_k[i])
    if (a.rank > 0) gear_k(a, q_s, ch, tok_g, tok_g8, s);

    // ---- online softmax over the tile's tokens, query rows 8n + 2t + j
    float p[kNT][4], alpha[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float qmj = qm[8 * n + 2 * t + j];
        const float x0 = ok_g ? (s[n][j] + qmj) * a.scale : kNegInf;
        const float x1 = ok_g8 ? (s[n][2 + j] + qmj) * a.scale : kNegInf;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[n][j], mx);
        alpha[n][j] = expf(m[n][j] - m_new);
        m[n][j] = m_new;
        p[n][j] = ok_g ? expf(x0 - m_new) : 0.f;
        p[n][2 + j] = ok_g8 ? expf(x1 - m_new) : 0.f;
        l[n][j] = l[n][j] * alpha[n][j] + (p[n][j] + p[n][2 + j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2 * kW; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[i][n][r] *= alpha[n][r & 1];

    // ---- B fragments of P^T (k: tile tokens, n: query rows), hi and lo:
    // rows g (tokens g) and g + 8 of the C layout, transposed
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = p[n][r];
      if constexpr (!kGrouped) {
        // fold the per-token V scale into p, its offset into pm
        const float sg = ok_g ? vsc[tok_g] : 0.f, sg8 = ok_g8 ? vsc[tok_g8] : 0.f;
        const float mg = ok_g ? vmn[tok_g] : 0.f, mg8 = ok_g8 ? vmn[tok_g8] : 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          pm[n][j] = pm[n][j] * alpha[n][j] + (p[n][j] * mg + p[n][2 + j] * mg8);
          x[j] *= sg;
          x[2 + j] *= sg8;
        }
      }
      uint32_t h0, l0, h1, l1;
      split_pair(x[0], x[1], h0, l0);
      split_pair(x[2], x[3], h1, l1);
      bh[n][0] = transpose8x8(h0);
      bh[n][1] = transpose8x8(h1);
      bl[n][0] = transpose8x8(l0);
      bl[n][1] = transpose8x8(l1);
    }

    // ---- O^T += V^T . P^T: the thread's d range is bytes 4 hw g.. of a
    // row, d-tile i takes bytes 2i (row g) and 2i + 1 (row g + 8)
    const uint8_t* vq = st + stg.vq;
    uint32_t w[4][kW];
    int vrow[4], vtok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      tile_token<kPer>((k & 1) + 2 * t + 8 * (k >> 1), R0, rows, vrow[k],
                       vtok[k]);
    }
    constexpr int kLoads = kPer == 1 ? 4 : kPer == 2 ? 2 : 1;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          vq + vrow[k] * hd + 4 * hw * g);
#pragma unroll
      for (int ww = 0; ww < kW; ++ww)
        w[k][ww] = (ww < hw && vrow[k] < rows) ? src[ww] : 0u;
    }
#pragma unroll
    for (int i = 0; i < 2 * kW; ++i) {
      if (i >= 2 * hw) break;
      uint32_t wi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) wi[k] = w[k < kLoads ? k : 0][i >> 1];
      const int p0 = 2 * (i & 1);
      if constexpr (!kGrouped) {
        uint32_t af[4];
        v_frag<kPer>(wi, p0, af);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          mma_bf16(o[i][n], af, bh[n][0], bh[n][1]);
          mma_bf16(o[i][n], af, bl[n][0], bl[n][1]);
        }
      } else {
        // dequantize: v = code * sc + mn of the group of d, split in two
        const int vg = hd / a.Gh;
        float v[2][4];                       // [d row][k slot]
#pragma unroll
        for (int dr = 0; dr < 2; ++dr) {
          const int grp = (4 * hw * g + 2 * i + dr) / vg;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ti = vrow[k] < rows ? vtok[k] * a.Gh + grp : 0;
            v[dr][k] = static_cast<float>(v_code<kPer>(wi, k, p0 + dr))
                       * vsc[ti] + vmn[ti];
          }
        }
        uint32_t ah[4], al[4];
        split_pair(v[0][0], v[0][1], ah[0], al[0]);
        split_pair(v[1][0], v[1][1], ah[1], al[1]);
        split_pair(v[0][2], v[0][3], ah[2], al[2]);
        split_pair(v[1][2], v[1][3], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          mma_bf16(o[i][n], ah, bh[n][0], bh[n][1]);
          mma_bf16(o[i][n], al, bh[n][0], bh[n][1]);
          mma_bf16(o[i][n], ah, bl[n][0], bl[n][1]);
        }
      }
    }
    // GEAR-L, V side: O += (p @ Q_v^T) @ P_v
    if (a.rank > 0) gear_v(a, ch, tok_g, tok_g8, ok_g, ok_g8, p);
  }

  // logit (before the scale) += sum_i kqb[i, tok] * (q . kp[i]) for tokens
  // g, g + 8 and query rows 8n + 2t + j; q read as bf16, as the chunks'.
  __device__ __forceinline__ void gear_k(const Args& a, const float* q_s,
                                         size_t ch, int tok_g, int tok_g8,
                                         float (&s)[kNT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int hd = a.hd, rank = a.rank, qp = hd + 4;
    const int b = blockIdx.z, c = static_cast<int>(ch % a.C);
    const size_t qrow = (static_cast<size_t>(b) * a.C + c) * rank;
    for (int i = 0; i < rank; ++i) {
      const size_t prow = (ch * rank + i) * hd;
      float part[kNT];
#pragma unroll
      for (int n = 0; n < kNT; ++n) part[n] = 0.f;
      for (int d = 8 * t; d < hd; d += 32) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kp = lr_at(a.kp, prow + d + e, a.lr_f32);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const int r = 8 * n + g;
            if (r < a.rep) part[n] = fmaf(q_s[r * qp + d + e], kp, part[n]);
          }
        }
      }
      const float cg = lr_at(a.kqb, (qrow + i) * a.gap + tok_g % a.gap, a.lr_f32);
      const float cg8 = lr_at(a.kqb, (qrow + i) * a.gap + tok_g8 % a.gap, a.lr_f32);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        part[n] += __shfl_xor_sync(0xffffffffu, part[n], 1);
        part[n] += __shfl_xor_sync(0xffffffffu, part[n], 2);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float qpv = __shfl_sync(0xffffffffu, part[n], 4 * (2 * t + j));
          s[n][j] = fmaf(cg, qpv, s[n][j]);
          s[n][2 + j] = fmaf(cg8, qpv, s[n][2 + j]);
        }
      }
    }
  }

  // O^T[d][r] += sum_i (sum_tok p[tok][r] vqb[i, tok]) vp[i, d].
  __device__ __forceinline__ void gear_v(const Args& a, size_t ch, int tok_g,
                                         int tok_g8, bool ok_g, bool ok_g8,
                                         const float (&p)[kNT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2;
    const int hd = a.hd, hw = hd / 32, rank = a.rank;
    const int b = blockIdx.z, c = static_cast<int>(ch % a.C);
    const size_t qrow = (static_cast<size_t>(b) * a.C + c) * rank;
    for (int i = 0; i < rank; ++i) {
      const float cg = ok_g ? lr_at(a.vqb, (qrow + i) * a.gap + tok_g % a.gap,
                                    a.lr_f32) : 0.f;
      const float cg8 = ok_g8 ? lr_at(a.vqb, (qrow + i) * a.gap
                                                 + tok_g8 % a.gap, a.lr_f32)
                              : 0.f;
      float coef[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = p[n][j] * cg + p[n][2 + j] * cg8;
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          coef[n][j] = x;
        }
      const size_t prow = (ch * rank + i) * hd + 4 * hw * g;
#pragma unroll
      for (int ii = 0; ii < 2 * kW; ++ii) {
        if (ii >= 2 * hw) break;
#pragma unroll
        for (int dr = 0; dr < 2; ++dr) {
          const float vp = lr_at(a.vp, prow + 2 * ii + dr, a.lr_f32);
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              o[ii][n][2 * dr + j] = fmaf(coef[n][j], vp, o[ii][n][2 * dr + j]);
        }
      }
    }
  }
};

// Scaled q of chunks [0, nc) of the block, made once for its four consumer
// warps (128 threads): for chunk c, the B fragments of S^T = K . QS^T,
// (q_d ksc_d) for the query rows 8 n + g and the thread's d = 32 bb + 8 t
// + 4 ss + e of k-step 2 bb + ss, split into hi and lo bf16 pairs (uint4:
// hi of e 0-1, of e 2-3, lo of the same) into qf + c * stride, and qm[c *
// 16 + r] = sum_d q_d kmn_d; q_s holds q rounded to bf16 (f32 rows of hd +
// 4), as the chunks' twin reads it, ksc + c * kstride and kmn likewise
// the K scales, all in shared memory. Warp w makes the k-steps w, w + 4,
// ... of every chunk, and the q . k_mn of chunks w, w + 4, ...
template <int kNT>
__device__ __forceinline__ void prep_q(const Args& a, const float* q_s,
                                       const float* ksc, const float* kmn,
                                       int kstride, int nc, uint4* qf,
                                       int stride, float* qm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = a.hd, qp = hd + 4, steps = hd / 16;
  for (int c = 0; c < nc; ++c) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int r = 8 * n + (lane >> 2);
      for (int ks = warp; ks < steps; ks += kWarps) {
        const int d = 32 * (ks >> 1) + 8 * (lane & 3) + 4 * (ks & 1);
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < a.rep) qv = *reinterpret_cast<const float4*>(q_s + r * qp + d);
        const float4 sc =
            *reinterpret_cast<const float4*>(ksc + c * kstride + d);
        uint4 f;
        split_pair(qv.x * sc.x, qv.y * sc.y, f.x, f.z);
        split_pair(qv.z * sc.z, qv.w * sc.w, f.y, f.w);
        qf[c * stride + (n * steps + ks) * 32 + lane] = f;
      }
    }
  }
  // q . k_mn: a warp a chunk, every query row's sum side by side
  for (int c = warp; c < nc; c += kWarps) {
    float part[8 * kNT];
#pragma unroll
    for (int r = 0; r < 8 * kNT; ++r) part[r] = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float mn = kmn[c * kstride + d];
#pragma unroll
      for (int r = 0; r < 8 * kNT; ++r)
        if (r < a.rep) part[r] = fmaf(q_s[r * qp + d], mn, part[r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < 8 * kNT; ++r)
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
    if (lane < 8 * kNT) {
      float v = part[0];
#pragma unroll
      for (int r = 1; r < 8 * kNT; ++r) v = lane == r ? part[r] : v;
      qm[c * 16 + lane] = v;
    }
  }
}

// The residual window's state (q in its own dtype, f32 sums), merged into
// the block's: res_len rows of res_k, res_v. Consumers only.
template <int kNT>
__device__ __forceinline__ void residual(const Args& a, const void* q,
                                         float* O, float* m_st, float* l_st,
                                         float* tmp, int res_len) {
  constexpr int kRep = 8 * kNT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rep = a.rep, hd = a.hd, gap = a.gap;
  const int b = blockIdx.z, g = blockIdx.y;
  float* e1 = tmp;                     // rep each: the rescales, then
  float* e2 = tmp + rep;               // the logits (rep, gap)
  float* logit = tmp + 4 * rep;
  for (int tt = warp; tt < res_len; tt += kWarps) {
    const size_t krow = ((static_cast<size_t>(b) * gap + tt) * a.KVH + g) * hd;
    float part[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) part[r] = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float kv = load_as(a.res_k, krow + d, a.res_kind);
#pragma unroll
      for (int r = 0; r < kRep; ++r)
        if (r < rep)
          part[r] = fmaf(load_as(q, static_cast<size_t>(r) * hd + d, a.q_kind),
                         kv, part[r]);
    }
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      float x = part[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0 && r < rep) logit[r * gap + tt] = x * a.scale;
    }
  }
  consumer_sync();
  for (int r = warp; r < rep; r += kWarps) {
    float* lr = logit + r * gap;
    float mx = kNegInf;
    for (int tt = lane; tt < res_len; tt += 32) mx = fmaxf(mx, lr[tt]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int tt = lane; tt < res_len; tt += 32) {
      const float e = expf(lr[tt] - mx);
      lr[tt] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float M = fmaxf(m_st[r], mx);
      e1[r] = expf(m_st[r] - M);
      e2[r] = expf(mx - M);
      l_st[r] = l_st[r] * e1[r] + sum * e2[r];
      m_st[r] = M;
    }
  }
  consumer_sync();
  for (int d = tid; d < hd; d += kConsumers) {
    float acc[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) acc[r] = 0.f;
    for (int tt = 0; tt < res_len; ++tt) {
      const float vv = load_as(
          a.res_v, ((static_cast<size_t>(b) * gap + tt) * a.KVH + g) * hd + d,
          a.res_kind);
#pragma unroll
      for (int r = 0; r < kRep; ++r)
        if (r < rep) acc[r] = fmaf(logit[r * gap + tt], vv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      if (r < rep) {
        float& x = O[frag_idx(r, d, hd / 32, kNT)];
        x = x * e1[r] + acc[r] * e2[r];
      }
    }
  }
}

// The merge of ns split states (O as rep rows of hd, read a float4 at a
// time by ld_o4(s, x4); m, l (rep) by ld_m(s, r), ld_l(s, r)) in split
// order, and the output: decode: O / max(l, 1e-30) in q's dtype; else the
// unnormalised (o, m, l). The loads of every split's (m, l), and of 8
// splits' O at a time, are in flight together. Consumers only; wts holds
// 2 kMaxSplits rep + rep floats.
template <class LdO4, class LdM, class LdL>
__device__ __forceinline__ void finish(const Args& a, size_t bg, int ns,
                                       LdO4 ld_o4, LdM ld_m, LdL ld_l,
                                       float* wts) {
  const int tid = threadIdx.x, rep = a.rep, hd = a.hd;
  float* lbuf = wts + kMaxSplits * rep;
  float* l_fin = lbuf + kMaxSplits * rep;
  for (int i = tid; i < ns * rep; i += kConsumers) {
    wts[i] = ld_m(i / rep, i % rep);
    lbuf[i] = ld_l(i / rep, i % rep);
  }
  consumer_sync();
  for (int r = tid; r < rep; r += kConsumers) {
    float M = kNegInf;
    for (int sp = 0; sp < ns; ++sp) M = fmaxf(M, wts[sp * rep + r]);
    float lsum = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float w = expf(wts[sp * rep + r] - M);
      wts[sp * rep + r] = w;
      lsum = fmaf(lbuf[sp * rep + r], w, lsum);
    }
    l_fin[r] = fmaxf(lsum, 1e-30f);
    if (!a.decode) {
      a.m_out[bg * rep + r] = M;
      a.l_out[bg * rep + r] = lsum;
    }
  }
  consumer_sync();
  for (int x4 = tid; x4 < rep * hd / 4; x4 += kConsumers) {
    const int r = 4 * x4 / hd;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ns; s0 += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < ns) v[j] = ld_o4(s0 + j, x4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s0 + j < ns) {
          const float w = wts[(s0 + j) * rep + r];
          acc.x = fmaf(v[j].x, w, acc.x);
          acc.y = fmaf(v[j].y, w, acc.y);
          acc.z = fmaf(v[j].z, w, acc.z);
          acc.w = fmaf(v[j].w, w, acc.w);
        }
      }
    }
    const size_t at = bg * rep * hd + 4 * static_cast<size_t>(x4);
    if (a.decode) {
      const float inv = 1.f / l_fin[r];
      const float o4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        store_as(a.out, at + k, o4[k] * inv, a.out_kind);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) = acc;
    }
  }
}

template <int kPer, int kNT, int kW, bool kGrouped>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quant_attention(const Args a) {
  extern __shared__ uint8_t qa_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(qa_smem) + kAlign - 1)
      & ~uintptr_t(kAlign - 1));
  const Stage stg(a.hd, a.gap, a.bits, a.Gh);
  const Smem L(a.rep, a.hd, a.gap, a.bits, a.Gh, a.stages, a.slots);
  const uint32_t bars = smem_u32(base);
  float* q_s = reinterpret_cast<float*>(base + L.q);
  uint8_t* ring = base + L.scratch;
  const int rep = a.rep, hd = a.hd, gap = a.gap;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const size_t bg = static_cast<size_t>(b) * a.KVH + g;
  const int tid = threadIdx.x;

  // folded chunks and residual rows of slot b
  int len = a.len ? a.len[static_cast<size_t>(b) * a.len_stride] : a.len_const;
  len = max(len, 0);
  int nf = a.decode ? len / gap : len;
  const int res_len = a.decode ? len - nf * gap : 0;
  nf = min(nf, a.C);
  const int c0 = split * a.cps;
  const int n = max(0, min(min(c0 + a.cps, a.C), nf) - c0);

  // barriers: full(s), empty(s) of ring stage s; pre: q and the k scales
  const uint32_t pre = bars + 16 * kMaxStages;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(bars + 8 * s, 33);            // arrive.expect_tx + 32 lanes
      mbar_init(bars + 8 * (kMaxStages + s), kWarps);
    }
    mbar_init(pre, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const size_t chunk0 = bg * a.C + c0;
  const int S = a.stages;
  const bool ahead = n <= a.slots;          // every chunk's scaled q first
  uint8_t* pre_q = base + L.pre_q;
  float* pre_ksc = reinterpret_cast<float*>(base + L.pre_k);
  float* pre_kmn = pre_ksc + a.slots * hd;
  if (tid >= kConsumers) {                  // the copying warp
    if ((tid & 31) == 0) {
      const int qb = rep * hd * (a.q_kind == kF32 ? 4 : 2);
      const int kb = ahead ? 4 * n * hd : 0;
      mbar_expect_tx(pre, qb + 2 * kb);
      bulk_copy(pre_q, static_cast<const uint8_t*>(a.q) + bg * qb, qb, pre);
      if (kb > 0) {
        bulk_copy(pre_ksc, a.ksc + chunk0 * hd, kb, pre);
        bulk_copy(pre_kmn, a.kmn + chunk0 * hd, kb, pre);
      }
    }
    for (int i = 0; i < n; ++i) {
      if (i >= S)                           // chunk i - S released
        bar_wait(bars + 8 * (kMaxStages + i % S), ((i / S) & 1) ^ 1);
      fill_stage(a, ring, bars, stg, chunk0, i);
    }
    return;
  }
  // q rounded to bf16, in f32 (pre_q keeps it as the caller holds it for
  // the residual window), and (where the split's chunks fit the slots)
  // every chunk's scaled q, while the chunks are in flight
  bar_wait(pre, 0);
  for (int i = tid; i < rep * hd; i += kConsumers) {
    const int r = i / hd;
    q_s[r * (hd + 4) + i - r * hd] = bf16r(load_as(pre_q, i, a.q_kind));
  }
  consumer_sync();
  uint4* qf = reinterpret_cast<uint4*>(base + L.qf);
  float* qm = reinterpret_cast<float*>(base + L.qm);
  const int qf_stride = kNT * hd * 2;       // uint4s of one chunk's
  if (ahead) {
    prep_q<kNT>(a, q_s, pre_ksc, pre_kmn, hd, n, qf, qf_stride, qm);
    consumer_sync();
  }

  // the merge area, in floats, over the scratch once the ring is drained
  const int F = frag_rows(rep) * hd;        // a state in fragment layout
  float* O = reinterpret_cast<float*>(ring);            // warp w: + w F
  float* mw = O + kWarps * F;
  float* lw = mw + kWarps * rep;
  float* m_st = lw + kWarps * rep;
  float* l_st = m_st + rep;
  float* tmp = l_st + rep;                  // residual: 4 rep + rep gap
  float* wts = tmp + 4 * rep + rep * gap;   // weights, l: finish
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  Consumer<kPer, kNT, kW, kGrouped> cs;
  cs.init();
  const int tiles = (gap + 15) / 16;
  for (int i = 0; i < n; ++i) {
    const int s = i % a.stages;
    bar_wait(bars + 8 * s, (i / a.stages) & 1);
    const uint8_t* st = ring + s * stg.bytes;
    const int slot = ahead ? i : i & 1;
    if (!ahead) {                           // this chunk's, from the stage
      prep_q<kNT>(a, q_s, reinterpret_cast<const float*>(st + stg.ksc),
                  reinterpret_cast<const float*>(st + stg.kmn), 0, 1,
                  qf + slot * qf_stride, 0, qm + slot * 16);
      consumer_sync();                      // and chunk i - 1's tiles done
    }
    const uint4* qfi = qf + slot * qf_stride;
    const float* qmi = qm + slot * 16;
    for (int jt = warp; jt < tiles; jt += kWarps)
      cs.tile(a, st, stg, q_s, qfi, qmi, chunk0 + i, jt);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kMaxStages + s));
  }
  // the warp's state: l and pm summed over the lanes of a query row
#pragma unroll
  for (int nn = 0; nn < kNT; ++nn)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs.l[nn][j] += __shfl_xor_sync(0xffffffffu, cs.l[nn][j], o);
        cs.pm[nn][j] += __shfl_xor_sync(0xffffffffu, cs.pm[nn][j], o);
      }
    }
  consumer_sync();                          // the ring is drained
  const int hw = hd / 32;
  float4* Ow = reinterpret_cast<float4*>(O + warp * F);
#pragma unroll
  for (int i = 0; i < 2 * kW; ++i) {
    if (i >= 2 * hw) break;
#pragma unroll
    for (int nn = 0; nn < kNT; ++nn)
      Ow[(i * kNT + nn) * 32 + lane] = make_float4(
          cs.o[i][nn][0] + cs.pm[nn][0], cs.o[i][nn][1] + cs.pm[nn][1],
          cs.o[i][nn][2] + cs.pm[nn][0], cs.o[i][nn][3] + cs.pm[nn][1]);
  }
  if ((lane >> 2) == 0) {
#pragma unroll
    for (int nn = 0; nn < kNT; ++nn)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qr = 8 * nn + 2 * t + j;
        if (qr < rep) {
          mw[warp * rep + qr] = cs.m[nn][j];
          lw[warp * rep + qr] = cs.l[nn][j];
        }
      }
  }
  consumer_sync();
  // the block's state: the warps merged in warp order (O in place)
  for (int r = tid; r < rep; r += kConsumers) {
    float M = mw[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, mw[w * rep + r]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = expf(mw[w * rep + r] - M);
      wts[w * rep + r] = x;
      lsum = fmaf(lw[w * rep + r], x, lsum);
    }
    m_st[r] = M;
    l_st[r] = lsum;
  }
  consumer_sync();
  for (int x = tid; x < F; x += kConsumers) {
    int qr, d;
    frag_at(x, hw, kNT, qr, d);
    if (qr >= rep) continue;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc = fmaf(O[w * F + x], wts[w * rep + qr], acc);
    O[x] = acc;
  }
  if (split == a.nsplit - 1 && res_len > 0) {
    consumer_sync();
    residual<kNT>(a, pre_q, O, m_st, l_st, tmp, res_len);
  }
  consumer_sync();
  if (a.nsplit == 1) {
    const int hw = hd / 32;
    finish(a, bg, 1,
           [&](int, int x4) {
             const int r = 4 * x4 / hd, d = 4 * x4 - r * hd;
             return make_float4(O[frag_idx(r, d, hw, kNT)],
                                O[frag_idx(r, d + 1, hw, kNT)],
                                O[frag_idx(r, d + 2, hw, kNT)],
                                O[frag_idx(r, d + 3, hw, kNT)]);
           },
           [&](int, int r) { return m_st[r]; },
           [&](int, int r) { return l_st[r]; }, wts);
    return;
  }
  // one scratch row a split (O as rep rows of hd, then m, l); the CTA that
  // counts last merges them
  const int row = rep * hd + up(2 * rep, 4);   // 16-byte rows
  float* mine = a.ws + (bg * a.nsplit + split) * row;
  for (int x = tid; x < F; x += kConsumers) {
    int qr, d;
    frag_at(x, hd / 32, kNT, qr, d);
    if (qr < rep) mine[qr * hd + d] = O[x];
  }
  for (int r = tid; r < rep; r += kConsumers) {
    mine[rep * hd + r] = m_st[r];
    mine[rep * hd + rep + r] = l_st[r];
  }
  __threadfence();
  consumer_sync();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(a.cnt + bg, 1) == a.nsplit - 1;
  consumer_sync();
  if (!last) return;
  __threadfence();
  const float* rows0 = a.ws + bg * a.nsplit * row;
  finish(a, bg, a.nsplit,
         [&](int sp, int x4) {
           return __ldcg(reinterpret_cast<const float4*>(rows0 + sp * row)
                         + x4);
         },
         [&](int sp, int r) { return __ldcg(rows0 + sp * row + rep * hd + r); },
         [&](int sp, int r) {
           return __ldcg(rows0 + sp * row + rep * hd + rep + r);
         },
         wts);
  if (tid == 0) a.cnt[bg] = 0;
}

template <int kPer, int kNT, int kW, bool kGrouped>
cudaError_t launch(const Args& a, int smem, cudaStream_t st) {
  auto kernel = quant_attention<kPer, kNT, kW, kGrouped>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.nsplit, a.KVH, a.B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int kPer, int kNT, int kW>
cudaError_t launch_v(const Args& a, int smem, cudaStream_t st) {
  return a.Gh > 1 ? launch<kPer, kNT, kW, true>(a, smem, st)
                  : launch<kPer, kNT, kW, false>(a, smem, st);
}

template <int kPer>
cudaError_t launch_per(const Args& a, int smem, cudaStream_t st) {
  if (a.rep > 8) {
    if (a.hd > 128) return cudaErrorInvalidValue;
    return a.hd <= 64 ? launch_v<kPer, 2, 2>(a, smem, st)
                      : launch_v<kPer, 2, 4>(a, smem, st);
  }
  return a.hd <= 64    ? launch_v<kPer, 1, 2>(a, smem, st)
         : a.hd <= 128 ? launch_v<kPer, 1, 4>(a, smem, st)
                       : launch_v<kPer, 1, 8>(a, smem, st);
}

int smem_of(int rep, int hd, int gap, int bits, int Gh, int stages,
            int slots) {
  return Smem(rep, hd, gap, bits, Gh, stages, slots).total;
}

}  // namespace

// One layer's quantized decode attention (decode = 1) or the chunks'
// unnormalised flash state (decode = 0), one launch.
// q (B, KVH, rep, hd) in q_kind (0 f32, 1 bf16, 2 f16); rep <= 16, <= 8
// when hd > 128; hd a multiple of 32 up to 256. kq, vq (B, KVH, C, gap /
// per, hd) uint8 and kmn, ksc (B, KVH, C, hd) f32, 16-byte aligned; vmn,
// vsc (B, KVH, C, gap, Gh) f32; kp, vp (B, KVH, C, rank, hd) and kqb, vqb
// (B, C, rank, gap), bf16 or f32 (lr_f32), unused when rank == 0.
// decode = 1: len holds the live lengths (len_stride 1: one a slot, 0: one
// for all; null: len_const for all), res_k, res_v (B, gap, KVH, hd) in
// res_kind, out (B, KVH, rep, hd) in out_kind. decode = 0: len (B,) the
// folded chunks, out the f32 o, m_out, l_out (B, KVH, rep). nsplit <= 32
// splits of cps chunks (nsplit * cps >= C), stages <= 4 ring stages, 2 to
// 8 slots of scaled q (a split's chunks all made ahead where they fit,
// else two, each chunk's as it lands) and smem bytes as
// quant_attention_smem_bytes gives them; with nsplit > 1, ws
// (B, KVH, nsplit, rep hd + 2 rep to a multiple of 4) f32 scratch and cnt
// (B, KVH) int32
// counters, zero before the launch and zero again after it (launches that
// share them run one after another). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a plan or geometry it refuses).
extern "C" int quant_attention(
    const void* q, const void* kq, const void* kmn, const void* ksc,
    const void* vq, const void* vmn, const void* vsc, const void* kp,
    const void* kqb, const void* vp, const void* vqb, const void* len,
    const void* res_k, const void* res_v, void* out, void* m_out,
    void* l_out, void* ws, void* cnt, int B, int KVH, int C, int rep,
    int hd, int gap, int bits,
    int Gh, int rank, int lr_f32, int nsplit, int cps, int stages, int slots,
    int smem,
    int len_stride, int len_const, int decode, int q_kind, int res_kind,
    int out_kind, float scale, void* stream) {
  const int per = bits == 8 ? 1 : bits == 4 ? 2 : bits == 2 ? 4 : 0;
  if (per == 0 || gap % per || hd % 32 || hd < 32 || hd > 256 || rep < 1
      || rep > 16 || Gh < 1 || hd % Gh || nsplit < 1 || nsplit > kMaxSplits
      || cps < 1 || nsplit * cps < C || stages < 1 || stages > kMaxStages
      || slots < 2 || slots > kMaxSlots
      || smem != smem_of(rep, hd, gap, bits, Gh, stages, slots)
      || smem > mxq::sm90::kMaxSmem
      || (nsplit > 1 && (ws == nullptr || cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.kq = static_cast<const uint8_t*>(kq);
  a.kmn = static_cast<const float*>(kmn);
  a.ksc = static_cast<const float*>(ksc);
  a.vq = static_cast<const uint8_t*>(vq);
  a.vmn = static_cast<const float*>(vmn);
  a.vsc = static_cast<const float*>(vsc);
  a.kp = kp; a.kqb = kqb; a.vp = vp; a.vqb = vqb;
  a.len = static_cast<const int*>(len);
  a.res_k = res_k; a.res_v = res_v;
  a.out = out;
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.ws = static_cast<float*>(ws);
  a.cnt = static_cast<int*>(cnt);
  a.B = B; a.KVH = KVH; a.C = C; a.rep = rep; a.hd = hd; a.gap = gap;
  a.bits = bits; a.Gh = Gh; a.rank = rank; a.lr_f32 = lr_f32;
  a.nsplit = nsplit; a.cps = cps; a.stages = stages; a.slots = slots;
  a.len_stride = len_stride; a.len_const = len_const; a.decode = decode;
  a.q_kind = q_kind; a.res_kind = res_kind; a.out_kind = out_kind;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = per == 1 ? launch_per<1>(a, smem, st)
                  : per == 2 ? launch_per<2>(a, smem, st)
                             : launch_per<4>(a, smem, st);
  return static_cast<int>(e);
}

// Dynamic shared memory of one block, in bytes, with `stages` ring stages
// and `slots` chunks' scaled q.
extern "C" int quant_attention_smem_bytes(int rep, int hd, int gap, int bits,
                                          int Gh, int stages, int slots) {
  return smem_of(rep, hd, gap, bits, Gh, stages, slots);
}
