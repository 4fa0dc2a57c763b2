// W8A8 scale-after-dot GEMV: y = xscale * (xq @ dequant(W)) for M <= 64
// rows, with per-token int8 activations xq and integer MX weight codes, and
// the one-launch quantizer of those activations.
//
// Replaces microscopiq_tpu/ops/pallas/dequant_matmul.py::_sad_s8_kernel
// (wrapper dequant_matmul_sad_s8), and quantize_activations_int8 (XLA
// there) by quantize_rows. It takes the int weight transports of the
// serving path: the int8 container and sb4, and sb2, which it decodes in
// the kernel (the TPU wrapper unpacks sb2 into an int8 copy first; the s32
// block sums are exact, so the result is the same).
//
// What bounds it on the H100: bytes, as the bf16-activation GEMV: the codes
// (1, 1/2 or 1/4 byte a weight) and the exponents are ~99% of the traffic at
// M = 8, and each weight byte feeds at most 16*M integer operations.
//
// Two kernels, chosen before the launch by dequant_matmul.py::s8_route:
//
// gemv_s8_tc (blocks that are a multiple of 16 whose ring fits: every
// block a packer makes for these transports), planned by
// dequant_matmul.py::s8_gemv_plan, on gemv_tc.cuh's pattern:
// - one persistent CTA an SM walks its (256-column tile, K split) tiles;
//   warp 8 keeps a TMA ring of packed code rows (128-byte swizzled
//   sub-tiles) and exponent rows in flight (plain copies where N % 16 != 0);
//   setmaxnreg moves registers from the copiers to the 8 consumer warps.
// - xq (M rows padded to 8, 16, 32 or 64, the split's K) is staged in
//   shared memory as int8, its K order permuted within each 16-row mma
//   step to the order in which a thread's codes arrive (the int8
//   container: natural order).
// - The dot is mma.sync.m16n8k16.s32.s8.s8.s32, the weight as the 16-row
//   operand: thread (g, t) reads one 4-byte word (4 columns) of each of
//   the packed rows its K positions name, sign-extends sb4 and sb2 fields
//   four at a time (SWAR), and a 4 x 4 byte transpose (prmt) turns the 4
//   words into one word of 4 K values a column; the int8 container's codes
//   go in as they are. No decode to float at all.
// - Per K-block the s32 sums (|sum| <= B * 127 * 127 < 2^24, exact in f32)
//   are scaled by 2^(se - fold) and added to the f32 sum, as the TPU kernel
//   scales its s32 block partials; each tile writes an f32 partial and
//   split_reduce adds the splits in order and applies xscale. The plan
//   depends only on the weight's shape, so a row's result does not depend
//   on M.
//
// s8_partial (other blocks, the "cc" route, CUDA cores): a thread owns 4
// neighbouring columns, K is split over blocks by the shape-only rule of
// dequant_gemv.cu's gemv_partial; per group of 4 packed rows a 4 x 4 byte
// transpose feeds __dp4a, and the s32 block sum is scaled likewise.
//
// quantize_rows: one block a row, amax by a block reduction, then
// clamp(rint(x / (max(amax, 1e-30) / 127)), -127, 127): IEEE division and
// round half to even, bit for bit as the JAX function.
#include "gemv_tc.cuh"

namespace {

using mxq::exp2_i32;

constexpr int kThreads = 128;
constexpr int kCols = 4;                      // columns per thread
constexpr int kTileN = kThreads * kCols;      // columns per block
constexpr int kChunkBlocks = 8;               // K-blocks of x staged at once

// 4 bytes of one packed row at columns col0..col0+3 (0 past N), column col0
// in the low byte.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ row,
                                         int col0, int N, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const int*>(row + col0));
  int w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col0 + j < N)
      w |= (static_cast<int>(__ldg(row + col0 + j)) & 0xFF) << (8 * j);
  return w;
}

// Field f of every byte of p, sign-extended to a byte (int8 container: p).
template <int D>
__device__ __forceinline__ int field_bytes(int p, int f) {
  if constexpr (D == mxq::kInt8) {
    return p;
  } else {
    constexpr int bits = D == mxq::kSb4 ? 4 : 2;
    constexpr unsigned mask = D == mxq::kSb4 ? 0x0F0F0F0Fu : 0x03030303u;
    constexpr unsigned sign = D == mxq::kSb4 ? 0x08080808u : 0x02020202u;
    const unsigned v = (static_cast<unsigned>(p) >> (bits * f)) & mask;
    return static_cast<int>(__vsub4(v ^ sign, sign));
  }
}

// a[r] holds row r's bytes for columns 0..3; on return a[c] holds column
// c's bytes for rows 0..3 (row 0 in the low byte).
__device__ __forceinline__ void transpose4x4(int a[4]) {
  const unsigned lo01 = __byte_perm(a[0], a[1], 0x5140);
  const unsigned hi01 = __byte_perm(a[0], a[1], 0x7362);
  const unsigned lo23 = __byte_perm(a[2], a[3], 0x5140);
  const unsigned hi23 = __byte_perm(a[2], a[3], 0x7362);
  a[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  a[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  a[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  a[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

// grid: (ceil(N / kTileN), ksplit, ceil(M / MT)); dynamic shared memory
// holds MT x (kChunkBlocks * B / 4) words of xq.
template <int MT, int D>
__global__ void __launch_bounds__(kThreads)
s8_partial(const int8_t* __restrict__ xq, const int8_t* __restrict__ codes,
           const int8_t* __restrict__ se, float* __restrict__ ws, int M,
           int K, int N, int NB, int B, int fold, int nb_per_split) {
  constexpr int F = mxq::fields<D>();
  extern __shared__ int xw[];
  const int per = B / F;                      // packed rows a block
  const int col0 = blockIdx.x * kTileN + threadIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int nb_begin = split * nb_per_split;
  const int nb_end = min(NB, nb_begin + nb_per_split);
  const int chunk_w = kChunkBlocks * B / 4;
  const bool vec = (N % 4) == 0;
  const bool live = col0 < N;

  float sum[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) sum[m][j] = 0.f;

  for (int cb = nb_begin; cb < nb_end; cb += kChunkBlocks) {
    const int nblk = min(kChunkBlocks, nb_end - cb);
    const int span_w = nblk * B / 4;
    const int k0 = cb * B;
    __syncthreads();
    for (int i = threadIdx.x; i < MT * span_w; i += kThreads) {
      const int m = i / span_w, wi = i - m * span_w, k = k0 + 4 * wi;
      int v = 0;
      if (m0 + m < M) {
        const int8_t* xr = xq + static_cast<size_t>(m0 + m) * K;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k + t < K) v |= (static_cast<int>(xr[k + t]) & 0xFF) << (8 * t);
      }
      xw[m * chunk_w + wi] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int b = 0; b < nblk; ++b) {
      const int nb = cb + b;
      const int8_t* blk = codes + static_cast<size_t>(nb) * per * N;
      int acc[MT][kCols];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = 0;
      for (int g = 0; g < per; g += 4) {
        int p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[r] = load_word(blk + static_cast<size_t>(g + r) * N, col0, N, vec);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          int t[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) t[r] = field_bytes<D>(p[r], f);
          transpose4x4(t);             // t[j]: column j, K rows f*per+g..+3
          const int* xr = xw + (b * B + f * per + g) / 4;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int xv = xr[m * chunk_w];
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[m][j] = __dp4a(t[j], xv, acc[m][j]);
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
        for (int m = 0; m < MT; ++m)
          sum[m][j] = fmaf(static_cast<float>(acc[m][j]), sc, sum[m][j]);
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
void launch_s8(int mt, dim3 grid, size_t smem, cudaStream_t st,
               const int8_t* xq, const int8_t* codes, const int8_t* se,
               float* ws, int M, int K, int N, int NB, int B, int fold,
               int nbps) {
  switch (mt) {
    case 8:
      s8_partial<8, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
    case 4:
      s8_partial<4, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
    case 2:
      s8_partial<2, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
    default:
      s8_partial<1, D><<<grid, kThreads, smem, st>>>(xq, codes, se, ws, M, K,
                                                     N, NB, B, fold, nbps);
      break;
  }
}

// ---------------------------------------------------------------------------
// gemv_s8_tc
// ---------------------------------------------------------------------------
namespace tc8 {

using mxq::gemv_tc::bar_wait;
using mxq::gemv_tc::consumer_sync;
using mxq::gemv_tc::init_ring;
using mxq::gemv_tc::kAlign;
using mxq::gemv_tc::kBarBytes;
using mxq::gemv_tc::kConsumers;
using mxq::gemv_tc::kMaxStages;
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

// The position in a block's x row (mma order) of K row kb of the block.
// Mma step s of a block takes, for thread t, the K positions 16s + 4t + e
// (e < 4), which hold:
// - the int8 container (F = 1): packed row 16s + 4t + e, K row the same;
// - sb4 (F = 2, P = B/2 packed rows): field e >> 1 of packed row 8s + 2t
//   + (e & 1), K row 8s + 2t + (e & 1) + (e >> 1) P;
// - sb2 (F = 4, P = B/4): field e of packed row 4s + t, K row 4s + t + eP.
template <int D>
__device__ __forceinline__ int kpos(int kb, int B) {
  constexpr int F = mxq::fields<D>();
  if constexpr (F == 1) {
    return kb;
  } else if constexpr (F == 2) {
    const int P = B / 2, h = kb / P, p = kb - h * P, r = p & 7;
    return 16 * (p >> 3) + 4 * (r >> 1) + (r & 1) + 2 * h;
  } else {
    const int P = B / 4, f = kb / P, p = kb - f * P;
    return 16 * (p >> 2) + 4 * (p & 3) + f;
  }
}

// The 32-bit word of a packed row at `byte` of a sub-tile: the codes of
// the thread's 4 columns, column j in byte j.
__device__ __forceinline__ uint32_t row_word(const uint8_t* sub, int row,
                                             int byte) {
  return *reinterpret_cast<const uint32_t*>(sub + swz(row, byte));
}

// d (16 x 8 s32) += a (16 x 16 s8, row-major) . b (16 x 8 s8). Thread
// (g, t) holds a0: (row g, k 4t..4t + 3), a1: (row g + 8, the same), the
// lower k in the low byte; b0: (k 4t..4t + 3; column g); d0, d1: (row g,
// columns 2t, 2t + 1), d2, d3: (row g + 8, the same).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// w[j]: column j's 4 int8 weights at the K positions 16s + 4t.. of the
// block whose packed rows start at stage row brow (byte e of the word:
// position 16s + 4t + e).
template <int D>
__device__ __forceinline__ void step_words(const uint8_t* sub, int brow,
                                           int s, int t, int byte,
                                           int (&w)[4]) {
  constexpr int F = mxq::fields<D>();
  if constexpr (F == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = static_cast<int>(row_word(sub, brow + 16 * s + 4 * t + e, byte));
  } else if constexpr (F == 2) {
    const int w0 = static_cast<int>(row_word(sub, brow + 8 * s + 2 * t, byte));
    const int w1 = static_cast<int>(
        row_word(sub, brow + 8 * s + 2 * t + 1, byte));
    w[0] = field_bytes<D>(w0, 0);
    w[1] = field_bytes<D>(w1, 0);
    w[2] = field_bytes<D>(w0, 1);
    w[3] = field_bytes<D>(w1, 1);
  } else {
    const int w0 = static_cast<int>(row_word(sub, brow + 4 * s + t, byte));
#pragma unroll
    for (int f = 0; f < 4; ++f) w[f] = field_bytes<D>(w0, f);
  }
  transpose4x4(w);
}

// The consumers' xq of a split (rows 0.. 8 NT - 1, zeros past M and K),
// row pitch x_pitch bytes, in mma order within each block.
template <int NT, int D>
__device__ __forceinline__ void load_x(uint8_t* xs,
                                       const int8_t* __restrict__ xq,
                                       const Plan& p, int nb_begin,
                                       int nb_end) {
  consumer_sync();                  // every warp is done with the last x
  const int span = (nb_end - nb_begin) * p.B, k0 = nb_begin * p.B;
  const int chunks = span / 16;
  const bool vec = (p.K % 16) == 0;
  for (int i = threadIdx.x; i < 8 * NT * chunks; i += kConsumers) {
    const int m = i / chunks, kc = (i - m * chunks) * 16, k = k0 + kc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < p.M) {
      const int8_t* src = xq + static_cast<size_t>(m) * p.K + k;
      if (vec && k + 16 <= p.K) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        alignas(16) uint8_t e[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          e[j] = k + j < p.K ? static_cast<uint8_t>(src[j]) : 0;
        v = *reinterpret_cast<const uint4*>(e);
      }
    }
    uint8_t* row = xs + m * p.x_pitch;
    if constexpr (mxq::fields<D>() == 1) {
      *reinterpret_cast<uint4*>(row + kc) = v;
    } else {
      const uint8_t* e = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kk = kc + j, bl = kk / p.B;
        row[bl * p.B + kpos<D>(kk - bl * p.B, p.B)] = e[j];
      }
    }
  }
  consumer_sync();
}

template <int NT, int D>
__device__ __forceinline__ void consume(const Ring& ring, uint8_t* xs,
                                        const int8_t* __restrict__ xq,
                                        float* __restrict__ ws,
                                        const Plan& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int c = 32 * warp + 4 * (lane >> 2);   // the thread's first column
  const int sub_i = c / kSubW, byte = c % kSubW;
  const int steps = p.B / 16;
  int lo, hi;
  tile_range(p.tiles, lo, hi);
  int it = 0, x_split = -1;
  for (int tt = lo; tt < hi; ++tt) {
    const int split = tt / p.col_tiles, n0 = (tt % p.col_tiles) * kTN;
    const int nb_begin = split * p.nbps;
    const int nb_end = min(p.NB, nb_begin + p.nbps);
    if (split != x_split) {
      load_x<NT, D>(xs, xq, p, nb_begin, nb_end);
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
      // PAR blocks side by side, each into its own accumulators, so that
      // one block's loads and transposes overlap another's mma (a block's
      // sum and its place in the f32 sum are the single block's)
      constexpr int PAR = NT == 1 ? 4 : NT == 2 ? 2 : 1;
#pragma unroll 1
      for (int b0 = 0; b0 < nvalid; b0 += PAR) {
        int acc[PAR][NT][2][4];
#pragma unroll
        for (int j = 0; j < PAR; ++j)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int mm = 0; mm < 2; ++mm)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[j][n][mm][r] = 0;
#pragma unroll 1
        for (int ks = 0; ks < steps; ++ks) {
#pragma unroll
          for (int j = 0; j < PAR; ++j) {
            const int b = min(b0 + j, nvalid - 1);
            int w[4];
            step_words<D>(sub, b * p.rows, ks, t, byte, w);
            const int kb = (nb0 - nb_begin + b) * p.B + 16 * ks + 4 * t;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const uint32_t b0r = *reinterpret_cast<const uint32_t*>(
                  xs + (8 * n + (lane >> 2)) * p.x_pitch + kb);
              mma_s8(acc[j][n][0], w[0], w[1], b0r);
              mma_s8(acc[j][n][1], w[2], w[3], b0r);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < PAR; ++j) {
          const int b = b0 + j;
          if (b >= nvalid) break;
          // the block's scale a column, 2^(se - fold), times its exact sums
          const uint32_t sw = *reinterpret_cast<const uint32_t*>(
              st + p.se_off + b * kTN + c);
          float sc[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sc[jj] = exp2_i32(static_cast<int>(static_cast<int8_t>(
                                  (sw >> (8 * jj)) & 0xFF)) - p.fold);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int mm = 0; mm < 2; ++mm)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                sum[n][mm][r] = fmaf(static_cast<float>(acc[j][n][mm][r]),
                                     sc[2 * mm + (r >> 1)], sum[n][mm][r]);
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
__global__ void __launch_bounds__(mxq::gemv_tc::kThreads, 1)
gemv_s8_tc(const __grid_constant__ CUtensorMap codes_map,
           const __grid_constant__ CUtensorMap se_map,
           const int8_t* __restrict__ xq, const int8_t* __restrict__ codes,
           const int8_t* __restrict__ se, float* __restrict__ ws,
           const Plan p) {
  extern __shared__ uint8_t s8_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(s8_smem) + kAlign - 1)
      & ~uintptr_t(kAlign - 1));
  const Ring ring{base + kBarBytes, mxq::sm90::smem_u32(base), p.stages,
                  p.stage_bytes};
  uint8_t* xs = base + kBarBytes + p.stages * p.stage_bytes;
  init_ring(ring, p.tma != 0);
  if (take_role())
    consume<NT, D>(ring, xs, xq, ws, p);
  else if (threadIdx.x / 32 == kConsumers / 32)
    produce<1>(ring, &codes_map, &se_map, codes, se, p);
}

template <int NT, int D>
int launch(const int8_t* xq, const int8_t* codes, const int8_t* se,
           float* ws, const Plan& p, int ctas, int smem, cudaStream_t st) {
  auto kernel = gemv_s8_tc<NT, D>;
  CUtensorMap maps[2] = {};
  const int err = ring_maps<1>(maps, codes, se, p);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, mxq::gemv_tc::kThreads, smem, st>>>(maps[0], maps[1], xq,
                                                      codes, se, ws, p);
  return static_cast<int>(cudaGetLastError());
}

// The layout of decode D's plan, its checks, and the kernel for the n8
// tiles of M rows.
template <int D>
int run(const int8_t* xq, const int8_t* codes, const int8_t* se, float* ws,
        Plan p, int ctas, int smem, cudaStream_t st) {
  p.rows = mxq::packed_rows<D>(p.B);
  stage_layout<1>(p);
  p.x_pitch = p.nbps * p.B + 16;
  if (p.sb * p.rows > 256 || smem != smem_bytes(p, n8_tiles(p.M)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n8_tiles(p.M)) {
    case 1: return launch<1, D>(xq, codes, se, ws, p, ctas, smem, st);
    case 2: return launch<2, D>(xq, codes, se, ws, p, ctas, smem, st);
    case 4: return launch<4, D>(xq, codes, se, ws, p, ctas, smem, st);
    default: return launch<8, D>(xq, codes, se, ws, p, ctas, smem, st);
  }
}

}  // namespace tc8

// ---------------------------------------------------------------------------
// quantize_rows: per-token symmetric int8 quantization, one block a row
// ---------------------------------------------------------------------------
constexpr int kQuantThreads = 256;

__global__ void __launch_bounds__(kQuantThreads)
quantize_rows(const void* __restrict__ x, int x_bf16,
              int8_t* __restrict__ q, float* __restrict__ scale, int K) {
  __shared__ float red[kQuantThreads / 32];
  const size_t row = static_cast<size_t>(blockIdx.x) * K;
  auto at = [&](int k) {
    return x_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(x)[row + k])
                  : static_cast<const float*>(x)[row + k];
  };
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = fmaxf(amax, fabsf(at(k)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float sc = fmaxf(amax, 1e-30f) / 127.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) {
    const float r = rintf(at(k) / sc);
    q[row + k] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = sc;
}

}  // namespace

// The "cc" route (s8_partial): xq: (M, K) int8; xscale: (M,) f32; codes:
// (NB, rows, N) int8 with rows = B (int8 container), B/2 (sb4) or B/4
// (sb2), rows % 4 == 0; se: (NB, N) int8; ws: (ksplit, M, N) f32 scratch;
// out: (M, N) bf16 or f32; decode: mxq::kInt8, kSb4 or kSb2. Returns the
// cudaError_t of the launches (0 on success; cudaErrorInvalidValue for
// another decode).
extern "C" int dequant_gemv_s8_cc(const void* xq, const void* xscale,
                               const void* codes, const void* se, void* ws,
                               void* out, int M, int K, int N, int NB, int B,
                               int decode, int fold, int ksplit, int out_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbps = (NB + ksplit - 1) / ksplit;
  const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  const int mt_tiles = (M + mt - 1) / mt;
  const dim3 grid((N + kTileN - 1) / kTileN, ksplit, mt_tiles);
  const size_t smem = static_cast<size_t>(mt) * kChunkBlocks * B / 4 * sizeof(int);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* wp = static_cast<float*>(ws);
  switch (decode) {
    case mxq::kInt8:
      launch_s8<mxq::kInt8>(mt, grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, fold, nbps);
      break;
    case mxq::kSb4:
      launch_s8<mxq::kSb4>(mt, grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, fold, nbps);
      break;
    case mxq::kSb2:
      launch_s8<mxq::kSb2>(mt, grid, smem, st, xp, cp, sp, wp, M, K, N, NB, B, fold, nbps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st,
                                  static_cast<const float*>(xscale));
}

// The tensor-core route (gemv_s8_tc): xq (M, K) int8, xscale (M,) f32,
// codes, se, ws, out as for dequant_gemv_s8_cc, B a multiple of 16 with sb
// * rows <= 256, M <= 64. The plan (ksplit, nbps K-blocks a split, sb
// K-blocks a stage, stages, ctas, smem) is dequant_matmul.py::
// s8_gemv_plan's; smem must be the bytes that it implies here. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a plan or
// operands the kernel refuses).
extern "C" int dequant_gemv_s8(const void* xq, const void* xscale,
                               const void* codes, const void* se, void* ws,
                               void* out, int M, int K, int N, int NB, int B,
                               int decode, int fold, int ksplit, int nbps,
                               int sb, int stages, int ctas, int smem,
                               int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc8::Plan p{};
  p.M = M; p.K = K; p.N = N; p.NB = NB; p.B = B; p.fold = fold;
  p.ksplit = ksplit; p.nbps = nbps; p.sb = sb; p.stages = stages;
  p.col_tiles = (N + tc8::kTN - 1) / tc8::kTN;
  p.tiles = p.col_tiles * ksplit;
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.tma = N % 16 == 0 && aligned(codes) && aligned(se);
  if (M < 1 || M > 64 || B % 16 != 0 || sb < 1 || stages < 2
      || stages > tc8::kMaxStages || ctas < 1 || ksplit * nbps < NB
      || nbps % sb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* wp = static_cast<float*>(ws);
  int err;
  switch (decode) {
    case mxq::kInt8:
      err = tc8::run<mxq::kInt8>(xp, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kSb4:
      err = tc8::run<mxq::kSb4>(xp, cp, sp, wp, p, ctas, smem, st);
      break;
    case mxq::kSb2:
      err = tc8::run<mxq::kSb2>(xp, cp, sp, wp, p, ctas, smem, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return mxq::launch_split_reduce(wp, out, M, N, N, ksplit, out_bf16, st,
                                  static_cast<const float*>(xscale));
}

// Per-token int8 quantization of x (M, K) f32 or bf16 (x_bf16) into q (M,
// K) int8 and scale (M,) f32, one launch. Returns its cudaError_t.
extern "C" int quantize_x_int8(const void* x, int x_bf16, void* q,
                               void* scale, int M, int K, void* stream) {
  quantize_rows<<<M, kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, static_cast<int8_t*>(q), static_cast<float*>(scale), K);
  return static_cast<int>(cudaGetLastError());
}
