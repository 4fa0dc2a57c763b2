// Hopper GEMM mainloop with a caller-supplied weight decode: y = x @ W for
// x (M, K) bf16 row-major and W decoded, a 64 x 128 tile at a time, into
// shared memory by the caller's decoder.
//
// It serves the GEMMs of three TPU kernels' paths:
// - microscopiq_tpu/ops/pallas/dequant_matmul.py::_dq_matmul_kernel above
//   64 tokens: emi8/emi8m, the int8 container and the float8 containers
//   (serving-layout and 2-D native2d codes), and the pf6, pf4, sb4 and sb2
//   transports and the fp16 container (which the JAX package sends to
//   XLA's dequantize-then-dot), at every MX block that divides the 64-deep
//   K step and whose ring fits: dequant_matmul.cu's gemm_dq_sm90;
// - ::_dq_matmul_outlier_kernel, the side-band PackedMXOutlier from 256
//   tokens on (JAX: XLA), at blocks of 8 to 64: outlier_matmul.cu's
//   outlier_gemm_sm90;
// - ::_nb_kernel, the compact PackedOutlierNB from 256 tokens on (JAX:
//   XLA), up to 16 slots: nb_matmul.cu's nb_gemm_sm90;
// - the first two at every other block that a packer makes (and the
//   side-band format at block 8 with 8 slots): gemm_any.cu's kernels,
//   which take the block at run time through the unit loop below.
// common.cuh's gemm_tile is left to the NB format above 16 slots, which
// no packer makes, and to the tests that force it.
//
// What bounds it on the H100: operations. At M = 1024 each weight byte
// feeds ~1000 flops, far above the ~295 flop/byte balance point, so the
// bound is 2*M*N*K / 989 TFLOP/s (bf16 tensor cores, dense).
//
// Design (sm_90a):
// - One block per SM (dynamic shared memory above 48 KB). Output tile
//   BM x BN = 256 x 128, K step BK = 64: 64 bf16 are 128 bytes, so a row of
//   x, and a column of the K-major B tile, fill one 128-byte swizzle row,
//   and a step holds whole MX blocks of 2 to 64.
// - DWG decode warpgroups (two for every decoder but the side-band
//   format's at 8 slots, which has one) and two consumer warpgroups, 384
//   or 512 threads, registers split by setmaxnreg (decoders 96 each of
//   two, or 136; consumers 160, of which 128 hold the accumulators):
//   * the decoders produce. Thread 0 issues the TMA load of each step's x
//     tile (256 x 64, 128-byte swizzle, rows past M and columns past K
//     zero-filled) on the stage's "full" mbarrier with its byte count, two
//     stages ahead of the decode (one with 3 stages), and the TMA loads of
//     the step's raw weight operands (the decoder's tensor maps, zeros
//     outside the weight) into a raw buffer on its own mbarrier, RAWBUFS-1
//     steps ahead. Where a weight's rows are no multiple of 16 bytes, every
//     decoder copies the raw operands with plain loads instead. Then every
//     decoder runs the decode on its share of the step (a column of one
//     MX block a thread): it writes the bf16 B tile K-major (row n holds
//     the 64 K values of column n) in the 128-byte swizzled layout that the
//     wgmma descriptor reads, 16-byte chunk c ^ (n % 8) of row n; then
//     fence.proxy.async and an arrive on "full". A named barrier over the
//     decoders frees each raw buffer before its next load.
//   * the consumers each wait on "full" and issue wgmma.mma_async
//     m64n128k16 (bf16 -> f32) over their 128 rows of the tile, 2 x 4
//     instructions a stage, commit, wait for all but the newest group and
//     release the previous stage on its "empty" mbarrier.
// - A ring of STAGES stages (x tile 32 KB + B tile 16 KB each, 1024-byte
//   aligned) and RAWBUFS raw buffers; the total is checked against the
//   227 KB (232,448 bytes) a block may use in a static_assert.
// - BM = 256 halves the decode work per output against 128-row tiles: each
//   B tile serves 256 rows of x.
// - Epilogue: masked stores from the accumulators, f32 or bf16, m < M and
//   n < N.
// - A row's result depends neither on M nor on the other rows: no split-K,
//   and no tile or stage choice taken from M.
//
// The decoder (a struct) provides:
//   static constexpr int kRawBytes;    the raw buffer (one step's operands)
//   bool tma;                          TMA copies (else plain copies)
//   int tx_bytes();                    bytes of one step's TMA copies
//   void copy_tma(int8_t* raw, int k0, int n0, uint32_t bar);   thread 0:
//       the TMA loads of the raw operands of K rows k0.. k0 + 63, columns
//       n0.. n0 + 127, on bar (zeros outside the weight);
//   template <int DWG> void copy(int8_t* raw, int k0, int n0, int t);
//       the same by plain loads and stores (thread t of 128 * DWG), where
//       the operands do not meet TMA's 16-byte alignment;
//   template <int DWG> void decode(const int8_t* raw, uint8_t* b, int t);
//       write that step's B tile from the raw copy (zeros outside the
//       weight) with store_b_words / store_b_elem.
//
// A decoder derived from UnitDecoder (the GEMMs at the MX blocks taken at
// run time, gemm_any.cu) copies "units" of U K rows instead of 64-row
// steps: U = 64 * S (S stages a unit: the lcm of the block and 64, whole
// blocks of a planar transport; S = 1 where that copy would not fit) or
// U = 64 / H (H units a stage: the side-band format's slots at small
// blocks or large budgets). It provides
//   int unit_rows();                   U, taken at run time
//   copy_tma / copy as above, k0 being the unit's first K row;
//   template <int DWG> void decode(const int8_t* raw, uint8_t* b, int t,
//                                  int k0, int part);
//       write B-tile rows from unit k0's raw copy: S > 1, the whole tile
//       from unit rows 64 * part..; H > 1, tile rows U * part.. from the
//       whole unit.
// The decoders wait for a unit's copy and free its buffer at the unit's
// first call, and release a stage after its last.
#pragma once

#include <type_traits>

#include <cuda.h>          // CUtensorMap and its enums (no driver linking)
#include "common.cuh"

namespace mxq {
namespace sm90 {

constexpr int kBM = 256, kBN = 128, kBK = 64;
// DWG decode warpgroups (1 or 2), then two consumers
__host__ __device__ constexpr int threads(int dwg) { return 128 * dwg + 256; }
constexpr int kXBytes = kBM * kBK * 2;        // 32 KB
constexpr int kBBytes = kBN * kBK * 2;        // 16 KB
constexpr int kStageBytes = kXBytes + kBBytes;
constexpr int kMaxSmem = 232448;              // 227 KB a block
// registers a thread after setmaxnreg: consumers 160 (128 accumulators);
// the decoders share the rest of the 64K: 136 for one warpgroup, 96 each
// for two (dwg * decode + 2 * 160 <= 512)
constexpr int kMmaRegs = 160;
__host__ __device__ constexpr int decode_regs(int dwg) {
  return dwg == 1 ? 136 : 96;
}
constexpr int kEmptyArrivals = 8;             // one lane per consumer warp

// The base of the decoders that copy units of a run-time number of K rows.
struct UnitDecoder {};

// Dynamic shared memory of a ring: 1024 bytes of alignment slack, the
// stages, RAWBUFS raw buffers of RAW bytes, the mbarriers (full and empty
// a stage, one a raw buffer).
__host__ __device__ constexpr int raw_pad(int raw) {
  return (raw + 127) / 128 * 128;
}
__host__ __device__ constexpr int ring_bytes(int stages, int raw,
                                             int rawbufs) {
  return 1024 + stages * kStageBytes + rawbufs * raw_pad(raw)
         + (2 * stages + rawbufs) * 8;
}
template <int STAGES, int RAW, int RAWBUFS>
struct Ring {
  static_assert(STAGES >= 3 && RAWBUFS >= 2, "ring of 3 stages or more");
  static constexpr int kRawPad = raw_pad(RAW);
  static constexpr int kRawOff = STAGES * kStageBytes;
  static constexpr int kBarOff = kRawOff + RAWBUFS * kRawPad;
  static constexpr int kBytes = ring_bytes(STAGES, RAW, RAWBUFS);
  static_assert(kBytes <= kMaxSmem, "ring exceeds 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (c0 innermost, c1) into dst, on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(bar) : "memory");
}

// Barrier 1 over the decode warpgroups alone.
template <int DWG>
__device__ __forceinline__ void decode_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * DWG) : "memory");
}

// The 16-byte chunk of K rows 8c.. 8c + 7 of column n (n < 128) in a
// K-major B tile with the 128-byte swizzle: eight bf16 packed two a word,
// the lower K row in the low half.
__device__ __forceinline__ void store_b_chunk(uint8_t* b, int n, int c,
                                              uint4 v) {
  *reinterpret_cast<uint4*>(b + n * 128 + ((c ^ (n & 7)) << 4)) = v;
}
// Two floats -> one word of two bf16 (round to nearest even), lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// n / 2 words of bf16 pairs (n % 8 == 0), K rows 8c0.. of column col.
template <int n>
__device__ __forceinline__ void store_b_words(uint8_t* b, int col, int c0,
                                              const uint32_t (&u)[n / 2]) {
  static_assert(n % 8 == 0, "whole 16-byte chunks");
#pragma unroll
  for (int c = 0; c < n / 8; ++c)
    store_b_chunk(b, col, c0 + c, make_uint4(u[4 * c], u[4 * c + 1],
                                             u[4 * c + 2], u[4 * c + 3]));
}
// One bf16 value of column n at K row k of the B tile.
__device__ __forceinline__ void store_b_elem(uint8_t* b, int n, int k,
                                             float v) {
  *reinterpret_cast<__nv_bfloat16*>(b + n * 128 + (((k >> 3) ^ (n & 7)) << 4)
                                    + (k & 7) * 2) = __float2bfloat16(v);
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); the
// leading offset is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 128 f32, this thread's 64) += A (64 x 16) . B (16 x 128), both
// bf16 from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Stores two neighbouring outputs (row, col) and (row, col + 1), masked.
__device__ __forceinline__ void store_pair(void* out, int M, int N,
                                           int out_bf16, int row, int col,
                                           float a, float b) {
  if (row >= M || col >= N) return;
  const size_t o = static_cast<size_t>(row) * N + col;
  const bool both = col + 1 < N, vec = both && (N % 2) == 0;
  if (out_bf16) {
    auto* p = static_cast<__nv_bfloat16*>(out) + o;
    if (vec) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    } else {
      p[0] = __float2bfloat16(a);
      if (both) p[1] = __float2bfloat16(b);
    }
  } else {
    float* p = static_cast<float*>(out) + o;
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      p[0] = a;
      if (both) p[1] = b;
    }
  }
}

// The block's 256 x 128 output tile (grid: M tiles on x, N tiles on y, so
// that the M tiles of one weight tile run together and share it in L2).
// K here is x's row length (a multiple of 8; columns past the weight's
// rows are zeros of x).
template <int STAGES, int RAWBUFS, int DWG, class Decoder>
__device__ __forceinline__ void gemm(const CUtensorMap* xmap, void* out,
                                     int M, int N, int K, int out_bf16,
                                     Decoder& dec) {
  using R = Ring<STAGES, Decoder::kRawBytes, RAWBUFS>;
  extern __shared__ uint8_t mxq_sm90_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mxq_sm90_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(base + R::kBarOff);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto raw_full = [&](int j) { return bars + 8 * (2 * STAGES + j % RAWBUFS); };
  auto x_tile = [&](int s) { return base + s * kStageBytes; };
  auto b_tile = [&](int s) { return base + s * kStageBytes + kXBytes; };
  auto raw = [&](int j) {
    return reinterpret_cast<int8_t*>(base + R::kRawOff
                                     + (j % RAWBUFS) * R::kRawPad);
  };

  const int m_blk = blockIdx.x * kBM, n_blk = blockIdx.y * kBN;
  const int nk = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1 + 128 * DWG);     // expect_tx + the decoders
      mbar_init(empty(s), kEmptyArrivals);
    }
    for (int j = 0; j < RAWBUFS; ++j) mbar_init(raw_full(j), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg < DWG) {
    // ---- decode warpgroups: x and the raw operands, the B tile ----
    // Raw copies run L = RAWBUFS - 1 steps ahead of the decode, x loads
    // X = STAGES - 2 steps ahead (thread 0 waits for their stage to be
    // released; X <= STAGES - 2 keeps that wait from needing a decode that
    // has not happened).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 ::"n"(decode_regs(DWG)));
    const int t = threadIdx.x;          // 0 .. 128 * DWG - 1
    constexpr int L = RAWBUFS - 1, X = STAGES - 2;
    auto load_x = [&](int j) {
      const int s = j % STAGES;
      mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
      mbar_expect_tx(full(s), kXBytes);
      tma_load_2d(x_tile(s), xmap, j * kBK, m_blk, full(s));
    };
    // step j's raw operands: TMA loads by thread 0 on raw_full(j), or
    // plain copies by every decode thread (visible after decode_sync)
    auto load_raw = [&](int j) {
      if (dec.tma) {
        if (t == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect_tx(raw_full(j), dec.tx_bytes());
          dec.copy_tma(raw(j), j * kBK, n_blk, raw_full(j));
        }
      } else {
        dec.template copy<DWG>(raw(j), j * kBK, n_blk, t);
      }
    };
    if (t == 0)
      for (int j = 0; j < X && j < nk; ++j) load_x(j);
    if constexpr (!std::is_base_of_v<UnitDecoder, Decoder>) {
      for (int j = 0; j < L && j < nk; ++j) load_raw(j);
      for (int d = 0; d < nk; ++d) {
        if (dec.tma) mbar_wait(raw_full(d), (d / RAWBUFS) & 1);
        decode_sync<DWG>();               // step d's raw copy is in, and
        if (d + L < nk) load_raw(d + L);  // every decoder is done with d - 1
        if (t == 0 && d + X < nk) load_x(d + X);
        const int s = d % STAGES;
        mbar_wait(empty(s), ((d / STAGES) & 1) ^ 1);
        dec.template decode<DWG>(raw(d), b_tile(s), t);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(full(s));
      }
    } else {
      // units of U K rows: call i decodes into stage i / H from unit i / S
      const int U = dec.unit_rows();
      const int H = U < kBK ? kBK / U : 1, S = U > kBK ? U / kBK : 1;
      const int nu = (nk * H + S - 1) / S;      // units over the nk stages
      auto load_unit = [&](int u) {
        if (dec.tma) {
          if (t == 0) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_expect_tx(raw_full(u), dec.tx_bytes());
            dec.copy_tma(raw(u), u * U, n_blk, raw_full(u));
          }
        } else {
          dec.template copy<DWG>(raw(u), u * U, n_blk, t);
        }
      };
      for (int j = 0; j < L && j < nu; ++j) load_unit(j);
      // call (stage d, part ph of H) = (unit u, part ps of S), counted
      // without a division
      for (int d = 0, u = 0, ph = 0, ps = 0; d < nk;) {
        const int s = d % STAGES;
        if (ps == 0) {                    // a unit's first call
          if (dec.tma) mbar_wait(raw_full(u), (u / RAWBUFS) & 1);
          decode_sync<DWG>();             // unit u is in; u - 1 is done
          if (u + L < nu) load_unit(u + L);
        }
        if (ph == 0) {                    // a stage's first call
          if (t == 0 && d + X < nk) load_x(d + X);
          mbar_wait(empty(s), ((d / STAGES) & 1) ^ 1);
        }
        dec.template decode<DWG>(raw(u), b_tile(s), t, u * U, ph + ps);
        if (++ph == H) {                  // a stage's last call
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(full(s));
          ph = 0;
          ++d;
        }
        if (++ps == S) {
          ps = 0;
          ++u;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma over 128 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kMmaRegs));
    const int t = threadIdx.x % 128;
    const int cw = wg - DWG, warp = t >> 5, lane = t & 31;
    float acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      const uint32_t a0 = smem_u32(x_tile(s)) + cw * 128 * 128;
      const uint32_t b0 = smem_u32(b_tile(s));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = smem_desc(b0 + kk * 32);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wgmma_m64n128k16(acc[m], smem_desc(a0 + m * 64 * 128 + kk * 32),
                           db);
      }
      wgmma_commit();
      wgmma_wait<1>();                  // step i - 1's products are done
      if (i > 0 && lane == 0) mbar_arrive(empty((i - 1) % STAGES));
    }
    wgmma_wait<0>();
    // accumulator i of a m64n128 tile: row 16 * warp + lane / 4 (+ 8 for
    // i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4) (+ 1 for odd i)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = m_blk + cw * 128 + m * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n_blk + j * 8 + (lane & 3) * 2;
        store_pair(out, M, N, out_bf16, row, col, acc[m][4 * j],
                   acc[m][4 * j + 1]);
        store_pair(out, M, N, out_bf16, row + 8, col, acc[m][4 * j + 2],
                   acc[m][4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 2-D tensor map of a row-major (d1, d0) array of `esize`-byte elements
// with rows of d0 elements (a multiple of 16 bytes, 16-byte aligned base):
// boxes of b1 rows of b0 elements, zeros outside the array. The driver's
// encoder comes through the runtime, so the library needs no -lcuda.
static inline int tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                                int esize, const void* p, long long d0,
                                long long d1, int b0, int b1,
                                CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (d0 <= 0 || d1 <= 0 || (d0 * esize) % 16 != 0
      || reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d0) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(p), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor map of x (M, K) bf16, K % 8 == 0: 64 x 256 boxes, 128-byte
// swizzle (the layout the A descriptor reads).
static inline int x_tensor_map(CUtensorMap* map, const void* x, int M,
                               int K) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M,
                       kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A tensor map of raw weight operands (int8 codes or exponents, 16-bit
// fp16 codes, or int32 positions) for the decoders' TMA copies: no swizzle.
static inline int raw_tensor_map(CUtensorMap* map, const void* p, int esize,
                                 long long d0, long long d1, int b0, int b1) {
  return tensor_map_2d(map,
                       esize == 4   ? CU_TENSOR_MAP_DATA_TYPE_INT32
                       : esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                       esize, p, d0, d1, b0, b1, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Launches kernel(xmap, args...) over the (M, N) output with `smem` bytes
// of dynamic shared memory and DWG decode warpgroups; returns the
// cudaError_t of the attribute, the tensor map or the launch.
template <int DWG, class Kernel, class... Args>
static inline int launch(Kernel kernel, int smem, const void* x, int M,
                         int N, int K, cudaStream_t st, Args... args) {
  CUtensorMap xmap;
  int err = x_tensor_map(&xmap, x, M, K);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, threads(DWG), smem, st>>>(xmap, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace mxq
