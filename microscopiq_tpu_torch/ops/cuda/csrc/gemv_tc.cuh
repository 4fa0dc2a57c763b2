// Pieces shared by the tensor-core GEMVs (dequant_gemv.cu's
// scale-after-dot GEMV, dequant_gemv_s8.cu's W8A8 GEMV and nb_matmul.cu's
// compact-NB GEMV): a persistent
// CTA an SM, two consumer warpgroups (8 warps) and a copying warpgroup of
// which one warp works, registers moved from the copiers to the consumers
// by setmaxnreg, a ring of stages behind
// full/empty mbarriers, x kept in shared memory for a whole K split, and
// the dot on mma.sync.m16n8k16 with the weight as the 16-row operand and
// up to 8 rows of x as the 8-wide one; the stage layout of packed code
// rows and exponent rows, and the copying warp that fills it.
#pragma once

#include "gemm_sm90.cuh"

namespace mxq {
namespace gemv_tc {

constexpr int kConsumers = 256;               // warps 0-7
constexpr int kThreads = kConsumers + 128;    // + warpgroup 2: warp 8 copies
// registers a thread after setmaxnreg (384 threads start with 168): the
// consumers' accumulators at 64 rows of x need more than 168; the copying
// warpgroup gives them its own
constexpr int kConsumeRegs = 232, kCopyRegs = 40;
static_assert(kConsumers * (kConsumeRegs - 168)
                  <= (kThreads - kConsumers) * (168 - kCopyRegs),
              "the consumers take more registers than the copiers give");
constexpr int kAlign = 1024;                  // slack for aligning the base
constexpr int kBarBytes = 1024;               // barriers; keeps the ring
                                              // 1024-aligned (128B swizzle)
constexpr int kMaxStages = 8;

__host__ __device__ constexpr int align_up(int v, int a) {
  return (v + a - 1) / a * a;
}

// Rows of x a tile sums (8 per n8 tile): 8, 16, 32 or 64.
__host__ __device__ constexpr int n8_tiles(int M) {
  return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
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

// The ring's stage pointers and barriers: stage s at base + s *
// stage_bytes, full(s) and empty(s) in the barrier block.
struct Ring {
  uint8_t* base;
  uint32_t bars;
  int stages, stage_bytes;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (kMaxStages + s);
  }
  __device__ __forceinline__ uint8_t* stage(int s) const {
    return base + s * stage_bytes;
  }
};

// Thread 0 sets up the barriers: full(s) completes on one arrive with the
// TMA byte count (or 32 arrives of the copying warp's plain copies),
// empty(s) on one arrive of each consumer warp.
__device__ __forceinline__ void init_ring(const Ring& ring, bool tma) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      sm90::mbar_init(ring.full(s), tma ? 1 : 32);
      sm90::mbar_init(ring.empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The register split of the roles: true for the thread of a consumer
// warp (more registers), false for the copying warpgroup (fewer).
__device__ __forceinline__ bool take_role() {
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kCopyRegs));
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumeRegs));
  return true;
}

// The CTA's contiguous share [lo, hi) of `tiles` tiles, so that a CTA's
// neighbouring tiles share their K split (and x stays in shared memory).
__device__ __forceinline__ void tile_range(int tiles, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles
                        / gridDim.x);
  hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles
                        / gridDim.x);
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16). Thread
// (g = lane / 4, t = lane % 4) holds a0: (row g, k 2t, 2t+1), a1: (g + 8,
// 2t..), a2: (g, 2t + 8..), a3: (g + 8, 2t + 8..), the lower k in the low
// half; b0: (k 2t, 2t+1; column g), b1: (k 2t + 8..; g); d0, d1: (row g,
// columns 2t, 2t + 1), d2, d3: (row g + 8, the same).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of x rows 8 nt.. (row pitch `pitch` bytes) at K position
// kp (even) of the tile's x: words (kp + 2t) / 2 and (kp + 2t + 8) / 2 of
// row 8 nt + g.
__device__ __forceinline__ void x_frag(const uint8_t* xs, int pitch, int nt,
                                       int kp, uint32_t& b0, uint32_t& b1) {
  const int lane = threadIdx.x & 31;
  const uint32_t* r = reinterpret_cast<const uint32_t*>(
      xs + (8 * nt + (lane >> 2)) * pitch + 2 * kp) + (lane & 3);
  b0 = r[0];
  b1 = r[4];
}

constexpr int kTN = 256;                      // columns a tile
constexpr int kSubW = 128;                    // bytes of a sub-tile row

// A GEMV's plan (the Python side's gemv_plan mirrors it).
struct Plan {
  int M, K, N, NB, B, mw, ebits, fold;
  int rows;                                   // packed rows a block
  int ksplit, nbps, sb, stages, col_tiles, tiles, tma;
  int sub_stride, se_off, stage_bytes, x_pitch;
};

// Stage layout of CB-byte codes: 2 * CB sub-tiles of sb * rows rows of 128
// bytes, each 1024-aligned, then the sb exponent rows of 256 columns;
// whole stages of 1024 bytes.
template <int CB>
__host__ __device__ inline void stage_layout(Plan& p) {
  p.sub_stride = align_up(p.sb * p.rows * kSubW, 1024);
  p.se_off = 2 * CB * p.sub_stride;
  p.stage_bytes = p.se_off + align_up(p.sb * kTN, 1024);
}
__host__ __device__ inline int smem_bytes(const Plan& p, int nt) {
  return kAlign + kBarBytes + p.stages * p.stage_bytes
         + align_up(8 * nt * p.x_pitch, 128);
}

// Byte `byte` (< 128) of row `row` of a sub-tile written with the 128-byte
// swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ int swz(int row, int byte) {
  return row * kSubW + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// The copying warp (warp 8): each tile's K-blocks of CB-byte codes and
// their exponents into the ring, by TMA (p.tma) or plain copies.
template <int CB>
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* codes_map,
                                        const CUtensorMap* se_map,
                                        const int8_t* __restrict__ codes,
                                        const int8_t* __restrict__ se,
                                        const Plan& p) {
  constexpr int subs = 2 * CB;
  const int lane = threadIdx.x & 31;
  const int srows = p.sb * p.rows, live_rows = p.NB * p.rows;
  int lo, hi;
  tile_range(p.tiles, lo, hi);
  int it = 0;
  for (int tt = lo; tt < hi; ++tt) {
    const int split = tt / p.col_tiles, n0 = (tt % p.col_tiles) * kTN;
    const int nb_begin = split * p.nbps;
    const int nb_end = min(p.NB, nb_begin + p.nbps);
    for (int nb0 = nb_begin; nb0 < nb_end; nb0 += p.sb, ++it) {
      const int s = it % ring.stages;
      bar_wait(ring.empty(s), ((it / ring.stages) & 1) ^ 1);
      uint8_t* st = ring.stage(s);
      if (p.tma) {
        if (lane == 0) {
          mxq::sm90::mbar_expect_tx(ring.full(s),
                                    subs * srows * kSubW + p.sb * kTN);
#pragma unroll
          for (int h = 0; h < subs; ++h)
            mxq::sm90::tma_load_2d(st + h * p.sub_stride, codes_map,
                                   n0 + h * (kSubW / CB), nb0 * p.rows,
                                   ring.full(s));
          mxq::sm90::tma_load_2d(st + p.se_off, se_map, n0, nb0,
                                 ring.full(s));
        }
      } else {
        // plain copies in the swizzled layout, zeros outside the weight
#pragma unroll 1
        for (int i = lane; i < subs * srows * kSubW; i += 32) {
          const int h = i / (srows * kSubW), rem = i - h * srows * kSubW;
          const int r = rem / kSubW, bt = rem % kSubW;
          const int col = n0 + h * (kSubW / CB) + bt / CB;
          const int grow = nb0 * p.rows + r;
          st[h * p.sub_stride + swz(r, bt)] =
              (col < p.N && grow < live_rows)
                  ? codes[(static_cast<size_t>(grow) * p.N + col) * CB
                          + bt % CB]
                  : 0;
        }
#pragma unroll 1
        for (int i = lane; i < p.sb * kTN; i += 32) {
          const int b = i / kTN, col = n0 + i % kTN;
          st[p.se_off + i] = (nb0 + b < p.NB && col < p.N)
                                 ? se[static_cast<size_t>(nb0 + b) * p.N + col]
                                 : 0;
        }
        mxq::sm90::mbar_arrive(ring.full(s));
      }
    }
  }
}

// The tensor maps of produce's TMA copies (p.tma): CB-byte codes in
// 128-byte-wide swizzled boxes of sb * rows rows, exponents in boxes of sb
// rows of 256 columns. Returns 0 or a cudaError_t.
template <int CB>
static inline int ring_maps(CUtensorMap (&maps)[2], const int8_t* codes,
                            const int8_t* se, const Plan& p) {
  if (!p.tma) return 0;
  int err = mxq::sm90::tensor_map_2d(
      &maps[0],
      CB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
      CB, codes, p.N, static_cast<long long>(p.NB) * p.rows, kSubW / CB,
      p.sb * p.rows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = mxq::sm90::raw_tensor_map(&maps[1], se, 1, p.N, p.NB, kTN, p.sb);
  return err;
}

}  // namespace gemv_tc
}  // namespace mxq
