// Prefill-GEMM experiments: y = x @ W at the Llama-3-8B gate_up shape
// (K 4096, N 28672), M = 1024, taken apart into pieces, each a kernel of its
// own. They answer on the H100 what scripts/exp_prefill_*.py asked on the
// TPU: how much of the packed prefill GEMM is the tile loop, the convert,
// the fp6 decode, the tile size and the overlap of decode and MMA.
//
// Replaces the Pallas kernels of those scripts:
// - gemm_pre    <- scripts/exp_prefill_floor.py::pre_kernel (bf16 weights,
//                  no decode, through the shipped tiling);
// - gemm_tiles  <- scripts/exp_prefill_tiles2.py::kern (the pre and emi8
//                  bodies over a sweep of tiles, f32 or bf16 out);
// - gemm_unroll <- scripts/exp_prefill_overlap.py::unroll_kernel (a K step in
//                  S sub-chunks, the decode of s+1 issued before the MMAs of
//                  s, or decode-then-MMA; emi8 or the int8 container);
// - gemm_pipe   <- scripts/exp_prefill_pipe.py::pipe_kernel (K-axis double
//                  buffer);
// - gemm_rx     <- scripts/exp_prefill_pipe.py::rx_kernel (x resident for
//                  the whole K, pipelined along N).
//
// What bounds them on the H100: operations. 2*M*N*K = 240 GFLOP against
// 0.37 GB of operands: 650 flop a byte, above the ~295 balance point, so the
// bound is 2MNK / 989 TFLOP/s = 0.2432 ms.
//
// Tiles are the card's own, not the TPU's (TM 1024, TN up to 7168 and
// 100-120 MB of VMEM have no meaning here): a block of 8 warps (2 x 4)
// computes a BM x BN tile of y with bf16 wmma 16x16x16 fragments and f32
// accumulators in registers, a warp (BM/2) x (BN/4) of it; shared memory is
// at most 227 KB (232,448 bytes) a block and dynamic above 48 KB. The tile
// loops live here and not in common.cuh, so that the shipped kernels keep
// their build and their code; gemm_pre runs common.cuh's gemm_tile itself
// (128 x 128 x 32), so that gemm_pre against the shipped GEMM is exactly
// the decode's cost.
//
// Exactness: the decodes are common.cuh's (decode_field<kEmi8|kInt8> and
// exp2_i32, which clamps se - fold at -126 as the TPU's _exp2_i32); each
// decoded weight is exact in bf16, so the outputs differ from the plain
// version only in the f32 summation order. Shapes must divide by the tiles
// and K by the block (the wrapper checks; the TPU scripts need the same).
#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;         // 8 warps, 2 x 4 over the output tile
constexpr int kPad = 8;               // bf16 row padding (wmma ldm % 8 == 0)
constexpr int kSmemMax = 232448;      // 227 KB, the H100's limit a block
constexpr int kRxRows = 16;           // x rows a resident-x block holds
enum Src : int { kPre = 0, kDecoded = 1 };

// Blocks an SM that __launch_bounds__ asks registers for: two (<= 128
// registers a thread) where a warp's (BM/2) x (BN/4) accumulators are at
// most 8 fragments (64 registers), as the shipped GEMM's 128 x 128 tile
// runs; else one.
constexpr int min_blocks(int BM, int BN) {
  return (BM / 32) * (BN / 64) <= 8 ? 2 : 1;
}

// ---- operands -------------------------------------------------------------
// 16 codes and their 16 block exponents: K row gk, columns gn.. gn + 15 of a
// one-byte-a-code serving layout (NB, B, N), where K row gk is row gk of the
// flat (K, N) view. The exponents' load is issued first.
struct Raw16 {
  int4 c, s;
};

__device__ __forceinline__ Raw16 load16(const int8_t* __restrict__ codes,
                                        const int8_t* __restrict__ se, int gk,
                                        int gn, int N, int B) {
  Raw16 r;
  r.s = __ldg(reinterpret_cast<const int4*>(
      se + static_cast<size_t>(gk / B) * N + gn));
  r.c = __ldg(reinterpret_cast<const int4*>(
      codes + static_cast<size_t>(gk) * N + gn));
  return r;
}

// Decodes r (code times 2^(se - fold)) into 16 bf16 at dst (16-byte aligned).
template <int D>
__device__ __forceinline__ void store16(const Raw16& r, int mw, int fold,
                                        bf16* dst) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&r.c);
  const int8_t* s = reinterpret_cast<const int8_t*>(&r.s);
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lo = mxq::decode_field<D>(c[2 * i], 0, mw, 0)
                     * mxq::exp2_i32(s[2 * i] - fold);
    const float hi = mxq::decode_field<D>(c[2 * i + 1], 0, mw, 0)
                     * mxq::exp2_i32(s[2 * i + 1] - fold);
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    h[i] = *reinterpret_cast<uint32_t*>(&p);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// Calls f(i, t) for the thread's share of TASKS tasks, t = tid + i *
// kThreads, unrolled so that the loads of every task are issued together.
template <int TASKS, class F>
__device__ __forceinline__ void for_tasks(F f) {
  constexpr int kPer = (TASKS + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = threadIdx.x + i * kThreads;
    if (TASKS % kThreads == 0 || t < TASKS) f(i, t);
  }
}

// x rows m0.. m0 + ROWS - 1, columns k0.. k0 + COLS - 1 into As (row stride
// lda), 16 bytes a task; up to four loads of a thread in flight at once.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_a(const bf16* __restrict__ x, int K,
                                       int m0, int k0, bf16* As, int lda) {
  constexpr int kVec = COLS / 8, kTasks = ROWS * kVec;
  constexpr int kChunk = 4 * kThreads;
  static_assert(kTasks < kChunk || kTasks % kChunk == 0, "whole chunks");
#pragma unroll
  for (int c0 = 0; c0 < kTasks; c0 += kChunk) {
    constexpr int kN = kTasks < kChunk ? kTasks : kChunk;
    uint4 v[(kN + kThreads - 1) / kThreads];
    for_tasks<kN>([&](int i, int t) {
      t += c0;
      const int r = t / kVec, c = (t - r * kVec) * 8;
      v[i] = __ldg(reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(m0 + r) * K + k0 + c));
    });
    for_tasks<kN>([&](int i, int t) {
      t += c0;
      const int r = t / kVec, c = (t - r * kVec) * 8;
      *reinterpret_cast<uint4*>(As + r * lda + c) = v[i];
    });
  }
}

// The ROWS x COLS weight tile from K row k0, column n0 into Bs (row stride
// ldb): copied from bf16 weights (kPre) or decoded (D) from one-byte codes;
// every load of the thread is issued before the first decode and store.
template <int SRC, int D, int ROWS, int COLS>
__device__ __forceinline__ void fill_b(const void* __restrict__ w,
                                       const int8_t* __restrict__ se, int k0,
                                       int n0, int N, int B, int mw, int fold,
                                       bf16* Bs, int ldb) {
  constexpr int kVec = COLS / 16, kTasks = ROWS * kVec;
  constexpr int kPer = (kTasks + kThreads - 1) / kThreads;
  if constexpr (SRC == kPre) {
    uint4 v[kPer][2];
    for_tasks<kTasks>([&](int i, int t) {
      const int r = t / kVec, c = (t - r * kVec) * 16;
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(w) + static_cast<size_t>(k0 + r) * N + n0
          + c);
      v[i][0] = __ldg(p);
      v[i][1] = __ldg(p + 1);
    });
    for_tasks<kTasks>([&](int i, int t) {
      const int r = t / kVec, c = (t - r * kVec) * 16;
      uint4* d = reinterpret_cast<uint4*>(Bs + r * ldb + c);
      d[0] = v[i][0];
      d[1] = v[i][1];
    });
  } else {
    Raw16 raw[kPer];
    for_tasks<kTasks>([&](int i, int t) {
      const int r = t / kVec, c = (t - r * kVec) * 16;
      raw[i] = load16(static_cast<const int8_t*>(w), se, k0 + r, n0 + c, N,
                      B);
    });
    for_tasks<kTasks>([&](int i, int t) {
      const int r = t / kVec, c = (t - r * kVec) * 16;
      store16<D>(raw[i], mw, fold, Bs + r * ldb + c);
    });
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The same copy as load_a through cp.async (one commit group).
template <int ROWS, int COLS>
__device__ __forceinline__ void issue_a(const bf16* __restrict__ x, int K,
                                        int m0, int k0, bf16* As, int lda) {
  constexpr int kVec = COLS / 8;
  for (int t = threadIdx.x; t < ROWS * kVec; t += kThreads) {
    const int r = t / kVec, c = (t - r * kVec) * 8;
    cp_async16(As + r * lda + c,
               x + static_cast<size_t>(m0 + r) * K + k0 + c);
  }
  cp_async_commit();
}

// ---- warp MMA and epilogues -----------------------------------------------
// acc[i][j] += A rows a0 + 16i (16 deep) x B columns b0 + 16j (16 deep).
template <int FM, int FN>
__device__ __forceinline__ void mma16(Acc (&acc)[FM][FN], const bf16* a0,
                                      int lda, const bf16* b0, int ldb) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
  for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(a[i], a0 + i * 16 * lda, lda);
#pragma unroll
  for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(b[j], b0 + j * 16, ldb);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
}

template <int FM, int FN>
__device__ __forceinline__ void zero(Acc (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// f32 out straight from the fragments (the tiles divide M and N).
template <int FM, int FN>
__device__ __forceinline__ void store_f32(Acc (&acc)[FM][FN], float* out,
                                          int N, int m0, int n0) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(out + static_cast<size_t>(m0 + i * 16) * N
                                  + n0 + j * 16,
                              acc[i][j], N, wmma::mem_row_major);
}

// bf16 out through the warp's 16 x 16 f32 staging tile cs.
template <int FM, int FN>
__device__ __forceinline__ void store_bf16(Acc (&acc)[FM][FN], bf16* out,
                                           int N, int m0, int n0, float* cs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        out[static_cast<size_t>(m0 + i * 16 + (e >> 4)) * N + n0 + j * 16
            + (e & 15)] = __float2bfloat16(cs[e]);
      __syncwarp();
    }
}

// ---- gemm_pre: the shipped tile loop, B tile copied from bf16 weights ------
__global__ void __launch_bounds__(mxq::kGemmThreads)
gemm_pre(const bf16* __restrict__ x, const bf16* __restrict__ wd,
         float* out, int M, int K, int N) {
  // B tile: thread -> row tid/8, 16 columns (as the shipped GEMM's decode)
  static_assert(mxq::kGemmThreads == kThreads, "one B-tile task a thread");
  const int n_blk = blockIdx.x * mxq::kGemmBN;
  auto copy = [&](mxq::BTile Bs, int k0) {
    fill_b<kPre, 0, mxq::kGemmBK, mxq::kGemmBN>(
        wd, nullptr, k0, n_blk, N, 0, 0, 0, &Bs[0][0],
        mxq::kGemmBN + mxq::kGemmPad);
  };
  mxq::gemm_tile(x, out, M, K, N, K, 0, copy);
}

// ---- gemm_tiles: the pre and decoded bodies over the card's tile sweep -----
template <int BM, int BN, int BK>
struct TileSmem {
  static constexpr int lda = BK + kPad, ldb = BN + kPad;
  static constexpr int a_elems = BM * lda, b_elems = BK * ldb;
  static constexpr int bytes = (a_elems + b_elems) * 2
                               + (kThreads / 32) * 256 * 4;
};

// Per BK step: x into As, the B tile (copied or emi8-decoded) into Bs, one
// barrier, the MMAs, one barrier: the shipped loop's schedule at other tiles.
template <int SRC, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, min_blocks(BM, BN))
gemm_tiles(const bf16* __restrict__ x, const void* __restrict__ w,
           const int8_t* __restrict__ se, void* out, int K, int N, int B,
           int mw, int fold, int out_bf16) {
  using T = TileSmem<BM, BN, BK>;
  constexpr int FM = BM / 32, FN = BN / 64;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + T::a_elems;
  float* Cs = reinterpret_cast<float*>(Bs + T::b_elems);
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  Acc acc[FM][FN];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<BM, BK>(x, K, m_blk, k0, As, T::lda);
    fill_b<SRC, mxq::kEmi8, BK, BN>(w, se, k0, n_blk, N, B, mw, fold, Bs,
                                    T::ldb);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma16(acc, As + wm * (BM / 2) * T::lda + kk, T::lda,
            Bs + kk * T::ldb + wn * (BN / 4), T::ldb);
    __syncthreads();
  }
  const int m0 = m_blk + wm * (BM / 2), n0 = n_blk + wn * (BN / 4);
  if (out_bf16)
    store_bf16(acc, static_cast<bf16*>(out), N, m0, n0, Cs + warp * 256);
  else
    store_f32(acc, static_cast<float*>(out), N, m0, n0);
}

// ---- gemm_unroll: a K step in S sub-chunks ---------------------------------
template <int BM, int BN, int BK, int S>
struct UnrollSmem {
  static constexpr int lda = BK + kPad, ldb = BN + kPad, SK = BK / S;
  static constexpr int a_elems = BM * lda, b_elems = SK * ldb;
  static constexpr int bytes = (a_elems + 2 * b_elems) * 2;
};

// Per BK step the block loads x (BM x BK) once. Interleaved (IL): sub-chunk
// 0 is decoded, then for each s every warp issues its share of the decode
// of sub-chunk s+1 into the other of two SK-deep buffers before its MMAs on
// s, and one barrier per sub-chunk publishes s+1 and frees s. Sequential:
// decode s, barrier, MMAs on s, barrier. The TPU kernel's straight-line
// unroll asked whether Mosaic overlaps VPU and MXU; here warps overlap
// anyway, so IL against sequential measures the overlap within a warp.
template <int D, int S, bool IL, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, min_blocks(BM, BN))
gemm_unroll(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
            const int8_t* __restrict__ se, float* out, int K, int N, int B,
            int mw, int fold) {
  using T = UnrollSmem<BM, BN, BK, S>;
  constexpr int SK = T::SK, FM = BM / 32, FN = BN / 64;
  static_assert(BK % S == 0 && SK % 16 == 0, "sub-chunks of 16 rows");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bb[2] = {As + T::a_elems, As + T::a_elems + T::b_elems};
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  auto decode = [&](int k0, int s, bf16* dst) {
    fill_b<kDecoded, D, SK, BN>(codes, se, k0 + s * SK, n_blk, N, B, mw,
                                fold, dst, T::ldb);
  };
  Acc acc[FM][FN];
  zero(acc);
  auto mma = [&](int s, const bf16* Bsrc) {
#pragma unroll
    for (int kk = 0; kk < SK; kk += 16)
      mma16(acc, As + wm * (BM / 2) * T::lda + s * SK + kk, T::lda,
            Bsrc + kk * T::ldb + wn * (BN / 4), T::ldb);
  };
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<BM, BK>(x, K, m_blk, k0, As, T::lda);
    if constexpr (IL) {
      decode(k0, 0, Bb[0]);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s + 1 < S) decode(k0, s + 1, Bb[(s + 1) & 1]);
        mma(s, Bb[s & 1]);
        __syncthreads();
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        decode(k0, s, Bb[0]);
        __syncthreads();
        mma(s, Bb[0]);
        __syncthreads();
      }
    }
  }
  store_f32(acc, out, N, m_blk + wm * (BM / 2), n_blk + wn * (BN / 4));
}

// ---- gemm_pipe: K-axis double buffer ----------------------------------------
template <int BM, int BN, int BK>
struct PipeSmem {
  static constexpr int lda = BK + kPad, ldb = BN + kPad;
  static constexpr int a_elems = BM * lda, b_elems = BK * ldb;
  static constexpr int bytes = 2 * (a_elems + b_elems) * 2;
};

// Two A and two B stages. At K step k the block issues the cp.async copy of
// x for k+1 and the global loads of the codes and exponents of k+1 into
// registers, runs its MMAs on stage k, then decodes the registers into the
// other B stage, waits for its copies and meets one barrier.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, min_blocks(BM, BN))
gemm_pipe(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
          const int8_t* __restrict__ se, float* out, int K, int N, int B,
          int mw, int fold) {
  using T = PipeSmem<BM, BN, BK>;
  constexpr int FM = BM / 32, FN = BN / 64;
  constexpr int kTasks = BK * (BN / 16);
  static_assert(kTasks % kThreads == 0, "whole B-tile tasks a thread");
  constexpr int BT = kTasks / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * T::a_elems;
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  Raw16 raw[BT];
  auto load_b = [&](int k0) {
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const int t = threadIdx.x + i * kThreads;
      const int r = t / (BN / 16), c = (t - r * (BN / 16)) * 16;
      raw[i] = load16(codes, se, k0 + r, n_blk + c, N, B);
    }
  };
  auto store_b = [&](bf16* dst) {
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const int t = threadIdx.x + i * kThreads;
      const int r = t / (BN / 16), c = (t - r * (BN / 16)) * 16;
      store16<mxq::kEmi8>(raw[i], mw, fold, dst + r * T::ldb + c);
    }
  };
  Acc acc[FM][FN];
  zero(acc);
  issue_a<BM, BK>(x, K, m_blk, 0, As, T::lda);
  load_b(0);
  store_b(Bs);
  cp_async_wait_all();
  __syncthreads();
  const int nk = K / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      issue_a<BM, BK>(x, K, m_blk, (kt + 1) * BK, As + (cur ^ 1) * T::a_elems,
                      T::lda);
      load_b((kt + 1) * BK);
    }
    const bf16* a = As + cur * T::a_elems + wm * (BM / 2) * T::lda;
    const bf16* b = Bs + cur * T::b_elems + wn * (BN / 4);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma16(acc, a + kk, T::lda, b + kk * T::ldb, T::ldb);
    if (more) store_b(Bs + (cur ^ 1) * T::b_elems);
    cp_async_wait_all();
    __syncthreads();
  }
  store_f32(acc, out, N, m_blk + wm * (BM / 2), n_blk + wn * (BN / 4));
}

// ---- gemm_rx: x resident for the whole K, pipelined along N ----------------
template <int TN, int BK>
struct RxSmem {
  static constexpr int ldb = TN + kPad, b_elems = BK * ldb;
  static int bytes(int K) {
    return 2 * b_elems * 2 + kRxRows * (K + kPad) * 2;
  }
};

// A block holds kRxRows rows of x for the whole K in shared memory (loaded
// once by cp.async) and walks `tiles` N tiles of TN columns, each over the
// whole K in BK steps; the 8 warps sit side by side, TN/8 columns each. The
// W chunk of step t+1 is loaded into registers before the MMAs of step t and
// decoded into the other of two buffers after them; one barrier a step. Each
// W tile is decoded once for every x panel (M / 16 times): the TPU kernel's
// VMEM held all of x, 227 KB holds 16 rows of it.
template <int TN, int BK>
__global__ void __launch_bounds__(kThreads)
gemm_rx(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
        const int8_t* __restrict__ se, float* out, int K, int N, int B,
        int mw, int fold, int tiles) {
  using T = RxSmem<TN, BK>;
  constexpr int FN = TN / 128;
  constexpr int kTasks = BK * (TN / 16);
  static_assert(kTasks % kThreads == 0, "whole B-tile tasks a thread");
  constexpr int BT = kTasks / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);
  bf16* Xs = Bs + 2 * T::b_elems;
  const int ldx = K + kPad;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kRxRows, tile0 = blockIdx.y * tiles;
  const int nk = K / BK, steps = tiles * nk;
  for (int t = threadIdx.x; t < kRxRows * (K / 8); t += kThreads) {
    const int r = t / (K / 8), c = (t - r * (K / 8)) * 8;
    cp_async16(Xs + r * ldx + c, x + static_cast<size_t>(m0 + r) * K + c);
  }
  cp_async_commit();
  Raw16 raw[BT];
  auto load_b = [&](int step) {
    const int n_base = (tile0 + step / nk) * TN, k0 = (step % nk) * BK;
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const int t = threadIdx.x + i * kThreads;
      const int r = t / (TN / 16), c = (t - r * (TN / 16)) * 16;
      raw[i] = load16(codes, se, k0 + r, n_base + c, N, B);
    }
  };
  auto store_b = [&](bf16* dst) {
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const int t = threadIdx.x + i * kThreads;
      const int r = t / (TN / 16), c = (t - r * (TN / 16)) * 16;
      store16<mxq::kEmi8>(raw[i], mw, fold, dst + r * T::ldb + c);
    }
  };
  Acc acc[1][FN];
  zero(acc);
  load_b(0);
  store_b(Bs);
  cp_async_wait_all();
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1, ks = st % nk;
    const bool more = st + 1 < steps;
    if (more) load_b(st + 1);
    const bf16* b = Bs + cur * T::b_elems + warp * (TN / 8);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma16(acc, Xs + ks * BK + kk, ldx, b + kk * T::ldb, T::ldb);
    if (ks == nk - 1) {
      store_f32(acc, out, N, m0, (tile0 + st / nk) * TN + warp * (TN / 8));
      zero(acc);
    }
    if (more) store_b(Bs + (cur ^ 1) * T::b_elems);
    __syncthreads();
  }
}

// ---- launch -----------------------------------------------------------------
template <class T>
struct Same {
  using type = T;
};

// Launches kern with `smem` bytes of dynamic shared memory; the cudaError_t.
template <class... P>
int launch(void (*kern)(P...), dim3 grid, int smem, cudaStream_t st,
           typename Same<P>::type... args) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* argv[] = {static_cast<void*>(&args)...};
  cudaLaunchKernel(reinterpret_cast<const void*>(kern), grid, dim3(kThreads),
                   argv, static_cast<size_t>(smem), st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point: x (M, K) bf16; f32 out (M, N) unless named; the tiles
// divide M, N and K (the wrapper checks); a tile configuration that was not
// compiled returns cudaErrorInvalidValue. Returns the cudaError_t of the
// launch (0 on success).

// wd: (K, N) bf16.
extern "C" int exp_gemm_pre(const void* x, const void* wd, void* out, int M,
                            int K, int N, void* stream) {
  gemm_pre<<<mxq::gemm_grid(M, N), mxq::kGemmThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wd),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// src 0: w is (K, N) bf16 and se unused; src 1: w is emi8 codes (NB, B, N)
// and se (NB, N) int8. out is bf16 when out_bf16, else f32.
extern "C" int exp_gemm_tiles(const void* x, const void* w, const void* se,
                              void* out, int M, int K, int N, int B, int src,
                              int bm, int bn, int bk, int mw, int fold,
                              int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* sp = static_cast<const int8_t*>(se);
#define MXQ_TILES(S, BM, BN, BK)                                            \
  if (src == S && bm == BM && bn == BN && bk == BK)                         \
    return launch(gemm_tiles<S, BM, BN, BK>, dim3(N / BN, M / BM),          \
                  TileSmem<BM, BN, BK>::bytes, st, xp, w, sp, out, K, N, B, \
                  mw, fold, out_bf16);
  MXQ_TILES(kPre, 128, 128, 32)
  MXQ_TILES(kPre, 128, 128, 64)
  MXQ_TILES(kPre, 128, 256, 32)
  MXQ_TILES(kPre, 256, 128, 32)
  MXQ_TILES(kPre, 64, 128, 32)
  MXQ_TILES(kPre, 128, 64, 32)
  MXQ_TILES(kDecoded, 128, 128, 32)
  MXQ_TILES(kDecoded, 128, 128, 64)
  MXQ_TILES(kDecoded, 128, 256, 32)
  MXQ_TILES(kDecoded, 256, 128, 32)
#undef MXQ_TILES
  return static_cast<int>(cudaErrorInvalidValue);
}

// codes (NB, B, N) in one byte a code (decode: mxq::kEmi8 or mxq::kInt8),
// se (NB, N) int8; s sub-chunks a BK step, interleaved or sequential.
extern "C" int exp_gemm_unroll(const void* x, const void* codes,
                               const void* se, void* out, int M, int K, int N,
                               int B, int decode, int s, int interleave,
                               int bm, int bn, int bk, int mw, int fold,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* op = static_cast<float*>(out);
#define MXQ_UNROLL(D, S, IL, BM, BN, BK)                                    \
  if (decode == D && s == S && interleave == IL && bm == BM && bn == BN     \
      && bk == BK)                                                          \
    return launch(gemm_unroll<D, S, IL, BM, BN, BK>, dim3(N / BN, M / BM),  \
                  UnrollSmem<BM, BN, BK, S>::bytes, st, xp, cp, sp, op, K,  \
                  N, B, mw, fold);
  MXQ_UNROLL(mxq::kInt8, 1, false, 128, 128, 64)
  MXQ_UNROLL(mxq::kEmi8, 1, false, 128, 128, 64)
  MXQ_UNROLL(mxq::kEmi8, 4, false, 128, 128, 64)
  MXQ_UNROLL(mxq::kEmi8, 4, true, 128, 128, 64)
  MXQ_UNROLL(mxq::kEmi8, 8, true, 128, 128, 128)
  MXQ_UNROLL(mxq::kEmi8, 4, true, 128, 256, 64)
  MXQ_UNROLL(mxq::kEmi8, 8, true, 128, 128, 256)
#undef MXQ_UNROLL
  return static_cast<int>(cudaErrorInvalidValue);
}

// emi8 codes (NB, B, N), se (NB, N) int8.
extern "C" int exp_gemm_pipe(const void* x, const void* codes, const void* se,
                             void* out, int M, int K, int N, int B, int bm,
                             int bn, int bk, int mw, int fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* op = static_cast<float*>(out);
#define MXQ_PIPE(BM, BN, BK)                                                \
  if (bm == BM && bn == BN && bk == BK)                                     \
    return launch(gemm_pipe<BM, BN, BK>, dim3(N / BN, M / BM),              \
                  PipeSmem<BM, BN, BK>::bytes, st, xp, cp, sp, op, K, N, B, \
                  mw, fold);
  MXQ_PIPE(128, 128, 32)
  MXQ_PIPE(128, 256, 32)
#undef MXQ_PIPE
  return static_cast<int>(cudaErrorInvalidValue);
}

// emi8 codes (NB, B, N), se (NB, N) int8; a block takes 16 rows of x and
// `tiles` consecutive N tiles of tn columns: grid (M / 16, N / (tn * tiles)).
extern "C" int exp_gemm_rx(const void* x, const void* codes, const void* se,
                           void* out, int M, int K, int N, int B, int tn,
                           int bk, int tiles, int mw, int fold,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const int8_t*>(se);
  auto* op = static_cast<float*>(out);
  if (tiles <= 0 || N % (tn * tiles))
    return static_cast<int>(cudaErrorInvalidValue);
#define MXQ_RX(TN, BK)                                                      \
  if (tn == TN && bk == BK)                                                 \
    return launch(gemm_rx<TN, BK>, dim3(M / kRxRows, N / (TN * tiles)),     \
                  RxSmem<TN, BK>::bytes(K), st, xp, cp, sp, op, K, N, B,    \
                  mw, fold, tiles);
  MXQ_RX(256, 32)
  MXQ_RX(512, 32)
#undef MXQ_RX
  return static_cast<int>(cudaErrorInvalidValue);
}
