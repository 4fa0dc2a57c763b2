// Decode-GEMV experiments: y = x @ dequant(W) at decode M (8 rows of x),
// taken apart into kernels of their own. They answer on the H100 what
// scripts/exp_decode_variants.py, exp_sad_tiles.py and exp_nb_variants.py
// asked on the TPU: how much of the packed GEMV is the decode, how much the
// tile and the K split, and what the compact NB format's outliers cost.
//
// Replaces:
// - gemv_exp<V>  <- scripts/exp_decode_variants.py::make_kernel's kern: the
//   scale-after-dot GEMV over MX-FP6 emi8 codes, one decode body a variant:
//     i32    the script's production decode: m̂ << e' in 32-bit integers,
//            converted to bf16 (exact);
//     i16    the same arithmetic in 16-bit integer types, converted from
//            16 bits. CUDA has no 16-bit integer lanes for a per-element
//            variable shift (the half-word SIMD intrinsics have none), so on
//            the card the arm measures narrow types and their convert, not
//            the TPU's lane width;
//     ebf8   the script's host re-encode: the byte's bits, shifted, are bf16
//            bits of |value| * 2^-126; no variable shift, no int convert;
//     f32dot m̂ * 2^e' converted to f32: the decode that _sad_kernel and
//            csrc/dequant_gemv.cu ship (common.cuh's decode_emi8);
//     zero   the code converted as it is: wrong numerics on purpose, the
//            floor of a decode;
// - gemv_exp<f32dot> at the tiles of exp_gemv.TILES <- the GEMV that
//   scripts/exp_sad_tiles.py sweeps (dequant_matmul.py::_sad_kernel under
//   MICROSCOPIQ_SAD_TM/TN/TK). The card's knobs are its own: rows of x a
//   block (MT), columns a block (TN = threads x 4) and K blocks a split
//   (KB); the TPU's tiles do not carry over;
// - nb_fd        <- scripts/exp_nb_variants.py::_fd_kernel: the compact NB
//   int2 + fp4 GEMV (nb_matmul.cu's storage), inliers field by field and the
//   outliers by one strategy a mode (exp_gemv.py's docstring maps the TPU
//   modes to them).
//
// What bounds them on the H100: bytes. At M = 8 a weight byte feeds at most
// 16 * 8 flops, far below the ~295 flop/byte where the tensor cores would
// become the limit. The bound is (codes + exponents + x + out) / 3.35 TB/s:
// 0.021 ms at (4096, 16384) emi8, 0.036 ms at (4096, 28672), 0.0025 ms for
// the (4096, 4096) NB weight at budget 2.
//
// Design (gemv_exp): dequant_gemv.cu's GEMV with its knobs as template
// parameters. A thread owns 4 neighbouring columns (one 4-byte load of a code
// row); a block stages its split's x (MT x KB * B values) in shared memory
// as f32 once, then walks its KB blocks: per block the dot of x with the
// decoded weights in f32 (CUDA-core fmaf, exact products), then one scale
// 2^(se - fold) a column, added to the row's f32 sum. Each split writes an
// f32 partial; common.cuh's split_reduce adds them in split order. One
// summation order serves every variant, so i16, ebf8 and f32dot equal i32
// bit for bit: ebf8 stages x times 2^100 and takes 2^-100 back in the scale,
// so that no product x * |value| * 2^-126 falls below 2^-126 where f32 loses
// low bits, and every partial sum is i32's times 2^-26 exactly. The split
// count ceil(NB / KB) depends on the configuration and the shape, never on
// M. At MT = 8, 512 columns and KB = 7 at (4096, 28672) the kernel does the
// shipped GEMV's arithmetic in its order.
//
// Design (nb_fd): nb_matmul.cu's GEMV (a block owns an N-block of 16 rows
// and tk columns of K; a thread groups of 4 columns; MT rows of x in
// registers; a fixed-order block reduce, then split_reduce). The four sb2
// fields of a code byte r are rows 4i + r of the N-block: the kernel decodes
// and accumulates field by field. On the TPU the field-major accumulator
// (rows i * TN/4 + b * 4 + r) needed an un-permute; here a block holds one
// N-block, so field-major order is row order and the un-permute is the
// output index 16b + 4i + r.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mxq::exp2_i32;

constexpr int kCols = 4;                // columns a thread (one 4-byte load)
constexpr int kSmemMax = 232448;        // 227 KB, the H100's limit a block
constexpr int kSmemStatic = 48 * 1024;  // beyond it: opt in per kernel

enum Variant : int { kI32 = 0, kI16 = 1, kEbf8 = 2, kF32dot = 3, kZero = 4 };
constexpr int kXShift = 100;            // ebf8's x pre-scale, 2^100

// The weight a variant decodes from sign-extended emi8 byte c (ebf8: the
// re-encoded byte), before the block scale.
template <int V>
__device__ __forceinline__ float decode_variant(int c, int mw) {
  const int sh = 8 - mw;
  if constexpr (V == kI32) {
    return __bfloat162float(
        __int2bfloat16_rn((c >> sh) << (c & ((1 << sh) - 1))));
  } else if constexpr (V == kI16) {
    const int16_t c16 = static_cast<int16_t>(c);
    const int16_t m = static_cast<int16_t>(c16 >> sh);
    const int16_t e = static_cast<int16_t>(c16 & ((1 << sh) - 1));
    return __bfloat162float(__short2bfloat16_rn(static_cast<int16_t>(m << e)));
  } else if constexpr (V == kEbf8) {
    // bf16 bits ((b & 0x7F) << 5) | ((b & 0x80) << 8), as f32 bits << 16
    return __uint_as_float((static_cast<uint32_t>(c & 0x7F) << 21)
                           | (static_cast<uint32_t>(c & 0x80) << 24));
  } else if constexpr (V == kF32dot) {
    return mxq::decode_emi8(c, mw);
  } else {
    return static_cast<float>(c);
  }
}

// grid: (ceil(N / (THREADS * kCols)), ceil(NB / KB), ceil(M / MT)); dynamic
// shared memory: MT x (KB * B) floats of x. codes: (NB, B, N) emi8 bytes.
template <int V, int MT, int THREADS, int KB>
__global__ void __launch_bounds__(THREADS)
gemv_exp(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
         const int8_t* __restrict__ se, float* __restrict__ ws, int M, int K,
         int N, int NB, int B, int mw, int fold) {
  extern __shared__ float xs[];
  const int ld = KB * B;
  const int col0 = (blockIdx.x * THREADS + threadIdx.x) * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int nb0 = split * KB;
  const int nblk = min(KB, NB - nb0);
  const int span = nblk * B, k0 = nb0 * B;
  for (int i = threadIdx.x; i < MT * span; i += THREADS) {
    const int m = i / span, kk = i - m * span, k = k0 + kk;
    float v = 0.f;
    if (m0 + m < M && k < K)
      v = __bfloat162float(x[static_cast<size_t>(m0 + m) * K + k]);
    if constexpr (V == kEbf8) v *= 0x1p100f;                 // exact
    xs[m * ld + kk] = v;
  }
  __syncthreads();
  if (col0 >= N) return;
  const bool vec = (N % kCols) == 0;
  const int sfold = fold + (V == kEbf8 ? kXShift : 0);

  float sum[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < kCols; ++i) sum[m][i] = 0.f;
  for (int b = 0; b < nblk; ++b) {
    const int nb = nb0 + b;
    float part[MT][kCols];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kCols; ++i) part[m][i] = 0.f;
#pragma unroll 8
    for (int j = 0; j < B; ++j) {
      int c[kCols];
      mxq::load_row<mxq::kEmi8, kCols>(
          codes, static_cast<size_t>(nb) * B + j, col0, N, vec, c);
      float w[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) w[i] = decode_variant<V>(c[i], mw);
      const float* xr = xs + b * B + j;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xr[m * ld];
#pragma unroll
        for (int i = 0; i < kCols; ++i) part[m][i] = fmaf(xv, w[i], part[m][i]);
      }
    }
    const int8_t* srow = se + static_cast<size_t>(nb) * N;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const float sc = (col0 + i < N)
          ? exp2_i32(static_cast<int>(srow[col0 + i]) - sfold) : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) sum[m][i] = fmaf(part[m][i], sc, sum[m][i]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
    float* dst = ws + (static_cast<size_t>(split) * M + m0 + m) * N;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (col0 + i < N) dst[col0 + i] = sum[m][i];
  }
}

// Shared memory above the static 48 KB needs the kernel's opt-in.
template <class Kernel>
int smem_opt_in(Kernel kern, size_t smem) {
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= static_cast<size_t>(kSmemStatic)) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int V, int MT, int THREADS, int KB>
int launch_exp(const void* x, const void* codes, const void* se, void* ws,
               void* out, int M, int K, int N, int NB, int B, int mw,
               int fold, cudaStream_t st) {
  const int ksplit = (NB + KB - 1) / KB;
  const dim3 grid((N + THREADS * kCols - 1) / (THREADS * kCols), ksplit,
                  (M + MT - 1) / MT);
  const size_t smem = sizeof(float) * MT * KB * B;
  auto kern = gemv_exp<V, MT, THREADS, KB>;
  int err = smem_opt_in(kern, smem);
  if (err) return err;
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const int8_t*>(se), static_cast<float*>(ws), M, K, N, NB,
      B, mw, fold);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return mxq::launch_split_reduce(static_cast<float*>(ws), out, M, N, N,
                                  ksplit, 0, st);
}

// ---------------------------------------------------------------------------
// compact NB, field by field
// ---------------------------------------------------------------------------
constexpr int kNbThreads = 128;
constexpr int kNbWarps = kNbThreads / 32;
constexpr int kRows = 16;                 // N-block
constexpr int kMaxBudget = 8;

enum FdIn : int { kInScaled = 0, kInUnscaled = 1, kInNone = 2 };
enum FdOut : int {
  kOutNone = 0,    // no outliers
  kOutMerge = 1,   // slots merged into each field's weights before the dot
  kOutSecond = 2,  // a second 16-row outlier column, a second fmaf pass
  kOutOneHot = 3,  // per slot, 16 one-hot fmafs into the same sums
  kOutPlanes = 4,  // 16 position planes (one-hot selects) into a second
                   // register accumulator
  kOutSmem = 5,    // position-indexed adds into a per-thread accumulator in
                   // shared memory
};

// fp4 e2m1 bits (s e e m) -> signed integer value 2 * fp4 (exact), as
// nb_matmul.cu.
__device__ __forceinline__ float fp4_twice(int b) {
  const int e = (b >> 1) & 3, m = b & 1;
  const int mag = (m + 2 * min(e, 1)) << max(e - 1, 0);
  return static_cast<float>((b & 8) ? -mag : mag);
}

__device__ __forceinline__ int byte_of(uint32_t word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xFF));
}

// Shared memory of nb_fd: the block reduce's two [warps][MT * 16] arrays,
// and for kOutSmem each thread's MT x 16 sums (row stride MT * 16 + 1, so
// that a warp's threads hit distinct banks).
template <int OUT, int MT>
constexpr size_t fd_smem() {
  return sizeof(float) * (2 * kNbWarps * MT * kRows
                          + (OUT == kOutSmem ? kNbThreads * (MT * kRows + 1)
                                             : 0));
}

// Warp butterfly of v[MT][16], then lane 0's sums into red[warp][MT * 16].
template <int MT>
__device__ __forceinline__ void warp_sums(float (&v)[MT][kRows], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float s = v[m][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp * MT * kRows + m * kRows + j] = s;
    }
}

// grid: (NB, ceil(K / tk), ceil(M / MT)); ws: (ksplit, M, Np) f32 partials.
template <int IN, int OUT, int MT>
__global__ void __launch_bounds__(kNbThreads)
nb_fd(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
      const int8_t* __restrict__ se, const int8_t* __restrict__ seo,
      const int8_t* __restrict__ ob, float* __restrict__ ws, int M, int K,
      int Np, int NB, int budget, int fold, int tk) {
  constexpr int kAcc2 = OUT == kOutPlanes ? MT : 1;
  constexpr int kPlane = MT * kRows + 1;
  extern __shared__ float sm[];
  float* red = sm;                                   // [2][warps][MT * 16]
  float* planes = sm + 2 * kNbWarps * MT * kRows;    // [threads][kPlane]
  const int tid = threadIdx.x;
  const int b = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int gps = tk / 4;
  const int g_end = min((K + 3) / 4, (split + 1) * gps);
  const bool vec = (K % 4) == 0;
  const size_t nbk = static_cast<size_t>(NB) * K;

  float acc[MT][kRows], acc2[kAcc2][kRows];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[m][j] = 0.f;
#pragma unroll
  for (int m = 0; m < kAcc2; ++m)
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc2[m][j] = 0.f;
  if constexpr (OUT == kOutSmem) {
    for (int i = 0; i < MT * kRows; ++i) planes[tid * kPlane + i] = 0.f;
  }

  for (int g = split * gps + tid; g < g_end; g += kNbThreads) {
    const int k0 = 4 * g;
    const size_t bk = static_cast<size_t>(b) * K + k0;
    uint32_t cw[4] = {0, 0, 0, 0}, sw = 0, ow = 0;
    if (vec) {
      if constexpr (IN != kInNone) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cw[r] = __ldg(reinterpret_cast<const uint32_t*>(
              codes + static_cast<size_t>(4 * b + r) * K + k0));
      }
      sw = __ldg(reinterpret_cast<const uint32_t*>(se + bk));
      if constexpr (OUT != kOutNone)
        ow = __ldg(reinterpret_cast<const uint32_t*>(seo + bk));
    } else {
      for (int kk = 0; kk < 4 && k0 + kk < K; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cw[r] |= static_cast<uint32_t>(static_cast<uint8_t>(
                       codes[static_cast<size_t>(4 * b + r) * K + k0 + kk]))
                   << (8 * kk);
        sw |= static_cast<uint32_t>(static_cast<uint8_t>(se[bk + kk]))
              << (8 * kk);
        ow |= static_cast<uint32_t>(static_cast<uint8_t>(seo[bk + kk]))
              << (8 * kk);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      if (k >= K) break;
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[m] = (m0 + m < M)
            ? __bfloat162float(x[static_cast<size_t>(m0 + m) * K + k]) : 0.f;
      const int s_in = byte_of(sw, kk);
      // the slots: value 2 * fp4 * 2^(seo - se - 1) at row pos; an empty
      // slot (byte 0) is +0 at row 0
      int pos[kMaxBudget];
      float val[kMaxBudget];
      if constexpr (OUT != kOutNone) {
        const float osc = exp2_i32(byte_of(ow, kk) - s_in - 1);
#pragma unroll
        for (int s = 0; s < kMaxBudget; ++s) {
          pos[s] = -1;
          val[s] = 0.f;
          if (s < budget) {
            const int byte = static_cast<int>(
                static_cast<uint8_t>(__ldg(ob + s * nbk + bk + kk)));
            pos[s] = byte >> 4;
            val[s] = fp4_twice(byte & 0xF) * osc;
          }
        }
      }
      if constexpr (IN != kInNone) {
        const float sc = IN == kInScaled ? exp2_i32(s_in - fold) : 1.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {            // field
#pragma unroll
          for (int r = 0; r < 4; ++r) {          // code byte
            const int j = 4 * i + r;
            float w = static_cast<float>(
                static_cast<int>(static_cast<uint32_t>(byte_of(cw[r], kk))
                                 << (30 - 2 * i)) >> 30) * sc;
            if constexpr (OUT == kOutMerge) {
#pragma unroll
              for (int s = 0; s < kMaxBudget; ++s)
                w += (pos[s] == j) ? val[s] : 0.f;
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xv[m], w, acc[m][j]);
          }
        }
      }
      if constexpr (OUT == kOutSecond) {
        float wo[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          wo[j] = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxBudget; ++s)
            wo[j] += (pos[s] == j) ? val[s] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xv[m], wo[j], acc[m][j]);
      } else if constexpr (OUT == kOutOneHot) {
#pragma unroll
        for (int s = 0; s < kMaxBudget; ++s) {
          if (s >= budget) break;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float oh = (pos[s] == j) ? val[s] : 0.f;
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xv[m], oh, acc[m][j]);
          }
        }
      } else if constexpr (OUT == kOutPlanes) {
#pragma unroll
        for (int p = 0; p < kRows; ++p) {
          float a = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxBudget; ++s) a += (pos[s] == p) ? val[s] : 0.f;
#pragma unroll
          for (int m = 0; m < MT; ++m) acc2[m][p] = fmaf(xv[m], a, acc2[m][p]);
        }
      } else if constexpr (OUT == kOutSmem) {
#pragma unroll
        for (int s = 0; s < kMaxBudget; ++s) {
          if (s >= budget) break;
          float* q = planes + tid * kPlane + pos[s];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            q[m * kRows] = fmaf(xv[m], val[s], q[m * kRows]);
        }
      }
    }
  }

  // fixed-order reduction: butterfly within each warp, then warps in order;
  // the second accumulator (planes) likewise, added last
  warp_sums<MT>(acc, red);
  if constexpr (OUT == kOutPlanes) warp_sums<MT>(acc2, red + kNbWarps * MT * kRows);
  __syncthreads();
  for (int i = tid; i < MT * kRows; i += kNbThreads) {
    const int m = i / kRows, j = i - m * kRows;
    if (m0 + m >= M) continue;
    float v = red[i];
#pragma unroll
    for (int w = 1; w < kNbWarps; ++w) v += red[w * MT * kRows + i];
    if constexpr (OUT == kOutPlanes) {
      const float* r2 = red + kNbWarps * MT * kRows;
      float v2 = r2[i];
#pragma unroll
      for (int w = 1; w < kNbWarps; ++w) v2 += r2[w * MT * kRows + i];
      v += v2;
    } else if constexpr (OUT == kOutSmem) {
      float v2 = 0.f;
      for (int t = 0; t < kNbThreads; ++t) v2 += planes[t * kPlane + i];
      v += v2;
    }
    ws[(static_cast<size_t>(split) * M + m0 + m) * Np + kRows * b + j] = v;
  }
}

template <int IN, int OUT, int MT>
int launch_fd(const void* x, const void* codes, const void* se,
              const void* seo, const void* ob, void* ws, void* out, int M,
              int K, int Np, int N, int budget, int fold, int tk,
              cudaStream_t st) {
  const int NB = Np / kRows;
  const int ksplit = (K + tk - 1) / tk;
  constexpr size_t smem = fd_smem<OUT, MT>();
  auto kern = nb_fd<IN, OUT, MT>;
  int err = smem_opt_in(kern, smem);
  if (err) return err;
  kern<<<dim3(NB, ksplit, (M + MT - 1) / MT), kNbThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const int8_t*>(se), static_cast<const int8_t*>(seo),
      static_cast<const int8_t*>(ob), static_cast<float*>(ws), M, K, Np, NB,
      budget, fold, tk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return mxq::launch_split_reduce(static_cast<float*>(ws), out, M, Np, N,
                                  ksplit, 0, st);
}

}  // namespace

// The compiled tile configurations (MT, TN, KB) of exp_gemv_tiles; the same
// list as exp_gemv.py's TILES. (8, 512, 7) is the shipped GEMV's at
// (4096, 28672).
#define MXQ_EXP_TILES(X)                                                    \
  X(8, 512, 7) X(8, 256, 4) X(8, 256, 16) X(8, 512, 4) X(8, 512, 16)        \
  X(8, 512, 32) X(8, 1024, 8) X(8, 1024, 16) X(8, 1024, 32) X(8, 2048, 16)  \
  X(8, 2048, 64) X(8, 2048, 128) X(4, 512, 7) X(4, 1024, 16) X(16, 1024, 16)

// x: (M, K) bf16; codes: (NB, B, N) one-byte codes (emi8, or ebf8 bytes for
// variant 2); se: (NB, N) int8; ws: (ceil(NB / 4), M, N) f32; out: (M, N)
// f32. The variants run at MT 8, 512 columns, KB 4. Returns the cudaError_t
// of the launches (cudaErrorInvalidValue for an unknown variant).
extern "C" int exp_gemv_variant(const void* x, const void* codes,
                                const void* se, void* ws, void* out, int M,
                                int K, int N, int NB, int B, int variant,
                                int mw, int fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXQ_VARIANT(V)                                                    \
  case V:                                                                 \
    return launch_exp<V, 8, 128, 4>(x, codes, se, ws, out, M, K, N, NB, B, \
                                    mw, fold, st)
  switch (variant) {
    MXQ_VARIANT(kI32);
    MXQ_VARIANT(kI16);
    MXQ_VARIANT(kEbf8);
    MXQ_VARIANT(kF32dot);
    MXQ_VARIANT(kZero);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_VARIANT
}

// The f32dot GEMV at tile (mt, tn, kb); ws: (ceil(NB / kb), M, N) f32.
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for a
// configuration that was not compiled or whose x passes the shared memory).
extern "C" int exp_gemv_tiles(const void* x, const void* codes,
                              const void* se, void* ws, void* out, int M,
                              int K, int N, int NB, int B, int mt, int tn,
                              int kb, int mw, int fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXQ_TILE(MT, TN, KB)                                                \
  if (mt == MT && tn == TN && kb == KB)                                     \
    return launch_exp<kF32dot, MT, TN / kCols, KB>(x, codes, se, ws, out, M, \
                                                   K, N, NB, B, mw, fold,   \
                                                   st);
  MXQ_EXP_TILES(MXQ_TILE)
#undef MXQ_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (M, K) bf16; codes (Np/4, K), se, seo (Np/16, K), ob (budget, Np/16,
// K) int8 as nb_matmul.cu; ws: (ceil(K / tk), M, Np) f32; out: (M, N) f32.
// mode: exp_gemv.py's MODES id. Returns the cudaError_t of the launches.
extern "C" int exp_nb_fd(const void* x, const void* codes, const void* se,
                         const void* seo, const void* ob, void* ws, void* out,
                         int M, int K, int Np, int N, int budget, int fold,
                         int mode, int tk, void* stream) {
  if (budget < 0 || budget > kMaxBudget || tk <= 0 || tk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXQ_FD(IN, OUT, MT)                                                  \
  return launch_fd<IN, OUT, MT>(x, codes, se, seo, ob, ws, out, M, K, Np, N, \
                                budget, fold, tk, st)
  switch (mode) {
    case 0: MXQ_FD(kInScaled, kOutSecond, 8);     // fd
    case 1: MXQ_FD(kInScaled, kOutOneHot, 8);     // fd_dot
    case 2: MXQ_FD(kInScaled, kOutMerge, 8);      // fd_sc
    case 3: MXQ_FD(kInScaled, kOutPlanes, 4);     // pdot
    case 4: MXQ_FD(kInScaled, kOutSmem, 8);       // pdot3
    case 5: MXQ_FD(kInScaled, kOutNone, 8);       // in_only
    case 6: MXQ_FD(kInUnscaled, kOutNone, 8);     // in_dot1
    case 7: MXQ_FD(kInNone, kOutSecond, 8);       // out_only
    case 8: MXQ_FD(kInNone, kOutPlanes, 4);       // out_pdot
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_FD
}
