// Device helpers shared by the dequantizing matmul kernels: the scale
// exponent, one decode per packed-weight transport, the fixed-order K-split
// reduce, and the bf16 tensor-core tile loop that each GEMM runs with its
// own weight decode.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <mma.h>
#include <stdint.h>

namespace mxq {

// 2^e as f32 built from exponent bits, e clamped to [-126, 127] as the TPU
// kernels' _exp2_i32 does (no subnormal scales).
__device__ __forceinline__ float exp2_i32(int e) {
  e = max(-126, min(127, e));
  return __int_as_float((e + 127) << 23);
}

// ---------------------------------------------------------------------------
// Transport decodes: a stored code -> the integer (or value) that the TPU
// kernels (_sad_kernel, _dq_matmul_kernel) multiply before the per-block
// scale 2^(se - fold). The ids are those of dequant_matmul.py's _DECODES.
// ---------------------------------------------------------------------------
enum Decode : int {
  kEmi8 = 0,    // one byte (m̂ << (8 - mw)) | e' (emi8, emi8m)
  kInt8 = 1,    // int8 container: the code as it is
  kSb4 = 2,     // two sign-extended 4-bit int codes a byte
  kSb2 = 3,     // four sign-extended 2-bit int codes a byte
  kPf4 = 4,     // two raw 4-bit fp codes a byte
  kPf6 = 5,     // raw 6-bit fp codes: a 4-bit low plane and a 2-bit high one
  kBf16 = 6,    // bf16 container: the value as it is
  kFp16 = 7,    // fp16 container: the value rounded to bf16, as the TPU
                // kernel's astype(bfloat16)
  kFp8E4m3 = 8, // float8_e4m3fn container (fp8_e4m3; fp6 and fp4 codes
                // packed with transport "native"): the value as it is
  kFp8E5m2 = 9, // float8_e5m2 container (fp8_e5m2): the value as it is
};

// K rows that one packed row carries. Sub-byte layouts are blockwise
// interleaved (packing._subbyte_pack): in a block of B rows, K row j sits in
// field j / (B / F) of packed row j % (B / F).
template <int D>
__host__ __device__ constexpr int fields() {
  return (D == kSb4 || D == kPf4) ? 2 : (D == kSb2 || D == kPf6) ? 4 : 1;
}
template <int D>
__host__ __device__ constexpr int code_bytes() {
  return (D == kBf16 || D == kFp16) ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr bool is_fp8() {
  return D == kFp8E4m3 || D == kFp8E5m2;
}
// Packed rows of one block of B K rows (transport_rows_per_block).
template <int D>
__host__ __device__ constexpr int packed_rows(int B) {
  return D == kPf6 ? 3 * B / 4 : B / fields<D>();
}

// The low `bits` bits of v, sign-extended.
__device__ __forceinline__ int sext(int v, int bits) {
  return (v << (32 - bits)) >> (32 - bits);
}

// emi8 byte (sign-extended) -> m̂ · 2^e' (exact in f32 and bf16).
__device__ __forceinline__ float decode_emi8(int c, int mw) {
  const int sh = 8 - mw;
  return static_cast<float>((c >> sh) * (1 << (c & ((1 << sh) - 1))));
}

// Raw fp bits (sign-extended from the format's sign bit) -> the integer
// (m | implicit << mw) << (e - implicit) with the code's sign, as _sad_kernel
// (fold = emi8_fold(fmt) puts it back on the format's grid).
__device__ __forceinline__ float decode_pf(int c, int mw, int ebits) {
  const int e = (c >> mw) & ((1 << ebits) - 1);
  const int m = c & ((1 << mw) - 1);
  const int ne = min(e, 1);
  const int mag = (m | (ne << mw)) << (e - ne);
  return static_cast<float>(c < 0 ? -mag : mag);
}

// The 16 bits of a bf16 or fp16 code -> its value as the kernels use it.
template <int D>
__device__ __forceinline__ float decode_half(int h) {
  if constexpr (D == kBf16) {
    return __uint_as_float(static_cast<uint32_t>(h & 0xFFFF) << 16);
  } else {
    __half_raw r;
    r.x = static_cast<unsigned short>(h);
    return __bfloat162float(__float2bfloat16(__half2float(__half(r))));
  }
}

// n float8 codes (the sign-extended bytes that load_row gives) -> their
// values, two at a time through Hopper's paired float8 -> f16 convert. Every
// e4m3 and e5m2 value is an f16 value, so the decode is exact, and so is the
// value times a power of two in f32 or bf16.
template <int D, int n>
__device__ __forceinline__ void decode_fp8(const int c[n], float w[n]) {
  static_assert(is_fp8<D>() && n % 2 == 0, "pairs of float8 codes");
  constexpr __nv_fp8_interpretation_t kKind =
      D == kFp8E4m3 ? __NV_E4M3 : __NV_E5M2;
#pragma unroll
  for (int i = 0; i < n; i += 2) {
    const auto pair = static_cast<__nv_fp8x2_storage_t>(
        (c[i] & 0xFF) | ((c[i + 1] & 0xFF) << 8));     // code i in the low byte
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, kKind)));
    w[i] = f.x;
    w[i + 1] = f.y;
  }
}

// Field f of packed byte c of a one-byte-code transport (the sign-extended
// byte itself where a byte holds one code), decoded.
template <int D>
__device__ __forceinline__ float decode_field(int c, int f, int mw,
                                              int ebits) {
  static_assert(D == kEmi8 || D == kInt8 || D == kSb4 || D == kSb2
                || D == kPf4, "one-byte field decodes only");
  if constexpr (D == kEmi8)
    return decode_emi8(c, mw);
  else if constexpr (D == kInt8)
    return static_cast<float>(c);
  else if constexpr (D == kSb4)
    return static_cast<float>(sext(c >> (4 * f), 4));
  else if constexpr (D == kSb2)
    return static_cast<float>(sext(c >> (2 * f), 2));
  else
    return decode_pf(sext(c >> (4 * f), 4), mw, ebits);
}

// pf6: K row j of a block holds low field j / (B/2) of packed row j % (B/2)
// and high field j / (B/4) of packed row B/2 + j % (B/4).
__device__ __forceinline__ float decode_pf6(int lo, int flo, int hi, int fhi,
                                            int mw, int ebits) {
  const int c = (sext(hi >> (2 * fhi), 2) << 4) | ((lo >> (4 * flo)) & 0xF);
  return decode_pf(c, mw, ebits);
}

// n codes of one packed row from column col0 on, as sign-extended ints (the
// 16 raw bits for two-byte codes), 0 past column N. `vec` asks for one
// vector load: the caller has checked alignment (N % n == 0, col0 % n == 0).
template <int D, int n>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ codes,
                                         size_t row, int col0, int N,
                                         bool vec, int c[n]) {
  static_assert(n == 4 || n == 16, "4 or 16 columns");
  if constexpr (code_bytes<D>() == 1) {
    const int8_t* p = codes + row * N + col0;
    if (vec) {
      if constexpr (n == 4) {
        const char4 v = __ldg(reinterpret_cast<const char4*>(p));
        c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
      } else {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < n; ++j) c[j] = b[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < n; ++j) c[j] = (col0 + j < N) ? __ldg(p + j) : 0;
    }
  } else {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(codes) + row * N
                        + col0;
    if (vec) {
#pragma unroll
      for (int h = 0; h < n / 4; ++h) {      // 4 codes a load, low half first
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + h);
        c[4 * h] = v.x & 0xFFFF;
        c[4 * h + 1] = v.x >> 16;
        c[4 * h + 2] = v.y & 0xFFFF;
        c[4 * h + 3] = v.y >> 16;
      }
    } else {
#pragma unroll
      for (int j = 0; j < n; ++j) c[j] = (col0 + j < N) ? __ldg(p + j) : 0;
    }
  }
}

// Codes are in the pre-blocked serving layout (NB, rows, N). In block nb,
// K row j = g + f * (B / F) with g < B / F and field f < F. The scale is the
// caller's; columns past N decode to zero.

// The n decoded weights, columns col0.. col0 + n - 1, of the F K rows of
// group g of block nb: w[f] is K row g + f * (B / F). One load of each
// packed row serves every field in it.
template <int D, int n>
__device__ __forceinline__ void decode_group(const int8_t* __restrict__ codes,
                                             int nb, int g, int B, int col0,
                                             int N, bool vec, int mw,
                                             int ebits,
                                             float w[fields<D>()][n]) {
  const size_t base = static_cast<size_t>(nb) * packed_rows<D>(B);
  int c[n];
  load_row<D, n>(codes, base + g, col0, N, vec, c);
  if constexpr (D == kPf6) {
    int c2[n], hi[n];           // low plane rows g and g + B/4; high row
    load_row<D, n>(codes, base + g + B / 4, col0, N, vec, c2);
    load_row<D, n>(codes, base + B / 2 + g, col0, N, vec, hi);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      w[0][i] = decode_pf6(c[i], 0, hi[i], 0, mw, ebits);
      w[1][i] = decode_pf6(c2[i], 0, hi[i], 1, mw, ebits);
      w[2][i] = decode_pf6(c[i], 1, hi[i], 2, mw, ebits);
      w[3][i] = decode_pf6(c2[i], 1, hi[i], 3, mw, ebits);
    }
  } else if constexpr (code_bytes<D>() == 2) {
#pragma unroll
    for (int i = 0; i < n; ++i) w[0][i] = decode_half<D>(c[i]);
  } else if constexpr (is_fp8<D>()) {
    decode_fp8<D, n>(c, w[0]);
  } else {
#pragma unroll
    for (int f = 0; f < fields<D>(); ++f)
#pragma unroll
      for (int i = 0; i < n; ++i) w[f][i] = decode_field<D>(c[i], f, mw, ebits);
  }
}

// The n decoded weights of the single K row g + f * (B / F) of block nb.
template <int D, int n>
__device__ __forceinline__ void decode_row(const int8_t* __restrict__ codes,
                                           int nb, int g, int f, int B,
                                           int col0, int N, bool vec, int mw,
                                           int ebits, float w[n]) {
  const size_t base = static_cast<size_t>(nb) * packed_rows<D>(B);
  int c[n];
  if constexpr (D == kPf6) {
    int hi[n];
    load_row<D, n>(codes, base + g + (f & 1) * (B / 4), col0, N, vec, c);
    load_row<D, n>(codes, base + B / 2 + g, col0, N, vec, hi);
#pragma unroll
    for (int i = 0; i < n; ++i)
      w[i] = decode_pf6(c[i], f >> 1, hi[i], f, mw, ebits);
  } else if constexpr (is_fp8<D>()) {
    load_row<D, n>(codes, base + g, col0, N, vec, c);
    decode_fp8<D, n>(c, w);
  } else {
    load_row<D, n>(codes, base + g, col0, N, vec, c);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      if constexpr (code_bytes<D>() == 2)
        w[i] = decode_half<D>(c[i]);
      else
        w[i] = decode_field<D>(c[i], f, mw, ebits);
    }
  }
}

// out[m, n] = sum over splits s = 0, 1, ... of ws[(s * M + m) * ld + n], in
// that order, for n < N <= ld, times row_scale[m] where given: the
// fixed-order reduce of the K-split kernels, so a row's result depends
// neither on the other rows nor on M.
static __global__ void split_reduce(const float* __restrict__ ws, void* out,
                                    int M, int ld, int N, int ksplit,
                                    int out_bf16,
                                    const float* __restrict__ row_scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i - m * N;
  float s = 0.f;
  for (int sp = 0; sp < ksplit; ++sp)
    s += ws[(static_cast<size_t>(sp) * M + m) * ld + n];
  if (row_scale != nullptr) s *= row_scale[m];
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(s);
  else
    static_cast<float*>(out)[i] = s;
}

// Launches split_reduce on st; returns the cudaError_t of the launch.
static inline int launch_split_reduce(const float* ws, void* out, int M,
                                      int ld, int N, int ksplit, int out_bf16,
                                      cudaStream_t st,
                                      const float* row_scale = nullptr) {
  const int total = M * N;
  split_reduce<<<(total + 255) / 256, 256, 0, st>>>(ws, out, M, ld, N, ksplit,
                                                    out_bf16, row_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 tensor-core GEMM tile, y = x @ W with W decoded into shared memory
// ---------------------------------------------------------------------------
// A block of 8 warps computes a 128 x 128 tile of y; each warp owns 64 x 32
// of it as 4 x 2 wmma 16x16x16 bf16 fragments with f32 accumulators. Per
// 32-deep K step the block copies x into As and the caller's decode fills
// Bs[k][n] with the bf16 weights of rows k0..k0+31 and the tile's 128
// columns (zeros outside the weight). Ragged M and K are masked on the x
// side; the epilogue stores only m < M, n < N.
constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 32;
constexpr int kGemmThreads = 256;
constexpr int kGemmPad = 8;                   // keeps wmma ldm a multiple of 8
using BTile = __nv_bfloat16 (*)[kGemmBN + kGemmPad];

// decode_b(Bs, k0): fills the B tile of K step k0 (called by all threads).
template <class DecodeB>
__device__ __forceinline__ void gemm_tile(const __nv_bfloat16* __restrict__ x,
                                          void* out, int M, int K, int N,
                                          int k_end, int out_bf16,
                                          DecodeB decode_b) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[kGemmBM][kGemmBK + kGemmPad];
  __shared__ __align__(128) __nv_bfloat16 Bs[kGemmBK][kGemmBN + kGemmPad];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;    // 2 x 4 warps
  const int m_blk = blockIdx.y * kGemmBM, n_blk = blockIdx.x * kGemmBN;
  const bool kvec = (K % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // x tile: thread -> row tid/2, 16 columns
  const int a_r = tid >> 1, a_c = (tid & 1) * 16;
  for (int k0 = 0; k0 < k_end; k0 += kGemmBK) {
    const int gm = m_blk + a_r;
    const int gk = k0 + a_c;
    if (kvec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gm < M && gk + h * 8 < K)
          v = __ldg(reinterpret_cast<const uint4*>(
              x + static_cast<size_t>(gm) * K + gk + h * 8));
        *reinterpret_cast<uint4*>(&As[a_r][a_c + h * 8]) = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (gm < M && gk + j < K) v = x[static_cast<size_t>(gm) * K + gk + j];
        As[a_r][a_c + j] = v;
      }
    }
    decode_b(Bs, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk],
                               kGemmBK + kGemmPad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16],
                               kGemmBN + kGemmPad);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m_blk + wm * 64 + i * 16;
      const int c0 = n_blk + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gm = r0 + (e >> 4), gn = c0 + (e & 15);
        if (gm < M && gn < N) {
          const size_t o = static_cast<size_t>(gm) * N + gn;
          if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(cs[e]);
          else
            static_cast<float*>(out)[o] = cs[e];
        }
      }
      __syncwarp();
    }
  }
}

// The grid of gemm_tile for an (M, N) output.
static inline dim3 gemm_grid(int M, int N) {
  return dim3((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
}

}  // namespace mxq
