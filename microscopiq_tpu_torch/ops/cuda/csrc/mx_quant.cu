// MX block quantizer on the last axis: float32 in; container codes and int8
// shared exponents out, bit-exact to pack_mx(..., exact_scale=True).
//
// Replaces microscopiq_tpu/ops/pallas/mx_quant.py::_quantize_block_kernel
// (wrapper quantize_mx_pallas), which itself replaced the reference's CUDA
// tile quantizer (one warp per row segment, __shfl_xor_sync for the block
// max); this kernel has that shape again.
//
// What bounds it on the H100: bytes. Each element is read once (4 bytes)
// and written once (1 or 2 bytes of code, plus one exponent byte per
// block), for a few dozen integer and float operations: far below the
// card's operation rate. The bound is (4 + code bytes + 1/B) bytes per
// element / 3.35 TB/s.
//
// Design:
// - each row of the (M, Kp) output (Kp = K padded to B) is cut into whole
//   blocks; a warp takes 32 consecutive elements of a row (B <= 32,
//   32 % B == 0: 32 / B blocks a warp) or one block of B = 32 * j elements
//   (j per lane), so neighbouring lanes read neighbouring floats. Elements
//   past K read as zero (the TPU wrapper's padding), and the block max is a
//   butterfly of __shfl_xor_sync over the block's lanes. No division by the
//   row length: grid.y walks the rows.
// - the arithmetic is the TPU kernel's, step by step: floor(log2) by bit
//   extraction (subnormal amax included), amax == 0 -> 2^-126, the scale
//   exponent clamped to +-(2^(scale_bits-1) - 1), x scaled by the exact
//   2^-se, the private exponent floored at 2 - 2^(ebits-1), rounding half
//   away from zero by floor(|x| * up + 0.5), clipping to max_norm; int codes
//   are rint(q * 2^(mbits-2)) (half to even, as jnp.round), float codes the
//   container's conversion of q (exact: q is on the format's grid). Each
//   power of two is applied as the plain version's two exact half factors:
//   where an exponent passes 126 (the bfloat16 format's shared scale) the
//   TPU kernel's single clamped 2^e departs from pack_mx, and this kernel
//   keeps to pack_mx.
// - built without --use_fast_math (build.py), so no flush of subnormals and
//   IEEE rounding in every multiply.
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

using mxq::exp2_i32;

// Container kinds: the ids of mx_quant.py's _CONTAINERS.
enum Container : int { kCInt8 = 0, kCE4m3 = 1, kCE5m2 = 2, kCF16 = 3,
                       kCBf16 = 4 };

// Exact floor(log2(x)) for x >= 0 from its bits (_floor_log2_f32):
// normal -> biased - 127, subnormal -> bit length(mantissa) - 150.
__device__ __forceinline__ int floor_log2(float x) {
  const int bits = __float_as_int(x);
  const int biased = (bits >> 23) & 0xFF;
  const int mant = bits & 0x7FFFFF;
  return biased > 0 ? biased - 127 : (32 - __clz(mant)) - 150;
}

// jnp.sign: -1, +1, or the zero itself (its sign kept).
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
}

// x * 2^e for |e| <= 254 as two exact half-exponent factors, in the order
// of the plain version's mul_pow2 (no power of two is ever clamped; no
// contraction into an FMA).
__device__ __forceinline__ float mul_pow2(float x, int e) {
  const int e1 = e / 2;                      // truncates, as torch.trunc
  return __fmul_rn(__fmul_rn(x, exp2_i32(e1)), exp2_i32(e - e1));
}

template <int C>
__device__ __forceinline__ void store_code(void* codes, size_t i, float q,
                                           int mbits) {
  if constexpr (C == kCInt8) {
    static_cast<int8_t*>(codes)[i] = static_cast<int8_t>(
        static_cast<int>(rintf(q * exp2_i32(mbits - 2))));
  } else if constexpr (C == kCE4m3) {
    static_cast<__nv_fp8_storage_t*>(codes)[i] =
        __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);
  } else if constexpr (C == kCE5m2) {
    static_cast<__nv_fp8_storage_t*>(codes)[i] =
        __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E5M2);
  } else if constexpr (C == kCF16) {
    static_cast<__half*>(codes)[i] = __float2half_rn(q);
  } else {
    static_cast<__nv_bfloat16*>(codes)[i] = __float2bfloat16_rn(q);
  }
}

constexpr int kChunks = 8;       // consecutive 32 * per chunks a warp takes

// grid: (ceil(chunks a row / (8 * kChunks)), min(M, 65535)), 8 warps a
// block. Chunk c of a row holds columns c * 32 * per + j * 32 + lane, j <
// per = max(1, B/32): whole blocks, since Kp % B == 0 and either B divides
// 32 or 32 divides B. A warp takes kChunks neighbouring chunks of a row, so
// that a block lives long enough to hide its launch; rows past gridDim.y
// are taken by a stride loop.
template <int C>
__global__ void __launch_bounds__(256)
quantize_block(const float* __restrict__ x, void* codes,
               int8_t* __restrict__ se_out, int M, int K, int Kp, int B,
               int per, int scale_bits, int ebits, int mbits, int emax,
               float max_norm) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp * kChunks * 32 * per >= Kp) return;  // whole warp leaves together
  const int width = min(B, 32);              // lanes of one block
  const bool head = per == 1 ? (lane % width) == 0 : lane == 0;
  const int nbr = Kp / B;                    // blocks a row
  const int scale_emax = (1 << (scale_bits - 1)) - 1;
  const float grid = exp2_i32(mbits - 2);
  const float ungrid = exp2_i32(2 - mbits);
  const int pe_min = ebits > 0 ? 2 - (1 << (ebits - 1)) : 0;

  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    for (int c = 0; c < kChunks; ++c) {
      const int chunk = warp * kChunks + c;
      const int kbase = chunk * 32 * per;
      if (kbase >= Kp) break;
      // per <= 8 (B <= 256) elements a lane
      float v[8];
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = 0.f;
        if (j < per) {
          const int k = kbase + j * 32 + lane;
          if (k < K) v[j] = x[static_cast<size_t>(m) * K + k];
          amax = fmaxf(amax, fabsf(v[j]));
        }
      }
      for (int off = width >> 1; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

      if (amax == 0.f) amax += exp2_i32(-126);
      const int se = max(-scale_emax,
                         min(scale_emax, floor_log2(amax) - emax));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = kbase + j * 32 + lane;
        if (j >= per || k >= Kp) break;
        const float xs = mul_pow2(v[j], -se);
        float q;
        if (ebits > 0) {
          const int pe = max(
              floor_log2(fabsf(xs) + (xs == 0.f ? 1.f : 0.f)), pe_min);
          const float t = __fmul_rn(mul_pow2(xs, -pe), grid);
          const float r = sign_of(t) * floorf(fabsf(t) + 0.5f);
          q = mul_pow2(__fmul_rn(r, ungrid), pe);
        } else {
          const float t = __fmul_rn(xs, grid);
          q = __fmul_rn(sign_of(t) * floorf(fabsf(t) + 0.5f), ungrid);
        }
        q = fminf(fmaxf(q, -max_norm), max_norm);
        store_code<C>(codes, static_cast<size_t>(m) * Kp + k, q, mbits);
      }
      // this lane's block within the row writes its exponent once
      if (head && kbase + lane < Kp) {
        const int blk = per == 1 ? (kbase + lane) / B : chunk;
        se_out[static_cast<size_t>(m) * nbr + blk] = static_cast<int8_t>(se);
      }
    }
  }
}

}  // namespace

// x: (M, K) f32; codes: (M, Kp) in the container (1 or 2 bytes); se: (M,
// Kp / B) int8; B <= 32 with 32 % B == 0, or B % 32 == 0 and B <= 256;
// container: an id of Container. Returns the cudaError_t of the launch (0
// on success; cudaErrorInvalidValue for another container or block size).
extern "C" int quantize_mx_block(const void* x, void* codes, void* se, int M,
                                 int K, int Kp, int B, int container,
                                 int scale_bits, int ebits, int mbits,
                                 int emax, float max_norm, void* stream) {
  const bool small = B <= 32 && 32 % B == 0;
  const bool large = B % 32 == 0 && B <= 256;
  if (!(small || large)) return static_cast<int>(cudaErrorInvalidValue);
  const int per = small ? 1 : B / 32;
  if (M == 0 || Kp == 0) return 0;
  const int chunks = (Kp + 32 * per - 1) / (32 * per);      // a row
  const int per_block = 8 * kChunks;                         // 8 warps
  const dim3 grid((chunks + per_block - 1) / per_block,
                  M < 65535 ? M : 65535);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  auto* sp = static_cast<int8_t*>(se);
#define MXQ_QUANT(C)                                                     \
  quantize_block<C><<<grid, 256, 0, st>>>(xp, codes, sp, M, K, Kp, B, per, \
                                          scale_bits, ebits, mbits, emax,  \
                                          max_norm)
  switch (container) {
    case kCInt8: MXQ_QUANT(kCInt8); break;
    case kCE4m3: MXQ_QUANT(kCE4m3); break;
    case kCE5m2: MXQ_QUANT(kCE5m2); break;
    case kCF16: MXQ_QUANT(kCF16); break;
    case kCBf16: MXQ_QUANT(kCBf16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXQ_QUANT
  return static_cast<int>(cudaGetLastError());
}
