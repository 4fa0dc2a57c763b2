// MX block quantizer on the last axis: float32 in; container codes and int8
// shared exponents out, bit-exact to pack_mx(..., exact_scale=True).
//
// Replaces microscopiq_tpu/ops/pallas/mx_quant.py::_quantize_block_kernel
// (wrapper quantize_mx_pallas).
//
// What bounds it on the H100: bytes. Each element is read once (4 bytes)
// and written once (1 or 2 bytes of code, plus one exponent byte per
// block), for a few dozen integer and float operations. The bound is
// (4 + code bytes + 1/B) bytes per element / 3.35 TB/s.
//
// Design (a streaming pass):
// - a warp step covers 128 consecutive columns of one row (one block at
//   B = 96, 160, 192, 224 and 256, see Geom): each lane takes a quad of 4
//   consecutive floats with one 16-byte load that does not allocate in L1
//   (read once), so a block of B >= 4 spans B / 4 lanes (B = 32: 8 lanes,
//   a 3-step __shfl_xor_sync butterfly) and a block of B < 4 lies inside
//   one lane's quad. Steps start at multiples of their width and Kp is a
//   multiple of B, so every block lies in one step.
// - the loads of kSteps steps (4; 2 above 128 columns a step) are issued
//   before any of their arithmetic: 64 bytes a lane in flight.
// - the grid is persistent (as many CTAs as the card holds at once); each
//   warp walks (row, kSteps-step segment) items with a fixed stride, kept
//   as a (rows, segments) pair: no division by the row length in the loop.
// - stores are wide: a lane's 4 one-byte codes in one 32-bit store (four
//   two-byte codes in one 64-bit store); the block exponents of a step are
//   gathered by shuffle and written 4 bytes a store.
// - rows whose base is not 16-byte aligned (K not a multiple of 4), the
//   quad that crosses K and codes or exponents whose address is not aligned
//   take the scalar loads and stores of the same lanes (head and tail).
// - the arithmetic is the TPU kernel's, step by step: floor(log2) by bit
//   extraction (subnormal amax included), amax == 0 -> 2^-126, the scale
//   exponent clamped to +-(2^(scale_bits-1) - 1), x scaled by the exact
//   2^-se, the private exponent floored at 2 - 2^(ebits-1), rounding half
//   away from zero by floor(|x| * up + 0.5), clipping to max_norm; int codes
//   are rint(q * 2^(mbits-2)) (half to even, as jnp.round), float codes the
//   container's conversion of q (exact: q is on the format's grid).
//   The plain version applies each power of two as two exact half factors.
//   Two factors give another result than one only where the first product
//   rounds, i.e. where it is subnormal. So each power of two here is one
//   multiply by an exact (possibly subnormal) 2^e, except in the one place
//   where the first half product can be subnormal: x * 2^-se with se > 0
//   and |x| < 2^(-126 - trunc(-se / 2)), which keeps the two factors. The
//   other two are provably single roundings: x * 2^-pe scales up or lands
//   in [1, 2), and (r * 2^(2-mbits)) * 2^pe has a half product of at least
//   2^-85.
// - built without --use_fast_math (build.py), so no flush of subnormals and
//   IEEE rounding in every multiply.
#include <cuda_fp8.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

// Container kinds: the ids of mx_quant.py's _CONTAINERS.
enum Container : int { kCInt8 = 0, kCE4m3 = 1, kCE5m2 = 2, kCF16 = 3,
                       kCBf16 = 4 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The format, constant over the launch.
struct Fmt {
  int ebits;        // 0: an int format
  int emax;         // the element format's largest exponent
  int scale_emax;   // 2^(scale_bits - 1) - 1
  int pe_min;       // 2 - 2^(ebits - 1) (float formats)
  float grid;       // 2^(mbits - 2)
  float ungrid;     // 2^(2 - mbits)
  float max_norm;
  float lo, up;     // 2^pe_min, 2^-pe_min (float formats)
  int half, keep;   // half the kept last mantissa bit; the kept bits' mask
};

// Geometry of a block size B (a divisor of 32, or a multiple of 32 <= 256).
// Powers of two up to 128 tile a 128-column step; the other multiples of
// 32 (96, 160, 192, 224) and 256 take one block a step, ceil(B / 128)
// quads a lane, the quads past B idle.
template <int B>
struct Geom {
  static constexpr bool kOne = B > 128 || 128 % B != 0;  // one block a step
  static constexpr int kWidth = kOne ? B : 128;          // columns a step
  static constexpr int kQuads = (kWidth + 127) / 128;    // quads a lane
  static constexpr int kSteps = kQuads > 1 ? 2 : 4;      // steps in flight
  static constexpr int kLanes = kOne ? 32 : (B >= 4 ? B / 4 : 1);
  static constexpr int kQuadBlocks = B < 4 ? 4 / B : 1;  // blocks in a quad
  static constexpr int kSub = B < 4 ? B : 4;             // a quad's block part
  static constexpr int kBlocks = kWidth / B;             // blocks a step
};

// Exact 2^e as a float for e in [-149, 127] (subnormal below -126).
__device__ __forceinline__ float pow2f(int e) {
  return e >= -126 ? __int_as_float((e + 127) << 23)
                   : __int_as_float(1 << (e + 149));
}

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
// of the plain version's mul_pow2 (truncating e / 2, as torch.trunc).
__device__ __forceinline__ float mul_pow2(float x, int e) {
  const int e1 = e / 2;
  return __fmul_rn(__fmul_rn(x, pow2f(e1)), pow2f(e - e1));
}

// A float4 from device memory without allocating in L1 (read once).
__device__ __forceinline__ float4 ld_stream(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Columns c..c+3 of a row, zero past K: one 16-byte load where the row is
// aligned and the quad lies below K, else scalar loads.
__device__ __forceinline__ void load_quad(const float* row, int c, int K,
                                          bool vec, float (&v)[4]) {
  if (vec && c + 4 <= K) {
    const float4 t = ld_stream(row + c);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < K ? __ldg(row + c + j) : 0.f;
  }
}

// The block's shared exponent from its max magnitude.
__device__ __forceinline__ int block_exp(float amax, const Fmt& f) {
  if (amax == 0.f) amax += pow2f(-126);
  return max(-f.scale_emax, min(f.scale_emax, floor_log2(amax) - f.emax));
}

// One element: x scaled by 2^e (e = -se; s = 2^e; thr = the magnitude below
// which the first half product of mul_pow2 would be subnormal), quantized
// to the element format and clipped.
//
// A float format rounds |xs| to k = mbits - 2 fraction bits, half away from
// zero: where 2^pe_min <= |xs| < 2^127 the private exponent is xs's own and
// floor(|xs| 2^(k - pe) + 0.5) 2^(pe - k) is the bit pattern of |xs| plus
// half the kept last bit, the lower bits cleared (a carry moves into the
// exponent as the float sum does); below 2^pe_min the grid is fixed,
// 2^(pe_min - k), and the plain version's products are exact. The rest
// (|xs| >= 2^127, inf, NaN) takes the plain version's steps.
__device__ __forceinline__ float quant_elem(float v, int e, float s,
                                            float thr, const Fmt& f) {
  float xs = __fmul_rn(v, s);
  if (e < 0 && fabsf(v) < thr && v != 0.f) xs = mul_pow2(v, e);
  float q;
  if (f.ebits > 0) {
    const float a = fabsf(xs);
    if (a < f.lo) {
      const float t = __fmul_rn(__fmul_rn(a, f.up), f.grid);
      q = copysignf(__fmul_rn(__fmul_rn(floorf(__fadd_rn(t, 0.5f)),
                                        f.ungrid), f.lo),
                    xs);
    } else if (a < 0x1p127f) {
      q = copysignf(__int_as_float((__float_as_int(a) + f.half) & f.keep),
                    xs);
    } else {
      const int pe = max(floor_log2(a), f.pe_min);
      const float t = __fmul_rn(__fmul_rn(xs, pow2f(-pe)), f.grid);
      const float r = sign_of(t) * floorf(fabsf(t) + 0.5f);
      q = __fmul_rn(__fmul_rn(r, f.ungrid), pow2f(pe));
    }
  } else {
    const float t = __fmul_rn(xs, f.grid);
    q = __fmul_rn(sign_of(t) * floorf(fabsf(t) + 0.5f), f.ungrid);
  }
  return fminf(fmaxf(q, -f.max_norm), f.max_norm);
}

// A quad's codes in the container, packed little-endian: x holds four
// 1-byte codes, or x and y four 2-byte codes. The float8 containers
// convert two values an instruction.
template <int C>
__device__ __forceinline__ uint2 pack_codes(const float (&q)[4],
                                            const Fmt& f) {
  if constexpr (C == kCInt8) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(
               static_cast<int>(rintf(q[j] * f.grid)))))
           << (8 * j);
    return make_uint2(w, 0u);
  } else if constexpr (C == kCE4m3 || C == kCE5m2) {
    constexpr __nv_fp8_interpretation_t kind =
        C == kCE4m3 ? __NV_E4M3 : __NV_E5M2;
    const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(q[0], q[1]),
                                                 __NV_SATFINITE, kind);
    const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(q[2], q[3]),
                                                 __NV_SATFINITE, kind);
    return make_uint2(lo | (hi << 16), 0u);
  } else if constexpr (C == kCF16) {
    const __half2 lo = __floats2half2_rn(q[0], q[1]);
    const __half2 hi = __floats2half2_rn(q[2], q[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(q[0], q[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(q[2], q[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <int C>
__host__ __device__ constexpr int code_bytes() {
  return C == kCF16 || C == kCBf16 ? 2 : 1;
}

// Codes of columns c..c+3 of a row of Kp: one 32-bit (64-bit for 2-byte
// codes) store where aligned and below Kp, else one store a code.
template <int C>
__device__ __forceinline__ void store_quad(char* crow, int c, int Kp,
                                           uint2 w) {
  constexpr int CB = code_bytes<C>();
  char* dst = crow + static_cast<size_t>(c) * CB;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(dst) & (4 * CB - 1)) == 0;
  if (aligned && c + 4 <= Kp) {
    if constexpr (CB == 1) {
      *reinterpret_cast<uint32_t*>(dst) = w.x;
    } else {
      *reinterpret_cast<uint2*>(dst) = w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j >= Kp) break;
      if constexpr (CB == 1) {
        dst[j] = static_cast<char>(w.x >> (8 * j));
      } else {
        reinterpret_cast<uint16_t*>(dst)[j] =
            static_cast<uint16_t>((j < 2 ? w.x : w.y) >> (16 * (j & 1)));
      }
    }
  }
}

// Exponent bytes word[0..n) at dst: one 32-bit (16-bit) store where n is 4
// (2) and dst aligned, else one store a byte.
__device__ __forceinline__ void store_exps(int8_t* dst, uint32_t word, int n,
                                           int width) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (n == 4 && width == 4 && (a & 3) == 0) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else if (n == 2 && width == 2 && (a & 1) == 0) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(word);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = static_cast<int8_t>(word >> (8 * i));
  }
}

// grid: persistent, kThreads a CTA. Item (m, seg) is row m's columns
// [seg * kSteps * kWidth, (seg + 1) * kSteps * kWidth): kSteps warp steps.
template <int C, int B>
__global__ void __launch_bounds__(kThreads)
quantize_rows(const float* __restrict__ x, void* __restrict__ codes,
              int8_t* __restrict__ se_out, int M, int K, int Kp, int segs,
              Fmt f) {
  using G = Geom<B>;
  constexpr int CB = code_bytes<C>();
  const int lane = threadIdx.x & 31;
  const int gw = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int nw = (gridDim.x * kThreads) >> 5;
  const int nbr = Kp / B;                       // blocks a row
  // (m, seg) = divmod(item, segs), advanced by the stride nw = (dm, dseg)
  int m = gw / segs, seg = gw - (gw / segs) * segs;
  const int dm = nw / segs, dseg = nw - (nw / segs) * segs;

  for (; m < M; m += dm, seg += dseg) {
    if (seg >= segs) { seg -= segs; ++m; if (m >= M) break; }
    const float* xrow = x + static_cast<size_t>(m) * K;
    char* crow = static_cast<char*>(codes) + static_cast<size_t>(m) * Kp * CB;
    int8_t* erow = se_out + static_cast<size_t>(m) * nbr;
    const bool vec = (reinterpret_cast<uintptr_t>(xrow) & 15) == 0;
    const int c_item = seg * G::kSteps * G::kWidth;

    // every load of the item before any arithmetic
    float v[G::kSteps][G::kQuads][4];
#pragma unroll
    for (int u = 0; u < G::kSteps; ++u) {
#pragma unroll
      for (int qd = 0; qd < G::kQuads; ++qd) {
        const int off = qd * 128 + 4 * lane;     // column in the step
        const int c = c_item + u * G::kWidth + off;
        if (off < G::kWidth && c < K) {
          load_quad(xrow, c, K, vec, v[u][qd]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[u][qd][j] = 0.f;
        }
      }
    }

#pragma unroll
    for (int u = 0; u < G::kSteps; ++u) {
      const int c0 = c_item + u * G::kWidth;
      if (c0 >= Kp) break;                      // the whole warp together
      // the shared exponent of each block that this lane's quad holds
      int se[G::kQuadBlocks];
#pragma unroll
      for (int b = 0; b < G::kQuadBlocks; ++b) {
        float a = 0.f;
#pragma unroll
        for (int qd = 0; qd < G::kQuads; ++qd) {
#pragma unroll
          for (int j = b * G::kSub; j < (b + 1) * G::kSub; ++j)
            a = fmaxf(a, fabsf(v[u][qd][j]));
        }
#pragma unroll
        for (int off = G::kLanes >> 1; off > 0; off >>= 1)
          a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
        se[b] = block_exp(a, f);
      }
      // per block: 2^-se, and where the two half factors must stay
      float s[G::kQuadBlocks], thr[G::kQuadBlocks];
#pragma unroll
      for (int b = 0; b < G::kQuadBlocks; ++b) {
        s[b] = pow2f(-se[b]);
        thr[b] = se[b] > 0 ? pow2f(-126 - (-se[b]) / 2) : 0.f;
      }
#pragma unroll
      for (int qd = 0; qd < G::kQuads; ++qd) {
        const int off = qd * 128 + 4 * lane;
        const int c = c0 + off;
        if (off >= G::kWidth || c >= Kp) continue;
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = j / G::kSub;
          q[j] = quant_elem(v[u][qd][j], -se[b], s[b], thr[b], f);
        }
        store_quad<C>(crow, c, Kp, pack_codes<C>(q, f));
      }
      // exponents of the step's blocks, gathered 4 a lane
      const int blk0 = c0 / B;                  // first block of the step
      if constexpr (B >= 4) {
        const int nblk = min(G::kBlocks, (Kp - c0) / B);
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int blk = 4 * lane + i;
          const int e = __shfl_sync(kFull, se[0], (blk * G::kLanes) & 31);
          if (blk < G::kBlocks)
            word |= static_cast<uint32_t>(e & 0xff) << (8 * i);
        }
        if (4 * lane < nblk)
          store_exps(erow + blk0 + 4 * lane, word,
                     min(4, nblk - 4 * lane), 4);
      } else {
        const int c = c0 + 4 * lane;
        if (c < Kp) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < G::kQuadBlocks; ++b)
            word |= static_cast<uint32_t>(se[b] & 0xff) << (8 * b);
          store_exps(erow + c / B, word,
                     min(G::kQuadBlocks, (Kp - c) / B), G::kQuadBlocks);
        }
      }
    }
  }
}

template <int C, int B>
int launch(const float* x, void* codes, int8_t* se, int M, int K, int Kp,
           const Fmt& f, cudaStream_t st) {
  using G = Geom<B>;
  const int steps = (Kp + G::kWidth - 1) / G::kWidth;
  const int segs = (steps + G::kSteps - 1) / G::kSteps;
  const long long items = static_cast<long long>(M) * segs;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_rows<C, B>,
                                                kThreads, 0);
  const long long want = (items + kWarps - 1) / kWarps;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  const int grid = static_cast<int>(want < most ? want : most);
  quantize_rows<C, B><<<grid, kThreads, 0, st>>>(x, codes, se, M, K, Kp,
                                                 segs, f);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_block(int B, const float* x, void* codes, int8_t* se, int M,
                 int K, int Kp, const Fmt& f, cudaStream_t st) {
  switch (B) {
    case 1: return launch<C, 1>(x, codes, se, M, K, Kp, f, st);
    case 2: return launch<C, 2>(x, codes, se, M, K, Kp, f, st);
    case 4: return launch<C, 4>(x, codes, se, M, K, Kp, f, st);
    case 8: return launch<C, 8>(x, codes, se, M, K, Kp, f, st);
    case 16: return launch<C, 16>(x, codes, se, M, K, Kp, f, st);
    case 32: return launch<C, 32>(x, codes, se, M, K, Kp, f, st);
    case 64: return launch<C, 64>(x, codes, se, M, K, Kp, f, st);
    case 96: return launch<C, 96>(x, codes, se, M, K, Kp, f, st);
    case 128: return launch<C, 128>(x, codes, se, M, K, Kp, f, st);
    case 160: return launch<C, 160>(x, codes, se, M, K, Kp, f, st);
    case 192: return launch<C, 192>(x, codes, se, M, K, Kp, f, st);
    case 224: return launch<C, 224>(x, codes, se, M, K, Kp, f, st);
    case 256: return launch<C, 256>(x, codes, se, M, K, Kp, f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (M, K) f32; codes: (M, Kp) in the container (1 or 2 bytes); se: (M,
// Kp / B) int8; B a divisor of 32 or a multiple of 32 up to 256;
// container: an id of Container. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for
// another container or block size).
extern "C" int quantize_mx_block(const void* x, void* codes, void* se, int M,
                                 int K, int Kp, int B, int container,
                                 int scale_bits, int ebits, int mbits,
                                 int emax, float max_norm, void* stream) {
  if (M == 0 || Kp == 0) return 0;
  Fmt f;
  f.ebits = ebits;
  f.emax = emax;
  f.scale_emax = (1 << (scale_bits - 1)) - 1;
  f.pe_min = ebits > 0 ? 2 - (1 << (ebits - 1)) : 0;
  f.grid = ldexpf(1.f, mbits - 2);
  f.ungrid = ldexpf(1.f, 2 - mbits);
  f.max_norm = max_norm;
  f.lo = ldexpf(1.f, f.pe_min);
  f.up = ldexpf(1.f, -f.pe_min);
  const int drop = 23 - (mbits - 2);          // mantissa bits rounded off
  f.half = ebits > 0 ? 1 << (drop - 1) : 0;
  f.keep = ebits > 0 ? ~((1 << drop) - 1) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  auto* sp = static_cast<int8_t*>(se);
  switch (container) {
    case kCInt8: return launch_block<kCInt8>(B, xp, codes, sp, M, K, Kp, f, st);
    case kCE4m3: return launch_block<kCE4m3>(B, xp, codes, sp, M, K, Kp, f, st);
    case kCE5m2: return launch_block<kCE5m2>(B, xp, codes, sp, M, K, Kp, f, st);
    case kCF16: return launch_block<kCF16>(B, xp, codes, sp, M, K, Kp, f, st);
    case kCBf16: return launch_block<kCBf16>(B, xp, codes, sp, M, K, Kp, f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
