// Native MX packing codec (host side), the PyTorch port's own copy of
// microscopiq_tpu/native/mx_codec.cpp.
//
// Counterpart of the reference's C++ CPU quantizer
// (number_system/mx/cpp/funcs.cpp:26-133 quantize_mx_func_cpp +
// shared_exp.cuh scale logic): multithreaded block quantization of fp32
// weight buffers into container codes + int8 shared exponents, used for
// fast offline checkpoint conversion (an 8B model packs in seconds
// instead of minutes of single-threaded Python).
//
// Semantics are bit-identical to microscopiq_tpu_torch.ops.packing.pack_mx
// (exact_scale=True): shared exponent = floor(log2(max|x|)) - emax clamped
// to scale_bits, exact power-of-two scaling, private-exponent elementwise
// quantization with round-nearest, saturation to max_norm. Containers:
// int8 mantissa codes for int formats, fp8-e4m3 bytes for fp formats.
//
// Built by microscopiq_tpu_torch/native/__init__.py at first use:
// g++ -O3 -march=native -shared -fPIC -o _build/libmxcodec-<hash>.so
//     mx_codec.cpp -lpthread
// and called through ctypes.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Format {
  int ebits, mbits, emax;
  float max_norm;
  bool is_int;
  // container byte layout: e4m3 for every sub-byte fp format (each such
  // value is exactly representable there), e5m2 for fp8_e5m2 itself —
  // mirrors packing.py container_dtype
  int c_ebits, c_fbits;
};

// mirrors formats.py:_FORMAT_TABLE
Format format_params(int fmt_id) {
  switch (fmt_id) {
    case 0: return {0, 8, 0, 127.f / 64.f, true, 0, 0};    // int8
    case 1: return {0, 4, 0, 7.f / 4.f, true, 0, 0};       // int4
    case 2: return {0, 2, 0, 1.f, true, 0, 0};             // int2
    case 3: return {4, 5, 8, 448.f, false, 4, 3};          // fp8_e4m3
    case 4: return {5, 4, 15, 57344.f, false, 5, 2};       // fp8_e5m2
    case 5: return {3, 4, 4, 28.f, false, 4, 3};           // fp6_e3m2
    case 6: return {2, 5, 2, 7.5f, false, 4, 3};           // fp6_e2m3
    case 7: return {2, 3, 2, 6.f, false, 4, 3};            // fp4_e2m1
    default: return {0, 8, 0, 127.f / 64.f, true, 0, 0};
  }
}

inline int floor_log2(float x) {
  // exact floor(log2(|x|)) via bit extraction (quantize.cuh semantics)
  uint32_t bits;
  std::memcpy(&bits, &x, 4);
  int biased = (bits >> 23) & 0xFF;
  uint32_t mant = bits & 0x7FFFFF;
  if (biased > 0) return biased - 127;
  if (mant == 0) return -150;
  int bitlen = 32 - __builtin_clz(mant);
  return bitlen - 150;
}

inline float exp2i(int e) {
  // exact 2^e for e in [-126, 127]
  if (e < -126) e = -126;
  if (e > 127) e = 127;
  uint32_t bits = (uint32_t)(e + 127) << 23;
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline float quantize_elem(float x, const Format& f) {
  // private exponent + mantissa shift + round-nearest + saturate
  // (elemwise_ops.py:84-174 semantics, allow_denorm, saturate)
  float out = x;
  if (f.ebits != 0) {
    float ax = std::fabs(x);
    int pe = floor_log2(ax + (x == 0.f ? 1.f : 0.f));
    int min_exp = -(1 << (f.ebits - 1)) + 2;
    if (pe < min_exp) pe = min_exp;
    float up = exp2i(-pe) * (float)(1 << (f.mbits - 2));
    float down = exp2i(pe) / (float)(1 << (f.mbits - 2));
    float scaled = out * up;
    float r = (scaled >= 0 ? std::floor(scaled + 0.5f)
                           : -std::floor(-scaled + 0.5f));
    out = r * down;
  } else {
    float scaled = out * (float)(1 << (f.mbits - 2));
    float r = (scaled >= 0 ? std::floor(scaled + 0.5f)
                           : -std::floor(-scaled + 0.5f));
    out = r / (float)(1 << (f.mbits - 2));
  }
  if (out > f.max_norm) out = f.max_norm;
  if (out < -f.max_norm) out = -f.max_norm;
  return out;
}

inline uint8_t encode_fp8(float v, int ebits, int fbits) {
  // exact fp8 byte for values already on the format's grid (packing.py
  // container trick); ebits/fbits select e4m3fn (4,3) or e5m2 (5,2)
  int bias = (1 << (ebits - 1)) - 1;
  int min_e = 1 - bias;
  if (v == 0.f) return std::signbit(v) ? 0x80 : 0x00;
  uint8_t sign = v < 0.f ? 0x80 : 0x00;
  float a = std::fabs(v);
  int e = floor_log2(a);
  if (e < min_e) e = min_e;
  float fscale = (float)(1 << fbits);
  float frac;
  uint8_t e_field;
  if (a < exp2i(min_e)) {       // subnormal: m/2^fbits * 2^min_e
    e_field = 0;
    frac = a * exp2i(-min_e) * fscale;
  } else {
    e_field = (uint8_t)(e + bias);
    frac = (a * exp2i(-e) - 1.f) * fscale;
  }
  uint8_t m_field = (uint8_t)(frac + 0.5f);
  if (m_field == (1 << fbits)) { m_field = 0; e_field += 1; }
  return sign | (e_field << fbits) | m_field;
}

void pack_rows(const float* in, int64_t r0, int64_t r1, int64_t cols,
               int block, int scale_bits, const Format& f,
               uint8_t* codes, int8_t* scales) {
  int64_t nb = cols / block;
  int scale_emax = (1 << (scale_bits - 1)) - 1;
  for (int64_t r = r0; r < r1; ++r) {
    const float* row = in + r * cols;
    for (int64_t b = 0; b < nb; ++b) {
      const float* blk = row + b * block;
      float amax = 0.f;
      for (int i = 0; i < block; ++i) {
        float a = std::fabs(blk[i]);
        if (a > amax) amax = a;
      }
      int se = floor_log2(amax == 0.f ? 1.17549435e-38f : amax) - f.emax;
      if (se > scale_emax) se = scale_emax;
      if (se < -scale_emax) se = -scale_emax;
      scales[r * nb + b] = (int8_t)se;
      float inv = exp2i(-se);
      uint8_t* out = codes + r * cols + b * block;
      for (int i = 0; i < block; ++i) {
        float q = quantize_elem(blk[i] * inv, f);
        if (f.is_int) {
          int code = (int)std::lrintf(q * (float)(1 << (f.mbits - 2)));
          out[i] = (uint8_t)(int8_t)code;
        } else {
          out[i] = encode_fp8(q, f.c_ebits, f.c_fbits);
        }
      }
    }
  }
}

void dequant_rows(const uint8_t* codes, const int8_t* scales, int64_t r0,
                  int64_t r1, int64_t cols, int block, const Format& f,
                  float* out) {
  int64_t nb = cols / block;
  for (int64_t r = r0; r < r1; ++r) {
    for (int64_t b = 0; b < nb; ++b) {
      float sc = exp2i(scales[r * nb + b]);
      const uint8_t* c = codes + r * cols + b * block;
      float* o = out + r * cols + b * block;
      for (int i = 0; i < block; ++i) {
        float v;
        if (f.is_int) {
          v = (float)(int8_t)c[i] / (float)(1 << (f.mbits - 2));
        } else {
          // decode fp8 container byte (e4m3 or e5m2 layout)
          uint8_t byte = c[i];
          int bias = (1 << (f.c_ebits - 1)) - 1;
          float fscale = (float)(1 << f.c_fbits);
          int s = byte >> 7;
          int e = (byte >> f.c_fbits) & ((1 << f.c_ebits) - 1);
          int m = byte & ((1 << f.c_fbits) - 1);
          float mag = e > 0 ? (1.f + m / fscale) * exp2i(e - bias)
                            : (m / fscale) * exp2i(1 - bias);
          v = s ? -mag : mag;
        }
        o[i] = v * sc;
      }
    }
  }
}

void parallel_rows(int64_t rows, int nthreads,
                   const std::function<void(int64_t, int64_t)>& fn) {
  if (nthreads <= 1 || rows < 2) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t a = t * per, b = std::min(rows, (t + 1) * per);
    if (a >= b) break;
    ts.emplace_back(fn, a, b);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Pack a (rows, cols) fp32 buffer; cols must be a block multiple.
// codes: (rows, cols) uint8; scales: (rows, cols/block) int8.
void msq_pack_mx(const float* in, int64_t rows, int64_t cols, int block,
                 int scale_bits, int fmt_id, uint8_t* codes,
                 int8_t* scales, int nthreads) {
  Format f = format_params(fmt_id);
  parallel_rows(rows, nthreads, [&](int64_t a, int64_t b) {
    pack_rows(in, a, b, cols, block, scale_bits, f, codes, scales);
  });
}

void msq_dequant_mx(const uint8_t* codes, const int8_t* scales,
                    int64_t rows, int64_t cols, int block, int fmt_id,
                    float* out, int nthreads) {
  Format f = format_params(fmt_id);
  parallel_rows(rows, nthreads, [&](int64_t a, int64_t b) {
    dequant_rows(codes, scales, a, b, cols, block, f, out);
  });
}

// 4x fp6 codes -> 3 bytes transport packing (packing.py pack_fp6 layout)
void msq_pack_fp6_transport(const uint8_t* codes6, int64_t n,
                            uint8_t* out) {
  for (int64_t i = 0, o = 0; i + 3 < n; i += 4, o += 3) {
    uint8_t c0 = codes6[i] & 0x3F, c1 = codes6[i + 1] & 0x3F;
    uint8_t c2 = codes6[i + 2] & 0x3F, c3 = codes6[i + 3] & 0x3F;
    out[o] = c0 | (uint8_t)((c1 & 0x3) << 6);
    out[o + 1] = (uint8_t)(c1 >> 2) | (uint8_t)((c2 & 0xF) << 4);
    out[o + 2] = (uint8_t)(c2 >> 4) | (uint8_t)(c3 << 2);
  }
}

}  // extern "C"
