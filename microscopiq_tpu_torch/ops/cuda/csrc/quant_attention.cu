// Flash-decode attention over the quantized chunks of one layer's KV cache.
//
// Replaces microscopiq_tpu/ops/pallas/quant_attention.py::_chunk_kernel
// (wrapper _chunk_attention). It runs once per layer at every decode step of
// a quantized cache: 2/4/8-bit KIVI chunk codes, per-chunk per-channel K
// scales, per-token (Gh = 1) or grouped (Gh > 1) V scales and an optional
// GEAR-L rank-r error correction, with a per-slot count of folded chunks.
// It returns the unnormalised flash state (o, m, l); the caller merges it
// with the full-precision residual window.
//
// What bounds it on the H100: bytes. Per decode step the codes (half a byte
// per element at 4 bits) and scales of every folded chunk are read once and
// used for ~4 flops each per query row, far below the ~295 flop/byte where
// compute would become the limit. The bound is (codes + scales + q + o) /
// 3.35 TB/s. What keeps a simple kernel from it is latency: each block reads
// little, so the design keeps many independent loads in flight per thread.
//
// Design:
// - grid (nsplit, KVH, B). Block (s, g, b) walks chunks [s*cps, (s+1)*cps)
//   of slot b, head group g, stopping at the slot's nfull[b]: flash-decoding
//   splits the chunk axis because B * KVH alone is 32 blocks at the Llama-3
//   shape. The split count depends only on (C, KVH), which the wrapper
//   picks, so a slot's result does not depend on the batch.
// - a chunk is one step. Each lane owns 4 adjacent head-dim columns (8 when
//   hd > 128) and each warp a quarter of the chunk's packed byte rows; a
//   thread loads its K and V code words (uint32, coalesced across the warp,
//   all in flight together) at the start of the step. It writes its share of
//   the dequantized K into shared memory; the block computes the rep x gap
//   logits from it and updates the online softmax (m, l) one warp per query
//   row; then each thread accumulates p @ V for its rows and columns in
//   registers, dequantizing V from the words it holds (V never goes through
//   shared memory). The warps' shares are summed in a fixed order at the end.
// - every key of a folded chunk is live, so no key is masked; a block with
//   no folded chunk writes o = 0, m = -1e30, l = 0.
// - a second kernel merges the splits' partial states in a fixed order (no
//   atomics) into (o, m, l).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

struct Args {
  const __nv_bfloat16* q;                       // (B, KVH, rep, hd)
  const uint8_t* kq;                            // (B, KVH, C, rows, hd)
  const float* kmn;                             // (B, KVH, C, hd)
  const float* ksc;
  const uint8_t* vq;                            // (B, KVH, C, rows, hd)
  const float* vmn;                             // (B, KVH, C, gap, Gh)
  const float* vsc;
  const void* kp;                               // (B, KVH, C, rank, hd)
  const void* kqb;                              // (B, C, rank, gap)
  const void* vp;
  const void* vqb;
  const int* nfull;                             // (B,)
  float* ws_o;                                  // (B, KVH, nsplit, rep, hd)
  float* ws_m;                                  // (B, KVH, nsplit, rep)
  float* ws_l;
  int B, KVH, C, rep, hd, gap, bits, Gh, rank, lr_f32, nsplit, cps;
  float scale;
};

__device__ __forceinline__ float lr_at(const void* p, size_t i, int f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout of chunk_partial, in floats; each array starts on a
// 16-byte boundary so that rows of kRep probabilities load as vectors. The
// key tile doubles as the cross-warp reduction buffer at the end.
struct Smem {
  int q, k, p, pt, vsm, lk, lv, pl, m, l, al, total;
  __host__ __device__ Smem(int rep, int krep, int hd, int gap, int Gh, int rank) {
    auto up = [](int n) { return (n + 3) & ~3; };
    const int keys = gap * (hd + 1), red = kWarps * rep * hd;
    q = 0;                                      // rep * hd query rows
    k = up(q + rep * hd);                       // gap * (hd + 1) keys
    p = up(k + (keys > red ? keys : red));      // rep * gap logits
    pt = up(p + rep * gap);                     // gap * krep probabilities
    vsm = up(pt + gap * krep);                  // gap * Gh (sc, mn) of V
    lk = up(vsm + 2 * gap * Gh);                // rank * gap K low-rank q
    lv = up(lk + rank * gap);                   // rank * gap V low-rank q
    pl = up(lv + rank * gap);                   // rep * rank p @ Q_v^T
    m = up(pl + rep * rank);                    // rep running max
    l = m + rep;                                // rep running sum
    al = l + rep;                               // rep rescale factors
    total = al + rep;
  }
};

__host__ __device__ inline int rep_bucket(int rep) {
  return rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : rep <= 8 ? 8 : 16;
}

// Code words of one chunk, (rows, hd / 4) uint32: thread (warp, lane) loads
// word lane + 32 j of byte rows row0 + warp + kWarps i, all in flight at once.
template <int kRB, int kWords>
__device__ __forceinline__ void load_words(const uint32_t* base, int n_words,
                                           int rows, int row0, int lane,
                                           uint32_t (&w)[kRB][kWords]) {
#pragma unroll
  for (int i = 0; i < kRB; ++i) {
    const int row = row0 + i * kWarps;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int wi = lane + 32 * j;
      w[i][j] = row < rows && wi < n_words
                    ? base[static_cast<size_t>(row) * n_words + wi] : 0u;
    }
  }
}

// fn(t, j, k, code) for every code of the loaded words: token t of byte row
// row0 + warp + kWarps i, field f (byte row r holds tokens r, r + rows,
// r + 2 rows, ..., low bits first), column 4 (lane + 32 j) + k.
template <int kRB, int kWords, typename Fn>
__device__ __forceinline__ void for_codes(const uint32_t (&w)[kRB][kWords],
                                          int n_words, int rows, int row0,
                                          int lane, int bits, Fn fn) {
  const int per = 8 / bits;
  const uint32_t mask = (1u << bits) - 1u;
#pragma unroll
  for (int i = 0; i < kRB; ++i) {
    const int row = row0 + i * kWarps;
    if (row >= rows) break;
    for (int f = 0; f < per; ++f) {
      const int t = row + f * rows;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        if (lane + 32 * j < n_words) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            fn(t, j, k, static_cast<int>((w[i][j] >> (8 * k + bits * f)) & mask));
        }
      }
    }
  }
}

// kRep >= rep query rows per KV head; kWords = code words of 4 head-dim
// columns per lane (hd <= 128: 1, hd <= 256: 2).
template <int kRep, int kWords>
__global__ void __launch_bounds__(kThreads)
chunk_partial(Args a) {
  constexpr int kRB = 8 / kWords;                // byte rows per load batch
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.rep, hd = a.hd, gap = a.gap, Gh = a.Gh, rank = a.rank;
  const int rows = gap / (8 / a.bits);
  const int n_words = hd / 4;
  const int vg = hd / Gh;
  const Smem L(rep, kRep, hd, gap, Gh, rank);
  float* q_s = smem + L.q;
  float* k_s = smem + L.k;
  float* p_s = smem + L.p;
  float* pt_s = smem + L.pt;
  float2* vsm_s = reinterpret_cast<float2*>(smem + L.vsm);
  float* lk_s = smem + L.lk;
  float* lv_s = smem + L.lv;
  float* pl_s = smem + L.pl;
  float* m_s = smem + L.m;
  float* l_s = smem + L.l;
  float* a_s = smem + L.al;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t bg = static_cast<size_t>(b) * a.KVH + g;
  const int nf = min(max(a.nfull[b], 0), a.C);
  const int c_begin = s * a.cps;
  const int c_end = min(min(c_begin + a.cps, a.C), nf);

  for (int i = tid; i < rep * hd; i += kThreads)
    q_s[i] = __bfloat162float(a.q[bg * rep * hd + i]);
  for (int i = tid; i < gap * kRep; i += kThreads) pt_s[i] = 0.f;
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // V group of each of this lane's columns
  int gi[kWords][4];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) gi[j][k] = min(4 * (lane + 32 * j) + k, hd - 1) / vg;
  // this warp's share of p @ V: its byte rows, this lane's columns
  float acc[kWords][4][kRep];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < kRep; ++r) acc[j][k][r] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const size_t chunk = bg * a.C + c;
    const uint32_t* kw_base = reinterpret_cast<const uint32_t*>(a.kq + chunk * rows * hd);
    const uint32_t* vw_base = reinterpret_cast<const uint32_t*>(a.vq + chunk * rows * hd);
    __syncthreads();                             // previous chunk consumed
    // first batch of K and V code words, in flight together
    uint32_t kw[kRB][kWords], vw[kRB][kWords];
    load_words(kw_base, n_words, rows, warp, lane, kw);
    load_words(vw_base, n_words, rows, warp, lane, vw);
    float ksc[kWords][4], kmn[kWords][4];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int wi = min(lane + 32 * j, n_words - 1);
      const float4 sc = reinterpret_cast<const float4*>(a.ksc + chunk * hd)[wi];
      const float4 mn = reinterpret_cast<const float4*>(a.kmn + chunk * hd)[wi];
      ksc[j][0] = sc.x; ksc[j][1] = sc.y; ksc[j][2] = sc.z; ksc[j][3] = sc.w;
      kmn[j][0] = mn.x; kmn[j][1] = mn.y; kmn[j][2] = mn.z; kmn[j][3] = mn.w;
    }
    for (int i = tid; i < gap * Gh; i += kThreads)
      vsm_s[i] = make_float2(a.vsc[chunk * gap * Gh + i], a.vmn[chunk * gap * Gh + i]);
    if (rank > 0) {
      const size_t lq = (static_cast<size_t>(b) * a.C + c) * rank * gap;
      for (int i = tid; i < rank * gap; i += kThreads) {
        lk_s[i] = lr_at(a.kqb, lq + i, a.lr_f32);
        lv_s[i] = lr_at(a.vqb, lq + i, a.lr_f32);
      }
    }
    // K = code * k_sc + k_mn into k_s
    for (int row0 = warp; row0 < rows; row0 += kWarps * kRB) {
      if (row0 != warp) load_words(kw_base, n_words, rows, row0, lane, kw);
      for_codes(kw, n_words, rows, row0, lane, a.bits, [&](int t, int j, int k, int code) {
        k_s[t * (hd + 1) + 4 * (lane + 32 * j) + k] =
            static_cast<float>(code) * ksc[j][k] + kmn[j][k];
      });
    }
    __syncthreads();
    if (rank > 0) {
      // GEAR-L on the K side: K += Q_k^T P_k
      for (int e = tid; e < gap * hd; e += kThreads) {
        const int t = e / hd, d = e - t * hd;
        float corr = 0.f;
        for (int i = 0; i < rank; ++i)
          corr = fmaf(lk_s[i * gap + t], lr_at(a.kp, (chunk * rank + i) * hd + d, a.lr_f32), corr);
        k_s[t * (hd + 1) + d] += corr;
      }
      __syncthreads();
    }
    // logits[r][t] = scale * q[r] . k[t], four partial sums per dot
    for (int p = tid; p < rep * gap; p += kThreads) {
      const int r = p / gap, t = p - r * gap;
      const float4* qr = reinterpret_cast<const float4*>(q_s + r * hd);
      const float* kr = k_s + t * (hd + 1);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d4 = 0; d4 < hd / 4; ++d4) {
        const float4 qv = qr[d4];
        s0 = fmaf(qv.x, kr[4 * d4], s0);
        s1 = fmaf(qv.y, kr[4 * d4 + 1], s1);
        s2 = fmaf(qv.z, kr[4 * d4 + 2], s2);
        s3 = fmaf(qv.w, kr[4 * d4 + 3], s3);
      }
      p_s[p] = ((s0 + s1) + (s2 + s3)) * a.scale;
    }
    __syncthreads();
    // online softmax, one warp per query row; probabilities go to pt_s
    // token-major, so that the p @ V step loads a token's kRep rows at once
    for (int r = warp; r < rep; r += kWarps) {
      const float* pr = p_s + r * gap;
      float x_max = kNegInf;
      for (int t = lane; t < gap; t += 32) x_max = fmaxf(x_max, pr[t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(x_max));
      float sum = 0.f;
      for (int t = lane; t < gap; t += 32) {
        const float e = expf(pr[t] - m_new);
        pt_s[t * kRep + r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    if (rank > 0) {
      // GEAR-L on the V side: pv += (p @ Q_v^T) @ P_v
      for (int i = tid; i < rep * rank; i += kThreads) {
        const int r = i / rank, k = i - r * rank;
        float sum = 0.f;
        for (int t = 0; t < gap; ++t) sum = fmaf(pt_s[t * kRep + r], lv_s[k * gap + t], sum);
        pl_s[i] = sum;
      }
      __syncthreads();
    }
    // acc = acc * alpha + p @ V over this warp's byte rows, V dequantized
    // from the code words in registers
    float alpha[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) alpha[r] = r < rep ? a_s[r] : 0.f;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < kRep; ++r) acc[j][k][r] *= alpha[r];
    for (int row0 = warp; row0 < rows; row0 += kWarps * kRB) {
      if (row0 != warp) load_words(vw_base, n_words, rows, row0, lane, vw);
      for_codes(vw, n_words, rows, row0, lane, a.bits, [&](int t, int j, int k, int code) {
        const float2 sm = vsm_s[t * Gh + gi[j][k]];
        const float v = static_cast<float>(code) * sm.x + sm.y;
        const float* pt = pt_s + t * kRep;
        float pr[kRep];
        if constexpr (kRep % 4 == 0) {
#pragma unroll
          for (int r = 0; r < kRep; r += 4) {
            const float4 x = *reinterpret_cast<const float4*>(pt + r);
            pr[r] = x.x; pr[r + 1] = x.y; pr[r + 2] = x.z; pr[r + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < kRep; ++r) pr[r] = pt[r];
        }
#pragma unroll
        for (int r = 0; r < kRep; ++r) acc[j][k][r] = fmaf(pr[r], v, acc[j][k][r]);
      });
    }
    if (rank > 0 && warp == 0) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        if (lane + 32 * j < n_words) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int d = 4 * (lane + 32 * j) + k;
            for (int i = 0; i < rank; ++i) {
              const float pv = lr_at(a.vp, (chunk * rank + i) * hd + d, a.lr_f32);
#pragma unroll
              for (int r = 0; r < kRep; ++r)
                if (r < rep) acc[j][k][r] = fmaf(pl_s[r * rank + i], pv, acc[j][k][r]);
            }
          }
        }
      }
    }
  }
  // sum the warps' shares in warp order, through the key tile
  __syncthreads();
  float* red = k_s;                              // (kWarps, rep, hd)
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    if (lane + 32 * j < n_words) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < kRep; ++r)
          if (r < rep) red[(warp * rep + r) * hd + 4 * (lane + 32 * j) + k] = acc[j][k][r];
    }
  }
  __syncthreads();
  const size_t part = bg * a.nsplit + s;
  for (int i = tid; i < rep * hd; i += kThreads) {
    float sum = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w * rep * hd + i];
    a.ws_o[part * rep * hd + i] = sum;
  }
  for (int r = tid; r < rep; r += kThreads) {
    a.ws_m[part * rep + r] = m_s[r];
    a.ws_l[part * rep + r] = l_s[r];
  }
}

// Merge the nsplit partial states of query row r of (b, g), block (bg, r),
// splits in order 0, 1, ...; the splits' weights exp(m_s - max) are computed
// once per block, into shared memory.
__global__ void chunk_merge(const float* __restrict__ ws_o,
                            const float* __restrict__ ws_m,
                            const float* __restrict__ ws_l, float* o,
                            float* m, float* l, int rep, int hd, int nsplit) {
  extern __shared__ float w_s[];                 // nsplit
  const size_t bg = blockIdx.x;
  const int r = blockIdx.y;
  const float* pm = ws_m + bg * nsplit * rep + r;
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s * rep]);
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x) w_s[s] = expf(pm[s * rep] - mx);
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    const float* po = ws_o + (bg * nsplit * rep + r) * hd + d;
    float so = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s)
      so = fmaf(po[static_cast<size_t>(s) * rep * hd], w_s[s], so);
    o[(bg * rep + r) * hd + d] = so;
  }
  if (threadIdx.x == 0) {
    const float* pl = ws_l + bg * nsplit * rep + r;
    float sl = 0.f;
    for (int s = 0; s < nsplit; ++s) sl = fmaf(pl[s * rep], w_s[s], sl);
    m[bg * rep + r] = mx;
    l[bg * rep + r] = sl;
  }
}

template <int kRep, int kWords>
cudaError_t launch_partial(const Args& a, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      chunk_partial<kRep, kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  chunk_partial<kRep, kWords><<<dim3(a.nsplit, a.KVH, a.B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// rep <= 16, and rep <= 8 when hd > 128 (kWords = 2): 4 kWords kRep
// accumulators per thread
template <int kWords>
cudaError_t launch_rep(const Args& a, size_t smem, cudaStream_t st) {
  switch (rep_bucket(a.rep)) {
    case 1: return launch_partial<1, kWords>(a, smem, st);
    case 2: return launch_partial<2, kWords>(a, smem, st);
    case 4: return launch_partial<4, kWords>(a, smem, st);
    case 8: return launch_partial<8, kWords>(a, smem, st);
    default:
      if constexpr (kWords == 1) return launch_partial<16, 1>(a, smem, st);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KVH, rep, hd) bf16, rep <= 16 (<= 8 when hd > 128); kq, vq (B,
// KVH, C, gap / per, hd) uint8, 4-byte aligned; kmn, ksc (B, KVH, C, hd)
// f32, 16-byte aligned; vmn, vsc (B, KVH, C, gap, Gh) f32; kp, vp (B, KVH,
// C, rank, hd) and kqb, vqb (B, C, rank, gap), bf16 or f32 (lr_f32), unused
// when rank == 0; nfull (B,) int32 folded chunks
// per slot; ws f32 scratch of B * KVH * nsplit * rep * (hd + 2); o (B, KVH,
// rep, hd), m, l (B, KVH, rep) f32; hd <= 256; quant_attention_smem_bytes
// of shared memory per block, at most 227 KB. Returns the cudaError_t of
// the launches.
extern "C" int quant_attention_chunks(
    const void* q, const void* kq, const void* kmn, const void* ksc,
    const void* vq, const void* vmn, const void* vsc, const void* kp,
    const void* kqb, const void* vp, const void* vqb, const void* nfull,
    void* ws, void* o, void* m, void* l, int B, int KVH, int C, int rep,
    int hd, int gap, int bits, int Gh, int rank, int lr_f32, int nsplit,
    int cps, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kq = static_cast<const uint8_t*>(kq);
  a.kmn = static_cast<const float*>(kmn);
  a.ksc = static_cast<const float*>(ksc);
  a.vq = static_cast<const uint8_t*>(vq);
  a.vmn = static_cast<const float*>(vmn);
  a.vsc = static_cast<const float*>(vsc);
  a.kp = kp;
  a.kqb = kqb;
  a.vp = vp;
  a.vqb = vqb;
  a.nfull = static_cast<const int*>(nfull);
  const size_t parts = static_cast<size_t>(B) * KVH * nsplit * rep;
  a.ws_o = static_cast<float*>(ws);
  a.ws_m = a.ws_o + parts * hd;
  a.ws_l = a.ws_m + parts;
  a.B = B; a.KVH = KVH; a.C = C; a.rep = rep; a.hd = hd; a.gap = gap;
  a.bits = bits; a.Gh = Gh; a.rank = rank; a.lr_f32 = lr_f32;
  a.nsplit = nsplit; a.cps = cps; a.scale = scale;
  const size_t smem =
      static_cast<size_t>(Smem(rep, rep_bucket(rep), hd, gap, Gh, rank).total) * sizeof(float);
  cudaError_t err = hd > 128 ? launch_rep<2>(a, smem, st)
                             : launch_rep<1>(a, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_merge<<<dim3(B * KVH, rep), kThreads, nsplit * sizeof(float), st>>>(
      a.ws_o, a.ws_m, a.ws_l, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), rep, hd, nsplit);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one chunk_partial block, in bytes.
extern "C" int quant_attention_smem_bytes(int rep, int hd, int gap, int Gh, int rank) {
  return Smem(rep, rep_bucket(rep), hd, gap, Gh, rank).total * static_cast<int>(sizeof(float));
}
