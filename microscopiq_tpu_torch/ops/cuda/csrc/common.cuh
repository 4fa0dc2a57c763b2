// Device helpers shared by the dequantizing matmul kernels: the scale
// exponent, the fixed-order K-split reduce, and the bf16 tensor-core tile
// loop that each GEMM runs with its own weight decode.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace mxq {

// 2^e as f32 built from exponent bits, e clamped to [-126, 127] as the TPU
// kernels' _exp2_i32 does (no subnormal scales).
__device__ __forceinline__ float exp2_i32(int e) {
  e = max(-126, min(127, e));
  return __int_as_float((e + 127) << 23);
}

// out[m, n] = sum over splits s = 0, 1, ... of ws[(s * M + m) * ld + n], in
// that order, for n < N <= ld: the fixed-order reduce of the K-split
// kernels, so a row's result depends neither on the other rows nor on M.
static __global__ void split_reduce(const float* __restrict__ ws, void* out,
                                    int M, int ld, int N, int ksplit,
                                    int out_bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i - m * N;
  float s = 0.f;
  for (int sp = 0; sp < ksplit; ++sp)
    s += ws[(static_cast<size_t>(sp) * M + m) * ld + n];
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(s);
  else
    static_cast<float*>(out)[i] = s;
}

// Launches split_reduce on st; returns the cudaError_t of the launch.
static inline int launch_split_reduce(const float* ws, void* out, int M,
                                      int ld, int N, int ksplit, int out_bf16,
                                      cudaStream_t st) {
  const int total = M * N;
  split_reduce<<<(total + 255) / 256, 256, 0, st>>>(ws, out, M, ld, N, ksplit,
                                                    out_bf16);
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
