// The floor of csrc/gemm_sm90.cuh's mainloop: y = x @ W for a bf16 weight
// W (K, N), whose "decode" is a copy of the raw bf16 tile into the swizzled
// K-major B tile. Built and timed by _dev/sm90_floor.py beside the shipped
// pf6 and side-band GEMMs and torch.matmul; no wrapper of the package
// routes to it.
#include "gemm_sm90.cuh"

namespace {

// Raw copy of a step: the 64 x 128 bf16 tile of W, row-major.
struct Bf16Copy {
  static constexpr int kN = mxq::sm90::kBN;
  static constexpr int kRawBytes = mxq::sm90::kBK * kN * 2;
  static constexpr int kStages = 3, kRawBufs = 3, kDwg = 2;

  const CUtensorMap* w_map;
  bool tma;

  __device__ __forceinline__ int tx_bytes() const { return kRawBytes; }
  __device__ __forceinline__ void copy_tma(int8_t* raw, int k0, int n0,
                                           uint32_t bar) const {
    mxq::sm90::tma_load_2d(raw, w_map, n0, k0, bar);
  }
  template <int DWG>
  __device__ __forceinline__ void copy(int8_t*, int, int, int) const {}

  // thread t: column t % 128, the 64 / DWG K rows of its part
  template <int DWG>
  __device__ __forceinline__ void decode(const int8_t* raw, uint8_t* b,
                                         int t) const {
    const uint16_t* w = reinterpret_cast<const uint16_t*>(raw);
    const int col = t % kN;
#pragma unroll
    for (int c = (t / kN) * (8 / DWG); c < (t / kN + 1) * (8 / DWG); ++c) {
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = w[(8 * c + 2 * i) * kN + col]
               | (static_cast<uint32_t>(w[(8 * c + 2 * i + 1) * kN + col])
                  << 16);
      mxq::sm90::store_b_chunk(b, col, c, make_uint4(u[0], u[1], u[2], u[3]));
    }
  }
};

__global__ void __launch_bounds__(mxq::sm90::threads(Bf16Copy::kDwg), 1)
gemm_bf16_sm90(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap w_map, void* out, int M,
               int K, int N) {
  Bf16Copy dec{&w_map, true};
  mxq::sm90::gemm<Bf16Copy::kStages, Bf16Copy::kRawBufs, Bf16Copy::kDwg>(
      &xmap, out, M, N, K, 0, dec);
}

}  // namespace

// x (M, K), w (K, N) bf16, K % 8 == 0, N % 8 == 0; out (M, N) f32.
extern "C" int gemm_bf16_sm90_floor(const void* x, const void* w, void* out,
                                    int M, int K, int N, void* stream) {
  CUtensorMap w_map{};
  int err = mxq::sm90::tensor_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     2, w, N, K, mxq::sm90::kBN,
                                     mxq::sm90::kBK,
                                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  constexpr int smem = mxq::sm90::Ring<Bf16Copy::kStages, Bf16Copy::kRawBytes,
                                       Bf16Copy::kRawBufs>::kBytes;
  return mxq::sm90::launch<Bf16Copy::kDwg>(
      gemm_bf16_sm90, smem, x, M, N, K, static_cast<cudaStream_t>(stream),
      w_map, out, M, K, N);
}
