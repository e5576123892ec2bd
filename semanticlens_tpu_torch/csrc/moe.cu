// The mixture-of-experts combine for Hopper (sm_90a): one gather-sum kernel.
//
// Replaces no TPU kernel: the JAX package's MoE layer leaves its combine to
// XLA. It was added for ops/moe.py's combine, the weighted per-token sum of
// the routed experts' outputs, which as PyTorch operators (a float32 cast, a
// broadcast weighting, an atomic index_add_ into a zero-filled float32
// output, a cast back) moved ~2 GB a DeepSeek-V2-Lite layer at 8,192 tokens.
//
// For token t with k routed pairs, pair (t, s) at row pos[t*k + s] of the
// expert-sorted outputs y (P, h) and weight w[t*k + s] (float32):
//     out[t, :] = round(sum_{s = 0..k-1} w[t*k + s] * float(y[pos[t*k + s], :]))
// summed in float32 in slot order (each product rounded, then added: no FMA
// contraction), rounded once to the output type, as HF's moe_infer does
// (.type(float32).mul_(w).sum(dim=1).type(bf16)). Where the layer holds only
// some experts (expert parallelism), the absent experts' pairs sit at sorted
// rows from *limit on, never computed: such a slot adds nothing (its weight
// and row taken as 0, its row not read).
//
// What bounds it: bytes. At 8,192 tokens, k = 6, h = 2,048 (bf16) it reads
// each of the P = 49,152 rows once (201 MB), the positions and weights (0.4
// MB) and writes the output once (34 MB): 235 MB, 70 us at 3.35 TB/s, against
// ~100 operations a row element, far below the CUDA cores' rate.
//
// Design: keep the rows in flight. A block of 256 threads covers whole rows
// of the output: threadIdx.x walks a row's 16-byte chunks (lanes: the
// chunks rounded up to a warp, at most 256), threadIdx.y picks one of
// 256 / lanes tokens, and the blocks stride over the tokens; the grid is
// the SMs times the blocks that fit on one (occupancy), so one wave covers
// the card. A thread issues the 16-byte loads of all k rows of its chunk
// before it sums any (the k = 1..8 instances unroll the slots; larger k
// goes in groups of 8), so a warp has k * 512 bytes in flight, and
// consecutive threads read consecutive 16 bytes of one row. There are no
// atomics (each output element has one writer), no float32 intermediate in
// device memory and no zero fill. Offsets into y and out are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;          // slots loaded together when k > 8
constexpr int kErrShape = -1;      // k < 1, h not a multiple of 8, or a negative size
constexpr int kErrDtype = -2;      // no such element type
constexpr int kErrAlign = -3;      // y or out not 16-byte aligned

// A 16-byte chunk of a row as float32, and back with round-to-nearest-even.
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <>
struct Chunk<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// K > 0: k == K, the slots unrolled; K == 0: any k, in groups of kGroup.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ pos,
                                                               const float* __restrict__ w,
                                                               const int* __restrict__ limit, T* __restrict__ out,
                                                               int n, int k, int h) {
  using C = Chunk<T>;
  constexpr int G = K > 0 ? K : kGroup;
  const int slots = K > 0 ? K : k;
  const int chunks = h / C::kVec;
  const int held = __ldg(limit);  // rows from it on: absent experts' pairs
  const uint4* rows = reinterpret_cast<const uint4*>(y);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y; t < n;
       t += static_cast<int64_t>(gridDim.x) * blockDim.y) {
    const int* tp = pos + t * slots;
    const float* tw = w + t * slots;
    uint4* dst = reinterpret_cast<uint4*>(out + t * h);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      float acc[C::kVec];
#pragma unroll
      for (int i = 0; i < C::kVec; ++i) acc[i] = 0.0f;
      for (int s0 = 0; s0 < slots; s0 += G) {
        uint4 v[G];
        float ws[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (K > 0 || s0 + j < slots) {
            const int p = __ldg(tp + s0 + j);
            const bool kept = p < held;
            ws[j] = kept ? __ldg(tw + s0 + j) : 0.0f;
            v[j] = kept ? __ldg(rows + static_cast<int64_t>(p) * chunks + c) : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (K > 0 || s0 + j < slots) {
            float f[C::kVec];
            C::unpack(v[j], f);
#pragma unroll
            for (int i = 0; i < C::kVec; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(ws[j], f[i]));
          }
        }
      }
      dst[c] = C::pack(acc);
    }
  }
}

template <typename T, int K>
int launch(const void* y, const int* pos, const float* w, const int* limit, void* out, int n, int k, int h,
           cudaStream_t stream) {
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, moe_combine_kernel<T, K>,
                                                                        kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = h / Chunk<T>::kVec;
  const int lanes = std::min((chunks + 31) / 32 * 32, kThreads);
  const int tokens = kThreads / lanes;  // tokens a block covers at once
  const int grid = static_cast<int>(
      std::min<int64_t>((static_cast<int64_t>(n) + tokens - 1) / tokens, static_cast<int64_t>(sms) * blocks_per_sm));
  moe_combine_kernel<T, K><<<grid, dim3(lanes, tokens), 0, stream>>>(
      static_cast<const T*>(y), pos, w, limit, static_cast<T*>(out), n, k, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* y, const int* pos, const float* w, const int* limit, void* out, int n, int k, int h,
             cudaStream_t stream) {
  switch (k) {
#define MOE_K(KK) \
  case KK: return launch<T, KK>(y, pos, w, limit, out, n, k, h, stream);
    MOE_K(1) MOE_K(2) MOE_K(3) MOE_K(4) MOE_K(5) MOE_K(6) MOE_K(7) MOE_K(8)
#undef MOE_K
    default: return launch<T, 0>(y, pos, w, limit, out, n, k, h, stream);
  }
}

}  // namespace

// y (n * k, h) and out (n, h) of one element type (dtype 0: bf16, the
// model's; 1: float32, lm_audit's float32 subject), contiguous and 16-byte
// aligned, h a multiple of 8; pos (n * k)
// int32, each in [0, n * k); w (n, k) float32, contiguous; limit one int32
// on the device (n * k where every expert is held): slots whose pos is at or
// past it add nothing.
// Launches on `stream` and returns 0, a cudaError_t, or a negative code of
// this file.
extern "C" int moe_combine(const void* y, const int* pos, const float* w, const int* limit, void* out, int n, int k,
                           int h, int dtype, cudaStream_t stream) {
  if (n < 0 || k < 1 || h < 0 || h % 8 != 0) return kErrShape;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out)) % 16 != 0) return kErrAlign;
  if (n == 0 || h == 0) return 0;
  switch (dtype) {
    case 0: return launch_k<__nv_bfloat16>(y, pos, w, limit, out, n, k, h, stream);
    case 1: return launch_k<float>(y, pos, w, limit, out, n, k, h, stream);
    default: return kErrDtype;
  }
}
