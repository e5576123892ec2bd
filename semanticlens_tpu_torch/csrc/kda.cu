// The KDA recurrence for Hopper (sm_90a): Kimi Delta Attention's gated delta rule, one launch a layer.
//
// Replaces no TPU kernel: the JAX package has no linear-attention layer. It was added for ops/kda.py's
// recurrence, the token-to-token part of Kimi Linear's KDA layers (arXiv:2510.26692; fla-org's
// fla/layers/kda.py). No PyTorch call computes it, and a loop of PyTorch calls over the tokens launches some
// ten thousand kernels a layer at 2,048 tokens.
//
// For each (sequence b, head h) a float32 d x d state S (key rows i, value columns j), 0 at the sequence's
// start. At every token t, with a = exp(g_t) (the decay, one per key channel), k_t and q_t as the caller
// normalised and scaled them, v_t and beta_t:
//     S <- Diag(a) S;   u = S^T k;   S <- S + beta * k (v - u)^T;   o_t = S^T q
// The value columns evolve independently given (q, k, a, beta), which is what the design uses.
//
// What bounds it: the chain over the tokens. The work a token-head must do is 7 d^2 operations (the benchmark
// counts it so), against 2 (5 d + 1) bytes of inputs and output: far below either of the card's rates, so at
// the text sweep's shape (4 x 2,048 tokens, 32 heads: 128 chains, about one an SM) each SM walks its chain
// alone and the time is the SM's issue rate over the 4 d^2 float32 state operations a token (decay, u, update,
// o), plus the shared-memory reads that feed them.
//
// Design: one block of 2d threads a (sequence, head), the state in registers, never in device memory. Thread
// (column pair c, row part r), lanes 4c .. 4c+3 of the block, holds value columns 2c and 2c+1 of the key rows
// in the 16-byte row chunks 4m + r (m = 0 .. d/16 - 1): d/2 floats. A token: each thread decays its rows and
// takes its partial u; the four row parts of a column pair sum theirs by two shuffles; each updates its rows
// and takes its partial o, summed the same way. The tokens' inputs are staged kTokens at a time in shared
// memory as float32 (a = exp(g) computed there once) and read as 16-byte broadcasts (a warp reads four
// consecutive chunks: no bank conflict); the outputs go back through shared memory, one coalesced row a token.
// Offsets into the (B, T, h, d) tensors are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTokens = 16;   // tokens staged in shared memory at a time
constexpr int kErrShape = -1;  // d not 128, or a negative size
constexpr int kErrDtype = -2;  // no such element type

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <typename T, int D>
__global__ void __launch_bounds__(2 * D) kda_recurrence_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                                const T* __restrict__ v, const float* __restrict__ g,
                                                                const float* __restrict__ beta, T* __restrict__ o,
                                                                int t_len, int heads) {
  constexpr int kChunks = D / 16;  // 16-byte row chunks a thread holds
  __shared__ __align__(16) float qs[kTokens][D];
  __shared__ __align__(16) float ks[kTokens][D];
  __shared__ __align__(16) float decay[kTokens][D];
  __shared__ __align__(16) float vs[kTokens][D];
  __shared__ __align__(16) float os[kTokens][D];
  __shared__ float bs[kTokens];

  const int seq = blockIdx.x / heads, head = blockIdx.x % heads;
  const int c = threadIdx.x >> 2, r = threadIdx.x & 3;
  float s[kChunks][4][2];  // s[m][e][col]: key row 4 (4m + r) + e, value column 2c + col
#pragma unroll
  for (int m = 0; m < kChunks; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[m][e][0] = s[m][e][1] = 0.0f;

  for (int t0 = 0; t0 < t_len; t0 += kTokens) {
    const int nt = min(kTokens, t_len - t0);
    for (int e = threadIdx.x; e < nt * D; e += blockDim.x) {
      const int tt = e / D, i = e % D;
      const int64_t off = ((static_cast<int64_t>(seq) * t_len + t0 + tt) * heads + head) * D + i;
      qs[tt][i] = to_float(q[off]);
      ks[tt][i] = to_float(k[off]);
      vs[tt][i] = to_float(v[off]);
      decay[tt][i] = expf(g[off]);
    }
    for (int tt = threadIdx.x; tt < nt; tt += blockDim.x)
      bs[tt] = beta[(static_cast<int64_t>(seq) * t_len + t0 + tt) * heads + head];
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float4* a4 = reinterpret_cast<const float4*>(decay[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[tt]);
      const float4* q4 = reinterpret_cast<const float4*>(qs[tt]);
      float ua[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ub[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const float4 a = a4[4 * m + r], kk = k4[4 * m + r];
        const float av[4] = {a.x, a.y, a.z, a.w}, kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[m][e][0] *= av[e];
          s[m][e][1] *= av[e];
          ua[e] = fmaf(kv[e], s[m][e][0], ua[e]);
          ub[e] = fmaf(kv[e], s[m][e][1], ub[e]);
        }
      }
      float u0 = (ua[0] + ua[1]) + (ua[2] + ua[3]), u1 = (ub[0] + ub[1]) + (ub[2] + ub[3]);
      u0 += __shfl_xor_sync(0xffffffffu, u0, 1);
      u1 += __shfl_xor_sync(0xffffffffu, u1, 1);
      u0 += __shfl_xor_sync(0xffffffffu, u0, 2);
      u1 += __shfl_xor_sync(0xffffffffu, u1, 2);
      const float2 vv = reinterpret_cast<const float2*>(vs[tt])[c];
      const float bt = bs[tt];
      const float d0 = bt * (vv.x - u0), d1 = bt * (vv.y - u1);
      float oa[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ob[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const float4 kk = k4[4 * m + r], qq = q4[4 * m + r];
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w}, qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[m][e][0] = fmaf(kv[e], d0, s[m][e][0]);
          s[m][e][1] = fmaf(kv[e], d1, s[m][e][1]);
          oa[e] = fmaf(qv[e], s[m][e][0], oa[e]);
          ob[e] = fmaf(qv[e], s[m][e][1], ob[e]);
        }
      }
      float o0 = (oa[0] + oa[1]) + (oa[2] + oa[3]), o1 = (ob[0] + ob[1]) + (ob[2] + ob[3]);
      o0 += __shfl_xor_sync(0xffffffffu, o0, 1);
      o1 += __shfl_xor_sync(0xffffffffu, o1, 1);
      o0 += __shfl_xor_sync(0xffffffffu, o0, 2);
      o1 += __shfl_xor_sync(0xffffffffu, o1, 2);
      if (r == 0) reinterpret_cast<float2*>(os[tt])[c] = make_float2(o0, o1);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nt * D; e += blockDim.x) {
      const int tt = e / D, i = e % D;
      o[((static_cast<int64_t>(seq) * t_len + t0 + tt) * heads + head) * D + i] = from_float<T>(os[tt][i]);
    }
  }
}

constexpr int kHeadDim = 128;  // Kimi Linear's (and Kimi K3's) KDA head size

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* g, const float* beta, void* o, int b, int t,
           int h, cudaStream_t stream) {
  kda_recurrence_kernel<T, kHeadDim><<<b * h, 2 * kHeadDim, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), g, beta, static_cast<T*>(o), t, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o (b, t, h, d) of one element type (dtype 0: bf16, the model's; 1: float32), contiguous; g (b, t, h, d)
// float32, the log decays; beta (b, t, h) float32. d is 128. Launches on `stream` and returns 0, a cudaError_t,
// or a negative code of this file.
extern "C" int kda_recurrence(const void* q, const void* k, const void* v, const float* g, const float* beta, void* o,
                              int b, int t, int h, int d, int dtype, cudaStream_t stream) {
  if (b < 0 || t < 0 || h < 0 || d != kHeadDim) return kErrShape;
  if (b == 0 || t == 0 || h == 0) return 0;
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(q, k, v, g, beta, o, b, t, h, stream);
    case 1: return launch<float>(q, k, v, g, beta, o, b, t, h, stream);
    default: return kErrDtype;
  }
}
