// Kimi Delta Attention for Hopper (sm_90a): the recurrence and the short convolutions, one launch each a layer.
//
// Neither replaces a TPU kernel: the JAX package has no linear-attention layer. Both were added for ops/kda.py,
// the KDA layers of Kimi Linear (arXiv:2510.26692; fla-org's fla/layers/kda.py). The short convolutions' design
// is noted at kda_short_conv_kernel below.
//
// The recurrence, the token-to-token part of the layer. No PyTorch call computes it, and a loop of PyTorch calls
// over the tokens launches some ten thousand kernels a layer at 2,048 tokens.
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
constexpr int kErrShape = -1;  // d not 128, a convolution width not 4, or a bad size
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

// The short convolutions. For each of a layer's three projections x (b, t, C), C = h d, with its weights
// w (C, 1, 4), at every token t and channel c:
//     y = sum_j w[c, j] x[t - 3 + j, c]   (zeros before the sequence's start; no row of another sequence)
//     s = SiLU(y);   for q and k, when `norm`: s * rsqrt(sum over the head's d channels of s^2 + 1e-6), q also * scale
// in float32, rounded once to the output's type. The outputs q, k, v (b, t, h, d) are the bytes of (b, t, C): the
// layout the recurrence takes. Without `norm` (a tap of the convolutions' output) all three stop after the SiLU.
//
// What bounds it: bytes. Each element is read once and written once, 4 bytes in bf16 against some 15 operations,
// far below the card's ratio. At the text sweep's shape (4 x 2,048 tokens, C = 4,096, three tensors) 403 MB: 0.120
// ms at 3.35 TB/s. PyTorch took two strided copies a tensor around a generic depthwise kernel in the (b, C, t)
// layout, a SiLU pass and a float32 chain for each norm.
//
// Design: the (b, t, C) rows are read as they lie, with no transpose. A thread owns 8 consecutive channels (16 bytes
// in bf16, a warp 512 contiguous bytes of a row) over a run of kConvRun tokens of one sequence and walks the run with
// the three previous rows in registers: each row is read once, the 3-row halo before a run a second time (from L2,
// where the run before it read it). The loads run kConvAhead rows ahead of the stores, in a ring of registers: the
// compiler cannot move a load above a store that may alias it, and with one row in flight a thread the kernel waited
// on latency (58 % of the bound on an H100). A head's 128 channels are 16 neighbouring lanes, so its sum of squares
// is four shuffles. blockIdx.z picks q, k or v. Lanes past the end run the arithmetic on zeros and store nothing, so
// every lane of a warp takes part in the shuffles.
constexpr int kConvWidth = 4;       // Kimi Linear's short_conv_kernel_size
constexpr int kConvRun = 16;        // tokens a thread walks: 4 x 2,048 x 4,096 / 8 / 16 x 3 = 786,432 lanes
constexpr int kConvAhead = 4;       // rows a thread has in flight
constexpr int kConvVec = 8;         // channels a thread owns
constexpr int kConvThreads = 256;
constexpr float kL2Eps = 1e-6f;     // fla's l2norm

// kConvVec elements of T as raw 16-byte words: loaded now, converted when their row's turn comes
template <typename T>
struct Row {
  uint4 u[kConvVec * sizeof(T) / 16];
};

template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* p, bool valid) {
  Row<T> r;
#pragma unroll
  for (int i = 0; i < kConvVec * static_cast<int>(sizeof(T)) / 16; ++i)
    r.u[i] = valid ? reinterpret_cast<const uint4*>(p)[i] : make_uint4(0u, 0u, 0u, 0u);
  return r;
}
__device__ __forceinline__ void to_floats(const Row<__nv_bfloat16>& r, float (&f)[kConvVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.u);
#pragma unroll
  for (int i = 0; i < kConvVec / 2; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void to_floats(const Row<float>& r, float (&f)[kConvVec]) {
  const float* x = reinterpret_cast<const float*>(r.u);
#pragma unroll
  for (int i = 0; i < kConvVec; ++i) f[i] = x[i];
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[kConvVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kConvVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[kConvVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T>
struct ConvOperands {
  const T* x[3];  // the projections of q, k, v, (b, t, C)
  const T* w[3];  // their weights, (C, 1, kConvWidth)
  T* y[3];        // q, k, v, (b, t, C)
};

// ops.*[which] by selection, not by a run-time index (which would copy the operands to local memory)
template <typename P>
__device__ __forceinline__ P pick(const P (&p)[3], int which) {
  return which == 0 ? p[0] : which == 1 ? p[1] : p[2];
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads, 2) kda_short_conv_kernel(ConvOperands<T> ops, int t_len, int runs,
                                                                         int chunks, int64_t lanes, int norm,
                                                                         float q_scale) {
  const int which = blockIdx.z;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kConvThreads + threadIdx.x;
  const bool live = lane < lanes;
  const int chunk = static_cast<int>(lane % chunks);
  const int64_t seq_run = lane / chunks;
  const int t0 = static_cast<int>(seq_run % runs) * kConvRun;
  const int64_t row = static_cast<int64_t>(chunks) * kConvVec;
  const int64_t base = (seq_run / runs) * t_len * row + static_cast<int64_t>(chunk) * kConvVec;
  const T* __restrict__ x = pick(ops.x, which) + base;
  T* __restrict__ y = pick(ops.y, which) + base;
  const T* __restrict__ wp = pick(ops.w, which) + static_cast<int64_t>(chunk) * kConvVec * kConvWidth;
  auto has = [&](int t) { return live && t >= 0 && t < t_len; };

  // every load before the first store: the halo, the first kConvAhead rows and the weights
  Row<T> halo[kConvWidth - 1], ring[kConvAhead], wr[kConvWidth];
#pragma unroll
  for (int j = 0; j < kConvWidth - 1; ++j) halo[j] = load_row(x + (t0 - (kConvWidth - 1) + j) * row,
                                                              has(t0 - (kConvWidth - 1) + j));
#pragma unroll
  for (int j = 0; j < kConvAhead; ++j) ring[j] = load_row(x + (t0 + j) * row, has(t0 + j));
#pragma unroll
  for (int i = 0; i < kConvWidth; ++i) wr[i] = load_row(wp + i * kConvVec, true);  // chunk < chunks on every lane

  float w[kConvVec][kConvWidth];
#pragma unroll
  for (int i = 0; i < kConvWidth; ++i) {
    float f[kConvVec];
    to_floats(wr[i], f);
#pragma unroll
    for (int e = 0; e < kConvVec; ++e) w[(i * kConvVec + e) / kConvWidth][(i * kConvVec + e) % kConvWidth] = f[e];
  }
  float win[kConvWidth - 1][kConvVec];  // rows t - 3, t - 2, t - 1
#pragma unroll
  for (int j = 0; j < kConvWidth - 1; ++j) to_floats(halo[j], win[j]);
  const bool l2 = norm && which < 2;  // one value a block: every lane of a warp shuffles or none
  const float scale = norm && which == 0 ? q_scale : 1.0f;

#pragma unroll
  for (int i = 0; i < kConvRun; ++i) {
    const int t = t0 + i;
    float cur[kConvVec];
    to_floats(ring[i % kConvAhead], cur);
    if (i + kConvAhead < kConvRun) ring[i % kConvAhead] = load_row(x + (t + kConvAhead) * row, has(t + kConvAhead));
    float s[kConvVec], sq = 0.0f;
#pragma unroll
    for (int e = 0; e < kConvVec; ++e) {
      float acc = w[e][kConvWidth - 1] * cur[e];
#pragma unroll
      for (int j = 0; j < kConvWidth - 1; ++j) acc = fmaf(w[e][j], win[j][e], acc);
      s[e] = __fdividef(acc, 1.0f + __expf(-acc));
      sq = fmaf(s[e], s[e], sq);
    }
    if (l2) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      const float r = rsqrtf(sq + kL2Eps) * scale;
#pragma unroll
      for (int e = 0; e < kConvVec; ++e) s[e] *= r;
    }
    if (has(t)) store8(y + t * row, s);
#pragma unroll
    for (int e = 0; e < kConvVec; ++e) {
      win[0][e] = win[1][e];
      win[1][e] = win[2][e];
      win[2][e] = cur[e];
    }
  }
}

template <typename T>
int launch_short_conv(const void* const* x, const void* const* w, void* const* y, int b, int t, int c, int norm,
                      float q_scale, cudaStream_t stream) {
  ConvOperands<T> ops;
  for (int i = 0; i < 3; ++i) {
    ops.x[i] = static_cast<const T*>(x[i]);
    ops.w[i] = static_cast<const T*>(w[i]);
    ops.y[i] = static_cast<T*>(y[i]);
  }
  const int runs = (t + kConvRun - 1) / kConvRun, chunks = c / kConvVec;
  const int64_t lanes = static_cast<int64_t>(b) * runs * chunks;
  const int64_t blocks = (lanes + kConvThreads - 1) / kConvThreads;
  if (blocks > 0x7fffffff) return kErrShape;
  kda_short_conv_kernel<T><<<dim3(static_cast<unsigned>(blocks), 1, 3), kConvThreads, 0, stream>>>(
      ops, t, runs, chunks, lanes, norm, q_scale);
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

// The three short convolutions of a KDA layer. xq, xk, xv, q, k, v (b, t, c) and wq, wk, wv (c, 1, width) of one
// element type (dtype 0: bf16, 1: float32), contiguous, 16-byte aligned; c a multiple of d = 128, width 4. `norm`
// 1: q and k unit-normed per head and q times q_scale; 0: all three after the SiLU. Launches on `stream` and returns
// 0, a cudaError_t, or a negative code of this file.
extern "C" int kda_short_conv(const void* xq, const void* xk, const void* xv, const void* wq, const void* wk,
                              const void* wv, void* q, void* k, void* v, int b, int t, int c, int d, int width,
                              int norm, float q_scale, int dtype, cudaStream_t stream) {
  if (b < 0 || t < 0 || c < 0 || d != kHeadDim || c % d != 0 || width != kConvWidth) return kErrShape;
  if (b == 0 || t == 0 || c == 0) return 0;
  const void* x[3] = {xq, xk, xv};
  const void* w[3] = {wq, wk, wv};
  void* y[3] = {q, k, v};
  switch (dtype) {
    case 0: return launch_short_conv<__nv_bfloat16>(x, w, y, b, t, c, norm, q_scale, stream);
    case 1: return launch_short_conv<float>(x, w, y, b, t, c, norm, q_scale, stream);
    default: return kErrDtype;
  }
}
