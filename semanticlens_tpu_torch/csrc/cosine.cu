// Fused cosine-similarity matrix for Hopper (sm_90a), fp32 CUDA-core FMA.
//
// Replaces the TPU kernel semanticlens_tpu/ops/pallas_ops.py:
// cosine_similarity_matrix (body _cosine_kernel): for x (M, D) and y (N, D),
//     out[i, j] = (x_i . y_j) * rsqrt(|x_i|^2 + 1e-24) * rsqrt(|y_j|^2 + 1e-24)
// so zero rows give 0. The TPU kernel pads rows to 256-row tiles and trims;
// this kernel masks the ragged M, N and D edges itself. A leading batch
// dimension (blockIdx.z) serves rank-3 inputs such as redundancy_score's
// stacked concept banks.
//
// Bound: at the shapes of the main path (probe 8x2048x512, redundancy
// 2048x2048x512) the work is 2*M*N*D FLOPs against (M+N)*D + M*N floats
// moved, about 170 FLOP per byte at the redundancy shape, so the fp32
// rate of the CUDA cores bounds it, not memory. The reference contracts at
// Precision.HIGHEST (full fp32); TF32 tensor cores keep about three digits
// and would miss the 3e-5 tolerance, so the dot stays on fp32 FMA.
//
// Design: each 256-thread block owns a 64x64 output tile, each thread a
// 4x4 register micro-tile. D is walked in 16-wide slabs staged through
// shared memory (transposed, so a thread reads its four rows and four
// columns as float4). The same slabs feed the squared norms: threads 0-63
// accumulate |x_i|^2 for the tile's rows, threads 64-127 |y_j|^2 for its
// columns, so neither operand is read from device memory twice for the
// norms. The epilogue applies both rsqrtf factors and writes the tile with
// the M and N edges masked.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;   // output tile is TILE x TILE
constexpr int BK = 16;     // D slab width
constexpr int MICRO = 4;   // per-thread micro-tile is MICRO x MICRO
constexpr int THREADS = (TILE / MICRO) * (TILE / MICRO);  // 256
constexpr int PAD = 4;     // keeps float4 alignment, spreads banks

__global__ void __launch_bounds__(THREADS)
cosine_kernel(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ out, int m, int n, int d,
              long long x_batch_stride, long long y_batch_stride) {
  __shared__ __align__(16) float xs[BK][TILE + PAD];
  __shared__ __align__(16) float ys[BK][TILE + PAD];
  __shared__ float x_inv[TILE];
  __shared__ float y_inv[TILE];

  const int tid = threadIdx.x;
  const int tx = tid % (TILE / MICRO);  // column group
  const int ty = tid / (TILE / MICRO);  // row group
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const long long b = blockIdx.z;
  x += b * x_batch_stride;
  y += b * y_batch_stride;
  out += b * static_cast<long long>(m) * n;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.f;
  float ss = 0.f;  // |x_i|^2 (tid < 64) or |y_j|^2 (64 <= tid < 128)

  for (int k0 = 0; k0 < d; k0 += BK) {
    // Stage the slab: 64 rows x 16 columns of each operand, 4 loads a
    // thread, neighbouring threads on neighbouring columns of one row.
#pragma unroll
    for (int l = 0; l < (TILE * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK;
      const int k = idx % BK;
      const int gk = k0 + k;
      const int gx = row0 + r;
      const int gy = col0 + r;
      xs[k][r] = (gx < m && gk < d) ? x[static_cast<long long>(gx) * d + gk] : 0.f;
      ys[k][r] = (gy < n && gk < d) ? y[static_cast<long long>(gy) * d + gk] : 0.f;
    }
    __syncthreads();

    if (tid < TILE) {
#pragma unroll
      for (int k = 0; k < BK; ++k) ss = fmaf(xs[k][tid], xs[k][tid], ss);
    } else if (tid < 2 * TILE) {
#pragma unroll
      for (int k = 0; k < BK; ++k) ss = fmaf(ys[k][tid - TILE], ys[k][tid - TILE], ss);
    }

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * MICRO]);
      const float4 c = *reinterpret_cast<const float4*>(&ys[k][tx * MICRO]);
      const float av[MICRO] = {a.x, a.y, a.z, a.w};
      const float cv[MICRO] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < TILE) {
    x_inv[tid] = rsqrtf(ss + 1e-24f);
  } else if (tid < 2 * TILE) {
    y_inv[tid - TILE] = rsqrtf(ss + 1e-24f);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int r = row0 + ty * MICRO + i;
    if (r >= m) continue;
    const float xi = x_inv[ty * MICRO + i];
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int c = col0 + tx * MICRO + j;
      if (c < n) out[static_cast<long long>(r) * n + c] = acc[i][j] * xi * y_inv[tx * MICRO + j];
    }
  }
}

}  // namespace

// x: (batch, m, d), y: (batch, n, d), out: (batch, m, n); all float32,
// rows contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int cosine_similarity_f32(const float* x, const float* y, float* out, int batch,
                                     int m, int n, int d, long long x_batch_stride,
                                     long long y_batch_stride, cudaStream_t stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  cosine_kernel<<<grid, THREADS, 0, stream>>>(x, y, out, m, n, d, x_batch_stride,
                                              y_batch_stride);
  return static_cast<int>(cudaGetLastError());
}
