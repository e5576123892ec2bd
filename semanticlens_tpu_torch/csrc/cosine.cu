// Fused cosine-similarity matrix for Hopper (sm_90a): three hand-written kernels.
//
// Replaces the TPU kernel semanticlens_tpu/ops/pallas_ops.py:
// cosine_similarity_matrix (body _cosine_kernel): for x (M, D) and y (N, D),
//     out[i, j] = (x_i . y_j) * rsqrt(|x_i|^2 + 1e-24) * rsqrt(|y_j|^2 + 1e-24)
// so zero rows give 0. The reference contracts at Precision.HIGHEST (full
// fp32); its tests hold atol 3e-5. A leading batch dimension serves rank-3
// inputs such as redundancy_score's stacked concept banks. The wrapper
// (ops/cosine.py) picks the kernel by shape and pads D with zeros to a
// multiple of 4 (16-byte rows), which changes neither dots nor norms.
//
// 1. cosine_tiled_kernel (redundancy: bank against bank). The work is
//    2*M*N*D FLOPs against 4*(M*D + N*D + M*N) bytes, ~170 FLOP per byte at
//    2048x2048x512, so arithmetic bounds it. fp32 FMA on the CUDA cores
//    peaks at 67 TFLOP/s; the tensor cores run TF32 at 495 TFLOP/s, but one
//    TF32 pass keeps a 10-bit mantissa and misses 3e-5 (~6e-5 at D=512). So
//    each operand is split as big = tf32_rna(a), small = tf32_rna(a - big),
//    and the dot is small.big + big.small + big.big (3xTF32, as CUTLASS's
//    fast-fp32 GEMM): |a - big - small| <= 2^-22 |a| and the dropped
//    small.small term is <= 2^-22 |a||b|, so the products are as precise as
//    fp32, at a bound of 495/3 = 165 TFLOP/s, 2.5x the fp32 rate.
//    The tensor cores' fp32 accumulator rounds toward zero on each of its
//    3*D/8 adds, so over the whole of K its error on a cosine near 1 grows
//    linearly with D and passes 3e-5 at large D. So they accumulate at most
//    FLUSH_K = 512 of K; each earlier group's partial is added, rounded to
//    nearest, into the output buffer (read back by the thread that wrote
//    it), which bounds the error independently of D (chip_smoke.py's scan
//    against float64). D <= 512 (the main path) never flushes.
//    Design: a block owns a (64*WG) x BN output tile; WG consumer
//    warpgroups (64 rows each) and one producer warp. The producer streams
//    K-slabs of x and y (16 fp32 = one 64-byte swizzle row; 32-wide slabs
//    with the 128-byte swizzle would leave room for 2 stages instead of 4,
//    so TMA would run less far ahead) with TMA (3-D
//    tensor maps over (batch, rows, D): zero fill at the M/N/D edges stays
//    inside one batch) into a ring of STAGES shared-memory stages,
//    completion on mbarriers. The consumers take each slab's squared norms
//    from the raw fp32 values, split it in place (big over the raw values,
//    small into a parallel buffer at the same swizzled offsets), fence the
//    generic writes to the async proxy, and issue wgmma.m64nBNk8.f32.tf32.tf32
//    from shared memory (x and y are both K-major as stored: no transpose),
//    keeping one slab's products in flight while the next slab is split.
//    Shared-memory bandwidth is what is left between it and the tensor-core
//    bound: for a 128x256 tile the split's reads and writes and wgmma's
//    operand reads move ~190 KB per 16-wide slab, ~130 B/clk at the tensor
//    cores' peak against 128 B/clk. The epilogue applies both rsqrt factors
//    and stores with the M and N edges masked.
// 2. cosine_streaming_kernel (text probing: a few queries against a bank).
//    At 8x2048x512 the work is 17 MFLOP against 4.3 MB, so bytes bound it
//    (1.3 us at 3.35 TB/s), and exact fp32 FMA on the CUDA cores costs
//    little next to that. Each block stages x (M x D) once in shared memory
//    with cp.async; each warp streams whole y rows with 16-byte read-only
//    loads, computing all M dots and the row's own norm from one read of
//    the row, reduced with warp shuffles. The grid covers the SMs twice.
//    It is compiled for M <= 32. Its time grows with M*N (x is re-read from
//    shared memory for every y row), so the wrapper sends larger problems to
//    the tiled kernel.
// 3. cosine_topk_tiled_kernel, K1b (the audit search and labeling: each row
//    of x's k best rows of y, k <= KMAX = 32). The TPU kernel's note names
//    the fused form ("masked per-row top-k similarity"); it wrote none. At
//    1024 x 1,048,576 x 512 the matrix is 4.3 GB, and writing it in blocks
//    for torch.topk to read back cost more than the products. K1b runs the
//    tiled kernel's main loop unchanged (mma_slabs: the split, 3xTF32 wgmma,
//    the TMA ring; the flush every FLUSH_K into a per-block buffer, `part`,
//    in place of the output; the same rsqrt factors applied in the same
//    order, so every score is bitwise the tiled kernel's), and replaces the
//    store with an exact running top-k per row: no score reaches device
//    memory. Design:
//    - Persistent blocks: a block owns 128 rows of x and a contiguous run of
//      256-wide column tiles (one of `splits` near-equal runs, the host's
//      choice: whole waves, one block an SM) and walks it in ascending column
//      order. The producer warp's ring runs on across tiles, so the next
//      tile's first slabs load during the selection.
//    - Each row keeps a ranked list of KMAX (value, column) entries in shared
//      memory. After a tile's products, phase 1 marks the 8-column groups
//      where some score is not below its row's k-th value: two multiplies
//      and a compare a score, and after the first tiles few groups (about
//      k(1 + ln(n/k)) of a split's n columns enter). Phase 2 takes the
//      warp's marked groups in turn; a switch fetches the group's
//      accumulators (registers cannot be indexed), and each exact survivor
//      is offered to its row with the whole warp inserting: lane i holds
//      entry i, one ballot counts the entries ranked before the candidate,
//      the rest shift down one lane. Phase 2's code exists once: the first
//      form, with insertion code in every group and each row's quad sharing
//      the list, ran 2.4x slower (spills, and every slot walked).
//    - Ranking: the larger value first, NaN above every number, the lower
//      column on equal values (-0 == +0): torch's stable descending sort and
//      lax.top_k. Insertions commute, so the order survivors come in does not
//      change the list.
//    - Output: each row's first k entries per split, side by side in split
//      order, (M, splits * k). Columns ascend with the split, so a stable
//      descending sort of that by value, cut to k, is the exact top-k (the
//      wrapper's merge). A split narrower than k (only the last can be: a
//      tile is 256 wide) pads with (-inf, INT_MAX).
//    - Registers: 288 threads leave 168 a thread (three warps share a
//      quarter of the SM's file); the accumulators take 128. The flush loop
//      inside the tile loop pushes them into local memory (and ptxas then
//      serializes wgmma), so it is compiled only into the D > FLUSH_K
//      instance; setmaxnreg with a producer warpgroup did not lift ptxas's
//      limit.
//    Shared memory at the 128 x 256 tile, 4 stages: the tiled kernel's
//    199,232 B + 128 rows x 32 x 8 B of lists = 232,000 of 232,448 B. A
//    longer list would cost a stage.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr float kEps = 1e-24f;
constexpr int kErrTensorMapEntry = -1;  // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMapEncode = -2;  // the CUDA driver refused a tensor map
constexpr int kErrConfig = -3;           // no such tile configuration, M too large, or k / splits out of range

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// -------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// The tiled kernel walks D in K-slabs of BK fp32: one 64-byte row, the span
// of TMA's 64-byte swizzle.
constexpr int BK = 16;
constexpr int ROW_BYTES = BK * 4;

// Shared-memory matrix descriptor for a K-major tile in the 64-byte swizzled
// layout that TMA writes: rows of ROW_BYTES, 8-row groups 8 * ROW_BYTES apart.
__device__ __forceinline__ uint64_t swizzled_desc(const void* p) {
  uint64_t desc = (smem_u32(p) & 0x3FFFFu) >> 4;  // start address
  desc |= uint64_t(1) << 16;                     // leading byte offset (unused when swizzled)
  desc |= uint64_t(8 * ROW_BYTES >> 4) << 32;    // stride byte offset: one 8-row group
  desc |= uint64_t(2) << 62;                     // swizzle mode: 64 bytes
  return desc;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_m64n256k8(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 256) {
    wgmma_tf32_m64n256k8(d, desc_a, desc_b);
  } else {
    static_assert(BN == 128, "BN must be 128 or 256");
    wgmma_tf32_m64n128k8(d, desc_a, desc_b);
  }
}

// Round to TF32 (10-bit mantissa), nearest with ties away from zero; the low
// 13 bits of cvt's result are not specified, so they are cleared.
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r & 0xFFFFE000u);
}

__device__ __forceinline__ void split_tf32(float4& v, float4& small) {
  const float bx = tf32_rna(v.x), by = tf32_rna(v.y), bz = tf32_rna(v.z), bw = tf32_rna(v.w);
  small = make_float4(tf32_rna(v.x - bx), tf32_rna(v.y - by), tf32_rna(v.z - bz), tf32_rna(v.w - bw));
  v = make_float4(bx, by, bz, bw);
}

__device__ __forceinline__ float sq4(const float4 v, float s) {
  return fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, fmaf(v.x, v.x, s))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// ------------------------------------------------------------ tiled kernel
// A block owns a BM x BN output tile (BM = 64 * WG) and walks D in K-slabs
// of BK through a ring of STAGES shared-memory stages.
// K accumulated by the tensor cores before their partial is flushed, rounded
// to nearest, into the output (see the header); D <= FLUSH_K never flushes.
constexpr int FLUSH_K = 512;

template <int WG, int BN, int STAGES>
struct Tiled {
  static constexpr int BM = 64 * WG;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);  // big (TMA target) + small
  static constexpr int SMEM_BYTES = 1024 /* alignment slack */ + STAGES * STAGE_BYTES + (BM + BN) * 4 +
                                    2 * STAGES * 8;
  static constexpr int CHUNKS = BK / 4;                     // 16-byte chunks of a row
  static constexpr int ROWS_PER_PASS = CONSUMERS / CHUNKS;  // one thread per chunk
  static constexpr int A_PASSES = BM / ROWS_PER_PASS;
  static constexpr int B_PASSES = BN / ROWS_PER_PASS;
  static constexpr int FLUSH_SLABS = FLUSH_K / BK;
  static constexpr int MIN_BLOCKS = SMEM_BYTES <= 113 * 1024 ? 2 : 1;
};

// Split rows [0, PASSES*ROWS_PER_PASS) of one K-slab in place and add the
// raw values' squares to this thread's row sums. The swizzle only permutes
// the 16-byte chunks within a row, which neither the elementwise split nor
// a row sum sees.
template <int PASSES, int ROWS_PER_PASS, int CHUNKS>
__device__ __forceinline__ void split_slab(float4* big, float4* small, float (&norm)[PASSES], int prow,
                                           int chunk) {
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int idx = (p * ROWS_PER_PASS + prow) * CHUNKS + chunk;
    float4 v = big[idx];
    norm[p] = sq4(v, norm[p]);
    float4 s;
    split_tf32(v, s);
    big[idx] = v;
    small[idx] = s;
  }
}

// Sum over the CHUNKS neighbouring lanes that share a row.
template <int CHUNKS>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < CHUNKS; o <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// The partial sum a previous flush left at out[r][c], c + 1 (0 where none, or
// outside the matrix).
__device__ __forceinline__ float2 flushed_pair(const float* out_b, bool flushed, int r, int c, int m, int n,
                                               bool pairs) {
  float2 v = make_float2(0.f, 0.f);
  if (flushed && r < m) {
    const float* p = out_b + static_cast<long long>(r) * n + c;
    if (pairs && c + 1 < n) {
      v = *reinterpret_cast<const float2*>(p);
    } else {
      if (c < n) v.x = p[0];
      if (c + 1 < n) v.y = p[1];
    }
  }
  return v;
}

__device__ __forceinline__ void store_pair(float* out_b, int r, int c, int m, int n, bool pairs, float v0,
                                           float v1) {
  if (r >= m) return;
  float* p = out_b + static_cast<long long>(r) * n + c;
  if (pairs && c + 1 < n) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (c < n) p[0] = v0;
    if (c + 1 < n) p[1] = v1;
  }
}

// Slabs [k0, k1) of the consumers' K loop: wait for each slab, split it (and
// take its squared norms), and run its 3xTF32 products into acc, keeping one
// slab's products in flight. Returns with all products done and every stage
// of the range released to the producer.
template <typename C, int BN, int STAGES>
__device__ __forceinline__ void mma_slabs(uint8_t* smem, uint64_t* full, uint64_t* empty, int k0, int k1, int wg,
                                          int prow, int chunk, float (&acc)[BN / 2], float (&nx)[C::A_PASSES],
                                          float (&ny)[C::B_PASSES]) {
  for (int kt = k0; kt < k1; ++kt) {
    const int s = kt % STAGES;
    uint8_t* a_big = smem + s * C::STAGE_BYTES;
    uint8_t* b_big = a_big + C::A_BYTES;
    uint8_t* a_small = b_big + C::B_BYTES;
    uint8_t* b_small = a_small + C::A_BYTES;
    mbar_wait(&full[s], (kt / STAGES) & 1);

    split_slab<C::A_PASSES, C::ROWS_PER_PASS, C::CHUNKS>(reinterpret_cast<float4*>(a_big),
                                                         reinterpret_cast<float4*>(a_small), nx, prow, chunk);
    split_slab<C::B_PASSES, C::ROWS_PER_PASS, C::CHUNKS>(reinterpret_cast<float4*>(b_big),
                                                         reinterpret_cast<float4*>(b_small), ny, prow, chunk);
    // The split wrote with ordinary stores; wgmma reads through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(C::CONSUMERS) : "memory");

    const uint64_t da_big = swizzled_desc(a_big + wg * 64 * ROW_BYTES);
    const uint64_t da_small = swizzled_desc(a_small + wg * 64 * ROW_BYTES);
    const uint64_t db_big = swizzled_desc(b_big);
    const uint64_t db_small = swizzled_desc(b_small);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {  // k8 steps: +32 bytes along the row (+2 in the descriptor)
      const uint64_t off = 2 * kk;
      wgmma_tf32<BN>(acc, da_small + off, db_big + off);
      wgmma_tf32<BN>(acc, da_big + off, db_small + off);
      wgmma_tf32<BN>(acc, da_big + off, db_big + off);
    }
    wgmma_commit();
    fence_regs(acc);
    // Keep this slab's products in flight; the previous slab's are done, so
    // its stage goes back to the producer.
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > k0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(&empty[(k1 - 1) % STAGES]);
}

template <int WG, int BN, int STAGES>
__global__ void __launch_bounds__(Tiled<WG, BN, STAGES>::THREADS, Tiled<WG, BN, STAGES>::MIN_BLOCKS)
    cosine_tiled_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
                        float* __restrict__ out, int m, int n, int d) {
  using C = Tiled<WG, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* x_inv = reinterpret_cast<float*>(smem + STAGES * C::STAGE_BYTES);
  float* y_inv = x_inv + C::BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(y_inv + BN);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * C::BM;
  const int col0 = blockIdx.x * BN;
  const int batch = blockIdx.z;
  const int k_tiles = (d + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {  // producer warp: one thread issues every load
    if (tid == C::CONSUMERS) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* a = smem + s * C::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], C::A_BYTES + C::B_BYTES);
        tma_load_3d(a, &x_map, &full[s], kt * BK, row0, batch);
        tma_load_3d(a + C::A_BYTES, &y_map, &full[s], kt * BK, col0, batch);
      }
    }
    return;
  }

  // Consumers.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int chunk = tid % C::CHUNKS;
  const int prow = tid / C::CHUNKS;
  float* out_b = out + static_cast<long long>(batch) * m * n;
  const bool pairs = (n % 2) == 0;
  // Accumulator layout of wgmma m64nN (f32): register 4j + 2h + e of thread
  // (warp w, lane l) holds row 16w + l/4 + 8h, column 8j + 2(l%4) + e of the
  // warpgroup's 64 x BN tile.
  const int lrow = wg * 64 + warp * 16 + lane / 4;
  float acc[BN / 2];  // the tensor cores' accumulator for the current FLUSH_K of K
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float nx[C::A_PASSES], ny[C::B_PASSES];
#pragma unroll
  for (int p = 0; p < C::A_PASSES; ++p) nx[p] = 0.f;
#pragma unroll
  for (int p = 0; p < C::B_PASSES; ++p) ny[p] = 0.f;

  // Every group but the last ends in a flush. The flush sits in a loop body,
  // not in a branch: a branch that touches the accumulators makes ptxas
  // serialize every wgmma.
  int k0 = 0;
  for (; k0 + C::FLUSH_SLABS < k_tiles; k0 += C::FLUSH_SLABS) {
    mma_slabs<C, BN, STAGES>(smem, full, empty, k0, k0 + C::FLUSH_SLABS, wg, prow, chunk, acc, nx, ny);
    // Add this group's partial into out, rounded to nearest.
    const bool flushed = k0 > 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int r = row0 + lrow + 8 * h, c = col0 + j * 8 + 2 * (lane % 4);
        const float2 prev = flushed_pair(out_b, flushed, r, c, m, n, pairs);
        store_pair(out_b, r, c, m, n, pairs, acc[4 * j + 2 * h] + prev.x, acc[4 * j + 2 * h + 1] + prev.y);
        acc[4 * j + 2 * h] = 0.f;
        acc[4 * j + 2 * h + 1] = 0.f;
      }
  }
  mma_slabs<C, BN, STAGES>(smem, full, empty, k0, k_tiles, wg, prow, chunk, acc, nx, ny);

  // Row norms: the CHUNKS threads of a row hold its partial sums.
#pragma unroll
  for (int p = 0; p < C::A_PASSES; ++p) {
    const float v = row_sum<C::CHUNKS>(nx[p]);
    if (chunk == 0) x_inv[p * C::ROWS_PER_PASS + prow] = rsqrtf(v + kEps);
  }
#pragma unroll
  for (int p = 0; p < C::B_PASSES; ++p) {
    const float v = row_sum<C::CHUNKS>(ny[p]);
    if (chunk == 0) y_inv[p * C::ROWS_PER_PASS + prow] = rsqrtf(v + kEps);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(C::CONSUMERS) : "memory");

  // Epilogue: the last group's partial plus what earlier flushes left in
  // out, times both rsqrt factors, stored with the M and N edges masked.
  const bool flushed = k_tiles > C::FLUSH_SLABS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float xi = x_inv[lrow + 8 * h];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int lc = j * 8 + 2 * (lane % 4);
      const int r = row0 + lrow + 8 * h, c = col0 + lc;
      const float2 prev = flushed_pair(out_b, flushed, r, c, m, n, pairs);
      store_pair(out_b, r, c, m, n, pairs, (acc[4 * j + 2 * h] + prev.x) * xi * y_inv[lc],
                 (acc[4 * j + 2 * h + 1] + prev.y) * xi * y_inv[lc + 1]);
    }
  }
}

// ------------------------------------------------------ top-k tiled kernel
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// Whether (va, ca) ranks before (vb, cb): the larger value first, NaN above
// every number, the lower column first on equal values.
__device__ __forceinline__ bool ranks_before(float va, int ca, float vb, int cb) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ca < cb);
  return va > vb || (va == vb && ca < cb);
}

// Insert (v, c) into a row's ranked list [0, k) (values lv, columns lc, in
// shared memory, KMAX = 32 entries) if it ranks among the first k. The whole
// warp takes part, lane i holding entry i: the entries ranked before (v, c)
// are a prefix, counted by one ballot; the rest shift down one lane.
__device__ __forceinline__ void insert_ranked(float* lv, int* lc, int lane, int k, float v, int c) {
  const float ev = lv[lane];
  const int ec = lc[lane];
  const int above = __popc(__ballot_sync(FULL_MASK, lane < k && ranks_before(ev, ec, v, c)));
  const float pv = __shfl_up_sync(FULL_MASK, ev, 1);
  const int pc = __shfl_up_sync(FULL_MASK, ec, 1);
  if (lane >= above && lane < k) {
    lv[lane] = lane == above ? v : pv;
    lc[lane] = lane == above ? c : pc;
  }
  __syncwarp();
}

// grid (splits, row blocks); block (s, b) walks column tiles [s*T/splits,
// (s+1)*T/splits) of T for rows [b*BM, b*BM + BM) and writes each row's first
// k entries to cand_v / cand_c (m, splits * k) at columns [s*k, s*k + k).
// part: BM x BN floats per block for the flushed partial sums. FLUSH (d >
// FLUSH_K) is a template flag: the flush loop inside the tile loop costs the
// registers that keep the accumulators out of local memory at 168 a thread
// (ptxas then serializes wgmma), so D <= FLUSH_K, the main path, runs without.
template <int WG, int BN, int STAGES, int KMAX, bool FLUSH>
__global__ void __launch_bounds__(Tiled<WG, BN, STAGES>::THREADS, 1)
    cosine_topk_tiled_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
                             float* __restrict__ part, float* __restrict__ cand_v, int* __restrict__ cand_c, int m,
                             int n, int d, int k) {
  static_assert(BN == 256 && KMAX == 32, "the selection names 32 groups of 8 columns, and a list entry a lane");
  using C = Tiled<WG, BN, STAGES>;
  constexpr int E = KMAX / 4;  // list entries each lane of a row's quad sets up and writes out
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* x_inv = reinterpret_cast<float*>(smem + STAGES * C::STAGE_BYTES);
  float* y_inv = x_inv + C::BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(y_inv + BN);
  uint64_t* empty = full + STAGES;
  float* list_v = reinterpret_cast<float*>(empty + STAGES);
  int* list_c = reinterpret_cast<int*>(list_v + C::BM * KMAX);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * C::BM;
  const int k_tiles = (d + BK - 1) / BK;
  const long long col_tiles = (n + BN - 1) / BN;
  const int t0 = static_cast<int>(blockIdx.x * col_tiles / gridDim.x);
  const int t1 = static_cast<int>((blockIdx.x + 1) * col_tiles / gridDim.x);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {  // producer warp: one thread issues every load, the ring running on across tiles
    if (tid == C::CONSUMERS) {
      int g = 0;
      for (int t = t0; t < t1; ++t) {
        for (int kt = 0; kt < k_tiles; ++kt, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(&empty[s], ((g / STAGES) - 1) & 1);
          uint8_t* a = smem + s * C::STAGE_BYTES;
          mbar_arrive_expect_tx(&full[s], C::A_BYTES + C::B_BYTES);
          tma_load_3d(a, &x_map, &full[s], kt * BK, row0, 0);
          tma_load_3d(a + C::A_BYTES, &y_map, &full[s], kt * BK, t * BN, 0);
        }
      }
    }
    return;
  }

  // Consumers: the tiled kernel's layout (see there).
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int chunk = tid % C::CHUNKS;
  const int prow = tid / C::CHUNKS;
  const int q = lane % 4;
  const int lrow = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: lrow and lrow + 8
  float* part_b = FLUSH ? part + static_cast<long long>(blockIdx.y * gridDim.x + blockIdx.x) * C::BM * BN : nullptr;

  // Every list starts with entries that any score outranks.
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < E; ++i) {
      list_v[(lrow + 8 * h) * KMAX + q * E + i] = -INFINITY;
      list_c[(lrow + 8 * h) * KMAX + q * E + i] = INT_MAX;
    }
  __syncwarp();

  float acc[BN / 2];
  float nx[C::A_PASSES], ny[C::B_PASSES];
  for (int t = t0, g = 0; t < t1; ++t, g += k_tiles) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < C::A_PASSES; ++p) nx[p] = 0.f;
#pragma unroll
    for (int p = 0; p < C::B_PASSES; ++p) ny[p] = 0.f;

    // The tiled kernel's K loop and flushes, into part_b in place of out.
    int k0 = 0;
    if constexpr (FLUSH) {
      for (; k0 + C::FLUSH_SLABS < k_tiles; k0 += C::FLUSH_SLABS) {
        mma_slabs<C, BN, STAGES>(smem, full, empty, g + k0, g + k0 + C::FLUSH_SLABS, wg, prow, chunk, acc, nx, ny);
        const bool again = k0 > 0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int r = lrow + 8 * h, c = j * 8 + 2 * q;
            const float2 prev = flushed_pair(part_b, again, r, c, C::BM, BN, true);
            store_pair(part_b, r, c, C::BM, BN, true, acc[4 * j + 2 * h] + prev.x, acc[4 * j + 2 * h + 1] + prev.y);
            acc[4 * j + 2 * h] = 0.f;
            acc[4 * j + 2 * h + 1] = 0.f;
          }
      }
    }
    mma_slabs<C, BN, STAGES>(smem, full, empty, g + k0, g + k_tiles, wg, prow, chunk, acc, nx, ny);

#pragma unroll
    for (int p = 0; p < C::A_PASSES; ++p) {
      const float v = row_sum<C::CHUNKS>(nx[p]);
      if (chunk == 0) x_inv[p * C::ROWS_PER_PASS + prow] = rsqrtf(v + kEps);
    }
#pragma unroll
    for (int p = 0; p < C::B_PASSES; ++p) {
      const float v = row_sum<C::CHUNKS>(ny[p]);
      if (chunk == 0) y_inv[p * C::ROWS_PER_PASS + prow] = rsqrtf(v + kEps);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(C::CONSUMERS) : "memory");

    // Selection: each score as the tiled kernel's epilogue computes it. Phase
    // 1 marks the 8-column groups j where a score is not below its row's k-th
    // value (a superset of what enters: NaN and equal values pass); phase 2
    // takes the warp's marked groups one at a time, recomputes their scores
    // (a switch fetches group j's accumulators: one copy of the code, not one
    // per group) and offers the exact survivors to their rows one by one.
    const float xi0 = x_inv[lrow], xi1 = x_inv[lrow + 8];
    const int col0 = t * BN;
    unsigned marked = 0;
    {
      const float th0 = list_v[lrow * KMAX + k - 1], th1 = list_v[(lrow + 8) * KMAX + k - 1];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int lc = j * 8 + 2 * q;
        const float2 p0 = flushed_pair(part_b, FLUSH, lrow, lc, C::BM, BN, true);
        const float2 p1 = flushed_pair(part_b, FLUSH, lrow + 8, lc, C::BM, BN, true);
        const float y0 = y_inv[lc], y1 = y_inv[lc + 1];
        const float v0 = (acc[4 * j] + p0.x) * xi0 * y0, v1 = (acc[4 * j + 1] + p0.y) * xi0 * y1;
        const float v2 = (acc[4 * j + 2] + p1.x) * xi1 * y0, v3 = (acc[4 * j + 3] + p1.y) * xi1 * y1;
        if (!(v0 < th0) || !(v1 < th0) || !(v2 < th1) || !(v3 < th1)) marked |= 1u << j;
      }
    }
    marked = __reduce_or_sync(FULL_MASK, marked);
    while (marked != 0) {
      const int j = __ffs(marked) - 1;
      marked &= marked - 1;
      float a0, a1, a2, a3;
      switch (j) {
#define K1B_GROUP(J)     \
  case J:                \
    a0 = acc[4 * J];     \
    a1 = acc[4 * J + 1]; \
    a2 = acc[4 * J + 2]; \
    a3 = acc[4 * J + 3]; \
    break;
        K1B_GROUP(0) K1B_GROUP(1) K1B_GROUP(2) K1B_GROUP(3) K1B_GROUP(4) K1B_GROUP(5) K1B_GROUP(6) K1B_GROUP(7)
        K1B_GROUP(8) K1B_GROUP(9) K1B_GROUP(10) K1B_GROUP(11) K1B_GROUP(12) K1B_GROUP(13) K1B_GROUP(14)
        K1B_GROUP(15) K1B_GROUP(16) K1B_GROUP(17) K1B_GROUP(18) K1B_GROUP(19) K1B_GROUP(20) K1B_GROUP(21)
        K1B_GROUP(22) K1B_GROUP(23) K1B_GROUP(24) K1B_GROUP(25) K1B_GROUP(26) K1B_GROUP(27) K1B_GROUP(28)
        K1B_GROUP(29) K1B_GROUP(30) default: K1B_GROUP(31)
#undef K1B_GROUP
      }
      const int lc = j * 8 + 2 * q;
      const float2 p0 = flushed_pair(part_b, FLUSH, lrow, lc, C::BM, BN, true);
      const float2 p1 = flushed_pair(part_b, FLUSH, lrow + 8, lc, C::BM, BN, true);
      const float y0 = y_inv[lc], y1 = y_inv[lc + 1];
      const float vs[4] = {(a0 + p0.x) * xi0 * y0, (a1 + p0.y) * xi0 * y1, (a2 + p1.x) * xi1 * y0,
                           (a3 + p1.y) * xi1 * y1};
#pragma unroll
      for (int which = 0; which < 4; ++which) {  // (row half, column parity)
        const int h = which >> 1;
        const int row = lrow + 8 * h;
        const int c = col0 + lc + (which & 1);
        const bool live = row0 + row < m && c < n;
        unsigned offers = __ballot_sync(
            FULL_MASK, live && ranks_before(vs[which], c, list_v[row * KMAX + k - 1], list_c[row * KMAX + k - 1]));
        while (offers != 0) {  // each lane's score to its row, the whole warp inserting
          const int src = __ffs(offers) - 1;
          offers &= offers - 1;
          const float v = __shfl_sync(FULL_MASK, vs[which], src);
          const int r = wg * 64 + warp * 16 + src / 4 + 8 * h;
          insert_ranked(list_v + r * KMAX, list_c + r * KMAX, lane, k, v, col0 + j * 8 + 2 * (src % 4) + (which & 1));
        }
      }
    }
  }

  // Each row's first k entries, ranked, into its split's k columns.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + lrow + 8 * h;
    if (r >= m) continue;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int at = q * E + i;
      if (at < k) {
        const long long o = (static_cast<long long>(r) * gridDim.x + blockIdx.x) * k + at;
        cand_v[o] = list_v[(lrow + 8 * h) * KMAX + at];
        cand_c[o] = list_c[(lrow + 8 * h) * KMAX + at];
      }
    }
  }
}

// -------------------------------------------------------- streaming kernel
constexpr int STREAM_WARPS = 8;   // one y row per warp at a time
constexpr int STREAM_UNROLL = 4;  // 16-byte loads in flight per lane

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

template <int MT>
__global__ void __launch_bounds__(STREAM_WARPS * 32)
    cosine_streaming_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
                            int m, int n, int d) {
  extern __shared__ float4 xs[];  // m rows of d/4 float4
  __shared__ float x_inv[MT];
  const long long batch = blockIdx.y;
  const int dq = d / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x + batch * m * d);
  const float4* y4 = reinterpret_cast<const float4*>(y + batch * n * d);
  float* out_b = out + batch * m * n;

  // Stage x with every copy in flight at once (a load-store loop would wait
  // out one memory latency per iteration).
  for (int i = threadIdx.x; i < m * dq; i += blockDim.x) cp_async16(&xs[i], &x4[i]);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < m; i += STREAM_WARPS) {
    float s = 0.f;
    for (int q = lane; q < dq; q += 32) s = sq4(xs[i * dq + q], s);
    s = warp_sum(s);
    if (lane == 0) x_inv[i] = rsqrtf(s + kEps);
  }
  __syncthreads();

  for (int j = blockIdx.x * STREAM_WARPS + warp; j < n; j += gridDim.x * STREAM_WARPS) {
    const float4* yr = y4 + static_cast<long long>(j) * dq;
    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.f;
    float ss = 0.f;
    for (int q0 = 0; q0 < dq; q0 += 32 * STREAM_UNROLL) {
      float4 yv[STREAM_UNROLL];
#pragma unroll
      for (int u = 0; u < STREAM_UNROLL; ++u) {
        const int q = q0 + u * 32 + lane;
        yv[u] = q < dq ? __ldg(&yr[q]) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < STREAM_UNROLL; ++u) {
        const int q = q0 + u * 32 + lane;
        if (q >= dq) break;
        ss = sq4(yv[u], ss);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < m) {
            const float4 xv = xs[i * dq + q];
            acc[i] = fmaf(xv.w, yv[u].w, fmaf(xv.z, yv[u].z, fmaf(xv.y, yv[u].y, fmaf(xv.x, yv[u].x, acc[i]))));
          }
        }
      }
    }
    const float yi = rsqrtf(warp_sum(ss) + kEps);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < m) {
        const float v = warp_sum(acc[i]);
        if (lane == i % 32) out_b[static_cast<long long>(i) * n + j] = v * x_inv[i] * yi;
      }
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor-map encoder is a CUDA driver API symbol; take it through the runtime
// so the library needs no link against libcuda.
EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                       &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (batch, rows, d) float32, contiguous, d a multiple of 4; boxes of BK x box_rows,
// swizzled over ROW_BYTES.
int encode_rows_map(CUtensorMap* map, const float* base, int batch, int rows, int d, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrTensorMapEntry;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 4, static_cast<cuuint64_t>(rows) * d * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMapEncode;
}

template <int WG, int BN, int STAGES>
int launch_tiled(const float* x, const float* y, float* out, int batch, int m, int n, int d,
                 cudaStream_t stream) {
  using C = Tiled<WG, BN, STAGES>;
  CUtensorMap x_map, y_map;
  int err = encode_rows_map(&x_map, x, batch, m, d, C::BM);
  if (err == 0) err = encode_rows_map(&y_map, y, batch, n, d, BN);
  if (err != 0) return err;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(cosine_tiled_kernel<WG, BN, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  const dim3 grid((n + BN - 1) / BN, (m + C::BM - 1) / C::BM, batch);
  cosine_tiled_kernel<WG, BN, STAGES><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(x_map, y_map, out, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

// K1b's tile (the tiled kernel's config 0, 128 x 256, 4 stages) and list length.
constexpr int TOPK_WG = 2, TOPK_BN = 256, TOPK_STAGES = 4, TOPK_KMAX = 32;

template <bool FLUSH>
int launch_topk_tiled(const float* x, const float* y, float* part, float* cand_v, int* cand_c, int m, int n, int d,
                      int k, int splits, cudaStream_t stream) {
  using C = Tiled<TOPK_WG, TOPK_BN, TOPK_STAGES>;
  constexpr int SMEM_BYTES = C::SMEM_BYTES + C::BM * TOPK_KMAX * 8;  // + the rows' ranked lists
  if (k < 1 || k > TOPK_KMAX || splits < 1 || splits > (n + TOPK_BN - 1) / TOPK_BN) return kErrConfig;
  if (FLUSH && part == nullptr) return kErrConfig;
  CUtensorMap x_map, y_map;
  int err = encode_rows_map(&x_map, x, 1, m, d, C::BM);
  if (err == 0) err = encode_rows_map(&y_map, y, 1, n, d, TOPK_BN);
  if (err != 0) return err;
  auto kernel = cosine_topk_tiled_kernel<TOPK_WG, TOPK_BN, TOPK_STAGES, TOPK_KMAX, FLUSH>;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  const dim3 grid(splits, (m + C::BM - 1) / C::BM);
  kernel<<<grid, C::THREADS, SMEM_BYTES, stream>>>(x_map, y_map, part, cand_v, cand_c, m, n, d, k);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory above 48 KB must be allowed per kernel: allow the
// device's most, so that a launch is refused only by the hardware's limit.
template <typename Kernel>
cudaError_t allow_max_dynamic_smem(Kernel kernel) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  }
  return e;
}

template <int MT>
int launch_streaming(const float* x, const float* y, float* out, int batch, int m, int n, int d,
                     cudaStream_t stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = allow_max_dynamic_smem(cosine_streaming_kernel<MT>);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  // Two blocks per SM: more would only stage x again.
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid_x = static_cast<int>(
      std::min((static_cast<long long>(n) + STREAM_WARPS - 1) / STREAM_WARPS, 2LL * sms));
  const size_t smem = static_cast<size_t>(m) * d * sizeof(float);
  cosine_streaming_kernel<MT><<<dim3(grid_x, batch), STREAM_WARPS * 32, smem, stream>>>(x, y, out, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All entry points: x (batch, m, d), y (batch, n, d), out (batch, m, n),
// float32, contiguous, 16-byte aligned, d a multiple of 4. They launch on
// `stream` and return 0, a cudaError_t, or a negative code of this file.

// config: an entry of TILED_CONFIGS (id, consumer warpgroups, block cols,
// stages); ops/cosine.py's TILE_CONFIGS names the same tiles.
#define TILED_CONFIGS(X) \
  X(0, 2, 256, 4)        \
  X(1, 1, 128, 4)

extern "C" int cosine_tiled_f32(const float* x, const float* y, float* out, int batch, int m, int n, int d,
                                int config, cudaStream_t stream) {
#define TILED_CASE(id, wg, bn, st) \
  case id: return launch_tiled<wg, bn, st>(x, y, out, batch, m, n, d, stream);
  switch (config) {
    TILED_CONFIGS(TILED_CASE)
    default: return kErrConfig;
  }
#undef TILED_CASE
}

// K1b: x (m, d), y (n, d) as above; cand_v (m, splits * k) float32 and cand_c
// (m, splits * k) int32, each row's k best of every split side by side (see
// the header); part: (row blocks * splits) * 128 * 256 float32 scratch when
// d > 512, else null. 1 <= k <= 32, 1 <= splits <= the 256-wide column tiles.
extern "C" int cosine_topk_tiled_f32(const float* x, const float* y, float* part, float* cand_v, int* cand_c,
                                     int m, int n, int d, int k, int splits, cudaStream_t stream) {
  if (d > FLUSH_K) return launch_topk_tiled<true>(x, y, part, cand_v, cand_c, m, n, d, k, splits, stream);
  return launch_topk_tiled<false>(x, y, part, cand_v, cand_c, m, n, d, k, splits, stream);
}

// m <= 32; x (m * d * 4 bytes) is staged in shared memory, so a launch
// whose x exceeds the device's shared memory per block is refused.
extern "C" int cosine_streaming_f32(const float* x, const float* y, float* out, int batch, int m, int n, int d,
                                    cudaStream_t stream) {
  if (m <= 8) return launch_streaming<8>(x, y, out, batch, m, n, d, stream);
  if (m <= 16) return launch_streaming<16>(x, y, out, batch, m, n, d, stream);
  if (m <= 32) return launch_streaming<32>(x, y, out, batch, m, n, d, stream);
  return kErrConfig;
}
