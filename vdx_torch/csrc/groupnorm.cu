// K2 and K3 — fused GroupNorm(+SiLU) over channels-last [B, S, C] for
// Hopper (sm_90a): a one-pass cluster kernel (K2) and a streaming kernel
// (K3).
//
// Replaces: vdx/kernels/groupnorm.py  fused_group_norm (:117, pallas_call
//   :136, body _gn_kernel :62; K2) and fused_group_norm_2phase (:205,
//   pallas_calls :226 statistics and :241 normalise; K3).
//
// Computes, per sample b and group g (C/G channels, all S rows):
//   mean = E[x], var = max(E[x^2] - mean^2, 0), inv = rsqrt(var + eps)
//   y = x * (gamma * inv) + (beta - mean * gamma * inv), then SiLU if asked,
// with fp32 statistics and fp32 arithmetic whatever the storage type
// (fp32 or bf16). gamma/beta arrive as fp32.
//
// What bounds it on this card: bytes. GroupNorm does a few operations per
// element, far below the ~295 operations per byte at which the H100 stops
// being memory bound, so the floor is one read of x and one write of y
// (168 MB -> 0.050 ms at [32, 4096, 320] bf16).
//
// What the design does about it (the launch plan, route, stripe, cluster
// and rows, is chosen in Python: kernels/groupnorm.py, gn_plan):
//  * K2, one pass (gn_cluster_kernel), where one sample's stripe of whole
//    groups fits the shared memory of a thread-block cluster with two
//    CTAs an SM. A stripe is the fewest whole groups (1, 2, 4 or 8) whose
//    channels fill a multiple of 16 bytes and at least 160 bytes a row
//    (8 groups, 160 bytes, at C = 320 in bf16; 80-byte rows ran slower).
//    One cluster of n CTAs (n <= 16) per (stripe, sample); CTA rank r
//    holds rows [r * rows, (r + 1) * rows) of the stripe, brought into
//    shared memory by TMA (a 3-D tensor map over [B, S, C], boxes of
//    [box_rows, stripe] rows, all issued at the start, one mbarrier each;
//    rows past S come in as zeros). Each CTA sums fp32 partial moments
//    per group over 16-byte vectors as its boxes land, the cluster
//    exchanges the partials through distributed shared memory, and every
//    CTA normalises its rows from shared memory and stores them in
//    16-byte vectors. x crosses device memory once; one launch. With two
//    CTAs an SM (rows under ~113 KB a CTA) one CTA's stores overlap
//    another's loads; a CTA's load, cluster wait and normalise run one
//    after another, which holds K2 near 55-60% of the bytes bound on an
//    H100 (a persistent, double-buffered form of the same kernel was
//    slower).
//  * K3, streaming (gn_stream_stats_kernel, gn_stream_apply_kernel), for
//    stripes no such cluster holds (the motion module's GN over frames x
//    space at levels 0-1, most of the VAE's, C up to 4096). Two launches
//    over the same (row chunk, sample) grid: the first writes per-chunk
//    partial moments [B, n_chunks, 2, G]; the second reduces them in its
//    prologue, then normalises its chunk. x is read twice, y written once
//    (floor 1.5x the bound). Each thread keeps K3_UNROLL 16-byte loads in
//    flight (32 KB a CTA at 256 threads in bf16), 8 channels a thread and
//    rows strided by the CTA's row groups; C > 2048 walks the row in
//    column passes of 256 vectors.
//  * SiLU takes two special-function-unit operations an element (__expf,
//    __fdividef), not the IEEE division's dozen instructions.
//
// Order of summation (for the tolerance; tests/test_torch_port_gn_plan.py
// emulates both in PyTorch):
//  * K2: thread t of a CTA holds vector column t % VPR (VPR = stripe
//    bytes / 16) and rows t / VPR, + RY, ... (RY = threads / VPR); it sums
//    each element's x and x^2 over its rows in row order, then folds its
//    elements into per-group sums in channel order; a warp reduces by an
//    xor-shuffle tree (offsets 16, 8, 4, 2, 1); one thread sums the warps
//    in order; every CTA of the cluster then sums the ranks' partials in
//    rank order 0..n-1, so all ranks hold the same bits.
//  * K3: each thread sums its 8 channels over its rows of the chunk in row
//    order; then per group, one thread sums the CTA's row groups in order,
//    each over the group's channels in order; the apply kernel's prologue
//    sums the chunks in chunk order.
// No atomics: both are deterministic run to run. Against a pairwise-summed
// reference the moments differ by a few fp32 ulps of the sums, far below
// one bf16 ulp of the output.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_MAX = 232448;  // 227 KB a block may use
constexpr int K2_MAX_THREADS = 512;
constexpr int K2_MAX_BOXES = 32;
constexpr int K2_MAX_GPS = 8;      // groups a stripe
constexpr int K2_MAX_CLUSTER = 16;
constexpr int K2_MAX_STRIPE = 256; // channels: a TMA box dimension's limit
constexpr int K3_THREADS = 256;
constexpr int K3_UNROLL = 8;
constexpr int K3_MAX_C = 4096;     // 8 channels per thread and column pass
constexpr int MAX_G = 128;

// y * sigmoid(y) on the special-function unit: ex2 and a reciprocal
// (__expf, __fdividef; a few fp32 ulps, far below one bf16 ulp of the
// output; y / inf -> 0 where exp(-y) overflows)
__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}

// 16-byte vectors: 8 bf16 or 4 fp32 values
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// 8 channels (one or two 16-byte vectors) for K3's streaming layout
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  load_vec(p, f);
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  store_vec(p, f);
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- K2 --
// grid (n * C / stripe_ch, B), clusters of n CTAs along x: cluster
// blockIdx.x / n is the stripe (neighbouring stripes of a sample run side
// by side, so their rows' shared sectors meet in L2), rank r its rows
// [r * rows, min(S, (r + 1) * rows)). Shared memory: the rank's rows as
// one flat [rows][stripe] array, box i at row i * box_rows.
template <typename T>
__global__ void __launch_bounds__(K2_MAX_THREADS)
gn_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y, int S,
                  int C, int cpg, int stripe_ch, int rows, int box_rows,
                  float eps, int with_silu) {
  constexpr int EPV = 16 / sizeof(T);  // values a 16-byte vector
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[K2_MAX_BOXES];
  __shared__ float red[K2_MAX_THREADS / 32][2 * K2_MAX_GPS];
  __shared__ float part[2 * K2_MAX_GPS];  // this rank's; the cluster reads it
  __shared__ float tot[2 * K2_MAX_GPS];

  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int stripe = blockIdx.x / n;
  const int b = blockIdx.y;
  const int r0 = rank * rows;
  const int nr = max(0, min(S - r0, rows));
  const int W = stripe_ch * (int)sizeof(T);  // bytes a row
  const int VPR = W / 16;
  const int RY = blockDim.x / VPR;
  const int col = threadIdx.x % VPR;
  const int ry = threadIdx.x / VPR;
  const int gps = stripe_ch / cpg;
  unsigned char* data = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);

  if (threadIdx.x == 0) {
    const int nbox = (nr + box_rows - 1) / box_rows;
    for (int i = 0; i < nbox; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < nbox; ++i) {
      const uint32_t bar = smem_u32(&bars[i]);
      mbar_expect_tx(bar, (uint32_t)(box_rows * W));
      tma_load_3d(smem_u32(data + (size_t)i * box_rows * W), &xmap, bar,
                  stripe * stripe_ch, r0 + i * box_rows, b);
    }
  }
  __syncthreads();

  // statistics: each element's sums over this thread's rows, in row order
  float s1[EPV], s2[EPV];
#pragma unroll
  for (int j = 0; j < EPV; ++j) { s1[j] = 0.0f; s2[j] = 0.0f; }
  int ready = 0;  // boxes this thread has waited for
  for (int r = ry; r < nr; r += RY) {
    while (r >= ready * box_rows) mbar_wait(smem_u32(&bars[ready++]), 0);
    float f[EPV];
    load_vec(reinterpret_cast<const T*>(data + (size_t)r * W) + col * EPV, f);
#pragma unroll
    for (int j = 0; j < EPV; ++j) {
      s1[j] += f[j];
      s2[j] += f[j] * f[j];
    }
  }
  // fold the elements into their groups of the stripe, in channel order
  float g1[K2_MAX_GPS], g2[K2_MAX_GPS];
#pragma unroll
  for (int k = 0; k < K2_MAX_GPS; ++k) { g1[k] = 0.0f; g2[k] = 0.0f; }
#pragma unroll
  for (int j = 0; j < EPV; ++j) {
    const int gi = (col * EPV + j) / cpg;
#pragma unroll
    for (int k = 0; k < K2_MAX_GPS; ++k)
      if (gi == k) { g1[k] += s1[j]; g2[k] += s2[j]; }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K2_MAX_GPS; ++k) {
    if (k < gps) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        g1[k] += __shfl_xor_sync(0xffffffffu, g1[k], off);
        g2[k] += __shfl_xor_sync(0xffffffffu, g2[k], off);
      }
      if (lane == 0) {
        red[warp][k] = g1[k];
        red[warp][gps + k] = g2[k];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * gps) {
    float acc = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) acc += red[w][threadIdx.x];
    part[threadIdx.x] = acc;
  }
  cluster.sync();  // every rank's partials are in its shared memory
  if (threadIdx.x < 2 * gps) {
    float acc = 0.0f;
    for (int q = 0; q < n; ++q) acc += cluster.map_shared_rank(part, q)[threadIdx.x];
    tot[threadIdx.x] = acc;
  }
  // this rank is done reading the others' partials; each waits for all
  // before it exits, so no rank's shared memory goes while it is read
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // normalise this thread's rows from shared memory
  const float cnt = (float)S * (float)cpg;
  float sc[EPV], sh[EPV];
#pragma unroll
  for (int j = 0; j < EPV; ++j) {
    const int cs = col * EPV + j;
    const int gi = cs / cpg;
    const float mean = tot[gi] / cnt;
    const float var = fmaxf(tot[gps + gi] / cnt - mean * mean, 0.0f);
    const float inv = rsqrtf(var + eps);
    const int c = stripe * stripe_ch + cs;
    sc[j] = gamma[c] * inv;
    sh[j] = beta[c] - mean * sc[j];
  }
  T* yb = y + ((size_t)b * S + r0) * C + (size_t)stripe * stripe_ch + col * EPV;
#pragma unroll 4
  for (int r = ry; r < nr; r += RY) {
    float f[EPV];
    load_vec(reinterpret_cast<const T*>(data + (size_t)r * W) + col * EPV, f);
#pragma unroll
    for (int j = 0; j < EPV; ++j) {
      const float v = f[j] * sc[j] + sh[j];
      f[j] = with_silu ? silu(v) : v;
    }
    store_vec(yb + (size_t)r * C, f);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------- K3 --
// Thread layout shared by the statistics and apply kernels: NV = C/8
// vectors per row, TN = min(NV, K3_THREADS) threads per row, RY =
// K3_THREADS / TN row groups; thread (cx, ry) handles channels col*8 ..
// col*8+7 for col = cx, cx + TN, ... < NV (one column pass unless
// C > 2048) of rows r0 + ry, r0 + ry + RY, ... < r1.
struct K3Layout {
  int NV, TN, RY, cx, ry;
  __device__ explicit K3Layout(int C) {
    NV = C >> 3;
    TN = min(NV, K3_THREADS);
    RY = K3_THREADS / TN;
    cx = threadIdx.x % TN;
    ry = threadIdx.x / TN;
  }
};

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
gn_stream_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                       int S, int C, int G, int rows_per_chunk) {
  // per-(row group, channel) sums: [2][RY * C]
  extern __shared__ float part_s[];
  const K3Layout L(C);
  const int part_n = L.RY * C;
  float* part[2] = {part_s, part_s + part_n};
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const int step = L.RY * K3_UNROLL;

  if (L.ry < L.RY) {
    for (int col = L.cx; col < L.NV; col += L.TN) {
      const T* xb = x + (size_t)b * S * C + col * 8;
      float s1[8], s2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) { s1[j] = 0.0f; s2[j] = 0.0f; }
      int r = r0 + L.ry;
      // K3_UNROLL rows in flight, then their sums in row order
      for (; r + (K3_UNROLL - 1) * L.RY < r1; r += step) {
        float f[K3_UNROLL][8];
#pragma unroll
        for (int u = 0; u < K3_UNROLL; ++u)
          load8(xb + (size_t)(r + u * L.RY) * C, f[u]);
#pragma unroll
        for (int u = 0; u < K3_UNROLL; ++u)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s1[j] += f[u][j];
            s2[j] += f[u][j] * f[u][j];
          }
      }
      for (; r < r1; r += L.RY) {
        float f[8];
        load8(xb + (size_t)r * C, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s1[j] += f[j];
          s2[j] += f[j] * f[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        part[0][L.ry * C + col * 8 + j] = s1[j];
        part[1][L.ry * C + col * 8 + j] = s2[j];
      }
    }
  }
  __syncthreads();
  const int cpg = C / G;
  if (threadIdx.x < 2 * G) {
    const int m = threadIdx.x / G;
    const int g = threadIdx.x - m * G;
    float acc = 0.0f;
    for (int q = 0; q < L.RY; ++q)
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) acc += part[m][q * C + c];
    partials[(((size_t)b * n_chunks + chunk) * 2 + m) * G + g] = acc;
  }
}

// grid (n_chunks, B), the statistics kernel's; the prologue reduces the
// sample's chunk partials in chunk order (every CTA of the sample gets
// the same bits), then the CTA normalises its chunk.
template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
gn_stream_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ partials, T* __restrict__ y,
                       int S, int C, int G, int rows_per_chunk, float eps,
                       int with_silu) {
  extern __shared__ float sc_s[];  // [C] scales, [C] offsets, [2G] sums
  float* off_s = sc_s + C;
  float* tot = off_s + C;
  const int n_chunks = gridDim.x;
  const int b = blockIdx.y;
  const int cpg = C / G;
  if (threadIdx.x < 2 * G) {  // [chunk][m][g]: index m * G + g
    const float* p = partials + (size_t)b * n_chunks * 2 * G + threadIdx.x;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < n_chunks; ++k) acc += p[(size_t)k * 2 * G];
    tot[threadIdx.x] = acc;
  }
  __syncthreads();
  const float cnt = (float)S * (float)cpg;
  for (int c = threadIdx.x; c < C; c += K3_THREADS) {
    const int g = c / cpg;
    const float mean = tot[g] / cnt;
    const float var = fmaxf(tot[G + g] / cnt - mean * mean, 0.0f);
    const float inv = rsqrtf(var + eps);
    const float sc = gamma[c] * inv;
    sc_s[c] = sc;
    off_s[c] = beta[c] - mean * sc;
  }
  __syncthreads();
  const K3Layout L(C);
  if (L.ry >= L.RY) return;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const int step = L.RY * K3_UNROLL;
  for (int col = L.cx; col < L.NV; col += L.TN) {
    float sc[8], off[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = sc_s[col * 8 + j];
      off[j] = off_s[col * 8 + j];
    }
    const size_t base = (size_t)b * S * C + col * 8;
    int r = r0 + L.ry;
    for (; r + (K3_UNROLL - 1) * L.RY < r1; r += step) {
      float f[K3_UNROLL][8];
#pragma unroll
      for (int u = 0; u < K3_UNROLL; ++u)
        load8(x + base + (size_t)(r + u * L.RY) * C, f[u]);
#pragma unroll
      for (int u = 0; u < K3_UNROLL; ++u) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = f[u][j] * sc[j] + off[j];
          f[u][j] = with_silu ? silu(v) : v;
        }
        store8(y + base + (size_t)(r + u * L.RY) * C, f[u]);
      }
    }
    for (; r < r1; r += L.RY) {
      float f[8];
      load8(x + base + (size_t)r * C, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = f[j] * sc[j] + off[j];
        f[j] = with_silu ? silu(v) : v;
      }
      store8(y + base + (size_t)r * C, f);
    }
  }
}

// ---------------------------------------------------------------- host --

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// [B, S, C] at `p` as dims (C, S, B), box (stripe_ch, box_rows, 1), zero
// fill past S
template <typename T>
bool encode_x(CUtensorMap* map, const void* p, int B, int S, int C,
              int stripe_ch, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T),
                                 (cuuint64_t)S * C * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)stripe_ch, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, type, 3, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K2's dynamic shared bytes: 128 of alignment slack, then the rank's rows
// rounded up to whole boxes (kernels/groupnorm.py, k2_plan, counts the
// same)
int k2_smem(int rows, int box_rows, int W) {
  const int nbox = (rows + box_rows - 1) / box_rows;
  return 128 + nbox * box_rows * W;
}

template <typename T>
cudaError_t launch_k2(const void* x, const void* gamma, const void* beta,
                      void* y, int B, int S, int C, int G, int stripe_ch,
                      int n, int rows, int box_rows, int threads, float eps,
                      int with_silu, cudaStream_t stream) {
  if (G < 1 || C % G != 0 || B < 1 || B > 65535 || S < 1) return cudaErrorInvalidValue;
  const int cpg = C / G;
  const int W = stripe_ch * (int)sizeof(T);
  const int VPR = W / 16;
  if (stripe_ch < cpg || stripe_ch % cpg != 0 || C % stripe_ch != 0 ||
      W % 16 != 0 || stripe_ch > K2_MAX_STRIPE ||
      stripe_ch / cpg > K2_MAX_GPS || n < 1 || n > K2_MAX_CLUSTER ||
      rows < 1 || (long long)rows * n < S || box_rows < 8 ||
      box_rows > 256 || box_rows % 8 != 0 ||
      (rows + box_rows - 1) / box_rows > K2_MAX_BOXES || threads < 32 ||
      threads > K2_MAX_THREADS || threads % 32 != 0 || threads % VPR != 0 ||
      !aligned16(x) || !aligned16(y))
    return cudaErrorInvalidValue;
  const int smem = k2_smem(rows, box_rows, W);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap xmap;
  if (!encode_x<T>(&xmap, x, B, S, C, stripe_ch, box_rows))
    return cudaErrorInvalidValue;
  auto kern = gn_cluster_kernel<T>;
  // the kernel's attributes and the non-portable clusters' fit are set and
  // asked once per value (host calls the launch need not repeat)
  static int smem_allowed = 0;
  static bool nonportable = false;
  static int fit_key[16][2];
  static bool fit_val[16];
  static int n_fit = 0;
  cudaError_t err;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  if (n > 8 && !nonportable) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * (C / stripe_ch), B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (n > 8) {  // a non-portable size: can the card place one such cluster?
    int i = 0;
    while (i < n_fit && (fit_key[i][0] != smem || fit_key[i][1] != threads)) ++i;
    if (i == n_fit) {
      int fits = 0;
      err = cudaOccupancyMaxActiveClusters(&fits, kern, &cfg);
      if (err != cudaSuccess) return err;
      if (n_fit < 16) {
        fit_key[n_fit][0] = smem;
        fit_key[n_fit][1] = threads;
        fit_val[n_fit++] = fits > 0;
      }
      if (fits < 1) return cudaErrorInvalidConfiguration;
    } else if (!fit_val[i]) {
      return cudaErrorInvalidConfiguration;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kern, xmap, static_cast<const float*>(gamma),
                           static_cast<const float*>(beta), static_cast<T*>(y),
                           S, C, cpg, stripe_ch, rows, box_rows, eps, with_silu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ``work`` holds B * n_chunks * 2 * G partial moments.
template <typename T>
cudaError_t launch_k3(const void* x, const void* gamma, const void* beta, void* y,
                      void* work, int B, int S, int C, int G, int rows_per_chunk,
                      float eps, int with_silu, cudaStream_t stream) {
  if (G < 1 || G > MAX_G || C % G != 0 || C % 8 != 0 || C > K3_MAX_C ||
      rows_per_chunk < 1 || B < 1 || B > 65535 || S < 1 || !aligned16(x) ||
      !aligned16(y))
    return cudaErrorInvalidValue;
  const int n_chunks = (S + rows_per_chunk - 1) / rows_per_chunk;
  float* partials = static_cast<float*>(work);
  const dim3 grid(n_chunks, B);
  // RY * C floats of partials per moment: at most K3_THREADS * 8 for one
  // column pass, C for several
  const int TN = C / 8 < K3_THREADS ? C / 8 : K3_THREADS;
  const size_t part_bytes = 2 * sizeof(float) * (size_t)(K3_THREADS / TN) * C;
  gn_stream_stats_kernel<T><<<grid, K3_THREADS, part_bytes, stream>>>(
      static_cast<const T*>(x), partials, S, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_stream_apply_kernel<T><<<grid, K3_THREADS,
                              sizeof(float) * (2 * C + 2 * G), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), partials, static_cast<T*>(y), S, C, G,
      rows_per_chunk, eps, with_silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vdx_group_norm_cluster_f32(
    const void* x, const void* gamma, const void* beta, void* y, int B, int S,
    int C, int G, int stripe_ch, int cluster, int rows, int box_rows,
    int threads, float eps, int with_silu, void* stream) {
  return (int)launch_k2<float>(x, gamma, beta, y, B, S, C, G, stripe_ch,
                               cluster, rows, box_rows, threads, eps, with_silu,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int vdx_group_norm_cluster_bf16(
    const void* x, const void* gamma, const void* beta, void* y, int B, int S,
    int C, int G, int stripe_ch, int cluster, int rows, int box_rows,
    int threads, float eps, int with_silu, void* stream) {
  return (int)launch_k2<__nv_bfloat16>(x, gamma, beta, y, B, S, C, G,
                                       stripe_ch, cluster, rows, box_rows,
                                       threads, eps, with_silu,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int vdx_group_norm_stream_f32(const void* x, const void* gamma,
                                         const void* beta, void* y, void* work,
                                         int B, int S, int C, int G,
                                         int rows_per_chunk, float eps,
                                         int with_silu, void* stream) {
  return (int)launch_k3<float>(x, gamma, beta, y, work, B, S, C, G, rows_per_chunk,
                               eps, with_silu, static_cast<cudaStream_t>(stream));
}

extern "C" int vdx_group_norm_stream_bf16(const void* x, const void* gamma,
                                          const void* beta, void* y, void* work,
                                          int B, int S, int C, int G,
                                          int rows_per_chunk, float eps,
                                          int with_silu, void* stream) {
  return (int)launch_k3<__nv_bfloat16>(x, gamma, beta, y, work, B, S, C, G,
                                       rows_per_chunk, eps, with_silu,
                                       static_cast<cudaStream_t>(stream));
}
