// K2 and K3 — fused GroupNorm(+SiLU) over channels-last [B, S, C] for
// Hopper (sm_90a).
//
// Replaces: vdx/kernels/groupnorm.py  fused_group_norm (_gn_kernel, K2)
//   and fused_group_norm_2phase (_gn_stats_kernel + _gn_apply_kernel, K3).
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
// What the design does about it:
//  * K2 (one block per (sample, group), the group's [S, C/G] slab in
//    shared memory): the statistics pass copies the slab into shared
//    memory while it sums, and the normalise pass reads it back from
//    there — x crosses device memory exactly once. The dispatch (Python,
//    kernels/groupnorm.py) takes K2 when the slab fits the shared-memory
//    budget that still leaves two blocks resident per SM.
//  * K3 (larger slabs, e.g. the motion module's GN over frames x space):
//    a statistics kernel over (row-chunk, sample) blocks writes per-chunk
//    partial moments [B, n_chunks, 2, G]; a one-block-per-sample finalise
//    kernel reduces them in a fixed order to (mean, inv) [B, 2, G]; an
//    apply kernel over the same row chunks normalises. x is read twice
//    (the streaming minimum for exact statistics), y written once. Rows
//    are read as 16-byte vectors of 8 channels, neighbouring threads on
//    neighbouring vectors.
//
// Order of summation (for the tolerance): K2 sums each channel's rows in
// a per-thread sequential fp32 loop, then across threads by a warp
// shuffle tree and a sequential pass over warps. K3 sums each channel's
// rows per thread, then across the block's row groups in order, then the
// group's channels, then the chunks in order. No atomics: both are
// deterministic run to run. Against a pairwise-summed reference the
// moments differ by a few fp32 ulps of the sums, far below one bf16 ulp
// of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int K3_MAX_C = 2048;  // 8 channels per thread, 256 threads
constexpr int MAX_G = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float silu(float y) {
  return y * (1.0f / (1.0f + expf(-y)));
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum (a, b) over the block; every thread gets the result.
__device__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = red[0];
    for (int w = 1; w < THREADS / 32; ++w) {
      t.x += red[w].x;
      t.y += red[w].y;
    }
    red[THREADS / 32] = t;
  }
  __syncthreads();
  return red[THREADS / 32];
}

// ---------------------------------------------------------------- K2 --
// grid (G, B); thread (ch, ry) = (tid % cpg, tid / cpg) walks rows
// ry, ry + RY, ... of channel g*cpg + ch.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_group_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y,
                int S, int C, int G, float eps, int with_silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);  // [S][cpg]
  __shared__ float2 red[THREADS / 32 + 1];
  const int cpg = C / G;
  const int RY = THREADS / cpg;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int ch = threadIdx.x % cpg;
  const int ry = threadIdx.x / cpg;
  const size_t base = (size_t)b * S * C + (size_t)g * cpg + ch;
  const bool active = ry < RY;

  float s1 = 0.0f, s2 = 0.0f;
  if (active) {
    for (int r = ry; r < S; r += RY) {
      const T v = x[base + (size_t)r * C];
      slab[r * cpg + ch] = v;
      const float f = to_f(v);
      s1 += f;
      s2 += f * f;
    }
  }
  const float2 t = block_sum2(s1, s2, red);  // also publishes the slab
  const float n = (float)S * (float)cpg;
  const float mean = t.x / n;
  const float var = fmaxf(t.y / n - mean * mean, 0.0f);
  const float inv = rsqrtf(var + eps);
  if (!active) return;
  const int c = g * cpg + ch;
  const float sc = gamma[c] * inv;
  const float off = beta[c] - mean * sc;
  for (int r = ry; r < S; r += RY) {
    float v = to_f(slab[r * cpg + ch]) * sc + off;
    if (with_silu) v = silu(v);
    from_f(&y[base + (size_t)r * C], v);
  }
}

// ---------------------------------------------------------------- K3 --
// Thread layout shared by the stats and apply kernels: NV = C/8 vectors
// per row, RY = THREADS / NV row groups; thread (col, ry) handles
// channels col*8 .. col*8+7 of rows r0 + ry, r0 + ry + RY, ...
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                int S, int C, int G, int rows_per_chunk) {
  __shared__ float part[2][K3_MAX_C];  // per-(row group, channel) sums
  const int NV = C >> 3;
  const int RY = THREADS / NV;
  const int col = threadIdx.x % NV;
  const int ry = threadIdx.x / NV;
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const T* xb = x + (size_t)b * S * C + col * 8;

  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) { s1[j] = 0.0f; s2[j] = 0.0f; }
  if (ry < RY) {
    for (int r = r0 + ry; r < r1; r += RY) {
      float f[8];
      load8(xb + (size_t)r * C, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += f[j];
        s2[j] += f[j] * f[j];
      }
    }
    // part[.][ry * C + c] fits: RY * C = RY * NV * 8 <= THREADS * 8
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      part[0][ry * C + col * 8 + j] = s1[j];
      part[1][ry * C + col * 8 + j] = s2[j];
    }
  }
  __syncthreads();
  const int cpg = C / G;
  if (threadIdx.x < 2 * G) {
    const int m = threadIdx.x / G;
    const int g = threadIdx.x - m * G;
    float acc = 0.0f;
    for (int q = 0; q < RY; ++q)
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) acc += part[m][q * C + c];
    partials[(((size_t)b * n_chunks + chunk) * 2 + m) * G + g] = acc;
  }
}

// grid (B); reduces the chunks' partial moments in chunk order.
__global__ void __launch_bounds__(THREADS)
gn_finalize_kernel(const float* __restrict__ partials, float* __restrict__ stats,
                   int n_chunks, int G, float n, float eps) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s1 = 0.0f, s2 = 0.0f;
    const float* p = partials + (size_t)b * n_chunks * 2 * G + g;
    for (int k = 0; k < n_chunks; ++k) {
      s1 += p[(size_t)k * 2 * G];
      s2 += p[(size_t)k * 2 * G + G];
    }
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.0f);
    stats[((size_t)b * 2 + 0) * G + g] = mean;
    stats[((size_t)b * 2 + 1) * G + g] = rsqrtf(var + eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const float* __restrict__ stats,
                T* __restrict__ y, int S, int C, int G, int rows_per_chunk,
                int with_silu) {
  __shared__ float sc_s[K3_MAX_C];
  __shared__ float off_s[K3_MAX_C];
  const int b = blockIdx.y;
  const int cpg = C / G;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int g = c / cpg;
    const float mean = stats[((size_t)b * 2 + 0) * G + g];
    const float inv = stats[((size_t)b * 2 + 1) * G + g];
    const float sc = gamma[c] * inv;
    sc_s[c] = sc;
    off_s[c] = beta[c] - mean * sc;
  }
  __syncthreads();
  const int NV = C >> 3;
  const int RY = THREADS / NV;
  const int col = threadIdx.x % NV;
  const int ry = threadIdx.x / NV;
  if (ry >= RY) return;
  float sc[8], off[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = sc_s[col * 8 + j];
    off[j] = off_s[col * 8 + j];
  }
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const size_t base = (size_t)b * S * C + col * 8;
  for (int r = r0 + ry; r < r1; r += RY) {
    float f[8];
    load8(x + base + (size_t)r * C, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = f[j] * sc[j] + off[j];
      f[j] = with_silu ? silu(v) : v;
    }
    store8(y + base + (size_t)r * C, f);
  }
}

template <typename T>
cudaError_t launch_k2(const void* x, const void* gamma, const void* beta, void* y,
                      int B, int S, int C, int G, float eps, int with_silu,
                      cudaStream_t stream) {
  const int cpg = C / G;
  if (G < 1 || C % G != 0 || cpg > THREADS) return cudaErrorInvalidValue;
  const size_t smem = (size_t)S * cpg * sizeof(T);
  auto kern = gn_group_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(G, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), S, C, G, eps,
      with_silu);
  return cudaGetLastError();
}

// ``work`` holds B * n_chunks * 2 * G partials followed by B * 2 * G stats.
template <typename T>
cudaError_t launch_k3(const void* x, const void* gamma, const void* beta, void* y,
                      void* work, int B, int S, int C, int G, int rows_per_chunk,
                      float eps, int with_silu, cudaStream_t stream) {
  if (G < 1 || G > MAX_G || C % G != 0 || C % 8 != 0 || C > K3_MAX_C ||
      rows_per_chunk < 1)
    return cudaErrorInvalidValue;
  const int n_chunks = (S + rows_per_chunk - 1) / rows_per_chunk;
  float* partials = static_cast<float*>(work);
  float* stats = partials + (size_t)B * n_chunks * 2 * G;
  const dim3 grid(n_chunks, B);
  gn_stats_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), partials, S, C, G, rows_per_chunk);
  gn_finalize_kernel<<<B, THREADS, 0, stream>>>(
      partials, stats, n_chunks, G, (float)S * (float)(C / G), eps);
  gn_apply_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), stats, static_cast<T*>(y), S, C, G,
      rows_per_chunk, with_silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vdx_group_norm_f32(const void* x, const void* gamma, const void* beta,
                                  void* y, int B, int S, int C, int G, float eps,
                                  int with_silu, void* stream) {
  return (int)launch_k2<float>(x, gamma, beta, y, B, S, C, G, eps, with_silu,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int vdx_group_norm_bf16(const void* x, const void* gamma, const void* beta,
                                   void* y, int B, int S, int C, int G, float eps,
                                   int with_silu, void* stream) {
  return (int)launch_k2<__nv_bfloat16>(x, gamma, beta, y, B, S, C, G, eps,
                                       with_silu, static_cast<cudaStream_t>(stream));
}

extern "C" int vdx_group_norm_2phase_f32(const void* x, const void* gamma,
                                         const void* beta, void* y, void* work,
                                         int B, int S, int C, int G,
                                         int rows_per_chunk, float eps,
                                         int with_silu, void* stream) {
  return (int)launch_k3<float>(x, gamma, beta, y, work, B, S, C, G, rows_per_chunk,
                               eps, with_silu, static_cast<cudaStream_t>(stream));
}

extern "C" int vdx_group_norm_2phase_bf16(const void* x, const void* gamma,
                                          const void* beta, void* y, void* work,
                                          int B, int S, int C, int G,
                                          int rows_per_chunk, float eps,
                                          int with_silu, void* stream) {
  return (int)launch_k3<__nv_bfloat16>(x, gamma, beta, y, work, B, S, C, G,
                                       rows_per_chunk, eps, with_silu,
                                       static_cast<cudaStream_t>(stream));
}
