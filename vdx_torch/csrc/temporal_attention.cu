// K6, K7, K8 and K9 — per-position temporal attention over F frames for
// Hopper (sm_90a), as one kernel with a numeric mode.
//
// Replaces: vdx/kernels/flash_attention.py  flash_attention_blockdiag
//   (K6, body _blockdiag_kernel), flash_attention_blockdiag_tc (K7, body
//   _blockdiag_tc_kernel) and flash_attention_blockdiag_tc2 (K8, body
//   _blockdiag_tc2_kernel); vdx/kernels/temporal_attention_cp.py
//   temporal_attention_cp (K9, body _temporal_cp_kernel).
//
// All four compute, for q, k, v of shape [P, F, H, D] (any strides whose
// innermost is 1) and every position p and head h,
//   out[p, :, h] = softmax_g(q[p, :, h] . k[p, g, h]) v[p, :, h]
// with the TPU kernels' numerics (the block-diagonal [P*F] folds, the
// [T, C] tiles and the [F, C, P] layout are TPU layout workarounds, not
// part of the function):
//   K6   (MODE_BLOCKDIAG): q' = r(q * r(scale*log2e)) in q's dtype r();
//        s = q' . k (fp32); p = 2^(s - rowmax s); l = sum p (fp32);
//        out = r((sum_g r(p) v) / l)
//   K7/K8 (MODE_TC): s = (q . k) * scale*log2e in fp32, then as K6. K7
//        and K8 compute the identical function (they differ only in
//        which TPU tile they transpose), so one mode serves both.
//   K9   (MODE_CP): everything in fp32: s = (q * scale) . k;
//        e = exp(s - rowmax s); p = e / sum e (normalised before PV);
//        out = r(sum_g p v)
// where r() rounds to the operands' dtype (bf16 or fp32; identity for
// fp32).
//
// What bounds it on this card: bytes. At the 512x512 level-0 motion site
// [8192, 16, 8, 40] bf16, q, k, v and out are 84 MB each (0.100 ms at
// 3.35 TB/s); the two F x F x D products are 2.7 GFLOP (0.003 ms on the
// tensor cores, 0.04 ms in fp32 FMAs).
//
// What the design does about it: every (position, head) is one warp's
// work item; consecutive warps take consecutive heads of one position, so
// a block reads whole [F, C] rows. The warp stages its [F, D] slabs of q,
// k and v in shared memory as fp32 (16-byte loads when D % 8 == 0 and
// every row is 16-byte aligned, element loads otherwise; no padding in
// device memory), computes the F x F scores with fp32 FMAs (each lane
// owns up to FMAX*FMAX/32 scores), the row softmax (one lane per row),
// and PV (each lane owns output columns), and writes the [F, D] result.
// q, k, v and out cross device memory once each; scores never leave the
// SM. The products run on the FMA pipes, not the tensor cores: at F = 16
// they are 1/30 of the bytes' time at the fp32 rate, and fp32 FMAs keep
// K9's all-fp32 arithmetic exact to fp32. Shared-memory row strides are
// D + 1 (odd), so lanes reading different rows hit different banks.
//
// Range: 1 <= F <= 32 (instances for F <= 16 and F <= 32), 1 <= D <= 160.
//
// Later work (not here): mma.sync for the bf16 modes, fewer shared-memory
// reads per FMA (register blocking), more warps in flight at D = 160.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MODE_BLOCKDIAG = 0;  // K6
constexpr int MODE_TC = 1;         // K7, K8
constexpr int MODE_CP = 2;         // K9
constexpr int MAX_F = 32;
constexpr int MAX_D = 160;
constexpr int MAX_WARPS = 4;
// shared memory per block: enough for 4 warps at D <= 80, 3 at D = 160
constexpr size_t SMEM_BUDGET = 100 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// r(): round to T and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// One 16-byte vector of T -> VEC floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
};
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float (&f)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
};

// What q becomes in shared memory: K6 pre-scales in q's dtype, K9 in
// fp32, K7/K8 scale the scores instead.
template <typename T, int MODE>
__device__ __forceinline__ float q_in(float x, float mult) {
  if (MODE == MODE_BLOCKDIAG) return rnd<T>(x * mult);
  if (MODE == MODE_CP) return x * mult;
  return x;
}

// Stage one [F, D] slab (rows at stride sF, unit stride on D) into
// dst[f * LD + d] as fp32, applying q_in when IS_Q.
template <typename T, int MODE, bool IS_Q>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long sF,
                                      float* dst, int F, int D, int LD,
                                      float mult, int vec, int lane) {
  if (vec) {
    constexpr int N = Vec<T>::N;
    const int vpr = D / N;
    for (int i = lane; i < F * vpr; i += 32) {
      const int f = i / vpr;
      const int c = (i - f * vpr) * N;
      float x[N];
      Vec<T>::load(src + f * sF + c, x);
#pragma unroll
      for (int j = 0; j < N; ++j)
        dst[f * LD + c + j] = IS_Q ? q_in<T, MODE>(x[j], mult) : x[j];
    }
  } else {
    for (int i = lane; i < F * D; i += 32) {
      const int f = i / D;
      const int d = i - f * D;
      const float x = to_f(src[f * sF + d]);
      dst[f * LD + d] = IS_Q ? q_in<T, MODE>(x, mult) : x;
    }
  }
}

// Block: W warps, one (position, head) item each. Shared memory per warp:
// qs, ks, vs [F][LD] fp32, ss [F][F + 1] scores then weights, ls [F].
template <typename T, int MODE, int FMAX>
__global__ void __launch_bounds__(MAX_WARPS * 32)
temporal_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int P, int F, int H, int D,
                     long long qsp, long long qsf, long long qsh,
                     long long ksp, long long ksf, long long ksh,
                     long long vsp, long long vsf, long long vsh,
                     long long osp, long long osf, long long osh,
                     float mult, int vec) {
  constexpr int NJ = FMAX * FMAX / 32;  // scores per lane
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= (long long)P * H) return;  // whole warp; no block barrier below
  const int p = (int)(item / H);
  const int h = (int)(item - (long long)p * H);
  const int LD = D + 1;
  const int SS = F + 1;
  float* qs = smem + (size_t)warp * (3 * F * LD + F * SS + F);
  float* ks = qs + F * LD;
  float* vs = ks + F * LD;
  float* ss = vs + F * LD;
  float* ls = ss + F * SS;

  stage<T, MODE, true>(q + p * qsp + h * qsh, qsf, qs, F, D, LD, mult, vec, lane);
  stage<T, MODE, false>(k + p * ksp + h * ksh, ksf, ks, F, D, LD, mult, vec, lane);
  stage<T, MODE, false>(v + p * vsp + h * vsh, vsf, vs, F, D, LD, mult, vec, lane);
  __syncwarp();

  // scores: lane owns i = lane + 32 j, (f, g) = (i / F, i % F)
  const int FF = F * F;
  float acc[NJ];
  int qo[NJ], ko[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = lane + 32 * j;
    const int f = i < FF ? i / F : 0;
    qo[j] = f * LD;
    ko[j] = (i < FF ? i - f * F : 0) * LD;
    acc[j] = 0.0f;
  }
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (32 * j < FF) acc[j] = fmaf(qs[qo[j] + d], ks[ko[j] + d], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = lane + 32 * j;
    if (i < FF) {
      const int f = i / F;
      ss[f * SS + i - f * F] = MODE == MODE_TC ? acc[j] * mult : acc[j];
    }
  }
  __syncwarp();

  // row softmax: one lane per query row
  if (lane < F) {
    float* row = ss + lane * SS;
    float m = row[0];
    for (int g = 1; g < F; ++g) m = fmaxf(m, row[g]);
    float l = 0.0f;
    for (int g = 0; g < F; ++g) {
      const float e = MODE == MODE_CP ? expf(row[g] - m) : exp2f(row[g] - m);
      l += e;
      // K6-K8: l from the unrounded p, PV from p rounded to v's dtype
      row[g] = MODE == MODE_CP ? e : rnd<T>(e);
    }
    if (MODE == MODE_CP) {
      for (int g = 0; g < F; ++g) row[g] = row[g] / l;  // before PV
      l = 1.0f;
    }
    ls[lane] = l;
  }
  __syncwarp();

  // PV: lane owns output columns d = lane, lane + 32, ...
  T* ob = o + p * osp + h * osh;
  for (int d = lane; d < D; d += 32) {
    float out[FMAX];
#pragma unroll
    for (int f = 0; f < FMAX; ++f) out[f] = 0.0f;
    for (int g = 0; g < F; ++g) {
      const float vv = vs[g * LD + d];
#pragma unroll
      for (int f = 0; f < FMAX; ++f)
        if (f < F) out[f] = fmaf(ss[f * SS + g], vv, out[f]);
    }
#pragma unroll
    for (int f = 0; f < FMAX; ++f) {
      if (f < F) {
        const float y = MODE == MODE_CP ? out[f] : out[f] / ls[f];
        ob[f * osf + d] = from_f<T>(y);
      }
    }
  }
}

template <typename T, int MODE, int FMAX>
cudaError_t launch_fmax(const void* q, const void* k, const void* v, void* o,
                        int P, int F, int H, int D, const long long* st,
                        float mult, int vec, cudaStream_t stream) {
  const int LD = D + 1;
  const size_t per_warp = sizeof(float) * (size_t)(3 * F * LD + F * (F + 1) + F);
  int warps = MAX_WARPS;
  while (warps > 1 && warps * per_warp > SMEM_BUDGET) --warps;
  const size_t smem = warps * per_warp;
  const long long items = (long long)P * H;
  const long long blocks = (items + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = temporal_attn_kernel<T, MODE, FMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), P, F, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], mult, vec);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int P, int F, int H, int D, const long long* st, float mult,
                   int is_bf16, int vec, void* stream) {
  if (P < 1 || H < 1 || F < 1 || F > MAX_F || D < 1 || D > MAX_D ||
      (vec && D % 8 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return F <= 16
        ? launch_fmax<bf16, MODE, 16>(q, k, v, o, P, F, H, D, st, mult, vec, s)
        : launch_fmax<bf16, MODE, 32>(q, k, v, o, P, F, H, D, st, mult, vec, s);
  return F <= 16
      ? launch_fmax<float, MODE, 16>(q, k, v, o, P, F, H, D, st, mult, vec, s)
      : launch_fmax<float, MODE, 32>(q, k, v, o, P, F, H, D, st, mult, vec, s);
}

}  // namespace

// One C entry per mode. Arguments: q, k, v, o, P, F, H, D, the strides
// (position, frame, head; in elements) of q, k, v and o, the mode's
// multiplier (K6: r(scale*log2e) in q's dtype; K7/K8: scale*log2e; K9:
// scale), bf16 (else fp32), vec (16-byte row loads), stream.
#define VDX_TEMPORAL_ENTRY(NAME, MODE)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      int P, int F, int H, int D,                             \
                      long long qsp, long long qsf, long long qsh,            \
                      long long ksp, long long ksf, long long ksh,            \
                      long long vsp, long long vsf, long long vsh,            \
                      long long osp, long long osf, long long osh,            \
                      float mult, int is_bf16, int vec, void* stream) {       \
    const long long st[12] = {qsp, qsf, qsh, ksp, ksf, ksh,                   \
                              vsp, vsf, vsh, osp, osf, osh};                  \
    return (int)launch<MODE>(q, k, v, o, P, F, H, D, st, mult, is_bf16, vec,  \
                             stream);                                         \
  }

VDX_TEMPORAL_ENTRY(vdx_temporal_attention_blockdiag, MODE_BLOCKDIAG)
VDX_TEMPORAL_ENTRY(vdx_temporal_attention_tc, MODE_TC)
VDX_TEMPORAL_ENTRY(vdx_temporal_attention_cp, MODE_CP)
