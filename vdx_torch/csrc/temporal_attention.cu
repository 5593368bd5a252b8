// K6, K7, K8 and K9 — per-position temporal attention over F frames for
// Hopper (sm_90a): a tensor-core kernel for the bf16 modes of K6-K8 and a
// SIMT kernel for K9 and for fp32 operands.
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
// tensor cores, 0.04 ms in fp32 FMAs). At the level-2 site
// [512, 16, 8, 160] 21 MB each, 0.025 ms.
//
// What the design does about it: every (position, head) is one warp's
// work item, and enough items are in flight on each SM that the loads,
// not their latency, set the pace; consecutive warps take consecutive
// heads of one position, so a block reads whole [F, C] rows. q, k, v and
// out cross device memory once each; scores never leave the registers.
//
//   temporal_mma_kernel (bf16 K6, K7, K8; any rows, any D <= 160): the
//   warp stages its [F, D] slabs of q, k and v in shared memory in bf16
//   (cp.async, 16 bytes a lane, when D % 8 == 0 and every row is 16-byte
//   aligned; element copies otherwise), rows padded to DP + 8 elements (DP
//   = D rounded up to 16, zero-filled; 16-byte row starts whose stride is
//   an odd number of 16-byte units, so ldmatrix meets no bank conflict).
//   F <= 16 is one m16 row tile, F <= 32 two. QK^T runs on
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulators) with q's A fragments
//   and k's B fragments from ldmatrix (K6 rounds q * mult to bf16 in the A
//   fragment, vdx's q'); the softmax runs on the accumulators (a quad of
//   lanes holds one row's columns), l sums the unrounded p, and p is
//   re-packed in registers as the bf16 A fragments of PV, whose B
//   fragments are v's rows through ldmatrix.trans, one n8 column tile at a
//   time. r(acc / l) goes to shared memory over q's rows, then out leaves
//   in 16-byte stores. 4 warps a block; at D = 160, F = 16 a warp holds
//   16 KB of shared memory, so 12 warps (3 blocks) share an SM.
//
//   temporal_simt_kernel (K9 in either dtype; K6-K8 on fp32 operands):
//   fp32 FMAs, no tensor cores (K9's arithmetic is fp32, and TF32 would
//   round its products). The warp stages q, k and v in their own dtype
//   (bf16 halves the shared memory of the old fp32 slabs: 12 warps an SM
//   at D = 160 in place of 6), rows padded to an even length whose 4-byte
//   stride is odd. QK^T is register-blocked: lane (i, j) of an 8 x 4 grid
//   owns an (F/8) x (F/4) block of scores, so each shared-memory value
//   feeds 2-4 FMAs (bf16: two values a 4-byte load); a quad of lanes holds
//   whole rows, so the softmax runs in registers with two shuffles. p goes
//   to shared memory transposed, [g][f], and PV has each lane own output
//   columns d = lane + 32 j for 16 rows at a time, reading 4 weights a
//   16-byte broadcast load.
//
// Range: 1 <= F <= 32 (instances for F <= 16 and F <= 32), 1 <= D <= 160.
// No bf16 K6-K8 case runs on the SIMT kernel.

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
constexpr int WARPS = 4;  // items a block
// SIMT kernel: shared memory a block may take (fp32 slabs at D = 160:
// 3 warps; bf16: 4)
constexpr size_t SIMT_SMEM_BUDGET = 100 * 1024;

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------- the tensor-core kernel --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// d += a . b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// K6's fold on one A register (two bf16 values): r(q * mult)
__device__ __forceinline__ uint32_t fold2(uint32_t x, float mult) {
  return pack_bf16(__uint_as_float(x << 16) * mult,
                   __uint_as_float(x & 0xffff0000u) * mult);
}

// One [F, D] bf16 slab (rows sF elements apart) into dst [FP][LDS]: rows
// below F from src, columns D .. DP - 1 of them and rows F .. FP - 1 zero.
__device__ __forceinline__ void stage_mma(const bf16* __restrict__ src,
                                          long long sF, bf16* dst, int F,
                                          int FP, int D, int DP, int LDS,
                                          int vec, int lane) {
  if (vec) {
    const int vpr = D / 8;
    for (int i = lane; i < F * vpr; i += 32) {
      const int f = i / vpr;
      const int c = (i - f * vpr) * 8;
      cp_async16(smem_u32(dst + f * LDS + c), src + f * sF + c);
    }
  } else {
    for (int i = lane; i < F * D; i += 32) {
      const int f = i / D;
      const int d = i - f * D;
      dst[f * LDS + d] = src[f * sF + d];
    }
  }
  const bf16 z = __float2bfloat16_rn(0.0f);
  const int pad = DP - D;
  for (int i = lane; i < F * pad; i += 32) {
    const int f = i / pad;
    dst[f * LDS + D + (i - f * pad)] = z;
  }
  for (int i = lane; i < (FP - F) * DP; i += 32) {
    const int f = i / DP;
    dst[(F + f) * LDS + i - f * DP] = z;
  }
}

// Block: WARPS warps, one (position, head) item each. Shared memory per
// warp: q, k, v [FP][LDS] bf16 (q's rows take the output at the end).
template <int MODE, int FP>
__global__ void __launch_bounds__(WARPS * 32)
temporal_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    int P, int F, int H, int D,
                    long long qsp, long long qsf, long long qsh,
                    long long ksp, long long ksf, long long ksh,
                    long long vsp, long long vsf, long long vsh,
                    long long osp, long long osf, long long osh,
                    float mult, int vec) {
  constexpr int NT = FP / 8;    // score n8 tiles (key frames)
  constexpr int KS = FP / 16;   // PV k16 steps
  extern __shared__ uint4 mma_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + warp;
  if (item >= (long long)P * H) return;  // whole warp; no block barrier below
  const int p = (int)(item / H);
  const int h = (int)(item - (long long)p * H);
  const int DP = (D + 15) & ~15;
  const int LDS = DP + 8;
  bf16* qs = reinterpret_cast<bf16*>(mma_smem) + (size_t)warp * 3 * FP * LDS;
  bf16* ks = qs + FP * LDS;
  bf16* vs = ks + FP * LDS;

  stage_mma(q + p * qsp + h * qsh, qsf, qs, F, FP, D, DP, LDS, vec, lane);
  stage_mma(k + p * ksp + h * ksh, ksf, ks, F, FP, D, DP, LDS, vec, lane);
  stage_mma(v + p * vsp + h * vsh, vsf, vs, F, FP, D, DP, LDS, vec, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const int g = lane >> 2;
  const int t = lane & 3;
  const int r8 = lane & 7;
  const uint32_t qb = smem_u32(qs);
  const uint32_t kb = smem_u32(ks);
  const uint32_t vb = smem_u32(vs);
  const float ninf = __int_as_float(0xff800000);
#pragma unroll
  for (int mt = 0; mt < FP / 16; ++mt) {
    // S = Q[16 rows] . K^T: A (ldmatrix x4) rows mt*16 + (lane & 15) at
    // column half lane / 16; B (x4) two n8 tiles of key rows at a time
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    for (int kc = 0; kc < DP; kc += 16) {
      uint32_t a[4];
      ldsm_x4(a, qb + 2 * ((mt * 16 + r8 + 8 * ((lane >> 3) & 1)) * LDS + kc +
                           8 * (lane >> 4)));
      if (MODE == MODE_BLOCKDIAG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = fold2(a[i], mult);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kb + 2 * ((np * 16 + r8 + 8 * (lane >> 4)) * LDS + kc +
                             8 * ((lane >> 3) & 1)));
        mma16816(s[2 * np], a, b[0], b[1]);
        mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // rows g and g + 8 of the tile: columns 8n + 2t + (e & 1); keys past F
    // masked
    float m0 = ninf, m1 = ninf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = MODE == MODE_TC ? s[n][e] * mult : s[n][e];
        if (8 * n + 2 * t + (e & 1) >= F) x = ninf;
        s[n][e] = x;
      }
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - m0);
      s[n][1] = exp2f(s[n][1] - m0);
      s[n][2] = exp2f(s[n][2] - m1);
      s[n][3] = exp2f(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
    l0 = quad_sum(l0);  // from the unrounded p
    l1 = quad_sum(l1);
    // accumulator n8 tiles 2kk, 2kk + 1 -> the A fragment of key slice kk
    uint32_t pa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    __syncwarp();  // every lane is done reading this tile's q rows
    // O = r(p) . V, one n8 column tile at a time: B from v's rows
    // (ldmatrix.trans, lanes 0-15 address key rows kk*16 + lane); r(O / l)
    // over q's rows of the tile
    bf16* orow0 = qs + (mt * 16 + g) * LDS + 2 * t;
    bf16* orow1 = orow0 + 8 * LDS;
    for (int n0 = 0; n0 < D; n0 += 8) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[2];
        ldsm_x2_t(b, vb + 2 * ((kk * 16 + (lane & 15)) * LDS + n0));
        mma16816(acc, pa[kk], b[0], b[1]);
      }
      *reinterpret_cast<uint32_t*>(orow0 + n0) = pack_bf16(acc[0] / l0, acc[1] / l0);
      *reinterpret_cast<uint32_t*>(orow1 + n0) = pack_bf16(acc[2] / l1, acc[3] / l1);
    }
  }
  __syncwarp();
  bf16* ob = o + p * osp + h * osh;
  if (vec) {
    const int vpr = D / 8;
    for (int i = lane; i < F * vpr; i += 32) {
      const int f = i / vpr;
      const int c = (i - f * vpr) * 8;
      *reinterpret_cast<uint4*>(ob + f * osf + c) =
          *reinterpret_cast<const uint4*>(qs + f * LDS + c);
    }
  } else {
    for (int i = lane; i < F * D; i += 32) {
      const int f = i / D;
      const int d = i - f * D;
      ob[f * osf + d] = qs[f * LDS + d];
    }
  }
}

template <int MODE, int FP>
cudaError_t launch_mma_fp(const void* q, const void* k, const void* v, void* o,
                          int P, int F, int H, int D, const long long* st,
                          float mult, int vec, cudaStream_t stream) {
  const int LDS = ((D + 15) & ~15) + 8;
  const size_t smem = (size_t)WARPS * 3 * FP * LDS * sizeof(bf16);
  const long long blocks = ((long long)P * H + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = temporal_mma_kernel<MODE, FP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), P, F, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], mult, vec);
  return cudaGetLastError();
}

// -------------------------------------------------------- the SIMT kernel --

// One [F, D] slab of T (rows sF elements apart) into dst [F][LD] as T.
template <typename T>
__device__ __forceinline__ void stage_simt(const T* __restrict__ src,
                                           long long sF, T* dst, int F, int D,
                                           int LD, int vec, int lane) {
  if (vec) {  // 16 bytes a lane from device memory
    constexpr int N = 16 / sizeof(T);
    const int vpr = D / N;
    for (int i = lane; i < F * vpr; i += 32) {
      const int f = i / vpr;
      const int c = (i - f * vpr) * N;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + f * sF + c);
      // 4-byte stores: rows start 4-byte aligned (LD even for bf16)
      uint32_t* d = reinterpret_cast<uint32_t*>(dst + f * LD + c);
      d[0] = raw.x;
      d[1] = raw.y;
      d[2] = raw.z;
      d[3] = raw.w;
    }
  } else {
    for (int i = lane; i < F * D; i += 32) {
      const int f = i / D;
      const int d = i - f * D;
      dst[f * LD + d] = src[f * sF + d];
    }
  }
}

// What q becomes in the scores: K6 pre-scales in q's dtype, K9 in fp32,
// K7/K8 scale the scores instead.
template <typename T, int MODE>
__device__ __forceinline__ float q_in(float x, float mult) {
  if (MODE == MODE_BLOCKDIAG) return rnd<T>(x * mult);
  if (MODE == MODE_CP) return x * mult;
  return x;
}

// element stride of a staged row: bf16 rows even (4-byte row starts) with
// an odd 4-byte stride where D allows, fp32 rows odd
template <typename T>
__host__ __device__ __forceinline__ int simt_ld(int D) {
  return sizeof(T) == 2 ? (D | 1) + 1 : (D | 1);
}

// Block: W warps, one item each. Shared memory per warp: pt [FMAX][FMAX]
// fp32 (p transposed, [g][f]), ls [FMAX], then q, k, v [FMAX][LD] of T.
template <typename T, int MODE, int FMAX>
__global__ void __launch_bounds__(WARPS * 32)
temporal_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int P, int F, int H, int D,
                     long long qsp, long long qsf, long long qsh,
                     long long ksp, long long ksf, long long ksh,
                     long long vsp, long long vsf, long long vsh,
                     long long osp, long long osf, long long osh,
                     float mult, int vec, int per_warp) {
  constexpr int RB = FMAX / 8;  // score rows a lane
  constexpr int CB = FMAX / 4;  // score columns a lane
  constexpr int NJ = (MAX_D + 31) / 32;  // output columns a lane
  extern __shared__ float4 simt_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= (long long)P * H) return;  // whole warp; no block barrier below
  const int p = (int)(item / H);
  const int h = (int)(item - (long long)p * H);
  const int LD = simt_ld<T>(D);
  unsigned char* base = reinterpret_cast<unsigned char*>(simt_smem) +
                        (size_t)warp * per_warp;
  float* pt = reinterpret_cast<float*>(base);
  float* ls = pt + FMAX * FMAX;
  T* qs = reinterpret_cast<T*>(ls + FMAX);
  T* ks = qs + FMAX * LD;
  T* vs = ks + FMAX * LD;

  stage_simt(q + p * qsp + h * qsh, qsf, qs, F, D, LD, vec, lane);
  stage_simt(k + p * ksp + h * ksh, ksf, ks, F, D, LD, vec, lane);
  stage_simt(v + p * vsp + h * vsh, vsf, vs, F, D, LD, vec, lane);
  __syncwarp();

  // scores: lane (fi, gi) owns rows fi * RB + r, columns gi * CB + c; rows
  // and columns past F read row 0 (their scores are dropped or masked)
  const int fi = lane >> 2;
  const int gi = lane & 3;
  int qo[RB], ko[CB];
#pragma unroll
  for (int r = 0; r < RB; ++r) qo[r] = (fi * RB + r < F ? fi * RB + r : 0) * LD;
#pragma unroll
  for (int c = 0; c < CB; ++c) ko[c] = (gi * CB + c < F ? gi * CB + c : 0) * LD;
  float acc[RB][CB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[r][c] = 0.0f;
  int d = 0;
  if constexpr (sizeof(T) == 2) {  // two bf16 values a 4-byte load
    for (; d + 1 < D; d += 2) {
      float a0[RB], a1[RB], b0[CB], b1[CB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(qs + qo[r] + d);
        a0[r] = q_in<T, MODE>(__uint_as_float(w << 16), mult);
        a1[r] = q_in<T, MODE>(__uint_as_float(w & 0xffff0000u), mult);
      }
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(ks + ko[c] + d);
        b0[c] = __uint_as_float(w << 16);
        b1[c] = __uint_as_float(w & 0xffff0000u);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < CB; ++c)
          acc[r][c] = fmaf(a1[r], b1[c], fmaf(a0[r], b0[c], acc[r][c]));
    }
  }
  for (; d < D; ++d) {
    float a[RB], b[CB];
#pragma unroll
    for (int r = 0; r < RB; ++r) a[r] = q_in<T, MODE>(to_f(qs[qo[r] + d]), mult);
#pragma unroll
    for (int c = 0; c < CB; ++c) b[c] = to_f(ks[ko[c] + d]);
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }

  // row softmax in registers: the quad (fi, 0..3) holds each row whole
  const float ninf = __int_as_float(0xff800000);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float m = ninf;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      float x = MODE == MODE_TC ? acc[r][c] * mult : acc[r][c];
      if (gi * CB + c >= F) x = ninf;
      acc[r][c] = x;
      m = fmaxf(m, x);
    }
    m = quad_max(m);
    float l = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const float e = MODE == MODE_CP ? expf(acc[r][c] - m) : exp2f(acc[r][c] - m);
      acc[r][c] = e;
      l += e;
    }
    l = quad_sum(l);
    const int f = fi * RB + r;
#pragma unroll
    for (int c = 0; c < CB; ++c)
      // K9: p = e / l before PV; K6-K8: l from the unrounded p, PV from
      // p rounded to v's dtype
      pt[(gi * CB + c) * FMAX + f] =
          MODE == MODE_CP ? acc[r][c] / l : rnd<T>(acc[r][c]);
    if (gi == 0) ls[f] = MODE == MODE_CP ? 1.0f : l;
  }
  __syncwarp();

  // PV: lane owns output columns lane + 32 j, 16 rows at a time
  T* ob = o + p * osp + h * osh;
#pragma unroll
  for (int f0 = 0; f0 < FMAX; f0 += 16) {
    if (f0 >= F) break;
    float out[16][NJ];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) out[r][j] = 0.0f;
    for (int g = 0; g < F; ++g) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int dd = lane + 32 * j;
        vv[j] = dd < D ? to_f(vs[g * LD + dd]) : 0.0f;
      }
      const float4* w = reinterpret_cast<const float4*>(pt + g * FMAX + f0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = w[i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (32 * j < D) {
            out[4 * i][j] = fmaf(x.x, vv[j], out[4 * i][j]);
            out[4 * i + 1][j] = fmaf(x.y, vv[j], out[4 * i + 1][j]);
            out[4 * i + 2][j] = fmaf(x.z, vv[j], out[4 * i + 2][j]);
            out[4 * i + 3][j] = fmaf(x.w, vv[j], out[4 * i + 3][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int f = f0 + r;
      if (f < F) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int dd = lane + 32 * j;
          if (dd < D) {
            // K9's p is normalised already
            const float y = MODE == MODE_CP ? out[r][j] : out[r][j] / ls[f];
            ob[f * osf + dd] = from_f<T>(y);
          }
        }
      }
    }
  }
}

template <typename T, int MODE, int FMAX>
cudaError_t launch_simt_fmax(const void* q, const void* k, const void* v,
                             void* o, int P, int F, int H, int D,
                             const long long* st, float mult, int vec,
                             cudaStream_t stream) {
  const size_t slabs = 3 * (size_t)FMAX * simt_ld<T>(D) * sizeof(T);
  const size_t per_warp =
      (sizeof(float) * (FMAX * FMAX + FMAX) + slabs + 15) / 16 * 16;
  int warps = WARPS;
  while (warps > 1 && warps * per_warp > SIMT_SMEM_BUDGET) --warps;
  const size_t smem = warps * per_warp;
  const long long items = (long long)P * H;
  const long long blocks = (items + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = temporal_simt_kernel<T, MODE, FMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), P, F, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], mult, vec, (int)per_warp);
  return cudaGetLastError();
}

bool range_ok(int P, int F, int H, int D, int vec) {
  return P >= 1 && H >= 1 && F >= 1 && F <= MAX_F && D >= 1 && D <= MAX_D &&
         !(vec && D % 8 != 0);
}

template <int MODE>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int P, int F, int H, int D, const long long* st,
                       float mult, int vec, cudaStream_t s) {
  return F <= 16
      ? launch_mma_fp<MODE, 16>(q, k, v, o, P, F, H, D, st, mult, vec, s)
      : launch_mma_fp<MODE, 32>(q, k, v, o, P, F, H, D, st, mult, vec, s);
}

template <typename T, int MODE>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        int P, int F, int H, int D, const long long* st,
                        float mult, int vec, cudaStream_t s) {
  return F <= 16
      ? launch_simt_fmax<T, MODE, 16>(q, k, v, o, P, F, H, D, st, mult, vec, s)
      : launch_simt_fmax<T, MODE, 32>(q, k, v, o, P, F, H, D, st, mult, vec, s);
}

}  // namespace

// The two C entry points; the wrapper (kernels.flash_attention
// .temporal_kernel_for) picks one. Arguments: q, k, v, o, P, F, H, D, the
// strides (position, frame, head; in elements) of q, k, v and o, the
// mode's multiplier (K6: r(scale*log2e) in q's dtype; K7/K8:
// scale*log2e; K9: scale), the mode (0 K6, 1 K7/K8, 2 K9), [bf16,] vec
// (16-byte row loads), stream.

// bf16 K6, K7, K8 on the tensor cores
extern "C" int vdx_temporal_attention_mma(
    const void* q, const void* k, const void* v, void* o, int P, int F, int H,
    int D, long long qsp, long long qsf, long long qsh, long long ksp,
    long long ksf, long long ksh, long long vsp, long long vsf, long long vsh,
    long long osp, long long osf, long long osh, float mult, int mode, int vec,
    void* stream) {
  const long long st[12] = {qsp, qsf, qsh, ksp, ksf, ksh,
                            vsp, vsf, vsh, osp, osf, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!range_ok(P, F, H, D, vec)) return (int)cudaErrorInvalidValue;
  if (mode == MODE_BLOCKDIAG)
    return (int)launch_mma<MODE_BLOCKDIAG>(q, k, v, o, P, F, H, D, st, mult, vec, s);
  if (mode == MODE_TC)
    return (int)launch_mma<MODE_TC>(q, k, v, o, P, F, H, D, st, mult, vec, s);
  return (int)cudaErrorInvalidValue;
}

// K9 (bf16 or fp32 operands) and fp32 K6, K7, K8 on the FMA pipes
extern "C" int vdx_temporal_attention_simt(
    const void* q, const void* k, const void* v, void* o, int P, int F, int H,
    int D, long long qsp, long long qsf, long long qsh, long long ksp,
    long long ksf, long long ksh, long long vsp, long long vsf, long long vsh,
    long long osp, long long osf, long long osh, float mult, int mode,
    int is_bf16, int vec, void* stream) {
  const long long st[12] = {qsp, qsf, qsh, ksp, ksf, ksh,
                            vsp, vsf, vsh, osp, osf, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!range_ok(P, F, H, D, vec)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return mode == MODE_CP
        ? (int)launch_simt<bf16, MODE_CP>(q, k, v, o, P, F, H, D, st, mult, vec, s)
        : (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_BLOCKDIAG:
      return (int)launch_simt<float, MODE_BLOCKDIAG>(q, k, v, o, P, F, H, D, st,
                                                     mult, vec, s);
    case MODE_TC:
      return (int)launch_simt<float, MODE_TC>(q, k, v, o, P, F, H, D, st, mult,
                                              vec, s);
    case MODE_CP:
      return (int)launch_simt<float, MODE_CP>(q, k, v, o, P, F, H, D, st, mult,
                                              vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
