// K4 — running-max flash attention for Hopper (sm_90a), bf16 operands.
//
// Replaces: vdx/kernels/flash_attention.py  flash_attention  (kernel
//   bodies _flash_kernel, via _flash_kernel_nomask / _flash_kernel_masked).
//
// Computes, for q, k, v of shape [B, S, H, D] (bf16, any strides whose
// innermost is 1, any 1 <= D <= 256), the non-causal
// out = softmax(q k^T * scale) v with the online-softmax recurrence of the
// TPU kernel, one key tile at a time:
//   s   = (q . k) * scale * log2(e)         (fp32 accumulate; base 2, which
//                                            is the TPU kernel's base-e form
//                                            with log2(e) folded in)
//   m'  = max(m, rowmax s),  alpha = 2^(m - m'),  p = 2^(s - m')  (fp32)
//   l'  = alpha * l + rowsum p                (from the unrounded p)
//   acc = alpha * acc + bf16(p) . v           (fp32 accumulate)
//   out = bf16(acc / l)                       (rounded once)
// Keys past Skv get s = -inf inside the kernel (the TPU pads them in
// memory and writes -1e30); both give p = 0 exactly.
//
// What bounds it on this card: tensor-core operations. At the 768x768
// level-2 site [32, 576, 8, 160] the two products are 54.4 GFLOP against
// 94 MB of q/k/v/o traffic (0.055 ms at 989 TFLOP/s vs 0.028 ms at
// 3.35 TB/s).
//
// What the design does about it: both products run on the tensor cores
// through mma.sync.m16n8k16 (bf16 in, fp32 accumulate). One block owns one
// (b, h) and 64 queries (4 warps x 16 rows) and loops over key tiles
// staged in shared memory, so the S x S score matrix never reaches device
// memory. Unlike K1's WMMA fragments, the mma.sync accumulator layout is
// documented (a lane owns rows lane/4 and lane/4 + 8, two adjacent columns
// of each 8-wide tile), so the row max, the row sum and the alpha rescale
// of the output accumulators all stay in registers, and the score
// fragments are re-packed in registers as the A operand of the PV product
// without a round trip through shared memory. V is stored transposed in
// shared memory so every B fragment is one 32-bit load. The head dim is
// zero-padded to a multiple of 16 in shared memory only; rows are read
// with 16-byte loads when D % 8 == 0 and every row is 16-byte aligned,
// else element by element. Row strides in shared memory are padded by 8
// elements, which makes every fragment load bank-conflict free.
//
// Instantiations: a compile-time bound on the 16-wide D slices (8, 10, 16:
// D <= 128, <= 160, <= 256) with the actual count a runtime guard inside
// fully unrolled loops, so the accumulators stay in registers. The
// D <= 256 instance takes 32-key tiles to bound registers (128 fp32
// accumulators a thread), the others 64.
//
// Later work (not here): wgmma + TMA, a K/V double buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;           // queries per block
constexpr int THREADS = 128;     // 4 warps x 16 query rows
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shared memory: Qs [BQ][LDS], Ks [BK][LDS], Vt [DP][BK + 8] (V transposed),
// with DP = 16 * ceil(D / 16) and LDS = DP + 8.
__host__ __device__ inline size_t smem_bytes(int D, int BK) {
  const int DP = ((D + 15) / 16) * 16;
  return sizeof(bf16) * ((size_t)(BQ + BK) * (DP + 8) + (size_t)DP * (BK + 8));
}

template <int KTMAX, int BK>
__global__ void __launch_bounds__(THREADS)
flash_runmax_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int Sq, int Skv, int H, int D,
                         long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         long long osb, long long oss, long long osh,
                         float t_mult, int vec) {
  constexpr int NJ = BK / 8;      // 8-key score tiles per key tile
  constexpr int LDV = BK + 8;     // Vt row stride
  const int KT = (D + 15) >> 4;   // 16-wide D slices in use
  const int DP = KT * 16;
  const int LDS = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDS;
  bf16* Vt = Ks + BK * LDS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;        // fragment row (and row + 8)
  const int tg = lane & 3;        // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // Q tile, zero past Sq and in the pad columns D..DP
  if (vec) {
    const int CV = DP >> 3;
    for (int i = tid; i < BQ * CV; i += THREADS) {
      const int r = i / CV;
      const int c = (i - r * CV) * 8;
      const int s = q0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (s < Sq && c < D) val = *reinterpret_cast<const uint4*>(qb + s * qss + c);
      *reinterpret_cast<uint4*>(Qs + r * LDS + c) = val;
    }
  } else {
    for (int i = tid; i < BQ * DP; i += THREADS) {
      const int r = i / DP;
      const int c = i - r * DP;
      const int s = q0 + r;
      Qs[r * LDS + c] = (s < Sq && c < D) ? qb[s * qss + c] : zero;
    }
  }

  float acc[2 * KTMAX][4];
#pragma unroll
  for (int n = 0; n < 2 * KTMAX; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g + 8
  float l0 = 0.0f, l1 = 0.0f;            // this lane's share of the row sums
  const bf16* Qw = Qs + (warp * 16 + g) * LDS + tg * 2;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();  // Q is staged / every warp is done with the last tile
    // K tile as rows, V tile transposed; consecutive threads take
    // consecutive keys, so the transposed 2-byte stores do not conflict.
    if (vec) {
      const int CV = DP >> 3;
      for (int i = tid; i < BK * CV; i += THREADS) {
        const int rr = i % BK;
        const int c = (i / BK) * 8;
        const int s = k0 + rr;
        uint4 kv = make_uint4(0, 0, 0, 0);
        uint4 vv = make_uint4(0, 0, 0, 0);
        if (s < Skv && c < D) {
          kv = *reinterpret_cast<const uint4*>(kb + s * kss + c);
          vv = *reinterpret_cast<const uint4*>(vb + s * vss + c);
        }
        *reinterpret_cast<uint4*>(Ks + rr * LDS + c) = kv;
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + rr] = ve[j];
      }
    } else {
      for (int i = tid; i < BK * DP; i += THREADS) {
        const int rr = i % BK;
        const int c = i / BK;
        const int s = k0 + rr;
        const bool in = s < Skv && c < D;
        Ks[rr * LDS + c] = in ? kb[s * kss + c] : zero;
        Vt[c * LDV + rr] = in ? vb[s * vss + c] : zero;
      }
    }
    __syncthreads();

    // scores [16 x BK] = q [16 x DP] . k^T [DP x BK]
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KTMAX; ++kk) {
      if (kk < KT) {
        const bf16* qp = Qw + kk * 16;
        const uint32_t a[4] = {lds32(qp), lds32(qp + 8 * LDS), lds32(qp + 8),
                               lds32(qp + 8 * LDS + 8)};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const bf16* kp = Ks + (j * 8 + g) * LDS + kk * 16 + tg * 2;
          mma16816(sc[j], a, lds32(kp), lds32(kp + 8));
        }
      }
    }

    // online softmax in the log2 domain; keys past Skv get -inf
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + j * 8 + tg * 2 + e < Skv;
        sc[j][e] = ok ? sc[j][e] * t_mult : -INFINITY;
        sc[j][2 + e] = ok ? sc[j][2 + e] * t_mult : -INFINITY;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0);  // 0 on the first tile (m = -inf)
    const float al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mn0);
      sc[j][1] = exp2f(sc[j][1] - mn0);
      sc[j][2] = exp2f(sc[j][2] - mn1);
      sc[j][3] = exp2f(sc[j][3] - mn1);
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
#pragma unroll
    for (int n = 0; n < 2 * KTMAX; ++n) {
      if (n < 2 * KT) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
    }

    // acc [16 x DP] += bf16(p) [16 x BK] . v [BK x DP]; the score
    // accumulators of 8-key tiles 2kk and 2kk + 1 are the A fragment of
    // key slice kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 2 * KTMAX; ++n) {
        if (n < 2 * KT) {
          const bf16* vp = Vt + (n * 8 + g) * LDV + kk * 16 + tg * 2;
          mma16816(acc[n], a, lds32(vp), lds32(vp + 8));
        }
      }
    }
  }

  // finalise: out = acc / l (the four lanes of a row hold its partial sums)
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < 2 * KTMAX; ++n) {
    if (n < 2 * KT) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + tg * 2 + e;
        if (c < D) {
          if (r0 < Sq) ob[r0 * oss + c] = __float2bfloat16_rn(acc[n][e] / l0);
          if (r1 < Sq) ob[r1 * oss + c] = __float2bfloat16_rn(acc[n][2 + e] / l1);
        }
      }
    }
  }
}

template <int KTMAX, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int D, const long long* st,
                   float t_mult, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, BK);
  auto kern = flash_runmax_bf16_kernel<KTMAX, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], t_mult, vec);
  return cudaGetLastError();
}

}  // namespace

// vec != 0: D % 8 == 0 and every q/k/v row 16-byte aligned (the wrapper
// decides); else element-wise loads.
extern "C" int vdx_flash_attention_runmax_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float t_mult, int vec, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Sq < 1 || Skv < 1 || B * H > 65535 ||
      (vec && D % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (D <= 128) return (int)launch<8, 64>(q, k, v, o, B, Sq, Skv, H, D, st, t_mult, vec, s);
  if (D <= 160) return (int)launch<10, 64>(q, k, v, o, B, Sq, Skv, H, D, st, t_mult, vec, s);
  return (int)launch<16, 32>(q, k, v, o, B, Sq, Skv, H, D, st, t_mult, vec, s);
}
