// K4, K1', K5 and K1 off the wgmma + TMA pipeline — flash attention for
// Hopper (sm_90a), bf16 operands, as one mma.sync kernel templated over
// the softmax form (the template).
//
// Replaces: vdx/kernels/flash_attention.py
//   flash_attention                       (K4; bodies _flash_kernel_*),
//   flash_attention_dt, every exp_impl    (K1 staticmax; K1' exp, exp2,
//                                         fastexp2, noexp, mxu_only; body
//                                         _flash_dt_kernel),
//   _flash_dt_staticaug                   (K5; body _flash_dt_staticaug_kernel),
// where the wgmma + TMA pipeline (flash_attention_sm90.cuh), which takes
// every one of them in bf16 at D % 8 == 0, 8 <= D <= 256 on 16-byte
// aligned rows, does not: rows that are not 16-byte aligned, and K4 at
// D % 8 != 0. The wrapper counts these
// launches apart ("K1 static", "K4 template", "<form> template").
//
// Computes, for q, k, v of shape [B, S, H, D] (bf16, any strides whose
// innermost is 1, any 1 <= D <= 256), non-causal attention in one of
// vdx's forms, one key tile at a time. fold: q is staged as
// bf16(float(q) * mult), so s = q'.k is in the log2 domain (every form but
// exp); exp instead multiplies the fp32 scores by mult = scale * log2(e),
// base 2 standing for vdx's base e. r() rounds to bf16.
//   RUNMAX (exp, exp2):  m' = max(m, tilemax s), alpha = 2^(m - m'),
//                        p = 2^(s - m'), l' = alpha l + sum p,
//                        acc' = alpha acc + r(p) v, out = r(acc / l)
//   FAST (fastexp2):     RUNMAX with vdx's cubic fast_exp2 for 2^x, the
//                        max updated once per `period` keys (vdx's
//                        effective block_k)
//   STATIC (staticmax):  p = 2^(s - 80), l = sum p, acc = sum r(p) v,
//                        out = r(acc / max(l, 2^-126))
//          (staticaug):  the same with l = sum r(p) (aug)
//   NOEXP (noexp):       FAST with x + 1 in place of 2^x; keys past Skv
//                        up to a multiple of the period score -1e30 and
//                        enter l, as vdx's padding
//   MXU (mxu_only):      out = r(sum r(s) v), no softmax
// Keys past Skv score -1e30 (p = 0 in every softmax form but noexp); in
// MXU their k and v rows are zero, as vdx's zero padding.
//
// exp and exp2 rescale once per 64-key tile (32 at D > 160), the same
// function as vdx's once per block up to fp32 rounding. fastexp2's and
// noexp's outputs depend on where the max is updated (the cubic's 7.5e-5
// error composes over the rescales; x + 1 is no exponential at all), so a
// period first takes a max-only sweep of q.k over its tiles (K tiles
// staged twice: extra QK work that vdx's kernel does not do, counted as
// the form's own cost, not K1's), then the p/PV sweep.
//
// What bounds it on this card: tensor-core operations and bytes, about
// even at the length of the 768x768 level-2 site: at [32, 576, 8, 256]
// the two products are 87 GFLOP (0.088 ms at 989 TFLOP/s) against 0.090
// ms of q/k/v/o bytes at 3.35 TB/s. No SD-1.5 site reaches it.
//
// What the design does about it: both products run on the tensor cores
// through mma.sync.m16n8k16 (bf16 in, fp32 accumulate). One block owns one
// (b, h) and 64 queries (4 warps x 16 rows) and loops over key tiles
// staged in shared memory, so the S x S score matrix never reaches device
// memory. The mma.sync accumulator layout is documented (a lane owns rows
// lane/4 and lane/4 + 8, two adjacent columns of each 8-wide tile), so the
// row max, the row sum and the alpha rescale of the output accumulators
// all stay in registers, and the score fragments are re-packed in
// registers as the A operand of the PV product without a round trip
// through shared memory. V is stored transposed in shared memory so every
// B fragment is one 32-bit load. The head dim is zero-padded to a multiple
// of 16 in shared memory only; rows are read with 16-byte loads when
// D % 8 == 0 and every row is 16-byte aligned, else element by element.
// Row strides in shared memory are padded by 8 elements, which makes every
// fragment load bank-conflict free.
//
// Instantiations: form x a compile-time bound on the 16-wide D slices (8,
// 10, 16: D <= 128, <= 160, <= 256) with the actual count a runtime guard
// inside fully unrolled loops, so the accumulators stay in registers. The
// D <= 256 instances take 32-key tiles to bound registers (128 fp32
// accumulators a thread), the others 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;           // queries per block
constexpr int THREADS = 128;     // 4 warps x 16 query rows
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;    // vdx's NEG_INF for masked scores
constexpr float STATIC_OFF = 80.0f;
constexpr float L_FLOOR = 1.17549435e-38f;  // 2^-126

// the kernel's forms; the entry point's form codes (vdx's exp_impl) map
// onto them with the fold and aug flags
enum Form { RUNMAX = 0, FAST = 1, STATIC = 2, NOEXP = 3, MXU = 4 };

// vdx's _fast_exp2, operation by operation in fp32 (the __f*_rn
// intrinsics keep nvcc from contracting the cubic into FMAs, which the
// plain version on the CPU does not do)
__device__ __forceinline__ float fast_exp2(float y) {
  y = fmaxf(y, -125.0f);
  const float n = floorf(y);
  const float f = __fsub_rn(y, n);
  float p = __fadd_rn(__fmul_rn(0.0780238760040786f, f), 0.22606693137993905f);
  p = __fadd_rn(__fmul_rn(p, f), 0.6958342408899721f);
  p = __fadd_rn(__fmul_rn(p, f), 0.9999250788416159f);
  return __fmul_rn(__int_as_float((static_cast<int>(n) + 127) << 23), p);
}

template <int FORM>
__device__ __forceinline__ float softmax_exp(float x) {
  if (FORM == FAST) return fast_exp2(x);
  if (FORM == NOEXP) return x + 1.0f;
  return exp2f(x);
}

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shared memory: Qs [BQ][LDS], Ks [BK][LDS], Vt [DP][BK + 8] (V transposed),
// with DP = 16 * ceil(D / 16) and LDS = DP + 8.
__host__ __device__ inline size_t smem_bytes(int D, int BK) {
  const int DP = ((D + 15) / 16) * 16;
  return sizeof(bf16) * ((size_t)(BQ + BK) * (DP + 8) + (size_t)DP * (BK + 8));
}

// The K tile [k0, k0 + BK) as rows and, with_v, the V tile transposed;
// zero past Skv and in the pad columns. Consecutive threads take
// consecutive keys, so the transposed 2-byte stores do not conflict.
template <int BK>
__device__ __forceinline__ void stage_kv(bf16* Ks, bf16* Vt, const bf16* kb,
                                         const bf16* vb, long long kss,
                                         long long vss, int k0, int Skv, int D,
                                         int DP, int LDS, int vec, bool with_v) {
  constexpr int LDV = BK + 8;
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  if (vec) {
    const int CV = DP >> 3;
    for (int i = tid; i < BK * CV; i += THREADS) {
      const int rr = i % BK;
      const int c = (i / BK) * 8;
      const int s = k0 + rr;
      const bool in = s < Skv && c < D;
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Ks + rr * LDS + c) =
          in ? *reinterpret_cast<const uint4*>(kb + s * kss + c) : z;
      if (with_v) {
        const uint4 vv = in ? *reinterpret_cast<const uint4*>(vb + s * vss + c) : z;
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + rr] = ve[j];
      }
    }
  } else {
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int rr = i % BK;
      const int c = i / BK;
      const int s = k0 + rr;
      const bool in = s < Skv && c < D;
      Ks[rr * LDS + c] = in ? kb[s * kss + c] : zero;
      if (with_v) Vt[c * LDV + rr] = in ? vb[s * vss + c] : zero;
    }
  }
}

// scores [16 x BK] = q [16 x DP] . k^T [DP x BK] for this warp's rows
template <int KTMAX, int BK>
__device__ __forceinline__ void qk_scores(float (&sc)[BK / 8][4], const bf16* Qw,
                                          const bf16* Ks, int KT, int LDS,
                                          int g, int tg) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KTMAX; ++kk) {
    if (kk < KT) {
      const bf16* qp = Qw + kk * 16;
      const uint32_t a[4] = {lds32(qp), lds32(qp + 8 * LDS), lds32(qp + 8),
                             lds32(qp + 8 * LDS + 8)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const bf16* kp = Ks + (j * 8 + g) * LDS + kk * 16 + tg * 2;
        mma16816(sc[j], a, lds32(kp), lds32(kp + 8));
      }
    }
  }
}

// the max over a row's four lanes (tg = 0..3)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

template <int FORM, int KTMAX, int BK>
__global__ void __launch_bounds__(THREADS)
flash_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int Sq, int Skv, int H, int D,
                      long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh,
                      long long vsb, long long vss, long long vsh,
                      long long osb, long long oss, long long osh,
                      float mult, int fold, int aug, int period, int vec) {
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
  const float s_mult = fold ? 1.0f : mult;

  // Q tile, zero past Sq and in the pad columns D..DP; fold: each element
  // bf16(float(q) * mult), rounded once
  if (vec) {
    const int CV = DP >> 3;
    for (int i = tid; i < BQ * CV; i += THREADS) {
      const int r = i / CV;
      const int c = (i - r * CV) * 8;
      const int s = q0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (s < Sq && c < D) val = *reinterpret_cast<const uint4*>(qb + s * qss + c);
      if (fold) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * mult);
      }
      *reinterpret_cast<uint4*>(Qs + r * LDS + c) = val;
    }
  } else {
    for (int i = tid; i < BQ * DP; i += THREADS) {
      const int r = i / DP;
      const int c = i - r * DP;
      const int s = q0 + r;
      bf16 val = (s < Sq && c < D) ? qb[s * qss + c] : zero;
      if (fold) val = __float2bfloat16_rn(__bfloat162float(val) * mult);
      Qs[r * LDS + c] = val;
    }
  }

  float acc[2 * KTMAX][4];
#pragma unroll
  for (int n = 0; n < 2 * KTMAX; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = NEG, m1 = NEG;    // running max, rows g and g + 8
  float l0 = 0.0f, l1 = 0.0f;  // this lane's share of the row sums
  const bf16* Qw = Qs + (warp * 16 + g) * LDS + tg * 2;
  // noexp runs over vdx's padded key count, a multiple of the period
  const int kv_end = FORM == NOEXP ? ((Skv + period - 1) / period) * period : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    if ((FORM == NOEXP || FORM == FAST) && k0 % period == 0) {
      // a statistics period begins: its max from a max-only q.k sweep
      float mx0 = NEG, mx1 = NEG;
      for (int t0 = k0; t0 < min(k0 + period, kv_end); t0 += BK) {
        __syncthreads();
        stage_kv<BK>(Ks, Vt, kb, vb, kss, vss, t0, Skv, D, DP, LDS, vec, false);
        __syncthreads();
        float sc[NJ][4];
        qk_scores<KTMAX, BK>(sc, Qw, Ks, KT, LDS, g, tg);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (t0 + j * 8 + tg * 2 + e < Skv) {
              mx0 = fmaxf(mx0, sc[j][e]);
              mx1 = fmaxf(mx1, sc[j][2 + e]);
            }
          }
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = softmax_exp<FORM>(m0 - mn0);
      const float al1 = softmax_exp<FORM>(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < 2 * KTMAX; ++n) {
        if (n < 2 * KT) {
          acc[n][0] *= al0;
          acc[n][1] *= al0;
          acc[n][2] *= al1;
          acc[n][3] *= al1;
        }
      }
    }
    __syncthreads();  // Q is staged / every warp is done with the last tile
    stage_kv<BK>(Ks, Vt, kb, vb, kss, vss, k0, Skv, D, DP, LDS, vec, true);
    __syncthreads();

    float sc[NJ][4];
    qk_scores<KTMAX, BK>(sc, Qw, Ks, KT, LDS, g, tg);

    // scores -> p in the form's arithmetic; ps: this lane's row sums
    float ps0 = 0.0f, ps1 = 0.0f;
    if (FORM == STATIC || FORM == MXU) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k0 + j * 8 + tg * 2 + (e & 1) < Skv;
          float p = 0.0f;
          if (ok) p = FORM == MXU ? sc[j][e] : exp2f(sc[j][e] - STATIC_OFF);
          if (FORM == STATIC) {
            sc[j][e] = p;
            const float pl = aug ? round_bf16(p) : p;
            if (e < 2) ps0 += pl; else ps1 += pl;
          } else {
            sc[j][e] = p;
          }
        }
      }
      l0 += ps0;
      l1 += ps1;
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k0 + j * 8 + tg * 2 + (e & 1) < Skv;
          sc[j][e] = ok ? sc[j][e] * s_mult : NEG;
        }
      }
      float mn0 = m0, mn1 = m1, al0 = 1.0f, al1 = 1.0f;
      if (FORM == RUNMAX) {  // the max once per tile
        float mx0 = NEG, mx1 = NEG;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
        mn0 = fmaxf(m0, quad_max(mx0));
        mn1 = fmaxf(m1, quad_max(mx1));
        al0 = softmax_exp<FORM>(m0 - mn0);  // 0 on the first tile
        al1 = softmax_exp<FORM>(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sc[j][0] = softmax_exp<FORM>(sc[j][0] - mn0);
        sc[j][1] = softmax_exp<FORM>(sc[j][1] - mn0);
        sc[j][2] = softmax_exp<FORM>(sc[j][2] - mn1);
        sc[j][3] = softmax_exp<FORM>(sc[j][3] - mn1);
        ps0 += sc[j][0] + sc[j][1];
        ps1 += sc[j][2] + sc[j][3];
      }
      if (FORM != RUNMAX) {  // rescaled once per period, above
        l0 += ps0;
        l1 += ps1;
      } else {
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

  // finalise: out = acc / l (the four lanes of a row hold its partial
  // sums); staticmax floors l, mxu_only does not normalise
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  if (FORM == STATIC) {
    l0 = fmaxf(l0, L_FLOOR);
    l1 = fmaxf(l1, L_FLOOR);
  }
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
          const float y0 = FORM == MXU ? acc[n][e] : acc[n][e] / l0;
          const float y1 = FORM == MXU ? acc[n][2 + e] : acc[n][2 + e] / l1;
          if (r0 < Sq) ob[r0 * oss + c] = __float2bfloat16_rn(y0);
          if (r1 < Sq) ob[r1 * oss + c] = __float2bfloat16_rn(y1);
        }
      }
    }
  }
}

template <int FORM, int KTMAX, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int D, const long long* st,
                   float mult, int fold, int aug, int period, int vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D, BK);
  auto kern = flash_mma_bf16_kernel<FORM, KTMAX, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], mult, fold, aug, period, vec);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int H, int D, const long long* st,
                     float mult, int fold, int aug, int period, int vec,
                     cudaStream_t s) {
  if (D <= 128)
    return launch<FORM, 8, 64>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, aug, period, vec, s);
  if (D <= 160)
    return launch<FORM, 10, 64>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, aug, period, vec, s);
  return launch<FORM, 16, 32>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, aug, period, vec, s);
}

}  // namespace

// form: vdx's exp_impl, 0 exp (K4 and K1' exp: mult = scale * log2e on
// the fp32 scores), 1 exp2, 2 fastexp2, 3 staticmax, 4 staticaug, 5 noexp,
// 6 mxu_only (forms 1-6 fold mult into q). period: noexp's statistics
// period in keys, a positive multiple of 128 (vdx's effective block_k).
// vec != 0: D % 8 == 0 and every q/k/v row 16-byte aligned (the wrapper
// decides); else element-wise loads.
extern "C" int vdx_flash_attention_mma_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float mult, int form, int period, int vec, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Sq < 1 || Skv < 1 || B * H > 65535 ||
      (vec && D % 8 != 0) || form < 0 || form > 6 ||
      ((form == 2 || form == 5) && (period < 128 || period % 128 != 0)))
    return (int)cudaErrorInvalidValue;
  const int fold = form != 0;
  switch (form) {
    case 0:
    case 1:
      return (int)launch_d<RUNMAX>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, 0, period, vec, s);
    case 2:
      return (int)launch_d<FAST>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, 0, period, vec, s);
    case 3:
    case 4:
      return (int)launch_d<STATIC>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, form == 4, period, vec, s);
    case 5:
      return (int)launch_d<NOEXP>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, 0, period, vec, s);
    default:
      return (int)launch_d<MXU>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, 0, period, vec, s);
  }
}
