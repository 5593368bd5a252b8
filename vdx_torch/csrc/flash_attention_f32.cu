// K1, K1', K4 and K5 with fp32 operands — SIMT flash attention for
// Hopper (sm_90a).
//
// Replaces, for fp32 q/k/v: vdx/kernels/flash_attention.py
//   flash_attention_dt, every exp_impl  (K1 staticmax, K5 staticaug, K1'
//                                        exp, exp2, fastexp2, noexp,
//                                        mxu_only) and
//   flash_attention                     (K4, the exp form).
// On the TPU these kernels take fp32 operands and then keep p in fp32 for
// the PV product (p.astype(v.dtype)); nothing rounds to bf16. This file
// does the same on the CUDA cores: no tensor cores, no TF32. So staticaug
// (l from the rounded p) computes what staticmax does; it stays a form of
// its own so that K5 is counted apart.
//
//   fold (every form but exp): q' = q * scale * log2(e), s = q'.k;
//   exp: s = (q.k) * scale * log2(e) (base 2 standing for base e)
//   RUNMAX (exp, exp2): running max m per 32-key tile, alpha = 2^(m - m'),
//     p = 2^(s - m'), l' = alpha l + sum p, acc' = alpha acc + p v,
//     out = acc / l
//   FAST (fastexp2, vdx's cubic): RUNMAX with the max once per `period`
//     keys (vdx's effective block_k, from a max-only sweep first)
//   STATIC (staticmax, staticaug): p = 2^(s - 80), out = (sum p v) /
//     max(sum p, 2^-126)
//   NOEXP: FAST with x + 1 for 2^x, keys past Skv up to a multiple of the
//     period scoring -1e30 (they enter l, as vdx's padding)
//   MXU (mxu_only): out = sum s v
//
// What bounds it on this card: fp32 operations outside the tensor cores
// (67 TFLOP/s), 4 * B * H * Sq * Skv * D of them.
//
// What the design does about it: little; it is the fp32 policy's path,
// simple and right first. One block owns one (b, h) and 32 queries; four
// lanes share a query row, each computing 8 of a 32-key tile's scores
// (row reductions by two shuffles) and a quarter of the output columns.
// Q, K and V tiles sit in shared memory with an odd row stride, so the
// lanes' reads fall in distinct banks; p goes through shared memory to
// the four lanes of its row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;   // queries per block, four lanes each
constexpr int BK = 32;   // keys per tile, eight per lane
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;  // vdx's NEG_INF for masked scores
constexpr float STATIC_OFF = 80.0f;
constexpr float L_FLOOR = 1.17549435e-38f;  // 2^-126
constexpr unsigned FULL = 0xffffffffu;

enum Form { RUNMAX = 0, FAST = 1, STATIC = 2, NOEXP = 3, MXU = 4 };

// vdx's _fast_exp2, operation by operation in fp32 (no FMA contraction)
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

inline size_t smem_bytes(int D) {
  const int LD = D | 1;
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * (BK + 1));
}

template <int FORM, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int Sq, int Skv, int H, int D,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh, float mult,
                 int fold, int period) {
  constexpr int DJ = DMAX / 4;  // output columns per lane: d = qd + 4 jj
  const int LD = D | 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;              // [BQ][LD]
  float* Ks = Qs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* Ps = Vs + BK * LD;     // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;       // query row of the block
  const int qd = tid & 3;       // lane within the row
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  // fold: q pre-scaled (vdx rounds q * scale * log2e to q's dtype, exact
  // in fp32 up to the product's own rounding); exp scales the scores.
  const float qmul = fold ? mult : 1.0f;
  const float smul = fold ? 1.0f : mult;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D;
    const int c = i - rr * D;
    const int s = q0 + rr;
    Qs[rr * LD + c] = s < Sq ? qb[s * qss + c] * qmul : 0.0f;
  }

  float acc[DJ];
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) acc[jj] = 0.0f;
  float m = NEG;    // running max of the row
  float l = 0.0f;   // this lane's share of the row sum
  // noexp runs over vdx's padded key count, a multiple of the period
  const int kv_end = FORM == NOEXP ? ((Skv + period - 1) / period) * period : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    if ((FORM == NOEXP || FORM == FAST) && k0 % period == 0) {
      // a statistics period begins: its max from a max-only q.k sweep
      float mx = NEG;
      for (int t0 = k0; t0 < min(k0 + period, kv_end); t0 += BK) {
        __syncthreads();
        for (int i = tid; i < BK * D; i += THREADS) {
          const int rr = i / D;
          const int c = i - rr * D;
          Ks[rr * LD + c] = t0 + rr < Skv ? kb[(t0 + rr) * kss + c] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = qd + 4 * j;
          float dot = 0.0f;
          for (int d = 0; d < D; ++d) dot += Qs[r * LD + d] * Ks[key * LD + d];
          if (t0 + key < Skv) mx = fmaxf(mx, dot);
        }
      }
      const float mn = fmaxf(m, quad_max(mx));
      const float al = softmax_exp<FORM>(m - mn);
      m = mn;
      l *= al;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[jj] *= al;
    }
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D;
      const int c = i - rr * D;
      const int s = k0 + rr;
      Ks[rr * LD + c] = s < Skv ? kb[s * kss + c] : 0.0f;
      Vs[rr * LD + c] = s < Skv ? vb[s * vss + c] : 0.0f;
    }
    __syncthreads();

    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = qd + 4 * j;
      float dot = 0.0f;
      for (int d = 0; d < D; ++d) dot += Qs[r * LD + d] * Ks[key * LD + d];
      const bool ok = k0 + key < Skv;
      if (FORM == STATIC) p[j] = ok ? exp2f(dot - STATIC_OFF) : 0.0f;
      else if (FORM == MXU) p[j] = ok ? dot : 0.0f;
      else p[j] = ok ? dot * smul : NEG;
    }
    float alpha = 1.0f;
    if (FORM == RUNMAX) {  // the max once per tile
      float mx = p[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, p[j]);
      const float mn = fmaxf(m, quad_max(mx));
      alpha = softmax_exp<FORM>(m - mn);  // 0 on the first tile
      m = mn;
    }
    if (FORM == RUNMAX || FORM == FAST || FORM == NOEXP) {
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = softmax_exp<FORM>(p[j] - m);
    }
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ps += p[j];
      Ps[r * (BK + 1) + qd + 4 * j] = p[j];
    }
    l = alpha * l + ps;
    __syncwarp();  // a row's four lanes are in one warp
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[jj] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float pc = Ps[r * (BK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = qd + 4 * jj;
        if (d < D) acc[jj] += pc * Vs[c * LD + d];
      }
    }
    __syncwarp();
  }

  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  if (FORM == STATIC) l = fmaxf(l, L_FLOOR);
  const int s = q0 + r;
  if (s < Sq) {
    float* orow = o + b * osb + s * oss + h * osh;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = qd + 4 * jj;
      if (d < D) orow[d] = FORM == MXU ? acc[jj] : acc[jj] / l;
    }
  }
}

template <int FORM, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int D, const long long* st,
                   float mult, int fold, int period, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kern = flash_f32_kernel<FORM, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], mult, fold, period);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int H, int D, const long long* st,
                     float mult, int fold, int period, cudaStream_t s) {
  if (D <= 128) return launch<FORM, 128>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, period, s);
  return launch<FORM, 256>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, period, s);
}

}  // namespace

// form: vdx's exp_impl, as vdx_flash_attention_mma_bf16: 0 exp (K4 and
// K1' exp: mult = scale * log2e on the scores), 1 exp2, 2 fastexp2,
// 3 staticmax, 4 staticaug, 5 noexp, 6 mxu_only (forms 1-6 fold mult
// into q); period: noexp's statistics period, a multiple of 128 keys.
extern "C" int vdx_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float mult, int form, int period, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Sq < 1 || Skv < 1 || B * H > 65535 || form < 0 ||
      form > 6 || ((form == 2 || form == 5) && (period < 128 || period % 128 != 0)))
    return (int)cudaErrorInvalidValue;
  const int fold = form != 0;
  switch (form) {
    case 0:
    case 1:
      return (int)launch_d<RUNMAX>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, period, s);
    case 2:
      return (int)launch_d<FAST>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, period, s);
    case 3:
    case 4:
      return (int)launch_d<STATIC>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, period, s);
    case 5:
      return (int)launch_d<NOEXP>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, period, s);
    default:
      return (int)launch_d<MXU>(q, k, v, o, B, Sq, Skv, H, D, st, mult, fold, period, s);
  }
}
