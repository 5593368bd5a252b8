// K1 and K4 with fp32 operands — SIMT flash attention for Hopper (sm_90a).
//
// Replaces, for fp32 q/k/v: vdx/kernels/flash_attention.py
//   flash_attention_dt(..., exp_impl="staticmax")  (K1, STATIC = true) and
//   flash_attention                                (K4, STATIC = false).
// On the TPU both kernels take fp32 operands and then keep p in fp32 for
// the PV product (p.astype(v.dtype)); nothing rounds to bf16. This file
// does the same on the CUDA cores: no tensor cores, no TF32.
//
//   K1 (STATIC):  q' = q * scale * log2(e);  p = 2^(q'.k - 80);
//                 out = (sum p v) / max(sum p, 2^-126)
//   K4:           s = (q.k) * scale * log2(e); running max m, alpha = 2^(m - m');
//                 p = 2^(s - m'); l' = alpha l + sum p; acc' = alpha acc + p v;
//                 out = acc / l
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
constexpr float STATIC_OFF = 80.0f;
constexpr float L_FLOOR = 1.17549435e-38f;  // 2^-126
constexpr unsigned FULL = 0xffffffffu;

inline size_t smem_bytes(int D) {
  const int LD = D | 1;
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * (BK + 1));
}

template <bool STATIC, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int Sq, int Skv, int H, int D,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh, float mult) {
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
  // K1 pre-scales q (vdx rounds q * scale * log2e to q's dtype, exact in
  // fp32 up to the product's own rounding); K4 scales the scores.
  const float qmul = STATIC ? mult : 1.0f;
  const float smul = STATIC ? 1.0f : mult;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D;
    const int c = i - rr * D;
    const int s = q0 + rr;
    Qs[rr * LD + c] = s < Sq ? qb[s * qss + c] * qmul : 0.0f;
  }

  float acc[DJ];
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) acc[jj] = 0.0f;
  float m = -INFINITY;  // running max of the row (K4)
  float l = 0.0f;       // this lane's share of the row sum

  for (int k0 = 0; k0 < Skv; k0 += BK) {
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
      p[j] = k0 + key < Skv ? dot * smul : -INFINITY;
    }
    float alpha = 1.0f;
    if (STATIC) {
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = exp2f(p[j] - STATIC_OFF);
    } else {
      float mx = p[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, p[j]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mn = fmaxf(m, mx);
      alpha = exp2f(m - mn);  // 0 on the first tile (m = -inf)
      m = mn;
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = exp2f(p[j] - mn);
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
  if (STATIC) l = fmaxf(l, L_FLOOR);
  const int s = q0 + r;
  if (s < Sq) {
    float* orow = o + b * osb + s * oss + h * osh;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = qd + 4 * jj;
      if (d < D) orow[d] = acc[jj] / l;
    }
  }
}

template <bool STATIC, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int D, const long long* st,
                   float mult, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kern = flash_f32_kernel<STATIC, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], mult);
  return cudaGetLastError();
}

}  // namespace

// running_max = 0: K1's staticmax form (mult = scale * log2e folded into
// q, D % 8 == 0, D < 128); running_max = 1: K4's form (mult = scale *
// log2e on the scores, any D <= 256).
extern "C" int vdx_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float mult, int running_max, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Sq < 1 || Skv < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!running_max) {
    if (D % 8 != 0 || D >= 128) return (int)cudaErrorInvalidValue;
    return (int)launch<true, 128>(q, k, v, o, B, Sq, Skv, H, D, st, mult, s);
  }
  if (D <= 128) return (int)launch<false, 128>(q, k, v, o, B, Sq, Skv, H, D, st, mult, s);
  return (int)launch<false, 256>(q, k, v, o, B, Sq, Skv, H, D, st, mult, s);
}
