// K1 — staticmax flash attention for Hopper (sm_90a).
//
// Replaces: vdx/kernels/flash_attention.py  flash_attention_dt(...,
//   exp_impl="staticmax")  (kernel body _flash_dt_kernel).
//
// Computes, for q, k, v of shape [B, S, H, D] (bf16, any strides whose
// innermost is 1), the non-causal  out = softmax(q k^T * scale) v  in the
// max-free base-2 form of the TPU kernel:
//   q'  = bf16(float(q) * scale * log2(e))          (rounded once, as vdx)
//   s   = q' . k                                      (fp32 accumulate)
//   p   = 2^(s - 80)                                  (no running max)
//   l   = sum_k p  (fp32, from the unrounded p)
//   acc = sum_k bf16(p) * v                           (fp32 accumulate)
//   out = bf16(acc / max(l, 2^-126))
// The power-of-two offset is exact and cancels in acc / l; keys past Skv
// contribute p = 0. Order of summation: acc in the tensor cores' fp32
// accumulators, key tile by key tile; l per lane over its 32 columns of
// each tile, then the row's two lanes added. Against the plain version
// (pairwise fp32 sums) this moves results by a few fp32 ulps, below the
// single bf16 rounding of the output: the tolerance is one bf16 ulp. Domain bound (as vdx): a row whose every scaled logit
// is below -46 underflows to zeros; one above ~193 overflows.
//
// What bounds it on this card: tensor-core operations. At the main path's
// level-0 shape [32, 4096, 8, 40] the two products are 687 GFLOP against
// 336 MB of q/k/v/o traffic (0.69 ms at 989 TFLOP/s vs 0.10 ms at
// 3.35 TB/s).
//
// What the design does about it: both products run on the tensor cores
// (WMMA 16x16x16 bf16 -> fp32). One block owns one (b, h) and 64 queries
// (4 warps x 16 rows); it loops over 64-key tiles of K and V staged
// through shared memory, so K and V are read once per query tile and the
// S x S score matrix never reaches device memory. Because staticmax needs
// no running max, the output accumulators stay in WMMA accumulator
// fragments across the whole key loop with no rescale. The head dim is
// zero-padded to a multiple of 16 in shared memory only (D = 40 -> 48,
// D = 80 -> 80); the tensors in device memory are read unpadded with
// 16-byte loads.
//
// Later work (not here): wgmma + TMA, a K/V double buffer, and keeping the
// score tile in registers (mma.sync fragments) instead of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;              // queries per block
constexpr int BK = 64;              // keys per tile
constexpr int WARPS = BQ / 16;      // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float STATIC_OFF = 80.0f;
constexpr float L_FLOOR = 1.17549435e-38f;  // 2^-126

template <int KT>
struct Smem {
  static constexpr int DP = KT * 16;                              // padded D
  static constexpr int SW = (BK > DP ? BK : DP) * 16;             // floats/warp
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * DP;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BK * DP;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BK * DP;
  static constexpr size_t p_off = s_off + sizeof(float) * WARPS * SW;
  static constexpr size_t bytes = p_off + sizeof(__nv_bfloat16) * WARPS * 16 * BK;
};

template <int KT>
__global__ void __launch_bounds__(THREADS)
flash_dt_staticmax_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          int Sq, int Skv, int H, int D,
                          long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          long long osb, long long oss, long long osh,
                          float q_mult) {
  using L = Smem<KT>;
  constexpr int DP = L::DP;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  const int DV = D >> 3;  // 16-byte vectors per row

  // Zero Q/K/V staging once: the pad columns D..DP stay zero for the
  // whole block, so they add nothing to q.k and only feed discarded
  // output columns.
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = static_cast<int>(L::s_off / sizeof(uint4));
    for (int i = tid; i < n; i += THREADS) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // Q tile, pre-scaled by scale*log2(e) in fp32 and rounded once to bf16.
  for (int i = tid; i < BQ * DV; i += THREADS) {
    const int r = i / DV;
    const int c = (i - r * DV) * 8;
    const int s = q0 + r;
    if (s < Sq) {
      uint4 raw = *reinterpret_cast<const uint4*>(qb + s * qss + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * q_mult);
      *reinterpret_cast<uint4*>(Qs + r * DP + c) = raw;
    }
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[KT];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * DP + kk * 16, DP);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[KT];
#pragma unroll
  for (int n = 0; n < KT; ++n) wmma::fill_fragment(of[n], 0.0f);

  float* Sw = Ss + warp * L::SW;        // this warp's [16][BK] score tile
  __nv_bfloat16* Pw = Ps + warp * 16 * BK;
  const int r = lane & 15;              // row of the tile this lane reduces
  const int hcol = lane >> 4;           // which 32 of the 64 key columns
  float l_part = 0.0f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int rr = i / DV;
      const int c = (i - rr * DV) * 8;
      const int s = k0 + rr;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (s < Skv) {
        kv = *reinterpret_cast<const uint4*>(kb + s * kss + c);
        vv = *reinterpret_cast<const uint4*>(vb + s * vss + c);
      }
      *reinterpret_cast<uint4*>(Ks + rr * DP + c) = kv;
      *reinterpret_cast<uint4*>(Vs + rr * DP + c) = vv;
    }
    __syncthreads();

    // scores [16 x BK] = q' [16 x DP] . k^T [DP x BK]
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * DP + kk * 16, DP);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Sw + n * 16, sf, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // p = 2^(s - 80), masked past Skv; l from the fp32 p, PV from bf16(p).
    // Lane (r, hcol) walks its 32 columns starting at a lane-dependent
    // offset, so the 32 lanes hit 32 different banks.
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = hcol * 32 + ((j + lane) & 31);
      const float s = Sw[r * BK + c];
      const float p = (k0 + c < Skv) ? exp2f(s - STATIC_OFF) : 0.0f;
      l_part += p;
      Pw[r * BK + c] = __float2bfloat16_rn(p);
    }
    __syncwarp();

    // acc [16 x DP] += bf16(p) [16 x BK] . v [BK x DP]
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, Pw + kk * 16, BK);
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * 16 * DP + n * 16, DP);
        wmma::mma_sync(of[n], pf, vf, of[n]);
      }
    }
  }

  // finalise: out = acc / max(l, 2^-126)
  float l = l_part + __shfl_xor_sync(0xffffffffu, l_part, 16);
  l = fmaxf(l, L_FLOOR);
  __syncwarp();
  float* Ow = Sw;  // reuse the score scratch as [16][DP]
#pragma unroll
  for (int n = 0; n < KT; ++n)
    wmma::store_matrix_sync(Ow + n * 16, of[n], DP, wmma::mem_row_major);
  __syncwarp();
  const int s = q0 + warp * 16 + r;
  if (s < Sq) {
    __nv_bfloat16* orow = o + b * osb + s * oss + h * osh;
    for (int c = hcol; c < D; c += 2)
      orow[c] = __float2bfloat16_rn(Ow[r * DP + c] / l);
  }
}

template <int KT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int D,
                   const long long* st, float q_mult, cudaStream_t stream) {
  const size_t smem = Smem<KT>::bytes;
  auto kern = flash_dt_staticmax_kernel<KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Skv, H, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], q_mult);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vdx_flash_attention_dt_staticmax_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float q_mult, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D < 8 || D >= 128 || Sq < 1 || Skv < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  // One instantiation per 16-wide slice count of the head dims that
  // ops/attention sends to K1 (D % 8 == 0, D < 128): D = 8 .. 120.
  switch ((D + 15) / 16) {
    case 1: return (int)launch<1>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
    case 2: return (int)launch<2>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
    case 3: return (int)launch<3>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
    case 4: return (int)launch<4>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
    case 5: return (int)launch<5>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
    case 6: return (int)launch<6>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
    case 7: return (int)launch<7>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
    case 8: return (int)launch<8>(q, k, v, o, B, Sq, Skv, H, D, st, q_mult, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vdx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
