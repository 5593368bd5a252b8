// K1 and K4 — flash attention for Hopper (sm_90a) on wgmma + TMA, bf16
// operands: the STATIC and RUNMAX forms of the pipeline in
// flash_attention_sm90.cuh (its header has the design, the layouts and
// what bounds it).
//
// Replaces: vdx/kernels/flash_attention.py
//   flash_attention_dt(..., exp_impl="staticmax")   (K1; :204, pallas_call
//                                  :265, body _flash_dt_kernel :292, the
//                                  staticmax branch :336),
//   flash_attention                                  (K4; :135, pallas_call
//                                  :169, bodies :73, :746, :753),
// and runs flash_attention_dt(..., exp_impl="exp") (K1' exp) as K4's
// instance: the same function, counted apart by the wrapper.
//
// Instances: one per (form, DP), DP = 48, 80, 128, 160, 256: ten.

#include "flash_attention_sm90.cuh"

namespace {

// two kernel names, so a profile tells K1 from K4
template <int DP, int SW, int BN>
__global__ void __launch_bounds__(Cfg<DP, SW, BN>::THREADS, 1)
flash_sm90_static_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         bf16* __restrict__ o, int Sq, int Skv, int D,
                         long long osb, long long oss, long long osh,
                         float mult) {
  flash_sm90_body<STATIC, DP, SW, BN>(qmap, kmap, vmap, o, Sq, Skv, D, osb, oss,
                                  osh, mult, true, 0);
}

template <int DP, int SW, int BN>
__global__ void __launch_bounds__(Cfg<DP, SW, BN>::THREADS, 1)
flash_sm90_runmax_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         bf16* __restrict__ o, int Sq, int Skv, int D,
                         long long osb, long long oss, long long osh,
                         float mult) {
  flash_sm90_body<RUNMAX, DP, SW, BN>(qmap, kmap, vmap, o, Sq, Skv, D, osb, oss,
                                  osh, mult, false, 0);
}

// the kernel of form FORM at one instance, for launch_d
template <int FORM, int DP, int SW, int BN>
struct Pick {
  static auto kernel() {
    return FORM == STATIC ? flash_sm90_static_kernel<DP, SW, BN>
                          : flash_sm90_runmax_kernel<DP, SW, BN>;
  }
};

}  // namespace

// form: 0 RUNMAX (K4 and K1' exp: mult = scale * log2e on the fp32
// scores), 1 STATIC (K1: mult folded into q). Takes what operands_ok
// says (the wrapper decides); strides in elements (b, s, h) for q, k, v, o.
extern "C" int vdx_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int H, int D,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float mult, int form, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!operands_ok(q, k, v, o, B, Sq, Skv, H, D, st) || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  if (form == 1)
    return (int)launch_d<Pick, STATIC>(q, k, v, o, B, Sq, Skv, H, D, st,
                                       mult, s);
  return (int)launch_d<Pick, RUNMAX>(q, k, v, o, B, Sq, Skv, H, D, st, mult,
                                     s);
}

extern "C" const char* vdx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
