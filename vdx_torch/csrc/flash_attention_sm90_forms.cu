// K1' and K5 — the other forms of vdx's flash_attention_dt for Hopper
// (sm_90a) on the wgmma + TMA pipeline of flash_attention_sm90.cuh (its
// header has the forms' arithmetic, the design, the layouts and what
// bounds it), bf16 operands, one kernel name per form.
//
// Replaces: vdx/kernels/flash_attention.py
//   flash_attention_dt(..., exp_impl=exp2 | fastexp2 | noexp | mxu_only)
//                    (K1'; :204, pallas_call :265, body _flash_dt_kernel
//                     :292: mxu_only :317, the running-max forms :361-388,
//                     _fast_exp2 :55),
//   _flash_dt_staticaug                              (K5; :393, pallas_call
//                     :435, body _flash_dt_staticaug_kernel :456).
// (exp is K4's instance in flash_attention_sm90.cu.)
//
//   flash_sm90f_exp2_kernel       RUNMAX after the q fold
//   flash_sm90f_staticaug_kernel  AUG
//   flash_sm90f_mxu_only_kernel   MXU
//   flash_sm90f_fastexp2_kernel   PERIOD with vdx's cubic
//   flash_sm90f_noexp_kernel      PERIOD with x + 1
//
// Instances: one per (form, DP), DP = 48, 80, 128, 160, 256: twenty-five.

#include "flash_attention_sm90.cuh"

namespace {

#define VDX_SM90_FORM(NAME, FORM)                                          \
  template <int DP, int SW, int BN>                                        \
  __global__ void __launch_bounds__(Cfg<DP, SW, BN>::THREADS, 1)           \
  NAME(const __grid_constant__ CUtensorMap qmap,                           \
       const __grid_constant__ CUtensorMap kmap,                           \
       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,     \
       int Sq, int Skv, int D, long long osb, long long oss, long long osh, \
       float mult, int period) {                                           \
    flash_sm90_body<FORM, DP, SW, BN>(qmap, kmap, vmap, o, Sq, Skv, D, osb, \
                                      oss, osh, mult, true, period);       \
  }

VDX_SM90_FORM(flash_sm90f_exp2_kernel, RUNMAX)
VDX_SM90_FORM(flash_sm90f_staticaug_kernel, AUG)
VDX_SM90_FORM(flash_sm90f_mxu_only_kernel, MXU)
VDX_SM90_FORM(flash_sm90f_fastexp2_kernel, FAST)
VDX_SM90_FORM(flash_sm90f_noexp_kernel, NOEXP)

#undef VDX_SM90_FORM

// the kernel of form FORM at one instance, for launch_d
template <int FORM, int DP, int SW, int BN>
struct Pick {
  static auto kernel() {
    return FORM == RUNMAX ? flash_sm90f_exp2_kernel<DP, SW, BN>
           : FORM == AUG  ? flash_sm90f_staticaug_kernel<DP, SW, BN>
           : FORM == MXU  ? flash_sm90f_mxu_only_kernel<DP, SW, BN>
           : FORM == FAST ? flash_sm90f_fastexp2_kernel<DP, SW, BN>
                          : flash_sm90f_noexp_kernel<DP, SW, BN>;
  }
};

}  // namespace

// form: vdx's exp_impl code, 1 exp2, 2 fastexp2, 4 staticaug, 5 noexp,
// 6 mxu_only, each with mult = scale * log2e folded into q. period:
// fastexp2's and noexp's statistics period in keys, a positive multiple
// of 128 (vdx's effective block_k). Takes what operands_ok says (the
// wrapper decides); strides in elements (b, s, h) for q, k, v, o.
extern "C" int vdx_flash_attention_sm90_forms(
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
  if (!operands_ok(q, k, v, o, B, Sq, Skv, H, D, st) ||
      ((form == 2 || form == 5) && (period < 128 || period % 128 != 0)))
    return (int)cudaErrorInvalidValue;
  switch (form) {
    case 1:
      return (int)launch_d<Pick, RUNMAX>(q, k, v, o, B, Sq, Skv, H, D, st,
                                         mult, s, period);
    case 2:
      return (int)launch_d<Pick, FAST>(q, k, v, o, B, Sq, Skv, H, D, st,
                                       mult, s, period);
    case 4:
      return (int)launch_d<Pick, AUG>(q, k, v, o, B, Sq, Skv, H, D, st,
                                      mult, s, period);
    case 5:
      return (int)launch_d<Pick, NOEXP>(q, k, v, o, B, Sq, Skv, H, D, st,
                                        mult, s, period);
    case 6:
      return (int)launch_d<Pick, MXU>(q, k, v, o, B, Sq, Skv, H, D, st,
                                      mult, s, period);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
