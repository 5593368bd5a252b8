// Flash attention for Hopper (sm_90a) on wgmma + TMA, bf16 operands: the
// pipeline that K1 and K4 (flash_attention_sm90.cu) and the other forms of
// vdx's flash_attention_dt, K1' and K5 (flash_attention_sm90_forms.cu),
// instantiate, each form under a kernel name of its own.
//
// Computes, for q, k, v of shape [B, S, H, D] (bf16, any strides whose
// innermost is 1, rows and bases 16-byte aligned, D % 8 == 0, D <= 256),
// non-causal attention, one 128-query tile per CTA (64 past D = 160), key
// tile by key tile.
// r() rounds to bf16. fold: q' = r(float(q) * mult), mult = scale *
// log2(e), so s = q'.k (fp32) is in the log2 domain.
//   STATIC (K1, staticmax; fold): p = 2^(s - 80), l = sum p (from the
//                 unrounded p), acc = sum r(p) v, out = r(acc / max(l, 2^-126)).
//                 p keeps its subnormal values (exp2f without flushing),
//                 as the plain version does, so a row whose every scaled
//                 logit is below about -69 gives zeros; vdx on the TPU,
//                 which flushes them, gives zeros below -46.
//   AUG (K5, staticaug; fold): STATIC with l = sum r(p), read back from the
//                 packed bf16 p.
//   RUNMAX (K4 and exp: s = (q.k) * mult in fp32, base 2 standing for
//                 vdx's base e; exp2: fold, s taken as it is):
//                 m' = max(m, tilemax s), alpha = 2^(m - m'),
//                 p = 2^(s - m'), l' = alpha l + sum p, acc' = alpha acc +
//                 r(p) v, out = r(acc / l). The max is taken once per key
//                 tile: the same function as vdx's once per block, up to
//                 fp32 rounding.
//   MXU (mxu_only; fold): p = s, no statistics, out = r(acc).
//   PERIOD (FAST, fastexp2, vdx's cubic for 2^x; NOEXP, noexp, x + 1;
//                 fold): RUNMAX with the max updated once per `period`
//                 keys, vdx's effective block_k, on which their outputs
//                 depend (the cubic's 7.5e-5 error composes over the
//                 rescales; x + 1 is no exponential at all). Each period's
//                 K tiles first stream through the ring alone, for a
//                 max-only QK^T sweep (the form's own extra work: one more
//                 QK^T per tile), then K and V for the usual sweep, with
//                 alpha, l and acc rescaled once at the period's first
//                 tile. noexp runs to vdx's padded key count, a multiple
//                 of the period; keys from Skv score -1e30 and enter l
//                 (their v rows are zero).
// The DP = 256 instance writes r(acc * (1 / l)): the quotient one fp32
// rounding apart, one division a row in place of one an element.
// Keys past Skv are masked in the last tile (p = 0 in STATIC and AUG,
// s = -inf in RUNMAX, -1e30 in PERIOD): TMA fills them with zeros, which
// would score 0 and put 2^-80 per padded key into STATIC's l. In MXU their
// zero k and v rows add nothing, as vdx's zero padding.
//
// What bounds it on this card. At D = 40 the special-function unit: one
// exp2 per score at 16 a clock per SM (CUDA C++ Programming Guide,
// arithmetic instruction throughput, compute capability 9.0), 1.03 ms at
// [32, 4096, 8, 40] on 132 SMs at 1980 MHz, against 0.70 ms of
// tensor-core work; for fastexp2 the cubic's FMA and integer instructions
// (chip_smoke.py's bound counts them from the SASS); for mxu_only and
// noexp the tensor cores. At D = 80 and 160 the tensor cores:
// 4 * B * H * Sq * Skv * D operations at 989 TFLOP/s (0.44 ms at
// [32, 2304, 8, 80]; 0.055 ms at [32, 576, 8, 160], where the bytes,
// 0.056 ms, weigh the same). At D = 256 the bytes: 0.090 ms at
// [32, 576, 8, 256] against 0.044 ms of tensor-core work.
//
// What the design does about it:
//  * One CTA per (b, h, 128 queries): a producer warpgroup, of which one
//    thread issues every TMA load, and two consumer warpgroups of 64 query
//    rows each. setmaxnreg moves registers from the producer (24) to the
//    consumers (240): 128 * 24 + 256 * 240 = 384 * 168, the launch's share.
//    Past D = 160 (the DP = 256 instance) one consumer warpgroup of 64
//    query rows: 256 threads, so the launch's share is 255 registers a
//    thread and no setmaxnreg is needed (see "Registers").
//  * K and V tiles (BN keys) stream through a ring of ST stages (2-4,
//    what fits in 227 KB), each with a full and an empty mbarrier, so
//    loads run ahead of the products. Q is loaded once.
//  * Both products run on wgmma.mma_async with fp32 accumulators in
//    registers. QK^T is SS (Q and K K-major in shared memory). PV is RS: the
//    score accumulators are re-packed in registers as bf16 A fragments (a
//    warp of the warpgroup owns 16 rows in the lane pattern of mma.sync,
//    so accumulator n8 blocks 2kk and 2kk + 1 form the A fragment of key
//    slice kk), and V is read from shared memory as an MN-major B operand
//    (the transpose bit). The S x S scores never reach shared or device
//    memory.
//  * The two consumer warpgroups take turns (two named barriers): in its
//    turn a warpgroup issues the PV product of its previous tile and the
//    QK^T product of its next one, then hands the tensor cores to the
//    other warpgroup while it runs its exponentials and row sums, so the
//    tensor cores and the special-function units work at once (at D = 40
//    the exponentials set the pace; PERF.md has how close it comes). The
//    one warpgroup of the DP = 256 instance takes no turns: it issues the
//    QK^T of tile j and the PV of tile j - 1 as two wgmma groups, runs tile
//    j's exponentials and row sums as soon as the first completes, and
//    rescales O and packs P once the second has (PERIOD forms: both
//    products, then the softmax, as in a turn).
//    PERIOD's max-only tiles take a turn of their own (their QK^T, with
//    the PV of a K+V tile if one waits); they hold no V, so their stage
//    is released as soon as their QK^T completes.
//  * TMA with one 4-D tensor map per operand, dims (D, H, S, B) with the
//    tensor's own strides, box (BE, 1, rows, 1): elements past D and rows
//    past S are zero-filled, which pads D in shared memory and fills the
//    ragged last tiles (and noexp's tiles wholly past Skv). The maps are
//    encoded on the host per call and passed as __grid_constant__
//    parameters; cuTensorMapEncodeTiled is found in the driver library
//    with dlsym, so nothing links -lcuda.
//  * The q fold runs in shared memory after Q's TMA load, one multiply per
//    element, which does not care about the swizzle, then
//    fence.proxy.async before any wgmma reads the tile. It is a runtime
//    flag: its branch sits before the key loop.
//  * The output is written from the accumulators with predicated 4-byte
//    stores (two adjacent columns of a row per lane): rows past Sq and
//    columns past D are never written.
//
// Shared-memory layouts (what was chosen at each head dim). wgmma reads
// K-major tiles in 32-, 64- or 128-byte swizzle atoms, and a TMA box's
// inner extent must fit the atom: BE = SW / 2 bf16 values, so a tile of
// DP columns is NB = DP / BE boxes, each [rows][BE], one TMA load each.
//   D <= 48:  DP = 48,  32-byte atoms (3 boxes; 40 pads to 48, and the
//             padding hides under the exponentials), BN = 128, 4 stages
//   D <= 80:  DP = 80,  32-byte atoms (5 boxes; 80 whole), BN = 128, 4
//   D <= 128: DP = 128, 128-byte atoms (2 boxes), BN = 64, 4
//   D <= 160: DP = 160, 64-byte atoms (5 boxes; 160 whole), BN = 64, 4
//   D <= 256: DP = 256, 128-byte atoms (4 boxes; 168..248 pad to 256),
//             BN = 64, 3 stages (Q 32 KB + 3 x 64 KB of K and V), one
//             consumer warpgroup
// 128-byte atoms (DP = 64) at D = 40 and 64-byte atoms (DP = 96) at
// D = 80 were tried on an H100 and were not faster.
// K-major descriptors (Q, K): rows SW bytes apart, stride byte offset
// 8 * SW between 8-row groups, the leading offset unused; a k16 step inside
// an atom advances the start address by 32 bytes, across atoms by one box.
// MN-major descriptor (V): stride byte offset 8 * SW between 8-key groups,
// leading byte offset BN * SW between boxes along D; a k16 step advances by
// 16 key rows. Every box starts 1024-byte aligned, so the base offset is 0.
//
// Registers: a consumer thread holds BN / 2 score accumulators, BN / 4
// packed bf16 A registers and DP / 2 output accumulators. ptxas allocates
// the consumer branch within the launch's 168 registers a thread, not the
// 240 that setmaxnreg makes room for, so BN = 128 spilled at DP = 128 and
// 160; BN = 64 there holds 32 + 16 + 80 without spills, and was faster.
// At DP = 256 that is 32 + 16 + 128 = 176 before addresses and row
// statistics, past 168: the instance has one consumer warpgroup, 256
// threads a CTA, whose launch bounds give ptxas up to 255 registers.
// PERIOD keeps only the current period's max (two floats), not one per
// period. -Xptxas -v reports each instance's registers and spills.

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float STATIC_OFF = 80.0f;
constexpr float L_FLOOR = 1.17549435e-38f;  // 2^-126
constexpr int SMEM_MAX = 232448;            // 227 KB a block may use

// the softmax forms (see the header); the kernels' names say which runs
enum Form { RUNMAX = 0, STATIC = 1, AUG = 2, MXU = 3, FAST = 4, NOEXP = 5 };

// Tile geometry of one instance: DP padded head dim, SW swizzle bytes, BN
// keys per tile; NC consumer warpgroups of 64 query rows each beside the
// producer: two up to DP = 160, one past it (see "Registers" above).
template <int DP_, int SW_, int BN_>
struct Cfg {
  static constexpr int DP = DP_;
  static constexpr int SW = SW_;
  static constexpr int BN = BN_;
  // DP <= 160: a producer warpgroup (its registers moved to the consumers
  // by setmaxnreg), then two consumer warpgroups. DP = 256: one consumer
  // warpgroup, then one producer warp, no setmaxnreg
  static constexpr bool WIDE = DP > 160;
  static constexpr int NC = WIDE ? 1 : 2;
  static constexpr int BQ = 64 * NC;          // queries per CTA
  static constexpr int THREADS = WIDE ? 160 : 384;
  static constexpr int BE = SW / 2;           // bf16 values per box row
  static constexpr int NB = DP / BE;          // boxes along D
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;   // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - Q_BYTES) / STAGE_BYTES;
  static constexpr int ST = FIT > 4 ? 4 : FIT;   // ring stages
  // 1024 bytes of slack to align the tiles, then the mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + ST * STAGE_BYTES + 256;
  static_assert(DP % BE == 0 && DP % 16 == 0, "DP must fill whole boxes");
  static_assert(ST >= 2, "two stages must fit");
};

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete. A wait that outlasts 2^34
// clocks (seconds; a tile takes microseconds) means a lost load or
// arrival: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from touching accumulators across an async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), base offset 0, layout type from the swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int sw) {
  const uint64_t mode = sw == 128 ? 1 : sw == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16 bf16 -> fp32: SS with both operands K-major (QK^T), RS with B
// MN-major (PV). N / 2 accumulators a thread.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ------------------------------------------------------------- kernel --

constexpr float NEG = -1e30f;  // vdx's NEG_INF: PERIOD's masked scores, m's start

// vdx's _fast_exp2 (the fastexp2 form): 2^y for y <= 0, clamped at -125,
// from the exponent bits of n = floor(y) times vdx's cubic in f = y - n,
// in vdx's Horner order as fused multiply-adds (the plain version rounds
// each product and sum; the two differ by about an fp32 ulp of p). n comes
// from a round-down add of 1.5 * 2^23, exact for |y| < 2^22, whose low
// bits are n itself: floorf and a float-to-int conversion would run on the
// conversion unit, 16 a clock per SM as ex2, and this runs on the FMA and
// integer pipes.
__device__ __forceinline__ float fast_exp2(float y) {
  constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
  y = fmaxf(y, -125.0f);
  const float t = __fadd_rd(y, MAGIC);  // MAGIC + n, bits 0x4B400000 + n
  const float f = __fsub_rn(y, __fsub_rn(t, MAGIC));
  const float p = fmaf(fmaf(fmaf(0.0780238760040786f, f, 0.22606693137993905f),
                            f, 0.6958342408899721f),
                       f, 0.9999250788416159f);
  // (0x4B400000 + n) << 23 is n << 23 mod 2^32
  return __uint_as_float((__float_as_uint(t) << 23) + (127u << 23)) * p;
}

// the exponential of the PERIOD forms: vdx's cubic or x + 1 (noexp)
template <int FORM>
__device__ __forceinline__ float period_exp(float x) {
  return FORM == FAST ? fast_exp2(x) : x + 1.0f;
}

// the max over a row's four lanes (a quad holds one row's columns)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int FORM, int DP, int SW, int BN>
struct Consumer {
  using C = Cfg<DP, SW, BN>;
  static constexpr int NS = BN / 2;    // score accumulators a thread
  static constexpr int NO = DP / 2;    // output accumulators a thread

  float S[NS];
  uint32_t P[BN / 16][4];
  float O[NO];
  float m0, m1, l0, l1;  // rows g and g + 8: running max (RUNMAX), sums
  float ra0, ra1;        // RUNMAX at DP = 256: the rescale of O, deferred
  float mx0, mx1;        // PERIOD: this lane's max over the period so far

  // S = Q_wg . K_tile^T
  __device__ __forceinline__ void issue_qk(uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int bx = kk * 16 / C::BE;
      const int in = kk * 16 % C::BE;
      const uint64_t da = make_desc(q_rows + bx * C::BQ * SW + in * 2, 16, 8 * SW, SW);
      const uint64_t db = make_desc(k_tile + bx * BN * SW + in * 2, 16, 8 * SW, SW);
      wgmma_ss<BN>(S, da, db, kk > 0);
    }
  }

  // O += r(P) . V_tile
  __device__ __forceinline__ void issue_pv(uint32_t v_tile) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DP>(O, P[kk], make_desc(v_tile + kk * 16 * SW, BN * SW, 8 * SW, SW));
  }

  // PERIOD's max sweep: this lane's row maxima over key tile k0's keys
  // below Skv
  __device__ __forceinline__ void tile_max(int k0, int Skv, int t) {
    const bool ragged = k0 + BN > Skv;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      if (ragged) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * i + 2 * t + (e & 1) >= Skv) S[4 * i + e] = NEG;
      }
      mx0 = fmaxf(mx0, fmaxf(S[4 * i], S[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(S[4 * i + 2], S[4 * i + 3]));
    }
  }

  // PERIOD at a period's first K+V tile: m' = max(m, the period's max),
  // alpha = e(m - m'), l and O rescaled once for the whole period
  __device__ __forceinline__ void period_start() {
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = period_exp<FORM>(m0 - mn0);  // l = O = 0 before period 0
    const float a1 = period_exp<FORM>(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    mx0 = mx1 = NEG;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      O[4 * i] *= a0;
      O[4 * i + 1] *= a0;
      O[4 * i + 2] *= a1;
      O[4 * i + 3] *= a1;
    }
  }

  // keep P's registers untouched until the PV product reading them is done
  __device__ __forceinline__ void fence_p() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(P[kk][i]) :: "memory");
  }

  // scores of key tile k0 -> p (packed into P), row statistics, O rescale
  __device__ __forceinline__ void softmax(int k0, int Skv, int t, float mult) {
    probs(k0, Skv, t, mult);
    rescale();
    pack();
  }

  // scores of key tile k0 -> p in S, row statistics, and RUNMAX's rescale
  // of O (DP = 256: deferred to rescale(), the tile's PV product still
  // running; probs then reads neither O nor P)
  __device__ __forceinline__ void probs(int k0, int Skv, int t, float mult) {
    const bool ragged = k0 + BN > Skv;
    if (FORM == STATIC || FORM == AUG) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(S[4 * i + e] - STATIC_OFF);
          if (ragged && k0 + 8 * i + 2 * t + (e & 1) >= Skv) p = 0.0f;
          S[4 * i + e] = p;
        }
        if (FORM == STATIC) {
          l0 += S[4 * i] + S[4 * i + 1];
          l1 += S[4 * i + 2] + S[4 * i + 3];
        }
      }
    } else if (FORM == RUNMAX) {
      const float ninf = __int_as_float(0xff800000);
      float mx0 = ninf, mx1 = ninf;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        if (ragged) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * i + 2 * t + (e & 1) >= Skv) S[4 * i + e] = ninf;
        }
        mx0 = fmaxf(mx0, fmaxf(S[4 * i], S[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(S[4 * i + 2], S[4 * i + 3]));
      }
      // the four lanes of a quad hold one row's columns
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // mult > 0: max(s) * mult is max(s * mult) exactly
      const float mn0 = fmaxf(m0, mx0 * mult);
      const float mn1 = fmaxf(m1, mx1 * mult);
      const float a0 = exp2f(m0 - mn0);  // 0 on the first tile
      const float a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        S[4 * i] = exp2f(fmaf(S[4 * i], mult, -mn0));
        S[4 * i + 1] = exp2f(fmaf(S[4 * i + 1], mult, -mn0));
        S[4 * i + 2] = exp2f(fmaf(S[4 * i + 2], mult, -mn1));
        S[4 * i + 3] = exp2f(fmaf(S[4 * i + 3], mult, -mn1));
        ps0 += S[4 * i] + S[4 * i + 1];
        ps1 += S[4 * i + 2] + S[4 * i + 3];
      }
      l0 = a0 * l0 + ps0;
      l1 = a1 * l1 + ps1;
      if constexpr (C::WIDE) {
        ra0 = a0;
        ra1 = a1;
      } else {
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        O[4 * i] *= a0;
        O[4 * i + 1] *= a0;
        O[4 * i + 2] *= a1;
        O[4 * i + 3] *= a1;
      }
      }
    } else if (FORM == FAST || FORM == NOEXP) {
      // m and the rescale were set at the period's start; keys past Skv
      // score -1e30 (noexp's padded keys enter l, as in vdx)
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = S[4 * i + e];
          if (ragged && k0 + 8 * i + 2 * t + (e & 1) >= Skv) s = NEG;
          S[4 * i + e] = period_exp<FORM>(s - (e < 2 ? m0 : m1));
        }
        ps0 += S[4 * i] + S[4 * i + 1];
        ps1 += S[4 * i + 2] + S[4 * i + 3];
      }
      l0 += ps0;
      l1 += ps1;
    }
    // (MXU: p = s. Keys past Skv have zero k and v rows, as in vdx's zero
    // padding, so they add nothing.)
  }

  // RUNMAX at DP = 256: O *= a, the tile's rescale, once O is no
  // product's accumulator; skipped when no row of the warp has a new max
  // (a = 1 exactly)
  __device__ __forceinline__ void rescale() {
    if constexpr (FORM == RUNMAX && C::WIDE) {
      if (!__any_sync(0xffffffffu, ra0 != 1.0f || ra1 != 1.0f)) return;
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        O[4 * i] *= ra0;
        O[4 * i + 1] *= ra0;
        O[4 * i + 2] *= ra1;
        O[4 * i + 3] *= ra1;
      }
    }
  }

  // p -> P (bf16 A fragments), once P is no product's operand; AUG: l
  __device__ __forceinline__ void pack() {
    // accumulator n8 blocks 2kk, 2kk + 1 -> the A fragment of key slice kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      P[kk][0] = pack_bf16(S[8 * kk], S[8 * kk + 1]);
      P[kk][1] = pack_bf16(S[8 * kk + 2], S[8 * kk + 3]);
      P[kk][2] = pack_bf16(S[8 * kk + 4], S[8 * kk + 5]);
      P[kk][3] = pack_bf16(S[8 * kk + 6], S[8 * kk + 7]);
    }
    if (FORM == AUG) {
      // l from the rounded p: the bf16 halves of the packed fragments
      // (registers 0 and 2 hold row g, 1 and 3 row g + 8)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        l0 += (__uint_as_float(P[kk][0] << 16) + __uint_as_float(P[kk][0] & 0xffff0000u)) +
              (__uint_as_float(P[kk][2] << 16) + __uint_as_float(P[kk][2] & 0xffff0000u));
        l1 += (__uint_as_float(P[kk][1] << 16) + __uint_as_float(P[kk][1] & 0xffff0000u)) +
              (__uint_as_float(P[kk][3] << 16) + __uint_as_float(P[kk][3] & 0xffff0000u));
      }
    }
  }
};

// One CTA's work in form FORM. fold: q' = r(float(q) * mult) in shared
// memory and scores taken as they come (every form but RUNMAX's K4 and
// exp instance, which scale the fp32 scores by mult). period: PERIOD's
// statistics period in keys, a multiple of 128 (unused by the others).
template <int FORM, int DP, int SW, int BN>
__device__ __forceinline__ void flash_sm90_body(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    bf16* __restrict__ o, int Sq, int Skv, int D, long long osb,
    long long oss, long long osh, float mult, bool fold, int period) {
  using C = Cfg<DP, SW, BN>;
  constexpr bool PERIOD = FORM == FAST || FORM == NOEXP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sKV = base + C::Q_BYTES;  // stage s: K at + s * STAGE_BYTES
  const uint32_t bars = sKV + C::ST * C::STAGE_BYTES;
  const uint32_t qbar = bars;
  const uint32_t full0 = bars + 8;
  const uint32_t empty0 = bars + 8 + 8 * C::ST;

  // noexp runs over vdx's padded key count, a multiple of the period
  const int kv_end = FORM == NOEXP ? (Skv + period - 1) / period * period : Skv;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x >> 7;
  // the thread that issues every TMA load
  const int loader = C::WIDE ? 128 * C::NC : 0;

  if (threadIdx.x == loader) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C::NC);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (C::WIDE ? threadIdx.x >= loader : wg == 0) {
    // ---- producer: one thread keeps the K/V ring full ----
    if constexpr (!C::WIDE) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == loader) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int bx = 0; bx < C::NB; ++bx)
        tma_load(sQ + bx * C::BQ * SW, &qmap, qbar, bx * C::BE, h, q0, b);
      if constexpr (PERIOD) {
        // per period: its K tiles alone (the max sweep), then K and V
        const int tpp = period / BN;  // key tiles a period
        int j = 0;
        for (int p0 = 0; p0 < n_tiles; p0 += tpp) {
          const int pe = min(p0 + tpp, n_tiles);
          for (int pass = 0; pass < 2; ++pass) {
            for (int tile = p0; tile < pe; ++tile, ++j) {
              const int s = j % C::ST;
              const int r = j / C::ST;
              if (r > 0) mbar_wait(empty0 + 8 * s, (r - 1) & 1);
              const uint32_t full = full0 + 8 * s;
              const uint32_t kt = sKV + s * C::STAGE_BYTES;
              mbar_expect_tx(full, pass ? C::STAGE_BYTES : C::KV_BYTES);
#pragma unroll
              for (int bx = 0; bx < C::NB; ++bx) {
                tma_load(kt + bx * BN * SW, &kmap, full, bx * C::BE, h, tile * BN, b);
                if (pass)
                  tma_load(kt + C::KV_BYTES + bx * BN * SW, &vmap, full, bx * C::BE,
                           h, tile * BN, b);
              }
            }
          }
        }
      } else {
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % C::ST;
          const int r = j / C::ST;
          if (r > 0) mbar_wait(empty0 + 8 * s, (r - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t kt = sKV + s * C::STAGE_BYTES;
          mbar_expect_tx(full, C::STAGE_BYTES);
#pragma unroll
          for (int bx = 0; bx < C::NB; ++bx) {
            tma_load(kt + bx * BN * SW, &kmap, full, bx * C::BE, h, j * BN, b);
            tma_load(kt + C::KV_BYTES + bx * BN * SW, &vmap, full, bx * C::BE, h,
                     j * BN, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows 64c .. 64c + 63 ----
    if constexpr (!C::WIDE) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = C::WIDE ? wg : wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t q_rows = sQ + 64 * c * SW;
    const int bar_me = 1 + c;    // named barriers 1, 2: the turns
    const int bar_other = 2 - c;

    mbar_wait(qbar, 0);
    if (fold) {
      // q' = r(float(q) * mult) in place, elementwise (swizzle-agnostic),
      // then make the generic-proxy writes visible to wgmma
#pragma unroll
      for (int bx = 0; bx < C::NB; ++bx) {
        uint4* p = reinterpret_cast<uint4*>(gbase + bx * C::BQ * SW + 64 * c * SW);
        for (int i = tid; i < 64 * SW / 16; i += 128) {
          uint4 v = p[i];
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            e[k] = __float2bfloat16_rn(__bfloat162float(e[k]) * mult);
          p[i] = v;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(3 + c, 128);
    }
    const float smult = fold ? 1.0f : mult;  // on the fp32 scores (RUNMAX)

    Consumer<FORM, DP, SW, BN> st;
#pragma unroll
    for (int i = 0; i < Consumer<FORM, DP, SW, BN>::NO; ++i) st.O[i] = 0.0f;
    st.m0 = st.m1 = PERIOD ? NEG : __int_as_float(0xff800000);
    st.mx0 = st.mx1 = NEG;
    st.l0 = st.l1 = 0.0f;

    // warpgroup 0 takes the first turn (one warpgroup takes no turns)
    if (C::NC == 2 && c == 1) bar_arrive(1, 256);

    int sl;  // the stage of the last tile, whose PV is still to run
    if constexpr (PERIOD) {
      // the producer's order: per period its K tiles (max only), then its
      // K+V tiles. A turn issues the QK^T of the next tile and the PV of
      // the last K+V tile if one waits; a period's PV products are done
      // before its successor's first K+V tile rescales O.
      const int tpp = period / BN;
      int j = 0;
      int sp = -1;  // the stage whose PV is pending, -1: none
      for (int p0 = 0; p0 < n_tiles; p0 += tpp) {
        const int pe = min(p0 + tpp, n_tiles);
        for (int pass = 0; pass < 2; ++pass) {
          for (int tile = p0; tile < pe; ++tile, ++j) {
            const int s = j % C::ST;
            mbar_wait(full0 + 8 * s, (j / C::ST) & 1);
            if constexpr (C::NC == 2) bar_sync(bar_me, 256);
            wg_fence();
            st.issue_qk(q_rows, sKV + s * C::STAGE_BYTES);
            if (sp >= 0) st.issue_pv(sKV + sp * C::STAGE_BYTES + C::KV_BYTES);
            wg_commit();
            if constexpr (C::NC == 2) bar_arrive(bar_other, 256);
            wg_wait0();
            fence_regs(st.S);
            if (sp >= 0) {
              fence_regs(st.O);
              if (lane == 0) mbar_arrive(empty0 + 8 * sp);
            }
            if (pass == 0) {
              if (lane == 0) mbar_arrive(empty0 + 8 * s);  // K alone: done
              st.tile_max(tile * BN, Skv, t);
              sp = -1;
            } else {
              if (tile == p0) st.period_start();
              st.softmax(tile * BN, Skv, t, smult);
              sp = s;
            }
          }
        }
      }
      sl = sp;
    } else if constexpr (C::NC == 1) {
      // one warpgroup: the PV product of tile j - 1 runs on the tensor
      // cores while the exponentials of tile j run; O's rescale and the
      // packing of P wait for it
      mbar_wait(full0, 0);
      wg_fence();
      st.issue_qk(q_rows, sKV);
      wg_commit();
      wg_wait0();
      fence_regs(st.S);
      st.softmax(0, Skv, t, smult);
      for (int j = 1; j < n_tiles; ++j) {
        const int s = j % C::ST;
        const int sp = (j - 1) % C::ST;
        mbar_wait(full0 + 8 * s, (j / C::ST) & 1);
        wg_fence();
        st.issue_qk(q_rows, sKV + s * C::STAGE_BYTES);
        wg_commit();
        st.issue_pv(sKV + sp * C::STAGE_BYTES + C::KV_BYTES);
        wg_commit();
        wg_wait1();  // the QK^T product, committed first, is done
        fence_regs(st.S);
        st.probs(j * BN, Skv, t, smult);
        wg_wait0();
        fence_regs(st.O);
        st.fence_p();
        if (lane == 0) mbar_arrive(empty0 + 8 * sp);
        st.rescale();
        st.pack();
      }
      sl = (n_tiles - 1) % C::ST;
    } else {
      // tile 0: QK^T alone
      mbar_wait(full0, 0);
      bar_sync(bar_me, 256);
      wg_fence();
      st.issue_qk(q_rows, sKV);
      wg_commit();
      bar_arrive(bar_other, 256);
      wg_wait0();
      fence_regs(st.S);
      st.softmax(0, Skv, t, smult);

      for (int j = 1; j < n_tiles; ++j) {
        const int s = j % C::ST;
        const int sp = (j - 1) % C::ST;
        mbar_wait(full0 + 8 * s, (j / C::ST) & 1);
        bar_sync(bar_me, 256);
        wg_fence();
        st.issue_qk(q_rows, sKV + s * C::STAGE_BYTES);
        st.issue_pv(sKV + sp * C::STAGE_BYTES + C::KV_BYTES);
        wg_commit();
        bar_arrive(bar_other, 256);
        wg_wait0();
        fence_regs(st.S);
        fence_regs(st.O);
        if (lane == 0) mbar_arrive(empty0 + 8 * sp);
        st.softmax(j * BN, Skv, t, smult);
      }
      sl = (n_tiles - 1) % C::ST;
    }

    // the last tile's PV
    if constexpr (C::NC == 2) bar_sync(bar_me, 256);
    wg_fence();
    st.issue_pv(sKV + sl * C::STAGE_BYTES + C::KV_BYTES);
    wg_commit();
    if constexpr (C::NC == 2) bar_arrive(bar_other, 256);
    wg_wait0();
    fence_regs(st.O);
    // takes warpgroup 1's last hand-over
    if (C::NC == 2 && c == 0) bar_sync(1, 256);

    // out = r(acc / l) (MXU: r(acc)); l's four partial sums per row live
    // in a quad
    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (FORM == STATIC || FORM == AUG) {
      l0 = fmaxf(l0, L_FLOOR);
      l1 = fmaxf(l1, L_FLOOR);
    }
    const int r0 = q0 + 64 * c + 16 * warp + g;
    const int r1 = r0 + 8;
    bf16* ob = o + b * osb + h * osh;
    if constexpr (C::WIDE) {
      // through shared memory: the Q tile is free once the last QK^T is
      // done. Rows of DP * 2 = 512 bytes whose 16-byte chunks are XOR-
      // swizzled by row % 8 (the fragment writes meet no bank conflict),
      // then each warp writes its 16 rows out in 16-byte stores, a whole
      // row per instruction
      // out = r(acc * (1 / l)): one division a row, not 128 a thread (an
      // fp32 rounding of the quotient apart from acc / l; MXU: r(acc))
      const float i0 = FORM == MXU ? 1.0f : 1.0f / l0;
      const float i1 = FORM == MXU ? 1.0f : 1.0f / l1;
      unsigned char* ot = gbase + (16 * warp) * (DP * 2);
      // (generic writes after the async proxy's reads of the tile)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const uint32_t w0 = pack_bf16(st.O[4 * i] * i0, st.O[4 * i + 1] * i0);
        const uint32_t w1 = pack_bf16(st.O[4 * i + 2] * i1, st.O[4 * i + 3] * i1);
        *reinterpret_cast<uint32_t*>(ot + g * (DP * 2) + ((i ^ g) << 4) + 4 * t) = w0;
        *reinterpret_cast<uint32_t*>(ot + (g + 8) * (DP * 2) + ((i ^ g) << 4) + 4 * t) = w1;
      }
      __syncwarp();
      static_assert(DP / 8 == 32, "one 16-byte chunk of a row per lane");
      for (int rr = 0; rr < 16; ++rr) {
        const int row = q0 + 16 * warp + rr;
        if (row < Sq && 8 * lane < D)
          *reinterpret_cast<uint4*>(ob + row * oss + 8 * lane) =
              *reinterpret_cast<const uint4*>(ot + rr * (DP * 2) + ((lane ^ (rr & 7)) << 4));
      }
    } else {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < D) {
        if (FORM == MXU) {
          if (r0 < Sq)
            *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
                pack_bf16(st.O[4 * i], st.O[4 * i + 1]);
          if (r1 < Sq)
            *reinterpret_cast<uint32_t*>(ob + r1 * oss + col) =
                pack_bf16(st.O[4 * i + 2], st.O[4 * i + 3]);
        } else {
          if (r0 < Sq)
            *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
                pack_bf16(st.O[4 * i] / l0, st.O[4 * i + 1] / l0);
          if (r1 < Sq)
            *reinterpret_cast<uint32_t*>(ob + r1 * oss + col) =
                pack_bf16(st.O[4 * i + 2] / l1, st.O[4 * i + 3] / l1);
        }
      }
    }
    }
  }
}

// ---------------------------------------------------------------- host --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled (in the libcuda that the runtime
// already loaded), looked up once
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// [B, S, H, D] bf16 at `p` with element strides (sb, ss, sh) as dims
// (D, H, S, B), box (box_e, 1, rows, 1), zero fill out of bounds. A size-1
// dim's stride is never used; it gets a packed one so any view encodes.
bool encode(CUtensorMap* map, const void* p, int B, int S, int H, int D,
            long long sb, long long ss, long long sh, int box_e, int rows,
            int sw) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  if (H == 1) sh = D;
  if (S == 1) ss = sh * H;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_e, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, k and v's tensor maps for an instance's tiles (q: BQ rows a box, k
// and v: BN); false when the encoder is missing or refuses a map
template <int DP, int SW, int BN>
bool encode_qkv(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm,
                const void* q, const void* k, const void* v, int B, int Sq,
                int Skv, int H, int D, const long long* st) {
  constexpr int BE = Cfg<DP, SW, BN>::BE;
  constexpr int BQ = Cfg<DP, SW, BN>::BQ;
  return encode(qm, q, B, Sq, H, D, st[0], st[1], st[2], BE, BQ, SW) &&
         encode(km, k, B, Skv, H, D, st[3], st[4], st[5], BE, BN, SW) &&
         encode(vm, v, B, Skv, H, D, st[6], st[7], st[8], BE, BN, SW);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// what every entry point takes: D % 8 == 0, 8 <= D <= 256, 16-byte
// aligned q/k/v bases and strides in multiples of 8 elements, 4-byte
// aligned o with even strides (past D = 160, whose rows leave in 16-byte
// stores, 16-byte aligned with strides in multiples of 8); strides in
// elements (b, s, h) for q, k, v, o
bool operands_ok(const void* q, const void* k, const void* v, const void* o,
                 int B, int Sq, int Skv, int H, int D, const long long* st) {
  bool ok = D % 8 == 0 && D >= 8 && D <= 256 && Sq >= 1 && Skv >= 1 &&
            H <= 65535 && B <= 65535 && aligned16(q) && aligned16(k) &&
            aligned16(v) && (reinterpret_cast<uintptr_t>(o) & 3) == 0;
  for (int i = 0; i < 9; ++i) ok = ok && st[i] % 8 == 0;
  for (int i = 9; i < 12; ++i) ok = ok && st[i] % (D > 160 ? 8 : 2) == 0;
  return ok && (D <= 160 || aligned16(o));
}

// One launch of the kernel Pick<FORM, DP, SW, BN>::kernel() (each source
// names its own kernels by form and instance): q, k and v's tensor maps,
// then one CTA per (BQ queries, h, b). `extra` are the kernel's
// arguments after mult.
template <template <int, int, int, int> class Pick, int FORM, int DP, int SW,
          int BN, typename... Extra>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int D, const long long* st,
                   float mult, cudaStream_t stream, Extra... extra) {
  CUtensorMap qm, km, vm;
  if (!encode_qkv<DP, SW, BN>(&qm, &km, &vm, q, k, v, B, Sq, Skv, H, D, st))
    return cudaErrorInvalidValue;
  using C = Cfg<DP, SW, BN>;
  auto kern = Pick<FORM, DP, SW, BN>::kernel();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), Sq, Skv, D, st[9], st[10], st[11],
      mult, extra...);
  return cudaGetLastError();
}

// The instance of every form at head dim D (the layouts above): the one
// place DP, SW and BN are chosen.
template <template <int, int, int, int> class Pick, int FORM,
          typename... Extra>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int H, int D, const long long* st,
                     float mult, cudaStream_t s, Extra... extra) {
  if (D <= 48)
    return launch<Pick, FORM, 48, 32, 128>(q, k, v, o, B, Sq, Skv, H, D, st,
                                           mult, s, extra...);
  if (D <= 80)
    return launch<Pick, FORM, 80, 32, 128>(q, k, v, o, B, Sq, Skv, H, D, st,
                                           mult, s, extra...);
  if (D <= 128)
    return launch<Pick, FORM, 128, 128, 64>(q, k, v, o, B, Sq, Skv, H, D, st,
                                            mult, s, extra...);
  if (D <= 160)
    return launch<Pick, FORM, 160, 64, 64>(q, k, v, o, B, Sq, Skv, H, D, st,
                                           mult, s, extra...);
  return launch<Pick, FORM, 256, 128, 64>(q, k, v, o, B, Sq, Skv, H, D, st,
                                          mult, s, extra...);
}

}  // namespace
