// Blocked online-softmax attention for Hopper (kernel K4).
//
// Replaces ml_mdm_tpu/ops/attention.py::flash_attention (the Pallas kernel
// inside it): for q (B, Lq, H, D) and k, v (B, Lk, H, D), per batch row and
// head,
//
//   out = softmax((q * d^-1/4) (k * d^-1/4)^T) v
//
// without ever storing the (Lq, Lk) logits: a running maximum m, a running
// sum l and an f32 accumulator per query row over tiles of keys, acc / l at
// the end. No mask, no dropout, no causal form, as in the JAX kernel.
//
// What bounds it on the H100: operations at the model's long sequences (at
// L = 1024, D = 64 it does 4*L*L*D FLOPs per head against 8*L*D bytes: 512
// operations a byte, above the card's ~295), bytes at the short ones (L = 256:
// 128 operations a byte). Inside the kernel the exponentials weigh about as
// much as the products: at D = 64 a tile of 64 queries x 128 keys is 512
// tensor-core cycles of products and 8192 exponentials on SFUs that take 16
// a cycle an SM. So the design keeps the tensor cores fed while the other
// warps take the softmax:
//
//   - persistent: one block an SM walks work items (batch row, head, tile of
//     BM = 128 queries), the query tile fastest so that the blocks at work
//     share heads in L2; two consumer warpgroups of 64 query rows each;
//   - one producer warpgroup (24 registers a thread after setmaxnreg, the
//     consumers take 240) of which one thread issues TMA loads: Q into two
//     buffers (the next item's Q lands while this one's is in use), K and V
//     tiles of BN keys (128, or 64 above D = 96) into a ring of STAGES = 3
//     shared-memory stages, running on into the next item while the
//     consumers finish this one; each load completes on its own mbarrier,
//     each buffer is handed back by an mbarrier the two consumers arrive on;
//   - both products on wgmma.mma_async: S = Q K^T as m64 nBN k16 with Q and
//     K read from shared memory in the canonical K-major swizzled layout the
//     TMA writes; O += P V as m64 nD k16 with P as the A operand from
//     registers (S's f32 accumulator becomes bf16 A fragments in place) and
//     V in its natural (keys x D) layout, read through the B operand's
//     transpose bit (MN-major);
//   - the consumers take turns at the tensor cores (two named barriers): a
//     turn issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} together, then the
//     softmax of S_j runs while the tensor cores finish the second product
//     and take the other warpgroup's turn;
//   - a tile's D columns are swizzled regions of CW = 64, 32 or 16 columns
//     (128-, 64- or 32-byte swizzle, the widest that divides D: D = 96 is
//     three 64-byte regions, since 192-byte rows fit no 128-byte TMA box);
//   - q, k, v are addressed by their (batch, position, head) strides in the
//     model's own (B, L, H, D) layout through 4-D tensor maps (the chunks of
//     one (B, L, 3C) tensor go in as they are); TMA zero-fills rows past L,
//     keys past Lk get S = -inf (every key tile holds at least one real key,
//     so no row's maximum stays at -inf), query rows past Lq are not stored;
//   - S and the softmax state in f32 registers, one scale d^-1/2 * log2(e)
//     folded into the exponent's argument, P rounded to bf16 only as the A
//     operand of the second product, the output rounded once to bf16.
//
// D is a template parameter: any multiple of 16 up to 128. The tensor maps
// are encoded on the host with cuTensorMapEncodeTiled, looked up in libcuda
// through cudaGetDriverEntryPoint so that the library links only cudart.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is called through a pointer
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int STAGES = 3;   // K and V tiles in flight
constexpr int WG = 128;     // threads of a warpgroup

template <int D>
struct Tile {
  static constexpr int CW = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;  // columns a region
  static constexpr int SW = 2 * CW;             // bytes a region row: the swizzle span
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // descriptor layout
  // keys a tile: 128, or 64 above D = 96, where S, P and O would not fit the
  // consumers' registers and three stages not the shared memory
  static constexpr int BN = D <= 96 ? 128 : 64;
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "D: a multiple of 16 up to 128");
};

constexpr int NWG = 2;                  // consumer warpgroups
constexpr int BM = 64 * NWG;            // queries a block
constexpr int THREADS = WG * (NWG + 1); // the consumers, then the producer
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;      // 2 x 128 x 240 + 128 x 24 <= 65536

struct Params {
  __nv_bfloat16* o;  // (B, Lq, H, D) contiguous
  int B, Lq, Lk, H, n_q_tiles;
  float scale_log2;  // d^-1/2 * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of the given parity has completed. A wait of more
// than ~10^10 cycles (5 s) traps: a lost arrival fails the launch instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 10000000000LL) __trap();
}

// -- TMA -----------------------------------------------------------------------

// one box of the 4-D map (D, H, L, B) at element coordinates (c0, c1, c2, c3)
// into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// -- named barriers: the two consumers take turns at the tensor cores ---------

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units) and the swizzle layout. K-major swizzled
// operands ignore the leading offset; MN-major ones step by it from one
// region of CW columns to the next.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of the committed groups are pending, the older ones done
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product (before wgmma_fence and after wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

// d (+)= A B^T for one k-step of 16: A (64 x 16) and B (N x 16) read from
// shared memory through their descriptors, both K-major; scale_d = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B for one k-step of 16: A (64 x 16) from registers (the layout of
// an m64 accumulator pair, packed to bf16), B (16 x N) from shared memory
// through its descriptor, MN-major (the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the SFU (one MUFU.EX2; exp2f adds range handling around it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- a consumer warpgroup's steps ---------------------------------------------------
//
// The accumulators of an m64 product: entry 4 i + r of a thread holds row
// lane/4 + 8 (r / 2) of its warp's 16 and column 8 i + 2 (lane % 4) + r % 2.

// S = Q K^T over one tile of BN keys (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::BN / 2], uint32_t qa, uint32_t ka) {
  using T = Tile<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 / T::CW, off = (ks * 16 % T::CW) * 2;
    wgmma_ss<T::BN>(sc, make_desc(qa + c * BM * T::SW + off, 16, 8 * T::SW, T::LAYOUT),
                    make_desc(ka + c * T::BN * T::SW + off, 16, 8 * T::SW, T::LAYOUT), ks > 0);
  }
}

// O += P V over one tile of BN keys (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[Tile<D>::BN / 16][4], uint32_t va) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < T::BN / 16; ++kk)
    wgmma_rs<D>(o, pa[kk],
                make_desc(va + kk * 16 * T::SW, T::BN * T::SW, 8 * T::SW, T::LAYOUT));
}

// The online softmax of one tile: the keys past Lk out, new row maxima (in
// log2 units), sc <- exp2(sc scale - m) in place, the row sums rescaled and
// grown; returns each row's factor for O. Maxima and sums run as four
// independent chains a row (entry i's chain is i / 4 % 4), so that their
// latency does not serialise the tile: l_run keeps the four partial sums
// of rows lane/4 and lane/4 + 8 until the end.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m_run)[2],
                                             float (&l_run)[2][4], float (&corr)[2], int key0,
                                             const Params& p, int quad) {
  const int valid = p.Lk - key0;  // keys of the tile that exist
  if (valid < BN) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      if ((i / 4) * 8 + 2 * quad + (i & 1) >= valid) sc[i] = -INFINITY;
  }
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[h][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[h], m * p.scale_log2);  // finite: a real key
    corr[h] = ex2(m_run[h] - m_new);                        // 0 on the first tile
    m_run[h] = m_new;
#pragma unroll
    for (int c = 0; c < 4; ++c) l_run[h][c] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = ex2(fmaf(sc[i], p.scale_log2, -m_run[h]));
    l_run[h][(i >> 2) & 3] += sc[i];
  }
}

// P as bf16 A fragments: keys 16 kk .. 16 kk + 15 are entries 8 kk .. 8 kk + 7
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// -- the kernel ----------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const Params p) {
  using T = Tile<D>;
  constexpr int BN = T::BN;
  constexpr int Q_BYTES = BM * D * 2;
  constexpr int KV_BYTES = BN * D * 2;  // one K or V tile

  // the swizzled regions want 1024-byte alignment; the launch adds the slack
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = sQ + 2 * Q_BYTES;           // Q: two buffers; K, V: rings of STAGES
  const uint32_t sV = sK + STAGES * KV_BYTES;
  const uint32_t bars = sV + STAGES * KV_BYTES;
  auto q_full = [&](int b) { return bars + 8 * b; };
  auto q_empty = [&](int b) { return bars + 8 * (2 + b); };
  auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + 2 * STAGES + s); };

  // work items (batch row, head, tile of BM queries), the query tile
  // fastest so that the blocks at work share heads in L2; block b takes
  // items b, b + gridDim.x, ...
  const int n_items = p.n_q_tiles * p.B * p.H;
  const int n_kt = (p.Lk + BN - 1) / BN;
  // warp-uniform as the compiler sees it, so that each role's branch keeps
  // its own register budget (setmaxnreg)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), NWG);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // -- producer: one thread keeps Q's two buffers and the K/V ring full,
    //    running ahead into the next item while the consumers finish this one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NWG * WG) {
      int g = 0;  // K/V tiles so far
      for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
        const int qt = item % p.n_q_tiles, bh = item / p.n_q_tiles;
        const int head = bh % p.H, batch = bh / p.H;
        const int qb = k & 1;
        mbar_wait(q_empty(qb), ((k >> 1) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(q_full(qb), Q_BYTES);
        for (int c = 0; c < D / T::CW; ++c)
          tma_load_4d(sQ + qb * Q_BYTES + c * BM * T::SW, &qmap, q_full(qb), c * T::CW, head,
                      qt * BM, batch);
        for (int j = 0; j < n_kt; ++j, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty(s), ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full(s), KV_BYTES);
          for (int c = 0; c < D / T::CW; ++c)
            tma_load_4d(sK + s * KV_BYTES + c * BN * T::SW, &kmap, k_full(s), c * T::CW, head,
                        j * BN, batch);
          mbar_expect_tx(v_full(s), KV_BYTES);
          for (int c = 0; c < D / T::CW; ++c)
            tma_load_4d(sV + s * KV_BYTES + c * BN * T::SW, &vmap, v_full(s), c * T::CW, head,
                        j * BN, batch);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows a warpgroup -------------------------------------
    // Each issues its products in turns with the other (named barriers 1 and
    // 2: a warpgroup waits on its own and arrives on the other's), so that
    // one's products run while the other takes its softmax. A turn issues
    // S_j = Q K_j^T and O += P_{j-1} V_{j-1} together; the softmax of S_j
    // then runs while the tensor cores do the second.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % WG;
    const int warp = t / 32, lane = t % 32;
    const int quad = lane % 4;
    auto my_turn = [&]() { named_sync(1 + wg, 2 * WG); };
    auto your_turn = [&]() { named_arrive(2 - wg, 2 * WG); };
    if (wg == 1) your_turn();  // the first turn is warpgroup 0's

    int g = 0;  // K/V tiles so far
    for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k, g += n_kt) {
      const int qt = item % p.n_q_tiles, bh = item / p.n_q_tiles;
      const int head = bh % p.H, batch = bh / p.H;
      const int qb = k & 1;
      const uint32_t qa = sQ + qb * Q_BYTES + wg * 64 * T::SW;  // this warpgroup's rows

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8, log2 units
      float l_run[2][4] = {};                    // partial row sums, see softmax_tile
      float sc[BN / 2], corr[2];
      uint32_t pa[BN / 16][4];

      mbar_wait(q_full(qb), (k >> 1) & 1);
      const int s0 = g % STAGES;
      mbar_wait(k_full(s0), (g / STAGES) & 1);
      my_turn();
      wgmma_fence();
      issue_qk<D>(sc, qa, sK + s0 * KV_BYTES);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<BN>(sc, m_run, l_run, corr, 0, p, quad);
      pack_p<BN>(pa, sc);

      for (int j = 1; j < n_kt; ++j) {
        const int s = (g + j) % STAGES, sp = (g + j - 1) % STAGES;
        mbar_wait(k_full(s), ((g + j) / STAGES) & 1);
        mbar_wait(v_full(sp), ((g + j - 1) / STAGES) & 1);
        fence_regs(o);
        fence_regs(pa);
        my_turn();
        wgmma_fence();
        issue_qk<D>(sc, qa, sK + s * KV_BYTES);
        wgmma_commit();
        issue_pv<D>(o, pa, sV + sp * KV_BYTES);
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();  // S_j
        fence_regs(sc);
        softmax_tile<BN>(sc, m_run, l_run, corr, j * BN, p, quad);
        wgmma_wait<0>();  // P_{j-1} V_{j-1}
        fence_regs(o);
        fence_regs(pa);
        if (t == 0) mbar_arrive(empty(sp));  // this warpgroup is done with stage sp
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        pack_p<BN>(pa, sc);
      }
      const int sl = (g + n_kt - 1) % STAGES;
      mbar_wait(v_full(sl), ((g + n_kt - 1) / STAGES) & 1);
      fence_regs(o);
      fence_regs(pa);
      my_turn();
      wgmma_fence();
      issue_pv<D>(o, pa, sV + sl * KV_BYTES);
      wgmma_commit();
      // warpgroup 1 takes the block's last turn: nobody waits after it
      if (wg == 0 || item + (int)gridDim.x < n_items) your_turn();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (t == 0) {
        mbar_arrive(empty(sl));
        mbar_arrive(q_empty(qb));
      }

      // out = O / l, rounded once to bf16, rows past Lq dropped
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = (l_run[h][0] + l_run[h][1]) + (l_run[h][2] + l_run[h][3]);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / l;
        const int row = qt * BM + wg * 64 + warp * 16 + h * 8 + lane / 4;
        if (row >= p.Lq) continue;
        __nv_bfloat16* orow =
            p.o + (((long long)batch * p.Lq + row) * p.H + head) * D + 2 * quad;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
              __floats2bfloat162_rn(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
      }
    }
  }
}

// -- host side -------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiledFn)ptr
                                                                      : nullptr;
  }();
  return fn;
}

// The 4-D map (D, H, L, B) of one operand, boxes of CW columns x `rows`
// positions of one (head, batch row); strides in elements. A unit
// dimension's stride is never stepped, so it is given a valid one.
template <int D>
bool encode(CUtensorMap* map, const void* base, int B, int L, int H, long long sb, long long sl,
            long long sh, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  if (H == 1) sh = 8;
  if (L == 1) sl = 8;
  if (B == 1) sb = 8;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<D>::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = Tile<D>::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Tile<D>::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Operands {
  const void *q, *k, *v;
  int B, Lq, Lk, H;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
};

template <int D>
int launch(const Operands& a, const Params& p, cudaStream_t stream) {
  constexpr int BN = Tile<D>::BN;
  constexpr size_t smem =
      1024 + (size_t)(2 * BM + 2 * STAGES * BN) * D * 2 + 8 * (4 + 3 * STAGES);
  static_assert(smem <= 232448, "more shared memory than a block can have");
  // the shared-memory limit, once per template instance and device
  static std::atomic<unsigned long long> configured{0};
  static std::atomic<int> sms[64];  // SMs of each device, 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n);
    configured.fetch_or(bit);
  }
  CUtensorMap qm, km, vm;
  if (!encode<D>(&qm, a.q, a.B, a.Lq, a.H, a.q_sb, a.q_sl, a.q_sh, BM) ||
      !encode<D>(&km, a.k, a.B, a.Lk, a.H, a.k_sb, a.k_sl, a.k_sh, BN) ||
      !encode<D>(&vm, a.v, a.B, a.Lk, a.H, a.v_sb, a.v_sl, a.v_sh, BN))
    return -1;  // the tensor maps could not be encoded
  // persistent: one block an SM, each walking its share of the work items
  const long long items = (long long)p.n_q_tiles * a.B * a.H;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(items < sms[dev & 63].load() ? items : sms[dev & 63].load());
  flash_attention_kernel<D><<<blocks, THREADS, smem, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Lq, H, D), k and v (B, Lk, H, D): bf16, the last axis contiguous,
// each given by its base pointer (16-byte aligned) and its batch, position
// and head strides in elements (multiples of 8); o (B, Lq, H, D) bf16,
// contiguous. D a multiple of 16, at most 128. scale is applied to q k^T
// (d^-1/2 for the model). Launches on `stream` and returns
// cudaGetLastError(), or -1 if a tensor map could not be encoded.
int ml_mdm_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                           int Lq, int Lk, int H, int D, long long q_sb, long long q_sl,
                           long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                           long long v_sb, long long v_sl, long long v_sh, float scale,
                           void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D < 16 || D > 128 || D % 16 != 0 ||
      q == nullptr || k == nullptr || v == nullptr || o == nullptr)
    return (int)cudaErrorInvalidValue;
  const Operands a{q, k, v, B, Lq, Lk, H, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  Params p;
  p.o = (__nv_bfloat16*)o;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.n_q_tiles = (Lq + BM - 1) / BM;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(a, p, s);
    case 32: return launch<32>(a, p, s);
    case 48: return launch<48>(a, p, s);
    case 64: return launch<64>(a, p, s);
    case 80: return launch<80>(a, p, s);
    case 96: return launch<96>(a, p, s);
    case 112: return launch<112>(a, p, s);
    case 128: return launch<128>(a, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
