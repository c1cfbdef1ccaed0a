// Blocked online-softmax attention for Hopper (kernel K4), and a 2-D
// attention layer's self and text branches on the matmul route's definition
// (kernel K6, after K4's kernel below: its own header is there). One library
// holds both, so one nvcc builds them.
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

#include "hopper_common.cuh"

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
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
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

// -- K6: a 2-D attention layer's self and text branches in one launch -----------
//
// Replaces no TPU kernel: in the JAX package a SelfAttention's two branches
// (ml_mdm_tpu/models/layers.py SelfAttention) are the matmul route's einsums
// (ml_mdm_tpu/ops/attention.py _einsum_attention), which XLA runs. For q, k, v
// (B, L, H, D), k_c, v_c (B, Lt, H, D) and a (B, Lt) key mask, per batch row
// and head,
//
//   out = attn(q, k, v) + attn(q, k_c, v_c, mask) (+ add)
//
// on the matmul route's definition (ops/attention.py matmul_attention): q and
// k each scaled by d^-1/4 and rounded to bf16 as the route scales them, each
// branch's logits rounded to bf16 where round_s (ML_MDM_TPU_BF16_LOGITS), -inf
// at masked keys, the softmax in f32 over the branch's whole key row, the
// weights normalised and then rounded to bf16, both products summed in f32.
// One departure that the definition leaves open: the branches (and `add`,
// K4's output where K4 took the self branch) are summed in f32 and rounded
// once. (Scaling the f32 product by d^-1/2 instead of q and k in bf16 would
// save a pass over each tile, but moves the output by 1.3-1.4e-2 of its
// largest value at the cells' shapes, next to the route's own tolerance of
// 2^-6.)
//
// Normalising before rounding is what a one-pass online softmax (K4's) cannot
// do: it rounds P before the row's sum is known. So a block keeps its 64 query
// rows' logits for a branch's whole key row in shared memory, in bf16 (128 KB
// at L = 1024; f32 where round_s is off, so half the length fits). Where that
// store leaves an SM one block of one consumer warpgroup (at L = 1024), two
// warpgroups take the same 64 rows and the self branch's key tiles in turns,
// each with its half of the store; else one takes them all:
//
//   - pass 1: S = Q K^T a tile of keys at a time on wgmma (Q and K in the
//     TMA's swizzled layout, as in K4, each tile scaled in place by its
//     warpgroup before its product), rounded a pair of keys at a time,
//     masked and stored, the rows' running maximum and sum of exponentials
//     kept in registers; the next tile's product runs while this one is
//     taken; the two warpgroups' maxima and sums are then combined through
//     shared memory, warpgroup 0's first in both;
//   - pass 2: each tile's weights exp(s - m) / l from the store, rounded to
//     bf16 as the A fragments of O += P V (V through the transpose bit, as in
//     K4); the next tile's weights are formed while this product runs;
//     warpgroup 0 then takes the text branch alone, and adds warpgroup 1's O
//     to its own before the output's one rounding;
//   - a thread stores and reloads only its own accumulator entries, 16 bytes
//     at a time with the warpgroup's threads side by side: no bank conflict,
//     no barrier;
//   - the self branch takes keys in tiles of 64, the text branch in tiles of
//     32 (Lt up to 128), through one ring of stages that one producer thread
//     keeps full by TMA in the order the consumers take them: Q once, then K
//     tiles, then V tiles, the self branch before the text. The ring is as
//     deep as the shared memory left beside the store allows without fewer
//     blocks an SM (3 to K6_MAX_STAGES): at L = 1024, where a block of two
//     warpgroups has an SM to itself, eight stages take 12-14% off three.
//
// What bounds it on the H100: at L = 1024, D = 64 the two products do
// 4 L^2 D FLOPs a head against 8 L D bytes (512 a byte, above the card's
// ~295). Inside a block the multi-function unit bounds it, not the products:
// a 64 x 64 tile is ~123 tensor-core cycles, while each warp spends 8 cycles
// on each of its two exponentials a logit (the sum in pass 1, the weight in
// pass 2) and on each bf16 conversion (q, k and the logits rounded, the
// weights packed). One warpgroup a block and one block an SM (the store at
// L = 1024) left that unit idle on latencies: two warpgroups on the same
// store give each scheduler two warps. Where the SM holds two blocks or more
// of one warpgroup, those do it. No float atomics, every sum across
// warpgroups in a fixed order, and the variant and the ring's depth fixed by
// the shapes: two calls give the same bits.

constexpr int K6_BM = 64;            // query rows a block: one consumer warpgroup
constexpr int K6_BN = 64;            // keys a tile of the self branch
constexpr int K6_TN = 32;            // keys a tile of the text branch
constexpr int K6_MIN_STAGES = 3;     // K or V tiles in flight, at least
constexpr int K6_MAX_STAGES = 8;     // and at most
constexpr float LOG2E = 1.4426950408889634f;

struct K6Params {
  __nv_bfloat16* o;            // (B, L, H, D) contiguous
  const __nv_bfloat16* add;    // (B, L, H, D) contiguous, or null
  const unsigned char* mask;   // (B, Lt) by m_sb, m_sl, 0 at a masked key; or null
  long long m_sb, m_sl;
  int L, Lt, H, n_q_tiles;
  int n_kt, n_tt;              // key tiles of the self and the text branch (0: none)
  float scale;                 // d^-1/4, on q and k
  int round_s;                 // the logits rounded to bf16
  int stages;                  // the ring's
  int store_bytes;             // the logits' store
};

// S = Q K^T over one tile of N keys (issued, not waited for)
template <int D, int N>
__device__ __forceinline__ void k6_issue_qk(float (&sc)[N / 2], uint32_t qa, uint32_t ka) {
  using T = Tile<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 / T::CW, off = (ks * 16 % T::CW) * 2;
    wgmma_ss<N>(sc, make_desc(qa + c * K6_BM * T::SW + off, 16, 8 * T::SW, T::LAYOUT),
                make_desc(ka + c * N * T::SW + off, 16, 8 * T::SW, T::LAYOUT), ks > 0);
  }
}

// O += P V over one tile of N keys (issued, not waited for)
template <int D, int N>
__device__ __forceinline__ void k6_issue_pv(float (&o)[D / 2], const uint32_t (&pa)[N / 16][4],
                                            uint32_t va) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs<D>(o, pa[kk], make_desc(va + kk * 16 * T::SW, N * T::SW, 8 * T::SW, T::LAYOUT));
}

// x <- bf16(x scale) over `bytes` bytes of bf16 in shared memory (a swizzled
// tile: the order does not matter), 16 bytes a thread at a time; then the
// writes made visible to wgmma, which reads through the async proxy, and the
// `threads` threads met at named barrier `bar`
__device__ __forceinline__ uint32_t k6_scale2(uint32_t w, float scale) {
  return pack_bf16(__uint_as_float(w << 16) * scale, __uint_as_float(w & 0xffff0000u) * scale);
}

__device__ __forceinline__ void k6_scale(uint32_t addr, uint32_t bytes, float scale, int tid,
                                         int threads, int bar) {
  for (uint32_t off = tid * 16; off < bytes; off += threads * 16) {
    uint32_t a, b, c, d;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
                 : "r"(addr + off));
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr + off),
                 "r"(k6_scale2(a, scale)), "r"(k6_scale2(b, scale)), "r"(k6_scale2(c, scale)),
                 "r"(k6_scale2(d, scale))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(bar, threads);
}

// One tile's logits in place: -inf at keys past `valid` and at masked ones
// (mrow: the mask at the tile's first key, or null), rounded to bf16 where
// round_s, a pair of neighbouring keys at a time into `pk` (one conversion
// a pair: the conversions, not the products, bound the tile), whose bf16
// values go back to sc
template <int N>
__device__ __forceinline__ void k6_logits(float (&sc)[N / 2], uint32_t (&pk)[N / 4], int valid,
                                          const unsigned char* mrow, long long m_sl, int round_s,
                                          int quad) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int key = (i / 4) * 8 + 2 * quad;  // entries i and i + 1: keys key and key + 1
    bool keep0 = key < valid, keep1 = key + 1 < valid;
    if (mrow != nullptr) {
      if (keep0) keep0 = mrow[key * m_sl] != 0;
      if (keep1) keep1 = mrow[(key + 1) * m_sl] != 0;
    }
    sc[i] = keep0 ? sc[i] : -INFINITY;
    sc[i + 1] = keep1 ? sc[i + 1] : -INFINITY;
    if (round_s) {
      pk[i / 2] = pack_bf16(sc[i], sc[i + 1]);
      sc[i] = __uint_as_float(pk[i / 2] << 16);
      sc[i + 1] = __uint_as_float(pk[i / 2] & 0xffff0000u);
    }
  }
}

// The rows' running maximum (log2 units) and sum of exponentials over one
// more tile, as four independent chains a row (see softmax_tile). A row with
// no key yet keeps its maximum at -inf and its sum at 0.
template <int N>
__device__ __forceinline__ void k6_online(const float (&sc)[N / 2], float (&m_run)[2],
                                          float (&l_run)[2][4]) {
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[h][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
  float mu[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[h], m * LOG2E);
    mu[h] = m_new == -INFINITY ? 0.f : m_new;
    const float corr = ex2(m_run[h] - mu[h]);  // 0 while the row had no key
    m_run[h] = m_new;
#pragma unroll
    for (int c = 0; c < 4; ++c) l_run[h][c] *= corr;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i >> 1) & 1;
    l_run[h][(i >> 2) & 3] += ex2(fmaf(sc[i], LOG2E, -mu[h]));
  }
}

// A thread's logits of tile j into the store and back: the bf16 pairs where
// round_s, else f32; 16 bytes a thread at a time, the warpgroup's 128
// threads side by side
template <int N>
__device__ __forceinline__ void k6_stash(uint4* store, int j, const float (&sc)[N / 2],
                                         const uint32_t (&pk)[N / 4], int t, int round_s) {
  if (round_s) {
#pragma unroll
    for (int u = 0; u < N / 16; ++u)
      store[(j * (N / 16) + u) * WG + t] =
          make_uint4(pk[4 * u], pk[4 * u + 1], pk[4 * u + 2], pk[4 * u + 3]);
  } else {
#pragma unroll
    for (int u = 0; u < N / 8; ++u)
      store[(j * (N / 8) + u) * WG + t] =
          make_uint4(__float_as_uint(sc[4 * u]), __float_as_uint(sc[4 * u + 1]),
                     __float_as_uint(sc[4 * u + 2]), __float_as_uint(sc[4 * u + 3]));
  }
}

template <int N>
__device__ __forceinline__ void k6_unstash(float (&sc)[N / 2], const uint4* store, int j, int t,
                                           int round_s) {
  if (round_s) {
#pragma unroll
    for (int u = 0; u < N / 16; ++u) {
      const uint4 w = store[(j * (N / 16) + u) * WG + t];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sc[8 * u + 2 * r] = __uint_as_float(ws[r] << 16);
        sc[8 * u + 2 * r + 1] = __uint_as_float(ws[r] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < N / 8; ++u) {
      const uint4 w = store[(j * (N / 8) + u) * WG + t];
      sc[4 * u] = __uint_as_float(w.x);
      sc[4 * u + 1] = __uint_as_float(w.y);
      sc[4 * u + 2] = __uint_as_float(w.z);
      sc[4 * u + 3] = __uint_as_float(w.w);
    }
  }
}

// The weights of tile j, exp(s - m) / l rounded once to bf16, as A fragments
template <int N>
__device__ __forceinline__ void k6_weights(uint32_t (&pa)[N / 16][4], const uint4* store, int j,
                                           int t, int round_s, const float (&m_fin)[2],
                                           const float (&inv)[2]) {
  float sc[N / 2];
  k6_unstash<N>(sc, store, j, t, round_s);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = ex2(fmaf(sc[i], LOG2E, -m_fin[h])) * inv[h];
  }
  pack_p<N>(pa, sc);
}

// One branch over n tiles of N keys (`valid` of them real), its P V added to
// o. Warpgroup w of nwg takes tiles w, w + nwg, ...: K tile j is the ring's
// tile g0 + j, V tile j its g0 + n + j. With two warpgroups the rows' maxima
// and sums are combined through `xch` between the passes, in a fixed order.
template <int D, int N>
__device__ __forceinline__ void k6_branch(float (&o)[D / 2], uint32_t sq, uint32_t ring,
                                          uint32_t bars, uint4* store, float4* xch, int g0, int n,
                                          int nwg, int w, int valid, const unsigned char* mrow,
                                          const K6Params& p, int t, int quad) {
  constexpr uint32_t STAGE = K6_BN * D * 2;
  auto stage = [&](int k) { return ring + (uint32_t)(k % p.stages) * STAGE; };
  auto full = [&](int k) { return bars + 8 * (1 + k % p.stages); };
  auto empty = [&](int k) { return bars + 8 * (1 + K6_MAX_STAGES + k % p.stages); };
  auto parity = [&](int k) { return (uint32_t)((k / p.stages) & 1); };
  const int mine = n > w ? (n - w + nwg - 1) / nwg : 0;  // this warpgroup's tiles

  // pass 1: the logits, stored, and the rows' maxima and sums; tile i + 1's
  // product runs while tile i is taken, and is copied in when both are done
  // (no product is pending across the loop's back edge)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2][4] = {};
  float sa[N / 2], sb[N / 2];
  auto issue = [&](float (&sc)[N / 2], int k) {
    mbar_wait(full(k), parity(k));
    k6_scale(stage(k), N * D * 2, p.scale, t, WG, 4 + w);
    fence_regs(sc);
    wgmma_fence();
    k6_issue_qk<D, N>(sc, sq, stage(k));
    wgmma_commit();
  };
  if (mine) {
    issue(sa, g0 + w);
    wgmma_wait<0>();
    fence_regs(sa);
  }
#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    const int j = w + i * nwg;
    if (i + 1 < mine) issue(sb, g0 + j + nwg);
    if (t == 0) mbar_arrive(empty(g0 + j));
    uint32_t pk[N / 4];
    k6_logits<N>(sa, pk, valid - j * N,
                 mrow == nullptr ? nullptr : mrow + (long long)j * N * p.m_sl, p.m_sl, p.round_s,
                 quad);
    k6_stash<N>(store, i, sa, pk, t, p.round_s);
    k6_online<N>(sa, m_run, l_run);
    if (i + 1 < mine) {
      wgmma_wait<0>();
      fence_regs(sb);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) sa[e] = sb[e];
    }
  }

  // the rows' maxima and sums over the branch's whole key row
  float m_fin[2], inv[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = (l_run[h][0] + l_run[h][1]) + (l_run[h][2] + l_run[h][3]);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float4 part[2] = {make_float4(m_run[0], m_run[1], l[0], l[1]),
                    make_float4(-INFINITY, -INFINITY, 0.f, 0.f)};
  if (nwg == 2) {  // the same rows are thread t's in both warpgroups
    xch[w * WG + t] = part[0];
    named_sync(2, 2 * WG);
    part[1] = xch[(1 - w) * WG + t];
    if (w == 1) {  // warpgroup 0's part first in both
      const float4 x = part[0];
      part[0] = part[1];
      part[1] = x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m0 = h ? part[0].y : part[0].x, m1 = h ? part[1].y : part[1].x;
    const float l0 = h ? part[0].w : part[0].z, l1 = h ? part[1].w : part[1].z;
    const float m = fmaxf(m0, m1);
    m_fin[h] = m == -INFINITY ? 0.f : m;
    inv[h] = 1.f / (l0 * ex2(m0 - m_fin[h]) + l1 * ex2(m1 - m_fin[h]));
  }

  // pass 2: O += P V, tile i's product running while tile i + 1's weights form
  uint32_t pa[N / 16][4], pb[N / 16][4];
  auto pv = [&](uint32_t (&pp)[N / 16][4], int k) {
    mbar_wait(full(k), parity(k));
    fence_regs(o);
    fence_regs(pp);
    wgmma_fence();
    k6_issue_pv<D, N>(o, pp, stage(k));
    wgmma_commit();
  };
  auto done = [&](uint32_t (&pp)[N / 16][4], int k) {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pp);
    if (t == 0) mbar_arrive(empty(k));
  };
  auto vtile = [&](int i) { return g0 + n + w + i * nwg; };
  if (mine) k6_weights<N>(pa, store, 0, t, p.round_s, m_fin, inv);
  int i = 0;
#pragma unroll 1
  for (; i + 1 < mine; i += 2) {  // tile i's weights in pa
    pv(pa, vtile(i));
    k6_weights<N>(pb, store, i + 1, t, p.round_s, m_fin, inv);
    done(pa, vtile(i));
    pv(pb, vtile(i + 1));
    if (i + 2 < mine) k6_weights<N>(pa, store, i + 2, t, p.round_s, m_fin, inv);
    done(pb, vtile(i + 1));
  }
  if (i < mine) {
    pv(pa, vtile(i));
    done(pa, vtile(i));
  }
}

// NWG consumer warpgroups (1 or 2) on the block's 64 rows, then one producer warp
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * WG + 32, 1)
    two_branch_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap kcmap,
                                const __grid_constant__ CUtensorMap vcmap, const K6Params p) {
  using T = Tile<D>;
  constexpr uint32_t Q_BYTES = K6_BM * D * 2;
  constexpr uint32_t STAGE = K6_BN * D * 2;  // a text tile uses the first half

  // the swizzled regions want 1024-byte alignment; the launch adds the slack.
  // Q, the ring, a store a consumer warpgroup, their exchange (two of them),
  // the barriers
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t XCH = NWG == 2 ? NWG * WG * 16 : 0;
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  const uint32_t sq = smem_u32(smem_raw) + pad;
  const uint32_t ring = sq + Q_BYTES;
  const uint32_t store_off = pad + Q_BYTES + p.stages * STAGE;
  float4* xch = reinterpret_cast<float4*>(smem_raw + store_off + NWG * p.store_bytes);
  const uint32_t bars = ring + p.stages * STAGE + NWG * p.store_bytes + XCH;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + K6_MAX_STAGES + s); };

  // the query tile fastest, so that the blocks at work share heads in L2
  const int qt = blockIdx.x % p.n_q_tiles, bh = blockIdx.x / p.n_q_tiles;
  const int head = bh % p.H, batch = bh / p.H;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);  // thread 0 of the warpgroup that took the tile arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * WG) {
    // -- producer: one thread loads Q, then the ring's tiles in the consumers' order
    if (threadIdx.x == NWG * WG) {
      mbar_expect_tx(bars, Q_BYTES);
      for (int c = 0; c < D / T::CW; ++c)
        tma_load_4d(sq + c * K6_BM * T::SW, &qmap, bars, c * T::CW, head, qt * K6_BM, batch);
      int g = 0;
      auto load = [&](const CUtensorMap* map, int rows, int row0) {
        const int s = g % p.stages;
        mbar_wait(empty(s), ((g / p.stages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), rows * D * 2);
        for (int c = 0; c < D / T::CW; ++c)
          tma_load_4d(ring + s * STAGE + c * rows * T::SW, map, full(s), c * T::CW, head, row0,
                      batch);
        ++g;
      };
      for (int j = 0; j < p.n_kt; ++j) load(&kmap, K6_BN, j * K6_BN);
      for (int j = 0; j < p.n_kt; ++j) load(&vmap, K6_BN, j * K6_BN);
      for (int j = 0; j < p.n_tt; ++j) load(&kcmap, K6_TN, j * K6_TN);
      for (int j = 0; j < p.n_tt; ++j) load(&vcmap, K6_TN, j * K6_TN);
    }
    return;
  }

  // -- consumers: the warpgroups on the block's 64 query rows, the self
  //    branch's key tiles taken in turns, the text branch by warpgroup 0 ----------
  const int w = NWG == 1 ? 0 : __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int t = threadIdx.x % WG;
  const int warp = t / 32, lane = t % 32, quad = lane % 4;
  uint4* store = reinterpret_cast<uint4*>(smem_raw + store_off + w * p.store_bytes);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(bars, 0);
  k6_scale(sq, Q_BYTES, p.scale, threadIdx.x, NWG * WG, 1);
  if (p.n_kt)
    k6_branch<D, K6_BN>(o, sq, ring, bars, store, xch, 0, p.n_kt, NWG, w, p.L, nullptr, p, t,
                        quad);
  if (p.n_tt && w == 0)
    k6_branch<D, K6_TN>(o, sq, ring, bars, store, xch, 2 * p.n_kt, p.n_tt, 1, 0, p.Lt,
                        p.mask == nullptr ? nullptr : p.mask + batch * p.m_sb, p, t, quad);

  // warpgroup 1 hands its O to warpgroup 0 through its own store, once all of
  // its threads are done reading their logits there
  if (NWG == 2) {
    float* xo = reinterpret_cast<float*>(smem_raw + store_off + p.store_bytes);
    if (w == 1) {
      named_sync(6, WG);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) xo[i * WG + t] = o[i];
      named_arrive(3, 2 * WG);
      return;
    }
    named_sync(3, 2 * WG);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += xo[i * WG + t];
  }

  // out = the branches' sum (+ add), rounded once to bf16, rows past L dropped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qt * K6_BM + warp * 16 + h * 8 + lane / 4;
    if (row >= p.L) continue;
    const long long off = (((long long)batch * p.L + row) * p.H + head) * D + 2 * quad;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float a = o[4 * i + 2 * h], b = o[4 * i + 2 * h + 1];
      if (p.add != nullptr) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p.add + off + 8 * i);
        a += __low2float(x);
        b += __high2float(x);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.o + off + 8 * i) = __floats2bfloat162_rn(a, b);
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

struct K6Operands {
  const void *q, *k, *v, *kc, *vc;  // k, v null: no self branch; kc, vc null: no text
  int B, L, Lt, H;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  long long kc_sb, kc_sl, kc_sh, vc_sb, vc_sl, vc_sh;
};

// A consumer warpgroup's store in 16-byte words a thread: its share of the
// self branch's logits, the text branch's (warpgroup 0's), or, with two,
// warpgroup 1's O in f32 on its way to warpgroup 0, the most of the three
long long k6_store_u4(int D, int n_kt, int n_tt, int round_s, int nwg) {
  const long long self_u4 = (long long)(n_kt + nwg - 1) / nwg * (K6_BN / 16) * (round_s ? 1 : 2);
  const long long text_u4 = (long long)n_tt * (K6_TN / 16) * (round_s ? 1 : 2);
  const long long u4 = self_u4 > text_u4 ? self_u4 : text_u4;
  return nwg == 2 && u4 < D / 8 ? D / 8 : u4;
}

// K6's dynamic shared memory: the alignment slack, Q, the ring, a store a
// consumer warpgroup (2048 bytes a word of the 128 threads), with two their
// exchange of the rows' maxima and sums, and the barriers
size_t k6_smem(int D, int n_kt, int n_tt, int round_s, int nwg, int stages) {
  return 1024 + (size_t)(1 + stages) * K6_BM * D * 2 +
         (size_t)nwg * k6_store_u4(D, n_kt, n_tt, round_s, nwg) * WG * 16 +
         (nwg == 2 ? 2 * WG * 16 : 0) + 8 * (1 + 2 * K6_MAX_STAGES);
}

// blocks of `smem` bytes an SM holds: its 228 KB, 1 KB of each block reserved
int k6_blocks_per_sm(size_t smem) { return (int)(233472 / (smem + 1024)); }

// Registers a thread of each K6 instance, read once (an SM's blocks follow
// them and the shared memory)
template <int D, int NWG>
int k6_configure(int dev) {
  static std::atomic<unsigned long long> configured{0};
  static std::atomic<int> regs{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(two_branch_attention_kernel<D, NWG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return -(int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, two_branch_attention_kernel<D, NWG>);
    if (err != cudaSuccess) return -(int)err;
    regs.store(attr.numRegs);
    configured.fetch_or(bit);
  }
  return regs.load();
}

// blocks of NWG warpgroups and `smem` bytes an SM holds: its 65,536 registers
// (8 a thread at a time) and 228 KB of shared memory, 1 KB of each block
// reserved
int k6_blocks_per_sm(int regs, int nwg, size_t smem) {
  const int by_regs = 65536 / (((regs + 7) / 8 * 8) * (nwg * WG + 32));
  const int by_smem = (int)(233472 / (smem + 1024));
  return by_regs < by_smem ? by_regs : by_smem;
}

template <int D>
int launch_k6(const K6Operands& a, K6Params p, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int regs1 = k6_configure<D, 1>(dev), regs2 = k6_configure<D, 2>(dev);
  if (regs1 < 0) return -regs1;
  if (regs2 < 0) return -regs2;
  // one warpgroup where the SM holds two blocks or more of it, else two on
  // the same store, so that each scheduler has two warps
  const size_t one = k6_smem(D, p.n_kt, p.n_tt, p.round_s, 1, K6_MIN_STAGES);
  const size_t two = k6_smem(D, p.n_kt, p.n_tt, p.round_s, 2, K6_MIN_STAGES);
  if (one > 232448) return -2;
  const int nwg = k6_blocks_per_sm(regs1, 1, one) < 2 && two <= 232448 ? 2 : 1;
  const int regs = nwg == 1 ? regs1 : regs2;
  // the least ring, then deeper while the SM still holds as many blocks
  p.stages = K6_MIN_STAGES;
  size_t smem = nwg == 1 ? one : two;
  const int per_sm = k6_blocks_per_sm(regs, nwg, smem);
  while (p.stages < K6_MAX_STAGES) {
    const size_t deeper = k6_smem(D, p.n_kt, p.n_tt, p.round_s, nwg, p.stages + 1);
    if (deeper > 232448 || k6_blocks_per_sm(regs, nwg, deeper) < per_sm) break;
    ++p.stages;
    smem = deeper;
  }
  p.store_bytes = (int)(k6_store_u4(D, p.n_kt, p.n_tt, p.round_s, nwg) * WG * 16);
  // maps a branch does not use are never read; Q's stands in for them
  CUtensorMap qm, km, vm, kcm, vcm;
  if (!encode<D>(&qm, a.q, a.B, a.L, a.H, a.q_sb, a.q_sl, a.q_sh, K6_BM)) return -1;
  km = vm = kcm = vcm = qm;
  if (a.k != nullptr && (!encode<D>(&km, a.k, a.B, a.L, a.H, a.k_sb, a.k_sl, a.k_sh, K6_BN) ||
                         !encode<D>(&vm, a.v, a.B, a.L, a.H, a.v_sb, a.v_sl, a.v_sh, K6_BN)))
    return -1;
  if (a.kc != nullptr &&
      (!encode<D>(&kcm, a.kc, a.B, a.Lt, a.H, a.kc_sb, a.kc_sl, a.kc_sh, K6_TN) ||
       !encode<D>(&vcm, a.vc, a.B, a.Lt, a.H, a.vc_sb, a.vc_sl, a.vc_sh, K6_TN)))
    return -1;
  const long long blocks = (long long)p.n_q_tiles * a.B * a.H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (nwg == 1)
    two_branch_attention_kernel<D, 1><<<(int)blocks, WG + 32, smem, stream>>>(qm, km, vm, kcm,
                                                                             vcm, p);
  else
    two_branch_attention_kernel<D, 2><<<(int)blocks, 2 * WG + 32, smem, stream>>>(qm, km, vm,
                                                                                 kcm, vcm, p);
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

// K6: q, k, v (B, L, H, D), kc, vc (B, Lt, H, D), bf16, the last axis
// contiguous, each given by its base pointer (16-byte aligned) and its batch,
// position and head strides in elements (multiples of 8); k and v null for no
// self branch, kc and vc null for no text branch (not both); mask (B, Lt)
// bytes by m_sb, m_sl (0 at a masked key) or null; add (B, L, H, D) bf16
// contiguous or null; o (B, L, H, D) bf16, contiguous. D a multiple of 16, at
// most 128; Lt at most 128; q and k are scaled by `scale` (d^-1/4) and
// rounded to bf16, the logits rounded to bf16 where round_s. Launches on `stream` and returns
// cudaGetLastError(), -1 if a tensor map could not be encoded, or -2 if the
// logits of one branch's key row do not fit a block's shared memory.
int ml_mdm_two_branch_attention(const void* q, const void* k, const void* v, const void* kc,
                                const void* vc, const void* mask, const void* add, void* o,
                                int B, int L, int Lt, int H, int D, long long q_sb,
                                long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                                long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                                long long kc_sb, long long kc_sl, long long kc_sh,
                                long long vc_sb, long long vc_sl, long long vc_sh,
                                long long m_sb, long long m_sl, float scale, int round_s,
                                void* stream) {
  const bool self = k != nullptr && v != nullptr, text = kc != nullptr && vc != nullptr;
  if (B <= 0 || L <= 0 || H <= 0 || D < 16 || D > 128 || D % 16 != 0 || q == nullptr ||
      o == nullptr || (!self && !text) || (text && (Lt <= 0 || Lt > 128)))
    return (int)cudaErrorInvalidValue;
  const K6Operands a{q,    self ? k : nullptr, v,    text ? kc : nullptr, vc,
                     B,    L,    text ? Lt : 0, H,
                     q_sb, q_sl, q_sh,  k_sb,  k_sl,  k_sh,  v_sb,  v_sl,  v_sh,
                     kc_sb, kc_sl, kc_sh, vc_sb, vc_sl, vc_sh};
  K6Params p;
  p.o = (__nv_bfloat16*)o;
  p.add = (const __nv_bfloat16*)add;
  p.mask = text ? (const unsigned char*)mask : nullptr;
  p.m_sb = m_sb;
  p.m_sl = m_sl;
  p.L = L;
  p.Lt = a.Lt;
  p.H = H;
  p.n_q_tiles = (L + K6_BM - 1) / K6_BM;
  p.n_kt = self ? (L + K6_BN - 1) / K6_BN : 0;
  p.n_tt = text ? (Lt + K6_TN - 1) / K6_TN : 0;
  p.scale = scale;
  p.round_s = round_s != 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_k6<16>(a, p, s);
    case 32: return launch_k6<32>(a, p, s);
    case 48: return launch_k6<48>(a, p, s);
    case 64: return launch_k6<64>(a, p, s);
    case 80: return launch_k6<80>(a, p, s);
    case 96: return launch_k6<96>(a, p, s);
    case 112: return launch_k6<112>(a, p, s);
    case 128: return launch_k6<128>(a, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
