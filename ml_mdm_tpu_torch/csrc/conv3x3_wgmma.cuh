// The wgmma 3x3 convolution kernel, `conv3x3_wgmma_kernel`, with its device
// helpers and its launch: one source for K2 (csrc/fused_resnet.cu, whose
// header says what the kernel computes, what bounds it on the H100 and how
// it is laid out) and for the cost-decomposition probes P1 and P2
// (csrc/kernel_anatomy.cu), which are instances of it with some of K2's
// features switched off. Each including source is its own library, so
// everything lives in an anonymous namespace.
//
// The template's last argument, PROBE, holds the probes' switches; every K2
// instance takes 0, K2 as it is, and each switch is read under `if
// constexpr`, so K2's code does not depend on them. Bits 8 and up hold a
// probe's taps a chunk (0, 1, 4 or 9), at the staged offsets the host
// passes in `toff` ([t]; packed [4 t + ks], as K2's packed launches). The
// switches:
//   PROBE_NO_HALO   P1: the tile alone, without its halo (no spatial shift).
//   PROBE_BANDS     P2's bands of PROBE_BAND rows (the tile's TH divides
//                   it): a halo row across a band's edge is not loaded...
//   PROBE_HALOS     ...unless this is on: then it is the neighbouring image
//                   row, clamped to the image's first and last rows.
//   PROBE_FILL_ACT  a cell that is not loaded holds act(0), the activation
//                   of its zero fill (K2 stores 0 there).
//   PROBE_DIRECT    no register pass: ldmatrix reads the raw tile cp.async
//                   filled, in three buffers by chunk (identity prologue).
//   PROBE_SERIAL    the next chunk's activation runs after this chunk's
//                   products, then the barrier (K2 runs it under them); the
//                   raw tiles still come by cp.async under the products.
// With 0 taps there is no weight ring and no product: each chunk's staged
// tile goes out as y (P1's copy).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int PROBE_ON = 1;
constexpr int PROBE_NO_HALO = 2;
constexpr int PROBE_BANDS = 4;
constexpr int PROBE_HALOS = 8;
constexpr int PROBE_FILL_ACT = 16;
constexpr int PROBE_DIRECT = 32;
constexpr int PROBE_SERIAL = 64;
constexpr int PROBE_TAPS_SHIFT = 8;
constexpr int PROBE_BAND = 16;  // rows of one of P2's bands

constexpr int MAX_OPS = 4;  // operands of one launch

// 16 bytes global -> shared, asynchronously; src_bytes = 0 stores zeros
// and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 bf16 values in one 16-byte register group.
union Pack8 {
  uint4 u;
  unsigned short h[8];
};

// tanh on the SFU (one MUFU.TANH, relative error below 2^-10.9)
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x*a+b (and SiLU) of 8 raw channels in f32, rounded to bf16 once. The
// SiLU as u sigmoid(u) = h + h tanh(h) with h = u / 2: one SFU operation
// and a short dependency chain (the staging runs at few warps an SM, so
// its latency, not its throughput, is what costs).
__device__ __forceinline__ uint4 act8(const uint4 rawv, const float (&av)[8],
                                      const float (&bv)[8], int apply_silu) {
  Pack8 r, o;
  r.u = rawv;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float u = __bfloat162float(__ushort_as_bfloat16(r.h[j])) * av[j] + bv[j];
    if (apply_silu) {
      const float h = 0.5f * u;
      u = fmaf(h, tanh_approx(h), h);
    }
    o.h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(u));
  }
  return o.u;
}

// ===========================================================================
// The kernel (wgmma), unpacked and packed
// ===========================================================================

constexpr int WG_BK = 64;                    // input channels a chunk: one 128-byte row
constexpr int WG_THREADS = 256;              // two warpgroups
constexpr int WG_MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;           // dynamic shared memory a block may have

struct ConvParams {
  const __nv_bfloat16* x[MAX_OPS];  // (B, H, W, c[k])
  int c[MAX_OPS];                   // channels of operand k
  int off[MAX_OPS];                 // its first channel in the concatenation (a, b)
  int q0[MAX_OPS + 1];              // its first chunk of 64 channels; q0[n_ops] = n_q
  int n_ops, n_q, ctot;
  const float* a;                   // (B, ctot) f32, or null with b: the identity prologue
  const float* b;
  int apply_silu;
  const __nv_bfloat16* wt;          // (n_q, taps, cpad, 64) bf16, swizzled (fused_resnet.cu)
  const __nv_bfloat16* pw;          // (n_q, cpad, 64) bf16, swizzled, or null
  const float* bias;                // (Cout) or null
  const float* pbias;               // (Cout) with pw
  const __nv_bfloat16* residual;    // (B, H, W, Cout) or null
  __nv_bfloat16* y;
  __nv_bfloat16* proj;
  float* s1;
  float* s2;
  int B, H, W, Cout, cpad;
  int TH, TW, tiles_w, tiles_per_image, n_ntiles, stages;
  int toff[16];                     // packed: staged offset of (combined tap, k-step);
                                    // a probe unpacked: of tap t, at [t]
};

// d += A B for one k-step of 16: A (64 x 16) from registers (an m16 x k16
// fragment a warp), B (16 x N) from shared memory through its descriptor,
// K-major (no transpose).
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_k<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<128>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_rs_k<256>(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the compiler from moving accesses of the A fragments across the
// asynchronous products that read them.
template <int MT>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[m][i])::"memory");
}

// Operand and first channel of chunk q.
__device__ __forceinline__ void wg_chunk_of(const ConvParams& p, int q, int& k, int& c0) {
  k = 0;
  while (k < p.n_ops - 1 && q >= p.q0[k + 1]) ++k;
  c0 = (q - p.q0[k]) * WG_BK;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

template <int BN, int MT, bool PROJ, bool PACKED, int PROBE = 0>
__global__ void __launch_bounds__(WG_THREADS, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ ConvParams p) {
  // taps a chunk: 9, or the 4 combined; a probe's own
  constexpr int NTAPS = PROBE ? PROBE >> PROBE_TAPS_SHIFT : PACKED ? 4 : 9;
  // the probes' switches (see the top of this file): all off for K2
  constexpr int HALO = (PROBE & PROBE_NO_HALO) ? 0 : 1;  // halo pixels each side
  constexpr bool BANDS = (PROBE & PROBE_BANDS) != 0, HALOS = (PROBE & PROBE_HALOS) != 0;
  constexpr bool FILL_ACT = (PROBE & PROBE_FILL_ACT) != 0;
  constexpr bool DIRECT = (PROBE & PROBE_DIRECT) != 0, SERIAL = (PROBE & PROBE_SERIAL) != 0;
  constexpr bool TURNS4 = NTAPS == 4;  // staging turns at odd k-steps (else at taps 1-8)
  static_assert(PROBE == 0 || (PROBE & PROBE_ON), "a probe's switches come with PROBE_ON");
  static_assert(PROBE == 0 || !PROJ, "a probe has no shortcut pass");
  static_assert(HALO || !(BANDS || HALOS || FILL_ACT || PACKED), "bands and selects need the halo");
  static_assert(BANDS || !(HALOS || FILL_ACT), "halos and the act(0) fill are P2's band rule");
  static_assert(!DIRECT || (SERIAL && !PACKED), "the raw tile read directly: serial, unpacked");
  static_assert(NTAPS > 0 || (SERIAL && !DIRECT && !PACKED && !PROJ), "0 taps: P1's copy");
  constexpr uint32_t SLOT = BN * 128;           // bytes of one tap's (BN x 64) weights
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = base + ((1024 - (base & 1023)) & 1023);  // 1024-aligned: the swizzle
  const int SW = p.TW + 2 * HALO;               // staged row width
  const int n_stage = (p.TH + 2 * HALO) * SW;   // staged pixels (tile and halo)
  const uint32_t tile_bytes = n_stage * 128;    // one staged tile: [n_stage][64], swizzled
  const uint32_t act0 = ring + p.stages * SLOT; // two activated tiles, by chunk parity
  const uint32_t raw = act0 + 2 * tile_bytes;   // the raw tile
  const uint32_t bars = raw + tile_bytes;       // full[stages], then empty[stages]
  const uint32_t coef = bars + 16 * p.stages;   // a and b of a chunk, by parity: [2][2][64] f32
  float* stat = reinterpret_cast<float*>(smem_raw + (coef + 1024 - base));  // [2][BN]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.stages + s); };
  const int tid = threadIdx.x;

  // Persistent: block b takes the output tiles b, b + gridDim.x, ...; a
  // tile is (pixel tile, N tile), the N tiles of one pixel tile adjacent,
  // so the blocks at work share their activation tiles and weights in L2.
  const int n_tiles = p.n_ntiles * p.tiles_per_image * p.B;
  const int n_mine_tiles = max(0, (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                                      (int)gridDim.x);
  struct Geo {
    int img, r0, col0, n0;
  };
  auto geo = [&](int i) {  // the block's i-th tile
    const int tl = blockIdx.x + i * gridDim.x;
    const int mtile = tl / p.n_ntiles, t = mtile % p.tiles_per_image;
    return Geo{mtile / p.tiles_per_image, (t / p.tiles_w) * p.TH, (t % p.tiles_w) * p.TW,
               (tl % p.n_ntiles) * BN};
  };
  const int n_q = p.n_q;
  const int n_u = PROJ ? 2 * n_q : n_q;         // chunks of a tile over both passes
  const int n_chunks = n_mine_tiles * n_u;      // chunks of the block, in order

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.s1 != nullptr)
    for (int i = tid; i < 2 * BN; i += WG_THREADS) stat[i] = 0.f;
  __syncthreads();

  // Thread 0 keeps the weight ring full: it issues slice j into slot
  // j % stages once both warpgroups have handed back slice j - stages. When
  // the block takes slice j (a tap) it blocks until slice j + stages - 2 is
  // out: that slot's last slice is the tap before the current one, which
  // its own warpgroup has handed back already, so it waits on the other
  // warpgroup alone, which never waits on it within a chunk; beyond that it
  // issues what is free without waiting. (A producer
  // warpgroup of its own would cap every thread at 168 registers, 65,536 /
  // 384; two warpgroups leave 255.) The slices come in the order the
  // warpgroups take them: tile by tile, (chunk, tap), then the shortcut's
  // chunks; a tile's last N tile copies only the channels that exist, and
  // the rest of its slot is never stored from.
  const int per_tile = n_q * (NTAPS + PROJ);
  const int n_slices = n_mine_tiles * per_tile;
  int issued = 0;
  auto produce = [&](int need) {
    if (tid != 0) return;
    while (issued < n_slices) {
      const int slot = issued % p.stages, phase = ((issued / p.stages) & 1) ^ 1;
      if (issued < need)
        mbar_wait(empty(slot), phase);  // the first round passes at once
      else if (!mbar_test_wait(empty(slot), phase))
        break;
      const int jl = issued % per_tile, n0 = geo(issued / per_tile).n0;
      const uint32_t bytes = (uint32_t)min(BN, p.cpad - n0) * 128;
      const __nv_bfloat16* src =
          jl < NTAPS * n_q ? p.wt + ((size_t)jl * p.cpad + n0) * 64
                           : p.pw + ((size_t)(jl - NTAPS * n_q) * p.cpad + n0) * 64;
      mbar_expect_tx(full(slot), bytes);
      bulk_load(ring + slot * SLOT, src, bytes, full(slot));
      ++issued;
    }
  };
  auto take = [&](int j) {  // slice j out and landed
    produce(j + p.stages - 1);
    mbar_wait(full(j % p.stages), (j / p.stages) & 1);
  };

  // staged offset of tap t's k-step ks from the tile's output pixel 0: tap
  // (ky, kx) at (ky, kx); packed, the host's table (the uniform shift of
  // combined tap t at parity class ks, see fused_resnet.cu); a probe's taps at
  // the host's offsets
  auto tap_off = [&](int t, int ks) {
    return PACKED ? p.toff[4 * t + ks] : PROBE ? p.toff[t] : (t / 3) * SW + t % 3;
  };

  // warpgroup wg owns the tile's pixels [wg MT 64, (wg + 1) MT 64)
  const int wg = tid / 128, wl = tid % 128;
  const int lane = tid % 32, wwarp = wl / 32;
  const int tile_px = p.TH * p.TW;
  const int khalf = lane >> 4;  // lanes 16-31 give the rows of k 8-15
  // staged pixel of this thread's ldmatrix row in each m64 tile, at tap
  // (0, 0); rows past the tile repeat its last pixel and are never stored
  int p0[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = min((wg * MT + mt) * 64 + wwarp * 16 + (lane & 15), tile_px - 1);
    p0[mt] = (m / p.TW) * SW + m % p.TW;
  }

  // Staging. Thread tid owns the cells k = 0, 1, ... of a staged tile:
  // 16-byte group j8 = tid % 8 (8 channels of the chunk) of staged pixel
  // px0 + 32 k, px0 = tid / 8 (packed: the pixels of a pair of warps in the
  // order 0 2 4 6 | 1 3 5 7, see fused_resnet.cu). It copies its cells of a
  // chunk's raw tile and halo by cp.async and later activates the same
  // cells, so the raw tile needs no barrier: a thread reads only what it
  // copied itself. The halo and the channels past an operand are
  // zero-filled; x*a+b (and SiLU) is applied once per element and cells
  // outside the image are 0 after it; the shortcut pass and the identity
  // prologue copy the raw values. Packed, every activated cell is stored in
  // parity-class order. Chunk U of the block is chunk U % n_u of its tile
  // U / n_u.
  const int j8 = tid & 7;
  const int px0 = PACKED ? (tid >> 6 << 3) | ((tid >> 3 & 3) << 1) | (tid >> 5 & 1) : tid >> 3;
  const int n_mine = PACKED ? max(0, (n_stage - px0 + WG_THREADS / 8 - 1) / (WG_THREADS / 8))
                            : max(0, (n_stage * 8 - tid + WG_THREADS - 1) / WG_THREADS);
  int cur_k = 0, cur_row = 0, cur_col = 0;  // the activation's cursor over the cells
  auto cursor_reset = [&]() {
    cur_k = 0;
    cur_row = px0 / SW;
    cur_col = px0 % SW;
  };
  auto cursor_step = [&]() {  // each thread's cells are 32 pixels apart
    ++cur_k;
    for (cur_col += WG_THREADS / 8; cur_col >= SW; cur_col -= SW) ++cur_row;
  };
  // P2's bands: the image row that staged row `row` (image row ih) of a
  // tile at row r0 loads, or -1 where it loads nothing. A halo row across a
  // band's edge is not loaded, or with HALOS is the neighbouring row clamped
  // to the image; the other rows lie inside the band, hence the image.
  [[maybe_unused]] auto band_row = [&](int r0, int row, int ih) {
    const bool edge = (row == 0 && r0 % PROBE_BAND == 0) ||
                      (row == p.TH + 1 && (r0 + p.TH) % PROBE_BAND == 0);
    return !edge ? ih : HALOS ? min(max(ih, 0), p.H - 1) : -1;
  };
  auto load_raw = [&](int U) {
    const Geo g = geo(U / n_u);
    const int u = U % n_u;
    int k, c0;
    wg_chunk_of(p, u < n_q ? u : u - n_q, k, c0);
    const int ck = p.c[k], c = c0 + 8 * j8;
    const __nv_bfloat16* xk = p.x[k] + (size_t)g.img * p.H * p.W * ck;
    uint32_t dst = raw;
    if constexpr (DIRECT) dst = act0 + (U % 3) * tile_bytes;  // the three raw buffers
    for (cursor_reset(); cur_k < n_mine; cursor_step()) {
      const int px = px0 + cur_k * (WG_THREADS / 8);
      const int ih = g.r0 - HALO + cur_row, iw = g.col0 - HALO + cur_col;
      if constexpr (BANDS) {
        const int sh = band_row(g.r0, cur_row, ih);
        const bool in = sh >= 0 && iw >= 0 && iw < p.W && c < ck;
        cp_async_16(dst + px * 128 + ((j8 ^ (px & 7)) << 4),
                    in ? xk + (((size_t)sh * p.W + iw) * ck + c) : xk, in ? 16 : 0);
      } else {
        const bool in = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W && c < ck;
        cp_async_16(dst + px * 128 + ((j8 ^ (px & 7)) << 4),
                    in ? xk + (((size_t)ih * p.W + iw) * ck + c) : xk, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // chunk U's a and b into the coefficient buffer of its parity (threads
  // 0-127: a then b, one channel each; 0 past the operand)
  auto load_coef = [&](int U) {
    const int u = U % n_u;
    if (u >= n_q || p.a == nullptr || tid >= 128) return;
    int k, c0;
    wg_chunk_of(p, u, k, c0);
    const int c = c0 + (tid & 63);
    const float* src = tid < 64 ? p.a : p.b;
    const float v = c < p.c[k] ? src[(size_t)geo(U / n_u).img * p.ctot + p.off[k] + c] : 0.f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(coef + ((U & 1) * 128 + tid) * 4), "f"(v)
                 : "memory");
  };
  // activate this thread's cells of chunk U, the cursor's next ones up to
  // cell k_end, into the activated tile of U's parity
  auto activate = [&](int U, int k_end) {
    const Geo g = geo(U / n_u);
    const int u = U % n_u;
    int k, c0;
    wg_chunk_of(p, u < n_q ? u : u - n_q, k, c0);
    const bool affine = u < n_q && p.a != nullptr && c0 + 8 * j8 < p.c[k];
    const uint32_t dst = act0 + (U & 1) * tile_bytes;
    float av[8], bv[8];
    if (affine && cur_k < k_end) {
      const uint32_t ca = coef + ((U & 1) * 128 + 8 * j8) * 4;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(av[0]), "=f"(av[1]), "=f"(av[2]), "=f"(av[3]) : "r"(ca) : "memory");
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(av[4]), "=f"(av[5]), "=f"(av[6]), "=f"(av[7]) : "r"(ca + 16) : "memory");
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(bv[0]), "=f"(bv[1]), "=f"(bv[2]), "=f"(bv[3]) : "r"(ca + 256) : "memory");
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(bv[4]), "=f"(bv[5]), "=f"(bv[6]), "=f"(bv[7]) : "r"(ca + 272) : "memory");
    }
    for (; cur_k < min(k_end, n_mine); cursor_step()) {
      const int px = px0 + cur_k * (WG_THREADS / 8);
      const uint32_t o = px * 128 + ((j8 ^ (px & 7)) << 4);
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(raw + o)
                   : "memory");
      if (affine) {
        if constexpr (FILL_ACT) {
          v = act8(v, av, bv, p.apply_silu);  // a cell not loaded: act of its zero fill
        } else {
          const int ih = g.r0 - HALO + cur_row, iw = g.col0 - HALO + cur_col;
          bool loaded;
          if constexpr (BANDS)
            loaded = band_row(g.r0, cur_row, ih) >= 0 && iw >= 0 && iw < p.W;
          else
            loaded = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
          v = loaded ? act8(v, av, bv, p.apply_silu) : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if (PACKED) {
        // channels j and j + 4 of the group (one class, j = code) to staged
        // positions 16 code + 2 j8 and + 1: byte 32 code + 4 j8 of the row,
        // in its 16-byte group 2 code + j8 / 4
        const uint32_t row = dst + px * 128 + 4 * (j8 & 3);
        const int hi = j8 >> 2, sw = px & 7;
        st_shared_u32(row + (((0 + hi) ^ sw) << 4), __byte_perm(v.x, v.z, 0x5410));
        st_shared_u32(row + (((2 + hi) ^ sw) << 4), __byte_perm(v.x, v.z, 0x7632));
        st_shared_u32(row + (((4 + hi) ^ sw) << 4), __byte_perm(v.y, v.w, 0x5410));
        st_shared_u32(row + (((6 + hi) ^ sw) << 4), __byte_perm(v.y, v.w, 0x7632));
      } else {
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + o), "r"(v.x),
                     "r"(v.y), "r"(v.z), "r"(v.w)
                     : "memory");
      }
    }
  };

  // the part of chunk U + 1's staging done at turn `turn` of chunk U. The
  // two warpgroups take turns: warpgroup 0 activates its cells at turns 0-3
  // and warpgroup 1 at turns 4-7 (unpacked: taps 1-4 and 5-8, turn tap - 1;
  // packed: taps 0-1 and 2-3, turn kk / 2 at the odd k-steps kk), so that
  // while one stages, the other's products have the tensor cores; each
  // first waits for its raw cells and after its last part sends for chunk
  // U + 2's raw tile (and warpgroup 0 for its coefficients). At a tile's
  // last chunk this stages the next tile's first. A chunk of one tap (the
  // shortcut), and a serial probe after the products, stages all at once.
  auto stage_next = [&](int U, int turn, int n_taps) {
    if (U + 1 >= n_chunks) return;
    int part, n_parts = 1;
    if (n_taps == 1) {
      part = 0;
    } else {
      part = turn - 4 * wg;
      n_parts = 4;
      if (part < 0 || part >= 4) return;
    }
    if (part == 0) {
      cp_async_wait_all();
      cursor_reset();
    }
    activate(U + 1, (n_mine * (part + 1) + n_parts - 1) / n_parts);
    if (part == n_parts - 1 && U + 2 < n_chunks) {
      load_raw(U + 2);
      load_coef(U + 2);
    }
  };
  // the A fragments of k-step ks of one tap (staged offset toff) for each
  // m64 tile. The row's 128 bytes start at a multiple of 128 (the tile is
  // 1024-aligned), so row + (((2 ks + khalf) ^ (px & 7)) << 4) is a base
  // XOR (ks << 5)
  auto load_a = [&](uint32_t (&af)[MT][4], uint32_t tile, int toff, int ks) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int px = p0[mt] + toff;
      ldmatrix_x4(af[mt], ((tile + px * 128 + ((px & 7) << 4)) ^ (khalf << 4)) ^ (ks << 5));
    }
  };
  auto issue = [&](float (&acc)[MT][BN / 2], uint32_t (&af)[MT][4], int slot, int ks) {
    const uint64_t db = make_desc(ring + slot * SLOT + ks * 32, 16, 1024, 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wgmma_rs_k<BN>(acc[mt], af[mt], db);
  };

  // P1's copy (0 taps): chunk U's staged tile at `tile` out as y, 16 bytes
  // a thread at a time
  [[maybe_unused]] auto store_tile = [&](int U, uint32_t tile) {
    const Geo g = geo(U / n_u);
    int k, c0;
    wg_chunk_of(p, U % n_u, k, c0);
    for (int i = tid; i < tile_px * 8; i += WG_THREADS) {
      const int m = i >> 3, j = i & 7, c = c0 + 8 * j;
      const int oh = g.r0 + m / p.TW, ow = g.col0 + m % p.TW;
      if (oh >= p.H || ow >= p.W || c >= p.c[k]) continue;
      const int px = (m / p.TW + HALO) * SW + m % p.TW + HALO;
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(tile + px * 128 + ((j ^ (px & 7)) << 4))
                   : "memory");
      *reinterpret_cast<uint4*>(p.y + (((size_t)g.img * p.H + oh) * p.W + ow) * p.Cout + c) = v;
    }
  };

  float acc[MT][BN / 2];
  uint32_t af[2][MT][4];  // the A fragments of two k-steps
  int s = 0;  // weight slices taken so far
  produce(0);
  if constexpr (DIRECT) {
    // the raw tiles of chunks U + 1 and U + 2 in flight while chunk U's
    // products read chunk U's: buffer U % 3
    if (n_chunks > 0) load_raw(0);
    if (n_chunks > 1) load_raw(1);
  } else if (n_chunks > 0) {
    load_raw(0);
    load_coef(0);
    named_sync(1, WG_THREADS);  // chunk 0's coefficients
    cp_async_wait_all();
    cursor_reset();
    activate(0, n_mine);
    if (n_chunks > 1) {
      load_raw(1);
      load_coef(1);
    }
  }
  for (int i = 0; i < n_mine_tiles; ++i) {
    const Geo g = geo(i);
    for (int pass = 0; pass < (PROJ ? 2 : 1); ++pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[mt][e] = 0.f;
      const int n_taps = pass == 0 ? NTAPS : 1;
      for (int q = 0; q < n_q; ++q) {
        const int U = i * n_u + pass * n_q + q;
        uint32_t tile = act0 + (U & 1) * tile_bytes;
        if constexpr (DIRECT) {
          tile = act0 + (U % 3) * tile_bytes;
          if (U + 1 < n_chunks)  // chunk U's raw tile in (U + 1's may be in flight)
            cp_async_wait<1>();
          else
            cp_async_wait_all();
        }
        // chunk U's activated tile and chunk U + 1's coefficients complete;
        // both warpgroups done with the other tile, which chunk U + 1's
        // activation now fills
        named_sync(1, WG_THREADS);
        if constexpr (DIRECT)  // into the buffer that chunk U - 1 read
          if (U + 2 < n_chunks) load_raw(U + 2);
        if constexpr (NTAPS == 0) {
          store_tile(U, tile);
          stage_next(U, 0, 1);
          continue;
        }
        // k-step kk = 4 tap + ks of the chunk is one commit group; before
        // the A fragments of k-step kk + 1 go into the buffer that k-step
        // kk - 1 read, that group is waited for, so that two groups are in
        // flight while the next fragments load. A tap's slot is handed back
        // once its last group is done (at the next tap's first k-step).
        take(s);
        load_a(af[0], tile, pass == 0 ? tap_off(0, 0) : SW + 1, 0);
#pragma unroll
        for (int tap = 0; tap < NTAPS; ++tap) {
          if (tap >= n_taps) break;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int kk = 4 * tap + ks, b = kk & 1;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
            fence_frags<MT>(af[b]);
            wgmma_fence();
            issue(acc, af[b], (s + tap) % p.stages, ks);
            wgmma_commit();
            // under the products in flight: the staging's turns (see
            // stage_next), or all of it at the shortcut's one tap
            if constexpr (!SERIAL)
              if (TURNS4 ? (ks & 1) && (n_taps > 1 || kk == 1) : ks == 1)
                stage_next(U, TURNS4 ? kk >> 1 : tap - 1, n_taps);
            wgmma_wait<1>();  // k-step kk - 1 done: buffer b ^ 1 is free
            fence_frags<MT>(af[b ^ 1]);
            if (ks == 0 && tap > 0 && wl == 0) mbar_arrive(empty((s + tap - 1) % p.stages));
            if (kk + 1 < 4 * n_taps) {
              const int nt = (kk + 1) / 4;
              if (ks == 3) take(s + nt);
              load_a(af[b ^ 1], tile, pass == 0 ? tap_off(nt, (kk + 1) % 4) : SW + 1,
                     (kk + 1) % 4);
            }
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        fence_frags<MT>(af[0]);
        fence_frags<MT>(af[1]);
        if (wl == 0) mbar_arrive(empty((s + n_taps - 1) % p.stages));
        s += n_taps;
        if constexpr (SERIAL && !DIRECT) stage_next(U, 0, 1);  // after the products
      }
      if constexpr (NTAPS == 0) continue;  // P1's copy stores no products

      // epilogue. Accumulator entry 4 i + r of m64 tile mt holds row
      // (wg MT + mt) 64 + 16 warp + lane/4 + 8 (r / 2) and column
      // 8 i + 2 (lane % 4) + r % 2.
      const bool y_pass = pass == 0;
      const bool stats = y_pass && p.s1 != nullptr;
      __nv_bfloat16* out = y_pass ? p.y : p.proj;
      const float* ob = y_pass ? p.bias : p.pbias;
      size_t rowoff[MT][2];
      bool rowok[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (wg * MT + mt) * 64 + wwarp * 16 + h * 8 + (lane >> 2);
          const int oh = g.r0 + m / p.TW, ow = g.col0 + m % p.TW;
          rowok[mt][h] = m < tile_px && oh < p.H && ow < p.W;
          rowoff[mt][h] = (((size_t)g.img * p.H + oh) * p.W + ow) * p.Cout;
        }
#pragma unroll
      for (int e = 0; e < BN / 8; ++e) {
        const int n = g.n0 + 8 * e + 2 * (lane & 3);
        const bool colok = n < p.Cout;
        float bias0 = 0.f, bias1 = 0.f;
        if (colok && ob != nullptr) bias0 = ob[n], bias1 = ob[n + 1];
        float t1a = 0.f, t1b = 0.f, t2a = 0.f, t2b = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!(colok && rowok[mt][h])) continue;
            float v0 = acc[mt][4 * e + 2 * h] + bias0;
            float v1 = acc[mt][4 * e + 2 * h + 1] + bias1;
            const size_t o = rowoff[mt][h] + n;
            if (y_pass && p.residual != nullptr) {
              const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p.residual + o);
              v0 += __low2float(r);
              v1 += __high2float(r);
            }
            const __nv_bfloat162 st = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(out + o) = st;
            const float q0 = __low2float(st), q1 = __high2float(st);
            t1a += q0, t1b += q1, t2a += q0 * q0, t2b += q1 * q1;
          }
        if (stats) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {  // over the rows (lane / 4)
            t1a += __shfl_xor_sync(0xffffffffu, t1a, off);
            t1b += __shfl_xor_sync(0xffffffffu, t1b, off);
            t2a += __shfl_xor_sync(0xffffffffu, t2a, off);
            t2b += __shfl_xor_sync(0xffffffffu, t2b, off);
          }
          if (lane < 4 && colok) {
            const int nl = 8 * e + 2 * lane;
            atomicAdd(stat + nl, t1a);
            atomicAdd(stat + nl + 1, t1b);
            atomicAdd(stat + BN + nl, t2a);
            atomicAdd(stat + BN + nl + 1, t2b);
          }
        }
      }
      if (stats) {
        // the tile's sums out, and the buffer zeroed by the thread that read
        // it, for the block's next tile
        named_sync(1, WG_THREADS);
        if (tid < BN) {
          if (g.n0 + tid < p.Cout) {
            atomicAdd(p.s1 + (size_t)g.img * p.Cout + g.n0 + tid, stat[tid]);
            atomicAdd(p.s2 + (size_t)g.img * p.Cout + g.n0 + tid, stat[BN + tid]);
          }
          stat[tid] = stat[BN + tid] = 0.f;
        }
      }
    }
  }
}

// Dynamic shared memory of a launch: the ring, the two activated
// tiles and the raw tile, the barriers, two chunks' coefficients, the stats
// and the slack that aligns the ring.
size_t wg_smem_bytes(int bn, int th, int tw, int stages) {
  return 1024 + (size_t)stages * bn * 128 + 3 * (size_t)(th + 2) * (tw + 2) * 128 +
         16 * (size_t)stages + 1024 + 8 * (size_t)bn;
}

typedef void (*WgKernel)(const ConvParams);

// One launch of `kernel` (an instance of conv3x3_wgmma_kernel) on `stream`:
// its ConvParams from the operands and the plan (tile th x tw, N tile bn, mt
// m64 tiles a warpgroup, a ring of `stages` slots, `grid` persistent blocks,
// one a tile where grid <= 0), with toff (null: zeros) each in [0,
// max_toff] and n_ntiles N tiles (<= 0: Cout over bn). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan it does not take.
int launch_conv(WgKernel kernel, const void* const* xs, const int* cs, int n_ops, const void* a,
                const void* b, const void* wt, const void* bias, const void* residual,
                const void* pw, const void* pbias, void* y, void* proj, void* s1, void* s2, int B,
                int H, int W, int Cout, int apply_silu, int th, int tw, int bn, int mt,
                int stages, int grid, const int* toff, int max_toff, int n_ntiles,
                cudaStream_t stream) {
  if (th <= 0 || tw <= 0 || th * tw > 128 * mt || stages < 2 || stages > WG_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes(bn, th, tw, stages);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  ConvParams p;
  int ctot = 0, n_q = 0;
  for (int k = 0; k < MAX_OPS; ++k) {
    p.x[k] = nullptr;
    p.c[k] = p.off[k] = p.q0[k] = 0;
  }
  for (int k = 0; k < n_ops; ++k) {
    p.x[k] = (const __nv_bfloat16*)xs[k];
    p.c[k] = cs[k];
    p.off[k] = ctot;
    p.q0[k] = n_q;
    ctot += cs[k];
    n_q += (cs[k] + WG_BK - 1) / WG_BK;
  }
  p.q0[n_ops] = n_q;
  p.n_ops = n_ops;
  p.n_q = n_q;
  p.ctot = ctot;
  p.a = (const float*)a;
  p.b = (const float*)b;
  p.apply_silu = apply_silu;
  p.wt = (const __nv_bfloat16*)wt;
  p.pw = (const __nv_bfloat16*)pw;
  p.bias = (const float*)bias;
  p.pbias = (const float*)pbias;
  p.residual = (const __nv_bfloat16*)residual;
  p.y = (__nv_bfloat16*)y;
  p.proj = (__nv_bfloat16*)proj;
  p.s1 = (float*)s1;
  p.s2 = (float*)s2;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cout = Cout;
  p.cpad = (Cout + 63) / 64 * 64;
  p.TH = th;
  p.TW = tw;
  p.tiles_w = (W + tw - 1) / tw;
  p.tiles_per_image = ((H + th - 1) / th) * p.tiles_w;
  p.n_ntiles = n_ntiles > 0 ? n_ntiles : (Cout + bn - 1) / bn;
  p.stages = stages;
  for (int i = 0; i < 16; ++i) {
    p.toff[i] = toff != nullptr ? toff[i] : 0;
    // a shifted read stays inside the staged tile and its halo
    if (p.toff[i] < 0 || p.toff[i] > max_toff) return (int)cudaErrorInvalidValue;
  }
  // persistent: `grid` blocks walk the output tiles (grid <= 0: one a tile)
  const long long tiles = (long long)B * p.tiles_per_image * p.n_ntiles;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long blocks = grid > 0 && grid < tiles ? grid : tiles;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, WG_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
