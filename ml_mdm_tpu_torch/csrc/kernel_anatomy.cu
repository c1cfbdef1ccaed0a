// The fused conv's cost decomposition on Hopper (kernels P1 and P2): a
// stripped copy of K2 (csrc/fused_resnet.cu) that adds one of K2's features
// at a time, so that a timing of each variant splits K2's time between its
// products and its staging.
//
// Replaces the JAX package's two TPU probes of the same shape:
//   P1  tools/probe_kernel_anatomy.py::make   (n products of one tile,
//       optional affine, SiLU and staging through scratch)
//   P2  tools/probe_kernel_anatomy2.py::make  (4 row-shifted or
//       parity-selected products of act(x), with halo rows, lane-parity
//       selects, a zero fill and a double buffer)
//
// What each variant computes (ops/kernel_anatomy.py holds the plain
// version; this kernel equals it on every cell). x is (B, H, W, C) bf16,
// w the n taps' (C, C) matrices, act(v) = bf16(silu(v * 1.01 + 0.02)) in
// f32 (without SiLU when SILU is 0), products in f32, one rounding to bf16.
//   P1: y = sum_t src @ w[t], src = act(x) with ACT, else x; every tap
//       multiplies the same tile (no spatial shift); 0 taps give y = src.
//   P2: act(x) staged per band of TH = 16 rows with one padding row above
//       and below (and with SELECTS one padding column each side); tap t
//       reads the row shifted by t % 3 - 1 at the centre column, or with
//       SELECTS the four parity-selected buffers of K2·struct. With HALOS
//       the padding rows are the neighbouring image rows (clamped at the
//       image's top and bottom, as the probe clamps them), re-read from
//       global memory; every other padding cell is not loaded and holds
//       act(0), the activation of a zero-filled load, or 0 with ZERO (K2's
//       rule). DBUF (K2·pipe's double buffer) does not change y.
//
// The template flags, in order: PROBE (1 or 2), NTAPS (0, 1, 4, 9), ACT,
// SILU, STAGE (global -> registers -> act -> shared memory, K2's path;
// without it cp.async copies the raw tile, "direct"), HALOS, SELECTS, ZERO
// and DBUF. Only the 16 variants that the two probes run are instantiated.
//
// What bounds it on the H100: at 9 taps compute (2 B H W C^2 9 FLOP against
// x and y once: 0.3127 ms against 0.1603 ms at the probes' B = 4, 512^2,
// C = 128); at 4 taps and fewer the bytes. The design is K2's, so that each
// variant's time is a part of K2's: a block of 8 warps (4 along M x 2 along
// N, 32 x 32 each, mma.sync m16n8k16, f32 accumulators) owns TH x TW = 16 x
// 8 output pixels (one band of the probes' rows) times 64 output channels
// and walks the input channels in chunks of 32. Per chunk it stages the
// chunk's weights for every tap by cp.async (unpadded, K2's 16-byte
// swizzle) and the tile (pixels padded to 40 bf16, K2's bank-conflict-free
// stride), then runs the taps as shifted reads of the staged tile. With
// SELECTS each chunk's 32 channels are staged in K2·struct's parity-class
// order (channel i*4 + code at code*8 + i, code = ei*2 + ej), and the host
// lays the weights out in the same order; each k16 step then has one row
// parity and each fragment half one column parity. DBUF is K2·pipe: two
// buffers, chunk q+1's raw tile and weights in flight by cp.async (cells
// not loaded zero-filled) while chunk q's products run, then the
// activation in place (the same act8 as the staged path, and 0 after it
// for the cells not loaded with ZERO), so y is bitwise the single buffer's.
// The TPU probe's double buffer read the buffer that the previous grid step
// wrote (its output lags one block); a CUDA block shares nothing with the
// next one, and the buffers alternate over the chunks inside the block.
//
// The helpers (mma, cp.async, the swizzle, the warp's k16 step) are copies
// of K2's, so that K2's source and build stay as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;       // tile rows: one band of the probes' row blocks
constexpr int TW = 8;        // tile columns
constexpr int BM = TH * TW;  // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per reduction chunk
constexpr int KP = BK + 8;   // staged pixel stride (bf16 elements)
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N, 32x32 each

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 stores zeros
// and reads nothing.
__device__ __forceinline__ void cp_async_16(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                            int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(s), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Staged offset of the 16-byte group v of output channel n's weights.
__device__ __forceinline__ int swz(int n, int v) { return (v ^ ((n >> 1) & 3)) << 3; }

// One k16 step of the warp's 32x32 product: A rows at offsets k0 (k 0-7 of
// the step) and k1 (k 8-15) per m16 tile and half, B from bsm.
__device__ __forceinline__ void warp_mma_k16(float (&acc)[2][4][4], const __nv_bfloat16* as,
                                             const int (&k0)[2][2], const int (&k1)[2][2],
                                             const __nv_bfloat16* bsm, int wn, int g, int tig,
                                             int kk) {
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    af[mi][0] = lds32(as + k0[mi][0] + kk);
    af[mi][1] = lds32(as + k0[mi][1] + kk);
    af[mi][2] = lds32(as + k1[mi][0] + kk + 8);
    af[mi][3] = lds32(as + k1[mi][1] + kk + 8);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const __nv_bfloat16* bp = bsm + (wn * 32 + ni * 8 + g) * BK + tig * 2;
    const int sw = (g >> 1) & 3, v = kk >> 3;
    const uint32_t b0 = lds32(bp + ((v ^ sw) << 3)), b1 = lds32(bp + (((v + 1) ^ sw) << 3));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
  }
}

union Pack8 {
  uint4 u;
  unsigned short h[8];
};

// v * 1.01 + 0.02 (and SiLU) of 8 raw channels in f32, rounded to bf16 once.
template <int SILU>
__device__ __forceinline__ uint4 act8(const uint4 rawv) {
  Pack8 r, o;
  r.u = rawv;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float u = __bfloat162float(__ushort_as_bfloat16(r.h[j])) * 1.01f + 0.02f;
    if (SILU) u = u / (1.f + __expf(-u));
    o.h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(u));
  }
  return o.u;
}

// Store channels v*8 .. v*8+7 of a chunk into a staged pixel: in place, or
// with SELECTS at their parity-class positions (K2·struct's store8).
template <int SELECTS>
__device__ __forceinline__ void store8(__nv_bfloat16* cell, int v, const uint4 val) {
  if (SELECTS) {
    Pack8 p;
    p.u = val;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(cell + j * 8 + 2 * v) =
          (uint32_t)p.h[j] | ((uint32_t)p.h[j + 4] << 16);
  } else {
    *reinterpret_cast<uint4*>(cell + v * 8) = val;
  }
}

template <int PROBE, int SELECTS>
struct Geometry {
  static constexpr int SH = PROBE == 2 ? TH + 2 : TH;  // staged rows
  static constexpr int SW = SELECTS ? TW + 2 : TW;     // staged columns
  static constexpr int NST = SH * SW;                  // staged cells
};

template <int PROBE, int NTAPS, int SELECTS, int DBUF>
constexpr size_t smem_elems() {
  return (size_t)(Geometry<PROBE, SELECTS>::NST * KP + NTAPS * BN * BK) * (DBUF ? 2 : 1);
}

template <int PROBE, int NTAPS, int ACT, int SILU, int STAGE, int HALOS, int SELECTS, int ZERO,
          int DBUF>
__global__ void __launch_bounds__(THREADS)
kernel_anatomy(const __nv_bfloat16* __restrict__ x,   // (B, H, W, C)
               const __nv_bfloat16* __restrict__ wt,  // (C out, NTAPS, C in)
               __nv_bfloat16* __restrict__ y,         // (B, H, W, C)
               int H, int W, int C) {
  static_assert(NTAPS > 0 || (PROBE == 1 && !SELECTS), "0 taps: P1's copy of the tile");
  static_assert(!SELECTS || NTAPS == 4, "the parity selects are 4 products");
  static_assert(NTAPS > 0 || !DBUF, "the double buffer overlaps loads with products");
  using G = Geometry<PROBE, SELECTS>;
  constexpr int SW = G::SW, NST = G::NST;
  constexpr bool ASYNC = DBUF || !STAGE;  // the raw tile by cp.async
  constexpr bool IN_PLACE = ASYNC && (ACT || SELECTS);
  constexpr int BUF = NST * KP + NTAPS * BN * BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tiles_w = W / TW, tiles_per_image = (H / TH) * tiles_w;
  const int img = blockIdx.x / tiles_per_image;
  const int t = blockIdx.x % tiles_per_image;
  const int r0 = (t / tiles_w) * TH, col0 = (t % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* ximg = x + (size_t)img * H * W * C;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;

  // the image pixel (row * W + column) a staged cell loads, or -1 for a
  // padding cell that is not loaded
  auto source = [&](int cell) -> int {
    const int sr = cell / SW, sc = cell % SW;
    int ih = r0 + sr - (PROBE == 2 ? 1 : 0);
    const int iw = col0 + sc - (SELECTS ? 1 : 0);
    if (iw < 0 || iw >= W) return -1;
    if (PROBE == 2 && (sr == 0 || sr == TH + 1)) {
      if (!HALOS) return -1;
      ih = min(max(ih, 0), H - 1);
    }
    return ih * W + iw;
  };

  // the chunks: every 32 input channels for the products, or with 0 taps
  // the two chunks that are the block's own output channels
  const int n_chunks = NTAPS > 0 ? C / BK : min(BN, C - n0) / BK;
  auto chunk_c0 = [&](int q) { return NTAPS > 0 ? q * BK : n0 + q * BK; };

  // cp.async of chunk q's weights (and of its raw tile when ASYNC) into
  // buffer `buf`; one commit group
  auto issue = [&](int buf, int q) {
    const int c0 = chunk_c0(q);
    __nv_bfloat16* as = smem + buf * BUF;
    __nv_bfloat16* bs = as + NST * KP;
    for (int i = tid; i < NTAPS * BN * (BK / 8); i += THREADS) {
      const int v = i % (BK / 8), rest = i / (BK / 8);
      const int n = rest % BN, tap = rest / BN, co = n0 + n;
      const bool in = co < C;
      cp_async_16(bs + (tap * BN + n) * BK + swz(n, v),
                  in ? wt + (((size_t)co * NTAPS + tap) * C + c0 + v * 8) : wt, in ? 16 : 0);
    }
    if (ASYNC) {
      for (int i = tid; i < NST * (BK / 8); i += THREADS) {
        const int v = i % (BK / 8), cell = i / (BK / 8);
        const int p = source(cell);
        cp_async_16(as + (size_t)cell * KP + v * 8,
                    p >= 0 ? ximg + ((size_t)p * C + c0 + v * 8) : ximg, p >= 0 ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // global -> registers -> (act) -> shared memory (K2's staging)
  auto stage = [&](int q) {
    const int c0 = chunk_c0(q);
    for (int i = tid; i < NST * (BK / 8); i += THREADS) {
      const int v = i % (BK / 8), cell = i / (BK / 8);
      const int p = source(cell);
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (p >= 0) o = *reinterpret_cast<const uint4*>(ximg + ((size_t)p * C + c0 + v * 8));
      if (ACT) o = act8<SILU>(o);
      if (ZERO && p < 0) o = make_uint4(0u, 0u, 0u, 0u);
      store8<SELECTS>(smem + (size_t)cell * KP, v, o);
    }
  };

  // the landed raw tile of buffer `buf`, activated (and permuted) in place;
  // with SELECTS one thread permutes all 32 channels of a cell
  auto activate = [&](int buf) {
    __nv_bfloat16* as = smem + buf * BUF;
    constexpr int PER = SELECTS ? BK / 8 : 1;
    for (int i = tid; i < NST * (BK / 8) / PER; i += THREADS) {
      const int cell = SELECTS ? i : i / (BK / 8);
      const int v_first = SELECTS ? 0 : i % (BK / 8);
      const bool loaded = source(cell) >= 0;
      __nv_bfloat16* cp = as + (size_t)cell * KP;
      uint4 rawv[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) rawv[u] = *reinterpret_cast<const uint4*>(cp + (v_first + u) * 8);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        uint4 o = ACT ? act8<SILU>(rawv[u]) : rawv[u];
        if (ZERO && !loaded) o = make_uint4(0u, 0u, 0u, 0u);
        store8<SELECTS>(cp, v_first + u, o);
      }
    }
  };

  // staged offsets of the 4 pixels this thread's A fragments read, at the
  // staged tile's top-left (rows g and g + 8 of the warp's two m16 tiles)
  int pix[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm * 32 + mi * 16 + hf * 8 + g;
      pix[mi][hf] = ((m / TW) * SW + (m % TW)) * KP + tig * 2;
    }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // the chunk's products from buffer `buf`
  auto products = [&](int buf) {
    const __nv_bfloat16* as = smem + buf * BUF;
    const __nv_bfloat16* bs = as + NST * KP;
    if (SELECTS) {
      // K2·struct's 4 products: centre, column select, row select, both;
      // each k16 step one row parity (kk 0: ei 0, below; kk 16: ei 1,
      // above), k 0-7 column parity ej 0 (right), k 8-15 ej 1 (left)
#pragma unroll 1
      for (int prod = 0; prod < 4; ++prod) {
        const int rsel = prod >> 1, csel = prod & 1;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          const int dr = rsel ? (kk ? -1 : 1) : 0;
          const int base = (1 + dr) * SW + 1;
          const int o0 = (base + csel) * KP, o1 = (base - csel) * KP;
          int k0[2][2], k1[2][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              k0[mi][hf] = pix[mi][hf] + o0;
              k1[mi][hf] = pix[mi][hf] + o1;
            }
          warp_mma_k16(acc, as, k0, k1, bs + prod * BN * BK, wn, g, tig, kk);
        }
      }
    } else {
#pragma unroll 1
      for (int tap = 0; tap < NTAPS; ++tap) {
        // P1: every tap the same tile; P2: staged row tap % 3 (above,
        // centre, below, above)
        const int toff = PROBE == 2 ? (tap % 3) * SW * KP : 0;
        int aoff[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) aoff[mi][hf] = pix[mi][hf] + toff;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16)
          warp_mma_k16(acc, as, aoff, aoff, bs + tap * BN * BK, wn, g, tig, kk);
      }
    }
  };

  // 0 taps: the staged chunk (P1's tile, unpadded) straight out as y
  auto copy_out = [&](int q) {
    const int c0 = chunk_c0(q);
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int v = i % (BK / 8), m = i / (BK / 8);
      const size_t o = (((size_t)img * H + r0 + m / TW) * W + col0 + m % TW) * C + c0 + v * 8;
      *reinterpret_cast<uint4*>(y + o) = *reinterpret_cast<const uint4*>(smem + m * KP + v * 8);
    }
  };

  if constexpr (!DBUF) {
    for (int q = 0; q < n_chunks; ++q) {
      issue(0, q);
      if (!ASYNC) stage(q);
      cp_async_wait_all();
      __syncthreads();
      if (IN_PLACE) {
        activate(0);
        __syncthreads();
      }
      if (NTAPS > 0)
        products(0);
      else
        copy_out(q);
      __syncthreads();
    }
  } else {
    issue(0, 0);
    cp_async_wait_all();
    __syncthreads();
    if (IN_PLACE) activate(0);
    __syncthreads();
    for (int q = 0; q < n_chunks; ++q) {
      const int cur = q & 1;
      const bool more = q + 1 < n_chunks;
      if (more) issue(cur ^ 1, q + 1);  // in flight during the products
      products(cur);
      if (more) {
        cp_async_wait_all();
        __syncthreads();
        if (IN_PLACE) activate(cur ^ 1);
      }
      __syncthreads();
    }
  }
  if constexpr (NTAPS > 0) {
    // epilogue: one rounding of the f32 sums to bf16
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = wm * 32 + mi * 16 + hf * 8 + g;
        const size_t pbase = (((size_t)img * H + r0 + m / TW) * W + col0 + m % TW) * C;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn * 32 + ni * 8 + tig * 2;
          if (n >= C) continue;
          *reinterpret_cast<__nv_bfloat162*>(y + pbase + n) =
              __floats2bfloat162_rn(acc[mi][ni][hf * 2], acc[mi][ni][hf * 2 + 1]);
        }
      }
    }
  }
}

typedef void (*KernelFn)(const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int, int,
                         int);

struct Instance {
  int flags[9];  // probe, taps, act, silu, stage, halos, selects, zero, dbuf
  KernelFn fn;
  size_t smem;   // dynamic shared memory, bytes
};

#define ANATOMY(P, N, A, S, ST, HA, SE, Z, D)                                      \
  {{P, N, A, S, ST, HA, SE, Z, D}, kernel_anatomy<P, N, A, S, ST, HA, SE, Z, D>, \
   smem_elems<P, N, SE, D>() * sizeof(__nv_bfloat16)}

// the rows of the two probes' tables, in their order
const Instance kInstances[] = {
    // P1: taps, act, silu, staging
    ANATOMY(1, 9, 0, 0, 0, 0, 0, 0, 0),  // dots direct from input block
    ANATOMY(1, 4, 0, 0, 0, 0, 0, 0, 0),  // dots direct, 4 taps
    ANATOMY(1, 1, 0, 0, 0, 0, 0, 0, 0),  // dots direct, 1 tap
    ANATOMY(1, 9, 0, 0, 1, 0, 0, 0, 0),  // copy->scratch + 9 dots
    ANATOMY(1, 9, 1, 0, 1, 0, 0, 0, 0),  // act->scratch + 9 dots
    ANATOMY(1, 9, 1, 1, 1, 0, 0, 0, 0),  // act+silu->scratch + 9 dots
    ANATOMY(1, 4, 1, 1, 1, 0, 0, 0, 0),  // act+silu->scratch + 4 dots
    ANATOMY(1, 0, 1, 1, 1, 0, 0, 0, 0),  // act+silu only (0 dots)
    ANATOMY(1, 0, 0, 0, 1, 0, 0, 0, 0),  // pure copy through scratch
    // P2: 4 products of act+silu, halos, selects, zero fill, double buffer
    ANATOMY(2, 4, 1, 1, 1, 0, 0, 0, 0),  // base: 4 dots, single buf
    ANATOMY(2, 4, 1, 1, 1, 1, 0, 0, 0),  // +halos
    ANATOMY(2, 4, 1, 1, 1, 0, 1, 0, 0),  // +selects
    ANATOMY(2, 4, 1, 1, 1, 0, 0, 1, 0),  // +when_zero
    ANATOMY(2, 4, 1, 1, 1, 0, 0, 0, 1),  // +dbuf
    ANATOMY(2, 4, 1, 1, 1, 1, 1, 0, 0),  // halos+selects
    ANATOMY(2, 4, 1, 1, 1, 1, 1, 1, 1),  // ALL (the real kernel's shape)
};

#undef ANATOMY

}  // namespace

extern "C" {

// x and y (B, H, W, C) bf16, 16-byte aligned; wt (C, taps, C) bf16: each
// output channel's taps x input channels (with selects each 32-channel
// chunk of input channels in parity-class order), unused with 0 taps.
// flags: probe, taps, act, silu, stage, halos, selects, zero, dbuf, one of
// the instantiated rows. H a multiple of 16, W of 8, C a positive multiple
// of 32. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or variant it does not take.
int ml_mdm_kernel_anatomy(const int* flags, const void* x, const void* wt, void* y, int B, int H,
                          int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H % TH != 0 || W % TW != 0 || C % BK != 0)
    return (int)cudaErrorInvalidValue;
  const Instance* inst = nullptr;
  for (const Instance& cand : kInstances) {
    bool same = true;
    for (int i = 0; i < 9; ++i) same = same && cand.flags[i] == flags[i];
    if (same) inst = &cand;
  }
  if (inst == nullptr) return (int)cudaErrorInvalidValue;
  KernelFn kernel = inst->fn;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)inst->smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * (H / TH) * (W / TW), (C + BN - 1) / BN);
  kernel<<<grid, THREADS, inst->smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (__nv_bfloat16*)y, H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
