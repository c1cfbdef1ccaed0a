// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (kernel K2),
// with N operands (K2·N), the 1x1 shortcut as a second output (K2·proj), the
// space-to-depth packed mode (K2·struct) and the software-pipelined variant
// (K2·pipe).
//
// Replaces ml_mdm_tpu/ops/fused_resnet.py::affine_silu_conv3x3 (the Pallas
// `_kernel` and `_kernel_pipelined` bodies, their tuple operands, their
// `emit_proj` output and their `packed_struct` taps, `_struct_dots`):
//
//   y    = conv3x3(concat_k silu(x_k * a_k + b_k), w, padding 1) + bias [+ residual]
//   proj = concat_k(x_k) @ P + pb                       (optional, raw x_k)
//
// over NHWC bf16 activations, with a and b per-(batch, channel) f32
// coefficients (GroupNorm with FiLM folded in), f32 accumulation and one
// rounding to bf16 at each store. The concatenation never exists in memory:
// the reduction walks the channel chunks of operand 0, then operand 1, ...,
// into the same accumulators. With stats != nullptr it also adds the f32
// sum and sum of squares of the STORED (rounded) y, per (batch, output
// channel), into two zeroed (B, Cout) buffers.
//
// What bounds it on the H100: compute. Every output pixel takes 9*C*Cout
// multiply-adds against about 2*(C + Cout) bytes of activation traffic,
// which is over 1,000 operations per byte at the wide shapes, far above the
// card's ~295 bf16 operations per byte of HBM bandwidth. The thinnest
// shells (C = 32-64) sit near that line, and at Cout = 32 half of the
// 64-channel output tile is idle; packed, those shells run at 128-256
// channels.
//
// Design: a direct (implicit-GEMM) convolution on bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulators). A block of 8 warps owns a 2-D
// tile of TH x TW output pixels (TW = min(W, 32), TH = 128 / TW, so up to
// BM = 128 pixels) of one image times BN = 64 output channels. For each
// chunk of BK = 32 channels of one operand the block
//   1. stages the (TH + 2) x (TW + 2) input pixels its tile touches (one
//      halo row and column each side, never whole rows, so any width
//      launches), applying x*a+b and SiLU in f32 and rounding to bf16 once
//      per element (not once per tap). Out-of-image pixels are stored as 0:
//      the convolution pads the ACTIVATED tensor, so the border is 0 and
//      not silu(0*a+b);
//   2. stages the chunk's weights for all taps;
//   3. runs the taps as shifted reads of the staged activations.
// After y is stored, the shortcut runs as a second, short reduction over
// the same chunks: the tile's RAW pixels and the chunk's slice of P are
// staged and multiplied into the same (now free) accumulators. Keeping one
// accumulator set keeps the kernel at ~100 registers and two blocks per SM;
// a second set beside the first took 146 and one block per SM. The second
// pass re-reads 1/9 of what the first staged, mostly from L2.
// Padding each staged pixel to KP = 40 bf16 (80 bytes) makes the fragment
// loads of 8 consecutive pixels hit 32 distinct banks. The weights are
// staged unpadded, 64 bytes an output channel, with the four 16-byte groups
// of channel n stored at group v ^ ((n >> 1) & 3): the B-fragment loads of
// 8 consecutive output channels then hit 32 distinct banks too, in 20% less
// shared memory (two pipelined buffers of 9 taps fit two blocks on an SM).
//
// K2·struct (STRUCT): x is a space-to-depth packed tensor (channel c*4 +
// ei*2 + ej holds sub-pixel (ei, ej) of unpacked channel c) and w the
// packed kernel collapsed to 4 combined taps (the JAX `_struct_weights`):
// the packed 3x3 kernel is 75% structural zeros, so its 9 taps reduce to 4
// products over the same staged tile: centre x centre, centre x column
// select, row select x centre, row select x column select. A row select
// reads, for each channel, the pixel above when its ei bit is 1 and the one
// below when it is 0; a column select the pixel left (ej = 1) or right
// (ej = 0). One 32-bit A-fragment register holds two adjacent channels,
// which differ in ej, so the staging permutes each chunk's 32 channels by
// parity class: staged position code*8 + i holds channel i*4 + code, with
// code = ei*2 + ej. Each k16 step then sees one ei (0 for k 0-15, 1 for
// 16-31), each fragment half one ej, and every 32-bit load reads one pixel.
// The host lays the combined weights out in the same order. Every operand
// of a STRUCT launch has a multiple of 32 channels. 4 products per chunk
// against 9 is 16/9 of an unpacked launch's tensor-core work on the same
// image, at full tile width.
//
// K2·pipe (PIPE): the counterpart of `_kernel_pipelined`, over channel
// chunks in place of the TPU's row blocks. Two shared-memory buffers: while
// the tensor cores run chunk q from one, cp.async brings chunk q+1's raw
// tile, halo and weights into the other (out-of-image cells and weights
// past Cout are zero-filled, src-size 0); then the block waits and applies
// affine and SiLU to chunk q+1 in place, masking out-of-image cells to 0
// AFTER the activation. y, the stats and the shortcut are the serial
// kernel's: the same activated values in the same chunk and tap order. The
// JAX variant's garbage first step and NaN-safe stats reset have no
// counterpart; the caller zeroes the stats.
//
// The Pallas kernel accumulated the stats in one output block that the
// sequential TPU grid revisits. Hopper blocks run in no order, so here each
// warp reduces its partial sums with shuffles and adds them to the (B, Cout)
// buffers with f32 atomics. Atomic order varies between runs, so the stats
// agree with a sequential sum to f32 rounding of the total, not bitwise.
//
// No TMA and no wgmma yet: this is the simple, right version; making it
// fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block (at most)
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per reduction chunk
constexpr int KP = BK + 8;   // staged pixel stride (bf16 elements)
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int MAX_OPS = 4;   // operands of one launch
constexpr int MAX_TW = 32;   // tile width in pixels

struct Operands {
  const __nv_bfloat16* x[MAX_OPS];  // (B, H, W, c[k])
  int c[MAX_OPS];                   // channels of operand k
  int off[MAX_OPS];                 // its first channel in the concatenation
  int n;
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
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

// One k16 step of the warp's 32x32 product. A rows at offsets `k0` (k
// 0-7 of the step) and `k1` (k 8-15), per m16 tile and half (pixel rows g
// and g + 8); B from `bsm`. Unpacked taps read one pixel for both halves;
// K2·struct's column select reads another pixel per half.
__device__ __forceinline__ void warp_mma_k16(float (&acc)[2][4][4],
                                             const __nv_bfloat16* asm_,
                                             const int (&k0)[2][2], const int (&k1)[2][2],
                                             const __nv_bfloat16* bsm,
                                             int wn, int g, int tig, int kk) {
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    af[mi][0] = lds32(asm_ + k0[mi][0] + kk);
    af[mi][1] = lds32(asm_ + k0[mi][1] + kk);
    af[mi][2] = lds32(asm_ + k1[mi][0] + kk + 8);
    af[mi][3] = lds32(asm_ + k1[mi][1] + kk + 8);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    // output channel wn*32 + ni*8 + g, whose swizzle is (g >> 1) & 3
    const __nv_bfloat16* bp = bsm + (wn * 32 + ni * 8 + g) * BK + tig * 2;
    const int sw = (g >> 1) & 3, v = kk >> 3;
    const uint32_t b0 = lds32(bp + ((v ^ sw) << 3)), b1 = lds32(bp + (((v + 1) ^ sw) << 3));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
  }
}

// 8 bf16 values in one 16-byte register group.
union Pack8 {
  uint4 u;
  unsigned short h[8];
};

// x*a+b (and SiLU) of 8 raw channels in f32, rounded to bf16 once.
__device__ __forceinline__ uint4 act8(const uint4 rawv, const float* ap, const float* bp,
                                      int apply_silu) {
  Pack8 r, o;
  r.u = rawv;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float u = __bfloat162float(__ushort_as_bfloat16(r.h[j])) * __ldg(ap + j) + __ldg(bp + j);
    if (apply_silu) u = u / (1.f + __expf(-u));
    o.h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(u));
  }
  return o.u;
}

// Store the 8 activated channels v*8 .. v*8+7 of a chunk into a staged
// pixel: in place, or for K2·struct at their parity-class positions
// (channel i*4 + code -> code*8 + i; channels j and j + 4 of the 8 share a
// class and land side by side).
template <bool STRUCT>
__device__ __forceinline__ void store8(__nv_bfloat16* cell, int v, const uint4 val) {
  if (STRUCT) {
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

// The tensor-core products of one staged chunk: 9 shifted taps, or the 4
// K2·struct products. `pix` are the staged offsets of the fragment rows at
// the tile's top-left tap.
template <bool STRUCT>
__device__ __forceinline__ void chunk_products(float (&acc)[2][4][4], const __nv_bfloat16* As,
                                               const __nv_bfloat16* Bs, const int (&pix)[2][2],
                                               int SW, int wn, int g, int tig) {
  if (STRUCT) {
#pragma unroll 1
    for (int prod = 0; prod < 4; ++prod) {
      const int rsel = prod >> 1, csel = prod & 1;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        // ei = kk / 16: the row select reads above (ei 1) or below (ei 0);
        // k 0-7 of the step have ej 0 (right), k 8-15 ej 1 (left)
        const int dr = rsel ? (kk ? -1 : 1) : 0;
        const int base = (1 + dr) * SW + 1;
        const int o0 = (base + (csel ? 1 : 0)) * KP, o1 = (base - (csel ? 1 : 0)) * KP;
        int k0[2][2], k1[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            k0[mi][hf] = pix[mi][hf] + o0;
            k1[mi][hf] = pix[mi][hf] + o1;
          }
        warp_mma_k16(acc, As, k0, k1, Bs + prod * BN * BK, wn, g, tig, kk);
      }
    }
  } else {
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * SW + (tap % 3)) * KP;
      int aoff[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) aoff[mi][hf] = pix[mi][hf] + toff;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16)
        warp_mma_k16(acc, As, aoff, aoff, Bs + tap * BN * BK, wn, g, tig, kk);
    }
  }
}

// Staged offset of the 16-byte group v (channels v*8 .. v*8+7) of output
// channel n's chunk of weights (see the header).
__device__ __forceinline__ int swz(int n, int v) { return (v ^ ((n >> 1) & 3)) << 3; }

// Operand and first channel of chunk q of the launch.
__device__ __forceinline__ void chunk_of(const Operands& ops, int q, int& k, int& c0) {
  k = 0;
  while (k < ops.n - 1 && q >= (ops.c[k] + BK - 1) / BK) {
    q -= (ops.c[k] + BK - 1) / BK;
    ++k;
  }
  c0 = q * BK;
}

template <bool PROJ, bool STRUCT, bool PIPE>
__global__ void __launch_bounds__(THREADS)
affine_silu_conv3x3_kernel(const Operands ops, int ctot, int n_chunks,
                           const float* __restrict__ a,            // (B, ctot)
                           const float* __restrict__ b,            // (B, ctot)
                           const __nv_bfloat16* __restrict__ wt,   // (Cout, NT, ctot)
                           const float* __restrict__ bias,         // (Cout)
                           const __nv_bfloat16* __restrict__ residual,
                           const __nv_bfloat16* __restrict__ pw,   // (Cout, ctot)
                           const float* __restrict__ pbias,        // (Cout)
                           __nv_bfloat16* __restrict__ y,
                           __nv_bfloat16* __restrict__ proj,
                           float* __restrict__ s1,
                           float* __restrict__ s2,
                           int H, int W, int Cout, int TH, int TW,
                           int tiles_w, int tiles_per_image, int apply_silu) {
  constexpr int NT = STRUCT ? 4 : 9;   // taps (or struct products) per chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SW = TW + 2;               // staged row width
  const int n_stage = (TH + 2) * SW;   // staged pixels
  const int tile_px = TH * TW;         // <= BM
  const int buf_elems = n_stage * KP + NT * BN * BK;  // one buffer: tile + weights
  const int img = blockIdx.x / tiles_per_image;
  const int t = blockIdx.x % tiles_per_image;
  const int r0 = (t / tiles_w) * TH;
  const int col0 = (t % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;

  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // buffer i: As [n_stage][KP] then Bs [NT][BN][BK] (swizzled); the
  // shortcut pass reuses the start of buffer 0 once the conv is done
  __nv_bfloat16* Rs = smem;                // [BM][KP] raw tile pixels (PROJ)
  __nv_bfloat16* Ps = Rs + BM * KP;        // [BN][BK] shortcut weights (PROJ)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;

  // staged offsets of the 4 pixels this thread's A fragments read: rows g
  // and g + 8 of the warp's two m16 tiles, at tap dy = dx = 0 (pix) and in
  // the raw tile (raw). Rows past the tile repeat its last pixel; their
  // results are never stored.
  int pix[2][2], raw[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = min(wm * 32 + mi * 16 + hf * 8 + g, tile_px - 1);
      pix[mi][hf] = ((m / TW) * SW + (m % TW)) * KP + tig * 2;
      raw[mi][hf] = m * KP + tig * 2;
    }
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const float* a_img = a + (size_t)img * ctot;
  const float* b_img = b + (size_t)img * ctot;
  const int nvb = NT * BN * (BK / 8);      // 16-byte weight vectors per chunk

  if (!PIPE) {
    for (int q = 0; q < n_chunks; ++q) {
      int k, c0;
      chunk_of(ops, q, k, c0);
      const int ck = ops.c[k], offk = ops.off[k];
      const __nv_bfloat16* xk = ops.x[k] + (size_t)img * H * W * ck;
      __nv_bfloat16* As = smem;
      __nv_bfloat16* Bs = As + n_stage * KP;
      // 1. activated tile + halo, 8 channels (16 bytes) per step
      for (int i = tid; i < n_stage * (BK / 8); i += THREADS) {
        const int v = i % (BK / 8);
        const int cell = i / (BK / 8);
        const int sr = cell / SW, sc = cell % SW;
        const int ih = r0 - 1 + sr, iw = col0 - 1 + sc;
        const int c = c0 + v * 8;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < ck) {
          const uint4 rawv =
              *reinterpret_cast<const uint4*>(xk + (((size_t)ih * W + iw) * ck + c));
          o = act8(rawv, a_img + offk + c, b_img + offk + c, apply_silu);
        }
        store8<STRUCT>(As + (size_t)cell * KP, v, o);
      }
      // 2. weights of the chunk for every tap
      for (int i = tid; i < nvb; i += THREADS) {
        const int v = i % (BK / 8);
        const int rest = i / (BK / 8);
        const int n = rest % BN, tap = rest / BN;
        const int c = c0 + v * 8, co = n0 + n;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (co < Cout && c < ck)
          val = *reinterpret_cast<const uint4*>(wt + (((size_t)co * NT + tap) * ctot + offk + c));
        *reinterpret_cast<uint4*>(Bs + (tap * BN + n) * BK + swz(n, v)) = val;
      }
      __syncthreads();
      // 3. the chunk's tensor-core products
      chunk_products<STRUCT>(acc, As, Bs, pix, SW, wn, g, tig);
      __syncthreads();
    }
  } else {
    // cp.async of chunk q's raw tile, halo and weights into buffer `buf`
    auto issue = [&](int buf, int q) {
      int k, c0;
      chunk_of(ops, q, k, c0);
      const int ck = ops.c[k], offk = ops.off[k];
      const __nv_bfloat16* xk = ops.x[k] + (size_t)img * H * W * ck;
      __nv_bfloat16* As = smem + buf * buf_elems;
      __nv_bfloat16* Bs = As + n_stage * KP;
      for (int i = tid; i < n_stage * (BK / 8); i += THREADS) {
        const int v = i % (BK / 8);
        const int cell = i / (BK / 8);
        const int ih = r0 - 1 + cell / SW, iw = col0 - 1 + cell % SW;
        const int c = c0 + v * 8;
        const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W && c < ck;
        cp_async_16(As + (size_t)cell * KP + v * 8,
                    in ? xk + (((size_t)ih * W + iw) * ck + c) : xk, in ? 16 : 0);
      }
      for (int i = tid; i < nvb; i += THREADS) {
        const int v = i % (BK / 8);
        const int rest = i / (BK / 8);
        const int n = rest % BN, tap = rest / BN;
        const int c = c0 + v * 8, co = n0 + n;
        const bool in = co < Cout && c < ck;
        cp_async_16(Bs + (tap * BN + n) * BK + swz(n, v),
                    in ? wt + (((size_t)co * NT + tap) * ctot + offk + c) : wt, in ? 16 : 0);
      }
      cp_async_commit();
    };
    // affine + SiLU of the landed chunk q in buffer `buf`, in place; cells
    // outside the image (and channels past the operand) become 0 after it
    auto activate = [&](int buf, int q) {
      int k, c0;
      chunk_of(ops, q, k, c0);
      const int ck = ops.c[k], offk = ops.off[k];
      __nv_bfloat16* As = smem + buf * buf_elems;
      // K2·struct permutes all 32 channels of a pixel: one thread a pixel;
      // otherwise one thread per 8 channels of a pixel
      const int per = STRUCT ? BK / 8 : 1;
      for (int i = tid; i < n_stage * (BK / 8) / per; i += THREADS) {
        const int cell = STRUCT ? i : i / (BK / 8);
        const int v_first = STRUCT ? 0 : i % (BK / 8);
        const int ih = r0 - 1 + cell / SW, iw = col0 - 1 + cell % SW;
        const bool in_img = ih >= 0 && ih < H && iw >= 0 && iw < W;
        __nv_bfloat16* cp = As + (size_t)cell * KP;
        uint4 rawv[BK / 8];
#pragma unroll
        for (int u = 0; u < per; ++u) rawv[u] = *reinterpret_cast<const uint4*>(cp + (v_first + u) * 8);
#pragma unroll
        for (int u = 0; u < per; ++u) {
          const int v = v_first + u, c = c0 + v * 8;
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (in_img && c < ck) o = act8(rawv[u], a_img + offk + c, b_img + offk + c, apply_silu);
          store8<STRUCT>(cp, v, o);
        }
      }
    };

    issue(0, 0);
    cp_async_wait_all();
    __syncthreads();
    activate(0, 0);
    __syncthreads();
    for (int q = 0; q < n_chunks; ++q) {
      const int cur = q & 1;
      const bool more = q + 1 < n_chunks;
      if (more) issue(cur ^ 1, q + 1);  // in flight during the products
      const __nv_bfloat16* As = smem + cur * buf_elems;
      chunk_products<STRUCT>(acc, As, As + n_stage * KP, pix, SW, wn, g, tig);
      if (more) {
        cp_async_wait_all();
        __syncthreads();
        activate(cur ^ 1, q + 1);
      }
      __syncthreads();
    }
  }

  // epilogue: + bias (+ residual) in f32, one rounding, stats of the
  // stored value squared in f32; the shortcut + pb in f32, one rounding
  float t1[4][2], t2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) t1[ni][0] = t1[ni][1] = t2[ni][0] = t2[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm * 32 + mi * 16 + hf * 8 + g;
      if (m >= tile_px) continue;
      const int oh = r0 + m / TW, ow = col0 + m % TW;
      if (oh >= H || ow >= W) continue;
      const size_t pbase = (((size_t)img * H + oh) * W + ow) * Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + tig * 2;
        if (n >= Cout) continue;
        const size_t o = pbase + n;
        float v0 = acc[mi][ni][hf * 2] + bias[n];
        float v1 = acc[mi][ni][hf * 2 + 1] + bias[n + 1];
        if (residual != nullptr) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(residual + o);
          v0 += __low2float(r);
          v1 += __high2float(r);
        }
        const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(y + o) = out;
        const float q0 = __low2float(out), q1 = __high2float(out);
        t1[ni][0] += q0;
        t1[ni][1] += q1;
        t2[ni][0] += q0 * q0;
        t2[ni][1] += q1 * q1;
      }
    }
  }
  if (s1 != nullptr) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float u1 = t1[ni][j], u2 = t2[ni][j];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // sum over g (same tig)
          u1 += __shfl_xor_sync(0xffffffffu, u1, off);
          u2 += __shfl_xor_sync(0xffffffffu, u2, off);
        }
        const int n = n0 + wn * 32 + ni * 8 + tig * 2 + j;
        if (g == 0 && n < Cout) {
          atomicAdd(s1 + (size_t)img * Cout + n, u1);
          atomicAdd(s2 + (size_t)img * Cout + n, u2);
        }
      }
    }
  }
  if (!PROJ) return;

  // the shortcut: raw tile pixels x P over the same chunks, in acc again
  // (channels in their own order: P is a plain matrix in every mode)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
  for (int k = 0; k < ops.n; ++k) {
    const int ck = ops.c[k], offk = ops.off[k];
    const __nv_bfloat16* xk = ops.x[k] + (size_t)img * H * W * ck;
    for (int c0 = 0; c0 < ck; c0 += BK) {
      for (int i = tid; i < tile_px * (BK / 8); i += THREADS) {
        const int v = i % (BK / 8), m = i / (BK / 8);
        const int ih = r0 + m / TW, iw = col0 + m % TW, c = c0 + v * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (ih < H && iw < W && c < ck)
          val = *reinterpret_cast<const uint4*>(xk + (((size_t)ih * W + iw) * ck + c));
        *reinterpret_cast<uint4*>(Rs + m * KP + v * 8) = val;
      }
      for (int i = tid; i < BN * (BK / 8); i += THREADS) {
        const int v = i % (BK / 8), n = i / (BK / 8);
        const int c = c0 + v * 8, co = n0 + n;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (co < Cout && c < ck)
          val = *reinterpret_cast<const uint4*>(pw + ((size_t)co * ctot + offk + c));
        *reinterpret_cast<uint4*>(Ps + n * BK + swz(n, v)) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) warp_mma_k16(acc, Rs, raw, raw, Ps, wn, g, tig, kk);
      __syncthreads();
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm * 32 + mi * 16 + hf * 8 + g;
      if (m >= tile_px) continue;
      const int oh = r0 + m / TW, ow = col0 + m % TW;
      if (oh >= H || ow >= W) continue;
      const size_t pbase = (((size_t)img * H + oh) * W + ow) * Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + tig * 2;
        if (n >= Cout) continue;
        *reinterpret_cast<__nv_bfloat162*>(proj + pbase + n) = __floats2bfloat162_rn(
            acc[mi][ni][hf * 2] + pbias[n], acc[mi][ni][hf * 2 + 1] + pbias[n + 1]);
      }
    }
  }
}

typedef void (*KernelFn)(const Operands, int, int, const float*, const float*,
                         const __nv_bfloat16*, const float*, const __nv_bfloat16*,
                         const __nv_bfloat16*, const float*, __nv_bfloat16*, __nv_bfloat16*,
                         float*, float*, int, int, int, int, int, int, int, int);

template <bool PROJ>
KernelFn pick_kernel(int packed_struct, int pipelined) {
  if (packed_struct)
    return pipelined ? affine_silu_conv3x3_kernel<PROJ, true, true>
                     : affine_silu_conv3x3_kernel<PROJ, true, false>;
  return pipelined ? affine_silu_conv3x3_kernel<PROJ, false, true>
                   : affine_silu_conv3x3_kernel<PROJ, false, false>;
}

}  // namespace

extern "C" {

// Tile of a launch for a row width W: TW = min(W, 32) columns by
// TH = 128 / TW rows.
static void tile_shape(int W, int* th, int* tw) {
  *tw = W < MAX_TW ? W : MAX_TW;
  *th = BM / *tw;
}

// Dynamic shared memory a launch needs, in bytes: one buffer of the
// staged tile and the chunk's weights (53,184 at W >= 32 with 9 taps,
// 32,704 with the 4 struct products), two with `pipelined`. The shortcut
// pass fits in the first buffer.
static size_t smem_bytes(int W, int packed_struct, int pipelined) {
  int th, tw;
  tile_shape(W, &th, &tw);
  const size_t elems = (size_t)(th + 2) * (tw + 2) * KP + (packed_struct ? 4 : 9) * BN * BK;
  return elems * sizeof(__nv_bfloat16) * (pipelined ? 2 : 1);
}

// xs[n_ops]: operands (B,H,W,cs[k]) bf16, 16-byte aligned; a, b (B, sum cs)
// f32; wt (Cout, 9, sum cs) bf16, or with packed_struct the combined taps
// (Cout, 4, sum cs) with each 32-channel chunk in parity-class order; bias
// (Cout) f32; residual (B,H,W,Cout) bf16 or null; pw (Cout, sum cs) bf16 and
// pbias (Cout) f32, or both null; y and proj (B,H,W,Cout) bf16 (proj null
// without pw); s1, s2 (B,Cout) f32, zeroed by the caller, or both null.
// 1 <= n_ops <= 4, every cs[k] and Cout a positive multiple of 8 (of 32 for
// every cs[k] with packed_struct). Launches on `stream` and returns
// cudaGetLastError().
int ml_mdm_affine_silu_conv3x3(const void* const* xs, const int* cs, int n_ops,
                               const void* a, const void* b, const void* wt,
                               const void* bias, const void* residual,
                               const void* pw, const void* pbias, void* y,
                               void* proj, void* s1, void* s2, int B, int H,
                               int W, int Cout, int apply_silu, int packed_struct,
                               int pipelined, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Cout % 8 != 0 || n_ops < 1 ||
      n_ops > MAX_OPS || (pw == nullptr) != (proj == nullptr) ||
      (pw != nullptr && pbias == nullptr))
    return (int)cudaErrorInvalidValue;
  Operands ops;
  int ctot = 0, n_chunks = 0;
  for (int k = 0; k < MAX_OPS; ++k) {
    ops.x[k] = nullptr;
    ops.c[k] = ops.off[k] = 0;
  }
  for (int k = 0; k < n_ops; ++k) {
    if (cs[k] <= 0 || cs[k] % (packed_struct ? BK : 8) != 0 || xs[k] == nullptr)
      return (int)cudaErrorInvalidValue;
    ops.x[k] = (const __nv_bfloat16*)xs[k];
    ops.c[k] = cs[k];
    ops.off[k] = ctot;
    ctot += cs[k];
    n_chunks += (cs[k] + BK - 1) / BK;
  }
  ops.n = n_ops;
  int th, tw;
  tile_shape(W, &th, &tw);
  const int tiles_w = (W + tw - 1) / tw;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  const dim3 grid(B * tiles, (Cout + BN - 1) / BN);
  const size_t smem = smem_bytes(W, packed_struct, pipelined);
  KernelFn kernel = pw != nullptr ? pick_kernel<true>(packed_struct, pipelined)
                                  : pick_kernel<false>(packed_struct, pipelined);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      ops, ctot, n_chunks, (const float*)a, (const float*)b, (const __nv_bfloat16*)wt,
      (const float*)bias, (const __nv_bfloat16*)residual,
      (const __nv_bfloat16*)pw, (const float*)pbias, (__nv_bfloat16*)y,
      (__nv_bfloat16*)proj, (float*)s1, (float*)s2, H, W, Cout, th, tw,
      tiles_w, tiles, apply_silu);
  return (int)cudaGetLastError();
}

}  // extern "C"
