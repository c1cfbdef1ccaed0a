// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (kernel K2),
// with N operands (K2·N) and the 1x1 shortcut as a second output (K2·proj).
//
// Replaces ml_mdm_tpu/ops/fused_resnet.py::affine_silu_conv3x3 (the Pallas
// `_kernel` body, its tuple operands and its `emit_proj` output):
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
// shells (C = 32-64) sit near that line.
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
//   2. stages the chunk's weights for all 9 taps;
//   3. runs the 9 taps as shifted reads of the staged activations.
// After y is stored, the shortcut runs as a second, short reduction over
// the same chunks: the tile's RAW pixels and the chunk's slice of P are
// staged and multiplied into the same (now free) accumulators. Keeping one
// accumulator set keeps the kernel at ~100 registers and two blocks per SM;
// a second set beside the first took 146 and one block per SM. The second
// pass re-reads 1/9 of what the first staged, mostly from L2.
// Padding each staged pixel to KP = 40 bf16 (80 bytes) makes the fragment
// loads of 8 consecutive pixels hit 32 distinct banks.
//
// The Pallas kernel accumulated the stats in one output block that the
// sequential TPU grid revisits. Hopper blocks run in no order, so here each
// warp reduces its partial sums with shuffles and adds them to the (B, Cout)
// buffers with f32 atomics. Atomic order varies between runs, so the stats
// agree with a sequential sum to f32 rounding of the total, not bitwise.
//
// No cp.async/TMA pipelining and no wgmma yet: this is the simple, right
// version; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block (at most)
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per reduction chunk
constexpr int KP = BK + 8;   // staged channel stride (bf16 elements)
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

// One BK-deep step of the warp's 32x32 product: A rows at `a_lo/a_hi`
// offsets (pixel rows g and g + 8 of its two m16 tiles), B from `bsm`.
__device__ __forceinline__ void warp_mma_k16(float (&acc)[2][4][4],
                                             const __nv_bfloat16* asm_,
                                             const int (&aoff)[2][2],
                                             const __nv_bfloat16* bsm,
                                             int wn, int g, int tig, int kk) {
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const __nv_bfloat16* lo = asm_ + aoff[mi][0] + kk;
    const __nv_bfloat16* hi = asm_ + aoff[mi][1] + kk;
    af[mi][0] = lds32(lo);
    af[mi][1] = lds32(hi);
    af[mi][2] = lds32(lo + 8);
    af[mi][3] = lds32(hi + 8);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const __nv_bfloat16* bp = bsm + (wn * 32 + ni * 8 + g) * KP + kk + tig * 2;
    const uint32_t b0 = lds32(bp), b1 = lds32(bp + 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
  }
}

template <bool PROJ>
__global__ void __launch_bounds__(THREADS)
affine_silu_conv3x3_kernel(const Operands ops, int ctot,
                           const float* __restrict__ a,            // (B, ctot)
                           const float* __restrict__ b,            // (B, ctot)
                           const __nv_bfloat16* __restrict__ wt,   // (Cout, 9, ctot)
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SW = TW + 2;               // staged row width
  const int n_stage = (TH + 2) * SW;   // staged pixels
  const int tile_px = TH * TW;         // <= BM
  const int img = blockIdx.x / tiles_per_image;
  const int t = blockIdx.x % tiles_per_image;
  const int r0 = (t / tiles_w) * TH;
  const int col0 = (t % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;

  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [n_stage][KP]
  __nv_bfloat16* Bs = As + n_stage * KP;   // [9][BN][KP]
  // the shortcut pass reuses the same memory once the conv is done
  __nv_bfloat16* Rs = As;                  // [BM][KP] raw tile pixels (PROJ)
  __nv_bfloat16* Ps = Rs + BM * KP;        // [BN][KP] shortcut weights (PROJ)

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
  for (int k = 0; k < ops.n; ++k) {
    const int ck = ops.c[k], offk = ops.off[k];
    const __nv_bfloat16* xk = ops.x[k] + (size_t)img * H * W * ck;
    for (int c0 = 0; c0 < ck; c0 += BK) {
      // 1. activated tile + halo, 8 channels (16 bytes) per step
      const int nva = n_stage * (BK / 8);
      for (int i = tid; i < nva; i += THREADS) {
        const int v = i % (BK / 8);
        const int cell = i / (BK / 8);
        const int sr = cell / SW, sc = cell % SW;
        const int ih = r0 - 1 + sr, iw = col0 - 1 + sc;
        const int c = c0 + v * 8;
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < ck) {
          const uint4 rawv =
              *reinterpret_cast<const uint4*>(xk + (((size_t)ih * W + iw) * ck + c));
          const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&rawv);
          __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
          const float* ap = a_img + offk + c;
          const float* bp = b_img + offk + c;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float u = __bfloat162float(r[j]) * __ldg(ap + j) + __ldg(bp + j);
            if (apply_silu) u = u / (1.f + __expf(-u));
            o[j] = __float2bfloat16_rn(u);
          }
        }
        *reinterpret_cast<uint4*>(As + (size_t)cell * KP + v * 8) = out;
      }
      // 2. weights of the chunk for the 9 taps
      const int nvb = 9 * BN * (BK / 8);
      for (int i = tid; i < nvb; i += THREADS) {
        const int v = i % (BK / 8);
        const int rest = i / (BK / 8);
        const int n = rest % BN, tap = rest / BN;
        const int c = c0 + v * 8, co = n0 + n;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (co < Cout && c < ck)
          val = *reinterpret_cast<const uint4*>(wt + (((size_t)co * 9 + tap) * ctot + offk + c));
        *reinterpret_cast<uint4*>(Bs + (tap * BN + n) * KP + v * 8) = val;
      }
      __syncthreads();

      // 3. nine taps x BK/16 k-steps of tensor-core products
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
          warp_mma_k16(acc, As, aoff, Bs + tap * BN * KP, wn, g, tig, kk);
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
        *reinterpret_cast<uint4*>(Ps + n * KP + v * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) warp_mma_k16(acc, Rs, raw, Ps, wn, g, tig, kk);
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

}  // namespace

extern "C" {

// Tile of a launch for a row width W: TW = min(W, 32) columns by
// TH = 128 / TW rows.
static void tile_shape(int W, int* th, int* tw) {
  *tw = W < MAX_TW ? W : MAX_TW;
  *th = BM / *tw;
}

// Dynamic shared memory a launch needs, in bytes (at most 77,280, at W = 1;
// 62,400 at W >= 32). The shortcut pass fits in the same memory.
static size_t smem_bytes(int W) {
  int th, tw;
  tile_shape(W, &th, &tw);
  const size_t cells = (size_t)(th + 2) * (tw + 2) + 9 * BN;
  return cells * KP * sizeof(__nv_bfloat16);
}

// xs[n_ops]: operands (B,H,W,cs[k]) bf16, 16-byte aligned; a, b (B, sum cs)
// f32; wt (Cout, 9, sum cs) bf16; bias (Cout) f32; residual (B,H,W,Cout)
// bf16 or null; pw (Cout, sum cs) bf16 and pbias (Cout) f32, or both null;
// y and proj (B,H,W,Cout) bf16 (proj null without pw); s1, s2 (B,Cout) f32,
// zeroed by the caller, or both null. 1 <= n_ops <= 4, every cs[k] and Cout
// a positive multiple of 8. Launches on `stream` and returns
// cudaGetLastError().
int ml_mdm_affine_silu_conv3x3(const void* const* xs, const int* cs, int n_ops,
                               const void* a, const void* b, const void* wt,
                               const void* bias, const void* residual,
                               const void* pw, const void* pbias, void* y,
                               void* proj, void* s1, void* s2, int B, int H,
                               int W, int Cout, int apply_silu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Cout % 8 != 0 || n_ops < 1 ||
      n_ops > MAX_OPS || (pw == nullptr) != (proj == nullptr) ||
      (pw != nullptr && pbias == nullptr))
    return (int)cudaErrorInvalidValue;
  Operands ops;
  int ctot = 0;
  for (int k = 0; k < MAX_OPS; ++k) {
    ops.x[k] = nullptr;
    ops.c[k] = ops.off[k] = 0;
  }
  for (int k = 0; k < n_ops; ++k) {
    if (cs[k] <= 0 || cs[k] % 8 != 0 || xs[k] == nullptr) return (int)cudaErrorInvalidValue;
    ops.x[k] = (const __nv_bfloat16*)xs[k];
    ops.c[k] = cs[k];
    ops.off[k] = ctot;
    ctot += cs[k];
  }
  ops.n = n_ops;
  int th, tw;
  tile_shape(W, &th, &tw);
  const int tiles_w = (W + tw - 1) / tw;
  const int tiles = ((H + th - 1) / th) * tiles_w;
  const dim3 grid(B * tiles, (Cout + BN - 1) / BN);
  const int with_proj = pw != nullptr;
  const size_t smem = smem_bytes(W);
  auto kernel = with_proj ? affine_silu_conv3x3_kernel<true> : affine_silu_conv3x3_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      ops, ctot, (const float*)a, (const float*)b, (const __nv_bfloat16*)wt,
      (const float*)bias, (const __nv_bfloat16*)residual,
      (const __nv_bfloat16*)pw, (const float*)pbias, (__nv_bfloat16*)y,
      (__nv_bfloat16*)proj, (float*)s1, (float*)s2, H, W, Cout, th, tw,
      tiles_w, tiles, apply_silu);
  return (int)cudaGetLastError();
}

}  // extern "C"
