// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (kernel K2).
//
// Replaces ml_mdm_tpu/ops/fused_resnet.py::affine_silu_conv3x3 (the Pallas
// `_kernel` body, single operand):
//
//   y = conv3x3(silu(x * a + b), w, padding 1) + bias [+ residual]
//
// over NHWC bf16 activations, with a and b per-(batch, channel) f32
// coefficients (GroupNorm with FiLM folded in), f32 accumulation and one
// rounding to bf16 at the store. With stats != nullptr it also adds the
// f32 sum and sum of squares of the STORED (rounded) output, per
// (batch, output channel), into two zeroed (B, Cout) buffers.
//
// What bounds it on the H100: compute. Every output pixel takes 9*C*Cout
// multiply-adds against about 2*(C + Cout) bytes of activation traffic,
// which is over 1,000 operations per byte at every flagship shape, far
// above the card's ~295 bf16 operations per byte of HBM bandwidth.
//
// Design: a direct (implicit-GEMM) convolution on bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulators). A block of 8 warps owns
// BM = 128 consecutive output pixels of one image times BN = 64 output
// channels. The reduction runs over C in chunks of BK = 32 channels; for
// each chunk the block
//   1. stages the input rows its pixels touch, plus one halo row above and
//      below and one zero column each side, into shared memory, applying
//      x*a+b and SiLU in f32 and rounding to bf16 once per element (not
//      once per tap). Out-of-image rows and columns are stored as 0: the
//      convolution pads the ACTIVATED tensor, so the border is 0 and not
//      silu(0*a+b);
//   2. stages the chunk's weights for all 9 taps;
//   3. runs the 9 taps as shifted reads of the staged activations.
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

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per reduction chunk
constexpr int KP = BK + 8;   // staged channel stride (bf16 elements)
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N, 32x32 each

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

__global__ void __launch_bounds__(THREADS)
affine_silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ a,
                           const float* __restrict__ b,
                           const __nv_bfloat16* __restrict__ wt,  // (Cout, 9, C)
                           const float* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ residual,
                           __nv_bfloat16* __restrict__ y,
                           float* __restrict__ s1,
                           float* __restrict__ s2,
                           int H, int W, int C, int Cout,
                           int tiles_per_image, int apply_silu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW = H * W;
  const int Wp = W + 2;
  const int img = blockIdx.x / tiles_per_image;
  const int p0 = (blockIdx.x % tiles_per_image) * BM;
  const int n0 = blockIdx.y * BN;
  const int row0 = p0 / W;
  const int last_row = min(p0 + BM - 1, HW - 1) / W;
  const int rows = last_row - row0 + 3;  // + one halo row each side

  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + rows * Wp * KP;  // [9][BN][KP]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;

  // staged offset (tap dy = dx = 0) of the 4 pixels this thread's A
  // fragments read: rows g and g + 8 of the warp's two m16 tiles
  int pix[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      int p = min(p0 + wm * 32 + mi * 16 + hf * 8 + g, HW - 1);
      pix[mi][hf] = ((p / W - row0) * Wp + (p % W)) * KP + tig * 2;
    }
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const size_t img_base = (size_t)img * HW;
  for (int c0 = 0; c0 < C; c0 += BK) {
    // 1. activated input rows + halo, 8 channels (16 bytes) per step
    const int nva = rows * Wp * (BK / 8);
    for (int i = tid; i < nva; i += THREADS) {
      const int v = i % (BK / 8);
      const int cell = i / (BK / 8);
      const int sr = cell / Wp, sc = cell % Wp;
      const int ih = row0 - 1 + sr, iw = sc - 1;
      const int c = c0 + v * 8;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            x + ((img_base + (size_t)ih * W + iw) * C + c));
        const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&raw);
        __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
        const float* ap = a + (size_t)img * C + c;
        const float* bp = b + (size_t)img * C + c;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t = __bfloat162float(r[j]) * __ldg(ap + j) + __ldg(bp + j);
          if (apply_silu) t = t / (1.f + __expf(-t));
          o[j] = __float2bfloat16_rn(t);
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
      if (co < Cout && c < C)
        val = *reinterpret_cast<const uint4*>(wt + (((size_t)co * 9 + tap) * C + c));
      *reinterpret_cast<uint4*>(Bs + (tap * BN + n) * KP + v * 8) = val;
    }
    __syncthreads();

    // 3. nine taps x BK/16 k-steps of tensor-core products
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * Wp + (tap % 3)) * KP;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* lo = As + pix[mi][0] + toff + kk;
          const __nv_bfloat16* hi = As + pix[mi][1] + toff + kk;
          af[mi][0] = lds32(lo);
          af[mi][1] = lds32(hi);
          af[mi][2] = lds32(lo + 8);
          af[mi][3] = lds32(hi + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* bp =
              Bs + (tap * BN + wn * 32 + ni * 8 + g) * KP + kk + tig * 2;
          const uint32_t b0 = lds32(bp), b1 = lds32(bp + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + bias (+ residual) in f32, one rounding, stats of the
  // stored value squared in f32
  float t1[4][2], t2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) t1[ni][0] = t1[ni][1] = t2[ni][0] = t2[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + wm * 32 + mi * 16 + hf * 8 + g;
      if (p >= HW) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + tig * 2;
        if (n >= Cout) continue;
        float v0 = acc[mi][ni][hf * 2] + bias[n];
        float v1 = acc[mi][ni][hf * 2 + 1] + bias[n + 1];
        const size_t o = (img_base + p) * Cout + n;
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
  if (s1 == nullptr) return;
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

}  // namespace

extern "C" {

// Dynamic shared memory the launch for a row width W needs, in bytes.
static size_t smem_bytes(int W) {
  // rows touched by BM consecutive pixels, + 2 halo rows
  const int rows = (BM % W == 0) ? BM / W + 2 : (W + BM - 2) / W + 3;
  return ((size_t)rows * (W + 2) + 9 * BN) * KP * sizeof(__nv_bfloat16);
}

// x (B,H,W,C) bf16; a, b (B,C) f32; wt (Cout,9,C) bf16; bias (Cout) f32;
// residual (B,H,W,Cout) bf16 or null; y (B,H,W,Cout) bf16; s1, s2 (B,Cout)
// f32, zeroed by the caller, or both null. C % 8 == 0, Cout % 8 == 0.
// Launches on `stream` and returns cudaGetLastError().
int ml_mdm_affine_silu_conv3x3(const void* x, const void* a, const void* b,
                               const void* wt, const void* bias,
                               const void* residual, void* y, void* s1,
                               void* s2, int B, int H, int W, int C, int Cout,
                               int apply_silu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      affine_silu_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (H * W + BM - 1) / BM;
  const dim3 grid(B * tiles, (Cout + BN - 1) / BN);
  affine_silu_conv3x3_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)a, (const float*)b,
      (const __nv_bfloat16*)wt, (const float*)bias,
      (const __nv_bfloat16*)residual, (__nv_bfloat16*)y, (float*)s1,
      (float*)s2, H, W, C, Cout, tiles, apply_silu);
  return (int)cudaGetLastError();
}

}  // extern "C"
