// Blocked online-softmax attention for Hopper (kernel K4).
//
// Replaces ml_mdm_tpu/ops/attention.py::flash_attention (the Pallas kernel
// inside it): for q (B, Lq, H, D) and k, v (B, Lk, H, D), per batch row and
// head,
//
//   out = softmax((q * d^-1/4) (k * d^-1/4)^T) v
//
// without ever storing the (Lq, Lk) logits: a running maximum m, a running
// sum l and an f32 accumulator per query row over blocks of keys, acc / l at
// the end. No mask, no dropout, no causal form, as in the JAX kernel.
//
// What bounds it on the H100: operations at the model's long sequences (at
// L = 1024, D = 64 it does 4*L*L*D FLOPs per head against 8*L*D bytes: 512
// operations a byte, above the card's ~295), bytes at the short ones (L = 256:
// 128 operations a byte). The matmul route it stands beside writes the logits
// to device memory once in bf16, once as the f32 softmax and once more in bf16;
// keeping S and P in registers is the point of the kernel.
//
// Design (the Pallas kernel folds heads into the batch with two transposes,
// holds all of K and V of a head in VMEM and upcasts everything to f32; none
// of that carries over):
//   - one block of 4 warps per (batch row, head, tile of BM = 64 queries),
//     each warp owning 16 query rows; consecutive blocks share a head, so its
//     K and V stay in L2;
//   - q, k, v are addressed by their (batch, position, head) strides in the
//     model's own (B, L, H, D) layout: the chunks of one (B, L, 3C) tensor go
//     in as they are, nothing is transposed or copied around the launch;
//   - Q is staged once and kept as mma A fragments in registers; K and V
//     stream through shared memory in tiles of BN = 64 keys, double buffered
//     with cp.async, rows padded by 8 bf16 so ldmatrix reads 8 rows from 8
//     distinct 16-byte bank groups;
//   - bf16 operands to the tensor cores (mma.sync m16n8k16, f32
//     accumulation), S and the softmax state in f32 registers, one scale
//     d^-1/2 * log2(e) applied to S in f32 so the exponentials are exp2f, P
//     rounded to bf16 only as the A operand of the second product;
//   - ragged edges: rows past Lq or Lk are staged as zeros; keys past Lk get
//     S = -inf (every key tile holds at least one real key, so no row's
//     maximum stays at -inf and exp2f never sees inf - inf); query rows past
//     Lq compute on zeros and are not stored.
//
// D is a template parameter: any multiple of 16 up to 128 (96 is six k-steps
// of 16). No wgmma, TMA or warp specialisation yet: this is the simple, right
// version; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 64;        // keys per streamed tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;  // (B, Lq, H, D) contiguous
  int Lq, Lk, H, n_q_tiles;
  long long q_sb, q_sl, q_sh;  // strides in elements: batch, position, head
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  float scale_log2;  // d^-1/2 * log2(e)
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

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i; each lane receives elements (lane / 4, 2 * (lane % 4)
// and the next) of every matrix, or with `trans` the transposed ones.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 stores zeros.
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage ROWS rows of HD bf16 (row stride `stride` elements in global memory,
// HD + 8 in shared) starting at row `row0`; rows at or past `n_rows` become 0.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride, int row0, int n_rows, int tid) {
  constexpr int LDS = HD + 8;
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    const __nv_bfloat16* g = src + (long long)(ok ? row : n_rows - 1) * stride + c * 8;
    cp_async_16(dst + r * LDS + c * 8, g, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(const Params p) {
  constexpr int LDS = HD + 8;     // shared row stride (bf16 elements)
  constexpr int KSTEPS = HD / 16; // k-steps of Q K^T; pairs of output n-tiles of P V
  constexpr int NT_S = BN / 8;    // n-tiles (8 keys) of S
  constexpr int NT_O = HD / 8;    // n-tiles (8 channels) of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDS]
  __nv_bfloat16* sK = sQ + BM * LDS;                               // [2][BN][LDS]
  __nv_bfloat16* sV = sK + 2 * BN * LDS;                           // [2][BN][LDS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int qt = blockIdx.x % p.n_q_tiles;
  const int bh = blockIdx.x / p.n_q_tiles;
  const int head = bh % p.H, batch = bh / p.H;
  const int q0 = qt * BM;

  const __nv_bfloat16* qb = p.q + batch * p.q_sb + head * p.q_sh;
  const __nv_bfloat16* kb = p.k + batch * p.k_sb + head * p.k_sh;
  const __nv_bfloat16* vb = p.v + batch * p.v_sb + head * p.v_sh;

  const int n_kt = (p.Lk + BN - 1) / BN;
  stage_tile<HD, BM>(sQ, qb, p.q_sl, q0, p.Lq, tid);
  cp_async_commit();
  stage_tile<HD, BN>(sK, kb, p.k_sl, 0, p.Lk, tid);
  stage_tile<HD, BN>(sV, vb, p.v_sl, 0, p.Lk, tid);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // the warp's 16 query rows as A fragments, one per 16 channels
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int row = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int col = ks * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[ks], sQ + row * LDS + col);
  }

  float o_acc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o_acc[nt][r] = 0.f;
  // softmax state of rows g and g + 8 of the warp's tile, in log2 units
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      stage_tile<HD, BN>(sK + (buf ^ 1) * BN * LDS, kb, p.k_sl, (j + 1) * BN, p.Lk, tid);
      stage_tile<HD, BN>(sV + (buf ^ 1) * BN * LDS, vb, p.v_sl, (j + 1) * BN, p.Lk, tid);
      cp_async_commit();
      cp_async_wait<1>();  // tile j has landed, tile j + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * BN * LDS;
    const __nv_bfloat16* tV = sV + buf * BN * LDS;

    // S = Q K^T over the tile's 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (lane >> 4) * 8 + (lane & 7);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b, tK + key * LDS + col);
        mma_bf16_16816(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16_16816(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale, mask the keys past Lk (only the last tile has any), row maxima
    const int key0 = j * BN;
    const bool ragged = key0 + BN > p.Lk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float val = s[nt][r] * p.scale_log2;
        if (ragged && key0 + nt * 8 + tig * 2 + (r & 1) >= p.Lk) val = -INFINITY;
        s[nt][r] = val;
        mx[r >> 1] = fmaxf(mx[r >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);  // finite: the tile has a real key
      corr[h] = exp2f(m_run[h] - m_new);           // exp2f(-inf) = 0 on the first tile
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
    // P = exp2(S - m); the row sums stay per thread until the end
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = exp2f(s[nt][r] - m_run[r >> 1]);
        s[nt][r] = e;
        l_run[r >> 1] += e;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      o_acc[nt][0] *= corr[0];
      o_acc[nt][1] *= corr[0];
      o_acc[nt][2] *= corr[1];
      o_acc[nt][3] *= corr[1];
    }

    // O += P V: P's accumulator layout is the A fragment layout of the next
    // product, 16 keys (two n-tiles of S) per k-step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KSTEPS; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, tV + key * LDS + col);
        mma_bf16_16816(o_acc[2 * dp], pa, b[0], b[1]);
        mma_bf16_16816(o_acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer's twin
  }

  // out = acc / l, rounded once to bf16, rows past Lq dropped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + warp * 16 + h * 8 + g;
    if (row >= p.Lq) continue;
    __nv_bfloat16* orow =
        p.o + (((long long)batch * p.Lq + row) * p.H + head) * HD + tig * 2;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
          __floats2bfloat162_rn(o_acc[nt][2 * h] * inv, o_acc[nt][2 * h + 1] * inv);
    }
  }
}

template <int HD>
int launch(const Params& p, long long blocks, cudaStream_t stream) {
  // Q, and two buffers each of K and V
  const size_t smem = (size_t)(BM + 4 * BN) * (HD + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<HD><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Lq, H, D), k and v (B, Lk, H, D): bf16, the last axis contiguous,
// each given by its base pointer (16-byte aligned) and its batch, position
// and head strides in elements (multiples of 8); o (B, Lq, H, D) bf16,
// contiguous. D a multiple of 16, at most 128. scale is applied to q k^T
// (d^-1/2 for the model). Launches on `stream` and returns
// cudaGetLastError().
int ml_mdm_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                           int Lq, int Lk, int H, int D, long long q_sb, long long q_sl,
                           long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                           long long v_sb, long long v_sl, long long v_sh, float scale,
                           void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || D < 16 || D > 128 || D % 16 != 0 ||
      q == nullptr || k == nullptr || v == nullptr || o == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = (const __nv_bfloat16*)q;
  p.k = (const __nv_bfloat16*)k;
  p.v = (const __nv_bfloat16*)v;
  p.o = (__nv_bfloat16*)o;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.n_q_tiles = (Lq + BM - 1) / BM;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.scale_log2 = scale * 1.4426950408889634f;
  const long long blocks = (long long)p.n_q_tiles * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(p, blocks, s);
    case 32: return launch<32>(p, blocks, s);
    case 48: return launch<48>(p, blocks, s);
    case 64: return launch<64>(p, blocks, s);
    case 80: return launch<80>(p, blocks, s);
    case 96: return launch<96>(p, blocks, s);
    case 112: return launch<112>(p, blocks, s);
    case 128: return launch<128>(p, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
