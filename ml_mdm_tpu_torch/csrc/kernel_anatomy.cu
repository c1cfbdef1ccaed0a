// The fused conv's cost decomposition on Hopper (kernels P1 and P2): K2's
// own kernel, `conv3x3_wgmma_kernel` (csrc/conv3x3_wgmma.cuh, the source K2
// runs from), with some of its features switched off, so that a timing of
// each variant is a part of the time of the kernel the model runs.
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
// f32 (without SiLU when silu is off), products in f32, one rounding to
// bf16.
//   P1: y = sum_t src @ w[t], src = act(x) with act, else x; every tap
//       multiplies the same tile (no spatial shift); 0 taps give y = src.
//   P2: act(x) in bands of 16 rows; tap t reads the row shifted by
//       t % 3 - 1 at the centre column, or with selects K2·struct's four
//       parity-selected neighbours. A padding row across a band's edge is
//       the neighbouring image row with halos (clamped at the image's top
//       and bottom, as the probe clamps it), else not loaded; padding
//       columns lie at the image's edges. A cell that is not loaded holds
//       act(0), or 0 with zero (K2's rule). dbuf does not change y.
//
// Every variant is K2 at its plan for the probes' shape (B = 4, 512^2, 128
// -> 128: N tile 128, two m64 tiles a warpgroup, 8 x 32 output pixels,
// `probe_plan` on the host, whose TH divides the band), with no bias,
// residual, stats or shortcut, and these of K2's features turned on:
//   taps     n of them a chunk, at the host's staged offsets (P1 all at the
//            centre of a tile without halo; P2 tap t at row t % 3 - 1;
//            selects: K2·struct's `struct_tap_offsets` under the packed
//            mode's parity-class staging, weights in its class order)
//   act      the coefficients a = 1.01, b = 0.02 (B, C) through K2's path,
//            SiLU by K2's apply_silu; without act K2's identity prologue
//   stage    K2's register pass (raw tile -> registers -> act -> activated
//            tile); without it ("direct") ldmatrix reads the raw tile
//   halos    the clamped halo rows across P2's bands (else not loaded)
//   zero     K2's zero fill of a cell not loaded (else act(0))
//   dbuf     K2's staging of the next chunk under this chunk's products
//            (else after them, then the barrier; the raw tiles come by
//            cp.async under the products either way, as Pallas brought each
//            input block under the previous grid step in every TPU variant)
// The switches are conv3x3_wgmma.cuh's PROBE_* word; act and SiLU are K2's
// own run-time switches, so the 16 variants take 13 instances.
//
// What bounds it on the H100: at 9 taps compute (2 B H W C^2 9 FLOP against
// x and y once: 0.3127 ms against 0.1603 ms at the probes' shape); at 4
// taps and fewer the bytes. The design is K2's (csrc/fused_resnet.cu), so
// each variant's time is a part of K2's.

#include "conv3x3_wgmma.cuh"

namespace {

// the probes' instance of K2 (`probe_plan`): N tile 128, two m64 tiles a
// warpgroup
constexpr int PROBE_BN = 128, PROBE_MT = 2;

constexpr int taps(int n) { return PROBE_ON | n << PROBE_TAPS_SHIFT; }
// P1: the tile without halo, the next chunk staged after the products
constexpr int p1(int n, int direct) {
  return taps(n) | PROBE_NO_HALO | PROBE_SERIAL | (direct ? PROBE_DIRECT : 0);
}
// P2: 4 taps over the bands
constexpr int p2(int halos, int zero, int dbuf) {
  return taps(4) | PROBE_BANDS | (halos ? PROBE_HALOS : 0) | (zero ? 0 : PROBE_FILL_ACT) |
         (dbuf ? 0 : PROBE_SERIAL);
}

struct Instance {
  int flags;     // the PROBE word
  int selects;   // K2's packed mode: parity-class staging
  WgKernel fn;
};

#define INSTANCE(FLAGS, SELECTS) \
  {FLAGS, SELECTS, conv3x3_wgmma_kernel<PROBE_BN, PROBE_MT, false, SELECTS, FLAGS>}

// the rows of the two probes' tables, in their order (rows that differ
// only in act or SiLU share an instance)
const Instance kInstances[] = {
    // P1: taps, act, silu, staging
    INSTANCE(p1(9, 1), false),    // dots direct from input block
    INSTANCE(p1(4, 1), false),    // dots direct, 4 taps
    INSTANCE(p1(1, 1), false),    // dots direct, 1 tap
    INSTANCE(p1(9, 0), false),    // copy/act/act+silu->scratch + 9 dots
    INSTANCE(p1(4, 0), false),    // act+silu->scratch + 4 dots
    INSTANCE(p1(0, 0), false),    // act+silu only (0 dots); pure copy through scratch
    // P2: 4 products of act+silu, halos, selects, zero fill, double buffer
    INSTANCE(p2(0, 0, 0), false),  // base: 4 dots, single buf
    INSTANCE(p2(1, 0, 0), false),  // +halos
    INSTANCE(p2(0, 0, 0), true),   // +selects
    INSTANCE(p2(0, 1, 0), false),  // +when_zero
    INSTANCE(p2(0, 0, 1), false),  // +dbuf
    INSTANCE(p2(1, 0, 0), true),   // halos+selects
    INSTANCE(p2(1, 1, 1), true),   // ALL (the real kernel's shape)
};

#undef INSTANCE

}  // namespace

extern "C" {

// flags: the PROBE word of one of the instances above, selects: its packed
// mode (ops/kernel_anatomy.py `kernel_flags`). x and y (B, H, W, C) bf16,
// 16-byte aligned; a, b (B, C) f32, or both null (the identity prologue;
// null with PROBE_DIRECT), apply_silu K2's; wt K2's layout of the taps
// (`conv_weight_layout`, packed with selects), unread with 0 taps; th, tw,
// stages, grid `probe_plan`'s (th dividing the band of 16 rows); toff 16
// ints, the staged offset of tap t at [t] (selects: of combined tap t's
// k-step ks at [4 t + ks]). H a multiple of 16, C of 8. Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape, plan or variant it does not take.
int ml_mdm_kernel_anatomy(int flags, int selects, const void* x, const void* a, const void* b,
                          const void* wt, void* y, int B, int H, int W, int C, int apply_silu,
                          int th, int tw, int stages, int grid, const int* toff, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H % PROBE_BAND != 0 || C % 8 != 0 || th <= 0 ||
      PROBE_BAND % th != 0 || (a == nullptr) != (b == nullptr) || x == nullptr ||
      y == nullptr || toff == nullptr)
    return (int)cudaErrorInvalidValue;
  const Instance* inst = nullptr;
  for (const Instance& cand : kInstances)
    if (cand.flags == flags && cand.selects == selects) inst = &cand;
  if (inst == nullptr || ((flags & PROBE_DIRECT) && a != nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_taps = flags >> PROBE_TAPS_SHIFT;
  if (n_taps > 0 && wt == nullptr) return (int)cudaErrorInvalidValue;
  const int halo = (flags & PROBE_NO_HALO) ? 0 : 1;
  const void* xs[1] = {x};
  const int cs[1] = {C};
  // 0 taps: one N tile a pixel tile, whose chunks are every channel of y
  return launch_conv(inst->fn, xs, cs, 1, a, b, n_taps > 0 ? wt : x, nullptr, nullptr, nullptr,
                     nullptr, y, nullptr, nullptr, nullptr, B, H, W, C, apply_silu, th, tw,
                     PROBE_BN, PROBE_MT, stages, grid, toff, halo * (2 * (tw + 2) + 2),
                     n_taps > 0 ? 0 : 1, (cudaStream_t)stream);
}

}  // extern "C"
