// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (kernel K2),
// with N operands (K2·N), the 1x1 shortcut as a second output (K2·proj), the
// space-to-depth packed mode (K2·struct) and its software-pipelined variant
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
// rounding to bf16 at each store. The activation is rounded to bf16 once per
// element. The concatenation never exists in memory: the reduction walks the
// channel chunks of operand 0, then operand 1, ..., into the same
// accumulators. With stats != nullptr it also adds the f32 sum and sum of
// squares of the STORED (rounded) y, per (batch, output channel), into two
// zeroed (B, Cout) buffers. Without a and b (null) the prologue is the
// identity: conv3x3_fast and K3's data gradient.
//
// One kernel, `conv3x3_wgmma_kernel`, templated on the tap count: every
// unpacked launch runs its 9-tap instances, every packed launch (K2·struct,
// and K2·pipe, its pipelined form) its 4-tap ones. Its source is
// csrc/conv3x3_wgmma.cuh, which the cost-decomposition probes
// (csrc/kernel_anatomy.cu) instantiate with parts of it switched off.
//
// == The unpacked kernel: implicit GEMM on wgmma ==
//
// What bounds it on the H100: operations. At the 64px model's shapes every
// output pixel takes 9 C Cout multiply-adds against 2 (C + Cout) bytes, over
// 1,000 operations a byte against the card's ~295 (the 15 launch shapes of
// the batch-64 forward are all bound by operations). The earlier mma.sync
// kernel ran there at about 12% of that bound, and the cost-decomposition probes (P1,
// P2) split its time at B = 4, 512^2, 128 channels into products 45% (at 26%
// of the tensor cores' peak), SiLU 20%, padding and halos 14%, the rest of
// the tile and epilogue 20%; its 128-pixel blocks also re-read the whole
// weight tensor from L2 once per 128 output pixels. The design answers each:
//
//   - products: wgmma.m64nNk16, A from registers (ldmatrix from the
//     activated tile in shared memory, one row address a thread, so the 9
//     shifted taps, ragged tiles and rows narrower than the tile read the
//     same tile), B the weights read from shared memory by descriptor,
//     K-major with the 128-byte swizzle. A block is two warpgroups; each
//     owns MT x 64 output pixels by BN output channels
//     (BN = 64, 128 or 256, MT x BN <= 256: at most 128 f32 accumulators a
//     thread). Each k-step of 16 channels is one commit group, and the A
//     fragments of two k-steps alternate, so a warpgroup keeps a group in
//     flight while it loads the next k-step's fragments; the other
//     warpgroup's products share the tensor cores.
//   - SiLU: a pixel is activated once per BN = 128-256 output channels (the
//     earlier mma.sync kernel: once per 64), and under the products: two
//     activated tiles alternate by chunk; while the tensor cores run chunk q's taps
//     from one, each thread activates its cells of chunk q + 1 into the
//     other, from a raw tile it copied by cp.async during chunk q - 1, with
//     a and b staged in shared memory (x*a+b and SiLU once per element,
//     out-of-image cells masked to 0 AFTER the activation: the convolution
//     pads the activated tensor). The warpgroups take turns, warpgroup 0 at
//     taps 1-4 and warpgroup 1 at taps 5-8, so one has the tensor cores
//     while the other stages. A thread activates only the cells it copied,
//     so the raw tile needs no barrier, and a chunk one. The SiLU is
//     h + h tanh(h), h = u / 2: one SFU operation.
//   - padding and halos: the tile is 8 x 32 (or 16 x 16, 32 x 8) output
//     pixels at M = 256, so the halo adds 33% (the earlier mma.sync 4 x 32
//     tile: 59%); the activated and raw tiles are swizzled (16-byte group j of
//     pixel p at j ^ (p mod 8)), so the ldmatrix reads of 8 consecutive
//     pixels hit 32 distinct banks.
//   - weight traffic: one thread of the block streams the weights into a
//     ring of STAGES slots of one tap's (BN x 64) slice each, by bulk copies
//     that complete on mbarriers; each warpgroup hands a slot back on
//     another. (No producer warpgroup: a third warpgroup would cap every
//     thread at 168 registers, and the accumulators alone take 128.) A
//     32-channel chunk's 9 taps at N = 256 would take 147 KB, so the ring's
//     unit is one tap, never a chunk. The host lays the weights out in the
//     order the ring reads them, already swizzled ((chunk, tap, Cout, 64)
//     with 16-byte group j of output channel n at j ^ (n mod 8)), so each
//     slot is one contiguous copy. At M = 256 a launch at (64, 64^2,
//     256 -> 256) reads its weights from L2 1,024 times, not 2,048. The
//     block index runs over the N tiles fastest, so the blocks sharing an
//     activation tile run together and read it from L2.
//   - the shortcut (K2·proj) is a second, short pass after y is stored:
//     the raw tile of each chunk (no affine) times the chunk's slice of P
//     through the centre tap, into the same accumulators; a second
//     accumulator set would not fit beside the first at 128 a thread.
//   - the epilogue adds bias and residual in f32 and rounds once; the stats
//     are taken from the stored bf16 values in f32: per-warp shuffles, one
//     shared-memory atomic a warp and column, then one global f32 atomic a
//     block and column. Atomic order varies between runs, so the stats agree
//     with a sequential sum to f32 rounding of the total, not bitwise.
//
//   - the prologue and the grid: persistent, one block an SM walks the
//     output tiles; the next tile's first chunk is staged under this tile's
//     last products, so only the epilogue stands between two tiles.
//
// The host's `conv_plan` (ops/fused_resnet.py) picks (BN, MT), the tile
// (TH x TW pixels, TW = min(W, 32)), the ring's depth and the grid for a
// launch, and says how much each launch reads from L2; this side checks and
// follows it.
//
// == The packed mode (K2·struct, K2·pipe): the same kernel at 4 taps ==
//
// x is a space-to-depth packed tensor (channel 4 c + 2 ei + ej holds
// sub-pixel (ei, ej) of unpacked channel c) and w the packed kernel
// collapsed to 4 combined taps (the JAX `_struct_weights`): the packed 3x3
// kernel is 75% structural zeros, so its 9 taps reduce to 4 products over
// the same staged tile: centre x centre, centre x column select, row select
// x centre, row select x column select. A row select reads, for each
// channel, the pixel above when its ei bit is 1 and the one below when it
// is 0; a column select the pixel left (ej = 1) or right (ej = 0). At the
// models' packed shapes (thin shells of 32-64 unpacked channels) the
// convolution is bound by its bytes, not its operations, and the combined
// taps carry the packed kernel's zeros: 16/9 of the unpacked convolution's
// multiply-adds, at 4/9 of its k-steps per staged chunk. How each cost is
// answered is the unpacked kernel's (above: the tile and halo, the
// activation once per BN output channels under the products, the weight
// ring, the epilogue, the stats and the shortcut pass). What differs:
//
//   - parity classes make each shift uniform: the activation stores each
//     64-channel chunk in parity-class order, staged position 16 code + i
//     holding channel c0 + 4 i + code, code = 2 ei + ej. Each k-step of 16
//     then holds one class (ei, ej) = (ks >> 1, ks & 1), and each (combined
//     tap, k-step) pair is one uniform pixel shift (dr, dc) in {-1, 0, 1}^2
//     of the tile, whose staged offsets the host computes (`struct_tap_
//     offsets`, passed as `toff`): the ldmatrix row addresses, the halo of one
//     pixel, the tile geometry and the swizzle are the unpacked kernel's.
//   - the permutation happens where a thread activates its own cells: the 8
//     channels of its 16-byte raw group go out as four 4-byte pieces (two
//     channels of one class each) into four of the row's 16-byte groups.
//     With the tile's 128-byte swizzle, 4 consecutive pixels of a warp would
//     put two pieces in one bank, so the packed staging gives the 8 pixels of
//     two warps in the order 0 2 4 6 | 1 3 5 7: a warp's 32 pieces of a class
//     fall into 32 banks.
//   - the host lays the combined taps out as the unpacked weights, (chunk,
//     tap, Cout, 64) swizzled, with each chunk's 64 channels in the same
//     class order; the shortcut's matrices likewise, since its pass stages
//     the raw tile through the same permuted store. Operands are zero-padded
//     to whole chunks, as unpacked.
//   - the turns at staging: the 8 turns of a chunk are the second and fourth
//     k-step of each of the 4 taps, warpgroup 0 taking taps 0-1, warpgroup 1
//     taps 2-3 (unpacked: the second k-step of taps 1-4 and 5-8).
//   - K2·pipe: the next chunk is always staged under this one's products,
//     so a pipelined packed launch runs the serial one, bit for bit.

#include "conv3x3_wgmma.cuh"

namespace {

template <bool PROJ, bool PACKED>
WgKernel pick_wgmma(int bn, int mt) {
  if (bn == 256 && mt == 1) return conv3x3_wgmma_kernel<256, 1, PROJ, PACKED>;
  if (bn == 128 && mt == 2) return conv3x3_wgmma_kernel<128, 2, PROJ, PACKED>;
  if (bn == 128 && mt == 1) return conv3x3_wgmma_kernel<128, 1, PROJ, PACKED>;
  if (bn == 64 && mt == 2) return conv3x3_wgmma_kernel<64, 2, PROJ, PACKED>;
  if (bn == 64 && mt == 1) return conv3x3_wgmma_kernel<64, 1, PROJ, PACKED>;
  return nullptr;
}

int launch_wgmma(const void* const* xs, const int* cs, int n_ops, const void* a, const void* b,
                 const void* wt, const void* bias, const void* residual, const void* pw,
                 const void* pbias, void* y, void* proj, void* s1, void* s2, int B, int H,
                 int W, int Cout, int apply_silu, int packed, int th, int tw, int bn, int mt,
                 int stages, int grid, const int* toff, cudaStream_t stream) {
  if (packed && toff == nullptr) return (int)cudaErrorInvalidValue;
  WgKernel kernel = packed ? (pw != nullptr ? pick_wgmma<true, true>(bn, mt)
                                            : pick_wgmma<false, true>(bn, mt))
                          : (pw != nullptr ? pick_wgmma<true, false>(bn, mt)
                                           : pick_wgmma<false, false>(bn, mt));
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch_conv(kernel, xs, cs, n_ops, a, b, wt, bias, residual, pw, pbias, y, proj, s1, s2,
                     B, H, W, Cout, apply_silu, th, tw, bn, mt, stages, grid,
                     packed ? toff : nullptr, 2 * (tw + 2) + 2, 0, stream);
}

}  // namespace

extern "C" {

// xs[n_ops]: operands (B,H,W,cs[k]) bf16, 16-byte aligned; a, b (B, sum cs)
// f32, or both null (the identity prologue; apply_silu is then ignored);
// bias (Cout) f32 or null; residual (B,H,W,Cout) bf16 or null; pbias (Cout) f32 with
// pw, else null; y and proj (B,H,W,Cout) bf16 (proj null without pw); s1,
// s2 (B,Cout) f32, zeroed by the caller, or both null. 1 <= n_ops <= 4,
// every cs[k] and Cout a positive multiple of 8.
//
// wt is (n_q, taps, cpad, 64) bf16 and pw (n_q, cpad, 64), with n_q the
// chunks of 64 channels over the operands (each operand's channels
// zero-padded to whole chunks), taps 9 (unpacked, packed_struct 0) or the 4
// combined taps (packed_struct 1, each chunk's channels in parity-class
// order, the shortcut's too), cpad Cout rounded up to 64 (zero rows) and
// each 128-byte row of 64 channels stored with its 16-byte group j at
// j ^ (row mod 8); th, tw, bn, mt, stages and grid are `conv_plan`'s tile,
// N tile, m64 tiles a warpgroup, ring depth and number of (persistent)
// blocks. `pipelined` is ignored. toff (packed; else null): 16 ints, the
// staged offset of combined tap t's k-step ks at [4 t + ks] (`struct_
// tap_offsets` on the host).
//
// Launches on `stream` and returns cudaGetLastError().
int ml_mdm_affine_silu_conv3x3(const void* const* xs, const int* cs, int n_ops,
                               const void* a, const void* b, const void* wt,
                               const void* bias, const void* residual,
                               const void* pw, const void* pbias, void* y,
                               void* proj, void* s1, void* s2, int B, int H,
                               int W, int Cout, int apply_silu, int packed_struct,
                               int pipelined, int th, int tw, int bn, int mt, int stages,
                               int grid, const int* toff, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Cout % 8 != 0 || n_ops < 1 ||
      n_ops > MAX_OPS || (pw == nullptr) != (proj == nullptr) ||
      (pw != nullptr && pbias == nullptr) || (a == nullptr) != (b == nullptr) ||
      wt == nullptr || y == nullptr || (s1 == nullptr) != (s2 == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_ops; ++k)
    if (cs[k] <= 0 || cs[k] % 8 != 0 || xs[k] == nullptr) return (int)cudaErrorInvalidValue;
  (void)pipelined;
  return launch_wgmma(xs, cs, n_ops, a, b, wt, bias, residual, pw, pbias, y, proj, s1, s2, B, H,
                      W, Cout, apply_silu, packed_struct, th, tw, bn, mt, stages, grid, toff,
                      (cudaStream_t)stream);
}

// The kernel's dynamic shared memory for a plan, in bytes (the
// host's `conv_plan` computes the same).
size_t ml_mdm_conv3x3_smem_bytes(int bn, int th, int tw, int stages) {
  return wg_smem_bytes(bn, th, tw, stages);
}

}  // extern "C"
