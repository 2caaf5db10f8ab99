// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// No TPU kernel to replace: the JAX package differentiates its attention
// with the plain jnp recompute VJP `_flash_vjp_bwd` of
// src/repro/kernels/ref.py:106-154, and this kernel computes the same
// function.  Given q, k, v (B, S, H, hd), the forward's output o, the
// output's gradient dO and the forward's lse (B, H, Sq) -- the natural log
// of each row's softmax denominator over the scaled logits,
// lse = m + log(max(l, 1e-30)), as flash_attention.cu writes it -- it
// recomputes p = exp(s - lse) with s = scale q.k and returns
//   delta = rowsum(dO * o),  ds = p (dO.v - delta) scale,
//   dq = ds k,  dk = ds^T q,  dv = p^T dO,
// in the inputs' dtype (fp32 or bf16), with fp32 arithmetic and sums (the
// bf16 tensor-core path rounds p and ds to bf16 for the products that take
// them, as every tensor-core flash backward does).  It honours
// causal, window, q_offset, scale, ragged Sq / Skv and strided inputs as the
// forward does (the mask and the key-tile walk come from flash_common.cuh).
// A pair that the mask hides gets p = 0, so a query row that sees no key at
// all gets dq = 0 and gives nothing to dk and dv (the plain version, whose
// masked logits are -1e30, spreads such a row over the masked keys
// instead: the two agree on every row that sees a key).
//
// Bound at the training path's shape (B=4, S=2048, H=32, hd=64, causal,
// bf16) on an H100 SXM: the five products over the visible pairs (s, dO.v^T,
// ds k, ds^T q, p^T dO) are 2.5 x the forward's ~68.8 GFLOP, ~172 GFLOP,
// ~0.1738 ms at 989 TFLOP/s; q, k, v, o, dO read and dq, dk, dv written are
// ~270 MB, ~0.08 ms at 3.35 TB/s.  So it is bound by tensor-core operations
// at ~0.17 ms (~0.43 ms at Qwen3-14B's (4, 2048, 40, 128)).  Gemma-7B's
// training shape (2, 2048, 16, 256) has the same 171.9 GFLOP and bound.
//
// bf16 design at hd 64, 128 and 256 (the training paths): three launches,
// no atomics, so the result is deterministic.
//  1. delta = rowsum(dO * o): one warp per row (below, shared with SIMT).
//  2. dK / dV (flash_bwd_dkdv_bf16): one block per (b*h, kBN keys), two
//     consumer warpgroups and no producer warpgroup, 256 threads.  K and V
//     of the tile arrive once by TMA and stay in shared memory; Q and dO
//     stream in steps of 128 (hd 64) or 64 (hd 128, 256) q rows through a
//     TMA ring of 3 stages (2 at hd 256; 128-byte swizzle, the forward's
//     4-D maps), each with its rows' lse * log2(e) and delta staged beside
//     it by one warp.  The q walk is q_range (flash_common.cuh).  Per step
//     a warpgroup issues S^T = K Q^T and dP^T = V dO^T (wgmma SS,
//     m64n128k16 or m64n64k16, Q and dO K-major as the forward's K);
//     P^T = exp2(S^T scale log2 e - lse2) and dS^T = P^T (dP^T - delta) are
//     computed in the accumulator layout, whose columns are q rows (each
//     thread reads the lse2 and delta of its columns 2 (lane % 4) + 8 j
//     from the staged vectors), and pack in place into bf16 A fragments;
//     dV += P^T dO and dK += dS^T Q are wgmma RS with dO and Q read MN-major
//     from the same stage, as the forward reads V.  Every product is waited
//     for in the step that issued it.  The last of the 8 consumer warps to
//     release a stage (a counter in shared memory) refills it.  dK and dV
//     stay in fp32 registers and are stored once as bf16, dK times scale.
//     At hd 64 / 128 a block owns 128 keys, 64 a warpgroup, and all of hd
//     (dK and dV 2 x 64 fp32 a thread at hd 128).  At hd 256 the same split
//     would need 2 x 128 for dK and dV alone, so a block owns 64 keys and
//     its warpgroups split hd instead: warpgroup w accumulates columns
//     [128 w, 128 w + 128) of dK and dV (2 x 64 fp32 a thread, as at hd
//     128), and both need all of P^T and dS^T for the 64 keys.  Warpgroup
//     0 computes S^T and P^T, warpgroup 1 dP^T and dS^T (each product once,
//     over all 256 columns); P^T crosses to warpgroup 1 in fp32 and dS^T
//     comes back as bf16 A fragments, through 24 KB of shared memory in the
//     accumulator layout, behind named barriers 1 and 2.  Both then issue
//     their halves of dV += P^T dO and dK += dS^T Q.  (With both
//     warpgroups computing S^T and dP^T instead, 9 products a pair and no
//     exchange, dK / dV took 0.4272 ms at (2, 2048, 16, 256) against
//     0.3626 ms; chip_smoke.py's profile.)
//  3. dQ (flash_bwd_dq_bf16): one block per (b*h, 128 q rows), heaviest
//     first, two consumer warpgroups of 64 rows.  Q and dO stay resident;
//     K and V stream in 64-key tiles over the forward's kv_range.  Per tile
//     S = Q K^T and dP = dO V^T (SS), P and dS with each row's lse2 and
//     delta in registers, dS packed into A fragments, dQ += dS K (RS, K
//     read MN-major); V is released after dP, K after dQ's product.  dQ is
//     stored once, times scale.  At hd 64 / 128 the forward's producer
//     warpgroup (384 threads) fills a ring of 3 (hd 64) or 2 (hd 128)
//     stages.  At hd 256 dQ alone is 128 fp32 registers a thread, so there
//     is no producer (256 threads, as the forward's hd 256): thread 0
//     loads Q, dO and the first tiles, and the last consumer warp to
//     release a K or V slot refills it.  Q and dO for 128 rows take 128 KB,
//     so of the three layouts that fit -- 64-key tiles in one stage,
//     32-key tiles in two (n32 products, which read as many shared-memory
//     bytes per operation as the tensor cores can take at n64, twice over),
//     or 64 q rows a block (S and dP computed twice again) -- it takes the
//     first and gives K, which is held until dQ's product, a second stage:
//     two K stages and one V stage, 224 KB (V is released after dP, early
//     in a tile, so its refill runs under the rest of the tile).
//  Masks, in both: only a tile that holds a masked pair (the causal
//  diagonal, the window's edge, the Sq / Skv tails) selects p = 0 outside
//  each row's (or key's) visible range; nothing is masked by a product, so
//  the inf of exp2(s - lse) on a row that sees no key (lse ~ -6.9e29) never
//  meets a 0.  Rows past Sq get lse2 = delta = 0 from the stager, not from
//  TMA's zero fill.
//  Registers: ptxas budgets the wgmma pipeline by the registers the launch
//  bound leaves a thread (168 at 384 threads, and it did the same at 288),
//  whatever setmaxnreg gives the consumers' region; a consumer whose
//  accumulators and in-flight products need more has its wgmma serialized
//  (ptxas info C7512) and spills.  dK / dV (dK, dV, S^T and dP^T: 192 fp32
//  a thread at hd 64 / 128) needs more, hence 256 threads (255
//  registers): ptxas uses 242 registers (hd 64), 235 (hd 128) and 208 (hd
//  256: dK and dV 128, one of S^T or dP^T 32), 0 bytes spilled.  dQ fits
//  in 168 with 64-key tiles at hd 64 / 128 (S and dP 32 each, dQ 32 or
//  64); with 128-key tiles at hd 64 it spilled.  At hd 256 dQ (128), S and
//  dP (32 each) are 192 fp32 a thread: 232 registers, 0 spilled.
//  Shared memory: dK / dV 132.1 KB (hd 64) / 162.6 KB (hd 128) / 218.1 KB
//  (hd 256: K + V 64 KB, 2 x (Q + dO) 128 KB, the exchange 24 KB), dQ
//  81.1 / 129.1 / 225.1 KB; one block an SM.
//  Products: 7 per visible pair (S and dP are computed by both kernels),
//  ~240.7 GFLOP at the main shape and at Gemma-7B's (2, 2048, 16, 256)
//  against the bound's 5 (171.9 GFLOP).  At (2, 2048, 16, 256) causal the
//  call takes ~0.67 ms on an H100 (delta 0.027, dK / dV 0.363, dQ 0.242;
//  PERF.md).  Accumulating dQ
//  in the dK / dV kernel with fp32 atomics (as FlashAttention-2 / 3 do)
//  would save the two recomputed products but give up determinism and add
//  an fp32 dQ buffer and a convert pass; that is left for a later change.
//
// SIMT design, for fp32 at every head dim (the tensor cores would round to
// tf32) and for bf16 at head dims 16 and 32 (the forward's split):
// simple and right, not fast.  Three launches a call, no atomics, fp32 on
// the FMA units, where the bound's products take >= 2.6 ms at 67 TFLOP/s
// (this path does 7 hd-long FMA chains a visible pair, ~240 GFLOP at the
// main shape, so >= 3.6 ms).
//  1. delta: one warp per row.
//  2. dK / dV: one block per (b*h, tile of kRows keys); TPR threads per key
//     row hold a share of its k, v, dk and dv in registers (at most 16 floats
//     each: TPR = 4 up to hd 64, hd / 16 above).  The block walks the q rows
//     that see a key of its tile (q_range), staging kTile rows of q and dO
//     in shared memory (two fp32 tiles, 32 KB at most) with their lse and
//     delta, read by broadcast.
//  3. dQ: one block per (b*h, tile of kRows q rows), heaviest first; q, dO
//     and dq of a row in registers across TPR threads, the forward's
//     kv_range over kTile-key tiles of k and v staged in shared memory.
//
// DeepSeek-V3's latent (MLA) layout (entry `flash_attention_mla_bwd`): q
// (B, Sq, H, 576) over one k head (B, Skv, 1, 576) and one v head (B, Skv,
// 1, 512) shared by all of q's heads, o and dO (B, Sq, H, 512).  The same
// function, with dK and dV summed over the heads (the plain twin's
// `flash_attention_bwd_plain` sums a shared head likewise).  Where v is k's
// first 512 features (`shared_kv`, as `mla_attention` passes k_eff[...,
// :512]) the caller may ask for k's whole gradient, dK + [dV, 0]
// (`dv_into_dk`), which autograd would form anyway; `FlashAttention` does.
// Bound at V3's training shape (B, 2048, 128, 576 / 512), causal: five
// products over 2,098,176 visible pairs a head and sequence, S 576 + dP
// 512 + dQ 576 + dK 576 + dV 512 = 2752 multiply-adds a pair, B x 1.478
// TFLOP: 1.494 ms at B = 1 on the bf16 tensor cores; q, o, dO read and dq
// written are ~1.1 GB a sequence (0.34 ms), so operations bound it.  Four
// launches (five where dV is wanted apart in bf16), no atomics, so two
// calls are bitwise equal:
//  1. delta = rowsum(dO * o): the kernel above at 512 features.
//  2. Partial dK (and dV) of a key tile over one head group, to fp32
//     scratch (B, ceil(H / 16), Skv, width).
//  3. flash_bwd_mla_sum: the groups' partials summed in order, stored in T
//     (with dv_into_dk, dK + [dV, 0] into dk alone).
//  4. dQ.
//
// bf16 (flash_bwd_mla_dk_bf16, flash_bwd_mla_dq_bf16): TMA, mbarriers and
// wgmma, two warpgroups and no producer (256 threads), one block an SM.
// Both kernels have one shape: a resident operand of 64 rows (the dK
// kernel's 64 keys; the dQ kernel's 64 rows (position, head), as the
// forward lays them out) and a streamed one of 32 rows a step (a step's
// rows (position, head); a tile's keys), in 128-byte-swizzled boxes of 64
// features.  Per step warpgroup 0 computes S^T = K Q^T (dK) or S = Q K^T
// (dQ), 36 k steps of m64n32k16 (SS), and warpgroup 1 dP^T = V dO^T or
// dP = dO V^T, 32 k steps, at once; warpgroup 0 turns S into P (exp2 of
// S scale log2(e) - lse2, 0 outside the mask) and hands it to warpgroup 1
// in fp32 (8 KB), which forms dS = P (dP - delta) and hands back its bf16
// A fragments (4 KB), behind named barriers 1 and 2; then each warpgroup
// adds its share of the register-operand products (RS, m64n256k16 and
// m64n64k16), the streamed operand read MN-major: warpgroup 0 column
// boxes [0, 4) (256 columns, 128 fp32 a thread), warpgroup 1 boxes [4, 9)
// (320 columns, 160).  The 256 | 320 split, not 288 | 288, balances the
// dK kernel's work once its P^T dO half is counted (S^T 576 + 256 + 256
// against dP^T 512 + 320 + 256 multiply-adds a pair), keeps every
// operand box-aligned and needs only the n256 and n64 shapes.  P, dS and
// their transposes are rounded to bf16 for the products that take them,
// as in the dense bf16 backward.
//  * dK (kFused): a block owns a 64-key tile (K, 72 KB, resident; V its
//    first 8 boxes) and one group of hg = min(16, H rounded up to a power
//    of 2) heads, and walks the group's rows that see the tile (q_range)
//    in steps of 32 rows, 32 / hg positions x hg heads (one TMA box over
//    (576, H, Sq, B) a step and 64-feature column: no gather), from the
//    top position down and aligned to multiples of 32 / hg positions, so
//    the resident blocks of a head group read the same Q and dO rows at
//    about the same time (at batch 1 the rows a call streams total 9.4 GB,
//    ~2.8 ms from HBM alone).  Q (36 KB) and dO (32 KB) of a step stream
//    through 2 stages with their rows' lse2 and delta (a row outside the
//    walk or past H gets lse2 = +inf: P = 0 without a mask), the last of
//    the 8 warps to release a stage refilling it: 226.9 KB of shared
//    memory.  The fp32 dK and dV of 64 keys would be 272 KB, more than the
//    register file, so the block accumulates their sum, dS^T Q over all
//    576 columns plus P^T dO into the first 512 (one 64 x 576
//    accumulator, split as above), the gradient autograd forms for k_eff;
//    dS^T is scaled before its rounding.  A head group keeps 256 blocks at
//    (1, 2048, 128) for 132 SMs, and the causal walks, 32x apart in length,
//    run longest first.  Where dV is wanted apart, or v is a tensor of its
//    own, the same kernel runs a dK pass (kDK) and a dV pass (kDV: S^T
//    and P^T alone) into a 1088-wide scratch; with a separate v one stage
//    and a 64 KB V tile.
//  * dQ: a block owns 64 rows (position, head), heaviest first; Q (72 KB)
//    and dO (64 KB) are resident and 32-key K tiles (36 KB) stream through
//    2 stages (V the K stage's first 8 boxes; a separate v: one stage of
//    K and V), 226.3 KB.  Of the two layouts that fit, one 64-key stage or
//    two 32-key stages, it takes the second: a single stage is read to the
//    end of each tile (S, dP and dS K), so its refill could not overlap
//    any product (these kernels with one 32-key stage took dQ 1.86 ->
//    2.53 ms and dK 2.53 -> 3.52 at (1, 2048, 128) on an H100:
//    tools/mla_bwd_ablation.py's one_stage).  dQ is 64 x 576 fp32, split
//    as above, stored once, times scale.
//  Registers (ptxas, sm_90a): dK 216 (kFused and the passes with V from
//  K; 226 with a separate V), dQ 216-217, 0 spilled, no C75xx.  Products:
//  dK 2176 and dQ 1664 multiply-adds a pair, 3840 against the bound's
//  2752.  At (1, 2048, 128) causal the fused call took 4.65 ms on an H100
//  (dK 2.52, dQ 1.85, delta 0.18, sum 0.01 ms; PERF.md), 3.1x its bound.
//
// fp32 (SIMT: the tensor cores would round to tf32): fp32 arithmetic on
// the FMA units.
//  2. Partial dK / dV (flash_bwd_mla_dkdv): the fp32 dK and dV of a 16-key
//     tile take 16 x 1088 x 4 = 69.6 KB, of 64 keys 278.5 KB, more than an
//     SM's register file; so a block owns 16 keys and one group of 16
//     heads (kHG), and the 8 groups of V3's 128 heads run in parallel.
//     256 threads: a key's 16 lanes hold its k, v, dk and dv at float4
//     chunks t + 16 c (136 fp32 registers a thread), and the block walks
//     the rows (position, head) of its group that see a key of the tile
//     (q_range), 16 rows a stage, q and dO staged raw through two cp.async
//     stages (139.5 KB) with their lse and delta.  Per row: the 16 lanes'
//     partial S and dP summed by shuffles, p = exp(s scale - lse) and ds =
//     p (dP - delta) scale, then dK += ds q and dV += p dO from the staged
//     row, read again (holding it beside the key's registers spilled).
//     Each lane's q read serves the two keys of its warp.  The block writes
//     its fp32 partials to scratch (B, ceil(H / 16), Skv, 1088).
//  4. dQ (flash_bwd_mla_dq): 16 rows a block, heads as rows as the forward
//     lays them out (at H = 128 a block is 16 heads of one position),
//     heaviest first; a row's 16 lanes hold its q, dO and dq (104 fp32
//     registers) and walk 16-key tiles of K and V over the forward's
//     kv_range through two cp.async stages; where v is k's first 512
//     features V is read from the K tile and not loaded.
//  S and dP are computed in both 2 and 4.  At (1, 2048, 128) in bf16 the
//  SIMT design (then run for bf16 too) took ~143 ms on an H100 (PERF.md).
//  A row that sees no key gets dq = 0 and adds nothing to dK and dV, as
//  above.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using flash::Strides;

constexpr int kThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq), written by the first launch
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, Sq, Skv;
  int causal, window, q_offset;  // window <= 0: none
  float scale;
};

// TPR threads per row, each holding the float4 chunks {TPR i + t} of the row
// (kC4 of them, at most 4); kRows rows per block; kTile rows of the other
// operand per shared-memory tile.
template <int HD>
struct Cfg {
  static constexpr int kTPR = HD <= 64 ? 4 : HD / 16;
  static constexpr int kRows = kThreads / kTPR;
  static constexpr int kTile = 4096 / HD < 64 ? 4096 / HD : 64;
  static constexpr int kC4 = HD / (4 * kTPR);
  static constexpr int kN = 4 * kC4;  // floats a thread holds of a row
};

// A thread's share of one row of a (B, S, H, hd) tensor, as fp32; zeros
// where the row does not exist.
template <int HD, typename T>
__device__ __forceinline__ void load_row(float (&dst)[Cfg<HD>::kN],
                                         const T* row, int t, bool exists) {
#pragma unroll
  for (int i = 0; i < Cfg<HD>::kC4; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (exists) x = flash::load4(row + 4 * (Cfg<HD>::kTPR * i + t));
    dst[4 * i + 0] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
  }
}

template <int HD, typename T>
__device__ __forceinline__ void store_row(T* row, const float (&src)[Cfg<HD>::kN],
                                          int t) {
#pragma unroll
  for (int i = 0; i < Cfg<HD>::kC4; ++i)
    flash::store4(row + 4 * (Cfg<HD>::kTPR * i + t),
                  make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2],
                              src[4 * i + 3]));
}

// Rows [r0, r0 + ROWS) of a tensor (row stride `stride`) into an fp32 tile
// [ROWS][HD] in shared memory; rows at or past `limit` as zeros.
template <int HD, int ROWS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int limit) {
  for (int c = threadIdx.x; c < ROWS * HD / 4; c += kThreads) {
    const int r = c / (HD / 4), cc = c % (HD / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) x = flash::load4(src + (r0 + r) * stride + 4 * cc);
    *reinterpret_cast<float4*>(dst + r * HD + 4 * cc) = x;
  }
}

// A thread's chunks of a shared-memory row into registers, and their dot
// product with `a`.
template <int HD>
__device__ __forceinline__ float read_dot(float (&dst)[Cfg<HD>::kN],
                                          const float* row,
                                          const float (&a)[Cfg<HD>::kN]) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < Cfg<HD>::kC4; ++i) {
    const float4 x =
        *reinterpret_cast<const float4*>(row + 4 * Cfg<HD>::kTPR * i);
    dst[4 * i + 0] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
    d = fmaf(a[4 * i + 0], x.x, d);
    d = fmaf(a[4 * i + 1], x.y, d);
    d = fmaf(a[4 * i + 2], x.z, d);
    d = fmaf(a[4 * i + 3], x.w, d);
  }
  return d;
}

// 1. delta = rowsum(dO * o): one warp per (b, h, row), rows in (B, H, Sq)
// order.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta(const Params p, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % p.Sq);
  const long long bh = row / p.Sq;
  const int h = static_cast<int>(bh % p.H), b = static_cast<int>(bh / p.H);
  const T* O = static_cast<const T*>(p.o) + b * p.so.b + i * p.so.s + h * p.so.h;
  const T* dO =
      static_cast<const T*>(p.dout) + b * p.sdo.b + i * p.sdo.s + h * p.sdo.h;
  float d = 0.f;
  for (int c = lane; c < HD / 4; c += 32) {
    const float4 x = flash::load4(O + 4 * c), y = flash::load4(dO + 4 * c);
    d = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, d))));
  }
  d = flash::row_sum<32>(d);
  if (lane == 0) p.delta[row] = d;
}

// 2. dK and dV of one tile of kRows keys.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const Params p) {
  using C = Cfg<HD>;
  constexpr int TPR = C::kTPR, TILE = C::kTile, N = C::kN;
  __shared__ __align__(16) float sQ[TILE * HD];
  __shared__ __align__(16) float sdO[TILE * HD];
  __shared__ float sL[TILE], sD[TILE];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * C::kRows;
  const int t = threadIdx.x % TPR;
  const int kj = k0 + threadIdx.x / TPR;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* K = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* V = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* dO = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const float* L = p.lse + bh * p.Sq;
  const float* D = p.delta + bh * p.Sq;

  float k[N], v[N], dk[N], dv[N];
  load_row<HD>(k, K + kj * p.sk.s, t, kj < p.Skv);
  load_row<HD>(v, V + kj * p.sv.s, t, kj < p.Skv);
#pragma unroll
  for (int d = 0; d < N; ++d) dk[d] = dv[d] = 0.f;

  // the q rows that see some key of [k0, k0 + kRows)
  int qlo, qhi;
  flash::q_range(p.Sq, p.causal, p.window, p.q_offset, k0, C::kRows, qlo,
                 qhi);
  for (int i0 = qlo; i0 < qhi; i0 += TILE) {
    stage<HD, TILE>(sQ, Q, p.sq.s, i0, p.Sq);
    stage<HD, TILE>(sdO, dO, p.sdo.s, i0, p.Sq);
    for (int r = threadIdx.x; r < TILE; r += kThreads) {
      const bool exists = i0 + r < p.Sq;
      sL[r] = exists ? L[i0 + r] : 0.f;
      sD[r] = exists ? D[i0 + r] : 0.f;
    }
    __syncthreads();
    const int n = min(TILE, qhi - i0);  // block-uniform
    for (int ii = 0; ii < n; ++ii) {
      float qv[N], ov[N];
      float s = read_dot<HD>(qv, sQ + ii * HD + 4 * t, k);
      float dp = read_dot<HD>(ov, sdO + ii * HD + 4 * t, v);
      s = flash::row_sum<TPR>(s);
      dp = flash::row_sum<TPR>(dp);
      const float pr = flash::visible(p.Skv, p.causal, p.window,
                                      i0 + ii + p.q_offset, kj)
                           ? expf(s * p.scale - sL[ii])
                           : 0.f;
      const float ds = pr * (dp - sD[ii]) * p.scale;
#pragma unroll
      for (int d = 0; d < N; ++d) {
        dv[d] = fmaf(pr, ov[d], dv[d]);
        dk[d] = fmaf(ds, qv[d], dk[d]);
      }
    }
    __syncthreads();
  }
  if (kj < p.Skv) {
    store_row<HD>(static_cast<T*>(p.dk) + b * p.sdk.b + kj * p.sdk.s +
                      h * p.sdk.h, dk, t);
    store_row<HD>(static_cast<T*>(p.dv) + b * p.sdv.b + kj * p.sdv.s +
                      h * p.sdv.h, dv, t);
  }
}

// 3. dQ of one tile of kRows query rows.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Params p) {
  using C = Cfg<HD>;
  constexpr int TPR = C::kTPR, TILE = C::kTile, N = C::kN;
  __shared__ __align__(16) float sK[TILE * HD];
  __shared__ __align__(16) float sV[TILE * HD];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;  // heaviest first
  const int t = threadIdx.x % TPR;
  const int qi = q0 + threadIdx.x / TPR;
  const bool exists = qi < p.Sq;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const T* K = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* V = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  float q[N], o[N], dq[N];
  load_row<HD>(q, static_cast<const T*>(p.q) + b * p.sq.b + qi * p.sq.s +
                      h * p.sq.h, t, exists);
  load_row<HD>(o, static_cast<const T*>(p.dout) + b * p.sdo.b +
                      qi * p.sdo.s + h * p.sdo.h, t, exists);
#pragma unroll
  for (int d = 0; d < N; ++d) dq[d] = 0.f;
  const float lse = exists ? p.lse[bh * p.Sq + qi] : 0.f;
  const float delta = exists ? p.delta[bh * p.Sq + qi] : 0.f;
  const int qpos = qi + p.q_offset;

  int lo, hi;
  flash::kv_range(p.Sq, p.Skv, p.causal, p.window, p.q_offset, q0, C::kRows,
                  TILE, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * TILE;
    stage<HD, TILE>(sK, K, p.sk.s, k0, p.Skv);
    stage<HD, TILE>(sV, V, p.sv.s, k0, p.Skv);
    __syncthreads();
    for (int jj = 0; jj < TILE; ++jj) {
      float kv[N], vv[N];
      float s = read_dot<HD>(kv, sK + jj * HD + 4 * t, q);
      float dp = read_dot<HD>(vv, sV + jj * HD + 4 * t, o);
      s = flash::row_sum<TPR>(s);
      dp = flash::row_sum<TPR>(dp);
      const float pr =
          exists && flash::visible(p.Skv, p.causal, p.window, qpos, k0 + jj)
              ? expf(s * p.scale - lse)
              : 0.f;
      const float ds = pr * (dp - delta) * p.scale;
#pragma unroll
      for (int d = 0; d < N; ++d) dq[d] = fmaf(ds, kv[d], dq[d]);
    }
    __syncthreads();
  }
  if (exists)
    store_row<HD>(static_cast<T*>(p.dq) + b * p.sdq.b + qi * p.sdq.s +
                      h * p.sdq.h, dq, t);
}

// ---------------------------------------------------------------------------
// bf16 at hd 64 and 128: TMA + mbarrier ring + wgmma kernels
// ---------------------------------------------------------------------------

// ptxas budgets the wgmma pipeline by the registers the launch bound leaves
// a thread (168 for 384 threads, and the same at 288), whatever setmaxnreg
// gives the consumers; a consumer that needs more has its wgmma serialized
// (C7512) and spills.  The dK / dV consumers (dK, dV, S^T and dP^T: 192
// fp32 a thread) need more, so that kernel runs two warpgroups and no
// producer (255 registers); the dQ consumers fit in 168 at hd 64 / 128, so
// dQ keeps the forward's producer warpgroup there, and at hd 256 (dQ alone
// is 128) runs without one, as the forward does.
constexpr int kTcConsumers = 2;   // consumer warpgroups
constexpr int kKvThreads = 128 * kTcConsumers;
constexpr float kLog2e = 1.4426950408889634f;

// dK / dV: a block owns kBN keys, whose K and V tiles stay in shared
// memory; Q and dO stream through a ring of kStages steps of kBM q rows,
// each with its rows' lse (in base 2) and delta as fp32 vectors.  At hd 64
// / 128 each consumer warpgroup takes 64 of the 128 keys and all of hd; at
// hd 256 (kSplit) both take the block's 64 keys and each owns kCols of the
// 64-wide column blocks of dK and dV (128 columns: a full 64 x 256 fp32
// pair would be 256 registers a thread), one computing P^T and the other
// dS^T for both.  Offsets in bytes from a 1024-byte-aligned base: K, V,
// the Q stages, the dO stages, the lse and delta vectors, the mbarriers, a
// release counter per stage, and at hd 256 the exchange of P^T and dS^T.
template <int HD>
struct KvCfg {
  static constexpr bool kSplit = HD == 256;
  static constexpr int kBN = kSplit ? 64 : 128;  // keys per block
  // q rows per step: 128 at hd 64 (S^T and dP^T 64 fp32 each beside dK
  // and dV's 32: the larger products halve the per-step waits, 0.4187 ->
  // 0.3556 ms at the main shape in chip_smoke.py's profile), 64 at hd 128
  // and 256 (dK and dV take 128)
  static constexpr int kBM = HD == 64 ? 128 : 64;
  static constexpr int kR = kBM / 32;  // of them a lane stages
  // K + V 64 KB and a step of Q + dO 64 KB at hd 256: two stages fit
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kSub = HD / kBox;  // 64-wide column blocks
  static constexpr int kCols = kSplit ? kSub / 2 : kSub;  // a warpgroup's
  static constexpr int kKVBytes = kBN * HD * 2;    // the K or the V tile
  static constexpr int kStepBytes = kBM * HD * 2;  // one step of Q or dO
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kKVBytes;
  static constexpr uint32_t kQ = 2 * kKVBytes;     // stage st: + st * kStepBytes
  static constexpr uint32_t kDO = kQ + kStages * kStepBytes;
  static constexpr uint32_t kL = kDO + kStages * kStepBytes;  // + st * kBM * 4
  static constexpr uint32_t kD = kL + kStages * kBM * 4;
  static constexpr uint32_t kKVFull = kD + kStages * kBM * 4;
  static constexpr uint32_t kQFull = kKVFull + 8;  // stage st: + 8 st, as the rest
  static constexpr uint32_t kDOFull = kQFull + 8 * kStages;
  static constexpr uint32_t kLFull = kDOFull + 8 * kStages;
  static constexpr uint32_t kCount = kLFull + 8 * kStages;
  // hd 256: P^T (fp32) and dS^T (bf16 fragments) handed between the
  // warpgroups, 32 and 16 words a thread
  static constexpr uint32_t kX = kCount + 8 * kStages;
  static constexpr uint32_t kY = kX + (kSplit ? 128 * (kBM / 2) * 4 : 0);
  static constexpr int kSmem =
      1024 + kY + (kSplit ? 128 * (kBM / 4) * 4 : 0);  // + alignment
};

// dQ: a block owns kBQ q rows, 64 per consumer warpgroup, whose Q and dO
// tiles stay in shared memory; K and V stream through rings of kBK-key
// tiles, kKStages of K and kVStages of V.  At hd 64 / 128 a producer
// warpgroup fills them, as the forward's; at hd 256 there is none and the
// consumers refill them (the "empty" slots are release counters).  Q and
// dO for 128 rows take 128 KB there, which leaves room for two K stages
// and one V stage (224 KB in all): V is released after dP, early in a
// tile, so its refill runs under the rest of the tile, while K is held
// until dQ's product and so gets the second stage.  Offsets: Q, dO, the K
// stages, the V stages, the mbarriers and counters.
template <int HD>
struct QCfg {
  static constexpr bool kProducer = HD != 256;
  static constexpr int kThreads = 128 * (kTcConsumers + (kProducer ? 1 : 0));
  static constexpr int kBQ = 128;                  // q rows per block
  static constexpr int kBK = 64;                   // keys per K/V tile
  static constexpr int kKStages = HD == 64 ? 3 : 2;
  static constexpr int kVStages = HD == 256 ? 1 : kKStages;
  static constexpr int kSub = HD / kBox;
  static constexpr int kQBytes = kBQ * HD * 2;     // the Q or the dO tile
  static constexpr int kTileBytes = kBK * HD * 2;  // one K or one V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQBytes;
  static constexpr uint32_t kK = 2 * kQBytes;      // stage st: + st * kTileBytes
  static constexpr uint32_t kV = kK + kKStages * kTileBytes;
  static constexpr uint32_t kQFull = kV + kVStages * kTileBytes;
  static constexpr uint32_t kKFull = kQFull + 8;
  static constexpr uint32_t kVFull = kKFull + 8 * kKStages;
  static constexpr uint32_t kKEmpty = kVFull + 8 * kVStages;
  static constexpr uint32_t kVEmpty = kKEmpty + 8 * kKStages;
  static constexpr int kSmem = 1024 + kVEmpty + 8 * kVStages;
};

// C (64 x N) = A B^T for one warpgroup, A (64 rows) and B (N rows) read
// K-major from 128-byte-swizzled tiles of a_rows / b_rows rows; issued, not
// waited for.  S^T = K Q^T and dP^T = V dO^T (dK / dV), S = Q K^T and
// dP = dO V^T (dQ).
template <int HD, int N>
__device__ __forceinline__ void issue_abt(float (&c)[N / 2], uint32_t a,
                                          int a_rows, uint32_t b,
                                          int b_rows) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(c, sw128_desc(a + (kk / 4) * a_rows * 128 + (kk % 4) * 32, 16,
                           1024),
             sw128_desc(b + (kk / 4) * b_rows * 128 + (kk % 4) * 32, 16,
                        1024),
             kk > 0);
  wgmma_commit();
}

// acc (64 x 64 NC) += A B: A the bf16 fragments of a 64 x K accumulator
// tile, B the NC 64-column blocks from `b` of a K-row tile [K][hd] (a
// block is K rows of 128 bytes) read MN-major; a k step is 16 rows (2048
// bytes).  Issued, not committed.
template <int NC, int K>
__device__ __forceinline__ void issue_ab(float (&acc)[NC][32],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs(acc[c], a[kk], sw128_desc(b + c * K * 128 + kk * 2048, K * 128,
                                         1024));
}

// One thread's two rows of an accumulator tile (64 x 64 NC, fp32, times
// `mul`) stored as bf16 to rows row0 and row0 + 8 of a (B, S, H, hd)
// tensor from column 0 of `dst`, those below `limit`.
template <int NC>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst,
                                           long long row_stride, int row0,
                                           int limit,
                                           const float (&acc)[NC][32],
                                           float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    __nv_bfloat16* out = dst + row * row_stride + 2 * t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 64 * c + 8 * j) =
            pack_bf16(acc[c][4 * j + 2 * r] * mul,
                      acc[c][4 * j + 2 * r + 1] * mul);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// The q rows of a step at row i0 that one lane stages, i0 + lane + 32 r
// for r < R: lse * log2(e) and delta, 0 for rows past Sq.
template <int R>
__device__ __forceinline__ void fetch_rows(const Params& p, long long bh,
                                           int i0, float (&l)[R],
                                           float (&d)[R]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = i0 + lane + 32 * r;
    const bool exists = row < p.Sq;
    l[r] = exists ? p.lse[bh * p.Sq + row] * kLog2e : 0.f;
    d[r] = exists ? p.delta[bh * p.Sq + row] : 0.f;
  }
}

// Step `it` (q rows from i0) into stage it % kStages, by one whole warp:
// lane 0 issues the TMA loads of its Q and dO rows, every lane writes its
// rows' lse2 and delta (from fetch_rows) and arrives on the step's row
// barrier.
template <int HD>
__device__ __forceinline__ void load_step(const CUtensorMap* tq,
                                          const CUtensorMap* tdo,
                                          uint8_t* smem, uint32_t base,
                                          int it, int i0, int h, int b,
                                          const float (&l)[KvCfg<HD>::kR],
                                          const float (&d)[KvCfg<HD>::kR]) {
  using C = KvCfg<HD>;
  const int st = it % C::kStages, lane = threadIdx.x % 32;
  if (lane == 0) {
    const uint32_t q_full = base + C::kQFull + 8 * st;
    const uint32_t do_full = base + C::kDOFull + 8 * st;
    mbar_expect_tx(q_full, C::kStepBytes);
    for (int c = 0; c < C::kSub; ++c)
      tma_load(base + C::kQ + st * C::kStepBytes + c * C::kBM * 128, tq,
               q_full, c * kBox, i0, h, b);
    mbar_expect_tx(do_full, C::kStepBytes);
    for (int c = 0; c < C::kSub; ++c)
      tma_load(base + C::kDO + st * C::kStepBytes + c * C::kBM * 128, tdo,
               do_full, c * kBox, i0, h, b);
  }
  float* sl = reinterpret_cast<float*>(smem + C::kL) + st * C::kBM;
  float* sd = reinterpret_cast<float*>(smem + C::kD) + st * C::kBM;
#pragma unroll
  for (int r = 0; r < C::kR; ++r) {
    sl[lane + 32 * r] = l[r];
    sd[lane + 32 * r] = d[r];
  }
  mbar_arrive(base + C::kLFull + 8 * st);
}

// Consumer warpgroup WG of the dK / dV kernel owns keys [kw0, kw0 + 64),
// kw0 = k0 + 64 WG (k0 at hd 256, where both warpgroups take the same
// keys), and the column blocks [c0, c0 + kCols) of dK and dV (all of them
// but at hd 256, where WG owns the WG-th half); a thread holds keys key0
// and key0 + 8 of the accumulator tiles, whose columns are q rows.  Per
// step of kBM q rows: S^T = K Q^T and dP^T = V dO^T (SS, over all of hd;
// at hd 256 warpgroup 0 computes S^T and warpgroup 1 dP^T); P^T =
// exp2(S^T scale log2(e) - lse2) with each column's lse2 from shared
// memory, 0 outside each key's visible q rows; dS^T = P^T (dP^T - delta);
// both packed into bf16 A fragments; dV += P^T dO and dK += dS^T Q over
// the owned columns (RS, dO and Q read MN-major from the same stage).
// Every product is waited for in the step that issued it.  Then
// each warp releases the stage, and the last to do so loads step it +
// kStages into it (its rows' lse2 and delta fetched at the top of the
// step, so their latency hides under the products).  dK is scaled once,
// at the store.
template <int HD, int WG>
__device__ __forceinline__ void consume_kv(const Params& p,
                                           const CUtensorMap* tq,
                                           const CUtensorMap* tdo,
                                           uint8_t* smem, uint32_t base,
                                           int k0, int qlo, int n_steps,
                                           int h, int b) {
  using C = KvCfg<HD>;
  constexpr int kBM = C::kBM, kN = kBM / 2;
  constexpr int kRow = C::kSplit ? 0 : 64 * WG;  // WG's first key, in the tile
  constexpr int c0 = C::kSplit ? WG * C::kCols : 0;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int kw0 = k0 + kRow;
  const int key0 = kw0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float scale_log2 = p.scale * kLog2e;
  const uint32_t k_rows = base + C::kK + kRow * 128;
  const uint32_t v_rows = base + C::kV + kRow * 128;
  // q rows that see key key0 + 8 r: [qlo_r[r], qhi_r[r])
  int qlo_r[2], qhi_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    qlo_r[r] = p.causal ? key - p.q_offset : 0;
    qhi_r[r] = p.window > 0 ? static_cast<int>(min(
                                  static_cast<long long>(p.Sq),
                                  static_cast<long long>(key) + p.window -
                                      p.q_offset))
                            : p.Sq;
    if (key >= p.Skv) qhi_r[r] = qlo_r[r];  // a key past Skv: none
  }

  float dk[C::kCols][32], dv[C::kCols][32];
  zero(dk);
  zero(dv);
  if (n_steps > 0) mbar_wait(base + C::kKVFull, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % C::kStages, i0 = qlo + it * kBM;
    const uint32_t ph = (it / C::kStages) & 1;
    const uint32_t q_st = base + C::kQ + st * C::kStepBytes;
    const uint32_t do_st = base + C::kDO + st * C::kStepBytes;
    const bool refill = it + C::kStages < n_steps;
    float nl[C::kR] = {}, nd[C::kR] = {};  // step it + kStages
    if (refill) fetch_rows(p, bh, i0 + C::kStages * kBM, nl, nd);
    const uint32_t q_full = base + C::kQFull + 8 * st;
    const uint32_t do_full = base + C::kDOFull + 8 * st;
    const float* sl = reinterpret_cast<const float*>(smem + C::kL) +
                      st * kBM + 2 * t;
    const float* sd = reinterpret_cast<const float*>(smem + C::kD) +
                      st * kBM + 2 * t;
    // a pair of the step is masked: the Sq or Skv tail, the causal
    // diagonal, the window's edge
    const bool masked =
        i0 + kBM > p.Sq || kw0 + 64 > p.Skv ||
        (p.causal && i0 + p.q_offset < kw0 + 63) ||
        (p.window > 0 && i0 + kBM - 1 + p.q_offset - kw0 >= p.window);
    const int lo_rel[2] = {qlo_r[0] - i0 - 2 * t, qlo_r[1] - i0 - 2 * t};
    const int hi_rel[2] = {qhi_r[0] - i0 - 2 * t, qhi_r[1] - i0 - 2 * t};
    // S^T -> P^T in place, 0 outside each key's visible q rows
    auto p_tile = [&](float (&x)[kN]) {
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + (e & 1), r = e >> 1;
          const float y = exp2_approx(
              fmaf(x[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          x[4 * j + e] =
              !masked || (col >= lo_rel[r] && col < hi_rel[r]) ? y : 0.f;
        }
      }
    };
    // dP^T -> dS^T = P^T (dP^T - delta) in place
    auto ds_tile = [&](const float (&pt)[kN], float (&x)[kN]) {
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(sd + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] =
              pt[4 * j + e] * (x[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
    };
    uint32_t pa[kBM / 16][4], dsa[kBM / 16][4];
    if constexpr (C::kSplit) {
      // Warpgroup 0 computes S^T and P^T, warpgroup 1 dP^T and dS^T, each
      // product once: P^T goes to warpgroup 1 in fp32 and dS^T comes back
      // as bf16 A fragments, through shared memory in the accumulator
      // layout (element i of thread tid at [i][tid]), behind named
      // barriers 1 and 2.
      const int tid = threadIdx.x % 128;
      float* xch = reinterpret_cast<float*>(smem + C::kX) + tid;
      uint32_t* ych = reinterpret_cast<uint32_t*>(smem + C::kY) + tid;
      float x[kN];
      if constexpr (WG == 0) {
        mbar_wait(q_full, ph);
        issue_abt<HD, kBM>(x, k_rows, C::kBN, q_st, kBM);
        mbar_wait(base + C::kLFull + 8 * st, ph);
        wgmma_wait<0>();
        reg_fence(x);
        p_tile(x);
#pragma unroll
        for (int i = 0; i < kN; ++i) xch[128 * i] = x[i];
        bar_arrive(1);
        pack_p(x, pa);
        bar_sync(2);
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) dsa[kk][r] = ych[128 * (4 * kk + r)];
        mbar_wait(do_full, ph);  // dV reads dO
      } else {
        mbar_wait(do_full, ph);
        issue_abt<HD, kBM>(x, v_rows, C::kBN, do_st, kBM);
        mbar_wait(base + C::kLFull + 8 * st, ph);
        wgmma_wait<0>();
        reg_fence(x);
        float pt[kN];
        bar_sync(1);
#pragma unroll
        for (int i = 0; i < kN; ++i) pt[i] = xch[128 * i];
        ds_tile(pt, x);
        pack_p(pt, pa);
        pack_p(x, dsa);
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) ych[128 * (4 * kk + r)] = dsa[kk][r];
        bar_arrive(2);
        mbar_wait(q_full, ph);  // dK reads Q
      }
    } else {
      float s[kN], dp[kN];
      mbar_wait(q_full, ph);
      issue_abt<HD, kBM>(s, k_rows, C::kBN, q_st, kBM);
      mbar_wait(do_full, ph);
      issue_abt<HD, kBM>(dp, v_rows, C::kBN, do_st, kBM);
      mbar_wait(base + C::kLFull + 8 * st, ph);
      wgmma_wait<1>();  // S^T
      reg_fence(s);
      p_tile(s);
      wgmma_wait<0>();  // dP^T
      reg_fence(dp);
      ds_tile(s, dp);
      pack_p(s, pa);
      pack_p(dp, dsa);
    }
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) {
      reg_fence(dv[c]);
      reg_fence(dk[c]);
    }
    wgmma_fence();
    issue_ab<C::kCols, kBM>(dv, pa, do_st + c0 * kBM * 128);
    issue_ab<C::kCols, kBM>(dk, dsa, q_st + c0 * kBM * 128);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) {
      reg_fence(dv[c]);
      reg_fence(dk[c]);
    }
    __syncwarp();
    if (release_last<4 * kTcConsumers>(base + C::kCount + 8 * st) &&
        refill)
      load_step<HD>(tq, tdo, smem, base, it + C::kStages,
                    i0 + C::kStages * kBM, h, b, nl, nd);
    __syncwarp();
  }
  store_tile(static_cast<__nv_bfloat16*>(p.dk) + b * p.sdk.b + h * p.sdk.h +
                 64 * c0, p.sdk.s, key0, p.Skv, dk, p.scale);
  store_tile(static_cast<__nv_bfloat16*>(p.dv) + b * p.sdv.b + h * p.sdv.h +
                 64 * c0, p.sdv.s, key0, p.Skv, dv, 1.f);
}

// 2b. dK and dV of one tile of kBN keys, bf16, on the tensor cores.  The
// grid is 1-D with the key tiles of one head adjacent, lowest keys first
// (under a causal mask they see the most q rows).  Warp 0 loads K, V and
// the first kStages steps before it turns consumer.
template <int HD>
__global__ void __launch_bounds__(kKvThreads, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const Params p) {
  using C = KvCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));

  const int n_kt = (p.Skv + C::kBN - 1) / C::kBN;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * C::kBN;
  const int b = bh / p.H, h = bh % p.H;
  int qlo, qhi;
  flash::q_range(p.Sq, p.causal, p.window, p.q_offset, k0, C::kBN, qlo, qhi);
  const int n_steps = qhi > qlo ? (qhi - qlo + C::kBM - 1) / C::kBM : 0;

  if (threadIdx.x == 0) {
    mbar_init(base + C::kKVFull, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(base + C::kQFull + 8 * st, 1);
      mbar_init(base + C::kDOFull + 8 * st, 1);
      mbar_init(base + C::kLFull + 8 * st, 32);  // a warp's lanes
      *reinterpret_cast<uint32_t*>(smem + C::kCount + 8 * st) = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // roles from a warp-uniform warp index, as the forward
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp == 0 && n_steps > 0) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(base + C::kKVFull, 2 * C::kKVBytes);
      for (int c = 0; c < C::kSub; ++c) {
        tma_load(base + C::kK + c * C::kBN * 128, &tk, base + C::kKVFull,
                 c * kBox, k0, h, b);
        tma_load(base + C::kV + c * C::kBN * 128, &tv, base + C::kKVFull,
                 c * kBox, k0, h, b);
      }
    }
    for (int it = 0; it < min(C::kStages, n_steps); ++it) {
      float l[C::kR], d[C::kR];
      fetch_rows(p, static_cast<long long>(bh), qlo + it * C::kBM, l, d);
      load_step<HD>(&tq, &tdo, smem, base, it, qlo + it * C::kBM, h, b, l,
                    d);
    }
    __syncwarp();
  }
  if (warp < 4)
    consume_kv<HD, 0>(p, &tq, &tdo, smem, base, k0, qlo, n_steps, h, b);
  else
    consume_kv<HD, 1>(p, &tq, &tdo, smem, base, k0, qlo, n_steps, h, b);
}

// One K or V tile of the dQ kernel (keys from k0) into the ring slot
// `dst`, announced on its full mbarrier; by one thread.
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* map, uint32_t dst,
                                        uint32_t full, int k0, int h, int b) {
  using C = QCfg<HD>;
  mbar_expect_tx(full, C::kTileBytes);
  for (int c = 0; c < C::kSub; ++c)
    tma_load(dst + c * C::kBK * 128, map, full, c * kBox, k0, h, b);
}

// The dQ loads, by one thread: Q and dO once, then K and V tile by tile.
// With a producer warpgroup it loads every tile, each into a slot once the
// consumers have released the slot's previous tile, as the forward's;
// without one it loads the tiles that fill the empty rings, and the
// consumers refill them.
template <int HD>
__device__ __forceinline__ void produce_q(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, uint32_t base, int q0, int h, int b, int lo,
    int n_tiles) {
  using C = QCfg<HD>;
  mbar_expect_tx(base + C::kQFull, 2 * C::kQBytes);
  for (int c = 0; c < C::kSub; ++c) {
    tma_load(base + C::kQ + c * C::kBQ * 128, &tq, base + C::kQFull,
             c * kBox, q0, h, b);
    tma_load(base + C::kDO + c * C::kBQ * 128, &tdo, base + C::kQFull,
             c * kBox, q0, h, b);
  }
  const int n_k = C::kProducer ? n_tiles : min(n_tiles, C::kKStages);
  const int n_v = C::kProducer ? n_tiles : min(n_tiles, C::kVStages);
  for (int it = 0; it < max(n_k, n_v); ++it) {
    const int k0 = (lo + it) * C::kBK;
    if (it < n_k) {
      const int st = it % C::kKStages;
      if (it >= C::kKStages)   // only with a producer
        mbar_wait(base + C::kKEmpty + 8 * st, (it / C::kKStages - 1) & 1);
      load_kv<HD>(&tk, base + C::kK + st * C::kTileBytes,
                  base + C::kKFull + 8 * st, k0, h, b);
    }
    if (it < n_v) {
      const int st = it % C::kVStages;
      if (it >= C::kVStages)
        mbar_wait(base + C::kVEmpty + 8 * st, (it / C::kVStages - 1) & 1);
      load_kv<HD>(&tv, base + C::kV + st * C::kTileBytes,
                  base + C::kVFull + 8 * st, k0, h, b);
    }
  }
}

// Consumer warpgroup WG of the dQ kernel owns q rows [q0 + 64 WG, + 64); a
// thread holds rows row0 and row0 + 8, with their lse2 and delta in
// registers.  Per K/V tile: S = Q K^T and dP = dO V^T (SS); P = exp2(S
// scale log2(e) - lse2), 0 outside each row's visible keys; dS = P (dP -
// delta) packed into bf16 A fragments; dQ += dS K (RS, K read MN-major).  V
// is released once dP is done, K once dQ's product is.
template <int HD, int WG>
__device__ __forceinline__ void consume_q(const Params& p,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          uint32_t base, int q0, int h,
                                          int b, int lo, int n_tiles) {
  using C = QCfg<HD>;
  constexpr int kBK = C::kBK, kN = kBK / 2;
  const int lane = threadIdx.x % 32, t = lane % 4;
  // The warp is done with tile it's K (V when `v`): an arrival on the
  // slot's empty mbarrier for the producer, or, without one, the last of
  // the 4 x kTcConsumers consumer warps to release the slot loads tile it +
  // stages into it.
  auto release = [&](bool v, int it) {
    const int stages = v ? C::kVStages : C::kKStages;
    const int st = it % stages;
    const uint32_t slot = base + (v ? C::kVEmpty : C::kKEmpty) + 8 * st;
    __syncwarp();
    if constexpr (C::kProducer) {
      if (lane == 0) mbar_arrive(slot);
    } else if (release_last<4 * kTcConsumers>(slot) &&
               it + stages < n_tiles && lane == 0) {
      load_kv<HD>(v ? tv : tk, base + (v ? C::kV : C::kK) + st * C::kTileBytes,
                  base + (v ? C::kVFull : C::kKFull) + 8 * st,
                  (lo + it + stages) * kBK, h, b);
    }
  };
  const int row0 = q0 + 64 * WG + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const float scale_log2 = p.scale * kLog2e;
  const uint32_t q_rows = base + C::kQ + WG * 64 * 128;
  const uint32_t do_rows = base + C::kDO + WG * 64 * 128;
  const long long bh = static_cast<long long>(b) * p.H + h;
  float lse2[2], delta[2];
  int klo[2], khi[2];  // keys visible to the thread's rows: [klo, khi)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool exists = row < p.Sq;
    lse2[r] = exists ? p.lse[bh * p.Sq + row] * kLog2e : 0.f;
    delta[r] = exists ? p.delta[bh * p.Sq + row] : 0.f;
    const int qpos = row + p.q_offset;
    khi[r] = p.causal ? min(qpos + 1, p.Skv) : p.Skv;
    klo[r] = p.window > 0 ? qpos - p.window + 1 : 0;
  }
  const int wq_first = q0 + 64 * WG + p.q_offset;
  const int wq_last = wq_first + 63;

  float dq[C::kSub][32];
  zero(dq);
  mbar_wait(base + C::kQFull, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int ks = it % C::kKStages, vs = it % C::kVStages;
    const int k0 = (lo + it) * kBK;
    const uint32_t kt = base + C::kK + ks * C::kTileBytes;
    const uint32_t vt = base + C::kV + vs * C::kTileBytes;
    float s[kN], dp[kN];
    mbar_wait(base + C::kKFull + 8 * ks, (it / C::kKStages) & 1);
    issue_abt<HD, kBK>(s, q_rows, C::kBQ, kt, kBK);
    mbar_wait(base + C::kVFull + 8 * vs, (it / C::kVStages) & 1);
    issue_abt<HD, kBK>(dp, do_rows, C::kBQ, vt, kBK);
    const bool masked = k0 + kBK > p.Skv ||
                        (p.causal && k0 + kBK - 1 > wq_first) ||
                        (p.window > 0 && wq_last - k0 >= p.window);
    const int lo_rel[2] = {klo[0] - k0 - 2 * t, klo[1] - k0 - 2 * t};
    const int hi_rel[2] = {khi[0] - k0 - 2 * t, khi[1] - k0 - 2 * t};
    wgmma_wait<1>();  // S
    reg_fence(s);
#pragma unroll
    for (int j = 0; j < kN / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + (e & 1), r = e >> 1;
        const float x =
            exp2_approx(fmaf(s[4 * j + e], scale_log2, -lse2[r]));
        s[4 * j + e] =
            !masked || (col >= lo_rel[r] && col < hi_rel[r]) ? x : 0.f;
      }
    wgmma_wait<0>();  // dP: V is free
    reg_fence(dp);
    release(true, it);
#pragma unroll
    for (int i = 0; i < kN; ++i)
      dp[i] = s[i] * (dp[i] - delta[(i >> 1) & 1]);
    uint32_t dsa[kBK / 16][4];
    pack_p(dp, dsa);
#pragma unroll
    for (int c = 0; c < C::kSub; ++c) reg_fence(dq[c]);
    wgmma_fence();
    issue_ab<C::kSub, kBK>(dq, dsa, kt);
    wgmma_commit();
    wgmma_wait<0>();  // K is free
#pragma unroll
    for (int c = 0; c < C::kSub; ++c) reg_fence(dq[c]);
    release(false, it);
  }
  store_tile(static_cast<__nv_bfloat16*>(p.dq) + b * p.sdq.b + h * p.sdq.h,
             p.sdq.s, row0, p.Sq, dq, p.scale);
}

// 3b. dQ of one tile of kBQ q rows, bf16, on the tensor cores; heaviest q
// tiles first, the q tiles of one head adjacent, as the forward.
template <int HD>
__global__ void __launch_bounds__(QCfg<HD>::kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  using C = QCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int n_qt = (p.Sq + C::kBQ - 1) / C::kBQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * C::kBQ;
  const int b = bh / p.H, h = bh % p.H;
  int lo, hi;
  flash::kv_range(p.Sq, p.Skv, p.causal, p.window, p.q_offset, q0, C::kBQ,
                  C::kBK, lo, hi);
  const int n_tiles = max(hi - lo, 0);

  if (threadIdx.x == 0) {
    // an empty slot: one arrival per consumer warp for the producer, or a
    // release counter
    auto empty = [&](uint32_t off) {
      if constexpr (C::kProducer)
        mbar_init(base + off, 4 * kTcConsumers);
      else
        *reinterpret_cast<uint32_t*>(smem_raw + (base - smem_addr(smem_raw)) +
                                     off) = 0;
    };
    mbar_init(base + C::kQFull, 1);
    for (int st = 0; st < C::kKStages; ++st) {
      mbar_init(base + C::kKFull + 8 * st, 1);
      empty(C::kKEmpty + 8 * st);
    }
    for (int st = 0; st < C::kVStages; ++st) {
      mbar_init(base + C::kVFull + 8 * st, 1);
      empty(C::kVEmpty + 8 * st);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // roles from a warp-uniform warp index, as the forward
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  auto consumers = [&] {
    if (warp < 4)
      consume_q<HD, 0>(p, &tk, &tv, base, q0, h, b, lo, n_tiles);
    else
      consume_q<HD, 1>(p, &tk, &tv, base, q0, h, b, lo, n_tiles);
  };
  if constexpr (C::kProducer) {
    // setmaxnreg moves registers from the producer warpgroup to the
    // consumers: (168 - 24) x 128 = (240 - 168) x 256
    if (warp >= 4 * kTcConsumers) {
      setmaxnreg_dec<24>();
      if (warp == 4 * kTcConsumers && threadIdx.x % 32 == 0)
        produce_q<HD>(tq, tdo, tk, tv, base, q0, h, b, lo, n_tiles);
    } else {
      setmaxnreg_inc<240>();
      consumers();
    }
  } else {
    if (threadIdx.x == 0)  // Q, dO and the first stages; the consumers refill
      produce_q<HD>(tq, tdo, tk, tv, base, q0, h, b, lo, n_tiles);
    consumers();
  }
}

// 1. delta, in every path: one warp per row.
template <int HD, typename T>
int launch_delta(const Params& p, int B, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * p.H * p.Sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  flash_bwd_delta<HD, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(p, rows);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_simt(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int n_k = (p.Skv + C::kRows - 1) / C::kRows;
  const int n_q = (p.Sq + C::kRows - 1) / C::kRows;
  if (static_cast<long long>(B) * p.H > INT_MAX || n_k > 65535 ||
      n_q > 65535)
    return (int)cudaErrorInvalidConfiguration;
  int err = launch_delta<HD, T>(p, B, stream);
  if (err != 0) return err;
  flash_bwd_dkdv<HD, T><<<dim3(B * p.H, n_k), kThreads, 0, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  flash_bwd_dq<HD, T><<<dim3(B * p.H, n_q), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  using KC = KvCfg<HD>;
  using QC = QCfg<HD>;
  CUtensorMap kv_k, kv_v, kv_q, kv_do, q_q, q_do, q_k, q_v;
  if (!make_map(&kv_k, p.k, HD, p.Skv, p.H, B, p.sk, KC::kBN) ||
      !make_map(&kv_v, p.v, HD, p.Skv, p.H, B, p.sv, KC::kBN) ||
      !make_map(&kv_q, p.q, HD, p.Sq, p.H, B, p.sq, KC::kBM) ||
      !make_map(&kv_do, p.dout, HD, p.Sq, p.H, B, p.sdo, KC::kBM) ||
      !make_map(&q_q, p.q, HD, p.Sq, p.H, B, p.sq, QC::kBQ) ||
      !make_map(&q_do, p.dout, HD, p.Sq, p.H, B, p.sdo, QC::kBQ) ||
      !make_map(&q_k, p.k, HD, p.Skv, p.H, B, p.sk, QC::kBK) ||
      !make_map(&q_v, p.v, HD, p.Skv, p.H, B, p.sv, QC::kBK))
    return (int)cudaErrorInvalidValue;
  const long long bh = static_cast<long long>(B) * p.H;
  const long long kv_blocks = bh * ((p.Skv + KC::kBN - 1) / KC::kBN);
  const long long q_blocks = bh * ((p.Sq + QC::kBQ - 1) / QC::kBQ);
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  int err = launch_delta<HD, __nv_bfloat16>(p, B, stream);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&flash_bwd_dkdv_bf16<HD>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, KC::kSmem);
  if (err != 0) return err;
  flash_bwd_dkdv_bf16<HD><<<static_cast<unsigned>(kv_blocks), kKvThreads,
                            KC::kSmem, stream>>>(kv_k, kv_v, kv_q, kv_do, p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&flash_bwd_dq_bf16<HD>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, QC::kSmem);
  if (err != 0) return err;
  flash_bwd_dq_bf16<HD><<<static_cast<unsigned>(q_blocks), QC::kThreads,
                          QC::kSmem, stream>>>(q_q, q_do, q_k, q_v, p);
  return (int)cudaGetLastError();
}

// fp32 at every head dim and bf16 at 16 and 32 on the SIMT kernels, bf16
// at 64, 128 and 256 on the tensor cores (the forward's split).
template <int HD>
int launch(const Params& p, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return launch_simt<HD, float>(p, B, stream);
  if constexpr (HD >= 64)
    return launch_bf16<HD>(p, B, stream);
  else
    return launch_simt<HD, __nv_bfloat16>(p, B, stream);
}

// ---------------------------------------------------------------------------
// The MLA layout: q (B, Sq, H, 576) over one k head (B, Skv, 1, 576) and one
// v head (B, Skv, 1, 512) shared by q's heads; SIMT for fp32 (the kernels
// are instantiated for fp32 alone: bf16 runs the wgmma kernels below)
// ---------------------------------------------------------------------------

namespace mla {
constexpr int kDK = 576;                // q / k head dim
constexpr int kDV = 512;                // v / o head dim
constexpr int kTPR = 16;                // threads a row (a key in dK / dV)
constexpr int kRows = kThreads / kTPR;  // rows a block, keys a tile: 16
constexpr int kCK = kDK / 4 / kTPR;     // four-element chunks a thread: 9
constexpr int kCV = kDV / 4 / kTPR;     // 8
constexpr int kHG = 16;                 // heads a dK / dV block walks
constexpr int kPart = kDK + kDV;        // floats of a key's partial dK, dV

// A stage in shared memory: kRows rows of 576 floats (q or K), kRows of
// 512 (dO or V), then kRows lse and kRows delta (dK / dV only).
struct Stage {
  static constexpr int kB = kRows * kDK;  // floats before the 512 rows
  static constexpr int kF = kRows * (kDK + kDV) * 4;  // bytes
  static constexpr int kBytes = kF + 2 * kRows * 4;
};
}  // namespace mla

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [0, rows) of W elements of T into shared memory, W elements a row,
// by 16-byte cp.async copies from row(r) (zeros where it is null; `any` is
// a valid global address that a zero fill names and does not read).
template <int W, typename T, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, int rows, const T* any,
                                           RowFn row) {
  constexpr int kPer = W * static_cast<int>(sizeof(T)) / 16;
  for (int c = threadIdx.x; c < rows * kPer; c += kThreads) {
    const int r = c / kPer, x = c % kPer;
    const T* src = row(r);
    cp_async16(reinterpret_cast<char*>(dst + r * W) + 16 * x,
               reinterpret_cast<const char*>(src ? src : any) + 16 * x,
               src != nullptr);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ float4 axpy4(float s, float4 x, float4 y) {
  return make_float4(fmaf(s, x.x, y.x), fmaf(s, x.y, y.y), fmaf(s, x.z, y.z),
                     fmaf(s, x.w, y.w));
}

// 2m. Partial dK and dV of kRows keys over the kHG heads of one head group:
// thread (key jj, lane t) holds k, v, dk and dv of its key at the chunks t
// + 16 c (136 fp32 registers) and walks the rows (position, head) of the
// group that see a key of the tile, kRows at a time through two cp.async
// stages.  Writes fp32 partials (B, n_hg, Skv, 1088): dK, then dV.
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_mla_dkdv(const Params p, int n_hg, int B, float* part) {
  using namespace mla;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = blockIdx.x / (n_hg * B);  // the longest causal walks first
  const int hg = (blockIdx.x / B) % n_hg, b = blockIdx.x % B;
  const int k0 = kt * kRows, jj = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int j = k0 + jj, h0 = hg * kHG, nh = min(kHG, p.H - h0);
  const float* Q = static_cast<const float*>(p.q) + b * p.sq.b;
  const float* dO = static_cast<const float*>(p.dout) + b * p.sdo.b;
  const float* L = p.lse + static_cast<long long>(b) * p.H * p.Sq;
  const float* D = p.delta + static_cast<long long>(b) * p.H * p.Sq;

  float4 k[kCK], v[kCV], dk[kCK], dv[kCV];
  {
    const bool key = j < p.Skv;
    const float* K = static_cast<const float*>(p.k) + b * p.sk.b + j * p.sk.s;
    const float* V = static_cast<const float*>(p.v) + b * p.sv.b + j * p.sv.s;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kCK; ++c) {
      k[c] = key ? flash::load4(K + 4 * (t + kTPR * c)) : z;
      dk[c] = z;
    }
#pragma unroll
    for (int c = 0; c < kCV; ++c) {
      v[c] = key ? flash::load4(V + 4 * (t + kTPR * c)) : z;
      dv[c] = z;
    }
  }

  int qlo, qhi;
  flash::q_range(p.Sq, p.causal, p.window, p.q_offset, k0, kRows, qlo, qhi);
  const int n_rows = max(0, qhi - qlo) * nh;  // (position, head) rows
  const int n_chunks = (n_rows + kRows - 1) / kRows;
  auto stage = [&](int s) { return smem + s * Stage::kBytes; };
  auto issue = [&](int n) {
    unsigned char* st = stage(n & 1);
    float* sq = reinterpret_cast<float*>(st);
    float* sl = reinterpret_cast<float*>(st + Stage::kF);
    const int r0 = n * kRows;
    stage_rows<kDK>(sq, kRows, Q, [&](int r) -> const float* {
      const int m = r0 + r;
      return m < n_rows ? Q + (qlo + m / nh) * p.sq.s + (h0 + m % nh) * p.sq.h
                        : nullptr;
    });
    stage_rows<kDV>(sq + Stage::kB, kRows, dO, [&](int r) -> const float* {
      const int m = r0 + r;
      return m < n_rows
                 ? dO + (qlo + m / nh) * p.sdo.s + (h0 + m % nh) * p.sdo.h
                 : nullptr;
    });
    if (threadIdx.x < kRows) {  // rows past the walk: lse = delta = 0
      const int m = r0 + threadIdx.x;
      const long long at = static_cast<long long>(h0 + m % nh) * p.Sq +
                           qlo + m / nh;
      sl[threadIdx.x] = m < n_rows ? L[at] : 0.f;
      sl[kRows + threadIdx.x] = m < n_rows ? D[at] : 0.f;
    }
  };

  if (n_chunks > 0) issue(0);
  cp_commit();
  for (int n = 0; n < n_chunks; ++n) {
    if (n + 1 < n_chunks) issue(n + 1);
    cp_commit();
    cp_wait_prior();  // chunk n has landed
    __syncthreads();
    const unsigned char* st = stage(n & 1);
    const float* sq = reinterpret_cast<const float*>(st) + 4 * t;
    const float* so = sq + Stage::kB;
    const float* sl = reinterpret_cast<const float*>(st + Stage::kF);
    const int r0 = n * kRows;
    for (int r = 0; r < min(kRows, n_rows - r0); ++r) {
      const float* qr = sq + r * kDK;
      const float* orow = so + r * kDV;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kCK; ++c)
        s = dot4(flash::load4(qr + 4 * kTPR * c), k[c], s);
#pragma unroll
      for (int c = 0; c < kCV; ++c)
        dp = dot4(flash::load4(orow + 4 * kTPR * c), v[c], dp);
      s = flash::row_sum<kTPR>(s);
      dp = flash::row_sum<kTPR>(dp);
      const float pr =
          flash::visible(p.Skv, p.causal, p.window,
                         qlo + (r0 + r) / nh + p.q_offset, j)
              ? expf(s * p.scale - sl[r])
              : 0.f;
      const float ds = pr * (dp - sl[kRows + r]) * p.scale;
      // the row's second read comes after ds: holding its first read
      // beside the key's 136 registers would spill
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kCK; ++c)
        dk[c] = axpy4(ds, flash::load4(qr + 4 * kTPR * c), dk[c]);
#pragma unroll
      for (int c = 0; c < kCV; ++c)
        dv[c] = axpy4(pr, flash::load4(orow + 4 * kTPR * c), dv[c]);
    }
    __syncthreads();  // the stage is read before chunk n + 2 refills it
  }
  if (j < p.Skv) {
    float* out = part + ((static_cast<long long>(b) * n_hg + hg) * p.Skv + j) *
                            kPart + 4 * t;
#pragma unroll
    for (int c = 0; c < kCK; ++c)
      *reinterpret_cast<float4*>(out + 4 * kTPR * c) = dk[c];
#pragma unroll
    for (int c = 0; c < kCV; ++c)
      *reinterpret_cast<float4*>(out + kDK + 4 * kTPR * c) = dv[c];
  }
}

// 3m. dK and dV: the head groups' partials (B, n_hg, Skv, width) summed in
// order, one block per key, a thread per four features, stored in T.
// width 1088 holds dK then dV (the SIMT kernel's and the wgmma dK and dV
// passes'); 576 holds their sum, dK + [dV, 0] (the fused wgmma kernel's).
// dv_into_dk stores dK + [dV, 0] into dk alone (summing the two halves of
// a 1088-wide partial, dK's groups first), else dK and dV apart.
constexpr int kSumThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    flash_bwd_mla_sum(const Params p, const float* part, int n_hg, int width,
                      int dv_into_dk) {
  using namespace mla;
  const int j = blockIdx.x % p.Skv, b = blockIdx.x / p.Skv;
  const float* row = part + (static_cast<long long>(b) * n_hg * p.Skv + j) *
                                width;
  const long long group = static_cast<long long>(p.Skv) * width;
  const int n_out = dv_into_dk || width == kDK ? kDK : kPart;
  for (int f = 4 * threadIdx.x; f < n_out; f += 4 * kSumThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < n_hg; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(row + g * group + f);
      acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
    }
    if (dv_into_dk && width == kPart && f < kDV) {
      float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = 0; g < n_hg; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(row + g * group + kDK + f);
        dv = make_float4(dv.x + x.x, dv.y + x.y, dv.z + x.z, dv.w + x.w);
      }
      acc = make_float4(acc.x + dv.x, acc.y + dv.y, acc.z + dv.z,
                        acc.w + dv.w);
    }
    T* out = f < kDK ? static_cast<T*>(p.dk) + b * p.sdk.b + j * p.sdk.s + f
                     : static_cast<T*>(p.dv) + b * p.sdv.b + j * p.sdv.s + f -
                           kDK;
    flash::store4(out, acc);
  }
}

// 4m. dQ of kRows rows (position, head), heaviest first, as the forward lays
// them out: thread (row rr, lane t) holds q, dO and dq of its row at the
// chunks t + 16 c (104 fp32 registers) and walks the key tiles of the
// causal kv_range, kRows keys at a time through two cp.async stages (K,
// and V unless `shared_kv`: v is k's first 512 features, read from the K
// tile).
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_mla_dq(const Params p, int n_rt, int B, int shared_kv) {
  using namespace mla;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x % B;
  const int r0 = (n_rt - 1 - blockIdx.x / B) * kRows;
  const int n_rows = p.Sq * p.H;
  const int t = threadIdx.x % kTPR, row = r0 + threadIdx.x / kTPR;
  const bool exists = row < n_rows;
  const int qi = exists ? row / p.H : 0, h = exists ? row % p.H : 0;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float* K = static_cast<const float*>(p.k) + b * p.sk.b;
  const float* V = static_cast<const float*>(p.v) + b * p.sv.b;

  float4 q[kCK], o[kCV], dq[kCK];
  {
    const float* Q = static_cast<const float*>(p.q) + b * p.sq.b + qi * p.sq.s +
                 h * p.sq.h;
    const float* dO = static_cast<const float*>(p.dout) + b * p.sdo.b +
                  qi * p.sdo.s + h * p.sdo.h;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kCK; ++c) {
      q[c] = exists ? flash::load4(Q + 4 * (t + kTPR * c)) : z;
      dq[c] = z;
    }
#pragma unroll
    for (int c = 0; c < kCV; ++c)
      o[c] = exists ? flash::load4(dO + 4 * (t + kTPR * c)) : z;
  }
  const float lse = exists ? p.lse[bh * p.Sq + qi] : 0.f;
  const float delta = exists ? p.delta[bh * p.Sq + qi] : 0.f;
  const int qpos = qi + p.q_offset;

  int lo, hi;
  const int i_first = r0 / p.H, i_last = (min(r0 + kRows, n_rows) - 1) / p.H;
  flash::kv_range(p.Sq, p.Skv, p.causal, p.window, p.q_offset, i_first,
                  i_last - i_first + 1, kRows, lo, hi);
  auto stage = [&](int s) {
    return reinterpret_cast<float*>(smem + s * Stage::kBytes);
  };
  auto issue = [&](int kt) {
    float* sk = stage((kt - lo) & 1);
    const int k0 = kt * kRows;
    stage_rows<kDK>(sk, kRows, K, [&](int r) -> const float* {
      return k0 + r < p.Skv ? K + (k0 + r) * p.sk.s : nullptr;
    });
    if (!shared_kv)
      stage_rows<kDV>(sk + Stage::kB, kRows, V, [&](int r) -> const float* {
        return k0 + r < p.Skv ? V + (k0 + r) * p.sv.s : nullptr;
      });
  };

  if (lo < hi) issue(lo);
  cp_commit();
  for (int kt = lo; kt < hi; ++kt) {
    if (kt + 1 < hi) issue(kt + 1);
    cp_commit();
    cp_wait_prior();  // tile kt has landed
    __syncthreads();
    const float* sk = stage((kt - lo) & 1) + 4 * t;
    const float* sv = shared_kv ? sk : sk + Stage::kB;
    const int vstride = shared_kv ? kDK : kDV;
    for (int jj = 0; jj < kRows; ++jj) {
      float4 kc[kCK];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        kc[c] = flash::load4(sk + jj * kDK + 4 * kTPR * c);
        s = dot4(q[c], kc[c], s);
      }
#pragma unroll
      for (int c = 0; c < kCV; ++c)
        dp = dot4(o[c], flash::load4(sv + jj * vstride + 4 * kTPR * c), dp);
      s = flash::row_sum<kTPR>(s);
      dp = flash::row_sum<kTPR>(dp);
      const float pr = exists && flash::visible(p.Skv, p.causal, p.window,
                                                qpos, kt * kRows + jj)
                           ? expf(s * p.scale - lse)
                           : 0.f;
      const float ds = pr * (dp - delta) * p.scale;
#pragma unroll
      for (int c = 0; c < kCK; ++c) dq[c] = axpy4(ds, kc[c], dq[c]);
    }
    __syncthreads();  // the stage is read before tile kt + 2 refills it
  }
  if (exists) {
    float* out = static_cast<float*>(p.dq) + b * p.sdq.b + qi * p.sdq.s + h * p.sdq.h;
#pragma unroll
    for (int c = 0; c < kCK; ++c) flash::store4(out + 4 * (t + kTPR * c), dq[c]);
  }
}

// The fp32 path: delta (the dense path's kernel at 512 features), dK / dV
// partials, their sum, dQ.
int launch_mla_simt(const Params& p, float* part, int shared_kv,
                    int dv_into_dk, int B, cudaStream_t stream) {
  using namespace mla;
  const long long n_rows = static_cast<long long>(p.Sq) * p.H;
  const long long n_rt = (n_rows + kRows - 1) / kRows;
  const long long n_kt = (p.Skv + kRows - 1) / kRows;
  const int n_hg = (p.H + kHG - 1) / kHG;
  const long long sums = static_cast<long long>(B) * p.Skv;
  if (n_rows > INT_MAX || n_rt * B > INT_MAX || n_kt * n_hg * B > INT_MAX ||
      sums > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  int err = launch_delta<kDV, float>(p, B, stream);
  if (err != 0) return err;
  constexpr int smem = 2 * Stage::kBytes;
  err = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&flash_bwd_mla_dkdv),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  flash_bwd_mla_dkdv<<<static_cast<unsigned>(n_kt * n_hg * B),
                              kThreads, smem, stream>>>(p, n_hg, B, part);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  flash_bwd_mla_sum<float><<<static_cast<unsigned>(sums), kSumThreads, 0,
                             stream>>>(p, part, n_hg, kPart, dv_into_dk);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&flash_bwd_mla_dq),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  flash_bwd_mla_dq<<<static_cast<unsigned>(n_rt * B), kThreads, smem,
                            stream>>>(p, static_cast<int>(n_rt), B, shared_kv);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at the MLA layout: TMA + wgmma (see the header)
// ---------------------------------------------------------------------------

namespace mla_tc {
constexpr int kThreads = 256;                  // two warpgroups, no producer
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;   // resident rows: the keys (dK), the rows (dQ)
constexpr int kBN = 32;   // streamed rows a step: rows (dK), keys (dQ)
constexpr int kQKBoxes = mla::kDK / kBox;      // 9 64-column boxes
constexpr int kVBoxes = mla::kDV / kBox;       // 8
constexpr int kOwn = 4;   // warpgroup 0 owns column boxes [0, 4), 1 [4, 9)
constexpr uint32_t kResBox = kBM * 128;        // a box of 64 rows: 8 KB
constexpr uint32_t kStepBox = kBN * 128;       // of 32 rows: 4 KB
constexpr uint32_t kResQK = kQKBoxes * kResBox;    // 72 KB
constexpr uint32_t kResV = kVBoxes * kResBox;      // 64 KB
constexpr uint32_t kStepQK = kQKBoxes * kStepBox;  // 36 KB
constexpr uint32_t kStepV = kVBoxes * kStepBox;    // 32 KB
constexpr uint32_t kXBytes = 16 * 128 * 4;  // P (fp32), 16 a thread
constexpr uint32_t kYBytes = 8 * 128 * 4;   // dS's bf16 fragments, 8 a thread
// the dK kernel's passes: dK + [dV, 0] in one accumulator, dK, dV
enum Mode { kFused, kDK, kDV };
}  // namespace mla_tc

// dK: the layout in bytes from a 1024-byte-aligned base: the K tile, the V
// tile (a separate v), the Q and dO stages, the P and dS exchange, the
// stages' lse2 and delta, the mbarriers (K / V; Q + dO and the rows' lse2
// and delta a stage) and a release counter a stage.
template <bool kShared>
struct MlaKvCfg {
  static constexpr int kStages = kShared ? 2 : 1;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = mla_tc::kResQK;
  static constexpr uint32_t kQ = kV + (kShared ? 0 : mla_tc::kResV);
  static constexpr uint32_t kDO = kQ + kStages * mla_tc::kStepQK;
  static constexpr uint32_t kX = kDO + kStages * mla_tc::kStepV;
  static constexpr uint32_t kY = kX + mla_tc::kXBytes;
  static constexpr uint32_t kL = kY + mla_tc::kYBytes;  // + st * kBN * 4
  static constexpr uint32_t kD = kL + kStages * mla_tc::kBN * 4;
  static constexpr uint32_t kKVFull = kD + kStages * mla_tc::kBN * 4;
  static constexpr uint32_t kQFull = kKVFull + 8;       // + 8 st, as the rest
  static constexpr uint32_t kLFull = kQFull + 8 * kStages;
  static constexpr uint32_t kCount = kLFull + 8 * kStages;
  static constexpr int kSmem = 1024 + kCount + 8 * kStages;  // + alignment
};

// dQ: Q, dO, the K stages, the V stage (a separate v), the exchange, the
// mbarriers (Q + dO; a K stage, with its V) and a release counter a stage.
template <bool kShared>
struct MlaQCfg {
  static constexpr int kStages = kShared ? 2 : 1;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = mla_tc::kResQK;
  static constexpr uint32_t kK = kDO + mla_tc::kResV;  // + st * kStepQK
  static constexpr uint32_t kV = kK + kStages * mla_tc::kStepQK;
  static constexpr uint32_t kX = kV + (kShared ? 0 : mla_tc::kStepV);
  static constexpr uint32_t kY = kX + mla_tc::kXBytes;
  static constexpr uint32_t kQFull = kY + mla_tc::kYBytes;
  static constexpr uint32_t kKFull = kQFull + 8;        // + 8 st
  static constexpr uint32_t kCount = kKFull + 8 * kStages;
  static constexpr int kSmem = 1024 + kCount + 8 * kStages;
};

// C (64 x 32) = A B^T over KS k steps of 16 (36: 576 features; 32: 512), A
// 64 rows and B 32 rows K-major from 128-byte-swizzled tiles (boxes of
// kResBox and kStepBox bytes).  Issued and committed, not waited for.  As
// the forward's issue_qk_mla: each step's descriptors are the first ones
// plus its offset, and the addresses pass through an opaque move (left to
// itself, ptxas keeps a loop-invariant address's 36 descriptors live).
template <int KS>
__device__ __forceinline__ void issue_ss_mla(float (&c)[16], uint32_t a,
                                             uint32_t b) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(a));
  asm volatile("mov.b32 %0, %0;\n" : "+r"(b));
  const uint64_t da = sw128_desc(a, 16, 1024), db = sw128_desc(b, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss(c,
             da + (((kk / 4) * mla_tc::kResBox + (kk % 4) * 32) >> 4),
             db + (((kk / 4) * mla_tc::kStepBox + (kk % 4) * 32) >> 4),
             kk > 0);
  wgmma_commit();
}

// acc (64 x NF / 2) += A B: A the bf16 fragments of a 64 x 32 tile (two k
// steps), B the column boxes from `b` of a 32-row tile read MN-major:
// m64n256k16 (NF 128: four boxes) or m64n64k16 (NF 32: one).  Issued, not
// committed.
template <int NF>
__device__ __forceinline__ void issue_rs_mla(float (&acc)[NF],
                                             const uint32_t (&a)[2][4],
                                             uint32_t b) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(b));
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs(acc, a[kk], sw128_desc(b + kk * 2048, mla_tc::kStepBox, 1024));
}

// The lse2 and delta of the dK step row that one lane stages: row `lane`
// of the step from position pos0 is (position pos0 + lane / hg, head h0 +
// lane % hg), hg = 2^hg_log2.  A row outside [qlo, qhi) or past H gets
// lse2 = +inf and delta 0, so its P is 0 with no mask.
__device__ __forceinline__ void fetch_mla_row(const Params& p, int b, int h0,
                                              int hg_log2, int qlo, int qhi,
                                              int pos0, float& l, float& d) {
  const int lane = threadIdx.x % 32;
  const int pos = pos0 + (lane >> hg_log2);
  const int h = h0 + (lane & ((1 << hg_log2) - 1));
  const bool exists = pos >= qlo && pos < qhi && h < p.H;
  const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + pos;
  l = exists ? p.lse[at] * kLog2e : INFINITY;
  d = exists ? p.delta[at] : 0.f;
}

// dK step `it` (positions from pos0) into stage it % kStages, by one whole
// warp: lane 0 issues the TMA loads of its Q and dO boxes (64 features x hg
// heads x 32 / hg positions), every lane writes its row's lse2 and delta
// (fetch_mla_row) and arrives on the stage's row barrier.
template <bool kShared>
__device__ __forceinline__ void load_step_mla(const CUtensorMap* tq,
                                              const CUtensorMap* tdo,
                                              uint8_t* smem, uint32_t base,
                                              int it, int pos0, int h0, int b,
                                              float l, float d) {
  using C = MlaKvCfg<kShared>;
  using namespace mla_tc;
  const int st = it % C::kStages, lane = threadIdx.x % 32;
  if (lane == 0) {
    const uint32_t full = base + C::kQFull + 8 * st;
    mbar_expect_tx(full, kStepQK + kStepV);
    for (int c = 0; c < kQKBoxes; ++c)
      tma_load(base + C::kQ + st * kStepQK + c * kStepBox, tq, full, c * kBox,
               h0, pos0, b);
    for (int c = 0; c < kVBoxes; ++c)
      tma_load(base + C::kDO + st * kStepV + c * kStepBox, tdo, full,
               c * kBox, h0, pos0, b);
  }
  reinterpret_cast<float*>(smem + C::kL)[st * kBN + lane] = l;
  reinterpret_cast<float*>(smem + C::kD)[st * kBN + lane] = d;
  mbar_arrive(base + C::kLFull + 8 * st);
}

// One thread's two rows (row0, row0 + 8) of an fp32 accumulator tile (64 x
// NF / 2) into rows of `out` (row stride `width` floats) from column col0,
// the rows below `limit`.
template <int NF>
__device__ __forceinline__ void store_part(float* out, int width, int row0,
                                           int limit, int col0,
                                           const float (&acc)[NF]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= limit) continue;
    float* o = out + static_cast<long long>(row0 + 8 * r) * width + col0 +
               2 * t;
#pragma unroll
    for (int j = 0; j < NF / 4; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// Warpgroup WG of a dK block (keys [k0, k0 + 64) of batch b, the heads
// [h0, h0 + hg) of one group): both warpgroups hold all 64 keys, a thread
// keys key0 and key0 + 8 of every accumulator tile, whose 32 columns are a
// step's rows.  Per step (positions walked from the top down): warpgroup
// 0 issues S^T = K Q^T, warpgroup 1 dP^T = V dO^T (not in the dV pass);
// warpgroup 0 turns S^T into P^T (lse2 of each column from the stage, 0
// outside each key's visible rows) and hands it over in fp32, warpgroup 1
// forms dS^T = P^T (dP^T - delta) scale and hands back its bf16
// fragments (named barriers 1 and 2); then each adds its column boxes'
// share of dS^T Q and (kFused, kDV) P^T dO, Q and dO read MN-major from
// the stage.  The last warp to release the stage refills it.  The block's
// fp32 sums go to `out` (its group's partials, `width` floats a key; the
// dV pass from column 576).
template <bool kShared, int kMode, int WG>
__device__ __forceinline__ void consume_mla_kv(
    const Params& p, const CUtensorMap* tq, const CUtensorMap* tdo,
    uint8_t* smem, uint32_t base, int k0, int b, int h0, int hg_log2,
    int qlo, int qhi, int top, int n_steps, float* out, int width) {
  using C = MlaKvCfg<kShared>;
  using namespace mla_tc;
  constexpr bool kDS = kMode != kDV;   // dS^T Q
  constexpr bool kPdO = kMode != kDK;  // P^T dO
  constexpr bool kBox8 = WG == 1 && kDS;  // column box 8 (dS^T Q only)
  const int tid = threadIdx.x % 128, lane = threadIdx.x % 32, t = lane % 4;
  const int npos = kBN >> hg_log2;
  const int key0 = k0 + 16 * (tid / 32) + lane / 4;
  const float scale_log2 = p.scale * kLog2e;
  float* xch = reinterpret_cast<float*>(smem + C::kX) + tid;
  uint32_t* ych = reinterpret_cast<uint32_t*>(smem + C::kY) + tid;
  const uint32_t k_tile = base + C::kK;
  const uint32_t v_tile = base + (kShared ? C::kK : C::kV);
  const uint32_t own = WG * kOwn * kStepBox;  // the first owned box

  float acc[128], acc8[32];
  zero(acc);
  if constexpr (kBox8) zero(acc8);
  if (n_steps > 0) mbar_wait(base + C::kKVFull, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % C::kStages;
    const uint32_t ph = (it / C::kStages) & 1;
    const int pos0 = top - (it + 1) * npos;
    const uint32_t q_st = base + C::kQ + st * kStepQK;
    const uint32_t do_st = base + C::kDO + st * kStepV;
    const bool refill = it + C::kStages < n_steps;
    float nl = 0.f, nd = 0.f;  // step it + kStages's rows
    if (refill)
      fetch_mla_row(p, b, h0, hg_log2, qlo, qhi, pos0 - C::kStages * npos,
                    nl, nd);
    mbar_wait(base + C::kQFull + 8 * st, ph);
    mbar_wait(base + C::kLFull + 8 * st, ph);
    uint32_t pa[2][4], dsa[2][4];
    if constexpr (WG == 0) {
      float x[16];
      issue_ss_mla<4 * kQKBoxes>(x, k_tile, q_st);  // S^T = K Q^T
      // a pair of the step is masked: the causal diagonal, the window's
      // edge (rows outside [qlo, qhi) have lse2 = +inf)
      const bool masked =
          (p.causal && pos0 + p.q_offset < k0 + kBM - 1) ||
          (p.window > 0 && pos0 + npos - 1 + p.q_offset - k0 >= p.window);
      const float* sl =
          reinterpret_cast<const float*>(smem + C::kL) + st * kBN + 2 * t;
      wgmma_wait<0>();
      reg_fence(x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1, key = key0 + 8 * (e >> 1);
          float y = exp2_approx(
              fmaf(x[4 * j + e], scale_log2, -(c ? l2.y : l2.x)));
          if (masked) {
            const int qpos =
                pos0 + ((8 * j + 2 * t + c) >> hg_log2) + p.q_offset;
            if ((p.causal && qpos < key) ||
                (p.window > 0 && qpos - key >= p.window))
              y = 0.f;
          }
          x[4 * j + e] = y;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) xch[128 * i] = x[i];
      bar_arrive(1);
      if constexpr (kPdO) pack_p(x, pa);
      bar_sync(2);  // dS^T is in, and P^T read
      if constexpr (kDS)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) dsa[kk][r] = ych[128 * (4 * kk + r)];
    } else {
      float y[16], pt[16];
      if constexpr (kDS) {
        issue_ss_mla<4 * kVBoxes>(y, v_tile, do_st);  // dP^T = V dO^T
        wgmma_wait<0>();
        reg_fence(y);
      }
      bar_sync(1);  // P^T is in
#pragma unroll
      for (int i = 0; i < 16; ++i) pt[i] = xch[128 * i];
      if constexpr (kDS) {
        const float* sd =
            reinterpret_cast<const float*>(smem + C::kD) + st * kBN + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(sd + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[4 * j + e] = pt[4 * j + e] *
                           (y[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * p.scale;
        }
        pack_p(y, dsa);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) ych[128 * (4 * kk + r)] = dsa[kk][r];
      }
      if constexpr (kPdO) pack_p(pt, pa);
      bar_arrive(2);
    }
    reg_fence(acc);
    if constexpr (kBox8) reg_fence(acc8);
    wgmma_fence();
    if constexpr (kDS) issue_rs_mla(acc, dsa, q_st + own);
    if constexpr (kBox8) issue_rs_mla(acc8, dsa, q_st + 8 * kStepBox);
    if constexpr (kPdO) issue_rs_mla(acc, pa, do_st + own);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    if constexpr (kBox8) reg_fence(acc8);
    __syncwarp();
    if (release_last<kWarps>(base + C::kCount + 8 * st) && refill)
      load_step_mla<kShared>(tq, tdo, smem, base, it + C::kStages,
                             pos0 - C::kStages * npos, h0, b, nl, nd);
    __syncwarp();
  }
  float* o = out + (kMode == kDV ? mla::kDK : 0);
  store_part(o, width, key0, p.Skv, 64 * kOwn * WG, acc);
  if constexpr (kBox8) store_part(o, width, key0, p.Skv, 64 * 8, acc8);
}

// 2t. The partial dK (kDK), dV (kDV) or dK + [dV, 0] (kFused) of 64 keys
// over one head group, bf16, on the tensor cores.  Blocks in (batch, key
// tile, group) order, lowest keys first (the longest causal walks), so the
// resident blocks share a sequence's rows (with the batch fastest the dK
// kernel is slower at batch 4: tools/mla_bwd_ablation.py's batch_inner,
// PERF.md).  Warp
// 0 loads the K (and V) tile and the first kStages steps; the step walk is
// aligned to multiples of 32 / hg positions (the same steps in every key
// tile), from the top down.
template <bool kShared, int kMode>
__global__ void __launch_bounds__(mla_tc::kThreads, 1)
    flash_bwd_mla_dk_bf16(const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const Params p, int n_hg, int hg_log2, int B,
                          float* part, int width) {
  using C = MlaKvCfg<kShared>;
  using namespace mla_tc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));

  const int n_kt = gridDim.x / (n_hg * B);
  const int b = blockIdx.x / (n_kt * n_hg);
  const int kt = blockIdx.x / n_hg % n_kt, hg = blockIdx.x % n_hg;
  const int k0 = kt * kBM, h0 = hg << hg_log2, npos = kBN >> hg_log2;
  int qlo, qhi;
  flash::q_range(p.Sq, p.causal, p.window, p.q_offset, k0, kBM, qlo, qhi);
  const int top = (qhi + npos - 1) / npos * npos;
  const int n_steps = qhi > qlo ? (top - qlo / npos * npos) / npos : 0;

  if (threadIdx.x == 0) {
    mbar_init(base + C::kKVFull, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(base + C::kQFull + 8 * st, 1);
      mbar_init(base + C::kLFull + 8 * st, 32);  // a warp's lanes
      *reinterpret_cast<uint32_t*>(smem + C::kCount + 8 * st) = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp == 0 && n_steps > 0) {
    if (threadIdx.x == 0) {
      constexpr bool kLoadV = !kShared && kMode != kDV;
      mbar_expect_tx(base + C::kKVFull, kResQK + (kLoadV ? kResV : 0));
      for (int c = 0; c < kQKBoxes; ++c)
        tma_load(base + C::kK + c * kResBox, &tk, base + C::kKVFull,
                 c * kBox, k0, 0, b);
      if constexpr (kLoadV)
        for (int c = 0; c < kVBoxes; ++c)
          tma_load(base + C::kV + c * kResBox, &tv, base + C::kKVFull,
                   c * kBox, k0, 0, b);
    }
    for (int it = 0; it < min(C::kStages, n_steps); ++it) {
      const int pos0 = top - (it + 1) * npos;
      float l, d;
      fetch_mla_row(p, b, h0, hg_log2, qlo, qhi, pos0, l, d);
      load_step_mla<kShared>(&tq, &tdo, smem, base, it, pos0, h0, b, l, d);
    }
    __syncwarp();
  }
  float* out = part + (static_cast<long long>(b) * n_hg + hg) * p.Skv * width;
  if (warp < 4)
    consume_mla_kv<kShared, kMode, 0>(p, &tq, &tdo, smem, base, k0, b, h0,
                                      hg_log2, qlo, qhi, top, n_steps, out,
                                      width);
  else
    consume_mla_kv<kShared, kMode, 1>(p, &tq, &tdo, smem, base, k0, b, h0,
                                      hg_log2, qlo, qhi, top, n_steps, out,
                                      width);
}

// dQ: K tile `it`'s stage (and V with a separate v) from key k0, announced
// on the stage's full mbarrier; by one thread.
template <bool kShared>
__device__ __forceinline__ void load_k_mla(const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           uint32_t base, int st, int k0,
                                           int b) {
  using C = MlaQCfg<kShared>;
  using namespace mla_tc;
  const uint32_t full = base + C::kKFull + 8 * st;
  mbar_expect_tx(full, kStepQK + (kShared ? 0 : kStepV));
  for (int c = 0; c < kQKBoxes; ++c)
    tma_load(base + C::kK + st * kStepQK + c * kStepBox, tk, full, c * kBox,
             k0, 0, b);
  if constexpr (!kShared)
    for (int c = 0; c < kVBoxes; ++c)
      tma_load(base + C::kV + c * kStepBox, tv, full, c * kBox, k0, 0, b);
}

// Warpgroup WG of a dQ block (rows (position, head) [r0, r0 + 64) of batch
// b): both hold all 64 rows, a thread rows row_l and row_l + 8, with their
// lse2 and delta in registers; the accumulator tiles' 32 columns are a K
// tile's keys.  Per tile: warpgroup 0 issues S = Q K^T, warpgroup 1 dP =
// dO V^T (V the K stage's first 8 boxes when kShared); P crosses to
// warpgroup 1 in fp32 and dS = P (dP - delta) comes back as bf16
// fragments, as in the dK kernel; then each adds its column boxes' share of
// dS K (K read MN-major).  dQ is stored once, times scale.
template <bool kShared, int WG>
__device__ __forceinline__ void consume_mla_q(const Params& p,
                                              const CUtensorMap* tk,
                                              const CUtensorMap* tv,
                                              uint8_t* smem, uint32_t base,
                                              int b, int r0, int lo,
                                              int n_tiles, int q_first,
                                              int q_last) {
  using C = MlaQCfg<kShared>;
  using namespace mla_tc;
  constexpr bool kBox8 = WG == 1;
  const int tid = threadIdx.x % 128, lane = threadIdx.x % 32, t = lane % 4;
  const int row_l = 16 * (tid / 32) + lane / 4;
  const int n_rows = p.Sq * p.H;
  const float scale_log2 = p.scale * kLog2e;
  float* xch = reinterpret_cast<float*>(smem + C::kX) + tid;
  uint32_t* ych = reinterpret_cast<uint32_t*>(smem + C::kY) + tid;
  // rows row_l + 8 r: lse2 (+inf past Sq H: P is 0), delta, visible keys
  float lse2[2], delta[2];
  int klo[2], khi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row_l + 8 * r;
    const bool exists = row < n_rows;
    const int qi = min(row, n_rows - 1) / p.H, h = min(row, n_rows - 1) % p.H;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + qi;
    lse2[r] = exists ? p.lse[at] * kLog2e : INFINITY;
    delta[r] = exists ? p.delta[at] : 0.f;
    const int qpos = qi + p.q_offset;
    khi[r] = p.causal ? min(qpos + 1, p.Skv) : p.Skv;
    klo[r] = p.window > 0 ? qpos - p.window + 1 : 0;
  }

  float acc[128], acc8[32];
  zero(acc);
  if constexpr (kBox8) zero(acc8);
  if (n_tiles > 0) mbar_wait(base + C::kQFull, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % C::kStages;
    const int k0 = (lo + it) * kBN;
    const uint32_t k_st = base + C::kK + st * kStepQK;
    const uint32_t v_st = kShared ? k_st : base + C::kV;
    mbar_wait(base + C::kKFull + 8 * st, (it / C::kStages) & 1);
    uint32_t dsa[2][4];
    if constexpr (WG == 0) {
      float x[16];
      issue_ss_mla<4 * kQKBoxes>(x, base + C::kQ, k_st);  // S = Q K^T
      const bool masked = k0 + kBN > p.Skv ||
                          (p.causal && k0 + kBN - 1 > q_first) ||
                          (p.window > 0 && q_last - k0 >= p.window);
      wgmma_wait<0>();
      reg_fence(x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
          const float y =
              exp2_approx(fmaf(x[4 * j + e], scale_log2, -lse2[r]));
          x[4 * j + e] =
              !masked || (col >= klo[r] && col < khi[r]) ? y : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 16; ++i) xch[128 * i] = x[i];
      bar_arrive(1);
      bar_sync(2);  // dS is in, and P read
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsa[kk][r] = ych[128 * (4 * kk + r)];
    } else {
      float y[16];
      issue_ss_mla<4 * kVBoxes>(y, base + C::kDO, v_st);  // dP = dO V^T
      wgmma_wait<0>();
      reg_fence(y);
      bar_sync(1);  // P is in
#pragma unroll
      for (int i = 0; i < 16; ++i)
        y[i] = xch[128 * i] * (y[i] - delta[(i >> 1) & 1]);
      pack_p(y, dsa);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) ych[128 * (4 * kk + r)] = dsa[kk][r];
      bar_arrive(2);
    }
    reg_fence(acc);
    if constexpr (kBox8) reg_fence(acc8);
    wgmma_fence();
    issue_rs_mla(acc, dsa, k_st + WG * kOwn * kStepBox);
    if constexpr (kBox8) issue_rs_mla(acc8, dsa, k_st + 8 * kStepBox);
    wgmma_commit();
    wgmma_wait<0>();  // the K (and V) stage is free
    reg_fence(acc);
    if constexpr (kBox8) reg_fence(acc8);
    __syncwarp();
    if (release_last<kWarps>(base + C::kCount + 8 * st) &&
        it + C::kStages < n_tiles && lane == 0)
      load_k_mla<kShared>(tk, tv, base, st, (lo + it + C::kStages) * kBN, b);
    __syncwarp();
  }
  auto* dq = static_cast<__nv_bfloat16*>(p.dq) + b * p.sdq.b;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row_l + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* o = dq + (row / p.H) * p.sdq.s + (row % p.H) * p.sdq.h +
                       64 * kOwn * WG + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) = pack_bf16(
          acc[4 * j + 2 * r] * p.scale, acc[4 * j + 2 * r + 1] * p.scale);
    if constexpr (kBox8)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 256 + 8 * j) =
            pack_bf16(acc8[4 * j + 2 * r] * p.scale,
                      acc8[4 * j + 2 * r + 1] * p.scale);
  }
}

// 4t. dQ of 64 rows (position, head), bf16, on the tensor cores, heaviest
// first, as the forward lays them out.  Thread 0 loads Q, dO and the first
// kStages K tiles; the last warp to release a stage refills it.
template <bool kShared>
__global__ void __launch_bounds__(mla_tc::kThreads, 1)
    flash_bwd_mla_dq_bf16(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p, int n_rt, int B) {
  using C = MlaQCfg<kShared>;
  using namespace mla_tc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));

  const int b = blockIdx.x % B;
  const int r0 = (n_rt - 1 - blockIdx.x / B) * kBM;
  const int n_rows = p.Sq * p.H;
  const int i_first = r0 / p.H, i_last = (min(r0 + kBM, n_rows) - 1) / p.H;
  int lo, hi;
  flash::kv_range(p.Sq, p.Skv, p.causal, p.window, p.q_offset, i_first,
                  i_last - i_first + 1, kBN, lo, hi);
  const int n_tiles = max(hi - lo, 0);  // tile it is key tile lo + it

  if (threadIdx.x == 0) {
    mbar_init(base + C::kQFull, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(base + C::kKFull + 8 * st, 1);
      *reinterpret_cast<uint32_t*>(smem + C::kCount + 8 * st) = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(base + C::kQFull, kResQK + kResV);
    for (int c = 0; c < kQKBoxes; ++c)
      tma_load(base + C::kQ + c * kResBox, &tq, base + C::kQFull, c * kBox,
               r0, 0, b);
    for (int c = 0; c < kVBoxes; ++c)
      tma_load(base + C::kDO + c * kResBox, &tdo, base + C::kQFull,
               c * kBox, r0, 0, b);
    for (int it = 0; it < min(n_tiles, C::kStages); ++it)
      load_k_mla<kShared>(&tk, &tv, base, it, (lo + it) * kBN, b);
  }
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int q_first = i_first + p.q_offset, q_last = i_last + p.q_offset;
  if (warp < 4)
    consume_mla_q<kShared, 0>(p, &tk, &tv, smem, base, b, r0, lo, n_tiles,
                              q_first, q_last);
  else
    consume_mla_q<kShared, 1>(p, &tk, &tv, smem, base, b, r0, lo, n_tiles,
                              q_first, q_last);
}

template <bool kShared, int kMode>
int launch_mla_dk(const CUtensorMap& tk, const CUtensorMap& tv,
                  const CUtensorMap& tq, const CUtensorMap& tdo,
                  const Params& p, int n_hg, int hg_log2, int B, float* part,
                  int width, unsigned blocks, cudaStream_t stream) {
  constexpr int smem = MlaKvCfg<kShared>::kSmem;
  const int err = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&flash_bwd_mla_dk_bf16<kShared, kMode>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  flash_bwd_mla_dk_bf16<kShared, kMode>
      <<<blocks, mla_tc::kThreads, smem, stream>>>(tk, tv, tq, tdo, p, n_hg,
                                                   hg_log2, B, part, width);
  return (int)cudaGetLastError();
}

template <bool kShared>
int launch_mla_dq(const CUtensorMap& tq, const CUtensorMap& tdo,
                  const CUtensorMap& tk, const CUtensorMap& tv,
                  const Params& p, int n_rt, int B, cudaStream_t stream) {
  constexpr int smem = MlaQCfg<kShared>::kSmem;
  const int err = (int)cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&flash_bwd_mla_dq_bf16<kShared>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  flash_bwd_mla_dq_bf16<kShared>
      <<<static_cast<unsigned>(n_rt * B), mla_tc::kThreads, smem, stream>>>(
          tq, tdo, tk, tv, p, n_rt, B);
  return (int)cudaGetLastError();
}

// The bf16 path: delta, the dK kernel (kFused where dV goes into dK, else a
// kDK and a kDV pass), the groups' sum, dQ.  A head group is hg = min(16,
// H rounded up to a power of 2) heads.  q's and dO's rows (position, head)
// must lie at one stride (H times the head stride a position), as the
// forward's q: dQ reads them as matrices of Sq H rows.
int launch_mla_bf16(const Params& p, float* part, int shared_kv,
                    int dv_into_dk, int B, cudaStream_t stream) {
  using namespace mla_tc;
  const long long n_rows = static_cast<long long>(p.Sq) * p.H;
  const long long n_rt = (n_rows + kBM - 1) / kBM;
  const long long n_kt = (p.Skv + kBM - 1) / kBM;
  int hg_log2 = 0;
  while ((1 << hg_log2) < min(p.H, mla::kHG)) ++hg_log2;
  const int n_hg = (p.H + (1 << hg_log2) - 1) >> hg_log2;
  const long long sums = static_cast<long long>(B) * p.Skv;
  if (n_rows > INT_MAX || n_rt * B > INT_MAX || n_kt * n_hg * B > INT_MAX ||
      sums > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const bool rows = p.H == 1 || p.Sq == 1 ||
                    (p.sq.s == p.H * p.sq.h && p.sdo.s == p.H * p.sdo.h);
  if (!rows || (dv_into_dk && !shared_kv)) return (int)cudaErrorInvalidValue;
  const flash::Strides q_rows = {p.sq.b, p.H > 1 ? p.sq.h : p.sq.s, 0};
  const flash::Strides do_rows = {p.sdo.b, p.H > 1 ? p.sdo.h : p.sdo.s, 0};
  const int hg = 1 << hg_log2, npos = kBN / hg;
  CUtensorMap kv_k, kv_v, kv_q, kv_do, q_q, q_do, q_k, q_v;
  if (!make_map(&kv_k, p.k, mla::kDK, p.Skv, 1, B, p.sk, kBM) ||
      !make_map(&kv_v, p.v, mla::kDV, p.Skv, 1, B, p.sv, kBM) ||
      !make_map_box(&kv_q, p.q, mla::kDK, {p.H, p.Sq, B},
                    {p.sq.h, p.sq.s, p.sq.b}, hg, npos) ||
      !make_map_box(&kv_do, p.dout, mla::kDV, {p.H, p.Sq, B},
                    {p.sdo.h, p.sdo.s, p.sdo.b}, hg, npos) ||
      !make_map(&q_q, p.q, mla::kDK, static_cast<int>(n_rows), 1, B, q_rows,
                kBM) ||
      !make_map(&q_do, p.dout, mla::kDV, static_cast<int>(n_rows), 1, B,
                do_rows, kBM) ||
      !make_map(&q_k, p.k, mla::kDK, p.Skv, 1, B, p.sk, kBN) ||
      !make_map(&q_v, p.v, mla::kDV, p.Skv, 1, B, p.sv, kBN))
    return (int)cudaErrorInvalidValue;
  int err = launch_delta<mla::kDV, __nv_bfloat16>(p, B, stream);
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>(n_kt * n_hg * B);
  const int width = dv_into_dk ? mla::kDK : mla::kPart;
  if (dv_into_dk) {
    err = launch_mla_dk<true, kFused>(kv_k, kv_v, kv_q, kv_do, p, n_hg,
                                      hg_log2, B, part, width, blocks, stream);
  } else if (shared_kv) {
    err = launch_mla_dk<true, kDK>(kv_k, kv_v, kv_q, kv_do, p, n_hg, hg_log2,
                                   B, part, width, blocks, stream);
    if (err == 0)
      err = launch_mla_dk<true, kDV>(kv_k, kv_v, kv_q, kv_do, p, n_hg,
                                     hg_log2, B, part, width, blocks, stream);
  } else {
    err = launch_mla_dk<false, kDK>(kv_k, kv_v, kv_q, kv_do, p, n_hg,
                                    hg_log2, B, part, width, blocks, stream);
    if (err == 0)
      err = launch_mla_dk<false, kDV>(kv_k, kv_v, kv_q, kv_do, p, n_hg,
                                      hg_log2, B, part, width, blocks,
                                      stream);
  }
  if (err != 0) return err;
  flash_bwd_mla_sum<__nv_bfloat16>
      <<<static_cast<unsigned>(sums), kSumThreads, 0, stream>>>(
          p, part, n_hg, width, dv_into_dk);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return shared_kv
             ? launch_mla_dq<true>(q_q, q_do, q_k, q_v, p,
                                   static_cast<int>(n_rt), B, stream)
             : launch_mla_dq<false>(q_q, q_do, q_k, q_v, p,
                                    static_cast<int>(n_rt), B, stream);
}

}  // namespace

namespace {

Params make_params(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int H, int Sq, int Skv,
                   const long long* strides, int causal, int window,
                   int q_offset, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  Strides* const all[8] = {&p.sq, &p.sk, &p.sv, &p.so,
                           &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 8; ++i)
    *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk and dv
// alike; lse is fp32 (B, H, Sq), delta fp32 scratch of the same shape.
// hd: 16, 32, 64, 128 or 256; Sq, Skv >= 1.  strides: 24 element strides,
// (batch, seq, head) of q, k, v, o, dout, dq, dk, dv in that order; every
// head_dim stride is 1.  window <= 0 means no window.  Returns
// cudaGetLastError() after the launches (0 = success), or
// cudaErrorInvalidValue for an unsupported dtype / head dim.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Sq, int Skv, int hd,
    const long long* strides, int causal, int window, int q_offset,
    float scale, void* stream) {
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, H,
                               Sq, Skv, strides, causal, window, q_offset,
                               scale);
  if ((dtype != 0 && dtype != 1) || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, dtype, B, st);
    case 32: return launch<32>(p, dtype, B, st);
    case 64: return launch<64>(p, dtype, B, st);
    case 128: return launch<128>(p, dtype, B, st);
    case 256: return launch<256>(p, dtype, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fp32 floats of `part`, the MLA backward's scratch for the head
// groups' partials: (B, ceil(H / 16), Skv, width), width 576 for the bf16
// kernel that sums dV into dK (dtype 1 with dv_into_dk), else 576 + 512
// (dK and dV apart).
extern "C" long long flash_attention_mla_bwd_scratch(int B, int H, int Skv,
                                                     int dtype,
                                                     int dv_into_dk) {
  return static_cast<long long>(B) * ((H + mla::kHG - 1) / mla::kHG) * Skv *
         (dtype == 1 && dv_into_dk ? mla::kDK : mla::kPart);
}

// The MLA layout: q (B, Sq, H, 576), k (B, Skv, 1, 576), v (B, Skv, 1,
// 512), o and dout (B, Sq, H, 512), lse fp32 (B, H, Sq); dq, dk and dv
// shaped as q, k and v; delta fp32 (B, H, Sq) and part (see above) scratch.
// dtype, strides (k's, v's, dk's and dv's head strides unread), masks and
// the return value as flash_attention_bwd.  shared_kv: v is k's first 512
// features (the same pointer and batch and position strides), and the
// kernels read V from their K tiles.  dv_into_dk (needs shared_kv): dk gets
// k's whole gradient, dK + [dV, 0], and dv is not written (may be null).
// dtype 0 runs the SIMT kernels, 1 the wgmma kernels, which take q and
// dout only with their (position, head) rows at one stride.
extern "C" int flash_attention_mla_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* part, void* dq,
    void* dk, void* dv, int dtype, int shared_kv, int dv_into_dk, int B,
    int H, int Sq, int Skv, const long long* strides, int causal, int window,
    int q_offset, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, H,
                               Sq, Skv, strides, causal, window, q_offset,
                               scale);
  if ((dtype != 0 && dtype != 1) || Sq < 1 || Skv < 1 || H < 1 ||
      (shared_kv && (v != k || p.sv.b != p.sk.b || p.sv.s != p.sk.s)) ||
      (dv_into_dk && !shared_kv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_mla_simt(p, part, shared_kv, dv_into_dk, B, st)
             : launch_mla_bf16(p, part, shared_kv, dv_into_dk, B, st);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
